#!/usr/bin/env python3
"""Time the two count kernels of one tree of the port on the card: K4,
the packed-pair count, and K1, the 2-bit count, on the same guides.

Usage, on a machine with one H100:

    python3 tools/count_probe.py [ROOT]

``ROOT`` is a tree of the port (default: this checkout), such as a parent
commit unpacked by ``git archive`` into a directory that ``.gitignore``
lists.  Two trees are compared in one call by running the script once for
each, in turns (parent, change, change, parent): a process imports one
tree's package only.  Guides are 1,159,224 random N-free 20-mers (the
size of the P. aeruginosa index) with 1,000 duplicated, made from a fixed
seed.  It checks that K4 equals K1 all against all at editdist 2 and at
the control triage's shape (2^19 random candidates against the guides,
editdist 7 and 2), then prints one JSON line: each kernel's mean ms over
3 calls at each shape, by CUDA events, with the card's name.  Without a
card it exits 1 and prints nothing.
"""
import json
import os
import sys
import time

N_GUIDES = 1_159_224
LENGTH = 20


def cuda_ms(fn, reps=3):
    """Mean ms of ``fn()`` on the card, after one call to warm up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(root: str) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("count_probe: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(root))
    from guidemaker_tpu_torch.knn import build, stream
    from guidemaker_tpu_torch.knn import packed as pk
    from guidemaker_tpu_torch.knn.hamming import pack_codes
    t0 = time.time()
    build.library()
    res = {"root": root, "device": torch.cuda.get_device_name(0),
           "build_s": round(time.time() - t0, 1)}
    dev = torch.device("cuda")
    codes = torch.from_numpy(np.random.default_rng(7).integers(
        0, 4, size=(N_GUIDES, LENGTH)).astype(np.uint8)).to(dev)
    codes[N_GUIDES // 2:N_GUIDES // 2 + 1000] = codes[:1000]
    cand = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4, size=(1 << 19, LENGTH)).astype(np.uint8)).to(dev)
    db, db2 = pk.db_rows(codes), pack_codes(codes)
    for shape, q, q2, edits in (("all", pk.query_rows(codes), db2, (2,)),
                                ("control", pk.query_rows(cand),
                                 pack_codes(cand), (7, 2))):
        for e in edits:
            def k4(q=q, e=e):
                return stream.packed_count(q, db, N_GUIDES, LENGTH, e)

            def k1(q2=q2, e=e):
                return stream.hamming_count(q2, db2, LENGTH, e)
            if not torch.equal(k4(), k1()):
                raise AssertionError(f"K4 != K1 at {shape}, editdist {e}")
            res[f"k4_ms_{shape}_{e}"] = cuda_ms(k4)
            res[f"k1_ms_{shape}_{e}"] = cuda_ms(k1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else
                  os.path.dirname(os.path.dirname(os.path.abspath(
                      __file__)))))
