#!/usr/bin/env python3
"""Time the count and top-k kernels of one tree of the port on the card:
K4, the packed-pair count, and K1, the 2-bit count, on the same guides;
K2, the 2-bit top-k; K5, the packed-pair top-k; and K1', the 3-gram
count.

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
editdist 7 and 2), and that K2 equals the plain top-k at the design run's
phase-2 shape (the first 101,513 guides against all, k 1, 4, 8, 16 and
32, each a kcap) and at 4096 x 200,000 (k 5), and times K1 on the
phase-2 shape (editdist 2) beside it; and that K5 equals the plain packed
top-k on K4's guides at the phase-2 shape (the same k) and at
4096 x 200,001 (k 5); and that K1' equals the plain 3-gram count in
tier 1 of the Levenshtein filter at dist 4 (each guide's plain 3-gram row
against every guide's row dilated by t 3, thresh 8) on all the guides
(on a fixed sample of 4,096 queries) and at 4096 x 200,000; then prints
one JSON line:
each kernel's mean ms over 3 calls at each shape (10 at the small one),
by CUDA events, with the card's name.  Without a card it exits 1 and
prints nothing.
"""
import json
import os
import sys
import time

N_GUIDES = 1_159_224
LENGTH = 20
#: queries of the design run's phase-2 lists (P. aeruginosa, NGG/5prime/20)
N_PHASE2 = 101_513
#: the top-k's k at the phase-2 shape: kcap 1, 4, 8 (the main path's),
#: 16 and 32
PHASE2_KS = (1, 4, 8, 16, 32)
#: K1' in tier 1 of the Levenshtein filter at dist 4: the database rows
#: dilated by t 3, thresh 8 (knn/leven.py)
TIER1_T, TIER1_THRESH = 3, 8


def cuda_ms(fn, reps=3):
    """Mean ms of ``reps`` calls of ``fn()`` on the card, after one call to
    warm up."""
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
    from guidemaker_tpu_torch.knn.features import (feature_count_plain,
                                                   gram_rows)
    from guidemaker_tpu_torch.knn.hamming import (hamming_topk_plain,
                                                  pack_codes)
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
    # K1 on the phase-2 grid: the block's cost when no pair can enter a list
    res["k1_ms_phase2_2"] = cuda_ms(
        lambda: stream.hamming_count(db2[:N_PHASE2], db2, LENGTH, 2))
    for shape, q, rows, ks, reps in (
            ("phase2", db2[:N_PHASE2], db2, PHASE2_KS, 3),
            ("4096x200000", db2[:4096], db2[:200_000], (5,), 10)):
        want = hamming_topk_plain(q, rows, LENGTH, max(ks))
        for k in ks:
            def k2(q=q, rows=rows, k=k):
                return stream.hamming_topk(q, rows, LENGTH, k)
            if not torch.equal(k2(), want[:, :k]):
                raise AssertionError(f"K2 != plain at {shape}, k {k}")
            res[f"k2_ms_{shape}_{k}"] = cuda_ms(k2, reps)
    for shape, q, rows, nd, ks, reps in (
            ("phase2", pk.query_rows(codes[:N_PHASE2]), db, N_GUIDES,
             PHASE2_KS, 3),
            ("4096x200001", pk.query_rows(codes[:4096]),
             pk.db_rows(codes[:200_001]), 200_001, (5,), 10)):
        want = pk.packed_topk_plain(q, rows, nd, LENGTH, max(ks))
        for k in ks:
            def k5(q=q, rows=rows, nd=nd, k=k):
                return stream.packed_topk(q, rows, nd, LENGTH, k)
            if not torch.equal(k5(), want[:, :k]):
                raise AssertionError(f"K5 != plain at {shape}, k {k}")
            res[f"k5_ms_{shape}_{k}"] = cuda_ms(k5, reps)
    del db, db2, want
    fq, fdb = gram_rows(codes, 0), gram_rows(codes, TIER1_T)
    sample = torch.from_numpy(np.sort(np.random.default_rng(3).choice(
        N_GUIDES, 4096, replace=False))).to(dev)
    for shape, q, rows, pick, reps in (
            ("genome", fq, fdb, sample, 3),
            ("4096x200000", fq[:4096], fdb[:200_000], None, 10)):
        def k1p(q=q, rows=rows):
            return stream.feature_count(q, rows, LENGTH - 2, TIER1_THRESH)
        got = k1p()
        if pick is not None:
            got, q = got[pick], q[pick]
        if not torch.equal(got, feature_count_plain(q, rows, TIER1_THRESH)):
            raise AssertionError(f"K1' != plain at {shape}")
        res[f"k1p_ms_{shape}"] = cuda_ms(k1p, reps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else
                  os.path.dirname(os.path.dirname(os.path.abspath(
                      __file__)))))
