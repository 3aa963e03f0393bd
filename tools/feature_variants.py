#!/usr/bin/env python3
"""Time variants of K1', the 3-gram count (csrc/feature_count.cu), that
each take one part of its tile's work away, on the card: where its time
goes, since no device profiler reaches inside a kernel on that machine.

Usage, on a machine with one H100, from the root of a checkout:

    python3 tools/feature_variants.py

Each variant is the kernel's source with one edit, built by its own nvcc
into build/feature_variants/<name>/ and loaded with ctypes:

- ``shipped``: the kernel as it is;
- ``cp_async``: the producer's 8-byte cp.async copies (its path for odd
  G) at G 18 too, in place of the TMA;
- ``no_product``: no wgmma, so the time of the database stream and the
  epilogue (the counts are wrong);
- ``no_copy``: no TMA copy, the stages left as they are, so the time of
  the products and the epilogue (the counts are wrong);
- ``no_set``: the sums not set to -(thresh + 1) before a tile, so the cost
  of that set (the counts are wrong);
- ``smem_a``: the queries staged in shared memory and A read by
  descriptor at 5 k256 steps too, as the kernel does above 5.

Guides are 1,159,224 random 20-mers (the size of the P. aeruginosa index)
from a fixed seed; the count is tier 1 of the Levenshtein filter at dist
4: each guide's plain 3-gram row against every guide's row dilated by
t 3, thresh 8.  Every variant is timed at that size and at 4096 x 200,000
in two rounds (mean ms of 3 and 10 calls, by CUDA events); the variants
that compute the count are checked against the plain count on 4,096
queries.  The last line is one JSON object with every time and the
card's name.  Without a card it exits 1 and prints nothing.
"""
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GUIDES = 1_159_224
T, THRESH, N_WORDS = 3, 8, 18
#: (old, new) edits of csrc/feature_count.cu, and whether the variant
#: still computes the count
_PRODUCT = ("gm::wgmma_m64n128k256_b1(\n"
            "                acc, a[s], desc0 + st * kStageDesc + kStepDesc * s,"
            " 1);")
_SET = ("#pragma unroll\n          for (int i = 0; i < 64; ++i) acc[i] = "
        "bias;\n          gm::wgmma_fence();\n#pragma unroll\n          for "
        "(int s = 0; s < S; ++s)\n            gm::wgmma_m64n128k256_b1(")
VARIANTS = {
    "shipped": ([], True),
    "cp_async": ([("const bool tma =\n      n_words % 2 == 0 &&",
                   "const bool tma =\n      false &&")], True),
    "no_product": ([(_PRODUCT, ";")], False),
    "no_copy": ([("const uint32_t bytes = kTile * 8 * n_words;",
                  "const uint32_t bytes = 0;"),
                 ("      gm::tma_load_3d(ring_addr + st * stage_bytes(S), "
                  "map, 0,\n                      lo + t * kTile, 0, "
                  "full + 8 * st);", "")], False),
    "no_set": ([(_SET, "gm::wgmma_fence();\n#pragma unroll\n          for "
                 "(int s = 0; s < S; ++s)\n            "
                 "gm::wgmma_m64n128k256_b1(")], False),
    "smem_a": ([("constexpr bool smem_a(int steps) { return steps > 5; }",
                 "constexpr bool smem_a(int steps) { return steps > 4; }")],
               True),
}


def variant_source(src, edits):
    """``src`` with each (old, new) edit made once; an edit that does not
    apply raises, so a changed kernel cannot time the wrong variant."""
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"edit does not apply once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def cuda_ms(fn, reps):
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


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("feature_variants: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from guidemaker_tpu_torch.knn import build, stream
    from guidemaker_tpu_torch.knn.features import (feature_count_plain,
                                                   gram_rows)
    csrc = os.path.join(ROOT, "guidemaker_tpu_torch", "csrc")
    with open(os.path.join(csrc, "feature_count.cu")) as fh:
        src = fh.read()
    out_dir = os.path.join(ROOT, "build", "feature_variants")
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        path = os.path.join(vdir, "feature_count.cu")
        with open(path, "w") as fh:
            fh.write(variant_source(src, edits))
        lib = os.path.join(vdir, "libfeature.so")
        procs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-I", csrc, "-shared",
             "-o", lib, path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(path)
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gm_feature_count.argtypes = [P, I, P, I, I, I, I, P, P]
        libs[name] = lib
    dev = torch.device("cuda")
    codes = torch.from_numpy(np.random.default_rng(7).integers(
        0, 4, size=(N_GUIDES, 20)).astype(np.uint8)).to(dev)
    q, db = gram_rows(codes, 0), gram_rows(codes, T)

    def count(lib, qq, dd):
        out = torch.zeros(qq.shape[0], dtype=torch.int32, device=dev)
        err = lib.gm_feature_count(
            qq.data_ptr(), qq.shape[0], dd.data_ptr(), dd.shape[0], N_WORDS,
            THRESH, stream._n_splits(qq.shape[0], dd.shape[0], dev),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"feature_count launch: CUDA error {err}")
        return out

    want = feature_count_plain(q[:4096], db, THRESH)
    res = {"device": torch.cuda.get_device_name(0)}
    for rnd in (1, 2):
        for name, lib in libs.items():
            if rnd == 1 and VARIANTS[name][1] and not torch.equal(
                    count(lib, q[:4096], db), want):
                raise AssertionError(f"{name} != plain")
            res[f"{name}_genome_ms_{rnd}"] = cuda_ms(
                lambda: count(lib, q, db), 3)
            res[f"{name}_4096x200000_ms_{rnd}"] = cuda_ms(
                lambda: count(lib, q[:4096], db[:200_000]), 10)
            print(f"round {rnd} {name}: genome "
                  f"{res[f'{name}_genome_ms_{rnd}']:.3f} ms, 4096 x 200,000 "
                  f"{res[f'{name}_4096x200000_ms_{rnd}']:.4f} ms", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
