#!/usr/bin/env python3
"""Smoke run of guidemaker_tpu_torch, the PyTorch/CUDA port, on one card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: the CUDA kernels of guidemaker_tpu_torch/csrc, built with nvcc;
3. each kernel against its plain PyTorch version on the card, on random
   codes with N bases and duplicated rows (4096 queries x 200,000 guides,
   L 20 and 27, every editdist and k of the main path and its edges),
   exact equality;
4. the C. ruddii parity configuration (tests/test_parity_e2e.py) on the
   card, byte for byte against tests/test_data/golden_pretty_cruddii.csv.gz;
5. P. aeruginosa retention (NGG/5prime/20, all unique guides against all,
   dist 2): 1,139,266 guides retained, and the count kernel equal to the
   plain count at full size;
6. the default P. aeruginosa design run with --controls 0, through the
   CLI's parser and ``run_pipeline``: its stage table, its rows, the launch
   count of each kernel (both must be > 0), and its neighbor lists against
   the plain top-k on the card.

The line before the last is a JSON object describing each kernel (launches
in phase 6, the largest error seen, its time and its plain version's time
in ms); the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or outside a checkout, it exits non-zero and prints no result.
"""
import gzip
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PA_GBK = os.path.join(ROOT, "guidemaker_tpu", "data",
                      "Pseudomonas_aeruginosa.gbk.gz")
CR_FASTA = os.path.join(ROOT, "tests", "test_data",
                        "Carsonella_ruddii.fasta.gz")
CR_GBK = os.path.join(ROOT, "tests", "test_data", "Carsonella_ruddii.gbk.gz")
GOLDEN = os.path.join(ROOT, "tests", "test_data",
                      "golden_pretty_cruddii.csv.gz")
#: P. aeruginosa guides retained at dist 2 (exact search, so any correct
#: implementation on any device gives this count)
PA_RETAINED = 1_139_266


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of ``fn()`` on the card, in ms, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Kernel:
    """What the last-but-one line reports about one kernel."""

    def __init__(self, name, source, replaces):
        self.row = {"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": 0, "max_abs_err": 0,
                    "ms": None, "plain_ms": None}

    def compare(self, got: torch.Tensor, want: torch.Tensor, what: str):
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        self.row["max_abs_err"] = max(self.row["max_abs_err"], err)
        if err:
            raise AssertionError(f"{what}: kernel != plain (max abs err {err})")


def random_codes(rng, nq, nd, length):
    """Guides with N bases, duplicated rows and member queries."""
    db = rng.integers(0, 4, size=(nd, length)).astype(np.uint8)
    n_rows = rng.random(nd) < 0.01
    db[n_rows, rng.integers(0, length, n_rows.sum())] = 4
    dup = min(100, nd // 2)
    db[nd // 2:nd // 2 + dup] = db[:dup]
    q = rng.integers(0, 4, size=(nq, length)).astype(np.uint8)
    q[:nq // 2] = db[rng.integers(0, nd, nq // 2)]
    q[-1] = 4
    return q, db


def phase_kernels(count, topk, dev):
    from guidemaker_tpu_torch.knn import KnnIndex, stream
    from guidemaker_tpu_torch.knn.hamming import (hamming_count_plain,
                                                  hamming_topk_plain,
                                                  pack_codes)
    rng = np.random.default_rng(1234)
    times = {}
    for length in (20, 27):
        qn, dbn = random_codes(rng, 4096, 200_000, length)
        q = pack_codes(torch.from_numpy(qn).to(dev))
        db = pack_codes(torch.from_numpy(dbn).to(dev))
        for e in (0, 1, 2, 3, length):
            count.compare(stream.hamming_count(q, db, length, e),
                          hamming_count_plain(q, db, length, e),
                          f"count L={length} editdist={e}")
        for k in (1, 2, 5, 20, 128):
            topk.compare(stream.hamming_topk(q, db, length, k),
                         hamming_topk_plain(q, db, length, k),
                         f"top-k L={length} k={k}")
        if length == 20:
            times["count"] = (
                cuda_ms(lambda: stream.hamming_count(q, db, 20, 2), 5),
                cuda_ms(lambda: hamming_count_plain(q, db, 20, 2), 5))
            times["topk"] = (
                cuda_ms(lambda: stream.hamming_topk(q, db, 20, 5), 5),
                cuda_ms(lambda: hamming_topk_plain(q, db, 20, 5), 5))
    # k > nd on a tiny database: k_eff = nd, and the index pads with -1
    qn, dbn = random_codes(rng, 64, 3, 20)
    q = pack_codes(torch.from_numpy(qn).to(dev))
    db = pack_codes(torch.from_numpy(dbn).to(dev))
    topk.compare(stream.hamming_topk(q, db, 20, 6),
                 hamming_topk_plain(q, db, 20, 6), "top-k k=6 > nd=3")
    from guidemaker_tpu_torch import dna
    d, i = KnnIndex(dna.decode_rows(dbn), device=dev).query_codes(qn, 6)
    if not ((d[:, 3:] == -1).all() and (i[:, 3:] == -1).all()
            and (d[:, :3] >= 0).all()):
        raise AssertionError("k > nd: -1 padding beyond nd is wrong")
    say("phase 3 kernels vs plain: exact at nq=4096 nd=200000 L=20,27 "
        "editdist 0,1,2,3,L k 1,2,5,20,128 and k>nd; L=20 times: "
        f"count {times['count'][0]:.3f} ms (plain {times['count'][1]:.3f} ms)"
        f", top-k k=5 {times['topk'][0]:.3f} ms "
        f"(plain {times['topk'][1]:.3f} ms)")


def phase_cruddii(dev):
    from guidemaker_tpu_torch import definitions
    from guidemaker_tpu_torch.annotate import Annotation
    from guidemaker_tpu_torch.io import parse_fasta
    from guidemaker_tpu_torch.scan import PamTarget
    from guidemaker_tpu_torch.targets import TargetProcessor
    t0 = time.time()
    targets = PamTarget("NGG", "5prime", "hamming").find_targets(
        parse_fasta(CR_FASTA), 20)
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=10,
                         device=dev)
    tl.check_restriction_enzymes(["NRAGCA"])
    tl.find_unique_near_pam()
    tl.create_index(configpath=definitions.CONFIG_PATH)
    tl.get_neighbors(configpath=definitions.CONFIG_PATH)
    anno = Annotation(annotation_list=[CR_GBK], annotation_type="genbank",
                      target_bed_df=tl.export_bed())
    anno.get_annotation_features()
    anno._get_nearby_features()
    anno._filter_features(before_feat=100, after_feat=200)
    anno._get_qualifiers(configpath=definitions.CONFIG_PATH)
    anno._format_guide_table(tl)
    buf = io.StringIO()
    anno.pretty_df.to_csv(buf, index=False)
    with gzip.open(GOLDEN, "rt") as fh:
        if buf.getvalue() != fh.read():
            raise AssertionError("C. ruddii table differs from the golden CSV")
    say(f"phase 4 C. ruddii on {dev}: golden table byte for byte "
        f"({anno.pretty_df.shape[0]} rows, {len(tl.index)} indexed guides, "
        f"{time.time() - t0:.2f} s)")


def phase_retention(count, dev):
    import pandas as pd
    from guidemaker_tpu_torch.io import parse_genbank
    from guidemaker_tpu_torch.knn import KnnIndex, stream
    from guidemaker_tpu_torch.knn.hamming import hamming_count_plain
    t0 = time.time()
    recs = [r.upper() for r in parse_genbank(PA_GBK)]
    from guidemaker_tpu_torch.scan import PamTarget
    targets = PamTarget("NGG", "5prime", "hamming").find_targets(recs, 20)
    uniq = pd.Series(pd.unique(targets["target"]), dtype="str")
    idx = KnnIndex(uniq, device=dev)
    t_host = time.time() - t0
    t0 = time.time()
    retained = int(idx.pass_distance_filter(uniq, 2).sum())
    t_filter = time.time() - t0
    if retained != PA_RETAINED:
        raise AssertionError(f"P. aeruginosa retained {retained}, "
                             f"expected {PA_RETAINED}")
    db, n = idx._db, len(idx)
    got = stream.hamming_count(db, db, 20, 2)
    t0 = time.time()
    want = hamming_count_plain(db, db, 20, 2)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    count.compare(got, want, "P. aeruginosa all-vs-all count")
    ms = cuda_ms(lambda: stream.hamming_count(db, db, 20, 2), 3)
    count.row["ms"], count.row["plain_ms"] = round(ms, 3), round(plain_ms, 3)
    say(f"phase 5 P. aeruginosa retention: {retained} of {n} guides retained "
        f"(expected {PA_RETAINED}); count kernel == plain at {n} x {n}; "
        f"kernel {ms:.3f} ms ({n * n / ms / 1e9:.4f} T pairs/s), plain "
        f"{plain_ms:.3f} ms; pass_distance_filter {t_filter:.3f} s; "
        f"parse+scan+index {t_host:.2f} s")


class StageGrab(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("[stage]"):
            self.lines.append(msg)


def phase_design(count, topk, dev):
    import pandas as pd
    from guidemaker_tpu_torch import cli
    from guidemaker_tpu_torch.knn import stream
    from guidemaker_tpu_torch.knn.hamming import (hamming_topk_plain,
                                                  pack_codes, unpack_keys)
    from guidemaker_tpu_torch.pipeline import run_pipeline
    out = tempfile.mkdtemp(prefix="gm_smoke_")
    argv = ["--genbank", PA_GBK, "--pamseq", "NGG", "--outdir", out,
            "--controls", "0", "--log", os.path.join(out, "run.log")]
    cfg = cli.config_from_args(cli.myparser().parse_args(argv))
    timing = logging.getLogger("guidemaker_tpu_torch.timing")
    grab = StageGrab()
    timing.addHandler(grab)
    timing.setLevel(logging.INFO)
    stream.count_launches.reset()
    stream.topk_launches.reset()
    t0 = time.time()
    res = run_pipeline(cfg)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = (stream.count_launches.n, stream.topk_launches.n)
    timing.removeHandler(grab)
    count.row["launches"], topk.row["launches"] = launches
    for line in grab.lines:
        say("  " + line)
    df = res.targets
    written = pd.read_csv(os.path.join(out, "targets.csv.gz"))
    if len(df) == 0 or len(written) != len(df):
        raise AssertionError(f"design table: {len(df)} rows, "
                             f"{len(written)} written")
    if min(launches) == 0:
        raise AssertionError(f"a kernel was not launched by the design run: "
                             f"count {launches[0]}, top-k {launches[1]}")
    # the neighbor lists of the phase-2 query set against the plain top-k
    idx = res.processor.index
    need = list(pd.unique(df["Guide sequence"]))
    q = pack_codes(torch.from_numpy(idx._encode_queries(need)).to(dev))
    got = stream.hamming_topk(q, idx._db, idx.length, cfg.knum)
    t0 = time.time()
    want = hamming_topk_plain(q, idx._db, idx.length, cfg.knum)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    topk.compare(got, want, "P. aeruginosa phase-2 top-k")
    ms = cuda_ms(lambda: stream.hamming_topk(q, idx._db, idx.length,
                                             cfg.knum), 3)
    topk.row["ms"], topk.row["plain_ms"] = round(ms, 3), round(plain_ms, 3)
    d, i = (t.cpu().numpy() for t in unpack_keys(want))
    seqs = idx.seqs
    expect = {s: (";".join(seqs[j] for j in i[r] if j >= 0),
                  ";".join(str(x) for x in d[r] if x >= 0))
              for r, s in enumerate(need)}
    for col, pos in (("Similar guides", 0), ("Similar guide distances", 1)):
        exp = df["Guide sequence"].map(lambda s: expect[s][pos])
        if not (df[col].astype(str) == exp).all():
            raise AssertionError(f"design table column {col!r} differs from "
                                 f"the plain top-k")
    say(f"phase 6 P. aeruginosa design run (--controls 0) on {dev}: "
        f"{len(df)} rows, {df['Guide sequence'].nunique()} guides, "
        f"{wall:.2f} s wall; launches: count {launches[0]}, top-k "
        f"{launches[1]}; neighbor lists == plain top-k for {len(need)} "
        f"queries x {len(idx)} guides (kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from guidemaker_tpu_torch.knn import build
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    say(smi)
    say(f"phase 1 device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.time()
    lib = build.build()
    build.library()
    with open(lib[:-3] + ".log") as fh:
        ptxas = [ln.strip() for ln in fh if "registers" in ln
                 or "spill" in ln]
    say(f"phase 2 build: {os.path.relpath(lib, ROOT)} in "
        f"{time.time() - t0:.2f} s")
    for ln in ptxas:
        say("  " + ln)
    count = Kernel("hamming_count",
                   "guidemaker_tpu_torch/csrc/hamming_count.cu",
                   "guidemaker_tpu/knn/pallas_stream.py:164")
    topk = Kernel("hamming_topk", "guidemaker_tpu_torch/csrc/hamming_topk.cu",
                  "guidemaker_tpu/knn/pallas_stream.py:90, "
                  "guidemaker_tpu/knn/pallas_hamming.py:84")
    phase_kernels(count, topk, dev)
    phase_cruddii(dev)
    phase_retention(count, dev)
    phase_design(count, topk, dev)
    say(json.dumps({"kernels": [count.row, topk.row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
