#!/usr/bin/env python3
"""Smoke run of guidemaker_tpu_torch, the PyTorch/CUDA port, on one card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: the CUDA kernels of guidemaker_tpu_torch/csrc, one nvcc per
   source, all started together;
3. each kernel against its plain PyTorch version on the card, exact
   equality: the 2-bit kernels on random codes with N bases and duplicated
   rows (4096 queries x 200,000 guides, L 20 and 27), the packed-pair
   kernels on N-free codes with duplicated rows (4096 x 200,001, odd, L 20
   and 21), every editdist and k of the main path and its edges;
4. the C. ruddii parity configuration (tests/test_parity_e2e.py) on the
   card, byte for byte against tests/test_data/golden_pretty_cruddii.csv.gz;
5. P. aeruginosa retention (NGG/5prime/20, all unique guides against all,
   dist 2) in both index layouts: 1,139,266 guides retained each time, and
   the 2-bit and packed count kernels equal to their plain versions, and
   to each other, at full size;
6. the default P. aeruginosa design run with --controls 1000 and a fixed
   --seed, through the CLI's parser and ``run_pipeline``, in the 2-bit
   layout: its stage table, its rows, its neighbor lists against the
   plain top-k on the card, its 1000 controls (each at Hamming distance
   >= 7, equal to the plain k=1 distance, named Cont-<md5>, the same frame
   again from a second search with the same seed), and the launch count of
   both 2-bit kernels (> 0);
7. the same run with GUIDEMAKER_TPU_PACKED=1: the same targets table, the
   same control invariants, both packed kernels launched and neither 2-bit
   kernel;
8. P. aeruginosa Levenshtein retention (NGG/5prime/20, all unique guides
   against all): at dist 2 the mask equals the Hamming mask (1,139,266
   retained); at dist 3 it is a subset of the Hamming dist-3 mask and, on
   a fixed sample of 4,096 queries, equals the exact rule (second-nearest
   Levenshtein distance >= 3, from the k=2 top-k over all guides);
9. the design run of phase 6 with --dtype leven: its table equals phase
   6's but for the dtype and the two "Similar guide" columns, its neighbor
   lists equal the plain DP top-k on the card for a sample of guides, its
   controls equal phase 6's frame (the control search is Hamming on either
   metric, and the seed, device and chunking are the same), and the
   Levenshtein top-k kernel was launched;
10. the 3-gram tiers of Levenshtein retention at dist 4, all against all,
   on the first 131,072 unique P. aeruginosa guides: the mask equals the
   exact rule (second-nearest distance >= 4, from the k=2 top-k), the
   3-gram count kernel was launched, and each tier's size and seconds are
   printed.  Reduced, because at genome size the e >= 4 all-vs-all is some
   1.3e12 pairs of 3-gram counting and a large ambiguous set, a run of its
   own rather than a smoke phase;
11. the scored design run: phase 6's run with --knum 3
   --doench_efficiency_score --cfd_score.  The three golden Doench floats
   are float32-exact; the table holds phase 6's rows less those whose
   target_seq30 holds an N, and equals phase 6's table on every column
   they share but the two neighbor-list columns; Efficiency is float32
   and finite; Max CFD is in [0, 1] and below 1 somewhere; CFD Similar
   Guides equals the scalar calc_cfd on 1,000 sampled rows; the neighbor
   lists equal the plain top-k at k 3 on the card; the controls equal
   phase 6's frame.  No plot: the page would embed every row of the table;
12. the web app's command (``app.build_cli_args`` with the app's defaults:
   knum 3, --controls 10, --plot, both scores) on the bundled C. ruddii
   demo genome, run by the app's ``run_command`` as a subprocess on the
   card and again with ``device="cpu"``: both exit 0 and write
   targets.csv.gz with the score columns, one <accession>.html holding the
   Vega-Lite spec and controls.csv.gz with 10 rows, and the two tables
   are equal byte for byte (the seeded controls differ between CPU and
   CUDA, so they are not compared).

Phase 3c holds the two Levenshtein kernels against their plain versions:
the 3-gram count on the rows of random codes with N bases and duplicated
rows (4096 x 200,000, L 20 and 27, t 3 and 4, both directions, the
threshold's edges), and the Myers top-k on codes with N bases, duplicates
and near-identical pairs (LEVEN_SHAPE, L 20, 27 and 32, k 1, 2, 5, 64 and
128).

The line before the last is a JSON object describing each kernel (launches
in the path that uses it: phase 6 or 7 for the Hamming kernels, phase 9
for the Myers top-k, phase 10 for the 3-gram count; the largest error
seen; its time and its plain version's time in ms at the sizes its phase
prints, and for the 2-bit top-k also at k 3 from phase 11); the last line
is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or outside a checkout, it exits non-zero and prints no result.
"""
import gzip
import hashlib
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
#: control-sampling seed of the design runs
SEED = 20261016
#: (queries, database guides) of the phase-3c checks: the 3-gram count,
#: and the Myers top-k, whose plain DP takes well under a second a call
FEATURE_SHAPE = (4096, 200_000)
LEVEN_SHAPE = (2048, 100_000)
#: rows of the NGG/3prime/20 design table at dist 2, Hamming or
#: Levenshtein (the JAX package's run, BENCH_r05.json leven_e2e_guides)
PA_TABLE_ROWS = 105_590
#: guides of the reduced all-vs-all 3-gram tier run (phase 10)
TIER_GUIDES = 131_072
#: the design table's two neighbor-list columns
NEIGHBOR_COLS = ["Similar guides", "Similar guide distances"]
#: the reference's golden Doench 2016 scores, float32-exact
GOLDEN_30MERS = np.array(["GTACAAAGCACGTTATTAGATGGTGGGAAC",
                          "TCTAATCACGACAGCATCACTATTAGGCCG",
                          "TGAAATGTCTCTTATCTCTGTGTAAGGCTC"])
GOLDEN_DOENCH = np.array([[0.59383124], [0.28157765], [0.5276569]],
                         dtype=np.float32)
#: rows of the scored table whose CFD lists phase 11 recomputes one by one
CFD_SAMPLE = 1000


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


def random_codes(rng, nq, nd, length, with_n=True):
    """Guides with duplicated rows and member queries, and with N bases
    unless ``with_n`` is false (the packed kernels are never fed an N)."""
    db = rng.integers(0, 4, size=(nd, length)).astype(np.uint8)
    if with_n:
        n_rows = rng.random(nd) < 0.01
        db[n_rows, rng.integers(0, length, n_rows.sum())] = 4
    dup = min(100, nd // 2)
    db[nd // 2:nd // 2 + dup] = db[:dup]
    q = rng.integers(0, 4, size=(nq, length)).astype(np.uint8)
    q[:nq // 2] = db[rng.integers(0, nd, nq // 2)]
    if with_n:
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


def phase_packed_kernels(pcount, ptopk, dev):
    from guidemaker_tpu_torch import dna
    from guidemaker_tpu_torch.knn import KnnIndex, stream
    from guidemaker_tpu_torch.knn import packed as pk
    from guidemaker_tpu_torch.knn.hamming import pack_codes
    rng = np.random.default_rng(4321)
    nd = 200_001
    times = {}
    for length in (20, 21):
        qn, dbn = random_codes(rng, 4096, nd, length, with_n=False)
        qc, dbc = (torch.from_numpy(a).to(dev) for a in (qn, dbn))
        q, db = pk.query_rows(qc), pk.db_rows(dbc)
        q2, db2 = pack_codes(qc), pack_codes(dbc)
        for e in (0, 1, 2, 3, length):
            got = stream.packed_count(q, db, nd, length, e)
            pcount.compare(got, pk.packed_count_plain(q, db, nd, length, e),
                           f"packed count L={length} editdist={e}")
            pcount.compare(got, stream.hamming_count(q2, db2, length, e),
                           f"packed count == 2-bit count L={length} "
                           f"editdist={e}")
        for k in (1, 2, 5, 20, 128):
            got = stream.packed_topk(q, db, nd, length, k)
            ptopk.compare(got, pk.packed_topk_plain(q, db, nd, length, k),
                          f"packed top-k L={length} k={k}")
            ptopk.compare(got, stream.hamming_topk(q2, db2, length, k),
                          f"packed top-k == 2-bit top-k L={length} k={k}")
        if length == 20:
            for name, fn in (
                    ("count", lambda: stream.packed_count(q, db, nd, 20, 2)),
                    ("count plain",
                     lambda: pk.packed_count_plain(q, db, nd, 20, 2)),
                    ("2-bit count",
                     lambda: stream.hamming_count(q2, db2, 20, 2)),
                    ("top-k", lambda: stream.packed_topk(q, db, nd, 20, 5)),
                    ("top-k plain",
                     lambda: pk.packed_topk_plain(q, db, nd, 20, 5)),
                    ("2-bit top-k",
                     lambda: stream.hamming_topk(q2, db2, 20, 5))):
                times[name] = cuda_ms(fn, 5)
    # k > nd on a three-guide database: k_eff = nd, and the index pads -1
    qn, dbn = random_codes(rng, 64, 3, 20, with_n=False)
    q = pk.query_rows(torch.from_numpy(qn).to(dev))
    db = pk.db_rows(torch.from_numpy(dbn).to(dev))
    ptopk.compare(stream.packed_topk(q, db, 3, 20, 6),
                  pk.packed_topk_plain(q, db, 3, 20, 6), "packed k=6 > nd=3")
    d, i = KnnIndex(dna.decode_rows(dbn), device=dev,
                    packed=True).query_codes(qn, 6)
    if not ((d[:, 3:] == -1).all() and (i[:, 3:] == -1).all()
            and (d[:, :3] >= 0).all()):
        raise AssertionError("packed k > nd: -1 padding beyond nd is wrong")
    say("phase 3 packed kernels vs plain (and vs the 2-bit kernels): exact "
        "at nq=4096 nd=200001 L=20,21 editdist 0,1,2,3,L k 1,2,5,20,128 and "
        "k>nd; L=20 ms: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                      times.items()))


def leven_codes(rng, nq, nd, length):
    """random_codes plus database rows at Levenshtein distance 1 and 2 from
    queries: substitutions, and a deletion with an insertion (a shift)."""
    q, db = random_codes(rng, nq, nd, length)
    near = min(nq, nd // 4)
    rows = rng.integers(0, nd, near)
    src = q[:near].copy()
    subs = rng.random(near) < 0.5
    src[subs, rng.integers(0, length, subs.sum())] = rng.integers(
        0, 4, subs.sum())
    shift = ~subs
    src[shift, :-1] = src[shift, 1:]
    src[shift, -1] = rng.integers(0, 4, shift.sum())
    db[rows] = src
    return q, db


def phase_leven_kernels(fcount, ltopk, dev):
    from guidemaker_tpu_torch.knn import stream
    from guidemaker_tpu_torch.knn.dp import leven_topk_plain
    from guidemaker_tpu_torch.knn.features import (feature_count_plain,
                                                   gram_rows)
    from guidemaker_tpu_torch.knn.hamming import pack_codes
    rng = np.random.default_rng(2468)
    times = {}
    fq, fd = FEATURE_SHAPE
    for length in (20, 27):
        qn, dbn = random_codes(rng, fq, fd, length)
        qc, dbc = (torch.from_numpy(a).to(dev) for a in (qn, dbn))
        glen = length - 2
        for t in (3, 4):
            plain_q, plain_db = gram_rows(qc, 0), gram_rows(dbc, 0)
            dil_q, dil_db = gram_rows(qc, t), gram_rows(dbc, t)
            for way, q, db in (("1", plain_q, dil_db), ("2", dil_q, plain_db)):
                for thresh in (glen - 3 * t - 1, 0, glen - 1, glen):
                    fcount.compare(
                        stream.feature_count(q, db, glen, thresh),
                        feature_count_plain(q, db, thresh),
                        f"feature count L={length} t={t} direction {way} "
                        f"thresh={thresh}")
            if length == 20 and t == 3:
                thresh = glen - 3 * t - 1
                times["feature count"] = cuda_ms(
                    lambda: stream.feature_count(plain_q, dil_db, glen,
                                                 thresh), 5)
                times["feature count plain"] = cuda_ms(
                    lambda: feature_count_plain(plain_q, dil_db, thresh), 2)
    nq, nd = LEVEN_SHAPE
    for length in (20, 27, 32):
        qn, dbn = leven_codes(rng, nq, nd, length)
        q = pack_codes(torch.from_numpy(qn).to(dev))
        db = pack_codes(torch.from_numpy(dbn).to(dev))
        for k in (1, 2, 5, 64, 128):
            got = stream.leven_topk(q, db, length, k)
            t0 = time.time()
            want = leven_topk_plain(q, db, length, k)
            torch.cuda.synchronize()
            plain_s = time.time() - t0
            ltopk.compare(got, want, f"leven top-k L={length} k={k}")
            if length == 20 and k == 5:
                times["leven top-k"] = cuda_ms(
                    lambda: stream.leven_topk(q, db, 20, 5), 3)
                times["leven top-k plain"] = plain_s * 1e3
    say(f"phase 3c Levenshtein kernels vs plain: feature count exact at "
        f"{fq} x {fd} L=20,27 t=3,4 both directions 4 thresholds; leven "
        f"top-k exact at {nq} x {nd} L=20,27,32 k 1,2,5,64,128; L=20 ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))


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


def pa_guides():
    """The unique NGG/5prime/20 guides of P. aeruginosa, in scan order."""
    import pandas as pd
    from guidemaker_tpu_torch.io import parse_genbank
    from guidemaker_tpu_torch.scan import PamTarget
    recs = [r.upper() for r in parse_genbank(PA_GBK)]
    targets = PamTarget("NGG", "5prime", "hamming").find_targets(recs, 20)
    return pd.Series(pd.unique(targets["target"]), dtype="str")


def phase_retention(count, pcount, dev, uniq, t_host):
    from guidemaker_tpu_torch.knn import KnnIndex, stream
    from guidemaker_tpu_torch.knn import packed as pk
    from guidemaker_tpu_torch.knn.hamming import hamming_count_plain
    counts = {}
    for layout, packed in (("2-bit", False), ("packed", True)):
        idx = KnnIndex(uniq, device=dev, packed=packed)
        t0 = time.time()
        retained = int(idx.pass_distance_filter(uniq, 2).sum())
        t_filter = time.time() - t0
        if retained != PA_RETAINED:
            raise AssertionError(f"P. aeruginosa retained {retained} in the "
                                 f"{layout} layout, expected {PA_RETAINED}")
        n = len(idx)
        if packed:
            kern = pcount
            q = pk.query_rows(torch.from_numpy(idx._codes).to(dev))
            db = idx._packed_db()
            run = lambda: stream.packed_count(q, db, n, 20, 2)  # noqa: E731
            plain = lambda: pk.packed_count_plain(q, db, n, 20, 2)  # noqa
        else:
            kern = count
            db = idx._db
            run = lambda: stream.hamming_count(db, db, 20, 2)  # noqa: E731
            plain = lambda: hamming_count_plain(db, db, 20, 2)  # noqa: E731
        got = run()
        t0 = time.time()
        want = plain()
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        kern.compare(got, want, f"P. aeruginosa all-vs-all {layout} count")
        counts[layout] = got
        ms = cuda_ms(run, 3)
        kern.row["ms"], kern.row["plain_ms"] = round(ms, 3), round(plain_ms, 3)
        say(f"phase 5 P. aeruginosa retention, {layout} layout: {retained} of "
            f"{n} guides retained (expected {PA_RETAINED}); kernel == plain "
            f"at {n} x {n}; kernel {ms:.3f} ms ({n * n / ms / 1e9:.4f} T "
            f"pairs/s), plain {plain_ms:.3f} ms; pass_distance_filter "
            f"{t_filter:.3f} s")
        del idx, db, got, want
    pcount.compare(counts["packed"], counts["2-bit"],
                   "P. aeruginosa packed count == 2-bit count")
    say(f"phase 5 packed count vector == 2-bit count vector; parse+scan "
        f"{t_host:.2f} s")


class StageGrab(logging.Handler):
    """Keeps the timing log's lines that start with ``tag``."""

    def __init__(self, tag="[stage]"):
        super().__init__(logging.INFO)
        self.tag = tag
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(self.tag):
            self.lines.append(msg)


def all_counters():
    from guidemaker_tpu_torch.knn import stream
    return (stream.count_launches, stream.topk_launches,
            stream.packed_count_launches, stream.packed_topk_launches,
            stream.feature_count_launches, stream.leven_topk_launches)


def design_run(dev, packed: bool, extra=()):
    """The default P. aeruginosa design run with --controls 1000 --seed
    SEED (and the flags ``extra``), through the CLI's parser and
    run_pipeline, with every launch count set to 0 just before it and read
    just after."""
    from guidemaker_tpu_torch import cli
    from guidemaker_tpu_torch.pipeline import run_pipeline
    out = tempfile.mkdtemp(prefix="gm_smoke_")
    argv = ["--genbank", PA_GBK, "--pamseq", "NGG", "--outdir", out,
            "--seed", str(SEED), "--log", os.path.join(out, "run.log"),
            *extra]
    cfg = cli.config_from_args(cli.myparser().parse_args(argv))
    timing = logging.getLogger("guidemaker_tpu_torch.timing")
    grab = StageGrab()
    timing.addHandler(grab)
    timing.setLevel(logging.INFO)
    counters = all_counters()
    if packed:
        os.environ["GUIDEMAKER_TPU_PACKED"] = "1"
    else:
        os.environ.pop("GUIDEMAKER_TPU_PACKED", None)
    try:
        for c in counters:
            c.reset()
        t0 = time.time()
        res = run_pipeline(cfg)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = [c.n for c in counters]
    finally:
        os.environ.pop("GUIDEMAKER_TPU_PACKED", None)
        timing.removeHandler(grab)
    if res.processor.index.packed != packed:
        raise AssertionError(f"design run index packed="
                             f"{res.processor.index.packed}, wanted {packed}")
    return cfg, out, res, launches, wall, grab.lines


def check_controls(res, out, dev):
    """1000 controls, each at Hamming distance >= 7 and equal to the plain
    k=1 distance on the card, named Cont-<md5>, written to controls.csv.gz."""
    import pandas as pd
    from guidemaker_tpu_torch import dna
    from guidemaker_tpu_torch.knn.hamming import (hamming_topk_plain,
                                                  pack_codes, unpack_keys)
    ctl = res.controls
    if len(ctl) != 1000 or list(ctl.columns) != ["name", "Sequences",
                                                 "Hamming distance"]:
        raise AssertionError(f"controls: {len(ctl)} rows, columns "
                             f"{list(ctl.columns)}")
    dist = ctl["Hamming distance"].to_numpy()
    if not (dist >= 7).all():
        raise AssertionError(f"a control below distance 7: {dist.min()}")
    idx = res.processor.index
    q = pack_codes(torch.from_numpy(
        dna.encode_batch(list(ctl["Sequences"]), 20)).to(dev))
    want = unpack_keys(hamming_topk_plain(q, idx._db, 20, 1))[0][:, 0]
    if not np.array_equal(dist, want.cpu().numpy().astype(float)):
        raise AssertionError("control distances != plain k=1 distances")
    names = ctl["Sequences"].map(
        lambda x: "Cont-" + hashlib.md5(x.encode()).hexdigest())
    if not (ctl["name"] == names).all():
        raise AssertionError("control names are not Cont-<md5>")
    written = pd.read_csv(os.path.join(out, "controls.csv.gz"), index_col=0)
    if not written.equals(ctl):
        raise AssertionError("controls.csv.gz differs from the frame")
    return (f"1000 controls, distance min {res.control_min_dist:g} median "
            f"{res.control_median_dist:g}, == plain k=1, Cont-<md5> names, "
            f"{res.processor.ncontrolsearched} candidates searched")


def stage_seconds(lines, name):
    for line in lines:
        if line.split()[1:1 + len(name.split())] == name.split():
            return line.split()[1 + len(name.split())]
    return "n/a"


def check_neighbor_lists(topk, res, k, dev):
    """The design table's neighbor lists against the plain top-k at ``k``
    over all guides, on the card; returns the query count and the
    kernel's and the plain version's ms."""
    import pandas as pd
    from guidemaker_tpu_torch.knn import stream
    from guidemaker_tpu_torch.knn.hamming import (hamming_topk_plain,
                                                  pack_codes, unpack_keys)
    df, idx = res.targets, res.processor.index
    need = list(pd.unique(df["Guide sequence"]))
    q = pack_codes(torch.from_numpy(idx._encode_queries(need)).to(dev))
    got = stream.hamming_topk(q, idx._db, idx.length, k)
    t0 = time.time()
    want = hamming_topk_plain(q, idx._db, idx.length, k)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    topk.compare(got, want, f"P. aeruginosa phase-2 top-k at k {k}")
    ms = cuda_ms(lambda: stream.hamming_topk(q, idx._db, idx.length, k), 3)
    d, i = (t.cpu().numpy() for t in unpack_keys(want))
    seqs = idx.seqs
    expect = {s: (";".join(seqs[j] for j in i[r] if j >= 0),
                  ";".join(str(x) for x in d[r] if x >= 0))
              for r, s in enumerate(need)}
    for col, pos in zip(NEIGHBOR_COLS, (0, 1)):
        exp = df["Guide sequence"].map(lambda s: expect[s][pos])
        if not (df[col].astype(str) == exp).all():
            raise AssertionError(f"design table column {col!r} differs from "
                                 f"the plain top-k at k {k}")
    return need, ms, plain_ms


def phase_design(count, topk, dev):
    import pandas as pd
    from guidemaker_tpu_torch.io import parse_genbank
    cfg, out, res, launches, wall, lines = design_run(dev, packed=False)
    count.row["launches"], topk.row["launches"] = launches[:2]
    for line in lines:
        say("  " + line)
    df = res.targets
    written = pd.read_csv(os.path.join(out, "targets.csv.gz"))
    if len(df) == 0 or len(written) != len(df):
        raise AssertionError(f"design table: {len(df)} rows, "
                             f"{len(written)} written")
    if min(launches[:2]) == 0:
        raise AssertionError(f"a 2-bit kernel was not launched by the design "
                             f"run: launches {launches}")
    need, ms, plain_ms = check_neighbor_lists(topk, res, cfg.knum, dev)
    topk.row["ms"], topk.row["plain_ms"] = round(ms, 3), round(plain_ms, 3)
    idx = res.processor.index
    controls = check_controls(res, out, dev)
    # the same seed searches the same candidates again
    t0 = time.time()
    again = res.processor.get_control_seqs(
        parse_genbank(PA_GBK), cfg.config, length=cfg.guidelength,
        n=cfg.controls, seed=SEED)[2]
    t_again = time.time() - t0
    if not again.equals(res.controls):
        raise AssertionError("a second control search with the same seed "
                             "gave another frame")
    say(f"phase 6 P. aeruginosa design run (--controls 1000 --seed {SEED}, "
        f"2-bit layout) on {dev}: {len(df)} rows, "
        f"{df['Guide sequence'].nunique()} guides, {wall:.2f} s wall, "
        f"controls stage {stage_seconds(lines, 'controls')} s; launches: "
        f"count {launches[0]}, top-k {launches[1]}, packed {launches[2:4]}, "
        f"Levenshtein {launches[4:]}; "
        f"neighbor lists == plain top-k for {len(need)} queries x "
        f"{len(idx)} guides (kernel {ms:.3f} ms, plain {plain_ms:.3f} ms); "
        f"{controls}; the same frame again from a second search with the "
        f"same seed ({t_again:.2f} s)")
    return out, res.controls, df


def phase_design_packed(pcount, ptopk, dev, codes_out):
    import pandas as pd
    from guidemaker_tpu_torch.knn import packed as pk
    from guidemaker_tpu_torch.knn import stream
    cfg, out, res, launches, wall, lines = design_run(dev, packed=True)
    pcount.row["launches"], ptopk.row["launches"] = launches[2:4]
    for line in lines:
        say("  " + line)
    tables = []
    for d in (codes_out, out):
        with gzip.open(os.path.join(d, "targets.csv.gz"), "rb") as fh:
            tables.append(fh.read())
    if tables[0] != tables[1]:
        raise AssertionError("packed design run: targets.csv.gz differs from "
                             "the 2-bit layout's")
    controls = check_controls(res, out, dev)
    if min(launches[2:4]) == 0 or max(launches[:2]) != 0:
        raise AssertionError(f"packed design run launches (count, top-k, "
                             f"packed count, packed top-k): {launches}")
    # the phase-2 top-k at full size against the plain packed top-k
    idx = res.processor.index
    need = list(pd.unique(res.targets["Guide sequence"]))
    q = pk.query_rows(torch.from_numpy(idx._encode_queries(need)).to(dev))
    db, n = idx._packed_db(), len(idx)
    got = stream.packed_topk(q, db, n, idx.length, cfg.knum)
    t0 = time.time()
    want = pk.packed_topk_plain(q, db, n, idx.length, cfg.knum)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    ptopk.compare(got, want, "P. aeruginosa phase-2 packed top-k")
    ms = cuda_ms(lambda: stream.packed_topk(q, db, n, idx.length, cfg.knum),
                 3)
    ptopk.row["ms"], ptopk.row["plain_ms"] = round(ms, 3), round(plain_ms, 3)
    say(f"phase 7 P. aeruginosa design run (--controls 1000 --seed {SEED}, "
        f"GUIDEMAKER_TPU_PACKED=1) on {dev}: targets.csv.gz content == "
        f"phase 6's ({len(tables[1])} bytes), {wall:.2f} s wall, controls "
        f"stage {stage_seconds(lines, 'controls')} s; launches: packed "
        f"count {launches[2]}, packed top-k {launches[3]}, 2-bit "
        f"{launches[:2]}, Levenshtein {launches[4:]}; {controls}; phase-2 "
        f"packed top-k == plain for "
        f"{len(need)} queries x {n} guides (kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms)")


def phase_leven_retention(dev, uniq):
    from guidemaker_tpu_torch import dna
    from guidemaker_tpu_torch.knn import KnnIndex, stream
    from guidemaker_tpu_torch.knn.hamming import pack_codes, unpack_keys
    ham = KnnIndex(uniq, device=dev)
    lev = KnnIndex(uniq, metric="leven", device=dev)
    masks, secs = {}, {}
    for e in (2, 3):
        t0 = time.time()
        masks[e] = lev.pass_distance_filter(uniq, e)
        secs[e] = time.time() - t0
        masks[-e] = ham.pass_distance_filter(uniq, e)
    if not np.array_equal(masks[2], masks[-2]):
        raise AssertionError("Levenshtein dist-2 mask != Hamming mask")
    if int(masks[2].sum()) != PA_RETAINED:
        raise AssertionError(f"Levenshtein dist 2 retained "
                             f"{int(masks[2].sum())}, expected {PA_RETAINED}")
    if (masks[3] & ~masks[-3]).any():
        raise AssertionError("Levenshtein dist-3 mask is not a subset of the "
                             "Hamming dist-3 mask")
    sample = np.sort(np.random.default_rng(SEED).choice(
        len(uniq), min(4096, len(uniq)), replace=False))
    q = pack_codes(torch.from_numpy(
        dna.encode_batch(list(uniq.iloc[sample]), 20)).to(dev))
    t0 = time.time()
    d2 = unpack_keys(stream.leven_topk(q, lev._db, 20, 2))[0][:, 1]
    rule = (d2 >= 3).cpu().numpy()
    t_rule = time.time() - t0
    if not np.array_equal(masks[3][sample], rule):
        raise AssertionError("Levenshtein dist-3 mask != the k=2 rule on the "
                             "sample")
    say(f"phase 8 P. aeruginosa Levenshtein retention ({len(uniq)} guides, "
        f"all against all) on {dev}: dist 2 mask == Hamming mask, "
        f"{int(masks[2].sum())} retained, {secs[2]:.3f} s; dist 3: "
        f"{int(masks[3].sum())} retained (Hamming {int(masks[-3].sum())}), "
        f"a subset of the Hamming mask, == the k=2 rule on {len(sample)} "
        f"sampled queries ({t_rule:.3f} s), {secs[3]:.3f} s")


def phase_leven_design(ltopk, dev, hamming_out, hamming_controls):
    import pandas as pd
    from guidemaker_tpu_torch.knn import stream
    from guidemaker_tpu_torch.knn.dp import leven_topk_plain
    from guidemaker_tpu_torch.knn.hamming import pack_codes, unpack_keys
    cfg, out, res, launches, wall, lines = design_run(
        dev, packed=False, extra=("--dtype", "leven"))
    ltopk.row["launches"] = launches[5]
    for line in lines:
        say("  " + line)
    if launches[5] == 0:
        raise AssertionError(f"the Levenshtein top-k kernel was not launched "
                             f"by the leven design run: launches {launches}")
    df = pd.read_csv(os.path.join(out, "targets.csv.gz"))
    ref = pd.read_csv(os.path.join(hamming_out, "targets.csv.gz"))
    if (len(df) != len(ref) or len(df) != PA_TABLE_ROWS
            or (df["dtype"] != "leven").any()):
        raise AssertionError(f"leven design table: {len(df)} rows (Hamming "
                             f"run {len(ref)}, expected {PA_TABLE_ROWS}), "
                             f"dtype {set(df['dtype'])}")
    drop = ["dtype"] + NEIGHBOR_COLS
    if not df.drop(columns=drop).equals(ref.drop(columns=drop)):
        raise AssertionError("leven design table differs from phase 6's "
                             "outside dtype and the neighbor lists")
    # the neighbor lists of a sample of the table's guides against the
    # plain DP top-k over all guides
    idx = res.processor.index
    need = pd.unique(df["Guide sequence"])
    sample = list(need[np.random.default_rng(SEED).choice(
        len(need), min(1024, len(need)), replace=False)])
    q = pack_codes(torch.from_numpy(idx._encode_queries(sample)).to(dev))
    got = stream.leven_topk(q, idx._db, idx.length, cfg.knum)
    t0 = time.time()
    want = leven_topk_plain(q, idx._db, idx.length, cfg.knum)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    ltopk.compare(got, want, "P. aeruginosa leven phase-2 top-k sample")
    ms = cuda_ms(lambda: stream.leven_topk(q, idx._db, idx.length,
                                           cfg.knum), 3)
    qa = pack_codes(torch.from_numpy(idx._encode_queries(list(need))).to(dev))
    ms_all = cuda_ms(lambda: stream.leven_topk(qa, idx._db, idx.length,
                                               cfg.knum), 1)
    d, i = (t.cpu().numpy() for t in unpack_keys(want))
    seqs = idx.seqs
    expect = {s: (";".join(seqs[j] for j in i[r] if j >= 0),
                  ";".join(str(x) for x in d[r] if x >= 0))
              for r, s in enumerate(sample)}
    rows = df[df["Guide sequence"].isin(expect)]
    for col, pos in zip(NEIGHBOR_COLS, (0, 1)):
        exp = rows["Guide sequence"].map(lambda s: expect[s][pos])
        if not (rows[col].astype(str) == exp).all():
            raise AssertionError(f"leven design column {col!r} differs from "
                                 f"the plain top-k on the sample")
    controls = check_controls(res, out, dev)
    if not res.controls.equals(hamming_controls):
        raise AssertionError("leven design run controls != phase 6's frame")
    n, nq = len(idx), len(need)
    say(f"phase 9 P. aeruginosa design run (--dtype leven --controls 1000 "
        f"--seed {SEED}, 2-bit layout) on {dev}: {len(df)} rows (expected "
        f"{PA_TABLE_ROWS}) == phase 6's table but for dtype and the neighbor "
        f"lists, {wall:.2f} s wall, "
        f"controls stage {stage_seconds(lines, 'controls')} s; launches: "
        f"2-bit {launches[:2]}, packed {launches[2:4]}, feature count "
        f"{launches[4]}, leven top-k {launches[5]}; neighbor lists == plain "
        f"DP top-k for {len(sample)} sampled guides x {n} (kernel {ms:.3f} "
        f"ms, plain {plain_ms:.3f} ms); all {nq} guides x {n} in "
        f"{ms_all:.3f} ms ({nq * n / ms_all / 1e9:.4f} T pairs/s); "
        f"{controls}; controls == phase 6's frame")
    ltopk.row["ms"], ltopk.row["plain_ms"] = round(ms, 3), round(plain_ms, 3)


def phase_leven_tiers(fcount, dev, uniq):
    from guidemaker_tpu_torch.knn import KnnIndex, stream
    from guidemaker_tpu_torch.knn.features import (feature_count_plain,
                                                   gram_rows)
    from guidemaker_tpu_torch.knn.hamming import unpack_keys
    sub = uniq.iloc[:TIER_GUIDES].reset_index(drop=True)
    idx = KnnIndex(sub, metric="leven", device=dev)
    timing = logging.getLogger("guidemaker_tpu_torch.timing")
    grab = StageGrab("[sub] leven")
    timing.addHandler(grab)
    timing.setLevel(logging.INFO)
    try:
        for c in all_counters():
            c.reset()
        t0 = time.time()
        mask = idx.pass_distance_filter(sub, 4)
        wall = time.time() - t0
        launches = [c.n for c in all_counters()]
    finally:
        timing.removeHandler(grab)
    fcount.row["launches"] = launches[4]
    if launches[4] == 0:
        raise AssertionError(f"the 3-gram count kernel was not launched at "
                             f"dist 4: launches {launches}")
    t0 = time.time()
    d2 = unpack_keys(stream.leven_topk(idx._db, idx._db, 20, 2))[0][:, 1]
    rule = (d2 >= 4).cpu().numpy()
    t_rule = time.time() - t0
    if not np.array_equal(mask, rule):
        raise AssertionError(f"dist-4 tier mask != the k=2 rule on "
                             f"{(mask != rule).sum()} guides")
    for line in grab.lines:
        say("  " + line)
    # the tier-1 count at this size, kernel and plain
    codes = torch.from_numpy(idx._codes).to(dev)
    q, db = gram_rows(codes, 0), gram_rows(codes, 3)
    got = stream.feature_count(q, db, 18, 8)
    t0 = time.time()
    want = feature_count_plain(q, db, 8)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    fcount.compare(got, want, "P. aeruginosa tier-1 3-gram count")
    ms = cuda_ms(lambda: stream.feature_count(q, db, 18, 8), 3)
    fcount.row["ms"], fcount.row["plain_ms"] = round(ms, 3), round(plain_ms, 3)
    n = TIER_GUIDES
    say(f"phase 10 Levenshtein dist 4 on the first {n} P. aeruginosa guides, "
        f"all against all, on {dev}: {int(mask.sum())} retained == the k=2 "
        f"rule ({t_rule:.3f} s), pass_distance_filter {wall:.3f} s; "
        f"launches: 2-bit {launches[:2]}, feature count {launches[4]}, leven "
        f"top-k {launches[5]}; tier-1 count kernel {ms:.3f} ms "
        f"({n * n / ms / 1e9:.4f} T pairs/s), plain {plain_ms:.3f} ms")


def phase_scored_design(topk, dev, hamming_controls, hamming_table):
    import pandas as pd
    from guidemaker_tpu_torch.score import cfd, doench
    golden = doench.predict(GOLDEN_30MERS)
    if golden.dtype != np.float32 or not (golden == GOLDEN_DOENCH).all():
        raise AssertionError(f"Doench goldens: {golden.ravel().tolist()} != "
                             f"{GOLDEN_DOENCH.ravel().tolist()}")
    cfg, out, res, launches, wall, lines = design_run(
        dev, packed=False, extra=("--knum", "3", "--controls", "1000",
                                  "--doench_efficiency_score", "--cfd_score"))
    for line in lines:
        say("  " + line)
    if min(launches[:2]) == 0:
        raise AssertionError(f"a 2-bit kernel was not launched by the scored "
                             f"design run: launches {launches}")
    df = res.targets
    written = pd.read_csv(os.path.join(out, "targets.csv.gz"))
    keep = ~hamming_table["target_seq30"].str.contains("N").to_numpy()
    if len(df) != int(keep.sum()) or len(written) != len(df):
        raise AssertionError(f"scored table: {len(df)} rows, {len(written)} "
                             f"written; phase 6's {len(hamming_table)} less "
                             f"{int((~keep).sum())} with an N is "
                             f"{int(keep.sum())}")
    eff = df["Efficiency"]
    if eff.dtype != np.float32 or not np.isfinite(eff.to_numpy()).all():
        raise AssertionError(f"Efficiency: dtype {eff.dtype}, finite "
                             f"{np.isfinite(eff.to_numpy()).all()}")
    max_cfd = df["Max CFD"].to_numpy()
    if not ((max_cfd >= 0) & (max_cfd <= 1)).all() or not (max_cfd < 1).any():
        raise AssertionError(f"Max CFD: min {max_cfd.min()} max "
                             f"{max_cfd.max()}")
    rows = np.random.default_rng(SEED).choice(
        len(df), min(CFD_SAMPLE, len(df)), replace=False)
    mm, _ = cfd.get_mm_pam_scores()
    for r in rows:
        g, sims, got = df.iloc[r][["Guide sequence", "Similar guides",
                                   "CFD Similar Guides"]]
        want = [cfd.calc_cfd(g, s, mm) for s in sims.split(";")]
        if [float(x) for x in got] != want:
            raise AssertionError(f"CFD of row {r} ({g}): {got} != {want}")
    shared = [c for c in df.columns
              if c in hamming_table.columns and c not in NEIGHBOR_COLS]
    ref = hamming_table[keep][shared].reset_index(drop=True)
    if not df[shared].reset_index(drop=True).equals(ref):
        raise AssertionError("scored table differs from phase 6's outside "
                             "the neighbor lists")
    need, ms, plain_ms = check_neighbor_lists(topk, res, 3, dev)
    topk.row["ms_k3"], topk.row["plain_ms_k3"] = (round(ms, 3),
                                                  round(plain_ms, 3))
    controls = check_controls(res, out, dev)
    if not res.controls.equals(hamming_controls):
        raise AssertionError("scored design run controls != phase 6's frame")
    say(f"phase 11 P. aeruginosa scored design run (--knum 3 --controls 1000 "
        f"--seed {SEED} --doench_efficiency_score --cfd_score, 2-bit layout) "
        f"on {dev}: {len(df)} rows (phase 6's {len(hamming_table)} less "
        f"{int((~keep).sum())} with an N in target_seq30), "
        f"{wall:.2f} s wall, doench scoring "
        f"{stage_seconds(lines, 'doench scoring')} s, cfd scoring "
        f"{stage_seconds(lines, 'cfd scoring')} s, controls stage "
        f"{stage_seconds(lines, 'controls')} s; Doench goldens float32-exact;"
        f" Efficiency float32 finite, Max CFD in [{max_cfd.min():g}, "
        f"{max_cfd.max():g}]; CFD lists == scalar calc_cfd on {CFD_SAMPLE} "
        f"rows; {len(shared)} shared columns == phase 6's; launches: count "
        f"{launches[0]}, top-k {launches[1]}, packed {launches[2:4]}, "
        f"Levenshtein {launches[4:]}; neighbor lists == plain top-k at k 3 "
        f"for {len(need)} queries x {len(res.processor.index)} guides "
        f"(kernel {ms:.3f} ms, plain {plain_ms:.3f} ms); {controls}; "
        f"controls == phase 6's frame")


class AppStatus:
    """The ``st`` that the app's ``run_command`` reports to: a log line."""

    @staticmethod
    def info(msg):
        say("  app: " + msg[:300])

    @staticmethod
    def error(msg):
        say("  app error: " + msg)


def phase_app(dev):
    import pandas as pd
    from guidemaker_tpu_torch import app, definitions
    demo = os.path.join(definitions.DATA_DIR, app.DEMO_GENOMES[0])
    tables, secs = {}, {}
    for device in ("cuda", "cpu"):
        work = tempfile.mkdtemp(prefix=f"gm_app_{device}_")
        args = app.build_cli_args(
            workdir=work, logfile=os.path.join(work, "guidemaker.log"),
            genbank=[demo], restriction_enzymes=["NGRT"], device=device)
        t0 = time.time()
        rc = app.run_command(AppStatus, args)
        secs[device] = time.time() - t0
        if rc != 0:
            raise AssertionError(f"the app's command on {device} exited {rc}")
        with gzip.open(os.path.join(work, "targets.csv.gz"), "rb") as fh:
            tables[device] = fh.read()
        head = pd.read_csv(io.BytesIO(tables[device]), nrows=1)
        missing = {"Efficiency", "CFD Similar Guides", "Max CFD"} - set(head)
        pages = [p for p in os.listdir(work) if p.endswith(".html")]
        accessions = set(pd.read_csv(io.BytesIO(tables[device]))["Accession"])
        if missing or sorted(pages) != sorted(f"{a}.html" for a in accessions):
            raise AssertionError(f"the app's run on {device}: score columns "
                                 f"missing {missing}, pages {pages}")
        for page in pages:
            with open(os.path.join(work, page)) as fh:
                if "vega-lite/v5.json" not in fh.read():
                    raise AssertionError(f"{page} holds no Vega-Lite spec")
        n_ctl = len(pd.read_csv(os.path.join(work, "controls.csv.gz")))
        if n_ctl != 10:
            raise AssertionError(f"the app's run on {device}: {n_ctl} "
                                 f"controls, expected 10")
    if tables["cuda"] != tables["cpu"]:
        raise AssertionError("the app's targets.csv.gz differs between the "
                             "card and the CPU")
    say(f"phase 12 the app's command on the C. ruddii demo (knum 3, "
        f"--controls 10, --plot, both scores): exit 0 on cuda "
        f"({secs['cuda']:.2f} s) and on cpu ({secs['cpu']:.2f} s); "
        f"targets.csv.gz with the score columns, equal byte for byte "
        f"({tables['cuda'].count(b'\n') - 1} rows); {len(pages)} Vega-Lite "
        f"page(s); 10 controls each")


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
    pcount = Kernel("packed_count",
                    "guidemaker_tpu_torch/csrc/packed_count.cu",
                    "guidemaker_tpu/knn/pallas_packed.py:182")
    ptopk = Kernel("packed_topk", "guidemaker_tpu_torch/csrc/packed_topk.cu",
                   "guidemaker_tpu/knn/pallas_packed.py:264")
    fcount = Kernel("feature_count",
                    "guidemaker_tpu_torch/csrc/feature_count.cu",
                    "guidemaker_tpu/knn/pallas_stream.py:164 (3-gram form, "
                    "guidemaker_tpu/knn/leven.py:684, 786)")
    ltopk = Kernel("leven_topk", "guidemaker_tpu_torch/csrc/leven_topk.cu",
                   "guidemaker_tpu/knn/leven.py:59, "
                   "guidemaker_tpu/knn/leven.py:126 (XLA, not Pallas)")
    phase_kernels(count, topk, dev)
    phase_packed_kernels(pcount, ptopk, dev)
    phase_leven_kernels(fcount, ltopk, dev)
    phase_cruddii(dev)
    t0 = time.time()
    uniq = pa_guides()
    phase_retention(count, pcount, dev, uniq, time.time() - t0)
    hamming_out, hamming_controls, hamming_table = phase_design(count, topk,
                                                               dev)
    phase_design_packed(pcount, ptopk, dev, hamming_out)
    phase_leven_retention(dev, uniq)
    phase_leven_design(ltopk, dev, hamming_out, hamming_controls)
    phase_leven_tiers(fcount, dev, uniq)
    phase_scored_design(topk, dev, hamming_controls, hamming_table)
    phase_app(dev)
    say(json.dumps({"kernels": [count.row, topk.row, pcount.row, ptopk.row,
                                fcount.row, ltopk.row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
