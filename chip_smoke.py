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
   kernel.

The line before the last is a JSON object describing each kernel (launches
in the design run of its layout, phase 6 or 7, the largest error seen, its
time and its plain version's time in ms at full P. aeruginosa size); the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or
outside a checkout, it exits non-zero and prints no result.
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


def phase_retention(count, pcount, dev):
    import pandas as pd
    from guidemaker_tpu_torch.io import parse_genbank
    from guidemaker_tpu_torch.knn import KnnIndex, stream
    from guidemaker_tpu_torch.knn import packed as pk
    from guidemaker_tpu_torch.knn.hamming import hamming_count_plain
    from guidemaker_tpu_torch.scan import PamTarget
    t0 = time.time()
    recs = [r.upper() for r in parse_genbank(PA_GBK)]
    targets = PamTarget("NGG", "5prime", "hamming").find_targets(recs, 20)
    uniq = pd.Series(pd.unique(targets["target"]), dtype="str")
    t_host = time.time() - t0
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
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("[stage]"):
            self.lines.append(msg)


def design_run(dev, packed: bool):
    """The default P. aeruginosa design run with --controls 1000 --seed
    SEED, through the CLI's parser and run_pipeline, with every launch
    count set to 0 just before it and read just after."""
    from guidemaker_tpu_torch import cli
    from guidemaker_tpu_torch.knn import stream
    from guidemaker_tpu_torch.pipeline import run_pipeline
    out = tempfile.mkdtemp(prefix="gm_smoke_")
    argv = ["--genbank", PA_GBK, "--pamseq", "NGG", "--outdir", out,
            "--seed", str(SEED), "--log", os.path.join(out, "run.log")]
    cfg = cli.config_from_args(cli.myparser().parse_args(argv))
    timing = logging.getLogger("guidemaker_tpu_torch.timing")
    grab = StageGrab()
    timing.addHandler(grab)
    timing.setLevel(logging.INFO)
    counters = (stream.count_launches, stream.topk_launches,
                stream.packed_count_launches, stream.packed_topk_launches)
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


def phase_design(count, topk, dev):
    import pandas as pd
    from guidemaker_tpu_torch.io import parse_genbank
    from guidemaker_tpu_torch.knn import stream
    from guidemaker_tpu_torch.knn.hamming import (hamming_topk_plain,
                                                  pack_codes, unpack_keys)
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
        f"count {launches[0]}, top-k {launches[1]}, packed {launches[2:]}; "
        f"neighbor lists == plain top-k for {len(need)} queries x "
        f"{len(idx)} guides (kernel {ms:.3f} ms, plain {plain_ms:.3f} ms); "
        f"{controls}; the same frame again from a second search with the "
        f"same seed ({t_again:.2f} s)")
    return out


def phase_design_packed(pcount, ptopk, dev, codes_out):
    import pandas as pd
    from guidemaker_tpu_torch.knn import packed as pk
    from guidemaker_tpu_torch.knn import stream
    cfg, out, res, launches, wall, lines = design_run(dev, packed=True)
    pcount.row["launches"], ptopk.row["launches"] = launches[2:]
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
    if min(launches[2:]) == 0 or max(launches[:2]) != 0:
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
        f"{launches[:2]}; {controls}; phase-2 packed top-k == plain for "
        f"{len(need)} queries x {n} guides (kernel {ms:.3f} ms, plain "
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
    pcount = Kernel("packed_count",
                    "guidemaker_tpu_torch/csrc/packed_count.cu",
                    "guidemaker_tpu/knn/pallas_packed.py:182")
    ptopk = Kernel("packed_topk", "guidemaker_tpu_torch/csrc/packed_topk.cu",
                   "guidemaker_tpu/knn/pallas_packed.py:264")
    phase_kernels(count, topk, dev)
    phase_packed_kernels(pcount, ptopk, dev)
    phase_cruddii(dev)
    phase_retention(count, pcount, dev)
    codes_out = phase_design(count, topk, dev)
    phase_design_packed(pcount, ptopk, dev, codes_out)
    say(json.dumps({"kernels": [count.row, topk.row, pcount.row,
                                ptopk.row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
