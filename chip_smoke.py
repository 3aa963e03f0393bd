#!/usr/bin/env python3
"""Smoke run of guidemaker_tpu_torch, the PyTorch/CUDA port, on one card.

Usage, from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build: the CUDA kernels of guidemaker_tpu_torch/csrc, one nvcc per
   source, all started together; ptxas's registers, spills and static
   shared memory for every kernel (each kcap of the top-k) and its wgmma
   notes, and by ``cuobjdump -sass`` the tensor-core instructions: IGMMA
   (int8 wgmma) in the 2-bit and the packed count and in every kcap of
   both top-k kernels, BGMMA (1-bit wgmma) in the 3-gram count at each of
   its 8 k256 step counts; none may hold mma.sync (IMMA, BMMA), POPC or
   IDP4A (dp4a), ptxas may serialise none's products, and none may spill
   on the main path (the counts, top-k kcap <= 8, the 3-gram count at every
   step count); every wgmma kernel's LOP3, SHF, IMAD, BAR, SYNCS (mbarrier)
   and WARPGROUP counts;
   then the tensor-core rate probe (csrc/mma_rate.cu): s8 m16n8k32 and b1
   m16n8k256 mma.sync chains and the s8 wgmma m64n128k32 and b1 wgmma
   m64n128k256 chains the counts issue, each kind's operations a second
   and SASS opcode, the b1 wgmma's ratio to the s8 wgmma and to the b1
   mma.sync, from the mma.sync ratio the card's 1-bit rate that the 3-gram
   count's bound uses, and the wgmma rates that phases 5 and 10 read the
   counts against;
3. each kernel against its plain PyTorch version on the card, exact
   equality: the 2-bit kernels on random codes with N bases and duplicated
   rows (4096 queries x 200,000 guides, L 20 and 27), the packed-pair
   kernels on N-free codes with duplicated rows (4096 x 200,001, odd, L 20
   and 21), every editdist and k of the main path and its edges; 3b, the
   2-bit count and top-k kernels at their tiling's edges (L 1, 8, 20, 24,
   25, 27 and 32, the count's bias lane spare at all but 8, 24 and 32;
   for the count nq 1, 63, 64, 65, 255, 257 and 4095 (m64 tiles, 256-query
   blocks) and nd 129 and 200,003, for the top-k nq 1, 15 and 4095 and
   nd 200,003; a query block ending in N and an all-N block; editdist 0-3
   and L; k 1, 2, 3, 5, 20 and 128);
   3d, the packed count and top-k kernels at their tiling's edges (L 1,
   10, 11, 16, 20 and 21; nq 1, 63, 64, 65, 255, 256, 257 and 4095 (m64
   tiles, 256-query blocks); nd 200,002 and 200,003; editdist 0-3, the
   first with 3L - 4 editdist + 1 <= 0, and L; k 1, 2, 3, 5, 20 and 128);
4. the C. ruddii parity configuration (tests/test_parity_e2e.py) on the
   card, byte for byte against tests/test_data/golden_pretty_cruddii.csv.gz;
5. P. aeruginosa retention (NGG/5prime/20, all unique guides against all,
   dist 2) in both index layouts: 1,139,266 guides retained each time, and
   the 2-bit and packed count kernels equal to their plain versions, and
   to each other, at full size, each kernel's time against its bound and
   against the product it issues at the probe's wgmma rate (the 2-bit
   count's one-hot rows, K 96; the packed count's tetrahedral B rows,
   K 64); then each at the control search's triage shape (2^19 random
   candidates against the index, editdist 7 and 2, exact on 4,096 rows);
6. the default P. aeruginosa design run with --controls 1000 and a fixed
   --seed, through the CLI's parser and ``run_pipeline``, in the 2-bit
   layout: its stage table, its rows, its neighbor lists against the
   plain top-k on the card, its 1000 controls (each at Hamming distance
   >= 7, equal to the plain k=1 distance, named Cont-<md5>, the same frame
   again from a second search with the same seed), and the launch count of
   both 2-bit kernels (> 0); then the top-k's time on the run's phase-2
   queries at kcap 1, 2, 4, 8, 16 and 32, each with its bound and beside
   the mma.sync design's time (each list the first columns of the kcap-32
   list, whose first knum columns are the plain top-k's);
7. the same run with GUIDEMAKER_TPU_PACKED=1: the same targets table, the
   same control invariants, both packed kernels launched and neither 2-bit
   kernel; its controls join and wall; then the packed top-k on the run's
   phase-2 queries against the plain packed top-k, and its time at kcap
   1, 2, 4, 8, 16 and 32, each with its bound and beside its mma.sync
   design's time, as in phase 6;
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
   own rather than a smoke phase; then one timed tier-1 count at genome
   size (every unique guide, t 3, thresh 8), equal to the plain count on a
   fixed sample of 4,096 queries, with both its bounds and the time its
   b1 wgmma product takes at the probe's rate;
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
   CUDA, so they are not compared);
13. the sharded backend (``knn/sharded.py``) on virtual shards of the one
   card, every merge through a world-size-1 NCCL group started by
   ``init_distributed`` on a free 127.0.0.1 port: dist-2 retention of all
   unique P. aeruginosa guides on a (1, 4) mesh, the mask and the count
   vector equal to phase 5's and K1 launched once a shard; phase 6's
   neighbor lists on a (2, 2) mesh, equal to its keys, K2 launched once a
   (block, shard); the NCCL ``all_gather`` and ``all_reduce`` times; the
   Levenshtein dist-3 mask on a (2, 2) mesh equal to phase 8's, the dist-4
   tiers on phase 10's guides on a (1, 4) mesh equal to its mask (K1'
   launched), and the Myers top-k of 4,096 sampled guides on the (2, 2)
   mesh equal to the unsharded kernel's (K6 launched once a (block,
   shard)); the default design run with GUIDEMAKER_TPU_KERNEL=sharded
   (``auto_mesh``: 1 x 1 on one card), its targets.csv.gz byte for byte
   phase 6's, with phase 6's control invariants.  Every launch count is
   set to 0 just before each of these runs and read just after.  One card
   measures no multi-card speed;
14. two processes on the one card: the script starts itself twice as a
   worker (``--rank R PORT``), with LOCAL_RANK 0 and 1 and
   LOCAL_WORLD_SIZE 2, so that ``local_devices`` gives both ``cuda:0``.
   Each starts a gloo group of 2 on a free 127.0.0.1 port (NCCL refuses
   two ranks on one card), so ``init_distributed`` is then a no-op, and
   runs phase 6's design run with no GUIDEMAKER_TPU_KERNEL: the group
   alone shards the index over the ranks.  Rank 0's targets.csv.gz equals
   phase 6's byte for byte, rank 1 writes nothing, both ranks return the
   same table and controls, the controls equal phase 13's sharded design
   run's and hold phase 6's invariants, K1 and K2 launch on each rank
   (launch counts set to 0 just before the run and read just after), and
   both ranks record the same ``all_gather``/``all_reduce``/``broadcast``
   calls, none begun while another was in flight; then an unseeded
   C. ruddii design run gives equal controls on both ranks.  Each rank's
   wall, stage table and gloo collectives' count and ms are printed: two
   processes sharing one card, not a scaling figure.  A rank that fails
   or outlasts 300 s fails the phase.

Phase 3c holds the two Levenshtein kernels against their plain versions:
the 3-gram count on the rows of random codes with N bases and duplicated
rows (4096 x 200,000, L 20 and 27, t 3 and 4, both directions, the
threshold's edges), and the Myers top-k on codes with N bases, duplicates
and near-identical pairs (LEVEN_SHAPE, L 20, 27 and 32, k 1, 2, 5, 64 and
128); then the 3-gram count at its tiling's edges (FEATURE_EDGE_WORDS,
nq 1, 63, 64, 65, 255, 257 and 4095, nd 200,003, an all-N block,
thresholds 0, G - 3t - 1, G - 1 and G, both directions).

The line before the last is a JSON object describing each kernel (launches
in the path that uses it: phase 6 or 7 for the Hamming kernels, phase 9
for the Myers top-k, phase 10 for the 3-gram count; the largest error
seen; its time and its plain version's time in ms at the sizes its phase
prints, and for the 2-bit top-k also at k 3 from phase 11 and at each
kcap of phase 6's sweep, for the packed top-k at each kcap of phase 7's
sweep, for the 3-gram count also at genome size (``ms_genome``); its
bound at the shape of its time, the larger of its operations at the
card's peak for their type and its bytes at the memory rate, and which of
the two sets it; for the 3-gram count the smaller of its int8 and 1-bit
bounds, named by ``bound_kind``; ``library_ms`` null, as no single
PyTorch call computes a thresholded count or a packed-key top-k); the
last line
is ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or outside a checkout, it exits non-zero and prints no result.
"""
import gzip
import hashlib
import io
import json
import logging
import os
import re
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
#: the 2-bit kernels' tiling edges (phase 3b): guide lengths at its k32
#: padding edges, query counts at its 256-query block edges, and a database
#: ragged against its 128-row tiles
EDGE_LENGTHS = (1, 8, 20, 24, 25, 27, 32)
EDGE_NQ = (1, 15, 4095)
EDGE_ND = 200_003
#: the edges of the counts on the ring block (the 2-bit count, phase 3b;
#: the 3-gram count's queries, phase 3c): its m64 tiles of queries (63, 64,
#: 65), its 256-query blocks (255, 257), and databases ragged against its
#: 128-row tile
COUNT_EDGE_NQ = (1, 63, 64, 65, 255, 257, 4095)
COUNT_EDGE_ND = (129, 200_003)
#: the top-k's list edges (phase 3b): kcap 1, 2, 4, 8, 32 and 128
EDGE_KS = (1, 2, 3, 5, 20, 128)
#: the packed kernels' tiling edges (phase 3d): guide lengths at their k32
#: step edges (K = 32 ceil((3L + 1) / 32) steps from 1 to 2 at L 10/11,
#: 3L % 4, the shift of the odd B rows, takes each value, and lane 3L is
#: the top-k's bias lane K - 1 at L 21), and databases ragged against
#: their 64-row tiles of pair rows, even and odd
PACKED_EDGE_LENGTHS = (1, 10, 11, 16, 20, 21)
PACKED_EDGE_ND = (200_002, 200_003)
#: the packed kernels' query edges (phase 3d): their m64 tiles (63, 64, 65)
#: and 256-query blocks (255, 256, 257)
PACKED_EDGE_NQ = (1, 63, 64, 65, 255, 256, 257, 4095)
#: the 3-gram count's tiling edges (phase 3c): row widths G = L - 2 words
#: at its k256 step edges (a step is 4 words; 1..8 steps)
FEATURE_EDGE_WORDS = (1, 4, 5, 8, 17, 18, 25, 29, 30)
#: the kcaps of phase 6's and phase 7's top-k sweeps
SWEEP_KCAPS = (1, 2, 4, 8, 16, 32)
#: the 2-bit top-k's ms at each kcap of SWEEP_KCAPS on the phase-2 lists
#: of the design run, as its mma.sync design took them before it moved to
#: wgmma (PERF.md section 6; NVIDIA H100 80GB HBM3, 700.00 W), printed
#: beside phase 6's sweep
MMA_SYNC_KCAP_MS = {1: 34.383, 2: 34.113, 4: 34.481, 8: 35.026,
                    16: 51.295, 32: 60.306}
#: the packed top-k's ms at each kcap of SWEEP_KCAPS on the phase-2 lists,
#: as its mma.sync design took them before it moved to wgmma (PERF.md
#: section 6; NVIDIA H100 80GB HBM3, 700.00 W), printed beside phase 7's
#: sweep
PACKED_MMA_SYNC_KCAP_MS = {1: 33.430, 2: 27.690, 4: 28.326, 8: 29.663,
                           16: 46.219, 32: 55.629}
#: an H100 SXM's peaks (NVIDIA's data sheet, dense): int8 tensor-core
#: operations, device-memory bytes, and INT32 operations (64 INT32 lanes a
#: SM against the 128 float32 lanes of the 67 TFLOP/s float32 peak, in
#: which an FMA counts 2)
INT8_OPS_PER_S = 1979e12
BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
#: integer operations of one Myers step, a (pair, base), with 3-input
#: logic fused (csrc/leven_topk.cu:myers writes 16)
MYERS_OPS = 10


def say(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(ops, rate, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``ops`` operations at ``rate`` and ``nbytes`` (each input read once,
    each output written once) at its memory rate, and which of the two
    sets it."""
    t_ops = ops / rate * 1e3
    t_bytes = nbytes / BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def feature_bounds(nq, nd, n_words, nbytes, b1_peak):
    """{"int8": (ms, by), "1-bit": (ms, by)}: the bounds of the 3-gram count
    of nq x nd rows of n_words words.  Either way the function is
    2 * nq * nd * 64 n_words operations, 64 lanes a gram position: the JAX
    kernel's int8 product at 1,979 TOP/s, or the 1-bit product at
    ``b1_peak``, the card's 1-bit rate taken as the probe's b1/s8 ratio of
    operations (phase 2) times 1,979 TOP/s, as the data sheet gives none."""
    ops = 2 * nq * nd * 64 * n_words
    return {"int8": bound_ms(ops, INT8_OPS_PER_S, nbytes),
            "1-bit": bound_ms(ops, b1_peak, nbytes)}


def feature_product_ms(nq, nd, n_words, b1_wgmma):
    """ms that the 3-gram count's own product takes at ``b1_wgmma``, the
    probe's b1 wgmma rate (phase 2): 2 * nq * nd * 256 S bit operations,
    its rows padded to S = ceil(n_words / 4) whole k256 steps."""
    return 2 * nq * nd * 256 * -(-n_words // 4) / b1_wgmma * 1e3


def least_bound(bounds):
    """(ms, by, kind) of the smallest of ``bounds`` (feature_bounds)."""
    kind = min(bounds, key=lambda k: bounds[k][0])
    return (*bounds[kind], kind)


def hamming_ops(nq, nd, length):
    """The int8 operations that the Hamming function of nq x nd pairs of
    length-L guides needs: a dot of 3L lanes a pair, each base a vertex of
    the tetrahedron in {-1,+1}^3 (the packed rows' code; the 2-bit kernels'
    one-hot product computes the same function with 4L)."""
    return 2 * nq * nd * 3 * length


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
        # library_ms stays null: no single PyTorch call computes a
        # thresholded match count or a packed-key top-k
        self.row = {"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": 0, "max_abs_err": 0,
                    "ms": None, "plain_ms": None, "bound_ms": None,
                    "bound_by": None, "library_ms": None}

    def timed(self, ms, plain_ms, ops, rate, nbytes):
        """Its time and its plain version's, and its bound at the same
        shape (:func:`bound_ms`)."""
        return self.timed_bound(ms, plain_ms, *bound_ms(ops, rate, nbytes))

    def timed_bound(self, ms, plain_ms, bound, by, **extra):
        """Its time and its plain version's, and the bound ``bound`` ms set
        by ``by`` at the same shape, with the keys ``extra``."""
        self.row.update(ms=round(ms, 3), plain_ms=round(plain_ms, 3),
                        bound_ms=round(bound, 4), bound_by=by, **extra)
        return self.row["bound_ms"]

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
            times["splits"] = topk_ms_by_splits(
                topk, q, db, 20, 5, hamming_topk_plain(q, db, 20, 5))
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
    bound = bound_ms(hamming_ops(4096, 200_000, 20), INT8_OPS_PER_S,
                     16 * (4096 + 200_000) + 4 * 4096 * 5)[0]
    say("phase 3 kernels vs plain: exact at nq=4096 nd=200000 L=20,27 "
        "editdist 0,1,2,3,L k 1,2,5,20,128 and k>nd; L=20 times: "
        f"count {times['count'][0]:.4f} ms (plain {times['count'][1]:.3f} "
        f"ms), top-k k=5 {times['topk'][0]:.3f} ms "
        f"(plain {times['topk'][1]:.3f} ms), int8 bound of either "
        f"{bound:.4f} ms; top-k k=5 by database splits (the wrapper plans "
        f"the first): " + ", ".join(f"{n} {t:.3f} ms" for n, t in
                                   times["splits"].items()))


def topk_ms_by_splits(topk, q, db, length, k, want):
    """The top-k's ms at the wrapper's split plan and at a quarter and a
    sixteenth of it, each result equal to the plain top-k ``want``."""
    from guidemaker_tpu_torch.knn import stream
    real = stream._n_splits
    plan = real(q.shape[0], db.shape[0], q.device)
    out = {}
    try:
        for n in dict.fromkeys((plan, -(-plan // 4), -(-plan // 16))):
            stream._n_splits = lambda *_, n=n: n
            topk.compare(stream.hamming_topk(q, db, length, k), want,
                         f"top-k k={k} at {n} database splits")
            out[n] = cuda_ms(lambda: stream.hamming_topk(q, db, length, k), 5)
    finally:
        stream._n_splits = real
    return out


def phase_edges(count, topk, dev):
    """The 2-bit count and top-k kernels against their plain versions at
    their tiling's edges: k32 padding and the count's bias lane
    (EDGE_LENGTHS: none is spare at L 8, 24 and 32), query tiles and blocks
    (COUNT_EDGE_NQ for the count, EDGE_NQ for the top-k), databases ragged
    against their tiles (COUNT_EDGE_ND, EDGE_ND), a block whose queries
    end in N, an all-N block, every editdist edge and every list edge
    (EDGE_KS)."""
    from guidemaker_tpu_torch.knn import stream
    from guidemaker_tpu_torch.knn.hamming import (hamming_count_plain,
                                                  hamming_topk_plain,
                                                  pack_codes)
    rng = np.random.default_rng(97)
    n_count = n_topk = 0
    for length in EDGE_LENGTHS:
        qn, dbn = random_codes(rng, max(COUNT_EDGE_NQ), EDGE_ND, length)
        qn[256:512, max(1, length - 9):] = 4
        qn[512:768] = 4
        q = pack_codes(torch.from_numpy(qn).to(dev))
        db = pack_codes(torch.from_numpy(dbn).to(dev))
        for nd in COUNT_EDGE_ND:
            for nq in COUNT_EDGE_NQ:
                for e in sorted({e for e in (0, 1, 2, 3, length)
                                 if e <= length}):
                    count.compare(
                        stream.hamming_count(q[:nq], db[:nd], length, e),
                        hamming_count_plain(q[:nq], db[:nd], length, e),
                        f"count L={length} nq={nq} nd={nd} editdist={e}")
                    n_count += 1
        for nq in EDGE_NQ:
            for k in EDGE_KS:
                topk.compare(stream.hamming_topk(q[:nq], db, length, k),
                             hamming_topk_plain(q[:nq], db, length, k),
                             f"top-k L={length} nq={nq} k={k}")
                n_topk += 1
    say(f"phase 3b count kernel vs plain at its tiling edges: exact in "
        f"{n_count} comparisons, L {EDGE_LENGTHS}, nq {COUNT_EDGE_NQ}, nd "
        f"{COUNT_EDGE_ND}, editdist 0,1,2,3,L, an all-N block and a block "
        f"ending in N")
    say(f"phase 3b top-k kernel vs plain at its tiling edges: exact in "
        f"{n_topk} comparisons, L {EDGE_LENGTHS}, nq {EDGE_NQ}, nd "
        f"{EDGE_ND}, k {EDGE_KS}, an all-N block and a block ending in N")


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
    bound = bound_ms(hamming_ops(4096, nd, 20), INT8_OPS_PER_S,
                     128 * (4096 + (nd + 1) // 2) + 4 * 4096 * 5)[0]
    say("phase 3 packed kernels vs plain (and vs the 2-bit kernels): exact "
        "at nq=4096 nd=200001 L=20,21 editdist 0,1,2,3,L k 1,2,5,20,128 and "
        "k>nd; L=20 ms: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                      times.items())
        + f"; int8 bound of either {bound:.4f} ms")


def phase_packed_edges(pcount, ptopk, dev):
    """The packed count and top-k kernels against their plain versions at
    their tiling's edges: k32 steps (PACKED_EDGE_LENGTHS), query tiles and
    blocks (PACKED_EDGE_NQ), databases ragged against their tiles with an
    odd slot left over or not (PACKED_EDGE_ND), every editdist edge (0-3,
    the first with T + 1 <= 0, where a padding slot passes the count's
    gate, and L) and every list edge (EDGE_KS)."""
    from guidemaker_tpu_torch.knn import packed as pk
    from guidemaker_tpu_torch.knn import stream
    rng = np.random.default_rng(98)
    n_count = n_topk = 0
    for length in PACKED_EDGE_LENGTHS:
        first_neg = -(-(3 * length + 1) // 4)
        edits = sorted({e for e in (0, 1, 2, 3, first_neg, length)
                        if e <= length})
        for nd in PACKED_EDGE_ND:
            qn, dbn = random_codes(rng, max(PACKED_EDGE_NQ), nd,
                                   length, with_n=False)
            q = pk.query_rows(torch.from_numpy(qn).to(dev))
            db = pk.db_rows(torch.from_numpy(dbn).to(dev))
            for nq in PACKED_EDGE_NQ:
                for e in edits:
                    pcount.compare(
                        stream.packed_count(q[:nq], db, nd, length, e),
                        pk.packed_count_plain(q[:nq], db, nd, length, e),
                        f"packed count L={length} nd={nd} nq={nq} "
                        f"editdist={e}")
                    n_count += 1
                for k in EDGE_KS:
                    ptopk.compare(
                        stream.packed_topk(q[:nq], db, nd, length, k),
                        pk.packed_topk_plain(q[:nq], db, nd, length, k),
                        f"packed top-k L={length} nd={nd} nq={nq} k={k}")
                    n_topk += 1
    say(f"phase 3d packed count and top-k kernels vs plain at their tiling "
        f"edges: exact in {n_count} and {n_topk} comparisons, L "
        f"{PACKED_EDGE_LENGTHS}, nq {PACKED_EDGE_NQ}, nd {PACKED_EDGE_ND}, "
        f"editdist 0,1,2,3,ceil((3L+1)/4),L, k {EDGE_KS}")


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


def phase_leven_kernels(fcount, ltopk, dev, b1_peak):
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
    f_bounds = feature_bounds(fq, fd, 18, 8 * 18 * (fq + fd) + 4 * fq,
                              b1_peak)
    l_bound = bound_ms(MYERS_OPS * nq * nd * 20, INT32_OPS_PER_S,
                       16 * (nq + nd) + 4 * nq * 5)[0]
    say(f"phase 3c Levenshtein kernels vs plain: feature count exact at "
        f"{fq} x {fd} L=20,27 t=3,4 both directions 4 thresholds; leven "
        f"top-k exact at {nq} x {nd} L=20,27,32 k 1,2,5,64,128; L=20 ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f"; bounds: feature count {f_bounds['int8'][0]:.4f} ms (int8), "
        f"{f_bounds['1-bit'][0]:.4f} ms (1-bit), leven top-k "
        f"{l_bound:.4f} ms (INT32)")


def phase_feature_edges(fcount, dev):
    """The 3-gram count kernel against its plain version at its tiling's
    edges: rows of G words at every k256 step edge (FEATURE_EDGE_WORDS),
    its m64 tiles and 256-query blocks (COUNT_EDGE_NQ), a database ragged
    against its 128-row tiles (EDGE_ND), an all-N query block (zero rows),
    the thresholds 0, G - 3t - 1, G - 1 and G, and both dilation
    directions (t 3)."""
    from guidemaker_tpu_torch.knn import stream
    from guidemaker_tpu_torch.knn.features import (feature_count_plain,
                                                   gram_rows)
    rng = np.random.default_rng(99)
    t, n = 3, 0
    for glen in FEATURE_EDGE_WORDS:
        qn, dbn = random_codes(rng, max(COUNT_EDGE_NQ), EDGE_ND, glen + 2)
        qn[512:768] = 4
        qc, dbc = (torch.from_numpy(a).to(dev) for a in (qn, dbn))
        threshs = sorted({x for x in (0, glen - 3 * t - 1, glen - 1, glen)
                          if x >= 0})
        for way, q, db in (("1", gram_rows(qc, 0), gram_rows(dbc, t)),
                           ("2", gram_rows(qc, t), gram_rows(dbc, 0))):
            for nq in COUNT_EDGE_NQ:
                for thresh in threshs:
                    fcount.compare(
                        stream.feature_count(q[:nq], db, glen, thresh),
                        feature_count_plain(q[:nq], db, thresh),
                        f"feature count G={glen} direction {way} nq={nq} "
                        f"thresh={thresh}")
                    n += 1
    say(f"phase 3c feature count kernel vs plain at its tiling edges: exact "
        f"in {n} comparisons, G {FEATURE_EDGE_WORDS}, nq {COUNT_EDGE_NQ}, nd "
        f"{EDGE_ND}, an all-N block, thresh 0,G-3t-1,G-1,G (t {t}), both "
        f"directions")


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


def phase_retention(count, pcount, dev, uniq, t_host, wgmma_rate):
    from guidemaker_tpu_torch.knn import KnnIndex, stream
    from guidemaker_tpu_torch.knn import packed as pk
    from guidemaker_tpu_torch.knn.hamming import hamming_count_plain
    counts, masks = {}, {}
    for layout, packed in (("2-bit", False), ("packed", True)):
        idx = KnnIndex(uniq, device=dev, packed=packed)
        t0 = time.time()
        masks[layout] = idx.pass_distance_filter(uniq, 2)
        retained = int(masks[layout].sum())
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
            q = db = idx._db
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
        bound = kern.timed(ms, plain_ms, hamming_ops(n, n, 20),
                           INT8_OPS_PER_S, q.numel() * q.element_size()
                           + db.numel() * db.element_size() + 4 * n)
        # the product the kernel issues at L 20: K1's one-hot rows, 3 k32
        # steps of 32 bytes; K4's tetrahedral B rows, 2 steps
        k_bytes = 64 if packed else 96
        name = "tetrahedral" if packed else "one-hot"
        product_ms = 2 * n * n * k_bytes / wgmma_rate * 1e3
        say(f"phase 5 P. aeruginosa retention, {layout} layout: {retained} of "
            f"{n} guides retained (expected {PA_RETAINED}); kernel == plain "
            f"at {n} x {n}; kernel {ms:.3f} ms ({n * n / ms / 1e9:.4f} T "
            f"pairs/s, {bound / ms:.3f} of its {bound:.2f} ms int8 bound; "
            f"its {name} product (2 n^2 x {k_bytes} operations) at the "
            f"probe's wgmma rate {product_ms:.2f} ms, "
            f"{product_ms / ms:.4f} of the kernel's time), plain "
            f"{plain_ms:.3f} ms; pass_distance_filter {t_filter:.3f} s")
        control_chunk_times(kern, db, n, packed)
        del idx, q, db, got, want
    pcount.compare(counts["packed"], counts["2-bit"],
                   "P. aeruginosa packed count == 2-bit count")
    say(f"phase 5 packed count vector == 2-bit count vector; parse+scan "
        f"{t_host:.2f} s")
    return masks["2-bit"], counts["2-bit"]


def control_chunk_times(kern, db, nd, packed):
    """The count kernel of a layout (K1, or K4 if ``packed``) at the control
    search's triage shape: one chunk of 2^19 random candidates
    (targets.py:_control_chunk_rows) against the index's nd guides (rows
    ``db``), at the triage's editdist 7 and at retention's 2; each equal to
    the plain count on its first 4,096 rows, with its time and its
    bound."""
    from guidemaker_tpu_torch.knn import packed as pk
    from guidemaker_tpu_torch.knn import stream
    from guidemaker_tpu_torch.knn.hamming import (hamming_count_plain,
                                                  pack_codes)
    rng = np.random.default_rng(SEED)
    codes = torch.from_numpy(rng.integers(
        0, 4, size=(1 << 19, 20)).astype(np.uint8)).to(db.device)
    if packed:
        q = pk.query_rows(codes)
        run = lambda q, e: stream.packed_count(q, db, nd, 20, e)  # noqa
        plain = lambda q, e: pk.packed_count_plain(q, db, nd, 20, e)  # noqa
    else:
        q = pack_codes(codes)
        run = lambda q, e: stream.hamming_count(q, db, 20, e)  # noqa: E731
        plain = lambda q, e: hamming_count_plain(q, db, 20, e)  # noqa: E731
    nq = q.shape[0]
    parts = []
    for e in (7, 2):
        kern.compare(run(q, e)[:4096], plain(q[:4096], e),
                     f"control chunk {kern.row['name']} editdist {e}")
        ms = cuda_ms(lambda e=e: run(q, e), 3)
        bound = bound_ms(hamming_ops(nq, nd, 20), INT8_OPS_PER_S, 0)[0]
        parts.append(f"editdist {e} {ms:.3f} ms ({nq * nd / ms / 1e9:.4f} "
                     f"T pairs/s, {bound / ms:.3f} of its {bound:.2f} ms "
                     f"bound)")
    say(f"phase 5 {'K4' if packed else 'K1'} at the control triage's shape, "
        f"{nq} x {nd}, exact on 4096 rows: " + "; ".join(parts))


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


def design_run(dev, packed: bool, extra=(), sharded=False):
    """The default P. aeruginosa design run with --controls 1000 --seed
    SEED (and the flags ``extra``), through the CLI's parser and
    run_pipeline, with every launch count set to 0 just before it and read
    just after; ``sharded`` sets GUIDEMAKER_TPU_KERNEL=sharded."""
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
    if sharded:
        os.environ["GUIDEMAKER_TPU_KERNEL"] = "sharded"
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
        os.environ.pop("GUIDEMAKER_TPU_KERNEL", None)
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
    over all guides, on the card; returns the queries (as guides and as
    packed rows), the plain top-k, and the kernel's and the plain
    version's ms."""
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
    return need, q, want, ms, plain_ms


def kcap_sweep(topk, run, want, ops, in_bytes):
    """The time of the top-k ``run(k)`` at each kcap of SWEEP_KCAPS, with
    its bound (``ops`` int8 operations; ``in_bytes`` read and the keys
    written); each list must be the first columns of the largest, and that
    one's first columns the plain top-k ``want``."""
    lists = {k: run(k) for k in SWEEP_KCAPS}
    top = lists[max(SWEEP_KCAPS)]
    for k, got in lists.items():
        topk.compare(got, top[:, :k], f"phase-2 top-k at k {k} against the "
                     f"first {k} columns at k {max(SWEEP_KCAPS)}")
    topk.compare(top[:, :want.shape[1]], want,
                 f"phase-2 top-k at k {max(SWEEP_KCAPS)}, first columns")
    rows = []
    for k in SWEEP_KCAPS:
        ms = cuda_ms(lambda: run(k), 3)
        bound = bound_ms(ops, INT8_OPS_PER_S,
                         in_bytes + 4 * want.shape[0] * k)[0]
        rows.append((k, ms, bound))
    return rows


def phase_design(count, topk, dev):
    import pandas as pd
    from guidemaker_tpu_torch.io import parse_genbank
    from guidemaker_tpu_torch.knn import stream
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
    need, q, want, ms, plain_ms = check_neighbor_lists(topk, res, cfg.knum,
                                                      dev)
    idx = res.processor.index
    nq, nd = len(need), len(idx)
    ops = hamming_ops(nq, nd, idx.length)
    topk.timed(ms, plain_ms, ops, INT8_OPS_PER_S,
               16 * (nq + nd) + 4 * nq * cfg.knum)
    sweep = kcap_sweep(
        topk, lambda k: stream.hamming_topk(q, idx._db, idx.length, k), want,
        ops, 16 * (nq + nd))
    topk.row["ms_by_kcap"] = {str(k): round(t, 3) for k, t, _ in sweep}
    say(f"phase 6 top-k by kcap on the {nq} phase-2 queries x {nd} guides: "
        + ", ".join(f"kcap {k} {t:.3f} ms (mma.sync design "
                    f"{MMA_SYNC_KCAP_MS[k]:.3f} ms; bound {b:.3f} ms, share "
                    f"{b / t:.3f})" for k, t, b in sweep))
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
    lists = {"seqs": idx.seqs, "queries": idx._encode_queries(need),
             "keys": want, "k": cfg.knum, "ms": ms, "wall": wall}
    return out, res.controls, df, lists


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
    ops = hamming_ops(len(need), n, idx.length)
    ptopk.timed(ms, plain_ms, ops, INT8_OPS_PER_S,
                q.numel() + db.numel() + 4 * len(need) * cfg.knum)
    sweep = kcap_sweep(
        ptopk, lambda k: stream.packed_topk(q, db, n, idx.length, k), want,
        ops, q.numel() + db.numel())
    ptopk.row["ms_by_kcap"] = {str(k): round(t, 3) for k, t, _ in sweep}
    say(f"phase 7 packed top-k by kcap on the {len(need)} phase-2 queries x "
        f"{n} guides: " + ", ".join(
            f"kcap {k} {t:.3f} ms (mma.sync design "
            f"{PACKED_MMA_SYNC_KCAP_MS[k]:.3f} ms; bound {b:.3f} ms, share "
            f"{b / t:.3f})" for k, t, b in sweep))
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
    return masks[3], secs[3]


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
    all_bound = bound_ms(MYERS_OPS * nq * n * idx.length, INT32_OPS_PER_S,
                         16 * (nq + n) + 4 * nq * cfg.knum)[0]
    say(f"phase 9 P. aeruginosa design run (--dtype leven --controls 1000 "
        f"--seed {SEED}, 2-bit layout) on {dev}: {len(df)} rows (expected "
        f"{PA_TABLE_ROWS}) == phase 6's table but for dtype and the neighbor "
        f"lists, {wall:.2f} s wall, "
        f"controls stage {stage_seconds(lines, 'controls')} s; launches: "
        f"2-bit {launches[:2]}, packed {launches[2:4]}, feature count "
        f"{launches[4]}, leven top-k {launches[5]}; neighbor lists == plain "
        f"DP top-k for {len(sample)} sampled guides x {n} (kernel {ms:.3f} "
        f"ms, plain {plain_ms:.3f} ms); all {nq} guides x {n} in "
        f"{ms_all:.3f} ms ({nq * n / ms_all / 1e9:.4f} T pairs/s, INT32 "
        f"bound {all_bound:.3f} ms); {controls}; controls == phase 6's "
        f"frame")
    ltopk.timed(ms, plain_ms, MYERS_OPS * len(sample) * n * idx.length,
                INT32_OPS_PER_S, 16 * (len(sample) + n)
                + 4 * len(sample) * cfg.knum)


def phase_leven_tiers(fcount, dev, uniq, b1_peak, b1_wgmma):
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
    n = TIER_GUIDES
    bounds = feature_bounds(n, n, 18, 8 * (q.numel() + db.numel()) + 4 * n,
                            b1_peak)
    bound, by, kind = least_bound(bounds)
    fcount.timed_bound(ms, plain_ms, bound, by, bound_kind=kind)
    say(f"phase 10 Levenshtein dist 4 on the first {n} P. aeruginosa guides, "
        f"all against all, on {dev}: {int(mask.sum())} retained == the k=2 "
        f"rule ({t_rule:.3f} s), pass_distance_filter {wall:.3f} s; "
        f"launches: 2-bit {launches[:2]}, feature count {launches[4]}, leven "
        f"top-k {launches[5]}; tier-1 count kernel {ms:.3f} ms "
        f"({n * n / ms / 1e9:.4f} T pairs/s), plain {plain_ms:.3f} ms; "
        + bounds_text(bounds, ms) + "; "
        + product_text(n, n, 18, b1_wgmma, ms))
    tier1_genome(fcount, dev, uniq, b1_peak, b1_wgmma)
    return mask, wall


def bounds_text(bounds, ms):
    """The least of ``bounds`` (feature_bounds) with its share of ``ms``,
    and the other beside it: the kernel computes the 1-bit product, so the
    int8 form's bound is no floor to its time."""
    bound, _, kind = least_bound(bounds)
    return (f"bound {bound:.4f} ms ({kind}, share {bound / ms:.3f}), "
            + ", ".join(f"{k} {b:.4f} ms" for k, (b, _) in bounds.items()
                        if k != kind))


def product_text(nq, nd, n_words, b1_wgmma, ms):
    """The time the 3-gram count's product takes at the probe's b1 wgmma
    rate (feature_product_ms), and its share of ``ms``."""
    t = feature_product_ms(nq, nd, n_words, b1_wgmma)
    return (f"its b1 wgmma product at the probe's {b1_wgmma / 1e12:,.1f} "
            f"T/s {t:.4f} ms ({t / ms:.3f} of its time)")


def tier1_genome(fcount, dev, uniq, b1_peak, b1_wgmma):
    """One timed tier-1 count at genome size: every unique guide's plain
    3-gram row against every guide's row dilated by t 3, thresh 8 (dist 4),
    equal to the plain count on a fixed sample of 4,096 queries."""
    from guidemaker_tpu_torch import dna
    from guidemaker_tpu_torch.knn import stream
    from guidemaker_tpu_torch.knn.features import (feature_count_plain,
                                                   gram_rows)
    codes = torch.from_numpy(dna.encode_pandas(uniq, 20)[0]).to(dev)
    q, db = gram_rows(codes, 0), gram_rows(codes, 3)
    del codes
    n = q.shape[0]
    sample = torch.from_numpy(np.sort(np.random.default_rng(SEED).choice(
        n, min(4096, n), replace=False))).to(dev)
    got = stream.feature_count(q, db, 18, 8)
    t0 = time.time()
    want = feature_count_plain(q[sample], db, 8)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    fcount.compare(got[sample], want, "P. aeruginosa genome-size tier-1 "
                   "count on the 4,096-query sample")
    ms = cuda_ms(lambda: stream.feature_count(q, db, 18, 8), 2)
    bounds = feature_bounds(n, n, 18, 8 * (q.numel() + db.numel()) + 4 * n,
                            b1_peak)
    fcount.row["ms_genome"] = round(ms, 3)
    say(f"phase 10 tier-1 count at genome size, {n} x {n} guides (t 3, "
        f"thresh 8) on {dev}: kernel == plain on {sample.numel()} sampled "
        f"queries (plain {plain_ms:.3f} ms for the sample); kernel "
        f"{ms:.3f} ms ({n * n / ms / 1e9:.4f} T pairs/s), "
        f"{int((got >= 2).sum())} queries ambiguous; "
        + bounds_text(bounds, ms) + "; "
        + product_text(n, n, 18, b1_wgmma, ms))


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
    need, _, _, ms, plain_ms = check_neighbor_lists(topk, res, 3, dev)
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


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_run(fn, counters):
    """``fn()`` with every launch count set to 0 just before it, the card
    waited for; returns its result, its seconds and the counts after it."""
    for c in counters:
        c.reset()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, [c.n for c in counters]


def phase_sharded(dev, uniq, ref):
    """Phase 13: the sharded backend on S virtual shards of the one card,
    every merge through a world-size-1 NCCL group, against the outputs of
    phases 5, 6, 8 and 10."""
    import torch.distributed as tdist
    from guidemaker_tpu_torch.distributed import (device_summary,
                                                  init_distributed)
    from guidemaker_tpu_torch.knn import KnnIndex, sharded, stream
    from guidemaker_tpu_torch.knn.hamming import host_lists, pack_codes
    init_distributed(f"127.0.0.1:{free_port()}", num_processes=1,
                     process_id=0)
    try:
        if tdist.get_backend() != "nccl" or tdist.get_world_size() != 1:
            raise AssertionError(f"process group {tdist.get_backend()} of "
                                 f"{tdist.get_world_size()}")
        counters = all_counters()

        def mesh(q, d):
            return sharded.make_mesh(q, d, [dev] * (q * d))

        # dist-2 retention over every guide, (1, 4)
        idx = KnnIndex(uniq, device=dev, backend="sharded")
        idx._mesh = mesh(1, 4)
        sdb = idx._sharded_db()
        mask, t_mask, launches = sharded_run(
            lambda: idx.pass_distance_filter(uniq, 2), counters)
        if launches != [4, 0, 0, 0, 0, 0]:
            raise AssertionError(f"sharded retention launches {launches}, "
                                 f"wanted K1 once on each of 4 shards")
        if not np.array_equal(mask, ref["mask2"]) or \
                int(mask.sum()) != PA_RETAINED:
            raise AssertionError(f"sharded retention: {int(mask.sum())} "
                                 f"retained, mask != phase 5's")
        codes = torch.from_numpy(idx._codes).to(dev)
        got = sharded.fused_sharded_count(codes, sdb, 2)
        if not torch.equal(got, ref["counts2"]):
            raise AssertionError("sharded count vector != phase 5's")
        n = len(idx)
        ms_count = cuda_ms(lambda: sharded.fused_sharded_count(codes, sdb, 2),
                           3)
        bound = bound_ms(hamming_ops(n, n, 20), INT8_OPS_PER_S,
                         32 * n + 4 * n)[0]
        say(f"phase 13 {device_summary()}; NCCL group of 1 "
            f"(127.0.0.1); dist-2 retention on a (1, 4) mesh of {dev}: "
            f"{int(mask.sum())} of {n} retained, mask == phase 5's, count "
            f"vector == phase 5's, K1 launched {launches[0]} times; "
            f"pass_distance_filter {t_mask:.3f} s; sharded count "
            f"{ms_count:.3f} ms ({n * n / ms_count / 1e9:.4f} T pairs/s, "
            f"{bound / ms_count:.3f} of the {bound:.2f} ms int8 bound)")
        del idx, sdb, codes, got
        # the phase-2 neighbor lists, (2, 2)
        lists = ref["lists"]
        idx = KnnIndex(lists["seqs"], device=dev, backend="sharded")
        idx._mesh = mesh(2, 2)
        sdb = idx._sharded_db()
        k, qc = lists["k"], lists["queries"]
        (d, i), t_lists, launches = sharded_run(
            lambda: idx.hamming_query_codes(qc, k), counters)
        want = host_lists(lists["keys"], k)
        if not (np.array_equal(d, want[0]) and np.array_equal(i, want[1])):
            raise AssertionError("sharded phase-2 lists != phase 6's")
        if launches != [0, 4, 0, 0, 0, 0]:
            raise AssertionError(f"sharded lists launches {launches}, "
                                 f"wanted K2 on each of 2 x 2 shards")
        q_dev = torch.from_numpy(qc).to(dev)
        ms_lists = cuda_ms(
            lambda: sharded._merge_topk(
                q_dev, sdb, k, lambda q, rows, kk: stream.hamming_topk(
                    q, rows, 20, kk), pack_codes), 3)
        keys = sharded._merge_topk(
            q_dev, sdb, k,
            lambda q, rows, kk: stream.hamming_topk(q, rows, 20, kk),
            pack_codes)
        parts = [torch.empty_like(keys)]
        ms_gather = cuda_ms(lambda: tdist.all_gather(parts, keys), 10)
        counts = torch.zeros(len(uniq), dtype=torch.int32, device=dev)
        ms_reduce = cuda_ms(lambda: tdist.all_reduce(counts), 10)
        say(f"phase 13 phase-2 lists on a (2, 2) mesh: {len(qc)} queries x "
            f"{len(idx)} guides, k {k}, == phase 6's keys; K2 launched "
            f"{launches[1]} times; {t_lists:.3f} s through the index, "
            f"{ms_lists:.3f} ms on the card for the keys (unsharded "
            f"{lists['ms']:.3f} ms in phase 6); NCCL world size 1: "
            f"all_gather of {tuple(keys.shape)} int32 keys {ms_gather:.4f} "
            f"ms, all_reduce of {counts.numel()} int32 counts "
            f"{ms_reduce:.4f} ms")
        del idx, sdb, q_dev, keys
        # Levenshtein: dist 3 on every guide (2, 2), dist 4 on the first
        # TIER_GUIDES (1, 4), and the Myers top-k on a sample (2, 2)
        lev = KnnIndex(uniq, metric="leven", device=dev, backend="sharded")
        lev._mesh = mesh(2, 2)
        mask3, t3, l3 = sharded_run(
            lambda: lev.pass_distance_filter(uniq, 3), counters)
        if not np.array_equal(mask3, ref["leven3"][0]):
            raise AssertionError("sharded Levenshtein dist-3 mask != phase "
                                 "8's")
        sub = uniq.iloc[:TIER_GUIDES].reset_index(drop=True)
        lev4 = KnnIndex(sub, metric="leven", device=dev, backend="sharded")
        lev4._mesh = mesh(1, 4)
        mask4, t4, l4 = sharded_run(
            lambda: lev4.pass_distance_filter(sub, 4), counters)
        if not np.array_equal(mask4, ref["leven4"][0]):
            raise AssertionError("sharded Levenshtein dist-4 mask != phase "
                                 "10's")
        sample = np.sort(np.random.default_rng(SEED).choice(
            len(uniq), min(4096, len(uniq)), replace=False))
        qs = lev._codes[sample]
        (d, i), t_knn, lk = sharded_run(lambda: lev.query_codes(qs, 5),
                                        counters)
        want = host_lists(stream.leven_topk(
            pack_codes(torch.from_numpy(qs).to(dev)), lev._db, 20, 5), 5)
        if not (np.array_equal(d, want[0]) and np.array_equal(i, want[1])):
            raise AssertionError("sharded Levenshtein top-k != unsharded")
        if l4[4] == 0 or lk[5] != 4 or l3[0] != 4:
            raise AssertionError(f"sharded Levenshtein launches: dist 3 "
                                 f"{l3}, dist 4 {l4}, top-k {lk}")
        say(f"phase 13 Levenshtein on virtual shards: dist 3 (2, 2) "
            f"{int(mask3.sum())} retained == phase 8's mask, {t3:.3f} s "
            f"({ref['leven3'][1]:.3f} s unsharded), K1 {l3[0]} launches; "
            f"dist 4 on {len(sub)} guides (1, 4) {int(mask4.sum())} "
            f"retained == phase 10's mask, {t4:.3f} s ({ref['leven4'][1]:.3f}"
            f" s unsharded), launches K1' {l4[4]}, K6 {l4[5]}; Myers top-k "
            f"k 5 for {len(sample)} sampled guides x {len(lev)} (2, 2) == "
            f"unsharded, K6 {lk[5]} launches, {t_knn:.3f} s")
        del lev, lev4
        # the default design run on the sharded backend (auto_mesh)
        cfg, out, res, launches, wall, lines = design_run(dev, packed=False,
                                                          sharded=True)
        for line in lines:
            say("  " + line)
        index = res.processor.index
        if index.backend != "sharded" or index.packed:
            raise AssertionError(f"design run index backend {index.backend}"
                                 f", packed {index.packed}")
        tables = []
        for d in (ref["out"], out):
            with gzip.open(os.path.join(d, "targets.csv.gz"), "rb") as fh:
                tables.append(fh.read())
        if tables[0] != tables[1]:
            raise AssertionError("sharded design run: targets.csv.gz != "
                                 "phase 6's")
        if min(launches[:2]) == 0 or max(launches[2:]) != 0:
            raise AssertionError(f"sharded design run launches {launches}")
        controls = check_controls(res, out, dev)
        from guidemaker_tpu_torch.io import parse_genbank
        again = res.processor.get_control_seqs(
            parse_genbank(PA_GBK), cfg.config, length=cfg.guidelength,
            n=cfg.controls, seed=SEED)[2]
        if not again.equals(res.controls):
            raise AssertionError("sharded design run: a second control "
                                 "search with the same seed gave another "
                                 "frame")
        say(f"phase 13 P. aeruginosa design run with "
            f"GUIDEMAKER_TPU_KERNEL=sharded (auto_mesh "
            f"{index._mesh.devices.shape}) on {dev}: targets.csv.gz == "
            f"phase 6's ({len(tables[1])} bytes), {wall:.2f} s wall "
            f"(phase 6: {lists['wall']:.2f} s), controls stage "
            f"{stage_seconds(lines, 'controls')} s, "
            f"{res.processor.ncontrolsearched} candidates searched (whole "
            f"rungs); launches: count {launches[0]}, top-k {launches[1]}; "
            f"{controls}; controls frame == phase 6's: "
            f"{res.controls.equals(ref['controls'])}; the same frame again "
            f"from a second search with the same seed")
        return res.controls
    finally:
        tdist.destroy_process_group()


#: phase 14's ranks, and each one's limit in seconds
RANKS = 2
RANK_TIMEOUT = 300


class CollectiveLog:
    """Wraps ``torch.distributed``'s ``all_gather``, ``all_reduce`` and
    ``broadcast``: each call's (op, shape) and host ms, and how many calls
    started while another of this process was in flight."""

    OPS = ("all_gather", "all_reduce", "broadcast")

    def __init__(self, tdist):
        import threading
        self.calls, self.ms, self.overlaps = [], 0.0, 0
        self._in_flight, self._lock = 0, threading.Lock()
        for name in self.OPS:
            setattr(tdist, name, self._wrap(name, getattr(tdist, name)))

    def _wrap(self, name, real):
        def call(*args, **kwargs):
            tensor = args[1] if name == "all_gather" else args[0]
            with self._lock:
                self.overlaps += self._in_flight > 0
                self._in_flight += 1
                self.calls.append([name, list(tensor.shape)])
            t0 = time.time()
            try:
                return real(*args, **kwargs)
            finally:
                with self._lock:
                    self._in_flight -= 1
                    self.ms += (time.time() - t0) * 1e3
        return call

    def take(self):
        """{"calls", "ms", "overlaps"} since the last take; then resets."""
        with self._lock:
            out = {"calls": self.calls, "ms": self.ms,
                   "overlaps": self.overlaps}
            self.calls, self.ms, self.overlaps = [], 0.0, 0
        return out


def rank_worker(rank: int, port: int) -> int:
    """Phase 14's worker: rank ``rank`` of a gloo group of RANKS on
    127.0.0.1:``port``, on the card that ``local_devices`` gives it under
    the LOCAL_RANK and LOCAL_WORLD_SIZE its parent set.  It runs phase 6's
    design run (no GUIDEMAKER_TPU_KERNEL: the group shards the index), then
    the C. ruddii design run unseeded, and prints one ``RESULT`` line."""
    sys.path.insert(0, ROOT)
    import torch.distributed as tdist
    from guidemaker_tpu_torch import cli
    from guidemaker_tpu_torch.distributed import (init_distributed,
                                                  local_devices)
    from guidemaker_tpu_torch.pipeline import run_pipeline
    dev = local_devices()[0]
    torch.cuda.set_device(dev)
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                             world_size=RANKS, rank=rank)
    init_distributed(f"127.0.0.1:{port}", num_processes=RANKS,
                     process_id=rank)     # a no-op: the group is up
    log = CollectiveLog(tdist)
    try:
        cfg, out, res, launches, wall, lines = design_run(dev, packed=False)
        pa_log = log.take()
        index = res.processor.index
        result = {
            "rank": rank, "device": str(dev), "backend": index.backend,
            "mesh": list(index._mesh.devices.shape), "wall": wall,
            "stages": lines, "launches": launches, "log": pa_log,
            "out": out, "controls": res.controls.to_csv(),
            "table_sha": hashlib.sha256(res.targets.to_csv(
                index=False).encode()).hexdigest(),
            "searched": res.processor.ncontrolsearched,
            "check": check_controls(res, out, dev) if rank == 0 else None}
        cr_out = tempfile.mkdtemp(prefix="gm_smoke_cr_")
        cr = run_pipeline(cli.config_from_args(cli.myparser().parse_args(
            ["--genbank", CR_GBK, "--pamseq", "NGG", "--outdir", cr_out])))
        torch.cuda.synchronize()
        result.update(cr_controls=cr.controls.to_csv(), cr_log=log.take(),
                      cr_out=cr_out)
    finally:
        tdist.destroy_process_group()
    print("RESULT " + json.dumps(result), flush=True)
    return 0


def phase_two_ranks(ref):
    """Phase 14: RANKS processes of one gloo group on the one card (each
    started by this script, LOCAL_RANK r of LOCAL_WORLD_SIZE RANKS), each
    running phase 6's design run with the index sharded over the group."""
    import pandas as pd
    env = {k: v for k, v in os.environ.items()
           if k not in ("GUIDEMAKER_TPU_KERNEL", "GUIDEMAKER_TPU_PACKED")}
    env["LOCAL_WORLD_SIZE"] = str(RANKS)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         str(port)], env=dict(env, LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(RANKS)]
    deadline = time.time() + RANK_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.time())))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"phase 14: a rank did not finish in "
                             f"{RANK_TIMEOUT} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        line = [x for x in out.splitlines() if x.startswith("RESULT ")]
        if p.returncode != 0 or len(line) != 1:
            raise AssertionError(f"phase 14 rank {r} failed (exit "
                                 f"{p.returncode}):\n{err[-4000:]}")
        ranks.append(json.loads(line[0][len("RESULT "):]))
    first, other = ranks[0], ranks[1:]
    tables = []
    for d in (ref["out"], first["out"]):
        with gzip.open(os.path.join(d, "targets.csv.gz"), "rb") as fh:
            tables.append(fh.read())
    checks = {
        "rank 0's targets.csv.gz == phase 6's": tables[0] == tables[1],
        "rank 0's table == its targets.csv.gz":
            hashlib.sha256(tables[1]).hexdigest() == first["table_sha"],
        "ranks other than 0 wrote nothing":
            all(not os.listdir(r["out"]) and not os.listdir(r["cr_out"])
                for r in other),
        "every rank's table and controls == rank 0's":
            all(r["table_sha"] == first["table_sha"]
                and r["controls"] == first["controls"] for r in other),
        "controls == phase 13's sharded design run's":
            pd.read_csv(io.StringIO(first["controls"]), index_col=0).equals(
                ref["sharded_controls"]),
        "every index sharded": all(r["backend"] == "sharded"
                                   for r in ranks),
        "every rank on cuda:0": all(r["device"] == "cuda:0" for r in ranks),
        "collective logs equal on every rank": all(
            r[k]["calls"] == first[k]["calls"] for r in other
            for k in ("log", "cr_log")),
        "no collective began while another was in flight": all(
            r[k]["overlaps"] == 0 for r in ranks for k in ("log", "cr_log")),
        "K1 and K2 launched on every rank": all(
            min(r["launches"][:2]) > 0 for r in ranks),
        "C. ruddii unseeded: controls equal on every rank": all(
            r["cr_controls"] == first["cr_controls"] for r in other),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 14: {failed}")
    for r in ranks:
        for line in r["stages"]:
            say(f"  rank {r['rank']} {line}")
        ops = {}
        for op, _ in r["log"]["calls"]:
            ops[op] = ops.get(op, 0) + 1
        say(f"phase 14 rank {r['rank']} of {RANKS} (two processes sharing "
            f"one card, not a scaling figure) on {r['device']}, mesh "
            f"{tuple(r['mesh'])}: P. aeruginosa design run {r['wall']:.2f} s "
            f"wall, controls stage {stage_seconds(r['stages'], 'controls')} "
            f"s, {r['searched']} candidates searched; launches: count "
            f"{r['launches'][0]}, top-k {r['launches'][1]}; gloo "
            f"collectives {len(r['log']['calls'])} ({ops}) in "
            f"{r['log']['ms']:.1f} ms; C. ruddii unseeded "
            f"{len(r['cr_log']['calls'])} collectives in "
            f"{r['cr_log']['ms']:.1f} ms")
    say(f"phase 14 {RANKS} gloo ranks on one card: " + "; ".join(checks)
        + f" ({len(tables[1])} bytes; {first['check']})")


def kernel_name(mangled: str) -> str:
    """``topk_kernel<8>`` from a mangled kernel name of the library: the
    last name of its nested name, with its first template argument."""
    pos, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while m := re.match(r"\d+", mangled[pos:]):
        start = pos + len(m.group())
        pos = start + int(m.group())
        name = mangled[start:pos]
    arg = re.match(r"ILi(\d+)E", mangled[pos:])
    return f"{name}<{arg.group(1)}>" if arg else name


def ptxas_report(log: str):
    """{kernel: [registers, spill store bytes, spill load bytes, static
    shared bytes]} from the ``-Xptxas -v`` report of the build."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn] = [0, int(m.group(1)), int(m.group(2)), 0]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn in out:
            out[fn][0] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[fn][3] = int(m.group(1)) if m else 0
    return out


def wgmma_notes(log: str):
    """{kernel: [message, ...]} of ptxas's wgmma notes (C75xx: a wait or an
    arrive it injected, or products it serialised)."""
    out = {}
    for line in log.splitlines():
        m = re.search(r"\((C75\d\d)\) (.*?) in (?:the )?function '(\S+)'",
                      line)
        if m:
            out.setdefault(kernel_name(m.group(3)), []).append(
                f"{m.group(1)} {m.group(2)}")
    return out


#: every kcap a top-k kernel is built for
KCAPS = (1, 2, 4, 8, 16, 32, 64, 128)


def topk_kernels(kcaps, prefix=""):
    """The 2-bit (or, with prefix "packed_", the packed) top-k kernel at
    each of ``kcaps``."""
    return tuple(f"{prefix}topk_kernel<{k}>" for k in kcaps)


def feature_kernels(steps):
    """The 3-gram count kernel at each k256 step count of ``steps``."""
    return tuple(f"feature_count_kernel<{s}>" for s in steps)


def lists_note(kcap):
    """Where the top-k kernels keep their lists at ``kcap``."""
    return ("sub-lists" if kcap <= 32 else "row lists") + " in shared memory"


#: the kernels on wgmma (the three counts, both top-k kernels at every
#: kcap, the 3-gram count at every step count): their wgmma opcode and no
#: mma.sync (IMMA, BMMA) in their SASS, no serialisation note from ptxas,
#: and each one's instantiations (phase 2 prints their logic, barrier and
#: warpgroup counts)
WGMMA_KERNELS = {
    "count_kernel": "k32 steps 1-4, bias lane or not",
    "packed_count_kernel": "L 1-21 producers, k32 steps 1-2",
    **{fn: "k32 steps 1-4, bias lane or not, " + lists_note(k)
       for k, fn in zip(KCAPS, topk_kernels(KCAPS))},
    **{fn: "L 1-21 producers in units, k32 steps 1-2, " + lists_note(k)
       for k, fn in zip(KCAPS, topk_kernels(KCAPS, "packed_"))},
    **{fn: f"{s} k256 step{'s' * (s > 1)}, {4 * s - 3}-{4 * s} words"
       for s, fn in zip(range(1, 9), feature_kernels(range(1, 9)))}}
#: the tensor-core kernels whose SASS phase 2 reads, each with the opcode
#: it must hold (IGMMA: int8 wgmma at every kcap a top-k kernel is built
#: for; BGMMA: 1-bit wgmma at every step count of the 3-gram count, 1..8
#: for 1..30 words), and those that must not spill (the counts, the top-k
#: kcaps the main path runs, and the 3-gram count at every step count: A
#: in registers at S <= 5, guides of <= 22 bases, in shared memory above)
TC_KERNELS = {fn: "BGMMA" if fn.startswith("feature_") else "IGMMA"
              for fn in WGMMA_KERNELS}
NO_SPILL_KERNELS = (("count_kernel", "packed_count_kernel")
                    + topk_kernels((1, 2, 4, 8))
                    + topk_kernels((1, 2, 4, 8), "packed_")
                    + feature_kernels(range(1, 9)))
#: the tensor-core rate probe's kernel for each kind (csrc/mma_rate.cu):
#: (kernel, gm_mma_rate kind, blocks an SM, iterations, M, N, K of one
#: product, products a warp (mma.sync) or a warpgroup (wgmma) an iteration,
#: product issuers a block)
PROBE_KERNELS = {
    "s8 m16n8k32": ("mma_rate_kernel<0>", 0, 4, 4096, 16, 8, 32, 8, 8),
    "b1 m16n8k256": ("mma_rate_kernel<1>", 1, 4, 4096, 16, 8, 256, 8, 8),
    "s8 wgmma m64n128k32": ("wgmma_rate_kernel", 2, 2, 256, 64, 128, 32, 8,
                            2),
    "b1 wgmma m64n128k256": ("wgmma_b1_rate_kernel", 3, 2, 256, 64, 128,
                             256, 8, 2)}
#: the opcodes phase 2 counts: tensor-core products (IMMA and BMMA:
#: mma.sync int8 and 1-bit; IGMMA and BGMMA: wgmma int8 and 1-bit), and the
#: CUDA-core popcount and dp4a (``IDP.4A``) that a tensor-core kernel must
#: not hold; for the wgmma kernels also the logic, the barriers (BAR: named
#: and block barriers, SYNCS: mbarriers) and the warpgroup fences and waits
SASS_OPS = ("IMMA", "BMMA", "IGMMA", "BGMMA", "POPC", "IDP")
WGMMA_SASS_OPS = ("LOP3", "SHF", "IMAD", "BAR", "SYNCS", "WARPGROUP")


def kernel_sass(lib: str):
    """{kernel: {opcode: count}} of SASS_OPS for each of TC_KERNELS and
    PROBE_KERNELS, from the SASS of the built library by ``cuobjdump
    -sass`` from nvcc's toolkit.  An opcode is a word up to its first dot,
    so the ``.POPC`` of a 1-bit product's ``.AND.POPC`` is not a POPC."""
    from guidemaker_tpu_torch.knn import build
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    wanted = set(TC_KERNELS) | {v[0] for v in PROBE_KERNELS.values()}
    out = {}
    for part in sass.split("Function : ")[1:]:
        fn = kernel_name(part.split(None, 1)[0])
        if fn in wanted:
            ops = [w.split(".")[0] for w in part.split()]
            out[fn] = {op: ops.count(op)
                       for op in dict.fromkeys(SASS_OPS + WGMMA_SASS_OPS)}
    return out


def mma_rates(dev, sass):
    """{kind: operations a second} of the tensor-core rate probe
    (csrc/mma_rate.cu, PROBE_KERNELS), each product counted 2 M N K;
    prints each with its SASS tensor opcodes."""
    from guidemaker_tpu_torch.knn import build
    lib = build.library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(4 * sms * 256, dtype=torch.int32, device=dev)
    rates = {}
    for name, (fn, kind, per_sm, iters, m, n, k, per_iter, issuers) in (
            PROBE_KERNELS.items()):
        blocks = per_sm * sms

        def run(kind=kind, blocks=blocks, iters=iters):
            err = lib.gm_mma_rate(kind, blocks, iters, out.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"mma_rate kernel {kind}: CUDA error {err}")
        ms = cuda_ms(run, 5)
        products = blocks * issuers * iters * per_iter
        rates[name] = products * 2 * m * n * k / (ms * 1e-3)
        ops = {op: c for op, c in sass.get(fn, {}).items()
               if op.endswith("MMA") and c}
        say(f"  probe {name}: {rates[name] / 1e12:.1f} T operations/s, "
            f"{products / (ms * 1e-3) / 1e12:.4f} T products/s ({ms:.3f} ms "
            f"for {products} products), SASS {ops}")
    say(f"  probe s8 wgmma/mma.sync: "
        f"{rates['s8 wgmma m64n128k32'] / rates['s8 m16n8k32']:.4f}; wgmma "
        f"{rates['s8 wgmma m64n128k32'] / INT8_OPS_PER_S:.4f} of the "
        f"{INT8_OPS_PER_S / 1e12:,.0f} TOP/s int8 peak")
    b1_wgmma = rates["b1 wgmma m64n128k256"]
    say(f"  probe b1 wgmma: {b1_wgmma / rates['s8 wgmma m64n128k32']:.4f} "
        f"x the s8 wgmma in operations, "
        f"{b1_wgmma / rates['b1 m16n8k256']:.4f} x the b1 mma.sync")
    ratio = rates["b1 m16n8k256"] / rates["s8 m16n8k32"]
    say(f"  probe b1/s8: {ratio:.4f} in operations, {ratio * 32 / 256:.4f} "
        f"in products; 1-bit rate taken as {ratio:.4f} x "
        f"{INT8_OPS_PER_S / 1e12:,.0f} TOP/s = "
        f"{ratio * INT8_OPS_PER_S / 1e12:,.0f} T bit operations/s")
    return rates


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
        ptxas = ptxas_report(fh.read())
    say(f"phase 2 build: {os.path.relpath(lib, ROOT)} in "
        f"{time.time() - t0:.2f} s")
    for fn, (regs, st, ld, smem) in sorted(ptxas.items()):
        say(f"  ptxas {fn}: {regs} registers, spill stores {st} B, spill "
            f"loads {ld} B, static shared {smem} B")
    with open(lib[:-3] + ".log") as fh:
        notes = wgmma_notes(fh.read())
    say(f"  ptxas wgmma notes: {notes or 'none'}")
    for fn in WGMMA_KERNELS:
        if any("serialized" in n for n in notes.get(fn, [])):
            raise AssertionError(f"{fn}: ptxas serialised its wgmma "
                                 f"products: {notes[fn]}")
    sass = kernel_sass(lib)
    for fn, op in TC_KERNELS.items():
        ops = sass.get(fn, {})
        if not ops.get(op) or ops["POPC"] or ops["IDP"]:
            raise AssertionError(f"{fn} SASS: {ops}; it must run on the "
                                 f"tensor cores ({op}, no POPC or IDP4A)")
    for fn in NO_SPILL_KERNELS:
        if fn not in ptxas or ptxas[fn][1] or ptxas[fn][2]:
            raise AssertionError(f"{fn}: ptxas reports spills or nothing: "
                                 f"{ptxas.get(fn)}")
    say("  SASS (cuobjdump): " + ", ".join(
        f"{fn} {sass[fn][op]} {op} {sass[fn]['POPC']} POPC "
        f"{sass[fn]['IDP']} IDP4A" for fn, op in TC_KERNELS.items()))
    for fn, parts in WGMMA_KERNELS.items():
        if sass[fn]["IMMA"] or sass[fn]["BMMA"]:
            raise AssertionError(f"{fn} SASS holds mma.sync (IMMA, BMMA): "
                                 f"{sass[fn]}")
        say(f"  SASS {fn} ({parts}): " + ", ".join(
            f"{sass[fn][op]} {op}" for op in (TC_KERNELS[fn],)
            + WGMMA_SASS_OPS))
    rates = mma_rates(dev, sass)
    b1_peak = rates["b1 m16n8k256"] / rates["s8 m16n8k32"] * INT8_OPS_PER_S
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
    phase_edges(count, topk, dev)
    phase_packed_kernels(pcount, ptopk, dev)
    phase_packed_edges(pcount, ptopk, dev)
    phase_leven_kernels(fcount, ltopk, dev, b1_peak)
    phase_feature_edges(fcount, dev)
    phase_cruddii(dev)
    t0 = time.time()
    uniq = pa_guides()
    mask2, counts2 = phase_retention(count, pcount, dev, uniq,
                                     time.time() - t0,
                                     rates["s8 wgmma m64n128k32"])
    hamming_out, hamming_controls, hamming_table, lists = phase_design(
        count, topk, dev)
    phase_design_packed(pcount, ptopk, dev, hamming_out)
    leven3 = phase_leven_retention(dev, uniq)
    phase_leven_design(ltopk, dev, hamming_out, hamming_controls)
    leven4 = phase_leven_tiers(fcount, dev, uniq, b1_peak,
                               rates["b1 wgmma m64n128k256"])
    phase_scored_design(topk, dev, hamming_controls, hamming_table)
    phase_app(dev)
    sharded_controls = phase_sharded(
        dev, uniq, {"mask2": mask2, "counts2": counts2, "lists": lists,
                    "out": hamming_out, "controls": hamming_controls,
                    "leven3": leven3, "leven4": leven4})
    torch.cuda.empty_cache()
    phase_two_ranks({"out": hamming_out,
                     "sharded_controls": sharded_controls})
    say(json.dumps({"kernels": [count.row, topk.row, pcount.row, ptopk.row,
                                fcount.row, ltopk.row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_worker(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
