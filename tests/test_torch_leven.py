"""The port's Levenshtein path against the JAX package's.

The same codes, made with numpy from a seed, go through the JAX package on
the CPU (its Pallas count kernel in interpret mode, its Myers and DP
engines in XLA) and through the port, whose wrappers run the plain PyTorch
versions on a CPU tensor.  Every result is an integer or a boolean, so the
tolerance is exact equality.  The kernels need the card: the ``cuda``
tests hold them against the plain versions there, and a numpy model of the
3-gram count kernel's 1-bit tensor-core arithmetic is held against both
packages here.
"""
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import guidemaker_tpu.targets as jax_targets
from guidemaker_tpu.io import parse_fasta as jax_parse_fasta
from guidemaker_tpu.knn import leven as jl
from guidemaker_tpu.knn.driver import KnnIndex as JaxKnnIndex
from guidemaker_tpu.knn.pallas_stream import _stream_count
from guidemaker_tpu_torch import dna, targets
from guidemaker_tpu_torch.io import parse_fasta
from guidemaker_tpu_torch.knn import KnnIndex, leven, stream
from guidemaker_tpu_torch.knn.dp import (banded_leven_pairs, leven_block,
                                         leven_topk_plain)
from guidemaker_tpu_torch.knn.features import (feature_count_plain,
                                               gram_rows, unpack_rows)
from guidemaker_tpu_torch.knn.hamming import pack_codes, unpack_keys
from test_torch_controls import FASTA, N, SEED, _config, _draw, _inject


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8))


def _oracle(a, b, n_equal_n=False):
    """Python Levenshtein DP over code rows; an N (>= 4) matches nothing
    unless ``n_equal_n``."""
    def eq(x, y):
        return x == y and (x < 4 or n_equal_n)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (not eq(ca, cb))))
        prev = cur
    return prev[-1]


def _near(rng, rows, n_sub, n_shift):
    """Copies of code rows with substitutions and shifts (a deletion and an
    insertion), so Levenshtein and Hamming distances part."""
    out = rows.copy()
    length = rows.shape[1]
    for r in out:
        for _ in range(n_sub):
            i = rng.integers(0, length)
            r[i] = (r[i] + rng.integers(1, 4)) % 4
        for _ in range(n_shift):
            d, ins = rng.integers(0, length, 2)
            rest = np.delete(r, d)
            r[:] = np.insert(rest, ins, rng.integers(0, 4))
    return out


def _codes(rng, nq, nd, length, with_n=True):
    """Database with duplicated rows and rows at distance 0, 1 and 2 of a
    query; queries with N bases (and one all-N) when ``with_n``."""
    q = rng.integers(0, 4, size=(nq, length)).astype(np.uint8)
    db = rng.integers(0, 4, size=(nd, length)).astype(np.uint8)
    m = min(nq, nd // 4)
    db[:m] = q[:m]                                   # distance 0
    db[m:2 * m] = _near(rng, q[:m], 1, 0)            # distance 1
    db[2 * m:3 * m] = _near(rng, q[:m], 0, 1)        # a shift
    db[-1] = db[0]                                   # a tie
    if with_n:
        q[::7, rng.integers(0, length)] = dna.INVALID
        db[::11, rng.integers(0, length)] = dna.INVALID
        q[-1] = dna.INVALID
    return q, db


@pytest.mark.parametrize("L", [5, 8, 20, 27, 31])
@pytest.mark.parametrize("with_n", [False, True])
def test_block_matches_jax_myers(L, with_n):
    rng = np.random.default_rng(L)
    q, db = _codes(rng, 12, 40, L, with_n)
    got = leven_block(_t(q), _t(db)).numpy()
    want = np.asarray(jl.leven_block_myers(q, db, length=L,
                                           clean=not with_n))
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got == 1).any()


@pytest.mark.parametrize("nq,nd,k,L", [(100, 9000, 5, 20), (30, 300, 1, 27),
                                       (70, 200, 2, 12), (9, 3, 5, 20)])
def test_topk_matches_jax(nq, nd, k, L):
    """Ties (duplicated rows) break by index, k > nd pads with -1, and the
    plain version runs several query and database tiles."""
    rng = np.random.default_rng(nq + nd)
    q, db = _codes(rng, nq, nd, L)
    keys = leven.leven_topk(_t(q), _t(db), k)
    assert keys.shape == (nq, min(k, nd))
    d, i = (a.numpy() for a in unpack_keys(keys))
    jd, ji = jl.leven_topk(q, db, k, db_tile=128, q_tile=64)
    np.testing.assert_array_equal(d, jd[:, :d.shape[1]])
    np.testing.assert_array_equal(i, ji[:, :d.shape[1]])
    assert (jd[:, d.shape[1]:] == -1).all()


@pytest.mark.parametrize("t", [1, 2, 4])
def test_banded_pairs_match_jax(t):
    rng = np.random.default_rng(7 * t)
    a = rng.integers(0, 4, size=(96, 20)).astype(np.uint8)
    b = np.concatenate([_near(rng, a[:32], t, 0), _near(rng, a[32:64], 0, 1),
                        rng.integers(0, 4, size=(32, 20)).astype(np.uint8)])
    got = banded_leven_pairs(_t(a), _t(b), t).numpy()
    want = np.asarray(jl.banded_leven_pairs(jnp.asarray(a), jnp.asarray(b),
                                            t=t, length=20))
    np.testing.assert_array_equal(got, want)
    assert (got <= t).any() and (got == t + 1).any()


@pytest.mark.parametrize("t", [0, 1, 2, 4])
def test_gram_rows_match_jax_features(t):
    rng = np.random.default_rng(31)
    codes = rng.integers(0, 5, size=(16, 20)).astype(np.uint8)   # with N
    got = unpack_rows(gram_rows(_t(codes), t), torch.int8).numpy()
    want = jl._filter_feats(codes, t, "q" if t == 0 else "db")
    np.testing.assert_array_equal(got, want)
    dev = np.asarray(jl._gram_feats_on_device(jnp.asarray(codes), t=t))
    np.testing.assert_array_equal(got, dev[:, :got.shape[1]])


@pytest.mark.parametrize("L,t", [(20, 3), (27, 4), (12, 2)])
@pytest.mark.parametrize("direction", [1, 2])
def test_feature_count_matches_jax_kernel(L, t, direction):
    """The plain count against the Pallas count kernel, in interpret mode,
    on the JAX package's gram features (padded to its tiles with N rows,
    whose features are zero)."""
    rng = np.random.default_rng(L * t)
    q, db = _codes(rng, 40, 250, L)
    glen, p_edit = L - 2, 3 * t + 1
    tq, td = (0, t) if direction == 1 else (t, 0)
    got = stream.feature_count(gram_rows(_t(q), tq), gram_rows(_t(db), td),
                               glen, glen - p_edit).numpy()
    qp = np.full((64, L), dna.INVALID, np.uint8)
    qp[:40] = q
    dp = np.full((256, L), dna.INVALID, np.uint8)
    dp[:250] = db
    ref = _stream_count(jl._gram_feats_on_device(jnp.asarray(qp), t=tq),
                        jl._gram_feats_on_device(jnp.asarray(dp), t=td),
                        length=glen, editdist=p_edit, q_tile=32, db_tile=128,
                        interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref)[:40, 0])
    assert (got >= 1).any()


#: row widths G = L - 2 at the 3-gram count kernel's k256 step edges (a
#: step is 4 words): 1 and 4 words in one step, 5 in two, 18 and 25 in 5
#: and 7 steps with padding, 30 in all 8
FEATURE_EDGE_WORDS = [1, 4, 5, 18, 25, 30]

_LANE = np.arange(32)
_GID, _TID = _LANE >> 2, _LANE & 3


def _units(rows, steps):
    """(n, 8 steps) uint32: int64 feature rows as csrc/feature_count.cu
    reads them, word w as 32-bit units 2w (its low half, the lower
    address) and 2w + 1, words G..4 steps - 1 zero."""
    words = np.zeros((rows.shape[0], 4 * steps), np.uint64)
    words[:, :rows.shape[1]] = rows.astype(np.int64).view(np.uint64)
    units = np.empty((rows.shape[0], 8 * steps), np.uint32)
    units[:, 0::2] = words & 0xFFFFFFFF
    units[:, 1::2] = words >> 32
    return units


def _ldsm_x4(units, row0, unit0):
    """(32, 4) uint32: ldmatrix.x4 as gm::ldsm_src addresses it, at tile
    row row0 and 32-bit unit unit0: lane l gives the row address of matrix
    l >> 3, row ((l >> 4) << 3) + (l & 7), 16 bytes in if (l >> 3) & 1;
    lane 4g + t receives unit t of row g of each matrix m."""
    src = 8 * np.arange(4)[None, :] + _GID[:, None]       # (lane, m)
    rows = row0 + ((src >> 4) << 3) + (src & 7)
    return units[rows, unit0 + 4 * ((src >> 3) & 1) + _TID[:, None]]


def _mma_b1(a, b):
    """(32, 4) int: mma.sync.m16n8k256 .b1 .and.popc of the lane fragments
    a (32, 4) and b (32, 2), by PTX's layout: A element (i, c) is bit
    c & 31 of register 2 (c >> 7) + (i >> 3) of lane 4 (i & 7) +
    ((c & 127) >> 5); B element (c, j) is bit c & 31 of register c >> 7 of
    lane 4j + ((c & 127) >> 5); lane 4g + t holds D rows g + 8 (r >> 1),
    columns 2t + (r & 1) in register r."""
    c = np.arange(256)
    i, j = np.arange(16)[:, None], np.arange(8)[None, :]
    abits = (a[4 * (i & 7) + ((c & 127) >> 5), 2 * (c >> 7) + (i >> 3)]
             >> (c & 31)) & 1
    bbits = (b[4 * j.T + ((c & 127) >> 5), c >> 7] >> (c & 31)) & 1
    d = abits.astype(np.int64) @ bbits.T.astype(np.int64)    # (16, 8)
    r = np.arange(4)
    return d[_GID[:, None] + 8 * (r >> 1), 2 * _TID[:, None] + (r & 1)]


def _feature_products(q_rows, db_rows):
    """(warps, batches, 2, 4, 32, 4) int: the products of
    csrc/feature_count.cu in its accumulator layout, [warp, batch, mt, nt,
    lane, register].  Rows of S = ceil(G/4) k256 steps with words G..4S-1
    zero; warps of 32 queries (rows past nq zero) whose A fragments hold
    units 8s + 4h + t of rows g and g + 8 of each m16 tile in register
    2h + half; 128-row database tiles zero-filled past nd, read by
    ldmatrix.x4 in batches of 4 n8 tiles."""
    steps = -(-q_rows.shape[1] // 4)
    nq, nd = q_rows.shape[0], db_rows.shape[0]
    qu = np.zeros((-(-nq // 32) * 32, 8 * steps), np.uint32)
    qu[:nq] = _units(q_rows, steps)
    du = np.zeros((-(-nd // 128) * 128, 8 * steps), np.uint32)
    du[:nd] = _units(db_rows, steps)
    out = np.zeros((qu.shape[0] // 32, du.shape[0] // 32, 2, 4, 32, 4),
                   np.int64)
    for w, qw in enumerate(range(0, qu.shape[0], 32)):
        a = np.zeros((2, steps, 32, 4), np.uint32)    # load_feature_a
        for mt, s, h, half in np.ndindex(2, steps, 2, 2):
            a[mt, s, :, 2 * h + half] = qu[qw + 16 * mt + 8 * half + _GID,
                                           8 * s + 4 * h + _TID]
        for n, n0 in enumerate(range(0, du.shape[0], 32)):   # mma_batch
            b = np.stack([[_ldsm_x4(du, n0 + 16 * p, 8 * s)
                           for p in range(2)] for s in range(steps)])
            for mt, nt, s in np.ndindex(2, 4, steps):
                out[w, n, mt, nt] += _mma_b1(
                    a[mt, s], b[s, nt >> 1][:, 2 * (nt & 1):2 * (nt & 1) + 2])
    return out


def _feature_count_model(products, nq, thresh):
    """The kernel's count from its products: sums started at
    -(thresh + 1), each lane's sign gate over its 32 sums of a batch
    (count_batch), and the quad sum of the sums >= 0 (add_counts)."""
    acc = products - (thresh + 1)
    lanes = acc.transpose(0, 1, 4, 2, 3, 5)           # [w, n, lane, mt, nt, r]
    gate = np.bitwise_and.reduce(
        lanes.reshape(*lanes.shape[:3], -1), axis=3) >= 0
    passed = (lanes >= 0) & gate[..., None, None, None]
    cnt = passed.reshape(*lanes.shape[:5], 2, 2).sum((1, 4, 6))  # [w, l, mt, h]
    quad = cnt.reshape(-1, 8, 4, 2, 2).sum(2)         # [w, g, mt, half]
    return quad.transpose(0, 2, 3, 1).reshape(-1)[:nq]


@pytest.mark.parametrize("glen", FEATURE_EDGE_WORDS)
@pytest.mark.parametrize("direction", [1, 2])
def test_feature_count_kernel_model_matches_plain_and_jax(glen, direction):
    """The 1-bit kernel's fragment addressing, zero padding, biased sign
    gate and quad sum, modelled in numpy, equal the plain count and the
    JAX Pallas count kernel (interpret mode) on the same 3-gram rows, with
    N bases, a warp of all-N queries, a partly empty query block and a
    database ragged against its tiles, at the threshold edges."""
    L, t = glen + 2, 3
    rng = np.random.default_rng(40 + glen)
    q, db = _codes(rng, 300, 260, L)
    q[32:64] = dna.INVALID
    tq, td = (0, t) if direction == 1 else (t, 0)
    q_rows, db_rows = gram_rows(_t(q), tq), gram_rows(_t(db), td)
    qp = np.full((320, L), dna.INVALID, np.uint8)
    qp[:300] = q
    dp = np.full((384, L), dna.INVALID, np.uint8)
    dp[:260] = db
    q_oh = jl._gram_feats_on_device(jnp.asarray(qp), t=tq)
    db_oh = jl._gram_feats_on_device(jnp.asarray(dp), t=td)
    products = _feature_products(q_rows.numpy(), db_rows.numpy())
    for thresh in sorted({x for x in (0, glen - 3 * t - 1, glen - 1, glen)
                          if x >= 0}):
        got = _feature_count_model(products, 300, thresh)
        want = feature_count_plain(q_rows, db_rows, thresh).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"thresh {thresh}")
        ref = _stream_count(q_oh, db_oh, length=glen,
                            editdist=glen - thresh, q_tile=32, db_tile=128,
                            interpret=True)
        np.testing.assert_array_equal(want, np.asarray(ref)[:300, 0],
                                      err_msg=f"thresh {thresh}")
        if thresh == 0:
            assert (want >= 1).any()


@pytest.mark.parametrize("L", [9, 16, 17, 20, 24, 31])
def test_deletion_join_matches_jax(L):
    """Both key branches: a composite (variant, owner) sort below 64 bits,
    a stable sort of variants above (L 31)."""
    rng = np.random.default_rng(13)
    base = rng.integers(0, 4, (120, L)).astype(np.uint8)
    shifted = np.concatenate([base[:25, 1:],
                              rng.integers(0, 4, (25, 1)).astype(np.uint8)],
                             axis=1)
    codes = np.unique(np.concatenate([base, shifted]), axis=0)
    want = jl._delset_partner_mask(codes)
    np.testing.assert_array_equal(
        leven.delset_partner_mask(_t(codes)).numpy(), want)
    assert want.any() and not want.all()


def test_deletion_join_n_and_32_bases():
    """At 32 bases (the packed sum wraps past 2**63) and with N bases, which
    match nothing, against brute force over deletion-variant sets."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, (60, 32)).astype(np.uint8)
    base[40:50] = np.roll(base[:10], 1, axis=1)
    base[50:55] = base[:5]
    base[50:55, 7] = dna.INVALID                 # partners only through N
    base[55, 3] = base[56, 3] = dna.INVALID
    base[56, 3:] = base[55, 3:]
    codes = np.unique(base, axis=0)
    sets = [{tuple(np.delete(r, d)) for d in range(32)
             if not (np.delete(r, d) >= 4).any()} for r in codes]
    want = [any(i != j and sets[i] & sets[j] for j in range(len(codes)))
            for i in range(len(codes))]
    np.testing.assert_array_equal(
        leven.delset_partner_mask(_t(codes)).numpy(), want)


def _fixture(name, rng):
    """The three retention fixtures of tests/test_knn.py:273-354: clustered
    20-mers, the filter_k=2 overflow 12-mers, repeat clusters."""
    def rand(n, length):
        return rng.integers(0, 4, (n, length)).astype(np.uint8)
    if name == "clustered":
        base = rand(150, 20)
        rows = [base, _near(rng, base[:30], 1, 0), _near(rng, base[:30], 0, 1)]
    elif name == "overflow":
        base = rand(30, 12)
        rows = [base, _near(rng, base[:10], 1, 0)]
    else:
        motif = rand(1, 12)
        subs = []
        for pos in range(0, 12, 2):
            for b in range(4):
                m = motif.copy()
                m[0, pos] = b
                subs.append(m)
        rep = [np.array([[(i + s) % 2 for i in range(12)]]) for s in (0, 1)]
        homo = np.zeros((3, 12), np.uint8)
        homo[1, -1] = 1
        homo[2, 0] = 1
        rows = [rand(40, 12), *subs, *rep, homo]
    codes = np.concatenate(rows).astype(np.uint8)
    _, first = np.unique(codes, axis=0, return_index=True)
    return codes[np.sort(first)]


@pytest.mark.parametrize("name,filter_k", [("clustered", 64),
                                           ("overflow", 2),
                                           ("repeats", 2)])
@pytest.mark.parametrize("e", [2, 3, 4, 5])
def test_pass_filter_matches_jax(name, filter_k, e):
    codes = _fixture(name, np.random.default_rng(17))
    c = _t(codes)
    got = leven.leven_pass_filter(c, c, e, filter_k=filter_k).numpy()
    want = jl.leven_pass_filter(codes, codes, e, filter_k=filter_k)
    np.testing.assert_array_equal(got, want)
    dm = leven_block(c, c).numpy()
    np.fill_diagonal(dm, 99)
    np.testing.assert_array_equal(got, dm.min(axis=1) >= e)


def test_pass_filter_reaches_every_tier(monkeypatch):
    """The clustered fixture at e=5 with filter_k=2 overflows the candidate
    lists of both directions, so all four tiers run; and a query subset
    (not all-vs-all) finds its database rows by match_rows."""
    codes = _fixture("clustered", np.random.default_rng(17))
    calls = []
    for name in ("feature_count", "leven_topk"):
        real = getattr(stream, name)
        monkeypatch.setattr(stream, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    c = _t(codes)
    got = leven.leven_pass_filter(c, c, 5, filter_k=2).numpy()
    assert calls.count("feature_count") == 2 and "leven_topk" in calls
    np.testing.assert_array_equal(got, jl.leven_pass_filter(codes, codes, 5))
    sub = codes[::3].copy()
    np.testing.assert_array_equal(
        leven.match_rows(_t(sub), c).numpy(), np.arange(len(codes))[::3])
    for e in (3, 4):
        np.testing.assert_array_equal(
            leven.leven_pass_filter(_t(sub), c, e).numpy(),
            jl.leven_pass_filter(sub, codes, e))


def _seqs(rng, n, length, with_n=False):
    codes = rng.integers(0, 4, size=(n, length)).astype(np.uint8)
    m = min(20, n // 4)
    codes[n // 2:n // 2 + m] = _near(rng, codes[:m], 0, 1)
    if with_n:
        codes[::17, 3] = dna.INVALID
    return list(dict.fromkeys(dna.decode_rows(codes)))


@pytest.mark.parametrize("k", [1, 4, 9])
def test_index_query_matches_jax_index(k):
    rng = np.random.default_rng(5)
    seqs = _seqs(rng, 300, 20, with_n=True)
    queries = seqs[:40] + _seqs(rng, 20, 20, with_n=True)
    got = KnnIndex(seqs, metric="leven", device="cpu").query(queries, k)
    ref = JaxKnnIndex(seqs, metric="leven", backend="xla").query(queries, k)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("case,counting", [
    ("member", True), ("member_arrow", True), ("subset", True),
    ("nonmember", False), ("duplicated", False)])
def test_index_retention_matches_jax(case, counting, monkeypatch):
    """The counting tiers where their preconditions hold, the k=2 query
    where they do not, at e 2 to 5."""
    seqs = _seqs(np.random.default_rng(9), 250, 16)
    db, queries = seqs, seqs
    if case == "member_arrow":
        db = pd.Series(seqs, dtype="str")
        queries = db
    elif case == "subset":
        queries = seqs[::4]
    elif case == "nonmember":
        qc = dna.encode(seqs[0]).copy()
        qc[0] ^= 1
        queries = [dna.decode_rows(qc[None, :])[0], seqs[1]]
    elif case == "duplicated":
        db, queries = seqs + [seqs[0]], seqs[:50]
    calls = []
    monkeypatch.setattr(leven, "leven_pass_filter",
                        lambda *a, _r=leven.leven_pass_filter:
                        calls.append(1) or _r(*a))
    import guidemaker_tpu_torch.knn.driver as port_driver
    monkeypatch.setattr(port_driver, "leven_pass_filter",
                        leven.leven_pass_filter)
    for e in (2, 3, 4, 5):
        got = KnnIndex(db, metric="leven", device="cpu").pass_distance_filter(
            queries, e)
        ref = JaxKnnIndex(list(db), metric="leven",
                          backend="xla").pass_distance_filter(list(queries), e)
        np.testing.assert_array_equal(got, ref)
    assert bool(calls) == counting


def test_index_save_load(tmp_path):
    """A leven index saved by either package loads with its metric."""
    seqs = _seqs(np.random.default_rng(13), 200, 20)
    path = str(tmp_path / "jax.npz")
    JaxKnnIndex(seqs, metric="leven", backend="xla").save(path)
    port = KnnIndex.load(path)
    assert port.metric == "leven" and port.device.type == "cpu"
    port.save(str(tmp_path / "port.npz"))
    again = KnnIndex.load(str(tmp_path / "port.npz"))
    assert again.metric == "leven" and again.seqs == seqs
    ref = JaxKnnIndex(seqs, metric="leven", backend="xla").query(seqs[:30], 5)
    for got in (port.query(seqs[:30], 5), again.query(seqs[:30], 5)):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_index_metric_and_k_cap():
    """An unknown metric raises; a Levenshtein query beyond the kernel's
    128-neighbor list raises instead of padding with -1."""
    seqs = _seqs(np.random.default_rng(3), 200, 20)
    with pytest.raises(ValueError, match="metric"):
        KnnIndex(seqs, metric="cosine", device="cpu")
    idx = KnnIndex(seqs, metric="leven", device="cpu")
    assert idx.query(seqs[:2], 128)[0].shape == (2, 128)
    with pytest.raises(ValueError, match="k must be"):
        idx.query(seqs[:2], 129)
    # the control search's calls stay Hamming on a leven index
    d, _ = idx.hamming_query_codes(dna.encode_batch(seqs[:5], 20), 1)
    assert (d[:, 0] == 0).all()
    assert (idx.count_within(dna.encode_batch(seqs[:5], 20), 1) == 1).all()


def test_n_at_32_bases_differs_from_jax_only_in_the_n_rule():
    """At 32 bases the JAX package leaves Myers for its DP, whose cost lets
    N equal N; the port keeps "N matches nothing" at every length.  So the
    two agree on N-free guides and on pairs where only one side has an N,
    and part only where both sides hold an N at aligned positions."""
    rng = np.random.default_rng(32)
    q, db = _codes(rng, 20, 60, 32, with_n=False)
    db[5] = q[0]
    q[0, 4] = db[5, 4] = dna.INVALID              # N against N
    got = unpack_keys(leven.leven_topk(_t(q), _t(db), 60))
    d, i = (a.numpy() for a in got)
    jd, ji = jl.leven_topk(q, db, 60)
    port = np.array([[_oracle(a, b) for b in db] for a in q])
    jax = np.array([[_oracle(a, b, n_equal_n=True) for b in db] for a in q])
    np.testing.assert_array_equal(np.take_along_axis(port, i, 1), d)
    np.testing.assert_array_equal(np.take_along_axis(jax, ji, 1), jd)
    differ = port != jax
    assert differ.any() and set(zip(*np.nonzero(differ))) == {(0, 5)}
    np.testing.assert_array_equal(d[1:], jd[1:])


def test_controls_on_leven_index_match_jax(monkeypatch, tmp_path):
    """The control search on a Levenshtein index is Hamming by definition:
    given one injected candidate stream, both packages return the same
    frame and count the same candidates."""
    from guidemaker_tpu.scan import PamTarget as JaxPamTarget
    from guidemaker_tpu_torch.scan import PamTarget
    port_t = PamTarget("NGG", "5prime", "leven").find_targets(
        parse_fasta(FASTA), 20)
    ref_t = JaxPamTarget("NGG", "5prime", "leven").find_targets(
        jax_parse_fasta(FASTA), 20)
    uniq = list(pd.unique(port_t["target"]))
    config = _config(tmp_path, [1, 10, 1000])
    _inject(monkeypatch, _draw(dna.encode_batch(uniq, 20), 0.03), 3)
    tl = targets.TargetProcessor(port_t, lsr=10, device="cpu")
    tl.create_index()
    jtl = jax_targets.TargetProcessor(ref_t, lsr=10)
    jtl.index = JaxKnnIndex(uniq, metric="leven", backend="pallas")
    assert tl.index.metric == jtl.index.metric == "leven"
    got = tl.get_control_seqs(parse_fasta(FASTA), config, length=20, n=N,
                              seed=SEED)
    want = jtl.get_control_seqs(jax_parse_fasta(FASTA), config, length=20,
                                n=N, seed=SEED)
    assert got[:2] == want[:2]
    pd.testing.assert_frame_equal(got[2], want[2])
    assert tl.ncontrolsearched == jtl.ncontrolsearched


def test_wrapper_checks():
    launched = (stream.feature_count_launches.n, stream.leven_topk_launches.n)
    rows = gram_rows(torch.zeros((3, 20), dtype=torch.uint8), 0)
    with pytest.raises(ValueError):
        stream.feature_count(rows, rows, 17, 0)          # width mismatch
    with pytest.raises(ValueError):
        stream.feature_count(rows, rows, 18, 64 * 18 + 1)
    with pytest.raises(ValueError):
        stream.feature_count(rows.to(torch.int32), rows, 18, 0)
    with pytest.raises(ValueError):
        gram_rows(torch.zeros((3, 33), dtype=torch.uint8), 0)
    q = pack_codes(torch.zeros((3, 20), dtype=torch.uint8))
    with pytest.raises(ValueError):
        stream.leven_topk(q, q, 20, 0)
    with pytest.raises(ValueError):
        stream.leven_topk(q, q, 20, 129)
    meta = torch.empty((4, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        stream.leven_topk(meta, meta, 20, 2)
    assert stream.feature_count(rows, rows, 18, 0).shape == (3,)
    assert stream.leven_topk(q, q, 20, 5).shape == (3, 3)
    # the plain versions launch nothing
    assert (stream.feature_count_launches.n,
            stream.leven_topk_launches.n) == launched


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("glen", FEATURE_EDGE_WORDS)
def test_feature_count_matches_plain_on_card(cuda_device, glen):
    """The kernel at its k256 step edges: query blocks of 1, 15 and 1000
    rows (an all-N block among them), a database ragged against its
    128-row tiles, t 3 and 4 in both directions, the threshold edges."""
    rng = np.random.default_rng(glen)
    qn, dbn = _codes(rng, 1000, 20003, glen + 2)
    qn[256:512] = dna.INVALID
    q, db = (torch.from_numpy(a).to(cuda_device) for a in (qn, dbn))
    for t in (3, 4):
        for qr, dr in ((gram_rows(q, 0), gram_rows(db, t)),
                       (gram_rows(q, t), gram_rows(db, 0))):
            for nq in (1, 15, 1000):
                for thresh in {0, max(0, glen - 3 * t - 1), glen - 1, glen}:
                    assert torch.equal(
                        stream.feature_count(qr[:nq], dr, glen, thresh),
                        feature_count_plain(qr[:nq], dr, thresh)), (
                            t, nq, thresh)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [20, 32])
def test_leven_topk_matches_plain_on_card(cuda_device, L):
    rng = np.random.default_rng(L)
    q, db = (pack_codes(torch.from_numpy(a).to(cuda_device))
             for a in _codes(rng, 500, 20000, L))
    for k in (1, 2, 5, 64, 128):
        assert torch.equal(stream.leven_topk(q, db, L, k),
                           leven_topk_plain(q, db, L, k))
