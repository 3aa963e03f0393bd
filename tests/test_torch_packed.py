"""The port's packed-pair layout against the JAX package's packed kernels.

The same N-free codes, made with numpy from a seed, go through the JAX
package's packed kernels (Pallas in interpret mode on the CPU, as
tests/test_packed.py runs them) and through the port's wrappers, which run
the plain PyTorch versions on a CPU tensor.  Every result is an integer,
so the tolerance is exact equality.  A numpy model of the CUDA kernels'
arithmetic (split sums, biases, gates, masks, splits) is held against
both.  The kernels themselves need the card (the ``cuda`` tests here and
in tests/test_torch_knn.py).
"""
import numpy as np
import pytest
import torch

from guidemaker_tpu.knn import pallas_packed as pp
from guidemaker_tpu.knn.driver import KnnIndex as JaxKnnIndex
from guidemaker_tpu_torch import dna
from guidemaker_tpu_torch.knn import KnnIndex, stream
from guidemaker_tpu_torch.knn import packed as pk
from guidemaker_tpu_torch.knn.driver import use_packed
from guidemaker_tpu_torch.knn.hamming import INF_KEY, MAX_DB, unpack_keys


def _codes(rng, nq, nd, length):
    """N-free database with a duplicated guide and a distance-1 pair;
    queries that mix members and random guides."""
    db = rng.integers(0, 4, size=(nd, length)).astype(np.uint8)
    if nd >= 4:
        db[nd // 2] = db[0]
        db[nd // 3] = db[1]
        db[nd // 3, 0] ^= 1
    q = rng.integers(0, 4, size=(nq, length)).astype(np.uint8)
    q[:nq // 2] = db[rng.integers(0, nd, nq // 2)]
    return q, db


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("L,nd", [(10, 257), (20, 512), (21, 257)])
@pytest.mark.parametrize("editdist", [0, 1, 5, "L"])
def test_count_matches_jax_packed_kernel(L, nd, editdist):
    editdist = L if editdist == "L" else editdist
    rng = np.random.default_rng(nd + L)
    q, db = _codes(rng, 100, nd, L)
    got = stream.packed_count(pk.query_rows(_t(q)), pk.db_rows(_t(db)), nd,
                              L, editdist)
    ref = pp.packed_count_device(q, pp.prepare_db_packed(db, 128), nd,
                                 editdist, L, db_tile=128, interpret=True)
    np.testing.assert_array_equal(got.numpy(), ref)
    if editdist == 0:
        assert not got.any()


@pytest.mark.parametrize("L,nd,k", [(10, 300, 3), (20, 257, 5),
                                    (21, 512, 4), (20, 3, 5)])
def test_topk_matches_jax_packed_kernel(L, nd, k):
    rng = np.random.default_rng(nd * 3 + L)
    q, db = _codes(rng, 64, nd, L)
    keys = stream.packed_topk(pk.query_rows(_t(q)), pk.db_rows(_t(db)), nd,
                              L, k)
    d, i = (t.numpy() for t in unpack_keys(keys))
    ref_d, ref_i = pp.packed_topk_device(q, pp.prepare_db_packed(db, 128), nd,
                                         k, L, db_tile=128, interpret=True)
    k_eff = min(k, nd)
    np.testing.assert_array_equal(d, ref_d[:, :k_eff])
    np.testing.assert_array_equal(i, ref_i[:, :k_eff])
    assert (ref_d[:, k_eff:] == -1).all()


@pytest.mark.parametrize("nd", [6, 7])
def test_rows_match_jax_layout(nd):
    """Query and database rows are the JAX package's, lane for lane; an odd
    nd leaves a zero odd slot in the last row."""
    rng = np.random.default_rng(nd)
    codes = rng.integers(0, 4, size=(nd, 21)).astype(np.uint8)
    np.testing.assert_array_equal(
        pk.query_rows(_t(codes)).numpy(),
        np.asarray(pp._query_rows(codes, length=21)))
    ref = np.asarray(pp.prepare_db_packed(codes, 8))[:-(-nd // 2)]
    got = pk.db_rows(_t(codes)).numpy()
    np.testing.assert_array_equal(got, ref)
    if nd % 2:
        assert not got[-1, 63:].any()


@pytest.mark.parametrize("length", range(1, pk.MAX_PACKED_LEN + 1))
def test_decode_exact_over_full_range(length):
    """Every (A, B) pair a row can produce decodes exactly, both by the
    plain versions' floor division and by the float32 formula of the JAX
    package's Pallas kernels (pallas_packed.py: floor((v + L + 0.5) *
    (1/s))).  The CUDA kernels need no decode: they keep the two sums
    apart (csrc/packed_common.cuh)."""
    s = pk.pack_scale(length)
    a = torch.arange(-length, 3 * length + 1, dtype=torch.int32)
    b = torch.arange(-length, 3 * length + 1, dtype=torch.int32)
    v = s * a[:, None] + b[None, :]
    want_a, want_b = torch.broadcast_tensors(a[:, None], b[None, :])
    for dtype in (torch.int32, torch.float32):
        dec_a, dec_b = pk.decode(v.to(dtype), length)
        assert torch.equal(dec_a.to(torch.int32), want_a)
        assert torch.equal(dec_b.to(torch.int32), want_b)
    inv_s = torch.tensor(1.0, dtype=torch.float32) / s
    vl = (v + length).to(torch.float32) + 0.5
    assert torch.equal(torch.floor(vl * inv_s).to(torch.int32), want_a)


def test_tetrahedron_dot_counts_matches():
    """A query row dotted with a database row's even half gives
    s * (4m - L); a query row holds the guide twice."""
    rng = np.random.default_rng(4)
    q, db = _codes(rng, 30, 40, 20)
    qr = pk.query_rows(_t(q)).to(torch.int32)
    even = pk.db_rows(_t(db)).to(torch.int32)[:, :60]
    matches = 20 - (q[:, None, :] != db[None, 0::2, :]).sum(2)
    np.testing.assert_array_equal((qr[:, :60] @ even.T).numpy(),
                                  pk.pack_scale(20) * (4 * matches - 20))


#: guide lengths at the packed kernels' k32-step edges: 1 step (L 1, 5),
#: 2 (L 10), 3 (L 11, 16), 4 (L 20, 21); lane 3L straddles a step at every
#: offset class, and 3L = 63 is not a multiple of 4 at L 21
MODEL_LENGTHS = [1, 5, 10, 11, 16, 20, 21]
#: k at the top-k's list edges: kcap 1, 2, 4, 8, 32 and 128
MODEL_KS = [1, 2, 3, 5, 20, 128]
#: pair rows a tile, pair rows a batch, queries a block and a warp
TILE, BATCH, BLOCK, WARP = 128, 16, 256, 32


def _model_editdists(length):
    """0-3, L, and the first editdist with T + 1 <= 0 (T = 3L - 4e), from
    which a zero slot's sum passes the count's sign gate."""
    first_neg = -(-(3 * length + 1) // 4)
    return sorted({e for e in (0, 1, 2, 3, first_neg, length)
                   if e <= length})


def _steps(length):
    """(even k32 steps, all k32 steps) of the split product."""
    return -(-3 * length // 32), -(-6 * length // 32)


def _a_fragments(qrows, length):
    """csrc/packed_common.cuh:load_pair_a: the int8 query rows ``[t|t|0]``
    as the even operand (steps 0..ES-1, lanes >= 3L zeroed) and the odd
    one (steps ES-1..NS-1, lanes < 3L zeroed)."""
    es, ns = _steps(length)
    lanes = np.arange(32 * ns)
    a = qrows[:, :32 * ns].astype(np.int64)
    return (np.where(lanes < 3 * length, a, 0)[:, :32 * es],
            np.where(lanes >= 3 * length, a, 0)[:, 32 * (es - 1):])


def _ring_tile(dbrows, t0, hi, ns):
    """A ring buffer of the kernels after load_pair_tile: 128 pair rows at
    a stride of 32 NS + 16 bytes, the first 32 NS bytes of each database
    row, zero-filled from ``hi``; the 16 pad bytes a row (here 0x55) are
    never read.  Returns the (128, 32 NS) rows that ldmatrix reads."""
    stride = 32 * ns + 16
    ring = np.full((TILE, stride), 0x55, np.int8)
    part = dbrows[t0:min(t0 + TILE, hi), :32 * ns]
    ring[:, :32 * ns] = 0
    ring[:part.shape[0], :32 * ns] = part
    return ring[:, :32 * ns].astype(np.int64)


def _split_sums(even, odd, rows, es, bias_e, bias_o):
    """acc_e = s*A and acc_o = B of 16 pair rows, from their biases."""
    return (even @ rows[:, :32 * es].T + bias_e,
            odd @ rows[:, 32 * (es - 1):].T + bias_o)


def _lane_pass(passing):
    """The count's per-lane gate: (nq, 16) sums >= 0 -> whether the lane
    holding each sum has one >= 0.  Lane (g, t) of a warp holds rows g,
    g + 8, g + 16, g + 24 and pair rows 8 nt + 2t + e."""
    nq = passing.shape[0]
    pad = np.zeros((-(-nq // WARP) * WARP, BATCH), bool)
    pad[:nq] = passing
    lanes = pad.reshape(-1, 4, 8, 2, 4, 2).any(axis=(1, 3, 5))
    return np.broadcast_to(lanes[:, None, :, None, :, None],
                           (lanes.shape[0], 4, 8, 2, 4, 2)).reshape(
                               -1, BATCH)[:nq]


def _splits(n2, n_splits):
    tiles = -(-n2 // TILE)
    per = -(-tiles // n_splits) * TILE
    return [(lo, min(n2, lo + per)) for lo in range(0, n_splits * per, per)]


def _packed_count_model(q, db, length, editdist, n_splits):
    """csrc/packed_count.cu's arithmetic in numpy: split A fragments from
    the query rows, database splits of whole 128-row tiles zero-filled at
    the ragged edge, 16-row batches whose sums start at acc_e = -s(T+1)
    and acc_o = -(T+1), the lane's sign gate, and each sum >= 0 counted
    when its guide index is below the split's end and nd."""
    nd = db.shape[0]
    qrows, dbrows = (r.numpy() for r in (pk.query_rows(_t(q)),
                                         pk.db_rows(_t(db))))
    es, ns = _steps(length)
    even, odd = _a_fragments(qrows, length)
    bias_o = -(3 * length - 4 * editdist + 1)
    bias_e = pk.pack_scale(length) * bias_o
    out = np.zeros(q.shape[0], np.int32)
    for lo, hi in _splits(dbrows.shape[0], n_splits):
        ghi = min(2 * hi, nd)
        for t0 in range(lo, hi, TILE):
            tile = _ring_tile(dbrows, t0, hi, ns)
            for n0 in range(0, min(TILE, hi - t0), BATCH):
                acc_e, acc_o = _split_sums(even, odd, tile[n0:n0 + BATCH],
                                           es, bias_e, bias_o)
                gate = _lane_pass((acc_e >= 0) | (acc_o >= 0))
                ge = 2 * (t0 + n0 + np.arange(BATCH))
                hits = (((acc_e >= 0) & (ge < ghi)).astype(np.int32)
                        + ((acc_o >= 0) & (ge + 1 < ghi)))
                out += (hits * gate).sum(1, dtype=np.int32)
    return out


def _stage_positions():
    """The top-k's staging byte of each of a row's 32 batch guides, and
    the guide that the owner's scan reads from each byte: lane t puts
    guide 16 nt + 4t + 2e + slot at byte 8t + 4nt + 2e + slot; byte
    4 wi + b of the row is guide 16 (wi & 1) + 4 (wi >> 1) + b."""
    j = np.arange(32)
    nt, t, low = j // 16, (j % 16) // 4, j % 4
    pos = 8 * t + 4 * nt + low
    p = np.arange(32)
    wi, b = p // 4, p % 4
    return pos, 16 * (wi & 1) + 4 * (wi >> 1) + b


def _packed_topk_model(q, db, length, k, n_splits):
    """csrc/packed_topk.cu's arithmetic in numpy: per block of 256 queries
    and database split, 16-row batches whose sums start at s * bias and
    bias, bias = 4 dK - 3L - 1 (dK: the distance of the row's K-th key,
    L + 1 while its list is not full); a warp's gate (some sum of its 32
    rows >= 0); each sum staged as its guide's distance ((3L + bias -
    acc_e / s) >> 2, the division in float32, or (3L + bias - acc_o) >> 2)
    or 0xff when < 0, at the lane's byte positions; the owner's scan of
    its row's bytes below 0x80 whose guide is below the split's end and
    nd into its sorted list of kcap keys; and the merge of the splits'
    lists.  Returns (nq, min(k, nd, 128)) int64 keys."""
    nq, nd = q.shape[0], db.shape[0]
    qrows, dbrows = (r.numpy() for r in (pk.query_rows(_t(q)),
                                         pk.db_rows(_t(db))))
    es, ns = _steps(length)
    s, three_l = pk.pack_scale(length), 3 * length
    inv_s = np.float32(1) / np.float32(s)
    k_eff = min(k, nd, 128)
    kcap = 1 << (k_eff - 1).bit_length()
    pos, owner = _stage_positions()
    assert (np.sort(pos) == np.arange(32)).all() and (owner[pos] ==
                                                     np.arange(32)).all()
    splits = _splits(dbrows.shape[0], n_splits)
    lists = np.full((nq, n_splits, kcap), INF_KEY, np.int64)
    for b0 in range(0, nq, BLOCK):
        even, odd = _a_fragments(qrows[b0:b0 + BLOCK], length)
        nb = even.shape[0]
        for split, (lo, hi) in enumerate(splits):
            ghi = min(2 * hi, nd)
            best = np.full((nb, kcap), INF_KEY, np.int64)
            for t0 in range(lo, hi, TILE):
                tile = _ring_tile(dbrows, t0, hi, ns)
                for n0 in range(0, min(TILE, hi - t0), BATCH):
                    bias = 4 * np.minimum(best[:, -1] >> 24,
                                          length + 1) - three_l - 1
                    acc_e, acc_o = _split_sums(
                        even, odd, tile[n0:n0 + BATCH], es,
                        s * bias[:, None], bias[:, None])
                    assert (acc_e % s == 0).all()
                    assert np.abs(acc_e).max() < 1 << 13
                    a = np.rint(acc_e.astype(np.float32) * inv_s)
                    top = three_l + bias[:, None]
                    d = np.empty((nb, 2 * BATCH), np.int64)
                    d[:, 0::2] = np.where(acc_e >= 0,
                                          (top - a.astype(np.int64)) >> 2,
                                          0xff)
                    d[:, 1::2] = np.where(acc_o >= 0, (top - acc_o) >> 2,
                                          0xff)
                    passing = d < 0x80
                    assert (d[passing] >= 0).all()
                    assert (d[passing] <= length).all()
                    stage = np.empty_like(d)
                    stage[:, pos] = d
                    gi = 2 * (t0 + n0) + owner
                    for w0 in range(0, nb, WARP):
                        w = slice(w0, w0 + WARP)
                        if not passing[w].any():
                            continue
                        keys = np.where((stage[w] < 0x80) & (gi < ghi),
                                        (stage[w] << 24) | gi, INF_KEY)
                        best[w] = np.sort(np.concatenate([best[w], keys], 1),
                                          1)[:, :kcap]
            lists[b0:b0 + BLOCK, split] = best
    return np.sort(lists.reshape(nq, -1), 1)[:, :k_eff]


def _keys_to_pairs(keys, k):
    """Keys -> (dist, idx) padded with -1 to k columns, as the JAX package
    returns them."""
    d, i = (t.numpy() for t in unpack_keys(torch.from_numpy(
        keys.astype(np.int32))))
    pad = np.full((keys.shape[0], k - keys.shape[1]), -1, np.int32)
    return np.concatenate([d, pad], 1), np.concatenate([i, pad], 1)


def _model_codes(length, nq, nd, seed):
    q, db = _codes(np.random.default_rng(seed), nq, nd, length)
    q[-1] = db[-1]          # the last guide (an odd slot when nd is even)
    return q, db


@pytest.mark.parametrize("nd", [600, 601])
@pytest.mark.parametrize("length", MODEL_LENGTHS)
def test_packed_count_model_matches_plain_and_jax(length, nd):
    """The tensor-core count's split sums, biases, sign gate and
    global-index mask equal ``packed_count_plain`` and the JAX packed
    count kernel exactly: every k32-step edge (L), nd odd and even, a
    database ragged against its 128-row tiles, 1 to 3 splits, every
    editdist edge including those where a zero slot passes the gate."""
    q, db = _model_codes(length, 300, nd, 300 + length + nd)
    qr, dbr = pk.query_rows(_t(q)), pk.db_rows(_t(db))
    dbj = pp.prepare_db_packed(db, 128)
    for editdist in _model_editdists(length):
        want = pk.packed_count_plain(qr, dbr, nd, length, editdist).numpy()
        for n_splits in (1, 2, 3):
            np.testing.assert_array_equal(
                _packed_count_model(q, db, length, editdist, n_splits), want,
                err_msg=f"editdist {editdist}, {n_splits} splits")
        np.testing.assert_array_equal(
            pp.packed_count_device(q, dbj, nd, editdist, length, db_tile=128,
                                   interpret=True), want,
            err_msg=f"JAX, editdist {editdist}")
        if editdist == 0:
            assert not want.any()
        if editdist == length:
            assert (want > 0).all()


def _check_topk_model(q, db, length, ks):
    """The model at 1 to 3 splits, and the JAX packed kernel, against
    ``packed_topk_plain`` at each k of ``ks``."""
    nd = db.shape[0]
    qr, dbr = pk.query_rows(_t(q)), pk.db_rows(_t(db))
    dbj = pp.prepare_db_packed(db, 128)
    for k in ks:
        want = pk.packed_topk_plain(qr, dbr, nd, length, k).numpy()
        for n_splits in (1, 2, 3):
            np.testing.assert_array_equal(
                _packed_topk_model(q, db, length, k, n_splits), want,
                err_msg=f"k {k}, {n_splits} splits")
        ref = pp.packed_topk_device(q, dbj, nd, k, length, db_tile=128,
                                    interpret=True)
        got = _keys_to_pairs(want, k)
        np.testing.assert_array_equal(got[0], ref[0], err_msg=f"k {k}")
        np.testing.assert_array_equal(got[1], ref[1], err_msg=f"k {k}")


@pytest.mark.parametrize("length", MODEL_LENGTHS)
def test_packed_topk_model_matches_plain_and_jax(length):
    """The tensor-core top-k's per-row bias from dK, warp gate, staged
    distances, owner scan, splits and merge equal ``packed_topk_plain``
    and the JAX packed top-k kernel exactly: every k32-step edge (L),
    every list edge (k), 1 to 3 splits, two query blocks, an odd database
    ragged against its tiles with duplicated guides."""
    q, db = _model_codes(length, 300, 601, 400 + length)
    _check_topk_model(q, db, length, MODEL_KS)


@pytest.mark.parametrize("nd,k", [(1, 1), (2, 5), (3, 5), (3, 2),
                                  (257, 128)])
def test_packed_topk_model_small_database(nd, k):
    """k above nd (the list keeps its sentinels and the wrapper pads with
    -1), one and two guides in one pair row, three guides with an odd
    slot left over, splits left empty."""
    q, db = _model_codes(20, 70, nd, nd + k)
    _check_topk_model(q, db, 20, (k,))
    for editdist in (0, 2, 20):
        np.testing.assert_array_equal(
            _packed_count_model(q, db, 20, editdist, 3),
            pk.packed_count_plain(pk.query_rows(_t(q)), pk.db_rows(_t(db)),
                                  nd, 20, editdist).numpy())


def _rand_seqs(rng, n, length=20):
    return list(dict.fromkeys(dna.decode_rows(
        rng.integers(0, 4, (n, length)).astype(np.uint8))))


def _spy(monkeypatch, name):
    calls = []
    real = getattr(stream, name)

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(stream, name, spy)
    return calls


def test_index_matches_jax_packed_index(monkeypatch):
    """KnnIndex(packed=True) against the JAX pallas index routed through
    its packed kernels (tests/test_packed.py's setup)."""
    monkeypatch.setenv("GUIDEMAKER_TPU_PACKED", "1")
    monkeypatch.setattr("guidemaker_tpu.knn.driver.STREAM_THRESHOLD", 64)
    counts = _spy(monkeypatch, "packed_count")
    topks = _spy(monkeypatch, "packed_topk")
    rng = np.random.default_rng(11)
    seqs = _rand_seqs(rng, 201)
    seqs[7] = seqs[8][:-1] + "ACGT"["ACGT".index(seqs[8][-1]) ^ 1]
    port = KnnIndex(seqs, device="cpu", packed=True)
    jax_idx = JaxKnnIndex(seqs, backend="pallas")
    assert port.packed and not port.supports_chunk_triage(7)
    for got, ref in zip(port.query(seqs[:40], 3),
                        jax_idx.query(seqs[:40], 3)):
        np.testing.assert_array_equal(got, ref)
    for editdist in (0, 2, 3):
        np.testing.assert_array_equal(
            port.pass_distance_filter(seqs[:40], editdist),
            jax_idx.pass_distance_filter(seqs[:40], editdist))
    cand = rng.integers(0, 4, (30, 20)).astype(np.uint8)
    for editdist in (0, 5, 20):
        np.testing.assert_array_equal(port.count_within(cand, editdist),
                                      jax_idx.count_within(cand, editdist))
    np.testing.assert_array_equal(port.count_within(_t(cand), 5),
                                  jax_idx.count_within(cand, 5))
    assert port.count_within(cand, 21) is None
    assert counts and topks


def test_n_gate_gives_true_distances(monkeypatch):
    """A packed index over guides with N answers exactly as the JAX xla
    index: the database's N keeps the whole index on the 2-bit kernels,
    and a query batch with N takes them for that call only."""
    counts = _spy(monkeypatch, "packed_count")
    topks = _spy(monkeypatch, "packed_topk")
    rng = np.random.default_rng(12)
    seqs = _rand_seqs(rng, 150)
    with_n = list(seqs)
    with_n[3] = "N" + with_n[3][1:]
    with_n[9] = with_n[3][:-1] + "N"
    idx = KnnIndex(with_n, device="cpu", packed=True)
    ref = JaxKnnIndex(with_n, backend="xla")
    assert not idx.packed
    for got, want in zip(idx.query(with_n[:20], 4), ref.query(with_n[:20], 4)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(idx.pass_distance_filter(with_n, 2),
                                  ref.pass_distance_filter(with_n, 2))
    assert not counts and not topks
    # N-free database, queries with N: those calls take the 2-bit kernels
    idx = KnnIndex(seqs, device="cpu", packed=True)
    ref = JaxKnnIndex(seqs, backend="xla")
    queries = [with_n[3], with_n[9], "N" * 20]
    for got, want in zip(idx.query(queries, 3), ref.query(queries, 3)):
        np.testing.assert_array_equal(got, want)
    qc = dna.encode_batch(queries, 20)
    np.testing.assert_array_equal(idx.count_within(qc, 3),
                                  ref.count_within(qc, 3))
    assert not counts and not topks
    idx.query(seqs[:5], 2)
    assert topks


def test_n_would_count_as_a_quarter_match():
    """Why the gate exists: in the packed rows an N is the zero vector, so
    a query with one N sits at distance 0 from its own row (the true
    distance is 1, since an N matches nothing)."""
    rng = np.random.default_rng(5)
    db = rng.integers(0, 4, (4, 20)).astype(np.uint8)
    q = db[:1].copy()
    q[0, 5] = dna.INVALID
    keys = pk.packed_topk_plain(pk.query_rows(_t(q)), pk.db_rows(_t(db)), 4,
                                20, 1)
    assert unpack_keys(keys)[0].item() == 0
    assert KnnIndex(dna.decode_rows(db), device="cpu",
                    packed=True).query_codes(q, 1)[0][0, 0] == 1


def test_packed_opt_in(monkeypatch):
    monkeypatch.delenv("GUIDEMAKER_TPU_PACKED", raising=False)
    seqs = _rand_seqs(np.random.default_rng(6), 10)
    assert not use_packed(20) and not KnnIndex(seqs, device="cpu").packed
    monkeypatch.setenv("GUIDEMAKER_TPU_PACKED", "1")
    assert use_packed(21) and not use_packed(22)
    assert KnnIndex(seqs, device="cpu").packed
    assert not KnnIndex(seqs, device="cpu", packed=False).packed
    long_seqs = _rand_seqs(np.random.default_rng(6), 10, length=22)
    assert not KnnIndex(long_seqs, device="cpu").packed
    with pytest.raises(ValueError, match="21"):
        KnnIndex(long_seqs, device="cpu", packed=True)


def test_packed_wrapper_checks():
    launched = (stream.packed_count_launches.n, stream.packed_topk_launches.n)
    codes = _t(np.random.default_rng(0).integers(0, 4, (5, 20))
               .astype(np.uint8))
    q, db = pk.query_rows(codes), pk.db_rows(codes)
    with pytest.raises(ValueError, match="editdist"):
        stream.packed_count(q, db, 5, 20, 21)
    with pytest.raises(ValueError, match="length"):
        stream.packed_count(q, db, 5, 22, 2)
    with pytest.raises(ValueError, match="guides"):
        stream.packed_topk(q, db, MAX_DB + 1, 20, 2)
    with pytest.raises(ValueError, match="rows"):
        stream.packed_topk(q, db, 7, 20, 2)
    with pytest.raises(ValueError, match="int8"):
        stream.packed_count(q.to(torch.int32), db, 5, 20, 2)
    with pytest.raises(ValueError, match="k must"):
        stream.packed_topk(q, db, 5, 20, 0)
    meta = torch.empty((4, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="device"):
        stream.packed_count(meta, meta[:2], 4, 20, 2)
    with pytest.raises(ValueError):
        pk.query_rows(torch.zeros((1, 22), dtype=torch.uint8))
    assert stream.packed_topk(q, db, 5, 20, 500).shape == (5, 5)
    # the plain versions launch nothing
    assert (stream.packed_count_launches.n,
            stream.packed_topk_launches.n) == launched


@pytest.mark.parametrize("packed", [False, True])
def test_triage_masks_in_count_chunks(monkeypatch, packed):
    """The control ladder's triage masks equal the JAX package's, also when
    the counts run in several launches."""
    rng = np.random.default_rng(13)
    seqs = _rand_seqs(rng, 120)
    cand = rng.integers(0, 4, (50, 20)).astype(np.uint8)
    cand[:10] = dna.encode_batch(seqs[:10], 20)
    idx = KnnIndex(seqs, device="cpu", packed=packed)
    ref = JaxKnnIndex(seqs, backend="xla")
    want = ref.pass_mask_within(cand, 6)
    assert want[:10].sum() == 0 < want.sum()
    monkeypatch.setattr("guidemaker_tpu_torch.knn.driver._COUNT_CHUNK", 7)
    np.testing.assert_array_equal(idx.pass_mask_within(cand, 6), want)
    np.testing.assert_array_equal(idx.count_within(cand, 6),
                                  ref.count_within(cand, 6))
    assert idx.pass_mask_within(cand[:0], 6).shape == (0,)
    chunks = [_t(cand[:25]), _t(cand[25:])]
    if packed:
        assert idx.pass_mask_chunks(chunks, 6) is None
    else:
        np.testing.assert_array_equal(idx.pass_mask_chunks(chunks, 6), want)
        assert idx.pass_mask_chunks(chunks, 21) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    return torch.device("cuda")


#: the packed kernels' tiling edges on the card, at a small size: k32
#: steps (L), query blocks of 256 (nq), a database ragged against its
#: 128-row tiles, even and odd (nd); chip_smoke.py's phase 3d runs the same
#: edges at full size
EDGE_LENGTHS = [1, 10, 11, 16, 20, 21]
EDGE_NQ = (1, 15, 300)
EDGE_ND = (2_050, 2_051)


@pytest.mark.cuda
@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_packed_kernels_edges_on_card(cuda_device, length):
    """Both packed kernels against their plain versions at their tiling
    edges, every editdist edge of the count (0-3, the first with T < 0,
    L) and every list edge of the top-k (k)."""
    for nd in EDGE_ND:
        qn, dbn = _model_codes(length, max(EDGE_NQ), nd, length + nd)
        q = pk.query_rows(_t(qn).to(cuda_device))
        db = pk.db_rows(_t(dbn).to(cuda_device))
        for nq in EDGE_NQ:
            for e in _model_editdists(length):
                assert torch.equal(
                    stream.packed_count(q[:nq], db, nd, length, e),
                    pk.packed_count_plain(q[:nq], db, nd, length, e)), \
                    (nd, nq, e)
            for k in MODEL_KS:
                assert torch.equal(
                    stream.packed_topk(q[:nq], db, nd, length, k),
                    pk.packed_topk_plain(q[:nq], db, nd, length, k)), \
                    (nd, nq, k)
