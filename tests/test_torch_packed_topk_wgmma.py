"""The packed-pair top-k kernel's wgmma design (csrc/packed_topk.cu) in
numpy, against the port's plain packed top-k and the JAX package's packed
top-k kernel (Pallas in interpret mode on the CPU, as tests/test_packed.py
runs it).

The model takes the packed count's B rows (tests/test_torch_packed_wgmma.py
``_wgmma_b_tile``) with the even rows in units and 1 at lane K - 1; gives
each query row its lanes [0, 3L) and its bias b = 4 dK - 3L - 1 at lane
K - 1; multiplies per m64 tile of a 256-query block and 64-row tile of pair
rows (128 columns in guide order); keeps the 2-bit top-k's sub-lists and
quad gate (tests/test_torch_knn.py ``_quad_gate``) at kcap <= 32 and one
list a row above; and merges the splits.  Every result is an integer, so
the tolerance is exact equality.  The inputs are N-free codes made with
numpy from a seed.  The kernel itself needs the card
(test_packed_kernels_edges_on_card in tests/test_torch_packed.py, and
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from guidemaker_tpu.knn import pallas_packed as pp
from guidemaker_tpu_torch.knn import packed as pk
from guidemaker_tpu_torch.knn.hamming import INF_KEY, MAX_K, unpack_keys
from test_torch_knn import (TOPK_QUAD_KCAP, _a_fragments, _keys_to_pairs,
                            _lane_of_column, _quad_gate)
from test_torch_packed_wgmma import (WG_BLOCK, WG_PAIR_TILE, _model_codes,
                                     _t, _wgmma_b_tile, _wgmma_k)

#: queries an m64 tile (one consumer warpgroup's product)
WG_M_TILE = 64


def _unit_bytes(x):
    """packed_common.cuh ``unit_bytes`` on int8 bytes: each byte's sign bit
    spread over the byte (prmt's sign mode), or'ed with its low bit."""
    u = x.view(np.uint8)
    return (np.where(u >= 0x80, 0xff, 0) | (u & 1)).astype(
        np.uint8).view(np.int8)


def _topk_b_tile(dbrows, length, t0, hi):
    """The top-k producer's B rows (produce_pairs with kUnit) of the 64 pair
    rows at t0: the count's (:func:`_wgmma_b_tile`), each even row's bytes
    through unit_bytes (+-s to +-1, the bias lane's s at 3L to 1), then 1 at
    lane K - 1 of every row."""
    b = _wgmma_b_tile(dbrows, length, t0, hi).copy()
    s = pk.pack_scale(length)
    assert set(np.unique(b[0::2]).tolist()) <= {0, s, -s}
    b[0::2] = _unit_bytes(b[0::2])
    b[:, -1] = 1
    return b


def _topk_a_rows(qrows, length, bias):
    """The consumers' A rows: the query row's lanes [0, 3L) (its second
    copy zeroed) and the row's bias at lane K - 1."""
    k = _wgmma_k(length)
    a = qrows[:, :k].astype(np.int64)
    a[:, 3 * length:] = 0
    a[:, k - 1] = bias
    return a


def _wgmma_packed_topk_model(q, db, length, k, n_splits, drop_padding=True,
                             trace=None):
    """csrc/packed_topk.cu's arithmetic in numpy: per block of 256 queries
    and database split of whole 64-row tiles of pair rows, each tile as 128
    B rows in units (:func:`_topk_b_tile`, rows past the split's end
    padding), per m64 tile of queries an int32 product with the A rows
    (:func:`_topk_a_rows`) whose bias lane holds b = 4 dK - 3L - 1, every
    sum an int8; the pairs with a sum >= 0 on a column below
    min(split end, nd) (unless ``drop_padding`` is false) as keys
    ((3L + b - sum) >> 2 << 24) | col, column c of the tile at pair row t0
    being guide 2 t0 + c.  For kcap <= 32 each lane t of a quad keeps each
    row's sub-list of kcap keys over its columns 8j + 2t + c, dK is the
    quad gate, and the quad merges its four sub-lists at the end of the
    split; for larger kcaps each row keeps one list and dK is its K-th
    distance.  Then the merge of the splits' lists.  ``trace`` (a dict), if
    given, collects "padding" (the columns at or past min(split end, nd)
    whose sum passed, in the first block's first split), "sums" (the least
    and the largest sum), "gates" (for each tile of the first block's first
    split, the kcap-th distance of each sub-list of query 0 and its gate)
    and "lists" (the splits' lists, (nq, n_splits, kcap)).  Returns
    (nq, min(k, nd, 128)) int64 keys."""
    nq, nd = q.shape[0], db.shape[0]
    qrows, dbrows = (r.numpy() for r in (pk.query_rows(_t(q)),
                                         pk.db_rows(_t(db))))
    n2, three_l = dbrows.shape[0], 3 * length
    k_eff = min(k, nd, MAX_K)
    kcap = 1 << (k_eff - 1).bit_length()
    quad = kcap <= TOPK_QUAD_KCAP
    per = -(-(-(-n2 // WG_PAIR_TILE)) // n_splits) * WG_PAIR_TILE
    lane_t = _lane_of_column(np.arange(2 * WG_PAIR_TILE))
    trace = {} if trace is None else trace
    trace.update(padding=set(), sums=(0, 0), gates=[])
    lists = np.full((nq, n_splits, kcap), INF_KEY, np.int64)
    for b0 in range(0, nq, WG_BLOCK):
        rows = min(WG_BLOCK, nq - b0)
        for split in range(n_splits):
            lo, hi = split * per, min(n2, (split + 1) * per)
            ghi = min(2 * hi, nd)
            first = split == 0 and b0 == 0
            sub = np.full((rows, 4 if quad else 1, kcap), INF_KEY, np.int64)
            # the lists start empty: dK = L + 1
            bias = np.full(rows, 4 * (length + 1) - three_l - 1, np.int64)
            for t0 in range(lo, hi, WG_PAIR_TILE):
                b = _topk_b_tile(dbrows, length, t0, hi).astype(np.int64)
                a = _topk_a_rows(qrows[b0:b0 + rows], length, bias)
                acc = np.concatenate([a[m0:m0 + WG_M_TILE] @ b.T
                                      for m0 in range(0, rows, WG_M_TILE)])
                assert -128 <= acc.min() and acc.max() <= 127
                trace["sums"] = (min(trace["sums"][0], int(acc.min())),
                                 max(trace["sums"][1], int(acc.max())))
                col = 2 * t0 + np.arange(2 * WG_PAIR_TILE)
                real = col < ghi
                top = three_l + bias[:, None] - acc
                # a guide's sum is 3L - 4h + b: top is 4h, h in [0, L]
                assert (top[:, real] % 4 == 0).all()
                assert (top[:, real] >= 0).all()
                assert (top[:, real] <= 4 * length).all()
                passed = acc >= 0
                if first:
                    trace["padding"] |= set(
                        col[(passed & ~real).any(0)].tolist())
                if drop_padding:
                    passed &= real
                keys = np.where(passed, ((top >> 2) << 24) | col, INF_KEY)
                for t in range(sub.shape[1]):
                    own = keys[:, lane_t == t] if quad else keys
                    sub[:, t] = np.sort(np.concatenate([sub[:, t], own], 1),
                                        1)[:, :kcap]
                dist = np.minimum(sub >> 24, length + 1)
                gate = (_quad_gate(dist, kcap) if quad
                        else dist[:, 0, kcap - 1])
                bias = 4 * gate - three_l - 1
                if first:
                    trace["gates"].append((dist[0, :, kcap - 1], gate[0]))
            lists[b0:b0 + rows, split] = np.sort(sub.reshape(rows, -1),
                                                 1)[:, :kcap]
    trace["lists"] = lists
    return np.sort(lists.reshape(nq, -1), 1)[:, :k_eff]


def _check_model(q, db, length, ks, splits=(1, 2, 3)):
    """The model at each number of ``splits``, and the JAX packed kernel,
    against ``packed_topk_plain`` at each k of ``ks``."""
    nd = db.shape[0]
    qr, dbr = pk.query_rows(_t(q)), pk.db_rows(_t(db))
    dbj = pp.prepare_db_packed(db, 128)
    for k in ks:
        want = pk.packed_topk_plain(qr, dbr, nd, length, k).numpy()
        for n_splits in splits:
            np.testing.assert_array_equal(
                _wgmma_packed_topk_model(q, db, length, k, n_splits), want,
                err_msg=f"k {k}, {n_splits} splits")
        ref = pp.packed_topk_device(q, dbj, nd, k, length, db_tile=128,
                                    interpret=True)
        got = _keys_to_pairs(want, k)
        np.testing.assert_array_equal(got[0], ref[0], err_msg=f"JAX, k {k}")
        np.testing.assert_array_equal(got[1], ref[1], err_msg=f"JAX, k {k}")


@pytest.mark.parametrize("length", range(1, pk.MAX_PACKED_LEN + 1))
def test_topk_b_rows_in_units(length):
    """The top-k producer's rows, for every L a row holds: B row 2p =
    [tetra(guide 2p) | 1 | 0 .. | 1] and B row 2p + 1 = [tetra(guide
    2p + 1) | 1 | 0 .. | 1] over K bytes, the 1s at lanes 3L and K - 1 (one
    lane at L 21); the odd slot of the last pair row when nd is odd, and
    rows at or past the split's end, carry only those 1s."""
    rng = np.random.default_rng(800 + length)
    nd = 101
    db = rng.integers(0, 4, size=(nd, length)).astype(np.uint8)
    dbrows = pk.db_rows(_t(db)).numpy()
    tetra = pk._tetra(_t(db)).numpy().astype(np.int64)
    k, three_l = _wgmma_k(length), 3 * length
    assert three_l <= k - 1 and (three_l == k - 1) == (length == 21)
    want = np.zeros((2 * WG_PAIR_TILE, k), np.int64)
    for t0, hi in ((0, 51), (WG_PAIR_TILE, 51)):
        want[:] = 0
        want[:, three_l] = want[:, k - 1] = 1
        for r in range(t0, min(t0 + WG_PAIR_TILE, hi)):
            want[2 * (r - t0), :three_l] = tetra[2 * r]
            if 2 * r + 1 < nd:
                want[2 * (r - t0) + 1, :three_l] = tetra[2 * r + 1]
        np.testing.assert_array_equal(_topk_b_tile(dbrows, length, t0, hi),
                                      want)


def test_unit_bytes_of_every_scaled_byte():
    """unit_bytes maps 0 to 0 and +-s to +-1 for every s = 4L + 1 of
    L 1..21, the bias lane's s to 1; the odd rows' +-1 stay as they are."""
    for length in range(1, pk.MAX_PACKED_LEN + 1):
        s = pk.pack_scale(length)
        x = np.array([0, s, -s, 1, -1], np.int8)
        np.testing.assert_array_equal(_unit_bytes(x), [0, 1, -1, 1, -1])


def test_topk_sum_code_for_every_gate():
    """For every L a row holds, every distance h of a guide and every gate
    distance dK (0..L + 1): the bias b = 4 dK - 3L - 1 and the sum
    3L - 4h + b are int8, the sum is >= 0 iff h < dK, and
    (3L + b - sum) >> 2 is h exactly; a padding column's sum, b alone, is
    >= 0 iff 4 dK >= 3L + 1, so from the start (dK = L + 1, b = L + 3)."""
    for length in range(1, pk.MAX_PACKED_LEN + 1):
        three_l = 3 * length
        h = np.arange(length + 1)[:, None]
        dk = np.arange(length + 2)[None, :]
        bias = 4 * dk - three_l - 1
        total = three_l - 4 * h + bias
        assert -128 <= bias.min() and bias.max() <= 127
        assert -128 <= total.min() and total.max() <= 127
        np.testing.assert_array_equal(total >= 0, h < dk)
        np.testing.assert_array_equal((three_l + bias - total) >> 2,
                                      np.broadcast_to(h, total.shape))
        np.testing.assert_array_equal(bias[0] >= 0, 4 * dk[0] >= three_l + 1)
        assert bias[0, -1] == length + 3


#: guide lengths at the wgmma top-k's k32-step edges (K 32 at L <= 10, 64
#: at L 11..21), lane 3L at each offset class of a word (3L % 4), and L 21,
#: where lane 3L is K - 1; k at its list edges (kcap 1, 2, 4, 8, 32, 128)
WG_TOPK_LENGTHS = [1, 10, 11, 16, 20, 21]
WG_TOPK_KS = [1, 2, 3, 5, 20, 128]


@pytest.mark.parametrize("nd", [300, 301])
@pytest.mark.parametrize("length", WG_TOPK_LENGTHS)
def test_wgmma_packed_topk_model_matches_plain_and_jax(length, nd):
    """The wgmma top-k's design equals ``packed_topk_plain`` and the JAX
    packed top-k kernel exactly: every k32-step edge (L), every list edge
    (k), 1 to 3 splits, two query blocks (the second ragged), a database
    ragged against its 64-row tiles of pair rows with nd even and odd, and
    duplicated guides."""
    q, db = _model_codes(length, 300, nd, 1000 + 3 * length + nd)
    _check_model(q, db, length, WG_TOPK_KS)


@pytest.mark.parametrize("nd,k", [(1, 1), (2, 5), (3, 5), (3, 2),
                                  (129, 128), (257, 128)])
def test_wgmma_packed_topk_model_small_database(nd, k):
    """k above nd (the list keeps its sentinels and the wrapper pads with
    -1), one and two guides in one pair row, three guides with an odd slot
    left over, a tile of one guide past 128 and one pair row past two
    tiles, splits left empty, row lists at kcap 128."""
    q, db = _model_codes(20, 70, nd, 50 + nd + k)
    _check_model(q, db, 20, (k,))


def _variants(guide, positions):
    """Copies of a guide, each with one more base changed at ``positions``
    (copy i at distance i + 1)."""
    out = np.repeat(guide[None], len(positions), 0)
    for i, p in enumerate(positions):
        out[i:, p] = (out[i:, p] + 1) % 4
    return out


@pytest.mark.parametrize("k", [1, 3, 5, 20])
def test_wgmma_packed_topk_model_ties(k):
    """Equal-distance copies of a guide on the even and the odd slot of one
    pair row (guides 4 and 5), on every lane of a quad, and in three tiles:
    the lists keep the lowest guides, as the plain top-k and the JAX kernel
    do."""
    q, db = _model_codes(20, 70, 400, 70 + k)
    guide = db[4].copy()
    copies = [4, 5, 6, 8, 10, 130, 133, 260]     # distance 0
    near = [3, 129, 131, 263]                    # distance 1
    db[copies] = guide
    db[near] = _variants(guide, [0])[0]
    q[0], q[1] = guide, db[3]
    assert set(_lane_of_column(np.array(copies[:5]))) == {0, 1, 2, 3}
    assert {c // (2 * WG_PAIR_TILE) for c in copies} == {0, 1, 2}
    _check_model(q, db, 20, (k,))
    got = _wgmma_packed_topk_model(q, db, 20, k, 1)
    d, i = (t.numpy() for t in unpack_keys(torch.from_numpy(
        got[:1].astype(np.int32))))
    order = sorted(copies) + sorted(near)
    np.testing.assert_array_equal(i[0, :12], order[:k])
    np.testing.assert_array_equal(d[0, :12], ([0] * 8 + [1] * 4)[:k])


@pytest.mark.parametrize("k", [4, 8])
def test_wgmma_packed_topk_model_uneven_sub_lists(k):
    """A query whose close neighbors all lie on one lane's columns of the
    first tile, even and odd slots: that lane's sub-list fills with them
    while the other three hold far guides, and the gate, taken over the
    quad, is that one lane's K-th distance."""
    rng = np.random.default_rng(90 + k)
    q, db = _model_codes(20, 70, 701, 90 + k)
    q[0] = rng.integers(0, 4, 20)
    # every other guide differs from q[0] at every base
    db[:] = (q[0] + 1 + rng.integers(0, 3, size=db.shape)) % 4
    cols = np.flatnonzero(_lane_of_column(np.arange(128)) == 1)[:k]
    assert {c % 2 for c in cols} == {0, 1}
    db[cols] = _variants(q[0], range(k))
    trace = {}
    _wgmma_packed_topk_model(q, db, 20, k, 1, trace=trace)
    kth, gate = trace["gates"][0]
    assert gate == kth[1] == k
    assert (np.delete(kth, 1) > gate).all()
    _check_model(q, db, 20, (k,), splits=(1, 3))


@pytest.mark.parametrize("nd,k", [(3, 5), (7, 8), (21, 32), (101, 128)])
def test_wgmma_packed_topk_model_padding_columns_pass(nd, k):
    """While a row's lists are not full its bias is L + 3, and a column
    that is no guide (the odd slot of the last pair row, nd odd, and the
    pair rows past the split, all zeros but the bias lanes) sums to the
    bias alone and passes the gate, in the sub-lists (kcap 8, 32) and the
    row lists (kcap 128): only the index drops it, and without the drop the
    splits' lists hold keys of columns that are no guide."""
    q, db = _model_codes(20, 70, nd, 110 + nd)
    trace = {}
    _wgmma_packed_topk_model(q, db, 20, k, 1, trace=trace)
    assert nd in trace["padding"] and nd + 1 in trace["padding"]
    kept = trace["lists"][trace["lists"] != INF_KEY]
    assert ((kept & 0xffffff) < nd).all()
    _wgmma_packed_topk_model(q, db, 20, k, 1, drop_padding=False,
                             trace=trace)
    bad = trace["lists"][trace["lists"] != INF_KEY]
    assert ((bad & 0xffffff) >= nd).any()
    _check_model(q, db, 20, (k,), splits=(1,))


def test_wgmma_packed_topk_sums_reach_both_int8_ends_at_l21():
    """At L 21 the sums reach both ends of [-4L - 1, 4L + 3] = [-85, 87]
    and stay int8: a query equal to guide 0 sums 3L + L + 3 = 87 in the
    first tile, where its bias is still L + 3; once its k = 1 list holds
    that guide (dK 0, bias -3L - 1 = -64), guides that differ at every base
    (A = -L) sum -85."""
    length = 21
    rng = np.random.default_rng(21)
    q = rng.integers(0, 4, size=(40, length)).astype(np.uint8)
    db = ((q[0] + 1 + rng.integers(0, 3, size=(600, length))) % 4).astype(
        np.uint8)
    db[0] = q[0]
    trace = {}
    _wgmma_packed_topk_model(q, db, length, 1, 1, trace=trace)
    assert trace["sums"] == (-4 * length - 1, 4 * length + 3)
    _check_model(q, db, length, (1,), splits=(1, 2))


@pytest.mark.parametrize("length", [1, 10, 11, 20, 21])
def test_wgmma_packed_topk_bias_byte_in_the_a_fragment(length):
    """The bias lane, K byte K - 1 of a query row, lies in the A fragments
    of lane t 3 of each quad, register 2 (row g) or 3 (row g + 8) of the
    last k32 step, byte 3, and nowhere else, at every L.  The byte is 0
    before the bias is written only because the query's second copy (lanes
    [3L, 6L)) is zeroed: it reaches lane K - 1 wherever 6L > K - 1."""
    k = _wgmma_k(length)
    steps = k // 32
    q, db = _model_codes(length, 70, 300, 130 + length)
    qrows = pk.query_rows(_t(q[:64])).numpy()
    raw = _a_fragments(qrows[:, :k].astype(np.int64), steps)
    real = _a_fragments(_topk_a_rows(qrows, length, 0), steps)
    assert not real[:, 3::4, steps - 1, 2:, 3].any()
    assert raw[:, 3::4, steps - 1, 2:, 3].any() == (6 * length > k - 1)
    marks = np.zeros((64, k), np.int64)
    marks[:, k - 1] = -1 - np.arange(64)
    frag = _a_fragments(marks, steps)
    w, lane, s, r, byte = np.nonzero(frag)
    assert len(w) == 64
    assert (lane % 4 == 3).all() and (s == steps - 1).all()
    assert (byte == 3).all() and set(r) == {2, 3}
    row = 16 * w + lane // 4 + 8 * (r - 2)
    np.testing.assert_array_equal(frag[w, lane, s, r, byte], -1 - row)
    _check_model(q, db, length, (1, 5), splits=(1,))
