"""The packed-pair count kernel's wgmma design (csrc/packed_count.cu) in
numpy, against the port's plain packed count and the JAX package's packed
count kernel (Pallas in interpret mode on the CPU, as tests/test_packed.py
runs it).

The model splits each pair row into two B rows with the s and 1 bias
lanes as the kernel's producer does, word by word; gives each query row
-(T + 1) at lane 3L; multiplies K = 32 ceil((3L + 1) / 32) bytes per 256
queries and 64-row tile of pair rows; and masks the padding slots of a
split's last tile by index.  Every result is an integer, so the tolerance
is exact equality.  The inputs are N-free codes made with numpy from a
seed.  The kernel itself needs the card (test_packed_kernels_edges_on_card
in tests/test_torch_packed.py, and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from guidemaker_tpu.knn import pallas_packed as pp
from guidemaker_tpu_torch.knn import packed as pk


def _t(a):
    return torch.from_numpy(a)


def _model_codes(length, nq, nd, seed):
    """N-free database with a duplicated guide and a distance-1 pair;
    queries that mix members and random guides, the last one the last
    guide (an odd slot when nd is even)."""
    rng = np.random.default_rng(seed)
    db = rng.integers(0, 4, size=(nd, length)).astype(np.uint8)
    if nd >= 4:
        db[nd // 2] = db[0]
        db[nd // 3] = db[1]
        db[nd // 3, 0] ^= 1
    q = rng.integers(0, 4, size=(nq, length)).astype(np.uint8)
    q[:nq // 2] = db[rng.integers(0, nd, nq // 2)]
    q[-1] = db[-1]
    return q, db


#: the wgmma count's block: 256 queries (four consumer warpgroups of one
#: m64 tile each); ring tiles of 64 pair rows, the 128 B rows of one
#: m64n128 product
WG_BLOCK, WG_PAIR_TILE = 256, 64


def _wgmma_k(length):
    """K bytes of the wgmma count's rows: lanes [0, 3L) and the bias lane
    3L, in whole k32 steps (32 at L <= 10, 64 at L 11..21)."""
    return 32 * -(-(3 * length + 1) // 32)


def _wgmma_b_tile(dbrows, length, t0, hi):
    """csrc/packed_count.cu:produce in numpy, word by word: the 64 pair rows
    at t0 (rows at or past hi load as zeros) as 128 B rows of K bytes.
    Thread p of the producer writes B row p from half p & 1 of pair row
    p // 2: the even half loads the row's 16-byte chunks 0.., the odd half
    the chunks from kJ // 4 on (kJ = 3L // 4, the word of lane 3L), as many
    as the wider of the two needs; word j <= kJ of the B row is word j of
    the even half, or the odd half's words moved down by 3L bytes (a funnel
    shift by 8 (3L % 4) bits), and word kJ keeps its bytes below lane 3L
    and takes the bias, s = 4L + 1 (even) or 1 (odd), at lane 3L."""
    kj, shift = 3 * length // 4, 8 * (3 * length % 4)
    k_words = _wgmma_k(length) // 4
    even_chunks = kj // 4 + 1
    chunks = max(even_chunks, (2 * kj + 1) // 4 - kj // 4 + 1)
    assert kj // 4 + chunks <= 8 and kj < k_words
    tile = np.zeros((WG_PAIR_TILE, pk.LANES), np.int8)
    part = dbrows[t0:min(t0 + WG_PAIR_TILE, hi)]
    tile[:part.shape[0]] = part
    words = tile.view("<u4").astype(np.uint64)
    ev = np.zeros((WG_PAIR_TILE, 4 * chunks), np.uint64)
    ev[:, :4 * even_chunks] = words[:, :4 * even_chunks]
    od = words[:, 4 * (kj // 4):4 * (kj // 4 + chunks)]
    b = np.zeros((2 * WG_PAIR_TILE, k_words), np.uint64)
    for j in range(kj + 1):
        moved = od[:, kj % 4 + j]
        if shift:
            moved = ((od[:, kj % 4 + j + 1] << np.uint64(32) | moved)
                     >> np.uint64(shift)) & np.uint64(0xffffffff)
        b[0::2, j], b[1::2, j] = ev[:, j], moved
    below = np.uint64((1 << shift) - 1)
    for rows, bias in ((b[0::2], pk.pack_scale(length)), (b[1::2], 1)):
        rows[:, kj] = rows[:, kj] & below | np.uint64(bias << shift)
    return b.astype("<u4").view(np.int8)


def _wgmma_a_rows(qrows, length, editdist):
    """The consumers' A rows: the query row's lanes [0, 3L) (its second
    copy zeroed), -(T + 1) at lane 3L, T = 3L - 4 editdist."""
    a = qrows[:, :_wgmma_k(length)].astype(np.int64)
    a[:, 3 * length:] = 0
    a[:, 3 * length] = 4 * editdist - 3 * length - 1
    assert -128 <= a[:, 3 * length].min() and a.max() <= 127
    return a


def _wgmma_packed_count_model(q, db, length, editdist, n_splits,
                              mask=True):
    """csrc/packed_count.cu's arithmetic in numpy: database splits of whole
    64-row tiles of pair rows, each tile split into 128 B rows
    (:func:`_wgmma_b_tile`), per block of 256 queries and tile the int32
    product with the A rows (:func:`_wgmma_a_rows`) from scale-d 0, and a
    count of the sums >= 0 whose column is below the tile's real guides,
    which fall short of 128 only in a split's last tile (``mask`` false
    drops that mask)."""
    nd = db.shape[0]
    qrows, dbrows = (r.numpy() for r in (pk.query_rows(_t(q)),
                                         pk.db_rows(_t(db))))
    n2 = dbrows.shape[0]
    a = _wgmma_a_rows(qrows, length, editdist)
    per = -(-(-(-n2 // WG_PAIR_TILE)) // n_splits) * WG_PAIR_TILE
    out = np.zeros(q.shape[0], np.int32)
    for lo in range(0, n_splits * per, per):
        hi = min(n2, lo + per)
        ghi = min(2 * hi, nd)
        for t0 in range(lo, hi, WG_PAIR_TILE):
            b = _wgmma_b_tile(dbrows, length, t0, hi).astype(np.int64)
            real = ghi - 2 * t0
            assert real > 0
            assert real >= 2 * WG_PAIR_TILE or t0 + WG_PAIR_TILE >= hi
            cols = np.arange(2 * WG_PAIR_TILE) < (real if mask else 1 << 30)
            for b0 in range(0, q.shape[0], WG_BLOCK):
                acc = a[b0:b0 + WG_BLOCK] @ b.T
                assert np.abs(acc).max() < 1 << 31
                out[b0:b0 + WG_BLOCK] += ((acc >= 0) & cols).sum(
                    1, dtype=np.int32)
    return out


@pytest.mark.parametrize("length", range(1, pk.MAX_PACKED_LEN + 1))
def test_wgmma_b_rows_split_each_pair_row(length):
    """The producer's word moves give, for every L a row holds, B row 2p =
    [s * tetra(guide 2p) | s | 0] and B row 2p + 1 = [tetra(guide 2p + 1) |
    1 | 0] over K bytes; the odd slot of the last pair row, when nd is
    odd, and rows at or past the split's end carry only the bias lane."""
    rng = np.random.default_rng(700 + length)
    nd = 101
    db = rng.integers(0, 4, size=(nd, length)).astype(np.uint8)
    dbrows = pk.db_rows(_t(db)).numpy()
    tetra = pk._tetra(_t(db)).numpy().astype(np.int64)
    k, s, three_l = _wgmma_k(length), pk.pack_scale(length), 3 * length
    want = np.zeros((2 * WG_PAIR_TILE, k), np.int64)
    for t0, hi in ((0, 51), (WG_PAIR_TILE, 51)):
        want[:] = 0
        want[0::2, three_l], want[1::2, three_l] = s, 1
        for r in range(t0, min(t0 + WG_PAIR_TILE, hi)):
            want[2 * (r - t0), :three_l] = s * tetra[2 * r]
            if 2 * r + 1 < nd:
                want[2 * (r - t0) + 1, :three_l] = tetra[2 * r + 1]
        np.testing.assert_array_equal(
            _wgmma_b_tile(dbrows, length, t0, hi), want)
    assert k % 32 == 0 and three_l < k <= three_l + 32


#: nd at the wgmma count's tile edge (128 guides a tile of 64 pair rows):
#: one short, on it, one past; odd and even
WG_MODEL_ND = (255, 256, 257)


def _wgmma_editdists(length):
    """0, 2, 7, the first editdist with T + 1 <= 0 (4e >= 3L + 1, where a
    padding slot's sum -c(T + 1) passes the sign gate) and L."""
    first_neg = -(-(3 * length + 1) // 4)
    return sorted({e for e in (0, 2, 7, first_neg, length) if e <= length})


@pytest.mark.parametrize("nd", WG_MODEL_ND)
@pytest.mark.parametrize("length", range(1, pk.MAX_PACKED_LEN + 1))
def test_wgmma_packed_count_model_matches_plain_and_jax(length, nd):
    """The wgmma count's design, for every L a row holds: each pair row
    split into two B rows with the s and 1 bias lanes, the query's
    -(T + 1) lane, K = 32 ceil((3L + 1) / 32), 1 and 3 splits of 64-row
    tiles, and the index mask of padding slots, against
    ``packed_count_plain`` and the JAX packed count kernel (Pallas in
    interpret mode) at editdist 0, 2, 7, ceil((3L + 1) / 4) and L."""
    q, db = _model_codes(length, 100, nd, 900 + 3 * length + nd)
    qr, dbr = pk.query_rows(_t(q)), pk.db_rows(_t(db))
    dbj = pp.prepare_db_packed(db, 128)
    for editdist in _wgmma_editdists(length):
        want = pk.packed_count_plain(qr, dbr, nd, length, editdist).numpy()
        for n_splits in (1, 3):
            np.testing.assert_array_equal(
                _wgmma_packed_count_model(q, db, length, editdist, n_splits),
                want, err_msg=f"editdist {editdist}, {n_splits} splits")
        np.testing.assert_array_equal(
            pp.packed_count_device(q, dbj, nd, editdist, length, db_tile=128,
                                   interpret=True), want,
            err_msg=f"JAX, editdist {editdist}")
        if editdist == 0:
            assert not want.any()


@pytest.mark.parametrize("length", [1, 10, 11, 20, 21])
def test_wgmma_padding_slots_need_the_index_mask(length):
    """A slot that is no guide (the odd slot of the last pair row when nd
    is odd, rows past a split's end) sums to -c(T + 1): below 0 while
    4 editdist < 3L + 1, so dropping the mask changes nothing there, but
    from editdist ceil((3L + 1) / 4) on every such slot counts for every
    query.  nd 201 leaves 55 such slots in the last tile, in 1 split or
    in 3."""
    q, db = _model_codes(length, 40, 201, length)
    first_neg = -(-(3 * length + 1) // 4)
    for n_splits in (1, 3):
        for editdist in sorted({max(0, first_neg - 1), first_neg, length}):
            good = _wgmma_packed_count_model(q, db, length, editdist,
                                             n_splits)
            bad = _wgmma_packed_count_model(q, db, length, editdist,
                                            n_splits, mask=False)
            extra = 2 * 2 * WG_PAIR_TILE - 201 if editdist >= first_neg else 0
            np.testing.assert_array_equal(bad - good, np.full(40, extra))


@pytest.mark.parametrize("nd", [1, 2, 3, 129])
def test_wgmma_packed_count_model_small_database(nd):
    """One pair row with its odd slot empty or full, two pair rows with an
    odd slot left over, and a tile of one guide past 128; splits left
    empty."""
    q, db = _model_codes(20, 70, nd, nd)
    qr, dbr = pk.query_rows(_t(q)), pk.db_rows(_t(db))
    for editdist in (0, 2, 16, 20):
        want = pk.packed_count_plain(qr, dbr, nd, 20, editdist).numpy()
        for n_splits in (1, 3):
            np.testing.assert_array_equal(
                _wgmma_packed_count_model(q, db, 20, editdist, n_splits),
                want, err_msg=f"editdist {editdist}, {n_splits} splits")
