"""The 3-gram count kernel's wgmma design (csrc/feature_count.cu) in numpy,
against the port's plain 3-gram count and the JAX package's Pallas count
kernel (interpret mode on the CPU, as tests/test_pallas.py runs it).

The model follows the kernel step by step: the producer's copy of a
128-row tile into a stage of 16-byte chunk columns, [chunk][row][16
bytes] (the TMA's box when a row is whole chunks, rows past the database
zero; else the producer warp's 8-byte copies lane by lane, 8 rows x 4
words an instruction, rows past the split's end zero-filled), the bytes
no copy writes left as whatever the stage held, random here; the B
operand read back through the descriptor of each k256 step; each
consumer's 64 queries as m64 A fragments in registers (up to 5 steps) or
staged in shared memory in B's layout (6 to 8 steps); the 1-bit products;
the sums started at -(thresh + 1); count_tile's sign AND and count over
each lane's 32 sums of a row; and the quad sum added once a split.  Every
result is an integer, so the tolerance is exact equality.  The kernel
itself needs the card (test_feature_count_matches_plain_on_card in
tests/test_torch_leven.py, and chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from guidemaker_tpu.knn import leven as jl
from guidemaker_tpu.knn.pallas_stream import _stream_count
from guidemaker_tpu_torch import dna
from guidemaker_tpu_torch.knn.features import feature_count_plain, gram_rows

#: the block: four consumer warpgroups of one m64 tile of queries each;
#: ring tiles of 128 database rows, the N of one m64n128 product
BLOCK, TILE, CONSUMER = 256, 128, 64
_LANE = np.arange(32)


def _steps(n_words):
    """k256 steps of a row: 4 words (32 bytes) a step."""
    return -(-n_words // 4)


def _smem_a(steps):
    """Whether the kernel keeps A in shared memory (above 5 steps)."""
    return steps > 5


def _core_offset(r, w, n_rows):
    """Byte of word w of row r in a tile of n_rows rows stored as
    [chunk][row][16 bytes] (csrc/feature_count.cu word_offset)."""
    return (w >> 1) * 16 * n_rows + r * 16 + (w & 1) * 8


def _stage(db_words, t0, hi, steps, tma, rng):
    """(32 S * 128,) uint8: the producer's copy of the tile at row t0 of
    the split [.., hi) into a stage.  The TMA writes its box, 2 words x 128
    rows x G / 2 chunks, in box order, rows past the database zero.  The
    cp.async producer's lane l copies rows 8 j + l / 4 and words
    4 c + l % 4 to dst + 16 (r - l / 4) + 4096 c, rows past hi
    zero-filled; each 8-byte slot is written at most once.  Slots no copy
    writes keep the stage's old bytes."""
    nd, n_words = db_words.shape
    stage = rng.integers(0, 1 << 63, TILE * 4 * steps, dtype=np.uint64)
    if tma:
        x = np.arange(2)[None, None, :]
        y = np.arange(TILE)[None, :, None]
        z = np.arange(n_words // 2)[:, None, None]
        # a split ends on a tile but at the database's end
        assert hi == nd or hi - t0 >= TILE
        slot = ((z * TILE + y) * 2 + x).ravel()      # box order, dim 0 first
        r = np.broadcast_to(y, (n_words // 2, TILE, 2)).ravel()
        word = np.broadcast_to(2 * z + x, (n_words // 2, TILE, 2)).ravel()
        inside = t0 + r < nd
    else:
        lane = _LANE[:, None, None]
        row_l, col_l = lane >> 2, lane & 3
        dst = _core_offset(row_l, col_l, TILE)
        j = np.arange(TILE // 8)[None, :, None]
        c = np.arange(steps)[None, None, :]
        r = 8 * j + row_l
        word = 4 * c + col_l
        live = np.broadcast_to(word < n_words, np.broadcast(r, c).shape)
        off = dst + 16 * (r - row_l) + 4096 * c
        r, word, off = (np.broadcast_to(a, live.shape)[live]
                        for a in (r, word, off))
        slot = off // 8
        inside = r < min(TILE, hi - t0)
    assert len(np.unique(slot)) == len(slot), "a slot written twice"
    data = np.zeros(len(slot), np.uint64)
    data[inside] = db_words[t0 + r[inside], word[inside]]
    stage[slot] = data
    # every word of every row of the tile is copied, where the layout says
    written = np.zeros((TILE, n_words), bool)
    written[r, word] = True
    assert written.all()
    np.testing.assert_array_equal(8 * slot, _core_offset(r, word, TILE))
    return stage.view(np.uint8)


def _desc_rows(smem, base, n_rows, s):
    """(n_rows, 32) uint8: the rows of the k256 step s of a tile of n_rows
    rows at byte base, as its wgmma descriptor (tile_desc) addresses them:
    K-major core matrices of 8 rows x 16 bytes, 16 n_rows bytes apart
    along K (the leading byte offset) and 128 apart along the rows (the
    stride byte offset), step s 32 n_rows s bytes in."""
    n = np.arange(n_rows)[:, None]
    k = np.arange(32)[None, :]
    return smem[base + 32 * n_rows * s + (k >> 4) * 16 * n_rows +
                (n >> 3) * 128 + (n & 7) * 16 + (k & 15)]


def _a_registers(q_units, qw, nq, n_words, steps):
    """(4 warps, 32 lanes, S, 4) uint32: feature_a for the warps of the
    consumer whose rows start at qw: register 2h + half of step s of lane
    4g + t holds unit 8s + 4h + t of row qw + 16 warp + 8 half + g; a unit
    past 2 n_words, or a row past nq, is zero."""
    w = np.arange(4)[:, None, None, None]
    g, t = (_LANE >> 2)[None, :, None, None], (_LANE & 3)[None, :, None, None]
    s = np.arange(steps)[None, None, :, None]
    i = np.arange(4)[None, None, None, :]
    row = qw + 16 * w + 8 * (i & 1) + g
    unit = 8 * s + 4 * (i >> 1) + t
    ok = (row < nq) & (unit < 2 * n_words)
    return np.where(ok, q_units[np.minimum(row, nq - 1),
                                np.minimum(unit, 2 * n_words - 1)], 0)


def _a_from_registers(a):
    """(S, 64, 32) uint8: the A tile that the m64 register fragments hold,
    each byte 8 k lanes as in the s8 k32 layout: lane 4g + t of warp w
    holds in register i bytes 16 (i >> 1) + 4t .. + 3 of row
    16 w + 8 (i & 1) + g."""
    steps = a.shape[2]
    out = np.zeros((steps, CONSUMER, 32), np.uint8)
    as_bytes = a.astype("<u4").view(np.uint8).reshape(4, 32, steps, 4, 4)
    for w, lane, i in np.ndindex(4, 32, 4):
        g, t = lane >> 2, lane & 3
        m = 16 * w + 8 * (i & 1) + g
        kb = 16 * (i >> 1) + 4 * t
        out[:, m, kb:kb + 4] = as_bytes[w, lane, :, i]
    return out


def _staged_queries(q_words, block, nq, steps):
    """(256 * 32 S,) uint8: stage_queries' shared copy of the block's
    queries, consumer c's 64 rows a [chunk][row][16 bytes] tile at
    64 * 32 S c, words n_words..4S - 1 and rows past nq zero."""
    n_words = q_words.shape[1]
    a = np.zeros(BLOCK * 4 * steps, np.uint64)
    row = np.arange(BLOCK)[:, None]
    w = np.arange(4 * steps)[None, :]
    qi = block * BLOCK + row
    ok = (qi < nq) & (w < n_words)
    vals = np.where(ok, q_words[np.minimum(qi, nq - 1),
                                np.minimum(w, n_words - 1)], 0)
    off = (row >> 6) * (CONSUMER * 32 * steps) + _core_offset(row & 63, w,
                                                             CONSUMER)
    a[(off // 8).ravel()] = vals.ravel().astype(np.uint64)
    return a.view(np.uint8)


def _popc_product(a_bytes, b_bytes):
    """(64, 128) int64: the AND-popcount of every A row with every B row."""
    a = np.unpackbits(a_bytes, axis=1).astype(np.int64)
    b = np.unpackbits(b_bytes, axis=1).astype(np.int64)
    return a @ b.T


def _count_tile(sums):
    """count_tile on an m64 x n128 tile of sums in the accumulator layout:
    lane 4g + t of warp w holds for its row 16 w + 8 h + g the 32 sums of
    columns 8 j + 2 t + c; the AND of a
    lane's sums of a row keeps the sign bit iff none is >= 0; a lane counts
    nothing when both its rows keep it, else each row without it counts its
    sums >= 0.  Returns (64,) the quad sums per row."""
    w = np.arange(4)[:, None, None, None, None]
    g = (_LANE >> 2)[None, :, None, None, None]
    t = (_LANE & 3)[None, :, None, None, None]
    h = np.arange(2)[None, None, :, None, None]
    j = np.arange(16)[None, None, None, :, None]
    c = np.arange(2)[None, None, None, None, :]
    lanes = sums[16 * w + 8 * h + g, 8 * j + 2 * t + c]   # [w, lane, h, j, c]
    lanes = lanes.reshape(4, 32, 2, 32)
    all_ = np.bitwise_and.reduce(lanes, axis=3)            # [w, lane, h]
    idle = (all_[..., 0] & all_[..., 1]) < 0
    cnt = np.where((all_ >= 0) & ~idle[..., None],
                   32 - (lanes < 0).sum(3), 0)              # [w, lane, h]
    quad = cnt.reshape(4, 8, 4, 2).sum(2)                   # [w, g, h]
    return quad.transpose(0, 2, 1).reshape(CONSUMER)


def _wgmma_feature_count(q_rows, db_rows, thresh, n_splits, tma=None,
                         seed=0):
    """(nq,) int64: csrc/feature_count.cu in numpy on (n, G) int64 feature
    rows, with the database cut into n_splits splits of whole tiles, as
    launch() cuts it; ``tma`` forces the producer's TMA or its cp.async
    copies (default: the kernel's choice, the TMA when G is even)."""
    q_words = np.ascontiguousarray(q_rows).view(np.uint64)
    db_words = np.ascontiguousarray(db_rows).view(np.uint64)
    nq, n_words = q_words.shape
    nd = db_words.shape[0]
    steps = _steps(n_words)
    if tma is None:
        tma = n_words % 2 == 0
    rng = np.random.default_rng(seed)
    q_units = q_words.view(np.uint32).reshape(nq, 2 * n_words)
    tiles = -(-nd // TILE)
    rows_per_split = -(-tiles // n_splits) * TILE
    out = np.zeros(nq, np.int64)
    for block in range(-(-nq // BLOCK)):
        if _smem_a(steps):
            staged = _staged_queries(q_words, block, nq, steps)
        a_tiles = []
        for c in range(4):
            if _smem_a(steps):
                a_tiles.append(np.stack([
                    _desc_rows(staged, CONSUMER * 32 * steps * c, CONSUMER,
                               s) for s in range(steps)]))
            else:
                a_tiles.append(_a_from_registers(_a_registers(
                    q_units, block * BLOCK + CONSUMER * c, nq, n_words,
                    steps)))
        for split in range(n_splits):
            lo = split * rows_per_split
            hi = min(nd, lo + rows_per_split)
            if lo >= hi:
                continue
            cnt = np.zeros(BLOCK, np.int64)
            for t0 in range(lo, hi, TILE):
                stage = _stage(db_words, t0, hi, steps, tma, rng)
                b = [_desc_rows(stage, 0, TILE, s) for s in range(steps)]
                for c in range(4):
                    sums = np.full((CONSUMER, TILE), -(thresh + 1), np.int64)
                    for s in range(steps):
                        sums += _popc_product(a_tiles[c][s], b[s])
                    cnt[CONSUMER * c:CONSUMER * (c + 1)] += _count_tile(sums)
            rows = slice(block * BLOCK, min(nq, (block + 1) * BLOCK))
            out[rows] += cnt[:rows.stop - rows.start]
    return out


def _model_codes(rng, nq, nd, length):
    """Queries with N bases (an all-N run among them); a database holding
    copies of queries and one-base variants of them, the last partial tile
    full of copies, so that the splits' ragged ends count."""
    q = rng.integers(0, 4, size=(nq, length)).astype(np.uint8)
    db = rng.integers(0, 4, size=(nd, length)).astype(np.uint8)
    m = min(nq, nd // 4)
    db[:m] = q[:m]
    db[m:2 * m] = q[:m]
    db[m:2 * m, rng.integers(0, length)] ^= 1
    tail = nd % TILE or TILE
    db[nd - tail:] = q[rng.integers(0, nq, tail)]
    q[::7, rng.integers(0, length)] = dna.INVALID
    q[32:40] = dna.INVALID
    db[::11, rng.integers(0, length)] = dna.INVALID
    return q, db


def _jax_count(q, db, tq, td, glen, thresh):
    """The JAX package's Pallas count (interpret mode) on its own gram
    features of the same codes, padded to its tiles with N rows."""
    L = q.shape[1]
    qp = np.full((-(-q.shape[0] // 32) * 32, L), dna.INVALID, np.uint8)
    qp[:q.shape[0]] = q
    dp = np.full((-(-db.shape[0] // 128) * 128, L), dna.INVALID, np.uint8)
    dp[:db.shape[0]] = db
    ref = _stream_count(jl._gram_feats_on_device(jnp.asarray(qp), t=tq),
                        jl._gram_feats_on_device(jnp.asarray(dp), t=td),
                        length=glen, editdist=glen - thresh, q_tile=32,
                        db_tile=128, interpret=True)
    return np.asarray(ref)[:q.shape[0], 0]


@pytest.mark.parametrize("glen,n_splits", [
    (5, 1), (5, 3), (18, 1), (18, 2), (18, 7), (29, 2), (29, 5)])
def test_wgmma_model_over_splits_matches_plain_and_jax(glen, n_splits):
    """A database ragged against the 128-row tiles (nd = 3 tiles + 37) cut
    into splits whose last tile is partial, its rows copies of queries so
    that the counts rise there; cp.async copies (G 5, 29), the TMA (G 18),
    A in registers (G 5, 18) and in shared memory (G 29)."""
    L, t = glen + 2, 3
    rng = np.random.default_rng(100 + glen + n_splits)
    q, db = _model_codes(rng, 70, 3 * TILE + 37, L)
    q_rows, db_rows = gram_rows(torch.from_numpy(q), 0), gram_rows(
        torch.from_numpy(db), t)
    for thresh in sorted({max(0, glen - 3 * t - 1), glen - 1}):
        got = _wgmma_feature_count(q_rows.numpy(), db_rows.numpy(), thresh,
                                   n_splits)
        want = feature_count_plain(q_rows, db_rows, thresh).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"thresh {thresh}")
        np.testing.assert_array_equal(
            want, _jax_count(q, db, 0, t, glen, thresh),
            err_msg=f"thresh {thresh}")
        assert (want >= 2).any()


@pytest.mark.parametrize("glen", [4, 18, 30])
def test_wgmma_model_copies_agree(glen):
    """At an even G the producer copies by TMA, unless db lies off 16
    bytes; its cp.async copies fill the same stage and give the same counts
    (G 4: one step, G 18: five, G 30: eight, A in shared memory)."""
    rng = np.random.default_rng(glen)
    q, db = _model_codes(rng, 40, TILE + 5, glen + 2)
    q_rows, db_rows = (gram_rows(torch.from_numpy(a), 3).numpy()
                       for a in (q, db))
    thresh = max(0, glen - 10)
    by_tma = _wgmma_feature_count(q_rows, db_rows, thresh, 2, tma=True)
    by_cp = _wgmma_feature_count(q_rows, db_rows, thresh, 2, tma=False)
    np.testing.assert_array_equal(by_tma, by_cp)
    np.testing.assert_array_equal(
        by_tma, feature_count_plain(torch.from_numpy(q_rows),
                                    torch.from_numpy(db_rows),
                                    thresh).numpy())
