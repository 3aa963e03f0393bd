"""The port's k-NN layer against the JAX package's kernels.

The same codes, made with numpy from a seed, go through the JAX kernels
(Pallas in interpret mode on the CPU, as tests/test_pallas.py runs them,
and the XLA reference) and through the port's wrappers, which run the
plain PyTorch versions on a CPU tensor.  Every result is an integer, so
the tolerance is exact equality.  The kernels themselves need the card:
the ``cuda`` tests hold them against the plain versions there.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from guidemaker_tpu import dna as jdna
from guidemaker_tpu.knn.driver import KnnIndex as JaxKnnIndex
from guidemaker_tpu.knn.hamming import hamming_topk as jax_hamming_topk
from guidemaker_tpu.knn.pallas_hamming import (pallas_hamming_topk,
                                               prepare_db_codes)
from guidemaker_tpu.knn.pallas_stream import (stream_count_device,
                                              stream_topk_device)
from guidemaker_tpu_torch import dna
from guidemaker_tpu_torch.knn import KnnIndex, build, stream
from guidemaker_tpu_torch.knn.hamming import (INF_KEY, MAX_K, pack_codes,
                                              unpack_keys)

# (nq, nd, k, L): the shapes of tests/test_pallas.py, plus k > nd
TOPK_CASES = [(100, 300, 3, 20), (257, 1025, 10, 27), (64, 64, 2, 12),
              (64, 1024, 5, 20), (8, 3, 6, 20)]


def _codes(rng, nq, nd, length):
    """Database with N bases and duplicated rows; queries that mix members
    (some with N) and random guides."""
    db = rng.integers(0, 4, size=(nd, length)).astype(np.uint8)
    n_rows = rng.random(nd) < 0.1
    db[n_rows, rng.integers(0, length, n_rows.sum())] = dna.INVALID
    if nd >= 4:
        db[nd // 2] = db[0]            # duplicated guide (N-free or not)
        db[nd // 3] = db[1]
        db[nd // 3, 0] ^= 1            # distance-1 neighbor
    q = rng.integers(0, 4, size=(nq, length)).astype(np.uint8)
    members = rng.integers(0, nd, nq // 2)
    q[:nq // 2] = db[members]
    q[-1, :] = dna.INVALID             # all-N query: matches nothing
    return q, db


def _port_topk(q, db, k, length):
    keys = stream.hamming_topk(pack_codes(torch.from_numpy(q)),
                               pack_codes(torch.from_numpy(db)), length, k)
    d, i = (t.numpy() for t in unpack_keys(keys))
    pad = np.full((q.shape[0], k - d.shape[1]), -1, np.int32)
    return np.concatenate([d, pad], 1), np.concatenate([i, pad], 1)


@pytest.mark.parametrize("nq,nd,k,L", TOPK_CASES)
def test_topk_matches_jax_kernels(nq, nd, k, L):
    rng = np.random.default_rng(nq * 7 + nd)
    q, db = _codes(rng, nq, nd, L)
    got = _port_topk(q, db, k, L)
    q_oh, db_oh = jdna.one_hot_matrix(q), jdna.one_hot_matrix(db)
    ref = {
        "xla": jax_hamming_topk(q_oh, db_oh, k, L),
        "pallas_hamming": pallas_hamming_topk(q_oh, db_oh, k, L, db_tile=256,
                                              q_tile=64, interpret=True),
        "pallas_stream": stream_topk_device(q, prepare_db_codes(db, 128), nd,
                                            k, L, db_tile=128, q_tile=32),
    }
    for name, (d, i) in ref.items():
        np.testing.assert_array_equal(got[0], d, err_msg=name)
        np.testing.assert_array_equal(got[1], i, err_msg=name)
    if k > nd:
        assert (got[0][:, nd:] == -1).all() and (got[1][:, nd:] == -1).all()


@pytest.mark.parametrize("nq,nd,L", [(90, 600, 20), (257, 1025, 27)])
@pytest.mark.parametrize("editdist", [0, 1, 3, "L"])
def test_count_matches_jax_kernel(nq, nd, L, editdist):
    editdist = L if editdist == "L" else editdist
    rng = np.random.default_rng(nd + L)
    q, db = _codes(rng, nq, nd, L)
    got = stream.hamming_count(pack_codes(torch.from_numpy(q)),
                               pack_codes(torch.from_numpy(db)), L, editdist)
    ref = stream_count_device(q, prepare_db_codes(db, 128), nd, editdist, L,
                              db_tile=128, q_tile=32)
    np.testing.assert_array_equal(got.numpy(), ref)
    if editdist == 0:
        assert not got.any()


#: guide lengths at the count kernel's k-padding edges: one k32 step with 4
#: useful bytes, exactly 1 and 3 steps, 3 steps plus 4 bytes padded to 4
COUNT_EDGE_LENGTHS = [1, 8, 20, 24, 25, 27, 32]


def _edge_editdists(length):
    return sorted({e for e in (0, 1, 2, 3, length) if e <= length})


#: the count kernel's block: 256 queries, one m64 tile of 64 queries to
#: each of its four consumer warpgroups; database tiles of 128 rows
COUNT_BLOCK, COUNT_M_TILE, COUNT_TILE = 256, 64, 128


def _block_bases(block):
    """The last valid base of any query of a block, plus 1; 0 if none."""
    valid = np.flatnonzero((block < 4).any(0))
    return int(valid[-1]) + 1 if valid.size else 0


def _wgmma_rows(codes, k_bytes):
    """(n, k_bytes) int32 one-hot rows as the wgmma count decodes a packed
    row: 16-byte chunk c holds bases 4c..4c+3 code-major, byte 4k + b being
    1 iff base 4c + b is valid with code k.  Built as the kernel builds it:
    the row's four code planes (bit 2i of plane k set iff base i is valid
    with code k), each byte of a plane spread to a word by one multiply by
    0x41041 and a mask."""
    packed = pack_codes(torch.from_numpy(codes)).numpy().view(np.uint64)
    rows = np.zeros((codes.shape[0], k_bytes), np.int32)
    for h in range(2):
        x = (packed[:, 0] >> np.uint64(32 * h)) & np.uint64(0xffffffff)
        v = (packed[:, 1] >> np.uint64(32 * h)) & np.uint64(0xffffffff)
        hi = (x >> np.uint64(1)) & np.uint64(0x55555555)
        nx, nhi = ~x & np.uint64(0xffffffff), ~hi & np.uint64(0xffffffff)
        planes = [v & nhi & nx, v & nhi & x, v & hi & nx, v & hi & x]
        for j in range(4):
            c = 4 * h + j
            if 16 * c >= k_bytes:
                break
            for k, plane in enumerate(planes):
                b = (plane >> np.uint64(8 * j)) & np.uint64(0x55)
                w = (b * np.uint64(0x41041)) & np.uint64(0x01010101)
                for byte in range(4):
                    rows[:, 16 * c + 4 * k + byte] = (
                        w >> np.uint64(8 * byte)) & np.uint64(1)
    return rows


def _count_model(q, db, length, editdist, n_splits=1, pad_bias=True):
    """csrc/hamming_count.cu's arithmetic in numpy: per block of 256
    queries with nb bases (the last valid base of any of its queries, plus
    1), one-hot rows of K = 32 KS bytes, KS = ceil(nb / 8), in the kernel's
    code-major order (:func:`_wgmma_rows`); database splits of whole
    128-row tiles, the ragged tile's rows past the split zero rows; per m64
    tile of queries and database tile an int32 product, and a count of the
    sums >= 0.  When nb % 8 != 0, base slot 8 KS - 1 is unused by every
    query of the block and is the bias lane: its code-0 byte, K byte
    32 KS - 13, holds -(thresh + 1) in every query row and 1 in every
    database row, padding rows included unless ``pad_bias`` is false, and
    the product starts at 0; otherwise (no spare lane) the sums start at
    -(thresh + 1).  Returns the counts and the set of paths the blocks took
    ("bias", "init")."""
    thresh = length - editdist
    nd = db.shape[0]
    tiles = -(-nd // COUNT_TILE)
    per_split = -(-tiles // n_splits) * COUNT_TILE
    out = np.zeros(q.shape[0], np.int32)
    paths = set()
    for b0 in range(0, q.shape[0], COUNT_BLOCK):
        block = q[b0:b0 + COUNT_BLOCK]
        nb = _block_bases(block)
        if nb == 0:
            continue
        k_bytes = 32 * -(-nb // 8)
        lane = k_bytes - 13
        bias_lane = nb % 8 != 0
        paths.add("bias" if bias_lane else "init")
        a = _wgmma_rows(block, k_bytes)
        if bias_lane:
            assert not a[:, lane].any()
            a[:, lane] = -(thresh + 1)
        for lo in range(0, nd, per_split):
            hi = min(nd, lo + per_split)
            for t0 in range(lo, hi, COUNT_TILE):
                tile = np.full((COUNT_TILE, db.shape[1]), dna.INVALID,
                               np.uint8)
                rows = min(COUNT_TILE, hi - t0)
                tile[:rows] = db[t0:t0 + rows]
                b = _wgmma_rows(tile, k_bytes)
                if bias_lane:
                    b[:COUNT_TILE if pad_bias else rows, lane] = 1
                for m0 in range(0, block.shape[0], COUNT_M_TILE):
                    am = a[m0:m0 + COUNT_M_TILE]
                    acc = am @ b.T
                    if not bias_lane:
                        acc -= thresh + 1
                    assert -128 <= acc.min() and acc.max() <= 127
                    out[b0 + m0:b0 + m0 + am.shape[0]] += (acc >= 0).sum(
                        1, dtype=np.int32)
    return out, paths


def test_wgmma_rows_are_one_hot():
    """The plane-and-multiply decode gives every valid base one 1, at the
    byte of its code in its chunk, and an N or a base past L nothing."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 5, size=(500, 32)).astype(np.uint8)
    codes[:100, 20:] = dna.INVALID
    rows = _wgmma_rows(codes, 128)
    want = np.zeros_like(rows)
    r, i = np.nonzero(codes < 4)
    want[r, 16 * (i // 4) + 4 * codes[r, i] + i % 4] = 1
    np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("length", COUNT_EDGE_LENGTHS)
def test_count_kernel_model_matches_plain(length):
    """The zero-padded one-hot layout, the block's k32 steps and the
    biased > thresh count that the tensor-core kernel relies on equal
    ``hamming_count_plain``, with N bases, duplicated rows, an all-N query
    and a block whose queries all end in N."""
    from guidemaker_tpu_torch.knn.hamming import hamming_count_plain
    rng = np.random.default_rng(100 + length)
    q, db = _codes(rng, 600, 300, length)
    q[256:512, max(1, length - 9):] = dna.INVALID
    for editdist in _edge_editdists(length):
        want = hamming_count_plain(pack_codes(torch.from_numpy(q)),
                                   pack_codes(torch.from_numpy(db)), length,
                                   editdist).numpy()
        np.testing.assert_array_equal(_count_model(q, db, length,
                                                   editdist)[0],
                                      want, err_msg=f"editdist {editdist}")
        if editdist == 0:
            assert not want.any()


def _count_model_paths(length):
    """The paths of the two blocks of test_count_model_matches_plain_and_jax:
    the first's last valid base is L - 1, the second's max(1, L - 9) - 1;
    a block takes the bias lane unless its bases fill its K."""
    return {"init" if nb % 8 == 0 else "bias"
            for nb in (length, max(1, length - 9))}


@pytest.mark.parametrize("n_splits", [1, 3])
@pytest.mark.parametrize("length", COUNT_EDGE_LENGTHS)
def test_count_model_matches_plain_and_jax(length, n_splits):
    """The wgmma count's arithmetic (the bias lane where a base slot is
    spare, the initialised sums where none is: L 8, 24 and 32, and L 25's
    second block with 16 bases), its 256-query blocks and m64 tiles ragged
    (300 queries), a database ragged against its 128-row tiles and splits
    (333 rows) whose padding rows carry the bias lane, N bases, duplicated
    rows and an all-N query, against ``hamming_count_plain`` and the JAX
    package's streaming count, at every editdist edge."""
    from guidemaker_tpu_torch.knn.hamming import hamming_count_plain
    rng = np.random.default_rng(300 + length)
    q, db = _codes(rng, 300, 333, length)
    q[256:, max(1, length - 9):] = dna.INVALID
    qt, dbt = (pack_codes(torch.from_numpy(x)) for x in (q, db))
    for editdist in _edge_editdists(length):
        want = hamming_count_plain(qt, dbt, length, editdist).numpy()
        got, paths = _count_model(q, db, length, editdist, n_splits)
        np.testing.assert_array_equal(got, want, err_msg=f"e {editdist}")
        assert paths == _count_model_paths(length)
        ref = stream_count_device(q, prepare_db_codes(db, 128), 333,
                                  editdist, length, db_tile=128, q_tile=32)
        np.testing.assert_array_equal(want, ref, err_msg=f"e {editdist}")
        if editdist == 0:
            assert not want.any()


def test_count_model_padding_rows_need_the_bias_lane():
    """A padding row past the split without the bias lane's 1 sums to 0
    with every query and so would count for each: the kernel's padding
    rows carry the lane (130 rows: the second tile has 126 of them)."""
    rng = np.random.default_rng(11)
    q, db = _codes(rng, 70, 130, 20)
    good, paths = _count_model(q, db, 20, 2)
    bad, _ = _count_model(q, db, 20, 2, pad_bias=False)
    assert paths == {"bias"}
    np.testing.assert_array_equal(bad - good, np.full(70, 126))


#: k at the top-k kernel's list edges: kcap 1, 2, 4, 8, 32 and 128
TOPK_EDGE_KS = [1, 2, 3, 5, 20, 128]


#: the wgmma top-k's sub-lists (in registers or shared memory) serve kcap
#: up to this; larger kcaps keep one list a row in shared memory
TOPK_QUAD_KCAP = 32


def _lane_of_column(cols):
    """The lane t of a quad whose accumulators hold a tile column: lane
    4g + t holds columns 8j + 2t + c."""
    return (cols >> 1) & 3


def _quad_gate(dist, kcap):
    """The gate of each row from its quad's four sub-lists, given their
    distances (rows, 4, kcap) capped at L + 1: the least of one sub-list's
    K-th distance, the second least K/2-th (two sub-lists with K/2 keys
    each) and the largest K/4-th (four with K/4 each); each leaves K keys
    of earlier tiles at a distance <= the gate."""
    gate = dist[:, :, kcap - 1].min(1)
    if kcap >= 2:
        gate = np.minimum(gate, np.sort(dist[:, :, kcap // 2 - 1], 1)[:, 1])
    if kcap >= 4:
        gate = np.minimum(gate, dist[:, :, kcap // 4 - 1].max(1))
    return gate


def _topk_model(q, db, length, k, n_splits, drop_padding=True, trace=None):
    """csrc/hamming_topk.cu's arithmetic in numpy: per block of 256 queries
    with nb bases (at least 1: an all-N block runs the 1-step product of
    zeros), the one-hot rows of the wgmma count (:func:`_wgmma_rows`, K =
    32 KS bytes); database splits of whole 128-row tiles, the rows past a
    split's end padding rows; per m64 tile of queries and database tile an
    int32 product whose sums start at each row's bias b = dK - L - 1, carried
    in the bias lane (K byte 32 KS - 13: b in the query row, 1 in every
    database row, padding rows included) or, when the bases fill K, added to
    the sums; the pairs with a sum >= 0 on a column below the split's end
    (unless ``drop_padding`` is false) as keys ((L + b - sum) << 24) | col.
    For kcap <= 32 each lane t of a quad keeps each row's sub-list of kcap
    keys over its columns 8j + 2t + c, dK is :func:`_quad_gate`, and the
    quad merges its four sub-lists at the end of the split; for larger
    kcaps each row keeps one list and dK is its K-th distance.  Then the
    merge of the splits' lists.  ``trace`` (a dict), if given, collects
    "paths" (the set of "bias" and "init" blocks), "padding" (padding
    columns whose sum passed) and "gates" (for each tile of the first
    block's first split, the kcap-th distance of each sub-list of query 0
    and its gate) and "lists" (the splits' lists, (nq, n_splits, kcap)).
    Returns (nq, min(k, nd, 128)) int64 keys."""
    nq, nd = q.shape[0], db.shape[0]
    k_eff = min(k, nd, MAX_K)
    kcap = 1 << (k_eff - 1).bit_length()
    quad = kcap <= TOPK_QUAD_KCAP
    tiles = -(-nd // COUNT_TILE)
    per_split = -(-tiles // n_splits) * COUNT_TILE
    lane_t = _lane_of_column(np.arange(COUNT_TILE))
    trace = {} if trace is None else trace
    trace.update(paths=set(), padding=0, gates=[])
    lists = np.full((nq, n_splits, kcap), INF_KEY, np.int64)
    for b0 in range(0, nq, COUNT_BLOCK):
        block = q[b0:b0 + COUNT_BLOCK]
        rows = block.shape[0]
        nb = max(1, _block_bases(block))
        k_bytes = 32 * -(-nb // 8)
        lane = k_bytes - 13
        bias_lane = nb % 8 != 0
        trace["paths"].add("bias" if bias_lane else "init")
        a = _wgmma_rows(block, k_bytes)
        if bias_lane:
            assert not a[:, lane].any()
        for split in range(n_splits):
            lo, hi = split * per_split, min(nd, (split + 1) * per_split)
            sub = np.full((rows, 4 if quad else 1, kcap), INF_KEY, np.int64)
            bias = np.zeros(rows, np.int64)
            for t0 in range(lo, hi, COUNT_TILE):
                tile = np.full((COUNT_TILE, db.shape[1]), dna.INVALID,
                               np.uint8)
                real = min(COUNT_TILE, hi - t0)
                tile[:real] = db[t0:t0 + real]
                b = _wgmma_rows(tile, k_bytes)
                if bias_lane:
                    b[:, lane] = 1
                    a[:, lane] = bias
                acc = np.concatenate([a[m0:m0 + COUNT_M_TILE] @ b.T
                                      for m0 in range(0, rows, COUNT_M_TILE)])
                if not bias_lane:
                    acc += bias[:, None]
                assert -128 <= acc.min() and acc.max() <= 127
                col = t0 + np.arange(COUNT_TILE)
                passed = acc >= 0
                if split == 0 and b0 == 0:
                    trace["padding"] += int(passed[:, real:].sum())
                if drop_padding:
                    passed &= col < hi
                keys = np.where(passed, ((length + bias[:, None] - acc)
                                         << 24) | col, INF_KEY)
                for t in range(sub.shape[1]):
                    own = keys[:, lane_t == t] if quad else keys
                    sub[:, t] = np.sort(np.concatenate([sub[:, t], own], 1),
                                        1)[:, :kcap]
                dist = np.minimum(sub >> 24, length + 1)
                gate = (_quad_gate(dist, kcap) if quad
                        else dist[:, 0, kcap - 1])
                bias = gate - length - 1
                if split == 0 and b0 == 0:
                    trace["gates"].append((dist[0, :, kcap - 1], gate[0]))
            lists[b0:b0 + rows, split] = np.sort(sub.reshape(rows, -1),
                                                 1)[:, :kcap]
    trace["lists"] = lists
    return np.sort(lists.reshape(nq, -1), 1)[:, :k_eff]


def _a_fragments(rows, steps):
    """The wgmma A fragments of an m64 tile of one-hot rows (64, 32 steps)
    as the count and top-k kernels load them: [warp w, lane 4g + t, step s,
    register r, byte] holds, in registers 0 and 1, rows 16w + g and 16w + g
    + 8 at K bytes 32s + 4t .. 32s + 4t + 3, in 2 and 3 the same rows at
    K bytes 32s + 16 + 4t .. 32s + 16 + 4t + 3."""
    frag = np.zeros((4, 32, steps, 4, 4), rows.dtype)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for s in range(steps):
                for r in range(4):
                    row = 16 * w + g + 8 * (r & 1)
                    k0 = 32 * s + 16 * (r >> 1) + 4 * t
                    frag[w, lane, s, r] = rows[row, k0:k0 + 4]
    return frag


def _keys_to_pairs(keys, k):
    """Keys -> (dist, idx) padded with -1 to k columns, as the JAX
    package returns them."""
    d, i = (t.numpy() for t in unpack_keys(torch.from_numpy(
        keys.astype(np.int32))))
    pad = np.full((keys.shape[0], k - keys.shape[1]), -1, np.int32)
    return np.concatenate([d, pad], 1), np.concatenate([i, pad], 1)


def _check_topk_model(q, db, length, ks):
    """The model at 1 to 3 splits, and the JAX streaming kernel, against
    ``hamming_topk_plain`` at each k of ``ks``."""
    from guidemaker_tpu_torch.knn.hamming import hamming_topk_plain
    nd = db.shape[0]
    qt, dbt = (pack_codes(torch.from_numpy(x)) for x in (q, db))
    for k in ks:
        want = hamming_topk_plain(qt, dbt, length, k).numpy()
        for n_splits in (1, 2, 3):
            np.testing.assert_array_equal(
                _topk_model(q, db, length, k, n_splits), want,
                err_msg=f"k {k}, {n_splits} splits")
        ref = stream_topk_device(q, prepare_db_codes(db, 128), nd, k, length,
                                 db_tile=128, q_tile=32)
        got = _keys_to_pairs(want, k)
        np.testing.assert_array_equal(got[0], ref[0], err_msg=f"k {k}")
        np.testing.assert_array_equal(got[1], ref[1], err_msg=f"k {k}")


@pytest.mark.parametrize("length", COUNT_EDGE_LENGTHS)
def test_topk_kernel_model_matches_plain_and_jax(length):
    """The tensor-core top-k's gated epilogue equals ``hamming_topk_plain``
    and the JAX streaming kernel exactly: k32 padding (L), every list edge
    (k), 1 to 3 splits, a database ragged against its 128-row tiles with N
    bases and duplicated rows, an all-N query, an all-N 256-query block and
    a block whose queries end in N."""
    rng = np.random.default_rng(200 + length)
    q, db = _codes(rng, 600, 300, length)
    q[256:512] = dna.INVALID
    q[512:, max(1, length - 9):] = dna.INVALID
    _check_topk_model(q, db, length, TOPK_EDGE_KS)


@pytest.mark.parametrize("nd,k", [(1, 1), (3, 5), (100, 128), (129, 128)])
def test_topk_kernel_model_small_database(nd, k):
    """k above nd (the list keeps its sentinels and the wrapper pads with
    -1), a database of one tile or just over it, and splits left empty."""
    rng = np.random.default_rng(nd + k)
    q, db = _codes(rng, 70, nd, 20)
    _check_topk_model(q, db, 20, (k,))


def _variants(guide, positions):
    """Copies of a guide, each with one more base changed at ``positions``
    (copy i at distance i + 1)."""
    out = np.repeat(guide[None], len(positions), 0)
    for i, p in enumerate(positions):
        out[i:, p] ^= 1
    return out


@pytest.mark.parametrize("k", [1, 3, 5, 20])
def test_topk_kernel_model_ties_across_quad_and_tiles(k):
    """Equal-distance copies of a guide on every lane of a quad, on both
    columns of one lane, and in three tiles: the lists keep the lowest
    columns, as the plain top-k and the JAX kernel do."""
    rng = np.random.default_rng(40 + k)
    q, db = _codes(rng, 70, 400, 20)
    guide = db[4].copy()
    copies = [4, 5, 6, 8, 10, 130, 133, 260]     # distance 0
    near = [3, 129, 131, 263]                    # distance 1
    db[copies] = guide
    db[near] = guide
    db[near, 0] ^= 1
    q[0], q[1] = guide, db[3]
    assert set(_lane_of_column(np.array(copies[:5]))) == {0, 1, 2, 3}
    assert {c // 128 for c in copies} == {0, 1, 2}
    _check_topk_model(q, db, 20, (k,))
    got = _topk_model(q, db, 20, k, 1)
    d, i = (t.numpy() for t in unpack_keys(torch.from_numpy(
        got[:2].astype(np.int32))))
    order = sorted(copies) + sorted(near)
    np.testing.assert_array_equal(i[0, :12], order[:k])
    np.testing.assert_array_equal(d[0, :12], ([0] * 8 + [1] * 4)[:k])


@pytest.mark.parametrize("k", [4, 8])
def test_topk_kernel_model_uneven_sub_lists(k):
    """A query whose close neighbors all lie on one lane's columns of the
    first tile: that lane's sub-list fills with them while the other three
    hold far guides, and the gate, taken over the quad, is that one lane's
    K-th distance."""
    rng = np.random.default_rng(60 + k)
    q, db = _codes(rng, 70, 700, 20)
    db = np.minimum(db, 3)
    q[0] = rng.integers(0, 4, 20)
    cols = np.flatnonzero(_lane_of_column(np.arange(128)) == 1)[:k]
    db[cols] = _variants(q[0], range(k))
    trace = {}
    _topk_model(q, db, 20, k, 1, trace=trace)
    kth, gate = trace["gates"][0]
    assert gate == kth[1] == k
    assert (np.delete(kth, 1) > gate).all()
    _check_topk_model(q, db, 20, (k,))


@pytest.mark.parametrize("nd,k", [(3, 5), (6, 8), (20, 32), (100, 128)])
def test_topk_kernel_model_padding_columns_pass_a_zero_bias(nd, k):
    """While a row's lists are not full its bias is 0, and a padding
    column past the split (all zeros but the bias lane's 1) sums to 0 and
    passes the gate, in the sub-lists (kcap 4, 8, 32) and the row lists
    (kcap 128): only the index drops it, and without the drop the splits' lists
    hold keys of columns that are no guide."""
    rng = np.random.default_rng(nd)
    q, db = _codes(rng, 70, nd, 20)
    trace = {}
    _topk_model(q, db, 20, k, 1, trace=trace)
    assert trace["padding"] > 0
    kept = trace["lists"][trace["lists"] != INF_KEY]
    assert ((kept & 0xffffff) < nd).all()
    _topk_model(q, db, 20, k, 1, drop_padding=False, trace=trace)
    bad = trace["lists"][trace["lists"] != INF_KEY]
    assert ((bad & 0xffffff) >= nd).any()
    _check_topk_model(q, db, 20, (k,))


@pytest.mark.parametrize("length", [5, 13, 21, 29])
def test_topk_kernel_bias_byte_in_the_a_fragment(length):
    """The bias lane, K byte 32 KS - 13 of a query row, lies in the A
    fragments of lane t 0 of each quad, register 2 (row g) or 3 (row g + 8)
    of the last k32 step, byte 3, and nowhere else; on real rows that byte
    is 0 before the bias is written (the block's base 8 KS - 1 is
    invalid).  L 5, 13, 21, 29 give KS 1 to 4, each with a spare lane."""
    steps = -(-length // 8)
    rng = np.random.default_rng(length)
    q, db = _codes(rng, 70, 300, length)
    rows = _wgmma_rows(q[:64], 32 * steps)
    real = _a_fragments(rows, steps)
    assert not real[:, 0::4, steps - 1, 2:, 3].any()
    marks = np.zeros_like(rows)
    marks[:, 32 * steps - 13] = -1 - np.arange(64)
    frag = _a_fragments(marks, steps)
    w, lane, s, r, byte = np.nonzero(frag)
    assert len(w) == 64
    assert (lane % 4 == 0).all() and (s == steps - 1).all()
    assert (byte == 3).all() and set(r) == {2, 3}
    row = 16 * w + lane // 4 + 8 * (r - 2)
    np.testing.assert_array_equal(frag[w, lane, s, r, byte], -1 - row)
    _check_topk_model(q, db, length, (1, 5))


def test_pack_codes_full_width_and_n_rule():
    """32 bases use all 64 bits of the code word; N matches nothing, not
    even another N."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, size=(1, 32)).astype(np.uint8)
    b = a.copy()
    b[0, 31] = 3 - b[0, 31]            # differs in the top two bits only
    n = a.copy()
    n[0, :2] = dna.INVALID
    q = pack_codes(torch.from_numpy(np.concatenate([a, n])))
    db = pack_codes(torch.from_numpy(np.concatenate([a, b, n])))
    d, i = unpack_keys(stream.hamming_topk(q, db, 32, 3))
    np.testing.assert_array_equal(d.numpy(), [[0, 1, 2], [2, 2, 3]])
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 2], [0, 2, 1]])
    with pytest.raises(ValueError):
        pack_codes(torch.zeros((1, 33), dtype=torch.uint8))


def test_unpack_keys_sentinel():
    keys = torch.tensor([[(3 << 24) | 7, INF_KEY]], dtype=torch.int32)
    d, i = unpack_keys(keys)
    assert d.tolist() == [[3, -1]] and i.tolist() == [[7, -1]]


def _seqs(rng, n, length=20, with_n=True):
    codes = rng.integers(0, 4, size=(n, length)).astype(np.uint8)
    if with_n:
        codes[::17, 3] = dna.INVALID
    return list(dict.fromkeys(dna.decode_rows(codes)))


@pytest.mark.parametrize("k", [1, 4, 9])
def test_index_query_matches_jax_index(k):
    rng = np.random.default_rng(5)
    seqs = _seqs(rng, 300)
    queries = seqs[:40] + _seqs(rng, 20)
    got = KnnIndex(seqs, device="cpu").query(queries, k)
    ref = JaxKnnIndex(seqs, backend="xla").query(queries, k)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def _filter_case(case, rng):
    codes = rng.integers(0, 4, size=(400, 20)).astype(np.uint8)
    codes[10] = codes[11]
    codes[12] = codes[13]
    codes[12, 0] ^= 1                       # a distance-1 pair fails
    seqs = list(dict.fromkeys(dna.decode_rows(codes)))
    if case == "member":
        return seqs, seqs
    if case == "nonmember":
        qc = dna.encode(seqs[0]).copy()
        qc[0] ^= 1                          # one db neighbor at distance 1
        return seqs, [dna.decode_rows(qc[None, :])[0], seqs[1]]
    if case == "duplicated":
        return seqs + [seqs[0]], seqs[:50]
    return _column_case(case, seqs)


def _column_case(case, seqs):
    """(database column, queries) of the pandas cases: the column itself,
    an equal fresh column, a subset, a reversed copy, a column of the
    database's length with one non-member, and an object column with one
    None."""
    col = pd.Series(seqs, dtype="str")
    if case == "db_column":
        return col, col
    if case == "fresh_column":
        return col, pd.Series(list(seqs), dtype="str")
    if case == "member_arrow":
        return col, col.iloc[::3]
    if case == "reversed":
        return col, pd.Series(seqs[::-1], dtype="str")
    if case == "one_nonmember":
        qc = dna.encode(seqs[5]).copy()
        qc[0] ^= 1
        guide = dna.decode_rows(qc[None, :])[0]
        assert guide not in seqs
        return col, pd.Series(seqs[:5] + [guide] + seqs[6:], dtype="str")
    assert case == "with_none"
    return col, pd.Series(seqs[:5] + [None] + seqs[6:], dtype=object)


#: case -> (counting shortcut taken, pyarrow is_in calls a call, all-vs-all)
FILTER_CASES = {
    "member": (True, 0, True), "member_arrow": (True, 1, False),
    "nonmember": (False, 0, False), "duplicated": (False, 0, False),
    "db_column": (True, 0, True), "fresh_column": (True, 0, True),
    "reversed": (True, 1, False), "one_nonmember": (False, 1, False),
    "with_none": (False, 1, False)}


@pytest.mark.parametrize("case,counting", [
    ("member", True), ("member_arrow", True), ("nonmember", False),
    ("duplicated", False), ("db_column", True), ("fresh_column", True),
    ("reversed", True), ("one_nonmember", False), ("with_none", False)])
def test_pass_distance_filter_matches_jax(case, counting, monkeypatch):
    db, queries = _filter_case(case, np.random.default_rng(9))
    calls = []
    real = stream.hamming_count

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(stream, "hamming_count", spy)
    for editdist in (0, 2, 3):
        if case == "with_none":
            # no mask: both packages refuse the null guide, as before
            # equality was tested first
            for idx in (KnnIndex(db, device="cpu"),
                        JaxKnnIndex(db, backend="xla")):
                with pytest.raises(ValueError, match="share one length"):
                    idx.pass_distance_filter(queries, editdist)
            continue
        got = KnnIndex(db, device="cpu").pass_distance_filter(queries,
                                                              editdist)
        ref = JaxKnnIndex(list(db), backend="xla").pass_distance_filter(
            list(queries), editdist)
        np.testing.assert_array_equal(got, ref)
    assert bool(calls) == counting
    if case == "duplicated":
        assert not got[0]       # the duplicated guide has a 0-distance twin


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_retention_tests_equality_before_membership(case, monkeypatch):
    """Queries equal to the database reach the all-vs-all count, on the
    resident rows, with no pyarrow ``is_in``; every other input calls it
    once a call, as it did before equality came first, and takes the same
    route."""
    import pyarrow.compute as pc
    counting, n_is_in, all_vs_all = FILTER_CASES[case]
    db, queries = _filter_case(case, np.random.default_rng(9))
    idx = KnnIndex(db, device="cpu")
    is_in, counts = [], []
    real_is_in, real_count = pc.is_in, stream.hamming_count
    monkeypatch.setattr(pc, "is_in",
                        lambda *a, **kw: is_in.append(1) or real_is_in(*a,
                                                                       **kw))
    monkeypatch.setattr(stream, "hamming_count",
                        lambda q, *a: counts.append(q) or real_count(q, *a))
    for call in range(2):
        try:
            idx.pass_distance_filter(queries, 2)
        except ValueError:
            assert case == "with_none"
        assert len(is_in) == n_is_in * (call + 1)
    assert bool(counts) == counting
    for q in counts:
        same = q.untyped_storage().data_ptr() == \
            idx._db.untyped_storage().data_ptr()
        assert same == all_vs_all


@pytest.mark.parametrize("chunk", [1 << 21, 64])
@pytest.mark.parametrize("with_n", [False, True])
def test_all_vs_all_count_on_resident_rows(chunk, with_n, monkeypatch):
    """The 2-bit all-vs-all count takes the resident rows as its queries,
    whole or in chunks, and counts exactly what the codes, copied and
    packed again, count."""
    import guidemaker_tpu_torch.knn.driver as port_driver
    _, db = _codes(np.random.default_rng(17), 2, 300, 20)
    if not with_n:
        db = np.minimum(db, 3)
    monkeypatch.setattr(port_driver, "_COUNT_CHUNK", chunk)
    idx = KnnIndex(dna.decode_rows(db), device="cpu")
    for editdist in (0, 1, 2, 3, 20):
        got = idx._count_all(editdist).numpy()
        np.testing.assert_array_equal(
            got, idx._count(idx._as_codes(idx._codes), editdist).numpy())
        assert got.shape == (300,)


def test_pass_distance_filter_singleton_db():
    idx = KnnIndex(["ACGTACGTACGTACGTACGT"], device="cpu")
    assert not idx.pass_distance_filter(["ACGTACGTACGTACGTACGT"], 2).any()


def test_jax_saved_index_loads_and_answers_identically(tmp_path):
    rng = np.random.default_rng(13)
    seqs = _seqs(rng, 200)
    jax_idx = JaxKnnIndex(seqs, backend="xla")
    path = str(tmp_path / "idx.npz")
    jax_idx.save(path)
    port = KnnIndex.load(path)              # "xla" -> the CPU
    assert port.device.type == "cpu" and port.seqs == seqs
    for got, ref in zip(port.query(seqs[:30], 5), jax_idx.query(seqs[:30], 5)):
        np.testing.assert_array_equal(got, ref)
    port.save(str(tmp_path / "port.npz"))
    again = KnnIndex.load(str(tmp_path / "port.npz"))
    assert again.device.type == "cpu" and again.seqs == seqs


def test_tpu_saved_index_maps_to_cuda(tmp_path):
    """An index saved by the TPU backend loads onto the card, and without
    a card that raises instead of quietly running on the CPU."""
    path = str(tmp_path / "idx.npz")
    JaxKnnIndex(_seqs(np.random.default_rng(1), 50), backend="pallas").save(
        path)
    if torch.cuda.is_available():
        assert KnnIndex.load(path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            KnnIndex.load(path)
    assert KnnIndex.load(path, device="cpu").device.type == "cpu"


def test_no_fallback_off_the_cpu(monkeypatch):
    """Only a CPU tensor takes the plain version: other devices raise, a
    missing card raises, and a missing nvcc raises."""
    seqs = _seqs(np.random.default_rng(2), 20)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            KnnIndex(seqs, device="cuda")
    meta = torch.empty((4, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        stream.hamming_count(meta, meta, 20, 2)
    with pytest.raises(ValueError, match="device"):
        stream.hamming_topk(meta, meta, 20, 2)
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


def test_wrapper_checks_and_caps():
    launched = (stream.count_launches.n, stream.topk_launches.n)
    q = pack_codes(torch.zeros((3, 20), dtype=torch.uint8))
    with pytest.raises(ValueError):
        stream.hamming_count(q, q, 20, 21)       # counting needs editdist <= L
    with pytest.raises(ValueError):
        stream.hamming_topk(q.to(torch.int32), q, 20, 2)
    with pytest.raises(ValueError):
        stream.hamming_topk(q, q, 20, 0)
    big = pack_codes(torch.from_numpy(
        np.random.default_rng(0).integers(0, 4, (300, 20)).astype(np.uint8)))
    assert stream.hamming_topk(q, big, 20, 500).shape == (3, MAX_K)
    assert stream.hamming_count(q, big, 20, 2).shape == (3,)
    # the plain versions launch nothing
    assert (stream.count_launches.n, stream.topk_launches.n) == launched


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [20, 27])
def test_kernels_match_plain_on_card(cuda_device, L):
    from guidemaker_tpu_torch.knn.hamming import (hamming_count_plain,
                                                  hamming_topk_plain)
    rng = np.random.default_rng(L)
    qn, dbn = _codes(rng, 1000, 20000, L)
    q = pack_codes(torch.from_numpy(qn).to(cuda_device))
    db = pack_codes(torch.from_numpy(dbn).to(cuda_device))
    for editdist in (0, 1, 2, 3, L):
        assert torch.equal(stream.hamming_count(q, db, L, editdist),
                           hamming_count_plain(q, db, L, editdist))
    for k in (1, 2, 5, 20, 128):
        assert torch.equal(stream.hamming_topk(q, db, L, k),
                           hamming_topk_plain(q, db, L, k))


@pytest.mark.cuda
@pytest.mark.parametrize("L", COUNT_EDGE_LENGTHS)
def test_count_kernel_edges_on_card(cuda_device, L):
    """The tensor-core count at its tiling's edges: k-padding (L), query
    blocks (nq 1, 15, 4095), a database ragged against its 128-row tiles
    (nd 200,003), a block whose queries end in N, every editdist edge."""
    from guidemaker_tpu_torch.knn.hamming import hamming_count_plain
    rng = np.random.default_rng(L)
    qn, dbn = _codes(rng, 4095, 200_003, L)
    qn[256:512, max(1, L - 9):] = dna.INVALID
    q = pack_codes(torch.from_numpy(qn).to(cuda_device))
    db = pack_codes(torch.from_numpy(dbn).to(cuda_device))
    for nq in (1, 15, 4095):
        for editdist in _edge_editdists(L):
            assert torch.equal(
                stream.hamming_count(q[:nq], db, L, editdist),
                hamming_count_plain(q[:nq], db, L, editdist)), (nq, editdist)


#: query counts at the wgmma count's edges: m64 tiles (63, 64, 65) and
#: 256-query blocks (255, 257)
WGMMA_EDGE_NQ = (1, 63, 64, 65, 255, 257, 4095)


@pytest.mark.cuda
@pytest.mark.parametrize("L", COUNT_EDGE_LENGTHS)
def test_count_kernel_wgmma_edges_on_card(cuda_device, L):
    """K1's wgmma design at its edges: m64 tiles and query blocks
    (WGMMA_EDGE_NQ), databases ragged against the 128-row tile (129 and
    200,003 rows), a block ending in N and an all-N block, the bias lane
    and the initialised path (L 8, 24, 32), every editdist edge."""
    from guidemaker_tpu_torch.knn.hamming import hamming_count_plain
    rng = np.random.default_rng(400 + L)
    qn, dbn = _codes(rng, max(WGMMA_EDGE_NQ), 200_003, L)
    qn[256:512, max(1, L - 9):] = dna.INVALID
    qn[512:768] = dna.INVALID
    q = pack_codes(torch.from_numpy(qn).to(cuda_device))
    db = pack_codes(torch.from_numpy(dbn).to(cuda_device))
    for nd in (129, 200_003):
        for nq in WGMMA_EDGE_NQ:
            for editdist in _edge_editdists(L):
                assert torch.equal(
                    stream.hamming_count(q[:nq], db[:nd], L, editdist),
                    hamming_count_plain(q[:nq], db[:nd], L, editdist)), (
                        nd, nq, editdist)


@pytest.mark.cuda
@pytest.mark.parametrize("L", COUNT_EDGE_LENGTHS)
def test_topk_kernel_edges_on_card(cuda_device, L):
    """The tensor-core top-k at its tiling's edges: k-padding (L), query
    blocks (nq 1, 15, 4095), a database ragged against its 128-row tiles
    (nd 200,003), an all-N block, a block whose queries end in N, every
    list edge (k)."""
    from guidemaker_tpu_torch.knn.hamming import hamming_topk_plain
    rng = np.random.default_rng(L)
    qn, dbn = _codes(rng, 4095, 200_003, L)
    qn[256:512, max(1, L - 9):] = dna.INVALID
    qn[512:768] = dna.INVALID
    q = pack_codes(torch.from_numpy(qn).to(cuda_device))
    db = pack_codes(torch.from_numpy(dbn).to(cuda_device))
    for nq in (1, 15, 4095):
        for k in TOPK_EDGE_KS:
            assert torch.equal(stream.hamming_topk(q[:nq], db, L, k),
                               hamming_topk_plain(q[:nq], db, L, k)), (nq, k)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [20, 21])
def test_packed_kernels_match_plain_on_card(cuda_device, L):
    """The packed-pair kernels against their plain versions, and against
    the 2-bit kernels, on N-free codes with an odd database."""
    from guidemaker_tpu_torch.knn import packed as pk
    rng = np.random.default_rng(L)
    qn, dbn = _codes(rng, 1000, 20001, L)
    qn[qn == dna.INVALID] = 0
    dbn[dbn == dna.INVALID] = 0
    qc, dbc = (torch.from_numpy(a).to(cuda_device) for a in (qn, dbn))
    q, db = pk.query_rows(qc), pk.db_rows(dbc)
    q2, db2 = pack_codes(qc), pack_codes(dbc)
    for editdist in (0, 1, 2, 3, L):
        got = stream.packed_count(q, db, 20001, L, editdist)
        assert torch.equal(got, pk.packed_count_plain(q, db, 20001, L,
                                                      editdist))
        assert torch.equal(got, stream.hamming_count(q2, db2, L, editdist))
    for k in (1, 2, 5, 20, 128):
        got = stream.packed_topk(q, db, 20001, L, k)
        assert torch.equal(got, pk.packed_topk_plain(q, db, 20001, L, k))
        assert torch.equal(got, stream.hamming_topk(q2, db2, L, k))
