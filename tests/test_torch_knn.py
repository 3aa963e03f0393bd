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


def _onehot_rows(codes, k_bytes):
    """(n, k_bytes) int32 one-hot rows: base i is the little-endian word
    ``valid << 8 * code`` at bytes 4i..4i+3; N and bases past k_bytes / 4
    are zeros."""
    rows = np.zeros((codes.shape[0], k_bytes), np.int32)
    for i in range(min(codes.shape[1], k_bytes // 4)):
        valid = codes[:, i] < 4
        rows[np.flatnonzero(valid), 4 * i + codes[valid, i]] = 1
    return rows


def _block_steps(block):
    """k32 steps of a block of queries: enough for its last valid base."""
    valid = np.flatnonzero((block < 4).any(0))
    return -(-(valid[-1] + 1) // 8) if valid.size else 0


def _db_tile(db, t0, hi, steps):
    """One-hot rows of the 128-row database tile at t0; rows at or past hi
    decode to zeros."""
    tile = np.full((128, db.shape[1]), dna.INVALID, np.uint8)
    part = db[t0:min(t0 + 128, hi)]
    tile[:part.shape[0]] = part
    return _onehot_rows(tile, 32 * steps)


def _count_model(q, db, length, editdist):
    """csrc/hamming_count.cu's arithmetic in numpy: per block of 256
    queries, one-hot rows of K = 32 * ceil(nb / 8) bytes (nb: the last valid
    base of any query of the block, plus 1; base i is the little-endian
    word ``valid << 8 * code`` at bytes 4i..4i+3), database tiles of 128
    rows zero-padded at the ragged edge, an int32 product started at
    -(thresh + 1), and a count of the sums >= 0."""
    thresh = length - editdist
    out = np.zeros(q.shape[0], np.int32)
    for b0 in range(0, q.shape[0], 256):
        block = q[b0:b0 + 256]
        steps = _block_steps(block)
        if steps == 0:
            continue
        a = _onehot_rows(block, 32 * steps)
        for t0 in range(0, db.shape[0], 128):
            acc = a @ _db_tile(db, t0, db.shape[0], steps).T - (thresh + 1)
            out[b0:b0 + 256] += (acc >= 0).sum(1, dtype=np.int32)
    return out


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
        np.testing.assert_array_equal(_count_model(q, db, length, editdist),
                                      want, err_msg=f"editdist {editdist}")
        if editdist == 0:
            assert not want.any()


#: k at the top-k kernel's list edges: kcap 1, 2, 4, 8, 32 and 128
TOPK_EDGE_KS = [1, 2, 3, 5, 20, 128]


def _topk_model(q, db, length, k, n_splits):
    """csrc/hamming_topk.cu's arithmetic in numpy: per block of 256 queries
    with its k32 steps (the 1-step product of zeros for an all-N block),
    database splits of whole 128-row tiles, tiles zero-padded at the ragged
    edge, batches of 32 columns whose sums start at each row's bias
    dK - L - 1 (dK: the distance of the row's K-th key, L + 1 while its
    list is not full) and are staged as bytes, a warp's gate (some sum of
    its 32 rows >= 0), each row's scan of its sums >= 0 on columns below
    the split's end into its sorted list of kcap keys, and the merge of
    the splits' lists.  Returns (nq, min(k, nd, 128)) int64 keys."""
    nq, nd = q.shape[0], db.shape[0]
    k_eff = min(k, nd, MAX_K)
    kcap = 1 << (k_eff - 1).bit_length()
    tiles = -(-nd // 128)
    per_split = -(-tiles // n_splits) * 128
    lists = np.full((nq, n_splits, kcap), INF_KEY, np.int64)
    for b0 in range(0, nq, 256):
        block = q[b0:b0 + 256]
        steps = max(1, _block_steps(block))
        a = _onehot_rows(block, 32 * steps)
        for split in range(n_splits):
            lo, hi = split * per_split, min(nd, (split + 1) * per_split)
            best = np.full((block.shape[0], kcap), INF_KEY, np.int64)
            for t0 in range(lo, hi, 128):
                b = _db_tile(db, t0, hi, steps)
                for n0 in range(0, min(128, hi - t0), 32):
                    bias = np.minimum(best[:, -1] >> 24, length + 1) \
                        - length - 1
                    acc = a @ b[n0:n0 + 32].T + bias[:, None]
                    assert -128 <= acc.min() and acc.max() <= 127
                    col = t0 + n0 + np.arange(32)
                    for w0 in range(0, block.shape[0], 32):
                        w = slice(w0, w0 + 32)
                        if not (acc[w] >= 0).any():
                            continue
                        keys = np.where(
                            (acc[w] >= 0) & (col < hi),
                            ((length + bias[w, None] - acc[w]) << 24) | col,
                            INF_KEY)
                        best[w] = np.sort(np.concatenate([best[w], keys], 1),
                                          1)[:, :kcap]
            lists[b0:b0 + 256, split] = best
    return np.sort(lists.reshape(nq, -1), 1)[:, :k_eff]


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
    if case == "member_arrow":
        col = pd.Series(seqs, dtype="str")
        return col, col.iloc[::3]
    if case == "nonmember":
        qc = dna.encode(seqs[0]).copy()
        qc[0] ^= 1                          # one db neighbor at distance 1
        return seqs, [dna.decode_rows(qc[None, :])[0], seqs[1]]
    return seqs + [seqs[0]], seqs[:50]      # duplicated database


@pytest.mark.parametrize("case,counting", [
    ("member", True), ("member_arrow", True), ("nonmember", False),
    ("duplicated", False)])
def test_pass_distance_filter_matches_jax(case, counting, monkeypatch):
    db, queries = _filter_case(case, np.random.default_rng(9))
    calls = []
    real = stream.hamming_count

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(stream, "hamming_count", spy)
    for editdist in (0, 2, 3):
        got = KnnIndex(db, device="cpu").pass_distance_filter(queries,
                                                              editdist)
        ref = JaxKnnIndex(list(db), backend="xla").pass_distance_filter(
            list(queries), editdist)
        np.testing.assert_array_equal(got, ref)
    assert bool(calls) == counting
    if case == "duplicated":
        assert not got[0]       # the duplicated guide has a 0-distance twin


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
