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
