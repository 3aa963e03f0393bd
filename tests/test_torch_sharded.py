"""The port's sharded backend against its unsharded wrappers and the JAX
package's sharded tier.

The port's meshes are virtual: every shard on ``torch.device("cpu")``
(or on one card, in the ``cuda`` test), where each wrapper runs its
kernel's plain version.  The JAX calls use conftest's 8 virtual CPU
devices.  Inputs are made with numpy from a seed; every result is an
integer, so the tolerance is exact equality.
"""
import gzip
import logging
import os

import numpy as np
import pandas as pd
import pytest
import torch

from guidemaker_tpu import dna as jdna
from guidemaker_tpu.knn import sharded as jsh
from guidemaker_tpu.knn.driver import KnnIndex as JaxKnnIndex
from guidemaker_tpu.knn.hamming import hamming_topk as jax_hamming_topk
from guidemaker_tpu.knn.leven import banded_leven_pairs as jax_banded
from guidemaker_tpu.knn.leven import leven_pass_filter as jax_pass_filter
from guidemaker_tpu.knn.leven import leven_topk as jax_leven_topk
from guidemaker_tpu_torch import definitions, dna
from guidemaker_tpu_torch.knn import KnnIndex, driver, sharded, stream
from guidemaker_tpu_torch.knn.dp import banded_leven_pairs
from guidemaker_tpu_torch.knn.features import feature_topk, gram_rows
from guidemaker_tpu_torch.knn.hamming import host_lists, pack_codes
from guidemaker_tpu_torch.knn.leven import leven_pass_filter

CPU = torch.device("cpu")
GBK = os.path.join(os.path.dirname(__file__), "test_data",
                   "Carsonella_ruddii.gbk.gz")
SHAPES = [(1, 1), (1, 2), (1, 3), (2, 4), (1, 8), (8, 1)]


def _mesh(q, d, dev=CPU):
    return sharded.make_mesh(q, d, [dev] * (q * d))


def _codes(rng, n, length, with_n=False):
    codes = rng.integers(0, 4, size=(n, length)).astype(np.uint8)
    if with_n:
        codes[::7, rng.integers(0, length)] = dna.INVALID
    return codes


def _t(a):
    return torch.from_numpy(a)


def _unsharded_topk(q, db, k):
    keys = stream.hamming_topk(pack_codes(_t(q)), pack_codes(_t(db)),
                               q.shape[1], k)
    return host_lists(keys, k)


# (nq, nd, L, k, N codes): unaligned sizes, nd 3 (empty shards on 8,
# k > nd), k 128, codes with N
TOPK_CASES = {"unaligned": (37, 531, 17, 4, False),
              "nd3": (8, 3, 12, 6, False),
              "k128": (20, 300, 20, 128, False),
              "with_n": (40, 200, 20, 5, True)}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_topk_matches_unsharded_and_jax(shape, case):
    nq, nd, length, k, with_n = TOPK_CASES[case]
    rng = np.random.default_rng(nq * nd + length)
    db = _codes(rng, nd, length, with_n)
    members = db[:nq // 2]
    q = np.concatenate([members, _codes(rng, nq - len(members), length,
                                        with_n)])
    sdb = sharded.prepare_db_sharded(db, _mesh(*shape))
    got = sharded.fused_sharded_topk(q, sdb, k)
    want = _unsharded_topk(q, db, k)
    ref = jax_hamming_topk(jdna.one_hot_matrix(q), jdna.one_hot_matrix(db),
                           k, length)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == np.int32 and g.shape == (nq, k)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    if k > nd:
        assert (got[0][:, nd:] == -1).all() and (got[1][:, nd:] == -1).all()
    # a shard without rows holds nothing and launches nothing
    assert sum(bool(p) for p in sdb.shards) == min(shape[1], nd)


def test_layout_offsets_and_one_copy_per_device():
    db = _codes(np.random.default_rng(0), 10, 8)
    sdb = sharded.prepare_db_sharded(db, _mesh(2, 4))
    assert sdb.offsets == (0, 3, 6, 9) and sdb.nd == 10 and sdb.length == 8
    assert [len(p) for p in sdb.shards] == [1, 1, 1, 1]
    rows = torch.cat([p[CPU] for p in sdb.shards])
    assert torch.equal(rows, pack_codes(_t(db)))
    with pytest.raises(ValueError, match="need 9 devices"):
        sharded.make_mesh(3, 3, [CPU] * 8)
    mesh = sharded.make_mesh(2, 2, [CPU] * 4)
    assert mesh.axis_names == ("q", "d") and mesh.devices.shape == (2, 2)


def _count_codes():
    rng = np.random.default_rng(29)
    codes = _codes(rng, 500, 20)
    codes[3] = codes[4]
    codes[4, 0] ^= 1
    return codes, (codes[:, None, :] != codes[None, :, :]).sum(axis=2)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_count_matches_oracle(shape):
    codes, dist = _count_codes()
    sdb = sharded.prepare_db_sharded(codes, _mesh(*shape))
    for e in (0, 1, 2, 5):
        counts = sharded.fused_sharded_count(codes, sdb, e)
        assert counts.dtype == torch.int32
        np.testing.assert_array_equal(counts.numpy(), (dist < e).sum(axis=1))
    with pytest.raises(ValueError, match="editdist"):
        sharded.fused_sharded_count(codes, sdb, 21)


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=str)
def test_count_matches_jax_sharded(shape):
    import jax
    codes, dist = _count_codes()
    jmesh = jsh.make_mesh(*shape, devices=jax.devices()[:8])
    jdb = jsh.prepare_db_sharded(codes, jmesh, db_tile=128)
    sdb = sharded.prepare_db_sharded(codes, _mesh(*shape))
    for e in (1, 2):
        got = sharded.fused_sharded_count(codes, sdb, e).numpy()
        np.testing.assert_array_equal(got,
                                      jsh.fused_sharded_count(codes, jdb, e))
        np.testing.assert_array_equal(got, (dist < e).sum(axis=1))


def test_leven_topk_matches_jax_sharded():
    rng = np.random.default_rng(204)
    q, db = _codes(rng, 48, 20), _codes(rng, 700, 20)
    q[:8] = db[:8]
    got = sharded.sharded_leven_topk(q, db, 4, mesh=_mesh(2, 4))
    for ref in (jsh.sharded_leven_topk(q, db, 4, mesh=jsh.make_mesh(2, 4),
                                       db_tile=128),
                jax_leven_topk(q, db, 4, db_tile=128)):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_leven_topk_matches_unsharded(shape):
    rng = np.random.default_rng(17)
    q, db = _codes(rng, 19, 13, with_n=True), _codes(rng, 5, 13)
    got = sharded.sharded_leven_topk(q, db, 7, mesh=_mesh(*shape))
    want = host_lists(stream.leven_topk(pack_codes(_t(q)), pack_codes(_t(db)),
                                        13, 7), 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0][:, 5:] == -1).all() and (got[1][:, 5:] == -1).all()
    with pytest.raises(ValueError, match="k must be in 1..128"):
        sharded.sharded_leven_topk(q, db, 129, mesh=_mesh(*shape))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_feature_count_and_topk_match_unsharded(shape):
    rng = np.random.default_rng(9)
    db = _t(_codes(rng, 300, 20, with_n=True))
    q = torch.cat([db[:20], _t(_codes(rng, 20, 20))])
    qf, df = gram_rows(q, 0), gram_rows(db, 3)
    mesh = _mesh(*shape)
    got = sharded.sharded_feature_count(qf, df, 18, 8, mesh=mesh)
    assert torch.equal(got, stream.feature_count(qf, df, 18, 8))
    # pre-sharded rows, each shard's built from its own codes
    df_sh = sharded.shard_rows(db, mesh).map(lambda c: gram_rows(c, 3))
    assert torch.equal(sharded.sharded_feature_count(qf, df_sh, 18, 8,
                                                     mesh=mesh), got)
    for k in (1, 16, 400):
        keys = sharded.sharded_feature_topk(qf, df_sh, 18, k, mesh=mesh)
        assert torch.equal(keys, feature_topk(qf, df, 18, k))


def _clusters():
    """Near-duplicate clusters (tests/test_sharded.py): 1-3 substitutions
    and one-shift copies, so that the e 4 filter reaches every tier."""
    rng = np.random.default_rng(41)
    base = rng.integers(0, 4, size=(120, 20)).astype(np.uint8)
    muts = []
    for r in base[:40]:
        m = r.copy()
        for _ in range(int(rng.integers(1, 4))):
            m[rng.integers(0, 20)] = rng.integers(0, 4)
        muts.append(m)
    for r in base[40:60]:
        muts.append(np.concatenate([r[1:], rng.integers(0, 4, 1)
                                    .astype(np.uint8)]))
    return np.unique(np.concatenate([base, np.array(muts)]), axis=0)


@pytest.mark.parametrize("e,filter_k", [(2, 4), (3, 4), (4, 4), (4, 1)])
def test_leven_pass_filter_on_mesh(e, filter_k):
    """At e 4, lists of 4 candidates decide every query in tier 2; lists of
    1 leave 116 queries to tiers 3 and 4."""
    db = _clusters()
    dbt = _t(db)
    want = leven_pass_filter(dbt, dbt, e, filter_k=filter_k)
    for shape in ((2, 4), (1, 3)):
        got = leven_pass_filter(dbt, dbt, e, filter_k=filter_k,
                                mesh=_mesh(*shape))
        assert torch.equal(got, want), shape
    ref = jax_pass_filter(db, db, e, mesh=jsh.make_mesh(2, 4),
                          filter_k=filter_k)
    np.testing.assert_array_equal(want.numpy(), ref)
    assert want.any() and not want.all()


def test_leven_pass_filter_on_mesh_reaches_every_tier(monkeypatch):
    calls = {}
    for name in ("sharded_feature_count", "sharded_feature_topk",
                 "sharded_banded_pairs", "sharded_leven_topk"):
        real = getattr(sharded, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(sharded, name, spy)
    db = _t(_clusters())
    leven_pass_filter(db, db, 4, filter_k=1, mesh=_mesh(2, 4))
    assert calls["sharded_feature_count"] == 2
    assert calls["sharded_feature_topk"] >= 2
    assert calls["sharded_banded_pairs"] >= 2
    assert calls["sharded_leven_topk"] == 1


@pytest.mark.parametrize("shape", [(2, 4), (1, 3), (8, 1)], ids=str)
def test_banded_pairs_match(shape):
    rng = np.random.default_rng(7)
    a = _codes(rng, 53, 20)
    b = a.copy()
    for i in range(0, 53, 3):
        b[i, rng.integers(0, 20)] = rng.integers(0, 4)
    got = sharded.sharded_banded_pairs(a, b, t=3, mesh=_mesh(*shape))
    assert torch.equal(got, banded_leven_pairs(_t(a), _t(b), 3))
    import jax.numpy as jnp
    ref = np.asarray(jax_banded(jnp.asarray(a), jnp.asarray(b), t=3,
                                length=20))
    np.testing.assert_array_equal(got.numpy(), ref)


def _index_seqs(rng, n=300):
    codes = _codes(rng, n, 20)
    codes[1] = codes[0]
    codes[1, 5] ^= 1                  # a distance-1 pair
    codes[::23, 2] = dna.INVALID
    return list(dict.fromkeys(dna.decode_rows(codes)))


def _sharded_index(seqs, metric, shape=(2, 4), **kw):
    idx = KnnIndex(seqs, metric, backend="sharded", device="cpu", **kw)
    idx._mesh = _mesh(*shape)
    return idx


@pytest.mark.parametrize("metric", ["hamming", "leven"])
def test_index_matches_unsharded_and_jax(metric):
    rng = np.random.default_rng(31)
    seqs = _index_seqs(rng)
    idx = _sharded_index(seqs, metric)
    assert idx.backend == "sharded" and idx.device == CPU
    one = KnnIndex(seqs, metric, device="cpu")
    ref = JaxKnnIndex(seqs, metric, backend="xla")
    queries = seqs[:40] + dna.decode_rows(_codes(rng, 10, 20))
    for got, a, b in zip(idx.query(queries, 4), one.query(queries, 4),
                         ref.query(queries, 4)):
        np.testing.assert_array_equal(got, a)
        np.testing.assert_array_equal(got, b)
    for e in (2, 3):
        got = idx.pass_distance_filter(seqs, e)
        np.testing.assert_array_equal(got, one.pass_distance_filter(seqs, e))
        np.testing.assert_array_equal(got, ref.pass_distance_filter(seqs, e))
    cand = _codes(rng, 30, 20)
    cand[:5] = dna.encode_batch(seqs[:5], 20)
    for e in (0, 2, 5):
        got = idx.count_within(cand, e)
        np.testing.assert_array_equal(got, one.count_within(cand, e))
        np.testing.assert_array_equal(got, ref.count_within(cand, e))
        np.testing.assert_array_equal(idx.pass_mask_within(_t(cand), e),
                                      ref.pass_mask_within(cand, e))
    assert idx.count_within(cand, 21) is None
    assert not idx.supports_chunk_triage(7)
    assert idx.pass_mask_chunks([_t(cand)], 7) is None


def test_index_builds_its_sharded_db_once():
    seqs = _index_seqs(np.random.default_rng(33), 200)
    idx = _sharded_index(seqs, "hamming")
    idx.query(seqs[:10], 3)
    sdb = idx._sdb
    assert isinstance(sdb, sharded.ShardedDb) and sdb.mesh is idx._mesh
    idx.pass_distance_filter(seqs, 3)
    idx.count_within(dna.encode_batch(seqs[:4], 20), 2)
    assert idx._sdb is sdb and idx._sharded_db() is sdb


def test_index_sharded_defaults(monkeypatch):
    seqs = _index_seqs(np.random.default_rng(34), 50)
    # no mesh set: one shard on the CPU
    idx = KnnIndex(seqs, backend="sharded", device="cpu")
    assert idx._sharded_db().mesh.devices.shape == (1, 1)
    monkeypatch.setenv("GUIDEMAKER_TPU_KERNEL", "sharded")
    assert KnnIndex(seqs, device="cpu").backend == "sharded"
    assert KnnIndex(seqs, device="cpu", backend="xla").backend == "cpu"
    for other in ("pallas", "xla", "native"):
        monkeypatch.setenv("GUIDEMAKER_TPU_KERNEL", other)
        assert KnnIndex(seqs, device="cpu").backend == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            KnnIndex(seqs, backend="sharded")


def test_packed_is_off_on_the_sharded_backend(caplog):
    seqs = _index_seqs(np.random.default_rng(35), 80)
    seqs = [s.replace("N", "A") for s in seqs]
    with caplog.at_level(logging.INFO, logger=driver.__name__):
        idx = _sharded_index(seqs, "hamming", packed=True)
    assert not idx.packed
    assert sum("sharded backend keeps the 2-bit layout" in r.getMessage()
               for r in caplog.records) == 1
    ref = KnnIndex(seqs, device="cpu", packed=True)
    assert ref.packed
    for got, want in zip(idx.query(seqs[:20], 3), ref.query(seqs[:20], 3)):
        np.testing.assert_array_equal(got, want)


def test_save_and_load_across_packages(tmp_path):
    seqs = _index_seqs(np.random.default_rng(36), 120)
    jax_path = str(tmp_path / "jax.npz")
    JaxKnnIndex(seqs, backend="sharded").save(jax_path)
    port = KnnIndex.load(jax_path, device="cpu")
    assert port.backend == "sharded" and port.seqs == seqs
    one = KnnIndex(seqs, device="cpu")
    for got, want in zip(port.query(seqs[:10], 3), one.query(seqs[:10], 3)):
        np.testing.assert_array_equal(got, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            KnnIndex.load(jax_path)        # sharded on the card by default
    port_path = str(tmp_path / "port.npz")
    _sharded_index(seqs, "leven").save(port_path)
    back = JaxKnnIndex.load(port_path)
    assert back.backend == "sharded" and back.metric == "leven"
    assert back.seqs == seqs
    assert KnnIndex.load(port_path, device="cpu").backend == "sharded"


def test_pipeline_on_the_sharded_backend(tmp_path, monkeypatch):
    """GUIDEMAKER_TPU_KERNEL=sharded on the CPU: the table of the unsharded
    run byte for byte, controls with their invariants and reproducible by
    seed; the index's mesh, built lazily, is made (2, 4) here."""
    from guidemaker_tpu_torch.io import parse_genbank
    from guidemaker_tpu_torch.pipeline import PipelineConfig, run_pipeline
    base = dict(genbank=[GBK], pamseq="NGG", device="cpu", seed=5)
    run_pipeline(PipelineConfig(outdir=str(tmp_path / "one"), controls=0,
                                **base))
    monkeypatch.setenv("GUIDEMAKER_TPU_KERNEL", "sharded")
    import guidemaker_tpu_torch.distributed as port_distributed
    monkeypatch.setattr(port_distributed, "auto_mesh",
                        lambda devices: _mesh(2, 4, devices[0]))
    res = run_pipeline(PipelineConfig(outdir=str(tmp_path / "sh"),
                                      controls=20, **base))
    idx = res.processor.index
    assert idx.backend == "sharded" and idx._sdb.mesh.devices.shape == (2, 4)
    tables = []
    for d in ("one", "sh"):
        with gzip.open(tmp_path / d / "targets.csv.gz", "rb") as fh:
            tables.append(fh.read())
    assert tables[0] == tables[1] and tables[0].count(b"\n") > 500
    ctl = res.controls
    assert len(ctl) == 20 and (ctl["Hamming distance"] >= 7).all()
    nearest = KnnIndex(idx.seqs, device="cpu").query(
        list(ctl["Sequences"]), 1)[0][:, 0]
    assert (ctl["Hamming distance"] == nearest).all()
    again = res.processor.get_control_seqs(
        parse_genbank(GBK), definitions.CONFIG_PATH, length=20, n=20,
        seed=5)[2]
    pd.testing.assert_frame_equal(again, ctl)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python -m pytest -m cuda)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_four_shards_on_the_card_equal_the_unsharded_kernels(cuda_device):
    rng = np.random.default_rng(40)
    db = _codes(rng, 50_003, 20, with_n=True)
    q = np.concatenate([db[:2000], _codes(rng, 2000, 20)])
    mesh = _mesh(1, 4, cuda_device)
    sdb = sharded.prepare_db_sharded(db, mesh)
    qr, dr = pack_codes(_t(q).to(cuda_device)), pack_codes(
        _t(db).to(cuda_device))
    for k in (1, 5, 128):
        got = sharded.fused_sharded_topk(q, sdb, k)
        want = host_lists(stream.hamming_topk(qr, dr, 20, k), k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for e in (1, 2, 4):
        assert torch.equal(sharded.fused_sharded_count(q, sdb, e),
                           stream.hamming_count(qr, dr, 20, e))
    got = sharded.sharded_leven_topk(q[:512], sdb, 5, mesh=mesh)
    want = host_lists(stream.leven_topk(qr[:512], dr, 20, 5), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    qf = gram_rows(_t(q).to(cuda_device), 0)
    df_sh = sharded.shard_rows(_t(db), mesh).map(lambda c: gram_rows(c, 3))
    assert torch.equal(
        sharded.sharded_feature_count(qf, df_sh, 18, 8, mesh=mesh),
        stream.feature_count(qf, gram_rows(_t(db).to(cuda_device), 3), 18, 8))
