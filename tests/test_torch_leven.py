"""The port's Levenshtein path against the JAX package's.

The same codes, made with numpy from a seed, go through the JAX package on
the CPU (its Pallas count kernel in interpret mode, its Myers and DP
engines in XLA) and through the port, whose wrappers run the plain PyTorch
versions on a CPU tensor.  Every result is an integer or a boolean, so the
tolerance is exact equality.  The kernels need the card: the ``cuda``
tests hold them against the plain versions there, and a numpy model of the
3-gram count kernel's 1-bit warpgroup products
(tests/test_torch_feature_wgmma.py) is held against both packages here.
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
from test_torch_feature_wgmma import _wgmma_feature_count
from test_torch_knn import _column_case


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
#: step is 4 words): 1 and 4 words in one step, 5 in two, 18 in 5 (A in
#: registers), 25 and 30 in 7 and 8 (A in shared memory), with padding
#: but at 4 and 30
FEATURE_EDGE_WORDS = [1, 4, 5, 18, 25, 30]


@pytest.mark.parametrize("glen", FEATURE_EDGE_WORDS)
@pytest.mark.parametrize("direction", [1, 2])
def test_feature_count_kernel_model_matches_plain_and_jax(glen, direction):
    """The wgmma kernel's copies into its core-matrix stages, A fragments
    (in registers up to 5 k256 steps, in shared memory above), biased
    sums, sign gate and quad sums, modelled in numpy
    (tests/test_torch_feature_wgmma.py), equal the plain count and the JAX
    Pallas count kernel (interpret mode) on the same 3-gram rows, with N
    bases, a warp of all-N queries, a partly empty query block and a
    database ragged against its tiles, whole or cut into 3 splits, at the
    threshold edges."""
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
    for thresh in sorted({x for x in (0, glen - 3 * t - 1, glen - 1, glen)
                          if x >= 0}):
        want = feature_count_plain(q_rows, db_rows, thresh).numpy()
        for n_splits in (1, 3):
            got = _wgmma_feature_count(q_rows.numpy(), db_rows.numpy(),
                                       thresh, n_splits)
            np.testing.assert_array_equal(
                got, want, err_msg=f"thresh {thresh}, {n_splits} splits")
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
    ("nonmember", False), ("duplicated", False), ("fresh_column", True),
    ("reversed", True), ("one_nonmember", False), ("with_none", False)])
def test_index_retention_matches_jax(case, counting, monkeypatch):
    """The counting tiers where their preconditions hold, the k=2 query
    where they do not, at e 0 and 2 to 5; the pandas cases of
    ``test_torch_knn`` on a Levenshtein index ("member_arrow" is the
    database's own column there)."""
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
    elif case != "member":
        db, queries = _column_case(case, seqs)
    calls = []
    monkeypatch.setattr(leven, "leven_pass_filter",
                        lambda *a, _r=leven.leven_pass_filter:
                        calls.append(1) or _r(*a))
    import guidemaker_tpu_torch.knn.driver as port_driver
    monkeypatch.setattr(port_driver, "leven_pass_filter",
                        leven.leven_pass_filter)
    for e in (0, 2, 3, 4, 5):
        port = KnnIndex(db, metric="leven", device="cpu")
        if case == "with_none":
            jax_idx = JaxKnnIndex(db, metric="leven", backend="xla")
            for idx in (port, jax_idx):
                with pytest.raises(ValueError, match="share one length"):
                    idx.pass_distance_filter(queries, e)
            continue
        got = port.pass_distance_filter(queries, e)
        ref = JaxKnnIndex(list(db), metric="leven",
                          backend="xla").pass_distance_filter(list(queries), e)
        np.testing.assert_array_equal(got, ref)
    assert bool(calls) == counting


@pytest.mark.parametrize("case,n_is_in", [
    ("member_arrow", 0), ("fresh_column", 0), ("reversed", 1),
    ("one_nonmember", 1)])
def test_index_retention_equality_before_membership(case, n_is_in,
                                                    monkeypatch):
    """On a Levenshtein index too, a column equal to the database goes to
    the all-vs-all tiers with no pyarrow ``is_in``; another calls it once
    a call, as before."""
    import pyarrow.compute as pc
    seqs = _seqs(np.random.default_rng(9), 250, 16)
    db, queries = _column_case("db_column" if case == "member_arrow"
                               else case, seqs)
    idx = KnnIndex(db, metric="leven", device="cpu")
    is_in, firsts = [], []
    real_is_in, real_filter = pc.is_in, leven.leven_pass_filter
    monkeypatch.setattr(pc, "is_in",
                        lambda *a, **kw: is_in.append(1) or real_is_in(*a,
                                                                       **kw))
    import guidemaker_tpu_torch.knn.driver as port_driver
    monkeypatch.setattr(port_driver, "leven_pass_filter",
                        lambda q, db, e, **kw: firsts.append(q is db)
                        or real_filter(q, db, e, **kw))
    for call in range(2):
        idx.pass_distance_filter(queries, 3)
        assert len(is_in) == n_is_in * (call + 1)
    # all-vs-all: the database's codes are the queries, not re-encoded
    assert firsts == ([n_is_in == 0] * 2 if case != "one_nonmember" else [])


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
    """The kernel at its k256 step edges: query sets of 1, 15 and 1000
    rows (an all-N block among them) and at its m64 tiles (63, 64, 65) and
    256-query blocks (255, 257), a database ragged against its 128-row
    tiles, t 3 and 4 in both directions, the threshold edges."""
    rng = np.random.default_rng(glen)
    qn, dbn = _codes(rng, 1000, 20003, glen + 2)
    qn[256:512] = dna.INVALID
    q, db = (torch.from_numpy(a).to(cuda_device) for a in (qn, dbn))
    for t in (3, 4):
        for qr, dr in ((gram_rows(q, 0), gram_rows(db, t)),
                       (gram_rows(q, t), gram_rows(db, 0))):
            for nq in (1, 15, 63, 64, 65, 255, 257, 1000):
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
