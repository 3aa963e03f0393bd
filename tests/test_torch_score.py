"""The port's scoring (Doench 2016, CFD, Tm, the ONNX tree reader and the
drop-in shims) against the JAX package's, on the same inputs: every
comparison is exact (``==`` on float32, ``array_equal``,
``DataFrame.equals``); no tolerance is used."""
import os
import struct
from types import ModuleType

import numpy as np
import pandas as pd
import pytest

import guidemaker_tpu.core as jax_core
import guidemaker_tpu.doench_featurization as jax_shim_feat
from guidemaker_tpu.score import cfd as jax_cfd
from guidemaker_tpu.score import doench as jax_doench
from guidemaker_tpu.score import doench_features as jax_feat
from guidemaker_tpu.score import onnx_tree as jax_onnx
from guidemaker_tpu.score import tm as jax_tm
import guidemaker_tpu_torch.core as port_core
import guidemaker_tpu_torch.doench_featurization as port_shim_feat
from guidemaker_tpu_torch import dna
from guidemaker_tpu_torch.pipeline import PipelineConfig, run_pipeline
from guidemaker_tpu_torch.score import cfd as port_cfd
from guidemaker_tpu_torch.score import doench as port_doench
from guidemaker_tpu_torch.score import doench_features as port_feat
from guidemaker_tpu_torch.score import onnx_tree as port_onnx
from guidemaker_tpu_torch.score import tm as port_tm

HERE = os.path.dirname(__file__)
GBK = os.path.join(HERE, "test_data", "Carsonella_ruddii.gbk.gz")
GOLDEN_SEQS = np.array(["GTACAAAGCACGTTATTAGATGGTGGGAAC",
                        "TCTAATCACGACAGCATCACTATTAGGCCG",
                        "TGAAATGTCTCTTATCTCTGTGTAAGGCTC"])
GOLDEN_SCORES = np.array([[0.59383124], [0.28157765], [0.5276569]],
                         dtype="float32")
ENSEMBLE_FIELDS = ("feature", "threshold", "children", "is_leaf", "value")


def _ngg_codes(n, seed):
    """n random 30-mer code rows with GG at [25:27] (an NGG PAM)."""
    codes = np.random.default_rng(seed).integers(0, 4, size=(n, 30))
    codes = codes.astype(np.uint8)
    codes[:, 25:27] = dna.G
    return codes


def _assert_ensembles_equal(a, b):
    for f in ENSEMBLE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.base_value == b.base_value and a.max_depth == b.max_depth


@pytest.fixture(scope="module")
def cruddii_table():
    """The C. ruddii NGG/3prime design table (knum 5) from the port, on
    the CPU, before scoring."""
    res = run_pipeline(PipelineConfig(genbank=[GBK], pamseq="NGG",
                                      controls=0, device="cpu"),
                       write_outputs=False)
    return res.targets


def test_golden_floats_through_both():
    """The reference's onnxruntime goldens, float32-exact, in both."""
    port = port_doench.predict(GOLDEN_SEQS)
    assert port.dtype == np.float32 and (port == GOLDEN_SCORES).all()
    assert (port == jax_doench.predict(GOLDEN_SEQS)).all()


def test_predict_codes_random_ngg():
    codes = _ngg_codes(4096, 11)
    port = port_doench.predict_codes(codes)
    jax = jax_doench.predict_codes(codes)
    assert port.shape == (4096, 1) and port.dtype == np.float32
    assert np.array_equal(port, jax)


def test_featurize_codes_matches_jax():
    codes = _ngg_codes(512, 12)
    port = port_feat.featurize_codes(codes)
    jax = jax_feat.featurize_codes(codes)
    assert port.dtype == np.float32 and port.flags.f_contiguous
    assert np.array_equal(port, jax)
    assert np.array_equal(port_feat.INT_FEATURE_MASK,
                          jax_feat.INT_FEATURE_MASK)
    strs = dna.decode_rows(codes[:16])
    assert np.array_equal(port_feat.featurize(strs), jax_feat.featurize(strs))


@pytest.mark.parametrize("length", [5, 8, 30])
def test_tm_matches_jax(length):
    codes = np.random.default_rng(length).integers(
        0, 4, size=(300, length)).astype(np.uint8)
    port = port_tm.tm_rna_nn2(codes)
    assert port.dtype == np.float64
    assert np.array_equal(port, jax_tm.tm_rna_nn2(codes))
    if length == 30:
        assert np.array_equal(port_tm.tm_features(codes),
                              jax_tm.tm_features(codes))


@pytest.mark.parametrize("length", [17, 20, 23])
def test_cfd_pairs_match_jax(length):
    """calc_cfd and cfd_batch on mutated pairs, below, at and above the
    20-base window."""
    rng = np.random.default_rng(100 + length)
    wt = rng.integers(0, 4, size=(200, length)).astype(np.uint8)
    off = wt.copy()
    mut = rng.random(wt.shape) < 0.2
    off[mut] = rng.integers(0, 4, size=int(mut.sum())).astype(np.uint8)
    batch = port_cfd.cfd_batch(wt, off)
    assert np.array_equal(batch, jax_cfd.cfd_batch(wt, off))
    assert np.array_equal(port_cfd.weight_tensor(length),
                          jax_cfd.weight_tensor(length))
    wts, offs = dna.decode_rows(wt), dna.decode_rows(off)
    scalar = [port_cfd.calc_cfd(a, b) for a, b in zip(wts, offs)]
    assert scalar == [jax_cfd.calc_cfd(a, b) for a, b in zip(wts, offs)]
    assert np.array_equal(batch, np.array(scalar))


def test_cfd_score_on_design_table(cruddii_table):
    port = port_cfd.cfd_score(cruddii_table.copy())
    jax = jax_cfd.cfd_score(cruddii_table.copy())
    assert port.equals(jax)
    assert len(port) > 500
    assert (port["Max CFD"] < 1.0).any() and (port["Max CFD"] <= 1.0).all()


def test_cfd_score_ragged_fallback(monkeypatch):
    """Entries of another length than the guide take the per-string path."""
    df = pd.DataFrame({
        "Guide sequence": ["ACGTACGTACGTACGTACGT", "TTTTACGTACGTACGTAAAA",
                           "GGGGCCCCAAAATTTTACGT"],
        "Similar guides": [
            "ACGTACGTACGTACGTACGT;ACGTACGTACGTACGTACG;"
            "ACGTACGTACGTACGTACGTA",
            "TTTTACGTACGTACGTAAAA;TTTTACGTACGTACGTAAAC",
            "GGGGCCCCAAAATTTTACGT"]})
    calls = []
    real = dna.encode_batch
    monkeypatch.setattr(dna, "encode_batch",
                        lambda seqs, n: calls.append(n) or real(seqs, n))
    port = port_cfd.cfd_score(df.copy())
    assert len(calls) == 2, "the Arrow fast path was taken"
    assert port.equals(jax_cfd.cfd_score(df.copy()))
    # the last row lists only the guide: Max CFD falls back to it
    assert port["Max CFD"].iloc[2] == 1.0


def test_cfd_score_empty_frame():
    df = pd.DataFrame({"Guide sequence": pd.Series([], dtype=str),
                       "Similar guides": pd.Series([], dtype=str)})
    assert port_cfd.cfd_score(df.copy()).equals(jax_cfd.cfd_score(df.copy()))


def _with_n(table, every=7):
    out = table.copy()
    rows = out.index[::every]
    out.loc[rows, "target_seq30"] = [
        s[:3] + "N" + s[4:] for s in out.loc[rows, "target_seq30"]]
    return out


@pytest.mark.parametrize("case", ["scored", "n_rows", "5prime", "pam_subset"])
def test_get_doench_efficiency_score_matches_jax(cruddii_table, case):
    table, orientation = cruddii_table, "3prime"
    if case == "n_rows":
        table = _with_n(cruddii_table)
    elif case == "5prime":
        orientation = "5prime"
    elif case == "pam_subset":
        table = table[table["PAM"].isin(["AGG", "CGG"])]
    port = port_doench.get_doench_efficiency_score(table.copy(), orientation)
    jax = jax_doench.get_doench_efficiency_score(table.copy(), orientation)
    assert port.equals(jax)
    assert "target_seq30" not in port.columns
    eff = port["Efficiency"]
    if case in ("scored", "n_rows"):
        assert eff.dtype == np.float32 and np.isfinite(eff).all()
    else:
        assert (eff == "Not Available").all()
    if case == "n_rows":
        assert len(port) == len(table) - len(table.index[::7])


def test_load_ensemble_field_by_field():
    port, jax = port_doench.load_ensemble(), jax_doench.load_ensemble()
    assert os.path.samefile(port_doench.MODEL, jax_doench.MODEL)
    _assert_ensembles_equal(port, jax)


def test_save_npz_round_trip(tmp_path):
    path = str(tmp_path / "trees.npz")
    port_doench.load_ensemble().save_npz(path)
    _assert_ensembles_equal(jax_onnx.TreeEnsemble.load_npz(path),
                            port_onnx.TreeEnsemble.load_npz(path))
    _assert_ensembles_equal(port_onnx.TreeEnsemble.load_npz(path),
                            jax_doench.load_ensemble())


@pytest.mark.parametrize("block", [b[0] for b in port_shim_feat._BLOCKS])
def test_featurize_data_blocks_match_jax(block):
    data = pd.DataFrame({"30mer": list(GOLDEN_SEQS)
                         + dna.decode_rows(_ngg_codes(8, 13))})
    port = port_shim_feat.featurize_data(data, {})
    assert list(port) == [b[0] for b in jax_shim_feat._BLOCKS]
    assert port[block].equals(jax_shim_feat.featurize_data(data, {})[block])
    assert port_shim_feat.parallel_featurize_data(data)[block].equals(
        port[block])


def test_shims_export_the_jax_names():
    import guidemaker_tpu.cfd_score_calculator as jax_calc
    import guidemaker_tpu.doench_predict as jax_pred
    import guidemaker_tpu_torch.cfd_score_calculator as port_calc
    import guidemaker_tpu_torch.doench_predict as port_pred
    for jax_mod, port_mod in ((jax_core, port_core), (jax_calc, port_calc),
                              (jax_pred, port_pred),
                              (jax_shim_feat, port_shim_feat)):
        names = {n for n, v in vars(jax_mod).items()
                 if not n.startswith("_") and not isinstance(v, ModuleType)}
        assert names <= set(vars(port_mod)), names - set(vars(port_mod))
    assert port_pred.predict is port_doench.predict
    assert port_core.cfd_score is port_cfd.cfd_score


@pytest.mark.parametrize("bad", ["list", "pam"])
def test_predict_validations_match_jax(bad):
    seqs = (list(GOLDEN_SEQS[:1]) if bad == "list"
            else np.array(["A" * 30]))
    with pytest.raises(Exception) as port_err:
        port_doench.predict(seqs)
    with pytest.raises(Exception) as jax_err:
        jax_doench.predict(seqs)
    assert type(port_err.value) is type(jax_err.value)
    assert str(port_err.value) == str(jax_err.value)


def test_empty_batch():
    port = port_doench.ensemble_predict(port_doench.load_ensemble(),
                                        np.zeros((0, port_feat.N_FEATURES)))
    jax = jax_doench.ensemble_predict(jax_doench.load_ensemble(),
                                      np.zeros((0, jax_feat.N_FEATURES)))
    assert port.shape == jax.shape == (0, 1)
    assert port.dtype == jax.dtype == np.float32


def test_wide_tree_no_int8_wrap():
    """A 201-node left-spine tree: a leaf id above 127 must not wrap."""
    n_nodes = 201
    feature = np.zeros((1, n_nodes), dtype=np.int32)
    threshold = np.full((1, n_nodes), -1.0, dtype=np.float32)
    children = np.zeros((1, n_nodes, 2), dtype=np.int32)
    is_leaf = np.zeros((1, n_nodes), dtype=bool)
    value = np.zeros((1, n_nodes), dtype=np.float32)
    for i in range(0, n_nodes - 1, 2):
        children[0, i] = (i + 1, i + 2)  # x > -1 -> right child i+2
        is_leaf[0, i + 1] = True
        value[0, i + 1] = -99.0
    is_leaf[0, n_nodes - 1] = True
    value[0, n_nodes - 1] = 7.5
    arrays = dict(feature=feature, threshold=threshold, children=children,
                  is_leaf=is_leaf, value=value, base_value=1.0,
                  max_depth=(n_nodes - 1) // 2 + 1)
    x = np.zeros((3, 1), np.float32)
    port = port_doench.ensemble_predict(port_onnx.TreeEnsemble(**arrays), x)
    jax = jax_doench.ensemble_predict(jax_onnx.TreeEnsemble(**arrays), x)
    assert np.array_equal(port, jax)
    assert (port.ravel() == np.float32(8.5)).all()


# --- the .onnx route: a TreeEnsembleRegressor written as protobuf bytes ---


def _varint(v):
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | 0x80 if v else b)
        if not v:
            return bytes(out)


def _field(num, wire, payload):
    """One protobuf field: ``payload`` is an int for wire type 0, bytes
    (length-delimited for 2, raw for 1 and 5) otherwise."""
    tag = _varint(num << 3 | wire)
    if wire == 0:
        return tag + _varint(payload)
    if wire == 2:
        return tag + _varint(len(payload)) + payload
    return tag + payload


def _attribute(name, value, packed=True):
    """AttributeProto: floats (7), ints (8), strings (9), or a scalar f (2),
    i (3) or s (4); field 20 (type) is there for the parser to skip."""
    out = _field(1, 2, name.encode())
    if isinstance(value, list) and isinstance(value[0], float):
        out += (_field(7, 2, struct.pack(f"<{len(value)}f", *value)) if packed
                else b"".join(_field(7, 5, struct.pack("<f", v))
                              for v in value))
    elif isinstance(value, list) and isinstance(value[0], int):
        out += (_field(8, 2, b"".join(_varint(v) for v in value)) if packed
                else b"".join(_field(8, 0, v) for v in value))
    elif isinstance(value, list):
        out += b"".join(_field(9, 2, s.encode()) for s in value)
    elif isinstance(value, float):
        out += _field(2, 5, struct.pack("<f", value))
    elif isinstance(value, int):
        out += _field(3, 0, value)
    else:
        out += _field(4, 2, value.encode())
    return out + _field(20, 0, 1)


def _ensemble_attrs(ens):
    """The TreeEnsembleRegressor attributes of ``ens``: the nodes reachable
    from each root, in node-id order."""
    a = {k: [] for k in ("nodes_treeids", "nodes_nodeids", "nodes_modes",
                         "nodes_featureids", "nodes_values",
                         "nodes_truenodeids", "nodes_falsenodeids",
                         "target_treeids", "target_nodeids",
                         "target_weights")}
    for t in range(ens.feature.shape[0]):
        seen, stack = set(), [0]
        while stack:
            nd = stack.pop()
            seen.add(nd)
            if not ens.is_leaf[t, nd]:
                stack += [int(c) for c in ens.children[t, nd]]
        for nd in sorted(seen):
            leaf = bool(ens.is_leaf[t, nd])
            a["nodes_treeids"].append(t)
            a["nodes_nodeids"].append(nd)
            a["nodes_modes"].append("LEAF" if leaf else "BRANCH_LEQ")
            a["nodes_featureids"].append(0 if leaf else int(ens.feature[t, nd]))
            a["nodes_values"].append(0.0 if leaf
                                     else float(ens.threshold[t, nd]))
            a["nodes_truenodeids"].append(0 if leaf
                                          else int(ens.children[t, nd, 0]))
            a["nodes_falsenodeids"].append(0 if leaf
                                           else int(ens.children[t, nd, 1]))
            if leaf:
                a["target_treeids"].append(t)
                a["target_nodeids"].append(nd)
                a["target_weights"].append(float(ens.value[t, nd]))
    a["base_values"] = [float(ens.base_value)]
    return a


def _onnx_model(attrs):
    """ModelProto bytes: an ir_version, then a graph holding an Identity
    node and the TreeEnsembleRegressor node."""
    protos = [_attribute(k, v, packed=k not in ("nodes_values",
                                                  "target_nodeids"))
              for k, v in attrs.items()]
    protos += [_attribute("n_targets", 1), _attribute("post_transform", "NONE"),
               _attribute("scale", 1.0)]
    body = b"".join(_field(5, 2, p) for p in protos)
    tree_node = (_field(1, 2, b"input") + _field(2, 2, b"variable")
                 + _field(4, 2, b"TreeEnsembleRegressor") + body
                 + _field(7, 2, b"ai.onnx.ml"))
    identity = (_field(1, 2, b"x") + _field(2, 2, b"input")
                + _field(4, 2, b"Identity"))
    graph = (_field(1, 2, identity) + _field(1, 2, tree_node)
             + _field(2, 2, b"doench"))
    return _field(1, 0, 8) + _field(7, 2, graph)


def test_onnx_route_matches_jax(tmp_path):
    npz = port_doench.load_ensemble()
    path = str(tmp_path / "doench.onnx")
    with open(path, "wb") as fh:
        fh.write(_onnx_model(_ensemble_attrs(npz)))
    port_attrs = port_onnx.parse_tree_ensemble(path)
    assert port_attrs == jax_onnx.parse_tree_ensemble(path)
    assert port_attrs["n_targets"] == 1 and port_attrs["scale"] == 1.0
    assert port_attrs["post_transform"] == "NONE"
    port = port_onnx.TreeEnsemble.from_attrs(port_attrs)
    _assert_ensembles_equal(port, jax_onnx.TreeEnsemble.from_attrs(port_attrs))
    _assert_ensembles_equal(port, npz)
    scores = port_doench.predict(GOLDEN_SEQS, model_file=path)
    assert (scores == GOLDEN_SCORES).all()
    assert (scores == jax_doench.predict(GOLDEN_SEQS, model_file=path)).all()


def test_onnx_parser_errors_match_jax(tmp_path):
    no_graph = tmp_path / "empty.onnx"
    no_graph.write_bytes(_field(1, 0, 8))
    no_tree = tmp_path / "identity.onnx"
    no_tree.write_bytes(_field(7, 2, _field(1, 2, _field(4, 2, b"Identity"))))
    for path, what in ((no_graph, "no graph"), (no_tree, "no TreeEnsemble")):
        for parse in (port_onnx.parse_tree_ensemble,
                      jax_onnx.parse_tree_ensemble):
            with pytest.raises(ValueError, match=what):
                parse(str(path))


def test_reference_onnx_file_direct():
    """The reference's skl2onnx model, when its path is given in
    GUIDEMAKER_REFERENCE_ONNX, scores as the bundled tables do."""
    ref_onnx = os.environ.get("GUIDEMAKER_REFERENCE_ONNX", "")
    if not os.path.exists(ref_onnx):
        pytest.skip("reference onnx not available")
    seqs = GOLDEN_SEQS[:1]
    port = port_doench.predict(seqs, model_file=ref_onnx)
    assert (port == port_doench.predict(seqs)).all()
    assert (port == jax_doench.predict(seqs, model_file=ref_onnx)).all()
