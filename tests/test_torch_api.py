"""The port's k-NN library API against the JAX package's.

``knn_search``, the JAX keywords of ``KnnIndex`` (``backend=``,
``num_threads=``), ``KnnIndex.load(..., backend=)`` and
``TargetProcessor.prewarm_controls`` are called as a JAX-package user
calls them.  Results are integers and frames, so the tolerance is exact
equality.  The port runs on the CPU here (its kernels' plain versions),
the JAX package on its XLA backend.
"""
import inspect
import os

import numpy as np
import pandas as pd
import pytest
import torch

import guidemaker_tpu.targets as jax_targets
from guidemaker_tpu.knn import KnnIndex as JaxKnnIndex
from guidemaker_tpu.knn import knn_search as jax_knn_search
from guidemaker_tpu_torch import targets
from guidemaker_tpu_torch.definitions import CONFIG_PATH
from guidemaker_tpu_torch.io import parse_fasta
from guidemaker_tpu_torch.knn import KnnIndex, knn_search
from guidemaker_tpu_torch.scan import PamTarget

FASTA = os.path.join(os.path.dirname(__file__), "test_data",
                     "Carsonella_ruddii.fasta.gz")


def _random_seqs(rng, n, length):
    return ["".join(rng.choice(list("ACGT"), size=length)) for _ in range(n)]


def _fixture(name):
    """(db, queries, k) of the knn_search cases of tests/test_knn.py."""
    if name.startswith("random"):
        nq, nd, k = (int(x) for x in name.split("_")[1:])
        rng = np.random.default_rng(nq * nd)
        q = _random_seqs(rng, nq, 20)
        return _random_seqs(rng, nd, 20), q, k
    if name == "self":
        seqs = _random_seqs(np.random.default_rng(0), 50, 20)
        return seqs, seqs, 2
    if name == "ties":
        return ["AAAA", "AAAT", "AAAT", "TTTT"], ["AAAA"], 3
    if name == "k_above_db":
        return ["ACGT", "TTTT"], ["ACGT"], 5
    if name == "leven_oracle":
        rng = np.random.default_rng(7)
        q = _random_seqs(rng, 40, 20)
        return _random_seqs(rng, 200, 20), q, 4
    # one substitution against one insertion (tests/test_knn.py:134-143)
    g1 = "CTAGTCACTAGCTGACAGCA"
    g2 = "CTAGACACTAGCTGACAGCA"
    g3 = "TAGTCACTAGCTGACTAGCA"
    return [g1, g2, g3], [g1], 3


FIXTURES = ["random_5_7_3", "random_100_300_5", "random_257_1025_20", "self",
            "ties", "k_above_db", "leven_oracle", "insertion"]


@pytest.mark.parametrize("metric", ["hamming", "leven"])
@pytest.mark.parametrize("name", FIXTURES)
def test_knn_search_matches_jax(name, metric):
    db, q, k = _fixture(name)
    got = knn_search(db, q, k, metric=metric, device="cpu")
    want = jax_knn_search(db, q, k, metric=metric)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (len(q), k)
        np.testing.assert_array_equal(g, w)


def test_knn_search_defaults_to_the_card():
    """Like every entry point of the port, ``knn_search`` runs on the card
    unless the caller asks for the CPU."""
    assert inspect.signature(knn_search).parameters["device"].default == \
        "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            knn_search(["ACGT"], ["ACGT"], 1)


@pytest.mark.parametrize("backend", ["xla", "native", "cpu"])
def test_index_takes_the_jax_keywords(backend):
    rng = np.random.default_rng(21)
    seqs = _random_seqs(rng, 120, 20)
    queries = seqs[:10] + _random_seqs(rng, 10, 20)
    idx = KnnIndex(seqs, "hamming", backend=backend, num_threads=3)
    assert idx.device.type == "cpu"
    ref = JaxKnnIndex(seqs, "hamming", backend="xla", num_threads=3)
    for got, want in zip(idx.query(queries, 4), ref.query(queries, 4)):
        np.testing.assert_array_equal(got, want)
    # the same backend beside an agreeing device is accepted
    assert KnnIndex(seqs, backend=backend, device="cpu").device.type == "cpu"


def test_index_backend_errors():
    seqs = ["ACGTACGT", "TTTTACGT"]
    with pytest.raises(ValueError, match="runs on"):
        KnnIndex(seqs, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        KnnIndex(seqs, backend="tpu-v9")
    if not torch.cuda.is_available():
        # a TPU backend maps to the card; without one that raises
        with pytest.raises(RuntimeError, match="is_available"):
            KnnIndex(seqs, backend="sharded")


def test_load_takes_backend(tmp_path):
    rng = np.random.default_rng(22)
    seqs = _random_seqs(rng, 80, 20)
    path = str(tmp_path / "idx.npz")
    JaxKnnIndex(seqs, backend="pallas").save(path)
    ref = JaxKnnIndex.load(path, backend="xla")
    for backend in ("xla", "native"):
        port = KnnIndex.load(path, backend=backend)
        assert port.device.type == "cpu" and port.seqs == seqs
        for got, want in zip(port.query(seqs[:20], 3), ref.query(seqs[:20],
                                                                  3)):
            np.testing.assert_array_equal(got, want)
    assert KnnIndex.load(path, device="cpu", backend="xla").metric == \
        "hamming"
    with pytest.raises(ValueError, match="runs on"):
        KnnIndex.load(path, device="cpu", backend="pallas")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            KnnIndex.load(path)            # saved "pallas" -> the card


def test_prewarm_controls_is_a_noop():
    """Same signature as the JAX method; the control search after it gives
    the same frame as one without it."""
    names = list(inspect.signature(
        jax_targets.TargetProcessor.prewarm_controls).parameters)
    assert list(inspect.signature(
        targets.TargetProcessor.prewarm_controls).parameters) == names
    found = PamTarget("NGG", "5prime", "hamming").find_targets(
        parse_fasta(FASTA), 20)
    frames = []
    for warm in (True, False):
        tl = targets.TargetProcessor(found, lsr=10, device="cpu")
        tl.index = KnnIndex(list(pd.unique(found["target"])), device="cpu")
        if warm:
            assert tl.prewarm_controls(CONFIG_PATH, 20, 10) is None
        frames.append(tl.get_control_seqs(parse_fasta(FASTA), CONFIG_PATH,
                                          length=20, n=10, seed=5))
    assert frames[0][:2] == frames[1][:2]
    pd.testing.assert_frame_equal(frames[0][2], frames[1][2])
