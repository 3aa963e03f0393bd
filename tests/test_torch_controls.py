"""The port's control-guide search against the JAX package's.

The two packages draw candidates from different generators (threefry in
JAX, the torch generators here), so the ladders are compared on one
injected candidate stream: each side's sampler is replaced by one numpy
function of (rung, chunk).  On the JAX side a fake ``_device_sampler``
maps each ``fold_in(fold_in(PRNGKey(seed), rung), chunk)`` key back to its
(rung, chunk).  Given the same chunks, both ladders must return the same
frame, distances, ``ncontrolsearched`` and errors, exactly.
"""
import gzip
import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import guidemaker_tpu.targets as jax_targets
from guidemaker_tpu.io import parse_fasta as jax_parse_fasta
from guidemaker_tpu.knn.driver import KnnIndex as JaxKnnIndex
from guidemaker_tpu.scan import PamTarget as JaxPamTarget
from guidemaker_tpu_torch import dna, targets
from guidemaker_tpu_torch.io import parse_fasta
from guidemaker_tpu_torch.knn import KnnIndex
from guidemaker_tpu_torch.pipeline import PipelineConfig, run_pipeline
from guidemaker_tpu_torch.scan import PamTarget

TEST_DATA = os.path.join(os.path.dirname(__file__), "test_data")
FASTA = os.path.join(TEST_DATA, "Carsonella_ruddii.fasta.gz")
GBK = os.path.join(TEST_DATA, "Carsonella_ruddii.gbk.gz")
SEED = 17
N = 60


def _config(tmp_path, multiples, mindist=7):
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump({"CONTROL": {
        "MINIMUM_HMDIST": mindist, "CONTROL_SEARCH_MULTIPLE": multiples}}))
    return str(path)


@pytest.fixture(scope="module")
def genome():
    """C. ruddii targets from each package's scan, and the unique guides."""
    port = PamTarget("NGG", "5prime", "hamming").find_targets(
        parse_fasta(FASTA), 20)
    ref = JaxPamTarget("NGG", "5prime", "hamming").find_targets(
        jax_parse_fasta(FASTA), 20)
    uniq = list(pd.unique(port["target"]))
    assert uniq == list(pd.unique(ref["target"]))
    return port, ref, uniq


def _draw(db_codes, p_far):
    """Candidate chunks as a function of (rung, chunk): copies of genome
    guides with at most two substitutions (nearest distance <= 2), and a
    fraction ``p_far`` of uniform random guides, most of which pass."""
    def draw(rung, chunk, m, length):
        rng = np.random.default_rng([SEED, rung, chunk])
        codes = db_codes[rng.integers(0, len(db_codes), m)]
        rows = np.arange(m)
        for _ in range(2):
            codes[rows, rng.integers(0, length, m)] = rng.integers(0, 4, m)
        far = rng.random(m) < p_far
        codes[far] = rng.integers(0, 4, (int(far.sum()), length))
        return codes.astype(np.uint8)
    return draw


def _inject(monkeypatch, draw, n_rungs, max_chunks=16):
    keys = {}
    root = jax.random.PRNGKey(SEED)
    for rung in range(n_rungs):
        rkey = jax.random.fold_in(root, rung)
        for c in range(max_chunks):
            key = np.asarray(jax.random.fold_in(rkey, c)).tobytes()
            keys[key] = (rung, c)

    def jax_sample(key, cum, *, m, length):
        return jnp.asarray(draw(*keys[np.asarray(key).tobytes()], m, length))

    def port_sample(seed, rung, chunk, cum, m, length, device):
        assert seed == SEED
        return torch.from_numpy(draw(rung, chunk, m, length)).to(device)

    monkeypatch.setattr(jax_targets, "_device_sampler", lambda: jax_sample)
    monkeypatch.setattr(targets, "_sample_chunk", port_sample)


def _processors(genome, packed):
    port_t, ref_t, uniq = genome
    tl = targets.TargetProcessor(port_t, lsr=10, device="cpu")
    tl.index = KnnIndex(uniq, device="cpu", packed=packed)
    jtl = jax_targets.TargetProcessor(ref_t, lsr=10)
    jtl.index = JaxKnnIndex(uniq, backend="pallas")
    return tl, jtl


@pytest.mark.parametrize("packed,multiples,searched", [
    (False, [1, 10, 1000], N + 10 * N + 2 * 8192),   # chunked, early exit
    (True, [1, 10, 300], N + 10 * N + 300 * N)])     # monolithic rungs
def test_ladder_matches_jax(genome, tmp_path, monkeypatch, packed,
                            multiples, searched):
    if packed:
        monkeypatch.setenv("GUIDEMAKER_TPU_PACKED", "1")
    config = _config(tmp_path, multiples)
    _inject(monkeypatch, _draw(dna.encode_batch(genome[2], 20), 0.03),
            len(multiples))
    tl, jtl = _processors(genome, packed)
    assert tl.index.supports_chunk_triage(7) == (not packed)
    assert jtl.index.supports_chunk_triage(7) == (not packed)
    got = tl.get_control_seqs(parse_fasta(FASTA), config, length=20, n=N,
                              seed=SEED)
    want = jtl.get_control_seqs(jax_parse_fasta(FASTA), config, length=20,
                                n=N, seed=SEED)
    assert got[:2] == want[:2]
    pd.testing.assert_frame_equal(got[2], want[2])
    assert tl.ncontrolsearched == jtl.ncontrolsearched == searched
    assert (tl.gc_percent, tl.genomesize) == (jtl.gc_percent, jtl.genomesize)
    assert len(got[2]) == N and (got[2]["Hamming distance"] >= 7).all()


@pytest.mark.parametrize("packed", [False, True])
def test_ladder_exhaustion_matches_jax(genome, tmp_path, monkeypatch,
                                       packed):
    if packed:
        monkeypatch.setenv("GUIDEMAKER_TPU_PACKED", "1")
    config = _config(tmp_path, [1, 10])
    _inject(monkeypatch, _draw(dna.encode_batch(genome[2], 20), 0.0), 2)
    tl, jtl = _processors(genome, packed)
    msgs = []
    for proc, fasta in ((tl, parse_fasta), (jtl, jax_parse_fasta)):
        with pytest.raises(IndexError) as err:
            proc.get_control_seqs(fasta(FASTA), config, length=20, n=N,
                                  seed=SEED)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == ("Could not find controls with minimum "
                                  "distance 7 even with a search pool of 600")


def test_uncountable_target_verifies_every_candidate(genome, tmp_path,
                                                     monkeypatch):
    """A MINIMUM_HMDIST above the guide length cannot be counted: both
    ladders take an exact k=1 query of every candidate instead, and
    exhaust."""
    config = _config(tmp_path, [1, 10], mindist=21)
    _inject(monkeypatch, _draw(dna.encode_batch(genome[2], 20), 0.5), 2)
    tl, jtl = _processors(genome, False)
    assert tl.index.pass_mask_within(np.zeros((3, 20), np.uint8), 21) is None
    queried = []
    real = tl.index.hamming_query_codes
    monkeypatch.setattr(tl.index, "hamming_query_codes",
                        lambda qc, k: queried.append(len(qc)) or real(qc, k))
    msgs = []
    for proc, fasta in ((tl, parse_fasta), (jtl, jax_parse_fasta)):
        with pytest.raises(IndexError) as err:
            proc.get_control_seqs(fasta(FASTA), config, length=20, n=5,
                                  seed=SEED)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert queried == [5, 50]


def test_sampler_is_seeded_per_rung_and_chunk():
    cum = torch.cumsum(torch.tensor([.3, .3, .2, .2]), 0)
    cpu = torch.device("cpu")

    def draw(seed, rung, chunk):
        return targets._sample_chunk(seed, rung, chunk, cum, 500, 20, cpu)

    a = draw(7, 1, 2)
    assert a.dtype == torch.uint8 and a.shape == (500, 20)
    assert torch.equal(a, draw(7, 1, 2))
    for other in (draw(7, 1, 3), draw(7, 2, 2), draw(8, 1, 2)):
        assert not torch.equal(a, other)
    assert targets._control_chunk_rows(cpu) == 1 << 13
    assert targets._control_chunk_rows(torch.device("cuda")) == 1 << 19


@pytest.mark.parametrize("gc", [0.166, 0.5, 0.66])
def test_sampler_base_frequencies(gc):
    """A, C, G, T come out at (1-gc)/2, gc/2, gc/2, (1-gc)/2, within 1%."""
    cum = torch.cumsum(torch.tensor(
        [gc / 2, gc / 2, (1 - gc) / 2, (1 - gc) / 2], dtype=torch.float32), 0)
    codes = targets._sample_chunk(11, 0, 0, cum, 1 << 16, 20,
                                  torch.device("cpu"))
    freq = np.bincount(codes.numpy().ravel(), minlength=5) / codes.numel()
    expect = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2, 0]
    assert np.abs(freq - expect).max() < 0.01


def test_background_search_joins_and_reraises(genome):
    tl = targets.TargetProcessor(genome[0], lsr=10, device="cpu")
    tl.index = KnnIndex(genome[2], device="cpu")
    from guidemaker_tpu_torch.definitions import CONFIG_PATH
    tl.launch_control_search(FASTA, CONFIG_PATH, length=20, n=10, seed=3)
    joined = tl.get_control_seqs(None, CONFIG_PATH, length=20, n=10, seed=3)
    again = tl.get_control_seqs(parse_fasta(FASTA), CONFIG_PATH, length=20,
                                n=10, seed=3)
    pd.testing.assert_frame_equal(joined[2], again[2])
    tl.launch_control_search("missing.fasta", CONFIG_PATH, length=20, n=10)
    with pytest.raises(FileNotFoundError):
        tl.get_control_seqs(None, CONFIG_PATH, length=20, n=10)


def _read_gz(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


def test_pipeline_writes_controls(tmp_path):
    """controls.csv.gz holds n controls at >= MINIMUM_HMDIST, each at its
    exact nearest distance and named Cont-<md5>; targets.csv.gz is the
    controls=0 run's."""
    base = dict(genbank=[GBK], pamseq="NGG", device="cpu", seed=5)
    res = run_pipeline(PipelineConfig(outdir=str(tmp_path / "c"),
                                      controls=20, **base))
    run_pipeline(PipelineConfig(outdir=str(tmp_path / "z"), controls=0,
                                **base))
    assert (_read_gz(tmp_path / "c" / "targets.csv.gz")
            == _read_gz(tmp_path / "z" / "targets.csv.gz"))
    assert not (tmp_path / "z" / "controls.csv.gz").exists()
    ctl = pd.read_csv(tmp_path / "c" / "controls.csv.gz", index_col=0)
    pd.testing.assert_frame_equal(ctl, res.controls)
    assert list(ctl.columns) == ["name", "Sequences", "Hamming distance"]
    assert len(ctl) == 20 and (ctl["Hamming distance"] >= 7).all()
    assert list(ctl["Hamming distance"]) == sorted(ctl["Hamming distance"],
                                                   reverse=True)
    nearest = res.processor.index.query(list(ctl["Sequences"]), 1)[0][:, 0]
    assert (ctl["Hamming distance"] == nearest).all()
    assert (ctl["name"] == ["Cont-" + hashlib.md5(s.encode()).hexdigest()
                            for s in ctl["Sequences"]]).all()
    assert res.control_min_dist == ctl["Hamming distance"].min()
    assert res.control_median_dist == ctl["Hamming distance"].median()
    assert res.processor.ncontrolsearched >= 20
