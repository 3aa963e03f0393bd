"""The port's design run on C. ruddii, on the CPU, against the golden table
and against the JAX package's own run (exact, byte for byte)."""
import gzip
import io
import os
import subprocess
import sys

import pytest

from guidemaker_tpu.pipeline import PipelineConfig as JaxPipelineConfig
from guidemaker_tpu.pipeline import run_pipeline as jax_run_pipeline
from guidemaker_tpu_torch import definitions
from guidemaker_tpu_torch.annotate import Annotation
from guidemaker_tpu_torch.cli import config_from_args, main, myparser
from guidemaker_tpu_torch.io import parse_fasta
from guidemaker_tpu_torch.pipeline import PipelineConfig, run_pipeline
from guidemaker_tpu_torch.scan import PamTarget
from guidemaker_tpu_torch.targets import TargetProcessor

HERE = os.path.dirname(__file__)
ROOT = os.path.dirname(HERE)
FASTA = os.path.join(HERE, "test_data", "Carsonella_ruddii.fasta.gz")
GBK = os.path.join(HERE, "test_data", "Carsonella_ruddii.gbk.gz")
GOLDEN = os.path.join(HERE, "test_data", "golden_pretty_cruddii.csv.gz")


def test_parity_configuration_gives_golden_table():
    """tests/test_parity_e2e.py's configuration (NGG/5prime/20-mer, lsr 10,
    dist 2, knum 10, restriction NRAGCA) through the port."""
    targets = PamTarget("NGG", "5prime", "hamming").find_targets(
        parse_fasta(FASTA), 20)
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=10,
                         device="cpu")
    tl.check_restriction_enzymes(["NRAGCA"])
    tl.find_unique_near_pam()
    tl.create_index(configpath=definitions.CONFIG_PATH)
    tl.get_neighbors(configpath=definitions.CONFIG_PATH)
    anno = Annotation(annotation_list=[GBK], annotation_type="genbank",
                      target_bed_df=tl.export_bed())
    anno.get_annotation_features()
    anno._get_nearby_features()
    anno._filter_features(before_feat=100, after_feat=200)
    anno._get_qualifiers(configpath=definitions.CONFIG_PATH)
    anno._format_guide_table(tl)
    buf = io.StringIO()
    anno.pretty_df.to_csv(buf, index=False)
    with gzip.open(GOLDEN, "rt") as fh:
        assert buf.getvalue() == fh.read()


@pytest.fixture
def root_logging():
    """Drop the handlers cli.main adds to the root logger."""
    import logging
    before = list(logging.root.handlers)
    yield
    for h in logging.root.handlers[:]:
        if h not in before:
            logging.root.removeHandler(h)
            h.close()


def _read_gz(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("extra,name", [
    ([], "targets.csv.gz"),
    (["--pam_orientation", "5prime", "--knum", "2", "--lsr", "0"],
     "targets.csv.gz"),
    (["--raw_output_only"], "rawguides.csv.gz"),
    (["--doench_efficiency_score", "--cfd_score", "--plot"],
     "targets.csv.gz")])
def test_cli_matches_jax_run(tmp_path, extra, name, root_logging):
    port_out = tmp_path / "port"
    main(["--genbank", GBK, "--pamseq", "NGG", "--outdir", str(port_out),
          "--controls", "0", "--cpu", "--log", str(tmp_path / "run.log")]
         + extra)
    args = myparser().parse_args(["--genbank", GBK, "--pamseq", "NGG",
                                  "--outdir", str(tmp_path / "jax")] + extra)
    cfg = config_from_args(args)
    jax_run_pipeline(JaxPipelineConfig(
        genbank=[GBK], pamseq="NGG", outdir=str(tmp_path / "jax"),
        pam_orientation=cfg.pam_orientation, knum=cfg.knum, lsr=cfg.lsr,
        raw_output_only=cfg.raw_output_only, controls=0,
        doench_efficiency_score=cfg.doench_efficiency_score,
        cfd_score=cfg.cfd_score, plot=cfg.plot))
    got = _read_gz(port_out / name)
    assert got == _read_gz(tmp_path / "jax" / name)
    assert got.count(b"\n") > 500
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(tmp_path / "jax"))


@pytest.mark.parametrize("dist", [2, 3, 4])
def test_leven_run_matches_jax_run(tmp_path, dist):
    """--dtype leven on C. ruddii: dist 2 takes the Hamming count, dist 3
    the deletion join beside it, dist 4 the 3-gram tiers."""
    base = dict(genbank=[GBK], pamseq="NGG", controls=0, dtype="leven",
                dist=dist)
    res = run_pipeline(PipelineConfig(outdir=str(tmp_path / "port"),
                                      device="cpu", **base))
    jax_run_pipeline(JaxPipelineConfig(outdir=str(tmp_path / "jax"), **base))
    got = _read_gz(tmp_path / "port" / "targets.csv.gz")
    assert got == _read_gz(tmp_path / "jax" / "targets.csv.gz")
    assert res.processor.index.metric == "leven"
    assert got.count(b"\n") > 500 and b",leven," in got


def test_import_leaves_jax_out():
    code = ("import pkgutil, sys, importlib, guidemaker_tpu_torch as g\n"
            "for m in pkgutil.walk_packages(g.__path__, g.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'guidemaker_tpu' not in sys.modules\n"
            "assert 'triton' not in sys.modules\n"
            "assert 'streamlit' not in sys.modules\n"
            "assert {'guidemaker_tpu_torch.app', 'guidemaker_tpu_torch.plot',\n"
            "        'guidemaker_tpu_torch.score.doench'} <= set(sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("extra", [
    dict(doench_efficiency_score=True, cfd_score=True, plot=True),
    dict(cfd_score=True),
    dict(doench_efficiency_score=True, pam_orientation="5prime"),
    dict(dtype="leven", cfd_score=True)],
    ids=["doench-cfd-plot", "cfd", "doench-5prime", "leven-cfd"])
def test_scored_run_matches_jax_run(tmp_path, extra):
    """Scoring and plots on C. ruddii: the port's table and charts byte for
    byte the JAX package's."""
    base = dict(genbank=[GBK], pamseq="NGG", controls=0, **extra)
    res = run_pipeline(PipelineConfig(outdir=str(tmp_path / "port"),
                                      device="cpu", **base))
    jax_run_pipeline(JaxPipelineConfig(outdir=str(tmp_path / "jax"), **base))
    got = _read_gz(tmp_path / "port" / "targets.csv.gz")
    assert got == _read_gz(tmp_path / "jax" / "targets.csv.gz")
    assert got.count(b"\n") > 500
    df = res.targets
    assert ("target_seq30" in df) != bool(extra.get("doench_efficiency_score"))
    if extra.get("cfd_score"):
        assert (df["Max CFD"] <= 1.0).all() and (df["Max CFD"] < 1.0).any()
    if extra.get("pam_orientation") == "5prime":
        assert (df["Efficiency"] == "Not Available").all()
    elif extra.get("doench_efficiency_score"):
        assert df["Efficiency"].dtype == "float32"
    pages = sorted(p for p in os.listdir(tmp_path / "port")
                   if p.endswith(".html"))
    assert pages == (["AP009180.1.html"] if extra.get("plot") else [])
    for page in pages:
        with open(tmp_path / "port" / page) as a, \
                open(tmp_path / "jax" / page) as b:
            assert a.read() == b.read()


def test_cli_device_and_defaults():
    """Only --cpu moves the run off the card; the reference defaults stay,
    controls included."""
    base = ["--genbank", GBK, "--pamseq", "NGG", "--outdir", "o"]
    cfg = config_from_args(myparser().parse_args(base))
    assert cfg.device == "cuda" and cfg.controls == 1000 and cfg.knum == 5
    assert config_from_args(myparser().parse_args(base + ["--cpu"])).device \
        == "cpu"
    assert myparser().prog == "guidemaker-tpu-torch"
    # the epilog names the port's web app on a line of its own
    assert f"\nstreamlit run {definitions.WEB_APP}\n" in myparser().format_help()


def test_run_without_card_raises(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would use it")
    cfg = PipelineConfig(genbank=[GBK], pamseq="NGG", outdir=str(tmp_path),
                         controls=0)
    with pytest.raises(RuntimeError, match="is_available"):
        run_pipeline(cfg)
