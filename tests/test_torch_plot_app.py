"""The port's plot writer and Streamlit app against the JAX package's:
the same Vega-Lite spec and HTML on the same frame, the app's CLI
invocation with its device, and a headless run of the app on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

import guidemaker_tpu.app as jax_app
from guidemaker_tpu.plot import GuideMakerPlot as JaxPlot
from guidemaker_tpu.plot import _single_spec as jax_spec
from guidemaker_tpu_torch import app, definitions
from guidemaker_tpu_torch.plot import GuideMakerPlot, _single_spec
from test_plot_app import FakeStreamlit, _df

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scored_df():
    """A frame like a scored design table: float32 scores, a missing
    value, a list column."""
    df = _df().assign(Efficiency=np.array([0.5, 0.25, 0.125, 1.0],
                                          dtype=np.float32))
    df["product"] = ["a", None, "c", np.nan]
    df["CFD Similar Guides"] = [["1.0", "0.5"], ["1.0"], [], ["0.25"]]
    return df


@pytest.mark.parametrize("make", [_df, _scored_df])
def test_single_spec_matches_jax(make):
    spec = _single_spec(make())
    assert spec == jax_spec(make())
    assert spec["$schema"].endswith("v5.json") and len(spec["vconcat"]) == 3


def test_plot_html_per_accession_matches_jax(tmp_path):
    df = pd.concat([_scored_df(), _scored_df().assign(Accession="acc2")])
    GuideMakerPlot(prettydf=df, outdir=str(tmp_path / "port"))
    JaxPlot(prettydf=df, outdir=str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == ["acc1.html", "acc2.html"]
    for name in ("acc1.html", "acc2.html"):
        html = (tmp_path / "port" / name).read_text()
        assert html == (tmp_path / "jax" / name).read_text()
        assert "vega-embed" in html and "Guide Density" in html


def test_app_imports_without_streamlit():
    code = ("import sys, guidemaker_tpu_torch.app as app\n"
            "assert callable(app.main)\n"
            "assert 'streamlit' not in sys.modules\n"
            "assert 'jax' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_app_runs_as_a_script(tmp_path):
    """``streamlit run`` executes the file as a script, outside its
    package: the imports must still resolve."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, definitions.WEB_APP],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=120)
    assert "Traceback" not in proc.stderr, proc.stderr
    assert definitions.WEB_APP == os.path.join(ROOT, "guidemaker_tpu_torch",
                                               "app.py")


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_build_cli_args_names_the_port_and_its_device(device):
    kw = dict(workdir="/w", logfile="/w/x.log", genbank=["g.gbk"],
              restriction_enzymes=["NGRT"], scoring=True)
    args = app.build_cli_args(device=device, **kw)
    assert args[:3] == [sys.executable, "-m", "guidemaker_tpu_torch.cli"]
    assert ("--cpu" in args) == (device == "cpu")
    want = jax_app.build_cli_args(**kw)[3:] + (["--cpu"] if device == "cpu"
                                               else [])
    assert args[3:] == want
    f = app.build_cli_args(workdir="/w", logfile="/w/x.log", fasta=["a.fa"],
                           gff=["a.gff"], scoring=False, device=device)
    assert "--fasta" in f and "--gff" in f and "--cfd_score" not in f
    assert ("--cpu" in f) == (device == "cpu")


def test_build_cli_args_refuses_other_devices():
    with pytest.raises(ValueError, match="device"):
        app.build_cli_args(workdir="/w", logfile="/w/x.log", genbank=["g"],
                           device="tpu")


def test_app_headless_smoke(tmp_path, monkeypatch):
    """main() on the bundled C. ruddii demo, on the CPU: the app runs the
    port's CLI, renders the chart, the tables and the download links."""
    monkeypatch.chdir(tmp_path)
    fake = FakeStreamlit()
    app.main(st=fake, device="cpu")
    kinds = [k for k, _ in fake.calls]
    assert "error" not in kinds, [c for c in fake.calls if c[0] == "error"]
    assert "vega_lite_chart" in kinds, "per-accession chart not rendered"
    assert kinds.count("dataframe") == 2, "targets or controls not rendered"
    ran = [v for k, v in fake.calls if k == "info" and "Running" in v]
    assert len(ran) == 1 and "guidemaker_tpu_torch.cli" in ran[0]
    assert "--cpu" in ran[0] and "--cfd_score" in ran[0]
    blobs = " ".join(str(v) for _, v in fake.calls)
    assert "download=" in blobs and "targets.csv.gz" in blobs
    assert "controls.csv.gz" in blobs and "Design runs on: **cpu**" in blobs
    assert "Parameter" in blobs or "PAM motif" in blobs
    (run,) = os.listdir(tmp_path / ".streamlit_runs")
    out = tmp_path / ".streamlit_runs" / run
    table = pd.read_csv(out / "targets.csv.gz")
    assert {"Efficiency", "CFD Similar Guides", "Max CFD"} <= set(table)
    assert len(pd.read_csv(out / "controls.csv.gz")) == 10
    assert [p for p in os.listdir(out) if p.endswith(".html")] == \
        ["AP009180.1.html"]
