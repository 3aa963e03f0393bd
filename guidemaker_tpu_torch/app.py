"""Streamlit web app for the PyTorch/CUDA port of GuideMaker.

The JAX package's app (``guidemaker_tpu/app.py``) on the port's CLI:
multi-file GenBank upload, FASTA + GFF/GTF upload, bundled demo genomes, a
restriction-enzyme tags widget, every design parameter, per-accession
result charts (Vega-Lite, rendered by Streamlit), download links, the
parameter dictionary and the pooled-CRISPR experiment protocol page, and
session cleanup.

Run with:  streamlit run guidemaker_tpu_torch/app.py
(add ``-- --cpu`` to run the design on the CPU).  The design runs on the
CUDA card unless the app is given ``device="cpu"``; without a card the CLI
refuses the run and the app shows its error.  Streamlit is an optional
dependency, imported in :func:`main` only; ``main(st)`` accepts an
injected streamlit-compatible module so the app logic is smoke-testable
headless.
"""
from __future__ import annotations

import base64
import os
import shutil
import subprocess
import sys
import uuid
from typing import List, Optional

import pandas as pd

if not __package__:
    # run as a script (``streamlit run``): put the checkout on the path so
    # the package imports by name
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
from guidemaker_tpu_torch import definitions  # noqa: E402

DEMO_GENOMES = ["Carsonella_ruddii.gbk.gz", "Pseudomonas_aeruginosa.gbk.gz"]


def build_cli_args(*, workdir: str, logfile: str, genbank: List[str] = (),
                   fasta: List[str] = (), gff: List[str] = (),
                   pam: str = "NGG", pam_orientation: str = "3prime",
                   guidelength: int = 20, lsr: int = 10, dtype: str = "hamming",
                   dist: int = 2, before: int = 100, into: int = 200,
                   knum: int = 3, controls: int = 10,
                   restriction_enzymes: Optional[List[str]] = None,
                   scoring: bool = True, threads: int = 2,
                   device: str = "cuda") -> List[str]:
    """The CLI invocation the app runs (pure function; unit-testable)."""
    args = [sys.executable, "-m", "guidemaker_tpu_torch.cli"]
    if genbank:
        args += ["--genbank"] + list(genbank)
    else:
        args += ["--fasta"] + list(fasta) + ["--gff"] + list(gff)
    args += ["--pamseq", pam,
             "--guidelength", str(guidelength),
             "--pam_orientation", pam_orientation,
             "--lsr", str(lsr), "--dtype", dtype, "--dist", str(dist),
             "--outdir", workdir, "--log", logfile,
             "--into", str(into), "--before", str(before),
             "--knum", str(knum), "--controls", str(int(controls)),
             "--threads", str(threads), "--plot"]
    if scoring:
        args += ["--cfd_score", "--doench_efficiency_score"]
    if restriction_enzymes:
        args += ["--restriction_enzyme_list"] + list(restriction_enzymes)
    if device == "cpu":
        args.append("--cpu")
    elif device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    return args


def run_command(st, args):
    """Run the CLI and surface status (reference app.py:93-104)."""
    st.info(f"Running:: '{' '.join(args)}'")
    env = dict(os.environ)
    pkg_parent = os.path.dirname(definitions.ROOT_DIR)
    env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
    result = subprocess.run(args, capture_output=True, text=True, env=env)
    if result.returncode != 0:
        st.error(result.stderr[-4000:])
    else:
        st.info("GuideMaker run complete")
    return result.returncode


def download_link(path: str, label: str) -> str:
    """Binary file downloader as an HTML anchor (reference app.py:107-113)."""
    with open(path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    name = os.path.basename(path)
    return (f'<a href="data:application/octet-stream;base64,{b64}" '
            f'download="{name}">{label}</a>')


def _tags_widget(st, label: str, default: List[str]) -> List[str]:
    """Restriction-enzyme tags input: streamlit_tags when installed
    (reference app.py:209), else a space-separated text input."""
    try:
        from streamlit_tags import st_tags_sidebar
        return st_tags_sidebar(label=label, text="Enter to add more",
                               value=default)
    except ImportError:
        raw = st.sidebar.text_input(label + " (space separated)",
                                    value=" ".join(default))
        return raw.split()


def render_results(st, workdir: str, logfile: str) -> None:
    """Per-accession interactive charts + download links
    (reference app.py:303-341)."""
    targets_path = os.path.join(workdir, "targets.csv.gz")
    if not os.path.exists(targets_path):
        return
    from guidemaker_tpu_torch.plot import _single_spec
    source = pd.read_csv(targets_path, low_memory=False)
    for accession in sorted(set(source["Accession"])):
        st.markdown(f"**Accession:** {accession}")
        st.vega_lite_chart(None, _single_spec(
            source[source["Accession"] == accession]))
    st.subheader(f"Guide RNAs ({len(source)})")
    st.dataframe(source.head(500))
    st.markdown(download_link(targets_path, "✅ Download targets.csv.gz"),
                unsafe_allow_html=True)
    controls_path = os.path.join(workdir, "controls.csv.gz")
    if os.path.exists(controls_path):
        ctrl = pd.read_csv(controls_path)
        st.subheader(f"Control RNAs ({len(ctrl)})")
        st.dataframe(ctrl.head(100))
        st.markdown(download_link(controls_path,
                                  "✅ Download controls.csv.gz"),
                    unsafe_allow_html=True)
    if os.path.exists(logfile):
        st.markdown(download_link(logfile, "✅ Log File"),
                    unsafe_allow_html=True)


def main(st=None, device: str = "cuda"):
    """Run the web app (``st`` injectable for headless smoke tests); the
    design runs on ``device``, ``"cuda"`` or ``"cpu"``."""
    if st is None:  # pragma: no cover - interactive path
        try:
            import streamlit as st
        except ImportError as e:
            raise SystemExit(
                "The web app requires streamlit (`pip install streamlit`); "
                "the guidemaker-tpu-torch CLI and library do not.") from e

    st.markdown('<strong style="font-size:36px;color:#0021A5">'
                'GuideMaker</strong>', unsafe_allow_html=True)
    st.markdown('<strong style="font-size:18px;color:#FA4616">Design '
                'CRISPR-Cas guide RNA pools in non-model genomes \U0001F9A0 '
                '\U0001F9EC — exact genome-wide off-target search'
                '</strong>', unsafe_allow_html=True)
    st.markdown("---")
    st.sidebar.markdown(f"Design runs on: **{device}**")

    session_id = str(uuid.uuid4())
    workdir = os.path.join(".streamlit_runs", session_id)
    os.makedirs(workdir, exist_ok=True)
    logfile = os.path.join(workdir, "guidemaker.log")

    # --- inputs (reference app.py:191-227) ---
    gbk_files = st.sidebar.file_uploader(
        "Upload one or more genome files [.gbk, .gbk.gz]",
        type=[".gbk", ".gb", ".gz", ".gbff"], accept_multiple_files=True)
    fasta_files = st.sidebar.file_uploader(
        "Upload one or more FASTA files [.fasta, .fasta.gz]",
        type=[".fasta", ".fna", ".fa", ".gz"], accept_multiple_files=True)
    gff_files = st.sidebar.file_uploader(
        "Upload GFF/GTF file(s) if you are using FASTA [.gff, .gtf]",
        type=[".gff", ".gff3", ".gtf", ".gz"], accept_multiple_files=True)
    demo = st.sidebar.selectbox("OR use a demo genome", DEMO_GENOMES)

    pam = st.sidebar.text_input("Input PAM motif [e.g. NGG]", "NGG")
    restriction = _tags_widget(st, "Restriction enzymes [e.g. NGRT]:",
                               ["NGRT"])
    pam_orientation = st.sidebar.selectbox(
        "PAM orientation [3prime, 5prime]", ("3prime", "5prime"))
    guidelength = st.sidebar.number_input("Guide length [10-27]", 10, 27,
                                          value=20)
    lsr = st.sidebar.number_input("Length of seed region [0-27]", 0, 27,
                                  value=10)
    dtype = st.sidebar.selectbox("Distance type [hamming, leven]",
                                 ("hamming", "leven"))
    dist = st.sidebar.number_input("Edit distance [0-5]", 0, 5, value=2)
    before = st.sidebar.number_input("Before [1-500]", 1, 500, value=100,
                                     step=50)
    into = st.sidebar.number_input("Into [1-500]", 1, 500, value=200,
                                   step=50)
    knum = st.sidebar.number_input("Similar guides [2-20]", 2, 20, value=3)
    controls = st.sidebar.number_input("Control RNAs", 1, 100000, value=10,
                                       step=100)
    scoring = st.sidebar.checkbox(
        "Doench efficiency + CFD scores (NGG 3prime only)", value=True)

    # --- stage the chosen inputs ---
    def _save(uploaded, name):
        path = os.path.join(workdir, name)
        with open(path, "wb") as f:
            f.write(uploaded.getbuffer() if hasattr(uploaded, "getbuffer")
                    else uploaded)
        return path

    genbank_paths, fasta_paths, gff_paths = [], [], []
    if gbk_files:
        genbank_paths = [_save(u, f"input_{i}.gbk{'.gz' if u.name.endswith('.gz') else ''}")
                         for i, u in enumerate(gbk_files)]
    elif fasta_files and gff_files:
        fasta_paths = [_save(u, f"input_{i}.fasta{'.gz' if u.name.endswith('.gz') else ''}")
                       for i, u in enumerate(fasta_files)]
        gff_paths = [_save(u, f"input_{i}.gff{'.gz' if u.name.endswith('.gz') else ''}")
                     for i, u in enumerate(gff_files)]
    else:
        genbank_paths = [os.path.join(definitions.DATA_DIR, demo)]

    args = build_cli_args(
        workdir=workdir, logfile=logfile, genbank=genbank_paths,
        fasta=fasta_paths, gff=gff_paths, pam=pam,
        pam_orientation=pam_orientation, guidelength=int(guidelength),
        lsr=int(lsr), dtype=dtype, dist=int(dist), before=int(before),
        into=int(into), knum=int(knum), controls=int(controls),
        restriction_enzymes=restriction, scoring=bool(scoring),
        device=device)

    if st.sidebar.button("SUBMIT"):
        if run_command(st, args) == 0:
            render_results(st, workdir, logfile)

    # --- parameter dictionary + protocol page (reference app.py:343-351) ---
    with st.expander("Parameter Dictionary"):
        with open(definitions.APP_PARAMETER_FILE) as fh:
            st.markdown(fh.read())
    with st.expander("Designing Experiments with GuideMaker Results"):
        with open(definitions.APP_EXPERIMENT_FILE) as fh:
            st.markdown(fh.read(), unsafe_allow_html=True)
    st.markdown(
        "##### License ©️\n\n*This app reimplements the USDA-ARS "
        "GuideMaker workflow (CC0 1.0) on PyTorch and CUDA.*")

    if st.button("Clean up session files"):
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    # streamlit run guidemaker_tpu_torch/app.py [-- --cpu]
    main(device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
