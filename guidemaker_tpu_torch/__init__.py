"""GuideMaker on PyTorch and CUDA: CRISPR guide-RNA pool design.

A port of :mod:`guidemaker_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
H100, with the same library API and output tables.  Genome-wide exact
off-target search runs on hand-written CUDA kernels (``csrc/``); the CPU
runs their plain PyTorch versions.  This package imports ``torch`` and
never ``jax``.

* :class:`PamTarget` — PAM/target enumeration (vectorized motif scan)
* :class:`TargetProcessor` — guide filtering + exact off-target k-NN
* :class:`Annotation` — feature ingestion + nearest-feature join
* :func:`cfd_score`, :func:`get_doench_efficiency_score` — scoring
* :func:`run_pipeline` — the design run; :mod:`.cli` its command line,
  :mod:`.app` its Streamlit web app
"""

__version__ = "0.5.0"

from .definitions import (APP_EXPERIMENT_FILE, APP_PARAMETER_IMG,  # noqa: E402
                          CONFIG_PATH, DATA_DIR, ROOT_DIR, WEB_APP)
from .dna import extend_ambiguous_dna, reverse_complement  # noqa: E402
from .io import get_fastas, is_gzip  # noqa: E402
from .scan import PamTarget  # noqa: E402
from .targets import TargetProcessor  # noqa: E402
from .annotate import Annotation  # noqa: E402
from .score import cfd_score, get_doench_efficiency_score  # noqa: E402
from .plot import GuideMakerPlot  # noqa: E402
from .pipeline import PipelineConfig, run_pipeline  # noqa: E402
from . import doench_predict  # noqa: E402
from . import cfd_score_calculator  # noqa: E402
from . import doench_featurization  # noqa: E402

__all__ = [
    "PamTarget", "TargetProcessor", "Annotation", "PipelineConfig",
    "run_pipeline", "get_fastas", "is_gzip", "extend_ambiguous_dna",
    "reverse_complement", "cfd_score", "get_doench_efficiency_score",
    "GuideMakerPlot", "doench_predict", "cfd_score_calculator",
    "doench_featurization", "ROOT_DIR", "CONFIG_PATH", "DATA_DIR", "WEB_APP",
    "APP_PARAMETER_IMG", "APP_EXPERIMENT_FILE",
]

# `guidemaker_tpu_torch.core` mirrors `guidemaker.core` for drop-in use.
from . import core  # noqa: E402,F401
