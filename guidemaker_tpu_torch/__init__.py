"""GuideMaker on PyTorch and CUDA: CRISPR guide-RNA pool design.

A port of :mod:`guidemaker_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
H100, with the same library API and output tables.  Genome-wide exact
off-target search runs on hand-written CUDA kernels (``csrc/``); the CPU
runs their plain PyTorch versions.  This package imports ``torch`` and
never ``jax``.

* :class:`PamTarget` — PAM/target enumeration (vectorized motif scan)
* :class:`TargetProcessor` — guide filtering + exact off-target k-NN
* :class:`Annotation` — feature ingestion + nearest-feature join
* :func:`run_pipeline` — the design run; :mod:`.cli` its command line
"""

__version__ = "0.5.0"

from .definitions import CONFIG_PATH, DATA_DIR, ROOT_DIR  # noqa: E402
from .dna import extend_ambiguous_dna, reverse_complement  # noqa: E402
from .io import get_fastas, is_gzip  # noqa: E402
from .scan import PamTarget  # noqa: E402
from .targets import TargetProcessor  # noqa: E402
from .annotate import Annotation  # noqa: E402
from .pipeline import PipelineConfig, run_pipeline  # noqa: E402

__all__ = [
    "PamTarget", "TargetProcessor", "Annotation", "PipelineConfig",
    "run_pipeline", "get_fastas", "is_gzip", "extend_ambiguous_dna",
    "reverse_complement", "ROOT_DIR", "CONFIG_PATH", "DATA_DIR",
]
