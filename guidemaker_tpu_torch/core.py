"""Namespace shim mirroring ``guidemaker.core`` for drop-in compatibility."""
from .scan import PamTarget  # noqa: F401
from .targets import TargetProcessor  # noqa: F401
from .annotate import Annotation  # noqa: F401
from .dna import extend_ambiguous_dna, reverse_complement  # noqa: F401
from .io import get_fastas, is_gzip  # noqa: F401
from .score import cfd_score, get_doench_efficiency_score  # noqa: F401
from .plot import GuideMakerPlot  # noqa: F401
