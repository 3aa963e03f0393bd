"""End-to-end guide-design pipeline (library API).

The orchestration mirrors the reference CLI flow
(``guidemaker/cli.py:123-273``) as a callable library function returning
DataFrames, with the CLI as a thin wrapper.  The k-NN stages run on
``PipelineConfig.device``: a CUDA card by default, the CPU only when asked.
Scoring and plots run on the host, as in the JAX package.
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
from dataclasses import dataclass, field
from typing import List, Optional

import pandas as pd

from . import definitions
from .annotate import Annotation
from .io import get_fastas, parse_fasta
from .knn.sharded import rank_and_world
from .plot import GuideMakerPlot
from .scan import PamTarget
from .score import cfd_score, get_doench_efficiency_score
from .targets import TargetProcessor
from .util import maybe_profile, resolve_device, stage_timer, substage_timer

logger = logging.getLogger(__name__)


@dataclass
class PipelineConfig:
    """All knobs of a guide-design run (defaults = reference CLI defaults)."""
    genbank: Optional[List[str]] = None
    fasta: Optional[List[str]] = None
    gff: Optional[List[str]] = None
    pamseq: str = "NGG"
    pam_orientation: str = "3prime"
    guidelength: int = 20
    lsr: int = 10
    dtype: str = "hamming"
    dist: int = 2
    before: int = 100
    into: int = 200
    knum: int = 5
    controls: int = 1000
    threads: int = 2
    restriction_enzyme_list: List[str] = field(default_factory=list)
    feature_types: Optional[List[str]] = None
    attribute_key: str = "ID"
    filter_by_attribute: List[str] = field(default_factory=list)
    doench_efficiency_score: bool = False
    cfd_score: bool = False
    raw_output_only: bool = False
    plot: bool = False
    keeptemp: bool = False
    profile: Optional[str] = None   # torch profiler trace directory
    seed: Optional[int] = None      # control-sampling seed (None=unseeded)
    tempdir: Optional[str] = None
    outdir: str = "."
    config: str = definitions.CONFIG_PATH
    device: str = "cuda"

    def validate(self) -> None:
        """Reference parser validation (cli.py:80-89)."""
        assert self.lsr <= self.guidelength, (
            "The length of sequence near the PAM .i.e seed sequence that must "
            "be less than the guide length")
        assert 1 < len(self.pamseq) < 9, \
            "The length of the PAM sequence must be between 2-8"
        assert ((self.genbank is not None and self.fasta is None and self.gff is None)
                or (self.genbank is None and self.fasta is not None and self.gff is not None)
                or ((self.genbank is not None or self.fasta is not None)
                    and self.raw_output_only)), (
            "Please provide either Genbank files or Fasta and GFF files. If "
            "raw_output_only is selected Genbank or Fasta files are required.")


@dataclass
class PipelineResult:
    targets: Optional[pd.DataFrame] = None       # final pretty table
    raw_bed: Optional[pd.DataFrame] = None       # seed-unique guides (bed)
    controls: Optional[pd.DataFrame] = None
    control_min_dist: Optional[float] = None
    control_median_dist: Optional[float] = None
    processor: Optional[TargetProcessor] = None
    annotation: Optional[Annotation] = None


def run_pipeline(cfg: PipelineConfig, write_outputs: bool = True) -> PipelineResult:
    """Run the GuideMaker workflow; optionally write csv.gz outputs.

    Under a ``torch.distributed`` process group every rank runs this with
    the same ``cfg`` and returns the whole result; the index is sharded
    over the ranks, and only rank 0 writes files."""
    cfg.validate()
    write_outputs = write_outputs and rank_and_world()[0] == 0
    device = resolve_device(cfg.device)
    result = PipelineResult()
    owns_tempdir = False
    if cfg.tempdir and not os.path.exists(cfg.tempdir):
        logger.warning("Specified tempdir %s does not exist; creating it",
                       cfg.tempdir)
        os.makedirs(cfg.tempdir)
        tempdir = cfg.tempdir
    elif cfg.tempdir:
        tempdir = cfg.tempdir
    else:
        tempdir = tempfile.mkdtemp(prefix="guidemaker_")
        owns_tempdir = True
    nb_t = write_t = None
    try:
        with stage_timer("fasta conversion"):
            if cfg.genbank:
                logger.info("Writing fasta file from genbank file(s)")
                fastapath = get_fastas(cfg.genbank, input_format="genbank",
                                       tempdir=tempdir)
            else:
                fastapath = get_fastas(cfg.fasta, input_format="fasta",
                                       tempdir=tempdir)

        logger.info("Identifying PAM sites in the genome")
        pamobj = PamTarget(cfg.pamseq, cfg.pam_orientation, cfg.dtype)
        with stage_timer("pam scan"):
            pamtargets = pamobj.find_targets(
                seq_record_iter=parse_fasta(fastapath),
                target_len=cfg.guidelength)
        tl = TargetProcessor(targets=pamtargets, lsr=cfg.lsr,
                             editdist=cfg.dist, knum=cfg.knum, device=device)
        result.processor = tl
        logger.info("Total PAM sites considered: %d", len(tl))

        logger.info("Checking guides for restriction enzymes")
        tl.check_restriction_enzymes(
            restriction_enzyme_list=cfg.restriction_enzyme_list)
        logger.info("Identifying guides that are unique near the PAM site")
        tl.find_unique_near_pam()
        logger.info("Number of guides with non unique seed sequence: %d",
                    int(tl.targets.isseedduplicated.sum()))

        logger.info("Indexing all potential guide sites (exact k-NN)")
        with stage_timer("index build"):
            tl.create_index(configpath=cfg.config, num_threads=cfg.threads)
        logger.info("Finding guides with distance > %s to all other guides",
                    cfg.dist)
        # The retention pass runs in a background thread: nothing before
        # the table format needs its result, so its device time overlaps
        # the host-bound annotation stages.  The "exact k-NN" stage records
        # the join wait, the wall-clock the pass costs the pipeline.
        # Across processes its collectives keep one order on every rank
        # only because, while it runs, this thread issues no collective
        # until _join_neighbors.
        nb_exc: List[BaseException] = []

        def _run_neighbors():
            try:
                with maybe_profile(cfg.profile):
                    tl.get_neighbors(configpath=cfg.config,
                                     num_threads=cfg.threads)
            except BaseException as exc:   # re-raised at the join
                nb_exc.append(exc)

        nb_t = threading.Thread(target=_run_neighbors, name="gm-retention",
                                daemon=True)
        nb_t.start()

        def _join_neighbors():
            with stage_timer("exact k-NN"):
                nb_t.join()
            if nb_exc:
                raise nb_exc[0]

        tf_df = tl.export_bed()
        result.raw_bed = tf_df

        if cfg.raw_output_only:
            _join_neighbors()
            if write_outputs:
                os.makedirs(cfg.outdir, exist_ok=True)
                out = os.path.join(cfg.outdir, "rawguides.csv.gz")
                tf_df.to_csv(out, index=False, header=[
                    "Chromosome", "Start", "Stop", "gRNA", "Strand"])
                logger.info("Raw guides written to %s", out)
            return result

        logger.info("Creating annotations")
        if cfg.genbank:
            anno = Annotation(annotation_list=cfg.genbank,
                              annotation_type="genbank", target_bed_df=tf_df)
        else:
            anno = Annotation(annotation_list=cfg.gff,
                              annotation_type="gff", target_bed_df=tf_df)
        result.annotation = anno
        with stage_timer("annotation"):
            with substage_timer("anno: parse features"):
                anno.get_annotation_features(feature_types=cfg.feature_types)
            logger.info("Total number of %s in the input genome: %d",
                        *anno.locuslen())
            with substage_timer("anno: nearby join"):
                anno._get_nearby_features()
            with substage_timer("anno: filter clauses"):
                anno._filter_features(before_feat=cfg.before,
                                      after_feat=cfg.into)
            with substage_timer("anno: qualifiers"):
                anno._get_qualifiers(configpath=cfg.config)
        _join_neighbors()
        if cfg.controls > 0:
            # the control search (mostly device time) runs in the
            # background from here, after the retention pass has left the
            # card, and hides behind the table and write stages; the
            # "controls" stage below records its join wait.  Under a
            # process group of world size > 1 it starts nothing, and the
            # search runs in that stage, on this thread
            tl.launch_control_search(fastapath, configpath=cfg.config,
                                     length=cfg.guidelength,
                                     n=cfg.controls, seed=cfg.seed)
        with stage_timer("format table"):
            anno._format_guide_table(tl)
        prettydf = anno._filterlocus(cfg.attribute_key, cfg.filter_by_attribute)

        # scoring is host work: the control search runs on the card behind it
        if cfg.doench_efficiency_score:
            logger.info("Scoring on-target efficiency (Doench et al. 2016)")
            with stage_timer("doench scoring"):
                prettydf = get_doench_efficiency_score(
                    df=prettydf, pam_orientation=cfg.pam_orientation,
                    num_threads=cfg.threads)
        if cfg.cfd_score:
            logger.info("Scoring off-target activity (CFD)")
            with stage_timer("cfd scoring"):
                prettydf = cfd_score(df=prettydf)

        fd_zero = prettydf["Feature distance"].isin([0]).sum()
        logger.info("Guides within a gene (zero feature distance): %d", fd_zero)
        result.targets = prettydf

        write_exc: List[BaseException] = []
        if write_outputs:
            os.makedirs(cfg.outdir, exist_ok=True)

            def _write_targets():
                # format once via to_csv(index=False), then gzip the blob
                # in one pass; compresslevel 1 is ~3x faster than the zlib
                # default and the content (and pd.read_csv round trip) is
                # identical
                try:
                    import gzip
                    data = prettydf.to_csv(index=False)
                    with gzip.open(os.path.join(cfg.outdir,
                                                "targets.csv.gz"),
                                   "wb", compresslevel=1) as fh:
                        fh.write(data.encode())
                except BaseException as exc:   # re-raised at the join
                    write_exc.append(exc)

            # the write overlaps the controls join (host CPU beside a
            # device wait); its stage records the join wait
            write_t = threading.Thread(target=_write_targets,
                                       name="gm-write", daemon=True)
            write_t.start()

        if cfg.controls > 0:
            logger.info("Creating random control guides")
            with stage_timer("controls"):
                cmin, cmed, randomdf = tl.get_control_seqs(
                    parse_fasta(fastapath), configpath=cfg.config,
                    length=cfg.guidelength, n=cfg.controls,
                    num_threads=cfg.threads, seed=cfg.seed)
            result.controls = randomdf
            result.control_min_dist = cmin
            result.control_median_dist = cmed
            if write_outputs:
                randomdf.to_csv(os.path.join(cfg.outdir, "controls.csv.gz"))
            logger.info("Created %d controls; min dist %d, median %d",
                        cfg.controls, cmin, cmed)
            logger.info("Genome GC content: %.2f%%; size %.1f MB",
                        tl.gc_percent, tl.genomesize)

        if write_t is not None:
            with stage_timer("write targets.csv.gz"):
                write_t.join()
            if write_exc:
                raise write_exc[0]

        if cfg.plot and write_outputs:
            logger.info("Creating plots")
            GuideMakerPlot(prettydf=prettydf, outdir=cfg.outdir)

        logger.info("GuideMaker completed; results in %s", cfg.outdir)
        logger.info("Guide RNA candidates found: %d", len(prettydf))
        return result
    finally:
        # exception path before a join: let the background work end before
        # the tempdir goes (the control search reads the fasta in it)
        control_t = getattr(result.processor, "_control_thread", None)
        for t in (nb_t, write_t, control_t):
            if t is not None and t.is_alive():
                t.join()
        if owns_tempdir and not cfg.keeptemp:
            shutil.rmtree(tempdir, ignore_errors=True)
