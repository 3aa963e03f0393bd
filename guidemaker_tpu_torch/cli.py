"""GuideMaker command line interface for the PyTorch/CUDA port.

Flag-for-flag the same as ``guidemaker_tpu.cli`` (names, defaults,
choices and validation).  The k-NN stages run on the CUDA card; ``--cpu``
runs them on the CPU with the kernels' plain versions, and nothing else
does.
"""
from __future__ import annotations

import argparse
import logging
import textwrap

from . import __version__, definitions
from .pipeline import PipelineConfig, run_pipeline


def myparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="guidemaker-tpu-torch",
        description=("GuideMaker (PyTorch/CUDA port): design gRNA pools in "
                     "non-model genomes and CRISPR-Cas systems"),
        # keeps the epilog's lines as written
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=textwrap.dedent("""\
            To run the web app locally, in terminal run:
            -----------------------------------------------------------------
            streamlit run """ + str(definitions.WEB_APP) + """
            -----------------------------------------------------------------"""))
    parser.add_argument('--genbank', '-i', nargs='+', type=str, required=False,
                        help='One or more genbank .gbk or gzipped .gbk files for a single genome. Provide this or GFF/GTF and fasta files')
    parser.add_argument('--fasta', '-f', nargs='+', type=str, required=False,
                        help='One or more fasta or gzipped fasta files for a single genome. If using a fasta, a GFF/GTF file must also be provided but not a genbank file.')
    parser.add_argument('--gff', '-g', nargs='+', type=str, required=False,
                        help='One or more GFF or GTF files (optionally gzipped) for a single genome. If using a GFF/GTF a fasta file must also be provided but not a genbank file.')
    parser.add_argument('--pamseq', '-p', type=str, required=True,
                        help='A short PAM motif to search for, it may use IUPAC ambiguous alphabet')
    parser.add_argument('--outdir', '-o', type=str, required=True,
                        help='The directory for data output')
    parser.add_argument('--raw_output_only', action='store_true',
                        help='if selected only the raw guide RNAs and their positions that meet lsr and dist criteria will be returned')
    parser.add_argument('--pam_orientation', '-r', choices=['5prime', '3prime'],
                        default='3prime',
                        help="The PAM position relative to the target: 5prime: [PAM][target], 3prime: [target][PAM]. For example, SpCas9 is 3prime. Default: '3prime'.")
    parser.add_argument('--guidelength', '-l', type=int, default=20,
                        choices=range(10, 28, 1), metavar="[10-27]",
                        help='Length of the guide sequence. Default: 20.')
    parser.add_argument('--lsr', type=int, default=10, choices=range(0, 28, 1),
                        metavar="[0-27]",
                        help='Length of a seed region near the PAM site required to be unique. Default: 10.')
    parser.add_argument('--dtype', type=str, choices=['hamming', 'leven'],
                        default='hamming',
                        help='Select the distance type. Default: hamming.')
    parser.add_argument('--dist', type=int, choices=range(0, 6, 1),
                        metavar="[0-5]", default=2,
                        help='Minimum edit distance from any other potential guide. Default: 2.')
    parser.add_argument('--before', type=int, default=100,
                        choices=range(1, 501, 1), metavar="[1-500]",
                        help='keep guides this far in front of a feature. Default: 100.')
    parser.add_argument('--into', type=int, default=200,
                        choices=range(1, 501, 1), metavar="[1-500]",
                        help='keep guides this far inside (past the start site) of a feature. Default: 200.')
    parser.add_argument('--knum', type=int, default=5, choices=range(2, 21, 1),
                        metavar="[2-20]",
                        help='how many sequences similar to the guide to report. Default: 5.')
    parser.add_argument('--controls', type=int, default=1000,
                        choices=range(0, 100001, 1), metavar="[0-100000]",
                        help='Number of random control RNAs to generate. Default: 1000.')
    parser.add_argument('--threads', type=int, default=2,
                        help='The number of cpu threads to use. Default: 2')
    parser.add_argument('--log', help="Log file", default="guidemaker.log")
    parser.add_argument('--tempdir', help='The temp file directory', default=None)
    parser.add_argument('--restriction_enzyme_list', nargs="*", default=[],
                        help='List of sequences representing restriction enzymes. Default: None.')
    parser.add_argument('--feature_types', nargs="*", default=None,
                        help='Feature types to annotate against (e.g. CDS gene). Default: CDS.')
    parser.add_argument('--attribute_key', type=str, default="ID",
                        help='the attribute key in column 9 of the GFF/GTF file to use for filtering. Default: ID')
    parser.add_argument('--filter_by_attribute', nargs="*", default=[],
                        help='List of locus ids. Default: None.')
    parser.add_argument('--doench_efficiency_score', action='store_true',
                        help="On-target scoring from Doench et al. 2016 - only for NGG PAM. Default: None.")
    parser.add_argument('--cfd_score', action='store_true',
                        help='CFD score for assessing off-target activity of gRNAs with NGG pam. Default: None.')
    parser.add_argument('--keeptemp', action='store_true',
                        help="Option to keep intermediate files")
    parser.add_argument('--plot', action='store_true',
                        help="Option to create GuideMaker plots")
    parser.add_argument('--config', default=str(definitions.CONFIG_PATH),
                        help="Path to YAML formatted configuration file, default is "
                             + str(definitions.CONFIG_PATH))
    parser.add_argument('--cpu', action='store_true',
                        help='Run on the CPU with the plain PyTorch versions of the kernels.')
    parser.add_argument('--seed', type=int, default=None,
                        help='Random seed for control-guide sampling '
                             '(default: unseeded, like the reference).')
    parser.add_argument('--profile', default=None, metavar='DIR',
                        help='Write a torch profiler trace of the k-NN stage to DIR.')
    parser.add_argument('-V', '--version', action='version',
                        version="%(prog)s (" + __version__ + ")")
    return parser


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    """The :class:`PipelineConfig` a parsed command line asks for."""
    return PipelineConfig(
        genbank=args.genbank, fasta=args.fasta, gff=args.gff,
        pamseq=args.pamseq, pam_orientation=args.pam_orientation,
        guidelength=args.guidelength, lsr=args.lsr, dtype=args.dtype,
        dist=args.dist, before=args.before, into=args.into, knum=args.knum,
        controls=args.controls, threads=args.threads,
        restriction_enzyme_list=args.restriction_enzyme_list,
        feature_types=args.feature_types,
        attribute_key=args.attribute_key,
        filter_by_attribute=args.filter_by_attribute,
        doench_efficiency_score=args.doench_efficiency_score,
        cfd_score=args.cfd_score, raw_output_only=args.raw_output_only,
        plot=args.plot, keeptemp=args.keeptemp, tempdir=args.tempdir,
        outdir=args.outdir, config=args.config, profile=args.profile,
        seed=args.seed, device="cpu" if args.cpu else "cuda")


def _logger_setup(logfile: str) -> logging.Logger:
    """DEBUG file + INFO console logging (reference cli.py:91-120)."""
    logger = logging.getLogger()
    logger.setLevel(logging.DEBUG)
    formatter = logging.Formatter(
        '%(asctime)s %(name)-12s %(levelname)-8s %(message)s')
    ch = logging.StreamHandler()
    ch.setLevel(logging.INFO)
    ch.setFormatter(formatter)
    fh = logging.FileHandler(logfile)
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(formatter)
    logger.addHandler(fh)
    logger.addHandler(ch)
    return logger


def main(arglist: list = None) -> None:
    """Run the GuideMaker workflow."""
    args = myparser().parse_args(arglist)
    logger = _logger_setup(args.log)
    cfg = config_from_args(args)
    try:
        cfg.validate()
    except AssertionError as err:
        logger.error(str(err))
        raise SystemExit(1)
    try:
        run_pipeline(cfg, write_outputs=True)
    except Exception:
        logger.exception(
            "GuideMaker terminated with errors. See the log file for details.")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
