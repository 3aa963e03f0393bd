"""The port's host layer against the JAX package on C. ruddii: PAM scan,
restriction and seed flags, the BED export and the genome readers.  Every
frame must be equal (``assert_frame_equal``, exact)."""
import os

import numpy as np
import pandas as pd
import pytest

import guidemaker_tpu as jgm
from guidemaker_tpu.io import get_fastas as jax_get_fastas
from guidemaker_tpu.io import parse_fasta as jax_parse_fasta
import guidemaker_tpu_torch as tgm
from guidemaker_tpu_torch import dna
from guidemaker_tpu_torch.io import get_fastas, parse_fasta

HERE = os.path.dirname(__file__)
FASTA = os.path.join(HERE, "test_data", "Carsonella_ruddii.fasta.gz")
GBK = os.path.join(HERE, "test_data", "Carsonella_ruddii.gbk.gz")


def _scan(pkg, parse, pam, orientation, length):
    return pkg.PamTarget(pam, orientation, "hamming").find_targets(
        parse(FASTA), length)


@pytest.mark.parametrize("pam,orientation,length", [
    ("NGG", "5prime", 20), ("NGG", "3prime", 20), ("TTTV", "5prime", 24)])
def test_find_targets_frame_equal(pam, orientation, length):
    got = _scan(tgm, parse_fasta, pam, orientation, length)
    ref = _scan(jgm, jax_parse_fasta, pam, orientation, length)
    assert len(got) > 1000
    pd.testing.assert_frame_equal(got, ref)


@pytest.mark.parametrize("enzymes,lsr", [(["NRAGCA"], 10), ([], 0),
                                         (["GAATTC", "GGATCC"], 12)])
def test_flags_and_bed_equal(enzymes, lsr):
    frames = []
    for pkg, parse, kw in ((tgm, parse_fasta, {"device": "cpu"}),
                           (jgm, jax_parse_fasta, {})):
        tl = pkg.TargetProcessor(
            targets=_scan(pkg, parse, "NGG", "5prime", 20), lsr=lsr,
            editdist=2, knum=3, **kw)
        tl.check_restriction_enzymes(enzymes)
        tl.find_unique_near_pam()
        frames.append((tl.targets, tl.export_bed()))
    (got_t, got_bed), (ref_t, ref_bed) = frames
    pd.testing.assert_frame_equal(got_t, ref_t)
    pd.testing.assert_frame_equal(got_bed, ref_bed)
    if enzymes:
        assert got_t["hasrestrictionsite"].any()


def test_genbank_to_fasta_identical(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = get_fastas([GBK], input_format="genbank",
                     tempdir=str(tmp_path / "port"))
    ref = jax_get_fastas([GBK], input_format="genbank",
                         tempdir=str(tmp_path / "jax"))
    with open(got, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_encode_pandas_matches_encode_batch():
    seqs = ["ACGTNACGTA", "TTTTGGGGCC", "acgtnNNNAC"]
    codes, arr = dna.encode_pandas(pd.Series(seqs, dtype="str"))
    np.testing.assert_array_equal(codes, dna.encode_batch(seqs, 10))
    assert arr.to_pylist() == seqs
