"""The logic of tools/bench_torch_ab.py, the two-tree comparison of the
port's benchmark, on synthetic records (it runs the benchmark only on a
card)."""
import importlib.util
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ab():
    spec = importlib.util.spec_from_file_location(
        "bench_torch_ab", os.path.join(ROOT, "tools", "bench_torch_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(rate, wall):
    return {"ok": True, "cells": {
        "pa-retention-d2": {"metrics": {
            "pa_genomewide_retention_pairs_per_s": rate,
            "retention_s": wall, "launches.hamming_count": 1}},
        "pa-ngg-scored-design": {"metrics": {"design_wall_s": wall * 10}}}}


def test_pairs_alternate_which_side_runs_first():
    ab = _ab()
    assert [ab.order(i) for i in range(3)] == [
        ("parent", "change"), ("change", "parent"), ("parent", "change")]


def test_last_record_is_the_last_json_line():
    ab = _ab()
    text = 'x\n{"ok": false}\nline\n{"ok": true, "n": 2}\n'
    assert ab.last_record(text) == {"ok": True, "n": 2}
    assert ab.last_record("no record\n") is None


@pytest.mark.parametrize("better,expect", [("higher", 2), ("lower", 1)])
def test_wins_follow_the_metric_direction(better, expect):
    assert _ab().wins([1, 2, 3, 4], [2, 3, 1, 4], better) == expect


def test_summary_of_synthetic_pairs():
    ab = _ab()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        benchmark = json.load(fh)
    records = [{"parent": _record(1.0 + i / 10, 0.9),
                "change": _record(2.0 + i / 10, 0.4 + i / 100)}
               for i in range(5)]
    out = ab.summarise(records, benchmark)
    ret = out["pa-retention-d2"]
    head = ret["headline"]
    assert head["metric"] == "pa_genomewide_retention_pairs_per_s"
    assert head["pairs"] == 5 and head["change_wins"] == 5
    assert head["median_ratio"] == pytest.approx(2.2 / 1.2)
    assert head["parent_iqr"] == pytest.approx(0.2)
    q1, med, q3, values = ret["metrics"]["retention_s"]["change"]
    assert (q1, med, q3) == pytest.approx((0.41, 0.42, 0.43))
    assert values == [0.4 + i / 100 for i in range(5)]
    design = out["pa-ngg-scored-design"]["headline"]
    assert design["better"] == "lower" and design["change_wins"] == 5
