#!/usr/bin/env python3
"""Compare two trees of the port on one card with the port's benchmark.

Usage, from the root of the changed tree, on a machine with one H100:

    python3 tools/bench_torch_ab.py --parent DIR [--pairs N]
        [--cells NAME,...] [--out DIR]

``DIR`` holds the parent commit, unpacked (``git archive``) into a
directory that ``.gitignore`` lists.  Each of ``--pairs`` pairs runs
``bench_torch/run.py --seed S --cells ...`` once in each tree, the parent
first in even pairs and the change first in odd ones, with one seed (the
``seeds`` of ``BENCHMARK.json``, in turn).  Every run's output goes to
``--out``.  It stops at the first run that fails.  It then prints, for
each cell, every numeric metric of each side as median and quartiles,
and for the cell's end-to-end metric the pairs the change won, by the
direction that ``BENCHMARK.json`` gives it; ``summary.json`` in
``--out`` holds the same.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def order(pair: int):
    """The sides of pair ``pair`` in the order they run."""
    return ("parent", "change") if pair % 2 == 0 else ("change", "parent")


def quartiles(values):
    """(first quartile, median, third quartile) of ``values``."""
    if len(values) == 1:
        return values[0], values[0], values[0]
    q1, q2, q3 = statistics.quantiles(values, n=4, method="inclusive")
    return q1, q2, q3


def last_record(text: str):
    """The benchmark's record: the last line of its output that is JSON."""
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return None


def wins(parent, change, better: str):
    """Pairs in which the change's value beats the parent's (ties count
    for neither side)."""
    sign = 1 if better == "higher" else -1
    return sum(sign * (c - p) > 0 for p, c in zip(parent, change))


def summarise(records, benchmark):
    """{cell: {"metrics": {name: {side: [q1, median, q3, values]}},
    "headline": {...}}} from ``records``, a list of pairs, each a dict
    side -> the benchmark's record of that run."""
    out = {}
    cells = {w["name"]: w for w in benchmark["workloads"]}
    for name in records[0]["parent"]["cells"]:
        metrics = {}
        for side in ("parent", "change"):
            for rec in (pair[side] for pair in records):
                for key, value in rec["cells"][name]["metrics"].items():
                    if isinstance(value, (int, float)):
                        metrics.setdefault(key, {}).setdefault(
                            side, []).append(value)
        table = {k: {side: list(quartiles(v)) + [v]
                     for side, v in sides.items()}
                 for k, sides in metrics.items()}
        head = cells[name]["metric"]
        better = benchmark["metrics"][head]["better"]
        p, c = metrics[head]["parent"], metrics[head]["change"]
        out[name] = {"metrics": table, "headline": {
            "metric": head, "better": better, "pairs": len(p),
            "change_wins": wins(p, c, better),
            "median_ratio": statistics.median(c) / statistics.median(p),
            "parent_iqr": quartiles(p)[2] - quartiles(p)[0],
            "bound": benchmark["metrics"][head]["bound"]}}
    return out


def run_side(tree: str, seed: int, cells: str, log: str):
    cmd = [sys.executable, "bench_torch/run.py", "--seed", str(seed)]
    if cells:
        cmd += ["--cells", cells]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True)
    with open(log, "w") as fh:
        fh.write(proc.stdout)
        fh.write(proc.stderr)
    return proc.returncode, last_record(proc.stdout), time.time() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True,
                        help="the parent's tree, unpacked")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--cells", default="")
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                      "ab"))
    args = parser.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        benchmark = json.load(fh)
    seeds = benchmark["seeds"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    records = []
    for pair in range(args.pairs):
        seed = seeds[pair % len(seeds)]
        records.append({})
        for side in order(pair):
            log = os.path.join(args.out, f"{pair:02d}_{side}.log")
            rc, rec, wall = run_side(trees[side], seed, args.cells, log)
            print(f"pair {pair} seed {seed} {side}: rc {rc}, {wall:.1f} s, "
                  f"metrics {rec and rec['metrics']}", flush=True)
            if rc != 0 or rec is None or not rec["ok"]:
                print(f"{side} failed in pair {pair}; see {log}",
                      flush=True)
                return 1
            records[-1][side] = rec
    summary = summarise(records, benchmark)
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump({"nvidia_smi": smi, "cells": summary}, fh, indent=1)
    for name, cell in summary.items():
        for key, sides in sorted(cell["metrics"].items()):
            print(f"{name} {key}: " + "; ".join(
                f"{side} median {v[1]} (q1 {v[0]}, q3 {v[2]}) {v[3]}"
                for side, v in sides.items()), flush=True)
        print(f"{name} headline: {json.dumps(cell['headline'])}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
