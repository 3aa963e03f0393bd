"""A design run across processes: two gloo ranks on 127.0.0.1 run the
port's ``run_pipeline`` on C. ruddii with the index sharded over both, and
every rank must return the one-process run's table and controls; and the
card each rank of a host takes.

Run as a script, this file is the worker of the two-process tests:
``python tests/test_torch_multiprocess.py RANK PORT WORLD OUTDIR SEED``
joins a gloo group of WORLD processes, checks where an index is placed
under it, records every ``all_gather``, ``all_reduce`` and ``broadcast``
with the number of collectives then in flight in the process, runs the
design (``SEED`` ``none`` for an unseeded run), and prints one line
``RESULT {json}``.  The worker imports no JAX; this module imports it only
inside the test that compares with it.
"""
import gzip
import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from guidemaker_tpu_torch.distributed import mesh as port_mesh  # noqa: E402

GBK = os.path.join(ROOT, "tests", "test_data", "Carsonella_ruddii.gbk.gz")
#: the design run of every case: GenBank, NGG, 100 controls, on the CPU
RUN = dict(genbank=[GBK], pamseq="NGG", controls=100, device="cpu")
#: each worker's limit: a hang fails the test well inside tier-1's
WORKER_TIMEOUT = 120
WORLD = 2


@pytest.mark.parametrize("local_rank,local_world,n,want", [
    (0, 2, 4, [0, 1]), (1, 2, 4, [2, 3]), (1, 2, 1, [0]), (3, 4, 8, [6, 7]),
    (None, None, 3, [0, 1, 2])],
    ids=["block-0", "block-1", "shared-card", "block-3-of-4", "unset"])
def test_local_devices(monkeypatch, local_rank, local_world, n, want):
    """A contiguous block of n // LOCAL_WORLD_SIZE cards, card LOCAL_RANK
    % n when the cards are fewer than the ranks, every card without
    torchrun's variables."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    for name, value in (("LOCAL_RANK", local_rank),
                        ("LOCAL_WORLD_SIZE", local_world)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, str(value))
    assert port_mesh.local_devices() == [torch.device("cuda", i)
                                         for i in want]


def test_meshes_take_the_local_cards(monkeypatch):
    from guidemaker_tpu_torch.knn import sharded
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    cards = [torch.device("cuda", 2), torch.device("cuda", 3)]
    assert list(port_mesh.auto_mesh().devices.flat) == cards
    assert list(sharded.make_mesh(1, 2).devices.flat) == cards


def test_init_distributed_sets_the_first_local_card(monkeypatch):
    """Before a NCCL group starts, the rank's current card is the first of
    its local cards (torch.cuda and the group start faked)."""
    dist = port_mesh.dist
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    port_mesh.init_distributed("127.0.0.1:1", num_processes=2, process_id=1)
    assert calls == [("set_device", torch.device("cuda", 2)),
                     ("nccl", dict(init_method="tcp://127.0.0.1:1",
                                   world_size=2, rank=1))]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(tmp_path, seed):
    """Each rank's RESULT record, from WORLD workers started at once, each
    given WORKER_TIMEOUT seconds from the start."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("GUIDEMAKER_TPU_KERNEL", "GUIDEMAKER_TPU_PACKED",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(port),
         str(WORLD), str(tmp_path / f"rank{rank}"), str(seed).lower()],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for rank in range(WORLD)]
    deadline = time.time() + WORKER_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.time())))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank did not finish in {WORKER_TIMEOUT} s (hang)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        line = [s for s in out.splitlines() if s.startswith("RESULT ")]
        assert len(line) == 1, out[-3000:]
        results.append(json.loads(line[0][len("RESULT "):]))
    return results


def _read_gz(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("seed", [7, None], ids=["seed-7", "unseeded"])
def test_two_process_design_run(tmp_path, monkeypatch, seed):
    """Both ranks shard the index over the group, issue the same
    collectives in the same order one at a time, and return equal
    controls; only rank 0 writes.  Seeded, rank 0's targets.csv.gz is the
    one-process run's and the JAX package's byte for byte, and the
    controls are a one-process sharded run's (the same whole-rung
    search)."""
    ranks = _run_ranks(tmp_path, seed)
    for r in ranks:
        assert r["placement"] == ["sharded", "cpu"]
        assert r["backend"] == "sharded"
        assert r["overlaps"] == 0, r["log"]
        assert r["jax_free"]
    assert ranks[0]["log"] == ranks[1]["log"]
    ops = {op for op, _ in ranks[0]["log"]}
    assert ops == {"all_reduce", "all_gather", "broadcast"}, ops
    assert ranks[0]["controls"] == ranks[1]["controls"]
    assert ranks[0]["controls"].count("\n") == 101
    assert ranks[0]["targets_sha"] == ranks[1]["targets_sha"]
    assert sorted(os.listdir(tmp_path / "rank0")) == ["controls.csv.gz",
                                                      "targets.csv.gz"]
    assert not os.path.exists(tmp_path / "rank1")
    table = _read_gz(tmp_path / "rank0" / "targets.csv.gz")
    assert hashlib.sha256(table).hexdigest() == ranks[0]["targets_sha"]
    assert table.count(b"\n") > 500
    if seed is None:
        return
    from guidemaker_tpu.pipeline import PipelineConfig as JaxPipelineConfig
    from guidemaker_tpu.pipeline import run_pipeline as jax_run_pipeline
    from guidemaker_tpu_torch.pipeline import PipelineConfig, run_pipeline
    base = dict(RUN, seed=seed)
    # the table does not depend on the controls: its references skip them
    run_pipeline(PipelineConfig(outdir=str(tmp_path / "one"),
                                **dict(base, controls=0)))
    jax_run_pipeline(JaxPipelineConfig(
        genbank=[GBK], pamseq="NGG", controls=0,
        outdir=str(tmp_path / "jax")))
    assert table == _read_gz(tmp_path / "one" / "targets.csv.gz")
    assert table == _read_gz(tmp_path / "jax" / "targets.csv.gz")
    monkeypatch.setenv("GUIDEMAKER_TPU_KERNEL", "sharded")
    one = run_pipeline(PipelineConfig(outdir=str(tmp_path / "sharded"),
                                      **base))
    assert one.processor.index.backend == "sharded"
    assert ranks[0]["controls"] == one.controls.to_csv()


def _worker(rank, port, world, outdir, seed):
    import torch.distributed as dist

    from guidemaker_tpu_torch.distributed import init_distributed
    from guidemaker_tpu_torch.knn import KnnIndex
    from guidemaker_tpu_torch.pipeline import PipelineConfig, run_pipeline
    init_distributed(f"127.0.0.1:{port}", num_processes=world,
                     process_id=rank)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == world
    seqs = ["ACGTACGTACGTACGTACGT", "ACGTACGTACGTACGTACGA",
            "TTTTACGTACGTACGTACGT"]
    placement = [KnnIndex(seqs, device="cpu").backend,
                 KnnIndex(seqs, device="cpu", backend="cpu").backend]
    log, state = [], {"in_flight": 0, "overlaps": 0}
    lock = threading.Lock()
    for name in ("all_gather", "all_reduce", "broadcast"):
        real = getattr(dist, name)

        def recorder(*a, _real=real, _name=name, **kw):
            tensor = a[1] if _name == "all_gather" else a[0]
            with lock:
                state["overlaps"] += state["in_flight"] > 0
                state["in_flight"] += 1
                log.append([_name, list(tensor.shape)])
            try:
                return _real(*a, **kw)
            finally:
                with lock:
                    state["in_flight"] -= 1
        setattr(dist, name, recorder)
    res = run_pipeline(PipelineConfig(
        outdir=outdir, seed=None if seed == "none" else int(seed), **RUN))
    targets = res.targets.to_csv(index=False).encode()
    out = dict(placement=placement, backend=res.processor.index.backend,
               log=log, overlaps=state["overlaps"],
               controls=res.controls.to_csv(),
               targets_sha=hashlib.sha256(targets).hexdigest(),
               jax_free=("jax" not in sys.modules
                         and "guidemaker_tpu" not in sys.modules))
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
            sys.argv[4], sys.argv[5])
