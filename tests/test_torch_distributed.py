"""The port's process-group and mesh helpers, and the sharded backend
across processes (``torch.distributed`` with gloo, on the CPU).

Run as a script, this file is the worker of the multi-process tests:
``python tests/test_torch_distributed.py RANK PORT WORLD`` joins a group of
WORLD processes at 127.0.0.1:PORT, holds 2 virtual CPU shards of a
database sharded over all ranks, checks the top-k and the count against a
numpy oracle, and prints ``DIST OK``.  The worker imports no JAX, so
this module imports it only inside the test that compares with it.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from guidemaker_tpu_torch.distributed import (  # noqa: E402
    auto_mesh, device_summary, init_distributed)

CPU = torch.device("cpu")


def test_init_distributed_single_process_noop():
    import torch.distributed as dist
    init_distributed()      # must not raise in a single process
    init_distributed()      # idempotent
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed(num_processes=2, process_id=0)


def test_device_summary():
    s = device_summary()
    assert "device(s)" in s and "process(es)" in s
    assert s.startswith(f"{max(torch.cuda.device_count(), 1)} device(s) "
                        f"across 1 process(es)")


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_auto_mesh_shapes_match_jax(n):
    from guidemaker_tpu.distributed import auto_mesh as jax_auto_mesh
    mesh = auto_mesh(n, devices=[CPU] * 8)
    assert mesh.devices.shape == jax_auto_mesh(n).devices.shape
    assert mesh.axis_names == ("q", "d")
    assert all(d == CPU for d in mesh.devices.flat)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(world):
    port = _free_port()
    # no card: init_distributed takes gloo, as the CPU shards need
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(port),
         str(world)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    except subprocess.TimeoutExpired:
        pytest.fail("distributed worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        assert f"DIST OK world={world}" in out, out


def test_two_processes_with_gloo():
    """Two ranks of 2 virtual shards each: 4 global shards, the top-k
    merged by all_gather and the counts by all_reduce across the
    process boundary."""
    _run_workers(2)


def test_world_size_one_goes_through_the_collectives():
    """A group of one process: the same path, in a subprocess so that no
    process group outlives the test."""
    _run_workers(1)


def _worker(rank, port, world):
    import torch.distributed as dist

    from guidemaker_tpu_torch.knn import sharded
    init_distributed(f"127.0.0.1:{port}", num_processes=world,
                     process_id=rank)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == world
    calls = {"all_gather": 0, "all_reduce": 0}
    for name in calls:
        real = getattr(dist, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        setattr(dist, name, spy)
    # the database and oracle of tests/_dist_worker.py
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=(512, 20)).astype(np.uint8)
    codes[3] = codes[4]
    codes[4, 0] ^= 1
    nq, k = 64, 3
    mesh = sharded.make_mesh(1, 2, [CPU, CPU])
    sdb = sharded.prepare_db_sharded(codes, mesh)
    per_shard = -(-512 // (2 * world))
    assert sdb.offsets == (2 * rank * per_shard, (2 * rank + 1) * per_shard)
    got_d, got_i = sharded.fused_sharded_topk(codes[:nq], sdb, k)
    dm = (codes[:nq, None, :] != codes[None, :, :]).sum(2)
    keys = np.sort(dm.astype(np.int64) * (1 << 24) + np.arange(512), axis=1)
    np.testing.assert_array_equal(got_d, (keys[:, :k] >> 24).astype(np.int32))
    np.testing.assert_array_equal(got_i,
                                  (keys[:, :k] & 0xFFFFFF).astype(np.int32))
    counts = sharded.fused_sharded_count(codes[:nq], sdb, 2)
    np.testing.assert_array_equal(counts.numpy(), (dm < 2).sum(axis=1))
    # k above the database: every rank pads to one width, -1 beyond nd
    small = sharded.prepare_db_sharded(codes[:3], mesh)
    d3, _ = sharded.fused_sharded_topk(codes[:8], small, 6)
    np.testing.assert_array_equal(d3[:, :3], np.sort(dm[:8, :3], axis=1))
    assert (d3[:, 3:] == -1).all()
    assert calls == {"all_gather": 2, "all_reduce": 1}, calls
    assert "jax" not in sys.modules and "guidemaker_tpu" not in sys.modules
    dist.destroy_process_group()
    print(f"DIST OK world={world} rank={rank}", flush=True)


if __name__ == "__main__":
    _worker(*(int(a) for a in sys.argv[1:4]))
