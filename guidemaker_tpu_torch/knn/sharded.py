"""Exact k-NN with the database sharded over a (q, d) grid of devices.

The counterpart of the JAX package's ``knn/sharded.py``:

* the database splits into ``d`` contiguous row ranges, one per mesh
  column; shard ``s`` starts at global row ``s * per_shard``;
* the queries split into ``q`` contiguous blocks, one per mesh row;
* every (block, shard) pair runs the single-device wrapper of
  :mod:`.stream` (a hand-written kernel on a card, its plain version on the
  CPU) on that shard's rows, and local keys become global by adding the
  shard's offset to their index bits;
* the merge selects on packed ``(dist << 24) | idx`` keys, which are unique,
  so the answer does not depend on the mesh's shape: every shape gives the
  unsharded result bit for bit.  Counts are summed.

A device may appear more than once in a mesh: S virtual shards on one card,
or on the CPU in the tests.  A device holds one copy of a shard however
often its column names it.  Shards hold no padding rows, and a shard left
without rows (``nd < d``) launches nothing.  Every shard's kernel is
launched before any result is gathered, so that the cards of a mesh run at
once.

Several processes: when a ``torch.distributed`` process group is
initialised (:func:`..distributed.init_distributed`), rank ``r`` of ``W``
holds global shards ``r * d .. (r + 1) * d - 1`` of ``W * d``, and every
rank holds all the queries.  A rank merges its own shards, then the ranks
merge by ``all_gather`` of key lists padded to one width, and counts by
``all_reduce``, on the mesh's first device under NCCL and gloo alike
(gloo takes tensors on a card too).  A group of world size 1 goes through
the collectives too.  Every rank must make the same calls in the same
order, from one thread at a time: a call's collective is matched with the
other ranks' by its place in that order.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import stream
from .dp import banded_leven_pairs
from .features import feature_topk
from .hamming import INF_KEY, MAX_DB, MAX_K, host_lists, pack_codes

#: pads a rank's key lists to the common width of the ``all_gather``; it
#: sorts after every key and every sentinel
_PAD_KEY = torch.iinfo(torch.int32).max


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (q, d) grid of torch devices: the queries split over its rows
    (axis ``"q"``), the database over its columns (axis ``"d"``)."""
    devices: np.ndarray               # (q, d) object array of torch.device
    axis_names: Tuple[str, str] = ("q", "d")


def _device(d) -> torch.device:
    """``d`` as a torch.device; a card without an index gets the current
    one, so that equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(q_shards: int, d_shards: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (q, d) mesh over the first ``q_shards * d_shards`` of ``devices``
    (default: this process's cards, :func:`..distributed.local_devices`),
    row by row; a device may repeat."""
    if devices is None:
        from ..distributed.mesh import local_devices
        devices = local_devices()
    if q_shards < 1 or d_shards < 1:
        raise ValueError(f"mesh shape must be positive, got "
                         f"({q_shards}, {d_shards})")
    n = q_shards * d_shards
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [_device(d) for d in devices[:n]]
    return Mesh(arr.reshape(q_shards, d_shards))


def _group() -> Optional[Tuple[int, int]]:
    """(rank, world size) of the initialised process group, or None."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the initialised process group; (0, 1) without
    one."""
    return _group() or (0, 1)


def broadcast_int(value: int) -> int:
    """Rank 0's ``value`` on every rank of the initialised process group,
    by one ``broadcast`` of an int64 on the group's device (this process's
    card for NCCL, the CPU for gloo)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([value], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


@dataclass(frozen=True, eq=False)
class ShardedDb:
    """Database rows split over a mesh's columns, resident on its devices.

    ``shards[s]`` maps each distinct device of local column ``s`` to its
    copy of the shard's rows (empty for a shard without rows); ``offsets[s]``
    is the shard's first global row; ``nd`` counts the rows of every shard
    of every rank; ``length`` is the guide length of code rows."""
    mesh: Mesh
    shards: Tuple[dict, ...]
    offsets: Tuple[int, ...]
    nd: int
    length: int

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "ShardedDb":
        """The same layout with ``fn`` applied to each copy of each shard,
        on the copy's device."""
        return dataclasses.replace(self, shards=tuple(
            {dev: fn(rows) for dev, rows in part.items()}
            for part in self.shards))


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(x))


def shard_rows(rows, mesh: Mesh,
               fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
               ) -> ShardedDb:
    """Split the (nd, ...) ``rows`` (array or tensor) into the mesh's
    contiguous shards of ``ceil(nd / shards)`` rows, and put each on the
    distinct devices of its column, ``fn`` applied there."""
    rows = _as_tensor(rows)
    nd = rows.shape[0]
    if not 1 <= nd <= MAX_DB:
        raise ValueError(f"database must hold 1..{MAX_DB} rows, got {nd}")
    d_local = mesh.devices.shape[1]
    rank, world = rank_and_world()
    per_shard = -(-nd // (world * d_local))
    shards, offsets = [], []
    for s in range(d_local):
        lo = (rank * d_local + s) * per_shard
        hi = min(lo + per_shard, nd)
        part = {}
        for dev in dict.fromkeys(mesh.devices[:, s]) if lo < hi else ():
            copy = rows[lo:hi].to(dev).contiguous()
            part[dev] = fn(copy) if fn is not None else copy
        shards.append(part)
        offsets.append(lo)
    return ShardedDb(mesh=mesh, shards=tuple(shards), offsets=tuple(offsets),
                     nd=nd, length=rows.shape[1])


def prepare_db_sharded(codes, mesh: Mesh) -> ShardedDb:
    """(nd, L) uint8 guide codes -> their packed ``(n, 2)`` int64 rows
    (:func:`.hamming.pack_codes`), sharded over ``mesh``."""
    return shard_rows(codes, mesh, pack_codes)


def _sharded(db, mesh: Mesh, fn=None) -> ShardedDb:
    """``db`` if already sharded, else its rows sharded over ``mesh``."""
    return db if isinstance(db, ShardedDb) else shard_rows(db, mesh, fn)


def _blocks(nq: int, parts: int):
    """(lo, hi) of ``parts`` contiguous blocks of ``nq`` rows."""
    per = -(-nq // parts)
    return [(min(i * per, nq), min((i + 1) * per, nq)) for i in range(parts)]


def _launch(q: torch.Tensor, sdb: ShardedDb, run, prep=None):
    """Run ``run(query block, shard rows, shard)`` on every (mesh row,
    shard) pair that holds queries and rows, ``prep`` applied once to each
    query block on each device, every launch before any wait; returns, for
    each mesh row that holds queries, its query range and its results, each
    moved to the mesh's first device."""
    mesh = sdb.mesh
    dev0 = mesh.devices[0, 0]
    launched = []
    for i, (lo, hi) in enumerate(_blocks(q.shape[0],
                                         mesh.devices.shape[0])):
        if lo == hi:
            continue
        on_dev, outs = {}, []
        for s, part in enumerate(sdb.shards):
            if not part:
                continue
            dev = mesh.devices[i, s]
            if dev not in on_dev:
                block = q[lo:hi].to(dev)
                on_dev[dev] = prep(block) if prep is not None else block
            outs.append(run(on_dev[dev], part[dev], s))
        launched.append(((lo, hi), outs))
    return [(span, [t.to(dev0, non_blocking=True) for t in outs])
            for span, outs in launched]


def _merge_topk(q, sdb: ShardedDb, k_eff: int, run, prep=None
                ) -> torch.Tensor:
    """(nq, k_eff) int32 global keys, ascending, on the mesh's first
    device: the per-shard key lists of ``run(q, rows, k_eff)``, offset to
    global rows and merged by key within the rank, then across ranks."""
    q = _as_tensor(q)
    dev0 = sdb.mesh.devices[0, 0]

    def shard_keys(qb, rows, s):
        keys = run(qb, rows, k_eff)
        off = sdb.offsets[s]
        # the offset cannot carry into the distance bits: nd <= 2**24
        return torch.where(keys >= INF_KEY, keys, keys + off) if off else keys

    merged = []
    for (lo, hi), outs in _launch(q, sdb, shard_keys, prep):
        if not outs:
            merged.append(torch.empty((hi - lo, 0), dtype=torch.int32,
                                      device=dev0))
            continue
        # shards' lists differ in width where a shard holds fewer rows
        keys = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
        merged.append(torch.sort(keys, dim=1).values[:, :k_eff])
    keys = torch.cat(merged) if merged else torch.empty(
        (0, k_eff), dtype=torch.int32, device=dev0)
    group = _group()
    if group is not None:
        pad = torch.full((keys.shape[0], k_eff - keys.shape[1]), _PAD_KEY,
                         dtype=torch.int32, device=dev0)
        local = torch.cat([keys, pad], dim=1).contiguous()
        parts = [torch.empty_like(local) for _ in range(group[1])]
        dist.all_gather(parts, local)
        keys = torch.sort(torch.cat(parts, dim=1), dim=1).values[:, :k_eff]
    return keys


def _sum_counts(q, sdb: ShardedDb, run, prep=None) -> torch.Tensor:
    """(nq,) int32 sums, on the mesh's first device, of the per-shard
    counts ``run(q, rows)`` over every shard of every rank."""
    q = _as_tensor(q)
    dev0 = sdb.mesh.devices[0, 0]
    parts = []
    for (lo, hi), outs in _launch(q, sdb, lambda qb, rows, s: run(qb, rows),
                                  prep):
        total = torch.zeros(hi - lo, dtype=torch.int32, device=dev0)
        for c in outs:
            total += c
        parts.append(total)
    counts = torch.cat(parts) if parts else torch.zeros(
        0, dtype=torch.int32, device=dev0)
    if _group() is not None:
        dist.all_reduce(counts)
    return counts


def fused_sharded_topk(q_codes, sdb: ShardedDb, k: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact Hamming k-NN of the (nq, L) ``q_codes`` against a sharded
    database: host (dist, idx), each (nq, k) int32, ascending by (distance,
    index), -1 beyond ``min(k, nd, 128)`` (``KnnIndex.query``'s form)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    keys = _merge_topk(
        q_codes, sdb, min(k, sdb.nd, MAX_K),
        lambda q, rows, kk: stream.hamming_topk(q, rows, sdb.length, kk),
        pack_codes)
    return host_lists(keys, k)


def fused_sharded_count(q_codes, sdb: ShardedDb,
                        editdist: int) -> torch.Tensor:
    """(nq,) int32 counts, on the mesh's first device, of database guides
    at Hamming distance < ``editdist`` from each of the (nq, L) codes."""
    if editdist > sdb.length:
        raise ValueError("editdist must be <= guide length for counting")
    return _sum_counts(
        q_codes, sdb,
        lambda q, rows: stream.hamming_count(q, rows, sdb.length, editdist),
        pack_codes)


def sharded_leven_topk(q_codes, db_codes, k: int, *, mesh: Mesh
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact Levenshtein k-NN, database sharded over ``mesh``; host
    (dist, idx) as :func:`fused_sharded_topk`.  ``db_codes`` are (nd, L)
    codes or their :func:`prepare_db_sharded` form; ``k`` <= 128."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    sdb = _sharded(db_codes, mesh, pack_codes)
    keys = _merge_topk(
        q_codes, sdb, min(k, sdb.nd),
        lambda q, rows, kk: stream.leven_topk(q, rows, sdb.length, kk),
        pack_codes)
    return host_lists(keys, k)


def sharded_feature_count(q_rows, db_rows, n_words: int, thresh: int, *,
                          mesh: Mesh) -> torch.Tensor:
    """(nq,) int32, on the mesh's first device: database rows whose 3-gram
    feature dot with each query row exceeds ``thresh``
    (:func:`.stream.feature_count` on each shard of ``db_rows``, a tensor
    or a :class:`ShardedDb` of feature rows)."""
    return _sum_counts(
        q_rows, _sharded(db_rows, mesh),
        lambda q, rows: stream.feature_count(q, rows, n_words, thresh))


def sharded_feature_topk(q_rows, db_rows, n_words: int, k: int, *,
                         mesh: Mesh) -> torch.Tensor:
    """(nq, min(k, nd)) int32 global keys ``((n_words - dot) << 24) | idx``,
    ascending, on the mesh's first device: :func:`.features.feature_topk`
    on each shard of ``db_rows`` (as :func:`sharded_feature_count`),
    merged by key."""
    sdb = _sharded(db_rows, mesh)
    return _merge_topk(q_rows, sdb, min(k, sdb.nd),
                       lambda q, rows, kk: feature_topk(q, rows, n_words, kk))


def sharded_banded_pairs(qa, ca, *, t: int, mesh: Mesh) -> torch.Tensor:
    """(n,) int32 banded Levenshtein distances of the row pairs of the
    (n, L) codes ``qa`` and ``ca`` (:func:`.dp.banded_leven_pairs`), the
    rows split over every position of the mesh, as the JAX package splits
    them over q x d; no collectives.  On the mesh's first device."""
    qa, ca = _as_tensor(qa), _as_tensor(ca)
    devs = list(mesh.devices.flat)
    outs = [banded_leven_pairs(qa[lo:hi].to(dev), ca[lo:hi].to(dev), t)
            for dev, (lo, hi) in zip(devs, _blocks(qa.shape[0], len(devs)))
            if lo < hi]
    dev0 = mesh.devices[0, 0]
    if not outs:
        return torch.empty(0, dtype=torch.int32, device=dev0)
    return torch.cat([o.to(dev0, non_blocking=True) for o in outs])
