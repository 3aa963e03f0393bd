"""Several cards and several processes.

One process drives every visible card through a (q, d) mesh
(:func:`auto_mesh`); the sharded k-NN backend (``knn/sharded.py``) holds a
database shard on each card.  For several processes or hosts, call
:func:`init_distributed` in each before the first index: the shards then
span every rank, and the merges ride ``torch.distributed``'s collectives.
"""
from .mesh import auto_mesh, device_summary, init_distributed

__all__ = ["init_distributed", "auto_mesh", "device_summary"]
