"""Several cards and several processes.

One process drives its cards (:func:`local_devices`: every visible card,
or its block of them under torchrun) through a (q, d) mesh
(:func:`auto_mesh`); the sharded k-NN backend (``knn/sharded.py``) holds a
database shard on each card.  For several processes or hosts, call
:func:`init_distributed` in each before the first index, or start the
group yourself: the index is then sharded over every rank, and the merges
ride ``torch.distributed``'s collectives.
"""
from .mesh import auto_mesh, device_summary, init_distributed, local_devices

__all__ = ["init_distributed", "auto_mesh", "device_summary",
           "local_devices"]
