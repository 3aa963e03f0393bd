"""Exact Hamming k-NN over guide sequences: a device-resident index, the
hand-written CUDA count and top-k kernels, and their plain versions."""
from .driver import KnnIndex, knn_search

__all__ = ["KnnIndex", "knn_search"]
