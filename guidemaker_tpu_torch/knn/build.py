"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` at first use and load
them with ctypes.

The sources have a plain C interface (no PyTorch headers).  Each source
is compiled by its own ``nvcc``, all started together, and one more call
links the objects into a shared library, in seconds.  The library is keyed
by a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded from ``build/guidemaker_tpu_torch/``.  Every
failure raises: a missing ``nvcc`` or a failed build never falls back to
the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..definitions import BUILD_DIR, ROOT_DIR

CSRC_DIR = os.path.join(ROOT_DIR, "csrc")
#: the kernels, and the tensor-core rate probe (``mma_rate.cu``, which only
#: chip_smoke.py calls)
SOURCES = ("hamming_count.cu", "hamming_topk.cu", "packed_count.cu",
           "packed_topk.cu", "feature_count.cu", "leven_topk.cu",
           "mma_rate.cu")
HEADERS = ("hamming_common.cuh", "mma_common.cuh", "packed_common.cuh",
           "topk_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin``."""
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME")
    if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc is not on PATH or in $CUDA_HOME/bin: the CUDA "
                       "kernels of guidemaker_tpu_torch cannot be built")


def build() -> str:
    """Compile the kernels if this version of the sources has not been
    built yet; returns the shared library's path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    lib = os.path.join(BUILD_DIR, f"libgm_hamming_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{name}.o" for name in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj,
             os.path.join(CSRC_DIR, name)]
            for name, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    runs = [(cmd, p.communicate()[0], p.returncode)
            for cmd, p in zip(cmds, procs)]
    if all(rc == 0 for _, _, rc in runs):
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        runs.append((cmd, proc.stdout, proc.returncode))
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    # ptxas -v reports registers, shared memory and spills per kernel
    with open(lib[:-3] + ".log", "w") as fh:
        for cmd, out, _ in runs:
            fh.write(" ".join(cmd) + "\n" + out)
    for cmd, out, rc in runs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed with exit code {rc} on "
                               f"{os.path.basename(cmd[-1])}:\n"
                               + out[-4000:])
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.gm_hamming_count.argtypes = [P, I, P, I, I, I, P, P]
            lib.gm_hamming_count.restype = I
            lib.gm_hamming_topk.argtypes = [P, I, P, I, I, I, I, I, P, P, P]
            lib.gm_hamming_topk.restype = I
            lib.gm_packed_count.argtypes = [P, I, P, I, I, I, I, P, P]
            lib.gm_packed_count.restype = I
            lib.gm_packed_topk.argtypes = [P, I, P, I, I, I, I, I, P, P, P]
            lib.gm_packed_topk.restype = I
            lib.gm_feature_count.argtypes = [P, I, P, I, I, I, I, P, P]
            lib.gm_feature_count.restype = I
            lib.gm_leven_topk.argtypes = [P, I, P, I, I, I, I, I, P, P, P]
            lib.gm_leven_topk.restype = I
            lib.gm_mma_rate.argtypes = [I, I, I, P, P]
            lib.gm_mma_rate.restype = I
            _lib = lib
        return _lib
