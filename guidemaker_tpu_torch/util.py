"""Small runtime utilities: stage timing, profiling and device checks."""
from __future__ import annotations

import contextlib
import logging
import time

import torch

logger = logging.getLogger("guidemaker_tpu_torch.timing")


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names a CUDA
    card that this process cannot use (the port never falls back to the
    CPU on its own: ``device="cpu"`` is the only way there)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' (--cpu) to run the plain versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@contextlib.contextmanager
def stage_timer(name: str):
    """Log the wall-clock (and process CPU) duration of a pipeline stage."""
    t0 = time.time()
    c0 = time.process_time()
    try:
        yield
    finally:
        logger.info("[stage] %-28s %8.3f s  (cpu %.3f s)",
                    name, time.time() - t0, time.process_time() - c0)


@contextlib.contextmanager
def substage_timer(name: str, device: torch.device = None):
    """Like :func:`stage_timer` but tagged ``[sub]``: fine-grained timings
    inside a stage, kept out of the ``[stage]`` table.  Given a CUDA
    ``device``, the block's work on it is waited for before the clock is
    read, so the time is the device's too."""
    t0 = time.time()
    try:
        yield
    finally:
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        logger.info("[sub] %-32s %8.3f s", name, time.time() - t0)


@contextlib.contextmanager
def maybe_profile(trace_dir: str = None):
    """Wrap a block in a ``torch.profiler`` trace (CPU and, when a card is
    present, CUDA activity) written as a Chrome trace into ``trace_dir``."""
    if not trace_dir:
        yield
        return
    import os
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("torch profiler trace written to %s", path)
