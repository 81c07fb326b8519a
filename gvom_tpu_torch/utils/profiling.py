"""Profiling hooks: named regions and Chrome-trace dumps (the port's
counterpart of gvom_tpu/utils/profiling.py).

Usage:
    with profile_trace("/tmp/gvom-trace"):      # one Chrome trace of CPU and CUDA
        with annotate("gvom/ingest"):
            engine.process_pointcloud(...)

`annotate` is a torch.profiler record_function, so a profile attributes
the device time of what runs inside it to the region, and an NVTX range
when CUDA is up, so Nsight tools see it too.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["annotate", "profile_trace"]


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline (a few µs outside a trace)."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the CPU and, when CUDA is up, the GPU while the block runs;
    write the Chrome trace to log_dir/trace.json on exit. Yields the
    profiler (key_averages(), events())."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
