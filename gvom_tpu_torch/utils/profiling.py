"""Profiling hooks: the port's span recorder, named regions and Chrome-trace
dumps (the port's counterpart of gvom_tpu/utils/profiling.py).

Usage:
    with profile_trace("/tmp/gvom-trace"):      # one Chrome trace of CPU and CUDA
        with annotate("gvom/ingest"):
            engine.process_pointcloud(...)

Spans are recorded while a torch.profiler session records, or after
`enable()`. Then `annotate(name)` keeps a span (its name, start and end on
`time.perf_counter_ns()`, the index of the span it runs in, its thread, and
the id of the step or call it belongs to) in a bounded buffer that
`spans()` reads, and still opens a torch.profiler record_function, so a
profile attributes the device time of what runs inside it to the region,
and an NVTX range when CUDA is up, so Nsight tools see it too. Otherwise
`annotate` costs one check and returns a shared object that does nothing:
no clock read, no NVTX range, no record_function, no allocation. Nothing
here touches the device.

The port's spans, one a layer boundary:
    step                     a batched step (parallel/sharding.py), id: its sequence number
    step/prepare, step/raycast, step/moments, step/reduce, step/merge, step/maps
                             its phases (step/reduce only on a mesh of more than one rank)
    kernel/<name>            one ctypes launch of ops/kernels.CudaKernel <name>
    gvom/ingest, gvom/combine, gvom/combine/sync, gvom/combine/to_host
                             the facade's calls (engine/gvom.py), id: the facade's call number
    gvom/export              a debug exporter's call (engine/node.py)
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["annotate", "profile_trace", "Span", "CAPACITY", "enable", "recording", "record", "spans", "dropped",
           "reset"]

CAPACITY = 1 << 16   # spans kept until reset(); later ones are counted in dropped()


class Span(NamedTuple):
    name: str
    start_ns: int          # time.perf_counter_ns()
    end_ns: Optional[int]  # None while the span is open
    parent: int            # index in spans() of the span it ran in; -1 at the top (or its parent was dropped)
    thread: int            # threading.get_ident()
    id: Optional[int]      # the step's or call's id, passed to annotate or inherited from the parent


_enabled = False
_lock = threading.Lock()
_buf: List[list] = []      # [name, start, end, parent, thread, id]
_dropped = 0
_local = threading.local()


def enable(on: bool = True) -> None:
    """Record spans whether or not a profiler records (until enable(False))."""
    global _enabled
    _enabled = bool(on)


def recording() -> bool:
    """Whether spans are recorded now: a torch.profiler session records, or
    enable() was called."""
    return _enabled or _profiler_enabled()


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _add(name: str, start: int, end: Optional[int], id: Optional[int]):
    """Append a span under the innermost open span of this thread; returns
    its record, its index (-1 where the buffer is full) and its id."""
    global _dropped
    stack = _stack()
    parent, pid = stack[-1] if stack else (-1, None)
    sid = pid if id is None else id
    rec = [name, start, end, parent, threading.get_ident(), sid]
    with _lock:
        if len(_buf) < CAPACITY:
            _buf.append(rec)
            return rec, len(_buf) - 1, sid
        _dropped += 1
    return rec, -1, sid


def record(name: str, start_ns: int, end_ns: int) -> None:
    """Keep a span whose ends the caller read (perf_counter_ns), inside the
    innermost open span of this thread. Call only while recording()."""
    _add(name, start_ns, end_ns, None)


class _Off:
    """The region while nothing records: no clock, no NVTX, no record_function."""

    __slots__ = ()

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_OFF = _Off()


class _Region:
    __slots__ = ("name", "id", "_rf", "_nvtx", "_rec")

    def __init__(self, name: str, id: Optional[int]):
        self.name = name
        self.id = id

    def __enter__(self):
        self._nvtx = torch.cuda.is_initialized()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._rf = record_function(self.name)
        self._rf.__enter__()
        self._rec, index, sid = _add(self.name, time.perf_counter_ns(), None, self.id)
        _stack().append((index, sid))
        return None

    def __exit__(self, *exc):
        self._rec[2] = time.perf_counter_ns()
        _stack().pop()
        self._rf.__exit__(*exc)
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        return False


def annotate(name: str, id: Optional[int] = None):
    """Named region: a span while recording() (module docstring), else a
    shared no-op. `id` names the step or call the region belongs to; by
    default the enclosing span's."""
    if not (_enabled or _profiler_enabled()):
        return _OFF
    return _Region(name, id)


def spans() -> List[Span]:
    """Every span kept since the last reset(), in the order they opened."""
    with _lock:
        return [Span(*r) for r in _buf]


def dropped() -> int:
    """Spans not kept since the last reset(): the buffer held CAPACITY."""
    return _dropped


def reset() -> None:
    """Forget every span kept, and the count of those dropped."""
    global _dropped
    with _lock:
        _buf.clear()
        _dropped = 0


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
