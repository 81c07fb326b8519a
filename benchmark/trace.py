"""The reduction of a traced stretch: a torch.profiler chrome trace of CUDA
activity to device busy time, each port kernel's device time and launches,
and the idle gaps by what the host was doing.

The trace holds the traced iterations only (benchmark/stretch.py): the
stretch runs from the host's first CUDA call in it (the stretch's opening
event record) to the end of its last cudaDeviceSynchronize. Device
operations are kernels, copies and fills that start inside it. An idle gap
is named by the CUDA call the host was in, where it was in one, and else
by the device operation that the host's Python was on its way to launch.
A trace can lose ctypes launches, so each port kernel's launches in the
trace are compared with its launch counter's delta over the same stretch;
a kernel group that differs is `incomplete`, and no share is read from it.
"""

from __future__ import annotations

import bisect
import json
import re
from typing import Dict, List

__all__ = ["PORT_KERNELS", "reduce_trace", "incomplete"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")

# group: (regex of its device kernels' names, regex of the one launched once a
# wrapper call, the port's launch counters (CudaKernel names) that count the calls)
PORT_KERNELS = {
    "prepare": (r"\bprepare_kernel\b", r"\bprepare_kernel\b", ("prepare_points",)),
    "raycast": (r"\bray_pass_counts_kernel\b", r"\bray_pass_counts_kernel\b",
                ("ray_pass_counts", "ray_pass_counts_slab")),
    "binning": (r"\b(fill_kernel|bin_count_kernel|bin_sums_kernel)\b", r"\bfill_kernel\b",
                ("bin_points", "bin_points_slab")),
    "epilogue": (r"\b(epilogue_kernel|box_pass|box_pass_z|epilogue_direct_kernel)\b",
                 r"\b(epilogue_kernel|epilogue_direct_kernel)\b",
                 ("ingest_epilogue", "moments_epilogue", "moments_epilogue_slab")),
    "combine": (r"\bcombine_(any_)?kernel\b", r"\bcombine_(any_)?kernel\b", ("combine",)),
    "merge": (r"\bmerge_(any_)?kernel\b", r"\bmerge_(any_)?kernel\b", ("merge_batch",)),
    "plane_fit": (r"\bplane_fit_kernel\b", r"\bplane_fit_kernel\b", ("plane_fit",)),
    "guess": (r"\bguess_(staged|global)_kernel\b", r"\bguess_(staged|global)_kernel\b", ("guess_height",)),
}


def _short(name: str) -> str:
    """A device operation's name without its return type, its namespaces'
    "(anonymous namespace)" and its argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:120]


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _gaps(intervals, t0: float, t1: float):
    gaps, cur = [], t0
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def _stretch(host) -> tuple:
    opens = [e for e in host if e["name"].startswith("cudaEventRecord")]
    syncs = [e for e in host if e["name"] == "cudaDeviceSynchronize"]
    if not opens or not syncs:
        raise RuntimeError("the trace holds no stretch: no event record or no device synchronisation")
    t0 = min(e["ts"] for e in opens)
    t1 = max(e["ts"] + e["dur"] for e in syncs)
    if t1 <= t0:
        raise RuntimeError("the trace's last device synchronisation comes before its first event record")
    return t0, t1


def reduce_trace(path: str, launch_deltas: Dict[str, int]) -> Dict:
    """The traced stretch of the chrome trace at `path`. launch_deltas: each
    port launch counter's delta over the stretch. Returns window_s, busy_s,
    the device operations (count, by name), each port kernel group's device
    seconds and launches and whether its trace is complete, and the
    breakdown (top device operations, idle gaps by host activity)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    t0, t1 = _stretch(host)
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS and t0 <= e["ts"] < t1), key=lambda e: e["ts"])
    ivals = [(e["ts"], min(e["ts"] + e["dur"], t1)) for e in dev]
    by_name: Dict[str, float] = {}
    for e in dev:
        k = _short(e["name"])
        by_name[k] = by_name.get(k, 0.0) + e["dur"] * 1e-6
    groups = {}
    for g, (all_re, one_re, counters) in PORT_KERNELS.items():
        mine = [e for e in dev if e.get("cat") == "kernel" and re.search(all_re, e["name"])]
        n_trace = sum(1 for e in mine if re.search(one_re, e["name"]))
        n_calls = sum(launch_deltas.get(c, 0) for c in counters)
        groups[g] = dict(seconds=sum(e["dur"] for e in mine) * 1e-6, launches=n_trace, calls=n_calls,
                         complete=n_trace == n_calls)
    starts = [e["ts"] for e in dev]
    gap_by: Dict[str, float] = {}
    for a, b in _gaps(ivals, t0, t1):
        mid = 0.5 * (a + b)
        cover = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        i = bisect.bisect_left(starts, b)
        nxt = dev[i] if i < len(dev) else None
        ahead = "before " + (_short(nxt["name"]) if nxt else "the stretch's end")
        key = (min(cover, key=lambda e: e["dur"])["name"] + " " if cover else "host ") + ahead
        gap_by[key[:120]] = gap_by.get(key[:120], 0.0) + (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(window_s=(t1 - t0) * 1e-6, busy_s=_union(ivals) * 1e-6, device_ops=len(dev), groups=groups,
                breakdown=dict(device_ops=top(by_name), idle_gaps=top(gap_by)))


def incomplete(summary: Dict) -> List[str]:
    return [g for g, v in summary["groups"].items() if not v["complete"]]
