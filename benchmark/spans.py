"""The program's spans on the device trace's clock.

The port records spans on the host's perf_counter_ns while a torch.profiler
session records (gvom_tpu_torch/utils/profiling.py); the trace of the same
stretch (benchmark/stretch.py) is on the profiler's clock. Each
`kernel/<name>` span [a, b] encloses its launch's CUDA call [c, d] in the
trace: the runtime or driver call whose correlation id the launched
kernel's device event carries. So the offset that takes the trace's clock
to the spans' lies in [a − c, b − d], and the fit is the intersection of
those intervals over every launch of the stretch: its midpoint the offset,
its width the alignment's error. Spans and launches are matched in order,
kernel by kernel, on the kernel each wrapper call launches once; a kernel
whose launches in the trace are not as many as its spans is left out of
the fit. Where no kernel is left, or the intervals do not meet, there is
no fit (fit_clock returns None); fit_device_starts then gives a one-sided
bound from each kernel's device start, which comes after its span opened.

The stretch and the device operations are benchmark/trace.py's: from the
first cudaEventRecord to the end of the last cudaDeviceSynchronize, the
kernels, copies and fills that start inside it.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, NamedTuple, Optional

__all__ = ["Fit", "Trace", "load", "fit_clock", "fit_device_starts", "idle_by_span", "idle_inside", "traced_steps",
           "OUTSIDE"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside the program"

# the kernel that one call of each group's wrappers launches once, and the
# port's CudaKernel names whose launches are that group's calls
ONCE_A_CALL = {
    r"\bprepare_kernel\b": ("prepare_points",),
    r"\bray_pass_counts_kernel\b": ("ray_pass_counts", "ray_pass_counts_slab"),
    r"\bfill_kernel\b": ("bin_points", "bin_points_slab"),
    r"\b(epilogue_kernel|epilogue_direct_kernel)\b": ("ingest_epilogue", "moments_epilogue",
                                                      "moments_epilogue_slab"),
    r"\bcombine_(any_)?kernel\b": ("combine",),
    r"\bmerge_(any_)?kernel\b": ("merge_batch",),
    r"\bplane_fit_kernel\b": ("plane_fit",),
    r"\bguess_(staged|global)_kernel\b": ("guess_height",),
}


class Fit(NamedTuple):
    offset_ns: float          # a span's clock = the trace's clock (ns) + offset_ns
    width_ns: Optional[float]  # the alignment's error; None for the one-sided bound
    pairs: int                # launches that bound it
    how: str                  # "launch calls" or "device starts"


class Trace(NamedTuple):
    host: List[dict]          # CUDA runtime and driver calls
    dev: List[dict]           # device operations of the stretch, by start
    t0: float                 # the stretch, in µs on the trace's clock
    t1: float


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


def _gaps(intervals, t0: float, t1: float):
    gaps, cur = [], t0
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    return gaps


def load(path) -> Trace:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    t0, t1 = _stretch(host)
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS and t0 <= e["ts"] < t1), key=lambda e: e["ts"])
    return Trace(host, dev, t0, t1)


def _corr(e) -> Optional[int]:
    return (e.get("args") or {}).get("correlation")


def _pairs(trace: Trace, spans, with_calls: bool):
    """(span, launch call or device event) of each kernel whose counts agree."""
    calls = {_corr(e): e for e in trace.host if _corr(e) is not None} if with_calls else None
    out = []
    for once, names in ONCE_A_CALL.items():
        want = {"kernel/" + n for n in names}
        mine = sorted((s for s in spans if s.name in want and s.end_ns is not None), key=lambda s: s.start_ns)
        evs = [e for e in trace.dev if e.get("cat") == "kernel" and re.search(once, e["name"])]
        if with_calls:
            evs = sorted((calls[_corr(e)] for e in evs if _corr(e) in calls), key=lambda e: e["ts"])
        if mine and len(evs) == len(mine):
            out += zip(mine, evs)
    return out


def fit_clock(trace: Trace, spans) -> Optional[Fit]:
    """The offset from the trace's clock to the spans', from every launch
    call of the stretch; None where there is none or the bounds do not meet."""
    pairs = _pairs(trace, spans, True)
    if not pairs:
        return None
    lo = max(s.start_ns - 1e3 * e["ts"] for s, e in pairs)
    hi = min(s.end_ns - 1e3 * (e["ts"] + e["dur"]) for s, e in pairs)
    if lo > hi:
        return None
    return Fit(0.5 * (lo + hi), hi - lo, len(pairs), "launch calls")


def fit_device_starts(trace: Trace, spans) -> Optional[Fit]:
    """The fallback: each launched kernel starts on the device after its
    span opened, so the offset is at least the largest a − start. A lower
    bound, tight where a kernel started at once on an idle device."""
    pairs = _pairs(trace, spans, False)
    if not pairs:
        return None
    return Fit(max(s.start_ns - 1e3 * e["ts"] for s, e in pairs), None, len(pairs), "device starts")


def _idle(trace: Trace):
    """The stretch's device idle intervals, µs on the trace's clock."""
    return _gaps([(e["ts"], min(e["ts"] + e["dur"], trace.t1)) for e in trace.dev], trace.t0, trace.t1)


def idle_by_span(trace_path, spans) -> Optional[Dict[str, float]]:
    """The stretch's device idle seconds by the innermost span the host was
    in (spans of one thread, nested), OUTSIDE where it was in none, on the
    fitted clock, or on fit_device_starts' bound where there is no fit;
    None where neither exists."""
    trace = load(trace_path)
    fit = fit_clock(trace, spans) or fit_device_starts(trace, spans)
    if fit is None:
        return None
    closed = [s for s in spans if s.end_ns is not None]
    out: Dict[str, float] = {}
    for g0, g1 in _idle(trace):
        a, b = 1e3 * g0 + fit.offset_ns, 1e3 * g1 + fit.offset_ns
        over = [s for s in closed if s.start_ns < b and s.end_ns > a]
        cuts = sorted({a, b} | {x for s in over for x in (s.start_ns, s.end_ns) if a < x < b})
        for p, q in zip(cuts, cuts[1:]):
            m = 0.5 * (p + q)
            inner = [s for s in over if s.start_ns <= m <= s.end_ns]
            key = max(inner, key=lambda s: (s.start_ns, -s.end_ns)).name if inner else OUTSIDE
            out[key] = out.get(key, 0.0) + (q - p) * 1e-9
    return out


def idle_inside(trace: Trace, spans, fit: Fit) -> float:
    """The stretch's device idle seconds that fall inside the spans (which
    do not overlap each other)."""
    total = 0.0
    for g0, g1 in _idle(trace):
        a, b = 1e3 * g0 + fit.offset_ns, 1e3 * g1 + fit.offset_ns
        total += sum(max(0.0, min(b, s.end_ns) - max(a, s.start_ns)) for s in spans) * 1e-9
    return total


def _program_spans():
    """The spans the program kept, or None where it keeps none (a port
    without the recorder)."""
    try:
        from gvom_tpu_torch.utils import profiling

        return [s for s in profiling.spans() if s.end_ns is not None]
    except (ImportError, AttributeError):
        return None


def traced_steps(rec) -> Optional[dict]:
    """The traced stretch's fit and its `step` spans, read once a run (kept
    in rec["spans"]): None where the run was not traced, the program kept
    no span, the clock does not fit, or the stretch does not hold
    rec["traced_iters"] steps on the fitted clock. The first reading adds
    a note with the fit and the stretch's idle time by innermost span."""
    if "spans" not in rec:
        rec["spans"] = None
        spans = _program_spans() if rec.get("trace_path") else None
        if spans:
            trace = load(rec["trace_path"])
            fit = fit_clock(trace, spans)
            idle = sorted((idle_by_span(rec["trace_path"], spans) or {}).items(), key=lambda kv: -kv[1])
            steps = []
            if fit is not None:
                lo, hi = 1e3 * trace.t0 + fit.offset_ns, 1e3 * trace.t1 + fit.offset_ns
                steps = [s for s in spans if s.name == "step" and lo <= s.start_ns and s.end_ns <= hi]
                if len(steps) == rec.get("traced_iters"):
                    rec["spans"] = dict(trace=trace, fit=fit, spans=spans, steps=steps)
            rec.setdefault("notes", []).append(
                f"spans: {fit or fit_device_starts(trace, spans)}; {len(steps)} steps in the stretch; device idle "
                "by innermost span (ms): " + ", ".join(f"{k} {1e3 * v:.4f}" for k, v in idle))
    return rec["spans"]
