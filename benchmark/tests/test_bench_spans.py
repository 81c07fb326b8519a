"""The program's spans on the trace's clock (benchmark/spans.py) and the three
readers of them, on a chrome trace and spans made by hand."""

from __future__ import annotations

import json

import pytest

from benchmark import harness
from benchmark import spans as sp
from gvom_tpu_torch.utils.profiling import Span

OFF = 5_000_000_000   # ns: a span's clock = the trace's (µs) · 1000 + OFF


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, a, b, parent=-1, id=0):
    """A span at trace times a..b µs."""
    return Span(name, int(1e3 * a) + OFF, int(1e3 * b) + OFF, parent, 1, id)


TRACE = [
    _ev("cuda_runtime", "cudaEventRecord", 100, 1),                          # the stretch opens
    _ev("cuda_runtime", "cudaLaunchKernel", 121, 8, corr=1),
    _ev("kernel", "prepare_kernel", 128, 20, corr=1),
    _ev("cuda_runtime", "cudaLaunchKernel", 152, 5, corr=2),
    _ev("kernel", "void ray_pass_counts_kernel<false>(int*)", 158, 92, corr=2),
    _ev("cuda_runtime", "cudaDeviceSynchronize", 400, 20),                   # and closes at 420
]
# one step and its phases; the device idle over the stretch [100, 420]:
# [100, 128], [148, 158] and [250, 420]
SPANS = [
    _span("step", 110, 300),
    _span("step/prepare", 115, 140, 0),
    _span("kernel/prepare_points", 120, 130, 1),     # encloses its call [121, 129]: offset in OFF + [-1, 1] µs
    _span("step/raycast", 145, 165, 0),
    _span("kernel/ray_pass_counts", 150, 160, 3),    # encloses [152, 157]: OFF + [-2, 3] µs
    _span("step", 500, 600, id=1),                   # after the stretch
]


@pytest.fixture
def trace_path(tmp_path):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": TRACE + [{"ph": "M", "name": "process_name"}]}))
    return str(p)


def test_the_fit_recovers_the_offset_and_its_width(trace_path):
    fit = sp.fit_clock(sp.load(trace_path), SPANS)
    assert fit == sp.Fit(pytest.approx(OFF), pytest.approx(2000.0), 2, "launch calls")


def test_bounds_that_do_not_meet_give_no_fit(trace_path):
    late = [s._replace(start_ns=s.start_ns - 10_000, end_ns=s.end_ns - 10_000)
            if s.name == "kernel/ray_pass_counts" else s for s in SPANS]    # [-12, -7] µs: misses [-1, 1]
    assert sp.fit_clock(sp.load(trace_path), late) is None


def test_without_launch_calls_the_device_starts_bound_it(tmp_path):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": [e for e in TRACE if e["name"] != "cudaLaunchKernel"]}))
    trace = sp.load(str(p))
    assert sp.fit_clock(trace, SPANS) is None
    fb = sp.fit_device_starts(trace, SPANS)
    assert fb == sp.Fit(pytest.approx(OFF - 8000.0), None, 2, "device starts") and fb.offset_ns <= OFF


def test_a_kernel_whose_counts_differ_is_left_out(trace_path):
    extra = SPANS + [_span("kernel/ray_pass_counts", 170, 175, 3)]
    fit = sp.fit_clock(sp.load(trace_path), extra)
    assert fit.pairs == 1 and fit.offset_ns == pytest.approx(OFF)


def test_idle_by_innermost_span(trace_path, tmp_path):
    want = {sp.OUTSIDE: 10 + 120, "step": 5 + 50, "step/prepare": 5, "kernel/prepare_points": 8,
            "step/raycast": 2, "kernel/ray_pass_counts": 8}
    assert sp.idle_by_span(trace_path, SPANS) == {k: pytest.approx(v * 1e-6) for k, v in want.items()}
    fit = sp.Fit(OFF, 0.0, 2, "launch calls")
    assert sp.idle_inside(sp.load(trace_path), SPANS[:1], fit) == pytest.approx(78e-6)
    # without launch calls, on the device starts' bound, which puts the idle 8 µs earlier on the spans
    p = tmp_path / "no_calls.json"
    p.write_text(json.dumps({"traceEvents": [e for e in TRACE if e["name"] != "cudaLaunchKernel"]}))
    want = {sp.OUTSIDE: 18 + 112, "step": 5 + 5 + 58, "step/prepare": 5, "step/raycast": 5}
    assert sp.idle_by_span(str(p), SPANS) == {k: pytest.approx(v * 1e-6) for k, v in want.items()}
    assert sp.idle_by_span(str(p), SPANS[:1]) is None         # no launch at all


def _reader(name):
    return harness._module(harness.PKG / "metrics" / f"{name}.py", f"spans_reader_{name.replace('.', '_')}")


READINGS = {"batched.host_ms.replay": 0.19, "kernels.launch_us.replay": 10.0,
            "device.idle_ms_in_step.replay": 0.078}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_the_readers(metric, trace_path, monkeypatch):
    monkeypatch.setattr(sp, "_program_spans", lambda: SPANS)
    rec = {"trace_path": trace_path, "traced_iters": 1, "notes": []}
    assert _reader(metric).read(rec) == pytest.approx(READINGS[metric])
    assert rec["notes"][0].startswith("spans: Fit(") and "1 steps in the stretch" in rec["notes"][0]
    assert _reader(metric).read(dict(rec, spans=None)) is None                 # no fit or steps
    assert _reader(metric).read({"trace_path": trace_path, "traced_iters": 2, "notes": []}) is None
    assert _reader(metric).read({"notes": []}) is None                         # an untraced run


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_a_program_without_spans_reads_nothing(metric, trace_path, monkeypatch):
    from gvom_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert _reader(metric).read({"trace_path": trace_path, "traced_iters": 1, "notes": []}) is None
