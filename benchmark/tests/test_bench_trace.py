"""The reduction of a traced stretch, on a chrome trace made by hand."""

from __future__ import annotations

import json

import pytest

from benchmark import harness
from benchmark.trace import incomplete, reduce_trace


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


TRACE = [
    _ev("kernel", "void fill_kernel(float*)", 40, 5),                       # before the stretch
    _ev("cuda_runtime", "cudaEventRecordWithFlags", 100, 4),                # the stretch opens
    _ev("cuda_driver", "cuLaunchKernel", 106, 2),
    _ev("kernel", "void ray_pass_counts_kernel<false>(int const*, float)", 110, 50),
    _ev("kernel", "void (anonymous namespace)::fill_kernel(float*)", 160, 10),
    _ev("cuda_runtime", "cudaMemcpyAsync", 175, 20),
    _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 200, 5),
    _ev("kernel", "bin_count_kernel<false>(int*)", 200, 20),
    _ev("cuda_runtime", "cudaEventRecordWithFlags", 204, 1),
    _ev("cuda_runtime", "cudaDeviceSynchronize", 205, 25),                  # the stretch closes at 230
    _ev("cpu_op", "aten::fill_", 150, 100),
    _ev("kernel", "void fill_kernel(float*)", 300, 5),                      # after it
]


@pytest.fixture
def trace_path(tmp_path):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": TRACE + [{"ph": "M", "name": "process_name"}]}))
    return str(p)


def test_the_stretch_its_busy_time_and_its_gaps(trace_path):
    t = reduce_trace(trace_path, {"ray_pass_counts": 1, "bin_points": 1})
    assert t["window_s"] == pytest.approx(130e-6) and t["busy_s"] == pytest.approx(80e-6)
    assert t["device_ops"] == 4 and incomplete(t) == []
    assert t["groups"]["raycast"] == dict(seconds=pytest.approx(50e-6), launches=1, calls=1, complete=True)
    assert t["groups"]["binning"]["seconds"] == pytest.approx(30e-6)
    gaps = dict(t["breakdown"]["idle_gaps"])
    assert gaps == {"cudaMemcpyAsync before Memcpy HtoD": pytest.approx(30e-6),
                    "host before ray_pass_counts_kernel<false>": pytest.approx(10e-6),
                    "cudaDeviceSynchronize before the stretch's end": pytest.approx(10e-6)}
    ops = dict(t["breakdown"]["device_ops"])
    assert ops["ray_pass_counts_kernel<false>"] == pytest.approx(50e-6) and ops["fill_kernel"] == pytest.approx(10e-6)


def test_a_lost_launch_makes_its_group_incomplete(trace_path):
    t = reduce_trace(trace_path, {"ray_pass_counts": 2, "bin_points": 1})
    assert incomplete(t) == ["raycast"]


def test_a_trace_without_its_stretch_is_refused(tmp_path):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": [e for e in TRACE if e["name"] != "cudaDeviceSynchronize"]}))
    with pytest.raises(RuntimeError):
        reduce_trace(str(p), {})


@pytest.mark.parametrize("metric", ["device.idle_share.replay", "device.idle_share.live"])
def test_the_idle_share_is_the_untraced_windows(metric):
    """The traced steps' busy time a step against the untraced step's time,
    not against the traced stretch's own length, which the profiler
    stretches."""
    reader = harness._module(harness.PKG / "metrics" / f"{metric}.py", "idle_share_reader")
    rec = {"trace": {"busy_s": 12 * 0.95e-3, "window_s": 0.018, "groups": {"raycast": {"complete": True}}},
           "untraced_ms": 1.0, "traced_iters": 12}
    assert reader.read(rec) == pytest.approx(5.0)
    rec["trace"]["groups"]["raycast"]["complete"] = False
    assert reader.read(rec) is None
