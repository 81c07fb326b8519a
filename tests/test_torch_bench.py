"""The port's bench (python -m gvom_tpu_torch.bench) and entry() on the CPU.

Each mode runs as a subprocess (the four at once) at a tiny size (32×32×16,
2,048 points, 2 steps, 1 repeat) with --device cpu and prints the JSON lines of the JAX
package's bench.py for that mode, with its keys: they are read from
bench.py's source, so that the two cannot drift apart. The perscan mode's
contract line (K = 8) is the last. --mode scaling runs its ranks over gloo
on the CPU (--devices 1,2) and prints bench.py's scaling keys, with the
backend and the device beside them; a rank count beyond the devices, ranks
over NCCL without cards, and the default device without a GPU are refused
with a non-zero exit.
entry(device="cpu")'s four maps are bitwise those of __graft_entry__.entry()'s
jitted fn on the same arguments."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from gvom_tpu_torch import bench
from gvom_tpu_torch.entry import entry

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--xy-size", "32", "--z-size", "16", "--points", "2048", "--steps", "2", "--repeats", "1",
        "--batch", "4"]
MODES = ("perscan", "combine", "async", "batched")


def _reference_keys():
    """{mode: [keys of each JSON line]} of bench.py, from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    funcs = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}

    def keys(fn, name):
        out = []
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name) and n.targets[0].id == name \
                    and isinstance(n.value, ast.Dict):
                out += [k.value for k in n.value.keys]
            elif isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Subscript) \
                    and isinstance(n.targets[0].value, ast.Name) and n.targets[0].value.id == name:
                out.append(n.targets[0].slice.value)
        return out

    base = keys(funcs["run_perscan"], "result")
    strict = [k for k in base if k not in ("combine_every", "combine_hz")]
    return {
        "perscan": [strict, base + keys(funcs["main"], "contract")],
        "combine": [keys(funcs["_run_combine"], "result")],
        "async": [keys(funcs["_run_async"], "result")],
        "batched": [keys(funcs["_run_batched"], "result")],
        "scaling": [keys(funcs["_run_scaling"], "result")],
    }


@pytest.fixture(scope="module")
def bench_runs():
    """{mode: (exit code, stdout, stderr)} of the four bench subprocesses,
    started together."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    extra = {"scaling": ["--devices", "1,2"]}
    procs = {m: subprocess.Popen([sys.executable, "-m", "gvom_tpu_torch.bench", "--mode", m, *TINY, *extra.get(m, [])],
                                 cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for m in MODES + ("scaling",)}
    out = {}
    try:
        for m, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            out[m] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("mode", MODES)
def test_bench_mode_prints_bench_py_keys(bench_runs, mode):
    rc, stdout, stderr = bench_runs[mode]
    assert rc == 0, stderr[-3000:]
    lines = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
    expected = _reference_keys()[mode]
    assert [sorted(x) for x in lines] == [sorted(k) for k in expected]
    for x in lines:
        assert x["device"] == "cpu" and x["value"] > 0 and x["steps"] == 2
        assert x.get("raycast", x.get("impl", "plain")) == "plain"
    if mode == "perscan":
        strict, contract = lines
        assert strict["metric"] == contract["metric"] + "_strict"
        assert contract["combine_every"] == 8 and contract["strict_scans_per_s"] == strict["value"]
        assert contract["metric"] == "e2e_scan+combine_throughput_1chip_2048pts_32x32x16"


def test_bench_scaling_prints_bench_py_keys(bench_runs):
    rc, stdout, stderr = bench_runs["scaling"]
    assert rc == 0, stderr[-3000:]
    lines = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1
    line = lines[0]
    assert sorted(set(line) - {"backend", "device"}) == sorted(_reference_keys()["scaling"][0])
    assert line["metric"] == "weak_scaling_efficiency_2dev_batch4perdev" and line["value"] > 0
    assert line["devices"] == [1, 2] and sorted(line["scans_per_s"]) == ["1", "2"]
    assert line["backend"] == "gloo" and line["platform"] == line["device"] == "cpu" and line["raycast"] == "plain"


def test_bench_refuses_scaling_and_a_missing_gpu(monkeypatch, capsys):
    assert bench.main(["--mode", "scaling", "--device", "cpu", "--devices", f"1,{(os.cpu_count() or 1) + 1}"]) == 2
    assert "visible device(s)" in capsys.readouterr().err
    assert bench.main(["--mode", "scaling", "--device", "cpu", "--processes", "2"]) == 2
    assert "--backend gloo" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert bench.main(["--mode", "scaling", "--devices", "1"]) == 2
    assert "exceed the 0 visible device(s)" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--steps", "1"]) == 2
    assert "device='cpu'" in capsys.readouterr().err


def test_entry_matches_graft_entry():
    fn, args = entry(device="cpu")
    jfn, jargs = __graft_entry__.entry()
    for a, b, name in zip(args[2:], jargs[2:], ("points", "valid", "ego")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    out = fn(*args)
    ref = jax.jit(jfn)(*jargs)
    assert len(out) == len(ref) == 4
    for a, b, name in zip(out, ref, ("positive", "negative", "roughness", "visibility")):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape == (64, 64), name
        assert a.tobytes() == b.tobytes(), name
    assert int(out[3].sum()) > 0 and (out[2].numpy() > -1).any()
