"""The harness: the manifest against the contract, cells and metrics found
by name from new files alone, and `correct` false under every fault a cell
can have and under the bfloat16 control."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.control import control_in_place
from benchmark.tests.tiny import checkout_copy, tiny_spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
REPLAY, LIVE = "os1_128.replay64", "os1_128.live"


def test_manifest_names_its_files(root=harness.ROOT):
    m = harness.manifest(root)
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for c in m["configs"]:
        assert NAME.match(c["name"]) and (harness.ROOT / c["file"]).is_file()
        assert sum(w["config"] == c["name"] for w in m["workloads"]) >= 1
    e2e = {e["name"]: e for e in m["end_to_end"]}
    for w in m["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        traffic = json.loads((harness.PKG / "traffic" / f"{w['traffic']}.json").read_text())
        assert (harness.PKG / "loops" / f"{traffic['loop']}.py").is_file()
        assert (harness.PKG / "drives" / f"{traffic['drive']}.json").is_file()
        cell = json.loads((harness.PKG / "workloads" / f"{w['name']}.json").read_text())
        assert set(cell["limits"]) == {"mismatch", "moment_err"}
        reported = [x["name"] for x in harness.metrics_for(w["name"], False, root)]
        assert "setup_s" in reported and len(reported) >= 3
        for p in harness.metrics_for(w["name"], True, root):
            assert w["name"] in e2e[p["moves"]].get("workloads", [w["name"]])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and (harness.PKG / "metrics" / f"{x['name']}.py").is_file()


@pytest.fixture
def left_out_root(tmp_path):
    """A checkout whose manifest holds the left-out cells too."""
    return checkout_copy(tmp_path)


def test_the_left_out_cells_name_their_files(left_out_root):
    test_manifest_names_its_files(left_out_root)


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    copy_root = checkout_copy(tmp_path, left_out=False)
    pkg = copy_root / "benchmark"
    cell = json.loads((pkg / "workloads" / f"{REPLAY}.json").read_text())
    cell["batch"] = 2
    (pkg / "workloads" / "os1_64.replay2.json").write_text(json.dumps(cell))
    (pkg / "metrics" / "replay.steps.count.py").write_text("def read(rec):\n    return rec['steps']\n")
    m = json.loads((copy_root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "os1_64", "source": "README.md:16-19", "file": "benchmark/configs/os1_64.json",
                         "reduced": [], "why": "the Warthog's OS1-64"})
    m["workloads"].append({"name": "os1_64.replay2", "config": "os1_64", "traffic": "replay", "chips": 1,
                           "why": "a map every 2 scans"})
    m["end_to_end"][0]["workloads"].append("os1_64.replay2")
    m["end_to_end"].append({"name": "replay.steps.count", "unit": "steps", "better": "higher", "bound": 0.01,
                            "source": "host_clock", "workloads": ["os1_64.replay2"]})
    (copy_root / "BENCHMARK.json").write_text(json.dumps(m))
    spec = tiny_spec("os1_64.replay2", 3, tmp_path / "out", root=copy_root, pkg=pkg)
    assert spec.cell["batch"] == 2 and spec.config["sensor"]["model"] == "Ouster OS1-64"
    r = harness.run_cell(spec, root=copy_root, pkg=pkg)
    assert r["correct"] and r["metrics"]["replay.steps.count"]["value"] == 1   # a window of 0 s: one step
    assert set(r["metrics"]) == {"replay_scans_per_s", "device_mem_gib", "setup_s", "replay.steps.count"}


def _run(workload, seed, tmp_path):
    """A tiny run of a cell of the manifest or of the left-out ones."""
    root = checkout_copy(tmp_path)
    return harness.run_cell(tiny_spec(workload, seed, tmp_path / "out", root=root, pkg=root / "benchmark"),
                            root=root, pkg=root / "benchmark")


def test_a_sound_run_is_correct(tmp_path):
    for w in (REPLAY, LIVE):
        r = _run(w, 5, tmp_path / w)
        assert r["correct"] and r["check"]["mismatch"]["value"] == 0, r
        assert list(r)[-2:] == ["check", "_notes"]


def _replay_fault(monkeypatch, fault):
    from gvom_tpu_torch.parallel import sharding

    real = sharding.make_batched_step

    def make(cfg, device="cuda", mesh=None, ingest="auto"):
        step = real(cfg, device, mesh, ingest)

        def broken(world, scans, valid, egos):
            if fault == "half_batch":
                h = valid.shape[0] // 2
                return step(world, scans[h:], valid[h:], egos[h:])
            new, products = step(world, scans, valid, egos)
            if fault == "state_unchanged":
                return world, products
            products.positive_obstacle = products.positive_obstacle.clone()
            products.positive_obstacle[3, 5] += 1
            return new, products
        return broken

    monkeypatch.setattr(sharding, "make_batched_step", make)


def _live_fault(monkeypatch, fault):
    from gvom_tpu_torch.models import pipeline

    real = pipeline.combine

    def combine(cfg, buf, world, ego):
        new, products, ok = real(cfg, buf, world, ego)
        if fault == "state_unchanged":
            return world, products, ok
        products.roughness = products.roughness.clone()
        products.roughness[7, 2] += 0.5
        return new, products, ok

    monkeypatch.setattr(pipeline, "combine", combine)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_replay_fault_is_not_correct(monkeypatch, tmp_path, fault):
    _replay_fault(monkeypatch, fault)
    r = _run(REPLAY, 9, tmp_path)
    assert not r["correct"] and r["check"]["mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_live_fault_is_not_correct(monkeypatch, tmp_path, fault):
    _live_fault(monkeypatch, fault)
    r = _run(LIVE, 9, tmp_path)
    assert not r["correct"] and r["check"]["mismatch"]["value"] > 0


@pytest.mark.parametrize("workload", [REPLAY, LIVE])
@pytest.mark.parametrize("control,number", [("sums", "moment_err"), ("points", "mismatch")])
def test_the_bfloat16_controls_are_not_correct(tmp_path, workload, control, number):
    with control_in_place(control):
        r = _run(workload, 11, tmp_path)
    assert not r["correct"] and r["check"][number]["value"] > r["check"][number]["limit"], r["check"]


def test_the_control_restores_the_program():
    from gvom_tpu_torch.parallel import sharding

    before = sharding.make_batched_step
    with control_in_place("sums"):
        assert sharding.make_batched_step is not before
    assert sharding.make_batched_step is before


def test_a_run_that_loads_jax_prints_no_result(tmp_path):
    """The last look at the process's modules comes after the metrics'
    readers: one that loads a module named jax ends the run with no
    result."""
    copy_root = checkout_copy(tmp_path, left_out=False)
    (copy_root / "benchmark" / "metrics" / "setup_s.py").write_text(
        "import sys\nimport types\n\nsys.modules.setdefault('jax', types.ModuleType('jax'))\n\n\n"
        "def read(rec):\n    return rec['setup_s']\n")
    code = ("import sys\nfrom pathlib import Path\nfrom benchmark import harness\nfrom benchmark.tests.tiny import tiny_spec\n"
            f"root = Path({str(copy_root)!r})\nassert 'jax' not in sys.modules\n"
            f"spec = tiny_spec({REPLAY!r}, 3, Path({str(tmp_path / 'out')!r}), root=root, pkg=root / 'benchmark')\n"
            "sys.exit(harness.report(spec, root, root / 'benchmark'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(harness.ROOT)))
    assert out.returncode == 3 and out.stdout.strip() == "", out.stderr[-2000:]
    assert "jax" in out.stderr


def test_a_sound_run_prints_its_result_last(tmp_path, capsys):
    copy_root = checkout_copy(tmp_path, left_out=False)
    spec = tiny_spec(REPLAY, 4, tmp_path / "out", root=copy_root, pkg=copy_root / "benchmark")
    assert harness.report(spec, copy_root, copy_root / "benchmark") == 0
    out, err = capsys.readouterr()
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] and list(r)[-1] == "check"
    assert err.strip().splitlines()[-1].startswith("check moment_err ")
