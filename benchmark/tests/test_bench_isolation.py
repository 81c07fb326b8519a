"""What a run loads: no JAX and not the JAX package (by whole top-level
names: the port's name begins with the JAX package's), and, for the
reference, nothing of the port either."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

ROOT = str(harness.ROOT)


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_either_package():
    names = _top_level("import benchmark.reference.pipeline, benchmark.roofline, benchmark.check, benchmark.scangen")
    assert not names & {"jax", "jaxlib", "flax", "gvom_tpu", "gvom_tpu_torch"}


def test_a_run_loads_the_port_and_no_jax():
    code = ("import torch\nfrom pathlib import Path\nfrom benchmark import harness\nfrom benchmark.tests.tiny import "
            "tiny_spec\nimport tempfile\nd = tempfile.mkdtemp()\n"
            "r = harness.run_cell(tiny_spec('os1_128.replay64', 1, Path(d)))\nassert r['correct']\n"
            "assert harness.forbidden_modules() == []")
    names = _top_level(code)
    assert "gvom_tpu_torch" in names and not names & set(harness.FORBIDDEN)


def test_without_a_card_it_exits_non_zero_and_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "os1_128.replay64", "--seed",
                          "4294967311", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "os1_128.replay64", "--seed", "77",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and "replay_scans_per_s" in r["metrics"]
