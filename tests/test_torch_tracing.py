"""utils.profiling, the port's span recorder: off, annotate does nothing at
all; on (enable(), or a torch.profiler session recording), spans keep their
name, ends, parent, thread and id in a bounded buffer; and the spans the
port places: the batched step and its phases, each kernel launch and the
facade's calls."""

import threading

import numpy as np
import pytest
import torch

from gvom_tpu_torch import Gvom
from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import kernels
from gvom_tpu_torch.parallel.mesh import Mesh
from gvom_tpu_torch.parallel.sharding import make_batched_step
from gvom_tpu_torch.types import empty_world_state
from gvom_tpu_torch.utils import profiling
from gvom_tpu_torch.utils.profiling import annotate

CFG = GvomConfig(xy_size=32, z_size=16, max_points=256, buffer_size=2)
PHASES = ["step/prepare", "step/raycast", "step/moments", "step/merge", "step/maps"]


@pytest.fixture(autouse=True)
def recorder():
    profiling.enable(False)
    profiling.reset()
    yield profiling
    profiling.enable(False)
    profiling.reset()


def _raise(*a, **k):
    raise AssertionError("called while spans are off")


def _batch(seed, S=2, N=CFG.max_points):
    g = torch.Generator().manual_seed(seed)
    pts = (torch.rand((S, N, 3), generator=g) - 0.5) * torch.tensor([10.0, 10.0, 2.0])
    return pts, torch.ones((S, N), dtype=torch.bool), torch.zeros((S, 3))


def _fake_kernel(name="fake"):
    k = kernels.CudaKernel(name, "prepare.cu", "gvom_fake", [], "none")
    k._fns[()] = lambda *args: 0
    return k


def test_off_annotate_does_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "record_function", _raise)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", _raise)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", _raise)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", _raise)
    assert not profiling.recording()
    assert annotate("a") is annotate("b", 3)        # one shared object: nothing allocated
    with annotate("outer", 1):
        with annotate("inner"):
            _fake_kernel().launch(1, 2)
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_enable_nests_parents_and_ids():
    profiling.enable()
    with annotate("a", 7):
        with annotate("a/b"):
            with annotate("a/b/c", 9):
                pass
        with annotate("a/d"):
            pass
    with annotate("e"):
        pass
    s = profiling.spans()
    assert [x.name for x in s] == ["a", "a/b", "a/b/c", "a/d", "e"]
    assert [x.parent for x in s] == [-1, 0, 1, 0, -1]
    assert [x.id for x in s] == [7, 7, 9, 7, None]
    assert all(x.start_ns <= x.end_ns for x in s)
    assert s[0].start_ns <= s[1].start_ns and s[1].end_ns <= s[0].end_ns
    assert {x.thread for x in s} == {threading.get_ident()}
    profiling.enable(False)
    with annotate("off"):
        pass
    assert len(profiling.spans()) == 5


def test_a_running_cpu_profiler_turns_spans_on():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        with annotate("region", 4):
            torch.ones(3).sum()
    assert [(x.name, x.id) for x in profiling.spans()] == [("region", 4)]
    assert any(ev.name == "region" for ev in prof.events())    # still a record_function
    assert not profiling.recording()


def test_threads_keep_their_own_stacks():
    profiling.enable()
    barrier = threading.Barrier(2, timeout=10)

    def work(tag):
        for i in range(50):
            with annotate(f"{tag}/outer", i):
                barrier.wait()
                with annotate(f"{tag}/inner"):
                    barrier.wait()

    threads = [threading.Thread(target=work, args=(tag,)) for tag in ("x", "y")]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    s = profiling.spans()
    assert len(s) == 200
    for x in s:
        tag, kind = x.name.split("/")
        if kind == "outer":
            assert x.parent == -1
        else:
            p = s[x.parent]
            assert p.name == f"{tag}/outer" and p.thread == x.thread and p.id == x.id
            assert p.start_ns <= x.start_ns and x.end_ns <= p.end_ns


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    profiling.enable()
    with annotate("top"):
        for i in range(5):
            with annotate("child", i):
                pass
    assert [x.name for x in profiling.spans()] == ["top", "child", "child"]
    assert profiling.dropped() == 3
    assert profiling.spans()[0].end_ns is not None
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_a_kernel_launch_is_a_span_of_its_call():
    k = _fake_kernel("fake_kernel")
    k.launch(1)
    assert profiling.spans() == [] and k.launches == 1
    profiling.enable()
    with annotate("step", 5):
        k.launch(1)
    (step, launch) = profiling.spans()
    assert (launch.name, launch.parent, launch.id) == ("kernel/fake_kernel", 0, 5)
    assert step.start_ns <= launch.start_ns <= launch.end_ns <= step.end_ns and k.launches == 2


def _step_tree(spans):
    steps = [i for i, x in enumerate(spans) if x.name == "step"]
    return [(spans[i].id, [x.name for x in spans if x.parent == i]) for i in steps]


def test_the_batched_step_and_its_phases():
    step = make_batched_step(CFG, "cpu")
    world = empty_world_state(CFG, "cpu")
    world, _ = step(world, *_batch(0))
    profiling.enable()
    for seed in (1, 2):
        world, _ = step(world, *_batch(seed))
    assert _step_tree(profiling.spans()) == [(1, PHASES), (2, PHASES)]
    assert all(x.id in (1, 2) for x in profiling.spans())


class _TwoRanks(Mesh):
    """A (2, 1) mesh whose collectives return their input: only the spans are looked at."""

    def __init__(self):
        super().__init__((2, 1), 0, torch.device("cpu"), None, None)

    def all_reduce(self, x, op="sum", axis=None):
        return x

    def all_gather(self, x, axis=None, dim=0):
        return x

    def reduce_scatter(self, x, axis=None, dim=0):
        return x


def test_the_reduce_phase_only_on_a_mesh_of_ranks():
    step = make_batched_step(CFG, "cpu", mesh=_TwoRanks())
    profiling.enable()
    step(empty_world_state(CFG, "cpu"), *_batch(3))
    assert _step_tree(profiling.spans()) == [(0, PHASES[:3] + ["step/reduce"] + PHASES[3:])]


def test_the_facade_spans_its_calls():
    g = Gvom(config=CFG, device="cpu")
    pts = _batch(4, S=1)[0][0].numpy()
    profiling.enable()
    g.process_pointcloud(pts, np.zeros(3))
    g.process_pointcloud(pts, np.zeros(3))
    assert g.combine_maps() is not None
    s = profiling.spans()
    assert [(x.name, x.id, x.parent) for x in s] == [
        ("gvom/ingest", 0, -1), ("gvom/ingest", 1, -1), ("gvom/combine", 2, -1),
        ("gvom/combine/sync", 2, 2), ("gvom/combine/to_host", 2, 2)]
