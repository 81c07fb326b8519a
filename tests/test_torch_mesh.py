"""The port's (data, space) mesh over torch.distributed on the CPU (gloo).

One 4-rank run (tests/torch_dist_worker.py, a process per rank, started by a
module-scoped fixture) does the batched step at 32×32×16 with 8 scans a step
for two steps on the meshes (2, 2) slab, (1, 4) slab, (4, 1) slab and (2, 2)
scatter, a sharded save → load → next step, and batched_replay(mesh=) of 10
scans in batches of 8. Meanwhile this process runs the references: the
port's one-device step and replay, and the JAX package's make_batched_step
on the same mesh shapes over the virtual CPU devices.

Each mesh result against the port's one-device step: every MapProducts field
and hit, miss, min_height and evidence bitwise; the moments n bitwise and
the nine others within MOM_RTOL / MOM_ATOL (the data ranks' sums add in
another order). Against the JAX package on the same mesh: the integer
channels bitwise, min_height and the products within the tolerances of
tests/test_multidevice.py. Also: slab and scatter ingest agree, the slab's
world bytes are 1/space of the world's (tests/test_slab_memory.py's point,
counted by tensor sizes), the slab arguments of overlap_mask and height_map
against the JAX package's on four slabs, factor_devices, the backend rule,
the shape checks, and dryrun_multichip(4, device="cpu")."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvom_tpu.config import GvomConfig
from gvom_tpu.ops import grid as jgrid
from gvom_tpu.ops import maps2d as jmaps2d
from gvom_tpu.parallel.mesh import factor_devices as jfactor_devices
from gvom_tpu.parallel.mesh import make_mesh as jmake_mesh
from gvom_tpu.parallel.sharding import make_batched_step as jmake_batched_step
from gvom_tpu.types import empty_world_state as jempty_world
from gvom_tpu.utils.parity import singular_fit_mask

import torch_dist_worker as W
from gvom_tpu_torch.engine.replay import batched_replay
from gvom_tpu_torch.entry import dryrun_multichip
from gvom_tpu_torch.ops import grid as tgrid
from gvom_tpu_torch.ops import maps2d as tmaps2d
from gvom_tpu_torch.parallel import make_batched_step, shard_batch
from gvom_tpu_torch.parallel.mesh import Mesh, factor_devices, init_distributed, make_mesh, resolve_backend, run_ranks
from gvom_tpu_torch.types import empty_world_state
from gvom_tpu_torch.utils.checkpoint import load_world

from torch_helpers import assert_products_equal, assert_state_equal, convert, jax_numpy, products_numpy, t, tcfg

_HERE = os.path.dirname(os.path.abspath(__file__))
CASES = [(name, step) for name, _, _ in W.MESHES for step in range(W.STEPS)]
SPACE = {name: space for name, space, _ in W.MESHES}
WORLD_KEYS = ("hit", "miss", "min_height", "mom", "origin", "evidence", "valid")


def _jax_runs(cfg, batches):
    """{mesh name: [(world, products) after each step]} of the JAX package's
    sharded step on the same mesh shape over 4 virtual CPU devices. Each
    step function is compiled once, ahead of time, all four in threads."""
    w0 = jempty_world(cfg)
    lowered = {name: jmake_batched_step(cfg, jmake_mesh(jax.devices()[:4], space=space), raycast_impl="xla",
                                        ingest=ingest).lower(w0, *batches[0])
               for name, space, ingest in W.MESHES}
    with ThreadPoolExecutor(len(lowered)) as ex:
        compiled = dict(zip(lowered, ex.map(lambda lw: lw.compile(), lowered.values())))
    out = {}
    for name, fn in compiled.items():
        w, runs = w0, []
        for b in batches:
            w, p = fn(w, *b)
            runs.append((convert.logical_from_jax_numpy(jax_numpy(w)), products_numpy(p)))
        out[name] = runs
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    (d / "replay").mkdir()
    out = d / "out.npz"
    jcfg = GvomConfig(**W.CFG)
    cfg = tcfg(jcfg)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(run_ranks, [sys.executable, os.path.join(_HERE, "torch_dist_worker.py"), str(out), str(d)],
                          4, 240, env=env, cwd=_HERE)
        batches = [W.batch(cfg, s) for s in range(W.STEPS)]
        step, world, port = make_batched_step(cfg, "cpu"), empty_world_state(cfg, "cpu"), []
        for b in batches:
            world, p = step(world, *(t(a) for a in b))
            port.append((convert.to_numpy(world), products_numpy(p)))
        rworld, rprods, rmet = batched_replay(cfg, W.replay_log(), W.REPLAY_BATCH, device="cpu")
        replay = (convert.to_numpy(rworld), products_numpy(rprods[-1]), rmet.snapshot()["counters"])
        jax_runs = _jax_runs(jcfg, [tuple(jnp.asarray(a) for a in b) for b in batches])
        ranks.result()
    with np.load(out) as z:
        res = {k: z[k] for k in z.files}
    return dict(res=res, port=port, replay=replay, jax=jax_runs, dir=d, cfg=cfg, jcfg=jcfg)


def mesh_world(res, key):
    return {k: res[f"{key}/world/{k}"] for k in WORLD_KEYS}


def mesh_products(res, key):
    return {k: res[f"{key}/products/{k}"] for k in W.PRODUCT_FIELDS}


@pytest.mark.parametrize("name,step", CASES)
def test_mesh_world_matches_one_device_step(mesh_run, name, step):
    got = mesh_world(mesh_run["res"], f"{name}/{step}")
    assert_state_equal(got, mesh_run["port"][step][0], f"{name} after step {step}")
    assert bool(got["valid"]) and (got["hit"] > 0).sum() > 50 and (got["evidence"] > 0).any()


@pytest.mark.parametrize("name,step", CASES)
def test_mesh_products_match_one_device_step(mesh_run, name, step):
    assert_products_equal(mesh_products(mesh_run["res"], f"{name}/{step}"), mesh_run["port"][step][1],
                          f"{name} step {step}")


@pytest.mark.parametrize("name,step", CASES)
def test_mesh_world_matches_jax_mesh(mesh_run, name, step):
    """The integer channels bitwise; min_height and the moments as
    tests/test_multidevice.py holds JAX's own meshes."""
    got = mesh_world(mesh_run["res"], f"{name}/{step}")
    ref = mesh_run["jax"][name][step][0]
    for k in ("hit", "miss", "evidence", "origin", "valid"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{name} step {step}: {k}")
    np.testing.assert_allclose(got["min_height"], ref["min_height"], atol=1e-6)
    np.testing.assert_array_equal(got["mom"][0], ref["mom"][0])
    np.testing.assert_allclose(got["mom"], ref["mom"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,step", CASES)
def test_mesh_products_match_jax_mesh(mesh_run, name, step):
    """tests/test_multidevice.py's tolerances between meshes: visibility and
    negative obstacles exact, heights to 1e-5, the slope-derived layers
    outside singular plane fits, at most 1 % of cells apart."""
    got = mesh_products(mesh_run["res"], f"{name}/{step}")
    ref = mesh_run["jax"][name][step][1]
    for k in ("origin", "visibility", "negative_obstacle"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("height", "inferred_height", "guessed_height_delta"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5, err_msg=k)
    ok = ~singular_fit_mask(ref["height"], mesh_run["jcfg"].xy_resolution)
    np.testing.assert_array_equal(got["positive_obstacle"][ok], ref["positive_obstacle"][ok])
    for k in ("slope_x", "slope_y", "roughness"):
        a, b = got[k][ok], ref[k][ok]
        if k == "roughness":
            a, b = (np.maximum(x, mesh_run["jcfg"].min_roughness) for x in (a, b))
        assert (np.abs(a - b) > 1e-4 + 1e-4 * np.abs(b)).mean() <= 0.01, k


@pytest.mark.parametrize("step", range(W.STEPS))
def test_ingest_strategies_agree(mesh_run, step):
    """Slab and scatter ingest on the (2, 2) mesh: the same worlds and
    products (the moments to rounding: their sums add in another order)."""
    res = mesh_run["res"]
    assert_state_equal(mesh_world(res, f"2x2_slab/{step}"), mesh_world(res, f"2x2_scatter/{step}"), "slab vs scatter")
    assert_products_equal(mesh_products(res, f"2x2_slab/{step}"), mesh_products(res, f"2x2_scatter/{step}"))


@pytest.mark.parametrize("name", [name for name, _, _ in W.MESHES])
def test_slab_world_bytes(mesh_run, name):
    """A rank holds 1/space of the world: the slab ingest's point
    (tests/test_slab_memory.py), here by tensor sizes. On the CPU gloo
    copies nothing through a host."""
    full = sum(v.nbytes for k, v in mesh_world(mesh_run["res"], f"{name}/0").items()
               if k in ("hit", "miss", "min_height", "mom", "evidence"))
    assert int(mesh_run["res"][f"{name}/slab_bytes"][0]) * SPACE[name] == full
    assert int(mesh_run["res"][f"{name}/host_bytes"][0]) == 0


def test_sharded_checkpoint_resume(mesh_run):
    """Save the (2, 2) mesh's world slabs after step 0, load them, step on:
    bitwise the uninterrupted run; the file is the logical world, which the
    JAX package loads."""
    from gvom_tpu.utils.checkpoint import load_world as jload_world

    res = mesh_run["res"]
    assert bool(res["resume/loaded_equal"][0])
    for k, v in mesh_world(res, "2x2_slab/1").items():
        np.testing.assert_array_equal(res[f"resume/1/world/{k}"], v, err_msg=k)
    for k, v in mesh_products(res, "2x2_slab/1").items():
        np.testing.assert_array_equal(res[f"resume/1/products/{k}"], v, err_msg=k)
    path = str(mesh_run["dir"] / "mesh_world.npz")
    saved = convert.logical_from_jax_numpy(jax_numpy(jload_world(path)))
    for k, v in mesh_world(res, "2x2_slab/0").items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)
    port = convert.to_numpy(load_world(path, "cpu"))
    for k, v in saved.items():
        np.testing.assert_array_equal(port[k], v, err_msg=k)


def test_batched_replay_on_a_mesh(mesh_run):
    """10 scans in batches of 8 on the (2, 2) mesh: the final batch of 2 is
    padded to 4 with dead scans, the scans counted are the 10 real ones, the
    world and products those of the one-device replay, and the last
    checkpoint holds the final world."""
    res = mesh_run["res"]
    world, products, counters = mesh_run["replay"]
    assert int(res["replay/scans"][0]) == counters["scans"] == W.REPLAY_SCANS
    assert int(res["replay/batches"][0]) == int(res["replay/products"][0]) == 2
    assert int(res["replay/checkpoints"][0]) == 2
    got = mesh_world(res, "replay/last")
    assert_state_equal(got, world, "replay on a mesh")
    assert_products_equal(mesh_products(res, "replay/last"), products, "replay on a mesh")
    saved = convert.to_numpy(load_world(str(mesh_run["dir"] / "replay" / "world_b2.npz"), "cpu"))
    for k in WORLD_KEYS:
        np.testing.assert_array_equal(saved[k], got[k], err_msg=k)


def _slab_inputs(cfg, seed=3):
    """A seeded occupancy, min_height, two origins and an ego."""
    rng = np.random.default_rng(seed)
    occ = rng.random(cfg.grid_shape) < 0.05
    minh = rng.random(cfg.grid_shape).astype(np.float32)
    o_t = np.array([5, -7, 2], np.int32)
    o_s = np.array([3, -4, 1], np.int32)
    ego = np.array([2.3, -1.9, 1.55], np.float32)
    return occ, minh, o_t, o_s, ego


@pytest.mark.parametrize("k", range(4))
def test_overlap_mask_coords_on_a_slab(k):
    cfg = GvomConfig(**W.CFG)
    c = tcfg(cfg)
    _, _, o_t, o_s, _ = _slab_inputs(cfg)
    Ys = cfg.xy_size // 4
    coords = tuple(np.arange(n, dtype=np.int32) for n in cfg.grid_shape)
    coords = (coords[0], coords[1][k * Ys:(k + 1) * Ys], coords[2])
    ref = jax.jit(lambda a, b, cs: jgrid.overlap_mask(cfg, a, b, coords=cs))(o_t, o_s, coords)
    got = tgrid.overlap_mask(c, t(o_t), t(o_s), coords=tuple(t(x) for x in coords))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    full = tgrid.overlap_mask(c, t(o_t), t(o_s))
    np.testing.assert_array_equal(got.numpy(), full.numpy()[:, k * Ys:(k + 1) * Ys])


@pytest.mark.parametrize("k", range(4))
def test_height_map_y_coords_on_a_slab(k):
    cfg = GvomConfig(**W.CFG)
    c = tcfg(cfg)
    occ, minh, o_t, _, ego = _slab_inputs(cfg)
    Ys = cfg.xy_size // 4
    rows = slice(k * Ys, (k + 1) * Ys)
    ys = np.arange(k * Ys, (k + 1) * Ys, dtype=np.int32)
    ref = jax.jit(lambda o, m, org, e, y: jmaps2d.height_map(cfg, jgrid.pack_yz(o), jgrid.pack_yz(m), org, e,
                                                              y_coords=y))(occ[:, rows], minh[:, rows], o_t, ego, ys)
    got = tmaps2d.height_map(c, t(occ[:, rows]), t(minh[:, rows]), t(o_t), t(ego), y_coords=t(ys))
    assert got.numpy().tobytes() == np.asarray(ref).tobytes()
    full = tmaps2d.height_map(c, t(occ), t(minh), t(o_t), t(ego))
    assert got.numpy().tobytes() == full.numpy()[:, rows].tobytes()


@pytest.mark.parametrize("n", (1, 2, 4, 8, 16))
def test_factor_devices(n):
    assert factor_devices(n) == jfactor_devices(n)
    for space in (1, 2, 3, 4, 8):
        if n % space == 0:
            assert factor_devices(n, space) == jfactor_devices(n, space) == (n // space, space)
        else:
            with pytest.raises(ValueError):
                factor_devices(n, space)
            with pytest.raises(ValueError):
                jfactor_devices(n, space)


def test_backend_rule():
    """NCCL needs a card a rank: with none here, the default and an explicit
    NCCL raise and name gloo; gloo on cards is explicit; the CPU takes gloo.
    No backend or device is ever swapped in."""
    assert torch.cuda.device_count() == 0
    for backend in (None, "nccl"):
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            resolve_backend(4, "cuda", backend)
    assert resolve_backend(4, "cuda", "gloo") == "gloo"
    assert resolve_backend(4, "cpu") == "gloo"
    with pytest.raises(ValueError):
        resolve_backend(4, "cpu", "nccl")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        init_distributed("localhost:1", 4, 0)
    assert init_distributed(None, 1, 0) is None
    one = make_mesh(device="cpu")
    assert one.shape == (1, 1) and one.size == 1 and one.backend is None


def test_bad_shapes_raise_before_any_collective():
    """A grid that the space axis does not divide and a batch that the
    ranks do not split raise on the rank, before a collective could wait."""
    cfg = tcfg(GvomConfig(**W.CFG))
    with pytest.raises(ValueError, match="not divisible by space"):
        make_batched_step(cfg, "cpu", mesh=Mesh((1, 3), 0, torch.device("cpu"), "gloo", None))
    with pytest.raises(ValueError):
        make_batched_step(cfg, "cpu", mesh=Mesh((2, 2), 0, torch.device("cpu"), "gloo", None), ingest="rows")
    mesh = Mesh((2, 2), 3, torch.device("cpu"), "gloo", None)
    scans, valid, egos = torch.zeros(6, 4, 3), torch.ones(6, 4, dtype=torch.bool), torch.zeros(6, 3)
    assert shard_batch(scans, valid, egos, mesh)[0].shape[0] == 3
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(scans, valid, egos, mesh, ingest="scatter")


def test_dryrun_multichip_on_cpu():
    line = dryrun_multichip(4, device="cpu", timeout=240)
    assert line.startswith("dryrun_multichip ok: meshes (data, space) (2, 2) and (1, 4) over gloo on cpu")
