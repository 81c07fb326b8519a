"""The port's batched step (gvom_tpu_torch.parallel.sharding) against
gvom_tpu's make_batched_step on a mesh of one device, on the CPU: two steps
of 8 scans with a moving ego and one dead scan, so the second step merges
with a live world at a moved origin (overlap masks, the decay veto, the
batch's own evidence formula).

Bitwise: every world channel but the nine non-n moments, and every
MapProducts field (slope_x, slope_y and roughness too: the port's log and
atan2 round as XLA's CPU code does). The moments are held as torch_helpers
states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gvom_tpu.config import GvomConfig
from gvom_tpu.io import synthetic
from gvom_tpu.parallel.mesh import make_mesh
from gvom_tpu.parallel.sharding import make_batched_step as jmake_batched_step
from gvom_tpu.types import empty_world_state as jempty_world

from gvom_tpu_torch.parallel import batched_step, make_batched_step
from gvom_tpu_torch.parallel.sharding import merge_batch_plain
from gvom_tpu_torch.types import empty_world_state

from torch_helpers import assert_products_equal, assert_state_equal, convert, jax_numpy, products_numpy, t, tcfg

S = 8
STEPS = 2
DEAD = (1, 5)    # (step, scan) whose mask is all False


def batch(cfg, step):
    """[S,N,3] points, [S,N] masks, [S,3] egos of one step of the drive."""
    scans, masks, egos = [], [], []
    for i in range(S):
        k = step * S + i
        ego = np.array([0.3, -0.2, 1.5]) + k * np.array([0.15, 0.1, 0.0])
        pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego, channels=8, azimuth_steps=32,
                                            max_range=10.0, seed=k)
        pad, mask = synthetic.pad_scan(pts, cfg.max_points)
        if (step, i) == DEAD:
            mask = np.zeros_like(mask)
        scans.append(pad)
        masks.append(mask)
        egos.append(ego.astype(np.float32))
    return np.stack(scans), np.stack(masks), np.stack(egos)


@pytest.fixture(scope="module")
def drive():
    cfg = GvomConfig(xy_size=32, z_size=16, max_points=1024, buffer_size=2)
    c = tcfg(cfg)
    jstep = jmake_batched_step(cfg, make_mesh(jax.devices()[:1]), raycast_impl="xla")
    tstep = make_batched_step(c, "cpu")
    jworld, tworld = jempty_world(cfg), empty_world_state(c, "cpu")
    out = []
    for step in range(STEPS):
        scans, masks, egos = batch(cfg, step)
        before = tworld
        jworld, jprod = jstep(jworld, jnp.asarray(scans), jnp.asarray(masks), jnp.asarray(egos))
        tworld, tprod = tstep(tworld, t(scans), t(masks), t(egos))
        out.append(dict(world=(convert.logical_from_jax_numpy(jax_numpy(jworld)), convert.to_numpy(tworld)),
                        products=(products_numpy(jprod), products_numpy(tprod)),
                        jax_world=jax_numpy(jworld), before=before, inputs=(scans, masks, egos), cfg=c))
    return out


@pytest.mark.parametrize("step", range(STEPS))
def test_world_after_batched_step(drive, step):
    ref, port = drive[step]["world"]
    assert_state_equal(port, ref, f"world after batch {step}")
    assert bool(port["valid"]) and (port["hit"] > 0).sum() > 50 and (port["evidence"] > 0).any()


@pytest.mark.parametrize("step", range(STEPS))
def test_products_after_batched_step(drive, step):
    ref, port = drive[step]["products"]
    assert_products_equal(port, ref, f"batch {step}")
    assert (port["visibility"] > 0).any()


def test_second_step_merges_a_moved_live_world(drive):
    """The drive is worth its name: the origin moved between the steps and
    the second world keeps voxels that its own batch did not hit."""
    (_, w0), (_, w1) = drive[0]["world"], drive[1]["world"]
    assert not np.array_equal(w0["origin"], w1["origin"])
    c = drive[1]["cfg"]
    scans, masks, egos = drive[1]["inputs"]
    fresh, _ = batched_step(c, empty_world_state(c, "cpu"), t(scans), t(masks), t(egos), device="cpu")
    revived = (w1["hit"] > 0) & ~(fresh.grid.hit.numpy() > 0)
    assert revived.sum() > 0


def test_batched_step_from_a_jax_world(drive):
    """State carried across: the JAX world after the first batch, converted
    with from_jax_numpy, takes the second batch in the port to JAX's world."""
    c = drive[1]["cfg"]
    scans, masks, egos = drive[1]["inputs"]
    world = convert.from_jax_numpy(drive[0]["jax_world"], "cpu")
    w2, _ = make_batched_step(c, "cpu")(world, t(scans), t(masks), t(egos))
    assert_state_equal(convert.to_numpy(w2), drive[1]["world"][0], "world from a JAX world")


def test_step_leaves_its_input_world_untouched_and_checks_devices(drive):
    c = drive[1]["cfg"]
    before = drive[1]["before"]
    np.testing.assert_array_equal(convert.to_numpy(before)["hit"], drive[0]["world"][1]["hit"])
    scans, masks, egos = drive[1]["inputs"]
    with pytest.raises(ValueError, match="made for"):
        make_batched_step(c, "cpu")(before, t(scans).to("meta"), t(masks), t(egos))


def test_merge_masks_raw_moments_by_batch_occupancy(drive):
    """The batch's moments arrive raw (K5 with the mask off): the merge keeps
    them only where the batch has a hit, and the old world's only inside the
    overlap at voxels the new map keeps occupied."""
    import torch

    from gvom_tpu_torch.types import VoxelGrid

    c = drive[0]["cfg"]
    world = drive[1]["before"]
    rng = np.random.default_rng(3)
    shape = c.grid_shape
    hit = t((rng.random(shape) < 0.05).astype(np.int32))
    contrib = VoxelGrid(hit=hit, miss=t(rng.integers(0, 3, shape).astype(np.int32)),
                        min_height=t(rng.random(shape).astype(np.float32)),
                        mom=t(rng.normal(size=(10,) + shape).astype(np.float32)),
                        origin=world.grid.origin + torch.tensor([2, -1, 0], dtype=torch.int32))
    merged, evidence, occ2 = merge_batch_plain(c, world, contrib)
    assert bool(((merged.mom != 0).any(dim=0) <= occ2).all())
    assert bool((evidence[occ2] == 0).all())
    only_new = (hit > 0) & ~(world.grid.hit > 0)
    np.testing.assert_array_equal(merged.mom[:, only_new].numpy(), contrib.mom[:, only_new].numpy())


def small_batches(cfg, steps=2):
    """`steps` batches of the drive (batch()) on cfg, as tensors."""
    return [tuple(t(a) for a in batch(cfg, step)) for step in range(steps)]


def test_k5_form_is_read_from_the_mesh(small_cfg, monkeypatch):
    """The step asks K5 for targets only on one rank, where no collective
    adds into the batch's hit after K5, and for the mask off on a mesh of
    two ranks, under slab and under scatter ingest."""
    import torch

    from gvom_tpu_torch.ops import kernels
    from gvom_tpu_torch.parallel.mesh import Mesh

    c = tcfg(small_cfg)
    asked = []
    real = kernels.moments_epilogue

    def record(cfg, n, rest, hit, origin, y_window, occupancy_mask):
        asked.append(occupancy_mask)
        return real(cfg, n, rest, hit, origin, y_window, occupancy_mask)

    monkeypatch.setattr(kernels, "moments_epilogue", record)
    (scans, masks, egos), = small_batches(c, 1)
    world = empty_world_state(c, "cpu")
    make_batched_step(c, "cpu")(world, scans, masks, egos)
    for ingest in ("slab", "scatter"):
        # two ranks of a mesh made without a process group: its collectives return their input
        mesh = Mesh((2, 1), 0, torch.device("cpu"), "gloo", None)
        make_batched_step(c, "cpu", mesh=mesh, ingest=ingest)(world, scans, masks, egos)
    assert asked == ["targets", False, False]


def test_merge_reads_k5_only_at_the_batch_hits(small_cfg, monkeypatch):
    """Two one-rank steps whose K5 returns NaN at every voxel without a hit
    (what targets only leaves unspecified there) give the world and the
    products of the unpatched steps, bit for bit."""
    import torch

    from gvom_tpu_torch.ops import kernels
    from gvom_tpu_torch.utils.compare import bitwise

    c = tcfg(small_cfg)
    batches = small_batches(c)

    def run():
        step, world, out = make_batched_step(c, "cpu"), empty_world_state(c, "cpu"), []
        for b in batches:
            world, products = step(world, *b)
            out.append((world, products))
        return out

    want = run()
    real = kernels.moments_epilogue

    def nan_off_the_hits(cfg, n, rest, hit, origin, *args, **kw):
        mom = real(cfg, n, rest, hit, origin, *args, **kw)
        return torch.where(hit[None] > 0, mom, torch.full((), float("nan")))

    monkeypatch.setattr(kernels, "moments_epilogue", nan_off_the_hits)
    got = run()
    for i, ((w, p), (wg, pg)) in enumerate(zip(want, got)):
        for name in ("hit", "miss", "min_height", "mom", "origin"):
            bitwise(f"step {i} {name}", getattr(wg.grid, name), getattr(w.grid, name))
        bitwise(f"step {i} evidence", wg.evidence, w.evidence)
        for name, value in vars(p).items():
            bitwise(f"step {i} {name}", getattr(pg, name), value)
    assert int((want[-1][0].grid.hit > 0).sum()) > 50
