"""K2 (csrc/binning.cu) on the card, on the benchmark lap's 64-scan batches:
on a binning.MomentScratch kept across calls (the batched step's, the ring
buffer's) against the plain twin, hit, min_height and n bit for bit and the
nine sums within the batch tolerance; the scratch's contract after each
call (channels 1-9 zero where n is 0, the touched bytes 1 where n > 0) and
after calls over other scans (what a fresh scratch gives); the epilogues
(K3, K5) on its n and channels 1-9 against their plain twins; and two
batched steps on one step's scratch, and a ring buffer's ingest after
others, against fresh ones.

Every test needs a CUDA card: it takes the `lap` fixture, which skips
without one. The file imports no JAX (the card's machine has none); on
the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_binning_card.py
"""

import json
from pathlib import Path

import pytest
import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import binning, kernels, moments
from gvom_tpu_torch.utils.compare import bitwise, close, moments_close, sums_close

pytestmark = pytest.mark.card

ROOT = Path(__file__).resolve().parent.parent
BATCHES = (64, 320)          # the first scans of two of the lap's 64-scan batches
LAP_SEED = 3_000_000_019      # the run's seed: the range noise
# the nine sums of a batch (chip_smoke.MOM_ATOL_BATCH): f32 adds in another
# order, up to thousands of terms a voxel near the egos
ATOL_BATCH = 1e-2


@pytest.fixture(scope="module")
def lap():
    """(cfg, made): the benchmark's lap (benchmark/scangen.make_lap) on the
    card, with the ray budget of its 64-scan batches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import scangen
    from gvom_tpu_torch.engine.replay import batched_ray_steps

    dev = torch.device("cuda", 0)
    conf = json.loads((ROOT / "benchmark/configs/os1_128.json").read_text())
    drive = json.loads((ROOT / "benchmark/drives/lap.json").read_text())
    made = scangen.make_lap(conf["sensor"], drive, conf["gvom"]["ground_to_lidar_height"], LAP_SEED, dev)
    cfg = GvomConfig.from_dict(conf["gvom"])
    cfg = cfg.replace(ray_steps_override=batched_ray_steps(cfg, made["egos"].cpu().numpy(), 64))
    return cfg, made


def raw(made, b0):
    b = slice(b0, b0 + 64)
    return made["points"][b].contiguous(), made["valid"][b].contiguous(), made["egos"][b].contiguous()


def prepared(cfg, made, b0):
    """The batch's flat world points, keep and origin, as the batched step
    prepares them (the frame of its last scan, dead scans dropped)."""
    pts, valid, egos = raw(made, b0)
    p, keep, origin, _ = kernels.prepare_points(cfg, pts, valid, egos, frame_ego=egos[-1].contiguous(),
                                                drop_dead=True)
    return p.view(-1, 3), keep.view(-1), origin


def check_contract(what, bins, scratch):
    live = bins.n[0].reshape(-1) > 0
    rest = scratch.rest.view(9, -1)
    assert bins.rest is scratch.rest
    assert int((rest[:, ~live] != 0).sum()) == 0, f"{what}: channels 1-9 set where n is 0"
    bitwise(f"{what} touched", scratch.touched.view(-1), live.to(torch.uint8))
    return live


@pytest.mark.parametrize("y_window", [None, (64, 64)])
def test_kept_scratch_against_plain(lap, y_window):
    """Each batch in turn on one scratch, one launch a call: hit,
    min_height and n bitwise those of the plain twin, the nine sums within
    the batch tolerance where n > 0, and the scratch's contract after the
    call."""
    cfg, made = lap
    scratch = binning.moment_scratch(cfg, "cuda", y_window)
    for b0 in BATCHES + BATCHES[:1]:
        p, keep, origin = prepared(cfg, made, b0)
        launches = (kernels.BIN_SLAB if y_window else kernels.BIN).launches
        got = kernels.bin_points(cfg, p, keep, origin, y_window, scratch=scratch)
        assert (kernels.BIN_SLAB if y_window else kernels.BIN).launches == launches + 1
        plain = binning.bin_points(cfg, p, keep, origin, y_window)
        bitwise("hit", got.hit, plain.hit)
        bitwise("min_height", got.min_height, plain.min_height)
        bitwise("n", got.n, plain.n)
        sums_close("sums", got.sums, plain.sums, ATOL_BATCH)
        live = check_contract(f"batch {b0}", got, scratch)
        assert int(live.sum()) > 10_000


def test_scratch_after_other_scans_equals_a_fresh_one(lap):
    """A scratch that binned another batch gives what a fresh scratch gives
    on this one: n and the touched bytes bitwise, the nine sums within the
    batch tolerance, zero where n is 0 in both."""
    cfg, made = lap
    used = binning.moment_scratch(cfg, "cuda")
    kernels.bin_points(cfg, *prepared(cfg, made, BATCHES[1]), scratch=used)
    p, keep, origin = prepared(cfg, made, BATCHES[0])
    a = kernels.bin_points(cfg, p, keep, origin, scratch=used)
    fresh = binning.moment_scratch(cfg, "cuda")
    b = kernels.bin_points(cfg, p, keep, origin, scratch=fresh)
    bitwise("n", a.n, b.n)
    bitwise("touched", used.touched, fresh.touched)
    live = check_contract("used", a, used)
    check_contract("fresh", b, fresh)
    close("sums", used.rest.view(9, -1)[:, live], fresh.rest.view(9, -1)[:, live], ATOL_BATCH)


@pytest.mark.parametrize("mask", [False, True])
def test_epilogues_against_plain(lap, mask):
    """K5 on a kept scratch's n and channels 1-9 against its plain twin on
    the same sums: n bitwise, the nine sums within the batch tolerance;
    with the mask on, K3 into a ring-buffer slot the same."""
    cfg, made = lap
    scratch = binning.moment_scratch(cfg, "cuda")
    kernels.bin_points(cfg, *prepared(cfg, made, BATCHES[1]), scratch=scratch)
    p, keep, origin = prepared(cfg, made, BATCHES[0])
    bins = kernels.bin_points(cfg, p, keep, origin, scratch=scratch)
    got = kernels.moments_epilogue(cfg, bins.n, bins.rest, bins.hit, origin, occupancy_mask=mask)
    moments_close("K5", got, moments.moments_epilogue_plain(cfg, bins.n, bins.rest, bins.hit, origin,
                                                            occupancy_mask=mask), ATOL_BATCH)
    if mask:
        out = torch.zeros((2, 10) + cfg.grid_shape, device="cuda")
        slot = torch.ones((1,), dtype=torch.int32, device="cuda")
        kernels.ingest_epilogue(cfg, bins.n, bins.rest, bins.hit, origin, out, slot)
        bitwise("K3 slot vs K5", out[1], got)


def test_batched_steps_on_one_scratch_equal_a_fresh_step(lap):
    """Two steps of one step (its scratch kept), from the first step's
    world: the second's world and products equal a fresh step's on the
    same input, every channel but the nine sums bitwise, those within the
    batch tolerance."""
    from gvom_tpu_torch.parallel import make_batched_step
    from gvom_tpu_torch.types import empty_world_state

    cfg, made = lap
    step = make_batched_step(cfg, "cuda")
    launches = kernels.BIN.launches
    world, _ = step(empty_world_state(cfg, "cuda"), *raw(made, BATCHES[1]))
    used, used_products = step(world, *raw(made, BATCHES[0]))
    fresh, fresh_products = make_batched_step(cfg, "cuda")(world, *raw(made, BATCHES[0]))
    assert kernels.BIN.launches == launches + 3
    for name in ("hit", "miss", "min_height", "origin"):
        bitwise(name, getattr(used.grid, name), getattr(fresh.grid, name))
    bitwise("evidence", used.evidence, fresh.evidence)
    bitwise("moment n", used.grid.mom[0], fresh.grid.mom[0])
    close("moments", used.grid.mom, fresh.grid.mom, ATOL_BATCH)
    for name, value in vars(used_products).items():
        bitwise(name, value, getattr(fresh_products, name))


def test_ring_buffer_ingest_after_others_equals_a_fresh_one(lap):
    """A lap scan ingested into a ring buffer whose scratch binned two other
    scans first writes the slot that a fresh buffer's first ingest writes:
    hit, min_height, the pass counts and n bitwise, the nine sums within
    the batch tolerance."""
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.types import empty_buffer_state

    cfg, made = lap
    used, fresh = empty_buffer_state(cfg, "cuda"), empty_buffer_state(cfg, "cuda")
    for s in (BATCHES[1], BATCHES[1] + 1, BATCHES[0]):
        pipeline.ingest_and_insert(cfg, used, made["points"][s], made["valid"][s], made["egos"][s])
    pipeline.ingest_and_insert(cfg, fresh, made["points"][BATCHES[0]], made["valid"][BATCHES[0]],
                               made["egos"][BATCHES[0]])
    a, b = int(used.last_slot), int(fresh.last_slot)
    for name in ("hit", "miss", "min_height", "origin"):
        bitwise(name, getattr(used.grids, name)[a], getattr(fresh.grids, name)[b])
    moments_close("slot moments", used.grids.mom[a], fresh.grids.mom[b], ATOL_BATCH)
    assert int((used.grids.hit[a] > 0).sum()) > 1_000
