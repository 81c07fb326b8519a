"""K2 (csrc/binning.cu) on the card, on the benchmark lap's 64-scan batches:
on a binning.MomentScratch kept across calls (the batched step's, the ring
buffer's) against the plain twin, hit, min_height and n bit for bit and the
nine sums within the batch tolerance; the scratch's contract after each
call (channels 1-9 zero where n is 0, the touched bytes 1 where n > 0) and
after calls over other scans (what a fresh scratch gives); the epilogues
(K3, K5) on its n and channels 1-9 against their plain twins; two
batched steps on one step's scratch, and a ring buffer's ingest after
others, against fresh ones; K5's targets only (the one-rank batched
step's form) over NaN-poisoned memory against its other forms, and three
lap steps in it against the same steps with the mask off; and, on the scratch's layout (channels 1-8
voxel-major, channel 9 apart, binning.rest_parts), K2 then K5 on the lap's
batch, K3 through the ring buffer, a slab across the window seam, and the
separable passes and the direct kernel of the wide boxes, each against
the plain twins run from the same points.

Every test needs a CUDA card: it takes the `lap` fixture, which skips
without one. The file imports no JAX (the card's machine has none); on
the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_binning_card.py
"""

import dataclasses
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


def channels(scratch):
    """Channels 1-9 of a scratch as [9, P] (binning.rest_channels)."""
    return binning.rest_channels(scratch.rest, scratch.touched.shape).view(9, -1)


def check_contract(what, bins, scratch):
    live = bins.n[0].reshape(-1) > 0
    rest = channels(scratch)
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
    close("sums", channels(used)[:, live], channels(fresh)[:, live], ATOL_BATCH)


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


NAN_BYTE = 0xFF   # a float32 of four such bytes is a NaN


def poison_free_memory(n_bytes):
    """Hand the allocator's free memory back to the card, then fill n_bytes
    of what it holds free with NaN bytes, so that the next allocations come
    from them; returns their address."""
    torch.cuda.empty_cache()
    junk = torch.full((n_bytes,), NAN_BYTE, dtype=torch.uint8, device="cuda")
    ptr = junk.data_ptr()
    del junk
    return ptr


def test_targets_only_stores_the_hits_alone(lap):
    """K5 in targets only, its output allocated over NaN bytes: NaN bytes
    left at every voxel without a hit, and at every hit voxel the bits that
    the mask-off and the mask-on forms write; one launch, counted under
    its store mode."""
    cfg, made = lap
    scratch = binning.moment_scratch(cfg, "cuda")
    p, keep, origin = prepared(cfg, made, BATCHES[0])
    bins = kernels.bin_points(cfg, p, keep, origin, scratch=scratch)
    assert kernels.epilogue_route(cfg) == "tiled"
    forms = {mask: kernels.moments_epilogue(cfg, bins.n, bins.rest, bins.hit, origin, occupancy_mask=mask)
             for mask in (False, True)}
    kernels.reset_launches()
    ptr = poison_free_memory(forms[True].numel() * 4)
    got = kernels.moments_epilogue(cfg, bins.n, bins.rest, bins.hit, origin, occupancy_mask="targets")
    assert got.data_ptr() == ptr, "the output was not allocated over the poisoned bytes"
    assert kernels.XBOX.launches == 1 and kernels.K5_STORES == {"all": 0, "targets": 1}
    occ = bins.hit > 0
    assert int(occ.sum()) > 10_000
    assert bool((got.view(torch.int32)[:, ~occ] == -1).all()), "targets only stored off the hits"
    for mask, want in forms.items():
        bitwise(f"targets only vs mask {mask} at the hits", got[:, occ], want[:, occ])


def test_lap_steps_in_targets_only_equal_the_mask_off(lap, monkeypatch):
    """Three consecutive lap steps of the one-rank step, each over free
    memory poisoned with NaN bytes, and the same three steps with K5 forced
    to the mask off on the same K2 sums (K2's float atomics differ from run
    to run): world and products bit for bit. The first run's K5 launches
    are one a step, all targets only."""
    from gvom_tpu_torch.parallel import make_batched_step
    from gvom_tpu_torch.types import empty_world_state

    cfg, made = lap
    real_bins, real_epilogue = kernels.bin_points, kernels.moments_epilogue
    kept = []

    def recorded(*args, **kw):
        bins = real_bins(*args, **kw)
        kept.append(binning.PointBins(*(x.clone() for x in bins)))
        return bins

    def run():
        step, world, out = make_batched_step(cfg, "cuda"), empty_world_state(cfg, "cuda"), []
        for b0 in (64, 128, 192):
            poison_free_memory(1 << 30)
            world, products = step(world, *raw(made, b0))
            out.append((world, products))
        torch.cuda.synchronize()
        return out

    monkeypatch.setattr(kernels, "bin_points", recorded)
    kernels.reset_launches()
    targets = run()
    assert kernels.K5_STORES == {"all": 0, "targets": 3} and kernels.XBOX.launches == 3
    replay = iter(kept)
    monkeypatch.setattr(kernels, "bin_points", lambda *a, **kw: binning.PointBins(*(x.clone() for x in next(replay))))
    monkeypatch.setattr(kernels, "moments_epilogue",
                        lambda cfg, n, rest, hit, origin, y_window, mask: real_epilogue(
                            cfg, n, rest, hit, origin, y_window, False))
    kernels.reset_launches()
    mask_off = run()
    assert kernels.K5_STORES == {"all": 3, "targets": 0}
    for i, ((w, p), (wm, pm)) in enumerate(zip(targets, mask_off)):
        for name in ("hit", "miss", "min_height", "mom", "origin"):
            bitwise(f"step {i} {name}", getattr(w.grid, name), getattr(wm.grid, name))
        bitwise(f"step {i} evidence", w.evidence, wm.evidence)
        for name, value in vars(p).items():
            bitwise(f"step {i} {name}", value, getattr(pm, name))
    assert not bool(torch.isnan(targets[-1][0].grid.mom).any())


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


def against_twins(what, cfg, p, keep, origin, y_window=None, masks=(False, True), scratch=None):
    """K2 on `scratch` (a used one where given), then K5 with each mask, held
    against the plain twins run from the same points (binning.bin_points,
    moments.moments_epilogue_plain on the twin's own bins): hit, min_height
    and n bitwise, the nine sums within the batch tolerance where n > 0;
    the moments' n bitwise, their nine other channels within it."""
    got = kernels.bin_points(cfg, p, keep, origin, y_window, scratch=scratch)
    plain = binning.bin_points(cfg, p, keep, origin, y_window)
    bitwise(f"{what} hit", got.hit, plain.hit)
    bitwise(f"{what} min_height", got.min_height, plain.min_height)
    bitwise(f"{what} n", got.n, plain.n)
    sums_close(f"{what} sums", got.sums, plain.sums, ATOL_BATCH)
    for mask in masks:
        moments_close(f"{what} K5 mask {mask}",
                      kernels.moments_epilogue(cfg, got.n, got.rest, got.hit, origin, y_window, mask),
                      moments.moments_epilogue_plain(cfg, plain.n, plain.rest, plain.hit, origin, y_window, mask),
                      ATOL_BATCH)
    return got


def test_k2_then_k5_lap_batch_against_twins(lap):
    """The batched step's pair on the lap's batch, K2 on a used scratch then
    K5 mask off (and on), against the twins from the same points; the
    scratch's two parts zero wherever its touched byte is 0."""
    cfg, made = lap
    scratch = binning.moment_scratch(cfg, "cuda")
    kernels.bin_points(cfg, *prepared(cfg, made, BATCHES[1]), scratch=scratch)
    got = against_twins("lap batch", cfg, *prepared(cfg, made, BATCHES[0]), scratch=scratch)
    first, ninth = binning.rest_parts(scratch.rest, scratch.touched.shape)
    untouched = scratch.touched == 0
    assert not first[untouched].any() and not ninth[untouched].any()
    assert int((got.n[0] > 0).sum()) == int((~untouched).sum()) > 10_000


def test_seam_slab_against_twins(lap):
    """K2's and K5's slab forms on a slab across the window seam (64 torus
    rows, the seam inside) of the lap's batch, on a kept scratch used by
    another batch first, against the twins."""
    cfg, made = lap
    Y = cfg.xy_size

    def seam_slab(origin):
        """64 torus rows around the window seam, torus row origin_y."""
        return min(max(int(origin[1]) % Y - 32, 0), Y - 64), 64

    p, keep, origin = prepared(cfg, made, BATCHES[0])
    y_window = seam_slab(origin)
    _, len_a, _ = binning.slab_rows(cfg, origin, y_window)
    assert 0 < int(len_a) < 64
    scratch = binning.moment_scratch(cfg, "cuda", y_window)
    other, okeep, oorigin = prepared(cfg, made, BATCHES[1])
    kernels.bin_points(cfg, other, okeep, oorigin, seam_slab(oorigin), scratch=scratch)
    got = against_twins("seam slab", cfg, p, keep, origin, y_window, scratch=scratch)
    assert int((got.hit > 0).sum()) > 1_000


def test_k3_through_ring_buffer_against_twins(lap):
    """A lap scan ingested into a ring buffer whose scratch binned two other
    scans first: its slot's moments against the twins (K2's, then K3's
    with the mask) from the scan's own prepared points, n bitwise."""
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.types import empty_buffer_state

    cfg, made = lap
    buf = empty_buffer_state(cfg, "cuda")
    s = BATCHES[0]
    for k in (BATCHES[1], BATCHES[1] + 1, s):
        pipeline.ingest_and_insert(cfg, buf, made["points"][k], made["valid"][k], made["egos"][k])
    p, keep, origin, _ = pipeline._prepare(cfg, made["points"][s], made["valid"][s], made["egos"][s].float(), None)
    plain = binning.bin_points(cfg, p, keep, origin)
    out = torch.zeros((2, 10) + cfg.grid_shape, device="cuda")
    moments.ingest_epilogue_plain(cfg, plain.n, plain.rest, plain.hit, origin, out,
                                  torch.ones((1,), dtype=torch.int32, device="cuda"))
    slot = int(buf.last_slot)
    bitwise("slot hit", buf.grids.hit[slot], plain.hit)
    moments_close("slot moments (K3)", buf.grids.mom[slot], out[1], ATOL_BATCH)
    assert int((plain.hit > 0).sum()) > 1_000


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("eigen", [(1, 9), (8, 1), (5, 8)])
def test_wide_boxes_against_twins(lap, eigen, mask):
    """The epilogue past the tiled box on a lap scan: the separable passes
    (whose first pass reads the scratch's layout) and, with the mask on at
    (1, 9), the direct kernel, against the twins; K2 at the wider padding
    too."""
    from gvom_tpu_torch.models import pipeline

    cfg, made = lap
    c = dataclasses.replace(cfg, xy_eigen_dist=eigen[0], z_eigen_dist=eigen[1])
    route = kernels.epilogue_route(c, None, mask)
    assert route == ("direct" if mask and eigen == (1, 9) else "separable")
    s = BATCHES[0]
    p, keep, origin, _ = pipeline._prepare(c, made["points"][s], made["valid"][s], made["egos"][s].float(), None)
    scratch = binning.moment_scratch(c, "cuda")
    kernels.bin_points(c, *pipeline._prepare(c, made["points"][s + 9], made["valid"][s + 9],
                                             made["egos"][s + 9].float(), None)[:3], scratch=scratch)
    against_twins(f"eigen {eigen} ({route})", c, p, keep, origin, masks=(mask,), scratch=scratch)
