"""K1's march schedule, counted by its plain twin (raycast.march_stats_plain)
on the CPU: each block's rays sorted by live steps before the march, so a
warp's 32 lanes walk rays of near-equal length. The counts are those that
kernels.ray_march_stats takes on the card (tests/test_torch_raycast_card.py
holds the two equal): live lane-steps, issued lane-steps (32 × each warp's
iterations) and the atomics after the warp merge."""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import kernels, raycast

# one voxel a metre, the ego at the centre of voxel (32, 32, 16) and the
# origin at 0, so a ray along an axis of length ℓ + 0.5 voxels has
# budget ℓ − 0.5, delta 1 and ℓ live steps, voxel 32 ± k (16 ± k in z) at step k
CFG = GvomConfig(xy_size=64, z_size=32, max_points=1024, buffer_size=3, xy_resolution=1.0, z_resolution=1.0)
EGO = torch.tensor([32.5, 32.5, 16.5])
ORIGIN = torch.zeros(3, dtype=torch.int32)
AXES = torch.tensor([[1.0, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]])


def fan(axes, lengths, keep=None):
    """One scan of rays from EGO along AXES[axes], `lengths` voxels long:
    (points [1,n,3], keep [1,n], egos [1,3])."""
    pts = EGO[None, :] + AXES[torch.as_tensor(axes)] * torch.as_tensor(lengths, dtype=torch.float32)[:, None]
    keep = torch.ones(len(axes), dtype=torch.bool) if keep is None else torch.as_tensor(keep)
    return pts[None].contiguous(), keep[None].contiguous(), EGO[None].clone()


def stats(inputs, window=256, sort=True):
    return raycast.march_stats_plain(CFG, *inputs, ORIGIN, window=window, sort=sort).tolist()


@pytest.mark.parametrize("sort", [False, True])
def test_one_warp_of_a_fan(sort):
    """Four rays along +x of 1, 3, 6 and 10 live steps in one warp: the warp
    walks 10 steps (320 lane-steps issued) for the rays' 20, in either
    order; at each step the lanes still walking add to one voxel, one
    atomic after the merge: 10."""
    inputs = fan([0] * 4, [1.5, 3.5, 6.5, 10.5])
    m = raycast.march_inputs(CFG, inputs[0][0], inputs[1][0], EGO, ORIGIN)
    assert raycast.live_steps(m, CFG.ray_steps).tolist() == [1, 3, 6, 10]
    assert stats(inputs, sort=sort) == [20, 320, 10]


def test_two_warps_sorted_by_length():
    """64 rays alternating along +x (10 live steps) and +y (2): in launch
    order each warp holds 16 of each and walks 10 steps, 640 lane-steps
    issued for 384, a utilisation of 0.6, and takes 2 atomics at each of
    steps 1-2 and 1 at steps 3-10 (24 in all). Sorted, warp 0 walks the
    short rays 2 steps and warp 1 the long ones 10: 384 issued, a
    utilisation of 1, and 12 atomics."""
    inputs = fan([0, 2] * 32, [10.5, 2.5] * 32)
    assert stats(inputs, sort=False) == [384, 640, 24]
    assert stats(inputs, sort=True) == [384, 384, 12]


def test_rays_that_leave_the_grid_or_never_start():
    """A ray along −z of 30 live steps leaves the grid at step 17 (voxel
    z = −1): it walks 17 iterations, 16 inside and the one that leaves; an
    unkept ray and a ray of half a voxel (no live step) walk none."""
    inputs = fan([5, 0, 1], [30.5, 10.5, 0.5], keep=[True, False, True])
    m = raycast.march_inputs(CFG, inputs[0][0], inputs[1][0], EGO, ORIGIN)
    assert raycast.live_steps(m, CFG.ray_steps).tolist() == [30, 0, 0]
    assert stats(inputs) == [17, 32 * 17, 16]


def test_march_order_of_a_ragged_block():
    """A block's slots in march order: ascending live steps, ties in the
    rays' order, and the slots past the last ray of a ragged block sort
    among the dead rays after the block's own (the kernel's threads past
    n stage a dead ray). Live steps past SORT_KEY_MAX tie at it, after the
    253 empty slots of a block of three rays."""
    key = torch.tensor([3, 0, 5, 3, 1, 0, 2])
    assert raycast.march_order(key, 4).tolist() == [1, 0, 3, 2, 6, 4, 7]
    assert raycast.march_order(key, 4, sort=False).tolist() == list(range(7))
    assert raycast.march_order(raycast.sort_key(torch.tensor([600, 511, 7])), 256).tolist() == [254, 255, 253]


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.integers(0, 5), st.floats(0.5, 15.4), st.booleans()), min_size=1, max_size=700),
       st.sampled_from([256, 1024]))
def test_sorted_never_issues_more_than_launch_order(rays, window):
    """Random rays that stay in the grid (each walks its live steps): within
    every block the sorted order issues no more warp-steps than the launch
    order, and both walk the same live lane-steps."""
    axes, lengths, keep = zip(*rays)
    pts, kp, egos = fan(list(axes), list(lengths), list(keep))
    for b0 in range(0, len(rays), window):
        block = (pts[:, b0:b0 + window].contiguous(), kp[:, b0:b0 + window].contiguous(), egos)
        srt, launch = stats(block, window, True), stats(block, window, False)
        assert srt[0] == launch[0]
        assert srt[1] <= launch[1]


def test_ray_window_follows_the_launch_shape():
    """K1 sorts 256 rays a block unless the launch, in blocks of 1,024 rays,
    gives every SM WIDE_BLOCKS_PER_SM of them: one OS1-128 scan keeps 256
    (512 blocks for the H100's 132 SMs), the benchmark's 64-scan batch
    takes 1,024 (8,192 blocks)."""
    sms, n = 132, 131072
    assert kernels.ray_window(1, n, sms) == 256
    assert kernels.ray_window(64, n, sms) == 1024
    need = kernels.WIDE_BLOCKS_PER_SM * sms
    assert kernels.ray_window(need, 1024, sms) == 1024
    assert kernels.ray_window(need - 1, 1024, sms) == 256
    assert kernels.ray_window(need, 1023, sms) == 1024 and kernels.ray_window(need - 1, 1025, sms) == 1024


def test_march_stats_wrapper_on_the_cpu():
    """kernels.ray_march_stats on CPU tensors returns the plain twin's pass
    counts and schedule counts; it needs the window given there (the card
    takes ray_window's) and takes only 256 or 1,024."""
    inputs = fan([0, 2] * 32, [10.5, 2.5] * 32)
    passes, counts = kernels.ray_march_stats(CFG, *inputs, ORIGIN, window=256)
    np.testing.assert_array_equal(passes.numpy(), raycast.pass_counts_plain(CFG, *inputs, ORIGIN).numpy())
    assert counts.tolist() == [384, 384, 12] and int(passes.sum()) == 384
    with pytest.raises(ValueError, match="give the window"):
        kernels.ray_march_stats(CFG, *inputs, ORIGIN)
    with pytest.raises(ValueError, match="256 or 1024"):
        kernels.ray_march_stats(CFG, *inputs, ORIGIN, window=512)


def test_sort_key_cap_is_the_kernels():
    """The twin caps the sort key where K1 does: SORT_KEY_MAX is KEY_MAX of
    csrc/raycast.cu, so rays past it tie in both."""
    import re
    from pathlib import Path

    src = (Path(raycast.__file__).resolve().parent.parent / "csrc" / "raycast.cu").read_text()
    caps = re.findall(r"constexpr int KEY_MAX = (\d+);", src)
    assert caps == [str(raycast.SORT_KEY_MAX)]
