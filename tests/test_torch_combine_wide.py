"""The port's combine at ring-buffer depths and z sizes at the boundaries of
K4's forms, against gvom_tpu's combine(impl="xla"), on the CPU, over a
drive of 3 scans with a moving ego (torch_helpers.combine_drive): the world
channels as torch_helpers states, the products bitwise.

These hold the plain twin (pipeline.fuse_plain and the column products),
which takes every depth and z size in one slot loop: the kernel's slot
groups, its ballots of 32 slots and its z pairs run only on the card, where
chip_smoke.py (phase1_combine_other_b) holds them bitwise against this twin
with the ring buffer full."""

import pytest

from gvom_tpu.config import GvomConfig

from torch_helpers import combine_drive


@pytest.mark.parametrize("buffer_size", [16, 33])
def test_fuse_plain_at_grouped_depths(buffer_size):
    """B = 16, the deepest unrolled kernel, and 33, past the grouped
    kernel's first ballot of 32 slots, at 16×16×16."""
    combine_drive(GvomConfig(xy_size=16, z_size=16, max_points=1024, buffer_size=buffer_size))


@pytest.mark.parametrize("z_size", [257, 31])
def test_fuse_plain_at_other_z_sizes(z_size):
    """An odd z size past 256 (the grouped kernel with 4-byte accesses) and
    31 (the unrolled kernel's four-chunk path), at 16×16, B = 4: the z
    sizes whose pairs of voxels are not both inside the column."""
    ref, tprod = combine_drive(GvomConfig(xy_size=16, z_size=z_size, max_points=1024, buffer_size=4))
    if z_size > 256:
        assert (ref["hit"][:, :, 256:] > 0).any() or (ref["miss"][:, :, 256:] > 0).any()
    assert (tprod.height.numpy() > -1000).any() and (tprod.inferred_height.numpy() > -1000).any()
