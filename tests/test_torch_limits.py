"""What the CUDA kernels cannot take is refused when an entry point is made,
not at its first use on the card.

The kernels index the grid and K2's padded moment scratch in int32, and one
raycast launch takes at most 65535 scans. `Gvom` and `make_batched_step`
check a config made for the card before they build a kernel or allocate any
state (`kernels.check_card_limits`); the batched step checks each batch's
scans (`kernels.check_batch`). Ring-buffer depth, z size and the eigen
distances have no such limit. The checks are pure Python: here the card is
only claimed (`torch.cuda.is_available` patched), and a build fails the test."""

import pytest
import torch

from gvom_tpu_torch import Gvom, GvomConfig
from gvom_tpu_torch.ops import kernels
from gvom_tpu_torch.parallel.sharding import make_batched_step

# (config fields, the words that the refusal names)
PAST_LIMITS = [
    (dict(xy_size=8192, z_size=32), "voxels"),                 # 2^31 voxels
    (dict(xy_size=8192, z_size=31), "moment scratch"),         # 2080374784 voxels, 8194·8194·33 scratch cells
    (dict(xy_size=8192, z_size=30, z_eigen_dist=2), "moment scratch"),
]


@pytest.fixture
def claimed_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_build(*a, **k):
        raise AssertionError("a kernel was built before the limits were checked")

    monkeypatch.setattr(kernels, "build_all", no_build)


@pytest.mark.parametrize("fields,words", PAST_LIMITS)
def test_entry_points_refuse_what_the_kernels_cannot_index(claimed_card, fields, words):
    cfg = GvomConfig(**fields)
    with pytest.raises(ValueError, match=words):
        Gvom(config=cfg, device="cuda")
    with pytest.raises(ValueError, match=words):
        make_batched_step(cfg, "cuda")
    # the plain versions on the CPU have no such limit
    kernels.check_card_limits(GvomConfig(xy_size=8192, z_size=29))
    make_batched_step(cfg, "cpu")


def test_no_limit_on_depth_z_or_eigen_distances():
    for fields in (dict(buffer_size=10000), dict(z_size=4096), dict(xy_eigen_dist=100, z_eigen_dist=100)):
        kernels.check_card_limits(GvomConfig(**fields))
        kernels.check_card_limits(GvomConfig(**fields), slab=True)


def test_batched_step_refuses_a_batch_past_the_kernels():
    kernels.check_batch(kernels.RAY_MAX_SCANS, 1024)
    with pytest.raises(ValueError, match="65535"):
        kernels.check_batch(kernels.RAY_MAX_SCANS + 1, 1)
    with pytest.raises(ValueError, match="int32"):
        kernels.check_batch(32, 2 ** 26)
