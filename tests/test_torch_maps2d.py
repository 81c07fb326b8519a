"""The port's 2-D stencils against the JAX package's, bitwise, on the CPU.

The plain twins of the stencils, `gvom_tpu_torch.ops.maps2d.plane_fit_plain`
and `guess_height_plain` (on the card the plane-fit and guess-height
kernels, which chip_smoke.py holds bitwise against the same twins), meet `gvom_tpu/ops/maps2d.py::slope_and_roughness` and
`::guess_height_delta`, jitted on the CPU, on seeded 64×64 maps of every
`io.synthetic.stencil_maps` pattern (all known, all unknown, checkerboard,
border only, collinear triples with det = 0, a count of exactly 3, heights
near ±1e4, sparse known cells, terrain with holes), the guess search at
R ∈ {0, 1, 3, 15, 80}. Every output is compared by its bits, so −0.0 and
0.0 differ.

R = 80 (beyond the map's 64 cells) is held against the JAX package's NumPy
oracle, `gvom_tpu/oracle/numpy_ref.py::NumpyOracle._guess_height`, the
reference's per-cell loop: XLA unrolls the JAX function's R steps, and its
compile grows faster than R² (3 s at R = 15, 22 s at R = 32 on a 64×64 map;
at R = 80 it had not finished after 40 minutes). The oracle works in
float64 on float32 heights; the one subtraction of two float32 heights is
exact there, so its float32 cast is the float32 subtraction's bits.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gvom_tpu.config import GvomConfig as JaxConfig
from gvom_tpu.ops import maps2d as jax_maps2d
from gvom_tpu.oracle.numpy_ref import NumpyOracle
from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.io.synthetic import STENCIL_PATTERNS, stencil_maps
from gvom_tpu_torch.ops import kernels, maps2d

X = 64
JIT_RADII = (0, 1, 3, 15)
ORACLE_RADII = (80,)


def _cfgs(R=15):
    return (GvomConfig(xy_size=X, z_size=32, max_points=4096, guess_search_radius=R),
            JaxConfig(xy_size=X, z_size=32, max_points=4096, guess_search_radius=R))


@functools.lru_cache(maxsize=None)
def _jax_slope():
    jcfg = _cfgs()[1]
    return jax.jit(lambda h: jax_maps2d.slope_and_roughness(jcfg, h))


@functools.lru_cache(maxsize=None)
def _jax_guess(R):
    jcfg = _cfgs(R)[1]
    return jax.jit(lambda h, i: jax_maps2d.guess_height_delta(jcfg, h, i))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float32)).view(np.int32)


def _assert_bitwise(name, got, want):
    diff = _bits(got) != _bits(want)
    assert not diff.any(), (f"{name}: {int(diff.sum())} cells differ in their bits, first at "
                            f"{np.argwhere(diff)[0].tolist()}")


@pytest.mark.parametrize("pattern", STENCIL_PATTERNS)
def test_slope_and_roughness_bitwise_the_jax_package(pattern):
    cfg, _ = _cfgs()
    hm, _ = stencil_maps(pattern, X, seed=1)
    rough, slope_x, slope_y = maps2d.plane_fit_plain(cfg, torch.from_numpy(hm))
    want = _jax_slope()(hm)
    for name, a, b in zip(("slope_x", "slope_y", "roughness"), (slope_x, slope_y, rough), want):
        assert a.dtype == torch.float32 and tuple(a.shape) == (X, X)
        _assert_bitwise(f"{pattern} {name}", a.numpy(), np.asarray(b))


@pytest.mark.parametrize("R", JIT_RADII + ORACLE_RADII)
@pytest.mark.parametrize("pattern", STENCIL_PATTERNS)
def test_guess_height_delta_bitwise_the_jax_package(pattern, R):
    cfg, jcfg = _cfgs(R)
    hm, ihm = stencil_maps(pattern, X, seed=2)
    got = maps2d.guess_height_plain(cfg, torch.from_numpy(hm), torch.from_numpy(ihm))
    assert got.dtype == torch.float32 and tuple(got.shape) == (X, X)
    if R in JIT_RADII:
        want = np.asarray(_jax_guess(R)(hm, ihm))
    else:
        want = NumpyOracle(jcfg)._guess_height(hm.astype(np.float64), ihm.astype(np.float64)).astype(np.float32)
    _assert_bitwise(f"{pattern} R={R}", got.numpy(), want)


def _count3(hm):
    """Cells whose 3×3 window holds exactly three known cells."""
    k = np.pad(hm > -1000.0, 1)
    return sum(k[1 + di:1 + di + X, 1 + dj:1 + dj + X].astype(int) for di in (-1, 0, 1) for dj in (-1, 0, 1)) == 3


def test_the_patterns_reach_the_cases_they_are_for():
    """The fit is ok (cnt >= 3, det != 0) everywhere on the dense map and
    nowhere on the empty one; windows of three collinear cells give det = 0
    exactly and also, rounded, det != 0; a count of exactly 3 gives an ok
    fit; and the guess search finds a positive spread on the sparse map at
    R = 15 but not at R = 0."""
    cfg, _ = _cfgs()
    ok, three = {}, {}
    for pattern in STENCIL_PATTERNS:
        hm, _ = stencil_maps(pattern, X, seed=1)
        ok[pattern] = maps2d.plane_fit_inputs(cfg, torch.from_numpy(hm))[1].numpy()
        three[pattern] = _count3(hm)
    assert ok["all_known"].all() and not ok["all_unknown"].any()
    assert (three["collinear_triples"] & ~ok["collinear_triples"]).any()
    assert (three["collinear_triples"] & ok["collinear_triples"]).any()
    assert (three["count_three"] & ok["count_three"]).any() and ok["near_1e4"].any()
    hm, ihm = (torch.from_numpy(a) for a in stencil_maps("sparse", X, seed=2))
    assert int((maps2d.guess_height_plain(cfg, hm, ihm) > 0).sum()) > X * X // 2
    assert int((maps2d.guess_height_plain(_cfgs(0)[0], hm, ihm) > 0).sum()) == 0


def test_cpu_wrappers_are_the_plain_twins():
    """On CPU tensors the kernel wrappers run the plain twins: the whole fit
    from the torus-layout maps (the window layout, then the fit), its tail
    on the fit's inputs, and the guess search with the maps after it; a
    wrong shape or a negative radius is refused."""
    cfg, _ = _cfgs()
    hm, ihm = (torch.from_numpy(a) for a in stencil_maps("terrain_holes", X, seed=3))
    o = torch.tensor([7, -3, 0], dtype=torch.int32)
    hm_t, ihm_t = (torch.roll(a, (7, -3), (0, 1)) for a in (hm, ihm))     # window[r] = torus[r + o]
    got = kernels.plane_fit(cfg, hm_t, ihm_t, o)
    _assert_bitwise("window height", got[0].numpy(), hm.numpy())
    _assert_bitwise("window inferred height", got[1].numpy(), ihm.numpy())
    fit = maps2d.plane_fit_inputs(cfg, hm)
    for a, b, c in zip(got[2:], maps2d.plane_fit_plain(cfg, hm), kernels.plane_fit_tail(*fit)):
        _assert_bitwise("plane fit", a.numpy(), b.numpy())
        _assert_bitwise("plane fit tail", c.numpy(), b.numpy())
    rng = np.random.default_rng(4)
    bands = [torch.from_numpy(rng.integers(0, 50, (X, X)).astype(np.int32)) for _ in range(2)]
    band_ok = torch.from_numpy((rng.random((X, X)) < 0.8).astype(np.int32))
    args = (hm, ihm, got[3], got[4], bands[0], torch.maximum(bands[0], bands[1]), band_ok, o)
    guess = kernels.guess_height(cfg, *args)
    _assert_bitwise("guess", guess[0].numpy(), maps2d.guess_height_plain(cfg, hm, ihm).numpy())
    for a, b in zip(guess[1:], maps2d.map_products_plain(cfg, *args[4:7], got[3], got[4], guess[0], hm, o)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="shape"):
        kernels.plane_fit(cfg, hm_t[:-1], ihm_t, o)
    with pytest.raises(ValueError, match="shape"):
        kernels.guess_height(cfg, hm, ihm[:, :-1], *args[2:])
    with pytest.raises(ValueError, match=">= 0"):
        kernels.guess_height(_cfgs(-1)[0], *args)
