"""The port's float32 log and atan2 (gvom_tpu_torch.ops.grid.log32 and
atan2_32) against the jitted jnp.log and jnp.arctan2 of the JAX package's
CPU backend, bitwise: XLA inlines a Cephes log polynomial with fused
multiply-adds and calls the C library's atan2f, both under
denormals-are-zero. The inputs are seeded numpy samples and edge cases
(subnormals, powers of two, values next to 1, the ends of the plane fit's
domain); every array's length is a multiple of 8, as the X·Y cells the
pipeline feeds are. The full sweep (every positive float32 for the log) is
scripts/torch_mathf_sweep.py. atan2's reference is the atan2f of the
machine that runs the tests: its C library is named in a failure."""

import platform

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvom_tpu_torch.ops.grid import atan2_32, log32

N = 1_000_000
RNG_SEED = 6


def _pad8(a: np.ndarray) -> np.ndarray:
    return np.concatenate([a, np.ones((-len(a)) % 8, a.dtype)]).astype(np.float32)


def _assert_bitwise(got: np.ndarray, ref: np.ndarray, inputs, what: str):
    differ = (got.view(np.uint32) != ref.view(np.uint32)) & ~(np.isnan(got) & np.isnan(ref))
    idx = np.flatnonzero(differ)[:5]
    assert not differ.any(), (
        f"{what}: {int(differ.sum())} of {got.size} values differ ({'-'.join(platform.libc_ver())}); "
        f"first inputs {[tuple(float(x[i]) for x in inputs) for i in idx]}, port {got[idx]}, jax {ref[idx]}")


def _log_inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(RNG_SEED)
    if kind == "random_bits":      # every binade, subnormals included
        return rng.integers(1, 0x7F800000, N, dtype=np.int64).astype(np.uint32).view(np.float32)
    if kind == "residuals":        # the plane fit's mean squared residuals
        return (10.0 ** rng.uniform(-14, 2, N)).astype(np.float32)
    one = np.float32(1.0)
    near_one = [np.nextafter(one, np.float32(k)) for k in (0, 2)]
    edges = [0.0, -0.0, 1e-45, 1e-40, 2.0 ** -126, np.nextafter(np.float32(2.0 ** -126), one), 1.0, *near_one,
             0.70710677, 0.7071068, 1.4142135, np.finfo(np.float32).max, np.inf, -1.0, np.nan]
    powers = [2.0 ** k for k in range(-149, 128)]
    ulps = one + np.arange(-64, 64, dtype=np.float32) * np.float32(2.0 ** -24)
    return _pad8(np.array(edges + powers + list(ulps), np.float32))


def _atan2_inputs(kind: str):
    rng = np.random.default_rng(RNG_SEED + 1)
    if kind == "fit_domain":       # y = a0/m, x = 1/m, m = sqrt(a0² + a1² + 1)
        a0 = (rng.standard_normal(N) * 10.0 ** rng.uniform(-6, 6, N)).astype(np.float32)
        a1 = rng.uniform(-1, 1, N).astype(np.float32)
        m = np.sqrt(a0.astype(np.float64) ** 2 + a1.astype(np.float64) ** 2 + 1.0).astype(np.float32)
        return (a0 / m).astype(np.float32), (np.float32(1.0) / m).astype(np.float32)
    if kind == "random_bits_x_positive":
        y = rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32).view(np.float32)
        x = rng.integers(0, 0x7F800001, N, dtype=np.int64).astype(np.uint32).view(np.float32)
        return y, x
    vals = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, 2.0 ** -29, 2.0 ** -28, 0.4375, 11 / 16, 1.0, -1.0,
                     np.nextafter(np.float32(1), np.float32(0)), np.nextafter(np.float32(1), np.float32(2)),
                     1.1875, 2.4375, 2.0 ** 25, 2.0 ** 62, 3e38, np.inf, -np.inf, np.nan], np.float32)
    y, x = (a.ravel() for a in np.meshgrid(vals, vals))
    return _pad8(y), _pad8(x)


@pytest.fixture(scope="module")
def jlog():
    return jax.jit(jnp.log)


@pytest.fixture(scope="module")
def jatan2():
    return jax.jit(jnp.arctan2)


@pytest.mark.parametrize("kind", ["random_bits", "residuals", "edges"])
def test_log32_matches_jnp_log(jlog, kind):
    x = _log_inputs(kind)
    assert len(x) % 8 == 0
    _assert_bitwise(log32(torch.from_numpy(x)).numpy(), np.asarray(jlog(x)), (x,), f"log32 on {kind}")


@pytest.mark.parametrize("kind", ["fit_domain", "random_bits_x_positive", "edges"])
def test_atan2_32_matches_jnp_arctan2(jatan2, kind):
    y, x = _atan2_inputs(kind)
    assert len(x) % 8 == 0
    _assert_bitwise(atan2_32(torch.from_numpy(y), torch.from_numpy(x)).numpy(), np.asarray(jatan2(y, x)),
                    (y, x), f"atan2_32 on {kind}")
