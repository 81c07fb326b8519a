"""Comparisons of a kernel's output with its plain version's, shared by the
card checks (`python -m gvom_tpu_torch.cli selftest`, chip_smoke.py, the `card` tests). Each
raises Failed with what differs, and returns the max abs error where a
tolerance applies."""

from __future__ import annotations

import torch

__all__ = ["MOM_RTOL", "MOM_ATOL", "Failed", "check", "exact", "bitwise", "close", "tol_share", "moments_close",
           "sums_close", "clean_sums"]

# f32 moment sums taken in another order (atomics, the 27-voxel box) than the
# plain version's: relative error grows with the number of terms, up to a few
# thousand near the ego
MOM_RTOL = 1e-4
MOM_ATOL = 1e-3


class Failed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Failed(what)


def exact(name, a, b):
    check(a.shape == b.shape and a.dtype == b.dtype, f"{name}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    n = int((a != b).sum())
    check(n == 0, f"{name}: {n} elements differ from the plain version")
    return 0.0


def bitwise(name, a, b):
    """exact, bit for bit: float32 −0.0 and 0.0 differ, NaNs compare by
    their bits."""
    if a.dtype == b.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return exact(name, a, b)


def close(name, a, b, atol=MOM_ATOL):
    check(a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}")
    ok = torch.isclose(a, b, rtol=MOM_RTOL, atol=atol)
    n = int((~ok).sum())
    err = float((a - b).abs().max()) if a.numel() else 0.0
    check(n == 0, f"{name}: {n} elements outside rtol={MOM_RTOL} atol={atol} (max abs err {err})")
    return err


def tol_share(a, b, atol):
    """The largest |a − b| as a share of its tolerance atol + MOM_RTOL·|b|."""
    return float(((a - b).abs() / (atol + MOM_RTOL * b.abs())).max())


def moments_close(name, a, b, atol=MOM_ATOL):
    """[10, ...] moments: the count n bitwise, the nine sums within tolerance."""
    exact(f"{name} n", a[0], b[0])
    return close(f"{name} moments", a, b, atol)


def sums_close(name, a, b, atol=MOM_ATOL):
    """K2's own-voxel sums [10, ...]: n bitwise, the nine other channels
    within tolerance where n > 0, the only voxels where they are defined
    (binning.PointBins)."""
    exact(f"{name} n", a[0], b[0])
    nz = b[0] > 0
    return close(f"{name} sums where n > 0", a[:, nz], b[:, nz], atol)


def clean_sums(sums):
    """The sums with channels 1-9 set to 0 where n == 0, as the plain twins
    read them."""
    return torch.where(sums[:1] > 0, sums, torch.zeros((), dtype=sums.dtype, device=sums.device))
