"""The benchmark's frozen copy of the port's plain PyTorch version of this stage, which the
benchmark's comparison holds the port against; it imports nothing of the port.

Grid geometry: origins, voxel indexing, torus layout, exact f32 rounding.

The reference's ego-centered scrolling-window convention (gvom.py:123-126):
origin = floor(ego/res − size/2) per axis, in voxel units. Grid tensors store
world voxel w at index w mod size (the torus layout), so maps with different
origins align by per-axis masks and never move data.

Every function here runs on the device of its inputs and never syncs with the
host: origins stay tensors, and rolls by an origin are index gathers.
"""

from __future__ import annotations

import struct

import torch

from benchmark.reference.config import GvomConfig

__all__ = [
    "fma32",
    "sqrt32",
    "log32",
    "atan2_32",
    "resolution_vector",
    "inv_resolution_vector",
    "size_vector",
    "floor_i32",
    "compute_origin",
    "map_local",
    "in_bounds",
    "overlap_mask",
    "window_to_torus",
    "torus_to_window",
]


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 fused multiply-add a·b + c.

    The JAX package's reference arithmetic is what XLA compiles, and XLA
    contracts `a*b + c` (and `a/const − c`, after rewriting the division as
    a multiply by the f32 reciprocal) into one fused multiply-add. Floors of
    those values decide voxel rows, so the port rounds the same expressions
    once, too. PyTorch has no fma operator; this one is exact: the float64
    product of two float32 values is exact, the float64 sum is made
    round-to-odd (TwoSum error, then nudge an even result toward the error),
    and rounding that to float32 is then the correctly rounded fma, because
    float64 carries more than 2·24 + 2 bits."""
    a64 = a.double()
    b64 = b.double() if torch.is_tensor(b) else torch.tensor(float(b), dtype=torch.float64, device=a.device)
    c64 = c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. PyTorch's vectorized CPU
    float32 sqrt can be one ulp off; the float64 root of a float32 value,
    rounded to float32, is the correctly rounded one (53 ≥ 2·24 + 2 bits),
    on every device."""
    return torch.sqrt(x.double()).float()


def _from_bits(bits: int) -> float:
    """The float32 value with these bits (as a Python float, exactly)."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


FLT_MIN = 2.0 ** -126

# XLA:CPU's float32 log (the Cephes logf polynomial, Eigen's plog_float):
# three Horner pairs, sqrt(1/2), ln 2 split into hi and lo
_LOG_P = ((_from_bits(0x3D9021BB), _from_bits(0xBDEBD1B8), _from_bits(0x3DEF251A)),
          (_from_bits(0xBDFE5D4F), _from_bits(0x3E11E9BF), _from_bits(0xBE2AAE50)),
          (_from_bits(0x3E4CCEAC), _from_bits(0xBE7FFFFC), _from_bits(0x3EAAAAAA)))
_SQRTHF = _from_bits(0x3F3504F3)
_LN2_HI = _from_bits(0x3F318000)
_LN2_LO = _from_bits(0xB95E8083)


def log32(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log, bitwise as XLA:CPU's compiled `jnp.log`.

    XLA inlines Cephes' logf polynomial and LLVM contracts it into fused
    multiply-adds; this is that program, op for op, with the same roundings
    (fma32 where the object code has vfmadd/vfnmadd, one rounding for every
    other op). The input's exponent e and mantissa m in [1/2, 1) are split
    off, m below sqrt(1/2) is doubled (e − 1), and with t = m − 1:
    log = e·ln2_hi + ((t − t²/2) + (P(t)·t³ + e·ln2_lo)). XLA runs with
    denormals-are-zero, so a subnormal input is a zero here too: −inf; a
    negative or NaN input gives the all-ones NaN, +inf gives +inf. Checked
    against the jitted jnp.log on every positive float32
    (scripts/torch_mathf_sweep.py)."""
    full = lambda v: torch.full_like(x, v)
    xc = torch.where(x > FLT_MIN, x, full(FLT_MIN))
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).float() + full(1.0)
    m = ((bits & -0x7F800001) | 0x3F000000).view(torch.float32)
    below = m < full(_SQRTHF)
    e = e - below.float()
    t = (m - full(1.0)) + torch.where(below, m, full(0.0))
    t2 = t * t
    t3 = t2 * t
    a, b, c = (fma32(fma32(t, p0, full(p1)), t, full(p2)) for p0, p1, p2 in _LOG_P)
    poly = fma32(fma32(a, t3, b), t3, c)
    r = fma32(poly, t3, e * full(_LN2_LO))
    out = fma32(e, _LN2_HI, fma32(t2, -0.5, t) + r)
    nan = torch.full_like(x, -1, dtype=torch.int32).view(torch.float32)
    out = torch.where((x < 0) | torch.isnan(x), nan, out)
    out = torch.where(x == float("inf"), full(float("inf")), out)
    return torch.where(x.abs() < FLT_MIN, full(float("-inf")), out)


# glibc's float atan2f / atanf (fdlibm e_atan2f.c on s_atanf.c), glibc 2.36
_ATAN_HI = (_from_bits(0x3EED6338), _from_bits(0x3F490FDA), _from_bits(0x3F7B985E), _from_bits(0x3FC90FDA))
_ATAN_LO = (_from_bits(0x31AC3769), _from_bits(0x33222168), _from_bits(0x33140FB4), _from_bits(0x33A22168))
_AT = tuple(_from_bits(b) for b in (0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
                              0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7))
_PI = _from_bits(0x40490FDB)
_PI_O_2 = _from_bits(0x3FC90FDB)
_PI_O_4 = _from_bits(0x3F490FDB)
_PI_LO = _from_bits(0xB3BBBD2E)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """Subnormals to a zero of their sign (XLA's denormals-are-zero and
    flush-to-zero, which hold in the libm calls it makes)."""
    return torch.where(v.abs() < FLT_MIN, v * 0.0, v)


def _atanf(t: torch.Tensor) -> torch.Tensor:
    """glibc's atanf: |t| reduced onto one of atan(1/2), atan(1), atan(3/2),
    atan(inf) (id 0-3) or kept (|t| < 7/16), then an odd polynomial split in
    two Horner chains of w = t⁴; every op rounded once (the library is SSE
    code, without FMAs)."""
    full = lambda v: torch.full_like(t, v)
    ix = t.view(torch.int32) & 0x7FFFFFFF
    a = t.abs()
    idx = ((ix >= 0x3F300000).int() + (ix >= 0x3F980000).int() + (ix >= 0x401C0000).int()).long()
    r = torch.where(idx == 0, ((a + a) - full(1.0)) / (a + full(2.0)),
        torch.where(idx == 1, (a - full(1.0)) / (a + full(1.0)),
        torch.where(idx == 2, (a - full(1.5)) / (a * full(1.5) + full(1.0)), full(-1.0) / a)))
    small = ix < 0x3EE00000
    r = torch.where(small, t, r)
    z = r * r
    w = z * z
    s1 = full(_AT[10])
    for k in (8, 6, 4, 2, 0):
        s1 = s1 * w + full(_AT[k])
    s2 = full(_AT[9])
    for k in (7, 5, 3, 1):
        s2 = s2 * w + full(_AT[k])
    q = (s1 * z + s2 * w) * r
    hi = torch.tensor(_ATAN_HI, dtype=torch.float32, device=t.device)[idx]
    lo = torch.tensor(_ATAN_LO, dtype=torch.float32, device=t.device)[idx]
    red = hi - ((q - lo) - r)
    out = torch.where(small, r - q, torch.where(t < 0, -red, red))
    out = torch.where(ix < 0x31000000, t, out)
    inf = full(_ATAN_HI[3]) + full(_ATAN_LO[3])
    out = torch.where(ix >= 0x4C000000, torch.where(t < 0, -inf, inf), out)
    return torch.where(torch.isnan(t), t + t, out)


def atan2_32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2(y, x), bitwise as XLA:CPU's `jnp.arctan2`, which calls
    glibc's atan2f: fdlibm's e_atan2f.c in float32, with its special cases
    (zeros, infinities, x = 1, |y/x| beyond 2⁶⁰) and atan(|y/x|) from
    _atanf, under XLA's denormals-are-zero and flush-to-zero. The plane fit
    calls it with x = 1/m in (0, 1]; checked against the jitted jnp.arctan2
    for x > 0 and every y, and on random bit patterns of both
    (scripts/torch_mathf_sweep.py). NaN in gives NaN out."""
    full = lambda v: torch.full_like(y, v)
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    nx, ny = hx < 0, hy < 0
    d = iy - ix
    z = _atanf(_flush(_flush(y) / _flush(x)).abs())
    z = torch.where(d > 0x1E7FFFFF, full(_PI_O_2) - full(-0.5 * _PI_LO), z)
    z = torch.where(nx & ((d >> 23) < -60), full(0.0), z)
    out = torch.where(nx, torch.where(ny, (z - full(_PI_LO)) - full(_PI), full(_PI) - (z - full(_PI_LO))),
                      torch.where(ny, -z, z))
    inf = 0x7F800000
    pi = torch.where(ny, full(-_PI), full(_PI))
    half_pi = torch.where(ny, full(-_PI_O_2), full(_PI_O_2))
    out = torch.where(iy == inf, half_pi, out)
    three = full(3.0) * full(_PI_O_4)
    corner = torch.where(nx, torch.where(ny, -three, three), torch.where(ny, full(-_PI_O_4), full(_PI_O_4)))
    out = torch.where(ix == inf, torch.where(iy == inf, corner, torch.where(nx, pi, torch.where(ny, full(-0.0), full(0.0)))), out)
    out = torch.where(ix == 0, half_pi, out)
    out = torch.where(iy == 0, torch.where(nx, pi, y), out)
    out = torch.where(hx == 0x3F800000, _atanf(y), out)
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, out)


def resolution_vector(cfg: GvomConfig, device) -> torch.Tensor:
    return torch.tensor([cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution],
                        dtype=torch.float32, device=device)


def inv_resolution_vector(cfg: GvomConfig, device) -> torch.Tensor:
    """f32(1 / res): the constant XLA multiplies by where the reference
    divides by the resolution."""
    return torch.reciprocal(resolution_vector(cfg, device))


def size_vector(cfg: GvomConfig, device) -> torch.Tensor:
    return torch.tensor([cfg.xy_size, cfg.xy_size, cfg.z_size], dtype=torch.int32, device=device)


def floor_i32(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int32, converted as XLA converts float to int: saturated
    to [INT32_MIN, INT32_MAX], NaN to 0 (a plain .to(torch.int32) of a NaN,
    an infinity or a value beyond the range is undefined, INT32_MIN on x86)."""
    f = torch.floor(x)
    lim = float(2 ** 31)
    i = torch.where((f >= -lim) & (f < lim), f, torch.zeros_like(f)).to(torch.int32)
    i = torch.where(f >= lim, torch.full_like(i, 2 ** 31 - 1), i)
    return torch.where(f < -lim, torch.full_like(i, -2 ** 31), i)


def compute_origin(cfg: GvomConfig, ego_position: torch.Tensor) -> torch.Tensor:
    """Grid origin in voxel units (gvom.py:123-126): floor(ego/res − size/2)."""
    dev = ego_position.device
    half = torch.tensor([cfg.xy_size / 2.0, cfg.xy_size / 2.0, cfg.z_size / 2.0],
                        dtype=torch.float32, device=dev)
    e = ego_position.float()
    return floor_i32(fma32(e, inv_resolution_vector(cfg, dev), -half))


def map_local(cfg: GvomConfig, points: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """[N,3] map-local voxel coordinates points/res − origin (float32)."""
    dev = points.device
    inv = inv_resolution_vector(cfg, dev).expand_as(points)
    return fma32(points, inv, -origin.float().expand_as(points))


def in_bounds(cfg: GvomConfig, vox: torch.Tensor) -> torch.Tensor:
    size = size_vector(cfg, vox.device)
    return torch.all((vox >= 0) & (vox < size), dim=-1)


def overlap_mask(cfg: GvomConfig, o_target: torch.Tensor, o_source: torch.Tensor) -> torch.Tensor:
    """[X,Y,Z] bool: torus cells where the source's stored world voxel equals
    the target window's world voxel (the two windows' overlap)."""
    out = []
    for ax, size in enumerate(cfg.grid_shape):
        i = torch.arange(size, dtype=torch.int32, device=o_target.device)
        rel_t = torch.remainder(i - o_target[ax], size)
        d = o_target[ax] - o_source[ax]
        out.append((rel_t >= -torch.clamp(d, max=0)) & (rel_t < size - torch.clamp(d, min=0)))
    mx, my, mz = out
    return mx[:, None, None] & my[None, :, None] & mz[None, None, :]


def _roll_index(size: int, shift: torch.Tensor, device) -> torch.Tensor:
    i = torch.arange(size, dtype=torch.int64, device=device)
    return torch.remainder(i - shift.to(torch.int64), size)


def window_to_torus(arr: torch.Tensor, origin: torch.Tensor, grid_ndim: int = 3) -> torch.Tensor:
    """torus[(r + o) mod size] = window[r] along the trailing grid axes."""
    for k in range(grid_ndim):
        ax = arr.ndim - grid_ndim + k
        arr = arr.index_select(ax, _roll_index(arr.shape[ax], origin[k], arr.device))
    return arr


def torus_to_window(arr: torch.Tensor, origin: torch.Tensor, grid_ndim: int = 3) -> torch.Tensor:
    """Inverse of window_to_torus: window[r] = torus[(r + o) mod size]."""
    for k in range(grid_ndim):
        ax = arr.ndim - grid_ndim + k
        arr = arr.index_select(ax, _roll_index(arr.shape[ax], -origin[k], arr.device))
    return arr
