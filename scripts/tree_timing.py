"""The one timer of the port's kernels on one NVIDIA GPU, the bounds a time
is read against, and the builds and inputs that the timing scripts share
(scripts/time_entry_points.py, scripts/time_wide_forms.py,
scripts/time_mesh_step.py).

Timers: graph_ms, the card's time for what a call launches, alone (its
launches captured in a CUDA graph and replayed); cuda_ms, the calls back to
back as the host paces them; turns, several calls timed by graph_ms in an
order such as parent, this, this, parent; atomic_rates, the card's rate of
scattered global atomics (gvom_tpu_torch/csrc/atomic_rate.cu).

Bounds: every bound that benchmark/roofline.py has is imported from there
(a change to the program cannot move them); the four it lacks are here,
each stated as roofline.py's arithmetic with the difference named
(merge_slab_bound, pair_bound, k2_atomic_floor_ms, targets_bound). A bound is
roofline.bound_ms(bytes, seconds of operations). Inputs: batch_points and
make_batch (a synthetic batch), lap_batch (a batch of the benchmark's lap).

Trees: use_root(DIR) puts the checkout at DIR first on the path, so that
gvom_tpu_torch imports from it (unpack the parent commit there with git
archive, into a directory that .gitignore lists); parent_build and
variant_build build one kernel of another checkout, or the committed source
with some of its text replaced, beside this tree's, each a library of its
own.
"""

import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(1, str(ROOT))

from benchmark.roofline import (F32, F32_OPS_PER_S, MERGE_OPS, bound_ms, combine_bound,  # noqa: E402,F401
                                epilogue_bound, guess_bound, k1_bound, k2_bound, merge_bound, plane_fit_bound,
                                prep_bound)

GRAPH_CALLS = 10        # calls of fn captured in one graph by graph_ms
LIDAR = dict(channels=128, azimuth_steps=2048)   # an OS1-128 sweep; its returns are cut to max_points
DISTINCT, BATCH = 8, 32  # the distinct synthetic scans, and the scans of a batched step made from them
# the atomic-rate probe: 2^26 scattered atomics into 2^22 words, the size of one 256×256×64 int32 grid
# (L2-resident, as K1's and K2's targets mostly are). The data sheet gives no atomic rate.
ATOMIC_PROBE_WORDS, ATOMIC_PROBE_OPS = 1 << 22, 1 << 26


def use_root(root):
    """Import gvom_tpu_torch from the checkout at root (this one by default):
    it goes first on the path. Returns its resolved path."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    return root


_CAPTURE = []   # graph_ms's capture stream, made at its first call


def graph_ms(fn, reps):
    """The card's time for what fn() launches, alone: GRAPH_CALLS calls
    captured in one CUDA graph (fills and small launches included, no host
    in between), replayed until about reps calls ran, timed with CUDA
    events. fn runs once on the capture stream first, so that what a
    wrapper keeps a stream exists before the capture."""
    import torch

    if not _CAPTURE:
        _CAPTURE.append(torch.cuda.Stream())
    stream = _CAPTURE[0]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        for _ in range(GRAPH_CALLS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    n = max(2, reps // GRAPH_CALLS)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * GRAPH_CALLS)


def cuda_ms(fn, reps, warm=3):
    """Mean device time of fn() over reps calls after warm ones, paced by
    the host: allocations and launch overhead included."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def turns(fns, order, reps):
    """{name: [ms, ...]}: fns[name] timed by graph_ms (reps calls, the
    launches alone) once each time its name comes in order."""
    t = {name: [] for name in fns}
    for name in order:
        t[name].append(graph_ms(fns[name], reps))
    return t


def atomic_rates(kernels, dev):
    """Scattered, uncontended global atomics a second on this card: int32,
    float32 and 16-byte float4 adds (a float4 op adds to a group of four
    words), ATOMIC_PROBE_OPS of them into ATOMIC_PROBE_WORDS words. The
    probe is this checkout's csrc/atomic_rate.cu, built by the imported
    kernels module."""
    import torch

    probe = kernels.CudaKernel("atomic_rate", "atomic_rate.cu", "gvom_atomic_rate",
                               [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
                               "not a TPU kernel: a probe of the card's atomic rate")
    probe.source = ROOT / "gvom_tpu_torch" / "csrc" / "atomic_rate.cu"
    rates = {}
    for name, dtype, mode in (("int32", torch.int32, 0), ("float32", torch.float32, 1),
                              ("float32x4", torch.float32, 2)):
        buf = torch.zeros(ATOMIC_PROBE_WORDS, dtype=dtype, device=dev)
        ms = cuda_ms(lambda: probe.launch(kernels._ptr(buf), ATOMIC_PROBE_WORDS.bit_length() - 1, ATOMIC_PROBE_OPS,
                                          mode, kernels._stream()), 5, warm=1)
        rates[name] = ATOMIC_PROBE_OPS / (1e-3 * ms)
    return rates


def k2_atomic_floor_ms(n_grid, n_win, rates):
    """Not a bound of the function, so not in roofline.py: the floor of a K2
    that merges no adds, at the probe's uncontended rates. One int32 atomic
    a point for hit and one for min_height, and, a point in the window, its
    flush's four reductions (n and channel 9 as float32 adds, channels 1-8
    as two float4 adds)."""
    return 1e3 * (2 * n_grid / rates["int32"] + 2 * n_win / rates["float32"] + 2 * n_win / rates["float32x4"])


def pair_bound(n_points, n_kept, n_out, epilogue_ops_s):
    """K2 then an epilogue, whatever implements them: roofline.k2_bound and
    roofline.epilogue_bound with the sums scratch between the two left out
    (it is the implementation's choice). The points (12 bytes) and keep (1)
    read, hit, min_height and the ten moment channels written; K2's 30
    operations a kept point and the epilogue's (epilogue_bound's seconds of
    operations, epilogue_ops_s). Returns (bytes, seconds of operations)."""
    return n_points * 13 + 12 * n_out * F32, 30 * n_kept / F32_OPS_PER_S + epilogue_ops_s


def targets_bound(cfg, n_w, targets_w, n_out):
    """K5 in targets only (kernels.moments_epilogue(occupancy_mask="targets")):
    roofline.epilogue_bound with the mask on, less the ten channels' stores
    off the targets (targets_w, window layout), which it leaves unwritten.
    Returns (bytes, seconds of operations)."""
    nbytes, ops_s = epilogue_bound(cfg, n_w, targets_w, n_out, True)
    return nbytes - 10 * (n_out - int(targets_w.sum())) * F32, ops_s


def merge_slab_bound(cfg, world, contrib, y0):
    """roofline.merge_bound of the merge on a y-slab whose rows start at
    torus row y0 (world and contrib hold the slab's rows, as a slab rank
    does): the same words, with the windows' overlap and the merged
    occupancy taken at the slab's global rows (the port's merge twin and
    overlap mask take them as coords) and five [X, Ys] maps written. At y0 =
    0 on the full grid it is merge_bound. Returns (bytes, seconds of
    operations)."""
    import torch

    from gvom_tpu_torch.ops import grid as gridops
    from gvom_tpu_torch.parallel.sharding import merge_batch_plain

    X, Ys, Z = contrib.hit.shape
    V = X * Ys * Z
    dev = contrib.hit.device
    coords = tuple(torch.arange(a, a + n, dtype=torch.int32, device=dev) for a, n in ((0, X), (y0, Ys), (0, Z)))
    _, _, occ2 = merge_batch_plain(cfg, world, contrib, coords)
    om = gridops.overlap_mask(cfg, contrib.origin, world.grid.origin, coords)
    ow = om & world.valid
    words = (3 * V + 10 * int((contrib.hit > 0).sum()) + 2 * int(ow.sum())
             + 2 * int((ow & (world.grid.hit > 0) & occ2).sum()) + 10 * int((om & occ2).sum())
             + 14 * V + 5 * X * Ys + 3 + 3 + 3 + 1)
    return words * F32, MERGE_OPS * V / F32_OPS_PER_S


def _scan(job):
    """(points [max_points, 3] f32, valid) of the synthetic OS1-128 scan i of
    the composite terrain at ego, in the checkout at root."""
    root, i, ego, max_points = job
    sys.path.insert(0, root)
    from gvom_tpu_torch.io import synthetic

    return synthetic.pad_scan(synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego, seed=i, **LIDAR),
                              max_points)


def batch_points(root, cfg, cache=None):
    """(points [8, N, 3], valid [8, N], egos [8, 3] f32) numpy: DISTINCT
    synthetic scans of the upstream sweep, ego i at (0.3 + 1.3i, −0.2 + 0.7i,
    1.5 + 0.02i), made in worker processes; loaded from or written to the
    npz file `cache` where one is given."""
    import numpy as np

    if cache and os.path.exists(cache):
        z = np.load(cache)
        return z["points"], z["valid"], z["egos"]
    egos = [(0.3 + 1.3 * i, -0.2 + 0.7 * i, 1.5 + 0.02 * i) for i in range(DISTINCT)]
    with ProcessPoolExecutor(max_workers=min(DISTINCT, os.cpu_count() or 1), mp_context=get_context("spawn")) as ex:
        scans = list(ex.map(_scan, [(str(root), i, e, cfg.max_points) for i, e in enumerate(egos)]))
    out = (np.stack([p for p, _ in scans]), np.stack([v for _, v in scans]), np.asarray(egos, np.float32))
    if cache:
        np.savez(cache, points=out[0], valid=out[1], egos=out[2])
    return out


def make_batch(pts, valid, egos, step_index=1, batch=BATCH):
    """(points [batch, N, 3], valid, egos) of one batched step: the distinct
    scans repeated, egos advancing (0.02, 0.01, 0) m a scan from a start
    moved (0.3, 0.15, 0) m a step, each scan's points moved with its ego."""
    import torch

    dev = pts.device
    reps = torch.arange(batch, device=dev) % pts.shape[0]
    ego0 = egos[0] + step_index * torch.tensor([0.3, 0.15, 0.0], device=dev)
    begos = ego0[None, :] + torch.arange(batch, dtype=torch.float32, device=dev)[:, None] * torch.tensor(
        [0.02, 0.01, 0.0], device=dev)
    shift = begos - egos[reps]
    return (pts[reps] + shift[:, None, :]).contiguous(), valid[reps].contiguous(), begos.contiguous()


LAP_SEED = 3_000_000_019   # a seed of the benchmark lap's range noise (benchmark/scangen.py)


def lap_batch(config, scans, dev, seed=LAP_SEED):
    """(cfg, origin, points, keep) of the benchmark lap's scans [scans[0],
    scans[1]) (benchmark/scangen.make_lap, the drive benchmark/drives/lap.json)
    in the configuration benchmark/configs/<config>.json, prepared as the
    batched step prepares them."""
    import json

    from benchmark import scangen
    from gvom_tpu_torch import GvomConfig
    from gvom_tpu_torch.parallel.sharding import prepare_batch

    conf = json.loads((ROOT / "benchmark/configs" / f"{config}.json").read_text())
    drive = json.loads((ROOT / "benchmark/drives/lap.json").read_text())
    made = scangen.make_lap(conf["sensor"], drive, conf["gvom"]["ground_to_lidar_height"], seed, dev)
    cfg = GvomConfig.from_dict(conf["gvom"])
    b = slice(*scans)
    return (cfg,) + tuple(prepare_batch(cfg, made["points"][b], made["valid"][b], made["egos"][b]))


def recorded(kernels, name, fn, keep):
    """keep(*args) of the last call of kernels.<name> that fn() makes."""
    calls, wrapped = [], getattr(kernels, name)

    def record(*args):
        calls.append(keep(*args))
        return wrapped(*args)

    setattr(kernels, name, record)
    try:
        fn()
    finally:
        setattr(kernels, name, wrapped)
    return calls[-1]


def copy_grid(g):
    """A VoxelGrid of copies of g's tensors (the merge writes over its
    contribution)."""
    return type(g)(hit=g.hit.clone(), miss=g.miss.clone(), min_height=g.min_height.clone(), mom=g.mom.clone(),
                   origin=g.origin.clone())


def parent_build(kernels, k, parent):
    """k as the checkout at `parent` has its source, built as this tree builds k."""
    p = kernels.CudaKernel(k.name + "_parent", k.source.name, k.entry, k.argtypes, "the parent tree's kernel",
                           defines=k.defines)
    p.source = Path(parent).resolve() / "gvom_tpu_torch" / "csrc" / k.source.name
    return p


def variant_build(kernels, k, name, subs):
    """k with its source's text changed by subs, [(regular expression,
    replacement)], each of which must match exactly once; the headers the
    source includes from its own directory are copied beside it."""
    text = k.source.read_text()
    for pattern, repl in subs:
        text, n = re.subn(pattern, repl, text)
        if n != 1:
            raise SystemExit(f"{name}: {pattern!r} matches {n} times in {k.source}, not once")
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for header in re.findall(r'^\s*#include\s+"([^"]+)"', text, re.M):
        (kernels.BUILD_DIR / header).write_bytes((k.source.parent / header).read_bytes())
    src = kernels.BUILD_DIR / f"{name}.cu"
    src.write_text(text)
    v = kernels.CudaKernel(name, k.source.name, k.entry, k.argtypes, f"a variant of {k.source.name}",
                           defines=k.defines)
    v.source = src
    return v


def build(*ks):
    """Build every k's library, one nvcc each, all started together; returns
    each one's compiler report ("" where the library existed)."""
    return [k.finish_build(proc) for k, proc in [(k, k.start_build()) for k in ks]]


def ptxas(report, entries):
    """The lines of a compiler report that give the registers and spills of
    the kernels whose (mangled) names hold one of entries."""
    out, cur = [], None
    for line in report.splitlines():
        if "entry function" in line:
            cur = line.split("'")[1] if "'" in line else line
        elif cur and any(e in cur for e in entries) and ("registers" in line or "spill" in line):
            out.append(f"{next(e for e in entries if e in cur)}: {line.split(':', 1)[-1].strip()}")
    return out


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    except FileNotFoundError:
        return "nvidia-smi: no reading"
    return out.splitlines()[0] if out else "nvidia-smi: no reading"
