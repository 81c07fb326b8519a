#!/usr/bin/env python3
"""How the moments epilogue (gvom_tpu_torch/csrc/epilogue.cu, kernels K3 and
K5) depends on the blocks it keeps in flight, on one NVIDIA GPU.

    python3 scripts/epilogue_occupancy.py

Builds the source as committed and with its `__launch_bounds__(THREADS, 4)`
taken out or set to (THREADS, 2), (THREADS, 3) and (THREADS, 6), prints what
ptxas reports for each (registers, spills), and times each on one synthetic
scan at the upstream deployment (256×256×64, 131,072 points) with the
occupancy mask on (K3's form) and off (K5's form), twice over, with CUDA
events. The sums are K2's: n and channels 1-9 in its scratch, zero where n
is 0 (the kernel reads them only where n > 0). The variants are
checked against the committed build bit for bit (each target sums in a
fixed order). A block takes about 50 KB of shared memory, so an SM holds at
most four whatever the bound; the bound sets the registers and the spills.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BOUNDS = {"none": "__launch_bounds__(THREADS) ", "(256, 2)": "__launch_bounds__(THREADS, 2) ",
          "(256, 3)": "__launch_bounds__(THREADS, 3) ", "(256, 4) as committed": None,
          "(256, 6)": "__launch_bounds__(THREADS, 6) "}
COMMITTED = "__launch_bounds__(THREADS, 4) "


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("epilogue_occupancy: no CUDA device is available", file=sys.stderr)
        return 2
    from gvom_tpu_torch import GvomConfig
    from gvom_tpu_torch.io import synthetic
    from gvom_tpu_torch.ops import binning, kernels
    from gvom_tpu_torch.ops import grid as gridops

    cfg = GvomConfig()
    dev = torch.device("cuda")
    ego = (0.3, -0.2, 1.5)
    pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego, seed=0, channels=128, azimuth_steps=2048)
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    e = torch.tensor(ego, dtype=torch.float32, device=dev)
    pw, keep = binning.prepare_points(cfg, torch.from_numpy(pad).to(dev), torch.from_numpy(mask).to(dev), e)
    origin = gridops.compute_origin(cfg, e)
    bins = kernels.bin_points(cfg, pw, keep, origin)
    X, Y, Z = cfg.grid_shape
    rx, ry, rz = binning.moment_pad(cfg)
    out = torch.empty((1, 10, X, Y, Z), dtype=torch.float32, device=dev)
    source = kernels.EPI.source.read_text()
    assert COMMITTED in source, "the committed launch bound has changed: bring this script up to date"

    def ms(fn, reps=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    fns, ref = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, bound in BOUNDS.items():
            cu = Path(tmp) / f"epilogue_{len(fns)}.cu"
            cu.write_text(source if bound is None else source.replace(COMMITTED, bound))
            so = cu.with_suffix(".so")
            r = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                print(r.stdout + r.stderr, file=sys.stderr)
                return 1
            for line in (r.stdout + r.stderr).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas, launch bounds {name}: {line.strip()}")
            f = getattr(ctypes.CDLL(str(so)), kernels.EPI.entry)
            f.argtypes = kernels.EPI.argtypes
            f.restype = ctypes.c_int
            fns[name] = f

        def call(f, masked):
            rc = f(kernels._ptr(bins.n), kernels._ptr(bins.rest), kernels._ptr(bins.hit), kernels._ptr(origin), None,
                   X, Y, Z, rx, ry, rz, 0, Y, masked, kernels._ptr(out), None, kernels._stream())
            assert rc == 0, rc

        for masked in (1, 0):
            call(fns["(256, 4) as committed"], masked)
            ref[masked] = out.clone()
        for rnd in range(2):
            for name, f in fns.items():
                for masked in (1, 0):
                    call(f, masked)
                    same = bool((out == ref[masked]).all())
                    t = ms(lambda: call(f, masked))
                    print(f"round {rnd}, launch bounds {name}, mask {'on' if masked else 'off'}: {t:.4f} ms, "
                          f"equal to the committed build: {same}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
