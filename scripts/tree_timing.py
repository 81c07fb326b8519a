"""Builds of a kernel beside the committed one, and their times in turns, for
the scripts that time a kernel against another tree's or a variant's on one
NVIDIA GPU (scripts/time_guess_routes.py, scripts/time_wide_forms.py).

A build is a gvom_tpu_torch.ops.kernels.CudaKernel with the committed
kernel's C entry, argument types and -D set, whose source is either the
same file of another checkout (parent_build: unpack the parent commit with
git archive into a directory that .gitignore lists) or the committed source
with some of its text replaced (variant_build, written under the package's
_build/ directory). Each build is a library of its own.
"""

import re
import subprocess
from pathlib import Path


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


def turns(fns, order, reps):
    """{name: [ms, ...]}: fns[name] timed by chip_smoke.graph_ms (reps
    calls, the launches alone) once each time its name comes in order."""
    import chip_smoke

    t = {name: [] for name in fns}
    for name in order:
        t[name].append(chip_smoke.graph_ms(fns[name], reps)[0])
    return t


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
