"""The port's public surface holds the JAX package's: for every module of
gvom_tpu (read with ast, so no JAX function is imported or traced), each
name of its __all__ (without one: its public top-level functions and
classes, and a package's imported names), each public method and property
of the classes it exports (a JAX property may be a dataclass field of the
port's class) and each parameter of its functions and methods exists in the
port's counterpart module. LEFT_OUT lists, with a reason each, what the port
leaves out on purpose (ROADMAP.md §A keeps the same list); it must name
exactly what is missing, so it cannot go stale. A reason that names a port
object in backticks (`gvom_tpu_torch....`) names what takes its place, and
that object must exist."""

import ast
import dataclasses
import importlib
import inspect
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "gvom_tpu"

# the port's counterpart of a JAX module, where it is not the module at the same path
COUNTERPART = {"gvom_tpu.ops.pallas_kernels": "gvom_tpu_torch.ops.kernels"}

_PACKED = "a TPU layout helper: the port stores plain [X, Y, Z] grids and [10, X, Y, Z] moments"
_IMPL = "an implementation selector: the port takes the kernel on a card and the plain version on the CPU, by device"

# key: "module:name", "module:Class.member" or "module:function(parameter)"
LEFT_OUT = {
    "gvom_tpu.ops.grid:pack_yz": _PACKED,
    "gvom_tpu.ops.grid:unpack_yz": _PACKED,
    "gvom_tpu.ops.grid:reduce_z_packed": _PACKED,
    "gvom_tpu.ops.grid:expand_cols_packed": _PACKED,
    "gvom_tpu.ops.grid:overlap_mask_packed": _PACKED + "; the merge applies the overlap mask",
    "gvom_tpu.ops.grid:packed_z_coord": _PACKED,
    "gvom_tpu.ops.grid:align_to": "the port's grids are tori: windows align by masks (`gvom_tpu_torch.ops.grid."
                                  "overlap_mask`) and never move data",
    "gvom_tpu.ops.grid:shift_align": "the port's grids are tori: windows align by masks (`gvom_tpu_torch.ops.grid."
                                     "overlap_mask`) and never move data",
    "gvom_tpu.ops.moments:pack_moments": _PACKED,
    "gvom_tpu.ops.moments:unpack_moments": _PACKED,
    "gvom_tpu.ops.moments:packed_lanes": _PACKED,
    "gvom_tpu.ops.moments:packed_voxel_mask": _PACKED,
    "gvom_tpu.ops.moments:box_aggregate_moments(bins)": "the port takes the padded sums tensor "
                                                        "(`gvom_tpu_torch.ops.moments.box_aggregate_moments`)",
    "gvom_tpu.parallel:world_pspecs": "JAX PartitionSpecs; the port shards with `gvom_tpu_torch.parallel.shard_world`",
    "gvom_tpu.parallel.sharding:world_pspecs": "JAX PartitionSpecs; the port shards with "
                                               "`gvom_tpu_torch.parallel.sharding.shard_world`",
    "gvom_tpu.parallel.mesh:make_mesh(devices)": "a list of JAX devices; the port's mesh is one process a device "
                                                 "over torch.distributed (`gvom_tpu_torch.parallel.mesh.make_mesh`)",
    "gvom_tpu.ops.maps2d:positive_obstacle_map": "composed of `gvom_tpu_torch.ops.maps2d.positive_band_sums` and "
                                                 "`gvom_tpu_torch.ops.maps2d.positive_obstacle_from_band`",
    "gvom_tpu.ops.maps2d:slope_and_roughness": "folded into `gvom_tpu_torch.ops.maps2d.plane_fit_window_plain`",
    "gvom_tpu.ops.maps2d:guess_height_delta": "folded into `gvom_tpu_torch.ops.maps2d.guess_products_plain`",
    "gvom_tpu.ops.raycast:ray_pass_counts_xla": "kept as `gvom_tpu_torch.ops.raycast.ray_pass_counts_plain`",
    "gvom_tpu.ops.binning:slab_point_moments": "kept in `gvom_tpu_torch.ops.moments.slab_point_moments`",
    "gvom_tpu.ops.pallas_kernels:use_fast_path": "the TPU backend query; the port takes a kernel for a CUDA tensor "
                                                 "and its plain version for a CPU tensor (`gvom_tpu_torch.ops."
                                                 "kernels.ray_pass_counts`)",
    "gvom_tpu.ops.pallas_kernels:ray_pass_counts_matmul": "kept as `gvom_tpu_torch.ops.kernels.ray_pass_counts`",
    "gvom_tpu.types:VoxelGrid.from_logical": "the JAX mom passes through in its packed 128-lane layout; the port's "
                                             "`gvom_tpu_torch.types.VoxelGrid` holds the logical layout",
    "gvom_tpu.types:WorldState.from_logical": "the JAX mom passes through in its packed 128-lane layout; the port's "
                                              "`gvom_tpu_torch.types.WorldState` holds the logical layout",
    "gvom_tpu.utils.profiling:profile_trace(host_tracer_level)": "a JAX profiler option; the port traces with "
                                                                 "torch.profiler",
    "gvom_tpu.engine.gvom:Gvom.__init__(raycast_impl)": _IMPL,
    "gvom_tpu.engine.node:VoxelMapperNode.__init__(raycast_impl)": _IMPL,
    "gvom_tpu.engine.replay:sequential_replay(raycast_impl)": _IMPL,
    "gvom_tpu.engine.replay:batched_replay(raycast_impl)": _IMPL,
    "gvom_tpu.models.pipeline:ingest_scan(raycast_impl)": _IMPL,
    "gvom_tpu.models.pipeline:ingest_scan(binning_impl)": _IMPL,
    "gvom_tpu.models.pipeline:ingest_and_insert(raycast_impl)": _IMPL,
    "gvom_tpu.models.pipeline:combine(impl)": _IMPL,
    "gvom_tpu.models.pipeline:full_step(raycast_impl)": _IMPL,
    "gvom_tpu.ops.raycast:ray_pass_counts(impl)": _IMPL,
    "gvom_tpu.parallel.sharding:make_batched_step(raycast_impl)": _IMPL,
    "gvom_tpu.parallel.sharding:batched_step(raycast_impl)": _IMPL,
}


def _module_name(path: Path) -> str:
    return ".".join(path.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")


MODULES = sorted(_module_name(p) for p in JAX_PKG.rglob("*.py"))


def _exported(tree: ast.Module, package: bool) -> set:
    """__all__ (every assignment of it: a package may set it in both arms of
    a try), else the public top-level functions and classes and, in a
    package, the names it imports."""
    names = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            names = (names or set()) | {ast.literal_eval(e) for e in node.value.elts}
    if names is not None:
        return names
    names = {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}
    if package:
        names |= {a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom) for a in n.names}
    return names


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _is_property(fn: ast.FunctionDef) -> bool:
    return any(isinstance(d, ast.Name) and d.id in ("property", "cached_property") for d in fn.decorator_list)


def _surface(module: str) -> list:
    """(key, check) of every name, member and parameter the JAX module
    exposes; check(port_module) says whether the port has it (None: not
    asked, the function or method is missing)."""
    path = JAX_PKG.joinpath(*module.split(".")[1:])
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    tree = ast.parse(path.read_text())
    names = _exported(tree, path.name == "__init__.py")
    out = [(f"{module}:{n}", lambda pm, n=n: hasattr(pm, n)) for n in sorted(names)]
    for node in tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or node.name not in names:
            continue
        if isinstance(node, ast.FunctionDef):
            out += [(f"{module}:{node.name}({p})", lambda pm, f=node.name, p=p: _has_param(getattr(pm, f, None), p))
                    for p in _params(node)]
            continue
        for m in node.body:
            if not isinstance(m, ast.FunctionDef) or (m.name.startswith("_") and m.name != "__init__"):
                continue
            if m.name != "__init__":
                out.append((f"{module}:{node.name}.{m.name}",
                            lambda pm, c=node.name, m=m.name: _has_member(getattr(pm, c, None), m)))
            if not _is_property(m):
                out += [(f"{module}:{node.name}.{m.name}({p})",
                         lambda pm, c=node.name, m=m.name, p=p: _has_param(_method(getattr(pm, c, None), m), p))
                        for p in _params(m)]
    return out


def _fields(cls) -> set:
    names = set(getattr(cls, "_fields", ()))
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    return names


def _has_member(cls, name: str) -> bool:
    return cls is not None and (hasattr(cls, name) or name in _fields(cls))


def _method(cls, name: str):
    if cls is None:
        return None
    return cls if name == "__init__" else getattr(cls, name, None)


def _has_param(fn, name: str):
    """Whether fn takes the parameter; None where fn itself is missing (its
    own key says so)."""
    if fn is None:
        return None
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _port_object(dotted: str):
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for p in parts[i:]:
            obj = getattr(obj, p)
        return obj
    raise ImportError(dotted)


@pytest.mark.parametrize("module", MODULES)
def test_port_has_the_jax_modules_public_surface(module):
    port = importlib.import_module(COUNTERPART.get(module, module.replace("gvom_tpu", "gvom_tpu_torch", 1)))
    surface = _surface(module)
    missing = {key for key, has in surface if has(port) is False}
    left_out = {k for k in LEFT_OUT if k.split(":")[0] == module}
    assert sorted(missing - left_out) == [], "missing from the port and not in LEFT_OUT"
    assert sorted(left_out - missing) == [], "in LEFT_OUT but present in the port, or not a public JAX name"
    for key in sorted(left_out):
        reason = LEFT_OUT[key]
        assert reason, key
        for dotted in re.findall(r"`(gvom_tpu_torch(?:\.\w+)+)`", reason):
            _port_object(dotted)     # what takes its place exists
