"""The (data, space) mesh over torch.distributed, and the start of its ranks.

Counterpart of gvom_tpu/parallel/mesh.py. The JAX package scales out on two
axes:

  data  — scan-level parallelism: the scans of a batch split over the data
          ranks; the per-voxel accumulators are associative, so they are
          summed (all_reduce) over the data axis
  space — spatial sharding: each space rank owns a y-slab of the world grid

A rank is one process with one device. Rank r sits at (r // space, r % space),
as the JAX package reshapes its device list to (data, space). Beside the world
group each rank belongs to two process groups: its data group (the ranks of
its space index, over which the data axis reduces) and its space group (the
ranks of its data index, over which the slabs are gathered).

Backends, with no silent fallback (resolve_backend):
  * NCCL, one card per rank: the default on cards;
  * gloo with device="cuda": several ranks on one card (NCCL refuses two ranks
    on one device), named by the caller;
  * gloo on the CPU, as the tests run it.
Gloo reduces in host memory: it moves a CUDA tensor through the host inside
each collective (torch 2.11's gloo takes CUDA tensors in every collective used
here, so none is staged by hand). Mesh.host_bytes counts the bytes of the CUDA
tensors handed to gloo's collectives, in and out.
"""

from __future__ import annotations

import datetime
import math
import os
import socket
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gvom_tpu_torch.types import resolve_device

__all__ = ["DATA_AXIS", "SPACE_AXIS", "Mesh", "factor_devices", "resolve_backend", "init_distributed",
           "shutdown", "make_mesh", "run_ranks", "rank_args"]

DATA_AXIS = "data"
SPACE_AXIS = "space"


def factor_devices(n: int, space: Optional[int] = None) -> Tuple[int, int]:
    """Split n devices into (data, space). Space defaults to the largest
    power-of-two divisor ≤ sqrt(n) so halo surface stays small."""
    if space is None:
        space = 1
        while space * 2 <= int(math.sqrt(n)) and n % (space * 2) == 0:
            space *= 2
    if n % space != 0:
        raise ValueError(f"{n} devices not divisible by space={space}")
    return n // space, space


def resolve_backend(num_processes: int, device="cuda", backend: Optional[str] = None) -> str:
    """The process-group backend of num_processes ranks on `device`.

    On the CPU: gloo. On cards: NCCL when every rank has a card of its own
    (backend None or "nccl"), else a RuntimeError that names
    backend="gloo", the explicit way to put several ranks on one card."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: the CPU ranks take gloo")
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: the mesh runs on 'cuda' or 'cpu'")
    if backend == "gloo":
        return "gloo"
    if backend not in (None, "nccl"):
        raise ValueError(f"unknown backend {backend!r}: 'nccl' or 'gloo'")
    cards = torch.cuda.device_count()
    if num_processes > cards:
        raise RuntimeError(
            f"{num_processes} ranks and {cards} CUDA device(s): NCCL needs a card for each rank; "
            f"pass backend='gloo' to put several ranks on one card")
    return "nccl"


def _rank_device(device, rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None, device="cuda",
                     timeout_s: float = 300.0) -> Optional[str]:
    """Start this process's rank in the default process group.

    A no-op without a coordinator for at most one process, as in JAX:
    make_mesh then builds a mesh of one rank with no process group. With a
    coordinator ("host:port", or a URL such as tcp://host:port or
    file:///path) it starts the group, for one process too. Returns the
    backend (resolve_backend), or None for the no-op. A collective that waits
    longer than timeout_s raises."""
    if coordinator is None and (num_processes is None or num_processes <= 1):
        return None
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs a coordinator, num_processes and process_id")
    backend = resolve_backend(num_processes, device, backend)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(_rank_device(device, process_id))
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def shutdown() -> None:
    """End this rank's part in the default process group: wait for every
    rank, then tear the group down, so that no rank exits (rank 0 takes the
    group's store with it) while another still talks to the group."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


class Mesh:
    """This rank's place in a (data, space) mesh: `shape` (data, space), its
    `rank`, `device` and `backend`, and the process groups of its data and
    space axes (none on a mesh of one rank made without a process group,
    whose collectives return their input).

    The collectives take and return tensors on this rank's device; `axis` is
    DATA_AXIS, SPACE_AXIS or None for every rank. Ranks are ordered within a
    group by their index along its axis, so a gather concatenates in mesh
    order."""

    def __init__(self, shape: Tuple[int, int], rank: int, device: torch.device, backend: Optional[str],
                 groups: Optional[dict]):
        self.shape = tuple(shape)
        self.rank = rank
        self.device = device
        self.backend = backend
        self._groups = groups
        self.host_bytes = 0     # bytes of CUDA tensors handed to gloo's collectives, in and out

    @classmethod
    def single(cls, device) -> "Mesh":
        """A mesh of one rank with no process group."""
        return cls((1, 1), 0, resolve_device(device), None, None)

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def space_index(self) -> int:
        return self.rank % self.shape[1]

    def axis_size(self, axis: Optional[str]) -> int:
        return {DATA_AXIS: self.shape[0], SPACE_AXIS: self.shape[1], None: self.size}[axis]

    def _count(self, *tensors) -> None:
        if self.backend == "gloo" and self.device.type == "cuda":
            self.host_bytes += sum(t.numel() * t.element_size() for t in tensors)

    def all_reduce(self, t: torch.Tensor, op: str = "sum", axis: Optional[str] = None) -> torch.Tensor:
        """The elementwise sum ("sum") or minimum ("min") of t over the axis."""
        if self._groups is None:
            return t
        out = t.contiguous().clone()
        dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}[op],
                        group=self._groups[axis])
        self._count(out, out)
        return out

    def all_gather(self, t: torch.Tensor, axis: Optional[str], dim: int) -> torch.Tensor:
        """The axis's tensors concatenated along dim, in mesh order."""
        if self._groups is None:
            return t
        x = t.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, x, group=self._groups[axis])
        self._count(x, *parts)
        return torch.cat(parts, dim)

    def reduce_scatter(self, t: torch.Tensor, axis: Optional[str], dim: int) -> torch.Tensor:
        """The sum of t over the axis, cut along dim into equal parts, this
        rank's part (its index along the axis)."""
        if self._groups is None:
            return t
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // self.axis_size(axis),) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=self._groups[axis])
        self._count(x, out)
        return out.movedim(0, dim).contiguous()

    def barrier(self) -> None:
        if self._groups is not None:
            dist.barrier(group=self._groups[None])

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[0]}, space={self.shape[1]}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


def make_mesh(space: Optional[int] = None, device="cuda", backend: Optional[str] = None) -> Mesh:
    """The (data, space) mesh over the initialised default process group
    (init_distributed), factored by factor_devices; without one, the mesh of
    this one rank. `backend`, if given, must be the group's. On cards a rank
    takes card rank mod the card count (several gloo ranks share a card).

    Every rank must call make_mesh, in the same order as the others: each
    rank creates every group of the mesh, also those it is not in."""
    if not dist.is_initialized():
        factor_devices(1, space)
        return Mesh.single(device)
    n, rank, have = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"make_mesh(backend={backend!r}): the process group runs {have!r}")
    if have == "nccl" and torch.device(device).type != "cuda":
        raise ValueError(f"an NCCL process group and device {device!r}: NCCL runs on cards")
    data, sp = factor_devices(n, space)
    groups = {None: dist.group.WORLD}
    for s in range(sp):
        g = dist.new_group([d * sp + s for d in range(data)])
        if rank % sp == s:
            groups[DATA_AXIS] = g
    for d in range(data):
        g = dist.new_group([d * sp + s for s in range(sp)])
        if rank // sp == d:
            groups[SPACE_AXIS] = g
    return Mesh((data, sp), rank, _rank_device(device, rank), have, groups)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(argv: Sequence[str], n: int, timeout: float, env: Optional[dict] = None,
              cwd: Optional[str] = None) -> List[str]:
    """Run n ranks, each the process `argv` + ["--rank", r, "--world", n,
    "--coordinator", "localhost:PORT"], and return each one's output
    (stdout and stderr). Raises RuntimeError with a rank's output if it
    exits non-zero or the ranks are not all done after `timeout` seconds;
    every rank has ended when it returns or raises."""
    coordinator = f"localhost:{_free_port()}"
    env = dict(os.environ if env is None else env)
    env.setdefault("OMP_NUM_THREADS", "1")
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(n)]
    procs = [subprocess.Popen([*argv, "--rank", str(r), "--world", str(n), "--coordinator", coordinator],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=cwd, text=True)
             for r in range(n)]
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.returncode not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        if failed is None:
            failed = next((r for r, p in enumerate(procs) if p.returncode not in (None, 0)), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    if failed is not None:
        raise RuntimeError(f"rank {failed} of {n} exited with {procs[failed].returncode}:\n{outs[failed][-4000:]}")
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"{n} ranks not done after {timeout} s:\n{outs[0][-4000:]}")
    return outs


def rank_args(argv: Optional[Sequence[str]] = None):
    """(rank, world, coordinator, the other arguments) from a command line
    that run_ranks made."""
    import argparse

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    a, rest = ap.parse_known_args(argv)
    return a.rank, a.world, a.coordinator, rest

