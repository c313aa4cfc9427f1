"""Process meshes on ``torch.distributed`` (counterpart of
``pyqsm_tpu/parallel/mesh.py``).

The JAX package lays one program over a device mesh; here every rank is a
process that calls the same entry point on the same inputs (SPMD) and gets
the same full result back, as the JAX package returns replicated outputs.
Work is split by rank, and the ranks exchange rows with two collectives:

- ``all_gather_rows`` — every rank's rows, concatenated in rank order
  (``jax.lax.all_gather(..., tiled=True)``);
- ``all_reduce_sum`` — the elementwise sum over ranks (``jax.lax.psum``).

Under NCCL they act on the device tensors. Under gloo they copy through
host memory explicitly: gloo's support for CUDA tensors is partial, and
NCCL refuses two ranks on one card, so gloo is how several ranks share a
card (and how the CPU tests run). The caller names the backend and the
device; nothing falls back from one to the other.

``launch`` spawns the ranks of one such program on this host.
"""

from __future__ import annotations

import contextlib
import math
import multiprocessing as mp
import pickle
import queue
import socket
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist

from pyqsm_tpu_torch.device import DEFAULT_DEVICE, resolve_device


class Mesh(NamedTuple):
    """This rank's view of a process mesh: the process group (None = the
    default group), the axis names and sizes (their product is the group's
    size; ranks are laid out row-major over the axes) and the device this
    rank computes on."""

    group: object
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device

    @property
    def size(self) -> int:
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    def coords(self) -> dict[str, int]:
        """This rank's index along each axis."""
        out, r = {}, self.rank
        for name, size in zip(reversed(self.axis_names), reversed(self.axis_sizes)):
            r, out[name] = divmod(r, size)
        return {n: out[n] for n in self.axis_names}


def _rank_device(device: str | torch.device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def _group_size(group) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs an initialised torch.distributed process group "
                           "(see launch)")
    return dist.get_world_size(group)


def make_mesh(axis_sizes: dict[str, int] | None = None, group=None,
              device: str | torch.device = DEFAULT_DEVICE) -> Mesh:
    """Mesh over the whole process group. Default: one axis, ``("points",)``.
    ``device``: ``cuda`` puts rank r on ``cuda:(r % device_count)``; pass
    ``cpu`` to compute on the CPU. Raises when no process group is
    initialised."""
    n = _group_size(group)
    if axis_sizes is None:
        axis_sizes = {"points": n}
    names = tuple(axis_sizes)
    sizes = tuple(int(axis_sizes[a]) for a in names)
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {axis_sizes} != {n} ranks")
    return Mesh(group, names, sizes, _rank_device(device))


def tree_points_mesh(n_trees_axis: int | None = None, group=None,
                     device: str | torch.device = DEFAULT_DEVICE) -> Mesh:
    """``("trees", "points")`` mesh: trees over the first axis, one tree's
    points over the second. Defaults to trees=2 when the rank count is
    even, else trees=1."""
    n = _group_size(group)
    if n_trees_axis is None:
        n_trees_axis = 2 if n % 2 == 0 and n >= 2 else 1
    return make_mesh({"trees": n_trees_axis, "points": n // n_trees_axis}, group, device)


def shard_tree_batch(arr: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a [T, N, ...] tree-batch array on its device:
    trees split over the ``trees`` axis, points over the ``points`` axis
    (an absent axis has size 1), feature dims whole."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    coords = mesh.coords()
    out = arr
    for dim, name in enumerate(("trees", "points")):
        k = sizes.get(name, 1)
        if out.shape[dim] % k:
            raise ValueError(f"axis {dim} of {tuple(arr.shape)} does not split over "
                             f"{name}={k}")
        step = out.shape[dim] // k
        out = out.narrow(dim, coords.get(name, 0) * step, step)
    return out.to(mesh.device).contiguous()


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, on ``x``'s device."""
    if x.dtype == torch.bool:  # sent as bytes: not every backend takes bool
        return all_gather_rows(x.to(torch.uint8), mesh).to(torch.bool)
    if mesh.backend == "nccl":
        out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
        return out
    host = x.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(mesh.size)]
    dist.all_gather(parts, host, group=mesh.group)
    return torch.cat(parts, dim=0).to(x.device)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise sum of every rank's ``x``, on ``x``'s device."""
    if mesh.backend == "nccl":
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        return out
    host = x.detach().cpu().clone()
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
    return host.to(x.device)


def _to_cpu(obj):
    """Tensors inside tuples, lists, dicts and NamedTuples moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_cpu(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, world_size, backend, addr, device, fn, args, results):
    try:
        torch.set_num_threads(1)  # ranks share the host's cores
        dist.init_process_group(backend, init_method=addr, world_size=world_size, rank=rank)
        try:
            mesh = make_mesh(device=device)
            if mesh.device.type == "cuda":
                torch.cuda.set_device(mesh.device)
            out = fn(*args, mesh=mesh)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(_to_cpu(out))))
    except Exception:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(fn, world_size: int, backend: str, args: tuple = (),
           device: str | torch.device = DEFAULT_DEVICE, timeout: float = 600.0) -> list:
    """Run ``fn(*args, mesh=mesh)`` on ``world_size`` spawned ranks
    of one process group (``backend``: ``nccl`` or ``gloo``; the store is
    on localhost) and return each rank's result, in rank order, with its
    tensors on the CPU. Rank r computes on ``cuda:(r % device_count)``, or
    on the CPU when ``device`` is ``cpu``; each rank runs torch on one
    thread. ``fn`` must be importable by name (a module-level
    function) and its results picklable. Raises with the rank's traceback
    when a rank fails, or when the ranks do not finish within ``timeout``
    seconds; every rank is stopped before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    addr = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, addr, str(device), fn, args,
                               results), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that reports exits 0 after its result is queued; a
                # nonzero exit means it died first (e.g. could not import ``fn``)
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode]
                if dead:
                    raise RuntimeError(f"launch: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"launch: {world_size - len(out)} of {world_size} ranks "
                                       f"gave no result within {timeout:g} s") from None
                continue
            if not ok:
                # one rank's failure breaks its peers' collectives: gather
                # every report for a moment, so that the first cause shows
                errors = {rank: payload}
                with contextlib.suppress(queue.Empty):
                    while len(errors) + len(out) < world_size:
                        r, ok_r, msg = results.get(timeout=2.0)
                        if not ok_r:
                            errors[r] = msg
                raise RuntimeError("launch: " + "\n".join(
                    f"rank {r} failed:\n{errors[r]}" for r in sorted(errors)))
            out[rank] = pickle.loads(payload)
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world_size else 0)
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(world_size)]
