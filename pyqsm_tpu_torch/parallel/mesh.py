"""Process meshes on ``torch.distributed`` (counterpart of
``pyqsm_tpu/parallel/mesh.py``).

The JAX package lays one program over a device mesh; here every rank is a
process that calls the same entry point on the same inputs (SPMD) and gets
the same full result back, as the JAX package returns replicated outputs.
Work is split by rank, and the ranks exchange rows with three collectives,
over the whole mesh or along one of its axes:

- ``all_gather_rows`` — every rank's rows, concatenated in rank order
  (``jax.lax.all_gather(..., tiled=True)``);
- ``all_reduce_sum`` — the elementwise sum over ranks (``jax.lax.psum``);
- ``ring_shift`` — each rank's tensor to its right neighbour along an axis
  (``jax.lax.ppermute`` with ``perm = [(i, i + 1 mod n)]``).

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
    size; ranks are laid out row-major over the axes), the device this
    rank computes on and, for each axis, the global ranks of this rank's
    row along it (in axis order) and that row's process group."""

    group: object
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device
    axis_ranks: dict = {}
    axis_groups: dict = {}

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

    def axis_size(self, axis: str | None = None) -> int:
        return self.size if axis is None else self.axis_sizes[self.axis_names.index(axis)]

    def axis_index(self, axis: str | None = None) -> int:
        return self.rank if axis is None else self.coords()[axis]

    def axis_group(self, axis: str | None = None):
        return self.group if axis is None else self.axis_groups[axis]


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
    me = dist.get_rank(group)
    glob = [r if group is None else dist.get_global_rank(group, r) for r in range(n)]
    axis_ranks, axis_groups = {}, {}
    for a, size in enumerate(sizes):
        stride = math.prod(sizes[a + 1:])
        # the rows along axis a: ranks that agree on every other coordinate,
        # each created by every rank in the same order (NCCL requires it);
        # an axis spanning the whole mesh uses the mesh's group
        for base in range(n):
            if (base // stride) % size:
                continue
            row = [glob[base + i * stride] for i in range(size)]
            g = group if size == n else dist.new_group(row)
            if glob[me] in row:
                axis_ranks[names[a]], axis_groups[names[a]] = tuple(row), g
    return Mesh(group, names, sizes, _rank_device(device), axis_ranks, axis_groups)


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


def all_gather_rows(x: torch.Tensor, mesh: Mesh, axis: str | None = None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, over the whole mesh or along ``axis`` (this rank's row of it),
    on ``x``'s device."""
    if x.dtype == torch.bool:  # sent as bytes: not every backend takes bool
        return all_gather_rows(x.to(torch.uint8), mesh, axis).to(torch.bool)
    group, size = mesh.axis_group(axis), mesh.axis_size(axis)
    if mesh.backend == "nccl":
        out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out
    host = x.detach().cpu().contiguous()
    parts = [torch.empty_like(host) for _ in range(size)]
    dist.all_gather(parts, host, group=group)
    return torch.cat(parts, dim=0).to(x.device)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str | None = None) -> torch.Tensor:
    """The elementwise sum of every rank's ``x``, over the whole mesh or
    along ``axis``, on ``x``'s device."""
    group = mesh.axis_group(axis)
    if mesh.backend == "nccl":
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out
    host = x.detach().cpu().clone()
    dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
    return host.to(x.device)


def ring_shift(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ``x`` of this rank's left neighbour along ``axis`` (index
    i − 1 mod n), each rank sending its own to the right: one
    ``batch_isend_irecv`` pair, on ``x``'s device."""
    if x.dtype == torch.bool:
        return ring_shift(x.to(torch.uint8), mesh, axis).to(torch.bool)
    row, i = mesh.axis_ranks[axis], mesh.axis_index(axis)
    n = len(row)
    if n == 1:
        return x.clone()
    send = x.contiguous() if mesh.backend == "nccl" else x.detach().cpu().contiguous()
    recv = torch.empty_like(send)
    group = mesh.axis_group(axis)
    ops = [dist.P2POp(dist.isend, send, row[(i + 1) % n], group),
           dist.P2POp(dist.irecv, recv, row[(i - 1) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device)


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
