#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pyqsm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--points N] [--seed S]

Phases, each printing lines with the elapsed seconds:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: one ``nvcc`` per kernel source, all started together, for sm_90a
   (``csrc/band_matvec.cu``, ``csrc/band_matvec_t.cu``, ``csrc/mt_raycast.cu``,
   ``csrc/band_matvec_bf16.cu``; ptxas registers, shared memory and spills of
   each, and the dynamic shared memory of a ``band_matvec_bf16`` block);
3. kernel: ``band_matvec`` and ``band_matvec_t`` against their plain
   versions at the contraction's fine [8, 160, 256, 768] and coarse
   [8, 40, 256, 768] band shapes, timed with CUDA events beside their
   memory bound and one ``torch.bmm`` of the same tiles;
4. reference: ``process_plot`` on a small two-tree plot on the card and on
   the CPU (the port's plain path) — same tree ids and point counts;
5. main path: ``process_plot`` on a synthetic plot (the bench's layout and
   settings: 8 trees, 40 000-point skeleton cap) with every kernel launch
   counter set to 0 just before and read just after; then the same call
   again, which must give equal labels and cylinders bit for bit (the
   segment sums are deterministic on the card);
6. Lᵀ path: ``laplacian_rmatvec`` on a banded Laplacian at the fine width
   with its Wᵀ band dropped (through ``band_matvec_t``) against the Wᵀ-band
   route (through ``band_matvec``), counters set to 0 just before;
7. raycast path: the main path's canopy (z > 6 m) meshed by
   ``poisson_like_mesh`` and decimated below 2048 triangles, then
   ``cast_scene`` (640×480), ``sun_exposure`` at elevations 30/60/90 with
   both backends, ``mri_slices``, ``sparse_cast_with_intersections`` and
   ``raycast_to_pcd``, counters set to 0 just before and read just after;
   then ``mri_slices`` again, timed steady;
8. kernel: ``mt_raycast`` against its plain version, all four outputs bit
   for bit, at the cast_scene, sun and occupancy (4096 points of one
   ``mri_slices`` slab) shapes on that mesh, timed beside the bound of the
   operations each shape's rays need, with the share of pairs that pass
   its early-out stages and the triangle slices of its plan; then its edge
   cases (duplicated triangles, T = 0, every row -1, R = 1, R off the ray
   tile, T beyond one block's shared memory) under the host's plan and
   forced ones, each bit for bit;
9. band-claim path: ``build_trees`` on the main path's plot with
   ``PYQSM_CLAIM=band`` and with the default (push), in turns, twice each
   (the second runs' seconds reported); the band claim must run, equal the
   push claim bit for bit (labels, order, cycles) and launch
   ``band_matvec_bf16`` once a cycle; then ``process_plot`` under
   ``PYQSM_CLAIM=band`` with the counters set to 0 just before — its trees
   and point counts must equal phase 5's;
10. kernel: ``band_matvec_bf16`` against its plain version at the claim's
   own shape ([1, rows/256, 256, 768], C = the run's cluster cap) and at
   C = 128 — 0/1 inputs exactly, random bf16 inputs within
   768·2⁻²⁴·Σ|W||x| — timed beside its byte bound and one ``torch.bmm`` of
   the bf16 windows; then every C in {16, 32, 64, 128} on 2 trees at
   nb = 1 and nb = 133, held to the same two checks;
11. sharded path: 4 ranks (``parallel.mesh.launch``; NCCL with one card a
   rank where the machine has 4 cards, else gloo with every rank on
   ``cuda:0``) run ``build_trees(mesh=)`` on the main path's plot under the
   default claim and under ``PYQSM_CLAIM=band`` — labels, order and cycles
   must equal phase 9's push and band runs bit for bit, and each rank must
   launch the halo form of ``band_matvec_bf16`` once a cycle — then
   ``process_plot(mesh=)`` under the band claim twice (the second, warm,
   reported) with each rank's counters set to 0 just before: phase 5's
   trees and point counts; each rank's gathered contraction rows equal,
   bit for bit, its block of 2 trees contracted alone on one device; rank
   0's single-device contraction of all 8 trees of the same batch gives
   phase 5's cylinders exactly; and each rank's cylinder counts and median
   radii lie within the tolerance stated there of phase 5's;
12. kernel: the halo (``prepadded``) form of ``band_matvec_bf16`` against
   its plain version at a rank's shape of phase 11 and at C = 128, with
   random halo blocks — 0/1 inputs exactly, random bf16 within
   768·2⁻²⁴·Σ|W||x| — timed beside its byte bound and one ``torch.bmm``
   of the prebuilt windows; then every C on 2 trees at nb = 1 and 133, as
   in phase 10;
13. canopy path: (a) ``process_plot(with_metrics=True)`` on the main
   path's plot with the counters set to 0 just before and read just after
   — phase 5's trees and cylinders bit for bit, phase 5's ``band_matvec``
   launches and no other, every tree's metrics with the JAX package's
   keys, disjoint classes covering its live batch rows, finite areas and
   widths ≥ 0 — then the same call again with ``canopy_metrics``' four
   parts timed, whose metrics must be equal bit for bit; (b) the single
   tree: ``skeletonize`` and ``canopy_metrics(shift=None)`` on the largest
   tree's contraction batch row (the ELL path: no kernel launch), with
   seconds, iterations and peak memory; (c) ``skeletonize`` and
   ``canopy_metrics`` on phase 4's two trees on the card and on the CPU —
   equal iteration counts, contracted points within 5e-3 m at the 99th
   percentile, class counts within 1 % of the live rows;
14. raycast grid path at the bench's scene (bench.py:364-470): phase 7's
   raw canopy mesh decimated to 400 000 triangles; (a) ``build_image_grid``
   + ``image_cast`` at 1280×950 (fov 60°, eye center + (0, -30, 18), up
   +z) on the kept and on the raw mesh, build, first and steady seconds and
   peak memory, the kept mesh's cast held against ``mt_raycast`` on the
   same rays (``image_rays``): the same rays hit, counts equal, t within
   1e-4 relative, tri differing on fewer than 1 % of hits; (b)
   ``cast_scene`` with the default config, which must take the image grid
   and equal a brute exposure of its rays within 1e-4; (c) an eye inside
   the canopy, whose residual pass must launch ``mt_raycast``, held
   against the brute kernel as in (a); (d) ``cell_cast_parallel`` along
   (0.3, 0.2, -0.93), 16 rays a cell side, timed, with the rays of 4096
   sampled cells held against the brute kernel; (e)
   ``build_grid3d_two_level`` timed, ``two_level_cast`` on the bench's
   10⁶-ray bundle (first and steady), its first 65 536 rays held against
   the brute kernel, and with ``count_all=True`` their counts equal to the
   brute's; (f) ``cast_rays(auto)``, ``occupancy`` (against the brute
   parity), ``sun_exposure`` at elevations 30/60/90 with both backends and
   ``mri_slices`` 8×64² on the kept mesh. Each drive of the path sets the
   counters to 0 just before and reads them just after. Then the image
   cast, the cell cast and ``grid_cast`` on a small scene on the card and
   on the CPU: tri and counts equal, t within 1e-6 relative;
15. wavefront and sharded casts on phase 14's scene: (a)
   ``two_level_cast(wavefront=True)`` on phase 14e's grid and 10⁶-ray
   bundle, first and steady call, seconds, Mrays/s, peak memory, host reads
   and (from a third call with ``debug=True``) its rounds and blocks; the
   same rays hit as in phase 14e's DDA, t equal bit for bit, tri equal but
   where two triangles give the same t (recomputed for each such ray); the
   same cast with ``tail_fallback=0`` (t bit for bit again), timed; (b)
   with ``count_all=True`` on the first 65 536 rays, counts equal to phase
   14e's DDA; (c) four ranks (as phase 11: NCCL with a card each on four
   cards, else gloo on ``cuda:0``), each building the grids from the same
   numpy scene and running ``sharded_image_cast`` at 1280×950 and with the
   eye inside the canopy, ``sharded_cell_cast`` at 16 rays a cell side,
   ``sharded_grid_cast`` on the primary grid with the 10⁶ rays (a rank's
   part in one tile) and ``sharded_cast_rays`` on phase 7's mesh with
   cast_scene's rays, twice each (the warm call reported) with the rank's
   counters set to 0 just before each call, every result equal bit for bit
   to the single-device call on the rank's card, ``mt_raycast`` launched
   by the eye-inside residual pass and exactly once by the brute cast on
   every rank, and on each rank ``mt_raycast`` against its plain version
   (all four outputs bit for bit) on the inputs of those two launches:
   the rank's part of cast_scene's rays against phase 7's mesh and its
   pixels against the residual triangles; (d) the wavefront and ``sharded_grid_cast`` (the card's
   ranks against 4 gloo ranks on the CPU) on phase 14's small scene: tri
   and counts equal, t within 1e-6 relative;
16. sphere-following QSM on phase 5's plot: (a) the bench's walk
   (bench.py:494-532) on its largest tree, voxel-laddered to at most
   300 000 points, seed rows below zmin + 0.5 m, radius 0.3, 48 steps,
   blocks of 1024, 512 hypotheses, a first and a steady call (seconds,
   steps, cylinders, ``models/qsm.SYNCS`` host reads, peak memory; at
   least one cylinder, all finite); (b) ``qsm_generation_main`` (sphere,
   256 steps) on that tree written by the port's ``write_npz`` — its
   cylinder file must read back the count it printed — then
   ``raycast_main`` and ``tree_isolation_main`` on the same file
   (``mt_raycast`` launches and seconds); (c) ``sphere_qsm_forest`` over
   the plot's 8 trees, each laddered as (a)'s (seconds, cylinders a tree; two trees alone equal to
   their rows of the batch bit for bit; 4 ranks of ``mesh=`` — NCCL with
   a card each on four cards, gloo on ``cuda:0`` otherwise — equal to the
   single-device forest bit for bit); (d) the walk on a small Y-shaped
   tree on the card and on the CPU from the same draws: found, branch
   orders, steps, cylinder counts, orders and parents equal, floats
   within 1e-4.

Then one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that last line; so does a machine without CUDA, or a directory
that holds this script without the package beside it. Before it exits,
passed or failed, the script stops every process it started that still
runs (multiprocessing's resource tracker, a rank) and logs their command
lines.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import subprocess
import sys
import time

T0 = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and float32
# FMA rate outside the tensor cores.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
# float32 instructions a second outside the tensor cores: 132 SMs x 128
# lanes x 1.98 GHz; an unfused multiply or add is one instruction each
FP32_INSTR_S = 33.5e12
BF16_TC_FLOP_S = 989e12  # dense bf16 tensor-core rate
N_TREES = 8  # the bench's plot layout
MT_OPS_PER_PAIR = 46  # float32 ops per ray-triangle pair in csrc/mt_raycast.cu
BUDGET_S = 1000  # wall-clock limit of the whole script, build included
SHARDED_RANKS = 4  # ranks of the sharded path (phase 11)
DDA_RAY_TILE = 1 << 20  # rays a tile of phase 14's 10⁶-ray DDA cast: the whole bundle


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def descendants() -> dict[int, str]:
    """This process's descendants that have not exited, by pid, with their
    command lines (read from ``/proc``)."""
    parent, cmd = {}, {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{d}/cmdline", "rb") as f:
                line = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue  # exited meanwhile
        if state not in ("Z", "X"):
            parent[int(d)], cmd[int(d)] = int(ppid), line
    out, todo = {}, [os.getpid()]
    while todo:
        p = todo.pop()
        for c, pp in parent.items():
            if pp == p and c not in out:
                out[c] = cmd[c]
                todo.append(c)
    return out


def adopt_orphans() -> None:
    """Make this process the Linux child subreaper of what it starts, so a
    process whose parent exits (a daemon that forks itself away) stays its
    descendant, seen and stopped by ``stop_children``."""
    import ctypes

    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)  # PR_SET_CHILD_SUBREAPER


def stop_children(grace_s: float = 10.0) -> dict[int, str]:
    """Stop every process this script started that still runs, reap them
    and return those found: multiprocessing's resource tracker (started
    with the first rank's queue; it outlives the ranks) is told to stop and
    waited for, anything else gets SIGTERM, then SIGKILL after ``grace_s``."""
    import multiprocessing as mp
    from multiprocessing import resource_tracker

    found = descendants()
    for p in mp.active_children():
        p.terminate()
        p.join()
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None and hasattr(tracker, "_stop"):
        tracker._stop()
    sig, deadline = signal.SIGTERM, time.monotonic() + grace_s
    while left := descendants():
        for pid in left:
            with contextlib.suppress(OSError):
                os.kill(pid, sig)
        if time.monotonic() > deadline + grace_s:
            break  # unkillable (stuck in the kernel): nothing more to do
        if time.monotonic() > deadline:
            sig = signal.SIGKILL
        time.sleep(0.1)
    with contextlib.suppress(ChildProcessError):  # reap the exited ones
        while os.waitpid(-1, os.WNOHANG)[0] > 0:
            pass
    return found


def synthetic_plot(n_total: int, n_trees: int, seed: int, device):
    """The bench's plot layout (trunk rings of radius 0.3 m, 6 m tall, under
    Gaussian canopy blobs, trees on an 8 m grid) drawn on the device."""
    import math

    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    per = n_total // n_trees
    grid = int(math.ceil(math.sqrt(n_trees)))
    n_trunk = per // 2
    n_canopy = per - n_trunk
    i = torch.arange(n_trees, device=device)
    cx = ((i % grid) * 8.0)[:, None]
    cy = ((i // grid) * 8.0)[:, None]
    th = torch.rand(n_trees, n_trunk, generator=g, device=device) * (2 * math.pi)
    z = torch.rand(n_trees, n_trunk, generator=g, device=device) * 6.0
    r = 0.3 + 0.01 * torch.randn(n_trees, n_trunk, generator=g, device=device)
    trunk = torch.stack([cx + r * torch.cos(th), cy + r * torch.sin(th), z], -1)
    nrm = torch.randn(n_trees, n_canopy, 3, generator=g, device=device)
    scale = torch.tensor([1.6, 1.6, 1.0], device=device)
    canopy = torch.stack([cx.expand(-1, n_canopy), cy.expand(-1, n_canopy),
                          torch.full((n_trees, n_canopy), 7.5, device=device)], -1) + nrm * scale
    return torch.cat([trunk, canopy], dim=1).reshape(-1, 3).contiguous()


def two_tree_plot(seed: int):
    """The small two-tree case of the JAX package's pipeline test."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def tree(cx, r, n=3000):
        th = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(0, 5, n)
        return np.stack([cx + (r + rng.normal(0, .005, n)) * np.cos(th),
                         (r + rng.normal(0, .005, n)) * np.sin(th), z], 1)

    return np.concatenate([tree(0, 0.3), tree(6, 0.2)]).astype(np.float32)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """The card's time of one call of ``fn``: the call captured once in a
    CUDA graph and replayed between CUDA events, so no host time between
    the launches counts."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def band_inputs(bm, shape, seed: int):
    import torch

    t, nb = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    b_w = torch.rand(t, nb, bm.BAND_BLOCK, 3 * bm.BAND_BLOCK, generator=g, device="cuda")
    x = torch.randn(t, nb * bm.BAND_BLOCK, 3, generator=g, device="cuda")
    return b_w, x


def check_band(bm, shape, seed: int, transpose: bool) -> dict:
    """Kernel vs plain version (W x, or Wᵀ x from the forward tiles) on
    seeded inputs at one band shape, then timings of the kernel, the plain
    version and one ``torch.bmm`` of the same tiles."""
    import torch

    t, nb = shape
    b_w, x = band_inputs(bm, shape, seed)
    kernel, plain = ((bm.band_matvec_t_cuda, bm.band_matvec_t_plain) if transpose
                     else (bm.band_matvec_cuda, bm.band_matvec_plain))
    y = kernel(b_w, x)
    ref = plain(b_w, x)
    mag = plain(b_w, x.abs())  # Σ |W||x| per output row
    torch.cuda.synchronize()
    err = (y - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / mag.clamp_min(1e-30)).max())
    # f32 sums of 768 terms in two different orders: each is within
    # 768·2⁻²⁴·Σ|W||x| of the exact value
    tol = 768 * 2.0 ** -24 * float(mag.max())
    w2 = b_w.reshape(t * nb, bm.BAND_BLOCK, 3 * bm.BAND_BLOCK)
    if transpose:
        # yardstick only: the three partial products per tile, without
        # their fold into output blocks (no one PyTorch call does both)
        xb = x.reshape(t * nb, bm.BAND_BLOCK, 3)
        lib = lambda: torch.bmm(w2.transpose(1, 2), xb)  # noqa: E731
    else:
        xw = bm._windows(x, nb).reshape(t * nb, 3 * bm.BAND_BLOCK, 3)
        lib = lambda: torch.bmm(w2, xw)  # noqa: E731
    ms = time_ms(lambda: kernel(b_w, x))
    plain_ms = time_ms(lambda: plain(b_w, x))
    bmm_ms = time_ms(lib)
    nbytes = b_w.numel() * 4 + x.numel() * 4 + y.numel() * 4
    flops = 2 * b_w.numel() * 3
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
    return dict(shape=[t, nb, bm.BAND_BLOCK, 3 * bm.BAND_BLOCK], max_abs_err=max_abs,
                max_rel_err=max_rel, tol=tol, ok=max_abs <= tol and bool(torch.isfinite(y).all()),
                ms=ms, plain_ms=plain_ms, bmm_ms=bmm_ms,
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                gbytes=nbytes / 1e9)


def check_lt_path(bm, sp, lap, seed: int, n_trees: int, nb: int) -> dict:
    """Lᵀ x of a banded Laplacian at the contraction's fine width with its
    Wᵀ band dropped (``band_matvec_t``) against the Wᵀ-band route
    (``band_matvec``); the counters are set to 0 just before."""
    import math

    import torch

    n = nb * bm.BAND_BLOCK
    g = torch.Generator(device="cuda").manual_seed(seed)
    th = torch.rand(n_trees, n, generator=g, device="cuda") * (2 * math.pi)
    z = torch.rand(n_trees, n, generator=g, device="cuda") * 6.0
    r = 0.3 + 0.01 * torch.randn(n_trees, n, generator=g, device="cuda")
    pts = torch.stack([r * torch.cos(th), r * torch.sin(th), z], -1)
    mask = torch.ones(n_trees, n, dtype=torch.bool, device="cuda")
    perm = torch.argsort(sp.morton_codes(pts, mask), dim=1, stable=True)
    pts = torch.gather(pts, 1, perm[..., None].expand(-1, -1, 3)).contiguous()
    L = lap.point_cloud_laplacian(pts, mask, 20, 1e-6, banded=True)
    x = torch.randn(n_trees, n, 3, generator=g, device="cuda")
    L_no_t = L._replace(b_w_t=None)
    torch.cuda.synchronize()
    bm.LAUNCHES = bm.LAUNCHES_T = 0
    y_t = sp.laplacian_rmatvec(L_no_t, x)
    torch.cuda.synchronize()
    launches_t, launches_fwd = bm.LAUNCHES_T, bm.LAUNCHES
    y_ref = sp.laplacian_rmatvec(L, x)
    mag = (L.deg[..., None] * x.abs() + bm.band_matvec_t_plain(L.b_w.abs(), x.abs())
           + sp._spill_apply(L.st_i, L.st_j, L.st_w.abs(), x.abs(), n, transpose=True))
    err = float((y_t - y_ref).abs().max())
    tol = 768 * 2.0 ** -24 * float(mag.max())
    # the sorted spill sums (``segment_sum``'s segmented reduce) add each
    # row's terms in index order on either device: the card's equal the CPU's
    spill_equal = all(torch.equal(
        sp._spill_apply(a, b, w, x, n, transpose=tr, sorted_dst=True).cpu(),
        sp._spill_apply(a.cpu(), b.cpu(), w.cpu(), x.cpu(), n, transpose=tr, sorted_dst=True))
        for a, b, w, tr in ((L.s_i, L.s_j, L.s_w, False), (L.st_i, L.st_j, L.st_w, True)))
    return dict(launches=launches_t, fwd_launches=launches_fwd, max_abs_err=err, tol=tol,
                ok=err <= tol and bool(torch.isfinite(y_t).all()), spill_equal=spill_equal,
                spill_overflow=bool(L.s_overflow.any()), shape=list(L.b_w.shape))


def mt_shapes(tr, tmr, mesh, cfg) -> dict:
    """The raycast path's three mt_raycast shapes on its mesh: cast_scene's
    pinhole bundle, a brute sun cast's parallel bundle (el 60) and
    ``occupancy``'s rays from the grid points of ``mri_slices``'s middle
    slab along ``_OCC_DIR``; label -> (origins, dirs), contiguous."""
    import numpy as np
    import torch

    v = mesh.vertices
    center = v.mean(dim=0)
    cam = tr.pinhole_rays(center + torch.tensor([0.0, 0.0, 10.0], device="cuda"), center,
                          [0.0, 1.0, 0.0], cfg.fov_deg, cfg.width_px, cfg.height_px,
                          device="cuda")
    sun = tr.parallel_rays(v.amin(0), v.amax(0), tmr._sun_direction(180.0, 60.0), 256, 256,
                           device="cuda")
    # the grid points of mri_slices' (axis 2, 8 slabs, 64²) fifth slab
    lo, hi = v.amin(0).cpu().numpy(), v.amax(0).cpu().numpy()
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], 64), np.linspace(lo[1], hi[1], 64),
                         indexing="xy")
    pts = np.zeros((64 * 64, 3), np.float32)
    pts[:, 0], pts[:, 1] = gx.ravel(), gy.ravel()
    pts[:, 2] = np.linspace(lo[2], hi[2], 8)[4]
    pts = torch.as_tensor(pts, device="cuda")
    occ = (pts, torch.tensor(tr._OCC_DIR, device="cuda").expand_as(pts))
    return {label: (o.contiguous(), d.contiguous())
            for label, (o, d) in (("cast_scene", cam), ("sun", sun), ("occupancy", occ))}


def mt_stage_shares(mt, origins, dirs, vertices, triangles, ray_tile: int = 4096) -> dict:
    """Ray-triangle pairs that pass stage 1 (big && u >= -eps on a valid
    triangle) and stage 2 (and v >= -eps && u + v <= 1 + eps) of
    csrc/mt_raycast.cu, counted and as shares, from the plain version's
    formulas in torch, tiled; and the share of (warp of 32 neighbouring
    rays, triangle) pairs in which any lane passes, which the kernel's
    early-out reads."""
    import torch

    soa = mt.triangle_soa(vertices, triangles)
    v0, e1, e2, ok = (soa[0], soa[1], soa[2]), (soa[3], soa[4], soa[5]), \
        (soa[6], soa[7], soa[8]), soa[9] > 0
    n_tri = soa.shape[1]
    sums = dict(pair1=0, pair2=0, warp1=0, warp2=0)
    n_warps = 0
    for r0 in range(0, origins.shape[0], ray_tile):
        o, d = origins[r0:r0 + ray_tile], dirs[r0:r0 + ray_tile]
        ov = tuple(o[:, a:a + 1] for a in range(3))
        dv = tuple(d[:, a:a + 1] for a in range(3))
        _, u, v = mt.mt_components(ov, dv, v0, e1, e2, ok)
        px = dv[1] * e2[2] - dv[2] * e2[1]
        py = dv[2] * e2[0] - dv[0] * e2[2]
        pz = dv[0] * e2[1] - dv[1] * e2[0]
        det = e1[0] * px + e1[1] * py + e1[2] * pz
        p1 = (det.abs() > 1e-9) & (u >= -1e-9) & ok
        p2 = p1 & (v >= -1e-9) & (u + v <= 1.0 + 1e-9)
        n = o.shape[0]
        pad = (-n) % 32
        for key, m in (("1", p1), ("2", p2)):
            sums["pair" + key] += int(m.sum())
            w = torch.cat([m, m.new_zeros(pad, n_tri)]) if pad else m
            sums["warp" + key] += int(w.view(-1, 32, n_tri).any(1).sum())
        n_warps += (n + pad) // 32
    pairs = max(origins.shape[0] * n_tri, 1)
    wpairs = max(n_warps * n_tri, 1)
    return dict(pass_stage1=sums["pair1"], pass_stage2=sums["pair2"],
                pair_stage1=sums["pair1"] / pairs, pair_stage2=sums["pair2"] / pairs,
                warp_stage1=sums["warp1"] / wpairs, warp_stage2=sums["warp2"] / wpairs)


def mt_needed_ops(origins, dirs, n_tri: int, shares: dict) -> int:
    """The float32 operations (multiplies, adds, the reciprocal) that this
    input needs, by stage: stage 1 (p 9, det 5, 1/det 1, tv 3, u 6) for
    every pair, stage 2 (q 9, v 6, u + v 1) for the pairs that pass stage 1,
    stage 3 (t 6) for those that pass stage 2. Terms that depend on the
    triangle alone are counted once a triangle: p, det and 1/det where every
    ray has one direction, tv, q and e2·q where every ray has one origin."""
    one_dir = bool((dirs == dirs[:1]).all())
    one_origin = bool((origins == origins[:1]).all())
    s1, s2, s3, per_tri = 24, 16, 6, 0
    if one_dir:
        s1, per_tri = s1 - 15, per_tri + 15
    if one_origin:
        s1, s2, s3, per_tri = s1 - 3, s2 - 9, s3 - 5, per_tri + 17
    return (origins.shape[0] * n_tri * s1 + shares["pass_stage1"] * s2
            + shares["pass_stage2"] * s3 + n_tri * per_tri)


def mt_bitwise(mt, o, d, vertices, triangles, slices=None):
    """Kernel against plain version on one input, under the host's plan or
    with ``slices`` triangle slices: (all four outputs equal bit for bit,
    the first output that differs or None)."""
    import torch

    got = mt._launch(o, d, vertices, triangles, slices=slices)
    want = mt.mt_raycast_plain(o, d, vertices, triangles)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "tri", "uv", "count"), got, want):
        if not torch.equal(a, b):
            return False, name
    return True, None


def check_mt_raycast(mt, origins, dirs, mesh, label: str) -> dict:
    """Kernel vs plain version on one ray bundle, all four outputs bit for
    bit; then timings (the wrapper's call, as a caller sees it, and a
    CUDA-graph replay of it, the card's time alone), the stage shares, the
    bound from the operations this bundle's rays need on this mesh's
    triangles at 67 TFLOP/s (beside it the same operations at 33.5 T
    unfused instructions a second, and the written-out 46 ops for every
    pair at 67 TFLOP/s) and the launch plan."""
    import torch

    o, d = origins.contiguous(), dirs.contiguous()
    got = mt.mt_raycast_cuda(o, d, mesh.vertices, mesh.triangles)
    want = mt.mt_raycast_plain(o, d, mesh.vertices, mesh.triangles)
    torch.cuda.synchronize()
    t_k, tri_k, uv_k, cnt_k = got
    t_p, tri_p, uv_p, cnt_p = want
    fin = torch.isfinite(t_p)
    t_err = float((t_k[fin] - t_p[fin]).abs().max()) if bool(fin.any()) else 0.0
    t_rel = float(((t_k[fin] - t_p[fin]).abs() / t_p[fin].abs()).max()) if bool(fin.any()) else 0.0
    uv_err = float((uv_k - uv_p).abs().max()) if uv_k.numel() else 0.0
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    ms = time_ms(lambda: mt.mt_raycast_cuda(o, d, mesh.vertices, mesh.triangles), iters=10)
    card_ms = graph_ms(lambda: mt.mt_raycast_cuda(o, d, mesh.vertices, mesh.triangles))
    plain_ms = time_ms(lambda: mt.mt_raycast_plain(o, d, mesh.vertices, mesh.triangles),
                       iters=3, warmup=1)
    r, n_tri, n_verts = o.shape[0], mesh.triangles.shape[0], mesh.vertices.shape[0]
    shares = mt_stage_shares(mt, o, d, mesh.vertices, mesh.triangles)
    ops = mt_needed_ops(o, d, n_tri, shares)
    nbytes = r * (24 + 20) + (n_tri + n_verts) * 12  # rays in, hits out, the mesh once
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_FLOP_S * 1e3
    pl = mt.plan(r, n_tri, torch.cuda.get_device_properties(0).multi_processor_count)
    return dict(label=label, rays=r, triangles=n_tri, ok=bitwise, bitwise=bitwise,
                tri_equal=torch.equal(tri_k, tri_p), count_equal=torch.equal(cnt_k, cnt_p),
                max_abs_err=max(t_err, uv_err), t_max_rel=t_rel, ms=ms, graph_ms=card_ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                ops=ops, ops_per_pair=ops / max(r * n_tri, 1),
                instr_ms=ops / FP32_INSTR_S * 1e3,
                full_ms=r * n_tri * MT_OPS_PER_PAIR / FP32_FLOP_S * 1e3,
                hit_rays=int(fin.sum()), grays_s=r / (ms * 1e-3) / 1e9,
                shares=shares, plan=pl._asdict())


def check_mt_edges(mt, mesh, shapes: dict) -> list[dict]:
    """The kernel's edge cases on the card, each bit for bit against the
    plain version under the host's plan and forced one- and eight-slice
    plans: duplicated triangles (every tie crosses a slice, the lower id
    must win) under one-direction and pinhole rays, T = 0, every row -1,
    R = 1, R off the ray tile, and T beyond one block's shared memory (the
    triangles tiled 11 times) under both kinds of rays. Pinhole rays take
    the kernel's general form, rays of one direction its one-direction
    form."""
    import torch

    v, tri = mesh.vertices, mesh.triangles
    occ, sun, cam = shapes["occupancy"], shapes["sun"], shapes["cast_scene"]
    cam_off = (cam[0][:4133], cam[1][:4133])
    cases = [
        ("duplicated, occupancy rays", occ, torch.cat([tri, tri])),
        ("duplicated, cast_scene rays", cam, torch.cat([tri, tri])),
        ("T = 0", occ, tri[:0]),
        ("every row -1", occ, torch.full_like(tri, -1)),
        ("R = 1", (cam[0][:1], cam[1][:1]), tri),
        ("R = 4133, off the ray tile", (sun[0][:4133], sun[1][:4133]), tri),
        ("T = 11 x mesh, beyond one block's shared memory", occ, tri.repeat(11, 1)),
        ("T = 11 x mesh, sun rays", sun, tri.repeat(11, 1)),
        ("T = 11 x mesh, 4133 cast_scene rays", cam_off, tri.repeat(11, 1)),
    ]
    out = []
    for name, (o, d), t in cases:
        r, n = o.shape[0], t.shape[0]
        host = mt.plan(r, n, torch.cuda.get_device_properties(0).multi_processor_count)
        for pname, slices in (("host", None), ("1 slice", 1), ("8 slices", 8)):
            ok, first = mt_bitwise(mt, o, d, v, t.contiguous(), slices=slices)
            out.append(dict(case=name, rays=r, triangles=n, plan=pname,
                            slices=slices or host.slices, bitwise=ok, first_diff=first))
    return out


def bf16_exact_and_within(bm, t: int, nb: int, c: int, seed: int, prepadded: bool):
    """bf16 kernel vs plain version at [t, nb, 256, 768] x [t, nb·256, c]
    (``prepadded``: the halo form, x [t, (nb+2)·256, c] whose two halo
    blocks are as random as the rest): a 0/1 adjacency (~16 of 768 window
    columns a row, as the claim's) with a one-hot frontier must match
    exactly; random bf16 inputs within 768·2⁻²⁴·Σ|W||x| per output.
    Returns the 0/1 inputs and output, exact, within and the random
    inputs' max abs error."""
    import torch

    bs = bm.BAND_BLOCK
    nx = (nb + 2 if prepadded else nb) * bs
    g = torch.Generator(device="cuda").manual_seed(seed)
    w01 = (torch.rand(t, nb, bs, 3 * bs, generator=g, device="cuda") < 16 / 768).to(torch.bfloat16)
    lab = torch.randint(0, c, (t, nx), generator=g, device="cuda")
    live = torch.rand(t, nx, generator=g, device="cuda") < 0.5
    x01 = ((lab[..., None] == torch.arange(c, device="cuda")) & live[..., None]).to(
        torch.bfloat16).contiguous()

    def kernel(w, x):
        return bm.band_matvec_bf16_cuda(w, x, prepadded=prepadded)

    def plain(w, x):
        return bm.band_matvec_plain(w, x, prepadded=prepadded)

    y01 = kernel(w01, x01)
    exact = torch.equal(y01, plain(w01, x01)) and bool(torch.isfinite(y01).all())
    wr = torch.randn(t, nb, bs, 3 * bs, generator=g, device="cuda").to(torch.bfloat16)
    xr = torch.randn(t, nx, c, generator=g, device="cuda").to(torch.bfloat16)
    err = (kernel(wr, xr) - plain(wr, xr)).abs()
    lim = 768 * 2.0 ** -24 * plain(wr.abs(), xr.abs())
    torch.cuda.synchronize()
    return w01, x01, y01, exact, bool((err <= lim).all()), float(err.max())


def check_bf16_widths(bm, seed: int, prepadded: bool) -> list[dict]:
    """Every C of ``BF16_WIDTHS`` on T = 2 trees at nb = 1 (both neighbours
    out of bounds) and nb = 133 (one block more than the H100's 132 SMs, so
    one persistent block walks two tiles): 0/1 inputs bit for bit, random
    bf16 within 768·2⁻²⁴·Σ|W||x|."""
    out = []
    for c in bm.BF16_WIDTHS:
        for nb in (1, 133):
            *_, exact, within, max_abs = bf16_exact_and_within(bm, 2, nb, c, seed + c + nb,
                                                               prepadded)
            out.append(dict(c=c, trees=2, nb=nb, exact01=exact, within=within,
                            max_abs_err=max_abs))
    return out


def check_band_bf16(bm, nb: int, c: int, seed: int, prepadded: bool = False) -> dict:
    """``bf16_exact_and_within`` at [1, nb, 256, 768] x [1, nb·256, c], then
    timings of the kernel, the plain version and one ``torch.bmm`` of the
    bf16 windows, on the 0/1 inputs."""
    import torch

    bs = bm.BAND_BLOCK
    n = nb * bs
    nx = n + 2 * bs if prepadded else n
    w01, x01, y01, exact, within, max_abs = bf16_exact_and_within(bm, 1, nb, c, seed, prepadded)
    w2 = w01.reshape(nb, bs, 3 * bs)
    xw = bm._windows(x01, nb, prepadded).reshape(nb, 3 * bs, c)
    ms = time_ms(lambda: bm.band_matvec_bf16_cuda(w01, x01, prepadded=prepadded))
    plain_ms = time_ms(lambda: bm.band_matvec_plain(w01, x01, prepadded=prepadded), iters=5,
                       warmup=1)
    bmm_ms = time_ms(lambda: torch.bmm(w2, xw))
    nbytes = n * (3 * bs * 2 + c * 4) + nx * c * 2  # W, x read once; y written once
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2 * n * 3 * bs * c / BF16_TC_FLOP_S * 1e3
    return dict(shape=[1, nb, bs, 3 * bs], c=c, exact01=exact, within=within,
                max_abs_err=max_abs, ok=exact and within,
                max_count=float(y01.max()), ms=ms, plain_ms=plain_ms, bmm_ms=bmm_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", gbytes=nbytes / 1e9)


def report_widths(name: str, widths: list[dict]) -> None:
    """Log phase 10's or 12's every-width check; fail on any disagreement."""
    for w in widths:
        log("kernel", f"{name} T={w['trees']} nb={w['nb']} C={w['c']}: 0/1 inputs equal "
            f"{w['exact01']}, random bf16 within 768·2⁻²⁴·Σ|W||x| {w['within']} (max_abs_err "
            f"{w['max_abs_err']:.3e})")
    bad = [(w["c"], w["nb"]) for w in widths if not (w["exact01"] and w["within"])]
    if bad:
        fail(f"{name}: kernel disagrees with its plain version at (C, nb) {bad} on 2 trees")


def band_claim_path(ti, bm, process_plot, Config, pts, mask, iso_cfg, main_trees, plot_kw) -> dict:
    """Phase 9: ``build_trees`` with the band claim and with the default
    push claim, in turns, twice each; then one ``process_plot`` under the
    band claim. Restores ``PYQSM_CLAIM`` afterwards."""
    import torch

    saved = os.environ.get("PYQSM_CLAIM")
    out = {}
    try:
        for rnd in (1, 2):
            for mode in ("band", "push"):
                if mode == "band":
                    os.environ["PYQSM_CLAIM"] = "band"
                else:
                    os.environ.pop("PYQSM_CLAIM", None)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                bm.LAUNCHES_BF16 = 0
                t = time.perf_counter()
                res = ti.build_trees(pts, mask, iso_cfg, device="cuda")
                torch.cuda.synchronize()
                sec = time.perf_counter() - t
                out[(mode, rnd)] = dict(res=res, s=sec, launches=bm.LAUNCHES_BF16,
                                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
                log("band_claim", f"build_trees run {rnd} claim {res.claim} (asked "
                    f"{'band' if mode == 'band' else 'the default'}): "
                    f"{sec:.4f}s, cycles {res.cycles_run}, band_matvec_bf16 launches "
                    f"{bm.LAUNCHES_BF16}, max_memory_allocated "
                    f"{out[(mode, rnd)]['peak_gib']:.3f} GiB")
        band, push = out[("band", 2)], out[("push", 2)]
        rb, rp = band["res"], push["res"]
        if any(out[("band", r)]["res"].claim != "band" for r in (1, 2)):
            fail("PYQSM_CLAIM=band did not run the band claim")
        if rp.claim == "band":
            fail("the default claim ran the band claim")
        same = (torch.equal(rb.labels, rp.labels) and torch.equal(rb.order, rp.order)
                and rb.cycles_run == rp.cycles_run)
        out["band_info"] = dict(ti.LAST_BAND)
        log("band_claim", f"band {out['band_info']}; band == push bit for bit: {same}; second "
            f"runs band {band['s']:.4f}s / push {push['s']:.4f}s")
        if not same:
            fail("band claim labels/order/cycles differ from the push claim's")
        if any(out[("band", r)]["launches"] != out[("band", r)]["res"].cycles_run for r in (1, 2)):
            fail("band_matvec_bf16 launches differ from the band claim's cycles")

        os.environ["PYQSM_CLAIM"] = "band"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bm.LAUNCHES = bm.LAUNCHES_T = bm.LAUNCHES_BF16 = 0
        t = time.perf_counter()
        res = process_plot(pts, mask, Config(), iso_cfg, device="cuda", **plot_kw)
        torch.cuda.synchronize()
        out["plot_s"] = time.perf_counter() - t
        out["launches"] = bm.LAUNCHES_BF16
        trees = [(tr.tree_id, tr.n_points) for tr in res.trees]
        log("band_claim", f"process_plot under the band claim: claim {res.growth.claim}, cycles "
            f"{res.growth.cycles_run}, trees {trees}, stages {res.timings}, total "
            f"{out['plot_s']:.2f}s; band_matvec_bf16 launches {out['launches']}, band_matvec "
            f"{bm.LAUNCHES}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if res.growth.claim != "band" or out["launches"] != res.growth.cycles_run:
            fail("process_plot under PYQSM_CLAIM=band did not run the band claim once a cycle")
        if trees != main_trees:
            fail("process_plot under the band claim found other trees than the main path")
        if not all(bool(torch.isfinite(tr.cylinders.radius).all()) and int(tr.cylinders.count())
                   for tr in res.trees):
            fail("process_plot under the band claim: a tree without finite cylinders")
    finally:
        if saved is None:
            os.environ.pop("PYQSM_CLAIM", None)
        else:
            os.environ["PYQSM_CLAIM"] = saved
    return out


def median_radii(trees) -> list[float]:
    return [float(t.cylinders.radius[t.cylinders.mask].median()) for t in trees]


def cylinder_stats(skels, batch_m, cfg) -> tuple[list[int], list[float]]:
    """Cylinder counts and median radii of a contracted batch, through
    ``process_plot``'s own topology calls."""
    from pyqsm_tpu_torch.models import skeleton as sk

    trees = [sk.skeleton_to_qsm(sk.extract_topology(skels.contracted[i], batch_m[i],
                                                    skels.total_shift[i], cfg.graph_k_n))
             for i in range(batch_m.shape[0])]
    return ([int(c.count()) for c in trees],
            [float(c.radius[c.mask].median()) for c in trees])


def sharded_rank(pts, iso_kw: dict, plot_kw: dict, mesh=None) -> dict:
    """One rank of phase 11 (every rank gets the same plot): ``build_trees(
    mesh=)`` under ``PYQSM_CLAIM=band`` and under the default claim, in
    turns, twice each, then ``process_plot(mesh=)`` under the band claim
    twice (the first warms the rank's contraction up; the second is
    reported), each with this rank's launch counters set to 0 just before
    and read just after. The contraction batch of the reported call is
    recorded as ``process_plot`` hands it to ``extract_skeleton_batch``;
    this rank's block of it is then contracted alone on this rank's device
    and compared with the gathered rows, and rank 0 contracts the whole
    batch on its device too."""
    import torch

    from pyqsm_tpu_torch.config import Config, IsolationConfig
    from pyqsm_tpu_torch.models import isolation as ti
    from pyqsm_tpu_torch.models import plot_pipeline as pp
    from pyqsm_tpu_torch.models import skeleton as sk
    from pyqsm_tpu_torch.ops import band_matvec as bm
    from pyqsm_tpu_torch.parallel import growth

    dev = mesh.device
    pts = pts.to(dev)
    mask = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    iso_cfg = IsolationConfig(**iso_kw)
    out = dict(rank=mesh.rank, backend=mesh.backend, world=mesh.size, device=str(dev))

    def run(label, fn):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        bm.LAUNCHES = bm.LAUNCHES_T = bm.LAUNCHES_BF16 = bm.LAUNCHES_BF16_HALO = 0
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        out[label] = dict(s=time.perf_counter() - t, halo_launches=bm.LAUNCHES_BF16_HALO,
                          bf16_launches=bm.LAUNCHES_BF16, f32_launches=bm.LAUNCHES,
                          peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
        return res

    try:
        for rnd in (1, 2):
            for mode in ("band", "default"):
                if mode == "band":
                    os.environ["PYQSM_CLAIM"] = "band"
                else:
                    os.environ.pop("PYQSM_CLAIM", None)
                growth.LAST_BAND = None
                res = run((mode, rnd),
                          lambda: ti.build_trees(pts, mask, iso_cfg, mesh=mesh, device=dev))
                out[(mode, rnd)].update(claim=res.claim, cycles=res.cycles_run,
                                        labels=res.labels.cpu(), order=res.order.cpu(),
                                        band=growth.LAST_BAND)
        os.environ["PYQSM_CLAIM"] = "band"
        batch = {}

        def recording(points, masks, cfg, **kw):  # observes, then calls through
            skels = extract(points, masks, cfg, **kw)
            batch.update(points=points, masks=masks, cfg=cfg, skels=skels)
            return skels

        extract, pp.extract_skeleton_batch = pp.extract_skeleton_batch, recording
        try:
            for _ in range(2):
                res = run("plot", lambda: pp.process_plot(pts, mask, Config(), iso_cfg,
                                                          mesh=mesh, device=dev, **plot_kw))
        finally:
            pp.extract_skeleton_batch = extract
        out["plot"].update(claim=res.growth.claim, cycles=res.growth.cycles_run,
                           timings=res.timings,
                           trees=[(t.tree_id, t.n_points) for t in res.trees],
                           cylinders=[int(t.cylinders.count()) for t in res.trees],
                           radius_median=median_radii(res.trees),
                           finite=all(bool(torch.isfinite(t.cylinders.radius).all())
                                      for t in res.trees))
    finally:
        os.environ.pop("PYQSM_CLAIM", None)
    # this rank's block of the batch, contracted alone at the batch's tier
    p, m, cfg, skels = batch["points"], batch["masks"], batch["cfg"], batch["skels"]
    t = time.perf_counter()
    alone = sk.extract_skeleton_batch(sk.tree_block(p, mesh.size, mesh.rank),
                                      sk.tree_block(m, mesh.size, mesh.rank),
                                      sk.batch_amplification(cfg, m), device=dev)
    torch.cuda.synchronize(dev)
    tb = alone.contracted.shape[0]
    lo, hi = mesh.rank * tb, min((mesh.rank + 1) * tb, p.shape[0])
    out["block"] = dict(trees=[lo, hi], s=time.perf_counter() - t, equal=all(
        torch.equal(g[lo:hi], a[:max(hi - lo, 0)]) for g, a in zip(skels, alone)))
    if mesh.rank == 0:
        # the whole batch on one device: the 8-tree contraction of phase 5
        whole = sk.extract_skeleton_batch(p, m, cfg, device=dev)
        cyl, rad = cylinder_stats(whole, m, cfg)
        out["whole"] = dict(cylinders=cyl, radius_median=rad, rows_equal_block=all(
            torch.equal(w[lo:hi], a[:max(hi - lo, 0)]) for w, a in zip(whole, alone)),
            contracted_max_diff=float((whole.contracted[lo:hi]
                                       - alone.contracted[:max(hi - lo, 0)]).abs().max()))
    return out


def sharded_path(launch, pts, iso_kw, plot_kw, claim, main_trees, main_cyl, main_rad) -> dict:
    """Phase 11: the sharded path over ``SHARDED_RANKS`` spawned ranks,
    checked against phases 5 and 9."""
    import torch

    count = torch.cuda.device_count()
    backend = "nccl" if count >= SHARDED_RANKS else "gloo"
    log("sharded", f"{SHARDED_RANKS} ranks, backend {backend}, "
        f"{'one card a rank' if backend == 'nccl' else 'every rank on cuda:0'}")
    t = time.perf_counter()
    ranks = launch(sharded_rank, SHARDED_RANKS, backend, args=(pts.cpu(), iso_kw, plot_kw),
                   device="cuda" if backend == "nccl" else "cuda:0", timeout=BUDGET_S)
    launch_s = time.perf_counter() - t
    want = {"default": claim[("push", 2)]["res"], "band": claim[("band", 2)]["res"]}
    for r in ranks:
        for rnd in (1, 2):
            for mode in ("band", "default"):
                o = r[(mode, rnd)]
                log("sharded", f"rank {r['rank']} ({r['device']}, {r['backend']}, world "
                    f"{r['world']}) build_trees run {rnd} {mode}: claim {o['claim']}, cycles "
                    f"{o['cycles']}, {o['s']:.4f}s, halo launches {o['halo_launches']}, "
                    f"max_memory_allocated {o['peak_gib']:.3f} GiB, band {o['band']}")
        p, blk = r["plot"], r["block"]
        log("sharded", f"rank {r['rank']} trees {blk['trees'][0]}..{blk['trees'][1] - 1} "
            f"contracted alone on its device in {blk['s']:.3f}s: equal to the gathered rows "
            f"bit for bit {blk['equal']}")
        log("sharded", f"rank {r['rank']} process_plot(mesh=) under the band: claim "
            f"{p['claim']}, cycles {p['cycles']}, {p['s']:.3f}s, stages {p['timings']}, trees "
            f"{p['trees']}, cylinders {p['cylinders']} (main path {main_cyl}), median radius "
            f"{[round(x, 5) for x in p['radius_median']]} (main path "
            f"{[round(x, 5) for x in main_rad]}), halo launches {p['halo_launches']}, "
            f"band_matvec launches {p['f32_launches']}, max_memory_allocated "
            f"{p['peak_gib']:.3f} GiB")
    whole = ranks[0]["whole"]
    log("sharded", f"rank 0, the batch's 8 trees contracted together on one device: cylinders "
        f"{whole['cylinders']} (main path {main_cyl}), median radius "
        f"{[round(x, 5) for x in whole['radius_median']]}; its rows of trees "
        f"{ranks[0]['block']['trees']} equal the 2-tree block's bit for bit "
        f"{whole['rows_equal_block']} (contracted max abs diff "
        f"{whole['contracted_max_diff']:.3e})")
    log("sharded", f"launch of {SHARDED_RANKS} ranks {launch_s:.2f}s in all")
    if whole["cylinders"] != main_cyl or whole["radius_median"] != main_rad:
        fail("rank 0's single-device contraction of the sharded run's batch differs from the "
             "main path's: the batch handed to the contraction is not phase 5's")
    for r in ranks:
        for (mode, rnd), ran in ((("default", 1), "gather"), (("default", 2), "gather"),
                                 (("band", 1), "band"), (("band", 2), "band")):
            o, w = r[(mode, rnd)], want[mode]
            if o["claim"] != ran:
                fail(f"sharded build_trees ({mode}) on rank {r['rank']} ran the {o['claim']} "
                     f"claim, not {ran}")
            if not (torch.equal(o["labels"], w.labels.cpu()) and torch.equal(
                    o["order"], w.order.cpu()) and o["cycles"] == w.cycles_run):
                fail(f"sharded build_trees ({mode}) on rank {r['rank']} differs from the "
                     f"single-device {w.claim} claim")
            if mode == "band" and (o["halo_launches"] != o["cycles"] or o["bf16_launches"]):
                fail(f"rank {r['rank']}: halo launches {o['halo_launches']} != cycles "
                     f"{o['cycles']} (unpadded bf16 launches {o['bf16_launches']})")
        p = r["plot"]
        if p["claim"] != "band" or p["halo_launches"] != p["cycles"]:
            fail(f"process_plot(mesh=) on rank {r['rank']} did not run the band claim's halo "
                 f"kernel once a cycle")
        if p["trees"] != main_trees or not p["finite"]:
            fail(f"process_plot(mesh=) on rank {r['rank']} found other trees or non-finite "
                 f"cylinders")
        if not r["block"]["equal"]:
            fail(f"rank {r['rank']}: the gathered contraction rows differ from its block of "
                 f"trees contracted alone")
        # The gathered rows are each block contracted alone (gated above,
        # bit for bit), and the batch is phase 5's (rank 0's 8-tree
        # contraction of it gives phase 5's cylinders exactly). What is
        # left is the batch's shape: CUDA's reductions over a tree's rows
        # split by it, so a block of 2 trees and the batch of 8 round
        # differently, and the contraction turns that last-bit difference
        # into other FPS picks. On the CPU the two agree bit for bit
        # (tests/test_torch_parallel_plot.py). Held: a tree's cylinder
        # count within 15 %, its median radius within 10 %, the plot's
        # cylinder total within 3 %.
        cyl, rad = p["cylinders"], p["radius_median"]
        if (any(abs(a - b) > 0.15 * b for a, b in zip(cyl, main_cyl))
                or abs(sum(cyl) - sum(main_cyl)) > 0.03 * sum(main_cyl)
                or any(abs(a - b) > 0.10 * b for a, b in zip(rad, main_rad))):
            fail(f"process_plot(mesh=) on rank {r['rank']}: cylinders {cyl} / median radii "
                 f"{rad} outside the stated tolerance of the main path's {main_cyl} / "
                 f"{main_rad}")
    return dict(ranks=ranks, backend=backend, launch_s=launch_s)


def launch_counts(bm, mt) -> dict:
    return {"band_matvec": bm.LAUNCHES, "band_matvec_t": bm.LAUNCHES_T,
            "mt_raycast": mt.LAUNCHES, "band_matvec_bf16": bm.LAUNCHES_BF16,
            "band_matvec_bf16_halo": bm.LAUNCHES_BF16_HALO}


def zero_launches(bm, mt) -> None:
    bm.LAUNCHES = bm.LAUNCHES_T = bm.LAUNCHES_BF16 = bm.LAUNCHES_BF16_HALO = mt.LAUNCHES = 0


@contextlib.contextmanager
def timing(module, parts: dict):
    """Within the block each function ``module.<name>`` of ``parts`` (part
    → name) runs synchronised on the card and appends (seconds, result) to
    ``times[part]``."""
    import torch

    times = {p: [] for p in parts}
    saved = {n: getattr(module, n) for n in parts.values()}

    def wrap(part, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            times[part].append((time.perf_counter() - t0, r))
            return r
        return run

    try:
        for part, name in parts.items():
            setattr(module, name, wrap(part, saved[name]))
        yield times
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


METRIC_KEYS = {"classes", "slice_areas", "width_at_bh", "counts"}
CLASSES = {"epis", "leaves", "wood"}


def metric_values(m: dict) -> list[float]:
    """Every area and width of one tree's metrics dict."""
    vals = [m["width_at_bh"], *m["slice_areas"]]
    for c in m["classes"].values():
        vals += [c["total"], *c["areas"]]
    return vals


def canopy_path(bm, mt, pp, canopy, pts, mask, Config, iso_cfg, plot_kw, main, main_launches):
    """Phase 13 (a): ``process_plot(with_metrics=True)`` on the main path's
    plot, counters set to 0 just before and read just after, the batch
    recorded as ``process_plot`` hands it to the contraction; then the same
    call again with the four parts of ``canopy_metrics`` timed (each part
    synchronised), whose metrics must equal the first call's bit for bit."""
    import torch

    batch = {}

    def recording(points, masks, cfg, **kw):  # observes, then calls through
        skels = extract(points, masks, cfg, **kw)
        batch.update(points=points, masks=masks, skels=skels)
        return skels

    extract, pp.extract_skeleton_batch = pp.extract_skeleton_batch, recording
    try:
        torch.cuda.synchronize()
        zero_launches(bm, mt)
        t = time.perf_counter()
        res = pp.process_plot(pts, mask, Config(), iso_cfg, with_metrics=True, device="cuda",
                              **plot_kw)
        torch.cuda.synchronize()
        plot_s = time.perf_counter() - t
        counts = launch_counts(bm, mt)
    finally:
        pp.extract_skeleton_batch = extract
    parts = {"epiphyte split": "identify_epiphytes", "clumps": "project_components_in_clusters",
             "slices": "project_in_slices", "width": "width_at_height"}
    with timing(canopy, parts) as times:
        again = pp.process_plot(pts, mask, Config(), iso_cfg, with_metrics=True, device="cuda",
                                **plot_kw)
    split_s = {p: [sec for sec, _ in v] for p, v in times.items()}
    bm_, skels = batch["masks"], batch["skels"]
    live = [int(r.sum()) for r in bm_]
    disjoint = []
    for i in range(len(res.trees)):
        sp = canopy.identify_epiphytes(skels.first_shift[i], bm_[i])
        disjoint.append(not bool((sp.epis & sp.leaves).any() | (sp.epis & sp.wood).any()
                                 | (sp.leaves & sp.wood).any())
                        and bool(((sp.epis | sp.leaves | sp.wood) == bm_[i]).all()))
    return dict(res=res, again=again, plot_s=plot_s, counts=counts, split_s=split_s, live=live,
                disjoint=disjoint, batch=batch, main_topology_s=main.timings["topology_s"],
                main_launches=main_launches)


def check_canopy_path(cp: dict, main) -> None:
    """Phase 13 (a)'s gates and report."""
    import torch

    res, again = cp["res"], cp["again"]
    log("canopy", f"process_plot(with_metrics=True): {len(res.trees)} trees, stages "
        f"{res.timings} (phase 5 without metrics: topology_s {cp['main_topology_s']}), total "
        f"{cp['plot_s']:.2f}s; launches {cp['counts']} (phase 5: band_matvec "
        f"{cp['main_launches']})")
    for i, t in enumerate(res.trees):
        m = t.metrics
        log("canopy", f"tree {t.tree_id}: live batch rows {cp['live'][i]}, counts "
            f"{m['counts']}, clumps {[len(c['areas']) for c in m['classes'].values()]} "
            f"(areas total {[round(c['total'], 4) for c in m['classes'].values()]} m²), slice "
            f"areas {[round(a, 4) for a in m['slice_areas']]} m², width at breast height "
            f"{m['width_at_bh']:.4f} m; seconds: " + ", ".join(
                f"{p} {v[i]:.4f}" for p, v in cp["split_s"].items()))
    sums = {p: sum(v) for p, v in cp["split_s"].items()}
    log("canopy", f"canopy_metrics seconds over the {len(res.trees)} trees (second call, each "
        f"part synchronised): " + ", ".join(f"{p} {v:.4f}" for p, v in sums.items())
        + f"; second call stages {again.timings}")
    if len(res.trees) != N_TREES or [(t.tree_id, t.n_points) for t in res.trees] != \
            [(t.tree_id, t.n_points) for t in main.trees]:
        fail("process_plot(with_metrics=True) found other trees than the main path")
    for t, tm in zip(res.trees, main.trees):
        if not all(torch.equal(getattr(t.cylinders, f), getattr(tm.cylinders, f))
                   for f in tm.cylinders._fields):
            fail(f"tree {t.tree_id}: cylinders with metrics differ from phase 5's")
    for i, t in enumerate(res.trees):
        m = t.metrics
        if m is None or set(m) != METRIC_KEYS or set(m["classes"]) != CLASSES \
                or set(m["counts"]) != CLASSES:
            fail(f"tree {t.tree_id}: metrics missing or without the JAX package's keys")
        if sum(m["counts"].values()) != cp["live"][i] or not cp["disjoint"][i]:
            fail(f"tree {t.tree_id}: class masks not disjoint or not covering the live rows")
        if not all(v == v and abs(v) != float("inf") and v >= 0 for v in metric_values(m)):
            fail(f"tree {t.tree_id}: an area or width is not finite and >= 0")
    if [t.metrics for t in again.trees] != [t.metrics for t in res.trees]:
        fail("two process_plot(with_metrics=True) calls give different metrics")
    if cp["counts"]["band_matvec"] != cp["main_launches"] or any(
            v for k, v in cp["counts"].items() if k != "band_matvec"):
        fail(f"with metrics the launches {cp['counts']} differ from phase 5's "
             f"{cp['main_launches']} band_matvec launches")


def single_tree_path(bm, mt, sk, canopy, cp: dict, cfg) -> dict:
    """Phase 13 (b): ``skeletonize`` and ``canopy_metrics(shift=None)`` on
    the largest tree's contraction batch row of (a), counters set to 0 just
    before each and read just after (the ELL path launches no kernel)."""
    import torch

    i = max(range(len(cp["live"])), key=cp["live"].__getitem__)
    p, m = cp["batch"]["points"][i], cp["batch"]["masks"][i]
    out = dict(tree=cp["res"].trees[i].tree_id, rows=p.shape[0], live=cp["live"][i])
    for name, fn in (("skeletonize", lambda: sk.skeletonize(p, m, cfg, device="cuda")),
                     ("canopy_metrics", lambda: canopy.canopy_metrics(p, m, device="cuda"))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(bm, mt)
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = dict(res=r, s=time.perf_counter() - t, launches=launch_counts(bm, mt),
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    # the same call again with its Laplacian builds, PCG solves and
    # topology timed (each synchronised), and whether a build's in-degree
    # overflowed the transpose ELL (Lᵀ then takes the exact scatter)
    parts = {"laplacian": "point_cloud_laplacian", "pcg": "pcg", "topology": "extract_topology"}
    with timing(sk, parts) as times:
        t = time.perf_counter()
        sk.skeletonize(p, m, cfg, device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t
    sp = out["split"] = dict(
        s=total, **{k: sum(sec for sec, _ in v) for k, v in times.items()},
        calls={k: len(v) for k, v in times.items()},
        t_overflow=[bool(L.t_overflow.any()) for _, L in times["laplacian"]])
    log("single_tree", f"skeletonize again, parts synchronised: {sp['s']:.3f}s; Laplacian "
        f"builds {sp['laplacian']:.3f}s ({sp['calls']['laplacian']}), PCG solves "
        f"{sp['pcg']:.3f}s ({sp['calls']['pcg']}), topology {sp['topology']:.3f}s; transpose "
        f"ELL overflowed (Lᵀ by the exact scatter) in builds {sp['t_overflow']}")
    skel, _, cyl = out["skeletonize"]["res"]
    met = out["canopy_metrics"]["res"]
    log("single_tree", f"tree {out['tree']} ({out['live']} live of {out['rows']} rows): "
        f"skeletonize {out['skeletonize']['s']:.3f}s, {int(skel.iterations)} iterations "
        f"(max_iter {cfg.max_iter}), volume ratio {float(skel.volume_ratio):.6f}, cylinders "
        f"{int(cyl.count())}, max_memory_allocated {out['skeletonize']['peak_gib']:.3f} GiB, "
        f"launches {out['skeletonize']['launches']}; canopy_metrics(shift=None) "
        f"{out['canopy_metrics']['s']:.3f}s, counts {met['counts']}, width at breast height "
        f"{met['width_at_bh']:.4f} m, max_memory_allocated "
        f"{out['canopy_metrics']['peak_gib']:.3f} GiB, launches "
        f"{out['canopy_metrics']['launches']}")
    if not 1 <= int(skel.iterations) <= cfg.max_iter:
        fail(f"single tree: {int(skel.iterations)} iterations outside 1..{cfg.max_iter}")
    if not bool((cyl.radius[cyl.mask] > 0).any()):
        fail("single tree: no cylinder with a radius > 0")
    if not all(bool(torch.isfinite(f).all()) for f in (skel.total_shift, skel.first_shift,
                                                       skel.contracted)):
        fail("single tree: non-finite shifts")
    if sum(met["counts"].values()) != out["live"] or not all(
            v == v and abs(v) != float("inf") and v >= 0 for v in metric_values(met)):
        fail("single tree: canopy metrics do not cover the live rows or are not finite")
    if any(v for r in ("skeletonize", "canopy_metrics") for v in out[r]["launches"].values()):
        fail("single tree: the ELL path launched a kernel")
    return out


def card_equals_cpu(sk, canopy, small, growth, trees, cfg) -> dict:
    """Phase 13 (c): ``skeletonize`` and ``canopy_metrics(shift=None)`` on
    each tree of the two-tree reference plot (phase 4), on the card and on
    the CPU: equal iteration counts, contracted points within 5e-3 m at the
    99th percentile, class counts within 1 % of the live rows."""
    import numpy as np
    import torch

    out = []
    labels = growth.labels.cpu().numpy()
    for t in trees:
        p = small[labels == t.tree_id]
        m = np.ones(len(p), bool)
        r = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            skel, _, cyl = sk.skeletonize(p, m, cfg, device=dev)
            met = canopy.canopy_metrics(p, m, device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
            r[dev] = dict(skel=skel, cyl=int(cyl.count()), met=met, s=time.perf_counter() - t0)
        d = (r["cuda"]["skel"].contracted.cpu() - r["cpu"]["skel"].contracted).abs()
        d99 = float(np.percentile(d.numpy(), 99))
        its = [int(r[k]["skel"].iterations) for k in ("cuda", "cpu")]
        counts = [r[k]["met"]["counts"] for k in ("cuda", "cpu")]
        worst = max(abs(counts[0][k] - counts[1][k]) for k in CLASSES)
        log("card_cpu", f"tree {t.tree_id} ({len(p)} points): iterations cuda/cpu {its}, "
            f"contracted p99 |diff| {d99:.3e} m, cylinders {r['cuda']['cyl']}/{r['cpu']['cyl']}, "
            f"counts {counts[0]} / {counts[1]}, width {r['cuda']['met']['width_at_bh']:.5f} / "
            f"{r['cpu']['met']['width_at_bh']:.5f} m, clump areas total "
            f"{[round(r[k]['met']['classes']['wood']['total'], 4) for k in ('cuda', 'cpu')]} m² "
            f"(wood); seconds cuda {r['cuda']['s']:.2f}, cpu {r['cpu']['s']:.2f}")
        if its[0] != its[1] or d99 > 5e-3 or worst > 0.01 * len(p):
            fail(f"tree {t.tree_id}: the card and the CPU disagree beyond the stated tolerance")
        out.append(dict(tree=t.tree_id, iterations=its, d99=d99, counts=counts))
    return out


def raycast_path(tr, tmr, rg, vm, mt, pts, cfg, seed: int) -> dict:
    """The ray-casting path on the main path's canopy; mt_raycast's counter
    is set to 0 just before the casts and read just after."""
    import torch

    torch.cuda.synchronize()
    canopy = pts[pts[:, 2] > 6.0]
    t0 = time.perf_counter()
    raw = vm.poisson_like_mesh(canopy, voxel=0.12, blur_iters=1)
    mesh = vm.simplify_mesh(raw, target_triangles=2000)
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    # the field is a count splat (float32 sums of ones, exact in any atomic
    # order) and elementwise blurs: a rebuild on the card must be identical
    raw2 = vm.poisson_like_mesh(canopy, voxel=0.12, blur_iters=1)
    rebuild_equal = torch.equal(raw.vertices, raw2.vertices) and \
        torch.equal(raw.triangles, raw2.triangles)
    del raw2
    n_raw, n_tri = raw.n_triangles(), mesh.n_triangles()
    log("raycast", f"canopy {canopy.shape[0]} points -> raw mesh {n_raw} triangles -> "
        f"decimated {n_tri} triangles, {mesh.vertices.shape[0]} vertices in {mesh_s:.3f}s; "
        f"rebuild on the card identical: {rebuild_equal}")
    out = dict(mesh=mesh, raw=raw, n_raw=n_raw, n_tri=n_tri, mesh_s=mesh_s,
               rebuild_equal=rebuild_equal)
    if not 1000 <= n_tri < 2048:
        fail(f"decimated mesh has {n_tri} triangles, expected 1000-2047")

    def timed(name, fn, rays):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        log("raycast", f"{name}: {sec:.4f}s, {rays} rays, {rays / sec / 1e6:.2f} Mrays/s")
        out.setdefault("casts", {})[name] = dict(s=sec, rays=rays)
        return r

    torch.cuda.reset_peak_memory_stats()
    mt.LAUNCHES = 0
    scene = timed("cast_scene 640x480", lambda: tmr.cast_scene(mesh, cfg=cfg, device="cuda"),
                  cfg.width_px * cfg.height_px)
    # the first cast carries the process's first-use costs; the repeat is steady
    timed("cast_scene 640x480 repeat", lambda: tmr.cast_scene(mesh, cfg=cfg, device="cuda"),
          cfg.width_px * cfg.height_px)
    sun = {}
    for el in (30.0, 60.0, 90.0):
        for backend in ("brute", "grid"):
            sun[(el, backend)] = timed(
                f"sun_exposure az 180 el {el:g} {backend} 256x256",
                lambda: tmr.sun_exposure(mesh, 180.0, el, 256, 256, backend=backend,
                                         device="cuda"), 256 * 256)
    mri = timed("mri_slices 8x64x64", lambda: tmr.mri_slices(mesh, n_slices=8, resolution=64,
                                                             device="cuda"), 8 * 64 * 64)
    hl, cross = timed("sparse_cast_with_intersections 64x64 k8",
                      lambda: tmr.sparse_cast_with_intersections(mesh, 64, 64, 8,
                                                                 device="cuda"), 64 * 64)
    pcd = timed("raycast_to_pcd", lambda: tmr.raycast_to_pcd(mesh, scene.hits, device="cuda"),
                cfg.width_px * cfg.height_px)
    torch.cuda.synchronize()
    out["launches"] = mt.LAUNCHES
    # out of the count: a second mri_slices, steady where the first carried
    # the process's first-use costs of its launch shapes
    timed("mri_slices 8x64x64 repeat", lambda: tmr.mri_slices(mesh, n_slices=8, resolution=64,
                                                              device="cuda"), 8 * 64 * 64)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log("raycast", f"cast_scene hit fraction {scene.hit_fraction:.6f}, exposed area 3D "
        f"{scene.surface_area_3d:.4f} m², 2D {scene.surface_area_2d:.4f} m²; "
        f"mt_raycast launches {out['launches']}; max_memory_allocated {out['peak_gib']:.3f} GiB")
    for el in (30.0, 60.0, 90.0):
        b, g = sun[(el, "brute")], sun[(el, "grid")]
        grid_used = True
        try:
            rg.build_ray_grid(mesh.vertices, mesh.triangles, tmr._sun_direction(180.0, el),
                              cell_cap=256)
        except ValueError:
            grid_used = False
        log("raycast", f"sun el {el:g}: brute frac {b.hit_fraction:.6f} areas "
            f"{b.surface_area_3d:.4f}/{b.surface_area_2d:.4f}; grid (built: {grid_used}) frac "
            f"{g.hit_fraction:.6f} areas {g.surface_area_3d:.4f}/{g.surface_area_2d:.4f}")
        if b.hit_fraction != g.hit_fraction or any(
                abs(x - y) > 1e-4 * abs(x) for x, y in ((b.surface_area_3d, g.surface_area_3d),
                                                        (b.surface_area_2d, g.surface_area_2d))):
            fail(f"sun exposure at elevation {el:g}: brute and grid backends disagree")
    fin_mri = bool(torch.isfinite(mri).all())
    n_cross = int((hl.tri >= 0).sum())
    log("raycast", f"mri_slices {tuple(mri.shape)} finite {fin_mri}, inside share "
        f"{float((mri < 0).float().mean()):.4f}; sparse cast {n_cross} crossings, max count "
        f"{int(hl.count.max())}; hit cloud {int(torch.isfinite(pcd).all(1).sum())} points")
    areas = (scene.surface_area_3d, scene.surface_area_2d)
    if not scene.hit_fraction > 0 or not all(map(lambda a: a == a and abs(a) < float("inf"),
                                                 areas)):
        fail("cast_scene: no hits or non-finite exposed areas")
    if not fin_mri or mri.shape != (8, 64, 64) or n_cross <= 0:
        fail("mri_slices or the sparse cast gave no usable result")
    if tuple(cross.shape) != (64 * 64, 8, 3) or pcd.shape != (cfg.width_px * cfg.height_px, 3):
        fail("sparse cast or hit cloud of the wrong shape")
    if out["launches"] <= 0:
        fail("the raycast path never launched mt_raycast")
    out["scene"] = scene
    return out


def bench_views(mesh):
    """The bench scene's views (bench.py:364-470): the mesh's centre, the
    pinhole eye at centre + (0, -30, 18) m, up +z (tensors on the card),
    and the sun direction (0.3, 0.2, -0.93), normalised (numpy)."""
    import numpy as np
    import torch

    center = mesh.vertices.mean(dim=0)
    eye = center + torch.tensor([0.0, -30.0, 18.0], device=center.device)
    zup = torch.tensor([0.0, 0.0, 1.0], device=center.device)
    direction = np.array([0.3, 0.2, -0.93], np.float32)
    return center, eye, zup, direction / np.linalg.norm(direction)


def random_rays(mesh, n: int, seed: int, margin: float):
    """``n`` rays (numpy float32) from points drawn uniformly in the mesh's
    box grown by ``margin`` m, along unit normal draws, from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v = mesh.vertices.cpu().numpy()
    o = rng.uniform(v.min(0) - margin, v.max(0) + margin, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def f64_hits(mt, o, d, mesh, chunk: int = 16):
    """Closest t and crossing count of rays against every triangle of the
    mesh in float64 arithmetic (Möller–Trumbore as the casters compute
    it): the arbiter where a float32 cast and the brute kernel disagree."""
    import torch

    soa = mt.triangle_soa(mesh.vertices.double(), mesh.triangles)
    ts, cs = [], []
    for r0 in range(0, o.shape[0], chunk):
        ov = tuple(o[r0:r0 + chunk, a:a + 1].double() for a in range(3))
        dv = tuple(d[r0:r0 + chunk, a:a + 1].double() for a in range(3))
        t, _, _ = mt.mt_components(ov, dv, (soa[0], soa[1], soa[2]), (soa[3], soa[4], soa[5]),
                                   (soa[6], soa[7], soa[8]), soa[9] > 0)
        ts.append(t.amin(dim=1))
        cs.append(torch.isfinite(t).sum(dim=1))
    return torch.cat(ts), torch.cat(cs)


def against_brute(mt, h, b, o, d, mesh, label: str, counts: bool = True) -> dict:
    """A grid cast ``h`` held against the brute kernel's ``b`` on the same
    rays (o, d), with the JAX package's oracle tolerances
    (tests/test_raygrid.py, tests/test_grid3d.py): the same rays hit, t
    within 1e-4 relative, the triangle ids differing on fewer than 1 % of
    hits (ties at equal t) and, where every crossing is counted, equal
    counts. A ray where they disagree is cast again in float64 against
    every triangle: the disagreement passes only when the grid cast agrees
    with the float64 cast (the same rays hit, t within 1e-4, equal counts)
    — float32 Möller–Trumbore from afar can find a crossing on a sliver
    triangle that its projected bounds exclude, which the grid never
    tests. More than 1000 such rays fail."""
    import torch

    fin = torch.isfinite(b.t)
    n_hit = int(fin.sum())
    rel = ((h.t - b.t).abs() / b.t.abs().clamp(min=1e-30)).nan_to_num(0.0)
    bad = (torch.isfinite(h.t) != fin) | (fin & (rel > 1e-4))
    if counts:
        bad |= h.count != b.count
    rows = torch.nonzero(bad)[:, 0]
    arbitrated = confirmed = 0
    if 0 < rows.shape[0] <= 1000:
        t64, c64 = f64_hits(mt, o[rows], d[rows], mesh)
        ht = h.t[rows].double()
        agree = (torch.isfinite(ht) == torch.isfinite(t64)) & (
            ~torch.isfinite(t64) | ((ht - t64).abs() <= 1e-4 * t64.abs()))
        if counts:
            agree &= h.count[rows] == c64
        arbitrated, confirmed = rows.shape[0], int(agree.sum())
    ok_rows = rows.shape[0] == 0 or (arbitrated and confirmed == arbitrated)
    good = ~bad & fin
    t_rel = float(rel[good].max()) if bool(good.any()) else 0.0
    tri_diff = int(((h.tri != b.tri) & good).sum()) / max(n_hit, 1)
    ok = ok_rows and tri_diff < 0.01
    log("raycast_grid", f"{label} against the brute kernel on the same {b.t.shape[0]} rays: "
        f"{n_hit} hit; {rows.shape[0]} rays disagree (hit mask, t beyond 1e-4 relative"
        f"{', count' if counts else ''}), float64 sides with the grid cast on {confirmed} of "
        f"{arbitrated}; elsewhere t max rel {t_rel:.3e}, tri differ on {tri_diff:.6f} of hits"
        f"{', counts equal' if counts else ''}")
    if not ok:
        fail(f"{label}: the grid cast disagrees with the brute kernel")
    return dict(n_hit=n_hit, disagree=int(rows.shape[0]), confirmed=confirmed, t_rel=t_rel,
                tri_diff=tri_diff)


def raycast_grid_path(bm, mt, tr, tmr, rg, g3, vm, TriMesh, ray: dict, cfg) -> dict:
    """Phase 14: the ray-casting path at the bench's scene (bench.py:364-470)
    through the image grid, the cell cast and the 3D grid. Each drive of the
    path sets the launch counters to 0 just before and reads them just
    after; the brute oracles run outside the drives."""
    import numpy as np
    import torch

    out = dict(counts={k: 0 for k in launch_counts(bm, mt)}, s={})

    def drive(name, fn, rays=None):
        torch.cuda.synchronize()
        zero_launches(bm, mt)
        syncs = g3.SYNCS
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        n = launch_counts(bm, mt)
        for k, v in n.items():
            out["counts"][k] += v
        out["s"][name] = sec
        rate = f", {rays / sec / 1e6:.3f} Mrays/s" if rays else ""
        log("raycast_grid", f"{name}: {sec:.4f}s{rate}; launches {n}; DDA host reads "
            f"{g3.SYNCS - syncs}")
        return r

    def brute(o, d, mesh):
        return tr.cast_rays(o.contiguous(), d.contiguous(), mesh.vertices, mesh.triangles,
                            backend="kernel")

    # the bench's scene: the canopy mesh of phase 7 before its decimation
    raw = ray["raw"]
    t0 = time.perf_counter()
    mesh = vm.simplify_mesh(raw, target_triangles=400_000)
    torch.cuda.synchronize()
    n_raw, n_tri = raw.n_triangles(), mesh.n_triangles()
    log("raycast_grid", f"bench scene: raw {n_raw} triangles -> simplify_mesh(400 000) kept "
        f"{n_tri} triangles, {mesh.vertices.shape[0]} vertices in {time.perf_counter() - t0:.3f}s")
    if n_tri < tr.GRID_TRIANGLES:
        fail(f"the bench scene kept {n_tri} triangles, fewer than {tr.GRID_TRIANGLES}")
    out.update(n_raw=n_raw, n_tri=n_tri)
    center, eye, zup, direction = bench_views(mesh)

    # (a) the pinhole cast at 1280x950, fov 60, eye = center + (0, -30, 18)
    W, H = 1280, 950
    for label, m in (("kept", mesh), ("raw", raw)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        grid = rg.build_image_grid(m.vertices, m.triangles, eye, center, zup, 60.0, W, H)
        build_s = time.perf_counter() - t
        first = drive(f"image_cast {label} {W}x{H} first", lambda: rg.image_cast(grid), W * H)
        h = drive(f"image_cast {label} {W}x{H} steady", lambda: rg.image_cast(grid), W * H)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        caps = [c for c, _, _ in grid.buckets]
        log("raycast_grid", f"image grid {label}: build {build_s:.3f}s (host), tile cap "
            f"{grid.tri_of_slot.shape[1]}, buckets {caps}, residual "
            f"{int((grid.residual >= 0).sum())}; max_memory_allocated {peak:.3f} GiB; the two "
            f"casts equal bit for bit {all(torch.equal(a, b) for a, b in zip(first, h))}")
        out[f"image_{label}"] = dict(build_s=build_s, peak_gib=peak, caps=caps,
                                     first_s=out["s"][f"image_cast {label} {W}x{H} first"],
                                     steady_s=out["s"][f"image_cast {label} {W}x{H} steady"])
        if label == "kept":
            o, d = rg.image_rays(grid)
            out["image_check"] = against_brute(mt, h, brute(o, d, m), o, d, m,
                                               f"image_cast {label}")
        del grid, first, h

    # (b) cast_scene with the default config: it must take the image route
    built = []
    real_build = tmr.build_image_grid
    tmr.build_image_grid = lambda *a, **kw: built.append(real_build(*a, **kw)) or built[-1]
    try:
        scene = drive(f"cast_scene {cfg.width_px}x{cfg.height_px}",
                      lambda: tmr.cast_scene(mesh, cfg=cfg, device="cuda"),
                      cfg.width_px * cfg.height_px)
    finally:
        tmr.build_image_grid = real_build
    if len(built) != 1:
        fail("cast_scene on the bench scene did not take the image grid")
    o, d = rg.image_rays(built[0])
    hb = brute(o, d, mesh)
    against_brute(mt, scene.hits, hb, o, d, mesh, "cast_scene")
    ref = tmr._exposure(hb, mesh)
    log("raycast_grid", f"cast_scene hit fraction {scene.hit_fraction:.6f}, areas "
        f"{scene.surface_area_3d:.4f}/{scene.surface_area_2d:.4f} m²; brute exposure of the "
        f"same rays {ref.hit_fraction:.6f}, {ref.surface_area_3d:.4f}/{ref.surface_area_2d:.4f}")
    if not scene.hit_fraction > 0 or any(
            abs(x - y) > 1e-4 * abs(y) for x, y in ((scene.hit_fraction, ref.hit_fraction),
                                                    (scene.surface_area_3d, ref.surface_area_3d),
                                                    (scene.surface_area_2d, ref.surface_area_2d))):
        fail("cast_scene through the image grid disagrees with the brute exposure")
    out["cast_scene"] = dict(hit_fraction=scene.hit_fraction, area_3d=scene.surface_area_3d)
    del built, scene

    # (c) the eye inside the canopy: straddling triangles take the residual pass
    grid = rg.build_image_grid(mesh.vertices, mesh.triangles, center,
                               center + torch.tensor([1.0, 0.3, 0.1], device="cuda"), zup, 90.0,
                               640, 480)
    n_res = int((grid.residual >= 0).sum())
    launches = out["counts"]["mt_raycast"]
    h = drive("image_cast eye inside 640x480", lambda: rg.image_cast(grid), 640 * 480)
    out["residual_launches"] = out["counts"]["mt_raycast"] - launches
    log("raycast_grid", f"eye inside the canopy: {n_res} residual triangles, mt_raycast "
        f"launches {out['residual_launches']}")
    if n_res == 0 or out["residual_launches"] <= 0:
        fail("the eye-inside cast did not run its residual pass through mt_raycast")
    o, d = rg.image_rays(grid)
    out["inside_check"] = against_brute(mt, h, brute(o, d, mesh), o, d, mesh,
                                        "image_cast eye inside")
    del grid, h

    # (d) the cell cast along (0.3, 0.2, -0.93), 16 rays a cell side
    t = time.perf_counter()
    sgrid = rg.build_ray_grid(mesh.vertices, mesh.triangles, direction)
    sbuild = time.perf_counter() - t
    n_sun = sgrid.nx * sgrid.ny * 256
    torch.cuda.reset_peak_memory_stats()
    drive("cell_cast_parallel rpc 16 first",
          lambda: rg.cell_cast_parallel(sgrid, direction, rays_per_cell_side=16), n_sun)
    res = drive("cell_cast_parallel rpc 16 steady",
                lambda: rg.cell_cast_parallel(sgrid, direction, rays_per_cell_side=16), n_sun)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("raycast_grid", f"ray grid {sgrid.nx}x{sgrid.ny} cells of {sgrid.cell:.4f} m, cap "
        f"{sgrid.tri_of_slot.shape[1]}, build {sbuild:.3f}s (host); {n_sun} rays; "
        f"max_memory_allocated {peak:.3f} GiB")
    cells = torch.randperm(sgrid.nx * sgrid.ny, generator=torch.Generator().manual_seed(0))[:4096]
    cells = cells.sort().values.to(device="cuda", dtype=torch.int32)
    o = rg.cell_cast_origins(sgrid, direction, 16, 1e3, cell_ids=cells).reshape(-1, 3)
    d = rg._unit(torch.as_tensor(direction, device="cuda")).expand_as(o)
    sampled = tr.Hits(res.t[cells.long()].reshape(-1), res.tri[cells.long()].reshape(-1),
                      torch.zeros_like(o[:, :2]), res.count[cells.long()].reshape(-1))
    out["cell_check"] = against_brute(mt, sampled, brute(o, d, mesh), o, d, mesh,
                                      "cell cast, 4096 cells")
    out["cell"] = dict(rays=n_sun, cap=sgrid.tri_of_slot.shape[1], peak_gib=peak,
                       build_s=sbuild, steady_s=out["s"]["cell_cast_parallel rpc 16 steady"])
    del sgrid, res, o, d

    # (e) the 3D grid: the bench's build and 10⁶-ray bundle (bench.py:435-470)
    t = time.perf_counter()
    grid3 = g3.build_grid3d_two_level(mesh.vertices, mesh.triangles)
    build3 = time.perf_counter() - t
    two = isinstance(grid3, g3.TwoLevelGrid)
    prim = grid3.primary if two else grid3
    log("raycast_grid", f"build_grid3d_two_level {build3:.3f}s (host): escalated to "
        f"TwoLevelGrid {two}; primary {prim.nx}x{prim.ny}x{prim.nz} cells of {prim.cell:.4f} m, "
        f"cap {prim.cap}, {prim.n_occupied} occupied, residual {prim.n_residual}"
        + (f"; sub {grid3.sub.nx}x{grid3.sub.ny}x{grid3.sub.nz}, cap {grid3.sub.cap}"
           if two else ""))
    n_bundle = 1_000_000
    o_b, d_b = (torch.as_tensor(x, device="cuda") for x in random_rays(mesh, n_bundle, 0, 2.0))
    torch.cuda.reset_peak_memory_stats()
    drive("two_level_cast 1e6 rays first",
          lambda: g3.two_level_cast(grid3, o_b, d_b, ray_tile=DDA_RAY_TILE), n_bundle)
    hb = drive("two_level_cast 1e6 rays steady",
               lambda: g3.two_level_cast(grid3, o_b, d_b, ray_tile=DDA_RAY_TILE), n_bundle)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    share = float(torch.isfinite(hb.t).float().mean())
    log("raycast_grid", f"two_level_cast (count_all=False, ray_tile {DDA_RAY_TILE}): "
        f"max_memory_allocated {peak:.3f} GiB, hit share {share:.4f}")
    n_chk = 65_536
    oc, dc = o_b[:n_chk], d_b[:n_chk]
    b = brute(oc, dc, mesh)
    sub = tr.Hits(hb.t[:n_chk], hb.tri[:n_chk], hb.uv[:n_chk], hb.count[:n_chk])
    out["grid3d_check"] = against_brute(mt, sub, b, oc, dc, mesh,
                                        "two_level_cast, first 65 536 rays", counts=False)
    hc = drive("two_level_cast count_all 65 536 rays",
               lambda: g3.two_level_cast(grid3, oc, dc, count_all=True), n_chk)
    out["grid3d_count_check"] = against_brute(mt, hc, b, oc, dc, mesh,
                                              "two_level_cast count_all, 65 536 rays")
    out["grid3d"] = dict(build_s=build3, two_level=two, peak_gib=peak,
                         first_s=out["s"]["two_level_cast 1e6 rays first"],
                         steady_s=out["s"]["two_level_cast 1e6 rays steady"])
    # phase 15 casts the same bundle through the wavefront and the sharded casts
    out["bundle"] = dict(mesh=mesh, grid3=grid3, o=o_b, d=d_b, dda=hb, dda_count_all=hc,
                         eye=eye, center=center, zup=zup, direction=direction)
    del hb

    # (f) the entry points that reach the grid on this mesh
    tr.clear_grid_cache()
    ha = drive("cast_rays(auto) 65 536 rays, grid build included",
               lambda: tr.cast_rays(oc, dc, mesh.vertices, mesh.triangles), n_chk)
    drive("cast_rays(auto) 65 536 rays, cached grid",
          lambda: tr.cast_rays(oc, dc, mesh.vertices, mesh.triangles), n_chk)
    if not all(torch.equal(x, y) for x, y in zip(ha, hc)):
        fail("cast_rays(auto) differs from two_level_cast(count_all=True) on the same grid")
    v = mesh.vertices.cpu().numpy()
    g = np.linspace(v.min(0), v.max(0), 64)
    gx, gy = np.meshgrid(g[:, 0], g[:, 1], indexing="xy")
    p = torch.as_tensor(np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, v[:, 2].mean())],
                                 1).astype(np.float32), device="cuda")
    occ = drive("occupancy 4096 points", lambda: tr.occupancy(p, mesh.vertices, mesh.triangles))
    occ_b = tr.occupancy(p, mesh.vertices, mesh.triangles, backend="kernel")
    log("raycast_grid", f"occupancy: {int(occ.sum())} of {p.shape[0]} inside, equal to the "
        f"brute parity {bool(torch.equal(occ, occ_b))}")
    if not torch.equal(occ, occ_b):
        fail("occupancy through the grid differs from the brute parity")
    for el in (30.0, 60.0, 90.0):
        sun = {bk: drive(f"sun_exposure el {el:g} {bk} 256x256",
                         lambda: tmr.sun_exposure(mesh, 180.0, el, 256, 256, backend=bk,
                                                  device="cuda"), 256 * 256)
               for bk in ("brute", "grid")}
        bs, gs = sun["brute"], sun["grid"]
        log("raycast_grid", f"sun el {el:g}: brute frac {bs.hit_fraction:.6f} areas "
            f"{bs.surface_area_3d:.4f}/{bs.surface_area_2d:.4f}; grid frac "
            f"{gs.hit_fraction:.6f} areas {gs.surface_area_3d:.4f}/{gs.surface_area_2d:.4f}")
        if bs.hit_fraction != gs.hit_fraction or any(
                abs(x - y) > 1e-4 * abs(x) for x, y in ((bs.surface_area_3d, gs.surface_area_3d),
                                                        (bs.surface_area_2d, gs.surface_area_2d))):
            fail(f"sun exposure at elevation {el:g} on the bench scene: backends disagree")
    torch.cuda.reset_peak_memory_stats()
    mri = drive("mri_slices 8x64x64",
                lambda: tmr.mri_slices(mesh, n_slices=8, resolution=64, device="cuda"),
                8 * 64 * 64)
    log("raycast_grid", f"mri_slices {tuple(mri.shape)} finite {bool(torch.isfinite(mri).all())}, "
        f"inside share {float((mri < 0).float().mean()):.4f}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB (its distance is brute in both "
        f"packages)")
    if mri.shape != (8, 64, 64) or not bool(torch.isfinite(mri).all()):
        fail("mri_slices on the bench scene gave no usable result")
    tr.clear_grid_cache()
    out["path_launches"] = dict(out["counts"])
    log("raycast_grid", f"launches over the path's drives: {out['path_launches']}")
    if out["path_launches"]["mt_raycast"] <= 0:
        fail("the raycast grid path never launched mt_raycast")

    # the card against the CPU on a small scene (a few thousand triangles)
    small = vm.simplify_mesh(raw, target_triangles=8000)
    small_cpu = TriMesh(small.vertices.cpu(), small.triangles.cpu())
    cmp = {}
    o_s, d_s = random_rays(small_cpu, 20_000, 1, 1.0)
    c_s = small_cpu.vertices.mean(dim=0)
    for dev, m in (("cuda", small), ("cpu", small_cpu)):
        cen = c_s.to(dev)
        ig = rg.build_image_grid(m.vertices, m.triangles, cen + torch.tensor(
            [0.0, -30.0, 18.0], device=dev), cen, zup.to(dev), 60.0, 160, 120)
        rgd = rg.build_ray_grid(m.vertices, m.triangles, direction)
        g3d = g3.build_grid3d(m.vertices, m.triangles)
        cmp[dev] = dict(
            image=rg.image_cast(ig),
            cell=rg.cell_cast_parallel(rgd, direction, rays_per_cell_side=4),
            grid=g3.grid_cast(g3d, torch.as_tensor(o_s, device=dev),
                              torch.as_tensor(d_s, device=dev), count_all=True))
    worst = 0.0
    for k in ("image", "cell", "grid"):
        a, b = cmp["cuda"][k], cmp["cpu"][k]
        ta, tb = a.t.cpu(), b.t
        fin = torch.isfinite(tb)
        equal = torch.equal(a.tri.cpu(), b.tri) and torch.equal(a.count.cpu(), b.count) and \
            torch.equal(torch.isfinite(ta), fin)
        rel = float(((ta - tb).abs() / tb.abs())[fin].max()) if bool(fin.any()) else 0.0
        worst = max(worst, rel)
        log("raycast_grid", f"card = CPU, {small.n_triangles()} triangles, {k}: tri and counts "
            f"equal {equal}, {int(fin.sum())} hits, t max rel {rel:.3e}")
        if not equal or rel > 1e-6:
            fail(f"card = CPU: the {k} cast differs between the card and the CPU")
    out["card_cpu_t_rel"] = worst
    out["small"] = dict(mesh=small, o=o_s, d=d_s)
    return out


def small_sharded_rank(scene: dict, mesh=None) -> dict:
    """The small scene's sharded cast (phase 15d): ``sharded_grid_cast``
    with every crossing counted, on this rank's device."""
    import torch

    from pyqsm_tpu_torch.ops import grid3d as g3
    from pyqsm_tpu_torch.parallel import raycast as pr

    dev = mesh.device
    g = g3.build_grid3d(torch.as_tensor(scene["vertices"], device=dev),
                        torch.as_tensor(scene["triangles"], device=dev))
    return pr.sharded_grid_cast(mesh, g, scene["o"], scene["d"], count_all=True)


def raycast_rank(scene: dict, mesh=None) -> dict:
    """One rank of phase 15c (every rank gets the same scene as numpy
    arrays and builds its grids on the host, as the single device does):
    each sharded cast twice (the second, warm, reported) with this rank's
    launch counters set to 0 just before each call and read just after,
    then the single-device call of the same cast on this rank's device,
    which both calls must equal bit for bit. ``mt_raycast`` is held
    against its plain version (``mt_bitwise``) on the rank's inputs of its
    two launches, outside the counted calls. Then the small scene's sharded
    cast of phase 15d."""
    import torch

    from pyqsm_tpu_torch.ops import band_matvec as bm
    from pyqsm_tpu_torch.ops import grid3d as g3
    from pyqsm_tpu_torch.ops import mt_raycast as mt
    from pyqsm_tpu_torch.ops import raygrid as rg
    from pyqsm_tpu_torch.ops import raytrace as tr
    from pyqsm_tpu_torch.parallel import raycast as pr

    dev = mesh.device
    cuda = dev.type == "cuda"  # a rehearsal on the CPU runs the same body

    def on(x):
        return torch.as_tensor(x, device=dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    out = dict(rank=mesh.rank, device=str(dev), backend=mesh.backend, world=mesh.size, casts={})
    counts = {k: 0 for k in launch_counts(bm, mt)}

    def drive(name, fn, single, rays):
        runs = []
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(2):
            sync()
            zero_launches(bm, mt)
            syncs = g3.SYNCS
            t0 = time.perf_counter()
            r = fn()
            sync()
            runs.append((r, time.perf_counter() - t0, launch_counts(bm, mt), g3.SYNCS - syncs))
        for _, _, n, _ in runs:
            for k, v in n.items():
                counts[k] += v
        ref = single()
        equal = [all(torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b
                     for a, b in zip(r, ref)) for r, _, _, _ in runs]
        (_, first_s, first_n, _), (_, s, n, syncs) = runs
        out["casts"][name] = dict(s=s, first_s=first_s, mrays_s=rays / s / 1e6,
                                  launches=n["mt_raycast"], first_launches=first_n["mt_raycast"],
                                  host_reads=syncs, equal=all(equal),
                                  peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30
                                  if cuda else 0.0)

    out["mt_plain"] = {}

    def plain_check(name, o, d, vertices, triangles):
        """``mt_raycast`` against its plain version on one launch's inputs."""
        if not cuda:
            return
        ok, first = mt_bitwise(mt, o, d, vertices, triangles)
        pl = mt.plan(o.shape[0], triangles.shape[0],
                     torch.cuda.get_device_properties(dev).multi_processor_count)
        out["mt_plain"][name] = dict(rays=o.shape[0], triangles=triangles.shape[0],
                                     slices=pl.slices, bitwise=ok, first_diff=first)

    v, f = on(scene["vertices"]), on(scene["triangles"])
    eye, center, zup = on(scene["eye"]), on(scene["center"]), on(scene["zup"])
    W, H = scene["image_wh"]
    grid = rg.build_image_grid(v, f, eye, center, zup, 60.0, W, H)
    drive(f"sharded_image_cast {W}x{H}", lambda: pr.sharded_image_cast(mesh, grid),
          lambda: rg.image_cast(grid), W * H)
    del grid
    W, H = scene["inside_wh"]
    grid = rg.build_image_grid(v, f, center, center + on(scene["inside_dir"]), zup, 90.0, W, H)
    out["inside_residual"] = int((grid.residual >= 0).sum())
    drive("sharded_image_cast eye inside", lambda: pr.sharded_image_cast(mesh, grid),
          lambda: rg.image_cast(grid), W * H)
    # the rank's launch of the residual pass: its pixels (pr._pixel_cast's
    # part) against the residual triangles
    o_px, d_px, v_res, f_res, _ = rg._residual_scene(grid)
    k, p, _ = pr._axis(mesh, "points")
    plain_check("residual pass", pr._padded_part(o_px, W * H, k, p, 0.0).contiguous(),
                pr._padded_part(d_px, W * H, k, p, 1.0).contiguous(), v_res, f_res)
    del grid, o_px, d_px
    direction, rpc = scene["direction"], scene["rays_per_cell_side"]
    sgrid = rg.build_ray_grid(v, f, direction)
    drive(f"sharded_cell_cast rpc {rpc}",
          lambda: pr.sharded_cell_cast(mesh, sgrid, direction, rays_per_cell_side=rpc),
          lambda: rg.cell_cast_parallel(sgrid, direction, rays_per_cell_side=rpc),
          sgrid.nx * sgrid.ny * rpc * rpc)
    del sgrid
    g = g3.build_grid3d_two_level(v, f)
    prim = g.primary if isinstance(g, g3.TwoLevelGrid) else g
    o, d = scene["o"], scene["d"]
    n = o.shape[0]
    # the single-device reference in tiles of a rank's share: a tile
    # changes no ray's result, and four one-tile casts of 10⁶ rays would
    # not fit on one card beside the ranks' own
    drive(f"sharded_grid_cast {n} rays",
          lambda: pr.sharded_grid_cast(mesh, prim, o, d, ray_tile=DDA_RAY_TILE),
          lambda: g3.grid_cast(prim, on(o), on(d), ray_tile=-(-n // mesh.size)), n)
    del g, prim
    v7, f7 = on(scene["vertices7"]), on(scene["triangles7"])
    o7, d7 = scene["o7"], scene["d7"]
    drive(f"sharded_cast_rays {o7.shape[0]} rays",
          lambda: pr.sharded_cast_rays(mesh, o7, d7, v7, f7),
          lambda: tr.cast_rays(on(o7), on(d7), v7, f7, backend="kernel"), o7.shape[0])
    part = pr._ray_part(o7.shape[0], mesh, "points", "sharded_cast_rays")
    plain_check("sharded_cast_rays", on(o7[part]).contiguous(), on(d7[part]).contiguous(), v7, f7)
    out["counts"] = counts
    out["small"] = small_sharded_rank(scene["small"], mesh=mesh)
    return out


def wavefront_path(bm, mt, g3, rgp: dict) -> dict:
    """Phase 15 (a)-(b): the wavefront caster on phase 14e's grid and
    bundle, held against its DDA hits. Each drive sets the launch counters
    to 0 just before and reads them just after."""
    import io

    import torch

    st = rgp["bundle"]
    grid3, o_b, d_b, hb, hc = st["grid3"], st["o"], st["d"], st["dda"], st["dda_count_all"]
    out = dict(counts={k: 0 for k in launch_counts(bm, mt)}, s={}, reads={})

    def drive(name, fn, rays):
        torch.cuda.synchronize()
        zero_launches(bm, mt)
        syncs = g3.SYNCS
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        n = launch_counts(bm, mt)
        for k, v in n.items():
            out["counts"][k] += v
        out["s"][name], out["reads"][name] = sec, g3.SYNCS - syncs
        log("wavefront", f"{name}: {sec:.4f}s, {rays / sec / 1e6:.3f} Mrays/s; launches {n}; "
            f"host reads {g3.SYNCS - syncs}")
        return r

    # (a) the wavefront on the 10⁶-ray bundle at its defaults
    n_b = o_b.shape[0]
    torch.cuda.reset_peak_memory_stats()
    first = drive("two_level_cast(wavefront=True) 1e6 rays first",
                  lambda: g3.two_level_cast(grid3, o_b, d_b, wavefront=True), n_b)
    hw = drive("two_level_cast(wavefront=True) 1e6 rays steady",
               lambda: g3.two_level_cast(grid3, o_b, d_b, wavefront=True), n_b)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g3.two_level_cast(grid3, o_b, d_b, wavefront=True, debug=True)
    rounds = [ln for ln in buf.getvalue().splitlines() if ln.startswith("#")]
    for ln in rounds:
        log("wavefront", f"debug call: {ln[2:]}")
    same_bits = all(torch.equal(a, b) for a, b in zip(first, hw))
    hit, hit_d = torch.isfinite(hw.t), torch.isfinite(hb.t)
    diff = hit_d & (hw.tri != hb.tri)
    rows = torch.nonzero(diff)[:, 0]
    prim = grid3.primary if isinstance(grid3, g3.TwoLevelGrid) else grid3

    def t_of(tri):
        """t of each differing ray against one triangle, by the casts' arithmetic."""
        k = tri[rows].long()
        o, d = o_b[rows], d_b[rows]
        return mt.mt_components(tuple(o[:, a] for a in range(3)), tuple(d[:, a] for a in range(3)),
                                tuple(prim.v0[k, a] for a in range(3)),
                                tuple(prim.e1[k, a] for a in range(3)),
                                tuple(prim.e2[k, a] for a in range(3)),
                                torch.ones_like(k, dtype=torch.bool))[0]

    ties = bool(torch.equal(t_of(hw.tri), hb.t[rows]) and torch.equal(t_of(hb.tri), hb.t[rows])) \
        if len(rows) else True
    check = dict(same_hits=bool(torch.equal(hit, hit_d)), t_bitwise=bool(torch.equal(hw.t, hb.t)),
                 tri_diff=int(diff.sum()), ties_same_t=ties, first_equals_steady=same_bits,
                 hits=int(hit.sum()))
    log("wavefront", f"against phase 14e's DDA on the same {n_b} rays: {check}; peak "
        f"max_memory_allocated {peak:.3f} GiB")
    if not (check["same_hits"] and check["t_bitwise"] and ties and same_bits):
        fail(f"the wavefront disagrees with the DDA on the 10⁶-ray bundle: {check}")
    # the same cast with every straggler kept on the rounds: the DDA tail
    # fallback is a host-stepped loop in the port
    h0 = drive("two_level_cast(wavefront=True, tail_fallback=0) 1e6 rays",
               lambda: g3.two_level_cast(grid3, o_b, d_b, wavefront=True, tail_fallback=0), n_b)
    check["no_tail_t_bitwise"] = bool(torch.equal(h0.t, hb.t))
    if not check["no_tail_t_bitwise"]:
        fail("the wavefront without its tail fallback disagrees with the DDA")
    del h0
    out["a"] = dict(check, peak_gib=peak, rounds=rounds,
                    first_s=out["s"]["two_level_cast(wavefront=True) 1e6 rays first"],
                    steady_s=out["s"]["two_level_cast(wavefront=True) 1e6 rays steady"],
                    reads=out["reads"]["two_level_cast(wavefront=True) 1e6 rays steady"],
                    no_tail_s=out["s"]["two_level_cast(wavefront=True, tail_fallback=0) 1e6 rays"],
                    no_tail_reads=out["reads"][
                        "two_level_cast(wavefront=True, tail_fallback=0) 1e6 rays"])

    # (b) every crossing counted, the first 65 536 rays
    n_chk = hc.t.shape[0]
    hwc = drive(f"two_level_cast(wavefront=True, count_all=True) {n_chk} rays",
                lambda: g3.two_level_cast(grid3, o_b[:n_chk], d_b[:n_chk], wavefront=True,
                                          count_all=True), n_chk)
    cnt_equal = bool(torch.equal(hwc.count, hc.count))
    log("wavefront", f"count_all against phase 14e's DDA count_all: counts equal {cnt_equal}, "
        f"t bit for bit {bool(torch.equal(hwc.t, hc.t))}, {int(hwc.count.sum())} crossings")
    if not cnt_equal:
        fail("the wavefront's count_all counts differ from the DDA's")
    out["b"] = dict(s=out["s"][f"two_level_cast(wavefront=True, count_all=True) {n_chk} rays"],
                    reads=out["reads"][f"two_level_cast(wavefront=True, count_all=True) {n_chk} rays"],
                    counts_equal=cnt_equal)
    return out


def raycast_scene(st: dict, mesh7, shapes: dict, small: dict) -> dict:
    """Phase 15c's inputs as numpy arrays, the same for every rank: phase
    14's kept mesh, cameras, sun direction and 10⁶-ray bundle, phase 7's
    mesh and cast_scene's rays, the small scene and its rays."""
    import numpy as np

    def host(x):
        return x.detach().cpu().numpy() if hasattr(x, "detach") else x

    o7, d7 = shapes["cast_scene"]
    sm = small["mesh"]
    scene = dict(vertices=host(st["mesh"].vertices), triangles=host(st["mesh"].triangles),
                 eye=host(st["eye"]), center=host(st["center"]), zup=host(st["zup"]),
                 image_wh=(1280, 950), inside_wh=(640, 480),
                 inside_dir=np.array([1.0, 0.3, 0.1], np.float32), direction=st["direction"],
                 rays_per_cell_side=16, o=host(st["o"]), d=host(st["d"]),
                 vertices7=host(mesh7.vertices), triangles7=host(mesh7.triangles), o7=host(o7),
                 d7=host(d7), small=dict(vertices=host(sm.vertices), triangles=host(sm.triangles),
                                         o=small["o"], d=small["d"]))
    return scene


def sharded_raycast_path(bm, mt, launch, scene: dict) -> dict:
    """Phase 15c: the four sharded casts over ``SHARDED_RANKS`` spawned
    ranks (NCCL with one card a rank where the machine has that many, else
    gloo with every rank on ``cuda:0``), each equal on every rank to the
    single-device call; ``mt_raycast`` launched once per rank by
    ``sharded_cast_rays`` and by the eye-inside image cast's residual pass,
    and equal to its plain version on each rank's inputs of both."""
    import torch

    out = dict(counts={k: 0 for k in launch_counts(bm, mt)})
    count = torch.cuda.device_count()
    backend = "nccl" if count >= SHARDED_RANKS else "gloo"
    log("sharded_raycast", f"{SHARDED_RANKS} ranks, backend {backend}, "
        f"{'one card a rank' if backend == 'nccl' else 'every rank on cuda:0'}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = launch(raycast_rank, SHARDED_RANKS, backend, args=(scene,),
                   device="cuda" if backend == "nccl" else "cuda:0", timeout=BUDGET_S)
    launch_s = time.perf_counter() - t
    bad = []
    for r in ranks:
        for name, c in r["casts"].items():
            log("sharded_raycast", f"rank {r['rank']} ({r['device']}, {r['backend']}) {name}: warm "
                f"{c['s']:.4f}s ({c['mrays_s']:.3f} Mrays/s; first {c['first_s']:.4f}s), "
                f"mt_raycast launches {c['launches']} (first call {c['first_launches']}), "
                f"host reads {c['host_reads']}, peak {c['peak_gib']:.3f} GiB, both calls equal "
                f"the single-device call bit for bit {c['equal']}")
            if not c["equal"]:
                bad.append((r["rank"], name))
        for k, v in r["counts"].items():
            out["counts"][k] += v
        for name, c in r["mt_plain"].items():
            log("sharded_raycast", f"rank {r['rank']} mt_raycast against its plain version on "
                f"the {name} launch's inputs, {c['rays']} rays x {c['triangles']} triangles "
                f"({c['slices']} slices): all four outputs bit for bit {c['bitwise']}")
            if not c["bitwise"]:
                bad.append((r["rank"], f"mt_raycast {name}: {c['first_diff']} differs"))
    log("sharded_raycast", f"launch and all ranks in {launch_s:.2f}s; eye-inside residual "
        f"{ranks[0]['inside_residual']} triangles")
    if bad:
        fail(f"sharded casts differ from the single-device call, or mt_raycast from its plain "
             f"version: {bad}")
    if any(len(r["mt_plain"]) != 2 for r in ranks):
        fail("a rank did not hold both of its mt_raycast launches against the plain version")
    for r in ranks:
        c = r["casts"]
        inside = c["sharded_image_cast eye inside"]
        brute = [v for k, v in c.items() if k.startswith("sharded_cast_rays")][0]
        if inside["launches"] < 1 or inside["first_launches"] < 1:
            fail(f"rank {r['rank']}: the eye-inside sharded cast did not launch mt_raycast")
        if brute["launches"] != 1 or brute["first_launches"] != 1:
            fail(f"rank {r['rank']}: sharded_cast_rays launched mt_raycast "
                 f"{brute['launches']} times, not once")
    out.update(backend=backend, launch_s=launch_s, ranks=ranks)
    return out


def small_card_cpu(g3, launch, small: dict, card_ranks: list) -> float:
    """Phase 15d: on the small scene the wavefront (one device) and the
    sharded grid cast (phase 15c's ranks on the card, 4 gloo ranks on the
    CPU) on the card and on the CPU: tri and counts equal, t within 1e-6
    relative. Returns the largest relative t difference."""
    import torch

    sm = small["mesh"]
    scene = dict(vertices=sm.vertices.cpu().numpy(), triangles=sm.triangles.cpu().numpy(),
                 o=small["o"], d=small["d"])
    cpu_ranks = launch(small_sharded_rank, SHARDED_RANKS, "gloo", args=(scene,), device="cpu",
                       timeout=BUDGET_S)
    wf = {}
    for key, (v, f) in (("card", (sm.vertices, sm.triangles)),
                        ("cpu", (sm.vertices.cpu(), sm.triangles.cpu()))):
        g = g3.build_grid3d(v, f)
        wf[key] = g3.grid_cast_wavefront(g, torch.as_tensor(small["o"], device=v.device),
                                         torch.as_tensor(small["d"], device=v.device),
                                         count_all=True)
    worst = 0.0
    pairs = [("wavefront", wf["card"], wf["cpu"])] + [
        (f"sharded_grid_cast rank {i}", r["small"], c) for i, (r, c) in
        enumerate(zip(card_ranks, cpu_ranks))]
    for label, a, b in pairs:
        ta, tb = a.t.cpu(), b.t.cpu()
        fin = torch.isfinite(tb)
        equal = torch.equal(a.tri.cpu(), b.tri.cpu()) and torch.equal(a.count.cpu(), b.count.cpu()) \
            and torch.equal(torch.isfinite(ta), fin)
        rel = float(((ta - tb).abs() / tb.abs())[fin].max()) if bool(fin.any()) else 0.0
        worst = max(worst, rel)
        log("wavefront", f"card = CPU, {sm.n_triangles()} triangles, {label}: tri and counts "
            f"equal {equal}, {int(fin.sum())} hits, t max rel {rel:.3e}")
        if not equal or rel > 1e-6:
            fail(f"card = CPU: {label} differs between the card and the CPU")
    return worst


def walk_tree(sampling, pts, labels, tree_id: int, walk_points: int):
    """One tree's rows of the plot voxel-laddered as the bench's walk
    (bench.py:498-508): voxel 0.03 m, grown 1.3× until at most
    ``walk_points`` live rows remain, then compacted (numpy, live rows)."""
    import torch

    rows = labels == tree_id
    voxel = 0.03
    p2, m2, _ = sampling.voxel_downsample(pts, voxel, rows)
    while int(m2.sum()) > walk_points and voxel < 0.5:
        voxel *= 1.3
        p2, m2, _ = sampling.voxel_downsample(pts, voxel, rows)
    return p2[m2].cpu().numpy(), voxel


def walk_seed(tree, block: int = 1024):
    """The bench's seed front: rows below zmin + 0.5 m, at most ``block``."""
    import numpy as np

    z = tree[:, 2]
    rows = np.flatnonzero(z < z.min() + 0.5)
    seed = np.full(block, -1, np.int32)
    seed[:min(len(rows), block)] = rows[:block]
    return seed


def qsm_walk_path(tq, cfg, tree) -> dict:
    """Phase 16a: the bench's sphere walk (bench.py:509-532) on the main
    path's largest tree, a first and a steady call."""
    import numpy as np
    import torch

    seed = walk_seed(tree)
    out = {}
    for call in ("first", "steady"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tq.SYNCS = 0
        t0 = time.perf_counter()
        res = tq.sphere_following_qsm(tree, np.ones(len(tree), bool), seed, seed >= 0, 0.3,
                                      sphere=cfg.sphere, dbscan_cfg=cfg.dbscan, max_steps=48,
                                      device="cuda")
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        c = res.cylinders
        m = c.mask
        finite = all(bool(torch.isfinite(getattr(c, f)[m]).all())
                     for f in ("center", "axis", "height", "radius"))
        out[call] = dict(s=s, steps=res.n_steps, cylinders=int(c.count()), syncs=tq.SYNCS,
                         found=int(res.found.sum()), finite=finite,
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                         median_radius=float(c.radius[m].median()) if bool(m.any()) else None)
        log("qsm_walk", f"{call} call: {len(tree)} points, seed {int((seed >= 0).sum())} rows: "
            f"{s:.3f}s, {res.n_steps} steps, {out[call]['cylinders']} cylinders (median radius "
            f"{out[call]['median_radius']}), {out[call]['found']} rows claimed, {tq.SYNCS} host "
            f"reads, max_memory_allocated {out[call]['peak_gib']:.3f} GiB, finite {finite}")
        if out[call]["cylinders"] < 1 or not finite:
            fail(f"sphere walk ({call}): no cylinder or non-finite cylinder values")
    out["breakdown"] = walk_breakdown(tq, cfg, tree, seed)
    return out


WALK_PARTS = {"chain": "_qsm_chain_fused", "wave": "_qsm_wave_fused",
              "policy": "_process_front_policy", "eps_floor": "_eps_floor"}


def walk_breakdown(tq, cfg, tree, seed) -> dict:
    """Where the steady walk's time goes: a third call with its parts
    timed (each synchronised; the policy includes the k-means sweeps), and
    a fourth under ``torch.profiler`` for the card's busy time (the sum of
    the kernels' device time against the wall)."""
    import numpy as np
    import torch

    args = (tree, np.ones(len(tree), bool), seed, seed >= 0, 0.3)
    kw = dict(sphere=cfg.sphere, dbscan_cfg=cfg.dbscan, max_steps=48, device="cuda")
    with timing(tq, WALK_PARTS) as times:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tq.sphere_following_qsm(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {"wall_s": wall}
    for part, got in times.items():
        out[part] = dict(calls=len(got), s=sum(t for t, _ in got))
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tq.sphere_following_qsm(*args, **kw)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        ev = prof.key_averages()
        dev_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                     for e in ev)
        top = sorted(ev, key=lambda e: -getattr(e, "self_device_time_total",
                                                 getattr(e, "self_cuda_time_total", 0)))[:5]
        out["profiled"] = dict(
            wall_s=pwall, device_s=dev_us / 1e6,
            busy_share=dev_us / 1e6 / pwall if pwall > 0 else None,
            kernels=sum(e.count for e in ev if getattr(e, "device_type", None) is not None
                        and "CUDA" in str(e.device_type)),
            top=[(e.key[:60], getattr(e, "self_device_time_total",
                                      getattr(e, "self_cuda_time_total", 0)) / 1e3)
                 for e in top])
    except Exception as exc:  # noqa: BLE001 — the busy share is then not measured
        out["profiled"] = f"not measured ({type(exc).__name__}: {exc})"
    log("qsm_walk", f"steady walk's parts (synchronised): wall {wall:.3f}s, " + ", ".join(
        f"{p} {v['calls']} calls {v['s']:.3f}s" for p, v in out.items()
        if isinstance(v, dict) and "calls" in v) + f"; under the profiler: {out['profiled']}")
    return out


def qsm_cli_path(cli, artifacts, readers, mt, tree) -> dict:
    """Phase 16b: the CLI's entry points on the tree written by the port's
    ``write_npz``: ``qsm_generation_main`` (sphere, 256 steps), whose
    cylinder file must read back with the count it printed, then
    ``raycast_main`` and ``tree_isolation_main`` on the same file."""
    import io
    import tempfile
    from pathlib import Path

    import torch

    out = {}
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "tree.npz"
        readers.write_npz(path, tree)
        for name, main, argv in (
                ("qsm_generation", cli.qsm_generation_main, ["--max-steps", "256"]),
                ("raycast", cli.raycast_main, []),
                ("tree_isolation", cli.tree_isolation_main,
                 ["--base-min-points", "200", "--low-pctile", "4"])):
            before = mt.LAUNCHES
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = main([str(path), "-o", d] + argv)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            printed = buf.getvalue().strip()
            out[name] = dict(rc=rc, s=s, mt_raycast_launches=mt.LAUNCHES - before,
                             printed=printed)
            log("qsm_cli", f"{name}_main: rc {rc}, {s:.3f}s, mt_raycast launches "
                f"{out[name]['mt_raycast_launches']}: {printed}")
            if rc != 0:
                fail(f"{name}_main returned {rc}")
        cyl = artifacts.load_cylinders(Path(d) / "tree_qsm.npz")
        n_printed = int(out["qsm_generation"]["printed"].split()[0])
        out["qsm_generation"]["cylinders"] = int(cyl.count())
        iso = readers.read_npz(Path(d) / "tree_trees.npz")
        labels = iso["labels"]
        out["tree_isolation"]["trees"] = int(len(set(labels[labels >= 0].tolist())))
        exposure = artifacts.load_metrics(Path(d) / "tree_exposure.json")
        out["raycast"]["n_triangles"] = exposure["n_triangles"]
    log("qsm_cli", f"cylinder file reads back {out['qsm_generation']['cylinders']} cylinders "
        f"(printed {n_printed}); raycast mesh {out['raycast']['n_triangles']} triangles; "
        f"isolation found {out['tree_isolation']['trees']} trees")
    if out["qsm_generation"]["cylinders"] != n_printed or n_printed < 1:
        fail("qsm_generation_main's cylinder file does not read back its count")
    if out["raycast"]["n_triangles"] < 1 or out["tree_isolation"]["trees"] < 1:
        fail("raycast_main or tree_isolation_main wrote an empty artifact")
    return out


def forest_inputs(trees: list, block: int = 1024):
    """Trees (numpy [n_i, 3] clouds) as the forest's padded [T, Np, 3]
    clouds, masks, seed fronts (the bench's seed rule) and radii."""
    import numpy as np

    npad = max(len(t) for t in trees)
    points = np.zeros((len(trees), npad, 3), np.float32)
    mask = np.zeros((len(trees), npad), bool)
    seeds = np.full((len(trees), block), -1, np.int32)
    for i, t in enumerate(trees):
        points[i, :len(t)], mask[i, :len(t)] = t, True
        seeds[i] = walk_seed(t, block)
    return points, mask, seeds, seeds >= 0, [0.3] * len(trees)


FOREST_KW = dict(max_steps=48)


def qsm_forest_rank(inputs, mesh=None) -> dict:
    """One rank of phase 16c: ``sphere_qsm_forest(mesh=)`` on the whole
    forest (every rank gets the same numpy inputs and returns all trees)."""
    import torch

    from pyqsm_tpu_torch.models import qsm as tq

    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    res = tq.sphere_qsm_forest(*inputs, mesh=mesh, device=mesh.device, **FOREST_KW)
    torch.cuda.synchronize(mesh.device)
    return dict(rank=mesh.rank, device=str(mesh.device), backend=mesh.backend,
                s=time.perf_counter() - t0, results=res)


def same_walk(a, b) -> bool:
    import torch

    return (a.n_steps == b.n_steps and torch.equal(a.found.cpu(), b.found.cpu())
            and torch.equal(a.branch_order.cpu(), b.branch_order.cpu())
            and all(torch.equal(getattr(a.cylinders, f).cpu(), getattr(b.cylinders, f).cpu())
                    for f in a.cylinders._fields))


def qsm_forest_path(tq, launch, trees: list) -> dict:
    """Phase 16c: ``sphere_qsm_forest`` over the plot's trees (each
    voxel-laddered as phase 16a's) on the card;
    two trees alone against their rows of the batch, bit for bit; then
    ``SHARDED_RANKS`` ranks (NCCL with a card each on a four-card machine,
    gloo on ``cuda:0`` otherwise) against the single-device forest."""
    import torch

    inputs = forest_inputs(trees)
    out = {"n_points": [int(m.sum()) for m in inputs[1]]}
    for call in ("first", "steady"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tq.sphere_qsm_forest(*inputs, device="cuda", **FOREST_KW)
        torch.cuda.synchronize()
        out[f"{call}_s"] = time.perf_counter() - t0
    out["cylinders"] = [int(r.cylinders.count()) for r in res]
    out["steps"] = [r.n_steps for r in res]
    log("qsm_forest", f"{len(trees)} trees ({out['n_points']} points): first call "
        f"{out['first_s']:.3f}s, steady {out['steady_s']:.3f}s; cylinders {out['cylinders']}, "
        f"steps {out['steps']}")
    if min(out["cylinders"]) < 1:
        fail("a tree of the forest has no cylinder")
    singles = {}
    for i in (0, len(trees) - 1):
        one = tuple(x[i:i + 1] for x in inputs[:4]) + (inputs[4][i:i + 1],)
        alone = tq.sphere_qsm_forest(*one, seeds=[i], device="cuda", **FOREST_KW)[0]
        singles[i] = same_walk(alone, res[i])
    out["batch_invariant"] = singles
    log("qsm_forest", f"forest([i]) equals the batch's tree i bit for bit: {singles}")
    if not all(singles.values()):
        fail("the forest's per-tree results depend on the batch")
    count = torch.cuda.device_count()
    backend = "nccl" if count >= SHARDED_RANKS else "gloo"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(qsm_forest_rank, SHARDED_RANKS, backend, args=(inputs,),
                   device="cuda" if backend == "nccl" else "cuda:0", timeout=BUDGET_S)
    out["sharded"] = dict(backend=backend, launch_s=time.perf_counter() - t0,
                          rank_s=[r["s"] for r in ranks],
                          equal=[all(same_walk(a, b) for a, b in zip(r["results"], res))
                                 for r in ranks])
    log("qsm_forest", f"{SHARDED_RANKS} ranks ({backend}, devices "
        f"{[r['device'] for r in ranks]}): forest(mesh=) in {out['sharded']['rank_s']} s "
        f"(launch {out['sharded']['launch_s']:.2f}s); every rank's forest equals the "
        f"single-device one bit for bit: {out['sharded']['equal']}")
    if not all(out["sharded"]["equal"]):
        fail("the sharded forest differs from the single-device forest")
    return out


def y_tree(seed: int):
    """A trunk forking into two branches (tests/test_qsm.py's Y tree)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def branch(n, r, length, axis, base):
        axis = np.asarray(axis, float) / np.linalg.norm(axis)
        ref = np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9 else np.array([0, 1.0, 0])
        u = np.cross(axis, ref)
        u /= np.linalg.norm(u)
        v = np.cross(axis, u)
        t, th = rng.uniform(0, length, n), rng.uniform(0, 2 * np.pi, n)
        rr = r + rng.normal(0, 0.005, n)
        return (t[:, None] * axis + rr[:, None] * (np.cos(th)[:, None] * u
                                                   + np.sin(th)[:, None] * v) + base)

    return np.concatenate([branch(3000, 0.25, 4.0, [0, 0, 1], [0, 0, 0]),
                           branch(1500, 0.12, 3.0, [0.7, 0, 0.7], [0, 0, 4.0]),
                           branch(1500, 0.12, 3.0, [-0.7, 0, 0.7], [0, 0, 4.0])]
                          ).astype(np.float32)


def qsm_card_cpu(tq, seed: int) -> dict:
    """Phase 16d: the walk on a small Y-shaped tree on the card and on the
    CPU from the same draws: discrete outputs equal, floats within 1e-4."""
    import numpy as np
    import torch

    tree = y_tree(seed)
    s = np.full(256, -1, np.int32)
    rows = np.flatnonzero(tree[:, 2] < 0.4)[:256]
    s[:len(rows)] = rows
    kw = dict(block_size=256, max_steps=128, seed=seed)
    card = tq.sphere_following_qsm(tree, np.ones(len(tree), bool), s, s >= 0, 0.25,
                                   device="cuda", **kw)
    cpu = tq.sphere_following_qsm(tree, np.ones(len(tree), bool), s, s >= 0, 0.25,
                                  device="cpu", **kw)
    cc, pc = card.cylinders, cpu.cylinders
    discrete = (card.n_steps == cpu.n_steps
                and torch.equal(card.found.cpu(), cpu.found)
                and torch.equal(card.branch_order.cpu(), cpu.branch_order)
                and all(torch.equal(getattr(cc, f).cpu(), getattr(pc, f))
                        for f in ("mask", "branch_order", "parent")))
    m = pc.mask
    err = max(float((getattr(cc, f).cpu()[m] - getattr(pc, f)[m]).abs().max())
              for f in ("center", "axis", "height", "radius")) if discrete and bool(m.any()) \
        else float("inf")
    out = dict(steps=card.n_steps, cylinders=int(cc.count()), discrete_equal=discrete,
               max_abs_err=err, orders=sorted(set(pc.branch_order[m].tolist())))
    log("qsm_card_cpu", f"Y tree ({len(tree)} points): card and CPU {card.n_steps}/"
        f"{cpu.n_steps} steps, {int(cc.count())}/{int(pc.count())} cylinders, found, branch "
        f"orders, cylinder orders and parents equal {discrete}; centres, axes, radii, heights "
        f"max abs err {err:.3e} (tol 1e-4); branch orders {out['orders']}")
    if not discrete or err > 1e-4:
        fail("the walk on the card differs from the walk on the CPU")
    if max(out["orders"]) < 1:
        fail("the Y tree's walk never split at the fork")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=2_000_000,
                    help="plot size of the main-path run (the bench measures 10 000 000)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    adopt_orphans()

    def on_alarm(signum, frame):
        fail(f"wall-clock budget of {BUDGET_S} s exceeded")

    signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(BUDGET_S)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card", 2)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from pyqsm_tpu_torch.config import Config, IsolationConfig, RaycastConfig
        from pyqsm_tpu_torch.models import canopy
        from pyqsm_tpu_torch.models import isolation as ti
        from pyqsm_tpu_torch.models import plot_pipeline as pp
        from pyqsm_tpu_torch.models import raycast as tmr
        from pyqsm_tpu_torch.models import skeleton as sk
        from pyqsm_tpu_torch.models.plot_pipeline import process_plot
        from pyqsm_tpu_torch.ops import band_matvec as bm
        from pyqsm_tpu_torch.ops import cuda_build
        from pyqsm_tpu_torch.ops import grid3d as g3
        from pyqsm_tpu_torch.ops import laplacian as lap
        from pyqsm_tpu_torch.ops.mesh import TriMesh
        from pyqsm_tpu_torch.ops import mt_raycast as mt
        from pyqsm_tpu_torch.ops import raygrid as rg
        from pyqsm_tpu_torch.ops import raytrace as tr
        from pyqsm_tpu_torch.ops import sparse as sp
        from pyqsm_tpu_torch.ops import voxelmesh as vm
        from pyqsm_tpu_torch.parallel.mesh import launch
        from pyqsm_tpu_torch.io import artifacts, readers
        from pyqsm_tpu_torch.models import qsm as tq
        from pyqsm_tpu_torch.ops import sampling
        from pyqsm_tpu_torch.pipeline import cli
    except ImportError as exc:
        fail(f"the pyqsm_tpu_torch package is not beside this script ({exc})", 3)

    # 1. device and power
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi unavailable (rc {smi.returncode})"
    log("device", f"{kind} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}; {smi_line}")

    # 2. kernel builds from the checkout's sources, one nvcc each, in parallel
    t_build = time.perf_counter()
    libs = {"band_matvec": bm.LIB, "band_matvec_t": bm.LIB_T, "mt_raycast": mt.LIB,
            "band_matvec_bf16": bm.LIB_BF16}
    paths = cuda_build.build_all(libs.values())
    for lib in libs.values():
        lib.load()
    log("build", f"{[p.name for p in paths]} in {time.perf_counter() - t_build:.2f}s")
    for name, lib in libs.items():
        for ln in lib.log.splitlines():
            if any(w in ln for w in ("registers", "spill", "smem", "Compiling entry")):
                print(f"    ptxas {name}: {ln.strip()}", flush=True)
    smem = {c: bm.LIB_BF16.load().band_matvec_bf16_smem_bytes(c) for c in bm.BF16_WIDTHS}
    log("build", f"band_matvec_bf16 dynamic shared memory a block, by C: {smem}")

    # 3. band kernels vs plain at the path's shapes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = {}
    for kname, transpose in (("band_matvec", False), ("band_matvec_t", True)):
        for name, nb in (("fine", 160), ("coarse", 40)):
            c = check_band(bm, (N_TREES, nb), args.seed, transpose)
            checks[(kname, name)] = c
            log("kernel", f"{kname} {name} {c['shape']}: max_abs_err {c['max_abs_err']:.3e} "
                f"(tol {c['tol']:.3e}), max_rel_err {c['max_rel_err']:.3e}; kernel "
                f"{c['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
                f"{c['gbytes']:.3f} GB), plain {c['plain_ms']:.4f} ms, torch.bmm "
                f"{c['bmm_ms']:.4f} ms")
            if not c["ok"]:
                fail(f"{kname} {name}: kernel disagrees with its plain version")

    # 4. small-input reference: the card against the port's CPU path
    small = two_tree_plot(args.seed)
    small_iso = IsolationConfig(base_min_points=15, low_pctile=5.0, max_dist=0.35, cycles=200,
                                min_frontier=2)
    small_kw = dict(iso_cfg=small_iso, skeleton_voxel=0.08, max_skeleton_points=2048,
                    min_tree_points=300)
    r_gpu = process_plot(small, np.ones(len(small), bool), device="cuda", **small_kw)
    r_cpu = process_plot(small, np.ones(len(small), bool), device="cpu", **small_kw)
    ids_gpu = [(t.tree_id, t.n_points) for t in r_gpu.trees]
    ids_cpu = [(t.tree_id, t.n_points) for t in r_cpu.trees]
    labels_equal = bool(torch.equal(r_gpu.growth.labels.cpu(), r_cpu.growth.labels))
    rad = [(float(g.cylinders.radius[g.cylinders.mask].median()),
            float(c.cylinders.radius[c.cylinders.mask].median()))
           for g, c in zip(r_gpu.trees, r_cpu.trees)]
    log("reference", f"two-tree plot: cuda trees {ids_gpu}, cpu trees {ids_cpu}, labels equal "
        f"{labels_equal}, median radius cuda/cpu {rad}")
    if ids_gpu != ids_cpu or len(ids_gpu) != 2 or not labels_equal:
        fail("two-tree plot: the card and the CPU disagree on the trees")
    if any(abs(g - c) > 0.05 * abs(c) for g, c in rad):
        fail("two-tree plot: median cylinder radius differs by more than 5 %")

    # 5. the main path at the bench's widths
    pts = synthetic_plot(args.points, N_TREES, args.seed, "cuda")
    mask = torch.ones(pts.shape[0], dtype=torch.bool, device="cuda")
    iso_kw = dict(base_min_points=200, low_pctile=4.0, max_dist=0.2, cycles=400, min_frontier=3)
    iso_cfg = IsolationConfig(**iso_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log("main", f"process_plot on {pts.shape[0]} points, {N_TREES} trees")
    bm.LAUNCHES = bm.LAUNCHES_T = bm.LAUNCHES_BF16 = mt.LAUNCHES = 0
    t_main = time.perf_counter()
    plot_kw = dict(skeleton_voxel=0.03, max_skeleton_points=40_000, min_tree_points=2000)
    res = process_plot(pts, mask, Config(), iso_cfg, **plot_kw,
                       progress=lambda stage, s: log("main", f"stage {stage} {s:.3f}s"),
                       device="cuda")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = bm.LAUNCHES
    main_counts = launch_counts(bm, mt)
    n_cyl = [int(t.cylinders.count()) for t in res.trees]
    finite = all(bool(torch.isfinite(t.cylinders.radius).all())
                 and bool(torch.isfinite(t.cylinders.center).all()) for t in res.trees)
    log("main", f"trees found {len(res.trees)} (ids {[t.tree_id for t in res.trees]}, points "
        f"{[t.n_points for t in res.trees]}), cylinders {n_cyl} total {sum(n_cyl)}; "
        f"growth cycles {res.growth.cycles_run} claim {res.growth.claim}; stages {res.timings}; "
        f"total {main_s:.2f}s; band_matvec launches {launches} (band_matvec_bf16 "
        f"{bm.LAUNCHES_BF16}); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(res.trees) != N_TREES:
        fail(f"found {len(res.trees)} trees, the plot holds {N_TREES}")
    if not finite or min(n_cyl) < 1:
        fail("a tree has no cylinders or non-finite cylinder values")
    if launches <= 0:
        fail("the main path never launched band_matvec")
    # determinism: the same call again gives the same bits
    t_again = time.perf_counter()
    again = process_plot(pts, mask, Config(), iso_cfg, **plot_kw, device="cuda")
    torch.cuda.synchronize()
    same_bits = torch.equal(again.growth.labels, res.growth.labels) and \
        len(again.trees) == len(res.trees) and all(
            torch.equal(getattr(a.cylinders, f), getattr(b.cylinders, f))
            for a, b in zip(again.trees, res.trees) for f in b.cylinders._fields)
    log("main", f"second process_plot on the same plot in {time.perf_counter() - t_again:.2f}s "
        f"(stages {again.timings}): labels and every cylinder field equal bit for bit: "
        f"{same_bits}")
    if not same_bits:
        fail("two process_plot runs on the same plot differ")
    del again

    # 6. the Lᵀ path without a Wᵀ band: band_matvec_t against band_matvec
    lt = check_lt_path(bm, sp, lap, args.seed, N_TREES, 160)
    log("lt_path", f"laplacian_rmatvec {lt['shape']} without b_w_t: band_matvec_t launches "
        f"{lt['launches']} (band_matvec {lt['fwd_launches']}), max_abs_err vs the Wᵀ-band "
        f"route {lt['max_abs_err']:.3e} (tol {lt['tol']:.3e}); spill overflow "
        f"{lt['spill_overflow']}; sorted spill sums equal the CPU's bit for bit "
        f"{lt['spill_equal']}")
    if not lt["ok"]:
        fail("Lᵀ x through band_matvec_t disagrees with the Wᵀ-band route")
    if not lt["spill_equal"]:
        fail("the sorted spill sums on the card differ from the CPU's")
    if lt["launches"] <= 0 or lt["fwd_launches"] != 0:
        fail("the Lᵀ path without a Wᵀ band did not run through band_matvec_t alone")

    # 7. the raycast path on the main path's canopy
    cfg = RaycastConfig()
    ray = raycast_path(tr, tmr, rg, vm, mt, pts, cfg, args.seed)
    mesh = ray["mesh"]

    # 8. mt_raycast vs plain at the path's shapes on that mesh, then its edge cases
    shapes = mt_shapes(tr, tmr, mesh, cfg)
    mts = {}
    for label, (o, d) in shapes.items():
        c = check_mt_raycast(mt, o, d, mesh, label)
        mts[label] = c
        sh, pl = c["shares"], c["plan"]
        log("kernel", f"mt_raycast {label} {c['rays']} rays x {c['triangles']} triangles: "
            f"{c['hit_rays']} hit; tri equal {c['tri_equal']}, count equal "
            f"{c['count_equal']}, all four outputs bit for bit {c['bitwise']} (t max rel "
            f"{c['t_max_rel']:.3e}); kernel {c['ms']:.4f} ms a call, {c['graph_ms']:.4f} ms "
            f"on the card (graph replay; {c['grays_s']:.3f} Grays/s), "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}: the {c['ops']} ops these rays need, "
            f"{c['ops_per_pair']:.2f} a pair, at 67 TFLOP/s), the same ops as unfused "
            f"instructions at 33.5 T/s {c['instr_ms']:.4f} ms, {MT_OPS_PER_PAIR} ops for every "
            f"pair at 67 TFLOP/s {c['full_ms']:.4f} ms; plain {c['plain_ms']:.4f} ms; pairs passing stage 1 {sh['pair_stage1']:.4f}, "
            f"stage 2 {sh['pair_stage2']:.4f}; warp-triangle pairs with a lane passing "
            f"stage 1 {sh['warp_stage1']:.4f}, stage 2 {sh['warp_stage2']:.4f}; plan "
            f"{pl['slices']} slices of {pl['per_slice']} triangles, {pl['tiles']} ray tiles of "
            f"{pl['threads']}, chunk {pl['chunk']} x {pl['buffers']}")
        if not c["ok"]:
            fail(f"mt_raycast {label}: kernel differs from its plain version")
    edges = check_mt_edges(mt, mesh, shapes)
    for e in edges:
        log("kernel", f"mt_raycast edge case {e['case']}: {e['rays']} rays x {e['triangles']} "
            f"triangles, plan {e['plan']} ({e['slices']} slices): bit for bit {e['bitwise']}")
    bad = [e for e in edges if not e["bitwise"]]
    if bad:
        fail(f"mt_raycast edge cases differ from the plain version: "
             f"{[(e['case'], e['plan'], e['first_diff']) for e in bad]}")

    # 9. the band-claim path on the main path's plot
    main_trees = [(t.tree_id, t.n_points) for t in res.trees]
    claim = band_claim_path(ti, bm, process_plot, Config, pts, mask, iso_cfg, main_trees, plot_kw)
    band = claim["band_info"]

    # 10. band_matvec_bf16 vs plain at the claim's shape and at C = 128
    nb_claim = band["rows"] // bm.BAND_BLOCK
    bf = {}
    for label, c in (("claim", band["cluster_cap"]), ("c128", 128)):
        r = check_band_bf16(bm, nb_claim, c, args.seed)
        bf[label] = r
        log("kernel", f"band_matvec_bf16 {label} {r['shape']} C={c}: 0/1 inputs equal "
            f"{r['exact01']} (max count {r['max_count']:g}), random bf16 within "
            f"768·2⁻²⁴·Σ|W||x| {r['within']} (max_abs_err {r['max_abs_err']:.3e}); kernel "
            f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['gbytes']:.3f} GB), plain {r['plain_ms']:.4f} ms, torch.bmm {r['bmm_ms']:.4f} ms")
        if not r["ok"]:
            fail(f"band_matvec_bf16 {label}: kernel disagrees with its plain version")
    widths = check_bf16_widths(bm, args.seed, prepadded=False)
    report_widths("band_matvec_bf16", widths)

    # 11. the sharded path over 4 ranks, against phases 5 and 9. On one card
    # the 4 ranks share it with this process: hand back the blocks this
    # process's allocator holds free, or the ranks' kNN can run out of memory
    torch.cuda.empty_cache()
    shd = sharded_path(launch, pts, iso_kw, plot_kw, claim, main_trees, n_cyl,
                       median_radii(res.trees))
    rank_band = shd["ranks"][0][("band", 2)]["band"]

    # 12. the halo form of band_matvec_bf16 vs plain at a rank's shape and C = 128
    halo = {}
    for label, c in (("rank", rank_band["cluster_cap"]), ("c128", 128)):
        r = check_band_bf16(bm, rank_band["rows"] // bm.BAND_BLOCK, c, args.seed + 1,
                            prepadded=True)
        halo[label] = r
        log("kernel", f"band_matvec_bf16 halo {label} {r['shape']} C={c}, random halo blocks: "
            f"0/1 inputs equal {r['exact01']} (max count {r['max_count']:g}), random bf16 "
            f"within 768·2⁻²⁴·Σ|W||x| {r['within']} (max_abs_err {r['max_abs_err']:.3e}); "
            f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['gbytes']:.3f} GB), plain {r['plain_ms']:.4f} ms, torch.bmm {r['bmm_ms']:.4f} ms")
        if not r["ok"]:
            fail(f"band_matvec_bf16 halo {label}: kernel disagrees with its plain version")
    halo_widths = check_bf16_widths(bm, args.seed + 1, prepadded=True)
    report_widths("band_matvec_bf16 halo", halo_widths)

    # 13. the canopy path: (a) process_plot(with_metrics=True) on the main
    # path's plot, (b) the single-tree path on its largest tree's batch row,
    # (c) the card against the CPU on the two-tree reference plot
    torch.cuda.empty_cache()
    cp = canopy_path(bm, mt, pp, canopy, pts, mask, Config, iso_cfg, plot_kw, res, launches)
    check_canopy_path(cp, res)
    single = single_tree_path(bm, mt, sk, canopy, cp, Config().skeletonize)
    card_equals_cpu(sk, canopy, small, r_gpu.growth, r_gpu.trees, Config().skeletonize)

    # 14. the ray-casting path at the bench's scene: the image grid, the cell
    # cast and the 3D grid on the canopy mesh decimated to 400 000 triangles
    torch.cuda.empty_cache()
    rgp = raycast_grid_path(bm, mt, tr, tmr, rg, g3, vm, TriMesh, ray, cfg)

    # 15. the wavefront caster and the sharded casts on phase 14's scene
    torch.cuda.empty_cache()
    wfp = wavefront_path(bm, mt, g3, rgp)
    scene = raycast_scene(rgp["bundle"], ray["mesh"], shapes, rgp["small"])
    rgp["bundle"].clear()  # phase 14's grid and DDA hits: the ranks share the card
    shr = sharded_raycast_path(bm, mt, launch, scene)
    wfp["card_cpu_t_rel"] = small_card_cpu(g3, launch, rgp["small"], shr["ranks"])

    # 16. the sphere-following QSM on the main path's plot: (a) the bench's
    # walk on its largest tree, (b) the CLI's entry points on that tree's
    # file, (c) the forest of its trees, alone and over ranks, (d) the card
    # against the CPU on a small Y-shaped tree
    torch.cuda.empty_cache()
    ladder = [walk_tree(sampling, pts, res.growth.labels, t.tree_id, 300_000)
              for t in res.trees]
    big = max(range(len(res.trees)), key=lambda i: res.trees[i].n_points)
    tree, voxel = ladder[big]
    log("qsm_walk", f"the trees laddered at voxels {[round(v, 4) for _, v in ladder]} m to "
        f"{[len(t) for t, _ in ladder]} points; the largest, tree {res.trees[big].tree_id} "
        f"({res.trees[big].n_points} points), walks")
    zero_launches(bm, mt)
    walk = qsm_walk_path(tq, Config(), tree)
    walk_counts = launch_counts(bm, mt)
    zero_launches(bm, mt)
    qcli = qsm_cli_path(cli, artifacts, readers, mt, tree)
    cli_counts = launch_counts(bm, mt)
    zero_launches(bm, mt)
    forest = qsm_forest_path(tq, launch, [t for t, _ in ladder])
    forest_counts = launch_counts(bm, mt)
    qcc = qsm_card_cpu(tq, args.seed + 2)
    print(json.dumps({"qsm": {"walk": walk, "cli": {k: {kk: vv for kk, vv in v.items()
                                                       if kk != "printed"}
                                                   for k, v in qcli.items()},
                              "forest": forest, "card_cpu": qcc}}), flush=True)
    paths = {"main (phase 5)": main_counts, "canopy (13a)": cp["counts"],
             "single-tree skeletonize (13b)": single["skeletonize"]["launches"],
             "single-tree canopy_metrics (13b)": single["canopy_metrics"]["launches"],
             "raycast grid (14)": rgp["path_launches"],
             "wavefront (15a-b)": wfp["counts"],
             "sharded raycast, 4 ranks (15c)": shr["counts"],
             "sphere walk (16a)": walk_counts, "CLI entry points (16b)": cli_counts,
             "sphere forest (16c)": forest_counts}

    def band_entry(kname, source, replaces, n_launches):
        fine, coarse = checks[(kname, "fine")], checks[(kname, "coarse")]
        return dict(
            name=kname, route="cuda", source=source, replaces=replaces, launches=n_launches,
            max_abs_err=max(fine["max_abs_err"], coarse["max_abs_err"]),
            ms=fine["ms"], plain_ms=fine["plain_ms"], bound_ms=fine["bound_ms"],
            bound_by=fine["bound_by"],
            library_ms=None if kname == "band_matvec_t" else fine["bmm_ms"],
            bmm_ms=fine["bmm_ms"], check="pass", shape=fine["shape"],
            coarse={k: coarse[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bmm_ms",
                                           "max_abs_err")})

    cs = mts["cast_scene"]
    mt_keys = ("rays", "triangles", "ms", "graph_ms", "plain_ms", "bound_ms", "ops",
               "max_abs_err", "grays_s", "shares", "plan")
    kernels = [
        band_entry("band_matvec", "pyqsm_tpu_torch/csrc/band_matvec.cu",
                   "pyqsm_tpu/ops/pallas_kernels.py:183", launches),
        band_entry("band_matvec_t", "pyqsm_tpu_torch/csrc/band_matvec_t.cu",
                   "pyqsm_tpu/ops/pallas_kernels.py:227", lt["launches"]),
        dict(name="mt_raycast", route="cuda", source="pyqsm_tpu_torch/csrc/mt_raycast.cu",
             replaces="pyqsm_tpu/ops/pallas_kernels.py:110", launches=ray["launches"],
             max_abs_err=max(c["max_abs_err"] for c in mts.values()), ms=cs["ms"],
             plain_ms=cs["plain_ms"], bound_ms=cs["bound_ms"], bound_by=cs["bound_by"],
             library_ms=None, check="pass", shape=[cs["rays"], cs["triangles"]],
             graph_ms=cs["graph_ms"], ops=cs["ops"],
             shares=cs["shares"], plan=cs["plan"],
             sun={k: mts["sun"][k] for k in mt_keys},
             occupancy={k: mts["occupancy"][k] for k in mt_keys},
             edge_cases=len(edges),
             raycast_grid={k: rgp[k] for k in ("n_raw", "n_tri", "image_kept", "image_raw",
                                               "cell", "grid3d", "residual_launches",
                                               "card_cpu_t_rel")},
             wavefront={k: wfp[k] for k in ("a", "b", "card_cpu_t_rel")},
             sharded=dict(backend=shr["backend"], ranks=SHARDED_RANKS,
                          launches_per_rank={name: [r["casts"][name]["launches"]
                                                    for r in shr["ranks"]]
                                             for name in shr["ranks"][0]["casts"]},
                          plain_checks_per_rank=[r["mt_plain"] for r in shr["ranks"]])),
        dict(name="band_matvec_bf16", route="cuda", source="pyqsm_tpu_torch/csrc/band_matvec_bf16.cu",
             replaces="pyqsm_tpu/ops/pallas_kernels.py:183", launches=claim["launches"],
             max_abs_err=max(bf["claim"]["max_abs_err"], bf["c128"]["max_abs_err"]),
             ms=bf["claim"]["ms"], plain_ms=bf["claim"]["plain_ms"],
             bound_ms=bf["claim"]["bound_ms"], bound_by=bf["claim"]["bound_by"],
             library_ms=bf["claim"]["bmm_ms"], check="pass", shape=bf["claim"]["shape"],
             c=bf["claim"]["c"], band_bytes=band["band_bytes"], widths_checked=widths,
             isolation_s={"band": claim[("band", 2)]["s"],
                          claim[("push", 2)]["res"].claim: claim[("push", 2)]["s"]},
             c128={k: bf["c128"][k] for k in ("ms", "plain_ms", "bmm_ms", "bound_ms", "bound_by",
                                              "max_abs_err")}),
        dict(name="band_matvec_bf16_halo", route="cuda",
             source="pyqsm_tpu_torch/csrc/band_matvec_bf16.cu",
             replaces="pyqsm_tpu/ops/pallas_kernels.py:183",
             launches=sum(r["plot"]["halo_launches"] for r in shd["ranks"]),
             launches_per_rank=[r["plot"]["halo_launches"] for r in shd["ranks"]],
             max_abs_err=max(halo["rank"]["max_abs_err"], halo["c128"]["max_abs_err"]),
             ms=halo["rank"]["ms"], plain_ms=halo["rank"]["plain_ms"],
             bound_ms=halo["rank"]["bound_ms"], bound_by=halo["rank"]["bound_by"],
             library_ms=halo["rank"]["bmm_ms"], check="pass", shape=halo["rank"]["shape"],
             c=halo["rank"]["c"], backend=shd["backend"], ranks=SHARDED_RANKS,
             widths_checked=halo_widths,
             isolation_s={"sharded band": [r[("band", 2)]["s"] for r in shd["ranks"]],
                          "sharded default": [r[("default", 2)]["s"] for r in shd["ranks"]]},
             c128={k: halo["c128"][k] for k in ("ms", "plain_ms", "bmm_ms", "bound_ms",
                                                "bound_by", "max_abs_err")}),
    ]
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
    signal.alarm(0)
    found = stop_children()
    log("exit", f"processes this script started that still ran, now stopped: "
        f"{[f'{pid}: {line[:120]}' for pid, line in found.items()]}; left: {len(descendants())}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        stop_children()
