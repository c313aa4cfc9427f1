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
   within 1e-4;
17. the batch driver on phase 5's plot written as two overlapping text
   scans (``plot_1.xyz``: x < 12 m, ``plot_2.xyz``: x > 4 m; the x = 8 m
   column of trees is in both; each row's generator part, trunk = wood 0,
   canopy = leaf 1, carried beside it): (a) the native ``read_xyz_stream``
   (the port's own ``csrc/pointio.cpp``, built with g++) on each scan, its
   rows equal to numpy ``read_xyz`` bit for bit, MB/s of both, and
   ``StreamingVoxelizer`` at 0.03 m, whose centroids equal the numpy
   path's as a set on 30 000 rows; (b) ``loop_over_files`` (the seed is
   the number after ``plot_``; loader ``read_xyz_stream``) over a ``StagedPipeline``
   of ``qsm`` (``process_plot``), ``segment`` (on the scan's largest tree
   laddered as 16a: ``compute_features`` k = 25, ``classify_wood_leaf``
   trained on a seeded 2 % of its rows, the three graph masks) and
   ``recover`` (onto the tree's full rows: ``recover_by_trace``,
   ``recover_details``, ``transfer_attributes``, ``expand_to_original``),
   with the counters set to 0 just before; seconds, peak memory and
   ``band_matvec`` launches a stage; no seed's error, every checkpoint
   written, every value finite, val accuracy ≥ 0.9; (c) seed 1 again from
   its ``qsm`` checkpoint (``start="segment"``), equal to the
   uninterrupted run bit for bit; (d) ``merge_labeled_scans`` of the two
   scans' labels: each tree both scans hold ends with one label, host
   reads (``models/joining.SYNCS``); ``voxel_overlap_mask`` of scan 2
   against scan 1 holds every row both scans hold; (e) ``viz_main`` on
   16a's tree with ``--labels`` from ``tree_isolation_main``'s artifact
   and a 0.3 m mesh: the page embeds the points it printed and the mesh's
   triangles; (f) on phase 4's plot the card against the CPU: features
   (gate equal, floats within the parity test's tolerance), the classifier
   trained on the same features (loss within 1e-4, predictions equal but
   on near-ties, counted), the graph masks, ``label_adjacency`` and
   ``recover_details`` equal;
18. the last slice's modules on phase 5's plot, each drive with the
   counters set to 0 just before and read just after: (a) the plot
   voxel-downsampled at 0.05 m, ``build_grid`` at 0.1 m (occupancy, cells)
   and ``grid_self_radius_knn(sort=True, k=16)``, first and steady — every
   row ascending, every id within the radius in float64 (up to the
   expanded form's rounding band), 4096 sampled rows equal to ``knn``'s
   outside ties within that band — then 100 000 raw rows through ``grid_radius_knn``
   and ``grid_radius_any_k`` (any-k ids inside the radius ball; on rows
   with fewer than k neighbours the same set), and the three queries on
   phase 4's plot card = CPU bit for bit; (b) ``clean_cloud`` on the
   largest tree's raw rows, rows kept, card = CPU on phase 4's plot; (c)
   on phase 7's canopy ``canopy_surface_mesh(max_edge=0.5)`` and its nadir
   ``sun_exposure``, ``alpha_complex_mesh(1.0)`` of the canopy laddered to
   ≤ 50 000 points, ``surface_clusters``, ``fill_holes`` and
   ``map_density(0.2, 10th percentile)`` against the canopy; card = CPU on
   a ≤ 5000-point ladder (counts, densities, colours equal); (d)
   ``build_octree`` (depth 6, stop 250) on the plot, ``get_center`` and
   ``get_radius`` on each tree card = CPU within 1e-6 of max(|CPU|, 1 m),
   ``generate_grid`` of the footprint; (e) ``multi_tree_pipeline_step``
   (k = 8, 64 hypotheses) on the 8 trees laddered to ≤ 16 384 rows and
   padded to it, over a (2, 2) mesh of 4 ranks (NCCL with a card each on
   four cards, gloo on ``cuda:0`` otherwise), first and warm call, peak
   memory a rank: fits finite and positive and the same on a ``points``
   row, each live row's label at most its id; against one rank's (1, 1)
   mesh the kNN distances slot for slot and the mean neighbour distances
   bit for bit, the labels on every row whose neighbour ids are equal
   (the ring keeps the earlier hop's id on an exact d² tie, as the JAX
   package's does; the tie rows and the contraction's difference are
   printed); the JAX test's two 512-row branches on the card's ranks
   against 4 gloo ranks on the CPU: labels and fits equal, contraction
   within 1e-4 m;
19. the bench's two configurations on its 10 M-point plot
   (``synthetic_plot(10_000_000, 8, seed)``, bench.py:39-54): (a)
   ``process_plot`` at phase 5's settings, a cold and a steady call, the
   counters set to 0 just before the cold one and read just after (stage
   seconds, peak memory, cycles, ``band_matvec`` launches): 8 of 8 trees
   with finite cylinders, the steady call equal to the cold one bit for
   bit; (b) ``build_trees`` at ``IsolationConfig()``, the reference's
   defaults (bench.py:533-565), cold then steady (seconds, trees counted
   by ``label_segments``, claim, cycles, peak memory; the two calls equal),
   then on phase 4's plot and on a 160 000-point plot in the bench's layout
   on the card and on the CPU: labels, order and cycles equal.

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
VOXEL_CHECK_ROWS = 30_000  # rows of phase 17a's numpy voxelizer check
SHARDED_RANKS = 4  # ranks of the sharded path (phase 11)
DDA_RAY_TILE = 1 << 20  # rays a tile of phase 14's 10⁶-ray DDA cast: the whole bundle
BENCH_POINTS = 10_000_000  # the bench's headline plot (bench.py:39-54, 283-320)
DEFAULTS_CHECK_POINTS = 160_000  # phase 19b's card = CPU plot in the bench's layout


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


def same_growth(a, b) -> bool:
    """Labels, claim cycles and cycle counts of two ``build_trees`` results
    (on any devices) equal bit for bit."""
    import torch

    return (torch.equal(a.labels.cpu(), b.labels.cpu()) and torch.equal(a.order.cpu(), b.order.cpu())
            and a.cycles_run == b.cycles_run)


def same_plot(a, b) -> bool:
    """Labels and every cylinder field of two ``process_plot`` results on
    one device equal bit for bit."""
    import torch

    return torch.equal(a.growth.labels, b.growth.labels) and len(a.trees) == len(b.trees) and all(
        torch.equal(getattr(x.cylinders, f), getattr(y.cylinders, f))
        for x, y in zip(a.trees, b.trees) for f in y.cylinders._fields)


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
        same = same_growth(rb, rp)
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


def write_scans(pts_np, per: int, n_trunk: int, d) -> dict:
    """Phase 17's two overlapping text scans of phase 5's plot:
    ``plot_1.xyz`` (rows with x < 12 m) and ``plot_2.xyz`` (x > 4 m), each
    row's generator part carried beside it (trunk ring 0 = wood, canopy 1 =
    leaf) with its tree of the generator and whether the other scan holds
    it too."""
    import numpy as np

    from pyqsm_tpu_torch.io import readers

    rows = np.arange(len(pts_np))
    part = ((rows % per) >= n_trunk).astype(np.int32)
    gen_tree = (rows // per).astype(np.int32)
    x = pts_np[:, 0]
    scans = {}
    for seed, keep in (("1", x < 12.0), ("2", x > 4.0)):
        path = d / f"plot_{seed}.xyz"
        readers.write_xyz(path, pts_np[keep])
        scans[seed] = dict(path=path, part=part[keep], tree=gen_tree[keep],
                           both=((x > 4.0) & (x < 12.0))[keep])
    return scans


def read_scan(path):
    """The driver's loader: the native streaming reader's batches joined."""
    import numpy as np

    from pyqsm_tpu_torch.io.native import read_xyz_stream

    return np.concatenate(list(read_xyz_stream(path)))


def ingestion_path(native, readers, scans: dict) -> dict:
    """Phase 17a: ``read_xyz_stream`` on each scan against the numpy
    ``read_xyz`` (rows bit for bit), MB/s of both; ``StreamingVoxelizer``
    at 0.03 m against the numpy path's centroids (as a set, on scan 1's
    first ``VOXEL_CHECK_ROWS`` rows)."""
    import numpy as np

    out = {}
    if not native.native_available():
        fail("the native ingestion library did not build")
    for seed, sc in scans.items():
        mb = sc["path"].stat().st_size / 1e6
        t0 = time.perf_counter()
        rows = read_scan(sc["path"])
        s_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = readers.read_xyz(sc["path"]).points
        s_numpy = time.perf_counter() - t0
        equal = rows.shape == ref.shape and bool(np.array_equal(rows, ref))
        t0 = time.perf_counter()
        cent = list(native.read_xyz_stream(sc["path"], voxel=0.03))[0]
        s_vox = time.perf_counter() - t0
        out[seed] = dict(rows=len(rows), mb=mb, native_s=s_native, numpy_s=s_numpy,
                         native_mb_s=mb / s_native, numpy_mb_s=mb / s_numpy, equal=equal,
                         voxels=len(cent), voxelize_s=s_vox, voxelize_mb_s=mb / s_vox)
        if seed == "1":
            # the numpy path (the plain version) loops over voxels in Python:
            # both paths on the scan's first VOXEL_CHECK_ROWS rows
            part = rows[:VOXEL_CHECK_ROWS]
            fast, slow = native.StreamingVoxelizer(0.03), native.StreamingVoxelizer(0.03)
            slow._lib = None
            fast.add(part)
            t0 = time.perf_counter()
            slow.add(part)
            out[seed]["voxelize_numpy_s"] = time.perf_counter() - t0
            ref_c, got_c = slow.centroids(), fast.centroids()

            def as_set(a):
                return a[np.lexsort(a.T[::-1])]

            out[seed]["centroids_equal"] = ref_c.shape == got_c.shape and bool(
                np.array_equal(as_set(ref_c), as_set(got_c)))
        log("ingest", f"plot_{seed}.xyz {mb:.1f} MB, {len(rows)} rows: read_xyz_stream "
            f"{s_native:.3f}s ({mb / s_native:.1f} MB/s) vs numpy read_xyz {s_numpy:.3f}s "
            f"({mb / s_numpy:.1f} MB/s), rows equal {equal}; StreamingVoxelizer 0.03 m "
            f"{len(cent)} voxels in {s_vox:.3f}s ({mb / s_vox:.1f} MB/s)"
            + (f"; on its first {min(len(rows), VOXEL_CHECK_ROWS)} rows the numpy path "
               f"{out[seed]['voxelize_numpy_s']:.3f}s, centroids equal "
               f"{out[seed]['centroids_equal']}" if seed == "1" else ""))
        if not equal:
            fail(f"plot_{seed}.xyz: the native rows differ from numpy read_xyz")
    if not out["1"]["centroids_equal"]:
        fail("StreamingVoxelizer: the native centroids differ from the numpy path's")
    return out


def ladder_rows(sampling, pts, rows, walk_points: int):
    """A tree's rows laddered as ``walk_tree`` (voxel 0.03 m grown 1.3×
    until at most ``walk_points`` live rows): the full rows, the compacted
    representatives, each full row's representative in that compaction and
    each representative's full row."""
    import torch

    full = pts[rows]
    ones = torch.ones(full.shape[0], dtype=torch.bool, device=full.device)
    voxel = 0.03
    p2, m2, trace = sampling.voxel_downsample(full, voxel, ones)
    while int(m2.sum()) > walk_points and voxel < 0.5:
        voxel *= 1.3
        p2, m2, trace = sampling.voxel_downsample(full, voxel, ones)
    pos = torch.cumsum(m2.to(torch.int64), 0) - 1
    rep_rows = torch.nonzero(m2).flatten()
    return full, p2[m2], pos[trace.long()], rep_rows, voxel


def driver_stages(mods, plot_kw, iso_cfg, cfg, data, gen, stats, seed: str):
    """The three stages of phase 17b over one scan (``data``: its rows,
    ``gen``: their generator parts and trees): ``qsm`` (``process_plot``),
    ``segment`` (features, the trained wood/leaf classifier and the graph
    masks on the largest tree, laddered) and ``recover`` (back onto that
    tree's full rows). Each stage adds to the state and records its
    seconds, peak memory and ``band_matvec`` launches in ``stats``."""
    import numpy as np
    import torch

    bm, pp, sampling, feat, seg, gf, rec = (mods[k] for k in (
        "bm", "pp", "sampling", "features", "segmentation", "graph_features",
        "reconstruction"))
    dev = torch.device(mods["device"])
    pts = torch.as_tensor(data.astype(np.float32), device=dev)

    def timed(name, fn):
        def run(state):
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            before = bm.LAUNCHES
            t0 = time.perf_counter()
            out = fn(dict(state))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            stats.setdefault(seed, {})[name] = dict(
                s=time.perf_counter() - t0, band_matvec_launches=bm.LAUNCHES - before,
                peak_gib=(torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda"
                          else 0.0))
            return out
        return run

    def qsm(state):
        mask = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
        res = pp.process_plot(pts, mask, cfg, iso_cfg, **plot_kw, device=dev)
        c = [t.cylinders for t in res.trees]
        state.update(
            labels=res.growth.labels, order=res.growth.order,
            tree_ids=torch.tensor([t.tree_id for t in res.trees], device=dev),
            tree_points=torch.tensor([t.n_points for t in res.trees], device=dev),
            cyl_tree=torch.cat([torch.full_like(x.radius, t.tree_id, dtype=torch.int32)
                                for x, t in zip(c, res.trees)]),
            cyl_center=torch.cat([x.center for x in c]), cyl_axis=torch.cat([x.axis for x in c]),
            cyl_radius=torch.cat([x.radius for x in c]), cyl_height=torch.cat([x.height for x in c]),
            cyl_mask=torch.cat([x.mask for x in c]))
        return state

    def largest(state):
        ids = torch.as_tensor(state["tree_ids"], device=dev)
        npts = torch.as_tensor(state["tree_points"], device=dev)
        tree_id = int(ids[int(torch.argmax(npts))])
        labels = torch.as_tensor(state["labels"], device=dev)
        rows = torch.nonzero(labels == tree_id).flatten()
        return tree_id, rows

    def segment(state):
        tree_id, rows = largest(state)
        full, coarse, _, rep_rows, voxel = ladder_rows(sampling, pts, rows, 300_000)
        n = coarse.shape[0]
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        part = torch.as_tensor(gen["part"], device=dev)[rows][rep_rows].to(torch.int32)
        order = torch.as_tensor(state["order"], device=dev)[rows][rep_rows]
        feats = feat.compute_features(coarse, ones, k=25)
        rng = np.random.default_rng(17)
        labeled = np.sort(rng.choice(n, max(n // 50, 2), replace=False))
        labeled_t = torch.as_tensor(labeled, device=dev)
        preds, clf, m = seg.classify_wood_leaf(coarse, ones, labeled_t, part[labeled_t], k=25,
                                               device=dev)
        leaf_deg, degree = gf.leaf_mask_by_degree(coarse, ones)
        sparse = gf.exclude_dense_areas(coarse, ones)
        leaf_order = gf.leaf_mask_by_order_diff(coarse, order, ones)
        state.update(
            tree_id=np.asarray(tree_id, np.int64), voxel=np.asarray(voxel, np.float64),
            coarse=coarse,
            planarity=feats["planarity"], linearity=feats["linearity"], preds=preds,
            part=part, degree=degree, leaf_deg=leaf_deg, sparse=sparse,
            leaf_order=leaf_order, loss=np.asarray(m["loss"], np.float64),
            train_acc=np.asarray(m["train_acc"], np.float64),
            val_acc=np.asarray(m["val_acc"], np.float64),
            pred_acc=np.asarray(float((preds == part).float().mean()), np.float64))
        return state

    def recover(state):
        tree_id, rows = largest(state)
        full, coarse, ctrace, rep_rows, _ = ladder_rows(sampling, pts, rows, 300_000)
        preds = torch.as_tensor(state["preds"], device=dev)
        nf = full.shape[0]
        fones = torch.ones(nf, dtype=torch.bool, device=dev)
        cones = torch.ones(coarse.shape[0], dtype=torch.bool, device=dev)
        leaf = preds == 1
        by_trace = rec.recover_by_trace(leaf, ctrace, fones)
        by_knn = rec.recover_details(coarse, leaf, full, fones)
        vals, matched = rec.transfer_attributes(coarse, preds, cones, full, fones)
        plan_full = feat.expand_to_original(coarse, torch.as_tensor(state["planarity"],
                                                                    device=dev),
                                            cones, full, fones)
        part_full = torch.as_tensor(gen["part"], device=dev)[rows]
        state.update(by_trace=by_trace, by_knn=by_knn, transferred=vals, matched=matched,
                     planarity_full=plan_full,
                     full_acc=np.asarray(float((vals == part_full).float().mean()), np.float64))
        return state

    pipe = mods["driver"].StagedPipeline(mods["workdir"], seed=seed)
    for name, fn in (("qsm", qsm), ("segment", segment), ("recover", recover)):
        pipe.add_stage(name, timed(name, fn))
    return pipe


def _np(v):
    import numpy as np
    import torch

    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def state_finite(state: dict) -> bool:
    import numpy as np

    return all(bool(np.isfinite(a).all()) for a in (_np(v) for v in state.values())
               if a.dtype.kind == "f")


def batch_driver_path(mods, scans: dict, plot_kw, iso_cfg, cfg) -> dict:
    """Phase 17b-c: ``loop_over_files`` over the scans' folder runs the
    staged pipeline on each seed; then seed 1 again from its ``qsm``
    checkpoint (``start="segment"``), whose final state must equal the
    uninterrupted run's bit for bit."""
    import numpy as np

    driver = mods["driver"]
    stats: dict = {}

    def run_seed(seed, data):
        return driver_stages(mods, plot_kw, iso_cfg, cfg, data["plot"], scans[seed], stats,
                             seed).run()

    folder = scans["1"]["path"].parent
    t0 = time.perf_counter()
    results, errors = driver.loop_over_files(run_seed, [folder], seed_pattern=r"plot_(\d+)",
                                             loaders={"plot": read_scan})
    total_s = time.perf_counter() - t0
    for seed in sorted(results):
        st, r = stats[seed], results[seed]
        log("driver", f"plot_{seed}: " + "; ".join(
            f"{k} {v['s']:.3f}s peak {v['peak_gib']:.3f} GiB band_matvec launches "
            f"{v['band_matvec_launches']}" for k, v in st.items())
            + f"; trees {len(_np(r['tree_ids']))}, the largest (tree {int(r['tree_id'])}) "
            f"laddered at {float(r['voxel']):.4f} m to {len(_np(r['coarse']))} rows; "
            f"classifier loss {float(r['loss']):.4f} train_acc {float(r['train_acc']):.4f} "
            f"val_acc {float(r['val_acc']):.4f}, all rows {float(r['pred_acc']):.4f}; "
            f"leaf by degree {int(_np(r['leaf_deg']).sum())}, kept outside dense areas "
            f"{int(_np(r['sparse']).sum())}, leaf by order {int(_np(r['leaf_order']).sum())}; "
            f"recovered leaf rows by trace {int(_np(r['by_trace']).sum())}, by kNN "
            f"{int(_np(r['by_knn']).sum())}, transferred {int(_np(r['matched']).sum())} of "
            f"{len(_np(r['matched']))} (full-row accuracy {float(r['full_acc']):.4f})")
    log("driver", f"loop_over_files {total_s:.3f}s, errors {sorted(errors)}")
    if errors:
        fail(f"loop_over_files: seeds failed: {errors}")
    if sorted(results) != ["1", "2"]:
        fail(f"loop_over_files ran seeds {sorted(results)}, expected 1 and 2")
    missing = [f"{s}_{k}.npz" for s in results for k in ("qsm", "segment", "recover")
               if not (mods["workdir"] / f"{s}_{k}.npz").exists()]
    if missing:
        fail(f"checkpoints not written: {missing}")
    for seed, r in results.items():
        if not state_finite(r):
            fail(f"plot_{seed}: a non-finite value in the pipeline's state")
        if float(r["val_acc"]) < 0.9:
            fail(f"plot_{seed}: wood/leaf val accuracy {float(r['val_acc']):.4f} < 0.9")
    # 17c: resume seed 1 at 'segment' from the 'qsm' checkpoint
    data = read_scan(scans["1"]["path"])
    rstats: dict = {}
    t0 = time.perf_counter()
    resumed = driver_stages(mods, plot_kw, iso_cfg, cfg, data, scans["1"], rstats, "1").run(
        start="segment")
    resume_s = time.perf_counter() - t0
    ref = results["1"]
    same_keys = set(resumed) == set(ref)
    diff = [k for k in ref if k in resumed
            and not (_np(ref[k]).dtype == _np(resumed[k]).dtype
                     and np.array_equal(_np(ref[k]), _np(resumed[k])))]
    log("resume", f"plot_1 from its qsm checkpoint: {resume_s:.3f}s ("
        + "; ".join(f"{k} {v['s']:.3f}s" for k, v in rstats["1"].items())
        + f"); keys equal {same_keys}, arrays differing bit-wise {diff}")
    if not same_keys or diff:
        fail(f"the resumed pipeline differs from the uninterrupted run: {diff}")
    return dict(stats=stats, total_s=total_s, resume_s=resume_s, resume_stats=rstats["1"],
                results=results)


def joining_path(joining, rec, results: dict, scans: dict, device) -> dict:
    """Phase 17d: ``merge_labeled_scans`` of the two scans' isolation labels
    (threshold 0.35): every tree of the x = 8 m column, which both scans
    hold, ends with one label; ``voxel_overlap_mask`` of scan 2 against
    scan 1 holds every row scan 1 holds too."""
    import numpy as np
    import torch

    pts = {s: torch.as_tensor(read_scan(scans[s]["path"]).astype(np.float32), device=device)
           for s in ("1", "2")}
    labels = {s: torch.as_tensor(_np(results[s]["labels"]), device=device) for s in ("1", "2")}
    masks = {s: torch.ones(pts[s].shape[0], dtype=torch.bool, device=device) for s in pts}
    joining.SYNCS = 0
    t0 = time.perf_counter()
    mp, ml, mm = joining.merge_labeled_scans([pts["1"], pts["2"]], [labels["1"], labels["2"]],
                                             [masks["1"], masks["2"]], threshold=0.35)
    if device == "cuda":
        torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    merge_reads = joining.SYNCS
    ml = ml.cpu().numpy()
    before = sorted(set(_np(labels["1"])[_np(labels["1"]) >= 0].tolist())) + sorted(
        set(_np(labels["2"])[_np(labels["2"]) >= 0].tolist()))
    n1 = pts["1"].shape[0]
    tree = np.concatenate([scans["1"]["tree"], scans["2"]["tree"]])
    both = np.concatenate([scans["1"]["both"], scans["2"]["both"]])
    column = [t for t in range(N_TREES) if 4.0 < (t % 3) * 8.0 < 12.0]
    per_tree = {t: sorted(set(ml[(tree == t) & both & (ml >= 0)].tolist())) for t in column}
    ok_join = all(len(v) == 1 for v in per_tree.values()) and all(
        ((tree[:n1] == t) & both[:n1] & (ml[:n1] >= 0)).any()
        and ((tree[n1:] == t) & both[n1:] & (ml[n1:] >= 0)).any() for t in column)
    t0 = time.perf_counter()
    over = rec.voxel_overlap_mask(pts["2"], masks["2"], pts["1"], masks["1"])
    over = over.cpu().numpy()
    overlap_s = time.perf_counter() - t0
    need = scans["2"]["both"]
    complete = bool(over[need].all())
    out = dict(merge_s=merge_s, host_reads=merge_reads, labels_before=len(before),
               labels_after=len(set(ml[ml >= 0].tolist())), column_labels=per_tree,
               overlap_s=overlap_s, overlap_rows=int(over.sum()), overlap_needed=int(need.sum()),
               overlap_complete=complete)
    log("join", f"merge_labeled_scans of {n1} + {pts['2'].shape[0]} rows: {merge_s:.3f}s, "
        f"{len(before)} labels before, {out['labels_after']} after, host reads {merge_reads}; "
        f"labels of the x = 8 m column's trees (both scans) {per_tree}; voxel_overlap_mask "
        f"{overlap_s:.3f}s, {out['overlap_rows']} rows of scan 2 in scan 1's voxels, all "
        f"{out['overlap_needed']} shared rows among them: {complete}")
    if not ok_join:
        fail(f"a tree both scans hold does not end with one label: {per_tree}")
    if not complete:
        fail("voxel_overlap_mask misses rows of scan 2 that scan 1 holds")
    return out


def viz_path(cli, readers, vm, tree, device) -> dict:
    """Phase 17e: ``viz_main`` on the largest tree's ``.npz`` with
    ``--labels`` from ``tree_isolation_main``'s artifact and a 0.3 m mesh:
    the page embeds the point count it printed and the mesh's triangles."""
    import io
    import re
    import tempfile
    from pathlib import Path

    import torch

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "tree.npz"
        readers.write_npz(path, tree)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc_iso = cli.tree_isolation_main([str(path), "-o", d, "--base-min-points", "200",
                                              "--low-pctile", "4"], device=device)
            t0 = time.perf_counter()
            rc = cli.viz_main([str(path), "-o", d, "--labels", str(Path(d) / "tree_trees.npz"),
                               "--mesh-voxel", "0.3"], device=device)
            s = time.perf_counter() - t0
        printed = buf.getvalue().strip().splitlines()[-1]
        html_path = Path(d) / "tree_viewer.html"
        html = html_path.read_text() if html_path.exists() else ""
        size_mb = len(html) / 1e6
    m = re.search(r"const LAYERS=(\[.*?\]), CENTER=", html, re.S)
    layers = json.loads(m.group(1)) if m else []
    n_printed = int(re.search(r"\(([\d,]+) points\)", printed).group(1).replace(",", ""))
    t = torch.as_tensor(tree, device=device)
    n_tri = vm.poisson_like_mesh(t, torch.ones(t.shape[0], dtype=torch.bool, device=device),
                                 voxel=0.3).n_triangles()
    kinds = [x["kind"] for x in layers]
    out = dict(rc=rc, rc_isolation=rc_iso, s=s, html_mb=size_mb, points=n_printed,
               layers=kinds, mesh_triangles=n_tri)
    log("viz", f"viz_main rc {rc} in {s:.3f}s: {printed}; page {size_mb:.2f} MB, layers {kinds}, "
        f"{layers[0]['n'] if layers else 0} points and "
        f"{layers[1]['n'] // 3 if len(layers) > 1 else 0} triangles embedded (mesh {n_tri})")
    if rc != 0 or rc_iso != 0 or kinds != ["points", "mesh"] or layers[0]["n"] != n_printed \
            or layers[1]["n"] != 3 * n_tri or n_printed != len(tree):
        fail("viz_main's page does not embed the points and triangles it made")
    return out


def segment_card_cpu(mods, small, devices=("cuda", "cpu")) -> dict:
    """Phase 17f: on phase 4's two-tree plot, the card against the CPU:
    features (gate equal, floats within the parity test's tolerance), the
    classifier trained from the same initial weights and split on the same
    features (loss within 1e-4 relative, logits within 0.05, predictions
    equal but on near-ties, counted), the graph masks, ``label_adjacency``
    and ``recover_details`` equal."""
    import numpy as np
    import torch

    feat, seg, gf, joining, rec = (mods[k] for k in ("features", "segmentation",
                                                    "graph_features", "joining",
                                                    "reconstruction"))
    tree = (np.arange(len(small)) >= len(small) // 2).astype(np.int32)
    labels = 2 * tree + (small[:, 2] > 2.5)  # each trunk's lower and upper half
    rng = np.random.default_rng(4)
    order = (small[:, 2] * 4).astype(np.int32) + rng.integers(0, 4, len(small)).astype(np.int32)
    out = {}
    res = {}
    card, cpu = devices
    for dev in devices:
        p = torch.as_tensor(small, device=dev)
        ones = torch.ones(len(small), dtype=torch.bool, device=dev)
        f = feat.compute_features(p, ones, k=25)
        res[dev] = dict(
            feats={k: v.cpu().numpy() for k, v in f.items()},
            deg=gf.leaf_mask_by_degree(p, ones, radius=0.1)[0].cpu().numpy(),
            sparse=gf.exclude_dense_areas(p, ones, radius=0.1).cpu().numpy(),
            order=gf.leaf_mask_by_order_diff(p, torch.as_tensor(order, device=dev), ones,
                                             radius=0.1).cpu().numpy(),
            adj=joining.label_adjacency(p, torch.as_tensor(labels, device=dev), ones,
                                        subsample_every=3),
            details=rec.recover_details(p[::3], torch.as_tensor(small[::3, 2] > 2.0,
                                                                device=dev),
                                        p, ones, radius=0.05).cpu().numpy())
    a, b = res[card]["feats"], res[cpu]["feats"]
    gate = bool(np.array_equal(a["PCA1"] > 0, b["PCA1"] > 0))
    worst, close_min = 0.0, 1.0
    for k in b:
        scale = max(float(np.abs(b[k]).max()), 1e-12)
        worst = max(worst, float(np.abs(a[k] - b[k]).max()) / scale)
        live = b["PCA1"] > 0
        close_min = min(close_min, float((np.abs(a[k] - b[k]) <= 2e-5 * np.abs(b[k]))[live].mean()))
    # the classifier from the same features, initial weights and split
    x = np.stack([b[k] for k in feat.FEATURE_NAMES], 1)
    lmask = np.zeros(len(small), bool)
    lmask[::10] = True
    preds, logits, metrics = {}, {}, {}
    for dev in devices:
        clf, m = seg.train_classifier(torch.as_tensor(x), torch.as_tensor(tree),
                                      torch.as_tensor(lmask), device=dev)
        xt = torch.as_tensor(x, device=dev)
        preds[dev] = seg.predict(clf, xt).cpu().numpy()
        with torch.no_grad():
            logits[dev] = clf.mlp((xt - clf.feat_mean) / clf.feat_std).cpu().numpy()
        metrics[dev] = m
    # 300 Adam steps part the two devices' weights (each gradient divided by
    # its own running RMS amplifies the float32 sums' rounding): a row is a
    # near-tie when its CPU margin is within twice the largest logit
    # difference between the devices
    dlogit = float(np.abs(logits[card] - logits[cpu]).max())
    top2 = np.sort(logits[cpu], axis=1)[:, -2:]
    tie = (top2[:, 1] - top2[:, 0]) <= 2 * dlogit
    differ = preds[card] != preds[cpu]
    masks_equal = {k: bool(np.array_equal(res[card][k], res[cpu][k]))
                   for k in ("deg", "sparse", "order", "details")}
    adj_equal = all(bool(torch.equal(getattr(res[card]["adj"], f).cpu(),
                                     getattr(res[cpu]["adj"], f).cpu()))
                    for f in ("min_dist", "adjacent", "labels"))
    out = dict(feature_gate_equal=gate, feature_max_err_of_scale=worst,
               feature_rows_within_2e5=close_min, near_ties=int(tie.sum()),
               predictions_differ=int(differ.sum()), differ_outside_ties=int((differ & ~tie).sum()),
               loss={d: metrics[d]["loss"] for d in metrics},
               logit_max_abs_diff=dlogit,
               masks_equal=masks_equal, adjacency_equal=adj_equal)
    log("seg_card_cpu", f"two-tree plot: features gate equal {gate}, max err {worst:.3e} of "
        f"scale, rows within 2e-5 ≥ {close_min:.4f}; classifier loss card/cpu "
        f"{metrics[card]['loss']:.6f}/{metrics[cpu]['loss']:.6f}, logits within "
        f"{out['logit_max_abs_diff']:.3e}, near-ties {int(tie.sum())}, predictions differing "
        f"{int(differ.sum())} ({int((differ & ~tie).sum())} outside near-ties); masks equal "
        f"{masks_equal}; label_adjacency equal {adj_equal}")
    if not gate or worst > 2e-3 or close_min < 0.93:
        fail("features: the card and the CPU differ beyond the parity test's tolerance")
    loss_rel = abs(metrics[card]["loss"] - metrics[cpu]["loss"]) / metrics[cpu]["loss"]
    if (differ & ~tie).any() or dlogit > 0.05 or loss_rel > 1e-4:
        fail("the classifier's predictions, logits or loss differ between the card and the CPU")
    if not all(masks_equal.values()) or not adj_equal:
        fail("graph masks, label_adjacency or recover_details differ between card and CPU")
    return out


def timed(fn):
    """(result, seconds, peak GiB) of one call that ends in a synchronise
    (the CPU reports no peak)."""
    import torch

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, (torch.cuda.max_memory_allocated() / 2 ** 30
                                           if cuda else 0.0)


def f64_dist(a, b, ids):
    """float64 distances of [Q, 3] rows to their [Q, k] candidate rows of
    ``b`` (inf where the id is -1), and the float32 rounding band of the
    expanded form ``q² + c² − 2·q·c`` there: 4·2⁻²⁴·(|q|² + |c|²) in d²."""
    import torch

    a64, b64 = a.double(), b.double()
    c = b64[ids.clamp(min=0).long()]
    d2 = ((a64[:, None, :] - c) ** 2).sum(-1)
    band = 4 * 2.0 ** -24 * ((a64 ** 2).sum(-1)[:, None] + (c ** 2).sum(-1))
    hit = ids >= 0
    return torch.where(hit, d2, float("inf")), torch.where(hit, band, 0.0)


def tie_explained(ids_a, ids_b, d2_of, r2, band) -> bool:
    """Two id lists of one row agree outside exact ties: the ids they do
    not share lie within the rounding band of the radius, or of the
    farthest distance both lists reach (where the k-th place is decided)."""
    sa, sb = set(ids_a), set(ids_b)
    if sa == sb:
        return True
    kth = max(d2_of[i] for i in sa | sb)
    return all(abs(d2_of[i] - r2) <= band or abs(d2_of[i] - kth) <= band for i in sa ^ sb)


def grid_index_path(tn, knn, sampling, pts, small) -> dict:
    """Phase 18a: the grid index at plot scale (phase 5's plot
    voxel-downsampled at 0.05 m, the sorted self query at 0.1 m, k = 16),
    100 000 raw rows queried against it, and the card against the CPU on
    phase 4's plot."""
    import numpy as np
    import torch

    r, k = 0.1, 16
    ones = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    vp, vm, _ = sampling.voxel_downsample(pts, r / 2, ones)
    q = vp[vm].contiguous()
    n = q.shape[0]
    index, build_s, _ = timed(lambda: tn.build_grid(q, r))
    sc = index.sorted_cell
    occ = int(tn.max_cell_occupancy(index))
    n_cells = int(((sc[1:] != sc[:-1]).sum() + 1))
    out = dict(points=n, cells=n_cells, occupancy=occ, build_s=build_s)
    for call in ("first", "steady"):
        (d, i), out[f"{call}_s"], out["peak_gib"] = timed(
            lambda: tn.grid_self_radius_knn(q, r, k))
    d2, band = f64_dist(q, q, i)
    fin = torch.isfinite(d)
    ascending = bool((torch.where(fin, d, 1e9).diff(dim=1) >= 0).all())
    within = bool(((d2 <= r * r + band) | ~fin).all())
    # a row's own id is among its k (its d² is 0 up to the rounding band)
    self_in = bool((i == torch.arange(n, device=q.device)[:, None]).any(1).all())
    # 4096 sampled rows against brute kNN within the radius
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(18))[:4096].to(q.device)
    bd, bi = knn(q[rows], q, k)
    bi = torch.where(bd <= r, bi, -1)
    same_rows = int((bi == i[rows]).all(1).sum())
    allc = torch.cat([i[rows], bi], 1)
    d2c, bandc = f64_dist(q[rows], q, allc)
    bad = 0
    for row in range(len(rows)):
        ga = [int(x) for x in i[rows[row]].tolist() if x >= 0]
        gb = [int(x) for x in bi[row].tolist() if x >= 0]
        d2_of = {int(x): float(v) for x, v in zip(allc[row].tolist(), d2c[row].tolist()) if x >= 0}
        if not tie_explained(ga, gb, d2_of, r * r, float(bandc[row].max())):
            bad += 1
    out.update(ascending=ascending, within=within, self_in_row=self_in,
               knn_rows_equal=same_rows, knn_rows_unexplained=bad)
    log("grid", f"plot voxelized at {r / 2} m: {n} points, {n_cells} cells at {r} m, largest "
        f"occupancy {occ}; build_grid {build_s:.3f}s; grid_self_radius_knn(sort=True, k={k}) "
        f"first {out['first_s']:.3f}s, steady {out['steady_s']:.3f}s, max_memory_allocated "
        f"{out['peak_gib']:.3f} GiB; rows ascending {ascending}, every id within the radius "
        f"in float64 (rounding band 4·2⁻²⁴·(|q|²+|c|²)) {within}, own id in every row {self_in}; "
        f"4096 sampled rows: ids equal to knn's within the radius in {same_rows}, the rest "
        f"differing only on ties within the rounding band but {bad}")
    if not (ascending and within and self_in) or bad:
        fail("the sorted grid self query disagrees with its checks")
    # 100 000 raw plot rows against the index
    qr = pts[torch.randperm(pts.shape[0], generator=torch.Generator().manual_seed(19))[
        :100_000].to(pts.device)].contiguous()
    cap = tn.recommend_cell_cap(index)
    (sd, si), out["radius_knn_s"], _ = timed(lambda: tn.grid_radius_knn(index, qr, r, k,
                                                                        cell_cap=cap))
    (ad, ai), out["any_k_s"], _ = timed(lambda: tn.grid_radius_any_k(index, qr, r, k,
                                                                     cell_cap=cap))
    ad2, aband = f64_dist(qr, q, ai)
    in_ball = bool(((ad2 <= r * r + aband) | (ai < 0)).all())
    unsat = (si < 0).any(1)
    d2s, bands = f64_dist(qr, q, torch.cat([si, ai], 1))
    sets_bad = 0
    for row in torch.nonzero(unsat).flatten()[:20_000].tolist():
        ga = [int(x) for x in si[row].tolist() if x >= 0]
        gb = [int(x) for x in ai[row].tolist() if x >= 0]
        ids = torch.cat([si[row], ai[row]]).tolist()
        d2_of = {int(x): float(v) for x, v in zip(ids, d2s[row].tolist()) if x >= 0}
        if not tie_explained(ga, gb, d2_of, r * r, float(bands[row].max())):
            sets_bad += 1
    hits = int((si >= 0).sum())
    out.update(cap=cap, any_k_in_ball=in_ball, unsaturated_rows=int(unsat.sum()),
               unsaturated_sets_bad=sets_bad, query_hits=hits)
    log("grid", f"100 000 raw rows against the index (cell_cap {cap}): grid_radius_knn "
        f"{out['radius_knn_s']:.3f}s ({hits} hits), grid_radius_any_k {out['any_k_s']:.3f}s; "
        f"every any-k id inside the radius ball {in_ball}; on the {int(unsat.sum())} rows with "
        f"fewer than {k} neighbours (first 20 000 checked) the any-k set equals the sorted "
        f"set but {sets_bad}")
    if not in_ball or sets_bad or hits == 0:
        fail("grid_radius_any_k disagrees with grid_radius_knn")
    # the card against the CPU on phase 4's plot: ids and distances bit for bit
    same = {}
    for dev in ("cuda", "cpu"):
        sp = torch.as_tensor(small, device=dev)
        sv, sm, _ = sampling.voxel_downsample(sp, r / 2, torch.ones(len(small), dtype=torch.bool,
                                                                    device=dev))
        sq = sv[sm].contiguous()
        idx = tn.build_grid(sq, r)
        same[dev] = [x.cpu() for x in (*tn.grid_self_radius_knn(sq, r, k),
                                       *tn.grid_radius_knn(idx, sp, r, k),
                                       *tn.grid_radius_any_k(idx, sp, r, k))]
    eq = [bool(np.array_equal(a.numpy().view(np.int32), b.numpy().view(np.int32)))
          for a, b in zip(same["cuda"], same["cpu"])]
    out["card_cpu"] = eq
    log("grid", f"phase 4's plot, card = CPU bit for bit (self d, ids; radius_knn d, ids; "
        f"any_k d, ids): {eq}")
    if not all(eq):
        fail("the grid queries differ between the card and the CPU")
    return out


def clean_cloud_path(outliers, pts, labels, tree_id: int, small) -> dict:
    """Phase 18b: ``clean_cloud`` (defaults) on the largest tree's raw rows,
    then the card against the CPU on phase 4's plot."""
    import torch

    rows = pts[labels == tree_id].contiguous()
    ones = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    (p, m, tr), s, peak = timed(lambda: outliers.clean_cloud(rows, ones))
    kept, reps = int(m.sum()), int((tr >= 0).sum())
    out = dict(rows=rows.shape[0], kept=kept, s=s, peak_gib=peak)
    cc = {dev: [x.cpu() for x in outliers.clean_cloud(torch.as_tensor(small, device=dev),
                                                      torch.ones(len(small), dtype=torch.bool,
                                                                 device=dev))]
          for dev in ("cuda", "cpu")}
    out["card_cpu"] = [bool(torch.equal(a, b)) for a, b in zip(cc["cuda"], cc["cpu"])]
    log("clean", f"clean_cloud on tree {tree_id}'s {rows.shape[0]} raw rows: {kept} rows kept "
        f"({reps} rows traced to a voxel) in {s:.3f}s, max_memory_allocated {peak:.3f} GiB; "
        f"phase 4's plot card = CPU (points, mask, trace): {out['card_cpu']} "
        f"({int(cc['cpu'][1].sum())} of {len(small)} kept)")
    if not 0 < kept < rows.shape[0] or not torch.isfinite(p[m]).all():
        fail("clean_cloud kept no rows, or every row, or non-finite points")
    if not all(out["card_cpu"]):
        fail("clean_cloud differs between the card and the CPU")
    return out


def ladder_to(sampling, pts, cap: int):
    """Live rows of ``pts`` voxel-laddered from 0.05 m, 1.3× a rung, to at
    most ``cap`` rows."""
    import torch

    ones = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    voxel = 0.05
    p2, m2, _ = sampling.voxel_downsample(pts, voxel, ones)
    while int(m2.sum()) > cap:
        voxel *= 1.3
        p2, m2, _ = sampling.voxel_downsample(pts, voxel, ones)
    return p2[m2].contiguous(), voxel


def mesh_counts(tm, mesh, cloud, device) -> dict:
    """The meshes' part of phase 18c on one device: alpha complex, clusters,
    holes, density; their triangle counts, densities and colours."""
    import torch

    labels, filt = tm.surface_clusters(mesh.to(device), min_triangles=20)
    filled = tm.fill_holes(filt)
    dens, cols, trimmed = tm.map_density(filled, torch.as_tensor(cloud).to(device), radius=0.2,
                                         density_threshold_pctile=10)
    return dict(clusters=int(labels.max()) + 1, kept=filt.n_triangles(),
                filled=filled.n_triangles(), trimmed=trimmed.n_triangles(),
                dens=dens.cpu(), cols=cols.cpu(), tris=trimmed.triangles.cpu())


def meshes_path(tm, tmr, sampling, pts) -> dict:
    """Phase 18c: the scipy meshes on phase 7's canopy (z > 6 m): the canopy
    surface and its nadir exposure, the alpha complex of the canopy
    laddered to ≤ 50 000 points, its clusters, holes and density; then the
    card against the CPU on a ladder of ≤ 5000 points."""
    import torch

    canopy = pts[pts[:, 2] > 6.0].contiguous()
    surf, surf_s, _ = timed(lambda: tm.canopy_surface_mesh(canopy, max_edge=0.5,
                                                              device="cuda"))
    sun, sun_s, sun_peak = timed(lambda: tmr.sun_exposure(surf, elevation_deg=90.0,
                                                                  device="cuda"))
    lad, voxel = ladder_to(sampling, canopy, 50_000)
    alpha, alpha_s, _ = timed(lambda: tm.alpha_complex_mesh(lad, 1.0, device="cuda"))
    parts, parts_s, peak = timed(lambda: mesh_counts(tm, alpha, canopy, "cuda"))
    out = dict(canopy=canopy.shape[0], surface=surf.n_triangles(), surface_s=surf_s,
               sun_area_2d=float(sun.surface_area_2d), sun_s=sun_s, sun_peak_gib=sun_peak,
               ladder=lad.shape[0], voxel=voxel, alpha=alpha.n_triangles(), alpha_s=alpha_s,
               parts_s=parts_s, peak_gib=peak,
               **{k: parts[k] for k in ("clusters", "kept", "filled", "trimmed")})
    log("mesh", f"canopy {canopy.shape[0]} points: canopy_surface_mesh(max_edge=0.5) "
        f"{out['surface']} triangles in {surf_s:.3f}s; sun_exposure (nadir, grid) 2D area "
        f"{out['sun_area_2d']:.3f} m² in {sun_s:.3f}s ({sun_peak:.3f} GiB); laddered at "
        f"{voxel:.4f} m to {lad.shape[0]} points: alpha_complex_mesh(1.0) {out['alpha']} "
        f"triangles in {alpha_s:.3f}s; surface_clusters {out['clusters']} components, "
        f"{out['kept']} triangles in those of ≥ 20; fill_holes {out['filled']}; "
        f"map_density(0.2, 10th percentile) keeps {out['trimmed']}; the three in "
        f"{parts_s:.3f}s, max_memory_allocated {peak:.3f} GiB")
    if min(out["surface"], out["alpha"], out["trimmed"]) <= 0 or not out["sun_area_2d"] > 0:
        fail("a canopy mesh is empty, or its exposure area is not positive")
    small, _ = ladder_to(sampling, canopy, 5000)
    cloud = lad.cpu()
    runs = {dev: mesh_counts(tm, tm.alpha_complex_mesh(small.cpu(), 1.0, device=dev), cloud,
                             dev) for dev in ("cuda", "cpu")}
    a, b = runs["cuda"], runs["cpu"]
    eq = {k: (a[k] == b[k]) if isinstance(a[k], int) else bool(torch.equal(a[k], b[k]))
          for k in a}
    out["card_cpu"] = eq
    log("mesh", f"{small.shape[0]}-point ladder against the {cloud.shape[0]}-point one, card = "
        f"CPU: {eq} (differing densities: {int((a['dens'] != b['dens']).sum())})")
    if not all(eq.values()):
        fail("the meshes' counts, densities or colours differ between the card and the CPU")
    return out


def octree_geometry_path(octree, geometry, pts, labels, trees) -> dict:
    """Phase 18d: ``build_octree`` on the plot (depth 6, stop 250),
    ``get_center`` and ``get_radius`` on each tree on the card and on the
    CPU, ``generate_grid`` of the footprint."""
    import torch

    root, s, _ = timed(lambda: octree.build_octree(pts, max_depth=6, stop_below=250))
    lv = octree.leaves(root)
    rows = sum(len(leaf.indices) for leaf in lv)
    out = dict(leaves=len(lv), rows=rows, s=s, deepest=max(leaf.depth for leaf in lv))
    worst = 0.0
    on = {"cuda": (pts, labels), "cpu": (pts.cpu(), labels.cpu())}
    for t in trees:
        vals = {}
        for dev, (p, lab) in on.items():
            mm = lab == t.tree_id
            vals[dev] = torch.cat([geometry.get_center(p, mm, meth) for meth in
                                   ("centroid", "top", "bottom")]
                                  + [geometry.get_radius(p, mm)[None]]).cpu().double()
        rel = ((vals["cuda"] - vals["cpu"]).abs() / vals["cpu"].abs().clamp(min=1.0)).max()
        worst = max(worst, float(rel))
    lo = pts.amin(0).tolist()
    hi = pts.amax(0).tolist()
    cells = geometry.generate_grid(tuple(lo[:2]), tuple(hi[:2]))
    out.update(center_radius_max_rel=worst, grid_cells=len(cells))
    log("octree", f"build_octree on {pts.shape[0]} points (depth 6, stop 250): {len(lv)} leaves "
        f"holding {rows} rows, deepest {out['deepest']}, {s:.3f}s; get_center (centroid, top, "
        f"bottom) and get_radius on {len(trees)} trees, card against CPU: largest difference "
        f"{worst:.3e} of max(|CPU|, 1 m); generate_grid of the footprint {len(cells)} cells, "
        f"first {[[round(v, 3) for v in c] for c in cells[0]]}")
    if rows != pts.shape[0] or len(cells) != 6:
        fail("the octree's leaves do not partition the plot, or the footprint grid is wrong")
    if worst > 1e-6:
        fail("get_center/get_radius differ between the card and the CPU by more than 1e-6")
    return out


STEP_N = 16_384  # rows a tree of phase 18e (__graft_entry__.entry()'s tree)
STEP_KW = dict(k=8, n_hyp=64)


def step_rank(trees, mask, seed: int, n_trees_axis: int, small=None, mesh=None) -> dict:
    """A rank of phase 18e: ``multi_tree_pipeline_step`` on its block of
    the [T, N, 3] trees over a (``n_trees_axis``, ranks / it) mesh, a first
    and a warm call; then, given ``small``, the JAX test's two trees."""
    import torch

    from pyqsm_tpu_torch.parallel import mesh as pm
    from pyqsm_tpu_torch.parallel import pipeline_step as ps
    from pyqsm_tpu_torch.parallel.collective_ops import ring_knn

    tp = pm.tree_points_mesh(n_trees_axis, device=mesh.device)
    step = ps.multi_tree_pipeline_step(tp, **STEP_KW)
    blk = pm.shard_tree_batch(torch.as_tensor(trees), tp)
    mblk = pm.shard_tree_batch(torch.as_tensor(mask), tp)
    draws = ps.step_draws(seed, tp, mblk, STEP_KW["n_hyp"])
    out = dict(rank=mesh.rank, coords=tp.coords(), device=str(mesh.device), backend=mesh.backend)
    cuda = mesh.device.type == "cuda"
    for call in ("first", "warm"):
        if cuda:
            torch.cuda.synchronize(mesh.device)
            torch.cuda.reset_peak_memory_stats(mesh.device)
        t0 = time.perf_counter()
        res = step(blk, mblk, draws)
        if cuda:
            torch.cuda.synchronize(mesh.device)
        out[f"{call}_s"] = time.perf_counter() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30 if cuda else 0.0
    out["res"] = res
    # the step's neighbour lists (its first stage again, outside the timed calls)
    knn = [ring_knn(torch.where(m[:, None], p, 1e6), torch.where(m[:, None], p, 1e6), m,
                    STEP_KW["k"] + 1, "points", mesh=tp) for p, m in zip(blk, mblk)]
    out["res"].update(knn_d=torch.stack([d[:, 1:] for d, _ in knn]),
                      knn_i=torch.stack([i[:, 1:] for _, i in knn]))
    if small is not None:
        sblk = pm.shard_tree_batch(torch.as_tensor(small[0]), tp)
        smb = pm.shard_tree_batch(torch.as_tensor(small[1]), tp)
        out["small"] = step(sblk, smb, ps.step_draws(seed, tp, smb, STEP_KW["n_hyp"]))
    return out


def assemble(ranks, key, t_axis: int):
    """The ranks' [T_local, P_local, ...] blocks of ``key`` as [T, N, ...]."""
    import torch

    p_axis = len(ranks) // t_axis
    return torch.cat([torch.cat([ranks[t * p_axis + j]["res"][key] for j in range(p_axis)], 1)
                      for t in range(t_axis)])


def step_trees(sampling, pts, labels, trees):
    """The 8 trees voxel-laddered to at most 4·``STEP_N`` rows and cut to
    ``STEP_N`` of them (a seeded choice, in row order): numpy [T, N, 3] and
    an all-true mask. Cut, not padded: a padded row sits at 10⁶ m, every
    candidate ties for its neighbours, the ring and a single block break
    those ties in other orders, and the padded rows' edges enter the
    Laplacian of the live ones (as in the JAX package), so one rank and
    four would contract differently."""
    import numpy as np

    batch = np.zeros((len(trees), STEP_N, 3), np.float32)
    for i, t in enumerate(trees):
        rows, _ = walk_tree(sampling, pts, labels, t.tree_id, 4 * STEP_N)
        if len(rows) < STEP_N:
            fail(f"tree {t.tree_id} laddered to {len(rows)} rows, fewer than {STEP_N}")
        batch[i] = rows[np.sort(np.random.default_rng(i).choice(len(rows), STEP_N,
                                                                replace=False))]
    return batch, np.ones((len(trees), STEP_N), bool)


def small_step_trees():
    """The JAX test's case (tests/test_parallel.py:25): two noisy 0.3 m
    branches of 512 rows, 3 m long."""
    import numpy as np

    out = []
    for seed in range(2):
        rng = np.random.default_rng(seed)
        t, th = rng.uniform(0, 3.0, 512), rng.uniform(0, 2 * np.pi, 512)
        r = 0.3 + rng.normal(0, 0.005, 512)
        out.append(np.stack([r * np.cos(th), r * np.sin(th), t], 1))
    return np.stack(out).astype(np.float32), np.ones((2, 512), bool)


def sharded_step_path(launch, sampling, pts, labels, trees) -> dict:
    """Phase 18e: the sharded multi-tree step at full width over 4 ranks on
    a (2, 2) mesh (NCCL with a card each on four cards, gloo on ``cuda:0``
    otherwise), against one rank on a (1, 1) mesh; the JAX test's case on
    the card's ranks against four gloo ranks on the CPU."""
    import torch

    batch, mask = step_trees(sampling, pts, labels, trees)
    small = small_step_trees()
    count = torch.cuda.device_count()
    backend = "nccl" if count >= SHARDED_RANKS else "gloo"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch(step_rank, SHARDED_RANKS, backend, args=(batch, mask, 18, 2, small),
                   device="cuda" if backend == "nccl" else "cuda:0", timeout=BUDGET_S)
    launch_s = time.perf_counter() - t0
    one = launch(step_rank, 1, "gloo", args=(batch, mask, 18, 1), device="cuda:0",
                 timeout=BUDGET_S)
    cpu = launch(step_rank, SHARDED_RANKS, "gloo", args=(small[0], small[1], 18, 2),
                 device="cpu", timeout=BUDGET_S)
    out = dict(backend=backend, rows=[int(m.sum()) for m in mask], launch_s=launch_s,
               rank_warm_s=[r["warm_s"] for r in ranks], rank_first_s=[r["first_s"] for r in ranks],
               rank_peak_gib=[r["peak_gib"] for r in ranks], one_warm_s=one[0]["warm_s"],
               one_peak_gib=one[0]["peak_gib"])
    lab = assemble(ranks, "labels", 2)
    gid = torch.arange(STEP_N, dtype=lab.dtype)[None].expand_as(lab)
    live = torch.as_tensor(mask)
    radius = torch.cat([ranks[2 * t]["res"]["fit_radius"] for t in range(2)])
    # against one rank: the ring merges a hop's candidates after the
    # earlier hops', so an exact tie in d² (the expanded form's float32 d²
    # at plot coordinates is a multiple of ~1e-4 m²) can keep another id
    # than one block's lower index does: the distances must be equal slot
    # for slot, and the labels on every row whose neighbour ids are equal
    one_res = one[0]["res"]
    tie = (assemble(ranks, "knn_i", 2) != one_res["knn_i"]).any(-1)
    lab_diff = lab != one_res["labels"]
    checks = dict(
        fit_radius=bool((torch.isfinite(radius) & (radius > 0)).all()),
        labels_le_id=bool((lab <= gid)[live].all()),
        contracted_finite=bool(torch.isfinite(assemble(ranks, "contracted", 2)).all()),
        fits_replicated=all(torch.equal(ranks[2 * t]["res"][k], ranks[2 * t + 1]["res"][k])
                            for t in range(2) for k in ("fit_radius", "fit_center")),
        knn_dist_one_rank=bool(torch.equal(assemble(ranks, "knn_d", 2), one_res["knn_d"])),
        labels_one_rank_outside_ties=bool(not (lab_diff & ~tie).any()),
        nbr_dist_one_rank=bool(torch.equal(assemble(ranks, "nbr_dist_mean", 2),
                                           one_res["nbr_dist_mean"])))
    con_diff = float((assemble(ranks, "contracted", 2) - one_res["contracted"])[live]
                     .abs().max())

    def small_of(rs, key):
        return torch.cat([torch.cat([rs[2 * t + j]["small"][key] if "small" in rs[0] else
                                     rs[2 * t + j]["res"][key] for j in range(2)], 1)
                          for t in range(2)])

    s_con = float((small_of(ranks, "contracted") - small_of(cpu, "contracted")).abs().max())
    checks.update(small_labels=bool(torch.equal(small_of(ranks, "labels"),
                                                small_of(cpu, "labels"))),
                  small_contracted=s_con <= 1e-4,
                  small_fit=all(torch.equal(ranks[2 * t]["small"]["fit_radius"],
                                            cpu[2 * t]["res"]["fit_radius"]) for t in range(2)))
    out.update(checks=checks, contracted_one_rank_max_diff=con_diff,
               tie_rows=int(tie.sum()), label_rows_differing=int(lab_diff.sum()),
               small_contracted_max_diff=s_con, fit_radius=radius.tolist(),
               labels=[int(torch.unique(lab[t][live[t]]).numel()) for t in range(lab.shape[0])])
    for r in ranks:
        log("step", f"rank {r['rank']} {r['coords']} ({r['device']}, {r['backend']}): 4 trees x "
            f"{STEP_N // 2} rows, first {r['first_s']:.3f}s, warm {r['warm_s']:.3f}s, "
            f"max_memory_allocated {r['peak_gib']:.3f} GiB")
    log("step", f"8 trees ({out['rows']} live rows of {STEP_N}), k=8, 64 hypotheses, (2, 2) mesh "
        f"over {SHARDED_RANKS} ranks ({backend}; launch {launch_s:.2f}s); one rank on a (1, 1) "
        f"mesh warm {out['one_warm_s']:.3f}s, {out['one_peak_gib']:.3f} GiB; fit radii "
        f"{[round(x, 4) for x in out['fit_radius']]}; labels a tree after one round "
        f"{out['labels']}; against one rank: {out['tie_rows']} rows keep another id on a d² tie, "
        f"{out['label_rows_differing']} labels differ (all on such rows: "
        f"{checks['labels_one_rank_outside_ties']}), contracted max diff {con_diff:.3e} m (the "
        f"graphs differ on those ties); the JAX test's "
        f"case card vs CPU ranks: contracted max diff {s_con:.3e} m; checks {checks}")
    if not all(checks.values()):
        fail(f"the sharded multi-tree step failed a check: "
             f"{[k for k, v in checks.items() if not v]}")
    return out


def bench_plot_path(bm, mt, process_plot, Config, pts, iso_cfg, plot_kw) -> dict:
    """Phase 19 (a): ``process_plot`` on the bench's 10 M-point plot at
    phase 5's settings, a cold and a steady call, the counters set to 0
    just before the cold call and read just after it."""
    import torch

    mask = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    out = {"points": int(pts.shape[0])}
    runs = {}
    for call in ("cold", "steady"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(bm, mt)
        t = time.perf_counter()
        runs[call] = process_plot(pts, mask, Config(), iso_cfg, **plot_kw, device="cuda")
        torch.cuda.synchronize()
        r = runs[call]
        out[call] = dict(s=time.perf_counter() - t, stages=r.timings,
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                         launches=launch_counts(bm, mt))
        log("bench_plot", f"{call} process_plot on {pts.shape[0]} points: "
            f"{out[call]['s']:.3f}s, stages {r.timings}, cycles {r.growth.cycles_run} claim "
            f"{r.growth.claim}, band_matvec launches {out[call]['launches']['band_matvec']}, "
            f"max_memory_allocated {out[call]['peak_gib']:.3f} GiB")
    res = runs["cold"]
    n_cyl = [int(t.cylinders.count()) for t in res.trees]
    finite = all(bool(torch.isfinite(t.cylinders.radius).all())
                 and bool(torch.isfinite(t.cylinders.center).all()) for t in res.trees)
    out.update(trees=[(t.tree_id, t.n_points) for t in res.trees], cylinders=n_cyl,
               cycles=res.growth.cycles_run, claim=res.growth.claim,
               steady_equal=same_plot(runs["steady"], res), counts=out["cold"]["launches"])
    log("bench_plot", f"trees {out['trees']}, cylinders {n_cyl} total {sum(n_cyl)}; the steady "
        f"call equals the cold one bit for bit: {out['steady_equal']}")
    if len(res.trees) != N_TREES or not finite or min(n_cyl, default=0) < 1:
        fail(f"the 10 M-point plot: {len(res.trees)} trees of {N_TREES}, cylinders {n_cyl}, "
             f"finite {finite}")
    if not out["steady_equal"]:
        fail("two process_plot calls on the 10 M-point plot differ")
    if out["counts"]["band_matvec"] <= 0:
        fail("the 10 M-point plot never launched band_matvec")
    return out


def reference_defaults_path(bm, mt, ti, sampling, IsolationConfig, pts, small, seed) -> dict:
    """Phase 19 (b): ``build_trees`` at ``IsolationConfig()`` (the
    reference's defaults, bench.py:533-565) on the bench's plot, cold then
    steady, trees counted on the device as the bench counts them; then
    card = CPU on phase 4's plot and on a 160 000-point plot in the
    bench's layout."""
    import torch

    ref_iso = IsolationConfig()
    mask = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    # the radius graph holds neighbor_cap = 16 ids a row at any cfg.k
    # (build_trees never reads k): reckon its bytes before the call
    reps = int(sampling.voxel_downsample(pts, ref_iso.max_dist / 2.0, mask)[1].sum())
    out = {"points": int(pts.shape[0]), "representatives": reps,
           "graph_gib": reps * 16 * 4 / 2 ** 30}
    log("ref_defaults", f"IsolationConfig() = {ref_iso}; {reps} representatives at "
        f"{ref_iso.max_dist / 2.0} m, radius graph {out['graph_gib']:.3f} GiB of int32 ids "
        f"(16 a row)")
    runs = {}
    for call in ("cold", "steady"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches(bm, mt)
        t = time.perf_counter()
        g = ti.build_trees(pts, mask, ref_iso, device="cuda")
        trees = int(sampling.label_segments(g.labels, u_cap=4096)[4])
        torch.cuda.synchronize()
        runs[call] = g
        out[call] = dict(s=time.perf_counter() - t, trees=trees, cycles=g.cycles_run,
                         claim=g.claim, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                         launches=launch_counts(bm, mt))
        log("ref_defaults", f"{call} build_trees(IsolationConfig()) on {pts.shape[0]} points: "
            f"{out[call]['s']:.3f}s, trees found {trees}, claim {g.claim}, cycles "
            f"{g.cycles_run}, max_memory_allocated {out[call]['peak_gib']:.3f} GiB")
    out["counts"] = out["cold"]["launches"]
    out["steady_equal"] = same_growth(runs["steady"], runs["cold"])
    log("ref_defaults", f"the steady call equals the cold one (labels, order, cycles): "
        f"{out['steady_equal']}")
    if not out["steady_equal"]:
        fail("two build_trees(IsolationConfig()) calls on the bench's plot differ")
    # card = CPU at the defaults
    plots = {"phase 4's two trees": small,
             f"{DEFAULTS_CHECK_POINTS} points, bench layout":
                 synthetic_plot(DEFAULTS_CHECK_POINTS, N_TREES, seed, "cuda").cpu().numpy()}
    out["card_cpu"] = {}
    for name, p in plots.items():
        m = torch.ones(len(p), dtype=torch.bool)
        t = time.perf_counter()
        card = ti.build_trees(p, m, ref_iso, device="cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu = ti.build_trees(p, m, ref_iso, device="cpu")
        cpu_s = time.perf_counter() - t
        lab = cpu.labels.numpy()
        n = len(set(lab[lab >= 0].tolist()))
        eq = same_growth(card, cpu)
        out["card_cpu"][name] = dict(points=len(p), trees=n, claim=cpu.claim,
                                     cycles=cpu.cycles_run, equal=eq, card_s=card_s, cpu_s=cpu_s)
        log("ref_defaults", f"{name} ({len(p)} points) at IsolationConfig(): card {card_s:.3f}s, "
            f"cpu {cpu_s:.3f}s; {n} trees, claim {cpu.claim}, cycles {cpu.cycles_run}; labels, "
            f"order and cycles equal: {eq}")
        if not eq:
            fail(f"build_trees(IsolationConfig()) on {name}: the card and the CPU differ")
    if out["card_cpu"][name]["trees"] < 1:  # the comparison must see grown trees
        fail(f"build_trees(IsolationConfig()) found no tree on {name}")
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
        from pyqsm_tpu_torch.io import native
        from pyqsm_tpu_torch.models import graph_features, joining, reconstruction, segmentation
        from pyqsm_tpu_torch.ops import features
        from pyqsm_tpu_torch.pipeline import driver
        from pyqsm_tpu_torch.ops import geometry, octree, outliers
        from pyqsm_tpu_torch.ops import mesh as tm
        from pyqsm_tpu_torch.ops import neighbors as tn
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
    same_bits = same_plot(again, res)
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

    # 17. the batch driver on phase 5's plot written as two overlapping text
    # scans: (a) native ingestion, (b) loop_over_files over a staged
    # pipeline (qsm → segment → recover), (c) its resume, (d) joining the
    # scans, (e) viz_main, (f) the card against the CPU on phase 4's plot
    torch.cuda.empty_cache()
    import tempfile
    from pathlib import Path

    t17 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d17:
        d17 = Path(d17)
        (d17 / "scans").mkdir()
        per = args.points // N_TREES
        scans = write_scans(pts.cpu().numpy(), per, per // 2, d17 / "scans")
        log("ingest", f"wrote {[sc['path'].name for sc in scans.values()]} "
            f"({[len(sc['part']) for sc in scans.values()]} rows) in "
            f"{time.perf_counter() - t17:.2f}s")
        ing = ingestion_path(native, readers, scans)
        mods = dict(bm=bm, pp=pp, sampling=sampling, features=features,
                    segmentation=segmentation, graph_features=graph_features,
                    reconstruction=reconstruction, joining=joining, driver=driver,
                    device="cuda",
                    workdir=d17 / "checkpoints")
        zero_launches(bm, mt)
        drv = batch_driver_path(mods, scans, plot_kw, iso_cfg, Config())
        driver_counts = launch_counts(bm, mt)
        jn17 = joining_path(joining, reconstruction, drv["results"], scans, "cuda")
    viz17 = viz_path(cli, readers, vm, tree, "cuda")
    scc = segment_card_cpu(mods, small)
    log("driver", f"phase 17 in {time.perf_counter() - t17:.2f}s")
    print(json.dumps({"driver": {"ingest": ing, "stages": drv["stats"], "loop_s": drv["total_s"],
                                 "resume_s": drv["resume_s"], "resume": drv["resume_stats"],
                                 "classifier": {s: {k: float(r[k]) for k in (
                                     "loss", "train_acc", "val_acc", "pred_acc", "full_acc")}
                                     for s, r in drv["results"].items()},
                                 "join": jn17, "viz": viz17, "card_cpu": scc}}, default=str),
          flush=True)
    # 18. the last slice's modules on the main path's plot: (a) the grid
    # index and its queries, (b) clean_cloud, (c) the scipy meshes with
    # map_density, (d) the octree and the geometry helpers, (e) the sharded
    # multi-tree step, each drive with the counters set to 0 just before
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    p18, c18 = {}, {}
    for part, drive in (
            ("grid index (18a)", lambda: grid_index_path(tn, tn.knn, sampling, pts, small)),
            ("clean_cloud (18b)", lambda: clean_cloud_path(outliers, pts, res.growth.labels,
                                                           res.trees[big].tree_id, small)),
            ("meshes (18c)", lambda: meshes_path(tm, tmr, sampling, pts)),
            ("octree, geometry (18d)", lambda: octree_geometry_path(
                octree, geometry, pts, res.growth.labels, res.trees)),
            ("sharded step (18e)", lambda: sharded_step_path(launch, sampling, pts,
                                                             res.growth.labels, res.trees))):
        zero_launches(bm, mt)
        t_part = time.perf_counter()
        p18[part] = drive()
        c18[part] = launch_counts(bm, mt)
        log("last_slice", f"{part} in {time.perf_counter() - t_part:.2f}s, kernel launches "
            f"{c18[part]}")
    log("last_slice", f"phase 18 in {time.perf_counter() - t18:.2f}s")
    print(json.dumps({"last_slice": p18}, default=str), flush=True)
    # 19. the bench's two configurations on its 10 M-point plot: (a) the main
    # path at phase 5's settings, (b) build_trees at the reference's defaults
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    pts10 = synthetic_plot(BENCH_POINTS, N_TREES, args.seed, "cuda")
    p19a = bench_plot_path(bm, mt, process_plot, Config, pts10, iso_cfg, plot_kw)
    torch.cuda.empty_cache()
    p19b = reference_defaults_path(bm, mt, ti, sampling, IsolationConfig, pts10, small, args.seed)
    del pts10
    log("bench_configs", f"phase 19 in {time.perf_counter() - t19:.2f}s")
    print(json.dumps({"bench_configs": {"main_10m": p19a, "reference_defaults": p19b}},
                     default=str), flush=True)
    paths = {"main (phase 5)": main_counts, "canopy (13a)": cp["counts"],
             "single-tree skeletonize (13b)": single["skeletonize"]["launches"],
             "single-tree canopy_metrics (13b)": single["canopy_metrics"]["launches"],
             "raycast grid (14)": rgp["path_launches"],
             "wavefront (15a-b)": wfp["counts"],
             "sharded raycast, 4 ranks (15c)": shr["counts"],
             "sphere walk (16a)": walk_counts, "CLI entry points (16b)": cli_counts,
             "sphere forest (16c)": forest_counts, "batch driver (17b-c)": driver_counts, **c18,
             "main path at 10 M points (19a)": p19a["counts"],
             "build_trees at IsolationConfig() (19b)": p19b["counts"]}

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
