#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pyqsm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--points N] [--seed S]

Phases, each printing lines with the elapsed seconds:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: one ``nvcc`` per kernel source, all started together, for sm_90a
   (``csrc/band_matvec.cu``, ``csrc/band_matvec_t.cu``, ``csrc/mt_raycast.cu``,
   ``csrc/band_matvec_bf16.cu``; ptxas registers, shared memory and spills of
   each);
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
   ``raycast_to_pcd``, counters set to 0 just before;
8. kernel: ``mt_raycast`` against its plain version at the cast_scene and
   sun shapes on that mesh, timed beside its operation bound;
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
   the bf16 windows;
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
   of the prebuilt windows.

Then one JSON line ``{"kernels": [...]}``, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without that last line; so does a machine without CUDA, or a directory
that holds this script without the package beside it.
"""

from __future__ import annotations

import argparse
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
BF16_TC_FLOP_S = 989e12  # dense bf16 tensor-core rate
N_TREES = 8  # the bench's plot layout
MT_OPS_PER_PAIR = 46  # float32 ops per ray-triangle pair in csrc/mt_raycast.cu
BUDGET_S = 1000  # wall-clock limit of the whole script, build included
SHARDED_RANKS = 4  # ranks of the sharded path (phase 11)


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def fail(msg: str, code: int = 1) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


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


def check_mt_raycast(mt, origins, dirs, mesh, label: str) -> dict:
    """Kernel vs plain version on one ray bundle: tri and count equal on
    every ray, t/u/v compared bit for bit; then timings and the operation
    bound from this bundle's rays and this mesh's triangles."""
    import torch

    o, d = origins.contiguous(), dirs.contiguous()
    got = mt.mt_raycast_cuda(o, d, mesh.vertices, mesh.triangles)
    want = mt.mt_raycast_plain(o, d, mesh.vertices, mesh.triangles)
    torch.cuda.synchronize()
    t_k, tri_k, uv_k, cnt_k = got
    t_p, tri_p, uv_p, cnt_p = want
    same_miss = torch.equal(torch.isfinite(t_k), torch.isfinite(t_p))
    fin = torch.isfinite(t_p)
    t_err = float((t_k[fin] - t_p[fin]).abs().max()) if bool(fin.any()) else 0.0
    t_rel = float(((t_k[fin] - t_p[fin]).abs() / t_p[fin].abs()).max()) if bool(fin.any()) else 0.0
    uv_err = float((uv_k - uv_p).abs().max()) if uv_k.numel() else 0.0
    bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
    ok = (torch.equal(tri_k, tri_p) and torch.equal(cnt_k, cnt_p) and same_miss
          and t_rel <= 1e-6 and uv_err <= 1e-6)
    ms = time_ms(lambda: mt.mt_raycast_cuda(o, d, mesh.vertices, mesh.triangles), iters=10)
    plain_ms = time_ms(lambda: mt.mt_raycast_plain(o, d, mesh.vertices, mesh.triangles),
                       iters=3, warmup=1)
    r, n_tri = o.shape[0], mesh.triangles.shape[0]
    ops = r * n_tri * MT_OPS_PER_PAIR
    nbytes = r * (24 + 20) + n_tri * 40  # rays in, hits out, the triangle table once
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / FP32_FLOP_S * 1e3
    return dict(label=label, rays=r, triangles=n_tri, ok=ok, bitwise=bitwise,
                tri_equal=torch.equal(tri_k, tri_p), count_equal=torch.equal(cnt_k, cnt_p),
                max_abs_err=max(t_err, uv_err), t_max_rel=t_rel, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                hit_rays=int(fin.sum()), grays_s=r / (ms * 1e-3) / 1e9)


def check_band_bf16(bm, nb: int, c: int, seed: int, prepadded: bool = False) -> dict:
    """bf16 kernel vs plain version at [1, nb, 256, 768] x [1, nb·256, c]
    (``prepadded``: the halo form, x [1, (nb+2)·256, c] whose two halo
    blocks are as random as the rest): a 0/1 adjacency (~16 of 768 window
    columns a row, as the claim's) with a one-hot frontier must match
    exactly; random bf16 inputs within 768·2⁻²⁴·Σ|W||x| per output. Then
    timings of the kernel, the plain version and one ``torch.bmm`` of the
    bf16 windows, on the 0/1 inputs."""
    import torch

    bs = bm.BAND_BLOCK
    n = nb * bs
    nx = n + 2 * bs if prepadded else n
    g = torch.Generator(device="cuda").manual_seed(seed)
    w01 = (torch.rand(1, nb, bs, 3 * bs, generator=g, device="cuda") < 16 / 768).to(torch.bfloat16)
    lab = torch.randint(0, c, (nx,), generator=g, device="cuda")
    live = torch.rand(nx, generator=g, device="cuda") < 0.5
    x01 = ((lab[:, None] == torch.arange(c, device="cuda")[None, :]) & live[:, None]).to(
        torch.bfloat16)[None].contiguous()

    def kernel(w, x):
        return bm.band_matvec_bf16_cuda(w, x, prepadded=prepadded)

    def plain(w, x):
        return bm.band_matvec_plain(w, x, prepadded=prepadded)

    y01 = kernel(w01, x01)
    exact = torch.equal(y01, plain(w01, x01))
    wr = torch.randn(1, nb, bs, 3 * bs, generator=g, device="cuda").to(torch.bfloat16)
    xr = torch.randn(1, nx, c, generator=g, device="cuda").to(torch.bfloat16)
    yr = kernel(wr, xr)
    err = (yr - plain(wr, xr)).abs()
    lim = 768 * 2.0 ** -24 * plain(wr.abs(), xr.abs())
    torch.cuda.synchronize()
    within = bool((err <= lim).all())
    max_abs = float(err.max())
    del wr, xr, yr, err, lim
    w2 = w01.reshape(nb, bs, 3 * bs)
    xw = bm._windows(x01, nb, prepadded).reshape(nb, 3 * bs, c)
    ms = time_ms(lambda: kernel(w01, x01))
    plain_ms = time_ms(lambda: plain(w01, x01), iters=5, warmup=1)
    bmm_ms = time_ms(lambda: torch.bmm(w2, xw))
    nbytes = n * (3 * bs * 2 + c * 4) + nx * c * 2  # W, x read once; y written once
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = 2 * n * 3 * bs * c / BF16_TC_FLOP_S * 1e3
    return dict(shape=[1, nb, bs, 3 * bs], c=c, exact01=exact, within=within,
                max_abs_err=max_abs, ok=exact and within and bool(torch.isfinite(y01).all()),
                max_count=float(y01.max()), ms=ms, plain_ms=plain_ms, bmm_ms=bmm_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", gbytes=nbytes / 1e9)


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
    out = dict(mesh=mesh, n_raw=n_raw, n_tri=n_tri, mesh_s=mesh_s, rebuild_equal=rebuild_equal)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=2_000_000,
                    help="plot size of the main-path run (the bench measures 10 000 000)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
        from pyqsm_tpu_torch.models import isolation as ti
        from pyqsm_tpu_torch.models import raycast as tmr
        from pyqsm_tpu_torch.models.plot_pipeline import process_plot
        from pyqsm_tpu_torch.ops import band_matvec as bm
        from pyqsm_tpu_torch.ops import cuda_build
        from pyqsm_tpu_torch.ops import laplacian as lap
        from pyqsm_tpu_torch.ops import mt_raycast as mt
        from pyqsm_tpu_torch.ops import raygrid as rg
        from pyqsm_tpu_torch.ops import raytrace as tr
        from pyqsm_tpu_torch.ops import sparse as sp
        from pyqsm_tpu_torch.ops import voxelmesh as vm
        from pyqsm_tpu_torch.parallel.mesh import launch
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

    # 8. mt_raycast vs plain at the path's shapes on that mesh
    v = mesh.vertices
    center = v.mean(dim=0)
    cam = tr.pinhole_rays(center + torch.tensor([0.0, 0.0, 10.0], device="cuda"), center,
                          [0.0, 1.0, 0.0], cfg.fov_deg, cfg.width_px, cfg.height_px,
                          device="cuda")
    sun = tr.parallel_rays(v.amin(0), v.amax(0), tmr._sun_direction(180.0, 60.0), 256, 256,
                           device="cuda")
    mts = {}
    for label, (o, d) in (("cast_scene", cam), ("sun", sun)):
        c = check_mt_raycast(mt, o, d, mesh, label)
        mts[label] = c
        log("kernel", f"mt_raycast {label} {c['rays']} rays x {c['triangles']} triangles: "
            f"{c['hit_rays']} hit; tri equal {c['tri_equal']}, count equal "
            f"{c['count_equal']}, bit for bit {c['bitwise']}, max_abs_err "
            f"{c['max_abs_err']:.3e} (t max rel {c['t_max_rel']:.3e}); kernel {c['ms']:.4f} ms "
            f"({c['grays_s']:.3f} Grays/s), bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
            f"{MT_OPS_PER_PAIR} ops per pair), plain {c['plain_ms']:.4f} ms")
        if not c["ok"]:
            fail(f"mt_raycast {label}: kernel disagrees with its plain version")

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

    # 11. the sharded path over 4 ranks, against phases 5 and 9
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

    cs, sn = mts["cast_scene"], mts["sun"]
    kernels = [
        band_entry("band_matvec", "pyqsm_tpu_torch/csrc/band_matvec.cu",
                   "pyqsm_tpu/ops/pallas_kernels.py:183", launches),
        band_entry("band_matvec_t", "pyqsm_tpu_torch/csrc/band_matvec_t.cu",
                   "pyqsm_tpu/ops/pallas_kernels.py:227", lt["launches"]),
        dict(name="mt_raycast", route="cuda", source="pyqsm_tpu_torch/csrc/mt_raycast.cu",
             replaces="pyqsm_tpu/ops/pallas_kernels.py:110", launches=ray["launches"],
             max_abs_err=max(cs["max_abs_err"], sn["max_abs_err"]), ms=cs["ms"],
             plain_ms=cs["plain_ms"], bound_ms=cs["bound_ms"], bound_by=cs["bound_by"],
             library_ms=None, check="pass", shape=[cs["rays"], cs["triangles"]],
             sun={k: sn[k] for k in ("rays", "triangles", "ms", "plain_ms", "bound_ms",
                                     "max_abs_err")}),
        dict(name="band_matvec_bf16", route="cuda", source="pyqsm_tpu_torch/csrc/band_matvec_bf16.cu",
             replaces="pyqsm_tpu/ops/pallas_kernels.py:183", launches=claim["launches"],
             max_abs_err=max(bf["claim"]["max_abs_err"], bf["c128"]["max_abs_err"]),
             ms=bf["claim"]["ms"], plain_ms=bf["claim"]["plain_ms"],
             bound_ms=bf["claim"]["bound_ms"], bound_by=bf["claim"]["bound_by"],
             library_ms=bf["claim"]["bmm_ms"], check="pass", shape=bf["claim"]["shape"],
             c=bf["claim"]["c"], band_bytes=band["band_bytes"],
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
             isolation_s={"sharded band": [r[("band", 2)]["s"] for r in shd["ranks"]],
                          "sharded default": [r[("default", 2)]["s"] for r in shd["ranks"]]},
             c128={k: halo["c128"][k] for k in ("ms", "plain_ms", "bmm_ms", "bound_ms",
                                                "bound_by", "max_abs_err")}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
