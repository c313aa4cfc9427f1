#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pyqsm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--points N] [--seed S]

Phases, each printing one line with its elapsed seconds:

1. device: name, count, ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` builds ``csrc/band_matvec.cu`` for sm_90a (ptxas lines);
3. kernel: ``band_matvec`` against its plain version at the contraction's
   fine [8, 160, 256, 768] and coarse [8, 40, 256, 768] band shapes, timed
   with CUDA events beside its memory bound and one ``torch.bmm`` of the
   same windows;
4. reference: ``process_plot`` on a small two-tree plot on the card and on
   the CPU (the port's plain path) — same tree ids and point counts;
5. main path: ``process_plot`` on a synthetic plot (the bench's layout and
   settings: 8 trees, 40 000-point skeleton cap) with every kernel launch
   counter set to 0 just before and read just after.

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
N_TREES = 8  # the bench's plot layout
BUDGET_S = 1000  # wall-clock limit of the whole script, build included


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


def check_band_matvec(bm, shape, seed: int) -> dict:
    """Kernel vs plain version on seeded inputs at one band shape, then
    timings of the kernel, the plain version and one ``torch.bmm``."""
    import torch

    t, nb = shape
    n = nb * bm.BAND_BLOCK
    g = torch.Generator(device="cuda").manual_seed(seed)
    b_w = torch.rand(t, nb, bm.BAND_BLOCK, 3 * bm.BAND_BLOCK, generator=g, device="cuda")
    x = torch.randn(t, n, 3, generator=g, device="cuda")
    y = bm.band_matvec_cuda(b_w, x)
    ref = bm.band_matvec_plain(b_w, x)
    mag = bm.band_matvec_plain(b_w, x.abs())  # Σ_j |W_ij| |x_j| per row
    torch.cuda.synchronize()
    err = (y - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / mag.clamp_min(1e-30)).max())
    # f32 sums of 768 terms in two different orders: each is within
    # 768·2⁻²⁴·Σ|W||x| of the exact value
    tol = 768 * 2.0 ** -24 * float(mag.max())
    xw = bm._windows(x, nb).reshape(t * nb, 3 * bm.BAND_BLOCK, 3)
    w2 = b_w.reshape(t * nb, bm.BAND_BLOCK, 3 * bm.BAND_BLOCK)
    ms = time_ms(lambda: bm.band_matvec_cuda(b_w, x))
    plain_ms = time_ms(lambda: bm.band_matvec_plain(b_w, x))
    library_ms = time_ms(lambda: torch.bmm(w2, xw))
    nbytes = b_w.numel() * 4 + x.numel() * 4 + y.numel() * 4
    flops = 2 * b_w.numel() * 3
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / FP32_FLOP_S * 1e3
    return dict(shape=[t, nb, bm.BAND_BLOCK, 3 * bm.BAND_BLOCK], max_abs_err=max_abs,
                max_rel_err=max_rel, tol=tol, ok=max_abs <= tol and bool(torch.isfinite(y).all()),
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                gbytes=nbytes / 1e9)


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
        from pyqsm_tpu_torch.config import Config, IsolationConfig
        from pyqsm_tpu_torch.models.plot_pipeline import process_plot
        from pyqsm_tpu_torch.ops import band_matvec as bm
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

    # 2. kernel build from the checkout's sources
    t_build = time.perf_counter()
    so = bm.build()
    bm._load()
    ptxas = [ln.strip() for ln in bm.BUILD_LOG.splitlines()
             if any(w in ln for w in ("registers", "spill", "smem", "Compiling entry"))]
    log("build", f"{so.name} in {time.perf_counter() - t_build:.2f}s")
    for ln in ptxas:
        print(f"    ptxas: {ln}", flush=True)

    # 3. kernel vs plain at the path's shapes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = {}
    for name, nb in (("fine", 160), ("coarse", 40)):
        c = check_band_matvec(bm, (N_TREES, nb), args.seed)
        checks[name] = c
        log("kernel", f"band_matvec {name} {c['shape']}: max_abs_err {c['max_abs_err']:.3e} "
            f"(tol {c['tol']:.3e}), max_rel_err {c['max_rel_err']:.3e}; kernel {c['ms']:.4f} ms, "
            f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}, {c['gbytes']:.3f} GB), "
            f"plain {c['plain_ms']:.4f} ms, torch.bmm {c['library_ms']:.4f} ms")
        if not c["ok"]:
            fail(f"band_matvec {name}: kernel disagrees with its plain version")

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
    iso_cfg = IsolationConfig(base_min_points=200, low_pctile=4.0, max_dist=0.2, cycles=400,
                              min_frontier=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log("main", f"process_plot on {pts.shape[0]} points, {N_TREES} trees")
    bm.LAUNCHES = 0
    t_main = time.perf_counter()
    res = process_plot(pts, mask, Config(), iso_cfg, skeleton_voxel=0.03,
                       max_skeleton_points=40_000, min_tree_points=2000,
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
        f"total {main_s:.2f}s; band_matvec launches {launches}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if len(res.trees) != N_TREES:
        fail(f"found {len(res.trees)} trees, the plot holds {N_TREES}")
    if not finite or min(n_cyl) < 1:
        fail("a tree has no cylinders or non-finite cylinder values")
    if launches <= 0:
        fail("the main path never launched band_matvec")

    fine = checks["fine"]
    kernels = [dict(
        name="band_matvec", route="cuda", source="pyqsm_tpu_torch/csrc/band_matvec.cu",
        replaces="pyqsm_tpu/ops/pallas_kernels.py:183", launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in checks.values()),
        ms=fine["ms"], plain_ms=fine["plain_ms"], bound_ms=fine["bound_ms"],
        bound_by=fine["bound_by"], library_ms=fine["library_ms"], check="pass",
        shape=fine["shape"], coarse={k: checks["coarse"][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")})]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
