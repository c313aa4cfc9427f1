"""Console entry points (counterpart of ``pyqsm_tpu/pipeline/cli.py``): tree
isolation, QSM generation, canopy metrics, the ray-casting study and the
HTML viewer export over any supported point-cloud file, with JSON/NPZ/HTML
artifacts out — the same arguments and the same artifacts as the JAX
package's commands.

    python -m pyqsm_tpu_torch.pipeline.cli INPUT [-o DIR] ...   # tree isolation

Each ``main(argv, device=...)`` runs on the card unless ``device`` names
another; there is no compilation cache to set up.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pyqsm_tpu_torch.device import DEFAULT_DEVICE, resolve_device


def _load(path: str, voxel: float | None, device: torch.device):
    from pyqsm_tpu_torch.io.readers import read_point_cloud
    from pyqsm_tpu_torch.ops.sampling import voxel_downsample

    data = read_point_cloud(path)
    pts = torch.as_tensor(data.points.astype(np.float32), device=device)
    mask = torch.ones(len(data.points), dtype=torch.bool, device=device)
    if voxel:
        pts, mask, _ = voxel_downsample(pts, voxel, mask)
    return data, pts, mask


def _common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("input", help="point cloud file (.las/.pcd/.ply/.xyz/.npz)")
    parser.add_argument("-o", "--output-dir", default=".", help="artifact directory")
    parser.add_argument("-c", "--config", default=None, help="TOML config path")
    parser.add_argument("--voxel", type=float, default=None,
                        help="pre-downsample voxel size (m)")


def tree_isolation_main(argv: list[str] | None = None,
                        device: str | torch.device = DEFAULT_DEVICE) -> int:
    parser = argparse.ArgumentParser(
        "pyqsm-tree-isolation", description="Isolate trees in a plot scan")
    _common(parser)
    parser.add_argument("--cycles", type=int, default=None)
    parser.add_argument("--base-min-points", type=int, default=None,
                        help="min DBSCAN points for a trunk-base seed")
    parser.add_argument("--low-pctile", type=float, default=None,
                        help="z-percentile of the trunk-base slice")
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    from pyqsm_tpu_torch.config import load_config
    from pyqsm_tpu_torch.io.readers import write_npz
    from pyqsm_tpu_torch.models.isolation import build_trees

    iso = load_config(args.config).isolation
    overrides = {k: v for k, v in (("cycles", args.cycles),
                                   ("base_min_points", args.base_min_points),
                                   ("low_pctile", args.low_pctile)) if v is not None}
    if overrides:
        iso = dataclasses.replace(iso, **overrides)
    _, pts, mask = _load(args.input, args.voxel, dev)
    t0 = time.perf_counter()
    res = build_trees(pts, mask, iso, device=dev)
    labels = res.labels.cpu().numpy()
    dt = time.perf_counter() - t0
    out = Path(args.output_dir) / (Path(args.input).stem + "_trees.npz")
    write_npz(out, pts.cpu().numpy(), labels=labels, order=res.order.cpu().numpy())
    n_trees = len(np.unique(labels[labels >= 0]))
    print(f"isolated {n_trees} trees from {int(mask.sum())} pts "
          f"in {dt:.1f}s ({int(res.cycles_run)} cycles) -> {out}")
    return 0


def qsm_generation_main(argv: list[str] | None = None,
                        device: str | torch.device = DEFAULT_DEVICE) -> int:
    parser = argparse.ArgumentParser(
        "pyqsm-qsm-generation", description="Fit a QSM cylinder model to a tree")
    _common(parser)
    parser.add_argument("--method", choices=("sphere", "skeleton"), default="sphere")
    parser.add_argument("--max-steps", type=int, default=256)
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    from pyqsm_tpu_torch.config import load_config
    from pyqsm_tpu_torch.io.artifacts import save_cylinders

    cfg = load_config(args.config)
    _, pts, mask = _load(args.input, args.voxel, dev)
    t0 = time.perf_counter()
    if args.method == "sphere":
        from pyqsm_tpu_torch.models.qsm import generate_qsm

        cyls = generate_qsm(pts, mask, cfg, max_steps=args.max_steps, device=dev).cylinders
    else:
        from pyqsm_tpu_torch.models.skeleton import skeletonize

        _, _, cyls = skeletonize(pts, mask, cfg.skeletonize, device=dev)
    dt = time.perf_counter() - t0
    out = Path(args.output_dir) / (Path(args.input).stem + "_qsm.npz")
    save_cylinders(out, cyls)
    print(f"{int(cyls.count())} cylinders, volume {float(cyls.volume()):.3f} m3, "
          f"{dt:.1f}s -> {out}")
    return 0


def canopy_metrics_main(argv: list[str] | None = None,
                        device: str | torch.device = DEFAULT_DEVICE) -> int:
    parser = argparse.ArgumentParser(
        "pyqsm-canopy-metrics", description="Canopy metrics + epiphyte split")
    _common(parser)
    parser.add_argument("--cell", type=float, default=0.05,
                        help="projected-area raster cell (m)")
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    from pyqsm_tpu_torch.io.artifacts import save_metrics
    from pyqsm_tpu_torch.models.canopy import canopy_metrics

    _, pts, mask = _load(args.input, args.voxel, dev)
    t0 = time.perf_counter()
    m = canopy_metrics(pts, mask, cell=args.cell, device=dev)
    dt = time.perf_counter() - t0
    out = Path(args.output_dir) / (Path(args.input).stem + "_metrics.json")
    save_metrics(out, m)
    print(f"classes {m['counts']}, width@bh {m['width_at_bh']:.2f} m, "
          f"{dt:.1f}s -> {out}")
    return 0


def raycast_main(argv: list[str] | None = None,
                 device: str | torch.device = DEFAULT_DEVICE) -> int:
    """Reconstruct a canopy surface from the cloud (marching tetrahedra)
    and measure sun/camera exposure against it — the reference's
    ray-casting study as one command."""
    parser = argparse.ArgumentParser(
        "pyqsm-raycast", description="Canopy surface reconstruction + exposure")
    _common(parser)
    parser.add_argument("--mesh-voxel", type=float, default=0.15,
                        help="reconstruction voxel (m)")
    parser.add_argument("--elevations", type=float, nargs="+",
                        default=[30.0, 60.0, 90.0])
    parser.add_argument("--azimuth", type=float, default=180.0)
    parser.add_argument("--rays-per-cell", type=int, default=4)
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    from pyqsm_tpu_torch.io.artifacts import save_metrics
    from pyqsm_tpu_torch.models.raycast import cast_scene, sun_exposure
    from pyqsm_tpu_torch.ops.voxelmesh import poisson_like_mesh

    _, pts, mask = _load(args.input, args.voxel, dev)
    t0 = time.perf_counter()
    mesh = poisson_like_mesh(pts, mask, voxel=args.mesh_voxel)
    n_tri = mesh.n_triangles()
    cam = cast_scene(mesh, device=dev)
    sweep = {}
    for el in args.elevations:
        r = sun_exposure(mesh, args.azimuth, el, device=dev)
        sweep[str(el)] = {"surface_area_3d": r.surface_area_3d,
                          "surface_area_2d": r.surface_area_2d,
                          "hit_fraction": r.hit_fraction}
    dt = time.perf_counter() - t0
    out = Path(args.output_dir) / (Path(args.input).stem + "_exposure.json")
    save_metrics(out, {
        "n_triangles": int(n_tri),
        "camera": {"surface_area_3d": cam.surface_area_3d,
                   "surface_area_2d": cam.surface_area_2d,
                   "hit_fraction": cam.hit_fraction},
        "sun_sweep": sweep,
    })
    print(f"mesh {n_tri} tris; camera SA3d {cam.surface_area_3d:.2f} m2; "
          f"{len(sweep)} sun angles, {dt:.1f}s -> {out}")
    return 0


def viz_main(argv: list[str] | None = None,
             device: str | torch.device = DEFAULT_DEVICE) -> int:
    """Export a standalone interactive HTML viewer of a cloud (optionally
    coloured by an isolation label artifact) and/or a reconstructed
    canopy mesh."""
    parser = argparse.ArgumentParser(
        "pyqsm-viz", description="Standalone WebGL viewer export")
    _common(parser)
    parser.add_argument("--labels", default=None,
                        help="NPZ artifact with a 'labels' array "
                             "(e.g. pyqsm-tree-isolation output)")
    parser.add_argument("--mesh-voxel", type=float, default=None,
                        help="also reconstruct + show a surface at this voxel size (m)")
    parser.add_argument("--max-points", type=int, default=2_000_000)
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    from pyqsm_tpu_torch.utils.webviz import export_viewer

    data, pts, mask = _load(args.input, args.voxel, dev)
    mask_np = mask.cpu().numpy()
    pts_np = pts.cpu().numpy()[mask_np]
    labels = None
    if args.labels:
        lab = np.load(args.labels)["labels"]
        labels = lab[mask_np] if len(lab) == len(mask_np) else lab
    mesh_v = mesh_t = None
    if args.mesh_voxel:
        from pyqsm_tpu_torch.ops.voxelmesh import poisson_like_mesh

        m = poisson_like_mesh(pts, mask, voxel=args.mesh_voxel)
        mesh_v, mesh_t = m.vertices.cpu().numpy(), m.triangles.cpu().numpy()
    out = Path(args.output_dir) / (Path(args.input).stem + "_viewer.html")
    colors = getattr(data, "colors", None)
    if labels is not None or (colors is not None and len(colors) != len(pts_np)):
        colors = None
    export_viewer(out, points=pts_np, labels=labels, colors=colors,
                  mesh_vertices=mesh_v, mesh_triangles=mesh_t,
                  title=Path(args.input).stem, max_points=args.max_points)
    print(f"viewer -> {out} ({len(pts_np):,} points)")
    return 0


if __name__ == "__main__":
    sys.exit(tree_isolation_main())
