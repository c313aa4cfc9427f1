"""Static checks of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points default to the card, and its config mirrors the
JAX package's."""

import ast
import dataclasses
import inspect
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "pyqsm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = {m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "pyqsm_tpu")}
    assert not bad, f"{path.name} imports {sorted(bad)}"


# modules the import scan must cover (the glob above finds every file; this
# list fails loudly if one of them moves out of its reach)
REQUIRED = ["ops/band_matvec.py", "ops/cuda_build.py", "ops/mt_raycast.py", "ops/mesh.py",
            "ops/raytrace.py", "ops/voxelmesh.py", "ops/raygrid.py", "models/raycast.py",
            "convert.py", "ops/segment.py", "state.py", "parallel/__init__.py",
            "parallel/mesh.py", "parallel/growth.py", "ops/area.py", "ops/color.py",
            "ops/cluster.py", "models/canopy.py", "ops/grid3d.py", "parallel/raycast.py",
            "ops/normals.py", "ops/ransac.py", "models/qsm.py", "io/readers.py", "io/artifacts.py",
            "pipeline/cli.py", "ops/features.py", "models/segmentation.py",
            "models/graph_features.py", "models/joining.py", "models/reconstruction.py",
            "io/native.py", "pipeline/__init__.py", "pipeline/driver.py", "utils/__init__.py",
            "utils/logging.py", "utils/timing.py", "utils/webviz.py"]


def test_import_scan_covers_every_port_module():
    scanned = {str(p.relative_to(ROOT / "pyqsm_tpu_torch")) for p in PORT_FILES[:-1]}
    assert not set(REQUIRED) - scanned


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_loads_nothing_of_native_dir(path):
    """The port builds its own ingestion library from ``csrc/pointio.cpp``;
    no file of it reaches the JAX package's ``native/`` directory."""
    text = path.read_text()
    assert "libpointio.so" not in text and '"native"' not in text and "native/" not in text


def test_every_kernel_source_is_registered_for_the_build():
    """Each ``csrc/*.cu`` source has one ``CudaLib`` in the build registry,
    so the first use of any kernel builds all of them together."""
    from pyqsm_tpu_torch.ops import band_matvec, cuda_build, mt_raycast  # noqa: F401

    sources = sorted(p.name for p in (ROOT / "pyqsm_tpu_torch" / "csrc").glob("*.cu"))
    assert sorted(lib.source.name for lib in cuda_build.REGISTRY) == sources
    assert "band_matvec_bf16.cu" in sources


def _entry_points():
    from pyqsm_tpu_torch import convert, state
    from pyqsm_tpu_torch.io import artifacts
    from pyqsm_tpu_torch.models import (canopy, isolation, plot_pipeline, qsm, raycast,
                                        segmentation, skeleton)
    from pyqsm_tpu_torch.parallel import mesh
    from pyqsm_tpu_torch.pipeline import cli

    return [plot_pipeline.process_plot, isolation.build_trees, skeleton.extract_skeleton_batch,
            convert.state_from_numpy, convert.mesh_from_numpy, raycast.cast_scene,
            raycast.sun_exposure, raycast.sun_sweep, raycast.raycast_to_pcd,
            raycast.sparse_cast_with_intersections, raycast.mri_slices,
            mesh.make_mesh, mesh.tree_points_mesh, mesh.launch, state.PointCloud.create,
            skeleton.extract_skeleton, skeleton.skeletonize, canopy.canopy_metrics,
            qsm.sphere_following_qsm, qsm.sphere_qsm_forest, qsm.generate_qsm,
            convert.front_from_numpy, artifacts.load_artifact, artifacts.load_cylinders,
            cli.tree_isolation_main, cli.qsm_generation_main, cli.canopy_metrics_main,
            cli.raycast_main, cli.viz_main, segmentation.train_classifier,
            segmentation.classify_wood_leaf, convert.classifier_from_numpy]


@pytest.mark.parametrize("fn", range(32))
def test_entry_points_default_to_cuda(fn):
    f = _entry_points()[fn]
    assert inspect.signature(f).parameters["device"].default == "cuda", f.__qualname__


def test_cuda_without_card_raises():
    """No silent CPU fallback: asking for the card without one raises."""
    from pyqsm_tpu_torch.device import resolve_device
    from pyqsm_tpu_torch.models.plot_pipeline import process_plot

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        process_plot(torch.zeros(4, 3), torch.ones(4, dtype=torch.bool))
    from pyqsm_tpu_torch.models.canopy import canopy_metrics
    from pyqsm_tpu_torch.models.skeleton import skeletonize

    for fn in (canopy_metrics, skeletonize):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(torch.zeros(4, 3), torch.ones(4, dtype=torch.bool))
    from pyqsm_tpu_torch.models.raycast import cast_scene
    from pyqsm_tpu_torch.ops.mesh import sphere_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        cast_scene(sphere_mesh([0.0, 0, 0], 1.0, device="cpu"))


def test_ray_generators_ask_for_the_card():
    """``pinhole_rays`` and ``parallel_rays`` given lists put their rays on
    the card (here: raise without one); ``device`` or a tensor input
    decides otherwise."""
    from pyqsm_tpu_torch.ops import raytrace as tr

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cam = ([0.0, 0.0, 5.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 60.0, 8, 6)
    box = ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 0.0, -1.0], 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.pinhole_rays(*cam)
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.parallel_rays(*box)
    assert tr.pinhole_rays(*cam, device="cpu")[1].device.type == "cpu"
    assert tr.parallel_rays(torch.zeros(3), *box[1:])[0].device.type == "cpu"


def test_build_grid3d_asks_for_the_card():
    """``build_grid3d`` (and so ``build_grid3d_two_level``) given numpy
    input builds its grid on the card (here: raises without one); a tensor
    input or ``device`` decides otherwise."""
    import numpy as np

    from pyqsm_tpu_torch.ops import grid3d as g3

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    t = np.array([[0, 1, 2], [0, 1, 3]], np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        g3.build_grid3d(v, t)
    with pytest.raises(RuntimeError, match="CUDA"):
        g3.build_grid3d_two_level(v.tolist(), t)
    assert g3.build_grid3d(torch.as_tensor(v), t).lo.device.type == "cpu"
    assert g3.build_grid3d(v, t, device="cpu").lo.device.type == "cpu"


def test_segmentation_and_joining_without_card_raise():
    """The new entry points given numpy input (or no device) ask for the
    card: without one they raise."""
    import numpy as np

    from pyqsm_tpu_torch.models import joining, segmentation
    from pyqsm_tpu_torch.pipeline import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pts = np.zeros((8, 3), np.float32)
    ones = np.ones(8, bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        segmentation.classify_wood_leaf(pts, ones, np.arange(4), np.zeros(4, np.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        joining.label_adjacency(pts, np.zeros(8, np.int32), ones)
    with pytest.raises(RuntimeError, match="CUDA"):
        joining.merge_labeled_scans([pts], [np.zeros(8, np.int32)], [ones])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.viz_main(["missing.npz"])


def test_qsm_entry_points_without_card_raise():
    from pyqsm_tpu_torch.models import qsm

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pts = torch.zeros(8, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        qsm.generate_qsm(pts, torch.ones(8, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="CUDA"):
        qsm.sphere_qsm_forest(pts[None], torch.ones(1, 8, dtype=torch.bool),
                              torch.zeros(1, 4, dtype=torch.int32),
                              torch.ones(1, 4, dtype=torch.bool), [0.3])


def _mesh_device_rank(mesh=None):
    return str(mesh.device)


def test_sharded_ranks_take_the_card_or_raise():
    """A rank launched with the default device asks for the card: without
    one it raises instead of computing on the CPU, and the launcher
    reports that rank's error; the CPU only when the caller names it."""
    from pyqsm_tpu_torch.parallel.mesh import launch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="rank 0 failed(.|\n)*CUDA"):
        launch(_mesh_device_rank, 1, "gloo", timeout=120)
    assert launch(_mesh_device_rank, 1, "gloo", device="cpu", timeout=120) == ["cpu"]


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; only band_apply picks the plain
    version, and only for CPU tensors (no launch counted)."""
    from pyqsm_tpu_torch.ops import band_matvec as bm

    b_w = torch.zeros(1, 2, 256, 768)
    x = torch.ones(1, 512, 3)
    with pytest.raises(ValueError):
        bm.band_matvec_cuda(b_w, x)
    before = bm.LAUNCHES
    assert torch.equal(bm.band_apply(b_w, x), torch.zeros(1, 512, 3))
    assert bm.LAUNCHES == before


def test_transpose_and_raycast_wrappers_refuse_cpu_tensors():
    """Kernels #2 and #3: the CUDA wrappers launch or raise; the
    dispatchers pick the plain versions for CPU tensors only, with no
    launch counted."""
    from pyqsm_tpu_torch.ops import band_matvec as bm
    from pyqsm_tpu_torch.ops import mt_raycast as mt

    b_w = torch.zeros(1, 2, 256, 768)
    x = torch.ones(1, 512, 3)
    with pytest.raises(ValueError):
        bm.band_matvec_t_cuda(b_w, x)
    before = bm.LAUNCHES_T
    assert torch.equal(bm.band_apply_t(b_w, x), torch.zeros(1, 512, 3))
    assert bm.LAUNCHES_T == before
    o = torch.zeros(4, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    verts = torch.zeros(3, 3)
    tris = torch.full((2, 3), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        mt.mt_raycast_cuda(o, d, verts, tris)
    with pytest.raises(TypeError):
        mt.mt_raycast_cuda(o, d, verts, tris.long())
    before = mt.LAUNCHES
    t, tri, uv, cnt = mt.mt_raycast(o, d, verts, tris)
    assert not torch.isfinite(t).any() and (tri == -1).all() and (cnt == 0).all()
    assert mt.LAUNCHES == before


@pytest.mark.parametrize("kind", ["point_cloud", "cylinders"])
def test_state_from_numpy_carries_containers(kind):
    """The JAX package's PointCloud and Cylinders, as dicts of numpy arrays,
    become the port's containers field by field."""
    import jax.numpy as jnp
    import numpy as np

    import pyqsm_tpu.state as js

    from pyqsm_tpu_torch.convert import state_from_numpy

    rng = np.random.default_rng(0)
    if kind == "point_cloud":
        src = js.PointCloud.create(rng.normal(size=(10, 3)).astype(np.float32), capacity=16)
    else:
        m = 6
        src = js.Cylinders(center=jnp.asarray(rng.normal(size=(m, 3)), jnp.float32),
                           axis=jnp.ones((m, 3)), height=jnp.ones(m), radius=jnp.full(m, 0.2),
                           branch_order=jnp.zeros(m, jnp.int32), parent=jnp.full(m, -1, jnp.int32),
                           mask=jnp.arange(m) < 4)
    arrays = {f: np.asarray(v) for f, v in vars(src).items() if v is not None}
    out = state_from_numpy(kind, arrays, device="cpu")
    for f, v in arrays.items():
        np.testing.assert_array_equal(getattr(out, f).numpy(), v)


def test_config_matches_jax_package():
    import pyqsm_tpu.config as jc

    import pyqsm_tpu_torch.config as tc
    from pyqsm_tpu_torch.convert import config_from_reference

    path = ROOT / "configs" / "default.toml"
    assert dataclasses.asdict(jc.load_config(path)) == dataclasses.asdict(tc.load_config(path))
    ref = jc.Config().replace(isolation=jc.IsolationConfig(max_dist=0.2, cycles=400))
    assert dataclasses.asdict(config_from_reference(dataclasses.asdict(ref))) == \
        dataclasses.asdict(ref)
