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
            "parallel/mesh.py", "parallel/growth.py"]


def test_import_scan_covers_every_port_module():
    scanned = {str(p.relative_to(ROOT / "pyqsm_tpu_torch")) for p in PORT_FILES[:-1]}
    assert not set(REQUIRED) - scanned


def test_every_kernel_source_is_registered_for_the_build():
    """Each ``csrc/*.cu`` source has one ``CudaLib`` in the build registry,
    so the first use of any kernel builds all of them together."""
    from pyqsm_tpu_torch.ops import band_matvec, cuda_build, mt_raycast  # noqa: F401

    sources = sorted(p.name for p in (ROOT / "pyqsm_tpu_torch" / "csrc").glob("*.cu"))
    assert sorted(lib.source.name for lib in cuda_build.REGISTRY) == sources
    assert "band_matvec_bf16.cu" in sources


def _entry_points():
    from pyqsm_tpu_torch import convert, state
    from pyqsm_tpu_torch.models import isolation, plot_pipeline, raycast, skeleton
    from pyqsm_tpu_torch.parallel import mesh

    return [plot_pipeline.process_plot, isolation.build_trees, skeleton.extract_skeleton_batch,
            convert.state_from_numpy, convert.mesh_from_numpy, raycast.cast_scene,
            raycast.sun_exposure, raycast.sun_sweep, raycast.raycast_to_pcd,
            raycast.sparse_cast_with_intersections, raycast.mri_slices,
            mesh.make_mesh, mesh.tree_points_mesh, mesh.launch, state.PointCloud.create]


@pytest.mark.parametrize("fn", range(15))
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
    from pyqsm_tpu_torch.models.raycast import cast_scene
    from pyqsm_tpu_torch.ops.mesh import sphere_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        cast_scene(sphere_mesh([0.0, 0, 0], 1.0, device="cpu"))


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
