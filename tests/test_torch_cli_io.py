"""File IO, artifacts and the console entry points of the port against the
JAX package's on the CPU: a point-cloud file written by either package
reads back the same in the other (every format), artifacts cross both ways,
and each CLI ``main`` run on a tiny cloud writes the artifact its JAX
counterpart writes (the QSM walk with the JAX package's draws replayed).
Tolerances are stated at each comparison."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.io import artifacts as ja
from pyqsm_tpu.io import readers as jrd
from pyqsm_tpu.pipeline import cli as jcli
from pyqsm_tpu_torch.io import artifacts as ta
from pyqsm_tpu_torch.io import readers as trd
from pyqsm_tpu_torch.pipeline import cli as tcli
from tests.conftest import synthetic_branch, synthetic_tree
from tests.test_torch_qsm import assert_walks_equal, replay_jax_draws


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cloud(rng, n=500):
    pts = (rng.normal(size=(n, 3)) * [3.0, 2.0, 5.0] + [400.0, -20.0, 10.0]).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    intensity = rng.uniform(0, 1000, n).astype(np.float32)
    return pts, colors, intensity


def _write(mod, fmt, path, cloud):
    pts, colors, intensity = cloud
    if fmt == "las":
        mod.write_las(path, pts, colors=colors, intensity=intensity,
                      classification=np.arange(len(pts)) % 7)
    elif fmt == "pcd":
        mod.write_pcd(path, pts, colors=colors)
    elif fmt == "ply":
        mod.write_ply(path, pts, colors=colors)
    elif fmt == "xyz":
        mod.write_xyz(path, pts, intensity=intensity)
    else:
        mod.write_npz(path, pts, colors=colors, labels=np.arange(len(pts)) % 3)


@pytest.mark.parametrize("fmt", ["las", "pcd", "ply", "xyz", "npz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_point_cloud_files_cross_packages(tmp_path, fmt, writer):
    """Written by one package, read by both: every array equal; the two
    writers' files are byte for byte the same."""
    cloud = _cloud(np.random.default_rng(0))
    mods = {"jax": jrd, "port": trd}
    path = tmp_path / f"c_{writer}.{fmt}"
    _write(mods[writer], fmt, path, cloud)
    other = tmp_path / f"c_other.{fmt}"
    _write(mods["port" if writer == "jax" else "jax"], fmt, other, cloud)
    if fmt != "npz":  # zip members carry timestamps
        assert path.read_bytes() == other.read_bytes()
    a, b = jrd.read_point_cloud(path), trd.read_point_cloud(path)
    assert set(a) == set(b) and "points" in b
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_allclose(b.points, cloud[0], rtol=0, atol=1e-3)


def test_reader_dispatch_rejects_unknown_suffix(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        trd.read_point_cloud(tmp_path / "x.obj")


def _cyl_arrays(rng, m=6):
    return dict(center=rng.normal(size=(m, 3)).astype(np.float32),
                axis=rng.normal(size=(m, 3)).astype(np.float32),
                height=rng.uniform(0.1, 1, m).astype(np.float32),
                radius=rng.uniform(0.01, 0.3, m).astype(np.float32),
                branch_order=np.arange(m, dtype=np.int32) % 3,
                parent=np.arange(m, dtype=np.int32) - 1, mask=np.arange(m) < 4)


def test_artifacts_cross_packages(tmp_path):
    """Cylinders, clouds and metrics saved by one package load in the other
    field for field; ``format_table`` prints the same text."""
    import pyqsm_tpu.state as js
    from pyqsm_tpu_torch.convert import state_from_numpy
    from pyqsm_tpu_torch.state import PointCloud

    rng = np.random.default_rng(1)
    arrs = _cyl_arrays(rng)
    ta.save_cylinders(tmp_path / "t.npz", state_from_numpy("cylinders", arrs, device="cpu"))
    ja.save_cylinders(tmp_path / "j.npz", js.Cylinders(**{k: jnp.asarray(v)
                                                          for k, v in arrs.items()}))
    for path in ("t.npz", "j.npz"):
        cj = ja.load_cylinders(tmp_path / path)
        ct = ta.load_cylinders(tmp_path / path, device="cpu")
        for f in arrs:
            np.testing.assert_array_equal(getattr(ct, f).numpy(), arrs[f])
            np.testing.assert_array_equal(np.asarray(getattr(cj, f)), arrs[f])
        assert int(ct.count()) == int(cj.count()) == 4
        assert abs(float(ct.volume()) - float(cj.volume())) <= 1e-6 * float(cj.volume())

    pts = rng.normal(size=(10, 3)).astype(np.float32)
    pc = PointCloud.create(pts, capacity=12, labels=np.arange(10), device="cpu")
    ta.save_artifact(tmp_path / "pc.npz", pc)
    back = ja.load_artifact(tmp_path / "pc.npz")
    np.testing.assert_array_equal(np.asarray(back.points), pc.points.numpy())
    np.testing.assert_array_equal(np.asarray(back.labels), pc.labels.numpy())
    ja.save_artifact(tmp_path / "pcj.npz", js.PointCloud.create(pts, capacity=12))
    back_t = ta.load_artifact(tmp_path / "pcj.npz", device="cpu")
    np.testing.assert_array_equal(back_t.points.numpy()[:10], pts)
    assert int(back_t.count()) == 10

    metrics = {"a": np.float32(1.5), "b": torch.arange(3), "c": {"d": [np.int64(2), 3.25]}}
    ta.save_metrics(tmp_path / "m.json", metrics)
    assert ja.load_metrics(tmp_path / "m.json") == {"a": 1.5, "b": [0, 1, 2],
                                                    "c": {"d": [2, 3.25]}}
    rows = [{"tree": 1, "volume": 0.123456, "name": "a"}, {"tree": 22, "volume": 3.0}]
    assert ta.format_table(rows) == ja.format_table(rows)
    assert ta.format_table([]) == ja.format_table([]) == "(empty)"


@pytest.fixture(scope="module")
def tree_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    path = d / "tree.npz"
    trd.write_npz(path, synthetic_tree(n_per=800, seed=4))
    return path


def _run(main, argv):
    assert main(argv) == 0


def test_qsm_generation_main_sphere_equal(tree_file, tmp_path):
    """``pyqsm-qsm-generation`` (sphere walk, 64 steps): the cylinder files
    agree — counts, orders and parents equal; fits along z within 1e-5,
    fits on a front's principal axis within 1e-3 (``assert_walks_equal``
    says why)."""
    from pyqsm_tpu_torch.models.qsm import QSMResult

    out_j, out_t = tmp_path / "j", tmp_path / "t"
    out_j.mkdir()
    out_t.mkdir()
    argv = [str(tree_file), "--max-steps", "64"]
    _run(jcli.qsm_generation_main, argv + ["-o", str(out_j)])
    with pytest.MonkeyPatch.context() as mp:
        replay_jax_draws(mp)
        assert tcli.qsm_generation_main(argv + ["-o", str(out_t)], device="cpu") == 0
    cj = ja.load_cylinders(out_j / "tree_qsm.npz")
    ct = ta.load_cylinders(out_t / "tree_qsm.npz", device="cpu")
    assert int(cj.count()) >= 2
    none = torch.zeros(0)
    assert_walks_equal(QSMResult(cj, np.zeros(0), np.zeros(0), 0),
                       QSMResult(ct, none, none, 0), atol=1e-5, pca_atol=1e-3)


def test_qsm_generation_main_skeleton(tree_file, tmp_path):
    """The skeleton route: the port's file reads back in the JAX package;
    the count within ±1 of the JAX package's, as the skeletonize parity
    test holds it."""
    out_j, out_t = tmp_path / "j", tmp_path / "t"
    out_j.mkdir()
    out_t.mkdir()
    _run(jcli.qsm_generation_main, [str(tree_file), "--method", "skeleton", "-o", str(out_j)])
    assert tcli.qsm_generation_main([str(tree_file), "--method", "skeleton", "-o", str(out_t)],
                                    device="cpu") == 0
    cj = ja.load_cylinders(out_j / "tree_qsm.npz")
    ct = ja.load_cylinders(out_t / "tree_qsm.npz")
    assert abs(int(ct.count()) - int(cj.count())) <= 1 and int(ct.count()) >= 2
    assert (np.asarray(ct.radius)[np.asarray(ct.mask)] > 0).all()


def test_canopy_metrics_main(tree_file, tmp_path):
    """``pyqsm-canopy-metrics``: the port's file holds what its
    ``canopy_metrics`` returns for the file's cloud, bit for bit; against
    the JAX package's file, class counts, slice areas and the width at
    breast height are equal (within 1e-6 relative). The class areas are
    taken on positions after one contraction iteration, which the two
    packages hold to 5e-3 m (tests/test_torch_canopy.py compares them)."""
    from pyqsm_tpu_torch.models.canopy import canopy_metrics

    out_j, out_t = tmp_path / "j", tmp_path / "t"
    out_j.mkdir()
    out_t.mkdir()
    _run(jcli.canopy_metrics_main, [str(tree_file), "-o", str(out_j)])
    assert tcli.canopy_metrics_main([str(tree_file), "-o", str(out_t)], device="cpu") == 0
    a = json.loads((out_j / "tree_metrics.json").read_text())
    b = json.loads((out_t / "tree_metrics.json").read_text())
    pts = trd.read_point_cloud(tree_file).points.astype(np.float32)
    direct = ta._jsonify(canopy_metrics(pts, np.ones(len(pts), bool), device="cpu"))
    assert b == json.loads(json.dumps(direct))
    assert set(b) == set(a) and b["counts"] == a["counts"]
    assert set(b["classes"]) == set(a["classes"])
    for name in a["classes"]:
        assert len(b["classes"][name]["areas"]) == len(a["classes"][name]["areas"]), name
    np.testing.assert_allclose(b["slice_areas"], a["slice_areas"], rtol=1e-6)
    np.testing.assert_allclose(b["width_at_bh"], a["width_at_bh"], rtol=1e-6)


def test_raycast_main_close(tmp_path):
    """``pyqsm-raycast`` on a small canopy cloud: the density field rounds
    as XLA's fused blur does, so the meshes have equal triangle counts;
    hit fractions and exposed areas within 1 % relative."""
    rng = np.random.default_rng(3)
    pts = (rng.normal(size=(3000, 3)) * [1.2, 1.2, 0.8] + [0, 0, 6.0]).astype(np.float32)
    path = tmp_path / "canopy.xyz"
    trd.write_xyz(path, pts)
    out_j, out_t = tmp_path / "j", tmp_path / "t"
    out_j.mkdir()
    out_t.mkdir()
    argv = [str(path), "--mesh-voxel", "0.3", "--elevations", "45", "90"]
    _run(jcli.raycast_main, argv + ["-o", str(out_j)])
    assert tcli.raycast_main(argv + ["-o", str(out_t)], device="cpu") == 0
    a = json.loads((out_j / "canopy_exposure.json").read_text())
    b = json.loads((out_t / "canopy_exposure.json").read_text())
    assert b["n_triangles"] == a["n_triangles"]
    assert a["n_triangles"] > 1000
    assert set(b["sun_sweep"]) == set(a["sun_sweep"]) == {"45.0", "90.0"}
    for got, ref in [(b["camera"], a["camera"])] + [(b["sun_sweep"][k], a["sun_sweep"][k])
                                                     for k in a["sun_sweep"]]:
        for key in ("hit_fraction", "surface_area_3d", "surface_area_2d"):
            assert abs(got[key] - ref[key]) <= 1e-2 * ref[key] and ref[key] > 0, key


def test_tree_isolation_main_equal(tmp_path):
    """``pyqsm-tree-isolation`` on two trunks: labels and claim order
    equal."""
    pts = np.concatenate([synthetic_branch(1500, radius=0.3, length=5.0, seed=1),
                          synthetic_branch(1500, radius=0.2, length=5.0, base=[4.0, 0, 0],
                                           seed=2)])
    path = tmp_path / "plot.ply"
    trd.write_ply(path, pts)
    out_j, out_t = tmp_path / "j", tmp_path / "t"
    out_j.mkdir()
    out_t.mkdir()
    argv = [str(path), "--base-min-points", "15", "--low-pctile", "5", "--cycles", "200"]
    _run(jcli.tree_isolation_main, argv + ["-o", str(out_j)])
    assert tcli.tree_isolation_main(argv + ["-o", str(out_t)], device="cpu") == 0
    a, b = np.load(out_j / "plot_trees.npz"), np.load(out_t / "plot_trees.npz")
    np.testing.assert_array_equal(b["points"], a["points"])
    np.testing.assert_array_equal(b["labels"], a["labels"])
    np.testing.assert_array_equal(b["order"], a["order"])
    assert len(np.unique(b["labels"][b["labels"] >= 0])) == 2


def test_mains_default_to_the_card():
    """Every ``main`` asks for the card unless told otherwise: without one
    it raises before reading its input."""
    import inspect

    for main in (tcli.tree_isolation_main, tcli.qsm_generation_main, tcli.canopy_metrics_main,
                 tcli.raycast_main):
        assert inspect.signature(main).parameters["device"].default == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                main(["missing.npz"])


def test_module_runs_tree_isolation(tmp_path):
    """``python -m pyqsm_tpu_torch.pipeline.cli --help`` is the tree
    isolation command, as the JAX package's module is."""
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-m", "pyqsm_tpu_torch.pipeline.cli", "--help"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "pyqsm-tree-isolation" in out.stdout
