"""Native ingestion, the batch driver, the utilities and ``viz_main`` of the
port against the JAX package's on the CPU: the port builds its own copy of
the C++ parser and voxelizer (``csrc/pointio.cpp``) and its rows and
centroids equal the JAX package's and the numpy path's; the driver's
discovery, error capture, staged resume (checkpoints read by both
packages) and pytree checkpoints; the viewer's HTML byte for byte."""

import base64
import json
import logging
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.io import native as jnat
from pyqsm_tpu.pipeline import cli as jcli
from pyqsm_tpu.pipeline import driver as jdr
from pyqsm_tpu.utils import webviz as jweb
from pyqsm_tpu_torch.io import native as tnat
from pyqsm_tpu_torch.io import readers as trd
from pyqsm_tpu_torch.pipeline import cli as tcli
from pyqsm_tpu_torch.pipeline import driver as tdr
from pyqsm_tpu_torch.state import Cylinders
from pyqsm_tpu_torch.utils import timing as ttime
from pyqsm_tpu_torch.utils import webviz as tweb
from pyqsm_tpu_torch.utils.logging import get_logger


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _text(rng, n=3000, cols=3):
    pts = rng.uniform(-50, 50, (n, cols))
    lines = [" ".join(f"{v:.5f}" for v in r) for r in pts]
    lines[7] = "# a comment"
    lines[11] = "1.0 2.0"  # too few columns: dropped
    return ("\n".join(lines) + "\n").encode()


def test_native_build_is_the_ports_own():
    """The port builds ``csrc/pointio.cpp`` into its git-ignored
    ``_build/`` (hash-named), never loading the JAX package's library."""
    assert tnat.native_available()
    path = tnat.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "pyqsm_tpu_torch"
    assert tnat.SOURCE.parent.parent == path.parent.parent and tnat.SOURCE.parent.name == "csrc"


def test_parse_text_points_equal():
    """Native rows equal the JAX package's native rows and the numpy path's,
    bit for bit (comments and short rows dropped)."""
    data = _text(np.random.default_rng(0), cols=4)
    ours = tnat.parse_text_points(data, 4)
    np.testing.assert_array_equal(ours, jnat.parse_text_points(data, 4))
    np.testing.assert_array_equal(ours, tnat._parse_numpy(data, 4))
    assert len(ours) == 2998


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    rng = np.random.default_rng(1)
    pts = (rng.normal(size=(6000, 3)) * [2, 2, 4]).astype(np.float32)
    path = tmp_path_factory.mktemp("scan") / "plot_1.xyz"
    trd.write_xyz(path, pts)
    return path


def _set(a):
    return a[np.lexsort(a.T[::-1])]


def test_read_xyz_stream_and_voxelizer_equal(scan):
    """``read_xyz_stream`` with 4 KiB batches (rows cross the batch
    boundary): the rows equal the JAX package's stream and ``read_xyz``
    bit for bit; the streamed voxel centroids at 0.2 m equal the JAX
    package's (same order) and, as a set, the numpy path's."""
    ours = list(tnat.read_xyz_stream(scan, batch_bytes=4096))
    assert len(ours) > 10
    rows = np.concatenate(ours)
    np.testing.assert_array_equal(rows, np.concatenate(list(jnat.read_xyz_stream(
        scan, batch_bytes=4096))))
    np.testing.assert_array_equal(rows, trd.read_xyz(scan).points.astype(np.float64))
    cent = list(tnat.read_xyz_stream(scan, batch_bytes=4096, voxel=0.2))
    assert len(cent) == 1
    np.testing.assert_array_equal(cent[0], list(jnat.read_xyz_stream(
        scan, batch_bytes=4096, voxel=0.2))[0])
    vox = tnat.StreamingVoxelizer(0.2, table_size=1 << 16)
    vox._lib = None  # the numpy path
    for batch in ours:
        vox.add(batch)
    np.testing.assert_array_equal(_set(vox.centroids()), _set(cent[0]))


def test_get_files_by_seed_equal(tmp_path):
    for name in ["seed27_cloud.npz", "seed27_shift.npz", "seed32_cloud.xyz", "notes.txt",
                 "seedx.npz"]:
        (tmp_path / name).write_bytes(b"")
    ours = tdr.get_files_by_seed([tmp_path, tmp_path / "missing"], seed_pattern=r"seed(\d+)")
    assert ours == jdr.get_files_by_seed([tmp_path], seed_pattern=r"seed(\d+)")
    assert set(ours) == {"27", "32"} and len(ours["27"]) == 2


@pytest.mark.parametrize("n_workers", [1, 2])
def test_loop_over_files_collects_errors(tmp_path, n_workers):
    rng = np.random.default_rng(2)
    for s in (1, 2, 3):
        trd.write_xyz(tmp_path / f"plot_{s}.xyz", rng.uniform(0, 1, (40 + s, 3)))

    def fn(seed, data):
        if seed == "2":
            raise RuntimeError("boom")
        return sum(len(v) for v in data.values())

    loaders = {"plot": lambda f: np.concatenate(list(tnat.read_xyz_stream(f)))}
    results, errors = tdr.loop_over_files(fn, [tmp_path], r"plot_(\d+)", loaders=loaders,
                                          skip_seeds=("9",), n_workers=n_workers)
    assert results == {"1": 41, "3": 43}
    assert set(errors) == {"2"} and "RuntimeError: boom" in errors["2"]
    assert "Traceback" in errors["2"]


def _stages(calls):
    def a(state):
        calls.append("a")
        return {"x": torch.arange(5), "y": np.linspace(0, 1, 4, dtype=np.float32), "tag": "a"}

    def b(state):
        calls.append("b")
        return {"x": torch.as_tensor(state["x"]) * 2, "y": np.asarray(state["y"]) + 1}

    return a, b


def test_staged_pipeline_resume_across_packages(tmp_path):
    """The port's pipeline resumes from its own checkpoint and from one the
    JAX package wrote, and the JAX package resumes from the port's: every
    array equal."""
    calls = []
    a, b = _stages(calls)
    pipe = tdr.StagedPipeline(tmp_path / "t", seed="s").add_stage("a", a).add_stage("b", b)
    full = pipe.run()
    assert calls == ["a", "b"] and isinstance(full["x"], torch.Tensor)
    ck = dict(np.load(tmp_path / "t" / "s_a.npz"))
    assert set(ck) == {"x", "y"}
    calls.clear()
    resumed = pipe.run(start="b")
    assert calls == ["b"]
    for k in ("x", "y"):
        np.testing.assert_array_equal(np.asarray(resumed[k]), np.asarray(full[k]))
    jpipe = jdr.StagedPipeline(tmp_path / "t", seed="s").add_stage(
        "a", lambda s: {}).add_stage("b", lambda s: {"x": s["x"] * 2, "y": s["y"] + 1})
    jout = jpipe.run(start="b")
    for k in ("x", "y"):
        np.testing.assert_array_equal(np.asarray(jout[k]), np.asarray(full[k]))
    jdr.StagedPipeline(tmp_path / "j", seed="s").add_stage(
        "a", lambda s: {"x": jnp.arange(5), "y": jnp.linspace(0, 1, 4)}).add_stage(
        "b", lambda s: s).run()
    (tmp_path / "j" / "s_b.npz").unlink()
    calls.clear()
    port_on_jax = tdr.StagedPipeline(tmp_path / "j", seed="s").add_stage(
        "a", a).add_stage("b", b).run(start="b")
    assert calls == ["b"]
    np.testing.assert_array_equal(port_on_jax["x"].numpy(), np.arange(5) * 2)
    with pytest.raises(ValueError):
        pipe.run(start="zzz")
    with pytest.raises(FileNotFoundError):
        tdr.StagedPipeline(tmp_path / "none").add_stage("a", a).add_stage("b", b).run(start="b")


def test_checkpoint_roundtrip(tmp_path):
    """``save_checkpoint``/``load_checkpoint``: dicts, lists and tuples of
    tensors, numpy arrays and scalars come back equal, numpy as numpy;
    ``template=`` puts tensors on the template's devices."""
    tree = {"pts": torch.arange(6.0).reshape(2, 3), "n": 2,
            "parts": [np.arange(3, dtype=np.int32), (torch.ones(2, dtype=torch.bool), 0.5)]}
    tdr.save_checkpoint(tmp_path / "ck" / "tree.pt", tree)
    for back in (tdr.load_checkpoint(tmp_path / "ck" / "tree.pt"),
                 tdr.load_checkpoint(tmp_path / "ck" / "tree.pt", template=tree)):
        assert torch.equal(back["pts"], tree["pts"]) and back["n"] == 2
        assert isinstance(back["parts"][0], np.ndarray) and back["parts"][0].dtype == np.int32
        np.testing.assert_array_equal(back["parts"][0], tree["parts"][0])
        assert isinstance(back["parts"][1], tuple) and back["parts"][1][1] == 0.5
        assert back["pts"].device.type == "cpu"


def test_timer_and_logging(caplog):
    t = ttime.Timer()
    with t.stage("load"):
        torch.ones(3).sum()
    with t.stage("load", sync=torch.ones(1)):
        pass
    assert set(t.stages) == {"load"} and t.stages["load"] >= 0
    assert "TOTAL" in t.report() and "load" in t.report()
    held = {}
    with caplog.at_level(logging.INFO, logger="pyqsm_tpu_torch.calc"):
        with ttime.stage_timer("step", held):
            pass
    assert "step" in held and "step:" in caplog.text
    assert get_logger("calc").name == "pyqsm_tpu_torch.calc"


def _viewer_inputs():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    cyl = dict(center=rng.normal(size=(4, 3)).astype(np.float32),
               axis=np.tile(np.array([0, 0, 1], np.float32), (4, 1)),
               height=np.full(4, 1.5, np.float32), radius=np.full(4, 0.2, np.float32),
               branch_order=np.zeros(4, np.int32), parent=np.full(4, -1, np.int32),
               mask=np.array([True, True, False, True]))
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    tris = rng.integers(0, 30, (20, 3)).astype(np.int32)
    tris[3] = -1
    return pts, cyl, verts, tris


@pytest.mark.parametrize("case", ["labels", "colors", "mesh_cylinders", "subsampled"])
def test_export_viewer_html_equal(tmp_path, case):
    pts, cyl, verts, tris = _viewer_inputs()
    kw = {}
    if case == "labels":
        kw = dict(points=pts, labels=np.arange(500) % 5 - 1)
    elif case == "colors":
        kw = dict(points=pts, colors=np.random.default_rng(4).uniform(0, 1, (500, 3)))
    elif case == "mesh_cylinders":
        kw = dict(mesh_vertices=verts, mesh_triangles=tris)
    else:
        kw = dict(points=pts, max_points=120)
    ref = jweb.export_viewer(tmp_path / "j.html", title="t", **kw)
    if case == "mesh_cylinders":
        from pyqsm_tpu.state import Cylinders as JCylinders

        ref = jweb.export_viewer(tmp_path / "j.html", title="t",
                                 cylinders=JCylinders(**{k: jnp.asarray(v) for k, v in
                                                         cyl.items()}), **kw)
        kw["cylinders"] = Cylinders(**{k: torch.as_tensor(v) for k, v in cyl.items()})
    else:
        kw = {k: (torch.as_tensor(np.asarray(v)) if k in ("points", "labels") else v)
              for k, v in kw.items()}
    ours = tweb.export_viewer(tmp_path / "t.html", title="t", **kw)
    same = ours.read_text() == ref.read_text()
    assert same
    with pytest.raises(ValueError):
        tweb.export_viewer(tmp_path / "none.html")


def _layers(html):
    return json.loads(re.search(r"const LAYERS=(\[.*?\]), CENTER=", html, re.S).group(1))


def test_viz_main_equal(tmp_path, capsys):
    """``pyqsm-viz`` on a tiny cloud with an isolation label artifact and a
    0.3 m mesh: the same page as the JAX package's command — the point
    layer byte for byte, the mesh layer with the same triangle count (the
    density field is equal bit for bit) and its vertices within 1e-5 m
    (XLA fuses the marching tetrahedra's edge interpolation into a
    multiply-add)."""
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(1500, 3)) * [1.0, 1.0, 0.7] + [0, 0, 5]).astype(np.float32)
    cloud = tmp_path / "tree.npz"
    trd.write_npz(cloud, pts)
    lab = tmp_path / "tree_trees.npz"
    np.savez(lab, labels=(np.arange(1500) % 4).astype(np.int32))
    out_j, out_t = tmp_path / "j", tmp_path / "t"
    out_j.mkdir()
    out_t.mkdir()
    argv = [str(cloud), "--labels", str(lab), "--mesh-voxel", "0.3"]
    assert jcli.viz_main(argv + ["-o", str(out_j)]) == 0
    capsys.readouterr()
    assert tcli.viz_main(argv + ["-o", str(out_t)], device="cpu") == 0
    assert "(1,500 points)" in capsys.readouterr().out
    a = _layers((out_j / "tree_viewer.html").read_text())
    b = _layers((out_t / "tree_viewer.html").read_text())
    assert [x["kind"] for x in b] == ["points", "mesh"] == [x["kind"] for x in a]
    assert b[0] == a[0] and b[0]["n"] == 1500
    assert b[1]["n"] == a[1]["n"] > 300
    va, vb = (np.frombuffer(base64.b64decode(x[1]["pos"]), np.float32) for x in (a, b))
    np.testing.assert_allclose(vb, va, rtol=0, atol=1e-5)
