"""The port's host utilities (``utils/viz.py``, ``utils/tbevents.py``,
``utils/laplacian_oracle.py``) against the JAX package's on the CPU: the
plasma table against matplotlib bit for bit, colours, PLY bytes, NPZ
dumps and histogram counts equal, snapshots and GIFs written, TensorBoard
events readable (tests/test_tbevents.py's three cases, with the port's
``build_trees(observer=)``), the oracle's outputs equal, and the port's
``extract_skeleton`` against the tufted oracle under
tests/test_laplacian_oracle.py's bounds.

matplotlib, imageio and TensorFlow exist on this CPU only: these paths do
not run on the card's machine."""

import glob

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.utils import laplacian_oracle as jlo
from pyqsm_tpu.utils import viz as jv
from pyqsm_tpu_torch.utils import laplacian_oracle as tlo
from pyqsm_tpu_torch.utils import viz as tv


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bits_eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8), np.atleast_1d(b).view(np.uint8))


def test_plasma_table_is_matplotlibs():
    import matplotlib

    np.testing.assert_array_equal(tv._plasma_lut(),
                                  np.asarray(matplotlib.colormaps["plasma"].colors))


@pytest.mark.parametrize("case", ["random", "ties_and_nan", "constant", "ints"])
def test_color_continuous_map_equals_matplotlib(case):
    """The table lookup gives matplotlib's colours bit for bit (the JAX
    package's ``color_continuous_map``), at the ends, on NaN and on a
    constant input; other maps still go through matplotlib."""
    rng = np.random.default_rng(1)
    v = {"random": rng.normal(size=5000),
         "ties_and_nan": np.concatenate([np.linspace(0, 1, 257), [np.nan, np.inf, -np.inf]]),
         "constant": np.full(40, 2.5),
         "ints": rng.integers(0, 300, 3000).astype(np.float32)}[case]
    _bits_eq(tv.color_continuous_map(v), jv.color_continuous_map(v))
    _bits_eq(tv.color_continuous_map(torch.as_tensor(v)), jv.color_continuous_map(v))
    if case == "random":
        _bits_eq(tv.color_continuous_map(v, "viridis"), jv.color_continuous_map(v, "viridis"))


def test_export_colored_cloud_bytes_equal(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    vals, mask = pts[:, 2] * 3, rng.uniform(size=700) < 0.7
    cols = rng.uniform(size=(700, 3)).astype(np.float32)
    for name, kw in (("values", dict(values=vals, mask=mask)), ("colors", dict(colors=cols)),
                     ("plain", {})):
        jv.export_colored_cloud(tmp_path / f"j_{name}.ply", pts, **kw)
        tv.export_colored_cloud(tmp_path / f"t_{name}.ply", torch.as_tensor(pts),
                                **{k: torch.as_tensor(v) for k, v in kw.items()})
        assert (tmp_path / f"t_{name}.ply").read_bytes() == (tmp_path / f"j_{name}.ply").read_bytes()


def test_step_logger_npz_equal(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    lab = (pts[:, 0] > 0).astype(np.int32)
    j, t = jv.StepLogger(tmp_path, "j"), tv.StepLogger(tmp_path, "t")
    for step in (0, 7):
        pj = j.log(step, pts * (1 + step), mask=lab > 0, labels=lab, loss=0.5)
        pt = t.log(step, torch.as_tensor(pts * (1 + step)), mask=torch.as_tensor(lab > 0),
                   labels=torch.as_tensor(lab), loss=0.5)
        assert pt.name == pj.name
        a, b = np.load(pt), np.load(pj)
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            _bits_eq(a[f], b[f])
    assert t.steps == j.steps == [0, 7]


def test_nn_distance_histogram_equal():
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 2, (1500, 3)).astype(np.float32)
    mask = rng.uniform(size=1500) < 0.9
    jc, je = jv.nn_distance_histogram(pts, mask=mask, bins=30)
    tc, te = tv.nn_distance_histogram(torch.as_tensor(pts), mask=torch.as_tensor(mask), bins=30)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(te, je)


def test_snapshot_and_gif_written(tmp_path):
    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.normal(size=(300, 3)).astype(np.float32))
    tv.scatter_snapshot(tmp_path / "s.png", a, values=a[:, 2], mask=a[:, 0] > -1)
    assert (tmp_path / "s.png").read_bytes()[:4] == b"\x89PNG"
    p = tv.rotating_compare_gif(tmp_path / "r.gif", a, a * 0.5, values_a=a[:, 2], steps=4,
                                figsize=2.0)
    import imageio.v2 as imageio

    assert p.read_bytes()[:3] == b"GIF" and len(imageio.mimread(p)) == 4


# -- TensorBoard (tests/test_tbevents.py, mirrored) --------------------------


def _mesh_tensors(logdir):
    from tensorboard.backend.event_processing import event_file_loader

    tags, n_mesh = set(), 0
    for f in glob.glob(str(logdir) + "/events.out.tfevents.*"):
        for ev in event_file_loader.EventFileLoader(f).Load():
            if ev.HasField("summary"):
                for v in ev.summary.value:
                    tags.add(v.tag)
                    if v.metadata.plugin_data.plugin_name == "mesh":
                        n_mesh += 1
    return tags, n_mesh


def test_cloud_and_mesh_events_openable(tmp_path):
    pytest.importorskip("tensorflow")
    from pyqsm_tpu_torch.ops.mesh import sphere_mesh
    from pyqsm_tpu_torch.utils.tbevents import TBMeshWriter

    rng = np.random.default_rng(0)
    w = TBMeshWriter(tmp_path, max_points=2000)
    pts = torch.as_tensor(rng.normal(0, 1, (5000, 3)).astype(np.float32))
    w.log_cloud("cloud", pts, step=0, labels=(pts[:, 0] > 0).to(torch.int32))
    w.log_cloud("cloud", pts, step=1, values=pts[:, 2])
    m = sphere_mesh([0.0, 0.0, 0.0], 1.0, n_lat=6, n_lon=8, device="cpu")
    w.log_mesh("mesh", m.vertices, m.triangles, step=0)
    w.flush()
    w.close()
    tags, n_mesh = _mesh_tensors(tmp_path)
    assert "cloud_VERTEX" in tags and "cloud_COLOR" in tags
    assert "mesh_VERTEX" in tags and "mesh_FACE" in tags
    assert n_mesh >= 5


def test_steplogger_conversion_roundtrip(tmp_path):
    pytest.importorskip("tensorflow")
    from pyqsm_tpu_torch.utils.tbevents import steplog_to_tb

    rng = np.random.default_rng(0)
    sl = tv.StepLogger(tmp_path / "sl", name="run")
    pts = rng.normal(0, 1, (1000, 3)).astype(np.float32)
    lab = (pts[:, 1] > 0).astype(np.int32)
    sl.log(0, pts, mask=np.ones(1000, bool), labels=lab)
    sl.log(7, pts * 1.1, labels=lab)
    assert steplog_to_tb(tmp_path / "sl" / "run", tmp_path / "tb") == 2
    _, n_mesh = _mesh_tensors(tmp_path / "tb")
    assert n_mesh >= 4


def test_growth_observer_streams_from_build_trees(tmp_path):
    """The observer plugs into the port's region-growing loop and emits
    one cloud per observed chunk (tests/test_tbevents.py's two trees)."""
    pytest.importorskip("tensorflow")
    from pyqsm_tpu_torch.config import IsolationConfig
    from pyqsm_tpu_torch.models.isolation import build_trees
    from pyqsm_tpu_torch.utils.tbevents import TBMeshWriter, growth_observer

    rng = np.random.default_rng(0)

    def tree(cx, n_per=2000):
        z = rng.uniform(0, 6, n_per)
        th = rng.uniform(0, 2 * np.pi, n_per)
        r = 0.25 + rng.normal(0, 0.01, n_per)
        trunk = np.stack([cx + r * np.cos(th), r * np.sin(th), z], 1)
        canopy = rng.normal([cx, 0, 7.0], [1.5, 1.5, 1.0], (n_per // 2, 3))
        return np.concatenate([trunk, canopy])

    pts = np.concatenate([tree(0), tree(8)]).astype(np.float32)
    cfg = IsolationConfig(base_min_points=50, low_pctile=5.0, max_dist=0.35, cycles=60,
                          min_frontier=2)
    w = TBMeshWriter(tmp_path, max_points=5000)
    res = build_trees(torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool), cfg,
                      observer=growth_observer(w, tag="g"), observe_every=10, device="cpu")
    w.close()
    lab = res.labels.numpy()
    assert len(np.unique(lab[lab >= 0])) == 2
    tags, n_mesh = _mesh_tensors(tmp_path)
    assert "g_VERTEX" in tags and n_mesh >= 2
    assert any(t.startswith("g/assigned") for t in tags)


# -- the Laplacian oracle ----------------------------------------------------


def _branch(rng, n=2000, radius=0.3, length=4.0, noise=0.005):
    """tests/test_laplacian_oracle.py's branch along z."""
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(0, length, n)
    r = radius + rng.normal(0, noise, n)
    a = np.array([0.0, 0.0, 1.0])
    u = np.cross(a, [0.0, 0.0, 1.0] if abs(a[2]) <= 0.9 else [1.0, 0, 0])
    u /= np.linalg.norm(u)
    v = np.cross(a, u)
    return (z[:, None] * a + (r * np.cos(th))[:, None] * u
            + (r * np.sin(th))[:, None] * v).astype(np.float32)


def test_oracle_outputs_equal():
    """The port's copy of the oracle gives the JAX package's operators,
    contraction and chamfer distance (host numpy and scipy in both)."""
    pts = _branch(np.random.default_rng(6), n=400)
    for name in ("tufted_style_laplacian", "heat_kernel_laplacian_host"):
        (La, ma), (Lb, mb) = getattr(tlo, name)(torch.as_tensor(pts), 12), getattr(jlo, name)(pts, 12)
        assert (La != Lb).nnz == 0
        _bits_eq(ma, mb)
    ca, ia, ra = tlo.contract_exact(pts, lambda p: tlo.heat_kernel_laplacian_host(p, 12), max_iter=3)
    cb, ib, rb = jlo.contract_exact(pts, lambda p: jlo.heat_kernel_laplacian_host(p, 12), max_iter=3)
    _bits_eq(ca, cb)
    assert (ia, ra) == (ib, rb)
    assert tlo.chamfer(ca, pts) == jlo.chamfer(cb, pts)


def test_port_contraction_vs_tufted_oracle():
    """tests/test_laplacian_oracle.py:65's bounds on the port's
    ``extract_skeleton`` against the exact tufted contraction."""
    from pyqsm_tpu_torch.models.skeleton import extract_skeleton

    pts = _branch(np.random.default_rng(0))
    oracle, _, _ = tlo.contract_exact(pts, lambda p: tlo.tufted_style_laplacian(p, 20))
    res = extract_skeleton(torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool),
                           device="cpu")
    mine = res.contracted.numpy()
    assert np.median(np.linalg.norm(oracle[:, :2], axis=1)) < 0.02
    assert np.median(np.linalg.norm(mine[:, :2], axis=1)) < 0.03
    z_oracle = oracle[:, 2].max() - oracle[:, 2].min()
    assert mine[:, 2].max() - mine[:, 2].min() >= 0.8 * z_oracle
    assert tlo.chamfer(mine, oracle) < 0.15


def test_jax_mesh_summary_tags_unchanged():
    """The port's writer and the JAX package's emit the same tags for the
    same cloud (the event files differ only in wall times)."""
    pytest.importorskip("tensorflow")
    import tempfile

    from pyqsm_tpu.utils.tbevents import TBMeshWriter as JW
    from pyqsm_tpu_torch.utils.tbevents import TBMeshWriter as TW

    pts = np.random.default_rng(9).normal(size=(300, 3)).astype(np.float32)
    tags = []
    for W, x in ((JW, jnp.asarray(pts)), (TW, torch.as_tensor(pts))):
        with tempfile.TemporaryDirectory() as d:
            w = W(d)
            w.log_cloud("c", x, step=3, values=x[:, 0])
            w.log_scalar("s", 1.5, step=3)
            w.close()
            tags.append(_mesh_tensors(d))
    assert tags[0] == tags[1]
