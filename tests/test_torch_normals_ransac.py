"""Normals, the stem filter, RANSAC shape fits and the Rodrigues rotation of
the port against the JAX package on the CPU, with the JAX package's
hypothesis draws replayed. Masks, inlier sets and signs are equal; the
float tolerances are stated at each comparison. Inputs are numpy arrays
from a seed, the same for both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.ops import geometry as jg
from pyqsm_tpu.ops import normals as jn
from pyqsm_tpu.ops import ransac as jr
from pyqsm_tpu_torch.ops import geometry as tg
from pyqsm_tpu_torch.ops import normals as tn
from pyqsm_tpu_torch.ops import ransac as tr
from tests.conftest import synthetic_branch
from tests.test_torch_qsm import JaxStream, jax_hypothesis_rows


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture
def jax_rows(monkeypatch):
    """The fits draw the JAX package's hypothesis rows (ransac.py:76) from
    the ``JaxStream`` they are given."""
    monkeypatch.setattr(tr, "hypothesis_rows", jax_hypothesis_rows)


def _plane(rng):
    return np.concatenate([rng.uniform(-1, 1, (800, 2)), rng.normal(0, 0.002, (800, 1))],
                          1).astype(np.float32)


@pytest.mark.parametrize("scene", ["plane", "cylinder", "trunk_and_ground"])
def test_estimate_normals_and_stem_filter_equal(scene):
    """Normals within 1e-5 with equal signs, angles within 1e-4 degrees,
    the stem filter's mask equal."""
    rng = np.random.default_rng(0)
    if scene == "plane":
        pts, k = _plane(rng), 12
    elif scene == "cylinder":
        pts, k = synthetic_branch(2000), 16
    else:
        ground = np.concatenate([rng.uniform(-2, 2, (1000, 2)), rng.normal(0, 0.01, (1000, 1))],
                                1).astype(np.float32)
        pts, k = np.concatenate([synthetic_branch(2000, seed=2), ground]), 30
    mask = rng.uniform(size=len(pts)) < 0.95
    nj = np.asarray(jn.estimate_normals(jnp.asarray(pts), jnp.asarray(mask), k=k))
    nt = tn.estimate_normals(_t(pts), _t(mask), k=k).numpy()
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.sign(nt), np.sign(nj))
    np.testing.assert_allclose(tn.angle_to_horizontal(_t(nj)).numpy(),
                               np.asarray(jn.angle_to_horizontal(jnp.asarray(nj))),
                               rtol=0, atol=1e-4)
    for cut in (10.0, 30.0):
        np.testing.assert_array_equal(
            tn.filter_by_norm(_t(nt), _t(mask), cut).numpy(),
            np.asarray(jn.filter_by_norm(jnp.asarray(nj), jnp.asarray(mask), cut)))


def _circle(rng, n=300, outliers=30):
    th = rng.uniform(0, 2 * np.pi, n)
    r = 0.3 + rng.normal(0, 0.01, n)
    c = rng.uniform(-0.3, 0.3, 2)
    pts = np.stack([c[0] + r * np.cos(th), c[1] + r * np.sin(th)], 1).astype(np.float32)
    pts[:outliers] = rng.uniform(-1, 1, (outliers, 2))
    return pts, rng.uniform(size=n) < 0.9


@pytest.mark.parametrize("seed", range(4))
def test_ransac_circle_equal(jax_rows, seed):
    """Given the JAX package's hypotheses: the same winner, inliers equal,
    centre and radius within 1e-6 m (the Kåsa refinement: float32 about
    the origin in the JAX package, float64 about the inliers' centroid in
    the port)."""
    rng = np.random.default_rng(seed)
    pts, m = _circle(rng)
    key = jax.random.PRNGKey(seed)
    kw = dict(threshold=0.04, n_hypotheses=256, max_radius=0.6, min_radius=0.01)
    fj = jr.ransac_circle_2d(jnp.asarray(pts), jnp.asarray(m), key, **kw)
    ft = tr.ransac_circle_2d(_t(pts), _t(m), JaxStream(key), **kw)
    np.testing.assert_array_equal(ft.inliers.numpy(), np.asarray(fj.inliers))
    assert int(ft.n_inliers) == int(fj.n_inliers) and bool(ft.ok) == bool(fj.ok)
    np.testing.assert_allclose(ft.center.numpy(), np.asarray(fj.center), rtol=0, atol=1e-6)
    assert abs(float(ft.radius) - float(fj.radius)) <= 1e-6


@pytest.mark.parametrize("gates", [(0.05, 0.1), (2.0, 3.0)])
def test_ransac_radius_gates_equal(jax_rows, gates):
    """Gates that reject most hypotheses: the same winner and ``ok``,
    inliers equal. The winners are short arcs of the 0.3 m ring, on which
    the JAX package's float32 Kåsa refinement is ill-conditioned: centres
    within 1e-4 m."""
    rng = np.random.default_rng(5)
    pts, m = _circle(rng, outliers=0)
    key = jax.random.PRNGKey(0)
    kw = dict(threshold=0.04, n_hypotheses=64, min_radius=gates[0], max_radius=gates[1])
    fj = jr.ransac_circle_2d(jnp.asarray(pts), jnp.asarray(m), key, **kw)
    ft = tr.ransac_circle_2d(_t(pts), _t(m), JaxStream(key), **kw)
    assert bool(ft.ok) == bool(fj.ok)
    np.testing.assert_array_equal(ft.inliers.numpy(), np.asarray(fj.inliers))
    np.testing.assert_allclose(ft.center.numpy(), np.asarray(fj.center), rtol=0, atol=1e-4)


@pytest.mark.parametrize("align", ["z", "pca", "auto"])
@pytest.mark.parametrize("seed", range(3))
def test_fit_cylinder_equal(jax_rows, align, seed):
    """Clusters near the origin along a random axis: inliers equal; centre,
    axis, radius and height within 1e-5."""
    rng = np.random.default_rng(10 + seed)
    ax = rng.normal(size=3)
    ax[2] = abs(ax[2]) + 1.0
    pts = synthetic_branch(400, radius=0.2, length=float(rng.uniform(0.3, 3.0)), axis=ax,
                           base=rng.uniform(-0.3, 0.3, 3), seed=seed)
    m = rng.uniform(size=400) < 0.95
    key = jax.random.PRNGKey(100 + seed)
    kw = dict(threshold=0.04, n_hypotheses=256, max_radius=0.5, min_radius=0.01,
              align_axis=align)
    fj = jr.fit_cylinder(jnp.asarray(pts), jnp.asarray(m), key, **kw)
    ft = tr.fit_cylinder(_t(pts), _t(m), JaxStream(key), **kw)
    np.testing.assert_array_equal(ft.inliers.numpy(), np.asarray(fj.inliers))
    assert bool(ft.ok) == bool(fj.ok)
    for f in ("center", "axis", "radius", "height"):
        np.testing.assert_allclose(getattr(ft, f).numpy(), np.asarray(getattr(fj, f)), rtol=0,
                                   atol=1e-5, err_msg=f)


def test_principal_axis_equal():
    """A flat strip along a tilted axis (three distinct eigenvalues): axis
    within 1e-6, elongation within 1e-4 relative."""
    rng = np.random.default_rng(4)
    local = np.stack([rng.uniform(0, 3, 600), rng.uniform(0, 0.5, 600),
                      rng.normal(0, 0.02, 600)], 1)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    pts = (local @ rot.T).astype(np.float32)
    m = rng.uniform(size=600) < 0.95
    aj, ej = jr.principal_axis(jnp.asarray(pts), jnp.asarray(m))
    at, et = tr.principal_axis(_t(pts), _t(m))
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=1e-6)
    assert abs(float(et) / float(ej) - 1.0) <= 1e-4 and float(et) > 4.0


def test_hypothesis_rows_draw_live_rows():
    """The default draw: live rows only, every live row reachable, the same
    rows from the same seed."""
    mask = torch.zeros(50, dtype=torch.bool)
    mask[[3, 7, 8, 20, 49]] = True
    rows = tr.hypothesis_rows(mask, 2000, torch.Generator().manual_seed(1))
    assert rows.shape == (2000, 3)
    assert set(rows.flatten().tolist()) == {3, 7, 8, 20, 49}
    again = tr.hypothesis_rows(mask, 2000, torch.Generator().manual_seed(1))
    assert torch.equal(rows, again)
    fit = tr.fit_cylinder(_t(synthetic_branch(300)), torch.ones(300, dtype=torch.bool),
                          torch.Generator().manual_seed(0), threshold=0.02, n_hypotheses=128)
    assert bool(fit.ok) and abs(float(fit.radius) - 0.3) < 0.02


@pytest.mark.parametrize("a", [[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0], [0.3, 0.2, 0.9],
                               [0, 1e-9, -1], [-0.3, -0.2, -0.9]])
@pytest.mark.parametrize("b", [[0, 0, 1], [0.3, 0.2, 0.9]])
def test_rotation_matrix_equal(a, b):
    """Parallel, antiparallel (the 180° fallback) and general pairs: within
    1e-6, and R a maps onto b."""
    rj = np.asarray(jg.rotation_matrix_from_vectors(jnp.asarray(a, jnp.float32),
                                                    jnp.asarray(b, jnp.float32)))
    rt = tg.rotation_matrix_from_vectors(torch.tensor(a, dtype=torch.float32),
                                         torch.tensor(b, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-6)
    an, bn = np.asarray(a, float) / np.linalg.norm(a), np.asarray(b, float) / np.linalg.norm(b)
    if an @ bn > -0.999 or np.count_nonzero(np.abs(an) > 1e-6) == 1:
        # a general antiparallel pair keeps |a × b|² above the 1e-16 switch
        # after float32 normalisation, in both packages alike
        np.testing.assert_allclose(rt @ an, bn, rtol=0, atol=1e-5)


def test_crop_mask_and_points_in_cylinder_equal():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    m = rng.uniform(size=500) < 0.9
    kw = dict(minx=-0.5, maxy=0.4, minz=-0.2, maxz=0.7)
    np.testing.assert_array_equal(tg.crop_mask(_t(pts), _t(m), **kw).numpy(),
                                  np.asarray(jg.crop_mask(jnp.asarray(pts), jnp.asarray(m), **kw)))
    c, ax = np.array([0.1, -0.1, 0.0], np.float32), np.array([0.0, 0.6, 0.8], np.float32)
    got = tr.points_in_cylinder(_t(pts), c, ax, 0.4, 1.2).numpy()
    ref = np.asarray(jr.points_in_cylinder(jnp.asarray(pts), jnp.asarray(c), jnp.asarray(ax),
                                           0.4, 1.2))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < 500


def test_sample_cylinder_surface_lies_on_the_cylinder():
    c, ax = np.array([1.0, 2.0, 3.0], np.float32), np.array([0.0, 0.6, 0.8], np.float32)
    p = tr.sample_cylinder_surface(c, ax, 0.25, 2.0, n=400).numpy()
    rel = p - c
    t = rel @ ax
    radial = np.linalg.norm(rel - t[:, None] * ax, axis=1)
    np.testing.assert_allclose(radial, 0.25, rtol=0, atol=1e-5)
    assert np.abs(t).max() <= 1.0 + 1e-5 and np.abs(t).max() > 0.9
    assert np.array_equal(p, tr.sample_cylinder_surface(c, ax, 0.25, 2.0, n=400).numpy())
