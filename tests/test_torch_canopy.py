"""Projected areas, color masks and canopy metrics of the PyTorch port
against the JAX package on the CPU. Inputs are numpy arrays from a seed,
the same for both packages; k-means' draws are the JAX package's
(``JaxDraws``, tests/test_torch_cluster.py). Tolerances: rasterized area
1e-6 relative, width 1e-5, hull 1e-5, HSV 1e-6 absolute, masks bit for
bit; canopy metrics from the JAX package's shift: masks and counts bit for
bit, areas and widths 1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_branch, synthetic_tree
from pyqsm_tpu.models import canopy as jc
from pyqsm_tpu.ops import area as ja
from pyqsm_tpu.ops import color as jcol
from pyqsm_tpu_torch.models import canopy as tc
from pyqsm_tpu_torch.ops import area as ta
from pyqsm_tpu_torch.ops import cluster as tcl
from pyqsm_tpu_torch.ops import color as tcol
from test_torch_cluster import JaxDraws

T = torch.as_tensor


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tcl, "first_center", JaxDraws())


def _cloud(n, seed, dead=0.2):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * [1.5, 1.0, 2.0]).astype(np.float32)
    return pts, rng.uniform(size=n) >= dead


@pytest.mark.parametrize("n,cell,close_iters,nan_rows", [
    (500, 0.05, 1, False), (3000, 0.05, 1, True), (3000, 0.06, 2, False), (20000, 0.01, 1, False),
], ids=["small", "nan_rows", "close2", "clipped_grid"])
def test_rasterized_area(n, cell, close_iters, nan_rows):
    """Equal to 1e-6 relative; non-finite rows are dropped and a cloud wider
    than the grid clips into its last cells."""
    pts, m = _cloud(n, n)
    if nan_rows:
        pts[::50, 0] = np.nan
    a = float(ja.rasterized_area(jnp.asarray(pts), jnp.asarray(m), cell=cell,
                                 close_iters=close_iters))
    b = float(ta.rasterized_area(T(pts), T(m), cell=cell, close_iters=close_iters))
    assert a > 0 and abs(b - a) <= 1e-6 * a


@pytest.mark.parametrize("n", [500, 3000, 9000], ids=["500", "3000", "over_cap"])
def test_width_p95_and_hull(n):
    """The p95 width within 1e-5 relative (9000 rows take the stride
    subsample); the support-line hull within 1e-5 relative."""
    pts, m = _cloud(n, n + 1)
    a = float(ja.width_p95(jnp.asarray(pts), jnp.asarray(m)))
    b = float(ta.width_p95(T(pts), T(m)))
    assert abs(b - a) <= 1e-5 * a
    live = np.ones(n, bool)
    a = float(ja.convex_hull_area_2d(jnp.asarray(pts), jnp.asarray(live)))
    b = float(ta.convex_hull_area_2d(T(pts), T(live)))
    assert abs(b - a) <= 1e-5 * a


def _colors(n, seed):
    rng = np.random.default_rng(seed)
    col = rng.uniform(size=(n, 3)).astype(np.float32)
    col[:50] = col[:50, :1]  # grays: zero saturation
    col[50:60] = 0.0  # black
    col[60:400] = np.clip(col[60:400] + 0.6, 0, 1)  # bright
    return col, rng.uniform(size=n) < 0.9


def test_hsv_round_trip_and_saturation():
    col, _ = _colors(5000, 0)
    hj = np.asarray(jcol.rgb_to_hsv(jnp.asarray(col)))
    ht = tcol.rgb_to_hsv(T(col)).numpy()
    np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tcol.hsv_to_rgb(T(hj)).numpy(),
                               np.asarray(jcol.hsv_to_rgb(jnp.asarray(hj))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tcol.saturate_colors(T(col)).numpy(),
                               np.asarray(jcol.saturate_colors(jnp.asarray(col))), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("saturate", [True, False])
def test_hue_and_green_masks_bit_for_bit(saturate):
    col, m = _colors(5000, 1)
    sj = jcol.segment_hues(jnp.asarray(col), jnp.asarray(m), saturate=saturate)
    st = tcol.segment_hues(T(col), T(m), saturate=saturate)
    assert list(st) == list(sj)
    for hue in sj:
        np.testing.assert_array_equal(st[hue].numpy(), np.asarray(sj[hue]), err_msg=hue)
    assert all(int(v.sum()) > 0 for v in st.values())
    hues = tuple(tcol.HUE_CONDITIONS)
    sj = jcol.segment_hues(jnp.asarray(col), jnp.asarray(m), hues=hues, saturate=saturate)
    st = tcol.segment_hues(T(col), T(m), hues=hues, saturate=saturate)
    for hue in sj:
        np.testing.assert_array_equal(st[hue].numpy(), np.asarray(sj[hue]), err_msg=hue)
    np.testing.assert_array_equal(tcol.green_surface_mask(T(col), T(m)).numpy(),
                                  np.asarray(jcol.green_surface_mask(jnp.asarray(col),
                                                                     jnp.asarray(m))))


@pytest.mark.parametrize("q", [0.0, 20.0, 33.3, 60.0, 65.0, 95.0, 100.0])
def test_split_on_percentile_bit_for_bit(q):
    rng = np.random.default_rng(int(q))
    v = rng.normal(size=5000).astype(np.float32)
    m = rng.uniform(size=5000) < 0.9
    hj, lj = jcol.split_on_percentile(jnp.asarray(v), jnp.asarray(m), q)
    ht, lt = tcol.split_on_percentile(T(v), T(m), q)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_homogenize_white_bloom():
    """Bloomed points take their non-white neighbours' mean color (within
    1e-6: the 30 neighbours are summed in another order); the rest keep
    theirs."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(4000, 3)).astype(np.float32)
    col, m = _colors(4000, 2)
    col[:300] = 0.95
    a = np.asarray(jcol.homogenize_white_bloom(jnp.asarray(pts), jnp.asarray(col),
                                               jnp.asarray(m)))
    b = tcol.homogenize_white_bloom(T(pts), T(col), T(m)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert not np.allclose(a[:300][m[:300]], 0.95)


@pytest.mark.parametrize("pct", [None, (65.0, 60.0), (50.0, 30.0)],
                         ids=["defaults", "defaults_passed", "other"])
def test_identify_epiphytes_bit_for_bit(pct):
    """Equal masks and magnitudes. On this input the z split's position is
    1570 · 0.6: the JAX package's default percentile (a constant it folds)
    and the same percentile passed in (a run-time value) put one point on
    either side, and the port follows each."""
    rng = np.random.default_rng(4)
    shift = (rng.normal(size=(5000, 3)) * 0.05).astype(np.float32)
    shift[:1750] *= 10
    m = rng.uniform(size=5000) < 0.9
    args = () if pct is None else pct
    sj = jc.identify_epiphytes(jnp.asarray(shift), jnp.asarray(m), *args)
    st = tc.identify_epiphytes(T(shift), T(m), *args)
    for f in sj._fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                      err_msg=f)


def test_width_at_height_and_slices():
    """The breast-height width (3000 slice points: the host's stride
    subsample) and the five slice areas within 1e-5 relative."""
    pts = synthetic_branch(40000, radius=0.3, length=4.0, seed=5)
    m = np.ones(len(pts), bool)
    m[::9] = False
    a = jc.width_at_height(jnp.asarray(pts), jnp.asarray(m))
    b = tc.width_at_height(T(pts), T(m))
    assert abs(b - a) <= 1e-5 * a and 0.55 < b < 0.65
    assert tc.width_at_height(T(pts), T(m), height=10.0) == 0.0
    a = jc.project_in_slices(jnp.asarray(pts), jnp.asarray(m), cell=0.05)
    b = tc.project_in_slices(T(pts), T(m), cell=0.05)
    assert len(b) == 5
    np.testing.assert_allclose(b, a, rtol=1e-5)


def _tree():
    pts = synthetic_tree()
    m = np.ones(len(pts), bool)
    m[::7] = False
    return pts, m


def test_canopy_metrics_from_the_jax_shift(jax_draws):
    """Fed the JAX package's shift and draws: the class masks' counts bit for
    bit, every area and width within 1e-5 relative."""
    pts, m = _tree()
    shift = np.asarray(jc.get_shift(jnp.asarray(pts), jnp.asarray(m)))
    a = jc.canopy_metrics(jnp.asarray(pts), jnp.asarray(m), shift=jnp.asarray(shift))
    b = tc.canopy_metrics(pts, m, shift=shift, device="cpu")
    assert b["counts"] == a["counts"]
    assert sum(b["counts"].values()) == int(m.sum())
    assert set(b) == set(a) == {"classes", "slice_areas", "width_at_bh", "counts"}
    assert set(b["classes"]) == set(a["classes"]) == {"epis", "leaves", "wood"}
    for name, cj in a["classes"].items():
        ct = b["classes"][name]
        assert len(ct["areas"]) == len(cj["areas"]), name
        np.testing.assert_allclose(ct["areas"], cj["areas"], rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(ct["total"], cj["total"], rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(b["slice_areas"], a["slice_areas"], rtol=1e-5)
    np.testing.assert_allclose(b["width_at_bh"], a["width_at_bh"], rtol=1e-5)


def test_canopy_metrics_end_to_end(jax_draws):
    """``shift=None``: each package's own one-iteration contraction, which
    differs by float summation order. Measured on this tree: counts,
    areas and width equal. Held to counts within 1 % of the live rows and
    areas and width within 5 %."""
    pts, m = _tree()
    a = jc.canopy_metrics(jnp.asarray(pts), jnp.asarray(m))
    b = tc.canopy_metrics(pts, m, device="cpu")
    n_live = int(m.sum())
    assert all(abs(b["counts"][k] - a["counts"][k]) <= 0.01 * n_live for k in a["counts"])
    assert sum(b["counts"].values()) == n_live
    for name, cj in a["classes"].items():
        np.testing.assert_allclose(b["classes"][name]["total"], cj["total"], rtol=0.05)
    np.testing.assert_allclose(b["slice_areas"], a["slice_areas"], rtol=0.05)
    np.testing.assert_allclose(b["width_at_bh"], a["width_at_bh"], rtol=0.05)


def test_get_shift_is_one_iteration():
    """``get_shift``'s configuration runs exactly one contraction iteration
    in both packages, and the shifts agree as the contraction tests hold
    them (5e-3 at p99, 5e-4 at the median)."""
    from pyqsm_tpu.config import SkeletonizeConfig as JCfg
    from pyqsm_tpu.models import skeleton as jsk
    from pyqsm_tpu_torch.config import SkeletonizeConfig as TCfg
    from pyqsm_tpu_torch.models import skeleton as tsk

    pts = synthetic_branch(1500, radius=0.3, length=4.0, seed=9)
    m = np.ones(len(pts), bool)
    kw = dict(init_contraction=3.0, init_attraction=0.8, max_iter=1,
              step_wise_contraction_amplification=3.0, n_neighbors=20, termination_ratio=0.0)
    rj = jsk.extract_skeleton(jnp.asarray(pts), jnp.asarray(m), JCfg(**kw), amplify_auto=False)
    rt = tsk.extract_skeleton(pts, m, TCfg(**kw), amplify_auto=False, device="cpu")
    assert int(rj.iterations) == int(rt.iterations) == 1
    d = np.abs(tc.get_shift(pts, m, device="cpu").numpy()
               - np.asarray(jc.get_shift(jnp.asarray(pts), jnp.asarray(m))))
    assert np.percentile(d, 99) < 5e-3 and np.median(d) < 5e-4
    np.testing.assert_array_equal(rt.first_shift.numpy(), tc.get_shift(pts, m, device="cpu").numpy())
