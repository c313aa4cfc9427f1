"""The PyTorch port's ``process_plot`` against the JAX package on the
two-tree case of tests/test_plot_pipeline.py: the same tree ids and
per-tree point counts (isolation is bit-equal), cylinders within the
tolerance stated below, per-tree canopy metrics (``with_metrics``), and
the reference's ``max_trees``, ``progress`` and ``TreeResult``
contracts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.config import IsolationConfig as JIso
from pyqsm_tpu.models.plot_pipeline import TreeResult as JTreeResult
from pyqsm_tpu.models.plot_pipeline import process_plot as j_process_plot
from pyqsm_tpu_torch.config import IsolationConfig as TIso
from pyqsm_tpu_torch.models.plot_pipeline import TreeResult as TTreeResult
from pyqsm_tpu_torch.models.plot_pipeline import process_plot as t_process_plot


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _two_trees(rng):
    def tree(cx, r, n=3000):
        th = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(0, 5, n)
        return np.stack([cx + (r + rng.normal(0, .005, n)) * np.cos(th),
                         (r + rng.normal(0, .005, n)) * np.sin(th), z], 1)
    return np.concatenate([tree(0, 0.3), tree(6, 0.2)]).astype(np.float32)


ISO = dict(base_min_points=15, low_pctile=5.0, max_dist=0.35, cycles=200, min_frontier=2)
KW = dict(skeleton_voxel=0.08, max_skeleton_points=2048, min_tree_points=300)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's result (its gather and push claims are
    bit-identical, so one run serves both claims of the port)."""
    pts = _two_trees(np.random.default_rng(0))
    return pts, j_process_plot(jnp.asarray(pts), jnp.ones(len(pts), bool), iso_cfg=JIso(**ISO),
                               **KW)


@pytest.mark.parametrize("claim", ["gather", "push"])
def test_process_plot_two_trees_matches_jax(jax_run, monkeypatch, claim):
    monkeypatch.setenv("PYQSM_CLAIM", claim)
    pts, a = jax_run
    b = t_process_plot(pts, np.ones(len(pts), bool), iso_cfg=TIso(**ISO), device="cpu", **KW)
    assert b.growth.claim == claim
    np.testing.assert_array_equal(b.growth.labels.numpy(), np.asarray(a.growth.labels))
    assert [(t.tree_id, t.n_points) for t in b.trees] == [(t.tree_id, t.n_points) for t in a.trees]
    assert len(b.trees) == 2
    assert set(b.timings) == {"isolation_s", "ladder_s", "contraction_s", "topology_s"}
    for tj, tt in zip(a.trees, b.trees):
        mj, mt = np.asarray(tj.cylinders.mask), tt.cylinders.mask.numpy()
        # contraction differs by float summation order (mm); the FPS vertex
        # picks on the collapsed cloud may then differ, so cylinders are
        # held to their count (±1) and radius/length statistics (10 %)
        assert abs(int(mt.sum()) - int(mj.sum())) <= 1 and mt.sum() >= 1
        rj, rt = np.asarray(tj.cylinders.radius)[mj], tt.cylinders.radius.numpy()[mt]
        assert np.all(rt > 0) and np.all(np.isfinite(rt))
        np.testing.assert_allclose(np.median(rt), np.median(rj), rtol=0.1)
        hj = np.asarray(tj.cylinders.height)[mj].sum()
        np.testing.assert_allclose(tt.cylinders.height.numpy()[mt].sum(), hj, rtol=0.1)


def test_max_trees_and_a_raising_progress_callback(jax_run):
    """``max_trees=1`` keeps the JAX package's largest tree, and a progress
    callback that raises is swallowed at every stage (the reference's
    plot_pipeline.py:69-76) instead of ending the run."""
    pts, _ = jax_run
    a = j_process_plot(jnp.asarray(pts), jnp.ones(len(pts), bool), iso_cfg=JIso(**ISO),
                       max_trees=1, **KW)
    stages = []

    def progress(stage, s):
        stages.append(stage)
        raise RuntimeError("observer failure")

    b = t_process_plot(pts, np.ones(len(pts), bool), iso_cfg=TIso(**ISO), max_trees=1,
                       progress=progress, device="cpu", **KW)
    assert [(t.tree_id, t.n_points) for t in b.trees] == [(t.tree_id, t.n_points) for t in a.trees]
    assert len(b.trees) == 1
    assert stages == ["isolation", "ladder", "contraction", "topology"]
    assert b.trees[0].metrics is None and int(b.trees[0].cylinders.count()) >= 1


def test_process_plot_in_the_jax_positional_form():
    """``process_plot(p, m, cfg, iso, 0.05, 50_000, 500, False, None, None)``
    as a caller of the JAX package writes it (the tenth position is
    ``mesh`` in both packages), with ``progress`` eleventh: the JAX
    package's labels, tree ids and point counts, cylinders within the
    tolerance of test_process_plot_two_trees_matches_jax."""
    from pyqsm_tpu.config import Config as JConfig

    from pyqsm_tpu_torch.config import Config as TConfig

    pts = _two_trees(np.random.default_rng(0))
    ones = np.ones(len(pts), bool)
    a = j_process_plot(jnp.asarray(pts), jnp.asarray(ones), JConfig(), JIso(**ISO), 0.05,
                       50_000, 500, False, None, None)
    stages = []
    b = t_process_plot(pts, ones, TConfig(), TIso(**ISO), 0.05, 50_000, 500, False, None, None,
                       lambda stage, s: stages.append(stage), device="cpu")
    np.testing.assert_array_equal(b.growth.labels.numpy(), np.asarray(a.growth.labels))
    assert [(t.tree_id, t.n_points) for t in b.trees] == [(t.tree_id, t.n_points) for t in a.trees]
    assert len(b.trees) == 2 and stages == ["isolation", "ladder", "contraction", "topology"]
    for tj, tt in zip(a.trees, b.trees):
        mj, mt = np.asarray(tj.cylinders.mask), tt.cylinders.mask.numpy()
        assert abs(int(mt.sum()) - int(mj.sum())) <= 1 and mt.sum() >= 1
        rj, rt = np.asarray(tj.cylinders.radius)[mj], tt.cylinders.radius.numpy()[mt]
        np.testing.assert_allclose(np.median(rt), np.median(rj), rtol=0.1)


def test_tree_result_has_the_reference_fields():
    """Code that unpacks the reference's 4-field ``TreeResult`` works on the
    port's; the metrics default to None (``with_metrics=False``)."""
    assert TTreeResult._fields == JTreeResult._fields
    tree_id, n_points, cylinders, metrics = TTreeResult(3, 10, None)
    assert (tree_id, n_points, metrics) == (3, 10, None)


def test_process_plot_with_metrics_matches_jax(monkeypatch):
    """``with_metrics=True`` on the two-tree case, the JAX package's k-means
    draws replayed (``JaxDraws``, tests/test_torch_cluster.py): the same
    tree ids, cylinders within the tolerance above, and each tree's
    metrics within the end-to-end canopy tolerance
    (tests/test_torch_canopy.py): class counts within 1 % of the tree's
    live batch rows (disjoint, summing to them), areas and width within
    5 %. The metrics come after the contraction: the cylinders equal a run
    without them bit for bit."""
    from test_torch_cluster import JaxDraws

    from pyqsm_tpu_torch.ops import cluster as tcl

    monkeypatch.setattr(tcl, "first_center", JaxDraws())
    pts = _two_trees(np.random.default_rng(0))
    a = j_process_plot(jnp.asarray(pts), jnp.ones(len(pts), bool), iso_cfg=JIso(**ISO),
                       with_metrics=True, **KW)
    batch = {}

    def recording(points, masks, cfg, **kw):  # observes, then calls through
        batch.update(masks=masks)
        return extract(points, masks, cfg, **kw)

    from pyqsm_tpu_torch.models import plot_pipeline as tpp

    extract = tpp.extract_skeleton_batch
    monkeypatch.setattr(tpp, "extract_skeleton_batch", recording)
    b = t_process_plot(pts, np.ones(len(pts), bool), iso_cfg=TIso(**ISO), with_metrics=True,
                       device="cpu", **KW)
    plain = t_process_plot(pts, np.ones(len(pts), bool), iso_cfg=TIso(**ISO), device="cpu", **KW)
    assert [(t.tree_id, t.n_points) for t in b.trees] == [(t.tree_id, t.n_points) for t in a.trees]
    assert len(b.trees) == 2
    for i, (tj, tt, tp) in enumerate(zip(a.trees, b.trees, plain.trees)):
        for f in tt.cylinders._fields:
            assert torch.equal(getattr(tt.cylinders, f), getattr(tp.cylinders, f)), f
        mj, mt = np.asarray(tj.cylinders.mask), tt.cylinders.mask.numpy()
        assert abs(int(mt.sum()) - int(mj.sum())) <= 1 and mt.sum() >= 1
        rj, rt = np.asarray(tj.cylinders.radius)[mj], tt.cylinders.radius.numpy()[mt]
        np.testing.assert_allclose(np.median(rt), np.median(rj), rtol=0.1)
        ma, mb = tj.metrics, tt.metrics
        assert set(mb) == set(ma) and set(mb["classes"]) == set(ma["classes"])
        n_live = int(batch["masks"][i].sum())
        assert sum(mb["counts"].values()) == n_live
        assert all(abs(mb["counts"][k] - ma["counts"][k]) <= 0.01 * n_live for k in ma["counts"])
        for name, cj in ma["classes"].items():
            np.testing.assert_allclose(mb["classes"][name]["total"], cj["total"], rtol=0.05)
        np.testing.assert_allclose(mb["slice_areas"], ma["slice_areas"], rtol=0.05)
        np.testing.assert_allclose(mb["width_at_bh"], ma["width_at_bh"], rtol=0.05)
