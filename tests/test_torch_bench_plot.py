"""The port's ``process_plot`` against the JAX package's at the bench's plot
layout: one numpy plot from ``bench.synthetic_plot`` (8 trees on an 8 m
grid, trunk rings under Gaussian canopies; bench.py:39-54) with the bench's
isolation and skeleton settings (bench.py:283-320: ``base_min_points=200,
low_pctile=4, max_dist=0.2, cycles=400, min_frontier=3``, skeleton voxel
0.03, min tree 2000 points).

Cut to what the CPU runs in about a minute: 160 000 points (the bench
draws 10 000 000) and a 4096-point skeleton cap per tree (the bench's is
40 000). Every tree's contraction buffer is then [8, 8192] rows, the
port's smallest bucket."""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyqsm_tpu.models.skeleton as j_skeleton
import pyqsm_tpu_torch.models.plot_pipeline as t_pipeline
from bench import synthetic_plot
from pyqsm_tpu.config import IsolationConfig as JIso
from pyqsm_tpu.models.plot_pipeline import process_plot as j_process_plot
from pyqsm_tpu_torch.config import IsolationConfig as TIso

N_POINTS = 160_000
SKELETON_CAP = 4096
ISO = dict(base_min_points=200, low_pctile=4.0, max_dist=0.2, cycles=400, min_frontier=3)
KW = dict(skeleton_voxel=0.03, max_skeleton_points=SKELETON_CAP, min_tree_points=2000)


def _recording(fn, into: list):
    """``fn`` that also keeps each result's per-tree iteration counts."""
    def wrapped(*args, **kwargs):
        res = fn(*args, **kwargs)
        into.append(np.asarray(res.iterations.cpu() if isinstance(res.iterations, torch.Tensor)
                               else res.iterations))
        return res
    return wrapped


@pytest.fixture(scope="module")
def runs():
    """Both packages on one plot, at the same time (the port in a worker
    thread on 2 torch threads), each with its contraction's per-tree
    outer-iteration counts recorded."""
    pts = synthetic_plot(N_POINTS, 8, seed=0)
    its_j, its_t = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(j_skeleton, "extract_skeleton_batch",
               _recording(j_skeleton.extract_skeleton_batch, its_j))
    mp.setattr(t_pipeline, "extract_skeleton_batch",
               _recording(t_pipeline.extract_skeleton_batch, its_t))
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(t_pipeline.process_plot, pts, np.ones(len(pts), bool),
                              iso_cfg=TIso(**ISO), device="cpu", **KW)
            a = j_process_plot(jnp.asarray(pts), jnp.ones(len(pts), bool), iso_cfg=JIso(**ISO),
                               **KW)
            b = fut.result()
    finally:
        torch.set_num_threads(prev)
        mp.undo()
    return a, b, its_j, its_t


def test_labels_and_claim_order_equal(runs):
    a, b, _, _ = runs
    np.testing.assert_array_equal(b.growth.labels.numpy(), np.asarray(a.growth.labels))
    np.testing.assert_array_equal(b.growth.order.numpy(), np.asarray(a.growth.order))
    assert b.growth.cycles_run == int(a.growth.cycles_run)


def test_tree_ids_and_point_counts_equal(runs):
    a, b, _, _ = runs
    assert len(a.trees) == 8
    assert [(t.tree_id, t.n_points) for t in b.trees] == [(t.tree_id, t.n_points)
                                                          for t in a.trees]


def test_outer_iterations_equal_per_tree(runs):
    _, _, its_j, its_t = runs
    # the JAX package's Morton wrapper calls the patched function again
    # inside; the outer call, the plot's, ends last
    assert its_j and len(its_t) == 1 and its_j[-1].shape == (8,)
    np.testing.assert_array_equal(its_t[-1], its_j[-1])


def test_cylinders_per_tree(runs):
    """The contraction differs from the JAX package's by float summation
    order; the FPS vertex picks on the collapsed cloud may then differ, so
    each tree's cylinder count is held to ±1, as on the two-tree plot
    (tests/test_torch_plot_pipeline.py), and every radius is finite and
    positive."""
    a, b, _, _ = runs
    for tj, tt in zip(a.trees, b.trees):
        nj, nt = int(tj.cylinders.count()), int(tt.cylinders.count())
        assert abs(nt - nj) <= 1 and nt >= 1, (tj.tree_id, nj, nt)
        rt = tt.cylinders.radius[tt.cylinders.mask].numpy()
        assert np.all(np.isfinite(rt)) and np.all(rt > 0)
