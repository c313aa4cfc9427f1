"""The port's ``process_plot(mesh=)`` on four gloo ranks on the CPU against
the JAX package's single-device ``process_plot``, on the three-tree plot of
tests/test_plot_pipeline.py:68 (sharded growth, then each rank contracting
its own block of trees: 3 trees over 4 ranks, one rank holding only an
empty padding tree).

The ranks are spawned processes that import this module by name: JAX is
imported only inside the functions the parent runs."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pyqsm_tpu_torch.parallel import mesh as pm

WORLD = 4
ISO = dict(base_min_points=15, low_pctile=5.0, max_dist=0.3, cycles=300, min_frontier=2)
KW = dict(skeleton_voxel=0.05, min_tree_points=500)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _three_trees():
    """The JAX test's plot, drawn from its ``rng`` fixture (default_rng(0))."""
    rng = np.random.default_rng(0)

    def tree(cx, r, n=3000):
        th = rng.uniform(0, 2 * np.pi, n)
        z = rng.uniform(0, 5, n)
        return np.stack([cx + (r + rng.normal(0, .005, n)) * np.cos(th),
                         (r + rng.normal(0, .005, n)) * np.sin(th), z], 1)

    return np.concatenate([tree(0, 0.3), tree(7, 0.2), tree(14, 0.25)]).astype(np.float32)


def _plot_ranks(pts, mesh=None):
    """Rank body: ``process_plot(mesh=)`` on the whole plot."""
    from pyqsm_tpu_torch.config import IsolationConfig
    from pyqsm_tpu_torch.models.plot_pipeline import process_plot

    return process_plot(pts, np.ones(len(pts), bool), iso_cfg=IsolationConfig(**ISO), mesh=mesh,
                        device=mesh.device, **KW)


@pytest.fixture(scope="module")
def runs():
    import jax.numpy as jnp

    from pyqsm_tpu.config import IsolationConfig as JIso
    from pyqsm_tpu.models.plot_pipeline import process_plot as j_process_plot
    from pyqsm_tpu_torch.config import IsolationConfig as TIso
    from pyqsm_tpu_torch.models.plot_pipeline import process_plot as t_process_plot

    pts = _three_trees()
    # the ranks run while this process runs the two single-device references
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(pm.launch, _plot_ranks, WORLD, "gloo", args=(pts,), device="cpu")
        ref = j_process_plot(jnp.asarray(pts), jnp.ones(len(pts), bool), iso_cfg=JIso(**ISO),
                             **KW)
        single = t_process_plot(pts, np.ones(len(pts), bool), iso_cfg=TIso(**ISO), device="cpu",
                                **KW)
        return ranks.result(), ref, single


def test_process_plot_sharded_matches_jax_single_device(runs):
    """Every rank returns the JAX package's labels, claim order, trees and
    point counts bit for bit. Cylinders are held as the single-device
    parity test holds them (tests/test_torch_plot_pipeline.py): the
    contraction differs from the JAX package's by float summation order,
    so counts agree within ±1 and the median radius and total length
    within 10 %."""
    ranks, a, _ = runs
    want = [(t.tree_id, t.n_points) for t in a.trees]
    assert len(want) == 3
    for b in ranks:
        np.testing.assert_array_equal(b.growth.labels.numpy(), np.asarray(a.growth.labels))
        np.testing.assert_array_equal(b.growth.order.numpy(), np.asarray(a.growth.order))
        assert b.growth.cycles_run == int(a.growth.cycles_run)
        assert [(t.tree_id, t.n_points) for t in b.trees] == want
        for tj, tt in zip(a.trees, b.trees):
            mj, mt = np.asarray(tj.cylinders.mask), tt.cylinders.mask.numpy()
            assert abs(int(mt.sum()) - int(mj.sum())) <= 1 and mt.sum() >= 1
            rj, rt = np.asarray(tj.cylinders.radius)[mj], tt.cylinders.radius.numpy()[mt]
            assert np.all(rt > 0) and np.all(np.isfinite(rt))
            np.testing.assert_allclose(np.median(rt), np.median(rj), rtol=0.1)
            hj = np.asarray(tj.cylinders.height)[mj].sum()
            np.testing.assert_allclose(tt.cylinders.height.numpy()[mt].sum(), hj, rtol=0.1)


def test_process_plot_sharded_equals_the_ports_single_device_run(runs):
    """Each tree contracts on its rank as it does in the unsharded batch
    (the amplification tier comes from the whole batch), so every rank's
    cylinders equal the port's single-device run's bit for bit."""
    ranks, _, single = runs
    for b in ranks:
        assert torch.equal(b.growth.labels, single.growth.labels)
        assert len(b.trees) == len(single.trees)
        for tb, ts in zip(b.trees, single.trees):
            assert (tb.tree_id, tb.n_points) == (ts.tree_id, ts.n_points)
            for f in ts.cylinders._fields:
                assert torch.equal(getattr(tb.cylinders, f), getattr(ts.cylinders, f)), f
