"""Contraction, topology and QSM of the PyTorch port against the JAX
package on the CPU: one contraction step on a carried-across Laplacian,
the batched single-level and two-level contractions, and topology/QSM on
identical contracted input."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_tree
from pyqsm_tpu.models import skeleton as jsk
from pyqsm_tpu_torch.convert import state_from_numpy
from pyqsm_tpu_torch.models import skeleton as tsk


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batch(cap, n_live, trees=2):
    pts = np.zeros((trees, cap, 3), np.float32)
    m = np.zeros((trees, cap), bool)
    for i in range(trees):
        t = synthetic_tree(n_live // 2, seed=i)
        pts[i, :len(t)] = t
        m[i, :len(t)] = True
    return pts, m


def test_one_contraction_step_on_carried_laplacian():
    """The port's contraction step (PCG solve + clamp + rebuild + weight
    update) from the same JAX-built banded Laplacians and weights."""
    pts, m = _batch(2048, 2000)
    perm = np.asarray(jsk._morton_perm_batch(jnp.asarray(pts), jnp.asarray(m)))
    pts = np.take_along_axis(pts, perm[..., None], 1)
    m = np.take_along_axis(m, perm, 1)
    init = jsk._contract_init_batch(jnp.asarray(pts), jnp.asarray(m), 20, 1e-6, 2.0, 3.0,
                                    banded=True)
    center, axes, half, L, m0, m0_mean, wl, wh = init
    zero = jnp.zeros_like(jnp.asarray(pts))
    ratio = jnp.ones(2)
    it = jnp.zeros(2, jnp.int32)
    kw = dict(n_neighbors=20, moll=1e-6, contraction_factor=2.0, max_contraction=2048.0,
              max_attraction=1024.0, termination_ratio=0.007, cg_iters=60, banded=True)
    out_j = jsk._contract_step_batch(jnp.asarray(pts), jnp.asarray(m), L, wl, wh, zero, zero,
                                     ratio, it, m0_mean, m0, center, axes, half, **kw)
    Lt = state_from_numpy("laplacian", {f: None if getattr(L, f) is None else np.asarray(getattr(L, f))
                                        for f in L._fields}, batched=True, device="cpu")
    T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    out_t = tsk._contract_step_batch(T(pts), T(m), Lt, T(wl), T(wh), T(zero), T(zero), T(ratio),
                                     T(it), T(m0_mean), T(m0), T(center), T(axes), T(half), **kw)
    live = m[..., None]
    # positions after 60 CG steps: within 2 mm on a 5 m tree
    np.testing.assert_allclose(np.where(live, out_t[0].numpy(), 0),
                               np.where(live, np.asarray(out_j[0]), 0), rtol=0, atol=2e-3)
    np.testing.assert_allclose(out_t[6].numpy(), np.asarray(out_j[6]), rtol=2e-2)  # mass ratio
    np.testing.assert_array_equal(out_t[7].numpy(), np.asarray(out_j[7]))  # iterations


@pytest.mark.parametrize("cap,n_live,trees", [(2048, 2000, 2), (16384, 3000, 1)],
                         ids=["single_level", "two_level"])
def test_extract_skeleton_batch_matches_jax(cap, n_live, trees):
    """Whole batched contraction (16 384 rows is the smallest buffer that
    takes the two-level path): same iteration counts; contracted points
    agree to a few mm at the 99th percentile (float sums in other orders
    grow through the CG solves)."""
    pts, m = _batch(cap, n_live, trees)
    a = jsk.extract_skeleton_batch(jnp.asarray(pts), jnp.asarray(m))
    b = tsk.extract_skeleton_batch(pts, m, device="cpu")
    np.testing.assert_array_equal(b.iterations.numpy(), np.asarray(a.iterations))
    np.testing.assert_allclose(b.volume_ratio.numpy(), np.asarray(a.volume_ratio), rtol=0.05)
    for f in ("contracted", "total_shift", "first_shift"):
        d = np.abs(getattr(b, f).numpy() - np.asarray(getattr(a, f)))[m]
        assert np.percentile(d, 99) < 5e-3, f
        assert np.median(d) < 5e-4, f


def test_topology_and_qsm_on_same_contracted_cloud():
    """Topology (FPS, kNN, Borůvka, degree-2 simplify) and cylinders from
    identical contracted input: same vertices and edges, cylinders equal to
    float rounding."""
    pts, m = _batch(2048, 2000, trees=1)
    a = jsk.extract_skeleton_batch(jnp.asarray(pts), jnp.asarray(m))
    c, s = np.array(a.contracted[0]), np.array(a.total_shift[0])
    tj = jsk.extract_topology(jnp.asarray(c), jnp.asarray(m[0]), jnp.asarray(s), 15)
    tt = tsk.extract_topology(torch.as_tensor(c), torch.as_tensor(m[0]), torch.as_tensor(s), 15)
    np.testing.assert_array_equal(tt.fps_idx.numpy(), np.asarray(tj.fps_idx))
    for f in ("edge_u", "edge_v", "edge_mask", "edge_chain", "chain_id", "degree"):
        np.testing.assert_array_equal(getattr(tt.graph, f).numpy(), np.asarray(getattr(tj.graph, f)))
    np.testing.assert_array_equal(tt.topology.point_to_vertex.numpy(),
                                  np.asarray(tj.topology.point_to_vertex))
    cj, ct = jsk.skeleton_to_qsm(tj), tsk.skeleton_to_qsm(tt)
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    for f in ("center", "axis", "height", "radius"):
        np.testing.assert_allclose(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert int(ct.count()) >= 1
