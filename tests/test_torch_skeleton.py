"""Contraction, topology and QSM of the PyTorch port against the JAX
package on the CPU: one contraction step on a carried-across Laplacian,
the batched single-level and two-level contractions with default and
non-default PCG budgets, the banded guard's overflow rescues,
topology/QSM on identical contracted input, and the single-tree
``extract_skeleton`` (plain and semantic-weighted) and ``skeletonize``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_branch, synthetic_tree
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


def test_extract_skeleton_batch_in_the_jax_positional_form():
    """``extract_skeleton_batch(p, m, cfg, 80, None)``: the fifth position
    is ``mesh`` in both packages, so ``None`` runs the single-device
    contraction and ``two_level`` keeps its default. Same iteration counts
    as the JAX package's, points within the tolerance above, and the same
    bits as the port's keyword call."""
    from pyqsm_tpu.config import SkeletonizeConfig as JSkel

    from pyqsm_tpu_torch.config import SkeletonizeConfig as TSkel

    pts, m = _batch(2048, 2000)
    a = jsk.extract_skeleton_batch(jnp.asarray(pts), jnp.asarray(m), JSkel(), 80, None)
    b = tsk.extract_skeleton_batch(pts, m, TSkel(), 80, None, device="cpu")
    np.testing.assert_array_equal(b.iterations.numpy(), np.asarray(a.iterations))
    for f in ("contracted", "total_shift", "first_shift"):
        d = np.abs(getattr(b, f).numpy() - np.asarray(getattr(a, f)))[m]
        assert np.percentile(d, 99) < 5e-3, f
    c = tsk.extract_skeleton_batch(pts, m, cfg=TSkel(), cg_iters=80, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(b, c))


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


@pytest.mark.parametrize("cap,n_live,kw", [
    (2048, 2000, dict(cg_iters=40, cg_iters_first=50)),
    (8192, 3000, dict(coarse_stride=2, cg_iters=60, cg_iters_first=100, cg_iters_polish=25)),
], ids=["single_level", "two_level_stride2"])
def test_extract_skeleton_batch_budgets_match_jax(cap, n_live, kw):
    """The PCG budgets and the coarse stride reach the solves as in the JAX
    package: same iteration counts, contracted points within the stated
    tolerance. 8192 rows take the two-level path only at stride 2."""
    pts, m = _batch(cap, n_live, trees=1)
    a = jsk.extract_skeleton_batch(jnp.asarray(pts), jnp.asarray(m), **kw)
    b = tsk.extract_skeleton_batch(pts, m, device="cpu", **kw)
    np.testing.assert_array_equal(b.iterations.numpy(), np.asarray(a.iterations))
    # the final mass ratio is a mean kNN-ball area (∝ mean kNN distance²)
    # of a cloud contracted to mm scale, where positions differ by a few mm
    # at the 99th percentile: it agrees within 10 %
    np.testing.assert_allclose(b.volume_ratio.numpy(), np.asarray(a.volume_ratio), rtol=0.1)
    for f in ("contracted", "total_shift", "first_shift"):
        d = np.abs(getattr(b, f).numpy() - np.asarray(getattr(a, f)))[m]
        assert np.percentile(d, 99) < 5e-3, f
        assert np.median(d) < 5e-4, f
    # the budgets change the result: the defaults land elsewhere
    c = tsk.extract_skeleton_batch(pts, m, device="cpu")
    assert np.abs(c.contracted.numpy() - b.contracted.numpy())[m].max() > 1e-3


@pytest.mark.parametrize("kw", [dict(fps_fraction=0.2, min_fps=40), dict(dedupe_voxel=0.0),
                                dict(min_fps=300)], ids=["fraction", "no_dedupe", "min_fps"])
def test_topology_keywords_match_jax(kw):
    """``fps_fraction``, ``min_fps`` and ``dedupe_voxel`` pick the JAX
    package's FPS samples and graph on identical contracted input."""
    pts, m = _batch(2048, 2000, trees=1)
    a = jsk.extract_skeleton_batch(jnp.asarray(pts), jnp.asarray(m))
    c, s = np.array(a.contracted[0]), np.array(a.total_shift[0])
    tj = jsk.extract_topology(jnp.asarray(c), jnp.asarray(m[0]), jnp.asarray(s), 15, **kw)
    tt = tsk.extract_topology(torch.as_tensor(c), torch.as_tensor(m[0]), torch.as_tensor(s), 15,
                              **kw)
    base = tsk.extract_topology(torch.as_tensor(c), torch.as_tensor(m[0]), torch.as_tensor(s), 15)
    np.testing.assert_array_equal(tt.fps_idx.numpy(), np.asarray(tj.fps_idx))
    np.testing.assert_array_equal(tt.topology.vertex_mask.numpy(),
                                  np.asarray(tj.topology.vertex_mask))
    for f in ("edge_u", "edge_v", "edge_mask"):
        np.testing.assert_array_equal(getattr(tt.graph, f).numpy(), np.asarray(getattr(tj.graph, f)))
    assert int(tt.topology.vertex_mask.sum()) != int(base.topology.vertex_mask.sum())


def _nonlocal_banded_batch(rng, n=1024, k=6, spill_cap=8):
    """A random non-local graph (tests/test_skeleton.py's ``_random_ell_256``)
    whose banded form overflows a tiny spill: the JAX package's Laplacian
    and the port's copy of it, both batched [1, ...]."""
    import jax

    from pyqsm_tpu.ops import sparse as jsp

    idx = np.full((n, k), -1, np.int32)
    w = np.zeros((n, k), np.float32)
    for i in range(n):
        nb = rng.choice(np.delete(np.arange(n), i), k - 1, replace=False)
        idx[i, :k - 1] = nb
        w[i, :k - 1] = rng.uniform(0.1, 1.0, k - 1)
    L = jsp.ELLLaplacian(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(w.sum(1)), jnp.ones(n))
    b_w, s_i, s_j, s_w, over = jsp.build_banded(L.nbr_idx, L.w, spill_cap)
    assert bool(over)
    Lj = jax.tree.map(lambda a: a[None], L._replace(b_w=b_w, s_i=s_i, s_j=s_j, s_w=s_w,
                                                     s_overflow=over))
    Lt = state_from_numpy("laplacian", {f: None if getattr(Lj, f) is None
                                        else np.asarray(getattr(Lj, f)) for f in Lj._fields},
                          batched=True, device="cpu")
    return Lj, Lt


@pytest.mark.parametrize("cloud", ["gaussian", "dense_knn"], ids=["re_morton", "ell_fallback"])
def test_banded_guard_rescues_overflow_as_jax(rng, cloud):
    """``_banded_guard`` on a flagged overflow (the oracle of
    tests/test_skeleton.py:366-393): it re-Mortons the batch on current
    positions and rebuilds; if the rebuilt band still overflows it drops
    to the exact ELL form. Both rescues give the JAX package's permutation,
    form and graph."""
    n = 1024
    Lj, Lt = _nonlocal_banded_batch(rng, n)
    if cloud == "gaussian":  # a compact cloud: re-sorting fixes the band
        pts = rng.normal(size=(1, n, 3)).astype(np.float32)
        k = 8
    else:  # 64-NN in a uniform cube: neighbors span many Morton blocks
        pts = rng.uniform(size=(1, n, 3)).astype(np.float32)
        k = 64
    msk = np.ones((1, n), bool)
    z2, z3 = np.zeros((1, n), np.float32), np.zeros((1, n, 3), np.float32)
    out_j = jsk._banded_guard(jnp.asarray(pts), jnp.asarray(msk), jnp.asarray(z3),
                              jnp.asarray(z3), jnp.asarray(z2), jnp.asarray(z2), jnp.asarray(z2),
                              Lj, None, True, jnp.ones(1, bool), k, 1e-6)
    T = torch.as_tensor
    out_t = tsk._banded_guard(T(pts), T(msk), T(z3), T(z3), T(z2), T(z2), T(z2), Lt, None, True,
                              torch.ones(1, dtype=torch.bool), k, 1e-6)
    pts_j, L_j, cum_j, banded_j = out_j[0], out_j[7], out_j[8], out_j[9]
    pts_t, L_t, cum_t, banded_t = out_t[0], out_t[7], out_t[8], out_t[9]
    assert banded_t == banded_j == (cloud == "gaussian")
    np.testing.assert_array_equal(cum_t.numpy(), np.asarray(cum_j))
    assert sorted(cum_t[0].tolist()) == list(range(n))
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    np.testing.assert_array_equal(L_t.nbr_idx.numpy(), np.asarray(L_j.nbr_idx))
    np.testing.assert_allclose(L_t.w.numpy(), np.asarray(L_j.w), rtol=1e-5, atol=1e-6)
    if banded_t:
        assert not bool(L_t.s_overflow.any())
        np.testing.assert_array_equal(L_t.s_i.numpy(), np.asarray(L_j.s_i))
    else:
        assert L_t.b_w is None and L_j.b_w is None
        np.testing.assert_array_equal(L_t.t_idx.numpy(), np.asarray(L_j.t_idx))


def _assert_single_tree_close(a, b):
    """Single-tree contraction as the batch path is held: same iteration
    count, volume ratio within 5 %, positions and shifts within 5e-3 m at
    the 99th percentile and 5e-4 m at the median."""
    assert b.contracted.dim() == 2 and b.iterations.dim() == 0
    assert int(b.iterations) == int(a.iterations)
    np.testing.assert_allclose(float(b.volume_ratio), float(a.volume_ratio), rtol=0.05)
    for f in ("contracted", "total_shift", "first_shift"):
        d = np.abs(getattr(b, f).numpy() - np.asarray(getattr(a, f)))
        assert np.percentile(d, 99) < 5e-3, f
        assert np.median(d) < 5e-4, f


@pytest.mark.parametrize("trunk", [False, True], ids=["plain", "trunk_mask"])
def test_extract_skeleton_matches_jax(trunk):
    """The single-tree ``extract_skeleton`` (ELL Laplacian rebuilt every
    iteration) on the oracles' branches: 2000 points, 10 iterations at
    most; with ``trunk_mask``, 1500 points, 3 iterations, semantic weight
    10 on the lower half."""
    from pyqsm_tpu.config import SkeletonizeConfig as JCfg
    from pyqsm_tpu_torch.config import SkeletonizeConfig as TCfg

    if trunk:
        pts = synthetic_branch(1500, radius=0.3, length=4.0, seed=8)
        kw, tm = dict(max_iter=3, semantic_weight=10.0), pts[:, 2] < 2.0
    else:
        pts = synthetic_branch(2000, radius=0.3, length=4.0, seed=1)
        kw, tm = dict(max_iter=10), None
    m = np.ones(len(pts), bool)
    a = jsk.extract_skeleton(jnp.asarray(pts), jnp.asarray(m), JCfg(**kw),
                             trunk_mask=None if tm is None else jnp.asarray(tm))
    b = tsk.extract_skeleton(pts, m, TCfg(**kw), trunk_mask=tm, device="cpu")
    _assert_single_tree_close(a, b)
    if trunk:  # the weighting changes the contraction
        plain = tsk.extract_skeleton(pts, m, TCfg(**kw), device="cpu")
        assert not torch.allclose(plain.contracted, b.contracted)


def test_skeletonize_matches_jax():
    """``skeletonize`` on the oracle tree (trunk and two branches, 10
    iterations at most): the contraction as above; the cylinders from it
    as the plot parity test holds them (count ±1, all radii positive)."""
    from pyqsm_tpu.config import SkeletonizeConfig as JCfg
    from pyqsm_tpu_torch.config import SkeletonizeConfig as TCfg

    pts = synthetic_tree()
    m = np.ones(len(pts), bool)
    sj, _, cj = jsk.skeletonize(jnp.asarray(pts), jnp.asarray(m), JCfg(max_iter=10))
    st, topo, ct = tsk.skeletonize(pts, m, TCfg(max_iter=10), device="cpu")
    _assert_single_tree_close(sj, st)
    assert abs(int(ct.mask.sum()) - int(jnp.sum(cj.mask))) <= 1
    assert int(ct.mask.sum()) >= 2 and bool((ct.radius[ct.mask] > 0).all())
    assert bool((topo.topology.point_to_vertex >= 0).all())
