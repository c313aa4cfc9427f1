"""The port's sphere-following QSM against the JAX package's on the CPU, with
the JAX package's draws replayed (``replay_jax_draws``): the DBSCAN split,
the ball query, a wave whose fronts contest rows, the chain climb, the
branch split of a Y-shaped tree, ``generate_qsm``, the forest (batching
invariance, and ``mesh=`` over two gloo ranks) and a resumed walk. Masks,
branch orders, steps, cylinder counts, orders and parents are equal; the
float tolerances are stated at each comparison.

Rank processes import this module by name: JAX is imported only inside the
functions the parent runs."""

import numpy as np
import pytest
import torch

from pyqsm_tpu_torch.config import Config as TConfig
from pyqsm_tpu_torch.models import qsm as tq
from pyqsm_tpu_torch.ops import cluster as tcl
from pyqsm_tpu_torch.ops import ransac as tra
from tests.conftest import synthetic_branch, synthetic_tree

BS = 256  # block size of every walk here


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class JaxStream:
    """A JAX key standing in for a ``models.qsm.Stream``; its "generator"
    is itself, read by the replayed draw functions."""

    def __init__(self, key):
        self.key = key

    def generator(self):
        return self


class JaxWalkDraws:
    """``models.qsm.walk_draws`` with the JAX package's schedule: the walk
    starts from ``PRNGKey(seed)``; a dispatch splits ``(key, k_fit, k_km)``
    and ``k_fit`` into one key a fit slot."""

    def __init__(self, seed):
        import jax

        self.key = jax.random.PRNGKey(seed)

    def split(self, n_fits):
        import jax

        self.key, k_fit, k_km = jax.random.split(self.key, 3)
        return [JaxStream(k) for k in jax.random.split(k_fit, n_fits)], JaxStream(k_km)


def _p(mask):
    import jax.numpy as jnp

    w = jnp.where(jnp.asarray(mask.cpu().numpy()), 1.0, 0.0)
    return w / jnp.maximum(jnp.sum(w), 1.0)


def jax_hypothesis_rows(mask, n_hypotheses, gen):
    """The fit's draw: ``jax.random.choice(key, N, (H, 3), p=mask/Σmask)``."""
    import jax

    rows = jax.random.choice(gen.key, mask.shape[0], shape=(n_hypotheses, 3), p=_p(mask))
    return torch.as_tensor(np.array(rows), device=mask.device).long()


def jax_first_center(mask, gen):
    """k-means' draw of its first centre, from the sweep's key unsplit."""
    import jax

    return torch.tensor(int(jax.random.choice(gen.key, mask.shape[0], p=_p(mask))),
                        device=mask.device)


def replay_jax_draws(mp):
    """Route every draw of the walk through the JAX package's keys."""
    mp.setattr(tq, "walk_draws", JaxWalkDraws)
    mp.setattr(tra, "hypothesis_rows", jax_hypothesis_rows)
    mp.setattr(tcl, "first_center", jax_first_center)


def _np(x):
    return np.asarray(x)


def assert_walks_equal(rj, rt, atol=1e-5, pca_atol=None):
    """Discrete outputs equal; cylinder floats within ``atol`` (m, rad).
    ``pca_atol``: the tolerance of the fits made on a front's principal
    axis (axis not +z). On those rotated coordinates, metres from the
    origin, the JAX package's Kåsa refinement (float32 normal equations
    about the origin, solved with LAPACK) is ill-conditioned and loses up
    to 1e-2 m; the port solves the same least squares in float64 about
    the inliers' centroid."""
    assert rt.n_steps == rj.n_steps
    np.testing.assert_array_equal(rt.found.numpy(), _np(rj.found))
    np.testing.assert_array_equal(rt.branch_order.numpy(), _np(rj.branch_order))
    cj, ct = rj.cylinders, rt.cylinders
    for f in ("mask", "branch_order", "parent"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(), _np(getattr(cj, f)), err_msg=f)
    m = _np(cj.mask)
    assert m.sum() >= 1
    along_z = np.all(_np(cj.axis) == [0.0, 0.0, 1.0], axis=1)
    for sel, tol in ((m & along_z, atol), (m & ~along_z, pca_atol)):
        if not sel.any():
            continue
        assert tol is not None, "a fit on a principal axis needs pca_atol"
        for f in ("center", "axis", "height", "radius"):
            np.testing.assert_allclose(getattr(ct, f).numpy()[sel], _np(getattr(cj, f))[sel],
                                       rtol=0, atol=tol, err_msg=f)


def _seed(pts, zc):
    from pyqsm_tpu_torch.convert import seed_block

    return seed_block(np.flatnonzero(pts[:, 2] < zc), BS)


def test_split_dbscan_sparse_shell_equal():
    """The JAX package's sparse-shell regression input: labels equal."""
    import jax.numpy as jnp

    from pyqsm_tpu.models.qsm import _split_dbscan as j_split

    rng = np.random.default_rng(1)
    th = rng.uniform(0, 2 * np.pi, 43)
    shell = np.stack([8 + 0.3 * np.cos(th), 8 + 0.3 * np.sin(th), rng.uniform(0.5, 0.9, 43)], 1)
    block = np.zeros((512, 3), np.float32)
    block[:43] = shell
    idx = np.full(512, -1, np.int32)
    idx[:43] = np.arange(43)
    cfg = TConfig()
    lj = _np(j_split(jnp.asarray(block), jnp.asarray(idx), jnp.asarray(idx >= 0),
                     eps=cfg.dbscan.epsilon, min_pts=cfg.dbscan.min_neighbors))
    lt = tq._split_dbscan(torch.as_tensor(block)[None], torch.as_tensor(idx)[None],
                          torch.as_tensor(idx >= 0)[None], torch.tensor([cfg.dbscan.epsilon]),
                          cfg.dbscan.min_neighbors)[0]
    np.testing.assert_array_equal(lt.numpy(), lj)
    assert (lj >= 0).sum() >= cfg.sphere.min_contained_points


def test_block_knn_equals_knn():
    """The walk's elementwise block kNN gives ``ops/neighbors.knn``'s ids
    bit for bit, dead rows included, and its distances within one ulp: the
    walk takes correctly rounded roots, as XLA does; ``knn`` takes torch's
    vectorised CPU root."""
    from pyqsm_tpu_torch.ops.neighbors import knn

    rng = np.random.default_rng(4)
    block = torch.as_tensor(rng.normal(size=(2, 300, 3)).astype(np.float32) * 0.3 + 5.0)
    block[:, 50:60] = block[:, 40:50]  # exact duplicates: ties by index
    valid = torch.as_tensor(rng.uniform(size=(2, 300)) < 0.8)
    for k in (2, 32):
        d, i = tq._block_knn(block, valid, k)
        for b in range(2):
            dr, ir = knn(block[b], block[b], k, query_mask=valid[b], point_mask=valid[b])
            np.testing.assert_array_equal(i[b].numpy(), ir.numpy())
            np.testing.assert_array_equal(np.isinf(d[b].numpy()), np.isinf(dr.numpy()))
            fin = np.isfinite(dr.numpy())
            np.testing.assert_array_max_ulp(d[b].numpy()[fin], dr.numpy()[fin], maxulp=1)


def test_ball_new_equal():
    import jax.numpy as jnp

    from pyqsm_tpu.models.qsm import _ball_new as j_ball

    pts = synthetic_branch(3000, radius=0.3, length=6.0, seed=21)
    mask = np.ones(len(pts), bool)
    found = np.zeros(len(pts), bool)
    found[::7] = True
    fidx, fvalid = _seed(pts, 0.6)
    nj = j_ball(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(found), jnp.asarray(fidx),
                jnp.asarray(fvalid), 1.75, 0.01, 1.5, jnp.float32(0.3), cap=BS)
    nt = tq._ball_new(torch.as_tensor(pts)[None], torch.as_tensor(mask)[None],
                      torch.as_tensor(found)[None], torch.as_tensor(fidx)[None],
                      torch.as_tensor(fvalid)[None], 1.75, 0.01, 1.5, torch.tensor([0.3]), BS)
    np.testing.assert_array_equal(nt[0][0].numpy(), _np(nj[0]))
    np.testing.assert_array_equal(nt[1][0].numpy(), _np(nj[1]))
    assert int(nt[1].sum()) == BS  # more candidates than the block: the cap's cut decides
    np.testing.assert_allclose(nt[2][0].numpy(), _np(nj[2]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(nt[3][0]), float(nj[3]), rtol=0, atol=1e-6)


def test_wave_conflict_equal():
    """Two fronts whose balls overlap and two dead slots in one wave: the
    earlier slot owns contested rows; claims, blocks and labels equal."""
    import jax
    import jax.numpy as jnp

    from pyqsm_tpu.models.qsm import _qsm_wave_fused as j_wave

    pts = synthetic_branch(4000, radius=0.25, length=6.0, seed=11)
    mask = np.ones(len(pts), bool)
    a, _ = _seed(pts, 0.4)
    b, _ = tq_seed_rows(pts, 0.3, 0.7)
    dead = np.full(BS, -1, np.int32)
    fidx = np.stack([a, b, dead, dead])
    lr = np.array([0.25, 0.25, 1.0, 1.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    found = np.zeros(len(pts), bool)
    out_j = j_wave(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(found), jnp.asarray(fidx),
                   jnp.asarray(fidx >= 0), keys, jnp.asarray(lr), threshold=0.04,
                   radius_multiplier=1.75, min_radius=0.01, max_radius=1.5, eps=0.1, min_pts=10,
                   cap=BS)
    with pytest.MonkeyPatch.context() as mp:
        replay_jax_draws(mp)
        out_t = tq._qsm_wave_fused(torch.as_tensor(pts), torch.as_tensor(mask),
                                   torch.as_tensor(found), torch.as_tensor(fidx),
                                   torch.as_tensor(fidx >= 0), [JaxStream(k) for k in keys],
                                   torch.as_tensor(lr), torch.tensor([0.1]), TConfig().sphere, 10,
                                   BS)
    f_j, st_j, idx_j, nv_j, lab_j, blk_j = out_j
    f_t, st_t, idx_t, nv_t, lab_t, blk_t = out_t
    np.testing.assert_array_equal(f_t.numpy(), _np(f_j))
    np.testing.assert_array_equal(idx_t.numpy(), _np(idx_j))
    np.testing.assert_array_equal(nv_t.numpy(), _np(nv_j))
    np.testing.assert_array_equal(lab_t.numpy(), _np(lab_j))
    np.testing.assert_array_equal(blk_t.numpy(), _np(blk_j))
    # the second front lost rows to the first: contested rows exist
    ball_b = set(_np(idx_j)[1][_np(nv_j)[1]])
    assert len(ball_b) < BS and _np(nv_j)[0].sum() > 0
    for f in ("ok", "n_inliers", "n_front"):
        np.testing.assert_array_equal(st_t[f].numpy()[:2], _np(st_j[f])[:2], err_msg=f)
    for f in ("radius", "center", "axis", "height"):
        np.testing.assert_allclose(st_t[f].numpy()[:2], _np(st_j[f])[:2], rtol=0, atol=1e-5,
                                   err_msg=f)


def tq_seed_rows(pts, lo, hi):
    from pyqsm_tpu_torch.convert import seed_block

    return seed_block(np.flatnonzero((pts[:, 2] > lo) & (pts[:, 2] < hi)), BS)


def _walk_pair(pts, seed, radius, **kw):
    import jax.numpy as jnp

    from pyqsm_tpu.models.qsm import sphere_following_qsm as j_walk

    idx, valid = seed
    rj = j_walk(jnp.asarray(pts), jnp.ones(len(pts), bool), jnp.asarray(idx),
                jnp.asarray(valid), radius, block_size=BS, **kw)
    with pytest.MonkeyPatch.context() as mp:
        replay_jax_draws(mp)
        rt = tq.sphere_following_qsm(pts, np.ones(len(pts), bool), idx, valid, radius,
                                     block_size=BS, device="cpu", **kw)
    return rj, rt


def test_chain_climbs_trunk_equal():
    """A single front up an 8 m trunk: every dispatch is a chain."""
    pts = synthetic_branch(6000, radius=0.3, length=8.0, seed=3)
    rj, rt = _walk_pair(pts, _seed(pts, 0.5), 0.3, max_steps=64)
    assert_walks_equal(rj, rt, atol=1e-5)
    assert int(rt.cylinders.count()) >= 3


def test_chain_syncs_once_a_step():
    """The chain reads one alive flag a step and one readback a dispatch."""
    pts = synthetic_branch(3000, radius=0.3, length=4.0, seed=3)
    idx, valid = _seed(pts, 0.5)
    tq.SYNCS = 0
    res = tq.sphere_following_qsm(pts, np.ones(len(pts), bool), idx, valid, 0.3,
                                  block_size=BS, max_steps=64, chain_steps=8, device="cpu")
    assert res.n_steps >= 3
    dispatches = -(-res.n_steps // 8)
    assert tq.SYNCS <= res.n_steps + 2 * dispatches + 8


@pytest.fixture(scope="module")
def y_tree():
    trunk = synthetic_branch(3000, radius=0.25, length=4.0, seed=5)
    b1 = synthetic_branch(1500, radius=0.12, length=3.0, axis=[0.7, 0, 0.7], base=[0, 0, 4.0],
                          seed=6)
    b2 = synthetic_branch(1500, radius=0.12, length=3.0, axis=[-0.7, 0, 0.7], base=[0, 0, 4.0],
                          seed=7)
    return np.concatenate([trunk, b1, b2])


@pytest.mark.parametrize("wave_size", [4, 1])
def test_branch_split_equal(y_tree, wave_size):
    """The Y tree fragments at its fork: waves, the k-means sweep and the
    host policy. Every discrete output is equal; fits along z within
    1e-5, fits on a branch's principal axis within 2e-2 (the branches lie
    about 4 m from the origin: ``assert_walks_equal`` says why)."""
    rj, rt = _walk_pair(y_tree, _seed(y_tree, 0.4), 0.25, max_steps=128, wave_size=wave_size)
    assert_walks_equal(rj, rt, atol=1e-5, pca_atol=2e-2)
    assert (rt.branch_order.numpy()[3000:] >= 1).any()


def test_generate_qsm_equal():
    import jax.numpy as jnp

    from pyqsm_tpu.config import Config as JConfig
    from pyqsm_tpu.models.qsm import generate_qsm as j_gen

    pts = synthetic_tree(n_per=1000, seed=2)
    rj = j_gen(jnp.asarray(pts), jnp.ones(len(pts), bool), JConfig(), block_size=BS,
               max_steps=64)
    with pytest.MonkeyPatch.context() as mp:
        replay_jax_draws(mp)
        rt = tq.generate_qsm(pts, np.ones(len(pts), bool), TConfig(), block_size=BS,
                             max_steps=64, device="cpu")
    assert_walks_equal(rj, rt, atol=1e-5, pca_atol=1e-3)


def test_stem_mask_equal():
    import jax.numpy as jnp

    from pyqsm_tpu.models.qsm import stem_mask as j_stem

    rng = np.random.default_rng(0)
    trunk = synthetic_branch(3000, radius=0.3, length=5.0, seed=2)
    ground = np.concatenate([rng.uniform(-3, 3, (2000, 2)), rng.normal(0, 0.01, (2000, 1))],
                            1).astype(np.float32)
    pts = np.concatenate([trunk, ground])
    mj = _np(j_stem(jnp.asarray(pts), jnp.ones(len(pts), bool)))
    mt = tq.stem_mask(torch.as_tensor(pts), torch.ones(len(pts), dtype=torch.bool)).numpy()
    np.testing.assert_array_equal(mt, mj)
    assert mt[3000:].sum() == 0 and mt[:3000].sum() > 1000


def _forest_inputs(n_trees, n_per=3000):
    pts, seeds = [], []
    for i in range(n_trees):
        p = synthetic_branch(n_per, radius=0.25 + 0.05 * i, length=6.0, seed=10 + i)
        pts.append(p)
        seeds.append(_seed(p, 0.5)[0])
    seed_idx = np.stack(seeds)
    return (np.stack(pts), np.ones((n_trees, n_per), bool), seed_idx, seed_idx >= 0,
            [0.25 + 0.05 * i for i in range(n_trees)])


FOREST_KW = dict(block_size=BS, max_steps=48, seeds=[7, 8])


def test_forest_equal_and_batch_invariant():
    """The forest's climb against the JAX package's, tree for tree; and
    the port's forest([A, B]) equal to forest([A]) and forest([B])."""
    import jax.numpy as jnp

    from pyqsm_tpu.models.qsm import sphere_qsm_forest as j_forest

    pts, mask, si, sv, radii = _forest_inputs(2)
    rj = j_forest(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(si), jnp.asarray(sv), radii,
                  **FOREST_KW)
    with pytest.MonkeyPatch.context() as mp:
        replay_jax_draws(mp)
        rt = tq.sphere_qsm_forest(pts, mask, si, sv, radii, device="cpu", **FOREST_KW)
    for a, b in zip(rj, rt):
        assert_walks_equal(a, b, atol=1e-5)
    singles = [tq.sphere_qsm_forest(pts[i:i + 1], mask[i:i + 1], si[i:i + 1], sv[i:i + 1],
                                    radii[i:i + 1], block_size=BS, max_steps=48,
                                    seeds=[FOREST_KW["seeds"][i]], device="cpu")[0]
               for i in range(2)]
    batch = tq.sphere_qsm_forest(pts, mask, si, sv, radii, device="cpu", **FOREST_KW)
    for b, s in zip(batch, singles):
        assert_bitwise(b, s)


def assert_bitwise(a, b):
    assert a.n_steps == b.n_steps
    assert torch.equal(a.found, b.found) and torch.equal(a.branch_order, b.branch_order)
    for f in a.cylinders._fields:
        assert torch.equal(getattr(a.cylinders, f), getattr(b.cylinders, f)), f


def test_forest_over_gloo_ranks_equals_single_device():
    """``mesh=`` over two gloo ranks on the CPU (a tree a rank): every rank
    returns the whole forest, equal to the single-device run bit for bit."""
    from pyqsm_tpu_torch.parallel.mesh import launch

    inputs = _forest_inputs(3)
    ref = tq.sphere_qsm_forest(*inputs, device="cpu", block_size=BS, max_steps=48,
                               seeds=[7, 8, 9])
    out = launch(_forest_rank, 2, "gloo", args=(inputs,), device="cpu", timeout=300)
    for rank_res in out:
        assert len(rank_res) == 3
        for a, b in zip(rank_res, ref):
            assert_bitwise(a, b)


def _forest_rank(inputs, mesh=None):
    """Rank body: the three-tree forest over the mesh (default draws)."""
    pts, mask, si, sv, radii = inputs
    return tq.sphere_qsm_forest(pts, mask, si, sv, radii, mesh=mesh, device=mesh.device,
                                block_size=BS, max_steps=48, seeds=[7, 8, 9])


def test_resume_from_carried_fronts_equal(y_tree):
    """A walk resumed from two branch fronts handed to both packages (the
    JAX package's ``Front``s carried across by ``convert.front_from_numpy``)
    after a state of claimed trunk rows."""
    import jax.numpy as jnp

    from pyqsm_tpu.models.qsm import Front as JFront
    from pyqsm_tpu.models.qsm import sphere_following_qsm as j_walk
    from pyqsm_tpu_torch.convert import front_from_numpy

    pts = y_tree
    n = len(pts)
    claimed = pts[:, 2] < 4.0
    fronts_np = [tq_seed_rows_mask(pts, (pts[:, 2] > 4.3) & (pts[:, 2] < 4.7) & (x * pts[:, 0] > 0.1))
                 for x in (1.0, -1.0)]
    order = np.where(claimed, 0, -1).astype(np.int32)
    jq = [JFront(jnp.asarray(i), jnp.asarray(v), 0.12, 1, 3) for i, v in fronts_np]
    rj = j_walk(jnp.asarray(pts), jnp.ones(n, bool), jnp.asarray(fronts_np[0][0]),
                jnp.asarray(fronts_np[0][1]), 0.12, block_size=BS, max_steps=64, seed=5,
                _resume=dict(found=jnp.asarray(claimed), branch_order=jnp.asarray(order),
                             queue=jq, cylinders=[], order_updates=[], steps=4))
    tqueue = [front_from_numpy({k: _np(v) for k, v in f._asdict().items()}, device="cpu")
              for f in jq]
    with pytest.MonkeyPatch.context() as mp:
        replay_jax_draws(mp)
        rt = tq.sphere_following_qsm(pts, np.ones(n, bool), None, None, 0.12, block_size=BS,
                                     max_steps=64, seed=5, device="cpu",
                                     _resume=dict(found=torch.as_tensor(claimed),
                                                  branch_order=torch.as_tensor(order),
                                                  queue=tqueue, cylinders=[], order_updates=[],
                                                  steps=4))
    assert rt.n_steps > 4 and int(rt.cylinders.count()) >= 1
    assert_walks_equal(rj, rt, atol=1e-5, pca_atol=2e-2)


def tq_seed_rows_mask(pts, sel):
    from pyqsm_tpu_torch.convert import seed_block

    return seed_block(np.flatnonzero(sel), BS)


def test_qsm_result_to_numpy():
    from pyqsm_tpu_torch.convert import qsm_result_to_numpy

    pts = synthetic_branch(2000, radius=0.3, length=3.0, seed=3)
    idx, valid = _seed(pts, 0.5)
    res = tq.sphere_following_qsm(pts, np.ones(len(pts), bool), idx, valid, 0.3, block_size=BS,
                                  max_steps=16, max_cylinders=32, device="cpu")
    d = qsm_result_to_numpy(res)
    assert d["n_steps"] == res.n_steps and d["center"].shape == (32, 3)
    np.testing.assert_array_equal(d["found"], res.found.numpy())
    np.testing.assert_array_equal(d["cylinder_branch_order"], res.cylinders.branch_order.numpy())
