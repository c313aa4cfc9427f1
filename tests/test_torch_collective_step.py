"""The port's collective kernels and sharded multi-tree step
(``parallel/collective_ops.py``, ``parallel/pipeline_step.py``) and the
mesh's axis subgroups, on four gloo ranks on the CPU, against the JAX
package on four of its eight CPU devices: ``("points",)`` for the
collectives, a (2, 2) ``("trees", "points")`` mesh for the step.

One ``launch`` runs every case. The ranks import this module by name, so
JAX is imported only inside the functions the parent runs."""

import numpy as np
import pytest
import torch

from pyqsm_tpu_torch.parallel import mesh as pm

WORLD = 4
N_KNN, K_KNN = 1024, 6
N_CG, K_CG = 256, 6
T_STEP, N_STEP, K_STEP, H_STEP = 2, 512, 8, 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _branch(n, seed, radius=0.3, length=3.0, noise=0.005):
    """tests/conftest.py's ``synthetic_branch`` along z (same draws)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, length, n)
    theta = rng.uniform(0, 2 * np.pi, n)
    axis = np.array([0.0, 0.0, 1.0])
    u = np.cross(axis, [1.0, 0.0, 0.0])
    u /= np.linalg.norm(u)
    v = np.cross(axis, u)
    r = radius + rng.normal(0, noise, n)
    return (t[:, None] * axis + r[:, None] * (np.cos(theta)[:, None] * u
                                              + np.sin(theta)[:, None] * v)).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(0)
    knn_pts = rng.uniform(0, 3, (N_KNN, 3)).astype(np.float32)
    knn_mask = rng.uniform(size=N_KNN) < 0.9
    # the directed, asymmetric kNN weights of tests/test_parallel.py:103-141
    idx = np.full((N_CG, K_CG), -1, np.int32)
    w = np.zeros((N_CG, K_CG), np.float32)
    for i in range(N_CG):
        idx[i] = rng.choice([j for j in range(N_CG) if j != i], K_CG, replace=False)
        w[i] = rng.uniform(0.1, 1.0, K_CG)
    cg = dict(idx=idx, w=w, deg=w.sum(1), wl=rng.uniform(0.5, 2.0, N_CG).astype(np.float32),
              wh=rng.uniform(0.5, 2.0, N_CG).astype(np.float32),
              b=rng.normal(size=(N_CG, 3)).astype(np.float32))
    resid = rng.uniform(0, 0.05, (16, N_KNN)).astype(np.float32)
    labels = rng.integers(0, 5000, N_KNN).astype(np.int32)
    lab_nbr = rng.integers(-1, N_KNN, (N_KNN, 5)).astype(np.int32)
    edge_ok = rng.uniform(size=(N_KNN, 5)) < 0.7
    trees = np.stack([_branch(N_STEP, seed=i) for i in range(T_STEP)])
    step_mask = np.ones((T_STEP, N_STEP), bool)
    step_mask[1, ::7] = False
    return dict(knn=(knn_pts, knn_mask), cg=cg, inl=(resid, knn_mask), lp=(labels, lab_nbr, edge_ok),
                step=(trees, step_mask))


def _jax_draws(step_mask):
    """Each (tree, points-shard) block's hypothesis rows as the JAX step
    draws them: ``choice(fold_in(PRNGKey(0), j), n_local, (H/2, 3),
    p=mask/Σmask)`` on points shard j."""
    import jax
    import jax.numpy as jnp

    n_local, h = N_STEP // 2, H_STEP // 2
    out = np.zeros((T_STEP, 2, h, 3), np.int32)
    for t in range(T_STEP):
        for j in range(2):
            m = jnp.asarray(step_mask[t, j * n_local:(j + 1) * n_local])
            p = jnp.where(m, 1.0, 0.0)
            p = p / jnp.maximum(jnp.sum(p), 1.0)
            out[t, j] = np.asarray(jax.random.choice(
                jax.random.fold_in(jax.random.PRNGKey(0), j), n_local, shape=(h, 3), p=p))
    return out


def _rank_cases(inp, draws, mesh=None):
    """Rank body: every case on this rank's blocks."""
    from pyqsm_tpu_torch.parallel import collective_ops as co
    from pyqsm_tpu_torch.parallel.pipeline_step import multi_tree_pipeline_step

    r = mesh.rank

    def blk(a, n):
        return torch.as_tensor(np.ascontiguousarray(a[r * (n // WORLD):(r + 1) * (n // WORLD)]))

    pts, m = blk(inp["knn"][0], N_KNN), blk(inp["knn"][1], N_KNN)
    out = {"knn": co.ring_knn(pts, pts, m, K_KNN, "points", mesh=mesh)}
    c = {k: blk(v, N_CG) for k, v in inp["cg"].items()}
    out["cg"] = co.sharded_cg(c["idx"], c["w"], c["deg"], c["wl"], c["wh"], c["b"],
                              "points", iters=400, mesh=mesh)
    resid, m = inp["inl"]
    out["inl"] = co.psum_inlier_count(
        torch.as_tensor(np.ascontiguousarray(resid[:, r * 256:(r + 1) * 256])), blk(m, N_KNN),
        0.02, "points", mesh=mesh)
    lab, nbr, ok = (blk(a, N_KNN) for a in inp["lp"])
    out["lp"] = co.label_prop_round(lab, nbr, ok, "points", mesh=mesh)
    tp = pm.tree_points_mesh(device="cpu")
    trees, step_mask = inp["step"]
    t, j = tp.coords()["trees"], tp.coords()["points"]
    step = multi_tree_pipeline_step(tp, k=K_STEP, n_hyp=H_STEP)
    out["step"] = step(pm.shard_tree_batch(torch.as_tensor(trees), tp),
                       pm.shard_tree_batch(torch.as_tensor(step_mask), tp), draws[t:t + 1, j])
    # the axis subgroups: sums and gathers along one axis, the ring shift
    x = torch.tensor([float(r), 1.0])
    out["axes"] = dict(points=pm.all_reduce_sum(x, tp, "points"),
                       trees=pm.all_reduce_sum(x, tp, "trees"), all=pm.all_reduce_sum(x, tp),
                       gather=pm.all_gather_rows(x[None], tp, "trees"),
                       shift=pm.ring_shift(x, mesh, "points"),
                       shift_points=pm.ring_shift(x, tp, "points"))
    return out


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp
    from functools import partial
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pyqsm_tpu.parallel import collective_ops as jco
    from pyqsm_tpu.parallel.mesh import shard_tree_batch
    from pyqsm_tpu.parallel.pipeline_step import multi_tree_pipeline_step

    inp = _inputs()
    draws = _jax_draws(inp["step"][1])
    ranks = pm.launch(_rank_cases, WORLD, "gloo", args=(inp, draws), device="cpu")
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), ("points",))
    put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("points")))

    def sm(fn, n_in, out_specs=P("points")):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=(P("points"),) * n_in,
                                 out_specs=out_specs, check_vma=False))

    knn_pts, knn_mask = inp["knn"]
    ref = {"knn": sm(partial(jco.ring_knn, k=K_KNN, axis="points"), 3,
                     (P("points"), P("points")))(put(knn_pts), put(knn_pts), put(knn_mask))}
    c = inp["cg"]
    ref["cg"] = sm(partial(jco.sharded_cg, axis="points", iters=400), 6)(
        *(put(c[k]) for k in ("idx", "w", "deg", "wl", "wh", "b")))
    resid, m = inp["inl"]
    ref["inl"] = jax.jit(shard_map(
        partial(jco.psum_inlier_count, threshold=0.02, axis="points"), mesh=mesh,
        in_specs=(P(None, "points"), P("points")), out_specs=P(), check_vma=False))(
        jnp.asarray(resid), jnp.asarray(m))
    ref["lp"] = sm(partial(jco.label_prop_round, axis="points"), 3)(*(put(a) for a in inp["lp"]))
    tmesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(2, 2), ("trees", "points"))
    trees, step_mask = inp["step"]
    ref["step"] = multi_tree_pipeline_step(tmesh, k=K_STEP, n_hyp=H_STEP)(
        shard_tree_batch(jnp.asarray(trees), tmesh), jnp.asarray(step_mask),
        jax.random.PRNGKey(0))
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return inp, ranks, ref


def _cat(ranks, key):
    return np.concatenate([r[key].numpy() for r in ranks])


def test_ring_knn_ids_and_distances_bit_for_bit(runs):
    _, ranks, ref = runs
    d = np.concatenate([r["knn"][0].numpy() for r in ranks])
    i = np.concatenate([r["knn"][1].numpy() for r in ranks])
    np.testing.assert_array_equal(i, ref["knn"][1])
    np.testing.assert_array_equal(d.view(np.int32), ref["knn"][0].view(np.int32))
    assert (i >= 0).all()


def test_sharded_cg_matches_jax_and_the_dense_solve(runs):
    """Within 1e-4 (relative to the largest entry) of the JAX package's
    400 iterations, and within tests/test_parallel.py:141's bound of the
    float64 dense solve of the directed normal equations."""
    inp, ranks, ref = runs
    x = _cat(ranks, "cg")
    scale = np.abs(ref["cg"]).max()
    assert np.abs(x - ref["cg"]).max() <= 1e-4 * scale
    c = inp["cg"]
    A = np.diag(c["deg"]).astype(np.float64)
    for i in range(N_CG):
        for s in range(K_CG):
            A[i, c["idx"][i, s]] -= c["w"][i, s]
    wl, wh = c["wl"].astype(np.float64), c["wh"].astype(np.float64)
    x_ref = np.linalg.solve(A.T @ np.diag(wl ** 2) @ A + np.diag(wh ** 2), c["b"].astype(np.float64))
    np.testing.assert_allclose(x, x_ref, rtol=2e-2, atol=2e-3)


def test_inlier_counts_and_label_round_equal(runs):
    _, ranks, ref = runs
    for r in ranks:
        np.testing.assert_array_equal(r["inl"].numpy(), ref["inl"])
    np.testing.assert_array_equal(_cat(ranks, "lp"), ref["lp"])


def _step_global(ranks, key):
    """The ranks' step blocks assembled into [T, N, ...] (rank r holds tree
    block r // 2 and points block r % 2)."""
    rows = [np.concatenate([ranks[2 * t + j]["step"][key].numpy() for j in range(2)], axis=1)
            for t in range(2)]
    return np.concatenate(rows)


def test_multi_tree_step_matches_jax_with_its_draws(runs):
    """Labels equal; fits within 1e-6 (the JAX package's draws replayed);
    contraction, shift and neighbour distances within 1e-4 m."""
    _, ranks, ref = runs
    np.testing.assert_array_equal(_step_global(ranks, "labels"), ref["step"]["labels"])
    for key in ("contracted", "shift_mag", "nbr_dist_mean"):
        np.testing.assert_allclose(_step_global(ranks, key), ref["step"][key], rtol=0, atol=1e-4)
    for t in range(T_STEP):
        for j in range(2):
            o = ranks[2 * t + j]["step"]
            np.testing.assert_allclose(o["fit_radius"].numpy(), ref["step"]["fit_radius"][t:t + 1],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(o["fit_center"].numpy(), ref["step"]["fit_center"][t:t + 1],
                                       rtol=0, atol=1e-6)
    np.testing.assert_allclose(ref["step"]["fit_radius"], 0.3, atol=0.05)
    assert (ref["step"]["labels"][1, ::7] == 2 ** 30).all()


def test_axis_subgroups_and_ring_shift(runs):
    """Along ``points`` of a (2, 2) mesh a rank sums with its row partner
    only; along ``trees`` with its column partner; ``ring_shift`` hands
    each rank its left neighbour's tensor."""
    _, ranks, _ = runs
    for r, o in enumerate(ranks):
        a = o["axes"]
        t, j = divmod(r, 2)
        assert a["points"].tolist() == [float(2 * t + 2 * t + 1), 2.0]
        assert a["trees"].tolist() == [float(j + 2 + j), 2.0]
        assert a["all"].tolist() == [6.0, 4.0]
        assert a["gather"][:, 0].tolist() == [float(j), float(2 + j)]
        assert a["shift"].tolist() == [float((r - 1) % WORLD), 1.0]
        assert a["shift_points"].tolist() == [float(2 * t + (j - 1) % 2), 1.0]
