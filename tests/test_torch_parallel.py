"""The port's sharded growth (``parallel/growth.py``) on four gloo ranks on
the CPU against the JAX package's single-device ``region_grow``, on the
32 768-point four-trunk case of tests/test_parallel.py:270 and :327, plus
the process mesh's collectives and launcher.

The ranks are spawned processes (``parallel.mesh.launch``) that import
this module by name: JAX is imported only inside the functions the parent
runs, so that no rank imports it. Each rank runs torch on one thread."""

import os

import numpy as np
import pytest
import torch

from pyqsm_tpu_torch.parallel import mesh as pm

WORLD = 4
N = 32768
# the trunks of tests/test_parallel.py:270 on a line along x, and the same
# trunks on a 2 x 2 grid; on the line, Morton order keeps half the edges
# out of the band window, and four shards' spills overflow their 6·n_local
# cap (the JAX package's own check says so too), so the band claim falls
# back to gather; on the grid it fits and runs
LAYOUTS = {"line": [(0.0, 0.0), (6.0, 0.0), (12.0, 0.0), (18.0, 0.0)],
           "grid": [(0.0, 0.0), (6.0, 0.0), (0.0, 6.0), (6.0, 6.0)]}
KW = dict(max_cycles=200, min_frontier=3, cluster_cap=16)
# (layout, PYQSM_CLAIM) -> the claim the sharded path must take
CASES = {("line", "auto"): "gather", ("line", "push"): "gather", ("line", "band"): "gather",
         ("grid", "band"): "band"}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _trunks(layout: str):
    """Points of the four-trunk case (the JAX test's draws from
    ``default_rng(0)``), Morton-ordered by the JAX package; its radius
    graph (k = 12) and seeds: the first 50 low rows of each trunk."""
    import jax.numpy as jnp

    from pyqsm_tpu.ops.neighbors import grid_self_radius_knn
    from pyqsm_tpu.ops.sparse import morton_codes

    rng = np.random.default_rng(0)
    per = N // 4
    pts = []
    for cx, cy in LAYOUTS[layout]:
        th = rng.uniform(0, 2 * np.pi, per)
        z = rng.uniform(0, 5.0, per)
        r = 0.3 + rng.normal(0, 0.01, per)
        pts.append(np.stack([cx + r * np.cos(th), cy + r * np.sin(th), z], 1))
    pts = np.concatenate(pts).astype(np.float32)
    mask = np.ones(N, bool)
    pts = pts[np.asarray(jnp.argsort(morton_codes(jnp.asarray(pts), jnp.asarray(mask))))]
    _, nbr = grid_self_radius_knn(jnp.asarray(pts), radius=0.25, k=12, mask=jnp.asarray(mask),
                                  sort=False, need_dists=False)
    seeds = np.full(N, -1, np.int32)
    base = pts[:, 2] < 0.3
    for cid, (cx, cy) in enumerate(LAYOUTS[layout]):
        near = (np.abs(pts[:, 0] - cx) < 3) & (np.abs(pts[:, 1] - cy) < 3)
        seeds[np.flatnonzero(base & near)[:50]] = cid
    return np.asarray(nbr), seeds, mask


def _grow_ranks(cases, mesh=None):
    """Rank body: ``region_grow_sharded`` on every case under its
    ``PYQSM_CLAIM``; returns the results and this rank's band size."""
    from pyqsm_tpu_torch.parallel import growth

    out = {}
    for key, (nbr, seeds, mask) in cases.items():
        os.environ["PYQSM_CLAIM"] = key[1]
        growth.LAST_BAND = None
        res = growth.region_grow_sharded(nbr, seeds, mask, mesh, **KW)
        out[key] = (res, growth.LAST_BAND)
    return out


@pytest.fixture(scope="module")
def sharded():
    """Every case's inputs, the four ranks' results (one launch for all
    cases) and the JAX package's single-device results."""
    import jax.numpy as jnp

    from pyqsm_tpu.models import isolation as ji

    inputs = {lay: _trunks(lay) for lay in LAYOUTS}
    cases = {key: inputs[key[0]] for key in CASES}
    ranks = pm.launch(_grow_ranks, WORLD, "gloo", args=(cases,), device="cpu")
    ref = {}
    saved = os.environ.get("PYQSM_CLAIM")
    try:
        for key, (nbr, seeds, mask) in cases.items():
            os.environ["PYQSM_CLAIM"] = key[1]
            # kt_max=256: the dense trunk graph's in-degree passes push's
            # default cap (tests/test_parallel.py:311-314)
            ref[key] = ji.region_grow(jnp.asarray(nbr), jnp.asarray(seeds), jnp.asarray(mask),
                                      kt_max=256, **KW)
    finally:
        if saved is None:
            os.environ.pop("PYQSM_CLAIM", None)
        else:
            os.environ["PYQSM_CLAIM"] = saved
    return inputs, ranks, ref


@pytest.mark.parametrize("key", list(CASES), ids=lambda k: f"{k[0]}-{k[1]}")
def test_region_grow_sharded_matches_jax_single_device(sharded, key):
    """Labels, claim order, activity and cycles on every rank equal the JAX
    package's single-device claim bit for bit; the claim that ran is the
    one the dispatch conditions pick."""
    _, ranks, ref = sharded
    a = ref[key]
    assert (np.asarray(a.labels) >= 0).sum() > N // 2  # real growth
    for rank, out in enumerate(ranks):
        res, band = out[key]
        assert res.claim == CASES[key], rank
        np.testing.assert_array_equal(res.labels.numpy(), np.asarray(a.labels))
        np.testing.assert_array_equal(res.order.numpy(), np.asarray(a.order))
        np.testing.assert_array_equal(res.active.numpy(), np.asarray(a.active))
        assert res.cycles_run == int(a.cycles_run)
        if res.claim == "band":
            assert band["rows"] == N // WORLD and band["cluster_cap"] == KW["cluster_cap"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_claim_band_shards_match_jax(sharded, layout, monkeypatch):
    """Each rank's band (window tiles and spill) equals the JAX package's
    ``_claim_band_shards`` shard bit for bit, and the shards' overflow
    flags agree with its: any shard that overflows sends every rank to the
    gather claim. The shards are built in this process, one rank's view at
    a time, with the overflow left unsummed to read each shard's flag."""
    import jax.numpy as jnp

    from pyqsm_tpu.parallel.growth import _claim_band_shards as j_claim
    from pyqsm_tpu_torch.parallel import growth

    monkeypatch.setattr(growth, "all_reduce_sum", lambda v, mesh: v)
    inputs, _, _ = sharded
    nbr, _, mask = inputs[layout]
    a = j_claim(jnp.asarray(nbr), jnp.asarray(mask), WORLD)
    flags = []
    for rank in range(WORLD):
        view = pm.Mesh(None, ("points",), (WORLD,), torch.device("cpu"))
        monkeypatch.setattr(pm.Mesh, "rank", property(lambda self, r=rank: r))
        monkeypatch.setattr(pm.Mesh, "size", property(lambda self: WORLD))
        b = growth._claim_band_shards(torch.tensor(nbr), torch.tensor(mask), view)
        for x, y in zip(a[:4], b[:4]):  # bf16 compared through float32 (exact)
            np.testing.assert_array_equal(np.asarray(x[rank]).astype(np.float32),
                                          y.to(torch.float32).numpy())
            assert (y.dtype == torch.bfloat16) == (x.dtype == jnp.bfloat16)
        flags.append(b[4])
    assert any(flags) == bool(a[4]) == (CASES[(layout, "band")] != "band")


def _collective_ranks(mesh=None):
    """Rank body: the two collectives on rank-dependent rows, the mesh
    layouts, and ``shard_tree_batch`` of a [4, 8, 3] batch."""
    r = mesh.rank
    rows = torch.full((2, 3), r, dtype=torch.int32)
    flags = torch.tensor([r % 2 == 0, True])
    tp = pm.tree_points_mesh(device="cpu")
    batch = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    return dict(gathered=pm.all_gather_rows(rows, mesh), flags=pm.all_gather_rows(flags, mesh),
                summed=pm.all_reduce_sum(torch.tensor([1.5, r], dtype=torch.float64), mesh),
                axes=(mesh.axis_names, mesh.axis_sizes, tp.axis_names, tp.axis_sizes),
                coords=tp.coords(), block=pm.shard_tree_batch(batch, tp),
                backend=mesh.backend, device=str(mesh.device))


def test_collectives_and_meshes_on_gloo_ranks():
    outs = pm.launch(_collective_ranks, WORLD, "gloo", device="cpu")
    batch = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    for r, o in enumerate(outs):
        assert torch.equal(o["gathered"], torch.arange(WORLD, dtype=torch.int32)
                           .repeat_interleave(2)[:, None].expand(-1, 3))
        assert o["flags"].dtype == torch.bool
        assert o["flags"].tolist() == [True, True, False, True] * 2
        assert o["summed"].tolist() == [6.0, 6.0]
        assert o["axes"] == (("points",), (4,), ("trees", "points"), (2, 2))
        assert o["coords"] == {"trees": r // 2, "points": r % 2}
        assert torch.equal(o["block"], batch[2 * (r // 2):2 * (r // 2) + 2,
                                             4 * (r % 2):4 * (r % 2) + 4])
        assert (o["backend"], o["device"]) == ("gloo", "cpu")


def _failing_rank(mesh=None):
    if mesh.rank == 2:
        raise ValueError("rank two stops here")
    pm.all_reduce_sum(torch.ones(1), mesh)  # the others wait in a collective
    return mesh.rank


def test_launch_reports_a_failed_rank_and_stops_the_rest():
    with pytest.raises(RuntimeError, match="rank 2 failed(.|\n)*rank two stops here"):
        pm.launch(_failing_rank, WORLD, "gloo", device="cpu", timeout=120)


def test_meshes_need_a_process_group():
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is initialised in this process")
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        pm.tree_points_mesh(device="cpu")


def test_resolve_device_with_a_mesh_is_the_rank_device():
    from pyqsm_tpu_torch.device import resolve_device

    view = pm.Mesh(None, ("points",), (WORLD,), torch.device("cpu"))
    assert resolve_device("cpu", view) == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh device"):
        resolve_device("meta", view)


def test_tree_block_splits_and_pads_the_tree_axis():
    """3 trees over 4 ranks, as in tests/test_torch_parallel_plot.py: ranks
    0-2 hold one tree each, rank 3 one empty (all-zero) tree; the tier is
    fixed from the whole batch's largest tree."""
    from pyqsm_tpu_torch.config import SkeletonizeConfig
    from pyqsm_tpu_torch.models import skeleton as sk

    masks = torch.zeros(3, 8, dtype=torch.bool)
    masks[0, :5], masks[1, :8], masks[2, :2] = True, True, True
    pts = torch.arange(3 * 8 * 3, dtype=torch.float32).reshape(3, 8, 3) + 1
    for r in range(WORLD):
        bp, bm = sk.tree_block(pts, WORLD, r), sk.tree_block(masks, WORLD, r)
        assert bp.shape == (1, 8, 3) and bm.shape == (1, 8)
        if r < 3:
            assert torch.equal(bp[0], pts[r]) and torch.equal(bm[0], masks[r])
        else:
            assert not bp.any() and not bm.any()
    cfg = SkeletonizeConfig()
    fixed = sk.batch_amplification(cfg, masks)
    assert fixed.step_wise_contraction_amplification == "fixed"
    assert (fixed.termination_ratio, fixed.init_contraction) == sk.set_amplification(
        8, cfg.termination_ratio)
    assert sk.batch_amplification(fixed, masks[2:]) is fixed
