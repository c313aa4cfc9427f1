"""Tree isolation of the PyTorch port against the JAX package on the CPU
(the cases of tests/test_isolation.py): seeds, region growing with the
gather, push and band claims, and build_trees with its keywords — labels
BIT-EQUAL. The band claim's own cases are in test_torch_band_claim.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.config import IsolationConfig as JIso
from pyqsm_tpu.models import isolation as ji
from pyqsm_tpu.ops.neighbors import radius_knn as j_radius_knn
from pyqsm_tpu.ops.sparse import morton_codes as j_morton
from pyqsm_tpu_torch.config import IsolationConfig as TIso
from pyqsm_tpu_torch.models import isolation as ti


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def two_tree_plot(rng, n_per=4000):
    """Two synthetic trees (dense vertical trunks + blobby canopies), 8 m apart."""
    def tree(cx, cy):
        z = rng.uniform(0, 6, n_per)
        th = rng.uniform(0, 2 * np.pi, n_per)
        r = 0.25 + rng.normal(0, 0.01, n_per)
        trunk = np.stack([cx + r * np.cos(th), cy + r * np.sin(th), z], 1)
        canopy = rng.normal([cx, cy, 7.0], [1.5, 1.5, 1.0], size=(n_per // 2, 3))
        return np.concatenate([trunk, canopy])
    return np.concatenate([tree(0, 0), tree(8, 0)]).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


@pytest.mark.parametrize("coarsen_rows", [65536, 256])
def test_id_trunk_bases_equal(rng, coarsen_rows):
    """Exact row-resolution seeds and the eps/8 coarsened (weighted core
    count) path both give the JAX package's labels and slices."""
    pts = two_tree_plot(rng)
    m = np.ones(len(pts), bool)
    kw = dict(base_min_points=50, low_pctile=5.0)
    a = ji.id_trunk_bases(jnp.asarray(pts), jnp.asarray(m), JIso(**kw), coarsen_rows=coarsen_rows)
    b = ti.id_trunk_bases(torch.as_tensor(pts), torch.as_tensor(m), TIso(**kw),
                          coarsen_rows=coarsen_rows)
    for x, y in zip(a, b):
        _eq(x, y)
    lab = b[0].numpy()
    assert len(np.unique(lab[lab >= 0])) == 2


def test_exclude_regions_equal(rng):
    pts = two_tree_plot(rng)
    m = np.ones(len(pts), bool)
    region = [[6.0, -3.0], [10.0, 3.0]]
    kw = dict(base_min_points=50, low_pctile=5.0)
    a = ji.id_trunk_bases(jnp.asarray(pts), jnp.asarray(m), JIso(**kw), [region])
    b = ti.id_trunk_bases(torch.as_tensor(pts), torch.as_tensor(m), TIso(**kw), [region])
    _eq(a[0], b[0])
    assert len(np.unique(b[0].numpy()[b[0].numpy() >= 0])) == 1


@pytest.mark.parametrize("min_frontier", [1, 3])
def test_region_grow_on_chain(min_frontier):
    n = 100
    pts = np.stack([np.arange(n) * 0.05, np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    _, idx = j_radius_knn(jnp.asarray(pts), jnp.asarray(pts), radius=0.06, k=4)
    seeds = np.full(n, -1, np.int32)
    seeds[0], seeds[n - 1] = 0, 1
    a = ji.region_grow(idx, jnp.asarray(seeds), jnp.ones(n, bool), max_cycles=200,
                       min_frontier=min_frontier)
    b = ti.region_grow(torch.as_tensor(np.array(idx)), torch.as_tensor(seeds),
                       torch.ones(n, dtype=torch.bool), max_cycles=200, min_frontier=min_frontier)
    _eq(a.labels, b.labels)
    _eq(a.order, b.order)
    assert int(a.cycles_run) == b.cycles_run
    if min_frontier == 1:  # the middle tie goes to the lower id
        lab = b.labels.numpy()
        assert (lab[:45] == 0).all() and (lab[55:] == 1).all()


def _blob_graph(rng, n=32768):
    centers = rng.uniform(0, 12, (6, 3)).astype(np.float32)
    pts = (centers[rng.integers(0, 6, n)] + rng.normal(0, 0.9, (n, 3))).astype(np.float32)
    order = np.asarray(jnp.argsort(j_morton(jnp.asarray(pts), jnp.ones(n, bool))))
    p = jnp.asarray(pts[order])
    _, idx = j_radius_knn(p, p, radius=0.25, k=8)
    seeds = np.full(n, -1, np.int32)
    for cid in range(6):
        seeds[rng.integers(0, n, 4)] = cid
    return np.array(idx), seeds


@pytest.mark.parametrize("mode", ["gather", "push", "band"])
def test_region_grow_claims_match_jax_gather(rng, monkeypatch, mode):
    """Every claim of the port is bit-identical to the JAX package's gather
    kernel on a contested multi-blob graph; the named claim really ran."""
    monkeypatch.setenv("PYQSM_CLAIM", mode)
    idx, seeds = _blob_graph(rng)
    n = idx.shape[0]
    kw = dict(max_cycles=60, min_frontier=2, cluster_cap=16)
    ref = ji._region_grow_gather(jnp.asarray(idx), jnp.asarray(seeds), jnp.ones(n, bool), **kw)
    res = ti.region_grow(torch.as_tensor(idx), torch.as_tensor(seeds),
                         torch.ones(n, dtype=torch.bool), **kw)
    assert res.claim == mode
    _eq(ref.labels, res.labels)
    _eq(ref.order, res.order)
    _eq(ref.active, res.active)
    assert int(ref.cycles_run) == res.cycles_run
    assert int((res.labels >= 0).sum()) > 24


@pytest.mark.parametrize("trial", range(4))
def test_region_grow_push_fuzz_matches_jax(rng, monkeypatch, trial):
    """Spill-heavy random graphs, masked rows, sparse or empty seeds: the
    port's push claim equals the JAX package's push claim and gather."""
    monkeypatch.setenv("PYQSM_CLAIM", "push")
    rng = np.random.default_rng(100 + trial)
    n, k = 8192, 6
    lo = np.maximum(np.arange(n)[:, None] - 200, 0)
    idx = np.where(rng.uniform(size=(n, k)) < 0.25, rng.integers(0, n, (n, k)),
                   np.minimum(lo + rng.integers(0, 400, (n, k)), n - 1)).astype(np.int32)
    idx[idx == np.arange(n)[:, None]] = -1
    idx[rng.uniform(size=(n, k)) < 0.1] = -1
    mask = rng.uniform(size=n) > (0.2 if trial % 2 else 0.0)
    seeds = np.full(n, -1, np.int32)
    n_seeds = [40, 1, 12, 0][trial]
    if n_seeds:
        seeds[rng.choice(n, n_seeds, replace=False)] = rng.integers(0, trial + 1, n_seeds)
    kw = dict(max_cycles=40, min_frontier=[2, 1, 3, 2][trial], cluster_cap=16)
    ref = ji.region_grow(jnp.asarray(idx), jnp.asarray(seeds), jnp.asarray(mask), kt_max=256, **kw)
    assert ji.LAST_CLAIM_KERNEL == "push"
    res = ti.region_grow(torch.as_tensor(idx), torch.as_tensor(seeds), torch.as_tensor(mask),
                         kt_max=256, **kw)
    assert res.claim == "push"
    _eq(ref.labels, res.labels)
    _eq(ref.order, res.order)
    _eq(ref.active, res.active)


def test_region_grow_push_falls_back_on_indegree_overflow(rng, monkeypatch):
    monkeypatch.setenv("PYQSM_CLAIM", "push")
    n, k = 4096, 4
    idx = rng.integers(0, n, (n, k)).astype(np.int32)
    idx[:, 0] = 7
    idx[idx == np.arange(n)[:, None]] = -1
    seeds = np.full(n, -1, np.int32)
    seeds[:8] = np.arange(8) % 4
    kw = dict(max_cycles=20, min_frontier=1, cluster_cap=8)
    res = ti.region_grow(torch.as_tensor(idx), torch.as_tensor(seeds),
                         torch.ones(n, dtype=torch.bool), kt_max=64, **kw)
    assert res.claim == "gather"
    ref = ji._region_grow_gather(jnp.asarray(idx), jnp.asarray(seeds), jnp.ones(n, bool), **kw)
    _eq(ref.labels, res.labels)


@pytest.mark.parametrize("mode", ["gather", "push"])
def test_build_trees_equal(rng, monkeypatch, mode):
    monkeypatch.setenv("PYQSM_CLAIM", mode)
    pts = two_tree_plot(rng)
    m = np.ones(len(pts), bool)
    kw = dict(base_min_points=50, low_pctile=5.0, max_dist=0.35, cycles=300, min_frontier=2)
    a = ji.build_trees(jnp.asarray(pts), jnp.asarray(m), JIso(**kw), neighbor_cap=16)
    b = ti.build_trees(pts, m, TIso(**kw), device="cpu")
    assert b.claim == mode
    _eq(a.labels, b.labels)
    _eq(a.order, b.order)
    assert int(a.cycles_run) == b.cycles_run
    lab = b.labels.numpy()
    t0, t1 = lab[:4000], lab[6000:10000]
    assert (t0 >= 0).sum() > 3000 and (t1 >= 0).sum() > 3000
    assert t0[t0 >= 0][0] != t1[t1 >= 0][0]


@pytest.mark.parametrize("mode", ["gather", "push", "band"])
def test_region_grow_active0_matches_jax(rng, monkeypatch, mode):
    """Activity carried in (``active0``: clusters 1 and 4 already retired)
    holds on every claim as in the JAX package's gather claim."""
    monkeypatch.setenv("PYQSM_CLAIM", mode)
    idx, seeds = _blob_graph(rng)
    n = idx.shape[0]
    active0 = np.ones(16, bool)
    active0[[1, 4]] = False
    kw = dict(max_cycles=60, min_frontier=2, cluster_cap=16)
    ref = ji._region_grow_gather(jnp.asarray(idx), jnp.asarray(seeds), jnp.ones(n, bool),
                                 active0=jnp.asarray(active0), **kw)
    res = ti.region_grow(torch.as_tensor(idx), torch.as_tensor(seeds),
                         torch.ones(n, dtype=torch.bool), active0=torch.as_tensor(active0), **kw)
    assert res.claim == mode
    _eq(ref.labels, res.labels)
    _eq(ref.order, res.order)
    _eq(ref.active, res.active)
    assert int(ref.cycles_run) == res.cycles_run
    # retired clusters propose nothing: they keep their seed rows only
    assert np.isin(res.labels.numpy(), [1, 4]).sum() == np.isin(seeds, [1, 4]).sum() > 0


def test_region_grow_scatter_push_matches_jax(rng, monkeypatch):
    """``scatter_push`` (in-edges propagate too) on a strongly asymmetric
    graph: it runs on the gather claim even when push is asked for, and
    equals the JAX package's."""
    monkeypatch.setenv("PYQSM_CLAIM", "push")
    n, k = 4096, 3
    idx = np.minimum(np.arange(n)[:, None] + rng.integers(1, 40, (n, k)), n - 1).astype(np.int32)
    idx[idx == np.arange(n)[:, None]] = -1  # forward edges only: asymmetric
    seeds = np.full(n, -1, np.int32)
    seeds[[100, 2000, 3500]] = [0, 1, 2]
    kw = dict(max_cycles=100, min_frontier=1, cluster_cap=8)
    for push in (False, True):
        ref = ji.region_grow(jnp.asarray(idx), jnp.asarray(seeds), jnp.ones(n, bool),
                             scatter_push=push, **kw)
        res = ti.region_grow(torch.as_tensor(idx), torch.as_tensor(seeds),
                             torch.ones(n, dtype=torch.bool), scatter_push=push, **kw)
        assert res.claim == ("gather" if push else "push")
        _eq(ref.labels, res.labels)
        _eq(ref.order, res.order)
        assert int(ref.cycles_run) == res.cycles_run
    # the in-edges reach rows below each seed, which out-edges alone never do
    assert (res.labels.numpy()[:100] >= 0).any()


def test_id_trunk_bases_without_clean_matches_jax(rng):
    """``clean=False`` skips the slice's outlier clean, as in the JAX
    package: strays 0.6 m off a trunk's base are outliers to the clean but
    DBSCAN border points without it."""
    pts = two_tree_plot(rng)
    rows = rng.choice(4000, 8, replace=False)
    pts[rows, 2] = 0.05
    pts[rows, 0] += 0.6
    m = np.ones(len(pts), bool)
    kw = dict(base_min_points=50, low_pctile=5.0)
    out = {}
    for clean in (True, False):
        a = ji.id_trunk_bases(jnp.asarray(pts), jnp.asarray(m), JIso(**kw), clean=clean)
        b = ti.id_trunk_bases(torch.as_tensor(pts), torch.as_tensor(m), TIso(**kw), clean=clean)
        for x, y in zip(a, b):
            _eq(x, y)
        out[clean] = int((b[0].numpy()[rows] >= 0).sum())
    assert out[False] > out[True]


@pytest.mark.parametrize("kw", [dict(exclude_regions=[[[6.0, -3.0], [10.0, 3.0]]]),
                                dict(neighbor_cap=8), dict(pre_voxel=0.1)],
                         ids=["exclude_regions", "neighbor_cap", "pre_voxel"])
def test_build_trees_keywords_match_jax(rng, kw):
    """``build_trees``' keywords give the JAX package's labels and orders:
    an excluded footprint leaves one tree; a smaller radius-graph cap and
    a finer representative voxel change the growth identically."""
    pts = two_tree_plot(rng)
    m = np.ones(len(pts), bool)
    cfg = dict(base_min_points=50, low_pctile=5.0, max_dist=0.35, cycles=300, min_frontier=2)
    a = ji.build_trees(jnp.asarray(pts), jnp.asarray(m), JIso(**cfg), **kw)
    b = ti.build_trees(pts, m, TIso(**cfg), device="cpu", **kw)
    _eq(a.labels, b.labels)
    _eq(a.order, b.order)
    assert int(a.cycles_run) == b.cycles_run
    lab = b.labels.numpy()
    assert len(np.unique(lab[lab >= 0])) == (1 if "exclude_regions" in kw else 2)


def test_build_trees_observer_matches_jax(rng):
    """Observed growth runs in chunks with carried activity: the observer
    fires at the JAX package's cycles with torch tensors, and the labels
    and orders equal the JAX package's observed and unobserved runs."""
    pts = two_tree_plot(rng)
    m = np.ones(len(pts), bool)
    cfg = dict(base_min_points=50, low_pctile=5.0, max_dist=0.35, cycles=300, min_frontier=2)
    calls_j, calls_t = [], []
    a = ji.build_trees(jnp.asarray(pts), jnp.asarray(m), JIso(**cfg),
                       observer=lambda c, p, lab, o: calls_j.append((c, np.asarray(lab))),
                       observe_every=7)
    plain = ji.build_trees(jnp.asarray(pts), jnp.asarray(m), JIso(**cfg))

    def observer(cycle, points, labels, order):
        assert all(isinstance(v, torch.Tensor) for v in (points, labels, order))
        calls_t.append((cycle, labels.numpy().copy()))

    b = ti.build_trees(pts, m, TIso(**cfg), observer=observer, observe_every=7, device="cpu")
    assert [c for c, _ in calls_t] == [c for c, _ in calls_j] and len(calls_t) >= 2
    for (_, lj), (_, lt) in zip(calls_j, calls_t):
        np.testing.assert_array_equal(lt, lj)
    for ref in (a, plain):
        _eq(ref.labels, b.labels)
        _eq(ref.order, b.order)
    assert int(a.cycles_run) == b.cycles_run


def test_build_trees_in_the_jax_positional_form(rng):
    """``build_trees(p, m, cfg, None, 16, None, None)``: the seventh
    position is ``mesh`` in both packages; ``observer`` and
    ``observe_every`` follow it. Labels, orders and cycles equal the JAX
    package's, and the positional observer fires at its cycles."""
    pts = two_tree_plot(rng)
    m = np.ones(len(pts), bool)
    cfg = dict(base_min_points=50, low_pctile=5.0, max_dist=0.35, cycles=300, min_frontier=2)
    a = ji.build_trees(jnp.asarray(pts), jnp.asarray(m), JIso(**cfg), None, 16, None, None)
    b = ti.build_trees(pts, m, TIso(**cfg), None, 16, None, None, device="cpu")
    _eq(a.labels, b.labels)
    _eq(a.order, b.order)
    assert int(a.cycles_run) == b.cycles_run
    calls_j, calls_t = [], []
    ji.build_trees(jnp.asarray(pts), jnp.asarray(m), JIso(**cfg), None, 16, None, None,
                   lambda c, *_: calls_j.append(c), 7)
    c = ti.build_trees(pts, m, TIso(**cfg), None, 16, None, None,
                       lambda cyc, *_: calls_t.append(cyc), 7, device="cpu")
    assert calls_t == calls_j and len(calls_t) >= 2
    _eq(a.labels, c.labels)


def defaults_plot(rng, n_per=30_000):
    """Two trees dense enough for the reference's defaults: at 0.05 m
    representatives the 3 % slice holds ~500 trunk rows a tree, all within
    ``base_eps`` = 1 m, above ``base_min_points`` = 300."""
    return two_tree_plot(rng, n_per)


@pytest.mark.parametrize("mode", ["auto", "push"])
def test_build_trees_at_the_reference_defaults_matches_jax(rng, monkeypatch, mode):
    """``IsolationConfig()`` (k 200, max_dist 0.1, 150 cycles, min_frontier
    5, base_eps 1, base_min_points 300, low_pctile 3), as the bench's
    reference-default section calls it: labels, orders and cycles equal
    the JAX package's, on the claim the plot's size picks (gather) and on
    the push claim the bench's plot takes."""
    monkeypatch.setenv("PYQSM_CLAIM", mode)
    pts = defaults_plot(rng)
    m = np.ones(len(pts), bool)
    a = ji.build_trees(jnp.asarray(pts), jnp.asarray(m), JIso())
    b = ti.build_trees(pts, m, TIso(), device="cpu")
    assert b.claim == ("gather" if mode == "auto" else "push")
    _eq(a.labels, b.labels)
    _eq(a.order, b.order)
    assert int(a.cycles_run) == b.cycles_run
    lab = b.labels.numpy()
    assert len(np.unique(lab[lab >= 0])) == 2
