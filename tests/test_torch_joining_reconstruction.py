"""Plot joining and detail recovery of the port against the JAX package on
the CPU: ``uniform_downsample``, the grid radius query with distances,
label adjacency, joins, ratings, scan merging and the four reconstruction
functions. Inputs are numpy arrays from a seed, the same for both
packages; every output is compared for equality (distances bit for
bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.models import joining as jj
from pyqsm_tpu.models import reconstruction as jr
from pyqsm_tpu.ops import neighbors as jn
from pyqsm_tpu.ops import sampling as jsm
from pyqsm_tpu_torch.models import joining as tj
from pyqsm_tpu_torch.models import reconstruction as tr
from pyqsm_tpu_torch.ops import neighbors as tn
from pyqsm_tpu_torch.ops import sampling as tsm


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.as_tensor(np.array(x))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a),
                                  np.asarray(b))


def _two_scans(seed=0):
    """Three clusters in scan 1 and two in scan 2; scan 2's first cluster
    duplicates scan 1's second (offset 2 cm)."""
    rng = np.random.default_rng(seed)

    def blob(c, n=600, s=0.25):
        return (rng.normal(size=(n, 3)) * s + c).astype(np.float32)

    s1 = [blob([0, 0, 1]), blob([3, 0, 1]), blob([6, 0, 1])]
    s2 = [s1[1] + 0.02, blob([3, 4, 1])]
    p1, p2 = np.concatenate(s1), np.concatenate(s2)
    l1 = np.repeat([0, 1, 2], 600).astype(np.int32)
    l2 = np.repeat([0, 1], 600).astype(np.int32)
    l1[::37] = -1
    m1 = rng.uniform(size=len(p1)) < 0.97
    m2 = np.ones(len(p2), bool)
    return (p1, l1, m1), (p2, l2, m2)


@pytest.mark.parametrize("k", [1, 3, 10])
def test_uniform_downsample_equal(k):
    m = np.random.default_rng(k).uniform(size=1000) < 0.7
    _eq(tsm.uniform_downsample(_t(m), k), jsm.uniform_downsample(jnp.asarray(m), k))


@pytest.mark.parametrize("k,max_bucket", [(64, 128), (12, 64)])
def test_grid_self_radius_knn_distances_equal(k, max_bucket):
    """Ids in first-in-cell order and distances bit for bit, on a cloud
    dense enough that rows fill all k slots (the cap decides which
    neighbours survive) and some cells pass 64 points."""
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.uniform(0, 1.5, (2500, 3)),
                          rng.normal(0.7, 0.03, (150, 3))]).astype(np.float32)
    m = rng.uniform(size=len(pts)) < 0.95
    jd, ji = jn.grid_self_radius_knn(jnp.asarray(pts), 0.35, k, jnp.asarray(m), sort=False,
                                     max_bucket=max_bucket)
    td, ti = tn.grid_self_radius_knn(_t(pts), 0.35, k, _t(m), sort=False,
                                     max_bucket=max_bucket)
    _eq(ti, ji)
    _eq(td, jd)
    assert (ti.numpy()[:, -1] >= 0).any()
    with pytest.raises(NotImplementedError):
        tn.grid_self_radius_knn(_t(pts), 0.35, k, _t(m))


def test_label_adjacency_equal():
    """Adjacency, min distances (bit for bit) and label ids on the merged
    scans' cloud, at ::10 and ::4."""
    (p1, l1, m1), (p2, l2, m2) = _two_scans()
    pts = np.concatenate([p1, p2])
    lab = np.concatenate([l1, np.where(l2 >= 0, l2 + 3, -1)]).astype(np.int32)
    m = np.concatenate([m1, m2])
    for every in (10, 4):
        a = tj.label_adjacency(_t(pts), _t(lab), _t(m), subsample_every=every)
        b = jj.label_adjacency(jnp.asarray(pts), jnp.asarray(lab), jnp.asarray(m),
                               subsample_every=every)
        for f in ("min_dist", "adjacent", "labels"):
            _eq(getattr(a, f), getattr(b, f))
        assert a.adjacent.numpy()[1, 3]
    empty = tj.label_adjacency(_t(pts), _t(np.full(len(pts), -1, np.int32)), _t(m))
    assert empty.min_dist.shape == (0, 0)


def test_label_adjacency_not_shadowed_by_closer_third_cluster():
    """The JAX package's shadowing case (tests/test_joining_reconstruction
    .py:126): A and B 0.3 apart, C 0.05 from both: every pair adjacent,
    equal to the JAX package's."""
    rng = np.random.default_rng(0)
    n = 120
    a = np.stack([rng.uniform(-0.5, 0.0, n), rng.uniform(0, 2, n), np.zeros(n)], 1)
    a[:, 0] = np.minimum(a[:, 0], -0.001)
    b = a.copy()
    b[:, 0] = -a[:, 0] + 0.30
    c = np.stack([np.full(n, 0.15), rng.uniform(0, 2, n), np.full(n, 0.02)], 1)
    pts = np.concatenate([a, b, c]).astype(np.float32)
    labels = np.repeat([0, 1, 2], n).astype(np.int32)
    mask = np.ones(3 * n, bool)
    adj = tj.label_adjacency(_t(pts), _t(labels), _t(mask), threshold=0.35, subsample_every=1)
    ref = jj.label_adjacency(jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(mask),
                             threshold=0.35, subsample_every=1)
    am = adj.adjacent.numpy()
    assert am[0, 1] and am[1, 0] and am[0, 2] and am[1, 2]
    _eq(adj.min_dist, ref.min_dist)
    _eq(adj.adjacent, ref.adjacent)


def test_joins_ratings_and_merge_equal():
    """``auto_join_policy``, ``join_clusters`` (chains, repeated and
    reversed pairs), ``rate_clusters`` and ``merge_labeled_scans`` equal;
    the duplicated cluster ends with one label."""
    rng = np.random.default_rng(2)
    lab = rng.integers(-1, 9, 400).astype(np.int32)
    joins = [(7, 2), (2, 5), (5, 7), (8, 0), (3, 3)]
    _eq(tj.join_clusters(_t(lab), joins), jj.join_clusters(jnp.asarray(lab), joins))
    _eq(tj.join_clusters(lab, [], device="cpu"), jj.join_clusters(jnp.asarray(lab), []))
    (p1, l1, m1), (p2, l2, m2) = _two_scans()
    adj = tj.label_adjacency(_t(p1), _t(l1), _t(m1), threshold=4.0, subsample_every=3)
    jadj = jj.label_adjacency(jnp.asarray(p1), jnp.asarray(l1), jnp.asarray(m1), threshold=4.0,
                              subsample_every=3)
    assert tj.auto_join_policy(adj) == jj.auto_join_policy(jadj)
    assert tj.auto_join_policy(adj, 3.2) == jj.auto_join_policy(jadj, 3.2)
    for kw in ({}, {"min_points": 700}, {"min_height": 5.0}):
        r = tj.rate_clusters(_t(p1), _t(l1), _t(m1), **kw)
        jr_ = jj.rate_clusters(jnp.asarray(p1), jnp.asarray(l1), jnp.asarray(m1), **kw)
        assert r.rating == jr_.rating
        _eq(r.labels, jr_.labels)
    r = tj.rate_clusters(_t(p1), _t(l1), _t(m1), rater=lambda lid, c: "g" if lid else "b")
    assert r.rating == {0: "b", 1: "g", 2: "g"}
    a = tj.merge_labeled_scans([_t(p1), _t(p2)], [_t(l1), _t(l2)], [_t(m1), _t(m2)])
    b = jj.merge_labeled_scans([jnp.asarray(p1), jnp.asarray(p2)],
                               [jnp.asarray(l1), jnp.asarray(l2)],
                               [jnp.asarray(m1), jnp.asarray(m2)])
    for x, y in zip(a, b):
        _eq(x, y)
    merged = a[1].numpy()
    dup = merged[len(p1):len(p1) + 600]
    assert len(np.unique(dup)) == 1 and dup[0] == merged[600]


def test_reconstruction_functions_equal():
    """``recover_by_trace``, ``recover_details``, ``transfer_attributes``
    (1-D and 2-D values) and ``voxel_overlap_mask`` equal."""
    rng = np.random.default_rng(3)
    full = rng.uniform(0, 2, (3000, 3)).astype(np.float32)
    fmask = rng.uniform(size=3000) < 0.95
    tp, tm, trace = tsm.voxel_downsample(_t(full), 0.1, _t(fmask))
    jp, jm, jtrace = jsm.voxel_downsample(jnp.asarray(full), 0.1, jnp.asarray(fmask))
    _eq(trace, jtrace)
    sel = (tp.numpy()[:, 2] > 1.0) & tm.numpy()
    _eq(tr.recover_by_trace(_t(sel), trace, _t(fmask)),
        jr.recover_by_trace(jnp.asarray(sel), jtrace, jnp.asarray(fmask)))
    for radius, k in ((0.05, 8), (0.12, 2)):
        _eq(tr.recover_details(tp, _t(sel), _t(full), _t(fmask), radius=radius, k=k),
            jr.recover_details(jp, jnp.asarray(sel), jnp.asarray(full), jnp.asarray(fmask),
                               radius=radius, k=k))
    vals1 = rng.normal(size=len(full)).astype(np.float32)
    vals2 = rng.integers(0, 5, (len(full), 2)).astype(np.int32)
    dst = (full + rng.normal(0, 0.01, full.shape)).astype(np.float32)
    dmask = rng.uniform(size=3000) < 0.9
    for vals in (vals1, vals2):
        a = tr.transfer_attributes(_t(full), _t(vals), _t(fmask), _t(dst), _t(dmask),
                                   radius=0.02)
        b = jr.transfer_attributes(jnp.asarray(full), jnp.asarray(vals), jnp.asarray(fmask),
                                   jnp.asarray(dst), jnp.asarray(dmask), radius=0.02)
        _eq(a[0], b[0])
        _eq(a[1], b[1])
    q = np.concatenate([full[:200] + 0.01, rng.uniform(5, 6, (50, 3))]).astype(np.float32)
    qm = np.ones(len(q), bool)
    _eq(tr.voxel_overlap_mask(_t(q), _t(qm), _t(full), _t(fmask), voxel=0.2),
        jr.voxel_overlap_mask(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(full),
                              jnp.asarray(fmask), voxel=0.2))


def test_voxel_keys_wrap_in_int32():
    """Negative and large cells: the hash's products wrap in int32, as the
    JAX package's do; membership equal across the wrap."""
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.uniform(-3000, 3000, (500, 3)),
                          rng.uniform(-1, 1, (200, 3))]).astype(np.float32)
    origin = np.array([-10.0, 7.5, -2000.0], np.float32)
    for voxel in (0.2, 0.01):
        ours = tr._voxel_keys(_t(pts), _t(origin), voxel).numpy()
        ref = np.asarray(jr._voxel_keys(jnp.asarray(pts), jnp.asarray(origin), voxel))
        np.testing.assert_array_equal(ours, ref)
        assert ours.dtype == np.int32 and (ours < 0).any()
    q = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    ones = np.ones(len(pts), bool)
    _eq(tr.voxel_overlap_mask(_t(q), _t(ones), _t(pts), _t(ones), voxel=0.01),
        jr.voxel_overlap_mask(jnp.asarray(q), jnp.asarray(ones), jnp.asarray(pts),
                              jnp.asarray(ones), voxel=0.01))
