"""The port's sorted-grid index and grid queries (``ops/neighbors.py``:
``GridIndex``, ``build_grid``, ``grid_radius_knn``, ``grid_radius_any_k``,
``grid_self_radius_knn`` sorted and unsorted, ``max_cell_occupancy``,
``recommend_cell_cap``) against the JAX package on the CPU: the same
numpy clouds from a seed go through both, and every output is compared
for equality, distances bit for bit (the cases of tests/test_neighbors.py,
plus masks, cross-cloud queries and cells fuller than the cap)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.ops import neighbors as jn
from pyqsm_tpu_torch import convert
from pyqsm_tpu_torch.ops import neighbors as tn


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _eq(a, b):
    """Equal arrays; floats compared by their bits."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _cloud(seed=0, n=3000, clump=0):
    """tests/test_neighbors.py's cloud (uniform in a 5 m cube), with
    ``clump`` extra points packed into a few cells."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 5, size=(n, 3))
    if clump:
        pts = np.concatenate([pts, rng.normal(2.5, 0.03, (clump, 3))])
    return pts.astype(np.float32), rng


def _both(pts, cell, mask=None):
    j = jn.build_grid(jnp.asarray(pts), cell, None if mask is None else jnp.asarray(mask))
    t = tn.build_grid(torch.as_tensor(pts), cell, None if mask is None else torch.as_tensor(mask))
    return j, t


@pytest.mark.parametrize("masked", [False, True])
def test_build_grid_fields_equal(masked):
    pts, rng = _cloud(1)
    mask = rng.uniform(size=len(pts)) < 0.8 if masked else None
    j, t = _both(pts, 0.3, mask)
    for f in ("sorted_points", "sorted_idx", "sorted_cell", "origin", "dims"):
        _eq(getattr(t, f), getattr(j, f))
    assert t.cell_size == j.cell_size == 0.3


@pytest.mark.parametrize("clump", [0, 400])
def test_occupancy_and_cell_cap_equal(clump):
    pts, _ = _cloud(2, clump=clump)
    j, t = _both(pts, 0.3)
    _eq(tn.max_cell_occupancy(t), jn.max_cell_occupancy(j))
    assert tn.recommend_cell_cap(t) == jn.recommend_cell_cap(j) >= 8


# (cloud seed, clump rows, cell, radius, k, cell_cap, query mask, cloud mask):
# tests/test_neighbors.py's brute-force case, its masked index, a query mask,
# and cells fuller than the cap (the overflow rows are not candidates)
QUERIES = {"bruteforce": (3, 0, 0.3, 0.3, 12, None, False, False),
           "masked_index": (4, 0, 0.4, 0.4, 8, 64, False, True),
           "query_mask": (5, 0, 0.3, 0.25, 16, 16, True, False),
           "overflow": (6, 600, 0.3, 0.3, 24, 8, True, True)}


@pytest.mark.parametrize("case", list(QUERIES))
@pytest.mark.parametrize("fn", ["grid_radius_knn", "grid_radius_any_k"])
def test_grid_queries_bit_for_bit(case, fn):
    seed, clump, cell, r, k, cap, qmask, cmask = QUERIES[case]
    pts, rng = _cloud(seed, clump=clump)
    mask = rng.uniform(size=len(pts)) < 0.85 if cmask else None
    queries = rng.uniform(-0.2, 5.2, size=(400, 3)).astype(np.float32)
    queries[:50] = pts[:50]
    qm = rng.uniform(size=len(queries)) < 0.8 if qmask else None
    j, t = _both(pts, cell, mask)
    cap = jn.recommend_cell_cap(j) if cap is None else cap
    if case == "overflow":
        assert int(jn.max_cell_occupancy(j)) > cap
    jd, ji = getattr(jn, fn)(j, jnp.asarray(queries), r, k,
                             None if qm is None else jnp.asarray(qm), cell_cap=cap)
    td, ti = getattr(tn, fn)(t, torch.as_tensor(queries), r, k,
                             None if qm is None else torch.as_tensor(qm), cell_cap=cap)
    _eq(ti, ji)
    _eq(td, jd)
    assert (ti >= 0).sum() > len(queries)


@pytest.mark.parametrize("fn", ["grid_radius_knn", "grid_radius_any_k"])
def test_radius_above_cell_size_raises(fn):
    pts, _ = _cloud(7)
    _, t = _both(pts, 0.2)
    with pytest.raises(ValueError):
        getattr(tn, fn)(t, torch.as_tensor(pts[:8]), 0.5, 8)


# (seed, clump, radius, k, max_bucket, masked): the JAX default (sort=True)
# self query on a uniform cloud, with a mask, with k past most rows'
# neighbour count, and over cells fuller than the bucket
SELF = {"uniform": (8, 0, 0.3, 16, 64, False), "masked": (9, 0, 0.35, 12, 64, True),
        "wide_k": (10, 0, 0.3, 40, 64, False), "overflow": (11, 300, 0.3, 16, 16, True)}


@pytest.mark.parametrize("case", list(SELF))
def test_self_query_sorted_bit_for_bit(case):
    seed, clump, r, k, mb, masked = SELF[case]
    pts, rng = _cloud(seed, n=1500, clump=clump)
    mask = rng.uniform(size=len(pts)) < 0.85 if masked else None
    jd, ji = jn.grid_self_radius_knn(jnp.asarray(pts), r, k,
                                     None if mask is None else jnp.asarray(mask), max_bucket=mb)
    td, ti = tn.grid_self_radius_knn(torch.as_tensor(pts), r, k,
                                     None if mask is None else torch.as_tensor(mask),
                                     max_bucket=mb)
    _eq(ti, ji)
    _eq(td, jd)
    live = ti[:, 0] >= 0
    assert live.sum() > len(pts) // 2
    d = td.numpy()
    assert (np.diff(np.where(np.isfinite(d), d, 1e9), axis=1) >= 0).all()


@pytest.mark.parametrize("need_dists", [True, False])
def test_self_query_unsorted_unchanged(need_dists):
    """``sort=False`` (the bucket rows the isolation and joining paths
    call) still equals the JAX package's."""
    pts, rng = _cloud(12, n=1500, clump=30)
    mask = rng.uniform(size=len(pts)) < 0.9
    jd, ji = jn.grid_self_radius_knn(jnp.asarray(pts), 0.3, 16, jnp.asarray(mask), sort=False,
                                     need_dists=need_dists)
    td, ti = tn.grid_self_radius_knn(torch.as_tensor(pts), 0.3, 16, torch.as_tensor(mask),
                                     sort=False, need_dists=need_dists)
    _eq(ti, ji)
    _eq(td, jd)


def test_jax_index_carried_across():
    """A JAX ``GridIndex`` crosses over through ``convert`` and answers the
    same queries as in the JAX package."""
    pts, rng = _cloud(13)
    j = jn.build_grid(jnp.asarray(pts), 0.3)
    t = convert.grid_index_from_jax(
        {f.name: np.asarray(getattr(j, f.name)) for f in dataclasses.fields(j)}, device="cpu")
    assert isinstance(t, tn.GridIndex) and t.cell_size == 0.3
    q = rng.uniform(0, 5, size=(300, 3)).astype(np.float32)
    jd, ji = jn.grid_radius_knn(j, jnp.asarray(q), 0.3, 12, cell_cap=jn.recommend_cell_cap(j))
    td, ti = tn.grid_radius_knn(t, torch.as_tensor(q), 0.3, 12, cell_cap=tn.recommend_cell_cap(t))
    _eq(ti, ji)
    _eq(td, jd)
