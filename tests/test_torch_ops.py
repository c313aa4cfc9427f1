"""Parity of the PyTorch port's sampling, neighbor, cluster, outlier and
geometry ops with the JAX package, on the CPU. The same numpy inputs go
through both. Ids, labels, masks, voxel traces and orders must be EQUAL;
floats carry the tolerance stated at each assertion."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.ops import cluster as jc
from pyqsm_tpu.ops import geometry as jg
from pyqsm_tpu.ops import linalg3 as jl
from pyqsm_tpu.ops import neighbors as jn
from pyqsm_tpu.ops import outliers as jo
from pyqsm_tpu.ops import sampling as js
from pyqsm_tpu.ops import sparse as jsp
from pyqsm_tpu_torch.ops import cluster as tc
from pyqsm_tpu_torch.ops import geometry as tg
from pyqsm_tpu_torch.ops import linalg3 as tl
from pyqsm_tpu_torch.ops import neighbors as tn
from pyqsm_tpu_torch.ops import outliers as to
from pyqsm_tpu_torch.ops import sampling as ts
from pyqsm_tpu_torch.ops import sparse as tsp


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cloud(seed, n=2000, scale=1.0, dead=0.1):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    return pts, rng.random(n) > dead


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("voxel", [0.05, 0.3, 1.0])
def test_voxel_downsample(voxel):
    pts, m = _cloud(1)
    a = js.voxel_downsample(jnp.asarray(pts), voxel, jnp.asarray(m))
    b = ts.voxel_downsample(torch.as_tensor(pts), voxel, torch.as_tensor(m))
    _eq(a[1], b[1])  # representative mask
    _eq(a[2], b[2])  # trace
    # centroids: index_add_ and segment_sum both sum in row order on the CPU
    np.testing.assert_allclose(np.asarray(a[0]), b[0].numpy(), rtol=0, atol=1e-6)


def test_voxel_batch_count_and_compaction():
    pts, m = _cloud(2)
    pb = np.stack([pts, 1.5 * pts, pts + 3])
    mb = np.stack([m, ~m, np.ones_like(m)])
    v = np.array([0.2, 0.5, 0.09], np.float32)
    _eq(js.voxel_count_batch(jnp.asarray(pb), jnp.asarray(v), jnp.asarray(mb)),
        ts.voxel_count_batch(torch.as_tensor(pb), torch.as_tensor(v), torch.as_tensor(mb)))
    a = js.voxel_downsample_batch(jnp.asarray(pb), jnp.asarray(v), jnp.asarray(mb))
    b = ts.voxel_downsample_batch(torch.as_tensor(pb), torch.as_tensor(v), torch.as_tensor(mb))
    _eq(a[1], b[1])
    _eq(a[2], b[2])
    np.testing.assert_allclose(np.asarray(a[0]), b[0].numpy(), rtol=0, atol=1e-6)
    for x, y in zip(js.compact_rows_batch(a[0], a[1]), ts.compact_rows_batch(b[0], b[1])):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=0, atol=1e-6)
    for x, y in zip(js.compact_rows(jnp.asarray(pts), jnp.asarray(m), jnp.arange(2000, dtype=jnp.int32)),
                    ts.compact_rows(torch.as_tensor(pts), torch.as_tensor(m),
                                    torch.arange(2000, dtype=torch.int32))):
        _eq(x, y)


@pytest.mark.parametrize("cap", [8, 64])
def test_label_segments_and_rows(cap):
    rng = np.random.default_rng(3)
    lab = rng.integers(-1, 20, 3000).astype(np.int32)
    a = js.label_segments(jnp.asarray(lab), cap)
    b = ts.label_segments(torch.as_tensor(lab), cap)
    for x, y in zip(a, b):
        _eq(x, y)
    kept = np.array([3, 7, 1, 19], np.int32)
    _eq(js.rows_for_labels(a[0], a[1], jnp.asarray(kept), 256),
        ts.rows_for_labels(b[0], b[1], torch.as_tensor(kept), 256))
    mask = lab > 10
    _eq(js.nonzero_rows(jnp.asarray(mask), cap), ts.nonzero_rows(torch.as_tensor(mask), cap))


@pytest.mark.parametrize("start", [0, 17])
def test_farthest_point_sampling(start):
    pts, m = _cloud(4, n=1500)
    _eq(js.farthest_point_sampling(jnp.asarray(pts), 96, jnp.asarray(m), start=start),
        ts.farthest_point_sampling(torch.as_tensor(pts), 96, torch.as_tensor(m), start=start))


@pytest.mark.parametrize("k", [1, 9, 33])
def test_knn_ids_equal(k):
    pts, m = _cloud(5, scale=3.0)
    q, qm = _cloud(6, n=700, scale=3.0)
    da, ia = jn.knn(jnp.asarray(q), jnp.asarray(pts), k, jnp.asarray(qm), jnp.asarray(m))
    db, ib = tn.knn(torch.as_tensor(q), torch.as_tensor(pts), k, torch.as_tensor(qm),
                    torch.as_tensor(m))
    _eq(ia, ib)
    # same d² arithmetic (FMA-emulated norms, one GEMM); the square roots
    # may round apart by an ulp
    np.testing.assert_allclose(np.asarray(da), db.numpy(), rtol=1e-6, atol=0)


def test_knn_ties_go_to_lower_index():
    """Exact duplicates (equal distances) rank by ascending index, as
    lax.top_k ranks them; padding is (inf, -1) with fewer live points."""
    base = np.random.default_rng(7).normal(size=(40, 3)).astype(np.float32)
    pts = np.concatenate([base, base, base])  # every point three times
    d_j, i_j = jn.knn(jnp.asarray(pts), jnp.asarray(pts), 7)
    d_t, i_t = tn.knn(torch.as_tensor(pts), torch.as_tensor(pts), 7)
    _eq(i_j, i_t)
    few = np.zeros(120, bool)
    few[:3] = True
    _, i_j = jn.knn(jnp.asarray(pts), jnp.asarray(pts), 5, point_mask=jnp.asarray(few))
    d_t, i_t = tn.knn(torch.as_tensor(pts), torch.as_tensor(pts), 5,
                      point_mask=torch.as_tensor(few))
    _eq(i_j, i_t)
    assert (i_t[:, 3:] == -1).all() and torch.isinf(d_t[:, 3:]).all()


@pytest.mark.parametrize("radius", [0.2, 0.6])
def test_radius_knn_and_count(radius):
    pts, m = _cloud(8)
    P, M = jnp.asarray(pts), jnp.asarray(m)
    tP, tM = torch.as_tensor(pts), torch.as_tensor(m)
    _eq(jn.radius_knn(P, P, radius, 32, M, M)[1], tn.radius_knn(tP, tP, radius, 32, tM, tM)[1])
    _eq(jn.radius_count(P, P, radius, M, M), tn.radius_count(tP, tP, radius, tM, tM))
    w = np.random.default_rng(9).integers(1, 5, len(pts)).astype(np.float32)
    # integer-valued weights: f32 sums exact in any order
    _eq(jn.radius_count(P, P, radius, M, M, weights=jnp.asarray(w)),
        tn.radius_count(tP, tP, radius, tM, tM, weights=torch.as_tensor(w)))


@pytest.mark.parametrize("approx", [False, True])
def test_knn_in_the_jax_positional_form(approx):
    """``knn(q, p, k, qm, pm, query_tile, candidate_tile, approx)`` as a
    caller of the JAX package writes it: the tiles change nothing, and
    ``approx=True`` is the exact query on the CPU in both packages."""
    pts, m = _cloud(5, scale=3.0)
    q, qm = _cloud(6, n=700, scale=3.0)
    da, ia = jn.knn(jnp.asarray(q), jnp.asarray(pts), 9, jnp.asarray(qm), jnp.asarray(m),
                    256, 512, approx)
    db, ib = tn.knn(torch.as_tensor(q), torch.as_tensor(pts), 9, torch.as_tensor(qm),
                    torch.as_tensor(m), 256, 512, approx)
    _eq(ia, ib)
    np.testing.assert_allclose(np.asarray(da), db.numpy(), rtol=1e-6, atol=0)
    dc, ic = tn.knn(torch.as_tensor(q), torch.as_tensor(pts), 9, torch.as_tensor(qm),
                    torch.as_tensor(m))
    assert torch.equal(ib, ic) and torch.equal(db, dc)


def test_radius_count_tiles_and_weights_positional():
    """The JAX package's sixth and seventh positions are the tiles and its
    eighth ``weights``: a positional call counts the same in both."""
    pts, m = _cloud(8)
    P, M = jnp.asarray(pts), jnp.asarray(m)
    tP, tM = torch.as_tensor(pts), torch.as_tensor(m)
    w = np.random.default_rng(9).integers(1, 5, len(pts)).astype(np.float32)
    _eq(jn.radius_count(P, P, 0.4, M, M, 256, 512), tn.radius_count(tP, tP, 0.4, tM, tM, 256, 512))
    # integer-valued weights: f32 sums exact in any order
    _eq(jn.radius_count(P, P, 0.4, M, M, 256, 512, jnp.asarray(w)),
        tn.radius_count(tP, tP, 0.4, tM, tM, 256, 512, torch.as_tensor(w)))


@pytest.mark.parametrize("k", [4, 16, 24])
def test_grid_self_radius_any_k(k):
    pts, m = _cloud(10, n=3000, scale=1.5)
    _, ia = jn.grid_self_radius_knn(jnp.asarray(pts), 0.3, k, jnp.asarray(m), sort=False,
                                    need_dists=False)
    _, ib = tn.grid_self_radius_knn(torch.as_tensor(pts), 0.3, k, torch.as_tensor(m),
                                    sort=False, need_dists=False)
    _eq(ia, ib)


@pytest.mark.parametrize("q", [(0.0, 4.0), (4.0, 100.0), (3.0, 10.0)])
def test_percentile_mask(q):
    pts, m = _cloud(11, n=5000)
    z, tz = jnp.asarray(pts[:, 2]), torch.as_tensor(pts[:, 2])
    _eq(jg.percentile_mask(z, jnp.asarray(m), *q), tg.percentile_mask(tz, torch.as_tensor(m), *q))
    for p in q:
        _eq(jg.masked_percentile(z, jnp.asarray(m), p), tg.masked_percentile(tz, torch.as_tensor(m), p))


def test_zoom_mask_and_morton():
    pts, m = _cloud(12, scale=3.0)
    region = [[-1.0, -2.0], [1.5, 0.5]]
    _eq(jg.zoom_mask(jnp.asarray(pts), jnp.asarray(m), jnp.asarray(region), reverse=True),
        tg.zoom_mask(torch.as_tensor(pts), torch.as_tensor(m), region, reverse=True))
    _eq(jsp.morton_codes(jnp.asarray(pts), jnp.asarray(m)),
        tsp.morton_codes(torch.as_tensor(pts), torch.as_tensor(m)))


def test_obb_clamp_and_eig():
    pts, m = _cloud(13)
    pts = pts * np.array([3.0, 1.0, 0.3], np.float32)
    a = jg.obb_axes(jnp.asarray(pts), jnp.asarray(m))
    b = tg.obb_axes(torch.as_tensor(pts), torch.as_tensor(m))
    # covariance sums in another order: frames agree to ~1e-5
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), rtol=0, atol=2e-5)
    ca = jg.clamp_to_obb(jnp.asarray(pts * 1.2), *a)
    cb = tg.clamp_to_obb(torch.as_tensor(pts * 1.2), *b)
    np.testing.assert_allclose(np.asarray(ca), cb.numpy(), rtol=0, atol=1e-4)
    rng = np.random.default_rng(14)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A + A.transpose(0, 2, 1)
    va, wa = jl.sym_eig3(jnp.asarray(A))
    vb, wb = tl.sym_eig3(torch.as_tensor(A))
    np.testing.assert_allclose(np.asarray(va), vb.numpy(), rtol=0, atol=1e-4)
    # eigenvectors up to sign, f32 closed form
    np.testing.assert_allclose(np.abs(np.sum(np.asarray(wa) * wb.numpy(), axis=1)), 1.0, atol=1e-3)


@pytest.mark.parametrize("nb", [8, 16])
def test_statistical_outlier_mask(nb):
    pts, m = _cloud(15)
    pts[:20] *= 8  # far outliers
    _eq(jo.statistical_outlier_mask(jnp.asarray(pts), jnp.asarray(m), nb, 2.0),
        to.statistical_outlier_mask(torch.as_tensor(pts), torch.as_tensor(m), nb, 2.0))


@pytest.mark.parametrize("min_samples", [3, 8])
def test_dbscan_and_components(min_samples):
    pts, m = _cloud(16, n=2500, scale=2.0)
    d, i = jn.radius_knn(jnp.asarray(pts), jnp.asarray(pts), 0.35, 32, jnp.asarray(m), jnp.asarray(m))
    ti = torch.as_tensor(np.array(i))
    lab_j = jc.dbscan_from_neighbors(i, d, jnp.asarray(m), min_samples=min_samples)
    lab_t = tc.dbscan_from_neighbors(ti, None, torch.as_tensor(m), min_samples=min_samples)
    _eq(lab_j, lab_t)
    assert len(np.unique(lab_t.numpy())) > 2
    valid = np.asarray(i) >= 0
    _eq(jc.connected_components(i, jnp.asarray(valid), jnp.asarray(m)),
        tc.connected_components(ti, torch.as_tensor(valid), torch.as_tensor(m)))
