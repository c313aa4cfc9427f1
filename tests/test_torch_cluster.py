"""Clustering of the PyTorch port against the JAX package on the CPU:
DBSCAN, cluster sizes, the top clusters and the largest-cluster mask
(equal), k-means given the JAX package's draws (labels equal, centres
within 1e-5), the silhouette score (within 1e-5) and the k sweep (the same
k). Inputs are numpy arrays from a seed, the same for both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.ops import cluster as jcl
from pyqsm_tpu_torch.ops import cluster as tcl


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class JaxDraws:
    """Stands in for ``ops/cluster.first_center``: the JAX package's draw of
    k-means' first centre, ``jax.random.choice(sub, n, p=mask/Σmask)``, with
    ``sub`` split from ``PRNGKey(generator.initial_seed())`` once a fit, in
    the order the JAX package splits (one key chain per generator)."""

    def __init__(self):
        self.chains = []  # [(generator, key)]

    def __call__(self, mask, generator):
        for i, (g, key) in enumerate(self.chains):
            if g is generator:
                break
        else:
            i, key = len(self.chains), jax.random.PRNGKey(generator.initial_seed())
            self.chains.append((generator, key))
        key, sub = jax.random.split(key)
        self.chains[i] = (generator, key)
        w = jnp.where(jnp.asarray(mask.cpu().numpy()), 1.0, 0.0)
        first = jax.random.choice(sub, mask.shape[0], p=w / jnp.maximum(jnp.sum(w), 1))
        return torch.tensor(int(first), device=mask.device)


@pytest.fixture
def jax_draws(monkeypatch):
    draws = JaxDraws()
    monkeypatch.setattr(tcl, "first_center", draws)
    return draws


def _blobs(rng, centers, n_per=150, scale=0.05):
    return np.concatenate([rng.normal(c, scale, size=(n_per, 3)) for c in centers]).astype(
        np.float32)


def _dbscan_plot(seed):
    """Three blobs, a small fourth one and isolated noise; 5 % of rows dead."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([_blobs(rng, [[0, 0, 0], [2, 0, 0], [0, 2, 0]]),
                          _blobs(rng, [[3, 0, 0]], n_per=50),
                          rng.uniform(3, 4, (5, 3)).astype(np.float32)])
    return pts, rng.uniform(size=len(pts)) < 0.95


@pytest.mark.parametrize("seed", [0, 1])
def test_dbscan_sizes_and_top_clusters_equal(seed):
    pts, m = _dbscan_plot(seed)
    lj = jcl.dbscan(jnp.asarray(pts), jnp.asarray(m), eps=0.3, min_samples=10, neighbor_cap=64)
    lt = tcl.dbscan(torch.as_tensor(pts), torch.as_tensor(m), eps=0.3, min_samples=10,
                    neighbor_cap=64)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert len(np.unique(lt.numpy())) == 5  # four clusters and noise
    np.testing.assert_array_equal(tcl.cluster_sizes(lt).numpy(),
                                  np.asarray(jcl.cluster_sizes(lj)))
    np.testing.assert_array_equal(tcl.top_clusters(lt, 3).numpy(),
                                  np.asarray(jcl.top_clusters(lj, 3)))
    _, mj = jcl.largest_cluster_mask(jnp.asarray(pts), jnp.asarray(m), 0.3, 10, 64)
    _, mt = tcl.largest_cluster_mask(torch.as_tensor(pts), torch.as_tensor(m), 0.3, 10, 64)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_top_clusters_ties_go_to_the_lower_id():
    """Equal sizes rank by ascending id, as ``lax.top_k`` ranks them; ids
    past the clusters pad with -1."""
    lab = np.array([1, 1, 0, 0, 2, 2, -1, 3, 3, 4], np.int32)
    for top in (1, 4, 10):
        np.testing.assert_array_equal(tcl.top_clusters(torch.as_tensor(lab), top).numpy(),
                                      np.asarray(jcl.top_clusters(jnp.asarray(lab), top)))


@pytest.mark.parametrize("n,k", [(450, 3), (3000, 20)])
def test_kmeans_and_silhouette_given_the_jax_draws(jax_draws, n, k):
    rng = np.random.default_rng(n)
    pts = (rng.normal(size=(n, 3)) * [1.5, 1.5, 3.0] + 5.0).astype(np.float32)
    m = rng.uniform(size=n) < 0.9
    _, sub = jax.random.split(jax.random.PRNGKey(k))
    cj, lj = jcl.kmeans(jnp.asarray(pts), jnp.asarray(m), k, sub)
    ct, lt = tcl.kmeans(torch.as_tensor(pts), torch.as_tensor(m), k,
                        torch.Generator().manual_seed(k))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    lab = np.array(lj)
    lab[::17] = -1  # unlabelled rows take no part
    sj = float(jcl.silhouette_score(jnp.asarray(pts), jnp.asarray(lab), jnp.asarray(m)))
    st = float(tcl.silhouette_score(torch.as_tensor(pts), torch.as_tensor(lab),
                                    torch.as_tensor(m)))
    assert abs(st - sj) <= 1e-5


def test_kmeans_sweep_picks_the_same_k(jax_draws):
    rng = np.random.default_rng(3)
    pts = _blobs(rng, [[0, 0, 0], [3, 0, 0], [0, 3, 0]])
    m = np.ones(len(pts), bool)
    aj = jcl.kmeans_sweep(jnp.asarray(pts), jnp.asarray(m), jax.random.PRNGKey(1),
                          k_range=(2, 3, 4, 5))
    at = tcl.kmeans_sweep(torch.as_tensor(pts), torch.as_tensor(m),
                          torch.Generator().manual_seed(1), k_range=(2, 3, 4, 5))
    assert at[2] == aj[2] == 3
    assert abs(at[3] - aj[3]) <= 1e-5
    np.testing.assert_array_equal(at[1].numpy(), np.asarray(aj[1]))
    # below min_silhouette both fall back to the smallest k, fitted anew
    bj = jcl.kmeans_sweep(jnp.asarray(pts), jnp.asarray(m), jax.random.PRNGKey(2),
                          k_range=(2, 3), min_silhouette=2.0)
    bt = tcl.kmeans_sweep(torch.as_tensor(pts), torch.as_tensor(m),
                          torch.Generator().manual_seed(2), k_range=(2, 3), min_silhouette=2.0)
    assert bt[2] == bj[2] == 2
    np.testing.assert_array_equal(bt[1].numpy(), np.asarray(bj[1]))


def test_first_center_draws_a_live_row_alike_for_a_seed():
    """The port's own draw: a live row, the same one for the same seed,
    whatever the row count of dead rows around it."""
    m = np.zeros(1000, bool)
    m[100:110] = True
    rows = [int(tcl.first_center(torch.as_tensor(m), torch.Generator().manual_seed(s)))
            for s in range(40)]
    assert all(100 <= r < 110 for r in rows) and len(set(rows)) > 1
    again = [int(tcl.first_center(torch.as_tensor(m), torch.Generator().manual_seed(s)))
             for s in range(40)]
    assert rows == again
    assert int(tcl.first_center(torch.zeros(5, dtype=torch.bool), torch.Generator())) in range(5)


@pytest.mark.parametrize("seed", [0, 1])
def test_dbscan_from_neighbors_binds_positional_calls_as_jax(seed):
    """The fifth parameter is the JAX package's unused ``neighbor_cap``, so a
    positional call written against it (min_samples 10, neighbor_cap 0,
    max_rounds 64) binds the same way and gives the same labels."""
    from pyqsm_tpu_torch.ops.neighbors import radius_knn

    pts, m = _dbscan_plot(seed)
    tp, tm = torch.as_tensor(pts), torch.as_tensor(m)
    d, i = radius_knn(tp, tp, 0.3, 64, query_mask=tm, point_mask=tm)
    lt = tcl.dbscan_from_neighbors(i, d, tm, 10, 0, 64)
    lj = jcl.dbscan_from_neighbors(jnp.asarray(i.numpy()), jnp.asarray(d.numpy()),
                                   jnp.asarray(m), 10, 0, 64)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert len(np.unique(lt.numpy())) > 2
    np.testing.assert_array_equal(lt.numpy(), tcl.dbscan_from_neighbors(
        i, d, tm, min_samples=10, neighbor_cap=0, max_rounds=64).numpy())
