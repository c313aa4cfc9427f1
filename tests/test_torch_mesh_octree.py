"""The port's scipy meshes, ``map_density``, octree, ``clean_cloud`` and
geometry helpers (``ops/mesh.py``, ``ops/octree.py``, ``ops/outliers.py``,
``ops/geometry.py``) against the JAX package on the CPU, on the inputs of
tests/test_raytrace.py:113-131 and tests/test_misc_parity.py:27-100 made
from a seed: meshes array for array (triangle order included), octree
leaves and paths, masks and traces equal; centres and radii within 1e-6
relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.ops import geometry as jg
from pyqsm_tpu.ops import mesh as jm
from pyqsm_tpu.ops import octree as jo
from pyqsm_tpu.ops import outliers as jout
from pyqsm_tpu_torch.ops import geometry as tg
from pyqsm_tpu_torch.ops import mesh as tm
from pyqsm_tpu_torch.ops import octree as to
from pyqsm_tpu_torch.ops import outliers as tout


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
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype.kind == "f":
        a, b = a.view(np.int32 if a.itemsize == 4 else np.int64), b.view(
            np.int32 if b.itemsize == 4 else np.int64)
    np.testing.assert_array_equal(a, b)


def _same_mesh(t, j):
    _eq(t.vertices, j.vertices)
    _eq(t.triangles, j.triangles)


def _port_mesh(j):
    return tm.TriMesh(torch.as_tensor(np.array(j.vertices)), torch.as_tensor(np.array(j.triangles)))


def _roof(seed=0, n=500):
    """tests/test_raytrace.py:113's 2 × 2 roof."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0, 2, (n, 2)), rng.uniform(0.9, 1.1, (n, 1))],
                          1).astype(np.float32)


def _sphere_cloud(seed=0, n=800):
    """tests/test_raytrace.py:124's unit-sphere samples."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, n)
    ph = np.arccos(rng.uniform(-1, 1, n))
    return np.stack([np.sin(ph) * np.cos(th), np.sin(ph) * np.sin(th), np.cos(ph)],
                    1).astype(np.float32)


@pytest.mark.parametrize("max_edge,masked", [(0.5, False), (None, False), (0.3, True)])
def test_canopy_surface_mesh_equal(max_edge, masked):
    pts = _roof(1)
    mask = np.random.default_rng(2).uniform(size=len(pts)) < 0.7 if masked else None
    j = jm.canopy_surface_mesh(pts, mask=mask, max_edge=max_edge)
    t = tm.canopy_surface_mesh(pts, mask=mask, max_edge=max_edge, device="cpu")
    _same_mesh(t, j)
    assert t.n_triangles() > 100


@pytest.mark.parametrize("alpha", [1.5, 0.4])
def test_alpha_complex_mesh_equal(alpha):
    pts = _sphere_cloud(3)
    _same_mesh(tm.alpha_complex_mesh(pts, alpha, device="cpu"), jm.alpha_complex_mesh(pts, alpha))


def test_small_inputs_give_the_empty_mesh():
    pts = _roof(4, n=3)
    for t, j in ((tm.canopy_surface_mesh(pts[:2], device="cpu"), jm.canopy_surface_mesh(pts[:2])),
                 (tm.alpha_complex_mesh(pts, 1.0, device="cpu"), jm.alpha_complex_mesh(pts, 1.0))):
        _same_mesh(t, j)
        assert t.n_triangles() == 0


@pytest.mark.parametrize("min_triangles", [1, 48])
def test_surface_clusters_equal(min_triangles):
    """tests/test_misc_parity.py:27's two spheres."""
    j = jm.merge_meshes([jm.sphere_mesh(jnp.array([0.0, 0, 0]), 1.0, n_lat=6, n_lon=8),
                         jm.sphere_mesh(jnp.array([5.0, 0, 0]), 0.5, n_lat=4, n_lon=6)])
    jl, jf = jm.surface_clusters(j, min_triangles)
    tl, tf = tm.surface_clusters(_port_mesh(j), min_triangles)
    _eq(tl, jl)
    _same_mesh(tf, jf)


@pytest.mark.parametrize("cut", [0.8, 0.3])
def test_fill_holes_equal(cut):
    """tests/test_misc_parity.py:84's sphere with its cap cut away, and a
    second cut so that two loops close: new vertices and triangles in the
    JAX package's order."""
    j = jm.sphere_mesh(jnp.array([0.0, 0, 0.0]), 1.0, n_lat=10, n_lon=16)
    v, t = np.asarray(j.vertices), np.asarray(j.triangles)
    c = v[t].mean(1)
    keep = (c[:, 2] < cut) & (c[:, 0] < 0.7)
    holed = j._replace(triangles=jnp.asarray(t[keep]))
    out = tm.fill_holes(_port_mesh(holed))
    _same_mesh(out, jm.fill_holes(holed))
    assert out.vertices.shape[0] > v.shape[0]
    assert tm.mesh_properties(out)["watertight"]


@pytest.mark.parametrize("pctile", [0.0, 60.0, 10.0, 33.3])
def test_map_density_equal(pctile):
    """tests/test_misc_parity.py:59's hemisphere cloud against a sphere:
    densities, colours and the trimmed triangles equal."""
    j = jm.sphere_mesh(jnp.array([0.0, 0, 0.0]), 1.0, n_lat=8, n_lon=16)
    rng = np.random.default_rng(5)
    v = rng.normal(size=(4000, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 2] = np.abs(v[:, 2])
    v = v.astype(np.float32)
    mask = rng.uniform(size=len(v)) < 0.9
    jd, jc, jt = jm.map_density(j, jnp.asarray(v), jnp.asarray(mask), radius=0.25,
                                density_threshold_pctile=pctile)
    td, tc, tt = tm.map_density(_port_mesh(j), torch.as_tensor(v), torch.as_tensor(mask),
                                radius=0.25, density_threshold_pctile=pctile)
    _eq(td, jd)
    _eq(tc, jc)
    _same_mesh(tt, jt)
    if pctile == 60.0:  # below it the empty hemisphere's zeros set the threshold
        assert 0 < tt.n_triangles() < j.triangles.shape[0]


def test_octree_leaves_and_paths_equal():
    """tests/test_misc_parity.py:42's cloud: every leaf (centre, half,
    depth, rows) in the same order, and the containing paths."""
    rng = np.random.default_rng(6)
    pts = rng.uniform(0, 10, (5000, 3))
    jr, tr = jo.build_octree(pts, max_depth=5, stop_below=250), to.build_octree(
        torch.as_tensor(pts), max_depth=5, stop_below=250)
    jl, tl = jo.leaves(jr), to.leaves(tr)
    assert len(tl) == len(jl) > 8
    for a, b in zip(tl, jl):
        _eq(a.center, b.center)
        assert (a.half, a.depth) == (b.half, b.depth)
        _eq(a.indices, b.indices)
    for row in (0, 123, 4999):
        jp, tp = jo.containing_path(jr, pts[row]), to.containing_path(tr, torch.as_tensor(pts[row]))
        assert [(n.depth, tuple(n.center)) for n in tp] == [(n.depth, tuple(n.center)) for n in jp]


@pytest.mark.parametrize("voxel", [0.04, 0.0])
def test_clean_cloud_equal(voxel):
    """Points, mask and trace of the reference's clean policy: a branch
    with scattered outliers, voxelized at 0.04 m or not at all."""
    rng = np.random.default_rng(7)
    th = rng.uniform(0, 2 * np.pi, 3000)
    z = rng.uniform(0, 3, 3000)
    pts = np.stack([0.3 * np.cos(th), 0.3 * np.sin(th), z], 1)
    pts = np.concatenate([pts, rng.uniform(-1.5, 1.5, (60, 3))]).astype(np.float32)
    mask = rng.uniform(size=len(pts)) < 0.95
    jp, jmask, jtr = jout.clean_cloud(jnp.asarray(pts), jnp.asarray(mask), voxel_size=voxel)
    tp, tmask, ttr = tout.clean_cloud(torch.as_tensor(pts), torch.as_tensor(mask),
                                      voxel_size=voxel)
    _eq(tp, jp)
    _eq(tmask, jmask)
    _eq(ttr, jtr)
    assert 0 < int(tmask.sum()) < int(mask.sum())


@pytest.mark.parametrize("method", ["centroid", "top", "bottom"])
def test_get_center_and_radius_within_1e6(method):
    rng = np.random.default_rng(8)
    pts = (rng.normal(size=(5000, 3)) * [0.4, 0.3, 2.0] + [10.0, -4.0, 3.0]).astype(np.float32)
    mask = rng.uniform(size=len(pts)) < 0.8
    P, M = torch.as_tensor(pts), torch.as_tensor(mask)
    np.testing.assert_allclose(tg.get_center(P, M, method).numpy(),
                               np.asarray(jg.get_center(jnp.asarray(pts), jnp.asarray(mask),
                                                        method)), rtol=1e-6)
    np.testing.assert_allclose(float(tg.get_radius(P, M)),
                               float(jg.get_radius(jnp.asarray(pts), jnp.asarray(mask))),
                               rtol=1e-6)
    with pytest.raises(ValueError):
        tg.get_center(P, M, "middle")


@pytest.mark.parametrize("args", [((0.0, 0.0), (12.0, 9.0)), ((-3.5, 2.0), (4.0, 7.5), 3, 2, 0.1)])
def test_generate_grid_equal(args):
    assert tg.generate_grid(*args) == jg.generate_grid(*args)
