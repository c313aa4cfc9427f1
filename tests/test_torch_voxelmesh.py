"""Parity of the port's surface reconstruction (``ops/voxelmesh``: density
splat + blur, marching tetrahedra, decimation, welding) with the JAX
package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.ops import voxelmesh as jv
from pyqsm_tpu.ops.mesh import mesh_properties as j_props
from pyqsm_tpu_torch.ops import voxelmesh as tv
from pyqsm_tpu_torch.ops.mesh import TriMesh, mesh_properties


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cloud(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v * [1.0, 1.3, 0.8] + rng.normal(0, 0.02, (n, 3))).astype(np.float32)


def _sphere_field(n=48, voxel=0.1, r0=1.5):
    """The analytic field of the JAX package's marching-tets test: r0 − |x|
    on a lattice, whose zero set is the sphere of radius r0."""
    lo = np.array([-2.4, -2.4, -2.4], np.float32)
    g = lo[0] + voxel * np.arange(n)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    return (r0 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)).astype(np.float32), lo, voxel


@pytest.mark.parametrize("blur_iters", [0, 2])
def test_density_grid_matches_jax(blur_iters):
    pts = _cloud(1)
    mask = np.random.default_rng(2).random(len(pts)) < 0.9
    lo, voxel, dims = np.array([-1.5, -1.8, -1.2], np.float32), 0.1, (30, 36, 24)
    ours = tv.density_grid(torch.as_tensor(pts), torch.as_tensor(mask), lo, voxel, *dims,
                           blur_iters=blur_iters).numpy()
    ref = np.asarray(jv.density_grid(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(lo),
                                     voxel, *dims, blur_iters=blur_iters))
    # counts are exact; the blur passes round as XLA's fused chain does
    np.testing.assert_array_equal(ours, ref)
    if blur_iters == 0:
        assert ours.sum() == mask.sum()  # every masked point lies inside the box


def test_cell_active_matches_jax():
    field, _, _ = _sphere_field(n=20, voxel=0.25)
    ours = tv._cell_active(torch.as_tensor(field), 0.0).numpy()
    ref = np.asarray(jv._cell_active(jnp.asarray(field.reshape(-1)), jnp.float32(0.0), 20, 20, 20))
    np.testing.assert_array_equal(ours, ref)


def test_marching_tetrahedra_sphere_field_matches_jax():
    field, lo, voxel = _sphere_field()
    ours = tv.marching_tetrahedra(torch.as_tensor(field), lo, voxel, iso=0.0)
    ref = jv.marching_tetrahedra(jnp.asarray(field), lo, voxel, iso=0.0)
    assert ours.n_triangles() == ref.n_triangles()
    np.testing.assert_array_equal(ours.triangles.numpy(), np.asarray(ref.triangles))
    # the same vertices in the same order; edge interpolation a + t·(b − a)
    # is one fused multiply-add in XLA's CPU code
    np.testing.assert_allclose(ours.vertices.numpy(), np.asarray(ref.vertices), rtol=0, atol=1e-5)
    area = mesh_properties(tv.weld_vertices(ours))["surface_area"]
    assert abs(area - 4 * np.pi * 1.5 ** 2) / (4 * np.pi * 1.5 ** 2) < 0.05


def test_marching_tetrahedra_chunks_keep_cell_order():
    field, lo, voxel = _sphere_field(n=24, voxel=0.2)
    whole = tv.marching_tetrahedra(torch.as_tensor(field), lo, voxel, iso=0.0)
    chunked = tv.marching_tetrahedra(torch.as_tensor(field), lo, voxel, iso=0.0, cell_chunk=100)
    assert torch.equal(whole.vertices, chunked.vertices)


def test_poisson_like_mesh_matches_jax():
    pts = _cloud(3)
    ours = tv.poisson_like_mesh(torch.as_tensor(pts), voxel=0.08, blur_iters=2)
    ref = jv.poisson_like_mesh(jnp.asarray(pts), voxel=0.08, blur_iters=2)
    assert ours.n_triangles() == ref.n_triangles() > 500
    a = mesh_properties(ours)["surface_area"]
    b = j_props(ref)["surface_area"]
    assert abs(a - b) <= 1e-4 * b  # float32 vertex differences of a few ulp


def test_poisson_like_mesh_empty_and_tiny():
    assert tv.poisson_like_mesh(torch.zeros(0, 3), mask=torch.zeros(0, dtype=torch.bool)) \
        .n_triangles() == 0
    tiny = np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)
    assert tv.poisson_like_mesh(torch.as_tensor(tiny)).n_triangles() == 0


@pytest.mark.parametrize("target", [400, 50_000])
def test_simplify_mesh_matches_jax(target):
    field, lo, voxel = _sphere_field()
    mt = jv.marching_tetrahedra(jnp.asarray(field), lo, voxel, iso=0.0)
    v, t = np.array(mt.vertices), np.array(mt.triangles)
    ours = tv.simplify_mesh(TriMesh(torch.as_tensor(v), torch.as_tensor(t)), target)
    ref = jv.simplify_mesh(mt, target)
    np.testing.assert_array_equal(ours.vertices.numpy(), np.asarray(ref.vertices))
    np.testing.assert_array_equal(ours.triangles.numpy(), np.asarray(ref.triangles))
    assert ours.n_triangles() <= max(target, len(t))


def test_weld_vertices_matches_jax():
    field, lo, voxel = _sphere_field(n=24, voxel=0.2)
    mt = jv.marching_tetrahedra(jnp.asarray(field), lo, voxel, iso=0.0)
    v, t = np.array(mt.vertices), np.array(mt.triangles)
    ours = tv.weld_vertices(TriMesh(torch.as_tensor(v), torch.as_tensor(t)))
    ref = jv.weld_vertices(mt)
    np.testing.assert_array_equal(ours.vertices.numpy(), np.asarray(ref.vertices))
    np.testing.assert_array_equal(ours.triangles.numpy(), np.asarray(ref.triangles))
    assert mesh_properties(ours) == j_props(ref)
