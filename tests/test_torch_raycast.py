"""Parity of the port's ray-casting slice with the JAX package on the CPU:
the fused closest-hit cast (``ops/mt_raycast``) against the Pallas kernel in
interpret mode and the XLA tiled cast, ``cast_rays`` routing, the hit list,
the derived queries, the parallel-bundle grid and the ``models/raycast``
entry points. Kernel tests that need a card are marked ``gpu``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.config import RaycastConfig as JRaycastConfig
from pyqsm_tpu.models import raycast as jmr
from pyqsm_tpu.ops import mesh as jm
from pyqsm_tpu.ops import raygrid as jg
from pyqsm_tpu.ops import raytrace as jr
from pyqsm_tpu.ops.pallas_kernels import mt_raycast as mt_raycast_pallas
from pyqsm_tpu.ops.voxelmesh import poisson_like_mesh as j_poisson
from pyqsm_tpu.ops.voxelmesh import simplify_mesh as j_simplify
from pyqsm_tpu_torch.config import RaycastConfig
from pyqsm_tpu_torch.convert import hits_to_numpy, mesh_from_numpy
from pyqsm_tpu_torch.models import raycast as tmr
from pyqsm_tpu_torch.ops import mesh as tm
from pyqsm_tpu_torch.ops import mt_raycast as tmt
from pyqsm_tpu_torch.ops import raygrid as tg
from pyqsm_tpu_torch.ops import raytrace as tr
from pyqsm_tpu_torch.ops.voxelmesh import poisson_like_mesh, simplify_mesh


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x)


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _sphere_cyl():
    """The sphere + cylinder scene of the JAX package's kernel test."""
    return jm.merge_meshes([
        jm.sphere_mesh(jnp.array([0.0, 0, 0]), 1.0, n_lat=8, n_lon=16),
        jm.cylinder_mesh(jnp.array([2.0, 0, 0]), jnp.array([0.0, 0, 1]), 0.4, 2.0),
    ])


def _scene(name):
    """(vertices, triangles, origins, dirs) as numpy arrays."""
    if name in ("sphere_cyl", "padded"):
        mesh = _sphere_cyl()
        o, d = jr.pinhole_rays(jnp.array([0.0, 0, 8.0]), jnp.array([1.0, 0, 0]),
                               jnp.array([0.0, 1, 0]), 70.0, 64, 48)
        v, t = _np(mesh.vertices), _np(mesh.triangles)
        if name == "padded":  # padding rows inside and at the end of the list
            pad = np.full((5, 3), -1, np.int32)
            t = np.concatenate([t[:100], pad, t[100:], pad])
        return v, t, _np(o), _np(d)
    if name == "empty":
        o = np.zeros((8, 3), np.float32)
        d = np.tile(np.array([[0.0, 0, 1.0]], np.float32), (8, 1))
        return np.zeros((3, 3), np.float32), np.full((4, 3), -1, np.int32), o, d
    # two coplanar triangles sharing the diagonal of the unit square; rays
    # on a dyadic grid (exact arithmetic), some on the shared edge itself,
    # where both triangles are hit at the same t and the lower id must win
    v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    t = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    g = (np.arange(8) + 0.5) / 8
    xy = np.concatenate([np.stack(np.meshgrid(g, g), -1).reshape(-1, 2),
                         np.stack([g, g], 1)])
    o = np.concatenate([xy, np.full((len(xy), 1), 2.0)], 1).astype(np.float32)
    d = np.tile(np.array([[0.0, 0, -1.0]], np.float32), (len(o), 1))
    return v, t, o, d


SCENES = ["sphere_cyl", "padded", "empty", "coplanar"]


def _near_shared_edge(uv, tri, tol=1e-5):
    """Rays whose hit lies within ``tol`` (barycentric) of a triangle edge:
    there an ulp of fused vs unfused multiply-adds may pick the neighbour."""
    u, v = uv[:, 0], uv[:, 1]
    return (tri >= 0) & (np.minimum(np.minimum(u, v), 1 - u - v) < tol)


def _assert_hits_match(t, tri, uv, cnt, ref_t, ref_tri, ref_uv, ref_cnt):
    hit = np.isfinite(ref_t)
    np.testing.assert_array_equal(np.isfinite(t), hit)  # the same rays hit
    # t in direction units: the XLA CPU cast fuses multiply-adds, the port
    # does not; a few ulp of t
    np.testing.assert_allclose(t[hit], ref_t[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(cnt, ref_cnt)
    edge = _near_shared_edge(ref_uv, ref_tri)
    np.testing.assert_array_equal(tri[~edge], ref_tri[~edge])
    assert (tri[hit] >= 0).all()


@pytest.mark.parametrize("scene", SCENES)
def test_mt_raycast_plain_matches_pallas_and_xla(scene):
    v, t, o, d = _scene(scene)
    ours = [x.numpy() for x in tmt.mt_raycast(_t(o), _t(d), _t(v), _t(t))]
    pal = [_np(x) for x in mt_raycast_pallas(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v),
                                             jnp.asarray(t), ray_tile=512, tri_chunk=256,
                                             interpret=True)]
    xla = jr._cast_rays_xla(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v), jnp.asarray(t))
    _assert_hits_match(*ours, *pal)
    _assert_hits_match(*ours, *(_np(x) for x in xla))
    miss = ~np.isfinite(ours[0])
    assert (ours[1][miss] == -1).all() and (ours[2][miss] == 0).all()
    if scene == "coplanar":  # the shared-edge rays: both counted, lower id wins
        diag = slice(64, None)
        assert (ours[3][diag] == 2).all() and (ours[1][diag] == 0).all()
        np.testing.assert_array_equal(ours[1], _np(xla.tri))
    if scene == "empty":
        assert not np.isfinite(ours[0]).any() and (ours[3] == 0).all()


@pytest.mark.parametrize("scene", ["padded", "coplanar"])
def test_mt_raycast_plain_tiling_keeps_the_lowest_id(scene):
    """Any ray and triangle tiling gives the one-tile answer: the running
    closest hit across triangle tiles (strict ``<``) keeps the lowest id on
    equal t; duplicated triangles put every tie across a tile boundary."""
    v, t, o, d = _scene(scene)
    if scene == "coplanar":
        t = np.concatenate([t, t])  # ids 2, 3 tie with 0, 1 in the next tile
    args = (_t(o), _t(d), _t(v), _t(t))
    whole = tmt.mt_raycast_plain(*args, ray_tile=len(o), tri_tile=len(t))
    for rt, tt in ((37, 64), (len(o), 2), (1000, 1)):
        for a, b in zip(tmt.mt_raycast_plain(*args, ray_tile=rt, tri_tile=tt), whole):
            assert torch.equal(a, b)
    if scene == "coplanar":
        assert int(whole[1].max()) <= 1  # a tie never goes to the later copy


@pytest.mark.parametrize("backend", ["plain", "kernel", "auto"])
def test_cast_rays_backends_match_jax(backend):
    v, t, o, d = _scene("padded")
    h = tr.cast_rays(_t(o), _t(d), _t(v), _t(t), backend=backend)
    ref = jr.cast_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v), jnp.asarray(t))
    hn = hits_to_numpy(h)
    _assert_hits_match(hn["t"], hn["tri"], hn["uv"], hn["count"], *(_np(x) for x in ref))


def test_list_intersections_matches_jax():
    v, t, o, d = _scene("padded")
    hl = tr.list_intersections(_t(o), _t(d), _t(v), _t(t), max_hits=4, tri_tile=128)
    ref = jr.list_intersections(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v),
                                jnp.asarray(t), max_hits=4, tri_tile=128)
    np.testing.assert_array_equal(hl.count.numpy(), _np(ref.count))  # exact past K
    rt, ot = _np(ref.t), hl.t.numpy()
    np.testing.assert_array_equal(np.isfinite(ot), np.isfinite(rt))
    fin = np.isfinite(rt)
    np.testing.assert_allclose(ot[fin], rt[fin], rtol=1e-4, atol=1e-5)  # sorted t, a few ulp
    np.testing.assert_array_equal(hl.tri.numpy(), _np(ref.tri))
    assert (np.diff(np.where(fin, ot, 1e30), axis=1) >= 0).all()
    p = tr.hit_points_list(_t(o), _t(d), hl).numpy()
    pj = _np(jr.hit_points_list(jnp.asarray(o), jnp.asarray(d), ref))
    np.testing.assert_array_equal(np.isnan(p), np.isnan(pj))
    np.testing.assert_allclose(p[~np.isnan(p)], pj[~np.isnan(pj)], rtol=0, atol=1e-4)


def test_list_intersections_ties_keep_lower_index():
    """Duplicated triangles give equal t: the merge keeps the lower id first,
    as ``lax.top_k`` does."""
    v, t, o, d = _scene("coplanar")
    t = np.concatenate([t, t, t])  # ids 0..5, every t tied three ways
    hl = tr.list_intersections(_t(o), _t(d), _t(v), _t(t), max_hits=4, tri_tile=2)
    ref = jr.list_intersections(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v),
                                jnp.asarray(t), max_hits=4, tri_tile=2)
    np.testing.assert_array_equal(hl.tri.numpy(), _np(ref.tri))
    np.testing.assert_array_equal(hl.count.numpy(), _np(ref.count))


def test_occupancy_and_unsigned_distance_match_jax():
    mesh = jm.sphere_mesh(jnp.array([0.0, 0, 0]), 1.0, n_lat=12, n_lon=24)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    v, t = _np(mesh.vertices), _np(mesh.triangles)
    occ = tr.occupancy(_t(pts), _t(v), _t(t)).numpy()
    occ_j = _np(jr.occupancy(jnp.asarray(pts), mesh.vertices, mesh.triangles))
    np.testing.assert_array_equal(occ, occ_j)
    r = np.linalg.norm(pts, axis=1)
    assert occ[r < 0.8].all() and not occ[r > 1.05].any()  # inside / outside the sphere
    dist = tr.unsigned_distance(_t(pts), _t(v), _t(t)).numpy()
    dist_j = _np(jr.unsigned_distance(jnp.asarray(pts), mesh.vertices, mesh.triangles))
    # sqrt of a squared distance summed in another order: 1e-5 m on a 1 m sphere
    np.testing.assert_allclose(dist, dist_j, rtol=1e-5, atol=1e-5)


def test_cast_rays_occupancy_distance_with_jax_positional_tiles():
    """The JAX package's positional tiles (``cast_rays``' fifth and sixth,
    ``occupancy``'s fourth and fifth, ``unsigned_distance``'s fourth), and
    ``backend`` after them: both packages give the same hits, parity and
    distances, and the tiles change nothing in the port."""
    v, t, o, d = _scene("padded")
    h = tr.cast_rays(_t(o), _t(d), _t(v), _t(t), 512, 128, "auto")
    ref = jr.cast_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v), jnp.asarray(t), 512, 128,
                       "auto")
    hn = hits_to_numpy(h)
    _assert_hits_match(hn["t"], hn["tri"], hn["uv"], hn["count"], *(_np(x) for x in ref))
    assert all(torch.equal(a, b) for a, b in zip(h, tr.cast_rays(_t(o), _t(d), _t(v), _t(t))))
    mesh = jm.sphere_mesh(jnp.array([0.0, 0, 0]), 1.0, n_lat=12, n_lon=24)
    pts = np.random.default_rng(4).uniform(-1.5, 1.5, (300, 3)).astype(np.float32)
    sv, st = _np(mesh.vertices), _np(mesh.triangles)
    occ = tr.occupancy(_t(pts), _t(sv), _t(st), 512, 128)
    np.testing.assert_array_equal(
        occ.numpy(), _np(jr.occupancy(jnp.asarray(pts), mesh.vertices, mesh.triangles, 512, 128)))
    assert torch.equal(occ, tr.occupancy(_t(pts), _t(sv), _t(st), 512, 128, "plain"))
    dist = tr.unsigned_distance(_t(pts), _t(sv), _t(st), 64)
    dist_j = _np(jr.unsigned_distance(jnp.asarray(pts), mesh.vertices, mesh.triangles, 64))
    # as test_occupancy_and_unsigned_distance_match_jax: 1e-5 m on a 1 m sphere
    np.testing.assert_allclose(dist.numpy(), dist_j, rtol=1e-5, atol=1e-5)
    assert torch.equal(dist, tr.unsigned_distance(_t(pts), _t(sv), _t(st)))


def test_exposed_surface_area_and_hit_points_match_jax():
    v, t, o, d = _scene("padded")
    ref = jr.cast_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v), jnp.asarray(t))
    hits = tr.Hits(*(_t(x) for x in ref))  # the JAX package's hits, padding rows included
    a3, a2 = tr.exposed_surface_area(hits, _t(v), _t(t))
    j3, j2 = jr.exposed_surface_area(ref, jnp.asarray(v), jnp.asarray(t))
    # float32 sums of a few hundred areas in two orders
    np.testing.assert_allclose([float(a3), float(a2)], [float(j3), float(j2)], rtol=1e-5)
    for flat in (False, True):
        np.testing.assert_allclose(tr.triangle_areas(_t(v), _t(t), flatten_z=flat).numpy(),
                                   _np(jr.triangle_areas(jnp.asarray(v), jnp.asarray(t),
                                                         flatten_z=flat)), rtol=1e-6, atol=1e-7)
    p = tr.hit_points(hits, _t(v), _t(t)).numpy()
    pj = _np(jr.hit_points(ref, jnp.asarray(v), jnp.asarray(t)))
    np.testing.assert_array_equal(np.isnan(p), np.isnan(pj))
    np.testing.assert_allclose(p[~np.isnan(p)], pj[~np.isnan(pj)], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["pinhole", "parallel"])
def test_ray_generators_match_jax(kind):
    if kind == "pinhole":
        args = ([1.0, -2.0, 9.0], [0.5, 0.2, 0.0], [0.0, 1.0, 0.0], 90.0, 40, 30)
        ours = tr.pinhole_rays(*args, device="cpu")
        ref = jr.pinhole_rays(*(jnp.asarray(a) if isinstance(a, list) else a for a in args))
    else:
        args = ([-1.0, -2.0, 0.0], [3.0, 1.0, 2.5], [0.3, 0.2, -0.93], 24, 18)
        ours = tr.parallel_rays(*args, z_offset=1.0, device="cpu")
        ref = jr.parallel_rays(*args, z_offset=1.0)
    for x, y in zip(ours, ref):  # float32 trig and norms of two libraries
        np.testing.assert_allclose(x.numpy(), _np(y), rtol=0, atol=1e-5 if kind == "parallel"
                                   else 1e-6)


def _grid_scene():
    return jm.merge_meshes([
        jm.sphere_mesh(jnp.array([0.0, 0, 3.0]), 1.0, n_lat=8, n_lon=16),
        jm.cylinder_mesh(jnp.array([0.0, 0, 1.0]), jnp.array([0.0, 0, 1]), 0.3, 2.0),
        jm.cylinder_mesh(jnp.array([3.0, 1, 1.5]), jnp.array([0.3, 0, 0.95]), 0.2, 3.0),
    ])


@pytest.mark.parametrize("elev", [90.0, 45.0])
def test_ray_grid_tables_and_cast_match_jax(elev):
    mesh = _grid_scene()
    v, t = _np(mesh.vertices), _np(mesh.triangles)
    az, el = np.radians(30.0), np.radians(elev)
    direction = -np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)],
                          dtype=np.float32)
    gj = jg.build_ray_grid(mesh.vertices, mesh.triangles, direction, cell_cap=128)
    gt = tg.build_ray_grid(_t(v), _t(t), direction, cell_cap=128)
    for f in jg.RayGrid._fields:  # host-built tables: equal cell for cell
        a, b = getattr(gj, f), getattr(gt, f)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), _np(a), err_msg=f)
        else:
            assert a == b, f
    o, d = jr.parallel_rays(v.min(0), v.max(0), direction, 96, 96)
    hits = tg.grid_cast_parallel(gt, _t(o), _t(d))
    ref = jg.grid_cast_parallel(gj, o, d)
    brute = tr.cast_rays(_t(o), _t(d), _t(v), _t(t))
    hn = hits_to_numpy(hits)
    _assert_hits_match(hn["t"], hn["tri"], hn["uv"], hn["count"],
                       *(_np(x) for x in ref))
    bn = hits_to_numpy(brute)
    _assert_hits_match(hn["t"], hn["tri"], hn["uv"], hn["count"],
                       bn["t"], bn["tri"], bn["uv"], bn["count"])
    # the unpacked table route (large grids) gives the same hits
    unpacked = tg.grid_cast_parallel(gt._replace(packed_cells=False), _t(o), _t(d))
    for f in ("t", "tri", "count"):
        np.testing.assert_array_equal(getattr(unpacked, f).numpy(), hn[f])


def test_ray_grid_cap_overflow_raises():
    verts = np.tile(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32), (200, 1))
    tris = np.arange(600, dtype=np.int32).reshape(200, 3)
    with pytest.raises(ValueError):
        tg.build_ray_grid(_t(verts), _t(tris), np.array([0, 0, -1.0]), cell_cap=64)


def test_mesh_constructors_match_jax():
    pairs = [
        (tm.cylinder_mesh([1.0, 2, 0], [0.2, 0.1, 1], 0.3, 2.0, segments=12, device="cpu"),
         jm.cylinder_mesh(jnp.array([1.0, 2, 0]), jnp.array([0.2, 0.1, 1]), 0.3, 2.0,
                          segments=12)),
        (tm.sphere_mesh([0.0, 1, 2], 0.7, device="cpu"),
         jm.sphere_mesh(jnp.array([0.0, 1, 2]), 0.7)),
    ]
    pairs.append((tm.merge_meshes([p[0] for p in pairs]), jm.merge_meshes([p[1] for p in pairs])))
    for ours, ref in pairs:
        np.testing.assert_array_equal(ours.vertices.numpy(), _np(ref.vertices))
        np.testing.assert_array_equal(ours.triangles.numpy(), _np(ref.triangles))
        assert tm.mesh_properties(ours) == jm.mesh_properties(ref)
        assert ours.n_triangles() == ref.n_triangles()


def test_qsm_mesh_matches_jax():
    import pyqsm_tpu.state as js

    from pyqsm_tpu_torch.convert import state_from_numpy

    rng = np.random.default_rng(4)
    m = 5
    cyl = js.Cylinders(center=jnp.asarray(rng.normal(size=(m, 3)), jnp.float32),
                       axis=jnp.asarray(rng.normal(size=(m, 3)), jnp.float32),
                       height=jnp.asarray([1.0, 0.5, 0.0, 2.0, 1.0]),
                       radius=jnp.asarray([0.1, 0.2, 0.3, 0.0, 0.05]),
                       branch_order=jnp.zeros(m, jnp.int32), parent=jnp.full(m, -1, jnp.int32),
                       mask=jnp.asarray([True, True, True, True, False]))
    ours = tm.qsm_mesh(state_from_numpy("cylinders", {f: _np(x) for f, x in vars(cyl).items()},
                                        device="cpu"), device="cpu")
    ref = jm.qsm_mesh(cyl)
    np.testing.assert_array_equal(ours.vertices.numpy(), _np(ref.vertices))
    np.testing.assert_array_equal(ours.triangles.numpy(), _np(ref.triangles))


# --- models/raycast: the slice as a whole on a canopy-like mesh ----------


@pytest.fixture(scope="module")
def canopy():
    """A seeded two-crown canopy cloud, meshed by the port's
    ``poisson_like_mesh`` and decimated below cast_scene's 2048 switch; the
    JAX package gets the same mesh through ``convert``."""
    rng = np.random.default_rng(11)
    crowns = [np.array([0.0, 0.0, 7.5]), np.array([4.0, 1.0, 8.0])]
    pts = np.concatenate([c + rng.normal(size=(3000, 3)) * [1.6, 1.6, 1.0] for c in crowns])
    pts = pts.astype(np.float32)
    mesh = simplify_mesh(poisson_like_mesh(_t(pts), voxel=0.25, blur_iters=1),
                         target_triangles=1500)
    jmesh = j_simplify(j_poisson(jnp.asarray(pts), voxel=0.25, blur_iters=1),
                       target_triangles=1500)
    v, t = mesh.vertices.numpy(), mesh.triangles.numpy()
    return mesh, jm.TriMesh(jnp.asarray(v), jnp.asarray(t)), jmesh


def test_canopy_mesh_matches_jax_build(canopy):
    mesh, _, jmesh = canopy
    assert 500 < mesh.n_triangles() < 2048
    np.testing.assert_array_equal(mesh.triangles.numpy(), _np(jmesh.triangles))
    # cluster centroids: float64 means of vertices that agree within 1e-5
    np.testing.assert_allclose(mesh.vertices.numpy(), _np(jmesh.vertices), rtol=0, atol=1e-5)


def _assert_exposure_close(ours, ref):
    # hit fraction and exposed areas: the rays and float32 area sums
    # differ by ulps between the packages
    assert abs(ours.hit_fraction - ref.hit_fraction) <= 1e-4 * max(ref.hit_fraction, 1e-6)
    np.testing.assert_allclose([ours.surface_area_3d, ours.surface_area_2d],
                               [ref.surface_area_3d, ref.surface_area_2d], rtol=1e-4)


def test_cast_scene_matches_jax(canopy):
    mesh, jmesh, _ = canopy
    ours = tmr.cast_scene(mesh, cfg=RaycastConfig(width_px=96, height_px=72), device="cpu")
    ref = jmr.cast_scene(jmesh, cfg=JRaycastConfig(width_px=96, height_px=72))
    assert ours.hit_fraction > 0
    _assert_exposure_close(ours, ref)


@pytest.mark.parametrize("backend", ["grid", "brute"])
def test_sun_exposure_matches_jax(canopy, backend):
    mesh, jmesh, _ = canopy
    ours = tmr.sun_exposure(mesh, 180.0, 60.0, 48, 48, backend=backend, device="cpu")
    ref = jmr.sun_exposure(jmesh, 180.0, 60.0, 48, 48, backend=backend)
    assert ours.hit_fraction > 0
    _assert_exposure_close(ours, ref)


def test_sun_exposure_grid_equals_brute(canopy):
    mesh = canopy[0]
    g = tmr.sun_exposure(mesh, 180.0, 30.0, 48, 48, backend="grid", device="cpu")
    b = tmr.sun_exposure(mesh, 180.0, 30.0, 48, 48, backend="brute", device="cpu")
    assert g.hit_fraction == b.hit_fraction
    np.testing.assert_array_equal(g.hits.count.numpy(), b.hits.count.numpy())
    np.testing.assert_allclose([g.surface_area_3d, g.surface_area_2d],
                               [b.surface_area_3d, b.surface_area_2d], rtol=1e-6)


def test_sun_sweep_matches_jax(canopy):
    mesh, jmesh, _ = canopy
    ours = tmr.sun_sweep(mesh, elevations=(30.0, 90.0), nx=32, ny=32, device="cpu")
    ref = jmr.sun_sweep(jmesh, elevations=(30.0, 90.0), nx=32, ny=32)
    assert list(ours) == list(ref)
    for el in ref:
        _assert_exposure_close(ours[el], ref[el])


def test_mri_slices_match_jax(canopy):
    mesh, jmesh, _ = canopy
    ours = tmr.mri_slices(mesh, n_slices=3, resolution=12, device="cpu").numpy()
    ref = _np(jmr.mri_slices(jmesh, n_slices=3, resolution=12))
    assert ours.shape == (3, 12, 12)
    # signed distances in metres on a ~10 m canopy; signs from crossing parity
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_sparse_cast_and_raycast_to_pcd_match_jax(canopy):
    mesh, jmesh, _ = canopy
    hl, pts = tmr.sparse_cast_with_intersections(mesh, nx=24, ny=24, max_hits=6, device="cpu")
    hj, pj = jmr.sparse_cast_with_intersections(jmesh, nx=24, ny=24, max_hits=6)
    np.testing.assert_array_equal(hl.count.numpy(), _np(hj.count))
    np.testing.assert_array_equal(hl.tri.numpy(), _np(hj.tri))
    pts, pj = pts.numpy(), _np(pj)
    np.testing.assert_array_equal(np.isnan(pts), np.isnan(pj))
    np.testing.assert_allclose(pts[~np.isnan(pts)], pj[~np.isnan(pj)], rtol=0, atol=1e-4)
    exp = tmr.cast_scene(mesh, cfg=RaycastConfig(width_px=32, height_px=24), device="cpu")
    cloud = tmr.raycast_to_pcd(mesh, exp.hits, device="cpu").numpy()
    ref = _np(jmr.raycast_to_pcd(jmesh, jr.Hits(*(jnp.asarray(x.numpy()) for x in exp.hits))))
    assert cloud.shape == (32 * 24, 3)
    np.testing.assert_array_equal(np.isnan(cloud), np.isnan(ref))
    np.testing.assert_allclose(cloud[~np.isnan(cloud)], ref[~np.isnan(ref)], rtol=0, atol=1e-5)


def test_mesh_from_numpy_and_hits_to_numpy_round_trip():
    mesh = _sphere_cyl()
    ours = mesh_from_numpy(_np(mesh.vertices), _np(mesh.triangles), device="cpu")
    assert ours.vertices.dtype == torch.float32 and ours.triangles.dtype == torch.int32
    np.testing.assert_array_equal(ours.triangles.numpy(), _np(mesh.triangles))
    h = tr.cast_rays(*(_t(x) for x in _scene("sphere_cyl")[2:]), ours.vertices, ours.triangles)
    assert set(hits_to_numpy(h)) == set(jr.Hits._fields)


# --- the kernel's launch plan and cross-slice merge, on the CPU ---------


@pytest.mark.parametrize("n_tri", [0, 1, 1113, 4095, 12000])
@pytest.mark.parametrize("n_rays", [1, 4096, 65536, 307200])
def test_mt_plan_covers_every_triangle_and_ray(n_rays, n_tri):
    """The host's plan: every triangle in exactly one slice and one staged
    chunk, in ascending order; every ray in one tile; a cluster of at most
    8 blocks; two buffers exactly when a slice takes several chunks; the
    shared memory within a block's limit. On a card of 132 SMs (an H100
    SXM)."""
    pl = tmt.plan(n_rays, n_tri, 132)
    chunks = pl.chunks(n_tri)
    assert len(chunks) == pl.slices and 1 <= pl.slices <= tmt.MAX_SLICES
    ids = [i for sl in chunks for lo, hi in sl for i in range(lo, hi)]
    assert ids == list(range(n_tri))
    assert all(hi - lo <= pl.chunk for sl in chunks for lo, hi in sl)
    assert all(len(sl) <= 1 for sl in chunks) == (pl.buffers == 1)
    assert (pl.tiles - 1) * pl.threads < n_rays <= pl.tiles * pl.threads
    assert pl.threads in (128, 256)
    assert pl.smem_bytes <= 232_448  # the dynamic shared memory a block may have
    if n_tri > tmt.WHOLE_TRIANGLES or (n_tri >= 2 * tmt.MIN_SLICE
                                       and pl.tiles < 2 * 132):
        assert pl.slices > 1  # large tables and few rays split the triangles
    if n_tri <= tmt.WHOLE_TRIANGLES and pl.tiles >= 2 * 132:
        assert pl.slices == 1


@pytest.mark.parametrize("slices", [0, 9, 16])
def test_mt_plan_refuses_a_cluster_the_kernel_does_not_take(slices):
    with pytest.raises(ValueError):
        tmt._sliced(4096, 1113, 128, slices)


def _merge_slices(parts):
    """The kernel's cross-slice merge: ``parts`` are the (t, tri, uv, count)
    of contiguous triangle slices in ascending order, ids global. The
    lexicographic least (t, id) wins, carrying its (u, v): slices are
    taken in order with a strict ``<``, so on equal t the earlier slice,
    whose ids are lower, keeps the hit. Counts are summed."""
    t, tri, uv, cnt = parts[0]
    t = torch.full_like(t, torch.inf)
    tri = torch.full_like(tri, -1)
    uv = torch.zeros_like(uv)
    cnt = torch.zeros_like(cnt)
    for ts, tris, uvs, cnts in parts:
        cnt = cnt + cnts
        better = ts < t
        t = torch.where(better, ts, t)
        tri = torch.where(better, tris, tri)
        uv = torch.where(better[:, None], uvs, uv)
    return t, tri, uv, cnt


def _slice_runs(o, d, v, t, pl):
    """Independent plain runs over each of the plan's slices, ids made global."""
    parts = []
    for sl in pl.chunks(t.shape[0]):
        lo, hi = (sl[0][0], sl[-1][1]) if sl else (0, 0)
        tt, tri, uv, cnt = tmt.mt_raycast_plain(o, d, v, t[lo:hi])
        parts.append((tt, torch.where(tri >= 0, tri + lo, tri), uv, cnt))
    return parts


@pytest.mark.parametrize("scene", ["padded", "coplanar"])
def test_merge_slices_gives_the_one_tile_result(scene):
    """The kernel's cross-slice merge (least (t, id), u and v carried,
    counts summed) over independent per-slice plain runs equals the
    one-tile plain result bit for bit; on the duplicated coplanar scene
    every tie crosses a slice, and the lower id must win it."""
    v, t, o, d = _scene(scene)
    if scene == "coplanar":
        t = np.concatenate([t, t])  # ids 2, 3 repeat 0, 1 in the next slice
    o, d, v, t = _t(o), _t(d), _t(v), _t(t)
    whole = tmt.mt_raycast_plain(o, d, v, t, ray_tile=len(o), tri_tile=len(t))
    for slices in (2, 3, 8):
        parts = _slice_runs(o, d, v, t, tmt._sliced(len(o), len(t), 128, slices))
        for a, b in zip(_merge_slices(parts), whole):
            assert torch.equal(a, b)
    if scene == "coplanar":
        first, second = _slice_runs(o, d, v, t, tmt._sliced(len(o), len(t), 128, 2))
        tie = torch.isfinite(first[0]) & (first[0] == second[0])
        assert bool(tie.all())  # every hit ties across the two slices
        assert int(whole[1].max()) <= 1


def test_zero_edges_never_hit_like_the_valid_flag():
    """The kernel stages a padding row with e1 = e2 = 0 instead of a valid
    flag: its det is 0 (NaN for an infinite direction), so ``big`` fails
    and the row never hits, exactly as the flag makes it."""
    v, t, o, d = _scene("padded")
    d = np.concatenate([d, [[np.inf, 0.0, 1.0], [np.nan, 0.0, 1.0]]]).astype(np.float32)
    o = np.concatenate([o, o[:2]])
    soa = tmt.triangle_soa(_t(v), _t(t))
    pad = soa[9] == 0
    assert bool(pad.any())
    zeroed = soa.clone()
    zeroed[3:9, pad] = 0.0
    ov = tuple(_t(o)[:, a:a + 1] for a in range(3))
    dv = tuple(_t(d)[:, a:a + 1] for a in range(3))
    flag = tmt.mt_components(ov, dv, (soa[0], soa[1], soa[2]), (soa[3], soa[4], soa[5]),
                             (soa[6], soa[7], soa[8]), soa[9] > 0)[0]
    edges = tmt.mt_components(ov, dv, (zeroed[0], zeroed[1], zeroed[2]),
                              (zeroed[3], zeroed[4], zeroed[5]),
                              (zeroed[6], zeroed[7], zeroed[8]), torch.ones_like(pad))[0]
    assert torch.equal(flag, edges)
    assert not torch.isfinite(edges[:, pad]).any()


@pytest.mark.gpu
def test_mt_raycast_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run chip_smoke.py on the card)")
    for scene in ("padded", "coplanar"):
        v, t, o, d = _scene(scene)
        if scene == "coplanar":
            t = np.concatenate([t, t])  # every tie crosses a slice: the lower id wins
        args = [torch.as_tensor(x, device="cuda") for x in (o, d, v, t)]
        before = tmt.LAUNCHES
        got = tmt.mt_raycast(*args)
        assert tmt.LAUNCHES == before + 1
        want = tmt.mt_raycast_plain(*args)
        for a, b in zip(got, want):  # same operations in the same order: bit for bit
            assert torch.equal(a, b)
        for slices in (1, 2, 8):
            for a, b in zip(tmt._launch(*args, slices=slices), want):
                assert torch.equal(a, b)
