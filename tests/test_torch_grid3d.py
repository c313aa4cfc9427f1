"""Parity of the port's 3D uniform grid (``ops/grid3d``) and the grid route
of ``cast_rays`` with the JAX package on the CPU: the host-built tables
equal, field for field; the DDA cast, the two-level cast and grid
occupancy with equal hit ids and crossing counts, and hit distances within
1e-4 relative (XLA's CPU code fuses the Möller–Trumbore multiply-adds, the
port rounds each product, so a grazing hit's t moves by some ulp). The
scenes are the JAX package's oracle scenes (tests/test_grid3d.py). Inputs
are numpy arrays from a seed, the same for both packages."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.ops import grid3d as jg
from pyqsm_tpu.ops import mesh as jm
from pyqsm_tpu.ops import raytrace as jr
from pyqsm_tpu_torch.convert import mesh_from_numpy
from pyqsm_tpu_torch.models import raycast as tmr
from pyqsm_tpu_torch.ops import grid3d as tg
from pyqsm_tpu_torch.ops import raytrace as tr

RTOL = 1e-4  # hit distances: the JAX oracle tests' tolerance (tests/test_grid3d.py)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _four():
    m = jm.merge_meshes([
        jm.sphere_mesh(jnp.array([0.0, 0, 3.0]), 1.0, n_lat=10, n_lon=20),
        jm.cylinder_mesh(jnp.array([0.0, 0, 1.0]), jnp.array([0.0, 0, 1]), 0.3, 2.0),
        jm.cylinder_mesh(jnp.array([3.0, 1, 1.5]), jnp.array([0.3, 0, 0.95]), 0.2, 3.0),
        jm.sphere_mesh(jnp.array([-2.0, 2, 2.0]), 0.7, n_lat=8, n_lon=12),
    ])
    return _np(m.vertices), _np(m.triangles)


def _hotspot():
    """A clump of 600 tiny triangles that overflows the percentile cap, and a
    sphere elsewhere."""
    rng = np.random.default_rng(21)
    n = 600
    c = rng.normal([0.0, 0, 0], 0.05, (n, 3)).astype(np.float32)
    u = rng.normal(size=(n, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w -= (w * u).sum(1, keepdims=True) * u
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    verts = np.concatenate([c - 0.02 * u, c + 0.02 * u, c + 0.02 * w])
    tris = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], 1).astype(np.int32)
    far = jm.sphere_mesh(jnp.array([4.0, 0, 0.0]), 0.5, n_lat=6, n_lon=10)
    return (np.concatenate([verts, _np(far.vertices)]).astype(np.float32),
            np.concatenate([tris, _np(far.triangles) + 3 * n]).astype(np.int32))


def _teapot():
    """A finely tessellated 0.5 m sphere inside a 400 m arena."""
    teapot = jm.sphere_mesh(jnp.array([3.0, -2.0, 1.0]), 0.25, n_lat=18, n_lon=36)
    g = 200.0
    verts_a = np.array([[-g, -g, 0], [g, -g, 0], [g, g, 0], [-g, g, 0],
                        [-g, -g, 0], [-g, -g, 25], [-g, g, 25], [-g, g, 0],
                        [g, -g, 0], [g, -g, 25], [g, g, 25], [g, g, 0]], np.float32)
    tris_a = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7], [8, 9, 10], [8, 10, 11]],
                      np.int32)
    nv = teapot.vertices.shape[0]
    return (np.concatenate([_np(teapot.vertices), verts_a]),
            np.concatenate([_np(teapot.triangles), tris_a + nv]).astype(np.int32))


def _mesh(name):
    if name == "four":
        return _four()
    if name == "padded":
        v, t = _four()
        return v, np.concatenate([t, np.full((13, 3), -1, np.int32)])
    if name == "hotspot":
        return _hotspot()
    return _teapot()


_BUILD_KW = {"four": {}, "padded": {}, "hotspot": {"cap_percentile": 90.0}, "teapot": {},
             "unpacked": {"cell_rows_budget": 0}}


def _grids(name, **kw):
    v, t = _mesh("four" if name == "unpacked" else name)
    kw = {**_BUILD_KW[name], **kw}
    return (v, t, jg.build_grid3d(jnp.asarray(v), jnp.asarray(t), **kw),
            tg.build_grid3d(_t(v), _t(t), **kw))


def _assert_grid_equal(gj, gt):
    for f in jg.Grid3D._fields:
        a, b = getattr(gj, f), getattr(gt, f)
        if isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), _np(a), err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("name", ["four", "padded", "hotspot", "teapot", "unpacked"])
def test_build_grid3d_matches_jax(name):
    """Host-built tables equal field for field: table, residual, skip,
    packed rows, cell_rank, cell_rows, dims and counts."""
    _, _, gj, gt = _grids(name)
    _assert_grid_equal(gj, gt)
    assert gt.packed_cells == (name != "unpacked")
    if name in ("hotspot", "teapot"):
        assert gt.n_residual > 0  # the dense part spilled


def test_chebyshev_dt_matches_scipy():
    from scipy.ndimage import distance_transform_cdt

    rng = np.random.default_rng(3)
    for shape, p in (((9, 7, 11), 0.08), ((40, 3, 5), 0.01)):
        occ = rng.random(shape) < p
        occ[0, 0, 0] = True
        ref = distance_transform_cdt(~occ, metric="chessboard")
        np.testing.assert_array_equal(tg._chebyshev_dt(occ), np.asarray(ref))
        np.testing.assert_array_equal(tg._chebyshev_dt(occ), jg._chebyshev_dt(occ))
    occ = np.zeros((200, 2, 2), bool)
    occ[0] = True  # farther than max_dist: saturates at 64 in both packages
    np.testing.assert_array_equal(tg._chebyshev_dt(occ), jg._chebyshev_dt(occ))
    assert tg._chebyshev_dt(occ).max() == 64


def test_cap_overflow_raises():
    verts = np.tile(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32), (300, 1))
    tris = np.arange(900, dtype=np.int32).reshape(300, 3)
    with pytest.raises(ValueError, match="cell_cap"):
        tg.build_grid3d(_t(verts), _t(tris), cell_cap=64)


def _rays(name, v, rng):
    lo, hi = v.min(0), v.max(0)
    if name == "pinhole":
        center = v.mean(0)
        o, d = jr.pinhole_rays(jnp.asarray(center + [4.0, -6.0, 5.0]), jnp.asarray(center),
                               jnp.array([0.0, 0, 1.0]), 70.0, 96, 72)
        return _np(o), _np(d)
    if name == "axis":  # zero direction components: inf t_max axes
        n = 400
        o = rng.uniform(lo - 1.0, hi + 1.0, (n, 3)).astype(np.float32)
        d = np.concatenate([np.tile(a, (n // 6, 1)) * s for a in np.eye(3, dtype=np.float32)
                            for s in (1.0, -1.0)])
        return o[:len(d)], d
    if name == "teapot":  # rays at the object and wide arena rays
        o_obj = rng.uniform([1.0, -4.0, 0.0], [5.0, 0.0, 3.0], (400, 3))
        d_obj = np.array([3.0, -2.0, 1.0]) - o_obj + rng.normal(0, 0.15, (400, 3))
        o_far = rng.uniform(-200, 200, (200, 3))
        o_far[:, 2] = rng.uniform(0, 25, 200)
        o = np.concatenate([o_obj, o_far]).astype(np.float32)
        d = np.concatenate([d_obj, rng.normal(size=(200, 3))]).astype(np.float32)
    else:
        n = 1500 if name == "hotspot" else 3000
        o = rng.uniform(lo - 2.0, hi + 2.0, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def _assert_hits(ours, ref, counts=True):
    t, rt = ours.t.numpy(), _np(ref.t)
    hit = np.isfinite(rt)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], rt[hit], rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(ours.tri.numpy(), _np(ref.tri))
    if counts:
        np.testing.assert_array_equal(ours.count.numpy(), _np(ref.count))


CASTS = [("four", "pinhole", False, 2048), ("four", "random", True, 1024),
         ("four", "random", False, 1024), ("four", "axis", True, 512),
         ("padded", "pinhole", False, 8192), ("hotspot", "random", True, 512),
         ("teapot", "teapot", True, 512), ("unpacked", "random", True, 1024)]


@pytest.mark.parametrize("name,rays,count_all,ray_tile", CASTS)
def test_grid_cast_matches_jax(name, rays, count_all, ray_tile):
    """The DDA cast gives the JAX package's hit ids (and, under
    ``count_all``, crossing counts) exactly; every crossing count also
    equals the brute cast's."""
    v, t, gj, gt = _grids(name)
    o, d = _rays(rays, v, np.random.default_rng(len(name) + ray_tile))
    ours = tg.grid_cast(gt, _t(o), _t(d), ray_tile=ray_tile, count_all=count_all)
    ref = jg.grid_cast(gj, jnp.asarray(o), jnp.asarray(d), ray_tile=ray_tile,
                       count_all=count_all)
    _assert_hits(ours, ref, counts=count_all)
    if count_all:
        brute = tr.cast_rays(_t(o), _t(d), _t(v), _t(t), backend="kernel")
        np.testing.assert_array_equal(ours.count.numpy(), brute.count.numpy())
    if name == "padded":
        assert int(ours.tri.max()) < len(t) - 13 and int((ours.tri >= 0).sum()) > 20


@pytest.mark.parametrize("compact_min", [4096, 16])
def test_ray_tile_and_dispatch_change_nothing(compact_min, monkeypatch):
    """Every ray's march is its own: tile size, dispatch chunks and the
    working set's compaction (from 16 live rays) leave every output bit
    unchanged."""
    monkeypatch.setattr(tg, "_COMPACT_MIN", compact_min)
    v, t, _, gt = _grids("four")
    o, d = _rays("random", v, np.random.default_rng(5))
    o, d = _t(o), _t(d)
    whole = tg.grid_cast(gt, o, d, ray_tile=len(o), count_all=True)
    for kw in ({"ray_tile": 64}, {"ray_tile": 1000}, {"ray_tile": 512, "rays_per_dispatch": 700}):
        got = tg.grid_cast(gt, o, d, count_all=True, **kw)
        for a, b in zip(got, whole):
            assert torch.equal(a, b)
    for a, b in zip(tg.grid_cast(gt, o, d, count_all=False),
                    tg.grid_cast(gt, o, d, ray_tile=100, count_all=False)):
        assert torch.equal(a, b)


def test_build_two_level_matches_jax():
    v, t = _teapot()
    tj = jg.build_grid3d_two_level(jnp.asarray(v), jnp.asarray(t))
    tt = tg.build_grid3d_two_level(_t(v), _t(t))
    assert isinstance(tt, tg.TwoLevelGrid) and isinstance(tj, jg.TwoLevelGrid)
    _assert_grid_equal(tj.primary, tt.primary)
    _assert_grid_equal(tj.sub, tt.sub)
    np.testing.assert_array_equal(tt.sub_tri_ids.numpy(), _np(tj.sub_tri_ids))
    assert tt.sub.cell < 0.2 and tt.primary.n_residual < 8
    s = jm.sphere_mesh(jnp.array([0.0, 0, 0.0]), 1.0, n_lat=10, n_lon=20)
    assert isinstance(tg.build_grid3d_two_level(_t(s.vertices), _t(s.triangles)), tg.Grid3D)


@pytest.mark.parametrize("bundle", ["object", "arena"])
@pytest.mark.parametrize("count_all", [True, False])
def test_two_level_cast_matches_jax(bundle, count_all, monkeypatch):
    """Both branches: a bundle aimed at the hotspot casts whole through the
    sub grid, a bundle of arena rays casts a culled sub-bundle."""
    v, t = _teapot()
    tj = jg.build_grid3d_two_level(jnp.asarray(v), jnp.asarray(t))
    tt = tg.build_grid3d_two_level(_t(v), _t(t))
    o, d = _rays("teapot", v, np.random.default_rng(7))
    keep = slice(0, 400) if bundle == "object" else slice(340, 600)
    o, d = o[keep], d[keep]
    culled = []
    real = tg.nonzero_rows
    monkeypatch.setattr(tg, "nonzero_rows", lambda m, c: culled.append(c) or real(m, c))
    ours = tg.two_level_cast(tt, _t(o), _t(d), count_all=count_all)
    ref = jg.two_level_cast(tj, jnp.asarray(o), jnp.asarray(d), count_all=count_all)
    _assert_hits(ours, ref, counts=count_all)
    assert bool(culled) == (bundle == "arena")
    if count_all:
        brute = tr.cast_rays(_t(o), _t(d), _t(v), _t(t), backend="kernel")
        np.testing.assert_array_equal(ours.count.numpy(), brute.count.numpy())


def test_grid_occupancy_matches_jax():
    rng = np.random.default_rng(9)
    s = jm.sphere_mesh(jnp.array([0.0, 0, 0.0]), 1.0, n_lat=12, n_lon=24)
    pts = rng.uniform(-1.5, 1.5, (800, 3)).astype(np.float32)
    gj = jg.build_grid3d(s.vertices, s.triangles)
    gt = tg.build_grid3d(_t(s.vertices), _t(s.triangles))
    ours = tg.grid_occupancy(gt, _t(pts), ray_tile=1024).numpy()
    np.testing.assert_array_equal(ours, _np(jg.grid_occupancy(gj, jnp.asarray(pts))))
    np.testing.assert_array_equal(ours, _np(jr.occupancy(jnp.asarray(pts), s.vertices,
                                                         s.triangles)))
    assert ours[np.linalg.norm(pts, axis=1) < 0.8].all()


def _big_sphere():
    """4512 triangles: past ``cast_rays``' 4096 switch to the grid."""
    s = jm.merge_meshes([jm.sphere_mesh(jnp.array([0.0, 0, 0.0]), 1.0, n_lat=48, n_lon=48),
                         jm.cylinder_mesh(jnp.array([0.6, 0, -1.5]), jnp.array([0.0, 0, 1]),
                                          0.2, 3.0)])
    return _np(s.vertices), _np(s.triangles)


def test_cast_rays_auto_takes_the_grid_at_4096():
    v, t = _big_sphere()
    assert len(t) >= tr.GRID_TRIANGLES
    o, d = _rays("random", v, np.random.default_rng(11))
    tr.clear_grid_cache()
    ours = tr.cast_rays(_t(o), _t(d), _t(v), _t(t))
    ref = jr.cast_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(v), jnp.asarray(t))
    _assert_hits(ours, ref)
    brute = tr.cast_rays(_t(o), _t(d), _t(v), _t(t), backend="kernel")
    np.testing.assert_array_equal(ours.count.numpy(), brute.count.numpy())
    np.testing.assert_array_equal(ours.tri.numpy(), brute.tri.numpy())


def test_occupancy_and_mri_slices_on_a_large_mesh():
    """At 4096 triangles or more ``occupancy`` and ``mri_slices`` cast
    through the grid. The JAX package's jitted ``occupancy`` cannot build
    its grid under a trace there, so the reference is what it computes
    un-jitted: the crossing parity of ``cast_rays(backend="grid")``, and
    ``unsigned_distance`` signed by it."""
    v, t = _big_sphere()
    mesh = mesh_from_numpy(v, t, device="cpu")
    pts = np.random.default_rng(12).uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
    occ = tr.occupancy(_t(pts), mesh.vertices, mesh.triangles).numpy()
    dirs = np.broadcast_to(np.array([1.73205e-4, 2.23607e-4, 1.0], np.float32), pts.shape)
    ref = jr.cast_rays(jnp.asarray(pts), jnp.asarray(dirs), jnp.asarray(v), jnp.asarray(t),
                       backend="grid")
    np.testing.assert_array_equal(occ, _np(ref.count) % 2 == 1)
    np.testing.assert_array_equal(occ, tr.occupancy(_t(pts), mesh.vertices, mesh.triangles,
                                                    backend="kernel").numpy())
    ours = tmr.mri_slices(mesh, n_slices=3, resolution=10, device="cpu").numpy()
    jmesh = jm.TriMesh(jnp.asarray(v), jnp.asarray(t))
    lo, hi = v.min(0), v.max(0)
    for i, z in enumerate(np.linspace(lo[2], hi[2], 3)):
        gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], 10), np.linspace(lo[1], hi[1], 10))
        p = np.stack([gx.ravel(), gy.ravel(), np.full(100, z)], 1).astype(np.float32)
        dj = _np(jr.unsigned_distance(jnp.asarray(p), jmesh.vertices, jmesh.triangles))
        cj = _np(jr.cast_rays(jnp.asarray(p), jnp.asarray(dirs[:100]), jmesh.vertices,
                              jmesh.triangles, backend="grid").count)
        sd = np.where(cj % 2 == 1, -dj, dj).reshape(10, 10)
        # signs equal; distances as test_torch_raycast's mri test: 1e-5 m
        np.testing.assert_allclose(ours[i], sd, rtol=0, atol=1e-5)


def test_grid_cache_reuse_eviction_and_clear(monkeypatch):
    builds = []
    real = tg.build_grid3d_two_level
    monkeypatch.setattr(tg, "build_grid3d_two_level",
                        lambda v, t: builds.append(1) or real(v, t))
    tr.clear_grid_cache()
    v, t = _four()
    meshes = [(_t(v + i), _t(t)) for i in range(3)]
    g0 = tr._cached_grid3d(*meshes[0])
    assert tr._cached_grid3d(*meshes[0]) is g0 and len(builds) == 1  # same tensors: reused
    tr._cached_grid3d(_t(v), meshes[0][1])  # equal values, another tensor: rebuilt
    assert len(builds) == 2
    tr._cached_grid3d(*meshes[1])
    tr._cached_grid3d(*meshes[2])
    assert len(tr._GRID_CACHE) == tr._GRID_CACHE_MAX  # oldest evicted first
    assert tr._cached_grid3d(*meshes[0]) is not g0 and len(builds) == 5
    monkeypatch.setattr(tr, "_GRID_CACHE_BYTES", 1)  # the byte budget keeps one grid
    tr._cached_grid3d(*meshes[1])
    assert len(tr._GRID_CACHE) == 1 and tr._grid_nbytes(tr._GRID_CACHE[0][2]) > 1
    del meshes
    gc.collect()
    tr._cached_grid3d(_t(v), _t(t))
    assert len(tr._GRID_CACHE) == 1  # the freed mesh's entry dropped out
    tr.clear_grid_cache()
    assert tr._GRID_CACHE == []
