"""Parity of the port's image grid and cell cast (``ops/raygrid``) and of
``cast_scene``'s image route with the JAX package on the CPU: the
host-built tables, residual and occupancy buckets equal; hit ids and
crossing counts equal; hit distances within 1e-5 relative (XLA's CPU code
fuses the Möller–Trumbore multiply-adds, the port rounds each product and
on the card equals the ``mt_raycast`` kernel, so a grazing hit's t moves by
some ulp; the pixel directions round as XLA's do). The scenes are the JAX
package's oracle scenes (tests/test_raygrid.py). Inputs are numpy arrays
from a seed, the same for both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.config import RaycastConfig as JRaycastConfig
from pyqsm_tpu.models import raycast as jmr
from pyqsm_tpu.ops import mesh as jm
from pyqsm_tpu.ops import raygrid as jg
from pyqsm_tpu.ops.voxelmesh import poisson_like_mesh as j_poisson
from pyqsm_tpu.ops.voxelmesh import simplify_mesh as j_simplify
from pyqsm_tpu_torch.config import RaycastConfig
from pyqsm_tpu_torch.convert import mesh_from_numpy
from pyqsm_tpu_torch.models import raycast as tmr
from pyqsm_tpu_torch.ops import raygrid as tg
from pyqsm_tpu_torch.ops import raytrace as tr

RTOL = 1e-5


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


def _three():
    m = jm.merge_meshes([
        jm.sphere_mesh(jnp.array([0.0, 0, 3.0]), 1.0, n_lat=8, n_lon=16),
        jm.cylinder_mesh(jnp.array([0.0, 0, 1.0]), jnp.array([0.0, 0, 1]), 0.3, 2.0),
        jm.cylinder_mesh(jnp.array([3.0, 1, 1.5]), jnp.array([0.3, 0, 0.95]), 0.2, 3.0),
    ])
    return _np(m.vertices), _np(m.triangles)


def _two_spheres():
    m = jm.merge_meshes([jm.sphere_mesh(jnp.array([0.0, 0, 0.0]), 1.0, n_lat=8, n_lon=16),
                         jm.sphere_mesh(jnp.array([4.0, 0, 0.0]), 1.0, n_lat=8, n_lon=16)])
    return _np(m.vertices), _np(m.triangles)


# (mesh, eye, center, up, fov, width, height, tile_px): outside the scene, the
# eye between two spheres, the eye inside a sphere (its triangles straddle
# the eye plane and take the residual pass), a padded mesh, 4-pixel tiles
VIEWS = {
    "outside": (_three, [4.0, -5.0, 4.0], [0.5, 0.0, 2.0], [0.0, 0, 1], 65.0, 120, 88, 8),
    "between": (_two_spheres, [2.0, 0.0, 0.0], [0.0, 0, 0], [0.0, 0, 1], 80.0, 64, 64, 8),
    "inside": (_two_spheres, [0.3, 0.1, 0.2], [4.0, 0, 0], [0.0, 0, 1], 100.0, 72, 56, 8),
    "padded": (_three, [0.0, 1.0, 9.0], [0.5, 0.0, 2.0], [0.0, 1, 0], 50.0, 70, 45, 8),
    "tile4": (_three, [4.0, -5.0, 4.0], [0.5, 0.0, 2.0], [0.0, 0, 1], 65.0, 50, 37, 4),
}


def _view(name):
    mk, eye, center, up, fov, w, h, tp = VIEWS[name]
    v, t = mk()
    if name == "padded":
        pad = np.full((5, 3), -1, np.int32)
        t = np.concatenate([t[:60], pad, t[60:], pad])
    args = (np.array(eye, np.float32), np.array(center, np.float32), np.array(up, np.float32),
            fov, w, h)
    gj = jg.build_image_grid(jnp.asarray(v), jnp.asarray(t), *(jnp.asarray(a) for a in args[:3]),
                             *args[3:], tile_px=tp)
    gt = tg.build_image_grid(_t(v), _t(t), *args, tile_px=tp)
    return v, t, args, gj, gt


def _assert_hits(ours, ref, counts=True):
    t, rt = ours.t.numpy(), _np(ref.t)
    hit = np.isfinite(rt)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], rt[hit], rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(ours.tri.numpy(), _np(ref.tri))
    if counts:
        np.testing.assert_array_equal(ours.count.numpy(), _np(ref.count))


@pytest.mark.parametrize("name", list(VIEWS))
def test_image_grid_tables_match_jax(name):
    """Tile table, residual, camera basis and every occupancy bucket (cap,
    tile ids padded to ≥ 512, packed rows with their id bits) equal."""
    *_, gj, gt = _view(name)
    for f in jg.ImageGrid._fields:
        a, b = getattr(gj, f), getattr(gt, f)
        if f == "buckets":
            assert len(a) == len(b) and len(b) > 0
            for (ca, ia, ra), (cb, ib, rb) in zip(a, b):
                assert ca == cb and ib.shape[0] >= 512
                np.testing.assert_array_equal(ib.numpy(), _np(ia))
                np.testing.assert_array_equal(rb.numpy(), _np(ra))
        elif isinstance(b, torch.Tensor):
            np.testing.assert_array_equal(b.numpy(), _np(a), err_msg=f)
        else:
            assert a == b, f
    assert (int((gt.residual >= 0).sum()) > 0) == (name == "inside")


@pytest.mark.parametrize("name", list(VIEWS))
def test_image_cast_matches_jax_and_brute(name):
    v, t, args, gj, gt = _view(name)
    ours = tg.image_cast(gt)
    _assert_hits(ours, jg.image_cast(gj))
    o, d = tr.pinhole_rays(*args, device="cpu")
    brute = tr.cast_rays(o, d, _t(v), _t(t), backend="kernel")
    np.testing.assert_array_equal(ours.count.numpy(), brute.count.numpy())
    np.testing.assert_array_equal(ours.tri.numpy(), brute.tri.numpy())
    assert int((ours.tri >= 0).sum()) > 100


def test_image_cast_blocks_change_nothing(monkeypatch):
    """Blocks of tiles are independent: any block size, and the element
    budget that shrinks blocks of wide buckets, leave every bit unchanged."""
    *_, gt = _view("inside")
    whole = tg.image_cast(gt)
    for tpb in (1, 7, 64):
        for a, b in zip(tg.image_cast(gt, tiles_per_block=tpb), whole):
            assert torch.equal(a, b)
    monkeypatch.setattr(tg, "_BLOCK_ELEMS", 1024)
    for a, b in zip(tg.image_cast(gt), whole):
        assert torch.equal(a, b)


def test_image_cast_tiles_unpacked_table_matches_packed_rows():
    """The table route of ``_image_cast_tiles`` (gathers from tri_of_slot)
    equals the packed-row route for every bucket, padding ids included."""
    *_, gt = _view("outside")
    for cap, ids, rows in gt.buckets:
        common = (gt.eye, gt.right, gt.true_up, gt.fwd, gt.half, gt.aspect, gt.width,
                  gt.height, gt.tile_px, gt.tri_of_slot[:, :cap], gt.v0, gt.e1, gt.e2, gt.valid)
        a = tg._image_cast_tiles(ids, *common, rows_aligned=rows, packed_cells=True)
        b = tg._image_cast_tiles(ids, *common)
        live = ids >= 0
        for x, y in zip(a, b):
            assert torch.equal(x[live], y[live])
        assert not torch.isfinite(a[0][~live]).any()


def _cell_scene():
    m = jm.merge_meshes([jm.sphere_mesh(jnp.array([0.0, 0, 3.0]), 1.0, n_lat=8, n_lon=16),
                         jm.cylinder_mesh(jnp.array([0.0, 0, 1.0]), jnp.array([0.0, 0, 1]),
                                          0.3, 2.0)])
    return _np(m.vertices), _np(m.triangles)


@pytest.mark.parametrize("rpc,direction,back", [(2, [0.2, 0.1, -0.97], 50.0),
                                                (3, [0.3, 0.2, -0.93], 1e3),
                                                (4, [-0.1, 0.25, -0.96], 20.0)])
def test_cell_cast_matches_jax(rpc, direction, back):
    v, t = _cell_scene()
    d = np.array(direction, np.float32)
    d /= np.linalg.norm(d)
    gj = jg.build_ray_grid(jnp.asarray(v), jnp.asarray(t), d, cell_cap=128)
    gt = tg.build_ray_grid(_t(v), _t(t), d, cell_cap=128)
    rj = jg.cell_cast_parallel(gj, d, rays_per_cell_side=rpc, back_dist=back)
    rt = tg.cell_cast_parallel(gt, d, rays_per_cell_side=rpc, back_dist=back)
    assert rt.ray_area == rj.ray_area
    _assert_hits(rt, rj)
    assert int(torch.isfinite(rt.t).sum()) > 50 and int((rt.count >= 2).sum()) > 20
    # the unpacked table route and other cell tiles give the same bits
    for other in (tg.cell_cast_parallel(gt._replace(packed_cells=False), d,
                                        rays_per_cell_side=rpc, back_dist=back),
                  tg.cell_cast_parallel(gt, d, rays_per_cell_side=rpc, back_dist=back,
                                        cell_tile=5)):
        for f in ("t", "tri", "count"):
            assert torch.equal(getattr(other, f), getattr(rt, f))


def test_cell_cast_rows_is_the_shared_body():
    """``_cell_cast_rows`` on a strip of cells (a shard's share) gives that
    strip of the whole cast, bit for bit."""
    v, t = _cell_scene()
    d = np.array([0.2, 0.1, -0.97], np.float32)
    d /= np.linalg.norm(d)
    g = tg.build_ray_grid(_t(v), _t(t), d, cell_cap=128)
    whole = tg.cell_cast_parallel(g, d, rays_per_cell_side=2, back_dist=50.0)
    lo, hi = 37, 37 + g.nx * g.ny // 3
    part = tg._cell_cast_rows(torch.as_tensor(d), g.u, g.v, g.origin_uv, g.cell, g.nx, g.ny,
                              g.tri_of_slot[lo:hi], torch.arange(lo, hi, dtype=torch.int32),
                              g.v0, g.e1, g.e2, g.valid, 2, 16, 50.0,
                              rows_strip=g.cell_rows[lo:hi], packed_cells=True)
    for x, f in zip(part, ("t", "tri", "count")):
        assert torch.equal(x, getattr(whole, f)[lo:hi])


def test_cell_cast_rays_match_brute():
    """Each cell's rays rebuilt on the host hit as the brute cast does."""
    v, t = _cell_scene()
    d = np.array([0.3, 0.2, -0.93], np.float32)
    d /= np.linalg.norm(d)
    g = tg.build_ray_grid(_t(v), _t(t), d, cell_cap=128)
    res = tg.cell_cast_parallel(g, d, rays_per_cell_side=2, back_dist=50.0)
    o = tg.cell_cast_origins(g, d, 2, 50.0).reshape(-1, 3)
    brute = tr.cast_rays(o, torch.as_tensor(d).expand_as(o), _t(v), _t(t), backend="kernel")
    np.testing.assert_array_equal(res.count.reshape(-1).numpy(), brute.count.numpy())
    np.testing.assert_array_equal(res.tri.reshape(-1).numpy(), brute.tri.numpy())
    fin = torch.isfinite(brute.t)
    torch.testing.assert_close(res.t.reshape(-1)[fin], brute.t[fin], rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def big_canopy():
    """A seeded two-crown canopy, meshed by each package and decimated to
    between 2048 and 4096 triangles: ``cast_scene`` takes the image grid."""
    from pyqsm_tpu_torch.ops.voxelmesh import poisson_like_mesh, simplify_mesh

    rng = np.random.default_rng(11)
    crowns = [np.array([0.0, 0.0, 7.5]), np.array([4.0, 1.0, 8.0])]
    pts = np.concatenate([c + rng.normal(size=(3000, 3)) * [1.6, 1.6, 1.0] for c in crowns])
    pts = pts.astype(np.float32)
    mesh = simplify_mesh(poisson_like_mesh(_t(pts), voxel=0.25, blur_iters=1),
                         target_triangles=6000)
    jmesh = j_simplify(j_poisson(jnp.asarray(pts), voxel=0.25, blur_iters=1),
                       target_triangles=6000)
    return mesh, jm.TriMesh(jnp.asarray(mesh.vertices.numpy()),
                            jnp.asarray(mesh.triangles.numpy())), jmesh


def test_cast_scene_takes_the_image_grid_like_jax(big_canopy, monkeypatch):
    mesh, jmesh, built = big_canopy
    assert tmr.IMAGE_GRID_TRIANGLES <= mesh.n_triangles() < tr.GRID_TRIANGLES
    np.testing.assert_array_equal(mesh.triangles.numpy(), _np(built.triangles))
    casts = []
    real = tmr.image_cast
    monkeypatch.setattr(tmr, "image_cast", lambda g: casts.append(g) or real(g))
    cfg = dict(width_px=96, height_px=72)
    ours = tmr.cast_scene(mesh, cfg=RaycastConfig(**cfg), device="cpu")
    ref = jmr.cast_scene(jmesh, cfg=JRaycastConfig(**cfg))
    assert len(casts) == 1 and ours.hit_fraction > 0.05
    _assert_hits(ours.hits, ref.hits)
    assert ours.hit_fraction == ref.hit_fraction
    np.testing.assert_allclose([ours.surface_area_3d, ours.surface_area_2d],
                               [ref.surface_area_3d, ref.surface_area_2d], rtol=1e-5)
    # the same rays through the brute cast: the same exposure
    center = mesh.vertices.mean(dim=0)
    o, d = tr.pinhole_rays(center + torch.tensor([0.0, 0.0, 10.0]), center, [0.0, 1.0, 0.0],
                           RaycastConfig().fov_deg, 96, 72)
    brute = tmr._exposure(tr.cast_rays(o, d, mesh.vertices, mesh.triangles, backend="kernel"),
                          mesh)
    assert brute.hit_fraction == ours.hit_fraction
    np.testing.assert_array_equal(brute.hits.tri.numpy(), ours.hits.tri.numpy())


def test_mesh_helpers_round_trip():
    v, t = _three()
    m = mesh_from_numpy(v, t, device="cpu")
    g = tg.build_image_grid(m.vertices, m.triangles, [4.0, -5.0, 4.0], [0.5, 0.0, 2.0],
                            [0.0, 0, 1], 65.0, 40, 30)
    assert g.eye.dtype == torch.float32 and g.tri_of_slot.dtype == torch.int32
    assert tg.image_cast(g).t.shape == (40 * 30,)
