"""The port's sharded ray casts (``parallel/raycast.py``) on four gloo ranks
on the CPU, on the scenes of tests/test_parallel.py:83, 144, 174, 203 and
232: every rank's result equals the port's single-device call bit for bit
and the JAX package's single-device call within the tolerances of
tests/test_torch_raycast.py, tests/test_torch_grid3d.py and
tests/test_torch_raygrid.py (hit ids and counts equal).

All four casts run in one ``parallel.mesh.launch``; the rank function lives
at module level, and JAX is imported only inside the functions the parent
runs, so that no rank imports it. Each rank runs torch on one thread."""

import numpy as np
import pytest
import torch

from pyqsm_tpu_torch.parallel import mesh as pm

WORLD = 4
# hit distances against the JAX package: the brute cast and the 3D grid as
# tests/test_torch_raycast.py and tests/test_torch_grid3d.py, the 2D grids
# as tests/test_torch_raygrid.py
TOL = {"rays": (1e-4, 1e-5), "grid": (1e-4, 1e-5), "cell": (1e-5, 1e-6),
       "image": (1e-5, 1e-6), "image_residual": (1e-5, 1e-6)}
CELL_KW = dict(rays_per_cell_side=2, cell_tile=64, back_dist=50.0)
EDGE_RAYS = ("rays", "grid")  # the cases whose bundles run along shared edges


def _near_edge(uv, tri, tol=1e-5):
    """Rays whose hit lies within ``tol`` (barycentric) of a triangle edge."""
    return (tri >= 0) & (np.minimum(np.minimum(uv[:, 0], uv[:, 1]), 1 - uv.sum(1)) < tol)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _scenes():
    """numpy inputs of every case, made by the JAX package's mesh and ray
    generators as tests/test_parallel.py makes them."""
    import jax.numpy as jnp

    from pyqsm_tpu.ops.mesh import cylinder_mesh, merge_meshes, sphere_mesh
    from pyqsm_tpu.ops.raytrace import pinhole_rays

    def npm(m):
        return np.asarray(m.vertices, np.float32), np.asarray(m.triangles, np.int32)

    sphere = sphere_mesh(jnp.array([0.0, 0, 0]), 1.0, n_lat=8, n_lon=16)
    o, d = pinhole_rays(jnp.array([0.0, 0, 5.0]), jnp.array([0.0, 0, 0]), jnp.array([0.0, 1, 0]),
                        60.0, 32, 16)  # 512 rays
    two = merge_meshes([sphere_mesh(jnp.array([0.0, 0, 3.0]), 1.0, n_lat=8, n_lon=16),
                        cylinder_mesh(jnp.array([0.0, 0, 1.0]), jnp.array([0.0, 0, 1]), 0.3, 2.0)])
    center = jnp.mean(two.vertices, axis=0)
    og, dg = pinhole_rays(center + jnp.array([0.0, 0, 8.0]), center, jnp.array([0.0, 1, 0.0]),
                          70.0, 64, 64)
    sun = np.array([0.2, 0.1, -0.97], np.float32)
    sun /= np.linalg.norm(sun)
    wall = merge_meshes([two, sphere_mesh(jnp.array([2.5, -2.0, 2.0]), 2.6, n_lat=6, n_lon=10)])
    view = (np.array([0.0, 0.0, 2.0], np.float32), np.array([0.0, 0.0, 1.0], np.float32), 65.0,
            96, 72)
    return {"rays": npm(sphere) + (np.asarray(o), np.asarray(d)),
            "grid": npm(two) + (np.asarray(og), np.asarray(dg)),
            "cell": npm(two) + (sun,),
            "image": npm(two) + (np.array([4.0, -5.0, 4.0], np.float32),) + view,
            "image_residual": npm(wall) + (np.array([2.0, -1.2, 2.2], np.float32),) + view}


def _port_grids(scenes, device):
    """The port's grids of the cases that cast through one, on ``device``."""
    from pyqsm_tpu_torch.ops import grid3d as tg
    from pyqsm_tpu_torch.ops import raygrid as rg

    def t(x):
        return torch.as_tensor(x, device=device)

    v, tri, *_ = scenes["grid"]
    grids = {"grid": tg.build_grid3d(t(v), t(tri))}
    v, tri, sun = scenes["cell"]
    grids["cell"] = rg.build_ray_grid(t(v), t(tri), sun, cell_cap=128)
    for name in ("image", "image_residual"):
        v, tri, eye, center, up, fov, w, h = scenes[name]
        grids[name] = rg.build_image_grid(t(v), t(tri), eye, center, up, fov, w, h, tile_px=8)
    return grids


def _single(scenes, device="cpu"):
    """The port's single-device calls."""
    from pyqsm_tpu_torch.ops import grid3d as tg
    from pyqsm_tpu_torch.ops import raygrid as rg
    from pyqsm_tpu_torch.ops import raytrace as tr

    grids = _port_grids(scenes, device)
    v, tri, o, d = (torch.as_tensor(x) for x in scenes["rays"])
    out = {"rays": tr.cast_rays(o, d, v, tri, backend="kernel")}
    o, d = (torch.as_tensor(x) for x in scenes["grid"][2:])
    out["grid"] = tg.grid_cast(grids["grid"], o, d, ray_tile=512, count_all=True)
    out["cell"] = rg.cell_cast_parallel(grids["cell"], scenes["cell"][2], **CELL_KW)
    out["image"] = rg.image_cast(grids["image"])
    out["image_residual"] = rg.image_cast(grids["image_residual"])
    return out


def _cast_ranks(scenes, mesh=None):
    """Rank body: the four sharded casts on their scenes, the brute cast
    again over the ``points`` axis of a 2 x 2 ``("trees", "points")`` mesh,
    and whether a ray count that four does not divide raises."""
    from pyqsm_tpu_torch.parallel import raycast as pr

    grids = _port_grids(scenes, mesh.device)
    v, tri, o, d = scenes["rays"]
    out = {"rays": pr.sharded_cast_rays(mesh, o, d, v, tri)}
    out["rays_2d"] = pr.sharded_cast_rays(pm.tree_points_mesh(device="cpu"), o, d, v, tri,
                                          axis="points")
    o, d = scenes["grid"][2:]
    out["grid"] = pr.sharded_grid_cast(mesh, grids["grid"], o, d, ray_tile=512, count_all=True)
    out["cell"] = pr.sharded_cell_cast(mesh, grids["cell"], scenes["cell"][2], **CELL_KW)
    out["image"] = pr.sharded_image_cast(mesh, grids["image"])
    out["image_residual"] = pr.sharded_image_cast(mesh, grids["image_residual"])
    v, tri, o, d = scenes["rays"]
    try:
        pr.sharded_cast_rays(mesh, o[:-2], d[:-2], v, tri)
        out["raised"] = None
    except ValueError as e:
        out["raised"] = str(e)
    return out


@pytest.fixture(scope="module")
def sharded():
    """The scenes, the four ranks' results (one launch), the port's and the
    JAX package's single-device results."""
    import jax.numpy as jnp

    from pyqsm_tpu.ops import grid3d as jg
    from pyqsm_tpu.ops import raygrid as jrg
    from pyqsm_tpu.ops import raytrace as jr

    scenes = _scenes()
    ranks = pm.launch(_cast_ranks, WORLD, "gloo", args=(scenes,), device="cpu")
    v, tri, o, d = (jnp.asarray(x) for x in scenes["rays"])
    ref = {"rays": jr.cast_rays(o, d, v, tri)}
    v, tri, o, d = (jnp.asarray(x) for x in scenes["grid"])
    ref["grid"] = jg.grid_cast(jg.build_grid3d(v, tri), o, d, ray_tile=512, count_all=True)
    v, tri, sun = scenes["cell"]
    ref["cell"] = jrg.cell_cast_parallel(jrg.build_ray_grid(jnp.asarray(v), jnp.asarray(tri), sun,
                                                            cell_cap=128), sun, **CELL_KW)
    for name in ("image", "image_residual"):
        v, tri, eye, center, up, fov, w, h = scenes[name]
        ref[name] = jrg.image_cast(jrg.build_image_grid(
            jnp.asarray(v), jnp.asarray(tri), jnp.asarray(eye), jnp.asarray(center),
            jnp.asarray(up), fov, w, h, tile_px=8))
    return scenes, ranks, _single(scenes), ref


@pytest.mark.parametrize("name", list(TOL))
def test_sharded_cast_matches_single_device(sharded, name):
    """Every rank: t, tri, (uv) and count equal the port's single-device
    call bit for bit; the JAX package's within the stated tolerance, with
    equal ids and counts (outside shared edges in the two bundles that run
    along them)."""
    scenes, ranks, single, ref = sharded
    one = single[name]
    for rank, out in enumerate(ranks):
        got = out[name]
        assert type(got) is type(one), rank
        for f in one._fields:
            a, b = getattr(got, f), getattr(one, f)
            assert (a == b) if f == "ray_area" else torch.equal(a, b), (rank, f)
    t, rt = one.t.numpy().reshape(-1), np.asarray(ref[name].t).reshape(-1)
    tri, rtri = one.tri.numpy().reshape(-1), np.asarray(ref[name].tri).reshape(-1)
    cnt, rcnt = one.count.numpy().reshape(-1), np.asarray(ref[name].count).reshape(-1)
    keep = np.ones(len(t), bool)
    if name in EDGE_RAYS:
        # nadir bundles onto the spheres' meridians: a ray through a shared
        # edge (its hit within 1e-5 of an edge in either cast) may cross or
        # miss it by an ulp of XLA's fused multiply-adds, and count it once
        # or twice (tests/test_torch_raycast.py)
        keep = ~(_near_edge(one.uv.numpy(), tri) | _near_edge(np.asarray(ref[name].uv), rtri))
        assert keep.mean() > 0.98
    hit = np.isfinite(rt) & keep
    rtol, atol = TOL[name]
    np.testing.assert_array_equal(np.isfinite(t)[keep], hit[keep])
    np.testing.assert_allclose(t[hit], rt[hit], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(tri[keep], rtri[keep])
    np.testing.assert_array_equal(cnt[keep], rcnt[keep])
    assert hit.sum() >= 10
    if name == "image_residual":
        res = _port_grids(scenes, "cpu")[name].residual
        assert int((res >= 0).sum()) > 0  # the residual pass ran


def test_sharded_cast_rays_over_one_axis_of_two(sharded):
    """Over the ``points`` axis of a 2 x 2 mesh the ``trees`` ranks hold
    copies: the same result bit for bit."""
    _, ranks, single, _ = sharded
    for out in ranks:
        for a, b in zip(out["rays_2d"], single["rays"]):
            assert torch.equal(a, b)


def test_ray_count_that_the_ranks_do_not_divide_raises(sharded):
    _, ranks, _, _ = sharded
    for out in ranks:
        assert out["raised"] is not None and "do not split over points=4" in out["raised"]
