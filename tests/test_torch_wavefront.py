"""Parity of the port's wavefront caster (``ops/grid3d.grid_cast_wavefront``
and ``two_level_cast(wavefront=True)``) with the JAX package on the CPU, on
the scenes of tests/test_grid3d.py: hit ids and crossing counts equal, hit
distances within 1e-5 relative (XLA's CPU code fuses the Möller–Trumbore
multiply-adds, the port rounds each product), and the same rounds. Each
cast also agrees with the port's own DDA (``grid_cast``) within the JAX
oracle tests' tolerance. The walk (``_enumerate_visits``) and the pair sort
(``_sort_pairs``) equal the JAX package's bit for bit, so that a rounding
fault shows where it lives. Inputs are numpy arrays from a seed, the same
for both packages."""

import contextlib
import functools
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.ops import grid3d as jg
from pyqsm_tpu_torch.ops import grid3d as tg
from tests.test_torch_grid3d import _hotspot, _teapot

RTOL = 1e-5  # the port against the JAX package: hit distances
ORACLE_ATOL = 1e-4  # the port's wavefront against its DDA (tests/test_grid3d.py)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.as_tensor(np.array(x))


def _unit(d):
    d = np.asarray(d, np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def _soup():
    """The 800-triangle random soup and 2048 random rays (tests/test_grid3d.py:156)."""
    rng = np.random.default_rng(0)
    ntri = 800
    v0 = rng.uniform(-4, 4, (ntri, 3)).astype(np.float32)
    verts = np.concatenate([v0, v0 + rng.normal(0, 0.35, (ntri, 3)).astype(np.float32),
                            v0 + rng.normal(0, 0.35, (ntri, 3)).astype(np.float32)])
    tris = np.stack([np.arange(ntri), np.arange(ntri) + ntri, np.arange(ntri) + 2 * ntri],
                    1).astype(np.int32)
    o = rng.uniform(-6, 6, (2048, 3)).astype(np.float32)
    d = _unit(rng.normal(size=(2048, 3)))
    return verts, tris, o, d


@functools.lru_cache(maxsize=None)
def _corridor():
    """A dense wall at the far end of a corridor strewn with decoys, 8192
    rays of which 90 % retire at once and the rest walk the corridor over
    several rounds (tests/test_grid3d.py:186-270)."""
    rng = np.random.default_rng(0)
    ntri = 500
    yz = rng.uniform(-1.5, 1.5, (ntri, 2)).astype(np.float32)
    v0 = np.concatenate([np.full((ntri, 1), 40.0, np.float32), yz], 1)
    verts = np.concatenate([
        v0, v0 + np.array([0.05, 0.4, 0.0], np.float32)
        + rng.normal(0, 0.05, (ntri, 3)).astype(np.float32),
        v0 + np.array([0.05, 0.0, 0.4], np.float32)
        + rng.normal(0, 0.05, (ntri, 3)).astype(np.float32)])
    tris = np.stack([np.arange(ntri), np.arange(ntri) + ntri, np.arange(ntri) + 2 * ntri],
                    1).astype(np.int32)
    ndec = 120
    dc = np.stack([rng.uniform(3.0, 38.0, ndec), rng.uniform(-1.2, 1.2, ndec),
                   rng.uniform(-1.2, 1.2, ndec)], 1).astype(np.float32)
    dverts = np.concatenate([dc, dc + np.array([0.0, 0.02, 0.0], np.float32),
                             dc + np.array([0.0, 0.0, 0.02], np.float32)])
    dtris = (np.stack([np.arange(ndec), np.arange(ndec) + ndec, np.arange(ndec) + 2 * ndec],
                      1).astype(np.int32) + len(verts))
    near = np.array([[0, -9, -9], [0, 9, -9], [0, 0, 9]], np.float32)
    nt0 = len(verts) + len(dverts)
    verts = np.concatenate([verts, dverts, near])
    tris = np.concatenate([tris, dtris, np.array([[nt0, nt0 + 1, nt0 + 2]], np.int32)])
    n_rays = 8192
    o = np.zeros((n_rays, 3), np.float32)
    o[:, 0] = rng.uniform(0.5, 2.0, n_rays)
    o[:, 1:] = rng.uniform(-1.0, 1.0, (n_rays, 2))
    d = np.zeros((n_rays, 3), np.float32)
    d[:, 0] = -1.0
    far = rng.choice(n_rays, n_rays // 10, replace=False)
    d[far, 0] = 1.0
    d[far, 1:] = rng.normal(0, 0.01, (len(far), 2)).astype(np.float32)
    return verts, tris, o, _unit(d)


def _teapot_rays(n_obj, n_far, seed=0):
    """Rays aimed at the small object and wide arena rays (tests/test_grid3d.py:287, 338)."""
    rng = np.random.default_rng(seed)
    g = 200.0
    o_obj = rng.uniform([1.0, -4.0, 0.0], [5.0, 0.0, 3.0], (n_obj, 3))
    d_obj = np.array([3.0, -2.0, 1.0]) - o_obj + rng.normal(0, 0.15, (n_obj, 3))
    o_far = rng.uniform(-g, g, (n_far, 3)).astype(np.float32)
    o_far[:, 2] = rng.uniform(0, 25, n_far)
    d_far = rng.normal(size=(n_far, 3))
    return (np.concatenate([o_obj, o_far]).astype(np.float32),
            _unit(np.concatenate([d_obj, d_far])))


@functools.lru_cache(maxsize=None)
def _scene(name):
    if name == "soup":
        return _soup()
    if name == "corridor":
        return _corridor()
    if name == "teapot":
        v, t = _teapot()
        return (v, t) + _teapot_rays(600, 400)
    # the residual spill: a clump at the origin that overflows a
    # 90th-percentile cap; half the rays aimed at it, half random
    v, t = _hotspot()
    rng = np.random.default_rng(4)
    o = rng.uniform(v.min(0) - 2.0, v.max(0) + 2.0, (1500, 3)).astype(np.float32)
    d = rng.normal(size=(1500, 3))
    d[:750] = rng.normal(0, 0.05, (750, 3)) - o[:750]
    return v, t, o, _unit(d)


@functools.lru_cache(maxsize=None)
def _grids(name):
    v, t, *_ = _scene(name)
    kw = {"cap_percentile": 90.0} if name == "hotspot" else {}
    return (jg.build_grid3d(jnp.asarray(v), jnp.asarray(t), **kw),
            tg.build_grid3d(_t(v), _t(t), **kw))


def _rounds(text):
    """(rnd, rc, blocks, alive) of each ``debug`` round line."""
    return [tuple(int(x) for x in m) for m in
            re.findall(r"rnd=(\d+) rc=(\d+) blocks=(\d+) alive=(\d+)", text)]


def _debug_cast(fn):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        h = fn()
    return h, out.getvalue()


def _assert_matches_jax(ours, ref):
    t, rt = ours.t.numpy(), np.asarray(ref.t)
    hit = np.isfinite(rt)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], rt[hit], rtol=RTOL, atol=0)
    np.testing.assert_array_equal(ours.tri.numpy(), np.asarray(ref.tri))
    np.testing.assert_array_equal(ours.count.numpy(), np.asarray(ref.count))


def _assert_matches_dda(ours, dda, counts):
    """The JAX oracle tests' check of the wavefront against the DDA: the
    same rays hit, t within 1e-4, the ids differing only where two
    triangles give the same t (on < 1 % of hits) and, when every crossing
    is counted, equal counts."""
    t, td = ours.t.numpy(), dda.t.numpy()
    hit = np.isfinite(td)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    np.testing.assert_allclose(t[hit], td[hit], rtol=ORACLE_ATOL, atol=ORACLE_ATOL)
    diff = hit & (ours.tri.numpy() != dda.tri.numpy())
    assert diff.mean() < 0.01
    if counts:
        np.testing.assert_array_equal(ours.count.numpy(), dda.count.numpy())


CASES = [("soup", dict(visits=4, count_all=True)), ("soup", dict(visits=4, count_all=False)),
         ("soup", dict(visits=16, count_all=True)), ("soup", dict(visits=16, count_all=False)),
         ("corridor", dict(visits=4, count_all=True, tail_fallback=0)),
         ("corridor", dict(visits=4, count_all=True, tail_fallback=2048)),
         ("corridor", dict(visits=1, count_all=False, tail_fallback=2048))]


def _case_ids(cases):
    return [f"{n}-" + "-".join(f"{k}{v}" for k, v in kw.items()) for n, kw in cases]


def check_wavefront(name, kw):
    """The same ids, counts and rounds (``debug``'s rc / blocks / alive) as
    the JAX package's wavefront; t within 1e-5. On the corridor the
    frontier is compacted, the survivors resume from their carried cells,
    and at one visit a ray in round 0 the stragglers finish in the DDA
    fallback (``tail_fallback=2048``) or in further rounds (0); on the
    hotspot the spill takes the residual pass."""
    v, t, o, d = _scene(name)
    gj, gt = _grids(name)
    ours, log_t = _debug_cast(lambda: tg.grid_cast_wavefront(gt, _t(o), _t(d), debug=True, **kw))
    ref, log_j = _debug_cast(lambda: jg.grid_cast_wavefront(gj, jnp.asarray(o), jnp.asarray(d),
                                                            debug=True, **kw))
    _assert_matches_jax(ours, ref)
    rounds = _rounds(log_t)
    assert rounds == _rounds(log_j) and rounds
    if name == "corridor":
        assert min(rc for _, rc, _, _ in rounds) < len(o), "compaction never engaged"
        assert len(rounds) >= 2  # the survivors resumed from their carried cells
        # at one cell a ray in round 0, the stragglers reach the DDA fallback
        fallback = kw["visits"] == 1 and kw["tail_fallback"] > 0
        assert ("tail-fallback" in log_t) == ("tail-fallback" in log_j) == fallback
    if name == "hotspot":
        assert gt.n_residual > 0 and "residual" in log_t
    dda = tg.grid_cast(gt, _t(o), _t(d), count_all=kw["count_all"])
    _assert_matches_dda(ours, dda, counts=kw["count_all"])
    assert int(torch.isfinite(ours.t).sum()) > 50


@pytest.mark.parametrize("name,kw", CASES, ids=_case_ids(CASES))
def test_wavefront_matches_jax_and_dda(name, kw):
    check_wavefront(name, kw)


def _walk_args(o, d, torch_side):
    r = len(o)
    if torch_side:
        return (_t(o), _t(d), torch.zeros(r), torch.ones(r, dtype=torch.bool),
                torch.zeros((r, 3), dtype=torch.int32))
    return (jnp.asarray(o), jnp.asarray(d), jnp.zeros(r), jnp.ones(r, bool),
            jnp.zeros((r, 3), jnp.int32))


def test_enumerate_visits_bit_for_bit():
    """One round of the walk from the ray origins (the soup's round 0),
    then a resume round from its carried cells and parameters at the
    escalated quota of round 1: every output equal bit for bit (visited
    cells, covered and resume parameters, frontier, resume cells)."""
    v, t, o, d = _scene("soup")
    gj, gt = _grids("soup")
    ms = gt.nx + gt.ny + gt.nz + 4
    grid_j = (gj.lo, gj.cell, gj.nx, gj.ny, gj.nz, gj.skip)
    grid_t = (gt.lo, gt.cell, gt.nx, gt.ny, gt.nz, gt.skip)
    kw = dict(ray_tile=2048, max_steps=ms)
    ej = jg._enumerate_visits(*_walk_args(o, d, False), *grid_j, visits=4, first_round=True,
                              it_budget=32, **kw)
    et = tg._enumerate_visits(*_walk_args(o, d, True), *grid_t, visits=4, first_round=True,
                              it_budget=32, **kw)
    ej2 = jg._enumerate_visits(jnp.asarray(o), jnp.asarray(d), ej[4], ej[2], ej[3], *grid_j,
                               visits=32, first_round=False, it_budget=ms + 32, **kw)
    et2 = tg._enumerate_visits(_t(o), _t(d), et[4], et[2], et[3], *grid_t, visits=32,
                               first_round=False, it_budget=ms + 32, **kw)
    names = ("vis", "t_cov", "more", "c_next", "t_next")
    for rnd, (a, b) in enumerate(((ej, et), (ej2, et2))):
        for f, x, y in zip(names, a, b):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x), err_msg=f"round {rnd} {f}")
    assert int(et[2].sum()) > 100 and int((et2[0] >= 0).sum()) > 100  # real resumes


def test_sort_pairs_field_for_field():
    """Cell-major stable order, block ids and positions (blocks never span
    two cells), live pairs and the exact live block count, on the soup's
    first round with a quarter of the rays dead."""
    v, t, o, d = _scene("soup")
    gj, gt = _grids("soup")
    ms = gt.nx + gt.ny + gt.nz + 4
    vis = tg._enumerate_visits(*_walk_args(o, d, True), gt.lo, gt.cell, gt.nx, gt.ny, gt.nz,
                               gt.skip, ray_tile=2048, visits=16, max_steps=ms)[0]
    alive = np.random.default_rng(2).random(len(o)) > 0.25
    for blk in (256, 8):
        sj = jg._sort_pairs(jnp.asarray(vis.numpy()), blk, jnp.asarray(alive))
        st = tg._sort_pairs(vis, blk, torch.as_tensor(alive))
        for f, x, y in zip(("skeys", "srays", "blk_id", "pos_in_blk", "live_pair", "n_blk"),
                           sj, st):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x), err_msg=f"block {blk} {f}")
        assert int(st[5]) > 1


def test_wavefront_on_no_rays():
    _, gt = _grids("soup")
    h = tg.grid_cast_wavefront(gt, torch.zeros((0, 3)), torch.ones((0, 3)))
    assert h.t.shape == (0,) and h.uv.shape == (0, 2)
