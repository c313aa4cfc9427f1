"""Parity of the port's banded matvec, sparse operators, Laplacian and PCG
with the JAX package on the CPU, the overflow routes (a spill that
overflows the band, in-degrees that overflow the transpose ELL), plus the
kernel-vs-plain checks that need the card (marked ``gpu``; they skip
without one)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.ops import laplacian as jlap
from pyqsm_tpu.ops import sparse as jsp
from pyqsm_tpu.ops.pallas_kernels import band_matvec_pallas, band_matvec_t_pallas
from pyqsm_tpu_torch.convert import state_from_numpy
from pyqsm_tpu_torch.ops import band_matvec as bm
from pyqsm_tpu_torch.ops import laplacian as tlap
from pyqsm_tpu_torch.ops import sparse as tsp

BS = 256


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _band_inputs(seed, t=2, nb=3, c=3):
    rng = np.random.default_rng(seed)
    b_w = rng.normal(size=(t, nb, BS, 3 * BS)).astype(np.float32)
    x = rng.normal(size=(t, nb * BS, c)).astype(np.float32)
    return b_w, x


def _scale(b_w, x):
    """Σ_j |W_ij||x_j| per output row: f32 sums of 768 terms in two orders
    differ by at most 768·2⁻²⁴ of it."""
    return np.asarray(jax.vmap(jsp._band_apply)(jnp.abs(jnp.asarray(b_w)), jnp.abs(jnp.asarray(x))))


@pytest.mark.parametrize("nb", [1, 3])
def test_band_plain_matches_jax_einsum_and_pallas(nb):
    b_w, x = _band_inputs(1, nb=nb)
    y_t = bm.band_apply(torch.as_tensor(b_w), torch.as_tensor(x)).numpy()
    y_j = np.asarray(jax.vmap(jsp._band_apply)(jnp.asarray(b_w), jnp.asarray(x)))
    y_p = np.asarray(jax.vmap(lambda a, b: band_matvec_pallas(a, b, interpret=True))(
        jnp.asarray(b_w), jnp.asarray(x)))
    tol = 768 * 2.0 ** -24 * _scale(b_w, x)
    assert np.all(np.abs(y_t - y_j) <= tol)
    assert np.all(np.abs(y_t - y_p) <= tol)


def test_band_transpose_matches_jax_transpose_apply():
    """The Wᵀ band equals the JAX package's; applying it with the forward
    kernel's plain version gives the JAX package's transpose apply."""
    b_w, x = _band_inputs(2)
    bt = tsp.band_transpose(torch.as_tensor(b_w))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jax.vmap(jsp.band_transpose)(jnp.asarray(b_w))))
    y_t = bm.band_apply(bt, torch.as_tensor(x)).numpy()
    y_j = np.asarray(jax.vmap(jsp._band_apply_t)(jnp.asarray(b_w), jnp.asarray(x)))
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=768 * 2.0 ** -24 * 4 * np.abs(y_j).max())


@pytest.mark.parametrize("nb", [1, 3])
def test_band_matvec_t_plain_matches_pallas_and_einsum(nb):
    """The transpose's plain version against the Pallas transpose kernel
    (interpret mode) and the JAX package's einsum route, per tree."""
    b_w, x = _band_inputs(8, nb=nb)
    y_t = bm.band_apply_t(torch.as_tensor(b_w), torch.as_tensor(x)).numpy()
    y_j = np.asarray(jax.vmap(jsp._band_apply_t)(jnp.asarray(b_w), jnp.asarray(x)))
    y_p = np.stack([np.asarray(band_matvec_t_pallas(jnp.asarray(b_w[i]), jnp.asarray(x[i]),
                                                    interpret=True)) for i in range(len(b_w))])
    # f32 sums of at most 768 terms in different orders: each within
    # 768·2⁻²⁴·Σ_i|W_ij||x_i| of the exact value
    mag = np.asarray(jax.vmap(jsp._band_apply_t)(jnp.abs(jnp.asarray(b_w)), jnp.abs(jnp.asarray(x))))
    tol = 2 * 768 * 2.0 ** -24 * mag
    assert np.all(np.abs(y_t - y_j) <= tol)
    assert np.all(np.abs(y_t - y_p) <= tol)


def _graph(seed, n=1024, k=8, far=0.2):
    rng = np.random.default_rng(seed)
    lo = np.maximum(np.arange(n)[:, None] - 300, 0)
    idx = np.minimum(lo + rng.integers(0, 600, (n, k)), n - 1)
    idx = np.where(rng.random((n, k)) < far, rng.integers(0, n, (n, k)), idx).astype(np.int32)
    idx[rng.random((n, k)) < 0.1] = -1
    w = np.where(idx >= 0, rng.random((n, k)), 0).astype(np.float32)
    return idx, w


@pytest.mark.parametrize("cap", [64, 4096])
def test_build_banded_and_spill_transpose(cap):
    idx, w = _graph(3)
    a = jsp.build_banded(jnp.asarray(idx), jnp.asarray(w), spill_cap=cap)
    b = tsp.build_banded(torch.as_tensor(idx)[None], torch.as_tensor(w)[None], spill_cap=cap)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y[0].numpy())
    n = idx.shape[0]
    for x, y in zip(jsp.sort_spill_transpose(*a[1:4], n), tsp.sort_spill_transpose(*b[1:4], n)):
        np.testing.assert_array_equal(np.asarray(x), y[0].numpy())


@pytest.mark.parametrize("kt", [8, 64])
def test_build_transpose_ell(kt):
    idx, w = _graph(4)
    a = jsp.build_transpose_ell(jnp.asarray(idx), jnp.asarray(w), kt=kt)
    b = tsp.build_transpose_ell(torch.as_tensor(idx), torch.as_tensor(w), kt=kt)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def _tree_cloud(n=1536, live=1500):
    rng = np.random.default_rng(5)
    z = rng.uniform(0, 3, live)
    th = rng.uniform(0, 2 * np.pi, live)
    pts = np.zeros((n, 3), np.float32)
    pts[:live] = np.stack([0.3 * np.cos(th), 0.3 * np.sin(th), z], 1)
    m = np.arange(n) < live
    perm = np.asarray(jnp.argsort(jsp.morton_codes(jnp.asarray(pts), jnp.asarray(m))))
    return pts[perm], m[perm]


def _carry(L):
    return state_from_numpy("laplacian", {f: None if getattr(L, f) is None else np.asarray(getattr(L, f))
                                          for f in L._fields}, device="cpu")


@pytest.mark.parametrize("banded", [False, True])
def test_point_cloud_laplacian_matches_jax(banded):
    pts, m = _tree_cloud()
    La = jlap.point_cloud_laplacian(jnp.asarray(pts), jnp.asarray(m), 12, 1e-6, banded=banded)
    Lb = tlap.point_cloud_laplacian(torch.as_tensor(pts), torch.as_tensor(m), 12, 1e-6,
                                    banded=banded)
    if banded:  # the kernel takes the tiles as they are built: contiguous
        assert Lb.b_w.is_contiguous() and Lb.b_w_t.is_contiguous()
    for f in La._fields:
        x, y = getattr(La, f), getattr(Lb, f)
        if x is None:
            assert y is None, f
            continue
        x, y = np.asarray(x), y[0].numpy()
        if x.dtype.kind in "bi":
            np.testing.assert_array_equal(x, y, err_msg=f)  # the same kNN graph
        else:
            # exp/sum rounding apart: weights within a few ulp
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("banded", [False, True])
def test_pcg_on_carried_laplacian(banded):
    """One JAX-built Laplacian goes through both solvers (independent of
    kNN ties): the matvec, the Jacobi diagonal and the PCG solution agree."""
    pts, m = _tree_cloud()
    La = jlap.point_cloud_laplacian(jnp.asarray(pts), jnp.asarray(m), 12, 1e-6, banded=banded)
    Lc = _carry(La)
    rng = np.random.default_rng(6)
    n = len(pts)
    wl = rng.uniform(1, 3, n).astype(np.float32)
    wh = rng.uniform(0.5, 2, n).astype(np.float32)
    b = (wh * wh)[:, None] * pts
    twl, twh = torch.as_tensor(wl)[None], torch.as_tensor(wh)[None]
    mv_j = np.asarray(jsp.normal_matvec(La, jnp.asarray(wl), jnp.asarray(wh), jnp.asarray(pts)))
    mv_t = tsp.normal_matvec(Lc, twl, twh, torch.as_tensor(pts)[None])[0].numpy()
    # Lᵀ·WL²·L·x cancels (deg·x − W·x): relative to the operator's scale
    np.testing.assert_allclose(mv_t, mv_j, rtol=0, atol=1e-4 * np.abs(mv_j).max())
    d_j = np.asarray(jsp.normal_diag(La, jnp.asarray(wl), jnp.asarray(wh)))
    d_t = tsp.normal_diag(Lc, twl, twh)[0].numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6)
    x_j, r_j = jsp.pcg((La, jnp.asarray(wl), jnp.asarray(wh)), jnp.asarray(b), jnp.asarray(d_j),
                       x0=jnp.asarray(pts), tol=3e-4, max_iters=40)
    x_t, r_t = tsp.pcg((Lc, twl, twh), torch.as_tensor(b)[None], torch.as_tensor(d_t)[None],
                       x0=torch.as_tensor(pts)[None], tol=3e-4, max_iters=40)
    # 40 CG steps amplify summation-order rounding: 1e-3 m on a 3 m cloud
    np.testing.assert_allclose(x_t[0].numpy(), np.asarray(x_j), rtol=0, atol=1e-3)
    assert abs(float(r_t[0]) - float(r_j)) <= 0.05 * float(r_j) + 1e-6


@pytest.mark.parametrize("drop", ["b_w_t", "st", "both"])
def test_rmatvec_without_wt_band_or_sorted_spill(drop):
    """A banded Laplacian without its Wᵀ band goes through the transpose
    apply; one without its column-sorted spill through the unsorted one.
    Both packages build the Laplacian from one cloud; the port's Lᵀx must
    equal the JAX package's and the port's own Wᵀ-band route."""
    pts, m = _tree_cloud()
    La = jlap.point_cloud_laplacian(jnp.asarray(pts), jnp.asarray(m), 12, 1e-6, banded=True)
    Lb = tlap.point_cloud_laplacian(torch.as_tensor(pts), torch.as_tensor(m), 12, 1e-6,
                                    banded=True)
    cut = {}
    if drop in ("b_w_t", "both"):
        cut["b_w_t"] = None
    if drop in ("st", "both"):
        cut.update(st_i=None, st_j=None, st_w=None)
    x = np.random.default_rng(9).normal(size=pts.shape).astype(np.float32)
    y_j = np.asarray(jsp.laplacian_rmatvec(La._replace(**cut), jnp.asarray(x)))
    y_full = tsp.laplacian_rmatvec(Lb, torch.as_tensor(x)[None])[0].numpy()
    y_t = tsp.laplacian_rmatvec(Lb._replace(**cut), torch.as_tensor(x)[None])[0].numpy()
    # the port's two routes differ only in f32 summation order
    np.testing.assert_allclose(y_t, y_full, rtol=0, atol=1e-5 * np.abs(y_full).max())
    # the packages' weights differ by a few ulp (exp/sum rounding)
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-4 * np.abs(y_j).max())


def test_pcg_freezes_converged_trees():
    """Batched PCG: a tree that meets its tolerance stops changing while
    the other keeps iterating (the vmapped while_loop's semantics)."""
    pts, m = _tree_cloud()
    L = tlap.point_cloud_laplacian(torch.as_tensor(np.stack([pts, pts])),
                                   torch.as_tensor(np.stack([m, m])), 12, 1e-6, banded=True)
    n = len(pts)
    wl = torch.full((2, n), 2.0)
    wh = torch.full((2, n), 1.0)
    x_true = torch.as_tensor(np.stack([pts, pts]))
    b = tsp.normal_matvec(L, wl, wh, x_true)
    x0 = torch.stack([x_true[0], x_true[1] + 0.1])  # tree 0 starts at the solution
    diag = tsp.normal_diag(L, wl, wh)
    x, r = tsp.pcg((L, wl, wh), b, diag, x0=x0, tol=1e-4, max_iters=30)
    assert torch.equal(x[0], x0[0])
    assert float(r[1]) < 0.1 and not torch.equal(x[1], x0[1])


def _dense(idx, w, deg):
    n, k = idx.shape
    a = np.diag(deg.astype(np.float64))
    for i in range(n):
        for s in range(k):
            if idx[i, s] >= 0:
                a[i, idx[i, s]] -= w[i, s]
    return a


def _nonlocal_ell(seed, n=1024, k=6):
    rng = np.random.default_rng(seed)
    idx = np.full((n, k), -1, np.int32)
    w = np.zeros((n, k), np.float32)
    for i in range(n):
        idx[i, :k - 1] = rng.choice(np.delete(np.arange(n), i), k - 1, replace=False)
        w[i, :k - 1] = rng.uniform(0.1, 1.0, k - 1)
    return idx, w


def test_banded_spill_heavy_and_overflow():
    """A non-local graph (the oracle of tests/test_skeleton.py:346-364):
    with a roomy spill the banded L and Lᵀ applies are exact against the
    dense matrix; with a tiny spill the build flags its overflow exactly
    as the JAX package's does."""
    idx, w = _nonlocal_ell(11)
    n = idx.shape[0]
    deg = w.sum(1)
    A = _dense(idx, w, deg)
    x = np.random.default_rng(12).normal(size=(n, 2)).astype(np.float32)
    T = lambda a: torch.as_tensor(a)[None]  # noqa: E731
    for cap in (6 * n, 8):
        a = jsp.build_banded(jnp.asarray(idx), jnp.asarray(w), spill_cap=cap)
        b_w, s_i, s_j, s_w, over = tsp.build_banded(T(idx), T(w), spill_cap=cap)
        assert bool(over[0]) == bool(a[4]) == (cap == 8)
        for u, v in zip(a[:4], (b_w, s_i, s_j, s_w)):
            np.testing.assert_array_equal(np.asarray(u), v[0].numpy())
        if cap == 8:
            continue
        assert int((s_i[0] < n).sum()) > n  # most edges ride the spill
        L = tsp.ELLLaplacian(T(idx), T(w), T(deg), torch.ones(1, n), b_w=b_w, s_i=s_i, s_j=s_j,
                             s_w=s_w, s_overflow=over)
        np.testing.assert_allclose(tsp.laplacian_matvec(L, T(x))[0].numpy(), A @ x,
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tsp.laplacian_rmatvec(L, T(x))[0].numpy(), A.T @ x,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kt", [8, 64])
def test_transpose_ell_overflow_takes_the_exact_scatter(kt):
    """Every row points at node 0 (in-degree n-1, the oracle of
    tests/test_skeleton.py:181-215): a transpose ELL of 8 slots flags its
    overflow and Lᵀx takes the exact scatter; with room the gather is
    lossless. Both equal the dense Lᵀx and the JAX package's."""
    rng = np.random.default_rng(13)
    n, k = 40, 5
    idx = np.full((n, k), -1, np.int32)
    w = np.zeros((n, k), np.float32)
    for i in range(n):
        nbrs = ([0] if i else []) + list(rng.choice([j for j in range(1, n) if j != i],
                                                    k - 1 - (1 if i else 0), replace=False))
        idx[i, :len(nbrs)] = nbrs
        w[i, :len(nbrs)] = rng.uniform(0.1, 1.0, len(nbrs))
    deg = w.sum(1)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    t_idx, t_w, over = tsp.build_transpose_ell(torch.as_tensor(idx), torch.as_tensor(w), kt=kt)
    assert bool(over) == (kt == 8)
    T = lambda a: torch.as_tensor(a)[None]  # noqa: E731
    L = tsp.ELLLaplacian(T(idx), T(w), T(deg), torch.ones(1, n), t_idx=t_idx[None], t_w=t_w[None],
                         t_overflow=over[None])
    y = tsp.laplacian_rmatvec(L, T(x))[0].numpy()
    np.testing.assert_allclose(y, _dense(idx, w, deg).T @ x, rtol=1e-4, atol=1e-5)
    jt = jsp.build_transpose_ell(jnp.asarray(idx), jnp.asarray(w), kt=kt)
    Lj = jsp.ELLLaplacian(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(deg), jnp.ones(n),
                          t_idx=jt[0], t_w=jt[1], t_overflow=jt[2])
    np.testing.assert_allclose(y, np.asarray(jsp.laplacian_rmatvec(Lj, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_band_matvec_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run chip_smoke.py on the card)")
    b_w, x = _band_inputs(7, t=2, nb=5)
    tb, tx = torch.as_tensor(b_w, device="cuda"), torch.as_tensor(x, device="cuda")
    before = bm.LAUNCHES
    y = bm.band_apply(tb, tx)
    assert bm.LAUNCHES == before + 1
    ref = bm.band_matvec_plain(tb.cpu(), tx.cpu())
    assert torch.all((y.cpu() - ref).abs() <= 768 * 2.0 ** -24 * torch.as_tensor(_scale(b_w, x)))


@pytest.mark.gpu
def test_band_matvec_t_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run chip_smoke.py on the card)")
    b_w, x = _band_inputs(10, t=2, nb=5)
    tb, tx = torch.as_tensor(b_w, device="cuda"), torch.as_tensor(x, device="cuda")
    before = bm.LAUNCHES_T
    y = bm.band_apply_t(tb, tx)
    assert bm.LAUNCHES_T == before + 1
    ref = bm.band_matvec_t_plain(tb.cpu(), tx.cpu())
    mag = bm.band_matvec_t_plain(tb.cpu().abs(), tx.cpu().abs())
    assert torch.all((y.cpu() - ref).abs() <= 2 * 768 * 2.0 ** -24 * mag)


def _halo_inputs(seed, nb=3, c=16, onehot=False):
    """bf16 tiles [nb, 256, 768] and a prepadded x [(nb + 2)·256, c] whose
    two halo blocks are random, not zero (a shard's neighbours' rows)."""
    rng = np.random.default_rng(seed)
    n_pad = (nb + 2) * BS
    if onehot:
        adj = (rng.uniform(size=(nb, BS, 3 * BS)) < 0.05).astype(np.float32)
        lab = rng.integers(0, c + 4, n_pad)  # ids ≥ c: rows that propose nothing
        x = (lab[:, None] == np.arange(c)[None, :]).astype(np.float32)
    else:
        adj = rng.normal(size=(nb, BS, 3 * BS)).astype(np.float32)
        x = rng.normal(size=(n_pad, c)).astype(np.float32)
    to_bf16 = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    return to_bf16(adj), to_bf16(x)


@pytest.mark.parametrize("onehot", [False, True])
def test_band_plain_prepadded_matches_jax_einsum_and_pallas(onehot):
    """The halo (``prepadded``) form of the plain apply against the JAX
    package's ``_band_apply(prepadded=True)`` einsum and
    ``band_matvec_pallas(interpret=True, prepadded=True)``: 0/1 tiles with
    a one-hot x give exact counts, equal bit for bit; random bf16 within
    768·2⁻²⁴·Σ|W||x| (bf16 products are exact in float32, so only the
    order of the 768-term sums differs)."""
    wb, xb = _halo_inputs(11 + onehot, onehot=onehot)
    y = bm.band_apply(wb[None], xb[None], prepadded=True)[0].numpy()
    wj = jnp.asarray(wb.float().numpy(), jnp.bfloat16)
    xj = jnp.asarray(xb.float().numpy(), jnp.bfloat16)
    y_j = np.asarray(jsp._band_apply(wj, xj, prepadded=True))
    y_p = np.asarray(band_matvec_pallas(wj, xj, interpret=True, prepadded=True))
    assert y.dtype == np.float32 and y.shape == (3 * BS, 16)
    if onehot:
        np.testing.assert_array_equal(y, y_j)
        np.testing.assert_array_equal(y, y_p)
        assert y.max() > 0
    else:
        tol = 768 * 2.0 ** -24 * bm.band_matvec_plain(
            wb.abs()[None], xb.abs()[None], prepadded=True)[0].numpy()
        assert np.all(np.abs(y - y_j) <= tol) and np.all(np.abs(y - y_p) <= tol)


def test_band_prepadded_with_zero_halos_is_the_unpadded_apply():
    """Zero halo blocks make the halo form the unpadded form; a nonzero
    halo moves only the first and last blocks' rows."""
    wb, xb = _halo_inputs(13)
    inner = xb[BS:-BS]
    zero_halo = torch.cat([torch.zeros_like(xb[:BS]), inner, torch.zeros_like(xb[:BS])])
    y0 = bm.band_apply(wb[None], zero_halo[None], prepadded=True)
    assert torch.equal(y0, bm.band_apply(wb[None], inner[None].contiguous()))
    y = bm.band_apply(wb[None], xb[None], prepadded=True)
    assert torch.equal(y[0, BS:2 * BS], y0[0, BS:2 * BS])
    assert not torch.equal(y[0, :BS], y0[0, :BS]) and not torch.equal(y[0, -BS:], y0[0, -BS:])


def test_halo_wrapper_takes_only_its_form():
    """The halo form is bf16 only, with (nb + 2)·256 x rows: the CUDA
    wrapper refuses CPU tensors and other row counts, and no float32 halo
    kernel exists; CPU tensors take the plain version with no launch."""
    wb = torch.zeros(1, 2, BS, 3 * BS, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # on the CPU
        bm.band_matvec_bf16_cuda(wb, torch.zeros(1, 4 * BS, 16, dtype=torch.bfloat16),
                                 prepadded=True)
    with pytest.raises(ValueError):  # nb·256 rows: the unpadded form's
        bm._check_band(wb, torch.zeros(1, 2 * BS, 16, dtype=torch.bfloat16), "halo",
                       bf16=True, prepadded=True)
    with pytest.raises(ValueError):  # no float32 halo form
        bm._check_band(wb.float(), torch.zeros(1, 4 * BS, 3), "band_matvec", prepadded=True)
    before = bm.LAUNCHES_BF16_HALO, bm.LAUNCHES_BF16
    y = bm.band_apply(wb, torch.ones(1, 4 * BS, 16, dtype=torch.bfloat16), prepadded=True)
    assert y.shape == (1, 2 * BS, 16) and not y.any()
    assert (bm.LAUNCHES_BF16_HALO, bm.LAUNCHES_BF16) == before


@pytest.mark.parametrize("shard", range(4))
def test_build_banded_window_matches_jax_per_shard(shard):
    """One shard's band of a globally ordered graph — local rows, global
    in-window columns in the band, global spill columns — equals the JAX
    package's ``build_banded_window`` bit for bit, at a spill cap that
    overflows on some shards and at one that does not."""
    idx, w = _graph(5, n=4096)
    n_local = 1024
    start = shard * n_local
    rows = slice(start, start + n_local)
    for cap in (256, 6 * n_local):
        a = jsp.build_banded_window(jnp.asarray(idx[rows]), jnp.asarray(w[rows]),
                                    jnp.int32(start), cap)
        b = tsp.build_banded_window(torch.as_tensor(idx[rows]), torch.as_tensor(w[rows]), start,
                                    cap)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert bool(b[4]) is False  # the 6·n_local cap holds this shard's spill


@pytest.mark.gpu
def test_band_matvec_bf16_halo_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run chip_smoke.py on the card)")
    for c in bm.BF16_WIDTHS:
        wb, xb = _halo_inputs(14, nb=5, c=c, onehot=True)
        wg, xg = wb.cuda()[None], xb.cuda()[None]
        before = bm.LAUNCHES_BF16_HALO
        y = bm.band_apply(wg, xg, prepadded=True)
        assert bm.LAUNCHES_BF16_HALO == before + 1
        assert torch.equal(y.cpu(), bm.band_matvec_plain(wb[None], xb[None], prepadded=True))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_segment_sum_sorted_and_unsorted_equal_index_add(lead):
    """``segment_sum`` (the deterministic sum behind every float segment sum
    of the main path) against ``index_add_`` in index order, bit for bit:
    the sorted path (``segment_reduce``) skips the dead tail past the last
    destination, the unsorted path drops destinations ≥ n, with and without
    a leading batch axis."""
    from pyqsm_tpu_torch.ops.segment import segment_sum

    rng = np.random.default_rng(21)
    n, e = 40, 300
    b = int(np.prod(lead)) if lead else 1
    idx = np.sort(rng.integers(0, n + 1, (b, e)), axis=1)  # n = dead, sorted last
    vals = (rng.normal(size=(b, e, 3)) * 10.0 ** rng.integers(-3, 4, (b, e, 1))).astype(np.float32)
    ref = np.zeros((b, n + 1, 3), np.float32)
    for t in range(b):
        ref[t] = torch.zeros(n + 1, 3).index_add_(0, torch.as_tensor(idx[t]),
                                                  torch.as_tensor(vals[t])).numpy()
    ti, tv = torch.as_tensor(idx).reshape(*lead, e), torch.as_tensor(vals).reshape(*lead, e, 3)
    want = ref[:, :n].reshape(*lead, n, 3)
    np.testing.assert_array_equal(segment_sum(tv, ti, n, sorted_index=True).numpy(), want)
    perm = rng.permutation(e)  # the same entries out of order: the unsorted path
    got = segment_sum(tv[..., perm, :], ti[..., perm], n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(segment_sum(tv[..., 0], ti, n, sorted_index=True).numpy(),
                                  want[..., 0])
