"""The banded region-grow claim of the PyTorch port against the JAX package
on the CPU (the band cases of tests/test_isolation.py and
tests/test_pallas_kernels.py:87-100): the bf16 band apply and spill, the
claim's band, the banded grow itself, its dispatch, fuzz graphs, its
fallbacks and ``build_trees`` — labels, orders, activity and cycle counts
BIT-EQUAL. The bf16 kernel itself needs the card (marked ``gpu``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.config import IsolationConfig as JIso
from pyqsm_tpu.models import isolation as ji
from pyqsm_tpu.ops import sparse as jsp
from pyqsm_tpu.ops.pallas_kernels import band_matvec_pallas
from pyqsm_tpu_torch.config import IsolationConfig as TIso
from pyqsm_tpu_torch.models import isolation as ti
from pyqsm_tpu_torch.ops import band_matvec as bm
from pyqsm_tpu_torch.ops import sparse as tsp

BS = 256


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b)


def _counts_case(seed, nb=3, c=16):
    """0/1 tiles and a 0/1 frontier, with rows whose counts pass 256 (bf16
    holds integers exactly only up to 256): row r of block 1 has the first
    257 + r window columns set against an all-ones x column 0."""
    rng = np.random.default_rng(seed)
    adj = (rng.uniform(size=(nb, BS, 3 * BS)) < 0.05).astype(np.float32)
    x = (rng.uniform(size=(nb * BS, c)) < 0.1).astype(np.float32)
    x[:, 0] = 1.0
    for r in range(BS):
        adj[1, r, :257 + r] = 1.0
    return adj, x


def test_plain_bf16_apply_counts_in_float32():
    """The plain version upcasts to float32 (the JAX einsum's
    ``preferred_element_type``): float32 out, exact counts above 256 equal
    to the JAX package's einsum and to the dense product, ``y > 0`` as the
    Pallas kernel's (interpret mode)."""
    adj, x = _counts_case(0)
    wb, xb = torch.as_tensor(adj).to(torch.bfloat16), torch.as_tensor(x).to(torch.bfloat16)
    before = bm.LAUNCHES_BF16
    y = bm.band_apply(wb[None], xb[None])[0]
    assert bm.LAUNCHES_BF16 == before  # a CPU tensor takes the plain version
    assert y.dtype == torch.float32
    y_j = np.asarray(jsp._band_apply(jnp.asarray(adj, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)))
    np.testing.assert_array_equal(y.numpy(), y_j)
    n = adj.shape[0] * BS
    dense = np.zeros((n, n), np.float32)
    for b in range(adj.shape[0]):
        lo = (b - 1) * BS
        for j0 in range(3 * BS):
            if 0 <= lo + j0 < n:
                dense[b * BS:(b + 1) * BS, lo + j0] = adj[b, :, j0]
    exact = dense @ x
    np.testing.assert_array_equal(y.numpy(), exact)
    assert exact[BS:2 * BS, 0].min() >= 257  # the counts bf16 would round
    y_p = np.asarray(band_matvec_pallas(jnp.asarray(adj, jnp.bfloat16),
                                        jnp.asarray(x, jnp.bfloat16), interpret=True))
    np.testing.assert_array_equal(y.numpy() > 0, y_p > 0)


def test_spill_apply_bf16_accumulates_in_float32():
    """bf16 spill through ``_spill_apply(sorted_dst=True)``: float32 counts,
    exact past 256, positive exactly where the JAX package's bf16 sum is."""
    rng = np.random.default_rng(1)
    n, r, c = 512, 3000, 16
    s_i = np.sort(rng.integers(0, n, r)).astype(np.int32)
    s_i[:400] = 7  # one row with 400 spill edges
    s_i.sort()
    s_j = rng.integers(0, n, r).astype(np.int32)
    s_w = np.ones(r, np.float32)
    x = (rng.uniform(size=(n, c)) < 0.3).astype(np.float32)
    x[:, 0] = 1.0
    y = tsp._spill_apply(torch.as_tensor(s_i)[None], torch.as_tensor(s_j)[None],
                         torch.as_tensor(s_w).to(torch.bfloat16)[None],
                         torch.as_tensor(x).to(torch.bfloat16)[None], n, sorted_dst=True)[0]
    assert y.dtype == torch.float32
    exact = np.zeros((n, c), np.float32)
    np.add.at(exact, s_i, x[s_j])
    np.testing.assert_array_equal(y.numpy(), exact)
    assert exact[7, 0] >= 400
    y_j = np.asarray(jsp._spill_apply(jnp.asarray(s_i), jnp.asarray(s_j),
                                      jnp.asarray(s_w, jnp.bfloat16),
                                      jnp.asarray(x, jnp.bfloat16), n, sorted_dst=True))
    np.testing.assert_array_equal(y.numpy() > 0, y_j > 0)


def _local_graph(rng, n, k=6, far=0.25, drop=0.1):
    """Mostly-local graph with random far edges (spill-heavy) — the fuzz
    graphs of tests/test_isolation.py."""
    lo = np.maximum(np.arange(n)[:, None] - 200, 0)
    idx = np.where(rng.uniform(size=(n, k)) < far, rng.integers(0, n, (n, k)),
                   np.minimum(lo + rng.integers(0, 400, (n, k)), n - 1)).astype(np.int32)
    idx[idx == np.arange(n)[:, None]] = -1
    idx[rng.uniform(size=(n, k)) < drop] = -1
    return idx


def test_claim_band_matches_jax():
    """The claim's bf16 band (window tiles and spill) equals the JAX
    package's bit for bit on a masked spill-heavy graph."""
    rng = np.random.default_rng(2)
    n = 16 * BS
    idx = _local_graph(rng, n)
    mask = rng.uniform(size=n) > 0.1
    a = ji._claim_band(jnp.asarray(idx), jnp.asarray(mask))
    b = ti._claim_band(torch.as_tensor(idx), torch.as_tensor(mask))
    assert b[0].dtype == torch.bfloat16 and b[3].dtype == torch.bfloat16
    for x, y in zip(a[:4], b[:4]):  # 0/1 weights and row/column ids: exact in float64
        np.testing.assert_array_equal(np.asarray(x).astype(np.float64), y[0].double().numpy())
    assert bool(a[4]) == bool(b[4]) is False


@pytest.mark.parametrize("carry", [False, True], ids=["fresh", "active0"])
def test_region_grow_banded_matches_jax_banded(carry):
    """The port's ``_region_grow_banded`` against the JAX package's, called
    directly at 16 blocks: labels, order, activity and cycles equal."""
    rng = np.random.default_rng(3)
    n = 16 * BS
    idx = _local_graph(rng, n)
    mask = rng.uniform(size=n) > 0.05
    seeds = np.full(n, -1, np.int32)
    seeds[rng.choice(n, 30, replace=False)] = rng.integers(0, 5, 30)
    active0 = np.array([True, False, True, True, False] + [True] * 11) if carry else None
    kw = dict(max_cycles=50, min_frontier=2, cluster_cap=16)
    ja = ji._claim_band(jnp.asarray(idx), jnp.asarray(mask))
    ref = ji._region_grow_banded(*ja[:4], jnp.asarray(seeds), jnp.asarray(mask),
                                 active0=None if active0 is None else jnp.asarray(active0), **kw)
    tb = ti._claim_band(torch.as_tensor(idx), torch.as_tensor(mask))
    res = ti._region_grow_banded(*tb[:4], torch.as_tensor(seeds), torch.as_tensor(mask),
                                 active0=None if active0 is None else torch.as_tensor(active0),
                                 **kw)
    assert res.claim == "band"
    _eq(ref.labels, res.labels)
    _eq(ref.order, res.order)
    _eq(ref.active, res.active)
    assert int(ref.cycles_run) == res.cycles_run
    assert int((res.labels >= 0).sum()) > 300
    assert ti.LAST_BAND["rows"] == n and ti.LAST_BAND["band_bytes"] == 16 * BS * 3 * BS * 2


@pytest.mark.parametrize("trial", range(4))
def test_region_grow_band_fuzz_matches_jax(monkeypatch, trial):
    """Spill-heavy random graphs, masked rows, sparse, single or no seeds
    (the fuzz cases of tests/test_isolation.py:203-250) through the
    ``region_grow`` dispatch under ``PYQSM_CLAIM=band``: the band claim runs
    and equals the JAX package's gather claim."""
    monkeypatch.setenv("PYQSM_CLAIM", "band")
    rng = np.random.default_rng(200 + trial)
    n = 32768
    idx = _local_graph(rng, n)
    mask = rng.uniform(size=n) > (0.2 if trial % 2 else 0.0)
    seeds = np.full(n, -1, np.int32)
    n_seeds = [40, 1, 12, 0][trial]
    if n_seeds:  # seeds on live rows, so the single-seed case grows too
        rows = rng.choice(np.flatnonzero(mask), n_seeds, replace=False)
        seeds[rows] = rng.integers(0, trial + 1, n_seeds)
    kw = dict(max_cycles=40, min_frontier=[2, 1, 3, 2][trial], cluster_cap=16)
    ref = ji._region_grow_gather(jnp.asarray(idx), jnp.asarray(seeds), jnp.asarray(mask), **kw)
    res = ti.region_grow(torch.as_tensor(idx), torch.as_tensor(seeds), torch.as_tensor(mask),
                         **kw)
    assert res.claim == "band"
    assert ti.LAST_BAND["spill_edges"] > n // 2  # the spill carries real work
    _eq(ref.labels, res.labels)
    _eq(ref.order, res.order)
    _eq(ref.active, res.active)
    assert int(ref.cycles_run) == res.cycles_run
    if n_seeds:
        assert res.cycles_run >= 3 and int((res.labels >= 0).sum()) > n // 2


@pytest.mark.parametrize("why", ["spill", "budget", "cap", "rows"])
def test_band_claim_falls_back_to_gather(monkeypatch, why):
    """Under ``PYQSM_CLAIM=band`` the claim falls back to gather (never push)
    when the spill overflows, the bytes budget is short, the cluster cap
    exceeds 128 or the rows are not a multiple of 256 — reporting
    ``claim == "gather"`` with the JAX package's labels."""
    monkeypatch.setenv("PYQSM_CLAIM", "band")
    rng = np.random.default_rng(4)
    n, cap = 32768, 16
    if why == "rows":
        n -= 128
    if why == "spill":  # 8 random far edges a row: ~7.8n spill edges > 6n
        idx = rng.integers(0, n, (n, 8)).astype(np.int32)
        idx[idx == np.arange(n)[:, None]] = -1
    else:
        idx = _local_graph(rng, n, far=0.0)
    if why == "budget":
        monkeypatch.setenv("PYQSM_BAND_BYTES_BUDGET", "1000000")
    if why == "cap":
        cap = 256
    seeds = np.full(n, -1, np.int32)
    seeds[rng.choice(n, 20, replace=False)] = rng.integers(0, 4, 20)
    args = (jnp.asarray(idx), jnp.asarray(seeds), jnp.ones(n, bool))
    kw = dict(max_cycles=30, min_frontier=1, cluster_cap=cap)
    ref = ji.region_grow(*args, **kw)
    assert ji.LAST_CLAIM_KERNEL == "gather"
    res = ti.region_grow(torch.as_tensor(idx), torch.as_tensor(seeds),
                         torch.ones(n, dtype=torch.bool), **kw)
    assert res.claim == "gather"
    _eq(ref.labels, res.labels)
    _eq(ref.order, res.order)
    assert int(ref.cycles_run) == res.cycles_run


def _plot(rng, n_trees=3, n_trunk=4000, n_canopy=9000):
    """Trunk rings under sparse Gaussian canopies: enough distinct voxels at
    the 0.05 m representative size for the band's 32 768-row floor."""
    out = []
    for i in range(n_trees):
        cx = 6.0 * i
        th = rng.uniform(0, 2 * np.pi, n_trunk)
        z = rng.uniform(0, 5, n_trunk)
        r = 0.25 + rng.normal(0, 0.01, n_trunk)
        out.append(np.stack([cx + r * np.cos(th), r * np.sin(th), z], 1))
        out.append(rng.normal([cx, 0.0, 6.5], [1.4, 1.4, 1.0], size=(n_canopy, 3)))
    return np.concatenate(out).astype(np.float32)


def test_build_trees_band_matches_jax(monkeypatch):
    """``build_trees`` under ``PYQSM_CLAIM=band`` runs the band claim on
    ≥ 32 768 representatives and gives the JAX package's labels, orders
    and cycle count."""
    rng = np.random.default_rng(5)
    pts = _plot(rng)
    m = np.ones(len(pts), bool)
    kw = dict(base_min_points=40, low_pctile=5.0, max_dist=0.1, cycles=200, min_frontier=2)
    a = ji.build_trees(jnp.asarray(pts), jnp.asarray(m), JIso(**kw))
    monkeypatch.setenv("PYQSM_CLAIM", "band")
    b = ti.build_trees(pts, m, TIso(**kw), device="cpu")
    assert b.claim == "band"
    assert ti.LAST_BAND["rows"] >= 32768
    _eq(a.labels, b.labels)
    _eq(a.order, b.order)
    assert int(a.cycles_run) == b.cycles_run
    lab = b.labels.numpy()
    assert len(np.unique(lab[lab >= 0])) == 3


def test_bf16_wrapper_takes_only_its_form():
    """The bf16 wrapper launches or raises: CPU tensors, float32 inputs, a
    width outside {16, 32, 64, 128} and mixed dtypes are refused; the f32
    kernel refuses bf16. ``band_apply`` on CPU tensors takes the plain
    version and counts no launch."""
    wb = torch.zeros(1, 2, BS, 3 * BS, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # on the CPU
        bm.band_matvec_bf16_cuda(wb, torch.zeros(1, 2 * BS, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # C = 24
        bm.band_matvec_bf16_cuda(wb, torch.zeros(1, 2 * BS, 24, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # C = 3 is the float32 form's
        bm.band_matvec_bf16_cuda(wb, torch.zeros(1, 2 * BS, 3, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        bm.band_matvec_bf16_cuda(wb, torch.zeros(1, 2 * BS, 16))
    with pytest.raises(TypeError):
        bm.band_matvec_cuda(wb, torch.zeros(1, 2 * BS, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # C = 16 is the bf16 form's
        bm.band_matvec_cuda(wb.float(), torch.zeros(1, 2 * BS, 16))
    before = bm.LAUNCHES_BF16
    y = bm.band_apply(wb, torch.ones(1, 2 * BS, 16, dtype=torch.bfloat16))
    assert y.dtype == torch.float32 and not y.any() and bm.LAUNCHES_BF16 == before


def _two_trees(seed, c, nb, prepadded=False):
    """Two trees of 0/1 tiles [2, nb, 256, 768] and a one-hot x [2, rows, c]
    (ids ≥ c: rows that propose nothing), rows = (nb + 2)·256 with the halo
    blocks (as random as the rest) when ``prepadded``, else nb·256."""
    rng = np.random.default_rng(seed)
    rows = (nb + 2 if prepadded else nb) * BS
    adj = (rng.uniform(size=(2, nb, BS, 3 * BS)) < 0.05).astype(np.float32)
    lab = rng.integers(0, c + 4, (2, rows))
    return adj, (lab[..., None] == np.arange(c)).astype(np.float32)


@pytest.mark.parametrize("nb", [1, 3])
@pytest.mark.parametrize("prepadded", [False, True], ids=["unpadded", "halo"])
@pytest.mark.parametrize("c", bm.BF16_WIDTHS)
def test_bf16_apply_two_trees_windows_stay_in_their_tree(c, prepadded, nb):
    """The per-tree window semantics the bf16 kernel's tensor map must
    reproduce, on T = 2 trees: the plain apply equals the JAX package's
    ``vmap(_band_apply)`` and ``band_matvec_pallas(interpret=True)`` tree by
    tree, bit for bit (0/1 tiles, one-hot x: exact counts). The second
    tree's first and last windows see zeros past its ends (or its own halo
    blocks), never the first tree's rows: its result equals the tree alone
    and does not move when the first tree's x changes."""
    adj, x = _two_trees(100 + c + nb + 7 * prepadded, c, nb, prepadded)
    to_bf16 = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    wb, xb = to_bf16(adj), to_bf16(x)
    y = bm.band_apply(wb, xb, prepadded=prepadded).numpy()
    assert y.dtype == np.float32 and y.shape == (2, nb * BS, c) and y[1].max() > 0
    wj, xj = jnp.asarray(adj, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    _eq(jax.vmap(lambda a, b: jsp._band_apply(a, b, prepadded=prepadded))(wj, xj), y)
    for t in range(2):
        _eq(band_matvec_pallas(wj[t], xj[t], interpret=True, prepadded=prepadded), y[t])
    _eq(y[1], bm.band_apply(wb[1:], xb[1:], prepadded=prepadded)[0])
    x_other = x.copy()
    x_other[0] = 1.0 - x_other[0]
    _eq(y[1], bm.band_apply(wb, to_bf16(x_other), prepadded=prepadded)[1])


@pytest.mark.gpu
def test_band_matvec_bf16_kernel_matches_plain_on_card():
    """The kernel against its plain version on T = 2 trees at nb = 1 (both
    neighbours out of bounds), 5 and 133 (one block more than the H100's
    132 SMs), every C: exact counts, including counts past 256."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode (run chip_smoke.py on the card)")
    for c in bm.BF16_WIDTHS:
        for nb in (1, 5, 133):
            adj, x = _two_trees(6 + nb, c, nb)
            if nb > 1:  # counts past 256 in the second tree's block 1
                x[1, :, 0] = 1.0
                for r in range(BS):
                    adj[1, 1, r, :257 + r] = 1.0
            wb = torch.as_tensor(adj, device="cuda").to(torch.bfloat16)
            xb = torch.as_tensor(x, device="cuda").to(torch.bfloat16)
            before = bm.LAUNCHES_BF16
            y = bm.band_apply(wb, xb)
            assert bm.LAUNCHES_BF16 == before + 1
            assert torch.equal(y.cpu(), bm.band_matvec_plain(wb.cpu(), xb.cpu()))  # exact counts
