"""Eigenfeatures, the wood/leaf classifier and the graph masks of the port
against the JAX package on the CPU. Inputs are numpy arrays from a seed,
the same for both packages; the classifier starts from the JAX package's
initial weights (its ``jax.random.normal`` draws replayed through
``segmentation.weight_draws``). Masks are equal; float tolerances are
stated at each comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.models import graph_features as jgf
from pyqsm_tpu.models import segmentation as js
from pyqsm_tpu.ops import features as jf
from pyqsm_tpu_torch import convert
from pyqsm_tpu_torch.models import graph_features as tgf
from pyqsm_tpu_torch.models import segmentation as ts
from pyqsm_tpu_torch.ops import features as tf
from tests.conftest import synthetic_branch


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.as_tensor(np.array(x))


def jax_weight_draws(seed, shapes):
    """The JAX package's initial-weight draws (segmentation.py:37-40,
    :83-84): ``PRNGKey(seed)`` split once for the init key, which is split
    once a layer."""
    key = jax.random.PRNGKey(seed)
    _, key = jax.random.split(key)
    out = []
    for shape in shapes:
        key, sub = jax.random.split(key)
        out.append(torch.as_tensor(np.asarray(jax.random.normal(sub, shape))))
    return out


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(ts, "weight_draws", jax_weight_draws)


def _tree_scene(seed=0):
    """A trunk (wood, 0) inside a leafy blob (leaf, 1), plus a line and a
    plane for the degenerate features."""
    rng = np.random.default_rng(seed)
    trunk = synthetic_branch(1200, radius=0.15, length=4.0, seed=seed)
    leaves = (rng.normal(size=(1500, 3)) * [0.9, 0.9, 0.6] + [0, 0, 3.2]).astype(np.float32)
    line = np.stack([np.linspace(3, 5, 200), np.zeros(200), np.zeros(200)], 1).astype(np.float32)
    plane = np.concatenate([rng.uniform(-1, 1, (300, 2)), np.zeros((300, 1))], 1)
    plane = (plane + [-4, 0, 0]).astype(np.float32)
    pts = np.concatenate([trunk, leaves, line, plane]).astype(np.float32)
    labels = np.concatenate([np.zeros(1200), np.ones(1500), np.zeros(200), np.ones(300)])
    mask = rng.uniform(size=len(pts)) < 0.97
    return pts, labels.astype(np.int32), mask


@pytest.fixture(scope="module")
def scene():
    pts, labels, mask = _tree_scene()
    jfeat = {k: np.asarray(v) for k, v in
             jf.compute_features(jnp.asarray(pts), jnp.asarray(mask), k=16).items()}
    return pts, labels, mask, jfeat


def test_features_equal_masks_and_close_values(scene):
    """The gate equal (a feature is 0 on exactly the rows the JAX package
    zeroes: dead rows and rows with fewer than 3 neighbours; PCA1 is
    positive on every other row). Neighbour means and covariances equal
    XLA's (sums in order, the products fused); the trigonometric 3×3
    eigenvalue formula takes arccos(r) with |r| near 1 where two
    eigenvalues nearly coincide, so one ulp of r, which the two compilers
    round differently, moves an eigenvalue by up to √eps·λ1 ≈ 3e-4·λ1.
    So: at least 93 % of the live rows of every feature within 2e-5
    relative, and every row within 2e-3 of the feature's largest value
    (the entropy's logarithm amplifies the eigenvalue error most)."""
    pts, _, mask, jfeat = scene
    ours = tf.compute_features(_t(pts), _t(mask), k=16)
    assert tuple(ours) == tf.FEATURE_NAMES == jf.FEATURE_NAMES
    live = jfeat["PCA1"] > 0
    np.testing.assert_array_equal(ours["PCA1"].numpy() > 0, live)
    assert live.sum() > 0.9 * mask.sum()
    for name in tf.FEATURE_NAMES:
        a, b = ours[name].numpy(), jfeat[name]
        assert (a[~live] == 0).all() and (b[~live] == 0).all(), name
        scale = max(float(np.abs(b).max()), 1e-12)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 * scale, err_msg=name)
        close = np.abs(a - b) <= 2e-5 * np.abs(b)
        assert close[live].mean() >= 0.93, (name, close[live].mean())
    line = slice(2700, 2900)
    live = mask[line]
    np.testing.assert_allclose(ours["linearity"].numpy()[line][live], 1.0, atol=5e-4)
    plane = slice(2900, 3200)
    assert np.median(ours["planarity"].numpy()[plane][mask[plane]]) > 0.5


def test_replace_smooth_expand(scene):
    """``replace_nan_features`` equal, ``smooth_feature`` and
    ``expand_to_original`` within 1e-6 relative (float64 sums against
    XLA's float32 ones)."""
    pts, _, mask, jfeat = scene
    v = jfeat["linearity"].copy()
    v[::7] = np.nan
    v[5] = np.inf
    np.testing.assert_allclose(
        tf.replace_nan_features(_t(v), _t(mask)).numpy(),
        np.asarray(jf.replace_nan_features(jnp.asarray(v), jnp.asarray(mask))), rtol=1e-6)
    s = jfeat["planarity"]
    np.testing.assert_allclose(
        tf.smooth_feature(_t(pts), _t(s), _t(mask), k=10).numpy(),
        np.asarray(jf.smooth_feature(jnp.asarray(pts), jnp.asarray(s), jnp.asarray(mask),
                                     k=10)), rtol=1e-6, atol=1e-7)
    coarse = pts[::4]
    cmask = mask[::4]
    for k in (1, 3):
        np.testing.assert_allclose(
            tf.expand_to_original(_t(coarse), _t(s[::4]), _t(cmask), _t(pts), _t(mask),
                                  k=k).numpy(),
            np.asarray(jf.expand_to_original(jnp.asarray(coarse), jnp.asarray(s[::4]),
                                             jnp.asarray(cmask), jnp.asarray(pts),
                                             jnp.asarray(mask), k=k)),
            rtol=1e-6, atol=1e-7)


def _near_ties(logits, tol=1e-4):
    top2 = np.sort(logits, axis=1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) <= tol


@pytest.fixture(scope="module")
def trained(scene):
    """The JAX package's classifier trained on the scene's features, and
    its initial weights."""
    pts, labels, mask, jfeat = scene
    x = np.stack([jfeat[n] for n in jf.FEATURE_NAMES], 1)
    rows = np.arange(0, len(pts), 3)
    y = np.zeros(len(pts), np.int32)
    y[rows] = labels[rows]
    lmask = np.zeros(len(pts), bool)
    lmask[rows] = True
    lmask &= mask
    jclf, jm = js.train_classifier(jnp.asarray(x), jnp.asarray(y), jnp.asarray(lmask),
                                   epochs=120, seed=3)
    return x, y, lmask, jclf, jm


def test_train_classifier_from_jax_initial_weights(trained, jax_draws):
    """From the same initial weights and split, 120 Adam steps: the loss
    within 1e-4 relative, the feature moments within 1e-6 relative, the
    accuracies equal; 99 % of each layer's weights within 1e-4 of the
    layer's largest weight and every weight within 5e-4 absolute (Adam
    divides each gradient by its own running RMS, so a weight of a unit
    whose gradient is float noise in both packages steps up to lr = 1e-3
    in a direction the noise picks: 14 of w1's 2048 weights part by up to
    1.4e-4); predictions on every row equal apart from rows whose JAX
    top-two logits are within 1e-4 (counted, at most 3)."""
    x, y, lmask, jclf, jm = trained
    clf, m = ts.train_classifier(_t(x), _t(y), _t(lmask), epochs=120, seed=3, device="cpu")
    assert abs(m["loss"] - jm["loss"]) <= 1e-4 * abs(jm["loss"])
    assert m["train_acc"] == pytest.approx(jm["train_acc"], abs=1e-9)
    assert m["val_acc"] == pytest.approx(jm["val_acc"], abs=1e-9)
    got = convert.classifier_to_numpy(clf)
    np.testing.assert_allclose(got["feat_mean"], np.asarray(jclf.feat_mean), rtol=1e-6)
    np.testing.assert_allclose(got["feat_std"], np.asarray(jclf.feat_std), rtol=1e-6)
    for name, w in jclf.params.items():
        w = np.asarray(w)
        err = np.abs(got["params"][name] - w)
        assert err.max() <= 5e-4, (name, err.max())
        assert (err <= 1e-4 * np.abs(w).max()).mean() >= 0.99, name
    jl = np.asarray(js._mlp_logits(jclf.params, (jnp.asarray(x) - jclf.feat_mean)
                                   / jclf.feat_std))
    ours = ts.predict(clf, _t(x)).numpy()
    ref = np.asarray(js.predict(jclf, jnp.asarray(x)))
    ties = _near_ties(jl)
    assert ties.sum() <= 3, int(ties.sum())
    np.testing.assert_array_equal(ours[~ties], ref[~ties])


def test_predict_and_proba_from_carried_weights(trained):
    """The JAX package's trained weights carried across: predictions equal
    (no near-ties among the rows), probabilities within 1e-6."""
    x, _, _, jclf, _ = trained
    params = {k: np.asarray(v) for k, v in jclf.params.items()}
    clf = convert.classifier_from_numpy(params, np.asarray(jclf.feat_mean),
                                        np.asarray(jclf.feat_std), jclf.n_classes, device="cpu")
    back = convert.classifier_to_numpy(clf)
    for k, v in params.items():
        np.testing.assert_array_equal(back["params"][k], v)
    ours = ts.predict(clf, _t(x)).numpy()
    ref = np.asarray(js.predict(jclf, jnp.asarray(x)))
    jl = np.asarray(js._mlp_logits(jclf.params, (jnp.asarray(x) - jclf.feat_mean)
                                   / jclf.feat_std))
    ties = _near_ties(jl, 1e-5)
    np.testing.assert_array_equal(ours[~ties], ref[~ties])
    np.testing.assert_allclose(ts.predict_proba(clf, _t(x)).numpy(),
                               np.asarray(js.predict_proba(jclf, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    # argmax ties go to the lower class, as jnp.argmax
    tie = convert.classifier_from_numpy(
        {"w0": np.zeros((11, 3), np.float32), "b0": np.zeros(3, np.float32)},
        np.zeros(11), np.ones(11), 3, device="cpu")
    assert (ts.predict(tie, _t(x)).numpy() == 0).all()


def test_classify_wood_leaf_matches_jax(scene, jax_draws):
    """End to end on the scene (k = 16, 150 epochs): the predictions equal
    the JAX package's outside its near-tie rows, dead rows -1, and the
    classifier separates the trunk from the leaves."""
    pts, labels, mask, _ = scene
    rows = np.arange(0, len(pts), 5).astype(np.int32)
    jp, jclf, jm = js.classify_wood_leaf(jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(rows),
                                         jnp.asarray(labels[rows]), k=16, epochs=150)
    tp, clf, m = ts.classify_wood_leaf(pts, mask, rows, labels[rows], k=16, epochs=150,
                                       device="cpu")
    tp = tp.numpy()
    feats = jf.compute_features(jnp.asarray(pts), jnp.asarray(mask), k=16)
    x = js.stack_features(feats)
    jl = np.asarray(js._mlp_logits(jclf.params, (x - jclf.feat_mean) / jclf.feat_std))
    ties = _near_ties(jl)
    assert ties.sum() <= 3, int(ties.sum())
    np.testing.assert_array_equal(tp[~ties], np.asarray(jp)[~ties])
    assert (tp[~mask] == -1).all()
    assert m["val_acc"] == pytest.approx(jm["val_acc"], abs=1e-9) and m["val_acc"] > 0.85
    assert clf.n_classes == jclf.n_classes == 2


def _order_scene(seed=4):
    rng = np.random.default_rng(seed)
    pts = synthetic_branch(2500, radius=0.3, length=3.0, seed=seed)
    order = (pts[:, 2] * 6).astype(np.int32) + rng.integers(0, 3, len(pts)).astype(np.int32)
    order[rng.uniform(size=len(pts)) < 0.05] = -1
    late = rng.uniform(size=len(pts)) < 0.03
    order[late] += 12
    return pts, order, rng.uniform(size=len(pts)) < 0.96


def test_graph_masks_equal():
    """``leaf_mask_by_degree`` (mask and degree), ``exclude_dense_areas``
    and ``leaf_mask_by_order_diff`` equal on a trunk with late-claimed
    rows."""
    pts, order, mask = _order_scene()
    P, M = jnp.asarray(pts), jnp.asarray(mask)
    leaf, deg = tgf.leaf_mask_by_degree(_t(pts), _t(mask), radius=0.15)
    jleaf, jdeg = jgf.leaf_mask_by_degree(P, M, radius=0.15)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    for pct in (50.0, 75.0):
        np.testing.assert_array_equal(
            tgf.exclude_dense_areas(_t(pts), _t(mask), radius=0.15, degree_pctile=pct,
                                    top_components=2).numpy(),
            np.asarray(jgf.exclude_dense_areas(P, M, radius=0.15, degree_pctile=pct,
                                               top_components=2)))
    for k in (8, 9):
        ours = tgf.leaf_mask_by_order_diff(_t(pts), _t(order), _t(mask), radius=0.2, k=k)
        ref = jgf.leaf_mask_by_order_diff(P, jnp.asarray(order), M, radius=0.2, k=k)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        assert 0 < int(ours.sum()) < mask.sum()


def test_nanmedian_rows_even_counts_and_all_nan():
    """The median of each row as ``jnp.nanmedian``: the mean of the two
    middle values of an even count, NaN for an all-NaN row."""
    nan = np.nan
    rows = np.array([[1, 5, nan, 2], [4, nan, nan, nan], [nan, nan, nan, nan],
                     [3, 1, 2, 10], [7, 7, 1, nan], [2.5, -1, nan, 8]], np.float32)
    ours = tgf._nanmedian_rows(_t(rows)).numpy()
    ref = np.asarray(jnp.nanmedian(jnp.asarray(rows), axis=1))
    np.testing.assert_array_equal(ours, ref)
    assert ours[3] == 2.5 and np.isnan(ours[2])
    rng = np.random.default_rng(1)
    big = rng.integers(0, 40, (500, 16)).astype(np.float32)
    big[rng.uniform(size=big.shape) < 0.4] = nan
    np.testing.assert_array_equal(tgf._nanmedian_rows(_t(big)).numpy(),
                                  np.asarray(jnp.nanmedian(jnp.asarray(big), axis=1)))
