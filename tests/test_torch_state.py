"""The port's state containers (``pyqsm_tpu_torch/state.py``) against the
JAX package's ``pyqsm_tpu/state.py`` on the same numpy inputs: the padded
``PointCloud`` and its methods, ``Cylinders.capacity``/``volume``,
``SceneState`` and ``concatenate``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyqsm_tpu.state as js
import pyqsm_tpu_torch.state as ts


def _cloud_arrays(seed, n=10):
    rng = np.random.default_rng(seed)
    return dict(points=rng.normal(size=(n, 3)).astype(np.float32),
                colors=rng.uniform(size=(n, 3)).astype(np.float32),
                intensity=rng.uniform(size=n).astype(np.float32),
                normals=rng.normal(size=(n, 3)).astype(np.float32),
                labels=rng.integers(-1, 4, n).astype(np.int32))


def _pair(seed, capacity=16, **drop):
    arrs = {k: v for k, v in _cloud_arrays(seed).items() if k not in drop}
    pts = arrs.pop("points")
    return (js.PointCloud.create(pts, capacity, **arrs),
            ts.PointCloud.create(pts, capacity, **arrs, device="cpu"))


def _same(a, b):
    """Every field of a JAX container equals the port's (None where None)."""
    for f in b._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), y.numpy(), err_msg=f)
            assert y.dtype == torch.from_numpy(np.asarray(x).copy()).dtype, f


@pytest.mark.parametrize("capacity", [None, 16])
def test_create_pads_as_the_jax_package(capacity):
    a, b = _pair(0, capacity)
    _same(a, b)
    assert b.capacity == a.capacity == (16 if capacity else 10)
    assert int(b.count()) == int(a.count()) == 10
    with pytest.raises(ValueError):
        ts.PointCloud.create(np.zeros((5, 3), np.float32), capacity=4, device="cpu")


def test_select_with_and_masked_points():
    a, b = _pair(1)
    keep = np.arange(16) % 3 != 0
    _same(a.select(jnp.asarray(keep)), b.select(torch.as_tensor(keep)))
    np.testing.assert_array_equal(np.asarray(a.masked_points()), b.masked_points().numpy())
    np.testing.assert_array_equal(np.asarray(a.masked_points(0.0)), b.masked_points(0.0).numpy())
    tid = np.arange(16, dtype=np.int32)
    _same(a.with_(tree_id=jnp.asarray(tid)), b.with_(tree_id=torch.as_tensor(tid)))


def test_to_numpy_and_compact():
    a, b = _pair(2, intensity=None)
    keep = np.arange(16) % 4 != 1
    a, b = a.select(jnp.asarray(keep)), b.select(torch.as_tensor(keep))
    da, db = a.to_numpy(), b.to_numpy()
    assert sorted(da) == sorted(db) and "intensity" not in db and "mask" not in db
    for k in da:
        np.testing.assert_array_equal(da[k], db[k])
    ca, cb = a.compact(), b.compact()
    _same(ca, cb)
    assert cb.capacity == ca.capacity == int(keep[:10].sum())


def test_cylinders_capacity_count_and_volume():
    rng = np.random.default_rng(3)
    m = 7
    f = dict(center=rng.normal(size=(m, 3)), axis=rng.normal(size=(m, 3)),
             height=rng.uniform(0.1, 2.0, m), radius=rng.uniform(0.01, 0.4, m))
    f = {k: v.astype(np.float32) for k, v in f.items()}
    f.update(branch_order=np.zeros(m, np.int32), parent=np.full(m, -1, np.int32),
             mask=np.arange(m) < 5)
    a = js.Cylinders(**{k: jnp.asarray(v) for k, v in f.items()})
    b = ts.Cylinders(**{k: torch.as_tensor(v) for k, v in f.items()})
    assert b.capacity == a.capacity == m
    assert int(b.count()) == int(a.count()) == 5
    # float32 sums of 5 products in two orders: within a few ulps
    np.testing.assert_allclose(float(b.volume()), float(a.volume()), rtol=1e-6)
    assert b.volume().dtype == torch.float32


def test_scene_state_and_concatenate():
    a1, b1 = _pair(4)
    a2, b2 = _pair(5, capacity=12, normals=None)
    _same(js.concatenate([a1, a2]), ts.concatenate([b1, b2]))
    sa, sb = js.SceneState(a1), ts.SceneState(b1)
    assert sb.step is None and sa.step is None
    sa, sb = sa.with_(step=jnp.int32(3)), sb.with_(step=torch.tensor(3, dtype=torch.int32))
    assert int(sb.step) == int(sa.step) == 3
    _same(sa.cloud, sb.cloud)


def test_create_defaults_to_the_card():
    import inspect

    assert inspect.signature(ts.PointCloud.create).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ts.PointCloud.create(np.zeros((2, 3), np.float32))
