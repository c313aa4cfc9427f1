"""Parity of the port's wavefront caster with the JAX package on the CPU on
the spill scenes (the rest of tests/test_torch_wavefront.py, whose checks
and helpers these cases share): the teapot in the stadium
(tests/test_grid3d.py:287), the residual-spill hotspot, and
``two_level_cast(wavefront=True)`` on the two-level grid of the teapot
scene (tests/test_grid3d.py:338-395) in both modes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqsm_tpu.ops import grid3d as jg
from pyqsm_tpu_torch.ops import grid3d as tg
from tests.test_torch_grid3d import _teapot
from tests.test_torch_wavefront import (_assert_matches_dda, _assert_matches_jax, _case_ids, _t,
                                        _teapot_rays, check_wavefront)

CASES = [("teapot", dict(count_all=True)),
         ("hotspot", dict(count_all=True)), ("hotspot", dict(count_all=False))]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name,kw", CASES, ids=_case_ids(CASES))
def test_spill_scene_wavefront_matches_jax_and_dda(name, kw):
    """The same ids, counts and rounds as the JAX package's wavefront, t
    within 1e-5; the spilled triangles take the residual pass."""
    check_wavefront(name, kw)


@pytest.mark.parametrize("count_all", [True, False])
def test_two_level_wavefront_matches_jax_and_dda(count_all):
    """Both levels through the wavefront, the sub cast culled (and, for
    closest hits, occlusion-culled) as in the DDA's two-level cast."""
    v, t = _teapot()
    o, d = _teapot_rays(400, 200)
    tj = jg.build_grid3d_two_level(jnp.asarray(v), jnp.asarray(t))
    tt = tg.build_grid3d_two_level(_t(v), _t(t))
    assert isinstance(tt, tg.TwoLevelGrid)
    ours = tg.two_level_cast(tt, _t(o), _t(d), wavefront=True, count_all=count_all)
    ref = jg.two_level_cast(tj, jnp.asarray(o), jnp.asarray(d), wavefront=True,
                            count_all=count_all)
    _assert_matches_jax(ours, ref)
    dda = tg.two_level_cast(tt, _t(o), _t(d), count_all=count_all)
    _assert_matches_dda(ours, dda, counts=count_all)
    assert int(np.isfinite(ours.t.numpy()).sum()) > 300
