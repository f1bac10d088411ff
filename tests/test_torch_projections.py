"""Cone projections: scs_tpu_torch against scs_tpu, zero and nonneg cones.

The port's projector and its Moreau dual must equal scs_tpu's exactly on
the same numpy-seeded inputs. Every cone kind has a projection now (the
curved cones' parity is tests/test_torch_cones.py); the cones that used to
raise NotImplementedError must build and match scs_tpu."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scs_tpu.cones import ConeSpec as JConeSpec
from scs_tpu.ops import projections as jpr
from scs_tpu_torch.cones import ConeSpec
from scs_tpu_torch.ops import projections as tpr

torch.set_num_threads(1)

CONES = [{"z": 5, "l": 7}, {"l": 10}, {"z": 4}, {"z": 1, "l": 1}]


def _input(m, seed):
    z = np.random.RandomState(seed).randn(m)
    z[::3] = 0.0  # exact zeros sit on the clamp's kink
    return z


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("cone", CONES)
def test_projector_equals_scs_tpu(cone, dual):
    jspec, tspec = JConeSpec.from_dict(cone), ConeSpec.from_dict(cone)
    make_j = jpr.make_dual_cone_projector if dual else jpr.make_cone_projector
    make_t = tpr.make_dual_cone_projector if dual else tpr.make_cone_projector
    z = _input(tspec.dim, 7)
    out_j = np.asarray(make_j(jspec, jnp.float64)(jnp.asarray(z)))
    out_t = make_t(tspec, torch.float64)(torch.as_tensor(z)).numpy()
    np.testing.assert_array_equal(out_t, out_j)


@pytest.mark.parametrize("cone", CONES)
def test_get_projector_cached_and_signature(cone):
    tspec = ConeSpec.from_dict(cone)
    assert tpr.spec_signature(tspec) == jpr.spec_signature(JConeSpec.from_dict(cone))
    p1 = tpr.get_projector(tspec, torch.float32)
    assert tpr.get_projector(tspec, torch.float32) is p1
    z = _input(tspec.dim, 8).astype(np.float32)
    out = p1(torch.as_tensor(z))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(
        out.numpy(),
        np.asarray(jpr.make_cone_projector(JConeSpec.from_dict(cone), jnp.float32)(jnp.asarray(z))),
    )


@pytest.mark.parametrize("cone,item", [
    ({"bu": [1.0], "bl": [0.0]}, "item 4"),
    ({"q": [3]}, "item 12"),
    ({"s": [2]}, "item 12"),
    ({"ep": 1}, "item 12"),
    ({"p": [0.5]}, "item 12"),
])
def test_unported_cones_raise(cone, item):
    """These cones raised NotImplementedError naming ROADMAP.md Queue 1
    `item` until their projections were ported: now nothing raises, and the
    projector equals scs_tpu's (f64, 1e-9 of 1 + |reference|)."""
    assert not hasattr(tpr, "_NOT_PORTED")
    tspec = ConeSpec.from_dict(cone)
    z = _input(tspec.dim, 11) * 2
    out_t = tpr.make_cone_projector(tspec)(torch.as_tensor(z)).numpy()
    out_j = np.asarray(jpr.make_cone_projector(JConeSpec.from_dict(cone))(jnp.asarray(z)))
    assert np.isfinite(out_t).all()
    np.testing.assert_array_less(np.abs(out_t - out_j), 1e-9 * (1 + np.abs(out_j)))


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("cone", CONES)
def test_projector_on_batch_equals_row_loop(cone, dual):
    """The batched path projects (B, m) slacks along the last axis: each
    row equals the (m,) projection of that row, and scs_tpu's vmap."""
    tspec = ConeSpec.from_dict(cone)
    make_t = tpr.make_dual_cone_projector if dual else tpr.make_cone_projector
    make_j = jpr.make_dual_cone_projector if dual else jpr.make_cone_projector
    proj = make_t(tspec, torch.float64)
    Z = np.stack([_input(tspec.dim, s) for s in range(4)])
    out = proj(torch.as_tensor(Z)).numpy()
    assert out.shape == Z.shape
    rows = np.stack([proj(torch.as_tensor(z)).numpy() for z in Z])
    np.testing.assert_array_equal(out, rows)
    vj = jax.vmap(make_j(JConeSpec.from_dict(cone), jnp.float64))
    np.testing.assert_array_equal(out, np.asarray(vj(jnp.asarray(Z))))
