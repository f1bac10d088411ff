"""ops/df32.py: scs_tpu_torch's compensated float32 products against
scs_tpu's and against the float64 product, from the same numpy inputs.

The plain versions (the CPU path) are scs_tpu's formulas as eager PyTorch
operations: Dekker's error-free product, the p- and err-streams summed
apart. Both packages must be within 5e-7 of the f64 product, the bound of
tests/test_hi_accuracy.py::test_df32_matvec_accuracy, and within 1e-6 of
each other (two summation orders, each within the bound). Kernel D1, the
CUDA form, is checked on the card against the same bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scs_tpu.ops import df32 as jdf
from scs_tpu_torch.ops import df32

REL = 5e-7  # against the f64 product (tests/test_hi_accuracy.py)
PARITY = 1e-6  # port against scs_tpu: two summation orders within REL


def _rel(out, ref, axis=-1):
    """Largest relative error in norm along `axis` (per problem)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    num = np.linalg.norm(out - ref, axis=axis)
    return float(np.max(num / np.linalg.norm(ref, axis=axis)))


def _pairs(rng, n):
    """float32 operands over many binades, the split's whole range."""
    a = (rng.randn(n) * 2.0 ** rng.randint(-40, 40, n)).astype(np.float32)
    b = (rng.randn(n) * 2.0 ** rng.randint(-40, 40, n)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("package", ["scs_tpu", "scs_tpu_torch"])
def test_two_prod_is_error_free(package):
    """p + err == a*b exactly (in f64, where both sides are exact) and p is
    the rounded product, in both packages, for operands of every size."""
    a, b = _pairs(np.random.RandomState(0), 100_000)
    if package == "scs_tpu":
        p, err = (np.asarray(t) for t in jdf._two_prod(jnp.asarray(a), jnp.asarray(b)))
    else:
        p, err = (t.numpy() for t in df32._two_prod(torch.as_tensor(a), torch.as_tensor(b)))
    assert p.dtype == err.dtype == np.float32
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p, (a * b).astype(np.float32))
    np.testing.assert_array_equal(p.astype(np.float64) + err.astype(np.float64), exact)


def test_split_halves():
    """_split gives the same halves as scs_tpu's, each of at most 12 bits."""
    a = np.random.RandomState(1).randn(1000).astype(np.float32)
    hi_t, lo_t = (t.numpy() for t in df32._split(torch.as_tensor(a)))
    hi_j, lo_j = (np.asarray(t) for t in jdf._split(jnp.asarray(a)))
    np.testing.assert_array_equal(hi_t, hi_j)
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(hi_t.astype(np.float64) + lo_t, a.astype(np.float64))
    assert df32._SPLIT == jdf._SPLIT == 4097.0


@pytest.mark.parametrize("shape", [(300, 400), (61, 1771), (3, 150, 100), (4, 77, 53)])
def test_mv_tv_accuracy_and_parity(shape):
    """mv and tv on (r, c) and (B, r, c): within REL of the f64 product per
    problem and within PARITY of scs_tpu's df32 (vmapped over the batch)."""
    rng = np.random.RandomState(2)
    M = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape[:-2], shape[-1]).astype(np.float32)
    u = rng.randn(*shape[:-2], shape[-2]).astype(np.float32)
    M64 = M.astype(np.float64)
    ref_mv = np.einsum("...rc,...c->...r", M64, v.astype(np.float64))
    ref_tv = np.einsum("...rc,...r->...c", M64, u.astype(np.float64))
    out_mv = df32.mv(torch.as_tensor(M), torch.as_tensor(v)).numpy()
    out_tv = df32.tv(torch.as_tensor(M), torch.as_tensor(u)).numpy()
    assert out_mv.dtype == out_tv.dtype == np.float32
    assert out_mv.shape == ref_mv.shape and out_tv.shape == ref_tv.shape
    assert _rel(out_mv, ref_mv) < REL and _rel(out_tv, ref_tv) < REL
    j_mv, j_tv = jdf.mv, jdf.tv
    if len(shape) == 3:
        import jax

        j_mv, j_tv = jax.vmap(jdf.mv), jax.vmap(jdf.tv)
    assert _rel(out_mv, j_mv(jnp.asarray(M), jnp.asarray(v))) < PARITY
    assert _rel(out_tv, j_tv(jnp.asarray(M), jnp.asarray(u))) < PARITY


@pytest.mark.parametrize("shape", [(1000,), (6, 1500)])
def test_dot_accuracy_and_parity(shape):
    """dot on (k,) and (B, k) against the f64 dot and scs_tpu's; positive
    operands, so the relative error is the summation's and not a
    cancellation's condition number."""
    rng = np.random.RandomState(3)
    a = np.abs(rng.randn(*shape)).astype(np.float32)
    b = np.abs(rng.randn(*shape)).astype(np.float32)
    ref = (a.astype(np.float64) * b).sum(-1)
    out = df32.dot(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert out.shape == ref.shape
    assert np.all(np.abs(out - ref) <= REL * np.abs(ref))
    jref = np.array([np.asarray(jdf.dot(jnp.asarray(x), jnp.asarray(y)))
                     for x, y in zip(a.reshape(-1, shape[-1]), b.reshape(-1, shape[-1]))])
    assert np.all(np.abs(out.reshape(-1) - jref) <= PARITY * np.abs(jref))


def test_cancelling_rows_defeat_a_plain_sum():
    """The premise of the card test's cancelling case (half of each row the
    negated other half, times a vector 2^-10 apart): a plain f32 product
    misses the f64 one by far more than REL there, so a kernel whose
    p-stream additions were contracted into the products, or summed without
    compensation, cannot pass it (gemv_proto._cancelling builds the same
    rows on the card)."""
    from scs_tpu_torch.tools import gemv_proto

    rng = np.random.RandomState(4)
    M = torch.as_tensor(rng.randn(3, 40, 1000).astype(np.float32))
    v = torch.as_tensor(rng.randn(3, 1000).astype(np.float32))
    gemv_proto._cancelling(M, v, 2)
    ref = np.einsum("brc,bc->br", M.double().numpy(), v.double().numpy())
    plain = torch.einsum("brc,bc->br", M, v).numpy()
    assert _rel(plain, ref) > 100 * REL


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    M, v = torch.ones(2, 3, 4), torch.ones(2, 4)
    before = (df32.mv.launches, df32.tv.launches)
    df32.mv(M, v), df32.tv(M, torch.ones(2, 3)), df32.dot(v, v)
    assert (df32.mv.launches, df32.tv.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        df32.mv(M.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        df32.tv(M.to("meta"), torch.ones(2, 3, device="meta"))


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kernels,offset,cancel", [
    ((4, 150, 100), ("rows", "cols"), 0, False),
    ((32, 1, 1000), ("rows",), 0, False),  # a batch of dots
    ((5, 1501, 1771), ("rows", "cols"), 0, False),  # ragged
    ((7, 185, 61), ("rows", "cols"), 0, False),  # rows of <= 16 groups
    ((3, 20, 4099), ("rows", "cols"), 0, False),  # x too long to stage
    ((2, 300, 200), ("rows", "cols"), 1, False),  # M one element in
    ((4, 300, 1000), ("rows", "cols"), 0, True),  # cancelling products
])
def test_d1_on_card(cuda_device, shape, kernels, offset, cancel):
    """D1 against the f64 product (5e-7 per problem) and its plain version,
    a bit-equal repeat, one launch per call, a misaligned M giving its
    aligned copy's bits (gemv_proto.check_comp raises on any miss)."""
    from scs_tpu_torch.tools import gemv_proto

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    rec = gemv_proto.check_comp(shape, kernels, gen, timed=False, offset=offset, cancel=cancel)
    assert all(r["rel_err"] < REL for r in rec.values())


@pytest.mark.cuda
def test_d1_wrappers_raise_on_card(cuda_device):
    M = torch.zeros((2, 4, 3), device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        df32.mv(M, torch.zeros((2, 3), device=cuda_device, dtype=torch.float64))
    M = torch.zeros((2, 4, 3), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        df32.tv(M.transpose(1, 2), torch.zeros((2, 3), device=cuda_device))
