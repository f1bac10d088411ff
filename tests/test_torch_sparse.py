"""Block-ELL packing and SpMV: scs_tpu_torch against scs_tpu.

The same numpy-seeded matrices and vectors go through both packages. On
the CPU the port's bell_spmv and bell_spmv_batched are their plain PyTorch
versions; the CUDA kernel (scs_tpu_torch/ops/csrc/bell_spmv.cu, single and
batched entry points) is checked against those plain versions on the card
by the `cuda`-marked tests below and by chip_smoke.py.
"""

import os

import numpy as np
import pytest
import torch
from scipy import sparse

import jax
import jax.numpy as jnp

from scs_tpu.ops import sparse as jsp
from scs_tpu_torch.ops import sparse as tsp

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (m, n, bs, density): the shapes of tests/test_sparse_ops.py, plus one
# wide pack where every tile is touched (width == nbc, the regime of
# scs_tpu's grid-over-slots kernel _bell_kernel)
CASES = [
    (100, 70, 8, 0.05),
    (300, 200, 16, 0.05),
    (64, 64, 32, 0.05),
    (96, 200, 8, 0.5),
]


def _rand_csc(m, n, density, seed):
    rng = np.random.RandomState(seed)
    A = sparse.random(m, n, density=density, random_state=rng, format="csc")
    A.sort_indices()
    return A


def _packs(m, n, bs, density, np_dtype):
    A = _rand_csc(m, n, density, m + n)
    return A, jsp.pack_bell_host(A, bs, np_dtype), tsp.pack_bell_host(A, bs, np_dtype)


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m,n,bs,density", CASES)
def test_pack_bell_host_identical(m, n, bs, density, np_dtype):
    _, pj, pt = _packs(m, n, bs, density, np_dtype)
    for a, b in zip(pj, pt):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,n,bs,density", CASES)
def test_pack_bell_sym_host_identical(m, n, bs, density):
    A = _rand_csc(m, n, density, m + n)
    P = sparse.csc_matrix(A.T @ A)  # symmetric (n, n)
    for a, b in zip(jsp.pack_bell_sym_host(P, bs, np.float64),
                    tsp.pack_bell_sym_host(P, bs, np.float64)):
        np.testing.assert_array_equal(a, b)


def _x_for(blocks, cols, dtype, seed):
    bs = blocks.shape[-1]
    n_pad = (int(np.max(cols)) + 1) * bs
    return np.random.RandomState(seed).randn(n_pad).astype(dtype)


# rtol per dtype: the two plain versions contract in different orders
RTOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m,n,bs,density", CASES)
def test_bell_spmv_ref_matches_scs_tpu(m, n, bs, density, np_dtype):
    _, pj, _ = _packs(m, n, bs, density, np_dtype)
    for blocks, cols in ((pj[0], pj[1]), (pj[2], pj[3])):  # A and A^T
        x = _x_for(blocks, cols, np_dtype, 3)
        y_j = np.asarray(jsp.bell_spmv_ref(jnp.asarray(blocks), jnp.asarray(cols), jnp.asarray(x)))
        y_t = tsp.bell_spmv_ref(torch.as_tensor(blocks), torch.as_tensor(cols), torch.as_tensor(x)).numpy()
        # atol at the rounding scale of |A||x| (entries can cancel to ~0)
        scale = np.abs(blocks).sum(axis=(1, 2)).max() * np.abs(x).max()
        np.testing.assert_allclose(y_t, y_j, rtol=RTOL[np_dtype],
                                   atol=RTOL[np_dtype] * scale)


@pytest.mark.parametrize("m,n,bs,density", CASES)
def test_bell_spmv_matches_pallas_interpret(m, n, bs, density):
    """The port's bell_spmv against scs_tpu's Pallas kernel run through the
    Pallas interpreter, f32, as tests/test_sparse_ops.py runs it."""
    _, pj, _ = _packs(m, n, bs, density, np.float32)
    blocks, cols = pj[0], pj[1]
    x = _x_for(blocks, cols, np.float32, 4)
    y_j = np.asarray(jsp.bell_spmv(jnp.asarray(blocks), jnp.asarray(cols), jnp.asarray(x), interpret=True))
    before = tsp.bell_spmv.launches
    y_t = tsp.bell_spmv(torch.as_tensor(blocks), torch.as_tensor(cols), torch.as_tensor(x))
    assert tsp.bell_spmv.launches == before  # CPU tensors: no kernel launch
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m,n,bs", [(100, 70, 8), (300, 200, 16)])
def test_pack_bell_mv_rmv(m, n, bs):
    A = _rand_csc(m, n, 0.05, m + n)
    bm = tsp.pack_bell(A, block_size=bs, dtype=torch.float64)
    x = np.random.RandomState(1).randn(n)
    y = np.random.RandomState(2).randn(m)
    np.testing.assert_allclose(bm.mv(torch.as_tensor(x)).numpy(), A @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(bm.rmv(torch.as_tensor(y)).numpy(), A.T @ y, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        bm.col_sq.numpy(), np.asarray(A.multiply(A).sum(axis=0)).ravel(), rtol=1e-12)
    assert bm.A_cols.dtype == torch.int32 and bm.At_cols.dtype == torch.int32


def test_pack_rejects_out_of_range_block_columns():
    with pytest.raises(ValueError, match="block-column ids"):
        tsp._cols_tensor(np.array([[0, 3]]), 3, "cpu")


def test_csc_ops_cpp_byte_identical():
    with open(os.path.join(ROOT, "scs_tpu", "native", "csc_ops.cpp"), "rb") as a, \
         open(os.path.join(ROOT, "scs_tpu_torch", "native", "csc_ops.cpp"), "rb") as b:
        assert a.read() == b.read()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
@pytest.mark.parametrize("m,n,bs,density", CASES)
def test_bell_spmv_kernel_matches_plain_on_card(cuda_device, m, n, bs, density, dtype, tol):
    A = _rand_csc(m, n, density, m + n)
    bm = tsp.pack_bell(A, bs, dtype, cuda_device)
    x = torch.as_tensor(np.random.RandomState(5).randn(bm.n_pad), dtype=dtype, device=cuda_device)
    before = tsp.bell_spmv.launches
    y_k = tsp.bell_spmv(bm.A_blocks, bm.A_cols, x)
    torch.cuda.synchronize()
    assert tsp.bell_spmv.launches == before + 1
    y_p = tsp.bell_spmv_ref(bm.A_blocks, bm.A_cols, x)
    bound = tol * tsp.bell_spmv_ref(bm.A_blocks.abs(), bm.A_cols, x.abs())
    assert bool(torch.all((y_k - y_p).abs() <= bound))


# Batched packs (B, nbr, w, bs, bs): B problems of one (m, n) with their own
# patterns, stacked at the largest width (zero tiles at block-column 0).
# (m, n, bs, densities): ragged edges, a wide pack (w == nbc) and mixed
# widths.
BATCH_CASES = [
    (100, 70, 8, (0.01, 0.05, 0.2)),
    (96, 200, 8, (0.5, 0.5)),
    (300, 200, 16, (0.002, 0.05, 0.01, 0.1)),
]


def _batched_pack(m, n, bs, densities, np_dtype, transpose=False):
    packs = [
        tsp.pack_bell_host(_rand_csc(m, n, d, m + n + k), bs, np_dtype)
        for k, d in enumerate(densities)
    ]
    i = 2 if transpose else 0
    blocks, cols = tsp.stack_bell_host([p[i] for p in packs], [p[i + 1] for p in packs])
    nbc = packs[0][3 - i].shape[0]  # block-rows of the other orientation
    x = np.random.RandomState(len(densities)).randn(len(densities), nbc * bs)
    return blocks, cols, x.astype(np_dtype)


def test_stack_bell_host_pads_with_zero_tiles():
    blocks, cols, _ = _batched_pack(300, 200, 16, (0.002, 0.1), np.float64)
    w0 = tsp.pack_bell_host(_rand_csc(300, 200, 0.002, 500), 16, np.float64)[0].shape[1]
    assert blocks.shape[2] > w0  # the sparser problem was padded
    assert not blocks[0, :, w0:].any() and not cols[0, :, w0:].any()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m,n,bs,densities", BATCH_CASES)
def test_bell_spmv_batched_ref_matches_vmap_and_loop(m, n, bs, densities, np_dtype, transpose):
    """bell_spmv_batched_ref equals scs_tpu's bell_spmv_ref under jax.vmap
    and a per-problem loop of the port's bell_spmv_ref."""
    blocks, cols, x = _batched_pack(m, n, bs, densities, np_dtype, transpose)
    y_t = tsp.bell_spmv_batched_ref(
        torch.as_tensor(blocks), torch.as_tensor(cols), torch.as_tensor(x)
    ).numpy()
    y_j = np.asarray(jax.vmap(jsp.bell_spmv_ref)(jnp.asarray(blocks), jnp.asarray(cols), jnp.asarray(x)))
    y_loop = np.stack([
        tsp.bell_spmv_ref(torch.as_tensor(b), torch.as_tensor(c), torch.as_tensor(xx)).numpy()
        for b, c, xx in zip(blocks, cols, x)
    ])
    assert y_t.shape == (len(densities), blocks.shape[1] * bs)
    scale = np.abs(blocks).sum(axis=(2, 3)).max() * np.abs(x).max()
    for other in (y_j, y_loop):
        np.testing.assert_allclose(y_t, other, rtol=RTOL[np_dtype], atol=RTOL[np_dtype] * scale)


@pytest.mark.parametrize("m,n,bs,densities", BATCH_CASES)
def test_bell_spmv_batched_matches_pallas_interpret_vmap(m, n, bs, densities):
    """The port's batched wrapper (plain version on CPU tensors) against
    scs_tpu's Pallas kernel under jax.vmap through the interpreter, f32:
    the batched bell path's operator in both packages."""
    blocks, cols, x = _batched_pack(m, n, bs, densities, np.float32)
    vk = jax.vmap(lambda b, c, xx: jsp.bell_spmv(b, c, xx, interpret=True))
    y_j = np.asarray(vk(jnp.asarray(blocks), jnp.asarray(cols), jnp.asarray(x)))
    before = tsp.bell_spmv_batched.launches
    y_t = tsp.bell_spmv_batched(torch.as_tensor(blocks), torch.as_tensor(cols), torch.as_tensor(x))
    assert tsp.bell_spmv_batched.launches == before  # CPU tensors: no kernel launch
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=1e-5, atol=1e-5)


def test_bell_spmv_batched_rejects_other_devices():
    blocks = torch.zeros((1, 1, 1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsp.bell_spmv_batched(blocks, torch.zeros((1, 1, 1), dtype=torch.int32), torch.zeros((1, 8)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
@pytest.mark.parametrize("m,n,bs,densities", BATCH_CASES)
def test_bell_spmv_batched_kernel_matches_plain_on_card(cuda_device, m, n, bs, densities, dtype, tol):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    blocks, cols, x = (
        torch.as_tensor(a, device=cuda_device)
        for a in _batched_pack(m, n, bs, densities, np_dtype)
    )
    before = tsp.bell_spmv_batched.launches
    y_k = tsp.bell_spmv_batched(blocks, cols, x)
    torch.cuda.synchronize()
    assert tsp.bell_spmv_batched.launches == before + 1
    y_p = tsp.bell_spmv_batched_ref(blocks, cols, x)
    bound = tol * tsp.bell_spmv_batched_ref(blocks.abs(), cols, x.abs())
    assert bool(torch.all((y_k - y_p).abs() <= bound))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,bs,density", CASES)
def test_bell_spmv_batched_b1_equals_single_kernel_on_card(cuda_device, m, n, bs, density, dtype):
    """A B = 1 launch of the batched entry point gives bell_spmv's output
    bit for bit (the same arithmetic, offset by problem 0)."""
    bm = tsp.pack_bell(_rand_csc(m, n, density, m + n), bs, dtype, cuda_device)
    x = torch.as_tensor(np.random.RandomState(6).randn(bm.n_pad), dtype=dtype, device=cuda_device)
    y1 = tsp.bell_spmv(bm.A_blocks, bm.A_cols, x)
    yb = tsp.bell_spmv_batched(bm.A_blocks[None], bm.A_cols[None], x[None])
    assert yb.shape == (1, y1.shape[0])
    assert torch.equal(yb[0], y1)
