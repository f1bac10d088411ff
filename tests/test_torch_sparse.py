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


# ragged in both orientations (m and n no multiples of bs), mixed widths
BATCH_CASES_UNPADDED = [
    (100, 70, 8, (0.01, 0.05, 0.2)),
    (300, 200, 16, (0.002, 0.05, 0.01, 0.1)),
    (77, 130, 32, (0.02, 0.3)),
]


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


def _orientation_pack(which, m, n, bs, density, np_dtype):
    """(blocks, cols, true x length) of A, of A^T, or of the symmetric
    P = A^T A, packed on the host."""
    A = _rand_csc(m, n, density, m + n)
    if which == "P":
        blocks, cols, _ = tsp.pack_bell_sym_host(sparse.csc_matrix(A.T @ A), bs, np_dtype)
        return blocks, cols, n
    pk = tsp.pack_bell_host(A, bs, np_dtype)
    return (pk[0], pk[1], n) if which == "A" else (pk[2], pk[3], m)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("which", ["A", "At", "P"])
@pytest.mark.parametrize("m,n,bs,density", CASES)
def test_bell_spmv_unpadded_x_equals_plain_on_padded(m, n, bs, density, which, np_dtype):
    """bell_spmv takes x at its true length (no multiple of bs) and gives
    exactly what the plain version gives on the zero-padded x."""
    blocks, cols, x_len = _orientation_pack(which, m, n, bs, density, np_dtype)
    x = np.random.RandomState(8).randn(x_len).astype(np_dtype)
    x_pad = np.zeros(-(-x_len // bs) * bs, np_dtype)
    x_pad[:x_len] = x
    bt, ct = torch.as_tensor(blocks), torch.as_tensor(cols)
    y = tsp.bell_spmv(bt, ct, torch.as_tensor(x))
    y_pad = tsp.bell_spmv_ref(bt, ct, torch.as_tensor(x_pad))
    assert torch.equal(y, y_pad)
    # a view into a longer vector (unit stride, no copy) and a padded x
    # serve alike
    longer = torch.as_tensor(np.concatenate([[7.0], x, [9.0]]).astype(np_dtype))
    assert torch.equal(tsp.bell_spmv(bt, ct, longer[1:-1]), y_pad)
    assert torch.equal(tsp.bell_spmv(bt, ct, torch.as_tensor(x_pad)), y_pad)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("m,n,bs,densities", BATCH_CASES_UNPADDED)
def test_bell_spmv_batched_unpadded_x_equals_plain_on_padded(m, n, bs, densities, np_dtype, transpose):
    """The batched wrapper on x of the true length (also as a column slice
    of a wider tensor, rows strided) equals the plain version on the padded
    x; B > 1 with mixed widths."""
    blocks, cols, x_pad = _batched_pack(m, n, bs, densities, np_dtype, transpose)
    x_len = m if transpose else n
    assert x_len % bs != 0 and x_pad.shape[1] > x_len
    x_pad[:, x_len:] = 0
    bt, ct = torch.as_tensor(blocks), torch.as_tensor(cols)
    y_pad = tsp.bell_spmv_batched_ref(bt, ct, torch.as_tensor(x_pad))
    x = torch.as_tensor(x_pad[:, :x_len].copy())
    assert torch.equal(tsp.bell_spmv_batched(bt, ct, x), y_pad)
    wide = torch.as_tensor(np.concatenate([x_pad[:, :x_len], np.ones((len(densities), 5), np_dtype)], axis=1))
    view = wide[:, :x_len]
    assert not view.is_contiguous()
    assert torch.equal(tsp.bell_spmv_batched(bt, ct, view), y_pad)


@pytest.mark.parametrize("m,n,bs", [(100, 70, 8), (300, 200, 16), (130, 45, 32)])
def test_bell_matrix_mv_rmv_match_scs_tpu(m, n, bs):
    """BellMatrix.mv/.rmv on vectors of the true lengths against scs_tpu's
    BellMatrix (plain path), f64."""
    A = _rand_csc(m, n, 0.05, m + n)
    bt = tsp.pack_bell(A, block_size=bs, dtype=torch.float64)
    bj = jsp.pack_bell(A, block_size=bs, dtype=jnp.float64)  # x64 is on (conftest)
    x = np.random.RandomState(1).randn(n)
    y = np.random.RandomState(2).randn(m)
    mv_j = np.asarray(bj.mv(jnp.asarray(x), use_pallas=False))
    rmv_j = np.asarray(bj.rmv(jnp.asarray(y), use_pallas=False))
    mv_t, rmv_t = bt.mv(torch.as_tensor(x)), bt.rmv(torch.as_tensor(y))
    assert mv_t.shape == (m,) and rmv_t.shape == (n,)
    np.testing.assert_allclose(mv_t.numpy(), mv_j, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(rmv_t.numpy(), rmv_j, rtol=1e-10, atol=1e-12)


def test_bell_spmv_rejects_bad_shapes():
    blocks = torch.zeros((2, 1, 8, 8))
    cols = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="1-D"):
        tsp.bell_spmv(blocks, cols, torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="cols shape"):
        tsp.bell_spmv(blocks, cols[:1], torch.zeros(8))
    with pytest.raises(ValueError, match=r"x must be \(B=2"):
        tsp.bell_spmv_batched(blocks[None].expand(2, -1, -1, -1, -1), cols[None].expand(2, -1, -1),
                              torch.zeros((3, 8)))


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


# The kernel's shapes on the card: (label, nbr, nbc, width, bs). Narrow and
# wide (w ~ nbc) packs; block sizes where an f32 lane takes two elements (a
# multiple of 64) and one (the others), with ragged last chunks (bs 3, 100);
# one block-row, one slot, packs far smaller than the grid, whose slots are
# dealt to a thread block cluster.
KERNEL_SHAPES = [
    ("narrow", 40, 60, 5, 128),
    ("wide", 12, 47, 47, 32),
    ("bs3", 9, 7, 3, 3),
    ("bs16", 33, 20, 6, 16),
    ("bs32", 70, 31, 4, 32),
    ("bs100", 11, 9, 4, 100),
    ("bs128-wide-row", 3, 40, 37, 128),
    ("one-block-row", 1, 30, 19, 128),
    ("one-slot", 25, 25, 1, 64),
    ("tiny", 2, 2, 1, 16),
]


def _random_pack(nbr, nbc, width, bs, np_dtype, seed, batch=None):
    """A random pack in the packer's layout: distinct block columns per
    block-row, the last slot of every other block-row a padding slot (zero
    tile at block-column 0)."""
    rng = np.random.RandomState(seed)
    lead = () if batch is None else (batch,)
    blocks = rng.randn(*lead, nbr, width, bs, bs).astype(np_dtype)
    cols = np.stack([
        rng.permutation(nbc)[:width] for _ in range(int(np.prod(lead, dtype=int)) * nbr)
    ]).reshape(*lead, nbr, width).astype(np.int32)
    if width > 1:
        blocks[..., ::2, -1, :, :] = 0
        cols[..., ::2, -1] = 0
    return blocks, cols


def _assert_kernel_close(y_k, y_p, bound):
    err = (y_k - y_p).abs()
    assert bool(torch.all(err <= bound)), float((err - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
@pytest.mark.parametrize("label,nbr,nbc,width,bs", KERNEL_SHAPES)
def test_bell_spmv_kernel_shapes_on_card(cuda_device, label, nbr, nbc, width, bs, dtype, tol):
    """The kernel against its plain version, |err| <= tol*|A||x| elementwise,
    on a padded and on an unpadded x (a third of the last tile missing); a
    repeated launch is bit-equal."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    blocks_np, cols_np = _random_pack(nbr, nbc, width, bs, np_dtype, nbr + bs)
    blocks = torch.as_tensor(blocks_np, device=cuda_device)
    cols = torch.as_tensor(cols_np, device=cuda_device)
    x_pad = torch.as_tensor(np.random.RandomState(3).randn(nbc * bs).astype(np_dtype), device=cuda_device)
    x_len = nbc * bs - bs // 3
    x_cut = x_pad.clone()
    x_cut[x_len:] = 0
    for x, x_ref in ((x_pad, x_pad), (x_cut[:x_len], x_cut), (x_pad[: bs], None)):
        if x_ref is None:  # x far shorter than the columns in use
            x_ref = torch.zeros_like(x_pad)
            x_ref[:bs] = x
        y_k = tsp.bell_spmv(blocks, cols, x)
        y_again = tsp.bell_spmv(blocks, cols, x)
        torch.cuda.synchronize()
        y_p = tsp.bell_spmv_ref(blocks, cols, x_ref)
        _assert_kernel_close(y_k, y_p, tol * tsp.bell_spmv_ref(blocks.abs(), cols, x_ref.abs()))
        assert torch.equal(y_k, y_again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
@pytest.mark.parametrize("label,nbr,nbc,width,bs", KERNEL_SHAPES)
def test_bell_spmv_batched_kernel_shapes_on_card(cuda_device, label, nbr, nbc, width, bs, dtype, tol):
    """The batched entry point on the same shapes with B = 3: unpadded x as
    a column slice of a wider tensor (strided rows), repeat bit-equal, and
    every problem within the tolerance of its own single launch (equal bit
    for bit only at B = 1: the thread blocks' shares of a batch fall
    elsewhere than those of one problem)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    B = 3
    blocks_np, cols_np = _random_pack(nbr, nbc, width, bs, np_dtype, nbr + bs + 1, batch=B)
    blocks = torch.as_tensor(blocks_np, device=cuda_device)
    cols = torch.as_tensor(cols_np, device=cuda_device)
    x_len = nbc * bs - bs // 3
    wide = torch.as_tensor(np.random.RandomState(4).randn(B, nbc * bs + 3).astype(np_dtype), device=cuda_device)
    x = wide[:, :x_len]
    x_ref = torch.zeros((B, nbc * bs), dtype=dtype, device=cuda_device)
    x_ref[:, :x_len] = x
    y_k = tsp.bell_spmv_batched(blocks, cols, x)
    y_again = tsp.bell_spmv_batched(blocks, cols, x)
    torch.cuda.synchronize()
    y_p = tsp.bell_spmv_batched_ref(blocks, cols, x_ref)
    assert torch.equal(y_k, y_again)
    limit = tol * tsp.bell_spmv_batched_ref(blocks.abs(), cols, x_ref.abs())
    _assert_kernel_close(y_k, y_p, limit)
    for b in range(B):
        _assert_kernel_close(tsp.bell_spmv(blocks[b], cols[b], x[b]), y_k[b], limit[b])


@pytest.mark.cuda
def test_bell_spmv_kernel_unaligned_pack_on_card(cuda_device):
    """A pack whose storage starts off an 8-byte boundary takes one
    element a lane and agrees."""
    blocks_np, cols_np = _random_pack(6, 5, 3, 64, np.float32, 1)
    flat = torch.zeros(blocks_np.size + 1, dtype=torch.float32, device=cuda_device)
    flat[1:] = torch.as_tensor(blocks_np.ravel())
    blocks = flat[1:].view(blocks_np.shape)
    assert blocks.data_ptr() % 8 != 0 and blocks.is_contiguous()
    cols = torch.as_tensor(cols_np, device=cuda_device)
    x = torch.as_tensor(np.random.RandomState(2).randn(5 * 64).astype(np.float32), device=cuda_device)
    y_k = tsp.bell_spmv(blocks, cols, x)
    torch.cuda.synchronize()
    y_p = tsp.bell_spmv_ref(blocks, cols, x)
    _assert_kernel_close(y_k, y_p, 1e-5 * tsp.bell_spmv_ref(blocks.abs(), cols, x.abs()))


@pytest.mark.cuda
def test_bell_spmv_kernel_refusals_raise_on_card(cuda_device):
    """What the kernel does not take raises; nothing falls back."""
    blocks = torch.zeros((2, 1, 8, 8), device=cuda_device)
    cols = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    x = torch.zeros(16, device=cuda_device)
    before = tsp.bell_spmv.launches
    with pytest.raises(TypeError, match="cols must be int32"):
        tsp.bell_spmv(blocks, cols.long(), x)
    with pytest.raises(TypeError, match="x dtype"):
        tsp.bell_spmv(blocks, cols, x.double())
    with pytest.raises(TypeError, match="float32 or float64"):
        tsp.bell_spmv(blocks.half(), cols, x.half())
    with pytest.raises(ValueError, match="unit stride"):
        tsp.bell_spmv(blocks, cols, torch.zeros(32, device=cuda_device)[::2])
    with pytest.raises(ValueError, match="contiguous"):
        tsp.bell_spmv(blocks.transpose(2, 3), cols, x)
    with pytest.raises(ValueError, match="on cpu"):
        tsp.bell_spmv(blocks, cols, x.cpu())
    with pytest.raises(ValueError, match=r"outside \[1, 1024\]"):
        tsp.bell_spmv(torch.zeros((1, 1, 1025, 1025), device=cuda_device), cols[:1], x)
    with pytest.raises(ValueError, match="at least one slot"):
        tsp.bell_spmv(torch.zeros((2, 0, 8, 8), device=cuda_device), cols[:, :0], x)
    assert tsp.bell_spmv.launches == before
