"""The dense matvecs and the dense batch's setup pieces of scs_tpu_torch
against scs_tpu, on the CPU.

  * ops/dense.py: the plain versions `gemv_rows_ref`/`gemv_cols_ref` (what
    the wrappers run on a CPU tensor) against scs_tpu's `Core._mv`/`_tv`,
    against an f64 einsum, and against the two Pallas kernel bodies of
    tools/gemv_proto.py. That module runs a TPU launch when imported, so its
    two ten-line bodies and their pallas_calls are restated here and run in
    interpret mode (as tests/test_sparse_ops.py runs the block-ELL kernel).
    Tolerance: two sums of n products in different orders each lie within
    n*eps*|M||v| of the exact value, so they differ by at most 2n*eps*|M||v|.
  * normalize.ruiz_equilibrate_batched against jax.vmap of
    ruiz_equilibrate_jnp: the same operations in the same order, rtol 1e-12.
  * batch.batch_memory_bytes / recommend_chunks against scs_tpu's.
  * tools/flagship.py: the planted optimum of the generated batch.
  * `cuda`-marked: each CUDA kernel against its plain version on the card
    (skipped where there is no card).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import scs_tpu.batch as jb
import scs_tpu_torch as st
from scs_tpu.cones import ConeSpec as JConeSpec
from scs_tpu.normalize import row_block_ids, ruiz_equilibrate_jnp
from scs_tpu.solver import Core as JCore
from scs_tpu_torch import batch as tb
from scs_tpu_torch.cones import ConeSpec
from scs_tpu_torch.normalize import ruiz_equilibrate_batched
from scs_tpu_torch.ops import dense
from scs_tpu_torch.tools.flagship import gen_qp_batch, kkt_check_batch

torch.set_num_threads(1)

EPS = {np.float32: 1.2e-7, np.float64: 2.3e-16}
# widths of every residue mod 4 (the f32 vector width) and odd f64 widths:
# 61, 177 and 1771 are the mixed-cone batches' n, 30 is = 2 (mod 4)
SHAPES = [(1, 7, 5), (3, 33, 65), (4, 130, 77), (2, 64, 128), (2, 37, 61), (1, 9, 1771),
          (3, 50, 177), (2, 20, 30)]


def _mats(shape, np_dtype, seed=0):
    rng = np.random.RandomState(seed)
    B, r, c = shape
    M = (rng.randn(B, r, c) / np.sqrt(c)).astype(np_dtype)
    return M, rng.randn(B, c).astype(np_dtype), rng.randn(B, r).astype(np_dtype)


def _within(y, exact, absprod, n_terms, np_dtype):
    """|y - exact| <= 2 n eps |M||v|: the worst case of any summation order
    of n products rounded in the working precision."""
    bound = 2 * n_terms * EPS[np_dtype] * absprod + 1e-300
    assert np.all(np.abs(np.asarray(y, np.float64) - exact) <= bound)


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_einsum_and_scs_tpu(shape, np_dtype):
    M, v, u = _mats(shape, np_dtype)
    M64, v64, u64 = (a.astype(np.float64) for a in (M, v, u))
    Mt, vt, ut = (torch.as_tensor(a) for a in (M, v, u))
    c, r = shape[2], shape[1]

    rows = dense.gemv_rows(Mt, vt)  # a CPU tensor takes the plain version
    assert rows.dtype == Mt.dtype and tuple(rows.shape) == shape[:2]
    assert torch.equal(rows, dense.gemv_rows_ref(Mt, vt))
    _within(rows.numpy(), np.einsum("brc,bc->br", M64, v64),
            np.einsum("brc,bc->br", np.abs(M64), np.abs(v64)), c, np_dtype)
    cols = dense.gemv_cols(Mt, ut)
    assert tuple(cols.shape) == (shape[0], c)
    assert torch.equal(cols, dense.gemv_cols_ref(Mt, ut))
    _within(cols.numpy(), np.einsum("brc,br->bc", M64, u64),
            np.einsum("brc,br->bc", np.abs(M64), np.abs(u64)), r, np_dtype)

    # scs_tpu's own forms, per problem: the same products, summed by XLA
    mv = jax.vmap(functools.partial(JCore._mv, None))(jnp.asarray(M), jnp.asarray(v))
    tv = jax.vmap(functools.partial(JCore._tv, None))(jnp.asarray(M), jnp.asarray(u))
    _within(rows.numpy(), np.asarray(mv, np.float64),
            np.einsum("brc,bc->br", np.abs(M64), np.abs(v64)), c, np_dtype)
    _within(cols.numpy(), np.asarray(tv, np.float64),
            np.einsum("brc,br->bc", np.abs(M64), np.abs(u64)), r, np_dtype)
    # a single (r, c) problem is the B = 1 case
    assert torch.equal(dense.gemv_rows(Mt[0], vt[0]), rows[0])
    assert torch.equal(dense.gemv_cols(Mt[0], ut[0]), cols[0])


# -- the Pallas bodies of tools/gemv_proto.py, restated ------------------------


def _pallas_gemv(A, x, bm):
    """tools/gemv_proto.py:13-42 (`_gemv_kernel` under `pallas_gemv`)."""

    def kernel(a_ref, x_ref, y_ref):
        i = pl.program_id(1)
        yb = jax.lax.dot_general(
            x_ref[0], a_ref[0], dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
        )
        y_ref[0, :, pl.dslice(i * bm, bm)] = yb

    B, m, n = A.shape
    y = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B, 1, m), jnp.float32),
        grid=(B, m // bm),
        in_specs=[
            pl.BlockSpec((1, bm, n), lambda b, i: (b, i, 0)),
            pl.BlockSpec((1, 1, n), lambda b, i: (b, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, m), lambda b, i: (b, 0, 0)),
        interpret=True,
    )(A, x.reshape(B, 1, n))
    return y.reshape(B, m)


def _pallas_vpu_gemv(At, x, bm):
    """tools/gemv_proto.py:100-123 (`_vpu_kernel` under `vpu_gemv`)."""

    def kernel(a_ref, x_ref, y_ref):
        i = pl.program_id(1)
        prod = a_ref[0] * x_ref[0]
        y_ref[0, :, pl.dslice(i * bm, bm)] = jnp.sum(prod, axis=0).reshape(1, bm)

    B, n, m = At.shape
    y = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B, 1, m), jnp.float32),
        grid=(B, m // bm),
        in_specs=[
            pl.BlockSpec((1, n, bm), lambda b, i: (b, 0, i)),
            pl.BlockSpec((1, n, 1), lambda b, i: (b, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, 1, m), lambda b, i: (b, 0, 0)),
        interpret=True,
    )(At, x.reshape(B, n, 1))
    return y.reshape(B, m)


@pytest.mark.parametrize("n", [128, 61, 177, 30])
def test_plain_versions_match_the_pallas_kernel_bodies(n):
    """G1 reads A (B, m, n) and reduces rows: gemv_rows. G2 reads the
    transposed layout At (B, n, m) and reduces over its leading axis:
    gemv_cols with M := At. f32; m a multiple of the block, n any width
    (the blocks take whole rows of A and whole columns of At)."""
    B, m, bm = 2, 32, 16
    A, x, _ = _mats((B, m, n), np.float32, seed=4)
    absprod = np.einsum("bmn,bn->bm", np.abs(A).astype(np.float64), np.abs(x).astype(np.float64))
    g1 = np.asarray(_pallas_gemv(jnp.asarray(A), jnp.asarray(x), bm), np.float64)
    _within(dense.gemv_rows_ref(torch.as_tensor(A), torch.as_tensor(x)).numpy(), g1, absprod, n, np.float32)
    At = np.ascontiguousarray(A.transpose(0, 2, 1))
    g2 = np.asarray(_pallas_vpu_gemv(jnp.asarray(At), jnp.asarray(x), bm), np.float64)
    _within(dense.gemv_cols_ref(torch.as_tensor(At), torch.as_tensor(x)).numpy(), g2, absprod, n, np.float32)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    M = torch.zeros((2, 4, 3))
    v = torch.zeros((2, 3))
    assert dense._prepare("gemv_rows", M, v, 2)[2] is False
    assert dense._prepare("gemv_rows", M[0], v[0], 2)[2] is True
    with pytest.raises(TypeError, match="float32 or float64"):
        dense._prepare("gemv_rows", M.half(), v.half(), 2)
    with pytest.raises(TypeError, match="dtype"):
        dense._prepare("gemv_rows", M, v.double(), 2)
    with pytest.raises(ValueError, match="does not match"):
        dense._prepare("gemv_cols", M, v, 1)  # (B, 3) against r = 4
    with pytest.raises(ValueError, match="contiguous"):
        dense._prepare("gemv_rows", M.transpose(1, 2), torch.zeros((2, 4)), 2)
    with pytest.raises(ValueError, match=r"\(r, c\) with a vector"):
        dense._prepare("gemv_rows", M, v[0], 2)
    with pytest.raises(ValueError, match="unsupported device"):
        dense.gemv_rows(M.to("meta"), v.to("meta"))
    # a strided vector (a slice of the iterate) is copied, not refused
    w = torch.zeros((2, 10))
    assert dense._prepare("gemv_rows", M, w[:, 2:5], 2)[1].is_contiguous()


def test_cols_cluster_depends_on_the_shape_only():
    """gemv_cols plans one launch whose rows are split over a cluster of
    1-8 blocks, from the shape and element size alone: 1 where the batch
    fills the card, more for one tall matrix, never more blocks than rows
    allow."""
    shapes = [(512, 1500, 1000), (1, 1500, 1000), (128, 5313, 1771), (64, 185, 61),
              (64, 61, 61), (1, 300, 200), (1, 40, 30), (1, 10**6, 8), (0, 5, 5), (3, 0, 7)]
    for B, r, c in shapes:
        for item in (4, 8):
            k = dense.cols_cluster(B, r, c, item)
            assert isinstance(k, int) and 1 <= k <= 8
            assert k == dense.cols_cluster(B, r, c, item)
            assert k == 1 or r // k >= dense._MIN_CLUSTER_ROWS
    assert dense.cols_cluster(512, 1500, 1000, 4) == 1  # the batch fills the card
    assert dense.cols_cluster(1, 1500, 1000, 4) > 1
    assert dense.cols_cluster(1, 40, 30, 8) == 1  # too few rows to split
    assert dense.cols_cluster(1, 10**6, 8, 4) == 8


# -- the on-device batched Ruiz equilibration ----------------------------------

RUIZ_CASES = {
    "l_with_P": ({"l": 14}, True),
    "z_l_no_P": ({"z": 4, "l": 10}, False),
    "soc_blocks_with_P": ({"z": 2, "l": 4, "q": [3, 5]}, True),
    "box_with_P": ({"l": 3, "bu": [1.0, 2.0, np.inf], "bl": [-1.0, -np.inf, 0.0], "q": [7]}, True),
}


@pytest.mark.parametrize("case", sorted(RUIZ_CASES))
def test_batched_ruiz_matches_vmapped_ruiz_equilibrate_jnp(case):
    cone, with_P = RUIZ_CASES[case]
    spec_j, spec_t = JConeSpec.from_dict(cone), ConeSpec.from_dict(cone)
    B, m, n = 5, spec_j.dim, 9
    rng = np.random.RandomState(7)
    A = rng.randn(B, m, n) * np.exp(rng.randn(B, m, 1))  # badly scaled rows
    A[:, 1, :] = 0.0  # an all-zero row keeps scale 1
    b, c = rng.randn(B, m), rng.randn(B, n)
    G = rng.randn(B, n, 3)
    P = G @ G.transpose(0, 2, 1) if with_P else None
    ids, nblocks = row_block_ids(spec_j)
    one = functools.partial(
        ruiz_equilibrate_jnp, ids=ids, nblocks=nblocks, box_off=spec_j.z + spec_j.l,
        bsize=spec_j.bsize, bl=spec_j.bl, bu=spec_j.bu,
    )
    if with_P:
        out_j = jax.vmap(one)(jnp.asarray(A), jnp.asarray(P), jnp.asarray(b), jnp.asarray(c))
    else:
        out_j = jax.vmap(lambda a, b1, c1: one(a, None, b1, c1))(
            jnp.asarray(A), jnp.asarray(b), jnp.asarray(c)
        )
    At = torch.tensor(A)
    Pt = torch.tensor(P) if with_P else None
    out_t = ruiz_equilibrate_batched(At, Pt, torch.tensor(b), torch.tensor(c), spec_t)
    assert out_t[0] is At and out_t[1] is Pt  # scaled in place
    names = ("A", "P", "b", "c", "D", "E", "sc_b", "sc_c", "bl", "bu")
    for name, a, ref in zip(names, out_t, out_j):
        if ref is None:
            assert a is None, name
            continue
        assert tuple(a.shape) == np.asarray(ref).shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=1e-12, err_msg=name)


# -- memory estimate -----------------------------------------------------------


@pytest.mark.parametrize("args", [(512, 1500, 1000, True), (64, 300, 200, False), (1000, 1500, 1000, True)])
def test_memory_estimate_matches_scs_tpu(args):
    assert tb.batch_memory_bytes(*args) == jb.batch_memory_bytes(*args)
    assert tb.batch_memory_bytes(*args, itemsize=8, lookback=0) == jb.batch_memory_bytes(
        *args, itemsize=8, lookback=0
    )
    for budget in (int(1e9), int(12e9), int(60e9)):
        assert tb.recommend_chunks(*args, budget=budget) == jb.recommend_chunks(*args, budget=budget)
    # the flagship needs one chunk in 3/4 of an 80 GB card
    assert tb.recommend_chunks(512, 1500, 1000, True, budget=int(0.75 * 80e9)) == 1


def test_recommend_chunks_reads_the_card_not_a_constant():
    if torch.cuda.is_available():
        assert tb.recommend_chunks(512, 1500, 1000, True) >= 1
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            tb.recommend_chunks(512, 1500, 1000, True)


# -- the flagship generator ----------------------------------------------------


def test_flagship_generator_plants_the_optimum():
    """gen_qp_batch's p* is the optimal objective: the solver, at eps 1e-7
    in f64, lands on it; the batched f64 KKT check passes on its results
    and refuses a perturbed one. The caller's A is left untouched."""
    data, p_star, obj_scale = gen_qp_batch(5, 40, 24, seed=3, device="cpu", dtype=torch.float64, sub=2)
    assert bool((obj_scale >= p_star.abs() / 2).all())
    assert data["A"].shape == (5, 40, 24) and data["P"].shape == (5, 24, 24)
    assert torch.equal(data["P"], data["P"].mT)
    A0 = data["A"].clone()
    res = st.solve_batch(data, {"l": 40}, eps_abs=1e-7, eps_rel=1e-7, device="cpu", max_iters=20000)
    assert torch.equal(data["A"], A0)
    assert [r["info"]["status"] for r in res] == ["solved"] * 5
    pobj = np.array([r["info"]["pobj"] for r in res])
    assert np.all(np.abs(pobj - p_star.numpy()) <= 1e-5 * obj_scale.numpy())
    worst = kkt_check_batch(data, res, 1e-7)
    assert max(worst) <= 5.0
    res[2]["x"] = res[2]["x"] + 1e-3
    with pytest.raises(AssertionError, match="problem 2"):
        kkt_check_batch(data, res, 1e-7)
    again, p_again, _ = gen_qp_batch(5, 40, 24, seed=3, device="cpu", dtype=torch.float64, sub=2)
    assert torch.equal(p_again, p_star) and torch.equal(again["A"], A0)  # seeded


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


# the main paths' shapes that fit a test (mixed_cone's A and S^-1, a cut of
# the wide batch's A, the single dense QP) and ragged ones: every row
# shift, rows of <= 8, <= 16 and more 16-byte groups, rows too long to stage
# x for (4099 columns), split and unsplit G2
CARD_SHAPES = [(512, 150, 100), (1, 1500, 1000), (3, 77, 53), (5, 33, 1027), (2, 4, 8),
               (1, 1501, 999), (64, 185, 61), (64, 61, 61), (2, 53, 1771), (1, 300, 200),
               (2, 5, 4099)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_gemv_kernels_match_plain_on_card(cuda_device, shape, dtype, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    B, r, c = shape
    M = torch.randn(shape, generator=gen, device=cuda_device, dtype=dtype)
    for kern, plain, vec in (
        (dense.gemv_rows, dense.gemv_rows_ref, torch.randn((B, c), generator=gen, device=cuda_device, dtype=dtype)),
        (dense.gemv_cols, dense.gemv_cols_ref, torch.randn((B, r), generator=gen, device=cuda_device, dtype=dtype)),
    ):
        before = kern.launches
        y = kern(M, vec)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        bound = tol * plain(M.abs(), vec.abs())
        assert bool(torch.all((y - plain(M, vec)).abs() <= bound))
        assert torch.equal(kern(M, vec), y)  # a fixed summation order
        if B == 1:
            assert torch.equal(kern(M[0], vec[0]), y[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-13)])
@pytest.mark.parametrize("shape", [(3, 77, 53), (4, 130, 1771)])
def test_gemv_kernels_take_a_misaligned_view_on_card(cuda_device, shape, dtype, tol):
    """M a contiguous view one element into its buffer (no row on a 16-byte
    boundary where the width is a multiple of 4): one launch per call,
    within the tolerance, a bit-equal repeat, and the very bits of an
    aligned copy (the summation order depends on the shape alone)."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    B, r, c = shape
    buf = torch.randn(1 + B * r * c, generator=gen, device=cuda_device, dtype=dtype)
    M = buf[1 : 1 + B * r * c].view(B, r, c)
    assert M.is_contiguous() and M.data_ptr() % 16 != 0
    for kern, plain, vec in (
        (dense.gemv_rows, dense.gemv_rows_ref, torch.randn((B, c), generator=gen, device=cuda_device, dtype=dtype)),
        (dense.gemv_cols, dense.gemv_cols_ref, torch.randn((B, r), generator=gen, device=cuda_device, dtype=dtype)),
    ):
        before = kern.launches
        y = kern(M, vec)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        bound = tol * plain(M.abs(), vec.abs())
        assert bool(torch.all((y - plain(M, vec)).abs() <= bound))
        assert torch.equal(kern(M, vec), y)
        assert torch.equal(kern(M.clone(), vec), y)


@pytest.mark.cuda
def test_gemv_wrappers_raise_on_card_for_bad_input(cuda_device):
    M = torch.zeros((2, 4, 3), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        dense.gemv_rows(M.transpose(1, 2), torch.zeros((2, 4), device=cuda_device))
    with pytest.raises(ValueError, match="on cpu"):
        dense.gemv_rows(M, torch.zeros((2, 3)))
