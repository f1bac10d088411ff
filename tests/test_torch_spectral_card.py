"""C4 and C5, the spectral-cone kernels of csrc/spectral_proj.cu, on the
card: against their plain versions (scs_tpu_torch.tools.mixed_cone's
checks), at the edges of the kernels' layouts too, the multisection's
serial passes against the plain map's, the wrappers' refusals of bad
input, and the projector sending the sum-of-largest and logdet buckets
through them. Every test is
`cuda`-marked and skips without a card; this file imports no JAX.

    python -m pytest tests/test_torch_spectral_card.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from scs_tpu_torch.cones import ConeSpec
from scs_tpu_torch.ops import projections as tpr
from scs_tpu_torch.tools import mixed_cone as mc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spectral_proj kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["logdet", "sl"])
def test_spectral_kernels_match_plain_on_card(cuda_device, kernel, dtype):
    """check_spectral_kernels' gates (agreement to KERNEL_TOL, bit-equal
    repeat, geometry in f64 against the oracle) at small sizes, rows in
    every regime, unsorted and ascending, in registers and past them."""
    cases = dict(logdet_cases=(), sl_cases=())
    if kernel == "logdet":
        cases["logdet_cases"] = ((14, 1), (14, 3), (21, 33), (7, 300))
    else:
        cases["sl_cases"] = ((10, 1, 1, False), (10, 6, 5, True), (15, 33, 2, False),
                             (5, 300, 7, False))
    before = tpr._proj_logdet_vec_batch.launches + tpr._proj_sl_vec_batch.launches
    lines = []
    mc.check_spectral_kernels(3.35e12, {torch.float32: 67e12, torch.float64: 34e12}, 1.98e9,
                              report_at={"proj_logdet_vec": (), "proj_sl_vec": ()},
                              geometry_rows=7, log=lines.append, dtypes=(dtype,), **cases)
    assert len(lines) == 4 and all(str(dtype)[6:] in ln for ln in lines)  # a fault raises
    assert tpr._proj_logdet_vec_batch.launches + tpr._proj_sl_vec_batch.launches > before


# n at each capacity of the kernels' layouts and one past it (a group of 8
# lanes holds 8, 16, 32 or 64 eigenvalues, of 16 lanes 128, of 32 lanes
# 256, then the memory path), at row counts the launch does not tile
EDGE_LOGDET = ((5, 8), (5, 9), (3, 32), (3, 33), (3, 64), (3, 65), (3, 128), (3, 129),
               (2, 256), (2, 257))
EDGE_SL = ((5, 16, 3, False), (5, 17, 16, True), (3, 64, 1, False), (3, 65, 64, True),
           (3, 128, 7, False), (3, 129, 2, True), (2, 256, 255, False), (2, 257, 1, True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spectral_kernels_match_plain_at_the_layouts_edges(cuda_device, dtype):
    lines = []
    mc.check_spectral_kernels(3.35e12, {torch.float32: 67e12, torch.float64: 34e12}, 1.98e9,
                              logdet_cases=EDGE_LOGDET, sl_cases=EDGE_SL,
                              report_at={"proj_logdet_vec": (), "proj_sl_vec": ()},
                              geometry_rows=2, log=lines.append, dtypes=(dtype,))
    assert len(lines) == len(EDGE_LOGDET) + len(EDGE_SL)  # a fault raises


@pytest.mark.cuda
def test_logdet_kernel_multisects_both_roots(cuda_device):
    """On logdet_rows(64, 32) in f32 the kernel's serial passes, outer and
    inner, are at most a third of the plain map's: the bisections run as
    multisection in the kernel."""
    rows = mc.logdet_rows(64, 32, seed=96)
    counts = {}
    tpr._proj_logdet_vec_batch_ref(*(torch.as_tensor(x, dtype=torch.float32) for x in rows),
                                   counts=counts)
    inner, outer = (torch.zeros(64, dtype=torch.int32, device=cuda_device) for _ in range(2))
    tpr._proj_logdet_vec_batch(
        *(torch.as_tensor(x, dtype=torch.float32, device=cuda_device) for x in rows),
        inner_out=inner, outer_out=outer)
    assert 0 < int(inner.sum()) <= int(counts["inner"].sum()) / 3
    assert 0 < int(outer.sum()) <= int(counts["outer"].sum()) / 3
    # the rows inside run no pass, in either
    assert torch.equal((inner.cpu() == 0), counts["inner"] == 0)


@pytest.mark.cuda
def test_spectral_wrappers_raise_on_card_for_bad_input(cuda_device):
    w0 = torch.zeros(4, 3, device=cuda_device)
    t0 = torch.zeros(4, device=cuda_device)
    with pytest.raises(ValueError):
        tpr._proj_logdet_vec_batch(t0, torch.zeros(4), w0)  # v0 on the CPU
    with pytest.raises(ValueError):
        tpr._proj_logdet_vec_batch(t0, t0, w0, inner_out=torch.zeros(4, dtype=torch.int64,
                                                                      device=cuda_device))
    with pytest.raises(ValueError):
        tpr._proj_sl_vec_batch(t0, w0, 2, outer_out=torch.zeros(3, dtype=torch.int32,
                                                                 device=cuda_device))
    with pytest.raises(ValueError):
        tpr._proj_sl_vec_batch(t0, w0, 4)
    with pytest.raises(TypeError):
        tpr._proj_sl_vec_batch(t0.half(), w0.half(), 1)


@pytest.mark.cuda
def test_projector_on_card_sends_spectral_buckets_through_the_kernels(cuda_device):
    """The dispatcher on the card, f64, single and batched: each sl bucket
    and the logdet bucket one kernel launch, the answer the CPU's."""
    K = {"z": 1, "l": 2, "sl_n": [4, 3], "sl_k": [2, 1], "d": [3, 2]}
    spec = ConeSpec.from_dict(K)
    proj = tpr.get_projector(spec, torch.float64)
    Z = torch.as_tensor(np.random.RandomState(1).randn(3, spec.dim) * 2)
    on_cpu = proj(Z)
    before = tpr._proj_logdet_vec_batch.launches, tpr._proj_sl_vec_batch.launches
    on_card = proj(Z.to(cuda_device))
    after = tpr._proj_logdet_vec_batch.launches, tpr._proj_sl_vec_batch.launches
    assert (after[0] - before[0], after[1] - before[1]) == (2, 2)
    np.testing.assert_allclose(on_card.cpu().numpy(), on_cpu.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(proj(Z[1].to(cuda_device)).cpu().numpy(), on_cpu[1].numpy(),
                               rtol=1e-9, atol=1e-9)
