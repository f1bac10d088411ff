"""C4 and C5, the spectral-cone kernels of csrc/spectral_proj.cu, on the
card: against their plain versions (scs_tpu_torch.tools.mixed_cone's
checks), the wrappers' refusals of bad input, and the projector sending
the sum-of-largest and logdet buckets through them. Every test is
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
