"""scs_tpu_torch — the PyTorch/CUDA port of scs_tpu, for NVIDIA GPUs.

Solves   minimize    (1/2) x'Px + c'x
         subject to  Ax + s = b,  s in K

with the public surface of scs_tpu (SCS, solve, LinearSolver, ConeSpec,
Settings, the status constants, the info dict). The port runs in
PyTorch; where scs_tpu ran a Pallas TPU kernel, it runs a CUDA kernel
written by hand for Hopper (ops/csrc/), built with nvcc at first use.

Ported: every cone kind of scs_tpu (zero, nonnegative, box, second-order,
PSD, complex PSD, exponential and power with their duals, ell1, nuclear,
sum-of-largest, logdet), with or without P, single problems (SCS, solve)
and batches (BatchedSCS, solve_batch), under the dense strategies
"direct" (Cholesky factor or precomputed inverse) and "indirect" (CG),
whose matvecs run through the batched GEMV kernels (ops/dense.py), a batch
being a dense (B, m, n) array, and the "bell" strategy (block-ELL
matrix-free CG), a batch being a list of sparse matrices; the f32
high-accuracy mode (compensated products, ops/df32.py) and the batched
polish (BatchedSCS.polish); the per-phase timers, measured with
phase_timing="always" (the instrumented loop; BatchedSCS.phase_times); and
the bench, `python -m scs_tpu_torch.bench_cli`. Not yet ported
(ROADMAP.md): ShardedSCS and the rest of scs_tpu.parallel. The package never
imports JAX; scs_tpu stays the reference it is tested against.
"""

__version__ = "1.0.0"  # tracks scs_tpu.__version__

from .api import SCS, solve, LinearSolver  # noqa: E402,F401
from .batch import BatchedSCS, solve_batch  # noqa: E402,F401
from .cones import ConeSpec  # noqa: E402,F401
from .settings import Settings  # noqa: E402,F401
from .info import (  # noqa: E402,F401
    INFEASIBLE_INACCURATE,
    UNBOUNDED_INACCURATE,
    SIGINT,
    FAILED,
    INDETERMINATE,
    INFEASIBLE,
    UNBOUNDED,
    UNFINISHED,
    SOLVED,
    SOLVED_INACCURATE,
)
