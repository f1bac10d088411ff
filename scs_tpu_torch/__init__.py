"""scs_tpu_torch — the PyTorch/CUDA port of scs_tpu, for NVIDIA GPUs.

Solves   minimize    (1/2) x'Px + c'x
         subject to  Ax + s = b,  s in K

with the public surface of scs_tpu (SCS, solve, LinearSolver, ConeSpec,
Settings, the status constants, the info dict). The port runs in
PyTorch; where scs_tpu ran a Pallas TPU kernel, it runs a CUDA kernel
written by hand for Hopper (ops/csrc/), built with nvcc at first use.

Ported so far, under the "bell" strategy (block-ELL matrix-free CG) over
zero and nonnegative cones, with or without P: single-problem solves
(SCS, solve) and batches of B same-shape sparse problems (BatchedSCS,
solve_batch). The rest is queued in ROADMAP.md. The package never imports
JAX; scs_tpu stays the reference it is tested against.
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
