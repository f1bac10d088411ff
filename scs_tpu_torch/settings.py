"""Solver settings: names, defaults, and validation.

Mirrors the reference solver's 17 runtime settings (parsed by keyword in the
reference C extension, scs-python's scs/scsobject.h:467-495) plus the
NaN/Inf validation policy documented at scsobject.h:802-868:

  * max_iters > 0
  * acceleration_lookback >= 0 (0 disables AA)
  * acceleration_interval > 0
  * acceleration_regularization finite, >= 0
  * acceleration_relaxation finite, in [0, 2]
  * scale finite, > 0
  * time_limit_secs >= 0 (0 disables; +inf allowed)
  * eps_abs / eps_rel / eps_infeas >= 0 (+inf allowed, NaN rejected)
  * alpha finite, in (0, 2)
  * rho_x finite, > 0

Extras with no reference analogue are grouped at the bottom of the
dataclass: device and dtype control, linear-solver strategy, CG knobs,
and the check interval. The field set is scs_tpu's (scs_tpu/settings.py)
plus `device`, so one settings dict works with either package; keys that
serve only the JAX package's TPU runtime (host_poll_chunks) are accepted
and validated but have no effect here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

# Default operating point of the reference solver (BASELINE.md "Reference
# default operating point"; reference README.md:98-104).
DEFAULTS = dict(
    verbose=True,
    normalize=True,
    adaptive_scale=True,
    max_iters=100_000,
    scale=0.1,
    eps_abs=1e-4,
    eps_rel=1e-4,
    eps_infeas=1e-7,
    alpha=1.5,
    rho_x=1e-6,
    time_limit_secs=0.0,
    acceleration_lookback=10,
    acceleration_interval=10,
    acceleration_type_1=1,
    acceleration_regularization=1e-8,
    acceleration_relaxation=1.0,
    write_data_filename=None,
    log_csv_filename=None,
)


def _err(msg):
    raise ValueError(msg)


# What dtype "auto" resolves to, on every device. On the CPU: the reference
# core is f64 unless built with -DSFLOAT. On CUDA: measured, PERF.md §6, the
# dtype table of tools/dtype_proto.py (NVIDIA H100 80GB HBM3, 700.00 W). At
# the default eps_infeas 1e-7, f32 certifies no unbounded LP (rows
# status_unbounded_*), which rules it out for zero / nonnegative cones, the
# class of the only rows where it is faster (flagship, bell_batch). It
# reaches eps 1e-4 on 0 of 64 D-optimal designs (row dopt), and f64 is
# faster or ties on every other row. Pass dtype="float32" to force f32.
AUTO_DTYPE = "float64"


@dataclasses.dataclass
class Settings:
    """Validated solver settings (reference parity + port extras)."""

    verbose: bool = True
    normalize: bool = True
    adaptive_scale: bool = True
    max_iters: int = 100_000
    scale: float = 0.1
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    eps_infeas: float = 1e-7
    alpha: float = 1.5
    rho_x: float = 1e-6
    time_limit_secs: float = 0.0
    acceleration_lookback: int = 10
    acceleration_interval: int = 10
    acceleration_type_1: int = 1
    acceleration_regularization: float = 1e-8
    acceleration_relaxation: float = 1.0
    write_data_filename: Optional[str] = None
    log_csv_filename: Optional[str] = None

    # --- extras (no reference analogue) ---
    # Where the solve runs: "cuda" | "cuda:<index>" | "cpu". The card by
    # default; with no card that raises, naming device="cpu": nothing falls
    # back to the CPU unasked.
    device: str = "cuda"
    # Numeric dtype of the solve: "auto" | "float64" | "float32". "auto"
    # resolves at construction to AUTO_DTYPE, float64 on every device
    # (PERF.md §6, the dtype table). Pass "float32" or "float64" to force
    # either.
    dtype: str = "auto"
    # Linear-system strategy: "auto" | "direct" (dense Cholesky) |
    # "indirect" (matrix-free CG on dense A) | "bell" (matrix-free CG with
    # the block-ELL SpMV kernel). "auto" is resolved by the API (direct for
    # n <= 4096).
    solver_strategy: str = "auto"
    # Tile size for the block-ELL pack (bell strategy); one CUDA thread
    # block of bell_block_size threads per block-row, so at most 1024.
    bell_block_size: int = 128
    # Direct-strategy linear solve: "cholesky" applies the factor by two
    # triangular solves; "inverse" precomputes S^-1 and applies it as one
    # dense matvec (BatchedSCS's default).
    direct_solver: str = "cholesky"
    # CG controls (reference: linsys/cpu/indirect, tolerance tightened
    # per-iteration at rate cg_rate).
    cg_rate: float = 2.0
    cg_max_iters: int = 1000
    cg_tol_min: float = 1e-12
    # Inexact-Krylov slack: CG tolerance = cg_tol_factor x the previous
    # DR step size (see solver._step_lin).
    cg_tol_factor: float = 2.0
    # ADMM iterations between host-side checks (residuals, termination,
    # adaptive scale, verbose line, time limit, SIGINT).
    check_interval: int = 25
    # JAX-package key (TPU host polling cadence); accepted, no effect.
    host_poll_chunks: int = 8
    # Per-phase timing (info dict lin_sys_time/cone_time/accel_time).
    # "auto": estimate (phase calls timed along the solve x phase counts)
    #   when the solve is verbose or longer than 0.3 s; "off": never
    #   measure; "always":
    #   measured (SCS runs the per-iteration instrumented loop with
    #   check_interval 1; BatchedSCS scales BatchedSCS.phase_times()).
    phase_timing: str = "auto"
    # AA safeguarding: accept a candidate if its fixed-point residual is at
    # most aa_safeguard_factor x the current one; optionally clear the AA
    # memory after a rejection.
    aa_safeguard_factor: float = 2.0
    aa_reset_on_reject: bool = False
    # Batched path: retirement compaction and its segment length, and
    # whether a rescale refactorizes inside the chunk or between segments
    # (BatchedSCS sets its own defaults); no effect on a single solve.
    batch_compaction: bool = True
    batch_compact_interval: int = 4
    rescale_in_chunk: bool = True
    # Direct-strategy iterative-refinement passes (-1 = auto: 1 in f32,
    # 2 on curved cones, 0 in f64); unused under CG.
    lin_refine_steps: int = -1
    # Adaptive-scale update guards (reference core: scale updated when the
    # primal/dual residual ratio drifts).
    rescale_min_iters: int = 100
    rescale_factor_band: float = 2.0
    min_scale: float = 1e-6
    max_scale: float = 1e6

    def __post_init__(self):
        f = float
        if int(self.max_iters) <= 0:
            _err("max_iters must be positive")
        if int(self.acceleration_lookback) < 0:
            _err(
                "acceleration_lookback must be nonnegative "
                "(use acceleration_type_1=0 for type-II AA)"
            )
        if int(self.acceleration_interval) <= 0:
            _err("acceleration_interval must be positive")
        r = f(self.acceleration_regularization)
        if not math.isfinite(r) or r < 0:
            _err("acceleration_regularization must be a nonnegative finite number")
        r = f(self.acceleration_relaxation)
        if not math.isfinite(r) or r < 0 or r > 2:
            _err("acceleration_relaxation must be in [0, 2]")
        if not math.isfinite(f(self.scale)) or f(self.scale) <= 0:
            _err("scale must be a positive finite number")
        t = f(self.time_limit_secs)
        if math.isnan(t) or t < 0:
            _err("time_limit_secs must be nonnegative")
        for name in ("eps_abs", "eps_rel", "eps_infeas"):
            v = f(getattr(self, name))
            if math.isnan(v) or v < 0:
                _err(f"{name} must be nonnegative")
        a = f(self.alpha)
        if not math.isfinite(a) or a <= 0 or a >= 2:
            _err("alpha must be in (0, 2)")
        rx = f(self.rho_x)
        if not math.isfinite(rx) or rx <= 0:
            _err("rho_x must be a positive finite number")
        if self.dtype not in ("auto", "float64", "float32"):
            _err("dtype must be 'auto', 'float64' or 'float32'")
        try:
            dev = torch.device(self.device)
        except (RuntimeError, TypeError):
            _err(f"device must be 'cuda[:index]' or 'cpu' (got {self.device!r})")
        if dev.type not in ("cpu", "cuda"):
            _err(f"device must be 'cuda[:index]' or 'cpu' (got {self.device!r})")
        if dev.type == "cuda" and not torch.cuda.is_available():
            _err(
                f"device={self.device!r} (the default is 'cuda') but PyTorch "
                f"sees no CUDA device; pass device=\"cpu\" to solve on the CPU"
            )
        if self.dtype == "auto":
            self.dtype = AUTO_DTYPE
        if int(self.check_interval) < 1:
            _err("check_interval must be >= 1")
        if int(self.host_poll_chunks) < 1:
            _err("host_poll_chunks must be >= 1")
        if int(self.batch_compact_interval) < 1:
            # a non-positive segment would spin BatchedSCS.solve forever
            # (run_seg's chunk condition is immediately false; ADVICE r3)
            _err("batch_compact_interval must be >= 1")
        if self.phase_timing not in ("auto", "always", "off"):
            _err("phase_timing must be 'auto', 'always' or 'off'")
        if self.direct_solver not in ("cholesky", "inverse"):
            _err("direct_solver must be 'cholesky' or 'inverse'")
        if self.solver_strategy not in ("auto", "direct", "indirect", "bell"):
            _err(
                "solver_strategy must be 'auto', 'direct', 'indirect' or"
                " 'bell' (block-ELL matrix-free)"
            )

    @classmethod
    def from_kwargs(cls, **kwargs) -> "Settings":
        """Build Settings, rejecting unknown keys with TypeError.

        The reference raises TypeError from PyArg_ParseTupleAndKeywords for
        unknown keywords (tested at test_scs_object.py:113-133); mirror that.
        """
        valid = {fld.name for fld in dataclasses.fields(cls)}
        for k in kwargs:
            if k not in valid:
                raise TypeError(f"'{k}' is an invalid keyword argument for SCS()")
        # bool-typed settings must be genuine bools in the reference
        # (parsed with O! PyBool_Type); accept ints 0/1 too for convenience.
        return cls(**kwargs)


StrOrNone = Union[str, None]
