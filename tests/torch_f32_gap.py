"""The f32 iteration gap of the wide mixed-cone batch, on the CPU: a cut of
scs_tpu_torch.tools.mixed_cone.wide_cone solved in float32 and float64 by
both packages, to tell the reference's own f32 behaviour from the port's.

    python tests/torch_f32_gap.py [FRACTION] [B]

FRACTION (default 0.1) scales every count of the wide cone (equalities,
inequalities, box bounds, exp, dual exp and power cones; at least one SOC
of 50 and one 32 x 32 PSD block are kept); B (default 16) planted-optimum
problems from tests/oracle.py (RandomState(4000), n = m // 3), solved as
one batch with the settings of chip_smoke.py's mixed-cone phases (eps 1e-4,
scale 1.0, max_iters 20000). Prints, per package and dtype, the iteration
counts, their mean, the statuses and the largest |pobj - p*|.

Not a test (pytest collects only test_*.py): a solve of 16 problems takes
minutes, and scs_tpu's f32 run can reach max_iters on one of them.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import scs_tpu  # noqa: E402
import scs_tpu_torch  # noqa: E402
from scs_tpu_torch.tools import mixed_cone  # noqa: E402


def cut_cone(frac):
    """wide_cone with every count scaled by frac."""
    K = mixed_cone.wide_cone(
        bounds=int(400 * frac), ep=int(200 * frac), ed=int(100 * frac), powers=int(100 * frac)
    )
    K.update(z=int(100 * frac), l=int(500 * frac), q=[50] * max(1, int(20 * frac)),
             s=[32] * max(1, int(4 * frac)))
    return K


def main(argv):
    frac = float(argv[0]) if argv else 0.1
    B = int(argv[1]) if len(argv) > 1 else 16
    torch.set_num_threads(2)
    K = cut_cone(frac)
    data, p_star = mixed_cone.gen_mixed_batch(K, B, 4000)
    counts = {k: (len(v) if isinstance(v, list) else v) for k, v in K.items()}
    print(f"{B} problems of {data['A'].shape[1]} x {data['A'].shape[2]}; cone counts {counts}", flush=True)
    kw = dict(eps_abs=mixed_cone.MIXED_EPS, eps_rel=mixed_cone.MIXED_EPS, max_iters=20000, scale=1.0)
    for pkg, make in (
        ("scs_tpu", lambda dt: scs_tpu.BatchedSCS(data, K, dtype=dt, **kw)),
        ("scs_tpu_torch", lambda dt: scs_tpu_torch.BatchedSCS(data, K, dtype=dt, device="cpu", **kw)),
    ):
        for dt in ("float32", "float64"):
            t0 = time.perf_counter()
            res = make(dt).solve()
            its = [r["info"]["iter"] for r in res]
            statuses = sorted({r["info"]["status"] for r in res})
            err = np.abs(np.array([r["info"]["pobj"] for r in res]) - p_star).max()
            print(f"{pkg} {dt}: iterations {its}, mean {np.mean(its):.1f}; statuses {statuses}; "
                  f"max |pobj - p*| {err:.2e}; {time.perf_counter() - t0:.0f} s on the CPU", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
