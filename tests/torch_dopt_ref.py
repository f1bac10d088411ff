"""The D-optimal design problems of chip_smoke.py's phase 15 (a) on the CPU:
the Kiefer-Wolfowitz gate's calibration, and scs_tpu's own behaviour on the
full-size problems in f32 and f64.

    python tests/torch_dopt_ref.py calib [SEED ...]
    python tests/torch_dopt_ref.py ref float32|float64 [COUNT]

calib: the port (device "cpu", plain projections) on one problem of
scs_tpu_torch.tools.mixed_cone.dopt_problem at (n = 8, p = 64) per seed
(default 5150), f32, eps 1e-4, max_iters 20000: status, iterations, |t -
logdet X(lam)| / (1 + |t|) and the Kiefer-Wolfowitz gap / n, from which
chip_smoke.py's DOPT_DELTA was fixed. ~1 min a seed.

ref: scs_tpu (the reference, JAX on the CPU) on problems 0 .. COUNT-1
(default 4) of phase 15 (a)'s batch (n = 32, p = 256, seed 5150 + i) alone,
in the given type, eps 1e-4, max_iters 20000: the same numbers. Up to ~70 s
a problem in f32.

Not a test (pytest collects only test_*.py): the solves take minutes.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
from scipy import sparse  # noqa: E402

import scs_tpu  # noqa: E402
import scs_tpu_torch  # noqa: E402
from scs_tpu_torch.tools import mixed_cone as mc  # noqa: E402

KW = dict(eps_abs=1e-4, eps_rel=1e-4, max_iters=20000, verbose=False)


def _report(tag, res, V, secs):
    rel, gap = mc.dopt_check(V, res["x"])
    print(f"{tag}: {res['info']['status']} in {res['info']['iter']} iterations, {secs:.1f} s; "
          f"pobj {res['info']['pobj']:.6f}; |t - logdet X| / (1 + |t|) {rel:.3e}; "
          f"Kiefer-Wolfowitz gap / n {gap:.4e}", flush=True)


def calib(seeds):
    n, p = 8, 64
    for seed in seeds:
        V = np.random.RandomState(seed).randn(p, n)
        data = mc.dopt_problem(V)
        data["A"] = sparse.csc_matrix(data["A"].astype(np.float32).astype(np.float64))
        t0 = time.time()
        res = scs_tpu_torch.solve(data, mc.dopt_cone(n, p), device="cpu", dtype="float32", **KW)
        _report(f"port f32 (n={n}, p={p}) seed {seed}", res, V, time.time() - t0)


def ref(dtype, count):
    data, V = mc.gen_dopt_batch(count, mc.DOPT_N, mc.DOPT_P, mc.DOPT_SEED)
    K = mc.dopt_cone(mc.DOPT_N, mc.DOPT_P)
    for i in range(count):
        one = {"A": sparse.csc_matrix(data["A"][i].astype(np.float64)), "b": data["b"][i],
               "c": data["c"][i]}
        t0 = time.time()
        res = scs_tpu.solve(one, K, dtype=dtype, **KW)
        _report(f"scs_tpu {dtype} problem {i}", res, V[i], time.time() - t0)


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["calib"]:
        calib([int(a) for a in args[1:]] or [mc.DOPT_SEED])
    elif args[:1] == ["ref"] and len(args) >= 2:
        ref(args[1], int(args[2]) if len(args) > 2 else 4)
    else:
        sys.exit(__doc__)
