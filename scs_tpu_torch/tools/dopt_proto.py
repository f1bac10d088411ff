"""Phase 15 (a)'s D-optimal design batch on the card under other settings:
how the type, the batch size, the settings and eigh move convergence.

    python -m scs_tpu_torch.tools.dopt_proto [--settings] [--batch-sizes] [--eigh]

--settings: the 64 problems (n = 32, p = 256, mixed_cone.gen_dopt_batch)
in f32 at the defaults, at scale 1.0 and without acceleration, and in f64
at the defaults and at scale 1.0; --batch-sizes: f32 on the first 8 and
the first 16 problems; --eigh: f32 on all 64 with torch.linalg.eigh run in
chunks of 8 matrices, and in f64 (cast back). Each line: seconds, solved
count, iterations (mean, median, max, the first 16), |t - logdet X(lam)| /
(1 + |t|) and the Kiefer-Wolfowitz gap / n over the solved problems (eps
1e-4, max_iters 20000). Needs a CUDA card; nothing runs on import.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import mixed_cone as mc


def _eigh_chunks(eigh):
    def fn(a, *args, **kw):
        outs = [eigh(a[i : i + 8], *args, **kw) for i in range(0, a.shape[0], 8)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    return fn


def _eigh_f64(eigh):
    def fn(a, *args, **kw):
        w, v = eigh(a.double(), *args, **kw)
        return w.to(a.dtype), v.to(a.dtype)

    return fn


def run(label, data, V, dtype="float32", **kw):
    from .. import BatchedSCS  # noqa: PLC0415

    B = len(V)
    t0 = time.perf_counter()
    res = BatchedSCS(data, mc.dopt_cone(mc.DOPT_N, mc.DOPT_P), dtype=dtype, eps_abs=1e-4,
                     eps_rel=1e-4, max_iters=20000, device="cuda", **kw).solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    its = np.array([r["info"]["iter"] for r in res])
    ok = np.array([r["info"]["status"] == "solved" for r in res])
    g = np.array([mc.dopt_check(V[i], r["x"]) for i, r in enumerate(res)])
    gates = (f"|t - logdet X| / (1 + |t|) max {g[ok, 0].max():.3e}, over 1e-3 {(g[ok, 0] > 1e-3).sum()}; "
             f"Kiefer-Wolfowitz gap / n max {g[ok, 1].max():.3e}") if ok.any() else "none solved"
    print(f"{label} {dtype} {kw}: {secs:.1f} s; solved {ok.sum()}/{B}; iterations mean "
          f"{its.mean():.0f}, median {np.median(its):.0f}, max {its.max()}, first 16 "
          f"{its[:16].tolist()}; {gates}", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        sys.exit("dopt_proto: PyTorch sees no CUDA device; this runs only on the card")
    data, V = mc.gen_dopt_batch(mc.DOPT_B, mc.DOPT_N, mc.DOPT_P, mc.DOPT_SEED)
    if "--settings" in argv:
        for dtype, kw in (("float32", {}), ("float32", {"scale": 1.0}),
                          ("float32", {"acceleration_lookback": 0}), ("float64", {}),
                          ("float64", {"scale": 1.0})):
            run("B=64", data, V, dtype, **kw)
    if "--batch-sizes" in argv:
        for B in (8, 16):
            run(f"B={B} (problems 0-{B - 1})", {k: v[:B] for k, v in data.items()}, V[:B])
    if "--eigh" in argv:
        eigh = torch.linalg.eigh
        try:
            for name, wrap in (("eigh in chunks of 8", _eigh_chunks), ("eigh in f64", _eigh_f64)):
                torch.linalg.eigh = wrap(eigh)
                run(f"B=64, {name}", data, V)
        finally:
            torch.linalg.eigh = eigh


if __name__ == "__main__":
    main()
