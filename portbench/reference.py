"""The plain reference that decides `correct`.

It judges what the timed path returned, `BatchedSCS(...).solve()` on the
window's batches, against the raw problem data the benchmark made itself
(the pool), in float64 plain PyTorch on the data's device. It imports
nothing of the program and takes nothing the program derived: the
equilibrated data, the factor and the scalings are worked out of nothing
here; every quantity is recomputed from the raw A, P, b, c and the
returned x, y, s.

Numbers, each the worst over the problems it covers (all of them for
wrong_status, the `solved` ones for the rest), compared with the
configuration's `limits`:

  wrong_status  problems whose status is neither "solved" nor
                "solved_inaccurate": the problems are feasible and
                bounded by construction, so any certificate is wrong
  kkt_ratio     the largest of the primal residual, the dual residual and
                the duality gap of (x, y, s), each over the solver's own
                stopping criterion at the configured eps (2-norms, as
                the port's `_status_from` states it): "solved" claims <= 1
  y_dist        the distance of y from K*, over 1 + its norm: y is the
                cone projection's output (of the dual iterate u), so it
                lies in K* to rounding
  s_dist        the distance of s from K, over 1 + its norm: s comes from
                the splitting's other iterate v, in K only at the fixed
                point, so it reads the residual again, with a long tail
  obj_err       |x'P x / 2 + c'x - p*| over 1 + the larger planted term
  report_obj    the gap between the returned pobj / dobj and the same
                objectives of the returned x, y, over the largest term
  report_res    the gap between the returned res_pri / res_dual / gap and
                the same residuals recomputed, over the criterion's limit

The last two read the program's own account of its answer: in float64 it
agrees with the recomputation to rounding (1e-16 and 1e-12 on the CPU),
while any part of the solve held in float32 leaves it off by ~1e-7 and
~1e-3, which is what the control (the program at float32) fails on. At
eps 1e-4 the residuals and the distances from the optimum read alike in
both precisions.

A configuration compares the numbers its `limits` name; the others are
reported beside them as readings.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import cones

NUMBERS = ("wrong_status", "kkt_ratio", "y_dist", "s_dist", "obj_err", "report_obj", "report_res")
_OK_STATUS = ("solved", "solved_inaccurate")


def _stack(results, key, dev):
    return torch.as_tensor(np.stack([r[key] for r in results]), dtype=torch.float64, device=dev)


def _info(results, key, dev):
    return torch.tensor([float(r["info"][key]) for r in results], dtype=torch.float64, device=dev)


def check_batch(problem, results, eps_abs, eps_rel, block_bytes=2**31):
    """Numbers of one batch: {name: float worst over its problems} and the
    number of problems they cover. `problem` is the generator's entry the
    batch was built from, `results` what solve() returned for it. Problems
    are checked in blocks of about `block_bytes` of copied data."""
    data = problem["data"]
    dev = data["A"].device
    K = problem["cone"]
    per = sum(v[0].numel() * 8 for k, v in data.items() if k in ("A", "P"))
    sub = max(1, block_bytes // per)
    out = {k: 0.0 for k in NUMBERS}
    out["wrong_status"] = float(sum(r["info"]["status"] not in _OK_STATUS for r in results))
    solved = [i for i, r in enumerate(results) if r["info"]["status"] == "solved"]
    if not solved:
        return out, 0
    nrm = lambda v: torch.linalg.vector_norm(v, dim=1)  # noqa: E731
    mx = torch.maximum
    for lo in range(0, len(solved), sub):
        idx = solved[lo : lo + sub]
        res = [results[i] for i in idx]
        it = torch.as_tensor(idx, device=dev)
        A = data["A"].index_select(0, it).double()
        b = data["b"].index_select(0, it).double()
        c = data["c"].index_select(0, it).double()
        x, y, s = (_stack(res, k, dev) for k in ("x", "y", "s"))
        Ax = torch.bmm(A, x[:, :, None])[:, :, 0]
        Aty = torch.bmm(A.mT, y[:, :, None])[:, :, 0]
        del A
        if "P" in data:
            P = data["P"].index_select(0, it).double()
            Px = torch.bmm(P, x[:, :, None])[:, :, 0]
            del P
        else:
            Px = torch.zeros_like(x)
        xPx, ctx, bty = (x * Px).sum(1), (c * x).sum(1), (b * y).sum(1)
        pri, dual, gap = nrm(Ax + s - b), nrm(Px + Aty + c), (xPx + ctx + bty).abs()
        lim_p = eps_abs + eps_rel * mx(mx(nrm(Ax), nrm(s)), nrm(b))
        lim_d = eps_abs + eps_rel * mx(mx(nrm(Px), nrm(Aty)), nrm(c))
        lim_g = eps_abs + eps_rel * mx(mx(xPx.abs(), ctx.abs()), bty.abs())
        kkt = mx(mx(pri / lim_p, dual / lim_d), gap / lim_g)
        s_dist = nrm(s - cones.proj_cone(s, K)) / (1.0 + nrm(s))
        y_dist = nrm(cones.proj_cone(-y, K)) / (1.0 + nrm(y))
        pobj, dobj = 0.5 * xPx + ctx, -0.5 * xPx - bty
        p_star = problem["p_star"].index_select(0, it)
        scale = problem["obj_scale"].index_select(0, it)
        obj_err = (pobj - p_star).abs() / (1.0 + scale)
        terms = mx(mx((0.5 * xPx).abs(), ctx.abs()), bty.abs())
        rep_obj = mx((_info(res, "pobj", dev) - pobj).abs(), (_info(res, "dobj", dev) - dobj).abs())
        rep_res = mx(
            mx((_info(res, "res_pri", dev) - pri).abs() / lim_p,
               (_info(res, "res_dual", dev) - dual).abs() / lim_d),
            (_info(res, "gap", dev) - gap).abs() / lim_g,
        )
        worst = {
            "kkt_ratio": kkt,
            "y_dist": y_dist,
            "s_dist": s_dist,
            "obj_err": obj_err,
            "report_obj": rep_obj / terms,
            "report_res": rep_res,
        }
        for k, v in worst.items():
            # a NaN anywhere is the worst reading there is
            w = math.inf if bool(torch.isnan(v).any()) else float(v.max())
            out[k] = max(out[k], w)
    return out, len(solved)


def judge(numbers, limits):
    """(correct, [(name, value, limit)]) over the numbers `limits` names:
    every one at or under its limit; a missing or NaN number fails."""
    rows = [(k, numbers.get(k, math.nan), float(limits[k])) for k in NUMBERS if k in limits]
    return all(v <= lim for _, v, lim in rows), rows
