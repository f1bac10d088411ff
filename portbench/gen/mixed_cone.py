"""Random feasible problems over a mixed cone with a planted optimum.

The recipe of scs-python's test/gen_random_cone_prob.py (`gen_feasible`,
as the repository's test oracle restates it), drawn over a batch on the
device from a seeded torch.Generator: z normal; y = proj_K*(z) and
s = y - z = proj_K(-z), complementary by Moreau; A (m, n) with
round(density m n) normal entries at uniform positions without
replacement; x normal; c = -A'y, b = A x + s. Then (x, y, s) is optimal
and p* = c'x.
"""

from __future__ import annotations

import torch

from portbench import cones


def make(cfg, batch, seed, device):
    """As gen/dense_qp.py's make, with no P."""
    K = cfg["cone"]
    m, n = cones.cone_dims(K), int(cfg["n"])
    if m != int(cfg["m"]):
        raise ValueError(f"cone K has {m} rows, the configuration says {cfg['m']}")
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((batch, m), generator=gen, device=device, dtype=dtype)
    s = cones.proj_cone(-z, K)
    y = z + s
    nnz = int(round(float(cfg["density"]) * m * n))
    keys = torch.rand((batch, m * n), generator=gen, device=device)
    pos = keys.topk(nnz, dim=1).indices
    vals = torch.randn((batch, nnz), generator=gen, device=device, dtype=dtype)
    A = torch.zeros((batch, m * n), device=device, dtype=dtype).scatter_(1, pos, vals)
    A = A.view(batch, m, n)
    x = torch.randn((batch, n), generator=gen, device=device, dtype=dtype)
    c = -torch.bmm(A.mT, y[:, :, None])[:, :, 0]
    b = torch.bmm(A, x[:, :, None])[:, :, 0] + s
    lin = (c * x).sum(1).double()
    return {
        "data": {"A": A, "b": b, "c": c},
        "cone": K,
        "p_star": lin,
        "obj_scale": lin.abs(),
    }
