"""Dense random QPs over the nonnegative cone with a planted optimum.

The recipe of the port's bench generator (`gen_batch_device`), drawn on
the device from a seeded torch.Generator in the configuration's dtype, in a
few large calls: A = N(0, 1) / sqrt(m); P = 0.1 / k G G' + 1e-4 I with G
(n, k), k = n / 8; y = max(z, 0), s = y - z for a normal z; a normal x;
c = -A'y - P x, b = A x + s. Then (x, y, s) satisfies the KKT conditions,
so p* = x'P x / 2 + c'x is each problem's optimum.
"""

from __future__ import annotations

import math

import torch


def make(cfg, batch, seed, device):
    """{"data": {"A", "P", "b", "c"}, "cone", "p_star", "obj_scale"}: the
    (B, ...) tensors on `device`, the cone dict, and each problem's optimum
    and the larger of its two objective terms (float64)."""
    m, n = int(cfg["m"]), int(cfg["n"])
    dtype = getattr(torch, cfg["dtype"])
    k = max(n // 8, 1)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    A = normal(batch, m, n).mul_(1.0 / math.sqrt(m))
    G = normal(batch, n, k)
    P = torch.bmm(G, G.mT).mul_(0.1 / k)
    del G
    P.diagonal(dim1=1, dim2=2).add_(1e-4)
    z = normal(batch, m)
    y = z.clamp_min(0.0)
    s = y - z
    x = normal(batch, n)
    Px = torch.bmm(P, x[:, :, None])[:, :, 0]
    c = -torch.bmm(A.mT, y[:, :, None])[:, :, 0] - Px
    b = torch.bmm(A, x[:, :, None])[:, :, 0] + s
    quad = 0.5 * (x * Px).sum(1).double()
    lin = (c * x).sum(1).double()
    return {
        "data": {"A": A, "P": P, "b": b, "c": c},
        "cone": {"l": m},
        "p_star": quad + lin,
        "obj_scale": torch.maximum(quad.abs(), lin.abs()),
    }
