"""Row-block-sharded conjugate gradient — the port of
scs_tpu/parallel/sharded_cg.py.

Layout: A is split by rows, (m_local, n) on each rank; x, rhs and P are
replicated. One CG step:

    q = A_local @ x                 # local rows (gemv_rows), no communication
    t = A_local.T @ (dy_local * q)  # local partial (n,) (gemv_cols) ...
    S x = rho_x x + P x + sum_ranks(t)   # ... summed over the ranks

so each CG iteration costs one gather of an (n,) vector a rank. The local
products are the dense path's kernels (G1/G2 on CUDA) on a (1, m_local, n)
view; no library matmul, so no TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.dense import gemv_cols, gemv_rows
from .comm import sum_ranks
from .mesh import mesh_layout, rank_device


def sharded_normal_matvec(A_local, P_mat, dy_local, rho_x, x, group):
    """S x with S = rho_x*I + P + A' diag(dy) A, A row-sharded over the
    ranks of `group` (this rank's rows A_local, their weights dy_local)."""
    q = gemv_rows(A_local, x)
    t = sum_ranks(gemv_cols(A_local, dy_local * q), group)
    out = rho_x * x + t
    if P_mat is not None:
        out = out + gemv_rows(P_mat, x)
    return out


def _tensor(a, device):
    """A tensor of a's dtype on device (a: numpy array or tensor)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.as_tensor(np.asarray(a), device=device)


def sharded_cg_solve(
    A,
    dy,
    rhs,
    mesh,
    *,
    P_mat=None,
    rho_x=1e-6,
    tol=1e-9,
    max_iters=500,
    axis_name="rows",
    device="cuda",
):
    """Solve (rho_x*I + P + A' diag(dy) A) x = rhs with A row-sharded over
    the mesh's ranks, by Jacobi-preconditioned CG from x = 0, while
    ||r|| > tol and fewer than max_iters iterations ran.

    A: (m, n) on the host or a device, the same on every rank; its rows (and
    dy's) are padded with zeros to a multiple of the mesh size, and only
    this rank's slice goes to its device: `device` "cuda" (the default) is
    cuda:{LOCAL_RANK}, "cpu" the CPU, "cuda:k" that card (`rank_device`,
    which raises where the card cannot be had). dy: (m,) row weights.
    rhs: (n,) replicated. Returns (x, n_iters), x on this rank's device, the
    same bits on every rank.
    """
    group, rank, n_dev = mesh_layout(mesh, axis_name)
    dev = rank_device(device, group)
    m, n = A.shape
    m_loc = -(-m // n_dev)
    lo, hi = rank * m_loc, min((rank + 1) * m_loc, m)
    A_local = _tensor(A[lo:hi], dev)
    dy_local = _tensor(dy[lo:hi], dev)
    pad = m_loc - A_local.shape[0]
    if pad:
        A_local = torch.cat([A_local, A_local.new_zeros((pad, n))])
        dy_local = torch.cat([dy_local, dy_local.new_zeros(pad)])
    A_local, dy_local = A_local.contiguous(), dy_local.contiguous()
    rhs = _tensor(rhs, dev)
    Pm = None if P_mat is None else _tensor(P_mat, dev).contiguous()

    def matvec(x):
        return sharded_normal_matvec(A_local, Pm, dy_local, rho_x, x, group)

    # Jacobi preconditioner: diag(S) = rho_x + diag(P) + sum_i dy_i A_i^2
    diag_local = (A_local * A_local * dy_local[:, None]).sum(0)
    diagS = rho_x + sum_ranks(diag_local, group)
    if Pm is not None:
        diagS = diagS + torch.diagonal(Pm)
    Minv = 1.0 / diagS

    x = torch.zeros_like(rhs)
    r = rhs - matvec(x)
    z = Minv * r
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < max_iters and bool(torch.linalg.vector_norm(r) > tol):
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv * r
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, k
