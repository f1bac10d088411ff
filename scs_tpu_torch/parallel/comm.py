"""The collectives of the sharded paths — the counterpart of `lax.psum` and
`lax.all_gather(..., tiled=True)` in scs_tpu/parallel, over a
`torch.distributed` process group.

Every rank of a sharded solve runs the same host loop on replicated
vectors, and every host decision (the CG stop test, the AA trial's accept
test, termination, the adaptive scale) reads a replicated value on each rank
by itself. A rank that read one differing bit would leave a loop while the
others wait in a collective: a deadlock. So a sum over ranks is never left to
the backend's reduction, whose order (a ring, a tree) need not give every
rank the same bits: `sum_ranks` gathers the partials and adds them on each
rank in rank order, rank 0 first. Every rank then holds the same bits, and a
repeated solve repeats its iteration counts.

The list form of `dist.all_gather` is used throughout: it runs under gloo
(CPU and CUDA tensors) and NCCL alike, where `all_gather_into_tensor` is
deprecated.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def gather_list(t, group):
    """Every rank's `t` (same shape on every rank), in rank order: one
    all_gather, counted in `gather_list.calls`."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    gather_list.calls += 1
    return parts


gather_list.calls = 0  # all_gathers since the last reset


def gather_rows(t, group):
    """The ranks' tensors concatenated along the first axis in rank order
    (`lax.all_gather(t, axis, tiled=True)`). Every rank passes the same
    shape."""
    return torch.cat(gather_list(t, group))


def sum_ranks(t, group, acc_dtype=None):
    """The sum of the ranks' tensors (`lax.psum`), the same bits on every
    rank: the partials are gathered and added in rank order, rank 0 first,
    in `acc_dtype` (t's dtype unless given) and rounded once to t's dtype."""
    parts = gather_list(t, group)
    acc = acc_dtype or t.dtype
    out = parts[0].to(acc, copy=True)
    for p in parts[1:]:
        out += p.to(acc)
    return out.to(t.dtype)


def sum_and_gather_rows(s, g, group):
    """(sum_ranks(s), gather_rows(g)) in one collective: each rank's s and g
    travel as one tensor; the s parts are added in rank order, rank 0
    first, and the g parts concatenated — the bits of the two calls."""
    k = s.shape[0]
    parts = gather_list(torch.cat([s, g]), group)
    total = parts[0][:k].clone()
    for p in parts[1:]:
        total += p[:k]
    return total, torch.cat([p[k:] for p in parts])


def _flag_device(group):
    """Where a host decision travels: NCCL takes only CUDA tensors."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def rank0_decides(flag, group):
    """Rank 0's value of the host decision `flag`, on every rank (one
    one-element broadcast). For decisions taken from a rank's own clock —
    the time limit, whether to run the phase timers — which would differ
    between ranks and split them between a loop and a collective."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_flag_device(group))
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return bool(t.item())
