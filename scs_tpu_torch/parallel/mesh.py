"""Scenario-batch sharding over the ranks of a process group — the port of
scs_tpu/parallel/mesh.py.

scs_tpu lays a batch of problems over a `jax.sharding.Mesh` and lets one
compiled program run them all. Here every rank is a process
(`torch.distributed`, one process a card): the mesh is a 1-D
`torch.distributed.device_mesh.DeviceMesh` over the ranks, each rank holds
and solves its contiguous slice of the batch, and the slices are gathered
at the end.
"""

from __future__ import annotations

import copy
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .comm import gather_rows


def make_mesh(n_devices=None, axis_name="batch"):
    """A 1-D DeviceMesh named `axis_name` over the first `n_devices` ranks of
    the default process group (all of them by default). Every rank of the
    group calls it. The mesh's device type is "cuda" under NCCL, else
    "cpu"; where a rank's tensors live is the solver's `device` setting."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: torch.distributed is not initialized; call "
            "dist.init_process_group (e.g. under torchrun) first"
        )
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: n_devices={n_devices} outside [1, {world}]")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, list(range(n)), mesh_dim_names=(axis_name,))


def mesh_layout(mesh, axis_name=None):
    """(group, this rank's index in the mesh, the mesh's size) of a 1-D
    mesh (whose axis is `axis_name`, where given); raises on a rank outside
    it."""
    if mesh.ndim != 1:
        raise ValueError("expected a 1-D mesh")
    if axis_name is not None and tuple(mesh.mesh_dim_names or ()) != (axis_name,):
        raise ValueError(f"the mesh's axis is {mesh.mesh_dim_names}, not {axis_name!r}")
    group = mesh.get_group()
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    return group, dist.get_rank(group), mesh.size()


def rank_device(device, group):
    """This rank's device: the CPU for "cpu"; for "cuda" with no index,
    cuda:{LOCAL_RANK} (the launcher's local rank, else the rank in the
    default group); "cuda:k" as given. Raises where the card cannot be had,
    and, under NCCL, where two ranks of `group` on one host share a card
    (NCCL refuses them). Nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} but PyTorch sees no CUDA device")
    index = dev.index
    if index is None:
        index = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(
            f"rank {dist.get_rank()} wants cuda:{index}, but this host has "
            f"{torch.cuda.device_count()} CUDA device(s)"
        )
    dev = torch.device("cuda", index)
    torch.cuda.set_device(dev)
    if dist.get_backend(group) == "nccl":
        seen = [None] * dist.get_world_size(group)
        dist.all_gather_object(seen, (socket.gethostname(), index), group=group)
        if len(set(seen)) != len(seen):
            raise RuntimeError(
                f"two NCCL ranks share a CUDA device ({seen}); NCCL takes one "
                f"rank a device: use the gloo backend to put several on one card"
            )
    return dev


def _tree_map(fn, tree):
    """fn applied to every tensor leaf of a NamedTuple tree (Mats, State);
    a None leaf stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_map(fn, a) for a in tree))
    return fn(tree)


def shard_batched_mats(mats, mesh, axis_name="batch", device=None):
    """This rank's contiguous slice of a batched Mats (leading batch axis on
    every leaf), on this rank's device, `rank_device(device)`. By default
    `device` follows the leaves: the batched solver that built `mats` has
    put them on the device its caller chose ("cuda", its default, or
    "cpu"), and "cuda" becomes cuda:{LOCAL_RANK} here. The batch must
    divide over the mesh, as a sharded jax array's must."""
    group, rank, n_dev = mesh_layout(mesh, axis_name)
    B = mats.bn.shape[0]
    if B % n_dev:
        raise ValueError(f"a batch of {B} does not divide over {n_dev} ranks")
    dev = rank_device(device or mats.bn.device.type, group)
    lo, hi = rank * (B // n_dev), (rank + 1) * (B // n_dev)
    return _tree_map(lambda a: a[lo:hi].to(dev).contiguous(), mats)


def sharded_batch_solve(core, mats, mesh, axis_name="batch", max_iters=None):
    """Solve a sharded batch: each rank runs its slice (from
    `shard_batched_mats`) to termination with the batched core's masked
    chunks — the adaptive rescale inside the chunk and no compaction, as
    scs_tpu's vmapped `_chunk` under its while_loop — and the final states
    are gathered along the batch axis, so every rank returns the states of
    the whole batch (batch_core.State, on this rank's device).

    A finished row stays frozen, so a rank whose rows are done waits for
    the others only at the final gather."""
    group, _, _ = mesh_layout(mesh, axis_name)
    max_iters = core.stg.max_iters if max_iters is None else int(max_iters)
    core = copy.copy(core)  # the caller's core keeps its own settings
    core.rescale_in_chunk = True
    core.device = mats.bn.device
    core.zero_mask = core.zero_mask.to(core.device)
    states = core.init_state(mats)
    while bool(core.live(states, max_iters).any()):
        states = core.masked_chunk(states, mats, max_iters)
    return _tree_map(lambda a: gather_rows(a, group), states)
