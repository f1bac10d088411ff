"""Carry the JAX package's solver data across to the port.

`mats_from_numpy` and `state_from_numpy` turn scs_tpu's `Mats` (with its
`BellData`/`PBell`) and `State` into this package's, so both cores can
start from identical data. The input is any object with scs_tpu's field
names whose leaves are numpy arrays (or numbers) — e.g. a scs_tpu NamedTuple
after `jax.tree.map(np.asarray, ...)`; this module itself imports no JAX.

Field mapping for the single-problem core: vectors and float scalars
become tensors on `device`; iteration counters, statuses and the
averaging count become Python numbers (the port keeps its control flow on
the host). The operator comes across in whichever form scs_tpu holds it:
the block-ELL packs (bell) or the dense A and P (direct, indirect), whose
zero-size placeholders become None; the factor slot L is carried as it is.
The batched path's deferred-rescale record, which the single core has no
use for, is dropped.

The batched path: `mats_from_numpy` takes a batched Mats as it is (every
leaf keeps its leading B axis), and `batch_state_from_numpy` turns a
batched scs_tpu State into batch_core.State, where every leaf — the int32
counters, the bool rescale trigger and the deferred-rescale ratio
and the (B, n, n) factor slot L included — is a tensor with a leading B
axis.
"""

from __future__ import annotations

import numpy as np
import torch

from . import batch_core
from .solver import AAState, BellData, Diag, Mats, PBell, State


def _tensor(a, dtype, device):
    """A fresh tensor (a copy: the source may be a read-only view)."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.tensor(a, dtype=torch.bool, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.tensor(a, dtype=torch.int32, device=device)
    return torch.tensor(a, dtype=dtype, device=device)


def _dtype_of(a):
    return torch.float64 if np.asarray(a).dtype == np.float64 else torch.float32


def mats_from_numpy(mats, device="cpu", dtype=None) -> Mats:
    """scs_tpu Mats (numpy leaves, single or batched, any strategy) ->
    port Mats."""
    dtype = dtype or _dtype_of(mats.bn)

    def t(a):
        return _tensor(a, dtype, device)

    def dense(a):
        # scs_tpu marks an absent dense operand by a zero-size array
        return None if a is None or np.asarray(a).size == 0 else t(a).contiguous()

    bell = mats.bell
    pbell = mats.pbell
    return Mats(
        bn=t(mats.bn),
        cn=t(mats.cn),
        bl=t(mats.bl),
        bu=t(mats.bu),
        D=t(mats.D),
        E=t(mats.E),
        sc_b=t(mats.sc_b),
        sc_c=t(mats.sc_c),
        norm_b=t(mats.norm_b),
        norm_c=t(mats.norm_c),
        A=dense(mats.A),
        P=dense(mats.P),
        bell=None
        if bell is None
        else BellData(*(t(getattr(bell, f)) for f in BellData._fields)),
        pbell=None
        if pbell is None
        else PBell(*(t(getattr(pbell, f)) for f in PBell._fields)),
    )


_STATE_INTS = ("it", "status", "scale_updates", "since_rescale", "cg_iters")
_AA_INTS = (
    "count", "n_accept", "n_reject_nonfinite", "n_reject_weight_cap",
    "n_safeguard_reject", "aa_iter",
)


def state_from_numpy(state, device="cpu", dtype=None) -> State:
    """scs_tpu State (numpy leaves) -> port State."""
    dtype = dtype or _dtype_of(state.w)

    def t(a):
        return _tensor(a, dtype, device)

    aa = state.aa
    aa_kw = {
        f: int(getattr(aa, f)) if f in _AA_INTS else t(getattr(aa, f))
        for f in AAState._fields
    }
    kw = {}
    for f in State._fields:
        val = getattr(state, f)
        if f in _STATE_INTS:
            kw[f] = int(val)
        elif f == "avg_cnt":
            kw[f] = float(val)
        elif f == "diag":
            kw[f] = Diag(*(t(getattr(val, g)) for g in Diag._fields))
        elif f == "aa":
            kw[f] = AAState(**aa_kw)
        else:
            kw[f] = t(val)
    return State(**kw)


def batch_state_from_numpy(state, device="cpu", dtype=None) -> batch_core.State:
    """Batched scs_tpu State (numpy leaves with a leading B axis) ->
    batch_core.State."""
    dtype = dtype or _dtype_of(state.w)

    def t(a):
        return _tensor(a, dtype, device)

    kw = {}
    for f in batch_core.State._fields:
        val = getattr(state, f)
        if f == "diag":
            kw[f] = Diag(*(t(getattr(val, g)) for g in Diag._fields))
        elif f == "aa":
            kw[f] = batch_core.AAState(
                *(t(getattr(val, g)) for g in batch_core.AAState._fields)
            )
        else:
            kw[f] = t(val)
    return batch_core.State(**kw)
