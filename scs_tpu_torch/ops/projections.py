"""Cone projections, on tensors.

The port of scs_tpu/ops/projections.py for the cones the bell slice runs:
the zero cone ("z") and the nonnegative orthant ("l"). The projector
factory keeps scs_tpu's signature, proj(z, bl=None, bu=None), and its
Moreau dual. Every other cone kind raises NotImplementedError naming the
ROADMAP.md item that ports it.

The projectors act on the last axis: a (m,) slack vector, or a (B, m)
batch of them (the batched path), projected row by row.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..cones import ConeSpec

# cone kind -> the ROADMAP.md Queue 1 item that ports its projection
_NOT_PORTED = {
    "box": "Queue 1 item 4 (box cone projection)",
    "q": "Queue 1 item 12 (curved cones: second-order)",
    "s": "Queue 1 item 12 (curved cones: PSD)",
    "cs": "Queue 1 item 12 (curved cones: complex PSD)",
    "ep": "Queue 1 item 12 (curved cones: exponential)",
    "ed": "Queue 1 item 12 (curved cones: dual exponential)",
    "p": "Queue 1 item 12 (curved cones: power)",
    "d": "Queue 1 item 12 (curved cones: spectral logdet)",
    "nuc": "Queue 1 item 12 (curved cones: spectral nuclear norm)",
    "ell1": "Queue 1 item 12 (curved cones: spectral ell1)",
    "sl": "Queue 1 item 12 (curved cones: spectral sum-of-largest)",
}


def _proj_nonneg(x):
    return torch.clamp_min(x, 0.0)


def make_cone_projector(spec: ConeSpec, dtype=torch.float64) -> Callable:
    """Build Pi_K for the full concatenated slack vector (last axis m).

    Returns proj(z, bl=None, bu=None). The zero and nonnegative segments
    are contiguous ranges of the last axis (ConeSpec.segments), so the
    projector works on slices; bl/bu (box bounds) are accepted for
    signature parity.
    """
    plans = []
    for sg in spec.segments():
        if sg.kind not in ("z", "l"):
            raise NotImplementedError(
                f"cone kind {sg.kind!r} is not ported to scs_tpu_torch yet: "
                f"ROADMAP.md {_NOT_PORTED.get(sg.kind, 'Queue 1')}"
            )
        plans.append((sg.kind, sg.offset, sg.offset + sg.length))

    def proj(z, bl=None, bu=None):
        parts = []
        for kind, lo, hi in plans:
            if kind == "z":
                parts.append(torch.zeros_like(z[..., lo:hi]))
            else:
                parts.append(_proj_nonneg(z[..., lo:hi]))
        return torch.cat(parts, dim=-1) if parts else z.clone()

    return proj


def make_dual_cone_projector(spec: ConeSpec, dtype=torch.float64) -> Callable:
    """Pi_K*(z) = z + Pi_K(-z) (Moreau; gen_random_cone_prob.py:82-83)."""
    proj = make_cone_projector(spec, dtype)

    def proj_dual(z, bl=None, bu=None):
        return z + proj(-z, bl, bu)

    return proj_dual


# Bounded LRU: cap projector growth in long-running processes sweeping
# many cone structures.
_PROJECTOR_CACHE = {}
_PROJECTOR_CACHE_MAX = 64


def spec_signature(spec: ConeSpec):
    """Static structure key for a ConeSpec (box bounds enter dynamically)."""
    return (
        spec.z,
        spec.l,
        len(spec.bu),
        spec.q,
        spec.s,
        spec.cs,
        spec.ep,
        spec.ed,
        spec.p,
        spec.d,
        spec.nuc,
        spec.ell1,
        spec.sl,
    )


def get_projector(spec: ConeSpec, dtype=torch.float64) -> Callable:
    """Cached projector keyed by cone structure (shared across instances)."""
    key = (spec_signature(spec), str(dtype))
    if key in _PROJECTOR_CACHE:
        _PROJECTOR_CACHE[key] = _PROJECTOR_CACHE.pop(key)  # refresh LRU
    else:
        while len(_PROJECTOR_CACHE) >= _PROJECTOR_CACHE_MAX:
            _PROJECTOR_CACHE.pop(next(iter(_PROJECTOR_CACHE)))
        _PROJECTOR_CACHE[key] = make_cone_projector(spec, dtype)
    return _PROJECTOR_CACHE[key]
