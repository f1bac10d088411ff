"""The plain cone projections: Moreau's decomposition on random points of
every kind the configurations use (p in K, p - v in K*, the two
orthogonal, p a fixed point)."""

import pytest
import torch

from portbench import cones

KINDS = [
    {"l": 5},
    {"q": [1, 2, 5]},
    {"s": [1, 2, 3, 4]},
    {"ep": 40},
    {"ed": 40},
    {"p": [0.3, -0.3, 0.75, -0.5]},
    {"z": 2, "l": 3, "q": [3, 0, 1], "s": [2, 0, 1], "ep": 2, "ed": 2, "p": [-0.25, 0.5]},
]


@pytest.mark.parametrize("K", KINDS, ids=lambda K: "+".join(sorted(K)))
@pytest.mark.parametrize("scale", [0.1, 1.0, 30.0])
def test_moreau(K, scale):
    m = cones.cone_dims(K)
    v = scale * torch.randn((64, m), generator=torch.Generator().manual_seed(m), dtype=torch.float64)
    p = cones.proj_cone(v, K)
    d = p - v
    tol = 1e-9 * (1 + scale)
    assert torch.allclose(cones.proj_cone(p, K), p, atol=tol)
    assert torch.allclose(cones.proj_dual_cone(d, K), d, atol=tol)
    assert float((p * d).sum(1).abs().max()) < tol * (1 + scale)


def test_exp_cases():
    """Inside, polar, the r, s <= 0 quadrant, and the boundary root."""
    v = torch.tensor([[0.0, 1.0, 2.0], [1.0, -1.0, -5.0], [-1.0, -2.0, 3.0], [1.0, 1.0, 1.0]],
                     dtype=torch.float64)
    p = cones.proj_exp(v)
    assert torch.equal(p[0], v[0])
    assert torch.equal(p[2], torch.tensor([-1.0, 0.0, 3.0], dtype=torch.float64))
    assert bool(cones.in_exp_dual(-v[1:2]).all()) and torch.equal(p[1], torch.zeros(3, dtype=torch.float64))
    r, s, t = p[3]
    assert abs(float(s * torch.exp(r / s) - t)) < 1e-12


def test_exp_far_roots():
    """Roots far out on an open end (s or r near 0): no overflow, Moreau
    holds."""
    v = torch.tensor([[-1.4, 4.9e-4, -0.51], [1.4, -4.9e-4, 0.51], [0.0493, -1.9557, 1.3431],
                      [-1e-9, 1e-12, -2.0], [3.0, 1e-8, -1.0]], dtype=torch.float64)
    p = cones.proj_exp(v)
    d = p - v
    assert bool(torch.isfinite(p).all())
    assert torch.allclose(cones.proj_exp(p), p, atol=1e-12)
    assert torch.allclose(d + cones.proj_exp(-d), d, atol=1e-12)
    assert float((p * d).sum(1).abs().max()) < 1e-12


def test_exp_negligible_coordinate():
    """An r or s far below the other: the projection stays finite and is
    that of the point with the coordinate at 0, to rounding (the third row
    is where the dual cone's closure meets u = 0, as the distance of a y
    with u = 0 and w < 0 from K* asks)."""
    v = torch.tensor([[1e-300, -0.3626, 0.0104], [1.0, 1e-300, 2.0], [0.0, -0.3626, 0.0104],
                      [-1e-300, 2.0, -1.0]], dtype=torch.float64)
    p = cones.proj_exp(v)
    zeroed = cones.proj_exp(torch.where(v.abs() < 1e-200, 0.0, v))
    assert bool(torch.isfinite(p).all())
    assert torch.allclose(p, zeroed, rtol=0.0, atol=1e-15)
    assert torch.equal(p[2], torch.tensor([0.0, 0.0, 0.0104], dtype=torch.float64))
    d = p - v
    assert torch.allclose(cones.proj_exp(p), p, atol=1e-12)
    assert torch.allclose(d + cones.proj_exp(-d), d, atol=1e-12)


def test_pow_near_axes():
    """Points on the boundary of the dual power cone with one coordinate
    near 0 lie at distance ~0 from it (a minimisation over the boundary
    reads 1.1e-17 for the first; the oracle's clipped Newton iteration read
    3.7e-7), and a projection near the axes satisfies Moreau."""
    y = torch.tensor([[1.2104679719983544, 1.9200415424908155e-08, -0.023837553667000782]],
                     dtype=torch.float64)
    a = torch.tensor([0.75], dtype=torch.float64)
    assert float(torch.linalg.vector_norm(cones.proj_pow(-y, a))) < 1e-15
    g = torch.Generator().manual_seed(5)
    u = torch.rand(200, generator=g, dtype=torch.float64) + 0.1
    w = 10.0 ** (-12 * torch.rand(200, generator=g, dtype=torch.float64) - 2)
    a = torch.rand(200, generator=g, dtype=torch.float64) * 0.9 + 0.05
    z = (u / a) ** a * (w / (1 - a)) ** (1 - a) * (1 + 1e-6 * torch.randn(200, generator=g, dtype=torch.float64))
    v = -torch.stack([u, w, z], dim=-1)
    p = cones.proj_pow(v, a)
    d = p - v
    assert torch.allclose(cones.proj_pow(p, a), p, atol=1e-12)
    assert bool(cones.in_pow_dual(d, a).all())
    assert float((p * d).sum(1).abs().max()) < 1e-12


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        cones.proj_cone(torch.zeros((1, 4)), {"bu": [1.0], "bl": [0.0], "l": 2})
