"""The generators: reproducible from the seed, and the planted point is an
optimum (the KKT conditions hold to rounding)."""

import json
import os

import pytest
import torch

from portbench import cones, registry, seeding


def _cfg(name):
    """The configuration's file (mixed_cone's has no cell yet)."""
    with open(os.path.join(registry.PKG, "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    if name == "dense_qp":
        cfg.update(m=24, n=16, cone={"l": 24})
    return cfg


@pytest.mark.parametrize("name", ["dense_qp", "mixed_cone"])
def test_same_seed_same_batch(name):
    cfg = _cfg(name)
    gen = registry.generator(cfg["generator"])
    a = gen.make(cfg, 3, seeding.entry_seed(2**31 + 11, 0), "cpu")
    b = gen.make(cfg, 3, seeding.entry_seed(2**31 + 11, 0), "cpu")
    c = gen.make(cfg, 3, seeding.entry_seed(2**31 + 11, 1), "cpu")
    for k in a["data"]:
        assert torch.equal(a["data"][k], b["data"][k])
        assert not torch.equal(a["data"][k], c["data"][k])
    assert torch.equal(a["p_star"], b["p_star"])


def test_entry_seed_takes_any_whole_number():
    seeds = {seeding.entry_seed(s, i) for s in (0, 1, 2**31 + 5, 2**40, -3) for i in (0, 1)}
    assert len(seeds) == 10
    assert all(0 <= s < 2**63 for s in seeds)


@pytest.mark.parametrize("name", ["dense_qp", "mixed_cone"])
def test_planted_point_is_optimal(name):
    """Rebuild (x, y, s) from the data as the recipe draws it and check the
    KKT conditions: the generator's p* is then the optimum."""
    cfg = _cfg(name)
    K = cfg["cone"]
    m, n = cones.cone_dims(K), int(cfg["n"])
    seed = seeding.entry_seed(7, 0)
    prob = registry.generator(cfg["generator"]).make(cfg, 2, seed, "cpu")
    d = prob["data"]
    assert d["A"].shape == (2, m, n) and d["A"].dtype == torch.float64
    g = torch.Generator().manual_seed(seed)
    if name == "dense_qp":
        k = max(n // 8, 1)
        torch.randn((2, m, n), generator=g, dtype=torch.float64)
        torch.randn((2, n, k), generator=g, dtype=torch.float64)
        z = torch.randn((2, m), generator=g, dtype=torch.float64)
        y, s = z.clamp_min(0), z.clamp_min(0) - z
        x = torch.randn((2, n), generator=g, dtype=torch.float64)
        P = d["P"]
        assert torch.allclose(P, P.mT) and bool((torch.linalg.eigvalsh(P) > 0).all())
        Px = (P @ x[..., None])[..., 0]
    else:
        z = torch.randn((2, m), generator=g, dtype=torch.float64)
        s = cones.proj_cone(-z, K)
        y = z + s
        torch.rand((2, m * n), generator=g)
        torch.randn((2, int(round(cfg["density"] * m * n))), generator=g, dtype=torch.float64)
        x = torch.randn((2, n), generator=g, dtype=torch.float64)
        Px = torch.zeros_like(x)
        nnz = (d["A"] != 0).sum((1, 2))
        assert bool((nnz == round(cfg["density"] * m * n)).all())
    A, b, c = d["A"], d["b"], d["c"]
    assert torch.allclose(b, (A @ x[..., None])[..., 0] + s, atol=1e-12)
    assert torch.allclose(c, -(A.mT @ y[..., None])[..., 0] - Px, atol=1e-12)
    # s in K, y in K*, complementary
    assert torch.allclose(cones.proj_cone(s, K), s, atol=1e-9)
    assert torch.allclose(cones.proj_dual_cone(y, K), y, atol=1e-9)
    assert float((s * y).sum(1).abs().max()) < 1e-9
    p = 0.5 * (x * Px).sum(1) + (c * x).sum(1)
    assert torch.allclose(prob["p_star"], p, rtol=1e-12, atol=1e-12)
