"""The port's Theorem 1 bound and concentration diagnostics against the
JAX package: the same numpy-seeded logits and points through
``repro.core.bounds`` and ``repro_torch.core.bounds``, within 1e-5
relative / 1e-6 absolute.  ``truncation_error`` takes the top k with
``lax.top_k``'s tie order (lowest index first), checked on tied logits."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import bounds as jbounds  # noqa: E402
from repro.core.schedules import make_schedule as jmake_schedule  # noqa: E402
from repro_torch.core import bounds as tbounds  # noqa: E402
from repro_torch.core import make_schedule  # noqa: E402
from repro_torch.data import synthetic as tsynth  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _problem(seed, n, d, sigma):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(3, d)).astype(np.float32)
    d2 = ((q[:, None] - x[None]) ** 2).sum(-1)
    return (-d2 / (2 * sigma ** 2)).astype(np.float32), x


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("seed,n,d,k,sigma", [
    (0, 4, 2, 1, 0.05), (1, 40, 3, 7, 0.5), (2, 128, 8, 50, 2.0),
    (3, 65, 4, 64, 20.0), (4, 100, 6, 100, 1.0), (5, 33, 5, 2, 0.2)])
def test_bounds_match(seed, n, d, k, sigma):
    lg, x = _problem(seed, n, d, sigma)
    jl, jx = jnp.asarray(lg), jnp.asarray(x)
    tl, tx = torch.from_numpy(lg), torch.from_numpy(x)
    radius = tbounds.data_radius(tx)
    np.testing.assert_allclose(radius, jbounds.data_radius(jx), rtol=RTOL)
    _close(tbounds.logit_gap(tl, k), jbounds.logit_gap(jl, k))
    _close(tbounds.theorem1_bound(tl, k, radius),
           jbounds.theorem1_bound(jl, k, radius))
    _close(tbounds.posterior_entropy(tl), jbounds.posterior_entropy(jl))
    _close(tbounds.participation_ratio(tl), jbounds.participation_ratio(jl))
    if k < n:
        err = tbounds.truncation_error(tl, tx, k)
        _close(err, jbounds.truncation_error(jl, jx, k))
        assert bool((err <= tbounds.theorem1_bound(tl, k, radius)
                     + 1e-5).all())


@pytest.mark.parametrize("k", [1, 3, 5])
def test_truncation_error_tie_order(k):
    """Tied logits: the reference keeps the lowest indices; so must the
    port, or the distinct values it averages differ."""
    lg = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 3.0, 2.0, 3.0],
                   [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    x = np.arange(16, dtype=np.float32).reshape(8, 2) ** 2
    want = jbounds.truncation_error(jnp.asarray(lg), jnp.asarray(x), k)
    got = tbounds.truncation_error(torch.from_numpy(lg), torch.from_numpy(x),
                                   k)
    _close(got, want)
    _close(tbounds.truncation_error(torch.from_numpy(lg[0]),
                                    torch.from_numpy(x), k),
           np.asarray(want)[0])


def test_bound_zero_when_k_covers_n():
    lg = torch.zeros(2, 5)
    assert torch.equal(tbounds.theorem1_bound(lg, 5, 3.0), torch.zeros(2))


def test_regime_asymptotics():
    """Delta_k -> 0 at high noise; large at low noise, where the bound is
    negligible although k << N."""
    x = tsynth.gmm(512, dim=8, seed=0, device="cpu").X
    q = x[:4] + 0.01
    d2 = ((q[:, None] - x[None]) ** 2).sum(-1)
    assert bool((tbounds.logit_gap(-d2 / (2 * 100.0 ** 2), 16) < 1e-2).all())
    assert bool((tbounds.logit_gap(-d2 / (2 * 0.05 ** 2), 16) > 10.0).all())
    bnd = tbounds.theorem1_bound(-d2 / (2 * 0.05 ** 2), 16,
                                 tbounds.data_radius(x))
    assert bool((bnd < 1e-3).all())


def test_posterior_progressive_concentration():
    """Fig. 1 / 3a: the participation ratio shrinks as t -> 0, with the
    port's ``add_noise`` and ``sigma`` (the reference's, checked here on
    the same noise)."""
    x = tsynth.gmm(1024, dim=8, seed=1, device="cpu").X
    sch, jsch = make_schedule("ddpm_linear", 1000), jmake_schedule(
        "ddpm_linear", 1000)
    rng = np.random.default_rng(0)
    x0 = x[:8]
    prs = []
    for t in [900, 600, 300, 100, 20]:
        eps = rng.normal(size=tuple(x0.shape)).astype(np.float32)
        xt = sch.add_noise(x0, torch.from_numpy(eps), t)
        np.testing.assert_allclose(
            xt.numpy(), np.asarray(jsch.add_noise(jnp.asarray(x0.numpy()),
                                                  jnp.asarray(eps), t)),
            rtol=1e-6, atol=1e-6)
        assert float(sch.sigma(t)) == float(jsch.sigma(t))
        q = xt / float(sch.a[t])
        d2 = ((q[:, None] - x[None]) ** 2).sum(-1)
        lg = -d2 / (2 * float(sch.sigma(t)) ** 2)
        prs.append(float(tbounds.participation_ratio(lg).mean()))
    assert prs[0] > 100.0 and prs[-1] < 10.0, prs
    assert all(prs[i] >= prs[i + 1] * 0.5 for i in range(len(prs) - 1)), prs
