"""The hand-written CUDA kernels against their plain versions on the card.

Marked ``cuda``; every test takes the ``card`` fixture, which skips when
no CUDA device is present (decided at run time, never at import, so
all workers collect the same tests).  On the chip:

  PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
does not have.)

Integer-valued data keeps every fp32 sum exact: distances and the
selected sets are bit-equal.  Float data agrees to fp32 reduction
order: 1e-5 relative on distances, 1e-5 absolute on means of O(1) rows.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.core import (GoldDiff, OptimalDenoiser,  # noqa: E402
                              make_schedule, sample)
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.golden_aggregate import golden_aggregate  # noqa: E402
from repro_torch.kernels.golden_rerank import support_sqdist  # noqa: E402
from repro_torch.kernels.golden_support_aggregate import (  # noqa: E402
    golden_support_aggregate)
from repro_torch.kernels.pdist import pdist  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def ints(shape, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-3, 4, shape, generator=g).float().to(dev)


@pytest.mark.parametrize("b,n,d", [(16, 5000, 192), (5, 333, 7),
                                   (17, 64, 33)])
def test_pdist_bit_equal_integer(card, b, n, d):
    q, x = ints((b, d), card, 0), ints((n, d), card, 1)
    qn, xn = (q * q).sum(-1), (x * x).sum(-1)
    xn[3] = float("inf")
    got = pdist(q, x, qn, xn)
    assert torch.equal(got, ref.pdist_ref(q, x, qn, xn))
    assert torch.isinf(got[:, 3]).all()
    for m in (40, n + 5):
        gi, gv = ref.materialized_topm(got, m)
        wi, wv = ref.materialized_topm(ref.pdist_ref(q, x, qn, xn), m)
        assert torch.equal(gi, wi) and torch.equal(gv, wv)


@pytest.mark.parametrize("b,n,d,m", [(16, 4000, 3072, 700), (3, 100, 10, 37)])
def test_support_sqdist_bit_equal_integer(card, b, n, d, m):
    q, x = ints((b, d), card, 2), ints((n, d), card, 3)
    xn = (x * x).sum(-1)
    g = torch.Generator().manual_seed(4)
    idx = torch.randint(0, n, (b, m), generator=g).to(card)
    got = support_sqdist(q, x, xn, idx)
    assert torch.equal(got, ref.support_sqdist_ref(q, x, xn, idx))
    k = m // 3
    gi, gv = ops.golden_rerank(q, x, idx, k, xn)
    wd = ref.support_sqdist_ref(q, x, xn, idx)
    wv, wp = torch.sort(wd, dim=-1, stable=True)
    assert torch.equal(gi, torch.gather(idx, -1, wp[:, :k]))
    assert torch.equal(gv, wv[:, :k])


@pytest.mark.parametrize("b,n,d,k", [(16, 3000, 3072, 500), (3, 50, 10, 9)])
def test_golden_support_aggregate_matches(card, b, n, d, k):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(n, d, generator=g).to(card)
    idx = torch.randint(0, n, (b, k), generator=g).to(card)
    lg = (3 * torch.randn(b, k, generator=g)).to(card)
    lg[0, ::2] = ref.NEG_INF
    lg[1] = ref.NEG_INF
    got = golden_support_aggregate(x, idx, lg)
    want = ref.golden_support_aggregate_ref(x, idx, lg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], x[idx[1]].mean(0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,n,d", [(16, 5000, 3072), (3, 77, 10),
                                   (1, 40, 12288)])
@pytest.mark.parametrize("sigma2", [0.5, 20.0, 0.0])
def test_golden_aggregate_matches(card, b, n, d, sigma2):
    g = torch.Generator().manual_seed(6)
    x = (torch.randn(n, d, generator=g) / d ** 0.5).to(card)
    q = x[:b] + 0.1 * torch.randn(b, d, generator=g).to(card)
    xn = (x * x).sum(-1)
    got = golden_aggregate(q, x, sigma2, xn)
    want = ref.golden_aggregate_ref(q, x, sigma2, xn)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_trajectory_card_matches_cpu(card):
    """A 10-step GoldDiff trajectory on the card (kernels) against the
    same trajectory on the CPU (plain versions), same store and x_T."""
    cpu_store = make_dataset("cifar_like", n=1024, seed=0, device="cpu")
    sched = make_schedule("ddpm_linear", 1000)
    x_T = float(sched.b[1000]) * torch.randn(
        8, cpu_store.dim, generator=torch.Generator().manual_seed(0))
    outs = []
    for dev in ("cpu", card):
        gd = GoldDiff(OptimalDenoiser(cpu_store, sched, device=dev))
        outs.append(sample(gd, sched, tuple(x_T.shape), x_init=x_T).cpu())
    assert np.isfinite(outs[1].numpy()).all()
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-3, atol=1e-3)


def test_kernels_count_launches(card):
    q, x = ints((2, 8), card, 7), ints((9, 8), card, 8)
    before = pdist.launches
    ops.pdist(q, x)
    assert pdist.launches == before + 1
