"""The port's streaming softmax estimators against the JAX package.

The same numpy-seeded logits and values go through ``repro.core.streaming``
and ``repro_torch.core.streaming``; the two agree to fp32 reduction order
(1e-5 relative, 1e-6 absolute).  The properties the reference's own
``tests/test_streaming.py`` pins (chunk invariance, exact merges, the WSS
tail fold and its flattening bias) are pinned here on the port."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import streaming as jstream  # noqa: E402
from repro_torch.core import streaming as tstream  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _data(seed, lead, n, d, scale=5.0, batched_values=False):
    rng = np.random.default_rng(seed)
    lg = (scale * rng.normal(size=lead + (n,))).astype(np.float32)
    vshape = lead + (n, d) if batched_values else (n, d)
    vals = rng.normal(size=vshape).astype(np.float32)
    return lg, vals


def _close(got: torch.Tensor, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_neg_inf_is_the_kernels_constant():
    assert tstream.NEG_INF is tref.NEG_INF
    assert tstream.NEG_INF == jstream.NEG_INF


@pytest.mark.parametrize("n,d,chunk", [(17, 3, 4), (64, 8, 64), (100, 5, 7),
                                       (4096, 16, 512), (33, 2, 1),
                                       (50, 4, 4096)])
def test_streaming_softmax_mean_matches(n, d, chunk):
    lg, vals = _data(n + chunk, (2,), n, d)
    want = jstream.streaming_softmax_mean(jnp.asarray(lg), jnp.asarray(vals),
                                          chunk)
    got = tstream.streaming_softmax_mean(torch.from_numpy(lg),
                                         torch.from_numpy(vals), chunk)
    _close(got, want)
    _close(tstream.softmax_mean_reference(torch.from_numpy(lg),
                                          torch.from_numpy(vals)),
           jstream.softmax_mean_reference(jnp.asarray(lg), jnp.asarray(vals)))


@pytest.mark.parametrize("chunk", [1, 3, 10])
def test_streaming_masked_matches(chunk):
    lg, vals = _data(3, (3,), 10, 2)
    mask = np.arange(10)[None, :] < np.array([[6], [1], [10]])
    want = jstream.streaming_softmax_mean(jnp.asarray(lg), jnp.asarray(vals),
                                          chunk, mask=jnp.asarray(mask))
    got = tstream.streaming_softmax_mean(
        torch.from_numpy(lg), torch.from_numpy(vals), chunk,
        mask=torch.from_numpy(mask))
    _close(got, want)
    _close(got[0], tstream.softmax_mean_reference(
        torch.from_numpy(lg[0, :6]), torch.from_numpy(vals[:6])))
    _close(tstream.softmax_mean_reference(torch.from_numpy(lg),
                                          torch.from_numpy(vals),
                                          torch.from_numpy(mask)),
           jstream.softmax_mean_reference(jnp.asarray(lg), jnp.asarray(vals),
                                          jnp.asarray(mask)))


@pytest.mark.parametrize("seed", range(4))
def test_chunk_invariance(seed):
    """The online softmax is exact for any chunking (unbiasedness)."""
    n = 37 + 29 * seed
    lg, vals = _data(seed, (), n, 3, scale=10.0)
    lg_t, vals_t = torch.from_numpy(lg), torch.from_numpy(vals)
    outs = [tstream.streaming_softmax_mean(lg_t, vals_t, c)
            for c in (1, max(n // 3, 1), n)]
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("n1,n2", [(1, 1), (5, 60), (64, 3)])
def test_state_fold_and_merge_match(n1, n2):
    """init/update/merge/finalize step by step, with batched values
    [..., C, D] and a mask, against the reference's functions."""
    lg, vals = _data(n1 * 7 + n2, (2,), n1 + n2, 4, scale=8.0,
                     batched_values=True)
    mask = np.random.default_rng(n2).random((2, n1 + n2)) < 0.8
    mask[:, 0] = True

    def fold(mod, arr):
        s1 = mod.update_state(mod.init_state((2,), 4), arr(lg[:, :n1]),
                              arr(vals[:, :n1]), arr(mask[:, :n1]))
        s2 = mod.update_state(mod.init_state((2,), 4), arr(lg[:, n1:]),
                              arr(vals[:, n1:]), arr(mask[:, n1:]))
        return s1, mod.merge_states(s1, s2)

    (j1, jm), (t1, tm) = fold(jstream, jnp.asarray), fold(tstream,
                                                         torch.from_numpy)
    for a, b in zip(t1, j1):
        _close(a, b)
    for a, b in zip(tm, jm):
        _close(a, b)
    _close(tstream.finalize(tm), jstream.finalize(jm))
    want = tstream.softmax_mean_reference(
        torch.from_numpy(np.where(mask, lg, -1e30)[0]),
        torch.from_numpy(vals[0]))
    np.testing.assert_allclose(tstream.finalize(tm)[0].numpy(), want.numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,chunk", [(64, 32), (70, 32), (23, 8), (10, 32),
                                     (96, 96), (100, 7)])
def test_weighted_streaming_softmax_mean_matches(n, chunk):
    lg, vals = _data(n * chunk, (3,), n, 5, scale=3.0)
    want = jstream.weighted_streaming_softmax_mean(
        jnp.asarray(lg), jnp.asarray(vals), chunk)
    got = tstream.weighted_streaming_softmax_mean(
        torch.from_numpy(lg), torch.from_numpy(vals), chunk)
    _close(got, want)


@pytest.mark.parametrize("k,chunk", [(64, 64), (10, 4), (12, 4), (7, 3),
                                     (5, 64), (130, 64)])
def test_wss_combine_matches(k, chunk):
    lg, vals = _data(k + chunk, (2, 3), k, 3, scale=4.0,
                     batched_values=True)
    want = jstream.wss_combine(jnp.asarray(lg), jnp.asarray(vals), chunk)
    got = tstream.wss_combine(torch.from_numpy(lg), torch.from_numpy(vals),
                              chunk)
    _close(got, want)


def test_wss_tail_remainder_not_dropped():
    """A sharp mode that lives only in the ragged tail still counts."""
    n, d, chunk = 70, 3, 32
    lg = torch.zeros(n)
    lg[n - 1] = 15.0
    vals = torch.zeros(n, d)
    vals[n - 1] = 5.0
    assert float(tstream.weighted_streaming_softmax_mean(lg, vals, chunk)[0]) \
        > 1.0
    lg2 = torch.zeros(3, 10)
    lg2[:, -1] = 12.0
    v2 = torch.zeros(10, 2)
    v2[-1] = 3.0
    out = tstream.wss_combine(lg2, v2.expand(3, 10, 2), 4)
    assert bool((out[:, 0] > 0.5).all())


def test_wss_is_biased_flattening():
    """WSS drags a sharp posterior toward the other chunks' means."""
    n, d = 64, 3
    lg = torch.zeros(n)
    lg[5] = 12.0
    vals = torch.cat([torch.ones(32, d), -torch.ones(32, d)])
    exact = tstream.softmax_mean_reference(lg, vals)
    wss = tstream.weighted_streaming_softmax_mean(lg, vals, chunk=32)
    assert float(exact[0]) > 0.99
    assert float(wss[0]) < float(exact[0]) - 0.2
