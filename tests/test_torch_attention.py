"""The port's attention ops (kernels 8 and 9) against the JAX package's
Pallas kernels in interpret mode (CPU tensors, plain versions).

``ops.flash_attention`` is held against ``repro.kernels.ops`` on its
``pallas_interpret`` backend over the shapes of
``tests/test_flash_kernel.py``, causal and full; golden block-sparse
decode attention the same way at G in {1, 3} with some blocks invalid.
Tolerances are the reference's own: fp32 2e-5 for flash and 1e-5 for
golden attention (fp32 reduction order), bf16 5e-2 (one rounding of the
output, and bf16 rounds at other places in the two frameworks).

Where the reference's two golden paths differ (a (b, h) with no valid
block: the Pallas kernel gives 0, the dense oracle the mean of V), the
port follows the kernel; the test pins that the oracle differs there
only.  ``select_golden_blocks`` must give the reference's indices,
``lax.top_k``'s order on tied integer keys included.  The CUDA
wrappers' pure-Python choices are checked here too: the bf16 flash
kernel's head/warpgroup plan and the golden kernel's chunk split.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.golden_attention import (  # noqa: E402
    select_golden_blocks as jselect)
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import golden_attention as gattn_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

BACKEND = "pallas_interpret"
TOL = {("flash", "float32"): 2e-5, ("golden", "float32"): 1e-5,
       ("flash", "bfloat16"): 5e-2, ("golden", "bfloat16"): 5e-2}


def pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    return j, torch.from_numpy(np.array(j, np.float32)).to(
        getattr(torch, dtype))


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,hkv,g,s,dh,qc,kc", [
    (1, 1, 1, 64, 32, 32, 32),
    (2, 2, 3, 128, 64, 32, 64),
    (1, 4, 5, 256, 64, 64, 128),   # GQA, uneven tiles over the diagonal
    (2, 1, 2, 96, 32, 32, 48),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(b, hkv, g, s, dh, qc, kc, causal,
                                        dtype):
    rng = np.random.default_rng(0)
    jq, q = pair(rng.standard_normal((b, hkv, g, s, dh)), dtype)
    jk, k = pair(rng.standard_normal((b, hkv, s, dh)), dtype)
    jv, v = pair(rng.standard_normal((b, hkv, s, dh)), dtype)
    want = jops.flash_attention(jq, jk, jv, causal=causal, qc=qc, kc=kc,
                                backend=BACKEND)
    got = ops.flash_attention(q, k, v, causal=causal, qc=qc, kc=kc)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = TOL["flash", dtype]
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


def test_flash_attention_refuses_what_the_reference_refuses():
    q = torch.zeros((1, 1, 1, 96, 32))
    k = torch.zeros((1, 1, 96, 32))
    with pytest.raises(ValueError, match="tile evenly"):
        ops.flash_attention(q, k, k, qc=64)
    with pytest.raises(ValueError, match="tile evenly"):
        ops.flash_attention(q, k, k, qc=32, kc=64)
    assert ops.flash_attention(q, k, k, qc=512, kc=48).shape == q.shape


def golden_inputs(g, dtype, seed=1, b=2, hkv=2, dh=32, s=256, bs=32, kb=4):
    rng = np.random.default_rng(seed)
    jq, q = pair(rng.standard_normal((b, hkv, g, dh)), dtype)
    jk, k = pair(rng.standard_normal((b, hkv, s, dh)), dtype)
    jv, v = pair(rng.standard_normal((b, hkv, s, dh)), dtype)
    idx = rng.integers(-2, s // bs + 2, (b, hkv, kb)).astype(np.int32)
    valid = (rng.random((b, hkv, kb)) < 0.7).astype(np.int32)
    valid[0, 0, 0] = 1
    return (jq, jk, jv), (q, k, v), idx, valid, bs


@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_golden_attention_matches_pallas(g, dtype):
    js, ts, idx, valid, bs = golden_inputs(g, dtype)
    assert 0 < valid.sum() < valid.size            # some blocks skipped
    want = jops.golden_attention_decode(*js, idx, valid, block_size=bs,
                                        backend=BACKEND)
    got = ops.golden_attention_decode(*ts, torch.from_numpy(idx),
                                      torch.from_numpy(valid), block_size=bs)
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    tol = TOL["golden", dtype]
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


def test_golden_attention_with_no_valid_block_gives_zero():
    js, ts, idx, valid, bs = golden_inputs(3, "float32", seed=2)
    valid[1, 0] = 0                                  # (b=1, h=0): none
    want = jops.golden_attention_decode(*js, idx, valid, block_size=bs,
                                        backend=BACKEND)
    got = ops.golden_attention_decode(*ts, torch.from_numpy(idx),
                                      torch.from_numpy(valid), block_size=bs)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-5, atol=1e-5)
    assert not got[1, 0].any()
    oracle = as_np(jref.golden_attention_decode_ref(*js, idx, valid, bs))
    diff = np.abs(oracle - as_np(got)).max(axis=(2, 3))
    assert diff[1, 0] > 1e-2                         # the mean of V there
    diff[1, 0] = 0.0
    assert diff.max() <= 1e-5                        # and equal elsewhere
    plain = ref.golden_attention_decode_ref(*ts, torch.from_numpy(idx),
                                            torch.from_numpy(valid), bs)
    assert torch.equal(plain, got)


def test_golden_attention_refuses_unaligned_cache():
    q, k = torch.zeros((1, 1, 1, 32)), torch.zeros((1, 1, 100, 32))
    idx = torch.zeros((1, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="block-aligned"):
        ops.golden_attention_decode(q, k, k, idx, idx, block_size=32)


@pytest.mark.parametrize("g,num_blocks", [(1, 3), (2, 5), (4, 64)])
def test_select_golden_blocks_ties_match_reference(g, num_blocks):
    rng = np.random.default_rng(3)
    b, hkv, dh, s, bs = 2, 3, 8, 256, 16
    q = rng.integers(-2, 3, (b, hkv, g, dh)).astype(np.float32)
    k = rng.integers(-1, 2, (b, hkv, s, dh)).astype(np.float32)
    k[:, :, :4 * bs] = k[:, :, 4 * bs:8 * bs]        # tied whole blocks
    k[0, 0] = 0.0                                    # every score tied
    want_idx, want_valid = jselect(jnp.asarray(q), jnp.asarray(k),
                                   num_blocks, bs)
    got_idx, got_valid = ops.select_golden_blocks(
        torch.from_numpy(q), torch.from_numpy(k), num_blocks, bs)
    assert got_idx.dtype == torch.int32 and got_valid.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got_idx[0, 0].numpy(),
                                  np.arange(min(num_blocks, s // bs)))


@pytest.mark.parametrize("g", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("s", [64, 96, 130, 4096])
def test_flash_sm90_rows_cover_every_head_and_position_once(g, s):
    """The bf16 kernel's plan: W = min(G, 3) warpgroups a CTA, one head
    each; the rows of all CTAs are every (head, position) exactly once,
    the last query tile (the longest causal rows) first."""
    w, groups = flash_mod.sm90_plan(g)
    assert w == min(g, 3) and groups * w >= g > (groups - 1) * w
    bq = flash_mod.SM90_BQ
    nq = -(-s // bq)
    rows = [(hg * w + wg, (nq - 1 - z) * bq + r)         # the kernel's grid
            for z in range(nq) for hg in range(groups) for wg in range(w)
            for r in range(bq)
            if hg * w + wg < g and (nq - 1 - z) * bq + r < s]
    assert len(rows) == len(set(rows)) == g * s
    assert set(rows) == {(h, p) for h in range(g) for p in range(s)}
    assert rows[0][1] == (s - 1) // 64 * 64


@pytest.mark.parametrize("bh,kb", [(128, 64), (16, 8), (1, 1), (2, 66),
                                   (32, 64), (200, 3), (5, 0), (1000, 300)])
def test_golden_split_chunks(bh, kb):
    """Every selected block in exactly one non-empty chunk, and at least
    one CTA an SM whenever B * Hkv * kb >= 132."""
    sms = 132                                        # an H100's SMs
    c, nch = gattn_mod.split_chunks(bh, kb, sms)
    chunks = [range(i * c, min(kb, (i + 1) * c)) for i in range(nch)]
    assert sorted(j for ch in chunks for j in ch) == list(range(kb))
    assert kb == 0 or all(len(ch) > 0 for ch in chunks)
    if bh * kb >= sms:
        assert bh * nch >= sms
    if bh * kb <= gattn_mod.CTAS_PER_SM * sms:
        assert c == 1
