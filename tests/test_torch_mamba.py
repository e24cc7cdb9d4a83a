"""Mamba-2 (``repro_torch.models.mamba2``) and the two archs that run it,
mamba2-2.7b and jamba-v0.1-52b, against the JAX package (CPU tensors,
plain versions).

The chunked SSD runs at chunk 16 over S = 64 (four chunks: the
inter-chunk term and the state carry run), with and without an initial
state, and its gradients against ``jax.grad``; the conv, the gated norm,
the mixer and its decode step (conv and SSM states included) against the
reference's; the prefill handoff against the full forward; the decode
path's steps against eager steps; parameter and FLOP counts; the
reference's attention-free jamba smoke config.  Inputs are drawn with
numpy from a seed; the model's parameters are the port's draws carried
to the reference.  Tolerances, fp32: the SSD's y and final state 1e-5
of their max abs (measured <= 1e-6), its gradients,
the layer functions and the mixer 1e-5 of the max abs (gradients 1e-4,
``GRAD_TOL``), logits 1e-4 (``LOGIT_TOL``); bf16 SSD 1e-2 of the max abs
(one bf16 rounding of each chunk's y).
"""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed.hlo_analysis import \
    model_flops as jmodel_flops  # noqa: E402
from repro.launch import inputs as JI  # noqa: E402
from repro.models import mamba2 as JM2  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.hlo_analysis import model_flops  # noqa: E402
from repro_torch.launch import inputs as I  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.module import (ParamSpec, init_params,  # noqa: E402
                                       param_count, tree_leaves, tree_map)

ARCHS = ("mamba2-2.7b", "jamba-v0.1-52b")
SSD_TOL, LAYER_TOL, GRAD_TOL, LOGIT_TOL, BF16_TOL = 1e-5, 1e-5, 1e-4, 1e-4, 1e-2
B, S_LEN, CHUNK = 2, 64, 16


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this file runs (the suite runs several
    workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rel_max(got, want) -> float:
    got, want = f32(got), f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def reduced(arch: str, chunk: int = CHUNK):
    """The arch's parity config: jamba over 8 layers (its whole pattern:
    attention at layer 3, MoE on 1, 3, 5, 7; the default 2-layer cut has
    no attention), the SSD at ``chunk``."""
    jcfg = jget_config(arch).reduced(num_layers=8 if arch.startswith("jamba")
                                     else 2)
    return dataclasses.replace(jcfg, ssm_chunk=chunk)


def ssd_inputs(seed: int, h: int = 4, p: int = 8, n: int = 16,
               s: int = S_LEN) -> dict:
    """SSD operands with small steps (dt ~ softplus(N(-3, 1))), so the
    state carried across chunks still weighs at their end."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((B, s, h, p)).astype(f),
        dt=np.log1p(np.exp(rng.standard_normal((B, s, h)) - 3)).astype(f),
        a=-np.arange(1, h + 1).astype(f),
        b=rng.standard_normal((B, s, n)).astype(f),
        c=rng.standard_normal((B, s, n)).astype(f),
        d=rng.standard_normal(h).astype(f),
        state=rng.standard_normal((B, h, p, n)).astype(f))


ORDER = ("x", "dt", "a", "b", "c", "d")


# --- the SSD ------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("init", [False, True], ids=["zero_state",
                                                     "init_state"])
def test_ssd_chunked_matches_reference(chunk, init):
    """y and the final state within SSD_TOL of their max abs, at four
    chunks and at one; an initial state changes y (it is carried)."""
    v = ssd_inputs(0)
    st = v["state"] if init else None
    jy, js = JM2.ssd_chunked(*(jnp.asarray(v[k]) for k in ORDER), chunk,
                             None if st is None else jnp.asarray(st))
    y, s = M2.ssd_chunked(*(t(v[k]) for k in ORDER), chunk,
                          None if st is None else t(st))
    assert y.shape == (B, S_LEN, 4, 8) and s.shape == (B, 4, 8, 16)
    assert y.dtype == s.dtype == torch.float32
    assert rel_max(y, jy) <= SSD_TOL and rel_max(s, js) <= SSD_TOL
    if init:
        y0, _ = M2.ssd_chunked(*(t(v[k]) for k in ORDER), chunk)
        assert rel_max(y0, y) > 1e-3


def test_ssd_chunked_bf16_keeps_the_reference_dtypes():
    """bf16 x, B and C: y in bf16 (each chunk's y cast, the skip term
    cast before the add), the state fp32, both against the reference on
    the same bf16 inputs."""
    v = ssd_inputs(1)
    for k in ("x", "b", "c"):
        v[k] = np.asarray(jnp.asarray(v[k], jnp.bfloat16).astype(jnp.float32))
    jargs = [jnp.asarray(v[k], jnp.bfloat16 if k in "xbc" else jnp.float32)
             for k in ORDER]
    targs = [t(v[k]).to(torch.bfloat16 if k in "xbc" else torch.float32)
             for k in ORDER]
    jy, js = JM2.ssd_chunked(*jargs, CHUNK, jnp.asarray(v["state"]))
    y, s = M2.ssd_chunked(*targs, CHUNK, t(v["state"]))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert rel_max(y, jy) <= BF16_TOL
    assert rel_max(s, js) <= SSD_TOL


def test_ssd_chunk_must_divide_the_sequence():
    v = ssd_inputs(2, s=60)
    with pytest.raises(ValueError, match="not a multiple of the chunk 16"):
        M2.ssd_chunked(*(t(v[k]) for k in ORDER), CHUNK)
    with pytest.raises(AssertionError):
        JM2.ssd_chunked(*(jnp.asarray(v[k]) for k in ORDER), CHUNK)
    y, _ = M2.ssd_chunked(*(t(v[k]) for k in ORDER), 128)   # one chunk of 60
    assert y.shape[1] == 60


def test_ssd_gradients_match_jax_grad():
    """Every input's gradient (the initial state's too) of a loss on y
    and the final state, at four chunks, against ``jax.grad``: finite
    (the j > i entries are masked before the exponential) and within
    GRAD_TOL of each gradient's max abs."""
    v = ssd_inputs(3)
    names = ORDER + ("state",)

    def jloss(*args):
        y, s = JM2.ssd_chunked(*args[:6], CHUNK, args[6])
        return jnp.sum(y * y) + jnp.sum(jnp.sin(s))
    jg = jax.grad(jloss, argnums=tuple(range(7)))(
        *(jnp.asarray(v[k]) for k in names))
    ts = [t(v[k]).requires_grad_() for k in names]
    y, s = M2.ssd_chunked(*ts[:6], CHUNK, ts[6])
    ((y * y).sum() + torch.sin(s).sum()).backward()
    for name, tt, g in zip(names, ts, jg):
        assert bool(torch.isfinite(tt.grad).all()), name
        assert rel_max(tt.grad, g) <= GRAD_TOL, name


# --- the layer functions, the mixer and its decode step -----------------------

@functools.cache
def layer_params(arch: str) -> dict:
    """One Mamba layer's parameters of the reduced arch (numpy, fp32,
    the port's draws, with a_log, dt_bias, d_skip, norm_w and conv_b
    moved off their constant inits so each term weighs)."""
    cfg = port_cfg(reduced(arch))
    specs = M2.mamba_specs(T._mamba_dims(cfg), torch.float32)
    p = tree_map(lambda x: x.numpy(), init_params(
        specs, torch.Generator().manual_seed(4)))
    rng = np.random.default_rng(4)
    for k in ("a_log", "dt_bias", "d_skip", "norm_w", "conv_b"):
        p[k] = (p[k] + 0.3 * rng.standard_normal(p[k].shape)).astype(
            np.float32)
    return p


def test_arange_init_matches_reference():
    """``init="arange"``: log(1..n) over the last axis, broadcast over a
    stacked repeat axis, in the spec's dtype; the reference's a_log."""
    spec = ParamSpec((3, 5), ("layers", None), torch.float32, "arange",
                     stacked=True)
    got = init_params({"a_log": spec}, torch.Generator().manual_seed(0))
    want = JM._init_leaf(JM.ParamSpec((3, 5), (None, None), jnp.float32,
                                      "arange"), jax.random.PRNGKey(0))
    assert torch.equal(got["a_log"], t(want))
    assert torch.equal(got["a_log"][1], torch.log(torch.arange(1.0, 6.0)))
    cfg = port_cfg(reduced("mamba2-2.7b"))
    p = init_params(T.model_specs(cfg), torch.Generator().manual_seed(0))
    a_log = p["blocks"]["l0"]["mamba"]["a_log"]
    assert a_log.dtype == torch.float32 and a_log.shape == (2, 16)
    assert torch.equal(a_log[0], torch.log(torch.arange(1.0, 17.0)))
    with pytest.raises(ValueError, match="none of"):
        init_params({"w": ParamSpec((2,), (None,), init="uniform")},
                    torch.Generator().manual_seed(0))


def test_conv_and_gated_norm_match_reference():
    """``_causal_conv`` (depthwise, a left pad of W - 1, silu(out + b))
    and ``_gated_norm`` (the gate before the RMS norm) within LAYER_TOL;
    the conv is causal: a later position changes no earlier output."""
    p = layer_params("mamba2-2.7b")
    rng = np.random.default_rng(5)
    xbc = rng.standard_normal((B, S_LEN, p["conv_w"].shape[1])).astype(
        np.float32)
    got = M2._causal_conv(t(xbc), t(p["conv_w"]), t(p["conv_b"]))
    assert rel_max(got, JM2._causal_conv(xbc, p["conv_w"], p["conv_b"])) \
        <= LAYER_TOL
    later = xbc.copy()
    later[:, 40:] += 1.0
    moved = M2._causal_conv(t(later), t(p["conv_w"]), t(p["conv_b"]))
    assert torch.equal(moved[:, :40], got[:, :40])
    assert not torch.equal(moved[:, 40], got[:, 40])
    y, z = (rng.standard_normal((B, S_LEN, 512)).astype(np.float32)
            for _ in range(2))
    assert rel_max(M2._gated_norm(t(p["norm_w"]), t(y), t(z)),
                   JM2._gated_norm(p["norm_w"], y, z)) <= LAYER_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_apply_and_decode_step_match_reference(arch):
    """The reduced arch's Mamba layer at chunk 16: ``mamba_apply`` over
    S = 64 (and its prefill handoff into a cache: the last W - 1 pre-conv
    xBC rows, the final state), then ``mamba_decode_step`` from a random
    cache: y and the new conv and SSM states, the states written into
    the given cache views in place."""
    jcfg = reduced(arch)
    dims, jdims = T._mamba_dims(port_cfg(jcfg)), JT._mamba_dims(jcfg)
    p = layer_params(arch)
    tp = {k: t(v) for k, v in p.items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S_LEN, jcfg.d_model)).astype(np.float32)
    want = JM2.mamba_apply(p, x, jdims, CHUNK)
    cache = {"conv": torch.empty((B, 3, dims.conv_dim)),
             "ssm": torch.empty((B, dims.heads, dims.head_dim, dims.state))}
    got = M2.mamba_apply(tp, t(x), dims, CHUNK, cache)
    assert rel_max(got, want) <= LAYER_TOL
    _, xbc, dt = JM2._in_proj(p, x)
    assert rel_max(cache["conv"], xbc[:, -3:]) <= LAYER_TOL
    xc = JM2._causal_conv(xbc, p["conv_w"], p["conv_b"])
    _, jstate = JM2.ssd_chunked(
        xc[..., :dims.d_inner].reshape(B, S_LEN, dims.heads, dims.head_dim),
        jax.nn.softplus(dt + p["dt_bias"]), -jnp.exp(p["a_log"]),
        xc[..., dims.d_inner:dims.d_inner + dims.state],
        xc[..., dims.d_inner + dims.state:], p["d_skip"], CHUNK)
    assert rel_max(cache["ssm"], jstate) <= SSD_TOL

    x1 = rng.standard_normal((B, jcfg.d_model)).astype(np.float32)
    jc = {"conv": rng.standard_normal((B, 3, dims.conv_dim)).astype(
              np.float32),
          "ssm": rng.standard_normal(tuple(cache["ssm"].shape)).astype(
              np.float32)}
    jy, jnew = JM2.mamba_decode_step(p, x1, jc, jdims)
    views = {k: torch.zeros((2,) + v.shape) for k, v in jc.items()}
    c1 = {k: v[1] for k, v in views.items()}            # repeat 1's views
    for k in jc:
        c1[k].copy_(t(jc[k]))
    y1 = M2.mamba_decode_step(tp, t(x1), c1, dims)
    assert rel_max(y1, jy) <= LAYER_TOL
    for k in jc:
        assert rel_max(views[k][1], jnew[k]) <= LAYER_TOL, k
        assert not views[k][0].any(), k                 # repeat 0 untouched
    assert torch.equal(views["conv"][1][:, :2], t(jc["conv"][:, 1:]))


# --- the archs: handoff, decode path, counts ----------------------------------

@functools.cache
def arch_setup(arch: str):
    """(reference config and params, port config and params) of the
    reduced arch at chunk 16, the port's draws on both sides."""
    jcfg = reduced(arch)
    cfg = port_cfg(jcfg)
    np_params = tree_map(lambda x: x.numpy(), init_params(
        T.model_specs(cfg), torch.Generator().manual_seed(0)))
    return (jcfg, jax.tree.map(jnp.asarray, np_params), cfg,
            params_from_numpy(cfg, np_params, device="cpu"))


def grown(cfg, cache: dict, seq: int) -> dict:
    """A prefill's cache with every attention layer's K/V grown to
    ``seq`` positions (zeros after the prompt)."""
    out = T.zero_cache(cfg, B, seq, device="cpu")
    for li, leaves in cache.items():
        for name, leaf in leaves.items():
            out[li][name][tuple(slice(0, n) for n in leaf.shape)].copy_(
                leaf)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_handoff_continues_the_forward(arch):
    """Prefill 32 tokens (two chunks; an MoE group is 64 tokens), then
    decode the next 16 one at a time from the handed-off cache: each
    step's logits equal the reference's full forward over all 64 at that
    position (LOGIT_TOL), and the prefill's last logits its position
    31."""
    jcfg, jp, cfg, tp = arch_setup(arch)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (B, S_LEN),
                                              dtype=np.int32)
    want = jax.jit(lambda p: JT.forward_full(
        jcfg, p, JT.embed_tokens(jcfg, p, toks), mode="prefill")[0])(jp)
    want = np.asarray(want, np.float32)
    tt = t(toks).long()
    lg, cache = T.prefill(cfg, tp, tt[:, :32])
    assert float((lg - t(want[:, 31])).abs().max()) <= LOGIT_TOL
    cache = grown(cfg, cache, S_LEN)
    for pos in range(32, 48):
        lg, _ = T.decode_step(cfg, tp, cache, tt[:, pos], pos)
        assert float((lg - t(want[:, pos])).abs().max()) <= LOGIT_TOL, pos


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_path_steps_equal_eager_steps(arch):
    """``make_decode_step`` (on the CPU its eager path; on the card one
    CUDA graph, held by ``chip_smoke.py``) over 4 tokens against 4
    ``decode_step`` calls from a copy of the same cache: logits and
    every cache leaf bit-equal, the states advanced once a step."""
    jcfg, _, cfg, tp = arch_setup(arch)
    toks = t(np.random.default_rng(9).integers(
        0, jcfg.vocab_size, (B, 48), dtype=np.int32)).long()
    _, cache = T.prefill(cfg, tp, toks[:, :32])
    cache = grown(cfg, cache, 48)
    eager = tree_map(torch.clone, cache)
    start = tree_map(torch.clone, cache)
    step = S.make_decode_step(cfg)
    for pos in range(32, 36):
        got, _ = step(tp, cache, toks[:, pos], pos)
        want, _ = T.decode_step(cfg, tp, eager, toks[:, pos], pos)
        assert torch.equal(got, want), pos
    for (path, a), (_, b) in zip(tree_leaves(cache), tree_leaves(eager)):
        assert torch.equal(a, b), path
    ssm = next(leaf for path, leaf in tree_leaves(cache)
               if path.endswith("ssm"))
    assert not torch.equal(ssm, next(
        leaf for path, leaf in tree_leaves(start) if path.endswith("ssm")))


def test_decode_position_bounds():
    """Without attention (mamba2-2.7b) a position has no upper bound, as
    in the reference; with attention it must lie in the first attention
    layer's cache; negative positions raise."""
    _, _, cfg, tp = arch_setup("mamba2-2.7b")
    cache = T.zero_cache(cfg, B, 8, device="cpu")
    assert T.attn_cache_len(cfg, cache) is None
    tok = torch.zeros((B,), dtype=torch.long)
    lg, _ = T.decode_step(cfg, tp, cache, tok, 10_000)
    assert bool(torch.isfinite(lg).all())
    with pytest.raises(ValueError, match="outside"):
        T.decode_step(cfg, tp, cache, tok, -1)
    _, _, hcfg, htp = arch_setup("jamba-v0.1-52b")
    hc = T.zero_cache(hcfg, B, 16, device="cpu")
    assert T.attn_cache_len(hcfg, hc) == 16 and "k" not in hc["l0"]
    with pytest.raises(ValueError, match="outside"):
        T.decode_step(hcfg, htp, hc, tok, 16)


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_convert_and_match_reference_specs(arch):
    """``cache_specs`` against the reference's (conv in the param dtype,
    ssm fp32; mamba2-2.7b at full size), ``cache_from_numpy`` on the
    reference's cache (B from any leaf, S from the first attention
    layer), and ``concrete_inputs``' decode cache against the
    reference's."""
    full = get_config(arch)
    got = {p: (tuple(s), tuple(ax), str(d).removeprefix("torch."))
           for p, (s, ax, d) in tree_leaves(T.cache_specs(full, 2, 256))}
    jspec = JT.cache_specs(jget_config(arch), 2, 256)
    want = {"/".join(k.key for k in path): (tuple(leaf[0]), tuple(leaf[1]),
                                             np.dtype(leaf[2]).name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                jspec, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 3
                and isinstance(x[0], tuple))[0]}
    assert got == want
    jcfg, _, cfg, _ = arch_setup(arch)
    rng = np.random.default_rng(10)
    jc = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32), JT.zero_cache(jcfg, 3, 32))
    tc = cache_from_numpy(cfg, jc, device="cpu")
    for path, leaf in tree_leaves(tc):
        li, name = path.split("/")
        assert np.array_equal(f32(leaf), jc[li][name]), path
    shape = I.InputShape("d", "decode", 32, 2)
    dec = I.concrete_inputs(cfg, shape, device="cpu")
    jdec = JI.concrete_inputs(jcfg, JI.InputShape("d", "decode", 32, 2))
    assert {p: tuple(v.shape) for p, v in tree_leaves(dec["cache"])} == \
        {"/".join(k.key for k in path): tuple(v.shape) for path, v in
         jax.tree_util.tree_flatten_with_path(jdec["cache"])[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_model_flops_match_reference(arch):
    """Full-size counts (specs only): 2.83 B and 51.49 B parameters, one
    8-layer jamba period 13.27 B; ``model_flops`` at the four shapes."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    n = param_count(T.model_specs(cfg))
    assert n == JM.param_count(JT.model_specs(jcfg))
    assert round(n / 1e9, 2) == {"mamba2-2.7b": 2.83,
                                 "jamba-v0.1-52b": 51.49}[arch]
    if arch.startswith("jamba"):
        period = dataclasses.replace(cfg, num_layers=8)
        assert round(param_count(T.model_specs(period)) / 1e9, 2) == 13.27
    for shape in I.SHAPES.values():
        assert model_flops(cfg, shape) == jmodel_flops(
            jcfg, JI.SHAPES[shape.name])


def test_reference_jamba_smoke_config_is_attention_free():
    """A fault of the reference, pinned: ``reduced()`` keeps the first
    two layers of jamba's pattern, ("M", "M"), so its smoke config (and
    ``tests/test_archs.py``'s golden-vs-full decode of it) holds no
    attention layer.  The port's parity config keeps the whole period:
    attention at layer 3, MoE on 1, 3, 5, 7."""
    smoke = jget_config("jamba-v0.1-52b").reduced()
    assert smoke.pattern == ("M", "M") and smoke.num_layers == 2
    assert not any(p.key == "attn" for path, _ in
                   jax.tree_util.tree_flatten_with_path(
                       JT.model_specs(smoke),
                       is_leaf=lambda x: isinstance(x, JM.ParamSpec))[0]
                   for p in path)
    assert [smoke.mlp_kind(i) for i in range(2)] == ["dense", "moe"]
    full = reduced("jamba-v0.1-52b")
    assert [i for i in range(8) if full.mixer_kind(i) == "A"] == [3]
    assert [i for i in range(8) if full.mlp_kind(i) == "moe"] == [1, 3, 5, 7]
    assert T.attn_cache_len(port_cfg(smoke), T.zero_cache(
        port_cfg(smoke), 1, 16, device="cpu")) is None


@pytest.mark.parametrize("arch", ARCHS)
def test_train_both_archs_on_the_cpu(arch):
    """``launch.train`` (--smoke: the reference's 2-layer cut) for 3
    steps on the CPU: finite losses; the setup's batches are the token
    pipeline's (no frontend)."""
    losses = train_lib.train(arch, smoke=True, steps=3, batch=2, seq=32,
                             log_every=100, device="cpu")
    assert losses.shape == (3,) and np.isfinite(losses).all()
