"""The MoE layer (``models.moe``) against the JAX package (CPU tensors).

``moe_apply``'s output and auxiliary loss against the reference's on the
same inputs (fp32 1e-5; bf16 activations 2e-2: bf16 products rounded at
other places), and its routing against the reference's own: the expert
choices (the reference's ``lax.top_k`` result) and the kept slots (its
dispatch tensor), read out of a jitted reference call by wrapping
``jax.lax.top_k`` and ``jnp.einsum`` while it is traced.  Cases: capacity
overflow over several groups, router probabilities tied on
integer-valued inputs (ties go to the lowest expert), bf16 activations
and decode's single group of B tokens.  Then the MoE in the model:
routing recomputed under remat equal bit for bit to the forward's, the
specs and ``params_from_numpy`` over the MoE leaves.  The port's routing
is read the same way, by wrapping ``moe.route``: its expert choices and
the kept ones, from the dispatch tensor it returns.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.module import init_params, tree_leaves  # noqa: E402
from repro_torch.models.transformer import model_specs  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def ref_routing(monkeypatch, p, x, e, k, cf, group):
    """The reference's moe_apply, jitted, with its expert choices [G, T,
    k] and kept (group, token, expert) triples [G, T, E] read out of its
    ``lax.top_k`` and its dispatch einsum while it is traced, and
    returned beside its result."""
    seen = {}
    top_k, einsum = jax.lax.top_k, jnp.einsum

    def spy_top_k(a, kk):
        out = top_k(a, kk)
        seen["experts"] = out[1]
        return out

    def spy_einsum(spec, *ops, **kw):
        if spec == "gtec,gtd->gecd":
            seen["dispatch"] = ops[0]
        return einsum(spec, *ops, **kw)

    def run(p, x):
        y, aux = JMoE.moe_apply(p, x, e, k, cf, group)
        return y, aux, seen["experts"], seen["dispatch"]
    monkeypatch.setattr(jax.lax, "top_k", spy_top_k)
    monkeypatch.setattr(jnp, "einsum", spy_einsum)
    y, aux, experts, dispatch = jax.jit(run)(p, x)
    monkeypatch.undo()
    return np.asarray(y, np.float32), float(aux), {
        "experts": np.asarray(experts), "cap": dispatch.shape[-1],
        "kept": np.asarray(dispatch, np.float32).sum(-1) > 0}


def port_routing(monkeypatch) -> list:
    """Wrap the port's ``moe.route``: each call appends ``{"experts":
    [G, T, k], "keep": [G, T, k] bool (False where the choice was
    dropped for capacity), "cap"}``, the kept choices read from the
    dispatch tensor it returns."""
    seen, route = [], moe.route

    def spy(p, xg, e, k, cap):
        out = route(p, xg, e, k, cap)
        idx, dispatch = out[1], out[2]
        seen.append({"experts": idx.detach(), "cap": cap,
                     "keep": torch.gather(dispatch.detach().sum(-1) != 0,
                                          -1, idx)})
        return out
    monkeypatch.setattr(moe, "route", spy)
    return seen


def port_kept(route, e) -> np.ndarray:
    """[G, T, E]: the experts a token's kept choices go to."""
    hit = torch.nn.functional.one_hot(route["experts"], e).bool() \
        & route["keep"][..., None]
    return hit.any(2).numpy()


def draw(case, rng, d, f, e):
    """(params, x) as numpy fp32 arrays for a case."""
    b, s = {"overflow": (2, 96), "ties": (2, 32), "bf16": (2, 64),
            "decode": (6, 1)}[case]
    p = {"router": 0.3 * rng.standard_normal((d, e)),
         "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    x = rng.standard_normal((b, s, d))
    if case == "ties":
        # integer inputs, router columns pairwise equal: every token's
        # probabilities tie in pairs, so its top-2 is a tied pair
        x = rng.integers(-2, 3, (b, s, d)).astype(np.float64)
        p["router"] = np.repeat(rng.integers(-1, 2, (d, e // 2)), 2, axis=1)
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


@pytest.mark.parametrize("case,e,k,cf,group", [
    ("overflow", 8, 2, 0.5, 64),     # 3 groups, half the slots needed
    ("ties", 4, 2, 1.25, 64),
    ("bf16", 8, 2, 1.0, 32),
    ("decode", 8, 2, 1.25, 512)])    # one group of B = 6 tokens, cap 2
def test_moe_apply_matches_reference(monkeypatch, case, e, k, cf, group):
    rng = np.random.default_rng(["overflow", "ties", "bf16",
                                 "decode"].index(case))
    d, f = 32, 48
    p, x = draw(case, rng, d, f, e)
    dt = "bfloat16" if case == "bf16" else "float32"
    jp = {n: jnp.asarray(v) if n == "router" else
          jnp.asarray(v).astype(dt) for n, v in p.items()}
    tp = {n: torch.from_numpy(v) if n == "router" else
          torch.from_numpy(v).to(getattr(torch, dt)) for n, v in p.items()}
    jx = jnp.asarray(x).astype(dt)
    tx = torch.from_numpy(x).to(getattr(torch, dt))
    jy, jaux, seen = ref_routing(monkeypatch, jp, jx, e, k, cf, group)
    rec = port_routing(monkeypatch)
    y, aux = moe.moe_apply(tp, tx, e, k, cf, group)
    assert y.dtype == tx.dtype and len(rec) == 1
    route = rec[0]
    assert route["cap"] == seen["cap"] == moe.capacity(
        min(group, x.shape[0] * x.shape[1]), e, k, cf)
    assert np.array_equal(route["experts"].numpy(), seen["experts"])
    assert np.array_equal(port_kept(route, e), seen["kept"])
    dropped = int((~route["keep"]).sum())
    if case == "overflow":
        assert dropped > 0.3 * route["keep"].numel()
    if case == "ties":      # each tie goes to the lower (even) expert first
        assert (route["experts"][..., 0] % 2 == 0).all()
        assert (route["experts"][..., 1] == route["experts"][..., 0] + 1).all()
    np.testing.assert_allclose(y.float().numpy(), jy, rtol=TOL[dt],
                               atol=TOL[dt])
    assert abs(float(aux) - jaux) <= 1e-5


def test_moe_group_must_divide_the_tokens():
    p = {n: torch.from_numpy(v) for n, v in draw(
        "overflow", np.random.default_rng(0), 8, 8, 4)[0].items()}
    with pytest.raises(ValueError, match="not a multiple"):
        moe.moe_apply(p, torch.zeros((3, 100, 8)), 4, 2, 1.25, 64)


def test_moe_specs_match_reference():
    got = moe.moe_specs(64, 96, 4, torch.bfloat16)
    want = JMoE.moe_specs(64, 96, 4, jnp.bfloat16)
    for name, spec in got.items():
        assert spec.shape == want[name].shape
        assert spec.scale == want[name].scale and spec.init == want[name].init
        assert str(spec.dtype).removeprefix("torch.") == \
            np.dtype(want[name].dtype).name


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "dbrx-132b"])
def test_remat_recomputes_the_same_routing(monkeypatch, arch):
    """Under remat the backward runs each layer's forward again: its
    routing equals the forward's bit for bit, and the loss and every
    gradient equal those without remat."""
    jcfg = jget_config(arch).reduced()
    cfg = port_cfg(jcfg)
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, jcfg.vocab_size, (2, 65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = {}
    for remat in (False, True):
        rec = port_routing(monkeypatch)
        out[remat] = S.make_loss_step(dataclasses.replace(
            cfg, remat=remat))(params, batch)
        monkeypatch.undo()
        n = cfg.num_layers
        assert len(rec) == n * (2 if remat else 1)
        if remat:                      # forward first, then the backward's
            for a, b in zip(rec[:n], rec[n:][::-1]):
                assert torch.equal(a["experts"], b["experts"])
                assert torch.equal(a["keep"], b["keep"])
    assert torch.equal(out[False][0], out[True][0])
    for (p, a), (_, b) in zip(tree_leaves(out[False][1]),
                              tree_leaves(out[True][1])):
        assert torch.equal(a, b), p


def test_convert_covers_the_moe_leaves():
    """``params_from_numpy`` takes the reference's MoE leaves (fp32
    router, bf16 experts) bit for bit, refuses a missing one, and
    ``cache_from_numpy`` an MoE model's cache."""
    jcfg = dataclasses.replace(jget_config("dbrx-132b").reduced(),
                               dtype="bfloat16")
    cfg = port_cfg(jcfg)
    jp = jax.tree.map(np.asarray, JM.init_params(JT.model_specs(jcfg),
                                                 jax.random.PRNGKey(3)))
    tp = params_from_numpy(cfg, jp, device="cpu")
    got = tp["blocks"]["l0"]["moe"]
    assert got["router"].dtype == torch.float32
    assert got["w_gate"].dtype == torch.bfloat16
    assert got["w_gate"].shape == (cfg.repeats, cfg.num_experts, cfg.d_model,
                                   cfg.d_ff)
    for name, leaf in got.items():
        assert np.array_equal(leaf.float().numpy(), np.asarray(
            jp["blocks"]["l0"]["moe"][name], np.float32)), name
    bad = jax.tree.map(lambda a: a, jp)
    del bad["blocks"]["l0"]["moe"]["w_up"]
    with pytest.raises(ValueError, match="missing leaves"):
        params_from_numpy(cfg, bad, device="cpu")
    jcache = jax.tree.map(np.asarray, JT.zero_cache(jcfg, 2, 32))
    cache = cache_from_numpy(cfg, jcache, device="cpu")
    assert cache["l0"]["k"].shape == (cfg.repeats, 2, cfg.num_kv_heads, 32,
                                      cfg.hdim)
