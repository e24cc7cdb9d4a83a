"""The nine archs beside llama3.2-3b (the frontend, MoE and Mamba-2
families) against the JAX package (CPU tensors, plain versions).

The reference's ``tests/test_archs.py`` at reduced size, each held
against the reference's own result: configs field for field, parameter
counts at full size (specs only, nothing allocated), the loss, its
auxiliary term and every gradient leaf against ``jax.value_and_grad``,
one train step moving every leaf, prefill and decode logits and caches,
and golden against full decode.  jamba-v0.1-52b runs at
``reduced(num_layers=8)``, its whole pattern (the default 2-layer cut
has no attention layer: ``tests/test_torch_mamba.py``).  Parameters are the reference's own,
carried across with ``params_from_numpy``; token and embedding inputs
are drawn with numpy from a seed.  Tolerances, fp32: the loss 1e-5
absolute, each gradient leaf 1e-4 of its largest magnitude, logits 1e-4
and caches 1e-5 (fp32 sums in another order through two layers; a
Mamba arch's leaves, through up to 8 layers and the SSD's sums over 64
positions, 3e-5 of each leaf's max abs, ``STATE_TOL``); golden
against full decode 2e-2 (the reference's own bound).  The reference
runs jitted: one function an arch computes the loss, its gradients, the
prefill and a decode step, once for the whole file (``reference``).
"""
import dataclasses
import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import inputs as JI  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import inputs as I  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.module import (init_params, param_count,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.training import optimizer as O  # noqa: E402

NEW = ["qwen2.5-32b", "qwen2-7b", "phi3.5-moe-42b-a6.6b", "dbrx-132b",
       "internvl2-1b", "musicgen-medium", "starcoder2-3b", "mamba2-2.7b",
       "jamba-v0.1-52b"]
MAMBA = ("mamba2-2.7b", "jamba-v0.1-52b")
LOSS_TOL, GRAD_TOL, LOGIT_TOL, CACHE_TOL = 1e-5, 1e-4, 1e-4, 1e-5
STATE_TOL = 3e-5
B, S_LEN = 2, 64


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


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def rel_max(got, want) -> float:
    got, want = f32(got), f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def flat(tree) -> dict:
    return {"/".join(str(p.key) for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def ref_params(jcfg, seed=0):
    jp = JM.init_params(JT.model_specs(jcfg), jax.random.PRNGKey(seed))
    return jp, params_from_numpy(port_cfg(jcfg), np_tree(jp), device="cpu")


def shared_params(jcfg, seed=0):
    """(the reference's params, the numpy leaves): drawn with the port's
    ``init_params`` (fast on the CPU), the same values on both sides."""
    np_params = tree_map(lambda t: t.numpy(), init_params(
        T.model_specs(port_cfg(jcfg)), torch.Generator().manual_seed(seed)))
    return jax.tree.map(jnp.asarray, np_params), np_params


def batch_of(jcfg, b, s, seed, mask=False) -> dict:
    """s positions a sequence: a frontend arch's first F are embeddings
    (0.02 x normal), the rest tokens with next-token labels."""
    rng = np.random.default_rng(seed)
    f = jcfg.frontend_tokens if jcfg.frontend else 0
    toks = rng.integers(0, jcfg.vocab_size, (b, s - f + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if f:
        out["embeds"] = (0.02 * rng.standard_normal(
            (b, f, jcfg.d_model))).astype(np.float32)
    if mask:
        out["loss_mask"] = rng.random((b, s - f)) < 0.7
    return out


def torch_batch(batch) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def reduced(arch):
    """The parity config: jamba over its whole 8-layer pattern, a Mamba
    arch's SSD in chunks of 16 (four chunks of the 64 positions: the
    inter-chunk term and the state carry run)."""
    jcfg = jget_config(arch).reduced(
        num_layers=8 if arch == "jamba-v0.1-52b" else 2)
    return (dataclasses.replace(jcfg, ssm_chunk=16) if arch in MAMBA
            else jcfg)


# --- configs ----------------------------------------------------------------

def test_registry_lists_the_ported_archs_in_the_reference_order():
    assert ARCH_IDS == JARCH_IDS == [a for a in JARCH_IDS
                                     if a in NEW + ["llama3.2-3b"]]
    assert len(ARCH_IDS) == 10
    with pytest.raises(KeyError, match="unknown"):
        get_config("mamba2-1.3b")


@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.source and cfg.source == jcfg.source
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert cfg.param_dtype == torch.bfloat16


@pytest.mark.parametrize("arch", NEW)
def test_param_count_matches_reference(arch):
    """The full-size specs (nothing allocated): every leaf's path, shape
    and dtype, and the count."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    specs, jspecs = T.model_specs(cfg), JT.model_specs(jcfg)
    assert param_count(specs) == JM.param_count(jspecs)
    jleaves = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, JM.ParamSpec))[0]
    want = {"/".join(k.key for k in path): (tuple(s.shape),
                                             np.dtype(s.dtype).name)
            for path, s in jleaves}
    got = {p: (s.shape, str(s.dtype).removeprefix("torch."))
           for p, s in tree_leaves(specs)}
    assert got == want


# --- loss, gradients, train step, prefill and decode ---------------------

@functools.cache
def reference(arch) -> dict:
    """A reduced arch's shared weights and batch, and the reference's
    results on them from one jitted function: the loss, its metrics and
    gradients (``jax.value_and_grad``), the prefill's logits and cache,
    and a decode step of the last token at the last position from that
    cache (an MoE routes the B tokens as one group)."""
    jcfg = reduced(arch)
    jp, np_params = shared_params(jcfg)
    batch = batch_of(jcfg, B, S_LEN, 1)
    toks, emb = batch["tokens"], batch.get("embeds")

    def run(p):
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: JT.loss_fn(jcfg, q, batch), has_aux=True)(p)
        logits, cache = JT.prefill(jcfg, p, toks, emb)
        dec, _ = JT.decode_step(jcfg, p, cache, toks[:, -1],
                                jnp.int32(S_LEN - 1))
        return loss, metrics, grads, logits, cache, dec
    loss, metrics, grads, logits, cache, dec = jax.jit(run)(jp)
    return dict(jcfg=jcfg, jp=jp, np_params=np_params, batch=batch,
                loss=float(loss), metrics={k: float(v) for k, v in
                                           metrics.items()},
                grads=flat(np_tree(grads)), prefill=np.asarray(logits),
                cache=np_tree(cache), decode=np.asarray(dec))


def port_params(r) -> dict:
    """Fresh port params from a reference's shared weights (a train step
    updates its params in place)."""
    return params_from_numpy(port_cfg(r["jcfg"]), r["np_params"],
                             device="cpu")


@pytest.mark.parametrize("arch", NEW)
def test_loss_and_grads_match_reference(arch):
    r = reference(arch)
    jcfg, jm = r["jcfg"], r["metrics"]
    tp, cfg = port_params(r), port_cfg(jcfg)
    batch = torch_batch(r["batch"])
    loss, grads = S.make_loss_step(cfg)(tp, batch)
    tl, tm = T.loss_fn(cfg, tp, batch)
    assert float(loss) == float(tl)
    assert abs(float(tl) - r["loss"]) <= LOSS_TOL
    assert abs(float(tm["nll"]) - jm["nll"]) <= LOSS_TOL
    assert abs(float(tm["aux"]) - jm["aux"]) <= LOSS_TOL
    assert (jm["aux"] > 0) == bool(jcfg.num_experts)
    assert set(r["grads"]) == {p for p, _ in tree_leaves(grads)}
    for path, g in tree_leaves(grads):
        assert rel_max(g, r["grads"][path]) <= GRAD_TOL, path


@pytest.mark.parametrize("arch", NEW)
def test_train_step_moves_every_leaf(arch):
    """One AdamW step at the warmup's small rate: every leaf's bits move
    (the reference's ``test_smoke_train_step``), the metrics finite and
    the loss the loss function's."""
    r = reference(arch)
    tp, cfg = port_params(r), port_cfg(r["jcfg"])
    batch = torch_batch(batch_of(r["jcfg"], B, S_LEN, 3))
    want, wm = T.loss_fn(cfg, tp, batch)
    before = {p: t.clone() for p, t in tree_leaves(tp)}
    step = S.make_train_step(cfg, None, O.AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=100))
    params, state, m = step(tp, O.init_state(tp), batch)
    assert int(state.step) == 1
    assert float(m["loss"]) == float(want)
    assert float(m["aux"]) == float(wm["aux"])
    assert all(np.isfinite(float(v)) for v in m.values())
    moved = [p for p, t in tree_leaves(params)
             if not torch.equal(t, before[p])]
    assert len(moved) == len(before), set(before) - set(moved)


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and the whole cache (F + S positions with a
    frontend), then a decode step of the last token at the last position
    from each side's own cache (an MoE routes the B tokens as one
    group)."""
    r = reference(arch)
    jcfg, batch, want = r["jcfg"], r["batch"], r["cache"]
    tp, cfg = port_params(r), port_cfg(jcfg)
    lg, cache = S.make_prefill_step(cfg)(tp, torch_batch(
        {k: v for k, v in batch.items() if k != "labels"}))
    assert lg.shape == (B, jcfg.padded_vocab)
    assert T.attn_cache_len(cfg, cache) == (None if jcfg.pattern == ("M",)
                                            else S_LEN)
    close(lg, r["prefill"], LOGIT_TOL)
    assert set(cache) == set(want)
    for li, leaves in cache.items():
        for name, leaf in leaves.items():
            if arch in MAMBA:
                assert rel_max(leaf, want[li][name]) <= STATE_TOL, (li, name)
            else:
                close(leaf, want[li][name], CACHE_TOL)
    d, _ = S.make_decode_step(cfg)(
        tp, cache, torch.from_numpy(batch["tokens"][:, -1]).long(),
        S_LEN - 1)
    close(d, r["decode"], LOGIT_TOL)
    again = cache_from_numpy(cfg, want, device="cpu")
    assert {li: set(v) for li, v in again.items()} == \
        {li: set(v) for li, v in want.items()}


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "musicgen-medium",
                                  "jamba-v0.1-52b"])
def test_golden_matches_full_decode(arch):
    """The reference's ``test_smoke_golden_vs_full_decode``: 4 blocks of
    16 cover a 64-position cache of random keys and values (and random
    Mamba states), so golden decode equals full decode; each also against
    the reference's (jamba over 8 layers: its smoke config attends to
    nothing)."""
    r = reference(arch)
    jcfg, jp, tp = r["jcfg"], r["jp"], port_params(r)
    rng = np.random.default_rng(5)
    jcache = jax.tree.map(lambda x: (0.1 * rng.standard_normal(
        x.shape)).astype(np.float32), JT.zero_cache(jcfg, B, S_LEN))
    tok = np.zeros((B,), np.int32)
    out = {}
    for kind in ("full", "golden"):
        jk = dataclasses.replace(jcfg, attn_kind_decode=kind,
                                 golden_blocks=4, golden_block_size=16)
        jlg, _ = JT.decode_step(jk, jp, jcache, jnp.asarray(tok),
                                jnp.int32(S_LEN - 1))
        cache = cache_from_numpy(port_cfg(jk), jcache, device="cpu")
        out[kind], _ = T.decode_step(port_cfg(jk), tp, cache,
                                     torch.from_numpy(tok).long(), S_LEN - 1)
        close(out[kind], jlg, LOGIT_TOL)
    close(out["golden"], out["full"], 2e-2)


# --- the frontends --------------------------------------------------------------

@functools.cache
def embeds_reference() -> dict:
    """internvl2-1b reduced with a 500-token vocab: the reference's loss,
    metrics and gradients without and with a loss mask, from one jitted
    function."""
    jcfg = jget_config("internvl2-1b").reduced(vocab=500)
    jp, np_params = shared_params(jcfg)
    batches = [batch_of(jcfg, B, S_LEN, 6, mask=m) for m in (False, True)]

    def run(p):
        return [jax.value_and_grad(lambda q: JT.loss_fn(jcfg, q, bt),
                                   has_aux=True)(p) for bt in batches]
    out = jax.jit(run)(jp)
    return dict(jcfg=jcfg, np_params=np_params, batches=batches,
                results=[(float(jl), float(jm["nll"]), flat(np_tree(jg)))
                         for (jl, jm), jg in out])


@pytest.mark.parametrize("mask", [False, True], ids=["no_mask", "loss_mask"])
def test_loss_with_embeds_matches_reference(mask):
    """internvl2-1b reduced with a 500-token vocab (padded to 512: the
    -1e30 fill with embeddings present), with and without a loss mask;
    the frontend's positions (label 0) are never scored."""
    r = embeds_reference()
    jcfg = r["jcfg"]
    assert jcfg.padded_vocab == 512 and jcfg.frontend_tokens == 16
    tp = port_params(r)
    batch = r["batches"][mask]
    jl, jnll, jflat = r["results"][mask]
    cfg = port_cfg(jcfg)
    tb = torch_batch(batch)
    tl, tm = T.loss_fn(cfg, tp, tb)
    assert abs(float(tl) - jl) <= LOSS_TOL
    assert abs(float(tm["nll"]) - jnll) <= LOSS_TOL
    _, grads = S.make_loss_step(cfg)(tp, tb)
    for path, g in tree_leaves(grads):
        assert rel_max(g, jflat[path]) <= GRAD_TOL, path
    # the nll is the token positions' alone: another label at a frontend
    # position changes nothing
    logits, _, _ = T.forward_full(cfg, tp, T._with_embeds(
        T.embed_tokens(cfg, tp, tb["tokens"]), tb["embeds"]), mode="train")
    f = batch["embeds"].shape[1]
    lg = logits[:, f:].float().masked_fill(
        torch.arange(512) >= 500, -1e30)
    nll = torch.logsumexp(lg, -1) - torch.gather(
        lg, -1, tb["labels"][..., None].long())[..., 0]
    keep = tb["loss_mask"] if mask else torch.ones_like(nll, dtype=bool)
    want = float((nll * keep).sum() / keep.sum())
    assert abs(float(tm["nll"]) - want) <= LOSS_TOL


def test_prefill_with_embeds_bf16():
    """musicgen-medium reduced in bf16: the fp32 embeddings are cast to
    the model's dtype ahead of the tokens (equal argmax, 5e-2: bf16
    rounds at other places in the two frameworks)."""
    jcfg = dataclasses.replace(reduced("musicgen-medium"), dtype="bfloat16")
    jp, tp = ref_params(jcfg)
    batch = batch_of(jcfg, B, S_LEN, 7)
    jlg, _ = jax.jit(lambda t, e: JT.prefill(jcfg, jp, t, e))(
        batch["tokens"], batch["embeds"])
    lg, cache = T.prefill(port_cfg(jcfg), tp,
                          torch.from_numpy(batch["tokens"]).long(),
                          torch.from_numpy(batch["embeds"]))
    assert lg.dtype == cache["l0"]["k"].dtype == torch.bfloat16
    close(lg, jlg, 5e-2)
    assert np.array_equal(lg.float().argmax(-1).numpy(),
                          np.asarray(jlg, np.float32).argmax(-1))


def test_concrete_inputs_for_a_frontend():
    """Tokens [B, S - F] and embeds [B, F, d] fp32 (0.02 x normal) for
    train and prefill, as the reference's ``concrete_inputs``; the
    decode cache spans S."""
    jcfg = reduced("internvl2-1b")
    cfg = port_cfg(jcfg)
    f = jcfg.frontend_tokens
    for kind in ("train", "prefill"):
        shp = I.InputShape("t", kind, 64, 2)
        got = I.concrete_inputs(cfg, shp, device="cpu")
        want = JI.concrete_inputs(jcfg, JI.InputShape("t", kind, 64, 2))
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert got["tokens"].shape == (2, 64 - f)
        assert got["embeds"].dtype == torch.float32
        assert 0.01 < float(got["embeds"].std()) < 0.03
        if kind == "train":
            assert torch.equal(got["labels"], torch.roll(got["tokens"], -1,
                                                         1))
    dec = I.concrete_inputs(cfg, I.InputShape("d", "decode", 64, 2),
                            device="cpu")
    assert dec["cache"]["l0"]["k"].shape[3] == 64 and "embeds" not in dec


def test_train_a_frontend_arch_on_the_cpu():
    """``launch.train`` for internvl2-1b (--smoke): tokens cut to seq - F,
    step i's embeddings from ``Generator.manual_seed(1000 + i)``, the
    losses finite."""
    cfg = get_config("internvl2-1b").reduced()
    _, _, batches, _ = train_lib.setup(cfg, 3, 2, 64, torch.device("cpu"))
    f = cfg.frontend_tokens
    assert batches[0]["tokens"].shape == batches[0]["labels"].shape == \
        (2, 64 - f)
    b1 = train_lib.step_batch(cfg, batches, 1)
    want = 0.02 * torch.randn((2, f, cfg.d_model),
                              generator=torch.Generator().manual_seed(1001))
    assert torch.equal(b1["embeds"], want)
    assert torch.equal(b1["tokens"], batches[1]["tokens"])
    losses = train_lib.train("internvl2-1b", smoke=True, steps=3, batch=2,
                             seq=64, log_every=100, device="cpu")
    assert losses.shape == (3,) and np.isfinite(losses).all()
