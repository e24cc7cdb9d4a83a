"""The port's reduced-LLM substrate against the JAX package (CPU tensors,
plain versions).

The parameters are the reference's own, drawn by ``init_params`` and
carried across with ``params_from_numpy`` (the port cannot redraw
``jax.random``'s weights).  Configs are small and have G >= 2 query
heads per KV head, so a wrong GQA head order shows.  Tolerances, fp32:
layers 1e-5 (2e-5 for attention, the reference's own), prefill and
decode logits 1e-4 and the KV cache 1e-5 (fp32 reduction order through
the layers); bf16: equal argmax and logits within 5e-2 (bf16 rounds at
other places in the two frameworks); the golden-decode sweep's KL column
within 1e-4.  Golden block choices must be equal.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import golden_decode as gd  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.convert import (cache_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.models.module import (init_params,  # noqa: E402
                                       param_count, tree_leaves)

TINY = JModelConfig(name="tiny", arch_type="dense", num_layers=3, d_model=64,
                    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=300,
                    rope_theta=5e5, attn_kind_decode="golden",
                    golden_blocks=2, golden_block_size=8, dtype="float32",
                    tie_embeddings=True, remat=False)
LOGIT_TOL, CACHE_TOL, LAYER_TOL, ATTN_TOL = 1e-4, 1e-5, 1e-5, 2e-5


def port_cfg(jcfg: JModelConfig) -> ModelConfig:
    return ModelConfig(**dataclasses.asdict(jcfg))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def ref_params(jcfg, seed=0):
    jp = JM.init_params(JT.model_specs(jcfg), jax.random.PRNGKey(seed))
    return jp, params_from_numpy(port_cfg(jcfg), np_tree(jp), device="cpu")


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(
        got, torch.Tensor) else got, np.float32), np.asarray(
        want, np.float32), rtol=tol, atol=tol)


def ref_spec_shapes(jcfg) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        JT.model_specs(jcfg), is_leaf=lambda x: isinstance(x, JM.ParamSpec))[0]
    return {"/".join(k.key for k in path): tuple(s.shape)
            for path, s in leaves}


# --- configs, specs, parameters ---------------------------------------------

def test_llama_config_is_the_reference_copy():
    cfg, jcfg = get_config("llama3.2-3b"), jget_config("llama3.2-3b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_dtype == torch.bfloat16
    assert (cfg.hdim, cfg.padded_vocab, cfg.repeats) == (128, 128512, 28)
    assert dataclasses.asdict(cfg.reduced(num_layers=4, vocab=1024)) == \
        dataclasses.asdict(jcfg.reduced(num_layers=4, vocab=1024))
    assert list_archs() == ["qwen2.5-32b", "mamba2-2.7b", "qwen2-7b",
                            "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b",
                            "llama3.2-3b", "dbrx-132b", "internvl2-1b",
                            "musicgen-medium", "starcoder2-3b"]
    with pytest.raises(KeyError, match="llama3.2-3b"):
        get_config("llama3.2-1b")


@pytest.mark.parametrize("jcfg", [
    TINY, dataclasses.replace(TINY, tie_embeddings=False, qkv_bias=True),
    jget_config("llama3.2-3b"),
    jget_config("llama3.2-3b").reduced(num_layers=4, vocab=1024)],
    ids=["tiny", "untied-bias", "llama3.2-3b", "llama-reduced"])
def test_specs_match_reference(jcfg):
    specs = T.model_specs(port_cfg(jcfg))
    assert {p: tuple(s.shape) for p, s in tree_leaves(specs)} == \
        ref_spec_shapes(jcfg)
    assert param_count(specs) == JM.param_count(JT.model_specs(jcfg))


def test_init_law():
    cfg = port_cfg(dataclasses.replace(TINY, tie_embeddings=False))
    p = init_params(T.model_specs(cfg), torch.Generator().manual_seed(0))
    again = init_params(T.model_specs(cfg), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_leaves(p), tree_leaves(again)))
    assert p["blocks"]["l0"]["attn"]["wq"].shape == (3, 64, 64)
    for leaf, std in ((p["embed"], 0.02), (p["lm_head"], 0.02),
                      (p["blocks"]["l0"]["attn"]["wq"], 64 ** -0.5),
                      (p["blocks"]["l0"]["mlp"]["w_down"], 128 ** -0.5)):
        assert abs(float(leaf.std()) / std - 1) < 0.1
    assert torch.equal(p["final_norm"], torch.ones(64))
    assert torch.equal(p["blocks"]["l0"]["ln1"], torch.ones(3, 64))


def test_convert_refuses_bad_trees():
    jp = np_tree(JM.init_params(JT.model_specs(TINY), jax.random.PRNGKey(0)))
    cfg = port_cfg(TINY)
    bad = dict(jp, lm_head=np.zeros((64, 512), np.float32))
    with pytest.raises(ValueError, match="extra leaves"):
        params_from_numpy(cfg, bad, device="cpu")
    bad = {k: v for k, v in jp.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing leaves"):
        params_from_numpy(cfg, bad, device="cpu")
    bad = dict(jp, final_norm=np.ones(63, np.float32))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(cfg, bad, device="cpu")


def test_unported_paths_raise(tmp_path):
    """What stays refused over ranks, on a one-rank gloo ``ProcessMesh``:
    ``ServeRuntime.hot_swap`` (a sharded engine does not hot-swap, as in
    the reference) and the masked step over a patch base (static mode
    only).  The LLM's multi-card path runs: ``train(use_mesh=True)``
    asks for the production mesh's 256 ranks and names the world it
    found."""
    import datetime

    import torch.distributed as dist

    from repro_torch.core import GoldDiff, make_denoiser, make_schedule
    from repro_torch.data.synthetic import image_store
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.runtime import ServeRuntime
    from repro_torch.launch.serve import ServeEngine
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        pm = make_process_mesh(device="cpu")
        srv = ServeEngine("gmm", {"n": 64, "dim": 8}, num_steps=2,
                          max_batch=2, mesh=pm)
        with pytest.raises(ValueError, match="ServeRuntime.hot_swap over a "
                                             "ProcessMesh"):
            ServeRuntime(srv).hot_swap(srv.store)
        img = image_store(16, 8, 8, 3, device="cpu")
        gd = GoldDiff(make_denoiser("kamb", img, make_schedule(
            "ddpm_linear"), device="cpu"), mesh=pm)
        with pytest.raises(ValueError, match="the masked step needs the "
                                             "Optimal base"):
            gd.call_masked(torch.zeros(1, 192), 500)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        train("llama3.2-3b", smoke=True, steps=1, batch=1, seq=8,
              ckpt_dir=None, use_mesh=True, device="cpu")


# --- layers ---------------------------------------------------------------

def test_rmsnorm_rope_qkv_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    close(L.rmsnorm(torch.from_numpy(w), torch.from_numpy(x)),
          JL.rmsnorm(w, x), LAYER_TOL)
    xh = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = np.arange(4095 - 15, 4096)[None].astype(np.int32)
    close(L.rope(torch.from_numpy(xh), torch.from_numpy(pos), 5e5),
          JL.rope(xh, pos, 5e5), LAYER_TOL)
    _, p = ref_params(dataclasses.replace(TINY, qkv_bias=True))
    jp = {k: np.asarray(v[1].float()) for k, v in
          p["blocks"]["l0"]["attn"].items()}
    jp["bq"] = rng.standard_normal(jp["bq"].shape).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    dims, jdims = L.AttnDims(4, 2, 16), JL.AttnDims(4, 2, 16)
    pos = np.arange(16)[None]
    for got, want in zip(
            L.qkv_proj(tp, torch.from_numpy(x), dims, torch.from_numpy(pos),
                       5e5),
            JL.qkv_proj(jp, x, jdims, pos, 5e5)):
        close(got, want, LAYER_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_layer_flash_attention_matches_reference(causal):
    rng = np.random.default_rng(1)
    b, s, h, hkv, dh = 2, 128, 6, 2, 32
    q = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)),
                              JL.AttnDims(h, hkv, dh), causal=causal,
                              q_chunk=32, kv_chunk=64)
    got = L.flash_attention(*map(torch.from_numpy, (q, k, v)),
                            L.AttnDims(h, hkv, dh), causal=causal,
                            q_chunk=32, kv_chunk=64)
    close(got, want, ATTN_TOL)
    with pytest.raises(ValueError, match="tile evenly"):
        L.flash_attention(*map(torch.from_numpy, (q, k, v)),
                          L.AttnDims(h, hkv, dh), q_chunk=48)


def ref_golden_idx(q, summ, mask, kb, bs):
    """The reference's golden block choice (layers.py:234-241)."""
    b, nb = mask.shape[0], summ.shape[2]
    lm = jnp.asarray(mask).reshape(b, nb, bs)
    scores = jnp.einsum("bhd,bhnd->bhn", jnp.asarray(q).mean(2),
                        jnp.asarray(summ, jnp.float32))
    scores = jnp.where(jnp.any(lm, -1)[:, None, :], scores, JL.NEG_INF)
    return np.asarray(jax.lax.top_k(scores, min(kb, nb))[1])


@pytest.mark.parametrize("live", [64, 40, 9])
def test_decode_partials_match_reference(live):
    rng = np.random.default_rng(2)
    b, hkv, g, dh, s, bs = 2, 2, 3, 16, 64, 8
    q = rng.standard_normal((b, hkv, g, dh)).astype(np.float32)
    k = rng.integers(-2, 3, (b, hkv, s, dh)).astype(np.float32)  # ties
    v = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    mask = np.broadcast_to(np.arange(s)[None] < live, (b, s))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v, mask)]
    for got, want in zip(L.decode_attention_local(*t),
                         JL.decode_attention_local(q, k, v, mask)):
        close(got, want, LAYER_TOL)
    summ = L.block_summaries(t[1], t[3], bs)
    close(summ, JL.block_summaries(k, mask, bs), LAYER_TOL)
    for kb in (1, 3, 8):
        got = L.golden_decode_partials(*t, kb, bs)
        want = JL.golden_decode_partials(q, k, v, mask, kb, bs)
        for a, w in zip(got, want):
            close(a, w, LAYER_TOL)
        assert np.array_equal(
            L.golden_block_idx(t[0], summ, t[3], kb, bs).numpy(),
            ref_golden_idx(q, np.asarray(summ), mask, kb, bs))


# --- the model --------------------------------------------------------------

@pytest.mark.parametrize("jcfg", [
    TINY, dataclasses.replace(TINY, tie_embeddings=False, qkv_bias=True),
    dataclasses.replace(TINY, golden_cached_summaries=True)],
    ids=["tied", "untied-bias", "cached-summaries"])
def test_prefill_matches_reference(jcfg):
    jp, tp = ref_params(jcfg)
    toks = tokens((2, 64), jcfg.vocab_size, 3)
    jlg, jcache = JT.prefill(jcfg, jp, jnp.asarray(toks))
    lg, cache = T.prefill(port_cfg(jcfg), tp, torch.from_numpy(toks).long())
    assert lg.shape == (2, jcfg.padded_vocab)
    close(lg, jlg, LOGIT_TOL)
    want = np_tree(jcache)
    assert set(cache["l0"]) == set(want["l0"])
    for name, leaf in cache["l0"].items():
        close(leaf, want["l0"][name], CACHE_TOL)


def test_forward_full_matches_reference():
    jp, tp = ref_params(TINY)
    toks = tokens((2, 32), TINY.vocab_size, 8)
    x = np.array(JT.embed_tokens(TINY, jp, jnp.asarray(toks)))
    jlg, _, jaux = JT.forward_full(TINY, jp, jnp.asarray(x), mode="prefill")
    lg, cache, aux = T.forward_full(port_cfg(TINY), tp, torch.from_numpy(x))
    assert cache is None and lg.shape == (2, 32, TINY.padded_vocab)
    assert float(aux) == float(jaux) == 0.0
    close(lg, jlg, LOGIT_TOL)


def layer0_query(cfg, tp, tok, pos):
    """The layer-0 decode query of ``tok`` at ``pos`` (it depends on the
    parameters alone, so it pins the golden block choice per step)."""
    p = {k: v[0] for k, v in tp["blocks"]["l0"]["attn"].items()}
    x = L.rmsnorm(tp["blocks"]["l0"]["ln1"][0], tp["embed"][tok])
    q, _, _ = L.qkv_proj(p, x[:, None], T._attn_dims(cfg),
                         torch.full((1, 1), pos), cfg.rope_theta)
    return q[:, 0].reshape(tok.shape[0], cfg.num_kv_heads, -1, cfg.hdim)


@pytest.mark.parametrize("kind,cached", [("full", False), ("golden", False),
                                         ("golden", True)])
def test_decode_steps_match_reference(kind, cached):
    jcfg = dataclasses.replace(TINY, attn_kind_decode=kind,
                               golden_cached_summaries=cached)
    cfg = port_cfg(jcfg)
    jp, tp = ref_params(jcfg)
    s, b = 64, 2
    jcache = JT.zero_cache(jcfg, b, s)
    cache = T.zero_cache(cfg, b, s, device="cpu")
    rng = np.random.default_rng(4)
    jdecode = jax.jit(lambda c, t, p: JT.decode_step(jcfg, jp, c, t, p))
    for pos in range(10):
        tok = rng.integers(0, jcfg.vocab_size, b).astype(np.int32)
        jlg, jcache = jdecode(jcache, jnp.asarray(tok), jnp.int32(pos))
        lg, cache = T.decode_step(cfg, tp, cache, torch.from_numpy(tok).long(),
                                  pos)
        close(lg, jlg, LOGIT_TOL)
        if kind == "golden":
            q = layer0_query(cfg, tp, torch.from_numpy(tok).long(), pos)
            mask = torch.arange(s).expand(b, s) <= pos
            summ = (cache["l0"]["summ"][0] if cached else
                    L.block_summaries(cache["l0"]["k"][0], mask, 8))
            got = L.golden_block_idx(q, summ, mask, 2, 8)
            jsumm = np.asarray(jcache["l0"]["summ"][0]) if cached else \
                np.asarray(JL.block_summaries(jcache["l0"]["k"][0],
                                              mask.numpy(), 8))
            assert np.array_equal(got.numpy(), ref_golden_idx(
                q.numpy(), jsumm, mask.numpy(), 2, 8))
    want = np_tree(jcache)
    for name, leaf in cache["l0"].items():
        close(leaf, want["l0"][name], CACHE_TOL)
    again = cache_from_numpy(cfg, want, device="cpu")
    assert all(torch.equal(again["l0"][n], torch.from_numpy(
        np.array(want["l0"][n]))) for n in again["l0"])


def test_decode_after_prefill_matches_reference():
    jp, tp = ref_params(TINY)
    toks = tokens((2, 64), TINY.vocab_size, 5)
    _, jcache = JT.prefill(TINY, jp, jnp.asarray(toks))
    _, cache = T.prefill(port_cfg(TINY), tp, torch.from_numpy(toks).long())
    for kb in (8, 2, 1):
        jcfg = dataclasses.replace(TINY, golden_blocks=kb)
        jlg, _ = JT.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, -1]),
                                jnp.int32(63))
        lg, _ = T.decode_step(port_cfg(jcfg), tp, cache,
                              torch.from_numpy(toks[:, -1]).long(), 63)
        close(lg, jlg, LOGIT_TOL)


def test_bf16_prefill_and_decode():
    jcfg = dataclasses.replace(TINY, dtype="bfloat16")
    jp, tp = ref_params(jcfg)
    assert tp["embed"].dtype == torch.bfloat16
    toks = tokens((2, 64), jcfg.vocab_size, 6)
    jlg, jcache = JT.prefill(jcfg, jp, jnp.asarray(toks))
    lg, cache = T.prefill(port_cfg(jcfg), tp, torch.from_numpy(toks).long())
    assert lg.dtype == torch.bfloat16
    close(lg, jlg, 5e-2)
    assert np.array_equal(lg.float().argmax(-1).numpy(),
                          np.asarray(jlg, np.float32).argmax(-1))
    jd, _ = JT.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, -1]),
                           jnp.int32(63))
    d, _ = T.decode_step(port_cfg(jcfg), tp, cache,
                         torch.from_numpy(toks[:, -1]).long(), 63)
    close(d, jd, 5e-2)
    assert np.array_equal(d.float().argmax(-1).numpy(),
                          np.asarray(jd, np.float32).argmax(-1))


# --- the golden-decode entry point ------------------------------------------

def test_golden_decode_entry_point_matches_reference_example():
    """``--reduced`` on the CPU against examples/golden_decode.py's math on
    the same parameters and tokens (a 1024-token cache, 16 blocks)."""
    jcfg = dataclasses.replace(
        jget_config("llama3.2-3b").reduced(num_layers=4, d_model=256,
                                           d_ff=512, vocab=1024),
        golden_block_size=64)
    cfg = gd.example_config(reduced=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jp, tp = ref_params(jcfg, seed=0)
    toks = tokens((2, 1024), jcfg.vocab_size, 7)
    res = gd.run(cfg, tp, torch.from_numpy(toks).long())

    _, jcache = JT.prefill(jcfg, jp, jnp.asarray(toks))
    tok, pos = jnp.asarray(toks[:, -1]), jnp.int32(1023)
    lg_full, _ = JT.decode_step(dataclasses.replace(
        jcfg, attn_kind_decode="full"), jp, jcache, tok, pos)
    close(res["full_logits"], lg_full, LOGIT_TOL)
    p_full = jax.nn.softmax(lg_full.astype(jnp.float32), -1)
    assert [r["kb"] for r in res["rows"]] == [16, 8, 4, 2, 1]
    for row in res["rows"]:
        jg = dataclasses.replace(jcfg, attn_kind_decode="golden",
                                 golden_blocks=row["kb"])
        lg_g, _ = JT.decode_step(jg, jp, jcache, tok, pos)
        p_g = jax.nn.log_softmax(lg_g.astype(jnp.float32), -1)
        kl = float(jnp.sum(p_full * (jnp.log(p_full + 1e-20) - p_g),
                           -1).mean())
        top1 = float((jnp.argmax(lg_g, -1) == jnp.argmax(lg_full, -1)).mean())
        assert abs(row["kl"] - kl) <= 1e-4, (row, kl)
        assert row["top1"] == top1
        close(res["golden_logits"][row["kb"]], lg_g, LOGIT_TOL)
    assert res["ops_err"] == 0.0
    assert res["block_idx"].shape == (2, 4, 2)


def test_golden_decode_cli_needs_a_card_or_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gd.main(["--reduced"])
    res = gd.main(["--reduced", "--device", "cpu", "--seq", "512",
                   "--batch", "1"])
    out = capsys.readouterr().out
    assert "KL(full||gold)" in out and len(res["rows"]) == 5
