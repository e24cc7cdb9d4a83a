#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Phases:
  1. environment: the card, CUDA, nvcc and triton; TF32 off;
  2. build: the nine hand-written kernels from ``src/repro_torch/kernels/csrc``
     (ten sources: kernel 9 has a bf16 tensor-core source and an fp32
     CUDA-core one), with the registers, shared memory and spills of
     each instance of the redesigned kernels (1-6, 8-9);
  3. scale: the cifar_like store, N=50000 rows of D=3072 (proxy dp=192),
     built once and shared by every phase, and the Golden Index's scale
     store, gmm N=65536 x 64 with 256 modes;
     index-build: the port's k-means on the card for both stores, twice
     each with one generator (bit-equal), the CSR layout validated and
     saved and loaded back;
  4. kernel checks at the main path's shapes (B=16, m=12500, k=5000;
     the two top-m kernels also at m=5000, and on integer data at m=2049,
     one past their sort chunk, and m=20000, four merge rounds; the
     centroid scan at both index shapes): each kernel against its plain
     PyTorch version,
     bit-equal on integer-valued data (distances and the selected sets,
     in order), within 1e-5 relative (distances) / 1e-4 absolute (means)
     on the float store, timed with CUDA events against its bound, its
     plain version and, where one exists, one PyTorch library call;
     the two top-m kernels' device time split into the select passes,
     the chunk sort, the merge rounds and the rest, and kernels 2 and
     3's into the row map, the weights (3), the row pass and the gather
     or merge ([time] ... split), their row passes' rate against a plain
     read of the store, and both at B=1; kernel 3 called twice,
     bit-equal; kernel 4's device time split into its cluster pass and
     its merge, the pass's rate against the same plain read, its
     clusters' ranks holding bit-identical softmax states, two calls
     bit-equal, and kernel 4 at B=1 and at D=12288 (N=16384), kernel 1
     at B=1; kernel 7 at both index shapes: its distance stage alone
     against the plain version as above, and its probe launch (pooling,
     distances, the stable top-nprobe windows, the CSR expansion) bit-
     equal to its plain version in every field on integer data at the
     indexed step's P and at P = W, its float probe lists equal up to
     printed near-ties, timed against the chain it replaces (launches
     counted with the profiler), and at every window of the gmm store;
  5. policy: the fused-vs-staged step sweep over m/N that sets the
     engine's "cuda" crossover, the streamed-vs-materialized screen's
     time and peak memory at B=16 and B=256 that set its byte budget,
     and the routes that fused="auto" / screen="auto" take here;
     index: on the gmm store (the reference's indexed configuration),
     which steps the index serves, recall@m_t against the exact screen
     (>= 0.95 at every served bucket, the reference's gate) and the
     indexed vs exact coarse and denoise times;
  6. serve: ServeEngine answers 3 requests of 16 images on the auto
     route, and again with fused=True; a streamed-screen trajectory
     (GoldDiff(screen="streamed")); the indexed cifar_like trajectory
     (GoldDiff(index=...), every step indexed), 3 indexed waves on the
     gmm store, and 3 waves on cifar_like with index_mode="auto" that
     must screen exactly; one indexed step profiled: exactly one launch
     (kernel 7's) from the rescaled query to kernel 2's first launch.
     Every count of launches is set to 0 just
     before each and read just after, and must show that each route's
     kernels ran once per step, and the others never;
  7. baseline: staged, fused, streamed, indexed, full-scan and the exact
     staged trajectory at the indexed configuration, from the same x_T,
     each counted alone, timed and profiled;
     plan: ServeEngine in plan mode (the reference's default) at B=16:
     the plan, warmup()'s CUDA graphs (one per plan bucket x batch
     bucket), their seconds and the memory they hold; 3 counted waves
     in turns with the static engine (no capture after warmup); every
     segment's graph replay bit-equal to the segment run eagerly; plan
     vs static within 1e-3; the indexed plan at INDEXED_CFG +
     SCALE_PROBES; gmm index_mode="always" plan waves; plan and static
     trajectories timed in turns and profiled at B=16, 4 and 1 (the
     earlier [serve] phases are pinned to mode="static");
  8. reference: a small store's trajectories on the card against the
     same trajectories on the CPU (plain versions), for every route
     (the indexed one with an index built on the CPU and moved over),
     and the auto and indexed plans;
  9. the reduced-LLM slice (``llm_phases``): flash attention (kernel 9)
     and golden decode attention (kernel 8) against their plain versions
     at the path's shapes in fp32 and bf16 ([llm-check]); the
     golden-decode entry point at --reduced on the card against the CPU
     ([llm-reference]); the entry point at llama3.2-3b's full width,
     counted (28 launches of kernel 9 a prefill), with its KL/top-1
     table, prefill and decode walls and idle shares ([llm-decode]);
     both kernels timed against bound, plain version and one library
     call, with the achieved rate and share of the bound, kernel 9 also
     at S=32768 ([time]).

Any failure exits non-zero before the last line.  The last lines are the
card's name and power limit, a JSON line of per-kernel numbers, and
``{"ok": true, "device": {...}}``.

  python3 chip_smoke.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "scripts"))
try:
    from card_timing import (B, GMM_C, GMM_DIM, GMM_MODES, GMM_N, GMM_SPREAD,
                             INDEXED_FRACS, N, SCALE_PROBES, STEPS, T_BUCKETS,
                             card, device_kernels, kernel_names, launch_name,
                             short, time_ms, wall_ms)
except ImportError:
    sys.exit(f"chip_smoke: FAIL: no scripts/card_timing.py beside "
             f"{Path(__file__).name}")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, fp32 outside the tensor cores
DP, D, M, K = 192, 3072, 12500, 5000
M_LOW = 5000                   # the smallest m_t of the 10-step schedule
# integer checks of the top-m kernels: the path's m_t, one past the
# sort's 2048-key chunk (its m + 2048 = 4097 slots: two chunks and one
# more), and above 16384 (22048 slots: 11 chunks, four merge rounds)
M_CHECKS = (M, M_LOW, 2049, 20000)
# the top-m kernels' launches by part, for [time] ... split and [profile]
TOPM_PARTS = {"select passes": ("radix_pass", "select_all"),
              "chunk sort": ("sort_chunks",), "merge rounds": ("merge_round",)}
TOPM_ENTRIES = ("radix_pass", "select_all", "sort_chunks", "merge_round")
# kernels 2 and 3's launches by part (csrc/row_union.cuh and the two
# sources), for [time] ... split, and both together for [profile]
SQDIST_PARTS = {"row map": ("sqdist_mark", "union_count", "union_compact"),
                "row pass": ("sqdist_dots",), "gather": ("sqdist_gather",)}
SAGG_PARTS = {"row map": ("sagg_mark", "union_count", "union_compact"),
              "weights": ("sagg_tally", "sagg_weigh"),
              "row pass": ("sagg_rows",), "merge": ("sagg_merge",)}
AGG_PARTS = {"cluster pass": ("agg_cluster",), "merge": ("merge_kernel",)}
WIDE_N, WIDE_D = 16384, 12288    # kernel 4 at the afhq_like width
UNION_PARTS = {"row maps": ("sqdist_mark", "sagg_mark", "union_count",
                            "union_compact"),
               "weights": SAGG_PARTS["weights"],
               "row passes": ("sqdist_dots", "sagg_rows"),
               "gather and merge": ("sqdist_gather", "sagg_merge")}
SWEEP = (0.05, 0.10, 0.25, 0.50)   # m/N of the fused-vs-staged sweep
DIST_RTOL, MEAN_ATOL, TRAJ_TOL = 1e-5, 1e-4, 1e-3
RECALL_MIN = 0.95
BF16_FLOPS_PER_S = 989e12      # H100 SXM data sheet, dense bf16 tensor cores
# The reduced-LLM slice: the golden-decode entry point's cache (B=2,
# S=4096, llama3.2-3b's 8 KV heads of G=3, dh=128) and two long-context
# shapes of the reference's dry-run (src/repro/launch/inputs.py:30-31):
# prefill_32k at one sequence through one layer, and decode_32k at 16
# of its 128 sequences with the config's own golden blocks (64 blocks
# of 128 keys).
LLM_B, LLM_S, HKV, G_Q, DH = 2, 4096, 8, 3, 128
LONG_S = 32768
DEC_B, DEC_BS, DEC_KB = 16, 128, 64
ATT_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
LLM_LOGIT_TOL = 1e-4           # fp32 logits, card vs CPU (reduced width)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def ints(shape, seed: int) -> torch.Tensor:
    """Integer-valued fp32 data: every sum below is exact in fp32."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-3, 4, shape, generator=g).float().cuda()


def bound(nbytes: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


def profile_line(label: str, wall: float, fn) -> float:
    """Profile one call of ``fn`` and print its device busy time, its idle
    share against ``wall`` (the unprofiled wall in ms of the same call:
    the profiler's own host work widens the gaps), its top kernels and
    the device time of the top-m kernels' parts (TOPM_PARTS) and of
    kernels 2 and 3's (UNION_PARTS).  Returns the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_on = (time.perf_counter() - t0) * 1e3
    kern = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    check(busy > 0, f"profile of {label}: no device time recorded")
    idle = 1 - busy / wall
    print(f"[profile] {label}: wall {wall:.2f} ms unprofiled ({wall_on:.2f} "
          f"ms with the profiler on), device busy {busy:.2f} ms, idle share "
          f"{idle:.3f} of the unprofiled wall ({1 - busy / wall_on:.3f} with "
          f"the profiler on); top kernels: " + "; ".join(
              f"{short(e.key)} x{e.count} {e.self_device_time_total / 1e3:.3f}"
              f" ms" for e in kern[:6]) + "; top-m parts: " + ", ".join(
              f"{part} {part_ms(kern, frags):.3f} ms"
              for part, frags in TOPM_PARTS.items()) + "; union parts: "
          + ", ".join(f"{part} {part_ms(kern, frags):.3f} ms"
                      for part, frags in UNION_PARTS.items()))
    return idle


def part_ms(kern, frags) -> float:
    """Device ms of the profiled kernels whose names hold a fragment."""
    return sum(e.self_device_time_total for e in kern
               if any(f in e.key for f in frags)) / 1e3


def device_split(fn, groups: dict, iters: int = 10):
    """Device ms per call of ``fn`` by kernel group, from the profiler
    over ``iters`` calls, each after an L2 flush (as ``time_ms``): each
    kernel's time goes to the first group one of whose name fragments its
    name holds, else to "rest".  The flush's own kernels are left out.
    Also returns the device us of each launch of one more such call, in
    launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def launches(run):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        return sorted(ev, key=lambda e: e.time_range.start)

    skip = {e.name for e in launches(flush.zero_)}
    fn()

    def calls():
        for _ in range(iters):
            flush.zero_()
            fn()

    out = dict.fromkeys([*groups, "rest"], 0.0)
    for e in launches(calls):
        if e.name in skip:
            continue
        g = next((g for g, frags in groups.items()
                  if any(f in e.name for f in frags)), "rest")
        out[g] += e.time_range.elapsed_us() / 1e3 / iters
    flush.zero_()
    one = [(launch_name(e.name), e.time_range.elapsed_us())
           for e in launches(fn) if e.name not in skip]
    return out, one


def split_line(label: str, kernel_ms: float, fn,
               parts: dict = TOPM_PARTS) -> dict:
    """Print a kernel's device time by part (TOPM_PARTS for the top-m
    kernels) and the device time of each launch of one call; return the
    parts' ms."""
    split, one = device_split(fn, parts)
    print(f"[time] {label} split (profiler, L2 flushed): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
          + f"; sum {sum(split.values()):.4f} ms against the kernel's "
          f"{kernel_ms:.4f} ms (CUDA events); one call's launches (us): "
          + ", ".join(f"{n} {us:.1f}" for n, us in one))
    return split


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def overlap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean fraction of each row's set in ``a`` also in ``b``'s row."""
    fr = [torch.isin(a[i], b[i]).float().mean() for i in range(a.shape[0])]
    return float(torch.stack(fr).mean())


def llm_phases(kernels: dict) -> tuple[dict, dict]:
    """The reduced-LLM slice on the card: [llm-check] holds kernels 9 and
    8 against their plain versions at the path's shapes; [llm-reference]
    runs the golden-decode entry point at --reduced on the card and on
    the CPU from one set of weights; [llm-decode] runs it at llama3.2-3b's
    full width with every count set to 0 just before, then times and
    profiles the prefill and one decode step; [time] times both kernels
    against their bounds, plain versions and one library call.  Returns
    the two kernels' result entries and the counts of the full-width
    run."""
    import dataclasses

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.golden_attention import (
        golden_attention_decode, select_golden_blocks)
    from repro_torch.launch import golden_decode as gd
    from repro_torch.models import transformer as T
    from repro_torch.models.module import tree_map
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(11)
    f32, bf16 = torch.float32, torch.bfloat16

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # -- [llm-check] kernel 9 at the prefill's shape --------------------------
    err9 = 0.0
    for dtype in (f32, bf16):
        q = randn((LLM_B, HKV, G_Q, LLM_S, DH), dtype)
        k, v = (randn((LLM_B, HKV, LLM_S, DH), dtype) for _ in range(2))
        for causal in (True, False):
            got = flash_attention(q, k, v, causal)
            want = ref.flash_attention_ref(q, k, v, causal)
            err = float((got.float() - want.float()).abs().max())
            del want
            check(err <= ATT_TOL[dtype], f"flash_attention {dtype} causal="
                  f"{causal}: max abs {err:.3g} > {ATT_TOL[dtype]}")
            err9 = max(err9, err)
            print(f"[llm-check] flash_attention [{LLM_B}, {HKV}, {G_Q}, "
                  f"{LLM_S}, {DH}] {str(dtype)[6:]} causal={causal}: max abs "
                  f"{err:.3g} against its plain version (tolerance "
                  f"{ATT_TOL[dtype]})")
    del q, k, v, got

    # -- [llm-check] kernel 8 at the ops shape and at decode_32k --------------
    shapes8 = {"ops": (LLM_B, LLM_S, 64, LLM_S // 64 // 8),
               "decode_32k": (DEC_B, LONG_S, DEC_BS, DEC_KB)}
    err8, timed8 = 0.0, {}
    for label, (b, s, bs, kb) in shapes8.items():
        for dtype in (f32, bf16):
            q = randn((b, HKV, G_Q, DH), dtype)
            k, v = (randn((b, HKV, s, DH), dtype) for _ in range(2))
            idx, _ = select_golden_blocks(q.float(), k, kb, bs)
            valid = (torch.rand(idx.shape, generator=gen, device="cuda")
                     < 0.75).int()
            valid[0, 0, 0] = 1
            valid[-1, -1] = 0                      # a (b, h) with none
            got = golden_attention_decode(q, k, v, idx, valid, bs)
            want = ref.golden_attention_decode_ref(q, k, v, idx, valid, bs)
            err = float((got.float() - want.float()).abs().max())
            zero = not bool(got[-1, -1].any())
            check(err <= ATT_TOL[dtype] and zero,
                  f"golden_attention_decode {label} {dtype}: max abs "
                  f"{err:.3g}, no-valid (b, h) zero {zero}")
            err8 = max(err8, err)
            print(f"[llm-check] golden_attention_decode {label} (B={b}, "
                  f"Hkv={HKV}, G={G_Q}, dh={DH}, S={s}, bs={bs}, kb={kb}, "
                  f"{int((valid == 1).sum())} of {valid.numel()} blocks "
                  f"valid) {str(dtype)[6:]}: max abs {err:.3g} against its "
                  f"plain version (tolerance {ATT_TOL[dtype]}); the (b, h) "
                  f"with no valid block gives 0")
            if dtype == bf16:
                timed8[label] = (q, k, v, idx, valid, bs)
            del got, want

    # -- [llm-reference] the entry point at --reduced, card against CPU -------
    rcfg = gd.example_config(reduced=True)
    params = gd.draw_params(rcfg, 0, "cpu")
    toks = gd.draw_tokens(rcfg, LLM_B, LLM_S, 0)
    t0 = time.perf_counter()
    want = gd.run(rcfg, params, toks)
    cpu_s = time.perf_counter() - t0
    got = gd.run(rcfg, tree_map(lambda t: t.cuda(), params), toks.cuda())
    errs = {key: float((got[key].cpu() - want[key]).abs().max())
            for key in ("prefill_logits", "full_logits")}
    for kb, lg in want["golden_logits"].items():
        errs[f"golden kb={kb}"] = float(
            (got["golden_logits"][kb].cpu() - lg).abs().max())
    kl_err = max(abs(a["kl"] - w["kl"]) for a, w in
                 zip(got["rows"], want["rows"]))
    same_blocks = torch.equal(got["block_idx"].cpu(), want["block_idx"])
    check(max(errs.values()) <= LLM_LOGIT_TOL and kl_err <= LLM_LOGIT_TOL
          and same_blocks and [r["top1"] for r in got["rows"]]
          == [r["top1"] for r in want["rows"]],
          f"llm-reference: logits {errs}, KL {kl_err:.3g}, blocks equal "
          f"{same_blocks}")
    print(f"[llm-reference] golden-decode entry point at --reduced "
          f"({rcfg.num_layers} layers, d_model {rcfg.d_model}, S={LLM_S}, "
          f"B={LLM_B}), card against CPU from the same weights: logits max "
          f"abs " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; KL column max abs {kl_err:.3g}; top-1 column equal; ops "
          f"block choices equal; tolerance {LLM_LOGIT_TOL} (CPU run "
          f"{cpu_s:.1f} s)")
    del params, want, got

    # -- [llm-decode] the entry point at full width, counted ------------------
    cfg = gd.example_config()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = gd.draw_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = gd.draw_tokens(cfg, LLM_B, LLM_S, 0).cuda()
    gd.run(cfg, params, toks)                      # warm-up, not counted
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = gd.run(cfg, params, toks)
    counts = {n: f.launches for n, f in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    want_counts = {n: 0 for n in kernels}
    want_counts.update(flash_attention=cfg.num_layers,
                       golden_attention_decode=1)
    check(counts == want_counts, f"llm-decode launches {counts}")
    check(all(bool(torch.isfinite(res[k]).all()) for k in
              ("prefill_logits", "full_logits"))
          and all(bool(torch.isfinite(v).all())
                  for v in res["golden_logits"].values()),
          "llm-decode: non-finite logits")
    check(tuple(res["prefill_logits"].shape) == (LLM_B, cfg.padded_vocab),
          f"llm-decode: logits {tuple(res['prefill_logits'].shape)}")
    print(f"[llm-decode] {cfg.name} at full width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size} padded to "
          f"{cfg.padded_vocab}, bf16, random weights drawn on the card in "
          f"{init_s:.2f} s), S={LLM_S}, B={LLM_B}, golden block "
          f"{cfg.golden_block_size}; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {counts}")
    gd.print_report(cfg, res, torch.device("cuda"))
    nb = LLM_S // cfg.golden_block_size
    pos, tok = LLM_S - 1, toks[:, -1]
    cfg_full = dataclasses.replace(cfg, attn_kind_decode="full")
    cfg_gold = dataclasses.replace(cfg, attn_kind_decode="golden",
                                   golden_blocks=nb // 8)
    _, cache = T.prefill(cfg, params, toks)
    # no step may wait on the device from the host (a read-back, a
    # blocking copy): with the sync debug mode at "error" any such call
    # raises
    torch.cuda.set_sync_debug_mode("error")
    for c in (cfg, cfg_full, cfg_gold):
        T.decode_step(c, params, cache, tok, pos)
    T.prefill(cfg, params, toks)
    torch.cuda.set_sync_debug_mode("default")
    print("[llm-decode] prefill and decode steps (full, golden) make no "
          "host-device synchronization (sync debug mode 'error')")
    steps = {"prefill": lambda: T.prefill(cfg, params, toks),
             "decode (full)": lambda: T.decode_step(cfg_full, params, cache,
                                                    tok, pos),
             f"decode (golden kb={nb // 8})": lambda: T.decode_step(
                 cfg_gold, params, cache, tok, pos)}
    walls = {}
    for label, fn in steps.items():
        walls[label] = wall_ms(fn, iters=3 if label == "prefill" else 10)
        idle = profile_line(f"llm {label}", walls[label], fn)
        print(f"[llm-decode] {label}: wall {walls[label]:.3f} ms (host clock "
              f"+ synchronize, mean of back-to-back calls), idle share "
              f"{idle:.3f}")
    del params, cache, res

    # -- [time] kernels 9 and 8 against bound, plain and library --------------
    def flash_time(b, s, plain: bool):
        q = randn((b, HKV, G_Q, s, DH), bf16)
        k, v = (randn((b, HKV, s, DH), bf16) for _ in range(2))
        qh = q.reshape(b, HKV * G_Q, s, DH)
        lib = sdpa(qh, k, v, is_causal=True, enable_gqa=True)
        lib_err = float((lib.reshape(q.shape).float()
                         - flash_attention(q, k, v, True).float()).abs().max())
        it = 10 if s <= LLM_S else 3
        out = dict(ms=time_ms(lambda: flash_attention(q, k, v, True), it),
                   plain_ms=(time_ms(lambda: ref.flash_attention_ref(
                       q, k, v, True), 3) if plain else None),
                   library_ms=time_ms(lambda: sdpa(
                       qh, k, v, is_causal=True, enable_gqa=True), it))
        flops = 4 * DH * b * HKV * G_Q * s * (s + 1) / 2
        out["bound_ms"], out["bound_by"] = bound(
            2 * (2 * q.numel() + 2 * k.numel()), flops, BF16_FLOPS_PER_S)
        print(f"[time] flash_attention bf16 causal B={b}, S={s}: kernel "
              f"{out['ms']:.4f} ms ({flops / out['ms'] / 1e9:.1f} TFLOP/s, "
              f"{out['bound_ms'] / out['ms']:.3f} of the bound; "
              f"{out['library_ms'] / out['ms']:.3f}x the library's speed), "
              f"bound {out['bound_ms']:.4f} ms "
              f"({out['bound_by']}: {flops / 1e9:.1f} GFLOP at the bf16 "
              f"tensor-core rate), plain "
              + (f"{out['plain_ms']:.4f} ms" if plain else
                 f"not measured (its [{b}, {HKV}, {G_Q}, {s}, {s}] fp32 "
                 f"scores need {4 * b * HKV * G_Q * s * s / 1e9:.0f} GB)")
              + f", library (scaled_dot_product_attention, is_causal, "
              f"enable_gqa) {out['library_ms']:.4f} ms, max abs "
              f"{lib_err:.3g} against it")
        return out

    r9 = flash_time(LLM_B, LLM_S, plain=True)
    flash_time(1, LONG_S, plain=False)
    r9["max_abs_err"] = err9
    r8 = None
    for label, (q, k, v, idx, valid, bs) in timed8.items():
        b, s = q.shape[0], k.shape[2]
        nvalid = int((valid == 1).sum())
        blocks = torch.zeros((b, HKV, s // bs), dtype=torch.bool,
                             device="cuda")
        blocks.scatter_(2, idx.long(), valid == 1)
        mask = blocks.repeat_interleave(bs, -1).repeat_interleave(
            G_Q, 1)[:, :, None, :]                  # [B, Hq, 1, S]
        qh = q.reshape(b, HKV * G_Q, 1, DH)
        out = dict(
            ms=time_ms(lambda: golden_attention_decode(q, k, v, idx, valid,
                                                       bs)),
            plain_ms=time_ms(lambda: ref.golden_attention_decode_ref(
                q, k, v, idx, valid, bs), 3),
            library_ms=time_ms(lambda: sdpa(qh, k, v, attn_mask=mask,
                                            enable_gqa=True), 3))
        nbytes = (2 * nvalid * bs * DH * 2 + 2 * 2 * q.numel()
                  + 8 * idx.numel())
        out["bound_ms"], out["bound_by"] = bound(
            nbytes, 4 * G_Q * DH * bs * nvalid, BF16_FLOPS_PER_S)
        print(f"[time] golden_attention_decode bf16 {label} (B={b}, S={s}, "
              f"bs={bs}, {nvalid} valid blocks): kernel {out['ms']:.4f} ms "
              f"({nbytes / out['ms'] / 1e6:.1f} GB/s, "
              f"{out['bound_ms'] / out['ms']:.3f} of the bound; "
              f"{out['library_ms'] / out['ms']:.3f}x the library's speed), "
              f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}: "
              f"{nbytes / 1e6:.1f} MB), plain {out['plain_ms']:.4f} ms, "
              f"library (scaled_dot_product_attention with the golden "
              f"blocks' mask, enable_gqa) {out['library_ms']:.4f} ms")
        if label == "ops":                        # the path's own call
            r8 = dict(out, max_abs_err=err8)
    return {"flash_attention": r9, "golden_attention_decode": r8}, counts


def main() -> None:
    # -- 1. environment ------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import (GoldDiff, GoldDiffConfig, GoldDiffEngine,
                                  OptimalDenoiser, build_plan, plan_segment,
                                  plan_segment_key, sample, sample_plan,
                                  sampling_timesteps)
    from repro_torch.core import engine as engine_mod
    from repro_torch.data import make_dataset
    from repro_torch.index import (ProbeSchedule, build_index,
                                   default_num_clusters, load_index,
                                   save_index, screening_recall,
                                   validate_index)
    from repro_torch.index.store import ARRAY_FIELDS
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.centroid_scan import centroid_scan
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused_step import (
        fused_candidates, fused_candidates_scan, fused_posterior)
    from repro_torch.kernels.golden_aggregate import (cluster_states,
                                                      golden_aggregate)
    from repro_torch.kernels.golden_attention import golden_attention_decode
    from repro_torch.kernels.golden_rerank import support_sqdist
    from repro_torch.kernels.golden_support_aggregate import (
        golden_support_aggregate)
    from repro_torch.kernels.pdist import pdist
    from repro_torch.kernels.screen import screen_topm, screen_topm_scan
    from repro_torch.launch.serve import Request, ServeEngine

    smi = card()
    nvcc_line = run([_build.nvcc(), "--version"]).splitlines()[-1]
    try:
        import triton
        triton_state = f"triton {triton.__version__}"
    except ImportError:
        triton_state = "triton absent"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(f"[env] card: {smi}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc_line}, {triton_state}, python {sys.version.split()[0]}")
    print("[env] TF32 off for matmul and cuDNN")

    # -- 2. build --------------------------------------------------------------
    names = ["pdist", "support_sqdist", "golden_support_aggregate",
             "golden_aggregate", "screen_topm", "fused_candidates",
             "centroid_scan", "flash_attention", "flash_attention_sm90",
             "golden_attention"]
    t0 = time.perf_counter()
    log = _build.build(names)
    print(f"[build] {len(names)} sources in {time.perf_counter() - t0:.1f}s "
          f"(one nvcc each, in parallel) into {_build.BUILD_DIR}")
    by_instance = {"pdist": ("pdist_kernel",),
                   "golden_aggregate": ("agg_cluster", "merge_kernel"),
                   "flash_attention_sm90": ("flash_sm90_kernel",),
                   "golden_attention": ("gattn_",),
                   "screen_topm": TOPM_ENTRIES + ("compact_pass",),
                   "support_sqdist": ("sqdist_", "union_"),
                   "golden_support_aggregate": ("sagg_", "union_"),
                   "fused_candidates": TOPM_ENTRIES + ("fused_pass",)}
    for name in names:
        if name in by_instance:
            continue                       # by instance, below
        for line in log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    for name, entries in by_instance.items():
        for entry in entries:
            for inst, regs, smem, spill in _build.instances(
                    log.get(name, ""), entry):
                print(f"[build] {name} {inst}: {regs} registers, {smem} "
                      f"{spill}")
    smem9 = _build.load("flash_attention_sm90", "flash_attention_sm90_smem_"
                        "bytes", [ctypes.c_int] * 2, ctypes.c_size_t)
    print("[build] flash_attention_sm90 dynamic shared memory a CTA (W "
          "consumer warpgroups, dh): " + ", ".join(
              f"W={w} dh={dh} {smem9(w, dh)} B" for w in (1, 2, 3)
              for dh in (32, 64, 128)))

    # -- 3. scale: the store ---------------------------------------------------
    t0 = time.perf_counter()
    eng = ServeEngine("cifar_like", {"n": N}, num_steps=STEPS, max_batch=B,
                      mode="static")
    torch.cuda.synchronize()
    store_s = time.perf_counter() - t0
    st = eng.store
    check(tuple(st.X.shape) == (N, D) and tuple(st.proxy.shape) == (N, DP),
          f"store shapes {tuple(st.X.shape)} {tuple(st.proxy.shape)}")
    print(f"[scale] cifar_like store N={st.n} D={st.dim} dp={st.proxy.shape[1]}"
          f" built in {store_s:.1f}s (numpy generation + upload)")
    t0 = time.perf_counter()
    gst = make_dataset("gmm", n=GMM_N, dim=GMM_DIM, num_modes=GMM_MODES,
                       spread=GMM_SPREAD, seed=0, device="cuda")
    print(f"[scale] gmm store N={gst.n} D={gst.dim} ({GMM_MODES} modes, "
          f"spread {GMM_SPREAD}) built in {time.perf_counter() - t0:.1f}s")
    indexed_cfg = GoldDiffConfig(**INDEXED_FRACS)
    scale_probes = ProbeSchedule(**SCALE_PROBES)

    # -- index-build: the port's k-means on the card -----------------------------
    def build_twice(store, c: int, label: str):
        """Build the index twice from one seed; they must be bit-equal."""
        built, secs = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            built.append(build_index(store, c, generator=torch.Generator(
                device="cuda").manual_seed(0)))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        ix, again = built
        check(all(torch.equal(getattr(ix, f), getattr(again, f))
                  for f in ("centroids", "perm", "offsets")),
              f"{label}: two builds from one generator differ")
        check(ix.device.type == "cuda" and ix.perm.dtype == torch.int64,
              f"{label}: index on {ix.device}, perm {ix.perm.dtype}")
        host = {f: getattr(ix, f).cpu().numpy() for f in ARRAY_FIELDS}
        validate_index(host, ix.max_cluster)
        sizes = torch.diff(ix.offsets).float()
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "index.npz")
            save_index(ix, path)
            back = load_index(path, device="cuda")
        check(back.max_cluster == ix.max_cluster and all(
            torch.equal(getattr(back, f), getattr(ix, f))
            for f in ARRAY_FIELDS), f"{label}: save/load round trip differs")
        print(f"[index-build] {label}: N={store.n} dp={store.proxy.shape[1]}"
              f" C={c} clusters -> W={ix.num_clusters} windows, L="
              f"{ix.max_cluster}; window rows min {int(sizes.min())}, "
              f"median {float(sizes.median()):.0f}, mean "
              f"{float(sizes.mean()):.1f}, max {int(sizes.max())}, std "
              f"{float(sizes.std()):.1f}; build {secs[0]:.2f} s and "
              f"{secs[1]:.2f} s, bit-equal; validate_index passes; "
              f"save/load round trip equal")
        return ix

    cix = build_twice(st, default_num_clusters(N), "cifar_like")
    gix = build_twice(gst, GMM_C, "gmm")

    # -- 4. kernel checks at the main path's shapes -----------------------------
    sched = eng.schedule
    ts = eng.denoiser.engine
    t_mid = 500
    a, sig2 = ts.constants(t_mid)
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(0, N, (B,), generator=g).cuda()
    eps = torch.randn(B, D, generator=g).cuda()
    q = (a * st.X[rows] + float(sched.b[t_mid]) * eps) / a   # rescaled query
    qp = ts._proxy_query(q)
    results = {}

    # kernel 1: pdist (coarse screen)
    qi, xi = ints((B, DP), 1), ints((N, DP), 2)
    qin, xin = (qi * qi).sum(-1), (xi * xi).sum(-1)
    d2k = pdist(qi, xi, qin, xin)
    d2r = ref.pdist_ref(qi, xi, qin, xin)
    check(torch.equal(d2k, d2r), "pdist: not bit-equal on integer data")
    ik, vk = ref.materialized_topm(d2k, M)
    ir, vr = ref.materialized_topm(d2r, M)
    check(torch.equal(ik, ir) and torch.equal(vk, vr),
          "pdist: integer top-m sets differ")
    int_cand = ik
    qpn = (qp * qp).sum(-1)
    d2k = pdist(qp, st.proxy, qpn, st.proxy_norms)
    d2r = ref.pdist_ref(qp, st.proxy, qpn, st.proxy_norms)
    err = float((d2k - d2r).abs().max())
    rel = rel_err(d2k, d2r)
    check(rel <= DIST_RTOL, f"pdist: relative error {rel:.3g} > {DIST_RTOL}")
    cand_k = ref.materialized_topm(d2k, M)[0]
    cand_r = ref.materialized_topm(d2r, M)[0]
    ov = overlap(cand_k, cand_r)
    bias = qpn[:, None] + st.proxy_norms[None, :]
    b_ms, b_by = bound(4 * (B * DP + N * DP + B + N + B * N), 2 * B * N * DP)
    results["pdist"] = dict(
        max_abs_err=err, ms=time_ms(lambda: pdist(qp, st.proxy, qpn,
                                                  st.proxy_norms)),
        plain_ms=time_ms(lambda: ref.pdist_ref(qp, st.proxy, qpn,
                                               st.proxy_norms)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.addmm(bias, qp, st.proxy.T,
                                               alpha=-2.0)))
    print(f"[check] pdist: integer bit-equal, top-{M} sets equal; float "
          f"max abs {err:.3g}, max rel {rel:.3g}, top-{M} overlap {ov:.6f} "
          f"(exact order {torch.equal(cand_k, cand_r)})")
    qp1, qpn1 = qp[:1].contiguous(), qpn[:1].contiguous()
    b1_ms = bound(4 * (DP + N * DP + 1 + N + N), 2 * N * DP)[0]
    print(f"[time] pdist B=1: kernel "
          f"{time_ms(lambda: pdist(qp1, st.proxy, qpn1, st.proxy_norms)):.4f}"
          f" ms (bound {b1_ms:.4f}); a plain read of the proxy store "
          f"(proxy.sum(), {4 * N * DP / 1e6:.1f} MB) "
          f"{time_ms(lambda: st.proxy.sum()):.4f} ms")
    del qp1, qpn1

    # kernel 2: support_sqdist (exact re-rank), rows loaded by index
    qfi, xfi = ints((B, D), 3), ints((N, D), 4)
    xfin = (xfi * xfi).sum(-1)
    sk = support_sqdist(qfi, xfi, xfin, int_cand)
    sr = ref.support_sqdist_ref(qfi, xfi, xfin, int_cand)
    check(torch.equal(sk, sr), "support_sqdist: not bit-equal on integer data")
    gk, gvk = ops.golden_rerank(qfi, xfi, int_cand, K, xfin)
    vr, pr = torch.sort(sr, dim=-1, stable=True)
    check(torch.equal(gk, torch.gather(int_cand, -1, pr[:, :K]))
          and torch.equal(gvk, vr[:, :K]),
          "support_sqdist: integer golden sets differ")
    del qfi, xfi, xfin, sr
    sk = support_sqdist(q, st.X, st.x_norms, cand_k)
    sr = ref.support_sqdist_ref(q, st.X, st.x_norms, cand_k)
    err = float((sk - sr).abs().max())
    rel = rel_err(sk, sr)
    check(rel <= DIST_RTOL,
          f"support_sqdist: relative error {rel:.3g} > {DIST_RTOL}")
    gold_k, gd2 = ops.golden_rerank(q, st.X, cand_k, K, st.x_norms)
    vr, pr = torch.sort(sr, dim=-1, stable=True)
    gold_r = torch.gather(cand_k, -1, pr[:, :K])
    ov = overlap(gold_k, gold_r)
    del sr
    u = int(torch.unique(cand_k).numel())
    b_ms, b_by = bound(4 * (u * D + u) + 4 * B * D + 8 * B * M + 4 * B * M,
                       2 * B * M * D)
    results["support_sqdist"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: support_sqdist(q, st.X, st.x_norms, cand_k)),
        plain_ms=time_ms(lambda: ref.support_sqdist_ref(q, st.X, st.x_norms,
                                                        cand_k), iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"[check] support_sqdist: integer bit-equal, top-{K} sets equal; "
          f"float max abs {err:.3g}, max rel {rel:.3g}, golden overlap "
          f"{ov:.6f}; {u} distinct rows of {N}")
    pass2 = split_line(f"support_sqdist m={M}",
                       results["support_sqdist"]["ms"],
                       lambda: support_sqdist(q, st.X, st.x_norms, cand_k),
                       SQDIST_PARTS)["row pass"]
    rows2 = u

    # kernel 3: golden_support_aggregate, rows loaded by index
    lg = torch.clamp_min(-gd2 / (2.0 * sig2), ref.NEG_INF)
    ak = golden_support_aggregate(st.X, gold_k, lg)
    check(torch.equal(ak, golden_support_aggregate(st.X, gold_k, lg)),
          "golden_support_aggregate: two calls differ")
    ar = ref.golden_support_aggregate_ref(st.X, gold_k, lg)
    err = float((ak - ar).abs().max())
    check(err <= MEAN_ATOL,
          f"golden_support_aggregate: max abs error {err:.3g} > {MEAN_ATOL}")
    lg_masked = lg.clone()
    lg_masked[0] = ref.NEG_INF
    am = golden_support_aggregate(st.X, gold_k, lg_masked)
    err_m = float((am[0] - st.X[gold_k[0]].mean(0)).abs().max())
    check(err_m <= MEAN_ATOL,
          f"golden_support_aggregate: all-NEG_INF row is not the mean "
          f"({err_m:.3g})")
    u = int(torch.unique(gold_k).numel())
    b_ms, b_by = bound(4 * u * D + 8 * B * K + 4 * B * K + 4 * B * D,
                       2 * B * K * D)
    results["golden_support_aggregate"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: golden_support_aggregate(st.X, gold_k, lg)),
        plain_ms=time_ms(lambda: ref.golden_support_aggregate_ref(
            st.X, gold_k, lg), iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    print(f"[check] golden_support_aggregate: max abs {err:.3g}, all-NEG_INF "
          f"row = uniform mean to {err_m:.3g}, two calls bit-equal; {u} "
          f"distinct rows of {N}")
    pass3 = split_line(f"golden_support_aggregate k={K}",
                       results["golden_support_aggregate"]["ms"],
                       lambda: golden_support_aggregate(st.X, gold_k, lg),
                       SAGG_PARTS)["row pass"]
    # the row passes against a plain read of the whole store (the rate
    # this card reaches on one sequential pass), and both kernels at B=1,
    # where no row is shared
    read_ms = time_ms(lambda: st.X.sum(0))
    read_rate = 4 * N * D / read_ms / 1e9
    print(f"[time] row passes: kernel 2 {4 * rows2 * D / pass2 / 1e9:.3f} "
          f"TB/s ({rows2} rows), kernel 3 {4 * u * D / pass3 / 1e9:.3f} TB/s "
          f"({u} rows); a plain read of the store (X.sum(0), "
          f"{4 * N * D / 1e6:.0f} MB) {read_ms:.4f} ms, {read_rate:.3f} TB/s")
    q1, c1 = q[:1].contiguous(), cand_k[:1].contiguous()
    g1, l1 = gold_k[:1].contiguous(), lg[:1].contiguous()
    b2 = bound(4 * (M * D + M + D) + 12 * M, 2 * M * D)[0]
    b3 = bound(4 * (K * D + D) + 12 * K, 2 * K * D)[0]
    print(f"[time] B=1 (no row shared): support_sqdist m={M} "
          f"{time_ms(lambda: support_sqdist(q1, st.X, st.x_norms, c1)):.4f} "
          f"ms (bound {b2:.4f}), golden_support_aggregate k={K} "
          f"{time_ms(lambda: golden_support_aggregate(st.X, g1, l1)):.4f} ms "
          f"(bound {b3:.4f})")
    del q1, c1, g1, l1

    # kernel 4: golden_aggregate (full-scan baseline)
    fk = golden_aggregate(q, st.X, sig2, st.x_norms)
    fr = ref.golden_aggregate_ref(q, st.X, sig2, st.x_norms)
    err = float((fk - fr).abs().max())
    check(err <= MEAN_ATOL,
          f"golden_aggregate: max abs error {err:.3g} > {MEAN_ATOL}")
    fd = golden_aggregate(q, st.X, 0.0, st.x_norms)     # degenerate sigma
    err_d = float((fd - st.X.mean(0)).abs().max())
    check(bool(torch.isfinite(fd).all()) and err_d <= MEAN_ATOL,
          f"golden_aggregate: sigma2=0 is not the data mean ({err_d:.3g})")
    inv = ref.finite_inv_two_sigma2(sig2)
    mask = (-inv * st.x_norms)[None, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(q[None, None], st.X[None, None], st.X[None, None],
                    attn_mask=mask, scale=2.0 * inv)[0, 0]

    lib_err = float((library() - fr).abs().max())
    b_ms, b_by = bound(4 * (N * D + N + 2 * B * D + B), 4 * B * N * D)
    results["golden_aggregate"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: golden_aggregate(q, st.X, sig2, st.x_norms)),
        plain_ms=time_ms(lambda: ref.golden_aggregate_ref(q, st.X, sig2,
                                                          st.x_norms)),
        bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(library))
    again, ranks = cluster_states(q, st.X, sig2, st.x_norms)
    check(torch.equal(again, fk), "golden_aggregate: two calls differ")
    check(bool(torch.equal(ranks, ranks[:, :1].expand_as(ranks))),
          "golden_aggregate: the CTAs of a cluster disagree")
    print(f"[check] golden_aggregate: max abs {err:.3g}; sigma2=0 -> data "
          f"mean to {err_d:.3g}; library call (scaled_dot_product_attention) "
          f"max abs {lib_err:.3g}; two calls bit-equal; the {ranks.shape[1]} "
          f"CTAs of each of {ranks.shape[0]} clusters hold bit-identical "
          f"(max, l) and first-tile weights")
    pass4 = split_line("golden_aggregate", results["golden_aggregate"]["ms"],
                       lambda: golden_aggregate(q, st.X, sig2, st.x_norms),
                       AGG_PARTS)["cluster pass"]
    print(f"[time] golden_aggregate cluster pass: {4 * N * D / pass4 / 1e9:.3f}"
          f" TB/s over the {4 * N * D / 1e6:.0f} MB store; the plain read "
          f"(X.sum(0)) {read_ms:.4f} ms, {read_rate:.3f} TB/s")
    q1 = q[:1].contiguous()
    b4_ms = bound(4 * (N * D + N + 2 * D + 1), 4 * N * D)[0]
    print(f"[time] golden_aggregate B=1: kernel "
          f"{time_ms(lambda: golden_aggregate(q1, st.X, sig2, st.x_norms)):.4f}"
          f" ms (bound {b4_ms:.4f})")
    gw = torch.Generator(device="cuda").manual_seed(7)
    xw = 0.3 * torch.randn(WIDE_N, WIDE_D, generator=gw, device="cuda")
    qw = xw[:B] + 0.1 * torch.randn(B, WIDE_D, generator=gw, device="cuda")
    xwn = (xw * xw).sum(-1)
    ew = float((golden_aggregate(qw, xw, 0.5, xwn)
                - ref.golden_aggregate_ref(qw, xw, 0.5, xwn)).abs().max())
    check(ew <= MEAN_ATOL, f"golden_aggregate D={WIDE_D}: max abs {ew:.3g}")
    bw_ms = bound(4 * (WIDE_N * WIDE_D + WIDE_N + 2 * B * WIDE_D + B),
                  4 * B * WIDE_N * WIDE_D)[0]
    print(f"[time] golden_aggregate B={B} N={WIDE_N} D={WIDE_D} (afhq_like "
          f"width, random store): kernel "
          f"{time_ms(lambda: golden_aggregate(qw, xw, 0.5, xwn)):.4f} ms "
          f"(bound {bw_ms:.4f}), plain "
          f"{time_ms(lambda: ref.golden_aggregate_ref(qw, xw, 0.5, xwn)):.4f}"
          f" ms, X.sum(0) {time_ms(lambda: xw.sum(0)):.4f} ms; max abs "
          f"{ew:.3g}")
    del xw, qw, xwn, q1, again, ranks

    # both aggregates again where the softmax is spread over many rows:
    # at t=500 it is nearly one-hot, at the first step (t=1000) it is not
    def spread(lg):
        """Mean effective number of rows, 1 / sum(w^2), over queries."""
        w = torch.softmax(lg, dim=-1)
        return float((1.0 / (w * w).sum(-1)).mean())

    for t_chk in (t_mid, 1000):
        a_c, sig2_c = ts.constants(t_chk)
        q_c = (a_c * st.X[rows] + float(sched.b[t_chk]) * eps) / a_c
        gold_c, gd2_c = ops.golden_rerank(
            q_c, st.X, ops.screen_topm(ts._proxy_query(q_c), st.proxy, M,
                                       x_norms=st.proxy_norms)[0],
            K, st.x_norms)
        lg_c = torch.clamp_min(-gd2_c / (2.0 * sig2_c), ref.NEG_INF)
        e3 = float((golden_support_aggregate(st.X, gold_c, lg_c)
                    - ref.golden_support_aggregate_ref(st.X, gold_c, lg_c)
                    ).abs().max())
        e4 = float((golden_aggregate(q_c, st.X, sig2_c, st.x_norms)
                    - ref.golden_aggregate_ref(q_c, st.X, sig2_c, st.x_norms)
                    ).abs().max())
        check(e3 <= MEAN_ATOL and e4 <= MEAN_ATOL,
              f"t={t_chk}: aggregate max abs errors {e3:.3g}, {e4:.3g}")
        full_lg = torch.clamp_min(-ref.pdist_ref(q_c, st.X, x_norms=st.x_norms)
                                  * ref.finite_inv_two_sigma2(sig2_c),
                                  ref.NEG_INF)
        results["golden_support_aggregate"]["max_abs_err"] = max(
            results["golden_support_aggregate"]["max_abs_err"], e3)
        results["golden_aggregate"]["max_abs_err"] = max(
            results["golden_aggregate"]["max_abs_err"], e4)
        print(f"[check] t={t_chk}: golden_support_aggregate max abs {e3:.3g} "
              f"(effective rows {spread(lg_c):.1f} of {K}); golden_aggregate "
              f"max abs {e4:.3g} (effective rows {spread(full_lg):.1f} of {N})")
    # kernel 5: screen_topm (streamed exact screen, no [B, N] matrix).
    # Integer data with a +inf-norm row: bit-equal to the plain carry loop
    # (sets, order, distances, the +inf slots' index 0), at both ends of
    # the schedule's m_t.
    xin_inf = xin.clone()
    xin_inf[7] = float("inf")
    for m in M_CHECKS:
        gk = screen_topm(qi, xi, m, qin, xin_inf)
        gr = screen_topm_scan(qi, xi, m, qin, xin_inf)
        check(torch.equal(gk[0], gr[0]) and torch.equal(gk[1], gr[1]),
              f"screen_topm: not bit-equal on integer data at m={m}")
        check(torch.equal(gk[0], ref.materialized_topm(
            ref.pdist_ref(qi, xi, qin, xin_inf), m)[0]),
              f"screen_topm: integer top-{m} differs from the materialized "
              f"screen")
    sc_times = {}
    for m in (M, M_LOW):
        gi, gv = screen_topm(qp, st.proxy, m, qpn, st.proxy_norms)
        wi, wv = screen_topm_scan(qp, st.proxy, m, qpn, st.proxy_norms)
        rel = rel_err(gv, wv)
        own = rel_err(torch.gather(d2r, -1, gi), gv)
        check(rel <= DIST_RTOL and own <= DIST_RTOL,
              f"screen_topm: m={m} relative errors {rel:.3g}, {own:.3g}")
        sc_times[m] = (
            time_ms(lambda: screen_topm(qp, st.proxy, m, qpn,
                                        st.proxy_norms)),
            time_ms(lambda: screen_topm_scan(qp, st.proxy, m, qpn,
                                             st.proxy_norms), iters=3),
            time_ms(lambda: torch.topk(torch.addmm(bias, qp, st.proxy.T,
                                                   alpha=-2.0), m,
                                       largest=False)))
        print(f"[check] screen_topm m={m}: integer bit-equal (sets, order, "
              f"+inf slots; also at m={M_CHECKS[2:]}); float max abs "
              f"{float((gv - wv).abs().max()):.3g}"
              f", max rel {rel:.3g}, own-row rel {own:.3g}, overlap "
              f"{overlap(gi, wi):.6f} (exact order {torch.equal(gi, wi)}); "
              f"kernel {sc_times[m][0]:.4f} ms, plain {sc_times[m][1]:.4f} "
              f"ms, library {sc_times[m][2]:.4f} ms")
        split_line(f"screen_topm m={m}", sc_times[m][0], lambda: screen_topm(
            qp, st.proxy, m, qpn, st.proxy_norms))
        if m == M:
            results["screen_topm"] = dict(max_abs_err=float(
                (gv - wv).abs().max()))
    b_ms, b_by = bound(4 * (B * DP + N * DP + B + N) + 12 * B * M,
                       2 * B * N * DP)
    results["screen_topm"].update(
        ms=sc_times[M][0], plain_ms=sc_times[M][1], bound_ms=b_ms,
        bound_by=b_by, library_ms=sc_times[M][2])

    # kernel 6: fused_candidates (one pass over proxy and store).  Integer
    # data: bit-equal to the plain carry loop, and its candidate list is
    # the streamed screen's; +inf rows in both stores.
    qfi, xfi = ints((B, D), 21), ints((N, D), 22)
    xfin = (xfi * xfi).sum(-1)
    xfin[11] = float("inf")
    for m in M_CHECKS:
        gk = fused_candidates(qi, qfi, xi, xfi, m, xin_inf, xfin)
        gr = fused_candidates_scan(qi, qfi, xi, xfi, m, xin_inf, xfin)
        check(torch.equal(gk[0], gr[0]) and torch.equal(gk[1], gr[1]),
              f"fused_candidates: not bit-equal on integer data at m={m}")
        check(torch.equal(gk[0], screen_topm(qi, xi, m, qin, xin_inf)[0]),
              f"fused_candidates: m={m} candidates differ from the screen's")
    del qfi, xfi, xfin, gk, gr
    fu_times = {}
    for m in (M, M_LOW):
        gi, gv = fused_candidates(qp, q, st.proxy, st.X, m, st.proxy_norms,
                                  st.x_norms)
        wi, wv = fused_candidates_scan(qp, q, st.proxy, st.X, m,
                                       st.proxy_norms, st.x_norms)
        own = rel_err(ref.support_sqdist_ref(q, st.X, st.x_norms, gi), gv)
        mean_err = float((fused_posterior(st.X, gi, gv, K, sig2)
                          - fused_posterior(st.X, wi, wv, K, sig2)
                          ).abs().max())
        check(own <= DIST_RTOL and mean_err <= MEAN_ATOL,
              f"fused_candidates: m={m} own-row rel {own:.3g}, posterior "
              f"mean max abs {mean_err:.3g}")
        fu_times[m] = (
            time_ms(lambda: fused_candidates(qp, q, st.proxy, st.X, m,
                                             st.proxy_norms, st.x_norms)),
            time_ms(lambda: fused_candidates_scan(
                qp, q, st.proxy, st.X, m, st.proxy_norms, st.x_norms),
                iters=3))
        same = gi == wi
        err = float((gv - wv)[same].abs().max())
        print(f"[check] fused_candidates m={m}: integer bit-equal (sets, "
              f"order, exact distances, +inf slots; also at m="
              f"{M_CHECKS[2:]}), candidates = the "
              f"screen's; float exact-d2 max abs {err:.3g} on equal slots, "
              f"own-row rel {own:.3g}, proxy overlap {overlap(gi, wi):.6f} "
              f"(exact order {bool(same.all())}), posterior mean max abs "
              f"{mean_err:.3g}; kernel {fu_times[m][0]:.4f} ms, plain "
              f"{fu_times[m][1]:.4f} ms")
        split_line(f"fused_candidates m={m}", fu_times[m][0],
                   lambda: fused_candidates(qp, q, st.proxy, st.X, m,
                                            st.proxy_norms, st.x_norms))
        if m == M:
            results["fused_candidates"] = dict(max_abs_err=max(err,
                                                               mean_err))
    b_ms, b_by = bound(4 * (N * D + N * DP + 2 * N + B * D + B * DP + 2 * B)
                       + 12 * B * M, 2 * B * N * (D + DP))
    results["fused_candidates"].update(
        ms=fu_times[M][0], plain_ms=fu_times[M][1], bound_ms=b_ms,
        bound_by=b_by, library_ms=None)

    # kernel 7 at both index shapes.  (a) Its distance stage alone
    # (ops.centroid_scan) with one +inf-norm padded window appended:
    # integer data bit-equal to the plain version (and the probe lists of
    # the stable sort), float data within DIST_RTOL, +inf windows +inf.
    gq = gst.X[:B] + 0.3 * torch.randn(
        B, GMM_DIM, generator=torch.Generator().manual_seed(40)).cuda()
    for label, q_c, ix in (("cifar_like", qp, cix), ("gmm", gq, gix)):
        w, dp = ix.centroids.shape
        qi_c, ci = ints((B, dp), 41), ints((w + 1, dp), 42)
        cni = (ci * ci).sum(-1)
        cni[-1] = float("inf")
        gk = centroid_scan(qi_c, ci, cni)
        gr = ref.centroid_scan_ref(qi_c, ci, cni)
        check(torch.equal(gk, gr) and bool(torch.isinf(gk[:, -1]).all()),
              f"centroid_scan: not bit-equal on integer data ({label})")
        check(torch.equal(torch.sort(gk, dim=-1, stable=True)[1],
                          torch.sort(gr, dim=-1, stable=True)[1]),
              f"centroid_scan: integer probe lists differ ({label})")
        cpad = torch.cat([ix.centroids, ix.centroids.new_zeros((1, dp))])
        cnpad = torch.cat([ix.centroid_norms,
                           ix.centroid_norms.new_full((1,), float("inf"))])
        qn_c = (q_c * q_c).sum(-1)
        fk = centroid_scan(q_c, cpad, cnpad)
        fr = ref.centroid_scan_ref(q_c, cpad, cnpad)
        check(bool(torch.isinf(fk[:, -1]).all()),
              f"centroid_scan: the padded window is not +inf ({label})")
        err = float((fk - fr)[:, :-1].abs().max())
        rel = rel_err(fk[:, :-1], fr[:, :-1])
        check(rel <= DIST_RTOL,
              f"centroid_scan: relative error {rel:.3g} > {DIST_RTOL} "
              f"({label})")
        probes_equal = torch.equal(torch.sort(fk, dim=-1, stable=True)[1],
                                   torch.sort(fr, dim=-1, stable=True)[1])
        cbias = qn_c[:, None] + cnpad[None, :]
        c_ms = time_ms(lambda: centroid_scan(q_c, cpad, cnpad))
        c_plain = time_ms(lambda: ref.centroid_scan_ref(q_c, cpad, cnpad))
        c_lib = time_ms(lambda: torch.addmm(cbias, q_c, cpad.T, alpha=-2.0))
        b_ms, b_by = bound(4 * (B * dp + (w + 1) * dp + B + (w + 1)
                                + B * (w + 1)), 2 * B * (w + 1) * dp)
        print(f"[check] centroid_scan {label} (B={B}, C={w}+1 padded, "
              f"d={dp}; kernel 7's distance stage alone): integer "
              f"bit-equal with equal probe lists, +inf window +inf; float "
              f"max abs {err:.3g}, max rel {rel:.3g}, probe order equal "
              f"{probes_equal}; kernel {c_ms:.4f} ms, bound {b_ms:.6f} ms "
              f"({b_by}), plain {c_plain:.4f} ms, library (torch.addmm) "
              f"{c_lib:.4f} ms")

    # (b) The probe launch (ops.ivf_probe: pooling, distances, the stable
    # top-P windows and the CSR expansion in one launch) against its plain
    # version (ref.downsample_proxy + ref.ivf_probe_ref) on the same card
    # tensors: integer data bit-equal in every field at the indexed
    # step's P and at P = C (the last window padded, so it must come
    # last; split windows' duplicated centroids kept, so ties occur);
    # float data (the real centroids) with probe lists equal or each
    # difference a near-tie within DIST_RTOL, printed; timed against the
    # chain the launch replaced, rebuilt here (downsample_proxy, the
    # distances, a stable sort, the expansion, perm[pos], isfinite).  Its
    # distances come from this tree's distance stage, which sums the query
    # norms inside, so it makes 38 launches where the replaced chain made
    # 40; scripts/torch_index_times.py times an older tree's own chain.
    steps = [int(t) for t in sampling_timesteps(sched, STEPS)[:-1]]
    cix_eng = GoldDiffEngine(st, sched, indexed_cfg, index=cix,
                             probe_schedule=scale_probes)
    gix_eng = GoldDiffEngine(gst, sched, indexed_cfg, index=gix,
                             probe_schedule=scale_probes)
    probe_shapes = (
        ("cifar_like", q, st.image_shape, cix,
         max(cix_eng.nprobe(t) for t in steps)),
        ("gmm", gq, gst.image_shape, gix, gix_eng.nprobe(T_BUCKETS[0])))
    engine_fields = ("ids", "valid")

    def probe_kernel(qq, shape, ix, cents, cn, p, fields=ref.PROBE_FIELDS):
        return ops.ivf_probe(qq, shape, 4, cents, cn, ix.offsets, ix.perm,
                             ix.n, p, ix.max_cluster, fields=fields)

    def probe_plain(qq, shape, ix, cents, cn, p):
        qpp = ref.downsample_proxy(
            qq.reshape((qq.shape[0],) + tuple(shape)), 4)
        return ref.ivf_probe_ref(qpp, cents, cn, ix.offsets, ix.perm, ix.n,
                                 p, ix.max_cluster)

    def rebuilt_chain(qq, shape, ix, p):
        qpp = ref.downsample_proxy(
            qq.reshape((qq.shape[0],) + tuple(shape)), 4)
        cd2 = ops.centroid_scan(qpp, ix.centroids, ix.centroid_norms)
        probe = torch.sort(cd2, dim=-1, stable=True)[1][:, :p]
        starts, ends = ix.offsets[probe], ix.offsets[probe + 1]
        lane = torch.arange(ix.max_cluster, dtype=starts.dtype,
                            device=qq.device)
        pos = starts[..., None] + lane
        valid = (pos < ends[..., None]).reshape(qq.shape[0], -1)
        pos = torch.clamp_max(pos, ix.n - 1).reshape(qq.shape[0], -1)
        d2 = torch.where(valid, 0.0, float("inf"))
        return ix.perm[pos], torch.isfinite(d2)

    for label, q_c, shape, ix, p_step in probe_shapes:
        w, dp = ix.centroids.shape
        qi_c = ints((B,) + tuple(q_c.shape[1:]), 43)
        ci = ints((w, dp), 44).cpu()
        dup = (ix.centroids[1:] == ix.centroids[:-1]).all(-1).cpu()
        for j in torch.nonzero(dup).flatten().tolist():
            ci[j + 1] = ci[j]                       # split windows tie
        ci = ci.cuda()
        cni = (ci * ci).sum(-1)
        cni[-1] = float("inf")                      # a padded window
        for p in sorted({1, p_step, w}):
            got = probe_kernel(qi_c, shape, ix, ci, cni, p)
            want = probe_plain(qi_c, shape, ix, ci, cni, p)
            for field, g, r in zip(ref.PROBE_FIELDS, got, want):
                check(torch.equal(g, r), f"ivf_probe {label} P={p}: {field} "
                      f"not bit-equal on integer data")
            if p == w:
                check(bool((got.probe[:, -1] == w - 1).all()),
                      f"ivf_probe {label}: the padded window is not last")
        ties = int(dup.sum())
        got = probe_kernel(q_c, shape, ix, ix.centroids, ix.centroid_norms,
                           p_step)
        want = probe_plain(q_c, shape, ix, ix.centroids, ix.centroid_norms,
                           p_step)
        qpp = ref.downsample_proxy(q_c.reshape((B,) + tuple(shape)), 4)
        d2r = ref.centroid_scan_ref(qpp, ix.centroids, ix.centroid_norms)
        differ = got.probe != want.probe
        near = [(float(a), float(r)) for a, r in zip(
            torch.gather(d2r, 1, got.probe)[differ],
            torch.gather(d2r, 1, want.probe)[differ])]
        check(all(abs(a - r) <= DIST_RTOL * max(abs(r), 1.0)
                  for a, r in near),
              f"ivf_probe {label}: probe lists differ beyond near-ties "
              f"{near[:8]}")
        if not near:
            for field, g, r in zip(ref.PROBE_FIELDS, got, want):
                check(torch.equal(g, r), f"ivf_probe {label}: float {field} "
                      f"differs with equal probe lists")
        # the timed launch (the engine's fields) writes what the full one
        # wrote; its error is the reference distances of the windows it
        # chose against those the plain version chose (0: the same lists)
        timed = probe_kernel(q_c, shape, ix, ix.centroids, ix.centroid_norms,
                             p_step, engine_fields)
        check(torch.equal(timed.ids, got.ids)
              and torch.equal(timed.valid, got.valid),
              f"ivf_probe {label}: the engine's fields differ from the full "
              f"launch's")
        probe_err = float((torch.gather(d2r, 1, got.probe)
                           - torch.gather(d2r, 1, want.probe)).abs().max())
        slots = B * p_step * ix.max_cluster
        k_ms = time_ms(lambda: probe_kernel(
            q_c, shape, ix, ix.centroids, ix.centroid_norms, p_step,
            engine_fields))
        plain_ms = time_ms(lambda: probe_plain(
            q_c, shape, ix, ix.centroids, ix.centroid_norms, p_step))
        chain_ms = time_ms(lambda: rebuilt_chain(q_c, shape, ix, p_step))
        chain_names = kernel_names(lambda: rebuilt_chain(q_c, shape, ix,
                                                         p_step))
        new_names = kernel_names(lambda: probe_kernel(
            q_c, shape, ix, ix.centroids, ix.centroid_norms, p_step,
            engine_fields))
        check(len(new_names) == 1, f"ivf_probe {label}: {new_names}")
        d = q_c.shape[1]
        touched = int(torch.unique(got.pos[got.valid]).numel())
        b_ms, b_by = bound(4 * (B * d + w * dp + w) + 8 * (w + 1)
                           + 8 * touched + 9 * slots,
                           2 * B * w * dp + B * d)
        print(f"[check] ivf_probe {label} (B={B}, D={d}, W={w} windows, "
              f"d={dp}, L={ix.max_cluster}, P in {sorted({1, p_step, w})}; "
              f"{ties} split windows tie): integer bit-equal in probe, pos, "
              f"ids, valid and markers, the padded window last at P=W; "
              f"float at P={p_step}: probe lists equal {not near} "
              f"({len(near)} near-tie slots within {DIST_RTOL}: {near[:4]}), "
              f"the chosen windows' reference distances max abs "
              f"{probe_err:.3g}")
        print(f"[time] ivf_probe {label} P={p_step} ({slots} slots, the "
              f"engine's ids and validity): kernel {k_ms:.4f} ms in "
              f"{len(new_names)} launch, bound {b_ms:.6f} ms ({b_by}) plus "
              f"one launch's latency; plain {plain_ms:.4f} ms; the rebuilt "
              f"chain (the replaced ops, this tree's distance stage) "
              f"{chain_ms:.4f} ms device over {len(chain_names)} launches "
              f"({', '.join(chain_names)})")
        if label == "cifar_like":        # the indexed trajectory's shape
            results["centroid_scan"] = dict(
                max_abs_err=probe_err, ms=k_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
    p_all = gix.num_clusters              # serve_gmm_indexed's first step
    big = [time_ms(lambda: probe_kernel(
        gq, gst.image_shape, gix, gix.centroids, gix.centroid_norms, p_all,
        engine_fields)), time_ms(lambda: rebuilt_chain(
            gq, gst.image_shape, gix, p_all))]
    print(f"[time] ivf_probe gmm P={p_all} (every window, "
          f"{B * p_all * gix.max_cluster} slots): kernel {big[0]:.4f} ms, "
          f"the rebuilt chain {big[1]:.4f} ms device")

    for name, r in results.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"[time] {name}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {lib}")
    print("[check] kernels 1-7: " + ", ".join(f"{n} ok" for n in results))
    del d2k, d2r, bias, xi, int_cand

    # -- 5. policy: the engine's "cuda" constants -------------------------------
    # Fused vs staged step at B=16, N=50000 over m/N (k = m/2, the same
    # aggregate in both): where the fused step starts to win sets
    # GATHER_CROSSOVER_FRAC["cuda"].
    sweep = []
    for frac in SWEEP:
        m = int(frac * N)
        k = m // 2

        def staged():
            cand = ops.screen_topm(qp, st.proxy, m, x_norms=st.proxy_norms)[0]
            gid, gd = ops.golden_rerank(q, st.X, cand, k, st.x_norms)
            return ops.golden_support_aggregate(
                st.X, gid, torch.clamp_min(-gd / (2.0 * sig2), ref.NEG_INF))

        def fused():
            return ops.fused_step(q, qp, st.X, st.proxy, m, k, sig2,
                                  st.x_norms, st.proxy_norms)

        err = float((staged() - fused()).abs().max())
        check(err <= MEAN_ATOL, f"sweep m/N={frac}: fused vs staged {err:.3g}")
        t_s, t_f = time_ms(staged, iters=5), time_ms(fused, iters=5)
        sweep.append((frac, t_s, t_f))
        print(f"[crossover] m/N={frac} (m={m}, k={k}): staged step "
              f"{t_s:.4f} ms, fused step {t_f:.4f} ms, fused/staged "
              f"{t_f / t_s:.3f}, max abs {err:.3g}")
    wins = [i for i, (_, t_s, t_f) in enumerate(sweep) if t_f < t_s]
    if not wins:
        cross = 1.0
    elif wins[0] == 0:
        cross = sweep[0][0]
    else:
        (f0, s0, u0), (f1, s1, u1) = sweep[wins[0] - 1], sweep[wins[0]]
        cross = f0 + (f1 - f0) * (u0 - s0) / ((u0 - s0) - (u1 - s1))
    print(f"[crossover] fused beats staged from m/N = {cross:.4f} "
          f"(measured here); the engine's GATHER_CROSSOVER_FRAC['cuda'] = "
          f"{engine_mod.GATHER_CROSSOVER_FRAC['cuda']}")

    # Streamed vs materialized screen: time and peak device memory above
    # what was allocated before the call, at B=16 and B=256.
    for bq in (16, 256):
        gq = torch.Generator().manual_seed(30 + bq)
        rows_q = torch.randint(0, N, (bq,), generator=gq).cuda()
        q_b = st.X[rows_q] + (float(sched.b[t_mid]) / a) * torch.randn(
            bq, D, generator=gq).cuda()
        qp_b = ts._proxy_query(q_b)
        got = {}
        for stream in (False, True):
            def call():
                return ops.screen_topm(qp_b, st.proxy, M,
                                       x_norms=st.proxy_norms, stream=stream)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            got[stream] = (out, peak, time_ms(call))
        (_, dm), pm, tm = got[False]
        (_, ds), ps, tst = got[True]
        rel = rel_err(ds, dm)
        check(rel <= DIST_RTOL, f"B={bq}: streamed vs materialized {rel:.3g}")
        print(f"[screen-memory] B={bq}, N={N}, m={M}: materialized "
              f"{tm:.4f} ms, peak {pm / 2**20:.1f} MiB; streamed {tst:.4f} "
              f"ms, peak {ps / 2**20:.1f} MiB; [B, N] fp32 matrix "
              f"{4 * bq * N / 2**20:.1f} MiB; distances max rel {rel:.3g}")
    del q_b, qp_b, got, out

    auto_fused = ts.use_fused(1000)
    auto_stream = ts.use_stream(B)
    route = "fused" if auto_fused else ("streamed" if auto_stream
                                        else "staged")
    print(f"[policy] B={B}, N={N}: fused='auto' -> {auto_fused} (m_max/N "
          f"{ts.cfg.sizes(N)[1] / N} vs crossover {ts.crossover_frac}), "
          f"screen='auto' -> streamed {auto_stream} (budget "
          f"{ts._screen_budget} bytes; streamed at B=256: "
          f"{ts.use_stream(256)}); the auto serve route is '{route}'")

    # -- index: the reference's indexed configuration on the gmm store ----------
    # Which buckets index_mode="auto" serves through the index, recall@m_t
    # of the indexed candidates against the exact screen (gated), and the
    # coarse and denoise times of both (recorded, not gated).
    geng = gix_eng
    gexact = GoldDiffEngine(gst, sched, indexed_cfg)
    x0 = gst.X[:B]
    for t in T_BUCKETS:
        m_t, k_t = geng.sizes(t)
        a_t = float(sched.a[t])
        eps_t = torch.randn(B, GMM_DIM, generator=torch.Generator(
            ).manual_seed(t)).cuda()
        q_t = (a_t * x0 + float(sched.b[t]) * eps_t) / a_t
        exact = geng.coarse(q_t, m_t)
        t_exact = time_ms(lambda: geng.coarse(q_t, m_t))
        w_exact = wall_ms(lambda: geng.coarse(q_t, m_t))
        line = (f"[index] gmm N={GMM_N} t={t}: m_t={m_t} k_t={k_t} nprobe="
                f"{geng.nprobe(t)} of {gix.num_clusters} windows, padded "
                f"candidates {geng.padded_m(t)} ({geng.padded_m(t) / GMM_N:.4f}"
                f" of N); exact coarse {t_exact:.4f} ms device, "
                f"{w_exact:.4f} ms wall")
        if geng.use_index(t):
            mp, p_t = geng.padded_m(t), geng.nprobe(t)
            pos, pd2 = geng.coarse_indexed(q_t, mp, p_t)
            recall = screening_recall(pos, pd2, gix.perm, exact)
            check(recall >= RECALL_MIN,
                  f"[index] t={t}: recall@m_t {recall:.4f} < {RECALL_MIN}")
            t_idx = time_ms(lambda: geng.coarse_indexed(q_t, mp, p_t))
            w_idx = wall_ms(lambda: geng.coarse_indexed(q_t, mp, p_t))
            line += (f", served by the index: indexed coarse {t_idx:.4f} ms "
                     f"device, {w_idx:.4f} ms wall (exact/indexed "
                     f"{t_exact / t_idx:.2f}x device, {w_exact / w_idx:.2f}x "
                     f"wall), recall@m_t {recall:.4f}")
        else:
            line += ", served by the exact screen (auto)"
        print(line)
    t = T_BUCKETS[-1]
    a_t = float(sched.a[t])
    x_t = a_t * x0 + float(sched.b[t]) * torch.randn(
        B, GMM_DIM, generator=torch.Generator().manual_seed(77)).cuda()
    d_idx, d_ex = geng.denoise(x_t, t), gexact.denoise(x_t, t)
    s_idx = time_ms(lambda: geng.denoise(x_t, t))
    s_ex = time_ms(lambda: gexact.denoise(x_t, t))
    ws_idx = wall_ms(lambda: geng.denoise(x_t, t))
    ws_ex = wall_ms(lambda: gexact.denoise(x_t, t))
    print(f"[index] gmm t={t} denoise step (indexed {geng.use_index(t)}): "
          f"indexed {s_idx:.4f} ms device, {ws_idx:.4f} ms wall; exact "
          f"{s_ex:.4f} ms device, {ws_ex:.4f} ms wall (exact/indexed "
          f"{s_ex / s_idx:.2f}x device, {ws_ex / ws_idx:.2f}x wall); "
          f"posterior means differ by max abs "
          f"{float((d_idx - d_ex).abs().max()):.3g}")

    # -- 6. serve: each route, counted -----------------------------------------
    kernels = {"pdist": pdist, "support_sqdist": support_sqdist,
               "golden_support_aggregate": golden_support_aggregate,
               "golden_aggregate": golden_aggregate,
               "screen_topm": screen_topm,
               "fused_candidates": fused_candidates,
               "centroid_scan": centroid_scan,
               "flash_attention": flash_attention,
               "golden_attention_decode": golden_attention_decode}
    route_kernels = {
        "staged": ("pdist", "support_sqdist", "golden_support_aggregate"),
        "streamed": ("screen_topm", "support_sqdist",
                     "golden_support_aggregate"),
        "fused": ("fused_candidates", "golden_support_aggregate"),
        "indexed": ("centroid_scan", "support_sqdist",
                    "golden_support_aggregate"),
        "full_scan": ("golden_aggregate",)}

    def expected(which: str, n: int) -> dict:
        return {k: n if k in route_kernels[which] else 0 for k in kernels}

    def counted(fn):
        """Run ``fn`` with every count set to 0 just before; return its
        result, the wall seconds and the counts just after."""
        for kfn in kernels.values():
            kfn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {n: f.launches
                                               for n, f in kernels.items()}

    reqs = [Request(i, B, seed=100 + i) for i in range(3)]
    path_counts = {}
    static_srv = {"serve": eng}               # the [plan] phase serves these
    for label, srv, want_route in (
            ("serve", eng, route),
            ("serve_fused", ServeEngine(st, num_steps=STEPS, max_batch=B,
                                        fused=True, mode="static"),
             "fused")):
        srv.serve([Request(99, B, seed=99)])     # warm-up wave, not counted
        served, total, counts = counted(lambda: srv.serve(reqs))
        for r in served:
            check(r.images.shape == (B, 32, 32, 3),
                  f"{label} request {r.request_id}: shape {r.images.shape}")
            check(bool(torch.isfinite(torch.from_numpy(r.images)).all()),
                  f"{label} request {r.request_id}: non-finite images")
        waves = len(served)
        check(counts == expected(want_route, STEPS * waves),
              f"{label} ({want_route} route): launches {counts} in {waves} "
              f"waves")
        path_counts[label] = counts
        print(f"[serve] {label} ({want_route} route): {waves} waves of {B} "
              f"images, {STEPS} steps: wave latency "
              + ", ".join(f"{r.latency_s * 1e3:.1f} ms" for r in served)
              + f"; {B * waves / total:.1f} images/s; launches {counts}")

    # the indexed path: (a) a cifar_like trajectory with every step
    # indexed, (b) indexed waves on the gmm store, (c) cifar_like waves
    # on index_mode="auto", which must screen every step exactly
    x_T = eng._init_noise([(reqs[0], 0, B)], B)
    full = OptimalDenoiser(st, sched)
    den_ix = GoldDiff(full, indexed_cfg, index=cix,
                      probe_schedule=scale_probes)
    ixe = den_ix.engine
    check(all(ixe.use_index(t) for t in steps),
          f"indexed trajectory: use_index {[ixe.use_index(t) for t in steps]}")
    sample(den_ix, sched, (B, D), num_steps=STEPS, x_init=x_T)   # warm-up
    _, dt, counts = counted(lambda: sample(den_ix, sched, (B, D),
                                           num_steps=STEPS, x_init=x_T))
    check(counts == expected("indexed", STEPS),
          f"indexed trajectory launches {counts}")
    path_counts["indexed"] = counts
    print(f"[serve] indexed trajectory (cifar_like N={N}, D={D}, "
          f"INDEXED_CFG, SCALE_PROBES, W={cix.num_clusters}, L="
          f"{cix.max_cluster}): nprobe_t {[ixe.nprobe(t) for t in steps]}, "
          f"re-ranked rows per query {[ixe.padded_m(t) for t in steps]}, "
          f"m_t {[ixe.sizes(t)[0] for t in steps]}; {dt * 1e3:.2f} ms; "
          f"launches {counts}")
    # one indexed step's launches, read from the profiler: the step's
    # selection must be kernel 7's probe launch and then exactly the
    # re-rank's launches (kernel 2 and its sort) on the probe's output
    t1 = steps[0]
    q1 = x_T / float(sched.a[t1])
    p1 = ixe.nprobe(t1)
    pr1 = ixe.probe(q1, p1)
    level1 = kernel_names(lambda: ixe.probe(q1, p1))
    rerank = kernel_names(lambda: ops.golden_rerank(
        q1, st.X, pr1.ids, min(ixe.sizes(t1)[1], ixe.padded_m(t1)),
        x_norms=st.x_norms, valid=pr1.valid))
    sel_names = kernel_names(lambda: ixe._select_body(q1, t1))
    check(len(level1) == 1 and "ivf_probe_kernel" in level1[0]
          and sel_names == level1 + rerank,
          f"indexed step: level 1 {level1}, re-rank {rerank}, selection "
          f"{sel_names}")
    chain_level1 = kernel_names(lambda: rebuilt_chain(q1, st.image_shape,
                                                      cix, p1))
    step_names = kernel_names(lambda: ixe.denoise(x_T, t1))
    print(f"[profile] indexed step t={t1} (profiler): {len(level1)} launch "
          f"from the rescaled q to the ids and validity kernel 2 takes "
          f"({level1[0]}), then the re-rank's {len(rerank)} "
          f"({', '.join(rerank)}); the rebuilt chain on the same q "
          f"{len(chain_level1)} launches; the whole step {len(step_names)} "
          f"launches: {', '.join(step_names)}")
    for label, srv, want_route in (
            ("serve_gmm_indexed",
             ServeEngine(gst, num_steps=STEPS, max_batch=B,
                         gd_cfg=indexed_cfg, index=gix,
                         index_mode="always", mode="static"), "indexed"),
            ("serve_cifar_auto_index",
             ServeEngine(st, num_steps=STEPS, max_batch=B,
                         gd_cfg=indexed_cfg, index=cix, mode="static"),
             "staged")):
        static_srv[label] = srv
        srv.serve([Request(99, B, seed=99)])     # warm-up wave, not counted
        served, total, counts = counted(lambda: srv.serve(reqs))
        for r in served:
            check(r.images.shape == (B,) + srv.store.image_shape,
                  f"{label} request {r.request_id}: shape {r.images.shape}")
            check(bool(torch.isfinite(torch.from_numpy(r.images)).all()),
                  f"{label} request {r.request_id}: non-finite images")
        waves = len(served)
        check(counts == expected(want_route, STEPS * waves),
              f"{label} ({want_route} route): launches {counts}")
        path_counts[label] = counts
        se = srv.engine
        print(f"[serve] {label} ({want_route} route): {waves} waves of {B}: "
              f"wave latency " + ", ".join(f"{r.latency_s * 1e3:.1f} ms"
                                           for r in served)
              + f"; {B * waves / total:.1f} images/s; use_index per step "
              f"{[se.use_index(t) for t in steps]}; nprobe_t "
              f"{[se.nprobe(t) for t in steps]}; launches {counts}")

    # -- 7. baseline: every route from one x_T, each counted alone -------------
    dens = {"staged": GoldDiff(full, screen="materialized", fused=False),
            "streamed": GoldDiff(full, screen="streamed", fused=False),
            "fused": GoldDiff(full, fused=True),
            "indexed": den_ix,
            "exact_indexed_cfg": GoldDiff(full, indexed_cfg),
            "full_scan": full}
    route_of = dict({w: w for w in dens}, exact_indexed_cfg="staged")
    times = {w: [] for w in dens}
    outs = {}
    for which in ("staged", "fused", "full_scan", "streamed", "indexed",
                  "exact_indexed_cfg", "exact_indexed_cfg", "indexed",
                  "streamed", "full_scan", "fused", "staged"):
        outs[which], dt, added = counted(lambda: sample(
            dens[which], sched, (B, D), num_steps=STEPS, x_init=x_T))
        times[which].append(dt)
        check(added == expected(route_of[which], STEPS),
              f"{which} trajectory launches {added}")
        check(bool(torch.isfinite(outs[which]).all()),
              f"{which} trajectory not finite")
        path_counts.setdefault(which, added)
    best = {w: min(v) for w, v in times.items()}
    for which in ("streamed", "fused"):
        err = float((outs[which] - outs["staged"]).abs().max())
        check(err <= TRAJ_TOL, f"{which} vs staged trajectory {err:.3g}")
    diff = (outs["staged"] - outs["full_scan"]).abs()
    print(f"[baseline] B={B} N={N} {STEPS} steps: " + ", ".join(
        f"{w} {best[w] * 1e3:.2f} ms (runs "
        f"{[round(t * 1e3, 2) for t in times[w]]})" for w in dens)
        + f"; staged/full-scan {best['staged'] / best['full_scan']:.3f}, "
        f"fused/full-scan {best['fused'] / best['full_scan']:.3f}, "
        f"streamed/full-scan {best['streamed'] / best['full_scan']:.3f}; "
        f"fused and streamed within {TRAJ_TOL} of staged; "
        f"|staged - full scan| max {float(diff.max()):.3g}, mean "
        f"{float(diff.mean()):.3g}")
    diff_ix = (outs["indexed"] - outs["exact_indexed_cfg"]).abs()
    print(f"[baseline] indexed {best['indexed'] * 1e3:.2f} ms vs exact staged "
          f"at the same INDEXED_CFG {best['exact_indexed_cfg'] * 1e3:.2f} ms "
          f"(indexed/exact {best['indexed'] / best['exact_indexed_cfg']:.3f}, "
          f"indexed/full-scan {best['indexed'] / best['full_scan']:.3f}); "
          f"|indexed - exact| max {float(diff_ix.max()):.3g}, mean "
          f"{float(diff_ix.mean()):.3g} (cifar_like does not cluster: not "
          f"gated)")
    # where the time goes: device time by kernel over one trajectory each.
    # The idle share is taken against the unprofiled wall time of the same
    # trajectory above: the profiler's own host work widens the gaps.
    for which in ("staged", "fused", "streamed", "indexed",
                  "exact_indexed_cfg", "full_scan"):
        profile_line(which, best[which] * 1e3, lambda: sample(
            dens[which], sched, (B, D), num_steps=STEPS, x_init=x_T))

    # -- 7b. plan: plan-mode serving, one CUDA graph a (plan x batch) bucket ---
    t_phase = time.perf_counter()
    peng = ServeEngine(st, num_steps=STEPS, max_batch=B)
    pe, plan = peng.engine, peng.plan
    check(peng.mode == "plan", f"ServeEngine(auto) serves {peng.mode}")
    p_route = ("fused" if pe._fused_masked(False) else
               "streamed" if pe.use_stream(B) else "staged")
    for line in plan.describe().splitlines():
        print(f"[plan] {line}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res0, alloc0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    stats = peng.warmup()
    torch.cuda.empty_cache()       # what stays reserved is what graphs hold
    pool_res = torch.cuda.memory_reserved() - res0
    pool_alloc = torch.cuda.memory_allocated() - alloc0
    n_graphs = len(stats["batch_buckets"]) * plan.num_buckets
    check(stats["programs_compiled"] == pe._captures == n_graphs,
          f"[plan] warmup: {stats} with {pe._captures} captures")
    print(f"[plan] warmup: {pe._captures} CUDA graphs captured (batch "
          f"buckets {stats['batch_buckets']} x {plan.num_buckets} plan "
          f"buckets) in {stats['warmup_s']:.2f} s; device memory held after "
          f"warmup (empty_cache before and after): {pool_res / 2**20:.1f} "
          f"MiB more reserved (the shared graph pool, the static buffers), "
          f"{pool_alloc / 2**20:.1f} MiB more allocated (the static "
          f"buffers)")
    builds = pe._builds
    waves_of = {}
    for label, srv, want in (("static", eng, route), ("plan", peng, p_route),
                             ("plan", peng, p_route),
                             ("static", eng, route)):
        served, total, counts = counted(lambda: srv.serve(reqs))
        check(all(r.images.shape == (B, 32, 32, 3) and bool(torch.isfinite(
            torch.from_numpy(r.images)).all()) for r in served),
              f"[plan] {label} waves: shapes or non-finite images")
        check(counts == expected(want, STEPS * len(served)),
              f"[plan] {label} waves ({want} route): launches {counts}")
        waves_of.setdefault(label, []).append(
            ([r.latency_s * 1e3 for r in served], B * len(served) / total))
        path_counts.setdefault(f"{label}_serve", counts)
    check(pe._builds == builds and pe._captures == n_graphs,
          f"[plan] serving after warmup built {pe._builds - builds} programs")
    for label, runs in waves_of.items():
        print(f"[plan] {label} serve, {p_route if label == 'plan' else route}"
              f" route, 3 waves of {B} images x {STEPS} steps, two runs: "
              + "; ".join("wave latency " + ", ".join(f"{v:.2f}" for v in w)
                          + f" ms, {ips:.1f} images/s" for w, ips in runs)
              + (f"; launches {path_counts['plan_serve']}, 0 captures after "
                 f"warmup" if label == "plan" else ""))

    def plan_run(gd, pln, x):
        e = gd.engine
        return sample_plan(gd.call_masked, sched, tuple(x.shape), pln,
                           x_init=x, program_cache=e.program, jitter=e.jitter)

    def replay_vs_eager(gd, pln, x, label):
        """Each segment's graph against the same segment run eagerly;
        returns the eager trajectory and each bucket's entry state."""
        entries = []
        for bucket in pln.buckets:
            entries.append(x)
            seg = plan_segment(gd.call_masked, sched, pln, bucket)
            graph = gd.engine._programs.get(plan_segment_key(
                pln, bucket, tuple(x.shape), "float32", 3.0))
            check(graph is not None, f"[plan] {label}: no graph for {bucket}")
            got, want = graph(x), seg(x)
            check(torch.equal(got, want),
                  f"[plan] {label} steps [{bucket.start}, {bucket.stop}): "
                  f"graph replay differs from eager by "
                  f"{float((got - want).abs().max()):.3g}")
            x = want
        return x, entries

    def counted_kernels(fn):
        """The counts ``fn`` adds and the device kernels the profiler
        sees it run, by name, less copies and memsets."""
        for kfn in kernels.values():
            kfn.launches = 0
        _, names = device_kernels(fn)
        return ({n: f.launches for n, f in kernels.items()},
                Counter(n for n in names if n not in copy_names
                        and not n.startswith(("Memcpy", "Memset"))))

    def replay_measured(gd, pln, x, label):
        """The counts a replayed plan trajectory adds hold what the card
        ran: its device kernels equal, name for name, those of the same
        segments run eagerly, where each wrapper counts at its launch,
        and its counts equal that eager run's."""
        segs = [plan_segment(gd.call_masked, sched, pln, b)
                for b in pln.buckets]

        def eager():
            y = x
            for seg in segs:
                y = seg(y)
            return y
        e_counts, e_names = counted_kernels(eager)
        r_counts, r_names = counted_kernels(lambda: plan_run(gd, pln, x))
        check(r_names == e_names and r_counts == e_counts,
              f"[plan] {label}: replay counts {r_counts}, device kernels "
              f"{dict(r_names)}; eager counts {e_counts}, device kernels "
              f"{dict(e_names)}")
        print(f"[plan] {label}: one replayed trajectory ran, by the "
              f"profiler, the device kernels of the eager segments "
              f"({sum(e_names.values())} launches of {len(e_names)} kernels,"
              f" copies and memsets aside); its counts equal the eager "
              f"run's wrapper counts: "
              f"{ {n: c for n, c in r_counts.items() if c} }")

    def masked_fused_vs_plain(pln, entries):
        """Kernels 6 and 3 as each bucket's fused masked step calls them
        at its first step, on that step's input: kernel 6 at m = m_cap
        against the plain carry loop, kernel 3 at k = min(k_cap, m_cap)
        with the m_t and k_t masks against the plain aggregate."""
        ps = pe.store
        for bucket, x in zip(pln.buckets, entries):
            t = int(pln.ts[bucket.start])
            m_cap, k_cap, p_cap, use_ix = pe._masked_caps(bucket.caps)
            m_t, k_t, _, a, sig2 = (None if v is None else v[t] for v in
                                    pe._masked_table(m_cap, k_cap, p_cap,
                                                     use_ix))
            k = min(k_cap, m_cap)
            q = x / a
            qp = pe._proxy_query(q)
            gi, gv = fused_candidates(qp, q, ps.proxy, ps.X, m_cap,
                                      ps.proxy_norms, ps.x_norms)
            wi, wv = fused_candidates_scan(qp, q, ps.proxy, ps.X, m_cap,
                                           ps.proxy_norms, ps.x_norms)
            own = rel_err(ref.support_sqdist_ref(q, ps.X, ps.x_norms, gi),
                          gv)
            mean_err = float((fused_posterior(ps.X, gi, gv, k, sig2, m_t, k_t)
                              - fused_posterior(ps.X, wi, wv, k, sig2, m_t,
                                                k_t)).abs().max())
            live = torch.arange(m_cap, device=gv.device) < m_t
            vals, pos = torch.sort(torch.where(live, gv, float("inf")),
                                   dim=-1, stable=True)
            gid = torch.gather(gi, -1, pos[:, :k]).contiguous()
            lg = torch.clamp_min(-vals[:, :k] / (2.0 * sig2), ref.NEG_INF)
            lg = torch.where(torch.arange(k, device=lg.device) < k_t, lg,
                             ref.NEG_INF).contiguous()
            agg_err = float((golden_support_aggregate(ps.X, gid, lg)
                             - ref.golden_support_aggregate_ref(ps.X, gid, lg)
                             ).abs().max())
            check(own <= DIST_RTOL and mean_err <= MEAN_ATOL
                  and agg_err <= MEAN_ATOL,
                  f"[plan] t={t} masked fused step: fused_candidates m="
                  f"{m_cap} own-row rel {own:.3g}, posterior mean max abs "
                  f"{mean_err:.3g}; golden_support_aggregate k={k} max abs "
                  f"{agg_err:.3g}")
            for n, e in (("fused_candidates", mean_err),
                         ("golden_support_aggregate", agg_err)):
                results[n]["max_abs_err"] = max(results[n]["max_abs_err"], e)
            print(f"[plan] bucket [{bucket.start}, {bucket.stop}) at t={t} "
                  f"(N={N}, B={x.shape[0]}): fused_candidates m={m_cap} vs "
                  f"the plain carry loop: own-row rel {own:.3g} (tolerance "
                  f"{DIST_RTOL}), masked posterior mean (m_t={int(m_t)}, "
                  f"k_t={int(k_t)}) max abs {mean_err:.3g}; "
                  f"golden_support_aggregate k={k} with the NEG_INF masks vs "
                  f"the plain aggregate max abs {agg_err:.3g} (tolerance "
                  f"{MEAN_ATOL})")

    copy_names = set(kernel_names(lambda: (x_T.clone(),
                                           torch.empty_like(x_T).copy_(x_T))))
    x_plan = plan_run(peng.denoiser, plan, x_T)
    x_eager, entries = replay_vs_eager(peng.denoiser, plan, x_T, "auto")
    replay_measured(peng.denoiser, plan, x_T, "auto plan")
    check(p_route == "fused", f"[plan] auto serves the {p_route} route")
    masked_fused_vs_plain(plan, entries)
    check(torch.equal(x_plan, x_eager), "[plan] chained replays != eager")
    x_static = sample(eng.denoiser, sched, (B, D), num_steps=STEPS,
                      x_init=x_T)
    err = float((x_plan - x_static).abs().max())
    check(err <= TRAJ_TOL, f"[plan] plan vs static trajectory {err:.3g}")
    print(f"[plan] graph replays bit-equal to the eager segments "
          f"({plan.num_buckets} buckets at B={B}); plan vs static trajectory "
          f"max abs {err:.3g} (tolerance {TRAJ_TOL})")

    # the indexed plan at INDEXED_CFG + SCALE_PROBES
    ix_plan = build_plan(ixe, STEPS)
    for line in ix_plan.describe().splitlines():
        print(f"[plan] indexed: {line}")
    t0 = time.perf_counter()
    plan_run(den_ix, ix_plan, x_T)                    # captures
    cap_s = time.perf_counter() - t0
    x_ixp, dt, counts = counted(lambda: plan_run(den_ix, ix_plan, x_T))
    check(counts == expected("indexed", STEPS),
          f"[plan] indexed plan launches {counts}")
    replay_vs_eager(den_ix, ix_plan, x_T, "indexed")
    replay_measured(den_ix, ix_plan, x_T, "indexed plan")
    err = float((x_ixp - outs["indexed"]).abs().max())
    check(err <= TRAJ_TOL, f"[plan] indexed plan vs static {err:.3g}")
    path_counts["plan_indexed"] = counts
    print(f"[plan] indexed plan: {ix_plan.num_buckets} graphs captured in "
          f"{cap_s:.2f} s (with one eager run each); trajectory {dt * 1e3:.2f}"
          f" ms; replays bit-equal to eager; vs the static indexed trajectory "
          f"max abs {err:.3g}; launches {counts}")
    gsrv = ServeEngine(gst, num_steps=STEPS, max_batch=B, gd_cfg=indexed_cfg,
                       index=gix, index_mode="always")
    gstats = gsrv.warmup()
    for label, srv in (("static", static_srv["serve_gmm_indexed"]),
                       ("plan", gsrv), ("plan", gsrv),
                       ("static", static_srv["serve_gmm_indexed"])):
        served, total, counts = counted(lambda: srv.serve(reqs))
        check(counts == expected("indexed", STEPS * len(served)),
              f"[plan] gmm {label} waves launches {counts}")
        check(all(bool(torch.isfinite(torch.from_numpy(r.images)).all())
                  for r in served), f"[plan] gmm {label}: non-finite")
        print(f"[plan] gmm index_mode='always' {label} serve: wave latency "
              + ", ".join(f"{r.latency_s * 1e3:.2f}" for r in served)
              + f" ms, {B * len(served) / total:.1f} images/s"
              + (f" ({gstats['programs_compiled']} graphs captured in "
                 f"{gstats['warmup_s']:.2f} s, {gsrv.plan.num_buckets} plan "
                 f"buckets)" if label == "plan" else ""))

    # where the time goes: plan (graph replays) against static, one call,
    # on the auto route at B=16, 4, 1 and on the indexed route at B=16
    for b, gd_plan, gd_static in ((B, (peng.denoiser, plan), eng.denoiser),
                                  (4, (peng.denoiser, plan), eng.denoiser),
                                  (1, (peng.denoiser, plan), eng.denoiser),
                                  (B, (den_ix, ix_plan), den_ix)):
        xb = x_T[:b].contiguous()
        tag = "indexed" if gd_static is den_ix else p_route
        fns = {f"plan {tag}": lambda: plan_run(*gd_plan, xb),
               f"static {tag}": lambda: sample(gd_static, sched, (b, D),
                                               num_steps=STEPS, x_init=xb)}
        walls = {label: [] for label in fns}
        for label in (f"static {tag}", f"plan {tag}", f"plan {tag}",
                      f"static {tag}"):
            walls[label].append(wall_ms(fns[label], iters=10))
        for label, fn in fns.items():
            print(f"[plan] B={b} {label} trajectory walls (mean of 10, in "
                  f"turns): {', '.join(f'{w:.3f}' for w in walls[label])} ms")
            profile_line(f"{label} trajectory B={b}", min(walls[label]), fn)
    check(pe._captures == n_graphs, "[plan] profiling captured a graph")
    print(f"[plan] phase {time.perf_counter() - t_phase:.1f} s")
    # each kernel's launches come from an eager run of the route that owns
    # it, where the wrappers count at their launches (a replay adds the
    # counts its capture recorded; replay_measured holds those to the card)
    path_of = {"pdist": "staged", "support_sqdist": "staged",
               "golden_support_aggregate": "serve_fused",
               "golden_aggregate": "full_scan", "screen_topm": "streamed",
               "fused_candidates": "serve_fused",
               "centroid_scan": "indexed"}
    for n, p in path_of.items():
        check(path_counts[p][n] > 0, f"{n} never launched on the {p} path")


    # -- 8. reference: small store, card against CPU plain versions ------------
    small = make_dataset("cifar_like", n=2048, seed=1, device="cpu")
    small_ix = build_index(small)                # on the CPU, moved over
    x0 = (float(sched.b[1000]) * torch.randn(
        B, small.dim, generator=torch.Generator().manual_seed(5)))
    for label, kw in (("golddiff auto", {}),
                      ("golddiff staged", dict(screen="materialized",
                                               fused=False)),
                      ("golddiff fused", dict(fused=True)),
                      ("golddiff streamed", dict(screen="streamed",
                                                 fused=False)),
                      ("golddiff indexed", dict(
                          cfg=indexed_cfg, index=small_ix,
                          probe_schedule=scale_probes, index_mode="always")),
                      ("full_scan", None),
                      ("plan auto", {}),
                      ("plan indexed", dict(
                          cfg=indexed_cfg, index=small_ix,
                          probe_schedule=scale_probes, index_mode="always"))):
        def build(dev):
            den = OptimalDenoiser(small, sched, device=dev)
            return den if kw is None else GoldDiff(den, **kw)

        def traj(dev):
            den = build(dev)
            if not label.startswith("plan"):
                return sample(den, sched, (B, small.dim), x_init=x0).cpu()
            return plan_run(den, build_plan(den.engine, STEPS),
                            x0.to(dev)).cpu()
        t0 = time.perf_counter()
        got, want = traj("cuda"), traj("cpu")
        ref_s = time.perf_counter() - t0
        err = float((got - want).abs().max())
        check(err <= TRAJ_TOL, f"reference {label}: card vs CPU {err:.3g}")
        print(f"[reference] {label}: N=2048, {STEPS} steps, card vs CPU "
              f"plain versions max abs {err:.3g} (tolerance {TRAJ_TOL}; "
              f"{ref_s:.1f} s)")

    # -- 9. the reduced-LLM slice: prefill and golden decode ------------------
    llm_results, path_counts["llm_decode"] = llm_phases(kernels)
    results.update(llm_results)
    path_of.update(flash_attention="llm_decode",
                   golden_attention_decode="llm_decode")

    sources = {"pdist": ("csrc/pdist.cu", "src/repro/kernels/pdist.py:61"),
               "support_sqdist": ("csrc/support_sqdist.cu",
                                  "src/repro/kernels/golden_rerank.py:66"),
               "golden_support_aggregate": (
                   "csrc/golden_support_aggregate.cu",
                   "src/repro/kernels/golden_support_aggregate.py:78"),
               "golden_aggregate": ("csrc/golden_aggregate.cu",
                                    "src/repro/kernels/golden_aggregate.py:93"),
               "screen_topm": ("csrc/screen_topm.cu",
                               "src/repro/kernels/screen.py:151"),
               "fused_candidates": ("csrc/fused_candidates.cu",
                                    "src/repro/kernels/fused_step.py:178"),
               "centroid_scan": ("csrc/centroid_scan.cu",
                                 "src/repro/kernels/centroid_scan.py:65"),
               "flash_attention": ("csrc/flash_attention_sm90.cu",
                                   "src/repro/kernels/flash_attention.py:85"),
               "golden_attention_decode": (
                   "csrc/golden_attention.cu",
                   "src/repro/kernels/golden_attention.py:85")}
    line = {"kernels": [
        dict(name=n, route="cuda",
             source=f"src/repro_torch/kernels/{sources[n][0]}",
             replaces=sources[n][1], path=path_of[n],
             launches=path_counts[path_of[n]][n], **results[n])
        for n in kernels]}
    for n in ("flash_attention", "golden_attention_decode"):
        check(path_counts["llm_decode"][n] > 0,
              f"{n} never launched on the llm_decode path")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
