#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Phases:
  1. environment: the card, CUDA, nvcc and triton; TF32 off;
  2. build: the nine hand-written kernels and the attention backward
     from ``src/repro_torch/kernels/csrc`` (twelve sources: kernel 9 and
     the backward each have a bf16 tensor-core source and an fp32
     CUDA-core one), with the registers, shared memory and spills of
     each instance of the redesigned kernels (1-6, 8-9) and of the
     backward;
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
  7c. bf16 (``bf16_phase``): the engine with bf16 store rows
     (``storage_dtype=torch.bfloat16``): each of kernels 1-7's bf16
     instance against its plain version on the same bf16 rows at the
     main path's shapes (integer data bit-equal, floats within 1e-5 rel
     / 1e-4 abs), timed against its bf16 bound beside the fp32
     instance; the fp32 and bf16 trajectories of every route (full
     scan, fused, staged, streamed, indexed, the fused plan on CUDA
     graphs) from one x_T, each counted alone (a bf16 route launches
     only bf16 instances, each once a step), timed in turns and
     profiled; the static step's bf16-vs-fp32 error at t = 800, 400,
     100; the operands' bytes and a step's peak; strategy="measure";
  7d. the live store (``live_store_phase``): [lifecycle] the cifar_like
     store and its index laid out by ``StoreLifecycle.create`` (capacity-
     padded windows and spares), the create, append, commit and open
     (replay) seconds and bytes; kernels 1-7 against their plain
     versions on the padded operands (integer data bit-equal; no +inf-
     norm row or spare window ranks before a real one, none weighs);
     the padded indexed plan against the unpadded one from one x_T;
     [runtime] ``ServeRuntime`` over the padded plan-mode engine:
     warmup's graphs on two operand slots, 32 requests arriving two a
     scheduler step (p50/p99, images/s, host share, mixed segments), two
     hot swaps (one with a wave in flight: bit-equal to its old-epoch
     run; later deliveries bit-equal to a fresh eager engine; 0 builds
     and 0 captures), the seeded fault ladder, a NaN storm (the exact
     rung: kernel 1) and an evict storm (graphs recaptured and counted,
     the scan rung), every ticket done and finite; a fused=True engine's
     NaN storm (its exact rung: kernel 6 in captured graphs); the
     tracer's cost; the runtime path must launch kernels 2, 3, 7 and 5
     or 6;
  7f. the engine over a ProcessMesh (``pmesh_phase``): 2 gloo ranks
     spawned on the one card, each holding its slab of the cifar_like
     store (its bytes on the card after construction at most the slab's
     plus 5%), gloo taking the card's tensors, every route's trajectory
     from [sharded]'s x_T against the one-card one (TRAJ_TOL), the ranks
     bit-equal, each shard-local kernel once a step a rank, ``select``
     overlap 1.0 or ties at a cut; then a one-rank NCCL ProcessMesh in
     this process: its bytes, every route against the one card, the
     plan's CUDA graphs (holding the NCCL collectives) bit-equal to the
     plan run eagerly, the plan's wall, busy and idle share in turns with
     the one-card plan and a LocalMesh of 1, the collectives' device time
     a step, and ``ServeEngine(mesh=...)`` capturing and building nothing
     after ``warmup()``; then ``ServeRuntime`` over the ranks
     (``pmesh_runtime``: the Wiener rung from the slabs' sums, [runtime]'s
     clean traffic with nothing built or captured after warmup, the fault
     ladder; on the gloo ranks faults on rank 1 alone and every record
     and image bit-equal across the ranks; on the NCCL rank images/s and
     p50/p99 in turns with a one-card runtime, deliveries within
     TRAJ_TOL of its) and GoldDiff+PCA / +Kamb static trajectories on
     the cifar10 preset (``pmesh_patches``), each within TRAJ_TOL of one
     card, with a rank's bytes held against slab + Wiener rung + feature
     cache + ``pmesh_workspace`` ([pmesh]);
  8. reference: a small store's trajectories on the card against the
     same trajectories on the CPU (plain versions), for every route
     (the indexed one with an index built on the CPU and moved over),
     and the auto and indexed plans;
  8b. presets (``presets_phase``): the paper's cifar10 preset (cifar_like
     N=8192, PCA rank 8) served by a static ServeEngine(base="pca")
     (warmup's feature caches, 3 counted waves: kernels 1 and 2 once a
     step, no other); paired trajectories from one x_T (GoldDiff+PCA,
     the PCA baseline, PCA "ss", GoldDiff+Kamb, Kamb, GoldDiff+Optimal)
     and the imagenet preset's GoldDiff+PCA and PCA baseline (N=20000,
     64x64x3), each counted, timed, profiled, with its peak memory; the
     card against the CPU's plain versions (B=4, 10 steps, 1e-3), the
     first step's golden supports, the PCA "ss" full scan against
     support = every row (2e-4), and the PCA features and box sums in
     fp32 with cuDNN's TF32 flag on (1e-5 of float64);
  9. the reduced-LLM slice (``llm_phases``): flash attention (kernel 9)
     and golden decode attention (kernel 8) against their plain versions
     at the path's shapes in fp32 and bf16 ([llm-check]); the
     golden-decode entry point at --reduced on the card against the CPU
     ([llm-reference]); the entry point at llama3.2-3b's full width,
     counted (28 launches of kernel 9 a prefill), with its KL/top-1
     table, prefill and decode walls and idle shares ([llm-decode]);
     both kernels timed against bound, plain version and one library
     call, with the achieved rate and share of the bound, kernel 9 also
     at S=32768 ([time]);
  10. LLM training (``training_phases``): the attention backward kernels
     (bf16: csrc/flash_attention_bwd_sm90.cu, fp32: the CUDA-core
     csrc/flash_attention_bwd.cu) against their plain version at
     llama3.2-3b's shape in bf16, at the reduced config's and smaller
     ragged shapes in fp32 and bf16, and at the bf16 kernels' tile edges
     (S = 1000 and 4095, G = 1-4, dh = 32, 64, 128, causal and not; 1e-2
     / 1e-5 of the plain gradient's max abs; two calls bit-equal), with
     kernel 9's row lse (1e-5), timed against its bound, its earlier
     time, plain version and SDPA's backward, with each launch's device
     ms ([train-check], [time]); the reduced config trained 5
     steps on the card and on the CPU from the same weights and batches
     (losses and step 1's gradients 1e-4; [train-reference]);
     llama3.2-3b's train step at full width and depth, bf16, remat on,
     B=2, S=4096: one warm step, 3 counted (2 x 28 launches of kernel 9
     and 28 of the backward a step), timed and profiled (tokens/s, the
     share of the bf16 peak, peak memory, the optimizer's share), then
     a step of two microbatches ([train]); ``make_decode_step``'s CUDA
     graph bit-equal to the eager decode step at three positions, full
     and golden, with both walls and idle shares ([decode-graph]);
  11. the frontend and MoE archs (``arch_phases``): kernels 9 and 8 and
     the backward against their plain versions at each new (G, dh) of
     qwen2.5-32b, qwen2-7b, starcoder2-3b, internvl2-1b, musicgen-medium,
     phi3.5-moe-42b-a6.6b and dbrx-132b, bf16 and fp32, causal, then
     checked again and timed at the shape each path gives them: the
     train steps' [2, Hkv, G, 4096, dh], the MoE prefills' B=1 and
     qwen2.5-32b's [1, 8, 5, 16384, 128] ([arch-check], [time]); each
     arch's reduced config on the card against the CPU from one set of
     weights and batches (loss, aux, step 1's gradients 1e-4; prefill
     and decode logits 1e-4; an MoE's expert choices and kept slots
     equal; [arch-reference]); qwen2.5-32b at full width and depth, B=1,
     S=16384: the prefill counted (64 launches of kernel 9), kernel 8 on
     its layer-0 cache as a path of its own (the ops section: the decode
     step runs the reference's plain partials), checked and timed at
     that shape, the decode step's CUDA graph bit-equal to eager
     at three positions, full and golden (64 of 128 blocks), KL and
     top-1, walls, idle shares, peak memory ([arch-prefill]);
     internvl2-1b (1024 vision embeddings) and musicgen-medium (512
     audio frames) trained at full width and depth, B=2, S=4096, remat:
     tokens/s, the share of the bf16 peak, peak memory, launches, no
     library or plain attention kernel ([arch-train]); phi3.5-moe and
     dbrx at full width cut to 2 layers: phi's train step, both
     prefills (B=1, S=4096) with their dropped share and aux loss, one
     MoE layer's route, dispatch, expert and combine products by the
     profiler, the decode graph ([moe]);
  12. Mamba-2 (``mamba_phases``): the chunked SSD (plain torch: the
     reference has no kernel there) on the card against the CPU in fp32
     and its bf16 path against fp32 on the same values, with gradients
     ([mamba-check]); both archs' reduced configs card against CPU, jamba
     over its whole 8-layer pattern ([mamba-reference]); mamba2-2.7b at
     full width and depth trained (B=2, S=4096, remat: every leaf moves;
     tokens/s, the share of the bf16 peak, peak memory, the device time
     split into the SSD's products and the rest, the other GEMMs and
     the elementwise work), prefilled at B=1, S=16384 and decoded
     through the CUDA graph (8 replays equal to 8 eager steps from a
     copy of the cache; ms a token against the weight read); no hand
     kernel runs on its path; jamba-v0.1-52b at full width cut to 8
     layers (one period): kernel 9 held against its plain version and
     timed at its prefill's [1, 8, 4, 16384, 128] before the weights are
     drawn, the prefill at B=1, S=16384 counted (kernel 9 once), its
     decode graph full and golden (64 of 128 blocks) against eager
     ([mamba]).
  13. The LLM's logical sharding (``mesh_phases``, ``dryrun_phase``):
     on a one-rank NCCL group with a (1, 1) ("data", "model") device
     mesh, llama3.2-3b at full width and depth trained under train rules
     from [train]'s weights and batches (losses against [train]'s; wall,
     busy and idle share beside [train]'s; 2 x 28 kernel 9 and 28
     backward launches a step, no library or plain attention), the
     reduced config with two microbatches and shard_grad_accum and with
     zero1_rules against one device, the prefill and the eager decode
     (full, golden) under their rules with logits bit-equal to one
     device ([mesh]); the dry run of four archs at the four shapes on the
     16 x 16 mesh on fake CUDA tensors, one subprocess an arch, side by
     side ([dryrun]).

Any failure exits non-zero before the last line.  The last lines are the
card's name and power limit, a JSON line of per-kernel numbers, and
``{"ok": true, "device": {...}}``.

  python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "scripts"))
try:
    from card_timing import (B, GMM_C, GMM_DIM, GMM_MODES, GMM_N, GMM_SPREAD,
                             INDEXED_FRACS, N, SCALE_PROBES, STEPS, T_BUCKETS,
                             card, device_events, device_kernels,
                             device_profile, kernel_names, launch_name,
                             short, time_ms, wall_ms)
except ImportError:
    sys.exit(f"chip_smoke: FAIL: no scripts/card_timing.py beside "
             f"{Path(__file__).name}")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM data sheet, dense TF32 tensor cores
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


def profile_line(label: str, wall: float, fn) -> tuple[float, float]:
    """Profile one call of ``fn`` and print its device busy time, its idle
    share against ``wall`` (the unprofiled wall in ms of the same call:
    the profiler's own host work widens the gaps), its top kernels and
    the device time of the top-m kernels' parts (TOPM_PARTS) and of
    kernels 2 and 3's (UNION_PARTS).  Returns the idle share and the
    busy ms."""
    from torch.autograd import DeviceType
    # a session that kept no device event lost them (device_events)
    for _ in range(3):
        with device_profile(cpu=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_on = (time.perf_counter() - t0) * 1e3
        kern = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        if busy > 0:
            break
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
    return idle, busy


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
    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    skip = {e.name for e in device_events(flush.zero_)}
    fn()

    def calls():
        for _ in range(iters):
            flush.zero_()
            fn()

    out = dict.fromkeys([*groups, "rest"], 0.0)
    for e in device_events(calls):
        if e.name in skip:
            continue
        g = next((g for g, frags in groups.items()
                  if any(f in e.name for f in frags)), "rest")
        out[g] += e.time_range.elapsed_us() / 1e3 / iters
    flush.zero_()
    one = [(launch_name(e.name), e.time_range.elapsed_us())
           for e in device_events(fn) if e.name not in skip]
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
        idle, _ = profile_line(f"llm {label}", walls[label], fn)
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


# LLM training on the card: the backward kernel, the reduced config card
# vs CPU, llama3.2-3b's full-width train step and the decode graph.  The
# full-width step is B=2 sequences of train_4k's S=4096
# (src/repro/launch/inputs.py:27) at full depth, remat on; bf16's dense
# peak is the data sheet's 989.4 TFLOP/s.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}   # x the grad's max abs
LSE_TOL = 1e-5
TRAIN_REF_STEPS, TRAIN_REF_B, TRAIN_REF_S = 5, 4, 256
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 1e-4
TRAIN_B, TRAIN_S, TRAIN_TIMED = 2, 4096, 3
BWD_WAS_MS = 6.6123     # the replaced mma.sync backward, same shape (PERF.md)
BWD_PROFILED = 20
BF16_PEAK = 989.4e12


def top_ops(events, n: int = 8) -> tuple[float, str]:
    """Device busy ms of profiler events and the top ``n`` kernels by
    device time, as one string."""
    by = Counter()
    for e in events:
        by[launch_name(e.name)] += e.time_range.elapsed_us() / 1e3
    busy = sum(by.values())
    return busy, "; ".join(f"{k} {v:.2f} ms ({v / busy:.3f})"
                           for k, v in by.most_common(n))


def attn_bwd_check(randn, shape, dtype, causal=True,
                   tag: str = "[train-check]"):
    """The attention backward kernel against its plain version at
    ``shape`` = (B, Hkv, G, S, dh) on inputs from ``randn(shape, dtype)``:
    its three gradients within BWD_TOL of the plain gradient's max abs,
    two calls bit-equal, kernel 9's row lse within LSE_TOL, kernel 9 with
    the lse bit-equal to kernel 9 without.  Returns the largest error
    and the inputs (q, k, v, o, do, lse)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    b, hkv, g, s, dh = shape
    q = randn((b, hkv, g, s, dh), dtype)
    k, v = (randn((b, hkv, s, dh), dtype) for _ in range(2))
    o, lse = flash_attention(q, k, v, causal, return_lse=True)
    o_plain, lse_plain = ref.flash_attention_ref(q, k, v, causal, True)
    lse_err = float((lse - lse_plain).abs().max())
    check(torch.equal(o, flash_attention(q, k, v, causal)),
          f"flash_attention {shape} {dtype}: output with lse differs")
    del o_plain, lse_plain
    do = randn(o.shape, dtype)
    got = flash_attention_bwd(q, k, v, o, do, lse, causal)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal)
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    errs = [float((a.float() - w.float()).abs().max())
            / float(w.float().abs().max()) for a, w in zip(got, want)]
    del want, again
    check(max(errs) <= BWD_TOL[dtype] and same and lse_err <= LSE_TOL,
          f"flash_attention_bwd {shape} {dtype} causal={causal}: errors "
          f"(dq, dk, dv) / max abs {errs} > {BWD_TOL[dtype]}, bit-equal "
          f"rerun {same}, lse max abs {lse_err:.3g}")
    print(f"{tag} flash_attention_bwd {list(shape)} "
          f"{str(dtype)[6:]} causal={causal}: max abs error / max abs of "
          f"the plain grad: dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv "
          f"{errs[2]:.3g} (tolerance {BWD_TOL[dtype]}); two calls "
          f"bit-equal; kernel 9's lse max abs {lse_err:.3g} against the "
          f"plain version's (tolerance {LSE_TOL})")
    return max(errs), (q, k, v, o, do, lse)


def training_phases(kernels: dict) -> tuple[dict, dict]:
    """LLM training on the card: [train-check] holds the attention
    backward kernel (and kernel 9's row log-sum-exp) against the plain
    versions; [train-reference] trains the reduced config on the card and
    on the CPU from the same weights and batches; [train] runs
    llama3.2-3b's train step at full width and depth (remat on) with
    every count set to 0 just before its timed steps, then one step with
    two microbatches; [decode-graph] replays ``make_decode_step``'s CUDA
    graph against the eager decode step.  Returns the backward's result
    entry and the counts of the [train] steps."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.distributed.hlo_analysis import model_flops
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.inputs import InputShape
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.module import init_params, tree_leaves, tree_map
    from repro_torch.training import optimizer as opt
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device="cuda").manual_seed(13)
    f32, bf16 = torch.float32, torch.bfloat16
    t_phase = time.perf_counter()

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # -- [train-check] the backward against its plain version -----------------
    def bwd_check(shape, dtype, causal=True):
        return attn_bwd_check(randn, shape, dtype, causal)

    full = (LLM_B, HKV, G_Q, LLM_S, DH)
    reduced = get_config("llama3.2-3b").reduced()
    err_bwd, timed = bwd_check(full, bf16)
    for shape, dtype, causal in (
            ((LLM_B, reduced.num_kv_heads, reduced.num_heads
              // reduced.num_kv_heads, LLM_S, reduced.hdim), f32, True),
            ((1, 2, 3, 1000, 128), f32, True), ((1, 2, 3, 1000, 128), f32,
                                                False),
            ((1, 2, 3, 1000, 128), bf16, False), ((2, 1, 2, 200, 32), bf16,
                                                  True),
            ((2, 1, 2, 200, 32), f32, True), ((1, 2, 1, 300, 64), bf16,
                                              True)):
        bwd_check(shape, dtype, causal)
    # the bf16 kernels' tile edges: S not a multiple of the 128-key tile
    # (1000, 4095), G = 1-4 (4 pads a head group of the dQ launch), every
    # head dim
    for shape, causal in [((1, 2, g, 1000, dh), c) for dh in (32, 64, 128)
                          for g in (1, 2, 3, 4) for c in (True, False)
                          if (g, dh, c) != (3, 128, False)] + [
            ((1, 1, g, 4095, 128), c) for g in (1, 4) for c in (True, False)]:
        bwd_check(shape, bf16, causal)

    q, k, v, o, do, lse = timed
    b, hkv, g, s, dh = q.shape
    qh, doh = (t.reshape(b, hkv * g, s, dh) for t in (q, do))
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (qh, k, v))
    out_l = sdpa(ql, kl, vl, is_causal=True, enable_gqa=True)
    res = dict(ms=time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse,
                                                      True)),
               plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(
                   q, k, v, o, do, lse, True), 3),
               library_ms=time_ms(lambda: torch.autograd.grad(
                   out_l, (ql, kl, vl), doh, retain_graph=True)))
    # five [S, S] x dh products a head are the gradient's work (the
    # bound); the kernels issue seven (S and dP again in the dQ launch)
    flops = 10 * dh * b * hkv * g * s * (s + 1) / 2
    issued = flops * 7 / 5
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOPS_PER_S)
    res["max_abs_err"] = err_bwd
    # each launch's device ms: BWD_PROFILED calls in one session (a short
    # session can lose its events to the card's clock skew), averaged
    # over the events kept
    launch_ms, kept = Counter(), Counter()
    for e in device_events(lambda: [flash_attention_bwd(
            q, k, v, o, do, lse, True) for _ in range(BWD_PROFILED)]):
        launch_ms[launch_name(e.name)] += e.time_range.elapsed_us() / 1e3
        kept[launch_name(e.name)] += 1
    fwd_ms = time_ms(lambda: flash_attention(q, k, v, True))
    fwd_lse_ms = time_ms(lambda: flash_attention(q, k, v, True,
                                                 return_lse=True))
    print(f"[time] flash_attention_bwd bf16 causal {list(q.shape)}: kernel "
          f"{res['ms']:.4f} ms (was {BWD_WAS_MS} ms: the mma.sync kernels "
          f"it replaced; {flops / res['ms'] / 1e9:.1f} TFLOP/s on the five "
          f"products, {issued / res['ms'] / 1e9:.1f} on the seven issued; "
          f"{res['bound_ms'] / res['ms']:.3f} of the bound; "
          f"{res['library_ms'] / res['ms']:.3f}x the library's speed), bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}: {flops / 1e9:.1f} "
          f"GFLOP at the bf16 tensor-core rate, {nbytes / 1e6:.1f} MB; "
          f"{issued / BF16_FLOPS_PER_S * 1e3:.4f} ms for the seven issued), "
          f"plain {res['plain_ms']:.4f} ms, library (the backward of "
          f"scaled_dot_product_attention, is_causal, enable_gqa) "
          f"{res['library_ms']:.4f} ms")
    print(f"[time] flash_attention_bwd launches, device ms a launch "
          f"(profiler, {BWD_PROFILED} calls in one session): " + (", ".join(
              f"{n} {v / kept[n]:.4f} ({kept[n]} kept)"
              for n, v in launch_ms.items()) or "no event kept"))
    print(f"[time] flash_attention bf16 causal {list(q.shape)} in one call's "
          f"turn: {fwd_ms:.4f} ms without the lse, {fwd_lse_ms:.4f} ms "
          f"writing it")
    del timed, q, k, v, o, do, lse, qh, doh, ql, kl, vl, out_l
    torch.cuda.empty_cache()

    # -- [train-reference] the reduced config, card against CPU ---------------
    rcfg = reduced
    cpu_params = init_params(T.model_specs(rcfg),
                             torch.Generator().manual_seed(0))
    np_params = tree_map(lambda t: t.numpy(), cpu_params)
    pipe = TokenPipeline(TokenPipelineConfig(rcfg.vocab_size, TRAIN_REF_S,
                                             TRAIN_REF_B))
    batches = [pipe.batch(i) for i in range(TRAIN_REF_STEPS)]
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2,
                           total_steps=TRAIN_REF_STEPS)
    runs = {}
    for dev in ("cuda", "cpu"):
        p = params_from_numpy(rcfg, np_params, device=dev)
        dev_batches = [{k: t.to(dev) for k, t in bt.items()}
                       for bt in batches]
        _, g1 = step_lib.make_loss_step(rcfg)(p, dev_batches[0])
        st = opt.init_state(p)
        step = step_lib.make_train_step(rcfg, None, ocfg)
        for fn in kernels.values():
            fn.launches = 0
        losses = []
        for bt in dev_batches:
            p, st, m = step(p, st, bt)
            losses.append(float(m["loss"]))
        runs[dev] = (losses, {k: t.cpu() for k, t in tree_leaves(g1)},
                     {n: f.launches for n, f in kernels.items()})
    (lg, gg, cg), (lc, gc_, _) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(lg, lc))
    grad_err = max(float((gg[k] - gc_[k]).abs().max())
                   / float(gc_[k].abs().max()) for k in gc_)
    want = {n: 0 for n in kernels}
    want.update(flash_attention=TRAIN_REF_STEPS * rcfg.num_layers,
                flash_attention_bwd=TRAIN_REF_STEPS * rcfg.num_layers)
    check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL
          and cg == want and lg[-1] < lg[0],
          f"train-reference: losses {lg} vs {lc}, step 1 grads {grad_err:.3g}"
          f" of max abs, launches {cg}")
    print(f"[train-reference] {rcfg.name} ({rcfg.num_layers} layers, d_model "
          f"{rcfg.d_model}, {rcfg.num_heads}/{rcfg.num_kv_heads} heads, fp32, "
          f"remat {rcfg.remat}), B={TRAIN_REF_B}, S={TRAIN_REF_S}, "
          f"{TRAIN_REF_STEPS} steps on the card and on the CPU from the same "
          f"weights and token batches: losses card {[f'{x:.6f}' for x in lg]}"
          f", max abs difference {loss_err:.3g} (tolerance {TRAIN_LOSS_TOL});"
          f" step 1's gradients max abs difference / leaf max abs "
          f"{grad_err:.3g} (tolerance {TRAIN_GRAD_TOL}); card launches: "
          f"flash_attention {cg['flash_attention']}, flash_attention_bwd "
          f"{cg['flash_attention_bwd']}")
    del runs, cpu_params, np_params

    # -- [train] llama3.2-3b at full width and depth ---------------------------
    cfg = get_config("llama3.2-3b")
    shape = InputShape("train_4k", "train", TRAIN_S, TRAIN_B)
    mflops = model_flops(cfg, shape)

    def train_run(cfg_run, nmb: int, steps: int):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, state, batches, step = train_lib.setup(
            cfg_run, steps, TRAIN_B, TRAIN_S, torch.device("cuda"), nmb)
        out = {"losses": []}

        def one(i):
            nonlocal params, state
            params, state, m = step(params, state, batches[i % len(batches)])
            return m
        m = one(0)                                    # warm, not counted
        torch.cuda.synchronize()
        out["losses"].append(float(m["loss"]))
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for i in range(1, steps):
            m = one(i)
        torch.cuda.synchronize()
        out["wall_ms"] = (time.perf_counter() - t0) * 1e3 / max(steps - 1, 1)
        out["counts"] = {n: f.launches for n, f in kernels.items()}
        out["losses"].append(float(m["loss"]))
        out["peak"] = torch.cuda.max_memory_allocated()
        out["finite"] = all(bool(torch.isfinite(t).all())
                            for _, t in tree_leaves(params))
        return out, params, state, batches, step, one

    t0 = time.perf_counter()
    run, params, state, batches, step, one = train_run(cfg, 1, 1
                                                       + TRAIN_TIMED)
    counts = run["counts"]
    want = {n: 0 for n in kernels}
    want.update(flash_attention=2 * cfg.num_layers * TRAIN_TIMED,
                flash_attention_bwd=cfg.num_layers * TRAIN_TIMED)
    check(counts == want, f"train launches {counts}, expected {want}")
    check(run["finite"] and all(np.isfinite(run["losses"])),
          f"train: non-finite losses {run['losses']} or parameters")
    wall = run["wall_ms"]
    ev = device_events(lambda: one(0))
    busy, tops = top_ops(ev)
    # the step's attention is kernel 9 and the backward kernel only: no
    # library attention and no softmax of a plain (materialized) version
    foreign = foreign_attention(ev)
    check(not foreign, f"train: library or plain attention kernels in the "
          f"step: {foreign}")
    bwd_ms, bwd_n = Counter(), Counter()
    for e in ev:
        if launch_name(e.name) in OURS[1:]:
            bwd_ms[launch_name(e.name)] += e.time_range.elapsed_us() / 1e3
            bwd_n[launch_name(e.name)] += 1
    grads = step_lib.make_loss_step(cfg)(params, batches[0])[1]
    opt_cfg = opt.AdamWConfig()
    opt_busy, _ = device_kernels(lambda: opt.apply_updates(
        opt_cfg, params, grads, state))
    del grads
    tok_s = TRAIN_B * TRAIN_S / (wall / 1e3)
    share = mflops / (wall / 1e3) / BF16_PEAK
    print(f"[train] {cfg.name} at full width and depth ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, bf16, remat {cfg.remat}), B={TRAIN_B}, "
          f"S={TRAIN_S} (train_4k sequences), AdamW (fp32 m, v, master): "
          f"wall {wall:.1f} ms a step (mean of {TRAIN_TIMED} after one warm "
          f"step; setup and warm step {time.perf_counter() - t0:.1f} s), "
          f"device busy {busy:.1f} ms a step (profiler), idle share "
          f"{1 - busy / wall:.3f}; {tok_s:.0f} tokens/s; model FLOPs "
          f"{mflops / 1e12:.2f} TFLOP a step (6 N D), "
          f"{share:.4f} of the bf16 dense peak ({BF16_PEAK / 1e12:.1f} "
          f"TFLOP/s); peak memory {run['peak'] / 2**30:.2f} GiB "
          f"(max_memory_allocated); launches flash_attention "
          f"{counts['flash_attention']} ({2 * cfg.num_layers} a step), "
          f"flash_attention_bwd {counts['flash_attention_bwd']} "
          f"({cfg.num_layers} a step); no library or plain attention "
          f"kernel among the step's {len(ev)} device kernels; losses "
          f"{run['losses']}")
    TRAIN_RUN.update(losses=list(run["losses"]), wall_ms=wall, busy_ms=busy,
                     peak=run["peak"])
    print(f"[train] top device operations of one step: {tops}; the "
          f"optimizer (apply_updates alone, profiled) {opt_busy:.1f} ms, "
          f"{opt_busy / busy:.3f} of the step's device time")
    print("[train] the attention backward's launches in the step (profiler): "
          + ", ".join(f"{n} {bwd_ms[n]:.2f} ms over {bwd_n[n]} "
                      f"({bwd_ms[n] / bwd_n[n]:.4f} a launch)" for n in bwd_n)
          + f"; {sum(bwd_ms.values()) / busy:.3f} of the step's device time")
    del params, state, batches, step, one, run
    gc.collect()

    layers, run2 = cfg.num_layers, None
    while run2 is None:
        try:
            run2 = train_run(dataclasses.replace(cfg, num_layers=layers), 2,
                             2)[0]
        except torch.cuda.OutOfMemoryError:
            check(layers > 4, "train: num_microbatches=2 does not fit at 4 "
                  "layers")
            layers //= 2
        gc.collect()
        torch.cuda.empty_cache()
    check(run2["finite"] and all(np.isfinite(run2["losses"]))
          and run2["counts"]["flash_attention_bwd"] == 2 * layers,
          f"train num_microbatches=2: {run2}")
    print(f"[train] num_microbatches=2 (fp32 gradient sums) at "
          + ("full depth" if layers == cfg.num_layers else
             f"full width cut to {layers} of {cfg.num_layers} layers (full "
             f"depth did not fit)")
          + f": wall {run2['wall_ms']:.1f} ms a step, peak memory "
          f"{run2['peak'] / 2**30:.2f} GiB, launches flash_attention_bwd "
          f"{run2['counts']['flash_attention_bwd']} a step, losses "
          f"{run2['losses']}")
    del run2
    gc.collect()
    torch.cuda.empty_cache()

    # -- [decode-graph] make_decode_step's CUDA graph against eager -----------
    nb = LLM_S // cfg.golden_block_size
    params = init_params(T.model_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (LLM_B, LLM_S), device="cuda",
                         generator=gen)
    with torch.no_grad():
        _, cache0 = T.prefill(cfg, params, toks)
    decode_graph_check(dataclasses.replace(cfg, golden_blocks=nb // 8),
                       params, cache0, toks[:, -1],
                       f"[decode-graph] {cfg.name} full width, B={LLM_B}, "
                       f"S={LLM_S},")
    del params, cache0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] phases {time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention_bwd": res}, counts


# The seven archs of the frontend and MoE families.  Each brings a
# (G, dh) pair of kernels 8, 9 and the backward that the llama phases do
# not run; [arch-check] holds them at every pair and times them at the
# pair's train_4k shape ([2, Hkv, G, 4096, dh]).  [arch-prefill] runs
# qwen2.5-32b at full width and depth (61.0 GiB of bf16 weights) over
# one 16384-token sequence; [arch-train] trains the two frontend archs
# at full width and depth; [moe] runs the two MoE archs at full width
# with their depth cut to MOE_LAYERS (their weights and AdamW state do
# not fit one card: ROADMAP's configurations the port has not run on the
# card).
ARCH_NEW = ("qwen2.5-32b", "qwen2-7b", "starcoder2-3b", "internvl2-1b",
            "musicgen-medium", "phi3.5-moe-42b-a6.6b", "dbrx-132b")
ARCH_CHECK_S = 1000            # not a multiple of any tile
ARCH_TIME_B, ARCH_TIME_S = 2, 4096
ARCH_REF_B, ARCH_REF_S = 2, 256
ARCH_REF_TOL = 1e-4            # loss, aux, step 1's gradients (fp32)
PREFILL_ARCH, PREFILL_S = "qwen2.5-32b", 16384
TRAIN_ARCHS, ARCH_TRAIN_TIMED = ("internvl2-1b", "musicgen-medium"), 3
MOE_ARCHS, MOE_LAYERS, MOE_S, MOE_TIMED = (
    ("phi3.5-moe-42b-a6.6b", "dbrx-132b"), 2, 4096, 2)
MOE_PROFILED = 10
# The [mamba] phase (``mamba_phases``): mamba2-2.7b at full width and
# depth (64 layers, 2.83 B parameters, 36.9 GiB with AdamW) trained at
# train_4k's B=2, S=4096, prefilled at B=1, S=MAMBA_S and decoded
# through the CUDA graph; jamba-v0.1-52b at full width over one period
# of its pattern (HYBRID_LAYERS: 7 Mamba layers and 1 attention layer,
# MoE on 4; 13.27 B parameters, 24.7 GiB in bf16: its 32 layers, 95.9
# GiB, do not fit the card) prefilled at B=1, S=MAMBA_S and decoded.  The
# SSD is plain torch (the reference has no kernel there): the on-card
# checks at SSD_CHECK (B, S, H, P, N, chunk: 8 chunks) hold it.
MAMBA_ARCH, HYBRID_ARCH, HYBRID_LAYERS = "mamba2-2.7b", "jamba-v0.1-52b", 8
MAMBA_ARCHS = (MAMBA_ARCH, HYBRID_ARCH)
MAMBA_TIMED, MAMBA_S, MAMBA_REPLAYS, MAMBA_PROFILED = 3, 16384, 8, 5
SSD_CHECK = (2, 1024, 16, 64, 128, 128)
SSD_CARD_TOL = 2e-5    # card fp32 against CPU fp32, of the max abs (y, state)
SSD_BF16_TOL = 1e-2    # bf16 against fp32 on the same values, of the max abs
REPLAY_TOL = 0.0       # decode graph replays against eager steps: bit-equal
# [mamba-reference]'s gradients, card against CPU, of each leaf's max abs:
# through jamba's 8 reduced layers at B=2, S=256 the port and the JAX
# reference differ by 1.64e-4 on the CPU (fp32 sums in another order;
# 5.4e-5 at S=64, tests/test_torch_archs.py), so ARCH_REF_TOL's 1e-4 is
# below the two frameworks' own spread there
MAMBA_REF_GRAD_TOL = 3e-4
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")   # cuBLAS's product kernels
# kernels of the attention path: kernel 9 (bf16 route) and the backward
OURS = ("flash_sm90_kernel", "bwd_dkdv_sm90_kernel", "bwd_dq_sm90_kernel",
        "bwd_dot_sm90_kernel")


def foreign_attention(events, softmax_ok: int = 0) -> list[str]:
    """The library or plain attention kernels among ``events``: any
    kernel named for attention or softmax that is not ours.  An MoE's
    router takes a softmax over its experts: ``softmax_ok`` softmax
    launches are its and allowed."""
    names = [launch_name(e.name) for e in events]
    soft = [n for n in names if "softmax" in n.lower()]
    foreign = {n for n in names if any(f in n.lower() for f in (
        "fmha", "flash", "sdpa", "attention")) and n not in OURS}
    if len(soft) > softmax_ok:
        foreign |= set(soft)
    return sorted(foreign)


@contextlib.contextmanager
def routings():
    """Wrap ``moe.route`` while the block runs: yields a list that each
    call appends ``{"experts": [G, T, k], "keep": [G, T, k] bool, "cap"}``
    to, ``keep`` False where a choice was dropped for capacity (read from
    the dispatch tensor the call returns)."""
    from repro_torch.models import moe
    seen, route = [], moe.route

    def spy(p, xg, e, k, cap):
        out = route(p, xg, e, k, cap)
        idx, dispatch = out[1], out[2]
        seen.append({"experts": idx.detach(), "cap": cap,
                     "keep": torch.gather(dispatch.detach().sum(-1) != 0,
                                          -1, idx)})
        return out
    moe.route = spy
    try:
        yield seen
    finally:
        moe.route = route


def arch_shape(cfg) -> tuple[int, int, int]:
    """(Hkv, G, dh) of a config's attention."""
    return cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.hdim


PLAIN_SCORES_BYTES = 8 << 30   # the plain attention's fp32 scores a chunk


def by_kv_heads(fn, *args):
    """``fn`` (a plain attention function of [B, Hkv, ...] tensors) one
    chunk of KV heads at a time, so that its fp32 scores [B, h, G, S, S]
    stay within PLAIN_SCORES_BYTES; the chunks' results concatenated."""
    b, hkv, g, s, _ = args[0].shape
    hc = max(1, min(hkv, PLAIN_SCORES_BYTES // (4 * b * g * s * s)))
    outs = [fn(*(a[:, h:h + hc] for a in args)) for h in range(0, hkv, hc)]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs, 1)
    return tuple(torch.cat(parts, 1) for parts in zip(*outs))


def print_timed(name: str, arch: str, hkv: int, g: int, dh: int,
                where: str, r: dict, smi: str) -> None:
    print(f"[time] {name} bf16 {arch} (Hkv={hkv}, G={g}, dh={dh}, {where}): "
          f"kernel {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.3f} of the "
          f"bound; {r['library_ms'] / r['ms']:.3f}x the library's speed), "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms; max "
          f"abs {r['max_abs_err']:.3g} against the plain version at this "
          f"shape; {smi}")


def golden_timed(q, k, v, idx, valid, bs: int, err: float) -> dict:
    """Kernel 8 on q [B, Hkv, G, dh] over k/v [B, Hkv, S, dh] and these
    blocks, bf16, timed against its bound (the valid blocks' keys and
    values read once), its plain version and SDPA with the blocks' mask;
    ``err`` is its error measured at this shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.golden_attention import golden_attention_decode
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b, hkv, g, dh = q.shape
    nvalid = int((valid == 1).sum())
    blocks = torch.zeros((b, hkv, k.shape[2] // bs), dtype=torch.bool,
                         device="cuda")
    blocks.scatter_(2, idx.long(), valid == 1)
    mask = blocks.repeat_interleave(bs, -1).repeat_interleave(
        g, 1)[:, :, None, :]
    qh = q.reshape(b, hkv * g, 1, dh)
    r = dict(ms=time_ms(lambda: golden_attention_decode(
        q, k, v, idx, valid, bs)),
        plain_ms=time_ms(lambda: ref.golden_attention_decode_ref(
            q, k, v, idx, valid, bs), 3),
        library_ms=time_ms(lambda: sdpa(qh, k, v, attn_mask=mask,
                                        enable_gqa=True), 3),
        max_abs_err=err)
    r["bound_ms"], r["bound_by"] = bound(
        2 * nvalid * bs * dh * 2 + 2 * 2 * q.numel() + 8 * idx.numel(),
        4 * g * dh * bs * nvalid, BF16_FLOPS_PER_S)
    return r


def attn_at(randn, arch: str, hkv: int, g: int, dh: int, b: int, s: int,
            bwd: bool, smi: str) -> dict:
    """Kernel 9, and with ``bwd`` the attention backward, at a path's own
    shape q [b, Hkv, G, s, dh], bf16, causal: each held against its plain
    version on the same inputs (the output within ATT_TOL, each gradient
    within BWD_TOL of the plain gradient's max abs), then timed against
    its bound, the plain version (run a chunk of KV heads at a time where
    the scores would not fit: ``by_kv_heads``) and one library call.
    Returns {kernel: result entry}, ``max_abs_err`` measured here (the
    backward's: relative to the plain gradient's max abs, as in
    ``attn_bwd_check``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    where = f"B={b}, S={s}, causal"
    q = randn((b, hkv, g, s, dh), bf16)
    k, v = (randn((b, hkv, s, dh), bf16) for _ in range(2))
    qh = q.reshape(b, hkv * g, s, dh)

    def plain():
        return by_kv_heads(lambda *a: ref.flash_attention_ref(*a, True),
                           q, k, v)
    o, lse = flash_attention(q, k, v, True, return_lse=True)
    err = float((o.float() - plain().float()).abs().max())
    check(err <= ATT_TOL[bf16], f"arch-check {arch} flash_attention "
          f"[{b}, {hkv}, {g}, {s}, {dh}] bf16: max abs {err:.3g} against its "
          f"plain version (tolerance {ATT_TOL[bf16]})")
    flops = 4 * dh * b * hkv * g * s * (s + 1) / 2
    r = dict(ms=time_ms(lambda: flash_attention(q, k, v, True)),
             plain_ms=time_ms(plain, 3),
             library_ms=time_ms(lambda: sdpa(qh, k, v, is_causal=True,
                                             enable_gqa=True)),
             max_abs_err=err)
    r["bound_ms"], r["bound_by"] = bound(
        2 * (2 * q.numel() + 2 * k.numel()), flops, BF16_FLOPS_PER_S)
    print_timed("flash_attention", arch, hkv, g, dh, where, r, smi)
    out = {"flash_attention": r}
    if bwd:
        do = randn(o.shape, bf16)

        def plain_bwd():
            return by_kv_heads(lambda *a: ref.flash_attention_bwd_ref(
                *a, True), q, k, v, o, do, lse)
        got = flash_attention_bwd(q, k, v, o, do, lse, True)
        errs = [float((a.float() - w.float()).abs().max())
                / float(w.float().abs().max())
                for a, w in zip(got, plain_bwd())]
        del got
        check(max(errs) <= BWD_TOL[bf16], f"arch-check {arch} "
              f"flash_attention_bwd [{b}, {hkv}, {g}, {s}, {dh}] bf16: "
              f"errors (dq, dk, dv) / max abs {errs} > {BWD_TOL[bf16]}")
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (qh, k, v))
        out_l = sdpa(ql, kl, vl, is_causal=True, enable_gqa=True)
        doh = do.reshape(qh.shape)
        bflops = 10 * dh * b * hkv * g * s * (s + 1) / 2
        rb = dict(ms=time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse,
                                                         True)),
                  plain_ms=time_ms(plain_bwd, 3),
                  library_ms=time_ms(lambda: torch.autograd.grad(
                      out_l, (ql, kl, vl), doh, retain_graph=True)),
                  max_abs_err=max(errs))
        rb["bound_ms"], rb["bound_by"] = bound(
            2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel(), bflops,
            BF16_FLOPS_PER_S)
        print_timed("flash_attention_bwd", arch, hkv, g, dh, where
                    + f"; dq, dk, dv errors / max abs {[f'{e:.3g}' for e in errs]}"
                    f" (tolerance {BWD_TOL[bf16]})", rb, smi)
        out["flash_attention_bwd"] = rb
        del do, ql, kl, vl, out_l, doh
    del q, k, v, qh, o, lse
    torch.cuda.empty_cache()
    return out


def arch_check(smi: str) -> dict:
    """[arch-check]: kernels 9 and 8 and the backward against their plain
    versions at every new (G, dh), bf16 and fp32, causal; then, in bf16,
    kernel 9 and the backward checked again and timed at the pair's
    train_4k shape ([2, Hkv, G, 4096, dh]), kernel 9 at the MoE prefills'
    [1, Hkv, G, 4096, dh] and qwen2.5-32b's [1, 8, 5, 16384, 128] (before
    its weights are drawn), and kernel 8 at [2, Hkv, G, dh] over 4096
    keys, each against its bound, plain version and one library call.
    Returns {arch: {shape key: {kernel: result entry}}} with the shape
    keys "train_4k", "prefill_4k" and "prefill_16k"."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.golden_attention import (
        golden_attention_decode, select_golden_blocks)
    gen = torch.Generator(device="cuda").manual_seed(17)
    f32, bf16 = torch.float32, torch.bfloat16
    t_phase = time.perf_counter()

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def golden_inputs(hkv, g, dh, dtype, b=ARCH_TIME_B, s=ARCH_TIME_S,
                      bs=128, kb=16):
        q = randn((b, hkv, g, dh), dtype)
        k, v = (randn((b, hkv, s, dh), dtype) for _ in range(2))
        idx, _ = select_golden_blocks(q.float(), k, kb, bs)
        valid = (torch.rand(idx.shape, generator=gen, device="cuda")
                 < 0.75).int()
        valid[0, 0, 0] = 1
        valid[-1, -1] = 0                          # a (b, h) with none
        return q, k, v, idx, valid, bs

    out = {}
    for arch in ARCH_NEW:
        cfg = get_config(arch)
        hkv, g, dh = arch_shape(cfg)
        err8 = 0.0
        for dtype in (bf16, f32):
            shape = (1, hkv, g, ARCH_CHECK_S, dh)
            q = randn(shape, dtype)
            k, v = (randn((1, hkv, ARCH_CHECK_S, dh), dtype) for _ in range(2))
            got = flash_attention(q, k, v, True)
            again = flash_attention(q, k, v, True)
            want = ref.flash_attention_ref(q, k, v, True)
            err = float((got.float() - want.float()).abs().max())
            check(err <= ATT_TOL[dtype] and torch.equal(got, again),
                  f"arch-check {arch} flash_attention {shape} {dtype}: max "
                  f"abs {err:.3g}, rerun bit-equal {torch.equal(got, again)}")
            print(f"[arch-check] {arch} (G={g}, dh={dh}) flash_attention "
                  f"{list(shape)} {str(dtype)[6:]} causal: max abs {err:.3g}"
                  f" against its plain version (tolerance {ATT_TOL[dtype]}); "
                  f"two calls bit-equal")
            del q, k, v, got, again, want
            attn_bwd_check(randn, shape, dtype, True, "[arch-check] "
                           f"{arch} (G={g}, dh={dh})")
            q, k, v, idx, valid, bs = golden_inputs(hkv, g, dh, dtype)
            got = golden_attention_decode(q, k, v, idx, valid, bs)
            want = ref.golden_attention_decode_ref(q, k, v, idx, valid, bs)
            err = float((got.float() - want.float()).abs().max())
            zero = not bool(got[-1, -1].any())
            check(err <= ATT_TOL[dtype] and zero,
                  f"arch-check {arch} golden_attention_decode {dtype}: max "
                  f"abs {err:.3g}, no-valid (b, h) zero {zero}")
            err8 = max(err8, err)
            print(f"[arch-check] {arch} (G={g}, dh={dh}) "
                  f"golden_attention_decode [{ARCH_TIME_B}, {hkv}, {g}, {dh}] "
                  f"over S={ARCH_TIME_S}, bs={bs}, kb={idx.shape[-1]} "
                  f"({int((valid == 1).sum())} of {valid.numel()} valid) "
                  f"{str(dtype)[6:]}: max abs {err:.3g} (tolerance "
                  f"{ATT_TOL[dtype]}); the (b, h) with no valid block gives 0")
            del q, k, v, got, want

        # -- at each path's own shape, bf16: checked, then timed ------------
        res = {"train_4k": attn_at(randn, arch, hkv, g, dh, ARCH_TIME_B,
                                   ARCH_TIME_S, True, smi)}
        if arch in MOE_ARCHS:
            res["prefill_4k"] = attn_at(randn, arch, hkv, g, dh, 1, MOE_S,
                                        False, smi)
        if arch == PREFILL_ARCH:
            res["prefill_16k"] = attn_at(randn, arch, hkv, g, dh, 1,
                                         PREFILL_S, False, smi)
        q, k, v, idx, valid, bs = golden_inputs(hkv, g, dh, bf16)
        rg = golden_timed(q, k, v, idx, valid, bs, err8)
        del q, k, v, idx, valid
        torch.cuda.empty_cache()
        print_timed("golden_attention_decode", arch, hkv, g, dh,
                    f"B={ARCH_TIME_B}, S={ARCH_TIME_S}, bs=128, kb=16", rg,
                    smi)
        res["train_4k"]["golden_attention_decode"] = rg
        out[arch] = res
    print(f"[arch-check] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def reduced_cfg(arch: str):
    """An arch's reduced config (fp32) for the card-vs-CPU checks:
    jamba over its whole 8-layer pattern (the default 2-layer cut holds
    no attention layer)."""
    from repro_torch.configs import get_config
    return get_config(arch).reduced(
        num_layers=HYBRID_LAYERS if arch == HYBRID_ARCH else 2)


def arch_reference(kernels: dict, smi: str, archs=ARCH_NEW,
                   tag: str = "[arch-reference]",
                   grad_tol: float = ARCH_REF_TOL) -> None:
    """[arch-reference]: each arch's reduced config (fp32) on the card
    against the CPU from one set of weights and batches: the loss and its
    aux term within ARCH_REF_TOL, step 1's gradients within ``grad_tol``
    of each leaf's max abs, the prefill and
    decode logits within LLM_LOGIT_TOL, and an MoE's expert choices and
    kept slots equal in every layer of every pass; kernel 9 three times
    and the backward once an attention layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as step_lib
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.module import init_params, tree_leaves, tree_map
    t_phase = time.perf_counter()
    for arch in archs:
        rcfg = reduced_cfg(arch)
        np_params = tree_map(lambda t: t.numpy(), init_params(
            T.model_specs(rcfg), torch.Generator().manual_seed(0)))
        rng = np.random.default_rng(7)
        f = rcfg.frontend_tokens if rcfg.frontend else 0
        toks = torch.from_numpy(rng.integers(
            0, rcfg.vocab_size, (ARCH_REF_B, ARCH_REF_S - f + 1)))
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        if f:
            batch["embeds"] = torch.from_numpy((0.02 * rng.standard_normal(
                (ARCH_REF_B, f, rcfg.d_model))).astype(np.float32))
        runs = {}
        for dev in ("cuda", "cpu"):
            p = params_from_numpy(rcfg, np_params, device=dev)
            bt = {k: t.to(dev) for k, t in batch.items()}
            for fn in kernels.values():
                fn.launches = 0
            with routings() as rec:
                loss, grads = step_lib.make_loss_step(rcfg)(p, bt)
                with torch.no_grad():
                    _, metrics = T.loss_fn(rcfg, p, bt)
                    pre, cache = T.prefill(rcfg, p, bt["tokens"],
                                           bt.get("embeds"))
                    dec, _ = T.decode_step(rcfg, p, cache, bt["tokens"][:, -1],
                                           ARCH_REF_S - 1)
            runs[dev] = dict(
                loss=float(loss), aux=float(metrics["aux"]),
                grads={k: t.cpu() for k, t in tree_leaves(grads)},
                prefill=pre.cpu(), decode=dec.cpu(),
                routes=[(r["experts"].cpu(), r["keep"].cpu()) for r in rec],
                counts={n: fn.launches for n, fn in kernels.items()})
        c, h = runs["cuda"], runs["cpu"]
        grad_err = max(float((c["grads"][k] - h["grads"][k]).abs().max())
                       / max(float(h["grads"][k].abs().max()), 1e-30)
                       for k in h["grads"])
        logit_err = max(float((c[k] - h[k]).abs().max())
                        for k in ("prefill", "decode"))
        same_routes = len(c["routes"]) == len(h["routes"]) and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(c["routes"], h["routes"]))
        n_moe = (sum(rcfg.mlp_kind(i) == "moe" for i in range(rcfg.period))
                 * rcfg.repeats * 4)
        layers = rcfg.num_layers
        n_attn = rcfg.pattern.count("A") * rcfg.repeats
        want = {n: 0 for n in kernels}
        want.update(flash_attention=3 * n_attn, flash_attention_bwd=n_attn)
        check(abs(c["loss"] - h["loss"]) <= ARCH_REF_TOL
              and abs(c["aux"] - h["aux"]) <= ARCH_REF_TOL
              and grad_err <= grad_tol and logit_err <= LLM_LOGIT_TOL
              and same_routes and len(c["routes"]) == n_moe
              and c["counts"] == want,
              f"arch-reference {arch}: loss {c['loss']} vs {h['loss']}, aux "
              f"{c['aux']} vs {h['aux']}, grads {grad_err:.3g}, logits "
              f"{logit_err:.3g}, routes equal {same_routes} "
              f"({len(c['routes'])} vs {len(h['routes'])}), launches "
              f"{c['counts']}")
        drop = (sum(int((~kp).sum()) for _, kp in c["routes"])
                / max(sum(kp.numel() for _, kp in c["routes"]), 1))
        print(f"{tag} {rcfg.name} ({layers} layers, d_model "
              f"{rcfg.d_model}, {rcfg.num_heads}/{rcfg.num_kv_heads} heads, "
              + (f"pattern {''.join(rcfg.pattern)}, SSD state "
                 f"{rcfg.ssm_state}, " if rcfg.ssm_state else "")
              + "fp32" + (f", {rcfg.num_experts} experts top-"
                         f"{rcfg.experts_per_token}" if rcfg.num_experts
                         else "") + (f", {f} frontend embeddings" if f else "")
              + f"), B={ARCH_REF_B}, S={ARCH_REF_S}, card against CPU from the"
              f" same weights and batch: loss {c['loss']:.6f} (difference "
              f"{abs(c['loss'] - h['loss']):.3g}), aux {c['aux']:.6f} "
              f"(difference {abs(c['aux'] - h['aux']):.3g}), step 1's "
              f"gradients max abs difference / leaf max abs {grad_err:.3g} "
              f"(tolerance {grad_tol}); prefill and decode logits max abs "
              f"{logit_err:.3g} (tolerance {LLM_LOGIT_TOL})"
              + (f"; expert choices and kept slots equal in all "
                 f"{len(c['routes'])} routings (loss, its no-grad rerun, "
                 f"prefill, decode), {drop:.3f} of the choices dropped"
                 if n_moe else "") + f"; card launches flash_attention "
              f"{c['counts']['flash_attention']}, flash_attention_bwd "
              f"{c['counts']['flash_attention_bwd']}; {smi}")
        del runs
    print(f"{tag} phase {time.perf_counter() - t_phase:.1f} s")


def decode_graph_check(cfg, params, cache, tok, label: str) -> dict:
    """``make_decode_step``'s CUDA graph against the eager decode step at
    the last three positions of ``cache`` (the first attention layer's;
    the graph decodes into ``cache``, the eager step into a copy, synced
    to it before each kind: a Mamba layer's states advance a step), full
    attention then golden (the config's kb): logits at every position and
    both caches at the end bit-equal, one graph a kind; walls and idle
    shares of both, and golden against full at the last position from
    one cache state (KL, top-1)."""
    from repro_torch.launch import steps as step_lib
    from repro_torch.models import transformer as T
    from repro_torch.models.module import tree_leaves, tree_map
    seq = T.attn_cache_len(cfg, cache)
    nb = seq // cfg.golden_block_size
    positions = (seq - 3, seq - 2, seq - 1)
    kb = min(cfg.golden_blocks, nb)
    eager_c = tree_map(torch.clone, cache)
    stateful = "M" in cfg.pattern
    out, last = {}, {}
    for kind in ("full", "golden"):
        c = dataclasses.replace(cfg, attn_kind_decode=kind)
        for (_, a), (_, b) in zip(tree_leaves(eager_c), tree_leaves(cache)):
            a.copy_(b)
        step = step_lib.make_decode_step(c)
        t = tok
        with torch.no_grad():
            step(params, cache, t, positions[0] - 1)
            T.decode_step(c, params, eager_c, t, positions[0] - 1)
            equal = True
            for pos in positions:
                want_l, _ = T.decode_step(c, params, eager_c, t, pos)
                got_l, _ = step(params, cache, t, pos)
                equal &= torch.equal(want_l, got_l)
                t = want_l.argmax(-1)
            equal &= all(torch.equal(a, b) for (_, a), (_, b) in zip(
                tree_leaves(eager_c), tree_leaves(cache)))
        check(equal and len(step.graphs) == 1,
              f"{label} decode graph {kind}: replay differs from eager, or "
              f"{len(step.graphs)} graphs")
        pos = positions[-1]
        with torch.no_grad():
            eager = lambda: T.decode_step(c, params, eager_c, t, pos)  # noqa: E731
            graph = lambda: step(params, cache, t, pos)  # noqa: E731
            w_e, w_g = wall_ms(eager, 5), wall_ms(graph, 10)
            b_e, _ = device_kernels(eager)
            b_g, tops = top_ops(device_events(graph), 6)
        out[kind] = dict(eager_ms=w_e, graph_ms=w_g,
                         eager_idle=1 - b_e / w_e, graph_idle=1 - b_g / w_g)
        print(f"{label} decode graph ({kind}"
              + (f", kb={kb} of {nb} blocks" if kind ==
                 "golden" else "") + f"): replay bit-equal to the eager "
              f"decode_step at positions {list(positions)} (logits and "
              f"cache), 1 graph; eager {w_e:.3f} ms a token (idle share "
              f"{1 - b_e / w_e:.3f}), graph {w_g:.3f} ms (idle share "
              f"{1 - b_g / w_g:.3f}), device busy {b_e:.3f} / {b_g:.3f} ms;"
              f" the replay's top device operations: {tops}")
        del step
    # golden against full from one cache state: each call writes its own
    # key and value at pos before it reads, and reads positions <= pos
    with torch.no_grad():
        for kind in ("full", "golden"):
            src = tree_map(torch.clone, eager_c) if stateful else eager_c
            last[kind] = T.decode_step(dataclasses.replace(
                cfg, attn_kind_decode=kind), params, src, tok,
                positions[-1])[0]
            del src
    pf = torch.softmax(last["full"].float(), -1)
    lg = torch.log_softmax(last["golden"].float(), -1)
    kl = float((pf * (torch.log(pf + 1e-20) - lg)).sum(-1).mean())
    top1 = float((last["full"].argmax(-1) == last["golden"].argmax(-1))
                 .float().mean())
    out.update(kl=kl, top1=top1)
    print(f"{label} golden (kb={kb} of {nb} blocks) against "
          f"full decode at position {positions[-1]}: KL {kl:.5f}, top-1 "
          f"agreement {top1:.3f} (B={tok.shape[0]})")
    del eager_c
    return out


def arch_prefill(kernels: dict, smi: str) -> dict:
    """[arch-prefill]: qwen2.5-32b at full width and depth, bf16, random
    weights drawn on the card: a prefill at B=1, S=16384 with every count
    set to 0 just before and read just after (kernel 9 once a layer);
    then, as a path of its own with its own counts, kernel 8 on the
    layer-0 cache (the golden-decode entry point's ops section: the
    decode step keeps the reference's plain partials), checked and timed
    at that shape; the decode step's CUDA graph at three positions, full
    and golden (64 of 128 blocks); walls, idle shares and peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import steps as step_lib
    from repro_torch.models.module import init_params
    from repro_torch.models import transformer as T
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = get_config(PREFILL_ARCH)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(T.model_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = torch.cuda.memory_allocated() - held
    init_peak = torch.cuda.max_memory_allocated() - held
    toks = torch.randint(0, cfg.vocab_size, (1, PREFILL_S), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    prefill = step_lib.make_prefill_step(cfg)
    hkv, g, dh = arch_shape(cfg)
    nb = PREFILL_S // cfg.golden_block_size

    bs = cfg.golden_block_size

    def ops_section(cache) -> tuple[dict, dict]:
        """Kernel 8 on the layer-0 cache with every count set to 0 just
        before: (its counts, its result entry at this shape)."""
        kc, vc = cache["l0"]["k"][0], cache["l0"]["v"][0]
        qh = torch.randn((1, hkv, g, dh), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2)).to(kc.dtype)
        for fn in kernels.values():
            fn.launches = 0
        blk, valid = ops.select_golden_blocks(qh, kc, cfg.golden_blocks, bs)
        o = ops.golden_attention_decode(qh, kc, vc, blk, valid, bs)
        counts = {n: fn.launches for n, fn in kernels.items()}
        want = ref.golden_attention_decode_ref(qh, kc, vc, blk, valid, bs)
        err = float((o.float() - want.float()).abs().max())
        check(err <= ATT_TOL[torch.bfloat16], f"arch-prefill kernel 8 on "
              f"the layer-0 cache: max abs {err:.3g} against its plain "
              f"version")
        r = golden_timed(qh, kc, vc, blk, valid, bs, err)
        print_timed("golden_attention_decode", cfg.name, hkv, g, dh,
                    f"B=1, S={PREFILL_S}, bs={bs}, kb={blk.shape[-1]} of "
                    f"{nb}, {int((valid == 1).sum())} of {valid.numel()} "
                    f"valid, the layer-0 cache", r, smi)
        return counts, r

    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {n: fn.launches for n, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {n: 0 for n in kernels}
    want.update(flash_attention=cfg.num_layers)
    check(counts == want, f"arch-prefill launches {counts}, expected {want}")
    check(tuple(logits.shape) == (1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          f"arch-prefill: logits {tuple(logits.shape)} finite "
          f"{bool(torch.isfinite(logits).all())}")
    ops_counts, ops_entry = ops_section(cache)
    want = {n: 0 for n in kernels}
    want.update(golden_attention_decode=1)
    check(ops_counts == want, f"arch-prefill ops section launches "
          f"{ops_counts}, expected {want}")
    tok = logits.argmax(-1)
    del logits
    cache_gib = sum(t.numel() * t.element_size() for lc in cache.values()
                    for t in lc.values()) / 2**30
    print(f"[arch-prefill] {cfg.name} at full width and depth "
          f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{hkv} heads (G={g}, dh={dh}), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, qkv bias, bf16): weights "
          f"{w_bytes / 2**30:.2f} GiB drawn on the card in {init_s:.2f} s "
          f"(draw peak {init_peak / 2**30:.2f} GiB above them; "
          f"{held / 2**30:.2f} GiB held by earlier phases); prefill B=1, "
          f"S={PREFILL_S}: first call {first_s:.2f} s, peak memory "
          f"{peak / 2**30:.2f} GiB, cache {cache_gib:.2f} GiB; "
          f"launches {counts}; the ops section (kernel 8 on the layer-0 "
          f"cache, kb={cfg.golden_blocks} of {nb}: max abs "
          f"{ops_entry['max_abs_err']:.3g} against its plain version) "
          f"launches {ops_counts}; {smi}")

    def again():
        with torch.no_grad():
            T.prefill(cfg, params, toks)
    del cache
    torch.cuda.empty_cache()
    wall = wall_ms(again, 2)
    ev = device_events(again)
    busy, tops = top_ops(ev)
    foreign = foreign_attention(ev)
    check(not foreign, f"arch-prefill: library or plain attention kernels "
          f"{foreign}")
    fl = sum(e.time_range.elapsed_us() for e in ev
             if launch_name(e.name) == OURS[0]) / 1e3
    print(f"[arch-prefill] prefill wall {wall:.1f} ms (mean of 2 after 2), "
          f"device busy {busy:.1f} ms (profiler), idle share "
          f"{1 - busy / wall:.3f}; kernel 9 {fl:.1f} ms ({fl / busy:.3f}); "
          f"top device operations: {tops}; no library or plain attention "
          f"kernel; {smi}")
    with torch.no_grad():
        _, cache = T.prefill(cfg, params, toks)
    dec = decode_graph_check(cfg, params, cache, tok, "[arch-prefill]")
    out = dict(prefill_ms=wall, busy_ms=busy, peak=peak, counts=counts,
               ops_counts=ops_counts, ops_entry=ops_entry, **dec)
    del params, cache, toks, tok
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[arch-prefill] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def fingerprints(params: dict) -> dict:
    """Each leaf's (sum, sum of squares) in float64: exact for bf16
    values, so a leaf whose bits move changes them."""
    from repro_torch.models.module import tree_leaves
    return {p: (float(t.double().sum()), float(t.double().square().sum()))
            for p, t in tree_leaves(params)}


def arch_train_run(cfg, kernels: dict, steps: int, softmax_ok: int = 0,
                   label: str = "[arch-train]", moved: bool = False) -> dict:
    """``launch.train``'s setup and ``steps`` train steps of ``cfg`` at
    B=2, S=4096 (train_4k sequences) on the card: one warm step, then
    ``steps - 1`` counted with every count set to 0 just before; one
    more step profiled (no library or plain attention kernel may run).
    Returns the walls, counts, losses, peak memory and the profile (its
    device ms by kernel in ``by_name``); with ``moved``, the leaves whose
    fingerprints the steps changed and the leaf count."""
    from repro_torch.launch import train as train_lib
    from repro_torch.models.module import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, batches, step = train_lib.setup(
        cfg, steps, TRAIN_B, TRAIN_S, torch.device("cuda"))
    before = fingerprints(params) if moved else {}
    losses = []

    def one(i):
        nonlocal params, state
        params, state, m = step(params, state,
                                train_lib.step_batch(cfg, batches, i))
        return m
    m = one(0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses.append(float(m["loss"]))
    aux = [float(m["aux"])]
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for i in range(1, steps):
        m = one(i)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    counts = {n: fn.launches for n, fn in kernels.items()}
    losses.append(float(m["loss"]))
    aux.append(float(m["aux"]))
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(t).all()) for _, t in tree_leaves(params))
    ev = device_events(lambda: one(steps))
    busy, tops = top_ops(ev)
    foreign = foreign_attention(ev, softmax_ok)
    check(finite and all(np.isfinite(losses)) and not foreign,
          f"{label} {cfg.name}: losses {losses}, parameters finite {finite}, "
          f"library or plain attention kernels {foreign}")
    bwd = sum(e.time_range.elapsed_us() for e in ev
              if launch_name(e.name) in OURS[1:]) / 1e3
    fwd = sum(e.time_range.elapsed_us() for e in ev
              if launch_name(e.name) == OURS[0]) / 1e3
    by_name = Counter()
    for e in ev:
        by_name[launch_name(e.name)] += e.time_range.elapsed_us() / 1e3
    after = fingerprints(params) if moved else {}
    n_moved = sum(after[p] != before[p] for p in before)
    del params, state, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    return dict(wall_ms=wall, counts=counts, losses=losses, aux=aux,
                peak=peak, busy=busy, tops=tops, setup_s=setup_s,
                attn_fwd_ms=fwd, attn_bwd_ms=bwd, n_events=len(ev),
                by_name=by_name, moved=n_moved, leaves=len(before))


def arch_train(kernels: dict, smi: str) -> dict:
    """[arch-train]: internvl2-1b (1024 vision embeddings + 3072 tokens)
    and musicgen-medium (512 audio frames + 3584 tokens) trained at full
    width and depth through ``launch.train``: tokens/s, the share of the
    bf16 peak by model FLOPs, peak memory, launches."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.hlo_analysis import model_flops
    from repro_torch.launch.inputs import InputShape
    t_phase = time.perf_counter()
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = get_config(arch)
        r = arch_train_run(cfg, kernels, 1 + ARCH_TRAIN_TIMED)
        n = ARCH_TRAIN_TIMED
        want = {k: 0 for k in kernels}
        want.update(flash_attention=2 * cfg.num_layers * n,
                    flash_attention_bwd=cfg.num_layers * n)
        check(r["counts"] == want, f"[arch-train] {arch}: launches "
              f"{r['counts']}, expected {want}")
        mflops = model_flops(cfg, InputShape("train_4k", "train", TRAIN_S,
                                             TRAIN_B))
        wall = r["wall_ms"]
        f = cfg.frontend_tokens
        print(f"[arch-train] {arch} at full width and depth "
              f"({cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads (G="
              f"{cfg.num_heads // cfg.num_kv_heads}, dh={cfg.hdim}), d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_size} padded to "
              f"{cfg.padded_vocab}, bf16, remat {cfg.remat}), B={TRAIN_B}, "
              f"S={TRAIN_S} = {f} {cfg.frontend} embeddings + {TRAIN_S - f} "
              f"tokens, AdamW: wall {wall:.1f} ms a step (mean of {n} after "
              f"one warm step; setup and warm step {r['setup_s']:.1f} s), "
              f"device busy {r['busy']:.1f} ms (profiler), idle share "
              f"{1 - r['busy'] / wall:.3f}; {TRAIN_B * TRAIN_S / (wall / 1e3):.0f}"
              f" positions/s ({TRAIN_B * (TRAIN_S - f) / (wall / 1e3):.0f} "
              f"tokens/s); model FLOPs {mflops / 1e12:.2f} TFLOP a step, "
              f"{mflops / (wall / 1e3) / BF16_PEAK:.4f} of the bf16 dense "
              f"peak; peak memory {r['peak'] / 2**30:.2f} GiB; launches "
              f"flash_attention {r['counts']['flash_attention']} "
              f"({2 * cfg.num_layers} a step), flash_attention_bwd "
              f"{r['counts']['flash_attention_bwd']} ({cfg.num_layers} a "
              f"step); kernel 9 {r['attn_fwd_ms']:.1f} ms and the backward "
              f"{r['attn_bwd_ms']:.1f} ms of the profiled step; no library or "
              f"plain attention kernel among its {r['n_events']} device "
              f"kernels; losses {r['losses']}; {smi}")
        print(f"[arch-train] {arch} top device operations of one step: "
              f"{r['tops']}")
        out[arch] = r
    print(f"[arch-train] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def moe_split(cfg, params: dict, b: int, s: int) -> dict:
    """Device ms of one MoE layer's routing and its dispatch, expert and
    combine products at B x S tokens (random activations of the layer's
    shape; the products are dense, so their time does not depend on the
    values), by the profiler: MOE_PROFILED calls of a part in one
    session, each kernel's mean over the events kept times its launches
    a call (late in a long process a session loses its first events)."""
    from repro_torch.models import moe
    p = {k: t[0] for k, t in params["blocks"]["l0"]["moe"].items()}
    g_sz = min(cfg.moe_group_size, b * s)
    xg = torch.randn((b * s // g_sz, g_sz, cfg.d_model), device="cuda"
                     ).to(cfg.param_dtype)
    cap = moe.capacity(g_sz, cfg.num_experts, cfg.experts_per_token,
                       cfg.capacity_factor)
    with torch.no_grad():
        _, _, dispatch, combine = moe.route(p, xg, cfg.num_experts,
                                            cfg.experts_per_token, cap)
        xe = moe.dispatch_tokens(dispatch, xg)
        ye = moe.expert_mlp(p, xe)
        parts = {"route": lambda: moe.route(p, xg, cfg.num_experts,
                                            cfg.experts_per_token, cap),
                 "dispatch": lambda: moe.dispatch_tokens(dispatch, xg),
                 "experts": lambda: moe.expert_mlp(p, xe),
                 "combine": lambda: moe.combine_tokens(combine, ye)}
        return {part: sum(per_call_ms(fn, MOE_PROFILED).values())
                for part, fn in parts.items()}


def moe_phase(kernels: dict, smi: str) -> dict:
    """[moe]: phi3.5-moe-42b-a6.6b and dbrx-132b at full width with their
    depth cut to MOE_LAYERS: phi's train step at B=2, S=4096, then for
    both a prefill at B=1, S=4096 (counted with the train steps) and the
    decode step's CUDA graph; the share of dropped slots and the aux loss
    from the prefill's routing, the dispatch, expert and combine products'
    device time by the profiler."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.hlo_analysis import model_flops
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.inputs import InputShape
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params
    t_phase = time.perf_counter()
    out = {}
    for arch in MOE_ARCHS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
        res, train = {}, None
        if arch == MOE_ARCHS[0]:
            train = arch_train_run(cfg, kernels, 1 + MOE_TIMED,
                                   softmax_ok=3 * MOE_LAYERS, label="[moe]")
            mflops = model_flops(cfg, InputShape("train_4k", "train",
                                                 TRAIN_S, TRAIN_B))
            want = {k: 0 for k in kernels}
            want.update(flash_attention=2 * MOE_LAYERS * MOE_TIMED,
                        flash_attention_bwd=MOE_LAYERS * MOE_TIMED)
            check(train["counts"] == want, f"[moe] {arch} train launches "
                  f"{train['counts']}, expected {want}")
            w = train["wall_ms"]
            print(f"[moe] {arch} train step at full width, depth cut to "
                  f"{MOE_LAYERS} of {full.num_layers} layers ({cfg.d_model} "
                  f"d_model, {cfg.num_experts} experts top-"
                  f"{cfg.experts_per_token}, d_ff {cfg.d_ff}, bf16, remat), "
                  f"B={TRAIN_B}, S={TRAIN_S}: wall {w:.1f} ms a step (mean "
                  f"of {MOE_TIMED}), busy {train['busy']:.1f} ms, idle "
                  f"share {1 - train['busy'] / w:.3f}; "
                  f"{TRAIN_B * TRAIN_S / (w / 1e3):.0f} tokens/s; "
                  f"{mflops / (w / 1e3) / BF16_PEAK:.4f} of the bf16 peak by "
                  f"model FLOPs ({mflops / 1e12:.2f} TFLOP, active experts "
                  f"only); peak memory {train['peak'] / 2**30:.2f} GiB; aux "
                  f"(first and last step) {train['aux']}; losses "
                  f"{train['losses']}; launches "
                  f"{ {k: v for k, v in train['counts'].items() if v} }; no "
                  f"library or plain attention kernel; {smi}")
            print(f"[moe] {arch} train step top device operations: "
                  f"{train['tops']}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(T.model_specs(cfg),
                             torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        toks = torch.randint(0, cfg.vocab_size, (1, MOE_S), device="cuda",
                             generator=torch.Generator(device="cuda")
                             .manual_seed(3))
        for fn in kernels.values():
            fn.launches = 0
        with routings() as rec:
            logits, cache = step_lib.make_prefill_step(cfg)(
                params, {"tokens": toks})
        counts = {n: fn.launches for n, fn in kernels.items()}
        want = {k: 0 for k in kernels}
        want["flash_attention"] = MOE_LAYERS
        check(counts == want and bool(torch.isfinite(logits).all())
              and len(rec) == MOE_LAYERS,
              f"[moe] {arch} prefill: launches {counts}, finite "
              f"{bool(torch.isfinite(logits).all())}, {len(rec)} routings")
        drop = [float((~r["keep"]).float().mean()) for r in rec]
        with torch.no_grad():
            _, metrics = T.loss_fn(cfg, params, {
                "tokens": toks, "labels": torch.roll(toks, -1, 1)})
        aux = float(metrics["aux"])
        peak = torch.cuda.max_memory_allocated()

        def again():
            with torch.no_grad():
                T.prefill(cfg, params, toks)
        wall = wall_ms(again, 3)
        ev = device_events(again)
        busy, tops = top_ops(ev)
        foreign = foreign_attention(ev, softmax_ok=MOE_LAYERS)
        check(not foreign, f"[moe] {arch} prefill: library or plain "
              f"attention kernels {foreign}")
        split = moe_split(cfg, params, 1, MOE_S)
        print(f"[moe] {arch} prefill at full width, depth cut to {MOE_LAYERS}"
              f" of {full.num_layers} layers, B=1, S={MOE_S} (groups of "
              f"{cfg.moe_group_size}, capacity {rec[0]['cap']} slots an "
              f"expert a group): weights drawn in {init_s:.2f} s; wall "
              f"{wall:.1f} ms, busy {busy:.1f} ms, idle share "
              f"{1 - busy / wall:.3f}, peak memory {peak / 2**30:.2f} GiB; "
              f"dropped share of the (token, choice) slots by layer "
              f"{[round(d, 4) for d in drop]}; aux loss {aux:.5f} (summed "
              f"over {MOE_LAYERS} layers; 1 a layer is balanced); launches "
              f"{ {k: v for k, v in counts.items() if v} }; one MoE layer's "
              f"products (profiler): route {split['route']:.3f} ms, dispatch "
              f"{split['dispatch']:.3f}, experts {split['experts']:.3f}, "
              f"combine {split['combine']:.3f} ms (x{MOE_LAYERS} layers: "
              f"{MOE_LAYERS * sum(split.values()) / busy:.3f} of the "
              f"prefill's device time); top device operations: {tops}; {smi}")
        res.update(prefill_ms=wall, busy=busy, drop=drop, aux=aux,
                   split=split, counts=counts, peak=peak, train=train)
        tok = logits.argmax(-1)
        del logits
        res.update(decode_graph_check(cfg, params, cache, tok,
                                      f"[moe] {arch}"))
        out[arch] = res
        del params, cache, toks, tok
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[moe] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def arch_phases(kernels: dict, smi: str) -> tuple[dict, dict]:
    """The seven archs: [arch-check], [arch-reference], [arch-prefill],
    [arch-train] and [moe].  Returns the JSON line's entries (kernel
    results keyed by (kernel, path), each measured at that path's own
    shape) and each path's counts."""
    timed = arch_check(smi)
    arch_reference(kernels, smi)
    pre = arch_prefill(kernels, smi)
    trained = arch_train(kernels, smi)
    moes = moe_phase(kernels, smi)
    ops_path = f"arch_ops {PREFILL_ARCH}"
    paths = {f"arch_prefill {PREFILL_ARCH}": (
        timed[PREFILL_ARCH]["prefill_16k"], pre["counts"]),
        ops_path: ({"golden_attention_decode": pre["ops_entry"]},
                   pre["ops_counts"])}
    for arch, r in trained.items():
        paths[f"arch_train {arch}"] = (timed[arch]["train_4k"], r["counts"])
    for arch, r in moes.items():
        if r["train"] is not None:
            paths[f"moe train {arch}"] = (timed[arch]["train_4k"],
                                          r["train"]["counts"])
        paths[f"moe prefill {arch}"] = (timed[arch]["prefill_4k"],
                                        r["counts"])
    entries = {}
    for path, (at, counts) in paths.items():
        for n, c in counts.items():
            if c:
                entries[(n, path)] = dict(at[n], launches=c)
    return entries, {p: c for p, (_, c) in paths.items()}


def is_gemm(name: str) -> bool:
    return any(f in name.lower() for f in GEMM_NAMES)


def per_call_ms(fn, iters: int) -> Counter:
    """Device ms a call of ``fn`` by kernel name, from the profiler over
    ``iters`` calls in one session: each kernel's mean over the events
    kept times its launches a call (late in a long process a session
    loses its first events)."""
    ms, kept = Counter(), Counter()
    for e in device_events(lambda: [fn() for _ in range(iters)]):
        ms[e.name] += e.time_range.elapsed_us() / 1e3
        kept[e.name] += 1
    return Counter({n: ms[n] / kept[n] * -(-kept[n] // iters) for n in kept})


def by_class(ms: Counter) -> tuple[float, float]:
    """(products, the rest): device ms of cuBLAS's product kernels and of
    every other kernel."""
    prod = sum(v for n, v in ms.items() if is_gemm(n))
    return prod, sum(ms.values()) - prod


def ssd_check(smi: str) -> None:
    """[mamba-check]: ``ssd_chunked`` on the card at SSD_CHECK from an
    initial state: the card's fp32 against the CPU's fp32 (y and the
    final state within SSD_CARD_TOL of their max abs, the gradients of
    x, dt, B, C and the initial state within ARCH_REF_TOL), and the bf16
    path (x, B and C in bf16) against an fp32 run on the card of the same
    values (y within SSD_BF16_TOL, the state within SSD_CARD_TOL)."""
    import torch.nn.functional as F
    from repro_torch.models.mamba2 import ssd_chunked
    b, s, h, p, n, chunk = SSD_CHECK
    gen = torch.Generator().manual_seed(23)

    def rn(*shape):
        return torch.randn(shape, generator=gen)
    x, bi, ci = rn(b, s, h, p), rn(b, s, n), rn(b, s, n)
    dt, d, st = F.softplus(rn(b, s, h) - 3), rn(h), rn(b, h, p, n)
    a = -torch.arange(1.0, h + 1)
    gy, gs = rn(b, s, h, p), rn(b, h, p, n)

    def run(dev, dtype=torch.float32):
        ins = [t.to(dev) for t in (x, dt, a, bi, ci, d, st)]
        for i in (0, 3, 4):
            ins[i] = ins[i].to(dtype)
        live = [ins[i].detach().requires_grad_() for i in (0, 1, 3, 4, 6)]
        y, fin = ssd_chunked(live[0], live[1], ins[2], live[2], live[3],
                             ins[5], chunk, live[4])
        grads = torch.autograd.grad((y, fin), live, (gy.to(dev, y.dtype),
                                                     gs.to(dev)))
        return [t.detach().float().cpu() for t in (y, fin, *grads)]

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())
    card_, cpu = run("cuda"), run("cpu")
    errs = [rel(c, h_) for c, h_ in zip(card_, cpu)]
    for t in (x, bi, ci):                       # the bf16 values, in fp32
        t.copy_(t.bfloat16().float())
    half, full = run("cuda", torch.bfloat16), run("cuda")
    berrs = [rel(half[0], full[0]), rel(half[1], full[1])]
    check(max(errs[:2]) <= SSD_CARD_TOL and max(errs[2:]) <= ARCH_REF_TOL
          and berrs[0] <= SSD_BF16_TOL and berrs[1] <= SSD_CARD_TOL,
          f"mamba-check ssd_chunked {SSD_CHECK}: card vs CPU fp32 (y, "
          f"state, grads) {errs}, bf16 vs fp32 (y, state) {berrs}")
    print(f"[mamba-check] ssd_chunked B={b}, S={s}, H={h}, P={p}, N={n}, "
          f"chunk {chunk} ({s // chunk} chunks, from an initial state): "
          f"card fp32 against CPU fp32, max abs difference / max abs: y "
          f"{errs[0]:.3g}, final state {errs[1]:.3g} (tolerance "
          f"{SSD_CARD_TOL}); gradients of x, dt, B, C, the initial state "
          f"{[f'{e:.3g}' for e in errs[2:]]} (tolerance {ARCH_REF_TOL}); "
          f"bf16 x, B, C against fp32 on the card on the same values: y "
          f"{berrs[0]:.3g} (tolerance {SSD_BF16_TOL}), state {berrs[1]:.3g} "
          f"(tolerance {SSD_CARD_TOL}); {smi}")


def ssd_split(cfg, b: int, s: int) -> dict:
    """Device ms of one Mamba layer's ``ssd_chunked`` at [b, s] (random
    inputs of the layer's shape and dtypes; the products are dense, so
    their time does not depend on the values), by the profiler
    (MAMBA_PROFILED calls a part): the forward without a gradient (a
    remat step's first pass) and the forward with the backward (its
    recompute and backward), each as (products, the rest)."""
    import torch.nn.functional as F
    from repro_torch.models import transformer as T
    from repro_torch.models.mamba2 import ssd_chunked
    dm = T._mamba_dims(cfg)
    gen = torch.Generator(device="cuda").manual_seed(29)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    bf = cfg.param_dtype
    x = rn(b, s, dm.heads, dm.head_dim, dtype=bf)
    bi, ci = (rn(b, s, dm.state, dtype=bf) for _ in range(2))
    dt = F.softplus(rn(b, s, dm.heads) - 3)
    a = -torch.arange(1.0, dm.heads + 1, device="cuda")
    dsk = torch.ones(dm.heads, device="cuda")
    live = [t.detach().requires_grad_() for t in (x, dt, bi, ci)]
    gy = rn(b, s, dm.heads, dm.head_dim, dtype=bf)
    gs = rn(b, dm.heads, dm.head_dim, dm.state)

    def fwd():
        with torch.no_grad():
            ssd_chunked(x, dt, a, bi, ci, dsk, cfg.ssm_chunk)

    def fwd_bwd():
        y, st = ssd_chunked(live[0], live[1], a, live[2], live[3], dsk,
                            cfg.ssm_chunk)
        torch.autograd.grad((y, st), live, (gy, gs))
    return {"forward": by_class(per_call_ms(fwd, MAMBA_PROFILED)),
            "forward and backward": by_class(per_call_ms(fwd_bwd,
                                                         MAMBA_PROFILED))}


def state_decode_check(cfg, params, cache, tok, s0: int, label: str
                       ) -> dict:
    """``make_decode_step``'s CUDA graph of a model without attention:
    one capturing call at position ``s0`` (its eager step advances the
    states once; the capture runs nothing), then MAMBA_REPLAYS replays
    against as many eager ``decode_step`` calls from a copy of the same
    cache (the same tokens): logits and every state within REPLAY_TOL;
    walls, idle shares, and the graph's ms a token against the weights'
    read at the HBM rate."""
    from repro_torch.launch import steps as step_lib
    from repro_torch.models import transformer as T
    from repro_torch.models.module import tree_leaves, tree_map
    eager_c = tree_map(torch.clone, cache)
    step = step_lib.make_decode_step(cfg)
    t = tok
    with torch.no_grad():
        step(params, cache, t, s0)
        T.decode_step(cfg, params, eager_c, t, s0)
        diff = 0.0
        for pos in range(s0 + 1, s0 + 1 + MAMBA_REPLAYS):
            want, _ = T.decode_step(cfg, params, eager_c, t, pos)
            got, _ = step(params, cache, t, pos)
            diff = max(diff, float((got.float() - want.float()).abs().max()))
            t = want.argmax(-1)
        sdiff = max(float((a.float() - b.float()).abs().max()) for (_, a), (
            _, b) in zip(tree_leaves(eager_c), tree_leaves(cache)))
    check(diff <= REPLAY_TOL and sdiff <= REPLAY_TOL
          and len(step.graphs) == 1,
          f"{label} decode graph: {MAMBA_REPLAYS} replays against eager "
          f"steps: logits {diff:.3g}, states {sdiff:.3g}, "
          f"{len(step.graphs)} graphs")
    pos = s0 + MAMBA_REPLAYS + 1
    with torch.no_grad():
        eager = lambda: T.decode_step(cfg, params, eager_c, t, pos)  # noqa: E731
        graph = lambda: step(params, cache, t, pos)  # noqa: E731
        w_e, w_g = wall_ms(eager, 5), wall_ms(graph, 20)
        b_e, _ = device_kernels(eager)
        b_g, tops = top_ops(device_events(graph), 6)
    w_bytes = sum(x.numel() * x.element_size() for _, x in tree_leaves(params))
    read = w_bytes / HBM_BYTES_PER_S * 1e3
    print(f"{label} decode graph, B={tok.shape[0]}: {MAMBA_REPLAYS} replays "
          f"equal to {MAMBA_REPLAYS} eager decode_step calls from a copy of "
          f"the same cache (logits max abs {diff:.3g}, states {sdiff:.3g}; "
          f"tolerance {REPLAY_TOL}: bit-equal), 1 graph; eager {w_e:.3f} ms "
          f"a token (idle share {1 - b_e / w_e:.3f}), graph {w_g:.3f} ms "
          f"(idle share {1 - b_g / w_g:.3f}), {w_g / read:.2f}x the "
          f"{w_bytes / 2**30:.2f} GiB weight read at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s ({read:.3f} ms); the replay's "
          f"top device operations: {tops}")
    del eager_c, step
    return dict(eager_ms=w_e, graph_ms=w_g, read_ms=read,
                eager_idle=1 - b_e / w_e, graph_idle=1 - b_g / w_g)


def draw_params(cfg) -> tuple[dict, float, int]:
    """Random weights of ``cfg`` drawn on the card (seed 0): the tree,
    its seconds and the bytes it holds."""
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(T.model_specs(cfg),
                         torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    return (params, time.perf_counter() - t0,
            torch.cuda.memory_allocated() - held)


def state_prefill(cfg, params, kernels: dict, label: str, softmax_ok: int
                  ) -> dict:
    """A prefill of ``cfg`` at B=1, S=MAMBA_S through
    ``make_prefill_step`` with every count set to 0 just before and read
    just after: logits finite, peak memory; then its wall (mean of 2
    after 2), its device busy time, top kernels and kernel 9's ms by the
    profiler (no library or plain attention kernel; ``softmax_ok``
    router softmaxes)."""
    from repro_torch.launch import steps as step_lib
    from repro_torch.models import transformer as T
    toks = torch.randint(0, cfg.vocab_size, (1, MAMBA_S), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, cache = step_lib.make_prefill_step(cfg)(params, {"tokens": toks})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {n: fn.launches for n, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits).all())
    check(tuple(logits.shape) == (1, cfg.padded_vocab) and finite,
          f"{label} prefill: logits {tuple(logits.shape)}, finite {finite}")

    def again():
        with torch.no_grad():
            T.prefill(cfg, params, toks)
    wall = wall_ms(again, 2)
    ev = device_events(again)
    busy, tops = top_ops(ev)
    foreign = foreign_attention(ev, softmax_ok)
    check(not foreign, f"{label} prefill: library or plain attention "
          f"kernels {foreign}")
    ms = Counter()
    for e in ev:
        ms[launch_name(e.name)] += e.time_range.elapsed_us() / 1e3
    prod, rest = by_class(ms)
    return dict(logits=logits, cache=cache, counts=counts, peak=peak,
                first_s=first_s, wall=wall, busy=busy, tops=tops,
                products=prod, rest=rest, attn_ms=ms[OURS[0]])


def mamba_phases(kernels: dict, smi: str) -> tuple[dict, dict]:
    """[mamba-check], [mamba-reference] and [mamba]: the SSD on the card
    against the CPU and bf16 against fp32; both archs' reduced configs
    card against CPU; mamba2-2.7b at full width and depth trained (B=2,
    S=4096, remat: every leaf moves, the loss finite; tokens/s, the share
    of the bf16 peak by model FLOPs, peak memory, the device time split
    into the SSD's products, the other GEMMs and the elementwise work),
    prefilled at B=1, S=MAMBA_S and decoded through the CUDA graph (no
    hand kernel on its path: every count stays 0); jamba-v0.1-52b at
    full width over HYBRID_LAYERS layers: kernel 9 checked and timed at
    its prefill's shape before the weights are drawn, the prefill
    counted (kernel 9 once), the decode graph full and golden.  Returns
    the JSON line's entry of jamba's prefill path and its counts."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.hlo_analysis import model_flops
    from repro_torch.launch.inputs import InputShape
    t_phase = time.perf_counter()
    ssd_check(smi)
    arch_reference(kernels, smi, MAMBA_ARCHS, "[mamba-reference]",
                   MAMBA_REF_GRAD_TOL)
    zero = {n: 0 for n in kernels}

    # -- mamba2-2.7b: the train step ------------------------------------------
    cfg = get_config(MAMBA_ARCH)
    r = arch_train_run(cfg, kernels, 1 + MAMBA_TIMED, label="[mamba]",
                       moved=True)
    check(r["counts"] == zero and r["moved"] == r["leaves"],
          f"[mamba] {MAMBA_ARCH} train: launches {r['counts']}, "
          f"{r['moved']} of {r['leaves']} leaves moved")
    mflops = model_flops(cfg, InputShape("train_4k", "train", TRAIN_S,
                                         TRAIN_B))
    wall, busy = r["wall_ms"], r["busy"]
    prod, rest = by_class(r["by_name"])
    sp = ssd_split(cfg, TRAIN_B, TRAIN_S)
    n = cfg.num_layers
    ssd_prod = n * (sp["forward"][0] + sp["forward and backward"][0])
    ssd_rest = n * (sp["forward"][1] + sp["forward and backward"][1])
    print(f"[mamba] {MAMBA_ARCH} at full width and depth ({n} layers, "
          f"d_model {cfg.d_model}, "
          f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} SSD heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk},"
          f" vocab {cfg.vocab_size}, bf16, remat {cfg.remat}), B={TRAIN_B}, "
          f"S={TRAIN_S}, AdamW: wall {wall:.1f} ms a step (mean of "
          f"{MAMBA_TIMED} after one warm step; setup and warm step "
          f"{r['setup_s']:.1f} s), device busy {busy:.1f} ms (profiler), "
          f"idle share {1 - busy / wall:.3f}; "
          f"{TRAIN_B * TRAIN_S / (wall / 1e3):.0f} tokens/s; model FLOPs "
          f"{mflops / 1e12:.2f} TFLOP a step, "
          f"{mflops / (wall / 1e3) / BF16_PEAK:.4f} of the bf16 dense peak; "
          f"peak memory {r['peak'] / 2**30:.2f} GiB; all {r['leaves']} "
          f"leaves moved; launches of the hand kernels: none (no "
          f"attention layer); losses {r['losses']}; {smi}")
    print(f"[mamba] {MAMBA_ARCH} step device split (profiler): cuBLAS "
          f"products {prod:.1f} ms ({prod / busy:.3f}), the rest "
          f"(elementwise, reductions, copies, AdamW) {rest:.1f} ms "
          f"({rest / busy:.3f}); the SSD ({n} layers x one layer's "
          f"forward without a gradient + forward and backward, "
          f"{MAMBA_PROFILED} calls each by the profiler): products "
          f"{ssd_prod:.1f} ms, the rest {ssd_rest:.1f} ms, "
          f"{(ssd_prod + ssd_rest) / busy:.3f} of the step's busy time (a "
          f"layer: forward {sum(sp['forward']):.3f} ms, forward and "
          f"backward {sum(sp['forward and backward']):.3f} ms); the other "
          f"GEMMs {prod - ssd_prod:.1f} ms, the other elementwise work "
          f"{rest - ssd_rest:.1f} ms; top device operations: {r['tops']}")
    out = {"train": dict(r, ssd_ms=ssd_prod + ssd_rest)}

    # -- mamba2-2.7b: prefill and the decode graph ----------------------------
    params, init_s, w_bytes = draw_params(cfg)
    pre = state_prefill(cfg, params, kernels, f"[mamba] {MAMBA_ARCH}", 0)
    check(pre["counts"] == zero, f"[mamba] {MAMBA_ARCH} prefill launches "
          f"{pre['counts']}")
    cache = pre.pop("cache")
    tok = pre.pop("logits").argmax(-1)
    state_mib = sum(t.numel() * t.element_size() for lc in cache.values()
                    for t in lc.values()) / 2**20
    print(f"[mamba] {MAMBA_ARCH} prefill B=1, S={MAMBA_S}: weights "
          f"{w_bytes / 2**30:.2f} GiB drawn in {init_s:.2f} s; first call "
          f"{pre['first_s']:.2f} s, wall {pre['wall']:.1f} ms (mean of 2 "
          f"after 2), device busy {pre['busy']:.1f} ms, idle share "
          f"{1 - pre['busy'] / pre['wall']:.3f}; cuBLAS products "
          f"{pre['products']:.1f} ms, the rest {pre['rest']:.1f} ms; peak "
          f"memory {pre['peak'] / 2**30:.2f} GiB; the cache (conv and SSM "
          f"states) {state_mib:.1f} MiB; "
          f"launches of the hand kernels: none; top device operations: "
          f"{pre['tops']}; {smi}")
    out["prefill"] = pre
    out["decode"] = state_decode_check(cfg, params, cache, tok, MAMBA_S,
                                       f"[mamba] {MAMBA_ARCH}")
    del params, cache, tok
    gc.collect()
    torch.cuda.empty_cache()

    # -- jamba-v0.1-52b over one period: kernel 9 at its prefill's shape ------
    full = get_config(HYBRID_ARCH)
    cfg = dataclasses.replace(full, num_layers=HYBRID_LAYERS)
    hkv, g, dh = arch_shape(cfg)
    gen = torch.Generator(device="cuda").manual_seed(31)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    timed = attn_at(randn, HYBRID_ARCH, hkv, g, dh, 1, MAMBA_S, False, smi)
    params, init_s, w_bytes = draw_params(cfg)
    n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.period))
    pre = state_prefill(cfg, params, kernels, f"[mamba] {HYBRID_ARCH}",
                        n_moe * cfg.repeats)
    want = dict(zero, flash_attention=cfg.pattern.count("A") * cfg.repeats)
    check(pre["counts"] == want, f"[mamba] {HYBRID_ARCH} prefill launches "
          f"{pre['counts']}, expected {want}")
    cache = pre.pop("cache")
    tok = pre.pop("logits").argmax(-1)
    launched = {k: v for k, v in pre["counts"].items() if v}
    print(f"[mamba] {HYBRID_ARCH} at full width, depth cut to "
          f"{HYBRID_LAYERS} of {full.num_layers} layers (pattern "
          f"{''.join(cfg.pattern)}: {cfg.pattern.count('M')} Mamba, 1 "
          f"attention of {cfg.num_heads}/{hkv} heads, MoE {cfg.num_experts} "
          f"experts top-{cfg.experts_per_token} on {n_moe}, bf16): weights "
          f"{w_bytes / 2**30:.2f} GiB drawn in {init_s:.2f} s; prefill B=1, "
          f"S={MAMBA_S}: first call {pre['first_s']:.2f} s, wall "
          f"{pre['wall']:.1f} ms, device busy {pre['busy']:.1f} ms, idle "
          f"share {1 - pre['busy'] / pre['wall']:.3f}; kernel 9 "
          f"{pre['attn_ms']:.2f} ms ({pre['attn_ms'] / pre['busy']:.4f}); "
          f"cuBLAS products {pre['products']:.1f} ms, the rest "
          f"{pre['rest']:.1f} ms; peak memory {pre['peak'] / 2**30:.2f} GiB;"
          f" launches {launched}; top device operations: {pre['tops']}; "
          f"{smi}")
    dec = decode_graph_check(cfg, params, cache, tok,
                             f"[mamba] {HYBRID_ARCH}")
    out["hybrid"] = dict(pre, **dec)
    del params, cache, tok
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mamba] phase {time.perf_counter() - t_phase:.1f} s")
    path = f"mamba prefill {HYBRID_ARCH}"
    entries = {(n_, path): dict(timed[n_], launches=c)
               for n_, c in pre["counts"].items() if c}
    return entries, {path: pre["counts"]}


# The [presets] phase: the batch of the card-vs-CPU checks of the PCA
# baseline (not served; its CPU full scan takes seconds a query) and of
# the "ss" full scan, the PCA "ss" full scan against the same denoiser on
# support = every row (the reference's own bound,
# tests/test_denoisers.py:75-84), and the card's PCA features against a
# float64 CPU convolution.  GoldDiff+PCA is checked at the served B.
PRESET_CHECK_B = 4
PCA_SS_TOL = 2e-4
FEAT_RTOL = 1e-5


# The [mesh] phase (``mesh_phases``): the LLM's logical sharding on a
# one-rank NCCL group with a (1, 1) ("data", "model") device mesh (one
# card; NCCL refuses two ranks on one device).  llama3.2-3b trains at full
# width and depth under make_rules("train", mesh) from [train]'s weights
# and batches (one warm step, MESH_TIMED counted), then prefills and
# decodes (eager, full and golden) under the prefill and decode rules,
# each bit-equal to the one-device path (one rank splits nothing: the
# layouts are the identity); the reduced config trains with two
# microbatches and shard_grad_accum and with zero1_rules against the
# one-device step.  [dryrun] traces DRYRUN_ARCHS at the four shapes on
# the 16 x 16 mesh (fake CUDA tensors, a fake group of 256 ranks), one
# subprocess an arch side by side: `--all` took 224.0 s on the card's
# host (jamba's train_4k about 100 s of it), over the 150 s this phase
# allows it, so four archs; in one subprocess they took 182.6-235.2 s,
# side by side about jamba's alone.
MESH_ARCH, MESH_TIMED = "llama3.2-3b", 3
MESH_LOSS_REL = 1e-4       # the mesh step's losses against [train]'s
MESH_REF_TOL = 1e-5        # reduced config: mesh vs one-device loss (fp32)
MESH_GNORM_TOL = 1e-4      # ... and gradient norm, relative
DRYRUN_ARCHS = ("llama3.2-3b", "qwen2.5-32b", "dbrx-132b", "jamba-v0.1-52b")
DRYRUN_TIMEOUT = 600
TRAIN_RUN: dict = {}       # [train]'s losses, wall, busy and peak


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phases(kernels: dict, smi: str) -> tuple[dict, dict]:
    """[mesh] (see the note above).  Returns the result entries of kernel
    9 and the backward at the mesh train path's shape and that path's
    counts."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.distributed.hlo_analysis import model_flops
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.inputs import InputShape
    from repro_torch.launch.mesh import make_debug_device_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.module import (init_params, param_shardings,
                                           place_params, place_tree,
                                           tree_leaves, tree_map)
    from repro_torch.training import optimizer as opt
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_debug_device_mesh(1, 1, "cuda")
        cuda = torch.device("cuda")
        cfg = get_config(MESH_ARCH)

        # -- [mesh] llama3.2-3b's train step at full width and depth --------
        rules = make_rules("train", mesh)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, state, batches, step = train_lib.setup(
            cfg, 1 + MESH_TIMED, TRAIN_B, TRAIN_S, cuda, rules=rules)

        def one(i):
            nonlocal params, state
            params, state, m = step(params, state, batches[i % len(batches)])
            return m
        losses = [float(one(0)["loss"])]
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for i in range(1, 1 + MESH_TIMED):
            m = one(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / MESH_TIMED
        counts = {n: f.launches for n, f in kernels.items()}
        losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated()
        want = {n: 0 for n in kernels}
        want.update(flash_attention=2 * cfg.num_layers * MESH_TIMED,
                    flash_attention_bwd=cfg.num_layers * MESH_TIMED)
        check(counts == want, f"[mesh] train launches {counts}, expected "
              f"{want}")
        ev = device_events(lambda: one(0))
        busy, tops = top_ops(ev)
        foreign = foreign_attention(ev)
        by = Counter(launch_name(e.name) for e in ev)
        check(not foreign and by[OURS[0]] == 2 * cfg.num_layers
              and all(by[n] == cfg.num_layers for n in OURS[1:]),
              f"[mesh] train profile: kernel launches {dict(by)}, library "
              f"or plain attention {foreign}")
        ref_l = TRAIN_RUN.get("losses", [])
        rel = max((abs(a - b) / abs(b) for a, b in zip(losses, ref_l)),
                  default=float("nan"))
        check(len(ref_l) == 2 and rel <= MESH_LOSS_REL,
              f"[mesh] train losses {losses} against [train]'s {ref_l}: "
              f"relative {rel:.3g} > {MESH_LOSS_REL}")
        mflops = model_flops(cfg, InputShape("train_4k", "train", TRAIN_S,
                                             TRAIN_B))
        tw, tb = TRAIN_RUN.get("wall_ms", float("nan")), \
            TRAIN_RUN.get("busy_ms", float("nan"))
        print(f"[mesh] {cfg.name} train step under make_rules('train', "
              f"mesh) on a (1, 1) ('data', 'model') NCCL device mesh, full "
              f"width and depth, B={TRAIN_B}, S={TRAIN_S}, [train]'s weights "
              f"and batches: wall {wall:.1f} ms a step (mean of {MESH_TIMED} "
              f"after one warm step; setup and warm step {setup_s:.1f} s), "
              f"device busy {busy:.1f} ms (profiler), idle share "
              f"{1 - busy / wall:.3f}; [train] wall {tw:.1f} ms, busy "
              f"{tb:.1f} ms, idle share {1 - tb / tw:.3f}; the mesh step "
              f"{wall / tw:.3f}x [train]'s wall; "
              f"{TRAIN_B * TRAIN_S / (wall / 1e3):.0f} tokens/s, "
              f"{mflops / (wall / 1e3) / BF16_PEAK:.4f} of the bf16 dense "
              f"peak by model FLOPs; peak memory {peak / 2**30:.2f} GiB "
              f"([train] {TRAIN_RUN.get('peak', 0) / 2**30:.2f} GiB); losses "
              f"{losses} against [train]'s {ref_l}: "
              + ("bit-equal" if losses == ref_l else
                 f"max relative difference {rel:.3g} (on one rank the mesh "
                 f"step runs [train]'s operations on the same shapes, its "
                 f"per-shard log-sum-exp torch.logsumexp over the whole "
                 f"vocabulary; a difference is an operation run in another "
                 f"order or by another kernel, which this check does not "
                 f"name)")
              + f"; launches flash_attention {counts['flash_attention']}, "
              f"flash_attention_bwd {counts['flash_attention_bwd']} over "
              f"{MESH_TIMED} steps; the profiled step: {by[OURS[0]]} kernel 9 "
              f"launches, " + ", ".join(f"{n} {by[n]}" for n in OURS[1:])
              + f", no library or plain attention among {len(ev)} device "
              f"kernels; {smi}")
        print(f"[mesh] top device operations of one step: {tops}")
        del params, state, batches, step, one, ev
        gc.collect()
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(29)
        entries = attn_at(lambda shp, dt: torch.randn(
            shp, generator=gen, device="cuda").to(dt), "mesh train",
            cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, cfg.hdim,
            TRAIN_B, TRAIN_S, True, smi)

        # -- [mesh] the reduced config: microbatches and ZeRO-1 -------------
        rcfg = cfg.reduced()
        specs = T.model_specs(rcfg)
        pipe = TokenPipeline(TokenPipelineConfig(rcfg.vocab_size,
                                                 TRAIN_REF_S, TRAIN_REF_B))
        rb = [{k: t.to(cuda) for k, t in pipe.batch(i).items()}
              for i in range(2)]
        ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
        zr = make_rules("train", mesh)
        for label, nmb, sga, z in (("two microbatches, shard_grad_accum", 2,
                                    True, False), ("zero1_rules", 1, False,
                                                   True)):
            def fresh():
                return init_params(specs, torch.Generator(
                    device="cuda").manual_seed(0))
            p1 = fresh()
            s1 = opt.init_state(p1)
            st1 = step_lib.make_train_step(rcfg, None, ocfg, nmb)
            r = (make_rules("train", mesh, overrides={"embed": None}) if z
                 else rules)
            pm = place_params(fresh(), specs, r)
            sm = opt.init_state(pm, param_shardings(specs, zr) if z
                                else None)
            stm = step_lib.make_train_step(rcfg, r, ocfg, nmb,
                                           shard_grad_accum=sga,
                                           zero1_rules=zr if z else None)
            errs = []
            for bt in rb:
                p1, s1, m1 = st1(p1, s1, bt)
                pm, sm, mm = stm(pm, sm, bt)
                errs.append((abs(float(mm["loss"]) - float(m1["loss"])),
                             abs(float(mm["grad_norm"])
                                 - float(m1["grad_norm"]))
                             / float(m1["grad_norm"])))
            check(all(a <= MESH_REF_TOL and b <= MESH_GNORM_TOL
                      for a, b in errs), f"[mesh] reduced {label}: (loss, "
                  f"grad norm) errors {errs}")
            print(f"[mesh] {rcfg.name} ({rcfg.num_layers} layers, fp32) "
                  f"{label}, B={TRAIN_REF_B}, S={TRAIN_REF_S}, two steps on "
                  f"the mesh and on one device from the same weights: "
                  f"(loss abs, grad norm rel) differences "
                  f"{[(f'{a:.3g}', f'{b:.3g}') for a, b in errs]} (tolerance "
                  f"{MESH_REF_TOL}, {MESH_GNORM_TOL})")
            del p1, s1, pm, sm
        gc.collect()
        torch.cuda.empty_cache()

        # -- [mesh] prefill and eager decode under their rules --------------
        params = init_params(T.model_specs(cfg),
                             torch.Generator(device="cuda").manual_seed(0))
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                             device="cuda", generator=gen)
        with torch.no_grad():
            want_l, cache1 = T.prefill(cfg, params, toks)
        pr = make_rules("prefill", mesh)
        pp = place_params(params, T.model_specs(cfg), pr)
        for fn in kernels.values():
            fn.launches = 0
        got_l, _ = step_lib.make_prefill_step(cfg, pr)(pp, {"tokens": toks})
        pcount = kernels["flash_attention"].launches
        got_l = got_l.full_tensor()
        perr = float((got_l.float() - want_l.float()).abs().max()
                     / want_l.float().abs().max())
        check(torch.equal(got_l, want_l) and pcount == cfg.num_layers,
              f"[mesh] prefill: logits not bit-equal to the one-device "
              f"prefill's (max abs / max {perr:.3g}), kernel 9 launches "
              f"{pcount}")
        del pp, got_l
        dr = make_rules("decode", mesh)
        pd = place_params(params, T.model_specs(cfg), dr)
        cache_axes = {p: ax for p, (_, ax, _) in tree_leaves(
            T.cache_specs(cfg, TRAIN_B, TRAIN_S))}
        tok, pos = toks[:, -1], TRAIN_S - 1
        dec = {}
        for kind in ("full", "golden"):
            c = dataclasses.replace(cfg, attn_kind_decode=kind,
                                    golden_blocks=TRAIN_S
                                    // cfg.golden_block_size // 8)
            one_c = tree_map(torch.clone, cache1)
            mesh_c = place_tree(tree_map(torch.clone, cache1), cache_axes, dr)
            with torch.no_grad():
                w1, _ = T.decode_step(c, params, one_c, tok, pos)
            mstep = step_lib.make_decode_step(c, dr)
            g1, _ = mstep(pd, mesh_c, tok, pos)
            g1 = g1.full_tensor()
            err = float((g1.float() - w1.float()).abs().max()
                        / w1.float().abs().max())
            same = torch.equal(g1, w1)
            t_one = wall_ms(lambda: T.decode_step(c, params, one_c, tok, pos))
            t_mesh = wall_ms(lambda: mstep(pd, mesh_c, tok, pos))
            check(same, f"[mesh] decode {kind}: logits not bit-equal to "
                  f"the one-device step's (max abs / max {err:.3g})")
            dec[kind] = (err, t_one, t_mesh)
            del one_c, mesh_c
        print(f"[mesh] {cfg.name} prefill under make_rules('prefill', mesh), "
              f"B={TRAIN_B}, S={TRAIN_S}: last logits against the one-device "
              f"prefill bit-equal (max abs / max {perr:.3g}), kernel 9 "
              f"launches {pcount}; eager decode under "
              f"make_rules('decode', mesh) at pos {pos}: " + "; ".join(
                  f"{k} logits bit-equal (max abs / max {e:.3g}), wall "
                  f"{tm:.2f} ms a step against "
                  f"the one-device eager step's {to:.2f} ms"
                  for k, (e, to, tm) in dec.items()) + f"; {smi}")
        del params, pd, cache1, want_l
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s")
    return ({(n, "mesh train"): dict(r, launches=counts[n])
             for n, r in entries.items()}, {"mesh train": counts})


def dryrun_phase(smi: str) -> None:
    """[dryrun]: ``python -m repro_torch.launch.dryrun`` on each of
    DRYRUN_ARCHS at the four shapes (16 x 16, fake CUDA tensors), one
    subprocess an arch, all started together: the traces are the host's
    work alone, and this phase is the last, so they share its cores with
    nothing measured; one line a combination, each record's fits_hbm and
    bottleneck.  A subprocess past DRYRUN_TIMEOUT fails the run; every
    one is stopped before the phase returns or fails."""
    import os
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env=env) for a in DRYRUN_ARCHS]
    runs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(
                1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
            runs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for a, (rc, out, err) in zip(DRYRUN_ARCHS, runs):
        lines = [x for x in out.splitlines()
                 if x.startswith(("OK ", "FAIL "))]
        for x in lines:
            print(f"[dryrun] {x}")
        ok = sum(x.startswith("OK ") for x in lines)
        check(rc == 0 and ok == 4, f"[dryrun] {a}: {ok} of 4 shapes "
              f"traced (exit {rc}): {err[-3000:]}")
    print(f"[dryrun] {len(DRYRUN_ARCHS)} archs x 4 shapes on the 16 x 16 "
          f"mesh (fake CUDA tensors, a fake group of 256 ranks; one "
          f"subprocess an arch, side by side) in "
          f"{time.perf_counter() - t0:.1f} s; per-card numbers are "
          f"extrapolated from 1 and 2 layer periods (and 2 and 3 "
          f"microbatches); the host of {smi}")


def cut_sets(pick_k: torch.Tensor, pick_r: torch.Tensor,
             d2r: torch.Tensor) -> tuple[int, int]:
    """Two [B, m] picks of the m nearest of one [B, P] pool (column
    indices into ``d2r``, the plain distances; ``pick_r`` ascending by
    them): the rows equal as sets and the slots in one pick only.  Fails
    unless each such slot is a near tie at the cut: its plain distance
    within DIST_RTOL of the m-th."""
    mem_k = torch.zeros(d2r.shape, dtype=torch.bool, device=d2r.device
                        ).scatter_(1, pick_k, True)
    mem_r = torch.zeros_like(mem_k).scatter_(1, pick_r, True)
    diff = mem_k ^ mem_r
    cut = d2r.gather(1, pick_r[:, -1:])
    near = (d2r - cut).abs() <= DIST_RTOL * cut.abs().clamp_min(1.0)
    check(not bool((diff & ~near).any()),
          f"picks differ beyond near ties at the cut: {int(diff.sum())} "
          f"slots, {int((diff & ~near).sum())} not near")
    return int((~diff).all(1).sum()), int(diff.sum())


def presets_phase(kernels: dict) -> None:
    """[presets]: the paper's presets (``repro_torch.configs.golddiff``)
    through the port's entry points.  The cifar10 preset (cifar_like
    N=8192, PCA rank 8, ddpm_linear, 10 DDIM steps) served by a static
    ``ServeEngine(base="pca")``; paired trajectories from one x_T
    (``denoise_trajectory``): GoldDiff+PCA, the PCA baseline (weighting
    "wss") and its "ss" form, GoldDiff+Kamb and the Kamb full scan,
    GoldDiff+Optimal; the imagenet preset (imagenet_like N=20000,
    64x64x3): GoldDiff+PCA and the PCA baseline; then the card against
    the CPU's plain versions, the first step's golden supports, the
    "ss" full scan against support = every row, and the PCA features
    and box sums in fp32 with cuDNN's TF32 turned on around them.
    Kernels 1 and 2 are held against their plain versions at the
    imagenet preset's shapes, on the inputs of its first step and of
    its step with the largest m_t."""
    import torch.nn.functional as F

    from repro_torch.configs.golddiff import PRESETS
    from repro_torch.core import (GoldDiff, denoise_trajectory,
                                  make_denoiser, make_schedule,
                                  sampling_timesteps)
    from repro_torch.core import denoisers as den_mod
    from repro_torch.data import make_dataset
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import Request, ServeEngine

    t_phase = time.perf_counter()
    patch_route = ("pdist", "support_sqdist")

    def mark(label: str) -> None:
        print(f"[presets] {label} done at {time.perf_counter() - t_phase:.1f}"
              f" s into the phase")

    def counted(fn):
        for kfn in kernels.values():
            kfn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {n: f.launches
                                               for n, f in kernels.items()}

    def want(names, n: int) -> dict:
        return {k: n if k in names else 0 for k in kernels}

    def build_store(preset):
        t0 = time.perf_counter()
        st = make_dataset(preset.dataset, **preset.dataset_kw)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t0

    def build_caches(den, sched, steps) -> tuple[list, float]:
        ts = sampling_timesteps(sched, steps)[:-1]
        t0 = time.perf_counter()
        den.build_caches(ts)
        torch.cuda.synchronize()
        return (sorted({den.patch_size(int(t)) for t in ts}, reverse=True),
                time.perf_counter() - t0)

    def paired(tag: str, runs: dict, sched, x_T, steps: int) -> dict:
        """Each trajectory from ``x_T``: warmed, counted (the kernels its
        route launches once a step, no other), its wall (the mean of
        back-to-back runs), busy and idle share, top kernels and peak
        memory."""
        out = {}
        for label, (den, names, iters) in runs.items():
            def fn(den=den):
                return denoise_trajectory(den, sched, x_T, steps)[0]
            t_run = time.perf_counter()
            fn()                               # builds caches, warms kernels
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            x0, _, counts = counted(fn)
            peak = torch.cuda.max_memory_allocated()
            check(bool(torch.isfinite(x0).all()),
                  f"[presets] {tag} {label}: non-finite trajectory")
            check(counts == want(names, steps),
                  f"[presets] {tag} {label}: launches {counts}")
            t0 = time.perf_counter()          # warm already: no warm-up
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
            idle, busy = profile_line(f"presets {tag} {label}", wall, fn)
            print(f"[presets] {tag} {label}: wall {wall:.2f} ms (mean of "
                  f"{iters} back-to-back trajectories, B={x_T.shape[0]}, "
                  f"{steps} steps), device busy {busy:.2f} ms, idle share "
                  f"{idle:.3f}; peak memory {peak / 2**20:.1f} MiB "
                  f"(max_memory_allocated; {(peak - base_mem) / 2**20:.1f} "
                  f"MiB over what was held before); launches "
                  f"{ {n: c for n, c in counts.items() if c} }; all this in "
                  f"{time.perf_counter() - t_run:.1f} s")
            out[label] = (x0, wall, busy)
        return out

    def ratios(tag: str, out: dict, pairs) -> None:
        for scan, gd in pairs:
            print(f"[presets] {tag} {scan} / {gd}: wall "
                  f"{out[scan][1] / out[gd][1]:.2f}x, device busy "
                  f"{out[scan][2] / out[gd][2]:.2f}x")

    # -- cifar10: served in static mode ---------------------------------------
    pre = PRESETS["cifar10"]
    store, build_s = build_store(pre)
    srv = ServeEngine(store, base=pre.base_denoiser, schedule=pre.schedule,
                      num_steps=pre.num_steps, gd_cfg=pre.golddiff,
                      max_batch=B)
    base = srv.denoiser.base
    check(srv.mode == "static", f"[presets] ServeEngine(base='pca') serves "
          f"{srv.mode}")
    check(base.weighting == "ss", "[presets] GoldDiff left the PCA base wss")
    steps, sched = pre.num_steps, srv.schedule
    print(f"[presets] cifar10: {pre.dataset} N={store.n} D={store.dim} "
          f"{store.image_shape}, base {pre.base_denoiser} rank {base.rank}, "
          f"{pre.schedule}, {steps} steps, B={B}; store built in "
          f"{build_s:.1f} s; ServeEngine mode {srv.mode}")
    stats = srv.warmup()
    ts = sampling_timesteps(sched, steps)[:-1]
    patches = sorted({base.patch_size(int(t)) for t in ts}, reverse=True)
    per = store.n * base.h * base.w * base.rank * 4
    check(stats["feature_cache_bytes"] == len(patches) * per,
          f"[presets] warmup holds {stats['feature_cache_bytes']} B of "
          f"feature caches, not {len(patches)} x {per}")
    print(f"[presets] cifar10 warmup: {stats['warmup_s']:.2f} s; feature "
          f"caches for patch sizes {patches} (t = {[int(t) for t in ts]}): "
          f"{stats['feature_cache_bytes'] / 2**20:.1f} MiB = {len(patches)} "
          f"x {per / 2**20:.1f} MiB; one trajectory a batch bucket "
          f"{stats['batch_buckets']}")
    n_feat, builds = len(base._features), srv.engine._builds
    reqs = [Request(i, B, seed=100 + i) for i in range(3)]
    served, total, counts = counted(lambda: srv.serve(reqs))
    for r in served:
        check(r.images.shape == (B,) + store.image_shape
              and bool(np.isfinite(r.images).all()),
              f"[presets] request {r.request_id}: {r.images.shape}, "
              f"finite {bool(np.isfinite(r.images).all())}")
    check(counts == want(patch_route, steps * len(served)),
          f"[presets] serve launches {counts}")
    check(len(base._features) == n_feat and srv.engine._builds == builds,
          "[presets] serving after warmup built a cache or a program")
    lat = sorted(r.latency_s * 1e3 for r in served)
    print(f"[presets] cifar10 serve (static, GoldDiff+PCA): {len(served)} "
          f"waves of {B}: median wave {lat[len(lat) // 2]:.2f} ms (waves "
          f"{[round(v, 2) for v in lat]} ms), {len(served) * B / total:.1f} "
          f"images/s; launches {counts}; nothing built after warmup")
    mark("cifar10 serving")

    # -- cifar10: paired trajectories from one x_T ----------------------------
    x_T = (float(sched.b[int(ts[0])]) * torch.randn(
        B, store.dim, generator=torch.Generator().manual_seed(21))).cuda()
    gd_opt = GoldDiff(make_denoiser("optimal", store, sched), pre.golddiff)
    opt_route = (("fused_candidates", "golden_support_aggregate")
                 if gd_opt.engine.use_fused(int(ts[0])) else
                 ("pdist", "support_sqdist", "golden_support_aggregate"))
    runs = {
        "golddiff+pca": (GoldDiff(make_denoiser("pca", store, sched),
                                  pre.golddiff), patch_route, 5),
        "pca wss (baseline)": (make_denoiser("pca", store, sched), (), 3),
        "pca ss": (make_denoiser("pca", store, sched, weighting="ss"), (), 3),
        "golddiff+kamb": (GoldDiff(make_denoiser("kamb", store, sched),
                                   pre.golddiff), patch_route, 5),
        "kamb": (make_denoiser("kamb", store, sched), (), 3),
        "golddiff+optimal": (gd_opt, opt_route, 10)}
    out = paired("cifar10", runs, sched, x_T, steps)
    ratios("cifar10", out, (("pca wss (baseline)", "golddiff+pca"),
                            ("pca ss", "golddiff+pca"),
                            ("kamb", "golddiff+kamb")))
    d_ws = float((out["pca wss (baseline)"][0] - out["pca ss"][0]).abs().max())
    d_gd = float((out["golddiff+pca"][0] - out["pca ss"][0]).abs().max())
    print(f"[presets] cifar10: |pca wss - pca ss| max {d_ws:.3g} (the patch "
          f"bases' full scan is the exact per-pixel softmax whatever the "
          f"weighting, as in the reference); |golddiff+pca - pca ss| max "
          f"{d_gd:.3g} (not gated)")
    del runs, out, gd_opt
    mark("cifar10 paired trajectories")

    # -- imagenet: GoldDiff+PCA and the PCA baseline ---------------------------
    pre_i = PRESETS["imagenet"]
    store_i, build_i = build_store(pre_i)
    sched_i = make_schedule(pre_i.schedule, 1000)
    gd_i = GoldDiff(make_denoiser(pre_i.base_denoiser, store_i, sched_i),
                    pre_i.golddiff)
    pca_i = make_denoiser(pre_i.base_denoiser, store_i, sched_i)
    caches = []
    for den in (gd_i.base, pca_i):
        caches.append(build_caches(den, sched_i, pre_i.num_steps))
    ts_i = sampling_timesteps(sched_i, pre_i.num_steps)
    print(f"[presets] imagenet: {pre_i.dataset} N={store_i.n} "
          f"D={store_i.dim} {store_i.image_shape}, store built in "
          f"{build_i:.1f} s; feature caches for patch sizes {caches[0][0]}: "
          f"{gd_i.base.feature_cache_bytes() / 2**30:.2f} GiB a denoiser, "
          f"built in {caches[0][1]:.2f} s and {caches[1][1]:.2f} s; sizes "
          f"(m_t, k_t) {[gd_i.engine.sizes(int(t)) for t in ts_i[:-1]]}")
    x_Ti = (float(sched_i.b[int(ts_i[0])]) * torch.randn(
        B, store_i.dim, generator=torch.Generator().manual_seed(22))).cuda()
    out = paired("imagenet", {
        "golddiff+pca": (gd_i, patch_route, 3),
        "pca wss (baseline)": (pca_i, (), 2)}, sched_i, x_Ti,
        pre_i.num_steps)
    ratios("imagenet", out, (("pca wss (baseline)", "golddiff+pca"),))
    del pca_i, out
    mark("imagenet trajectories")

    # kernels 1 and 2 at the imagenet shapes, on the inputs the path gave
    # them: the first step's and the step with the largest m_t
    eng = gd_i.engine
    _, xs = denoise_trajectory(gd_i, sched_i, x_Ti, pre_i.num_steps)
    m_all = [eng.sizes(int(t))[0] for t in ts_i[:-1]]
    for i in sorted({0, m_all.index(max(m_all))}):
        t = int(ts_i[i])
        (m_t, k_t), a = eng.sizes(t), eng.constants(t)[0]
        q = xs[i] / a
        qp = eng._proxy_query(q)
        d2k = ops.pdist(qp, store_i.proxy, x_norms=store_i.proxy_norms)
        d2r = ref.pdist_ref(qp, store_i.proxy, x_norms=store_i.proxy_norms)
        rel1 = rel_err(d2k, d2r)
        check(rel1 <= DIST_RTOL, f"[presets] imagenet t={t} pdist: relative "
              f"error {rel1:.3g} > {DIST_RTOL}")
        cand = ref.materialized_topm(d2k, m_t)[0]
        eq1, diff1 = cut_sets(cand, ref.materialized_topm(d2r, m_t)[0], d2r)
        del d2k
        sk = ops.support_distances(q, store_i.X, cand, store_i.x_norms)
        sr = ref.support_sqdist_ref(q, store_i.X, store_i.x_norms, cand)
        rel2 = rel_err(sk, sr)
        check(rel2 <= DIST_RTOL, f"[presets] imagenet t={t} support_sqdist: "
              f"relative error {rel2:.3g} > {DIST_RTOL}")
        gold_k = ops.golden_rerank(q, store_i.X, cand, k_t,
                                   x_norms=store_i.x_norms)[0]
        gold_r = cand.gather(1, torch.sort(sr, dim=-1, stable=True)[1][:, :k_t])
        d2r.fill_(float("inf")).scatter_(1, cand, sr)     # plain d2 by row id
        eq2, diff2 = cut_sets(gold_k, gold_r, d2r)
        print(f"[presets] imagenet t={t} (step {i}, m_t={m_t}, k_t={k_t}, "
              f"B={q.shape[0]}): pdist q [{q.shape[0]}, {qp.shape[1]}] x "
              f"proxy [{store_i.n}, {qp.shape[1]}] vs plain max rel "
              f"{rel1:.3g}, top-{m_t} sets equal in {eq1} of {q.shape[0]} "
              f"rows ({diff1} slots differ, each a near tie at the cut); "
              f"support_sqdist q [{q.shape[0]}, {store_i.dim}] on {m_t} "
              f"candidates vs plain max rel {rel2:.3g} (tolerance "
              f"{DIST_RTOL}), golden top-{k_t} sets equal in {eq2} of "
              f"{q.shape[0]} rows ({diff2} slots differ)")
        del sk, sr, d2r, cand
    del gd_i, store_i, xs
    torch.cuda.empty_cache()
    mark("imagenet kernel checks")

    # -- correctness: the card against the CPU's plain versions ---------------
    cpu_store = store.to("cpu")
    for label, make, nb in (
            ("golddiff+pca", lambda st: GoldDiff(make_denoiser(
                "pca", st, sched, device=st.device), pre.golddiff), B),
            ("pca wss", lambda st: make_denoiser("pca", st, sched,
                                                 device=st.device),
             PRESET_CHECK_B)):
        t0 = time.perf_counter()
        got = denoise_trajectory(make(store), sched, x_T[:nb], steps)[0].cpu()
        want_x = denoise_trajectory(make(cpu_store), sched, x_T[:nb].cpu(),
                                    steps)[0]
        err = float((got - want_x).abs().max())
        check(err <= TRAJ_TOL, f"[presets] {label} card vs CPU {err:.3g}")
        print(f"[presets] reference {label}: cifar10 preset, B={nb}, "
              f"{steps} steps, card vs CPU plain versions max abs {err:.3g} "
              f"(tolerance {TRAJ_TOL}; {time.perf_counter() - t0:.1f} s)")
    # the first step's golden supports at the served B, card against CPU:
    # equal as sets
    t1 = int(ts[0])
    gds = {dev: GoldDiff(make_denoiser("pca", st, sched, device=dev),
                         pre.golddiff)
           for dev, st in (("cuda", store), ("cpu", cpu_store))}
    sel = {dev: g.select(x_T.to(dev), t1).cpu() for dev, g in gds.items()}
    rows_eq = sum(set(a.tolist()) == set(b.tolist())
                  for a, b in zip(sel["cuda"], sel["cpu"]))
    check(rows_eq == B, f"[presets] first-step supports: {rows_eq} of {B} "
          f"rows equal as sets")
    print(f"[presets] golddiff+pca first step t={t1} (m_t, k_t = "
          f"{gds['cpu'].engine.sizes(t1)}): card vs CPU golden supports "
          f"equal as sets in {rows_eq} of {B} rows")
    mark("cifar10 card vs CPU")
    # the "ss" full scan against the same denoiser on support = every row
    t_ss = 300
    rows = torch.arange(PRESET_CHECK_B, device="cuda") * 97
    x_ss = (float(sched.a[t_ss]) * store.X[rows] + float(sched.b[t_ss])
            * torch.randn(PRESET_CHECK_B, store.dim,
                          generator=torch.Generator().manual_seed(23)).cuda())
    pca_ss = make_denoiser("pca", store, sched, weighting="ss")
    every = torch.arange(store.n, device="cuda").expand(PRESET_CHECK_B, -1)
    err = float((pca_ss(x_ss, t_ss) - pca_ss(x_ss, t_ss, support=every)
                 ).abs().max())
    check(err <= PCA_SS_TOL, f"[presets] pca ss full vs support {err:.3g}")
    print(f"[presets] pca ss full scan vs support = all {store.n} rows, t="
          f"{t_ss}, B={PRESET_CHECK_B}: max abs {err:.3g} (tolerance "
          f"{PCA_SS_TOL})")
    # features and box sums in fp32 with cuDNN's TF32 on around them
    imgs = store.X[:64].reshape((64,) + store.image_shape)
    p = patches[0]
    w64 = pca_ss._basis(p).double().cpu().permute(3, 2, 0, 1)
    feat64 = F.conv2d(imgs.double().cpu().permute(0, 3, 1, 2), w64,
                      padding=p // 2).permute(0, 2, 3, 1)
    d64 = ((imgs[:8, None] - imgs[None, 8:16]) ** 2).sum(-1).double().cpu()
    box64 = F.conv2d(F.pad(d64.reshape(-1, 1, *d64.shape[-2:]),
                           (p // 2,) * 4),
                     torch.ones(1, 1, p, p, dtype=torch.float64))
    torch.backends.cudnn.allow_tf32 = True
    try:
        feat = pca_ss.features(imgs, p).double().cpu()
        box = den_mod._box_patch_dist(imgs[:8], imgs[8:16], p
                                      ).double().cpu().reshape(box64.shape)
        tf32 = F.conv2d(imgs.permute(0, 3, 1, 2), pca_ss._basis(p).permute(
            3, 2, 0, 1), padding=p // 2).permute(0, 2, 3, 1).double().cpu()
        check(torch.backends.cudnn.allow_tf32,
              "[presets] the fp32 pin did not restore cuDNN's TF32 flag")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    rel = {name: float((v - w).abs().max() / w.abs().max())
           for name, v, w in (("features", feat, feat64),
                              ("box sums", box, box64),
                              ("unpinned conv", tf32, feat64))}
    check(rel["features"] <= FEAT_RTOL and rel["box sums"] <= FEAT_RTOL,
          f"[presets] card features / box sums vs float64: {rel}")
    print(f"[presets] with cuDNN TF32 on: PCA features (patch {p}, 64 "
          f"images) vs a float64 CPU conv rel {rel['features']:.3g}, Kamb "
          f"box sums rel {rel['box sums']:.3g} (tolerance {FEAT_RTOL}); the "
          f"same conv without the pin rel {rel['unpinned conv']:.3g}")
    print(f"[presets] phase {time.perf_counter() - t_phase:.1f} s")


BF16 = torch.bfloat16
# the bf16-row instances each route launches once a step
BF16_ROUTES = {
    "fused": ("fused_candidates", "golden_support_aggregate"),
    "staged": ("pdist", "support_sqdist", "golden_support_aggregate"),
    "streamed": ("screen_topm", "support_sqdist", "golden_support_aggregate"),
    "indexed": ("centroid_scan", "support_sqdist",
                "golden_support_aggregate"),
    "full_scan": ("golden_aggregate",),
    "plan": ("fused_candidates", "golden_support_aggregate")}
# each instance's launches in the kernels line: its first route above
BF16_PATH = {n: r for r, names in reversed(BF16_ROUTES.items())
             for n in names}


def bf16_phase(ctx: dict) -> tuple[dict, dict]:
    """[bf16]: the engine with bf16 store rows (``storage_dtype``).

    Each kernel's bf16-row instance against its plain version on the same
    bf16 rows at the main path's shapes (B=16, N=50000, D=3072, dp=192,
    m=12500, k=5000; integer data bit-equal, floats within DIST_RTOL /
    MEAN_ATOL), timed (CUDA events, L2 flushed) against its bf16 bound
    and beside the fp32 instance's time; then the fp32 and bf16
    trajectories of every route from one x_T (full scan, fused static,
    staged, streamed, indexed at INDEXED_CFG, the fused plan on CUDA
    graphs), each counted alone (a bf16 route launches its routes' bf16
    instances once a step and no fp32 instance), timed in turns and
    profiled; the bf16-vs-fp32 error of the static step at t in {800,
    400, 100} and over the trajectory; the operands' bytes and the peak
    over what is held; and ``strategy="measure"`` on the card.  Returns
    the bf16 instances' numbers and the bf16 routes' counts."""
    from repro_torch.core import (FullScan, GoldDiff, OptimalDenoiser,
                                  build_plan, sample, sample_plan)
    from repro_torch.core.engine import measure_crossover
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_step import (
        fused_candidates, fused_candidates_scan, fused_posterior)
    from repro_torch.kernels.golden_aggregate import golden_aggregate
    from repro_torch.kernels.golden_rerank import support_sqdist
    from repro_torch.kernels.golden_support_aggregate import (
        golden_support_aggregate)
    from repro_torch.kernels.pdist import pdist
    from repro_torch.kernels.screen import screen_topm, screen_topm_scan

    t_phase = time.perf_counter()
    st, sched, x_T = ctx["store"], ctx["sched"], ctx["x_T"]
    fp32 = ctx["results"]
    kern = {k.__name__: k for k in ops.COUNTED_BF16
            if k not in ops.STATE_ENTRIES}
    check(set(kern) == set(BF16_PATH),
          f"[bf16] the bf16 instances' wrappers {sorted(kern)}")

    # the operands: bf16 rows beside the fp32 master, fp32 norms
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    full = OptimalDenoiser(st, sched)
    gd = GoldDiff(full, storage_dtype=BF16)
    eng = gd.engine
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    op_bytes = {"X": eng.X.numel() * 2, "proxy": eng.proxy.numel() * 2}
    check(eng.X.dtype == eng.proxy.dtype == BF16
          and eng.x_norms.dtype == torch.float32
          and st.X.dtype == torch.float32, "[bf16] engine operand dtypes")
    check(eng.strategy == "dense" and eng.use_fused(500),
          f"[bf16] fused='auto' at m_max/N 0.25: strategy {eng.strategy}")

    a, sig2 = eng.constants(500)
    q = ctx["q"]                                  # the rescaled query
    qp = eng._proxy_query(q)                      # rounded to bf16, fp32
    check(torch.equal(qp, qp.to(BF16).float()), "[bf16] qp not rounded")
    qpn = (qp * qp).sum(-1)
    xb, pb, xn, pn = eng.X, eng.proxy, eng.x_norms, eng.proxy_norms
    res = {}

    def ints_bf16(shape, seed):
        return ints(shape, seed).to(BF16)

    def row(name, err, ms, plain_ms, nbytes, flops, rate=FP32_FLOPS_PER_S):
        b_ms, b_by = bound(nbytes, flops, rate)
        res[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
        print(f"[bf16] {name} bf16 rows: max abs {err:.3g}; kernel "
              f"{ms:.4f} ms (fp32 instance {fp32[name]['ms']:.4f} ms, "
              f"bf16/fp32 {ms / fp32[name]['ms']:.3f}), bound {b_ms:.4f} ms "
              f"({b_by}: {nbytes / 1e6:.1f} MB; fp32 bound "
              f"{fp32[name]['bound_ms']:.4f} ms), {b_ms / ms:.3f} of the "
              f"bound; plain {plain_ms:.4f} ms")

    # kernel 1
    qi, xi = ints((B, DP), 60), ints_bf16((N, DP), 61)
    qin, xin = (qi * qi).sum(-1), (xi.float() ** 2).sum(-1)
    check(torch.equal(pdist(qi, xi, qin, xin),
                      ref.pdist_ref(qi, xi, qin, xin)),
          "[bf16] pdist: not bit-equal on integer data")
    d2k = pdist(qp, pb, qpn, pn)
    d2r = ref.pdist_ref(qp, pb, qpn, pn)
    rel = rel_err(d2k, d2r)
    check(rel <= DIST_RTOL, f"[bf16] pdist: relative error {rel:.3g}")
    cand = ref.materialized_topm(d2k, M)[0]
    row("pdist", float((d2k - d2r).abs().max()),
        time_ms(lambda: pdist(qp, pb, qpn, pn)),
        time_ms(lambda: ref.pdist_ref(qp, pb, qpn, pn)),
        4 * (B * DP + B + N + B * N) + 2 * N * DP, 4 * B * N * DP,
        TF32_FLOPS_PER_S)
    del d2k, d2r

    # kernel 2
    qfi, xfi = ints((B, D), 62), ints_bf16((N, D), 63)
    xfin = (xfi.float() ** 2).sum(-1)
    ci = ref.materialized_topm(ref.pdist_ref(qi, xi, qin, xin), M)[0]
    check(torch.equal(support_sqdist(qfi, xfi, xfin, ci),
                      ref.support_sqdist_ref(qfi, xfi, xfin, ci)),
          "[bf16] support_sqdist: not bit-equal on integer data")
    sk = support_sqdist(q, xb, xn, cand)
    sr = ref.support_sqdist_ref(q, xb, xn, cand)
    rel = rel_err(sk, sr)
    check(rel <= DIST_RTOL, f"[bf16] support_sqdist: relative error "
          f"{rel:.3g}")
    gold, gd2 = ops.golden_rerank(q, xb, cand, K, xn)
    u = int(torch.unique(cand).numel())
    row("support_sqdist", float((sk - sr).abs().max()),
        time_ms(lambda: support_sqdist(q, xb, xn, cand)),
        time_ms(lambda: ref.support_sqdist_ref(q, xb, xn, cand), iters=3),
        2 * u * D + 4 * u + 4 * B * D + 12 * B * M, 2 * B * M * D)
    del sr

    # kernel 3: integer rows and the path's rows against the plain
    # aggregate within MEAN_ATOL (the softmax's exponentials are not
    # exact, so no bit-equality), each with [check]'s all-NEG_INF row
    # (the mean of its rows) and the plan's k_t mask (slots >= K/2 at
    # NEG_INF)
    gold_i, gd2_i = ops.golden_rerank(qfi, xfi, ci, K, xfin)
    lg = torch.clamp_min(-gd2 / (2.0 * sig2), ref.NEG_INF)
    kept = torch.arange(K, device=lg.device) < K // 2
    err = 0.0
    for label, rows, ids, lgs in (
            ("integer rows", xfi, gold_i,
             torch.clamp_min(-gd2_i / 40.0, ref.NEG_INF)),
            ("path rows", xb, gold, lg)):
        lg_none = lgs.clone()
        lg_none[0] = ref.NEG_INF
        for case, lgc in (("", lgs), (" k_t mask", torch.where(
                kept, lgs, ref.NEG_INF)), (" all-NEG_INF row", lg_none)):
            got = golden_support_aggregate(rows, ids, lgc)
            e = float((got - ref.golden_support_aggregate_ref(rows, ids, lgc))
                      .abs().max())
            check(e <= MEAN_ATOL, f"[bf16] golden_support_aggregate "
                  f"{label}{case}: max abs {e:.3g}")
            err = max(err, e)
        e = float((got[0] - rows[ids[0]].float().mean(0)).abs().max())
        check(e <= MEAN_ATOL, f"[bf16] golden_support_aggregate {label}: "
              f"the all-NEG_INF row is not the mean of its rows ({e:.3g})")
    del gold_i, gd2_i, lg_none, got
    ak = golden_support_aggregate(xb, gold, lg)
    check(torch.equal(ak, golden_support_aggregate(xb, gold, lg)),
          "[bf16] golden_support_aggregate: two calls differ")
    print(f"[bf16] golden_support_aggregate: integer and path rows, k_t "
          f"mask and all-NEG_INF row within {MEAN_ATOL}: max abs {err:.3g}")
    u3 = int(torch.unique(gold).numel())
    row("golden_support_aggregate", err,
        time_ms(lambda: golden_support_aggregate(xb, gold, lg)),
        time_ms(lambda: ref.golden_support_aggregate_ref(xb, gold, lg),
                iters=3),
        2 * u3 * D + 4 * B * D + 12 * B * K, 2 * B * K * D)

    # kernel 4: integer rows and the path's rows against the plain full
    # scan within MEAN_ATOL; the integer rows also bit-equal to the fp32
    # instance on the widened rows; sigma2=0 on the path's rows is their
    # mean, as in [check]
    fk = golden_aggregate(q, xb, sig2, xn)
    err = float((fk - ref.golden_aggregate_ref(q, xb, sig2, xn)).abs().max())
    check(err <= MEAN_ATOL, f"[bf16] golden_aggregate: {err:.3g}")
    fi = golden_aggregate(qfi, xfi, 20.0, xfin)
    err_i = float((fi - ref.golden_aggregate_ref(qfi, xfi, 20.0, xfin))
                  .abs().max())
    check(err_i <= MEAN_ATOL, f"[bf16] golden_aggregate: integer rows, max "
          f"abs {err_i:.3g}")
    check(torch.equal(fi, golden_aggregate(qfi, xfi.float(), 20.0, xfin)),
          "[bf16] golden_aggregate: integer rows differ from the fp32 "
          "instance on the widened rows")
    fd = golden_aggregate(q, xb, 0.0, xn)
    err_d = float((fd - xb.float().mean(0)).abs().max())
    check(bool(torch.isfinite(fd).all()) and err_d <= MEAN_ATOL,
          f"[bf16] golden_aggregate: sigma2=0 is not the rows' mean "
          f"({err_d:.3g})")
    print(f"[bf16] golden_aggregate: path rows max abs {err:.3g}, integer "
          f"rows {err_i:.3g} (bit-equal to the fp32 instance on the widened "
          f"rows), sigma2=0 -> the rows' mean to {err_d:.3g}")
    del fi, fd
    # two products of two TF32 MMAs each (hi and lo query terms; a bf16
    # row is exact in TF32)
    row("golden_aggregate", max(err, err_i),
        time_ms(lambda: golden_aggregate(q, xb, sig2, xn)),
        time_ms(lambda: ref.golden_aggregate_ref(q, xb, sig2, xn)),
        2 * N * D + 4 * (N + 2 * B * D + B), 8 * B * N * D, TF32_FLOPS_PER_S)

    # kernel 5
    xin_inf = xin.clone()
    xin_inf[7] = float("inf")
    for m in (M, 2049):
        gk = screen_topm(qi, xi, m, qin, xin_inf)
        gr = screen_topm_scan(qi, xi, m, qin, xin_inf)
        check(torch.equal(gk[0], gr[0]) and torch.equal(gk[1], gr[1]),
              f"[bf16] screen_topm: not bit-equal on integer data at m={m}")
    gi, gv = screen_topm(qp, pb, M, qpn, pn)
    wi, wv = screen_topm_scan(qp, pb, M, qpn, pn)
    rel = rel_err(gv, wv)
    check(rel <= DIST_RTOL, f"[bf16] screen_topm: relative error {rel:.3g}")
    print(f"[bf16] screen_topm m={M}: overlap {overlap(gi, wi):.6f} (exact "
          f"order {torch.equal(gi, wi)})")
    row("screen_topm", float((gv - wv).abs().max()),
        time_ms(lambda: screen_topm(qp, pb, M, qpn, pn)),
        time_ms(lambda: screen_topm_scan(qp, pb, M, qpn, pn), iters=3),
        4 * (B * DP + B + N) + 2 * N * DP + 12 * B * M, 2 * B * N * DP)

    # kernel 6
    xfin_inf = xfin.clone()
    xfin_inf[11] = float("inf")
    for m in (M, 2049):
        gk = fused_candidates(qi, qfi, xi, xfi, m, xin_inf, xfin_inf)
        gr = fused_candidates_scan(qi, qfi, xi, xfi, m, xin_inf, xfin_inf)
        check(torch.equal(gk[0], gr[0]) and torch.equal(gk[1], gr[1]),
              f"[bf16] fused_candidates: not bit-equal on integer data at "
              f"m={m}")
    del qfi, xfi, xfin, xfin_inf, gk, gr
    gi, gv = fused_candidates(qp, q, pb, xb, M, pn, xn)
    wi, wv = fused_candidates_scan(qp, q, pb, xb, M, pn, xn)
    own = rel_err(ref.support_sqdist_ref(q, xb, xn, gi), gv)
    mean_err = float((fused_posterior(xb, gi, gv, K, sig2)
                      - fused_posterior(xb, wi, wv, K, sig2)).abs().max())
    check(own <= DIST_RTOL and mean_err <= MEAN_ATOL,
          f"[bf16] fused_candidates: own-row rel {own:.3g}, mean "
          f"{mean_err:.3g}")
    same = gi == wi
    row("fused_candidates", max(float((gv - wv)[same].abs().max()),
                                mean_err),
        time_ms(lambda: fused_candidates(qp, q, pb, xb, M, pn, xn)),
        time_ms(lambda: fused_candidates_scan(qp, q, pb, xb, M, pn, xn),
                iters=3),
        2 * (N * D + N * DP) + 4 * (2 * N + B * D + B * DP + 2 * B)
        + 12 * B * M, 2 * B * N * (D + DP))
    del gi, gv, wi, wv

    # kernel 7: the probe launch with the pooled query rounded to bf16
    ixe = GoldDiff(full, ctx["indexed_cfg"], index=ctx["cix"],
                   probe_schedule=ctx["probes"], storage_dtype=BF16).engine
    cix = ixe.index
    p_step = max(ixe.nprobe(t) for t in ctx["steps"])

    def probe(qq, cents, cn, fields=ref.PROBE_FIELDS):
        return ops.ivf_probe(qq, st.image_shape, 4, cents, cn, cix.offsets,
                             cix.perm, cix.n, p_step, cix.max_cluster,
                             fields=fields, round_bf16=True)

    def probe_plain(qq, cents, cn):
        qpp = ref.downsample_proxy(qq.reshape((B,) + tuple(st.image_shape)),
                                   4).to(BF16).float()
        return ref.ivf_probe_ref(qpp, cents, cn, cix.offsets, cix.perm,
                                 cix.n, p_step, cix.max_cluster)

    w, dpc = cix.centroids.shape
    qi7 = ints((B, D), 64)
    ci7 = ints((w, dpc), 65)
    cn7 = (ci7 * ci7).sum(-1)
    for field, g, r in zip(ref.PROBE_FIELDS, probe(qi7, ci7, cn7),
                           probe_plain(qi7, ci7, cn7)):
        check(torch.equal(g, r), f"[bf16] ivf_probe: {field} not bit-equal "
              f"on integer data")
    got = probe(q, cix.centroids, cix.centroid_norms)
    want = probe_plain(q, cix.centroids, cix.centroid_norms)
    qpp = ref.downsample_proxy(q.reshape((B,) + tuple(st.image_shape)),
                               4).to(BF16).float()
    d2c = ref.centroid_scan_ref(qpp, cix.centroids, cix.centroid_norms)
    chosen = torch.gather(d2c, 1, got.probe)
    wanted = torch.gather(d2c, 1, want.probe)
    p_err = float((chosen - wanted).abs().max())
    check(bool(((chosen - wanted).abs()
                <= DIST_RTOL * wanted.abs().clamp_min(1.0)).all()),
          f"[bf16] ivf_probe: probe lists differ beyond near-ties {p_err}")
    print(f"[bf16] ivf_probe cifar_like P={p_step}: integer bit-equal in "
          f"every field; float probe lists equal "
          f"{torch.equal(got.probe, want.probe)}")
    slots = B * p_step * cix.max_cluster
    touched = int(torch.unique(got.pos[got.valid]).numel())
    row("centroid_scan", p_err,
        time_ms(lambda: probe(q, cix.centroids, cix.centroid_norms,
                              ("ids", "valid"))),
        time_ms(lambda: probe_plain(q, cix.centroids, cix.centroid_norms)),
        4 * (B * D + w * dpc + w) + 8 * (w + 1) + 8 * touched + 9 * slots,
        2 * B * w * dpc + B * D)
    del cand, gold, gd2, lg, ak, fk, sk
    print(f"[bf16] kernel checks done at {time.perf_counter() - t_phase:.1f}"
          f" s into the phase")

    # the routes: fp32 and bf16 from one x_T, each counted alone
    def counted(fn):
        for k in ops.COUNTED:
            k.launches = 0
        for k in ops.COUNTED_BF16:
            k.launches_bf16 = 0
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        return out, ({n: k.launches for n, k in kern.items()},
                     {n: k.launches_bf16 for n, k in kern.items()})

    cfgs = {"full_scan": None, "fused": {}, "plan": {},
            "staged": dict(screen="materialized", fused=False),
            "streamed": dict(screen="streamed", fused=False),
            "indexed": dict(cfg=ctx["indexed_cfg"], index=ctx["cix"],
                            probe_schedule=ctx["probes"])}
    trajs, outs, walls, route_counts = {}, {}, {}, {}
    for route, kw in cfgs.items():
        for sd in (None, BF16):
            tag = f"{route} {'bf16' if sd else 'fp32'}"
            if kw is None:
                den = FullScan(GoldDiff(full, storage_dtype=sd).engine)
            else:
                den = GoldDiff(full, storage_dtype=sd, **kw)
            if route == "plan":
                e = den.engine
                plan = build_plan(e, STEPS)
                trajs[tag] = (lambda den=den, plan=plan, e=e: sample_plan(
                    den.call_masked, sched, (B, D), plan, x_init=x_T,
                    program_cache=e.program, jitter=e.jitter))
            else:
                trajs[tag] = (lambda den=den: sample(
                    den, sched, (B, D), num_steps=STEPS, x_init=x_T))
            trajs[tag]()                      # warm-up (and the capture)
            outs[tag], (c32, c16) = counted(trajs[tag])
            want = {n: STEPS if n in BF16_ROUTES[route] else 0 for n in kern}
            if sd is None:
                check(c32 == want and not any(c16.values()),
                      f"[bf16] {tag} launches {c32} {c16}")
            else:
                check(c16 == want and not any(c32.values()),
                      f"[bf16] {tag} launches fp32 {c32}, bf16 {c16}")
                route_counts[route] = c16
            check(bool(torch.isfinite(outs[tag]).all()),
                  f"[bf16] {tag} trajectory not finite")
    for route in cfgs:
        pair = (f"{route} fp32", f"{route} bf16")
        for tag in pair + pair[::-1]:
            walls.setdefault(tag, []).append(wall_ms(trajs[tag], iters=5))
    busy = {}
    for tag, fn in trajs.items():
        idle, busy[tag] = profile_line(f"[bf16] {tag} trajectory B={B}",
                                       min(walls[tag]), fn)
        walls[tag] = (walls[tag], idle)
    for route in cfgs:
        f32, b16 = f"{route} fp32", f"{route} bf16"
        err = float((outs[b16] - outs[f32]).abs().max())
        rel = err / float(outs[f32].abs().max())
        print(f"[bf16] {route} trajectory (B={B}, {STEPS} steps, one x_T): "
              f"fp32 walls {[round(v, 3) for v in walls[f32][0]]} ms, busy "
              f"{busy[f32]:.3f} ms, idle {walls[f32][1]:.3f}; bf16 walls "
              f"{[round(v, 3) for v in walls[b16][0]]} ms, busy "
              f"{busy[b16]:.3f} ms, idle {walls[b16][1]:.3f}; bf16/fp32 "
              f"wall {min(walls[b16][0]) / min(walls[f32][0]):.3f}, busy "
              f"{busy[b16] / busy[f32]:.3f}; bf16 vs fp32 max abs "
              f"{err:.3g} (relative to max |x0| {rel:.3g}); bf16 launches "
              f"{route_counts[route]}")
    pw = min(walls["plan bf16"][0])
    print(f"[bf16] the open question at bf16 (B={B}): the bf16 plan takes "
          f"{pw / min(walls['plan fp32'][0]):.3f}x the fp32 plan's wall and "
          f"{pw / min(walls['full_scan bf16'][0]):.3f}x the bf16 full "
          f"scan's ({pw:.3f} ms against "
          f"{min(walls['full_scan bf16'][0]):.3f} ms); busy "
          f"{busy['plan bf16'] / busy['full_scan bf16']:.3f}x")
    ref_err = float((outs["fused bf16"] - outs["full_scan bf16"]).abs().max())
    print(f"[bf16] |fused bf16 - full scan bf16| max {ref_err:.3g}")

    # quality: the static step, bf16 against fp32, as the reference reports
    g32 = GoldDiff(full)
    for t in (800, 400, 100):
        xt = (float(sched.a[t]) * st.X[:B]
              + float(sched.b[t]) * torch.randn(
                  B, D, generator=torch.Generator().manual_seed(t)).cuda())
        o32, o16 = g32(xt, t), gd(xt, t)
        rel = float((o16 - o32).abs().max() / (o32.abs().max() + 1e-9))
        print(f"[bf16] static step t={t} (fused): bf16 vs fp32 relative "
              f"error {rel:.3g} (max |diff| / max |fp32|)")
        check(rel <= 5e-2, f"[bf16] static step t={t}: {rel:.3g} > 5e-2")

    # memory: the operands and the peak over what is held during a step
    xs = x_T.clone()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gd(xs, 500)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[bf16] operands: X {op_bytes['X'] / 1e6:.1f} MB, proxy "
          f"{op_bytes['proxy'] / 1e6:.1f} MB in bf16 (norms fp32 "
          f"{8 * st.n / 1e6:.1f} MB shared with the store); the engine "
          f"allocated {held / 1e6:.1f} MB beside the fp32 master; a fused "
          f"bf16 step's peak over what is held {peak / 1e6:.1f} MB")

    # strategy="measure" on the card
    for label, x, xnorm in (("fp32", st.X, st.x_norms), ("bf16", xb, xn)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frac = measure_crossover(x, xnorm)
        secs = time.perf_counter() - t0
        m_frac = ctx["m_max_frac"]
        pick = "gather" if m_frac <= frac else "dense"
        print(f"[bf16] strategy='measure' on {label} rows: crossover "
              f"fraction {frac:.4f}, picks {pick!r} at m_max/N {m_frac}, "
              f"{secs:.3f} s (the constant's 'cuda' entry "
              f"{ctx['crossover_frac']})")
        check(0.0 < frac <= 1.0, f"[bf16] measured fraction {frac}")
    m = GoldDiff(full, storage_dtype=BF16, strategy="measure").engine
    check(m.strategy in ("gather", "dense"), f"[bf16] {m.strategy}")
    print(f"[bf16] phase {time.perf_counter() - t_phase:.1f} s")
    return res, route_counts


LIVE_APPEND = 1024      # rows an append of the live-store phase (~2% of N)
LIVE_REQS = 32          # requests the runtime serves (1-4 images each)


def live_store_phase(ctx: dict) -> dict:
    """[lifecycle] and [runtime] on the cifar_like cell (N=50000, the
    index at C=224, INDEXED_FRACS): the capacity-padded store's create,
    append, commit and open (replay) seconds and bytes; kernels 1-7
    against their plain versions on the padded operands at the path's
    shapes (no +inf-norm slot or spare window ranks before a real one,
    none weighs); the padded indexed plan against the unpadded one from
    one x_T; then ``ServeRuntime`` over a plan-mode ServeEngine on the
    padded view (max_batch 16, 10 steps): warmup's graphs for two slots,
    32 requests served continuously, two hot swaps (one with a wave in
    flight) that capture and build nothing, the fault ladder, NaN and
    evict storms, a fused engine's exact rung and the tracer's cost.
    Returns the launch counts of the runtime path; the directory of the
    last committed epoch stays, as ``ctx["lifecycle"]``, for [pmesh]."""
    from repro_torch.index import IngestConfig, StoreLifecycle
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_step import (fused_candidates,
                                                fused_candidates_scan)
    from repro_torch.kernels.screen import screen_topm, screen_topm_scan
    from repro_torch.launch.faults import FaultConfig, injected
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.obs.quality import QualityMonitor
    from repro_torch.core import sample_plan, sampling_timesteps
    st, cix, sched = ctx["store"], ctx["cix"], ctx["sched"]
    cfg, probes, x_T, kernels = (ctx["indexed_cfg"], ctx["probes"],
                                 ctx["x_T"], ctx["kernels"])
    dev = st.device          # the card (a CPU store rehearses the phase)
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="live_store_")
    root = tmp.name

    def on_disk() -> int:
        return sum(f.stat().st_size for f in Path(root).rglob("*")
                   if f.is_file())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def dints(shape, seed: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(-3, 4, shape, generator=g, device=dev).float()

    def memory() -> tuple[int, int]:
        if dev.type != "cuda":
            return 0, 0
        sync()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()

    # -- [lifecycle] the capacity-padded layout -------------------------------
    lc, create_s = timed(lambda: StoreLifecycle.create(
        root, dataclasses.replace(st, labels=None), cix, IngestConfig()))
    n_rows, n_cap, w = lc.n_rows, lc.n_capacity, lc.num_windows
    spares = int(np.isinf(lc._cnorm).sum())
    w_real = w - spares
    print(f"[lifecycle] create: cifar_like N={n_rows}, {cix.num_clusters} "
          f"windows of at most L={cix.max_cluster} -> {w} windows ({w_real} + "
          f"{spares} spare) of L_cap={lc.capacity} slots, n_cap={n_cap} "
          f"({n_cap / n_rows:.3f}x the rows; X {lc._X.nbytes / 1e9:.3f} GB "
          f"for {n_rows * D * 4 / 1e9:.3f} GB of rows); epoch 0 in "
          f"{create_s:.2f} s, {on_disk()} bytes on disk")
    rng = np.random.default_rng(0)

    def new_rows(b: int) -> np.ndarray:
        """Rows near the store's: a real row plus N(0, 0.1^2) noise."""
        src = lc._X[rng.integers(0, st.n, b)]
        return (src + 0.1 * rng.standard_normal(src.shape, np.float32)
                ).astype(np.float32)

    (ds0, ix0), view_s = timed(lambda: lc.view(device=dev))
    print(f"[lifecycle] view: the padded store and index copied to the card "
          f"in {view_s:.2f} s")
    srv = ServeEngine(ds0, num_steps=STEPS, max_batch=B, gd_cfg=cfg,
                      index=ix0, probe_schedule=probes, device=dev)
    pe, plan = srv.engine, srv.plan
    check(srv.mode == "plan" and plan.num_buckets >= 2,
          f"[runtime] ServeEngine serves {srv.mode} with "
          f"{plan.num_buckets} plan buckets (a wave in flight needs two)")
    o = pe.current_operands()
    moved = o.perm != ix0.perm
    remapped = int(moved.sum())
    check(bool(torch.isinf(o.x_norms[o.perm[moved]]).all()),
          "[lifecycle] empty slots not pointed at +inf-norm rows")
    print(f"[lifecycle] engine operands: {remapped} empty slots of the "
          f"windows point at a +inf-norm padding row (the reference's "
          f"capacity-mode screen reads dataset row 0 there)")

    # kernels 1-7 on the padded operands, at the path's shapes
    t = 500
    a, sig2 = pe.constants(t)
    g = torch.Generator().manual_seed(7)
    rows = torch.randint(0, st.n, (B,), generator=g).to(dev)
    q = (a * st.X[rows] + float(sched.b[t]) * torch.randn(
        B, D, generator=g).to(dev)) / a
    qp = pe._proxy_query(q)
    qpn = (qp * qp).sum(-1)
    m_pad, _, _, k_pad = cfg.sizes(n_cap)
    errs = {}
    # kernel 1 (pdist) and kernel 5 (screen_topm): integer data bit-equal,
    # padding rows (+inf norms) always after every real row
    qi, xi = dints((B, DP), 71), dints((n_cap, DP), 72)
    xi[n_rows:] = 0.0
    qin, xin = (qi * qi).sum(-1), (xi * xi).sum(-1)
    xin[n_rows:] = float("inf")
    d2k = ops.pdist(qi, xi, qin, xin)
    check(torch.equal(d2k, ref.pdist_ref(qi, xi, qin, xin)),
          "[lifecycle] pdist: not bit-equal on integer padded data")
    idx_k, d2_k = ref.materialized_topm(d2k, n_rows + 64)
    check(bool(torch.isfinite(d2_k[:, :n_rows]).all()
               and torch.isinf(d2_k[:, n_rows:]).all()
               and (idx_k[:, n_rows:] >= n_rows).all()),
          "[lifecycle] pdist: a padding row ranks before a real one")
    for m in (m_pad, n_rows + 64):
        gk = screen_topm(qi, xi, m, qin, xin)
        gr = screen_topm_scan(qi, xi, m, qin, xin)
        check(torch.equal(gk[0], gr[0]) and torch.equal(gk[1], gr[1]),
              f"[lifecycle] screen_topm: not bit-equal on integer padded "
              f"data at m={m}")
        fin = torch.isfinite(gk[1])
        check(bool((gk[0][fin] < n_rows).all())
              and int(fin.sum(1).min()) == min(m, n_rows),
              f"[lifecycle] screen_topm: padding ranks before a real row "
              f"at m={m}")
    d2f = ops.pdist(qp, o.proxy, qpn, o.proxy_norms)
    d2r = ref.pdist_ref(qp, o.proxy, qpn, o.proxy_norms)
    fin = torch.isfinite(d2r)
    check(torch.equal(torch.isfinite(d2f), fin)
          and bool(fin[:, :n_rows].all()) and not bool(fin[:, n_rows:].any()),
          "[lifecycle] pdist: +inf pattern of the padded store")
    errs["pdist"] = rel_err(d2f[fin], d2r[fin])
    gk = screen_topm(qp, o.proxy, m_pad, qpn, o.proxy_norms)
    gr = screen_topm_scan(qp, o.proxy, m_pad, qpn, o.proxy_norms)
    errs["screen_topm"] = rel_err(gk[1], gr[1])
    check(errs["pdist"] <= DIST_RTOL and errs["screen_topm"] <= DIST_RTOL,
          f"[lifecycle] pdist / screen_topm float errors {errs}")
    del d2k, d2f, d2r, idx_k, d2_k
    # kernel 6 (fused_candidates): integer data bit-equal
    qfi, xfi = dints((B, D), 73), dints((n_cap, D), 74)
    xfi[n_rows:] = 0.0
    xfin = (xfi * xfi).sum(-1)
    xfin[n_rows:] = float("inf")
    for m in (m_pad, n_rows + 64):
        gk = fused_candidates(qi, qfi, xi, xfi, m, xin, xfin)
        gr = fused_candidates_scan(qi, qfi, xi, xfi, m, xin, xfin)
        check(torch.equal(gk[0], gr[0]) and torch.equal(gk[1], gr[1]),
              f"[lifecycle] fused_candidates: not bit-equal on integer "
              f"padded data at m={m}")
    del qfi, xfi, xfin, qi, xi, qin, xin
    gi, gv = fused_candidates(qp, q, o.proxy, o.X, m_pad, o.proxy_norms,
                              o.x_norms)
    own = rel_err(ref.support_sqdist_ref(q, o.X, o.x_norms, gi), gv)
    errs["fused_candidates"] = own
    check(own <= DIST_RTOL and bool((gi < n_rows).all()),
          f"[lifecycle] fused_candidates: own-row rel {own:.3g} or a "
          f"padding row among the candidates")
    # kernel 7 (the probe launch): integer data bit-equal in every field;
    # spare windows (+inf centroid norms) never probed before a real one
    steps = sampling_timesteps(sched, STEPS)[:-1]
    p_step = max(pe.nprobe(int(tt)) for tt in steps)
    cents = ix0.centroids
    dpc = cents.shape[1]
    ci, qi7 = dints((w, dpc), 75), dints((B, D), 76)
    spare = torch.isinf(ix0.centroid_norms)
    ci[spare] = 0.0
    cn = (ci * ci).sum(-1)
    cn[spare] = float("inf")
    for p in (p_step, w):
        got = ops.ivf_probe(qi7, st.image_shape, 4, ci, cn, o.offsets,
                            o.perm, n_cap, p, lc.capacity)
        want = ref.ivf_probe_ref(
            ref.downsample_proxy(qi7.reshape((B,) + tuple(st.image_shape)),
                                 4), ci, cn, o.offsets, o.perm, n_cap, p,
            lc.capacity)
        for field, gg, rr in zip(ref.PROBE_FIELDS, got, want):
            check(torch.equal(gg, rr), f"[lifecycle] ivf_probe P={p}: "
                  f"{field} not bit-equal on integer padded data")
        ranks = spare[got.probe]
        check(not bool(ranks[:, :min(p, w_real)].any())
              and bool(ranks[:, w_real:].all()),
              f"[lifecycle] ivf_probe P={p}: a spare window probed before "
              f"a real one")
    pr = ops.ivf_probe(q, st.image_shape, 4, cents, ix0.centroid_norms,
                       o.offsets, o.perm, n_cap, p_step, lc.capacity)
    pr_ref = ref.ivf_probe_ref(qp, cents, ix0.centroid_norms, o.offsets,
                               o.perm, n_cap, p_step, lc.capacity)
    check(not bool(spare[pr.probe].any()),
          "[lifecycle] a spare window among the float probes")
    near = torch.equal(pr.ids, pr_ref.ids) and torch.equal(pr.valid,
                                                           pr_ref.valid)
    # kernel 2 (support_sqdist, in golden_rerank) and kernel 3 (the
    # aggregate) over the probed slots, empty ones included
    d2s = ops.support_distances(q, o.X, pr.ids, o.x_norms)
    d2s_r = ref.support_sqdist_ref(q, o.X, o.x_norms, pr.ids)
    fin = torch.isfinite(d2s_r)
    check(torch.equal(torch.isfinite(d2s), fin), "[lifecycle] "
          "support_sqdist: +inf pattern on the probed slots")
    errs["support_sqdist"] = rel_err(d2s[fin], d2s_r[fin])
    empty = ~torch.isfinite(ix0.proxy_norms_sorted[pr.pos])
    check(bool(torch.isinf(d2s[empty & pr.valid]).all()),
          "[lifecycle] an empty slot re-ranked finite")
    idx, d2 = ops.golden_rerank(q, o.X, pr.ids, k_pad, x_norms=o.x_norms,
                                valid=pr.valid)
    fin = torch.isfinite(d2)
    check(bool((idx[fin] < n_rows).all()) and bool(
        (fin.long().diff(dim=1) <= 0).all()),
        "[lifecycle] golden set: a padding row ranks before a real row")
    lg = torch.clamp_min(-d2 / (2.0 * sig2), -1e30)
    agg = ops.golden_support_aggregate(o.X, idx, lg)
    errs["golden_support_aggregate"] = float(
        (agg - ref.golden_support_aggregate_ref(o.X, idx, lg)).abs().max())
    w_pad = torch.softmax(lg, -1)[~fin]
    check(w_pad.numel() == 0 or float(w_pad.max()) == 0.0,
          "[lifecycle] a padding row got a weight")
    # kernel 4 (the full scan): padded equals unpadded
    fs = ops.golden_aggregate(q, o.X, sig2, o.x_norms)
    errs["golden_aggregate"] = float(
        (fs - ref.golden_aggregate_ref(q, o.X, sig2, o.x_norms)).abs().max())
    unpadded = float((fs - ops.golden_aggregate(q, st.X, sig2, st.x_norms)
                      ).abs().max())
    check(errs["support_sqdist"] <= DIST_RTOL
          and errs["golden_support_aggregate"] <= MEAN_ATOL
          and errs["golden_aggregate"] <= MEAN_ATOL and unpadded <= MEAN_ATOL,
          f"[lifecycle] kernel errors on padded operands {errs}, full scan "
          f"padded vs unpadded {unpadded:.3g}")
    print(f"[lifecycle] kernels 1-7 on the padded operands (B={B}, n_cap="
          f"{n_cap}, m={m_pad}, k={k_pad}, P={p_step} of {w} windows): "
          f"integer data bit-equal (pdist, screen_topm and fused_candidates "
          f"at m={m_pad} and {n_rows + 64}, ivf_probe at P={p_step} and "
          f"{w}); float errors " + ", ".join(f"{k} {v:.3g}" for k, v in
                                             errs.items())
          + f"; full scan padded vs unpadded max abs {unpadded:.3g}; no "
          f"+inf-norm row or spare window ranks before a real one, none "
          f"weighs; float probe ids equal the plain version's {near}")
    del gi, gv, d2s, d2s_r, fs, agg

    # the layout's price: padded vs unpadded indexed plan, one x_T
    upe = ServeEngine(st, num_steps=STEPS, max_batch=B, gd_cfg=cfg,
                      index=cix, probe_schedule=probes, device=dev)

    def plan_run(s):
        e = s.engine
        return sample_plan(s.denoiser.call_masked, sched, (B, D), s.plan,
                           x_init=x_T, program_cache=e.program,
                           jitter=e.jitter)

    for line in plan.describe().splitlines():
        print(f"[lifecycle] padded plan: {line}")
    for line in upe.plan.describe().splitlines():
        print(f"[lifecycle] unpadded plan: {line}")

    # -- [runtime] warmup: every rung on two slots ----------------------------
    alloc0, res0 = memory()
    rcfg = dict(max_queue=64, backoff_base_s=0.001, backoff_max_s=0.01,
                breaker_cooldown_s=0.5)
    rt = ServeRuntime(srv, RuntimeConfig(**rcfg))
    _, wiener_s = timed(rt._wiener_den)
    stats = rt.warmup()
    alloc1, res1 = memory()
    slot_bytes = sum(t_.numel() * t_.element_size()
                     for t_ in pe.current_operands() if t_ is not None)
    print(f"[runtime] warmup: {stats['graphs_captured']} CUDA graphs on "
          f"slots {stats['slots']} ({stats['programs_total']} programs with "
          f"the slot-free Gaussian segments) in "
          f"{stats['runtime_warmup_s']:.2f} s after {wiener_s:.2f} s for the "
          f"Wiener rung's host SVD of the padded store; device memory held "
          f"after: {(alloc1 - alloc0) / 2**30:.3f} GiB allocated, "
          f"{(res1 - res0) / 2**30:.3f} GiB reserved "
          f"(a slot's operands {slot_bytes / 2**30:.3f} GiB)")
    c0, b0 = pe._captures, pe._builds
    # padded vs unpadded plan walls (the padded one on the warmed graphs)
    x_pad = plan_run(srv)
    x_unp = plan_run(upe)
    walls = {"padded": [], "unpadded": []}
    for which in ("padded", "unpadded", "unpadded", "padded"):
        s_ = srv if which == "padded" else upe
        walls[which].append(wall_ms(lambda: plan_run(s_), iters=10))
    busy = {k: device_kernels(lambda: plan_run(srv if k == "padded"
                                               else upe))[0]
            for k in walls}
    diff = float((x_pad - x_unp).abs().max())
    check(bool(torch.isfinite(x_pad).all()), "[lifecycle] padded plan "
          "not finite")
    ratio = min(walls["padded"]) / min(walls["unpadded"])
    print("[lifecycle] indexed plan from one x_T, B=16, 10 steps: "
          + "; ".join(
        f"{k} wall {min(v):.2f} ms (runs {[round(x, 2) for x in v]}), busy "
        f"{busy[k]:.2f} ms, idle {1 - busy[k] / min(v):.3f}"
        for k, v in walls.items())
        + f"; padded/unpadded wall {ratio:.3f}"
        f"; |padded - unpadded| max {diff:.3g} (m_t, k_t follow n_cap)")
    del upe

    # -- [runtime] continuous serving -----------------------------------------
    sizes = np.random.default_rng(1).integers(1, 5, LIVE_REQS)
    rid = [0]

    def serve(n_reqs=LIVE_REQS, runtime=None, seed0=1000, burst=2):
        """``n_reqs`` requests arriving ``burst`` at a time, one burst
        a scheduler step, then drained: later arrivals join waves in
        flight (continuous batching)."""
        r = runtime or rt
        tickets = []
        for i in range(n_reqs):
            tickets.append(r.submit(Request(
                rid[0], int(sizes[i % LIVE_REQS]), seed=seed0 + i)))
            rid[0] += 1
            if (i + 1) % burst == 0:
                r.pump()
        r.run_until_idle()
        return tickets

    def zero():
        for kfn in kernels.values():
            kfn.launches = 0

    def counts() -> dict:
        return {n: f.launches for n, f in kernels.items()}

    path_counts = Counter()
    serve()                                          # warm the host path
    zero()
    mixed0, joins0 = rt.counters["mixed_segments"], rt.counters["joins"]
    tickets, wall = timed(serve)
    path_counts.update(counts())
    lat = np.array([t_.latency_s for t_ in tickets]) * 1e3
    check(all(t_.status == "done" and np.isfinite(t_.images).all()
              for t_ in tickets), "[runtime] a ticket failed or is not finite")
    busy_ms = device_kernels(serve)[0]
    n_img = int(sizes.sum())
    print(f"[runtime] served {LIVE_REQS} requests ({n_img} images, 1-4 each,"
          f" two arriving a scheduler step) in {wall * 1e3:.1f} ms: "
          f"{n_img / wall:.1f} images/s, latency p50 "
          f"{np.percentile(lat, 50):.1f} ms p99 {np.percentile(lat, 99):.1f} "
          f"ms; {rt.counters['mixed_segments'] - mixed0} mixed segments, "
          f"{rt.counters['joins'] - joins0} joins; device busy "
          f"{busy_ms:.1f} ms of the wall: host share at the seams "
          f"{1 - busy_ms / (wall * 1e3):.3f}; launches {dict(path_counts)}")
    check(pe._captures == c0 and pe._builds == b0,
          "[runtime] serving captured or built after warmup")

    # -- [runtime] two hot swaps, one with a wave in flight -------------------
    def one(seed, n=4):
        t_ = rt.submit(Request(rid[0], n, seed=seed))
        rid[0] += 1
        return t_

    base = one(77)
    rt.run_until_idle()
    app = [timed(lambda: lc.append(new_rows(LIVE_APPEND)))[1]
           for _ in range(2)]
    bytes0 = on_disk()
    e1, commit1_s = timed(lc.commit)
    print(f"[lifecycle] append {LIVE_APPEND} rows: {app[0]:.3f} s and "
          f"{app[1]:.3f} s (journal fsync'd first); commit epoch {e1} in "
          f"{commit1_s:.2f} s, {on_disk() - bytes0} bytes written net "
          f"(the new epoch less the truncated journal)")
    view1 = lc.view(device=dev)
    inflight = one(77)
    check(rt.pump() and inflight.status == "running",
          "[runtime] no wave in flight before the swap")
    rt.hot_swap(*view1)
    sw1 = dict(rt.last_swap)
    rt.run_until_idle()
    check(inflight.status == "done" and np.array_equal(inflight.images,
                                                       base.images),
          "[runtime] the in-flight wave differs from its old-epoch run")

    def fresh_check(view, label):
        t_ = one(91)
        rt.run_until_idle()
        fe = ServeEngine(view[0], num_steps=STEPS, max_batch=B, gd_cfg=cfg,
                         index=view[1], probe_schedule=probes, device=dev)
        x0 = fe._init_noise([(t_.request, 0, 4)], 4)
        want = sample_plan(fe.denoiser.call_masked, sched, (4, D), fe.plan,
                           x_init=x0).cpu().numpy()
        check(np.array_equal(t_.images.reshape(4, D), want),
              f"[runtime] delivery after {label} differs from a fresh eager "
              f"engine on the new view")
        return t_

    fresh_check(view1, "swap 1")
    del view1
    lc.append(new_rows(LIVE_APPEND))
    live = {k: v.copy() for k, v in lc._arrays().items()}
    reopened, open_s = timed(lambda: StoreLifecycle.open(root))
    check(reopened.replayed_frames == 1 and all(
        np.array_equal(v, reopened._arrays()[k]) for k, v in live.items()),
        "[lifecycle] open: the replayed store differs from the live one")
    del reopened, live
    bytes0 = on_disk()
    e2, commit2_s = timed(lc.commit)
    view2 = lc.view(device=dev)
    rt.hot_swap(*view2)
    sw2 = dict(rt.last_swap)
    fresh_check(view2, "swap 2")
    del view2
    h = rt.health()
    check(pe._captures == c0 and pe._builds == b0
          and h["compiles_post_warmup"] == 0 and h["epochs_resident"] == 1,
          f"[runtime] the swaps captured {pe._captures - c0} graphs, built "
          f"{pe._builds - b0}; {h['epochs_resident']} epochs resident")
    print(f"[lifecycle] open (load epoch {e1}, validate, replay 1 frame of "
          f"{LIVE_APPEND} rows) {open_s:.2f} s, bit-equal to the live store; "
          f"commit epoch {e2} {commit2_s:.2f} s, {on_disk() - bytes0} bytes "
          f"net; {lc.n_rows} rows in {n_cap} slots")
    print(f"[runtime] hot swap 1 (a wave in flight): install copy "
          f"{sw1['install_s'] * 1e3:.1f} ms, probe {sw1['probe_s'] * 1e3:.1f}"
          f" ms, flip {sw1['flip_s'] * 1e3:.3f} ms; hot swap 2: install "
          f"{sw2['install_s'] * 1e3:.1f} ms, probe {sw2['probe_s'] * 1e3:.1f}"
          f" ms, flip {sw2['flip_s'] * 1e3:.3f} ms; 0 builds and 0 captures "
          f"after warmup; the in-flight wave bit-equal to its old-epoch run, "
          f"deliveries after each swap bit-equal to a fresh eager engine on "
          f"the new view")

    # -- [runtime] the fault ladder -------------------------------------------
    lad = ServeRuntime(srv, RuntimeConfig(breaker_threshold=1, **rcfg))
    lad.warmup()
    fc = FaultConfig(seed=3, nan_rate=0.05, error_rate=0.05, oom_rate=0.03,
                     evict_rate=0.02)
    zero()
    c1 = pe._captures
    with injected(fc) as inj:
        tickets = serve(runtime=lad, seed0=5000)
    path_counts.update(counts())
    check(all(t_.status == "done" and np.isfinite(t_.images).all()
              for t_ in tickets)
          and lad.counters["completed"] == len(tickets),
          f"[runtime] ladder: {Counter(t_.status for t_ in tickets)}")
    kinds = Counter(e[0] for e in inj.events)
    hl = lad.health()
    rates = {k: v for k, v in dataclasses.asdict(fc).items()
             if k.endswith("_rate") and v}
    print(f"[runtime] fault ladder, seed {fc.seed}, rates {rates}: "
          f"{len(tickets)} tickets done and "
          f"finite ({sum(t_.degraded for t_ in tickets)} degraded); faults "
          f"{dict(kinds)}; counters " + ", ".join(
              f"{k} {v}" for k, v in lad.counters.items() if v)
          + f"; breakers " + ", ".join(
              f"{k[8:]} {hl[k]}" for k in hl if k.startswith("breaker_"))
          + f"; {pe._captures - c1} graphs recaptured after evictions")

    # a NaN storm trips the screen breaker: the next wave takes the
    # exact rung (the exact coarse screen: kernel 1 at these fractions)
    storm = ServeRuntime(srv, RuntimeConfig(breaker_threshold=1, **rcfg))
    storm.warmup()
    zero()
    with injected(FaultConfig(seed=4, nan_rate=1.0)):
        tickets = [serve(1, runtime=storm, seed0=6000, burst=1)[0]
                   for _ in range(2)]
    path_counts.update(counts())
    check(all(t_.status == "done" and t_.degraded
              and np.isfinite(t_.images).all() for t_ in tickets)
          and storm.counters["exact_waves"] >= 1,
          f"[runtime] NaN storm: {storm.counters}")
    print(f"[runtime] NaN storm (every segment's output corrupted): 2 "
          f"tickets done, degraded and finite; finite trips "
          f"{storm.counters['finite_trips']}, Gaussian segments "
          f"{storm.counters['gauss_segments']}, exact waves "
          f"{storm.counters['exact_waves']}; launches {counts()}")

    # an evict storm: every program lookup drops its graph, so each
    # dispatch recaptures one after warmup (the collector must not run
    # inside those captures) and the compile breaker opens: the scan rung
    ev = ServeRuntime(srv, RuntimeConfig(breaker_threshold=1, **rcfg))
    ev.warmup()
    zero()
    c1, b1 = pe._captures, pe._builds
    with injected(FaultConfig(seed=5, evict_rate=1.0)) as inj:
        tickets = [serve(1, runtime=ev, seed0=6500, burst=1)[0]
                   for _ in range(2)]
    path_counts.update(counts())
    recaptured, rebuilt = pe._captures - c1, pe._builds - b1
    check(all(t_.status == "done" and np.isfinite(t_.images).all()
              for t_ in tickets) and ev.counters["scan_waves"] >= 1
          and rebuilt > 0 and ev.health()["compiles_post_warmup"] == rebuilt
          and (recaptured == rebuilt or dev.type != "cuda"),
          f"[runtime] evict storm: {ev.counters}, {rebuilt} builds, "
          f"{recaptured} captures")
    print(f"[runtime] evict storm (every lookup evicts): 2 tickets done and "
          f"finite; {len(inj.events)} evictions, {recaptured} graphs "
          f"recaptured after warmup, builds counted "
          f"{ev.health()['compiles_post_warmup']}, scan waves "
          f"{ev.counters['scan_waves']}, breaker compile "
          f"{ev.health()['breaker_compile']}; launches {counts()}")
    del ev

    # a fused engine on the same view: its exact rung (the screen
    # breaker's) runs kernel 6 on the padded operands in captured graphs
    fsrv = ServeEngine(ds0, num_steps=STEPS, max_batch=B, gd_cfg=cfg,
                       index=ix0, probe_schedule=probes, device=dev,
                       fused=True)
    fst = ServeRuntime(fsrv, RuntimeConfig(breaker_threshold=1, **rcfg))
    fst._wiener = rt._wiener        # same store: the same host SVD
    fstats = fst.warmup()
    zero()
    cf = fsrv.engine._captures
    with injected(FaultConfig(seed=4, nan_rate=1.0)):
        tickets = [serve(1, runtime=fst, seed0=6000, burst=1)[0]
                   for _ in range(2)]
    fcounts = counts()
    path_counts.update(fcounts)
    check(all(t_.status == "done" and t_.degraded
              and np.isfinite(t_.images).all() for t_ in tickets)
          and fst.counters["exact_waves"] >= 1
          and fcounts["fused_candidates"] > 0
          and fsrv.engine._captures == cf,
          f"[runtime] fused NaN storm: {fst.counters}, launches {fcounts}")
    print(f"[runtime] fused engine (fused=True; warmup "
          f"{fstats['graphs_captured']} graphs in "
          f"{fstats['runtime_warmup_s']:.2f} s): NaN storm, 2 tickets done, "
          f"degraded and finite, exact waves {fst.counters['exact_waves']} "
          f"on captured graphs (0 captures after warmup); launches {fcounts}")
    del fst, fsrv

    # -- [runtime] the tracer's cost ------------------------------------------
    prev = obs_trace.tracer()
    walls = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off") * 3:
        tr = obs_trace.Tracer(capacity=1 << 16) if mode == "on" else None
        obs_trace.set_tracer(tr)
        try:
            walls[mode].append(timed(lambda: serve(16, seed0=7000))[1] * 1e3)
        finally:
            obs_trace.set_tracer(prev)
    med = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"[runtime] 16 requests traced vs not, 6 runs each in turns: on "
          + ", ".join(f"{v:.1f}" for v in walls["on"]) + " ms, off "
          + ", ".join(f"{v:.1f}" for v in walls["off"]) + f" ms; medians "
          f"{med['on']:.1f} and {med['off']:.1f} ms (on/off "
          f"{med['on'] / med['off']:.3f})")
    # -- [runtime] the quality monitor on the same engine ----------------------
    mon = QualityMonitor(pe, registry=MetricsRegistry(), sample_rate=1.0)
    mrt = ServeRuntime(srv, RuntimeConfig(**rcfg), monitor=mon)
    c1 = pe._captures
    mstats = mrt.warmup()
    warm_caps = pe._captures - c1
    c1, b1 = pe._captures, pe._builds
    tickets = serve(8, runtime=mrt, seed0=8000)
    hm = mrt.health()
    check(all(t_.status == "done" and np.isfinite(t_.images).all()
              for t_ in tickets) and pe._captures == c1
          and pe._builds == b1 and hm["compiles_post_warmup"] == 0
          and hm["n_recall_probes"] > 0,
          f"[runtime] monitor: {hm}, {pe._captures - c1} captures")
    print(f"[runtime] QualityMonitor (sample rate 1.0, 2 probe rows): "
          f"warmup {mstats['probe_ts_warmed']} probe timesteps, "
          f"{warm_caps} graphs captured for the probes on the kept slots; "
          f"8 requests: {hm['n_recall_probes']:.0f} recall probes, recall "
          f"last {hm['screen_recall_last']:.4f}, p50 "
          f"{hm['screen_recall_p50']:.4f}, min "
          f"{mon.recall_hist.quantile(0.0):.4f}; steps observed "
          f"{hm['n_steps_observed']:.0f}, k_t/N p50 "
          f"{hm['subset_frac_p50']:.4f}, occupancy p50 "
          f"{hm['probe_occupancy_p50']:.4f}; 0 builds and 0 captures after "
          f"warmup")
    del mrt, mon
    need = ("support_sqdist", "golden_support_aggregate", "centroid_scan")
    check(all(path_counts[n] > 0 for n in need)
          and (path_counts["screen_topm"]
               + path_counts["fused_candidates"]) > 0,
          f"[runtime] the runtime path's launches {dict(path_counts)}")
    # the committed epoch stays for [pmesh], whose ranks open it by slab
    # (it removes the directory), and its state, whose view is [pmesh]'s
    # one-card reference
    ctx["lifecycle"], ctx["lifecycle_state"] = tmp, lc
    print(f"[runtime] phase {time.perf_counter() - t_phase:.1f} s; runtime "
          f"path launches {dict(path_counts)}")
    return dict(path_counts)


SHARDS = (2, 8)            # LocalMesh sizes of the [sharded] phase
SGS, SGA = "golden_support_aggregate_state", "golden_aggregate_state"
# the kernels each sharded route launches S times a step (the fused
# sharded step is the staged one's operations in another order, and its
# screen materializes at the shard's size)
SHARD_ROUTES = {
    "staged": ("pdist", "support_sqdist", SGS),
    "streamed": ("screen_topm", "support_sqdist", SGS),
    "fused": ("pdist", "support_sqdist", SGS),
    "indexed": ("centroid_scan", "support_sqdist", SGS),
    "full_scan": (SGA,),
    "plan": ("pdist", "support_sqdist", SGS)}
ROUTE_KW = {"staged": dict(fused=False, screen="materialized"),
            "streamed": dict(fused=False, screen="streamed"),
            "fused": dict(fused=True, screen="auto"),
            "full_scan": dict(fused="auto", screen="auto"),
            "plan": dict(fused="auto", screen="auto"),
            "indexed": {}}


@contextlib.contextmanager
def routed(eng, fused, screen):
    """The engine's route policies set for one trajectory (both are read
    at every step), put back after."""
    old = eng.fused, eng.screen
    eng.fused, eng.screen = fused, screen
    try:
        yield eng
    finally:
        eng.fused, eng.screen = old


def route_trajectory(gd, route: str, sched, x_T: torch.Tensor):
    """The route's STEPS-step trajectory from ``x_T`` as a callable:
    ``sample`` over ``gd`` (``FullScan`` of its engine for "full_scan"),
    or ``sample_plan`` through the engine's program cache and ``jitter``
    for "plan" (CUDA graphs where the engine captures)."""
    from repro_torch.core import FullScan, build_plan, sample, sample_plan
    eng, shape = gd.engine, tuple(x_T.shape)
    if route == "full_scan":
        return lambda: sample(FullScan(eng), sched, shape, num_steps=STEPS,
                              x_init=x_T)
    if route == "plan":
        pln = build_plan(eng, STEPS)
        return lambda: sample_plan(gd.call_masked, sched, shape, pln,
                                   x_init=x_T, program_cache=eng.program,
                                   jitter=eng.jitter)
    return lambda: sample(gd, sched, shape, num_steps=STEPS, x_init=x_T)


def route_launches(names, route: str, eng, shards: int) -> dict:
    """The launches a sharded route's trajectory must count: each of its
    kernels (SHARD_ROUTES) ``shards`` times a step, kernel 7 on the
    steps the index serves and kernel 1 on the indexed route's others;
    every other kernel (the unsharded entries of 3 and 4 too) never."""
    from repro_torch.core import sampling_timesteps
    n_ix = (sum(eng.use_index(int(t)) for t in
                sampling_timesteps(eng.schedule, STEPS)[:-1])
            if route == "indexed" else 0)
    want = {n: 0 for n in names}
    for n in SHARD_ROUTES[route]:
        want[n] = shards * (n_ix if n == "centroid_scan" else STEPS)
    if route == "indexed":
        want["pdist"] = shards * (STEPS - n_ix)
    return want


def near_tie_swaps(got: torch.Tensor, want: torch.Tensor, q: torch.Tensor,
                   x: torch.Tensor, eng=None, t: int = 0) -> tuple[int, bool]:
    """Rows in one golden set of a query and not in the other: their
    count, and whether each is explained by a tie at a cut, which fp32
    sums in another order, or the threshold's rule, may resolve either
    way: a row lost or gained within 1e-6 of ||q||^2 of the one-card
    set's k-th exact distance (float64 on the host), or (``eng``, the
    one-card engine, exact screen) a gained row whose proxy distance
    lies within 1e-6 of ||q_p||^2 of the one-card screen's m-th: the
    cross-shard m-th threshold (``neg >= mth``) admits every candidate
    tied there, as the reference's sharded engine does."""
    swaps, ok = 0, True
    for b in range(got.shape[0]):
        g, w = set(got[b].tolist()), set(want[b].tolist())
        if g == w:
            continue
        swaps += len(g - w)
        qb = q[b].double().cpu()
        rows = sorted(w | g)
        d = dict(zip(rows, ((x[rows].double().cpu() - qb) ** 2)
                     .sum(-1).tolist()))
        kth = max(d[r] for r in w)
        tol = 1e-6 * float((qb * qb).sum())
        bad = [r for r in g ^ w if abs(d[r] - kth) > tol]
        if bad and eng is not None:
            qp = eng._proxy_query(q[b: b + 1])[0].double().cpu()
            cand = eng.coarse(q[b: b + 1], eng.sizes(t)[0])[0].tolist()
            pr = eng.proxy.double()
            mth = float(((pr[cand].cpu() - qp) ** 2).sum(-1).max())
            pd = ((pr[bad].cpu() - qp) ** 2).sum(-1).tolist()
            ptol = 1e-6 * float((qp * qp).sum())
            bad = [r for r, v in zip(bad, pd)
                   if r not in g or abs(v - mth) > ptol]
        ok &= not bad
    return swaps, ok


def swap_allowance(got: torch.Tensor, want: torch.Tensor, q: torch.Tensor,
                   x64: torch.Tensor, sig2: float) -> torch.Tensor:
    """Per query, how far the sharded mean may stray from the one-card
    one (golden sets ``got`` and ``want``, k rows each): MEAN_ATOL, plus
    2 max|x| times the softmax weight (float64 distances to the rows
    ``x64``, normalized over ``want``) of every row that one engine may
    hold and the other not: the rows in one set only (ties at a cut,
    ``near_tie_swaps``) and the rows outside ``want`` within 1e-6 of
    ||q||^2 of its k-th distance, which the cross-shard threshold
    (``neg >= kth``) keeps beside the k-th, as the reference's sharded
    engine does.  No such row: MEAN_ATOL alone."""
    q64 = q.double()
    d = ((q64 * q64).sum(-1, keepdim=True) + (x64 * x64).sum(-1)
         - 2.0 * q64 @ x64.T)                                 # [B, N]
    out = torch.full((got.shape[0],), MEAN_ATOL, dtype=torch.float64)
    xmax = float(x64.abs().max())
    for b in range(got.shape[0]):
        db, w = d[b], want[b]
        tol = 1e-6 * float((q64[b] * q64[b]).sum())
        inw = torch.zeros_like(db, dtype=torch.bool)
        inw[w] = True
        ing = torch.zeros_like(inw)
        ing[got[b]] = True
        moved = (inw ^ ing) | (~inw & ((db - db[w].max()).abs() <= tol))
        lg = -(db - db[w].min()) / (2.0 * sig2)
        wt = torch.exp(lg) / torch.exp(lg[w]).sum()
        out[b] += 2.0 * xmax * float(wt[moved].sum())
    return out


def sharded_phase(ctx: dict) -> tuple[dict, dict]:
    """[sharded]: the store sharded over a ``LocalMesh`` on the one card.

    The state entries of kernels 3 and 4 (fp32 and bf16 rows) against
    their plain versions at a shard's shapes (S=8: n_loc=6250, B=16,
    k=5000; integer data bit-equal, an all-padding shard exactly the
    plain version's finite state, floats within DIST_RTOL of the largest
    value and MEAN_ATOL on the means), timed against their bytes bound;
    then at S=2 and S=8, from the x_T of the other phases, each sharded
    route against the single-card engine's (staged, streamed, fused,
    indexed at INDEXED_CFG, full scan, the plan on CUDA graphs) within
    TRAJ_TOL after 10 steps, each counted alone (every shard-local kernel
    S times a step; the unsharded entries of kernels 3 and 4 never),
    timed in turns with the single-card route and profiled; ``select``
    at t in {100, 500, 900} (overlap 1.0) and the single steps within
    MEAN_ATOL; the sharded plan's replay bit-equal to eager and a
    plan-mode ``ServeEngine(mesh=...)`` capturing nothing after
    ``warmup()``; ``ServeRuntime`` over a sharded engine on the gmm store
    through a ``shard_drop`` storm.  Returns the state entries' numbers
    and the sharded path's counts."""
    from repro_torch.core import (GoldDiff, OptimalDenoiser, build_plan,
                                  sample_plan)
    from repro_torch.distributed import LocalMesh, lse_merge_mean
    from repro_torch.index.shard import shard_layout
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.golden_aggregate import golden_aggregate_state
    from repro_torch.kernels.golden_support_aggregate import (
        golden_support_aggregate_state)
    from repro_torch.launch.faults import FaultConfig, injected
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import Request, ServeEngine

    t_phase = time.perf_counter()
    st, sched, x_T = ctx["store"], ctx["sched"], ctx["x_T"]
    dev = st.device          # the card (a CPU store rehearses the phase)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    full = OptimalDenoiser(st, sched, device=dev)
    names = {k.__name__: k for k in ops.COUNTED}
    res = {}

    def zero():
        for k in ops.COUNTED:
            k.launches = 0
        for k in ops.COUNTED_BF16:
            k.launches_bf16 = 0

    def counted(fn):
        zero()
        sync()
        out = fn()
        sync()
        return out, ({n: k.launches for n, k in names.items()},
                     {n: getattr(k, "launches_bf16", 0)
                      for n, k in names.items()})

    ikw = dict(cfg=ctx["indexed_cfg"], index=ctx["cix"],
               probe_schedule=ctx["probes"])
    one = {"exact": GoldDiff(full), "indexed": GoldDiff(full, **ikw)}
    one_staged = {"exact": GoldDiff(full, fused=False),
                  "indexed": GoldDiff(full, fused=False, **ikw)}

    # -- the state entries at a shard's shapes (S=8) ---------------------------
    lay = shard_layout(st, LocalMesh((SHARDS[-1],), ("data",)))
    n_loc = lay.n_loc
    _, sig2 = one["exact"].engine.constants(500)
    q = ctx["q"]
    g = torch.Generator().manual_seed(24)
    k = min(K, n_loc)
    idx = torch.randint(0, n_loc, (B, k), generator=g).to(dev)
    lg01 = torch.where(torch.rand(B, k, generator=g) < 0.5, 0.0,
                       ref.NEG_INF).to(dev)
    lg01[1] = ref.NEG_INF                      # an all-NEG_INF query
    d = st.dim
    xi = ints((n_loc, d), 90).to(dev)
    pad_n = torch.full((n_loc,), float("inf"), device=dev)

    def close(got, want, label):
        """(max abs error of the mean acc / l, of the state) within
        DIST_RTOL of the largest value; m and l as well."""
        errs = [float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                for x, y in zip(got, want)]
        mean = float((got[0] / got[2][:, None] - want[0] / want[2][:, None])
                     .abs().max())
        check(max(errs) <= DIST_RTOL and mean <= MEAN_ATOL,
              f"[sharded] {label}: state errors {errs}, mean {mean:.3g}")
        return mean, errs

    for dt in (torch.float32, BF16):
        tag = "bf16" if dt == BF16 else "fp32"
        xs = lay.X[0].to(dt)                    # shard 0's slab
        xn = lay.x_norms[0]
        # kernel 3's state entry: integer rows and 0/NEG_INF logits are
        # exact; the path's rows with their own distances' logits
        xb = xi.to(dt)
        got = golden_support_aggregate_state(xb, idx, lg01)
        want = ref.partial_aggregate_ref(xb, idx, lg01)
        check(all(torch.equal(u, v) for u, v in zip(got, want)),
              f"[sharded] {SGS} {tag}: integer data not bit-equal")
        lg = torch.clamp_min(-ops.support_distances(q, xs, idx, xn)
                             / (2.0 * sig2), ref.NEG_INF)
        got = golden_support_aggregate_state(xs, idx, lg)
        mean3, errs3 = close(got, ref.partial_aggregate_ref(xs, idx, lg),
                             f"{SGS} {tag}")
        u3 = int(torch.unique(idx).numel())
        item = xs.element_size()
        b_ms, b_by = bound(item * u3 * d + 4 * B * d + 12 * B * k + 8 * B,
                           2 * B * k * d)
        res[f"{SGS}[{tag}]"] = dict(
            max_abs_err=mean3, ms=time_ms(
                lambda: golden_support_aggregate_state(xs, idx, lg)),
            plain_ms=time_ms(lambda: ref.partial_aggregate_ref(xs, idx, lg),
                             iters=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        # kernel 4's state entry: the integer store at sigma2 = 0 with its
        # own rows as queries (weights 1 or 0: exact), an all-padding
        # shard (m = NEG_INF, l = n_loc, acc = 0), the path's slab
        qi = xi[:B].clone()
        xin = (xi * xi).sum(-1)
        got = golden_aggregate_state(qi, xb, 0.0, xin)
        check(all(torch.equal(u, v) for u, v in zip(
            got, ref.full_partial_ref(qi, xb, 0.0, xin))),
              f"[sharded] {SGA} {tag}: integer data not bit-equal")
        got = golden_aggregate_state(q, torch.zeros_like(xb), sig2, pad_n)
        want = ref.full_partial_ref(q, torch.zeros_like(xb), sig2, pad_n)
        check(all(torch.equal(u, v) for u, v in zip(got, want))
              and bool((got[1] == ref.NEG_INF).all())
              and bool((got[2] == n_loc).all()),
              f"[sharded] {SGA} {tag}: the all-padding shard {got[1][:2]}, "
              f"{got[2][:2]}")
        # the float data: a shard's (acc, l) carry the common factor
        # exp(-m), and for a query whose near rows lie in other shards
        # its mean is a softmax over far rows of close logits, where
        # fp32 distances in another order move it by ~1e-4; what the
        # entry must give is a max logit within DIST_RTOL and states
        # that merge into the full scan: the S shards' states, merged by
        # log-sum-exp, against the plain full-store mean within MEAN_ATOL
        xall = st.X.to(dt)
        states = [golden_aggregate_state(q, lay.X[i].to(dt), sig2,
                                         lay.x_norms[i])
                  for i in range(SHARDS[-1])]
        merged = lse_merge_mean(*zip(*states),
                                LocalMesh((SHARDS[-1],), ("data",)))
        mean4 = float((merged - ref.golden_aggregate_ref(
            q, xall, sig2, st.x_norms)).abs().max())
        m_err = max(float(((u[1] - v[1]).abs()
                           / v[1].abs().clamp_min(1e-30)).max())
                    for u, v in zip(states, (
                        ref.full_partial_ref(q, lay.X[i].to(dt), sig2,
                                             lay.x_norms[i])
                        for i in range(SHARDS[-1]))))
        shard0 = float((states[0][0] / states[0][2][:, None]
                        - (lambda w: w[0] / w[2][:, None])(
                            ref.full_partial_ref(q, xs, sig2, xn)))
                       .abs().max())
        check(m_err <= DIST_RTOL and mean4 <= MEAN_ATOL,
              f"[sharded] {SGA} {tag}: max logit {m_err:.3g} (rel), "
              f"merged mean {mean4:.3g}")
        errs4 = [m_err]
        del xall, states
        print(f"[sharded] {SGA} {tag}: the {SHARDS[-1]} shards' states "
              f"merged by log-sum-exp vs the plain full-store mean max abs "
              f"{mean4:.3g}; max logits within {m_err:.3g} (rel); shard 0's "
              f"own mean vs its plain state's {shard0:.3g} (not gated: far "
              f"queries)")
        b_ms, b_by = bound(item * n_loc * d + 4 * (n_loc + 2 * B * d + B)
                           + 8 * B, 8 * B * n_loc * d, TF32_FLOPS_PER_S)
        res[f"{SGA}[{tag}]"] = dict(
            max_abs_err=mean4,
            ms=time_ms(lambda: golden_aggregate_state(q, xs, sig2, xn)),
            plain_ms=time_ms(lambda: ref.full_partial_ref(q, xs, sig2, xn)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        for n in (SGS, SGA):
            r = res[f"{n}[{tag}]"]
            print(f"[sharded] {n} {tag} rows (n_loc={n_loc}, B={B}"
                  + (f", k={k}" if n == SGS else "") + f"): integer data "
                  f"bit-equal, all-padding state exact; path rows max abs "
                  f"{r['max_abs_err']:.3g} on the "
                  + ("mean, state " if n == SGS else "merged mean, max logit ")
                  + f"{max(errs3 if n == SGS else errs4):.3g} "
                  + ("of its largest value" if n == SGS else "(rel)")
                  + f"; kernel {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
                  f"{r['bound_ms'] / r['ms']:.3f} of the bound; plain "
                  f"{r['plain_ms']:.4f} ms")
    del lay, xi, xb, xs
    print(f"[sharded] state entries done at "
          f"{time.perf_counter() - t_phase:.1f} s into the phase")

    # -- the routes at S=2 and S=8 against the single card ---------------------
    def run(gd, route):
        eng = gd.engine
        kw = ROUTE_KW[route]
        with (routed(eng, kw["fused"], kw["screen"]) if kw
              else contextlib.nullcontext()):
            fn = route_trajectory(gd, route, sched, x_T)
            fn()                                  # warm-up (the capture)
            return fn, counted(fn)

    want_traj, one_fn = {}, {}
    for route in SHARD_ROUTES:
        gd = one["indexed" if route == "indexed" else "exact"]
        one_fn[route], (want_traj[route], _) = run(gd, route)
    sharded_counts, sel_err, step_err = {}, 0.0, 0.0
    for s in SHARDS:
        mesh = LocalMesh((s,), ("data",))
        gds = {"exact": GoldDiff(full, mesh=mesh),
               "indexed": GoldDiff(full, mesh=mesh, **ikw)}
        for route in SHARD_ROUTES:
            gd = gds["indexed" if route == "indexed" else "exact"]
            eng = gd.engine
            fn, (out, (c32, _)) = run(gd, route)
            err = float((out - want_traj[route]).abs().max())
            check(bool(torch.isfinite(out).all()) and err <= TRAJ_TOL,
                  f"[sharded] S={s} {route}: vs one card {err:.3g}")
            want = route_launches(names, route, eng, s)
            check(c32 == want, f"[sharded] S={s} {route} launches {c32}, "
                  f"expected {want}")
            if s == SHARDS[-1]:
                sharded_counts[route] = c32
            walls = {"one": [], "sharded": []}
            with (routed(eng, **ROUTE_KW[route]) if ROUTE_KW[route]
                  else contextlib.nullcontext()):
                oeng = one["indexed" if route == "indexed" else
                           "exact"].engine
                with (routed(oeng, **ROUTE_KW[route]) if ROUTE_KW[route]
                      else contextlib.nullcontext()):
                    for who in ("one", "sharded", "sharded", "one"):
                        walls[who].append(wall_ms(
                            one_fn[route] if who == "one" else fn, iters=3))
                    idle = {}
                    busy = {}
                    for who, f in (("one", one_fn[route]),
                                   ("sharded", fn)):
                        idle[who], busy[who] = profile_line(
                            f"[sharded] S={s} {route} ({who})",
                            min(walls[who]), f)
            print(f"[sharded] S={s} {route} trajectory (B={B}, {STEPS} "
                  f"steps, one x_T): vs one card max abs {err:.3g}; wall "
                  f"{min(walls['sharded']):.3f} ms (runs "
                  f"{[round(v, 3) for v in walls['sharded']]}) against "
                  f"{min(walls['one']):.3f} ms "
                  f"({min(walls['sharded']) / min(walls['one']):.3f}x), busy "
                  f"{busy['sharded']:.3f} against {busy['one']:.3f} ms, idle "
                  f"{idle['sharded']:.3f} against {idle['one']:.3f}; launches "
                  + ", ".join(f"{n} {v}" for n, v in c32.items() if v))
        # golden sets and single steps
        swaps, min_ov, tie_err = 0, 1.0, 0.0
        x64 = st.X.double()
        for t in (100, 500, 900):
            xt = (float(sched.a[t]) * st.X[:B] + float(sched.b[t])
                  * torch.randn(B, d, generator=torch.Generator()
                                .manual_seed(t)).to(dev))
            for kind in ("exact", "indexed"):
                e1, e0 = gds[kind].engine, one[kind].engine
                got, want = e1.select(xt, t), e0.select(xt, t)
                ov = overlap(got, want)
                nsw, ties = near_tie_swaps(
                    got, want, xt / float(sched.a[t]), st.X,
                    e0 if kind == "exact" else None, t)
                check(ov == 1.0 or ties, f"[sharded] S={s} {kind} select "
                      f"t={t}: overlap {ov}, {nsw} swaps not near ties")
                swaps += nsw
                min_ov = min(min_ov, ov)
                # the one-card staged step: the same kernel 2 distances
                e0 = one_staged[kind].engine
                q_t = xt / float(sched.a[t])
                allow = swap_allowance(got, want, q_t, x64,
                                       e0.constants(t)[1])
                for label, u, v in (
                        ("denoise", e1.denoise(xt, t), e0.denoise(xt, t)),
                        ("denoise_masked", e1.denoise_masked(xt, t),
                         e0.denoise_masked(xt, t))):
                    err = (u - v).abs().amax(-1).double().cpu()
                    check(bool((err <= allow).all()), f"[sharded] S={s} "
                          f"{kind} {label} t={t}: errors {err.tolist()}, "
                          f"allowed {allow.tolist()}")
                    same = allow == MEAN_ATOL
                    step_err = max(step_err, float(err[same].max())
                                   if same.any() else 0.0)
                    tie_err = max(tie_err, float(err.max()))
                if kind == "exact":
                    err = float((e1.full_scan(xt, t) - e0.full_scan(xt, t))
                                .abs().max())
                    check(err <= MEAN_ATOL, f"[sharded] S={s} full scan "
                          f"t={t}: {err:.3g}")
                    step_err = max(step_err, err)
        print(f"[sharded] S={s}: select at t in (100, 500, 900), exact and "
              f"indexed: overlap min {min_ov} ({swaps} rows swapped, each a "
              f"tie at a cut: at the k-th distance (kernel 2 splits D by "
              f"the rows it is given, so a shard sums a distance in another "
              f"order) or at the m-th proxy distance, where the cross-shard "
              f"threshold keeps every tied candidate); against the one-card"
              f" staged step, denoise and denoise_masked within {MEAN_ATOL} "
              f"on every query with no row tied at a cut, and full_scan "
              f"(max {step_err:.3g}); a query with tied rows within "
              f"MEAN_ATOL plus what those rows weigh (max {tie_err:.3g})")
        del x64
        # the plan: graph replay bit-equal to eager
        gd = gds["exact"]
        pln = build_plan(gd.engine, STEPS)
        eager = sample_plan(gd.call_masked, sched, (B, d), pln, x_init=x_T)
        graph = sample_plan(gd.call_masked, sched, (B, d), pln, x_init=x_T,
                            program_cache=gd.engine.program,
                            jitter=gd.engine.jitter)
        check(torch.equal(eager, graph), f"[sharded] S={s} plan: replay "
              f"differs from eager by "
              f"{float((eager - graph).abs().max()):.3g}")
        print(f"[sharded] S={s} plan: {pln.num_buckets} buckets, each "
              f"segment one CUDA graph of {s} slices; replay bit-equal to "
              f"eager; graphs captured {gd.engine._captures}")
        del gds

    # -- bf16 rows: the state entries' bf16 instances on the sharded path --------
    gd16 = GoldDiff(full, storage_dtype=BF16,
                    mesh=LocalMesh((SHARDS[-1],), ("data",)))
    bf16_counts = {}
    for route in ("staged", "full_scan"):
        _, (out, (c32, c16)) = run(gd16, route)
        check(c16[SGS if route == "staged" else SGA] == SHARDS[-1] * STEPS
              and not c32[SGS] and not c32[SGA]
              and bool(torch.isfinite(out).all()),
              f"[sharded] bf16 S={SHARDS[-1]} {route}: fp32 {c32}, bf16 "
              f"{c16}")
        bf16_counts[route] = c16
        print(f"[sharded] bf16 rows, S={SHARDS[-1]} {route}: bf16 launches "
              + ", ".join(f"{n} {v}" for n, v in c16.items() if v))
    del gd16

    # -- serving: plan mode on a sharded engine captures nothing after warmup
    srv = ServeEngine(st, num_steps=STEPS, max_batch=B, device=dev,
                      mesh=LocalMesh((SHARDS[-1],), ("data",)))
    wst = srv.warmup()
    c0, b0 = srv.engine._captures, srv.engine._builds
    t0 = time.perf_counter()
    served = srv.serve([Request(i, B, seed=300 + i) for i in range(2)])
    serve_s = time.perf_counter() - t0
    check(srv.engine._captures == c0 and srv.engine._builds == b0
          and all(np.isfinite(r.images).all() for r in served),
          f"[sharded] serve: {srv.engine._captures - c0} captures after "
          f"warmup")
    print(f"[sharded] ServeEngine(mesh=S={SHARDS[-1]}) plan mode: warmup "
          f"{wst['programs_compiled']} graphs in {wst['warmup_s']:.2f} s; 2 "
          f"waves of {B} in {serve_s * 1e3:.1f} ms, 0 captures and 0 builds "
          f"after warmup")
    del srv

    # -- the runtime over a sharded plan engine: a shard_drop storm ------------
    rsrv = ServeEngine(ctx["gmm"], num_steps=STEPS, max_batch=4, device=dev,
                       mesh=LocalMesh((SHARDS[-1],), ("data",)))
    rt = ServeRuntime(rsrv, RuntimeConfig(backoff_base_s=0.0,
                                          backoff_max_s=0.0, max_retries=50))
    rstats = rt.warmup()
    c0, b0 = rsrv.engine._captures, rsrv.engine._builds
    with injected(FaultConfig(seed=2, shard_drop_rate=0.3)) as inj:
        tickets = [rt.submit(Request(i, 1 + i % 4, seed=400 + i))
                   for i in range(6)]
        rt.run_until_idle()
    drops = sum(e[0] == "shard_drop" for e in inj.events)
    check(all(t_.status == "done" and np.isfinite(t_.images).all()
              for t_ in tickets) and drops > 0
          and rsrv.engine._captures == c0 and rsrv.engine._builds == b0,
          f"[sharded] runtime storm: {Counter(t_.status for t_ in tickets)},"
          f" {drops} drops, {rsrv.engine._captures - c0} captures")
    print(f"[sharded] ServeRuntime over a sharded plan engine (gmm N="
          f"{rsrv.store.n}, S={SHARDS[-1]}, n_loc "
          f"{rsrv.engine._layout.n_loc}; warmup {rstats['graphs_captured']}"
          f" graphs on slots {rstats['slots']}): shard_drop storm (rate 0.3)"
          f" {drops} drops, {rt.counters['retries']} retries, "
          f"{len(tickets)} tickets done and finite; 0 builds and 0 captures "
          f"after warmup")
    del rsrv, rt
    print(f"[sharded] phase {time.perf_counter() - t_phase:.1f} s")
    return res, {"fp32": sharded_counts, "bf16": bf16_counts}


PMESH_S = 2                # gloo ranks on the one card in [pmesh]
PMESH_JOIN_S = 300         # the ranks' whole run; a join past it fails
PMESH_PG_S = 120           # every process group's collective timeout
PMESH_MEM_SLACK = 1.05     # a rank's allocated bytes over its slab's
PMESH_LIB_BYTES = 64 << 20  # the libraries' fixed workspaces (cuBLAS's)
PMESH_TS = (100, 500, 900)  # the select checks' timesteps ([sharded]'s)
# the sources of the kernels the engine's routes launch, built before the
# ranks spawn so that they only load them
PMESH_SOURCES = ("pdist", "support_sqdist", "golden_support_aggregate",
                 "golden_aggregate", "screen_topm", "fused_candidates",
                 "centroid_scan")


def pmesh_xt(st, sched, t: int) -> torch.Tensor:
    """[sharded]'s noisy queries at t, on the store's device."""
    return (float(sched.a[t]) * st.X[:B] + float(sched.b[t])
            * torch.randn(B, st.dim, generator=torch.Generator()
                          .manual_seed(t)).to(st.device))


def slab_bytes(eng) -> int:
    """The bytes of a ProcessMesh rank's slab: its rows, norms, ids,
    window offsets and range, and the replicated centroid table."""
    return sum(t.numel() * t.element_size()
               for t in eng._layout.slabs[0] if isinstance(t, torch.Tensor))


def pmesh_workspace(*engines, batch: int = B,
                    lib: int = PMESH_LIB_BYTES) -> int:
    """The stated bound on what a rank's step of ``batch`` queries
    allocates on the card beyond its slabs, for the largest of
    ``engines``: 32 fp32 words a query for each of the shard's rows (the
    screen's distances, top-m keys and state, the re-rank's row maps and
    dot partials), 8 for each of the m_max candidates, one D-row for
    each SM (the aggregate's partial sums), and ``lib``, the libraries'
    fixed workspaces (0 where they were allocated before the reading:
    :func:`lib_warm`).  A step that held another shard's rows on the
    card (a lazy move, a whole-store gather) would pass it by those
    rows' bytes."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return max(4 * batch * (32 * e._layout.n_loc
                            + 8 * e.cfg.sizes(e.store.n)[1]
                            + sms * e.store.dim) for e in engines) + lib


# The fixed part of the allowance on a step's host bytes: a rank's
# resident anonymous + file bytes (``RssAnon + RssFile``, the allocator's
# free pages handed back first) may grow in one step (``open_slab``, the
# engines' construction, the Wiener rung, the runtime's warmup, the PCA
# caches; each from a reading just before it) by at most PMESH_MEM_SLACK
# x the bytes of the slabs it holds on the host (about 0 on a card rank:
# the slab is on the card), plus the small arrays that ``open_slab``
# reads whole, plus this (the step's own objects and the libraries'
# state for a new shape: cuDNN's for the PCA features, 24.6 MB on a gloo
# rank), plus the step's named terms: rank 0's PCA draws, and
# PMESH_GRAPH_HOST for each CUDA graph a runtime's warmup captures.  Set
# so that a whole read of the smaller epoch's rows (the cifar10 preset's,
# 160.2 MB) fails every step that captures no graph.
PMESH_HOST_FIXED = 48 << 20
# The host bytes a captured CUDA graph holds (CUDA's host copy of its
# nodes and the executable graph; the NCCL runtime's 85 graphs grew the
# process by 2.54-2.57 MB a graph in a [pmesh] run alone, 0.82 in the
# whole script)
PMESH_GRAPH_HOST = 3 << 20
PMESH_WARM_N = 2048        # rows of the in-memory store a gloo rank warms on
HOST_FIELDS = ("RssAnon", "RssFile", "VmRSS", "threads", "pinned", "heap")


def heap_rss() -> int | None:
    """The resident bytes of this process's ``[heap]`` (the C allocator's
    main arena: small allocations; a large buffer is a mapping of its
    own), from ``/proc/self/smaps``; None where it cannot be read."""
    try:
        with open("/proc/self/smaps") as f:
            heap = False
            for line in f:
                head = line.split(maxsplit=1)
                if head and "-" in head[0] and not head[0].endswith(":"):
                    heap = line.rstrip().endswith("[heap]")
                elif heap and line.startswith("Rss:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        return None
    return 0


def host_reading() -> dict:
    """This process's host memory (``repro_torch.utils.host_memory``,
    collected and trimmed first), with the trace that tells its parts
    apart: ``threads`` (each new thread's stack is touched), ``pinned``
    (the page-locked bytes the caching host allocator holds: the copies
    gloo makes of the card's tensors) and ``heap`` (``heap_rss``)."""
    from repro_torch.utils import host_memory
    gc.collect()
    m = host_memory()
    m["threads"] = len(os.listdir("/proc/self/task"))
    m["pinned"] = torch.cuda.host_memory_stats().get(
        "allocated_bytes.current", 0)
    m["heap"] = heap_rss()
    return m


class HostSteps:
    """A process's host readings step by step: the first at construction,
    ``mark()`` before a step, ``point(name, ...)`` after it (the next
    step's base).  A gated point holds the step's ``RssAnon + RssFile``
    delta to PMESH_MEM_SLACK x ``slab`` host bytes + ``small`` +
    PMESH_HOST_FIXED + ``extra`` + ``graphs`` x PMESH_GRAPH_HOST, and
    records ``whole``: the bytes of the rows whose whole read the bound
    must not let through.  Every point also keeps its delta since the
    first reading and each traced field's."""

    def __init__(self):
        self.first = self.last = host_reading()
        self.points = {}

    def mark(self) -> None:
        self.last = host_reading()

    def point(self, name: str, slab: int = 0, small: int = 0,
              extra: int = 0, graphs: int = 0, whole: int | None = None
              ) -> None:
        m = host_reading()
        rss = lambda r: r["RssAnon"] + r["RssFile"]
        q = {k: (None if m[k] is None or self.last[k] is None
                 else m[k] - self.last[k]) for k in HOST_FIELDS}
        q.update(delta=rss(m) - rss(self.last),
                 since_first=rss(m) - rss(self.first),
                 bound=None if whole is None else (
                     int(PMESH_MEM_SLACK * slab) + small + PMESH_HOST_FIXED
                     + extra + graphs * PMESH_GRAPH_HOST),
                 slab=slab, small=small, extra=extra, graphs=graphs,
                 whole=whole, hwm=m.get("VmHWM"))
        self.points[name] = q
        self.last = m


def host_slab(*engines) -> int:
    """The bytes of the engines' slabs that live on the host."""
    return sum(t.numel() * t.element_size() for e in engines
               for t in e._layout.slabs[0]
               if isinstance(t, torch.Tensor) and t.device.type == "cpu")


def host_gate(who: str, mem: dict) -> str:
    """Check every gated point of ``mem`` (``HostSteps.points``) against
    its bound, and that the bound's slack is below the rows it names
    (a whole read of them fails it); the line [pmesh] prints (MB: 1e6
    bytes; the ungated steps are the one-time costs of a process's first
    full-size run, shown with their trace)."""
    mb = lambda v: "not measured" if v is None else f"{v / 1e6:.1f}"
    out = []
    for name, q in mem.items():
        trace = (f"anon {mb(q['RssAnon'])}, file {mb(q['RssFile'])}; heap "
                 f"{mb(q['heap'])}, pinned {mb(q['pinned'])}, threads "
                 f"{q['threads']:+d}; since the first reading "
                 f"{mb(q['since_first'])}")
        if q["bound"] is None:
            out.append(f"{name} {mb(q['delta'])} MB, not gated ({trace})")
            continue
        check(q["delta"] <= q["bound"], f"[pmesh] {who} host bytes in "
              f"{name}: RssAnon + RssFile grew {q['delta']}, over the bound "
              f"{q['bound']} ({q})")
        slack = q["bound"] - q["delta"]
        check(slack < q["whole"], f"[pmesh] {who} {name}: the bound's slack "
              f"{slack} would let a whole read of {q['whole']} bytes of "
              f"rows through")
        out.append(
            f"{name} {mb(q['delta'])} MB ({trace}; bound {mb(q['bound'])} = "
            f"slab {mb(q['slab'])} x {PMESH_MEM_SLACK} + small "
            f"{mb(q['small'])} + fixed {mb(PMESH_HOST_FIXED)}"
            + (f" + draws {mb(q['extra'])}" if q["extra"] else "")
            + (f" + {q['graphs']} graphs x {mb(PMESH_GRAPH_HOST)}"
               if q["graphs"] else "")
            + f"; slack {mb(slack)} < whole rows {mb(q['whole'])}"
            + ("" if q["hwm"] is None else f"; peak {mb(q['hwm'])}") + ")")
    return "; ".join(out)


def pca_draw_bytes(gd, timesteps) -> int:
    """The rows the host channel's first rank reads to fit a PCA base's
    bases for ``timesteps`` (its largest fit: the distinct rows drawn)."""
    b = gd.base
    if b.name != "pca" or b._mesh.host_rank != 0:
        return 0
    return max(np.unique(b.fit_draws(b.patch_size(int(t)))[0]).size
               for t in timesteps) * b.store.dim * 4


def lib_warm() -> None:
    """Allocate the libraries' fixed workspaces for the current stream
    (cuBLAS's and cuBLASLt's: a product, a batched product and an addmm)
    before a bytes reading, so that they fall in what the reading starts
    from rather than in what it measures."""
    a = torch.ones(8, 8, device="cuda")
    torch.mm(a, a)
    torch.bmm(a[None], a[None])
    torch.addmm(a, a, a)
    torch.cuda.synchronize()


def patch_support_bytes(gd, batch: int) -> tuple[int, int]:
    """The stated bound on a patch base's transients in one GoldDiff step
    of ``batch`` queries over a ProcessMesh, as (bound, u): with u = 4 *
    batch * k_max * H * W bytes (one fp32 plane of the gathered
    support), the gather's three live copies of the [b, k, H, W, C + F]
    support (the per-value gathers, their masked concatenation, the
    all-reduce's buffer; F the PCA rank, 0 for the Kamb base, whose
    features are its rows) and one plane more.  What follows the gather
    holds one copy: the distances' two [b, k, H, W, F'] temporaries (F'
    = F, or C for the Kamb base), the [b, k, H, W] logits and weights
    and the weighted sum's [b, k, H, W, C] copy fit the same bound."""
    b = gd.base
    feat = b.feature_dim if b.name == "pca" else 0
    k_max = gd.engine.cfg.sizes(gd.engine.store.n)[3]
    u = 4 * batch * k_max * b.h * b.w
    return u * (3 * (b.c + feat) + 1), u


def pmesh_peak(held: int, engines, what: str) -> dict:
    """The card's peak allocated bytes since the last reset against
    ``held`` (allocated at the reset) plus :func:`pmesh_workspace`."""
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    bound = pmesh_workspace(*engines)
    check(peak <= held + bound, f"[pmesh] {what}: peak {peak} bytes "
          f"allocated, over the {held} held plus the workspace bound "
          f"{bound}")
    return {"held": held, "peak": peak, "bound": bound}


def reset_peak() -> int:
    """The card's allocated bytes, the peak reset to them."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def counted_launches(fn) -> tuple:
    """``fn()`` between the card's synchronizations, every wrapper's
    count set to 0 just before it: its output and the fp32 counts."""
    from repro_torch.kernels import ops
    for k in ops.COUNTED:
        k.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in ops.COUNTED}


def pmesh_engines(full, mesh, ikw) -> dict:
    """The exact and indexed GoldDiff over ``mesh``, each with its
    allocated bytes on the card after construction and its slab's."""
    from repro_torch.core import GoldDiff
    out = {}
    for kind, kw in (("exact", {}), ("indexed", ikw)):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        gd = GoldDiff(full, mesh=mesh, **kw)
        torch.cuda.synchronize()
        out[kind] = (gd, torch.cuda.memory_allocated() - m0,
                     slab_bytes(gd.engine))
    return out


PMESH_PATCH_B = 4          # queries of the patch bases' trajectories
# the cifar10 preset's epoch: windows of its widest cluster and one spare,
# so that its capacity padding stays near 1.5x its 8192 rows
PMESH_PATCH_INGEST = dict(slack=1.0, spare_frac=0.01)
PMESH_RCFG = dict(max_queue=64, backoff_base_s=0.001, backoff_max_s=0.01,
                  breaker_cooldown_s=0.5)          # [runtime]'s settings
PMESH_FAULTS = dict(seed=3, nan_rate=0.05, error_rate=0.05, oom_rate=0.03,
                    evict_rate=0.02)               # [runtime]'s ladder


def pmesh_traffic(rt, seed0: int) -> tuple:
    """[runtime]'s clean traffic through ``rt``: LIVE_REQS requests of 1-4
    images (request ids and seeds from ``seed0``), two arriving a
    scheduler step, then drained; over ranks rank 0 submits and the
    others replay.  Returns this rank's tickets in order and the wall
    seconds."""
    from repro_torch.launch.serve import Request
    sizes = np.random.default_rng(1).integers(1, 5, LIVE_REQS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, n in enumerate(sizes):
        if rt.front:
            rt.submit(Request(seed0 + i, int(n), seed=seed0 + i))
        if i % 2:
            rt.pump()
    rt.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [rt.ticket(seed0 + i) for i in range(LIVE_REQS)], wall


def pmesh_record(rt, tickets, wall: float) -> dict:
    """What the ranks must agree on (statuses, degraded flags, counters,
    breaker states, the images) and this rank's own timing."""
    h = rt.health()
    lat = np.array([t.latency_s or 0.0 for t in tickets]) * 1e3
    n_img = sum(t.request.num_images for t in tickets)
    return {"status": [t.status for t in tickets],
            "degraded": [bool(t.degraded) for t in tickets],
            "counters": dict(rt.counters),
            "breakers": {k: h[k] for k in h if k.startswith("breaker_")},
            "images": torch.from_numpy(np.concatenate(
                [t.images.reshape(t.images.shape[0], -1) for t in tickets
                 if t.images is not None])),
            "wall_s": wall, "images_per_s": n_img / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


HOST_CALLS = ("host_broadcast", "host_float", "host_max", "host_sum")


@contextlib.contextmanager
def runtime_probe(rt):
    """Count and time on the host clock what ``rt`` does while the block
    runs: its pumps, its segments (``_run_segment``, which ends in the
    output's copy to the host, so the card is synchronized) and every
    host-channel collective of a ``ProcessMesh`` (``host_any`` counts as
    the ``host_max`` it makes).  Yields the dict it fills: ``{"pump": [n,
    s], "segment": [n, s], "host": {call: [n, s]}}``."""
    from repro_torch.distributed import ProcessMesh
    got = {"pump": [0, 0.0], "segment": [0, 0.0],
           "host": {k: [0, 0.0] for k in HOST_CALLS}}

    def timed(fn, slot):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                slot[0] += 1
                slot[1] += time.perf_counter() - t0
        return wrapped

    saved = {k: getattr(ProcessMesh, k) for k in HOST_CALLS}
    for k in HOST_CALLS:
        setattr(ProcessMesh, k, timed(saved[k], got["host"][k]))
    rt.pump = timed(rt.pump, got["pump"])
    rt._run_segment = timed(rt._run_segment, got["segment"])
    try:
        yield got
    finally:
        for k, f in saved.items():
            setattr(ProcessMesh, k, f)
        del rt.pump, rt._run_segment


def probe_line(got: dict, wall: float) -> str:
    """A probed traffic run's pumps, segments and host-channel calls
    against its wall seconds, as [pmesh] prints them."""
    (np_, _), (ns, ss) = got["pump"], got["segment"]
    nh = sum(n for n, _ in got["host"].values())
    sh = sum(t for _, t in got["host"].values())
    return (f"{np_} pumps, {ns} segments taking {ss * 1e3:.1f} ms with "
            f"the host calls they make ({ss / wall:.3f} of the "
            f"{wall * 1e3:.1f} ms wall); "
            f"host channel {nh} calls ({nh / max(np_, 1):.2f} a pump: "
            + ", ".join(f"{k} {n} in {t * 1e3:.2f} ms"
                        for k, (n, t) in got["host"].items() if n)
            + f"), {sh * 1e3:.2f} ms ({sh / wall:.3f} of the wall, "
            f"{sh / max(nh, 1) * 1e6:.1f} us a call)")


def wiener_bytes(w) -> int:
    return sum(t.numel() * t.element_size() for t in (w.mu, w.V, w.lam))


def pmesh_runtime(mesh, host, sched, inject: bool, on_point=None) -> tuple:
    """``ServeRuntime`` over ``ServeEngine(mesh=mesh)`` on the card: the
    Wiener rung from the slabs' sums (its seconds), warmup (graphs on
    NCCL), the bytes it holds after warmup against slab + Wiener rung +
    ``pmesh_workspace`` (each term; ``on_point(name, engine, graphs)``
    takes the host's readings after the Wiener rung (with the
    construction) and after warmup, with the CUDA graphs each step
    captured), [runtime]'s
    clean traffic (nothing built or captured after warmup), then the fault ladder on a second runtime with
    PMESH_FAULTS installed where ``inject``.  Returns the results and the
    first runtime."""
    import contextlib

    from repro_torch.launch.faults import FaultConfig, injected
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import ServeEngine
    base = reset_peak()
    srv = ServeEngine(host, num_steps=STEPS, max_batch=B, mesh=mesh)
    eng = srv.engine
    rt = ServeRuntime(srv, RuntimeConfig(**PMESH_RCFG))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt._wiener_den()
    wiener_s = time.perf_counter() - t0
    if on_point is not None:
        on_point("Wiener rung", eng, 0)
    stats = rt.warmup()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    terms = {"slab": slab_bytes(eng), "Wiener rung": wiener_bytes(rt._wiener),
             "workspace bound": pmesh_workspace(eng)}
    check(held <= sum(terms.values()), f"[pmesh] runtime on {mesh}: {held} "
          f"bytes held after warmup, over {terms}")
    if on_point is not None:
        on_point("runtime warmup", eng, stats["graphs_captured"])
    c0, b0 = eng._captures, eng._builds
    with runtime_probe(rt) as probe:
        tickets, wall = pmesh_traffic(rt, 0)
    check(eng._captures == c0 and eng._builds == b0
          and all(t.status == "done" for t in tickets),
          f"[pmesh] runtime on {mesh}: {eng._captures - c0} captures, "
          f"{eng._builds - b0} builds after warmup; statuses "
          f"{Counter(t.status for t in tickets)}")
    out = {"wiener_s": wiener_s, "graphs": stats["graphs_captured"],
           "warmup_s": stats["runtime_warmup_s"], "held": held,
           "terms": terms, "clean": pmesh_record(rt, tickets, wall),
           "probe": probe_line(probe, wall)}
    lad = ServeRuntime(srv, RuntimeConfig(breaker_threshold=1, **PMESH_RCFG))
    lad._wiener = rt._wiener             # the same statistics, computed once
    lad.warmup()
    with (injected(FaultConfig(**PMESH_FAULTS)) if inject
          else contextlib.nullcontext()):
        tickets, wall = pmesh_traffic(lad, 5000)
    check(all(t.status == "done" and np.isfinite(t.images).all()
              for t in tickets), f"[pmesh] fault ladder on {mesh}: "
          f"{Counter(t.status for t in tickets)}")
    out["faults"] = pmesh_record(lad, tickets, wall)
    return out, rt


def pmesh_patches(mesh, pst, sched, x_P, on_caches=None) -> dict:
    """GoldDiff over the PCA and the Kamb base on ``mesh`` (the preset
    store ``pst`` on the host): the bytes held after the PCA caches
    (slab, slot map, feature cache, ``pmesh_workspace`` for the served
    batch; each term), that allowance against another shard's rows, the
    static trajectory from ``x_P`` (counted: every wrapper's launches)
    with its peak against what it held plus ``patch_support_bytes`` and
    the step workspace, and its wall.  The libraries' workspaces are
    allocated first (``lib_warm``), so neither bound carries them.
    ``on_caches(name, gd, timesteps)`` takes the host's reading after
    each base's caches."""
    from repro_torch.core import (GoldDiff, make_denoiser, sample,
                                  sampling_timesteps)
    out = {}
    b = x_P.shape[0]
    for name in ("pca", "kamb"):
        lib_warm()
        base = reset_peak()
        gd = GoldDiff(make_denoiser(name, pst, sched, device="cpu"),
                      mesh=mesh)
        ts = sampling_timesteps(sched, STEPS)[:-1]
        cache = gd.base.build_caches(ts)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        if on_caches is not None:
            on_caches(name, gd, ts)
        ws = pmesh_workspace(gd.engine, batch=b, lib=0)
        terms = {"slab": slab_bytes(gd.engine),
                 "slot map": gd.base._slots.numel() * 4,
                 "feature cache": cache, "workspace bound": ws}
        check(held <= sum(terms.values()), f"[pmesh] {name} on {mesh}: "
              f"{held} bytes held after the caches, over {terms}")
        # another shard's fp32 rows: what a whole-store copy would add
        other = (gd.engine._layout.n_loc * pst.dim * 4
                 if gd.engine.n_shards > 1 else None)
        check(other is None or 2 * ws <= other, f"[pmesh] {name} on "
              f"{mesh}: the allowance {ws} is not well below another "
              f"shard's rows {other}")
        fn = lambda: sample(gd, sched, tuple(x_P.shape), num_steps=STEPS,
                            x_init=x_P)
        fn()                            # builds the kernels' first shapes
        held_t = reset_peak()
        traj, counts = counted_launches(fn)
        peak = torch.cuda.max_memory_allocated()
        sup, plane = patch_support_bytes(gd, b)
        check(peak <= held_t + sup + ws, f"[pmesh] {name} on {mesh}: the "
              f"trajectory's peak {peak} bytes over the {held_t} held plus "
              f"the support bound {sup} and the workspace bound {ws}")
        # the slack over the gather's three copies, which a copy of
        # another shard's rows during the step would pass
        check(other is None or 2 * (plane + ws) <= other, f"[pmesh] {name} "
              f"on {mesh}: the trajectory's slack {plane + ws} is not well "
              f"below another shard's rows {other}")
        out[name] = {"traj": traj.cpu(), "wall_ms": wall_once(fn),
                     "held": held, "terms": terms, "other": other,
                     "peak": {"held": held_t, "peak": peak, "support": sup,
                              "workspace": ws, "slack": plane + ws},
                     "launches": {n: v for n, v in counts.items() if v}}
        del gd, fn
    return out


def patch_mem_line(q: dict) -> str:
    """A patch base's bytes, as [pmesh] prints them."""
    pk = q["peak"]
    return (f"held after the caches {q['held']} <= " + " + ".join(
        f"{k} {v}" for k, v in q["terms"].items())
        + ("" if q["other"] is None else
           f" (another shard's rows {q['other']})")
        + f"; trajectory peak {pk['peak']}, {pk['peak'] - pk['held']} over "
        f"the {pk['held']} held <= support bound {pk['support']} + "
        f"workspace bound {pk['workspace']} (slack over the gather's three "
        f"copies {pk['slack']})")


def wall_once(fn) -> float:
    """The host wall ms of one warm call of ``fn``, the card synchronized
    at both ends (a trajectory that takes a second over gloo)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def pmesh_warm(mesh, sched, kw: dict) -> None:
    """A gloo rank's entry points once over an in-memory cifar_like store
    of PMESH_WARM_N rows, before its first host reading: every route
    (every kernel loaded), a select, a runtime's warmup and the patch
    bases' caches and two steps, so that the libraries' code pages a
    first call faults in, the kernels' modules and the interpreter's
    lazy state lie in the baseline and the readings count what the
    epochs' slabs bring.  Also the device rule's check: a gloo mesh given
    no device lays a card store out on the card (its devices)."""
    from repro_torch.core import (GoldDiff, OptimalDenoiser, make_denoiser,
                                  sample, sampling_timesteps)
    from repro_torch.data import make_dataset
    from repro_torch.distributed import ProcessMesh
    from repro_torch.index import build_index
    from repro_torch.index.shard import shard_layout
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import ServeEngine
    small = make_dataset("cifar_like", n=PMESH_WARM_N, seed=2, device="cpu")
    bare = shard_layout(small.to("cuda"), ProcessMesh("data"), "data")
    devices = (str(mesh.device), str(bare.X.device),
               str(bare.slabs[0].X.device))
    del bare
    x = torch.randn(B, small.dim,
                    generator=torch.Generator().manual_seed(3)).cuda()
    full = OptimalDenoiser(small, sched, device="cpu")
    gds = {"exact": GoldDiff(full, mesh=mesh),
           "indexed": GoldDiff(full, mesh=mesh, cfg=kw["cfg"],
                               index=build_index(small),
                               probe_schedule=kw["probes"])}
    for route in SHARD_ROUTES:
        gd = gds["indexed" if route == "indexed" else "exact"]
        rk = ROUTE_KW[route]
        with (routed(gd.engine, rk["fused"], rk["screen"]) if rk
              else contextlib.nullcontext()):
            route_trajectory(gd, route, sched, x)()
        gd.engine.select(x, PMESH_TS[0])
    ServeRuntime(ServeEngine(small, num_steps=STEPS, max_batch=B, mesh=mesh),
                 RuntimeConfig(**PMESH_RCFG)).warmup()
    for name in ("pca", "kamb"):
        lib_warm()
        gd = GoldDiff(make_denoiser(name, small, sched, device="cpu"),
                      mesh=mesh)
        gd.base.build_caches(sampling_timesteps(sched, STEPS)[:-1])
        sample(gd, sched, (PMESH_PATCH_B, small.dim), num_steps=2,
               x_init=x[:PMESH_PATCH_B])
    torch.cuda.synchronize()
    del gds, full, gd
    return devices


def pmesh_rank(rank: int, world: int, port: int, pdir: str, kw: dict
               ) -> None:
    """One gloo rank of [pmesh] on the card: it warms its entry points on
    a small store (``pmesh_warm``) and takes its first host reading, opens
    [lifecycle]'s committed cifar_like epoch and the cifar10 preset's
    epoch by slab (``StoreLifecycle.open_slab``), builds the exact and
    indexed engines over a ProcessMesh of ``world`` (their bytes on the
    card after construction), runs every route's trajectory from x_T
    counted alone and timed, ``select`` at PMESH_TS, the serving runtime
    and the patch bases, with host readings step by step (``HostSteps``:
    the opens, the engines, the Wiener rung, the runtime's warmup and the
    PCA caches gated, each against its whole rows: the preset's; the
    routes and the runtime's traffic recorded); all written to
    ``pdir/rank<r>.pt`` for the parent to check."""
    import datetime

    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import OptimalDenoiser, make_schedule
    from repro_torch.index import StoreLifecycle
    from repro_torch.launch.mesh import make_process_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=PMESH_PG_S))
    try:
        inp = torch.load(Path(pdir) / "inputs.pt")
        sched = make_schedule("ddpm_linear", 1000)
        x_T = inp["x_T"].cuda()
        # the default device under gloo: the card (LOCAL_RANK's, else
        # the rank's, modulo the one card)
        mesh = make_process_mesh((world,), ("data",))
        # gloo takes the card's tensors as they are (the merges' calls)
        r = torch.full((4,), float(rank + 1), device="cuda")
        dist.all_reduce(r)
        g = torch.empty(4 * world, device="cuda")
        dist.all_gather_into_tensor(g, torch.full((4,), float(rank),
                                                  device="cuda"))
        c = torch.full((2,), float(rank), device="cuda", dtype=torch.float64)
        dist.broadcast(c, src=0)
        probe = (bool((r == world * (world + 1) / 2).all())
                 and g.cpu().tolist() == [float(i) for i in range(world)
                                          for _ in range(4)]
                 and bool((c == 0).all()))
        t0 = time.perf_counter()
        devices = pmesh_warm(mesh, sched, kw)
        warm_s = time.perf_counter() - t0
        hs = HostSteps()
        t0 = time.perf_counter()
        ep = StoreLifecycle.open_slab(kw["root"], mesh)
        pep = StoreLifecycle.open_slab(kw["patch_root"], mesh)
        open_s = time.perf_counter() - t0
        (st, ix), (pst, _) = ep, pep
        small = ep.small_bytes + pep.small_bytes
        # a whole read of the preset's rows (the smaller epoch) must fail
        # every gated step
        whole = pst.X.numel() * pst.X.element_size()
        hs.point("open_slab", 0, small, whole=whole)
        gds = pmesh_engines(OptimalDenoiser(st, sched, device="cpu"), mesh,
                            dict(cfg=kw["cfg"], index=ix,
                                 probe_schedule=kw["probes"]))
        hs.point("engines", host_slab(*(gd.engine for gd, _, _ in
                                        gds.values())), small, whole=whole)
        res = {"probe": probe, "mem": {k: v[1:] for k, v in gds.items()},
               "traj": {}, "counts": {}, "want": {}, "wall": {}, "select": {},
               "devices": devices, "warm_s": warm_s, "open_s": open_s,
               "host": hs.points}
        held = reset_peak()
        for route in SHARD_ROUTES:
            eng = gds["indexed" if route == "indexed" else "exact"][0].engine
            rk = ROUTE_KW[route]
            with (routed(eng, rk["fused"], rk["screen"]) if rk
                  else contextlib.nullcontext()):
                fn = route_trajectory(gds["indexed" if route == "indexed"
                                          else "exact"][0], route, sched,
                                      x_T)
                fn()                                      # warm-up
                out, res["counts"][route] = counted_launches(fn)
                res["wall"][route] = wall_ms(fn, iters=3)
            res["traj"][route] = out.cpu()
            res["want"][route] = route_launches(list(res["counts"][route]),
                                                route, eng, 1)
        for t in PMESH_TS:
            xt = inp["x_sel"][t].cuda()
            for kind, (gd, _, _) in gds.items():
                res["select"][kind, t] = gd.engine.select(xt, t).cpu()
        res["peak"] = pmesh_peak(held, [gd.engine for gd, _, _ in
                                        gds.values()],
                                 f"rank {rank}'s routes and selects")
        del gds
        hs.point("routes and selects")

        def on_point(name, eng, graphs):
            hs.point(name, host_slab(eng), small, graphs=graphs, whole=whole)

        # the serving runtime over the ranks, faults on rank 1 alone
        res["runtime"], _ = pmesh_runtime(mesh, st, sched, inject=rank == 1,
                                          on_point=on_point)
        hs.point("runtime traffic and faults")

        def on_caches(name, gd, ts):
            if name == "pca":
                hs.point("PCA caches", host_slab(gd.engine), small,
                         pca_draw_bytes(gd, ts), whole=whole)

        res["patch"] = pmesh_patches(mesh, pst, sched, x_T[:PMESH_PATCH_B],
                                     on_caches)
        torch.save(res, Path(pdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def pmesh_nccl(ctx: dict, roots: dict, want: dict, one: dict, est, x_P,
               patch_want: dict) -> tuple:
    """[pmesh]'s one-rank NCCL ProcessMesh in this process (the group is
    the caller's): its bytes after construction, every route against
    the one card (the plan on CUDA graphs that hold the NCCL
    collectives, bit-equal to the plan run eagerly), the plan's wall,
    busy and idle share in turns with the one-card plan and a LocalMesh
    of 1, the collectives' device time a step, and a plan-mode
    ServeEngine over the mesh capturing and building nothing after
    warmup().  Then ``ServeRuntime`` over a ServeEngine on the mesh
    (``pmesh_runtime``): its clean traffic against the one-card runtime's
    on the same requests (TRAJ_TOL), images/s and p50/p99 in turns with
    it, the path's launches, the fault ladder; and GoldDiff over the PCA
    and Kamb bases (``pmesh_patches``) against one card.  The rank opens
    the two epochs by slab (``roots``); this process also holds the
    one-card references (``one``, over the epoch's card view ``est``), so
    its host readings are its own steps' deltas: the opens and the
    engines from a reading just before them, the runtime's warmup and
    the PCA caches each from one just before its own step.  Returns the
    path's counts and the one-card runtime's clean deliveries."""
    from repro_torch.core import (GoldDiff, OptimalDenoiser, build_plan,
                                  sample_plan)
    from repro_torch.distributed import LocalMesh
    from repro_torch.index import StoreLifecycle
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.serve import Request, ServeEngine
    sched, x_T = ctx["sched"], ctx["x_T"]
    mesh = make_process_mesh()
    check(mesh.backend == "nccl" and mesh.device.type == "cuda"
          and mesh.capturable("data", mesh.device),
          f"[pmesh] the one-rank mesh {mesh}")
    hs = HostSteps()
    ep = StoreLifecycle.open_slab(roots["root"], mesh)
    pep = StoreLifecycle.open_slab(roots["patch_root"], mesh)
    (host, hix), (pst, _) = ep, pep
    small = ep.small_bytes + pep.small_bytes
    # a whole read of the preset's rows must fail a step that captures no
    # graph; of the cifar_like epoch's, the runtime's warmup (its graphs)
    whole = {0: pst.X.numel() * pst.X.element_size(),
             1: host.X.numel() * host.X.element_size()}
    hs.point("open_slab", 0, small, whole=whole[0])
    ikw = dict(cfg=ctx["indexed_cfg"], index=hix,
               probe_schedule=ctx["probes"])
    gds = pmesh_engines(OptimalDenoiser(host, sched, device="cpu"), mesh,
                        ikw)
    hs.point("engines", host_slab(*(gd.engine for gd, _, _ in gds.values())),
             small, whole=whole[0])
    for kind, (gd, mem, slab) in gds.items():
        check(mem <= PMESH_MEM_SLACK * slab, f"[pmesh] nccl {kind}: "
              f"{mem} bytes allocated after construction, slab {slab}")
        print(f"[pmesh] nccl S=1 {kind} engine: {mem} bytes allocated on "
              f"the card after construction, its slab {slab} bytes "
              f"({mem / slab:.4f}x; the store's rows "
              f"{host.X.numel() * 4} bytes)")
    names = [k.__name__ for k in ops.COUNTED]
    counts, fns = {}, {}
    held = reset_peak()
    for route in SHARD_ROUTES:
        gd = gds["indexed" if route == "indexed" else "exact"][0]
        rk = ROUTE_KW[route]
        with (routed(gd.engine, rk["fused"], rk["screen"]) if rk
              else contextlib.nullcontext()):
            fns[route] = fn = route_trajectory(gd, route, sched, x_T)
            fn()                                  # warm-up (the capture)
            out, counts[route] = counted_launches(fn)
        err = float((out - want[route]).abs().max())
        check(bool(torch.isfinite(out).all()) and err <= TRAJ_TOL,
              f"[pmesh] nccl S=1 {route}: vs one card {err:.3g}")
        exp = route_launches(names, route, gd.engine, 1)
        check(counts[route] == exp, f"[pmesh] nccl S=1 {route} launches "
              f"{counts[route]}, expected {exp}")
        print(f"[pmesh] nccl S=1 {route} trajectory: vs one card max abs "
              f"{err:.3g}; launches " + ", ".join(
                  f"{n} {v}" for n, v in counts[route].items() if v))
    gd = gds["exact"][0]
    pln = build_plan(gd.engine, STEPS)
    eager = sample_plan(gd.call_masked, sched, tuple(x_T.shape), pln,
                        x_init=x_T)
    graph = fns["plan"]()
    check(torch.equal(eager, graph) and gd.engine._captures > 0,
          f"[pmesh] nccl plan: replay differs from eager by "
          f"{float((eager - graph).abs().max()):.3g} "
          f"({gd.engine._captures} graphs)")
    print(f"[pmesh] nccl S=1 plan: {pln.num_buckets} buckets, "
          f"{gd.engine._captures} CUDA graphs holding the NCCL collectives; "
          f"replay bit-equal to eager")
    pk = pmesh_peak(held, [g.engine for g, _, _ in gds.values()],
                    "the nccl rank's routes and plan capture")
    print(f"[pmesh] nccl S=1 routes, plan eager and captured: peak "
          f"{pk['peak']} bytes allocated on the card, {pk['peak'] - held} "
          f"over the {held} held after construction (workspace bound "
          f"{pk['bound']})")
    # the plan in turns: the one card, the NCCL rank, a LocalMesh of 1
    loc = GoldDiff(one["exact"].base, mesh=LocalMesh((1,), ("data",)))
    plans = {"one card": route_trajectory(one["exact"], "plan", sched, x_T),
             "nccl S=1": fns["plan"],
             "LocalMesh S=1": route_trajectory(loc, "plan", sched, x_T)}
    walls = {k: [] for k in plans}
    for who in ("one card", "nccl S=1", "LocalMesh S=1", "LocalMesh S=1",
                "nccl S=1", "one card"):
        walls[who].append(wall_ms(plans[who], iters=5))
    for who, fn in plans.items():
        idle, busy = profile_line(f"[pmesh] plan ({who})", min(walls[who]),
                                  fn)
        print(f"[pmesh] plan trajectory ({who}; B={B}, {STEPS} steps, "
              f"CUDA graphs): walls {[round(w, 3) for w in walls[who]]} ms, "
              f"busy {busy:.3f} ms, idle share {idle:.3f}")
    # the collectives' device time: the plan run eagerly under the
    # profiler, each c10d collective's device work attributed to its op
    with device_profile(cpu=True) as prof:
        sample_plan(gd.call_masked, sched, tuple(x_T.shape), pln, x_init=x_T)
        torch.cuda.synchronize()
    coll = [(e.key, e.count, e.device_time_total / 1e3)
            for e in prof.key_averages() if e.key.startswith("c10d::")]
    coll_ms = sum(ms for _, _, ms in coll)
    check(coll and coll_ms > 0, f"[pmesh] the eager nccl plan's profile "
          f"shows no collective's device time: {coll}")
    print(f"[pmesh] nccl S=1 plan run eagerly: the collectives' device time "
          f"{coll_ms / STEPS:.4f} ms a step (" + ", ".join(
              f"{k} x{n} {ms:.4f} ms" for k, n, ms in coll)
          + f" in {STEPS} steps)")
    # serving over the mesh: warmup captures, serving captures nothing
    srv = ServeEngine(host, num_steps=STEPS, max_batch=B, mesh=mesh)
    held = reset_peak()
    wst = srv.warmup()
    c0, b0 = srv.engine._captures, srv.engine._builds
    t0 = time.perf_counter()
    served = srv.serve([Request(i, B, seed=300 + i) for i in range(2)])
    serve_s = time.perf_counter() - t0
    check(srv.engine._captures == c0 and srv.engine._builds == b0
          and c0 > 0 and all(np.isfinite(r.images).all() for r in served),
          f"[pmesh] nccl serve: {c0} graphs at warmup, "
          f"{srv.engine._captures - c0} captures and "
          f"{srv.engine._builds - b0} builds after")
    pk = pmesh_peak(held, [srv.engine], "the nccl ServeEngine's warmup and "
                    "serve")
    print(f"[pmesh] ServeEngine(mesh=nccl S=1) plan mode: warmup "
          f"{wst['programs_compiled']} graphs in {wst['warmup_s']:.2f} s; 2 "
          f"waves of {B} in {serve_s * 1e3:.1f} ms, 0 captures and 0 builds "
          f"after warmup; peak {pk['peak']} bytes allocated on the card, "
          f"{pk['peak'] - held} over the {held} held after construction "
          f"(workspace bound {pk['bound']})")
    del srv, gds, fns, plans, loc
    gc.collect()
    # -- the serving runtime over the NCCL rank ------------------------------
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    hs.mark()
    rt_res, rt = pmesh_runtime(
        mesh, host, sched, inject=True, on_point=lambda name, eng, graphs:
        hs.point(name, host_slab(eng), graphs=graphs,
                 whole=whole[bool(graphs)]))
    print(f"[pmesh] nccl S=1 runtime: warmup {rt_res['graphs']} CUDA graphs "
          f"in {rt_res['warmup_s']:.2f} s after {rt_res['wiener_s']:.2f} s "
          f"for the Wiener rung from the slab's sums; held after warmup "
          f"{rt_res['held']} bytes <= " + " + ".join(
              f"{k} {v}" for k, v in rt_res["terms"].items())
          + f"; clean traffic ({LIVE_REQS} requests, 1-4 images, two a "
          f"step): 0 captures and 0 builds after warmup")
    one_srv = ServeEngine(est, num_steps=STEPS, max_batch=B)
    one_rt = ServeRuntime(one_srv, RuntimeConfig(**PMESH_RCFG))
    one_rt._wiener = rt._wiener          # the same statistics, on this card
    one_rt.warmup()
    recs = {"nccl S=1": [], "one card": []}
    for who in ("nccl S=1", "one card", "one card", "nccl S=1"):
        r_ = rt if who == "nccl S=1" else one_rt
        recs[who].append(pmesh_record(r_, *pmesh_traffic(r_, 0)))
    one_clean = recs["one card"][0]["images"]
    err = float((recs["nccl S=1"][0]["images"] - one_clean).abs().max())
    check(err <= TRAJ_TOL, f"[pmesh] nccl runtime clean deliveries vs the "
          f"one-card runtime's {err:.3g}")
    for who, rs in recs.items():
        print(f"[pmesh] runtime clean traffic in turns ({who}): " + "; ".join(
            f"{r_['images_per_s']:.1f} images/s, p50 {r_['p50_ms']:.1f} ms, "
            f"p99 {r_['p99_ms']:.1f} ms" for r_ in rs)
            + (f"; deliveries vs the one-card runtime's max abs {err:.3g}"
               if who == "nccl S=1" else ""))
    # where the runtime's time goes: its segments and its host channel,
    # the NCCL rank's from its first clean run, one card's probed here
    with runtime_probe(one_rt) as probe:
        _, wall1 = pmesh_traffic(one_rt, 0)
    print(f"[pmesh] runtime clean traffic probed (host clock): nccl S=1 "
          f"{rt_res['probe']}; one card {probe_line(probe, wall1)}")
    (_, _), counts["runtime"] = counted_launches(
        lambda: pmesh_traffic(rt, 0))
    print(f"[pmesh] nccl S=1 runtime clean traffic launches: " + ", ".join(
        f"{n} {v}" for n, v in counts["runtime"].items() if v))
    rf = rt_res["faults"]
    print(f"[pmesh] nccl S=1 fault ladder ({PMESH_FAULTS}): "
          f"{Counter(rf['status'])}, every delivery finite; counters "
          + ", ".join(f"{k} {v}" for k, v in rf["counters"].items() if v)
          + "; breakers " + ", ".join(f"{k[8:]} {v}" for k, v in
                                      rf["breakers"].items()))
    del one_rt, one_srv, rt
    gc.collect()
    # -- the patch bases over the NCCL rank ----------------------------------
    hs.mark()

    def on_caches(name, gd, ts):
        if name == "pca":
            hs.point("PCA caches", host_slab(gd.engine), 0,
                     pca_draw_bytes(gd, ts), whole=whole[0])

    pres = pmesh_patches(mesh, pst, sched, x_P, on_caches)
    print(f"[pmesh] nccl S=1 host bytes, each step's own delta (this "
          f"process also holds the one-card references): "
          + host_gate("nccl S=1", hs.points))
    for name, q in pres.items():
        want_p, wall_p = patch_want[name]
        err = float((q["traj"] - want_p).abs().max())
        check(bool(torch.isfinite(q["traj"]).all()) and err <= TRAJ_TOL,
              f"[pmesh] nccl GoldDiff+{name}: vs one card {err:.3g}")
        print(f"[pmesh] nccl S=1 GoldDiff+{name} static trajectory (cifar10 "
              f"preset N={pst.n}, B={PMESH_PATCH_B}, {STEPS} steps): vs one "
              f"card max abs {err:.3g}; wall {q['wall_ms']:.1f} ms, one card "
              f"{wall_p:.1f} ms; launches {q['launches']}; "
              + patch_mem_line(q))
    return counts, one_clean


def pmesh_phase(ctx: dict) -> dict:
    """[pmesh]: the engine over a ``ProcessMesh``, one shard a rank.

    PMESH_S gloo ranks spawned on the one card (the parent built every
    kernel, so the ranks only load them), each opening [lifecycle]'s
    committed cifar_like epoch (``ctx["lifecycle"]``) and the cifar10
    preset's epoch by slab (``StoreLifecycle.open_slab``): a probe that
    gloo takes the card's tensors; each rank's host bytes step by step
    (``HostSteps``): the opens, the engines, the Wiener rung, the
    runtime's warmup and the PCA caches each within its bound
    (PMESH_MEM_SLACK x the slabs it holds on the host + the small arrays
    + PMESH_HOST_FIXED + the step's named terms), whose slack a whole
    read of the preset's rows would exceed; each rank's bytes on the
    card after constructing the exact and the indexed engine, at most
    its slab's plus 5%; every route (staged, streamed, fused, indexed at
    INDEXED_CFG, full scan, the plan, eager over gloo) from [sharded]'s
    x_T against the one-card trajectory over the same epoch's
    ``view("cuda")`` within TRAJ_TOL, the ranks'
    trajectories bit-equal, each counted alone (every shard-local
    kernel once a step a rank; the unsharded entries of kernels 3 and 4
    never); ``select`` at PMESH_TS with overlap 1.0 or ties at a cut, as
    [sharded] allows; then each rank's ``ServeRuntime`` (``pmesh_runtime``,
    faults on rank 1 alone: the ranks' records and images bit-equal, the
    clean deliveries within TRAJ_TOL of the one-card runtime's) and
    GoldDiff+PCA / +Kamb on the cifar10 preset (``pmesh_patches``,
    within TRAJ_TOL of one card, the ranks bit-equal).  A rank's error, or
    a join past PMESH_JOIN_S, fails the run.  Then a one-rank NCCL
    ProcessMesh in this process (``pmesh_nccl``).  Returns the path's
    counts: the gloo rank 0's and the NCCL rank's, by route."""
    import datetime

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.core import GoldDiff, OptimalDenoiser
    from repro_torch.index import IngestConfig, StoreLifecycle
    from repro_torch.kernels import _build
    t_phase = time.perf_counter()
    _build.build(PMESH_SOURCES)
    sched, x_T = ctx["sched"], ctx["x_T"]
    # the one-card references: [lifecycle]'s committed epoch, whole, on
    # the card (what the ranks open by slab)
    root = ctx["lifecycle"].name
    st, eix = ctx.pop("lifecycle_state").view("cuda")
    full = OptimalDenoiser(st, sched, device=st.device)
    ikw = dict(cfg=ctx["indexed_cfg"], index=eix,
               probe_schedule=ctx["probes"])
    one = {"exact": GoldDiff(full), "indexed": GoldDiff(full, **ikw)}
    want = {}
    for route in SHARD_ROUTES:
        gd = one["indexed" if route == "indexed" else "exact"]
        rk = ROUTE_KW[route]
        with (routed(gd.engine, rk["fused"], rk["screen"]) if rk
              else contextlib.nullcontext()):
            want[route] = route_trajectory(gd, route, sched, x_T)()
    # the patch bases' store (the cifar10 preset's), committed as an epoch
    # of its own that the ranks open by slab, and its one-card static
    # trajectories from x_T's first rows
    from repro_torch.configs.golddiff import PRESETS
    from repro_torch.core import make_denoiser, sample
    from repro_torch.data import make_dataset
    from repro_torch.index import build_index
    pre = PRESETS["cifar10"]
    pdata = dataclasses.replace(make_dataset(pre.dataset, device="cuda",
                                             **pre.dataset_kw), labels=None)
    ptmp = tempfile.TemporaryDirectory(prefix="pmesh_patch_")
    pst = StoreLifecycle.create(ptmp.name, pdata, build_index(pdata),
                                IngestConfig(**PMESH_PATCH_INGEST)
                                ).view("cuda")[0]
    del pdata
    x_P = x_T[:PMESH_PATCH_B]
    patch_want = {}
    for name in ("pca", "kamb"):
        gd = GoldDiff(make_denoiser(name, pst, sched, device="cuda"))
        fn = lambda: sample(gd, sched, tuple(x_P.shape), num_steps=STEPS,
                            x_init=x_P)
        patch_want[name] = (fn().cpu(), wall_once(fn))
        del gd, fn
    pdir = ROOT / "build" / "pmesh"
    pdir.mkdir(parents=True, exist_ok=True)
    for f in pdir.glob("rank*.pt"):
        f.unlink()
    # the ranks' inputs: the queries only (the stores are the epochs)
    torch.save({"x_T": x_T.cpu(),
                "x_sel": {t: pmesh_xt(st, sched, t).cpu() for t in PMESH_TS}},
               pdir / "inputs.pt")
    t0 = time.perf_counter()
    procs = mp.start_processes(
        pmesh_rank, args=(PMESH_S, free_port(), str(pdir),
                          dict(cfg=ctx["indexed_cfg"], probes=ctx["probes"],
                               root=root, patch_root=ptmp.name)),
        nprocs=PMESH_S, join=False, start_method="spawn")
    try:
        while not procs.join(timeout=5):      # a rank's error raises here
            check(time.perf_counter() - t0 < PMESH_JOIN_S,
                  f"[pmesh] the {PMESH_S} ranks did not finish in "
                  f"{PMESH_JOIN_S} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(pdir / f"rank{r}.pt") for r in range(PMESH_S)]
    s = PMESH_S
    for r, res in enumerate(ranks):
        check(res["probe"], f"[pmesh] rank {r}: gloo's all_reduce, "
              f"all_gather_into_tensor or broadcast of the card's tensors "
              f"gave wrong values")
        for kind, (mem, slab) in res["mem"].items():
            check(mem <= PMESH_MEM_SLACK * slab, f"[pmesh] rank {r} {kind}:"
                  f" {mem} bytes allocated after construction, slab {slab}")
        check(res["devices"] == ("cuda:0",) * 3, f"[pmesh] rank {r}: the "
              f"gloo mesh's device, and a card store's layout over a mesh "
              f"given none: {res['devices']}")
        for route in SHARD_ROUTES:
            out = res["traj"][route]
            err = float((out - want[route].cpu()).abs().max())
            check(bool(torch.isfinite(out).all()) and err <= TRAJ_TOL,
                  f"[pmesh] rank {r} S={s} {route}: vs one card {err:.3g}")
            check(torch.equal(out, ranks[0]["traj"][route]),
                  f"[pmesh] rank {r} S={s} {route}: not rank 0's bit for "
                  f"bit")
            check(res["counts"][route] == res["want"][route],
                  f"[pmesh] rank {r} S={s} {route} launches "
                  f"{res['counts'][route]}, expected {res['want'][route]}")
    res = ranks[0]
    print(f"[pmesh] {s} gloo ranks on the card ({ranks_s:.1f} s with the "
          f"spawn): gloo takes the card's tensors (all_reduce, "
          f"all_gather_into_tensor, broadcast: values right); bytes on "
          f"the card after construction, rank by rank: " + "; ".join(
              f"{kind} {mem} (slab {slab}, {mem / slab:.4f}x)"
              for q in ranks for kind, (mem, slab) in q["mem"].items())
          + f"; the epoch's rows {st.X.numel() * 4} bytes, / S = "
          f"{st.X.numel() * 4 // s}")
    for r, q in enumerate(ranks):
        print(f"[pmesh] gloo rank {r} host bytes step by step, each from "
              f"a reading just before it (the first taken after warming its "
              f"entry points on a {PMESH_WARM_N}-row store in "
              f"{q['warm_s']:.1f} s; open_slab of both epochs "
              f"{q['open_s']:.3f} s): " + host_gate(f"gloo rank {r}",
                                                   q["host"]))
    print(f"[pmesh] {s} gloo ranks: the default device {res['devices'][0]}; "
          f"a card store's layout over a gloo mesh given no device on "
          f"{res['devices'][1]}; peak allocated over the routes and "
          f"selects, rank by rank: " + "; ".join(
              f"{q['peak']['peak']} ({q['peak']['peak'] - q['peak']['held']}"
              f" over the {q['peak']['held']} held, workspace bound "
              f"{q['peak']['bound']})" for q in ranks)
          + f"; another shard's rows {st.X.numel() * 4 // s} bytes")
    for route in SHARD_ROUTES:
        err = max(float((q["traj"][route] - want[route].cpu()).abs().max())
                  for q in ranks)
        print(f"[pmesh] S={s} gloo {route} trajectory (B={B}, {STEPS} steps,"
              f" one x_T): vs one card max abs {err:.3g}, ranks bit-equal; "
              f"rank 0 wall {res['wall'][route]:.3f} ms; launches a rank "
              + ", ".join(f"{n} {v}" for n, v in res["counts"][route].items()
                          if v))
    swaps, min_ov = 0, 1.0
    for t in PMESH_TS:
        xt = pmesh_xt(st, sched, t)         # the queries the ranks were sent
        for kind in ("exact", "indexed"):
            e0 = one[kind].engine
            want_sel = e0.select(xt, t)
            for r, q in enumerate(ranks):
                got = q["select"][kind, t].to(st.device)
                ov = overlap(got, want_sel)
                nsw, ties = near_tie_swaps(
                    got, want_sel, xt / float(sched.a[t]), st.X,
                    e0 if kind == "exact" else None, t)
                check(ov == 1.0 or ties, f"[pmesh] rank {r} {kind} select "
                      f"t={t}: overlap {ov}, {nsw} swaps not near ties")
                swaps += nsw
                min_ov = min(min_ov, ov)
    print(f"[pmesh] S={s} select at t in {PMESH_TS}, exact and indexed, "
          f"every rank: overlap min {min_ov} ({swaps} rows swapped, each a "
          f"tie at a cut)")
    # the serving runtime over the ranks: the records bit-equal, faults
    # on rank 1 alone
    for kind in ("clean", "faults"):
        r0 = ranks[0]["runtime"][kind]
        for r, q in enumerate(ranks[1:], 1):
            rk = q["runtime"][kind]
            check(all(rk[k] == r0[k] for k in ("status", "degraded",
                                              "counters", "breakers"))
                  and torch.equal(rk["images"], r0["images"]),
                  f"[pmesh] gloo rank {r} runtime {kind}: not rank 0's "
                  f"records and images")
    for r, q in enumerate(ranks):
        rt_ = q["runtime"]
        print(f"[pmesh] gloo rank {r} runtime: Wiener rung from the slabs' "
              f"sums {rt_['wiener_s']:.2f} s, warmup {rt_['warmup_s']:.2f} s;"
              f" held after warmup {rt_['held']} bytes <= " + " + ".join(
                  f"{k} {v}" for k, v in rt_["terms"].items())
              + f"; clean {rt_['clean']['images_per_s']:.1f} images/s, p50 "
              f"{rt_['clean']['p50_ms']:.1f} ms, p99 "
              f"{rt_['clean']['p99_ms']:.1f} ms; probed: {rt_['probe']}")
    rf = ranks[0]["runtime"]["faults"]
    print(f"[pmesh] {s} gloo ranks, faults on rank 1 only ({PMESH_FAULTS}):"
          f" both ranks' statuses, counters, breakers and images bit-equal; "
          f"{Counter(rf['status'])}, counters " + ", ".join(
              f"{k} {v}" for k, v in rf["counters"].items() if v))
    for name, (want_p, wall_p) in patch_want.items():
        for r, q in enumerate(ranks):
            pr = q["patch"][name]
            err = float((pr["traj"] - want_p).abs().max())
            check(bool(torch.isfinite(pr["traj"]).all()) and err <= TRAJ_TOL
                  and torch.equal(pr["traj"], ranks[0]["patch"][name]["traj"]),
                  f"[pmesh] gloo rank {r} GoldDiff+{name}: vs one card "
                  f"{err:.3g}, or not rank 0's")
        q = ranks[0]["patch"][name]
        print(f"[pmesh] S={s} gloo GoldDiff+{name} static trajectory "
              f"(cifar10 preset N={pst.n}, B={PMESH_PATCH_B}, {STEPS} steps): "
              f"vs one card max abs {max(float((q_['patch'][name]['traj'] - want_p).abs().max()) for q_ in ranks):.3g}, "
              f"ranks bit-equal; walls rank 0 {q['wall_ms']:.1f} ms, one "
              f"card {wall_p:.1f} ms; launches a rank {q['launches']}; "
              f"bytes, rank by rank: " + "; ".join(
                  patch_mem_line(q_["patch"][name]) for q_ in ranks))
    print(f"[pmesh] gloo ranks done at {time.perf_counter() - t_phase:.1f} "
          f"s into the phase")
    # -- one NCCL rank in this process ------------------------------------------
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=PMESH_PG_S))
    try:
        nccl, one_clean = pmesh_nccl(ctx, dict(root=root,
                                               patch_root=ptmp.name),
                                     want, one, st, x_P, patch_want)
    finally:
        gc.collect()          # the engines and their graphs, before the comm
        torch.cuda.synchronize()
        dist.destroy_process_group()
    for r, q in enumerate(ranks):
        err = float((q["runtime"]["clean"]["images"] - one_clean).abs().max())
        check(err <= TRAJ_TOL, f"[pmesh] gloo rank {r} runtime clean "
              f"deliveries vs the one-card runtime's {err:.3g}")
    print(f"[pmesh] {s} gloo ranks' runtime: clean deliveries within "
          f"{max(float((q['runtime']['clean']['images'] - one_clean).abs().max()) for q in ranks):.3g}"
          f" of the one-card runtime's")
    ptmp.cleanup()
    ctx["lifecycle"].cleanup()
    print(f"[pmesh] phase {time.perf_counter() - t_phase:.1f} s")
    return {f"gloo S={s} rank 0": res["counts"], "nccl S=1": nccl}


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
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
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
             "golden_attention", "flash_attention_bwd",
             "flash_attention_bwd_sm90"]
    t0 = time.perf_counter()
    log = _build.build(names)
    print(f"[build] {len(names)} sources in {time.perf_counter() - t0:.1f}s "
          f"(one nvcc each, in parallel) into {_build.BUILD_DIR}")
    by_instance = {"pdist": ("pdist_kernel",),
                   "golden_aggregate": ("agg_cluster", "merge_kernel"),
                   "flash_attention_sm90": ("flash_sm90_kernel",),
                   "flash_attention_bwd": ("bwd_dot", "bwd_dkdv", "bwd_dq"),
                   "flash_attention_bwd_sm90": ("bwd_dot", "bwd_dkdv",
                                                "bwd_dq"),
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
    smem_bwd = _build.load("flash_attention_bwd_sm90", "flash_attention_bwd_"
                           "sm90_smem_bytes", [ctypes.c_int] * 2,
                           ctypes.c_size_t)
    nw_bwd = _build.load("flash_attention_bwd_sm90", "flash_attention_bwd_"
                         "sm90_dkdv_warpgroups", [])()
    print("[build] flash_attention_bwd_sm90 dynamic shared memory a CTA: "
          + ", ".join(f"dK/dV ({nw_bwd} warpgroups of 64 keys) "
                      f"dh={dh} {smem_bwd(0, dh)} B" for dh in (32, 64, 128))
          + "; " + ", ".join(f"dQ W={w} dh={dh} {smem_bwd(w, dh)} B"
                             for w in (1, 2, 3) for dh in (32, 64, 128)))

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
               "golden_attention_decode": golden_attention_decode,
               "flash_attention_bwd": flash_attention_bwd}
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
            graph = gd.engine._programs.get(gd.engine.program_key(
                plan_segment_key(pln, bucket, tuple(x.shape), "float32",
                                 3.0)))
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
        def run():              # device_kernels may run fn again
            for kfn in kernels.values():
                kfn.launches = 0
            fn()
        _, names = device_kernels(run)
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

    # -- 7c. bf16: the engine with bf16 store rows (storage_dtype) -------------
    bf16_results, bf16_counts = bf16_phase(dict(
        store=st, sched=sched, x_T=x_T, q=q, results=results, cix=cix,
        indexed_cfg=indexed_cfg, probes=scale_probes, steps=steps,
        m_max_frac=GoldDiffConfig().sizes(N)[1] / N,
        crossover_frac=engine_mod.GATHER_CROSSOVER_FRAC["cuda"]))
    for n, p in BF16_PATH.items():
        check(bf16_counts[p][n] > 0,
              f"{n}'s bf16 instance never launched on the bf16 {p} path")

    # -- 7d. the live store: the lifecycle and the serving runtime ------------
    live = dict(store=st, cix=cix, sched=sched, indexed_cfg=indexed_cfg,
                probes=scale_probes, x_T=x_T, kernels=kernels)
    path_counts["runtime"] = live_store_phase(live)

    # -- 7e. sharded: the store over a LocalMesh on the one card --------------
    sharded_results, sharded_counts = sharded_phase(dict(
        store=st, sched=sched, x_T=x_T, q=q, cix=cix,
        indexed_cfg=indexed_cfg, probes=scale_probes, gmm=gst))

    # -- 7f. the engine over a ProcessMesh: gloo ranks, one NCCL rank ---------
    pmesh_counts = pmesh_phase(dict(
        sched=sched, x_T=x_T, indexed_cfg=indexed_cfg, probes=scale_probes,
        lifecycle=live.pop("lifecycle"),
        lifecycle_state=live.pop("lifecycle_state")))
    print("[pmesh] path launches (a rank, by route): " + "; ".join(
        f"{path} {route} " + ", ".join(f"{n} {v}" for n, v in c.items() if v)
        for path, by in pmesh_counts.items() for route, c in by.items()))

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

    # -- 8b. presets: the paper's presets on the patch bases -----------------
    presets_phase(kernels)

    # -- 9. the reduced-LLM slice: prefill and golden decode ------------------
    llm_results, path_counts["llm_decode"] = llm_phases(kernels)
    results.update(llm_results)
    path_of.update(flash_attention="llm_decode",
                   golden_attention_decode="llm_decode")

    # -- 10. LLM training: the backward kernel, the train step, decode graph --
    train_results, path_counts["train"] = training_phases(kernels)
    results.update(train_results)
    path_of["flash_attention_bwd"] = "train"

    # -- 11. the seven archs of the frontend and MoE families ----------------
    arch_entries, arch_counts = arch_phases(kernels, smi)

    # -- 12. Mamba-2: mamba2-2.7b and jamba-v0.1-52b --------------------------
    mamba_entries, mamba_counts = mamba_phases(kernels, smi)
    arch_entries.update(mamba_entries)
    arch_counts.update(mamba_counts)

    # -- 13. the LLM's logical sharding on a (1, 1) device mesh --------------
    mesh_entries, mesh_counts = mesh_phases(kernels, smi)
    arch_entries.update(mesh_entries)
    arch_counts.update(mesh_counts)

    # -- 14. the dry run: per-card cost on the 16 x 16 mesh -------------------
    dryrun_phase(smi)

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
                   "src/repro/kernels/golden_attention.py:85"),
               # no TPU kernel: the reference differentiates its attention
               # by autodiff of this pure-JAX scan
               "flash_attention_bwd": ("csrc/flash_attention_bwd_sm90.cu",
                                       "src/repro/models/layers.py:122")}
    line = {"kernels": [
        dict(name=n, route="cuda",
             source=f"src/repro_torch/kernels/{sources[n][0]}",
             replaces=sources[n][1], path=path_of[n],
             launches=path_counts[path_of[n]][n], **results[n])
        for n in kernels]}
    line["kernels"] += [
        dict(name=f"{n}[bf16]", route="cuda",
             source=f"src/repro_torch/kernels/{sources[n][0]}",
             replaces=sources[n][1], path=f"bf16 {p}",
             launches=bf16_counts[p][n], **bf16_results[n])
        for n, p in BF16_PATH.items()]
    for n, route in ((SGS, "staged"), (SGA, "full_scan")):
        for tag, counts in sharded_counts.items():
            launches = counts[route][n]
            check(launches > 0, f"{n} [{tag}] never launched on the sharded "
                  f"{route} path")
            src = sources[n.removesuffix("_state")]
            line["kernels"].append(dict(
                name=n if tag == "fp32" else f"{n}[bf16]", route="cuda",
                source=f"src/repro_torch/kernels/{src[0]}",
                replaces=src[1], path=f"sharded S={SHARDS[-1]} {route}"
                + (" bf16" if tag == "bf16" else ""), launches=launches,
                **sharded_results[f"{n}[{tag}]"]))
    for (n, path), r in arch_entries.items():
        line["kernels"].append(dict(
            name=f"{n}[{path}]", route="cuda",
            source=f"src/repro_torch/kernels/{sources[n][0]}",
            replaces=sources[n][1], path=path, **r))
    for path, counts in arch_counts.items():
        n = ("golden_attention_decode" if path.startswith("arch_ops")
             else "flash_attention")
        check(counts[n] > 0, f"{n} never launched on the {path} path")
        check("train" not in path or counts["flash_attention_bwd"] > 0,
              f"flash_attention_bwd never launched on the {path} path")
    for n in ("flash_attention", "golden_attention_decode"):
        check(path_counts["llm_decode"][n] > 0,
              f"{n} never launched on the llm_decode path")
    for n in ("flash_attention", "flash_attention_bwd"):
        check(path_counts["train"][n] > 0,
              f"{n} never launched on the train path")
    print(smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
