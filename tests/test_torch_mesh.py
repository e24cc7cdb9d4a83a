"""The LLM's logical sharding and the dry run against the JAX package.

* Every leaf of every arch's parameter tree and decode cache carries the
  reference's logical axes, and ``Rules.spec`` resolves each (leaf,
  mode, mesh) as the reference's does on ``AbstractMesh`` (16, 16) and
  (2, 16, 16): 1928 parameter specs.
* On four gloo ranks ((2, 2) ("data", "model"), one subprocess,
  ``tests/_mesh_ranks.py``) the reduced llama3.2-3b, phi3.5-moe and jamba
  train steps (plain, ``shard_grad_accum`` over two microbatches,
  ``zero1_rules``) equal the one-process port from the same fp32 weights
  and batch: loss 1e-5, gradients and updated parameters 1e-4 of the
  leaf's largest value (``tests/test_torch_training.py``'s); the MoE
  routings of every rank's groups equal the one-process routings.
* The sharded decode (full, golden, golden with cached summaries) equals
  the reference's ``decode_step`` under ``make_rules("decode", mesh)`` on
  an emulated four-device mesh (a second subprocess writes an ``.npz``)
  within ``LOGIT_TOL`` 1e-4, the written cache row within ``CACHE_TOL``
  1e-5.
* The dry run on fake CPU tensors (a third subprocess: a fake process
  group is global state): a reduced config's per-device parameter and
  AdamW bytes equal the count from the placements, one sharded product's
  local FLOPs and collective bytes equal a hand count (``FlopCounterMode``
  counts the global product), the port's ``collective_bytes`` equals the
  reference's HLO parser on the same collectives, and one attention
  layer's traced FLOPs equal the reference's formula.
* The dry run's extrapolation from 1 and 2 periods at 2 and 3
  microbatches against the step traced at 3 periods and 4 microbatches
  (two more subprocesses), and its ``ValueError`` on a negative value.
* On the gloo ranks, ``shard_map_compat`` and the parameters drawn on
  the mesh (each rank keeps only its shards).

The file takes about 140 s on one worker, its subprocesses most of it.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from torch.distributed.tensor import Shard  # noqa: E402

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.models import module as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.module import ParamSpec, tree_leaves  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MODES = ("train", "prefill", "decode", "decode_long")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
LOSS_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-4
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5        # tests/test_torch_models.py's
N_PARAM_SPECS = 1928


def jspec_tuple(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def jleaves(tree):
    return {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JM.ParamSpec))[0]}


def spec_pairs(arch):
    """(path, port ParamSpec, reference ParamSpec) of every leaf."""
    mine = dict(tree_leaves(T.model_specs(get_config(arch))))
    ref = jleaves(JT.model_specs(jget_config(arch)))
    assert set(mine) == set(ref)
    return [(p, mine[p], ref[p]) for p in sorted(mine)]


# --- logical axes and specs ----------------------------------------------------

def test_archs_cover_the_reference():
    assert ARCH_IDS == list(JARCH_IDS)
    n = sum(len(spec_pairs(a)) for a in ARCH_IDS)
    assert n * len(MODES) * len(MESHES) == N_PARAM_SPECS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_and_specs_match_reference(arch):
    """Each leaf's logical axes, and its spec in every mode on both
    meshes, are the reference's."""
    n = 0
    for shape, names in MESHES.values():
        jmesh = JAbstractMesh(shape, names)
        mesh = S.AbstractMesh(shape, names)
        for mode in MODES:
            jr, r = JS.make_rules(mode, jmesh), S.make_rules(mode, mesh)
            assert r.table == jr.table
            for path, mine, ref in spec_pairs(arch):
                assert mine.logical_axes == ref.logical_axes, path
                assert mine.shape == ref.shape, path
                got = r.spec(mine.logical_axes, mine.shape)
                want = jspec_tuple(jr.spec(ref.logical_axes, ref.shape))
                assert got == want, (path, mode, shape)
                n += 1
    assert n == len(spec_pairs(arch)) * len(MODES) * len(MESHES)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_and_specs_match_reference(arch):
    """``cache_specs`` gives the reference's (shape, logical axes, dtype)
    and resolves as the reference's in the decode modes (the decode_32k
    and long_500k shapes)."""
    for b, s in ((128, 32768), (1, 524288)):
        mine = dict(tree_leaves(T.cache_specs(get_config(arch), b, s)))
        ref = {"/".join(k.key for k in path): leaf for path, leaf in
               jax.tree_util.tree_flatten_with_path(
                   JT.cache_specs(jget_config(arch), b, s),
                   is_leaf=lambda x: isinstance(x, tuple) and len(x) == 3
                   and isinstance(x[0], tuple))[0]}
        assert set(mine) == set(ref)
        for shape, names in MESHES.values():
            for mode in ("prefill", "decode", "decode_long"):
                jr = JS.make_rules(mode, JAbstractMesh(shape, names))
                r = S.make_rules(mode, S.AbstractMesh(shape, names))
                for path, (shp, ax, dt) in mine.items():
                    rshp, rax, rdt = ref[path]
                    assert (shp, ax) == (tuple(rshp), tuple(rax)), path
                    assert str(dt).removeprefix("torch.") == \
                        np.dtype(rdt).name
                    assert r.spec(ax, shp) == jspec_tuple(jr.spec(rax, rshp))


def test_rules_resolution_and_context():
    """Without a mesh the rules are empty and ``shard`` is the identity;
    a spec drops a mesh axis that does not divide its dimension and never
    uses one twice; overrides replace table entries; the context nests."""
    none = S.make_rules("none")
    assert none.mesh is None and none.spec(("batch",)) == ()
    x = torch.ones(3)
    assert S.shard(x, "batch") is x and S.mesh_axis_size("data") == 1
    mesh = S.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    r = S.make_rules("train", mesh, overrides={"embed": None})
    assert r.table["embed"] is None
    assert r.spec(("batch", "embed"), (64, 8)) == (("pod", "data"), None)
    assert r.spec(("batch",), (2,)) == ("pod",)        # 2 % 32: data goes
    assert r.spec(("heads", "act_heads"), (40, 32)) == (None, "model")
    assert r.spec(("mlp", "heads"), (32, 32)) == ("model", None)
    with pytest.raises(ValueError):
        S.make_rules("serve", mesh)
    with S.use_rules(r):
        assert S.current_rules() is r
        assert S.mesh_axis_size("pod", "data", "nope") == 32
        with S.use_rules(none):
            assert S.current_rules() is none
        assert S.current_rules() is r
    assert S.current_rules().mesh is None
    with pytest.raises(ValueError, match="vs"):
        ParamSpec((2, 3), ("embed",))


# --- gloo ranks ------------------------------------------------------------------

_REF_DECODE = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.distributed.sharding import make_rules
from repro.launch import steps
from repro.models import module as M, transformer as T
out = sys.argv[1]
base = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                           num_kv_heads=2)
from jax.sharding import AxisType
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
rules = make_rules("decode", mesh)
params = M.init_params(T.model_specs(base), jax.random.PRNGKey(0))
rng = np.random.default_rng(3)
b, s, pos = 4, 128, 100
token = rng.integers(0, base.vocab_size, (b,)).astype(np.int32)
res = {"token": token, "pos": np.asarray(pos)}
for kind in ("full", "golden", "golden_cached"):
    cfg = dataclasses.replace(
        base, attn_kind_decode="full" if kind == "full" else "golden",
        golden_cached_summaries=kind == "golden_cached")
    cache = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)),
        T.zero_cache(cfg, b, s))
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        res[f"c_{kind}/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    with mesh:
        logits, new = jax.jit(steps.make_decode_step(cfg, rules))(
            params, cache, jnp.asarray(token), jnp.asarray(pos, jnp.int32))
    res[f"logits_{kind}"] = np.asarray(logits)
    res[f"k_{kind}"] = np.asarray(new["l0"]["k"])
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    res["p/" + "/".join(k.key for k in path)] = np.asarray(leaf)
meta = {k: (list(v) if isinstance(v, tuple) else v)
        for k, v in dataclasses.asdict(base).items()}
res["config"] = np.asarray(json.dumps(meta))
np.savez(out, **res)
print("PASS")
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The reference's sharded decode, then the gloo ranks' results."""
    d = tmp_path_factory.mktemp("mesh")
    ref = d / "ref_decode.npz"
    r = subprocess.run([sys.executable, "-c", _REF_DECODE, str(ref)],
                       capture_output=True, text=True, timeout=600,
                       cwd=str(REPO), env=_env())
    assert "PASS" in r.stdout, r.stdout + r.stderr[-4000:]
    out = d / "ranks.json"
    r = subprocess.run([sys.executable, str(REPO / "tests" / "_mesh_ranks.py"),
                        str(out), str(ref)], capture_output=True, text=True,
                       timeout=600, cwd=str(d), env=_env())
    assert "PASS" in r.stdout, r.stdout + r.stderr[-4000:]
    return (json.loads(out.read_text()), dict(np.load(ref)),
            dict(np.load(str(out) + ".npz")))


MESH_ARCHS = ("llama3.2-3b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b")


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_loss_step_matches_one_process(ranks, arch):
    got = ranks[0][arch]["loss_step"]
    assert got["loss"] <= LOSS_TOL
    assert got["grads"] <= GRAD_TOL


@pytest.mark.parametrize("variant", ["plain", "accum", "zero1"])
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_train_step_matches_one_process(ranks, arch, variant):
    """One AdamW step on the mesh: plain, two microbatches with
    ``shard_grad_accum``, and ZeRO-1 (parameters whole over "data", the
    optimizer state split: its placements differ from the
    parameters')."""
    got = ranks[0][arch][variant]
    assert got["loss"] <= LOSS_TOL and got["nll"] <= LOSS_TOL
    assert got["grad_norm"] <= GRAD_TOL
    assert got["params"] <= STEP_TOL
    assert got["master_placements_differ"] == (variant == "zero1")


@pytest.mark.parametrize("arch", MESH_ARCHS[1:])
def test_mesh_routing_equals_one_process(ranks, arch):
    """Every rank's expert choices and kept slots (its own groups) equal
    the one-process routing of those groups, at every MoE layer."""
    got = ranks[0][arch]
    assert got["routing_calls"] >= 1 and got["routing_equal"]


def test_tuple_axis_checkpoint_and_world(ranks):
    """A dimension over ("data", "model") splits in the reference's
    major-to-minor order (rank (d, m) holds block 2 d + m), another order
    raises; a checkpoint of mesh parameters reads back onto their
    placements; the production mesh names the world it did not find."""
    got = ranks[0]
    assert all(got["tuple_axis"].values()) and len(got["tuple_axis"]) == 4
    assert got["tuple_out_of_order_raises"]
    assert all(got["checkpoint"].values()) and len(got["checkpoint"]) == 4
    assert "needs 256 ranks; the world has 4" in \
        got["production_world_error"]


def test_shard_map_compat_on_gloo_ranks(ranks):
    """On every rank of the 2 x 2 mesh: a body that sums its shard's
    rows and all-reduces over "model" gives the full rows' sums on
    (Shard(0), Replicate()); a replicated [1, 1] factor's gradient is
    the sum of x over every rank's shard."""
    got = ranks[0]["shard_map_compat"]
    assert len(got) == 4 and all(got.values())


@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_params_drawn_on_the_mesh_keep_only_their_shards(ranks, arch):
    """``init_params(..., rules)`` on the 2 x 2 mesh gives on every rank
    the leaves of ``place_params`` over the whole draw, bit for bit and
    on the same placements, each local shard in a storage of its own
    (not a view that keeps the whole leaf alive)."""
    got = {k: v for k, v in ranks[0]["sharded_init"].items()
           if k.startswith(arch + "/")}
    assert len(got) == 4 and all(got.values())


@pytest.mark.parametrize("kind", ["full", "golden", "golden_cached"])
def test_sharded_decode_matches_reference(ranks, kind):
    """The split-S decode (each shard writes the new row where it falls,
    golden keeps max(1, golden_blocks // 2) blocks a shard) against the
    reference's ``decode_step`` under decode rules on its own 2 x 2
    mesh."""
    _, ref, port = ranks
    np.testing.assert_allclose(port[kind], ref[f"logits_{kind}"],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(port[kind + "_k"], ref[f"k_{kind}"],
                               rtol=CACHE_TOL, atol=CACHE_TOL)


_ONE_RANK = r"""
import dataclasses, json, sys
import torch, torch.distributed as dist
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[2], 1), rank=0,
                        world_size=1)
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import train as train_lib
from repro_torch.launch.mesh import make_debug_device_mesh
from repro_torch.models.module import tree_leaves
torch.set_num_threads(1)
mesh = make_debug_device_mesh(1, 1, "cpu")
cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                          dtype="bfloat16", remat=True)
out = {}
for name, rules in (("one", make_rules("none")),
                    ("mesh", make_rules("train", mesh))):
    p, st, b, step = train_lib.setup(cfg, 4, 2, 128, torch.device("cpu"),
                                     rules=rules)
    losses = []
    for i in range(4):
        p, st, m = step(p, st, b[i % len(b)])
        losses.append(float(m["loss"]))
    out[name] = (losses, {k: (v.full_tensor() if hasattr(v, "full_tensor")
                              else v) for k, v in tree_leaves(p)})
json.dump({"losses": {k: v[0] for k, v in out.items()},
           "params_equal": all(torch.equal(out["one"][1][k], out["mesh"][1][k])
                               for k in out["one"][1])}, open(sys.argv[1], "w"))
dist.destroy_process_group()
print("PASS")
"""


def test_one_rank_mesh_step_is_the_one_device_step(tmp_path):
    """On a (1, 1) mesh (one gloo rank) four bf16 train steps of the
    reduced llama (remat on) give the one-device steps' losses and
    parameters bit for bit: the layouts, the per-shard log-sum-exp and
    the merges add no rounding where nothing is split (chip_smoke.py's
    [mesh] holds the full-width step so against [train])."""
    path = tmp_path / "one_rank.json"
    r = subprocess.run([sys.executable, "-c", _ONE_RANK, str(path),
                        str(tmp_path / "store")], capture_output=True,
                       text=True, timeout=300, cwd=str(REPO), env=_env())
    assert "PASS" in r.stdout, r.stdout + r.stderr[-4000:]
    got = json.loads(path.read_text())
    assert got["losses"]["mesh"] == got["losses"]["one"]
    assert got["params_equal"]


# --- the dry run on fake CPU tensors ---------------------------------------------

_DRYRUN = r"""
import json, sys, dataclasses
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import get_config
from repro_torch.distributed import hlo_analysis as H
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import dryrun as D
from repro_torch.launch.inputs import InputShape
from repro_torch.models import layers as L
out = {}
mesh = D.make_mesh(False, "cpu", (2, 2))
# one sharded product: x [8, 16, 32] (batch over data, features over
# model) @ w [32, 64] (input over data, output over model)
from torch._subclasses.fake_tensor import FakeTensorMode
with FakeTensorMode():
    x = distribute_tensor(torch.empty(8, 16, 32), mesh, [Shard(0), Shard(2)],
                          src_data_rank=None)
    w = distribute_tensor(torch.empty(32, 64), mesh, [Shard(0), Shard(1)],
                          src_data_rank=None)
    m = H.DeviceCostMode()
    with m:
        y = L.dense(x, w)
    with FlopCounterMode(display=False) as fc:
        x @ w
out["product"] = {"flops": m.flops, "coll": H.collective_bytes(m.records),
                  "global_flops": fc.get_total_flops(),
                  "out": [str(p) for p in y.placements]}
# a reduced llama: its probes' arguments and the full record
cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), num_kv_heads=2,
                          dtype="bfloat16", remat=True)
shape = InputShape("t", "train", 64, 8)
rules = make_rules("train", mesh)
mt = D.trace_step(cfg, shape, rules, "cpu", 1)
out["tracked"] = mt.tracked
out["records"] = [(k, str(d).removeprefix("torch."), list(s))
                  for k, d, s in mt.records]
out["coll"] = H.collective_bytes(mt.records)
rec = D.run_one("llama3.2-3b", "t", cfg=cfg, shape=shape, mesh_shape=(2, 2),
                device="cpu", save=False, num_microbatches=2)
out["record"] = rec
z = D.run_one("llama3.2-3b", "t", cfg=cfg, shape=shape, mesh_shape=(2, 2),
              device="cpu", save=False, num_microbatches=2, zero1=True)
out["zero1_args"] = [z["probe_memory"]["p1_mb2"]["argument_size_in_bytes"],
                     rec["probe_memory"]["p1_mb2"]["argument_size_in_bytes"]]
for kind, shp in (("prefill", InputShape("p", "prefill", 64, 4)),
                  ("decode", InputShape("d", "decode", 64, 4))):
    out[kind] = D.run_one("llama3.2-3b", kind, cfg=cfg, shape=shp,
                          mesh_shape=(2, 2), device="cpu", save=False)
print(D.line(rec))
json.dump(out, open(sys.argv[1], "w"))
print("PASS")
"""


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "dryrun.json"
    r = subprocess.run([sys.executable, "-c", _DRYRUN, str(path)],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(REPO), env=_env())
    assert "PASS" in r.stdout, r.stdout + r.stderr[-4000:]
    return json.loads(path.read_text())


def test_dryrun_local_product_is_a_hand_count(dryrun):
    """x [8, 16, 32] (rows over "data", features over "model") @ w [32,
    64] (input over "data", output over "model") on 2 x 2: each rank
    gathers w's input (all-gather, 32 x 32 fp32) and x's features (4 x 16
    x 32 fp32), then multiplies its 4 x 16 rows by 32 output columns:
    2 x 64 x 32 x 32 FLOPs, a quarter of the global count."""
    got = dryrun["product"]
    assert got["flops"] == 2 * 64 * 32 * 32
    assert got["global_flops"] == 4 * got["flops"]
    assert got["coll"]["all-gather"] == (32 * 32 + 4 * 16 * 32) * 4
    assert got["coll"]["total"] == got["coll"]["all-gather"]
    assert got["out"] == [str(Shard(0)), str(Shard(2))]


def test_dryrun_argument_bytes_follow_the_placements(dryrun):
    """The tracked arguments of a reduced llama's train probe are each
    leaf's local shard (its placements on 2 x 2) in bf16 plus three fp32
    AdamW copies, and the tokens and labels."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(),
                              num_kv_heads=2, dtype="bfloat16", remat=True)
    r = S.make_rules("train", S.AbstractMesh((2, 2), ("data", "model")))
    want = 0
    for _, s in tree_leaves(T.model_specs(cfg)):
        n = 1
        for size, ms in zip(s.shape, r.spec(s.logical_axes, s.shape)):
            ways = 1 if ms is None else 2 ** len(
                (ms,) if isinstance(ms, str) else ms)
            n *= size // ways
        want += n * (s.dtype.itemsize + 12)
    want += 2 * (8 // 2) * 64 * 8                # tokens, labels: int64
    want += 4                                    # the AdamW step (int32)
    assert dryrun["tracked"] == want


def test_dryrun_collective_bytes_match_reference_parser(dryrun):
    """The collectives the train probe recorded, written as HLO result
    lines, parse to the same bytes in the reference's ``collective_bytes``
    (its convention: result shapes, by kind)."""
    from repro.distributed import hlo_analysis as JH
    dt = {"float32": "f32", "bfloat16": "bf16", "int64": "s64",
          "int32": "s32", "bool": "pred"}
    lines = [f"  %c.{i} = {dt[d]}[{','.join(map(str, s))}]"
             f"{{{','.join(map(str, range(len(s) - 1, -1, -1)))}}} {k}(%x)"
             for i, (k, d, s) in enumerate(dryrun["records"])]
    assert dryrun["records"]
    assert JH.collective_bytes("\n".join(lines)) == dryrun["coll"]


def test_dryrun_record_keeps_the_reference_fields(dryrun):
    rec = dryrun["record"]
    for key in ("arch", "shape", "mesh", "chips", "memory", "collectives",
                "flops_corrected", "bytes_corrected", "roofline",
                "model_flops_global", "model_flops_per_chip",
                "useful_flops_ratio", "fits_hbm", "probe_costs"):
        assert key in rec, key
    assert rec["mesh"] == "2x2" and rec["chips"] == 4
    assert rec["fits_hbm"] is True
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    # two microbatches of 4 rows: probed at 2 microbatches only, and the
    # extrapolation at r = 2 (two layers of one-layer periods) is the
    # 2-period probe itself
    assert set(rec["probe_costs"]) == {"p1_mb2", "p2_mb2"}
    assert rec["flops_corrected"] == rec["probe_costs"]["p2_mb2"]["flops"]
    assert rec["memory"]["peak_bytes"] == max(
        rec["probe_memory"]["p2_mb2"]["phase_peak_bytes"].values())
    assert 0 < rec["useful_flops_ratio"] < 1
    # ZeRO-1 keeps the parameters whole over "data": more argument bytes
    zero1, plain = dryrun["zero1_args"]
    assert zero1 > plain
    for kind in ("prefill", "decode"):
        r = dryrun[kind]
        assert r["flops_corrected"] > 0 and r["memory"]["peak_bytes"] > 0
        assert set(r["probe_costs"]) == {"p1_mb1", "p2_mb1"}


_EXTRAP = r"""
import dataclasses, json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import dryrun as D
from repro_torch.launch.inputs import InputShape
mesh = D.make_mesh(False, "cpu", (2, 2))
shape = InputShape("t", "train", 32, 8)        # 2 rows a microbatch of 4
out = {}
for case in sys.argv[2:]:
    arch, zero1 = case.removesuffix("+zero1"), case.endswith("+zero1")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16",
                              remat=True)
    zr = make_rules("train", mesh) if zero1 else None
    rules = make_rules("train", mesh,
                       overrides={"embed": None} if zero1 else None)
    t0 = time.time()
    grid = D.probe_grid(cfg, shape, rules, "cpu", 4, zr)
    got = D.extrapolate(grid, 3, 4)
    cost, coll, mem = D.probe_grid(cfg, shape, rules, "cpu", 4, zr,
                                   points=[(3, 4)])[3, 4]
    out[case] = {"probes": sorted(grid), "extrapolated": got,
                 "traced": {"flops": cost["flops"], "bytes": cost["bytes"],
                            "collectives": coll, "memory": mem},
                 "seconds": time.time() - t0}
json.dump(out, open(sys.argv[1], "w"))
print("PASS")
"""
EXTRAP_CASES = ("llama3.2-3b", "llama3.2-3b+zero1", "phi3.5-moe-42b-a6.6b",
                "jamba-v0.1-52b", "musicgen-medium")


@pytest.fixture(scope="module")
def extrap(tmp_path_factory):
    """The cases in two processes side by side (jamba and musicgen, a
    frontend's embeddings in its batch, take about as long as the other
    three)."""
    d = tmp_path_factory.mktemp("extrap")
    groups = (EXTRAP_CASES[:3], EXTRAP_CASES[3:])
    procs = [subprocess.Popen([sys.executable, "-c", _EXTRAP,
                               str(d / f"{i}.json"), *cases],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=str(REPO), env=_env())
             for i, cases in enumerate(groups)]
    out = {}
    try:
        for i, p in enumerate(procs):
            so, se = p.communicate(timeout=600)
            assert "PASS" in so, so + se[-4000:]
            out.update(json.loads((d / f"{i}.json").read_text()))
    finally:
        for p in procs:
            p.kill()
    return out


@pytest.mark.parametrize("case", EXTRAP_CASES)
def test_dryrun_extrapolation_matches_a_deeper_trace(extrap, case):
    """The dry run's extrapolation from 1 and 2 periods at 2 and 3
    microbatches, held against the step traced at 3 periods and 4
    microbatches (reduced configs, 2 x 2 mesh, train rules, remat; a
    dense, a ZeRO-1, an MoE, a hybrid and a frontend arch): the
    FLOPs, every collective kind, the argument bytes and the peak
    exactly, and each phase's peak exactly but ZeRO-1's gradient phase;
    the eager bytes within 1e-4, 1e-2 under ZeRO-1.  The two ZeRO-1
    gaps, measured: DTensor gathers a stacked leaf of one period without
    the copy it makes at two or more, so the bytes count that copy once
    too often at 3 periods (+0.58%); the gradient phase's peak grows
    4597760, 4720704, then 4728832 bytes a period from 3 periods on, so
    its extrapolation falls 0.81% short at 3 periods (the update phase
    holds the peak there)."""
    got, want = extrap[case]["extrapolated"], extrap[case]["traced"]
    zero1 = case.endswith("+zero1")
    assert extrap[case]["probes"] == [[1, 2], [1, 3], [2, 2], [2, 3]]
    assert got["flops"] == want["flops"]
    assert got["collectives"] == want["collectives"]
    assert want["collectives"]["all-gather"] > 0
    assert want["collectives"]["reduce-scatter"] > 0
    for key in ("argument_size_in_bytes", "peak_bytes", "total_hbm_bytes"):
        assert got["memory"][key] == want["memory"][key], key
    phases = want["memory"]["phase_peak_bytes"]
    assert set(phases) == {"grad", "step", "update"}
    for ph, v in phases.items():
        if zero1 and ph == "grad":
            assert v < phases["update"]
            assert got["memory"]["phase_peak_bytes"][ph] == pytest.approx(
                v, rel=1e-2)
        else:
            assert got["memory"]["phase_peak_bytes"][ph] == v, ph
    assert got["bytes"] >= want["bytes"]
    assert got["bytes"] == pytest.approx(want["bytes"],
                                         rel=1e-2 if zero1 else 1e-4)


def test_dryrun_extrapolation_refuses_a_negative_value():
    """A probe grid whose slope drives a quantity below zero raises
    ``ValueError`` naming it, instead of clamping it to 0."""
    from repro_torch.launch import dryrun as D

    def probe(flops, peak):
        mem = {"argument_size_in_bytes": 1.0, "peak_bytes": peak,
               "total_hbm_bytes": peak, "phase_peak_bytes": {"step": peak}}
        return ({"flops": flops, "bytes": 1.0}, {"total": 0.0}, mem)
    grid = {(1, 1): probe(10.0, 5.0), (2, 1): probe(4.0, 6.0)}
    with pytest.raises(ValueError, match="flops"):
        D.extrapolate(grid, 4, 1)
    grid = {(1, 1): probe(1.0, 9.0), (2, 1): probe(2.0, 5.0)}
    with pytest.raises(ValueError, match="step"):
        D.extrapolate(grid, 4, 1)
    assert D.extrapolate({(1, 1): probe(1.0, 9.0), (2, 1): probe(2.0, 9.0)},
                         4, 1)["flops"] == 4.0


def test_attention_layer_flops_match_reference_formula():
    """The port traces every tile (no loop correction): one attention
    layer's FLOPs, kernel 9 on fake tensors, are the reference's count,
    its once-counted tile plus ``loop_corrections`` (4 B H S^2 dh), and
    its peak memory holds no [S, S] scores."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro.distributed import hlo_analysis as JH
    from repro.launch.inputs import InputShape as JShape
    from repro_torch.distributed import hlo_analysis as H
    from repro_torch.models import layers as L
    b, s, h, kv, dh = 2, 2048, 8, 2, 64
    jcfg = dataclasses.replace(jget_config("llama3.2-3b").reduced(
        num_layers=1), num_heads=h, num_kv_heads=kv, head_dim=dh)
    qc, kc = min(jcfg.attn_q_chunk, s), min(jcfg.attn_kv_chunk, s)
    want = JH.loop_corrections(jcfg, JShape("p", "prefill", s, b), 1)[
        "flops"] + 4 * b * h * qc * kc * dh
    with FakeTensorMode():
        q = torch.empty(b, s, h, dh)
        k, v = torch.empty(b, s, kv, dh), torch.empty(b, s, kv, dh)
        m = H.DeviceCostMode()
        m.track([q, k, v])
        with m:
            L.flash_attention(q, k, v, L.AttnDims(h, kv, dh),
                              q_chunk=jcfg.attn_q_chunk,
                              kv_chunk=jcfg.attn_kv_chunk)
    assert m.flops == want == 4 * b * h * s * s * dh
    assert m.peak < b * h * s * s * 4 / 4
