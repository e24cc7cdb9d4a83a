"""The sharded LLM steps on gloo ranks, held against the one-process port.

Run as ``python tests/_mesh_ranks.py OUT [REF_NPZ]``: four ranks on a
``dist.FileStore`` (no port) form a (2, 2) ("data", "model") CPU
``DeviceMesh``.  Every rank draws the same fp32 weights and batches; rank
0 also runs the one-process port and writes what the tests compare to
``OUT`` (a JSON file):

* the reduced llama3.2-3b, phi3.5-moe and jamba (its 8-layer pattern)
  train steps under train rules (plain, two microbatches with
  ``shard_grad_accum``, ``zero1_rules``): loss, gradients and updated
  parameters, and the MoE routings of every rank's groups;
* a tuple axis (one dimension over ("data", "model")), a checkpoint of
  mesh parameters, ``shard_map_compat`` (a psum over "model", a
  replicated input's gradient) and the parameters drawn on the mesh;
* with ``REF_NPZ`` (the reference's sharded decode on an emulated
  four-device mesh): the port's sharded decode logits, full, golden and
  golden with cached summaries, into ``OUT``'s sibling ``.npz``.
"""
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ARCHS = ("llama3.2-3b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b")
B, S = 4, 64
# the first AdamW step maps g to g / (|g| + eps): a gradient far below eps
# moves its parameter by lr x g / eps, so the step amplifies a gradient's
# fp32 reduction-order error by lr / eps (1e5 at the default 1e-8).  At
# 1e-2 the updated parameters show the gradients' agreement.
EPS = 1e-2


def reduced(arch):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced(
        num_layers=8 if arch == "jamba-v0.1-52b" else 2)
    return dataclasses.replace(cfg, ssm_chunk=16) if cfg.ssm_state else cfg


def rel_max(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / max(want.abs().max(), 1e-30))


def full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def leaves(tree):
    from repro_torch.models.module import tree_leaves
    return dict(tree_leaves(tree))


def record_routes(calls):
    """Wrap ``moe.route`` to append (expert_idx, dispatch) of each call."""
    from repro_torch.models import moe
    inner = moe.route

    def wrapped(*a, **k):
        out = inner(*a, **k)
        calls.append((out[1].clone(), out[2].clone()))
        return out
    moe.route = wrapped
    return lambda: setattr(moe, "route", inner)


def train_checks(mesh, rank, res):
    from repro_torch.distributed.sharding import make_rules, mesh_coordinate
    from repro_torch.launch import steps as S_
    from repro_torch.models.module import place_params
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params, param_shardings
    from repro_torch.training import optimizer as O
    for arch in ARCHS:
        cfg = reduced(arch)
        specs = T.model_specs(cfg)
        init = init_params(specs, torch.Generator().manual_seed(0), "cpu")
        gen = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=1, eps=EPS)
        clone = lambda: {k: v for k, v in  # noqa: E731
                         _copy(init).items()}
        out = res.setdefault(arch, {})

        # gradients and routings: the loss step
        calls1, callsm = [], []
        undo = record_routes(calls1)
        loss1, g1 = S_.make_loss_step(cfg)(clone(), batch)
        undo()
        tr = make_rules("train", mesh)
        undo = record_routes(callsm)
        lossm, gm = S_.make_loss_step(cfg, tr)(
            place_params(clone(), specs, tr), batch)
        undo()
        g1, gm = leaves(g1), leaves(gm)
        out["loss_step"] = {
            "loss": abs(float(lossm) - float(loss1)),
            "grads": max(rel_max(full(gm[p]), g1[p]) for p in g1)}
        if calls1:
            c = mesh_coordinate(mesh, ("data",))
            same = len(calls1) == len(callsm)
            for (e1, d1), (em, dm) in zip(calls1, callsm):
                n = em.shape[0]
                same &= bool(torch.equal(em, e1[c * n:(c + 1) * n]))
                same &= bool(torch.equal(dm, d1[c * n:(c + 1) * n]))
            out["routing_equal"] = same
            out["routing_calls"] = len(calls1)

        for variant in ("plain", "accum", "zero1"):
            n = 2 if variant == "accum" else 1
            p1 = clone()
            st1 = O.init_state(p1)
            p1, st1, m1 = S_.make_train_step(cfg, None, ocfg, n)(
                p1, st1, batch)
            if variant == "zero1":
                zr = make_rules("train", mesh)
                rules = make_rules("train", mesh, overrides={"embed": None})
                pm = place_params(clone(), specs, rules)
                stm = O.init_state(pm, param_shardings(specs, zr))
                step = S_.make_train_step(cfg, rules, ocfg, zero1_rules=zr)
            else:
                rules = tr
                pm = place_params(clone(), specs, rules)
                stm = O.init_state(pm)
                step = S_.make_train_step(cfg, rules, ocfg, n,
                                          shard_grad_accum=variant == "accum")
            pm, stm, mm = step(pm, stm, batch)
            p1, pm = leaves(p1), leaves(pm)
            out[variant] = {
                "loss": abs(float(mm["loss"]) - float(m1["loss"])),
                "nll": abs(float(mm["nll"]) - float(m1["nll"])),
                "grad_norm": abs(float(mm["grad_norm"])
                                 - float(m1["grad_norm"]))
                / float(m1["grad_norm"]),
                "params": max(rel_max(full(pm[p]), p1[p]) for p in p1),
                "master_placements_differ": variant == "zero1" and any(
                    tuple(a.placements) != tuple(b.placements) for a, b in
                    zip(leaves(stm.master).values(), pm.values()))}


def _copy(tree):
    from repro_torch.models.module import tree_map
    return tree_map(lambda t: t.clone(), tree)


def misc_checks(mesh, rank, res, tmp):
    from repro_torch.distributed.sharding import (AbstractMesh, make_rules,
                                                  place, spec_placements)
    from repro_torch.launch.train import train
    from repro_torch.models.module import place_params
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params
    from repro_torch.training import checkpoint as C
    # a tuple axis: rank (d, m) holds block d * 2 + m of the dimension
    t = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    pl = spec_placements(mesh, (("data", "model"), None))
    dt = place(t, mesh, pl)
    d, m = int(mesh.get_local_rank("data")), int(mesh.get_local_rank("model"))
    blk = d * 2 + m
    res.setdefault("tuple_axis", {})[str(rank)] = bool(
        torch.equal(dt.to_local(), t[blk * 2:(blk + 1) * 2])
        and torch.equal(dt.full_tensor(), t))
    try:
        spec_placements(mesh, (("model", "data"), None))
        res["tuple_out_of_order_raises"] = False
    except ValueError:
        res["tuple_out_of_order_raises"] = True
    assert AbstractMesh((2, 2), ("data", "model")).size(1) == 2
    res.setdefault("shard_map_compat", {})[str(rank)] = _map_check(mesh)
    # a checkpoint of mesh parameters: the full tensors, read back onto
    # the rules' placements
    cfg = reduced("llama3.2-3b")
    specs = T.model_specs(cfg)
    rules = make_rules("train", mesh)
    p0 = init_params(specs, torch.Generator().manual_seed(0), "cpu")
    pm = place_params(_copy(p0), specs, rules)
    d_ = C.save(tmp, 3, {"params": pm})
    like = place_params({k: v for k, v in _copy(p0).items()}, specs, rules)
    like = _zero(like)
    back = C.restore(tmp, 3, {"params": like})["params"]
    ok = all(torch.equal(full(b), a) and tuple(b.placements)
             == tuple(c.placements) for a, b, c in zip(
                 leaves(p0).values(), leaves(back).values(),
                 leaves(pm).values()))
    ok &= d_.exists()
    res.setdefault("checkpoint", {})[str(rank)] = bool(ok)
    # drawn on the mesh: place_params's leaves, each rank's shard in a
    # storage of its own
    for arch in ARCHS:
        cfg = reduced(arch)
        specs = T.model_specs(cfg)
        drawn = init_params(specs, torch.Generator().manual_seed(5), "cpu",
                            rules)
        want = place_params(init_params(specs, torch.Generator().manual_seed(
            5), "cpu"), specs, rules)
        ok = all(torch.equal(a.to_local(), b.to_local())
                 and tuple(a.placements) == tuple(b.placements)
                 and a.shape == b.shape
                 and a.to_local().untyped_storage().nbytes()
                 == a.to_local().numel() * a.element_size()
                 for a, b in zip(leaves(drawn).values(),
                                 leaves(want).values()))
        res.setdefault("sharded_init", {})[f"{arch}/{rank}"] = bool(ok)
    # the production mesh wants 256 ranks
    try:
        train("llama3.2-3b", smoke=True, steps=1, batch=4, seq=8,
              use_mesh=True, device="cpu")
        res["production_world_error"] = ""
    except ValueError as e:
        res["production_world_error"] = str(e)


def _map_check(mesh) -> bool:
    """``shard_map_compat``: a body with a psum over "model" gives the
    full rows' sums, and a replicated input's gradient is the partial
    sums of every rank's shard, summed."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import (mesh_psum, place,
                                                  shard_map_compat)
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    xs = place(x, mesh, (Shard(0), Shard(1)))
    rows = shard_map_compat(
        lambda t: mesh_psum(t.sum(1, keepdim=True), mesh, ("model",)),
        mesh, ((Shard(0), Shard(1)),), (Shard(0), Replicate()))(xs)
    ok = tuple(rows.placements) == (Shard(0), Replicate())
    ok &= torch.equal(rows.full_tensor(), x.sum(1, keepdim=True))
    w = place(torch.full((1, 1), 3.0), mesh,
              (Replicate(), Replicate())).requires_grad_()
    y = shard_map_compat(lambda a, b: a * b, mesh,
                         ((Shard(0), Shard(1)), (Replicate(), Replicate())),
                         (Shard(0), Shard(1)))(xs, w)
    y.sum().backward()
    ok &= torch.equal(y.full_tensor(), 3 * x)
    ok &= torch.equal(w.grad.full_tensor(), x.sum().reshape(1, 1))
    return bool(ok)


def _zero(tree):
    from repro_torch.models.module import tree_map
    return tree_map(lambda t: t * 0, tree)


def decode_checks(mesh, rank, ref_npz, out_npz):
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch import steps as S_
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.convert import cache_from_numpy, params_from_numpy
    ref = np.load(ref_npz, allow_pickle=False)
    meta = {k: tuple(v) if isinstance(v, list) else v
            for k, v in json.loads(str(ref["config"])).items()}
    rules = make_rules("decode", mesh)
    got = {}
    for kind in ("full", "golden", "golden_cached"):
        cfg = ModelConfig(**dict(
            meta, attn_kind_decode="full" if kind == "full" else "golden",
            golden_cached_summaries=kind == "golden_cached"))
        tree = _unflat({k[len("p/"):]: ref[k] for k in ref.files
                        if k.startswith("p/")})
        params = params_from_numpy(cfg, tree, "cpu", rules)
        pre = f"c_{kind}/"
        cache = cache_from_numpy(cfg, _unflat(
            {k[len(pre):]: ref[k] for k in ref.files if k.startswith(pre)}),
            "cpu", rules)
        token = torch.from_numpy(ref["token"]).long()
        logits, cache = S_.make_decode_step(cfg, rules)(
            params, cache, token, int(ref["pos"]))
        got[kind] = full(logits).numpy()
        k0 = full(cache["l0"]["k"]).numpy()
        got[kind + "_k"] = k0
    if rank == 0:
        np.savez(out_npz, **got)


def _unflat(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, key = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[key] = v
    return out


def rank_main(rank, world, store_path, out, ref_npz):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_debug_device_mesh
    mesh = make_debug_device_mesh(2, 2, "cpu")
    res: dict = {}
    train_checks(mesh, rank, res)
    misc_checks(mesh, rank, res,
                os.path.join(os.path.dirname(store_path), "ckpt"))
    if ref_npz:
        decode_checks(mesh, rank, ref_npz, out + ".npz")
    gathered = [None] * world
    dist.all_gather_object(gathered, res)
    if rank == 0:
        merged = gathered[0]
        for key in ("tuple_axis", "checkpoint", "shard_map_compat",
                    "sharded_init"):
            merged[key] = {k: v for r in gathered for k, v in r[key].items()}
        with open(out, "w") as f:
            json.dump(merged, f, indent=1)
    dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    ref_npz = sys.argv[2] if len(sys.argv) > 2 else ""
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(rank_main, args=(4, os.path.join(d, "store"), out, ref_npz),
                 nprocs=4, join=True)
    print("PASS")
