"""Carry the reference's parameters and caches across to the port.

The port cannot redraw ``jax.random``'s weights, so tests hand the
reference's pytrees over as nested dicts of numpy arrays (bf16 leaves
arrive as ml_dtypes arrays and go through float32, which is exact).
Every leaf of the port's spec tree must be present with its shape, and
no other: a missing or extra leaf, or a wrong shape, raises
``ValueError``.  Given ``rules`` with a mesh, the converted leaves are
placed on their ``param_shardings`` (a cache's on its logical axes'
placements), so one set of weights feeds the one-process and the
sharded port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.module import place_tree, tree_leaves
from repro_torch.models.transformer import cache_specs, model_specs
from repro_torch.utils import resolve_device


def _convert(want: dict, tree, what: str, device) -> dict:
    """``want``: path -> (shape, dtype); ``tree``: nested dict of arrays."""
    got = dict(tree_leaves(tree))
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{what}: missing leaves {missing}, extra leaves "
                         f"{extra}")
    out: dict = {}
    for path, (shape, dtype) in want.items():
        arr = np.asarray(got[path])
        if arr.shape != tuple(shape):
            raise ValueError(f"{what}: {path} has shape {arr.shape}, "
                             f"expected {tuple(shape)}")
        node = out
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = torch.from_numpy(np.array(arr, np.float32)).to(
            device=device, dtype=dtype)
    return out


def params_from_numpy(cfg: ModelConfig, tree, device=None,
                      rules=None) -> dict:
    """The reference's parameter pytree (``embed``, ``blocks/l{i}/...``,
    ``final_norm``, ``lm_head`` when untied) as the port's tensors, on
    ``device`` (the CUDA card unless the caller names another); DTensors
    on ``param_shardings(model_specs(cfg), rules)`` under a mesh."""
    device = resolve_device(device)
    specs = dict(tree_leaves(model_specs(cfg)))
    want = {path: (s.shape, s.dtype) for path, s in specs.items()}
    out = _convert(want, tree, "params_from_numpy", device)
    return out if rules is None else place_tree(
        out, {p: s.logical_axes for p, s in specs.items()}, rules)


def cache_from_numpy(cfg: ModelConfig, tree, device=None,
                     rules=None) -> dict:
    """The reference's decode cache (``l{i}/{k, v[, summ]}``, each
    ``[repeats, B, Hkv, S | nb, dh]``, and ``l{i}/{conv, ssm}`` of a
    Mamba layer) as the port's tensors, on ``device`` (the CUDA card
    unless the caller names another).  B comes from any leaf, S from the
    first attention layer's ``k`` (a cache without attention has none)."""
    device = resolve_device(device)
    leaves = dict(tree_leaves(tree))
    if not leaves or any(np.ndim(v) < 2 for v in leaves.values()):
        raise ValueError("cache_from_numpy: no [repeats, B, ...] leaves")
    batch = np.shape(next(iter(leaves.values())))[1]
    seq_len = 0                          # unused by a Mamba layer's specs
    for i in range(cfg.period):
        if cfg.mixer_kind(i) == "A":
            try:
                _, _, _, seq_len, _ = np.shape(tree[f"l{i}"]["k"])
            except (KeyError, TypeError, ValueError) as err:
                raise ValueError(f"cache_from_numpy: no [repeats, B, Hkv, "
                                 f"S, dh] leaf l{i}/k ({err})") from err
            break
    specs = dict(tree_leaves(cache_specs(cfg, batch, seq_len)))
    want = {path: (shp, dt) for path, (shp, _, dt) in specs.items()}
    out = _convert(want, tree, "cache_from_numpy", device)
    return out if rules is None else place_tree(
        out, {p: ax for p, (_, ax, _) in specs.items()}, rules)
