"""Sharded execution: the LLM's logical-axis sharding and the golden
store's data sharding (counterpart of ``repro.distributed``).

* :mod:`repro_torch.distributed.sharding` -- the LLM's rules
  (``Rules``, ``make_rules``, ``use_rules``, ``current_rules``,
  ``shard``, ``mesh_axis_size``, ``shard_map_compat``: logical axes
  resolved to DTensor placements on a ``DeviceMesh``); the store's mesh
  interface (:class:`LocalMesh`: every shard in this process, several
  slices on one card or one a listed card; :class:`ProcessMesh`: one
  shard a rank of a ``torch.distributed`` group or ``DeviceMesh``, NCCL
  on cards and gloo on the CPU) and the cross-shard
  merges written once on gathered tensors: the two-stage top-k
  threshold (``crossshard_kth``, ``kth_from_gathered``), the gathered
  global top-k (``gather_global_topk``) and the log-sum-exp merge of
  softmax states (``lse_merge_mean``);
* :mod:`repro_torch.distributed.retrieval` -- the shard-local stages of
  a GoldDiff step and ``distributed_golden_denoise``;
* :mod:`repro_torch.distributed.hlo_analysis` -- a traced step's
  per-device FLOPs, bytes, collectives and peak memory (the dry run's).
"""
from repro_torch.distributed.sharding import (LocalMesh, ProcessMesh, Rules,
                                              crossshard_kth, current_rules,
                                              gather_global_topk,
                                              kth_from_gathered,
                                              lse_merge_mean, make_rules,
                                              mesh_axis_size, shard,
                                              shard_map_compat, use_rules)

__all__ = ["LocalMesh", "ProcessMesh", "crossshard_kth",
           "kth_from_gathered", "gather_global_topk", "lse_merge_mean",
           "Rules", "make_rules", "use_rules", "current_rules", "shard",
           "mesh_axis_size", "shard_map_compat"]
