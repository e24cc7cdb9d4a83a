"""Sharded execution of the golden store.

Counterpart of ``repro.distributed`` for the store's data sharding:

* :mod:`repro_torch.distributed.sharding`  -- the mesh interface
  (:class:`LocalMesh`: every shard in this process, several slices on
  one card or one a listed card; :class:`ProcessMesh`: one shard a rank
  of a ``torch.distributed`` group) and the cross-shard merges written
  once on gathered tensors: the two-stage top-k threshold
  (``crossshard_kth``, ``kth_from_gathered``), the gathered global top-k
  (``gather_global_topk``) and the log-sum-exp merge of softmax states
  (``lse_merge_mean``);
* :mod:`repro_torch.distributed.retrieval` -- the shard-local stages of
  a GoldDiff step and ``distributed_golden_denoise``.

The reference's logical-axis rules for the LLM (``Rules``,
``make_rules``, ``shard``) are not ported (ROADMAP Queue 1: the LLM's
logical sharding).
"""
from repro_torch.distributed.sharding import (LocalMesh, ProcessMesh,
                                              crossshard_kth,
                                              gather_global_topk,
                                              kth_from_gathered,
                                              lse_merge_mean)

__all__ = ["LocalMesh", "ProcessMesh", "crossshard_kth",
           "kth_from_gathered", "gather_global_topk", "lse_merge_mean"]
