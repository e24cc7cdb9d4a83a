"""Golden Index: clustered, time-aware retrieval for the coarse screen.

Counterpart of ``repro.index`` for one device:

* :mod:`repro_torch.index.build`    — k-means (k-means++ seeding,
  batched Lloyd iterations) over the proxy embedding, seeded by a
  ``torch.Generator``;
* :mod:`repro_torch.index.store`    — the immutable :class:`GoldenIndex`
  (centroids, cluster-sorted row permutation, CSR offsets, norms),
  ``save_index``/``load_index`` in the reference's file format, and
  ``index_from_numpy`` to carry a reference index across;
* :mod:`repro_torch.index.schedule` — :class:`ProbeSchedule`, the
  time-aware probe count nprobe_t;
* :mod:`repro_torch.index.ingest`   — :class:`StoreLifecycle`, the
  appendable capacity-padded store with epochs and a journal, in the
  reference's on-disk format (``StoreLifecycle.open_slab``: a committed
  epoch opened by every rank of a ``ProcessMesh`` without its rows, so
  that a rank reads its slab's alone).

``GoldDiffEngine(index=...)`` routes the coarse stage through it:
``ops.ivf_probe`` (on the card one launch of a hand-written kernel)
pools the query, scans the centroids and expands the probed CSR
windows, O(C d + nprobe_t L) instead of O(N d).
"""
from repro_torch.index.build import kmeans, kmeans_plusplus
from repro_torch.index.ingest import (CURRENT_FILE, JOURNAL_FILE,
                                      IngestConfig, SlabEpoch,
                                      StoreLifecycle)
from repro_torch.index.schedule import ProbeSchedule
from repro_torch.index.store import (GoldenIndex, StoreCapacityError,
                                     StoreCorruptionError, StoreError,
                                     StoreVersionError, build_index,
                                     default_num_clusters, index_from_numpy,
                                     load_index, save_index,
                                     screening_recall, validate_index)

__all__ = ["GoldenIndex", "build_index", "default_num_clusters",
           "index_from_numpy", "save_index", "load_index", "kmeans",
           "kmeans_plusplus", "ProbeSchedule", "screening_recall",
           "validate_index", "StoreError", "StoreCorruptionError",
           "StoreVersionError", "StoreCapacityError", "IngestConfig",
           "StoreLifecycle", "SlabEpoch", "CURRENT_FILE", "JOURNAL_FILE"]
