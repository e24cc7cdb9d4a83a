"""The appendable store lifecycle (``repro_torch.index.ingest``) held
against the reference's (``repro.index.ingest``): on gmm (N=512, dim 16,
where the proxy is the identity) the lifecycle's arrays, manifests and
journal are bit-equal to the reference's through the same appends,
reclusters into spares, the no-spare fallback and the capacity error;
stores open across the packages both ways; every ``commit(kill=)``
crash window and a torn journal recover bit-identically; each
``STORE_CORRUPTIONS`` kind raises the reference's error class and
``open(fallback=True)`` quarantines; an image store's appends agree
within 1e-6 with equal window choices."""
import os

import numpy as np
import pytest
import torch

import repro.index.ingest as r_ingest
from repro.data import gmm as r_gmm
from repro.data import make_dataset as r_make_dataset
from repro.index import StoreCapacityError as RStoreCapacityError
from repro.index import build_index as r_build_index
from repro.launch.faults import corrupt_store as r_corrupt_store
from repro_torch.core.dataset import store_from_numpy
from repro_torch.index import (CURRENT_FILE, JOURNAL_FILE, IngestConfig,
                               StoreCapacityError, StoreCorruptionError,
                               StoreLifecycle, StoreVersionError,
                               index_from_numpy, validate_index)
from repro_torch.launch.faults import STORE_CORRUPTIONS, corrupt_store

INDEX_FIELDS = ("centroids", "centroid_norms", "perm", "offsets",
                "proxy_sorted", "proxy_norms_sorted")


def ref_pair(kind="gmm", n=512, num_clusters=8):
    if kind == "gmm":
        store = r_gmm(n, dim=16, seed=3)
    else:
        store = r_make_dataset("cifar_like", n=n, seed=1)
    store = store._replace(labels=None)
    return store, r_build_index(store, num_clusters=num_clusters)


def port_pair(store, index):
    return (store_from_numpy(*(np.asarray(a) for a in (
                store.X, store.proxy, store.x_norms, store.proxy_norms)),
                store.image_shape, device="cpu"),
            index_from_numpy(*(np.asarray(getattr(index, f))
                               for f in INDEX_FIELDS),
                             max_cluster=index.max_cluster, device="cpu"))


def twins(tmp_path, cfg=None, kind="gmm", n=512, num_clusters=8):
    """The reference's lifecycle and the port's, created from one store."""
    store, index = ref_pair(kind, n, num_clusters)
    r_cfg = None if cfg is None else r_ingest.IngestConfig(
        cfg.slack, cfg.spare_frac, cfg.recluster_iters)
    ref = r_ingest.StoreLifecycle.create(str(tmp_path / "ref"), store, index,
                                         r_cfg)
    port = StoreLifecycle.create(str(tmp_path / "port"),
                                 *port_pair(store, index), cfg)
    return ref, port


def rows(b, dim=16, seed=100):
    return np.random.default_rng(seed).normal(size=(b, dim)).astype(
        np.float32)


def snapshot(lc):
    return {k: v.copy() for k, v in lc._arrays().items()}


def assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_files_equal(ref_root, port_root):
    """CURRENT, the journal and every epoch's manifest (per-array
    sha256, shapes, dtypes, meta) are byte-equal."""
    names = sorted(os.listdir(ref_root))
    assert names == sorted(os.listdir(port_root))
    for name in names:
        paths = [os.path.join(r, name) for r in (ref_root, port_root)]
        if os.path.isdir(paths[0]):
            paths = [os.path.join(p, "arrays.npz.manifest.json")
                     for p in paths]
        a, b = (open(p, "rb").read() for p in paths)
        assert a == b, name


class Kill(RuntimeError):
    pass


def kill_at(stage):
    def hook(s):
        if s == stage:
            raise Kill(stage)
    return hook


# -- bit-equality through appends ------------------------------------------------

@pytest.mark.parametrize("cfg, chunk", [
    (IngestConfig(), 40),                              # default layout
    (IngestConfig(slack=1.05, spare_frac=0.5), 64),    # reclusters to spares
    (IngestConfig(slack=1.0, spare_frac=0.01), 50),    # one spare, fallback
])
def test_appends_bit_equal_to_reference(tmp_path, cfg, chunk):
    ref, port = twins(tmp_path, cfg)
    assert_state_equal(snapshot(ref), snapshot(port))
    seed = 0
    while True:
        free = port.n_capacity - port.n_rows
        b = chunk if free >= chunk else free + 1
        batch = rows(b, seed=seed)
        seed += 1
        if b > free:
            with pytest.raises(RStoreCapacityError):
                ref.append(batch)
            with pytest.raises(StoreCapacityError):
                port.append(batch)
            break
        assert ref.append(batch) == port.append(batch)
        assert_state_equal(snapshot(ref), snapshot(port))
        if seed % 4 == 0:
            assert ref.commit() == port.commit()
    assert ref.commit() == port.commit()
    assert_state_equal(snapshot(ref), snapshot(port))
    assert_files_equal(ref.root, port.root)
    # every selectable row is a distinct dataset id (the index validates)
    _, ix = port.view(device="cpu")
    validate_index({f: getattr(ix, f).numpy() for f in INDEX_FIELDS},
                   ix.max_cluster)


def test_reclusters_and_fallback_happen(tmp_path):
    """The one-spare layout exercises both rare paths: a recluster into
    the spare, then, with no spare left, the nearest window with room."""
    _, port = twins(tmp_path, IngestConfig(slack=1.0, spare_frac=0.01))
    assert np.isinf(port._cnorm).sum() == 1
    port.append(rows(port.n_capacity - port.n_rows - 5, seed=7))
    assert np.isfinite(port._cnorm).all()       # the spare was taken
    assert (port._sizes == port.capacity).sum() >= 2


# -- cross-open ----------------------------------------------------------------------

def test_reference_writes_port_opens(tmp_path):
    ref, port = twins(tmp_path)
    ref.append(rows(24))
    ref.commit()
    ref.append(rows(8, seed=101))                # journaled, not committed
    opened = StoreLifecycle.open(ref.root)
    assert opened.epoch == 1 and opened.replayed_frames == 1
    assert_state_equal(snapshot(ref), snapshot(opened))


def test_port_writes_reference_opens(tmp_path):
    ref, port = twins(tmp_path)
    port.append(rows(24))
    port.commit()
    port.append(rows(8, seed=101))
    opened = r_ingest.StoreLifecycle.open(port.root)
    assert opened.epoch == 1 and opened.replayed_frames == 1
    assert_state_equal(snapshot(port), snapshot(opened))


# -- crash windows ---------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["epoch_written", "current_flipped",
                                   "journal_truncated"])
def test_kill_during_commit_recovers_bit_identical(tmp_path, stage):
    ref, port = twins(tmp_path)
    for lc in (ref, port):
        lc.append(rows(12))
    before = snapshot(port)
    for lc in (ref, port):
        with pytest.raises(Kill):
            lc.commit(kill=kill_at(stage))
    assert_files_equal(ref.root, port.root)
    for opener in (StoreLifecycle.open, r_ingest.StoreLifecycle.open):
        assert_state_equal(before, snapshot(opener(port.root)))
    again = StoreLifecycle.open(port.root)
    again.append(rows(4, seed=7))
    again.commit()
    assert_state_equal(snapshot(again),
                       snapshot(StoreLifecycle.open(port.root)))


def test_torn_journal_tail_replays_valid_prefix(tmp_path):
    _, port = twins(tmp_path)
    port.append(rows(8))
    mid = snapshot(port)
    port.append(rows(8, seed=101))
    j = os.path.join(port.root, JOURNAL_FILE)
    with open(j, "r+b") as f:
        f.truncate(os.path.getsize(j) - 10)
    lc2 = StoreLifecycle.open(port.root)
    assert lc2.replayed_frames == 1
    assert_state_equal(mid, snapshot(lc2))
    lc2.append(rows(4, seed=9))
    assert_state_equal(snapshot(lc2), snapshot(StoreLifecycle.open(port.root)))


def test_commit_without_pending_is_noop(tmp_path):
    _, port = twins(tmp_path)
    assert port.commit() == 0
    assert open(os.path.join(port.root, CURRENT_FILE)).read().strip() == \
        "epoch_00000000"


# -- corruption and quarantine ------------------------------------------------------------

@pytest.mark.parametrize("kind", STORE_CORRUPTIONS)
def test_corruptions_raise_the_reference_class_and_quarantine(tmp_path, kind):
    ref, port = twins(tmp_path)
    for lc, corrupt in ((ref, r_corrupt_store), (port, corrupt_store)):
        lc.append(rows(8))
        lc.commit()
        corrupt(os.path.join(lc.root, "epoch_00000001", "arrays.npz"),
                kind, seed=5)
    with pytest.raises(Exception) as r_err:
        r_ingest.StoreLifecycle.open(ref.root, fallback=False)
    with pytest.raises((StoreCorruptionError, StoreVersionError)) as p_err:
        StoreLifecycle.open(port.root, fallback=False)
    assert type(p_err.value).__name__ == type(r_err.value).__name__
    lc = StoreLifecycle.open(port.root)
    r_lc = r_ingest.StoreLifecycle.open(ref.root)
    assert lc.epoch == r_lc.epoch == 0
    assert [q[0] for q in lc.quarantined] == [q[0] for q in r_lc.quarantined]
    assert lc.replayed_frames == 0


# -- an image store ---------------------------------------------------------------------------

def test_image_store_appends_within_1e6(tmp_path):
    """cifar_like (32x32x3, proxy factor 4): the numpy pooling of
    appended rows agrees with the reference's JAX pooling to 1e-6 and
    every row lands in the same window."""
    ref, port = twins(tmp_path, IngestConfig(slack=1.05, spare_frac=0.5),
                      kind="cifar", n=256, num_clusters=8)
    new = np.random.default_rng(4).normal(size=(300, 3072)).astype(
        np.float32) * 0.5
    for i in range(0, 300, 60):
        ref.append(new[i:i + 60])
        port.append(new[i:i + 60])
    a, b = snapshot(ref), snapshot(port)
    for k in ("perm", "sizes", "offsets", "X", "x_norms"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("proxy", "proxy_sorted", "centroids"):
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    for k in ("proxy_norms", "proxy_norms_sorted", "centroid_norms"):
        fin = np.isfinite(a[k])
        np.testing.assert_array_equal(fin, np.isfinite(b[k]))
        np.testing.assert_allclose(a[k][fin], b[k][fin], rtol=1e-6, atol=0)


# -- views -------------------------------------------------------------------------------------

def test_view_copies_and_keeps_shapes(tmp_path):
    _, port = twins(tmp_path)
    ds, ix = port.view(device="cpu")
    x0, ps0 = ds.X.clone(), ix.proxy_sorted.clone()
    port.append(rows(32))
    port.commit()
    assert torch.equal(ds.X, x0) and torch.equal(ix.proxy_sorted, ps0)
    ds1, ix1 = port.view(device="cpu")
    assert ds1.X.shape == ds.X.shape and ix1.max_cluster == ix.max_cluster
    assert torch.equal(ix1.offsets, ix.offsets)
    assert ix1.perm.dtype == torch.int64


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card "
                    "error; on the card view() runs there")
def test_view_runs_on_the_card_unless_asked(tmp_path):
    _, port = twins(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.view()
