"""A rank that holds only its slab (``StoreLifecycle.open_slab``).

The epoch is written by the reference's ``StoreLifecycle.create`` (and
one ``append`` + ``commit``) from a numpy-seeded 16x16x3 image store of
N = 8192 rows, whose capacity-padded epoch holds n_cap = 24354 rows
(X 75 MB, about 6x the allowance above a slab: ``_slab_ranks``'s
``HOST_FIXED`` and the small arrays).  ``tests/_slab_ranks.py`` opens it
by slab on 4 gloo ranks (forked once for the module) and the tests hold:

* every rank's ``select`` bit-equal to the port's one-process engine over
  ``StoreLifecycle.open(root).view("cpu")`` with the ranks' layout (a
  ``LocalMesh`` of 4), and the same rows as the unsharded engine's up to
  ties at the cut; ``denoise`` / ``denoise_masked`` / ``full_scan``
  within ``REL`` of both, exact and indexed;
  the Wiener rung's statistics and the PCA bases against one process;
* the ranks bit-equal to each other;
* each rank's ``RssAnon + RssFile`` delta after ``open_slab``, the
  engines, ``ServeRuntime.warmup()`` and the PCA caches within the bound
  (``_slab_ranks.host_bound``), and the same ranks opening the epoch
  whole over it;
* a flipped byte of the current epoch's ``X`` raising one typed error on
  every rank (``fallback=False``) or falling back alike, with
  ``StoreLifecycle.open``'s ``quarantined`` list; a pending journal
  raising one ``StoreError`` on every rank;
* and, in one process, the arrays ``open_slab`` reads in place equal to
  ``load_arrays``' for an epoch written by each package, and the
  in-place reader's refusals.

The module's ranks take about 10 s; the file about 20 s alone, every
thread pool held to one.
"""
import json
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import repro.index.ingest as r_ingest
from repro.core import make_schedule as r_make_schedule
from repro.core.dataset import make_store as r_make_store
from repro.index import build_index as r_build_index
from repro_torch.core import (GoldDiffEngine, PCADenoiser, make_schedule,
                              store_from_numpy)
from repro_torch.distributed import LocalMesh
from repro_torch.index import (StoreCorruptionError, StoreLifecycle,
                               index_from_numpy)
from repro_torch.index.ingest import EPOCH_FORMAT, EPOCH_FORMAT_VERSION
from repro_torch.index.shard import file_backed, host_rows
from repro_torch.utils import atomic

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import _slab_ranks as SR  # noqa: E402

REL = 1e-5
N = 8192
WORLD = SR.WORLD
TS = SR.TS
ROW_ARRAYS = ("X", "proxy", "proxy_sorted")
INDEX_FIELDS = ("centroids", "centroid_norms", "perm", "offsets",
                "proxy_sorted", "proxy_norms_sorted")
SPAWN_TIMEOUT_S = 300


def relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def image_rows(n: int, seed: int = 0) -> np.ndarray:
    """[n, 16, 16, 3] images around 48 random centres."""
    rng = np.random.default_rng(seed)
    cents = rng.uniform(-1, 1, (48,) + SR.IMG_SHAPE).astype(np.float32)
    return (cents[rng.integers(0, 48, n)] + 0.35 * rng.standard_normal(
        (n,) + SR.IMG_SHAPE, np.float32)).astype(np.float32)


def write_epochs(work: str) -> None:
    """The reference's epochs (``store``, ``flip``, ``pending``) and the
    queries, as ``_slab_ranks`` reads them."""
    x = image_rows(N)
    st = r_make_store(x, SR.IMG_SHAPE)
    root = os.path.join(work, "store")
    lc = r_ingest.StoreLifecycle.create(root, st, r_build_index(st))
    rng = np.random.default_rng(1)
    new = (x[rng.integers(0, N, N // 16)].reshape(N // 16, -1)
           + 0.1 * rng.standard_normal((N // 16, x[0].size), np.float32))
    lc.append(new.astype(np.float32))
    lc.commit()
    shutil.copytree(root, os.path.join(work, "flip"))
    npz = os.path.join(work, "flip", "epoch_00000001", "arrays.npz")
    m = atomic.stored_members(npz)["X"]
    at = m.offset + m.nbytes // 2 + 1
    with open(npz, "r+b") as f:
        f.seek(at)
        b = f.read(1)
        f.seek(at)
        f.write(bytes([b[0] ^ 0x10]))
    shutil.copytree(root, os.path.join(work, "pending"))
    r_ingest.StoreLifecycle.open(os.path.join(work, "pending")).append(
        new[:8].astype(np.float32))
    sch = r_make_schedule("ddpm_linear", 1000)
    xs = {}
    for t in TS:
        r = np.random.default_rng(t)
        x0 = x[r.integers(0, N, 4)].reshape(4, -1)
        xs[f"x_{t}"] = (float(sch.a[t]) * x0 + float(sch.b[t])
                        * r.standard_normal(x0.shape)).astype(np.float32)
    np.savez(os.path.join(work, "inputs.npz"), **xs)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch and the BLAS on one thread for the module: under the suite's
    workers, threads fighting over the cores made its references take
    minutes rather than seconds."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def slab(tmp_path_factory):
    """The ranks' outputs and the one-process references."""
    work = str(tmp_path_factory.mktemp("slab"))
    write_epochs(work)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"), HERE]),
        OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(HERE,
                                                        "_slab_ranks.py"),
                           work], env=env, capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0 and "PASS" in proc.stdout, proc.stderr[-4000:]
    ranks = [dict(np.load(os.path.join(work, f"rank_{r}.npz")))
             for r in range(WORLD)]
    store, ix = StoreLifecycle.open(os.path.join(work, "store")).view("cpu")
    return dict(work=work, ranks=ranks, store=store, index=ix,
                inputs=dict(np.load(os.path.join(work, "inputs.npz"))))


@pytest.fixture(scope="module")
def one(slab):
    """The one-process engines over the epoch's whole view at ``TS``,
    exact and indexed: unsharded, and over a ``LocalMesh`` of ``WORLD``
    shards (the ranks' layout in one process)."""
    sch = make_schedule("ddpm_linear", 1000)
    st, ix = slab["store"], slab["index"]
    out = {}
    for tag, kw in (("exact", {}),
                    ("indexed", dict(index=ix, index_mode="always"))):
        for where, mesh in (("one", None),
                            ("local", LocalMesh((WORLD,), ("data",)))):
            eng = GoldDiffEngine(st, sch, device="cpu", mesh=mesh, **kw)
            for t in TS:
                x = torch.from_numpy(slab["inputs"][f"x_{t}"])
                pre = f"{where}_{tag}"
                out[f"{pre}_select_{t}"] = eng.select(x, t).numpy()
                out[f"{pre}_denoise_{t}"] = eng.denoise(x, t).numpy()
                out[f"{pre}_masked_{t}"] = eng.denoise_masked(x, t).numpy()
                if tag == "exact":
                    out[f"{pre}_full_{t}"] = eng.full_scan(x, t).numpy()
    return out


def cut_ties_only(got, want, q, X) -> bool:
    """Whether two supports [B, k] hold the same rows but for rows at the
    cut: every row in one and not the other lies within 1e-6 (relative)
    of the k-th distance (a shard's distances may differ from one card's
    in the last bit, as ``chip_smoke.py``'s [sharded] allows)."""
    for b in range(got.shape[0]):
        odd = np.setxor1d(got[b], want[b])
        if odd.size == 0:
            continue
        d = ((X[want[b]] - q[b]) ** 2).sum(-1, dtype=np.float64)
        kth = d.max()
        do = ((X[odd] - q[b]) ** 2).sum(-1, dtype=np.float64)
        if np.abs(do - kth).max() > 1e-6 * kth:
            return False
    return True


@pytest.mark.parametrize("kind", ["exact", "indexed"])
def test_slab_select_matches_one_process(slab, one, kind):
    """Bit-equal to one process over the view with the ranks' layout
    (``LocalMesh``); the same rows as the unsharded engine up to ties at
    the cut."""
    sch = make_schedule("ddpm_linear", 1000)
    X = slab["store"].X.numpy()
    for t in TS:
        q = slab["inputs"][f"x_{t}"] / float(sch.a[t])
        for r, got in enumerate(slab["ranks"]):
            sel = got[f"{kind}_select_{t}"]
            np.testing.assert_array_equal(
                sel, one[f"local_{kind}_select_{t}"],
                err_msg=f"rank {r} t={t}")
            assert cut_ties_only(sel, one[f"one_{kind}_select_{t}"], q, X), \
                (r, t)


@pytest.mark.parametrize("kind", ["exact", "indexed"])
def test_slab_means_match_one_process(slab, one, kind):
    for t in TS:
        for what in ("denoise", "masked") + (("full",) if kind == "exact"
                                             else ()):
            key = f"{kind}_{what}_{t}"
            for got in slab["ranks"]:
                assert relerr(got[key], one[f"one_{key}"]) <= REL, key
                assert relerr(got[key], one[f"local_{key}"]) <= REL, key


def test_slab_ranks_bit_equal(slab):
    r0 = slab["ranks"][0]
    for r, got in enumerate(slab["ranks"][1:], 1):
        for key, v in r0.items():
            if key in ("mem", "whole_mem"):
                continue
            np.testing.assert_array_equal(got[key], v, err_msg=f"rank {r} "
                                          f"{key}")


def test_slab_epoch_geometry(slab):
    st, ix = slab["store"], slab["index"]
    for got in slab["ranks"]:
        assert int(got["epoch"]) == 1
        assert got["n_dim"].tolist() == [st.n, st.dim, ix.max_cluster]


def test_slab_wiener_and_pca_match_one_process(slab):
    """The Wiener rung's statistics from the slabs' sums, and rank 0's
    PCA bases from its drawn rows, against one process on the view."""
    sch = make_schedule("ddpm_linear", 1000)
    st = slab["store"]
    # the one-process rung's statistics (``WienerDenoiser``'s SVD form,
    # as the covariance's eigenvalues: the same numbers, a fraction of
    # the time)
    x = st.X.numpy().astype(np.float64)
    mu = x.mean(0)
    lam = np.linalg.eigvalsh(x.T @ x / x.shape[0] - np.outer(mu, mu))[::-1]
    got = slab["ranks"][0]
    assert relerr(got["wiener_mu"], mu) <= REL
    assert relerr(got["wiener_lam"], np.clip(lam, 0.0, None)) <= 1e-4
    pca = PCADenoiser(st, sch, device="cpu")
    keys = [k for k in got if k.startswith("pca_basis_")]
    assert len(keys) >= 1
    for k in keys:
        np.testing.assert_array_equal(
            got[k], pca._basis(int(k.rsplit("_", 1)[1])).numpy(),
            err_msg=k)


@pytest.mark.parametrize("point", ["open", "engine", "warmup", "pca"])
def test_slab_host_bytes_under_gate(slab, point):
    """Each rank's resident bytes over its first reading, after each
    point, within ``HOST_SLACK`` x the slabs it holds on the host plus
    the small arrays, ``HOST_FIXED`` and the point's own terms (the
    Wiener rung's mu, V and eigenvalues; the PCA feature caches, the
    slot map and rank 0's drawn rows)."""
    for r, got in enumerate(slab["ranks"]):
        m = json.loads(str(got["mem"]))[point]
        assert m["delta"] <= m["bound"], (r, point, m)


def test_whole_store_rank_fails_the_gate(slab):
    """The same ranks opening the epoch whole exceed the bound the slab
    ranks keep, at the engines' point, by more than the store's rows
    over a slab's; and the epoch is several times the allowance over a
    slab, so the gate can tell them apart."""
    st = slab["store"]
    rows = sum(t.numel() * 4 for t in (st.X, st.proxy, slab["index"]
                                       .proxy_sorted))
    for r, got in enumerate(slab["ranks"]):
        m = json.loads(str(got["whole_mem"]))["engine"]
        assert m["delta"] > m["bound"], (r, m)
        slab_m = json.loads(str(got["mem"]))["open"]
        allowance = slab_m["bound"] - int(SR.HOST_SLACK * slab_m["slab"])
        assert rows >= 4 * allowance + rows // WORLD, (rows, allowance)


def test_flipped_byte_raises_alike(slab):
    errs = {str(got["flip_False"]) for got in slab["ranks"]}
    assert len(errs) == 1
    (err,) = errs
    assert err.startswith("StoreCorruptionError: ") and "'X'" in err
    with pytest.raises(StoreCorruptionError):
        StoreLifecycle.open(os.path.join(slab["work"], "flip"),
                            fallback=False)


def test_flipped_byte_falls_back_alike(slab):
    got = {str(g["flip_True"]) for g in slab["ranks"]}
    assert len(got) == 1
    res = json.loads(got.pop())
    lc = StoreLifecycle.open(os.path.join(slab["work"], "flip"))
    assert res["epoch"] == lc.epoch == 0
    # the same epochs quarantined as ``open``; the message is the in-place
    # reader's (the streamed sha256), where ``np.load`` trips the zip CRC
    assert [q[0] for q in res["quarantined"]] == \
        [q[0] for q in lc.quarantined] == ["epoch_00000001"]
    assert "'X' checksum mismatch" in res["quarantined"][0][1]


def test_pending_journal_raises_alike(slab):
    errs = {str(got["pending"]) for got in slab["ranks"]}
    assert len(errs) == 1
    (err,) = errs
    assert err.startswith("StoreError: ") and "commit()" in err


# -- in place, one process ---------------------------------------------------------------

def epoch_npz(tmp_path, writer: str) -> str:
    """A small epoch written by ``writer`` ("reference" or "port")."""
    x = image_rows(512, seed=3)
    st = r_make_store(x, SR.IMG_SHAPE)
    ix = r_build_index(st, num_clusters=8)
    root = str(tmp_path / writer)
    if writer == "reference":
        r_ingest.StoreLifecycle.create(root, st, ix)
    else:
        StoreLifecycle.create(
            root, store_from_numpy(*(np.asarray(a) for a in (
                st.X, st.proxy, st.x_norms, st.proxy_norms)),
                SR.IMG_SHAPE, device="cpu"),
            index_from_numpy(*(np.asarray(getattr(ix, f))
                               for f in INDEX_FIELDS),
                             max_cluster=ix.max_cluster, device="cpu"))
    return os.path.join(root, "epoch_00000000", "arrays.npz")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_in_place_arrays_equal_load_arrays(tmp_path, writer):
    npz = epoch_npz(tmp_path, writer)
    whole, meta = atomic.load_arrays(npz, EPOCH_FORMAT, EPOCH_FORMAT_VERSION)
    got, meta2 = atomic.load_arrays(npz, EPOCH_FORMAT, EPOCH_FORMAT_VERSION,
                                    in_place=ROW_ARRAYS)
    assert meta == meta2 and got.keys() == whole.keys()
    rng = np.random.default_rng(0)
    for k, v in whole.items():
        if k not in ROW_ARRAYS:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            continue
        np.testing.assert_array_equal(np.asarray(got[k].map()), v, err_msg=k)
        t = file_backed(got[k])
        np.testing.assert_array_equal(t.numpy(), v, err_msg=k)
        rows = rng.integers(0, v.shape[0], 200)
        np.testing.assert_array_equal(host_rows(t, rows), v[rows],
                                      err_msg=k)
        out = np.zeros((300,) + v.shape[1:], v.dtype)
        dst = rng.permutation(300)[:200]
        host_rows(t, rows, out, dst)
        np.testing.assert_array_equal(out[dst], v[rows], err_msg=k)
        assert got[k].sha256() == atomic.sha256_hex(v)


def _rezip(npz: str, out: str, compression=zipfile.ZIP_STORED,
           edit=None) -> str:
    """``npz`` rewritten member by member (``edit(name, bytes)`` may
    change a member), its manifest copied beside it."""
    with zipfile.ZipFile(npz) as zin, zipfile.ZipFile(
            out, "w", compression=compression) as zout:
        for info in zin.infolist():
            data = zin.read(info)
            zout.writestr(info.filename, data if edit is None
                          else edit(info.filename, data))
    shutil.copy(npz + ".manifest.json", out + ".manifest.json")
    return out


def _fortran(name, data):
    return (data.replace(b"'fortran_order': False", b"'fortran_order': True ")
            if name == "X.npy" else data)


def _short(name, data):
    return data[:-64] if name == "X.npy" else data


@pytest.mark.parametrize("case,edit,match", [
    ("compressed", None, "compressed"),
    ("fortran", _fortran, "Fortran"),
    ("short", _short, "bytes"),
])
def test_in_place_refusals(tmp_path, case, edit, match):
    npz = epoch_npz(tmp_path, "port")
    bad = _rezip(npz, str(tmp_path / f"{case}.npz"),
                 zipfile.ZIP_DEFLATED if case == "compressed"
                 else zipfile.ZIP_STORED, edit)
    with pytest.raises(StoreCorruptionError, match=match):
        atomic.load_arrays(bad, EPOCH_FORMAT, EPOCH_FORMAT_VERSION,
                           in_place=ROW_ARRAYS,
                           corruption_exc=StoreCorruptionError)


@pytest.mark.parametrize("case", ["compressed", "short"])
def test_whole_arrays_load_as_before(tmp_path, case):
    """Read whole (no ``in_place``), a compressed member still loads and a
    member cut short still raises the corruption class."""
    npz = epoch_npz(tmp_path, "port")
    whole, _ = atomic.load_arrays(npz, EPOCH_FORMAT, EPOCH_FORMAT_VERSION)
    bad = _rezip(npz, str(tmp_path / f"{case}.npz"),
                 zipfile.ZIP_DEFLATED if case == "compressed"
                 else zipfile.ZIP_STORED,
                 _short if case == "short" else None)
    if case == "short":
        with pytest.raises(StoreCorruptionError, match="unreadable npz"):
            atomic.load_arrays(bad, EPOCH_FORMAT, EPOCH_FORMAT_VERSION,
                               corruption_exc=StoreCorruptionError)
        return
    got, _ = atomic.load_arrays(bad, EPOCH_FORMAT, EPOCH_FORMAT_VERSION)
    for k, v in whole.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("cap", [1000, 5 * 3072 + 7])
def test_read_rows_takes_short_counts(tmp_path, monkeypatch, cap):
    """``read_rows`` reads on after a short ``os.preadv`` count (Linux
    returns at most about 2 GiB a call, so a slab over that comes back
    in parts): with every call cut to ``cap`` bytes (less than a row;
    several rows and a piece of one) the rows still come out whole, in
    more calls than runs."""
    npz = epoch_npz(tmp_path, "port")
    whole, _ = atomic.load_arrays(npz, EPOCH_FORMAT, EPOCH_FORMAT_VERSION)
    got, _ = atomic.load_arrays(npz, EPOCH_FORMAT, EPOCH_FORMAT_VERSION,
                                in_place=ROW_ARRAYS)
    real, calls = os.preadv, []

    def short(fd, bufs, pos):
        left, cut = cap, []
        for b in bufs:
            if left <= 0:
                break
            cut.append(memoryview(b)[:left])
            left -= len(cut[-1])
        calls.append(real(fd, cut, pos))
        return calls[-1]

    monkeypatch.setattr(os, "preadv", short)
    x = whole["X"]
    assert x.shape[1] * 4 == 3072
    rows = np.concatenate([np.arange(40, 140), np.random.default_rng(2)
                           .integers(0, x.shape[0], 100)])
    np.testing.assert_array_equal(got["X"].read_rows(rows), x[rows])
    assert len(calls) > 100 * 3072 // cap
    assert max(calls) <= cap


def test_read_rows_past_the_end_raises(tmp_path):
    """A read that finds the file ending before its rows (a call that
    reads nothing) raises ``EOFError``."""
    npz = epoch_npz(tmp_path, "port")
    got, _ = atomic.load_arrays(npz, EPOCH_FORMAT, EPOCH_FORMAT_VERSION,
                                in_place=ROW_ARRAYS)
    x = got["X"]
    size = os.path.getsize(npz)
    past = x._replace(shape=((size - x.offset) // x.row_bytes + 8,)
                      + x.shape[1:])
    with pytest.raises(EOFError, match="truncated"):
        past.read_rows(np.arange(past.shape[0] - 4, past.shape[0]))


@pytest.mark.parametrize("shards", [2, 4])
def test_capacity_padded_layout_holds_no_second_row(tmp_path, shards):
    """A capacity-padded epoch's empty window slots (``perm`` naming row
    0, +inf ``proxy_norms_sorted``) hold no row in the sharded layout: a
    query at row 0 on the indexed route over a ``LocalMesh`` gets row 0
    once in its support, and the support the unsharded engine gives
    (the reference's layout copies row 0 into those slots, so a probe of
    their window ranks a second copy of it)."""
    npz = epoch_npz(tmp_path, "port")
    st, ix = StoreLifecycle.open(os.path.dirname(os.path.dirname(npz))) \
        .view("cpu")
    empty = (~torch.isfinite(ix.proxy_norms_sorted)
             & torch.isfinite(st.proxy_norms[ix.perm]))
    assert int((ix.perm[empty] == 0).sum()) == int(empty.sum()) > 0
    sch = make_schedule("ddpm_linear", 1000)
    t = 100
    x = torch.stack([st.X[0], st.X[7]]) * float(sch.a[t])
    kw = dict(index=ix, index_mode="always", device="cpu")
    want = GoldDiffEngine(st, sch, **kw).select(x, t).numpy()
    eng = GoldDiffEngine(st, sch, mesh=LocalMesh((shards,), ("data",)), **kw)
    got = eng.select(x, t).numpy()
    for b in range(got.shape[0]):
        assert np.unique(got[b]).size == got.shape[1], (b, got[b])
    assert int((got[0] == 0).sum()) == 1
    assert cut_ties_only(got, want, x.numpy() / float(sch.a[t]),
                         st.X.numpy())
    slab = eng._layout.slabs[0]
    pad = ~torch.isfinite(slab.x_norms)
    assert bool((slab.ids[pad] == 0).all())
