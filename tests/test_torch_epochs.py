"""Engine epochs on operand slots (``GoldDiffEngine.install_epoch`` and
friends) and the runtime's hot swap, held against the reference: the
reasons ``swap_compat`` gives, install / flip / pin / retire with no
build, slot recycling, the full scan over a capacity-padded view
against the unpadded store, the padded indexed support (no empty slot
weighs), and the scripted hot-swap scenarios run on both runtimes
(``_runtime_parity``).  gmm (N=512, dim 16, 8 windows) on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.launch.serve as r_serve
from _runtime_parity import (ENG_KW, PORT, REF, FakeClock, assert_same,
                             fresh, plan_alone, run_both)
from repro.core import GoldDiffEngine as RGoldDiffEngine
from repro.core import make_schedule as r_make_schedule
from repro.data import gmm as r_gmm
from repro.index import IngestConfig as RIngestConfig
from repro.index import StoreLifecycle as RLifecycle
from repro.index import build_index as r_build_index
from repro_torch.core import GoldDiffEngine, make_schedule
from repro_torch.core.engine import STANDBY_EPOCH
from repro_torch.core.dataset import store_from_numpy
from repro_torch.index import IngestConfig, StoreLifecycle, index_from_numpy
from repro_torch.launch.serve import Request, ServeEngine

INDEX_FIELDS = ("centroids", "centroid_norms", "perm", "offsets",
                "proxy_sorted", "proxy_norms_sorted")


def port_pair(store, index):
    """A reference (store, index) carried to the port on the CPU."""
    return (store_from_numpy(*(np.asarray(a) for a in (
                store.X, store.proxy, store.x_norms, store.proxy_norms)),
                store.image_shape, device="cpu"),
            index_from_numpy(*(np.asarray(getattr(index, f))
                               for f in INDEX_FIELDS),
                             max_cluster=index.max_cluster, device="cpu"))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    store = r_gmm(512, dim=16, seed=3)._replace(labels=None)
    index = r_build_index(store, num_clusters=8)
    p_store, p_index = port_pair(store, index)
    lc = StoreLifecycle.create(str(tmp_path_factory.mktemp("epochs")),
                               p_store, p_index, IngestConfig())
    ds0, ix0 = lc.view(device="cpu")
    eng = GoldDiffEngine(ds0, make_schedule("ddpm_linear", 1000),
                         index=ix0, index_mode="always", device="cpu")
    r_ds0, r_ix0 = RLifecycle.create(
        str(tmp_path_factory.mktemp("epochs_ref")), store, index,
        RIngestConfig()).view()
    r_eng = RGoldDiffEngine(r_ds0, r_make_schedule("ddpm_linear", 1000),
                            index=r_ix0, index_mode="always")
    return dict(lc=lc, eng=eng, ds0=ds0, ix0=ix0, r_eng=r_eng, r_ds0=r_ds0,
                r_ix0=r_ix0, store=store, index=index, p_store=p_store,
                p_index=p_index)


def query(seed=0, b=4):
    return np.random.default_rng(seed).normal(size=(b, 16)).astype(np.float32)


# -- swap_compat --------------------------------------------------------------

def _variants(env):
    """(name, port (store, index), reference (store, index)) pairs that
    each break one static ingredient."""
    other = r_gmm(256, dim=16, seed=9)._replace(labels=None)
    other_ix = r_build_index(other, num_clusters=8)
    four = r_build_index(env["store"], num_clusters=4)
    wide = env["r_ix0"]._replace(max_cluster=env["r_ix0"].max_cluster + 1)
    offs = np.asarray(env["r_ix0"].offsets).copy()
    offs[1] += 1
    shifted = env["r_ix0"]._replace(offsets=jnp.asarray(offs))

    def port_ix(ix):
        return index_from_numpy(*(np.asarray(getattr(ix, f))
                                  for f in INDEX_FIELDS),
                                max_cluster=ix.max_cluster, device="cpu")
    return [
        ("store shape", port_pair(other, other_ix), (other, other_ix)),
        ("indexed-ness", (env["ds0"], None), (env["r_ds0"], None)),
        ("num_clusters", (env["ds0"], port_ix(four)), (env["r_ds0"], four)),
        ("max_cluster", (env["ds0"], port_ix(wide)), (env["r_ds0"], wide)),
        ("CSR offsets", (env["ds0"], port_ix(shifted)),
         (env["r_ds0"], shifted)),
    ]


@pytest.mark.parametrize("case", range(5))
def test_swap_compat_reasons_match_reference(env, case):
    name, (ds, ix), (r_ds, r_ix) = _variants(env)[case]
    reason = env["eng"].swap_compat(ds, ix)
    assert name in reason
    assert reason == env["r_eng"].swap_compat(r_ds, r_ix)
    with pytest.raises(ValueError, match="cannot hot-swap"):
        env["eng"].install_epoch(99, ds, ix)
    assert 99 not in env["eng"]._epochs
    assert env["eng"].swap_compat(env["ds0"], env["ix0"]) is None


# -- install, flip, pin, retire; slots -----------------------------------------

def test_epoch_swap_sequence_and_slots(tmp_path, env):
    p_store, p_index = env["p_store"], env["p_index"]
    lc = StoreLifecycle.create(str(tmp_path), p_store, p_index,
                               IngestConfig())
    ds0, ix0 = lc.view(device="cpu")
    eng = GoldDiffEngine(ds0, make_schedule("ddpm_linear", 1000), index=ix0,
                         index_mode="always", device="cpu")
    x = torch.from_numpy(query())
    y0 = eng.denoise(x, 300)
    assert eng.reserve_standby() == [0, STANDBY_EPOCH]
    assert eng._epochs == {0: 0, STANDBY_EPOCH: 1}
    assert eng.X.data_ptr() != ds0.X.data_ptr()   # slot 0 owns its rows
    with eng.at_epoch(STANDBY_EPOCH):             # the standby: a copy
        torch.testing.assert_close(eng.denoise(x, 300), y0, rtol=0, atol=0)
    eng.retire_epoch(STANDBY_EPOCH)
    assert eng._free_slots == [1]
    grow(lc, 48, seed=42)
    ds1, ix1 = lc.view(device="cpu")
    b0 = eng._builds
    eng.install_epoch(1, ds1, ix1)
    assert eng._epochs == {0: 0, 1: 1} and eng._free_slots == []
    eng.set_serving_epoch(1)
    y1 = eng.denoise(x, 300)
    assert not torch.equal(y0, y1)                  # the new rows serve
    with eng.at_epoch(0):
        torch.testing.assert_close(eng.denoise(x, 300), y0, rtol=0, atol=0)
    with pytest.raises(ValueError, match="serving"):
        eng.retire_epoch(1)
    eng.retire_epoch(0)
    assert eng._free_slots == [0] and sorted(eng._epochs) == [1]
    # the next epoch recycles slot 0 in place; the caller's view is intact
    ds0_x = ds0.X.clone()
    grow(lc, 16, seed=43)
    ds2, ix2 = lc.view(device="cpu")
    eng.install_epoch(2, ds2, ix2)
    assert eng._epochs[2] == 0 and torch.equal(ds0.X, ds0_x)
    # a third live epoch takes a new slot, freed again on retirement
    grow(lc, 8, seed=44)
    ds3, ix3 = lc.view(device="cpu")
    eng.install_epoch(3, ds3, ix3)
    assert eng._epochs[3] == 2 and sorted(eng._slots) == [0, 1, 2]
    eng.retire_epoch(3)
    assert sorted(eng._slots) == [0, 1] and eng._free_slots == []
    assert eng._builds == b0
    with pytest.raises(KeyError):
        eng.set_serving_epoch(99)


def test_appends_after_install_leave_the_epoch_alone(tmp_path, env):
    lc = StoreLifecycle.create(str(tmp_path), env["p_store"],
                               env["p_index"], IngestConfig())
    ds, ix = lc.view(device="cpu")
    eng = GoldDiffEngine(ds, make_schedule("ddpm_linear", 1000), index=ix,
                         index_mode="always", device="cpu")
    eng.install_epoch(1, *lc.view(device="cpu"))
    x = torch.from_numpy(query(1))
    with eng.at_epoch(1):
        before = eng.denoise(x, 200)
    lc.append(np.random.default_rng(5).normal(size=(64, 16))
              .astype(np.float32))
    with eng.at_epoch(1):
        torch.testing.assert_close(eng.denoise(x, 200), before, rtol=0,
                                   atol=0)


# -- padded operands -------------------------------------------------------------

@pytest.mark.parametrize("t", [50, 400, 900])
def test_full_scan_padded_equals_unpadded(env, t):
    """Empty slots (+inf norms) weigh 0: the full scan over the padded
    view equals the one over the unpadded store, and the reference's."""
    x = query(t)
    padded = env["eng"].full_scan(torch.from_numpy(x), t)
    plain = GoldDiffEngine(env["p_store"], make_schedule("ddpm_linear", 1000),
                           device="cpu").full_scan(torch.from_numpy(x), t)
    r_plain = RGoldDiffEngine(env["store"], r_make_schedule(
        "ddpm_linear", 1000)).full_scan(jnp.asarray(x), t)
    torch.testing.assert_close(padded, plain, rtol=0, atol=1e-4)
    np.testing.assert_allclose(padded.numpy(), np.asarray(r_plain), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("t", [100, 500, 999])
def test_padded_indexed_support_never_weighs_an_empty_slot(env, t):
    """The probed windows of a padded view hold empty slots (``perm`` 0,
    +inf proxy norm).  The engine points them at a padding row, so they
    re-rank +inf, rank after every real row and weigh 0: every finite
    entry of the support is a distinct real row."""
    eng = env["eng"]
    n_rows = env["lc"].n_rows
    a, _ = eng.constants(t)
    idx, d2 = eng._select_body(torch.from_numpy(query(t)) / a, t)
    fin = torch.isfinite(d2)
    assert fin.any(dim=1).all()
    for b in range(idx.shape[0]):
        real = idx[b][fin[b]]
        assert (real < n_rows).all()
        assert real.unique().numel() == real.numel()
        pad = idx[b][~fin[b]]
        assert (pad >= n_rows).all()
        # ranked: every finite distance before every +inf one
        assert not fin[b][fin[b].logical_not().cumsum(0) > 0].any()
    assert (eng.index_perm != env["ix0"].perm).any()


@pytest.fixture(scope="module")
def r_remapped(env):
    """The reference engine on the same padded view, its index given
    the port's perm (empty slots at a +inf-norm padding row)."""
    perm = jnp.asarray(env["eng"].index_perm.numpy())
    return RGoldDiffEngine(env["r_ds0"], r_make_schedule("ddpm_linear", 1000),
                           index=env["r_ix0"]._replace(perm=perm),
                           index_mode="always")


@pytest.mark.parametrize("t", [100, 500, 999])
def test_padded_indexed_matches_reference_with_remapped_perm(env, r_remapped,
                                                             t):
    """The padded indexed step (``_select_body``, ``denoise``,
    ``denoise_masked``) against the reference's on the same view with
    the port's perm: the golden sets equal, distances 1e-5 rel,
    posterior means 1e-4."""
    eng = env["eng"]
    x = query(t)
    a, _ = eng.constants(t)
    idx, d2 = eng._select_body(torch.from_numpy(x) / a, t)
    r_idx, r_d2 = (np.asarray(v) for v in
                   r_remapped._select_body(jnp.asarray(x) / a, t))
    fin = np.isfinite(r_d2)
    np.testing.assert_array_equal(torch.isfinite(d2).numpy(), fin)
    for b in range(x.shape[0]):
        assert set(idx[b].numpy()[fin[b]]) == set(r_idx[b][fin[b]])
    np.testing.assert_allclose(d2.numpy()[fin], r_d2[fin], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        eng.denoise(torch.from_numpy(x), t).numpy(),
        np.asarray(r_remapped.denoise(jnp.asarray(x), t)), rtol=1e-4,
        atol=1e-4)
    np.testing.assert_allclose(      # the masked step the runtime serves
        eng.denoise_masked(torch.from_numpy(x), t).numpy(),
        np.asarray(r_remapped.denoise_masked(jnp.asarray(x), jnp.int32(t))),
        rtol=1e-4, atol=1e-4)


# -- the runtime's hot swap ------------------------------------------------------------

@pytest.fixture(scope="module")
def swap_engines(tmp_path_factory):
    """Both runtimes on lifecycles of the same gmm store (their arrays
    are bit-equal: ``tests/test_torch_ingest.py``)."""
    store = r_gmm(512, dim=16, seed=3)._replace(labels=None)
    index = r_build_index(store, num_clusters=8)
    r_lc = RLifecycle.create(str(tmp_path_factory.mktemp("ref")), store,
                             index, RIngestConfig())
    p_store = store_from_numpy(*(np.asarray(a) for a in (
        store.X, store.proxy, store.x_norms, store.proxy_norms)),
        store.image_shape, device="cpu")
    p_index = index_from_numpy(*(np.asarray(getattr(index, f)) for f in (
        "centroids", "centroid_norms", "perm", "offsets", "proxy_sorted",
        "proxy_norms_sorted")), max_cluster=index.max_cluster, device="cpu")
    p_lc = StoreLifecycle.create(str(tmp_path_factory.mktemp("port")),
                                 p_store, p_index, IngestConfig())
    r_ds, r_ix = r_lc.view()
    p_ds, p_ix = p_lc.view(device="cpu")
    kw = dict(ENG_KW, index_mode="always")
    return {REF: (r_serve.ServeEngine(r_ds, index=r_ix, **kw), r_lc,
                  lambda: r_lc.view()),
            PORT: (ServeEngine(p_ds, index=p_ix, device="cpu", **kw), p_lc,
                   lambda: p_lc.view(device="cpu"))}


def grow(lc, b, seed):
    lc.append(np.random.default_rng(seed).normal(
        size=(b, lc.dim)).astype(np.float32))
    lc.commit()


def test_hot_swap_with_inflight_wave(swap_engines):
    engs = {k: v[0] for k, v in swap_engines.items()}
    eng = engs[PORT]

    def scen(pkg, rt, clk):
        R = pkg.serve.Request
        _, lc, view = swap_engines[pkg]
        base = rt.submit(R(10, 1, seed=77))
        rt.run_until_idle()
        t = rt.submit(R(11, 1, seed=77))
        assert rt.pump()
        grow(lc, 16, seed=60)
        rt.hot_swap(*view())
        rt.run_until_idle()
        post = rt.submit(R(12, 1, seed=77))
        rt.run_until_idle()
        return [base, t, post]
    fresh(PORT, eng, FakeClock())
    b0 = eng.engine._builds
    out = run_both(engs, scen)
    # images held against the port's own runs below: on padded windows
    # the reference re-ranks row 0 at empty slots (ROADMAP Queue 3);
    # test_padded_indexed_matches_reference_with_remapped_perm holds the
    # step itself against it
    assert_same(out, images=False)
    rec, rt, (base, t, post) = out[PORT]
    assert rec["status"] == ["done"] * 3
    np.testing.assert_array_equal(t.images, base.images)     # old epoch
    assert not np.array_equal(post.images, base.images)      # new rows live
    assert eng.engine._builds == b0
    assert rt.health()["compiles_post_warmup"] == 0
    assert rec["epochs"] == (1, 1)
    # post-swap delivery = a fresh engine on the new view
    _, lc, view = swap_engines[PORT]
    fresh_eng = ServeEngine(view()[0], index=view()[1], device="cpu",
                            index_mode="always", **ENG_KW)
    np.testing.assert_array_equal(post.images,
                                  plan_alone(fresh_eng, Request(12, 1, 77)))


def test_quarantined_probe(swap_engines):
    engs = {k: v[0] for k, v in swap_engines.items()}

    def scen(pkg, rt, clk):
        R = pkg.serve.Request
        _, lc, view = swap_engines[pkg]
        pre = rt.submit(R(20, 1, seed=8))
        rt.run_until_idle()
        ds, ix = view()
        if pkg is REF:
            import jax.numpy as jnp
            bad = ds._replace(X=jnp.full_like(ds.X, jnp.nan))
        else:
            import dataclasses
            bad = dataclasses.replace(ds, X=torch.full_like(ds.X, np.nan))
        with pytest.raises(pkg.runtime.EpochProbeError):
            rt.hot_swap(bad, ix)
        post = rt.submit(R(21, 1, seed=8))
        rt.run_until_idle()
        return [pre, post]
    out = run_both(engs, scen)
    assert_same(out)
    rec, rt, (pre, post) = out[PORT]
    assert rec["counters"]["epoch_quarantined"] == 1
    np.testing.assert_array_equal(pre.images, post.images)
    assert rt.health()["compiles_post_warmup"] == 0


