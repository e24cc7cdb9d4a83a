"""The sharded golden store (``repro_torch.distributed``,
``repro_torch.index.shard`` and the engine's mesh path) against the JAX
package and against the port's one-device engine, on the CPU.

* The cross-shard primitives run the reference's own functions under
  ``jax.vmap`` with a named axis (its ``all_gather`` / ``pmax`` /
  ``psum`` then merge the mapped shards) on the same arrays as the
  port's ``LocalMesh`` lists.
* The reference's sharded engine and layouts need a mesh of several
  devices: one subprocess on an emulated 8-device CPU mesh (the
  reference's own tests do the same) writes its outputs to an ``.npz``,
  which the tests below read.  The port takes the same stores (numpy
  generators, bit-equal) and the reference's index (``index_from_numpy``).
* The gloo ``ProcessMesh`` runs 2 and 4 ranks in one subprocess with a
  timeout, on a ``FileStore`` (no port), for ``distributed_golden_
  denoise``; the engine over a ``ProcessMesh`` runs on 8 gloo ranks in
  one more (``tests/_pmesh_ranks.py``, module fixture ``ranks``), each
  rank's outputs held against the reference's sharded engine, the
  port's ``LocalMesh`` engine and rank 0's.  So do the serving runtime
  over the ranks (``tests/_runtime_parity.py``'s scenarios: every
  rank's records equal the port's ``LocalMesh`` runtime's, which equal
  the reference's runtime over its emulated mesh, run in the
  ``reference`` subprocess) and GoldDiff over the patch bases.

Tolerances: golden sets equal (overlap 1.0, distinct float distances);
means 1e-5 relative (fp32 reduction order: a different order of the
shards' sums); layouts and integer outputs equal.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.distributed import sharding as jsh
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import screen as jscreen
from repro_torch.core import (GoldDiff, GoldDiffConfig, GoldDiffEngine,
                              OptimalDenoiser, build_plan, make_schedule,
                              sample, sample_plan, store_from_numpy)
from repro_torch.data.synthetic import gmm
from repro_torch.distributed import (LocalMesh, crossshard_kth,
                                     gather_global_topk, kth_from_gathered,
                                     lse_merge_mean)
from repro_torch.distributed.retrieval import (distributed_golden_denoise,
                                               shard_store)
from repro_torch.index import index_from_numpy
from repro_torch.index.shard import partition_windows, shard_layout
from repro_torch.kernels import ops, ref
from repro_torch.kernels import screen as tscreen
from repro_torch.launch.mesh import make_debug_mesh, make_process_mesh

from _pmesh_ranks import (ERROR_TIMEOUT_S, MONITOR_HEALTH, MONITOR_TS,
                          PATCH_BASES, PCA_SERVE, REF_T, ROUTES, SERVE,
                          SERVE_REQUESTS, TS, WORLD, image_store,
                          monitor_probes, monitor_queries)

REPO = Path(__file__).resolve().parent.parent
SCH = make_schedule("ddpm_linear", 1000)
REL = 1e-5
INDEX_FIELDS = ("centroids", "centroid_norms", "perm", "offsets",
                "proxy_sorted", "proxy_norms_sorted")


def relerr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def overlap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean([len(set(a[i]) & set(b[i])) / a.shape[1]
                          for i in range(a.shape[0])]))


def noisy(x0, t, seed):
    eps = np.random.default_rng(seed).normal(size=x0.shape)
    return (SCH.a[t] * x0 + SCH.b[t] * eps).astype(np.float32)


def mesh(s, *rest):
    names = ("data", "model")[: 1 + len(rest)]
    return LocalMesh((s,) + rest, names)


# -- the cross-shard primitives against the reference's ------------------------

def _vmapped(fn, *arrays):
    """The reference primitive over a leading shard axis named "s"."""
    return jax.vmap(fn, axis_name="s")(*(jnp.asarray(a) for a in arrays))


@pytest.mark.parametrize("s,kloc,k", [(8, 6, 17), (3, 5, 1), (2, 4, 8),
                                      (5, 7, 35)])
def test_kth_and_global_topk_match_reference(s, kloc, k):
    rng = np.random.default_rng(s * 100 + k)
    b = 5
    neg = rng.standard_normal((s, b, kloc)).astype(np.float32)
    neg[1 % s, :, -1] = -np.inf                       # invalid slots
    neg[0, 0, :2] = neg[-1, 0, 0]                     # ties across shards
    ids = rng.integers(0, 1000, (s, b, kloc)).astype(np.int32)
    want_kth = np.asarray(_vmapped(
        lambda n: jsh.crossshard_kth(n, k, k, "s"), neg))[0]
    want_ids = np.asarray(_vmapped(
        lambda i, n: jsh.gather_global_topk(i, n, k, "s"), ids, neg))[0]
    parts = [torch.from_numpy(neg[i]) for i in range(s)]
    lm = mesh(s)
    got_kth = crossshard_kth(parts, k, k, lm)
    np.testing.assert_array_equal(got_kth.numpy(), want_kth)
    got_ids = gather_global_topk([torch.from_numpy(ids[i]).long()
                                  for i in range(s)], parts, k, lm)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    # a traced k: a 0-d tensor (the masked path) and the gathered form
    g = np.concatenate(list(neg), axis=1)
    for kk in (1, k, k + 3):
        want = np.asarray(jsh.kth_from_gathered(jnp.asarray(g), k + 1, kk))
        got = kth_from_gathered(torch.from_numpy(g), k + 1,
                                torch.tensor(kk))
        np.testing.assert_array_equal(got.numpy(), want)


def _states(s, b=4, d=12, seed=0):
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal((s, b, d)).astype(np.float32)
    m = rng.standard_normal((s, b)).astype(np.float32) * 3
    lsum = rng.uniform(0.5, 4.0, (s, b)).astype(np.float32)
    return acc, m, lsum


def _merge_both(acc, m, lsum):
    s = acc.shape[0]
    want = np.asarray(_vmapped(lambda a, mm, ll: jsh.lse_merge_mean(
        a, mm, ll, "s"), acc, m, lsum))[0]
    got = lse_merge_mean([torch.from_numpy(acc[i]) for i in range(s)],
                         [torch.from_numpy(m[i]) for i in range(s)],
                         [torch.from_numpy(lsum[i]) for i in range(s)],
                         mesh(s))
    return got.numpy(), want


@pytest.mark.parametrize("case", ["plain", "padding shard", "nan guard"])
def test_lse_merge_matches_reference(case):
    acc, m, lsum = _states(5, seed=len(case))
    if case == "padding shard":
        # a shard with no members: the finite NEG_INF max, its scale
        # underflows to exactly 0
        m[2] = ref.NEG_INF
        acc[2] = 1e3
    elif case == "nan guard":
        m[:, 1] = -np.inf                           # every shard hard -inf
    got, want = _merge_both(acc, m, lsum)
    assert np.isfinite(got).all()
    assert relerr(got, want) <= REL
    if case == "padding shard":
        keep = [i for i in range(5) if i != 2]
        got2, _ = _merge_both(acc[keep], m[keep], lsum[keep])
        np.testing.assert_allclose(got, got2, rtol=REL, atol=1e-6)
    if case == "nan guard":
        np.testing.assert_array_equal(got[1], 0.0)


def test_merge_equals_global_softmax():
    """Two-stage threshold + LSE merge == a global top-k + softmax in one
    place (the reference's own regression, on the port)."""
    s, b, kloc, nloc, d, k, s2 = 8, 5, 6, 32, 12, 17, 0.37
    rng = np.random.default_rng(0)
    neg = rng.standard_normal((s, b, kloc)).astype(np.float32)
    X = rng.standard_normal((s, nloc, d)).astype(np.float32)
    idx = rng.integers(0, nloc, (s, b, kloc))
    lm = mesh(s)
    parts = [torch.from_numpy(neg[i]) for i in range(s)]
    kth = crossshard_kth(parts, k, k, lm)
    states = []
    for i in range(s):
        lg = torch.where(parts[i] >= kth[:, None], parts[i] / (2.0 * s2),
                         ref.NEG_INF)
        states.append(ops.golden_partial_aggregate(
            torch.from_numpy(X[i]), torch.from_numpy(idx[i]), lg))
    out = lse_merge_mean(*zip(*states), lm).numpy()
    flat = neg.transpose(1, 0, 2).reshape(b, s * kloc)
    rows = np.stack([np.concatenate([X[i][idx[i, j]] for i in range(s)])
                     for j in range(b)])
    want = np.zeros((b, d), np.float32)
    for j in range(b):
        top = np.argsort(-flat[j])[:k]
        lg = flat[j][top] / (2.0 * s2)
        w = np.exp(lg - lg.max())
        want[j] = (w / w.sum()) @ rows[j][top]
    assert relerr(out, want) <= REL


# -- the partial ops against ops.py's --------------------------------------------

@pytest.mark.parametrize("strategy", ["gather", "dense", None])
def test_partial_aggregate_matches_reference(strategy):
    rng = np.random.default_rng(1)
    n, d, b, k = 97, 10, 4, 23
    x = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, (b, k))
    idx[0, :3] = idx[0, 3]                           # duplicate rows
    lg = (-rng.uniform(0, 30, (b, k))).astype(np.float32)
    lg[1] = jref.NEG_INF                             # an all-masked row
    lg[2, ::2] = jref.NEG_INF
    if strategy is None:                             # idx=None: every row
        lgd = (-rng.uniform(0, 30, (b, n))).astype(np.float32)
        want = jops.golden_partial_aggregate(jnp.asarray(x), None,
                                             jnp.asarray(lgd))
        got = ops.golden_partial_aggregate(torch.from_numpy(x), None,
                                           torch.from_numpy(lgd))
    else:
        want = jops.golden_partial_aggregate(
            jnp.asarray(x), jnp.asarray(idx), jnp.asarray(lg),
            strategy=strategy)
        got = ops.golden_partial_aggregate(
            torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(lg),
            strategy=strategy)
    for g, w in zip(got, want):
        assert relerr(g.numpy(), w) <= REL
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("padding", [False, True])
def test_full_partial_matches_reference(stream, padding):
    rng = np.random.default_rng(2)
    n, d, b = 300, 16, 3
    x = rng.standard_normal((n, d)).astype(np.float32)
    xn = (x * x).sum(-1)
    if padding:                                     # the last shard's tail
        x[-40:] = 0.0
        xn[-40:] = np.inf
    q = rng.standard_normal((b, d)).astype(np.float32)
    want = jops.golden_full_partial(jnp.asarray(q), jnp.asarray(x), 0.7,
                                    x_norms=jnp.asarray(xn), stream=stream,
                                    tile=64)
    got = ops.golden_full_partial(torch.from_numpy(q), torch.from_numpy(x),
                                  0.7, x_norms=torch.from_numpy(xn),
                                  stream=stream, tile=64)
    for g, w in zip(got, want):
        assert relerr(g.numpy(), w) <= REL
    # all padding: m = NEG_INF (finite), l = the row count, no NaN
    pad = torch.full((n,), float("inf"))
    acc, m, lsum = ops.golden_full_partial(torch.from_numpy(q),
                                           torch.zeros(n, d), 0.7,
                                           x_norms=pad, stream=stream,
                                           tile=64)
    assert (m == ref.NEG_INF).all() and (lsum == n).all()
    assert (acc == 0).all()
    s = jscreen.full_scan_partial_stream(jnp.asarray(q), jnp.asarray(x),
                                         0.7, x_norms=jnp.asarray(xn),
                                         tile=64)
    t = tscreen.full_scan_partial_stream(torch.from_numpy(q),
                                         torch.from_numpy(x), 0.7,
                                         x_norms=torch.from_numpy(xn),
                                         tile=64)
    for g, w in zip(t, s):
        assert relerr(g.numpy(), w) <= REL


@pytest.mark.parametrize("w_lo,w_hi,nprobe", [(0, 5, None), (3, 9, None),
                                              (9, 12, 4), (12, 12, None),
                                              (0, 12, 2)])
def test_ivf_screen_local_matches_reference(w_lo, w_hi, nprobe):
    rng = np.random.default_rng(3)
    c, dp, b, maxc = 12, 6, 5, 7
    sizes = rng.integers(1, maxc + 1, c)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    cents = rng.standard_normal((c, dp)).astype(np.float32)
    cents[4] = cents[5]                              # tied windows
    cn = (cents * cents).sum(-1)
    cn[-1] = np.inf                                  # a spare window
    qp = rng.standard_normal((b, dp)).astype(np.float32)
    o = offsets[w_lo: w_hi + 1] - offsets[w_lo]
    w_cap = 4
    o = np.pad(o, (0, w_cap + 1 - len(o)) if len(o) <= w_cap else (0, 0),
               mode="edge" if len(o) else "constant")
    n_loc = max(int(o[-1]), 1)
    want = jops.ivf_screen_local(
        jnp.asarray(qp), jnp.asarray(o, jnp.int32), jnp.asarray(cents),
        jnp.asarray(cn), w_lo, w_hi, 8, maxc, w_cap, n_loc,
        nprobe=nprobe, backend="xla")
    got = ops.ivf_screen_local(
        torch.from_numpy(qp), torch.from_numpy(o), torch.from_numpy(cents),
        torch.from_numpy(cn), torch.tensor(w_lo), torch.tensor(w_hi), 8,
        maxc, w_cap, n_loc,
        nprobe=None if nprobe is None else torch.tensor(nprobe))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("n", [1, 100, 6250, 50000])
def test_select_plan_at_m_equal_and_above_n(n):
    """The sharded screen asks kernel 5 for m = n_loc (S=8 at cifar_like
    scale): the cap takes every row and no radix pass runs; above n the
    cap stays n (the surplus slots carry +inf)."""
    for m in (n, n + 1, 2 * n):
        assert tscreen.select_cap(n, m) == n
        assert tscreen.radix_plan(n, m) == ()
        z = tscreen.scratch_sizes(16, n, m)
        assert z["cap"] == n and z["keys"] == 2 * 16 * n
    q = torch.randn(3, 4)
    x = torch.randn(min(n, 300), 4)
    for m in (x.shape[0], x.shape[0] + 5):
        i1, d1 = ops.screen_topm(q, x, m)
        i2, d2 = ops.screen_topm(q, x, m, stream=True, tile=64)
        np.testing.assert_array_equal(d1.numpy(), d2.numpy())
        fin = torch.isfinite(d1)
        np.testing.assert_array_equal(i1[fin].numpy(), i2[fin].numpy())
        assert (~fin).sum() == 3 * (m - x.shape[0])


# -- the layout against the reference's, array for array ----------------------

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, jax.numpy as jnp, numpy as np
from repro.core import (GoldDiff, GoldDiffConfig, GoldDiffEngine,
                        OptimalDenoiser, build_plan, make_schedule,
                        sample_plan)
from repro.core.dataset import make_store
from repro.data import gmm
from repro.index import build_index
from repro.index.shard import partition_windows, shard_layout

out = {}
sch = make_schedule("ddpm_linear", 1000)
TS = (500,)
PATCH_TS = (100, 500, 900)

def noisy(x0, t, seed):
    eps = np.random.default_rng(seed).normal(size=x0.shape)
    return (sch.a[t] * x0 + sch.b[t] * eps).astype(np.float32)

def run(tag, eng, x0, masked=True, full=True):
    for t in TS:
        xt = jnp.asarray(noisy(x0, t, t))
        out[f"{tag}_denoise_{t}"] = np.asarray(eng.denoise(xt, t))
        out[f"{tag}_select_{t}"] = np.asarray(eng.select(xt, t))
        if masked:
            out[f"{tag}_masked_{t}"] = np.asarray(
                eng.denoise_masked(xt, jnp.asarray(t)))
        if full:
            out[f"{tag}_full_{t}"] = np.asarray(eng.full_scan(xt, t))

# exact: 1003 % 8 != 0, a padded tail
store = gmm(1003, dim=16, seed=0)
store2 = gmm(2003, dim=16, num_modes=32, spread=0.05, seed=0)
for tag, st in (("store", store), ("store2", store2)):
    for f in ("X", "proxy", "x_norms", "proxy_norms"):
        out[f"{tag}_{f}"] = np.asarray(getattr(st, f))
x0 = np.asarray(store.X[:4])
mesh8 = jax.make_mesh((8,), ("data",))
run("exact", GoldDiffEngine(store, sch, GoldDiffConfig(), mesh=mesh8), x0)
# indexed on the data axis of a (4, 2) mesh
ix = build_index(store2, num_clusters=32)
for f in ("centroids", "centroid_norms", "perm", "offsets", "proxy_sorted",
          "proxy_norms_sorted"):
    out[f"ix_{f}"] = np.asarray(getattr(ix, f))
out["ix_max_cluster"] = np.asarray(ix.max_cluster)
mesh42 = jax.make_mesh((4, 2), ("data", "model"))
run("indexed", GoldDiffEngine(store2, sch, GoldDiffConfig(), index=ix,
                              index_mode="always", mesh=mesh42),
    np.asarray(store2.X[:4]), full=False)
# the plan over the sharded engine (8 steps)
gd = GoldDiff(OptimalDenoiser(store, sch), GoldDiffConfig(), mesh=mesh8)
plan = build_plan(gd.engine, num_steps=8)
xT = (float(sch.b[1000]) * np.random.default_rng(11).normal(
    size=(4, 16))).astype(np.float32)
out["plan_xT"] = xT
out["plan_out"] = np.asarray(sample_plan(
    gd.call_masked, sch, (4, 16), jax.random.PRNGKey(0), plan,
    x_init=jnp.asarray(xT), program_cache=gd.engine.program))
# ties: an integer store whose distances tie at the k-th value
xi = np.random.default_rng(4).integers(-1, 2, (515, 8)).astype(np.float32)
out["tie_X"] = xi
tie = make_store(xi, (8,))
cfg = GoldDiffConfig(m_min_frac=0.2, m_max_frac=0.3, k_min_frac=0.05,
                     k_max_frac=0.1)
eng = GoldDiffEngine(tie, sch, cfg, mesh=mesh8)
TIE_T = 900
out["tie_denoise"] = np.asarray(eng.denoise(
    jnp.asarray(xi[:4] * float(sch.a[TIE_T])), TIE_T))
# the layouts at S in {1, 3, 8}
for s in (1, 3, 8):
    m = jax.make_mesh((s,), ("data",), devices=jax.devices()[:s])
    for tag, L in (("exact", shard_layout(store, m)),
                   ("indexed", shard_layout(store2, m, index=ix)),
                   ("bf16", shard_layout(store, m,
                                         storage_dtype=jnp.bfloat16))):
        for f in ("X", "x_norms", "proxy", "proxy_norms", "ids", "offsets",
                  "wrange"):
            a = getattr(L, f)
            if a is not None:
                out[f"layout_{tag}_{s}_{f}"] = np.asarray(
                    a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
        out[f"layout_{tag}_{s}_sizes"] = np.asarray(
            [L.n_loc, L.w_max, L.max_cluster, L.n_shards])
# the patch bases over the mesh: an image store, GoldDiff static steps
from repro.core.denoisers import PCADenoiser, PatchDenoiser
from repro.data.synthetic import image_store
img = image_store(257, 16, 16, 3, seed=0)
for f in ("X", "proxy", "x_norms", "proxy_norms"):
    out[f"img_{f}"] = np.asarray(getattr(img, f))
for t in PATCH_TS:
    out[f"xpatch_{t}"] = noisy(np.asarray(img.X[:4]), t, t + 3)
for name, cls in (("kamb", PatchDenoiser), ("pca", PCADenoiser)):
    gd = GoldDiff(cls(img, sch), GoldDiffConfig(), mesh=mesh8)
    for t in PATCH_TS:
        x = jnp.asarray(out[f"xpatch_{t}"])
        out[f"patch_{name}_{t}"] = np.asarray(gd(x, t))
        out[f"patch_{name}_select_{t}"] = np.asarray(gd.select(x, t))
# the serving runtime over the mesh: the scripted scenarios, drawing the
# port's x_T (records as JSON)
import json
sys.path.insert(0, sys.argv[2])
import _runtime_parity as rp
import repro.launch.serve as r_serve
from repro_torch.core import store_from_numpy
from repro_torch.launch.serve import ServeEngine as TServe
reng = r_serve.ServeEngine(store, mesh=mesh8, **rp.ENG_KW)
peng = TServe(store_from_numpy(*(out[f"store_{f}"] for f in (
    "X", "proxy", "x_norms", "proxy_norms")), (16,), device="cpu"),
    device="cpu", **rp.ENG_KW)
for name, (scen, faults, kw) in rp.SCENARIOS.items():
    rec, tickets = rp.run_one(rp.REF, reng, scen, faults,
                              around=lambda: rp.port_noise(reng, peng), **kw)
    out[f"rt_{name}_record"] = json.dumps(rec)
    for i, t in enumerate(tickets):
        out[f"rt_{name}_img{i}"] = (np.zeros((0,), np.float32)
                                    if t.images is None
                                    else np.asarray(t.images))
np.savez(sys.argv[1], **out)
print("PASS")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded outputs on an emulated 8-device mesh."""
    path = tmp_path_factory.mktemp("sharded") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                        str(REPO / "tests")],
                       capture_output=True, text=True, timeout=600,
                       cwd=str(REPO), env=env)
    assert "PASS" in r.stdout, r.stdout + r.stderr
    return dict(np.load(path))


TIE_T = 900


def ref_store(refd, tag):
    """The reference's store, norms and all (the port's generators give
    the same rows; their norms may differ in the last bit)."""
    return store_from_numpy(*(refd[f"{tag}_{f}"] for f in
                              ("X", "proxy", "x_norms", "proxy_norms")),
                            (16,), device="cpu")


def port_index(refd):
    return index_from_numpy(*(refd[f"ix_{f}"] for f in INDEX_FIELDS),
                            max_cluster=int(refd["ix_max_cluster"]),
                            device="cpu")


def stores():
    return (gmm(1003, dim=16, seed=0, device="cpu"),
            gmm(2003, dim=16, num_modes=32, spread=0.05, seed=0,
                device="cpu"))


@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("tag", ["exact", "indexed", "bf16"])
def test_layout_matches_reference(reference, tag, s):
    store, store2 = ref_store(reference, "store"), ref_store(reference,
                                                            "store2")
    if tag == "indexed":
        L = shard_layout(store2, mesh(s), index=port_index(reference))
    else:
        L = shard_layout(store, mesh(s), storage_dtype=(
            torch.bfloat16 if tag == "bf16" else None))
    pre = f"layout_{tag}_{s}_"
    assert [L.n_loc, L.w_max, L.max_cluster, L.n_shards] == \
        reference[pre + "sizes"].tolist()
    for f in ("X", "x_norms", "proxy", "proxy_norms", "ids", "offsets",
              "wrange"):
        got = getattr(L, f)
        if pre + f not in reference:
            assert got is None, f
            continue
        np.testing.assert_array_equal(got.float().numpy() if got.dtype ==
                                      torch.bfloat16 else got.numpy(),
                                      reference[pre + f], err_msg=f)
    # each slab is a view of its shard's slice, its window range a 0-d pair
    for i, sl in enumerate(L.slabs):
        assert sl.X.data_ptr() == L.X[i].data_ptr()
        if L.indexed:
            assert int(sl.w_lo) == int(L.wrange[i, 0])


def test_partition_windows_matches_reference():
    from repro.index.shard import partition_windows as jpartition
    rng = np.random.default_rng(3)
    for sizes in (rng.integers(1, 50, 37), np.array([1000, 1, 1, 1]),
                  np.array([5]), rng.integers(0, 9, 64)):
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        for s in (1, 3, 4, 8, 70):
            np.testing.assert_array_equal(partition_windows(offsets, s),
                                          jpartition(offsets, s))


# -- the sharded engine against the reference's and the one-device engine ----

@pytest.mark.parametrize("tag", ["exact", "indexed"])
def test_sharded_engine_matches_reference(reference, tag):
    store, store2 = ref_store(reference, "store"), ref_store(reference,
                                                            "store2")
    if tag == "exact":
        eng = GoldDiffEngine(store, SCH, device="cpu", mesh=mesh(8))
        one = GoldDiffEngine(store, SCH, device="cpu")
        x0 = store.X[:4].numpy()
    else:
        ix = port_index(reference)
        kw = dict(index=ix, index_mode="always", device="cpu")
        eng = GoldDiffEngine(store2, SCH, mesh=mesh(4, 2), **kw)
        one = GoldDiffEngine(store2, SCH, **kw)
        x0 = store2.X[:4].numpy()
    for t in (REF_T,):
        xt = torch.from_numpy(noisy(x0, t, t))
        pre = f"{tag}_"
        got = eng.denoise(xt, t)
        assert relerr(got, reference[pre + f"denoise_{t}"]) <= REL
        assert relerr(got, one.denoise(xt, t)) <= REL
        got = eng.denoise_masked(xt, t)
        assert relerr(got, reference[pre + f"masked_{t}"]) <= REL
        assert relerr(got, one.denoise_masked(xt, t)) <= REL
        sel = eng.select(xt, t).numpy()
        np.testing.assert_array_equal(sel, reference[pre + f"select_{t}"])
        assert overlap(sel, one.select(xt, t)) == 1.0
        if tag == "exact":
            got = eng.full_scan(xt, t)
            assert relerr(got, reference[pre + f"full_{t}"]) <= REL
            assert relerr(got, one.full_scan(xt, t)) <= REL


def test_sharded_plan_matches_reference(reference):
    store = ref_store(reference, "store")
    gd = GoldDiff(OptimalDenoiser(store, SCH, device="cpu"), mesh=mesh(8))
    plan = build_plan(gd.engine, 8)
    xT = torch.from_numpy(reference["plan_xT"])
    got = sample_plan(gd.call_masked, SCH, (4, 16), plan, x_init=xT,
                      program_cache=gd.engine.program,
                      jitter=gd.engine.jitter)
    assert relerr(got, reference["plan_out"]) <= 1e-4
    keys = [k for k in gd.engine._programs if k[0] == "plan_seg"]
    assert keys and all(k[-1] == ("mesh", "data", 8, None, 1) for k in keys)
    one = GoldDiff(OptimalDenoiser(store, SCH, device="cpu"))
    want = sample(one, SCH, (4, 16), num_steps=8, x_init=xT)
    assert float((got - want).abs().max()) <= 1e-4


def test_threshold_ties_keep_every_tied_row_as_the_reference(reference):
    """At a tied k-th distance the cross-shard cut keeps every tied row
    (``neg >= kth``): the sharded mean can differ from the one-device
    one there, and is pinned to the reference's sharded engine."""
    xi = reference["tie_X"]
    st = store_from_numpy(xi, xi, (xi * xi).sum(-1), (xi * xi).sum(-1),
                          (8,), device="cpu")
    cfg = GoldDiffConfig(m_min_frac=0.2, m_max_frac=0.3, k_min_frac=0.05,
                         k_max_frac=0.1)
    eng = GoldDiffEngine(st, SCH, cfg, device="cpu", mesh=mesh(8))
    one = GoldDiffEngine(st, SCH, cfg, device="cpu")
    xt = torch.from_numpy(xi[:4] * np.float32(SCH.a[TIE_T]))
    got = eng.denoise(xt, TIE_T)
    assert relerr(got, reference["tie_denoise"]) <= REL
    # the masked body cuts k_t by the same threshold
    assert relerr(eng.denoise_masked(xt, TIE_T), got) <= REL
    assert relerr(got, one.denoise(xt, TIE_T)) > 1e-3, \
        "no tie at the k-th value: the case tests nothing"


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("shape", [(3,), (4, 2)])
def test_sharded_engine_matches_one_device(route, shape):
    store, _ = stores()
    kw = dict(ROUTES[route], device="cpu")
    one = GoldDiffEngine(store, SCH, **kw)
    batch = {"batch_axis": "model"} if len(shape) == 2 else {}
    eng = GoldDiffEngine(store, SCH, mesh=mesh(*shape), **batch, **kw)
    x0 = store.X[:4].numpy()
    for t in TS:
        xt = torch.from_numpy(noisy(x0, t, t + 7))
        assert relerr(eng.denoise(xt, t), one.denoise(xt, t)) <= REL
        assert relerr(eng.denoise_masked(xt, t),
                      one.denoise_masked(xt, t)) <= REL
        assert overlap(eng.select(xt, t), one.select(xt, t)) == 1.0
        assert relerr(eng.full_scan(xt, t), one.full_scan(xt, t)) <= REL


def test_indexed_plan_sharded_matches_one_device(reference):
    store2 = ref_store(reference, "store2")
    ix = port_index(reference)
    kw = dict(index=ix, index_mode="always", device="cpu")
    xT = torch.from_numpy((float(SCH.b[1000]) * np.random.default_rng(
        12).normal(size=(4, 16))).astype(np.float32))
    outs = []
    for m in (None, mesh(8)):
        gd = GoldDiff(OptimalDenoiser(store2, SCH, device="cpu"), mesh=m,
                      **{k: v for k, v in kw.items() if k != "device"})
        plan = build_plan(gd.engine, 10)
        outs.append(sample_plan(gd.call_masked, SCH, (4, 16), plan,
                                x_init=xT, program_cache=gd.engine.program,
                                jitter=gd.engine.jitter))
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-4


def test_mesh_arguments_and_errors():
    store, _ = stores()
    m = make_debug_mesh(4, 2)
    assert m.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="shard_axis"):
        GoldDiffEngine(store, SCH, device="cpu", mesh=m, shard_axis="x")
    with pytest.raises(ValueError, match="requires a mesh"):
        GoldDiffEngine(store, SCH, device="cpu", batch_axis="model")
    with pytest.raises(ValueError, match="must differ"):
        GoldDiffEngine(store, SCH, device="cpu", mesh=m, batch_axis="data")
    with pytest.raises(ValueError, match="not in mesh"):
        GoldDiffEngine(store, SCH, device="cpu", mesh=m, batch_axis="pod")
    eng = GoldDiffEngine(store, SCH, device="cpu", mesh=m,
                         batch_axis="model")
    assert (eng.n_shards, eng.batch_shards) == (4, 2)
    with pytest.raises(ValueError, match="does not divide"):
        eng.denoise(torch.zeros(3, 16), 500)
    reason = eng.swap_compat(store, None)
    assert reason and "do not hot-swap" in reason
    with pytest.raises(ValueError, match="hot-swap"):
        eng.install_epoch(1, store)
    assert eng.reserve_standby() == [0]
    key = eng.program_key(("plan_seg", 1))
    assert key == ("plan_seg", 1, ("mesh", "data", 4, "model", 2))
    # a process mesh needs a world of its size (here none: a world of 1)
    with pytest.raises(ValueError, match=r"a \(4, 2\) mesh needs 8 ranks; "
                       "the world has 1"):
        make_process_mesh((4, 2), ("data", "model"))


# -- distributed_golden_denoise on gloo ranks -----------------------------------

_GLOO = r"""
import os, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def rank_main(rank, world, path, out):
    store_file = dist.FileStore(path, world)
    dist.init_process_group("gloo", store=store_file, rank=rank,
                            world_size=world)
    from repro_torch.core import make_schedule
    from repro_torch.data.synthetic import gmm
    from repro_torch.distributed import ProcessMesh
    from repro_torch.distributed.retrieval import (
        build_shard_indexes, distributed_golden_denoise, shard_store)
    from repro_torch.index.shard import shard_layout
    from repro_torch.index import build_index
    st = gmm(1003, dim=16, seed=0, device="cpu")
    pm = ProcessMesh("data")
    q = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 16)).astype(np.float32))
    a = distributed_golden_denoise(shard_store(st, pm), pm, q, 0.3, 250, 60)
    ix = shard_layout(st, pm, index=build_index(st, num_clusters=16))
    b = distributed_golden_denoise(st, pm, q, 0.3, 250, 60, index=ix,
                                   nprobe=6)
    np.save(f"{out}_{world}_{rank}.npy", np.stack([a.numpy(), b.numpy()]))
    dist.destroy_process_group()

if __name__ == "__main__":
    out = sys.argv[1]
    for world in (2, 4):
        with tempfile.TemporaryDirectory() as d:
            mp.spawn(rank_main, args=(world, os.path.join(d, "store"), out),
                     nprocs=world, join=True)
    print("PASS")
"""


def test_distributed_denoise_on_gloo_ranks(tmp_path):
    script = tmp_path / "gloo_ranks.py"
    script.write_text(_GLOO)
    out = str(tmp_path / "rank")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), out],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path), env=env)
    assert "PASS" in r.stdout, r.stdout + r.stderr[-4000:]
    from repro_torch.index import build_index
    st = gmm(1003, dim=16, seed=0, device="cpu")
    q = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, 16)).astype(np.float32))
    for world in (2, 4):
        lm = mesh(world)
        want_a = distributed_golden_denoise(shard_store(st, lm), lm, q, 0.3,
                                            250, 60)
        ix = shard_layout(st, lm, index=build_index(st, num_clusters=16))
        want_b = distributed_golden_denoise(st, lm, q, 0.3, 250, 60,
                                            index=ix, nprobe=6)
        for rank in range(world):
            got = np.load(f"{out}_{world}_{rank}.npy")
            assert relerr(got[0], want_a) <= REL
            assert relerr(got[1], want_b) <= REL


# -- the engine over a ProcessMesh: 8 gloo ranks ----------------------------------

@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """Every rank's outputs of ``tests/_pmesh_ranks.py`` (one ``mp.spawn``
    of 8 gloo ranks in a subprocess with a timeout), as a list of dicts,
    and the inputs they ran on."""
    d = tmp_path_factory.mktemp("pmesh")
    store, store2 = (ref_store(reference, t) for t in ("store", "store2"))
    inputs = {"x_exact": noisy(store.X[:4].numpy(), REF_T, REF_T),
              "x_indexed": noisy(store2.X[:4].numpy(), REF_T, REF_T)}
    for t in TS:
        inputs[f"x_batch_exact_{t}"] = noisy(store.X[:4].numpy(), t, t + 7)
        inputs[f"x_batch_indexed_{t}"] = noisy(store2.X[:4].numpy(), t,
                                               t + 7)
    keep = [k for k in reference if k.split("_")[0] in (
        "store", "store2", "ix", "plan", "img", "xpatch")]
    np.savez(d / "in.npz", **{k: reference[k] for k in keep}, **inputs)
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO / 'tests'}",
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(REPO / "tests" / "_pmesh_ranks.py"),
                        str(d / "rank"), str(d / "in.npz")],
                       capture_output=True, text=True, timeout=300,
                       cwd=str(d), env=env)
    assert "PASS" in r.stdout, r.stdout + r.stderr[-4000:]
    return [dict(np.load(d / f"rank_{i}.npz")) for i in range(WORLD)], inputs


def test_process_mesh_exact_matches_reference(reference, ranks):
    """(a) One axis of 8 ranks: the reference's sharded exact outputs."""
    for got in ranks[0]:
        for kind in ("denoise", "masked", "full"):
            key = f"exact_{kind}_{REF_T}"
            assert relerr(got[key], reference[key]) <= REL, key
        np.testing.assert_array_equal(got[f"exact_select_{REF_T}"],
                                      reference[f"exact_select_{REF_T}"])
        # the rank holds its slab alone: N / 8 rows, padded
        assert got["slab_rows"].tolist() == [1, -(-1003 // WORLD), 16]


def test_process_mesh_plan_matches_reference(reference, ranks):
    for got in ranks[0]:
        assert relerr(got["plan_out"], reference["plan_out"]) <= 1e-4
        assert set(got["plan_keys"].tolist()) == {
            repr(("mesh", "data", WORLD, None, 1))}


def test_process_mesh_indexed_matches_reference(reference, ranks):
    """(b) The (4, 2) ("data", "model") mesh, the model axis replicated."""
    for got in ranks[0]:
        for kind in ("denoise", "masked"):
            key = f"indexed_{kind}_{REF_T}"
            assert relerr(got[key], reference[key]) <= REL, key
        np.testing.assert_array_equal(got[f"indexed_select_{REF_T}"],
                                      reference[f"indexed_select_{REF_T}"])


@pytest.fixture
def one_thread():
    """Torch on one thread for a test of tiny operations: under the
    suite's workers, threads fighting over the cores made each such test
    take seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("route", sorted(ROUTES) + ["indexed"])
def test_process_mesh_batch_axis_matches_local_mesh(reference, ranks, route,
                                                   one_thread):
    """(c) The (4, 2) mesh with the query batch over "model" against the
    port's ``LocalMesh`` (4, 2) engine with the same axes."""
    if route == "indexed":
        st = ref_store(reference, "store2")
        kw, tag = dict(index=port_index(reference), index_mode="always"), \
            "indexed"
    else:
        st, kw, tag = ref_store(reference, "store"), ROUTES[route], "exact"
    eng = GoldDiffEngine(st, SCH, device="cpu", mesh=mesh(4, 2),
                         batch_axis="model", **kw)
    outs, inputs = ranks
    for t in TS:
        xt = torch.from_numpy(inputs[f"x_batch_{tag}_{t}"])
        want = {"denoise": eng.denoise(xt, t),
                "masked": eng.denoise_masked(xt, t),
                "full": eng.full_scan(xt, t)}
        sel = eng.select(xt, t).numpy()
        for got in outs:
            pre = f"batch {route}_"
            for kind, w in want.items():
                assert relerr(got[pre + f"{kind}_{t}"], w) <= REL, (kind, t)
            np.testing.assert_array_equal(got[pre + f"select_{t}"], sel)


def test_process_mesh_ranks_bit_equal(ranks):
    """(d) SPMD: every rank returns rank 0's tensors bit for bit (but the
    ``submit`` refusal, which only the ranks after the front end raise:
    ``test_process_mesh_refusals``, and the real error of one rank:
    ``test_process_mesh_runtime_real_error_raises_on_every_rank``)."""
    outs, _ = ranks
    for got in outs[1:]:
        assert got.keys() == outs[0].keys()
        for k, v in outs[0].items():
            if k != "err_runtime" and not k.startswith("real_error"):
                np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_process_mesh_serve_matches_one_device(ranks):
    """``ServeEngine(mesh=ProcessMesh)``: warmup, then serving builds
    nothing and returns the one-device engine's images."""
    from repro_torch.launch.serve import Request, ServeEngine
    one = ServeEngine("gmm", {"n": 1003, "dim": 16}, device="cpu", **SERVE)
    want = one.serve([Request(i, n, seed=s) for i, n, s in SERVE_REQUESTS])
    for got in ranks[0]:
        assert int(got["serve_builds_after_warmup"]) == 0
        for w in want:
            np.testing.assert_allclose(got[f"serve_{w.request_id}"],
                                       w.images, atol=1e-4)


def test_process_mesh_given_no_device_takes_the_callers(ranks):
    """A gloo ``ProcessMesh`` given no device puts a rank's shard on the
    caller's default (``shard_layout``'s store device, the engine's
    device), never on a device of its own choosing."""
    for got in ranks[0]:
        assert got["bare_devices"].tolist() == ["meta"] * WORLD
        assert str(got["bare_slab_device"]) == "cpu"


@pytest.mark.parametrize("case,match", [
    ("runtime", "ValueError: submit runs on rank 0 of the mesh's host "
                "channel, the front end; this is rank [1-7]"),
    ("runtime_hot_swap", "ValueError: ServeRuntime.hot_swap over a "
                         "ProcessMesh: sharded engines do not hot-swap"),
    ("batch", "ValueError: batch 3 does not divide over batch_axis 'model'"),
    ("hot_swap", "ValueError: epoch 1 cannot hot-swap: sharded engines"),
    ("patch_base", "ValueError: the masked step needs the Optimal base; "
                   "golddiff\\+pca serves in static mode only"),
    ("default_card", "RuntimeError: no CUDA device is available; pass "
                     "device='cpu'"),
    ("bare_engine_card", "RuntimeError: no CUDA device is available"),
    ("other_device", "ValueError: device meta is not the ProcessMesh's "
                     "cpu")])
def test_process_mesh_refusals(ranks, case, match):
    """Each refusal is raised on every rank alike; ``submit`` on every
    rank but the front end, rank 0."""
    import re
    outs = ranks[0]
    if case == "runtime":
        assert str(outs[0]["err_runtime"]) == ""
        outs = outs[1:]
    for got in outs:
        assert re.match(match, str(got[f"err_{case}"])), got[f"err_{case}"]


# -- the serving runtime over a sharded plan-mode engine ------------------------

def test_runtime_over_sharded_engine_retries_shard_drops():
    """Chaos on a sharded engine (8 shards, uneven N): shard-dropout
    faults at the dispatch seam retry to completion with finite images,
    the images those of the unsharded engine (1e-4)."""
    from repro_torch.launch.faults import FaultConfig, injected
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import Request, ServeEngine
    kw = dict(num_steps=5, max_batch=4, device="cpu")
    eng = ServeEngine("gmm", {"n": 1003, "dim": 16}, mesh=mesh(8), **kw)
    one = ServeEngine("gmm", {"n": 1003, "dim": 16}, **kw)
    assert eng.mode == "plan"
    rt = ServeRuntime(eng, RuntimeConfig(backoff_base_s=0.0,
                                         backoff_max_s=0.0, max_retries=50))
    stats = rt.warmup()
    assert stats["slots"] == [0]            # a sharded engine: one slot
    b0 = eng.engine._builds
    reqs = [Request(i, 2, seed=100 + i) for i in range(3)]
    with injected(FaultConfig(seed=2, shard_drop_rate=0.3)) as inj:
        tickets = [rt.submit(r) for r in reqs]
        rt.run_until_idle()
    assert any(e[0] == "shard_drop" for e in inj.events), inj.events
    assert rt.counters["retries"] > 0 and eng.engine._builds == b0
    want = one.serve(reqs)
    for t, w in zip(tickets, want):
        assert t.status == "done" and np.isfinite(t.images).all()
        np.testing.assert_allclose(t.images, w.images, atol=1e-4)
    # the unsharded engine's keys carry no mesh: shard_drop stays inert
    with injected(FaultConfig(seed=2, shard_drop_rate=1.0)) as inj:
        one.serve(reqs[:1])
    assert inj.events == []


# -- the serving runtime over a ProcessMesh: 8 gloo ranks ------------------------

SCEN_TAGS = ("clean", "deadline", "join", "faults", "faults_rank3")


@pytest.fixture(scope="module")
def local_runtime(reference):
    """The port's runtime over a ``LocalMesh`` of 8 on the reference's
    store, every scenario of ``_runtime_parity.SCENARIOS``: records (as
    JSON round-trips them) and deliveries."""
    import json

    from _runtime_parity import ENG_KW, PORT, SCENARIOS, run_one
    from repro_torch.launch.serve import ServeEngine
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = ServeEngine(ref_store(reference, "store"), mesh=mesh(8),
                          device="cpu", **ENG_KW)
        out = {}
        for name, (scen, faults, kw) in SCENARIOS.items():
            rec, tickets = run_one(PORT, eng, scen, faults, **kw)
            out[name] = (json.loads(json.dumps(rec)),
                         [t.images for t in tickets])
    finally:
        torch.set_num_threads(n)
    return out


def _delivered(got: dict, tag: str, n: int) -> list:
    return [got[f"rt_{tag}_img{i}"] for i in range(n)]


@pytest.mark.parametrize("tag", SCEN_TAGS)
def test_process_mesh_runtime_matches_local_mesh(ranks, local_runtime, tag):
    """Every rank's statuses, degraded flags, counters, breakers, epochs
    and trace events equal the ``LocalMesh`` runtime's, its deliveries
    within ``REL``, and the ranks' deliveries bit-equal.  The follower
    ranks' clocks raise when read, so no rank but 0 read its own clock
    inside ``pump()``; ``faults_rank3`` installs the injector on rank 3
    alone and gets the records of the injector on every rank."""
    import json
    want, images = local_runtime[tag.replace("_rank3", "")]
    outs = ranks[0]
    for got in outs:
        assert json.loads(str(got[f"rt_{tag}_record"])) == want
        for g, w, g0 in zip(_delivered(got, tag, len(images)), images,
                            _delivered(outs[0], tag, len(images))):
            if w is None:
                assert g.size == 0
                continue
            assert relerr(g, w) <= REL
            np.testing.assert_array_equal(g, g0)
    if tag.startswith("faults"):           # every kind and every rung
        kinds = {n for _, n in want["events"] if n.startswith("fault.")}
        assert kinds == {f"fault.{k}" for k in ("shard_drop", "error", "oom",
                                                 "nan", "evict")}
        for k in ("retries", "finite_trips", "gauss_segments", "oom_splits",
                  "scan_waves", "joins"):
            assert want["counters"][k] > 0, k


@pytest.mark.parametrize("tag", SCEN_TAGS[:4])
def test_local_mesh_runtime_matches_reference(reference, local_runtime, tag):
    """The ``LocalMesh`` runtime's records equal the reference's
    ``ServeRuntime`` over its emulated 8-device mesh (the same scenario,
    the same x_T), its deliveries within 1e-4."""
    import json
    want = json.loads(str(reference[f"rt_{tag}_record"]))
    rec, images = local_runtime[tag]
    assert rec == want
    for g, w in zip(_delivered(reference, tag, len(images)), images):
        if w is None:
            assert g.size == 0
        else:
            np.testing.assert_allclose(w, g, rtol=0, atol=1e-4)


def test_process_mesh_runtime_background_thread(ranks):
    """``start()`` on every rank, a request on rank 0, rank 0's
    ``stop()`` ending every rank's loop: each rank holds the ticket,
    done, with rank 0's images."""
    outs = ranks[0]
    for got in outs:
        assert str(got["bg_status"]) == "done"
        assert np.isfinite(got["bg_images"]).all()
        np.testing.assert_array_equal(got["bg_images"], outs[0]["bg_images"])


def test_process_mesh_runtime_real_error_raises_on_every_rank(ranks):
    """(e) A real ``TransientExecutorError`` in rank 3's segment (no drawn
    fault, so no agreement) is not retried there: rank 3's ``pump()``
    raises it, and every other rank's ``pump()`` raises when its
    segment's collective times out, within the group's timeout (and a
    margin for a loaded host) rather than hanging or pairing mismatched
    collectives."""
    for r, got in enumerate(ranks[0]):
        err = str(got["real_error"])
        if r == 3:
            assert err == "TransientExecutorError"
        else:
            assert err and err != "TransientExecutorError", (r, err)
        assert int(got["real_error_retries"]) == 0
        assert float(got["real_error_s"]) < 2 * ERROR_TIMEOUT_S, (
            r, float(got["real_error_s"]))


def test_process_mesh_wiener_segment_matches_one_process(reference, ranks):
    """The Gaussian rung from the slabs' sums (float64 sums, one eigh on
    rank 0, broadcast) within 1e-4 of the one-process runtime's (the SVD
    of the whole store), on every rank alike; its statistics alone on
    the device, the store on the host."""
    from _runtime_parity import ENG_KW
    from repro_torch.launch.runtime import ServeRuntime
    from repro_torch.launch.serve import ServeEngine
    eng = ServeEngine(ref_store(reference, "store"), device="cpu", **ENG_KW)
    rt = ServeRuntime(eng)
    outs = ranks[0]
    ts = tuple(int(x) for x in eng.plan.ts)
    want = rt._gauss_program(4, ts, 0, len(ts) - 1)(
        torch.from_numpy(outs[0]["gauss_x"])).numpy()
    for got in outs:
        np.testing.assert_allclose(got["gauss_seg"], want, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got["gauss_seg"], outs[0]["gauss_seg"])
        assert got["wiener_on"].tolist() == ["cpu", "cpu"]


def _monitor_engine(reference, m):
    from repro_torch.launch.serve import ServeEngine
    from _runtime_parity import ENG_KW
    return ServeEngine(ref_store(reference, "store2"),
                       index=port_index(reference), index_mode="always",
                       probe_schedule=monitor_probes(), device="cpu",
                       mesh=m, **ENG_KW)


def test_monitor_recall_is_global(reference, ranks):
    """The recall probe gives the global recall everywhere: a
    ``LocalMesh`` engine's (its slot holds the whole store) equals the
    one-device engine's, and so does every rank's over the
    ``ProcessMesh`` (the shards' screens merged), below 1 somewhere."""
    from repro_torch.obs import MetricsRegistry, QualityMonitor
    st2 = ref_store(reference, "store2")
    want = {}
    for name, m in (("one", None), ("local", mesh(8))):
        mon = QualityMonitor(_monitor_engine(reference, m).engine,
                             registry=MetricsRegistry(), sample_rate=1.0)
        want[name] = [mon.probe_recall(x, t) for x in monitor_queries(st2)
                      for t in MONITOR_TS]
    assert want["local"] == want["one"] and min(want["one"]) < 1.0
    for got in ranks[0]:
        assert got["monitor_recall"].tolist() == want["one"]


def test_process_mesh_runtime_monitor_matches_local_mesh(reference, ranks):
    """A runtime with a monitor (every seam probes) over the ranks: its
    health's recall and concentration equal the ``LocalMesh`` runtime's,
    its deliveries within ``REL``."""
    import json

    from _runtime_parity import FakeClock
    from repro_torch.launch.runtime import RuntimeConfig, ServeRuntime
    from repro_torch.launch.serve import Request
    from repro_torch.obs import MetricsRegistry, QualityMonitor
    eng = _monitor_engine(reference, mesh(8))
    clk = FakeClock()
    rt = ServeRuntime(eng, RuntimeConfig(clock=clk, sleep=clk.sleep),
                      monitor=QualityMonitor(eng.engine,
                                             registry=MetricsRegistry(),
                                             sample_rate=1.0))
    rt.warmup()
    tk = [rt.submit(Request(i, 1 + i % 3, seed=40 + i)) for i in range(4)]
    rt.run_until_idle()
    h = rt.health()
    want = {k: h[k] for k in MONITOR_HEALTH}
    assert want["n_recall_probes"] > 0
    imgs = np.concatenate([t.images for t in tk])
    for got in ranks[0]:
        assert json.loads(str(got["monitor_health"])) == want
        assert relerr(got["monitor_images"], imgs) <= REL


def _patch_gd(reference, name, m):
    from repro_torch.core import make_denoiser
    return GoldDiff(make_denoiser(name, image_store(reference), SCH,
                                  device="cpu"), mesh=m)


@pytest.mark.parametrize("name", PATCH_BASES)
def test_process_mesh_patch_bases_match_reference(reference, ranks, name):
    """GoldDiff over the Kamb / PCA base on 8 ranks (the support's rows
    gathered from the slabs) matches the reference's GoldDiff over its
    8-device mesh at ``TS``: supports equal, steps within ``REL``."""
    for got in ranks[0]:
        for t in TS:
            np.testing.assert_array_equal(
                got[f"patch_{name}_select_{t}"],
                reference[f"patch_{name}_select_{t}"])
            assert relerr(got[f"patch_{name}_{t}"],
                          reference[f"patch_{name}_{t}"]) <= REL, t


@pytest.mark.parametrize("name", PATCH_BASES)
def test_process_mesh_patch_bases_match_local_mesh(reference, ranks, name,
                                                   one_thread):
    """... and the port's ``LocalMesh`` of 8, the ranks bit-equal; every
    store-row tensor a rank holds (the engine's slot, the base's rows,
    the PCA feature caches) has n_loc rows, and the base's store stays
    on the host."""
    gd = _patch_gd(reference, name, mesh(8))
    n_loc = -(-257 // WORLD)
    outs = ranks[0]
    for t in TS:
        x = torch.from_numpy(reference[f"xpatch_{t}"])
        want, sel = gd(x, t).numpy(), gd.select(x, t).numpy()
        for got in outs:
            assert relerr(got[f"patch_{name}_{t}"], want) <= REL
            np.testing.assert_array_equal(got[f"patch_{name}_select_{t}"],
                                          sel)
            np.testing.assert_array_equal(got[f"patch_{name}_{t}"],
                                          outs[0][f"patch_{name}_{t}"])
    for got in outs:
        rows = got[f"patch_{name}_rows"].tolist()
        assert rows and set(rows) == {n_loc}
        sizes = {gd.base.patch_size(t) for t in TS}
        assert len(rows) == 2 + (len(sizes) if name == "pca" else 0)
        assert str(got[f"patch_{name}_store_on"]) == "cpu"


def test_process_mesh_pca_serve_one_rank(reference, ranks, one_thread):
    """``ServeEngine(base="pca")`` over a one-rank mesh (a group of one,
    on each rank): warmup builds the slab's feature caches, serving
    builds nothing, the images those of the one-device engine."""
    from repro_torch.launch.serve import Request, ServeEngine
    one = ServeEngine(image_store(reference), base="pca", device="cpu",
                      **PCA_SERVE)
    st = one.warmup()
    (want,) = one.serve([Request(0, 2, seed=5)])
    for got in ranks[0]:
        cache, builds, n_loc = got["pca_serve_cache"].tolist()
        assert cache == st["feature_cache_bytes"] > 0
        assert builds == 0 and n_loc == 257
        np.testing.assert_allclose(got["pca_serve"], want.images, atol=1e-4)


def test_slab_slots_and_gather_support():
    """Each slab's ``slab_slots`` maps exactly its real rows (padding
    maps nothing), and ``gather_support``'s per-slab buffers sum to the
    store's rows of any ids, bit for bit."""
    from repro_torch.index.shard import gather_support, slab_slots
    st = gmm(103, dim=6, seed=3, device="cpu")
    L = shard_layout(st, mesh(4))

    class One:                      # a slab's own buffer: the sum's part
        @staticmethod
        def psum(parts):
            (p,) = parts
            return p
    idx = torch.from_numpy(np.random.default_rng(0).integers(0, 103, (5, 7)))
    feats = st.X * 2 + 1
    total = [0, 0]
    owners = torch.zeros(103, dtype=torch.long)
    for sl in L.slabs:
        slots = slab_slots(sl, st.n)
        held = torch.nonzero(slots >= 0)[:, 0]
        assert held.numel() == sl.n_rows
        np.testing.assert_array_equal(sl.ids[slots[held].long()], held)
        owners[held] += 1
        rows = sl.X
        got = gather_support([rows, rows * 2 + 1], idx, slots, One)
        total = [a + b for a, b in zip(total, got)]
    assert bool((owners == 1).all())
    np.testing.assert_array_equal(total[0].numpy(), st.X[idx].numpy())
    np.testing.assert_array_equal(total[1].numpy(), feats[idx].numpy())
