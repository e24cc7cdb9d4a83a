"""Kernel 7 as one probe launch: its plain version and host plan, on the CPU.

``ops.ivf_probe`` takes the indexed step from the rescaled query to the
probed candidates: the proxy pooling, the centroid distances, the
stable top-nprobe windows and the CSR window expansion.  On the CPU it
is ``ref.ivf_probe_ref`` (the chain the engine ran before), held here
against the JAX package fed the same index through ``index_from_numpy``
(``downsample_proxy``, ``centroid_scan`` and ``ivf_screen``'s capacity
mode, on ``xla`` and ``pallas_interpret``).  A numpy model of the
CUDA kernel (``csrc/centroid_scan.cu``) follows its key, its places by
counting, its rank split and its slot split (``centroid_scan.plan``),
and is held against the plain version.

Tolerances: on integer-valued data every fp32 sum is exact, so the
pooled proxy, the distances, the probe lists, ``pos``, ``ids``,
validity and markers are equal; on the float gmm store distances agree
to 1e-5 relative and the probe lists are equal up to near-ties (two
windows whose distances differ by less than 1e-5 relative); a 10-step
indexed trajectory on an image store agrees to 1e-3.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import GoldDiff as JGoldDiff  # noqa: E402
from repro.core import GoldDiffConfig as JConfig  # noqa: E402
from repro.core import OptimalDenoiser as JOptimal  # noqa: E402
from repro.core import make_schedule as jmake_schedule  # noqa: E402
from repro.core import sample as jsample  # noqa: E402
from repro.core.dataset import downsample_proxy as jdownsample  # noqa: E402
from repro.data import gmm as jgmm  # noqa: E402
from repro.data import mnist_like as jmnist_like  # noqa: E402
from repro.index import GoldenIndex as JIndex  # noqa: E402
from repro.index import ProbeSchedule as JProbes  # noqa: E402
from repro.index import build_index as jbuild_index  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import (GoldDiff, GoldDiffConfig,  # noqa: E402
                              GoldDiffEngine, OptimalDenoiser,
                              make_schedule, sample, sampling_timesteps,
                              store_from_numpy)
from repro_torch.index import ProbeSchedule, index_from_numpy  # noqa: E402
from repro_torch.kernels import centroid_scan as cs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

JBACKENDS = ["xla", "pallas_interpret"]
FRACS = dict(m_min_frac=1 / 64, m_max_frac=1 / 16, k_min_frac=1 / 128,
             k_max_frac=1 / 64)
JSCH = jmake_schedule("ddpm_linear", 1000)
TSCH = make_schedule("ddpm_linear", 1000)
REL = 1e-5


def ints(shape, seed):
    return np.random.default_rng(seed).integers(-3, 4, shape).astype(
        np.float32)


def carry_store(js):
    return store_from_numpy(js.X, js.proxy, js.x_norms, js.proxy_norms,
                            js.image_shape, device="cpu")


def index_fields(jix, integer: bool):
    """The reference index's arrays; with ``integer`` its centroids and
    proxies replaced by integer values (the CSR layout kept)."""
    f = {k: np.array(getattr(jix, k)) for k in JIndex._fields[:-1]}
    if integer:
        c = ints(f["centroids"].shape, 8)
        c[1::7] = c[::7][: len(c[1::7])]      # duplicated centroids: ties
        ps = ints(f["proxy_sorted"].shape, 7)
        f.update(centroids=c, centroid_norms=(c * c).sum(-1),
                 proxy_sorted=ps, proxy_norms_sorted=(ps * ps).sum(-1))
    return f


@pytest.fixture(scope="module", params=["gmm", "image"])
def setup(request):
    """(kind, reference store, reference index) on a gmm store (no
    pooling) and an image store (28x28x1, pooled 4x to 7x7x1)."""
    if request.param == "gmm":
        js = jgmm(4096, dim=16, seed=3)
        return "gmm", js, jbuild_index(js, num_clusters=64)
    js = jmnist_like(2048, seed=1)
    return "image", js, jbuild_index(js, num_clusters=32)


def reference_probe(js, f, q, p, L, backend):
    """The JAX package's level 1 on queries q [B, D]: its pooling, its
    centroid scan and lax.top_k, and ivf_screen's capacity mode."""
    qj = jnp.asarray(q).reshape((q.shape[0],) + tuple(js.image_shape))
    qp = jdownsample(qj, 4) if len(js.image_shape) == 3 else jnp.asarray(q)
    a = {k: jnp.asarray(v) for k, v in f.items()}
    cd2 = jops.centroid_scan(qp, a["centroids"], a["centroid_norms"],
                             backend=backend)
    probe = jax.lax.top_k(-cd2, p)[1]
    pos, d2 = jops.ivf_screen(qp, a["proxy_sorted"], a["proxy_norms_sorted"],
                              a["offsets"], a["centroids"],
                              a["centroid_norms"], p * L, p, L,
                              backend=backend)
    return (np.asarray(qp), np.asarray(cd2), np.asarray(probe),
            np.asarray(pos), np.asarray(d2))


def port_probe(js, f, q, p, L, nprobe=None):
    return ops.ivf_probe(torch.from_numpy(q), js.image_shape, 4,
                         torch.from_numpy(f["centroids"]),
                         torch.from_numpy(f["centroid_norms"]),
                         torch.from_numpy(f["offsets"].astype(np.int64)),
                         torch.from_numpy(f["perm"].astype(np.int64)),
                         len(f["perm"]), p, L, nprobe)


def assert_probes_equal_up_to_near_ties(got, want, cd2):
    """Equal probe lists, or differences only between windows whose
    distances differ by less than REL relative."""
    for b in np.nonzero((got != want).any(-1))[0]:
        d = np.nonzero(got[b] != want[b])[0]
        a, w = cd2[b, got[b, d]], cd2[b, want[b, d]]
        assert (np.abs(a - w) <= REL * np.maximum(np.abs(w), 1.0)).all(), (
            b, d, a, w)


# -- the plain version against the JAX package -------------------------------

@pytest.mark.parametrize("backend", JBACKENDS)
@pytest.mark.parametrize("integer", [True, False])
def test_ivf_probe_ref_matches_reference(setup, backend, integer):
    kind, js, jix = setup
    f = index_fields(jix, integer)
    L, c = jix.max_cluster, len(f["centroids"])
    rng = np.random.default_rng(11)
    x = np.asarray(js.X)
    q = (ints((6, js.dim), 12) if integer else
         (x[rng.integers(0, js.n, 6)] + 0.3 * rng.normal(size=(6, js.dim))
          ).astype(np.float32))
    for p in (1, 5, c):
        jqp, jcd2, jprobe, jpos, jd2 = reference_probe(js, f, q, p, L,
                                                       backend)
        pr = port_probe(js, f, q, p, L)
        if integer:
            np.testing.assert_array_equal(pr.probe.numpy(), jprobe)
            np.testing.assert_array_equal(pr.pos.numpy(), jpos)
        else:
            assert_probes_equal_up_to_near_ties(pr.probe.numpy(), jprobe,
                                                jcd2)
            if (pr.probe.numpy() == jprobe).all():
                np.testing.assert_array_equal(pr.pos.numpy(), jpos)
        np.testing.assert_array_equal(pr.marker.numpy(),
                                      np.where(pr.valid.numpy(), 0, np.inf))
        if (pr.probe.numpy() == jprobe).all():
            np.testing.assert_array_equal(pr.marker.numpy(), jd2)
        # ids / valid are what the engine took: perm[pos] and isfinite
        perm = torch.from_numpy(f["perm"].astype(np.int64))
        assert torch.equal(pr.ids, perm[pr.pos])
        assert torch.equal(pr.valid, torch.isfinite(pr.marker))


def test_pooling_matches_reference_bit_for_bit(setup):
    """The plain pooling the kernel repeats equals the reference's, on
    integer and on float queries."""
    kind, js, jix = setup
    for q in (ints((5, js.dim), 3),
              np.random.default_rng(4).normal(size=(5, js.dim)).astype(
                  np.float32)):
        shape = (5,) + tuple(js.image_shape)
        want = np.asarray(jdownsample(jnp.asarray(q).reshape(shape), 4))
        got = ref.downsample_proxy(torch.from_numpy(q).reshape(shape), 4)
        np.testing.assert_array_equal(got.numpy(), want)


def test_engine_probe_matches_old_chain(setup):
    """The engine's level 1 gives what its old chain did: ivf_screen in
    capacity mode on the pooled query, ``perm[pos]``, ``isfinite``."""
    kind, js, jix = setup
    ts = carry_store(js)
    f = index_fields(jix, False)
    tix = index_from_numpy(max_cluster=jix.max_cluster, device="cpu", **f)
    eng = GoldDiffEngine(ts, TSCH, GoldDiffConfig(**FRACS), device="cpu",
                         index=tix, index_mode="always")
    q = torch.from_numpy(np.asarray(js.X)[:7] + 0.2)
    for t in (999, 500, 20):
        p = eng.nprobe(t)
        pos, pd2 = eng.coarse_indexed(q, eng.padded_m(t), p)
        pr = eng.probe(q, p)
        assert pr.pos is None and pr.marker is None and pr.probe is None
        assert torch.equal(pr.ids, tix.perm[pos])
        assert torch.equal(pr.valid, torch.isfinite(pd2))


def test_indexed_trajectory_on_image_store_matches_reference():
    """The whole slice on an image store (pooled in the probe): 10
    indexed steps against the JAX package from the same x_T."""
    js = jmnist_like(1024, seed=2)
    jix = jbuild_index(js, num_clusters=24)
    tix = index_from_numpy(max_cluster=jix.max_cluster, device="cpu",
                           **index_fields(jix, False))
    probes = dict(f_lo=1 / 8, f_hi=1 / 2)
    jgd = JGoldDiff(JOptimal(js, JSCH), JConfig(**FRACS), index=jix,
                    probe_schedule=JProbes(**probes), index_mode="always")
    tgd = GoldDiff(OptimalDenoiser(carry_store(js), TSCH, device="cpu"),
                   GoldDiffConfig(**FRACS), index=tix,
                   probe_schedule=ProbeSchedule(**probes),
                   index_mode="always")
    assert all(tgd.engine.use_index(int(t))
               for t in sampling_timesteps(TSCH, 10)[:-1])
    shape = (3, js.dim)
    x_T = np.array(float(JSCH.b[1000]) * jax.random.normal(
        jax.random.PRNGKey(3), shape))
    want = np.asarray(jsample(jgd, JSCH, shape, jax.random.PRNGKey(7),
                              num_steps=10, x_init=jnp.asarray(x_T)))
    got = sample(tgd, TSCH, shape, num_steps=10,
                 x_init=torch.from_numpy(x_T)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


# -- a numpy model of the kernel: its key, places and splits -----------------

def keys_of(d2):
    """The kernel's key (bits(d2 + 0) << 32) | window, per query row."""
    d2 = np.asarray(d2, np.float32) + np.float32(0.0)        # -0 -> +0
    j = np.arange(d2.shape[-1], dtype=np.uint64)
    return (d2.view(np.uint32).astype(np.uint64) << np.uint64(32)) | j


def slot_ranges(p, L):
    """The slots [s0, s1) each rank writes: ``plan().chunk`` a rank from
    r chunk, cut at P L (the kernel's step 4)."""
    chunk = cs.plan(p, 1, p, L).chunk
    return [(min(p * L, r * chunk), min(p * L, (r + 1) * chunk))
            for r in range(cs.CLUSTER)]


def model_probe(d2, offsets, perm, n, p, L, nprobe=None):
    """The kernel's steps 3-4 on the distances d2 [B, C]: each rank's
    windows, each key's place counted by ``group`` threads, the probe
    list, then each rank's slot range."""
    b, c = d2.shape
    pl_ = cs.plan(c, 1, p, L)
    keys = keys_of(d2)
    probe = np.full((b, p), -1, np.int64)
    for r in range(cs.CLUSTER):
        for j in range(r * pl_.rows, min(c, (r + 1) * pl_.rows)):
            # the group's threads count strided shares of the keys
            place = sum((keys[:, gi::pl_.group] < keys[:, j:j + 1]).sum(-1)
                        for gi in range(pl_.group))
            for bb in np.nonzero(place < p)[0]:
                assert probe[bb, place[bb]] == -1      # places are unique
                probe[bb, place[bb]] = j
    assert (probe >= 0).all()
    live = p if nprobe is None else int(nprobe)
    s = p * L
    pos = np.empty((b, s), np.int64)
    valid = np.empty((b, s), bool)
    for s0, s1 in slot_ranges(p, L):
        for sl in range(s0, s1):
            pp, lane = divmod(sl, L)
            w = probe[:, pp]
            raw = offsets[w] + lane
            valid[:, sl] = (raw < offsets[w + 1]) & (pp < live)
            pos[:, sl] = np.minimum(raw, n - 1)
    return probe, pos, perm[pos], valid, np.where(valid, 0.0, np.inf)


def synthetic_index(c, L, seed, dup=True):
    """A CSR layout of C windows of 1..L rows (one of L), a permutation
    of its rows, integer centroids with split windows duplicated."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, L + 1, c)
    sizes[rng.integers(0, c)] = L
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(offsets[-1])
    cents = ints((c, 12), seed + 1)
    if dup and c > 2:
        cents[1::3] = cents[0::3][: len(cents[1::3])]
    return offsets, rng.permutation(n).astype(np.int64), n, cents


@pytest.mark.parametrize("c,p", [(1, 1), (5, 1), (5, 5), (37, 9),
                                 (230, 8), (230, 230), (617, 25),
                                 (617, 617)])
def test_kernel_model_matches_plain_version(c, p):
    L = 7
    offsets, perm, n, cents = synthetic_index(c, L, c + p)
    cn = (cents * cents).sum(-1)
    if c > 3:
        cn[-1] = np.inf                           # a padded window
    q = ints((3, 12), c)
    q[0] = cents[min(2, c - 1)]                   # a zero distance
    t = {k: torch.from_numpy(v) for k, v in
         dict(cents=cents, cn=cn, offsets=offsets, perm=perm).items()}
    want = ref.ivf_probe_ref(torch.from_numpy(q), t["cents"], t["cn"],
                             t["offsets"], t["perm"], n, p, L)
    d2 = ref.centroid_scan_ref(torch.from_numpy(q), t["cents"], t["cn"])
    got = model_probe(d2.numpy(), offsets, perm, n, p, L)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    zero = np.nonzero(d2[0].numpy() == 0)[0]
    assert min(2, c - 1) in zero and want.probe[0, 0] == zero[0]
    if c > 3 and p == c:
        assert want.probe[:, -1].tolist() == [c - 1] * 3   # +inf: last


def test_key_canonicalises_negative_zero():
    """-0.0's bits sort after +inf: the kernel adds +0 before taking
    them, so a zero distance comes first however it was rounded."""
    neg, inf = np.float32(-0.0), np.float32(np.inf)
    assert neg.view(np.uint32) > inf.view(np.uint32)
    d2 = np.array([[inf, 1.0, neg, 0.0, inf, 1.0]], np.float32)
    raw = (d2.view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
        np.arange(6, dtype=np.uint64)
    assert list(np.argsort(raw[0])[:2]) == [3, 1]      # wrong without it
    want = torch.sort(torch.from_numpy(d2), dim=-1, stable=True)[1]
    assert list(np.argsort(keys_of(d2)[0])) == want[0].tolist() == \
        [2, 3, 1, 5, 0, 4]


def test_key_orders_ties_and_inf_windows_like_a_stable_sort():
    rng = np.random.default_rng(5)
    d2 = rng.integers(0, 4, (4, 300)).astype(np.float32)
    d2[:, rng.integers(0, 300, 40)] = np.inf
    want = torch.sort(torch.from_numpy(d2), dim=-1, stable=True)[1].numpy()
    np.testing.assert_array_equal(np.argsort(keys_of(d2), -1), want)
    assert len(np.unique(keys_of(d2)[0])) == 300         # keys are unique


@pytest.mark.parametrize("nprobe", [0, 3, 7, 9, torch.tensor(4),
                                    torch.tensor(7, dtype=torch.int32)])
def test_kernel_model_nprobe_mask(nprobe):
    c, p, L = 40, 7, 5
    offsets, perm, n, cents = synthetic_index(c, L, 3)
    q = torch.from_numpy(ints((2, 12), 4))
    t = [torch.from_numpy(a) for a in (cents, (cents * cents).sum(-1),
                                       offsets, perm)]
    want = ref.ivf_probe_ref(q, *t, n, p, L, nprobe=nprobe)
    d2 = ref.centroid_scan_ref(q, t[0], t[1]).numpy()
    got = model_probe(d2, offsets, perm, n, p, L, nprobe=nprobe)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    live = min(p, max(0, int(nprobe)))
    assert not want.valid.reshape(2, p, L)[:, live:].any()


# -- the host plan --------------------------------------------------------------

@pytest.mark.parametrize("c,dp,p,L", [(1, 9, 1, 3), (230, 192, 8, 334),
                                      (617, 64, 617, 192),
                                      (4097, 192, 4097, 16),
                                      (16384, 192, 16384, 4)])
def test_plan(c, dp, p, L):
    pl_ = cs.plan(c, dp, p, L)
    assert pl_.rows * cs.CLUSTER >= c > (pl_.rows - 1) * cs.CLUSTER
    assert pl_.group & (pl_.group - 1) == 0 and 1 <= pl_.group <= 32
    assert cs.THREADS // pl_.group >= pl_.rows or pl_.group == 1
    assert pl_.smem == 4 * (dp + dp % 2) + 8 * c + 4 * p <= cs.SMEM_BYTES
    ranges = slot_ranges(p, L)
    assert ranges[0][0] == 0 and ranges[-1][1] == p * L
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(s1 - s0 <= pl_.chunk for s0, s1 in ranges)


def test_plan_distance_stage_has_no_cap():
    assert cs.plan(40000, 64, 0, 0).smem == 256


def test_window_cap_raises():
    with pytest.raises(ValueError, match="16384"):
        cs.plan(cs.MAX_WINDOWS + 1, 64, 8, 10)
    with pytest.raises(ValueError, match="nprobe_max 9 > 8"):
        cs.plan(8, 64, 9, 10)
    c = cs.MAX_WINDOWS + 1
    with pytest.raises(ValueError, match="cap of 16384"):
        cs.ivf_probe(torch.zeros(2, 4), (4,), 1, torch.zeros(c, 4),
                     torch.zeros(c), torch.zeros(c + 1, dtype=torch.int64),
                     torch.arange(c), c, 4, 1)


def test_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors are
    ``ops``' business."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        cs.ivf_probe(torch.zeros(2, 4), (4,), 1, torch.zeros(3, 4),
                     torch.zeros(3), torch.zeros(4, dtype=torch.int64),
                     torch.arange(3), 3, 2, 1)


@pytest.mark.parametrize("shape,factor,want", [
    ((32, 32, 3), 4, (32, 3, 4, 192)),
    ((28, 28, 1), 4, (28, 1, 4, 49)),
    ((64, 64, 3), 4, (64, 3, 4, 768)),
    ((30, 30, 3), 4, (30, 3, 4, 147)),      # cropped to 28x28
    ((32, 32, 3), 1, (32, 3, 1, 3072)),
    ((32, 32, 3), 2, (32, 3, 2, 768)),
    ((32, 32, 3), 3, (32, 3, 3, 300)),      # cropped to 30x30, 9 samples
    ((32, 32, 3), 8, (32, 3, 8, 48)),       # 64 samples: four chunks
    ((16,), 4, (1, 1, 0, 16)),
])
def test_pool_geometry(shape, factor, want):
    assert cs.pool_geometry(shape, factor) == want
    w, ch, f, dp = want
    rng = np.random.default_rng(6)
    for q in (torch.from_numpy(ints((2,) + shape, 6)),
              torch.from_numpy(rng.standard_normal((2,) + shape,
                                                   dtype=np.float32))):
        assert ref.downsample_proxy(q, factor).shape == (2, dp)
        # the kernel's index map and fold (sample k = (k // f, k % f) of
        # the window, read in chunks of 16, folded left), in numpy, bit
        # for bit
        flat = q.reshape(2, -1).numpy()
        got = np.empty((2, dp), np.float32)
        for o in range(dp):
            if not f:
                got[:, o] = flat[:, o]
                continue
            chn, ij = o % ch, o // ch
            j, i = ij % (w // f), ij // (w // f)
            base = (i * f * w + j * f) * ch + chn
            acc = None
            for k0 in range(0, f * f, 16):
                for k in range(k0, min(k0 + 16, f * f)):
                    x = flat[:, base + ((k // f) * w + k % f) * ch]
                    acc = x.copy() if acc is None else acc + x
            got[:, o] = acc / np.float32(f * f)
        np.testing.assert_array_equal(got, ref.downsample_proxy(q, factor))


def test_pool_geometry_refuses_other_shapes():
    with pytest.raises(ValueError, match="neither"):
        cs.pool_geometry((28, 28), 4)
    # below the factor the reference's proxy keeps the image's shape
    assert ref.downsample_proxy(torch.zeros(2, 3, 3, 2), 4).shape == (
        2, 3, 3, 2)
    with pytest.raises(ValueError, match="flat proxy"):
        cs.pool_geometry((3, 3, 2), 4)
    with pytest.raises(ValueError, match="neither"):
        ops.ivf_probe(torch.zeros(2, 784), (28, 28), 4, torch.zeros(3, 49),
                      torch.zeros(3), torch.zeros(4, dtype=torch.int64),
                      None, 3, 1, 1)


def test_ops_fields_select_outputs():
    offsets, perm, n, cents = synthetic_index(20, 6, 9)
    args = (torch.from_numpy(ints((3, 12), 1)), (12,), 4,
            torch.from_numpy(cents), torch.from_numpy((cents * cents).sum(-1)),
            torch.from_numpy(offsets), torch.from_numpy(perm), n, 4, 6)
    full = ops.ivf_probe(*args)
    assert all(v is not None for v in full)
    part = ops.ivf_probe(*args, fields=("ids", "valid"))
    assert part.probe is None and part.pos is None and part.marker is None
    assert torch.equal(part.ids, full.ids)
    assert torch.equal(part.valid, full.valid)
    assert torch.equal(full.ids, torch.from_numpy(perm)[full.pos])
