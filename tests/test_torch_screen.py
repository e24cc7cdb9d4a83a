"""The port's streamed coarse screen and its routing policies against the
JAX package (CPU tensors, plain versions).

``screen_topm_scan`` is held against the reference's Pallas kernel in
interpret mode (``screen_topm_pallas``) and its materialized oracle
(``ref.screen_topm_ref``).  Integer-valued data keeps every fp32 sum
exact, so indices and distances are bit-equal, tie order included.  The
reference kernel's slot semantics are pinned against the kernel itself:
a slot whose distance is +inf (a +inf-norm row, or past N when m > N)
carries index 0, where the materialized oracle names the +inf row.
Float data: indices equal, distances within 1e-5 relative (fp32
reduction order); a 10-step trajectory within 1e-3 (per-step
differences compound through DDIM).

The CUDA kernel's host-side plan (``select_cap``, ``radix_plan``,
``sort_plan``, ``scratch_sizes``) is checked here too, with a numpy
model of what the kernel does with it: the radix passes must leave at
most cap keys that hold the m smallest, on any data, ties and +inf
included, and the chunk sort plus merge-path rounds must sort any count
of keys, padding included."""
import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import GoldDiff as JGoldDiff  # noqa: E402
from repro.core import OptimalDenoiser as JOptimal  # noqa: E402
from repro.core import make_schedule as jmake_schedule  # noqa: E402
from repro.core import sample as jsample  # noqa: E402
from repro.data import synthetic as jsynth  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.screen import screen_topm_pallas  # noqa: E402
from repro_torch.core import (GoldDiff, GoldDiffConfig,  # noqa: E402
                              GoldDiffEngine, OptimalDenoiser, make_schedule,
                              sample, store_from_numpy)
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import screen as tscreen  # noqa: E402
from repro_torch.kernels.screen import screen_topm_scan  # noqa: E402

DIST_RTOL = 1e-5     # fp32 reduction order of the distance dot products
TRAJ_TOL = 1e-3      # 10 DDIM steps compound the per-step differences


def ints(rng, shape):
    return rng.integers(-3, 4, size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def pallas(q, x, m, x_norms=None, tile=16):
    xn = None if x_norms is None else jnp.asarray(x_norms)
    idx, d2 = screen_topm_pallas(jnp.asarray(q), jnp.asarray(x), m,
                                 x_norms=xn, bn=tile, interpret=True)
    return np.asarray(idx), np.asarray(d2)


def scan(q, x, m, x_norms=None, tile=16):
    xn = None if x_norms is None else t(x_norms)
    idx, d2 = screen_topm_scan(t(q), t(x), m, x_norms=xn, tile=tile)
    return idx.numpy(), d2.numpy()


def check_against_oracle(q, x, m, x_norms, idx, d2):
    """Equal distances everywhere; equal indices on every finite slot;
    index 0 on every +inf slot."""
    xn = None if x_norms is None else jnp.asarray(x_norms)
    ri, rd = jref.screen_topm_ref(jnp.asarray(q), jnp.asarray(x), m,
                                  x_norms=xn)
    ri, rd = np.asarray(ri), np.asarray(rd)
    np.testing.assert_array_equal(d2, rd)
    fin = np.isfinite(rd)
    np.testing.assert_array_equal(idx[fin], ri[fin])
    assert (idx[~fin] == 0).all()


@pytest.mark.parametrize("b,n,d,m,tile", [
    (5, 300, 12, 40, 64),      # several tiles
    (4, 257, 16, 30, 64),      # ragged N: N % tile != 0
    (3, 50, 8, 64, 16),        # m > N: surplus slots
    (3, 64, 8, 64, 16),        # m == N
    (2, 40, 6, 1, 8),          # m == 1
    (6, 120, 10, 100, 32),     # m spans several tiles
])
def test_scan_bit_equal_to_pallas_on_integer_data(b, n, d, m, tile):
    rng = np.random.default_rng(n * 7 + m)
    q, x = ints(rng, (b, d)), ints(rng, (n, d))
    si, sd = scan(q, x, m, tile=tile)
    pi, pd = pallas(q, x, m, tile=tile)
    np.testing.assert_array_equal(si, pi)
    np.testing.assert_array_equal(sd, pd)
    check_against_oracle(q, x, m, None, si, sd)
    assert si.dtype == np.int64 and sd.dtype == np.float32


@pytest.mark.parametrize("m", [12, 40])
def test_all_tied_store_lowest_index_first(m):
    """Every distance equal: the lowest indices, in order, as lax.top_k."""
    q, x = np.zeros((2, 4), np.float32), np.ones((40, 4), np.float32)
    si, sd = scan(q, x, m, tile=8)
    pi, pd = pallas(q, x, m, tile=8)
    np.testing.assert_array_equal(si, pi)
    np.testing.assert_array_equal(sd, pd)
    np.testing.assert_array_equal(si, np.tile(np.arange(m), (2, 1)))


@pytest.mark.parametrize("m", [40, 49, 64])
def test_inf_norm_rows_and_surplus_slots_pinned_to_pallas(m):
    """+inf-norm rows screen last and never take a slot's index: every
    +inf slot carries index 0, exactly as the interpret-mode kernel."""
    rng = np.random.default_rng(m)
    q, x = ints(rng, (3, 8)), ints(rng, (50, 8))
    xn = (x * x).sum(-1)
    xn[[3, 10, 49]] = np.inf
    si, sd = scan(q, x, m, x_norms=xn)
    pi, pd = pallas(q, x, m, x_norms=xn)
    np.testing.assert_array_equal(si, pi)
    np.testing.assert_array_equal(sd, pd)
    check_against_oracle(q, x, m, xn, si, sd)
    assert np.isinf(sd).sum(-1).min() == max(m - 47, 0)


def test_float_data_indices_equal_distances_close():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(6, 24)).astype(np.float32)
    x = rng.normal(size=(2000, 24)).astype(np.float32)
    si, sd = scan(q, x, 128, tile=512)
    pi, pd = pallas(q, x, 128, tile=512)
    np.testing.assert_array_equal(si, pi)
    np.testing.assert_allclose(sd, pd, rtol=DIST_RTOL, atol=DIST_RTOL)


def test_ops_screen_topm_stream_switch():
    """ops.screen_topm: stream=False is the materialized form (the
    default), stream=True the carry loop; both the oracle's on finite
    slots."""
    rng = np.random.default_rng(3)
    q, x = ints(rng, (4, 10)), ints(rng, (90, 10))
    mi, md = tops.screen_topm(t(q), t(x), 33)
    si, sd = tops.screen_topm(t(q), t(x), 33, stream=True, tile=32)
    np.testing.assert_array_equal(mi.numpy(), si.numpy())
    np.testing.assert_array_equal(md.numpy(), sd.numpy())
    ri, _ = jref.screen_topm_ref(jnp.asarray(q), jnp.asarray(x), 33)
    np.testing.assert_array_equal(si.numpy(), np.asarray(ri))


# -- the engine's streamed route and its policies -----------------------------

@pytest.fixture(scope="module")
def stores():
    js = jsynth.image_store(256, 16, 16, 3, seed=2)
    ts = store_from_numpy(js.X, js.proxy, js.x_norms, js.proxy_norms,
                          js.image_shape, device="cpu")
    return js, ts, jmake_schedule("ddpm_linear", 1000), \
        make_schedule("ddpm_linear", 1000)


def test_streamed_trajectory_matches_reference_pallas(stores):
    """sample(GoldDiff(screen="streamed")) against the reference's same
    route on its Pallas kernels in interpret mode, from its x_T."""
    js, ts, jsched, tsched = stores
    shape = (3, js.dim)
    x_T = np.array(float(jsched.b[1000]) * jax.random.normal(
        jax.random.PRNGKey(4), shape))
    jgd = JGoldDiff(JOptimal(js, jsched), backend="pallas_interpret",
                    screen="streamed", fused=False)
    tgd = GoldDiff(OptimalDenoiser(ts, tsched, device="cpu"),
                   screen="streamed", fused=False)
    assert tgd.engine.use_stream(3) and not tgd.engine.use_fused(999)
    want = np.asarray(jsample(jgd, jsched, shape, jax.random.PRNGKey(0),
                              num_steps=10, x_init=jnp.asarray(x_T)))
    got = sample(tgd, tsched, shape, num_steps=10,
                 x_init=torch.from_numpy(x_T)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TRAJ_TOL, atol=TRAJ_TOL)


def test_streamed_select_equals_materialized(stores):
    """The two screen forms pick the same golden supports."""
    js, ts, jsched, tsched = stores
    rng = np.random.default_rng(1)
    x_t = torch.from_numpy(rng.normal(size=(4, js.dim)).astype(np.float32))
    engines = [GoldDiffEngine(ts, tsched, device="cpu", screen=s)
               for s in ("streamed", "materialized")]
    for step in (999, 500, 20):
        a, b = (e.select(x_t, step) for e in engines)
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_auto_policies_hand_computed(stores, monkeypatch):
    """use_fused / use_stream against cases worked out by hand from the
    tables in core/engine.py."""
    js, ts, jsched, tsched = stores
    cuda_frac = tengine.GATHER_CROSSOVER_FRAC["cuda"]
    cuda_budget = tengine.SCREEN_MATERIALIZE_BYTES["cuda"]
    # cpu: m_max/N = 64/256 = 0.25 > 0.10 -> "dense" -> auto fuses
    eng = GoldDiffEngine(ts, tsched, device="cpu")
    assert eng.crossover_frac == 0.10 and eng.strategy == "dense"
    assert eng.use_fused(999) and eng.use_fused(0)
    # m_max/N = 12/256 = 0.047 <= 0.10 -> "gather" -> staged
    small = GoldDiffConfig(m_min_frac=0.03, m_max_frac=0.05,
                           k_min_frac=0.01, k_max_frac=0.02)
    eng_small = GoldDiffEngine(ts, tsched, small, device="cpu")
    assert eng_small.strategy == "gather" and not eng_small.use_fused(500)
    assert GoldDiffEngine(ts, tsched, small, device="cpu",
                          fused=True).use_fused(500)
    assert not GoldDiffEngine(ts, tsched, device="cpu",
                              fused=False).use_fused(500)
    # cpu budget 2^31 bytes: 4 * 16 * 50000 = 3.2 MB materializes;
    # 4 * 16384 * 50000 = 3.3 GB streams
    assert not eng.use_stream(16, 50000) and eng.use_stream(16384, 50000)
    assert GoldDiffEngine(ts, tsched, device="cpu",
                          screen="streamed").use_stream(1)
    assert not GoldDiffEngine(ts, tsched, device="cpu",
                              screen="materialized").use_stream(1 << 20)
    # the card's entries, applied through the same rules
    monkeypatch.setitem(tengine.GATHER_CROSSOVER_FRAC, "cpu", cuda_frac)
    monkeypatch.setitem(tengine.SCREEN_MATERIALIZE_BYTES, "cpu", cuda_budget)
    card = GoldDiffEngine(ts, tsched, device="cpu")
    assert card.use_fused(500) == (0.25 > cuda_frac)
    for b in (16, 256, 4096):
        assert card.use_stream(b, 50000) == (4 * b * 50000 > cuda_budget)


@pytest.mark.parametrize("kw", [dict(screen="dense"), dict(fused="yes"),
                                dict(fused=None), dict(screen=True)])
def test_invalid_modes_raise(stores, kw):
    js, ts, jsched, tsched = stores
    with pytest.raises(ValueError, match="unknown"):
        GoldDiff(OptimalDenoiser(ts, tsched, device="cpu"), **kw)
    with pytest.raises(ValueError, match="unknown"):
        JGoldDiff(JOptimal(js, jsched), **kw)


# -- the CUDA kernel's plan (csrc/topm_select.cuh), and a model of its use --

U64 = np.uint64


def keys_of(d2):
    """The kernel's 64-bit keys ``(bits(d2) << 32) | row`` of fp32 d2."""
    d2 = np.asarray(d2, np.float32)
    bits = d2.view(np.uint32).astype(U64)
    return (bits << U64(32)) | np.arange(d2.size, dtype=U64)


def model_select(keys, m, cap, plan):
    """The radix passes on one query's keys: per pass the histogram of
    the digit over the keys inside the prefix, the coarse group (32 bins)
    and then the bin that holds the m-th key; done once the keys below
    the bin and in it are at most cap.  Returns the threshold: the query
    selects every key <= it."""
    if not plan:
        return int(np.iinfo(U64).max)
    prefix, need = 0, m
    for shift, width in plan:
        top = shift + width
        inside = keys if top >= 64 else keys[(keys >> U64(top))
                                             == U64(prefix >> top)]
        digit = ((inside >> U64(shift)) & U64((1 << width) - 1)).astype(
            np.int64)
        hist = np.bincount(digit, minlength=tscreen.HIST_INTS - 64)
        coarse = np.cumsum(hist.reshape(64, 32).sum(1))
        g = int(np.searchsorted(coarse, need))      # first incl >= need
        base = int(coarse[g - 1]) if g else 0
        fine = base + np.cumsum(hist[32 * g: 32 * g + 32])
        lane = int(np.searchsorted(fine, need))
        left = need - (int(fine[lane - 1]) if lane else base)
        prefix |= (32 * g + lane) << shift
        need = left
        if m - left + hist[32 * g + lane] <= cap:
            return prefix | ((1 << shift) - 1)
    raise AssertionError("the plan left the m-th key unresolved")


def split(a, b, k):
    """How many of the first k keys of merge(a, b) come from a."""
    lo, hi = max(0, k - len(b)), min(k, len(a))
    while lo < hi:
        i = (lo + hi) // 2
        if a[i] < b[k - i - 1]:
            lo = i + 1
        else:
            hi = i
    return lo


def warp_split(a, b, k):
    """The same split by 32 probes a step, as one warp finds it."""
    lo, hi = max(0, k - len(b)), min(k, len(a))
    while lo < hi:
        step = (hi - lo + 30) // 31
        probe = [min(lo + lane * step, hi) for lane in range(32)]
        f = next(lane for lane, i in enumerate(probe)
                 if i == hi or a[i] >= b[k - i - 1])
        lo, hi = (lo + (f - 1) * step + 1 if f else lo), probe[f]
    return lo


def model_sort(keys, chunk, tile=2048, items=8):
    """Sorted chunks, then merge rounds in which each CTA writes one
    ``tile`` of outputs from its split, each thread ``items`` of them."""
    s = len(keys)
    buf = np.concatenate([np.sort(keys[c: c + chunk])
                          for c in range(0, s, chunk)])
    w = chunk
    while w < s:
        out = np.empty_like(buf)
        for o0 in range(0, s, tile):
            p0 = o0 // (2 * w) * 2 * w
            la, lb = min(w, s - p0), max(0, min(w, s - p0 - w))
            a, b = buf[p0: p0 + la], buf[p0 + la: p0 + la + lb]
            k0 = o0 - p0
            k1 = min(k0 + tile, la + lb)
            a0, a1 = warp_split(a, b, k0), warp_split(a, b, k1)
            sa, sb = a[a0:a1], b[k0 - a0: k1 - a1]
            n = k1 - k0
            for t in range(tile // items):
                kt = min(items * t, n)
                ia = split(sa, sb, kt)
                ib = kt - ia
                for j in range(min(items, n - kt)):
                    take_a = ib >= len(sb) or (ia < len(sa)
                                               and sa[ia] < sb[ib])
                    out[o0 + kt + j] = sa[ia] if take_a else sb[ib]
                    ia, ib = ia + take_a, ib + (not take_a)
        buf, w = out, 2 * w
    return buf


@pytest.mark.parametrize("n", [2050, 4096, 50000, 1 << 22, (1 << 22) + 1,
                               1 << 31])
def test_radix_plan_covers_the_key(n):
    """The digits are disjoint, at most 11 bits, and cover bits 32-62
    (the distance: bit 63 is always 0) and every bit of n - 1; no pass
    when the cap takes every row."""
    plan = tscreen.radix_plan(n, 1)
    bits = (n - 1).bit_length()
    assert 3 <= len(plan) <= tscreen.MAX_PASSES
    covered = []
    for shift, width in plan:
        assert 1 <= width <= tscreen.RADIX_BITS
        covered += range(shift, shift + width)
    assert len(set(covered)) == len(covered)
    assert sorted(covered) == list(range(bits)) + list(range(32, 63))
    assert tscreen.radix_plan(n, n) == () == tscreen.radix_plan(n, n + 5)
    assert tscreen.radix_plan(n, n - 2048) == ()
    assert tscreen.radix_plan(2049, 1) == ()


@pytest.mark.parametrize("n,m,cap", [(50000, 12500, 14548),
                                     (50000, 5000, 7048),
                                     (50000, 49000, 50000), (300, 400, 300),
                                     (10, 1, 10)])
def test_select_cap(n, m, cap):
    assert tscreen.select_cap(n, m) == cap


def test_radix_plan_main_shape():
    assert tscreen.radix_plan(50000, 12500) == ((52, 11), (41, 11), (32, 9),
                                                (11, 5), (0, 11))


@pytest.mark.parametrize("kind", ["float", "int", "tied", "inf", "zero"])
@pytest.mark.parametrize("n,m", [(50000, 12500), (5000, 1), (5000, 2400),
                                 (6000, 2500), (3000, 900)])
def test_radix_model_selects_the_m_smallest_keys(kind, n, m):
    rng = np.random.default_rng(n + m)
    if kind == "float":
        d2 = rng.gamma(40.0, 5.0, n)
    elif kind == "int":
        d2 = rng.integers(0, 60, n)
    elif kind == "tied":
        d2 = np.full(n, 8.0)
    elif kind == "inf":
        d2 = np.where(rng.random(n) < 0.9, np.inf, rng.integers(0, 9, n))
    else:
        d2 = np.zeros(n)
    keys = keys_of(d2)
    cap = tscreen.select_cap(n, m)
    thr = model_select(keys, m, cap, tscreen.radix_plan(n, m))
    picked = np.sort(keys[keys <= U64(thr)])
    assert m <= len(picked) <= cap
    np.testing.assert_array_equal(picked[:m], np.sort(keys)[:m])


@pytest.mark.parametrize("s,plan", [
    (1, (64, 1, 0)), (40, (64, 1, 0)), (64, (64, 1, 0)), (65, (128, 1, 0)),
    (2048, (2048, 1, 0)),          # one chunk
    (2049, (2048, 2, 1)),          # one chunk + 1
    (3 * 2048 - 1, (2048, 3, 2)),  # a multiple of chunks - 1
    (5000, (2048, 3, 2)), (12500, (2048, 7, 3)), (20000, (2048, 10, 4)),
])
def test_sort_plan(s, plan):
    assert tscreen.sort_plan(s) == plan


@pytest.mark.parametrize("s,c", [(1, 1), (63, 40), (2048, 2048), (2049, 2049),
                                 (3 * 2048 - 1, 4000), (4096, 2100),
                                 (14548, 12500), (20000, 19999)])
def test_merge_model_sorts(s, c):
    """c unique keys in any order, then s - c empty slots (KEY_PAD, the
    only key that repeats): the chunk sort and the merge rounds of the
    plan give them ascending, whatever the ragged last run."""
    rng = np.random.default_rng(s)
    keys = keys_of(rng.integers(0, 50, c).astype(np.float32))
    keys = np.concatenate([keys[rng.permutation(c)],
                           np.full(s - c, np.iinfo(U64).max, U64)])
    chunk = tscreen.sort_plan(s)[0]
    np.testing.assert_array_equal(model_sort(keys, chunk), np.sort(keys))


@pytest.mark.parametrize("b,n,m,want", [
    (16, 50000, 12500, dict(state=384, work=16 + 5 * (1 + 16 * 2112),
                            keys=2 * 16 * 14548, cap=14548)),
    (33, 50000, 5000, dict(state=33 * 24, work=33 + 5 * (3 + 33 * 2112),
                           keys=2 * 33 * 7048, cap=7048)),
    (4, 300, 400, dict(state=96, work=4, keys=2 * 4 * 300, cap=300)),
])
def test_scratch_sizes(b, n, m, want):
    """O(B (m + 2112 bins a pass)): keys scale with m, not N."""
    assert tscreen.scratch_sizes(b, n, m) == want
