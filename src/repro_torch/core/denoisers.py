"""Analytical denoisers: map ``x_t: [B, D]`` at timestep ``t`` to the
posterior-mean estimate ``x0_hat: [B, D]``.

Counterpart of ``repro.core.denoisers``, the paper's baseline hierarchy
(Sec. 4.1):

* ``OptimalDenoiser`` -- the exact empirical-Bayes posterior mean
  (Eq. 2): its unbiased (``ss``) full scan and golden ``support=`` path
  go through ``repro_torch.kernels.ops``; the biased ``wss`` weighting
  keeps the chunked streaming estimators;
* ``WienerDenoiser`` -- the linear-MMSE estimator from the dataset's
  mean and covariance (an SVD in float64 on the host, as the reference);
* ``PatchDenoiser`` -- Kamb & Ganguli's per-pixel patch posterior with a
  timestep-dependent patch size;
* ``PCADenoiser`` -- Lukoianov et al.: patch features projected onto a
  rank-r PCA basis (one convolution), the biased WSS by default.

Each takes ``device=`` (the CUDA card unless the caller passes another;
raises when there is none) and moves the store there.  Every corpus-
scanning base takes a per-query golden ``support`` ([B, k] row ids),
the hook GoldDiff plugs into (Tab. 5).  The patch bases' distances,
box sums and per-pixel softmaxes are plain PyTorch, as they are plain
jnp in the reference; their convolutions run in fp32 (cuDNN's TF32 is
turned off around them).
"""
from __future__ import annotations

import contextlib
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import streaming
from repro_torch.core.dataset import DatasetStore, pairwise_sq_dists
from repro_torch.core.schedules import Schedule
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.utils import resolve_device

Weighting = Literal["ss", "wss"]

# Bytes of the [b, k, H, W, channels] gather a patch base's support path
# holds at once: queries are taken in groups under it (one group at
# cifar10's k_t; about four at imagenet's k_t = 2000).
SUPPORT_GATHER_BYTES = 1 << 30


@contextlib.contextmanager
def _fp32_convolutions():
    """cuDNN convolutions in fp32, as the reference computes them: cuDNN
    defaults to TF32 for fp32 inputs.  (``torch.backends.cudnn.flags``
    would also reset its other flags, turning cuDNN off by default.)"""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Optimal (full-scan empirical Bayes, Eq. 2)
# ---------------------------------------------------------------------------

class OptimalDenoiser:
    """Exact posterior mean over the training set (or a golden support)."""

    name = "optimal"

    def __init__(self, store: DatasetStore, schedule: Schedule,
                 chunk: int = 8192, weighting: Weighting = "ss", device=None):
        self.store = store.to(resolve_device(device))
        self.device = self.store.device
        self.schedule = schedule
        self.chunk = chunk
        self.weighting = weighting

    def logits(self, x_t: torch.Tensor, t: int) -> torch.Tensor:
        """Full-scan logits l_i = -||x_t/a_t - x_i||^2 / (2 sigma_t^2); [B,N]."""
        a = float(self.schedule.a[t])
        sig2 = float(self.schedule.sigma_np(t)) ** 2
        d2 = pairwise_sq_dists(x_t / a, self.store.X, self.store.x_norms)
        return -d2 / (2.0 * sig2)

    def __call__(self, x_t: torch.Tensor, t: int,
                 support: torch.Tensor | None = None) -> torch.Tensor:
        if support is not None:
            return self._on_support(x_t, t, support)
        if self.weighting == "wss":
            return streaming.weighted_streaming_softmax_mean(
                self.logits(x_t, t), self.store.X, self.chunk)
        a = float(self.schedule.a[t])
        sig2 = float(self.schedule.sigma_np(t)) ** 2
        return ops.golden_aggregate(x_t / a, self.store.X, sig2,
                                    x_norms=self.store.x_norms).to(x_t.dtype)

    def _on_support(self, x_t: torch.Tensor, t: int, idx: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
        a = float(self.schedule.a[t])
        sig2 = float(self.schedule.sigma_np(t)) ** 2
        q = x_t / a                                # [B, D]
        d2 = ops.support_distances(q, self.store.X, idx,
                                   x_norms=self.store.x_norms)
        lg = -d2 / (2.0 * sig2)
        if mask is not None:
            lg = torch.where(mask, lg, NEG_INF)
        if self.weighting == "wss":
            return streaming.wss_combine(lg, self.store.X[idx])
        return ops.golden_support_aggregate(self.store.X, idx,
                                            lg).to(x_t.dtype)


# ---------------------------------------------------------------------------
# Wiener (linear MMSE; N enters only through precomputed statistics)
# ---------------------------------------------------------------------------

class WienerDenoiser:
    """x0_hat = mu + Sigma a (a^2 Sigma + b^2 I)^-1 (x_t - a mu), Sigma
    through the SVD of the centered data (float64 numpy on the host, as
    in the reference); V and the eigenvalues then move to the device.

    Over a ``ProcessMesh`` (``mesh=``, with ``rows`` the dataset ids of
    this rank's slab; ``store`` on the host) no rank reads another's
    rows: each sums its slab's rows and their products (sum x and X^T X
    in float64, on the host), one sum over the mesh's host channel
    (``host_sum``) gives the mean and the covariance, and the channel's
    first rank takes one float64 ``eigh`` of the D x D covariance and
    broadcasts mu, V and the eigenvalues (``_rank_stats``).  Only those
    go on the device, 4 D (r + 2) bytes, and every rank holds the same
    ones."""

    name = "wiener"

    def __init__(self, store: DatasetStore, schedule: Schedule,
                 rank: int | None = None, device=None, mesh=None,
                 rows=None):
        self.schedule = schedule
        if mesh is not None:
            self.store = store
            self.device = dev = resolve_device(device)
            mu, vt, lam = _rank_stats(store, mesh, rows, rank)
        else:
            self.store = store.to(resolve_device(device))
            self.device = dev = self.store.device
            x = self.store.X.cpu().numpy().astype(np.float64)
            mu = x.mean(0)
            xc = x - mu
            r = min(x.shape) if rank is None else min(rank, min(x.shape))
            _, s, vt = np.linalg.svd(xc, full_matrices=False)
            vt, lam = vt[:r], (s[:r] ** 2) / x.shape[0]
        self.mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
        self.V = torch.as_tensor(vt.T, dtype=torch.float32,
                                 device=dev)                   # [D, r]
        self.lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)

    def __call__(self, x_t: torch.Tensor, t: int,
                 support: torch.Tensor | None = None) -> torch.Tensor:
        # a support means nothing to a statistics-only estimator (the
        # paper leaves Wiener out of the orthogonality study)
        a = float(self.schedule.a[t])
        b = float(self.schedule.b[t])
        z = x_t - a * self.mu
        coeff = (a * self.lam) / (a * a * self.lam + b * b)   # [r]
        return self.mu + ((z @ self.V) * coeff) @ self.V.T


def _rank_stats(store: DatasetStore, mesh, rows, rank: int | None):
    """(mu [D], V^T [r, D], eigenvalues [r]) of the whole store from
    the ranks' slabs: each rank's float64 sums of its ``rows`` (x and
    x x^T), summed over the host channel; the first rank's ``eigh`` of
    the covariance, eigenvalues descending (the SVD form's order),
    broadcast."""
    from repro_torch.index.shard import host_rows
    n, d = store.n, store.dim
    rows = np.asarray(rows, np.int64)
    s1, s2 = np.zeros(d), np.zeros((d, d))
    for c in range(0, len(rows), 8192):         # float64 a chunk at a time
        x = host_rows(store.X, rows[c:c + 8192]).astype(np.float64)
        s1 += x.sum(0)
        s2 += x.T @ x
        del x
    sums = mesh.host_sum(np.concatenate([s1, s2.ravel()]))
    out = None
    if mesh.host_rank == 0:
        mu = sums[:d] / n
        cov = sums[d:].reshape(d, d) / n - np.outer(mu, mu)
        lam, v = np.linalg.eigh(cov)
        r = min(n, d) if rank is None else min(rank, n, d)
        order = np.argsort(lam)[::-1][:r]
        out = (mu, v[:, order].T, np.clip(lam[order], 0.0, None))
    return mesh.host_broadcast(out)


# ---------------------------------------------------------------------------
# Patch-based (Kamb & Ganguli) and PCA (Lukoianov et al.)
# ---------------------------------------------------------------------------

def _box_sum(d: torch.Tensor, patch: int) -> torch.Tensor:
    """Zero-padded ("SAME") sum over a patch x patch window of the last
    two axes of ``d`` [..., H, W]: a ones-kernel convolution in fp32."""
    if patch <= 1:
        return d
    h, w = d.shape[-2:]
    lo = (patch - 1) // 2
    x = F.pad(d.reshape(-1, 1, h, w), (lo, patch - 1 - lo, lo, patch - 1 - lo))
    ones = torch.ones((1, 1, patch, patch), dtype=d.dtype, device=d.device)
    with _fp32_convolutions():
        return F.conv2d(x, ones).reshape(d.shape)


def _box_patch_dist(qf: torch.Tensor, xf: torch.Tensor,
                    patch: int) -> torch.Tensor:
    """Per-pixel patch squared distance between query/data feature maps.

    qf: [B, H, W, C], xf: [Nc, H, W, C] -> [B, Nc, H, W]
    (sum over a patch x patch window of per-pixel squared diffs, SAME pad).
    """
    return _box_sum(((qf[:, None] - xf[None]) ** 2).sum(-1), patch)


class PatchDenoiser:
    """Kamb-style per-pixel patch posterior: each pixel has its own
    softmax over the training set, its logit comparing the patch around
    that pixel.  The patch size p_t is large at high noise and small
    near the data manifold."""

    name = "kamb"
    default_weighting: Weighting = "ss"

    def __init__(self, store: DatasetStore, schedule: Schedule,
                 patch_min: int = 3, patch_max: int = 11, chunk: int = 128,
                 weighting: Weighting | None = None, device=None):
        if len(store.image_shape) != 3:
            raise ValueError("patch denoisers need [H, W, C] data")
        self.store = store.to(resolve_device(device))
        self.device = self.store.device
        self.schedule = schedule
        self.patch_min = patch_min
        self.patch_max = patch_max
        self.chunk = chunk
        self.weighting = weighting or self.default_weighting
        self.h, self.w, self.c = store.image_shape
        self._mesh = None         # a ProcessMesh once ``on_ranks`` binds it

    def on_ranks(self, engine) -> None:
        """Run on ``engine``'s ``ProcessMesh`` rank (``GoldDiff`` binds a
        patch base so): the base takes the engine's device and host
        store, holds its slab's fp32 rows on the device (the engine's own
        slab where that is fp32) and the map from dataset id to slab row
        (``index.shard.slab_slots``), and gathers each query's support
        rows from the ranks (``index.shard.gather_support``, one
        collective a query group).  It never holds another rank's rows on
        the device; the full patch scan (no support) raises."""
        from repro_torch.index.shard import host_rows, slab_slots
        sl = engine._layout.slabs[0]
        self.store, self.device = engine.store, engine.device
        if sl.X.dtype == torch.float32:
            self._slab = sl.X
        else:                     # bf16 engine rows: the base reads fp32
            at, ids = engine.slab_rows()
            slab = np.zeros(tuple(sl.X.shape), np.float32)
            host_rows(self.store.X, ids, slab, at)
            self._slab = torch.from_numpy(slab).to(self.device)
        self._slots = slab_slots(sl, self.store.n)
        self._mesh = engine.mesh

    # -- hooks overridden by PCADenoiser ------------------------------------
    def features(self, imgs: torch.Tensor, patch: int) -> torch.Tensor:
        """Feature map whose per-pixel L2 distance defines the patch logit."""
        return imgs

    def _chunk_features(self, s: int, e: int, ximg: torch.Tensor,
                        patch: int) -> torch.Tensor:
        return self.features(ximg, patch)

    def _support_features(self, ids: torch.Tensor, ximg: torch.Tensor,
                          patch: int) -> torch.Tensor:
        """Features of the gathered support rows ``ximg`` [b, k, H, W, C]."""
        return ximg

    def _pixel_dist(self, qf: torch.Tensor, xf: torch.Tensor,
                    patch: int) -> torch.Tensor:
        """Per-pixel logit distance of broadcastable feature maps
        [..., H, W, F] -> [..., H, W]: the patch's box sum."""
        return _box_sum(((qf - xf) ** 2).sum(-1), patch)

    def feature_dist(self, qf: torch.Tensor, xf: torch.Tensor,
                     patch: int) -> torch.Tensor:
        """[B, H, W, F] x [Nc, H, W, F] -> [B, Nc, H, W]."""
        return self._pixel_dist(qf[:, None], xf[None], patch)

    def build_caches(self, timesteps) -> int:
        """Build whatever the steps at ``timesteps`` read from a cache
        before the first of them runs; returns the device bytes held.
        The Kamb base has no cache."""
        return 0

    # ------------------------------------------------------------------------
    def patch_size(self, t: int) -> int:
        g = self.schedule.g_np(t)
        p = int(round(self.patch_min + (self.patch_max - self.patch_min) * g))
        return p | 1  # odd

    def _imgs(self, flat: torch.Tensor) -> torch.Tensor:
        return flat.reshape(flat.shape[:-1] + (self.h, self.w, self.c))

    def __call__(self, x_t: torch.Tensor, t: int,
                 support: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
        a = float(self.schedule.a[t])
        sig2 = float(self.schedule.sigma_np(t)) ** 2
        patch = self.patch_size(t)
        q = self._imgs(x_t / a)                                 # [B,H,W,C]
        qf = self.features(q, patch)
        if support is not None:
            return self._on_support(q, qf, t, support, patch, sig2, mask)
        if self._mesh is not None:
            raise ValueError(f"the {self.name} base's full scan reads every "
                             f"row; over a ProcessMesh it runs on a "
                             f"support (GoldDiff) only")

        # full scan, chunked over the store with an online softmax per
        # pixel (the weighting does not enter: the reference's full scan
        # is the exact softmax for both)
        b, n = q.shape[0], self.store.n
        state = streaming.init_state((b, self.h * self.w), self.c,
                                     device=q.device)
        chunk = min(self.chunk, n)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            ximg = self._imgs(self.store.X[s:e])
            xf = self._chunk_features(s, e, ximg, patch)
            dist = self.feature_dist(qf, xf, patch)             # [B,nc,H,W]
            lg = (-dist / (2.0 * sig2)).reshape(b, e - s, -1).movedim(1, -1)
            vals = ximg.reshape(e - s, -1, self.c).movedim(0, 1)  # [HW,nc,C]
            state = streaming.update_state(state, lg, vals)
        return streaming.finalize(state).reshape(b, -1)

    def _query_group(self, k: int) -> int:
        """Queries whose [b, k, H, W, F] support gather fits
        ``SUPPORT_GATHER_BYTES`` (over ranks the rows and the features
        share one [b, k, H, W, C + F] buffer)."""
        width = (self.c + self.feature_dim if self._mesh is not None
                 else max(self.feature_dim, self.c))
        per_query = 4 * k * self.h * self.w * width
        return max(1, SUPPORT_GATHER_BYTES // per_query)

    def _slab_features(self, patch: int) -> torch.Tensor | None:
        """The slab's cached feature maps a rank gathers beside its rows
        (None: the features are the rows)."""
        return None

    def _support_rows(self, ids: torch.Tensor, patch: int):
        """The support's rows [b, k, H, W, C] and their features: from
        the whole store, or over a ``ProcessMesh`` from the ranks' slabs
        in one ``gather_support``."""
        if self._mesh is None:
            ximg = self._imgs(self.store.X[ids])
            return ximg, self._support_features(ids, ximg, patch)
        from repro_torch.index.shard import gather_support
        cache = self._slab_features(patch)
        vals = [self._imgs(self._slab)] + ([] if cache is None else [cache])
        got = gather_support(vals, ids, self._slots, self._mesh)
        return got[0], got[-1]

    @property
    def feature_dim(self) -> int:
        return self.c

    def _on_support(self, q, qf, t, idx, patch, sig2, mask):
        """The posterior over each query's own support rows, queries in
        groups (``_query_group``): the reference's ``vmap`` over queries
        as a batched gather."""
        bsz, k = idx.shape
        out = q.new_empty((bsz, self.h, self.w, self.c))
        step = self._query_group(k)
        for b0 in range(0, bsz, step):
            ids = idx[b0:b0 + step]
            nb = ids.shape[0]
            ximg, xf = self._support_rows(ids, patch)         # [b,k,H,W,C]
            lg = -self._pixel_dist(qf[b0:b0 + step, None], xf,
                                   patch) / (2.0 * sig2)        # [b,k,H,W]
            if mask is not None:
                lg = torch.where(mask[b0:b0 + step, :, None, None], lg,
                                 NEG_INF)
            if self.weighting == "wss":
                lgp = lg.reshape(nb, k, -1).movedim(1, -1)        # [b,HW,k]
                vals = ximg.reshape(nb, k, -1, self.c).movedim(1, 2)
                out[b0:b0 + step] = streaming.wss_combine(lgp, vals).reshape(
                    nb, self.h, self.w, self.c)
            else:
                w = torch.softmax(lg, dim=1)
                out[b0:b0 + step] = torch.einsum("bkhw,bkhwc->bhwc", w, ximg)
        return out.reshape(bsz, -1)


class PCADenoiser(PatchDenoiser):
    """Lukoianov et al.: patch features projected on a rank-r PCA basis.

    Patch extraction and projection are one convolution with the PCA
    filters, so the per-pixel distance runs in the r-dim subspace.  The
    default weighting is the *biased* WSS of the original method;
    GoldDiff swaps it for the unbiased SS on the golden support."""

    name = "pca"
    default_weighting: Weighting = "wss"

    def __init__(self, store: DatasetStore, schedule: Schedule,
                 rank: int = 8, num_fit_patches: int = 4096, seed: int = 0,
                 **kw):
        super().__init__(store, schedule, **kw)
        self.rank = rank
        self.num_fit_patches = num_fit_patches
        self.seed = seed
        self._bases: dict[int, torch.Tensor] = {}
        self._features: dict[int, torch.Tensor] = {}

    @property
    def feature_dim(self) -> int:
        return self.rank

    def feature_cache_bytes(self) -> int:
        """Device bytes held by the cached dataset feature maps."""
        return sum(f.numel() * f.element_size()
                   for f in self._features.values())

    def build_caches(self, timesteps) -> int:
        """The dataset feature maps of every patch size the steps at
        ``timesteps`` take (``_dataset_features``); the bytes held."""
        for t in timesteps:
            self._dataset_features(self.patch_size(int(t)))
        return self.feature_cache_bytes()

    def _dataset_features(self, patch: int) -> torch.Tensor:
        """PCA feature maps of the whole store for this patch size,
        [N, H, W, r] on the store's device, built once: features do not
        depend on the query, so the support path gathers them.  Over a
        ``ProcessMesh`` those of the rank's slab only, [n_loc, H, W, r]."""
        if patch not in self._features:
            imgs = self._imgs(self.store.X if self._mesh is None
                              else self._slab)
            n = imgs.shape[0]
            feats = imgs.new_empty((n, self.h, self.w, self._basis(patch)
                                    .shape[-1]))
            step = max(1, 4096 // max(self.h // 8, 1))
            for s in range(0, n, step):
                feats[s:s + step] = self.features(imgs[s:s + step], patch)
            self._features[patch] = feats
        return self._features[patch]

    def _basis(self, patch: int) -> torch.Tensor:
        """PCA filters [patch, patch, C, r] fit on random training patches:
        the reference's numpy draws and SVD, on patches gathered where
        the store lives (only they are copied to the host).  Over a
        ``ProcessMesh`` the host channel's first rank fits it from the
        host rows and broadcasts it, so every rank holds the same one."""
        if patch in self._bases:
            return self._bases[patch]
        if self._mesh is None:
            basis = self._fit_basis(patch)
        else:
            basis = self._mesh.host_broadcast(
                self._fit_basis(patch) if self._mesh.host_rank == 0
                else None)
        self._bases[patch] = torch.as_tensor(basis, dtype=torch.float32,
                                             device=self.device)
        return self._bases[patch]

    def fit_draws(self, patch: int) -> tuple:
        """The reference's draws for the basis of ``patch``: ``(rows,
        ys, xs)``, each patch's dataset row and top-left corner."""
        rng = np.random.default_rng(self.seed + patch)
        cnt = min(self.num_fit_patches, 16384)
        return (rng.integers(0, self.store.n, cnt),
                rng.integers(0, max(self.h - patch, 0) + 1, cnt),
                rng.integers(0, max(self.w - patch, 0) + 1, cnt))

    def _fit_basis(self, patch: int) -> np.ndarray:
        ii, hh, ww = self.fit_draws(patch)
        cnt = ii.size
        if self._mesh is None:
            dev, src = self.store.device, self.store.X
        else:                     # the drawn rows alone, read from the host
            from repro_torch.index.shard import host_rows
            uniq, ii = np.unique(ii, return_inverse=True)
            dev, src = torch.device("cpu"), torch.from_numpy(
                host_rows(self.store.X, uniq))
        ar = torch.arange(patch, device=dev)
        rows = torch.as_tensor(ii, device=dev)[:, None, None]
        ys = (torch.as_tensor(hh, device=dev)[:, None] + ar)[:, :, None]
        xs = (torch.as_tensor(ww, device=dev)[:, None] + ar)[:, None, :]
        patches = self._imgs(src)[rows, ys, xs].cpu().numpy()
        flat = patches.reshape(cnt, -1)
        flat = flat - flat.mean(0)
        r = min(self.rank, flat.shape[1])
        _, _, vt = np.linalg.svd(flat, full_matrices=False)
        return vt[:r].T.reshape(patch, patch, self.c, r)

    def features(self, imgs: torch.Tensor, patch: int) -> torch.Tensor:
        """[n, H, W, C] -> [n, H, W, r]: a SAME cross-correlation with the
        HWIO basis (as XLA's convolution, so the kernel is not flipped)."""
        w = self._basis(patch).permute(3, 2, 0, 1)           # [r, C, p, p]
        with _fp32_convolutions():
            y = F.conv2d(imgs.permute(0, 3, 1, 2), w, padding=patch // 2)
        return y.permute(0, 2, 3, 1)

    def _pixel_dist(self, qf, xf, patch):
        # the distance already lives in the projected patch space
        return ((qf - xf) ** 2).sum(-1)

    def _chunk_features(self, s, e, ximg, patch):
        return self._dataset_features(patch)[s:e]

    def _support_features(self, ids, ximg, patch):
        return self._dataset_features(patch)[ids]

    def _slab_features(self, patch):
        return self._dataset_features(patch)


DENOISERS = {
    "optimal": OptimalDenoiser,
    "wiener": WienerDenoiser,
    "kamb": PatchDenoiser,
    "pca": PCADenoiser,
}


def make_denoiser(name: str, store: DatasetStore, schedule: Schedule, **kw):
    return DENOISERS[name](store, schedule, **kw)
