"""In-memory dataset store consumed by the analytical denoisers.

Counterpart of ``repro.core.dataset``: the training set flattened to
``X: [N, D]``, the 4x average-pooled proxy ``proxy: [N, dp]`` used by
GoldDiff's coarse screen, and precomputed fp32 squared norms, all as
tensors on one device.  ``downsample_proxy`` lives in ``kernels.ref``
(it is the plain version of kernel 7's pooling stage) and is exported
here as before.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.ref import downsample_proxy
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class DatasetStore:
    X: torch.Tensor                    # [N, D] flattened training points
    proxy: torch.Tensor                # [N, dp] proxy-space embedding
    x_norms: torch.Tensor              # [N] ||x_i||^2
    proxy_norms: torch.Tensor          # [N] ||proxy_i||^2
    image_shape: tuple                 # e.g. (32, 32, 3) or (2,)
    labels: torch.Tensor | None = None  # [N] int class ids

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def dim(self) -> int:
        return self.X.shape[1]

    @property
    def device(self) -> torch.device:
        return self.X.device

    def to(self, device) -> "DatasetStore":
        device = torch.device(device)
        if device == self.device:
            return self
        return DatasetStore(
            X=self.X.to(device), proxy=self.proxy.to(device),
            x_norms=self.x_norms.to(device),
            proxy_norms=self.proxy_norms.to(device),
            image_shape=self.image_shape,
            labels=None if self.labels is None else self.labels.to(device))


def make_store(x, image_shape: tuple, labels=None, proxy_factor: int = 4,
               device=None) -> DatasetStore:
    """Build a DatasetStore from raw data of shape [N, *image_shape]."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    n = x.shape[0]
    proxy = downsample_proxy(x.reshape((n,) + tuple(image_shape)),
                             proxy_factor)
    flat = x.reshape(n, -1)
    return DatasetStore(
        X=flat, proxy=proxy,
        x_norms=(flat * flat).sum(-1),
        proxy_norms=(proxy * proxy).sum(-1),
        image_shape=tuple(image_shape),
        labels=None if labels is None
        else torch.as_tensor(np.asarray(labels)).to(device))


def store_from_numpy(X, proxy, x_norms, proxy_norms, image_shape: tuple,
                     labels=None, device=None) -> DatasetStore:
    """A store from arrays computed elsewhere (e.g. a ``repro`` store
    converted with ``np.asarray``), taken as they are: both packages
    then share the same fp32 norms."""
    device = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return DatasetStore(
        X=t(X, np.float32), proxy=t(proxy, np.float32),
        x_norms=t(x_norms, np.float32), proxy_norms=t(proxy_norms, np.float32),
        image_shape=tuple(image_shape),
        labels=None if labels is None else t(labels, np.int64))


def restrict(store: DatasetStore, idx) -> DatasetStore:
    """The sub-store at integer indices ``idx`` (e.g. one class), on the
    store's device."""
    idx = torch.as_tensor(idx, device=store.device)
    return DatasetStore(
        X=store.X[idx], proxy=store.proxy[idx], x_norms=store.x_norms[idx],
        proxy_norms=store.proxy_norms[idx], image_shape=store.image_shape,
        labels=None if store.labels is None else store.labels[idx])


def pairwise_sq_dists(q: torch.Tensor, x: torch.Tensor,
                      x_norms: torch.Tensor | None = None) -> torch.Tensor:
    """||q - x_i||^2 for q: [B, D], x: [N, D] -> [B, N] via the matmul form."""
    if x_norms is None:
        x_norms = (x * x).sum(-1)
    qn = (q * q).sum(-1, keepdim=True)
    return torch.clamp_min(qn + x_norms[None, :] - 2.0 * (q @ x.T), 0.0)
