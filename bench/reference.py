"""The plain reference that decides ``correct``: GoldDiff DDIM sampling
over the Optimal base, written from the paper in plain PyTorch (fp32,
TF32 off), importing nothing of the program.

It works out again everything the program derives: each row's x_T from
its request seed (``row_seed`` is a frozen copy of the serving rule), the
proxy and the norms of the store, the schedule and its fp32 tables, the
per-step sizes m_t and k_t (Eqs. 4/6, in fp32 as the program's masked
steps compute them), and every step's selections:

* the candidate set C_t: the m_t rows nearest the query by proxy
  distance (the query and the rows average-pooled), ties to the lower
  row;
* the golden support S_t: the k_t rows of C_t nearest by exact
  distance;
* the posterior mean over S_t with the unbiased softmax of
  -||x_t / a_t - x_i||^2 / (2 sigma_t^2), clipped to +-clip, then the
  deterministic DDIM update.

``Reference.trajectory`` also returns each step's candidate and golden
row ids, from which the work counts take the distinct rows a request
reads.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from bench.store import blockwise, pool_proxy, sq_norms

NEG_INF = -1e30


def row_seed(seed: int, row: int) -> int:
    """The generator seed of row ``row`` of a request seeded ``seed``
    (frozen copy of the serving rule)."""
    return int(np.random.SeedSequence([seed, row]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def ddpm_linear(num_steps: int = 1000, beta_start: float = 1e-4,
                beta_end: float = 2e-2) -> tuple[np.ndarray, np.ndarray]:
    """The affine forward process x_t = a_t x_0 + b_t eps (float64)."""
    betas = np.linspace(beta_start, beta_end, num_steps)
    alpha_bar = np.cumprod(1.0 - betas)
    a = np.concatenate([[1.0], np.sqrt(alpha_bar)])
    b = np.concatenate([[1e-4], np.sqrt(1.0 - alpha_bar)])
    return a, b


SCHEDULES = {"ddpm_linear": ddpm_linear}


def sampling_timesteps(T: int, steps: int) -> list[int]:
    """Evenly spaced grid T ... 0, endpoints included."""
    ts = np.unique(np.linspace(0, T, steps + 1).round().astype(int))
    return [int(t) for t in ts[::-1]]


def sizes(n: int, fracs: dict) -> tuple[int, int, int, int]:
    """(m_min, m_max, k_min, k_max) of the fractions of N; the golden
    set always fits the candidate set."""
    m_min = max(1, int(n * fracs["m_min_frac"]))
    m_max = max(m_min, int(n * fracs["m_max_frac"]))
    k_min = max(1, int(n * fracs["k_min_frac"]))
    k_max = min(max(k_min, int(n * fracs["k_max_frac"])), m_min)
    return m_min, m_max, k_min, k_max


@dataclasses.dataclass(frozen=True)
class Step:
    t: int
    t_prev: int
    m: int
    k: int
    a: float          # fp32 values, as Python floats
    b: float
    a_prev: float
    b_prev: float
    sig2: float


def steps_of(cfg: dict) -> list[Step]:
    """Every DDIM step of a configuration: sizes by Eqs. 4/6 with the
    noise level g in fp32, log-linear in sigma_t = b_t / a_t over the
    grid t = 1..T."""
    a64, b64 = SCHEDULES[cfg["schedule"]](cfg["schedule_steps"])
    T = len(a64) - 1
    a = torch.tensor(a64, dtype=torch.float32)
    b = torch.tensor(b64, dtype=torch.float32)
    lsig = torch.log(b[1:] / a[1:])
    lo, hi = lsig.min(), lsig.max()
    m_min, m_max, k_min, k_max = sizes(cfg["n"], cfg["golddiff"])
    ts = sampling_timesteps(T, cfg["steps"])
    out = []
    for t, tp in zip(ts[:-1], ts[1:]):
        tc = min(max(t, 1), T)
        g = torch.clamp((torch.log(b[tc] / a[tc]) - lo) / (hi - lo), 0, 1)
        m = int(torch.floor(m_min + (m_max - m_min) * (1.0 - g)))
        k = int(torch.floor(k_min + (k_max - k_min) * g))
        sig = b[t] / a[t]
        out.append(Step(t, tp, max(1, min(m, cfg["n"])), max(1, min(k, m)),
                        float(a[t]), float(b[t]), float(a[tp]), float(b[tp]),
                        float(sig * sig)))
    return out


def x_T(cfg: dict, seeds: list[tuple[int, int]]) -> torch.Tensor:
    """[len(seeds), D] terminal noise on the CPU: row (seed, i) draws
    N(0, 1) from a CPU generator seeded ``row_seed(seed, i)``, scaled
    by b_T."""
    a64, b64 = SCHEDULES[cfg["schedule"]](cfg["schedule_steps"])
    b_T = float(b64[sampling_timesteps(len(a64) - 1, cfg["steps"])[0]])
    dim = int(np.prod(cfg["image_shape"]))
    gen = torch.Generator()
    rows = []
    for s, i in seeds:
        gen.manual_seed(row_seed(s, i))
        rows.append(torch.randn(dim, generator=gen))
    return b_T * torch.stack(rows)


@contextlib.contextmanager
def exact_fp32():
    """fp32 products without TF32, restored afterwards."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


class Reference:
    """The reference over a store's rows ``X`` [N, D] fp32."""

    def __init__(self, cfg: dict, X: torch.Tensor):
        self.cfg = cfg
        self.image_shape = tuple(cfg["image_shape"])
        self.X = X
        self.proxy = blockwise(lambda b: pool_proxy(b, self.image_shape,
                                                    cfg["proxy_factor"]), X)
        self.x_norms = sq_norms(self.X)
        self.proxy_norms = sq_norms(self.proxy)
        self.steps = steps_of(cfg)
        self.clip = cfg["clip"]

    def _dists(self, q: torch.Tensor, rows: torch.Tensor,
               norms: torch.Tensor) -> torch.Tensor:
        """||q_b - rows_i||^2 [B, N] in the matmul form."""
        qn = (q * q).sum(-1, keepdim=True)
        return torch.clamp_min(qn + norms[None] - 2.0 * (q @ rows.T), 0.0)

    def denoise(self, x: torch.Tensor, st: Step
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x0_hat unclipped [B, D], candidate ids [B, m], golden ids
        [B, k]) of one step."""
        q = x / st.a
        qp = pool_proxy(q, self.image_shape, self.cfg["proxy_factor"])
        d_proxy = self._dists(qp, self.proxy, self.proxy_norms)
        cand = torch.sort(d_proxy, dim=-1, stable=True)[1][:, :st.m]
        xc = self.X[cand]                                   # [B, m, D]
        qn = (q * q).sum(-1, keepdim=True)
        d2 = torch.clamp_min(qn + self.x_norms[cand]
                             - 2.0 * torch.bmm(xc, q[:, :, None])[..., 0],
                             0.0)
        d2s, pos = torch.sort(d2, dim=-1, stable=True)
        gold = torch.gather(cand, -1, pos[:, :st.k])
        lg = torch.clamp_min(-d2s[:, :st.k] / (2.0 * st.sig2), NEG_INF)
        w = torch.softmax(lg, dim=-1)
        xg = torch.gather(xc, 1, pos[:, :st.k, None].expand(-1, -1,
                                                           xc.shape[2]))
        out = torch.bmm(w[:, None, :], xg)[:, 0]
        return out, cand, gold

    def trajectory(self, x_init: torch.Tensor, keep_ids: bool = False):
        """Deterministic DDIM from ``x_init`` [B, D], on the store's
        device and in its rows' dtype: (images [B, D], [(cand, gold) per
        step] or None)."""
        x = x_init.to(self.X.device, self.X.dtype)
        ids = [] if keep_ids else None
        with exact_fp32():
            for st in self.steps:
                x0, cand, gold = self.denoise(x, st)
                x0 = torch.clamp(x0, -self.clip, self.clip)
                eps = (x - st.a * x0) / st.b
                x = st.a_prev * x0 + st.b_prev * eps
                if keep_ids:
                    ids.append((cand, gold))
        return x, ids

