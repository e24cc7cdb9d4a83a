"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) in plain PyTorch
(counterpart of ``repro.models.mamba2``).

Layout as the reference's: d_inner = expand x d_model, H = d_inner /
head_dim heads, state size N, one B/C group; the z, xBC and dt
projections are separate weights.  The chunked SSD splits the sequence
into chunks of L positions: inside a chunk an attention-like L x L block
(masked before its exponential, so the j > i entries are exactly 0 and
carry no gradient), across chunks a state [B, H, P, N] carried in order.
The reference has no Pallas kernel here, and the port none either.

Differences from the reference:

  * ``ssd_chunked`` computes every chunk's intra-chunk block, its state
    increment and its inter-chunk term batched over the chunks (the
    reference scans the chunks one at a time under ``jax.checkpoint``);
    only the state recurrence runs chunk by chunk, in the reference's
    order.  The batched intra-chunk tensors are [B, nc, H, L, L] fp32;
    training keeps them per repeat under ``torch.utils.checkpoint``
    (``models.transformer``), not per chunk;
  * ``dt`` multiplies x_j before the intra-chunk product, not the
    [B, nc, H, L, L] block (one such tensor fewer; fp32 rounding only);
  * ``mamba_apply`` with a ``cache`` writes the prefill handoff into it
    (the last W - 1 rows of the pre-conv xBC, the SSD's final state)
    from the same pass; the reference runs the projection, the conv and
    the SSD a second time for them;
  * ``mamba_decode_step`` writes the conv and SSM states into the given
    cache views in place and returns only the output.

Under a mesh the projections and the gated norm take DTensors, ``z`` is
constrained where the reference constrains it, and the conv and the SSD
run under ``local_map``: each rank holds its batch rows with every
channel (the conv is cheap and x, B and C are cut from its output) and
runs the scan on its own heads (the SSD is independent per head; B and
C are shared), so the causal masks, the cumsum and the chunk recurrence
never see a DTensor.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (axis_names, current_rules,
                                              is_dtensor, mesh_coordinate,
                                              shard, shard_map_compat)
from repro_torch.models import layers as L
from repro_torch.models.module import ParamSpec


@dataclasses.dataclass(frozen=True)
class MambaDims:
    d_model: int
    d_inner: int
    head_dim: int
    state: int
    conv_width: int = 4

    @property
    def heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.state       # x, B, C share the conv


def mamba_specs(dims: MambaDims, dtype: torch.dtype) -> dict:
    f32 = torch.float32
    return {
        "in_z": ParamSpec((dims.d_model, dims.d_inner),
                          ("embed", "mamba_inner"), dtype),
        "in_xbc": ParamSpec((dims.d_model, dims.conv_dim),
                            ("embed", "mamba_conv"), dtype),
        "in_dt": ParamSpec((dims.d_model, dims.heads),
                           ("embed", "mamba_heads"), dtype),
        "conv_w": ParamSpec((dims.conv_width, dims.conv_dim),
                            (None, "mamba_conv"), dtype, scale=0.5),
        "conv_b": ParamSpec((dims.conv_dim,), ("mamba_conv",), dtype,
                            "zeros"),
        "a_log": ParamSpec((dims.heads,), ("mamba_heads",), f32, "arange"),
        "dt_bias": ParamSpec((dims.heads,), ("mamba_heads",), f32, "zeros"),
        "d_skip": ParamSpec((dims.heads,), ("mamba_heads",), f32, "ones"),
        "norm_w": ParamSpec((dims.d_inner,), ("mamba_inner",), f32, "ones"),
        "out_proj": ParamSpec((dims.d_inner, dims.d_model),
                              ("mamba_inner", "embed"), dtype),
    }


def _in_proj(p: dict, x: torch.Tensor):
    return (L.dense(x, p["in_z"]), L.dense(x, p["in_xbc"]),
            L.dense(x, p["in_dt"]))


def _gated_norm(w: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """RMS norm of x * silu(z) (the gate before the norm), in fp32, cast
    back to x's dtype."""
    xf = (x * F.silu(z)).float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over the sequence, in xbc's dtype.  xbc:
    [B, S, C]; w: [W, C]; a left pad of W - 1 zeros, then silu(out + b)."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_in: torch.Tensor, c_in: torch.Tensor,
                d_skip: torch.Tensor, chunk: int = 128,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: [B, S, H, P]; dt: [B, S, H] fp32 (post-softplus); a: [H] fp32
    (negative); b_in / c_in: [B, S, N]; d_skip: [H] fp32; init_state:
    [B, H, P, N] or None (zeros).  Returns (y [B, S, H, P] in x's dtype,
    the final state [B, H, P, N] fp32).  dt, a, the within-chunk cumsum,
    the states and every product are fp32; x, B and C are raised to fp32
    and each chunk's y is cast to x's dtype, as the reference does.
    Raises ``ValueError`` when S is not a multiple of min(chunk, S)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a "
                         f"multiple of the chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    xf = x.reshape(bsz, nc, chunk, h, p).to(f32)                # [B,nc,L,H,P]
    dtc = dt.reshape(bsz, nc, chunk, h)                         # [B,nc,L,H]
    bc = b_in.reshape(bsz, nc, chunk, n).to(f32)                # [B,nc,L,N]
    cc = c_in.reshape(bsz, nc, chunk, n).to(f32)
    cum = torch.cumsum(dtc * a, 2)                              # <= 0
    xdt = xf * dtc[..., None]                                   # dt_j x_j

    # intra-chunk, heads ahead of positions ([B, nc, H, i, j]):
    # y_i = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    cum_h = cum.transpose(-1, -2)                               # [B,nc,H,L]
    seg = cum_h[..., :, None] - cum_h[..., None, :]
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    att = decay * (cc @ bc.transpose(-1, -2))[:, :, None]
    y = (att @ xdt.transpose(2, 3)).transpose(2, 3)             # [B,nc,L,H,P]
    del seg, decay, att

    # each chunk's state increment: sum_j exp(cum_L - cum_j) dt_j x_j b_j^T
    w_end = torch.exp(cum[:, :, -1:] - cum)                     # [B,nc,L,H]
    xw = (xdt * w_end[..., None]).reshape(bsz, nc, chunk, h * p)
    adds = (xw.transpose(-1, -2) @ bc).reshape(bsz, nc, h, p, n)
    chunk_decay = torch.exp(cum[:, :, -1])                      # [B,nc,H]
    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    starts = []
    for c in range(nc):            # the recurrence, in the reference's order
        starts.append(state)
        state = torch.addcmul(adds[:, c], state,
                              chunk_decay[:, c, :, None, None])
    starts = torch.stack(starts, 1).reshape(bsz, nc, h * p, n)

    # inter-chunk: y_i += exp(cum_i) c_i . state(chunk start)
    y_inter = (cc @ starts.transpose(-1, -2)).reshape(bsz, nc, chunk, h, p)
    y = y + y_inter * torch.exp(cum)[..., None]
    y = y.to(x.dtype).reshape(bsz, s, h, p)
    y = y + (d_skip[:, None] * x.to(f32)).to(x.dtype)
    return y, state


def _ssd_inputs(p: dict, xbc: torch.Tensor, dt: torch.Tensor,
                dims: MambaDims):
    """From the conv's output and the raw dt: (x heads [B, S, H, P], dt
    post-softplus fp32, a, b_in, c_in)."""
    di, n = dims.d_inner, dims.state
    xs, b_in, c_in = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = xs.reshape(*xs.shape[:-1], dims.heads, dims.head_dim)
    return xh, dt, a, b_in, c_in


def _sharded_axes(placements, dim: int, mesh) -> list[str]:
    from torch.distributed.tensor import Shard
    names = axis_names(mesh)
    return [names[i] for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == dim]


def _moved(placements, src: int, dst: int) -> tuple:
    """The placements with a shard of dimension ``src`` moved to ``dst``."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(dst) if isinstance(p, Shard) and p.dim == src else p
                 for p in placements)


def _mesh_conv_ssd(p: dict, xbc_raw, dt, dims: MambaDims, chunk: int):
    """The conv and the SSD of DTensors under ``local_map``: (y [B, S, H,
    P] with the heads on the mesh axes of "mamba_heads", the final state
    [B, H, P, N], the raw xBC [B, S, C] with every channel)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = current_rules().mesh
    xbc_raw = shard(xbc_raw, "batch", None, None)
    dt = shard(dt, "batch", None, "mamba_heads")
    bpl, hpl = tuple(xbc_raw.placements), tuple(dt.placements)
    rep = (Replicate(),) * len(bpl)
    head_axes = _sharded_axes(hpl, 2, mesh)
    vpl = tuple(Shard(0) if q == Shard(2) else Replicate()
                for q in hpl)                             # [H] params

    def body(xbc_l, dt_l, conv_w, conv_b, dt_bias, a_log, d_skip):
        xbc = _causal_conv(xbc_l, conv_w, conv_b)
        h_loc = dt_l.shape[-1]
        h0 = mesh_coordinate(mesh, head_axes) * h_loc
        di, n = dims.d_inner, dims.state
        xh = xbc[..., :di].reshape(*xbc.shape[:-1], dims.heads,
                                   dims.head_dim)[:, :, h0:h0 + h_loc]
        b_in, c_in = xbc[..., di:di + n], xbc[..., di + n:]
        dtv = F.softplus(dt_l.float() + dt_bias)
        y, state = ssd_chunked(xh, dtv, -torch.exp(a_log), b_in, c_in,
                               d_skip, chunk)
        return y, state
    fn = shard_map_compat(body, mesh, (bpl, hpl, rep, rep, vpl, vpl, vpl),
                          (hpl, _moved(hpl, 2, 1)))
    y, state = fn(xbc_raw, dt, p["conv_w"], p["conv_b"], p["dt_bias"],
                  p["a_log"], p["d_skip"])
    return y, state, xbc_raw


def mamba_apply(p: dict, x: torch.Tensor, dims: MambaDims, chunk: int = 128,
                cache: dict | None = None) -> torch.Tensor:
    """Full-sequence (train / prefill) mixer.  x: [B, S, d_model].  With
    ``cache`` ({conv: [B, W-1, C], ssm: [B, H, P, N]}, one repeat's
    views) it writes the prefill handoff there: the last W - 1 rows of
    the pre-conv xBC (zeros ahead of a shorter sequence) and the SSD's
    final state."""
    z, xbc_raw, dt = _in_proj(p, x)
    z = shard(z, "batch", "seq", "act_mlp")
    if is_dtensor(xbc_raw):
        y, state, xbc_raw = _mesh_conv_ssd(p, xbc_raw, dt, dims, chunk)
    else:
        xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
        xh, dt, a, b_in, c_in = _ssd_inputs(p, xbc, dt, dims)
        y, state = ssd_chunked(xh, dt, a, b_in, c_in, p["d_skip"], chunk)
    bsz, s = x.shape[:2]
    y = _gated_norm(p["norm_w"], y.reshape(bsz, s, dims.d_inner), z)
    if cache is not None:
        keep = min(s, dims.conv_width - 1)
        if keep < dims.conv_width - 1:
            cache["conv"].zero_()
        cache["conv"][:, dims.conv_width - 1 - keep:].copy_(
            xbc_raw[:, s - keep:])
        cache["ssm"].copy_(state)
    return L.dense(y, p["out_proj"])


def mamba_decode_step(p: dict, x: torch.Tensor, cache: dict,
                      dims: MambaDims) -> torch.Tensor:
    """One-token decode.  x: [B, d_model]; cache: {conv: [B, W-1, C],
    ssm: [B, H, P, N] fp32} (one repeat's views), advanced in place: the
    conv window shifts by one row (through a temporary: the shift is an
    overlapping copy) and the state takes one step.  Returns y [B,
    d_model]."""
    z, xbc, dt = _in_proj(p, x)
    if is_dtensor(xbc):
        y = _mesh_decode_state(p, xbc, dt, cache, dims)
        y = _gated_norm(p["norm_w"], y.reshape(x.shape[0], dims.d_inner), z)
        return L.dense(y, p["out_proj"])
    conv_in = torch.cat([cache["conv"], xbc[:, None, :]], 1)   # [B, W, C]
    xbc_c = F.silu(torch.einsum("bwc,wc->bc", conv_in, p["conv_w"])
                   + p["conv_b"])
    xh, dt, a, b_in, c_in = _ssd_inputs(p, xbc_c, dt, dims)
    b_in, c_in, xh = b_in.float(), c_in.float(), xh.float()
    decay = torch.exp(dt * a)                                  # [B, H]
    add = torch.einsum("bh,bn,bhp->bhpn", dt, b_in, xh)
    ssm = cache["ssm"].float() * decay[..., None, None] + add
    y = torch.einsum("bn,bhpn->bhp", c_in, ssm)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(x.shape[0], dims.d_inner).to(x.dtype)
    y = _gated_norm(p["norm_w"], y, z)
    cache["conv"].copy_(conv_in[:, 1:])
    cache["ssm"].copy_(ssm)
    return y @ p["out_proj"]


def _mesh_decode_state(p: dict, xbc, dt, cache: dict, dims: MambaDims):
    """The conv and state step of ``mamba_decode_step`` for DTensors under
    ``local_map``: every rank convolves every channel (from the gathered
    conv window), writes its own channels of the window and its own
    heads of the state in place, and returns y [B, H, P] on its heads."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = current_rules().mesh
    conv, ssm = cache["conv"], cache["ssm"]
    cpl, spl = tuple(conv.placements), tuple(ssm.placements)
    bpl = tuple(q if q == Shard(0) else Replicate()
                for q in cpl)                             # batch only
    rep = (Replicate(),) * len(cpl)
    head_axes = _sharded_axes(spl, 1, mesh)
    conv_axes = _sharded_axes(cpl, 2, mesh)
    hpl = spl                          # dt [B, H]: the state's B and H
    vpl = tuple(Shard(0) if q == Shard(1) else Replicate()
                for q in spl)                             # [H] params
    dt = dt.redistribute(mesh, hpl)

    def body(xbc_l, dt_l, window, conv_l, ssm_l, conv_w, conv_b, dt_bias,
             a_log, d_skip):
        conv_in = torch.cat([window, xbc_l[:, None, :]], 1)   # [B, W, C]
        c_loc = conv_l.shape[2]
        c0 = mesh_coordinate(mesh, conv_axes) * c_loc
        xbc_c = F.silu(torch.einsum("bwc,wc->bc", conv_in, conv_w) + conv_b)
        h_loc = dt_l.shape[-1]
        h0 = mesh_coordinate(mesh, head_axes) * h_loc
        di, n = dims.d_inner, dims.state
        xh = xbc_c[..., :di].reshape(-1, dims.heads, dims.head_dim)[
            :, h0:h0 + h_loc].float()
        b_in, c_in = xbc_c[..., di:di + n].float(), xbc_c[..., di + n:].float()
        dtv = F.softplus(dt_l.float() + dt_bias)
        decay = torch.exp(dtv * -torch.exp(a_log))
        add = torch.einsum("bh,bn,bhp->bhpn", dtv, b_in, xh)
        state = ssm_l.float() * decay[..., None, None] + add
        y = torch.einsum("bn,bhpn->bhp", c_in, state)
        y = y + d_skip[None, :, None] * xh
        conv_l.copy_(conv_in[:, 1:, c0:c0 + c_loc])
        ssm_l.copy_(state)
        return y.to(xbc_l.dtype)
    fn = shard_map_compat(body, mesh, (bpl, hpl, bpl, cpl, spl, rep, rep,
                                       vpl, vpl, vpl), spl)
    return fn(xbc, dt, conv, conv, ssm, p["conv_w"], p["conv_b"],
              p["dt_bias"], p["a_log"], p["d_skip"])


def mamba_cache_specs(dims: MambaDims, batch: int, dtype: torch.dtype
                      ) -> dict:
    """One Mamba layer's decode cache: ``{name: (shape, logical_axes,
    dtype)}``."""
    return {"conv": ((batch, dims.conv_width - 1, dims.conv_dim),
                     ("batch", None, "mamba_conv"), dtype),
            "ssm": ((batch, dims.heads, dims.head_dim, dims.state),
                    ("batch", "mamba_heads", None, None), torch.float32)}
