"""Mamba2 (state-space duality) mixer block; mirrors `repro/models/mamba.py`.

Layout conventions:
  x   [B, L, H, P]   (H heads of dim P = headdim)
  B,C [B, L, G, N]   (G groups, N = d_state; G divides H)
  dt  [B, L, H]      per-head step sizes (softplus-activated)
  A   [H]            negative per-head decay rates

The input projection is stored as separate weights per segment (w_z, w_x,
w_bc, w_dt), as in the reference.  The chunked scan is
`repro_torch.kernels.ssd_scan` (Hopper kernel + plain torch version); the
single-token decode step is plain torch, as the reference's is plain jnp.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import layers
from repro_torch.sharding import partition


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 128
    ssd_impl: str = "xla"  # "xla": plain torch | "pallas": kernel
    heads: int = 0         # 0: expand * d_model / headdim
    norm_eps: float = 1e-6

    @property
    def d_inner(self) -> int:
        if self.heads:
            return self.heads * self.headdim
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.headdim == 0
        return self.d_inner // self.headdim

    @property
    def bc_dim(self) -> int:
        return 2 * self.n_groups * self.d_state


def _causal_conv(u, w, bias):
    """Depthwise causal conv over seq. u: [B,L,C]; w: [K, C]; bias [C].

    A sum of K shifted products in fp32, as the reference computes it; not
    a cuDNN convolution, whose fp32 path defaults to TF32."""
    k = w.shape[0]
    seqlen = u.shape[1]
    pad = F.pad(u.float(), (0, 0, k - 1, 0))
    wf = w.float()
    out = pad[:, 0:seqlen] * wf[0]
    for i in range(1, k):
        out = out + pad[:, i:i + seqlen] * wf[i]
    return F.silu(out + bias.float()).to(u.dtype)


def _conv_step(buf, u_new, w, bias):
    """Single-token depthwise conv. buf [B,K-1,C], u_new [B,1,C] -> [B,C]
    and the shifted buffer, in buf's (cache) dtype."""
    cache_dtype = buf.dtype
    full = torch.cat([buf.to(u_new.dtype), u_new], dim=1)      # [B, K, C]
    out = torch.einsum("bkc,kc->bc", full.float(), w.float())
    out = F.silu(out + bias.float())
    return out.to(u_new.dtype), full[:, 1:, :].to(cache_dtype)


def mamba_block(params, x, spec: MambaSpec, state=None, mesh=None, tp=(),
                sp=()):
    """Apply the mixer.

    Train / prefill (state=None, or L > 1): full-sequence chunked SSD.
      Returns (y, new_state) where new_state = (ssm_state, conv_x_tail,
      conv_bc_tail) so prefill can seed decode.
    Decode: state as above; x is [B,1,D]; returns (y, new_state).

    `tp`: the mesh axes of tensor parallelism over the heads.  The params
    are this rank's heads (w_z/w_x/w_dt and the per-channel and per-head
    params its share, w_out its rows) and the state its heads' (the ssm
    state, the x conv tail); B/C, shared by every head of a group, are
    computed whole on each rank and its groups taken (with one group, the
    group), their gradient summed over `tp` (Megatron's f after the
    replicated branch, so that x's gradient counts it once); the gated
    norm's mean square sums over `tp` (with more than one group it is a
    rank's own groups'), and so does the output projection.
    `sp` (the same axes as `tp`): sequence parallelism, x is this rank's
    rows of the sequence; the scan needs all of them, so they are
    all-gathered first (the same x on every rank, as without it) and the
    output projection's partial sums are reduce-scattered back to them.
    """
    if sp:
        x = partition.gather_whole(x, mesh, sp, 1)
    bsz, seqlen, _ = x.shape
    n_heads, n_groups, d_inner = spec.n_heads, spec.n_groups, spec.d_inner
    g0 = 0
    xs = x
    if tp:
        n = partition.axis_size(mesh, tp)
        n_heads, d_inner = n_heads // n, d_inner // n
        if n_groups > 1:
            n_groups //= n
            g0 = partition.axis_index(mesh, tp) * n_groups
        xs = partition.copy_to_group(x, mesh, tp)
    z = xs @ params["w_z"].to(x.dtype)
    xu = xs @ params["w_x"].to(x.dtype)
    bc = x @ params["w_bc"].to(x.dtype)
    dt = xs @ params["w_dt"].to(x.dtype)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())                    # [H]
    gn = spec.n_groups * spec.d_state

    def groups(bcc):
        if tp:
            bcc = partition.copy_to_group(bcc, mesh, tp)
        bi, ci = bcc[..., :gn], bcc[..., gn:]
        shape = bcc.shape[:-1] + (spec.n_groups, spec.d_state)
        return (bi.reshape(shape)[..., g0:g0 + n_groups, :],
                ci.reshape(shape)[..., g0:g0 + n_groups, :])

    if seqlen > 1 or state is None:
        # full-sequence chunked scan (training, or prefill into a cache);
        # an existing ssm state (all-zeros at prefill start) seeds the scan.
        initial_state = state[0] if state is not None else None
        xc = _causal_conv(xu, params["w_conv_x"], params["b_conv_x"])
        bi, ci = groups(_causal_conv(bc, params["w_conv_bc"],
                                     params["b_conv_bc"]))
        xi = xc.reshape(bsz, seqlen, n_heads, spec.headdim)
        y, ssm_state = ssd_ops.ssd(
            xi, dt, a, bi, ci, chunk=spec.chunk, impl=spec.ssd_impl,
            initial_state=initial_state)
        y = y + xi.float() * params["d_skip"].float()[None, None, :, None]
        k1 = spec.conv_kernel - 1

        def tail(u):
            t = u[:, -k1:, :]
            if seqlen < k1:
                t = F.pad(t, (0, 0, k1 - seqlen, 0))
            return t
        new_state = (ssm_state, tail(xu), tail(bc))
    else:
        ssm_state, buf_x, buf_bc = state
        xc, buf_x = _conv_step(buf_x, xu, params["w_conv_x"],
                               params["b_conv_x"])
        bcc, buf_bc = _conv_step(buf_bc, bc, params["w_conv_bc"],
                                 params["b_conv_bc"])
        bi, ci = groups(bcc)
        xi = xc.reshape(bsz, n_heads, spec.headdim)
        dt1 = dt[:, 0]                                          # [B, H]
        decay = torch.exp(dt1 * a[None, :])                     # [B, H]
        rep = n_heads // n_groups
        b_h = bi.repeat_interleave(rep, dim=1).float()          # [B, H, N]
        c_h = ci.repeat_interleave(rep, dim=1).float()
        xf = xi.float()
        ssm_state = (ssm_state * decay[..., None, None]
                     + dt1[..., None, None] * xf[..., :, None]
                     * b_h[..., None, :])                       # [B,H,P,N]
        y = torch.einsum("bhpn,bhn->bhp", ssm_state, c_h)
        y = y + xf * params["d_skip"].float()[None, :, None]
        y = y[:, None]                                          # [B,1,H,P]
        new_state = (ssm_state, buf_x, buf_bc)

    y = y.reshape(bsz, seqlen, d_inner)
    # gated RMSNorm (mamba2 style): norm(y * silu(z)), over each group's
    # d_inner / n_groups channels (one group: over all of them)
    y = y * F.silu(z.float())
    if spec.n_groups > 1:   # under `tp` this rank's whole groups
        y = _rms_norm_grouped(y.to(x.dtype), params["norm_w"], n_groups,
                              spec.norm_eps)
    elif tp:
        y = _rms_norm_split(y.to(x.dtype), params["norm_w"], spec.d_inner,
                            mesh, tp, spec.norm_eps)
    else:
        y = layers.rms_norm(y.to(x.dtype), params["norm_w"], spec.norm_eps)
    out = y @ params["w_out"].to(x.dtype)
    out = partition.tp_leave(out, mesh, tp, sp)
    out = partition.constrain(out, ("batch", "seq", "embed_act"))
    return out, new_state


def _rms_norm_grouped(y, weight, n_groups: int, eps: float):
    """`layers.rms_norm` of each of `n_groups` equal runs of y's channels
    (nemotron-h's group_size = d_inner / n_groups)."""
    shape = y.shape
    w = weight.reshape(n_groups, -1)
    return layers.rms_norm(y.reshape(*shape[:-1], n_groups, -1), w,
                           eps).reshape(shape)


def _rms_norm_split(y, weight, width: int, mesh, tp, eps: float = 1e-6):
    """`layers.rms_norm` over a last dim of `width` channels split over
    the ranks of `tp` (this rank's y and weight its channels): the mean
    square sums over `tp`, and so does its gradient (each rank scales its
    own channels by it)."""
    dtype = y.dtype
    y = y.float()
    var = partition.sum_over_group(
        y.square().sum(dim=-1, keepdim=True), mesh, tp) / width
    return (y * torch.rsqrt(var + eps) * weight.float()).to(dtype)
