"""Plain-torch oracles for causal GQA attention and decode attention
([B, S, H, hd] layout); counterparts of `repro/kernels/flash_attention/ref.py`.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True,
                  scale: float | None = None, window: int = 0):
    """q: [B,Sq,Hq,hd]; k,v: [B,Sk,Hkv,hd] -> [B,Sq,Hq,hd] (q.dtype).
    Causal: query i sees keys j <= i, and with `window` W > 0 only those
    with j > i - W."""
    sq, hq, hd = q.shape[1:]
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = hd ** -0.5 if scale is None else scale
    kr = k.repeat_interleave(g, dim=2).float()
    vr = v.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
    if causal:
        kpos = torch.arange(sk, device=q.device)[None, :]
        qpos = torch.arange(sq, device=q.device)[:, None]
        mask = kpos <= qpos
        if window:
            mask = mask & (kpos > qpos - window)
        s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)


def decode_attention_ref(q, k, v, length, *, scale: float):
    """q: [B,Hq,hd]; k,v: [B,S,Hkv,hd]; length: #valid -> [B,Hq,hd]."""
    hq = q.shape[1]
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kr = k.repeat_interleave(g, dim=2).float()
    vr = v.repeat_interleave(g, dim=2).float()
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kr) * scale
    valid = torch.arange(sk, device=q.device)[None, None, :] < length
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, vr).to(q.dtype)
