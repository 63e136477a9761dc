"""Seeded weights in the layout the port's models take, made on the device.

The benchmark makes the weights itself and hands the same tensors to the
program and to the plain reference.  Every random leaf is a view into one
buffer filled by one `normal_` call from a generator seeded with the run's
seed, then scaled in place: a few large calls, in the type the model is
served in.
"""
from __future__ import annotations

import math

import torch

from fosbench.counts import dims


def padded_vocab(vocab: int) -> int:
    return (vocab + 255) // 256 * 256


def table(cfg: dict) -> dict:
    """path -> (shape, init) of every leaf; block leaves are stacked over
    the layers.  init: a float scale for a normal draw, or "ones",
    "a_log", "dt_bias", "tied" (the embedding's transpose)."""
    m = dims(cfg)
    d, n_l, vp = m["d"], m["layers"], padded_vocab(m["vocab"])

    def normal(shape):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return min(0.02, fan_in ** -0.5)

    t = {"embed/tok": ((vp, d), 0.02)}
    if m["family"] == "moe":
        hq, hkv, hd, e, f = m["hq"], m["hkv"], m["hd"], m["experts"], m["d_ff"]
        sub = {"ln1_w": (d,), "attn/wq": (d, hq * hd),
               "attn/wk": (d, hkv * hd), "attn/wv": (d, hkv * hd),
               "attn/wo": (hq * hd, d), "attn/q_norm": (hd,),
               "attn/k_norm": (hd,), "ln2_w": (d,),
               "moe/w_router": (d, e), "moe/w1": (e, d, f),
               "moe/w3": (e, d, f), "moe/w2": (e, f, d)}
        ones = {"ln1_w", "ln2_w", "attn/q_norm", "attn/k_norm"}
        special = {}
    else:
        di, h, bc, k = (m["d_inner"], m["heads"], 2 * m["groups"] * m["d_state"],
                        m["conv"])
        sub = {"ln1_w": (d,), "mamba/w_z": (d, di), "mamba/w_x": (d, di),
               "mamba/w_bc": (d, bc), "mamba/w_dt": (d, h),
               "mamba/dt_bias": (h,), "mamba/a_log": (h,),
               "mamba/d_skip": (h,), "mamba/w_conv_x": (k, di),
               "mamba/b_conv_x": (di,), "mamba/w_conv_bc": (k, bc),
               "mamba/b_conv_bc": (bc,), "mamba/norm_w": (di,),
               "mamba/w_out": (di, d)}
        ones = {"ln1_w", "mamba/d_skip", "mamba/norm_w"}
        special = {"mamba/a_log": "a_log", "mamba/dt_bias": "dt_bias",
                   "mamba/b_conv_x": 0.02, "mamba/b_conv_bc": 0.02}
    for k, shape in sub.items():
        init = ("ones" if k in ones else special.get(k, normal(shape)))
        t[f"blocks/sub0/{k}"] = ((n_l,) + shape, init)
    t["final/lnf_w"] = ((d,), "ones")
    # a tied unembedding is the embedding's transpose, held apart
    t["lm_head"] = ((d, vp), "tied" if cfg.get("tie_embeddings")
                    else normal((d, vp)))
    return t


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for s, _ in table(cfg).values())


def make(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The nested param dict of `cfg`, drawn from `seed` on `device`."""
    tab = table(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    randoms = [(k, s, i) for k, (s, i) in tab.items()
               if isinstance(i, float)]
    total = sum(math.prod(s) for _, s, _ in randoms)
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(generator=gen)
    flat, off = {}, 0
    for k, shape, scale in randoms:
        n = math.prod(shape)
        flat[k] = buf[off:off + n].view(shape).mul_(scale)
        off += n
    for k, (shape, init) in tab.items():
        if init == "ones":
            flat[k] = torch.ones(shape, dtype=dtype, device=device)
        elif init == "a_log":       # decay rates a = -1 .. -16 over heads
            v = torch.log(torch.linspace(1.0, 16.0, shape[-1]))
            flat[k] = v.expand(shape).to(device, dtype).contiguous()
        elif init == "dt_bias":     # softplus(dt_bias) = 1e-3 .. 1e-1
            dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1),
                                          shape[-1]))
            flat[k] = torch.log(torch.expm1(dt)).expand(shape).to(
                device, dtype).contiguous()
        elif init == "tied":
            flat[k] = flat["embed/tok"].T.contiguous()
    tree: dict = {}
    for path in tab:                # the table's order
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = flat[path]
    return tree
