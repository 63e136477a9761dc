"""The afmoe configuration's sizes, FLOPs, weight table and port config:
Trinity-Mini, whose layers are each an attention and an FFN: sliding-window
attention (with RoPE) or full attention (without), in the published
`layer_types`, before a dense SwiGLU (the first `num_dense_layers`) or a
sigmoid-routed SwiGLU MoE with a shared expert.

The served layers are the first `num_hidden_layers`, one character each
in the port's `layer_pattern` (d: window + dense, e: window + MoE, F: full
+ MoE); the port stacks them by the shortest period that repeats to that
length (`hybrid.period`: one group of all 16 for the served cut, whose
two dense layers repeat nowhere), and the weights are its param tree:
`blocks/sub{j}` stacked over the groups.  Arithmetic on sizes, as
`counts.py`, so it runs on any machine; the seeded weights are made on
the device as `weights.make` makes them.
"""
from __future__ import annotations

import math

import torch

from fosbench import counts
from fosbench.hybrid import period
from fosbench.weights import padded_vocab

# what the port serves of the published config's choices: anything else
# is refused, not served differently
PUBLISHED = {"hidden_act": "silu", "score_func": "sigmoid",
             "route_norm": True, "n_group": 1, "topk_group": 1,
             "num_expert_groups": 1, "num_limited_groups": 1,
             "num_shared_experts": 1, "tie_word_embeddings": False,
             "mup_enabled": True, "rope_scaling": None}


def served_pattern(cfg: dict) -> str:
    """The served layers' kinds, one character a layer."""
    out = []
    for i, kind in enumerate(cfg["layer_types"][:cfg["num_hidden_layers"]]):
        dense = i < cfg["num_dense_layers"]
        if kind == "sliding_attention":
            out.append("d" if dense else "e")
        elif kind == "full_attention" and not dense:
            out.append("F")
        else:
            raise ValueError(f"{cfg['name']}: layer {i} {kind!r} "
                             f"{'dense' if dense else 'MoE'}: no port kind")
    return "".join(out)


def dims(cfg: dict) -> dict:
    """The sizes a count needs, from the configuration file's keys."""
    for k, v in PUBLISHED.items():
        if cfg[k] != v:
            raise ValueError(f"{cfg['name']}: {k}={cfg[k]!r}; the port "
                             f"serves {v!r}")
    pat = served_pattern(cfg)
    return {"family": "afmoe", "layers": len(pat), "pattern": pat,
            "window_layers": pat.count("d") + pat.count("e"),
            "full_layers": pat.count("F"), "dense_layers": pat.count("d"),
            "moe_layers": pat.count("e") + pat.count("F"),
            "window": cfg["sliding_window"],
            "d": cfg["hidden_size"], "hq": cfg["num_attention_heads"],
            "hkv": cfg["num_key_value_heads"], "hd": cfg["head_dim"],
            "dense_d_ff": cfg["intermediate_size"],
            "experts": cfg["num_experts"],
            "top_k": cfg["num_experts_per_tok"],
            "d_ff": cfg["moe_intermediate_size"],
            "shared_d_ff": (cfg["moe_intermediate_size"]
                            * cfg["num_shared_experts"]),
            "vocab": cfg["vocab_size"]}


def window_keys(s: int, w: int) -> int:
    """Keys summed over the queries of one row of s positions in a window
    of w: sum over i of min(i + 1, w)."""
    if s <= w:
        return s * (s + 1) // 2
    return w * (w + 1) // 2 + (s - w) * w


def part_flops(m: dict, b: int, s: int) -> dict:
    """Model FLOPs of a prefill of [b, s] by part: 2 x the multiplying
    parameters a token touches x tokens (attention: q, k, v, the gate and
    the output projection; the dense SwiGLU; MoE: the router, the top k
    experts and the shared expert, three matrices each), and attention's
    score and value products over the causal prefix (full layers) or the
    window (window layers); "unembed" the last position a row."""
    d, tok, hq, hd = m["d"], b * s, m["hq"], m["hd"]
    proj = d * (2 * hq + 2 * m["hkv"]) * hd + hq * hd * d
    return {
        "projections": m["layers"] * 2 * proj * tok,
        "attn_full": m["full_layers"] * 4 * hq * hd * (s * (s + 1) // 2) * b,
        "attn_window": (m["window_layers"] * 4 * hq * hd
                        * window_keys(s, m["window"]) * b),
        "dense": m["dense_layers"] * 2 * 3 * d * m["dense_d_ff"] * tok,
        "routed": m["moe_layers"] * 2 * 3 * d * m["d_ff"] * m["top_k"] * tok,
        "shared": m["moe_layers"] * 2 * 3 * d * m["shared_d_ff"] * tok,
        "router": m["moe_layers"] * 2 * d * m["experts"] * tok,
        "unembed": 2 * d * m["vocab"] * b}


def prefill_flops(m: dict, b: int, s: int) -> int:
    return sum(part_flops(m, b, s).values())


def flash_window_work(b: int, s: int, w: int, hq: int, hkv: int, hd: int,
                      elem: int = 4) -> tuple[int, int]:
    """(bytes, flops) of one windowed flash-attention call: q, k, v and the
    output read or written once, the score and value products over each
    query's min(i + 1, w) keys."""
    nbytes = elem * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    return nbytes, 4 * b * hq * hd * window_keys(s, w)


def table(cfg: dict) -> dict:
    """path -> (shape, init) of every leaf, in the port's param tree; init
    as `weights.table`'s (a float: the scale of a normal draw)."""
    m = dims(cfg)
    d, vp, hq, hkv, hd = (m["d"], padded_vocab(m["vocab"]), m["hq"],
                          m["hkv"], m["hd"])
    e, f, sf, df = m["experts"], m["d_ff"], m["shared_d_ff"], m["dense_d_ff"]
    per = period(m["pattern"])
    n_g = m["layers"] // len(per)

    def normal(shape):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return min(0.02, fan_in ** -0.5)

    attn = {"ln1_w": (d,), "attn/wq": (d, hq * hd), "attn/wk": (d, hkv * hd),
            "attn/wv": (d, hkv * hd), "attn/wo": (hq * hd, d),
            "attn/q_norm": (hd,), "attn/k_norm": (hd,),
            "attn/w_gate": (d, hq * hd), "ln1_post_w": (d,), "ln2_w": (d,)}
    ffn = {"dense": {"mlp/w_gate": (d, df), "mlp/w_up": (d, df),
                     "mlp/w_down": (df, d)},
           "moe": {"moe/w_router": (d, e), "moe/w1": (e, d, f),
                   "moe/w3": (e, d, f), "moe/w2": (e, f, d),
                   "moe/router_bias": (e,), "moe/shared_w1": (d, sf),
                   "moe/shared_w3": (d, sf), "moe/shared_w2": (sf, d)}}
    ones = {"ln1_w", "ln2_w", "ln1_post_w", "ln2_post_w", "attn/q_norm",
            "attn/k_norm"}
    special = {"moe/router_bias": 0.02}
    t = {"embed/tok": ((vp, d), 0.02)}
    for j, kind in enumerate(per):
        leaves = {**attn, **ffn["dense" if kind == "d" else "moe"],
                  "ln2_post_w": (d,)}
        for key, shape in leaves.items():
            init = "ones" if key in ones else special.get(key, normal(shape))
            t[f"blocks/sub{j}/{key}"] = ((n_g,) + shape, init)
    t["final/lnf_w"] = ((d,), "ones")
    t["lm_head"] = ((d, vp), normal((d, vp)))
    return t


def make(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The nested param dict of `cfg`, drawn from `seed` on `device`: every
    random leaf a view into one buffer filled by one `normal_` call, then
    scaled in place (`weights.make`'s scheme over this table)."""
    tab = table(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    randoms = [(k, s, i) for k, (s, i) in tab.items()
               if isinstance(i, float)]
    buf = torch.empty(sum(math.prod(s) for _, s, _ in randoms),
                      dtype=dtype, device=device)
    buf.normal_(generator=gen)
    flat, off = {}, 0
    for k, shape, scale in randoms:
        n = math.prod(shape)
        flat[k] = buf[off:off + n].view(shape).mul_(scale)
        off += n
    for k, (shape, init) in tab.items():
        if init == "ones":
            flat[k] = torch.ones(shape, dtype=dtype, device=device)
    tree: dict = {}
    for path in tab:                # the table's order
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = flat[path]
    return tree


def port_config(cfg: dict):
    """The port's ModelConfig of the configuration file, served as its
    `served` section says: its layer pattern the served pattern's period,
    the published window, norm eps, router and experts; RoPE on the
    window layers only, the gated output, the sandwich norms and the muP
    embedding scale."""
    from repro_torch.models import api
    served = cfg["served"]
    dt = getattr(torch, served["dtype"])
    m = dims(cfg)
    return api.ModelConfig(
        name=cfg["name"], family="moe", n_layers=m["layers"],
        d_model=m["d"], n_heads=m["hq"], n_kv_heads=m["hkv"],
        head_dim=m["hd"], d_ff=m["dense_d_ff"], vocab=m["vocab"],
        qk_norm=True, rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"], layer_pattern=period(m["pattern"]),
        sliding_window=m["window"], nope_full=True, attn_gate=True,
        post_norms=True, mup_embed=cfg["mup_enabled"],
        moe=api.MoEConfig(n_experts=m["experts"], top_k=m["top_k"],
                          d_ff=m["d_ff"],
                          capacity_factor=cfg["capacity_factor"],
                          impl=served["moe_impl"], router="sigmoid_bias",
                          routed_scale=cfg["route_scale"],
                          expert_act="swiglu", shared_d_ff=m["shared_d_ff"]),
        param_dtype=dt, compute_dtype=dt, kv_dtype=dt,
        attn_impl=served["attn_impl"],
        attn_chunk=served.get("attn_chunk", 0))
