"""The hybrid configuration's sizes, FLOPs, weight table and port config:
nemotron-h (NVIDIA-Nemotron-3-Nano-30B-A3B), whose blocks are one mixer
each, Mamba2 (M), MoE (E) or attention (*), in the order of the published
`hybrid_override_pattern`.

The served layers are the pattern's first `num_hidden_layers`
characters; the port stacks them by the shortest period that repeats to
that length (three groups of `MEMEM*E` for 21 layers), and the weights
are its param tree: `blocks/sub{j}` stacked over the groups.  Arithmetic
on sizes, as `counts.py`, so it runs on any machine; the seeded weights
are made on the device as `weights.make` makes them.
"""
from __future__ import annotations

import math

import torch

from fosbench import counts
from fosbench.weights import padded_vocab

# what the port serves of the published config's choices: anything else
# is refused, not served differently
PUBLISHED = {"mlp_hidden_act": "relu2", "mamba_hidden_act": "silu",
             "n_group": 1, "topk_group": 1, "norm_topk_prob": True,
             "attention_bias": False, "use_conv_bias": True,
             "mamba_proj_bias": False, "tie_word_embeddings": False,
             "n_shared_experts": 1}


def served_pattern(cfg: dict) -> str:
    """The served blocks' kinds, one character a layer."""
    return cfg["hybrid_override_pattern"][:cfg["num_hidden_layers"]]


def period(pattern: str) -> str:
    """The shortest prefix of `pattern` that repeats to all of it."""
    n = len(pattern)
    for p in range(1, n + 1):
        if n % p == 0 and pattern[:p] * (n // p) == pattern:
            return pattern[:p]
    return pattern


def dims(cfg: dict) -> dict:
    """The sizes a count needs, from the configuration file's keys."""
    for k, v in PUBLISHED.items():
        if cfg[k] != v:
            raise ValueError(f"{cfg['name']}: {k}={cfg[k]!r}; the port "
                             f"serves {v!r}")
    pat = served_pattern(cfg)
    heads, hdim = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    return {"family": "hybrid", "layers": len(pat), "pattern": pat,
            "ssm_layers": pat.count("M"), "moe_layers": pat.count("E"),
            "attn_layers": pat.count("*"),
            "d": cfg["hidden_size"], "hq": cfg["num_attention_heads"],
            "hkv": cfg["num_key_value_heads"], "hd": cfg["head_dim"],
            "experts": cfg["n_routed_experts"],
            "top_k": cfg["num_experts_per_tok"],
            "d_ff": cfg["moe_intermediate_size"],
            "shared_d_ff": cfg["moe_shared_expert_intermediate_size"],
            "d_inner": heads * hdim, "heads": heads, "headdim": hdim,
            "d_state": cfg["ssm_state_size"], "groups": cfg["n_groups"],
            "conv": cfg["conv_kernel"], "chunk": cfg["chunk_size"],
            "vocab": cfg["vocab_size"]}


def block_flops(m: dict, b: int, s: int) -> dict:
    """Model FLOPs of a prefill of [b, s] by block kind: 2 x the
    multiplying parameters a token touches x tokens (MoE: the router, top
    k experts and the shared expert, each two matrices; Mamba2: the in-
    and out-projections and the conv; attention: the four projections),
    plus the SSD scan (`counts.ssd_flops`) and attention's score and value
    products over the causal prefix; "unembed" the last position a row."""
    d, tok = m["d"], b * s
    bc = 2 * m["groups"] * m["d_state"]
    ssm = (d * (2 * m["d_inner"] + bc + m["heads"]) + m["d_inner"] * d
           + m["conv"] * (m["d_inner"] + bc))
    moe = d * m["experts"] + 2 * d * (m["top_k"] * m["d_ff"]
                                      + m["shared_d_ff"])
    attn = d * (m["hq"] + 2 * m["hkv"]) * m["hd"] + m["hq"] * m["hd"] * d
    return {
        "M": m["ssm_layers"] * (2 * ssm * tok + counts.ssd_flops(b, s, m)),
        "E": m["moe_layers"] * 2 * moe * tok,
        "*": m["attn_layers"] * (2 * attn * tok + 4 * m["hq"] * m["hd"]
                                 * (s * (s + 1) // 2) * b),
        "unembed": 2 * d * m["vocab"] * b}


def prefill_flops(m: dict, b: int, s: int) -> int:
    return sum(block_flops(m, b, s).values())


def table(cfg: dict) -> dict:
    """path -> (shape, init) of every leaf, in the port's param tree; init
    as `weights.table`'s (a float: the scale of a normal draw)."""
    m = dims(cfg)
    d, vp = m["d"], padded_vocab(m["vocab"])
    per = period(m["pattern"])
    n_g = m["layers"] // len(per)

    def normal(shape):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return min(0.02, fan_in ** -0.5)

    di, h, bcd, k = (m["d_inner"], m["heads"], 2 * m["groups"] * m["d_state"],
                     m["conv"])
    kinds = {
        "M": {"ln1_w": (d,), "mamba/w_z": (d, di), "mamba/w_x": (d, di),
              "mamba/w_bc": (d, bcd), "mamba/w_dt": (d, h),
              "mamba/dt_bias": (h,), "mamba/a_log": (h,),
              "mamba/d_skip": (h,), "mamba/w_conv_x": (k, di),
              "mamba/b_conv_x": (di,), "mamba/w_conv_bc": (k, bcd),
              "mamba/b_conv_bc": (bcd,), "mamba/norm_w": (di,),
              "mamba/w_out": (di, d)},
        "E": {"ln2_w": (d,), "moe/w_router": (d, m["experts"]),
              "moe/router_bias": (m["experts"],),
              "moe/w1": (m["experts"], d, m["d_ff"]),
              "moe/w2": (m["experts"], m["d_ff"], d),
              "moe/shared_w1": (d, m["shared_d_ff"]),
              "moe/shared_w2": (m["shared_d_ff"], d)},
        "*": {"ln1_w": (d,), "attn/wq": (d, m["hq"] * m["hd"]),
              "attn/wk": (d, m["hkv"] * m["hd"]),
              "attn/wv": (d, m["hkv"] * m["hd"]),
              "attn/wo": (m["hq"] * m["hd"], d)}}
    ones = {"ln1_w", "ln2_w", "mamba/d_skip", "mamba/norm_w"}
    special = {"mamba/a_log": "a_log", "mamba/dt_bias": "dt_bias",
               "mamba/b_conv_x": 0.02, "mamba/b_conv_bc": 0.02,
               "moe/router_bias": 0.02}
    t = {"embed/tok": ((vp, d), 0.02)}
    for j, kind in enumerate(per):
        for key, shape in kinds[kind].items():
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
        elif init == "a_log":       # decay rates a = -1 .. -16 over heads
            v = torch.log(torch.linspace(1.0, 16.0, shape[-1]))
            flat[k] = v.expand(shape).to(device, dtype).contiguous()
        elif init == "dt_bias":     # softplus(dt_bias) = 1e-3 .. 1e-1
            dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1),
                                          shape[-1]))
            flat[k] = torch.log(torch.expm1(dt)).expand(shape).to(
                device, dtype).contiguous()
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
    `served` section says: its block pattern the served pattern's period,
    no rotary embedding, the published norm eps, router and experts."""
    from repro_torch.models import api
    served = cfg["served"]
    dt = getattr(torch, served["dtype"])
    m = dims(cfg)
    return api.ModelConfig(
        name=cfg["name"], family="hybrid", n_layers=m["layers"],
        d_model=m["d"], n_heads=m["hq"], n_kv_heads=m["hkv"],
        head_dim=m["hd"], d_ff=0, vocab=m["vocab"],
        layer_pattern=period(m["pattern"]), norm_eps=cfg["norm_eps"],
        use_rope=False,
        moe=api.MoEConfig(n_experts=m["experts"], top_k=m["top_k"],
                          d_ff=m["d_ff"],
                          capacity_factor=cfg["capacity_factor"],
                          impl=served["moe_impl"], router="sigmoid_bias",
                          routed_scale=cfg["routed_scaling_factor"],
                          expert_act="relu2", shared_d_ff=m["shared_d_ff"]),
        ssm=api.SSMConfig(d_state=m["d_state"], headdim=m["headdim"],
                          n_heads=m["heads"], n_groups=m["groups"],
                          conv_kernel=m["conv"], chunk=m["chunk"]),
        param_dtype=dt, compute_dtype=dt, kv_dtype=dt,
        attn_impl=served["attn_impl"], ssd_impl=served["ssd_impl"],
        attn_chunk=served.get("attn_chunk", 0))
