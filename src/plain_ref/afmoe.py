"""Plain PyTorch reference of Trinity-Mini (afmoe), written from the
published config.json and modeling code; it imports nothing but torch.

The forward of a whole teacher-forced sequence, prompt and served tokens,
with no cache, no kernel and no batching trick, in float32 with TF32 off
(set at import).  The embeddings are E[tok] * sqrt(hidden_size)
(`mup_enabled`); then `num_hidden_layers` layers, the first
`num_dense_layers` with a dense FFN and the rest MoE, each

    h <- h + RMSNorm_post_attn(Attn(RMSNorm_in(h)))
    h <- h + RMSNorm_post_mlp(FFN(RMSNorm_pre_mlp(h)))

(four norms a layer, each its own weight); then a final RMSNorm and the
untied unembedding.  RMSNorm eps `rms_norm_eps` everywhere.

- Attention, u = RMSNorm_in(h): q, k, v from u, q and k RMS-normalised
  per head over head_dim (their own weights); a `sliding_attention`
  layer (`layer_types`) rotates q and k by RoPE (theta `rope_theta`, the
  half rotation over all of head_dim) and a query at i sees the keys
  i - sliding_window < j <= i; a `full_attention` layer has no positional
  embedding and sees j <= i.  Grouped-query heads, scale head_dim^-1/2;
  the output is W_o (o * sigmoid(u W_gate)), over the concatenated heads.
  The scores are computed a block of queries at a time over the keys the
  block sees, so that a 16K-token row fits beside the weights.
- FFN: dense SwiGLU W_down (silu(u W_gate) * u W_up); MoE: scores
  sigmoid(u W_r) in fp32 over `num_experts`, the top `num_experts_per_tok`
  of scores + expert_bias chosen (one group: no group masking), weighted
  by their unbiased scores over their sum + 1e-20 (`route_norm`) times
  `route_scale`; each expert SwiGLU; plus the shared SwiGLU expert of
  `moe_intermediate_size * num_shared_experts` over every token.

Departures from the published model:
- float32 where the checkpoint is bfloat16;
- each expert holds at most `capacity_factor` of an even share of a call's
  pairs, max(8, ceil8(int(T k c / E))), the pairs past it dropped in
  token-major (token, k) order, as the served layer does (the published
  model is dropless).  A call is the prompt of every row, then each later
  position's B tokens, so the positions are grouped so.

Weights are the port's param tree: `embed/tok` [V, d], `lm_head` [d, V],
`final/lnf_w`, and `blocks/sub{j}` stacked over groups, layer i at sub
i % P of group i // P for P subs: `ln1_w`, `attn` (`wq`, `wk`, `wv`,
`wo`, `q_norm`, `k_norm`, `w_gate` [d, heads * head_dim]), `ln1_post_w`,
`ln2_w`, `mlp` (`w_gate`, `w_up`, `w_down`) or `moe` (`w_router` [d, E],
`router_bias` [E], `w1`, `w3` [E, d, F], `w2` [E, F, d], `shared_w1`,
`shared_w3`, `shared_w2`), `ln2_post_w`.

`Prec("tf32")` is the control of a float32 model: every product's
operands rounded to TF32's 10-bit mantissa (round to nearest), the
accumulation in float32, as TF32 tensor cores compute; it is emulated, so
it runs on the CPU too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# queries a block of the attention's scores
Q_BLOCK = 1024
# an expert choice whose margin (the k-th biased score over the next) is
# under TIE of the token's biased-score spread is one rounding may decide
TIE = 5e-4


class Prec:
    def __init__(self, kind: str = "fp32"):
        assert kind in ("fp32", "tf32")
        self.kind = kind

    def r(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return t
        i = t.contiguous().view(torch.int32)
        i = (i + 0x1000) & ~0x1FFF          # keep 10 of 23 mantissa bits
        return i.view(torch.float32)

    def mm(self, a, b):
        return self.r(a) @ self.r(b)

    def einsum(self, eq, *ts):
        return torch.einsum(eq, *(self.r(t) for t in ts))


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, theta: float):
    """x [L, H, hd] rotated by its positions 0 .. L - 1: the halves
    (x1, x2) to (x1 cos - x2 sin, x2 cos + x1 sin)."""
    n, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, u, cfg, sliding: bool, pr: Prec):
    """The attention of each row of u [B, L, d] (already normed)."""
    hq, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    eps, w = cfg["rms_norm_eps"], cfg["sliding_window"]
    g = hq // hkv
    b_n, n, _ = u.shape
    out = torch.empty(b_n, n, hq * hd, device=u.device)
    for b in range(b_n):
        q = _rms(pr.mm(u[b], p["wq"]).view(n, hq, hd), p["q_norm"], eps)
        k = _rms(pr.mm(u[b], p["wk"]).view(n, hkv, hd), p["k_norm"], eps)
        v = pr.mm(u[b], p["wv"]).view(n, hkv, hd)
        if sliding:
            q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
        for i0 in range(0, n, Q_BLOCK):
            i1 = min(n, i0 + Q_BLOCK)
            j0 = max(0, i0 - w + 1) if sliding else 0
            qi = torch.arange(i0, i1, device=u.device)[:, None]
            kj = torch.arange(j0, i1, device=u.device)[None, :]
            seen = kj <= qi
            if sliding:
                seen = seen & (kj > qi - w)
            for j in range(hkv):
                qj = q[i0:i1, j * g:(j + 1) * g].transpose(0, 1)
                s = pr.einsum("gqd,kd->gqk", qj, k[j0:i1, j]) * hd ** -0.5
                s = torch.where(seen, s, -torch.inf).softmax(-1)
                o = pr.einsum("gqk,kd->qgd", s, v[j0:i1, j])
                out[b, i0:i1, j * g * hd:(j + 1) * g * hd] = o.reshape(
                    i1 - i0, g * hd)
    gate = torch.sigmoid(pr.mm(u, p["w_gate"]))
    return pr.mm(out * gate, p["wo"])


def _swiglu(x, w_gate, w_up, w_down, pr: Prec):
    return pr.mm(F.silu(pr.mm(x, w_gate)) * pr.mm(x, w_up), w_down)


def _capacity(n_tokens: int, cfg: dict, cf: float) -> int:
    c = int(n_tokens * cfg["num_experts_per_tok"] * cf / cfg["num_experts"])
    return max(8, (c + 7) // 8 * 8)


def _moe(p, u, cfg, prompt_len: int, cf: float, pr: Prec, pin=None,
         own: list | None = None, count: dict | None = None):
    """The MoE FFN over u [B, L, d]; the prompt positions of all rows are
    one call of the layer, each later position's B tokens another.
    Returns the output and the [B, L] mask of near-tie choices.

    `pin` [B * prompt_len, k]: another run's choices in the prompt's call,
    taken for each prompt token whose own choice differs from it and sits
    within TIE of a tie; `count` adds up those tokens ("pinned") and the
    tokens whose choice differs further from a tie ("route_diff"), which
    keep their own.  `own` gets this call's own prompt choices (uint8)."""
    b_n, n, d = u.shape
    e_n, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    order = [u[:, :prompt_len].reshape(-1, d)] + [u[:, i] for i in
                                                   range(prompt_len, n)]
    sizes = [b_n * prompt_len] + [b_n] * (n - prompt_len)
    xt = torch.cat(order)                                      # [T, d]
    scores = torch.sigmoid(pr.mm(xt, p["w_router"]))
    choice = scores + p["router_bias"]
    srt, top_i = torch.sort(choice, dim=-1, descending=True, stable=True)
    tie = (srt[:, k - 1] - srt[:, k]) < TIE * choice.std(-1)
    top_i = top_i[:, :k]
    n0 = sizes[0]
    if own is not None:
        own.append(top_i[:n0].to(torch.uint8))
    if pin is not None:
        other = pin.long()
        differ = ~(top_i[:n0, :, None] == other[:, None, :]).any(-1).all(-1)
        take = differ & tie[:n0]
        top_i = torch.cat([torch.where(take[:, None], other, top_i[:n0]),
                           top_i[n0:]])
        count["pinned"] += int(take.sum())
        count["route_diff"] += int((differ & ~take).sum())
    top_p = scores.gather(1, top_i)
    top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-20)
    top_p = top_p * cfg["route_scale"]
    # each pair's place in its expert's queue within its call
    onehot = F.one_hot(top_i.reshape(-1), e_n).to(torch.int32)  # [T*k, E]
    upto = onehot.cumsum(0)
    call = torch.repeat_interleave(
        torch.arange(len(sizes), device=u.device),
        torch.tensor(sizes, device=u.device) * k)
    starts = torch.tensor([0] + sizes[:-1], device=u.device).cumsum(0) * k
    before = torch.where(starts[:, None] > 0,
                         upto[(starts - 1).clamp(min=0)], 0)   # [calls, E]
    place = ((upto - before[call]) * onehot).sum(-1) - 1       # [T*k]
    del onehot, upto
    caps = torch.tensor([_capacity(s, cfg, cf) for s in sizes],
                        device=u.device)
    keep = place < caps[call]
    tok = torch.arange(xt.shape[0], device=u.device).repeat_interleave(k)
    flat_e, flat_w = top_i.reshape(-1), top_p.reshape(-1)
    y = torch.zeros_like(xt)
    for e in range(e_n):
        sel = keep & (flat_e == e)
        if not bool(sel.any()):
            continue
        t = tok[sel]
        y.index_add_(0, t, _swiglu(xt[t], p["w1"][e], p["w3"][e],
                                   p["w2"][e], pr) * flat_w[sel][:, None])
    y = y + _swiglu(xt, p["shared_w1"], p["shared_w3"], p["shared_w2"], pr)
    out = torch.empty_like(u)
    out[:, :prompt_len] = y[:sizes[0]].view(b_n, prompt_len, d)
    out[:, prompt_len:] = y[sizes[0]:].view(n - prompt_len, b_n,
                                            d).transpose(0, 1)
    near = torch.empty(b_n, n, dtype=torch.bool, device=u.device)
    near[:, :prompt_len] = tie[:sizes[0]].view(b_n, prompt_len)
    near[:, prompt_len:] = tie[sizes[0]:].view(n - prompt_len, b_n).T
    return out, near


def final_hidden(params: dict, cfg: dict, tokens: torch.Tensor,
                 prompt_len: int, pr: Prec | None = None,
                 capacity_factor: float | None = None,
                 ties: dict | None = None, routes: list | None = None,
                 own: list | None = None) -> torch.Tensor:
    """The final-normed hidden states [B, L - S + 1, d] of the positions
    S - 1 .. L - 1 of `tokens` [B, L] (the prompt's S tokens, then the
    served tokens fed back), whose logits are the served tokens' own.

    `ties`, if given, gets under "served" a [B, L - S + 1] mask of the
    served positions at or after the first of its row whose own expert
    choice, in some layer, was within TIE of a tie (where rounding sent
    it the other way, every later position of the row reads that
    position's other K/V), and under "prefill" whether any token of the
    prefill call made such a choice (one changed choice moves the expert
    queues of the whole call).

    `routes`, if given, holds for each MoE layer another run's expert
    choices [B * S, k] of the prompt's tokens (the program's, or a
    control's): where the reference's own choice of a prompt token differs
    and sits within TIE of a tie, rounding decided it, and the reference
    takes the other run's, since one flipped choice moves the expert
    queues of the whole call and, through every later position's
    attention, that position's hidden state; `ties` then gets "pinned"
    and "route_diff", the prompt tokens taken so and those whose choice
    differs further from a tie (kept).  `own`, if given, gets each MoE
    layer's own prompt choices, for another run to be pinned to."""
    pr = pr or Prec()
    count = {"pinned": 0, "route_diff": 0}
    eps = cfg["rms_norm_eps"]
    near = torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    blocks = params["blocks"]
    period = len(blocks)
    x = params["embed"]["tok"][tokens.long()].float()
    if cfg["mup_enabled"]:
        x = x * cfg["hidden_size"] ** 0.5
    cf = capacity_factor or cfg.get("capacity_factor")
    for i in range(cfg["num_hidden_layers"]):
        layer = _layer(blocks[f"sub{i % period}"], i // period)
        sliding = cfg["layer_types"][i] == "sliding_attention"
        a = _attention(layer["attn"], _rms(x, layer["ln1_w"], eps), cfg,
                       sliding, pr)
        x = x + _rms(a, layer["ln1_post_w"], eps)
        u = _rms(x, layer["ln2_w"], eps)
        if i < cfg["num_dense_layers"]:
            m = layer["mlp"]
            y = _swiglu(u, m["w_gate"], m["w_up"], m["w_down"], pr)
        else:
            j = i - cfg["num_dense_layers"]
            y, tie = _moe(layer["moe"], u, cfg, prompt_len, cf, pr,
                          routes[j] if routes else None, own, count)
            near = near | tie
        x = x + _rms(y, layer["ln2_post_w"], eps)
    if ties is not None:
        ties["served"] = near[:, prompt_len - 1:].cumsum(1) > 0
        ties["prefill"] = bool(near[:, :prompt_len].any())
        ties.update(count)
    x = x[:, prompt_len - 1:]
    return _rms(x, params["final"]["lnf_w"], eps)


def _layer(sub: dict, g: int) -> dict:
    return {k: (_layer(v, g) if isinstance(v, dict) else v[g])
            for k, v in sub.items()}


def logits(params: dict, cfg: dict, h: torch.Tensor,
           pr: Prec | None = None) -> torch.Tensor:
    """[..., d] -> [..., vocab] over the real vocabulary."""
    pr = pr or Prec()
    return pr.mm(h, params["lm_head"][:, :cfg["vocab_size"]])
