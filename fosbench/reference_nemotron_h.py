"""Plain PyTorch reference of NVIDIA-Nemotron-3-Nano-30B-A3B (nemotron_h),
written from the published config.json and modeling code; it imports
nothing but torch.

The forward of a whole teacher-forced sequence, prompt and served tokens,
with no cache, no kernel and no batching trick, in float32 with TF32 off
(set at import).  Every block is h <- h + mixer(RMSNorm(h)) with one
mixer a block, in the order of `hybrid_override_pattern`'s first
`num_hidden_layers` characters; then a final RMSNorm and the untied
unembedding.  RMSNorm eps `norm_eps` everywhere.

- M, Mamba2: z, x, B, C and dt from the input projection; a depthwise
  causal conv (with bias) and SiLU over x, B, C; `mamba_num_heads` heads
  of `mamba_head_dim`, B and C in `n_groups` groups of `ssm_state_size`
  (head h reads group h // (heads / groups)); dt = softplus(dt + dt_bias),
  A = -exp(A_log); the chunked SSD scan, y += D x; the gated RMSNorm
  norm(y * silu(z)) over each group of d_inner / n_groups channels, times
  its weight; the out-projection.
- E, MoE: scores sigmoid(x W) in fp32 over `n_routed_experts`; the top
  `num_experts_per_tok` of scores + e_score_correction_bias chosen (one
  group: no group masking); weights the unbiased scores of the chosen,
  over their sum + 1e-20 (`norm_topk_prob`), times
  `routed_scaling_factor`; each expert W2 relu(W1 x)^2; plus the shared
  expert of the same form.
- *, attention: causal grouped-query attention, no bias, no positional
  embedding (the published attention has no rotary step).

Departures from the published model:
- float32 where the checkpoint is bfloat16;
- each expert holds at most `capacity_factor` of an even share of a call's
  pairs, max(8, ceil8(int(T k c / E))), the pairs past it dropped in
  token-major (token, k) order, as the served layer does (the published
  model is dropless).  A call is the prompt of every row, then each later
  position's B tokens, so the positions are grouped so.

Weights are the port's param tree: `embed/tok` [V, d], `lm_head` [d, V],
`final/lnf_w`, and `blocks/sub{j}` stacked over groups, layer i at
sub i % P of group i // P for P subs: M and * blocks `ln1_w` and `mamba`
or `attn`, E blocks `ln2_w` and `moe` (`w_router` [d, E], `router_bias`
[E], `w1` [E, d, F], `w2` [E, F, d], `shared_w1`, `shared_w2`).

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

REF_CHUNK = 64      # the reference's own chunk of the SSD scan
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


def pattern(cfg: dict) -> str:
    """The served blocks' kinds, one character a layer."""
    return cfg["hybrid_override_pattern"][:cfg["num_hidden_layers"]]


def _attention(p, h, cfg, pr: Prec):
    """Causal grouped-query attention of each row of h [B, L, d]."""
    hq, hkv, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                   cfg["head_dim"])
    g = hq // hkv
    b_n, n, _ = h.shape
    out = torch.empty(b_n, n, hq * hd, device=h.device)
    causal = torch.ones(n, n, dtype=torch.bool, device=h.device).tril()
    for b in range(b_n):
        q = pr.mm(h[b], p["wq"]).view(n, hq, hd)
        k = pr.mm(h[b], p["wk"]).view(n, hkv, hd)
        v = pr.mm(h[b], p["wv"]).view(n, hkv, hd)
        for j in range(hkv):
            qj = q[:, j * g:(j + 1) * g].transpose(0, 1)     # [g, L, hd]
            s = pr.einsum("gqd,kd->gqk", qj, k[:, j]) * hd ** -0.5
            s = torch.where(causal, s, -torch.inf).softmax(-1)
            o = pr.einsum("gqk,kd->qgd", s, v[:, j])
            out[b, :, j * g * hd:(j + 1) * g * hd] = o.reshape(n, g * hd)
    return pr.mm(out, p["wo"])


def _capacity(n_tokens: int, cfg: dict, cf: float) -> int:
    c = int(n_tokens * cfg["num_experts_per_tok"] * cf
            / cfg["n_routed_experts"])
    return max(8, (c + 7) // 8 * 8)


def _relu2(x, w1, w2, pr: Prec):
    return pr.mm(torch.relu(pr.mm(x, w1)).square(), w2)


def _moe(p, h, cfg, prompt_len: int, cf: float, pr: Prec):
    """The MoE block over h [B, L, d]; the prompt positions of all rows
    are one call of the layer, each later position's B tokens another.
    Returns the output and the [B, L] mask of near-tie choices."""
    b_n, n, d = h.shape
    e_n, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    order = [h[:, :prompt_len].reshape(-1, d)] + [h[:, i] for i in
                                                   range(prompt_len, n)]
    sizes = [b_n * prompt_len] + [b_n] * (n - prompt_len)
    xt = torch.cat(order)                                      # [T, d]
    scores = torch.sigmoid(pr.mm(xt, p["w_router"]))
    choice = scores + p["router_bias"]
    srt, top_i = torch.sort(choice, dim=-1, descending=True, stable=True)
    tie = (srt[:, k - 1] - srt[:, k]) < TIE * choice.std(-1)
    top_i = top_i[:, :k]
    top_p = scores.gather(1, top_i)
    top_p = top_p / (top_p.sum(-1, keepdim=True) + 1e-20)
    top_p = top_p * cfg["routed_scaling_factor"]
    # each pair's place in its expert's queue within its call
    onehot = F.one_hot(top_i.reshape(-1), e_n).to(torch.int32)  # [T*k, E]
    upto = onehot.cumsum(0)
    call = torch.repeat_interleave(
        torch.arange(len(sizes), device=h.device),
        torch.tensor(sizes, device=h.device) * k)
    starts = torch.tensor([0] + sizes[:-1], device=h.device).cumsum(0) * k
    before = torch.where(starts[:, None] > 0,
                         upto[(starts - 1).clamp(min=0)], 0)   # [calls, E]
    place = ((upto - before[call]) * onehot).sum(-1) - 1       # [T*k]
    caps = torch.tensor([_capacity(s, cfg, cf) for s in sizes],
                        device=h.device)
    keep = place < caps[call]
    tok = torch.arange(xt.shape[0], device=h.device).repeat_interleave(k)
    flat_e, flat_w = top_i.reshape(-1), top_p.reshape(-1)
    y = torch.zeros_like(xt)
    for e in range(e_n):
        sel = keep & (flat_e == e)
        if not bool(sel.any()):
            continue
        t = tok[sel]
        y.index_add_(0, t, _relu2(xt[t], p["w1"][e], p["w2"][e], pr)
                     * flat_w[sel][:, None])
    y = y + _relu2(xt, p["shared_w1"], p["shared_w2"], pr)
    out = torch.empty_like(h)
    out[:, :prompt_len] = y[:sizes[0]].view(b_n, prompt_len, d)
    out[:, prompt_len:] = y[sizes[0]:].view(n - prompt_len, b_n,
                                            d).transpose(0, 1)
    near = torch.empty(b_n, n, dtype=torch.bool, device=h.device)
    near[:, :prompt_len] = tie[:sizes[0]].view(b_n, prompt_len)
    near[:, prompt_len:] = tie[sizes[0]:].view(n - prompt_len, b_n).T
    return out, near


def _segsum(x):
    """[..., T] -> [..., T, T]: sum of x over (j, i] at [i, j], -inf above
    the diagonal; a cumsum of masked copies, so no long sums are
    subtracted."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    below = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    s = x.masked_fill(~below, 0).cumsum(-2)
    return s.masked_fill(~torch.ones(t, t, dtype=torch.bool,
                                     device=x.device).tril(), -torch.inf)


def _ssd(x, dt, a, bm, cm, chunk: int, pr: Prec):
    """x [L, H, P], dt [L, H], a [H], bm / cm [L, H, N] -> y [L, H, P];
    the chunked SSD (arXiv:2405.21060) over one row."""
    n, h, p = x.shape
    pad = -n % chunk
    if pad:
        x, dt, bm, cm = (F.pad(t, (0,) * (2 * t.dim() - 1) + (pad,))
                         for t in (x, dt, bm, cm))
    c = x.shape[0] // chunk
    xs = (x * dt[..., None]).view(c, chunk, h, p)
    ad = (dt * a).view(c, chunk, h).permute(2, 0, 1)            # [H, c, l]
    bm, cm = bm.view(c, chunk, h, -1), cm.view(c, chunk, h, -1)
    lmat = torch.exp(_segsum(ad))                               # [H,c,l,s]
    cb = pr.einsum("clhn,cshn->hcls", cm, bm) * lmat
    y = pr.einsum("hcls,cshp->clhp", cb, xs)
    # each chunk's state from its own inputs: decay from s to the chunk end
    tail = torch.flip(torch.flip(ad, [-1]).cumsum(-1), [-1]) - ad
    states = pr.einsum("clhn,hcl,clhp->chpn", bm, torch.exp(tail), xs)
    # states carried over chunks: decays between chunk ends
    tot = F.pad(ad.sum(-1), (1, 0))                             # [H, c+1]
    carry = torch.exp(_segsum(tot))                             # [H,c+1,c+1]
    states = torch.cat([torch.zeros_like(states[:1]), states])
    start = pr.einsum("hzc,chpn->zhpn", carry, states)[:-1]     # [c,H,P,N]
    into = torch.exp(ad.cumsum(-1))                             # [H, c, l]
    y = y + pr.einsum("clhn,chpn,hcl->clhp", cm, start, into)
    return y.reshape(-1, h, p)[:n]


def _conv(u, w, bias):
    """Depthwise causal conv and SiLU: u [L, C], w [K, C]."""
    k = w.shape[0]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = sum(up[i:i + u.shape[0]] * w[i] for i in range(k))
    return F.silu(out + bias)


def _mamba(p, h, cfg, pr: Prec):
    """The Mamba2 mixer over each row of h [B, L, d]."""
    g, n_st = cfg["n_groups"], cfg["ssm_state_size"]
    heads, hd = cfg["mamba_num_heads"], cfg["mamba_head_dim"]
    eps = cfg["norm_eps"]
    out = torch.empty_like(h)
    for b in range(h.shape[0]):
        x = h[b]
        n = x.shape[0]
        z = pr.mm(x, p["w_z"])
        xu = _conv(pr.mm(x, p["w_x"]), p["w_conv_x"], p["b_conv_x"])
        bc = _conv(pr.mm(x, p["w_bc"]), p["w_conv_bc"], p["b_conv_bc"])
        dt = F.softplus(pr.mm(x, p["w_dt"]) + p["dt_bias"])
        a = -torch.exp(p["a_log"])
        bm = bc[:, :g * n_st].view(n, g, n_st).repeat_interleave(
            heads // g, dim=1)
        cm = bc[:, g * n_st:].view(n, g, n_st).repeat_interleave(
            heads // g, dim=1)
        xh = xu.view(n, heads, hd)
        y = _ssd(xh, dt, a, bm, cm, REF_CHUNK, pr)
        y = (y + xh * p["d_skip"][:, None]).reshape(n, -1) * F.silu(z)
        # the gated norm within each group of d_inner / n_groups channels
        y = _rms(y.view(n, g, -1), p["norm_w"].view(g, -1), eps)
        out[b] = pr.mm(y.reshape(n, -1), p["w_out"])
    return out


def final_hidden(params: dict, cfg: dict, tokens: torch.Tensor,
                 prompt_len: int, pr: Prec | None = None,
                 capacity_factor: float | None = None,
                 ties: dict | None = None) -> torch.Tensor:
    """The final-normed hidden states [B, L - S + 1, d] of the positions
    S - 1 .. L - 1 of `tokens` [B, L] (the prompt's S tokens, then the
    served tokens fed back), whose logits are the served tokens' own.

    `ties`, if given, gets under "served" a [B, L - S + 1] mask of the
    served positions at or after the first of its row whose own expert
    choice, in some layer, was within TIE of a tie (where rounding sent
    it the other way, every later position of the row reads that
    position's other K/V and SSM state), and under "prefill" whether any
    token of the prefill call made such a choice (one changed choice
    moves the expert queues of the whole call)."""
    pr = pr or Prec()
    eps = cfg["norm_eps"]
    near = torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    blocks = params["blocks"]
    period = len(blocks)
    x = params["embed"]["tok"][tokens.long()].float()
    cf = capacity_factor or cfg.get("capacity_factor")
    for i, kind in enumerate(pattern(cfg)):
        layer = _layer(blocks[f"sub{i % period}"], i // period)
        if kind == "M":
            x = x + _mamba(layer["mamba"], _rms(x, layer["ln1_w"], eps),
                           cfg, pr)
        elif kind == "*":
            x = x + _attention(layer["attn"], _rms(x, layer["ln1_w"], eps),
                               cfg, pr)
        elif kind == "E":
            y, tie = _moe(layer["moe"], _rms(x, layer["ln2_w"], eps), cfg,
                          prompt_len, cf, pr)
            x, near = x + y, near | tie
        else:
            raise ValueError(f"block kind {kind!r}")
    if ties is not None:
        ties["served"] = near[:, prompt_len - 1:].cumsum(1) > 0
        ties["prefill"] = bool(near[:, :prompt_len].any())
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
