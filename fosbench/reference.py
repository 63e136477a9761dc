"""Plain PyTorch references of the served models, written from the
published descriptions; nothing of the port is imported.

Both run a whole teacher-forced sequence, prompt and served tokens, with no
cache, no kernel and no batching trick, in float32 with TF32 off.  The
caller asks for the final hidden states of the positions whose logits were
served and unembeds them a row at a time, so nothing of size [B, L, V] is
ever held.

Qwen3-MoE (hf:Qwen/Qwen3-30B-A3B): pre-norm blocks of grouped-query
attention (RMS-normed q and k per head, rotary half rotation) and a
top-k-of-E SwiGLU expert layer whose top-k weights are renormalised.  The
served deployment caps each expert's tokens at a capacity of
max(8, ceil8(int(T k c / E))) per call of the layer over T tokens and drops
the pairs past it in token-major (token, k) order; a call is the whole
prefill of a batch, then each decode step's B tokens, so the reference
groups the positions the same way.

Mamba-2 (arXiv:2405.21060): pre-norm SSD blocks: in-projections to z, x,
B, C and dt, a depthwise causal conv and SiLU on x and on B, C,
dt = softplus(. + dt_bias), h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
y_t = C_t h_t + D x_t, a gated RMSNorm norm(y * silu(z)) and the
out-projection.  The scan is the paper's chunked form with decays from
segment sums taken inside each chunk (no difference of long prefix sums).

`Prec("tf32")` is the control of a float32 model: every product's
operands rounded to TF32's 10-bit mantissa (round to nearest), the
accumulation in float32, as TF32 tensor cores compute.  It is emulated
the same way on every device, so it runs on the CPU too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-6
REF_CHUNK = 64      # the reference's own chunk of the SSD scan
# an expert choice whose router-logit margin (k-th over the next) is under
# TIE of the token's router-logit spread is one rounding may decide: the
# program's hidden states differ from these by ~1e-5 of their size
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


def _rms(x, w):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * w


def _rope(x, theta):
    """x [L, H, hd] at positions 0..L-1, half rotation."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(x.shape[0], device=x.device,
                       dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


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
        q = _rope(_rms(q, p["q_norm"]), cfg["rope_theta"])
        k = _rope(_rms(k, p["k_norm"]), cfg["rope_theta"])
        for j in range(hkv):
            qj = q[:, j * g:(j + 1) * g].transpose(0, 1)     # [g, L, hd]
            s = pr.einsum("gqd,kd->gqk", qj, k[:, j]) * hd ** -0.5
            s = torch.where(causal, s, -torch.inf).softmax(-1)
            o = pr.einsum("gqk,kd->qgd", s, v[:, j])
            out[b, :, j * g * hd:(j + 1) * g * hd] = o.reshape(n, g * hd)
    return pr.mm(out, p["wo"])


def _capacity(n_tokens: int, cfg: dict, cf: float) -> int:
    c = int(n_tokens * cfg["num_experts_per_tok"] * cf / cfg["num_experts"])
    return max(8, (c + 7) // 8 * 8)


def _moe(p, h, cfg, prompt_len: int, cf: float, pr: Prec):
    """The expert layer over h [B, L, d]; the prompt positions of all rows
    are one call of the layer, each later position's B tokens another."""
    b_n, n, d = h.shape
    e_n, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    # token-major order within each call: the prompt [B, S] flattened, then
    # position by position
    order = [h[:, :prompt_len].reshape(-1, d)] + [h[:, i] for i in
                                                   range(prompt_len, n)]
    sizes = [b_n * prompt_len] + [b_n] * (n - prompt_len)
    xt = torch.cat(order)                                      # [T, d]
    logit = pr.mm(xt, p["w_router"])
    probs = logit.softmax(-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    # a choice between the k-th and the next expert that rounding decides
    srt = logit.sort(-1, descending=True).values
    tie = (srt[:, k - 1] - srt[:, k]) < TIE * logit.std(-1)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
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
        xe = xt[t]
        a = F.silu(pr.mm(xe, p["w1"][e])) * pr.mm(xe, p["w3"][e])
        y.index_add_(0, t, pr.mm(a, p["w2"][e]) * flat_w[sel][:, None])
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
    the paper's chunked SSD over one row."""
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
    """The SSD mixer over each row of h [B, L, d]."""
    g, n_st = cfg["ngroups"], cfg["d_state"]
    hd = cfg["headdim"]
    out = torch.empty_like(h)
    for b in range(h.shape[0]):
        x = h[b]
        z = pr.mm(x, p["w_z"])
        xu = _conv(pr.mm(x, p["w_x"]), p["w_conv_x"], p["b_conv_x"])
        bc = _conv(pr.mm(x, p["w_bc"]), p["w_conv_bc"], p["b_conv_bc"])
        dt = F.softplus(pr.mm(x, p["w_dt"]) + p["dt_bias"])
        a = -torch.exp(p["a_log"])
        heads = dt.shape[-1]
        n = x.shape[0]
        bm = bc[:, :g * n_st].view(n, g, n_st).repeat_interleave(
            heads // g, dim=1)
        cm = bc[:, g * n_st:].view(n, g, n_st).repeat_interleave(
            heads // g, dim=1)
        xh = xu.view(n, heads, hd)
        y = _ssd(xh, dt, a, bm, cm, REF_CHUNK, pr)
        y = y + xh * p["d_skip"][:, None]
        y = _rms(y.reshape(n, -1) * F.silu(z), p["norm_w"])
        out[b] = pr.mm(y, p["w_out"])
    return out


def final_hidden(params: dict, cfg: dict, tokens: torch.Tensor,
                 prompt_len: int, pr: Prec | None = None,
                 capacity_factor: float | None = None,
                 ties: dict | None = None) -> torch.Tensor:
    """The final-normed hidden states [B, L - S + 1, d] of the positions
    S - 1 .. L - 1 of `tokens` [B, L] (the prompt's S tokens, then the
    served tokens fed back), whose logits are the served tokens' own.

    `ties`, if given, gets under "served" a [B, L - S + 1] mask of the
    served positions whose own expert choice, in some layer, was within
    TIE of a tie (float32 rounding may decide it either way, and the
    position's logits then move by far more than rounding), and under
    "prefill" whether any token of the prefill call made such a choice:
    one changed choice moves the expert queues of the whole call, so the
    prefill's own position is then held by its logits (see
    `serve._check`), not marked."""
    pr = pr or Prec()
    near = torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    blocks = params["blocks"]["sub0"]
    x = params["embed"]["tok"][tokens.long()].float()
    n_layers = blocks["ln1_w"].shape[0]
    cf = capacity_factor or cfg.get("capacity_factor")
    for i in range(n_layers):
        layer = {k: (v[i] if not isinstance(v, dict) else
                     {kk: vv[i] for kk, vv in v.items()})
                 for k, v in blocks.items()}
        h = _rms(x, layer["ln1_w"])
        if cfg["family"] == "moe":
            x = x + _attention(layer["attn"], h, cfg, pr)
            y, tie = _moe(layer["moe"], _rms(x, layer["ln2_w"]), cfg,
                          prompt_len, cf, pr)
            x, near = x + y, near | tie
        else:
            x = x + _mamba(layer["mamba"], h, cfg, pr)
    if ties is not None:
        ties["served"] = near[:, prompt_len - 1:]
        ties["prefill"] = bool(near[:, :prompt_len].any())
    x = x[:, prompt_len - 1:]
    return _rms(x, params["final"]["lnf_w"])


def logits(params: dict, cfg: dict, h: torch.Tensor,
           pr: Prec | None = None) -> torch.Tensor:
    """[..., d] -> [..., vocab] over the real vocabulary."""
    pr = pr or Prec()
    return pr.mm(h, params["lm_head"][:, :cfg["vocab_size"]])

