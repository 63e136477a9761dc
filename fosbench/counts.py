"""Operations and bytes counted from shapes, and the card's peaks.

Everything here is arithmetic on sizes, so it runs on any machine; the
times it is divided by come from the card.  Bytes count each input byte
read once and each output byte written once, whatever an implementation
reads again, so a later change of route reads the same work.

Peaks: one NVIDIA H100 SXM's data sheet, dense: 989.4 TFLOP/s in bf16,
half of it (494.7) in TF32, 3.35 TB/s of HBM.  A kernel's fp32 instance
is bounded at the TF32 rate, since no fp32-accurate route runs faster.
"""
from __future__ import annotations

PEAK_BF16 = 989.4e12
PEAK_TF32 = 494.7e12
HBM_BW = 3.35e12


def dims(cfg: dict) -> dict:
    """The sizes a count needs, from a configuration file's keys."""
    if cfg["family"] == "moe":
        return {"family": "moe", "layers": cfg["num_hidden_layers"],
                "d": cfg["hidden_size"], "hq": cfg["num_attention_heads"],
                "hkv": cfg["num_key_value_heads"], "hd": cfg["head_dim"],
                "experts": cfg["num_experts"],
                "top_k": cfg["num_experts_per_tok"],
                "d_ff": cfg["moe_intermediate_size"],
                "vocab": cfg["vocab_size"]}
    d_inner = cfg["expand"] * cfg["d_model"]
    return {"family": "ssm", "layers": cfg["n_layer"], "d": cfg["d_model"],
            "d_inner": d_inner, "heads": d_inner // cfg["headdim"],
            "headdim": cfg["headdim"], "d_state": cfg["d_state"],
            "groups": cfg["ngroups"], "conv": cfg["d_conv"],
            "chunk": cfg["chunk_size"], "vocab": cfg["vocab_size"]}


def token_params(m: dict) -> int:
    """Multiplying parameters one token touches in one layer: MoE takes
    top-k of the experts; norms and gates multiply nothing by a weight
    matrix.  The embedding lookup is no multiply and is not counted."""
    d = m["d"]
    if m["family"] == "moe":
        attn = d * (m["hq"] + 2 * m["hkv"]) * m["hd"] + m["hq"] * m["hd"] * d
        return attn + d * m["experts"] + m["top_k"] * 3 * d * m["d_ff"]
    bc = 2 * m["groups"] * m["d_state"]
    return (d * (2 * m["d_inner"] + bc + m["heads"]) + m["d_inner"] * d
            + m["conv"] * (m["d_inner"] + bc))


def ssd_flops(b: int, length: int, m: dict) -> int:
    """The chunked SSD scan of one layer over [b, length] (chip_smoke's
    count): per chunk C.B^T over the causal triangle once a group, the
    score.x product over the triangle, C.S and the state update a head."""
    q, n, p, h, g = (m["chunk"], m["d_state"], m["headdim"], m["heads"],
                     m["groups"])
    tri = q * (q + 1) // 2
    n_chunks = -(-length // q)
    return n_chunks * b * (2 * n * tri * g + h * (2 * p * tri + 4 * q * n * p))


def prefill_flops(m: dict, b: int, s: int) -> int:
    """Model FLOPs of a prefill of [b, s]: 2 x the multiplying parameters
    x tokens, attention's score and value products over the causal prefix
    (or the SSD scan), and the unembedding of the last position a row."""
    f = 2 * token_params(m) * b * s * m["layers"]
    if m["family"] == "moe":
        f += 4 * m["hq"] * m["hd"] * (s * (s + 1) // 2) * b * m["layers"]
    else:
        f += ssd_flops(b, s, m) * m["layers"]
    return f + 2 * m["d"] * m["vocab"] * b


def decode_step_flops(m: dict, b: int, pos: int) -> int:
    """Model FLOPs of one decode step of b tokens at position `pos`, which
    attend over the pos + 1 rows of the cache (or update the SSM state)."""
    f = 2 * token_params(m) * b * m["layers"]
    if m["family"] == "moe":
        f += 4 * m["hq"] * m["hd"] * (pos + 1) * b * m["layers"]
    else:
        f += 4 * m["heads"] * m["headdim"] * m["d_state"] * b * m["layers"]
    return f + 2 * m["d"] * m["vocab"] * b


def generate_flops(m: dict, b: int, s: int, new: int) -> tuple[int, int]:
    """(prefill, decode) model FLOPs of `generate` over a [b, s] prompt
    and `new` served tokens: the prefill gives token 0, decode steps at
    positions s .. s + new - 2 give the rest."""
    return (prefill_flops(m, b, s),
            sum(decode_step_flops(m, b, s + i) for i in range(new - 1)))


def decode_attention_work(b: int, hq: int, hkv: int, hd: int, length: int,
                          elem: int = 4) -> tuple[int, int]:
    """(bytes, flops) of one decode-attention call over `length` cache
    rows: q and the output once, K and V's valid rows once."""
    nbytes = elem * (2 * b * length * hkv * hd + 2 * b * hq * hd)
    return nbytes, 4 * b * hq * length * hd


def ssd_work(b: int, length: int, h: int, p: int, g: int, n: int,
             chunk: int, elem: int = 4) -> tuple[int, int]:
    """(bytes, flops) of one SSD scan call (its four kernels): x, dt, B, C,
    A and the initial state read once, y and the final state written."""
    nbytes = elem * (2 * b * length * h * p + b * length * h
                     + 2 * b * length * g * n + h + 2 * b * h * p * n)
    tri = chunk * (chunk + 1) // 2
    n_chunks = -(-length // chunk)
    flops = n_chunks * b * (2 * n * tri * g
                            + h * (2 * p * tri + 4 * chunk * n * p))
    return nbytes, flops


def flash_work(b: int, s: int, hq: int, hkv: int, hd: int,
               elem: int = 4) -> tuple[int, int]:
    """(bytes, flops) of one causal flash-attention call."""
    nbytes = elem * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    return nbytes, 4 * b * hq * hd * (s * (s + 1) // 2)


def bound_seconds(nbytes: float, flops: float, peak: float) -> float:
    """The least time the card could take: bytes at HBM rate or operations
    at `peak`, whichever is longer."""
    return max(nbytes / HBM_BW, flops / peak)
