"""trinity-mini [moe] — sliding-window and full attention, sigmoid-routed
experts.  [hf:arcee-ai/Trinity-Mini, config.json, model_type afmoe]

32 layers at hidden size 2048 in the published `layer_types`: three
sliding-window layers (window 2048, RoPE theta 1e4 on all 128 dims) then
one full-attention layer without positions (NoPE), eight times.  GQA 32 q /
4 kv heads of 128 with qk-norm; the attention output gated by
sigmoid(x W_gate) over the heads; a norm before and after each attention
and FFN (sandwich norms); embeddings times sqrt(2048) (muP).  Layers 0-1
a dense SwiGLU of 6144, the rest MoE: 128 SwiGLU experts of 1024, top 8
of sigmoid(x W) + a bias, weighted by the unbiased scores renormalised
times 2.826, plus one shared SwiGLU expert of 1024.  RMSNorm eps 1e-5,
untied 200192-row vocabulary.  Not one of the reference's ten
architectures: the port serves it (`PORT_ARCH_IDS`), and
`src/plain_ref/afmoe.py` is its plain reference.
"""
from repro_torch.models.api import ModelConfig, MoEConfig

# afmoe's layers by `PATTERN_LAYERS`: d a window layer before the dense FFN,
# e a window layer before MoE, F a full layer before MoE
PATTERN = "ddeF" + "eeeF" * 7

CONFIG = ModelConfig(
    name="trinity-mini", family="moe",
    n_layers=32, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=6144, vocab=200192, qk_norm=True, rope_theta=10000.0,
    norm_eps=1e-5, layer_pattern=PATTERN, sliding_window=2048,
    nope_full=True, attn_gate=True, post_norms=True, mup_embed=True,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=1024, router="sigmoid_bias",
                  routed_scale=2.826, expert_act="swiglu", shared_d_ff=1024))

# two periods of the published 3:1 ratio after the two dense layers, a
# window of 8 so that short prompts wrap the ring several times; 8 q heads
# on 2 kv heads (G = 4), which the decode kernel runs on the card
REDUCED = ModelConfig(
    name="trinity-mini-reduced", family="moe",
    n_layers=8, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=256, qk_norm=True, rope_theta=10000.0,
    norm_eps=1e-5, layer_pattern="ddeFeeeF", sliding_window=8,
    nope_full=True, attn_gate=True, post_norms=True, mup_embed=True,
    moe=MoEConfig(n_experts=8, top_k=3, d_ff=32, router="sigmoid_bias",
                  routed_scale=2.826, expert_act="swiglu", shared_d_ff=32))
