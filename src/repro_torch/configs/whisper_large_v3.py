"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed.
[arXiv:2212.04356; unverified]

Backbone only: 32 encoder + 32 decoder layers, d_model=1280, 20 heads
(MHA: kv=20), GELU MLP, LayerNorm, attention biases, learned decoder
positions, sinusoidal encoder positions.  input_specs() supplies
precomputed frame embeddings (1500 frames) in place of the conv frontend.
"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    head_dim=64, d_ff=5120, vocab=51866, enc_seq=1536,
    mlp_kind="gelu", norm_kind="layer", attn_bias=True, max_pos=4096)
# enc_seq: whisper's conv frontend yields 1500 frames; the stub pads to 1536
# so the cross-attention cache sequence axis shards evenly (see DESIGN.md).

REDUCED = ModelConfig(
    name="whisper-large-v3-reduced", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=256, enc_seq=8,
    mlp_kind="gelu", norm_kind="layer", attn_bias=True, max_pos=64)
