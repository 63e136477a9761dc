"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.api import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab=32064, rope_theta=10000.0,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=6400))

REDUCED = ModelConfig(
    name="phi3.5-moe-42b-a6.6b-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=0, vocab=256, rope_theta=10000.0,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff=32))
