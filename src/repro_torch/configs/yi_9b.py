"""yi-9b [dense] — llama-arch GQA.  [arXiv:2403.04652; hf]"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, rope_theta=5_000_000.0)

REDUCED = ModelConfig(
    name="yi-9b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, rope_theta=5_000_000.0)
