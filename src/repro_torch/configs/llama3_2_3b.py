"""llama3.2-3b [dense] — small llama3.  [hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=128256, rope_theta=500_000.0, tie_embeddings=True)

REDUCED = ModelConfig(
    name="llama3.2-3b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, rope_theta=500_000.0, tie_embeddings=True)
