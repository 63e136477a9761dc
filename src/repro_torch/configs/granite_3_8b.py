"""granite-3-8b [dense] — GQA.  [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12800, vocab=49155, rope_theta=10000.0)

REDUCED = ModelConfig(
    name="granite-3-8b-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, rope_theta=10000.0)
