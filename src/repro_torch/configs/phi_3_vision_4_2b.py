"""phi-3-vision-4.2b [vlm] — phi3-mini + CLIP (frontend stubbed).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

Backbone only: input_specs() supplies pre-projected patch embeddings
(576 patches at d_model) occupying the first sequence positions.
MHA: kv=32, head_dim=96.
"""
from repro_torch.models.api import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064, rope_theta=10000.0, n_patches=576)

REDUCED = ModelConfig(
    name="phi-3-vision-4.2b-reduced", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256, rope_theta=10000.0, n_patches=4)
