"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

32 layers = 4 super-blocks of 8 sub-layers (attn at index 4, mamba
elsewhere; MoE FFN on odd sub-layers).  Jamba v0.1 uses Mamba-1 internally;
the reference substitutes its Mamba2/SSD block with d_state=16, and so does
the port.  d_inner=8192, headdim=64 => 128 SSD heads.
"""
from repro_torch.models.api import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536, attn_every=8,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, every=2),
    ssm=SSMConfig(d_state=16, headdim=64, expand=2, chunk=128))

REDUCED = ModelConfig(
    name="jamba-v0.1-52b-reduced", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, attn_every=4,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff=128, every=2),
    ssm=SSMConfig(d_state=16, headdim=16, expand=2, chunk=16))
