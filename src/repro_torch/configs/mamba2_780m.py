"""mamba2-780m [ssm] — SSD (state-space duality).  [arXiv:2405.21060; unverified]

48 blocks, d_model=1536 (d_inner=3072, headdim=64 => 48 SSD heads),
d_state=128, attention-free.
"""
from repro_torch.models.api import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, chunk=128))

REDUCED = ModelConfig(
    name="mamba2-780m-reduced", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=256,
    ssm=SSMConfig(d_state=16, headdim=16, expand=2, chunk=16))
