"""nemotron-3-nano-30b-a3b [hybrid] — Mamba2 / MoE / attention blocks.
[hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16, config.json, model_type
nemotron_h]

52 single-mixer blocks in the published hybrid_override_pattern: 23 Mamba2
(M: 64 heads of 64, B/C in 8 groups of d_state 128, the gated norm per
group of 512 channels), 23 MoE (E: 128 relu² experts of 1856, top 6 by a
sigmoid score plus a correction bias, weights the unbiased scores
renormalised times 2.5, one shared relu² expert of 3712) and 6 attention
(*: GQA 32 q / 2 kv heads of 128, no positional embedding).  RMSNorm eps
1e-5, untied 131072-row vocabulary.  Not one of the reference's ten
architectures: the port serves it (`PORT_ARCH_IDS`), and
`src/plain_ref/nemotron_h.py` is its plain reference.
"""
from repro_torch.models.api import ModelConfig, MoEConfig, SSMConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = ModelConfig(
    name="nemotron-3-nano-30b-a3b", family="hybrid",
    n_layers=52, d_model=2688, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=0, vocab=131072, layer_pattern=PATTERN, norm_eps=1e-5,
    use_rope=False,
    moe=MoEConfig(n_experts=128, top_k=6, d_ff=1856, router="sigmoid_bias",
                  routed_scale=2.5, expert_act="relu2", shared_d_ff=3712),
    ssm=SSMConfig(d_state=128, headdim=64, n_heads=64, n_groups=8,
                  conv_kernel=4, chunk=128))

# two periods of a five-block pattern; 16 q heads on one kv head, so the
# decode kernel's two CTAs a kv head run on the card
REDUCED = ModelConfig(
    name="nemotron-3-nano-30b-a3b-reduced", family="hybrid",
    n_layers=10, d_model=64, n_heads=16, n_kv_heads=1, head_dim=16,
    d_ff=0, vocab=256, layer_pattern="MEM*E", norm_eps=1e-5,
    use_rope=False,
    moe=MoEConfig(n_experts=8, top_k=3, d_ff=32, router="sigmoid_bias",
                  routed_scale=2.5, expert_act="relu2", shared_d_ff=48),
    ssm=SSMConfig(d_state=16, headdim=16, n_heads=8, n_groups=4,
                  conv_kernel=4, chunk=16))
