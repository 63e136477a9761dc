"""Configurations and mixes cut to sizes a CPU test holds (the port's
reduced shapes), the same files otherwise."""
from fosbench import common


def config(name: str) -> dict:
    cfg = common.config(name)
    if cfg["family"] == "moe":
        cfg.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=16, num_experts=8,
                   num_experts_per_tok=2, moe_intermediate_size=32,
                   vocab_size=256)
    else:
        cfg.update(d_model=64, n_layer=2, d_state=16, headdim=16,
                   chunk_size=16, vocab_size=256)
    return cfg


def serve_traffic(name: str, low: int = 20, high: int = 70) -> dict:
    tr = common.traffic(name)
    tr.update(batch=3, new_tokens=6, warmup_new_tokens=2)
    tr["prompt_len"] = {"dist": "uniform", "low": low, "high": high,
                        "set": 4, "round_to": 1}
    return tr
