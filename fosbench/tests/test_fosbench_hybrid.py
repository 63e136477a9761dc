"""The hybrid configuration's harness on the CPU at the port's reduced
nemotron-h shapes: the weight table is the port's param table, the FLOP
count by block kind, and the served loop against the plain reference
(the program sound, the TF32 control not)."""
import math
import time

import torch

from fosbench import common, hybrid, serve_hybrid

CONFIG = "nemotron-3-nano-30b-a3b-21l"


def tiny() -> dict:
    cfg = common.config(CONFIG)
    cfg.update(hidden_size=64, num_attention_heads=16, num_key_value_heads=1,
               head_dim=16, mamba_num_heads=8, mamba_head_dim=16,
               n_groups=4, ssm_state_size=16, chunk_size=16,
               n_routed_experts=8, num_experts_per_tok=3,
               moe_intermediate_size=32,
               moe_shared_expert_intermediate_size=48, vocab_size=256,
               num_hidden_layers=14)
    return cfg


def test_the_table_is_the_ports_param_table():
    from repro_torch.models import api
    for cfg in (tiny(), common.config(CONFIG)):
        want = {p: tuple(t.shape) for p, t in api.flatten(
            api.abstract_params(hybrid.port_config(cfg)))}
        got = {p: s for p, (s, _) in hybrid.table(cfg).items()}
        assert got == want
    assert sum(math.prod(s) for s, _ in hybrid.table(
        common.config(CONFIG)).values()) == 12_800_760_384


def test_the_served_pattern_and_its_period():
    m = hybrid.dims(common.config(CONFIG))
    assert m["pattern"] == "MEMEM*E" * 3
    assert hybrid.period(m["pattern"]) == "MEMEM*E"
    assert (m["ssm_layers"], m["moe_layers"], m["attn_layers"]) == (9, 9, 3)
    assert hybrid.period("MEMEM*EMEM") == "MEMEM*EMEM"


def test_flops_by_block_kind():
    """At the mix's median prompt the MoE blocks take about 61%, the
    Mamba2 blocks 31% and attention 8% of ~2.36 GFLOP a token."""
    m = hybrid.dims(common.config(CONFIG))
    f = hybrid.block_flops(m, 4, 2048)
    total = sum(f.values())
    assert abs(total / (4 * 2048) / 2.356e9 - 1) < 1e-3
    assert [round(100 * f[k] / total) for k in "EM*"] == [61, 31, 8]


def test_served_run_matches_the_reference_and_the_control_does_not():
    tr = common.traffic("rag_b4_hybrid")
    tr.update(batch=2, new_tokens=6, warmup_new_tokens=2, check_batches=3)
    tr["prompt_len"] = {"dist": "uniform", "low": 20, "high": 70, "set": 4,
                        "round_to": 1}
    out = serve_hybrid.run({"name": "test"}, tiny(), tr, 2**33 + 5, 1.0,
                           False, torch.device("cpu"), time.perf_counter(),
                           log=lambda *a, **k: None)
    got, ctl = out["check"](), out["check"]("tf32")
    assert got["gap"] <= 1e-5
    assert got["logit_err"] <= 1e-4 and got["first_err"] <= 1e-4
    assert ctl["logit_err"] > 1e-3 and ctl["first_err"] > 1e-3
