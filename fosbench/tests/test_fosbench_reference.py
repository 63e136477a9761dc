"""Each plain reference against the port at the port's reduced sizes on
the CPU, through the benchmark's own serve loop and comparison."""
import time

import pytest
import torch
import torch.nn.functional as F

from fosbench import reference, serve, weights
from fosbench.tests import tiny


@pytest.mark.parametrize("name,mix", [("qwen3-moe-30b-a3b-16l", "chat_b16"),
                                      ("mamba2-780m", "longdoc_b4")])
def test_served_run_matches_reference(name, mix):
    cfg, tr = tiny.config(name), tiny.serve_traffic(mix)
    tr["check_batches"] = 3
    out = serve.run({"name": "test"}, cfg, tr, 2**31 + 11, 2.0, False,
                    torch.device("cpu"), time.perf_counter(),
                    log=lambda *a, **k: None)
    got = out["check"]()
    n = len(got["batches"])
    assert n == min(3, len(out["ctx"]["batches"]))
    # every served token of the sample, but for decode positions near a tie
    assert got["served_tokens"] + got["near_ties"] == n * 3 * 6
    assert got["gap"] <= 1e-5
    assert got["logit_err"] <= 1e-4 and got["first_err"] <= 1e-4
    # the rate is every served token of the window over the whole window
    ctx = out["ctx"]
    served = sum(b["b"] * b["new"] for b in ctx["batches"])
    assert out["e2e"]["gen_tok_s"] == served / ctx["window_s"]
    assert out["attempted"] == sum(b["b"] for b in ctx["batches"])


def test_tied_unembedding_is_the_embedding():
    cfg = tiny.config("mamba2-780m")
    assert cfg["tie_embeddings"]
    p = weights.make(cfg, 2**31 + 5, "cpu")
    assert torch.equal(p["lm_head"], p["embed"]["tok"].T)
    cfg["tie_embeddings"] = False
    p = weights.make(cfg, 2**31 + 5, "cpu")
    assert not torch.equal(p["lm_head"], p["embed"]["tok"].T)


def _sequential_ssd(x, dt, a, bm, cm):
    """h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t;  y_t = C_t h_t."""
    n, h, p = x.shape
    st = torch.zeros(h, p, bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(n):
        st = (torch.exp(dt[t] * a)[:, None, None] * st
              + (dt[t][:, None] * x[t])[..., None] * bm[t][:, None, :])
        ys.append(torch.einsum("hpn,hn->hp", st, cm[t]))
    return torch.stack(ys)


def test_chunked_scan_equals_the_recurrence():
    g = torch.Generator().manual_seed(3)
    n, h, p, s = 150, 3, 4, 5
    x = torch.randn(n, h, p, generator=g, dtype=torch.float64)
    dt = F.softplus(torch.randn(n, h, generator=g, dtype=torch.float64))
    a = -torch.linspace(1, 16, h, dtype=torch.float64)
    bm = torch.randn(n, h, s, generator=g, dtype=torch.float64)
    cm = torch.randn(n, h, s, generator=g, dtype=torch.float64)
    got = reference._ssd(x, dt, a, bm, cm, 64, reference.Prec())
    want = _sequential_ssd(x, dt, a, bm, cm)
    assert torch.allclose(got, want, atol=1e-10, rtol=1e-8)


def test_expert_capacity_drops_as_the_port():
    """A router that sends every token to the same experts fills their
    queues: the reference's drops, call by call, are the port's."""
    from repro_torch.models import moe as moe_mod
    cfg = tiny.config("qwen3-moe-30b-a3b-16l")
    p = weights.make(cfg, 5, "cpu")["blocks"]["sub0"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    p["w_router"] = p["w_router"].clone()
    p["w_router"][:, :2] += 1.0           # experts 0 and 1 win everywhere
    b, s_prompt, n = 3, 11, 14
    h = torch.randn(b, n, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(1)) + 2.0
    got, _ = reference._moe(p, h, cfg, s_prompt, 1.25, reference.Prec())
    spec = moe_mod.MoESpec(n_experts=8, top_k=2, d_ff=32, impl="dense")
    want = torch.empty_like(h)
    want[:, :s_prompt] = moe_mod.moe_dense(p, h[:, :s_prompt], spec)[0]
    for i in range(s_prompt, n):
        want[:, i:i + 1] = moe_mod.moe_dense(p, h[:, i:i + 1], spec)[0]
    assert torch.allclose(got, want, atol=1e-5)
    # the prompt's call of 33 tokens has capacity 8: most pairs dropped
    assert (want[:, :s_prompt].abs().sum(-1) == 0).any()
