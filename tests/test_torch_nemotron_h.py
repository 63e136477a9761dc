"""nemotron-3-nano-30b-a3b (nemotron_h) on the port, held to its plain
reference `src/plain_ref/nemotron_h.py` (float32, no cache, no kernel).

On the CPU, at `REDUCED` size with seeded weights, on both MoE routes
(the one-hot oracle and the gather): the prefill's logits, and prefill
then decode through the cache against the reference's full forward, at
logits; then the block kinds one at a time (the sigmoid router's choice
by biased and weight by unbiased score, the relu² experts and the shared
expert, the per-group gated norm, attention without positions), the
registry, and two repository checks: the benchmark's copy of the
reference is the reference byte for byte, and the benchmark runner's
window loop, end-to-end metrics and check are `fosbench/serve.py`'s
statement for statement (by their syntax trees; nothing of `fosbench`
is imported).

The `card` tests run the decode kernel at 16 q heads a kv head (two CTAs
of 8) against the plain version at head dim 128, and a replayed decode
step of the hybrid against eager steps, bit for bit; they skip without a
card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_nemotron_h.py -m card
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import pytest

from torch_cpu import torch  # noqa: E402

from plain_ref import nemotron_h as ref  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.launch.serve import (ServeRun, generate,  # noqa: E402
                                      serve_inputs)
from repro_torch.models import api, layers, mamba, moe, stack  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "nemotron-3-nano-30b-a3b"
B, S, NEW = 2, 40, 6
# the port and the reference compute the same fp32 function in another
# order of sums (batched products, the chunked scan's own chunk, the
# combine's index_add_): they agree to ~2e-7 of the logits' largest
# (measured), so 2e-5 of it leaves room for other seeds, while the TF32
# control moves them by ~3e-3 of it
REL = 2e-5


def _cfg(impl: str):
    cfg = configs.get(ARCH, reduced=True)
    return dataclasses.replace(
        cfg, param_dtype=torch.float32, compute_dtype=torch.float32,
        kv_dtype=torch.float32, moe=dataclasses.replace(cfg.moe, impl=impl))


def ref_cfg(cfg) -> dict:
    """The reference's config (the published config.json's keys) of a
    port config."""
    per = cfg.layer_pattern
    return {"hybrid_override_pattern": per * (cfg.n_layers // len(per)),
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "mamba_num_heads": cfg.ssm.n_heads,
            "mamba_head_dim": cfg.ssm.headdim, "n_groups": cfg.ssm.n_groups,
            "ssm_state_size": cfg.ssm.d_state,
            "n_routed_experts": cfg.moe.n_experts,
            "num_experts_per_tok": cfg.moe.top_k,
            "routed_scaling_factor": cfg.moe.routed_scale,
            "norm_eps": cfg.norm_eps, "vocab_size": cfg.vocab,
            "capacity_factor": cfg.moe.capacity_factor}


def _params(cfg, seed=0):
    return api.init_params(cfg, torch.Generator().manual_seed(seed))


def _prompt(cfg, seed=1):
    return torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= REL * float(want.abs().max()), err


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_prefill_logits_match_the_plain_reference(impl):
    cfg = _cfg(impl)
    params, prompt = _params(cfg), _prompt(cfg)
    with torch.inference_mode():
        _, logits = stack.build_prefill_fn(cfg, S + 1)(
            params, {"tokens": prompt})
        h = ref.final_hidden(params, ref_cfg(cfg), prompt, S)
        want = ref.logits(params, ref_cfg(cfg), h)[:, 0]
    _close(logits[:, :cfg.vocab], want)


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_prefill_then_decode_matches_the_full_forward(impl):
    """Every served position's logits (the prefill's, then each decode
    step's through the cache) against the reference's forward over the
    prompt and the served tokens fed back; the reference groups the
    expert layer's calls as the served path does (the prompt, then each
    step's B tokens), so the capacity drops the same pairs."""
    cfg = _cfg(impl)
    params, prompt = _params(cfg), _prompt(cfg)
    toks, logits, _, _ = generate(cfg, params, prompt, NEW)
    seq = torch.cat([prompt, toks[:, :-1]], dim=1)
    with torch.inference_mode():
        h = ref.final_hidden(params, ref_cfg(cfg), seq, S)
        want = ref.logits(params, ref_cfg(cfg), h)
    assert want.shape == (B, NEW, cfg.vocab)
    _close(logits[..., :cfg.vocab], want)
    # the control: the reference at TF32 fails the same tolerance
    with torch.inference_mode():
        hc = ref.final_hidden(params, ref_cfg(cfg), seq, S, ref.Prec("tf32"))
        ctl = ref.logits(params, ref_cfg(cfg), hc, ref.Prec("tf32"))
    with pytest.raises(AssertionError):
        _close(ctl, want)


def test_served_positions_after_a_tie_are_left_out(monkeypatch):
    """A served position whose expert choice the reference finds on a tie
    leaves out every later position of its row too (the served run may
    have gone the other way there, and the later positions read its K/V
    and SSM state), and no position of another row or before it."""
    cfg = _cfg("dense")
    params, prompt = _params(cfg), _prompt(cfg)
    real = ref._moe

    def one_tie(p, h, rc, prompt_len, cf, pr):
        y, _ = real(p, h, rc, prompt_len, cf, pr)
        near = torch.zeros(h.shape[:2], dtype=torch.bool)
        near[1, prompt_len + 2] = True          # row 1, served position 3
        return y, near
    monkeypatch.setattr(ref, "_moe", one_tie)
    seq = torch.cat([prompt, prompt[:, :NEW - 1]], dim=1)
    ties: dict = {}
    with torch.inference_mode():
        ref.final_hidden(params, ref_cfg(cfg), seq, S, ties=ties)
    want = torch.zeros((B, NEW), dtype=torch.bool)
    want[1, 3:] = True
    assert torch.equal(ties["served"], want)
    assert not ties["prefill"]


def _spec(**kw):
    return moe.MoESpec(n_experts=8, top_k=3, d_ff=16, router="sigmoid_bias",
                       routed_scale=2.5, expert_act="relu2", **kw)


def test_sigmoid_router_picks_by_biased_and_weights_by_unbiased_score():
    """A seeded case where the bias changes the choice: the chosen are the
    top k of score + bias, their weights the unbiased scores over their
    sum times the scale, and the top k of the scores alone differ."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(16, 32, generator=gen)
    p = {"w_router": torch.randn(32, 8, generator=gen) * 0.2,
         "router_bias": torch.randn(8, generator=gen) * 0.3}
    top_p, top_i, aux = moe.router_probs(p, x, _spec())
    scores = torch.sigmoid(x @ p["w_router"])
    want_i = torch.topk(scores + p["router_bias"], 3).indices
    assert torch.equal(top_i.sort(-1).values, want_i.sort(-1).values)
    unbiased = torch.topk(scores, 3).indices
    assert not torch.equal(top_i.sort(-1).values, unbiased.sort(-1).values)
    w = scores.gather(1, top_i)
    torch.testing.assert_close(top_p, 2.5 * w / w.sum(-1, keepdim=True),
                               rtol=1e-6, atol=1e-7)
    assert float(aux) == 0.0


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_relu2_experts_and_the_shared_expert(impl):
    """The layer (capacity past every pair) is, token by token, the sum of
    its chosen experts' W2 relu(W1 x)^2 by their weights, plus the shared
    expert's."""
    spec = _spec(impl=impl, capacity_factor=8.0, shared_d_ff=24)
    gen = torch.Generator().manual_seed(4)
    d = 32
    p = {"w_router": torch.randn(d, 8, generator=gen) * 0.2,
         "router_bias": torch.randn(8, generator=gen) * 0.1,
         "w1": torch.randn(8, d, 16, generator=gen) * 0.2,
         "w2": torch.randn(8, 16, d, generator=gen) * 0.2,
         "shared_w1": torch.randn(d, 24, generator=gen) * 0.2,
         "shared_w2": torch.randn(24, d, generator=gen) * 0.2}
    x = torch.randn(2, 5, d, generator=gen)
    y, _ = moe.moe_ffn(p, x, spec)
    xt = x.reshape(-1, d)
    top_p, top_i, _ = moe.router_probs(p, xt, spec)
    want = torch.relu(xt @ p["shared_w1"]).square() @ p["shared_w2"]
    for t in range(xt.shape[0]):
        for w, e in zip(top_p[t], top_i[t]):
            want[t] += w * (torch.relu(xt[t] @ p["w1"][e]).square()
                            @ p["w2"][e])
    torch.testing.assert_close(y.reshape(-1, d), want, rtol=1e-5, atol=1e-6)


def test_gated_norm_is_per_group(monkeypatch):
    """The Mamba2 block with 4 groups matches the reference's, whose gated
    norm normalises each group of d_inner / 4 channels; the same block
    with the norm over all of d_inner does not."""
    cfg = _cfg("ep")
    assert cfg.ssm.n_groups == 4
    params = _params(cfg)["blocks"]["sub0"]
    sub = {k: v[0] for k, v in params["mamba"].items()}
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(5))
    want = ref._mamba(sub, x, ref_cfg(cfg), ref.Prec())
    got, _ = mamba.mamba_block(sub, x, cfg.mamba_spec)
    _close(got, want)

    def whole(y, weight, n_groups, eps):
        return layers.rms_norm(y, weight, eps)
    monkeypatch.setattr(mamba, "_rms_norm_grouped", whole)
    got, _ = mamba.mamba_block(sub, x, cfg.mamba_spec)
    with pytest.raises(AssertionError):
        _close(got, want)


def test_attention_has_no_positions():
    """NoPE: the block's attention is the reference's, and the same at
    other positions; with rotary embedding it would not be."""
    cfg = _cfg("ep")
    assert not cfg.attn_spec.use_rope
    sub = _params(cfg)["blocks"]["sub3"]["attn"]
    p = {k: v[0] for k, v in sub.items()}
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    pos = torch.arange(24)
    got, _ = layers.attention(p, x, cfg.attn_spec, pos)
    _close(got, ref._attention(p, x, ref_cfg(cfg), ref.Prec()))
    moved, _ = layers.attention(p, x, cfg.attn_spec, pos + 7)
    assert torch.equal(got, moved)
    roped = dataclasses.replace(cfg.attn_spec, use_rope=True)
    assert not torch.allclose(layers.attention(p, x, roped, pos + 7)[0], got)


def test_the_registry_serves_it_beside_the_reference_ten():
    """`configs.get` resolves it (full and reduced) while `ARCH_IDS` stays
    the reference's ten; the full config is the published 52 blocks (23
    Mamba2, 23 MoE, 6 attention) and 31.58 B parameters."""
    assert len(configs.ARCH_IDS) == 10 and ARCH not in configs.ARCH_IDS
    assert ARCH in configs.PORT_ARCH_IDS
    full = configs.get(ARCH)
    n_groups, plan = full.layer_plan()
    assert n_groups == 1 and len(plan) == 52
    kinds = [m if m != "none" else f for m, f in plan]
    assert (kinds.count("mamba"), kinds.count("moe"),
            kinds.count("attn")) == (23, 23, 6)
    assert round(api.param_count(full) / 1e9, 2) == 31.58
    assert full.mamba_spec.d_inner == 4096 and full.norm_eps == 1e-5
    assert api.param_table(configs.get(ARCH, reduced=True))


def test_a_block_without_mixer_has_no_mixer_span_or_cache():
    """An E block opens `layer.moe` (and `moe.shared` inside it) and no
    mixer span; its sub-layer has no cache; every layer's span is
    there."""
    cfg = _cfg("ep")
    params, prompt = _params(cfg), _prompt(cfg)
    cache = stack.init_cache(cfg, B, S + 1, "cpu")
    assert sorted(cache) == ["sub0", "sub2", "sub3"]
    with spans.recorder(device=False) as rec:
        stack.build_prefill_fn(cfg, S + 1)(params, {"tokens": prompt})
    names = [r["name"] for r in rec["spans"]]
    n_g, _ = cfg.layer_plan()
    assert names.count("layer.ssm") == 2 * n_g
    assert names.count("layer.attn") == n_g
    assert names.count("layer.moe") == names.count("moe.shared") == 2 * n_g
    parent = {r["id"]: r["name"] for r in rec["spans"]}
    assert all(parent[r["parent"]] == "layer.moe" for r in rec["spans"]
               if r["name"] == "moe.shared")
    assert rec["counters"]["other"]["moe.pairs"] == 2 * n_g * B * S * 3


def test_the_benchmark_copy_of_the_reference_is_the_reference():
    assert (ROOT / "fosbench" / "reference_nemotron_h.py").read_bytes() \
        == (ROOT / "src" / "plain_ref" / "nemotron_h.py").read_bytes()


def _functions(path: Path) -> dict:
    tree = ast.parse(path.read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


class _Swap(ast.NodeTransformer):
    """The hybrid's names put back to `serve.py`'s: its sizes, weights and
    port config from `hybrid`."""

    def visit_Attribute(self, node):
        self.generic_visit(node)
        if isinstance(node.value, ast.Name) and node.value.id == "hybrid":
            if node.attr == "port_config":
                return ast.copy_location(ast.Name("port_config", node.ctx),
                                         node)
            node.value.id = {"dims": "counts", "make": "weights"}.get(
                node.attr, node.value.id)
        return node


def _statements(fn) -> list[tuple[str, str]]:
    """(what it sets or tests, its syntax tree) of each statement."""
    out = []
    for s in fn.body:
        head = (s.targets[0] if isinstance(s, ast.Assign)
                else getattr(s, "test", None))
        name = getattr(head, "id", None) or getattr(
            getattr(head, "elts", [None])[0], "id", "")
        out.append((name, ast.dump(_Swap().visit(s))))
    return out


def test_the_hybrid_runner_is_serve_py_statement_for_statement():
    """`fosbench/serve_hybrid.py`'s `_check` is `serve._check`, and its
    `_run`'s set-up, warm-up, window loop and end-to-end metrics are
    `serve._run`'s, apart from the hybrid's port config, sizes and
    weights (its traced part and its ctx add the recorded batch and the
    decode profile)."""
    serve = _functions(ROOT / "fosbench" / "serve.py")
    hyb = _functions(ROOT / "fosbench" / "serve_hybrid.py")
    assert ast.dump(hyb["_check"]) == ast.dump(serve["_check"])
    assert ast.dump(hyb["run"]) == ast.dump(serve["run"])
    a, b = _statements(hyb["_run"]), _statements(serve["_run"])
    assert [x for x, _ in a] == [y for y, _ in b]
    # the statements that differ: the traced part and what ctx holds
    diff = [x for (x, ta), (_, tb) in zip(a, b) if ta != tb]
    assert diff == ["profile", "trace", "ctx"], diff
    assert any(t.startswith("While(") for _, t in a)


@pytest.mark.parametrize("b,sms,want", [(4, 132, 8), (64, 132, 1),
                                         (33, 132, 1), (16, 132, 5)])
def test_split_count_at_16_q_heads_counts_two_ctas_a_kv_head(b, sms, want):
    """At G=16 a kv head's two CTAs of 8 q heads each take a cluster, so
    the split count sees twice the (batch, kv head) pairs; G <= 8 counts
    one cluster a pair as before."""
    assert da_ops.split_count(b, 2, sms, 16) == want
    assert da_ops.split_count(2 * b, 2, sms, 8) == want
    assert da_ops.split_count(b, 2, sms) == da_ops.split_count(b, 2, sms, 8)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stack.release_decode_graphs()
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_decode_kernel_at_16_q_heads_a_kv_head(dtype):
    """The cell's decode shape (B=4, 32 q heads on 2 kv heads of 128)
    against the plain version, over lengths that cross the split
    boundaries, and two kv heads of 16 q heads equal to the same heads
    run as G=8 launches of each half."""
    dev = _card()
    b, hkv, hq, hd, s = 4, 2, 32, 128, 530
    gen = torch.Generator(device=dev).manual_seed(16)
    q = torch.randn((b, hq, hd), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, s, hkv, hd), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    tol = ({"atol": 2e-5, "rtol": 2e-5} if dtype == torch.float32
           else {"atol": 2e-2, "rtol": 2e-2})
    for length in (1, 7, 64, 129, 333, 530):
        got = da_ops.decode_attention(q, k, v, length, scale=hd ** -0.5)
        plain = da_ops.decode_attention_plain(q, k, v, length,
                                              scale=hd ** -0.5)
        torch.testing.assert_close(got.float(), plain.float(), **tol)
        # each half of a kv head's 16 q heads as its own G=8 kv head
        q8 = q.view(b, hkv, 2, 8, hd).reshape(b, 2 * hkv * 8, hd)
        k8, v8 = (t.repeat_interleave(2, dim=2) for t in (k, v))
        half = da_ops.decode_attention(q8.contiguous(), k8, v8, length,
                                       scale=hd ** -0.5)
        assert torch.equal(got, half), length


@pytest.fixture
def _deterministic(monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.card
def test_card_replayed_hybrid_step_equals_eager_steps(_deterministic):
    """The hybrid's graphed decode step (one eager step, a capture, then
    replays; the G=16 kernel and the grouped SSM step inside it) gives
    every step's tokens and logits and the final cache of eager steps on
    a Python int, bit for bit."""
    dev = _card()
    cfg, params, prompt, extra = serve_inputs(
        ServeRun(arch=ARCH, batch=B, prompt_len=S, max_new_tokens=NEW,
                 device="cuda", attn_impl="pallas"), dev)
    assert cfg.n_heads // cfg.n_kv_heads == 16
    decode = stack.build_decode_fn(cfg)
    with torch.inference_mode(), spans.recorder(device=True) as rec:
        cache, logits = stack.build_prefill_fn(cfg, S + NEW)(
            params, {**extra, "tokens": prompt})
        twin = tree_mod.tree_map(lambda t: t.clone(), cache)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        for i in range(NEW - 1):
            cache, nxt, lg = decode(params, cache, tok, S + i)
            want = stack._decode_step(params, cfg, twin, tok, S + i)
            assert torch.equal(nxt, want[0]) and torch.equal(lg, want[1])
            tok = want[0][:, None]
    torch.cuda.synchronize(dev)
    assert all(torch.equal(x, y) for x, y in zip(tree_mod.leaves(cache),
                                                 tree_mod.leaves(twin)))
    counts = rec["counters"]["other"]
    assert counts["serve.decode_graph.captures"] == 1
    assert counts["serve.decode_graph.replays"] == NEW - 2


@pytest.mark.card
def test_card_generate_serves_the_hybrid_on_the_decode_graph():
    """Served through `generate`, the hybrid's decode steps run on the
    graph: a first call warms its shapes with one eager step, then
    captures and replays; a second call of the same shapes captures at
    once.  The recorded batches count it."""
    dev = _card()
    cfg, params, prompt, extra = serve_inputs(
        ServeRun(arch=ARCH, batch=B, prompt_len=S, max_new_tokens=NEW,
                 device="cuda", attn_impl="pallas"), dev)
    got = []
    for _ in range(2):
        with spans.recorder(device=True) as rec:
            toks, _, _, _ = generate(cfg, params, prompt, NEW, extra=extra)
        got.append(rec["counters"]["decode"])
        assert toks.shape == (B, NEW)
    assert got[0]["serve.decode_graph.captures"] == 1
    assert got[0]["serve.decode_graph.replays"] == NEW - 2
    assert got[1]["serve.decode_graph.captures"] == 1
    assert got[1]["serve.decode_graph.replays"] == NEW - 1
