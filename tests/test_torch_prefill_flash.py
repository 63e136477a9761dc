"""The served prefill's attention on the flash kernel
(`models/layers.py::attention`, the branch with a cache and s > 1).

Under `attn_impl="pallas"` and without a mesh, a causal prefill sends
its attention over the fresh k/v through `fa_ops.flash_attention`, once
an attention layer, and counts it as `attn.prefill_flash`; under "xla"
it keeps `_sdpa` / `_chunked_sdpa`.  The prefill starts at cache row 0,
so both compute the same causal square.

On the CPU the wrapper runs its plain version: the two routes' prefill
logits agree within 1e-6 and their caches bit for bit, at GQA groups of
8 and 16 at hd=128, a NoPE layer, a layer with `attn_chunk` set, and on
every reduced architecture with causal self-attention.  The `card` tests
run one-layer prefills at qwen3-moe's (32 / 4 heads) and nemotron-h's
(32 / 2 heads, NoPE) widths at the benchmark cells' lengths, fp32, on
the kernel; they skip without a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_prefill_flash.py -m card
"""
from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.launch.serve import (ServeRun, generate,  # noqa: E402
                                      serve_inputs)
from repro_torch.models import api, stack  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

B, S, NEW = 2, 13, 3
COUNTER = "attn.prefill_flash"


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts the calls of `fa_ops.flash_attention` (on the CPU the
    wrapper runs its plain version and launches nothing)."""
    real, calls = fa_ops.flash_attention, []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(fa_ops, "flash_attention", counted)
    return calls


def _attn_layers(cfg) -> int:
    n_groups, plan = cfg.layer_plan()
    return n_groups * sum(1 for mixer, _ in plan if mixer == "attn")


def _dense(name, n_heads, n_kv_heads, head_dim=128, d_model=64, layers=2,
           vocab=256, **kw):
    """A dense fp32 model whose attention has the given heads."""
    return api.ModelConfig(
        name=name, family="dense", n_layers=layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv_heads, head_dim=head_dim,
        d_ff=2 * d_model, vocab=vocab, param_dtype=torch.float32,
        compute_dtype=torch.float32, kv_dtype=torch.float32, **kw)


# G = Hq / Hkv at hd = 128: qwen3-moe's 8 (qk-norm, rope), nemotron-h's 16
# (NoPE), and a q-block size that `_chunked_sdpa` would split the prompt
# by: its blocks sum in another order than the whole square, so a second
# layer's k/v would differ in the last bits, and that model has one layer
SPECS = {
    "g8": _dense("g8", 8, 1, qk_norm=True, rope_theta=1e6),
    "g16_nope": _dense("g16_nope", 16, 1, use_rope=False),
    "g8_attn_chunk": _dense("g8_attn_chunk", 8, 1, layers=1, attn_chunk=4),
}


def _prefill(cfg, params, prompt, extra, impl):
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    with torch.inference_mode():
        return stack.build_prefill_fn(cfg, S + NEW)(
            params, {**extra, "tokens": prompt})


def _routes_agree(cfg, params, prompt, extra, calls):
    """Prefill on both routes: the kernel route calls the wrapper once an
    attention layer and the plain route never; the logits agree within
    1e-6 and every cache leaf bit for bit."""
    cache_k, logits_k = _prefill(cfg, params, prompt, extra, "pallas")
    assert len(calls) == _attn_layers(cfg) > 0
    assert all(shape[1] == S for shape in calls)
    del calls[:]
    cache_p, logits_p = _prefill(cfg, params, prompt, extra, "xla")
    assert not calls
    torch.testing.assert_close(logits_k, logits_p, atol=1e-6, rtol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(tree_mod.leaves(cache_k),
                                                 tree_mod.leaves(cache_p)))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_prefill_routes_agree_at_model_heads(name, flash_calls):
    cfg = SPECS[name]
    params = api.init_params(cfg, torch.Generator().manual_seed(3))
    prompt = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(4))
    _routes_agree(cfg, params, prompt, {}, flash_calls)


@pytest.mark.parametrize("arch", [
    "qwen3-moe-30b-a3b", "nemotron-3-nano-30b-a3b", "llama3.2-3b",
    "jamba-v0.1-52b", "whisper-large-v3", "phi-3-vision-4.2b"])
def test_prefill_routes_agree_on_reduced_archs(arch, flash_calls):
    """Reduced configs as served (fp32; MoE layers on the gather route on
    both sides, so only the attention differs); whisper's encoder and
    cross attention stay plain on both."""
    cfg, params, prompt, extra = serve_inputs(
        ServeRun(arch=arch, batch=B, prompt_len=S, max_new_tokens=NEW,
                 device="cpu", attn_impl="pallas"), torch.device("cpu"))
    _routes_agree(cfg, params, prompt, extra, flash_calls)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_recorded_generate_counts_prefill_flash(impl, flash_calls):
    """`attn.prefill_flash` counts the prefill's kernel calls, in the
    prefill phase; decode steps add none."""
    cfg, params, prompt, extra = serve_inputs(
        ServeRun(arch="nemotron-3-nano-30b-a3b", batch=B, prompt_len=S,
                 max_new_tokens=NEW, device="cpu", attn_impl=impl),
        torch.device("cpu"))
    with spans.recorder(device=True) as rec:
        generate(cfg, params, prompt, NEW, extra=extra)
    want = _attn_layers(cfg) if impl == "pallas" else 0
    assert len(flash_calls) == want
    counts = {phase: c.get(COUNTER) for phase, c in rec["counters"].items()}
    assert counts.get("prefill") == (want or None)
    assert all(n is None for phase, n in counts.items() if phase != "prefill")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# one attention layer at the cells' widths: qwen3-moe-30b-a3b's (d_model
# 2048, 32 / 4 heads of 128, qk-norm, rope 1e6) and nemotron-h's (d_model
# 2688, 32 / 2 heads of 128, no rope)
CARD_MODELS = {
    "qwen3": dict(n_heads=32, n_kv_heads=4, d_model=2048, qk_norm=True,
                  rope_theta=1e6),
    "nemotron": dict(n_heads=32, n_kv_heads=2, d_model=2688, use_rope=False),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("s", [1000, 2304, 4096])
@pytest.mark.parametrize("model", sorted(CARD_MODELS))
def test_card_prefill_on_the_kernel(model, s):
    """B=4, fp32: the kernel route's last logits within 2e-5 (relative to
    the largest) of the plain route's, the caches equal bit for bit, and
    one launch of the kernel for the one attention layer."""
    dev = _card()
    cfg = _dense(model, layers=1, vocab=4096, **CARD_MODELS[model])
    gen = torch.Generator(device=dev)
    params = api.init_params(cfg, gen.manual_seed(5))
    prompt = torch.randint(0, cfg.vocab, (4, s), generator=gen.manual_seed(6),
                           device=dev, dtype=torch.int32)
    got = {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        before = fa_ops.flash_attention.launches
        with torch.inference_mode():
            cache, logits = stack.build_prefill_fn(c, s)(
                params, {"tokens": prompt})
        torch.cuda.synchronize()
        got[impl] = (cache, logits,
                     fa_ops.flash_attention.launches - before)
        del cache, logits
    (cache_k, logits_k, n_k), (cache_p, logits_p, n_p) = (got["pallas"],
                                                          got["xla"])
    assert (n_k, n_p) == (1, 0)
    rel = float((logits_k - logits_p).abs().max() / logits_p.abs().max())
    assert rel <= 2e-5, rel
    assert all(torch.equal(a, b) for a, b in zip(tree_mod.leaves(cache_k),
                                                 tree_mod.leaves(cache_p)))
