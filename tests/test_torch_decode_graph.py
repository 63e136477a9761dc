"""The single-device decode step on a position held on the device, and its
CUDA graph (`models/stack.py::_DecodeGraph`).

On the CPU: for reduced qwen3-moe, mamba2, jamba, whisper and llama, on
both routes, the step `build_decode_fn` returns without a mesh (its
position a device tensor, the code a CUDA graph captures) equals the
step on a Python int bit for bit: the tokens, every step's logits and
every cache leaf; the cache row written by `index_copy_` is the one the
slice wrote; and what a call returns is not overwritten by the next.

The `card` tests replay the captured step against eager steps under
deterministic algorithms, count captures and replays (a cache at new
addresses is captured again; shapes the process has run are captured
without another eager step), and check the decode kernel's launch
counter and recorded runs; they skip without a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_graph.py -m card
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.launch.serve import (ServeRun, generate,  # noqa: E402
                                      serve_inputs)
from repro_torch.models import layers, stack  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "mamba2-780m", "jamba-v0.1-52b",
         "whisper-large-v3", "llama3.2-3b"]
B, S, NEW = 2, 12, 6
GRAPH = ("serve.decode_graph.captures", "serve.decode_graph.replays")


@pytest.fixture(autouse=True)
def _no_recorder_left():
    yield
    if spans.recording():
        spans.deactivate()


def _inputs(arch, impl, device):
    return serve_inputs(ServeRun(arch=arch, batch=B, prompt_len=S,
                                 max_new_tokens=NEW, device=device,
                                 attn_impl=impl), torch.device(device))


def _clone(tree):
    return tree_mod.tree_map(lambda t: t.clone(), tree)


def _equal_trees(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_mod.leaves(a),
                                                 tree_mod.leaves(b)))


def _two_ways(cfg, params, prompt, extra, decode, steps=NEW - 1):
    """From one prefill: `steps` steps of `decode` (pos an int) beside the
    eager step on a Python int (`stack._decode_step`), fed the same
    tokens.  Returns (a list of each step's (next_tok, logits) from each
    way, the two final caches); each pair returned by `decode` is kept as
    it came, so that a later call overwriting it would show."""
    cache, logits = stack.build_prefill_fn(cfg, S + NEW)(
        params, {**extra, "tokens": prompt})
    twin = _clone(cache)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    out = []
    for i in range(steps):
        cache, nxt, lg = decode(params, cache, tok, S + i)
        want = stack._decode_step(params, cfg, twin, tok, S + i)
        out.append(((nxt, lg), want, (nxt.clone(), lg.clone())))
        tok = want[0][:, None]
    return out, cache, twin


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("arch", ARCHS)
def test_device_position_step_equals_int_step(arch, impl):
    """Tokens, logits and cache of the device-position step are the int
    step's, bit for bit, and a later call leaves earlier outputs alone."""
    cfg, params, prompt, extra = _inputs(arch, impl, "cpu")
    with torch.inference_mode():
        out, cache, twin = _two_ways(cfg, params, prompt, extra,
                                     stack.build_decode_fn(cfg))
    for (nxt, lg), (nxt_i, lg_i), (nxt0, lg0) in out:
        assert torch.equal(nxt, nxt_i) and torch.equal(lg, lg_i)
        assert torch.equal(nxt, nxt0) and torch.equal(lg, lg0)
    assert _equal_trees(cache, twin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos,s", [(0, 1), (7, 1), (15, 1), (4, 3)])
def test_index_copy_writes_the_rows_the_slice_writes(pos, s, dtype):
    gen = torch.Generator().manual_seed(pos + s)
    cache = torch.randn((2, 16, 3, 8), generator=gen).to(dtype)
    new = torch.randn((2, s, 3, 8), generator=gen)
    by_slice, by_index = cache.clone(), cache.clone()
    layers._write_rows(by_slice, 0, new, pos)
    layers._write_rows(by_index, 0, new,
                       torch.tensor([pos], dtype=torch.int32))
    assert torch.equal(by_slice, by_index)
    assert not torch.equal(by_slice, cache)


def test_the_cpu_step_captures_nothing():
    """On the CPU the step runs eager: a recorded batch counts no capture
    and no replay, and no launch."""
    cfg, params, prompt, extra = _inputs("llama3.2-3b", "pallas", "cpu")
    before = da_ops.decode_attention.launches
    with spans.recorder(device=True) as rec:
        generate(cfg, params, prompt, NEW, extra=extra)
    assert da_ops.decode_attention.launches == before
    assert not any(name in c for c in rec["counters"].values()
                   for name in GRAPH)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _card():
    """The card, with no shape warmed up by an earlier test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stack.release_decode_graphs()
    return torch.device("cuda", 0)


@pytest.fixture
def _deterministic(monkeypatch):
    # cuBLAS needs its workspace fixed before its first call; the MoE
    # combine's index_add_ otherwise sums in the order its atomics land
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.card
@pytest.mark.parametrize("arch", ARCHS)
def test_card_replayed_steps_equal_eager_steps(arch, _deterministic):
    """Every step's tokens and logits, and the final cache, of the graph
    (one eager step, a capture, then replays) equal eager steps on a
    Python int, bit for bit; one capture serves every later step."""
    dev = _card()
    cfg, params, prompt, extra = _inputs(arch, "pallas", "cuda")
    decode = stack.build_decode_fn(cfg)
    with torch.inference_mode(), spans.recorder(device=True) as rec:
        out, cache, twin = _two_ways(cfg, params, prompt, extra, decode)
    torch.cuda.synchronize(dev)
    for (nxt, lg), (nxt_i, lg_i), (nxt0, lg0) in out:
        assert torch.equal(nxt, nxt_i) and torch.equal(lg, lg_i)
        assert torch.equal(nxt, nxt0) and torch.equal(lg, lg0)
    assert _equal_trees(cache, twin)
    counts = rec["counters"]["other"]
    assert counts[GRAPH[0]] == 1 and counts[GRAPH[1]] == NEW - 2


@pytest.mark.card
def test_card_new_cache_captures_again_and_counts_launches():
    """A cache at other addresses is captured again, with no eager step
    since its shapes have run, and so is a later decode function's (a
    later `generate` call's) first step; each replay advances the decode
    kernel's launch counter by the launches the graph holds, one an
    attention layer, and a profiled replay's device records of the kernel
    are as many as that advance."""
    from torch.profiler import ProfilerActivity, profile
    dev = _card()
    cfg, params, prompt, extra = _inputs("llama3.2-3b", "pallas", "cuda")
    decode = stack.build_decode_fn(cfg)
    with torch.inference_mode(), spans.recorder(device=True) as rec:
        cache, logits = stack.build_prefill_fn(cfg, S + NEW)(
            params, {**extra, "tokens": prompt})
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        per_call = []
        for i in range(5):
            if i == 2:
                cache = _clone(cache)       # new data pointers
            if i == 4:
                decode = stack.build_decode_fn(cfg)
            before = da_ops.decode_attention.launches
            cache, nxt, _ = decode(params, cache, tok, S + i)
            per_call.append(da_ops.decode_attention.launches - before)
            tok = nxt[:, None]
        torch.cuda.synchronize(dev)
        before = da_ops.decode_attention.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            decode(params, cache, tok, S + 5)           # a replay
            torch.cuda.synchronize(dev)
        counted = da_ops.decode_attention.launches - before
    counts = rec["counters"]["other"]
    # eager, capture + replay, capture + replay (new cache), replay,
    # capture + replay (new decode function), replay
    assert counts[GRAPH[0]] == 3 and counts[GRAPH[1]] == 5
    assert per_call == [cfg.n_layers] * 5
    records = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "decode_kernel" in e.name]
    assert len(records) == counted == cfg.n_layers


@pytest.mark.card
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-780m"])
def test_card_recorded_generate_resolves(arch):
    """Recorded batches resolve: the replays' step spans carry device
    times, the counters of captures and replays add up to the decode
    steps, and the layer spans come from the prefill and the first
    batch's one eager step; a second batch of the same shapes replays
    every step."""
    _card()
    cfg, params, prompt, extra = _inputs(arch, "pallas", "cuda")
    new = 10
    for first in (True, False):
        with spans.recorder(device=True) as rec:
            generate(cfg, params, prompt, new, extra=extra)
        counts = rec["counters"]["decode"]
        assert counts[GRAPH[0]] == 1
        assert counts[GRAPH[1]] == (new - 2 if first else new - 1)
        steps = [r for r in rec["spans"]
                 if r["name"] == "serve.decode_step"]
        assert len(steps) == new - 1 and all("d0" in r for r in steps)
        layer_steps = {r["step"] for r in rec["spans"]
                       if r["name"].startswith("layer.")}
        assert layer_steps == ({-1, 0} if first else {-1})
