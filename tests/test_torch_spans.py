"""The served path's spans and counters (`repro_torch.obs.spans`).

On the CPU: the recorder is off by default and then records nothing;
active, it nests spans and numbers their batches and steps, holds its
ring buffer's bound, keeps counters per phase, puts device events on the
host's clock, and `generate` on reduced qwen3-moe and mamba2 emits the
documented span tree without changing a token or a logit.  The `card`
test holds the spans to torch.profiler's trace and counts synchronises
on the card; it skips without one:

    PYTHONPATH=src python -m pytest -q tests/test_torch_spans.py -m card
"""
from __future__ import annotations

import collections
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import (ServeRun, generate, serve,  # noqa: E402
                                      serve_inputs)
from repro_torch.models import api, stack  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

ARCHS = ["qwen3-moe-30b-a3b", "mamba2-780m"]
B, S, NEW = 2, 8, 5
MIXER = {"attn": "layer.attn", "mamba": "layer.ssm"}
FFN = {"dense": "layer.mlp", "moe": "layer.moe"}
MOE_PARTS = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


@pytest.fixture(autouse=True)
def _no_recorder_left():
    yield
    if spans.recording():
        spans.deactivate()
        pytest.fail("the test left a recorder active")


def _inputs(arch):
    return serve_inputs(ServeRun(arch=arch, device="cpu", batch=B,
                                 prompt_len=S), torch.device("cpu"))


def test_off_span_is_the_shared_noop_and_nothing_is_recorded():
    assert not spans.recording()
    sp = spans.span("serve.decode_step", device=True, step=3, pos=9)
    assert sp is spans.NULL and spans.span("layer.moe") is spans.NULL
    with sp as entered:
        assert entered is spans.NULL
        spans.count("moe.pairs", 4)
        spans.count_device("moe.experts_hit", torch.count_nonzero,
                           torch.ones(2))
        spans.anchor(torch.device("cpu"))
        spans.resolve()
    assert not spans.recording()
    with pytest.raises(RuntimeError, match="no span recorder"):
        spans.deactivate()


def test_nesting_parents_batches_and_steps():
    with spans.recorder(device=False) as rec:
        for _ in range(2):
            with spans.span("serve.generate", b=2, s=8):
                with spans.span("serve.prefill", device=True):
                    with spans.span("layer.attn"):
                        pass
                for i in range(2):
                    with spans.span("serve.decode_step", step=i, pos=8 + i):
                        with spans.span("layer.moe"):
                            with spans.span("moe.route"):
                                pass
        with pytest.raises(RuntimeError, match="already active"):
            spans.activate()
    by_id = {r["id"]: r for r in rec["spans"]}
    assert len(by_id) == 2 * (3 + 2 * 3) and rec["dropped"] == 0
    for r in rec["spans"]:
        parent = by_id.get(r["parent"])
        assert r["t0"] <= r["t1"]
        assert "d0" not in r            # no device events on a host span
        if r["name"] == "serve.generate":
            assert parent is None and r["step"] == -1
            assert (r["b"], r["s"]) == (2, 8)
            continue
        assert parent["t0"] <= r["t0"] and r["t1"] <= parent["t1"]
        assert r["batch"] == parent["batch"]
        want = {"serve.prefill": "serve.generate",
                "serve.decode_step": "serve.generate",
                "layer.attn": "serve.prefill",
                "layer.moe": "serve.decode_step",
                "moe.route": "layer.moe"}[r["name"]]
        assert parent["name"] == want
        if r["name"] == "serve.decode_step":
            assert r["pos"] == 8 + r["step"]
        elif r["name"] != "serve.prefill":
            assert r["step"] == parent["step"]
    steps = [(r["batch"], r["step"]) for r in rec["spans"]
             if r["name"] == "serve.decode_step"]
    assert steps == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert {r["step"] for r in rec["spans"]
            if r["name"] in ("serve.prefill", "layer.attn")} == {-1}


def test_ring_buffer_keeps_its_bound_and_counts_dropped():
    with spans.recorder(device=False, max_events=4) as rec:
        for i in range(10):
            with spans.span("layer.mlp", step=i):
                pass
    assert [r["step"] for r in rec["spans"]] == [6, 7, 8, 9]
    assert rec["dropped"] == 6


def test_counters_are_kept_per_phase():
    with spans.recorder(device=False) as rec:
        spans.count("moe.pairs", 1)
        with spans.span("serve.generate"):
            with spans.span("serve.prefill"):
                spans.count("moe.pairs", 64)
                spans.count_device("moe.experts_hit", torch.count_nonzero,
                                   torch.ones(5))
            for i in range(3):
                with spans.span("serve.decode_step", step=i):
                    with spans.span("layer.moe"):
                        spans.count("moe.pairs", 16)
                        spans.count_device("moe.experts_hit",
                                           torch.count_nonzero,
                                           torch.ones(i + 1))
            spans.resolve()
    assert rec["counters"] == {
        "other": {"moe.pairs": 1},
        "prefill": {"moe.pairs": 64, "moe.experts_hit": 5},
        "decode": {"moe.pairs": 48, "moe.experts_hit": 6}}


class _Event:
    """A stand-in for a CUDA event recorded at a given device time (ms)."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_resolve_puts_device_events_on_the_hosts_clock(monkeypatch):
    monkeypatch.setattr(spans, "_POOL", [])
    rec = spans.Recorder(device=False, max_events=8)
    none = (None, None, None)
    rec.events += [_Event(1.0), _Event(1.5), _Event(0.5),
                   _Event(7.25), _Event(9.0), _Event(7.0)]
    rec.rows += [("a", 0, None, 0, -1, none, 0, 1, 0, 10**9),
                 ("b", 1, None, 0, 0, (2, None, 9), 2, 3, 3, 2 * 10**9),
                 ("c", 2, 1, 0, 0, none, 4, 5, None, None)]
    rec.resolve()
    first, second, host = (e.data for e in rec.tracer.events)
    assert (first["d0"], first["d1"]) == (10**9 + 500_000, 10**9 + 1_000_000)
    assert (second["d0"], second["d1"]) == (2 * 10**9 + 250_000,
                                            2 * 10**9 + 2_000_000)
    assert (second["b"], second["pos"]) == (2, 9) and "s" not in second
    assert first["parent"] is None and host["parent"] == 1
    assert "d0" not in host and "b" not in host
    assert not rec.rows and not rec.events
    assert len(spans._POOL) == 4        # the spans' events come back


class _Created(_Event):
    """A stand-in for a CUDA event that counts its records."""

    def __init__(self, **kw):
        super().__init__(0.0)
        self.streams = []

    def record(self, stream=None):
        self.streams.append(stream)


def test_reserve_fills_the_event_pool_before_a_batch(monkeypatch):
    monkeypatch.setattr(spans, "_POOL", [])
    monkeypatch.setattr(torch.cuda, "Event", _Created)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    cuda = torch.device("cuda", 0)
    spans.reserve(cuda, 3)                  # off: nothing
    with spans.recorder(device=False):
        spans.reserve(cuda, 3)              # no device events: nothing
        assert spans._POOL == []
        spans._REC.device = True
        spans.reserve(torch.device("cpu"), 3)
        assert spans._POOL == []
        spans.reserve(cuda, 5)
        # each created by a first record, on the device's current stream
        assert [ev.streams for ev in spans._POOL] == [["stream"]] * 5
        spans.reserve(cuda, 2)              # the pool already holds them
        assert len(spans._POOL) == 5
        spans._REC.event()                  # a span takes one
        assert len(spans._POOL) == 4


def _tree_checks(records, cfg, new):
    sp = records["spans"]
    by_id = {r["id"]: r for r in sp}
    names = collections.Counter(r["name"] for r in sp)
    (gen,) = [r for r in sp if r["name"] == "serve.generate"]
    (pre,) = [r for r in sp if r["name"] == "serve.prefill"]
    steps = [r for r in sp if r["name"] == "serve.decode_step"]
    assert gen["parent"] is None and pre["parent"] == gen["id"]
    assert [r["step"] for r in steps] == list(range(new - 1))
    assert all(r["parent"] == gen["id"] for r in steps)
    # one layer span a sub-layer's mixer and ffn, in every forward
    groups, plan = cfg.layer_plan()
    want = collections.Counter()
    for mixer, ffn in plan:
        want[MIXER[mixer]] += groups
        if ffn != "none":
            want[FFN[ffn]] += groups
    layers = [r for r in sp if r["name"].startswith("layer.")]
    per_parent = collections.defaultdict(collections.Counter)
    for r in layers:
        parent = by_id[r["parent"]]
        assert parent["name"] in ("serve.prefill", "serve.decode_step")
        assert r["step"] == parent["step"]
        per_parent[r["parent"]][r["name"]] += 1
    assert set(per_parent) == {pre["id"]} | {r["id"] for r in steps}
    assert all(c == want for c in per_parent.values())
    # the MoE layer's four parts, in order, under each layer.moe
    parts = collections.defaultdict(list)
    for r in sp:
        if r["name"].startswith("moe."):
            assert by_id[r["parent"]]["name"] == "layer.moe"
            parts[r["parent"]].append(r["name"])
    assert set(parts) == {r["id"] for r in layers
                          if r["name"] == "layer.moe"}
    assert all(p == MOE_PARTS for p in parts.values())
    assert all(r["batch"] == 0 for r in sp)
    return names


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_emits_the_span_tree(arch):
    cfg, params, prompt, _ = _inputs(arch)
    with spans.recorder(device=True) as rec:
        generate(cfg, params, prompt, NEW)
    names = _tree_checks(rec, cfg, NEW)
    assert rec["dropped"] == 0
    assert not any("d0" in r for r in rec["spans"])     # no CUDA here
    if cfg.moe is None:
        assert rec["counters"] == {} and "layer.moe" not in names
        return
    # counters: T*K pairs and every expert read, per MoE layer call
    groups, _ = cfg.layer_plan()
    for phase, tokens, calls in (("prefill", B * S, 1),
                                 ("decode", B, NEW - 1)):
        c = rec["counters"][phase]
        assert c["moe.pairs"] == tokens * cfg.moe.top_k * groups * calls
        assert c["moe.experts_read"] == cfg.moe.n_experts * groups * calls
        assert 0 < c["moe.experts_hit"] <= c["moe.experts_read"]
        assert 0 <= c["moe.pairs_dropped"] <= c["moe.pairs"]


@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_and_logits_are_bitwise_equal_with_the_recorder(arch):
    cfg, params, prompt, _ = _inputs(arch)
    off = generate(cfg, params, prompt, NEW)
    with spans.recorder(device=True):
        on = generate(cfg, params, prompt, NEW)
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])


def test_chrome_trace_has_host_and_device_lanes():
    records = {"spans": [
        {"name": "serve.decode_step", "id": 1, "parent": 0, "batch": 0,
         "step": 0, "pos": 8, "t0": 2_000, "t1": 9_000, "d0": 4_000,
         "d1": 12_000},
        {"name": "serve.generate", "id": 0, "parent": None, "batch": 0,
         "step": -1, "t0": 1_000, "t1": 10_000}],
        "counters": {"decode": {"moe.pairs": 3}}, "dropped": 2}
    doc = spans.chrome_trace(records)
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {(e["tid"], e["args"]["name"]) for e in meta} == {
        (0, "fos"), (0, "host"), (1, "device")}
    xs = [(e["name"], e["tid"], e["ts"], e["dur"]) for e in
          doc["traceEvents"] if e["ph"] == "X"]
    assert xs == [("serve.generate", 0, 0.0, 9.0),
                  ("serve.decode_step", 0, 1.0, 7.0),
                  ("serve.decode_step", 1, 3.0, 8.0)]
    assert doc["otherData"] == {"dropped_events": 2,
                                "counters": {"decode": {"moe.pairs": 3}}}


def test_serve_trace_out_writes_the_spans(tmp_path):
    path = tmp_path / "spans.json"
    out = serve(ServeRun(arch="qwen3-moe-30b-a3b", device="cpu", batch=B,
                         prompt_len=S, max_new_tokens=NEW,
                         trace_out=str(path)), log=lambda _: None)
    doc = json.loads(path.read_text())
    names = collections.Counter(e["name"] for e in doc["traceEvents"]
                                if e["ph"] == "X")
    assert names["serve.generate"] == 1 and names["serve.prefill"] == 1
    assert names["serve.decode_step"] == NEW - 1
    assert names["moe.experts"] == names["layer.moe"] > 0
    assert doc["otherData"]["counters"] == out["spans"]["counters"]
    assert not spans.recording()
    assert serve(ServeRun(device="cpu", batch=B, prompt_len=S,
                          max_new_tokens=2), log=lambda _: None)["spans"] \
        is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

PROGRAM = ("serve.", "layer.", "moe.")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _card_model(dev):
    """qwen3-moe-30b-a3b at its published widths, two layers, as the
    card serves it (fp32, the kernels, the gather route)."""
    cfg = configs.get("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(
        cfg, n_layers=2, param_dtype=torch.float32,
        compute_dtype=torch.float32, kv_dtype=torch.float32,
        attn_impl="pallas", ssd_impl="pallas",
        moe=dataclasses.replace(cfg.moe, impl="ep"))
    gen = torch.Generator(device=dev)
    params = api.init_params(cfg, gen.manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (16, 256), generator=gen,
                           device=dev, dtype=torch.int32)
    return cfg, params, prompt


def _enclosing(anns):
    """For each annotation (sorted by start, outer first), the index of
    the innermost other annotation around it, or None."""
    out = []
    for i, (a0, a1, _) in enumerate(anns):
        around = [j for j in range(i) if anns[j][0] <= a0
                  and a1 <= anns[j][1]]
        out.append(max(around) if around else None)
    return out


@pytest.mark.card
def test_card_spans_match_the_profiler_and_add_no_synchronise(
        tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile
    # deterministic algorithms (cuBLAS's needs its workspace fixed before
    # its first call): the MoE combine's index_add_ otherwise sums in the
    # order its atomics land, and two runs differ in the last bits
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda", 0)
    cfg, params, prompt, new = *_card_model(dev), 12
    generate(cfg, params, prompt, new)                  # build, warm up

    # the recorder adds no synchronise, and changes nothing served
    syncs = []
    real_sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (syncs.append(1), real_sync(*a, **k)))
    torch.use_deterministic_algorithms(True)
    try:
        off = generate(cfg, params, prompt, new)
        n_off = len(syncs)
        # the recorded call's first decode step runs eager (its shapes
        # forgotten), the rest are replays of the step's CUDA graph
        stack.release_decode_graphs()
        with spans.recorder(device=True) as rec:
            on = generate(cfg, params, prompt, new)
    finally:
        torch.use_deterministic_algorithms(False)
    assert len(syncs) == 2 * n_off and n_off > 0
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    assert all("d0" in r for r in rec["spans"] if r["name"].startswith(
        ("serve.prefill", "serve.decode_step", "layer.")))
    assert rec["counters"]["decode"]["moe.experts_hit"] > 0
    # a replay counts nothing inside the graph: the decode phase's device
    # counters come from the eager step alone
    decode = rec["counters"]["decode"]
    assert decode["serve.decode_graph.captures"] == 1
    assert decode["serve.decode_graph.replays"] == new - 2
    assert {r["step"] for r in rec["spans"]
            if r["name"].startswith("moe.")} == {-1, 0}
    monkeypatch.setattr(torch.cuda, "synchronize", real_sync)

    # under the profiler: each decode step starts with a spin kernel
    # (~50 ms, longer than the host takes to launch a step), so the device
    # stays behind the host and each step's events sit between its
    # kernels
    build = stack.build_decode_fn

    def held(*a, **kw):
        f = build(*a, **kw)

        def decode(params, cache, tokens, pos):
            torch.cuda._sleep(100_000_000)
            return f(params, cache, tokens, pos)
        return decode
    monkeypatch.setattr(stack, "build_decode_fn", held)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with spans.recorder(device=True) as rec:
            generate(cfg, params, prompt, new)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    anns = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith(PROGRAM)),
                  key=lambda a: (a[0], -a[1]))
    recs = sorted(rec["spans"], key=lambda r: r["id"])
    # every span's copy, in the same order and with the same nesting
    assert [a[2] for a in anns] == [r["name"] for r in recs]
    index = {r["id"]: i for i, r in enumerate(recs)}
    assert _enclosing(anns) == [index.get(r["parent"]) for r in recs]
    # each decode step's device time against the span of its kernels,
    # within 2% of the kernels' time besides the spin
    launched = {e["args"]["correlation"]: e["ts"] for e in xs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    # the served stream's records: the decode step's CUDA graph is
    # captured on a stream of its own, where the capture's prologue runs
    # two fills of the RNG's state that are no step's work
    served = {e["args"].get("stream") for e in xs if "spin" in e["name"]}
    device = [e for e in xs if e.get("cat") in DEVICE_CATS
              and e["args"].get("stream") in served]
    steps = [(a, r) for a, r in zip(anns, recs)
             if r["name"] == "serve.decode_step" and r["step"] > 0]
    assert len(steps) == new - 2
    pairs = []
    for (a0, a1, _), r in steps:
        ks = [e for e in device if a0 <= launched.get(
            e.get("args", {}).get("correlation"), -1) <= a1]
        span_us = max(e["ts"] + e["dur"] for e in ks) - min(
            e["ts"] for e in ks)
        (spin,) = [e["dur"] for e in ks if "spin" in e["name"]]
        pairs.append(((r["d1"] - r["d0"]) * 1e-3, span_us, spin))
    assert all(abs(got - want) <= 0.02 * (want - spin)
               for got, want, spin in pairs), pairs
