"""The span readers and `spans.py` on synthetic records and traces, and
on a recorded batch of the port at reduced sizes on the CPU.  Each reader
reports nothing where its records are absent, as on a program without
the recorder."""
import time

import pytest
import torch

from fosbench import common, serve, spans, weights
from fosbench.tests import tiny

READERS = ["token_gap_p95_ms", "host_step_ms.decode", "moe_share.decode",
           "moe_share.prefill", "moe_expert_use.decode",
           "moe_idle_share.decode"]
MS = 1_000_000          # nanoseconds


def _span(name, i, parent, step, t0, t1, d0=None, d1=None, batch=0):
    r = {"name": name, "id": i, "parent": parent, "batch": batch,
         "step": step, "t0": t0, "t1": t1}
    if d0 is not None:
        r.update(d0=d0, d1=d1)
    return r


def _records():
    """One batch: a prefill of 100 ms (MoE 60 ms of it on the device), then
    three decode steps issued in 30, 40, 50 ms whose device ends are 40,
    45 and 60 ms apart (MoE 20 of each 30 ms of device time)."""
    sp = [_span("serve.generate", 0, None, -1, 0, 400 * MS)]
    sp.append(_span("serve.prefill", 1, 0, -1, 0, 100 * MS, 0, 100 * MS))
    sp.append(_span("layer.moe", 2, 1, -1, 10 * MS, 70 * MS,
                    20 * MS, 80 * MS))
    ends, t, i = [140, 185, 245], 100, 3
    for step, (issue, end) in enumerate(zip([30, 40, 50], ends)):
        sp.append(_span("serve.decode_step", i, 0, step, t * MS,
                        (t + issue) * MS, (end - 30) * MS, end * MS))
        sp.append(_span("layer.moe", i + 1, i, step, t * MS, (t + 1) * MS,
                        (end - 25) * MS, (end - 5) * MS))
        t, i = t + issue, i + 2
    # an earlier batch the readers leave alone
    sp.insert(0, _span("serve.decode_step", 99, None, 0, 0, 10**12, 0,
                       10**12, batch=-1))
    return {"spans": sp, "dropped": 0, "counters": {
        "prefill": {"moe.experts_read": 256, "moe.experts_hit": 256},
        "decode": {"moe.experts_read": 768, "moe.experts_hit": 480,
                   "moe.pairs": 384, "moe.pairs_dropped": 0}}}


def _trace():
    """A profiled window of 100 us: two kernels and a copy, and the
    program's spans around them (see test_idle_by_span)."""
    def ann(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name,
                "ts": ts, "dur": dur}

    def dev(cat, ts, dur, corr):
        return {"ph": "X", "cat": cat, "name": cat, "ts": ts, "dur": dur,
                "args": {"correlation": corr}}

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 1, "args": {"correlation": corr}}
    return [ann("fosbench.window", 0, 100),
            ann("serve.decode_step", 0, 100), ann("layer.attn", 5, 25),
            ann("layer.moe", 30, 50), ann("moe.dispatch", 40, 15),
            dev("kernel", 10, 10, 1), launch(6, 1),
            dev("kernel", 50, 10, 2), launch(45, 2),
            dev("gpu_memcpy", 12, 3, 3), launch(2, 3),
            dev("kernel", 200, 5, 4), launch(150, 4)]


def _read(name, ctx):
    return common.reader(name)(ctx)


def test_readers_of_the_recorded_batch():
    ctx = {"spans": _records()}
    assert _read("token_gap_p95_ms", ctx) == 60.0
    assert _read("host_step_ms.decode", ctx) == 40.0
    assert _read("moe_share.decode", ctx) == pytest.approx(200 / 3)
    assert _read("moe_share.prefill", ctx) == pytest.approx(60.0)
    assert _read("moe_expert_use.decode", ctx) == 62.5


def test_idle_by_span():
    """Idle: [0, 10), [20, 50), [60, 100) (the copy lies inside a kernel):
    decode_step [0, 5) and [80, 100); attn [5, 10) and [20, 30); moe
    [30, 40) and [60, 80); its dispatch [40, 50)."""
    got = spans.idle_by_span(_trace())
    want = {"serve.decode_step": 25e-6, "layer.attn": 15e-6,
            "layer.moe": 30e-6, "moe.dispatch": 10e-6}
    assert got == pytest.approx(want)
    assert spans.moe_idle_share(got) == pytest.approx(50.0)
    ctx = {"profile": {"phase": "decode", "idle_by_span": got}}
    assert _read("moe_idle_share.decode", ctx) == pytest.approx(50.0)
    # time outside every program span is the host's
    outside = [e for e in _trace() if e["name"] != "serve.decode_step"]
    got = spans.idle_by_span(outside)
    assert got["host"] == pytest.approx(25e-6)
    assert sum(got.values()) == pytest.approx(80e-6)


@pytest.mark.parametrize("name", READERS)
def test_readers_report_nothing_without_records(name):
    """As on a program without the recorder: no `spans` (or None), no
    `idle_by_span`, an empty one, or a profile of the prefill."""
    for ctx in ({}, {"spans": None, "profile": None},
                {"spans": {"spans": [], "counters": {}, "dropped": 0}},
                {"profile": {"phase": "decode"}},
                {"profile": {"phase": "decode", "idle_by_span": {}}},
                {"profile": {"phase": "prefill", "idle_by_span": {"x": 1}}}):
        assert _read(name, ctx) is None, ctx


def test_trace_without_program_spans_reads_nothing():
    bare = [e for e in _trace() if not e["name"].startswith(spans.PROGRAM)]
    assert spans.idle_by_span(bare) == {}
    no_window = [e for e in _trace() if e["name"] != "fosbench.window"]
    assert spans.idle_by_span(no_window) == {}


def test_without_the_recorder_record_gives_none(monkeypatch):
    monkeypatch.setattr(spans, "_recorder", lambda: None)
    calls = []
    assert spans.record(lambda *a: calls.append(a), 1, 2) is None
    assert calls == []
    with spans.annotated():
        pass


def test_recorded_batch_of_the_port():
    """The port's reduced MoE model on the CPU: the host readers read,
    the device ones report nothing (no CUDA events there)."""
    from repro_torch.launch.serve import generate
    from repro_torch.obs import spans as program
    cfg = tiny.config("qwen3-moe-30b-a3b-16l")
    pcfg = serve.port_config(cfg)
    params = weights.make(cfg, 2**31 + 5, torch.device("cpu"),
                          pcfg.param_dtype)
    prompt = torch.randint(0, 256, (3, 20), dtype=torch.int32)
    t = time.perf_counter()
    rec = spans.record(generate, pcfg, params, prompt, 6)
    assert not program.recording()
    ctx = {"spans": rec}
    host = _read("host_step_ms.decode", ctx)
    assert 0 < host < (time.perf_counter() - t) * 1e3
    assert 0 < _read("moe_expert_use.decode", ctx) <= 100
    for name in ("token_gap_p95_ms", "moe_share.decode",
                 "moe_share.prefill"):
        assert _read(name, ctx) is None
    with spans.annotated():
        assert program.recording()
    assert not program.recording()
