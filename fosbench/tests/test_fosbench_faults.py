"""The comparison that decides `correct` fails a broken timed path, and
its control separates from sound runs.

Each fault drives the rest of a run (everything but the look for a card)
at the port's reduced sizes on the CPU with the timed path broken
underneath, then builds the result line against the cell's own limits:
a token altered where it is produced (the prefill's, or a whole
answer), the prefill's logits altered, and a decode step that returns
its state unchanged."""
import time

import pytest
import torch

from fosbench import common, run, serve
from fosbench.tests import tiny

SERVE = [("qwen3moe.decode", "qwen3-moe-30b-a3b-16l", "chat_b16"),
         ("mamba2.prefill", "mamba2-780m", "longdoc_b4"),
         ("qwen3moe.prefill", "qwen3-moe-30b-a3b-16l", "rag_b4")]


def _serve_line(cell, cfg_name, mix, seconds=0.6, width=None, new=None):
    cfg, tr = tiny.config(cfg_name), tiny.serve_traffic(mix)
    if width:       # logits nearer the served widths' scale
        cfg["hidden_size" if "hidden_size" in cfg else "d_model"] = width
    if new:
        tr["new_tokens"] = new
    out = serve.run(common.cell(cell), cfg, tr, 2**31 + 21, seconds, False,
                    torch.device("cpu"), time.perf_counter(),
                    log=lambda *a, **k: None)
    return run.result_line(common.cell(cell), out, False,
                           common.limits(cell), "cpu"), out


@pytest.mark.parametrize("cell,cfg_name,mix", SERVE)
def test_sound_run_is_correct(cell, cfg_name, mix):
    line, _ = _serve_line(cell, cfg_name, mix)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell,cfg_name,mix", SERVE)
def test_altered_token_fails(cell, cfg_name, mix, monkeypatch):
    import repro_torch.launch.serve as port_serve
    real = port_serve.generate

    def altered(cfg, params, prompt, new, *a, **k):
        toks, logits, pf, dc = real(cfg, params, prompt, new, *a, **k)
        toks = toks.clone()
        toks[0] = (toks[0] + 1) % cfg.vocab     # the first answer
        return toks, logits, pf, dc
    monkeypatch.setattr(port_serve, "generate", altered)
    line, _ = _serve_line(cell, cfg_name, mix)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell,cfg_name,mix", SERVE)
def test_altered_first_token_fails(cell, cfg_name, mix, monkeypatch):
    """Only the prefill's token of every row altered: the position whose
    gap a near tie in the prefill call lets its logits explain."""
    import repro_torch.launch.serve as port_serve
    real = port_serve.generate

    def altered(cfg, params, prompt, new, *a, **k):
        toks, logits, pf, dc = real(cfg, params, prompt, new, *a, **k)
        toks = toks.clone()
        toks[:, 0] = (toks[:, 0] + 1) % cfg.vocab
        return toks, logits, pf, dc
    monkeypatch.setattr(port_serve, "generate", altered)
    line, _ = _serve_line(cell, cfg_name, mix)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell,cfg_name,mix", SERVE)
def test_altered_prefill_logits_fail(cell, cfg_name, mix, monkeypatch):
    """The prefill's logits scaled, as a wrong final norm would: every
    served token stays the best, so only the logits can show it."""
    from repro_torch.models import stack
    real = stack.build_prefill_fn

    def build(cfg, *a, **k):
        f = real(cfg, *a, **k)

        def prefill(params, batch):
            cache, logits = f(params, batch)
            return cache, logits * 1.05
        return prefill
    monkeypatch.setattr(stack, "build_prefill_fn", build)
    line, _ = _serve_line(cell, cfg_name, mix)
    assert line["checks"]["gap_sum" if "gap_sum" in line["checks"]
                          else "gap"]["value"] <= 1e-5
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell,cfg_name,mix", SERVE[:2])
def test_stale_state_fails(cell, cfg_name, mix, monkeypatch):
    from repro_torch.models import stack
    real = stack.build_decode_fn

    def build(cfg, *a, **k):
        f = real(cfg, *a, **k)

        def step(params, cache, tokens, pos):
            scratch = {n: {k: v.clone() for k, v in sub.items()}
                       for n, sub in cache.items()}
            _, nxt, logits = f(params, scratch, tokens, pos)
            return cache, nxt, logits       # the state left as it was
        return step
    monkeypatch.setattr(stack, "build_decode_fn", build)
    # a stale cache shows over many steps: 24 served tokens a request
    line, _ = _serve_line(cell, cfg_name, mix, width=256, new=24)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell,cfg_name,mix", SERVE[:2])
def test_control_separates(cell, cfg_name, mix):
    """The reference in TF32 in the program's place reads at least three
    times what the program does."""
    _, out = _serve_line(cell, cfg_name, mix)
    sound, ctrl = out["check"](), out["check"]("tf32")
    assert ctrl["logit_err"] >= 3 * sound["logit_err"]
    assert ctrl["logit_err"] > 0
    assert ctrl["gap_sum"] >= sound["gap_sum"]
    assert ctrl["first_err"] >= 3 * sound["first_err"]
    assert ctrl["first_err"] > 0
