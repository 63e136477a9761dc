"""Served generation of the hybrid configuration (nemotron-h): the closed
loop of `serve.py`, one client, batches back to back through the port's
`repro_torch.launch.serve.generate`, on the hybrid's own port config,
sizes and weights (`hybrid.py`), checked against its plain reference
(`reference_nemotron_h.py`, a byte-for-byte copy of
`src/plain_ref/nemotron_h.py`).

The window loop, the end-to-end metrics and the check are `serve._run`'s
and `serve._check`'s, statement for statement (a CPU test compares their
syntax trees); see `serve.py` for what they measure and compare.  One
difference lies in the reference: a decode position left out because its
own expert choice sat on a tie takes every later position of its row
with it, since the SSM state and the K/V carry a flipped choice on.  A
traced run adds, after the window, one batch recorded through the
program's spans (`spans.record`, `ctx["spans"]`), then two profiled
calls at the mix's middle prompt: the prefill (`ctx["profile"]`, whose
`busy_s` and breakdown the line carries) and the decode steps the
traffic's `profile["decode"]` names (`ctx["profile_decode"]`).
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from fosbench import hybrid, spans, traffic
from fosbench import reference_nemotron_h as reference
from fosbench.common import p95
from fosbench.serve import Batch, _Hooks, _picked, _profiled, _prompt


def run(cell: dict, cfg: dict, tr: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, log=print) -> dict:
    from repro_torch.launch.serve import generate
    from repro_torch.models import stack
    hooks = _Hooks(stack, device)
    try:
        return _run(cell, cfg, tr, seed, seconds, trace, device, t_start,
                    log, generate, hooks)
    finally:
        hooks.restore()


def _check(batches: list[Batch], cfg: dict, params: dict, seed: int,
           n_check: int, control: str | None = None) -> dict:
    """The reference over a sample of the batches: `gap`, `gap_sum`,
    `first_err` and `logit_err` of the program's served tokens and logits.
    With `control` (a reference.Prec kind) the same numbers of the
    reference computed in that precision put in the program's place: its
    gaps at the tokens it puts first, and its logits' difference."""
    vocab = cfg["vocab_size"]
    picked = _picked(batches, seed, n_check)
    gaps, errs, firsts, n_tie, n_pf = [], [], [], 0, 0
    for i in picked:
        bt = batches[i]
        seq = torch.cat([bt.prompt, bt.tokens[:, :-1]], dim=1)
        with torch.no_grad():
            ties: dict = {}
            h = reference.final_hidden(params, cfg, seq, bt.s, ties=ties)
            hc = (reference.final_hidden(params, cfg, seq, bt.s,
                                         reference.Prec(control))
                  if control else None)
            n_pf += ties["prefill"]
            for r in range(bt.b):
                ref = reference.logits(params, cfg, h[r])        # [T, V]
                if control:
                    got = reference.logits(params, cfg, hc[r],
                                           reference.Prec(control))
                    served, first = got.argmax(-1), got[0]
                else:
                    got = bt.kept_logits[:, :vocab].float()
                    served = bt.tokens[r].long()
                    first = bt.first_logits[r, :vocab].float()
                g = ref.max(-1).values - ref.gather(1, served[:, None])[:, 0]
                # the prefill's position, by every row's own logits
                dev = float((first - ref[0]).abs().max())
                firsts.append(dev / float(ref[0].square().mean().sqrt()))
                # where a choice of the prefill call sat on a tie, a gap the
                # logits' own difference explains is not the token's fault
                g0 = (g[:1] - 2 * dev).clamp(min=0) if ties["prefill"] \
                    else g[:1]
                keep = ~ties["served"][r, 1:]
                gaps.append(torch.cat([g0, g[1:][keep]]))
                n_tie += int((~keep).sum())
                if r == bt.kept_row:
                    rms = ref.square().mean().sqrt()
                    errs += ((got - ref).abs().max(-1).values
                             / rms).tolist()
                del ref, got
    g = torch.cat(gaps)
    return {"gap": float(g.max()), "gap_sum": float(g.sum()),
            "first_err": statistics.median(firsts),
            "first_err_max": max(firsts),
            "logit_err": statistics.median(errs),
            "logit_err_max": max(errs), "served_tokens": g.numel(),
            "near_ties": n_tie, "prefill_ties": n_pf, "batches": picked}


def _run(cell, cfg, tr, seed, seconds, trace, device, t_start, log,
         generate, hooks):
    pcfg = hybrid.port_config(cfg)
    m = hybrid.dims(cfg)
    params = hybrid.make(cfg, seed, device, pcfg.param_dtype)
    plan = traffic.lengths(tr["prompt_len"], seed)
    new = tr["new_tokens"]
    for s in (max(plan), min(plan)):        # warm up the mix's extremes
        generate(pcfg, params, _prompt(tr, m["vocab"], s, seed, -1, device),
                 tr.get("warmup_new_tokens", new))
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    batches: list[Batch] = []
    while time.perf_counter() - t0 < seconds:
        i = len(batches)
        s = plan[i % len(plan)]
        prompt = _prompt(tr, m["vocab"], s, seed, i, device)
        t_call = time.perf_counter()
        toks, logits, _, _ = generate(pcfg, params, prompt, new)
        t_done = time.perf_counter()
        pf, dc = hooks.prefill_end - t_call, t_done - hooks.prefill_end
        row = int(np.random.default_rng(traffic.sub_seed(seed, 3, i))
                  .integers(prompt.shape[0]))
        batches.append(Batch(s, prompt.shape[0], new, pf, dc, prompt, toks,
                             logits[:, 0].clone(), row, logits[row].clone()))
        del logits
    window_s = time.perf_counter() - t0
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    profile = profile_decode = records = None
    if trace:   # after the window: once run, the profiler slows the host
        # path of the rest of its process (~40% a decode step); the
        # recorded batch first, which the profiler has not slowed
        s_mid = sorted(plan)[len(plan) // 2]
        prompt = _prompt(tr, m["vocab"], s_mid, seed, -2, device)
        records = spans.record(generate, pcfg, params, prompt, new)
        profile = _profiled(generate, hooks, pcfg, params, prompt,
                            tr["profile"]["prefill"])
        profile_decode = _profiled(generate, hooks, pcfg, params, prompt,
                                   tr["profile"]["decode"])
    n_req = sum(bt.b for bt in batches)
    e2e = {"gen_tok_s": sum(bt.b * bt.new for bt in batches) / window_s,
           "ttft_p95_ms": p95([bt.prefill_s * 1e3 for bt in batches
                               for _ in range(bt.b)]),
           "setup_s": setup_s}
    ctx = {"model": m, "traffic": tr, "profile": profile,
           "batches": [{"s": bt.s, "b": bt.b, "new": bt.new,
                        "prefill_s": bt.prefill_s, "decode_s": bt.decode_s}
                       for bt in batches], "window_s": window_s,
           "spans": records, "profile_decode": profile_decode}
    log(f"[fosbench] {cell['name']}: {len(batches)} batches, {n_req} "
        f"requests in {window_s:.3f} s; set-up {setup_s:.3f} s",
        file=sys.stderr)
    return {"ctx": ctx, "e2e": e2e, "attempted": n_req, "failed": 0,
            "memory_peak_bytes": mem,
            "check": lambda control=None: _check(
                batches, cfg, params, seed, tr.get("check_batches", 1),
                control)}
