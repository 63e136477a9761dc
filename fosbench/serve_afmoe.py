"""Served generation of the afmoe configuration (Trinity-Mini): the closed
loop of `serve.py`, one client, batches back to back through the port's
`repro_torch.launch.serve.generate`, on the configuration's own port
config, sizes and weights (`afmoe.py`), checked against its plain
reference (`reference_afmoe.py`, a byte-for-byte copy of
`src/plain_ref/afmoe.py`).

The window loop, the end-to-end metrics and the check are
`serve_hybrid._run`'s and `serve_hybrid._check`'s (a CPU test compares
their syntax trees), with one addition: the program's expert choices in
each prefill are recorded (`_PrefillRoutes`), and the reference takes
them where its own choice of a prompt token sits within its tie margin.
In this model one flipped choice moves every later position: it moves
the prefill call's expert queues, so other tokens' drops, and each
sub-layer's output is normalised after it (the sandwich norms), so a
change to one token's K/V that near-uniform attention spreads thin over
thousands of keys comes back at full scale.  Left to itself, the
reference then departs from a sound program by ~1e-3 of the logits'
scale and an unflagged decode choice can flip later.  See `serve.py`
for what the check measures and compares, and `serve_hybrid.py` for the
rule that a decode position left out on a tie of its own expert choice
takes every later position of its row with it (here the K/V carry the
flipped choice on).  A traced run adds, after the window, one batch recorded through the
program's spans (`spans.record`, `ctx["spans"]`), then one profiled
prefill at the mix's middle prompt (`ctx["profile"]`, whose `busy_s` and
breakdown the line carries), with the windowed flash kernel's launches
in it under `launches["flash_window"]`.
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from fosbench import afmoe, spans, traffic
from fosbench import reference_afmoe as reference
from fosbench.common import p95
from fosbench.serve import Batch, _Hooks, _picked, _profiled, _prompt


def run(cell: dict, cfg: dict, tr: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, log=print) -> dict:
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe, stack
    hooks = _Hooks(stack, device)
    routes = _PrefillRoutes(moe, stack)
    try:
        return _run(cell, cfg, tr, seed, seconds, trace, device, t_start,
                    log, generate, hooks, routes)
    finally:
        routes.restore()
        hooks.restore()


class _PrefillRoutes:
    """The program's expert choices in each prefill: `moe.router_probs`
    wrapped, recording while a `stack.build_prefill_fn` function runs (a
    replayed decode step calls no Python), each MoE layer's top-k [T, k]
    kept on the device as uint8 (no synchronise); `take()` returns and
    clears those of the prefills since the last call."""

    def __init__(self, moe, stack):
        self.moe, self.stack = moe, stack
        self.orig = (moe.router_probs, stack.build_prefill_fn)
        self.on, self.calls = False, []
        moe.router_probs = self._router
        stack.build_prefill_fn = self._prefill

    def restore(self):
        self.moe.router_probs, self.stack.build_prefill_fn = self.orig

    def _router(self, params, x, spec):
        out = self.orig[0](params, x, spec)
        if self.on:
            self.calls.append(out[1].to(torch.uint8))
        return out

    def _prefill(self, cfg, *a, **kw):
        f = self.orig[1](cfg, *a, **kw)

        def wrapped(params, batch):
            self.on = True
            try:
                return f(params, batch)
            finally:
                self.on = False
        return wrapped

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def _check(batches: list[Batch], cfg: dict, params: dict, seed: int,
           n_check: int, control: str | None = None,
           pins: list | None = None) -> dict:
    """The reference over a sample of the batches: `gap`, `gap_sum`,
    `first_err` and `logit_err` of the program's served tokens and logits.
    With `control` (a reference.Prec kind) the same numbers of the
    reference computed in that precision put in the program's place: its
    gaps at the tokens it puts first, and its logits' difference.  The
    reference is pinned at its prompt tokens' near-ties to the program's
    prefill choices (`pins`, one list a batch), or to the control's own;
    `pinned` and `route_diff` count the prompt tokens taken so and those
    whose choice differs further from a tie."""
    vocab = cfg["vocab_size"]
    picked = _picked(batches, seed, n_check)
    gaps, errs, firsts, n_tie, n_pf = [], [], [], 0, 0
    n_pin = n_diff = 0
    for i in picked:
        bt = batches[i]
        seq = torch.cat([bt.prompt, bt.tokens[:, :-1]], dim=1)
        with torch.no_grad():
            ties: dict = {}
            own: list = []
            hc = (reference.final_hidden(params, cfg, seq, bt.s,
                                         reference.Prec(control), own=own)
                  if control else None)
            h = reference.final_hidden(params, cfg, seq, bt.s, ties=ties,
                                       routes=own if control else pins[i])
            n_pf += ties["prefill"]
            n_pin += ties["pinned"]
            n_diff += ties["route_diff"]
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
            "near_ties": n_tie, "prefill_ties": n_pf, "pinned": n_pin,
            "route_diff": n_diff, "batches": picked}


def _window_profiled(generate, hooks, pcfg, params, prompt, spec: dict):
    """`serve._profiled`'s prefill, with the windowed flash kernel's
    launches in it (none where the program's wrapper counts none)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    fa = fa_ops.flash_attention
    before = getattr(fa, "window_launches", 0)
    info = _profiled(generate, hooks, pcfg, params, prompt, spec)
    info.setdefault("launches", {})["flash_window"] = (
        getattr(fa, "window_launches", 0) - before)
    return info


def _run(cell, cfg, tr, seed, seconds, trace, device, t_start, log,
         generate, hooks, routes):
    pcfg = afmoe.port_config(cfg)
    m = afmoe.dims(cfg)
    params = afmoe.make(cfg, seed, device, pcfg.param_dtype)
    plan = traffic.lengths(tr["prompt_len"], seed)
    new = tr["new_tokens"]
    for s in (max(plan), min(plan)):        # warm up the mix's extremes
        generate(pcfg, params, _prompt(tr, m["vocab"], s, seed, -1, device),
                 tr.get("warmup_new_tokens", new))
    if device.type == "cuda":
        torch.cuda.synchronize()
    routes.take()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    batches: list[Batch] = []
    pins: list = []
    while time.perf_counter() - t0 < seconds:
        i = len(batches)
        s = plan[i % len(plan)]
        prompt = _prompt(tr, m["vocab"], s, seed, i, device)
        t_call = time.perf_counter()
        toks, logits, _, _ = generate(pcfg, params, prompt, new)
        t_done = time.perf_counter()
        pins.append(routes.take())
        pf, dc = hooks.prefill_end - t_call, t_done - hooks.prefill_end
        row = int(np.random.default_rng(traffic.sub_seed(seed, 3, i))
                  .integers(prompt.shape[0]))
        batches.append(Batch(s, prompt.shape[0], new, pf, dc, prompt, toks,
                             logits[:, 0].clone(), row, logits[row].clone()))
        del logits
    window_s = time.perf_counter() - t0
    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    profile = records = None
    if trace:   # after the window: once run, the profiler slows the host
        # path of the rest of its process (~40% a decode step); the
        # recorded batch first, which the profiler has not slowed
        s_mid = sorted(plan)[len(plan) // 2]
        prompt = _prompt(tr, m["vocab"], s_mid, seed, -2, device)
        records = spans.record(generate, pcfg, params, prompt, new)
        profile = _window_profiled(generate, hooks, pcfg, params, prompt,
                                   tr["profile"])
    n_req = sum(bt.b for bt in batches)
    e2e = {"gen_tok_s": sum(bt.b * bt.new for bt in batches) / window_s,
           "ttft_p95_ms": p95([bt.prefill_s * 1e3 for bt in batches
                               for _ in range(bt.b)]),
           "setup_s": setup_s}
    ctx = {"model": m, "traffic": tr, "profile": profile,
           "batches": [{"s": bt.s, "b": bt.b, "new": bt.new,
                        "prefill_s": bt.prefill_s, "decode_s": bt.decode_s}
                       for bt in batches], "window_s": window_s,
           "spans": records}
    log(f"[fosbench] {cell['name']}: {len(batches)} batches, {n_req} "
        f"requests in {window_s:.3f} s; set-up {setup_s:.3f} s",
        file=sys.stderr)
    return {"ctx": ctx, "e2e": e2e, "attempted": n_req, "failed": 0,
            "memory_peak_bytes": mem,
            "check": lambda control=None: _check(
                batches, cfg, params, seed, tr.get("check_batches", 1),
                control, pins)}
