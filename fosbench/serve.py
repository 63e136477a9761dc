"""Served generation: a closed loop of batches through the port's
`repro_torch.launch.serve.generate`, one client, batches back to back.

Set-up makes the weights from the seed on the card, builds the port's
config from the configuration file, and runs one warm-up batch at the
longest and one at the shortest prompt of the mix.  The window then runs
whole batches: one that starts before `seconds` have passed runs to its
end and its overrun counts.  `gen_tok_s` is every served token of the
window over the window; `ttft_p95_ms` the nearest-rank 95th percentile,
over every request, of its batch's time to first token: from the call of
`generate` to the prefill's logits on the device, on the benchmark's own
clock (a wrapper of the prefill function that synchronises where
`generate` does).

With `trace`, a profiled batch runs after the window (a few decode
steps, or one prefill, under torch.profiler: once it has run, the
profiler slows the host path of the rest of its process), and the
per-layer readers take the window's batches and that profile.

Correctness: after the window the program's logits are freed, and a
sample of the window's batches, drawn from the seed with the batch of the
longest prompt always in it, is run through the plain reference
(`reference.py`) over each prompt and its served tokens.  It reads by how
much each served token's reference logit lies below the reference's
best: `gap` the widest, `gap_sum` the sum.  A decode position whose own
expert choice the reference finds within a hair of a tie
(`reference.final_hidden`'s `ties`, counted as `near_ties`) is left out.
The prefill's position is held in every row: where some choice of the
prefill call sat on a tie, it counts only the part of its gap that the
row's own logits' difference from the reference does not explain (a
served token that is the program's own best lies at most twice that
difference below the reference's best).  `first_err` is the median over
the sampled rows of that difference, the largest over the vocabulary,
over the reference logits' RMS; `logit_err`, over the served positions of
one kept request of each sampled batch, the median of the same quantity.
Each cell's limits file says which of them decide `correct` (PERF.md
gives the readings each limit was set from).
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
import time

import numpy as np
import torch

from fosbench import counts, reference, tracing, traffic, weights
from fosbench.common import p95


def port_config(cfg: dict):
    """The port's ModelConfig of a configuration file, served as its
    `served` section says."""
    from repro_torch.models import api
    served = cfg["served"]
    dt = getattr(torch, served["dtype"])
    m = counts.dims(cfg)
    common = dict(name=cfg["name"], n_layers=m["layers"], d_model=m["d"],
                  vocab=m["vocab"], d_ff=0, param_dtype=dt, compute_dtype=dt,
                  kv_dtype=dt)
    if m["family"] == "moe":
        return api.ModelConfig(
            family="moe", n_heads=m["hq"], n_kv_heads=m["hkv"],
            head_dim=m["hd"], qk_norm=True, rope_theta=cfg["rope_theta"],
            moe=api.MoEConfig(n_experts=m["experts"], top_k=m["top_k"],
                              d_ff=m["d_ff"],
                              capacity_factor=cfg["capacity_factor"],
                              impl=served["moe_impl"]),
            attn_impl=served["attn_impl"], ssd_impl="pallas", **common)
    return api.ModelConfig(
        family="ssm", n_heads=0, n_kv_heads=0, head_dim=0,
        ssm=api.SSMConfig(d_state=m["d_state"], headdim=m["headdim"],
                          expand=cfg["expand"], n_groups=m["groups"],
                          conv_kernel=m["conv"], chunk=m["chunk"]),
        attn_impl="pallas", ssd_impl=served["ssd_impl"], **common)


@dataclasses.dataclass
class Batch:
    s: int
    b: int
    new: int
    prefill_s: float            # from the call to the prefill's logits
    decode_s: float             # from there to generate's return
    prompt: torch.Tensor        # [B, S]
    tokens: torch.Tensor        # [B, new] served
    first_logits: torch.Tensor  # [B, V]: every row's prefill logits
    kept_row: int
    kept_logits: torch.Tensor   # [new, V] of the kept row


class _Hooks:
    """The port's `stack.build_prefill_fn` and `build_decode_fn`, wrapped
    for the whole run.  Each prefill ends with a device synchronise (which
    `generate` makes right after it anyway) and the host's clock then:
    `.prefill_end`.  `.spec`, while set, names the phase of one call that
    a profiler window covers: the prefill, or decode steps [first_step,
    first_step + steps) after a prompt of `spec["s"]` tokens."""

    def __init__(self, stack, device):
        self.stack, self.device = stack, device
        self.orig = (stack.build_prefill_fn, stack.build_decode_fn)
        self.prefill_end, self.spec = 0.0, None
        self.open_ = self.close = None
        stack.build_prefill_fn = self._prefill
        stack.build_decode_fn = self._decode

    def restore(self):
        self.stack.build_prefill_fn, self.stack.build_decode_fn = self.orig

    def _phase(self, name):
        return self.spec is not None and self.spec["phase"] == name

    def _prefill(self, cfg, *a, **kw):
        f = self.orig[0](cfg, *a, **kw)

        def wrapped(params, batch):
            if self._phase("prefill"):
                self.open_()
            out = f(params, batch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.prefill_end = time.perf_counter()
            if self._phase("prefill"):
                self.close()
            return out
        return wrapped

    def _decode(self, cfg, *a, **kw):
        f = self.orig[1](cfg, *a, **kw)

        def wrapped(params, cache, tokens, pos):
            sp = self.spec if self._phase("decode") else None
            step = pos - sp["s"] - sp["first_step"] if sp else -1
            if step == 0:
                self.open_()
            out = f(params, cache, tokens, pos)
            if sp and step == sp["steps"] - 1:
                self.close()
            return out
        return wrapped


def _prompt(tr: dict, vocab: int, s: int, seed: int, i: int, device):
    gen = torch.Generator(device=device).manual_seed(
        traffic.sub_seed(seed, 10, i))
    return torch.randint(0, vocab, (tr["batch"], s), generator=gen,
                         device=device, dtype=torch.int32)


def _profiled(generate, hooks, pcfg, params, prompt, spec: dict):
    """One generate call with the profiler open over `spec`'s phase:
    decode steps [first, first + steps), or the prefill."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    win = tracing.Window()
    s = prompt.shape[1]
    first, n = spec.get("first_step", 0), spec.get("steps", 0)
    info = {"phase": spec["phase"], "b": prompt.shape[0], "s": s,
            "positions": [s + first + i for i in range(n)]}

    def open_():
        info["launch0"] = (da_ops.decode_attention.launches,
                           ssd_ops.ssd.launches)
        win.start()

    def close():
        win.stop()
        info["launches"] = {
            "decode_attention": da_ops.decode_attention.launches
            - info["launch0"][0],
            "ssd_scan": ssd_ops.ssd.launches - info["launch0"][1]}

    hooks.open_, hooks.close = open_, close
    hooks.spec = {"first_step": first, "steps": n, **spec, "s": s}
    try:
        generate(pcfg, params, prompt,
                 first + n + 1 if spec["phase"] == "decode" else 1)
    finally:
        hooks.spec = None
    info.update(win.read())
    return info


def _picked(batches: list[Batch], seed: int, n_check: int) -> list[int]:
    """The sampled batches: the one of the longest prompt, then others
    drawn from the seed."""
    longest = max(range(len(batches)), key=lambda i: batches[i].s)
    rest = [i for i in range(len(batches)) if i != longest]
    rng = np.random.default_rng(traffic.sub_seed(seed, 4))
    return [longest] + [int(i) for i in rng.choice(
        rest, size=min(n_check - 1, len(rest)), replace=False)]


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


def _run(cell, cfg, tr, seed, seconds, trace, device, t_start, log,
         generate, hooks):
    pcfg = port_config(cfg)
    m = counts.dims(cfg)
    params = weights.make(cfg, seed, device, pcfg.param_dtype)
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
    profile = None
    if trace:   # after the window: once run, the profiler slows the host
        # path of the rest of its process (~40% a decode step)
        s_mid = sorted(plan)[len(plan) // 2]
        profile = _profiled(generate, hooks, pcfg, params,
                            _prompt(tr, m["vocab"], s_mid, seed, -2, device),
                            tr["profile"])
    n_req = sum(bt.b for bt in batches)
    e2e = {"gen_tok_s": sum(bt.b * bt.new for bt in batches) / window_s,
           "ttft_p95_ms": p95([bt.prefill_s * 1e3 for bt in batches
                               for _ in range(bt.b)]),
           "setup_s": setup_s}
    ctx = {"model": m, "traffic": tr, "profile": profile,
           "batches": [{"s": bt.s, "b": bt.b, "new": bt.new,
                        "prefill_s": bt.prefill_s, "decode_s": bt.decode_s}
                       for bt in batches], "window_s": window_s}
    log(f"[fosbench] {cell['name']}: {len(batches)} batches, {n_req} "
        f"requests in {window_s:.3f} s; set-up {setup_s:.3f} s",
        file=sys.stderr)
    return {"ctx": ctx, "e2e": e2e, "attempted": n_req, "failed": 0,
            "memory_peak_bytes": mem,
            "check": lambda control=None: _check(
                batches, cfg, params, seed, tr.get("check_batches", 1),
                control)}
