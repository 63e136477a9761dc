"""Serving driver: prefill + greedy batched decode on one device.

Mirrors `repro/launch/serve.py::serve`.  The multi-tenant `--daemon` mode
(the FOS runtime, ROADMAP A6-A8) is not part of this CLI yet.

    PYTHONPATH=src python -m repro_torch.launch.serve            # on cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import configs
from repro_torch.models import api, io, stack


@dataclasses.dataclass
class ServeRun:
    arch: str = "llama3.2-3b"
    reduced: bool = True
    batch: int = 4
    prompt_len: int = 32
    max_new_tokens: int = 32
    seed: int = 0
    device: str = "cuda"
    attn_impl: str = "pallas"       # "pallas": Hopper kernels | "xla": plain


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompt: torch.Tensor, max_new_tokens: int):
    """Prefill `prompt` [B, S], then decode greedily.

    Returns (tokens [B, T], logits [B, T, V], prefill_s, decode_s) with
    T = max_new_tokens: token t is the argmax of logits t, which come from
    the prefill (t = 0) and from decode steps 1..T-1.  Times are wall-clock
    seconds, each ended by a device synchronise.
    """
    device = prompt.device
    s = prompt.shape[1]
    prefill = stack.build_prefill_fn(cfg, max_len=s + max_new_tokens)
    decode = stack.build_decode_fn(cfg)
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        cache, logits = prefill(params, {"tokens": prompt})
        _sync(device)
        t_prefill = time.perf_counter() - t0

        tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
        out_tokens, out_logits = [tok[:, 0]], [logits]
        t0 = time.perf_counter()
        for i in range(max_new_tokens - 1):
            cache, nxt, logits = decode(params, cache, tok, s + i)
            tok = nxt[:, None]
            out_tokens.append(nxt)
            out_logits.append(logits)
        _sync(device)
        t_decode = time.perf_counter() - t0
    return (torch.stack(out_tokens, dim=1), torch.stack(out_logits, dim=1),
            t_prefill, t_decode)


def serve(run: ServeRun, log=print) -> dict:
    """Prefill a random prompt, then decode greedily.

    Params come from `api.init_params` seeded with `run.seed`, the prompt
    from `io.make_batch` seeded with `run.seed + 1`, both on `run.device`.
    Returns prefill_s, decode_tok_per_s and tokens [B, max_new_tokens]
    (numpy) as the reference does, plus the prompt and the logits the
    tokens were taken from (prefill's, then each decode step's), stacked
    [B, max_new_tokens, V] on the device.
    """
    device = api.resolve_device(run.device)
    cfg = configs.get(run.arch, reduced=run.reduced)
    cfg = dataclasses.replace(cfg, param_dtype=torch.float32,
                              compute_dtype=torch.float32,
                              kv_dtype=torch.float32,
                              attn_impl=run.attn_impl, ssd_impl="pallas")
    gen = torch.Generator(device=device)
    params = api.init_params(cfg, gen.manual_seed(run.seed))

    cell = io.smoke_cell("prefill", b=run.batch, s=run.prompt_len)
    batch = io.make_batch(cfg, cell, gen.manual_seed(run.seed + 1))

    tokens, logits, t_prefill, t_decode = generate(
        cfg, params, batch["tokens"], run.max_new_tokens)
    toks_per_s = (run.batch * (run.max_new_tokens - 1)) / max(t_decode, 1e-9)
    log(f"[serve] {run.arch} on {device} ({run.attn_impl}): prefill "
        f"{t_prefill * 1e3:.1f} ms, decode {toks_per_s:.1f} tok/s "
        f"(batch={run.batch})")
    return {"prefill_s": t_prefill, "decode_tok_per_s": toks_per_s,
            "tokens": tokens.cpu().numpy(), "prompt": batch["tokens"],
            "logits": logits}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=configs.ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    serve(ServeRun(arch=args.arch, batch=args.batch,
                   prompt_len=args.prompt_len,
                   max_new_tokens=args.max_new_tokens, device=args.device))


if __name__ == "__main__":
    main()
