#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check makes the exit code non-zero and keeps
the final `{"ok": true, ...}` line from printing:
  1. report the card (nvidia-smi name and power limit), turn TF32 off for
     matmuls and cuDNN, build the CUDA kernels from the sources (timed);
     fail on a register spill in a main-path instantiation; report the
     registers and CTAs an SM of the MHA decode instances (G=1 at hd=64
     and hd=96); check that no bf16 instance of the mma.sync flash kernel
     is built (bf16 has one route, the wgmma kernel); count the
     tensor-core instructions of the hd=128 and hd=96 flash kernels (and
     of the windowed fp32 one at hd=128) where the toolkit has cuobjdump:
     HMMA (mma.sync) in the fp32 ones, HGMMA (wgmma) in the bf16 ones;
  2. hold each kernel against its plain PyTorch version on the card: the
     reference test cases plus the full-width llama3.2-3b and mamba2-780m
     shapes, each in fp32 (tolerance 2e-5; SSD state 1e-4) and bf16 (2e-2;
     SSD state 5e-2); decode lengths whose split-KV shares run empty or
     ragged (1, 7, 9, 131, 1033 rows, the full cache, B=1); flash lengths
     below one mma tile and ragged against its tiles (S = 1, 7, 1000,
     1040), hd=16 at S=1024 and B=1 at full width, and inputs x3 (a
     peaky softmax) held against fp64 at twice fp32's own error; the
     full-width SSD shape also at the decay and step ranges of the model's
     init, at L=4096 (32 chunks of state passing), and continued from a
     carried state; decode at jamba's and qwen3-moe's groupings (32 q
     heads on 8 and on 4 kv heads) at lengths 1040 and 1, flash at both
     at S=1024, and the SSD at jamba's shape (128 heads, d_state 16) at
     its init's decay and step ranges; MHA at whisper's 20 heads of 64
     and phi-3-vision's 32 of 96: decode at lengths 1, 7, 131, 1040 and
     1056 and B=1 (hd=96), flash at S=1024, and at hd=96 also S = 1, 7,
     1000, 1040, B=1 and inputs x3 against fp64; decode at nemotron-h's
     grouping (32 q heads on 2 kv heads: two CTAs of 8 a kv head) in a
     4112-row cache at lengths 1, 131, 2305, 4097 and 4112 and B=1, and
     the SSD at its shape (64 heads, B and C in 8 groups of d_state 128)
     at L=1024 and 4096 and at its init's ranges; the bf16 flash kernel
     (wgmma) at every head dim (16, 32, 64, 96, 128) at lengths ragged
     against its 64-row tiles (77, 200, 1000; GQA and MHA), on q/k/v cut
     from one fused projection (strided views), and with inputs x3 against
     fp64 at twice the plain bf16 version's error; the grouped expert
     product (`expert_gemm`) at the expert layers of the qwen3moe.prefill
     and nemotronh.prefill cells in a B=4 prefill of S in CELL_PREFILL_S
     (capacities 720, 1280 / 544, 960), both products, on the counts of a
     real dispatch: the occupied rows within 1e-6 of torch.bmm's largest
     value (0 expected) and every row past a count an exact 0, written
     into memory that held NaN; the windowed fp32 flash kernel
     (`flash_window_kernel`, 32 q on 4 kv heads of 128: trinity-mini's)
     against the plain version with the band, one batch row and kv head
     at a time (WINDOW_CASES: the trinity.prefill cell's B=2, S 9088 and
     16384, W=2048; S below W, S and W off the 64-key tile, W = 1), and a
     window at least S long equal to the causal kernel bit for bit;
  3. serve llama3.2-3b at full width (B=4, 1024-token prompt, 32 new
     tokens, attn_impl="pallas"): the decode kernel must launch exactly
     28 layers x 31 steps = 868 times, the flash kernel 28 times (the
     prefill's attention, a layer) and no other kernel; a plain ("xla")
     rerun with the same weights, teacher-forced on the served tokens, must
     match every step's logits at atol = rtol = 1e-3 (fp32 over 28 layers,
     sums in another order);
  4. the llama3.2-3b cache-free forward at full width (B=4, S=1024):
     exactly 28 flash kernel launches, final hidden state within 1e-3 of
     the plain forward;
  5. serve mamba2-780m at full width (the same B, prompt and new tokens;
     serving runs the SSD kernel on the card): exactly 48 SSD-scan
     launches, all in prefill (the decode step is plain torch, as in the
     reference), no attention kernel, and every step's logits within 1e-3
     of the plain rerun;
  6. the mamba2-780m forward at full width: 48 SSD-scan launches, hidden
     state within 1e-3 of the plain forward;
  7. times with CUDA events (median of >= 20, after warm-up, L2 flushed
     before each run): each kernel, its plain version and one PyTorch call
     computing the same function where there is one (the `library_ms`
     yardstick, used nowhere in the port), their lower bounds on the card
     (the bytes over the memory rate, or the FLOP at the tensor-core rate
     of the inputs' type: 3xTF32 for fp32, bf16's own for bf16),
     each kernel's and each library call's device-only time (CUDA events
     around the call alone, enqueued behind a `torch.cuda._sleep` spin so
     the host's enqueue cost is hidden: `device_time`), how many device
     kernels one call enqueues (the kernel nodes of one call captured into
     a CUDA graph; checked against each wrapper's own: 1 flash, 1 decode,
     4 SSD, 1 grouped expert product), a check that no device time is
     under its bound, the grouped expert product at phase 2's shapes on a
     dispatch's counts (bound: fp32 FFMA over the FLOPs of the occupied
     rows; its tile waste, the rows its 64-row tiles compute over the
     occupied ones, apart), at full occupancy and at balanced counts (each
     expert the same share of its slots) against torch.bmm, with the
     computed share at which the two take the same time; the flash kernel
     also in bf16 at llama's and
     the lm-forward module's shapes (with the design's bound: P.V in two
     passes, 1.5x the FLOP), prefill and decode of both models, the
     llama3.2-3b forward on the flash kernel and with plain attention, and
     a torch.profiler breakdown;
  8. the FOS runtime on the card (run after phase 6; then 9, 10, 17, 11, 12
     and 7):
     (a) `serve_daemon` as the reference's (mandelbrot and sobel tenants on
     one slot and its stream): 14 chunks, every output equal to a direct
     `run_placement` on the card, the mandelbrot counts within 1% of
     pixels of the CPU's (the iteration is chaotic and the card rounds
     otherwise); (b) a deterministic preemption (8 low-priority chunks
     on a preemptive 1-slot shell, then a priority-5 request): >= 1
     preemption, every chunk once and right; (c) the contract run: admitted +
     degraded + rejected = 6, each rejected future raising
     AdmissionRejected; (d) the `lm-forward` module at the full width of
     llama3.2-3b (bf16 compute, as the reference config) through the
     daemon, 3 chunks: exactly 28 x (3 + 1 warm-up) = 112 flash kernel
     launches and no other kernel, one reconfiguration and two reuses, a
     second placement a cache hit, logits within 5e-2 relative L2 of the
     plain path on the same weights; then the chunk time of each zoo
     module on the card (CUDA events on the slot's stream, median of 5),
     a torch.profiler breakdown of one lm-forward and one mandelbrot
     chunk, and the relative L2 of the flash and of the plain bf16
     path's logits to an fp32 forward (attention too) of the same weights
     and tokens.  (a) writes the flight recorder's Chrome trace
     (`trace_out`), which must parse and count the daemon's 14 chunks and
     its preemptions; (b) runs with a recorder attached, whose counts must
     be the daemon's;
  9. jamba-v0.1-52b cut to one super-block (n_layers=8: 1 attention, 7
     mamba, 4 MoE and 4 dense FFN sub-layers; 13.27 B params, 53.1 GB in
     fp32) at full width, and
 10. qwen3-moe-30b-a3b cut to 16 of its 48 layers (10.59 B params) at full
     width: served as phases 3 and 5 (the kernel path, MoE layers on the
     gather route, the decode step's CUDA graph): exactly 31 decode, 1
     flash and 7 SSD launches (jamba) / 496 decode and 16 flash launches
     (qwen3-moe), and 3 grouped expert products a MoE sub-layer in the
     prefill (12 / 48; none in decode: a step's capacity is 8), and no
     other kernel; one recorded `generate` (B=4, 2 new tokens) at each
     of CELL_PREFILL_S: the prefill's grouped launches and its spans'
     counters `moe.pairs`, `moe.pairs_dropped`, `moe.slots` and
     `moe.rows_computed` (the shares of pairs dropped, of slots occupied
     and of slots computed), the decode step's rows computed all its
     slots; the same run with every decode step eager, its routes
     recorded, equal to it bit for bit (both under deterministic
     algorithms), and every step's logits within 1e-3 of a teacher-forced
     plain rerun (plain attention and SSD, the one-hot MoE oracle), with
     the (token, expert) routes that differ between the eager and the
     plain run printed per MoE sub-layer; the forward (1 flash
     and 7 SSD / 16 flash launches, 12 / 48 grouped expert products,
     hidden state within 1e-3); one MoE
     layer alone at T=4096 and T=4: the same experts and the same dropped
     pairs on both routes, outputs within 2e-5, aux within 1e-6; and their
     times (prefill, decode step, the MoE layer, a profile of one prefill
     naming router, dispatch, experts and combine).  Each frees its params
     before the next phase; every phase prints its wall time and
     max_memory_allocated.
 17. nemotron-3-nano-30b-a3b cut to its first 21 blocks (MEMEM*E three
     times: 9 Mamba2, 9 MoE with the sigmoid router, relu² experts and
     the shared expert, 3 attention at 16 q heads a kv head; 12.8 B
     params, 51.2 GB in fp32) at full width, run after 10: as phases 9
     and 10, with exactly 3 x 31 = 93 decode launches (the g=16 instance),
     3 flash launches (the prefill), 9 SSD launches (8 groups) and 2 x 9 =
     18 grouped expert products (relu²: two products) in the served run, 3
     flash, 9 SSD and 18 grouped products in the forward, and routes pinned at ties of the biased score (gap
     < SIGMOID_TIE_GAP); its stage profile names the shared expert.
 18. trinity-mini cut to its first 16 layers (ddeF eeeF eeeF eeeF: 12
     sliding-window layers, 2 of them dense, and 4 full ones, 14 MoE with
     the sigmoid router and a shared SwiGLU expert; 12.70 B params, 50.8
     GB in fp32) at full width, run after 17: as phase 17, with 16 x 31 =
     496 decode launches (the G=8 instance over the rings), 12
     `flash_window_kernel` and 4 causal flash launches (the prefill) and
     3 x 14 = 42 grouped expert products in the served run and in the
     forward; each recorded prefill at CELL_PREFILL_S (S=4096: the band
     narrower than the prefix) launches the windowed kernel 12 times and
     the causal one 4 times, the counts set to 0 just before it.
 11. whisper-large-v3 at full width and depth (32 encoder and 32 decoder
     layers, 1.607 B params, 6.43 GB in fp32; 1536 stub frames), and
 12. phi-3-vision-4.2b at full width and depth (32 layers, 3.822 B params,
     15.29 GB; 576 stub patches spliced over the prompt's first
     positions): served as phase 3 (exactly 32 x 31 = 992 decode
     launches and 32 flash launches, the decoder's self-attention in the
     prefill, no other kernel; cross attention and the encoder are plain,
     as the reference's), every step's logits within 1e-3 of a
     teacher-forced plain rerun; the forward (exactly 32 flash launches,
     hidden state within 1e-3); prefill and decode-step times and a
     profile of one prefill, whisper's naming its encoder's and its cross
     attention's shares.
 13. training (run after 12, before 7): (a) llama3.2-3b at full width and
     depth (3.21 B params, fp32 masters, bf16 compute) through
     `launch/train.py::train()`: B=2, S=512, 8 steps, lr 1e-3, warm-up 5;
     every loss finite, no kernel launched (training runs the plain
     routes, as the reference's), step 0 and the mean over the steps
     lower the loss of the batch each step took, and step 0's loss within
     2e-2 relative of an fp32-compute forward of the same weights; peak
     memory, step ms (CUDA events, median of steps 2-7), tokens/s, the
     share of the bf16 dense peak, and a torch.profiler breakdown of one
     step (matrix products, softmax, AdamW, the casts, the stacked
     gradients' assembly); (b) its full width cut to 2 layers (595 M
     params), fp32 compute, B=1, S=128, on the card and on the CPU from
     the same weights: one train step (loss and grad norm within 1e-5,
     every grad leaf within 1e-4 relative L2), the card's AdamW fed the
     CPU's grads (1e-6), `quantize_int8` bit for bit, remat "full" and
     "dots" (grads within 1e-6 of "none"'s, each one's peak), and a 7.1 GB
     checkpoint saved without blocking across an in-place step, restored
     bit for bit, its step's loss reproduced (1e-5), with write and read
     GB/s; (c) the driver's control flow on the card at the reduced
     configs: the reference's four test_train_* runs and assertions.
 14. distribution on the card (after 13, before 7), one spawned rank per
     GPU of the machine (NCCL; one rank on a one-GPU machine), world size,
     card and power limit printed: (a) llama3.2-3b at full width and depth
     served as `serve` serves it over several ranks (`serve_inputs`,
     `shard_inputs`, `generate(mesh, rules)`) on a (1, world)
     ("data", "model") mesh under the "serve" rules: on the kernel route
     exactly 868 decode launches on each rank and every step's logits
     within 1e-5 of phase 3's; on the plain route (the update-inside body
     over the sequence-sharded cache) within 1e-3 of the plain unsharded
     rerun; prefill and decode-step ms (CUDA events) of the unsharded and
     the sharded path in one process; (b) its full width cut to 2 layers,
     fp32 compute, B=1, S=128, under the "train" rules on a (world, 1)
     mesh: one sharded step against the unsharded step (loss and grad norm
     1e-5, every grad leaf 1e-4 relative L2), both steps' ms, a checkpoint
     saved under those placements and restored under the elastic flip, the
     next step's loss equal to the unflipped run's (1e-5); (c)
     qwen3-moe-30b-a3b at full width cut to 4 layers, the forward on the
     sharded `moe_ep` (128 / world experts a rank) against the one-device
     gather route: hidden state 2e-5, the same routes and dropped pairs,
     exactly 4 flash launches and no grouped expert product in the
     sharded forward, 4 flash and 12 grouped products in the one-device
     one (its capacity, 320, is above a row tile); (d) in this process, the `lm-forward` module
     at llama3.2-3b's full width through the daemon on a slot over every
     GPU (a replica and a stream on each, the rows split over them):
     exactly 28 x 4 x world flash launches and logits equal to phase 8
     (d)'s on its weights and tokens; (e) the mamba2-780m forward at full
     width and depth over the mesh: exactly 48 SSD launches, hidden state
     within 2e-5 of the one-device forward; (f) qwen3-moe-30b-a3b at full
     width cut to 4 layers served on the plain route (the MoE oracle,
     moe "dense", over the batch gathered from the batch ranks) as
     `serve` serves it over the ranks: every step's logits within 1e-5
     of the unsharded plain serve's, no kernel launched.
 15. the dry run against the card (after 14, before 7): (a) `python -m
     repro_torch.launch.dryrun --arch llama3.2-3b --shape all --mesh
     single` in a subprocess that sees no GPU (DRYRUN_TIMEOUT_S): exit 0,
     roofline terms for train_4k, prefill_32k and decode_32k on 256 fake
     ranks, the reference's skip record for long_500k; for train_4k the
     useful FLOPs (at least 0.40), the q and kv heads rank 0 computes
     attention with (2 and 1: `layers.head_split` over 16 "model"
     ranks) and its argument + temp GB; meanwhile (b)
     phase 13's train step (full width and depth, B=2, S=512, bf16
     compute, fp32 masters, unsharded) and (c) phase 3's prefill (B=4,
     1024 tokens, fp32, plain attention) are traced at world size 1 and
     run on the card: counted FLOPs within 2% of torch.profiler's
     products (`with_flops`), (b)'s predicted argument + temp bytes
     within 10% of `max_memory_allocated` over its steps, no kernel
     launched; step and prefill ms (CUDA events), achieved FLOP/s and
     the roofline terms at the H100's peaks are printed with the card.
 16. the port's examples on the card (after 15, before 7), each
     `repro_torch.examples.<name>.main(["--device", "cuda"])` with the
     checks of tests/test_torch_examples.py that hold on any device:
     `quickstart` (a finite training loss that falls, 16 served tokens,
     its serve on the decode kernel), `multi_tenant_serving` (the
     fabric line, each tenant's chunk count and output shape, erin's
     DEGRADE verdict and the recorder's admission counts; carol's
     `lm-forward` on the flash kernel), `fos_registry_tour` (the cache
     hits, the tile within 1% of pixels of the CPU's counts, the CPU's
     signature), `elastic_train` (one restart, one switch, every step),
     and `elastic_train --m100` (~100M params, B=4, S=256): steps/s,
     peak GB, restarts and switches.  Their launches are in the
     `kernels` line (`examples_launches`).
Each of phases 3-6 and 8-18 sets every launch count to 0 just before it
drives a path and reads the counts just after.  Phase 7 runs last, in a
fresh process (`python3 chip_smoke.py --times DIR`, the main paths'
launch counts passed in DIR): torch.profiler drops kernel records in a
process, more the longer it has run (`profiler_census` counts them after
every phase), and phase 7's breakdowns are read from it.  Phase 7 also times the decode kernel at jamba's,
qwen3-moe's, whisper's and phi-3-vision's heads and at nemotron-h's in
the nemotronh.prefill cell's cache (4112 rows, 2305 and 4097 valid), the
flash kernel at their forward shapes (and in bf16 at the lm-forward
module's, B=8, S=64; in fp32 at qwen3-moe's and nemotron-h's heads at the
benchmark cells' prefills, B=4, S=2304 and 4096) and the SSD kernel at
jamba's and nemotron-h's shapes, and (entry `flash_window`) the windowed
flash kernel at the trinity.prefill cell's shapes (B=2, S 9088 and 16384,
W=2048; bound: 3xTF32 over the band's FLOPs; library: SDPA with the band
as a boolean mask; its launches phase 18's).  Then the `kernels` JSON
line, the card line and the final line.

It imports nothing of jax or of the reference package `repro`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import zoo  # noqa: E402

# the lm-forward zoo module at full width, as a registry entrypoint
# ("chip_smoke:build_lm_forward_full")
build_lm_forward_full = functools.partial(zoo.build_lm_forward, reduced=False)

# H100 SXM, NVIDIA data sheet (dense): device-memory rate, the fp32 rate
# outside the tensor cores, and the TF32 and bf16 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# the fastest the card computes products at each input type's accuracy:
# fp32-accurate products as three TF32 tensor-core passes (3xTF32), bf16 at
# its tensor-core rate; every kernel's operations bound uses it
FLOP_PER_S = {torch.float32: TF32_FLOP_PER_S / 3,
              torch.bfloat16: BF16_FLOP_PER_S}

DEVICE = "cuda"
LLAMA, MAMBA = "llama3.2-3b", "mamba2-780m"
JAMBA, QWEN_MOE = "jamba-v0.1-52b", "qwen3-moe-30b-a3b"
WHISPER, PHI3V = "whisper-large-v3", "phi-3-vision-4.2b"
NEMOTRON = "nemotron-3-nano-30b-a3b"
TRINITY = "trinity-mini"
LAYERS = {LLAMA: 28, MAMBA: 48, WHISPER: 32, PHI3V: 32}
# full width in fp32 does not fit one 80 GB card, so these three are cut
# in depth, never in width: jamba to one super-block of 8 sub-layers
# (13.27 B params, every sub-layer kind of its plan), qwen3-moe to 16 of
# its 48 layers (10.59 B params), nemotron-h to its first 21 blocks
# (MEMEM*E three times: 9 Mamba2, 9 MoE, 3 attention; 12.8 B params), the
# depth the benchmark's nemotronh.prefill cell serves, trinity-mini to its
# first 16 (12 window and 4 full layers; 12.70 B params), the depth of its
# trinity.prefill cell
DEPTH_CUT = {JAMBA: 8, QWEN_MOE: 16, NEMOTRON: 21, TRINITY: 16}
BATCH, PROMPT, NEW = 4, 1024, 32
# the prefill lengths phase 7 times the flash kernel at for the benchmark's
# qwen3moe.prefill and nemotronh.prefill cells: a middle length of their
# mix and its longest, the p95 batch's
CELL_PREFILL_S = (2304, 4096)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}

# (b, s_cache, hq, hkv, hd, length): the reference's DECODE_CASES
# (tests/test_kernels.py), then the llama3.2-3b serving shapes, where 8 CTAs
# split each (batch, kv head): lengths 1, 7 and 9 leave splits empty, 131
# and 1033 make the last share ragged, 1056 fills the cache; B=1 has 8
# clusters only
DECODE_CASES = [
    (1, 512, 4, 4, 64, 512), (2, 1024, 8, 2, 64, 700),
    (1, 2048, 4, 1, 128, 1), (2, 512, 4, 2, 64, 512), (1, 640, 4, 4, 32, 300),
    (4, 1056, 24, 8, 128, 1), (4, 1056, 24, 8, 128, 7),
    (4, 1056, 24, 8, 128, 9), (4, 1056, 24, 8, 128, 131),
    (4, 1056, 24, 8, 128, 1025), (4, 1056, 24, 8, 128, 1033),
    (4, 1056, 24, 8, 128, 1056), (1, 1056, 24, 8, 128, 5),
    (1, 1056, 24, 8, 128, 1040),
    # jamba's grouping (32 q heads on 8 kv heads: g=4, the G=4 instance
    # full) and qwen3-moe's (32 on 4: g=8, the G=8 instance), served
    (4, 1056, 32, 8, 128, 1040), (4, 1056, 32, 8, 128, 1),
    (4, 1056, 32, 4, 128, 1040), (4, 1056, 32, 4, 128, 1),
    # MHA (g=1, the G=1 instance): whisper's 20 heads of 64, and
    # phi-3-vision's 32 of 96 (rows on 32 / 16 lanes, 8 of them idle) at
    # lengths that leave splits empty, ragged and full, and B=1
    (4, 1056, 20, 20, 64, 1040), (4, 1056, 20, 20, 64, 1),
    (4, 1056, 32, 32, 96, 1), (4, 1056, 32, 32, 96, 7),
    (4, 1056, 32, 32, 96, 131), (4, 1056, 32, 32, 96, 1040),
    (4, 1056, 32, 32, 96, 1056), (1, 1056, 32, 32, 96, 5),
    # nemotron-h's grouping (32 q heads on 2 kv heads: g=16, two CTAs of 8
    # a kv head) at the nemotronh.prefill cell's cache (prompts to 4096, 16
    # new tokens): lengths that leave splits empty and ragged, a mid-length
    # and a full prompt, the full cache, and B=1
    (4, 4112, 32, 2, 128, 1), (4, 4112, 32, 2, 128, 131),
    (4, 4112, 32, 2, 128, 2305), (4, 4112, 32, 2, 128, 4097),
    (4, 4112, 32, 2, 128, 4112), (1, 4112, 32, 2, 128, 1040),
]
# (b, sq, sk, hq, hkv, hd): the reference's FLASH_CASES, then the
# llama3.2-3b forward shape; then, at its head counts, S=1 and S=7 (fewer
# rows than one 16-row mma tile), S=1000 and S=1040 (ragged against the
# 64-row and 64-key tiles), hd=16 at S=1024, and B=1
FLASH_CASES = [
    (1, 128, 128, 4, 4, 64), (2, 256, 256, 8, 2, 64), (1, 384, 384, 4, 1, 32),
    (1, 200, 200, 4, 2, 64), (2, 128, 128, 4, 4, 128), (1, 512, 512, 2, 2, 16),
    (4, 1024, 1024, 24, 8, 128),
    (4, 1, 1, 24, 8, 128), (4, 7, 7, 24, 8, 128), (4, 1000, 1000, 24, 8, 128),
    (4, 1040, 1040, 24, 8, 128), (4, 1024, 1024, 24, 8, 16),
    (1, 1024, 1024, 24, 8, 128),
    # the jamba and qwen3-moe forwards' groupings
    (4, 1024, 1024, 32, 8, 128), (4, 1024, 1024, 32, 4, 128),
    # the whisper decoder's and phi-3-vision's forwards (MHA, hd 64 and
    # 96), and at hd 96: S = 1, 7, 1000, 1040 and B=1
    (4, 1024, 1024, 20, 20, 64), (4, 1024, 1024, 32, 32, 96),
    (4, 1, 1, 32, 32, 96), (4, 7, 7, 32, 32, 96),
    (4, 1000, 1000, 32, 32, 96), (4, 1040, 1040, 32, 32, 96),
    (1, 1024, 1024, 32, 32, 96),
]
# (b, s, window) of the windowed fp32 flash kernel at trinity-mini's heads
# (32 q on 4 kv of 128): the trinity.prefill cell's prefills, then S below
# W, S and W off the 64-key tile (the band's lower edge inside a tile),
# W = 1 (each query its own key) and W above S
WINDOW_HEADS = (32, 4, 128)
WINDOW_CASES = [(2, 9088, 2048), (2, 16384, 2048), (1, 2047, 2048),
                (1, 4096, 100), (1, 1000, 65), (1, 130, 64), (1, 65, 1),
                (1, 1, 1), (1, 200, 300)]
# inputs x3 against fp64: (hq, hkv, hd) of llama's and phi-3-vision's
# forwards
PEAKY_CASES = [(24, 8, 128), (32, 32, 96)]
# bf16 (the wgmma kernel) at every head dim: (b, s, hq, hkv) at lengths
# that are no multiple of its 64-row tiles and boxes, GQA and MHA; and
# (hq, hkv, hd) of q/k/v cut from one fused projection (strided views)
FLASH_BF16_RAGGED = [(2, 200, 8, 2), (1, 77, 4, 4), (3, 1000, 6, 3)]
FLASH_BF16_FUSED = [(24, 8, 128), (32, 32, 96), (4, 1, 64)]
# (b, L, h, p, g, n, chunk): the full-width mamba2-780m prefill shape,
# jamba's (128 heads, d_state 16) and nemotron-h's (64 heads, B and C in 8
# groups of d_state 128)
SSD_FULL = (4, 1024, 48, 64, 1, 128, 128)
SSD_JAMBA = (4, 1024, 128, 64, 1, 16, 128)
SSD_NEMOTRON = (4, 1024, 64, 64, 8, 128, 128)
# the reference's SSD_CASES, the reduced mamba2-780m shape, then the
# full-width prefill shape, a ragged L=1000 and L=4096 (32 chunks); then
# nemotron-h's at L=1024 and at the nemotronh.prefill cell's longest
# prompt, L=4096
SSD_CASES = [
    (1, 256, 2, 64, 1, 64, 64), (2, 128, 4, 32, 2, 16, 32),
    (1, 512, 2, 64, 1, 128, 128), (1, 128, 2, 64, 1, 16, 64),
    (2, 20, 8, 16, 1, 16, 16),
    SSD_FULL, (4, 1000, 48, 64, 1, 128, 128), (4, 4096, 48, 64, 1, 128, 128),
    SSD_NEMOTRON, (4, 4096, 64, 64, 8, 128, 128),
]
# the kernel instantiations the main paths run, as ptxas names them
# (mangled): decode at hd=128, g<=4 (llama, jamba), g<=8 (qwen3-moe, fp32
# and bf16) and g=16 as two CTAs of 8 (nemotron-h, fp32), and g=1 at hd=64
# (whisper) and hd=96 (phi-3-vision); SSD at P=64, N=128 (mamba2-780m,
# nemotron-h) and N=16 (jamba), with their C.B^T kernels;
# flash at hd=128, 64 and 96 in fp32 (mma.sync) and at hd=128 in bf16
# (wgmma; the lm-forward module's), and the windowed fp32 one at hd=128
# (trinity-mini's)
FLASH_MAIN = "flash_kernelIfLi128E"
FLASH_WINDOW = "flash_window_kernelIfLi128E"
FLASH_BF16 = "flash_wgmma_kernelILi128E"
DECODE_G1 = ("decode_kernelIfLi64ELi1E", "decode_kernelIfLi96ELi1E")
DECODE_G16 = "decode_kernelIfLi128ELi8ELi2E"
MAIN_PATH_INSTANCES = (
    "decode_kernelIfLi128ELi4E", "decode_kernelIfLi128ELi8ELi1E",
    "decode_kernelI13__nv_bfloat16Li128ELi8ELi1E", DECODE_G16, *DECODE_G1,
    "ssd_chunk_state_kernelIfLi64ELi128E",
    "ssd_chunk_scan_kernelIfLi64ELi128E", "ssd_cb_kernelIfLi128E",
    "ssd_chunk_state_kernelIfLi64ELi16E",
    "ssd_chunk_scan_kernelIfLi64ELi16E", "ssd_cb_kernelIfLi16E",
    "ssd_state_pass_kernel", FLASH_MAIN, "flash_kernelIfLi64E",
    "flash_kernelIfLi96E", FLASH_BF16, FLASH_WINDOW, "expert_gemm_kernel")
# the flash instances whose SASS must hold tensor-core instructions: HMMA
# (mma.sync) in the fp32 kernel, HGMMA (wgmma) in the bf16 one
FLASH_SASS = {FLASH_MAIN: "HMMA", "flash_kernelIfLi96E": "HMMA",
              FLASH_WINDOW: "HMMA", FLASH_BF16: "HGMMA",
              "flash_wgmma_kernelILi96E": "HGMMA"}
# the bf16 flash kernel's registers at launch, which its setmaxnreg moves
# assume (flash_attention.cu, Wg::kLaunchRegs: two CTAs of 256 threads an
# SM)
FLASH_BF16_REGS = 128
# y and final state, as the reference's test_ssd_kernel_matches_ref
SSD_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 5e-2)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def err_within(got, want, tol) -> tuple[float, bool]:
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool(torch.all(diff <= tol + tol * want.abs())) and \
        bool(torch.isfinite(got).all())
    return float(diff.max()), ok


class Smoke:
    def __init__(self):
        self.failures: list[str] = []
        self.results: dict = {}

    def check(self, name: str, ok: bool, detail: str = "") -> None:
        print(f"[{'ok' if ok else 'FAIL'}] {name} {detail}".rstrip(),
              flush=True)
        if not ok:
            self.failures.append(name)

    def phase(self, name: str, fn) -> None:
        """Run one phase; print its wall time, the most device memory it
        held, and what is still allocated once it has returned (its
        tensors freed)."""
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        try:
            fn()
        except Exception:  # a failed phase is reported, the rest still run
            traceback.print_exc()
            self.check(f"{name}: raised", False)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        self.results.setdefault("phases", {})[name] = {
            "wall_s": wall, "max_memory_allocated_gb": peak}
        print(f"   {name}: {wall:.1f} s, max_memory_allocated "
              f"{peak:.2f} GB, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
              f"still allocated", flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_setup(smoke: Smoke) -> None:
    from repro_torch.kernels import _build
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    libs = _build.build()
    smoke.results["build_s"] = time.perf_counter() - t0
    print(f"built {sorted(libs)} in {smoke.results['build_s']:.1f} s")
    main_path = []
    for name, lib in libs.items():
        log = lib.with_suffix(".log").read_text() \
            if lib.with_suffix(".log").exists() else ""
        kernels = _ptxas_kernels(log)
        regs = [k["registers"] for k in kernels]
        print(f"ptxas {name}: {len(kernels)} kernels, registers "
              f"{min(regs, default=0)}..{max(regs, default=0)}, "
              f"spill stores {max((k['spill'] for k in kernels), default=0)}"
              f" bytes")
        for k in kernels:
            if k["spill"]:
                print(f"   spills {k['spill']} bytes: {k['name']}")
            if any(m in k["name"] for m in MAIN_PATH_INSTANCES):
                main_path.append(k)
                print(f"   main path: {k['registers']} registers, "
                      f"{k['spill']} bytes spilled: {k['name']}")
    smoke.results["ptxas_main_path"] = main_path
    missing = [m for m in MAIN_PATH_INSTANCES
               if not any(m in k["name"] for k in main_path)]
    smoke.check("ptxas: main-path instantiations do not spill",
                not missing and not any(k["spill"] for k in main_path),
                f"{len(main_path)} kernels, not found: {missing or 'none'}")
    # the MHA decode instances (whisper, phi-3-vision): registers, and the
    # CTAs of 256 threads an SM that registers and shared memory allow
    for k in main_path:
        inst = next((m for m in DECODE_G1 if m in k["name"]), None)
        if inst:
            k["ctas_per_sm"] = _ctas_per_sm(k["registers"], k["smem"], 256)
            smoke.results.setdefault("decode_g1", {})[inst] = k
            print(f"   {inst}: {k['registers']} registers, {k['smem']} "
                  f"bytes shared, {k['ctas_per_sm']} CTAs an SM")
    # bf16 has one route, the wgmma kernel: no bf16 instance of the
    # mma.sync one is built, and the wgmma instances got the registers at
    # launch that their setmaxnreg moves assume
    flash = _ptxas_kernels(libs["flash_attention"].with_suffix(".log")
                           .read_text())
    old_bf16 = [k["name"] for k in flash
                if "flash_kernelI13__nv_bfloat16" in k["name"]]
    smoke.check("flash: no bf16 instance of the mma.sync kernel",
                not old_bf16, f"{old_bf16 or 'none'}")
    wgmma = {k["name"]: k["registers"] for k in flash
             if "flash_wgmma_kernel" in k["name"]}
    smoke.check(f"flash: the wgmma instances have {FLASH_BF16_REGS} "
                f"registers at launch",
                len(wgmma) == 5 and all(r == FLASH_BF16_REGS
                                        for r in wgmma.values()),
                f"{sorted(wgmma.values())}")
    # the flash kernels' products run on the tensor cores: HMMA in the
    # fp32 kernel's SASS, HGMMA in the bf16 one's
    sass = _sass(libs["flash_attention"])
    for inst, op in FLASH_SASS.items():
        if sass is None:
            print(f"sass {inst}: not read (no cuobjdump in the toolkit)")
            continue
        n = _sass_count(sass, inst, op)
        smoke.results.setdefault("sass_tensor_core", {})[inst] = {op: n}
        smoke.check(f"sass {inst}: {op} instructions", n > 0, str(n))


def _sass(lib: Path) -> str | None:
    """The SASS of a library; None where the toolkit has no cuobjdump."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def _sass_count(sass: str, kernel: str, op: str) -> int:
    """How many `op` instructions (HMMA: mma.sync, HGMMA: wgmma) the SASS of
    the kernel whose mangled name holds `kernel` has."""
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.search(rf"\b{op}\b", line):
            count += 1
    return count


def _ptxas_kernels(log: str) -> list[dict]:
    """Each entry function of a `-Xptxas -v` log, with its registers, spill
    stores and static shared memory."""
    kernels = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            kernels.append({"name": m.group(1), "registers": 0, "spill": 0,
                            "smem": 0})
        elif kernels and (m := re.search(r"(\d+) bytes spill stores", line)):
            kernels[-1]["spill"] = int(m.group(1))
        elif kernels and (m := re.search(r"Used (\d+) registers", line)):
            kernels[-1]["registers"] = int(m.group(1))
            if m := re.search(r"(\d+) bytes smem", line):
                kernels[-1]["smem"] = int(m.group(1))
    return kernels


def _ctas_per_sm(registers: int, smem: int, threads: int) -> int:
    """CTAs of `threads` threads that fit on one H100 SM: 65536 registers
    (allocated per warp in units of 256), 228 KB of shared memory (1 KB of
    it reserved per CTA), 2048 threads and 32 CTAs."""
    warps = threads // 32
    regs = warps * -(-registers * 32 // 256) * 256
    return min(65536 // max(regs, 1), 233472 // (smem + 1024),
               2048 // threads, 32)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def _attention_fp64(q, k, v):
    """Causal GQA attention computed in fp64: [B,S,Hq,hd] -> [B,S,Hq,hd]."""
    s, hq, hd = q.shape[1:]
    g = hq // k.shape[2]
    kr, vr = (t.double().repeat_interleave(g, dim=2) for t in (k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), kr) * hd ** -0.5
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr)


def _ssd_inputs(gen, b, l, h, p, g, n, dtype):
    """x, dt, a, B, C by the reference test's recipe: dt = softplus(z - 1),
    a = -exp(0.3 z)."""
    x = _randn(gen, (b, l, h, p), dtype)
    dt = torch.nn.functional.softplus(_randn(gen, (b, l, h), torch.float32)
                                      - 1.0)
    a = -torch.exp(_randn(gen, (h,), torch.float32) * 0.3)
    return (x, dt, a, _randn(gen, (b, l, g, n), dtype),
            _randn(gen, (b, l, g, n), dtype))


def _ssd_model_inputs(gen, b, l, h, p, g, n, dtype):
    """x, dt, a, B, C over the ranges of the model's own init (api.py:
    `a_log`, `dt_bias`): a from -1 to -16 and dt from 1e-3 to 1e-1 over the
    heads, so the slowest heads carry their state across whole chunks."""
    x = _randn(gen, (b, l, h, p), dtype)
    dt_bias = torch.log(torch.expm1(torch.logspace(-3, -1, h, device=DEVICE)))
    dt = torch.nn.functional.softplus(
        0.1 * _randn(gen, (b, l, h), torch.float32) + dt_bias)
    a = -torch.linspace(1.0, 16.0, h, device=DEVICE)
    return (x, dt, a, _randn(gen, (b, l, g, n), dtype),
            _randn(gen, (b, l, g, n), dtype))


def _check_ssd(smoke, name, got, want, dtype):
    (y, s), (y_want, s_want) = got, want
    tol_y, tol_s = SSD_TOL[dtype]
    err_y, ok_y = err_within(y, y_want, tol_y)
    err_s, ok_s = err_within(s, s_want, tol_s)
    smoke.check(name, ok_y and ok_s,
                f"max_abs_err y={err_y:.3g} state={err_s:.3g}")


def phase_kernels(smoke: Smoke) -> None:
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for b, s, hq, hkv, hd, length in DECODE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn(gen, (b, hq, hd), dtype)
            k = _randn(gen, (b, s, hkv, hd), dtype)
            v = _randn(gen, (b, s, hkv, hd), dtype)
            got = da.decode_attention(q, k, v, length, scale=hd ** -0.5)
            want = da.decode_attention_plain(q, k, v, length,
                                             scale=hd ** -0.5)
            torch.cuda.synchronize()
            err, ok = err_within(got, want, TOL[dtype])
            smoke.check(f"decode_attention b={b} s={s} hq={hq} hkv={hkv} "
                        f"hd={hd} length={length} {dtype}", ok,
                        f"max_abs_err={err:.3g}")
    for b, sq, sk, hq, hkv, hd in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn(gen, (b, sq, hq, hd), dtype)
            k = _randn(gen, (b, sk, hkv, hd), dtype)
            v = _randn(gen, (b, sk, hkv, hd), dtype)
            got = fa.flash_attention(q, k, v, causal=True)
            want = fa.flash_attention_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            err, ok = err_within(got, want, TOL[dtype])
            smoke.check(f"flash_attention b={b} sq={sq} sk={sk} hq={hq} "
                        f"hkv={hkv} hd={hd} {dtype}", ok,
                        f"max_abs_err={err:.3g}")
    # a peaky softmax: the full-width shapes with inputs x3 (scores x9),
    # where fp32 itself drifts from the exact result.  The kernel keeps
    # fp32's accuracy if its error against an fp64 computation is at most
    # twice the plain fp32 version's
    for hq, hkv, hd in PEAKY_CASES:
        q, k, v = (3 * _randn(gen, (4, 1024, h, hd), torch.float32)
                   for h in (hq, hkv, hkv))
        exact = _attention_fp64(q, k, v)
        err_kernel = float((fa.flash_attention(q, k, v, causal=True)
                            .double() - exact).abs().max())
        err_plain = float((fa.flash_attention_plain(q, k, v, causal=True)
                           .double() - exact).abs().max())
        smoke.check(f"flash_attention inputs x3 hq={hq} hkv={hkv} hd={hd} "
                    f"float32: error vs fp64 within 2x the plain fp32 "
                    f"version's", err_kernel <= 2 * err_plain,
                    f"kernel {err_kernel:.3g}, plain fp32 {err_plain:.3g}")
        del q, k, v, exact
    _flash_bf16_cases(smoke, gen)
    _flash_window_cases(smoke, gen)
    _expert_gemm_cases(smoke)
    for b, l, h, p, g, n, chunk in SSD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_inputs(gen, b, l, h, p, g, n, dtype)
            got = ssd.ssd(*args, chunk=chunk, impl="pallas")
            want = ssd.ssd(*args, chunk=chunk, impl="xla")
            torch.cuda.synchronize()
            _check_ssd(smoke, f"ssd_scan b={b} L={l} h={h} p={p} g={g} n={n} "
                       f"chunk={chunk} {dtype}", got, want, dtype)
    # the full-width shapes (mamba2-780m's, jamba's, nemotron-h's) at the
    # model's decay and step ranges, where the state is carried across
    # whole chunks
    for b, l, h, p, g, n, chunk in (SSD_FULL, SSD_JAMBA, SSD_NEMOTRON):
        for dtype in (torch.float32, torch.bfloat16):
            args = _ssd_model_inputs(gen, b, l, h, p, g, n, dtype)
            got = ssd.ssd(*args, chunk=chunk, impl="pallas")
            want = ssd.ssd(*args, chunk=chunk, impl="xla")
            torch.cuda.synchronize()
            _check_ssd(smoke, f"ssd_scan b={b} L={l} h={h} p={p} g={g} "
                       f"n={n} chunk={chunk} model ranges {dtype}", got,
                       want, dtype)
    # full-width continuation: 512 steps, then 512 more from the carried
    # state, against one 1024-step scan (tolerance as the reference's)
    b, l, h, p, g, n, chunk = SSD_FULL
    x, dt, a, bb, cc = _ssd_inputs(gen, b, l, h, p, g, n, torch.float32)
    y_full, s_full = ssd.ssd(x, dt, a, bb, cc, chunk=chunk, impl="xla")
    half = l // 2
    _, s1 = ssd.ssd(x[:, :half], dt[:, :half], a, bb[:, :half],
                    cc[:, :half], chunk=chunk, impl="pallas")
    y2, s2 = ssd.ssd(x[:, half:], dt[:, half:], a, bb[:, half:],
                     cc[:, half:], chunk=chunk, impl="pallas",
                     initial_state=s1)
    torch.cuda.synchronize()
    err_y, ok_y = err_within(y2, y_full[:, half:], 1e-4)
    err_s, ok_s = err_within(s2, s_full, 1e-4)
    smoke.check("ssd_scan continuation 512+512 vs 1024 (1e-4)", ok_y and ok_s,
                f"max_abs_err y={err_y:.3g} state={err_s:.3g}")


def _window_plain(q, k, v, window):
    """The plain version of the windowed kernel, one batch row and kv head
    at a time: its scores are [1, g, S, S] (B=2, S=16384 whole would take
    69 GB)."""
    from repro_torch.kernels.flash_attention import ops as fa
    g = q.shape[2] // k.shape[2]
    out = torch.empty_like(q)
    for b in range(q.shape[0]):
        for h in range(k.shape[2]):
            out[b:b + 1, :, h * g:(h + 1) * g] = fa.flash_attention_plain(
                q[b:b + 1, :, h * g:(h + 1) * g], k[b:b + 1, :, h:h + 1],
                v[b:b + 1, :, h:h + 1], window=window)
    return out


def _window_inputs(gen, b, s):
    hq, hkv, hd = WINDOW_HEADS
    return (_randn(gen, (b, s, hq, hd), torch.float32),
            _randn(gen, (b, s, hkv, hd), torch.float32),
            _randn(gen, (b, s, hkv, hd), torch.float32))


def _flash_window_cases(smoke, gen) -> None:
    """Phase 2's cases of the windowed fp32 flash kernel: WINDOW_CASES
    against the plain version with the band, and a window of S keys equal
    to the causal kernel bit for bit."""
    from repro_torch.kernels.flash_attention import ops as fa
    hq, hkv, hd = WINDOW_HEADS
    for b, s, w in WINDOW_CASES:
        q, k, v = _window_inputs(gen, b, s)
        got = fa.flash_attention(q, k, v, window=w)
        err, ok = err_within(got, _window_plain(q, k, v, w),
                             TOL[torch.float32])
        smoke.check(f"flash_window b={b} s={s} window={w} hq={hq} "
                    f"hkv={hkv} hd={hd} float32", ok,
                    f"max_abs_err={err:.3g}")
        del q, k, v, got
        torch.cuda.empty_cache()
    q, k, v = _window_inputs(gen, 2, 1000)
    smoke.check("flash_window: a window of S keys equals the causal "
                "kernel bit for bit (b=2 s=1000)",
                torch.equal(fa.flash_attention(q, k, v, window=1000),
                            fa.flash_attention(q, k, v)))


def _flash_bf16_cases(smoke, gen) -> None:
    """Phase 2's cases of the bf16 flash kernel beyond FLASH_CASES: every
    head dim at ragged lengths, strided views of a fused projection, and a
    peaky softmax against fp64."""
    from repro_torch.kernels.flash_attention import ops as fa
    bf = torch.bfloat16

    def check(what, q, k, v):
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err, ok = err_within(got, want, TOL[bf])
        smoke.check(f"flash_attention bf16 {what}", ok,
                    f"max_abs_err={err:.3g}")

    for hd in fa.HEAD_DIMS:
        for b, s, hq, hkv in FLASH_BF16_RAGGED:
            q = _randn(gen, (b, s, hq, hd), bf)
            k, v = (_randn(gen, (b, s, hkv, hd), bf) for _ in range(2))
            check(f"b={b} s={s} hq={hq} hkv={hkv} hd={hd}", q, k, v)
    for hq, hkv, hd in FLASH_BF16_FUSED:
        qkv = _randn(gen, (2, 200, (hq + 2 * hkv) * hd), bf)
        q, k, v = (t.unflatten(-1, (-1, hd)) for t in
                   qkv.split([hq * hd, hkv * hd, hkv * hd], dim=-1))
        check(f"strided views of one projection b=2 s=200 hq={hq} "
              f"hkv={hkv} hd={hd} (strides {q.stride()})", q, k, v)
    for hq, hkv, hd in PEAKY_CASES[:1]:
        q, k, v = ((3 * _randn(gen, (4, 1024, h, hd), torch.float32)).to(bf)
                   for h in (hq, hkv, hkv))
        exact = _attention_fp64(q, k, v)
        err_kernel = float((fa.flash_attention(q, k, v, causal=True)
                            .double() - exact).abs().max())
        err_plain = float((fa.flash_attention_plain(q, k, v, causal=True)
                           .double() - exact).abs().max())
        smoke.check(f"flash_attention inputs x3 hq={hq} hkv={hkv} hd={hd} "
                    f"bfloat16: error vs fp64 within 2x the plain bf16 "
                    f"version's", err_kernel <= 2 * err_plain,
                    f"kernel {err_kernel:.3g}, plain bf16 {err_plain:.3g}")


def _expert_operands(arch, s, second, seed):
    """The grouped expert product's operands at `arch`'s full-width expert
    layer in a B=4 prefill of s tokens, on a real dispatch: normal tokens
    routed by normal router weights over sqrt(D) (a sigmoid router's bias
    normal x 0.02).  Returns x [E, cap, K] (zero past each count), w [E, K,
    N] and the counts [E] int32: the gate and up products' K=D, N=F, or
    with `second` the down product's K=F, N=D (x normal on the occupied
    rows)."""
    from repro_torch.models import moe, stack
    f32 = torch.float32
    cfg = _full_cfg(arch, "pallas")
    spec, d = stack.moe_spec(cfg), cfg.d_model
    f = spec.d_ff
    e, t = spec.n_experts, BATCH * s
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    p = {"w_router": _randn(gen, (d, e), f32) / d ** 0.5,
         "router_bias": 0.02 * _randn(gen, (e,), f32)}
    xt = _randn(gen, (t, d), f32)
    top_p, top_i, _ = moe.router_probs(p, xt, spec)
    x, _, _, counts = moe._sorted_dispatch(xt, top_p, top_i,
                                           moe._capacity(t, spec), spec)
    del xt
    if second:
        rows = torch.arange(x.shape[1], device=DEVICE)
        x = _randn(gen, (e, x.shape[1], f), f32) * (
            rows[None, :, None] < counts[:, None, None])
        d, f = f, d
    return x, _randn(gen, (e, d, f), f32) / d ** 0.5, counts


def _expert_gemm_cases(smoke) -> None:
    """Phase 2's grouped expert product: both MoE prefill cells' expert
    layers at each of CELL_PREFILL_S, both products, on a real dispatch's
    counts, against torch.bmm (TF32 off: cuBLAS's fp32 kernel)."""
    from repro_torch.kernels.expert_gemm import ops as eg
    for arch in (QWEN_MOE, NEMOTRON):
        for s in CELL_PREFILL_S:
            for second in (False, True):
                x, w, counts = _expert_operands(arch, s, second, 11)
                e, cap, k = x.shape
                want = torch.bmm(x, w)
                nan = torch.full_like(want, float("nan"))
                ptr = nan.data_ptr()
                del nan
                got = eg.expert_gemm(x, w, counts)
                torch.cuda.synchronize()
                rows = torch.arange(cap, device=DEVICE)
                occ = (rows[None, :] < counts[:, None])[..., None]
                diff = float((got - want).abs().masked_fill(~occ, 0).max())
                scale = float(want.abs().max())
                zeros = bool((got.masked_fill(occ, 0) == 0).all())
                reused = got.data_ptr() == ptr
                smoke.check(
                    f"expert_gemm {arch} S={s} cap={cap} K={k} "
                    f"N={w.shape[2]}: occupied rows vs torch.bmm (1e-6 of "
                    f"its largest), exact zeros past the counts over NaN",
                    diff <= 1e-6 * scale and zeros and reused
                    and bool(torch.isfinite(got).all()),
                    f"largest difference {diff:.3g} (of {scale:.3g}), "
                    f"occupied {int(counts.sum())} of {e * cap} slots, "
                    f"written over the NaN block {reused}")
                del x, w, want, got, occ


def _counters() -> dict:
    """The kernel wrappers, by kernel name; each counts its launches."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.expert_gemm import ops as eg
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as ssd
    return {"decode_attention": da.decode_attention,
            "flash_attention": fa.flash_attention, "ssd_scan": ssd.ssd,
            "expert_gemm": eg.expert_gemm}


def _reset_launches() -> None:
    for fn in _counters().values():
        fn.launches = 0
    _counters()["flash_attention"].window_launches = 0


def _read_launches() -> dict:
    """Each kernel's launches; the flash wrapper's split into the causal
    kernel's (`flash_attention`) and the windowed one's (`flash_window`)."""
    out = {name: fn.launches for name, fn in _counters().items()}
    out["flash_window"] = _counters()["flash_attention"].window_launches
    out["flash_attention"] -= out["flash_window"]
    return out


def _check_launches(smoke, what, got, want) -> None:
    """Each kernel's launches in `got` against `want`; a kernel that `want`
    leaves out must not launch."""
    for name in sorted(got):
        n = want.get(name, 0)
        smoke.check(f"{what}: {name} launches", got[name] == n,
                    f"{got[name]} (want {n})")


def _full_cfg(arch, impl):
    """Full-width config in fp32 (weights, activations, cache), as the
    serving path (`launch/serve.py`) runs it, with both kernel knobs set
    to `impl` and the MoE route following them as serving sets it
    ("pallas": the gather route "ep"; "xla": the one-hot oracle "dense");
    DEPTH_CUT's models cut in depth."""
    import dataclasses
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(arch), param_dtype=torch.float32,
                              compute_dtype=torch.float32,
                              kv_dtype=torch.float32, attn_impl=impl,
                              ssd_impl=impl)
    if arch in DEPTH_CUT:
        cfg = _cut(cfg, DEPTH_CUT[arch])
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl="ep" if impl == "pallas" else "dense"))
    return cfg


def _cut(cfg, n_layers):
    """cfg cut in depth to n_layers, its widths unchanged; a block pattern
    to its first n_layers blocks, stacked by the shortest period that
    repeats to them (nemotron-h's first 21: MEMEM*E three times)."""
    pat = (cfg.layer_pattern * (cfg.n_layers // len(cfg.layer_pattern))
           if cfg.layer_pattern else "")[:n_layers]
    if pat:
        pat = next(pat[:p] for p in range(1, n_layers + 1)
                   if pat[:p] * (n_layers // p) == pat)
    return dataclasses.replace(cfg, n_layers=n_layers, layer_pattern=pat)


@contextlib.contextmanager
def _depth_cut(cuts=None):
    """`configs.get` (which `serve` reads its config from) hands out the
    full configs of `cuts` ({arch: layers}, default DEPTH_CUT) with their
    depth cut and their widths unchanged."""
    import dataclasses
    from repro_torch import configs
    real = configs.get
    cuts = DEPTH_CUT if cuts is None else cuts

    def get(arch_id, reduced=False):
        cfg = real(arch_id, reduced)
        if reduced or arch_id not in cuts:
            return cfg
        return _cut(cfg, cuts[arch_id])
    configs.get = get
    try:
        yield
    finally:
        configs.get = real


def _params(cfg, seed=0):
    from repro_torch.models import api
    return api.init_params(cfg, torch.Generator(device=DEVICE)
                           .manual_seed(seed))


def phase_serve(smoke: Smoke, arch: str) -> None:
    from repro_torch.launch.serve import ServeRun, serve
    layers = LAYERS[arch]
    run = ServeRun(arch=arch, reduced=False, batch=BATCH, prompt_len=PROMPT,
                   max_new_tokens=NEW, device=DEVICE, attn_impl="pallas")
    _reset_launches()
    out = serve(run)
    launches = _read_launches()
    # llama, whisper, phi-3-vision: the decode kernel at every (decoder)
    # layer of every decode step and the flash kernel at every one in the
    # prefill (whisper's encoder and cross attention are plain, as the
    # reference's); mamba: the SSD scan at every layer of the prefill (its
    # decode step is plain torch)
    want = ({"decode_attention": 0, "flash_attention": 0, "ssd_scan": layers}
            if arch == MAMBA else
            {"decode_attention": layers * (NEW - 1),
             "flash_attention": layers, "ssd_scan": 0})
    smoke.results.setdefault("launches", {})[f"serve {arch}"] = launches
    _check_launches(smoke, f"serve {arch}", launches, want)
    tokens, logits = torch.from_numpy(out["tokens"]), out["logits"]
    if arch == LLAMA:
        _KEPT["phase3_logits"] = logits.cpu()
    cfg = _full_cfg(arch, "xla")
    smoke.check(f"serve {arch}: tokens shape and range",
                tuple(tokens.shape) == (BATCH, NEW)
                and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()))
    smoke.check(f"serve {arch}: logits finite",
                bool(torch.isfinite(logits).all()))

    # the plain path, same weights and prompt, fed the served tokens
    params = _params(cfg, run.seed)
    plain = _teacher_forced(cfg, params, out["prompt"], tokens,
                            out["extra"])
    err = float((logits - plain).abs().max())
    ok = bool(torch.allclose(logits, plain, atol=1e-3, rtol=1e-3))
    smoke.results.setdefault("serve", {})[arch] = {
        "batch": BATCH, "prompt_len": PROMPT, "new_tokens": NEW,
        "prefill_s": out["prefill_s"],
        "decode_tok_per_s": out["decode_tok_per_s"],
        "launches": launches, "max_abs_logit_err_vs_plain": err}
    smoke.check(f"serve {arch}: logits vs plain path (atol=rtol=1e-3)", ok,
                f"max_abs_err={err:.3g}")


def _teacher_forced(cfg, params, prompt, tokens, extra=None):
    """The logits of prefill and of each decode step on `cfg`'s path, fed
    the served `tokens` [B, NEW]: the plain rerun of a served run.  `extra`:
    the prompt's other inputs (whisper's frames, phi-3-vision's patches)."""
    from repro_torch.models import stack
    toks = tokens.to(prompt.device, torch.int32)
    with torch.inference_mode():
        cache, plain = stack.build_prefill_fn(cfg, PROMPT + NEW)(
            params, {**(extra or {}), "tokens": prompt})
        plain_logits = [plain]
        decode = stack.build_decode_fn(cfg)
        for i in range(NEW - 1):
            cache, _, lg = decode(params, cache, toks[:, i:i + 1], PROMPT + i)
            plain_logits.append(lg)
    return torch.stack(plain_logits, dim=1)


def phase_forward(smoke: Smoke, arch: str) -> None:
    from repro_torch.models import io, stack
    layers = LAYERS[arch]
    cfg_k, cfg_p = _full_cfg(arch, "pallas"), _full_cfg(arch, "xla")
    params = _params(cfg_p)
    # tokens (and whisper's frames or phi-3-vision's patches)
    batch = io.make_batch(cfg_p, io.smoke_cell("train", BATCH, PROMPT),
                          torch.Generator(device=DEVICE).manual_seed(1))
    with torch.inference_mode():
        _reset_launches()
        h, _ = stack.forward(params, cfg_k, batch)
        launches = _read_launches()
        h_plain, _ = stack.forward(params, cfg_p, batch)
    # flash at every (decoder) layer; whisper's encoder is non-causal and
    # stays plain, as the reference's
    want = ({"decode_attention": 0, "flash_attention": 0, "ssd_scan": layers}
            if arch == MAMBA else
            {"decode_attention": 0, "flash_attention": layers,
             "ssd_scan": 0})
    smoke.results.setdefault("launches", {})[f"forward {arch}"] = launches
    _check_launches(smoke, f"forward {arch}", launches, want)
    err = float((h - h_plain).abs().max())
    smoke.results.setdefault("forward", {})[arch] = {
        "batch": BATCH, "seq": PROMPT, "launches": launches,
        "max_abs_hidden_err_vs_plain": err}
    smoke.check(f"forward {arch}: hidden state vs plain path "
                f"(atol=rtol=1e-3)",
                bool(torch.isfinite(h).all())
                and bool(torch.allclose(h, h_plain, atol=1e-3, rtol=1e-3)),
                f"max_abs_err={err:.3g}")


# A top-k choice whose k-th and (k+1)-th probabilities lie closer than this
# is a tie at fp32 noise: kernel and plain attention differ by ~1e-5 in the
# hidden state, ~1e-7 in a router probability, and a routing flip there
# moves that token's hidden state by ~1e-2, far past the 1e-3 checks.
TIE_GAP = 1e-6
# The same for a sigmoid router's biased score (nemotron-h): a score's
# slope in its logit near the top-k boundary, sigmoid' ~ 0.2, is about ten
# times a softmax probability's there (p ~ 0.01-0.05 over 128 experts),
# so the same hidden-state noise moves it ten times as far.
SIGMOID_TIE_GAP = 1e-5


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms for a block (cuBLAS's workspace fixed):
    the MoE combine's `index_add_` otherwise sums in the order its atomics
    land, and two runs of one step differ in the last bits."""
    import os
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = env or ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


class _Routes:
    """Records each MoE router call's top-k experts, the top k+1 scores
    the choice is made on (the probabilities; a sigmoid router's biased
    scores), for the gap at the top-k boundary, and which tokens' choices
    were pinned, while a run is inside `record(name)`.  It wraps
    `moe.router_probs`, which both MoE routes call, and has every decode
    step run eager (on a Python position) meanwhile.

    A plain rerun records with `follow` set to the run it is held to, and
    is teacher-forced on that run's routes where they tie, as it is on the
    served tokens: where its own top-k set differs from the followed run's
    at call j and its own gap is below `tie_gap`, it takes the followed
    run's experts (and their weights, renormalised as the router's are).
    A difference at a larger gap is left alone, and `differ` counts it."""

    def __init__(self, tie_gap=TIE_GAP):
        self.calls: dict[str, list] = {}
        self.tie_gap = tie_gap

    @contextlib.contextmanager
    def record(self, name, follow=None):
        from repro_torch.models import moe
        real, log = moe.router_probs, self.calls.setdefault(name, [])

        def router_probs(params, x, spec):
            top_p, top_i, aux = real(params, x, spec)
            k = spec.top_k
            logits = x.float() @ params["w_router"].float()
            if spec.router == "sigmoid_bias":
                weight = torch.sigmoid(logits)
                score = weight + params["router_bias"].float()
                scale = spec.routed_scale
            else:
                weight = score = torch.softmax(logits, -1)
                scale = 1.0
            top = torch.sort(score, dim=-1, descending=True,
                             stable=True).values[:, :k + 1]
            pinned = torch.zeros(top_i.shape[0], dtype=torch.bool,
                                 device=top_i.device)
            own = top_i.clone()
            if follow is not None:
                ref = self.calls[follow][len(log)][0]
                same = (top_i[:, :, None] == ref[:, None, :]).any(-1).all(-1)
                pinned = ~same & (top[:, k - 1] - top[:, k] < self.tie_gap)
                top_i = torch.where(pinned[:, None], ref, top_i)
                p = weight.gather(1, top_i)
                top_p = torch.where(pinned[:, None],
                                    p / p.sum(-1, keepdim=True) * scale,
                                    top_p)
            log.append((own, top, pinned))
            return top_p, top_i, aux
        moe.router_probs = router_probs
        # the decode step runs eager while recording: a replayed CUDA
        # graph (`stack._DecodeGraph`) calls no Python, so no router
        from repro_torch.models import stack
        graphed = stack.build_decode_fn

        def eager_decode(cfg, mesh=None, *a, **kw):
            if mesh is not None:
                return graphed(cfg, mesh, *a, **kw)
            return lambda params, cache, tokens, pos: (
                cache, *stack._decode_step(params, cfg, cache, tokens, pos))
        stack.build_decode_fn = eager_decode
        try:
            yield
        finally:
            moe.router_probs = real
            stack.build_decode_fn = graphed

    def differ(self, a: str, b: str, n_moe: int) -> dict:
        """(token, expert) routes run `a` chose and run `b`'s own choice did
        not, per MoE sub-layer (call j is sub-layer j % n_moe); of them,
        those `b` pinned to `a`'s at a tie and those it did not; and the
        first difference with both runs' gaps between their k-th and
        (k+1)-th probability."""
        ca, cb = self.calls[a], self.calls[b]
        out = {"calls": [len(ca), len(cb)], "per_sublayer": [0] * n_moe,
               "pinned_per_sublayer": [0] * n_moe, "not_ties": 0,
               "routes_per_sublayer": [0] * n_moe, "first": None}
        for j, ((ia, pa, _), (ib, pb, pinned)) in enumerate(zip(ca, cb)):
            differs = ~(ia[:, :, None] == ib[:, None, :]).any(-1)  # [T, K]
            n = int(differs.sum())
            n_pinned = int(differs[pinned].sum())
            out["per_sublayer"][j % n_moe] += n
            out["pinned_per_sublayer"][j % n_moe] += n_pinned
            out["not_ties"] += n - n_pinned
            out["routes_per_sublayer"][j % n_moe] += ia.numel()
            if n and out["first"] is None:
                t = int(differs.any(-1).nonzero()[0])
                k = ia.shape[1]
                out["first"] = {
                    "call": j, "sublayer": j % n_moe, "step": j // n_moe,
                    "token": t, "experts_" + a: ia[t].tolist(),
                    "experts_" + b: ib[t].tolist(),
                    "gap_" + a: float(pa[t, k - 1] - pa[t, k]),
                    "gap_" + b: float(pb[t, k - 1] - pb[t, k])}
        return out


def _check_routes(smoke, what, routes, a, b, n_moe, n_calls) -> dict:
    """Print the (token, expert) routes that differ between run `a` and
    the plain run `b` per MoE sub-layer, and the first of them with its
    gaps; check that both ran `n_calls` router calls and that every
    difference was a tie `b` was pinned at."""
    diff = routes.differ(a, b, n_moe)
    print(f"   {what}: (token, expert) routes of the kernel path the plain "
          f"path chose otherwise, per MoE sub-layer: {diff['per_sublayer']} "
          f"of {diff['routes_per_sublayer']}; pinned at ties (gap < "
          f"{routes.tie_gap:g}): {diff['pinned_per_sublayer']}; first: "
          f"{diff['first']}")
    smoke.check(f"{what}: the plain rerun routed the same calls",
                diff["calls"][0] == diff["calls"][1] == n_calls,
                f"{diff['calls']}")
    smoke.check(f"{what}: routes differ only at ties (gap < "
                f"{routes.tie_gap:g})",
                diff["not_ties"] == 0,
                f"{diff['not_ties']} routes differ at a larger gap")
    return diff


def _sublayer_counts(cfg) -> dict:
    """Sub-layers by kind: full attention, sliding-window attention
    ("swa"), Mamba2 and MoE."""
    n_groups, plan = cfg.layer_plan()
    return {kind: n_groups * sum(1 for item in plan if kind in item)
            for kind in ("attn", "swa", "mamba", "moe")}


def phase_moe_model(smoke: Smoke, arch: str) -> None:
    """Phases 9, 10, 17 and 18: a DEPTH_CUT model at full width in fp32.  Serve it
    (B=4, a 1024-token prompt, 32 new tokens, greedy, the kernel path with
    the gather MoE route, the decode step's CUDA graph), serve it again
    with every decode step eager to record its routes, hold the two to
    each other bit for bit (both under deterministic algorithms), and hold
    every step's logits to a teacher-forced plain rerun (plain attention
    and SSD, the one-hot MoE oracle) on the same weights, pinned to the
    eager run's routes at ties; run its forward on both paths; read the
    prefill's MoE counters in one recorded `generate` at each of
    CELL_PREFILL_S (`_served_occupancy`); hold one MoE layer's gather
    route to the oracle at the prefill's and a decode
    step's token counts; time prefill, decode and the MoE layer, and
    profile a prefill.  The params are freed before it returns."""
    from repro_torch.launch.serve import ServeRun, serve
    from repro_torch.models import api, stack
    res = smoke.results.setdefault("moe_models", {}).setdefault(arch, {})
    cfg_k, cfg_p = _full_cfg(arch, "pallas"), _full_cfg(arch, "xla")
    n = _sublayer_counts(cfg_k)
    n_moe = n["moe"]
    # the prefill's grouped expert products (its capacity is above a row
    # tile; a decode step's, 8, keeps torch.bmm)
    grouped = n_moe * (2 if cfg_k.moe.expert_act == "relu2" else 3)
    res.update(n_layers=cfg_k.n_layers, sublayers=n,
               params=api.param_count(cfg_k))
    print(f"   {arch} cut to {cfg_k.n_layers} layers: {n}, "
          f"{res['params'] / 1e9:.3f} B params "
          f"({4 * res['params'] / 1e9:.2f} GB in fp32)")
    routes = _Routes(SIGMOID_TIE_GAP if cfg_k.moe.router == "sigmoid_bias"
                     else TIE_GAP)

    # serve, as phases 3 and 5 do (the decode step's CUDA graph), then
    # again with the decode steps eager, recording their routes: a replay
    # calls no Python, so no router
    run = ServeRun(arch=arch, reduced=False, batch=BATCH, prompt_len=PROMPT,
                   max_new_tokens=NEW, device=DEVICE, attn_impl="pallas")
    with _depth_cut(), _deterministic():
        _reset_launches()
        out = serve(run)
        launches = _read_launches()
        with routes.record("served"):
            eager = serve(run)
    smoke.results.setdefault("launches", {})[f"serve {arch}"] = launches
    _check_launches(smoke, f"serve {arch}", launches, {
        "decode_attention": (n["attn"] + n["swa"]) * (NEW - 1),
        "flash_attention": n["attn"], "flash_window": n["swa"],
        "ssd_scan": n["mamba"], "expert_gemm": grouped})
    tokens, logits = torch.from_numpy(out["tokens"]), out["logits"]
    smoke.check(f"serve {arch}: the graphed decode step equals the eager "
                f"one bit for bit (tokens, every step's logits)",
                np.array_equal(out["tokens"], eager["tokens"])
                and torch.equal(logits, eager["logits"]),
                f"max_abs_err="
                f"{float((logits - eager['logits']).abs().max()):.3g}")
    del eager
    smoke.check(f"serve {arch}: tokens shape and range",
                tuple(tokens.shape) == (BATCH, NEW)
                and bool(((tokens >= 0) & (tokens < cfg_k.vocab)).all()))
    smoke.check(f"serve {arch}: logits finite",
                bool(torch.isfinite(logits).all()))
    params = _params(cfg_p, run.seed)
    with routes.record("plain", follow="served"):
        plain = _teacher_forced(cfg_p, params, out["prompt"], tokens)
    err = float((logits - plain).abs().max())
    ok = bool(torch.allclose(logits, plain, atol=1e-3, rtol=1e-3))
    diff = _check_routes(smoke, f"serve {arch}", routes, "served", "plain",
                         n_moe, n_moe * NEW)
    smoke.check(f"serve {arch}: logits vs plain path (atol=rtol=1e-3)", ok,
                f"max_abs_err={err:.3g}" + ("" if ok else
                                            f"; first flip {diff['first']}"))
    res["serve"] = {"prefill_s": out["prefill_s"],
                    "decode_tok_per_s": out["decode_tok_per_s"],
                    "launches": launches, "max_abs_logit_err_vs_plain": err,
                    "route_diff": diff}
    del out, logits, plain

    # the cache-free forward on both paths
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    fwd = {"tokens": torch.randint(0, cfg_p.vocab, (BATCH, PROMPT),
                                   generator=gen, device=DEVICE,
                                   dtype=torch.int32)}
    with torch.inference_mode():
        with routes.record("forward"):
            _reset_launches()
            h, aux = stack.forward(params, cfg_k, fwd)
            launches = _read_launches()
        with routes.record("forward plain", follow="forward"):
            h_plain, aux_plain = stack.forward(params, cfg_p, fwd)
    smoke.results["launches"][f"forward {arch}"] = launches
    _check_launches(smoke, f"forward {arch}", launches, {
        "decode_attention": 0, "flash_attention": n["attn"],
        "flash_window": n["swa"], "ssd_scan": n["mamba"],
        "expert_gemm": grouped})
    err = float((h - h_plain).abs().max())
    fdiff = _check_routes(smoke, f"forward {arch}", routes, "forward",
                          "forward plain", n_moe, n_moe)
    smoke.check(f"forward {arch}: hidden state vs plain path "
                f"(atol=rtol=1e-3)",
                bool(torch.isfinite(h).all())
                and bool(torch.allclose(h, h_plain, atol=1e-3, rtol=1e-3)),
                f"max_abs_err={err:.3g}, aux {float(aux):.6g} vs "
                f"{float(aux_plain):.6g}")
    res["forward"] = {"launches": launches,
                      "max_abs_hidden_err_vs_plain": err,
                      "aux": float(aux), "aux_plain": float(aux_plain),
                      "route_diff": fdiff}
    del h, h_plain, routes

    res["occupancy"] = _served_occupancy(smoke, arch, cfg_k, params,
                                         grouped, n)
    flush = torch.empty(64 * 2 ** 20, device=DEVICE)
    res["moe_layer"] = _moe_layer_alone(smoke, arch, cfg_k, params, flush)
    res["times"] = _serve_times(cfg_k, params, flush, (
        "profile_prefill_moe_stages", _moe_stage_profile))
    smoke.results.setdefault("times", {})[arch] = res["times"]
    del params, flush
    gc.collect()
    torch.cuda.empty_cache()


def _served_occupancy(smoke, arch, cfg, params, grouped, n) -> dict:
    """One recorded `generate` (B=4, a random prompt, 2 new tokens) at each
    of CELL_PREFILL_S on the kernel path, the launch counts set to 0 just
    before it: a causal flash launch a full attention layer and a windowed
    one a window layer (`n`, `_sublayer_counts`), kept under
    "prefill <arch> S=<s>"; `grouped` grouped launches, all
    in the prefill, and the prefill's MoE counters (`moe.pairs`,
    `moe.pairs_dropped`, `moe.slots`, `moe.rows_computed`): the shares of
    the pairs dropped, of the slots occupied and of the slots the row
    tiles compute (whole 64-row tiles, so above 1 where an expert is full
    at a capacity that is no multiple of 64); a decode step computes
    every slot."""
    from repro_torch.launch.serve import generate
    from repro_torch.obs import spans
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    out = {}
    for s in CELL_PREFILL_S:
        prompt = torch.randint(0, cfg.vocab, (BATCH, s), generator=gen,
                               device=DEVICE, dtype=torch.int32)
        _reset_launches()
        with spans.recorder(device=True) as rec:
            generate(cfg, params, prompt, 2)
        counts = _read_launches()
        smoke.results.setdefault("launches", {})[
            f"prefill {arch} S={s}"] = counts
        smoke.check(f"serve {arch} S={s}: {n['attn']} causal and {n['swa']}"
                    f" windowed flash launches", counts["flash_attention"]
                    == n["attn"] and counts["flash_window"] == n["swa"],
                    f"{counts['flash_attention']}, {counts['flash_window']}")
        launches = counts["expert_gemm"]
        pre = rec["counters"].get("prefill", {})
        dec = rec["counters"].get("decode", {})
        pairs, slots = pre.get("moe.pairs", 0), pre.get("moe.slots", 0)
        occupied = pairs - pre.get("moe.pairs_dropped", 0)
        computed = pre.get("moe.rows_computed", 0)
        r = out[f"S={s}"] = {
            "launches": launches, "pairs": pairs, "slots": slots,
            "rows_computed": computed,
            "dropped_share": 1 - occupied / max(pairs, 1),
            "occupied_share": occupied / max(slots, 1),
            "computed_share": computed / max(slots, 1),
            "decode": {k: dec.get(k) for k in ("moe.slots",
                                               "moe.rows_computed")}}
        smoke.check(f"serve {arch} S={s}: {grouped} grouped launches, all "
                    f"in the prefill; its rows computed cover the occupied "
                    f"slots; a decode step computes every slot",
                    launches == grouped and 0 < occupied <= computed
                    and dec.get("moe.rows_computed") == dec.get("moe.slots"),
                    json.dumps(r))
        del prompt
    return out


def _moe_layer_alone(smoke, arch, cfg, params, flush) -> dict:
    """The first MoE sub-layer's weights on a normalised input of T = 4096
    tokens (the prefill) and T = 4 (a decode step): the gather route and
    the one-hot oracle choose the same experts, drop the same (token, k)
    pairs, and agree within 2e-5 (aux within 1e-6); with a zero router
    every token takes experts 0 .. k-1 (a sigmoid router's bias zeroed
    too).  Times the gather route and the oracle at T = 4096."""
    import dataclasses
    from repro_torch.models import layers, moe, stack
    i = next(i for i, (_, ffn) in enumerate(cfg.layer_plan()[1])
             if ffn == "moe")
    sub = params["blocks"][f"sub{i}"]
    p = {k: v[0] for k, v in sub["moe"].items()}
    spec = stack.moe_spec(cfg)
    e, k = spec.n_experts, spec.top_k
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    out = {}
    with torch.inference_mode():
        for t in (BATCH * PROMPT, BATCH):
            x = layers.rms_norm(
                torch.randn((1, t, cfg.d_model), generator=gen,
                            device=DEVICE), sub["ln2_w"][0])
            xt = x[0]
            top_p, top_i, _ = moe.router_probs(p, xt, spec)
            top_p2, top_i2, _ = moe.router_probs(p, xt, spec)
            cap = moe._capacity(t, spec)
            disp, _ = moe._dense_dispatch(top_p, top_i, cap, spec, x.dtype)
            kept_dense = disp.sum(-1) > 0                      # [T, E]
            _, src, w, _ = moe._sorted_dispatch(xt, top_p2, top_i2, cap,
                                                spec)
            kept_ep = torch.zeros_like(kept_dense)
            ids = torch.arange(e, device=DEVICE)[:, None].expand_as(src)
            kept_ep[src[w > 0], ids[w > 0]] = True
            dropped = t * k - int(kept_ep.sum())
            del disp
            y_ep, aux_ep = moe.moe_ep(p, x, spec)
            y_d, aux_d = moe.moe_dense(p, x, spec)
            err, ok = err_within(y_ep, y_d, 2e-5)
            aux_err = abs(float(aux_ep) - float(aux_d))
            smoke.check(f"{arch} MoE layer T={t}: gather route vs one-hot "
                        f"oracle (same experts, same drops, 2e-5, aux 1e-6)",
                        torch.equal(top_i, top_i2)
                        and torch.equal(kept_dense, kept_ep) and ok
                        and aux_err <= 1e-6,
                        f"capacity {cap}, {dropped} of {t * k} (token, k) "
                        f"pairs dropped, max_abs_err={err:.3g}, aux "
                        f"err={aux_err:.3g}")
            out[f"T={t}"] = {"capacity": cap, "pairs": t * k,
                             "dropped": dropped, "max_abs_err": err,
                             "aux_err": aux_err}
            if t == BATCH * PROMPT:
                out["ms_gather"] = time_ms(lambda: moe.moe_ep(p, x, spec),
                                           flush, reps=10, warmup=2)
                out["ms_dense_oracle"] = time_ms(
                    lambda: moe.moe_dense(p, x, spec), flush, reps=5,
                    warmup=1)
                out["profile_gather"] = _moe_stage_profile(
                    lambda: moe.moe_ep(p, x, spec))
            del y_ep, y_d
        zero = {k: torch.zeros_like(v) if k in ("w_router", "router_bias")
                else v for k, v in p.items()}
        _, ties, _ = moe.router_probs(zero, xt, spec)
        smoke.check(f"{arch} MoE router: equal probabilities take experts "
                    f"0 .. k-1 on the card",
                    bool((ties == torch.arange(k, device=DEVICE)).all()))
    print(f"   {arch} MoE layer: {out}")
    return out


@contextlib.contextmanager
def _moe_stage_ranges():
    """torch.profiler ranges around the MoE layer's stages: router
    (`router_probs`), dispatch (`_sorted_dispatch`: the sort and the
    gather), experts (`_expert_ffn`: the bmm), the whole routed layer
    (`moe_ep`; what the three leave is the weighting and `index_add_`),
    and the shared expert beside it (`_with_shared`: its `_expert_ffn`
    counts as the shared expert's, not the experts')."""
    from repro_torch.models import moe
    names = {"router_probs": "moe.router",
             "_sorted_dispatch": "moe.dispatch",
             "_expert_ffn": "moe.experts", "moe_ep": "moe.layer",
             "_with_shared": "moe.shared"}
    real = {fn: getattr(moe, fn) for fn in names}

    def ranged(fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(names[fn]):
                return real[fn](*args, **kwargs)
        return run
    for fn in names:
        setattr(moe, fn, ranged(fn))
    try:
        yield
    finally:
        for fn, f in real.items():
            setattr(moe, fn, f)


def _moe_stage_profile(fn) -> dict:
    """fn() under torch.profiler with `_moe_stage_ranges`: the device time
    of each stage's kernels (summed over the MoE layers fn runs), of all
    kernels, and each stage's share of the latter."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with _moe_stage_ranges(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    def in_shared(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.name == "moe.shared":
                return True
        return False
    stage = {}
    for e in prof.events():
        if e.name.startswith("moe.") and e.device_type.name == "CPU" \
                and not in_shared(e):
            stage[e.name] = stage.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and not e.key.startswith("moe.")) / 1e3
    if not busy:
        return {"device_busy_ms": "not measured"}
    layer = stage.pop("moe.layer", 0.0)
    if layer:
        stage["moe.combine (weights, index_add_)"] = layer - sum(
            stage.get(k, 0.0) for k in ("moe.router", "moe.dispatch",
                                        "moe.experts"))
    return {"device_busy_ms": busy, "moe_layers_ms": layer,
            "stage_ms": stage,
            "stage_share": {k: v / busy for k, v in stage.items()}}


def _serve_times(cfg, params, flush, stages) -> dict:
    """Prefill ms (CUDA events, median of 5), the median decode step ms
    over a served run's 31 steps, and torch.profiler breakdowns of three
    decode steps and of one prefill; `stages` = (key, profile function)
    adds a breakdown of one prefill with the model's stages named."""
    from repro_torch.models import io, stack
    with torch.inference_mode():
        batch = io.make_batch(cfg, io.smoke_cell("prefill", BATCH, PROMPT),
                              torch.Generator(device=DEVICE).manual_seed(1))
        prefill = stack.build_prefill_fn(cfg, PROMPT + NEW)
        times = {"prefill_ms": time_ms(lambda: prefill(params, batch), flush,
                                       reps=5, warmup=1)}
        cache, logits = prefill(params, batch)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        decode = stack.build_decode_fn(cfg)
        steps = []
        for i in range(NEW - 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            cache, nxt, _ = decode(params, cache, tok, PROMPT + i)
            end.record()
            end.synchronize()
            steps.append(start.elapsed_time(end))
            tok = nxt[:, None]
        step_ms = statistics.median(steps[1:])
        times.update({"decode_step_ms": step_ms,
                      "decode_tok_per_s": BATCH * 1e3 / step_ms,
                      "decode_steps_timed": len(steps) - 1})

        def three_steps():
            c, t = cache, tok
            for i in range(3):
                c, n, _ = decode(params, c, t, PROMPT + NEW - 4 + i)
                t = n[:, None]
        times["profile_decode_3_steps"] = _profile(three_steps)
        del cache
        times["profile_prefill"] = _profile(lambda: prefill(params, batch))
        if stages is not None:
            key, stage_profile = stages
            times[key] = stage_profile(lambda: prefill(params, batch))
    print(f"   times: prefill {times['prefill_ms']:.1f} ms, decode step "
          f"{step_ms:.2f} ms" + (f", stages of one prefill {times[key]}"
                                 if stages is not None else ""))
    return times


def phase_encdec_vlm(smoke: Smoke, arch: str) -> None:
    """Phases 11 and 12: whisper-large-v3 and phi-3-vision-4.2b at full
    width and depth in fp32, their stub frames / patches from
    `io.make_batch`: served and run cache-free as phases 3 and 4 do, then
    prefill and decode timed and a prefill profiled (whisper's with its
    encoder and cross attention named).  The params are freed before it
    returns."""
    from repro_torch.models import api
    cfg = _full_cfg(arch, "pallas")
    n = api.param_count(cfg)
    print(f"   {arch}: {cfg.n_layers} decoder layers, {cfg.n_enc_layers} "
          f"encoder layers, {n / 1e9:.3f} B params ({4 * n / 1e9:.2f} GB "
          f"in fp32)")
    phase_serve(smoke, arch)
    phase_forward(smoke, arch)
    params = _params(cfg)
    flush = torch.empty(64 * 2 ** 20, device=DEVICE)
    smoke.results.setdefault("times", {})[arch] = _serve_times(
        cfg, params, flush,
        ("profile_prefill_stages", _whisper_stage_profile)
        if arch == WHISPER else None)
    del params, flush
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _whisper_stage_ranges():
    """torch.profiler ranges around whisper's stages: the encoder
    (`stack._encode`), the cross attention's k/v from the encoder states
    (`layers.cross_kv_from_encoder`) and the cross attention itself
    (`layers.attention` called with `cross_kv`)."""
    from repro_torch.models import layers, stack
    real = (stack._encode, layers.cross_kv_from_encoder, layers.attention)

    def ranged(name, fn, only_cross=False):
        def run(*args, **kwargs):
            if only_cross and kwargs.get("cross_kv") is None:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return run
    stack._encode = ranged("whisper.encoder", real[0])
    layers.cross_kv_from_encoder = ranged("whisper.cross_kv", real[1])
    layers.attention = ranged("whisper.cross_attention", real[2], True)
    try:
        yield
    finally:
        stack._encode, layers.cross_kv_from_encoder, layers.attention = real


def _whisper_stage_profile(fn) -> dict:
    """fn() under torch.profiler with `_whisper_stage_ranges`: the device
    time of the encoder, the cross k/v, the cross attention and the rest
    (the decoder's self attention, MLPs and the logits), and their shares
    of all kernels' time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with _whisper_stage_ranges(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    stage = {}
    for e in prof.events():
        if e.name.startswith("whisper.") and e.device_type.name == "CPU":
            stage[e.name] = stage.get(e.name, 0.0) + e.device_time_total / 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and not e.key.startswith("whisper.")) / 1e3
    if not busy:
        return {"device_busy_ms": "not measured"}
    stage["decoder (self attention, MLPs, logits)"] = busy - sum(
        stage.values())
    return {"device_busy_ms": busy, "stage_ms": stage,
            "stage_share": {k: v / busy for k, v in stage.items()}}


def _resolved(handles) -> list:
    """Each handle's chunk outputs; raises if a future failed."""
    return [h.future.result(timeout=600) for h in handles]


def _direct(module_builder, slot, *args):
    """One direct run of a zoo module, placed on its own on `slot`."""
    from repro_torch.core.module import AccelModule, run_placement
    pl = AccelModule("direct", module_builder, [1]).place(slot, 1)
    return run_placement(pl, *args)


def _chunk_ms(placement, args, reps=5) -> float:
    """Median time of one run_placement chunk, CUDA events on the slot's
    stream (its inputs' upload included), after one warm-up chunk."""
    from repro_torch.core.module import run_placement
    stream = placement.slot.stream
    run_placement(placement, *args)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        run_placement(placement, *args)
        end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_daemon(smoke: Smoke) -> None:
    from repro_torch.core import Daemon, PolicyConfig, Shell, \
        default_registry, uniform_shell
    from repro_torch.core.slo import AdmissionRejected
    from repro_torch.launch.serve import DaemonServeRun, serve_daemon
    from repro_torch.obs import FlightRecorder
    res = smoke.results.setdefault("daemon", {})
    slot = Shell(uniform_shell("direct1_s1", (1, 1), 1)).slots[0]

    # (a) serve_daemon as the reference runs it, on one slot of the card,
    # with the flight recorder writing a Chrome trace
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = Path(tmp) / "serve_daemon_trace.json"
        out = serve_daemon(DaemonServeRun(trace_out=str(trace_path)))
        trace = json.loads(trace_path.read_text())
    s = out["stats"]
    smoke.check("daemon: serve_daemon chunks", s["chunks"] == 14,
                f"{s['chunks']} (want 14)")
    rec = out["metrics"]["obs"]["counters"]
    smoke.check("daemon: --trace-out writes a Chrome trace whose chunk "
                "counts are the daemon's",
                bool(trace["traceEvents"])
                and rec["chunks_completed"] == s["chunks"]
                and rec["chunks_preempted"] == s["preemptions"],
                f"{len(trace['traceEvents'])} trace events, completed "
                f"{rec['chunks_completed']}, preempted "
                f"{rec['chunks_preempted']} (stats: chunks {s['chunks']}, "
                f"preemptions {s['preemptions']})")
    live = _resolved(out["handles"]["live"])
    batch = _resolved(out["handles"]["batch"])
    re_t, im_t = out["inputs"]["mandelbrot"]
    img = out["inputs"]["sobel"][0]
    mandel = _direct(zoo.build_mandelbrot, slot, re_t, im_t)
    edges = _direct(zoo.build_sobel, slot, img)
    smoke.check("daemon: every sobel output equals a direct run",
                all(torch.equal(o, edges) for (o,) in live), f"{len(live)}")
    smoke.check("daemon: every mandelbrot output equals a direct run",
                all(torch.equal(o, mandel) for outs in batch for o in outs),
                f"{sum(len(o) for o in batch)}")
    cpu = zoo.build_mandelbrot(None, 1).fn(None, torch.from_numpy(re_t),
                                           torch.from_numpy(im_t))
    differ = int((mandel.cpu() != cpu).sum())
    smoke.check("daemon: mandelbrot counts vs the CPU's (<= 1% of pixels)",
                differ <= 0.01 * cpu.numel(),
                f"{differ} of {cpu.numel()} pixels differ")
    res["serve_daemon"] = {
        "live_p95_ms": out["live_p95_ms"], "slo_misses": out["slo_misses"],
        "wall_s": out["wall_s"], "stats": s, "trace_counters": rec,
        "trace_events": len(trace["traceEvents"]),
        "sched_us_per_pass": s["sched_ns"] / max(1, s["sched_calls"]) / 1e3,
        "mandelbrot_pixels_differing_from_cpu": differ}
    print(f"   serve_daemon: live p95 {out['live_p95_ms']:.1f} ms, "
          f"{out['slo_misses']} SLO misses, wall {out['wall_s']:.3f} s, "
          f"stats {s}, scheduling "
          f"{res['serve_daemon']['sched_us_per_pass']:.1f} us a pass")

    # (b) the preemption recipe: saturate one slot, then a priority-5 job;
    # a flight recorder attached
    recorder = FlightRecorder(sample_every_ms=100.0)
    d = Daemon(Shell(uniform_shell("preempt1_s1", (1, 1), 1)),
               default_registry(), PolicyConfig(preemptive=True),
               obs=recorder)
    try:
        lo = d.submit("batch", "mandelbrot", [(re_t, im_t)] * 8, priority=0)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:  # a chunk in flight, then 50 ms
            with d._lock:
                if d.state.active:
                    break
            time.sleep(0.005)
        time.sleep(0.05)
        hi = d.submit("live", "sobel", [(img,)], priority=5)
        (hi_out,), lo_outs = _resolved([hi, lo])
        st = dict(d.stats)
    finally:
        d.shutdown()
    smoke.check("daemon: preemption recipe preempts", st["preemptions"] >= 1,
                f"{st['preemptions']} preemptions")
    c = recorder.counts
    smoke.check("daemon: the recorder counts the recipe's chunks and "
                "preemptions", c["chunks_completed"] == st["chunks"]
                and c["chunks_preempted"] == st["preemptions"],
                f"completed {c['chunks_completed']}, preempted "
                f"{c['chunks_preempted']}")
    smoke.check("daemon: every preempted job's chunk resolves once, right",
                len(lo_outs) == 8 and st["chunks"] == 9
                and all(torch.equal(o, mandel) for o in lo_outs)
                and torch.equal(hi_out, edges), f"stats {st}")
    res["preemption"] = dict(st, recorder={
        k: c[k] for k in ("chunks_started", "chunks_completed",
                          "chunks_preempted")})

    # (c) the contract run
    out = serve_daemon(DaemonServeRun(contract=True))
    lv = out["slo"]["live"]
    counts = (lv["admitted"], lv["degraded"], lv["rejected"])
    smoke.check("daemon: contract admitted + degraded + rejected = 6",
                sum(counts) == 6, f"{counts}")
    rejected = [h for h in out["handles"]["live"]
                if h.future.exception() is not None]
    smoke.check("daemon: each rejected future raises AdmissionRejected",
                len(rejected) == lv["rejected"]
                and all(isinstance(h.future.exception(), AdmissionRejected)
                        for h in rejected), f"{len(rejected)} rejected")
    _resolved(out["handles"]["batch"])
    res["contract"] = {"admitted": counts[0], "degraded": counts[1],
                       "rejected": counts[2],
                       "attainment": lv["attainment"],
                       "live_p95_ms": out["live_p95_ms"]}
    print(f"   contract: {counts[0]} admitted / {counts[1]} degraded / "
          f"{counts[2]} rejected, attainment {lv['attainment']}")

    res["lm_forward_full"] = _lm_forward_full(smoke, slot, (re_t, im_t),
                                              (img,))


def _lm_forward_full(smoke, slot, mandel_args, sobel_args) -> dict:
    """(d): the lm-forward module at full width through the daemon."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.core import Daemon, ImplAlt, ModuleDescriptor, Shell, \
        default_registry, uniform_shell
    from repro_torch.core.module import AccelModule, run_placement
    from repro_torch.models import stack
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    cfg = configs.get(LLAMA)
    reg = default_registry()
    reg.register_module(ModuleDescriptor(
        "lm-forward-full", entrypoint="chip_smoke:build_lm_forward_full",
        impls=(ImplAlt("x1", 1, 20.0),)))
    shell = Shell(uniform_shell("lm1_s1", (1, 1), 1))
    d = Daemon(shell, reg)
    try:
        mod = d._module("lm-forward-full")
        t0 = time.perf_counter()
        mod.program(shell.slots[0], 1)
        host = mod.host_weights(1)        # the CPU init, timed on its own
        init_s = time.perf_counter() - t0
        n_bytes = sum(t.numel() * t.element_size() for t in
                      _leaves(host))
        print(f"   lm-forward-full: CPU init of "
              f"{sum(t.numel() for t in _leaves(host)) / 1e9:.3f} B params "
              f"({n_bytes / 1e9:.2f} GB) in {init_s:.1f} s")
        tokens = np.random.default_rng(11).integers(
            0, cfg.vocab, (3, 8, 64), dtype=np.int32)
        _reset_launches()
        h = d.submit("lm", "lm-forward-full", [(t,) for t in tokens])
        (outs,) = _resolved([h])
        launches = _read_launches()
        st = dict(d.stats)
        (pl,) = d._placements.values()
    finally:
        d.shutdown()
    _KEPT.update(lm_host_weights=host, lm_tokens=tokens,
                 lm_logits=[o.cpu() for o in outs])
    want = {"decode_attention": 0, "flash_attention": 28 * (3 + 1),
            "ssd_scan": 0}
    smoke.results.setdefault("launches", {})["daemon lm-forward-full"] = \
        launches
    _check_launches(smoke, "daemon lm-forward-full", launches, want)
    smoke.check("daemon lm-forward-full: one reconfiguration, two reuses",
                st["reconfigurations"] == 1 and st["reuses"] == 2,
                f"stats {st}")
    # the plain path on the same weights and tokens; and the whole forward
    # in fp32 (attention too), from which the flash and the plain bf16
    # runs' logits each stand some way off
    cfg_plain = dataclasses.replace(cfg, attn_impl="xla")
    cfg_fp32 = dataclasses.replace(cfg_plain, compute_dtype=torch.float32)

    def logits(c, t):
        hp, _ = stack.forward(pl.weights_on_slot, c, {"tokens": t})
        return stack.unembed(pl.weights_on_slot, c,
                             hp[:, -1:])[:, 0][:, :cfg.vocab].float()

    rel, abs_err, gap = [], [], {"flash": [], "plain": []}
    with torch.inference_mode():
        for toks, got in zip(tokens, outs):
            t = torch.from_numpy(toks).to(slot.device)
            want_l, fp32_l = logits(cfg_plain, t), logits(cfg_fp32, t)
            got_l = got[:, :cfg.vocab].float()
            rel.append(float((got_l - want_l).norm() / want_l.norm()))
            abs_err.append(float((got_l - want_l).abs().max()))
            for name, l in (("flash", got_l), ("plain", want_l)):
                gap[name].append(float((l - fp32_l).norm() / fp32_l.norm()))
    print(f"   lm-forward-full: relative L2 to the fp32 forward: flash "
          f"{gap['flash']}, plain bf16 {gap['plain']}")
    smoke.check("daemon lm-forward-full: logits vs plain path "
                "(relative L2 <= 5e-2)",
                all(r <= 5e-2 for r in rel) and all(
                    bool(torch.isfinite(o).all()) for o in outs)
                and all(tuple(o.shape) == (8, cfg.padded_vocab)
                        for o in outs),
                f"relative L2 {max(rel):.3g}, max_abs_err {max(abs_err):.3g}")
    second = mod.place(pl.slot, 1)
    smoke.check("daemon lm-forward-full: a second placement is a cache hit",
                second.cache_hit, f"cache_hit={second.cache_hit}")
    del second
    lm = {"params": sum(t.numel() for t in _leaves(host)),
          "weight_bytes": n_bytes, "cpu_init_s": init_s,
          "compile_time_s": pl.compile_time_s, "load_time_s": pl.load_time_s,
          "upload_gb_per_s": n_bytes / pl.load_time_s / 1e9,
          "launches": launches, "stats": st, "relative_l2": rel,
          "max_abs_err": abs_err, "relative_l2_to_fp32": gap}
    print(f"   lm-forward-full: compile {pl.compile_time_s:.3f} s, load "
          f"{pl.load_time_s:.3f} s ({lm['upload_gb_per_s']:.2f} GB/s)")
    # each zoo module's chunk on the card, beside the registry's estimate
    chunk, placed = {}, {"lm-forward-full": (pl, (tokens[0],))}
    for name, builder, args in (
            ("mandelbrot", zoo.build_mandelbrot, mandel_args),
            ("sobel", zoo.build_sobel, sobel_args),
            ("matmul", zoo.build_matmul,
             (np.random.default_rng(12).standard_normal((512, 512))
              .astype(np.float32),))):
        placed[name] = (AccelModule(name, builder, [1]).place(slot, 1), args)
    for name, (placement, args) in placed.items():
        chunk[name] = _chunk_ms(placement, args)
    lm["chunk_ms"] = chunk
    lm["est_chunk_ms_x1"] = {"mandelbrot": 12.0, "sobel": 6.0,
                             "matmul": 4.0, "lm-forward": 20.0}
    print(f"   chunk ms on the card: {chunk}")
    # where a chunk's time goes: one chunk of the two slowest modules
    lm["profile"] = {
        f"{name} chunk": _profile(
            lambda: run_placement(placed[name][0], *placed[name][1]))
        for name in ("lm-forward-full", "mandelbrot")}
    return lm


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _flash_lm_shape(smoke) -> dict:
    """The flash kernel alone at the lm-forward module's attention shape
    (bf16, B=8, S=64, Hq=24, Hkv=8, hd=128, causal) beside one SDPA call
    in bf16 at the same shape, as a `kernels`-line entry."""
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    flush = torch.empty(64 * 2 ** 20, device=DEVICE)
    return _flash_shape_entry(
        smoke, gen, flush, 8, 64, 24, 8, 128, 128 ** -0.5, torch.bfloat16,
        _launches(smoke, "daemon lm-forward-full", "flash_attention"))


# ---------------------------------------------------------------------------
# phase 13: training on the card
# ---------------------------------------------------------------------------

# (a) llama3.2-3b at full width and depth through `train()`; (b) its full
# width cut to TRAIN_CUT layers, held against the CPU; (c) the driver's
# control flow at the reduced configs, as the reference's test_train_*
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 2, 512, 8, 1e-3
TRAIN_CUT, CUT_B, CUT_S = 2, 1, 128
# the kernels of a cuBLAS / CUTLASS matrix product, by name
GEMM_NAMES = re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.I)
# the autograd nodes that put the per-group views back into a stacked
# gradient (`unbind`'s backward is one stack; `v[i]`'s a zero fill each)
STACK_NODES = ("UnbindBackward0", "StackBackward0", "SelectBackward0")


# the reference's losses over phase 13 (a)'s batch and schedule (B=2,
# S=512, 8 steps, lr 1e-3, warm-up 5, cosine over 10) at llama3.2-3b's
# full width and vocabulary cut to TRAIN_CUT layers, fp32 compute, from
# `numpy_params(cfg, 0)`: the reference's unsharded step on the CPU,
# printed by tests/train_full_width_witness.py
WITNESS_LOSSES = (11.774210929870605, 11.770812034606934, 11.776093482971191,
                  11.763729095458984, 11.908243179321289, 11.817910194396973,
                  11.83788013458252, 12.063973426818848)


class _StepTimer:
    """While `patch()` is open, every train step that
    `steps.build_train_step` builds is timed with CUDA events; after each
    step the loss of the batch it took is computed again on the updated
    params (outside the timed window), and the last call's (step, state,
    batch) is kept, so one more step can be profiled after the driver
    returns."""

    def __init__(self):
        self.events: list = []
        self.descent: list = []     # (loss before the step, after it)
        self.last = None

    @contextlib.contextmanager
    def patch(self):
        from repro_torch import tree
        from repro_torch.launch import steps
        from repro_torch.models import stack
        from repro_torch.sharding import partition
        real = steps.build_train_step

        def build(cfg, *args, **kwargs):
            step = real(cfg, *args, **kwargs)
            loss_fn = stack.build_loss_fn(cfg)

            def timed(state, batch):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(state, batch)
                end.record()
                self.events.append((start, end))
                with torch.no_grad():
                    # the driver's state and batch are DTensors over its
                    # one rank: their whole tensors, without a copy
                    params = tree.tree_map(
                        lambda p: steps._compute_cast(cfg, partition.full(p)),
                        out[0]["params"])
                    whole = {k: partition.full(v) for k, v in batch.items()}
                    self.descent.append((float(out[1]["loss"]),
                                         float(loss_fn(params, whole))))
                self.last = (step, out[0], batch)
                return out
            return timed
        steps.build_train_step = build
        try:
            yield self
        finally:
            steps.build_train_step = real

    def ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def _part(smoke, name, fn) -> None:
    """One part of a phase: a failure is reported and the next part
    runs; the part's tensors are freed after it."""
    print(f"-- {name}", flush=True)
    try:
        fn()
    except Exception:  # reported; the other parts still run
        traceback.print_exc()
        smoke.check(f"{name}: raised", False)
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(smoke: Smoke) -> None:
    res = smoke.results.setdefault("train", {})
    _part(smoke, "13a train full width and depth",
          lambda: _train_full(smoke, res))
    _part(smoke, f"13b train cut to {TRAIN_CUT} layers vs the CPU",
          lambda: _train_cut(smoke, res))
    _part(smoke, f"13b train cut to {TRAIN_CUT} layers: the reference's "
          "losses", lambda: _train_witness(smoke, res))
    _part(smoke, "13c train driver control flow",
          lambda: _train_driver(smoke, res))


def _train_flops(cfg, b, s) -> float:
    """FLOP of one train step: 6 per param and token for the products
    (the tied embedding counted once, as the unembedding), and the plain
    attention's scores and weighted sum over the whole S x S square
    (masked, not skipped), forward and backward."""
    from repro_torch.models import api
    attn = 4 * b * s * s * cfg.n_heads * cfg.head_dim * cfg.n_layers
    return 6 * api.param_count(cfg) * b * s + 3 * attn


def _train_full(smoke, res) -> None:
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.launch.train import TrainRun, train
    from repro_torch.models import api, stack
    run = TrainRun(arch=LLAMA, reduced=False, steps=TRAIN_STEPS,
                   global_batch=TRAIN_B, seq_len=TRAIN_S, lr=TRAIN_LR,
                   log_every=1, device=DEVICE)
    timer = _StepTimer()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with timer.patch():
        hist = train(run)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [loss for _, loss in hist["loss"]]
    ms = timer.ms()
    cfg = configs.get(LLAMA)
    step_ms = statistics.median(ms[2:])
    tokens = TRAIN_B * TRAIN_S
    flops = _train_flops(cfg, TRAIN_B, TRAIN_S)
    out = res["full"] = {
        "arch": LLAMA, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": api.param_count(cfg), "batch": TRAIN_B, "seq": TRAIN_S,
        "steps": TRAIN_STEPS, "losses": losses, "step_ms": ms,
        "step_ms_median_2_7": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3), "train_wall_s": wall,
        "flop_per_step": flops,
        "achieved_tflop_per_s": flops / (step_ms / 1e3) / 1e12,
        "bf16_peak_share": flops / (step_ms / 1e3) / BF16_FLOP_PER_S,
        "max_memory_allocated_gb": peak, "launches": launches}
    print(f"   full width: losses {[f'{x:.4f}' for x in losses]}, step "
          f"{step_ms:.1f} ms (median of steps 2-7), "
          f"{out['tokens_per_s']:.0f} tokens/s, "
          f"{out['achieved_tflop_per_s']:.1f} TFLOP/s = "
          f"{out['bf16_peak_share']:.1%} of the bf16 dense peak, "
          f"max_memory_allocated {peak:.2f} GB", flush=True)
    smoke.check("train full: 8 losses, all finite",
                len(losses) == TRAIN_STEPS
                and all(np.isfinite(x) for x in losses), str(len(losses)))
    # each step takes a fresh batch, and at this width, vocabulary, batch
    # and schedule a fresh batch's loss rises above ln V over the 8 steps:
    # the reference's does too (part 13b holds the card's steps at
    # TRAIN_CUT layers to the reference's losses).  So the learning check
    # is on the batch each step took: the first step (Adam's first step is
    # its gradient's sign) and the mean over the steps lower it
    before, after = zip(*timer.descent)
    out["descent"] = {"loss_before_step": before, "loss_after_step": after}
    print(f"   each batch's loss after its step: "
          f"{[f'{b:.4f}->{a:.4f}' for b, a in timer.descent]}; "
          f"loss[0] {losses[0]:.4f}, loss[7] {losses[-1]:.4f}", flush=True)
    smoke.check("train full: step 0 lowers its batch's loss",
                after[0] < before[0], f"{before[0]:.4f} -> {after[0]:.4f}")
    smoke.check("train full: the steps lower their batches' loss on the "
                "mean", np.mean(after) < np.mean(before),
                f"{np.mean(before):.4f} -> {np.mean(after):.4f}")
    _check_launches(smoke, "train full", launches,
                    {name: 0 for name in launches})
    step, state, batch = timer.last
    out["profile"] = _train_profile(lambda: step(state, batch), state)
    print(f"   step profile: {json.dumps(out['profile'])}", flush=True)
    timer.last = step = state = batch = None
    gc.collect()
    torch.cuda.empty_cache()

    # step 0's loss against forwards of the same weights (the driver's
    # init, drawn again from its seed) and batch under no_grad, in fp32
    # compute and in the config's bf16.  The train step's loss is its bf16
    # forward's; the fp32 forward is another computation, whose per-token
    # losses differ from the bf16 ones by the spread printed here, so two
    # equal means are the rounding of the mean to fp32, not one
    # computation twice.  The driver's next batches show the same
    # spread, and means that differ by more than the rounding.
    params = api.init_params(cfg, torch.Generator(device=DEVICE)
                             .manual_seed(run.seed))
    source = SyntheticSource(DataConfig(cfg.vocab, TRAIN_S, TRAIN_B,
                                        seed=run.seed))
    ulp = float(torch.finfo(torch.float32).eps) * 8     # at 8 <= x < 16
    fwd = []
    with torch.no_grad():
        for i in range(4):
            tokens = torch.from_numpy(source.batch(i)).to(DEVICE)
            (l32, nll32), (lbf, nllbf) = (_token_losses(
                params, dataclasses.replace(cfg, compute_dtype=dtype,
                                            kv_dtype=dtype, loss_chunk=0),
                tokens) for dtype in (torch.float32, cfg.compute_dtype))
            diff = nllbf - nll32
            fwd.append({"batch": i, "fp32": l32, "bf16": lbf,
                        "mean_diff_ulps": (lbf - l32) / ulp,
                        "token_diff_mean": float(diff.mean()),
                        "token_diff_std": float(diff.std()),
                        "token_diff_max_abs": float(diff.abs().max())})
            print(f"   batch {i} no-grad forwards: fp32 {l32!r}, bf16 "
                  f"{lbf!r} ({fwd[-1]['mean_diff_ulps']:+.0f} ulps); "
                  f"per-token bf16 - fp32: mean {float(diff.mean()):.3e}, "
                  f"std {float(diff.std()):.3e}, max |.| "
                  f"{float(diff.abs().max()):.3e}", flush=True)
    del params
    rel = abs(losses[0] - fwd[0]["fp32"]) / abs(fwd[0]["fp32"])
    rel_bf = abs(losses[0] - fwd[0]["bf16"]) / abs(fwd[0]["bf16"])
    out["forwards"] = fwd
    out["step0_loss_vs_forwards"] = {"rel_fp32": rel, "rel_bf16": rel_bf}
    smoke.check("train full: step-0 loss vs an fp32 forward (2e-2 rel)",
                rel <= 2e-2, f"{losses[0]:.5f} vs {fwd[0]['fp32']:.5f}, "
                f"rel {rel:.3g}")
    smoke.check("train full: step-0 loss is the bf16 forward's (1e-6 rel)",
                rel_bf <= 1e-6, f"{losses[0]!r} vs {fwd[0]['bf16']!r}")
    smoke.check("train full: the fp32 and bf16 forwards differ per token",
                all(f["token_diff_max_abs"] > 0 for f in fwd),
                str([f"{f['token_diff_std']:.2e}" for f in fwd]))


def _token_losses(params, cfg, tokens) -> tuple[float, torch.Tensor]:
    """The loss of a forward, and its per-token losses (fp64)."""
    from repro_torch.models import stack
    h, aux = stack.forward(params, cfg, {"tokens": tokens})
    loss = float(stack.loss_from_hidden(params, cfg, h, tokens, aux))
    logits = stack.unembed(params, cfg, h[:, :-1])
    del h
    gold = logits.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return loss, (torch.logsumexp(logits, -1) - gold).double()


def _train_profile(fn, state) -> dict:
    """One train step under torch.profiler: device busy ms, and the device
    ms of the matrix products (by kernel name), the attention softmax, the
    optimizer (`adamw.update`), the param casts (forward: `_compute_cast`;
    backward: the ToCopyBackward0 nodes whose input is a param's shape)
    and the stacked gradients' assembly (`unbind`/`stack`/`select`
    backward); the rest is "other"."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    real_update, real_cast = adamw.update, steps._compute_cast

    def ranged(name, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return run
    shapes = {tuple(t.shape) for t in _leaves(state["params"])}
    torch.cuda.synchronize()
    adamw.update = ranged("train.adamw", real_update)
    steps._compute_cast = ranged("train.cast", real_cast)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        adamw.update, steps._compute_cast = real_update, real_cast
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total
               and not e.key.startswith("train.")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    stage = {"gemm": sum(e.self_device_time_total for e in kernels
                         if GEMM_NAMES.search(e.key)) / 1e3,
             "softmax": sum(e.self_device_time_total for e in kernels
                            if "softmax" in e.key.lower()) / 1e3,
             "adamw": 0.0, "cast forward": 0.0, "cast backward": 0.0,
             "stack/select backward": 0.0}
    for e in prof.events():
        if e.device_type.name != "CPU":
            continue
        ms = e.device_time_total / 1e3
        if e.name == "train.adamw":
            stage["adamw"] += ms
        elif e.name == "train.cast":
            stage["cast forward"] += ms
        elif e.name == "ToCopyBackward0" and any(
                tuple(s) in shapes for s in (e.input_shapes or [])):
            stage["cast backward"] += ms
        elif e.name in STACK_NODES:
            stage["stack/select backward"] += ms
    stage["other"] = busy - sum(stage.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1 - busy / wall_ms),
            "kernel_calls": sum(e.count for e in kernels),
            "stage_ms": stage,
            "stage_share": {k: v / busy for k, v in stage.items()},
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def _rel_l2(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _close(got, want, tol) -> tuple[float, bool]:
    """Max abs error, and whether it is within tol relative to the leaf's
    scale (tol x max |want|) and tol elementwise."""
    got, want = got.double().cpu(), want.double().cpu()
    diff = (got - want).abs()
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float(diff.max()) if diff.numel() else 0.0, bool(
        torch.all(diff <= tol * scale + tol * want.abs()))


def _spied_step(step, state, batch) -> tuple:
    """(metrics, grads): one train step, and the gradients it handed the
    optimizer (copied)."""
    from repro_torch import tree as tree_mod
    from repro_torch.optim import adamw
    real = adamw.update
    seen = []

    def spy(opt_cfg, grads, opt_state, params):
        seen.append(tree_mod.tree_map(lambda g: g.clone(), grads))
        return real(opt_cfg, grads, opt_state, params)
    adamw.update = spy
    try:
        _, metrics = step(state, batch)
    finally:
        adamw.update = real
    return {k: float(v) for k, v in metrics.items()}, seen[0]


def _clone(tree):
    from repro_torch import tree as tree_mod
    return tree_mod.tree_map(lambda t: t.clone(), tree)


def _train_cut(smoke, res) -> None:
    """llama3.2-3b at full width cut to TRAIN_CUT layers, fp32 compute: one
    train step, AdamW, int8 quantisation, remat and a checkpoint on the
    card, each held against the CPU (or itself) on the same inputs."""
    import dataclasses
    import shutil
    from repro_torch import configs, tree as tree_mod
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.launch import steps
    from repro_torch.models import api, stack
    from repro_torch.optim import adamw, grad_compress as gc
    cfg = dataclasses.replace(
        configs.get(LLAMA), n_layers=TRAIN_CUT, compute_dtype=torch.float32,
        kv_dtype=torch.float32, loss_chunk=0, remat="none")
    out = res["cut"] = {"n_layers": TRAIN_CUT, "d_model": cfg.d_model,
                        "params": api.param_count(cfg), "batch": CUT_B,
                        "seq": CUT_S}
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=10)
    step = steps.build_train_step(cfg, opt_cfg)
    tokens = torch.from_numpy(SyntheticSource(DataConfig(
        cfg.vocab, CUT_S, CUT_B, seed=0)).batch(0))
    # the same weights on both devices: drawn on the CPU, then copied
    cpu = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    card = tree_mod.tree_map(lambda t: t.to(DEVICE, copy=True), cpu)
    card0 = _clone(card)
    t0 = time.perf_counter()
    m_card, g_card = _spied_step(step, card, {"tokens": tokens.to(DEVICE)})
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_cpu, g_cpu = _spied_step(step, cpu, {"tokens": tokens})
    out["step_s"] = {"card": t_card, "cpu": time.perf_counter() - t0}
    for k in ("loss", "grad_norm"):
        rel = abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
        out[f"{k}_rel"] = rel
        smoke.check(f"train cut: {k} card vs CPU (1e-5 rel)", rel <= 1e-5,
                    f"{m_card[k]:.7g} vs {m_cpu[k]:.7g}, rel {rel:.3g}")
    worst = max((_rel_l2(a, b), "/".join(p)) for (p, a), b in zip(
        tree_mod.leaves_with_paths(g_card), tree_mod.leaves(g_cpu)))
    out["grad_rel_l2_max"] = worst[0]
    smoke.check("train cut: every grad leaf card vs CPU (1e-4 rel L2)",
                worst[0] <= 1e-4, f"worst {worst[0]:.3g} at {worst[1]}")

    # the card's AdamW fed the CPU's grads, from the same pre-step state
    g_cpu_on_card = tree_mod.tree_map(lambda g: g.to(DEVICE), g_cpu)
    adamw.update(opt_cfg, g_cpu_on_card, card0["opt"], card0["params"])
    errs = []
    for name, a, b in (("params", card0["params"], cpu["params"]),
                       ("m", card0["opt"]["m"], cpu["opt"]["m"]),
                       ("v", card0["opt"]["v"], cpu["opt"]["v"])):
        for x, y in zip(tree_mod.leaves(a), tree_mod.leaves(b)):
            errs.append((*_close(x, y, 1e-6), name))
    out["adamw_max_abs_err"] = max(e[0] for e in errs)
    smoke.check("train cut: card AdamW on the CPU's grads (1e-6)",
                all(e[1] for e in errs),
                f"max abs err {out['adamw_max_abs_err']:.3g}")
    del card0, g_cpu_on_card

    # int8 quantisation of the same fp32 grads: bit for bit
    same = True
    for g in tree_mod.leaves(g_cpu):
        q, s = gc.quantize_int8(g)
        qc, sc = gc.quantize_int8(g.to(DEVICE))
        same &= torch.equal(q, qc.cpu()) and torch.equal(
            s.view(torch.int32), sc.cpu().view(torch.int32))
    smoke.check("train cut: quantize_int8 card == CPU, bit for bit", same)
    del g_cpu, cpu

    # remat: the same grads with "full" and "dots", and each one's peak
    tokens_card = {"tokens": tokens.to(DEVICE)}
    grads, peaks = {}, {}
    for remat in ("none", "full", "dots"):
        params = tree_mod.tree_map(
            lambda t: t.detach().clone().requires_grad_(), card["params"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = stack.build_loss_fn(dataclasses.replace(cfg, remat=remat))(
            params, tokens_card)
        leaves = tree_mod.leaves(params)
        grads[remat] = torch.autograd.grad(loss, leaves)
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
        del params, loss, leaves
    worst = max(_rel_l2(a, b) for r in ("full", "dots")
                for a, b in zip(grads[r], grads["none"]))
    out["remat"] = {"grad_rel_l2_max": worst,
                    "peak_gb_above_state": peaks}
    smoke.check("train cut: remat full/dots grads vs none (1e-6 rel L2)",
                worst <= 1e-6, f"worst {worst:.3g}, peaks above the state "
                f"{ {k: round(v, 3) for k, v in peaks.items()} } GB")
    del grads

    # a checkpoint: non-blocking save, an in-place step, then wait()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(tmp, keep_last=1)
        before = _clone(card)
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree_mod.leaves(card))
        batch1 = {"tokens": torch.from_numpy(SyntheticSource(DataConfig(
            cfg.vocab, CUT_S, CUT_B, seed=0)).batch(1)).to(DEVICE)}
        t0 = time.perf_counter()
        mgr.save(1, card)
        t_copy = time.perf_counter() - t0
        _, m_inplace = step(card, batch1)
        loss_inplace = float(m_inplace["loss"])
        mgr.wait()
        t_write = time.perf_counter() - t0
        del card
        t0 = time.perf_counter()
        restored = mgr.restore(1, before)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        exact = all(torch.equal(a, b) for a, b in zip(
            tree_mod.leaves(restored), tree_mod.leaves(before)))
        smoke.check("train cut: restore == the pre-step state, bit for bit",
                    exact)
        _, m_again = step(restored, batch1)
        rel = abs(float(m_again["loss"]) - loss_inplace) / abs(loss_inplace)
        smoke.check("train cut: the step from the restored state (1e-5)",
                    rel <= 1e-5, f"rel {rel:.3g}")
        disk = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                   if f.is_file())
        out["checkpoint"] = {
            "state_gb": nbytes / 1e9, "disk_gb": disk / 1e9,
            "host_copy_s": t_copy, "save_to_published_s": t_write,
            "write_gb_per_s": disk / 1e9 / t_write,
            "restore_s": t_read, "read_gb_per_s": disk / 1e9 / t_read,
            "loss_rel": rel}
        print(f"   checkpoint: {disk / 1e9:.2f} GB on disk, write "
              f"{out['checkpoint']['write_gb_per_s']:.2f} GB/s (host copy "
              f"{t_copy:.2f} s), read {out['checkpoint']['read_gb_per_s']:.2f}"
              f" GB/s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def numpy_params(cfg, seed: int) -> dict:
    """CPU params drawn with numpy, the same on machines with other torch
    releases (torch's CPU `trunc_normal_` draws differently from one
    release to the next): `api.init_params`' fan-in scales, with a
    standard normal clipped at +-2 in place of its truncated normal; the
    leaves it draws no random numbers for are its own."""
    from repro_torch import tree
    from repro_torch.models import api
    rng = np.random.default_rng(seed)

    def leaf(spec):
        if spec.init != "normal":
            return api._init_leaf(spec, cfg, torch.Generator())
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        x = rng.standard_normal(spec.shape, dtype=np.float32)
        np.clip(x, -2.0, 2.0, out=x)
        x *= min(0.02, (1.0 / max(fan_in, 1)) ** 0.5)
        return torch.from_numpy(x).to(cfg.param_dtype)
    return tree.tree_map(leaf, api.param_table(cfg))


def _train_witness(smoke, res) -> None:
    """(a)'s fresh batches' losses rise over its 8 steps; so do the
    reference's at that width.  At (a)'s batch and schedule, full width
    cut to TRAIN_CUT layers in fp32, the card's 8 steps give the losses
    of the reference's step on the CPU (WITNESS_LOSSES) within 1e-4."""
    import dataclasses
    from repro_torch import configs, tree
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(
        configs.get(LLAMA), n_layers=TRAIN_CUT, compute_dtype=torch.float32,
        kv_dtype=torch.float32, loss_chunk=0, remat="none")
    params = tree.tree_map(lambda t: t.to(DEVICE), numpy_params(cfg, 0))
    state = {"params": params, "opt": adamw.init(params)}
    step = steps.build_train_step(cfg, adamw.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=5, total_steps=max(TRAIN_STEPS, 10)))
    source = SyntheticSource(DataConfig(cfg.vocab, TRAIN_S, TRAIN_B, seed=0))
    losses = []
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, {"tokens": torch.from_numpy(
            source.batch(i)).to(DEVICE)})
        losses.append(float(metrics["loss"]))
    want = np.array(WITNESS_LOSSES)
    rel = float(np.max(np.abs(np.array(losses) - want) / want))
    res["witness"] = {"losses": losses, "reference": list(WITNESS_LOSSES),
                      "max_rel": rel}
    print(f"   {TRAIN_CUT} layers, fp32: losses "
          f"{[f'{x:.6f}' for x in losses]}; loss[7] - loss[0] "
          f"{losses[-1] - losses[0]:+.6f} (reference "
          f"{want[-1] - want[0]:+.6f}), max rel {rel:.3g}", flush=True)
    smoke.check("train cut: 8 steps' losses vs the reference's (1e-4 rel)",
                rel <= 1e-4, f"{rel:.3g}")


def _train_driver(smoke, res) -> None:
    """The reference's four test_train_* runs, on the card."""
    from repro_torch.launch.train import TrainRun, train
    def quiet(*_):
        pass
    out = res["driver"] = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        runs = {
            "loss decreases": TrainRun(arch=LLAMA, steps=25, global_batch=8,
                                       seq_len=32, lr=3e-3, log_every=100,
                                       device=DEVICE),
            "fault at 12": TrainRun(arch=LLAMA, steps=20, global_batch=4,
                                    seq_len=32, ckpt_dir=f"{tmp}/fault",
                                    ckpt_every=5, fail_at_step=12,
                                    log_every=100, device=DEVICE),
            "elastic at 8": TrainRun(arch="granite-3-8b", steps=16,
                                     global_batch=4, seq_len=32,
                                     ckpt_dir=f"{tmp}/elastic",
                                     elastic_switch_step=8, log_every=100,
                                     device=DEVICE),
            "grad compress": TrainRun(arch=LLAMA, steps=12, global_batch=4,
                                      seq_len=32, lr=3e-3,
                                      grad_compress=True, log_every=100,
                                      device=DEVICE)}
        hist = {}
        for name, run in runs.items():
            t0 = time.perf_counter()
            hist[name] = train(run, log=quiet)
            out[name] = {"wall_s": time.perf_counter() - t0,
                         **{k: v for k, v in hist[name].items()}}
    losses = dict(hist["loss decreases"]["loss"])
    smoke.check("train driver: loss decreases over 25 steps",
                losses[0] > losses[24], f"{losses[0]:.4f} -> "
                f"{losses[24]:.4f}")
    h = hist["fault at 12"]
    smoke.check("train driver: fault at 12 -> 1 restart, final step 20",
                h["restarts"] == 1 and h["final_step"] == 20,
                f"{h['restarts']}, {h['final_step']}")
    h = hist["elastic at 8"]
    smoke.check("train driver: elastic switch at 8 -> 1 switch, final 16",
                h["elastic_switches"] == 1 and h["final_step"] == 16,
                f"{h['elastic_switches']}, {h['final_step']}")
    losses = dict(hist["grad compress"]["loss"])
    smoke.check("train driver: grad compress, loss[11] < loss[0]",
                losses[11] < losses[0], f"{losses[0]:.4f} -> "
                f"{losses[11]:.4f}")


# ---------------------------------------------------------------------------
# phase 14: distribution on the card
# ---------------------------------------------------------------------------

# what earlier phases keep for phase 14 to hold its runs to: phase 3's
# llama logits, phase 8 (d)'s lm-forward host weights, tokens and logits
_KEPT: dict = {}
MOE_CUT = 4          # qwen3-moe-30b-a3b's layers in phase 14 (c)
MOE_SEEDS = (1, 2)   # (c)'s prompts


def _events_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _serve_step_times(prefill, decode, params, batch, put) -> dict:
    """Prefill ms (CUDA events, median of 3 after one warm-up) and the
    median decode-step ms over a served run's 31 steps, of one path."""
    from repro_torch.sharding import partition
    with torch.inference_mode():
        prefill(params, batch)
        pre = statistics.median(
            _events_ms(lambda: prefill(params, batch)) for _ in range(3))
        cache, logits = prefill(params, batch)
        tok = partition.full(logits).argmax(-1)[:, None].to(torch.int32)
        steps = []
        for i in range(NEW - 1):
            out = {}

            def one():
                out["r"] = decode(params, cache, put(tok), PROMPT + i)
            steps.append(_events_ms(one))
            cache, nxt, _ = out["r"]
            tok = partition.full(nxt)[:, None]
    return {"prefill_ms": pre, "decode_step_ms": statistics.median(steps[1:])}


def _dist_serve(rank, world, tmp) -> dict:
    """(a) llama3.2-3b at full width and depth served over the mesh under
    the "serve" rules, the kernel route and the plain update-inside body,
    and the times of both paths in this process."""
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.launch.serve import (ServeRun, generate, serve_inputs,
                                          shard_inputs)
    from repro_torch.models import api, io, stack
    from repro_torch.models.api import ShapeCell
    from repro_torch.sharding import partition
    out = {}
    mesh = mesh_mod.make_mesh((1, world), ("data", "model"))
    rules = partition.make_rules("serve")

    def served(run):
        # what `serve` runs when launched over several ranks, here on
        # this phase's mesh at any world size
        cfg, params, prompt, extra = serve_inputs(run, DEVICE)
        pd, prompt_d, extra_d = shard_inputs(cfg, params, prompt, extra,
                                             mesh, rules)
        got = generate(cfg, pd, prompt_d, NEW, extra=extra_d, mesh=mesh,
                       rules=rules)
        return params, prompt, extra, got
    _reset_launches()
    run = ServeRun(arch=LLAMA, reduced=False, batch=BATCH, prompt_len=PROMPT,
                   max_new_tokens=NEW, device=DEVICE, attn_impl="pallas")
    params, _, _, (_, logits, prefill_s, decode_s) = served(run)
    out["launches_pallas"] = _read_launches()
    phase3 = torch.load(Path(tmp) / "phase3_logits.pt")
    logits = logits.cpu()
    out["pallas_vs_phase3_max_abs"] = float((logits - phase3).abs().max())
    out["pallas_vs_phase3_ok"] = bool(torch.allclose(logits, phase3,
                                                     atol=1e-5, rtol=1e-5))
    out["pallas_wall"] = {"prefill_s": prefill_s,
                          "decode_tok_per_s": BATCH * (NEW - 1) / decode_s}
    del logits, params
    # the plain route: the update-inside body (1056 rows over the
    # sequence shards), against the plain unsharded rerun on its tokens
    _reset_launches()
    params, prompt, extra, (tokens, logits, _, _) = served(
        dataclasses.replace(run, attn_impl="xla"))
    out["launches_xla"] = _read_launches()
    cfg = _full_cfg(LLAMA, "xla")
    plain = _teacher_forced(cfg, params, prompt, tokens, extra)
    out["xla_vs_plain_max_abs"] = float((logits - plain).abs().max())
    out["xla_vs_plain_ok"] = bool(torch.allclose(logits, plain,
                                                 atol=1e-3, rtol=1e-3))
    del logits, plain, params
    # CUDA-event times of the unsharded and the sharded path, here
    cfg = _full_cfg(LLAMA, "pallas")
    params = _params(cfg, run.seed)
    batch = io.make_batch(cfg, io.smoke_cell("prefill", BATCH, PROMPT),
                          torch.Generator(device=DEVICE).manual_seed(1))
    cell = ShapeCell("serve", PROMPT + NEW, BATCH, "prefill")
    put_b = lambda t: partition.distribute(  # noqa: E731
        t, mesh, partition.to_placements(("batch", None), rules, mesh))
    times = {"unsharded": _serve_step_times(
        stack.build_prefill_fn(cfg, PROMPT + NEW), stack.build_decode_fn(cfg),
        params, batch, lambda t: t)}
    times["sharded"] = _serve_step_times(
        steps.build_prefill_step(cfg, cell, mesh, rules),
        steps.build_decode_step(cfg, mesh, rules),
        partition.distribute_tree(params, api.param_specs(cfg), mesh, rules),
        {"tokens": put_b(batch["tokens"])}, put_b)
    out["times"] = times
    return out


def _dist_train(rank, world, tmp) -> dict:
    """(b) llama3.2-3b at full width cut to TRAIN_CUT layers, fp32
    compute: one sharded train step under the "train" rules against the
    unsharded step from the same state and batch; then a checkpoint
    saved under these placements, restored under the elastic flip
    (`embed` -> None), and the next step from it against the unflipped
    run's."""
    from repro_torch import configs, tree as tree_mod
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.optim import adamw
    from repro_torch.sharding import partition
    cfg = dataclasses.replace(
        configs.get(LLAMA), n_layers=TRAIN_CUT, compute_dtype=torch.float32,
        kv_dtype=torch.float32, loss_chunk=0, remat="none")
    b = max(CUT_B, world)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=10)
    source = SyntheticSource(DataConfig(cfg.vocab, CUT_S, b, seed=0))
    tokens = [torch.from_numpy(source.batch(i)).to(DEVICE) for i in (0, 1)]
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   DEVICE)
    mesh = mesh_mod.make_mesh((world, 1), ("data", "model"))
    rules = partition.make_rules("train")
    flipped = partition.make_rules("train", overrides={"embed": None})
    put = lambda r, t: partition.distribute_tree(  # noqa: E731
        {"tokens": t}, {"tokens": ("batch", None)}, mesh, r)
    sharded = steps.shard_train_state(_clone(state), cfg, mesh, rules)
    one = steps.build_train_step(cfg, opt_cfg)
    step = steps.build_train_step(cfg, opt_cfg, mesh, rules)
    out = {"n_layers": TRAIN_CUT, "batch": b, "seq": CUT_S}
    m1, g1 = _spied_step(one, state, {"tokens": tokens[0]})
    m2, g2 = _spied_step(step, sharded, put(rules, tokens[0]))
    for k in ("loss", "grad_norm"):
        out[f"{k}_rel"] = abs(m2[k] - m1[k]) / abs(m1[k])
    out["grad_rel_l2_max"] = max(
        _rel_l2(partition.full(a), c) for a, c in zip(
            tree_mod.leaves(g2), tree_mod.leaves(g1)))
    del g1, g2
    # the step's time, both paths, from these states (CUDA events)
    out["step_ms"] = {
        "unsharded": _events_ms(lambda: one(state, {"tokens": tokens[1]})),
        "sharded": _events_ms(lambda: step(sharded,
                                           put(rules, tokens[1])))}
    # a checkpoint under these placements, restored under the flip
    mgr = CheckpointManager(Path(tmp) / "ckpt", keep_last=1)
    mgr.save(2, sharded, blocking=True)
    _, m_a = step(sharded, put(rules, tokens[0]))
    del sharded, state
    restored = mgr.restore(2, steps.abstract_train_state(cfg), DEVICE, mesh,
                           partition.tree_placements(
                               steps.train_state_axis_specs(cfg), flipped,
                               mesh))
    _, m_b = steps.build_train_step(cfg, opt_cfg, mesh, flipped)(
        restored, put(flipped, tokens[0]))
    out["elastic_loss"] = [float(m_a["loss"]), float(m_b["loss"])]
    out["elastic_loss_rel"] = abs(float(m_b["loss"]) - float(m_a["loss"])) \
        / abs(float(m_a["loss"]))
    return out


def _dropped(top_i, cap: int, n_experts: int) -> set:
    """The (token, expert) pairs past their expert's capacity, queue order
    token-major, as both MoE routes drop them (a token's own order of its
    top k, which fp32 noise can swap, moves none of them)."""
    t, k = top_i.shape
    flat = top_i.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, n_experts)
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    return {(int(i) // k, int(flat[i]))
            for i in (pos >= cap).nonzero().flatten()}


def _dist_moe(rank, world, tmp) -> dict:
    """(c) qwen3-moe-30b-a3b at full width cut to MOE_CUT layers: the
    forward on the sharded `moe_ep` (E / world experts a rank) against
    the one-device gather route, on the prompts of MOE_SEEDS (the
    launches counted on the first).  The two routes' combines add in
    another atomic order, and a router whose k-th and (k+1)-th
    probabilities tie within that noise may choose otherwise: as phase
    10's plain rerun, the sharded run is teacher-forced on the one-device
    run's experts where its own top-k set differs at a gap below TIE_GAP
    (`_Routes`), and a difference at a larger gap fails.  The dropped
    pairs are compared on the routes each run used."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import api, io, moe, stack
    from repro_torch.sharding import partition
    cfg = dataclasses.replace(_full_cfg(QWEN_MOE, "pallas"), n_layers=MOE_CUT)
    params = _params(cfg)
    mesh = mesh_mod.make_mesh((1, world), ("data", "model"))
    rules = partition.make_rules("serve")
    pd = partition.distribute_tree(params, api.param_specs(cfg), mesh, rules)
    spec = stack.moe_spec(cfg)
    cap = moe._capacity(BATCH * PROMPT, spec)     # a rank's tokens: all
    out = {"n_layers": MOE_CUT,
           "experts_per_rank": cfg.moe.n_experts // world,
           "hidden_max_abs": [], "routes": [], "dropped_pairs": [],
           "same_drops": [], "drops_order_free": [], "hidden_ok": True}
    for seed in MOE_SEEDS:
        routes = _Routes()
        batch = io.make_batch(cfg, io.smoke_cell("prefill", BATCH, PROMPT),
                              torch.Generator(device=DEVICE).manual_seed(seed))
        with torch.inference_mode():
            if seed == MOE_SEEDS[0]:
                _reset_launches()
            with routes.record("one"):
                h1, _ = stack.forward(params, cfg, batch)
            if seed == MOE_SEEDS[0]:
                out["launches_one"] = _read_launches()
            bd = partition.distribute_tree(
                batch, {"tokens": ("batch", None)}, mesh, rules)
            if seed == MOE_SEEDS[0]:
                _reset_launches()
            with routes.record("sharded", follow="one"), \
                    partition.use_rules(rules):
                h2, _ = stack.forward(pd, cfg, bd, mesh=mesh,
                                      batch_axes=rules.batch_axes)
            if seed == MOE_SEEDS[0]:
                out["launches"] = _read_launches()
            h2 = partition.full(h2)
            out["hidden_max_abs"].append(float((h2 - h1).abs().max()))
            out["hidden_ok"] &= bool(torch.allclose(h2, h1, atol=2e-5,
                                                    rtol=2e-5))
        diff = routes.differ("one", "sharded", MOE_CUT)
        out["routes"].append(diff)
        one = [_dropped(i, cap, spec.n_experts)
               for i, _, _ in routes.calls["one"]]
        used = [torch.where(pinned[:, None], ref, own)
                for (own, _, pinned), (ref, _, _) in
                zip(routes.calls["sharded"], routes.calls["one"])]
        out["same_drops"].append(
            one == [_dropped(i, cap, spec.n_experts) for i in used])
        # a token's own order of its k experts moves none of its drops
        out["drops_order_free"].append(all(
            _dropped(i.flip(-1), cap, spec.n_experts) == d
            for (i, _, _), d in zip(routes.calls["one"], one)))
        out["dropped_pairs"].append([len(d) for d in one])
    return out


def _dist_ssm(rank, world, tmp) -> dict:
    """(e) mamba2-780m at full width and depth: the forward over the mesh
    under the "serve" rules (the SSD kernel at every layer) against the
    one-device forward."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import api, io, stack
    from repro_torch.sharding import partition
    cfg = _full_cfg(MAMBA, "pallas")
    params = _params(cfg)
    batch = io.make_batch(cfg, io.smoke_cell("prefill", BATCH, PROMPT),
                          torch.Generator(device=DEVICE).manual_seed(1))
    mesh = mesh_mod.make_mesh((1, world), ("data", "model"))
    rules = partition.make_rules("serve")
    out = {}
    with torch.inference_mode():
        h1, _ = stack.forward(params, cfg, batch)
        pd = partition.distribute_tree(params, api.param_specs(cfg), mesh,
                                       rules)
        bd = partition.distribute_tree(batch, {"tokens": ("batch", None)},
                                       mesh, rules)
        _reset_launches()
        with partition.use_rules(rules):
            h2, _ = stack.forward(pd, cfg, bd, mesh=mesh,
                                  batch_axes=rules.batch_axes)
        out["launches"] = _read_launches()
        h2 = partition.full(h2)
        out["hidden_max_abs"] = float((h2 - h1).abs().max())
        out["hidden_ok"] = bool(torch.allclose(h2, h1, atol=2e-5, rtol=2e-5))
    return out


MOE_DENSE_NEW = 4    # (f)'s tokens: the prefill's and 3 decode steps'


def _dist_moe_dense(rank, world, tmp) -> dict:
    """(f) qwen3-moe-30b-a3b at full width cut to MOE_CUT layers served on
    the plain route, whose MoE is the one-hot oracle ("dense"), as `serve`
    runs it launched over several ranks (`serve_inputs`, `shard_inputs`,
    `generate(mesh, rules)`), against the unsharded plain serve of the
    same inputs."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.serve import (ServeRun, generate, serve_inputs,
                                          shard_inputs)
    from repro_torch.sharding import partition
    mesh = mesh_mod.make_mesh((1, world), ("data", "model"))
    rules = partition.make_rules("serve")
    run = ServeRun(arch=QWEN_MOE, reduced=False, batch=BATCH,
                   prompt_len=PROMPT, max_new_tokens=MOE_DENSE_NEW,
                   device=DEVICE, attn_impl="xla")
    with _depth_cut({QWEN_MOE: MOE_CUT}):
        cfg, params, prompt, extra = serve_inputs(run, DEVICE)
    out = {"n_layers": cfg.n_layers, "moe_impl": cfg.moe.impl}
    _, want, _, _ = generate(cfg, params, prompt, MOE_DENSE_NEW, extra)
    pd, prompt_d, extra_d = shard_inputs(cfg, params, prompt, extra, mesh,
                                         rules)
    _reset_launches()
    _, got, prefill_s, decode_s = generate(
        cfg, pd, prompt_d, MOE_DENSE_NEW, extra=extra_d, mesh=mesh,
        rules=rules)
    out["launches"] = _read_launches()
    out["max_abs"] = float((got - want).abs().max())
    out["ok"] = bool(torch.allclose(got, want, atol=1e-5, rtol=1e-5))
    out["finite"] = bool(torch.isfinite(got).all())
    out["wall"] = {"prefill_s": prefill_s, "decode_s": decode_s}
    return out


def _dist_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of phase 14: joins the NCCL group, runs (a)-(c) and (e),
    writes what it measured to `tmp/rank<r>.json`; a failed part is
    recorded with its traceback and the next part runs."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh_mod.init_distributed(DEVICE, store_path=str(Path(tmp) / "store"),
                              rank=rank, world_size=world)
    out = {"rank": rank, "world": world}
    for name, fn in (("serve", _dist_serve), ("train", _dist_train),
                     ("moe", _dist_moe), ("ssm", _dist_ssm),
                     ("moe_dense", _dist_moe_dense)):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        try:
            out[name] = fn(rank, world, tmp)
        except Exception:  # recorded; the next part still runs
            out[name] = {"error": traceback.format_exc()}
        out[name]["wall_s"] = time.perf_counter() - t0
        out[name]["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        gc.collect()
        torch.cuda.empty_cache()
        print(f"   rank {rank}: {name} {out[name]['wall_s']:.1f} s, "
              f"max_memory_allocated "
              f"{out[name]['max_memory_allocated_gb']:.2f} GB", flush=True)
    (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def phase_distribution(smoke: Smoke) -> None:
    """Phase 14: (a)-(c) and (e) on one spawned rank per GPU of the
    machine (NCCL), (d) a FOS slot over every GPU of the card's shell in
    this process."""
    import shutil
    import torch.multiprocessing as mp
    world = torch.cuda.device_count()
    print(f"   world size {world}; card: {card_line()}", flush=True)
    res = smoke.results.setdefault("distribution", {"world": world})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        torch.save(_KEPT["phase3_logits"], Path(tmp) / "phase3_logits.pt")
        mp.spawn(_dist_rank, args=(world, tmp), nprocs=world, join=True)
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["ranks"] = ranks
    layers = LAYERS[LLAMA]
    for r in ranks:
        tag = f"dist rank {r['rank']}/{world}"
        for part in ("serve", "train", "moe", "ssm", "moe_dense"):
            if "error" in r[part]:
                print(r[part]["error"])
            smoke.check(f"{tag}: {part} ran", "error" not in r[part])
        a, b, c, e = r["serve"], r["train"], r["moe"], r["ssm"]
        f = r["moe_dense"]
        if "error" not in f:
            _check_launches(smoke, f"{tag} (f) sharded moe oracle serve",
                            f["launches"],
                            {"decode_attention": 0, "flash_attention": 0,
                             "ssd_scan": 0})
            smoke.check(f"{tag} (f) {QWEN_MOE} cut to {f['n_layers']} on "
                        f"the plain route (moe {f['moe_impl']}): logits vs "
                        f"the unsharded plain serve (1e-5)",
                        f["ok"] and f["finite"]
                        and f["moe_impl"] == "dense",
                        f"max_abs {f['max_abs']:.3g}, wall {f['wall']}")
        if "error" not in a:
            _check_launches(smoke, f"{tag} (a) sharded serve, pallas",
                            a["launches_pallas"],
                            {"decode_attention": layers * (NEW - 1),
                             "flash_attention": 0, "ssd_scan": 0})
            smoke.check(f"{tag} (a) logits vs phase 3's (1e-5)",
                        a["pallas_vs_phase3_ok"],
                        f"max_abs {a['pallas_vs_phase3_max_abs']:.3g}")
            _check_launches(smoke, f"{tag} (a) sharded serve, xla",
                            a["launches_xla"],
                            {"decode_attention": 0, "flash_attention": 0,
                             "ssd_scan": 0})
            smoke.check(f"{tag} (a) update-inside body vs the plain "
                        f"unsharded rerun (1e-3)", a["xla_vs_plain_ok"],
                        f"max_abs {a['xla_vs_plain_max_abs']:.3g}")
            print(f"   {tag} (a) times: {a['times']}")
        if "error" not in b:
            for k in ("loss", "grad_norm"):
                smoke.check(f"{tag} (b) sharded step {k} vs unsharded "
                            f"(1e-5 rel)", b[f"{k}_rel"] <= 1e-5,
                            f"rel {b[f'{k}_rel']:.3g}")
            smoke.check(f"{tag} (b) every grad leaf (1e-4 rel L2)",
                        b["grad_rel_l2_max"] <= 1e-4,
                        f"worst {b['grad_rel_l2_max']:.3g}")
            smoke.check(f"{tag} (b) restored under the elastic flip: the "
                        f"next step's loss (1e-5)",
                        b["elastic_loss_rel"] <= 1e-5,
                        f"{b['elastic_loss']}, rel "
                        f"{b['elastic_loss_rel']:.3g}")
            print(f"   {tag} (b) step ms: {b['step_ms']}")
        if "error" not in c:
            _check_launches(smoke, f"{tag} (c) sharded moe forward",
                            c["launches"],
                            {"decode_attention": 0, "flash_attention": MOE_CUT,
                             "ssd_scan": 0})
            # the one-device forward runs the grouped expert product: its
            # capacity (320) is above a row tile
            _check_launches(smoke, f"{tag} (c) one-device moe forward",
                            c["launches_one"],
                            {"flash_attention": MOE_CUT,
                             "expert_gemm": 3 * MOE_CUT})
            smoke.check(f"{tag} (c) hidden state vs the one-device gather "
                        f"route (2e-5), two prompts", c["hidden_ok"],
                        f"max_abs {c['hidden_max_abs']}")
            for i, d in enumerate(c["routes"]):
                print(f"   {tag} (c) prompt {i + 1}: (token, expert) routes "
                      f"the sharded run chose otherwise per layer "
                      f"{d['per_sublayer']}, pinned at ties "
                      f"{d['pinned_per_sublayer']}; first {d['first']}")
            smoke.check(f"{tag} (c) routes differ only at ties (gap < "
                        f"{TIE_GAP:g}), the same dropped pairs, two prompts",
                        all(d["not_ties"] == 0
                            and d["calls"] == [MOE_CUT, MOE_CUT]
                            for d in c["routes"])
                        and all(c["same_drops"])
                        and all(c["drops_order_free"]),
                        f"not at ties {[d['not_ties'] for d in c['routes']]}"
                        f", dropped {c['dropped_pairs']} per layer, same "
                        f"{c['same_drops']}, order-free "
                        f"{c['drops_order_free']}")
        if "error" not in e:
            _check_launches(smoke, f"{tag} (e) sharded mamba forward",
                            e["launches"],
                            {"decode_attention": 0, "flash_attention": 0,
                             "ssd_scan": LAYERS[MAMBA]})
            smoke.check(f"{tag} (e) hidden state vs the one-device forward "
                        f"(2e-5)", e["hidden_ok"],
                        f"max_abs {e['hidden_max_abs']:.3g}")
    _part(smoke, "14d a FOS slot over every GPU",
          lambda: _dist_slot(smoke, res, world))


def _dist_slot(smoke, res, world) -> None:
    """(d) lm-forward at llama3.2-3b's full width through the daemon on a
    slot over every GPU of the card's shell: phase 8 (d)'s weights and
    tokens, a weight replica and a stream on each GPU, the rows split over
    them."""
    from repro_torch.core import Daemon, ImplAlt, ModuleDescriptor, Shell, \
        default_registry, uniform_shell
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    reg = default_registry()
    reg.register_module(ModuleDescriptor(
        "lm-forward-full", entrypoint="chip_smoke:build_lm_forward_full",
        impls=(ImplAlt("x1", 1, 20.0),)))
    shell = Shell(uniform_shell("gpus", (1, world), 1))
    slot = shell.slots[0]
    d = Daemon(shell, reg)
    try:
        mod = d._module("lm-forward-full")
        mod.program(slot, 1)
        mod._host_weights[1] = _KEPT["lm_host_weights"]
        tokens = _KEPT["lm_tokens"]
        _reset_launches()
        t0 = time.perf_counter()
        h = d.submit("lm", "lm-forward-full", [(t,) for t in tokens])
        (outs,) = _resolved([h])
        wall = time.perf_counter() - t0
        launches = _read_launches()
        (pl,) = d._placements.values()
    finally:
        d.shutdown()
    _check_launches(smoke, "14d slot over every GPU: lm-forward", launches,
                    {"decode_attention": 0,
                     "flash_attention": 28 * (len(tokens) + 1) * world,
                     "ssd_scan": 0})
    same = all(torch.equal(a.cpu(), b) for a, b in
               zip(outs, _KEPT["lm_logits"]))
    smoke.check("14d slot over every GPU: logits equal phase 8 (d)'s",
                same and len(outs) == len(_KEPT["lm_logits"]))
    smoke.check("14d slot over every GPU: a replica and a stream on each",
                len(pl.replicas) == world == len(slot.streams)
                and [str(x.device) for x in (
                    next(_leaves(r)) for r in pl.replicas)]
                == [str(dv) for dv in slot.run_devices])
    res["slot"] = {"gpus": world, "launches": launches, "wall_s": wall,
                   "equal_to_phase8": same}
    print(f"   14d: {world} GPU(s), {len(outs)} chunks in {wall:.2f} s, "
          f"launches {launches}")


# ---------------------------------------------------------------------------
# phase 15: the dry run against the card
# ---------------------------------------------------------------------------

# (a)'s subprocess: the dry run of llama3.2-3b's cells on 256 fake ranks
DRYRUN_TIMEOUT_S = 150
# the products torch.profiler counts FLOPs for (with_flops) that the dry
# run counts too (`torch.utils.flop_counter`'s registry); the profiler
# also counts the elementwise aten::mul and aten::add, the dry run not
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def phase_dryrun(smoke: Smoke) -> None:
    """(a) `python -m repro_torch.launch.dryrun` over llama3.2-3b's four
    cells in a subprocess that sees no GPU, while (b) and (c) run the
    counting code at world size 1 against the card: phase 13's train step
    and phase 3's prefill, counted FLOPs against torch.profiler's and
    (the step) the predicted argument + temp bytes against
    max_memory_allocated."""
    import os
    res = smoke.results.setdefault("dryrun", {})
    res["card"] = card_line()
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", LLAMA,
         "--shape", "all", "--mesh", "single", "--out", out_dir],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        _part(smoke, "15b train step: counted vs the card",
              lambda: _dryrun_train(smoke, res))
        _part(smoke, "15c prefill: counted vs the card",
              lambda: _dryrun_prefill(smoke, res))
    finally:
        left = max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0))
        try:
            log, _ = proc.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
    _part(smoke, "15a dry run of the llama cells",
          lambda: _dryrun_cells(smoke, res, proc.returncode, log, out_dir,
                                time.perf_counter() - t0))


def _dryrun_cells(smoke, res, rc, log, out_dir, wall) -> None:
    from repro_torch.launch import dryrun
    from repro_torch.models.api import SHAPE_CELLS
    print("\n".join(log.splitlines()[-30:]))
    smoke.check("15a dry run: exit code 0", rc == 0,
                f"rc={rc} after {wall:.1f} s")
    cells = res["cells"] = {"wall_s": wall}
    for name in SHAPE_CELLS:
        path = Path(out_dir) / "single" / LLAMA / f"{name}.json"
        if not path.exists():
            smoke.check(f"15a dry run: {name} written", False)
            continue
        cell = json.loads(path.read_text())
        if name == "long_500k":
            want = {"arch": LLAMA, "cell": name, "mesh": "single",
                    "skipped": dryrun.FULL_ATTENTION_SKIP, "tag": "baseline"}
            smoke.check("15a dry run: long_500k skipped as the reference",
                        cell == want, json.dumps(cell))
            continue
        roof = cell.get("roofline", {})
        terms = [roof.get(k) for k in ("compute_s", "memory_s",
                                       "collective_s", "roofline_fraction")]
        ok = all(isinstance(t, float) and np.isfinite(t) and t > 0
                 for t in terms) and cell.get("chips") == 256
        cells[name] = {"roofline": roof, "memory": cell["full"]["memory"],
                       "trace_s": cell["full"]["trace_s"],
                       "attn_split": cell.get("attn_split")}
        smoke.check(f"15a dry run: {name} has roofline terms", ok,
                    f"compute {terms[0]!r} s, memory {terms[1]!r} s, "
                    f"collective {terms[2]!r} s, fraction {terms[3]!r}")
        if name == "train_4k":
            _dryrun_train_4k(smoke, cells[name])


def _dryrun_train_4k(smoke, cell) -> None:
    """llama3.2-3b train_4k: attention split by whole heads over the 16
    "model" ranks (rank 0: 2 q heads, 1 kv head), so a rank's useful
    share of its FLOPs is at least 0.40 (0.097 with attention whole)."""
    useful = cell["roofline"].get("useful_flops_ratio", 0.0)
    split = cell.get("attn_split") or {}
    mem = cell["memory"]
    gb = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 1e9
    print(f"   15a train_4k: useful FLOPs {useful!r}, rank 0 attention "
          f"{split}, args + temp {gb!r} GB "
          f"(args {mem['argument_size_in_bytes'] / 1e9!r}, temp "
          f"{mem['temp_size_in_bytes'] / 1e9!r})")
    smoke.check("15a train_4k: useful FLOPs >= 0.40", useful >= 0.40,
                f"{useful:.4f}")
    smoke.check("15a train_4k: rank 0 computes 2 q heads and 1 kv head",
                split.get("q_heads") == 2 and split.get("kv_heads") == 1,
                json.dumps(split))


def _profiled_matmul_flops(fn) -> float | str:
    """torch.profiler's FLOPs of the matrix products in one call of fn."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        fn()
        torch.cuda.synchronize()
    flops = sum(e.flops for e in prof.key_averages() if e.key in MATMUL_OPS)
    return float(flops) if flops else "not measured"


def _counted_vs_profiled(smoke, what, counted, profiled) -> None:
    if not isinstance(profiled, float):
        smoke.check(f"{what}: torch.profiler counted FLOPs", False,
                    str(profiled))
        return
    rel = abs(counted - profiled) / profiled
    smoke.check(f"{what}: counted FLOPs within 2% of torch.profiler's",
                rel <= 0.02, f"{counted!r} vs {profiled!r}, rel {rel:.3g}")


def _dryrun_train(smoke, res) -> None:
    """Phase 13's step (llama3.2-3b at full width and depth, B=2, S=512,
    fp32 masters and bf16 compute, remat and loss chunking off as the
    driver sets them) without a mesh: traced, then run on the card."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, roofline_model, steps
    from repro_torch.models.api import ShapeCell
    cfg = dataclasses.replace(configs.get(LLAMA), loss_chunk=0,
                              remat="none")
    cell = ShapeCell("phase13_train", TRAIN_S, TRAIN_B, "train")
    _, info = dryrun.trace_cell(cfg, cell, None, None)
    mem, flops = info["memory"], info["cost"]["flops"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]

    step = steps.step_for_cell(cfg, cell, None, None)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    state = steps.init_train_state(cfg, gen, DEVICE)
    batch = {"tokens": torch.randint(0, cfg.vocab, (TRAIN_B, TRAIN_S),
                                     generator=gen, device=DEVICE,
                                     dtype=torch.int32)}
    _reset_launches()
    step(state, batch)                   # cuBLAS handles and workspaces
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = [_events_ms(lambda: step(state, batch)) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated()
    profiled = _profiled_matmul_flops(lambda: step(state, batch))
    launches = _read_launches()
    del state, batch
    step_ms = statistics.median(ms)
    terms = roofline_model.terms_from_costs(
        flops, info["cost"]["bytes accessed"], 0.0, 1, cfg, cell)
    measured = peak - before
    out = res["train"] = {
        "counted_flops": flops, "profiler_matmul_flops": profiled,
        "predicted_argument_bytes": mem["argument_size_in_bytes"],
        "predicted_temp_bytes": mem["temp_size_in_bytes"],
        "predicted_bytes": predicted, "max_memory_allocated": peak,
        "allocated_before_state": before, "allocated_after_warmup": base,
        "measured_bytes": measured, "step_ms": ms,
        "achieved_tflop_per_s": flops / (step_ms / 1e3) / 1e12,
        "roofline": terms.to_dict(),
        "measured_roofline_fraction": terms.model_flops_global / (
            roofline_model.PEAK_FLOPS * step_ms / 1e3),
        "roofline_step_share": terms.step_time_s / (step_ms / 1e3),
        "launches": launches}
    print(f"   15b train: counted {flops!r} FLOP, profiler {profiled!r}; "
          f"predicted args {mem['argument_size_in_bytes'] / 1e9:.3f} GB + "
          f"temp {mem['temp_size_in_bytes'] / 1e9:.3f} GB = "
          f"{predicted / 1e9:.3f} GB, measured {measured / 1e9:.3f} GB "
          f"(max_memory_allocated {peak / 1e9:.3f} GB); step {step_ms:.1f} "
          f"ms, {out['achieved_tflop_per_s']:.1f} TFLOP/s; roofline "
          f"compute {terms.compute_s * 1e3:.2f} ms, memory "
          f"{terms.memory_s * 1e3:.2f} ms, roofline_fraction "
          f"{terms.roofline_fraction:.3f}, measured fraction "
          f"{out['measured_roofline_fraction']:.3f} [{res['card']}]",
          flush=True)
    _counted_vs_profiled(smoke, "15b train", flops, profiled)
    rel = abs(predicted - measured) / measured
    out["memory_rel_err"] = rel
    smoke.check("15b train: predicted args + temp within 10% of the "
                "measured peak", rel <= 0.10, f"rel {rel:.3g}")
    _check_launches(smoke, "15b train", launches,
                    {name: 0 for name in launches})


def _dryrun_prefill(smoke, res) -> None:
    """Phase 3's prefill shape (B=4, 1024 tokens) in fp32 on plain
    attention, as the reference's prefill: traced, then run on the
    card."""
    from repro_torch.launch import dryrun, roofline_model, steps
    from repro_torch.models.api import ShapeCell
    cfg = _full_cfg(LLAMA, "xla")
    cell = ShapeCell("phase3_prefill", PROMPT, BATCH, "prefill")
    _, info = dryrun.trace_cell(cfg, cell, None, None)
    flops = info["cost"]["flops"]
    step = steps.step_for_cell(cfg, cell, None, None)
    params = _params(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                                     generator=gen, device=DEVICE,
                                     dtype=torch.int32)}
    _reset_launches()
    with torch.inference_mode():
        step(params, batch)
        ms = [_events_ms(lambda: step(params, batch)) for _ in range(5)]
        profiled = _profiled_matmul_flops(lambda: step(params, batch))
    launches = _read_launches()
    del params
    prefill_ms = statistics.median(ms)
    terms = roofline_model.terms_from_costs(
        flops, info["cost"]["bytes accessed"], 0.0, 1, cfg, cell)
    out = res["prefill"] = {
        "counted_flops": flops, "profiler_matmul_flops": profiled,
        "prefill_ms": ms,
        "achieved_tflop_per_s": flops / (prefill_ms / 1e3) / 1e12,
        "roofline": terms.to_dict(),
        "measured_roofline_fraction": terms.model_flops_global / (
            roofline_model.PEAK_FLOPS * prefill_ms / 1e3),
        "launches": launches}
    print(f"   15c prefill: counted {flops!r} FLOP, profiler {profiled!r}; "
          f"{prefill_ms:.1f} ms, {out['achieved_tflop_per_s']:.1f} TFLOP/s "
          f"(fp32); roofline compute {terms.compute_s * 1e3:.2f} ms, "
          f"memory {terms.memory_s * 1e3:.2f} ms [{res['card']}]",
          flush=True)
    _counted_vs_profiled(smoke, "15c prefill", flops, profiled)
    _check_launches(smoke, "15c prefill", launches,
                    {name: 0 for name in launches})


# ---------------------------------------------------------------------------
# phase 16: the examples
# ---------------------------------------------------------------------------

# what `multi_tenant_serving` prints that does not depend on timing, as the
# reference example prints it on one device (tests/test_torch_examples.py)
TENANT_LINES = [
    "fabric: example -> [('shellA', 1)]; modules: ['lm-forward', "
    "'mandelbrot', 'matmul', 'sobel']",
    "  alice/mandelbrot: 4 chunks done (out[0] shape (256, 256))",
    "  bob/sobel: 4 chunks done (out[0] shape (1024, 1024))",
    "  carol/lm-forward: 2 chunks done (out[0] shape (8, 256)) "
    "(priority=3)",
    "  dave/burst0: 1 chunks done (out[0] shape (1024, 1024)) (priority=5)",
    "  dave/burst1: 1 chunks done (out[0] shape (1024, 1024)) (priority=5)",
    "  dave/burst2: 1 chunks done (out[0] shape (1024, 1024)) (priority=5)",
    "erin/sobel admission: DEGRADE -> 'sobel-lite'",
    "slo  : erin submitted=1 admitted=0 degraded=1 rejected=0",
    "obs  : submitted=7 (admitted=6 degraded=1 rejected=0)"]


def _steady_lines(text: str) -> list:
    out = []
    for line in text.splitlines():
        if line.startswith("fabric:"):
            out.append(line)
        elif re.match(r"  \w+/[\w-]+: ", line):
            out.append(re.sub(r" at t=[\d.]+s", "", line))
        elif line.startswith("erin/sobel admission:"):
            out.append(line.split(" (")[0])
        elif line.startswith("slo  :"):
            out.append(line.split(" attainment=")[0])
        elif line.startswith("obs  :"):
            out.append(line.split(" chunks=")[0])
    return out


def _example(smoke, res, name, argv, counted=True):
    """Run `repro_torch.examples.<name>.main(argv)` with its output
    captured (and then printed), the launch counts set to 0 before it
    and read after; returns (what main returned, its output)."""
    import importlib
    import io
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    buf = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    wall = time.perf_counter() - t0
    if counted:
        res["launches"][name] = _read_launches()
    text = buf.getvalue()
    print("\n".join("   | " + line for line in text.splitlines()[-14:]))
    res["wall_s"][" ".join([name] + argv)] = wall
    return out, text


def phase_examples(smoke: Smoke) -> None:
    """Phase 16: the four examples on the card with the checks of their
    CPU test that hold on any device; `elastic_train --m100` measured."""
    import math
    import os
    res = smoke.results.setdefault("examples", {"launches": {},
                                                "wall_s": {}})
    res["card"] = card_line()
    cuda = ["--device", DEVICE]

    def quickstart():
        out, _ = _example(smoke, res, "quickstart", cuda)
        losses = [x for _, x in out["train"]["loss"]]
        smoke.check("16 quickstart: a finite training loss that falls",
                    all(math.isfinite(x) for x in losses)
                    and losses[-1] < losses[0],
                    f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        smoke.check("16 quickstart: 16 tokens served",
                    out["serve"]["tokens"].shape == (2, 16))
        n = res["launches"]["quickstart"]["decode_attention"]
        smoke.check("16 quickstart: its serve launched the decode kernel",
                    n > 0, f"{n} launches")

    def multi_tenant():
        cwd = os.getcwd()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_tenants_")
        os.chdir(tmp)
        try:
            out, text = _example(smoke, res, "multi_tenant_serving", cuda)
            trace = Path(tmp) / "trace.json"
            smoke.check("16 multi_tenant_serving: trace.json written",
                        trace.exists())
        finally:
            os.chdir(cwd)
        lines = _steady_lines(text)
        want = (TENANT_LINES if torch.cuda.device_count() == 1
                else TENANT_LINES[1:])
        got = lines if torch.cuda.device_count() == 1 else lines[1:]
        smoke.check("16 multi_tenant_serving: the lines that do not depend "
                    "on timing are the reference's", got == want,
                    json.dumps([g for g in got if g not in want]))
        n = res["launches"]["multi_tenant_serving"]["flash_attention"]
        smoke.check("16 multi_tenant_serving: carol's lm-forward launched "
                    "the flash kernel", n > 0, f"{n} launches")

    def tour():
        out, text = _example(smoke, res, "fos_registry_tour", cuda)
        cpu, _ = _example(smoke, res, "fos_registry_tour",
                          ["--device", "cpu"], counted=False)
        hits = re.findall(r"cache_hit=(\w+)", text)
        smoke.check("16 fos_registry_tour: compile, then a cache hit",
                    hits == ["False", "True"], str(hits))
        differ = float(np.mean(out["escape"] != cpu["escape"]))
        smoke.check("16 fos_registry_tour: escape counts within 1% of "
                    "pixels of the CPU's", out["escape"].shape == (256, 256)
                    and differ <= 0.01, f"{differ:.4%} differ, mean "
                    f"{float(out['escape'].mean())!r} vs "
                    f"{float(cpu['escape'].mean())!r}")
        smoke.check("16 fos_registry_tour: the CPU's signature",
                    out["signature"] == cpu["signature"])

    def elastic(argv, tag):
        torch.cuda.reset_peak_memory_stats()
        hist, _ = _example(smoke, res, "elastic_train", cuda + argv)
        steps = 40
        res[tag] = {"steps_per_sec": hist["steps_per_sec"],
                    "max_memory_allocated_gb":
                    torch.cuda.max_memory_allocated() / 1e9,
                    "restarts": hist["restarts"],
                    "elastic_switches": hist["elastic_switches"],
                    "final_step": hist["final_step"],
                    "loss": [hist["loss"][0][1], hist["loss"][-1][1]]}
        print(f"   16 {tag}: {json.dumps(res[tag])}; card: {card_line()}")
        smoke.check(f"16 {tag}: one restart, one elastic switch, every "
                    f"step", hist["restarts"] == 1
                    and hist["elastic_switches"] == 1
                    and hist["final_step"] == steps)

    _part(smoke, "16 quickstart", quickstart)
    _part(smoke, "16 multi_tenant_serving", multi_tenant)
    _part(smoke, "16 fos_registry_tour", tour)
    _part(smoke, "16 elastic_train", lambda: elastic([], "elastic_train"))
    _part(smoke, "16 elastic_train --m100",
          lambda: elastic(["--m100"], "elastic_train_m100"))


def time_ms(fn, flush, reps=30, warmup=3) -> float:
    """Median device time of fn() over `reps` runs, CUDA events around each
    run, the L2 cache flushed (a 256 MB write) before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# cycles of the `torch.cuda._sleep` spin that device_time enqueues before
# each timed call: ~1 ms at the H100's clocks, longer than any wrapper's
# host work (its checks, tensor maps and launches)
SLEEP_CYCLES = 2_000_000


def device_time(fn, flush, kernel_name=None, calls=20,
                clean_l2=False) -> dict:
    """Device-only time of one call of fn() (`ms`), and with `kernel_name`
    the device kernels it enqueues.

    `ms` is the median over `calls` calls of CUDA events recorded around
    fn() alone while the card is still busy with a `torch.cuda._sleep`
    spin the host enqueued first: the host has enqueued all of fn()'s work
    before the card reaches the first event, so the events time the
    device's work only, every kernel of it, and not the wrapper's host
    cost.  The L2 is flushed before each call: by time_ms's 256 MB write,
    which leaves dirty lines whose write-back the next kernel pays, or with
    `clean_l2` by a 256 MB read, which leaves clean lines, as the weight
    reads before attention in a decode step do.

    `kernels_per_call`: the kernels whose name holds `kernel_name` among
    the nodes of one call captured into a CUDA graph (`graph_kernels`).
    torch.profiler is not used for it: in a process that has run for a
    while it drops kernel records, more the longer it runs
    (`profiler_census`).  `by_kernel`: the profiler's mean device time of
    one launch of each such kernel, by name, over `calls` calls (a mean
    over the records it kept)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(calls):
        if clean_l2:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out = {"ms": statistics.median(times)}
    if kernel_name is None:
        return out
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and kernel_name in e.key \
                and e.count:
            # demangled name up to its argument list
            name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                          e.key)
            by_kernel[name] = e.self_device_time_total / 1e3 / e.count
    out.update(kernels_per_call=graph_kernels(fn, kernel_name),
               by_kernel=by_kernel)
    return out


def graph_kernels(fn, kernel_name) -> int:
    """How many kernels whose name holds `kernel_name` one call of fn()
    enqueues: the call captured into a CUDA graph (relaxed capture: the
    wrappers set function attributes and make tensor maps on the host while
    they launch), its kernel nodes read from the graph's DOT dump."""
    import warnings
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # never instantiated
    graph.enable_debug_mode()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the debug API's beta warning
        path = Path(tmp) / "call.dot"
        graph.debug_dump(str(path))
        dot = path.read_text()
    del graph
    labels = re.findall(r'"graph_\d+_node_\d+"\s*\[(.*?)\];', dot, re.S)
    return sum("KERNEL" in label and kernel_name in label
               for label in labels)


def _launches(smoke, path, name):
    """A kernel's launches in the main-path run that drives it."""
    return smoke.results.get("launches", {}).get(path, {}).get(name)


def phase_times(smoke: Smoke) -> None:
    flush = torch.empty(64 * 2 ** 20, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    f32 = torch.float32
    cfg = _full_cfg(LLAMA, "pallas")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = hd ** -0.5
    kernels = []
    with torch.inference_mode():
        # decode: a mid-run step of the serving path; nested, the same at
        # jamba's and qwen3-moe's groupings (g=4 on 8 kv heads, g=8 on 4)
        # and at whisper's and phi-3-vision's MHA heads (hd 64 and 96),
        # and nemotron-h's (g=16 on 2 kv heads) at the nemotronh.prefill
        # cell's cache, filled to a mid-length and to a full prompt
        kernels.append(_decode_entry(smoke, gen, flush, hq, hkv, hd, LLAMA))
        for arch in (JAMBA, QWEN_MOE, WHISPER, PHI3V):
            c = _full_cfg(arch, "pallas")
            kernels[-1][arch] = _decode_entry(smoke, gen, flush, c.n_heads,
                                              c.n_kv_heads, c.head_dim, arch)
        c = _full_cfg(NEMOTRON, "pallas")
        for key, length in ((NEMOTRON, 2305), (f"{NEMOTRON} full", 4097)):
            kernels[-1][key] = _decode_entry(
                smoke, gen, flush, c.n_heads, c.n_kv_heads, c.head_dim,
                NEMOTRON, s_cache=4112, length=length)
        # flash: the full-width cache-free forward's attention, in fp32 (the
        # main path) and in bf16 (nested in the fp32 entry; also at the
        # lm-forward module's shape), and in fp32 at jamba's, qwen3-moe's,
        # whisper's and phi-3-vision's heads (nested)
        kernels.append(_flash_entry(smoke, gen, flush, hq, hkv, hd, scale,
                                    f32))
        kernels[-1]["bf16"] = _flash_entry(smoke, gen, flush, hq, hkv, hd,
                                           scale, torch.bfloat16)
        kernels[-1]["bf16_lm_forward"] = _flash_lm_shape(smoke)
        for arch in (JAMBA, QWEN_MOE, WHISPER, PHI3V):
            c = _full_cfg(arch, "pallas")
            kernels[-1][arch] = _flash_entry(
                smoke, gen, flush, c.n_heads, c.n_kv_heads, c.head_dim,
                c.head_dim ** -0.5, f32, arch)
        # and in fp32 at the served prefills of the benchmark's attention
        # cells (qwen3-moe's 32 / 4 heads, nemotron-h's 32 / 2; B=4 at a
        # middle and the longest length of their mix), launched once an
        # attention layer of each prefill
        for arch in (QWEN_MOE, NEMOTRON):
            c = _full_cfg(arch, "pallas")
            for s in CELL_PREFILL_S:
                kernels[-1][f"{arch} prefill S={s}"] = _flash_shape_entry(
                    smoke, gen, flush, BATCH, s, c.n_heads, c.n_kv_heads,
                    c.head_dim, c.head_dim ** -0.5, f32,
                    _launches(smoke, f"serve {arch}", "flash_attention"))
        # the windowed one at the trinity.prefill cell's prefills (B=2, a
        # middle length of its mix and its longest, W=2048), launched once
        # a window layer of each prefill
        for b, s, w in WINDOW_CASES[:2]:
            entry = _flash_window_entry(smoke, gen, flush, b, s, w)
            if kernels[-1]["name"] != "flash_window":
                kernels.append(entry)
            else:
                kernels[-1][f"S={s}"] = entry
        # ssd_scan: one layer of the full-width mamba2-780m prefill, and
        # (nested) of jamba's and of nemotron-h's (8 B/C groups)
        kernels.append(_ssd_entry(smoke, gen, flush, MAMBA))
        for arch in (JAMBA, NEMOTRON):
            kernels[-1][arch] = _ssd_entry(smoke, gen, flush, arch)
        # expert_gemm: the grouped expert product at phase 2's shapes,
        # qwen3-moe's gate and up products at S=2304 first, the rest nested
        for arch in (QWEN_MOE, NEMOTRON):
            for s in CELL_PREFILL_S:
                for second in (False, True):
                    entry = _expert_entry(smoke, flush, arch, s, second)
                    if kernels[-1]["name"] != "expert_gemm":
                        kernels.append(entry)
                    else:
                        sh = entry["shape"]
                        kernels[-1][f"{arch} S={s} K={sh['k']} "
                                    f"N={sh['n']}"] = entry
        for entry in kernels:       # every main-path run that launched it
            entry["launches_by_path"] = {
                path: counts[entry["name"]] for path, counts in
                smoke.results.get("launches", {}).items()
                if counts.get(entry["name"])}
        smoke.results["kernels"] = kernels
    for arch in (LLAMA, MAMBA):
        _model_times(smoke, flush, arch)


def _decode_entry(smoke, gen, flush, hq, hkv, hd, arch,
                  s_cache=PROMPT + NEW, length=PROMPT + NEW // 2) -> dict:
    """The decode kernel's `kernels`-line entry at a step of serving `arch`
    (by default mid-run: cache 1056 rows, 1040 valid), fp32."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops as da
    f32, scale = torch.float32, hd ** -0.5
    q = _randn(gen, (BATCH, hq, hd), f32)
    k = _randn(gen, (BATCH, s_cache, hkv, hd), f32)
    v = _randn(gen, (BATCH, s_cache, hkv, hd), f32)
    kq, kk, kv = (q[:, :, None], k[:, :length].transpose(1, 2),
                  v[:, :length].transpose(1, 2))
    nbytes = 4 * (2 * BATCH * length * hkv * hd + 2 * BATCH * hq * hd)
    flops = 4 * BATCH * hq * length * hd
    return _kernel_entry(
        smoke, flush, "decode_attention",
        "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/decode_attention.py:63",
        _launches(smoke, f"serve {arch}", "decode_attention"),
        lambda: da.decode_attention(q, k, v, length, scale=scale),
        lambda: da.decode_attention_plain(q, k, v, length, scale=scale),
        lambda: F.scaled_dot_product_attention(kq, kk, kv, scale=scale,
                                               enable_gqa=True),
        "decode_kernel", 1, nbytes, flops,
        {"b": BATCH, "hq": hq, "hkv": hkv, "hd": hd, "s_cache": s_cache,
         "length": length, "dtype": "float32"})


def _ssd_entry(smoke, gen, flush, arch) -> dict:
    """The SSD kernel's `kernels`-line entry at one layer of `arch`'s
    full-width prefill, seeded from the (zero) cache state as the serving
    path seeds it."""
    from repro_torch.kernels.ssd_scan import ops as ssd
    f32 = torch.float32
    ms = _full_cfg(arch, "pallas").mamba_spec
    h, p, g, n, chunk = (ms.n_heads, ms.headdim, ms.n_groups, ms.d_state,
                         ms.chunk)
    args = _ssd_inputs(gen, BATCH, PROMPT, h, p, g, n, f32)
    init = torch.zeros((BATCH, h, p, n), device=DEVICE)
    got = ssd.ssd(*args, chunk=chunk, impl="pallas", initial_state=init)
    want = ssd.ssd(*args, chunk=chunk, impl="xla", initial_state=init)
    err_s, ok_s = err_within(got[1], want[1], SSD_TOL[f32][1])
    smoke.check(f"ssd_scan: timed inputs vs plain (state) h={h} n={n}", ok_s,
                f"max_abs_err={err_s:.3g}")
    # x, dt, B, C and the initial state read once, y and the state written
    # once
    nbytes = 4 * (2 * BATCH * PROMPT * h * p + BATCH * PROMPT * h
                  + 2 * BATCH * PROMPT * g * n + h + 2 * BATCH * h * p * n)
    # per chunk: C.B^T over the causal triangle once per (batch, group),
    # the score.x product over the triangle, C.S and the state update per
    # (batch, head)
    tri = chunk * (chunk + 1) // 2
    n_chunks = -(-PROMPT // chunk)
    flops = n_chunks * BATCH * (2 * n * tri * g
                                + h * (2 * p * tri + 4 * chunk * n * p))
    return _kernel_entry(
        smoke, flush, "ssd_scan",
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/ssd_scan.py:69",
        _launches(smoke, f"serve {arch}", "ssd_scan"),
        lambda: ssd.ssd(*args, chunk=chunk, impl="pallas",
                        initial_state=init)[0],
        lambda: ssd.ssd(*args, chunk=chunk, impl="xla",
                        initial_state=init)[0],
        None,
        # all four phases' kernels (ssd_cb, ssd_chunk_state,
        # ssd_state_pass, ssd_chunk_scan)
        "ssd_", 4, nbytes, flops,
        {"b": BATCH, "L": PROMPT, "h": h, "p": p, "g": g, "n": n,
         "chunk": chunk, "dtype": "float32"}, plain_reps=20,
        library_note="none: no single PyTorch call computes an SSD scan")


# the shares of its slots each expert holds in the grouped product's
# balanced sweep
BALANCED_SHARES = (0.4, 0.5, 0.6, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95, 1.0)


def _expert_entry(smoke, flush, arch, s, second) -> dict:
    """The grouped expert product's entry at `arch`'s expert layer in a
    B=4 prefill of s tokens (`_expert_operands`), on the dispatch's
    counts: the bound is fp32 FFMA over the FLOPs of the occupied rows,
    2 K N sum(counts); `tile_waste` the rows the 64-row tiles compute over
    the occupied ones.  `full`: the device time at every slot occupied;
    `balanced`: at each of BALANCED_SHARES, every expert the same count;
    each against torch.bmm's device time (which computes every slot
    whatever the counts), and `break_even_computed_share`: the computed
    share at which the two take the same time, interpolated between the
    sweep's points (None where the sweep does not cross it)."""
    from repro_torch.kernels.expert_gemm import ops as eg
    x, w, counts = _expert_operands(arch, s, second, 12)
    e, cap, k = x.shape
    n = w.shape[2]
    occupied, computed = int(counts.sum()), int(eg.computed_rows(counts))
    # the weights once, x's occupied rows, every row of y
    nbytes = 4 * (e * k * n + occupied * k + e * cap * n)
    entry = _kernel_entry(
        smoke, flush, "expert_gemm",
        "src/repro_torch/kernels/expert_gemm/csrc/expert_gemm.cu",
        "none: XLA's batched matmul over every slot "
        "(src/repro/models/moe.py::_expert_ffn)",
        _launches(smoke, f"serve {arch}", "expert_gemm"),
        lambda: eg.expert_gemm(x, w, counts),
        lambda: eg.expert_gemm_plain(x, w, counts),
        lambda: torch.bmm(x, w), "expert_gemm_kernel", 1, nbytes,
        2 * k * n * occupied,
        {"arch": arch, "s": s, "e": e, "cap": cap, "k": k, "n": n,
         "dtype": "float32"}, plain_reps=5)
    library = entry["library_device_ms"]

    def timed(c):
        ms = device_time(lambda: eg.expert_gemm(x, w, c), flush)["ms"]
        return {"occupied_share": int(c.sum()) / (e * cap),
                "computed_share": int(eg.computed_rows(c)) / (e * cap),
                "device_ms": ms, "vs_library": ms / library,
                "tflop_per_s": 2 * k * n * int(c.sum()) / ms / 1e9}
    entry.update(occupied_rows=occupied, computed_rows=computed,
                 slots=e * cap, tile_waste=computed / occupied,
                 tflop_per_s=2 * k * n * occupied / entry["device_ms"] / 1e9,
                 vs_library=entry["device_ms"] / library,
                 full=timed(torch.full_like(counts, cap)))
    entry["balanced"] = [
        timed(torch.full_like(counts, round(share * cap)))
        for share in BALANCED_SHARES]
    pts = sorted((p["computed_share"], p["vs_library"])
                 for p in entry["balanced"])
    entry["break_even_computed_share"] = next(
        (s0 + (1 - r0) * (s1 - s0) / (r1 - r0)
         for (s0, r0), (s1, r1) in zip(pts, pts[1:]) if r0 < 1 <= r1), None)
    print(f"   expert_gemm {arch} S={s} cap={cap} K={k} N={n}: "
          f"{entry['vs_library']:.3f}x torch.bmm on the dispatch's counts "
          f"({occupied / (e * cap):.3f} occupied, tile waste "
          f"{entry['tile_waste']:.3f}), {entry['full']['vs_library']:.3f}x "
          f"at full occupancy, break-even at "
          f"{entry['break_even_computed_share']} computed", flush=True)
    del x, w
    return entry


def _flash_entry(smoke, gen, flush, hq, hkv, hd, scale, dtype,
                 arch=LLAMA) -> dict:
    """The flash kernel's `kernels`-line entry at the full-width forward
    shape of `arch` (llama3.2-3b's by default) in `dtype`; the forwards run
    in fp32, so a bf16 entry has no main-path launches."""
    launches = (_launches(smoke, f"forward {arch}", "flash_attention")
                if dtype == torch.float32 else None)
    return _flash_shape_entry(smoke, gen, flush, BATCH, PROMPT, hq, hkv, hd,
                              scale, dtype, launches)


def _flash_shape_entry(smoke, gen, flush, b, s, hq, hkv, hd, scale, dtype,
                       launches) -> dict:
    """The flash kernel's entry at [b, s] with hq / hkv heads of hd in
    `dtype`: fp32 on the mma.sync kernel, bf16 on the wgmma one, whose
    design bound (P.V in two passes: 1.5x the FLOP) stands beside the
    FLOP-only one."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    q = _randn(gen, (b, s, hq, hd), dtype)
    k = _randn(gen, (b, s, hkv, hd), dtype)
    v = _randn(gen, (b, s, hkv, hd), dtype)
    nbytes = q.element_size() * (2 * b * s * hq * hd + 2 * b * s * hkv * hd)
    flops = 4 * b * hq * hd * (s * (s + 1) // 2)
    bf16 = dtype == torch.bfloat16
    return _kernel_entry(
        smoke, flush, "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:79",
        launches,
        lambda: fa.flash_attention(q, k, v, causal=True, scale=scale),
        lambda: fa.flash_attention_plain(q, k, v, causal=True, scale=scale),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=scale, enable_gqa=True),
        "flash_wgmma_kernel" if bf16 else "flash_kernel", 1, nbytes, flops,
        {"b": b, "s": s, "hq": hq, "hkv": hkv, "hd": hd,
         "dtype": str(dtype).removeprefix("torch.")}, dtype=dtype,
        passes=1.5 if bf16 else 1.0)


def _flash_window_entry(smoke, gen, flush, b, s, w) -> dict:
    """The windowed fp32 flash kernel's entry at [b, s] with trinity-mini's
    heads and a window of w keys.  Operations: the band's, 4 hq hd
    sum_i min(i + 1, w) a batch row, at 3xTF32; bytes: q, k, v and the
    output once.  The plain version runs a batch row and kv head at a time
    (`_window_plain`); the library call is SDPA with the band as a boolean
    mask over kv heads repeated to the q heads.  Its launches: phase 18's
    recorded prefill at the longest of CELL_PREFILL_S, one a window
    layer."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa
    hq, hkv, hd = WINDOW_HEADS
    q, k, v = _window_inputs(gen, b, s)
    m = min(s, w)
    band = m * (m + 1) // 2 + (s - m) * w     # sum_i min(i + 1, w)
    qt, kt, vt = (t.transpose(1, 2).repeat_interleave(
        hq // t.shape[2], dim=1).contiguous() for t in (q, k, v))
    i = torch.arange(s, device=DEVICE)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    return _kernel_entry(
        smoke, flush, "flash_window",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "none: the reference's kernel has no window",
        _launches(smoke, f"prefill {TRINITY} S={CELL_PREFILL_S[-1]}",
                  "flash_window"),
        lambda: fa.flash_attention(q, k, v, window=w),
        lambda: _window_plain(q, k, v, w),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
        "flash_window_kernel", 1, 4 * b * s * 2 * (hq + hkv) * hd,
        4 * b * hq * hd * band,
        {"b": b, "s": s, "window": w, "hq": hq, "hkv": hkv, "hd": hd,
         "dtype": "float32"}, plain_reps=3,
        library_note="SDPA with the band as a boolean mask, the kv heads "
                     "repeated to the q heads")


def _model_times(smoke, flush, arch) -> None:
    """Prefill and decode-step times of one model on the kernel path at full
    width, and where the time goes (torch.profiler over one prefill and over
    three decode steps).  The kernels' end-to-end counterparts: for
    mamba2-780m the prefill with the plain SSD scan; for llama3.2-3b the
    cache-free forward (the flash kernel's path) on the kernel and with
    plain attention."""
    import dataclasses
    from repro_torch.models import io, stack
    cfg = _full_cfg(arch, "pallas")
    with torch.inference_mode():
        params = _params(cfg)
        batch = io.make_batch(cfg, io.smoke_cell("prefill", BATCH, PROMPT),
                              torch.Generator(device=DEVICE).manual_seed(1))
        prefill = stack.build_prefill_fn(cfg, PROMPT + NEW)
        times = {"prefill_ms": time_ms(lambda: prefill(params, batch), flush,
                                       reps=20, warmup=2)}
        if arch == MAMBA:
            plain = stack.build_prefill_fn(
                dataclasses.replace(cfg, ssd_impl="xla"), PROMPT + NEW)
            times["prefill_ms_plain_ssd"] = time_ms(
                lambda: plain(params, batch), flush, reps=10, warmup=1)
        else:
            fwd = {"tokens": batch["tokens"]}
            cfg_plain = dataclasses.replace(cfg, attn_impl="xla")
            times["forward_ms"] = time_ms(
                lambda: stack.forward(params, cfg, fwd), flush, reps=10,
                warmup=1)
            times["forward_ms_plain_attn"] = time_ms(
                lambda: stack.forward(params, cfg_plain, fwd), flush,
                reps=10, warmup=1)
        cache, logits = prefill(params, batch)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        decode = stack.build_decode_fn(cfg)
        steps = []
        for i in range(NEW - 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            cache, nxt, _ = decode(params, cache, tok, PROMPT + i)
            end.record()
            end.synchronize()
            steps.append(start.elapsed_time(end))
            tok = nxt[:, None]
        step_ms = statistics.median(steps[1:])
        times.update({"decode_step_ms": step_ms,
                      "decode_tok_per_s": BATCH * 1e3 / step_ms,
                      "decode_steps_timed": len(steps) - 1})
        smoke.results.setdefault("times", {})[arch] = times

        def three_steps():
            c, t = cache, tok
            for i in range(3):
                c, n, _ = decode(params, c, t, PROMPT + NEW - 4 + i)
                t = n[:, None]
        smoke.results.setdefault("profile", {})[arch] = {
            "prefill": _profile(lambda: prefill(params, batch)),
            "decode_3_steps": _profile(three_steps)}


def _profile(fn) -> dict:
    """Host wall time of fn() under torch.profiler, the device time its
    kernels took (one stream, so their sum is the busy time), the idle
    share, and the kernels that took most of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if not busy_ms:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1 - busy_ms / wall_ms),
            "kernel_calls": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top]}


def _kernel_entry(smoke, flush, name, source, replaces, launches, run, plain,
                  library, kernel_name, per_call, nbytes, flops, shape,
                  dtype=torch.float32, passes=1.0, plain_reps=30,
                  library_note=None) -> dict:
    """One entry of the `kernels` line: the kernel's wrapper call `run`,
    its plain version `plain` and the one PyTorch call `library` that
    computes the same function (None where there is none), at one shape.
    Checks the kernel's output against the plain version's at `dtype`'s
    tolerance.  `ms`, `plain_ms`, `library_ms`: time_ms (events around the
    call, its host cost included); `device_ms` (write flush),
    `device_ms_clean_l2` (read flush) and `library_device_ms`: device_time.
    Checks that one call enqueues `per_call` device kernels (the
    wrapper's own count) and that no device time is under the bound.  The
    operations bound takes the FLOP at FLOP_PER_S of `dtype`; with `passes`
    > 1 the design's bound (the FLOP times the passes its arithmetic takes)
    stands beside it, as the bound at the fp32 rate outside the tensor
    cores does."""
    got = run()
    err, ok = err_within(got, plain(), TOL[dtype])
    what = f"{shape['dtype']} " + " ".join(
        f"{k}={v}" for k, v in shape.items() if k != "dtype")
    smoke.check(f"{name}: timed inputs vs plain ({what})", ok,
                f"max_abs_err={err:.3g}")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOP_PER_S[dtype] * 1e3
    bound = max(t_bytes, t_ops)
    device = device_time(run, flush, kernel_name)
    clean = device_time(run, flush, clean_l2=True)
    smoke.check(f"{name}: device kernels a call ({what})",
                device["kernels_per_call"] == per_call,
                f"{device['kernels_per_call']} (want {per_call})")
    smoke.check(f"{name}: no device time under the bound ({what})",
                min(device["ms"], clean["ms"]) >= bound,
                f"device_ms {device['ms']:.4g}, clean L2 {clean['ms']:.4g}, "
                f"bound_ms {bound:.4g}")
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": time_ms(run, flush), "device_ms": device["ms"],
             "device_ms_clean_l2": clean["ms"],
             "device_kernels_per_call": device["kernels_per_call"],
             "device_ms_by_kernel": device["by_kernel"],
             "plain_ms": time_ms(plain, flush, reps=plain_reps),
             "bound_ms": bound,
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "bound_ms_fp32_fma": max(t_bytes,
                                      flops / FP32_FLOP_PER_S * 1e3),
             "library_ms": time_ms(library, flush) if library else None,
             "library_device_ms": (device_time(library, flush)["ms"]
                                   if library else None),
             **({"library_note": library_note} if library_note else {}),
             "shape": shape, "bytes": nbytes, "flops": flops}
    entry["kernel_ms"] = entry["ms"]
    if passes != 1.0:
        entry["bound_ms_design"] = max(t_bytes, passes * t_ops)
    print(f"   {name} {what}: device {entry['device_ms']:.4f} ms (clean L2 "
          f"{entry['device_ms_clean_l2']:.4f}), events {entry['ms']:.4f}, "
          f"library device {entry['library_device_ms']}, bound "
          f"{bound:.4f} ({entry['bound_by']})"
          + (f", design bound {entry['bound_ms_design']:.4f}"
             if passes != 1.0 else "") + f" [{card_line()}]", flush=True)
    return entry


def _sharded_launches(r) -> None:
    """Each kernel entry's launches on phase 14's sharded paths (rank 0):
    decode on the sharded serve path, flash in the sharded MoE forward and
    in lm-forward on the slot over every GPU, the SSD scan in the sharded
    mamba forward."""
    dist = r.get("distribution", {})
    rank0 = (dist.get("ranks") or [{}])[0]
    paths = {"serve (a)": rank0.get("serve", {}).get("launches_pallas"),
             "moe forward (c)": rank0.get("moe", {}).get("launches"),
             "mamba forward (e)": rank0.get("ssm", {}).get("launches"),
             "slot over every GPU (d)": dist.get("slot", {}).get("launches")}
    for entry in r["kernels"]:
        entry["sharded_launches"] = {
            path: counts.get(entry["name"]) for path, counts in paths.items()
            if counts and counts.get(entry["name"])}


def _examples_launches(r) -> None:
    """Each kernel entry's launches in phase 16's examples."""
    runs = r.get("examples", {}).get("launches", {})
    for entry in r["kernels"]:
        entry["examples_launches"] = {
            name: counts.get(entry["name"]) for name, counts in runs.items()
            if counts.get(entry["name"])}


def profiler_census(smoke: Smoke, after: str) -> None:
    """How many of 20 launches of the fp32 flash kernel (a small shape)
    torch.profiler records in this process now: the record of which phase
    leaves the profiler losing kernel records (`profiler_census`)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import ops as fa
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    q, k, v = (_randn(gen, (1, 256, h, 64), torch.float32) for h in (4, 2, 2))
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type.name == "CUDA" and "flash_kernel" in e.key)
    smoke.results.setdefault("profiler_census", {})[after] = n
    print(f"   profiler census after {after}: {n} of 20 kernel records",
          flush=True)


def phase_times_fresh(smoke: Smoke) -> None:
    """Phase 7 in a fresh process (`python3 chip_smoke.py --times DIR`):
    after the phases before it torch.profiler drops kernel records in this
    process (`profiler_census`), and phase 7's breakdowns (`_profile`,
    `device_ms_by_kernel`) are read from it.  The main paths' launch
    counts go to the child and its results and failures come back through
    DIR."""
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "launches.json").write_text(
            json.dumps(smoke.results.get("launches", {})))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--times", tmp], timeout=900)
        out = Path(tmp) / "times.json"
        if not out.exists():
            smoke.check("7 times: the fresh process wrote its results", False,
                        f"rc {proc.returncode}")
            return
        child = json.loads(out.read_text())
    smoke.failures += child["failures"]
    for key in ("kernels", "times", "profile"):
        if key in child["results"]:
            smoke.results[key] = child["results"][key]
    for key in ("phases", "profiler_census"):
        smoke.results.setdefault(key, {}).update(child["results"][key])


def times_child(tmp: str) -> int:
    """The fresh process of phase 7: the card set up as phase 1 sets it
    (TF32 off), the kernels loaded from phase 1's build."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke()
    smoke.results["launches"] = json.loads(
        (Path(tmp) / "launches.json").read_text())
    profiler_census(smoke, "the fresh process's start")
    smoke.phase("7 times", lambda: phase_times(smoke))
    (Path(tmp) / "times.json").write_text(json.dumps(
        {"results": smoke.results, "failures": smoke.failures}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 1
    smoke = Smoke()
    t0 = time.perf_counter()
    phases = [
        ("1 setup and build", lambda: phase_setup(smoke)),
        ("2 kernels vs plain", lambda: phase_kernels(smoke)),
        (f"3 serve {LLAMA} at full width", lambda: phase_serve(smoke, LLAMA)),
        (f"4 forward {LLAMA} at full width",
         lambda: phase_forward(smoke, LLAMA)),
        (f"5 serve {MAMBA} at full width", lambda: phase_serve(smoke, MAMBA)),
        (f"6 forward {MAMBA} at full width",
         lambda: phase_forward(smoke, MAMBA)),
        ("8 FOS daemon on the card", lambda: phase_daemon(smoke)),
        (f"9 {JAMBA} cut to {DEPTH_CUT[JAMBA]} layers at full width",
         lambda: phase_moe_model(smoke, JAMBA)),
        (f"10 {QWEN_MOE} cut to {DEPTH_CUT[QWEN_MOE]} layers at full width",
         lambda: phase_moe_model(smoke, QWEN_MOE)),
        (f"17 {NEMOTRON} cut to {DEPTH_CUT[NEMOTRON]} layers at full width",
         lambda: phase_moe_model(smoke, NEMOTRON)),
        (f"18 {TRINITY} cut to {DEPTH_CUT[TRINITY]} layers at full width",
         lambda: phase_moe_model(smoke, TRINITY)),
        (f"11 {WHISPER} at full width and depth",
         lambda: phase_encdec_vlm(smoke, WHISPER)),
        (f"12 {PHI3V} at full width and depth",
         lambda: phase_encdec_vlm(smoke, PHI3V)),
        (f"13 train {LLAMA} on the card", lambda: phase_train(smoke)),
        ("14 distribution on the card", lambda: phase_distribution(smoke)),
        ("15 dry run against the card", lambda: phase_dryrun(smoke)),
        ("16 the examples on the card", lambda: phase_examples(smoke)),
    ]
    for name, fn in phases:
        smoke.phase(name, fn)
        if name.startswith("1 ") and smoke.failures:
            break                 # no kernels: nothing else can run
        profiler_census(smoke, name.split()[0])
    else:
        smoke.phase("7 times (a fresh process)",
                    lambda: phase_times_fresh(smoke))
    r = smoke.results
    for key in ("launches", "serve", "forward", "times", "profile",
                "daemon", "moe_models", "decode_g1", "train", "distribution",
                "dryrun", "examples", "profiler_census", "phases"):
        if key in r:
            print(json.dumps({key: r[key]}))
    print(f"total {time.perf_counter() - t0:.1f} s; "
          f"failures: {smoke.failures or 'none'}")
    if smoke.failures or "kernels" not in r:
        return 1
    _sharded_launches(r)
    _examples_launches(r)
    print(json.dumps({"kernels": r["kernels"]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--times"]:
        sys.exit(times_child(sys.argv[2]))
    sys.exit(main())
