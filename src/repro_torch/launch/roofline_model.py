"""Roofline model for one NVIDIA H100 SXM5 80GB (HBM3, 700 W) per rank.

The counterpart of `repro/launch/roofline_model.py`, whose constants are a
TPU's; these are the H100's, from NVIDIA's H100 Tensor Core GPU data
sheet (SXM5 column, dense rates without sparsity).

Terms (seconds), per (arch x cell x mesh), from the dry run's per-rank
counts (`launch/dryrun.py`):
  compute    = FLOPs_per_rank            / PEAK_FLOPS
  memory     = HBM_bytes_per_rank        / HBM_BW
  collective = collective_bytes_per_rank / LINK_BW

The dry run counts per rank (the program each rank dispatches), so the
global totals over `chips` ranks divide back to these per-rank seconds.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models import api
from repro_torch.models.api import ModelConfig, ShapeCell

# dense bf16 tensor-core rate (data sheet: 1,979 TFLOPS with sparsity)
PEAK_FLOPS = 989.4e12
# HBM3 bandwidth (data sheet: 3.35 TB/s)
HBM_BW = 3.35e12
# HBM capacity (data sheet: 80 GB)
HBM_PER_CHIP = 80e9
# Collectives are priced at the slowest link the production mesh crosses.
# A (16, 16) mesh of 256 GPUs spans 32 eight-GPU nodes, so its groups
# leave the node over InfiniBand: one 400 Gb/s (NDR) NIC per GPU, 50 GB/s
# each way.  Inside a node NVLink gives each GPU 450e9 B/s each way (data
# sheet: 900 GB/s bidirectional), nine times more; a group that stays
# inside one node would be priced at that.
LINK_BW = 50e9


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    model_flops_global: float
    useful_flops_ratio: float     # MODEL_FLOPS / (counted FLOPs * chips)
    chips: int = 256
    memory_kernel_adj_s: float = 0.0   # memory term with the score
    #                                    traffic the port's kernels never
    #                                    write removed (see
    #                                    scores_traffic_bytes)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s,
                 "memory": self.memory_kernel_adj_s or self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap roofline step time: max of the three terms,
        memory taken kernel-adjusted when available."""
        return max(self.compute_s,
                   self.memory_kernel_adj_s or self.memory_s,
                   self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the ideal compute roofline achieved if the step
        runs at step_time_s: ideal = MODEL_FLOPS/(chips*peak)."""
        if self.step_time_s == 0:
            return 0.0
        ideal = self.model_flops_global / (self.chips * PEAK_FLOPS)
        return ideal / self.step_time_s

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "memory_kernel_adj_s": self.memory_kernel_adj_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "step_time_s": self.step_time_s,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS = 6*N*D (train), 2*N*D (prefill), 2*N*B (decode: one
    token/sequence), with N = active params (MoE: top-k of experts)."""
    n = api.active_param_count(cfg)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * cell.global_batch


def scores_traffic_bytes(cfg: ModelConfig, cell: ShapeCell,
                         chips: int) -> float:
    """Per-rank HBM bytes the plain attention/SSD route spends on
    materialised score/prob tensors, which the port's flash and SSD
    kernels never write (their score tiles live in registers and shared
    memory).

    Per score element: fwd ~12 B (f32 scores w+r, bf16 probs w+r);
    bwd with remat="full" ~20 B more.  train=32 B/elem, prefill=12,
    decode=0 (the decode kernel streams KV only).
    """
    if cell.kind == "decode":
        return 0.0
    per_elem = 32.0 if cell.kind == "train" else 12.0
    b, s = cell.global_batch, cell.seq_len
    n_groups, plan = cfg.layer_plan()
    elems = 0.0
    n_attn = sum(1 for mix, _ in plan if mix == "attn") * n_groups
    n_ssm = sum(1 for mix, _ in plan if mix == "mamba") * n_groups
    if n_attn:
        elems += n_attn * b * cfg.n_heads * s * s * 0.5     # causal
    if cfg.family == "encdec":
        enc = cfg.enc_seq
        elems += cfg.n_enc_layers * b * cfg.n_heads * enc * enc
        elems += cfg.n_layers * b * cfg.n_heads * s * enc   # cross
    if n_ssm:
        ms = cfg.mamba_spec
        elems += n_ssm * b * ms.n_heads * s * ms.chunk      # intra-chunk
    return per_elem * elems / chips


def terms_from_costs(flops_dev: float, bytes_dev: float,
                     coll_bytes_dev: float, chips: int,
                     cfg: ModelConfig, cell: ShapeCell) -> RooflineTerms:
    """The roofline terms of one rank's counted step on the H100: FLOPs at
    the bf16 peak, bytes at the HBM rate, collective bytes at LINK_BW."""
    mf = model_flops(cfg, cell)
    adj = max(bytes_dev - scores_traffic_bytes(cfg, cell, chips), 0.0)
    return RooflineTerms(
        compute_s=flops_dev / PEAK_FLOPS,
        memory_s=bytes_dev / HBM_BW,
        memory_kernel_adj_s=adj / HBM_BW,
        collective_s=coll_bytes_dev / LINK_BW,
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        coll_bytes_per_device=coll_bytes_dev,
        model_flops_global=mf,
        useful_flops_ratio=(mf / (flops_dev * chips)) if flops_dev else 0.0,
        chips=chips,
    )
