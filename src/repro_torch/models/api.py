"""Unified model API: configs, the declarative param table and init.

Mirrors `repro/models/api.py`.  Every architecture is a ModelConfig; the
param table (path -> ParamSpec) is the single source of truth for parameter
shapes, logical sharding axes and initializers (every param has
`cfg.param_dtype`).  Block params carry a leading `groups`
axis (one entry per repeat of `layer_plan()`), as in the reference, so a
converted reference param tree maps across leaf for leaf.

All six families of the reference are ported: dense, SSM, MoE, hybrid,
encoder-decoder (whisper) and VLM (phi-3-vision).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models import layers, mamba as mamba_mod

def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is never silently replaced
    by the CPU: asking for it on a machine without it raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int               # per-expert hidden width
    every: int = 1          # MoE FFN on every `every`-th layer (1 = all)
    capacity_factor: float = 1.25
    impl: str = "dense"     # "dense" | "ep"
    fsdp_experts: bool = False
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_kernel: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str             # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int               # dense FFN width (0 for pure-ssm / pure-moe)
    vocab: int
    # attention flavour
    qk_norm: bool = False
    rope_theta: float = 1e4
    attn_bias: bool = False
    mlp_kind: str = "swiglu"
    norm_kind: str = "rms"          # rms | layer
    tie_embeddings: bool = False
    # family extensions
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    attn_every: int = 0             # hybrid: 1 attn layer per this many
    n_enc_layers: int = 0           # encdec
    enc_seq: int = 1500             # stub audio frontend frames
    n_patches: int = 0              # vlm stub patches
    # numerics / impl
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    kv_dtype: Any = torch.bfloat16
    attn_impl: str = "xla"          # "xla": plain torch | "pallas": kernel
    ssd_impl: str = "xla"           # the same, for the SSD scan
    remat: str = "none"             # none | full | dots
    loss_chunk: int = 0             # 0 = unchunked final projection
    max_pos: int = 8192             # learned-pos table size (encdec only)
    logit_softcap: float = 0.0
    attn_chunk: int = 0             # q-block size for chunked attention
    attn_unroll: bool = False       # unroll q-block loop (dry-run cost mode)
    scan_layers: bool = True

    @property
    def sub_quadratic(self) -> bool:
        """Attention-free or mostly so (SSM, hybrid): the families a
        500k-token context is run for."""
        return self.family in ("ssm", "hybrid")

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to a multiple of 256 (Megatron-style);
        cfg.vocab stays the logical vocabulary and padded logit slots are
        masked to -1e30 in unembed()."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def mamba_spec(self) -> mamba_mod.MambaSpec:
        s = self.ssm or SSMConfig()
        return mamba_mod.MambaSpec(
            d_model=self.d_model, d_state=s.d_state, headdim=s.headdim,
            expand=s.expand, n_groups=s.n_groups, conv_kernel=s.conv_kernel,
            chunk=s.chunk, ssd_impl=self.ssd_impl)

    @property
    def attn_spec(self) -> layers.AttentionSpec:
        return layers.AttentionSpec(
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim, rope_theta=self.rope_theta,
            qk_norm=self.qk_norm, causal=True,
            use_rope=(self.family != "encdec"), bias=self.attn_bias,
            attn_chunk=self.attn_chunk, attn_unroll=self.attn_unroll)

    def layer_plan(self):
        """Returns (n_groups, per-group sub-layer plan).

        Each sub-layer is (mixer, ffn) with mixer in {attn, mamba} and ffn
        in {dense, moe, none}.  Homogeneous families repeat a one-sub-layer
        plan n_layers times (the VLM takes the dense plan; the
        encoder-decoder's is its decoder's); the MoE family a plan of
        `moe.every` sub-layers; the hybrid (jamba) super-blocks of
        `attn_every` sub-layers, attention in the middle one, MoE on the
        odd ones.
        """
        if self.family in ("dense", "vlm", "encdec"):
            return self.n_layers, [("attn", "dense")]
        if self.family == "moe":
            assert self.moe is not None
            plan = [("attn", "moe" if (i % self.moe.every == 0) else "dense")
                    for i in range(self.moe.every)]
            assert self.n_layers % self.moe.every == 0
            return self.n_layers // self.moe.every, plan
        if self.family == "ssm":
            return self.n_layers, [("mamba", "none")]
        if self.family != "hybrid":
            raise ValueError(f"{self.name}: unknown family {self.family!r}")
        assert self.attn_every > 0 and self.moe is not None
        period = self.attn_every
        attn_pos = period // 2
        plan = []
        for i in range(period):
            mixer = "attn" if i == attn_pos else "mamba"
            ffn = "moe" if (i % self.moe.every == 1) else "dense"
            plan.append((mixer, ffn))
        assert self.n_layers % period == 0
        return self.n_layers // period, plan


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # train | prefill | decode


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Param table
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]    # logical axis names, len == len(shape)
    init: str = "normal"            # normal | zeros | ones | a_log | dt_bias

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _attn_table(cfg: ModelConfig, cross: bool = False) -> dict:
    """Self attention, or with `cross` the decoder's cross attention over
    the encoder states (no qk-norm there).  Biases on q, v and the output,
    none on k, as whisper's."""
    hq = cfg.n_heads * cfg.head_dim
    hkv = cfg.n_kv_heads * cfg.head_dim
    d = cfg.d_model
    t = {
        "wq": ParamSpec((d, hq), ("embed", "q_proj")),
        "wk": ParamSpec((d, hkv), ("embed", "kv_proj")),
        "wv": ParamSpec((d, hkv), ("embed", "kv_proj")),
        "wo": ParamSpec((hq, d), ("q_proj", "embed")),
    }
    if cfg.attn_bias:
        t["bq"] = ParamSpec((hq,), ("q_proj",), "zeros")
        t["bv"] = ParamSpec((hkv,), ("kv_proj",), "zeros")
        t["bo"] = ParamSpec((d,), ("embed",), "zeros")
    if cfg.qk_norm and not cross:
        t["q_norm"] = ParamSpec((cfg.head_dim,), (None,), "ones")
        t["k_norm"] = ParamSpec((cfg.head_dim,), (None,), "ones")
    return t


def _mlp_table(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {
            "w_gate": ParamSpec((d, f), ("embed", "mlp")),
            "w_up": ParamSpec((d, f), ("embed", "mlp")),
            "w_down": ParamSpec((f, d), ("mlp", "embed")),
        }
    t = {"w_up": ParamSpec((d, f), ("embed", "mlp")),
         "w_down": ParamSpec((f, d), ("mlp", "embed"))}
    if cfg.attn_bias:   # whisper-style biases everywhere
        t["b_up"] = ParamSpec((f,), ("mlp",), "zeros")
        t["b_down"] = ParamSpec((d,), ("embed",), "zeros")
    return t


def _moe_table(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    emb = "embed" if m.fsdp_experts else "embed_nofsdp"
    return {
        "w_router": ParamSpec((d, m.n_experts), ("embed", None)),
        "w1": ParamSpec((m.n_experts, d, m.d_ff),
                        ("expert", emb, "expert_mlp")),
        "w3": ParamSpec((m.n_experts, d, m.d_ff),
                        ("expert", emb, "expert_mlp")),
        "w2": ParamSpec((m.n_experts, m.d_ff, d),
                        ("expert", "expert_mlp", emb)),
    }


def _mamba_table(cfg: ModelConfig) -> dict:
    s = cfg.mamba_spec
    d = cfg.d_model
    return {
        "w_z": ParamSpec((d, s.d_inner), ("embed", "inner")),
        "w_x": ParamSpec((d, s.d_inner), ("embed", "inner")),
        "w_bc": ParamSpec((d, s.bc_dim), ("embed", None)),
        "w_dt": ParamSpec((d, s.n_heads), ("embed", "heads_ssm")),
        "dt_bias": ParamSpec((s.n_heads,), ("heads_ssm",), "dt_bias"),
        "a_log": ParamSpec((s.n_heads,), ("heads_ssm",), "a_log"),
        "d_skip": ParamSpec((s.n_heads,), ("heads_ssm",), "ones"),
        "w_conv_x": ParamSpec((s.conv_kernel, s.d_inner), (None, "inner")),
        "b_conv_x": ParamSpec((s.d_inner,), ("inner",), "zeros"),
        "w_conv_bc": ParamSpec((s.conv_kernel, s.bc_dim), (None, None)),
        "b_conv_bc": ParamSpec((s.bc_dim,), (None,), "zeros"),
        "norm_w": ParamSpec((s.d_inner,), ("inner",), "ones"),
        "w_out": ParamSpec((s.d_inner, d), ("inner", "embed")),
    }


def _norm_table(cfg: ModelConfig, name: str) -> dict:
    t = {f"{name}_w": ParamSpec((cfg.d_model,), ("embed",), "ones")}
    if cfg.norm_kind == "layer":
        t[f"{name}_b"] = ParamSpec((cfg.d_model,), ("embed",), "zeros")
    return t


def _stack_specs(tree: dict, n: int) -> dict:
    """Prepend a `groups` axis of size n (logical axis "layers") to every
    spec in tree."""
    return {k: (_stack_specs(v, n) if isinstance(v, dict)
                else ParamSpec((n,) + v.shape, ("layers",) + v.axes,
                               v.init))
            for k, v in tree.items()}


def _sublayer_table(cfg: ModelConfig, mixer: str, ffn: str,
                    cross: bool = False) -> dict:
    t = dict(_norm_table(cfg, "ln1"))
    if mixer == "attn":
        t["attn"] = _attn_table(cfg)
    else:
        t["mamba"] = _mamba_table(cfg)
    if cross:
        t.update(_norm_table(cfg, "lnx"))
        t["xattn"] = _attn_table(cfg, cross=True)
    if ffn != "none":
        t.update(_norm_table(cfg, "ln2"))
        if ffn == "dense":
            t["mlp"] = _mlp_table(cfg)
        else:
            t["moe"] = _moe_table(cfg)
    return t


def param_table(cfg: ModelConfig) -> dict:
    n_groups, plan = cfg.layer_plan()
    cross = cfg.family == "encdec"
    group = {f"sub{i}": _sublayer_table(cfg, mixer, ffn, cross)
             for i, (mixer, ffn) in enumerate(plan)}
    table = {
        "embed": {"tok": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                   ("vocab", "embed"))},
        "blocks": _stack_specs(group, n_groups),
        "final": _norm_table(cfg, "lnf"),
    }
    if not cfg.tie_embeddings:
        table["lm_head"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                     ("embed", "vocab"))
    if cross:   # the encoder stack and the decoder's learned positions
        enc = {"sub0": _sublayer_table(cfg, "attn", "dense")}
        table["enc_blocks"] = _stack_specs(enc, cfg.n_enc_layers)
        table["enc_final"] = _norm_table(cfg, "lnf")
        table["dec_pos"] = ParamSpec((cfg.max_pos, cfg.d_model),
                                     (None, "embed"))
    return table


def _table_map(fn, table: dict) -> dict:
    return {k: (_table_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in table.items()}


def param_specs(cfg: ModelConfig) -> dict:
    """The logical-axes tuple of every param, mirroring the params."""
    return _table_map(lambda s: s.axes, param_table(cfg))


def abstract_params(cfg: ModelConfig) -> dict:
    """Every param as a `meta` tensor of its shape and dtype: nothing is
    allocated (the reference's ShapeDtypeStructs)."""
    return _table_map(lambda s: torch.empty(s.shape, dtype=cfg.param_dtype,
                                            device="meta"),
                      param_table(cfg))


def flatten(tree: dict, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] in insertion order, paths joined with '/'."""
    out = []
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.extend(flatten(v, path) if isinstance(v, dict) else [(path, v)])
    return out


def param_count(cfg: ModelConfig) -> int:
    return sum(int(torch.Size(s.shape).numel())
               for _, s in flatten(param_table(cfg)))


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE counts top_k of n_experts)."""
    total = param_count(cfg)
    if cfg.moe is not None:
        n_groups, plan = cfg.layer_plan()
        m = cfg.moe
        expert_params = 3 * cfg.d_model * m.d_ff
        n_moe_layers = sum(1 for _, f in plan if f == "moe") * n_groups
        total -= n_moe_layers * expert_params * (m.n_experts - m.top_k)
    return total


def _init_leaf(spec: ParamSpec, cfg: ModelConfig,
               gen: torch.Generator) -> torch.Tensor:
    dtype = cfg.param_dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=gen.device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=gen.device)
    if spec.init == "a_log":        # decay rates a = -1 .. -16 over heads
        v = torch.log(torch.linspace(1.0, 16.0, spec.shape[-1]))
        return v.expand(spec.shape).to(gen.device, dtype)
    if spec.init == "dt_bias":      # softplus(dt_bias) = 1e-3 .. 1e-1
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1),
                                      spec.shape[-1]))
        return torch.log(torch.expm1(dt)).expand(spec.shape).to(gen.device,
                                                               dtype)
    # truncated-normal fan-in init, as the reference
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = min(0.02, (1.0 / max(fan_in, 1)) ** 0.5)
    x = torch.empty(spec.shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    # scaled in place: a stacked expert leaf is up to 12.9 GB at full width
    return x.mul_(scale).to(dtype)


def unflatten(items) -> dict:
    tree: dict = {}
    for path, leaf in items:
        *head, last = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Params on `generator.device`, drawn in param-table order.

    The reference folds a hash of each path into its key, and Python salts
    string hashes per process, so its init is not reproducible across
    processes.  Here one generator walks the table in order: the same seed
    on the same device gives the same params in every process.  Parity
    tests load the reference's params through `convert` instead.
    """
    return unflatten((path, _init_leaf(spec, cfg, generator))
                      for path, spec in flatten(param_table(cfg)))
