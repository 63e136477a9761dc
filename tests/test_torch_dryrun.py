"""The port's dry run and roofline against the reference's.

`launch/roofline_model.py`'s model FLOPs and score traffic, and the
H100-free fields of its terms, equal the reference's for every arch and
shape cell; `sharding/op_analysis.py`'s collective accounting of recorded
calls equals the reference's `hlo_analysis.collective_bytes` on the same
ops written as HLO; the g=1/g=2 extrapolation of `launch/dryrun.py`
equals the full-depth count (eager dispatch counts every layer group); the
counted FLOPs of a small prefill equal the analytic matrix-product count;
a tensor-parallel rank counts its share; counting changes no result; and
`run_cell` on 256 fake ranks writes the reference's JSON and leaves no
process group.  Everything runs on the CPU, on fake ranks (`fake_world`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.distributed._functional_collectives as funcol  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.configs.common import apply_cell_policy as ref_policy  # noqa: E402
from repro.launch import roofline_model as ref_roofline  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.sharding import hlo_analysis  # noqa: E402
from repro_torch import configs, tree as tree_mod  # noqa: E402
from repro_torch.configs.common import apply_cell_policy  # noqa: E402
from repro_torch.launch import dryrun, mesh as mesh_mod, roofline_model, \
    steps  # noqa: E402
from repro_torch.models.api import SHAPE_CELLS, ShapeCell  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sharding import op_analysis, partition  # noqa: E402


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    assert not dist.is_initialized()


# -- api: the shape cells and the sub-quadratic families -------------------


def test_shape_cells_and_sub_quadratic_equal_reference():
    assert list(SHAPE_CELLS) == list(ref_api.SHAPE_CELLS)
    for name, cell in SHAPE_CELLS.items():
        assert dataclasses.astuple(cell) == dataclasses.astuple(
            ref_api.SHAPE_CELLS[name])
    for arch in configs.ARCH_IDS:
        for reduced in (False, True):
            assert configs.get(arch, reduced).sub_quadratic == \
                ref_configs.get(arch, reduced).sub_quadratic, arch


# -- roofline_model ---------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_roofline_counts_equal_reference(arch):
    """Model FLOPs, score traffic, and the terms' fields that hold no
    hardware constant, per shape cell after each package's cell policy."""
    costs = (1.5e15, 2.5e13, 3.5e11)
    for name, cell in SHAPE_CELLS.items():
        cfg = apply_cell_policy(configs.get(arch), cell)
        ref_cfg = ref_policy(ref_configs.get(arch), ref_api.SHAPE_CELLS[name])
        assert roofline_model.model_flops(cfg, cell) == \
            ref_roofline.model_flops(ref_cfg, ref_api.SHAPE_CELLS[name])
        for chips in (256, 512):
            assert roofline_model.scores_traffic_bytes(cfg, cell, chips) == \
                ref_roofline.scores_traffic_bytes(
                    ref_cfg, ref_api.SHAPE_CELLS[name], chips)
        got = roofline_model.terms_from_costs(*costs, 256, cfg, cell)
        want = ref_roofline.terms_from_costs(
            *costs, 256, ref_cfg, ref_api.SHAPE_CELLS[name])
        for field in ("flops_per_device", "bytes_per_device",
                      "coll_bytes_per_device", "model_flops_global",
                      "useful_flops_ratio", "chips"):
            assert getattr(got, field) == getattr(want, field), (name, field)
        assert set(got.to_dict()) == set(want.to_dict())


def test_roofline_constants_are_the_h100s():
    """The H100 SXM5 data sheet's rates; a collective at the 400 Gb/s
    InfiniBand rate of one NIC per GPU."""
    assert roofline_model.PEAK_FLOPS == 989.4e12
    assert roofline_model.HBM_BW == 3.35e12
    assert roofline_model.HBM_PER_CHIP == 80e9
    assert roofline_model.LINK_BW == 50e9
    cfg, cell = configs.get("llama3.2-3b"), SHAPE_CELLS["decode_32k"]
    t = roofline_model.terms_from_costs(989.4e12, 3.35e12, 50e9, 256, cfg,
                                        cell)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 1.0)


# -- op_analysis: collectives ----------------------------------------------


def _hlo_lines(g: int, dtype: str) -> str:
    """One HLO line per call `_recorded_calls` makes, as the reference's
    partitioned program prints them.  A collective-permute prints no
    replica groups (the reference then takes 16); here the line carries
    the group, so both packages price it at the same g."""
    grp = "replica_groups={{" + ",".join(map(str, range(g))) + "}}"
    x, xs = f"{dtype}[8,64]{{1,0}}", f"{dtype}[{2 * g},64]{{1,0}}"
    lines = []
    for i in range(2):
        lines += [
            f"  %ar.{i} = {x} all-reduce({x} %x), {grp}, to_apply=%add",
            f"  %ag.{i} = {dtype}[{8 * g},64]{{1,0}} all-gather({x} %x), "
            f"{grp}, dimensions={{0}}",
            f"  %rs.{i} = {dtype}[2,64]{{1,0}} reduce-scatter({xs} %xs), "
            f"{grp}, dimensions={{0}}, to_apply=%add",
            f"  %a2a.{i} = {xs} all-to-all({xs} %xs), {grp}, "
            f"dimensions={{0}}"]
    lines.append(f"  %cp = {x} collective-permute({x} %x), {grp}, "
                 f"source_target_pairs={{{{0,1}},{{1,0}}}}")
    return "\n".join(lines)


def _recorded_calls(group, g: int, dtype) -> list:
    """Each collective the port reaches, once through c10d and once
    through the functional collectives, and a batch_isend_irecv pair."""
    x = torch.ones(8, 64, dtype=dtype)
    xs = torch.ones(2 * g, 64, dtype=dtype)
    rec = op_analysis.OpRecorder()
    with rec:
        dist.all_reduce(x, group=group)
        funcol.all_reduce(x, "sum", group).wait()
        dist.all_gather_into_tensor(torch.empty(8 * g, 64, dtype=dtype), x,
                                    group=group)
        funcol.all_gather_tensor(x, 0, group).wait()
        dist.reduce_scatter_tensor(torch.empty(2, 64, dtype=dtype), xs,
                                   group=group)
        funcol.reduce_scatter_tensor(xs, "sum", 0, group).wait()
        dist.all_to_all_single(torch.empty_like(xs), xs, group=group)
        funcol.all_to_all_single(xs, None, None, group).wait()
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1, group),
                dist.P2POp(dist.irecv, torch.empty_like(x), 1, group)]):
            req.wait()
    return rec.records


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "bf16"),
                                        (torch.float32, "f32")])
@pytest.mark.parametrize("g", [2, 4, 16])
def test_collective_bytes_equal_reference_on_the_same_ops(g, dtype, name):
    assert op_analysis.COLLECTIVES == hlo_analysis.COLLECTIVES
    with dryrun.fake_world(16):
        group = dist.new_group(list(range(g)))
        got = op_analysis.collective_bytes(_recorded_calls(group, g, dtype))
    want = hlo_analysis.collective_bytes(_hlo_lines(g, name))
    assert got == want
    # every opcode the port reaches (not the reference's ragged all-to-all)
    assert set(want["counts"]) == set(op_analysis.COLLECTIVES[:5])


def test_bytes_by_op_counts_views_zero_and_slice_writes_twice():
    x = torch.ones(4, 8)
    rec = op_analysis.OpRecorder()
    with rec:
        y = x.view(8, 4).t().detach()      # views: nothing moves
        z = x + 1                          # 2 reads... one of 128 B + write
        x[1:3].copy_(z[:2])                # a 64 B piece, read and written
        x.index_put_((torch.tensor([0]),), torch.ones(1, 8))
        torch.empty(100)
    by_op = op_analysis.bytes_by_op(rec.records)
    assert "view" not in by_op and "t" not in by_op and "empty" not in by_op
    assert by_op["add"] == {"bytes": 2 * 128, "count": 1}
    assert by_op["copy_"] == {"bytes": 2 * 64, "count": 1}
    assert by_op["index_put_"] == {"bytes": 2 * 32, "count": 1}
    assert op_analysis.hbm_model_bytes(rec.records) == sum(
        v["bytes"] for v in op_analysis.bytes_by_op(rec.records,
                                                    10 ** 6).values())
    assert y.shape == (4, 8)


# -- the dry run ------------------------------------------------------------


def _deeper(arch: str, groups: int = 4):
    """The reduced config with `groups` layer groups (so that the g=1/g=2
    extrapolation reaches past its samples) and, for the MoE, 16 experts
    (the (16, 16) mesh splits them over "model")."""
    cfg = configs.get(arch, reduced=True)
    _, plan = cfg.layer_plan()
    upd = {"n_layers": groups * len(plan)}
    if cfg.family == "encdec":
        upd["n_enc_layers"] = groups
    if cfg.moe is not None:
        upd["moe"] = dataclasses.replace(cfg.moe, n_experts=16)
    return dataclasses.replace(cfg, **upd)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-780m",
                                  "qwen3-moe-30b-a3b", "whisper-large-v3"])
def test_extrapolation_equals_full_depth(arch, kind, monkeypatch):
    """`run_cell` on the deeper reduced config (as `configs.get` hands
    it out) and a small cell of 16 sequences of 32 tokens."""
    cfg, cell = _deeper(arch), ShapeCell(f"small_{kind}", 32, 16, kind)
    monkeypatch.setattr(configs, "get", lambda arch_id, reduced=False: cfg)
    monkeypatch.setitem(SHAPE_CELLS, cell.name, cell)
    res = dryrun.run_cell(arch, cell.name, multi_pod=False)
    ex, full = res["extrapolated"], res["full"]
    assert ex["n_groups"] == 4
    assert ex["flops_per_device"] == full["cost"]["flops"] > 0
    assert ex["bytes_per_device"] == full["cost"]["bytes accessed"]
    assert ex["raw_bytes_per_device"] == full["cost"]["bytes accessed"]
    assert ex["coll_bytes_per_device"] == full["coll"]["total"] > 0


def _world_one(cfg, cell):
    """(records, info) of the cell's step without a mesh."""
    return dryrun.trace_cell(cfg, cell, None, None, verbose=False)


def _dense_layer_flops(cfg, b: int, s: int) -> int:
    """One dense layer's forward products over b x s tokens, attention
    over the whole s x s square (the plain route masks, not skips)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return (2 * b * s * d * h * hd            # q
            + 2 * 2 * b * s * d * kv * hd     # k, v
            + 2 * b * s * h * hd * d          # o
            + 3 * 2 * b * s * d * cfg.d_ff    # gate, up, down
            + 2 * 2 * b * h * s * s * hd)     # scores, weighted sum


def test_dense_prefill_flops_equal_the_analytic_count():
    cfg = configs.get("llama3.2-3b", reduced=True)
    b, s = 2, 24
    records, info = _world_one(cfg, ShapeCell("p", s, b, "prefill"))
    want = (cfg.n_layers * _dense_layer_flops(cfg, b, s)
            + 2 * b * cfg.d_model * cfg.padded_vocab)       # last token
    assert info["cost"]["flops"] == want
    assert op_analysis.total_flops(records) == want


def test_remat_recomputation_is_counted():
    """remat="full" runs each layer group's forward again in backward, as
    far as the backward needs it: non-reentrant checkpointing stops once
    the last saved tensor is recomputed, before the MLP's down projection
    (whose backward needs its input, not its output).  The count grows by
    exactly that."""
    cfg = configs.get("llama3.2-3b", reduced=True)
    b, s = 2, 24
    cell = ShapeCell("t", s, b, "train")
    flops = {remat: _world_one(dataclasses.replace(cfg, remat=remat),
                               cell)[1]["cost"]["flops"]
             for remat in ("none", "full")}
    down = 2 * b * s * cfg.d_ff * cfg.d_model
    assert flops["full"] - flops["none"] == \
        cfg.n_layers * (_dense_layer_flops(cfg, b, s) - down)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_a_tensor_parallel_rank_counts_its_share(kind):
    """8 q and 4 kv heads split whole over a fake (1, 4) mesh: every
    product is split, so rank 0 counts a quarter of one device's FLOPs."""
    cfg = dataclasses.replace(configs.get("llama3.2-3b", reduced=True),
                              n_heads=8, n_kv_heads=4, head_dim=8)
    cell = ShapeCell("p", 16, 2, kind)
    one, _ = _world_one(cfg, cell)
    rules = partition.make_rules("train" if kind == "train" else "serve")
    with dryrun.fake_world(4):
        mesh = mesh_mod.make_mesh((1, 4), ("data", "model"))
        rank, _ = dryrun.trace_cell(cfg, cell, mesh, rules, verbose=False)
    assert 4 * op_analysis.total_flops(rank) == \
        op_analysis.total_flops(one) > 0
    if kind == "train":   # the model axis splits no param's storage here
        assert op_analysis.collective_bytes(rank)["total"] > 0


def test_counting_changes_nothing():
    """A small train step's loss, grad norm and updated state are the same
    with and without the recorder."""
    cfg = configs.get("llama3.2-3b", reduced=True)
    step = steps.build_train_step(cfg, adamw.AdamWConfig(warmup_steps=1))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16), dtype=np.int32))

    def run(record: bool):
        state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                       "cpu")
        rec = op_analysis.OpRecorder()
        if record:
            with rec:
                state, metrics = step(state, {"tokens": tokens})
        else:
            state, metrics = step(state, {"tokens": tokens})
        return state, metrics, rec
    plain, plain_m, _ = run(False)
    counted, counted_m, rec = run(True)
    assert len(rec.records) > 100 and op_analysis.total_flops(rec.records)
    for k in plain_m:
        assert torch.equal(plain_m[k], counted_m[k]), k
    for a, b in zip(tree_mod.leaves(plain), tree_mod.leaves(counted)):
        assert torch.equal(a, b)


def test_run_cell_llama_writes_the_reference_json_and_leaves_no_group():
    """llama3.2-3b's decode cell at full width on 256 fake ranks (and on
    512 without the cost traces), and its skipped long_500k cell."""
    res = dryrun.run_cell("llama3.2-3b", "decode_32k", multi_pod=False)
    assert not dist.is_initialized()
    # the reference's keys (repro/launch/dryrun.py run_cell); "full" names
    # the trace's time where the reference names its lower and compile
    # times, and adds the full trace's collectives; "attn_split" records
    # the attention heads rank 0 computes with (or that it computes whole)
    assert set(res) == {"arch", "cell", "mesh", "chips", "tag", "full",
                        "extrapolated", "roofline", "attn_split"}
    assert res["attn_split"] == {"q_heads": 2, "kv_heads": 1, "ranks": 16}
    assert res["chips"] == 256 and res["mesh"] == "single"
    assert set(res["full"]) == {"trace_s", "memory", "cost", "coll"}
    assert set(res["full"]["memory"]) == {
        "generated_code_size_in_bytes", "argument_size_in_bytes",
        "output_size_in_bytes", "alias_size_in_bytes", "temp_size_in_bytes"}
    assert set(res["full"]["cost"]) == {"flops", "bytes accessed"}
    assert set(res["extrapolated"]) == {
        "n_groups", "flops_per_device", "bytes_per_device",
        "raw_bytes_per_device", "coll_bytes_per_device", "g1", "g2"}
    assert set(res["extrapolated"]["g1"]) == {"cost", "coll", "hbm_model",
                                              "by_op"}
    want = ref_roofline.RooflineTerms(1, 1, 1, 1, 1, 1, 1, 1).to_dict()
    assert set(res["roofline"]) == set(want)
    roof = res["roofline"]
    assert roof["flops_per_device"] == res["full"]["cost"]["flops"] > 0
    assert 0 < roof["roofline_fraction"] <= 1
    # the rank's shard of the cache is written in place
    mem = res["full"]["memory"]
    assert 0 < mem["alias_size_in_bytes"] <= mem["argument_size_in_bytes"]

    multi = dryrun.run_cell("llama3.2-3b", "decode_32k", multi_pod=True,
                            cost_extrapolate=False)
    assert multi["chips"] == 512 and "extrapolated" not in multi
    assert multi["full"]["cost"]["flops"] > 0

    skip = dryrun.run_cell("llama3.2-3b", "long_500k", multi_pod=False)
    assert skip == {"arch": "llama3.2-3b", "cell": "long_500k",
                    "mesh": "single", "skipped": dryrun.FULL_ATTENTION_SKIP}
    assert not dist.is_initialized()


def test_fake_world_refuses_a_standing_group_and_restores_the_hook():
    import sys
    hook = sys.excepthook
    with dryrun.fake_world(8):
        with pytest.raises(RuntimeError, match="already initialised"):
            with dryrun.fake_world(8):
                pass
    assert not dist.is_initialized() and sys.excepthook is hook
