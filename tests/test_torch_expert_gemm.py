"""The grouped expert product (`kernels/expert_gemm`) and its route in
`models/moe.py::moe_ep`.

CPU tests hold the plain version (torch.bmm, then the rows past each
expert's count set to 0), the dispatch's per-expert counts, and the
route's rule: the grouped product on a CUDA device without a mesh at a
capacity of at least one row tile with no gradient to take, torch.bmm
otherwise.  The route's own tests let it run on the CPU
(`grouped_on_cpu`), where the plain version stands in for the kernel.  The
`card` tests run the kernel at the expert shapes of `qwen3moe.prefill`
and `nemotronh.prefill` on counts from a real dispatch, and a graphed
decode; they skip without a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_expert_gemm.py -m card
"""
from __future__ import annotations

import dataclasses

import pytest

from torch_cpu import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.expert_gemm import ops as eg_ops  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import api, moe, stack  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

TILE = eg_ops.ROW_TILE


def _operands(e, c, k, n, counts, seed=0, device="cpu"):
    gen = torch.Generator(device=device).manual_seed(seed)
    counts = torch.tensor(counts, dtype=torch.int32, device=device)
    rows = torch.arange(c, device=device)
    x = torch.randn((e, c, k), generator=gen, device=device)
    x = x * (rows[None, :, None] < counts[:, None, None])
    w = torch.randn((e, k, n), generator=gen, device=device)
    return x, w, counts


@pytest.mark.parametrize("cap", [TILE, 300])
def test_plain_version_is_bmm_on_occupied_rows_and_zero_past(cap):
    """Counts of 0, 1, tile - 1, tile and cap: torch.bmm's rows below the
    count, exact zeros at and past it (also where x's rows there are not
    zero), and the wrapper on the CPU is the plain version."""
    counts = [0, 1, TILE - 1, TILE, cap]
    x, w, c = _operands(5, cap, 16, 12, counts)
    x_dirty = x + (x == 0)          # rows past the count hold ones
    got = eg_ops.expert_gemm_plain(x_dirty, w, c)
    want = torch.bmm(x_dirty, w)
    for i, n in enumerate(counts):
        assert torch.equal(got[i, :n], want[i, :n])
        assert bool((got[i, n:] == 0).all())
    assert torch.equal(eg_ops.expert_gemm(x, w, c),
                       eg_ops.expert_gemm_plain(x, w, c))


def test_computed_rows_round_each_count_up_to_whole_tiles():
    c = torch.tensor([0, 1, TILE - 1, TILE, TILE + 1, 3 * TILE],
                     dtype=torch.int32)
    assert int(eg_ops.computed_rows(c)) == (0 + 1 + 1 + 1 + 2 + 3) * TILE


# (seed, T, D, E, k, F, capacity factor, router): the layer tests' shapes
# and two prefill-sized ones whose capacity is at least a row tile
DISPATCH_CASES = {
    "e8_k2": (1, 64, 16, 8, 2, 12, 1.25, "softmax"),
    "e128_k8": (2, 96, 32, 128, 8, 8, 1.25, "softmax"),
    "drops": (3, 256, 16, 4, 2, 12, 0.5, "softmax"),
    "prefill_e8_k2": (4, 640, 16, 8, 2, 12, 1.25, "softmax"),
    "prefill_sigmoid_e16_k4": (5, 512, 16, 16, 4, 12, 1.25, "sigmoid_bias"),
}


def _case(name, act="swiglu"):
    seed, t, d, e, k, f, cf, router = DISPATCH_CASES[name]
    spec = moe.MoESpec(n_experts=e, top_k=k, d_ff=f, capacity_factor=cf,
                       impl="ep", router=router, expert_act=act)
    gen = torch.Generator().manual_seed(seed)
    p = {"w_router": torch.randn((d, e), generator=gen),
         "w1": 0.2 * torch.randn((e, d, f), generator=gen),
         "w2": 0.2 * torch.randn((e, f, d), generator=gen)}
    if act == "swiglu":
        p["w3"] = 0.2 * torch.randn((e, d, f), generator=gen)
    if router == "sigmoid_bias":
        p["router_bias"] = 0.1 * torch.randn((e,), generator=gen)
    return spec, p, torch.randn((2, t // 2, d), generator=gen)


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_counts_are_the_dense_dispatch_kept_pairs(case):
    """`_sorted_dispatch`'s counts are each expert's pairs that the one-hot
    oracle keeps, and its occupied slots are exactly [0, count)."""
    spec, p, x = _case(case)
    xt = x.reshape(-1, x.shape[-1])
    top_p, top_i, _ = moe.router_probs(p, xt, spec)
    cap = moe._capacity(xt.shape[0], spec)
    disp, _ = moe._dense_dispatch(top_p, top_i, cap, spec, xt.dtype)
    _, _, weight, counts = moe._sorted_dispatch(xt, top_p, top_i, cap, spec)
    assert counts.dtype == torch.int32
    assert counts.tolist() == disp.sum((0, 2)).long().tolist()
    rows = torch.arange(cap)
    assert torch.equal(weight > 0, rows[None, :] < counts[:, None])


@pytest.fixture
def grouped_on_cpu(monkeypatch):
    """The grouped route taken on the CPU as on a card, with the kernel's
    plain version in the kernel's place."""
    monkeypatch.setattr(moe, "_GROUPED_DEVICES", ("cuda", "cpu"))


@pytest.fixture
def grouped_calls(monkeypatch, grouped_on_cpu):
    """The calls of the grouped product from `moe`."""
    calls = []
    real = eg_ops.expert_gemm

    def counted(x, w, counts):
        calls.append(tuple(x.shape))
        return real(x, w, counts)
    monkeypatch.setattr(moe.eg_ops, "expert_gemm", counted)
    return calls


@pytest.mark.parametrize("act,products", [("swiglu", 3), ("relu2", 2)])
def test_moe_ep_routes_by_capacity_and_grad(grouped_calls, act, products):
    """A capacity of at least a row tile runs every expert product grouped
    and gives torch.bmm's layer; a capacity of 8 (a decode step) and a
    layer whose weights take a gradient keep torch.bmm."""
    spec, p, x = _case("prefill_e8_k2", act)
    assert moe._capacity(x.shape[0] * x.shape[1], spec) >= TILE
    y, _ = moe.moe_ep(p, x, spec)
    assert len(grouped_calls) == products
    grouped_calls.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "_grouped", lambda *a: False)
        y_bmm, _ = moe.moe_ep(p, x, spec)
    assert not grouped_calls
    torch.testing.assert_close(y, y_bmm, atol=0, rtol=0)
    step = x[:, :2]
    assert moe._capacity(step.shape[0] * step.shape[1], spec) == 8
    moe.moe_ep(p, step, spec)
    assert not grouped_calls
    trained = {k: v.clone().requires_grad_() for k, v in p.items()}
    y_grad, _ = moe.moe_ep(trained, x, spec)
    assert not grouped_calls
    y_grad.sum().backward()
    assert trained["w1"].grad is not None
    with torch.no_grad():
        moe.moe_ep(trained, x, spec)
    assert len(grouped_calls) == products


def test_cpu_tensors_keep_torch_bmm(monkeypatch):
    """On the CPU the layer keeps torch.bmm at a prefill's capacity too:
    there the plain version would do torch.bmm's work and more."""
    calls = []
    monkeypatch.setattr(moe.eg_ops, "expert_gemm",
                        lambda *a: calls.append(1))
    spec, p, x = _case("prefill_e8_k2")
    assert moe._capacity(x.shape[0] * x.shape[1], spec) >= TILE
    moe.moe_ep(p, x, spec)
    assert not calls


@pytest.mark.parametrize("grouped", [True, False],
                         ids=["grouped", "cpu_bmm"])
def test_counters_read_the_rows_computed_and_the_slots(grouped,
                                                       monkeypatch):
    """`moe.rows_computed` counts whole row tiles of occupied slots on the
    grouped route and every slot on torch.bmm's, on the device either way;
    `moe.slots` E * cap."""
    if grouped:
        monkeypatch.setattr(moe, "_GROUPED_DEVICES", ("cuda", "cpu"))
    spec, p, x = _case("prefill_e8_k2")
    t = x.shape[0] * x.shape[1]
    cap = moe._capacity(t, spec)
    xt = x.reshape(t, -1)
    top_p, top_i, _ = moe.router_probs(p, xt, spec)
    counts = moe._sorted_dispatch(xt, top_p, top_i, cap, spec)[3]
    with spans.recorder(device=False) as rec:
        moe.moe_ep(p, x, spec)
        moe.moe_ep(p, x[:, :2], spec)
    c = rec["counters"]["other"]
    e = spec.n_experts
    assert c["moe.slots"] == e * cap + e * 8
    rows = int(eg_ops.computed_rows(counts)) if grouped else e * cap
    if grouped:
        assert rows < e * cap
    assert c["moe.rows_computed"] == rows + e * 8


def test_shared_expert_keeps_torch_bmm(grouped_calls):
    """The shared expert (one expert, every row occupied) is a plain
    batched product: only the routed experts' products are grouped."""
    spec, p, x = _case("prefill_sigmoid_e16_k4", "relu2")
    spec = dataclasses.replace(spec, shared_d_ff=12, routed_scale=2.5)
    gen = torch.Generator().manual_seed(9)
    d = x.shape[-1]
    p = dict(p, shared_w1=0.2 * torch.randn((d, 12), generator=gen),
             shared_w2=0.2 * torch.randn((12, d), generator=gen))
    moe.moe_ffn(p, x, spec)
    assert len(grouped_calls) == 2


# -- on the card -----------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    stack.release_decode_graphs()
    return torch.device("cuda", 0)


# (router, top k, D, F, tokens): the cells' expert layers at a 4 x 2304
# prefill (qwen3moe.prefill, nemotronh.prefill), 128 experts each
CARD_CELLS = {
    "qwen3": ("softmax", 8, 2048, 768, 4 * 2304),
    "nemotron": ("sigmoid_bias", 6, 2688, 1856, 4 * 2304),
}


def _dispatched(cell, dev):
    """A real dispatch of the cell's shape: xe [128, cap, D], counts."""
    router, k, d, f, t = CARD_CELLS[cell]
    spec = moe.MoESpec(n_experts=128, top_k=k, d_ff=f, impl="ep",
                       router=router)
    gen = torch.Generator(device=dev).manual_seed(11)
    p = {"w_router": torch.randn((d, 128), generator=gen, device=dev)
         / d ** 0.5,
         "router_bias": 0.02 * torch.randn((128,), generator=gen,
                                           device=dev)}
    xt = torch.randn((t, d), generator=gen, device=dev)
    top_p, top_i, _ = moe.router_probs(p, xt, spec)
    cap = moe._capacity(t, spec)
    xe, _, _, counts = moe._sorted_dispatch(xt, top_p, top_i, cap, spec)
    return xe, counts, d, f


@pytest.mark.card
@pytest.mark.parametrize("second", [False, True], ids=["w1", "w2"])
@pytest.mark.parametrize("cell", sorted(CARD_CELLS))
def test_card_kernel_equals_bmm_on_occupied_rows(cell, second):
    """At the cell's (K, N) (qwen3: 2048/768, 768/2048; nemotron:
    2688/1856, 1856/2688) on a real dispatch's counts, the occupied rows
    equal torch.bmm's (the largest difference is printed; 0 expected) and
    every row past the count is an exact 0, written into memory that held
    NaN."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    xe, counts, d, f = _dispatched(cell, dev)
    if second:      # the down product's input: [E, cap, F], zero past
        gen = torch.Generator(device=dev).manual_seed(12)
        rows = torch.arange(xe.shape[1], device=dev)
        xe = torch.randn((xe.shape[0], xe.shape[1], f), generator=gen,
                         device=dev) * (rows[None, :, None]
                                        < counts[:, None, None])
        d, f = f, d
    gen = torch.Generator(device=dev).manual_seed(13)
    w = torch.randn((128, d, f), generator=gen, device=dev) / d ** 0.5
    want = torch.bmm(xe, w)
    nan = torch.full_like(want, float("nan"))
    ptr = nan.data_ptr()
    del nan
    got = eg_ops.expert_gemm(xe, w, counts)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr        # the kernel wrote over the NaNs
    rows = torch.arange(xe.shape[1], device=dev)
    occ = (rows[None, :] < counts[:, None])[..., None]
    diff = float((got - want).abs().masked_fill(~occ, 0).max())
    scale = float(want.abs().max())
    print(f"{cell} {'w2' if second else 'w1'}: cap {xe.shape[1]}, "
          f"occupied {int(counts.sum())} of {counts.numel() * xe.shape[1]}, "
          f"largest difference from torch.bmm {diff:.3g} (of {scale:.3g})")
    assert diff <= 1e-6 * scale
    assert bool((got.masked_fill(occ, 0) == 0).all())
    assert bool(torch.isfinite(got).all())


@pytest.mark.card
def test_card_graphed_decode_launches_no_grouped_product():
    """A served prefill whose capacity is a row tile or more runs each
    expert product grouped; the decode steps, replayed from their CUDA
    graph at a capacity of 8, launch the kernel 0 times."""
    dev = _card()
    cfg = dataclasses.replace(
        configs.get("qwen3-moe-30b-a3b", True), param_dtype=torch.float32,
        compute_dtype=torch.float32, kv_dtype=torch.float32,
        attn_impl="pallas")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="ep"))
    params = _to(api.init_params(cfg, torch.Generator().manual_seed(0)), dev)
    spec = stack.moe_spec(cfg)
    b, s = 4, 128
    assert moe._capacity(b * s, spec) >= TILE
    n_groups, plan = cfg.layer_plan()
    n_moe = n_groups * sum(ffn == "moe" for _, ffn in plan)
    prompt = torch.randint(0, cfg.vocab, (b, s), device=dev,
                           dtype=torch.int32)
    generate(cfg, params, prompt, 4)        # warm-up: the eager first step
    eg_ops.expert_gemm.launches = 0
    with spans.recorder(device=True) as rec:
        generate(cfg, params, prompt, 8)
    assert rec["counters"]["decode"]["serve.decode_graph.replays"] >= 6
    assert eg_ops.expert_gemm.launches == 3 * n_moe


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}
