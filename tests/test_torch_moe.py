"""The port's MoE layer and the MoE and hybrid families against the reference.

Layer tests feed numpy inputs made from seeds to `repro.models.moe` and
`repro_torch.models.moe`.  Model tests run the reduced qwen3-moe-30b-a3b,
phi3.5-moe-42b-a6.6b and jamba-v0.1-52b in fp32 on the CPU: params are
made once by numpy from a seed in the shapes of the reference's param table
(jamba's `a_log` and `dt_bias` from the reference's own deterministic
init) and handed to both packages, the port's through `convert`.  The
port runs both MoE routes, "dense" (the one-hot oracle) and "ep" (gather
and `index_add_`), with the plain and the kernel knob ("pallas": the CPU
runs the kernels' plain versions); the reference runs its plain path,
where `moe_ffn` without a mesh is `moe_dense`.  fp32 at atol = rtol =
1e-4 unless stated; routing (`top_i`) and drops exactly.
"""
from __future__ import annotations

import dataclasses
import functools
import zlib

import numpy as np
import pytest

from torch_cpu import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import api as ref_api, moe as ref_moe  # noqa: E402
from repro.models import stack as ref_stack  # noqa: E402
from repro_torch import configs  # noqa: E402
from torch_ref_init import ref_init  # noqa: E402
from repro_torch.kernels.expert_gemm import ops as eg_ops  # noqa: E402
from repro_torch.launch.serve import ServeRun, generate, serve  # noqa: E402
from repro_torch.models import api, convert, moe, stack  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def grouped_on_cpu(monkeypatch):
    """`moe_ep` takes the grouped expert product on the CPU as on a card
    (the kernel's plain version in the kernel's place), so that the layer
    cases whose capacity reaches a row tile hold that route's dispatch
    counts and masking to the reference."""
    monkeypatch.setattr(moe, "_GROUPED_DEVICES", ("cuda", "cpu"))


ARCHS = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b", "jamba-v0.1-52b"]
# (attn_impl, moe impl) of the port; "pallas" also sets ssd_impl
IMPLS = [("xla", "dense"), ("xla", "ep"), ("pallas", "dense"),
         ("pallas", "ep")]
B, S, NEW = 2, 20, 8     # batch, prompt length, greedy tokens


# -- the layer ---------------------------------------------------------------


def _specs(e, k, f, cf=1.25):
    return (ref_moe.MoESpec(n_experts=e, top_k=k, d_ff=f, capacity_factor=cf),
            moe.MoESpec(n_experts=e, top_k=k, d_ff=f, capacity_factor=cf))


def _layer_params(seed, d, e, f, zero_router=False):
    rng = np.random.default_rng(seed)
    p = {"w_router": rng.standard_normal((d, e)).astype(np.float32),
         "w1": (0.2 * rng.standard_normal((e, d, f))).astype(np.float32),
         "w3": (0.2 * rng.standard_normal((e, d, f))).astype(np.float32),
         "w2": (0.2 * rng.standard_normal((e, f, d))).astype(np.float32)}
    if zero_router:
        p["w_router"] = np.zeros_like(p["w_router"])
    return p


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


# the reference's layer functions, jitted (eager JAX is slow on the CPU)
ref_router_probs = jax.jit(ref_moe.router_probs, static_argnums=2)
ref_moe_dense = jax.jit(ref_moe.moe_dense, static_argnums=2)
ref_sorted_dispatch = jax.jit(ref_moe._sorted_dispatch_local,
                              static_argnums=(3, 4, 5, 6))


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


# (seed, T, D, E, k, F, capacity_factor): an ordinary case, qwen3-moe's
# 128-expert top-8 router, and T=256, E=4, k=2 at capacity_factor 0.5,
# where a quarter of the (token, k) pairs and more are dropped; then two
# whose capacity is at least the grouped expert product's row tile, so
# that `moe_ep` runs `expert_gemm` (its plain version on the CPU: the
# file's `grouped_on_cpu` lets the route run there as on a card)
LAYER_CASES = {
    "e8_k2": (1, 64, 16, 8, 2, 12, 1.25),
    "e128_k8": (2, 96, 32, 128, 8, 8, 1.25),
    "drops": (3, 256, 16, 4, 2, 12, 0.5),
    "grouped_e8_k2": (7, 512, 16, 8, 2, 12, 1.25),
    "grouped_e16_k4_drops": (8, 512, 16, 16, 4, 12, 0.75),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_router_probs_matches_reference(case):
    seed, t, d, e, k, f, cf = LAYER_CASES[case]
    ref_spec, spec = _specs(e, k, f, cf)
    p = _layer_params(seed, d, e, f)
    x = _x(seed + 100, 1, t, d)[0]
    want_p, want_i, want_aux = ref_router_probs(_j(p), jnp.asarray(x),
                                                    ref_spec)
    got_p, got_i, got_aux = moe.router_probs(_t(p), torch.from_numpy(x), spec)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), **TOL)


@pytest.mark.parametrize("n_tokens,e,k,cf", [
    (1, 4, 2, 1.25), (4, 128, 8, 1.25), (4, 16, 2, 1.25), (40, 8, 2, 1.25),
    (256, 4, 2, 0.5), (4096, 128, 8, 1.25), (4096, 16, 2, 1.25),
    (1000, 7, 3, 1.1)])
def test_capacity_matches_reference(n_tokens, e, k, cf):
    ref_spec, spec = _specs(e, k, 8, cf)
    assert moe._capacity(n_tokens, spec) == \
        ref_moe._capacity(n_tokens, ref_spec)
    assert moe._capacity(n_tokens, spec) % 8 == 0


def test_full_width_capacities():
    """The prefill at B=4, S=1024 (T=4096): jamba 640, qwen3-moe 320."""
    for arch, cap in (("jamba-v0.1-52b", 640), ("qwen3-moe-30b-a3b", 320)):
        spec = stack.moe_spec(configs.get(arch))
        assert moe._capacity(4096, spec) == cap, arch


def test_all_equal_probabilities_route_to_the_lowest_experts():
    """With a zero router every probability is equal: both packages take
    experts 0 .. k-1, as jax.lax.top_k breaks ties."""
    ref_spec, spec = _specs(128, 8, 8)
    p = _layer_params(4, 32, 128, 8, zero_router=True)
    x = _x(5, 1, 24, 32)[0]
    _, want_i, _ = ref_router_probs(_j(p), jnp.asarray(x), ref_spec)
    _, got_i, _ = moe.router_probs(_t(p), torch.from_numpy(x), spec)
    lowest = np.broadcast_to(np.arange(8), (24, 8))
    np.testing.assert_array_equal(np.asarray(want_i), lowest)
    np.testing.assert_array_equal(got_i.numpy(), lowest)


def _kept_dense(x, p, spec):
    """(token, expert) pairs the one-hot dispatch keeps, and its capacity."""
    xt = torch.from_numpy(x).reshape(-1, x.shape[-1])
    top_p, top_i, _ = moe.router_probs(_t(p), xt, spec)
    cap = moe._capacity(xt.shape[0], spec)
    disp, _ = moe._dense_dispatch(top_p, top_i, cap, spec, xt.dtype)
    t, e, _ = torch.nonzero(disp, as_tuple=True)
    return set(zip(t.tolist(), e.tolist())), top_i, cap


def _kept_gather(src_idx, weight):
    e = np.broadcast_to(np.arange(src_idx.shape[0])[:, None], src_idx.shape)
    keep = np.asarray(weight) > 0
    return set(zip(np.asarray(src_idx)[keep].tolist(), e[keep].tolist()))


LAYER_ROUTE_CASES = ["e8_k2", "e128_k8", "drops", "ties", "grouped_e8_k2",
                     "grouped_e16_k4_drops"]


def _layer_case(case):
    if case == "ties":
        seed, t, d, e, k, f, cf = 6, 64, 16, 4, 2, 12, 1.25
    else:
        seed, t, d, e, k, f, cf = LAYER_CASES[case]
    p = _layer_params(seed, d, e, f, zero_router=case == "ties")
    return _specs(e, k, f, cf), p, _x(seed + 100, 2, t // 2, d)


@pytest.mark.parametrize("case", LAYER_ROUTE_CASES)
def test_dispatch_drops_the_reference_pairs(case):
    """Both routes keep exactly the (token, expert) pairs the reference's
    sorted dispatch keeps, also where pairs are dropped."""
    (ref_spec, spec), p, x = _layer_case(case)
    xt = x.reshape(-1, x.shape[-1])
    e = spec.n_experts
    top_p, top_i, _ = ref_router_probs(_j(p), jnp.asarray(xt), ref_spec)
    cap = ref_moe._capacity(xt.shape[0], ref_spec)
    _, ref_src, ref_w = ref_sorted_dispatch(
        jnp.asarray(xt), top_p, top_i, 0, e, cap, ref_spec)
    want = _kept_gather(ref_src, ref_w)
    kept, got_i, got_cap = _kept_dense(x, p, spec)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(top_i))
    assert got_cap == cap and kept == want
    tp, ti, _ = moe.router_probs(_t(p), torch.from_numpy(xt), spec)
    _, src, w, _ = moe._sorted_dispatch(torch.from_numpy(xt), tp, ti, cap,
                                        spec)
    np.testing.assert_array_equal(src.numpy(), np.asarray(ref_src))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), **TOL)
    assert _kept_gather(src.numpy(), w.numpy()) == want
    # only e8_k2 fits every pair: 128 experts at capacity 8 overflow too
    assert (len(want) < xt.shape[0] * spec.top_k) == (case != "e8_k2")


@pytest.mark.parametrize("impl", ["dense", "ep"])
@pytest.mark.parametrize("case", LAYER_ROUTE_CASES)
def test_moe_routes_match_reference_dense(case, impl):
    """moe_ffn on either route against the reference's moe_dense."""
    (ref_spec, spec), p, x = _layer_case(case)
    want_y, want_aux = ref_moe_dense(_j(p), jnp.asarray(x), ref_spec)
    got_y, got_aux = moe.moe_ffn(_t(p), torch.from_numpy(x),
                                 dataclasses.replace(spec, impl=impl))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), **TOL)


@pytest.mark.parametrize("case", LAYER_ROUTE_CASES)
def test_gather_route_matches_reference_ep_on_one_device(case):
    """The reference's shard_map expert-parallel route on a 1x1 CPU mesh is
    a third witness for the port's gather route."""
    (ref_spec, spec), p, x = _layer_case(case)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want_y, want_aux = jax.jit(functools.partial(
        ref_moe.moe_ep, spec=dataclasses.replace(ref_spec, impl="ep"),
        mesh=mesh))(_j(p), jnp.asarray(x))
    got_y, got_aux = moe.moe_ep(_t(p), torch.from_numpy(x), spec)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), **TOL)


@pytest.mark.parametrize("case", ["drops", "grouped_e8_k2",
                                  "grouped_e16_k4_drops"])
def test_gather_route_runs_the_grouped_product_at_a_row_tile(case,
                                                             monkeypatch):
    """At a capacity of a row tile or more the gather route's three expert
    products are `expert_gemm`'s, which the cases above hold to the
    reference."""
    (_, spec), p, x = _layer_case(case)
    assert moe._capacity(x.shape[0] * x.shape[1], spec) >= \
        eg_ops.ROW_TILE
    calls = []
    real = eg_ops.expert_gemm
    monkeypatch.setattr(moe.eg_ops, "expert_gemm",
                        lambda *a: calls.append(1) or real(*a))
    moe.moe_ep(_t(p), torch.from_numpy(x), spec)
    assert len(calls) == 3


def test_routes_agree_to_rounding():
    """The routes differ only in the order of each token's <= k-term
    combine, so they agree far inside the tolerance."""
    (_, spec), p, x = _layer_case("drops")
    x = torch.from_numpy(x)
    yd, ad = moe.moe_dense(_t(p), x, spec)
    ye, ae = moe.moe_ep(_t(p), x, spec)
    torch.testing.assert_close(ye, yd, atol=2e-6, rtol=2e-6)
    assert float(ae) == float(ad)


def test_unknown_impl_raises():
    (_, spec), p, x = _layer_case("e8_k2")
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.moe_ffn(_t(p), torch.from_numpy(x),
                    dataclasses.replace(spec, impl="sharded"))


# -- the reduced models ------------------------------------------------------


def _ref_cfg(arch):
    return dataclasses.replace(
        ref_configs.get(arch, reduced=True), param_dtype=jnp.float32,
        compute_dtype=jnp.float32, kv_dtype=jnp.float32)


def _port_cfg(arch, attn_impl, moe_impl):
    fields = dataclasses.asdict(_ref_cfg(arch))
    fields["moe"] = dict(fields["moe"], impl=moe_impl)
    return convert.config_from_fields(dict(fields, attn_impl=attn_impl,
                                           ssd_impl=attn_impl))


@functools.cache
def _numpy_params(arch):
    """Param tree of numpy arrays shaped by the reference's table; a_log
    and dt_bias (jamba's) from the reference's deterministic init."""
    cfg = _ref_cfg(arch)
    rng = np.random.default_rng(zlib.crc32(arch.encode()))
    ref_tree = ref_init(cfg, jax.random.PRNGKey(0))

    def leaf(path, sd):
        name = jax.tree_util.keystr(path)
        if name.endswith("['a_log']") or name.endswith("['dt_bias']"):
            node = ref_tree
            for k in path:
                node = node[k.key]
            return np.array(node, np.float32)
        if name.endswith("_w']") or name.endswith("['d_skip']") \
                or "_norm" in name:
            return (1 + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, ref_api.abstract_params(cfg))


def _tokens(arch):
    rng = np.random.default_rng(7)
    return rng.integers(0, _ref_cfg(arch).vocab, (B, S + 1), dtype=np.int32)


@functools.cache
def _reference(arch):
    """Forward hidden state and aux, prefill logits, one decode step's
    logits, the greedy stream and the loss, from the reference."""
    cfg = _ref_cfg(arch)
    params = jax.tree.map(jnp.asarray, _numpy_params(arch))
    toks = jnp.asarray(_tokens(arch))
    h, aux = jax.jit(functools.partial(ref_stack.forward, cfg=cfg))(
        params, batch={"tokens": toks[:, :S]})
    prefill = jax.jit(ref_stack.build_prefill_fn(cfg, max_len=S + NEW))
    decode = jax.jit(ref_stack.build_decode_fn(cfg))
    cache, plogits = prefill(params, {"tokens": toks[:, :S]})
    _, _, dlogits = decode(params, cache, toks[:, S:S + 1], jnp.int32(S))
    tok = jnp.argmax(plogits, axis=-1)[:, None].astype(jnp.int32)
    stream = [np.asarray(tok[:, 0])]
    for i in range(NEW - 1):
        cache, nxt, _ = decode(params, cache, tok, jnp.int32(S + i))
        tok = nxt[:, None]
        stream.append(np.asarray(nxt))
    loss = jax.jit(ref_stack.build_loss_fn(cfg))(params, {"tokens": toks})
    return {"h": np.asarray(h), "aux": float(aux),
            "prefill": np.asarray(plogits), "decode": np.asarray(dlogits),
            "stream": np.stack(stream, axis=1), "loss": float(loss)}


def _port(arch, attn_impl="xla", moe_impl="dense"):
    cfg = _port_cfg(arch, attn_impl, moe_impl)
    return cfg, convert.params_from_numpy(_numpy_params(arch), cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_table_matches_reference(arch):
    want = {jax.tree_util.keystr(p): tuple(sd.shape) for p, sd in
            jax.tree_util.tree_flatten_with_path(
                ref_api.abstract_params(_ref_cfg(arch)))[0]}
    got = {"".join(f"['{k}']" for k in path.split("/")): spec.shape
           for path, spec in api.flatten(api.param_table(configs.get(
               arch, reduced=True)))}
    assert got == want
    assert api.param_count(configs.get(arch)) == \
        ref_api.param_count(ref_configs.get(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_plan_matches_reference(arch):
    for reduced in (False, True):
        assert configs.get(arch, reduced).layer_plan() == \
            ref_configs.get(arch, reduced).layer_plan()


def test_init_draws_the_moe_leaves_by_the_reference_rule():
    """The router and expert weights are truncated normals scaled by
    min(0.02, fan_in ** -0.5), fan_in = d_model, as the reference's."""
    cfg = configs.get("qwen3-moe-30b-a3b", reduced=True)
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    sub = params["blocks"]["sub0"]["moe"]
    scale = min(0.02, cfg.d_model ** -0.5)
    for name in ("w_router", "w1", "w3", "w2"):
        leaf = sub[name]
        assert float(leaf.abs().max()) <= 2 * scale + 1e-7, name
        assert 0.5 * scale < float(leaf.std()) < scale, name
    assert sub["w1"].shape == (cfg.n_layers, 8, cfg.d_model, 32)


@pytest.mark.parametrize("attn_impl,moe_impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, attn_impl, moe_impl):
    want = _reference(arch)
    cfg, params = _port(arch, attn_impl, moe_impl)
    toks = torch.from_numpy(_tokens(arch))
    with torch.inference_mode():
        h, aux = stack.forward(params, cfg, {"tokens": toks[:, :S]})
        prefill = stack.build_prefill_fn(cfg, max_len=S + NEW)
        cache, plogits = prefill(params, {"tokens": toks[:, :S]})
        _, _, dlogits = stack.build_decode_fn(cfg)(
            params, cache, toks[:, S:S + 1], S)
    np.testing.assert_allclose(h.numpy(), want["h"], **TOL)
    np.testing.assert_allclose(aux.item(), want["aux"], **TOL)
    assert aux.item() > 0
    np.testing.assert_allclose(plogits.numpy(), want["prefill"], **TOL)
    np.testing.assert_allclose(dlogits.numpy(), want["decode"], **TOL)


@pytest.mark.parametrize("moe_impl", ["dense", "ep"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_stream_equals_reference(arch, moe_impl):
    cfg, params = _port(arch, "pallas", moe_impl)
    prompt = torch.from_numpy(_tokens(arch)[:, :S])
    tokens, logits, _, _ = generate(cfg, params, prompt, NEW)
    assert logits.shape == (B, NEW, cfg.padded_vocab)
    np.testing.assert_array_equal(tokens.numpy(), _reference(arch)["stream"])


@pytest.mark.parametrize("moe_impl", ["dense", "ep"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, moe_impl):
    """The loss carries the aux term (weight 0.01)."""
    cfg, params = _port(arch, "xla", moe_impl)
    got = stack.build_loss_fn(cfg)(params,
                                   {"tokens": torch.from_numpy(_tokens(arch))})
    np.testing.assert_allclose(got.item(), _reference(arch)["loss"], **TOL)


def test_hybrid_cache_shapes_match_reference():
    arch = "jamba-v0.1-52b"
    cfg = _port_cfg(arch, "xla", "dense")
    got = {name: {k: tuple(t.shape) for k, t in sub.items()}
           for name, sub in stack.init_cache(cfg, 3, 40, "cpu").items()}
    want = jax.tree.map(lambda sd: tuple(sd.shape),
                        ref_stack.abstract_cache(_ref_cfg(arch), 3, 40))
    assert got == want
    n_groups, plan = cfg.layer_plan()
    assert [("k" in got[f"sub{i}"]) for i in range(len(plan))] == \
        [mixer == "attn" for mixer, _ in plan]


@pytest.mark.parametrize("moe_impl", ["dense", "ep"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, moe_impl):
    """tests/test_smoke_archs.py's check on the port: prefill of s tokens
    matches the teacher-forced forward at s-1 (2e-4) and decoding token s
    matches it at s (2e-4; 2e-2 for the SSD hybrid, whose decode step
    recomputes the scan state in another order)."""
    cfg, params = _port(arch, "pallas", moe_impl)
    tokens = torch.from_numpy(_tokens(arch))[:, :17]
    s = 16
    with torch.inference_mode():
        h, _ = stack.forward(params, cfg, {"tokens": tokens})
        full = stack.unembed(params, cfg, h)
        cache, plogits = stack.build_prefill_fn(cfg, s + 1)(
            params, {"tokens": tokens[:, :s]})
        _, _, dlogits = stack.build_decode_fn(cfg)(
            params, cache, tokens[:, s:s + 1], s)
    torch.testing.assert_close(plogits, full[:, s - 1], atol=2e-4, rtol=2e-4)
    tol = 2e-2 if cfg.ssm is not None else 2e-4
    torch.testing.assert_close(dlogits, full[:, s], atol=tol, rtol=tol)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_serve_picks_the_moe_route_by_the_kernel_knob(attn_impl,
                                                      monkeypatch):
    """serve() on the card path gathers ("ep"); on the plain path it runs
    the oracle ("dense")."""
    seen = []
    real = moe.moe_ffn
    monkeypatch.setattr(moe, "moe_ffn", lambda p, x, spec: (
        seen.append(spec.impl), real(p, x, spec))[1])
    out = serve(ServeRun(arch="qwen3-moe-30b-a3b", device="cpu",
                         attn_impl=attn_impl, batch=2, prompt_len=8,
                         max_new_tokens=4), log=lambda _: None)
    assert out["tokens"].shape == (2, 4)
    assert torch.isfinite(out["logits"]).all()
    assert set(seen) == {"ep" if attn_impl == "pallas" else "dense"}
