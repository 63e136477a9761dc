"""The port's SSM family (mamba2-780m) against the reference.

Reduced mamba2-780m in fp32 on CPU.  Params and tokens are made once by
numpy from a seed and handed to both packages (the port through
`convert`); `a_log` and `dt_bias` get the reference's init values, so the
decays span the real range (a = -1 .. -16).  Both port impls ("xla",
"pallas": CPU runs the kernel's plain version) are held against both
reference impls ("xla", "pallas_interpret").
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import api as ref_api, mamba as ref_mamba  # noqa: E402
from repro.models import stack as ref_stack  # noqa: E402
from repro_torch import configs  # noqa: E402
from torch_ref_init import ref_init  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch.serve import ServeRun, generate, serve  # noqa: E402
from repro_torch.models import api, convert, io, mamba, stack  # noqa: E402

ARCH = "mamba2-780m"
IMPLS = [("xla", "xla"), ("xla", "pallas_interpret"), ("pallas", "xla"),
         ("pallas", "pallas_interpret")]
# two layers in fp32; XLA and torch sum in different orders
TOL = dict(atol=1e-4, rtol=1e-4)
# batch, prompt length (one full chunk of 16 and a ragged one), new tokens
B, S, NEW = 2, 20, 8


def _ref_cfg(ref_impl="xla"):
    return dataclasses.replace(
        ref_configs.get(ARCH, reduced=True), param_dtype=jnp.float32,
        compute_dtype=jnp.float32, kv_dtype=jnp.float32, ssd_impl=ref_impl)


def _port_cfg(impl):
    fields = dataclasses.asdict(_ref_cfg())
    return convert.config_from_fields(dict(fields, ssd_impl=impl))


@functools.cache
def _numpy_params():
    """Param tree of numpy arrays shaped by the reference's table; a_log
    and dt_bias from the reference's own (deterministic) init."""
    rng = np.random.default_rng(11)
    ref_tree = jax.tree_util.tree_map_with_path(
        lambda p, v: v, ref_init(_ref_cfg(), jax.random.PRNGKey(0)))

    def leaf(path, sd):
        name = jax.tree_util.keystr(path)
        if name.endswith("['a_log']") or name.endswith("['dt_bias']"):
            node = ref_tree
            for k in path:
                node = node[k.key]
            return np.array(node, np.float32)
        if name.endswith("_w']") or name.endswith("['d_skip']"):
            return (1 + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, ref_api.abstract_params(_ref_cfg()))


def _tokens():
    rng = np.random.default_rng(7)
    return rng.integers(0, _ref_cfg().vocab, (B, S + 1), dtype=np.int32)


@functools.cache
def _reference(ref_impl):
    """Forward hidden state, prefill logits, one decode step's logits and
    the greedy stream, from the reference."""
    cfg = _ref_cfg(ref_impl)
    params = jax.tree.map(jnp.asarray, _numpy_params())
    toks = jnp.asarray(_tokens())
    h, _ = jax.jit(functools.partial(ref_stack.forward, cfg=cfg))(
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
    return (np.asarray(h), np.asarray(plogits), np.asarray(dlogits),
            np.stack(stream, axis=1))


def _port(impl):
    cfg = _port_cfg(impl)
    return cfg, convert.params_from_numpy(_numpy_params(), cfg, "cpu")


def test_param_table_matches_reference():
    want = {jax.tree_util.keystr(p): tuple(sd.shape) for p, sd in
            jax.tree_util.tree_flatten_with_path(
                ref_api.abstract_params(_ref_cfg()))[0]}
    got = {"".join(f"['{k}']" for k in path.split("/")): spec.shape
           for path, spec in api.flatten(api.param_table(configs.get(
               ARCH, reduced=True)))}
    assert got == want
    assert api.param_count(configs.get(ARCH)) == \
        ref_api.param_count(ref_configs.get(ARCH)) == 857_846_016


def test_init_matches_reference_deterministic_leaves():
    """a_log, dt_bias and the constant leaves equal the reference's init;
    the random leaves have the table's shapes."""
    cfg = configs.get(ARCH, reduced=True)
    got = dict(api.flatten(api.init_params(
        cfg, torch.Generator().manual_seed(0))))
    ref = dict(api.flatten(_numpy_params()))
    ref_tree = ref_init(_ref_cfg(), jax.random.PRNGKey(0))
    ref_leaves = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                  jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    for path, leaf in got.items():
        assert tuple(leaf.shape) == ref[path].shape, path
        name = path.split("/")[-1]
        if name in ("a_log", "dt_bias", "d_skip", "norm_w", "ln1_w",
                    "lnf_w", "b_conv_x", "b_conv_bc"):
            key = "".join(f"['{k}']" for k in path.split("/"))
            np.testing.assert_allclose(leaf.numpy(), ref_leaves[key],
                                       rtol=1e-6, atol=1e-7)


def test_params_from_numpy_keeps_the_groups_axis():
    cfg, params = _port("xla")
    n_layers = cfg.n_layers
    for path, leaf in api.flatten(params["blocks"]):
        assert leaf.shape[0] == n_layers, path
    assert params["blocks"]["sub0"]["mamba"]["w_x"].shape == (
        n_layers, cfg.d_model, cfg.mamba_spec.d_inner)
    assert "ln2_w" not in params["blocks"]["sub0"]
    assert "mlp" not in params["blocks"]["sub0"]


@pytest.mark.parametrize("impl,ref_impl", IMPLS)
def test_forward_prefill_decode_match_reference(impl, ref_impl):
    h_want, p_want, d_want, _ = _reference(ref_impl)
    cfg, params = _port(impl)
    toks = torch.from_numpy(_tokens())
    with torch.inference_mode():
        h, _ = stack.forward(params, cfg, {"tokens": toks[:, :S]})
        prefill = stack.build_prefill_fn(cfg, max_len=S + NEW)
        cache, plogits = prefill(params, {"tokens": toks[:, :S]})
        _, _, dlogits = stack.build_decode_fn(cfg)(
            params, cache, toks[:, S:S + 1], S)
    np.testing.assert_allclose(h.numpy(), h_want, **TOL)
    np.testing.assert_allclose(plogits.numpy(), p_want, **TOL)
    np.testing.assert_allclose(dlogits.numpy(), d_want, **TOL)


@pytest.mark.parametrize("impl,ref_impl", IMPLS)
def test_greedy_stream_equals_reference(impl, ref_impl):
    cfg, params = _port(impl)
    prompt = torch.from_numpy(_tokens()[:, :S])
    tokens, logits, _, _ = generate(cfg, params, prompt, NEW)
    assert logits.shape == (B, NEW, cfg.padded_vocab)
    np.testing.assert_array_equal(tokens.numpy(), _reference(ref_impl)[3])


def test_loss_matches_reference():
    want = jax.jit(ref_stack.build_loss_fn(_ref_cfg()))(
        jax.tree.map(jnp.asarray, _numpy_params()),
        {"tokens": jnp.asarray(_tokens())})
    cfg, params = _port("xla")
    got = stack.build_loss_fn(cfg)(params,
                                   {"tokens": torch.from_numpy(_tokens())})
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_decode_carries_the_ssm_and_conv_state():
    """Prefill writes the SSM state and the conv tails into the cache, and
    decode reads them: decoding after prefill differs from decoding the
    same token from a zeroed cache, and the prefilled cache matches the
    reference's."""
    cfg, params = _port("pallas")
    toks = torch.from_numpy(_tokens())
    ref_cfg = _ref_cfg()
    ref_cache, _ = jax.jit(ref_stack.build_prefill_fn(ref_cfg, S + NEW))(
        jax.tree.map(jnp.asarray, _numpy_params()),
        {"tokens": jnp.asarray(_tokens()[:, :S])})
    with torch.inference_mode():
        cache, _ = stack.build_prefill_fn(cfg, S + NEW)(
            params, {"tokens": toks[:, :S]})
        for name in ("ssm", "conv_x", "conv_bc"):
            got = cache["sub0"][name]
            assert bool(got.abs().sum() > 0), name
            np.testing.assert_allclose(
                got.numpy(), np.asarray(ref_cache["sub0"][name]), **TOL)
        decode = stack.build_decode_fn(cfg)
        _, _, carried = decode(params, cache, toks[:, S:S + 1], S)
        zero = stack.init_cache(cfg, B, S + NEW, "cpu")
        _, _, fresh = decode(params, zero, toks[:, S:S + 1], S)
    assert float((carried - fresh).abs().max()) > 1e-2


def test_cache_shapes_match_reference():
    cfg = _port_cfg("xla")
    got = {n: (tuple(t.shape), t.dtype) for n, t in
           stack.init_cache(cfg, 3, 40, "cpu")["sub0"].items()}
    want = jax.tree.map(lambda sd: tuple(sd.shape),
                        ref_stack.abstract_cache(_ref_cfg(), 3, 40))["sub0"]
    assert {n: s for n, (s, _) in got.items()} == want
    assert got["ssm"][1] == torch.float32


@pytest.mark.parametrize("seqlen", [1, 2, 9])
def test_causal_conv_matches_reference(seqlen):
    """The sum of shifted products equals the reference's grouped conv,
    including sequences shorter than the kernel."""
    rng = np.random.default_rng(seqlen)
    u = rng.standard_normal((2, seqlen, 24), np.float32)
    w = rng.standard_normal((4, 24), np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    want = ref_mamba._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                  jnp.asarray(bias))
    got = mamba._causal_conv(torch.from_numpy(u), torch.from_numpy(w),
                             torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


def test_prefill_counts_no_launch_on_cpu():
    """The CPU path never reaches the kernel: the launch count stays."""
    cfg, params = _port("pallas")
    before = ssd_ops.ssd.launches
    with torch.inference_mode():
        stack.build_prefill_fn(cfg, S + NEW)(
            params, {"tokens": torch.from_numpy(_tokens()[:, :S])})
    assert ssd_ops.ssd.launches == before


def test_make_batch_is_tokens_only():
    cfg = configs.get(ARCH, reduced=True)
    batch = io.make_batch(cfg, io.smoke_cell("prefill", 3, 17),
                          torch.Generator().manual_seed(0))
    assert set(batch) == {"tokens"}
    assert batch["tokens"].shape == (3, 17)
    assert batch["tokens"].dtype == torch.int32


def test_serve_on_cpu_returns_tokens():
    out = serve(ServeRun(arch=ARCH, device="cpu"), log=lambda _: None)
    assert out["tokens"].shape == (4, 32)
    assert out["logits"].shape == (4, 32, 256)
    assert torch.isfinite(out["logits"]).all()
