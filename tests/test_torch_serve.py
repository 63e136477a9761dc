"""The port's dense stack and serving loop against the reference.

Reduced llama3.2-3b, granite-3-8b, yi-9b and qwen3-14b in fp32 on CPU.
Params and tokens are made once by numpy from a seed and handed to both
packages (the port through `convert`).  Both port impls ("xla", "pallas":
CPU runs the kernels' plain versions) are held against both reference impls
("xla", "pallas_interpret").
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
from repro.models import api as ref_api, stack as ref_stack  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import ServeRun, generate, serve  # noqa: E402
from repro_torch.models import api, convert, stack  # noqa: E402

ARCHS = ["llama3.2-3b", "granite-3-8b", "yi-9b", "qwen3-14b"]
IMPLS = [("xla", "xla"), ("xla", "pallas_interpret"), ("pallas", "xla"),
         ("pallas", "pallas_interpret")]
# two layers in fp32; XLA and torch sum in different orders
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, NEW = 2, 12, 8     # batch, prompt length, greedy tokens


def _ref_cfg(arch, ref_impl="xla"):
    return dataclasses.replace(
        ref_configs.get(arch, reduced=True), param_dtype=jnp.float32,
        compute_dtype=jnp.float32, kv_dtype=jnp.float32, attn_impl=ref_impl)


def _port_cfg(arch, impl):
    fields = dataclasses.asdict(_ref_cfg(arch))
    return convert.config_from_fields(dict(fields, attn_impl=impl))


@functools.cache
def _numpy_params(arch):
    """Param tree of numpy arrays shaped by the reference's table."""
    rng = np.random.default_rng(zlib.crc32(arch.encode()))

    def leaf(path, sd):
        name = jax.tree_util.keystr(path)
        if name.endswith("_w']") or "_norm" in name:
            return (1 + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, ref_api.abstract_params(_ref_cfg(arch)))


def _tokens(arch):
    rng = np.random.default_rng(7)
    return rng.integers(0, _ref_cfg(arch).vocab, (B, S + 1), dtype=np.int32)


@functools.cache
def _reference(arch, ref_impl):
    """Forward hidden state, prefill logits, one decode step's logits and
    the greedy stream, from the reference."""
    cfg = _ref_cfg(arch, ref_impl)
    params = jax.tree.map(jnp.asarray, _numpy_params(arch))
    toks = jnp.asarray(_tokens(arch))
    h, _ = jax.jit(functools.partial(ref_stack.forward, cfg=cfg))(
        params, batch={"tokens": toks[:, :S]})
    prefill = jax.jit(ref_stack.build_prefill_fn(cfg, max_len=S + NEW))
    decode = jax.jit(ref_stack.build_decode_fn(cfg))
    cache, plogits = prefill(params, {"tokens": toks[:, :S]})
    _, _, dlogits = decode(params, cache, toks[:, S:S + 1], jnp.int32(S))
    # greedy: as repro.launch.serve.serve runs it
    tok = jnp.argmax(plogits, axis=-1)[:, None].astype(jnp.int32)
    stream = [np.asarray(tok[:, 0])]
    for i in range(NEW - 1):
        cache, nxt, _ = decode(params, cache, tok, jnp.int32(S + i))
        tok = nxt[:, None]
        stream.append(np.asarray(nxt))
    return (np.asarray(h), np.asarray(plogits), np.asarray(dlogits),
            np.stack(stream, axis=1))


def _port(arch, impl):
    cfg = _port_cfg(arch, impl)
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


@pytest.mark.parametrize("impl,ref_impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, impl, ref_impl):
    h_want, p_want, d_want, _ = _reference(arch, ref_impl)
    cfg, params = _port(arch, impl)
    toks = torch.from_numpy(_tokens(arch))
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
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_stream_equals_reference(arch, impl, ref_impl):
    cfg, params = _port(arch, impl)
    prompt = torch.from_numpy(_tokens(arch)[:, :S])
    tokens, logits, _, _ = generate(cfg, params, prompt, NEW)
    assert logits.shape == (B, NEW, cfg.padded_vocab)
    np.testing.assert_array_equal(tokens.numpy(), _reference(arch, ref_impl)[3])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    ref_cfg = _ref_cfg(arch)
    want = jax.jit(ref_stack.build_loss_fn(ref_cfg))(
        jax.tree.map(jnp.asarray, _numpy_params(arch)),
        {"tokens": jnp.asarray(_tokens(arch))})
    cfg, params = _port(arch, "xla")
    got = stack.build_loss_fn(cfg)(params,
                                   {"tokens": torch.from_numpy(_tokens(arch))})
    np.testing.assert_allclose(got.item(), float(want), **TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_serve_on_cpu_returns_tokens(impl):
    out = serve(ServeRun(device="cpu", attn_impl=impl), log=lambda _: None)
    assert out["tokens"].shape == (4, 32)
    assert out["logits"].shape == (4, 32, 256)
    assert torch.isfinite(out["logits"]).all()
    assert out["prefill_s"] > 0 and out["decode_tok_per_s"] > 0


def test_every_arch_resolves_and_builds_a_param_table():
    """All ten architectures resolve through `configs.get` (full and
    reduced) and build a param table of the reference's size; an unknown
    arch or family still raises."""
    assert len(configs.ARCH_IDS) == 10
    for arch in configs.ARCH_IDS:
        for reduced in (False, True):
            cfg = configs.get(arch, reduced)
            assert cfg.name.startswith(arch)
            assert api.param_table(cfg)
        assert api.param_count(configs.get(arch)) == \
            ref_api.param_count(ref_configs.get(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-2")
    cfg = dataclasses.replace(configs.get("llama3.2-3b", reduced=True),
                              family="retnet")
    with pytest.raises(ValueError, match="unknown family 'retnet'"):
        api.param_table(cfg)
