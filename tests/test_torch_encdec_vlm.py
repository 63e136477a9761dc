"""The port's encoder-decoder (whisper) and VLM (phi-3-vision) families
against the reference.

Reduced whisper-large-v3 and phi-3-vision-4.2b in fp32 on the CPU.  Params
are made once by numpy from a seed in the shapes of the reference's param
table and handed to both packages (the port's through `convert`).  The
reference's init sets the attention biases `bq`, `bv`, `bo` and every
LayerNorm bias to zero, where a missing bias term would go unseen, so every
leaf here is drawn at random, the biases too.  The stub frames and patches
are numpy draws rounded to bf16, as `make_batch` makes them bf16.  Both
port impls ("xla", "pallas": the CPU runs the kernels' plain versions) are
held against both reference impls ("xla", "pallas_interpret") at atol =
rtol = 1e-4; the decode-vs-forward check of tests/test_smoke_archs.py at
2e-4.
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
from repro.models import api as ref_api, layers as ref_layers  # noqa: E402
from repro.models import stack as ref_stack  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch.serve import ServeRun, generate, serve  # noqa: E402
from repro_torch.models import api, convert, io, layers, stack  # noqa: E402

ARCHS = ["whisper-large-v3", "phi-3-vision-4.2b"]
WHISPER = "whisper-large-v3"
IMPLS = [("xla", "xla"), ("xla", "pallas_interpret"), ("pallas", "xla"),
         ("pallas", "pallas_interpret")]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, NEW = 2, 12, 8     # batch, prompt length, greedy tokens
STUB = {"encdec": "frames", "vlm": "patches"}


def _ref_cfg(arch, ref_impl="xla"):
    return dataclasses.replace(
        ref_configs.get(arch, reduced=True), param_dtype=jnp.float32,
        compute_dtype=jnp.float32, kv_dtype=jnp.float32, attn_impl=ref_impl)


def _port_cfg(arch, impl):
    fields = dataclasses.asdict(_ref_cfg(arch))
    return convert.config_from_fields(dict(fields, attn_impl=impl))


@functools.cache
def _numpy_params(arch):
    """Param tree of numpy arrays shaped by the reference's table; norm
    weights near 1, every other leaf (biases and `dec_pos` included) at
    0.1 x normal."""
    rng = np.random.default_rng(zlib.crc32(arch.encode()))

    def leaf(path, sd):
        if jax.tree_util.keystr(path).endswith("_w']"):
            return (1 + 0.1 * rng.standard_normal(sd.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, ref_api.abstract_params(_ref_cfg(arch)))


def _bf16(a):
    """numpy fp32 rounded to bf16 and back, as both packages round it."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@functools.cache
def _batch_np(arch):
    """Tokens [B, S+1] and the stub input ("frames" [B, enc_seq, D] or
    "patches" [B, n_patches, D], bf16 values) as numpy."""
    cfg = _ref_cfg(arch)
    rng = np.random.default_rng(7)
    n = cfg.enc_seq if cfg.family == "encdec" else cfg.n_patches
    return {"tokens": rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32),
            STUB[cfg.family]: _bf16(rng.standard_normal((B, n, cfg.d_model))
                                    .astype(np.float32))}


def _ref_batch(arch, n_tokens=S):
    b = _batch_np(arch)
    return {k: (jnp.asarray(v[:, :n_tokens]) if k == "tokens"
                else jnp.asarray(v).astype(jnp.bfloat16))
            for k, v in b.items()}


def _port_batch(arch, n_tokens=S):
    b = _batch_np(arch)
    return {k: (torch.from_numpy(v[:, :n_tokens]) if k == "tokens"
                else torch.from_numpy(v).to(torch.bfloat16))
            for k, v in b.items()}


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree):
    """Copies: the port writes its cache in place."""
    return {"".join(f"['{k}']" for k in path.split("/")): t.numpy().copy()
            for path, t in api.flatten(tree)}


@functools.cache
def _reference(arch, ref_impl):
    """Forward hidden state, prefill logits and cache, one decode step's
    logits, the greedy stream and the loss, from the reference."""
    cfg = _ref_cfg(arch, ref_impl)
    params = jax.tree.map(jnp.asarray, _numpy_params(arch))
    batch = _ref_batch(arch)
    h, _ = jax.jit(functools.partial(ref_stack.forward, cfg=cfg))(
        params, batch=batch)
    prefill = jax.jit(ref_stack.build_prefill_fn(cfg, max_len=S + NEW))
    decode = jax.jit(ref_stack.build_decode_fn(cfg))
    cache, plogits = prefill(params, batch)
    next_tok = jnp.asarray(_batch_np(arch)["tokens"][:, S:S + 1])
    _, _, dlogits = decode(params, cache, next_tok, jnp.int32(S))
    tok = jnp.argmax(plogits, axis=-1)[:, None].astype(jnp.int32)
    stream, c = [np.asarray(tok[:, 0])], cache
    for i in range(NEW - 1):
        c, nxt, _ = decode(params, c, tok, jnp.int32(S + i))
        tok = nxt[:, None]
        stream.append(np.asarray(nxt))
    loss = jax.jit(ref_stack.build_loss_fn(cfg))(
        params, _ref_batch(arch, S + 1))
    return {"h": np.asarray(h), "prefill": np.asarray(plogits),
            "cache": _leaves(cache), "decode": np.asarray(dlogits),
            "stream": np.stack(stream, axis=1), "loss": float(loss)}


def _port(arch, impl):
    cfg = _port_cfg(arch, impl)
    return cfg, convert.params_from_numpy(_numpy_params(arch), cfg, "cpu")


# -- configs, tables, inputs --------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_table_and_plan_match_reference(arch):
    want = {jax.tree_util.keystr(p): tuple(sd.shape) for p, sd in
            jax.tree_util.tree_flatten_with_path(
                ref_api.abstract_params(_ref_cfg(arch)))[0]}
    got = {"".join(f"['{k}']" for k in path.split("/")): spec.shape
           for path, spec in api.flatten(api.param_table(configs.get(
               arch, reduced=True)))}
    assert got == want
    for reduced in (False, True):
        assert configs.get(arch, reduced).layer_plan() == \
            ref_configs.get(arch, reduced).layer_plan()


def test_full_width_param_counts():
    assert api.param_count(configs.get(WHISPER)) == 1_607_480_320
    assert api.param_count(configs.get("phi-3-vision-4.2b")) == 3_822_259_200


@pytest.mark.parametrize("arch", ARCHS)
def test_numpy_params_fill_every_bias(arch):
    """The bias leaves the reference initialises to zero are random here,
    so a term the port left out would show."""
    leaves = _leaves(_numpy_params(arch))
    biases = [k for k in leaves if k.endswith(("_b']", "['bq']", "['bv']",
                                               "['bo']", "['b_up']",
                                               "['b_down']"))]
    assert bool(biases) == (arch == WHISPER)
    for k in biases:
        assert np.abs(leaves[k]).min() > 0, k


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_adds_the_stub_input(arch):
    cfg = configs.get(arch, reduced=True)
    cell = io.smoke_cell("prefill", b=3, s=16)
    batch = io.make_batch(cfg, cell, torch.Generator().manual_seed(0))
    name = STUB[cfg.family]
    n = cfg.enc_seq if cfg.family == "encdec" else cfg.n_patches
    assert set(batch) == {"tokens", name}
    assert batch["tokens"].shape == (3, 16)
    assert batch["tokens"].dtype == torch.int32
    stub = batch[name]
    assert stub.shape == (3, n, cfg.d_model) and stub.dtype == torch.bfloat16
    assert 0.01 < float(stub.float().std()) < 0.03      # normal x 0.02


# -- the layers ---------------------------------------------------------------


@pytest.mark.parametrize("seq,dim", [(8, 64), (64, 16), (1536, 64)])
def test_sinusoidal_positions_match_reference(seq, dim):
    got = stack.sinusoidal_positions(seq, dim)
    want = np.asarray(ref_stack.sinusoidal_positions(seq, dim))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_sinusoidal_positions_full_width_keep_fp32_accuracy():
    """At whisper's full encoder shape (1536 frames, d 1280) the angle
    pos x freq, rounded to fp32, is ~1e-4 off at the last positions in
    both packages, and an ulp of difference between the two libraries'
    exp moves it as far; so each is held against an fp64 computation of
    the same formula, the port within 1.25x the reference's own error."""
    seq, dim = 1536, 1280
    pos = np.arange(seq, dtype=np.float64)[:, None]
    freq = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    exact = np.zeros((seq, dim))
    exact[:, 0::2], exact[:, 1::2] = np.sin(pos * freq), np.cos(pos * freq)
    err_port = np.abs(stack.sinusoidal_positions(seq, dim).numpy()
                      - exact).max()
    err_ref = np.abs(np.asarray(ref_stack.sinusoidal_positions(seq, dim))
                     - exact).max()
    assert err_port <= 1.25 * err_ref, (err_port, err_ref)


def _layer_inputs(seed, s, se=6):
    cfg = _ref_cfg(WHISPER)
    rng = np.random.default_rng(seed)
    p = _numpy_params(WHISPER)["blocks"]["sub0"]["xattn"]
    p = {k: v[0] for k, v in p.items()}
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, se, cfg.d_model)).astype(np.float32)
    return cfg, p, x, enc


def test_cross_kv_from_encoder_matches_reference():
    cfg, p, _, enc = _layer_inputs(1, 1)
    want = ref_layers.cross_kv_from_encoder(
        jax.tree.map(jnp.asarray, p), jnp.asarray(enc), cfg.attn_spec)
    got = layers.cross_kv_from_encoder(convert.tree_from_numpy(p, "cpu"),
                                       torch.from_numpy(enc),
                                       _port_cfg(WHISPER, "xla").attn_spec)
    for g, w in zip(got, want):
        assert g.shape == (B, 6, cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("s,chunk", [(1, 0), (7, 0), (7, 4)])
def test_cross_attention_matches_reference(s, chunk):
    """The cross-attention branch of `attention`: a decode step (s = 1), a
    prefill, and the chunked path; the query of each position sees every
    encoder position, and the kernel knob changes nothing."""
    cfg, p, x, enc = _layer_inputs(2, s)
    spec = dataclasses.replace(cfg.attn_spec, attn_chunk=chunk)
    jp = jax.tree.map(jnp.asarray, p)
    ck = ref_layers.cross_kv_from_encoder(jp, jnp.asarray(enc), spec)
    want, _ = ref_layers.attention(jp, jnp.asarray(x), spec, jnp.arange(s),
                                   cross_kv=ck)
    tspec = dataclasses.replace(_port_cfg(WHISPER, "xla").attn_spec,
                                attn_chunk=chunk)
    tp = convert.tree_from_numpy(p, "cpu")
    tck = layers.cross_kv_from_encoder(tp, torch.from_numpy(enc), tspec)
    for impl in ("xla", "pallas"):
        got, cache = layers.attention(tp, torch.from_numpy(x), tspec,
                                      torch.arange(s), attn_impl=impl,
                                      cross_kv=tck)
        assert cache is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl,ref_impl", IMPLS)
def test_encode_matches_reference(impl, ref_impl):
    """whisper's encoder (non-causal: the kernel knob leaves it plain)."""
    want = ref_stack._encode(jax.tree.map(jnp.asarray,
                                          _numpy_params(WHISPER)),
                             _ref_cfg(WHISPER, ref_impl),
                             _ref_batch(WHISPER)["frames"], None, ("data",))
    cfg, params = _port(WHISPER, impl)
    with torch.inference_mode():
        got = stack._encode(params, cfg, _port_batch(WHISPER)["frames"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the reduced models -------------------------------------------------------


@pytest.mark.parametrize("impl,ref_impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, impl, ref_impl):
    """The forward's hidden state, the prefill's logits and every leaf of
    its cache (whisper's cross k/v included), and one decode step's
    logits."""
    want = _reference(arch, ref_impl)
    cfg, params = _port(arch, impl)
    toks = torch.from_numpy(_batch_np(arch)["tokens"])
    with torch.inference_mode():
        h, _ = stack.forward(params, cfg, _port_batch(arch))
        prefill = stack.build_prefill_fn(cfg, max_len=S + NEW)
        cache, plogits = prefill(params, _port_batch(arch))
        got_cache = _port_leaves(cache)
        _, _, dlogits = stack.build_decode_fn(cfg)(
            params, cache, toks[:, S:S + 1], S)
    np.testing.assert_allclose(h.numpy(), want["h"], **TOL)
    np.testing.assert_allclose(plogits.numpy(), want["prefill"], **TOL)
    assert set(got_cache) == set(want["cache"])
    assert any("xk" in k for k in got_cache) == (arch == WHISPER)
    for k, w in want["cache"].items():
        np.testing.assert_allclose(got_cache[k], w, err_msg=k, **TOL)
    np.testing.assert_allclose(dlogits.numpy(), want["decode"], **TOL)


@pytest.mark.parametrize("impl,ref_impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_stream_equals_reference(arch, impl, ref_impl):
    cfg, params = _port(arch, impl)
    batch = _port_batch(arch)
    prompt = batch.pop("tokens")
    tokens, logits, _, _ = generate(cfg, params, prompt, NEW, extra=batch)
    assert logits.shape == (B, NEW, cfg.padded_vocab)
    np.testing.assert_array_equal(tokens.numpy(),
                                  _reference(arch, ref_impl)["stream"])


@pytest.mark.parametrize("impl,ref_impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, impl, ref_impl):
    cfg, params = _port(arch, impl)
    with torch.inference_mode():
        got = stack.build_loss_fn(cfg)(params, _port_batch(arch, S + 1))
    np.testing.assert_allclose(got.item(), _reference(arch, ref_impl)["loss"],
                               **TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, impl):
    """tests/test_smoke_archs.py's check on the port: prefill of s tokens
    matches the teacher-forced forward at s-1 and decoding token s matches
    it at s (2e-4)."""
    cfg, params = _port(arch, impl)
    s = S
    with torch.inference_mode():
        h, _ = stack.forward(params, cfg, _port_batch(arch, s + 1))
        full = stack.unembed(params, cfg, h)
        cache, plogits = stack.build_prefill_fn(cfg, s + 1)(
            params, _port_batch(arch, s))
        tok = _port_batch(arch, s + 1)["tokens"][:, s:s + 1]
        _, _, dlogits = stack.build_decode_fn(cfg)(params, cache, tok, s)
    torch.testing.assert_close(plogits, full[:, s - 1], atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(dlogits, full[:, s], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_cpu_returns_tokens(arch, impl):
    out = serve(ServeRun(arch=arch, device="cpu", attn_impl=impl, batch=2,
                         prompt_len=8, max_new_tokens=4), log=lambda _: None)
    cfg = configs.get(arch, reduced=True)
    assert out["tokens"].shape == (2, 4)
    assert out["logits"].shape == (2, 4, cfg.padded_vocab)
    assert torch.isfinite(out["logits"]).all()
    assert set(out["extra"]) == {STUB[cfg.family]}


def test_serve_rejects_a_prompt_shorter_than_the_patches():
    """The reference's splice puts the patches over the prompt's first
    n_patches positions, so a shorter prompt cannot hold them."""
    with pytest.raises(ValueError, match="must hold the 4 image patches"):
        serve(ServeRun(arch="phi-3-vision-4.2b", device="cpu", prompt_len=3),
              log=lambda _: None)
