"""Port layers against the reference, fp32 on CPU, same numpy inputs and
params on both sides.  Attention runs each branch (cache-free, prefill,
decode) with both port impls against both reference impls."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
D, HQ, HKV, HD = 64, 4, 2, 16
THETA = 500_000.0


def _both(tree):
    """(reference tree of jnp arrays, port tree of torch tensors)."""
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: torch.from_numpy(v) for k, v in tree.items()})


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, D), np.float32) * 3
    w = 1 + 0.1 * rng.standard_normal(D, np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           ref.rms_norm(jnp.asarray(x), jnp.asarray(w)))


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, HQ, HD), np.float32)
    pos = np.arange(7, dtype=np.int32) + 3
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             THETA),
           ref.apply_rope(jnp.asarray(x), jnp.asarray(pos), THETA))


def test_swiglu_mlp_matches_reference():
    rng = np.random.default_rng(2)
    p = {k: 0.1 * rng.standard_normal(s, np.float32) for k, s in
         (("w_gate", (D, 128)), ("w_up", (D, 128)), ("w_down", (128, D)))}
    x = rng.standard_normal((2, 5, D), np.float32)
    jp, tp = _both(p)
    _close(layers.swiglu_mlp(tp, torch.from_numpy(x)),
           ref.swiglu_mlp(jp, jnp.asarray(x)))


def _attn_case(qk_norm: bool, seed: int = 3):
    rng = np.random.default_rng(seed)
    p = {"wq": (D, HQ * HD), "wk": (D, HKV * HD), "wv": (D, HKV * HD),
         "wo": (HQ * HD, D)}
    p = {k: 0.15 * rng.standard_normal(s, np.float32) for k, s in p.items()}
    if qk_norm:
        p["q_norm"] = 1 + 0.1 * rng.standard_normal(HD, np.float32)
        p["k_norm"] = 1 + 0.1 * rng.standard_normal(HD, np.float32)
    kw = dict(n_heads=HQ, n_kv_heads=HKV, head_dim=HD, rope_theta=THETA,
              qk_norm=qk_norm)
    x = rng.standard_normal((2, 9, D), np.float32)
    return p, ref.AttentionSpec(**kw), layers.AttentionSpec(**kw), x


IMPLS = [("xla", "xla"), ("xla", "pallas_interpret"), ("pallas", "xla"),
         ("pallas", "pallas_interpret")]


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("impl,ref_impl", IMPLS)
def test_attention_cache_free_matches_reference(impl, ref_impl, qk_norm):
    p, rspec, tspec, x = _attn_case(qk_norm)
    jp, tp = _both(p)
    pos = np.arange(x.shape[1], dtype=np.int32)
    got, gc = layers.attention(tp, torch.from_numpy(x), tspec,
                               torch.from_numpy(pos), attn_impl=impl)
    want, wc = ref.attention(jp, jnp.asarray(x), rspec, jnp.asarray(pos),
                             attn_impl=ref_impl)
    assert gc is None and wc is None
    _close(got, want)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("impl,ref_impl", IMPLS)
def test_attention_prefill_then_decode_matches_reference(impl, ref_impl,
                                                         qk_norm):
    """Prefill 8 tokens into a 12-slot cache, then decode token 9."""
    p, rspec, tspec, x = _attn_case(qk_norm, seed=4)
    jp, tp = _both(p)
    b, s_max, s = x.shape[0], 12, 8
    zeros = np.zeros((b, s_max, HKV, HD), np.float32)
    tcache = {"k": torch.from_numpy(zeros.copy()),
              "v": torch.from_numpy(zeros.copy())}
    jcache = {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)}
    pos = np.arange(s, dtype=np.int32)
    got, tcache = layers.attention(tp, torch.from_numpy(x[:, :s]), tspec,
                                   torch.from_numpy(pos), attn_impl=impl,
                                   kv_cache=tcache, cache_pos=0)
    want, jcache = ref.attention(jp, jnp.asarray(x[:, :s]), rspec,
                                 jnp.asarray(pos), attn_impl=ref_impl,
                                 kv_cache=jcache, cache_pos=0)
    _close(got, want)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])
    pos = np.array([s], np.int32)
    got, tcache = layers.attention(tp, torch.from_numpy(x[:, s:s + 1]),
                                   tspec, torch.from_numpy(pos),
                                   attn_impl=impl, kv_cache=tcache,
                                   cache_pos=s)
    want, jcache = ref.attention(jp, jnp.asarray(x[:, s:s + 1]), rspec,
                                 jnp.asarray(pos), attn_impl=ref_impl,
                                 kv_cache=jcache, cache_pos=jnp.int32(s))
    _close(got, want)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


def test_attention_rejects_unknown_impl():
    p, _, tspec, x = _attn_case(False)
    _, tp = _both(p)
    with pytest.raises(ValueError, match="attn_impl"):
        layers.attention(tp, torch.from_numpy(x), tspec,
                         torch.arange(x.shape[1]), attn_impl="pallas_interpret")
