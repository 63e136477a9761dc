"""Port flash attention (CPU: its plain version) against the reference's
Pallas kernel in interpret mode and its oracle, on the reference's
FLASH_CASES with inputs made by numpy from a seed."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as ref_ops  # noqa: E402
from repro.kernels.flash_attention import ref as ref_oracle  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from test_kernels import FLASH_CASES, _tol  # noqa: E402

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(b, sq, sk, hq, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, hd), np.float32),
            rng.standard_normal((b, sk, hkv, hd), np.float32),
            rng.standard_normal((b, sk, hkv, hd), np.float32))


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,dtype,bq,bk", FLASH_CASES)
def test_flash_attention_matches_reference(b, sq, sk, hq, hkv, hd, dtype, bq,
                                           bk):
    arrays = _inputs(b, sq, sk, hq, hkv, hd)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrays)
    before = ops.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert ops.flash_attention.launches == before   # CPU: no kernel
    assert got.shape == (b, sq, hq, hd) and got.dtype == tq.dtype
    got = got.float().numpy()
    kernel = ref_ops.flash_attention(jq, jk, jv, causal=True, block_q=bq,
                                     block_k=bk, interpret=True)
    oracle = ref_oracle.attention_ref(jq, jk, jv, causal=True)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol(dtype))


def test_flash_attention_non_causal_matches_reference():
    """Non-causal calls take the plain version, as the reference wrapper
    sends them to its oracle."""
    arrays = _inputs(2, 96, 96, 4, 2, 32, seed=5)
    jq, jk, jv = (jnp.asarray(a) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a) for a in arrays)
    got = ops.flash_attention(tq, tk, tv, causal=False, scale=0.2)
    want = ref_ops.flash_attention(jq, jk, jv, causal=False, scale=0.2,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(jnp.float32))


def test_flash_attention_rejects_other_devices():
    q = torch.empty((1, 16, 4, 32), device="meta")
    k = torch.empty((1, 16, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(q, k, k)
