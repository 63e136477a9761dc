"""Port decode attention (CPU: its plain version) against the reference's
Pallas kernel in interpret mode and its oracle, on the reference's
DECODE_CASES with inputs made by numpy from a seed."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as ref_ops  # noqa: E402
from repro.kernels.flash_attention import ref as ref_oracle  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from test_kernels import DECODE_CASES, _tol  # noqa: E402

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _inputs(b, s, hq, hkv, hd, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, hd), np.float32),
            rng.standard_normal((b, s, hkv, hd), np.float32),
            rng.standard_normal((b, s, hkv, hd), np.float32))


@pytest.mark.parametrize("b,s,hq,hkv,hd,length,dtype,bk", DECODE_CASES)
def test_decode_attention_matches_reference(b, s, hq, hkv, hd, length, dtype,
                                            bk):
    arrays = _inputs(b, s, hq, hkv, hd)
    scale = hd ** -0.5
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(TORCH_DTYPE[dtype]) for a in arrays)
    before = ops.decode_attention.launches
    got = ops.decode_attention(tq, tk, tv, length, scale=scale)
    assert ops.decode_attention.launches == before   # CPU: no kernel
    assert got.shape == (b, hq, hd) and got.dtype == tq.dtype
    got = got.float().numpy()
    kernel = ref_ops.decode_attention(jq, jk, jv, length, scale=scale,
                                      block_k=bk, interpret=True)
    oracle = ref_oracle.decode_attention_ref(jq, jk, jv, length, scale=scale)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **_tol(dtype))


def test_decode_attention_casts_cache_to_q_dtype():
    """A bf16 cache under an fp32 query is read as the reference reads it:
    cast to q's dtype first."""
    q, k, v = _inputs(2, 64, 4, 2, 32, seed=3)
    jq = jnp.asarray(q)
    jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))
    tq = torch.from_numpy(q)
    tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    got = ops.decode_attention(tq, tk, tv, 40, scale=0.25)
    want = ref_ops.decode_attention(jq, jk, jv, 40, scale=0.25,
                                    interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_tol(jnp.float32))


def test_decode_attention_rejects_other_devices():
    """Only CPU tensors take the plain version; anything else that is not
    CUDA raises instead of computing somewhere else."""
    q = torch.empty((1, 4, 32), device="meta")
    k = torch.empty((1, 8, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.decode_attention(q, k, k, 8, scale=1.0)
