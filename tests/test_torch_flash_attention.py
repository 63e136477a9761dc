"""Port flash attention (CPU: its plain version) against the reference's
Pallas kernel in interpret mode and its oracle, on the reference's
FLASH_CASES and on MHA cases at phi-3-vision's head dim 96 (and whisper's
64), with inputs made by numpy from a seed."""
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
# MHA at hd = 96 (phi-3-vision) and 64 (whisper, 5 heads): a whole tile,
# rows ragged against it, fewer rows than one 16-row mma tile, and bf16
HD96_CASES = [
    (1, 128, 128, 4, 4, 96, jnp.float32, 64, 64),
    (2, 100, 100, 2, 2, 96, jnp.float32, 64, 64),
    (1, 7, 7, 4, 4, 96, jnp.float32, 16, 16),
    (1, 96, 96, 5, 5, 64, jnp.float32, 64, 64),
    (1, 128, 128, 4, 4, 96, jnp.bfloat16, 64, 64),
]


def _inputs(b, sq, sk, hq, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, hd), np.float32),
            rng.standard_normal((b, sk, hkv, hd), np.float32),
            rng.standard_normal((b, sk, hkv, hd), np.float32))


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,dtype,bq,bk",
                         FLASH_CASES + HD96_CASES)
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


@pytest.mark.parametrize("shape_q,shape_kv,dtype,match", [
    ((1, 16, 4, 80), (1, 16, 4, 80), torch.float32, "head_dim 80"),
    ((1, 16, 4, 48), (1, 16, 2, 48), torch.bfloat16, "head_dim 48"),
    ((1, 16, 6, 32), (1, 16, 4, 32), torch.float32, "not a multiple"),
    ((2, 16, 4, 32), (1, 16, 2, 32), torch.float32, "do not match q"),
])
def test_flash_kernel_input_checks(shape_q, shape_kv, dtype, match):
    """What a CUDA launch would refuse is refused before it: a head dim
    that no kernel instance has, a grouping that does not divide, shapes
    that do not match.  The checks do not depend on the device."""
    q = torch.zeros(shape_q, dtype=dtype)
    k = torch.zeros(shape_kv, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        ops._check_cuda_inputs(q, k, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,hd", [(32, 32, 96), (20, 20, 64),
                                       (24, 8, 128)])
def test_flash_kernel_input_checks_accept_the_model_shapes(hq, hkv, hd,
                                                           dtype):
    """phi-3-vision's (MHA, hd 96), whisper's (MHA, hd 64) and llama's
    forward shapes pass, in the model's [B, S, H, hd] layout."""
    q = torch.zeros(4, 64, hq, hd, dtype=dtype)
    k = torch.zeros(4, 64, hkv, hd, dtype=dtype)
    ops._check_cuda_inputs(q, k, k)


# The CUDA kernel's arithmetic, emulated in plain torch.  fp32 runs on the
# TF32 tensor cores (mma.sync), with each fp32 operand split as hi = x
# rounded to tf32 and lo = x - hi (which the tensor cores read truncated to
# tf32), and each product taken as lo*hi' + hi*lo' + hi*hi' in fp32
# (3xTF32).  bf16 runs on the bf16 tensor cores (wgmma): Q.K^T in one pass
# (bf16 products are exact in fp32), P.V with P split into bf16 hi =
# bf16(P) and lo = bf16(P - hi), two passes into one fp32 accumulator.  The
# "tf32" bf16 mode is the TF32 route bf16 took before (Q.K^T one pass, P.V
# two with P's tf32 split), kept as the yardstick of the new one.  These
# tests guard the design's numerics, not the CUDA code: they run no port
# code and would not see a change to the kernel's own arithmetic.  The
# kernel itself is held against its plain version on the card
# (chip_smoke.py, phase 2).


def _tf32(x):
    """Round fp32 to tf32 (10 mantissa bits), to nearest with ties away
    from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _truncate_tf32(x):
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _truncate_tf32(x - hi)


def _bf16(x):
    """Round fp32 to bf16 (to nearest even), back in fp32."""
    return x.to(torch.bfloat16).float()


def _product(a, b, passes):
    """a @ b in fp32 accumulation.  TF32 operands: 3 = both split, 2 = a
    split and b exact in tf32, 1 = a single tf32 pass.  bf16 operands (b
    exact in bf16): "bf16" = a rounded to bf16, one pass; "bf16x2" = a as
    bf16 hi + lo, two passes."""
    if passes == "bf16":
        return _bf16(a) @ _bf16(b)
    if passes == "bf16x2":
        hi = _bf16(a)
        return _bf16(a - hi) @ _bf16(b) + hi @ _bf16(b)
    a_hi, a_lo = _split(a)
    if passes == 1:
        return a_hi @ _tf32(b)
    if passes == 2:
        return a_lo @ b + a_hi @ b
    b_hi, b_lo = _split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _emulated_kernel(q, k, v, qk_passes, pv_passes):
    """q: [B,Sq,Hq,hd]; k,v: [B,Sk,Hkv,hd], fp32 -> [B,Sq,Hq,hd] fp32; the
    kernel's causal online softmax in base 2, over the whole row at once."""
    sq, hq, hd = q.shape[1:]
    sk, hkv = k.shape[1], k.shape[2]
    kr = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    vr = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    s = _product(q.transpose(1, 2), kr.transpose(-1, -2), qk_passes)
    s = s * (hd ** -0.5 * 1.4426950408889634)
    mask = torch.arange(sk)[None, :] > torch.arange(sq)[:, None]
    s = s.masked_fill(mask, float("-inf"))
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    out = _product(p, vr, pv_passes) / p.sum(-1, keepdim=True)
    return out.transpose(1, 2)


FP32_CASES = [c for c in FLASH_CASES + HD96_CASES if c[6] == jnp.float32]
BF16_CASES = [c for c in FLASH_CASES + HD96_CASES if c[6] == jnp.bfloat16]


def _oracle(arrays, dtype):
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrays)
    return np.asarray(ref_oracle.attention_ref(jq, jk, jv, causal=True),
                      np.float32)


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,dtype,bq,bk", FP32_CASES)
def test_flash_3xtf32_meets_fp32_tolerance(b, sq, sk, hq, hkv, hd, dtype, bq,
                                           bk):
    """The kernel's fp32 arithmetic (3xTF32 on both products) meets the
    reference's 2e-5 fp32 tolerance against its oracle."""
    arrays = _inputs(b, sq, sk, hq, hkv, hd)
    got = _emulated_kernel(*(torch.from_numpy(a) for a in arrays), 3, 3)
    np.testing.assert_allclose(got.numpy(), _oracle(arrays, dtype),
                               **_tol(dtype))


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,dtype,bq,bk", FP32_CASES)
def test_flash_single_tf32_pass_misses_fp32_tolerance(b, sq, sk, hq, hkv, hd,
                                                      dtype, bq, bk):
    """Why the kernel splits: one TF32 pass on each product is ~1e-3 off,
    far outside the 2e-5 fp32 tolerance."""
    arrays = _inputs(b, sq, sk, hq, hkv, hd)
    got = _emulated_kernel(*(torch.from_numpy(a) for a in arrays), 1, 1)
    want = _oracle(arrays, dtype)
    assert not np.allclose(got.numpy(), want, **_tol(dtype))
    assert np.abs(got.numpy() - want).max() > 1e-4


# (Q.K^T, P.V) passes of each bf16 mode: the wgmma route's, and the TF32
# route's before it
BF16_MODES = {"wgmma": ("bf16", "bf16x2"), "tf32": (1, 2)}


@pytest.mark.parametrize("mode", sorted(BF16_MODES))
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,dtype,bq,bk", BF16_CASES)
def test_flash_bf16_passes_keep_fp32_accuracy(b, sq, sk, hq, hkv, hd, dtype,
                                              bq, bk, mode):
    """The kernel's bf16 path ("wgmma": Q.K^T one bf16 pass, P.V two with
    P as bf16 hi + lo; "tf32": the TF32 route it replaced).  Before the
    output's bf16 rounding it is within the fp32 tolerance of the oracle on
    the same bf16-rounded inputs, and after it within the bf16 tolerance."""
    arrays = _inputs(b, sq, sk, hq, hkv, hd)
    rounded = [torch.from_numpy(a).to(torch.bfloat16).float() for a in arrays]
    got = _emulated_kernel(*rounded, *BF16_MODES[mode])
    want32 = _oracle([r.numpy() for r in rounded], jnp.float32)
    np.testing.assert_allclose(got.numpy(), want32, **_tol(jnp.float32))
    np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(),
                               _oracle(arrays, dtype), **_tol(dtype))


@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,dtype,bq,bk", BF16_CASES)
def test_flash_bf16_one_pass_p_misses_fp32_tolerance(b, sq, sk, hq, hkv, hd,
                                                     dtype, bq, bk):
    """Why P.V takes P in two bf16 passes: one bf16 rounding of P is
    ~1e-3 off the oracle (PERF.md), far outside the fp32 tolerance that
    the two passes meet, though within bf16's once the output is rounded."""
    arrays = _inputs(b, sq, sk, hq, hkv, hd)
    rounded = [torch.from_numpy(a).to(torch.bfloat16).float() for a in arrays]
    want32 = _oracle([r.numpy() for r in rounded], jnp.float32)
    one = _emulated_kernel(*rounded, "bf16", "bf16").numpy()
    two = _emulated_kernel(*rounded, "bf16", "bf16x2").numpy()
    assert not np.allclose(one, want32, **_tol(jnp.float32))
    assert np.abs(one - want32).max() > 1e-4
    assert np.abs(one - want32).max() > 10 * np.abs(two - want32).max()
    np.testing.assert_allclose(_bf16(torch.from_numpy(one)).numpy(),
                               _oracle(arrays, dtype), **_tol(dtype))
