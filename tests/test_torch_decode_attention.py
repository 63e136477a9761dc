"""Port decode attention (CPU: its plain version) against the reference's
Pallas kernel in interpret mode and its oracle, on the reference's
DECODE_CASES and on MHA (g = 1) cases at whisper's head dim 64 and
phi-3-vision's 96, with inputs made by numpy from a seed."""
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
# MHA (hq == hkv, g = 1) at hd = 64 (whisper) and hd = 96 (phi-3-vision),
# lengths that fill the cache, leave it ragged against the block, and 1
MHA_CASES = [
    (2, 160, 5, 5, 64, 150, jnp.float32, 128),
    (2, 256, 4, 4, 96, 200, jnp.float32, 128),
    (1, 192, 6, 6, 96, 192, jnp.float32, 128),
    (2, 256, 4, 4, 96, 1, jnp.float32, 128),
    (2, 256, 4, 4, 96, 131, jnp.bfloat16, 128),
    (2, 160, 5, 5, 64, 7, jnp.bfloat16, 128),
]


def _inputs(b, s, hq, hkv, hd, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, hd), np.float32),
            rng.standard_normal((b, s, hkv, hd), np.float32),
            rng.standard_normal((b, s, hkv, hd), np.float32))


@pytest.mark.parametrize("b,s,hq,hkv,hd,length,dtype,bk",
                         DECODE_CASES + MHA_CASES)
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


@pytest.mark.parametrize("b,hkv", [(4, 8), (1, 8), (1, 1), (2, 2), (16, 8)])
def test_split_rows_cover_each_row_once(b, hkv):
    """At every length from 1 to the cache size, the rows the cluster's CTAs
    stream cover [0, length) exactly once, in order; a CTA may get none."""
    splits = ops.split_count(b, hkv, 132)
    for length in range(1, 1057):
        ranges = ops.split_rows(length, splits)
        assert len(ranges) == splits
        rows = [r for start, end in ranges for r in range(start, end)]
        assert rows == list(range(length))
        assert all(0 <= start <= end <= length for start, end in ranges)


@pytest.mark.parametrize("b,hkv,sms,want", [
    (4, 8, 132, 8),      # llama3.2-3b serving: 32 clusters of 8 CTAs
    (1, 8, 132, 8),      # capped at the portable cluster size
    (16, 8, 132, 3),     # 128 pairs: about 2 CTAs on each SM
    (33, 4, 132, 1),     # B*Hkv alone fills the card
    (64, 8, 132, 1),
    (4, 8, 16, 1),       # a smaller card
])
def test_split_count_depends_on_pairs_and_sms_only(b, hkv, sms, want):
    splits = ops.split_count(b, hkv, sms)
    assert splits == want
    assert 1 <= splits <= ops.MAX_SPLITS


@pytest.mark.parametrize("shape_q,shape_kv,length,match", [
    ((1, 4, 48), (1, 8, 2, 48), 8, "head_dim 48"),
    ((1, 4, 80), (1, 8, 4, 80), 8, "head_dim 80"),
    ((1, 18, 32), (1, 8, 2, 32), 8, "at most 8 per kv head"),
    ((1, 24, 32), (1, 8, 2, 32), 8, r"or 16 \(two CTAs of 8\)"),
    ((1, 64, 32), (1, 8, 2, 32), 8, r"or 16 \(two CTAs of 8\)"),
    ((1, 6, 32), (1, 8, 4, 32), 8, "multiple of kv heads"),
    ((1, 4, 32), (1, 8, 2, 32), 0, r"length 0 outside \[1, 8\]"),
    ((1, 4, 32), (1, 8, 2, 32), 9, r"length 9 outside \[1, 8\]"),
    ((2, 4, 32), (1, 8, 2, 32), 8, "do not match q"),
])
def test_decode_kernel_input_checks(shape_q, shape_kv, length, match):
    """What a CUDA launch would refuse is refused before it; the checks do
    not depend on the device, so they run here on CPU tensors."""
    q = torch.zeros(shape_q)
    k = torch.zeros(shape_kv)
    with pytest.raises(ValueError, match=match):
        ops._check_cuda_inputs(q, k, k, length)


def test_decode_kernel_input_checks_accept_the_cache_in_place():
    """The model's [B, S, Hkv, hd] cache, read in place, passes; a query that
    is not contiguous does not."""
    q = torch.zeros(4, 24, 128)
    k = torch.zeros(4, 1056, 8, 128)
    ops._check_cuda_inputs(q, k, k, 1040)
    # nemotron-h's 16 q heads a kv head (two CTAs of 8)
    ops._check_cuda_inputs(torch.zeros(4, 32, 128),
                           torch.zeros(4, 1056, 2, 128),
                           torch.zeros(4, 1056, 2, 128), 1040)
    # phi-3-vision's MHA cache at head dim 96, fp32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        ops._check_cuda_inputs(torch.zeros(4, 32, 96, dtype=dtype),
                               torch.zeros(4, 1056, 32, 96, dtype=dtype),
                               torch.zeros(4, 1056, 32, 96, dtype=dtype),
                               1040)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_cuda_inputs(q.transpose(1, 2).contiguous()
                               .transpose(1, 2), k, k, 1040)


@pytest.mark.parametrize("length", [1, 17, 40, 64])
def test_decode_attention_takes_a_device_length(length):
    """A one-element int32 length (a decode step's position on the device)
    gives what the int gives; on the CPU the plain version reads it."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 64, 8, 2, 32, seed=5))
    got = ops.decode_attention(q, k, v, torch.tensor([length],
                                                     dtype=torch.int32),
                               scale=0.25)
    assert torch.equal(got, ops.decode_attention(q, k, v, length,
                                                 scale=0.25))


@pytest.mark.parametrize("length,match", [
    (torch.tensor([8], dtype=torch.int64), "one int32"),
    (torch.tensor([8, 8], dtype=torch.int32), "one int32"),
])
def test_decode_kernel_input_checks_on_a_device_length(length, match):
    """A device length is one int32 on q's device; its range is the
    kernel's to clamp, so a value past the cache passes the host check."""
    q = torch.zeros(1, 4, 32)
    k = torch.zeros(1, 8, 2, 32)
    ops._check_cuda_inputs(q, k, k, torch.tensor([9], dtype=torch.int32))
    with pytest.raises(ValueError, match=match):
        ops._check_cuda_inputs(q, k, k, length)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,hq,hd", [(2, 2, 16, 128), (16, 4, 32, 128),
                                         (1, 8, 8, 96)])
def test_card_device_length_matches_int_length(b, hkv, hq, hd, dtype):
    """On the card the kernel reading its length through a pointer gives
    the int form's output bit for bit at every length from 1 to S (each
    split boundary among them), and clamps a device length to [1, S]."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    s = 72
    gen = torch.Generator(device=dev).manual_seed(b * hq)
    q = torch.randn((b, hq, hd), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((b, s, hkv, hd), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    # 1..S holds every length at which a CTA's share of rows changes
    assert 1 < ops.split_count(b, hkv, ops._sm_count(0)) <= s // 8
    box = torch.zeros(1, dtype=torch.int32, device=dev)
    for length in range(1, s + 1):
        box.fill_(length)
        got = ops.decode_attention(q, k, v, box, scale=hd ** -0.5)
        want = ops.decode_attention(q, k, v, length, scale=hd ** -0.5)
        assert torch.equal(got, want), length
        plain = ops.decode_attention_plain(q, k, v, length, scale=hd ** -0.5)
        torch.testing.assert_close(got.float(), plain.float(),
                                   **({"atol": 2e-5, "rtol": 2e-5}
                                      if dtype == torch.float32
                                      else {"atol": 2e-2, "rtol": 2e-2}))
    for outside, inside in ((0, 1), (-3, 1), (s + 5, s)):
        box.fill_(outside)
        assert torch.equal(ops.decode_attention(q, k, v, box, scale=0.1),
                           ops.decode_attention(q, k, v, inside, scale=0.1))
