"""Port SSD scan (CPU: its plain version) against the reference's oracle and
its Pallas kernel in interpret mode, on the reference's SSD_CASES with
inputs made by numpy from a seed (the reference's input recipe)."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ops as ref_ops  # noqa: E402
from repro.kernels.ssd_scan import ref as ref_oracle  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import _cumsum  # noqa: E402
from test_kernels import SSD_CASES, _tol  # noqa: E402

TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _state_tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == jnp.bfloat16 \
        else dict(atol=1e-4, rtol=1e-4)


def _inputs(b, l, h, p, g, n, seed=2):
    """x, dt (post-softplus), a (negative), B, C as in test_kernels."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((b, l, h)) - 1.0)
    a = -np.exp(rng.standard_normal(h) * 0.3)
    bb = rng.standard_normal((b, l, g, n), np.float32)
    cc = rng.standard_normal((b, l, g, n), np.float32)
    return x, dt.astype(np.float32), a.astype(np.float32), bb, cc


def _model_inputs(b, l, h, p, g, n, seed=6):
    """x, dt, a, B, C over the ranges of the model's own init (api.py:
    `a_log`, `dt_bias`): a from -1 to -16 and dt from 1e-3 to 1e-1 over the
    heads, so the slowest heads carry their state across whole chunks."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), np.float32)
    dt_bias = np.log(np.expm1(np.geomspace(1e-3, 1e-1, h)))
    dt = np.logaddexp(0.0, 0.1 * rng.standard_normal((b, l, h)) + dt_bias)
    a = -np.linspace(1.0, 16.0, h)
    bb = rng.standard_normal((b, l, g, n), np.float32)
    cc = rng.standard_normal((b, l, g, n), np.float32)
    return x, dt.astype(np.float32), a.astype(np.float32), bb, cc


def _both(arrays, dtype):
    """The same arrays for the reference (jnp) and the port (torch); x, B
    and C in `dtype`, dt and a in fp32."""
    x, dt, a, bb, cc = arrays
    jx, jb, jc = (jnp.asarray(v).astype(dtype) for v in (x, bb, cc))
    tx, tb, tc = (torch.from_numpy(v).to(TORCH_DTYPE[dtype])
                  for v in (x, bb, cc))
    return ((jx, jnp.asarray(dt), jnp.asarray(a), jb, jc),
            (tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("b,l,h,p,g,n,chunk,dtype", SSD_CASES)
def test_ssd_matches_reference(b, l, h, p, g, n, chunk, dtype, impl):
    ref_in, port_in = _both(_inputs(b, l, h, p, g, n), dtype)
    before = ops.ssd.launches
    y, s = ops.ssd(*port_in, chunk=chunk, impl=impl)
    assert ops.ssd.launches == before     # CPU: no kernel
    assert y.shape == (b, l, h, p) and y.dtype == torch.float32
    assert s.shape == (b, h, p, n) and s.dtype == torch.float32
    oracle = ref_oracle.ssd_ref(*ref_in, chunk=chunk)
    kernel = ref_ops.ssd(*ref_in, chunk=chunk, impl="pallas_interpret")
    for y_want, s_want in (oracle, kernel):
        np.testing.assert_allclose(y.numpy(), np.asarray(y_want),
                                   **_tol(dtype))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_want),
                                   **_state_tol(dtype))


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [
    (1, 512, 4, 64, 1, 128, 128),    # the full config's P, N and chunk
    (2, 256, 8, 32, 2, 64, 64),
    (1, 300, 4, 16, 1, 16, 32),      # ragged
])
def test_ssd_model_ranges_match_reference(b, l, h, p, g, n, chunk):
    """At the decay and step ranges of the model's init, where the state is
    carried across chunks, y and the state match the reference's oracle
    and its kernel at the fp32 tolerances."""
    ref_in, port_in = _both(_model_inputs(b, l, h, p, g, n), jnp.float32)
    y, s = ops.ssd(*port_in, chunk=chunk, impl="pallas")
    for impl in ("xla", "pallas_interpret"):
        y_want, s_want = ref_ops.ssd(*ref_in, chunk=chunk, impl=impl)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_want),
                                   **_tol(jnp.float32))
        np.testing.assert_allclose(s.numpy(), np.asarray(s_want),
                                   **_state_tol(jnp.float32))


@pytest.mark.parametrize("n", [1, 7, 16, 33, 128, 300])
def test_cumsum_sums_in_the_reference_order(n):
    """`cum` is summed exactly as jnp.cumsum sums it (bit for bit): y is
    ill-conditioned in cum, so another order moves y past the tolerance."""
    x = np.random.default_rng(n).standard_normal((2, n, 3), np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=1))
    np.testing.assert_array_equal(_cumsum(torch.from_numpy(x), 1).numpy(),
                                  want)


def test_ssd_initial_state_continuation():
    """Splitting a sequence in half and carrying the state equals the
    full-sequence scan, and the second half's output equals the reference
    kernel's seeded with the reference's first-half state."""
    b, l, h, p, g, n, chunk = 1, 256, 2, 32, 1, 32, 64
    (jx, jdt, ja, jb, jc), (tx, tdt, ta, tb, tc) = _both(
        _inputs(b, l, h, p, g, n, seed=3), jnp.float32)
    half = l // 2
    y_full, s_full = ops.ssd(tx, tdt, ta, tb, tc, chunk=chunk, impl="pallas")
    _, s1 = ops.ssd(tx[:, :half], tdt[:, :half], ta, tb[:, :half],
                    tc[:, :half], chunk=chunk, impl="pallas")
    y2, s2 = ops.ssd(tx[:, half:], tdt[:, half:], ta, tb[:, half:],
                     tc[:, half:], chunk=chunk, impl="pallas",
                     initial_state=s1)
    tol = dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(y2.numpy(), y_full[:, half:].numpy(), **tol)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), **tol)
    _, js1 = ref_ops.ssd(jx[:, :half], jdt[:, :half], ja, jb[:, :half],
                         jc[:, :half], chunk=chunk, impl="pallas_interpret")
    jy2, js2 = ref_ops.ssd(jx[:, half:], jdt[:, half:], ja, jb[:, half:],
                           jc[:, half:], chunk=chunk,
                           impl="pallas_interpret", initial_state=js1)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), **tol)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **tol)


@pytest.mark.parametrize("l,chunk", [(100, 32), (20, 16), (7, 16)])
def test_ssd_ragged_length_matches_reference(l, chunk):
    """L not a multiple of the chunk: the reference wrapper pads with
    dt = 0 (an identity step); y and the final state must match it, with
    and without an initial state."""
    b, h, p, g, n = 2, 4, 32, 2, 16
    ref_in, port_in = _both(_inputs(b, l, h, p, g, n, seed=4), jnp.float32)
    s0 = np.random.default_rng(5).standard_normal((b, h, p, n),
                                                  np.float32)
    for init in (None, s0):
        y, s = ops.ssd(*port_in, chunk=chunk, impl="pallas",
                       initial_state=None if init is None
                       else torch.from_numpy(init))
        for impl in ("xla", "pallas_interpret"):
            y_want, s_want = ref_ops.ssd(
                *ref_in, chunk=chunk, impl=impl,
                initial_state=None if init is None else jnp.asarray(init))
            np.testing.assert_allclose(y.numpy(), np.asarray(y_want),
                                       **_tol(jnp.float32))
            np.testing.assert_allclose(s.numpy(), np.asarray(s_want),
                                       **_state_tol(jnp.float32))


def test_ssd_rejects_other_devices_and_impls():
    """Only CPU tensors take the plain version under "pallas"; a device
    that is neither CPU nor CUDA raises, and so does an unknown impl."""
    x = torch.empty((1, 16, 2, 16), device="meta")
    dt = torch.empty((1, 16, 2), device="meta")
    a = torch.empty((2,), device="meta")
    bc = torch.empty((1, 16, 1, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd(x, dt, a, bc, bc, chunk=16, impl="pallas")
    cpu = [torch.zeros(t.shape) for t in (x, dt, a, bc, bc)]
    with pytest.raises(ValueError, match="unknown ssd impl"):
        ops.ssd(*cpu, chunk=16, impl="pallas_interpret")


@pytest.mark.parametrize("shape,chunk,match", [
    ((1, 64, 4, 48, 1, 16), 16, "P 48"),         # P outside the kernel's
    ((1, 64, 4, 32, 1, 96), 16, "N 96"),         # N outside
    ((1, 64, 4, 32, 1, 16), 256, "chunk 256"),   # chunk outside
    ((1, 64, 4, 32, 3, 16), 16, "multiple of groups"),
])
def test_ssd_kernel_input_checks(shape, chunk, match):
    """What a CUDA launch would refuse is refused before it; the checks do
    not depend on the device, so they run here on CPU tensors."""
    b, l, h, p, g, n = shape
    x, dt, a, bb, cc = (torch.from_numpy(v) for v in
                        _inputs(b, l, h, p, g, n))
    with pytest.raises(ValueError, match=match):
        ops._check_cuda_inputs(x, dt, a, bb, cc, chunk, None)


def test_ssd_kernel_input_checks_accept_the_model_layout():
    """B and C as the mixer passes them, views into one [B, L, 2GN]
    projection (row stride 2GN, C at an offset of GN), pass the checks."""
    b, l, h, p, g, n = 2, 40, 4, 32, 1, 64
    x, dt, a, _, _ = (torch.from_numpy(v) for v in _inputs(b, l, h, p, g, n))
    bc = torch.randn(b, l, 2 * g * n)
    bb = bc[..., :g * n].reshape(b, l, g, n)
    cc = bc[..., g * n:].reshape(b, l, g, n)
    ops._check_cuda_inputs(x, dt, a, bb, cc, 16, torch.zeros(b, h, p, n))
    with pytest.raises(ValueError, match="initial_state"):
        ops._check_cuda_inputs(x, dt, a, bb, cc, 16, torch.zeros(b, h, n, p))


@pytest.mark.parametrize("b,l,h,p,g,n,chunk", [
    (4, 1024, 48, 64, 1, 128, 128),   # the full-width mamba2-780m prefill
    (4, 1000, 48, 64, 1, 128, 128),   # ragged: the last chunk is partial
    (2, 20, 8, 16, 2, 16, 16),
])
def test_ssd_scratch_shapes(b, l, h, p, g, n, chunk):
    """One kernel call's scratch: C.B^T per (batch, chunk, group), a state
    per (batch, head, chunk) and a decay per (batch, head, chunk), with
    nc = ceil(L / chunk)."""
    nc = -(-l // chunk)
    shapes = ops.scratch_shapes(b, l, h, g, p, n, chunk)
    assert shapes == {"cb": (b, nc, g, chunk, chunk),
                      "states": (b, h, nc, p, n), "decay": (b, h, nc)}
    if (b, l, h, p, g, n, chunk) == (4, 1024, 48, 64, 1, 128, 128):
        assert 4 * np.prod(shapes["cb"]) == 2 * 2 ** 20           # 2 MiB
        assert 4 * np.prod(shapes["states"]) == 48 * 2 ** 20      # 48 MiB


def test_ssd_kernel_input_checks_refuse_a_grid_too_long():
    """More chunks than a grid row holds (65535 at chunk 16) is refused."""
    l, h, p, g, n = 16 * 65536, 1, 16, 1, 16
    x = torch.zeros(1, 1, h, p).expand(1, l, h, p)
    dt = torch.zeros(1, 1, h).expand(1, l, h)
    bc = torch.zeros(1, 1, g, n).expand(1, l, g, n)
    with pytest.raises(ValueError, match="too long for the kernel's grid"):
        ops._check_cuda_inputs(x, dt, torch.zeros(h), bc, bc, 16, None)


def _four_phases(x, dt, a, b, c, chunk, initial_state=None):
    """The kernel's decomposition in plain torch, through scratch of the
    shapes `scratch_shapes` gives: C.B^T per (batch, chunk, group), each
    chunk's own state and decay, the state passing that overwrites each
    chunk's state with the one entering it, and the chunk scan."""
    bsz, seqlen, h, p = x.shape
    g, n = b.shape[2:]
    shapes = ops.scratch_shapes(bsz, seqlen, h, g, p, n, chunk)
    nc, rep = shapes["decay"][2], h // g
    pad = nc * chunk - seqlen
    x, b, c = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
               for t in (x, b, c))
    dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    xf = x.reshape(bsz, nc, chunk, h, p)
    dtf = dt.reshape(bsz, nc, chunk, h)
    bf = b.reshape(bsz, nc, chunk, g, n)
    cf = c.reshape(bsz, nc, chunk, g, n)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cf, bf) * tril
    assert cb.shape == shapes["cb"]
    cum = _cumsum(dtf * a, 2)                                  # [B,nc,Q,H]
    w = torch.exp(cum[:, :, -1:] - cum) * dtf
    states = torch.einsum("bckhp,bckhn->bhcpn", xf * w[..., None],
                          bf.repeat_interleave(rep, dim=3))
    decay = torch.exp(cum[:, :, -1]).permute(0, 2, 1)
    assert states.shape == shapes["states"] and decay.shape == shapes["decay"]
    s = torch.zeros(bsz, h, p, n) if initial_state is None else initial_state
    for ci in range(nc):
        s, states[:, :, ci] = (s * decay[:, :, ci, None, None]
                               + states[:, :, ci], s)
    diff = cum[:, :, :, None] - cum[:, :, None]                # [B,nc,Q,K,H]
    lmat = torch.exp(diff.masked_fill(~tril[None, None, :, :, None],
                                      float("-inf")))
    scores = cb.repeat_interleave(rep, dim=2).permute(0, 1, 3, 4, 2) \
        * lmat * dtf[:, :, None]
    y = torch.exp(cum)[..., None] * torch.einsum(
        "bcqhn,bhcpn->bcqhp", cf.repeat_interleave(rep, dim=3), states) \
        + torch.einsum("bcqkh,bckhp->bcqhp", scores, xf)
    return y.reshape(bsz, nc * chunk, h, p)[:, :seqlen], s


@pytest.mark.parametrize("b,l,h,p,g,n,chunk,init", [
    (1, 512, 4, 64, 1, 128, 128, False),
    (2, 256, 8, 32, 2, 64, 64, True),
    (2, 100, 4, 32, 2, 16, 32, True),    # ragged
])
def test_ssd_four_phase_decomposition_matches_reference(b, l, h, p, g, n,
                                                        chunk, init):
    """The four phases the kernel runs, through its scratch layout, give the
    reference's y and final state at the fp32 tolerances, at the model's
    decay and step ranges."""
    ref_in, port_in = _both(_model_inputs(b, l, h, p, g, n), jnp.float32)
    s0 = np.random.default_rng(7).standard_normal((b, h, p, n), np.float32) \
        if init else None
    y, s = _four_phases(*port_in, chunk,
                        None if s0 is None else torch.from_numpy(s0))
    y_want, s_want = ref_ops.ssd(
        *ref_in, chunk=chunk, impl="xla",
        initial_state=None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want),
                               **_tol(jnp.float32))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want),
                               **_state_tol(jnp.float32))
