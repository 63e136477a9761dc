"""Plain-torch oracle for the Mamba2 SSD chunked scan; counterpart of
`repro/kernels/ssd_scan/ref.py`.

Semantics (per batch b, head h; P = headdim, N = d_state):
    h_t = exp(dt_t * a_h) * h_{t-1} + dt_t * B_t (x) x_t     (outer product)
    y_t = C_t . h_t
with B_t, C_t shared across the heads of a group (G groups, G | H).
Chunked evaluation (chunk length Q): a within-chunk quadratic term plus the
cross-chunk state recurrence, all in float32.  The reference runs the
recurrence as an associative scan; here it is a loop over chunks, the same
first-order recurrence.

y depends on differences cum_q - cum_k of prefix sums that reach the
hundreds within a chunk, so the order in which `cum` is summed moves y by
more than the fp32 tolerance (2e-5): `_cumsum` sums in the order XLA uses
for `jnp.cumsum` on the CPU, and the CUDA kernel sums in the same order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SCAN_BLOCK = 16


def _cumsum(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumsum along `dim`, summed in XLA's order (its reduce-window
    rewrite): left to right within blocks of 16, the blocks' totals scanned
    the same way, then each block offset by the totals before it.  Plain
    elementwise adds, so every device rounds alike."""
    t = t.movedim(dim, -1)
    n = t.shape[-1]
    if n <= SCAN_BLOCK:
        parts = [t[..., 0]]
        for i in range(1, n):
            parts.append(parts[-1] + t[..., i])
        out = torch.stack(parts, dim=-1)
    else:
        nb = -(-n // SCAN_BLOCK)
        padded = F.pad(t, (0, nb * SCAN_BLOCK - n))
        rows = _cumsum(padded.reshape(*t.shape[:-1], nb, SCAN_BLOCK), -1)
        before = F.pad(_cumsum(rows[..., -1], -1)[..., :-1], (1, 0))
        out = (rows + before[..., None]).flatten(-2)[..., :n]
    return out.movedim(-1, dim)


def _repeat_groups(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, L, G, N] -> [B, L, H, N]."""
    g = t.shape[2]
    assert n_heads % g == 0
    return t.repeat_interleave(n_heads // g, dim=2)


def ssd_ref(x, dt, a, b, c, chunk: int = 128, initial_state=None):
    """x: [B,L,H,P]; dt: [B,L,H] (post-softplus); a: [H] (negative);
    b, c: [B,L,G,N].  Returns (y [B,L,H,P] f32, final_state [B,H,P,N] f32).
    """
    bsz, seqlen, n_heads, p = x.shape
    n = b.shape[-1]
    assert seqlen % chunk == 0, (seqlen, chunk)
    nc, q = seqlen // chunk, chunk

    xf = x.float().reshape(bsz, nc, q, n_heads, p)
    dtf = dt.float().reshape(bsz, nc, q, n_heads)
    bh = _repeat_groups(b.float(), n_heads).reshape(bsz, nc, q, n_heads, n)
    ch = _repeat_groups(c.float(), n_heads).reshape(bsz, nc, q, n_heads, n)

    adt = dtf * a.float()[None, None, None, :]                  # [B,NC,Q,H]
    cum = _cumsum(adt, dim=2)                                   # inclusive
    # within-chunk decay matrix  L[q,k] = exp(cum_q - cum_k),  k <= q
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [B,NC,Q,K,H]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    lmat = torch.exp(diff.masked_fill(~mask[None, None, :, :, None],
                                      float("-inf")))
    # diagonal (within-chunk) output
    scores = torch.einsum("bcqhn,bckhn->bcqkh", ch, bh) * lmat
    scores = scores * dtf[:, :, None, :, :]                     # weight by dt_k
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", scores, xf)
    # per-chunk end states:  sum_k exp(cum_Q - cum_k) dt_k B_k (x) x_k
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)              # [B,NC,Q,H]
    s_c = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_end * dtf, bh, xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # [B,NC,H]

    if initial_state is not None:
        state = initial_state.float()
    else:
        state = torch.zeros((bsz, n_heads, p, n), dtype=torch.float32,
                            device=x.device)
    s_prevs = []                                                # [B,H,P,N] each
    for i in range(nc):
        s_prevs.append(state)
        state = state * chunk_decay[:, i, :, None, None] + s_c[:, i]
    s_prev = torch.stack(s_prevs, dim=1)                        # [B,NC,H,P,N]
    # cross-chunk contribution:  C_q . (exp(cum_q) S_prev)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", ch, s_prev, torch.exp(cum))
    y = (y_diag + y_off).reshape(bsz, seqlen, n_heads, p)
    return y, state
