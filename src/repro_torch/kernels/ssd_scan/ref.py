"""Plain PyTorch versions of the SSD scan (the CPU path and the oracles).

``ssd_ref`` is the sequential recurrence of ``repro.kernels.ssd_scan.ref``,
a different algorithm from the chunked form, which makes an allclose check
between the two meaningful::

    s_t = exp(dt_t * A) * s_{t-1} + dt_t * (B_t (x) x_t)
    y_t = C_t . s_t

``ssd_scan_ref`` is the chunked dual form the kernel computes, all in f32:
per chunk of ``block_q`` positions the intra-chunk term
``(C B^T * L * dt_j) x`` with ``L[i, j] = exp(cum_i - cum_j)`` on and below
the diagonal and 0 above it (the exponent is set to -inf there before the
exp, never multiplied by a mask: it overflows above the diagonal), the inter-chunk term ``exp(cum_i) C state^T``,
and the state update ``exp(total) state + sum_j dt_j exp(total - cum_j)
x_j (x) B_j``. Positions past S count as dt = 0, an exact no-op on the
recurrence. Head h reads group ``h // (H // G)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y (B, S, H, P) in x's dtype, final_state (B, H, P, N) f32)``."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    Bh = Bm.repeat_interleave(rep, dim=2).float()  # (B,S,H,N)
    Ch = Cm.repeat_interleave(rep, dim=2).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None, :])  # (B,H)
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :]
        state = state * decay[..., None, None] + upd  # (B,H,P,N)
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, h, p))
    return y.to(x.dtype), state


def ssd_scan_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) f32
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    *,
    block_q: int = 128,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y (B, S, H, P) in x's dtype, final_state (B, H, P, N) f32)``."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    q = max(min(block_q, s), 1)
    pad = (-s) % q
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    if pad:
        xf, dtf, Bf, Cf = (torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                           for t in (xf, dtf, Bf, Cf))
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, s + pad, q):
        xc = xf[:, c0:c0 + q]  # (B,Q,H,P)
        dtc = dtf[:, c0:c0 + q].transpose(1, 2)  # (B,H,Q)
        Bh = Bf[:, c0:c0 + q].repeat_interleave(rep, dim=2)  # (B,Q,H,N)
        Ch = Cf[:, c0:c0 + q].repeat_interleave(rep, dim=2)
        cum = torch.cumsum(dtc * A.float()[None, :, None], dim=-1)  # (B,H,Q)
        total = cum[..., -1:]  # (B,H,1)
        # -inf above the diagonal before the exp, as the reference's _segsum
        L = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~tri, float("-inf")))
        cb = torch.einsum("bqhn,bshn->bhqs", Ch, Bh)  # (B,H,Q,Q)
        scores = cb * L * dtc[..., None, :]  # dt_j on the keys
        y_intra = torch.einsum("bhqs,bshp->bqhp", scores, xc)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", Ch, state) * torch.exp(cum).transpose(1, 2)[..., None]
        ys.append(y_intra + y_inter)
        w = (dtc * torch.exp(total - cum)).transpose(1, 2)  # (B,Q,H)
        contrib = torch.einsum("bqhp,bqhn->bhpn", xc * w[..., None], Bh)
        state = state * torch.exp(total)[..., None] + contrib
    y = torch.cat(ys, dim=1)[:, :s] if ys else xf.new_zeros((b, 0, h, p))
    return y.to(x.dtype), state
