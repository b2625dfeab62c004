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

``ssd_scan_bwd_ref`` is the chunked backward written out (the backward
kernel's oracle), in f32. Per chunk, with ``w_j = dt_j exp(total - cum_j)``,
``G_out`` the gradient of the chunk's outgoing state and ``S_in`` its
incoming state:

* the state gradients run backwards over the chunks:
  ``G_in = exp(total) G_out + sum_i exp(cum_i) dy_i (x) C_i``;
* ``dx_j = sum_{i>=j} (C_i . B_j) L_ij dt_j dy_i + w_j G_out B_j``;
* ``dB_j = sum_{i>=j} (dy_i . x_j) L_ij dt_j C_i + w_j G_out^T x_j`` and
  ``dC_i = sum_{j<=i} (dy_i . x_j) L_ij dt_j B_j + exp(cum_i) S_in^T dy_i``,
  per head, summed over the heads of a group;
* dt and A enter through ``cum``: ``dcum_i = sum_j T_ij - sum_k T_ki +
  dy_i . y_inter_i - w_i x_i^T G_out B_i`` with ``T_ij = (dy_i . x_j)
  (C_i . B_j) L_ij dt_j``, plus ``<G_out, S_out>`` at the chunk's last
  position; ``da_t`` is its suffix sum within the chunk, ``ddt_t = sum_i
  T_it / dt_t + exp(total - cum_t) x_t^T G_out B_t + A da_t`` and
  ``dA = sum dt_t da_t``.

``ssd_chunk_states_ref`` gives every chunk's incoming state and summed
``dt * A``, the ``states`` that ``ssd_scan_bwd_ref`` takes in place of its
own recompute, as the kernels' backward takes the forward's.
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


def _chunks(t: torch.Tensor, nc: int, q: int) -> torch.Tensor:
    """(B, nc q, H, F) -> (B, H, nc, q, F)."""
    return t.reshape(t.shape[0], nc, q, t.shape[2], t.shape[3]).permute(0, 3, 1, 2, 4)


def _unchunk(t: torch.Tensor, s: int) -> torch.Tensor:
    """(B, H, nc, q, F) -> (B, s, H, F), the padding dropped."""
    b, h, nc, q, f = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(b, nc * q, h, f)[:, :s]


def _chunked(x, dt, A, Bm, block_q):
    """The chunk of ``block_q`` positions (at most S), the padding and the
    chunked f32 views: x (B, H, nc, Q, P), B (B, H, nc, Q, N) per head, dt
    and cum (B, H, nc, Q), total (B, H, nc)."""
    b, s, h, p = x.shape
    rep = h // Bm.shape[2]
    q = max(min(block_q, s), 1)
    pad = (-s) % q
    nc = (s + pad) // q
    xf, dtf, Bf = (t.float() for t in (x, dt, Bm))
    if pad:
        xf, dtf, Bf = (torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                       for t in (xf, dtf, Bf))
    xc = _chunks(xf, nc, q)
    Bc = _chunks(Bf.repeat_interleave(rep, dim=2), nc, q)
    dtc = _chunks(dtf[..., None], nc, q)[..., 0]
    cum = torch.cumsum(dtc * A.float()[None, :, None, None], dim=-1)
    return q, pad, nc, xc, Bc, dtc, cum, cum[..., -1]


def _incoming_states(xc, Bc, dtc, cum, total, initial_state):
    """Every chunk's incoming state, (B, H, nc, P, N) f32."""
    b, h, nc, _, p = xc.shape
    n = Bc.shape[-1]
    w = dtc * torch.exp(total[..., None] - cum)
    contrib = torch.einsum("bhcq,bhcqp,bhcqn->bhcpn", w, xc, Bc)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xc.device)
             if initial_state is None else initial_state.float())
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = state * torch.exp(total[:, :, c])[..., None, None] + contrib[:, :, c]
    return torch.stack(s_in, dim=2)


def ssd_chunk_states_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) f32
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, S, G, N)
    *,
    block_q: int = 128,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s_in (B, nc, H, P, N), total (B, H, nc))``, f32: every chunk's
    incoming state and its summed ``dt * A``, at chunks of ``block_q``
    positions (the last padded): the ``states`` that ``ssd_scan_bwd_ref``
    takes in place of its own recompute, in the layout the kernels keep."""
    _, _, _, xc, Bc, dtc, cum, total = _chunked(x, dt, A, Bm, block_q)
    return _incoming_states(xc, Bc, dtc, cum, total, initial_state).transpose(1, 2), total


def ssd_scan_bwd_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) f32
    A: torch.Tensor,  # (H,) f32, negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    dy: torch.Tensor,  # (B, S, H, P): the gradient of y
    dstate_final: Optional[torch.Tensor] = None,  # (B, H, P, N): of the final state; None: zeros
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N); None: zeros
    *,
    block_q: int = 128,
    states: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddt, dA, dB, dC, dinit)``, all f32 (the caller casts dx, dB
    and dC to the inputs' dtype); dinit is the gradient of the initial
    state, zeros or not. ``states``: every chunk's incoming state and summed
    ``dt * A`` at this ``block_q``, as ``ssd_chunk_states_ref`` gives them
    (the forward's, on the main path); None recomputes them."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    q, pad, nc, xc, Bc, dtc, cum, total = _chunked(x, dt, A, Bm, block_q)
    Af = A.float()
    Cf, dyf = Cm.float(), dy.float()
    if pad:
        Cf, dyf = (torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (Cf, dyf))
    dyc = _chunks(dyf, nc, q)  # (B,H,nc,Q,P)
    Cc = _chunks(Cf.repeat_interleave(rep, dim=2), nc, q)
    if states is None:
        S_in = _incoming_states(xc, Bc, dtc, cum, total, initial_state)  # (B,H,nc,P,N)
    else:
        if states[0].shape != (b, nc, h, p, n) or states[1].shape != (b, h, nc):
            raise ValueError(f"ssd_scan_bwd_ref: states must be {(b, nc, h, p, n)} and "
                             f"{(b, h, nc)} at block_q={q}, not {tuple(states[0].shape)} and "
                             f"{tuple(states[1].shape)}")
        S_in, total = states[0].float().transpose(1, 2).contiguous(), states[1].float()
    w = dtc * torch.exp(total[..., None] - cum)
    ecum = torch.exp(cum)

    # the outgoing state gradient of every chunk, walking back from the last
    dsum = torch.einsum("bhcq,bhcqp,bhcqn->bhcpn", ecum, dyc, Cc)
    grad = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
            if dstate_final is None else dstate_final.float())
    g_out = [None] * nc
    for c in reversed(range(nc)):
        g_out[c] = grad
        grad = grad * torch.exp(total[:, :, c])[..., None, None] + dsum[:, :, c]
    G = torch.stack(g_out, dim=2)  # (B,H,nc,P,N)

    # within each chunk: L above the diagonal is 0, its exponent -inf before the exp
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~tri, float("-inf")))
    dtj = dtc[..., None, :]  # dt_j on the columns
    CB = torch.einsum("bhcin,bhcjn->bhcij", Cc, Bc)
    M = torch.einsum("bhcip,bhcjp->bhcij", dyc, xc)
    Sx, Sb, E = CB * L * dtj, M * L * dtj, M * CB * L
    xG = torch.einsum("bhcjp,bhcpn->bhcjn", xc, G)
    dyS = torch.einsum("bhcip,bhcpn->bhcin", dyc, S_in)
    dx = torch.einsum("bhcij,bhcip->bhcjp", Sx, dyc) + \
        w[..., None] * torch.einsum("bhcjn,bhcpn->bhcjp", Bc, G)
    dBh = torch.einsum("bhcij,bhcin->bhcjn", Sb, Cc) + w[..., None] * xG
    dCh = torch.einsum("bhcij,bhcjn->bhcin", Sb, Bc) + ecum[..., None] * dyS
    u = (Bc * xG).sum(-1)  # x_j^T G_out B_j
    v = (Cc * dyS).sum(-1)  # dy_i . y_inter_i / exp(cum_i)
    gs = (G * S_in).sum((-1, -2))  # <G_out, S_in>
    colE = E.sum(-2)
    dcum = (E * dtj).sum(-1) - dtc * colE + ecum * v - w * u
    dcum[..., -1] += (w * u).sum(-1) + torch.exp(total) * gs  # <G_out, S_out>
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), dim=-1), (-1,))
    ddt = colE + torch.exp(total[..., None] - cum) * u + Af[None, :, None, None] * da
    dA = (dtc * da).sum((0, 2, 3))

    def group_sum(t):  # (B,H,nc,Q,N) per head -> (B,S,G,N)
        t = _unchunk(t, s)
        return t.reshape(b, s, g, rep, n).sum(3)

    return (_unchunk(dx, s), _unchunk(ddt[..., None], s)[..., 0], dA, group_sum(dBh),
            group_sum(dCh), grad)
