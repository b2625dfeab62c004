"""The Mamba-2 SSD scan on the model layout: the CUDA kernels
(``csrc/ssd_scan.cu``) for CUDA tensors, the plain chunked version
(``ref.ssd_scan_ref``) for CPU tensors.

The kernels read x ``(B, S, H, P)`` and B, C ``(B, S, G, N)`` through their
strides, so neither the reference wrapper's move of the sequence axis nor
its padding to a multiple of ``block_q`` is needed. They take chunks of 64
positions, and ``block_q`` sets the chunk of the plain version only (the
result does not depend on the chunk beyond rounding). One call makes three
CUDA launches, each parallel over (chunk, head, batch) or (batch, head, p,
n): every chunk's own state contribution into an f32 workspace, the pass
that carries the state across the chunks, and every chunk's output; bf16
runs their products on the tensor cores. The bound on the card is the bytes
(x, B, C and dt read once, y and the final state written once). Beyond the
reference's signature there is one keyword, ``initial_state``: the state
the scan starts from (zeros when None), which the model's prefill passes
from its cache, as the reference's ``ssd_chunked`` takes one.

A gradient goes through ``_SSDScan``, a ``torch.autograd.Function`` that
saves only its inputs: its backward (``ssd_scan_bwd``, the backward
kernels) recomputes the chunk states, so no (B, nc, H, P, N) workspace is
kept from the forward to the backward. One backward call makes six
launches: the forward's chunk-state kernel and pass again (each chunk's
incoming state), the same two on dy and C with the pass in reverse (each
chunk's outgoing state gradient), one block per (chunk, head, batch) for dx,
ddt and each head's share of dB, dC and dA (bf16 on the tensor cores), and
the sums of those shares over the heads of a group and over (batch, chunk)
in a fixed order: no float atomics, so equal inputs give equal bits. On the
CPU the plain version is differentiated by autograd. ``launches`` and
``launches_bwd`` count the calls that launched the forward and backward
kernels; the CPU path leaves them alone.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import ssd_scan_bwd_ref, ssd_scan_ref

MAX_N = 256
CHUNK = 64  # the kernels' chunk of positions
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 11  # x, dt, A, B, C, initial state (null: zeros), y, final state,
    # the workspace, its bf16 copy (null for f32), the chunk totals
    + [ctypes.c_int] * 6  # B, S, H, G, P, N
    + [ctypes.c_int64] * 15  # (batch, seq, head) strides of x, dt, B, C, y
    + [ctypes.c_int, ctypes.c_void_p]  # dtype, stream
)

_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 20  # x, dt, A, B, C, dy, initial state, final-state gradient (nulls:
    # zeros); dx, ddt, dA, dB, dC, dinit; the workspaces: states, state gradients, chunk
    # totals, dB and dC per head, dA per chunk
    + [ctypes.c_int] * 6  # B, S, H, G, P, N
    + [ctypes.c_int64] * 15  # (batch, seq, head) strides of x, dt, B, C, dy
    + [ctypes.c_int, ctypes.c_void_p]  # dtype, stream
)

launches = 0
launches_bwd = 0


def _check(x, dt, A, Bm, Cm, initial_state) -> Tuple[int, int, int, int, int, int]:
    ts = (x, dt, A, Bm, Cm) + ((initial_state,) if initial_state is not None else ())
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"ssd_scan runs on cuda or cpu tensors, not {[str(t.device) for t in ts]}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes x, B and C in float32 or bfloat16 alike, not "
                        f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (b, s, h) or A.shape != (h,) or Bm.shape != (b, s, g, n)
            or Cm.shape != Bm.shape or g == 0 or h % g):
        raise ValueError(f"ssd_scan shapes: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if not 0 < n <= MAX_N:
        raise ValueError(f"ssd_scan kernel needs 0 < N <= {MAX_N}, got {n}")
    if initial_state is not None and initial_state.shape != (b, h, p, n):
        raise ValueError(f"ssd_scan initial_state must be {(b, h, p, n)}, "
                         f"not {tuple(initial_state.shape)}")
    return b, s, h, g, p, n


def _scan_fwd(x, dt, A, Bm, Cm, initial_state):
    """The forward kernels on CUDA tensors that ``_check`` passed."""
    global launches
    b, s, h, g, p, n = _check(x, dt, A, Bm, Cm, initial_state)
    x, Bm, Cm = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, Bm, Cm))
    dt, A = dt.float(), A.float().contiguous()
    init = None if initial_state is None else initial_state.float().contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    nc = -(-s // CHUNK)
    ws = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=x.device)
    # bf16: the incoming states as the output kernel's bf16 operands
    ws_in = torch.empty_like(ws, dtype=x.dtype) if x.dtype == torch.bfloat16 else None
    total = torch.empty((b, h, nc), dtype=torch.float32, device=x.device)
    fn = _build.entry("ssd_scan", "repro_ssd_scan", _ARGTYPES)
    strides = [st for t in (x, dt, Bm, Cm, y) for st in t.stride()[:3]]
    code = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
              init.data_ptr() if init is not None else None, y.data_ptr(), state.data_ptr(),
              ws.data_ptr(), ws_in.data_ptr() if ws_in is not None else None, total.data_ptr(),
              b, s, h, g, p, n, *strides, _DTYPES[x.dtype],
              _build.stream_ptr(x.device))
    _build.check("ssd_scan", code)
    launches += 1
    return y, state


def ssd_scan_bwd(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H), post-softplus
    A: torch.Tensor,  # (H,), negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    dy: torch.Tensor,  # (B, S, H, P): the gradient of y
    dstate_final: Optional[torch.Tensor] = None,  # (B, H, P, N): of the final state; None: zeros
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N); None: zeros
    *,
    block_q: int = 128,
) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddt, dA, dB, dC, dinit)``: dx, dB and dC in x's dtype; ddt,
    dA and dinit (the initial state's gradient, zeros or not) f32.
    ``block_q`` sets the chunk of the plain version only, as in ``ssd_scan``."""
    global launches_bwd
    if x.device.type == "cpu":
        dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dstate_final,
                                                      initial_state, block_q=block_q)
        return dx.to(x.dtype), ddt, dA, dB.to(x.dtype), dC.to(x.dtype), dinit
    b, s, h, g, p, n = _check(x, dt, A, Bm, Cm, initial_state)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan backward: dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"does not match x")
    if dstate_final is not None and (dstate_final.shape != (b, h, p, n)
                                     or dstate_final.device != x.device):
        raise ValueError(f"ssd_scan backward: the final state's gradient must be {(b, h, p, n)}")
    x, Bm, Cm, dy = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, Bm, Cm, dy))
    dt, A = dt.float(), A.float().contiguous()
    init = None if initial_state is None else initial_state.float().contiguous()
    dst = None if dstate_final is None else dstate_final.float().contiguous()
    dev, f32 = x.device, torch.float32
    nc = -(-s // CHUNK)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, h), dtype=f32, device=dev)
    dA = torch.empty((h,), dtype=f32, device=dev)
    dB, dC = (torch.empty((b, s, g, n), dtype=x.dtype, device=dev) for _ in range(2))
    dinit = torch.empty((b, h, p, n), dtype=f32, device=dev)
    ws_s, ws_g = (torch.empty((b, nc, h, p, n), dtype=f32, device=dev) for _ in range(2))
    total = torch.empty((b, h, nc), dtype=f32, device=dev)
    db_part, dc_part = (torch.empty((b, s, h, n), dtype=f32, device=dev) for _ in range(2))
    da_part = torch.empty((b, nc, h), dtype=f32, device=dev)
    fn = _build.entry("ssd_scan", "repro_ssd_scan_bwd", _BWD_ARGTYPES)
    strides = [st for t in (x, dt, Bm, Cm, dy) for st in t.stride()[:3]]
    ptrs = [t.data_ptr() if t is not None else None
            for t in (x, dt, A, Bm, Cm, dy, init, dst, dx, ddt, dA, dB, dC, dinit, ws_s, ws_g,
                      total, db_part, dc_part, da_part)]
    code = fn(*ptrs, b, s, h, g, p, n, *strides, _DTYPES[x.dtype], _build.stream_ptr(dev))
    _build.check("ssd_scan", code)
    launches_bwd += 1
    return dx, ddt, dA, dB, dC, dinit


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, initial_state):
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.set_materialize_grads(False)  # None cotangents stay None (the final state's)
        return _scan_fwd(x, dt, A, Bm, Cm, initial_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, init = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dstate, init)
        return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC,
                None if init is None else dinit.to(init.dtype))


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H), post-softplus
    A: torch.Tensor,  # (H,), negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    *,
    block_q: int = 128,
    interpret: bool = False,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y (B, S, H, P) in x's dtype, final_state (B, H, P, N) f32)``;
    differentiable in every input on the card (the backward kernels) and
    on the CPU (autograd of the plain version). dt, A and the state are
    taken in f32. ``interpret``, the reference's keyword, is accepted and
    ignored: it names the TPU kernel's interpreter, so a CUDA tensor still
    runs the CUDA kernel."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bm, Cm, block_q=block_q, initial_state=initial_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, initial_state)):
        return _SSDScan.apply(x, dt, A, Bm, Cm, initial_state)
    return _scan_fwd(x, dt, A, Bm, Cm, initial_state)
