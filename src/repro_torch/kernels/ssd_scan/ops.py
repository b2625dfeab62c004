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

A gradient goes through ``_SSDScan``, a ``torch.autograd.Function`` whose
forward keeps what the forward kernels already wrote: every chunk's
incoming state (the bf16 copy the output kernel reads, or the f32
workspace) and the chunks' summed ``dt * A``, saved for the backward, so
that under remat they live only from a layer's recompute to its backward.
Its backward (``ssd_scan_bwd`` with ``states``, the backward kernels) makes
four launches: each chunk's ``sum_i exp(cum_i) dy_i (x) C_i``; the pass in
reverse, which writes each chunk's outgoing state gradient once in the
chunk kernel's operand type and the partial sums of ``<G_out, S_in>``;
one block per (chunk, head, batch) for dx, ddt and dA's shares, in clusters
along the head axis that sum a group's dB and dC on chip; and the sums over
(batch, chunk) and over a group's clusters in a fixed order: no float
atomics and no per-head (B, S, H, N) shares, so equal inputs give equal
bits. ``ssd_scan_bwd`` without ``states`` (the standalone route) first runs
the forward's chunk-state kernel and pass into the same bf16 copy: six
launches, the same bits. ``ssd_scan_with_states`` returns the forward's
states beside its outputs. On the CPU the same route runs the plain
versions at ``block_q``: ``ref.ssd_scan_ref`` forward, and backward
autograd of it run again from the saved inputs (the gradient of the plain
version, bit for bit); so a step makes the same calls, and counts the same
costs, on the CPU, the meta device and the card. ``ssd_scan_bwd`` on CPU
tensors is ``ref.ssd_scan_bwd_ref``. ``launches`` and ``launches_bwd`` count
the calls that launched the forward and backward kernels; the CPU path
leaves them alone. ``last_bwd_scratch`` names what the last backward call
on the card allocated (``bwd_scratch``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.dtensors import (dtensor, grad_partial_where_sharded, is_dtensor, local,
                                              placements_keeping)

from .. import _build
from .._costs import KernelCost, counted, nbytes, op_type
from .._sharded import per_rank
from .ref import ssd_chunk_states_ref, ssd_scan_bwd_ref, ssd_scan_ref

MAX_N = 256
CHUNK = 64  # the kernels' chunk of positions
PASS_THREADS = 256  # the state pass's block
MAX_CLUSTER = 8  # heads whose dB and dC one cluster of the backward sums on chip
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = (
    [ctypes.c_void_p] * 11  # x, dt, A, B, C, initial state (null: zeros), y, final state,
    # the workspace, its bf16 copy (null for f32), the chunk totals
    + [ctypes.c_int] * 6  # B, S, H, G, P, N
    + [ctypes.c_int64] * 15  # (batch, seq, head) strides of x, dt, B, C, y
    + [ctypes.c_int, ctypes.c_void_p]  # dtype, stream
)

_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 23  # x, dt, A, B, C, dy, initial state, final-state gradient (nulls:
    # zeros); dx, ddt, dA, dB, dC, dinit; the chunk states and totals; the scratch: the
    # recompute's f32 states, the state gradients (f32, bf16), <G_out, S_in> partials,
    # dB and dC cluster partials, dA per chunk
    + [ctypes.c_int] * 9  # B, S, H, G, P, N, gs_parts, npart, recompute
    + [ctypes.c_int64] * 15  # (batch, seq, head) strides of x, dt, B, C, dy
    + [ctypes.c_int, ctypes.c_void_p]  # dtype, stream
)

launches = 0
launches_bwd = 0
last_bwd_scratch: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}


def _check(x, dt, A, Bm, Cm, initial_state) -> Tuple[int, int, int, int, int, int]:
    """What the kernels refuse, on the card and on the meta device alike (a
    dry run fails where the card would)."""
    ts = (x, dt, A, Bm, Cm) + ((initial_state,) if initial_state is not None else ())
    if x.device.type not in ("cuda", "meta") or any(t.device != x.device for t in ts):
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


def _fwd_cost(x, dt, A, Bm, Cm, initial_state=None, **_) -> KernelCost:
    """x, B, C, dt and A read, y and the final state written (an initial
    state read); 2 x 2 x P x N products a position and head."""
    b, s, h, p = x.shape
    state = 4 * b * h * p * Bm.shape[-1]
    moved = (2 * nbytes(x) + nbytes(Bm) + nbytes(Cm) + 4 * (dt.numel() + A.numel())
             + state * (2 if initial_state is not None else 1))
    products = 4.0 * x.numel() * Bm.shape[-1]
    return KernelCost(products, moved, products, op_type(x))


def _bwd_cost(x, dt, A, Bm, Cm, dy, dstate_final=None, initial_state=None, **_) -> KernelCost:
    """x, B, C, dt, dy and A read, dx, dB, dC, ddt and dA written (an
    initial state read and its gradient written, a final-state gradient
    read); twice the forward's products."""
    b, s, h, p = x.shape
    state = 4 * b * h * p * Bm.shape[-1]
    moved = (3 * nbytes(x) + 2 * (nbytes(Bm) + nbytes(Cm)) + 8 * (dt.numel() + A.numel())
             + state * (2 * (initial_state is not None) + (dstate_final is not None)))
    products = 8.0 * x.numel() * Bm.shape[-1]
    return KernelCost(products, moved, products, op_type(x))


@per_rank
@counted("ssd_scan_fwd", _fwd_cost)
def _scan_fwd(x, dt, A, Bm, Cm, initial_state, keep=False, block_q=128):
    """The forward kernels: ``(y, final_state)``, and with ``keep`` also
    the states the backward takes, ``(incoming states (B, nc, H, P, N) in
    x's dtype, totals (B, H, nc) f32)``. On the meta device, outputs of
    those shapes; on the CPU the plain versions at ``block_q``."""
    global launches
    if x.device.type == "cpu":
        y, state = ssd_scan_ref(x, dt, A, Bm, Cm, block_q=block_q, initial_state=initial_state)
        if keep:
            return y, state, ssd_chunk_states_ref(x, dt, A, Bm, block_q=block_q,
                                                  initial_state=initial_state)
        return y, state
    b, s, h, g, p, n = _check(x, dt, A, Bm, Cm, initial_state)
    if x.device.type == "meta":
        nc = -(-s // CHUNK)
        f32 = torch.float32
        y, state = x.new_empty(x.shape), x.new_empty((b, h, p, n), dtype=f32)
        if not keep:
            return y, state
        ws = x.new_empty((b, nc, h, p, n), dtype=f32)
        s_in = ws if x.dtype != torch.bfloat16 else ws.new_empty(ws.shape, dtype=x.dtype)
        return y, state, (s_in, x.new_empty((b, h, nc), dtype=f32))
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
    if keep:
        return y, state, (ws if ws_in is None else ws_in, total)
    return y, state


def bwd_parts(h: int, g: int, p: int, n: int) -> Tuple[int, int]:
    """``(gs_parts, npart)`` of the backward kernels: the reverse pass's
    blocks per (batch, head), each writing one partial sum of <G_out, S_in>
    per chunk, and the partial sums of dB and dC per group (its heads over
    the heads one cluster sums: the largest power of two up to
    ``MAX_CLUSTER`` that divides them)."""
    gs_parts = -(-p * n // (PASS_THREADS * (4 if n % 4 == 0 else 1)))
    rep, cs = h // g, MAX_CLUSTER
    while rep % cs:
        cs //= 2
    return gs_parts, rep // cs


def bwd_scratch(b: int, s: int, h: int, g: int, p: int, n: int, dtype: torch.dtype,
                recompute: bool) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Name to (shape, dtype) of every scratch tensor a backward call on the
    card allocates: with ``recompute`` (no states given) the chunk states
    and totals it writes first; the state gradients (f32, and in bf16 their
    operand copy); the <G_out, S_in> partials; the groups' dB and dC
    cluster partials where a group has more heads than a cluster; dA's
    per-chunk shares."""
    nc = -(-s // CHUNK)
    f32 = torch.float32
    gs_parts, npart = bwd_parts(h, g, p, n)
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if recompute:
        out["ws"] = ((b, nc, h, p, n), f32)
        if dtype == torch.bfloat16:
            out["s_in"] = ((b, nc, h, p, n), dtype)
        out["total"] = ((b, h, nc), f32)
    out["ws_g"] = ((b, nc, h, p, n), f32)
    if dtype == torch.bfloat16:
        out["g_op"] = ((b, nc, h, p, n), dtype)
    out["gs_part"] = ((b, nc, h, gs_parts), f32)
    if npart > 1:
        out["db_part"] = out["dc_part"] = ((b, s, g, npart, n), f32)
    out["da_part"] = ((b, nc, h), f32)
    return out


@per_rank
@counted("ssd_scan_bwd", _bwd_cost)
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
    states: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, ...]:
    """``(dx, ddt, dA, dB, dC, dinit)``: dx, dB and dC in x's dtype; ddt,
    dA and dinit (the initial state's gradient, zeros or not) f32.
    ``block_q`` sets the chunk of the plain version only, as in ``ssd_scan``.
    ``states``: the forward's ``(incoming states, totals)`` as
    ``ssd_scan_with_states`` returns them on this device (on the card
    (B, ceil(S / 64), H, P, N) in x's dtype and (B, H, ceil(S / 64)) f32);
    None recomputes them, with the same bits."""
    global launches_bwd, last_bwd_scratch
    if x.device.type == "cpu":
        dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, dstate_final,
                                                      initial_state, block_q=block_q, states=states)
        return dx.to(x.dtype), ddt, dA, dB.to(x.dtype), dC.to(x.dtype), dinit
    b, s, h, g, p, n = _check(x, dt, A, Bm, Cm, initial_state)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"ssd_scan backward: dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"does not match x")
    if dstate_final is not None and (dstate_final.shape != (b, h, p, n)
                                     or dstate_final.device != x.device):
        raise ValueError(f"ssd_scan backward: the final state's gradient must be {(b, h, p, n)}")
    nc = -(-s // CHUNK)
    if states is not None:
        s_in, total = states
        if (s_in.shape != (b, nc, h, p, n) or s_in.dtype != x.dtype or total.shape != (b, h, nc)
                or total.dtype != torch.float32 or not s_in.is_contiguous()
                or not total.is_contiguous() or s_in.device != x.device
                or total.device != x.device):
            raise ValueError(f"ssd_scan backward: states must be contiguous {(b, nc, h, p, n)} "
                             f"{x.dtype} and {(b, h, nc)} float32 on {x.device}")
    if x.device.type == "meta":
        f32 = torch.float32
        grads = (x.new_empty(x.shape), x.new_empty((b, s, h), dtype=f32), x.new_empty((h,), dtype=f32),
                 Bm.new_empty(Bm.shape), Bm.new_empty(Bm.shape), x.new_empty((b, h, p, n), dtype=f32))
        # the card's scratch, alive during the call as there
        _scratch = [x.new_empty(shape, dtype=dtype) for shape, dtype in
                    bwd_scratch(b, s, h, g, p, n, x.dtype, states is None).values()]
        return grads
    x, Bm, Cm, dy = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, Bm, Cm, dy))
    dt, A = dt.float(), A.float().contiguous()
    init = None if initial_state is None else initial_state.float().contiguous()
    dst = None if dstate_final is None else dstate_final.float().contiguous()
    dev, f32 = x.device, torch.float32
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, h), dtype=f32, device=dev)
    dA = torch.empty((h,), dtype=f32, device=dev)
    dB, dC = (torch.empty((b, s, g, n), dtype=x.dtype, device=dev) for _ in range(2))
    dinit = torch.empty((b, h, p, n), dtype=f32, device=dev)
    scratch = bwd_scratch(b, s, h, g, p, n, x.dtype, states is None)
    last_bwd_scratch = scratch
    ws = {k: torch.empty(shape, dtype=dtype, device=dev) for k, (shape, dtype) in scratch.items()}
    if states is None:
        s_in, total = ws.get("s_in", ws["ws"]), ws["total"]
    gs_parts, npart = bwd_parts(h, g, p, n)
    fn = _build.entry("ssd_scan", "repro_ssd_scan_bwd", _BWD_ARGTYPES)
    strides = [st for t in (x, dt, Bm, Cm, dy) for st in t.stride()[:3]]
    ptrs = [t.data_ptr() if t is not None else None
            for t in (x, dt, A, Bm, Cm, dy, init, dst, dx, ddt, dA, dB, dC, dinit, s_in, total,
                      ws.get("ws"), ws["ws_g"], ws.get("g_op"), ws["gs_part"], ws.get("db_part"),
                      ws.get("dc_part"), ws["da_part"])]
    code = fn(*ptrs, b, s, h, g, p, n, gs_parts, npart, int(states is None), *strides,
              _DTYPES[x.dtype], _build.stream_ptr(dev))
    _build.check("ssd_scan", code)
    launches_bwd += 1
    return dx, ddt, dA, dB, dC, dinit


@per_rank
@counted("ssd_scan_bwd", _bwd_cost)
def _input_grads(x, dt, A, Bm, Cm, dy, dstate_final, initial_state, *, block_q, states, needs):
    """``_SSDScan``'s input gradients, in the inputs' dtypes (None where
    ``needs`` wants none): on the CPU autograd of the plain version, run
    again from the inputs (so bit for bit ``ssd_scan_ref``'s gradient),
    elsewhere ``ssd_scan_bwd`` over the forward's ``states``."""
    if x.device.type == "cpu":
        with torch.enable_grad():
            leaves = [t if t is None else t.detach().requires_grad_(n)
                      for t, n in zip((x, dt, A, Bm, Cm, initial_state), needs)]
            y, state = ssd_scan_ref(*leaves[:5], block_q=block_q, initial_state=leaves[5])
            outs = (y,) if dstate_final is None else (y, state)
            cots = (dy,) if dstate_final is None else (dy, dstate_final)
            grads = iter(torch.autograd.grad(outs, [t for t, n in zip(leaves, needs) if n], cots))
        return tuple(next(grads) if n else None for n in needs)
    dx, ddt, dA, dB, dC, dinit = ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dstate_final, initial_state,
                                              block_q=block_q, states=states)
    return (dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC,
            None if initial_state is None else dinit.to(initial_state.dtype))


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, initial_state, block_q):
        if x.device.type == "cpu":  # the backward differentiates the plain version again
            y, state = _scan_fwd(x, dt, A, Bm, Cm, initial_state, block_q=block_q)
            states = ()
        else:
            y, state, states = _scan_fwd(x, dt, A, Bm, Cm, initial_state, keep=True)
        # the forward's chunk states, saved (not attributes) so that remat's
        # hooks drop them with the layer's other saved tensors
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state, *states)
        ctx.set_materialize_grads(False)  # None cotangents stay None (the final state's)
        ctx.block_q = block_q
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, init, *states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        return _input_grads(x, dt, A, Bm, Cm, dy, dstate, init, block_q=ctx.block_q,
                            states=tuple(states), needs=ctx.needs_input_grad[:6]) + (None,)


def ssd_scan_with_states(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H), post-softplus
    A: torch.Tensor,  # (H,), negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    *,
    block_q: int = 128,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``(y, final_state, states)``, not differentiable: ``ssd_scan``'s
    outputs and the ``states`` that ``ssd_scan_bwd`` takes on this device
    (on the card the forward kernels' own, in one launch of them; on the
    CPU the plain version's at ``block_q``)."""
    with torch.no_grad():
        return _scan_fwd(x, dt, A, Bm, Cm, initial_state, keep=True, block_q=block_q)


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
    runs the CUDA kernel. DTensors (the sharded step) run the kernels on
    each rank's batch rows (``_sharded``)."""
    if is_dtensor(x):
        return _sharded(x, dt, A, Bm, Cm, block_q, initial_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, initial_state)):
        return _SSDScan.apply(x, dt, A, Bm, Cm, initial_state, block_q)
    return _scan_fwd(x, dt, A, Bm, Cm, initial_state, block_q=block_q)


def _sharded(x, dt, A, Bm, Cm, block_q, initial_state):
    """The scan of DTensors: the batch rows keep their shards. The state
    pass carries each chunk's state into the next, so a split sequence (the
    reference splits its chunk axis over "model") is gathered here, and so
    are split heads (a head reads its group's B and C). A is gathered whole;
    its local gradient is a partial sum over each axis that splits the
    batch."""
    from torch.distributed.tensor import Replicate

    if not all(is_dtensor(t) for t in (dt, A, Bm, Cm)):
        raise TypeError("ssd_scan of a DTensor x needs DTensors dt, A, B and C on the same mesh")
    pl = placements_keeping(x.placements, (0,))
    whole = (Replicate(),) * len(pl)
    init = None if initial_state is None else local(initial_state, pl)
    y, state = ssd_scan(local(x, pl), local(dt, pl), local(A, whole, grad_partial_where_sharded(pl)),
                        local(Bm, pl), local(Cm, pl), block_q=block_q, initial_state=init)
    return dtensor(y, x, pl), dtensor(state, x, pl)
