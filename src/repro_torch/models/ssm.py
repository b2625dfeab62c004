"""Mamba-2 (SSD, state-space duality) blocks; counterpart of
``repro.models.ssm`` (arXiv:2405.21060).

The reference's chunked SSD in jnp (``ssd_chunked``) does not call its
Pallas kernel; here ``ssd_chunked`` is a call of the ``ssd_scan`` op: the
hand-written CUDA kernel on the card, its plain chunked version on the CPU,
as the port's attention calls the flash op where the reference calls
``_chunked_attention``. The gated RMSNorm goes through the rmsnorm op; the
causal conv, ``silu`` and the O(1) decode step stay plain torch, as in the
reference (no TPU kernel exists for them).

Decode keeps a per-layer recurrent state (B, H, P, N) and conv tail
(B, d_conv - 1, d_xBC), both f32 in the cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.dtensors import rows_for_product
from repro_torch.distributed.logical import constrain
from repro_torch.kernels.ssd_scan.ops import ssd_scan

from .layers import ParamSpec, rms_norm


@dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    norm_eps: float = 1e-6
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def d_xbc(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba2_spec(cfg: SSMConfig) -> Dict[str, ParamSpec]:
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + cfg.n_heads
    return {
        "in_proj": ParamSpec((cfg.d_model, d_in_proj), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.d_conv, cfg.d_xbc), (None, "mlp")),
        "conv_b": ParamSpec((cfg.d_xbc,), ("mlp",), init="zeros"),
        "A_log": ParamSpec((cfg.n_heads,), ("heads",), init="zeros", f32_at_use=True),
        "dt_bias": ParamSpec((cfg.n_heads,), ("heads",), init="zeros", f32_at_use=True),
        "D": ParamSpec((cfg.n_heads,), ("heads",), init="ones"),
        "norm": ParamSpec((cfg.d_inner,), ("mlp",), init="ones", f32_at_use=True),
        "out_proj": ParamSpec((cfg.d_inner, cfg.d_model), ("mlp", "embed")),
    }


# ---------------------------------------------------------------------------
# Chunked SSD core
# ---------------------------------------------------------------------------


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H), post-softplus
    A: torch.Tensor,  # (H,), negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in x's dtype, final_state (B, H, P, N) f32).

    The scan runs in f32 throughout. At bf16 compute the reference rounds its
    scores and carried states to bf16 before its einsums; the op rounds once,
    at y (ROADMAP Queue C).

    The reference's ``("batch", "chunks", ...)`` constraints on its inputs
    and on y hold here on the chunked view of the sequence. Its chunk
    scores, chunk states and carried states (``cb``, ``chunk_states``,
    ``prev_states``) live only inside the ssd_scan kernels, whose wrapper
    gathers a split chunk axis before the state pass crosses it."""
    q = min(chunk, x.shape[1])
    x, dt, Bm, Cm = (_constrain_chunks(t, q) for t in (x, dt, Bm, Cm))
    y, state = ssd_scan(x, dt, A, Bm, Cm, block_q=chunk, initial_state=initial_state)
    return _constrain_chunks(y, q), state


def _constrain_chunks(t: torch.Tensor, q: int) -> torch.Tensor:
    """``t`` (B, S, ...) constrained as its (B, S / q, q, ...) view with the
    chunk axis "chunks", then viewed back. A sequence that is not a multiple
    of q (the reference pads it; the kernel needs no padding) is left as it
    is."""
    b, s = t.shape[:2]
    if s % q:
        return t
    chunks = t.view(b, s // q, q, *t.shape[2:])
    return constrain(chunks, ("batch", "chunks") + (None,) * (t.ndim - 1)).view(t.shape)


# ---------------------------------------------------------------------------
# Full Mamba-2 block
# ---------------------------------------------------------------------------


def _causal_conv(
    xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, tail: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. xbc: (B, S, C); w: (K, C). Returns (y, new_tail).

    ``tail`` (the cache leaf) keeps its own storage dtype; compute happens in
    the activation dtype."""
    k = w.shape[0]
    tail_dtype = xbc.dtype if tail is None else tail.dtype
    if tail is None:
        tail_c = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    else:
        tail_c = tail.to(xbc.dtype)
    xp = torch.cat([tail_c, xbc], dim=1)
    new_tail = xp[:, xp.shape[1] - (k - 1):, :] if k > 1 else tail_c[:, :0, :]
    s = xbc.shape[1]
    ys = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        ys = ys + xp[:, i:i + s, :] * w[i][None, None, :]
    return F.silu(ys + bias[None, None, :]), new_tail.to(tail_dtype)


def _gate_and_project(
    params: Dict[str, torch.Tensor], y: torch.Tensor, z: torch.Tensor, cfg: SSMConfig
) -> torch.Tensor:
    """rms_norm(y; norm) * silu(z), then out_proj: the block's output."""
    dt_ = y.dtype
    y = rms_norm({"scale": params["norm"]}, y, cfg.norm_eps) * F.silu(z)
    return y @ params["out_proj"].to(dt_)


def _dt_and_A(params: Dict[str, torch.Tensor], dt_raw: torch.Tensor,
              cfg: SSMConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    dt = dt.clamp(cfg.dt_min, cfg.dt_max)
    return dt, -torch.exp(params["A_log"].float())


def mamba2_forward(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, d_model)
    cfg: SSMConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Sequence-mode forward. ``state`` carries {ssm (B,H,P,N), conv (B,K-1,C)}
    for chunked prefill / streaming; None for plain training. The returned
    state is new tensors; the given one is not written."""
    dt_ = x.dtype
    b, s, _ = x.shape
    h, p, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups

    zxbcdt = constrain(rows_for_product(x) @ params["in_proj"].to(dt_), ("batch", None, "mlp"))
    z, xbc, dt_raw = torch.split(zxbcdt, [cfg.d_inner, cfg.d_xbc, h], dim=-1)
    conv_tail = state["conv"] if state is not None else None
    xbc, new_tail = _causal_conv(xbc, params["conv_w"].to(dt_), params["conv_b"].to(dt_), conv_tail)
    xs, Bm, Cm = torch.split(xbc, [cfg.d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(b, s, h, p)
    Bm = Bm.reshape(b, s, g, n)
    Cm = Cm.reshape(b, s, g, n)
    dt, A = _dt_and_A(params, dt_raw, cfg)

    init = state["ssm"] if state is not None else None
    y, final_state = ssd_chunked(xs, dt, A, Bm, Cm, cfg.chunk, init)
    y = y + xs * params["D"].to(dt_)[None, None, :, None]
    out = _gate_and_project(params, y.reshape(b, s, cfg.d_inner), z, cfg)
    new_state = {"ssm": final_state, "conv": new_tail} if state is not None else None
    return out, new_state


def mamba2_decode_step(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, 1, d_model)
    cfg: SSMConfig,
    state: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """O(1) recurrent decode: s' = exp(dt A) s + dt B (x) x; y = C s + D x."""
    dt_ = x.dtype
    b = x.shape[0]
    h, p, n, g = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    rep = h // g

    zxbcdt = x @ params["in_proj"].to(dt_)
    z, xbc, dt_raw = torch.split(zxbcdt, [cfg.d_inner, cfg.d_xbc, h], dim=-1)
    xbc, new_tail = _causal_conv(
        xbc, params["conv_w"].to(dt_), params["conv_b"].to(dt_), state["conv"]
    )
    xs, Bm, Cm = torch.split(xbc, [cfg.d_inner, g * n, g * n], dim=-1)
    xs = xs.reshape(b, h, p)
    Bm = Bm.reshape(b, g, n).repeat_interleave(rep, dim=1)  # (B,H,N)
    Cm = Cm.reshape(b, g, n).repeat_interleave(rep, dim=1)
    dt, A = _dt_and_A(params, dt_raw[:, 0], cfg)  # (B,H)
    decay = torch.exp(dt * A[None, :])

    s_prev = state["ssm"].float()
    upd = (dt[..., None] * xs.float())[..., :, None] * Bm.float()[:, :, None, :]
    s_new = s_prev * decay[..., None, None] + upd  # (B,H,P,N)
    y = torch.einsum("bhn,bhpn->bhp", Cm.float(), s_new)
    y = y.to(dt_) + xs * params["D"].to(dt_)[None, :, None]
    out = _gate_and_project(params, y.reshape(b, 1, cfg.d_inner), z, cfg)
    return out, {"ssm": s_new.to(state["ssm"].dtype), "conv": new_tail}


def mamba2_state_shape(
    batch: int, cfg: SSMConfig, dtype: Any = torch.float32
) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """(shape, dtype) of each state leaf."""
    return {
        "ssm": ((batch, cfg.n_heads, cfg.head_dim, cfg.d_state), dtype),
        "conv": ((batch, cfg.d_conv - 1, cfg.d_xbc), dtype),
    }
