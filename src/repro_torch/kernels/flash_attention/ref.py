"""Plain PyTorch versions of the flash_attention kernels (the CPU path and
the oracle). ``attention_ref`` is the same function as
``repro.kernels.flash_attention.ref``; ``attention_bwd_ref`` repeats the
backward kernels' arithmetic: P recomputed from the saved log-sum-exp, and
``Delta = rowsum(dO * O)``."""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch


def _scores(q, k, causal, sm_scale):
    """Masked f32 scores (B, H, Sq, Sk); query head h reads KV head h // group."""
    h, kv = q.shape[1], k.shape[1]
    sq, sk = q.shape[2], k.shape[2]
    kf = k.repeat_interleave(h // kv, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        mask = torch.arange(sk, device=q.device)[None, :] <= qpos
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    return s


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KV, Sk, D)
    v: torch.Tensor,  # (B, KV, Sk, D)
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Output (B, H, Sq, D) in q's dtype; with ``return_lse`` also the f32
    row log-sum-exps (B, H, Sq) of the scaled, masked scores."""
    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = _scores(q, k, causal, sm_scale)
    w = torch.softmax(s, dim=-1)
    vf = v.repeat_interleave(group, dim=1).float()
    out = torch.einsum("bhqk,bhkd->bhqd", w, vf).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def attention_bwd_ref(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KV, S, D)
    v: torch.Tensor,  # (B, KV, S, D)
    o: torch.Tensor,  # (B, H, S, D), the forward's output
    lse: torch.Tensor,  # (B, H, S) f32
    do: torch.Tensor,  # (B, H, S, D)
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in the inputs' dtypes, computed in f32; dK and dV sum
    the query heads of each KV group."""
    b, h, s_len, d = q.shape
    kv = k.shape[1]
    group = h // kv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    dof = do.float()
    vf = v.repeat_interleave(group, dim=1).float()
    kf = k.repeat_interleave(group, dim=1).float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * sm_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * sm_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.view(b, kv, group, -1, d).sum(dim=2)
    dv = dv.view(b, kv, group, -1, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
