"""Plain PyTorch version of the flash_attention kernel (the CPU path and the
oracle); the same function as ``repro.kernels.flash_attention.ref``."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KV, Sk, D)
    v: torch.Tensor,  # (B, KV, Sk, D)
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    b, h, sq, d = q.shape
    kv, sk = k.shape[1], k.shape[2]
    group = h // kv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    # query head h reads KV head h // group
    kf = k.repeat_interleave(group, dim=1).float()
    vf = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        mask = torch.arange(sk, device=q.device)[None, :] <= qpos
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vf).to(q.dtype)
