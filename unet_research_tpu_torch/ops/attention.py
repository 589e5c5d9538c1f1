"""Multi-head attention through PyTorch's fused SDPA, held to its flash backend
on the card.

`attention(q, k, v)` is softmax(q k^T / sqrt(d)) v over (N, heads, T, d)
tensors, no mask, no dropout. On the card a bf16 or fp16 call with a head
size the flash kernels take (a multiple of 8, at most 256) runs under
`sdpa_kernel(FLASH_ATTENTION)` alone, so a refused call raises instead of
falling back to the math route; each such call adds one to `calls["flash"]`,
any other card call one to `calls["other"]`. CPU calls run SDPA's default
route and count nothing. A CUDA graph replays the kernels without calling
this function, so whoever replays one credits the counts
(ops/cuda/launches.py, as `attn:flash` / `attn:other`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

calls = {"flash": 0, "other": 0}


def flash_supported(q: torch.Tensor) -> bool:
    """Whether the flash backend takes q (and k, v of q's shape and dtype)."""
    d = q.shape[-1]
    return (q.is_cuda and q.dtype in (torch.bfloat16, torch.float16) and d % 8 == 0
            and d <= 256)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v of (N, heads, T, d) q, k, v."""
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v)
    if flash_supported(q):
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            out = F.scaled_dot_product_attention(q, k, v)
        calls["flash"] += 1
        return out
    calls["other"] += 1
    return F.scaled_dot_product_attention(q, k, v)
