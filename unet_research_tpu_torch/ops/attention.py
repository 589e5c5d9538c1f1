"""Multi-head attention through PyTorch's fused SDPA, held to one backend on
the card: flash without a bias, memory-efficient with one.

`attention(q, k, v, bias=None)` is softmax(q k^T / sqrt(d) + bias) v over
(N, heads, T, d) tensors, no dropout; the bias (window attention's
relative-position bias and shift mask) broadcasts to (N, heads, T, T). Flash
takes no bias. On the card a bf16 or fp16 call whose head size the backend
takes (a multiple of 8, at most 256 for flash, at most 128 for the
memory-efficient kernels) runs under `sdpa_kernel` of that backend alone, so
a refused call raises instead of falling back to the math route, which
materialises every score; each such call adds one to `calls["flash"]` or
`calls["efficient"]`, any other card call one to `calls["other"]`. CPU calls
run SDPA's default route and count nothing. A CUDA graph replays the kernels
without calling this function, so whoever replays one credits the counts
(ops/cuda/launches.py, as `attn:flash` / `attn:efficient` / `attn:other`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

calls = {"flash": 0, "efficient": 0, "other": 0}


def route(q: torch.Tensor, biased: bool) -> str:
    """The count a card call of q (and k, v of q's shape and dtype, and a bias
    in q's dtype where `biased`) goes to: the backend it is held to, or
    'other' where that backend does not take it."""
    d = q.shape[-1]
    if q.is_cuda and q.dtype in (torch.bfloat16, torch.float16) and d % 8 == 0:
        if biased and d <= 128:
            return "efficient"
        if not biased and d <= 256:
            return "flash"
    return "other"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v of (N, heads, T, d) q, k, v and an
    optional additive bias that broadcasts to (N, heads, T, T)."""
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    name = route(q, bias is not None)
    if name == "other":
        calls["other"] += 1
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backend = (SDPBackend.FLASH_ATTENTION if name == "flash"
               else SDPBackend.EFFICIENT_ATTENTION)
    with sdpa_kernel(backend):
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
    calls[name] += 1
    return out
