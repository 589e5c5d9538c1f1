"""Losses with torch BCELoss values and finite gradients (twin of
unet_research_tpu/ops/losses.py).

The reference trains with ``nn.BCELoss()`` on sigmoid outputs, multiplies
segmentation and ground truth by the FOV mask first, and rescales the mean
loss by numel/count_nonzero(mask) so that masked-out zeros do not dilute it
(reference utils/utils_training.py:21-39).

The log terms are clamped at -100 as BCELoss clamps them, through a
double-`where` safe log: masked-out pixels are exactly 0 after seg*mask, and
a plain max(log(p), -100) has the gradient 0 * inf = NaN there (the NaN
bug of the JAX package's first round). Autograd through the two `where`s
gives the JAX gradients, finite at p = 0 and p = 1. `nn.BCELoss` is not
used: its backward, (p - t) / max(p(1-p), 1e-12), is another function at
the clamp.
"""

from __future__ import annotations

import torch

from unet_research_tpu_torch.parallel.mesh import psum

_TINY = 1.1754944e-38  # the smallest normal float32


def _safe_log(v: torch.Tensor) -> torch.Tensor:
    small = v < _TINY
    guarded = torch.where(small, torch.ones_like(v), v)
    return torch.where(small, torch.full_like(v, -100.0), torch.log(guarded))


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with torch.nn.BCELoss's values, computed in
    float32 whatever the input dtype."""
    p = pred.to(torch.float32)
    t = target.to(torch.float32)
    return -torch.mean(t * _safe_log(p) + (1.0 - t) * _safe_log(1.0 - p))


def masked_rescaled_bce(seg: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                        mesh=None) -> torch.Tensor:
    """Masked BCE with the reference's numel/nonzero rescale
    (utils/utils_training.py:28-33): -sum(terms) / count_nonzero(mask).

    mesh: the tensors are this rank's rows of a global batch
    (parallel/mesh.py). The count is then the global batch's, and the rank
    returns its share -sum_r(terms) / nonzero_global: the ranks' shares, and
    their gradients, sum to the global batch's loss and gradient (a mean of
    per-rank losses would be another function wherever two ranks' masks
    differ)."""
    seg = seg * mask
    gt = gt * mask
    loss = bce_loss(seg, gt)
    nonzero = (mask != 0).sum(dtype=torch.float32)
    if mesh is not None:
        nonzero = psum(nonzero, mesh)
    return loss * (seg.numel() / nonzero)
