"""Streaming ensemble statistics (twin of unet_research_tpu/uncertainty/ensemble.py).

Members are evaluated in chunks and merged into a running (count, mean, M2)
with Chan's parallel-variance combine, so memory holds one chunk of
activations whatever the ensemble size. The statistics match torch's
mean(0) / std(0) (unbiased) of the stacked members to float32 accuracy.
"""

from __future__ import annotations

from typing import Callable

import torch


def _batch_stats(outs: torch.Tensor):
    mean = outs.mean(dim=0)
    return float(outs.shape[0]), mean, ((outs - mean) ** 2).sum(dim=0)


def _merge(stats, new_stats):
    count, mean, m2 = stats
    new_count, new_mean, new_m2 = new_stats
    tot = count + new_count
    delta = new_mean - mean
    mean = mean + delta * (new_count / tot)
    m2 = m2 + new_m2 + delta * delta * (count * new_count / tot)
    return tot, mean, m2


def streaming_ensemble(chunk_fn: Callable[[torch.Tensor], torch.Tensor], xs: torch.Tensor,
                       chunk: int, return_num: int = 0):
    """(mean, std, saved) over the members xs[i], where chunk_fn maps a slice
    of xs to its members' outputs stacked on dim 0 (JAX
    streaming_ensemble(chunk_fn=True)).

    Chunk order, as in JAX: xs[:return_num] in one batch (kept as `saved`,
    the reference's tensors[0:return_num]), then full chunks of `chunk`,
    then the remainder. Statistics reduce in float32; std is unbiased."""
    total = xs.shape[0]
    if total < 2:
        raise ValueError("ensemble needs >= 2 members for std")
    return_num = min(return_num, total)
    stats = saved = None

    def absorb(part):
        nonlocal stats
        outs = chunk_fn(part).to(torch.float32)
        bstats = _batch_stats(outs)
        stats = bstats if stats is None else _merge(stats, bstats)
        return outs

    if return_num > 0:
        saved = absorb(xs[:return_num])
    for start in range(return_num, total, chunk):
        absorb(xs[start:start + chunk])
    count, mean, m2 = stats
    std = torch.sqrt(m2 / (count - 1.0))
    if saved is None:
        saved = torch.zeros((0,) + tuple(mean.shape), dtype=torch.float32, device=mean.device)
    return mean, std, saved


def streaming_ensemble_batched(batch_fn: Callable[[int], torch.Tensor], total: int,
                               chunk: int, return_num: int = 0):
    """streaming_ensemble over `total` members, where batch_fn(size) returns
    `size` fresh members stacked on dim 0 (the same chunk order)."""
    return streaming_ensemble(lambda idx: batch_fn(idx.shape[0]), torch.arange(total),
                              chunk, return_num)
