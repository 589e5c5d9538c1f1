"""The port's losses (unet_research_tpu_torch/ops/losses.py) against the JAX
package's: values and gradients of the masked rescaled BCE, with
predictions at exactly 0 and 1 inside and outside the mask. float32; values
and gradients within 1e-6 relative (the same float32 operations; the means
sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_research_tpu.ops import losses as jl
from unet_research_tpu_torch.ops import losses as tl


def _case(rng, shape, extremes: bool):
    seg = rng.random(shape, dtype=np.float32)
    gt = (rng.random(shape) > 0.5).astype(np.float32)
    mask = (rng.random(shape) > 0.3).astype(np.float32)
    if extremes:
        flat = seg.reshape(-1)
        m = mask.reshape(-1)
        flat[:8] = [0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 1e-39, 1.0 - 1e-8]
        m[:8] = [1.0, 1.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0]
        gt.reshape(-1)[:8] = [1.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0, 1.0]
    return seg, gt, mask


@pytest.mark.parametrize("shape,extremes", [((2, 12, 10, 1), False), ((1, 9, 7, 1), True),
                                            ((3, 8, 8, 1), True)])
def test_masked_rescaled_bce_value_and_grad_match_jax(rng, shape, extremes):
    seg, gt, mask = _case(rng, shape, extremes)
    jv, jg = jax.value_and_grad(jl.masked_rescaled_bce)(jnp.asarray(seg), jnp.asarray(gt),
                                                        jnp.asarray(mask))
    s = torch.from_numpy(seg).requires_grad_()
    tv = tl.masked_rescaled_bce(s, torch.from_numpy(gt), torch.from_numpy(mask))
    tv.backward()
    assert tv.dtype == torch.float32
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-6)
    assert np.isfinite(s.grad.numpy()).all()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)


def test_bce_clamps_at_minus_100_like_bceloss():
    p = torch.tensor([[0.0, 1.0]])
    t = torch.tensor([[1.0, 0.0]])
    assert float(tl.bce_loss(p, t)) == 100.0
    q = torch.rand((4, 5), generator=torch.Generator().manual_seed(0))
    t = (torch.rand((4, 5), generator=torch.Generator().manual_seed(1)) > 0.5).float()
    ref = torch.nn.BCELoss()(q, t)
    assert abs(float(tl.bce_loss(q, t)) - float(ref)) < 1e-6


def test_bf16_input_computes_in_float32():
    p = torch.full((2, 3), 0.25, dtype=torch.bfloat16)
    t = torch.ones((2, 3), dtype=torch.bfloat16)
    out = tl.bce_loss(p, t)
    assert out.dtype == torch.float32
    assert abs(float(out) - float(-np.log(np.float32(0.25)))) < 1e-6
