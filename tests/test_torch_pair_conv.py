"""Kernel K3's plain version (unet_research_tpu_torch/ops/cuda/pair_conv.py)
against the JAX pair-view conv run in interpret mode, as
tests/test_pair_conv.py runs it. float32; y atol 1e-4, sums rtol 1e-4 (the
two sum in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_research_tpu.ops.pallas.pair_conv import conv3x3_pair as jax_conv3x3_pair
from unet_research_tpu_torch.ops.cuda import pair_conv as tpc


@pytest.mark.parametrize("shape,f", [((2, 16, 12, 5), 4), ((1, 24, 20, 8), 8),
                                     ((1, 20, 16, 1), 8), ((1, 22, 12, 8), 4)])
def test_plain_matches_jax_interpret(rng, shape, f):
    x = rng.standard_normal(shape).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, shape[-1], f))).astype(np.float32)
    jy, js1, js2 = jax_conv3x3_pair(jnp.asarray(x), jnp.asarray(k), stats=True,
                                    interpret=True)
    y, s1, s2 = tpc.conv3x3_pair(torch.from_numpy(x), torch.from_numpy(k), stats=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4)
    np.testing.assert_allclose(s1.numpy(), np.asarray(js1), rtol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-4)


def test_cpu_wrapper_takes_the_plain_version(rng):
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 3)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 3, 3, 2)).astype(np.float32))
    before = tpc.conv3x3_pair.launches
    y = tpc.conv3x3_pair(x, k)
    assert torch.equal(y, tpc.conv3x3_pair_plain(x, k))
    assert y.shape == (1, 8, 8, 2) and y.is_contiguous()
    assert tpc.conv3x3_pair.launches == before


def test_kernel_shape_mismatch_raises():
    with pytest.raises(ValueError):
        tpc.conv3x3_pair(torch.zeros((1, 8, 8, 3)), torch.zeros((3, 3, 4, 2)))
