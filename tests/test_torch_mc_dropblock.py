"""The port's streaming ensemble and MC-DropBlock engine
(unet_research_tpu_torch/uncertainty/) against a direct torch reduction and
the JAX `streaming_ensemble_batched` on the same member table. rtol 1e-5
(float32 Chan merge against a one-shot reduction)."""

import jax
import numpy as np
import pytest
import torch

from unet_research_tpu.uncertainty.ensemble import (
    streaming_ensemble_batched as jax_streaming_ensemble_batched,
)
from unet_research_tpu_torch.models.unet import UNet, canonical_config
from unet_research_tpu_torch.uncertainty.ensemble import streaming_ensemble_batched
from unet_research_tpu_torch.uncertainty.mc_dropblock import MCDropBlockEngine


def _table_fn(table):
    """batch_fn handing out the next `size` rows of a member table."""
    pos = 0

    def batch_fn(size):
        nonlocal pos
        out = torch.from_numpy(table[pos:pos + size])
        pos += size
        return out

    return batch_fn


@pytest.mark.parametrize("total,chunk,return_num", [(11, 4, 3), (9, 3, 0), (12, 5, 12), (2, 8, 1)])
def test_matches_direct_reduction(rng, total, chunk, return_num):
    table = rng.standard_normal((total, 6, 5, 1)).astype(np.float32)
    mean, std, saved = streaming_ensemble_batched(_table_fn(table), total, chunk, return_num)
    ref = torch.from_numpy(table)
    torch.testing.assert_close(mean, ref.mean(0), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(std, ref.std(0, unbiased=True), rtol=1e-5, atol=1e-6)
    assert torch.equal(saved, ref[:return_num])


@pytest.mark.parametrize("total,chunk,return_num", [(11, 4, 3), (10, 3, 0), (7, 2, 2)])
def test_matches_jax_streaming(total, chunk, return_num):
    """The same members in the same chunk order: JAX draws chunk kidx from
    fold_in(key, kidx); the port reads the same rows from a table."""
    key = jax.random.PRNGKey(3)
    sizes = [return_num] if return_num else []
    rest = total - return_num
    sizes += [chunk] * (rest // chunk) + ([rest % chunk] if rest % chunk else [])
    table = np.concatenate([np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (s, 4, 3)))
                            for i, s in enumerate(sizes)])

    def jax_batch(k, size):
        return jax.random.uniform(k, (size, 4, 3))

    jmean, jstd, jsaved = jax_streaming_ensemble_batched(jax_batch, key, total, chunk, return_num)
    mean, std, saved = streaming_ensemble_batched(_table_fn(table), total, chunk, return_num)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=1e-5)
    np.testing.assert_allclose(saved.numpy(), np.asarray(jsaved), rtol=1e-5)


def test_needs_two_members():
    with pytest.raises(ValueError):
        streaming_ensemble_batched(lambda s: torch.zeros((s, 2)), 1, 4, 0)


def _engine(resize=-1, seed=0):
    cfg = canonical_config(filters=4, model_depth=2, group_norm_groups=2)
    model = UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    return MCDropBlockEngine(model, num_iterations=7, return_num=2, resize=resize, chunk=3,
                             device="cpu", generator=torch.Generator().manual_seed(seed))


def _image(rng, h=20, w=18):
    im = rng.random((1, h, w, 1)).astype(np.float32)
    gt = (rng.random((1, h, w, 1)) > 0.5).astype(np.float32)
    mask = np.ones((1, h, w, 1), np.float32)
    mask[:, :3] = 0.0
    return im, gt, mask


def test_engine_shapes_and_saved_layout(rng):
    im, gt, mask = _image(rng)
    mean, std, saved, im_t, gt_t, mask_t = _engine().predict(im, gt, mask, 0.15)
    assert mean.shape == std.shape == (1, 20, 18, 1)
    assert saved.shape == (2, 1, 20, 18, 1)
    assert float(std.max()) > 0 and bool(torch.isfinite(std).all())
    assert float(saved[:, :, :3].abs().max()) == 0.0  # seg * mask
    assert float(mean.min()) >= 0.0 and float(mean.max()) <= 1.0
    assert torch.equal(im_t, torch.from_numpy(im))


def test_engine_is_reproducible_and_keyed(rng):
    im, gt, mask = _image(rng)
    a = _engine(seed=5).predict(im, gt, mask, 0.15)[0]
    b = _engine(seed=5).predict(im, gt, mask, 0.15)[0]
    c = _engine(seed=6).predict(im, gt, mask, 0.15)[0]
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_engine_resize(rng):
    im, gt, mask = _image(rng, 22, 17)
    mean, std, saved, im_t, gt_t, mask_t = _engine(resize=16).predict(im, gt, mask, 0.1)
    assert mean.shape == (1, 16, 16, 1) and saved.shape == (2, 1, 16, 16, 1)
    assert im_t.shape == gt_t.shape == mask_t.shape == (1, 16, 16, 1)
