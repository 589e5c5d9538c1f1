"""The port's rotational TTA engine (unet_research_tpu_torch/uncertainty/
rotational.py) and streaming_ensemble against the JAX package.

The engine runs on JAX-initialised weights converted by
utils/convert.py::jax_params_to_state_dict, float32, on the same image,
under both warps (the JAX shear warp's Pallas kernel in interpret mode).
Tolerances: mean and saved atol 1e-4, std atol 2e-4 (two warps around the
model, each within ~1.4e-5 of JAX, and the model within 1e-5; std is the
spread of those members). streaming_ensemble: rtol 1e-5 against a direct
reduction and against JAX streaming_ensemble(chunk_fn=True) on one table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unet_research_tpu.models.unet as junet
from unet_research_tpu.uncertainty import RotationalEngine as JaxRotationalEngine
from unet_research_tpu.uncertainty import streaming_ensemble as jax_streaming_ensemble
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.uncertainty import RotationalEngine
from unet_research_tpu_torch.uncertainty.ensemble import streaming_ensemble
from unet_research_tpu_torch.utils.convert import jax_params_to_state_dict

SMALL = dict(filters=8, model_depth=2, group_norm_groups=4)


@pytest.fixture(scope="module")
def models():
    jcfg = junet.canonical_config(dropblock=junet.DropBlockConfig(kind=None), **SMALL)
    jmodel = junet.UNet(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    tcfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(kind=None), **SMALL)
    model = tunet.UNet(tcfg, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(variables, jcfg))
    return jmodel, variables["params"], model.eval()


def _image(seed, h=32, w=32):
    rng = np.random.default_rng(seed)
    im = rng.random((1, h, w, 1), dtype=np.float32)
    gt = (rng.random((1, h, w, 1)) > 0.8).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    fov = ((yy - (h - 1) / 2) ** 2 + (xx - (w - 1) / 2) ** 2 <= (min(h, w) / 2) ** 2)
    return im, gt, fov.astype(np.float32)[None, :, :, None]


@pytest.mark.parametrize("warp,iters", [("gather", 12), ("shear", 12), ("shear", 46)])
def test_engine_matches_jax(models, warp, iters):
    jmodel, params, model = models
    im, gt, mask = _image(iters)
    jengine = JaxRotationalEngine(jmodel, num_iterations=iters, return_num=2, chunk=4, warp=warp)
    jmean, jstd, jsaved, *_ = jengine.predict(params, jnp.asarray(im), jnp.asarray(gt),
                                              jnp.asarray(mask))
    engine = RotationalEngine(model, num_iterations=iters, return_num=2, chunk=4, warp=warp,
                              device="cpu")
    mean, std, saved, im_t, gt_t, mask_t = engine.predict(im, gt, mask)
    assert mean.shape == std.shape == (1, 32, 32, 1) and saved.shape == (2, 1, 32, 32, 1)
    assert float(std.max()) > 0
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=1e-4)
    np.testing.assert_allclose(saved.numpy(), np.asarray(jsaved), rtol=0, atol=1e-4)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=0, atol=2e-4)
    assert torch.equal(im_t, torch.from_numpy(im)) and torch.equal(mask_t, torch.from_numpy(mask))


def test_engine_resize(models):
    model = models[2]
    im, gt, mask = _image(5, 30, 21)
    engine = RotationalEngine(model, num_iterations=5, return_num=2, resize=24, chunk=2,
                              warp="shear", device="cpu")
    mean, std, saved, im_t, gt_t, mask_t = engine.predict(im, gt, mask)
    assert mean.shape == std.shape == (1, 24, 24, 1) and saved.shape == (2, 1, 24, 24, 1)
    assert im_t.shape == gt_t.shape == mask_t.shape == (1, 24, 24, 1)
    assert bool(torch.isfinite(std).all())


def test_unknown_warp_raises(models):
    with pytest.raises(ValueError, match="warp"):
        RotationalEngine(models[2], warp="nearest", device="cpu")


def _rows_fn(table):
    """chunk_fn reading the members' rows of a table by their indices."""
    return lambda idx: torch.from_numpy(table[idx.numpy()])


@pytest.mark.parametrize("total,chunk,return_num", [(11, 4, 3), (9, 3, 0), (12, 5, 12), (2, 8, 1)])
def test_streaming_ensemble_matches_direct(rng, total, chunk, return_num):
    table = rng.standard_normal((total, 6, 5, 1)).astype(np.float32)
    mean, std, saved = streaming_ensemble(_rows_fn(table), torch.arange(total), chunk, return_num,
                                          chunk_fn=True)
    ref = torch.from_numpy(table)
    torch.testing.assert_close(mean, ref.mean(0), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(std, ref.std(0, unbiased=True), rtol=1e-5, atol=1e-6)
    assert torch.equal(saved, ref[:return_num])


@pytest.mark.parametrize("total,chunk,return_num", [(11, 4, 3), (10, 3, 0), (23, 5, 4)])
def test_streaming_ensemble_matches_jax(rng, total, chunk, return_num):
    """The same members and chunk boundaries: both sides index one table."""
    table = rng.random((total, 4, 3), dtype=np.float32)
    jtable = jnp.asarray(table)
    jmean, jstd, jsaved = jax_streaming_ensemble(lambda idx: jtable[idx], jnp.arange(total),
                                                 chunk, return_num, chunk_fn=True)
    mean, std, saved = streaming_ensemble(_rows_fn(table), torch.arange(total), chunk, return_num,
                                          chunk_fn=True)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=1e-5)
    np.testing.assert_allclose(saved.numpy(), np.asarray(jsaved), rtol=1e-5)


def test_streaming_ensemble_chunk_order():
    """Each call gets the next slice of xs: return_num, full chunks, rest."""
    seen = []

    def chunk_fn(idx):
        seen.append(idx.tolist())
        return idx.to(torch.float32)[:, None]

    streaming_ensemble(chunk_fn, torch.arange(12), 4, 3, chunk_fn=True)
    assert seen == [[0, 1, 2], [3, 4, 5, 6], [7, 8, 9, 10], [11]]
