"""The port's streaming ensemble and MC-DropBlock engine
(unet_research_tpu_torch/uncertainty/) against a direct torch reduction and
the JAX `streaming_ensemble_batched` on the same member table. rtol 1e-5
(float32 Chan merge against a one-shot reduction). The two MC engines end
to end on the same per-chunk site keys: 1e-5 in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unet_research_tpu.models.unet as junet
from unet_research_tpu.uncertainty.ensemble import (
    streaming_ensemble_batched as jax_streaming_ensemble_batched,
)
from unet_research_tpu.uncertainty.mc_dropblock import MCDropBlockEngine as JaxMCDropBlockEngine
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.models.unet import UNet, canonical_config
from unet_research_tpu_torch.uncertainty import mc_dropblock
from unet_research_tpu_torch.uncertainty.ensemble import streaming_ensemble_batched
from unet_research_tpu_torch.uncertainty.mc_dropblock import MCDropBlockEngine
from unet_research_tpu_torch.utils.convert import jax_params_to_state_dict


def _table_fn(table):
    """batch_fn handing out the next `size` rows of a member table (it draws
    nothing from the generator)."""
    pos = 0

    def batch_fn(generator, size):
        nonlocal pos
        out = torch.from_numpy(table[pos:pos + size])
        pos += size
        return out

    return batch_fn


@pytest.mark.parametrize("total,chunk,return_num", [(11, 4, 3), (9, 3, 0), (12, 5, 12), (2, 8, 1)])
def test_matches_direct_reduction(rng, total, chunk, return_num):
    table = rng.standard_normal((total, 6, 5, 1)).astype(np.float32)
    mean, std, saved = streaming_ensemble_batched(_table_fn(table), torch.Generator(), total,
                                                  chunk, return_num)
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
    mean, std, saved = streaming_ensemble_batched(_table_fn(table), torch.Generator(), total,
                                                  chunk, return_num)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=1e-5)
    np.testing.assert_allclose(saved.numpy(), np.asarray(jsaved), rtol=1e-5)


def test_needs_two_members():
    with pytest.raises(ValueError):
        streaming_ensemble_batched(lambda g, s: torch.zeros((s, 2)), torch.Generator(), 1, 4, 0)


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


@pytest.mark.parametrize("kind,resize", [("dependent", -1), ("independent", 16)])
def test_engine_matches_jax_engine_on_its_chunk_keys(monkeypatch, rng, kind, resize):
    """The JAX engine folds the chunk index into its key and each mask site
    draws from that (uncertainty/ensemble.py:131-157). A spy records the key
    of every site call of an unjitted run (inside jit it would see tracers);
    the port's engine draws the same keys, chunk by chunk, through its
    draw_site_keys seam. 7 members, 2 saved, chunk 3: chunks of 2, 3, 2."""
    small = dict(filters=4, model_depth=2, group_norm_groups=2)
    jcfg = junet.canonical_config(dropblock=junet.DropBlockConfig(kind=kind, block_size=3), **small)
    tcfg = tunet.canonical_config(
        dropblock=tunet.DropBlockConfig(kind=kind, block_size=3, mask_impl="fused"), **small)
    im, gt, mask = _image(rng, 20, 18)
    variables = junet.UNet(jcfg).init(jax.random.PRNGKey(2), jnp.asarray(im))
    model = UNet(tcfg, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(variables, jcfg))

    calls = []
    for name in ("dropblock_dependent", "dropblock_independent"):
        real = getattr(junet, name)

        def spy(x_, key, *a, _real=real, **k):
            calls.append(np.asarray(jax.random.key_data(key)).reshape(-1).astype(np.int64))
            return _real(x_, key, *a, **k)

        monkeypatch.setattr(junet, name, spy)
    engine = JaxMCDropBlockEngine(junet.UNet(jcfg), num_iterations=7, return_num=2,
                                  resize=resize, chunk=3)
    with jax.disable_jit():
        ref = engine.predict(variables["params"], im, gt, mask, jax.random.PRNGKey(9), 0.15)
    sites = model.num_mask_sites()
    assert len(calls) == 3 * sites
    chunk_keys = iter(torch.from_numpy(np.stack(calls)).split(sites))
    monkeypatch.setattr(mc_dropblock, "draw_site_keys", lambda n, generator: next(chunk_keys))
    got = MCDropBlockEngine(model, num_iterations=7, return_num=2, resize=resize, chunk=3,
                            device="cpu").predict(im, gt, mask, 0.15)
    for name, a, b in zip(("mean", "std", "saved"), got[:3], ref[:3]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)
    assert float(got[1].max()) > 0.01  # the masks differ between members


def test_predict_takes_a_generator(rng):
    """A call's generator decides its masks; the engine's own is left alone."""
    im, gt, mask = _image(rng)
    engine = _engine(seed=5)
    a = engine.predict(im, gt, mask, 0.15, generator=torch.Generator().manual_seed(8))[0]
    b = engine.predict(im, gt, mask, 0.15, generator=torch.Generator().manual_seed(8))[0]
    c = engine.predict(im, gt, mask, 0.15)[0]
    assert torch.equal(a, b)
    assert torch.equal(c, _engine(seed=5).predict(im, gt, mask, 0.15)[0])
