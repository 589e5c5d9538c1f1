"""The port's DropBlock (unet_research_tpu_torch/ops/dropblock.py and the plain
versions of kernels K1/K2) against the JAX package on the same numpy inputs
and the same key words.

Tolerances: masks and keep counts exact (same counter hash, same gamma in
float32); values rtol 1e-6 (float32, one multiply per element); the fused
plain version atol 1e-6 (float32 GroupNorm apply)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_research_tpu.models.unet import group_norm_coeffs as jax_gn_coeffs
from unet_research_tpu.ops import dropblock as jdb
from unet_research_tpu_torch.ops import dropblock as tdb
from unet_research_tpu_torch.ops.cuda import dropblock_kernel as tk


def _key(seed):
    key = jax.random.PRNGKey(seed)
    words = torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(np.int64))
    return key, words


@pytest.mark.parametrize("seed,shape", [(0, (2, 5, 7, 3)), (1234, (1, 33, 17, 4)),
                                        (2**31 + 5, (3, 8, 8, 1))])
def test_hash_uniform_bit_exact(seed, shape):
    key, words = _key(seed)
    ref = np.asarray(jdb._hash_uniform(key, shape))
    ours = tdb.hash_uniform(words, shape).numpy()
    np.testing.assert_array_equal(ours, ref)


def test_hash_uniform_high_key_words():
    # key words with the top bit set exercise the 32-bit wrap of the xors
    words = np.array([0xFFFFFFF0, 0x80000001], dtype=np.uint32)
    key = jax.random.wrap_key_data(jnp.asarray(words))
    ref = np.asarray(jdb._hash_uniform(key, (2, 9, 11, 3)))
    ours = tdb.hash_uniform(torch.from_numpy(words.astype(np.int64)), (2, 9, 11, 3)).numpy()
    np.testing.assert_array_equal(ours, ref)


CASES = [("dependent", 5), ("dependent", 3), ("dependent", 4), ("independent", 5)]


@pytest.mark.parametrize("variant,b", CASES)
@pytest.mark.parametrize("rescale", ["apply", "defer", "skip"])
@pytest.mark.parametrize("impl", ["elementwise", "kernel"])
def test_dropblock_matches_jax(variant, b, rescale, impl):
    rng = np.random.default_rng(7)
    x = rng.uniform(0.5, 1.5, (2, 20, 18, 5)).astype(np.float32)
    key, words = _key(11)
    jfn = jdb.dropblock_dependent if variant == "dependent" else jdb.dropblock_independent
    tfn = tdb.dropblock_dependent if variant == "dependent" else tdb.dropblock_independent
    ref = jfn(jnp.asarray(x), key, 0.3, b, mask_impl="elementwise", rescale=rescale)
    ours = tfn(torch.from_numpy(x), words, 0.3, b, mask_impl=impl, rescale=rescale)
    if rescale == "defer":
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), rtol=1e-6)
        ref, ours = ref[0], ours[0]
    ref, ours = np.asarray(ref), ours.numpy()
    np.testing.assert_array_equal(ours == 0, ref == 0)
    assert (ref == 0).any() and (ref != 0).any()
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def _assert_keep_matches_scale(keep, jscale, numel):
    """Exact keep counts against the JAX defer scale numel/keep (the
    division itself may differ by an ulp under XLA)."""
    jscale = np.asarray(jscale)
    np.testing.assert_array_equal(keep.numpy(), np.round(numel / jscale))
    np.testing.assert_allclose((float(numel) / keep).numpy(), jscale, rtol=1e-6)


@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
def test_fused_plain_matches_jax_gn_dropblock_act(act):
    """K1's plain version against JAX group_norm_affine -> dropblock_dependent
    (rescale='skip') -> activation; keep counts against the JAX defer scale."""
    from unet_research_tpu.models.unet import group_norm_affine

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 24, 20, 8)).astype(np.float32)
    scale = jnp.asarray(rng.uniform(0.5, 1.5, 8).astype(np.float32))
    bias = jnp.asarray(rng.uniform(-0.5, 0.5, 8).astype(np.float32))
    ab = np.stack([np.asarray(v) for v in jax_gn_coeffs(jnp.asarray(x), scale, bias, 4, 1e-5)])
    key, words = _key(21)
    h, w, c = x.shape[1:]
    p, b = 0.2, 5
    gamma = jdb.dropblock_gamma_dependent(h, w, b, p)
    y = group_norm_affine(jnp.asarray(x), scale, bias, 4, 1e-5, jnp.float32)
    masked, jscale = jdb.dropblock_dependent(y, key, p, b, mask_impl="elementwise",
                                             rescale="defer")
    ref = np.asarray(jax.nn.relu(masked) if act == "relu"
                     else jax.nn.leaky_relu(masked, negative_slope=0.01))
    out, keep = tk.dropblock_fused_apply(torch.from_numpy(x), torch.from_numpy(ab), words,
                                         gamma, b, act=act, slope=0.01)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    _assert_keep_matches_scale(keep, jscale, h * w * c)


def test_fused_plain_bare_site_matches_jax():
    """The bare skip-merge form: no affine, no activation."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 16, 22, 6)).astype(np.float32)
    key, words = _key(4)
    h, w, c = x.shape[1:]
    gamma = jdb.dropblock_gamma_dependent(h, w, 7, 0.25)
    ref, jscale = jdb.dropblock_dependent(jnp.asarray(x), key, 0.25, 7,
                                          mask_impl="elementwise", rescale="defer")
    out, keep = tk.dropblock_fused_apply(torch.from_numpy(x), None, words, gamma, 7,
                                         act="none")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    _assert_keep_matches_scale(keep, jscale, h * w * c)


@pytest.mark.parametrize("b", [3, 7, 17])
def test_mask_plain_matches_jax_elementwise(b):
    key, words = _key(b)
    shape = (2, 40, 36, 3)
    gamma = jdb.dropblock_gamma_dependent(40, 36, b, 0.2)
    ref = np.asarray(jdb.dropblock_dependent(jnp.ones(shape), key, 0.2, b,
                                             mask_impl="elementwise", rescale="skip"))
    mask, keep = tk.dropblock_mask(shape, words, gamma, b)
    assert mask.dtype == torch.int8
    np.testing.assert_array_equal(mask.numpy(), ref.astype(np.int8))
    np.testing.assert_array_equal(keep.numpy(), ref.sum(axis=(1, 2, 3)))


@pytest.mark.parametrize("rows", [1, 2, 5])
@pytest.mark.parametrize("threshold", [False, True])
def test_masks_are_drawn_a_block_of_rows_at_a_time(monkeypatch, rows, threshold):
    """The plain mask hashes at most SEED_BLOCK counters per call (whole
    rows, at least one), so its int64 temporaries stay bounded whatever the
    batch (one call over a chunk of 16 at 592x576x64 ran a chunk of 32 out
    of the card's memory), and draws the same bits as in one call, also at
    a sample offset; JAX's elementwise mask is the reference."""
    shape, offset, b = (5, 20, 18, 3), 2, 7
    key, words = _key(rows)
    gamma = jdb.dropblock_gamma_dependent(20, 18, b, 0.3)
    thr = torch.tensor([tk.seed_threshold(gamma)], dtype=torch.int32) if threshold else None
    whole = tdb.dropped_blocks(shape, words, gamma, b, offset, thr)
    calls = []
    real = tdb._seeds

    def seeds(key_words, block, *args):
        calls.append(block[0])
        return real(key_words, block, *args)

    monkeypatch.setattr(tdb, "SEED_BLOCK", rows * 20 * 18 * 3 + 1)
    monkeypatch.setattr(tdb, "_seeds", seeds)
    blocked = tdb.dropped_blocks(shape, words, gamma, b, offset, thr)
    assert calls == [min(rows, 5 - r) for r in range(0, 5, rows)]
    assert torch.equal(blocked, whole)
    ref = np.asarray(jdb.dropblock_dependent(jnp.ones((offset + 5, 20, 18, 3)), key, 0.3, b,
                                             mask_impl="elementwise", rescale="skip"))
    np.testing.assert_array_equal(~whole.numpy(), ref[offset:].astype(bool))


def test_cpu_wrappers_take_the_plain_version():
    words = torch.tensor([1, 2], dtype=torch.int64)
    x = torch.ones((1, 12, 12, 2))
    before = (tk.dropblock_fused_apply.launches, tk.dropblock_mask.launches)
    out, keep = tk.dropblock_fused_apply(x, None, words, 0.05, 3, act="none")
    ref, ref_keep = tk.dropblock_fused_apply_plain(x, None, words, 0.05, 3, act="none")
    assert torch.equal(out, ref) and torch.equal(keep, ref_keep)
    tk.dropblock_mask(x.shape, words, 0.05, 3)
    assert (tk.dropblock_fused_apply.launches, tk.dropblock_mask.launches) == before


@pytest.mark.parametrize("gamma", [0.0, 2.0**-24, 3 * 2.0**-24, 0.0031, 0.15 / 49, 0.5, 1.0, 1.5])
def test_seed_threshold_matches_float_compare(gamma):
    """The kernels draw a seed where (bits >> 8) < seed_threshold(gamma);
    that is exactly the float32 test u < gamma of the plain version."""
    t = tk.seed_threshold(gamma)
    m = np.unique(np.clip(np.concatenate([np.arange(t - 3, t + 3),
                                          np.random.default_rng(0).integers(0, 1 << 24, 1000)]),
                          0, (1 << 24) - 1)).astype(np.int64)
    u = m.astype(np.float32) * np.float32(1.0 / (1 << 24))
    np.testing.assert_array_equal(m < t, u < np.float32(gamma))


@pytest.mark.parametrize("b", [4, 19, 1])
def test_kernel_wrappers_reject_unsupported_block_sizes(b):
    words = torch.tensor([1, 2], dtype=torch.int64)
    with pytest.raises(ValueError):
        tk.dropblock_mask((1, 24, 24, 2), words, 0.05, b)


def test_gamma_formulas_match_jax():
    expected = 0.15 * 40 * 50 / (49 * 34 * 44)
    assert abs(tdb.dropblock_gamma_dependent(40, 50, 7, 0.15) - expected) < 1e-12
    assert abs(tdb.dropblock_gamma_independent(40, 50, 7, 0.15) - expected) < 1e-12
    assert tdb.dropblock_gamma_independent(8, 8, 7, 50.0) == 1.0
    for args in [(40, 50, 7, 0.15), (24, 24, 3, 0.3), (8, 8, 7, 50.0)]:
        assert abs(tdb.dropblock_gamma_dependent(*args)
                   - float(jdb.dropblock_gamma_dependent(*args))) < 1e-12
        assert abs(tdb.dropblock_gamma_independent(*args)
                   - float(jdb.dropblock_gamma_independent(*args))) < 1e-6


@pytest.mark.parametrize("fn", [tdb.dropblock_dependent, tdb.dropblock_independent])
def test_identity_at_zero_prob(fn):
    x = torch.ones((2, 24, 24, 3)) * 1.5
    assert torch.equal(fn(x, torch.tensor([0, 0]), 0.0, 7), x)


@pytest.mark.parametrize("fn", [tdb.dropblock_dependent, tdb.dropblock_independent])
def test_drop_fraction_matches_target(fn):
    """With the paper gamma the dropped fraction is about drop_prob
    (the statistics of tests/test_dropblock.py:43-53)."""
    x = torch.ones((4, 64, 64, 8))
    out = fn(x, torch.tensor([42, 7]), 0.15, 7)
    dropped = float((out == 0).to(torch.float32).mean())
    assert abs(dropped - 0.15) < 0.04, dropped


@pytest.mark.parametrize("step", [0, 3, 10, 500, 900])
def test_linear_drop_prob_matches_jax(step):
    ref = float(jdb.linear_drop_prob(step, 0.0, 0.2, 500))
    assert abs(tdb.linear_drop_prob(step, 0.0, 0.2, 500) - ref) < 1e-7
    assert tdb.linear_drop_prob(step, 0.0, 0.2, 1) == 0.2
