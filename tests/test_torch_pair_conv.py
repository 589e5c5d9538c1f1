"""Kernel K3's plain version (unet_research_tpu_torch/ops/cuda/pair_conv.py)
against the JAX pair-view conv run in interpret mode, as
tests/test_pair_conv.py runs it. float32; y atol 1e-4, sums rtol 1e-4 (the
two sum in different orders). Gradients (the autograd Function against the
JAX custom VJP, with cotangents on the sums): rtol 2e-4, atol 2e-5 for dx
and 2e-4 for dK, the limits of tests/test_pair_conv.py. The backward's one dx
call (dx and the folded g) against the JAX `_pair_vjp_bwd`: 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_research_tpu.ops.pallas.pair_conv import conv3x3_pair as jax_conv3x3_pair
from unet_research_tpu.ops.pallas.pair_conv import _pair_vjp_bwd as _jax_pair_vjp_bwd
from unet_research_tpu.ops.pallas.pair_conv import conv3x3_pair_valid as jax_conv3x3_pair_valid
from unet_research_tpu_torch.ops.cuda import pair_conv as tpc


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here, and the suite runs
    several test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _grad_inputs(rng, shape, f):
    x = rng.standard_normal(shape).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, shape[-1], f))).astype(np.float32)
    w = rng.standard_normal(shape[:3] + (f,)).astype(np.float32)
    return x, k, w


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("shape,f", [((2, 16, 12, 8), 4), ((1, 10, 14, 5), 6)])
def test_grads_match_jax_vjp_interpret(rng, stats, shape, f):
    """dx and dK of the port's Function equal jax.grad through the JAX
    conv3x3_pair's custom VJP (interpret mode), the sums' cotangents ds1 =
    cos(s1) and ds2 = 1e-2 folded in when stats are on."""
    x, k, w = _grad_inputs(rng, shape, f)

    def jloss(x, k):
        if stats:
            y, s1, s2 = jax_conv3x3_pair(x, k, stats=True, interpret=True)
            return jnp.sum(y * w) + jnp.sum(jnp.sin(s1)) + jnp.sum(s2 * 1e-2)
        return jnp.sum(jax_conv3x3_pair(x, k, interpret=True) * w)

    jdx, jdk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    tw = torch.from_numpy(w)
    if stats:
        y, s1, s2 = tpc.conv3x3_pair(tx, tk, stats=True)
        loss = (y * tw).sum() + torch.sin(s1).sum() + (s2 * 1e-2).sum()
    else:
        loss = (tpc.conv3x3_pair(tx, tk) * tw).sum()
    loss.backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jdk), rtol=2e-4, atol=2e-4)


def test_backward_runs_dx_through_conv3x3_pair(rng, monkeypatch):
    """The backward makes exactly one dx call, `conv3x3_pair_dx` (one K3
    launch on the card, which reads the kernel as rot_transpose(K)), hands
    it the sums' cotangents to fold (only they reach the Function here: dy
    is None), and takes dK from the g that call returned."""
    x, k, _ = _grad_inputs(rng, (1, 8, 6, 3), 4)
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    marker = torch.from_numpy(rng.standard_normal((1, 8, 6, 4)).astype(np.float32))
    calls, returned = [], []
    real = tpc.conv3x3_pair_dx

    def spy(dy, kernel, *fold):
        calls.append((dy.clone(), kernel.clone(), [t.clone() for t in fold],
                      torch.is_grad_enabled()))
        dx, g = real(dy, kernel, *fold)
        returned.append(g + marker)
        return dx, returned[-1]

    _, s1, s2 = tpc.conv3x3_pair(tx, tk, stats=True)
    monkeypatch.setattr(tpc, "conv3x3_pair_dx", spy)
    (s1.sum() + s2.sum()).backward()
    assert len(calls) == 1
    dy, kernel, fold, grad_mode = calls[0]
    assert not grad_mode and torch.equal(kernel, tk.detach()) and len(fold) == 3
    assert torch.equal(dy, torch.zeros((1, 8, 6, 4)))
    y = tpc.conv3x3_pair_plain(torch.from_numpy(x), torch.from_numpy(k))
    assert torch.equal(fold[0], y)
    assert torch.equal(fold[1], torch.ones((1, 4))) and torch.equal(fold[2], torch.ones((1, 4)))
    expect = torch.from_numpy(np.ascontiguousarray(np.transpose(k[::-1, ::-1], (0, 1, 3, 2))))
    assert torch.equal(tpc.rot_transpose(tk), expect)
    # the dx of sum(s1) + sum(s2) = sum(y) + sum(y^2): conv of (1 + 2y)
    ref = tpc.conv3x3_pair_plain((1.0 + 2.0 * y).contiguous(), expect)
    torch.testing.assert_close(tx.grad, ref, atol=1e-5, rtol=1e-5)
    # dK is the correlation of x with the g the dx call returned
    dk = torch.nn.grad.conv2d_weight(torch.from_numpy(x).permute(0, 3, 1, 2), (4, 3, 3, 3),
                                     returned[0].permute(0, 3, 1, 2), padding=1)
    torch.testing.assert_close(tk.grad, dk.permute(2, 3, 1, 0), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,f", [((2, 16, 12, 8), 8), ((1, 11, 9, 5), 6),
                                     ((2, 13, 10, 8), 8)])
def test_dx_fold_matches_jax_pair_vjp_bwd(rng, shape, f):
    """conv3x3_pair_dx with the sums' cotangents (the port's one dx call of
    the backward) against the JAX `_pair_vjp_bwd` in interpret mode on the
    same inputs, stats on, nonzero ds1/ds2: dx and the folded g (the JAX
    expression) float32 to 1e-5; dK taken from that g to the 2e-4 of the
    gradient tests above (a sum over N*H*W in another order). The first
    shape takes the JAX Pallas dx kernel, the odd ones its XLA conv."""
    x, k, dy = _grad_inputs(rng, shape, f)
    y = rng.standard_normal(shape[:3] + (f,)).astype(np.float32)
    ds1 = rng.standard_normal((shape[0], f)).astype(np.float32)
    ds2 = rng.standard_normal((shape[0], f)).astype(np.float32)
    jx, jk, jy, jdy = (jnp.asarray(a) for a in (x, k, y, dy))
    jds1, jds2 = jnp.asarray(ds1), jnp.asarray(ds2)
    jdx, jdk = _jax_pair_vjp_bwd(True, 8, True, (jx, jk, jy), (jdy, jds1, jds2))
    jg = jdy + jds1[:, None, None, :] + 2.0 * jy * jds2[:, None, None, :]
    dx, g = tpc.conv3x3_pair_dx(*(torch.from_numpy(a) for a in (dy, k, y, ds1, ds2)))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    dk = torch.nn.grad.conv2d_weight(torch.from_numpy(x).permute(0, 3, 1, 2),
                                     (f, shape[-1], 3, 3), g.permute(0, 3, 1, 2), padding=1)
    np.testing.assert_allclose(dk.permute(2, 3, 1, 0).numpy(), np.asarray(jdk),
                               rtol=2e-4, atol=2e-4)


def test_kernel_gradient_only_when_asked(rng):
    x, k, _ = _grad_inputs(rng, (1, 6, 6, 2), 2)
    tx = torch.from_numpy(x)
    tk = torch.from_numpy(k).requires_grad_()
    tpc.conv3x3_pair(tx, tk).sum().backward()
    assert tk.grad is not None and tk.grad.shape == tk.shape and tx.grad is None


@pytest.mark.parametrize("shape,f", [((2, 16, 12, 8), 4), ((1, 11, 9, 3), 5)])
def test_valid_matches_jax_in_value_and_gradient(rng, shape, f):
    x, k, _ = _grad_inputs(rng, shape, f)
    w = rng.standard_normal((shape[0], shape[1] - 2, shape[2] - 2, f)).astype(np.float32)
    if shape[2] % 2 == 0:  # the JAX pair kernel needs even W
        jy = jax_conv3x3_pair_valid(jnp.asarray(x), jnp.asarray(k), interpret=True)
        jdx, jdk = jax.grad(
            lambda x, k: jnp.sum(jax_conv3x3_pair_valid(x, k, interpret=True) * w),
            argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    else:  # odd W: the XLA VALID conv the JAX model takes there
        def conv(x, k):
            return jax.lax.conv_general_dilated(x, k, (1, 1), "VALID",
                                                dimension_numbers=("NHWC", "HWIO", "NHWC"))
        jy = conv(jnp.asarray(x), jnp.asarray(k))
        jdx, jdk = jax.grad(lambda x, k: jnp.sum(conv(x, k) * w), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(k))
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    y = tpc.conv3x3_pair_valid(tx, tk)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-4)
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jdk), rtol=2e-4, atol=2e-4)
