"""Train state: the model's parameters, SGD with momentum and optional
global-norm clipping, the step count (twin of unet_research_tpu/train/state.py).

The update equals the JAX package's optax.chain(clip_by_global_norm,
sgd(momentum)) with an injected learning rate:

- clipping: g if ||g|| < max_norm, else g / ||g|| * max_norm, over all
  gradients at once (written here: torch.nn.utils.clip_grad_norm_ divides
  by ||g|| + 1e-6, another function);
- momentum: v = g + mu * v (v starts at 0), p -= lr * v, the rule of
  torch.optim.SGD with dampening 0 and nesterov off, written out below.

The learning rate is set before every step, so the plateau schedule and
the LR finder change it between steps. `step` counts the updates; the
DropBlock ramp reads it. Parameters are updated in place.

The update is written so that a CUDA graph can capture it (the trainer's
scanned epochs): the learning rate is a float32 tensor on the device
(`lr_tensor`), read by the kernels; the gradients are allocated when the
state is built and zeroed in place after each update; the momentum buffers
v exist from the start, as zeros (torch's first step would clone g into v,
and g + mu * 0 = g is the same number). It writes p - (lr * v), which is
optax's p + (-lr * v). The optimizer object holds the hyper-parameters and the
buffers in torch.optim.SGD's format, which checkpoints store; its step() is
not called.

Under a mesh (parallel/mesh.py) each rank's gradients are its share of the
global batch's; one all-reduce of one flat buffer sums them before the
clip, so the clip and the momentum run alike on every rank and the
parameters stay identical across ranks (JAX's gradient psum).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from unet_research_tpu_torch.parallel.mesh import all_reduce_grads_


def clip_by_global_norm(grads: list, max_norm: float) -> None:
    """optax.clip_by_global_norm on a list of gradient tensors, in place,
    without a host synchronisation."""
    if not grads:
        return
    norm = torch.sqrt(sum(g.to(torch.float32).square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


class TrainState:
    """Parameters (the model's), optimizer (SGD + momentum) and step."""

    def __init__(self, model: torch.nn.Module, lr: float, momentum: float = 0.99,
                 clip_norm: Optional[float] = None, mesh=None):
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.clip_norm = clip_norm
        self.mesh = mesh
        self.optimizer = torch.optim.SGD(self.params, lr=lr, momentum=momentum,
                                         dampening=0.0, nesterov=False)
        self.lr_tensor = torch.zeros((), dtype=torch.float32, device=self.params[0].device)
        self.set_lr(lr)
        self.init_momentum_buffers()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.step = 0

    def init_momentum_buffers(self) -> None:
        """Zero momentum buffers for the parameters that have none (all of
        them at the start; a loaded optimizer state brings its own)."""
        for p in self.params:
            state = self.optimizer.state[p]
            if state.get("momentum_buffer") is None:
                state["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.lr_tensor.fill_(lr)

    @torch.no_grad()
    def apply_gradients(self, lr: Optional[float] = None) -> None:
        """One update from the gradients in the parameters' .grad, then the
        gradients zeroed in place. lr: set first (set_lr); None takes
        `lr_tensor` as it stands, which a captured step reads at each
        replay. No host synchronisation and, without a mesh, no allocation
        that outlives the call."""
        if lr is not None:
            self.set_lr(lr)
        grads = [p.grad for p in self.params]
        if self.mesh is not None:
            all_reduce_grads_(grads, self.mesh)
        if self.clip_norm is not None:
            clip_by_global_norm(grads, self.clip_norm)
        bufs = self.momentum_buffers()
        torch._foreach_mul_(bufs, self.optimizer.param_groups[0]["momentum"])
        torch._foreach_add_(bufs, grads)
        torch._foreach_sub_(self.params, torch._foreach_mul(bufs, self.lr_tensor))
        torch._foreach_zero_(grads)
        self.step += 1

    def momentum_buffers(self) -> list:
        """The optimizer's trace v per parameter."""
        return [self.optimizer.state.get(p, {}).get("momentum_buffer") for p in self.params]


def make_optimizer(lr: float, momentum: float = 0.99, clip_norm: Optional[float] = None):
    """The update rule with its hyper-parameters (JAX make_optimizer's
    optax chain with an injected learning rate). Calling the result on a
    model, as JAX's tx.init on the params, gives the TrainState that applies
    it; `mesh` passes through."""
    return functools.partial(TrainState, lr=lr, momentum=momentum, clip_norm=clip_norm)


def create_train_state(model: torch.nn.Module, lr: float, momentum: float = 0.99,
                       clip_norm: Optional[float] = None, mesh=None) -> TrainState:
    """A TrainState at step 0 over the model's parameters (JAX
    create_train_state; BatchNorm's statistics live in the model's
    buffers, where JAX passes them as batch_stats)."""
    return make_optimizer(lr, momentum, clip_norm)(model, mesh=mesh)


def get_lr(state: TrainState) -> float:
    """The state's learning rate (JAX get_lr on its opt_state)."""
    return state.lr


def set_lr(state: TrainState, lr: float) -> TrainState:
    """The state with its learning rate set to lr, in place (JAX set_lr
    returns a new opt_state)."""
    state.set_lr(lr)
    return state
