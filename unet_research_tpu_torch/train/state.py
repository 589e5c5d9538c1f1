"""Train state: the model's parameters, SGD with momentum and optional
global-norm clipping, the step count (twin of unet_research_tpu/train/state.py).

The update equals the JAX package's optax.chain(clip_by_global_norm,
sgd(momentum)) with an injected learning rate:

- clipping: g if ||g|| < max_norm, else g / ||g|| * max_norm, over all
  gradients at once (written here: torch.nn.utils.clip_grad_norm_ divides
  by ||g|| + 1e-6, another function);
- momentum: v = g + mu * v (v starts at 0), p -= lr * v: torch.optim.SGD
  with dampening 0 and nesterov off does exactly this.

The learning rate is set before every step, so the plateau schedule and
the LR finder change it between steps. `step` counts the updates; the
DropBlock ramp reads it. Parameters are updated in place.

Under a mesh (parallel/mesh.py) each rank's gradients are its share of the
global batch's; one all-reduce of one flat buffer sums them before the
clip, so the clip and the momentum run alike on every rank and the
parameters stay identical across ranks (JAX's gradient psum).
"""

from __future__ import annotations

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
        self.step = 0

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    def apply_gradients(self, lr: float) -> None:
        """One update from the gradients in the parameters' .grad, at `lr`."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.mesh is not None:
            all_reduce_grads_(grads, self.mesh)
        if self.clip_norm is not None:
            clip_by_global_norm(grads, self.clip_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    def momentum_buffers(self) -> list:
        """The optimizer's trace v per parameter (None before a first step)."""
        return [self.optimizer.state.get(p, {}).get("momentum_buffer") for p in self.params]
