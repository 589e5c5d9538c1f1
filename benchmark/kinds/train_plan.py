"""The "train_plan" kind: the "train" kind (kinds/train.py) under a
multi-fidelity size plan, as `mf_training` fits: the stepped epochs of
`Trainer._step_epoch` at batch 1 with the traffic's `policy` (the port's
ResizePolicy) and a plan drawn by `make_size_plan(policy, originals,
augmentations)` from a generator seeded from the run's seed, cycled or cut
to the frames as mf_training.size_plan_for does. The MF loader is
unshuffled: every epoch takes the frames in order, and step k of an epoch
runs at plan entry k (its size: -1 native, or a side the frame is resized
to).

Traffic keys: those of the train kind, with `policy`, `originals` and
`augmentations` in place of `check_steps`. Set-up's epoch, which the check
follows, runs the plan's sizes in the order they first come in it, one step
each, three times (a step of each size is checked; each size then has had
its two eager warm-up steps and its capture before the window, since the
step program captures one graph per size); the window's epochs run the
drawn plan. (The drawn plan's own first steps would reach its last size
after 73 to 361 steps, and bf16's distance from float32 grows with the
steps followed, so the check would read a seed's plan more than the
program.)

The reference runs the same steps through reference/resize.py (the
policy's square pad and bilinear resizes around reference/unet.py's
forward).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import cells
from benchmark.reference import resize, tasks, unet as ref

train = cells.kind("train")


class Cell(train):
    def inputs(self) -> None:
        from unet_research_tpu_torch.train import make_size_plan

        super().inputs()
        t = self.traffic
        rng = np.random.default_rng(cells.derive(self.seed, "plan"))
        plan = make_size_plan(t["policy"], t["originals"], t["augmentations"], rng)
        self.plan = np.tile(plan, -(-t["frames"] // len(plan)))[:t["frames"]]
        self.first_order = np.arange(t["frames"])
        self.sizes = [int(s) for s in dict.fromkeys(self.plan.tolist())]  # by first step
        self.check_steps = len(self.sizes)
        self.set_up_plan = np.concatenate([self.sizes * 3, self.plan])
        self.epoch_plan = self.set_up_plan

    def setup(self) -> None:
        from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig

        t, c = self.traffic, self.cfg
        opt = c["optimizer"]
        self.inputs()
        self.phase("inputs")
        self.model = cells.port_model(c, self.weights, self.device)
        tcfg = TrainerConfig(lr=opt["lr"], momentum=opt["momentum"], clip_norm=opt["clip"],
                             auto_lr_find=False, train_batch=t["batch"], seed=self.trainer_seed,
                             verbose=False)
        self.trainer = Trainer(self.model, POLICIES[t["policy"]], tcfg, mesh=self.mesh,
                               device=self.device)
        self.state = self.trainer.create_state(None, opt["lr"])
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        self.phase("model, trainer and state")
        n = self.check_steps

        def after(k: int) -> None:
            if k == 1:  # the first gradient, as the optimizer holds it after one step
                self.first_grad = {m: b.to("cpu", torch.float32, copy=True)
                                   for m, b in zip(names, self.state.momentum_buffers())}
                self.phase("step 1")
            if k == n:
                self.change = {m: (p.detach() - self.weights[m]).float().cpu()
                               for m, p in zip(names, self.state.params)}
                self.phase(f"the check's {n} steps")

        self.steps(self.first_order, 3 * n, after)
        self.phase("every size captured")
        self.epoch_plan = self.plan

    def epoch(self, order, e: int = 0) -> np.ndarray:
        """One epoch through `_step_epoch` under the plan (set-up's until
        set-up ends); the frames in order whatever `order` (the MF loader is
        unshuffled)."""
        return self.trainer._step_epoch(self.state, self.data, self.first_order, train_ds=None,
                                        lr=self.state.lr, size_plan=self.epoch_plan,
                                        shuffle=False, np_rng=self.rng, epoch=e)

    def reference(self, quant: bool = False, lr_scale: float = 1.0,
                  momentum: float | None = None, **_) -> dict:
        """The reference's first check_steps steps from the same weights,
        items, sizes, site keys and drop probabilities (the plain float32 run
        kept for the next call); lr_scale, momentum: a fault's reading."""
        plain = not quant and lr_scale == 1.0 and momentum is None
        if plain and self._reference is not None:
            return self._reference
        c, steps = self.cfg, self.check_steps
        ramp, opt = c["ramp"], c["optimizer"]
        gen = torch.Generator().manual_seed(self.trainer_seed)
        keys = [tasks.draw_keys(gen, ref.num_sites(c)) for _ in range(steps)]
        probs = [tasks.drop_prob_at(k, ramp["start"], ramp["stop"], ramp["steps"])
                 for k in range(steps)]
        batches = [tuple(a[k:k + 1].to(torch.float32) / 255.0 for a in self.data)
                   for k in range(steps)]
        out = resize.train_steps(self.weights, c, batches, self.sizes[:steps],
                                 keys, probs, opt["lr"] * lr_scale,
                                 opt["momentum"] if momentum is None else momentum,
                                 c["dropblock"]["block_size"], quant)
        if plain:
            self._reference = out
        return out
