"""The "train" kind: the trainer's epochs over a device-resident uint8 split
of `frames` frames at global batch `batch`, over the workload's `chips`
ranks (one card each): the scanned epoch (`Trainer.train_epoch_scan`) on
one card, else the stepped epoch that `Trainer.fit` runs (`_step_epoch`,
under an NCCL mesh). Each epoch shuffles the split from the seed. The
window ends at the first epoch end at or after its seconds.

Traffic keys: `frames`, `height`, `width`, `vessel_share`, `batch`;
`check_steps`, the first steps that the check follows; `profile_steps`, the
profiled slice's steps; `reference_rows` rows a reference forward;
`limits`.

Set-up drives the window's own entry on the first order and stops it after
`check_steps` steps (`steps`); the check follows them with the reference:
per leaf the norms of the first gradient (the momentum buffer after one
step) and of the parameters' change, and over all leaves the relative L2
of the change's difference (`gaps`).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from benchmark import cells
from benchmark.reference import tasks, unet as ref


def leaf_gaps(prog: dict, refn: dict, keep=None, over=max) -> float:
    """The worst leaf's (over=max) or the median leaf's (over=
    statistics.median) |prog norm - reference norm| over the larger of the
    reference's norm of that leaf and the median leaf's. prog, refn: {leaf:
    norm}; keep: the leaves that count (all when None)."""
    names = [k for k in refn if keep is None or k in keep]
    median = statistics.median(refn[k] for k in names)
    return over(abs(prog[k] - refn[k]) / max(refn[k], median) for k in names)


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.to(torch.float64))) for k, v in tensors.items()}


def l2_gap(prog: dict, refs: dict, keep) -> float:
    """||prog - refs|| / ||refs|| over the leaves `keep` together, in
    float64 on the reference's device."""
    diff = total = 0.0
    for k in keep:
        r = refs[k].to(torch.float64)
        diff += float(torch.sum((prog[k].to(r.device, torch.float64) - r) ** 2))
        total += float(torch.sum(r * r))
    return (diff / total) ** 0.5


class _Stop(Exception):
    """Raised out of the window's entry once a slice has had its steps."""


class Cell(cells.Cell):
    unit = "epoch"

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
        self.trainer = Trainer(self.model, POLICIES[c["policy"]], tcfg, mesh=self.mesh,
                               device=self.device)
        self.state = self.trainer.create_state(None, opt["lr"])
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        self.phase("model, trainer and state")

        def after(k: int) -> None:
            if k == 1:  # the first gradient, as the optimizer holds it after one step
                self.first_grad = {n: b.to("cpu", torch.float32, copy=True)
                                   for n, b in zip(names, self.state.momentum_buffers())}
            self.phase(f"step {k}")

        self.steps(self.first_order, t["check_steps"], after)
        self.change = {n: (p.detach() - self.weights[n]).float().cpu()
                       for n, p in zip(names, self.state.params)}
        self.sync()

    def inputs(self) -> None:
        """The weights, the split, the trainer's seed and the first order, on
        the device and the host from the seed."""
        self.weights = cells.make_weights(self.cfg, self.seed, self.device)
        self.data = cells.make_split(self.traffic, self.seed, self.device)
        self.trainer_seed = cells.derive(self.seed, "trainer")
        self.rng = np.random.default_rng(cells.derive(self.seed, "order"))
        self.first_order = self.rng.permutation(self.traffic["frames"])
        self._reference = None

    def epoch(self, order, e: int = 0) -> np.ndarray:
        """One epoch on `order` through the window's entry; its losses."""
        t = self.trainer
        if self.mesh is None and t.scans():
            return t.train_epoch_scan(self.state, self.data, order, self.state.lr)
        return t._step_epoch(self.state, self.data, order, train_ds=None, lr=self.state.lr,
                             size_plan=None, shuffle=True, np_rng=self.rng, epoch=e)

    def steps(self, order, n: int, after=None) -> None:
        """The first n steps of an epoch on `order` through the window's own
        entry (epoch), which is stopped after them; after(k) runs after step
        k. The entry's step program counts the steps (_StepProgram.advance)."""
        from unet_research_tpu_torch.train import loop

        advance, done = loop._StepProgram.advance, [0]

        def counted(prog, size: int = -1) -> None:
            advance(prog, size)
            done[0] += 1
            if after is not None:
                after(done[0])
            if done[0] == n:
                raise _Stop

        loop._StepProgram.advance = counted
        try:
            self.epoch(order)
        except _Stop:
            return
        finally:
            loop._StepProgram.advance = advance
        raise RuntimeError(f"the epoch ended after {done[0]} of {n} steps")

    def window(self, seconds: float) -> cells.Window:
        win = cells.Window(self.unit)
        t0 = time.perf_counter()
        e = 0
        while True:
            order = self.rng.permutation(self.traffic["frames"])
            s = time.perf_counter()
            losses = self.epoch(order, e)
            now = time.perf_counter()
            e += 1
            win.seconds.append(now - s)
            win.failed += int((~np.isfinite(losses)).sum())
            stop = now - t0 >= seconds
            if self.mesh is not None:  # rank 0's clock decides for every rank
                from unet_research_tpu_torch.parallel.mesh import broadcast_int

                stop = bool(broadcast_int(int(stop), self.mesh))
            if stop:
                break
        win.wall_s = now - t0
        win.work = e * self.traffic["frames"]
        win.attempted = e * (self.traffic["frames"] // self.traffic["batch"])
        return win

    def profile_work(self) -> tuple:
        """(run, work): the first profile_steps steps of one more epoch."""
        t = self.traffic
        order = self.rng.permutation(t["frames"])

        def run():
            self.steps(order, t["profile_steps"])

        work = {"steps": t["profile_steps"], "rows": t["batch"] // self.chips,
                "h": t["height"], "w": t["width"]}
        return run, work

    def release(self) -> None:
        self.trainer = self.state = self.model = None
        cells.free_device()

    def reference(self, quant: bool = False, rows: int | None = None,
                  grad_rows: int | None = None, lr_scale: float = 1.0,
                  momentum: float | None = None) -> dict:
        """The reference's first steps from the same weights, items, site keys
        and drop probabilities: losses, first gradient and parameters. rows:
        the first rows of each batch only; grad_rows: see tasks.train_steps;
        lr_scale, momentum: the optimizer's, changed (a fault's reading). The
        plain float32 run (no argument) is kept for the next call."""
        plain = not quant and rows is None and grad_rows is None and lr_scale == 1.0 \
            and momentum is None
        if plain and self._reference is not None:
            return self._reference
        t, c = self.traffic, self.cfg
        ramp, opt, steps = c["ramp"], c["optimizer"], t["check_steps"]
        gen = torch.Generator().manual_seed(self.trainer_seed)
        keys = [tasks.draw_keys(gen, ref.num_sites(c)) for _ in range(steps)]
        probs = [tasks.drop_prob_at(k, ramp["start"], ramp["stop"], ramp["steps"])
                 for k in range(steps)]
        batch = t["batch"]
        batches = []
        for k in range(steps):
            idx = torch.as_tensor(self.first_order[k * batch:(k + 1) * batch],
                                  device=self.device)
            batches.append(tuple(a.index_select(0, idx[:rows]).to(torch.float32) / 255.0
                                 for a in self.data))
        out = tasks.train_steps(self.weights, c, batches, keys, probs, opt["lr"] * lr_scale,
                                opt["momentum"] if momentum is None else momentum,
                                c["dropblock"]["block_size"], t["reference_rows"], quant,
                                grad_rows)
        if plain:
            self._reference = out
        return out

    def changes(self, r: dict) -> dict:
        return {k: r["params"][k] - self.weights[k] for k in r["params"]}

    def gaps(self, grads: dict, change: dict, r: dict) -> dict:
        """{number: value} of a first gradient and a change ({leaf: tensor})
        against the reference run r: the worst leaf's gap of the first
        gradient's norm and of the change's (leaf_gaps), the median leaf's
        gap of the change's norm, and the relative L2 of the changes'
        difference over all leaves (l2_gap). The change counts the leaves
        whose reference gradient is at least a thousandth of the median
        leaf's."""
        ref_grads, ref_change = r["grads"], self.changes(r)
        grad_norms = norms(ref_grads)
        median = statistics.median(grad_norms.values())
        moved = [k for k, v in grad_norms.items() if v >= 1e-3 * median]
        mine, theirs = norms(change), norms(ref_change)
        return {"grad_gap": leaf_gaps(norms(grads), grad_norms),
                "change_gap": leaf_gaps(mine, theirs, moved),
                "change_median_gap": leaf_gaps(mine, theirs, moved, statistics.median),
                "change_l2_gap": l2_gap(change, ref_change, moved)}

    def check(self) -> dict:
        return self.gaps(self.first_grad, self.change, self.reference())

    def stand_in(self, q: dict) -> dict:
        """check()'s numbers of reference readings q in the program's place."""
        return self.gaps(q["grads"], self.changes(q), self.reference())

    def control(self) -> dict:
        """check()'s numbers of the float8 reference in the program's place
        (inputs() is all the set-up it needs)."""
        return self.stand_in(self.reference(quant=True))

    def faults(self) -> dict:
        """check()'s numbers of faults planted in the reference put in the
        program's place: the learning rate 5% high, the momentum 0.9 in
        place of the configuration's, and, on a batch of several rows, half
        of the batch left out (the mean over the rest) and rank 0 stepping on
        its own share without the exchange (its gradient and parameters; the
        loss, which would sum the ranks' diverged losses, is not read)."""
        out = {"lr_5pc_high": self.stand_in(self.reference(lr_scale=1.05)),
               "momentum_0.9": self.stand_in(self.reference(momentum=0.9))}
        batch, ranks = self.traffic["batch"], self.workload["chips"]
        if batch > 1:
            out["half_of_the_batch"] = self.stand_in(self.reference(rows=batch // 2))
        if ranks > 1:
            out["no_exchange"] = self.stand_in(self.reference(grad_rows=batch // ranks))
        return out
