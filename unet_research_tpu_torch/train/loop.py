"""The training engine (twin of unet_research_tpu/train/loop.py).

Replaces the reference's PyTorch-Lightning assembly (Trainer + callbacks +
LightningModule overrides, base_model_tests/training.py:198-231):

- one train step: the resize policy's train_io around the model in train
  mode (DropBlock at the ramped drop probability, masks from the mask
  producer K2, the 3x3 convs through K3 and its backward under
  conv_impl='pair'), the masked rescaled BCE, backward, then the clipped
  SGD + momentum update (train/state.py);
- host-side per-epoch control: ReduceLROnPlateau, EarlyStopping,
  best-checkpoint keeping and the PL-style history, including the
  reference's `if batch_idx % 10:` train-loss logging gate
  (utils_training.py:36);
- an LR finder reproducing PL's trainer.tune(auto_lr_find=True) exponential
  sweep and steepest-gradient suggestion (training.py:217-220).

With `mesh` (parallel/mesh.py), the twin of JAX's `mesh=`: the step is
data-parallel over the ranks of a process group and computes JAX's
global-batch step. `train_batch` is the global batch; each rank takes its
rows of every batch of the shared shuffled order, draws its masks at their
global rows, normalises the loss and BatchNorm by the global batch, and
sums the gradients over the ranks in one all-reduce before the clip, so
every rank holds the same parameters. The seed and the initial weights are
rank 0's. Validation splits the items over the ranks; rank 0 alone writes
checkpoints and prints.

Step programs (`_StepProgram`, the twin of JAX's jitted
`train_step_indexed`, one program per static `size`, and of its
`train_epoch_scan`): every batch-1 step without a mesh is train_step on
inputs that it reads from tables on the device (the items' order, each
step's site keys, drop probability and learning rate, filled on the host
before a run of steps from the same generator, ramp and learning rates as
the per-step path) at a step index that it advances on the device. On the
card each size's first steps run eagerly, then its step is captured once as
a CUDA graph and replayed for every later step at that size; on the CPU the
same step runs eagerly. It computes the per-step path's numbers. A failed
capture or replay raises. The runs are:

- scanned epochs (`TrainerConfig.scan_epochs`, on by default): under JAX's
  conditions (no size plan, batch 1, no detect_anomaly, no mesh) an epoch
  of one size, with one host synchronisation (the losses);
- stepped epochs (a size plan, detect_anomaly or scan_epochs=False at batch
  1 without a mesh): an epoch over the plan's sizes, one graph per size,
  the losses read once per epoch, or after every step under
  detect_anomaly, as JAX reads them;
- lr_find's sweep: its learning rates in the table, the loss read after
  every step for the divergence stop.

`Trainer(program=False)` and `lr_find(program=False)` (port-only) run the
stepped epochs' and the sweep's steps from the host, one eager
train_step_indexed at a time, for comparisons.

Differences from the JAX trainer: the DropBlock site keys of each step
are drawn from a torch.Generator seeded with the run's seed, where JAX
folds the step into a PRNG key, so the two packages draw different masks
from one seed; `train_step` takes explicit `site_keys`.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from unet_research_tpu_torch.data.dataset import ArrayDataset
from unet_research_tpu_torch.data.loading import batch_iterator, to_device
from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.models.unet import UNet, draw_site_keys
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.ops.losses import masked_rescaled_bce
from unet_research_tpu_torch.parallel.mesh import barrier, broadcast_, broadcast_int, psum
from unet_research_tpu_torch.train.checkpoint import BestCheckpointKeeper, load_checkpoint
from unet_research_tpu_torch.train.policies import ResizePolicy
from unet_research_tpu_torch.train.schedule import EarlyStopping, ReduceLROnPlateau
from unet_research_tpu_torch.train.state import TrainState


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: int = 50
    lr: float = 1e-3
    momentum: float = 0.99
    clip_norm: Optional[float] = None  # --gradient_clip_val
    auto_lr_find: bool = True
    early_stop_patience: int = 10
    check_val_every_n_epoch: int = 1
    train_batch: int = 1
    val_batch: int = 1
    seed: int = -1
    log_gate: int = 10  # the reference logs the train loss when batch_idx % 10 != 0
    verbose: bool = True
    profiler: Optional[str] = None  # 'simple' | 'trace'
    detect_anomaly: bool = False  # per-step finite check (waits for the card each step)
    # an epoch as one device program (module docstring); steps one at a time
    # under a size plan, batch > 1, detect_anomaly or a mesh, as JAX does
    scan_epochs: bool = True


def drop_prob_at(step: int, db) -> np.float32:
    """The step's DropBlock drop probability in float32 arithmetic, as the
    JAX step computes it from its traced step (ops/dropblock.py
    linear_drop_prob, or the fixed drop_prob without the scheduler)."""
    if not db.use_scheduler:
        return np.float32(db.drop_prob)
    if db.nr_steps <= 1:
        return np.float32(db.max_drop_prob)
    i = np.float32(min(step, db.nr_steps - 1))
    return (np.float32(db.start_drop_prob)
            + np.float32(db.max_drop_prob - db.start_drop_prob) * i / np.float32(db.nr_steps - 1))


class Trainer:
    """Drives one model and one resize policy end to end, on `device` (the
    card unless the caller asks for the CPU; the model must live there).
    mesh: data-parallel over its ranks (module docstring); the mesh's size
    must divide `train_batch`. program=False (port-only): the stepped
    epochs' and lr_find's steps run from the host (module docstring)."""

    def __init__(self, model: UNet, policy: ResizePolicy, cfg: TrainerConfig, mesh=None,
                 device=None, program: bool = True):
        if mesh is not None and cfg.train_batch % mesh.size:
            raise ValueError(f"train_batch {cfg.train_batch} does not divide over the "
                             f"{mesh.size} ranks of the mesh")
        self.model = model
        self.policy = policy
        self.cfg = cfg
        self.mesh = mesh
        self.rank0 = mesh is None or mesh.rank == 0
        self.device = resolve_device(device)
        where = model.output_conv[0].weight.device
        if where.type != self.device.type:
            raise ValueError(f"the model lives on {where}, the trainer runs on {self.device}")
        self.has_dropblock = model.cfg.dropblock.kind is not None
        self.key_generator = torch.Generator().manual_seed(max(cfg.seed, 0))
        self.program = program
        self._program = None  # the fit's step program (_StepProgram)

    def scans(self, size_plan: Optional[np.ndarray] = None) -> bool:
        """Whether fit runs scanned epochs: JAX's `use_scan` conditions
        (unet_research_tpu/train/loop.py:296-302)."""
        cfg = self.cfg
        return (cfg.scan_epochs and size_plan is None and cfg.train_batch == 1
                and not cfg.detect_anomaly and self.mesh is None)

    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0) -> dict:
        """A seeded torch-style initialisation of the model's configuration,
        as a CPU state_dict; the model itself is left as it is."""
        fresh = UNet(self.model.cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
        return fresh.state_dict()

    def create_state(self, params: Optional[dict] = None, lr: Optional[float] = None) -> TrainState:
        """Load `params` (a state_dict) into the model, if given, and start a
        fresh optimizer on its parameters. Under a mesh every rank then holds
        rank 0's weights."""
        if params is not None:
            self.model.load_state_dict(params)
        if self.mesh is not None:
            for t in self.model.state_dict().values():
                broadcast_(t, self.mesh)
        return TrainState(self.model, lr or self.cfg.lr, self.cfg.momentum, self.cfg.clip_norm,
                          mesh=self.mesh)

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, im, gt, mask, lr: Optional[float], size: int = -1,
                   site_keys: Optional[torch.Tensor] = None,
                   drop_prob: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update; returns the loss (float32, on the device, detached).
        lr: None takes the state's lr_tensor as it stands (the scanned
        step's). site_keys: the (S, 2) DropBlock keys, drawn from
        `key_generator` when None. drop_prob: the DropBlock drop probability
        as a 0-d float32 tensor on the device, drop_prob_at(state.step) when
        None; the mask sites compute their seed thresholds from it there.
        Under a mesh im/gt/mask are this rank's rows of the global batch
        (data/loading.py::shard_batch) and the loss is the global batch's."""
        kwargs = {}
        if self.has_dropblock:
            if site_keys is None:
                site_keys = draw_site_keys(self.model.num_mask_sites(), self.key_generator)
            if drop_prob is None:
                p = drop_prob_at(state.step, self.model.cfg.dropblock)
                drop_prob = torch.full((), float(p), dtype=torch.float32, device=self.device)
            kwargs = dict(drop_prob=drop_prob, site_keys=site_keys)

        def forward(x):
            return self.model(x, train=True, mesh=self.mesh, **kwargs)

        seg, gt2, mask2 = self.policy.train_io(forward, im, gt, mask, size)
        loss = masked_rescaled_bce(seg, gt2, mask2, mesh=self.mesh)
        loss.backward()
        state.apply_gradients(lr)
        loss = loss.detach()
        return loss if self.mesh is None else psum(loss, self.mesh)

    def train_step_indexed(self, state: TrainState, data, oi, lr: Optional[float],
                           size: int = -1, **inputs) -> torch.Tensor:
        """train_step on item `oi` (an int, or a (1,) int64 tensor on the
        device) of the device-resident uint8 split `data` (images, targets,
        masks), normalised as ArrayDataset.__getitem__. inputs: train_step's
        site_keys and drop_prob."""
        im, gt, mask = ((t.index_select(0, oi) if torch.is_tensor(oi) else t[oi:oi + 1])
                        .to(torch.float32) / 255.0 for t in data)
        return self.train_step(state, im, gt, mask, lr, size, **inputs)

    def step_tables(self, step: int, num_steps: int) -> tuple:
        """The DropBlock inputs of `num_steps` steps from `step`, as the
        per-step path draws and computes them: (K, S, 2) site keys from
        `key_generator` and the (K,) float32 drop probabilities
        drop_prob_at(step + i). CPU tensors."""
        db = self.model.cfg.dropblock
        keys = torch.stack([draw_site_keys(self.model.num_mask_sites(), self.key_generator)
                            for _ in range(num_steps)])
        drop_probs = torch.tensor(np.array([drop_prob_at(step + i, db) for i in range(num_steps)],
                                           dtype=np.float32))
        return keys, drop_probs

    def train_epoch_scan(self, state: TrainState, data, order, lr: float) -> np.ndarray:
        """All K steps of one epoch as one device program over the
        device-resident uint8 split `data` (JAX `train_epoch_scan`,
        loop.py:152-171): the steps of train_step_indexed on items `order`
        at `lr`. Returns the (K,) float32 losses and advances state.step by
        K. The program (tables, captured graph) is kept for the next epoch
        of the same fit."""
        prog = self._program_for(state, data, len(order))
        prog.fill(order, lr)
        for _ in range(len(order)):
            prog.advance()
        return prog.losses.cpu().numpy()

    def _program_for(self, state: TrainState, data, num_steps: int) -> "_StepProgram":
        """The fit's step program for runs of `num_steps` steps of `state`
        on `data`, made anew when the cached one does not serve them."""
        prog = self._program
        if prog is None or not prog.serves(state, data, num_steps):
            prog = self._program = _StepProgram(self, state, data, num_steps)
        return prog

    @torch.no_grad()
    def eval_step(self, im, gt, mask) -> torch.Tensor:
        seg, gt2, mask2 = self.policy.val_io(self.model, im, gt, mask)
        return masked_rescaled_bce(seg, gt2, mask2)

    # ------------------------------------------------------------------
    def fit(self, train_ds: ArrayDataset, val_ds: ArrayDataset, model_info_dir: str,
            size_plan: Optional[np.ndarray] = None, params: Optional[dict] = None,
            ckpt_meta: Optional[dict] = None, resume_from: Optional[str] = None):
        """Train with early stopping, plateau LR and best-checkpoint keeping.

        params: a state_dict to start from (a seeded initialisation when
        None). resume_from: a checkpoint written by this trainer; training
        continues after its epoch with its weights, momentum, LR and step.

        Returns (state, history, keeper); `history` holds per-epoch lists
        'train_loss_epoch' / 'val_loss_epoch' / 'lr', as PL logs them."""
        cfg = self.cfg
        seed = cfg.seed if cfg.seed != -1 else int(time.time()) % (2**31)
        if self.mesh is not None:
            seed = broadcast_int(seed, self.mesh)  # one shuffle and one set of site keys
        np_rng = np.random.default_rng(seed)
        self.key_generator = torch.Generator().manual_seed(seed)

        start_epoch = 0
        if resume_from is not None:
            sd, meta, opt = load_checkpoint(resume_from)
            lr = float(meta.get("lr", cfg.lr))
            state = self.create_state(sd, lr)
            if opt is not None:
                state.optimizer.load_state_dict(opt)
                state.init_momentum_buffers()
            state.step = int(meta.get("step", 0))
            start_epoch = int(meta.get("epoch", -1)) + 1
        else:
            self.model.load_state_dict(self.init_params(seed) if params is None else params)
            lr = cfg.lr
            if cfg.auto_lr_find:
                lr = lr_find(self, None, train_ds, size_plan, seed)
                if cfg.verbose and self.rank0:
                    print(f"LR finder suggestion: {lr:.3e}")
            state = self.create_state(None, lr)
        plateau = ReduceLROnPlateau(lr)
        early = EarlyStopping(patience=cfg.early_stop_patience)
        keeper = BestCheckpointKeeper(model_info_dir) if self.rank0 else None
        history = {"train_loss_epoch": [], "val_loss_epoch": [], "lr": []}
        verbose = cfg.verbose and self.rank0

        prof = None
        if cfg.profiler == "trace" and self.rank0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()

        t_fit = time.time()
        shuffle = not self.policy.uses_size_plan  # MF plans index by batch_idx
        use_scan = self.scans(size_plan)
        dev_data = None
        try:
            for epoch in range(start_epoch, cfg.max_epochs):
                t0 = time.time()
                if cfg.train_batch == 1:
                    # the uint8 split uploaded once; each step indexes one item
                    if dev_data is None:
                        dev_data = to_device((train_ds.images, train_ds.targets,
                                              train_ds.masks), self.device)
                    order = np.arange(len(train_ds))
                    if shuffle:
                        np_rng.shuffle(order)
                if use_scan:
                    losses = self.train_epoch_scan(state, dev_data, order, lr)
                    step_losses = losses[np.arange(len(losses)) % cfg.log_gate != 0]
                else:
                    step_losses = self._step_epoch(state, dev_data, order if cfg.train_batch == 1
                                                   else None, train_ds, lr, size_plan, shuffle,
                                                   np_rng, epoch)
                train_loss = float(np.mean(step_losses)) if len(step_losses) else float("nan")
                history["train_loss_epoch"].append(train_loss)
                history["lr"].append(lr)

                if (epoch + 1) % cfg.check_val_every_n_epoch == 0:
                    val_loss = self._mean_val_loss(val_ds, cfg.val_batch)
                    history["val_loss_epoch"].append(val_loss)
                    if keeper is not None:
                        keeper.update(epoch, val_loss, self.model.state_dict(),
                                      meta={**(ckpt_meta or {}), "lr": lr, "step": state.step},
                                      optimizer=state.optimizer.state_dict())
                    if self.mesh is not None:
                        barrier(self.mesh)  # the other ranks wait for rank 0's checkpoint
                    lr = plateau.step(val_loss)
                    stop = early.step(val_loss)
                    if verbose:
                        print(f"epoch {epoch:3d} train_loss {train_loss:.4f} "
                              f"val_loss {val_loss:.4f} lr {lr:.2e} ({time.time() - t0:.1f}s)")
                    if stop:
                        if verbose:
                            print(f"early stopping at epoch {epoch}")
                        break
        finally:
            self._program = None  # frees the captured graphs and their memory pools
        if prof is not None:
            prof.stop()
            trace_dir = os.path.join(model_info_dir, "..", "profile")
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        if cfg.profiler == "simple" and verbose:
            n_epochs = len(history["train_loss_epoch"])
            total = time.time() - t_fit
            print(f"[profiler simple] {n_epochs} epochs in {total:.1f}s "
                  f"({total / max(1, n_epochs):.1f}s/epoch)")
        return state, history, keeper

    def _step_epoch(self, state, dev_data, order, train_ds, lr, size_plan, shuffle, np_rng,
                    epoch) -> np.ndarray:
        """One epoch a step at a time: items `order` of the device-resident
        split at batch 1 (through the step program without a mesh, unless
        program=False), else batch_iterator's batches. Returns the float32
        losses that the log gate keeps."""
        cfg = self.cfg
        prog = None
        if order is not None and self.mesh is None and self.program:
            prog = self._program_for(state, dev_data, len(order))
            prog.fill(order, lr)
        if order is not None:
            batches = ((i, int(oi)) for i, oi in enumerate(order))
        else:
            batches = enumerate(batch_iterator(train_ds, cfg.train_batch, shuffle, np_rng,
                                               device=self.device, mesh=self.mesh))
        step_losses = []
        for batch_idx, item in batches:
            size = int(size_plan[batch_idx]) if size_plan is not None else -1
            if prog is not None:
                prog.advance(size)
                loss = prog.losses[batch_idx]
            elif order is not None:
                loss = self.train_step_indexed(state, dev_data, item, lr, size)
            else:
                loss = self.train_step(state, *item, lr, size)
            if cfg.detect_anomaly and not np.isfinite(float(loss)):
                raise FloatingPointError(
                    f"non-finite train loss at epoch {epoch} batch {batch_idx}"
                    " (--detect_anomaly)")
            if batch_idx % cfg.log_gate:  # the reference's gate quirk
                step_losses.append(loss)
        if not step_losses:
            return np.zeros(0, np.float32)
        return torch.stack(step_losses).cpu().numpy()

    def _mean_val_loss(self, ds: ArrayDataset, batch: int) -> float:
        """The mean of the batches' losses. Under a mesh rank r takes batches
        r, r + R, ...; the ranks' sums of losses and counts are all-reduced,
        so every rank reads the same mean."""
        starts = range(0, len(ds), batch)
        if self.mesh is not None:
            starts = starts[self.mesh.rank::self.mesh.size]
        total = torch.zeros(2, dtype=torch.float64, device=self.device)
        for s in starts:
            im, gt, mask = to_device(ds[np.arange(s, min(s + batch, len(ds)))], self.device)
            total[0] += self.eval_step(im, gt, mask).to(torch.float64)
            total[1] += 1
        if self.mesh is not None:
            total = psum(total, self.mesh)
        return float(total[0] / total[1])

    # ------------------------------------------------------------------
    def validate(self, params: Optional[dict], val_ds: ArrayDataset) -> float:
        """Mean validation loss; `params` (a state_dict) is loaded into the
        model first when given."""
        if params is not None:
            self.model.load_state_dict(params)
        return self._mean_val_loss(val_ds, 1)

    def predict(self, params: Optional[dict], ds: ArrayDataset):
        """Batch-1 predictions as trainer.predict over a re-wrapped loader
        (utils_metrics.py:52-56,87-90). Yields (idx, seg, im, gt, mask) as
        numpy NHWC; `params` is loaded into the model first when given."""
        if params is not None:
            self.model.load_state_dict(params)
        for i, (im, gt, mask) in enumerate(batch_iterator(ds, 1, False, device=self.device)):
            with torch.no_grad():
                out = self.policy.predict_io(self.model, im, gt, mask)
            yield (i, *(t.cpu().numpy() for t in out))




class _StepProgram:
    """The static buffers of runs of batch-1 steps of one TrainState and, on
    the card, one captured step per `size` (module docstring).

    The step reads every input that changes from step to step from tables
    on the device (order, site keys, drop probabilities, learning rates) at
    the step index `index` on the device, writes its loss to the losses
    table there and advances the index: a CUDA graph of one step at a size,
    replayed, runs the next step of the run at that size. The host fills the
    tables before a run (fill) and reads the losses back."""

    # Eager steps at a size before its capture, on a side stream, as
    # PyTorch's CUDA graph notes ask; counted across runs, so that runs of
    # one step still reach a capture. They are real steps of the run. The
    # first does the one-time work that a capture cannot hold: it loads the
    # kernel libraries, raises K3's shared-memory limit and builds cuDNN's
    # plans for every conv of the forward, the remat re-run and the
    # backward at this size's feature maps. The second is a step in the
    # steady state that the capture will record, at the cost of one eager
    # step per size.
    WARMUP = 2

    def __init__(self, trainer: Trainer, state: TrainState, data, num_steps: int):
        self.trainer, self.state, self.data, self.num_steps = trainer, state, data, num_steps
        dev = trainer.device
        self.order = torch.zeros(num_steps, dtype=torch.int64, device=dev)
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.losses = torch.zeros(num_steps, dtype=torch.float32, device=dev)
        self.lrs = torch.zeros(num_steps, dtype=torch.float32, device=dev)
        if trainer.has_dropblock:
            sites = trainer.model.num_mask_sites()
            self.keys = torch.zeros((num_steps, sites, 2), dtype=torch.int64, device=dev)
            self.drop_probs = torch.zeros(num_steps, dtype=torch.float32, device=dev)
        self.warm = collections.Counter()  # eager steps so far, by size
        # by size: the graph, the kernel launches of one replay
        # (ops/cuda/launches.py) and the capture's seconds
        self.graphs, self.replay_counts, self.capture_seconds = {}, {}, {}

    def serves(self, state: TrainState, data, num_steps: int) -> bool:
        return state is self.state and data is self.data and num_steps == self.num_steps

    def fill(self, order, lr) -> None:
        """The tables of a run of K steps from state.step on items `order`
        (K = num_steps): the site keys drawn from the trainer's
        key_generator and the drop probabilities of the ramp
        (Trainer.step_tables); `lr` one learning rate for every step, which
        also becomes the state's, or K of them. The step index goes to 0."""
        t, state = self.trainer, self.state
        if t.has_dropblock:
            keys, drop_probs = t.step_tables(state.step, self.num_steps)
            self.keys.copy_(keys)
            self.drop_probs.copy_(drop_probs)
        self.order.copy_(torch.as_tensor(np.asarray(order), dtype=torch.int64))
        if np.ndim(lr) == 0:
            state.set_lr(float(lr))  # the optimizer's, which checkpoints keep
        self.lrs.copy_(torch.tensor(np.broadcast_to(np.float32(lr), (self.num_steps,))))
        self.index.zero_()

    def step(self, size: int = -1) -> None:
        """One train step at the step index, on the buffers."""
        t, idx = self.trainer, self.index
        inputs = {}
        if t.has_dropblock:
            inputs = dict(site_keys=self.keys.index_select(0, idx)[0],
                          drop_prob=self.drop_probs.index_select(0, idx)[0])
        self.state.lr_tensor.copy_(self.lrs.index_select(0, idx)[0])
        loss = t.train_step_indexed(self.state, self.data, self.order.index_select(0, idx), None,
                                    size, **inputs)
        self.losses.index_copy_(0, idx, loss.reshape(1))
        idx.add_(1)

    def advance(self, size: int = -1) -> None:
        """The run's next step at `size`: on the CPU the step itself; on the
        card a replay of the size's graph, after its warm-up steps and its
        capture. state.step counts it either way."""
        dev = self.trainer.device
        if dev.type != "cuda":
            self.step(size)
            return
        graph = self.graphs.get(size)
        if graph is None and self.warm[size] < self.WARMUP:
            self.warm[size] += 1
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.step(size)
            torch.cuda.current_stream(dev).wait_stream(side)
            return
        if graph is None:
            graph = self.capture(size)
        graph.replay()
        launches.credit(self.replay_counts[size])
        self.state.step += 1  # apply_gradients' count is Python, which a replay does not run

    def capture(self, size: int):
        """Record one step at `size` as a CUDA graph (launches.capture); the
        step does not run, so state.step stays where it is."""
        step = self.state.step
        graph, self.replay_counts[size], self.capture_seconds[size] = launches.capture(
            lambda: self.step(size))
        self.state.step = step
        self.graphs[size] = graph
        return graph


def lr_find(trainer: Trainer, params: Optional[dict], train_ds: ArrayDataset,
            size_plan: Optional[np.ndarray], seed: int, num_training: int = 100,
            min_lr: float = 1e-8, max_lr: float = 1.0, beta: float = 0.98,
            program: Optional[bool] = None) -> float:
    """PL 1.5 lr_find: exponential LR sweep over `num_training` steps,
    EWMA-smoothed losses, divergence stop at 4x the best, steepest-negative-
    gradient suggestion skipping the first 10 and the last point. The probe
    starts from `params` (the model's current weights when None) and the
    model's weights are put back afterwards, as PL restores them. Under the
    trainer's mesh the probe steps are data-parallel steps, whose global
    losses take the same decisions on every rank.

    At batch 1 without a mesh the sweep runs through a step program of its
    own (module docstring), discarded at its end; program (port-only):
    False steps from the host, None takes the trainer's. Either way the
    trainer's key_generator ends where the steps that ran leave it."""
    saved = copy.deepcopy(trainer.model.state_dict())
    lrs = min_lr * (max_lr / min_lr) ** (np.arange(num_training) / (num_training - 1))
    state = trainer.create_state(params, float(lrs[0]))
    np_rng = np.random.default_rng(seed)
    losses = []
    avg, best = 0.0, float("inf")

    def record(loss: float) -> bool:
        """One step's loss into the smoothed curve; False stops the sweep."""
        nonlocal avg, best
        if not np.isfinite(loss):
            return False
        avg = beta * avg + (1 - beta) * loss
        smoothed = avg / (1 - beta ** (len(losses) + 1))
        if losses and smoothed > 4 * best:
            return False
        best = min(best, smoothed)
        losses.append(smoothed)
        return True

    shuffle = not trainer.policy.uses_size_plan
    indexed = trainer.cfg.train_batch == 1
    if program is None:
        program = trainer.program

    def shuffled():
        order = np.arange(len(train_ds))
        if shuffle:
            np_rng.shuffle(order)
        return order

    if indexed:
        data = to_device((train_ds.images, train_ds.targets, train_ds.masks), trainer.device)
    try:
        if indexed and program and trainer.mesh is None:
            # one pass after another over the items, as the host steps take them
            n = len(train_ds)
            order = np.concatenate([shuffled() for _ in range(-(-num_training // n))])
            sizes = (np.full(num_training, -1) if size_plan is None
                     else np.asarray(size_plan)[np.arange(num_training) % n])
            _program_sweep(trainer, state, data, order[:num_training], lrs, sizes, record)
        else:
            i = 0
            while i < num_training:
                if indexed:
                    batches = enumerate(shuffled())
                else:
                    batches = enumerate(batch_iterator(train_ds, trainer.cfg.train_batch,
                                                       shuffle, np_rng, device=trainer.device,
                                                       mesh=trainer.mesh))
                for batch_idx, item in batches:
                    if i >= num_training:
                        break
                    size = int(size_plan[batch_idx]) if size_plan is not None else -1
                    if indexed:
                        loss = trainer.train_step_indexed(state, data, int(item), float(lrs[i]),
                                                          size)
                    else:
                        loss = trainer.train_step(state, *item, float(lrs[i]), size)
                    if not record(float(loss)):
                        i = num_training
                        break
                    i += 1
    finally:
        trainer.model.load_state_dict(saved)

    skip_begin, skip_end = 10, 1
    if len(losses) < skip_begin + skip_end + 2:
        return float(trainer.cfg.lr)
    seg_losses = np.array(losses[skip_begin:-skip_end])
    idx = int(np.gradient(seg_losses).argmin()) + skip_begin
    return float(lrs[idx])


def _program_sweep(trainer: Trainer, state: TrainState, data, order, lrs, sizes, record) -> None:
    """lr_find's steps through a step program of their own: step i on item
    order[i] at lrs[i] and sizes[i], its loss read and handed to record,
    until record returns False. The tables hold the whole sweep, so the site
    keys of every step are drawn up front; the key generator is then set
    back and moved on by the steps that ran, as the eager sweep draws them.
    The program and its graphs go when the sweep returns."""
    keys_at = trainer.key_generator.get_state()
    prog = _StepProgram(trainer, state, data, len(order))
    prog.fill(order, lrs)
    ran = 0
    for i, size in enumerate(sizes):
        prog.advance(int(size))
        ran += 1
        if not record(float(prog.losses[i])):
            break
    if trainer.has_dropblock:
        trainer.key_generator.set_state(keys_at)
        trainer.step_tables(0, ran)
