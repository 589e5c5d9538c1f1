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

Step programs (`_StepProgram`, the twin of JAX's jitted `train_step` and
`train_step_indexed`, one program per static `size` and batch shape, and of
its `train_epoch_scan`): every step is train_step on inputs that it reads
from tables on the device (each step's rows of the device-resident uint8
split, its site keys, drop probability and learning rate, filled on the
host before a run of steps from the same shuffle, generator, ramp and
learning rates as the per-step path) at a step index that it advances on
the device. Under a mesh the tables hold this rank's rows of each global
batch, cut as data/loading.py::shard_batch cuts them, and the keys, drop
probabilities and learning rates that every rank draws alike from the
broadcast seed; the step is the mesh step, its collectives included. On
the card the first steps of each (size, rows) run eagerly, then its step is
captured once as a CUDA graph and replayed for every later step of that
shape; on the CPU the same step runs eagerly. It computes the per-step
path's numbers. A failed capture or replay raises. The runs are:

- scanned epochs (`TrainerConfig.scan_epochs`, on by default): under JAX's
  conditions (no size plan, batch 1, no detect_anomaly, no mesh) an epoch
  of one size, with one host synchronisation (the losses);
- stepped epochs (a size plan, detect_anomaly, scan_epochs=False,
  train_batch > 1 or a mesh): an epoch over the plan's sizes and
  batch_iterator's batches (no drop_last: a final partial batch gets a
  graph of its own, as JAX compiles one for its shape), the losses read
  once per epoch, or after every step under detect_anomaly, as JAX reads
  them; under a mesh JAX calls its jitted mesh step once a step and the
  port replays the step's graph once a step;
- lr_find's sweep: its learning rates in the table, the loss read after
  every step for the divergence stop.

Forward programs (`ForwardProgram`, the twin of JAX's jitted `eval_step`
and `predict_step`): validation (in fit and `validate`) and `predict` copy
each batch into static buffers of its shape; on the card the first forward
of each (role, shape) runs eagerly, then it is captured once and replayed.
Validation adds each batch's loss and a count into a float64 pair on the
device, read once per validation (under a mesh summed over the ranks once,
after the loop: the forwards hold no collective).

Which programs capture is decided once, when the trainer is built, and
exposed as `Trainer.captures_steps` and `Trainer.captures_forwards`
(ops/cuda/launches.py::captures_on_card): on the card the forwards always
capture; the steps capture without a mesh and under an NCCL mesh, whose
collectives (the loss, BatchNorm and keep-count psums, the gradient
all-reduce) become nodes of the step's graph, as XLA's psum is part of
JAX's jitted step. Under a gloo mesh (two ranks sharing one card) the step
program runs each step eagerly on the card: gloo's collectives run on the
host, which a graph cannot hold. On the CPU every program runs eagerly.

`Trainer(program=False)` and `lr_find(program=False)` (port-only) run the
stepped epochs', the sweep's steps and the forwards from the host (the
steps at batch 1 one eager train_step_indexed at a time, at batch > 1
train_step on batch_iterator's batches), for comparisons.

Differences from the JAX trainer: the DropBlock site keys of each step
are drawn from a torch.Generator seeded with the run's seed, where JAX
folds the step into a PRNG key, so the two packages draw different masks
from one seed; `train_step` takes explicit `site_keys`.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
import weakref
from typing import Optional

import numpy as np
import torch

from unet_research_tpu_torch.data.dataset import ArrayDataset
from unet_research_tpu_torch.data.loading import batch_iterator, shard_batch, to_device
from unet_research_tpu_torch.device import resolve_device
from unet_research_tpu_torch.models.unet import UNet, draw_site_keys
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.ops.losses import masked_rescaled_bce
from unet_research_tpu_torch.parallel.mesh import barrier, broadcast_, broadcast_int, psum
from unet_research_tpu_torch.spans import span
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
    epochs', lr_find's steps and the forwards of validation and predict run
    from the host (module docstring). `captures_steps` and
    `captures_forwards` say whether the step and forward programs capture
    CUDA graphs, decided here from the device, `program` and the mesh's
    backend."""

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
        on_card = self.device.type == "cuda"
        self.captures_steps = on_card and launches.captures_on_card(program, mesh)
        self.captures_forwards = on_card and launches.captures_on_card(program)
        self._program = None  # the fit's step program (_StepProgram)
        self._forward = None  # validation's and predict's (ForwardProgram)

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
        with span("trainer.epoch"):
            prog = self._program_for(state, data, len(order))
            prog.fill(order, lr)
            for _ in range(len(order)):
                prog.advance()
            with span("trainer.losses"):
                return prog.losses.cpu().numpy()

    def _program_for(self, state: TrainState, data, num_steps: int,
                     batch: int = 1) -> "_StepProgram":
        """The fit's step program for runs of `num_steps` steps of `state`
        on batches of up to `batch` items of `data`, made anew when the
        cached one does not serve them."""
        prog = self._program
        if prog is None or not prog.serves(state, data, num_steps, batch):
            prog = self._program = _StepProgram(self, state, data, num_steps, batch)
        return prog

    def _forward_program(self) -> "ForwardProgram":
        """The trainer's forward program, which runs every forward from the
        host under program=False."""
        if self._forward is None:
            self._forward = ForwardProgram(self.device, capture=self.program)
        return self._forward

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

        prof = None
        if cfg.profiler == "trace" and self.rank0:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()

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
                with span("trainer.lr_find"):
                    lr = lr_find(self, None, train_ds, size_plan, seed)
                if cfg.verbose and self.rank0:
                    print(f"LR finder suggestion: {lr:.3e}")
            state = self.create_state(None, lr)
        plateau = ReduceLROnPlateau(lr)
        early = EarlyStopping(patience=cfg.early_stop_patience)
        keeper = BestCheckpointKeeper(model_info_dir) if self.rank0 else None
        history = {"train_loss_epoch": [], "val_loss_epoch": [], "lr": []}
        verbose = cfg.verbose and self.rank0

        t_fit = time.time()
        shuffle = not self.policy.uses_size_plan  # MF plans index by batch_idx
        use_scan = self.scans(size_plan)
        # the steps index the device-resident split (else batch_iterator's)
        indexed = cfg.train_batch == 1 or self.program
        dev_data = None
        try:
            for epoch in range(start_epoch, cfg.max_epochs):
                t0 = time.time()
                if indexed:
                    # the uint8 split uploaded once; each step indexes its items
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
                    step_losses = self._step_epoch(state, dev_data, order if indexed else None,
                                                   train_ds, lr, size_plan, shuffle, np_rng,
                                                   epoch)
                train_loss = float(np.mean(step_losses)) if len(step_losses) else float("nan")
                history["train_loss_epoch"].append(train_loss)
                history["lr"].append(lr)

                if (epoch + 1) % cfg.check_val_every_n_epoch == 0:
                    val_loss = self._mean_val_loss(val_ds, cfg.val_batch)
                    history["val_loss_epoch"].append(val_loss)
                    if keeper is not None:
                        with span("trainer.checkpoint"):
                            keeper.update(epoch, val_loss, self.model.state_dict(),
                                          meta={**(ckpt_meta or {}), "lr": lr,
                                                "step": state.step},
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
            # frees the captured graphs and their memory pools
            self._program = self._forward = None
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
        """One epoch a step at a time: the batches of items `order` of the
        device-resident split, as batch_iterator cuts them (through the step
        program unless program=False; else at batch 1 from the host), or
        batch_iterator's host batches (order None). Returns the float32
        losses that the log gate keeps."""
        with span("trainer.epoch"):
            cfg = self.cfg
            prog = None
            if order is not None:
                table, rows = _cut_batches(order, cfg.train_batch)
                if self.program:
                    prog = self._program_for(state, dev_data, len(table), cfg.train_batch)
                    prog.fill(table, lr, rows)
                items = enumerate(table)
            else:
                items = enumerate(batch_iterator(train_ds, cfg.train_batch, shuffle, np_rng,
                                                 device=self.device, mesh=self.mesh))
            step_losses = []
            for batch_idx, item in items:
                size = int(size_plan[batch_idx]) if size_plan is not None else -1
                if prog is not None:
                    prog.advance(size)
                    loss = prog.losses[batch_idx]
                elif order is not None:  # batch 1
                    loss = self.train_step_indexed(state, dev_data, int(item[0]), lr, size)
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
            with span("trainer.losses"):
                return torch.stack(step_losses).cpu().numpy()

    def _mean_val_loss(self, ds: ArrayDataset, batch: int) -> float:
        """The mean of the batches' losses, summed with their count in a
        float64 pair on the device and read once; the batches go through the
        trainer's forward program (captured on the card unless
        program=False). Under a mesh rank r takes
        batches r, r + R, ...; the ranks' pairs are all-reduced, so every
        rank reads the same mean."""
        with span("trainer.validate"):
            forward = self._forward_program()
            total = forward.zeroed_sums()

            def accumulate(im, gt, mask):
                total[0] += self.eval_step(im, gt, mask).to(torch.float64)
                total[1] += 1

            starts = range(0, len(ds), batch)
            if self.mesh is not None:
                starts = starts[self.mesh.rank::self.mesh.size]
            for s in starts:
                forward("val", accumulate,
                        *to_device(ds[np.arange(s, min(s + batch, len(ds)))], self.device))
            if self.mesh is not None:
                total = psum(total, self.mesh)
            return float(total[0] / total[1])

    # ------------------------------------------------------------------
    def validate(self, params: Optional[dict], val_ds: ArrayDataset) -> float:
        """Mean validation loss; `params` (a state_dict) is copied into the
        model's tensors first when given."""
        if params is not None:
            self.model.load_state_dict(params)
        return self._mean_val_loss(val_ds, 1)

    def predict(self, params: Optional[dict], ds: ArrayDataset):
        """Batch-1 predictions as trainer.predict over a re-wrapped loader
        (utils_metrics.py:52-56,87-90), through the trainer's forward
        program. Yields (idx, seg, im, gt, mask) as numpy NHWC; `params` is
        copied into the model's tensors first when given."""
        if params is not None:
            self.model.load_state_dict(params)
        forward = self._forward_program()

        def predict_io(im, gt, mask):
            return self.policy.predict_io(self.model, im, gt, mask)

        for i, batch in enumerate(batch_iterator(ds, 1, False, device=self.device)):
            out = forward("predict", predict_io, *batch)
            yield (i, *(t.cpu().numpy() for t in out))


class ForwardProgram(launches.KeyedGraphs):
    """Static input buffers per batch shape and, on the card, one captured
    forward per (role, input shapes): the twin of JAX's jitted eval_step
    and predict_step, compiled per input shape (module docstring).

    Calling it with (role, fn, im, gt, mask) runs fn on the batch under
    torch.no_grad(). On the CPU, or with capture=False (program=False), fn
    runs on the batch itself, from the host. On the card the batch is
    copied into its shape's buffers and fn runs on them through
    launches.KeyedGraphs.run: one eager call per (role, shape), then its
    capture and replays; fn holds no collective, so this holds under any
    mesh. fn must be the same function of the buffers for one role, and
    what it returns on the card is the graph's output, valid until the next
    call. A failed capture or replay raises.

    The program keeps no reference to fn or to its owner, so a trainer that
    drops it frees its graphs at once."""

    WARMUP = 1  # eager calls of a (role, shape) before its capture

    def __init__(self, device, capture: bool = True):
        super().__init__(capture)
        self.device = torch.device(device)
        self.sums = None  # zeroed_sums' pair
        self.buffers = {}  # by input shapes: the static (im, gt, mask)
        self.outputs = {}  # by (role, shapes): the graph's output

    def zeroed_sums(self) -> torch.Tensor:
        """A float64 pair on the device at a fixed address, set to zero:
        captured forwards add into it (validation's loss sum and count)."""
        if self.sums is None:
            self.sums = torch.zeros(2, dtype=torch.float64, device=self.device)
        return self.sums.zero_()

    @torch.no_grad()
    def __call__(self, role: str, fn, *batch):
        if self.device.type != "cuda" or not self.captures:
            return fn(*batch)
        shapes = tuple(tuple(t.shape) for t in batch)
        bufs = self.buffers.get(shapes)
        if bufs is None:
            bufs = self.buffers[shapes] = tuple(torch.empty_like(t) for t in batch)
        for buf, t in zip(bufs, batch):
            buf.copy_(t)
        key = (role, shapes)

        def call():
            self.outputs[key] = fn(*bufs)

        if self.run(key, call, self.device):
            return self.outputs[key]
        return self.outputs.pop(key)  # an eager call's


class _StepProgram(launches.KeyedGraphs):
    """The static buffers of runs of steps of one TrainState on batches of
    up to `batch` items and, on the card, one captured step per (size,
    rows) (module docstring). Under the trainer's mesh `batch` is the
    global batch, the tables hold this rank's rows (batch/R at most) and
    `rows` counts them; whether the steps capture is the trainer's
    captures_steps.

    The step reads every input that changes from step to step from tables
    on the device (each step's items, site keys, drop probabilities,
    learning rates) at the step index `index` on the device, writes its loss
    to the losses table there and advances the index: a CUDA graph of one
    step of a shape, replayed, runs the next step of the run of that shape.
    The host fills the tables before a run (fill), keeps each step's number
    of rows, and reads the losses back. The program reaches its trainer
    through a weak reference, so a trainer that drops it frees its graphs
    at once."""

    # Eager steps of a shape before its capture (launches.KeyedGraphs),
    # counted across runs, so that runs of one step still reach a capture.
    # They are real steps of the run. The first does the one-time work for
    # the forward, the remat re-run and the backward at this shape's
    # feature maps; the second is a step in the steady state that the
    # capture will record, at the cost of one eager step per shape.
    WARMUP = 2

    def __init__(self, trainer: Trainer, state: TrainState, data, num_steps: int,
                 batch: int = 1):
        mesh = trainer.mesh
        super().__init__(launches.captures_on_card(True, mesh), mesh)
        self._trainer = weakref.ref(trainer)
        self.state, self.data, self.num_steps, self.batch = state, data, num_steps, batch
        self.width = batch if mesh is None else batch // mesh.size  # this rank's rows at most
        dev = trainer.device
        self.order = torch.zeros((num_steps, self.width), dtype=torch.int64, device=dev)
        self.rows = [self.width] * num_steps  # each step's number of items, on the host
        self.at = 0  # the host's step index of the run
        self.index = torch.zeros(1, dtype=torch.int64, device=dev)
        self.losses = torch.zeros(num_steps, dtype=torch.float32, device=dev)
        self.lrs = torch.zeros(num_steps, dtype=torch.float32, device=dev)
        if trainer.has_dropblock:
            sites = trainer.model.num_mask_sites()
            self.keys = torch.zeros((num_steps, sites, 2), dtype=torch.int64, device=dev)
            self.drop_probs = torch.zeros(num_steps, dtype=torch.float32, device=dev)

    @property
    def trainer(self) -> Trainer:
        return self._trainer()

    def serves(self, state: TrainState, data, num_steps: int, batch: int = 1) -> bool:
        return (state is self.state and data is self.data and num_steps == self.num_steps
                and batch == self.batch)

    def fill(self, order, lr, rows=None) -> None:
        """The tables of a run of K steps from state.step (K = num_steps):
        step k on the items order[k] (a (K,) order: one item a step; a (K,
        batch) table: its first rows[k] items, all `batch` when rows is
        None; under a mesh this rank's share of them, as shard_batch cuts
        them), the site keys drawn from the trainer's key_generator and the
        drop probabilities of the ramp (Trainer.step_tables); `lr` one
        learning rate for every step, which also becomes the state's, or K
        of them. The step index goes to 0."""
        with span("trainer.fill"):
            t, state = self.trainer, self.state
            table = np.asarray(order, np.int64).reshape(self.num_steps, self.batch)
            rows = np.full(self.num_steps, self.batch) if rows is None else np.asarray(rows)
            if t.mesh is not None:
                table, rows = _shard_table(table, rows, t.mesh)
            if t.has_dropblock:
                keys, drop_probs = t.step_tables(state.step, self.num_steps)
                self.keys.copy_(keys)
                self.drop_probs.copy_(drop_probs)
            self.order.copy_(torch.from_numpy(table))
            self.rows = rows.tolist()
            if np.ndim(lr) == 0:
                state.set_lr(float(lr))  # the optimizer's, which checkpoints keep
            self.lrs.copy_(torch.tensor(np.broadcast_to(np.float32(lr), (self.num_steps,))))
            self.index.zero_()
            self.at = 0

    def step(self, size: int = -1, rows: Optional[int] = None) -> None:
        """One train step at the step index on its first `rows` items
        (`width` when None), on the buffers."""
        t, idx = self.trainer, self.index
        inputs = {}
        if t.has_dropblock:
            inputs = dict(site_keys=self.keys.index_select(0, idx)[0],
                          drop_prob=self.drop_probs.index_select(0, idx)[0])
        self.state.lr_tensor.copy_(self.lrs.index_select(0, idx)[0])
        items = self.order.index_select(0, idx)[0, :rows or self.width]
        loss = t.train_step_indexed(self.state, self.data, items, None, size, **inputs)
        self.losses.index_copy_(0, idx, loss.reshape(1))
        idx.add_(1)

    def advance(self, size: int = -1) -> None:
        """The run's next step at `size`: on the CPU the step itself; on the
        card its (size, rows) through launches.KeyedGraphs.run (eagerly
        when the program does not capture). state.step counts it either
        way (apply_gradients' count is Python, which neither a capture
        keeps nor a replay runs)."""
        with span("trainer.step"):
            rows = self.rows[self.at]
            self.at += 1
            dev = self.trainer.device
            if dev.type != "cuda":
                self.step(size, rows)
                return
            step = self.state.step
            if self.run((size, rows), lambda: self.step(size, rows), dev):
                self.state.step = step + 1


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

    The sweep runs through a step program of its own (module docstring; a
    mesh's step under the trainer's mesh, captured as the trainer's
    captures_steps says) on batch_iterator's batches of passes over the
    items, discarded at its end; program (port-only): False steps from the
    host, None takes the trainer's. Either way the trainer's key_generator
    ends where the steps that ran leave it."""
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
    batch = trainer.cfg.train_batch
    if program is None:
        program = trainer.program
    indexed = batch == 1 or program

    def shuffled():
        order = np.arange(len(train_ds))
        if shuffle:
            np_rng.shuffle(order)
        return order

    if indexed:
        data = to_device((train_ds.images, train_ds.targets, train_ds.masks), trainer.device)
    try:
        if program:
            # one pass after another over the items, cut into batches as
            # batch_iterator cuts them, as the host steps take them
            per_pass = -(-len(train_ds) // batch)
            passes = [_cut_batches(shuffled(), batch)
                      for _ in range(-(-num_training // per_pass))]
            table = np.concatenate([p[0] for p in passes])[:num_training]
            rows = np.concatenate([p[1] for p in passes])[:num_training]
            sizes = (np.full(num_training, -1) if size_plan is None
                     else np.asarray(size_plan)[np.arange(num_training) % per_pass])
            _program_sweep(trainer, state, data, table, rows, lrs, sizes, record)
        else:
            i = 0
            while i < num_training:
                if indexed:
                    items = enumerate(shuffled())
                else:
                    items = enumerate(batch_iterator(train_ds, batch, shuffle, np_rng,
                                                     device=trainer.device, mesh=trainer.mesh))
                for batch_idx, item in items:
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


def _program_sweep(trainer: Trainer, state: TrainState, data, table, rows, lrs, sizes,
                   record) -> None:
    """lr_find's steps through a step program of their own: step i on the
    first rows[i] items of table[i] at lrs[i] and sizes[i], its loss read
    and handed to record, until record returns False. The tables hold the whole sweep, so the site
    keys of every step are drawn up front; the key generator is then set
    back and moved on by the steps that ran, as the eager sweep draws them.
    The program and its graphs go when the sweep returns."""
    keys_at = trainer.key_generator.get_state()
    prog = _StepProgram(trainer, state, data, len(table), trainer.cfg.train_batch)
    prog.fill(table, lrs, rows)
    ran = 0
    for i, size in enumerate(sizes):
        prog.advance(int(size))
        ran += 1
        if not record(float(prog.losses[i])):
            break
    if trainer.has_dropblock:
        trainer.key_generator.set_state(keys_at)
        trainer.step_tables(0, ran)


def _shard_table(table: np.ndarray, rows: np.ndarray, mesh) -> tuple:
    """This rank's share of a (K, batch) table of global batches whose row
    k holds rows[k] items: each batch's items cut by shard_batch (which
    raises when the ranks do not divide a batch), as batch_iterator feeds
    the rank. Returns the (K, batch/R) table, zero-padded, and each row's
    number of items."""
    local = np.zeros((len(table), table.shape[1] // mesh.size), np.int64)
    for k, (items, n) in enumerate(zip(table, rows)):
        mine = shard_batch(items[:n], mesh)
        local[k, :len(mine)] = mine
    return local, np.asarray(rows) // mesh.size


def _cut_batches(order: np.ndarray, batch: int) -> tuple:
    """`order` cut as batch_iterator cuts it (no drop_last): a (K, batch)
    table whose last row is padded with zeros, and each row's number of
    items."""
    k = -(-len(order) // batch)
    table = np.zeros(k * batch, np.int64)
    table[:len(order)] = order
    rows = np.full(k, batch)
    rows[-1] = len(order) - (k - 1) * batch
    return table.reshape(k, batch), rows
