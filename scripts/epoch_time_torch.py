"""Training seconds per epoch of the PyTorch/CUDA port under -conv_impl xla
and pair (the twin of scripts/epoch_time.py).

Each arm runs the training CLI (unet_research_tpu_torch.cli.training.main)
with epoch_time.py's flags: -mode train, -num_epochs E, -seed 1234,
--precision bf16, --auto_lr_find False, and -conv_impl xla (cuDNN
everywhere) or pair (the hand-written K3, its dx and the fold); both arms
draw their DropBlock masks with K2. The model is the canonical 31M U-Net
(batch 1, remat), each epoch one CUDA graph of the step replayed.

Usage:
    EPOCH_DATA=AUG python3 scripts/epoch_time_torch.py [epochs=3] [training flags...]

EPOCH_DATA is an augmented tree with train/val/test splits, such as
create_augmentations writes; it is required. Flags after the epoch count go
to both arms' CLI (e.g. `-device cpu -filters 4 -model_depth 2
-group_norm_groups 2` for a CPU run of a tiny model). The run's output
goes to a temporary directory that is removed afterwards.

Per arm it prints epoch_time.py's `[epoch_time] arm=... total=...s` line,
then one JSON line: the seconds of the whole command and of each epoch
(an epoch from the start of its training steps to the start of the next
epoch's, validation and the checkpoint included), the mean seconds per
epoch after the first (which holds the capture), the final epoch's train
loss, the kernel launches and the card (its name and power limit; null on
the CPU).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.roofline import power_limit  # noqa: E402
from unet_research_tpu_torch.cli import training  # noqa: E402
from unet_research_tpu_torch.ops.cuda import launches  # noqa: E402
from unet_research_tpu_torch.train import Trainer  # noqa: E402

ARMS = ("xla", "pair")


def epoch_data(env=os.environ) -> str:
    data = env.get("EPOCH_DATA")
    if not data:
        raise SystemExit("epoch_time_torch: set EPOCH_DATA to an augmented tree with train, "
                         "val and test splits (as create_augmentations writes)")
    if not os.path.isdir(data):
        raise SystemExit(f"epoch_time_torch: EPOCH_DATA={data} is not a directory")
    return data


@contextlib.contextmanager
def epoch_clock():
    """While active, record when each training epoch of Trainer.fit starts
    (its scanned or stepped epoch is called), when fit returns, and fit's
    history."""
    rec = {"starts": [], "end": None, "history": None}
    saved = {name: getattr(Trainer, name) for name in ("fit", "train_epoch_scan", "_step_epoch")}

    def started(fn):
        def epoch(*args, **kwargs):
            rec["starts"].append(time.perf_counter())
            return fn(*args, **kwargs)
        return epoch

    def fit(*args, **kwargs):
        out = saved["fit"](*args, **kwargs)
        rec["end"], rec["history"] = time.perf_counter(), out[1]
        return out

    Trainer.fit = fit
    Trainer.train_epoch_scan = started(saved["train_epoch_scan"])
    Trainer._step_epoch = started(saved["_step_epoch"])
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(Trainer, name, fn)


def run_arm(conv_impl: str, data: str, epochs: int, extra=()) -> dict:
    """One arm: the training CLI on `data` for `epochs` epochs."""
    before = launches.snapshot()
    with tempfile.TemporaryDirectory() as tmp, epoch_clock() as rec:
        t0 = time.perf_counter()
        training.main(["-mode", "train", "-data_path", data,
                       "-save_path", os.path.join(tmp, f"epoch_time_{conv_impl}"),
                       "-num_epochs", str(epochs), "-seed", "1234", "-conv_impl", conv_impl,
                       "--precision", "bf16", "--auto_lr_find", "False", *extra])
        total = time.perf_counter() - t0
    marks = rec["starts"] + [rec["end"]]
    epoch_s = [b - a for a, b in zip(marks, marks[1:])]
    print(f"[epoch_time] arm={conv_impl} total={total:.1f}s", flush=True)
    return {"arm": conv_impl, "epochs": epochs, "total_s": total, "epoch_s": epoch_s,
            "s_per_epoch_after_first": (sum(epoch_s[1:]) / (len(epoch_s) - 1)
                                        if len(epoch_s) > 1 else None),
            "final_train_loss": rec["history"]["train_loss_epoch"][-1],
            "launches": launches.since(before)}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    epochs = int(argv[0]) if argv else 3
    extra = list(argv[1:])
    data = epoch_data()
    on_cpu = "-device" in extra and extra[extra.index("-device") + 1] == "cpu"
    card = None if on_cpu else power_limit()
    for conv_impl in ARMS:
        row = run_arm(conv_impl, data, epochs, extra)
        print(json.dumps({**row, "card": card}), flush=True)


if __name__ == "__main__":
    main()
