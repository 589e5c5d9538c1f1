"""Named spans around the port's host phases, recorded by torch.profiler.

`span(name)` marks one phase of the engines or the trainer. While a
torch.profiler is recording, it is the profiler's own
`record_function("unet." + name)`, so the span lands on the profiler's
timeline beside the device operations and the CUDA runtime calls, on the
profiler's clock: a profiled window and the chrome trace that
`Trainer.fit(profiler='trace')` writes carry the spans with no sink,
exporter or clock mapping of their own. Otherwise it is one shared no-op
context: the path with the profiler off is one flag check, with no
allocation and no clock read.

Spans nest as the calls do, and a span's parent is the innermost span open
around it. A request is the order of the spans: the k-th root span of a
window (`unet.engine.predict`, `unet.trainer.epoch`) is its k-th image or
epoch, and the k-th `unet.trainer.step` inside an epoch is its k-th step.

Spans wrap host code only. A span inside a function that a CUDA graph
captures (a step program's step, an ensemble program's step, the members'
forward) would record once, at the capture, and never on a replay; none is
put there.

The spans (the metric of benchmark/metrics/ that reads each, where one
does; the others are for an operator's trace):

- `engine.predict`: an engine's predict, the root of one image;
- `engine.input`, `engine.keys`, `engine.fill`: the inputs' placement, the
  MC engine's site-key draws, the copies into the program's buffers;
- `engine.host_chunk`, `engine.body`, `engine.finish`: a chunk run from
  the host with its merge, the program's body chunks, the std and saved;
- `trainer.epoch`: a scanned or stepped epoch, the root of one epoch;
- `trainer.fill`, `trainer.step`, `trainer.losses`: a step program's
  tables, the host's issue of one step, the losses' read-back;
- `trainer.validate`, `trainer.checkpoint`, `trainer.lr_find`: fit's
  validation and checkpoint, the learning-rate sweep;
- `graph.capture`, `graph.warmup`: a CUDA graph's capture and the eager
  warm-up runs before it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the span `unet.<name>` while a profiler is
    recording, else the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function("unet." + name)
