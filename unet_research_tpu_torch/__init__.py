"""unet_research_tpu_torch — the PyTorch/CUDA port of `unet_research_tpu`.

Same subpackage layout as the JAX package, one twin per module:

- `models/`       the configurable U-Net as an `nn.Module` (reference torch
                  state_dict layout), DropBlock mask sites and fold_rescale.
- `ops/`          image geometry (with the bilinear rotation), the plain
                  DropBlock ops (counter hash) and the masked BCE loss.
- `ops/cuda/`     hand-written Hopper kernels (CUDA C++, sm_90a) with their
                  plain PyTorch versions and launch counters; twin of
                  `ops/pallas/`.
- `uncertainty/`  the streaming Chan-merge ensemble, the MC-DropBlock engine
                  and the rotational TTA engine.
- `train/`        the trainer (SGD + momentum, clipping, plateau LR, early
                  stopping, best-checkpoint keeping, lr_find) and the eight
                  resize policies; data-parallel under a mesh.
- `parallel/`     the data-parallel mesh over torch.distributed, its
                  collectives, and the local rank launcher of `--devices N`.
- `data/`         the split reader (`load_split`), the in-memory uint8 split
                  and the batch feed.
- `evaluation/`   FOV metrics and the final_test_metrics harness with its
                  artifacts (numpy, scipy and torch only).
- `cli/`          the entry points: the training CLIs, the ensembles, the
                  generator and the analysis half (`--devices N` on the
                  four whose JAX twins take a mesh).
- `utils/`        JAX-params / JAX msgpack / reference-checkpoint reading,
                  the PNG reader and writer, general helpers.

Public functions keep JAX's NHWC layout. Entry points run on the card
(`device="cuda"`) unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
