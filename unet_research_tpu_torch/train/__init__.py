"""Training: the trainer, SGD state, schedules, resize policies and
checkpoints."""

from unet_research_tpu_torch.train.checkpoint import (
    BestCheckpointKeeper,
    find_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from unet_research_tpu_torch.train.loop import Trainer, TrainerConfig, lr_find
from unet_research_tpu_torch.train.policies import POLICIES, ResizePolicy, lf_policy, make_size_plan
from unet_research_tpu_torch.train.schedule import EarlyStopping, ReduceLROnPlateau
from unet_research_tpu_torch.train.state import TrainState, create_train_state

__all__ = ["BestCheckpointKeeper", "EarlyStopping", "POLICIES", "ReduceLROnPlateau",
           "ResizePolicy", "TrainState", "Trainer", "TrainerConfig", "create_train_state",
           "find_checkpoint",
           "lf_policy", "load_checkpoint", "lr_find", "make_size_plan", "save_checkpoint"]
