"""Evaluation: FOV metrics, the final_test_metrics harness and its
artifacts."""

from unet_research_tpu_torch.evaluation.metrics import (
    dice_score,
    final_test_metrics,
    get_accuracy_metrics,
)

__all__ = ["dice_score", "final_test_metrics", "get_accuracy_metrics"]
