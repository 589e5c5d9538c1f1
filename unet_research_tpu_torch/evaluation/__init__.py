"""Evaluation: FOV metrics, the final_test_metrics harness and its
artifacts, the density analysis (KDE on the card) and the host rasters."""

from unet_research_tpu_torch.evaluation.density import create_density_report, render_density_report
from unet_research_tpu_torch.evaluation.metrics import (
    dice_score,
    final_test_metrics,
    get_accuracy_metrics,
)

__all__ = ["create_density_report", "dice_score", "final_test_metrics", "get_accuracy_metrics",
           "render_density_report"]
