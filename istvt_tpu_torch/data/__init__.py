"""Data (counterpart of istvt_tpu/data): the synthetic clip dataset and a
synchronous ClipLoader. The real datasets and loader workers are
ROADMAP.md queue 1 work ('Training')."""
from istvt_tpu_torch.data.loader import ClipLoader  # noqa: F401
from istvt_tpu_torch.data.video_dataset import (  # noqa: F401
    SyntheticVideoDataset)
