"""Pipeline orchestration (capture → segment → register → pick)."""

from tpu3d_torch.pipeline.dedup import filter_duplicates
from tpu3d_torch.pipeline.pipeline import Pipeline

__all__ = ["Pipeline", "filter_duplicates"]
