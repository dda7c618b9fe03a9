from transmogrifai_tpu_torch.serving.batcher import (
    ScoreError, bucket_for, bucket_ladder)
from transmogrifai_tpu_torch.serving.service import (
    ScoreResult, ScoringService, ServingConfig)

__all__ = ["ScoreError", "ScoreResult", "ScoringService", "ServingConfig",
           "bucket_for", "bucket_ladder"]
