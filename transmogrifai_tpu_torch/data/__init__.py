from transmogrifai_tpu_torch.data.columns import Column, kind_of
from transmogrifai_tpu_torch.data.metadata import (
    VectorColumnMetadata, VectorMetadata)
from transmogrifai_tpu_torch.data.dataset import Dataset

__all__ = ["Column", "kind_of", "VectorColumnMetadata", "VectorMetadata",
           "Dataset"]
