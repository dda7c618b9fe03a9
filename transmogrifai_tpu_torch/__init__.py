"""transmogrifai_tpu_torch — the PyTorch/CUDA port of transmogrifai_tpu.

This package serves models that the JAX package (`transmogrifai_tpu`)
trained and saved: it loads the saved directory, plans the fitted feature
DAG into host and device segments, and scores batches on an NVIDIA GPU
(Hopper), with the tree-ensemble binning and walk as kernels written by
hand in CUDA C++ (`csrc/`). It imports torch and numpy and nothing of the
JAX package.

    from transmogrifai_tpu_torch import Dataset, load_model
    model = load_model("model_dir")              # device="cuda" by default
    scores = model.score_compiled(Dataset.from_csv("rows.csv"))

Entry points default to ``device="cuda"`` and raise without CUDA unless
the caller passes ``device="cpu"``.
"""

from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.workflow.serialization import (
    from_jax_params, load_model)
from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel

__all__ = ["Dataset", "WorkflowModel", "from_jax_params", "load_model"]
