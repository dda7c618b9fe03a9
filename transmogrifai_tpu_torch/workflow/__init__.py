from transmogrifai_tpu_torch.workflow.serialization import (
    ModelIntegrityError, from_jax_params, load_model, verify_model_dir)
from transmogrifai_tpu_torch.workflow.workflow import Workflow, WorkflowModel

__all__ = ["ModelIntegrityError", "Workflow", "WorkflowModel",
           "from_jax_params", "load_model", "verify_model_dir"]
