"""Device resolution for the port's entry points.

Every entry point (`load_model`, `WorkflowModel.score_compiled`,
`ScoringService.from_path`) takes a `device` argument that defaults to
``"cuda"``. Without a CUDA device that default raises: the port never
carries on on the CPU unless the caller asks for it with
``device="cpu"``, as the CPU tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """`device` as a `torch.device`; raises when CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
