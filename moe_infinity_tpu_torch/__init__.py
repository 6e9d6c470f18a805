"""moe_infinity_tpu_torch: the PyTorch + CUDA port of moe_infinity_tpu.

The port runs on an NVIDIA Hopper GPU. Its hot kernels (flash decode, flash
attention, paged decode, absorbed-MLA decode and the grouped matmul with
fused dequantisation) are CUDA C++ under ``csrc/``, built with
``nvcc`` at first use; every kernel has a plain PyTorch version beside it,
which is what runs for CPU tensors. Entry points run on ``"cuda"`` unless the
caller passes ``device="cpu"``.
"""

import torch

__all__ = ["MoE", "resolve_device"]


def __getattr__(name):
    # ``from moe_infinity_tpu_torch import MoE``: the entry point, imported
    # on first use (its module imports this package)
    if name == "MoE":
        from moe_infinity_tpu_torch.entrypoints.api import MoE

        return MoE
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent
    (nothing drops to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
