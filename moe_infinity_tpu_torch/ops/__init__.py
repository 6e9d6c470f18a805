"""Kernels of the port and their plain PyTorch versions."""


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset_launches()."""
    from moe_infinity_tpu_torch.ops import flash_attention, gmm

    return {**flash_attention.LAUNCHES, **gmm.LAUNCHES}


def reset_launches() -> None:
    from moe_infinity_tpu_torch.ops import flash_attention, gmm

    for counts in (flash_attention.LAUNCHES, gmm.LAUNCHES):
        for k in counts:
            counts[k] = 0
