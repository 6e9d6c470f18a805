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


def add_launches(counts: dict) -> None:
    """Add ``counts`` to the launch counts: a CUDA graph adds the launches
    counted while it was captured at each replay, and takes them back from
    the capture itself, which runs nothing (``runtime/graphs.py``)."""
    from moe_infinity_tpu_torch.ops import flash_attention, gmm

    for k, n in counts.items():
        table = gmm.LAUNCHES if k in gmm.LAUNCHES else flash_attention.LAUNCHES
        table[k] += n
