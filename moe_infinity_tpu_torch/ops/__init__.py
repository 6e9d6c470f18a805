"""Kernels of the port and their plain PyTorch versions."""


def _tables() -> tuple:
    from moe_infinity_tpu_torch.ops import flash_attention, gmm, stream

    return flash_attention.LAUNCHES, gmm.LAUNCHES, stream.LAUNCHES


def launch_counts() -> dict:
    """Launches of each CUDA kernel since the last reset_launches()."""
    return {k: n for counts in _tables() for k, n in counts.items()}


def reset_launches() -> None:
    for counts in _tables():
        for k in counts:
            counts[k] = 0


def add_launches(counts: dict) -> None:
    """Add ``counts`` to the launch counts: a CUDA graph adds the launches
    counted while it was captured at each replay, and takes them back from
    the capture itself, which runs nothing (``runtime/graphs.py``)."""
    tables = _tables()
    for k, n in counts.items():
        next(t for t in tables if k in t)[k] += n
