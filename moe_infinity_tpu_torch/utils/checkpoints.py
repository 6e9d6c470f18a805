"""Checkpoint discovery and reading, from
``moe_infinity_tpu/utils/checkpoints.py``: resolve a model path into an
ordered list of weight shards (safetensors preferred, torch ``.bin``
accepted), and read the shards' tensors as numpy arrays.

The port reads the safetensors format itself (the card's machine has no
``safetensors`` package): an 8-byte little-endian header length, a JSON
header of ``{name: {"dtype", "shape", "data_offsets"}}`` (plus an optional
``__metadata__``), then the raw bytes, which ``numpy.memmap`` maps without
copying. bf16 stays raw ``uint16`` bits, as ``utils/dtypes.py`` holds it.
``.bin`` shards go through ``torch.load(mmap=True, weights_only=True)``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
WEIGHTS_NAME = "pytorch_model.bin"
WEIGHTS_INDEX_NAME = "pytorch_model.bin.index.json"


def get_checkpoint_paths(checkpoint: str) -> Tuple[List[str], bool]:
    """Return (ordered shard paths, is_safetensors).

    `checkpoint` may be a single weights file, an index json, or a model
    directory containing either.
    """
    if os.path.isfile(checkpoint):
        if checkpoint.endswith(".index.json"):
            return _from_index(checkpoint)
        return [checkpoint], checkpoint.endswith(".safetensors")

    if not os.path.isdir(checkpoint):
        raise FileNotFoundError(f"checkpoint not found: {checkpoint}")

    for index_name in (SAFE_WEIGHTS_INDEX_NAME, WEIGHTS_INDEX_NAME):
        index_path = os.path.join(checkpoint, index_name)
        if os.path.isfile(index_path):
            return _from_index(index_path)

    for name in (SAFE_WEIGHTS_NAME, WEIGHTS_NAME):
        path = os.path.join(checkpoint, name)
        if os.path.isfile(path):
            return [path], name.endswith(".safetensors")

    # Fall back to any sharded files present without an index.
    entries = sorted(os.listdir(checkpoint))
    safes = [e for e in entries if e.endswith(".safetensors")]
    if safes:
        return [os.path.join(checkpoint, e) for e in safes], True
    bins = [e for e in entries if e.endswith(".bin") and "arguments" not in e]
    if bins:
        return [os.path.join(checkpoint, e) for e in bins], False
    raise FileNotFoundError(f"no weight files under {checkpoint}")


def _from_index(index_path: str) -> Tuple[List[str], bool]:
    with open(index_path) as f:
        index = json.load(f)
    folder = os.path.dirname(index_path)
    shards = sorted(set(index["weight_map"].values()))
    paths = [os.path.join(folder, s) for s in shards]
    return paths, all(p.endswith(".safetensors") for p in paths)


# safetensors dtype -> (numpy dtype, store dtype name); bf16 as its bits
_SAFE_DTYPES = {
    "F64": (np.float64, "float64"),
    "F32": (np.float32, "float32"),
    "F16": (np.float16, "float16"),
    "BF16": (np.uint16, "bfloat16"),
    "I64": (np.int64, "int64"),
    "I32": (np.int32, "int32"),
    "I16": (np.int16, "int16"),
    "I8": (np.int8, "int8"),
    "U8": (np.uint8, "uint8"),
    "BOOL": (np.bool_, "bool"),
    "F8_E4M3": (np.uint8, "float8_e4m3fn"),
}

_TORCH_NP = {
    torch.float64: "float64",
    torch.float32: "float32",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.int64: "int64",
    torch.int32: "int32",
    torch.int16: "int16",
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.bool: "bool",
}
# dtypes numpy lacks travel as their bits: (torch view, numpy view)
_BITS = {torch.bfloat16: (torch.int16, np.uint16)}
if hasattr(torch, "float8_e4m3fn"):
    _TORCH_NP[torch.float8_e4m3fn] = "float8_e4m3fn"
    _BITS[torch.float8_e4m3fn] = (torch.uint8, np.uint8)


def read_safetensors_header(path: str) -> Tuple[Dict[str, dict], int]:
    """(tensor entries without ``__metadata__``, byte offset of the data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def iter_safetensors(path: str) -> Iterator[Tuple[str, np.ndarray, str]]:
    """(name, read-only array, store dtype name) for every tensor of one
    safetensors file, in name order (the order of ``safe_open.keys()``).
    Arrays are views of one memory map of the file."""
    header, base = read_safetensors_header(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    for name in sorted(header):
        e = header[name]
        if e["dtype"] not in _SAFE_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unknown dtype {e['dtype']!r}")
        np_dt, store = _SAFE_DTYPES[e["dtype"]]
        lo, hi = e["data_offsets"]
        raw = mm[base + lo: base + hi]
        yield name, raw.view(np_dt).reshape(e["shape"]), store


def tensor_to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array, store dtype name) of a CPU tensor, sharing its memory; bf16
    as its ``uint16`` bits, fp8 as its bytes."""
    t = t.detach().contiguous()
    if t.dtype in _BITS:
        tview, nview = _BITS[t.dtype]
        return t.view(tview).numpy().view(nview), _TORCH_NP[t.dtype]
    return t.numpy(), _TORCH_NP[t.dtype]


def iter_checkpoint_arrays(checkpoint: str) -> Iterator[Tuple[str, np.ndarray, str]]:
    """(name, array, store dtype name) across every shard of a checkpoint,
    in shard order: safetensors by memory map, ``.bin`` by ``torch.load``
    with ``mmap=True``."""
    paths, is_safetensors = get_checkpoint_paths(checkpoint)
    for path in paths:
        if is_safetensors:
            yield from iter_safetensors(path)
        else:
            state = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
            for name, tensor in state.items():
                arr, store = tensor_to_numpy(tensor)
                yield name, arr, store
            del state
