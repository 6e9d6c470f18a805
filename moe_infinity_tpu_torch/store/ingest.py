"""Checkpoint ingest: HF shards -> expert-major blob store + dense archive,
from ``moe_infinity_tpu/store/ingest.py``.

One fixed-stride record per (layer, expert), so a whole expert streams with
one aligned read and one copy. Expert 2-D weights are stored transposed
into compute layout ([in, out]); quantized experts keep a per-output-channel
f32 scale beside them (``store/quant.py``). Dense matrices are cast to the
dense dtype, 1-D tensors to f32. The files are byte-equal to the JAX
ingest's for the same checkpoint.

Ingest is idempotent: a finished store (``store_exists``) is a warm start
and is not rewritten unless ``force``.

Tensors come from the port's own readers (``utils/checkpoints.py``): the
safetensors format by memory map, ``.bin`` by ``torch.load``. Experts are
stored as ``float32``/``bfloat16``/``float16`` or quantized row-wise to
``int8``, ``int4`` or ``float8_e4m3fn`` (``store/quant.py``). Quantized
checkpoints are dequantized to f32 as their tensors stream in: DeepSeek-V3's
block-fp8 (``store/fp8_block.py``) and GPTQ (``store/gptq.py``); an fp8
tensor of any other checkpoint is read as its f32 values.
"""

from __future__ import annotations

import json
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch

from moe_infinity_tpu_torch.common.arch import expert_layout
from moe_infinity_tpu_torch.store.blob import DenseArchiveWriter, ExpertStoreWriter, store_exists
from moe_infinity_tpu_torch.store.fp8_block import Fp8BlockReassembler, fp8_block_config
from moe_infinity_tpu_torch.store.gptq import GPTQ_COMPONENTS, GptqReassembler, gptq_config
from moe_infinity_tpu_torch.store.quant import quantize_rowwise
from moe_infinity_tpu_torch.utils.checkpoints import iter_checkpoint_arrays
from moe_infinity_tpu_torch.utils.dtypes import bf16_bits, fp8_values, to_tensor
from moe_infinity_tpu_torch.utils.hf_config import detect_arch, parse_expert_param, parse_geometry
from moe_infinity_tpu_torch.utils.logger import get_logger

logger = get_logger("ingest")

QUANT_DTYPES = ("int8", "int4", "float8_e4m3fn")
EXPERT_DTYPES = ("float32", "bfloat16", "float16") + QUANT_DTYPES


def _check_supported(expert_dtype: str) -> None:
    if expert_dtype not in EXPERT_DTYPES:
        raise ValueError(f"unsupported expert_dtype {expert_dtype!r}")


def _as_f32(a: np.ndarray, dtype: str) -> np.ndarray:
    """float32 values of an array of store dtype ``dtype`` (bf16 from its
    bits and fp8 from its codes, exactly)."""
    if dtype == "bfloat16":
        return to_tensor(a, dtype).float().numpy()
    if dtype == "float8_e4m3fn":
        return fp8_values(a)
    return np.asarray(a, dtype=np.float32)


def _iter_model_tensors(checkpoint: str, config):
    """(name, array, store dtype name) of the checkpoint's tensors, with
    quantized linears reconstructed as plain f32 ``.weight`` tensors:
    DeepSeek-V3's block-fp8 checkpoints, then GPTQ's packed 2/4/8-bit ones,
    else the plain stream. Each linear is emitted when its last tensor
    arrives, so the dense archive's order is the JAX ingest's."""
    f8cfg = fp8_block_config(config)
    if f8cfg is not None:
        logger.info("FP8 block-quantized checkpoint (block=%s): dequantizing at ingest",
                    f8cfg["block"])
        asm8 = Fp8BlockReassembler(f8cfg)
        for name, arr, src in iter_checkpoint_arrays(checkpoint):
            is_fp8 = src == "float8_e4m3fn"
            is_scale = name.endswith(Fp8BlockReassembler.SCALE_SUFFIX)
            if is_scale or is_fp8 and name.endswith(".weight"):
                # the codes as uint8, the scales as f32 (bf16 from its bits)
                part = _as_f32(arr, src) if is_scale else arr
                for out_name, out in asm8.feed(name, part, is_fp8):
                    yield out_name, out, "float32"
            else:  # what the reassembler passes through as it comes
                yield name, arr, src
        for out_name, out in asm8.flush():
            yield out_name, out, "float32"
        return

    qcfg = gptq_config(config)
    if qcfg is None:
        yield from iter_checkpoint_arrays(checkpoint)
        return
    logger.info("GPTQ checkpoint detected (bits=%d group_size=%d): dequantizing at ingest",
                qcfg["bits"], qcfg["group_size"])
    asm = GptqReassembler(qcfg)
    for name, arr, src in iter_checkpoint_arrays(checkpoint):
        if any(name.endswith("." + c) for c in GPTQ_COMPONENTS):
            if name.endswith(".scales"):
                arr = _as_f32(arr, src)  # fp16 as numpy holds it; bf16 from its bits
            for out_name, out in asm.feed(name, arr):
                yield out_name, out, "float32"
        else:
            yield name, arr, src
    for out_name, out in asm.flush():
        yield out_name, out, "float32"


_SAME_SIZE = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}


def _transposed(a: np.ndarray) -> np.ndarray:
    """``np.ascontiguousarray(a.T)`` of a 2-D array, copied by torch (a
    blocked copy on the intra-op threads; numpy's is slow for one-byte
    dtypes): the same bytes."""
    v = a.view(_SAME_SIZE[a.itemsize])
    t = torch.from_numpy(v if v.flags.writeable else v.copy())
    return t.T.contiguous().numpy().view(a.dtype)


def _cast_np(a: np.ndarray, src: str, dtype: str) -> np.ndarray:
    """``a`` (store dtype ``src``) in store dtype ``dtype``, through f32 as the
    JAX ingest casts; an array already of that dtype is returned as is."""
    if src == dtype:
        return a
    f = _as_f32(a, src)
    if dtype == "bfloat16":
        return bf16_bits(f)
    return f.astype(np.float16 if dtype == "float16" else np.float32)


_EXPERT_THREADS = 4  # expert tensors in flight (each op also uses torch's intra-op threads)


def _expert_arrays(arr: np.ndarray, src: str, expert_dtype: str):
    """[(field suffix, array)] of one expert tensor as the record stores it:
    a 2-D weight transposed into compute layout ([in, out]), quantized with a
    per-output-channel scale (``.scale``) for a quantized store dtype."""
    if expert_dtype in QUANT_DTYPES and arr.ndim == 2:
        q, scale = quantize_rowwise(_as_f32(arr, src), expert_dtype)
        return [("", _transposed(q)), (".scale", scale)]
    a = _cast_np(arr, src, expert_dtype if expert_dtype not in QUANT_DTYPES else "bfloat16")
    return [("", _transposed(a) if a.ndim == 2 else a)]


def _expert_fields(layout, expert_dtype: str):
    """Record field list for one expert given the storage dtype."""
    fields = []
    for spec in layout.tensors:
        if expert_dtype in QUANT_DTYPES and len(spec.shape) == 2:
            shape = spec.shape
            if expert_dtype == "int4":  # packed: out axis halves
                shape = (shape[0], shape[1] // 2)
            fields.append((spec.name, shape, expert_dtype))
            # per-output-channel scale; out dim is shape[1] in compute layout
            fields.append((spec.name + ".scale", (spec.shape[1],), "float32"))
        else:
            dt = expert_dtype if expert_dtype not in QUANT_DTYPES else "bfloat16"
            fields.append((spec.name, spec.shape, dt))
    return fields


def ingest_checkpoint(
    checkpoint: str,
    offload_path: str,
    config,
    expert_dtype: str = "bfloat16",
    dense_dtype: str = "bfloat16",
    force: bool = False,
) -> Dict[str, object]:
    """Convert an HF checkpoint into the offload store. Returns the store
    meta dict. A warm start (the store already exists) returns its meta and
    writes nothing, unless ``force``."""
    if store_exists(offload_path) and not force:
        logger.info("store already present at %s (warm start)", offload_path)
        with open(os.path.join(offload_path, "experts.index.json")) as f:
            return json.load(f)["meta"]
    _check_supported(expert_dtype)

    arch = detect_arch(config)
    geometry = parse_geometry(config)
    layout = expert_layout(config)
    meta = {
        "arch": arch,
        "num_moe_layers": geometry.num_moe_layers,
        "num_experts": geometry.num_experts,
        "num_encoder_moe_layers": geometry.num_encoder_moe_layers,
        "expert_dtype": expert_dtype,
        "dense_dtype": dense_dtype,
        "activation": layout.activation,
        "gated": layout.gated,
        "tensor_names": list(layout.names),
    }

    writer = ExpertStoreWriter(
        offload_path,
        geometry.num_moe_layers,
        geometry.num_experts,
        _expert_fields(layout, expert_dtype),
        meta=meta,
    )
    dense_writer = DenseArchiveWriter(offload_path)
    name_map: Dict[str, list] = {}
    n_expert_tensors = 0
    n_dense = 0

    # expert tensors are quantized and transposed on a few threads while the
    # stream goes on; their writes, like every other write, stay in order here
    pending: deque = deque()

    def write_pending(keep: int) -> None:
        while len(pending) > keep:
            layer, expert, tail, fut = pending.popleft()
            for suffix, a in fut.result():
                writer.write_tensor(layer, expert, tail + suffix, a)

    with ThreadPoolExecutor(_EXPERT_THREADS) as pool:
        for name, arr, src in _iter_model_tensors(checkpoint, config):
            parsed = parse_expert_param(name, config)
            if parsed is not None:
                layer, expert, tail = parsed
                pending.append((layer, expert, tail,
                                pool.submit(_expert_arrays, arr, src, expert_dtype)))
                write_pending(_EXPERT_THREADS)
                name_map[name] = ["expert", layer, expert, tail]
                n_expert_tensors += 1
            else:
                # small norm/bias tensors stay f32; matrices take the dense dtype
                dt = dense_dtype if arr.ndim >= 2 else "float32"
                dense_writer.write(name, _cast_np(arr, src, dt))
                name_map[name] = ["dense"]
                n_dense += 1
        write_pending(0)

    missing = int((~writer._written).sum())
    if missing:
        missing_ids = np.argwhere(~writer._written)[:8].tolist()
        raise RuntimeError(
            f"{missing} expert records missing after ingest, e.g. {missing_ids}"
        )
    writer.finalize()
    dense_writer.finalize()
    with open(os.path.join(offload_path, "name_map.json"), "w") as f:
        json.dump(name_map, f)
    logger.info(
        "ingested %d expert tensors (%d experts) + %d dense tensors -> %s",
        n_expert_tensors,
        geometry.num_moe_layers * geometry.num_experts,
        n_dense,
        offload_path,
    )
    return meta
