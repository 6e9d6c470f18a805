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
``int8``, ``int4`` or ``float8_e4m3fn`` (``store/quant.py``). GPTQ and
block-fp8 checkpoints, and fp8 tensors in a checkpoint, raise (ROADMAP
queue-1 item 14).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from moe_infinity_tpu_torch.common.arch import expert_layout
from moe_infinity_tpu_torch.store.blob import DenseArchiveWriter, ExpertStoreWriter, store_exists
from moe_infinity_tpu_torch.store.quant import quantize_rowwise
from moe_infinity_tpu_torch.utils.checkpoints import iter_checkpoint_arrays
from moe_infinity_tpu_torch.utils.dtypes import bf16_bits, to_tensor
from moe_infinity_tpu_torch.utils.hf_config import detect_arch, parse_expert_param, parse_geometry
from moe_infinity_tpu_torch.utils.logger import get_logger

logger = get_logger("ingest")

QUANT_DTYPES = ("int8", "int4", "float8_e4m3fn")
EXPERT_DTYPES = ("float32", "bfloat16", "float16") + QUANT_DTYPES


def _quant_method(config):
    qc = getattr(config, "quantization_config", None)
    if qc is None:
        return None
    if not isinstance(qc, dict):
        qc = qc.to_dict() if hasattr(qc, "to_dict") else vars(qc)
    return qc.get("quant_method")


def _check_supported(config, expert_dtype: str) -> None:
    if expert_dtype not in EXPERT_DTYPES:
        raise ValueError(f"unsupported expert_dtype {expert_dtype!r}")
    method = _quant_method(config)
    if method == "gptq":
        raise NotImplementedError(
            "GPTQ checkpoints are not ported (ROADMAP queue-1 item 14: store/gptq.py)"
        )
    if method == "fp8":
        raise NotImplementedError(
            "block-fp8 checkpoints are not ported (ROADMAP queue-1 item 14: "
            "store/fp8_block.py)"
        )


def _as_f32(a: np.ndarray, dtype: str) -> np.ndarray:
    """float32 values of an array of store dtype ``dtype`` (bf16 from its
    bits, exactly)."""
    if dtype == "bfloat16":
        return to_tensor(a, dtype).float().numpy()
    if dtype in ("float8_e4m3fn",):
        raise NotImplementedError(
            "fp8 checkpoint tensors are not ported (ROADMAP queue-1 item 14)"
        )
    return a.astype(np.float32)


def _cast_np(a: np.ndarray, src: str, dtype: str) -> np.ndarray:
    """``a`` (store dtype ``src``) in store dtype ``dtype``, through f32 as the
    JAX ingest casts; an array already of that dtype is returned as is."""
    if src == dtype:
        return a
    f = _as_f32(a, src)
    if dtype == "bfloat16":
        return bf16_bits(f)
    return f.astype(np.float16 if dtype == "float16" else np.float32)


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
    _check_supported(config, expert_dtype)

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

    for name, arr, src in iter_checkpoint_arrays(checkpoint):
        parsed = parse_expert_param(name, config)
        if parsed is not None:
            layer, expert, tail = parsed
            # expert 2-D weights go transposed into compute layout ([in, out]);
            # scales stay per output channel (common/arch.py)
            if expert_dtype in QUANT_DTYPES and arr.ndim == 2:
                q, scale = quantize_rowwise(_as_f32(arr, src), expert_dtype)
                writer.write_tensor(layer, expert, tail, np.ascontiguousarray(q.T))
                writer.write_tensor(layer, expert, tail + ".scale", scale)
            else:
                dt = expert_dtype if expert_dtype not in QUANT_DTYPES else "bfloat16"
                a = _cast_np(arr, src, dt)
                if a.ndim == 2:
                    a = np.ascontiguousarray(a.T)
                writer.write_tensor(layer, expert, tail, a)
            name_map[name] = ["expert", layer, expert, tail]
            n_expert_tensors += 1
        else:
            # small norm/bias tensors stay f32; matrices take the dense dtype
            dt = dense_dtype if arr.ndim >= 2 else "float32"
            dense_writer.write(name, _cast_np(arr, src, dt))
            name_map[name] = ["dense"]
            n_dense += 1

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
