"""HF-config introspection, from ``moe_infinity_tpu/utils/hf_config.py``:
architecture detection, MoE geometry and expert parameter-name parsing,
plus ``read_hf_config``, the port's reader of a checkpoint's
``config.json``.

The port imports no ``transformers``: ``read_hf_config`` reads the JSON
into a namespace and fills in, per family, the defaults that
``transformers``' config classes (4.57) give the fields a published
``config.json`` may leave out (``head_dim``, ``rope_theta``,
``tie_word_embeddings``, the sparse steps of Switch, ...). Every function
here reads attributes only, so it takes that namespace or an HF config
object alike.

Layer-id convention: MoE layers are numbered 0..L-1 across the whole model,
encoder sparse layers first, then decoder sparse layers; a model's raw block
index is divided by its sparse step.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

SUPPORTED_ARCHS = (
    "switch",
    "nllb",
    "mixtral",
    "grok",
    "arctic",
    "deepseek_v3",
    "deepseek",
    # dense decoder-only: the reference registers plain OPT in
    # MODEL_MAPPING_NAMES (constants.py:22) and serves it with every
    # layer treated as a dense offload unit; keep LAST so the MoE archs
    # win substring matches
    "opt",
)


@dataclass(frozen=True)
class MoEGeometry:
    """Global MoE shape of one checkpoint."""

    arch: str
    num_moe_layers: int  # encoder + decoder sparse layers
    num_experts: int  # routed experts per sparse layer
    num_encoder_moe_layers: int
    encoder_sparse_step: int = 1
    decoder_sparse_step: int = 1
    first_k_dense_replace: int = 0  # DeepSeek: leading dense layers


def detect_arch(config) -> str:
    """Map an HF config to one of SUPPORTED_ARCHS (longest match wins so
    'deepseek_v3' is preferred over 'deepseek')."""
    name = ""
    if getattr(config, "architectures", None):
        name = config.architectures[0].lower()
    if not name:
        name = getattr(config, "model_type", "").lower()
    # normalize: DeepseekV3ForCausalLM -> deepseek_v3
    if "deepseekv3" in name.replace("_", "") or "deepseek_v3" in name:
        return "deepseek_v3"
    for arch in SUPPORTED_ARCHS:
        if arch in name:
            return arch
    raise RuntimeError(
        f"Unsupported architecture {name!r}; supported: {SUPPORTED_ARCHS}"
    )


def parse_moe_param(config) -> Tuple[int, int, int]:
    """(num_moe_layers, num_experts, num_encoder_moe_layers) — same contract
    as the reference's parse_moe_param (hf_config.py:22-53)."""
    g = parse_geometry(config)
    return g.num_moe_layers, g.num_experts, g.num_encoder_moe_layers


def parse_geometry(config) -> MoEGeometry:
    arch = detect_arch(config)
    if arch == "switch":
        enc = config.num_sparse_encoder_layers
        dec = config.num_sparse_decoder_layers
        return MoEGeometry(
            arch=arch,
            num_moe_layers=enc + dec,
            num_experts=config.num_experts,
            num_encoder_moe_layers=enc,
            encoder_sparse_step=getattr(config, "encoder_sparse_step", 2),
            decoder_sparse_step=getattr(config, "decoder_sparse_step", 2),
        )
    if arch == "nllb":
        enc_step = config.encoder_sparse_step
        dec_step = config.decoder_sparse_step
        enc = config.encoder_layers // enc_step
        dec = config.decoder_layers // dec_step
        return MoEGeometry(
            arch=arch,
            num_moe_layers=enc + dec,
            num_experts=config.num_experts,
            num_encoder_moe_layers=enc,
            encoder_sparse_step=enc_step,
            decoder_sparse_step=dec_step,
        )
    if arch == "mixtral":
        return MoEGeometry(
            arch=arch,
            num_moe_layers=config.num_hidden_layers,
            num_experts=config.num_local_experts,
            num_encoder_moe_layers=0,
        )
    if arch == "arctic":
        freq = getattr(config, "moe_layer_frequency", 1) or 1
        return MoEGeometry(
            arch=arch,
            num_moe_layers=config.num_hidden_layers // freq,
            num_experts=config.num_local_experts,
            num_encoder_moe_layers=0,
            decoder_sparse_step=freq,
        )
    if arch == "grok":
        return MoEGeometry(
            arch=arch,
            num_moe_layers=config.num_hidden_layers,
            num_experts=config.num_experts,
            num_encoder_moe_layers=0,
        )
    if arch in ("deepseek", "deepseek_v3"):
        first_dense = getattr(config, "first_k_dense_replace", 0)
        step = getattr(config, "moe_layer_freq", 1) or 1
        n_moe = max(0, (config.num_hidden_layers - first_dense + step - 1) // step)
        return MoEGeometry(
            arch=arch,
            num_moe_layers=n_moe,
            num_experts=config.n_routed_experts,
            num_encoder_moe_layers=0,
            decoder_sparse_step=step,
            first_k_dense_replace=first_dense,
        )
    if arch == "opt":  # dense decoder-only: no MoE geometry at all
        return MoEGeometry(
            arch=arch, num_moe_layers=0, num_experts=0,
            num_encoder_moe_layers=0,
        )
    raise AssertionError(arch)


# One regex per arch family capturing (coder?, block_idx, expert_idx, tail).
_EXPERT_PATTERNS: Dict[str, re.Pattern] = {
    "switch": re.compile(
        r"(encoder|decoder)\.block\.(\d+)\..*?experts\.expert_(\d+)\.(.+)"
    ),
    "nllb": re.compile(
        r"(encoder|decoder)\.layers\.(\d+)\..*?experts\.expert_(\d+)\.(.+)"
    ),
    "mixtral": re.compile(
        r"layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.(.+)"
    ),
    "arctic": re.compile(
        r"layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)\.(.+)"
    ),
    "grok": re.compile(r"layers\.(\d+)\.moe_block\.experts\.(\d+)\.(.+)"),
    "deepseek": re.compile(r"layers\.(\d+)\.mlp\.experts\.(\d+)\.(.+)"),
    "deepseek_v3": re.compile(r"layers\.(\d+)\.mlp\.experts\.(\d+)\.(.+)"),
}


def parse_expert_id(
    param_name: str, config
) -> Tuple[Optional[int], Optional[int]]:
    """(global_moe_layer_id, expert_id) for an expert param, (None, None)
    otherwise. Same contract as reference parse_expert_id (hf_config.py:56-126)."""
    parsed = parse_expert_param(param_name, config)
    if parsed is None:
        return None, None
    return parsed[0], parsed[1]


def parse_expert_param(
    param_name: str, config
) -> Optional[Tuple[int, int, str]]:
    """(global_moe_layer_id, expert_id, weight_name) or None.

    weight_name is the per-expert tensor tail, e.g. 'wi.weight',
    'w1.weight', 'gate_proj.weight' — the key used by the expert store
    layout.
    """
    g = parse_geometry(config)
    if g.num_experts == 0:  # dense-only archs (opt): nothing routes
        return None
    pat = _EXPERT_PATTERNS[g.arch]
    m = pat.search(param_name)
    if not m:
        return None
    if g.arch in ("switch", "nllb"):
        coder, block, expert, tail = m.groups()
        block, expert = int(block), int(expert)
        if coder == "encoder":
            layer = block // g.encoder_sparse_step
        else:
            layer = block // g.decoder_sparse_step + g.num_encoder_moe_layers
    else:
        block, expert, tail = m.groups()
        block, expert = int(block), int(expert)
        if g.arch in ("deepseek", "deepseek_v3"):
            layer = (block - g.first_k_dense_replace) // g.decoder_sparse_step
        elif g.arch == "arctic":
            # MoE layers sit at (i+1) % freq == 0
            layer = (block + 1) // g.decoder_sparse_step - 1
        else:
            layer = block
    return layer, expert, tail


def parse_expert_dtype(config) -> str:
    """Checkpoint compute dtype as a string ('bfloat16' | 'float32' |
    'float16'). The reference returns an int enum (hf_config.py:8-19); we
    keep strings and map at the store boundary."""
    dt = getattr(config, "torch_dtype", None)
    name = str(dt).replace("torch.", "") if dt is not None else "float32"
    if name not in ("bfloat16", "float32", "float16"):
        raise ValueError(f"unknown checkpoint dtype {name}")
    return name


# ---------------------------------------------------------------------------
# config.json without transformers
# ---------------------------------------------------------------------------

# PretrainedConfig's own defaults for the fields the port reads
_BASE_DEFAULTS: Dict[str, Any] = {
    "architectures": None,
    "model_type": "",
    "tie_word_embeddings": True,
    "is_encoder_decoder": False,
    "bos_token_id": None,
    "pad_token_id": None,
    "eos_token_id": None,
    "decoder_start_token_id": None,
    "torch_dtype": None,
}

# The keyword defaults of transformers' config classes (4.57), per family.
_FAMILY_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "mixtral": {
        "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
        "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": 8, "head_dim": None, "hidden_act": "silu",
        "max_position_embeddings": 131072, "rms_norm_eps": 1e-05,
        "bos_token_id": 1, "eos_token_id": 2, "tie_word_embeddings": False,
        "rope_theta": 1000000.0, "sliding_window": None,
        "num_experts_per_tok": 2, "num_local_experts": 8,
        "router_jitter_noise": 0.0,
    },
    "deepseek": {  # DeepseekV2Config
        "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 11008,
        "num_hidden_layers": 32, "num_attention_heads": 32,
        "num_key_value_heads": None, "hidden_act": "silu",
        "max_position_embeddings": 2048, "rms_norm_eps": 1e-06,
        "bos_token_id": 1, "eos_token_id": 2, "tie_word_embeddings": False,
        "rope_theta": 10000.0, "rope_scaling": None, "first_k_dense_replace": 0,
        "kv_lora_rank": 512, "q_lora_rank": 1536, "n_group": None,
        "n_routed_experts": 64, "n_shared_experts": 2, "qk_nope_head_dim": 128,
        "qk_rope_head_dim": 64, "routed_scaling_factor": 1.0,
        "topk_group": None, "topk_method": "greedy", "v_head_dim": 128,
        "num_experts_per_tok": None, "norm_topk_prob": False,
        "moe_intermediate_size": 1407,
    },
    "deepseek_v3": {  # DeepseekV3Config
        "vocab_size": 129280, "hidden_size": 7168, "intermediate_size": 18432,
        "moe_intermediate_size": 2048, "num_hidden_layers": 61,
        "num_attention_heads": 128, "num_key_value_heads": 128,
        "n_shared_experts": 1, "n_routed_experts": 256,
        "routed_scaling_factor": 2.5, "kv_lora_rank": 512, "q_lora_rank": 1536,
        "qk_rope_head_dim": 64, "v_head_dim": 128, "qk_nope_head_dim": 128,
        "n_group": 8, "topk_group": 4, "num_experts_per_tok": 8,
        "first_k_dense_replace": 3, "norm_topk_prob": True, "hidden_act": "silu",
        "max_position_embeddings": 4096, "rms_norm_eps": 1e-06,
        "bos_token_id": 0, "eos_token_id": 1, "tie_word_embeddings": False,
        "rope_theta": 10000.0, "rope_scaling": None,
    },
    "switch": {  # SwitchTransformersConfig
        "vocab_size": 32128, "d_model": 768, "d_kv": 64, "d_ff": 2048,
        "expert_capacity": 64, "num_layers": 12, "num_sparse_encoder_layers": 3,
        "num_decoder_layers": 12, "num_sparse_decoder_layers": 3,
        "num_heads": 12, "num_experts": 8, "router_bias": False,
        "router_jitter_noise": 0.01, "router_dtype": "float32",
        "relative_attention_num_buckets": 32,
        "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-06,
        "dense_act_fn": "relu", "is_encoder_decoder": True,
        "pad_token_id": 0, "eos_token_id": 1,
    },
    "nllb": {  # NllbMoeConfig
        "vocab_size": 128112, "max_position_embeddings": 1024,
        "encoder_layers": 12, "encoder_ffn_dim": 4096,
        "encoder_attention_heads": 16, "decoder_layers": 12,
        "decoder_ffn_dim": 4096, "decoder_attention_heads": 16,
        "is_encoder_decoder": True, "activation_function": "relu",
        "d_model": 1024, "decoder_start_token_id": 2, "scale_embedding": True,
        "router_bias": False, "router_dtype": "float32", "num_experts": 128,
        "expert_capacity": 64, "encoder_sparse_step": 4,
        "decoder_sparse_step": 4, "pad_token_id": 1, "bos_token_id": 0,
        "eos_token_id": 2,
    },
    "opt": {  # OPTConfig
        "vocab_size": 50272, "hidden_size": 768, "num_hidden_layers": 12,
        "ffn_dim": 3072, "max_position_embeddings": 2048,
        "do_layer_norm_before": True, "word_embed_proj_dim": None,
        "num_attention_heads": 12, "activation_function": "relu",
        "enable_bias": True, "pad_token_id": 1, "bos_token_id": 2,
        "eos_token_id": 2,
    },
}


def read_hf_config(checkpoint: str) -> SimpleNamespace:
    """The checkpoint's ``config.json`` (``checkpoint`` is its directory or
    the file) as a namespace with ``AutoConfig``'s defaults and derived
    fields, for the families the port serves; other families get the
    JSON's fields and ``PretrainedConfig``'s defaults only."""
    path = checkpoint if os.path.isfile(checkpoint) else os.path.join(checkpoint, "config.json")
    with open(path) as f:
        raw = json.load(f)
    cfg: Dict[str, Any] = dict(_BASE_DEFAULTS)
    # newer transformers write "dtype" where older ones wrote "torch_dtype"
    if "dtype" in raw and "torch_dtype" not in raw:
        raw["torch_dtype"] = raw["dtype"]
    probe = SimpleNamespace(architectures=raw.get("architectures"),
                            model_type=raw.get("model_type", ""))
    arch = detect_arch(probe)
    cfg.update(_FAMILY_DEFAULTS.get(arch, {}))
    cfg.update(raw)
    if arch in ("mixtral", "deepseek") and cfg["num_key_value_heads"] is None:
        cfg["num_key_value_heads"] = cfg["num_attention_heads"]
    if arch == "deepseek":
        cfg["head_dim"] = cfg["qk_rope_head_dim"]
    if arch == "switch":
        if cfg["num_decoder_layers"] is None:  # an explicit null: symmetry
            cfg["num_decoder_layers"] = cfg["num_layers"]
        # SwitchTransformersConfig derives the sparse steps; a stored value,
        # set after the derivation, wins
        for side, n_all in (("encoder", cfg["num_layers"]),
                            ("decoder", cfg["num_decoder_layers"])):
            n_sparse = cfg[f"num_sparse_{side}_layers"]
            cfg.setdefault(f"{side}_sparse_step", n_all // n_sparse if n_sparse > 0 else n_all)
    if arch == "opt" and cfg["word_embed_proj_dim"] is None:
        cfg["word_embed_proj_dim"] = cfg["hidden_size"]
    return SimpleNamespace(**cfg)
