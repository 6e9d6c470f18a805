"""Per-architecture expert tensor layouts and role names, from
``moe_infinity_tpu/common/arch.py``.

``expert_layout`` is the table the ingest (record layout) reads. Shapes are
in **compute layout**: every 2-D expert weight is stored transposed from the
HF Linear layout, i.e. as [in_features, out_features], the right-hand side
K3 and the grouped FFN consume ([groups, in, out]); ingest pays the one
transpose. Quantization scales stay per *output* channel: shape
(out_features,) = stored shape[1].

``FFN_ROLES`` maps the canonical roles of the MoE blocks onto the store's
tensor tails; 'up' is None for non-gated FFNs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from moe_infinity_tpu_torch.utils.hf_config import detect_arch


@dataclass(frozen=True)
class ExpertTensorSpec:
    name: str  # param tail after 'experts.<e>.', e.g. 'w1.weight'
    shape: Tuple[int, ...]  # compute layout: 2-D weights are [in, out]


@dataclass(frozen=True)
class ArchExpertLayout:
    arch: str
    tensors: Tuple[ExpertTensorSpec, ...]
    activation: str  # 'relu' | 'gelu' | 'silu' — expert FFN nonlinearity
    gated: bool

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tensors)

    def numel(self) -> int:
        total = 0
        for t in self.tensors:
            n = 1
            for d in t.shape:
                n *= d
            total += n
        return total


def expert_layout(config) -> ArchExpertLayout:
    """Build the expert tensor layout for one checkpoint config."""
    arch = detect_arch(config)
    if arch == "switch":
        # Experts are always DenseActDense (wi/wo) — HF's SparseMLP never
        # uses the gated class even when is_gated_act (the gated FF applies
        # to dense layers only); activation follows dense_act_fn.
        d_model, d_ff = config.d_model, config.d_ff
        act = getattr(config, "dense_act_fn", "relu")
        activation = "gelu_tanh" if act in ("gelu_new", "gelu") else "relu"
        tensors = (
            ExpertTensorSpec("wi.weight", (d_model, d_ff)),
            ExpertTensorSpec("wo.weight", (d_ff, d_model)),
        )
        return ArchExpertLayout(arch, tensors, activation, False)
    if arch == "nllb":
        d_model, d_ff = config.d_model, config.encoder_ffn_dim
        tensors = (
            ExpertTensorSpec("fc1.weight", (d_model, d_ff)),
            ExpertTensorSpec("fc1.bias", (d_ff,)),
            ExpertTensorSpec("fc2.weight", (d_ff, d_model)),
            ExpertTensorSpec("fc2.bias", (d_model,)),
        )
        return ArchExpertLayout(arch, tensors, "relu", False)
    if arch in ("mixtral", "arctic"):
        d_model = config.hidden_size
        d_ff = config.intermediate_size
        tensors = (
            ExpertTensorSpec("w1.weight", (d_model, d_ff)),
            ExpertTensorSpec("w2.weight", (d_ff, d_model)),
            ExpertTensorSpec("w3.weight", (d_model, d_ff)),
        )
        return ArchExpertLayout(arch, tensors, "silu", True)
    if arch == "grok":
        d_model = config.hidden_size
        d_ff = config.intermediate_size
        tensors = (
            ExpertTensorSpec("linear.weight", (d_model, d_ff)),
            ExpertTensorSpec("linear_1.weight", (d_ff, d_model)),
            ExpertTensorSpec("linear_v.weight", (d_model, d_ff)),
        )
        return ArchExpertLayout(arch, tensors, "gelu", True)
    if arch in ("deepseek", "deepseek_v3"):
        d_model = config.hidden_size
        d_ff = config.moe_intermediate_size
        tensors = (
            ExpertTensorSpec("gate_proj.weight", (d_model, d_ff)),
            ExpertTensorSpec("up_proj.weight", (d_model, d_ff)),
            ExpertTensorSpec("down_proj.weight", (d_ff, d_model)),
        )
        return ArchExpertLayout(arch, tensors, "silu", True)
    if arch == "opt":  # dense decoder-only: no expert tensors at all
        return ArchExpertLayout(arch, (), "relu", False)
    raise AssertionError(arch)


FFN_ROLES: Dict[str, Dict[str, Optional[str]]] = {
    "switch": {"gate_or_in": "wi.weight", "up": None, "down": "wo.weight"},
    "switch_gated": {
        "gate_or_in": "wi_0.weight",
        "up": "wi_1.weight",
        "down": "wo.weight",
    },
    "nllb": {"gate_or_in": "fc1.weight", "up": None, "down": "fc2.weight"},
    "mixtral": {"gate_or_in": "w1.weight", "up": "w3.weight", "down": "w2.weight"},
    "arctic": {"gate_or_in": "w1.weight", "up": "w3.weight", "down": "w2.weight"},
    "grok": {
        "gate_or_in": "linear.weight",
        "up": "linear_v.weight",
        "down": "linear_1.weight",
    },
    "deepseek": {
        "gate_or_in": "gate_proj.weight",
        "up": "up_proj.weight",
        "down": "down_proj.weight",
    },
    "deepseek_v3": {
        "gate_or_in": "gate_proj.weight",
        "up": "up_proj.weight",
        "down": "down_proj.weight",
    },
}


# TP x EP: which dim of each STACKED expert array ([slots, ...]) shards over
# the `model` mesh axis (the d_ff hidden dim). Keys absent here (down_bias
# [S, d_model], down_scale) replicate across the model axis. The fused
# 'gateup' and the packed int4 '<role>4' arrays are listed as the JAX
# package lists them, but the port's ``parallel/mesh.py`` refuses to cut
# them: a slice of [gate | up] would mix the two halves, and a slice of a
# split-nibble array holds columns that are not the slice of `down`'s rows.
TP_MODEL_DIMS: Dict[str, int] = {
    "gate": 2,
    "up": 2,
    "gateup": 2,
    "down": 1,
    "gate_bias": 1,
    "gate4": 2,
    "up4": 2,
    "gateup4": 2,
    "down4": 1,
    "gate_scale": 1,
    "up_scale": 1,
    "gateup_scale": 1,
}
