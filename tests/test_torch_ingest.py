"""The port's loading path against the JAX package's, mirroring
tests/test_ingest.py, tests/test_hf_config.py, tests/test_config.py and the
DenseArchive parts of tests/test_store.py:

* ``store/ingest.py``: for tiny HF Mixtral, DeepSeek-V2, Switch and NLLB
  checkpoints, sharded, in safetensors and in ``.bin``, the port writes a
  store byte-equal to the JAX ingest's (index files, expert records, dense
  blob, name map) at f32, bf16, int8, int4 and float8_e4m3fn; a warm start
  writes nothing; GPTQ at 3 bits and an unknown expert dtype raise (GPTQ,
  block-fp8 and fp8 tensors: tests/test_torch_gptq.py and
  tests/test_torch_fp8_checkpoint.py);
* ``utils/checkpoints.py``: the port's safetensors reader is byte-equal to
  ``safetensors.safe_open``;
* ``utils/hf_config.py``: ``read_hf_config`` gives the same geometry, expert
  layout and model ``Spec`` as the JAX package's ``AutoConfig`` path, from a
  full ``config.json``, from one with only a published config's fields and
  from a minimal one;
* ``store/blob.py::DenseArchive`` and ``load_params`` of each family: the
  port's param tree equals the JAX model's;
* ``utils/config.py::EngineConfig``: the JAX fields and defaults, JSON round
  trip, validation.
"""

import dataclasses
import filecmp
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import AutoConfig

from moe_infinity_tpu.common.arch import expert_layout as j_layout
from moe_infinity_tpu.store.blob import DenseArchive as JDense
from moe_infinity_tpu.store.ingest import ingest_checkpoint as j_ingest
from moe_infinity_tpu.utils import hf_config as jhc
from moe_infinity_tpu.utils.config import EngineConfig as JConfig
from moe_infinity_tpu_torch.common.arch import expert_layout as p_layout
from moe_infinity_tpu_torch.store.blob import DenseArchive, DenseArchiveWriter, store_exists
from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
from moe_infinity_tpu_torch.utils import hf_config as phc
from moe_infinity_tpu_torch.utils.checkpoints import get_checkpoint_paths, iter_safetensors
from moe_infinity_tpu_torch.utils.config import EngineConfig
from torch_port_helpers import HF_FAMILIES, jax_to_numpy, one_intra_op_thread  # noqa: F401
from torch_port_helpers import save_tiny_checkpoint

DTYPES = ("float32", "bfloat16", "int8", "int4", "float8_e4m3fn")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One sharded tiny checkpoint per (family, format), bf16 weights for
    safetensors (bf16 records stay raw bits end to end) and f32 for .bin."""
    root = tmp_path_factory.mktemp("ingest_ckpts")
    out = {}
    for fam in HF_FAMILIES:
        for safe in (True, False):
            dtype = torch.bfloat16 if safe else torch.float32
            out[fam, safe] = save_tiny_checkpoint(fam, root / f"{fam}-{safe}", safe=safe,
                                                  dtype=dtype, seed=3)[0]
    return out


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert names == ["dense.blob", "dense.index.json", "experts.blob", "experts.index.json",
                     "name_map.json"]
    for f in names:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
@pytest.mark.parametrize("family", HF_FAMILIES)
def test_store_byte_equal_to_jax(checkpoints, tmp_path, family, safe, dtype):
    ckpt = checkpoints[family, safe]
    paths, is_safe = get_checkpoint_paths(ckpt)
    assert is_safe == safe and len(paths) > 1  # sharded, through the index
    j_meta = j_ingest(ckpt, str(tmp_path / "jax"), AutoConfig.from_pretrained(ckpt),
                      expert_dtype=dtype)
    p_meta = ingest_checkpoint(ckpt, str(tmp_path / "port"), phc.read_hf_config(ckpt),
                               expert_dtype=dtype)
    assert p_meta == j_meta
    _same_dirs(tmp_path / "jax", tmp_path / "port")


def test_warm_start_writes_nothing(checkpoints, tmp_path):
    ckpt = checkpoints["mixtral", True]
    cfg = phc.read_hf_config(ckpt)
    meta = ingest_checkpoint(ckpt, str(tmp_path), cfg, expert_dtype="int8")
    assert store_exists(str(tmp_path))
    stamps = {f: os.stat(tmp_path / f).st_mtime_ns for f in os.listdir(tmp_path)}
    # a warm start returns the stored meta whatever dtype is asked for, as JAX's
    assert ingest_checkpoint(ckpt, str(tmp_path), cfg, expert_dtype="bfloat16") == meta
    assert j_ingest(ckpt, str(tmp_path), AutoConfig.from_pretrained(ckpt),
                    expert_dtype="bfloat16") == meta
    assert stamps == {f: os.stat(tmp_path / f).st_mtime_ns for f in os.listdir(tmp_path)}
    forced = ingest_checkpoint(ckpt, str(tmp_path), cfg, expert_dtype="int4", force=True)
    assert forced["expert_dtype"] == "int4"


def test_safetensors_reader_equals_safe_open(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {
        "b.weight": torch.randn(5, 7, generator=g).to(torch.bfloat16),
        "a.bias": torch.randn(7, generator=g),
        "c.half": torch.randn(3, 2, 2, generator=g).half(),
        "d.ids": torch.arange(6, dtype=torch.int64).reshape(2, 3),
        "e.q": torch.randint(-128, 127, (4, 4), generator=g, dtype=torch.int8),
        "f.scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = list(iter_safetensors(path))
    with safe_open(path, framework="pt") as f:
        assert [n for n, _, _ in got] == list(f.keys())
        for name, arr, store in got:
            t = f.get_tensor(name)
            want = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
                else t.numpy()
            assert arr.dtype == want.dtype and arr.shape == want.shape, name
            assert arr.tobytes() == want.tobytes(), name
            assert store == {"b.weight": "bfloat16", "a.bias": "float32", "c.half": "float16",
                             "d.ids": "int64", "e.q": "int8", "f.scalar": "float32"}[name]


def test_unported_checkpoints_raise(checkpoints, tmp_path):
    """What the port's ingest still refuses, as JAX's does: GPTQ at a width
    other than 2/4/8 bits (``NotImplementedError`` from ``dequant_gptq``)
    and an expert dtype the store has no kind for (``ValueError``; JAX's
    fails at its first record). GPTQ and block-fp8 checkpoints and fp8
    tensors are served: tests/test_torch_gptq.py and
    tests/test_torch_fp8_checkpoint.py."""
    from safetensors.torch import load_file, save_file

    from moe_infinity_tpu.store.gptq import pack_gptq

    ckpt = checkpoints["mixtral", True]
    gptq_dir = tmp_path / "gptq3"
    gptq_dir.mkdir()
    for path in get_checkpoint_paths(ckpt)[0]:
        tensors = {}
        for n, t in load_file(path).items():
            if ".experts.0.w1." in n:
                for comp, arr in pack_gptq(t.float().numpy(), bits=4, group_size=16).items():
                    tensors[n[: -len(".weight")] + "." + comp] = torch.from_numpy(
                        np.ascontiguousarray(arr))
            else:
                tensors[n] = t
        save_file(tensors, str(gptq_dir / os.path.basename(path)), metadata={"format": "pt"})
    (gptq_dir / "model.safetensors.index.json").write_bytes(
        open(os.path.join(ckpt, "model.safetensors.index.json"), "rb").read())
    cfg = json.load(open(os.path.join(ckpt, "config.json")))
    cfg["quantization_config"] = {"quant_method": "gptq", "bits": 3, "group_size": 16}
    (gptq_dir / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(NotImplementedError, match="GPTQ bits=3"):
        ingest_checkpoint(str(gptq_dir), str(tmp_path / "a"), phc.read_hf_config(str(gptq_dir)))
    with pytest.raises(NotImplementedError, match="GPTQ bits=3"):
        j_ingest(str(gptq_dir), str(tmp_path / "j"), AutoConfig.from_pretrained(str(gptq_dir)))
    with pytest.raises(ValueError, match="unsupported expert_dtype 'int2'"):
        ingest_checkpoint(ckpt, str(tmp_path / "b"), phc.read_hf_config(ckpt), expert_dtype="int2")
    assert not os.path.exists(tmp_path / "b")


# ---------------------------------------------------------------------------
# config.json -> the same geometry and Spec as JAX's AutoConfig path
# ---------------------------------------------------------------------------

# the key sets of published config.json files (Mixtral-8x7B-v0.1,
# DeepSeek-V2-Lite, switch-base-8, nllb-moe-54b) at tiny widths
PUBLISHED = {
    "mixtral": {
        "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0,
        "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 32,
        "initializer_range": 0.02, "intermediate_size": 64, "max_position_embeddings": 128,
        "model_type": "mixtral", "num_attention_heads": 4, "num_experts_per_tok": 2,
        "num_hidden_layers": 2, "num_key_value_heads": 2, "num_local_experts": 4,
        "output_router_logits": False, "rms_norm_eps": 1e-05, "rope_theta": 1000000.0,
        "router_aux_loss_coef": 0.02, "sliding_window": None, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16", "transformers_version": "4.36.0.dev0", "use_cache": True,
        "vocab_size": 128,
    },
    "deepseek": {
        "architectures": ["DeepseekV2ForCausalLM"], "attention_bias": False,
        "attention_dropout": 0.0, "aux_loss_alpha": 0.001, "bos_token_id": 100000,
        "eos_token_id": 100001, "first_k_dense_replace": 1, "hidden_act": "silu",
        "hidden_size": 64, "initializer_range": 0.02, "intermediate_size": 96,
        "kv_lora_rank": 32, "max_position_embeddings": 163840, "model_type": "deepseek_v2",
        "moe_intermediate_size": 48, "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 8,
        "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 4,
        "num_experts_per_tok": 2, "num_hidden_layers": 3, "num_key_value_heads": 4,
        "pretraining_tp": 1, "q_lora_rank": None, "qk_nope_head_dim": 32,
        "qk_rope_head_dim": 16, "rms_norm_eps": 1e-06,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                         "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                         "type": "yarn"},
        "rope_theta": 10000, "routed_scaling_factor": 1.0, "scoring_func": "softmax",
        "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1,
        "topk_method": "greedy", "torch_dtype": "bfloat16", "transformers_version": "4.39.3",
        "use_cache": True, "v_head_dim": 32, "vocab_size": 128,
    },
    "switch": {
        "architectures": ["SwitchTransformersForConditionalGeneration"], "d_ff": 64,
        "d_kv": 8, "d_model": 32, "decoder_sparse_step": 2, "decoder_start_token_id": 0,
        "dense_act_fn": "relu", "dropout_rate": 0.1, "encoder_sparse_step": 2,
        "eos_token_id": 1, "expert_capacity": 64, "initializer_factor": 1.0,
        "is_encoder_decoder": True, "is_gated_act": False, "layer_norm_epsilon": 1e-06,
        "model_type": "switch_transformers", "num_decoder_layers": 4, "num_experts": 8,
        "num_heads": 4, "num_layers": 4, "num_sparse_decoder_layers": 2,
        "num_sparse_encoder_layers": 2, "pad_token_id": 0,
        "relative_attention_max_distance": 128, "relative_attention_num_buckets": 32,
        "router_aux_loss_coef": 0.001, "router_bias": False, "router_dtype": "float32",
        "router_ignore_padding_tokens": False, "router_jitter_noise": 0.01,
        "router_type": "tokens_masked", "router_z_loss_coef": 0.001, "torch_dtype": "float32",
        "transformers_version": "4.26.0.dev0", "use_cache": True, "vocab_size": 128,
    },
    "nllb": {
        "activation_dropout": 0.0, "activation_function": "relu",
        "architectures": ["NllbMoeForConditionalGeneration"], "attention_dropout": 0.1,
        "batch_prioritized_routing": True, "bos_token_id": 0, "d_model": 32,
        "decoder_attention_heads": 4, "decoder_ffn_dim": 64, "decoder_layerdrop": 0.0,
        "decoder_layers": 4, "decoder_sparse_step": 4, "decoder_start_token_id": 2,
        "dropout": 0.1, "encoder_attention_heads": 4, "encoder_ffn_dim": 64,
        "encoder_layerdrop": 0.0, "encoder_layers": 4, "encoder_sparse_step": 4,
        "eos_token_id": 2, "expert_capacity": 64, "init_std": 0.02, "is_encoder_decoder": True,
        "max_position_embeddings": 1024, "model_type": "nllb-moe",
        "moe_eval_capacity_token_fraction": 1.0, "moe_token_dropout": 0.2,
        "normalize_router_prob_before_dropping": False, "num_experts": 8,
        "num_hidden_layers": 4, "output_router_logits": False, "pad_token_id": 1,
        "router_aux_loss_coef": 0.001, "router_bias": False, "router_dtype": "float32",
        "router_ignore_padding_tokens": False, "router_z_loss_coef": 0.001,
        "scale_embedding": True, "second_expert_policy": "all", "torch_dtype": "float32",
        "transformers_version": "4.27.0.dev0", "use_cache": True, "vocab_size": 128,
    },
}

# the fields a geometry needs and nothing else: every default comes in
MINIMAL_KEYS = {
    "mixtral": ("architectures", "model_type", "hidden_size", "intermediate_size",
                "num_hidden_layers", "num_attention_heads", "num_local_experts",
                "vocab_size"),
    "deepseek": ("architectures", "model_type", "hidden_size", "intermediate_size",
                 "moe_intermediate_size", "num_hidden_layers", "num_attention_heads",
                 "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
                 "n_routed_experts", "num_experts_per_tok", "q_lora_rank", "vocab_size"),
    "switch": ("architectures", "model_type", "d_model", "d_kv", "d_ff", "num_layers",
               "num_heads", "num_experts", "num_sparse_encoder_layers",
               "num_sparse_decoder_layers", "decoder_start_token_id", "vocab_size"),
    "nllb": ("architectures", "model_type", "d_model", "encoder_layers", "decoder_layers",
             "encoder_ffn_dim", "decoder_ffn_dim", "num_experts", "vocab_size"),
}

_SPECS = {
    "mixtral": ("moe_infinity_tpu.models.mixtral", "moe_infinity_tpu_torch.models.mixtral",
                "MixtralSpec"),
    "deepseek": ("moe_infinity_tpu.models.deepseek_v2",
                 "moe_infinity_tpu_torch.models.deepseek_v2", "DeepseekV2Spec"),
    "switch": ("moe_infinity_tpu.models.switch", "moe_infinity_tpu_torch.models.switch",
               "SwitchSpec"),
    "nllb": ("moe_infinity_tpu.models.nllb", "moe_infinity_tpu_torch.models.nllb", "NllbSpec"),
}


def _config_variant(family, variant, tmp_path, checkpoints):
    if variant == "full":
        return checkpoints[family, True]
    raw = PUBLISHED[family]
    if variant == "minimal":
        raw = {k: raw[k] for k in MINIMAL_KEYS[family]}
    d = tmp_path / f"{family}-{variant}"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(raw))
    return str(d)


@pytest.mark.parametrize("variant", ["full", "published", "minimal"])
@pytest.mark.parametrize("family", HF_FAMILIES)
def test_config_reader_gives_autoconfigs_spec(checkpoints, tmp_path, family, variant):
    import importlib

    path = _config_variant(family, variant, tmp_path, checkpoints)
    auto, ours = AutoConfig.from_pretrained(path), phc.read_hf_config(path)
    assert phc.detect_arch(ours) == jhc.detect_arch(auto)
    assert phc.parse_geometry(ours) .__dict__ == jhc.parse_geometry(auto).__dict__
    assert phc.parse_moe_param(ours) == jhc.parse_moe_param(auto)
    assert phc.parse_expert_dtype(ours) == jhc.parse_expert_dtype(auto)
    assert dataclasses.asdict(p_layout(ours)) == dataclasses.asdict(j_layout(auto))
    jmod, pmod, name = _SPECS[family]
    jspec = getattr(importlib.import_module(jmod), name).from_hf(auto)
    pspec = getattr(importlib.import_module(pmod), name).from_hf(ours)
    assert dataclasses.asdict(pspec) == dataclasses.asdict(jspec)
    assert getattr(ours, "eos_token_id", None) == getattr(auto, "eos_token_id", None)


def test_expert_param_parsing_equals_jax(checkpoints):
    for fam in HF_FAMILIES:
        ckpt = checkpoints[fam, True]
        auto, ours = AutoConfig.from_pretrained(ckpt), phc.read_hf_config(ckpt)
        with open(os.path.join(ckpt, "model.safetensors.index.json")) as f:
            names = sorted(json.load(f)["weight_map"])
        parsed = [phc.parse_expert_param(n, ours) for n in names]
        assert parsed == [jhc.parse_expert_param(n, auto) for n in names]
        assert [phc.parse_expert_id(n, ours) for n in names] == \
            [jhc.parse_expert_id(n, auto) for n in names]
        assert sum(p is not None for p in parsed) > 0
    for name in ("DeepseekV3ForCausalLM", "GrokForCausalLM", "ArcticForCausalLM",
                 "OPTForCausalLM", "NllbMoeForConditionalGeneration"):
        cfg = type("C", (), {"architectures": [name]})
        assert phc.detect_arch(cfg) == jhc.detect_arch(cfg)
    with pytest.raises(RuntimeError, match="Unsupported"):
        phc.detect_arch(type("C", (), {"architectures": ["LlamaForCausalLM"]}))


# ---------------------------------------------------------------------------
# DenseArchive and load_params
# ---------------------------------------------------------------------------


def test_dense_archive_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"a": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.integers(0, 2**16, (7,), dtype=np.uint16),  # bf16 bits
              "c": rng.normal(size=(2, 2, 2)).astype(np.float16)}
    w = DenseArchiveWriter(str(tmp_path))
    for n, a in arrays.items():
        w.write(n, a)
    w.finalize()
    arc, jarc = DenseArchive(str(tmp_path)), JDense(str(tmp_path))
    assert arc.names() == jarc.names() == list(arrays)
    assert "a" in arc and "z" not in arc
    for n, a in arrays.items():
        np.testing.assert_array_equal(arc.get(n), a)
        assert arc.get(n).tobytes() == np.asarray(jarc.get(n)).tobytes()
    assert arc.tensor("b").dtype == torch.bfloat16
    assert torch.equal(arc.tensor("b").view(torch.int16),
                       torch.from_numpy(arrays["b"].view(np.int16)))


_MODELS = {
    "mixtral": ("moe_infinity_tpu.models.mixtral", "MixtralModel", "MixtralSpec",
                "moe_infinity_tpu_torch.models.mixtral", "MixtralModel"),
    "deepseek": ("moe_infinity_tpu.models.deepseek_v2", "DeepseekV2ModelJax", "DeepseekV2Spec",
                 "moe_infinity_tpu_torch.models.deepseek_v2", "DeepseekV2Model"),
    "switch": ("moe_infinity_tpu.models.switch", "SwitchModel", "SwitchSpec",
               "moe_infinity_tpu_torch.models.switch", "SwitchModel"),
    "nllb": ("moe_infinity_tpu.models.nllb", "NllbModel", "NllbSpec",
             "moe_infinity_tpu_torch.models.nllb", "NllbModel"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", HF_FAMILIES)
def test_load_params_equals_jax(checkpoints, tmp_path, family, dtype):
    import importlib

    from moe_infinity_tpu_torch import bridge

    ckpt = checkpoints[family, True]
    ingest_checkpoint(ckpt, str(tmp_path), phc.read_hf_config(ckpt), expert_dtype="int8",
                      dense_dtype=dtype)
    jm_name, jcls, sname, pm_name, pcls = _MODELS[family]
    jmod, pmod = importlib.import_module(jm_name), importlib.import_module(pm_name)
    jdt, pdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jparams = getattr(jmod, jcls)(getattr(jmod, sname).from_hf(AutoConfig.from_pretrained(ckpt)),
                                  jdt).load_params(JDense(str(tmp_path)))
    pmodel = getattr(pmod, pcls)(getattr(pmod, sname).from_hf(phc.read_hf_config(ckpt)), pdt,
                                 device="cpu")
    pparams = pmodel.load_params(DenseArchive(str(tmp_path)))
    want, got = jax_to_numpy(jparams), bridge.to_numpy(pparams)

    def walk(a, b, where):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), where
            for k in a:
                walk(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{where}[{i}]")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, where
            assert a.tobytes() == b.tobytes(), where

    walk(want, got, family)


# ---------------------------------------------------------------------------
# EngineConfig
# ---------------------------------------------------------------------------


def test_engine_config_fields_and_defaults_equal_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(EngineConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    c = EngineConfig()
    assert c.moe_impl == "ragged" and c.trace_capacity == 1000 and c.prefetch is True
    assert c.to_json() == JConfig().to_json()


def test_engine_config_json_roundtrip(tmp_path):
    c = EngineConfig(offload_path="/tmp/x", device_memory_ratio=0.5, num_slots=16,
                     moe_impl="pallas", expert_dtype="int8")
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(c.to_json()))
    assert EngineConfig.load_from_file(str(p)) == c
    assert JConfig.load_from_file(str(p)).to_json() == c.to_json()
    with pytest.raises(ValueError, match="unknown"):
        EngineConfig.load_from_json({"not_a_key": 1})


@pytest.mark.parametrize("bad", [
    dict(device_memory_ratio=0.0), dict(host_memory_ratio=1.5), dict(expert_dtype="int2"),
    dict(moe_impl="magic"), dict(prefill_impl="magic"), dict(load_mode="tape"),
    dict(dense_paging="maybe"), dict(s2s_batcher="burst"), dict(max_batch_size=0),
    dict(kv_page_size=0), dict(num_slots=0), dict(speculative_tokens=-1),
])
def test_engine_config_validation(bad):
    with pytest.raises(ValueError):
        EngineConfig(**bad)
