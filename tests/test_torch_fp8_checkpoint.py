"""The port's fp8 loading (``moe_infinity_tpu_torch/store/fp8_block.py``, the
block-fp8 branch of ``store/ingest.py`` and fp8 tensors in a plain
checkpoint) against the JAX package's, mirroring
tests/test_fp8_checkpoint.py:

* ``pack_fp8_block``'s codes byte-equal to ``ml_dtypes``' (the JAX
  function's) and its scales equal, ragged edge blocks included;
  ``dequant_fp8_block`` byte-equal; the JAX codec tests on the port;
* ``Fp8BlockReassembler``: either order, pass-through, the unpaired error;
* tiny DeepSeek-V2 and DeepSeek-V3 (``noaux_tc``) checkpoints in the
  official layout (every attention projection, dense MLP, shared and routed
  expert as e4m3 codes plus ``weight_scale_inv`` at blocks of 16 x 24, so
  every matrix has ragged edge blocks; embeddings, head, norms and the
  router plain): stores byte-equal to the JAX ingest's at every expert
  dtype, and ``MoE.generate``'s greedy tokens equal to JAX's and to the HF
  model holding the dequantized weights;
* a plain Mixtral checkpoint holding ``F8_E4M3`` tensors (an expert's and a
  dense projection): ingested byte-equal to the JAX ingest's.

Every comparison is exact (bytes, or tokens at f32), except the JAX codec
tests' own bounds.
"""

import filecmp
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch
from transformers import AutoConfig

from moe_infinity_tpu.entrypoints.api import MoE as JMoE
from moe_infinity_tpu.store import fp8_block as jf
from moe_infinity_tpu.store.ingest import ingest_checkpoint as j_ingest
from moe_infinity_tpu.utils.dtypes import numpy_to_torch
from moe_infinity_tpu_torch.entrypoints.api import MoE
from moe_infinity_tpu_torch.store import fp8_block as pf
from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
from moe_infinity_tpu_torch.utils.hf_config import read_hf_config
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import save_tiny_checkpoint, tiny_hf_model

DTYPES = ("float32", "bfloat16", "int8", "int4", "float8_e4m3fn")
STORE_FILES = ["dense.blob", "dense.index.json", "experts.blob", "experts.index.json",
               "name_map.json"]
BLOCK = (16, 24)


def _same_bytes(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_dirs(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == STORE_FILES
    for f in STORE_FILES:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,block", [
    ((24, 40), (8, 16)), ((10, 18), (8, 16)), ((576, 300), (128, 128)), ((7, 5), (8, 16)),
], ids=["24x40", "ragged-10x18", "ragged-576x300", "one-block"])
@pytest.mark.parametrize("scale", [0.02, 300.0], ids=["std0.02", "std300"])
def test_pack_and_dequant_equal_jax(shape, block, scale):
    rng = np.random.default_rng(shape[0])
    w = (rng.normal(size=shape) * scale).astype(np.float32)
    w[0, 0] = 0.0
    q, s = jf.pack_fp8_block(w, block)
    pq, ps = pf.pack_fp8_block(w, block)
    assert q.dtype == ml_dtypes.float8_e4m3fn and pq.dtype == np.uint8
    _same_bytes(pq, q.view(np.uint8))
    _same_bytes(ps, s)
    _same_bytes(pf.dequant_fp8_block(pq, ps, block), jf.dequant_fp8_block(q, s, block))
    # the same packing from a tensor, on its device
    tq, ts = pf.pack_fp8_block(torch.from_numpy(w), block)
    _same_bytes(tq.numpy(), pq)
    _same_bytes(ts.numpy(), ps)
    # float values (not codes) dequantize as JAX's astype(f32) does
    f = q.astype(np.float32)
    _same_bytes(pf.dequant_fp8_block(f, ps, block), jf.dequant_fp8_block(f, s, block))


@pytest.mark.parametrize("row", ["normal", "subnormal-1e-41", "subnormal-1e-44", "nan", "inf",
                                 "zero"])
def test_quantize_rowwise_fp8_edge_rows_equal_jax(row):
    """The per-channel e4m3 quantizer the ingest runs after dequantizing,
    byte-equal to JAX's on rows whose scaled values leave e4m3's range
    (subnormal scales, NaN, inf) as on ordinary ones."""
    from moe_infinity_tpu.store import quant as jq
    from moe_infinity_tpu_torch.store import quant as pq

    w = np.random.default_rng(0).standard_normal((4, 40)).astype(np.float32)
    edit = {"normal": 1.0, "subnormal-1e-41": 1e-41, "subnormal-1e-44": 1e-44}
    if row in edit:
        w[1] *= np.float32(edit[row])
    elif row == "zero":
        w[1] = 0
    else:
        w[1, 3] = np.nan if row == "nan" else np.inf
    with np.errstate(invalid="ignore", divide="ignore"):
        q, s = jq.quantize_rowwise(w, "float8_e4m3fn")
    pq_, ps = pq.quantize_rowwise(w, "float8_e4m3fn")
    _same_bytes(pq_, q.view(np.uint8))
    _same_bytes(ps, s)


def test_roundtrip_is_fixed_point():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(24, 40)).astype(np.float32)
    q, s = pf.pack_fp8_block(w, block=(8, 16))
    assert q.shape == w.shape and s.shape == (3, 3)
    d1 = pf.dequant_fp8_block(q, s, (8, 16))
    d2 = pf.dequant_fp8_block(*pf.pack_fp8_block(d1, block=(8, 16)), (8, 16))
    np.testing.assert_allclose(d1, d2, rtol=1e-6, atol=1e-6)
    assert np.abs(d1 - w).max() < np.abs(w).max() * 0.1


def test_config_equals_jax():
    class Cfg:
        pass

    c = Cfg()
    assert pf.fp8_block_config(c) is None
    for qc in ({"quant_method": "fp8", "weight_block_size": [8, 16]},
               {"quant_method": "fp8"}, {"quant_method": "gptq"},
               {"quant_method": "fp8", "fmt": "e4m3", "weight_block_size": [128, 128]}):
        c.quantization_config = qc
        assert pf.fp8_block_config(c) == jf.fp8_block_config(c)


@pytest.mark.parametrize("order", [("w", "s"), ("s", "w")])
def test_reassembler_either_order_equals_jax(order):
    rng = np.random.default_rng(2)
    q, s = jf.pack_fp8_block(rng.normal(size=(10, 18)).astype(np.float32), block=(8, 16))
    outs = []
    for mod, codes in ((jf, q), (pf, q.view(np.uint8))):
        asm = mod.Fp8BlockReassembler({"block": (8, 16)})
        out = []
        for item in order:
            if item == "w":
                out += list(asm.feed("m.w1.weight", codes, True))
            else:
                out += list(asm.feed("m.w1.weight_scale_inv", s, False))
        out += list(asm.feed("m.norm.weight", np.ones(4, np.float32), False))
        out += list(asm.flush())
        outs.append(out)
    want, got = outs
    assert [n for n, _ in got] == [n for n, _ in want] == ["m.w1.weight", "m.norm.weight"]
    for (_, x), (_, y) in zip(got, want):
        _same_bytes(x, y)


def test_unpaired_raises_as_jax():
    for mod in (jf, pf):
        asm = mod.Fp8BlockReassembler({"block": (8, 16)})
        list(asm.feed("m.w1.weight", np.zeros((8, 16), np.uint8), True))
        list(asm.feed("m.w2.weight_scale_inv", np.ones((1, 1), np.float32), False))
        with pytest.raises(RuntimeError, match=r"unpaired FP8.*m\.w1.*m\.w2"):
            asm.flush()


# ---------------------------------------------------------------------------
# tiny DeepSeek-V2 / V3 checkpoints in the official block-fp8 layout
# ---------------------------------------------------------------------------


def _tiny_deepseek(version):
    if version == "v2":
        return tiny_hf_model("deepseek", seed=17)
    from transformers import DeepseekV3Config, DeepseekV3ForCausalLM

    # as tests/test_deepseek_v3_parity.py builds it
    cfg = DeepseekV3Config(
        vocab_size=128, hidden_size=64, intermediate_size=96, moe_intermediate_size=48,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4, q_lora_rank=32,
        kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
        head_dim=16, n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
        n_group=4, topk_group=2, first_k_dense_replace=1, norm_topk_prob=True,
        routed_scaling_factor=2.5, max_position_embeddings=128, torch_dtype=torch.float32,
        architectures=["DeepseekV3ForCausalLM"], attention_bias=False, rope_interleave=True)
    torch.manual_seed(31)
    hf = DeepseekV3ForCausalLM(cfg).eval()
    with torch.no_grad():  # a nonzero correction bias exercises the noaux path
        for layer in hf.model.layers[1:]:
            layer.mlp.gate.e_score_correction_bias.uniform_(-0.2, 0.2)
    return cfg, hf


def _quantized(name, t):
    """The official layout's fp8 linears: every 2-D ``.weight`` but the
    embeddings, the head and the router."""
    return (t.ndim == 2 and name.endswith(".weight") and "embed_tokens" not in name
            and "lm_head" not in name and not name.endswith("mlp.gate.weight"))


@pytest.fixture(scope="module", params=["v2", "v3"])
def deepseek_fp8(request, tmp_path_factory):
    """(checkpoint path, HF model holding the dequantized weights)."""
    from safetensors.torch import save_file

    cfg, hf = _tiny_deepseek(request.param)
    state = {}
    for name, t in hf.state_dict().items():
        if _quantized(name, t):
            q, s = jf.pack_fp8_block(t.numpy(), block=BLOCK)
            state[name] = numpy_to_torch(q)
            state[name[: -len(".weight")] + ".weight_scale_inv"] = torch.from_numpy(s)
            with torch.no_grad():
                t.copy_(torch.from_numpy(jf.dequant_fp8_block(q, s, BLOCK)))
        else:
            state[name] = t.clone()
    assert any(n.endswith("kv_a_proj_with_mqa.weight_scale_inv") for n in state)
    ckpt = tmp_path_factory.mktemp(f"dsfp8-{request.param}") / "ckpt"
    ckpt.mkdir()
    save_file(state, str(ckpt / "model.safetensors"), metadata={"format": "pt"})
    cfg_dict = cfg.to_dict()
    cfg_dict["quantization_config"] = {"quant_method": "fp8", "fmt": "e4m3",
                                       "weight_block_size": list(BLOCK)}
    with open(ckpt / "config.json", "w") as f:
        json.dump(cfg_dict, f)
    return str(ckpt), hf


@pytest.mark.parametrize("dtype", DTYPES)
def test_deepseek_store_byte_equal_to_jax(deepseek_fp8, tmp_path, dtype):
    ckpt, _ = deepseek_fp8
    j_meta = j_ingest(ckpt, str(tmp_path / "jax"), AutoConfig.from_pretrained(ckpt),
                      expert_dtype=dtype)
    p_meta = ingest_checkpoint(ckpt, str(tmp_path / "port"), read_hf_config(ckpt),
                               expert_dtype=dtype)
    assert p_meta == j_meta
    _same_dirs(tmp_path / "jax", tmp_path / "port")


def test_deepseek_generate_equals_jax_and_dequantized_hf(deepseek_fp8, tmp_path):
    ckpt, hf = deepseek_fp8
    cfg = {"expert_dtype": "float32", "max_seq_len": 64}
    prompt = np.array([[5, 31, 8, 77]])
    with torch.no_grad():
        want = hf.generate(torch.tensor(prompt), max_new_tokens=8, do_sample=False,
                           pad_token_id=0).numpy()
    j = JMoE(ckpt, dict(cfg, offload_path=str(tmp_path / "jax")))
    p = MoE(ckpt, dict(cfg, offload_path=str(tmp_path / "port")), device="cpu")
    try:
        got = p.generate(prompt, max_new_tokens=8)
        np.testing.assert_array_equal(got, j.generate(prompt, max_new_tokens=8))
        np.testing.assert_array_equal(got, want)
    finally:
        j.shutdown()
        p.shutdown()


# ---------------------------------------------------------------------------
# fp8 tensors in a plain checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plain_fp8_ckpt(tmp_path_factory):
    from safetensors.torch import load_file, save_file

    from moe_infinity_tpu_torch.utils.checkpoints import get_checkpoint_paths

    root = tmp_path_factory.mktemp("plain_fp8")
    ckpt, _ = save_tiny_checkpoint("mixtral", root / "bf16", dtype=torch.bfloat16, seed=3)
    out = root / "fp8"
    out.mkdir()
    n = 0
    for path in get_checkpoint_paths(ckpt)[0]:
        tensors = load_file(path)
        for name in tensors:
            if ".experts.0.w1." in name or "layers.1.self_attn.o_proj" in name:
                tensors[name] = tensors[name].to(torch.float8_e4m3fn)
                n += 1
        save_file(tensors, str(out / os.path.basename(path)), metadata={"format": "pt"})
    assert n == 3  # expert 0's w1 in both layers and one dense projection
    for f in ("config.json", "model.safetensors.index.json"):
        (out / f).write_bytes(open(os.path.join(ckpt, f), "rb").read())
    return str(out)


@pytest.mark.parametrize("dense_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_checkpoint_fp8_tensors_byte_equal_to_jax(plain_fp8_ckpt, tmp_path, dtype,
                                                        dense_dtype):
    ckpt = plain_fp8_ckpt
    j_ingest(ckpt, str(tmp_path / "jax"), AutoConfig.from_pretrained(ckpt), expert_dtype=dtype,
             dense_dtype=dense_dtype)
    ingest_checkpoint(ckpt, str(tmp_path / "port"), read_hf_config(ckpt), expert_dtype=dtype,
                      dense_dtype=dense_dtype)
    _same_dirs(tmp_path / "jax", tmp_path / "port")
