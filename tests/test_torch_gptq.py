"""The port's GPTQ loading (``moe_infinity_tpu_torch/store/gptq.py`` and the
GPTQ branch of ``store/ingest.py``) against the JAX package's, mirroring
tests/test_gptq.py:

* ``pack_gptq``, ``dequant_gptq`` and the unpack helpers byte-equal to
  JAX's at bits 2/4/8, v1 and v2, ``g_idx`` None and permuted (act-order);
  the JAX codec tests on the port's functions;
* ``GptqReassembler``: the emitted names and arrays equal JAX's for
  components arriving in every order, interleaved across two linears, and
  the same error for an incomplete group;
* a tiny GPTQ Mixtral (attention and expert linears packed, two shards with
  a linear's components split between them): ``experts.blob``,
  ``dense.blob``, both indices and ``name_map.json`` byte-equal to the JAX
  ingest's, at bits 2/4/8, v1/v2 and act-order;
* ``MoE.generate``'s greedy tokens equal to JAX's ``MoE`` and to the HF
  model holding the dequantized weights (as tests/test_gptq.py's e2e test).

Tolerances: every comparison is exact (bytes or tokens at f32), except the
JAX codec tests' own bounds (half a quantization step, 1e-5).
"""

import filecmp
import itertools
import json
import os

import numpy as np
import pytest
import torch
from transformers import AutoConfig

from moe_infinity_tpu.entrypoints.api import MoE as JMoE
from moe_infinity_tpu.store import gptq as jg
from moe_infinity_tpu.store.ingest import ingest_checkpoint as j_ingest
from moe_infinity_tpu_torch.entrypoints.api import MoE
from moe_infinity_tpu_torch.store import gptq as pg
from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
from moe_infinity_tpu_torch.utils.hf_config import read_hf_config
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import tiny_hf_model

STORE_FILES = ["dense.blob", "dense.index.json", "experts.blob", "experts.index.json",
               "name_map.json"]


def _same_bytes(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


def _weight(seed, shape, gs):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    w[0, :gs] = np.abs(w[0, :gs]) + 0.5  # a group above 0: its zero-point clips to 0
    return w


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape,gs", [((32, 64), 16), ((48, 128), 32)])
def test_pack_equals_jax(bits, shape, gs):
    w = _weight(bits, shape, gs)
    want = jg.pack_gptq(w, bits=bits, group_size=gs)
    got = pg.pack_gptq(w, bits=bits, group_size=gs)
    assert sorted(got) == sorted(want)
    for k in want:
        _same_bytes(got[k], want[k])
    # the same packing from a tensor, on its device
    got_t = pg.pack_gptq(torch.from_numpy(w), bits=bits, group_size=gs)
    for k in want:
        _same_bytes(got_t[k].numpy(), want[k])


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("act_order", [False, True], ids=["g_idx-none", "g_idx-permuted"])
def test_dequant_and_unpack_equal_jax(bits, v2, act_order):
    rng = np.random.default_rng(7)
    packed = jg.pack_gptq(_weight(11, (32, 64), 16), bits=bits, group_size=16)
    g_idx = rng.permutation(packed["g_idx"]) if act_order else None
    args = (packed["qweight"], packed["qzeros"], packed["scales"], g_idx)
    kw = dict(bits=bits, group_size=16, v2=v2)
    _same_bytes(pg.dequant_gptq(*args, **kw), jg.dequant_gptq(*args, **kw))
    _same_bytes(pg._unpack_rows(packed["qweight"], bits), jg._unpack_rows(packed["qweight"], bits))
    _same_bytes(pg._unpack_cols(packed["qzeros"], bits), jg._unpack_cols(packed["qzeros"], bits))


def test_bits_not_supported_raise_as_jax():
    packed = jg.pack_gptq(_weight(1, (8, 32), 16), bits=4, group_size=16)
    for mod in (jg, pg):
        with pytest.raises(NotImplementedError, match="bits=3"):
            mod.dequant_gptq(**packed, bits=3, group_size=16)
        with pytest.raises(ValueError, match="not divisible"):
            mod.pack_gptq(np.zeros((8, 24), np.float32), bits=4, group_size=16)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_pack_dequant_roundtrip(bits):
    """tests/test_gptq.py's bound on the port's codec: the reconstruction
    error is within half a quantization step."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 64)).astype(np.float32)
    packed = pg.pack_gptq(w, bits=bits, group_size=16)
    deq = pg.dequant_gptq(**packed, bits=bits, group_size=16)
    assert deq.shape == w.shape
    step = packed["scales"].astype(np.float32).max()
    assert np.abs(deq - w).max() <= step * 0.5 + 1e-6


def test_dequant_is_a_fixed_point_and_g_idx_optional():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(8, 32)).astype(np.float32)
    packed = pg.pack_gptq(w, bits=4, group_size=8)
    deq1 = pg.dequant_gptq(**packed, bits=4, group_size=8)
    deq2 = pg.dequant_gptq(**pg.pack_gptq(deq1, bits=4, group_size=8), bits=4, group_size=8)
    np.testing.assert_allclose(deq1, deq2, atol=1e-5)
    without = pg.dequant_gptq(packed["qweight"], packed["qzeros"], packed["scales"], None,
                              bits=4, group_size=8)
    np.testing.assert_array_equal(deq1, without)


def test_gptq_config_equals_jax():
    class Cfg:
        pass

    c = Cfg()
    assert pg.gptq_config(c) is None
    for qc in ({"quant_method": "awq"},
               {"quant_method": "gptq", "bits": 4, "group_size": 32},
               {"quant_method": "gptq", "bits": 8, "checkpoint_format": "gptq_v2", "sym": True},
               {"quant_method": "gptq"}):
        c.quantization_config = qc
        assert pg.gptq_config(c) == jg.gptq_config(c)
    assert pg.gptq_config(c) == {"bits": 4, "group_size": 128, "v2": False, "sym": False}


# ---------------------------------------------------------------------------
# the reassembler
# ---------------------------------------------------------------------------


def _feed_all(mod, qcfg, items):
    asm = mod.GptqReassembler(qcfg)
    out = []
    for name, arr in items:
        out += list(asm.feed(name, arr))
    out += list(asm.flush())
    return out


QCFG = {"bits": 4, "group_size": 16, "v2": False, "sym": False}


@pytest.mark.parametrize("order", list(itertools.permutations(jg.GPTQ_COMPONENTS)),
                         ids=lambda o: "-".join(c[:2] for c in o))
def test_reassembler_any_order_equals_jax(order):
    """Two linears' components interleaved in ``order`` (the second's
    reversed), a plain tensor between them: the same emissions, in the same
    order, as JAX's."""
    a = jg.pack_gptq(_weight(3, (8, 32), 16), bits=4, group_size=16)
    b = jg.pack_gptq(_weight(4, (16, 32), 16), bits=4, group_size=16)
    items = []
    for ca, cb in zip(order, reversed(order)):
        items += [(f"m.0.w1.{ca}", a[ca]), (f"m.1.w2.{cb}", b[cb])]
    items.insert(3, ("m.norm.weight", np.ones(4, np.float32)))
    want, got = _feed_all(jg, QCFG, items), _feed_all(pg, QCFG, items)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, x), (_, y) in zip(got, want):
        _same_bytes(x, y)


def test_reassembler_flush_derives_g_idx_and_raises_on_incomplete():
    a = jg.pack_gptq(_weight(5, (8, 32), 16), bits=4, group_size=16)
    items = [(f"x.w1.{c}", a[c]) for c in ("qweight", "scales", "qzeros")]
    got, want = _feed_all(pg, QCFG, items), _feed_all(jg, QCFG, items)
    assert [n for n, _ in got] == [n for n, _ in want] == ["x.w1.weight"]
    _same_bytes(got[0][1], want[0][1])
    for mod in (jg, pg):
        asm = mod.GptqReassembler(QCFG)
        for c in ("qweight", "g_idx"):
            assert not list(asm.feed(f"x.w1.{c}", a[c]))
        with pytest.raises(RuntimeError, match=r"incomplete GPTQ tensor groups.*x\.w1"):
            list(asm.flush())


# ---------------------------------------------------------------------------
# a tiny GPTQ Mixtral: ingest and generate
# ---------------------------------------------------------------------------

QUANTIZED = (".block_sparse_moe.experts.", ".self_attn.")


def write_gptq_checkpoint(path, *, bits=4, group_size=16, v2=False, act_order=False, seed=5):
    """The tiny Mixtral of tests/test_gptq.py with its attention and expert
    linears GPTQ-packed (JAX's ``pack_gptq``), in two safetensors shards
    with an index: each linear's ``qweight`` and ``g_idx`` in the first,
    ``qzeros`` and ``scales`` in the second, the other tensors alternating.
    ``act_order`` permutes each linear's ``g_idx``. Returns (path, HF model
    holding the weights as either package dequantizes them)."""
    from safetensors.torch import save_file

    cfg, hf = tiny_hf_model("mixtral", seed)
    rng = np.random.default_rng(seed)
    shards = ({}, {})
    for i, (name, tensor) in enumerate(hf.state_dict().items()):
        if any(q in name for q in QUANTIZED) and name.endswith(".weight"):
            packed = jg.pack_gptq(tensor.numpy(), bits=bits, group_size=group_size)
            if act_order:
                packed["g_idx"] = rng.permutation(packed["g_idx"])
            prefix = name[: -len(".weight")]
            for comp, arr in packed.items():
                shard = shards[comp in ("qzeros", "scales")]
                shard[f"{prefix}.{comp}"] = torch.from_numpy(np.ascontiguousarray(arr))
            deq = jg.dequant_gptq(**packed, bits=bits, group_size=group_size, v2=v2)
            with torch.no_grad():
                tensor.copy_(torch.from_numpy(deq))
        else:
            shards[i % 2][name] = tensor.clone()
    os.makedirs(path, exist_ok=True)
    weight_map = {}
    for k, shard in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-00002.safetensors"
        save_file(shard, os.path.join(path, fname), metadata={"format": "pt"})
        weight_map.update({n: fname for n in shard})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    cfg_dict = cfg.to_dict()
    cfg_dict["quantization_config"] = {"quant_method": "gptq", "bits": bits,
                                       "group_size": group_size, "sym": False,
                                       "desc_act": act_order}
    if v2:
        cfg_dict["quantization_config"]["checkpoint_format"] = "gptq_v2"
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg_dict, f)
    return str(path), hf


def _same_dirs(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == STORE_FILES
    for f in STORE_FILES:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


@pytest.mark.parametrize("bits,v2,act_order", [
    (4, False, False), (2, False, True), (8, True, False), (4, True, True),
], ids=["4-v1", "2-v1-act-order", "8-v2", "4-v2-act-order"])
@pytest.mark.parametrize("dtype", ["float32", "int4", "int8", "bfloat16"])
def test_store_byte_equal_to_jax(tmp_path, bits, v2, act_order, dtype):
    ckpt, _ = write_gptq_checkpoint(tmp_path / "ckpt", bits=bits, v2=v2, act_order=act_order)
    j_meta = j_ingest(ckpt, str(tmp_path / "jax"), AutoConfig.from_pretrained(ckpt),
                      expert_dtype=dtype)
    p_meta = ingest_checkpoint(ckpt, str(tmp_path / "port"), read_hf_config(ckpt),
                               expert_dtype=dtype)
    assert p_meta == j_meta
    _same_dirs(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("bits,v2,act_order", [(4, False, False), (8, True, True)],
                         ids=["4-v1", "8-v2-act-order"])
def test_generate_equals_jax_and_dequantized_hf(tmp_path, bits, v2, act_order):
    ckpt, hf = write_gptq_checkpoint(tmp_path / "ckpt", bits=bits, v2=v2, act_order=act_order)
    cfg = {"expert_dtype": "float32", "max_seq_len": 64}
    prompt = np.array([[5, 9, 33, 2]])
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
