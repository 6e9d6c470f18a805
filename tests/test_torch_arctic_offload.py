"""The port's Snowflake Arctic through the ``OffloadEngine`` and ``MoE``
against the JAX package's, on the tiny Arctic of tests/test_torch_arctic.py
(split from it, whose spec, family fixture and config it shares): greedy
tokens per layer (with the dense layers in its loop), speculative and in
blocks, eagerly and through the graph stand-in, with the JAX engine's
executions and counters (prefetch off, one worker); ``MoE`` from a
seed-written checkpoint at f32, int8 and fp8 against the JAX ``MoE``, the
port's ingest byte-equal to the JAX ingest."""

import numpy as np
import pytest

from moe_infinity_tpu_torch.runtime.generate import Generator

from test_torch_arctic import ARCTIC_CONFIG, E, _no_tf32, arctic  # noqa: F401
from torch_decoder_family import (
    ONE,
    TWO,
    StandIn,
    facade_tokens_equal,
    facades,
    random_tensors,
    run_engines,
    same_counters,
    stores_byte_equal,
    write_checkpoint,
)
from torch_port_helpers import one_intra_op_thread  # noqa: F401


# ---- the offload engine -----------------------------------------------------------

@pytest.mark.parametrize("quant", ["float32", "int8", "float8_e4m3fn"])
def test_offload_per_layer_equals_jax_and_resident(arctic, quant):
    """The per-layer loop runs the dense layers with ``dense_layer`` and the
    MoE layers over the slots."""
    eng, jeng = arctic.engines(quant, E)
    base = arctic.resident(quant).generate(ONE, max_new_tokens=8)
    got, want = run_engines(eng, jeng, ONE, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.sequences)
    assert eng.executed_steps == 7
    same_counters(eng, jeng)


@pytest.mark.parametrize("quant", ["float32", "int8"])
def test_offload_speculative_step_equals_jax(arctic, quant):
    eng, jeng = arctic.engines(quant, 10, speculative=True)
    base = arctic.resident(quant).generate(TWO, max_new_tokens=8)
    got, want = run_engines(eng, jeng, TWO, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.sequences)
    assert eng.speculative and max(eng.replay_counts) > 1
    same_counters(eng, jeng)


@pytest.mark.parametrize("mode", ["whole", "prefix"])
def test_offload_blocks_equal_jax(arctic, monkeypatch, mode):
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    eng, jeng = arctic.engines("float32", 14, speculative=True, spec_block=2)
    base = arctic.resident().generate(TWO, max_new_tokens=8)
    got, want = run_engines(eng, jeng, TWO, 8, eos_token_id=None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.sequences)
    assert eng.spec_block == 2
    same_counters(eng, jeng)


@pytest.mark.parametrize("k", [1, 2])
def test_offload_graphs_equal_eager(arctic, k):
    """Arctic's step (``graph_step``, the dense layers inside) as replays of
    graphs captured by the stand-in backend, against the eager engine."""
    seqs, engines = [], []
    for graphs in (True, False):
        eng, jeng = arctic.engines("int8", 14, speculative=True, spec_block=k,
                                   graphs=graphs, graph_backend=StandIn() if graphs else None)
        engines.append(eng)
        jeng.arena.shutdown()
        try:
            seqs.append(Generator(stepper=eng, max_seq_len=64).generate(
                TWO, max_new_tokens=8, eos_token_id=None).sequences)
        finally:
            eng.arena.shutdown()
    np.testing.assert_array_equal(seqs[0], seqs[1])
    g, e = engines
    assert g.replay_counts == e.replay_counts and g.stats() == e.stats()
    assert g.graph_stats()["replays"] >= len(g.replay_counts) and e.graph_stats() == {}


# ---- the facade from a checkpoint -------------------------------------------------

def _checkpoint_tensors(cfg, seed):
    D, F, E_ = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_local_experts"]
    hd = D // cfg["num_attention_heads"]
    kvd = cfg["num_key_value_heads"] * hd
    freq = cfg.get("moe_layer_frequency", 1)
    shapes = {"model.embed_tokens.weight": (cfg["vocab_size"], D), "model.norm.weight": (D,),
              "lm_head.weight": (cfg["vocab_size"], D)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        shapes.update({p + "input_layernorm.weight": (D,),
                       p + "post_attention_layernorm.weight": (D,),
                       p + "self_attn.q_proj.weight": (D, D),
                       p + "self_attn.k_proj.weight": (kvd, D),
                       p + "self_attn.v_proj.weight": (kvd, D),
                       p + "self_attn.o_proj.weight": (D, D)})
        mlp = {"w1.weight": (F, D), "w2.weight": (D, F), "w3.weight": (F, D)}
        if (i + 1) % freq == 0:
            shapes[p + "block_sparse_moe.gate.weight"] = (E_, D)
            if cfg.get("parallel_attn_mlp_res"):
                shapes[p + "residual_layernorm.weight"] = (D,)
                shapes.update({p + "residual_mlp." + k: v for k, v in mlp.items()})
            for e in range(E_):
                shapes.update({f"{p}block_sparse_moe.experts.{e}.{k}": v
                               for k, v in mlp.items()})
        else:
            shapes.update({p + "block_sparse_moe.mlp." + k: v for k, v in mlp.items()})
    return random_tensors(shapes, seed)


TINY_CONFIG = dict(ARCTIC_CONFIG, vocab_size=128, hidden_size=56, intermediate_size=32,
                   num_hidden_layers=2, num_attention_heads=7, num_key_value_heads=1,
                   num_local_experts=8, torch_dtype="float32")
DENSE_CONFIG = dict(TINY_CONFIG, num_hidden_layers=4, moe_layer_frequency=2,
                    parallel_attn_mlp_res=False)


@pytest.fixture(scope="module")
def arctic_ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("arctic_ckpt")
    return {name: write_checkpoint(root / name, cfg, _checkpoint_tensors(cfg, 4))
            for name, cfg in (("parallel", TINY_CONFIG), ("dense", DENSE_CONFIG))}


BASE = {"max_seq_len": 64}
OFFLOAD = dict(BASE, device_memory_bytes=1, dense_paging="off", prefetch=False, num_threads=1)
PROMPT = np.array([[5, 9, 33, 70]])


@pytest.mark.parametrize("ckpt,quant,cfg,plan", [
    ("parallel", "float32", dict(BASE, max_batch_size=1), "generator"),
    ("parallel", "float32", dict(BASE, max_batch_size=2, kv_page_size=8), "batcher"),
    ("parallel", "float32", dict(OFFLOAD, num_slots=9), "per-layer"),
    ("parallel", "float32", dict(OFFLOAD, num_slots=12, speculative_decode=True,
                                 speculative_block=2, max_batch_size=1), "spec-k2"),
    ("dense", "float32", dict(OFFLOAD, num_slots=9), "per-layer"),
    ("parallel", "int8", dict(OFFLOAD, num_slots=9), "per-layer"),
    ("parallel", "float8_e4m3fn", dict(BASE, max_batch_size=1), "generator"),
    ("dense", "float8_e4m3fn", dict(OFFLOAD, num_slots=9, speculative_decode=True,
                                    speculative_block=1, max_batch_size=1), "spec-k1"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_moe_facade_equals_jax(arctic_ckpts, tmp_path, ckpt, quant, cfg, plan):
    """``MoE`` from the checkpoint: the port's ingest writes the JAX ingest's
    files, and the greedy tokens equal the JAX ``MoE``'s: all of them at f32
    compute (float32 experts); at bf16, the facade's rule for int8 and fp8,
    the prefill's log-probs and token (``facade_tokens_equal``)."""
    j, p = facades(arctic_ckpts[ckpt], tmp_path, dict(cfg, expert_dtype=quant))
    try:
        stores_byte_equal(tmp_path)
        assert p.arch == "arctic" and (p.batcher is not None) == (plan == "batcher")
        assert (p.engine is not None) == (plan not in ("generator", "batcher"))
        facade_tokens_equal(p, j, PROMPT, exact=quant == "float32")
        if p.engine is not None:  # the same routing where the tokens are the same
            assert p.stats() == j.stats() if quant == "float32" else p.stats()["visits"] > 0
    finally:
        j.shutdown()
        p.shutdown()
