"""The port's Grok-1 through the ``OffloadEngine`` and ``MoE`` against the
JAX package's, on the tiny Grok of tests/test_torch_grok.py (split from it,
whose spec, family fixture and config it shares): greedy tokens per layer,
speculative and in k-step blocks, eagerly and through the graph stand-in,
with the JAX engine's executions and counters (prefetch off, one worker);
``MoE`` from a seed-written checkpoint at f32, int8 and fp8 against the JAX
``MoE``, the port's ingest byte-equal to the JAX ingest; and the offload
facade asking for graphs by the model's flag."""

import numpy as np
import pytest

from moe_infinity_tpu_torch.runtime.generate import Generator

from test_torch_grok import E, TINY_CONFIG, _checkpoint_tensors, _no_tf32, grok  # noqa: F401
from torch_decoder_family import (
    ONE,
    TWO,
    StandIn,
    facade_tokens_equal,
    facades,
    run_engines,
    same_counters,
    stores_byte_equal,
    write_checkpoint,
)
from torch_port_helpers import one_intra_op_thread  # noqa: F401


# ---- the offload engine -----------------------------------------------------------

@pytest.mark.parametrize("quant", ["float32", "int8", "float8_e4m3fn"])
def test_offload_per_layer_equals_jax_and_resident(grok, quant):
    eng, jeng = grok.engines(quant, E)
    base = grok.resident(quant).generate(ONE, max_new_tokens=8)
    got, want = run_engines(eng, jeng, ONE, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.sequences)
    assert eng.executed_steps == 7 and eng.stats()["evictions"] > 0
    same_counters(eng, jeng)


@pytest.mark.parametrize("quant", ["float32", "float8_e4m3fn"])
def test_offload_speculative_step_equals_jax(grok, quant):
    eng, jeng = grok.engines(quant, 10, speculative=True)
    base = grok.resident(quant).generate(TWO, max_new_tokens=8)
    got, want = run_engines(eng, jeng, TWO, 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.sequences)
    assert eng.speculative and max(eng.replay_counts) > 1
    same_counters(eng, jeng)


@pytest.mark.parametrize("mode", ["whole", "prefix"])
def test_offload_blocks_equal_jax(grok, monkeypatch, mode):
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    eng, jeng = grok.engines("float32", 14, speculative=True, spec_block=2)
    base = grok.resident().generate(TWO, max_new_tokens=8)
    got, want = run_engines(eng, jeng, TWO, 8, eos_token_id=None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base.sequences)
    assert eng.spec_block == 2
    same_counters(eng, jeng)


@pytest.mark.parametrize("k", [1, 2])
def test_offload_graphs_equal_eager(grok, k):
    """The speculative step (k = 1) and the blocks of 2 as replays of graphs
    captured by the stand-in backend: the step as a 0-d tensor (Grok's
    ``graph_step``), tokens and counters equal to the eager engine's."""
    seqs, engines = [], []
    for graphs in (True, False):
        eng, jeng = grok.engines("float8_e4m3fn", 14, speculative=True, spec_block=k,
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

@pytest.fixture(scope="module")
def grok_ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("grok_ckpt") / "ckpt", TINY_CONFIG,
                            _checkpoint_tensors(TINY_CONFIG, 3))


BASE = {"max_seq_len": 64}
OFFLOAD = dict(BASE, device_memory_bytes=1, dense_paging="off", prefetch=False, num_threads=1)
PROMPT = np.array([[5, 9, 33, 70]])


@pytest.mark.parametrize("quant,cfg,plan", [
    ("float32", dict(BASE, max_batch_size=1), "generator"),
    ("float32", dict(BASE, max_batch_size=2, kv_page_size=8), "batcher"),
    ("float32", dict(OFFLOAD, num_slots=9), "per-layer"),
    ("float32", dict(OFFLOAD, num_slots=12, speculative_decode=True, speculative_block=2,
                     max_batch_size=1), "spec-k2"),
    ("int8", dict(OFFLOAD, num_slots=9), "per-layer"),
    ("float8_e4m3fn", dict(BASE, max_batch_size=1), "generator"),
    ("float8_e4m3fn", dict(OFFLOAD, num_slots=9), "per-layer"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_moe_facade_equals_jax(grok_ckpt, tmp_path, quant, cfg, plan):
    """``MoE`` from the checkpoint: the port's ingest writes the JAX ingest's
    files, and the greedy tokens equal the JAX ``MoE``'s: all of them at f32
    compute (float32 experts); at bf16, the facade's rule for int8 and fp8,
    the prefill's log-probs and token (``facade_tokens_equal``)."""
    j, p = facades(grok_ckpt, tmp_path, dict(cfg, expert_dtype=quant))
    try:
        stores_byte_equal(tmp_path)
        assert p.arch == "grok" and (p.batcher is not None) == (plan == "batcher")
        assert (p.engine is not None) == (plan not in ("generator", "batcher"))
        facade_tokens_equal(p, j, PROMPT, exact=quant == "float32")
        if p.engine is not None:  # the same routing where the tokens are the same
            assert p.stats() == j.stats() if quant == "float32" else p.stats()["visits"] > 0
            assert p.engine.graphs is None  # the CPU runs eagerly
    finally:
        j.shutdown()
        p.shutdown()


def test_facade_asks_for_graphs_by_the_models_flag(grok_ckpt, tmp_path, monkeypatch):
    """The offload facade asks the engine for CUDA graphs because Grok's
    model sets ``graph_step`` (no list of families to keep), and not with the
    "ragged" grouped FFN, which reads its group sizes on the host; on the CPU
    the engine then runs eagerly."""
    from moe_infinity_tpu_torch.entrypoints.api import MoE
    from moe_infinity_tpu_torch.models.grok import GrokModel as Model
    from moe_infinity_tpu_torch.runtime import engine as eng_mod

    seen = []
    init = eng_mod.OffloadEngine.__init__

    def spy(self, *a, **kw):
        seen.append(kw["graphs"])
        init(self, *a, **kw)

    monkeypatch.setattr(eng_mod.OffloadEngine, "__init__", spy)
    cfg = dict(OFFLOAD, num_slots=9, expert_dtype="float32")
    for flag, impl in ((True, "gather"), (False, "gather"), (True, "ragged")):
        monkeypatch.setattr(Model, "graph_step", flag)
        p = MoE(grok_ckpt, dict(cfg, moe_impl=impl,
                                offload_path=str(tmp_path / f"s{flag}{impl}")), device="cpu")
        try:
            assert p.engine.graphs is None  # the CPU has no capture backend
        finally:
            p.shutdown()
    assert seen == [True, False, False]
