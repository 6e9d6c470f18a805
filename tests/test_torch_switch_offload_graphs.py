"""Switch through the port's offload engine on the tiny Switch of
tests/test_torch_switch_offload.py (split from it, whose spec, stores and
engine helpers it shares): the decode step and the speculative blocks as
replays of graphs captured by the stand-in backend, against the eager path
and the JAX engine, and stream decode against the JAX engine and the
resident path; greedy tokens exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
from moe_infinity_tpu.runtime.engine_seq2seq import Seq2SeqOffloadEngine as JEngine
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store.blob import ExpertStore
from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

from test_torch_switch_offload import (  # noqa: F401
    E,
    GEN,
    IDS,
    MASK,
    _jax_engine,
    _models,
    _port_engine,
    _resident,
    setup,
)
from torch_port_helpers import one_intra_op_thread, to_port  # noqa: F401


# ---- the decode step as a graph (a stand-in capture backend) ------------------


def test_generator_graph_replays_equal_eager(setup):
    """``Seq2SeqGenerator`` with the stand-in backend (the step captured
    once, replayed with no arguments at each new step, so a position or T5
    bias baked in at capture would go stale) against ``graphs=False``: the
    logits of 8 steps bit for bit, equal tokens, one capture for two
    requests of one shape."""
    from test_torch_graphs import StandIn

    _, jtree, params, _ = setup
    _, model = _models()
    tree = to_port(jtree)
    for_layer = ResidentProvider.for_layer
    graphed = Seq2SeqGenerator(model, params, tree, for_layer, graph_backend=StandIn())
    eager = Seq2SeqGenerator(model, params, tree, for_layer, graphs=False)
    got, want = graphed.generate(IDS, **GEN), eager.generate(IDS, **GEN)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(graphed.generate(IDS, **GEN).sequences, want.sequences)
    assert graphed.graph_stats()["captures"] == 1
    with torch.inference_mode():
        pm = torch.as_tensor(MASK)
        cross = model.cross_kv(params, model.encode(
            params, tree, torch.as_tensor(IDS, dtype=torch.int32), pm, for_layer))
        steps = [g.decoder(3, 16, pm, cross) for g in (graphed, eager)]
        cur = torch.zeros(3, 1, dtype=torch.int32)
        for step in range(8):
            (lg, ng), (le, ne) = (s(cur, step) for s in steps)
            assert torch.equal(lg, le) and torch.equal(ng, ne), step
            cur = ne[:, None].to(torch.int32)


@pytest.mark.parametrize("k", [1, 3])
def test_speculative_graph_replays_equal_jax(setup, k):
    """The speculative engine with its step and blocks replayed through the
    stand-in backend, prefetch off and one worker: tokens, executions and
    counters equal the JAX engine's, and every execution is a replay of a
    graph captured once per block size."""
    from test_torch_graphs import StandIn

    jparams, _, params, stores = setup
    jmodel, model = _models()
    path = stores["float32"]
    jeng = _jax_engine(jmodel, jparams, path, 2 * E, False, 1, speculative=True, spec_block=k)
    eng = _port_engine(model, params, path, 2 * E, False, 1, speculative=True, spec_block=k,
                       graph_backend=StandIn())
    try:
        want = jeng.generate(IDS, **GEN)
        got = eng.generate(IDS, **GEN)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        assert eng.replay_counts == jeng.replay_counts and max(eng.replay_counts) > 1
        assert eng.stats() == jeng.stats()
        st = eng.graph_stats()
        assert st["replays"] == sum(eng.replay_counts) and st["recaptures"] == 0
        assert 1 <= st["captures"] <= 2  # one graph per block size
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


@pytest.mark.parametrize("k,U", [(3, 2), (1, 4)])
def test_stream_decode_equals_jax_and_resident(setup, k, U):
    """Stream decode on Switch (top-1, capacity 2 in the encoder): greedy
    tokens equal the JAX engine's and the resident path's, with the same
    executions and the same final U; from U = 2 some block runs again at a
    larger U. The weights are sharpened (a copy) so that rows route apart."""
    from moe_infinity_tpu.store.pinned import PinnedExpertTier as JTier
    from torch_port_helpers import sharpen_seq2seq

    jparams, _, _, stores = setup
    jparams = sharpen_seq2seq(jax.tree.map(lambda a: a, jparams))
    params = to_port(jparams)
    jmodel, model = _models()
    path = stores["float32"]
    jstore, store = JStore(path), ExpertStore(path)
    jarena = JArena(jstore, E, compute_dtype=jnp.float32, num_threads=1,
                    pinned_tier=JTier(jstore, shared_record=False))
    jeng = JEngine(jmodel, jparams, jarena, prefetch=False, speculative=True, spec_block=k,
                   stream_decode=True, stream_unique=U)
    eng = _port_engine(model, params, path, E, False, 1, speculative=True, spec_block=k,
                       stream_decode=True, stream_unique=U,
                       tier=PinnedExpertTier(store, device="cpu", shared_record=False))
    res, _ = _resident(model, params, path)
    try:
        want = jeng.generate(IDS, **GEN)
        got = eng.generate(IDS, **GEN)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        np.testing.assert_array_equal(got.sequences, res.generate(IDS, **GEN).sequences)
        assert eng.replay_counts == jeng.replay_counts and eng._stream_U == jeng._stream_U
        assert (max(eng.replay_counts) > 1) == (U < E)
        assert len(eng.replay_counts) == (8 if k == 1 else 4)  # blocks of 3, 3, 1, 1
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()
