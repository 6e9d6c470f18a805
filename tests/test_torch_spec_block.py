"""The port's speculative runners (``runtime/engine.py``) on its slot arena,
mirroring tests/test_spec_block.py: scripted dispatch functions over a real
``ExpertArena`` on the CPU check prefix acceptance, suffix quantization,
union protection and id accounting without a model in the loop. The lease
cases evict a key the dispatch saw resident from inside its scope; the
execution must not be accepted. The hill-climb of the block size
(``Seq2SeqOffloadEngine._adapt_spec_block``) runs on attribute stubs of
both packages' engines, fed the same execution counts: the sizes chosen
must be equal."""

import types

import numpy as np
import pytest
import torch

from moe_infinity_tpu.runtime.engine_seq2seq import Seq2SeqOffloadEngine as JEngine
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.engine import (
    is_spec_capacity_error,
    quantize_block,
    run_speculative,
    run_speculative_block,
    spec_block_diag,
    speculative_stats,
)
from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine
from moe_infinity_tpu_torch.store.blob import SyntheticStore

from torch_port_helpers import one_intra_op_thread

MLIS = [0, 1]
E = 4
B = 1


def _arena(slots=8):
    store = SyntheticStore(
        2, E, [("fc1.weight", (4, 8), "float32"), ("fc2.weight", (8, 4), "float32")],
        meta={"arch": "nllb"},
    )
    return ExpertArena(store, slots, compute_dtype=torch.float32, device="cpu", num_threads=1)


def _dispatch(calls):
    """Scripted block: step j (global) routes expert j % E at every MoE
    layer and emits token j."""

    def dispatch(tree, rows, cur, j0, kk, kvs):
        calls.append((j0, kk))
        toks = torch.arange(j0, j0 + kk, dtype=torch.int32)[None, :]
        ids = torch.tensor([[[[(j0 + j) % E] for j in range(kk)]] for _ in MLIS],
                           dtype=torch.int32)  # [L, B, kk, 1]
        return toks, kvs, ids

    return dispatch


def test_quantize_block_halving_chain():
    assert [quantize_block(r, 4) for r in (4, 3, 2, 1)] == [4, 2, 2, 1]
    assert [quantize_block(r, 3) for r in (8, 3, 2, 1)] == [3, 3, 1, 1]
    assert quantize_block(0, 4) == 1


def test_cold_block_accepts_after_union_load():
    arena = _arena()
    calls = []
    try:
        toks, _, execs, ids = run_speculative_block(
            arena, MLIS, _dispatch(calls), 4, 20, torch.zeros((B, 1)), None)
        np.testing.assert_array_equal(toks[0], [0, 1, 2, 3])
        assert execs == 2  # cold miss at step 0, then all resident
        assert calls == [(0, 4), (0, 4)]
        assert ids.shape == (2, 1, 4, 1)
        assert not arena.policy.protected_ondemand  # released on exit
    finally:
        arena.shutdown()


def test_warm_prefix_accepted_suffix_redispatched():
    arena = _arena()
    calls = []
    try:
        # steps 0 and 1 resident up front: the first dispatch commits two
        # tokens and only the suffix (quantized to size 2) runs again
        arena.warm([(li, e) for li in MLIS for e in (0, 1)])
        toks, _, execs, ids = run_speculative_block(
            arena, MLIS, _dispatch(calls), 4, 20, torch.zeros((B, 1)), None)
        np.testing.assert_array_equal(toks[0], [0, 1, 2, 3])
        assert execs == 2
        assert calls == [(0, 4), (2, 2)]  # prefix accepted, suffix only
        assert ids.shape == (2, 1, 4, 1)
    finally:
        arena.shutdown()


@pytest.mark.parametrize("runner", ["whole", "prefix"])
def test_nonconvergence_raises_capacity_error(runner):
    arena = _arena(slots=8)
    n = [0]

    def never_resident(tree, rows, cur, j0, kk, kvs):
        # a different expert every call: verification never sees the
        # dispatched set resident
        n[0] += 1
        return (torch.zeros((B, kk), dtype=torch.int32), kvs,
                torch.full((len(MLIS), B, kk, 1), n[0] % E, dtype=torch.int32))

    try:
        with pytest.raises(RuntimeError) as err:
            if runner == "prefix":
                run_speculative_block(arena, MLIS, never_resident, 4, 3, torch.zeros((B, 1)),
                                      None)
            else:
                run_speculative(arena, MLIS, lambda tree, rows: never_resident(
                    tree, rows, None, 0, 1, None)[1:], 3)
        assert is_spec_capacity_error(err.value)
        assert not arena.policy.protected_ondemand
    finally:
        arena.shutdown()


def test_whole_step_cold_then_accepted():
    arena = _arena()
    seen = []

    def run(tree, rows):
        seen.append(rows.clone())
        return torch.tensor([7]), torch.tensor([[[[0, 1]]], [[[2, 3]]]], dtype=torch.int32)

    timings = {}
    try:
        (out,), ids_np, execs = run_speculative(arena, MLIS, run, 5, timings=timings)
        assert execs == 2 and int(out) == 7
        assert ids_np.shape == (2, 1, 1, 2)
        # the second dispatch saw the union loaded, in its slot rows too
        assert (seen[0] == -1).all()
        assert all(int(seen[1][l, e]) >= 0 for l, es in ((0, (0, 1)), (1, (2, 3))) for e in es)
        assert set(timings) >= {"lock_wait_s", "dispatch_s", "replay_hook_s", "acquire_s"}
        assert not arena.policy.protected_ondemand
    finally:
        arena.shutdown()


def _evict_inside(arena, victim_layer):
    """Inside a dispatch scope: load E other keys of the victim's layer into
    a full arena, which evicts every key the scope saw resident there."""
    others = [(victim_layer + 2, e) for e in range(E)]
    arena.acquire(others, victim_layer + 2)
    arena.release(others)


@pytest.mark.parametrize("runner", ["whole", "prefix"])
def test_lease_eviction_is_a_miss(runner):
    """A key resident at the snapshot and evicted while the dispatch scope is
    open may have had its slot overwritten under the queued reads: the
    execution that routed it must not be accepted. The second execution,
    with nothing evicted, is."""
    store = SyntheticStore(
        4, E, [("fc1.weight", (4, 8), "float32"), ("fc2.weight", (8, 4), "float32")],
        meta={"arch": "nllb"},
    )
    arena = ExpertArena(store, E, compute_dtype=torch.float32, device="cpu", num_threads=1)
    keys = [(0, e) for e in range(E)]
    arena.warm(keys)
    calls = []

    def scripted(evict):
        def dispatch(tree, rows, cur, j0, kk, kvs):
            calls.append(j0)
            assert int(rows[0, 0]) >= 0  # the routed key is resident at the snapshot
            if evict and len(calls) == 1:
                _evict_inside(arena, 0)
            ids = torch.zeros((1, B, kk, 1), dtype=torch.int32)  # expert 0 of layer 0
            return torch.zeros((B, kk), dtype=torch.int32), kvs, ids
        return dispatch

    counters = {}
    try:
        if runner == "whole":
            d = scripted(True)
            (_,), _, execs = run_speculative(
                arena, [0], lambda tree, rows: d(tree, rows, None, 0, 2, None)[1:], 5,
                counters=counters)
        else:
            _, _, execs, _ = run_speculative_block(
                arena, [0], scripted(True), 2, 5, torch.zeros((B, 1)), None,
                counters=counters)
        assert execs == 2, execs
        assert counters == {"lease_misses": 1, "lease_rejects": 1}
        assert arena.lease_evictions >= 1
        assert arena.fetch_stats()["lease_evictions"] == arena.lease_evictions
        # the same dispatch with no eviction inside is accepted at once
        arena.warm(keys)
        calls.clear()
        before = arena.lease_evictions
        _, _, execs, _ = run_speculative_block(
            arena, [0], scripted(False), 2, 5, torch.zeros((B, 1)), None)
        assert execs == 1 and arena.lease_evictions == before
        assert not arena.policy.protected_ondemand
    finally:
        arena.shutdown()


def test_speculative_stats_and_block_diag():
    assert speculative_stats([]) == {}
    assert speculative_stats([1, 2, 3]) == {"speculative_steps": 3,
                                            "mean_step_executions": 2.0}
    log = [{"unions": [6], "misses": [0]}, {"unions": [6, 8], "misses": [2, 0]},
           {"unions": [5, 7, 9], "misses": [3, 1, 0]}]
    assert spec_block_diag(log) == {
        "blocks": 3, "accept_at_1": 1 / 3, "accept_at_2": 1 / 3, "mean_union": 7.7,
        "mean_miss_at_dispatch": [1.7, 0.5, 0.0]}


# ---- measured-cost adaptive block sizing (engine_seq2seq) --------------


def _adapt_stub(cfg=4, cls=Seq2SeqOffloadEngine):
    """Bare attribute carrier for ``_adapt_spec_block`` (the hill-climb
    without an engine)."""
    s = types.SimpleNamespace(
        replay_counts=[], spec_block=cfg, _spec_block_cfg=cfg, adaptive_spec=True,
        _k_trace=[], _ppt_ewma={}, _probe_queue=None, _chosen=None,
        _blocks_since_probe=0, _k_cap=cfg,
    )
    s._halving_chain = lambda: cls._halving_chain(s)
    s._PROBE_BLOCKS = cls._PROBE_BLOCKS
    s._REPROBE_EVERY = cls._REPROBE_EVERY
    return s


def _adapt(stub, execs, k=None, tokens=None, cls=Seq2SeqOffloadEngine):
    """Record one block of ``execs`` dispatches at the stub's current size
    and run the adaptation step (the engine's own call pattern)."""
    k = k if k is not None else stub.spec_block
    stub.replay_counts.append(execs)
    cls._adapt_spec_block(stub, k=k, tokens=tokens)


def _execs_uniform(k):
    """Programs per token about 1.7 at k=4, 2.2 at k=2, 2.3 at k=1: larger
    blocks amortize replays even at no first-dispatch acceptance."""
    return {4: 7, 2: 5, 1: 2}[k]


def test_hill_climb_picks_large_k_on_uniform_drift():
    s = _adapt_stub(cfg=4)
    for _ in range(12):
        _adapt(s, _execs_uniform(s.spec_block))
    assert s._chosen is not None and s._chosen[0] == 4
    assert s.spec_block == 4
    assert {4, 2, 1} <= set(s._k_trace)  # every chain size was probed


def test_hill_climb_picks_small_k_when_small_wins():
    costs = {4: 10, 2: 4, 1: 1.5}
    s = _adapt_stub(cfg=4)
    for _ in range(12):
        _adapt(s, costs[s.spec_block])
    assert s._chosen is not None and s._chosen[0] == 1


def test_hill_climb_reprobes_on_regime_shift():
    s = _adapt_stub(cfg=4)
    for _ in range(12):
        _adapt(s, _execs_uniform(s.spec_block))
    for _ in range(2 * s._REPROBE_EVERY + 12 * s._PROBE_BLOCKS):
        _adapt(s, 1)  # every size now accepts at the first dispatch
        if s._chosen is not None and s._chosen[0] == 4:
            break
    assert s._chosen is not None and s._chosen[0] == 4, (s._chosen, s._ppt_ewma)


def test_hill_climb_reprobes_on_cost_drift():
    s = _adapt_stub(cfg=4)
    for _ in range(12):
        _adapt(s, _execs_uniform(s.spec_block))
    assert s._chosen[0] == 4
    n_trace = len(s._k_trace)
    for _ in range(8):
        _adapt(s, 16)  # the chosen size's cost explodes
        if s._chosen is None:
            break
    assert s._chosen is None  # re-probing
    assert len(s._k_trace) < n_trace + s._REPROBE_EVERY


def test_hill_climb_respects_capacity_cap():
    s = _adapt_stub(cfg=4)
    s._k_cap = 2
    s.spec_block = 2  # the engine sets spec_block to the cap when capping
    for _ in range(10):
        assert s.spec_block <= 2
        _adapt(s, 1)
    assert s._chosen[0] <= 2
    assert 4 not in s._ppt_ewma


def test_hill_climb_respects_disable_flag():
    s = _adapt_stub(cfg=4)
    s.adaptive_spec = False
    for _ in range(20):
        _adapt(s, 7)
    assert s.spec_block == 4
    assert s._probe_queue is None


def test_hill_climb_skips_dominated_probe_sizes():
    s = _adapt_stub(cfg=4)
    for _ in range(12):
        _adapt(s, 1 if s.spec_block == 4 else 99)  # ppt(4) = 0.25
    assert s._chosen is not None and s._chosen[0] == 4
    assert set(s._k_trace) == {4}
    assert 1 not in s._ppt_ewma and 2 not in s._ppt_ewma


@pytest.mark.parametrize("seed,cfg,cap", [(0, 4, 4), (1, 8, 8), (2, 4, 2), (3, 2, 2)])
def test_hill_climb_equals_jax(seed, cfg, cap):
    """The same execution counts into the port's and the JAX engine's
    hill-climb: the sequence of sizes chosen is equal, through probes,
    choices, drift re-probes and periodic re-probes."""
    rng = np.random.default_rng(seed)
    ours, theirs = _adapt_stub(cfg), _adapt_stub(cfg, JEngine)
    for s in (ours, theirs):
        s._k_cap = s.spec_block = cap
    ks = []
    for i in range(300):
        k = ours.spec_block
        assert theirs.spec_block == k
        ks.append(k)
        # regimes of 60 blocks: cost grows with k, falls with k, or is flat
        regime = (i // 60) % 3
        base = {0: k + 1, 1: max(1, 8 // k), 2: 1}[regime]
        execs = int(base + rng.integers(0, 3))
        tokens = None if rng.random() > 0.1 else int(rng.integers(1, k + 1))
        _adapt(ours, execs, k=k, tokens=tokens)
        _adapt(theirs, execs, k=k, tokens=tokens, cls=JEngine)
    assert ours._k_trace == theirs._k_trace
    assert ours._chosen == theirs._chosen
    assert len(set(ks)) > 1 or cap == 1
