"""The NLLB and Mixtral decode as CUDA graphs on the card (``runtime/graphs.py``): graph
replays against the eager path, the ticket counters after replays, the
sync guard, the graph cache's keys, and the arena's stream order under
replays. Marked ``cuda``: they skip without a CUDA device. On a machine
with one, run them with ``python3 -m pytest --noconftest -m cuda
tests/test_torch_cuda_graphs.py`` (``--noconftest``: the repo conftest
imports jax).

f32 logits of graph and eager runs are held bit for bit; where they differ,
only by at most 1e-5 with equal tokens (a cuBLAS call may pick another
algorithm on the capture stream's handle), and the test prints which."""

import numpy as np
import pytest
import torch

from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
from moe_infinity_tpu_torch.ops import _build
from moe_infinity_tpu_torch.ops.moe import grouped_ffn
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.engine import run_speculative
from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
from moe_infinity_tpu_torch.runtime.graphs import CudaGraphBackend, GraphCache
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

from test_torch_cuda_offload import (
    D,
    E,
    SPEC,
    _engine,
    _ffn,
    _inputs,
    _store,
    _tier,
    mixtral_offload,
    mixtral_steps,
)

pytestmark = pytest.mark.cuda

# NLLB-MoE-54B's width with 2+2 blocks: K1 splits its keys at a capacity of
# 1024 and K3 its reduction, so both use the ticket counters
WIDE = dict(SPEC, d_model=2048, num_heads=16, encoder_layers=2, decoder_layers=2,
            encoder_ffn_dim=8192, decoder_ffn_dim=8192)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _same(got, want, what):
    """Bit for bit, or within 1e-5 (printed)."""
    if torch.equal(got, want):
        return
    err = (got - want).abs().max().item()
    print(f"{what}: graph and eager differ by {err:.3e}")
    assert err <= 1e-5, (what, err)


def _resident(dev, spec, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    model = NllbModel(NllbSpec(**spec), compute_dtype=dtype, device=dev)
    params, tree = model.init_random(g)
    return model, params, ResidentProvider(tree).pytree()


def _encoded(model, params, experts, tok, mask):
    return model.cross_kv(params, model.encode(params, experts, tok, mask,
                                               ResidentProvider.for_layer, "pallas"))


def test_generator_graph_equals_eager_f32(dev):
    """The resident generator's decode step, 24 steps at f32: graph and eager
    logits equal, tokens equal; two requests of one shape, one capture."""
    model, params, experts = _resident(dev, SPEC, torch.float32, 0)
    tok, mask = _inputs(dev, 0)
    graphed = Seq2SeqGenerator(model, params, experts, ResidentProvider.for_layer,
                               impl="pallas")
    eager = Seq2SeqGenerator(model, params, experts, ResidentProvider.for_layer,
                             impl="pallas", graphs=False)
    with torch.inference_mode():
        cross = _encoded(model, params, experts, tok, mask)
        steps = [g.decoder(4, 32, mask, cross) for g in (graphed, eager)]
        cur = torch.full((4, 1), 2, dtype=torch.int32, device=dev)
        for step in range(24):
            (lg, ng), (le, ne) = (s(cur, step) for s in steps)
            torch.cuda.synchronize()
            assert torch.equal(ng, ne), step
            _same(lg, le, f"generator step {step}")
            cur = ne[:, None].to(torch.int32)
    ids, m = tok.cpu().numpy(), mask.cpu().numpy()
    gen = dict(max_new_tokens=24, attention_mask=m, eos_token_id=None)
    for _ in range(2):
        np.testing.assert_array_equal(graphed.generate(ids, **gen).sequences,
                                      eager.generate(ids, **gen).sequences)
    st = graphed.graph_stats()
    # generate's step reads the same buffers as decoder(4, 32) above
    assert (st["captures"], st["recaptures"]) == (1, 0)


def test_generator_serves_two_threads_on_two_streams(dev):
    """Fault F3 on the card: two threads, each on a stream of its own, send
    their own two rows (one shape) 5 times to one resident generator with
    graphs, whose graph and decoder buffers the two share. Every output
    equals the eager run's alone: the generator's lock serializes the
    requests and its event orders each after the replays of the one before.
    The embedding and attention are scaled up so that tokens depend on the
    source."""
    import threading

    model, params, experts = _resident(dev, SPEC, torch.float32, 0)
    params["embed"] = params["embed"] * 8.0
    for blk in params["enc_blocks"] + params["dec_blocks"]:
        for attn in ("self_attn", "cross_attn"):
            for n, f in (("q", 10.0), ("k", 10.0), ("v", 15.0), ("o", 15.0)):
                if attn in blk:
                    blk[attn][n] = blk[attn][n] * f
    graphed = Seq2SeqGenerator(model, params, experts, ResidentProvider.for_layer,
                               impl="pallas")
    eager = Seq2SeqGenerator(model, params, experts, ResidentProvider.for_layer,
                             impl="pallas", graphs=False)
    tok, mask = _inputs(dev, 0)
    ids, m = tok.cpu().numpy(), mask.cpu().numpy()
    reqs = [(ids[:2], m[:2]), (ids[2:], m[2:])]
    gen = dict(max_new_tokens=24, eos_token_id=None)
    want = [eager.generate(i, attention_mask=mm, **gen).sequences for i, mm in reqs]
    assert not np.array_equal(want[0], want[1])
    got, errors = [[None] * 5 for _ in reqs], []

    def serve(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                for n in range(5):
                    got[i][n] = graphed.generate(reqs[i][0], attention_mask=reqs[i][1],
                                                 **gen).sequences
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i in range(2):
        for out in got[i]:
            np.testing.assert_array_equal(out, want[i])
    assert graphed.graph_stats()["captures"] == 1


@pytest.mark.parametrize("seed", [7, 8])
def test_offload_step_graph_equals_eager_f32(dev, seed):
    """The speculative whole step (k=1) of the offload engine over an arena
    of 2E slots with prefetch and 4 workers, 24 steps, graph against eager
    on the same inputs: every accepted step's logits equal."""
    g = torch.Generator(device=dev).manual_seed(seed)
    model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    store = _store(seed)
    engines = [_engine(model, params, store, dev, None, slots=2 * E, speculative=True,
                       spec_block=1, graphs=gr) for gr in (True, False)]
    tok, mask = _inputs(dev, seed)
    try:
        with torch.inference_mode():
            state = []
            for eng in engines:
                seq_ids = [eng.tracer.create_entry() for _ in range(4)]
                _, cross = eng.run_encoder(tok, mask, seq_ids)
                state.append((seq_ids, cross, eng.init_cache(4, 32)))
            cur = torch.full((4, 1), 2, dtype=torch.int32, device=dev)
            for step in range(24):
                pos = torch.full((4, 1), step, dtype=torch.int32, device=dev)
                out = []
                for eng, (seq_ids, cross, kvs) in zip(engines, state):
                    logits, _ = eng._speculative_step(cur, pos, step, kvs, mask, cross,
                                                      eng.dec_mlis, seq_ids)
                    out.append(logits.clone())
                torch.cuda.synchronize()
                _same(out[0], out[1], f"offload step {step}")
                cur = torch.argmax(out[1][:, -1], -1, keepdim=True).to(torch.int32)
        assert engines[0].graph_stats()["captures"] == 1
        assert max(engines[0].replay_counts) > 1
    finally:
        for eng in engines:
            eng.arena.shutdown()


@pytest.mark.parametrize("k,mode", [(2, "whole"), (2, "prefix"), (4, "whole"), (4, "prefix")])
def test_offload_block_graph_tokens_equal_eager_bf16(dev, monkeypatch, k, mode):
    """Blocks of k in bf16 through the offload engine, the block size held at
    k: graph and eager greedy tokens equal. Each graph key is captured once;
    in whole mode the second request of the shape captures nothing new (in
    prefix mode it may meet a suffix size for the first time)."""
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    g = torch.Generator(device=dev).manual_seed(k)
    model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.bfloat16, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    store = _store(k)
    tok, mask = _inputs(dev, k)
    ids, m = tok.cpu().numpy(), mask.cpu().numpy()
    gen = dict(max_new_tokens=24, attention_mask=m, eos_token_id=None)
    seqs, engines = [], []
    try:
        for gr in (True, False):  # int4 slots: the arena holds no bf16 field
            eng = _engine(model, params, store, dev, None, slots=2 * E, speculative=True,
                          spec_block=k, graphs=gr)
            eng.adaptive_spec = False
            engines.append(eng)
            seqs.append(eng.generate(ids, **gen).sequences)
        np.testing.assert_array_equal(seqs[0], seqs[1])
        captures = engines[0].graph_stats()["captures"]
        np.testing.assert_array_equal(engines[0].generate(ids, **gen).sequences, seqs[1])
        st = engines[0].graph_stats()
        assert st["recaptures"] == 0 and st["captures"] == st["graphs"]
        assert mode == "prefix" or st["captures"] == captures
    finally:
        for eng in engines:
            eng.arena.shutdown()


def test_tickets_zero_after_replays_under_sync_guard(dev):
    """At NLLB-MoE-54B's width and a capacity of 1024, K1 splits its keys and
    K3 its reduction: after 50 replays, every ticket counter of the capture
    stream reads 0, and every replay ran under
    ``set_sync_debug_mode("error")``."""
    model, params, experts = _resident(dev, WIDE, torch.bfloat16, 1)
    tok, mask = _inputs(dev, 1)
    gen = Seq2SeqGenerator(model, params, experts, ResidentProvider.for_layer, impl="pallas")
    with torch.inference_mode():
        step = gen.decoder(4, 1024, mask, _encoded(model, params, experts, tok, mask))
        cur = torch.full((4, 1), 2, dtype=torch.int32, device=dev)
        _, nxt = step(cur, 0)  # the capture
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(1, 51):
                _, nxt = step(nxt[:, None].to(torch.int32), i)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    key = (dev, gen.graphs.backend.stream.cuda_stream)  # the capture stream's buffers
    tickets, scratch = _build._tickets.get(key), _build._workspaces.get(key)
    assert tickets is not None and scratch is not None  # split launches were captured
    assert int(tickets.abs().sum()) == 0
    assert gen.graph_stats()["replays"] == 51 and gen.graph_stats()["captures"] == 1


def test_moved_pointer_recaptures(dev):
    """A graph reads w by address: after w is replaced by a tensor elsewhere,
    the cache captures anew and reads the new one; it never replays the old
    graph."""
    cache = GraphCache(CudaGraphBackend(dev), dev)
    w = torch.arange(8, dtype=torch.float32, device=dev)

    def fn(x, step):
        return (x * torch.index_select(w, 0, step.long().reshape(1)),)

    (out,) = cache.run("f", fn, {"x": torch.ones(8, device=dev), "step": 3}, [w])
    assert out.tolist() == [3.0] * 8
    w = w * 10  # a new tensor at another address
    (out,) = cache.run("f", fn, {"x": torch.ones(8, device=dev), "step": 2}, [w])
    assert out.tolist() == [20.0] * 8
    assert (cache.captures, cache.recaptures) == (1, 1)


def _ffn_graph(dev, arena, x, cw):
    """K3's grouped FFN over the arena's slots as a graph whose inputs are
    the routed ids and the slot row, captured before any hazard."""
    cache = GraphCache(CudaGraphBackend(dev), dev)
    tree = arena.pytree()

    def fn(ids, row):
        return (_ffn(x, ids, cw, row, tree),)

    def run(ids, row):
        return cache.run("ffn", fn, {"ids": ids, "row": row}, list(tree.values()))[0]

    run(torch.zeros(6, 1, dtype=torch.int32, device=dev),
        torch.full((E,), -1, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    return cache, run


@pytest.mark.parametrize("tier_records", [0, 32])
def test_evicted_slot_leaves_queued_replay_alone(dev, tier_records):
    """``test_evicted_slot_leaves_queued_launch_alone`` with the K3 launches
    as graph replays: a replay reading key A's slot is queued behind a spin
    of some 0.3 s; A is released and B acquired into the same slot. The
    queued replay must still see A's bytes, the next replay B's."""
    store = _store(4)
    tier = _tier(store, dev, tier_records) if tier_records else None
    arena = ExpertArena(store, 1, compute_dtype=torch.float32, device=dev, num_threads=4,
                        pinned_tier=tier)
    resident = ResidentProvider.from_store(store, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(6, D, generator=g, device=dev)
    cw = torch.ones(6, 1, device=dev)
    a, b = (2, 5), (2, 6)
    try:
        cache, ffn = _ffn_graph(dev, arena, x, cw)
        want, out = {}, {}
        for key in (a, b):
            w, row, bias = ResidentProvider.for_layer(resident.pytree(), key[0])
            ids = torch.full((6, 1), key[1], dtype=torch.int32, device=dev)
            want[key] = grouped_ffn(x, ids, cw, row, w, "relu", biases=bias, impl="pallas")
        torch.cuda.synchronize()
        for key in (a, b):
            arena.acquire([key], key[0])
            ids = torch.full((6, 1), key[1], dtype=torch.int32, device=dev)
            row = torch.from_numpy(arena.slot_map(key[0])).to(dev)
            with arena.locked_tree([key]):
                if key == a:
                    torch.cuda._sleep(500_000_000)
                out[key] = ffn(ids, row).clone()  # the next replay overwrites it
            arena.release([key])
        torch.cuda.synchronize()
        assert arena.hit_stats()["evictions"] == 1
        assert cache.stats()["captures"] == 1 and cache.stats()["replays"] == 3
        for key in (a, b):
            assert torch.equal(out[key], want[key]), key
    finally:
        arena.shutdown()


@pytest.mark.parametrize("tier_records", [0, 32])
def test_snapshot_key_evicted_under_queued_replay_is_a_miss(dev, tier_records):
    """``test_snapshot_key_evicted_under_queued_launch_is_a_miss`` with the
    dispatch's K3 launches as a graph replay: A is evicted and B lands in
    A's slot inside the dispatch scope, under the queued replay's read.
    Verification counts A as a miss, and the accepted execution equals the
    resident result bit for bit."""
    store = _store(5)
    tier = _tier(store, dev, tier_records) if tier_records else None
    arena = ExpertArena(store, 1, compute_dtype=torch.float32, device=dev, num_threads=4,
                        pinned_tier=tier)
    resident = ResidentProvider.from_store(store, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(6, D, generator=g, device=dev)
    cw = torch.ones(6, 1, device=dev)
    a, b = (2, 5), (2, 6)
    ids = torch.full((6, 1), a[1], dtype=torch.int32, device=dev)
    calls = []
    try:
        w, row, bias = ResidentProvider.for_layer(resident.pytree(), a[0])
        want = grouped_ffn(x, ids, cw, row, w, "relu", biases=bias, impl="pallas")
        cache, ffn = _ffn_graph(dev, arena, x, cw)
        arena.warm([a])

        def run(tree, slot_rows):
            calls.append(int(slot_rows[a[0], a[1]]))
            if len(calls) == 1:
                torch.cuda._sleep(500_000_000)
            out = ffn(ids, slot_rows[a[0]])
            trace = torch.full((1, 6, 1), a[1], dtype=torch.int32, device=dev)
            if len(calls) == 1:  # evict A, land B in its slot, under the queued replay
                arena.acquire([b], b[0])
                arena.release([b])
            return out, trace

        (got,), _, execs = run_speculative(arena, [a[0]], run, 4)
        torch.cuda.synchronize()
        assert execs == 2 and arena.lease_evictions == 1
        assert calls[0] >= 0
        assert cache.stats()["captures"] == 1
        assert torch.equal(got, want)
    finally:
        arena.shutdown()


def test_replay_after_a_later_warmup_grew_the_workspace(dev):
    """Queue-3 fault F1: a graph of a split K3 call is captured; a second
    graph of the same backend, whose warm-up needs more split scratch, grows
    the capture stream's workspace; the allocators' caches are emptied and a
    buffer of the old workspace's size is allocated and filled. The first
    graph's replay then equals the eager call bit for bit, every ticket
    counter reads 0, the filled buffer is untouched, and the outgrown
    workspace is still held (``_build.grown``)."""
    from moe_infinity_tpu_torch.ops import gmm as gm

    g = torch.Generator(device=dev).manual_seed(11)
    S, D, F = 8, 4096, 4096
    w = (torch.randn(S, D, F, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    small = torch.full((S,), 1, dtype=torch.int32, device=dev)
    large = torch.full((S,), 32, dtype=torch.int32, device=dev)
    assert gm._gmm_plan(8, S, D, F).splits > 1 and gm._gmm_plan(256, S, D, F).splits > 1
    cache = GraphCache(CudaGraphBackend(dev), dev)
    key = (dev, cache.backend.stream.cuda_stream)
    x8 = torch.randn(8, D, generator=g, device=dev).to(torch.bfloat16)
    x256 = torch.randn(256, D, generator=g, device=dev).to(torch.bfloat16)

    def run_small(x):
        return (gm.gmm(x, w, small),)

    with torch.inference_mode():
        want = gm.gmm(x8, w, small)
        cache.run("small", run_small, {"x": x8}, [w, small])
        old = _build._workspaces[key]
        old_ptr, old_n = old.data_ptr(), old.numel()
        del old
        cache.run("large", lambda x: (gm.gmm(x, w, large),), {"x": x256}, [w, large])
        assert _build._workspaces[key].numel() > old_n  # the warm-up grew it
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        filler = torch.full((old_n,), 7.0, device=dev)
        (got,) = cache.run("small", run_small, {"x": x8}, [w, small])
        torch.cuda.synchronize()
    assert (cache.captures, cache.recaptures, cache.replays) == (2, 0, 3)
    assert torch.equal(got, want)
    assert any(t.data_ptr() == old_ptr for t in _build._retired)
    assert bool((filler == 7.0).all())
    counters = [t for (d, _), t in _build._tickets.items() if d == dev]
    counters += [t for t in _build._retired if t.dtype == torch.int32]
    assert all(int(t.abs().sum()) == 0 for t in counters)


def test_mixtral_offload_step_graph_equals_eager_f32(dev):
    """The decoder-only engine's speculative whole step as a graph against
    the same engine run eagerly (``graphs=False``: the step then as a 0-d
    tensor too, so both plan K1 from the capacity), one row, 2E slots with
    prefetch and 4 workers, 32 steps: every step's logits bit for bit, and
    the graph replays in a step that follows one whose fetches evicted
    slots it reads."""
    runs, marks = {}, []
    for graphs in (True, False):
        model, params, experts, engine = mixtral_offload(dev, 13, 2 * E, speculative=True,
                                                         graphs=graphs)
        prompt = np.random.default_rng(13).integers(0, 300, (1, 16))
        runs[graphs] = []
        try:
            with torch.inference_mode():
                for _, got, _ in mixtral_steps(engine, model, params, experts, prompt, 32):
                    runs[graphs].append(got.clone())
                    if graphs:  # (evictions, replays) after each step
                        marks.append((engine.arena.hit_stats()["evictions"],
                                      engine.graph_stats()["replays"]))
            if graphs:
                st = engine.graph_stats()
        finally:
            engine.arena.shutdown()
    for step, (a, b) in enumerate(zip(runs[True], runs[False])):
        assert torch.equal(a, b), f"Mixtral offload step {step}"
    assert st["captures"] == 1 and st["recaptures"] == 0 and st["replays"] > 32
    assert any(e1 > e0 and r2 > r1 for (e0, _), (e1, r1), (_, r2)
               in zip(marks, marks[1:], marks[2:]))


# ---- the seq2seq continuous batcher's graph ---------------------------------------

def _batchers(dev):
    """A graphed and an eager Seq2SeqContinuousBatcher over one f32 model,
    their threads stopped: the tests drive admission and steps by hand, and
    record each step's logits."""
    from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher

    model, params, experts = _resident(dev, SPEC, torch.float32, 3)
    out = []
    for graphs in (True, False):
        b = Seq2SeqContinuousBatcher(model, params, experts, ResidentProvider.for_layer,
                                     impl="pallas", max_batch_size=3, max_src_len=32,
                                     max_decode_len=32, graphs=graphs)
        b.shutdown()
        b.logits = []
        step = b._step

        def record(*a, _step=step, _b=b):
            lg, nxt, trace = _step(*a)
            _b.logits.append(lg.clone())
            return lg, nxt, trace

        b._step = record
        out.append(b)
    return out


def _sources(dev, seed, n):
    tok, _ = _inputs(dev, seed)
    ids = tok.cpu().numpy()
    return [row[row != 1] for row in ids[:n]]


def test_s2s_batcher_join_between_replays_equals_eager(dev):
    """A row seated between two replays (its cross K/V and mask copied into
    the buffers the graph reads) gives the eager step's logits, at every
    step, bit for bit or within 1e-5."""
    graphed, eager = _batchers(dev)
    start = SPEC["decoder_start_token_id"]
    srcs = _sources(dev, 5, 3)
    with torch.inference_mode():
        for b in (graphed, eager):
            b.submit(srcs[0], max_new_tokens=12)
            b._admit()
            for i in range(10):
                if i in (3, 6):  # joins mid-flight, between replays
                    b.submit(srcs[1 + (i == 6)], max_new_tokens=8)
                    b._admit()
                b._step_once(start)
    torch.cuda.synchronize()
    assert len(graphed.logits) == len(eager.logits) == 10
    for i, (lg, le) in enumerate(zip(graphed.logits, eager.logits)):
        _same(lg, le, f"batcher step {i}")
    st = graphed.graph_stats()
    assert (st["captures"], st["recaptures"], st["replays"]) == (1, 0, 10)


def test_s2s_batcher_graph_replays_after_a_failed_step(dev):
    """After ``_fail_active`` the caches are zeroed in place: every address
    the graph reads is unchanged, no capture follows, and the next requests'
    logits equal the eager batcher's."""
    graphed, eager = _batchers(dev)
    start = SPEC["decoder_start_token_id"]
    srcs = _sources(dev, 6, 2)

    def addresses(b):
        return [t.data_ptr() for t in (b._ck, b._cv, b._mask)] + [
            t.data_ptr() for kv in b._kvs for t in (kv.k, kv.v)]

    with torch.inference_mode():
        graphed.submit(srcs[0], max_new_tokens=8)
        graphed._admit()
        for _ in range(3):
            graphed._step_once(start)
        before = addresses(graphed)
        graphed._fail_active(RuntimeError("injected"))
        assert addresses(graphed) == before
        graphed.logits.clear()
        for b in (graphed, eager):
            for s in srcs:
                b.submit(s, max_new_tokens=6)
            b._admit()
            for _ in range(6):
                b._step_once(start)
    torch.cuda.synchronize()
    for i, (lg, le) in enumerate(zip(graphed.logits, eager.logits)):
        _same(lg, le, f"step {i} after the failure")
    st = graphed.graph_stats()
    assert (st["captures"], st["recaptures"], st["replays"]) == (1, 0, 9)


def test_s2s_batcher_defaults_refuse_on_the_card(dev):
    """At its defaults ("ragged", graphs on) the batcher refuses on the card
    with a ValueError at construction, before any request could fail."""
    from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher

    model, params, experts = _resident(dev, SPEC, torch.float32, 3)
    with pytest.raises(ValueError, match="cannot run inside a CUDA graph"):
        Seq2SeqContinuousBatcher(model, params, experts, ResidentProvider.for_layer)


def test_sampled_decode_scan_replays_draw_fresh_noise(dev):
    """A generator registered with a graph (``decode_scan``'s): two replays
    of one capture draw different noise, the two draws an eager run of the
    same seed makes; reseeding replays them again."""
    from moe_infinity_tpu_torch.runtime.sampling import gumbel

    gen = torch.Generator(device=dev)
    cache = GraphCache(CudaGraphBackend(dev), dev)
    x = torch.zeros(4, 1000, device=dev)
    g = cache.get("noise", lambda x: (x + gumbel(x.shape, gen, dev),), {"x": x}, [],
                  generators=[gen])
    gen.manual_seed(3)
    a = cache.replay(g, {"x": x})[0].clone()
    b = cache.replay(g, {"x": x})[0].clone()
    assert not torch.equal(a, b)
    e = torch.Generator(device=dev).manual_seed(3)
    assert torch.equal(a, gumbel(x.shape, e, dev)) and torch.equal(b, gumbel(x.shape, e, dev))
    gen.manual_seed(3)
    assert torch.equal(cache.replay(g, {"x": x})[0], a)


def test_sampled_decode_scan_graph_equals_eager(dev):
    """``Seq2SeqGenerator.decode_scan`` sampled (temperature 0.8, top-p 0.9,
    repetition penalty 1.1) over 20 steps (two blocks and a remainder):
    graph and eager tokens equal at one seed, a seed gives the same tokens
    twice, two seeds differ."""
    from moe_infinity_tpu_torch.runtime.sampling import SamplingParams

    model, params, experts = _resident(dev, SPEC, torch.float32, 0)
    tok, _ = _inputs(dev, 0)
    src = tok.cpu().numpy()
    sp = SamplingParams(temperature=0.8, top_p=0.9, repetition_penalty=1.1)
    graphed = Seq2SeqGenerator(model, params, experts, ResidentProvider.for_layer, impl="pallas")
    eager = Seq2SeqGenerator(model, params, experts, ResidentProvider.for_layer, impl="pallas",
                             graphs=False)
    a = graphed.decode_scan(src, 20, sampling=sp, seed=11)[0].clone()
    assert torch.equal(a, graphed.decode_scan(src, 20, sampling=sp, seed=11)[0])
    assert torch.equal(a, eager.decode_scan(src, 20, sampling=sp, seed=11)[0])
    assert not torch.equal(a, graphed.decode_scan(src, 20, sampling=sp, seed=12)[0])
    assert graphed.graph_stats()["captures"] == 2
