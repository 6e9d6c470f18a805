"""The port's offload path on the card: the slot arena's side-stream
landings against stream-ordered reads, on the per-layer and the
speculative path. Marked ``cuda``: they skip without a
CUDA device. On a machine with one, run them with ``python3 -m pytest
--noconftest -m cuda tests/test_torch_cuda_offload.py`` (``--noconftest``:
the repo conftest imports jax).

The decoder-only ``OffloadEngine`` (Mixtral, int8 slots, K1 planned from
the cache's capacity on the speculative path) is held to the resident
``Generator`` the same way.

The hazards: a key is registered while its copy may still run on a worker
stream (read after write), and a slot is evicted as soon as its key is
released while the K3 launch that read it may only be queued (write after
read). A speculative dispatch also reads slots of keys it has not
acquired, so a worker may evict one and land another record in its slot
while the dispatch's launches are queued; the arena then counts the key as
a miss. Copies on the CPU are synchronous, so only the card shows these.
Every check here is exact: the same bytes through the same kernels give
the same bits."""

import numpy as np
import pytest
import torch

from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
from moe_infinity_tpu_torch.ops.moe import grouped_ffn
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.engine import OffloadEngine, run_speculative
from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine
from moe_infinity_tpu_torch.runtime.generate import Generator, Seq2SeqGenerator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store.blob import SyntheticStore
from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

pytestmark = pytest.mark.cuda

SPEC = dict(
    vocab_size=300, d_model=256, num_heads=2, encoder_layers=4, decoder_layers=4,
    encoder_ffn_dim=512, decoder_ffn_dim=512, encoder_sparse_step=2,
    decoder_sparse_step=2, num_experts=8, pad_token_id=1, decoder_start_token_id=2,
    max_positions=128, scale_embedding=True,
)
D, F, E, LAYERS = 256, 512, 8, 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _store(seed=0):
    fields = [("fc1.weight", (D, F // 2), "int4"), ("fc1.weight.scale", (F,), "float32"),
              ("fc1.bias", (F,), "float32"), ("fc2.weight", (F, D // 2), "int4"),
              ("fc2.weight.scale", (D,), "float32"), ("fc2.bias", (D,), "float32")]
    return SyntheticStore(LAYERS, E, fields, meta={"arch": "nllb", "num_encoder_moe_layers": 2},
                          seed=seed, distinct_records=True, cache_records=LAYERS * E)


def _tier(store, dev, records):
    """A tier copied from the store's records (so every key has one value),
    decoder records first, ``records`` of them."""
    return PinnedExpertTier(store, device=dev, shared_record=False,
                            max_bytes=records * store.stride, synth_on_device=False)


def _engine(model, params, store, dev, tier, slots=E, **kw):
    tracer = ExpertTracer(64, LAYERS, E, num_encoder_layers=2)
    arena = ExpertArena(store, slots, compute_dtype=torch.float32, device=dev, num_threads=4,
                        pinned_tier=tier)
    return Seq2SeqOffloadEngine(model, params, arena, tracer=tracer,
                                predictor=ExpertPredictor(tracer), prefetch=True, lookahead=3,
                                prefetch_budget=8, impl="pallas", **kw)


def _inputs(dev, seed):
    rng = np.random.default_rng(seed)
    lens = (24, 17, 12, 6)
    ids = np.full((4, 24), 1, np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(3, SPEC["vocab_size"], n)
        ids[i, n - 1] = 2
    mask = (ids != 1).astype(np.float32)
    return torch.as_tensor(ids, dtype=torch.int32, device=dev), torch.as_tensor(mask, device=dev)


@pytest.mark.parametrize("seed,tier_records", [(0, 0), (1, 20), (2, 40)])
def test_offload_decode_equals_resident_bitwise(dev, seed, tier_records):
    """Per-layer offload through an arena of E slots with prefetch and 4
    workers, step by step beside the resident path: logits equal bit for
    bit at every step, over steps whose routing evicts at every MoE layer."""
    g = torch.Generator(device=dev).manual_seed(seed)
    model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    store = _store(seed)
    resident = ResidentProvider.from_store(store, dtype=torch.float32, device=dev)
    experts, for_layer = resident.pytree(), ResidentProvider.for_layer
    tier = _tier(store, dev, tier_records) if tier_records else None
    engine = _engine(model, params, store, dev, tier)
    tok, mask = _inputs(dev, seed)
    B = tok.shape[0]
    try:
        with torch.inference_mode():
            seq_ids = [engine.tracer.create_entry() for _ in range(B)]
            _, cross_o = engine.run_encoder(tok, mask, seq_ids)
            engine._prefetch_decoder_tier(seq_ids)
            cross_r = model.cross_kv(params, model.encode(params, experts, tok, mask,
                                                          for_layer, "pallas"))
            kv_o, kv_r = engine.init_cache(B, 32), model.init_cache(B, 32)
            cur = torch.full((B, 1), 2, dtype=torch.int32, device=dev)
            for step in range(24):
                pos = torch.full((B, 1), step, dtype=torch.int32, device=dev)
                got = engine.decode_step(cur, step, kv_o, mask, cross_o, seq_ids)
                want, _, _ = model.decode_step(params, experts, cur, pos, kv_r, step, mask,
                                               cross_r, for_layer, "pallas")
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"step {step}"
                cur = torch.argmax(want[:, -1], -1, keepdim=True).to(torch.int32)
        ev = engine.arena.policy.node_stats["evictions"].sum(axis=1)
        assert (ev > 0).all(), ev
        if tier_records:
            assert engine.arena.fetch_stats()["fetches_tier"] > 0
    finally:
        engine.arena.shutdown()


def _want_slot(store, key):
    rec = store.get_expert(*key)
    return {"gate4": rec["fc1.weight"], "gate_scale": rec["fc1.weight.scale"],
            "gate_bias": rec["fc1.bias"], "down4": rec["fc2.weight"],
            "down_scale": rec["fc2.weight.scale"], "down_bias": rec["fc2.bias"]}


def test_landing_is_repeatable_under_prefetch_storms(dev):
    """Random acquires against a 6-slot arena while prefetch plans are
    replaced between them, 4 workers, tier and store paths: every acquired
    slot holds exactly its record's bytes when the compute stream reads it."""
    store = _store(3)
    arena = ExpertArena(store, 6, compute_dtype=torch.float32, device=dev, num_threads=4,
                        pinned_tier=_tier(store, dev, 12))
    rng = np.random.default_rng(3)
    try:
        for _ in range(60):
            arena.prefetch([(int(rng.integers(LAYERS)), int(rng.integers(E))) for _ in range(4)])
            keys = sorted({(int(rng.integers(LAYERS)), int(rng.integers(E))) for _ in range(3)})
            arena.acquire(keys, keys[0][0])
            with arena.locked_tree(keys) as tree:
                got = {k: {n: t[arena.key_to_slot[k]].clone() for n, t in tree.items()}
                       for k in keys}
            arena.release(keys)
            torch.cuda.synchronize()
            for k in keys:
                for n, want in _want_slot(store, k).items():
                    assert np.array_equal(got[k][n].cpu().numpy(), want), (k, n)
        s = arena.fetch_stats()
        assert s["fetches_tier"] > 0 and s["fetches_store"] > 0
        assert arena.hit_stats()["evictions"] > 0
    finally:
        arena.shutdown()


def _ffn(x, ids, cw, row, tree):
    w = {k: v for k, v in tree.items() if "bias" not in k}
    b = {k: v for k, v in tree.items() if "bias" in k}
    return grouped_ffn(x, ids, cw, row, w, "relu", biases=b, impl="pallas")


@pytest.mark.parametrize("tier_records", [0, 32])
def test_evicted_slot_leaves_queued_launch_alone(dev, tier_records):
    """Write after read, then read after write, on a one-slot arena: a K3
    launch reading key A's slot is queued behind a spin of some 0.3 s; A is
    released and B acquired, which evicts A and lands B in the same slot.
    The queued launch must still see A's bytes, and a launch queued right
    after the acquire must see B's: both equal the resident results."""
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
        want = {}
        for key in (a, b):
            w, row, bias = ResidentProvider.for_layer(resident.pytree(), key[0])
            ids = torch.full((6, 1), key[1], dtype=torch.int32, device=dev)
            want[key] = grouped_ffn(x, ids, cw, row, w, "relu", biases=bias, impl="pallas")
        torch.cuda.synchronize()
        out = {}
        for key in (a, b):
            arena.acquire([key], key[0])
            ids = torch.full((6, 1), key[1], dtype=torch.int32, device=dev)
            row = torch.from_numpy(arena.slot_map(key[0])).to(dev)
            with arena.locked_tree([key]) as tree:
                if key == a:
                    torch.cuda._sleep(500_000_000)
                out[key] = _ffn(x, ids, cw, row, tree)
            arena.release([key])
        torch.cuda.synchronize()
        assert arena.hit_stats()["evictions"] == 1
        for key in (a, b):
            assert torch.equal(out[key], want[key]), key
    finally:
        arena.shutdown()


@pytest.mark.parametrize("tier_records", [0, 32])
def test_snapshot_key_evicted_under_queued_launch_is_a_miss(dev, tier_records):
    """A speculative dispatch on a one-slot arena reads key A's slot by a K3
    launch queued behind a spin of some 0.3 s; inside the same dispatch
    scope A is evicted and B lands in A's slot, a copy the launch's queued
    read does not fence. Verification must count A as a miss, and the
    accepted execution must equal the resident result bit for bit."""
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
        arena.warm([a])

        def run(tree, slot_rows):
            calls.append(int(slot_rows[a[0], a[1]]))
            if len(calls) == 1:
                torch.cuda._sleep(500_000_000)
            out = _ffn(x, ids, cw, slot_rows[a[0]], tree)
            trace = torch.full((1, 6, 1), a[1], dtype=torch.int32, device=dev)
            if len(calls) == 1:  # evict A, land B in its slot, under the queued read
                arena.acquire([b], b[0])
                arena.release([b])
            return out, trace

        (got,), _, execs = run_speculative(arena, [a[0]], run, 4)
        torch.cuda.synchronize()
        assert execs == 2 and arena.lease_evictions == 1
        assert calls[0] >= 0  # A was resident at the first snapshot
        assert torch.equal(got, want)
    finally:
        arena.shutdown()


@pytest.mark.parametrize("k,mode", [(1, "whole"), (4, "whole"), (4, "prefix")])
def test_speculative_decode_equals_resident_bitwise(dev, monkeypatch, k, mode):
    """24 speculative decode steps through an arena of 2E slots with
    prefetch and 4 workers, beside the resident path: at k=1 every step's
    logits equal bit for bit; blocks of 4, in both modes, give equal
    tokens. Steps evict and replay."""
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    g = torch.Generator(device=dev).manual_seed(7)
    model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    store = _store(7)
    resident = ResidentProvider.from_store(store, dtype=torch.float32, device=dev)
    experts, for_layer = resident.pytree(), ResidentProvider.for_layer
    engine = _engine(model, params, store, dev, None, slots=2 * E, speculative=True,
                     spec_block=k)
    tok, mask = _inputs(dev, 7)
    B = tok.shape[0]
    try:
        with torch.inference_mode():
            if k == 1:
                seq_ids = [engine.tracer.create_entry() for _ in range(B)]
                _, cross_o = engine.run_encoder(tok, mask, seq_ids)
                engine._prefetch_decoder_tier(seq_ids)
                cross_r = model.cross_kv(params, model.encode(params, experts, tok, mask,
                                                              for_layer, "pallas"))
                kv_o, kv_r = engine.init_cache(B, 32), model.init_cache(B, 32)
                cur = torch.full((B, 1), 2, dtype=torch.int32, device=dev)
                for step in range(24):
                    pos = torch.full((B, 1), step, dtype=torch.int32, device=dev)
                    got, kv_o = engine._speculative_step(cur, pos, step, kv_o, mask, cross_o,
                                                         engine.dec_mlis, seq_ids)
                    want, _, _ = model.decode_step(params, experts, cur, pos, kv_r, step, mask,
                                                   cross_r, for_layer, "pallas")
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), f"step {step}"
                    cur = torch.argmax(want[:, -1], -1, keepdim=True).to(torch.int32)
            else:
                ids, m = tok.cpu().numpy(), mask.cpu().numpy()
                got = engine.generate(ids, max_new_tokens=24, attention_mask=m,
                                      eos_token_id=None)
                want = Seq2SeqGenerator(model, params, experts, for_layer, impl="pallas").generate(
                    ids, max_new_tokens=24, attention_mask=m, eos_token_id=None)
                np.testing.assert_array_equal(got.sequences, want.sequences)
        assert max(engine.replay_counts) > 1
        assert engine.arena.hit_stats()["evictions"] > 0
    finally:
        engine.arena.shutdown()


# ---- Switch (K2 at head dim 64 with the T5 bias) -------------------------------

SWITCH = dict(
    vocab_size=300, d_model=256, d_kv=64, d_ff=512, num_heads=4,
    num_encoder_layers=4, num_decoder_layers=4, encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=E, expert_capacity=8, rel_buckets=32, rel_max_distance=128, rms_eps=1e-6,
    tie_embeddings=True, is_gated=False, dense_act_gelu=False, decoder_start_token_id=0,
)


def _switch_store(seed):
    fields = [("wi.weight", (D, F // 2), "int4"), ("wi.weight.scale", (F,), "float32"),
              ("wo.weight", (F, D // 2), "int4"), ("wo.weight.scale", (D,), "float32")]
    return SyntheticStore(LAYERS, E, fields, meta={"arch": "switch", "num_encoder_moe_layers": 2},
                          seed=seed, distinct_records=True, cache_records=LAYERS * E)


@pytest.mark.parametrize("speculative,k", [(False, 1), (True, 1), (True, 4)])
def test_switch_offload_equals_resident_bitwise(dev, speculative, k):
    """Switch at f32 (head dim 64, the T5 bias, capacity 8 so that the
    encoder drops tokens) through an arena of E slots (per-layer) or 2E
    (speculative, k = 1 and blocks of 4, graphs), prefetch and 4 workers,
    beside the resident path over the same store: per-layer, every step's
    logits equal bit for bit over 24 steps; speculative, greedy tokens."""
    from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec

    g = torch.Generator(device=dev).manual_seed(5)
    model = SwitchModel(SwitchSpec(**SWITCH), compute_dtype=torch.float32, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    store = _switch_store(5)
    resident = ResidentProvider.from_store(store, dtype=torch.float32, device=dev)
    experts, for_layer = resident.pytree(), ResidentProvider.for_layer
    tracer = ExpertTracer(64, LAYERS, E, num_encoder_layers=2)
    arena = ExpertArena(store, 2 * E if speculative else E, compute_dtype=torch.float32,
                        device=dev, num_threads=4)
    engine = Seq2SeqOffloadEngine(model, params, arena, tracer=tracer,
                                  predictor=ExpertPredictor(tracer), prefetch=True,
                                  impl="pallas", speculative=speculative, spec_block=k)
    tok, mask = _inputs(dev, 5)
    mask[:, 20:] = 0.0  # padded rows beside the shorter sources
    B = tok.shape[0]
    try:
        with torch.inference_mode():
            if not speculative:
                seq_ids = [engine.tracer.create_entry() for _ in range(B)]
                _, cross_o = engine.run_encoder(tok, mask, seq_ids)
                cross_r = model.cross_kv(params, model.encode(params, experts, tok, mask,
                                                              for_layer, "pallas"))
                kv_o, kv_r = engine.init_cache(B, 32), model.init_cache(B, 32)
                cur = torch.zeros((B, 1), dtype=torch.int32, device=dev)
                for step in range(24):
                    pos = torch.full((B, 1), step, dtype=torch.int32, device=dev)
                    got = engine.decode_step(cur, step, kv_o, mask, cross_o, seq_ids)
                    want, _, _ = model.decode_step(params, experts, cur, pos, kv_r, step, mask,
                                                   cross_r, for_layer, "pallas")
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), f"step {step}"
                    cur = torch.argmax(want[:, -1], -1, keepdim=True).to(torch.int32)
                ev = engine.arena.policy.node_stats["evictions"].sum(axis=1)
                assert (ev > 0).all(), ev
            else:
                ids, m = tok.cpu().numpy(), mask.cpu().numpy()
                kw = dict(max_new_tokens=24, attention_mask=m, eos_token_id=None)
                got = engine.generate(ids, **kw)
                want = Seq2SeqGenerator(model, params, experts, for_layer,
                                        impl="pallas").generate(ids, **kw)
                np.testing.assert_array_equal(got.sequences, want.sequences)
                assert engine.speculative and engine.graph_stats()["replays"] > 0
    finally:
        engine.arena.shutdown()


# ---- Mixtral (the decoder-only OffloadEngine, int8 slots) ------------------------

MIXTRAL = dict(
    vocab_size=300, hidden_size=D, intermediate_size=F, num_layers=LAYERS, num_heads=4,
    num_kv_heads=2, head_dim=128, num_experts=E, top_k=2, rms_eps=1e-5, rope_theta=1e6,
    tie_embeddings=False,
)
# a capacity of 128: K1 planned from it splits the keys in two, while the
# live keys (16 + 24) fit one split, as the resident path plans them
CAP = 128


def _mixtral_store(seed):
    """bench.py's Mixtral store at MIXTRAL's width: int8 w1/w3/w2 with f32
    per-channel scales, records distinct per expert."""
    fields = []
    for tail, shape in (("w1", (D, F)), ("w3", (D, F)), ("w2", (F, D))):
        fields += [(tail + ".weight", shape, "int8"),
                   (tail + ".weight.scale", shape[1:], "float32")]
    return SyntheticStore(LAYERS, E, fields, meta={"arch": "mixtral", "gated": True,
                                                   "num_encoder_moe_layers": 0},
                          seed=seed, distinct_records=True, cache_records=LAYERS * E)


def mixtral_offload(dev, seed, slots, prefetch=True, **kw):
    """(model, params, the resident tree over the store's records, an
    engine over ``slots`` slots with 4 workers, K3 throughout), f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    model = MixtralModel(MixtralSpec(**MIXTRAL), compute_dtype=torch.float32, device=dev)
    params, _ = model.init_random(g, with_experts=False)
    store = _mixtral_store(seed)
    experts = ResidentProvider.from_store(store, dtype=torch.float32, device=dev).pytree()
    tracer = ExpertTracer(64, LAYERS, E)
    arena = ExpertArena(store, slots, compute_dtype=torch.float32, device=dev, num_threads=4)
    engine = OffloadEngine(model, params, arena, tracer=tracer,
                           predictor=ExpertPredictor(tracer), prefetch=prefetch, lookahead=3,
                           prefetch_budget=8, impl="pallas", **kw)
    return model, params, experts, engine


def mixtral_steps(engine, model, params, experts, prompt, n):
    """Prefill ``prompt`` [B, T] through the engine and the resident model,
    then ``n`` greedy one-token steps of each on the resident path's
    tokens; yields (step, engine logits, resident logits)."""
    dev = model.device
    B, T = prompt.shape
    tok = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    seq_ids = engine.begin_sequences(B)
    kv_o, kv_r = engine.init_cache(B, CAP), model.init_cache(B, CAP)
    got, _, _ = engine.forward(tok, pos, kv_o, 0, seq_ids)
    want, _, _ = model.forward(params, experts, tok, pos, kv_r, 0,
                               for_layer=ResidentProvider.for_layer, impl="pallas")
    yield -1, got, want
    cur = torch.argmax(want[:, -1], -1, keepdim=True).to(torch.int32)
    for step in range(T, T + n):
        pos = torch.full((B, 1), step, dtype=torch.int32, device=dev)
        got, _, _ = engine.forward(cur, pos, kv_o, step, seq_ids)
        want, _, _ = model.forward(params, experts, cur, pos, kv_r, step,
                                   for_layer=ResidentProvider.for_layer, impl="pallas")
        yield step, got, want
        cur = torch.argmax(want[:, -1], -1, keepdim=True).to(torch.int32)
    engine.end_sequences(seq_ids)


@pytest.mark.parametrize("speculative", [False, True])
def test_mixtral_offload_equals_resident_bitwise(dev, speculative):
    """Mixtral at f32 beside the resident model over the same store, 24
    steps after a 16-token prefill: per-layer through an arena of E slots (4
    rows, evictions at every MoE layer), or the speculative whole step as a
    graph through 2E slots (one row: its union fits); every step's logits
    equal bit for bit."""
    B, slots = (1, 2 * E) if speculative else (4, E)
    model, params, experts, engine = mixtral_offload(dev, 11, slots, speculative=speculative)
    prompt = np.random.default_rng(11).integers(0, 300, (B, 16))
    try:
        with torch.inference_mode():
            for step, got, want in mixtral_steps(engine, model, params, experts, prompt, 24):
                torch.cuda.synchronize()
                assert torch.equal(got, want), f"step {step}"
        if speculative:
            assert engine.speculative and max(engine.replay_counts) > 1
            assert engine.graph_stats()["replays"] == sum(engine.replay_counts)
        else:
            ev = engine.arena.policy.node_stats["evictions"].sum(axis=1)
            assert (ev > 0).all(), ev
    finally:
        engine.arena.shutdown()


@pytest.mark.parametrize("mode", ["whole", "prefix"])
def test_mixtral_speculative_blocks_equal_resident(dev, monkeypatch, mode):
    """Greedy blocks of 2 steps through ``Generator`` as graphs, one row,
    an arena of 3E slots without prefetch: the tokens of 24 new tokens
    equal the resident ``Generator``'s; blocks run again on a miss."""
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    k = 2
    model, params, experts, engine = mixtral_offload(dev, 12, 3 * E, prefetch=False,
                                                     speculative=True, spec_block=k)
    prompt = np.random.default_rng(12).integers(0, 300, (1, 16))
    try:
        got = Generator(stepper=engine).generate(prompt, max_new_tokens=24, cache_len=CAP)
        want = Generator(model, params, experts, ResidentProvider.for_layer, impl="pallas"
                         ).generate(prompt, max_new_tokens=24, cache_len=CAP)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        assert engine.spec_block == k and max(engine.replay_counts) > 1
        assert engine.graph_stats()["replays"] == sum(engine.replay_counts)
    finally:
        engine.arena.shutdown()


def test_dense_landing_waits_for_queued_reads(dev):
    """Write after read on the dense arena: a read of layer 0's slot is
    queued behind a spin of some 0.3 s and layer 0 released; acquiring layer
    1 evicts layer 0 (the ring's furthest next use) and lands layer 1 in the
    same slot on a worker's stream. The queued read must still see layer 0,
    and a read queued after the acquire must see layer 1."""
    from moe_infinity_tpu_torch.runtime.dense_arena import DenseLayerArena

    g = torch.Generator().manual_seed(0)
    layers = [{"w": torch.randn(1024, 1024, generator=g)} for _ in range(3)]
    arena = DenseLayerArena(layers, 2, device=dev, ahead=0, num_threads=2)
    x = torch.randn(64, 1024, generator=g).to(dev)
    try:
        want = [x @ lt["w"].to(dev) for lt in layers]
        torch.cuda.synchronize()
        arena.acquire(2)
        arena.release(2)
        s0 = arena.acquire(0)
        torch.cuda._sleep(500_000_000)
        out0 = x @ arena.layer_view(0, s0)["w"]
        arena.release(0)
        s1 = arena.acquire(1)
        out1 = x @ arena.layer_view(1, s1)["w"]
        arena.release(1)
        torch.cuda.synchronize()
        assert s1 == s0 and 0 not in arena.layer_to_slot
        assert torch.equal(out0, want[0]) and torch.equal(out1, want[1])
    finally:
        arena.shutdown()


def test_zero_slot_through_k3_contributes_zero(dev):
    """The host fallback's zero slot through K3 (int4 slots, NLLB's biases):
    an expert pointed at it contributes exactly 0, as a masked (-1) one
    does, bit for bit."""
    store = _store(5)
    arena = ExpertArena(store, E, compute_dtype=torch.bfloat16, device=dev, num_threads=2,
                        reserve_zero_slot=True)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(8, D, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.randint(0, E, (8, 2), generator=g, device=dev, dtype=torch.int32)
    cw = torch.rand(8, 2, generator=g, device=dev)
    try:
        keys = [(2, e) for e in range(E)]
        arena.acquire(keys, 2)
        row = arena.slot_map(2)
        zero, masked = row.copy(), row.copy()
        zero[::2] = arena.zero_slot
        masked[::2] = -1
        with arena.locked_tree(keys) as tree:
            outs = [_ffn(x, ids, cw, torch.from_numpy(r).to(dev), tree)
                    for r in (zero, masked, np.full(E, arena.zero_slot, np.int32))]
        arena.release(keys)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1])
        assert not outs[2].any()
    finally:
        arena.shutdown()
