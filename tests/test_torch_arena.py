"""The port's slot arena and pinned tier (``runtime/arena.py``,
``store/pinned.py``) on the CPU (``device="cpu"``): the tests of
``tests/test_arena_engine.py``'s TestArena, ``tests/test_pinned_tier.py``
and the invariants of ``tests/test_arena_stress.py``, plus residency
counters equal to the JAX arena's on the same acquire sequence. Stores are
written from the JAX NllbModel.init_random weights with the JAX
ExpertStoreWriter. (The stress file's lease tests are not mirrored: the port
has no donated writes for a lease to defer; its stream fences run on the
card, ``tests/test_torch_cuda_offload.py``.)"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu.store.pinned import PinnedExpertTier as JTier
from moe_infinity_tpu_torch.memory.cache_policy import ExpertCachePolicy
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.store.blob import ExpertStore, SyntheticStore
from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

from torch_port_helpers import write_nllb_store, one_intra_op_thread

SPEC = dict(
    vocab_size=96, d_model=32, num_heads=4, encoder_layers=4, decoder_layers=4,
    encoder_ffn_dim=64, decoder_ffn_dim=64, encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=8, pad_token_id=1, decoder_start_token_id=2, max_positions=64,
    scale_embedding=True,
)
L, E = 4, 8
ROLE_TAILS = {"gate": "fc1.weight", "gate4": "fc1.weight", "gate_scale": "fc1.weight.scale",
              "gate_bias": "fc1.bias", "down": "fc2.weight", "down4": "fc2.weight",
              "down_scale": "fc2.weight.scale", "down_bias": "fc2.bias"}
SYN_FIELDS = [("fc1.weight", (16, 32), "float32"), ("fc2.weight", (32, 16), "float32")]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    jmodel = JNllbModel(JNllbSpec(**SPEC), compute_dtype=jnp.float32)
    _, jtree = jmodel.init_random(jax.random.PRNGKey(9))
    root = tmp_path_factory.mktemp("torch_arena")
    return {q: write_nllb_store(root / q, jtree["layers"], q, 2, seed=2)
            for q in ("float32", "int4")}


def make_arena(path, num_slots, **kw):
    kw.setdefault("compute_dtype", torch.float32)
    kw.setdefault("num_threads", 2)
    return ExpertArena(ExpertStore(path), num_slots, device="cpu", **kw)


def _assert_slot_is_record(arena, store, key):
    slot = arena.key_to_slot[key]
    rec = store.get_expert(*key)
    for akey, t in arena.pytree().items():
        np.testing.assert_array_equal(t[slot].numpy(), rec[ROLE_TAILS[akey]], err_msg=f"{key}/{akey}")


def test_acquire_loads_and_counts_miss_then_hit(stores):
    arena = make_arena(stores["float32"], 4)
    try:
        arena.acquire([(0, 1), (0, 2)], layer=0)
        assert arena.is_resident((0, 1)) and arena.is_resident((0, 2))
        arena.release([(0, 1), (0, 2)])
        arena.acquire([(0, 1)], layer=0)
        arena.release([(0, 1)])
        s = arena.hit_stats()
        assert s["visits"] == 3 and s["misses"] == 2 and s["hits"] == 1
        assert arena.fetch_stats()["fetches_store"] == 2
    finally:
        arena.shutdown()


@pytest.mark.parametrize("quant", ["float32", "int4"])
def test_slot_contents_byte_equal_store(stores, quant):
    arena = make_arena(stores[quant], 3, policy="lru")
    store = ExpertStore(stores[quant])
    try:
        expect = {"float32": {"gate", "down", "gate_bias", "down_bias"},
                  "int4": {"gate4", "gate_scale", "down4", "down_scale", "gate_bias",
                           "down_bias"}}[quant]
        assert set(arena.pytree()) == expect
        if quant == "int4":
            assert arena.pytree()["gate4"].dtype == torch.int8
        for key in [(1, 3), (3, 7), (0, 0), (2, 5), (1, 3)]:  # evicts on the way
            arena.acquire([key], key[0])
            _assert_slot_is_record(arena, store, key)
            row = arena.slot_map(key[0])
            assert row[key[1]] == arena.key_to_slot[key]
            arena.release([key])
    finally:
        arena.shutdown()


def test_eviction_when_full(stores):
    arena = make_arena(stores["float32"], 2, policy="lru")
    try:
        for key in [(0, 0), (0, 1), (0, 2)]:  # the third evicts (0, 0), the oldest
            arena.acquire([key], 0)
            arena.release([key])
        assert not arena.is_resident((0, 0))
        assert arena.is_resident((0, 1)) and arena.is_resident((0, 2))
        assert arena.hit_stats()["evictions"] == 1
        assert arena.slot_map(0)[0] == -1  # masked to a zero contribution
    finally:
        arena.shutdown()


def test_exhaustion_raises_in_caller(stores):
    arena = make_arena(stores["float32"], 1)
    try:
        with pytest.raises(RuntimeError, match="exhausted"):
            arena.acquire([(0, 0), (0, 1)], 0)  # 2 protected, 1 slot
    finally:
        arena.shutdown()


def test_failed_fetch_surfaces_in_acquire():
    class Broken(SyntheticStore):
        def get_expert(self, layer, expert, **kw):
            if expert == 1:
                raise OSError("read failed")
            return super().get_expert(layer, expert, **kw)

    arena = ExpertArena(Broken(2, 2, SYN_FIELDS, meta={"arch": "nllb"}), 2,
                        compute_dtype=torch.float32, device="cpu", num_threads=1)
    try:
        with pytest.raises(OSError, match="read failed"):
            arena.acquire([(0, 1)], 0)
        arena.release([(0, 1)])
        arena.acquire([(0, 0), (1, 0)], 0)  # the slot went back to the free list
        arena.release([(0, 0), (1, 0)])
    finally:
        arena.shutdown()


def test_swap_policy_preserves_state_and_reconciles(stores):
    arena = make_arena(stores["float32"], 2, policy="lru")
    try:
        pol_a = arena.policy
        pol_b = ExpertCachePolicy(arena.num_layers, arena.num_experts, policy="priority")
        arena.acquire([(0, 0), (0, 1)], 0)
        arena.release([(0, 0), (0, 1)])
        freq_a = pol_a.frequency.copy()
        assert arena.swap_policy(pol_b) is pol_a
        assert set(pol_b.resident) == {(0, 0), (0, 1)} and pol_b.stats.evictions == 0
        arena.acquire([(0, 2)], 0)
        arena.release([(0, 2)])
        assert pol_b.stats.visits == 1
        evicted = {(0, 0), (0, 1)} - set(arena.key_to_slot)
        assert len(evicted) == 1 and pol_b.stats.evictions == 1
        arena.swap_policy(pol_a)
        np.testing.assert_array_equal(pol_a.frequency, freq_a)
        assert set(pol_a.resident) == set(arena.key_to_slot)
        assert pol_a.stats.evictions == 0
        arena.reset_policy("lfu")
        assert arena.policy.policy == "lfu" and set(arena.policy.resident) == set(arena.key_to_slot)
    finally:
        arena.shutdown()


def test_prefetch_then_acquire_is_hit(stores):
    arena = make_arena(stores["float32"], 4)
    try:
        arena.warm([(2, 5)])
        arena.acquire([(2, 5)], 2)
        arena.release([(2, 5)])
        s = arena.hit_stats()
        assert s["hits"] == 1 and s["prefetches"] == 1 and s["prefetch_hits"] == 1
        assert arena.node_stats()["hit_rate_matrix"][2, 5] == 1.0
    finally:
        arena.shutdown()


def test_try_acquire_reports_missing_on_deadline():
    import time

    class Slow(SyntheticStore):
        def get_expert(self, layer, expert, **kw):
            time.sleep(0.3)
            return super().get_expert(layer, expert, **kw)

    arena = ExpertArena(Slow(2, 2, SYN_FIELDS, meta={"arch": "nllb"}), 2,
                        compute_dtype=torch.float32, device="cpu", num_threads=1)
    try:
        resident, missing = arena.try_acquire([(0, 0)], 0, timeout=0.01)
        assert resident == [] and missing == [(0, 0)]
        arena.warm([(1, 1)])
        resident, missing = arena.try_acquire([(1, 1)], 1, timeout=5.0)
        assert resident == [(1, 1)] and missing == []
        arena.release(resident)
    finally:
        arena.shutdown()


@pytest.mark.parametrize("policy", ["priority", "lru"])
@pytest.mark.parametrize("quant,slots", [("float32", 8), ("int4", 8), ("int4", 12)])
def test_counters_equal_jax_arena(stores, quant, slots, policy):
    """One worker, no prefetch: the same acquire sequence gives the JAX
    arena's hit, miss and eviction counters, slot table and per-node
    planes at every step."""
    path = stores[quant]
    arena = make_arena(path, slots, policy=policy, num_threads=1)
    jarena = JArena(JStore(path), slots, policy=policy, compute_dtype=jnp.float32,
                    num_threads=1)
    rng = np.random.default_rng(slots)
    try:
        for step in range(40):
            layer = step % L
            keys = sorted({(layer, int(e)) for e in rng.integers(0, E, 4)})
            if step % 5 == 0:
                dm = rng.random((L, E)).astype(np.float32)
                arena.set_context(layer, dm)
                jarena.set_context(layer, dm)
            for a in (arena, jarena):
                a.acquire(keys, layer)
                a.release(keys)
            assert arena.hit_stats() == jarena.hit_stats(), step
            assert arena.key_to_slot == jarena.key_to_slot, step
            np.testing.assert_array_equal(arena.expert_to_slot, jarena.expert_to_slot)
        got, want = arena.node_stats(), jarena.node_stats()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert arena.hit_stats()["evictions"] > 0
    finally:
        arena.shutdown()
        jarena.shutdown()


def test_unported_options_raise(stores, tmp_path):
    path = stores["int4"]
    with pytest.raises(NotImplementedError, match="item 18b"):
        make_arena(path, 4, tp_mirrors=[("dev", None)])
    # served since the host fallback (tests/test_torch_host_fallback.py):
    # the zero slot, one more all-zero row, and dequantized compute-dtype slots
    for kw in (dict(dequant_on_write=True), dict(reserve_zero_slot=True)):
        arena = make_arena(path, 4, **kw)
        try:
            if "reserve_zero_slot" in kw:
                assert arena.zero_slot == 4 and arena.pytree()["gate4"].shape[0] == 5
            else:
                assert arena.zero_slot is None and arena.pytree()["gate"].dtype != torch.int8
                assert not any(k.endswith("_scale") for k in arena.pytree())
        finally:
            arena.shutdown()
    # fp8 records are served since K3 takes e4m3: their slots keep the codes
    fields = [("fc1.weight", (16, 16), "float8_e4m3fn"), ("fc2.weight", (16, 16), "float8_e4m3fn")]
    fp8 = ExpertArena(SyntheticStore(1, 2, fields, meta={"arch": "nllb"}), 2, device="cpu")
    try:
        assert fp8.pytree()["gate"].dtype == torch.float8_e4m3fn
    finally:
        fp8.shutdown()
    # layer_stack is served: a tier that is not layer-aligned has no layer
    # stack, as the JAX tier's returns None
    assert PinnedExpertTier(ExpertStore(path), device="cpu").layer_stack(0) is None
    assert JTier(JStore(path), shared_record=False).layer_stack(0, promote=False) is None


# ---------------------------------------------------------------------------
# the pinned tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["float32", "int4"])
def test_tier_slots_equal_store_path(stores, quant):
    store = ExpertStore(stores[quant])
    tier = PinnedExpertTier(store, device="cpu")
    assert not tier.shared and tier.num_staged == L * E
    host = make_arena(stores[quant], E, num_threads=1)
    via_tier = make_arena(stores[quant], E, num_threads=1, pinned_tier=tier)
    try:
        keys = [(layer, e) for layer in range(L) for e in (0, 3)]
        for a in (host, via_tier):
            a.warm(keys)
        for key in keys:
            hs, ts = host.key_to_slot[key], via_tier.key_to_slot[key]
            for akey in host.pytree():
                assert torch.equal(host.pytree()[akey][hs], via_tier.pytree()[akey][ts])
            _assert_slot_is_record(via_tier, store, key)
        assert via_tier.fetch_stats()["fetches_tier"] == len(keys)
        assert via_tier.fetch_stats()["fetches_store"] == 0
    finally:
        host.shutdown()
        via_tier.shutdown()


def test_tier_matches_jax_tier_rows(stores):
    """Same staging order and budget: the same records staged, at the same
    rows, with the same bytes as the JAX tier."""
    store, jstore = ExpertStore(stores["int4"]), JStore(stores["int4"])
    rec_bytes = sum(f.nbytes for f in store.fields)
    tier = PinnedExpertTier(store, device="cpu", max_bytes=11 * rec_bytes, seg_bytes=2048)
    jtier = JTier(jstore, max_bytes=11 * rec_bytes, seg_bytes=2048)
    assert tier.num_staged == jtier.num_staged == 11
    assert tier.stats() == jtier.stats()
    for layer in range(L):
        for e in range(E):
            row = tier.record_index(layer, e)
            assert row == jtier.record_index(layer, e)
            if row is None:
                continue
            seg, local = tier.segment_for(row)
            jseg, jlocal = jtier.segment_for(row)
            assert local == jlocal
            for name in seg:
                np.testing.assert_array_equal(seg[name][local].numpy(),
                                              np.asarray(jseg[name])[jlocal])


def test_tier_byte_budget_partial_staging(stores):
    store = ExpertStore(stores["float32"])
    rec_bytes = sum(f.nbytes for f in store.fields)
    tier = PinnedExpertTier(store, device="cpu", max_bytes=3 * rec_bytes + 1)
    assert tier.num_staged == 3 and tier.stats()["pinned_tier_staged_records"] == 3
    staged = [(l, e) for l in range(L) for e in range(E) if tier.record_index(l, e) is not None]
    unstaged = [(l, e) for l in range(L) for e in range(E) if tier.record_index(l, e) is None]
    assert len(staged) == 3 and len(unstaged) == L * E - 3
    host = make_arena(stores["float32"], L * E, num_threads=1)
    via_tier = make_arena(stores["float32"], L * E, num_threads=1, pinned_tier=tier)
    try:
        keys = staged[:2] + unstaged[:2]
        for a in (host, via_tier):
            a.warm(keys)
        for key in keys:
            hs, ts = host.key_to_slot[key], via_tier.key_to_slot[key]
            for akey in host.pytree():
                assert torch.equal(host.pytree()[akey][hs], via_tier.pytree()[akey][ts])
        assert via_tier.fetch_stats()["fetches_tier"] == 2
        assert via_tier.fetch_stats()["fetches_store"] == 2
    finally:
        host.shutdown()
        via_tier.shutdown()


def test_tier_decoder_first_staging_order():
    store = SyntheticStore(4, 2, SYN_FIELDS, meta={"arch": "nllb", "num_encoder_moe_layers": 2})
    rec_bytes = (16 * 32 + 32 * 16) * 4
    tier = PinnedExpertTier(store, device="cpu", shared_record=False, max_bytes=4 * rec_bytes)
    assert tier.num_staged == 4
    for layer in (2, 3):
        for e in range(2):
            assert tier.record_index(layer, e) is not None
    for layer in (0, 1):
        for e in range(2):
            assert tier.record_index(layer, e) is None


def test_tier_zero_budget_degrades_to_store_path():
    store = SyntheticStore(2, 2, SYN_FIELDS, meta={"arch": "nllb"})
    tier = PinnedExpertTier(store, device="cpu", shared_record=False, max_bytes=1)
    assert tier.num_staged == 0
    arena = ExpertArena(store, 4, compute_dtype=torch.float32, device="cpu", num_threads=1,
                        pinned_tier=tier)
    try:
        arena.warm([(0, 1)])
        s = arena.key_to_slot[(0, 1)]
        np.testing.assert_array_equal(arena.pytree()["gate"][s].numpy(),
                                      store.get_expert(0, 1)["fc1.weight"])
        assert arena.fetch_stats()["fetches_store"] == 1
    finally:
        arena.shutdown()


def test_tier_synthetic_shared_record_and_synth():
    store = SyntheticStore(3, 4, SYN_FIELDS, meta={"arch": "nllb"})
    tier = PinnedExpertTier(store, device="cpu")
    assert tier.shared and tier.record_index(2, 3) == 0
    arena = ExpertArena(store, 4, compute_dtype=torch.float32, device="cpu", num_threads=1,
                        pinned_tier=tier)
    try:
        arena.warm([(0, 1), (2, 2)])
        s = arena.key_to_slot[(0, 1)]
        np.testing.assert_array_equal(arena.pytree()["gate"][s].numpy(),
                                      store.get_expert(0, 1)["fc1.weight"])
    finally:
        arena.shutdown()
    # synth_on_device: made from an explicit generator, so repeatable; floats
    # in [1.6e-2, 3.2e-2]
    kw = dict(device="cpu", shared_record=False, synth_on_device=True, seg_bytes=4096)
    a, b = PinnedExpertTier(store, **kw), PinnedExpertTier(store, **kw)
    assert a.num_staged == 12 and len(a.fields["fc1.weight"]) == 6
    for name in a.fields:
        for sa, sb in zip(a.fields[name], b.fields[name]):
            assert torch.equal(sa, sb)
            assert float(sa.min()) >= 1.6e-2 and float(sa.max()) <= 3.2e-2


def test_direct_segment():
    store = SyntheticStore(3, 4, SYN_FIELDS, meta={"arch": "nllb", "num_encoder_moe_layers": 1})
    tier = PinnedExpertTier(store, device="cpu", shared_record=False, align_rows=4,
                            synth_on_device=False)
    assert [tier.direct_segment(layer) for layer in range(3)] == [2, 0, 1]
    assert PinnedExpertTier(store, device="cpu", shared_record=False,
                            synth_on_device=False).direct_segment(1) is None


@pytest.mark.parametrize("quant", ["float32", "int4"])
@pytest.mark.parametrize("records", [None, 10])
def test_layer_stack_equals_jax(stores, quant, records):
    """A layer-aligned tier (``align_rows`` = E): the layers staged whole
    give the same [E, ...] stacks as the JAX tier's ``layer_stack`` on the
    same store, byte for byte, decoder layers first; under a byte budget
    the layers not staged whole give None in both. ``promote`` on a CPU
    tier changes nothing."""
    path = stores[quant]
    store = ExpertStore(path)
    E = store.num_experts
    kw = dict(max_bytes=None if records is None else records * store.stride)
    tier = PinnedExpertTier(store, device="cpu", shared_record=False, align_rows=E, **kw)
    jtier = JTier(JStore(path), shared_record=False, align_rows=E, **kw)
    whole = 0
    for layer in range(store.num_layers):
        got, want = tier.layer_stack(layer), jtier.layer_stack(layer, promote=False)
        assert (got is None) == (want is None), layer
        if got is None:
            continue
        whole += 1
        assert set(got) == set(want)
        for name, a in got.items():
            np.testing.assert_array_equal(a.view(torch.uint8).numpy(),
                                          np.asarray(want[name]).view(np.uint8), err_msg=name)
        assert tier.layer_stack(layer, promote=False)[name] is a
    assert whole == (store.num_layers if records is None else records // E)


# ---------------------------------------------------------------------------
# concurrency (the invariants of tests/test_arena_stress.py)
# ---------------------------------------------------------------------------

def _check_tables(arena):
    with arena._lock:
        for key, slot in arena.key_to_slot.items():
            assert arena.slot_to_key[slot] == key
            assert arena.expert_to_slot[key] == slot
        assert int((arena.expert_to_slot >= 0).sum()) == len(arena.key_to_slot)


def test_concurrent_acquire_release_liveness(stores):
    """8 clients (more than the cores) with a short switch interval against a
    6-slot arena of 3 workers: every acquire completes, acquired keys are
    resident with their record's bytes, the slot tables stay a bijection."""
    store = ExpertStore(stores["int4"])
    arena = make_arena(stores["int4"], 6, num_threads=3)
    errors = []
    rng = np.random.default_rng(0)
    plans = [[sorted({(int(rng.integers(L)), int(rng.integers(E))) for _ in range(3)})
              for _ in range(10)] for _ in range(8)]

    def client(tid):
        try:
            for keys in plans[tid]:
                with arena.client_lock:
                    arena.acquire(keys, keys[0][0])
                    for k in keys:
                        _assert_slot_is_record(arena, store, k)
                    arena.release(keys)
                _check_tables(arena)
        except Exception as e:  # noqa: BLE001
            errors.append((tid, e))

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "client thread deadlocked"
    finally:
        sys.setswitchinterval(prev)
        arena.shutdown()
    assert not errors, errors
    assert arena.hit_stats()["visits"] == sum(len(k) for p in plans for k in p)


def test_prefetch_storm_with_acquires(stores):
    """Prefetch plans replaced continuously while another thread acquires:
    purging stale orders never drops an acquired key."""
    arena = make_arena(stores["float32"], 6, num_threads=3)
    stop = threading.Event()
    errors = []

    def prefetcher():
        rng = np.random.default_rng(1)
        while not stop.is_set():
            arena.prefetch([(int(rng.integers(L)), int(rng.integers(E))) for _ in range(4)])

    def acquirer():
        rng = np.random.default_rng(2)
        try:
            for _ in range(40):
                keys = sorted({(int(rng.integers(L)), int(rng.integers(E))) for _ in range(2)})
                arena.acquire(keys, keys[0][0])
                assert all(arena.is_resident(k) for k in keys)
                arena.release(keys)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    pt, at = threading.Thread(target=prefetcher), threading.Thread(target=acquirer)
    pt.start()
    at.start()
    at.join(timeout=60)
    stop.set()
    pt.join(timeout=10)
    arena.shutdown()
    assert not at.is_alive() and not pt.is_alive(), "deadlock"
    assert not errors, errors
    _check_tables(arena)
