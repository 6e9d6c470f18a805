"""The port's host fallback (``runtime/host_exec.py``, the arena's zero slot,
the engines' deadline) and the arena's ``dequant_on_write`` on the CPU,
against the JAX package, mirroring tests/test_host_fallback.py:

* a fetch that fails raising in the engine, within the deadline or at the
  next call after it, and never sending its expert to the host;
* the five JAX tests on the port (every miss on the host, partial misses,
  the zero slot required, the executor against the device FFN, seq2seq
  through ``MoE``), each also against the JAX engine: tokens always, and
  ``host_exec_count`` where a blocked store makes every miss deterministic
  (its workers never land a record, so every expert not warmed runs on the
  host in both packages);
* ``HostExpertExecutor.ffn`` against the JAX executor for f32, int8 and
  packed int4 stores and every activation (atol 1e-5: both f32, the matmul
  order differs);
* the zero slot still all zero after eviction churn, and the grouped FFN
  through it contributing exactly 0 (the plain versions of every impl);
* ``dequant_on_write`` slots equal to the JAX arena's (bit for bit at f32
  and bf16, store and tier paths); no direct layers and no stream decode
  under it;
* an e4m3 store refused by the port's executor, beside the JAX executor's
  result on it: the raw codes times x, with no scale.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import MixtralConfig, MixtralForCausalLM

from moe_infinity_tpu.models.mixtral import MixtralModel as JMixtralModel
from moe_infinity_tpu.models.mixtral import MixtralSpec as JMixtralSpec
from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
from moe_infinity_tpu.runtime.engine import OffloadEngine as JEngine
from moe_infinity_tpu.runtime.generate import Generator as JGenerator
from moe_infinity_tpu.runtime.host_exec import HostExpertExecutor as JExecutor
from moe_infinity_tpu.store.blob import DenseArchive as JDense
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu.store.ingest import ingest_checkpoint
from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
from moe_infinity_tpu_torch.ops.moe import grouped_ffn
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.engine import OffloadEngine
from moe_infinity_tpu_torch.runtime.generate import Generator
from moe_infinity_tpu_torch.runtime.host_exec import (
    HostExpertExecutor,
    activation_for,
    host_moe_delta,
)
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store.blob import DenseArchive, ExpertStore
from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import write_decoder_store, write_nllb_store

L, E = 2, 4


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg = MixtralConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=L,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=E,
        num_experts_per_tok=2, vocab_size=128, max_position_embeddings=64,
        torch_dtype=torch.float32, architectures=["MixtralForCausalLM"],
    )
    torch.manual_seed(5)
    hf = MixtralForCausalLM(cfg).eval()
    root = tmp_path_factory.mktemp("torch_hostfb")
    ckpt = root / "ckpt"
    hf.save_pretrained(ckpt, safe_serialization=True)
    store_dir = str(root / "store")
    ingest_checkpoint(str(ckpt), store_dir, cfg, expert_dtype="float32", dense_dtype="float32")
    jmodel = JMixtralModel(JMixtralSpec.from_hf(cfg), compute_dtype=jnp.float32)
    jparams = jmodel.load_params(JDense(store_dir))
    model = MixtralModel(MixtralSpec.from_hf(read_hf_config(str(ckpt))),
                         compute_dtype=torch.float32, device="cpu")
    params = model.load_params(DenseArchive(store_dir))
    return hf, model, params, jmodel, jparams, store_dir


def _hf(hf, prompt, n):
    return hf.generate(torch.tensor(prompt), max_new_tokens=n, do_sample=False,
                       eos_token_id=None, pad_token_id=0).numpy()


class _Gate:
    """A store behaviour for the arena's fetch workers: ``delay`` seconds per
    fetch, or (``blocked``) no fetch returns until the gate opens. Reads on
    the main thread (the host executor's) pass at once."""

    def __init__(self, delay=0.0, blocked=False):
        self.delay = delay
        self.open = threading.Event()
        if not blocked:
            self.open.set()

    def wait(self):
        if threading.current_thread() is threading.main_thread():
            return
        self.open.wait(timeout=120.0)
        if self.delay:
            time.sleep(self.delay)


def _store_cls(base):
    class GatedStore(base):
        gate = None

        def get_expert(self, layer, expert, prio=0, gen=0):
            if self.gate is not None:
                self.gate.wait()
            return super().get_expert(layer, expert, prio=prio, gen=gen)

    return GatedStore


PortStore, JaxStore = _store_cls(ExpertStore), _store_cls(JStore)


def _port_arena(store_dir, gate=None, slots=E, zero=True, threads=2):
    store = PortStore(store_dir)
    store.gate = gate
    return ExpertArena(store, slots, compute_dtype=torch.float32, device="cpu",
                       num_threads=threads, reserve_zero_slot=zero)


def _jax_arena(store_dir, gate=None, slots=E, zero=True, threads=2):
    store = JaxStore(store_dir)
    store.gate = gate
    return JArena(store, slots, compute_dtype=jnp.float32, num_threads=threads,
                  reserve_zero_slot=zero)


def _run_both(tiny, prompt, n, timeout, gate_kw, warm=(), slots=E, threads=2):
    """(port tokens, port count, JAX tokens, JAX count) with the host
    fallback at ``timeout``, over stores gated alike."""
    _, model, params, jmodel, jparams, store_dir = tiny
    out = []
    for make, eng_cls, gen_cls, mdl, prm in (
            (_port_arena, OffloadEngine, Generator, model, params),
            (_jax_arena, JEngine, JGenerator, jmodel, jparams)):
        gate = _Gate(**gate_kw)
        arena = make(store_dir, gate if not warm else None, slots=slots, threads=threads)
        try:
            if warm:
                arena.warm(list(warm))
                arena.store.gate = gate
            eng = eng_cls(mdl, prm, arena, prefetch=False, host_fallback=True,
                          host_fallback_timeout=timeout)
            got = gen_cls(stepper=eng, max_seq_len=64).generate(prompt, max_new_tokens=n)
            out += [np.asarray(got.sequences), eng.host_exec_count, eng.stats()]
        finally:
            gate.open.set()
            arena.shutdown()
    return out


def test_all_misses_run_on_host_exactly(tiny):
    hf = tiny[0]
    prompt = np.array([[5, 9, 33, 7]])
    want = _hf(hf, prompt, 6)
    # deadline 0 and a slow store: every cold expert takes the host path
    got, count, _, jgot, _, _ = _run_both(tiny, prompt, 6, 0.0, dict(delay=0.05))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jgot, want)
    assert count > 0
    # a blocked store: nothing ever lands, so every routed expert of every
    # step runs on the host, in both packages alike
    got, count, stats, jgot, jcount, jstats = _run_both(tiny, prompt, 6, 0.0,
                                                        dict(blocked=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jgot, want)
    assert count == jcount > 0
    assert stats["host_exec_count"] == jstats["host_exec_count"] == count


def test_partial_misses_mix_device_and_host(tiny):
    hf = tiny[0]
    prompt = np.array([[3, 14, 15, 9, 2]])
    want = _hf(hf, prompt, 5)
    # a generous deadline: everything lands in time, the device path alone
    got, count, _, jgot, jcount, _ = _run_both(tiny, prompt, 5, 30.0, {})
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jgot, want)
    assert count == jcount == 0
    # a tight deadline against a slowed store, layer 0 warmed: warm hits on
    # the device, the rest on the host
    got, _, _, jgot, _, _ = _run_both(tiny, prompt, 5, 0.01, dict(delay=0.03),
                                      warm=[(0, e) for e in range(E)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jgot, want)
    # layer 0 warmed (2E slots: the one blocked worker takes a free slot, no
    # warm key is evicted), the store blocked: layer 1 on the host, alike
    got, count, _, jgot, jcount, _ = _run_both(
        tiny, prompt, 5, 0.0, dict(blocked=True), warm=[(0, e) for e in range(E)],
        slots=2 * E, threads=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jgot, want)
    assert count == jcount > 0


def test_host_fallback_requires_zero_slot(tiny):
    _, model, params, _, _, store_dir = tiny
    arena = _port_arena(store_dir, zero=False)
    try:
        with pytest.raises(ValueError, match="reserve_zero_slot"):
            OffloadEngine(model, params, arena, host_fallback=True)
    finally:
        arena.shutdown()


class _FailingStore(ExpertStore):
    """Every read on an arena fetch worker raises; the host executor's reads
    (on the main thread) pass."""

    def get_expert(self, layer, expert, prio=0, gen=0):
        if threading.current_thread() is not threading.main_thread():
            raise OSError(f"store read failed for {(layer, expert)}")
        return super().get_expert(layer, expert, prio=prio, gen=gen)


def test_failed_fetch_raises_instead_of_host(tiny):
    """The host fallback is a deadline on residency: a fetch that fails
    within the deadline raises in the engine, and no expert runs on the
    host."""
    _, model, params, _, _, store_dir = tiny
    arena = ExpertArena(_FailingStore(store_dir), E, compute_dtype=torch.float32,
                        device="cpu", num_threads=2, reserve_zero_slot=True)
    try:
        eng = OffloadEngine(model, params, arena, prefetch=False, host_fallback=True,
                            host_fallback_timeout=30.0)
        with pytest.raises(OSError, match="store read failed"):
            Generator(stepper=eng, max_seq_len=64).generate(np.array([[5, 9, 33, 7]]),
                                                            max_new_tokens=2)
        assert eng.host_exec_count == 0
        assert not arena.policy.protected_ondemand
    finally:
        arena.shutdown()


def test_failed_fetch_after_deadline_raises_next_call(tiny):
    """At a deadline of 0 the key is missing at once; its fetch then fails in
    the background, and the next try_acquire of that key raises that error
    instead of sending the key to the host again."""
    store_dir = tiny[-1]
    arena = ExpertArena(_FailingStore(store_dir), E, compute_dtype=torch.float32,
                        device="cpu", num_threads=1, reserve_zero_slot=True)
    try:
        resident, missing = arena.try_acquire([(0, 0), (0, 1)], 0, 0.0)
        assert resident == [] and sorted(missing) == [(0, 0), (0, 1)]
        t0 = time.perf_counter()
        while len(arena._errors) < 2 and time.perf_counter() - t0 < 30.0:
            time.sleep(0.01)
        with pytest.raises(OSError, match="store read failed"):
            arena.try_acquire([(0, 1)], 0, 0.0)
        assert not arena.policy.protected_ondemand
    finally:
        arena.shutdown()


def test_host_executor_matches_device_ffn(tiny):
    """HostExpertExecutor.ffn equals the model's expert FFN over the store's
    resident tree, and the JAX executor's."""
    _, model, _, _, _, store_dir = tiny
    store = ExpertStore(store_dir)
    ex = HostExpertExecutor(store, activation_for(store.meta))
    jex = JExecutor(JStore(store_dir), activation_for(store.meta))
    tree = ResidentProvider.from_store(store, dtype=torch.float32, device="cpu").pytree()
    x = np.random.default_rng(0).normal(size=(5, model.spec.hidden_size)).astype(np.float32)
    for (l, e) in [(0, 0), (1, 3)]:
        got = ex.ffn(l, e, torch.from_numpy(x))
        w = tree["layers"][l]
        s = x @ w["gate"][e].numpy()
        ref = ((s / (1 + np.exp(-s))) * (x @ w["up"][e].numpy())) @ w["down"][e].numpy()
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), jex.ffn(l, e, x), atol=1e-5)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("torch_hostfb_stores")
    D, F = 32, 64

    def layers(n):
        return [{"gate": rng.normal(0, 0.1, (E, D, F)).astype(np.float32),
                 "up": rng.normal(0, 0.1, (E, D, F)).astype(np.float32),
                 "down": rng.normal(0, 0.1, (E, F, D)).astype(np.float32)} for _ in range(n)]

    mix, nllb = layers(2), layers(2)
    out = {q: write_decoder_store(root / q, mix, "mixtral", q)
           for q in ("float32", "int8", "float8_e4m3fn")}
    out.update({"nllb_" + q: write_nllb_store(root / ("nllb_" + q), nllb, q, 1, seed=4)
                for q in ("float32", "int4")})
    return out


@pytest.mark.parametrize("store", ["float32", "int8", "nllb_float32", "nllb_int4"])
@pytest.mark.parametrize("act", ["relu", "silu", "gelu", "gelu_tanh"])
def test_executor_equals_jax(stores, store, act):
    path = stores[store]
    ex, jex = HostExpertExecutor(ExpertStore(path), act), JExecutor(JStore(path), act)
    x = np.random.default_rng(1).normal(size=(6, 32)).astype(np.float32)
    for l, e in [(0, 1), (1, 3)]:
        np.testing.assert_allclose(ex.ffn(l, e, torch.from_numpy(x)).numpy(),
                                   jex.ffn(l, e, x), rtol=1e-5, atol=1e-5)


def test_host_moe_delta_equals_jax(stores):
    from moe_infinity_tpu.runtime.host_exec import host_moe_delta as j_delta

    path = stores["nllb_int4"]
    ex, jex = HostExpertExecutor(ExpertStore(path), "relu"), JExecutor(JStore(path), "relu")
    rng = np.random.default_rng(2)
    h = rng.normal(size=(2, 3, 32)).astype(np.float32)
    cw = rng.uniform(size=(2, 3, 2)).astype(np.float32)
    ids = rng.integers(0, E, size=(2, 3, 2)).astype(np.int32)
    missing = [(1, 0), (1, 2), (1, 3)]
    got = host_moe_delta(ex, 1, missing, torch.from_numpy(h), torch.from_numpy(cw), ids)
    np.testing.assert_allclose(got.numpy(), j_delta(jex, 1, missing, h, cw, ids), atol=1e-5)


def test_e4m3_store_refused_beside_jax_unscaled(stores):
    """The JAX executor reads an fp8 record's codes without their scale:
    its FFN is x @ codes, not x @ (codes * scale), the device's function.
    The port refuses such a store rather than copy that result."""
    path = stores["float8_e4m3fn"]
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        HostExpertExecutor(ExpertStore(path), "silu")
    jex = JExecutor(JStore(path), "silu")
    rec = JStore(path).get_expert(0, 1)
    x = np.random.default_rng(3).normal(size=(3, 32)).astype(np.float32)

    def ffn(scaled):
        def w(t):
            v = np.asarray(rec[t]).astype(np.float32)
            return v * np.asarray(rec[t + ".scale"])[None, :] if scaled else v

        g = x @ w("w1.weight")
        return (g / (1 + np.exp(-g)) * (x @ w("w3.weight"))) @ w("w2.weight")

    got = jex.ffn(0, 1, x)
    np.testing.assert_allclose(got, ffn(False), rtol=1e-4, atol=1e-3)
    assert not np.allclose(got, ffn(True), rtol=1e-2, atol=1e-2)


def test_zero_slot_stays_zero_under_churn(stores):
    path = stores["nllb_int4"]
    arena = ExpertArena(ExpertStore(path), 3, compute_dtype=torch.float32, device="cpu",
                        num_threads=1, reserve_zero_slot=True)
    try:
        assert arena.zero_slot == 3
        assert len(arena.slot_to_key) == 3 and len(arena._free_slots) == 3
        for t in arena.pytree().values():
            assert t.shape[0] == 4
        for step in range(12):
            keys = [(step % 2, (step + j) % E) for j in range(2)]
            arena.acquire(keys, step % 2)
            arena.release(keys)
        assert arena.hit_stats()["evictions"] > 0
        assert arena.zero_slot not in arena.key_to_slot.values()
        for k, t in arena.pytree().items():
            assert not t[arena.zero_slot].any(), k
        # the grouped FFN over the zero slot: exactly 0, every plain impl
        x = torch.randn(4, 32)
        ids = torch.tensor([[0, 1]] * 4, dtype=torch.int32)
        row = torch.full((E,), arena.zero_slot, dtype=torch.int32)
        weights = {k: v for k, v in arena.pytree().items() if not k.endswith("_bias")}
        biases = {k: v for k, v in arena.pytree().items() if k.endswith("_bias")}
        for impl in ("ragged", "gather", "dense", "pallas"):
            y = grouped_ffn(x, ids, torch.full((4, 2), 0.5), row, weights, "relu",
                            biases=biases, impl=impl)
            assert torch.equal(y, torch.zeros_like(y)), impl
    finally:
        arena.shutdown()


@pytest.mark.parametrize("store", ["int8", "nllb_int4"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tier", [False, True])
def test_dequant_on_write_slots_equal_jax(stores, store, dtype, tier):
    from moe_infinity_tpu.store.pinned import PinnedExpertTier as JTier
    from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

    path = stores[store]
    pstore, jstore = ExpertStore(path), JStore(path)
    arena = ExpertArena(pstore, 8, compute_dtype=getattr(torch, dtype), device="cpu",
                        num_threads=1, dequant_on_write=True,
                        pinned_tier=PinnedExpertTier(pstore, device="cpu") if tier else None)
    jarena = JArena(jstore, 8, compute_dtype=getattr(jnp, dtype), num_threads=1,
                    dequant_on_write=True, pinned_tier=JTier(jstore) if tier else None)
    keys = [(l, e) for l in range(2) for e in range(E)]
    try:
        arena.warm(keys)
        jarena.warm(keys)
        got, want = arena.pytree(), jarena._arena
        assert sorted(got) == sorted(want)
        assert not any(k.endswith("_scale") or k.endswith("4") for k in got)
        for k in want:
            want_dt = torch.float32 if k.endswith("_bias") else getattr(torch, dtype)
            assert got[k].dtype == want_dt, k
            for key in keys:
                a = got[k][arena.key_to_slot[key]].float().numpy()
                b = np.asarray(want[k][jarena.key_to_slot[key]]).astype(np.float32)
                np.testing.assert_array_equal(a, b, err_msg=f"{k} {key}")
    finally:
        arena.shutdown()
        jarena.shutdown()


def test_dequant_on_write_keeps_the_slot_path(stores):
    """Under dequant_on_write the seq2seq engine promotes no layer to run
    direct from the tier and refuses stream decode."""
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine
    from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

    spec = NllbSpec(vocab_size=96, d_model=32, num_heads=4, encoder_layers=2,
                    decoder_layers=2, encoder_ffn_dim=64, decoder_ffn_dim=64,
                    encoder_sparse_step=2, decoder_sparse_step=2, num_experts=E,
                    pad_token_id=1, decoder_start_token_id=2, max_positions=64,
                    scale_embedding=True)
    model = NllbModel(spec, compute_dtype=torch.float32, device="cpu")
    params, _ = model.init_random(torch.Generator().manual_seed(0), with_experts=False)
    store = ExpertStore(stores["nllb_int4"])
    tier = PinnedExpertTier(store, device="cpu", align_rows=E)
    for dq in (False, True):
        arena = ExpertArena(store, 2 * E, compute_dtype=torch.float32, device="cpu",
                            dequant_on_write=dq, pinned_tier=tier)
        try:
            eng = Seq2SeqOffloadEngine(model, params, arena)
            assert bool(eng._direct_mlis) != dq
            if dq:
                with pytest.raises(ValueError, match="dequant_on_write"):
                    Seq2SeqOffloadEngine(model, params, arena, speculative=True,
                                         stream_decode=True)
        finally:
            arena.shutdown()


def test_seq2seq_host_fallback_exact(tmp_path):
    """NLLB (biased experts): every miss on the host through ``MoE``
    matches the HF model and the JAX facade."""
    from transformers import NllbMoeConfig, NllbMoeForConditionalGeneration

    from moe_infinity_tpu.entrypoints.api import MoE as JMoE
    from moe_infinity_tpu_torch.entrypoints.api import MoE

    cfg = NllbMoeConfig(
        vocab_size=64, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_ffn_dim=48, decoder_ffn_dim=48, encoder_attention_heads=4,
        decoder_attention_heads=4, encoder_sparse_step=2,
        decoder_sparse_step=2, num_experts=4, max_position_embeddings=64,
        torch_dtype=torch.float32, pad_token_id=1, bos_token_id=0,
        eos_token_id=2, decoder_start_token_id=2,
        architectures=["NllbMoeForConditionalGeneration"],
        router_bias=False, moe_token_dropout=0.0,
    )
    torch.manual_seed(7)
    hf = NllbMoeForConditionalGeneration(cfg).eval()
    ckpt = tmp_path / "ckpt"
    hf.save_pretrained(ckpt, safe_serialization=True)
    prompt = np.array([[5, 9, 33, 7, 2]])
    want = hf.generate(torch.tensor(prompt), max_new_tokens=5, do_sample=False,
                       eos_token_id=None).numpy()
    conf = {"expert_dtype": "float32", "max_seq_len": 64, "device_memory_bytes": 1,
            "num_slots": 4, "host_fallback": True, "host_fallback_timeout_s": 0.0,
            "prefetch": False, "speculative_decode": False}
    eng = MoE(str(ckpt), dict(conf, offload_path=str(tmp_path / "port")), device="cpu")
    jeng = JMoE(str(ckpt), dict(conf, offload_path=str(tmp_path / "jax")))
    try:
        assert eng.engine.arena.zero_slot == 4
        got = eng.generate(prompt, max_new_tokens=5, eos_token_id=None)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jeng.generate(prompt, max_new_tokens=5,
                                                         eos_token_id=None))
        assert eng.stats().get("host_exec_count", 0) > 0
    finally:
        eng.shutdown()
        jeng.shutdown()


def test_seq2seq_blocked_store_counts_equal_jax(tmp_path):
    """The seq2seq engine with every expert on the host (a blocked store):
    tokens equal to the resident path's and to the JAX engine's, and the
    same host_exec_count."""
    import jax

    from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
    from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
    from moe_infinity_tpu.runtime.engine_seq2seq import Seq2SeqOffloadEngine as JS2S
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine
    from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
    from torch_port_helpers import port_attention, to_port

    spec = dict(vocab_size=96, d_model=32, num_heads=4, encoder_layers=4, decoder_layers=4,
                encoder_ffn_dim=64, decoder_ffn_dim=64, encoder_sparse_step=2,
                decoder_sparse_step=2, num_experts=E, pad_token_id=1,
                decoder_start_token_id=2, max_positions=64, scale_embedding=True)
    jmodel = JNllbModel(JNllbSpec(**spec), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(5))
    path = write_nllb_store(tmp_path / "s", jtree["layers"], "int4", 2, seed=3)
    model = NllbModel(NllbSpec(**spec), compute_dtype=torch.float32, device="cpu")
    params = to_port(jparams)
    ids = np.array([[5, 31, 8, 77, 40, 2], [9, 3, 44, 2, 1, 1]])
    gen = dict(max_new_tokens=6, attention_mask=(ids != 1).astype(np.float32),
               eos_token_id=None)
    provider = ResidentProvider.from_store(ExpertStore(path), dtype=torch.float32, device="cpu")
    res = Seq2SeqGenerator(model, params, provider.pytree(), ResidentProvider.for_layer)
    with port_attention("naive"):
        base = res.generate(ids, **gen)
    out = []
    for make, cls, mdl, prm in ((_port_arena, Seq2SeqOffloadEngine, model, params),
                                (_jax_arena, JS2S, jmodel, jparams)):
        gate = _Gate(blocked=True)
        arena = make(path, gate, threads=1)
        try:
            eng = cls(mdl, prm, arena, prefetch=False, host_fallback=True,
                      host_fallback_timeout=0.0)
            with port_attention("naive"):
                out += [eng.generate(ids, **gen).sequences, eng.host_exec_count]
        finally:
            gate.open.set()
            arena.shutdown()
    np.testing.assert_array_equal(out[0], base.sequences)
    np.testing.assert_array_equal(out[0], out[2])
    assert out[1] == out[3] > 0
