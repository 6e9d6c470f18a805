"""The port's decode step with the step as a device scalar, and its graphs
(``runtime/graphs.py``), on the CPU against the JAX package.

On the card the NLLB decode step and the speculative block run as CUDA
graphs; here a stand-in backend takes the place of the capture: it runs the
closure once when it "captures" it, then replays it with no arguments,
copying each run's outputs into the first run's, as a graph overwrites its
static outputs. A Python int baked into the closure at capture (the cache
offset, a position, the embedding's step) would show at the first replay
at another step, so every replay here runs at a new step with new tokens
and slot rows. f32 throughout, TF32 off. Tolerances: 1e-4 (rtol = atol)
against the JAX package, the suite's f32 tolerance for a whole decoder step
(summation order differs between the packages); 1e-6 where the same plain
arithmetic runs over more, masked, columns; bit for bit where the same ops
run on the same values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.memory import ExpertPredictor as JPredictor
from moe_infinity_tpu.memory import ExpertTracer as JTracer
from moe_infinity_tpu.models import layers as jlayers
from moe_infinity_tpu.models.mixtral import MixtralModel as JMixtralModel
from moe_infinity_tpu.models.mixtral import MixtralSpec as JMixtralSpec
from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
from moe_infinity_tpu.runtime.engine import OffloadEngine as JOffloadEngine
from moe_infinity_tpu.runtime.engine_seq2seq import Seq2SeqOffloadEngine as JEngine
from moe_infinity_tpu.runtime.generate import Generator as JGenerator
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
from moe_infinity_tpu_torch.models.layers import KVCache
from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
from moe_infinity_tpu_torch.ops import flash_attention as fa
from moe_infinity_tpu_torch.ops import launch_counts, reset_launches
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.engine import OffloadEngine
from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine
from moe_infinity_tpu_torch.runtime.generate import Generator, Seq2SeqGenerator
from moe_infinity_tpu_torch.runtime.graphs import GraphCache
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store.blob import ExpertStore
from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

from torch_port_helpers import (
    TINY_NLLB,
    StandIn,
    port_attention,
    to_port,
    write_decoder_store,
    write_nllb_store,
    one_intra_op_thread,
)

TOL = 1e-4
SPEC = dict(
    vocab_size=96, d_model=32, num_heads=4, encoder_layers=4, decoder_layers=4,
    encoder_ffn_dim=64, decoder_ffn_dim=64, encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=4, pad_token_id=1, decoder_start_token_id=2, max_positions=64,
    scale_embedding=True,
)
E, N_MOE, N_ENC, S_SLOTS = 4, 4, 2, 8
IDS = np.array([[5, 31, 8, 77, 40, 2], [9, 3, 44, 2, 1, 1], [60, 7, 2, 1, 1, 1]])
MASK = (IDS != 1).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


# ---- the step as a device scalar -------------------------------------------


@pytest.mark.parametrize("T,offset", [(1, 0), (1, 5), (3, 4), (2, 14)])
def test_kv_update_tensor_offset_equals_int_and_jax(T, offset):
    rng = np.random.default_rng(T * 100 + offset)
    k0 = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v0 = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    kn = rng.standard_normal((2, T, 2, 8)).astype(np.float32)
    vn = rng.standard_normal((2, T, 2, 8)).astype(np.float32)
    by_int = KVCache(torch.tensor(k0), torch.tensor(v0)).update(
        torch.tensor(kn), torch.tensor(vn), offset)
    by_tensor = KVCache(torch.tensor(k0), torch.tensor(v0)).update(
        torch.tensor(kn), torch.tensor(vn), torch.tensor(offset, dtype=torch.int32))
    want = jlayers.KVCache(jnp.asarray(k0), jnp.asarray(v0)).update(
        jnp.asarray(kn), jnp.asarray(vn), jnp.int32(offset))
    assert torch.equal(by_tensor.k, by_int.k) and torch.equal(by_tensor.v, by_int.v)
    np.testing.assert_array_equal(by_tensor.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(by_tensor.v.numpy(), np.asarray(want.v))


@pytest.fixture(scope="module")
def tiny():
    jmodel = JNllbModel(JNllbSpec(**TINY_NLLB), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(11), expert_dtype=jnp.float32)
    model = NllbModel(NllbSpec(**TINY_NLLB), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, jtree, model, to_port(jparams), to_port(jtree)


@pytest.mark.parametrize("attention", ["flash", "naive"])
def test_decode_step_tensor_step_equals_int_and_jax(tiny, attention):
    """8 decode steps, each twice in the port (the step as an int, and as a
    0-d int32 tensor with positions from it) and once in JAX, fed JAX's
    argmax: the two port runs agree bit for bit (logits, trace and cache),
    and both agree with JAX within 1e-4. "flash" runs the kernels' plain
    versions (K1 over the cache's capacity), "naive" the einsum oracle."""
    jmodel, jparams, jtree, model, params, tree = tiny
    for_layer, jfor = ResidentProvider.for_layer, JProvider.for_layer
    ids, mask = IDS[:2], MASK[:2]
    m = jnp.asarray(mask)
    jcross = jmodel.cross_kv(jparams, jmodel.encode(jparams, jtree, jnp.asarray(ids, jnp.int32),
                                                    m, jfor))
    jkv = jmodel.init_cache(2, 16)
    pm = torch.as_tensor(mask)
    with port_attention(attention), torch.inference_mode():
        cross = model.cross_kv(params, model.encode(params, tree, torch.as_tensor(
            ids, dtype=torch.int32), pm, for_layer))
        kv_int, kv_t = model.init_cache(2, 16), model.init_cache(2, 16)
        cur = np.full((2, 1), 2, np.int32)
        for step in range(8):
            jlog, jkv, jtr = jmodel.decode_step(
                jparams, jtree, jnp.asarray(cur), jnp.full((2, 1), step, jnp.int32), jkv,
                jnp.int32(step), m, jcross, jfor)
            tok = torch.as_tensor(cur)
            got_i, kv_int, tr_i = model.decode_step(
                params, tree, tok, torch.full((2, 1), step, dtype=torch.int32), kv_int, step,
                pm, cross, for_layer)
            st = torch.tensor(step, dtype=torch.int32)
            got_t, kv_t, tr_t = model.decode_step(
                params, tree, tok, st.reshape(1, 1).expand(2, 1), kv_t, st, pm, cross,
                for_layer)
            assert torch.equal(got_t, got_i) and torch.equal(tr_t, tr_i), step
            for a, b in zip(kv_t, kv_int):
                assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v), step
            np.testing.assert_allclose(got_t.numpy(), np.asarray(jlog), rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(tr_t.numpy(), np.asarray(jtr))
            cur = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pad", [False, True])
def test_k1_plain_reads_no_column_past_the_causal_bound(dtype, pad):
    """The garbage-column argument of the speculative block: K1's plain
    version at kv_len = capacity, with every column after a row's own
    position filled with NaN, equals its result over the live columns only
    (kv_len = the largest live count), rows at different positions, with
    and without pad holes."""
    g = torch.Generator().manual_seed(3 + pad)
    B, S, H, Hkv, Dh = 4, 32, 4, 2, 128
    q = torch.randn(B, H, Dh, generator=g).to(dtype)
    k = torch.randn(B, S, Hkv, Dh, generator=g).to(dtype)
    v = torch.randn(B, S, Hkv, Dh, generator=g).to(dtype)
    qpos = torch.tensor([0, 5, 11, 16], dtype=torch.int32)
    live = int(qpos.max()) + 1
    holes = None
    if pad:
        holes = torch.rand(B, S, generator=g) > 0.2
        holes[:, 0] = True
    dead = torch.arange(S)[None, :] > qpos[:, None].long()
    k_nan = torch.where(dead[:, :, None, None], torch.tensor(float("nan"), dtype=dtype), k)
    v_nan = torch.where(dead[:, :, None, None], torch.tensor(float("nan"), dtype=dtype), v)
    got = fa.flash_decode_plain(q, k_nan, v_nan, qpos, S, scale=Dh ** -0.5, pad_mask=holes)
    want = fa.flash_decode_plain(q, k[:, :live], v[:, :live], qpos, live, scale=Dh ** -0.5,
                                 pad_mask=None if holes is None else holes[:, :live])
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-6, atol=1e-6)


# ---- the speculative step and block through the graph cache ----------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jmodel = JNllbModel(JNllbSpec(**SPEC), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(5))
    root = tmp_path_factory.mktemp("torch_graphs")
    path = write_nllb_store(root / "f32", jtree["layers"], "float32", N_ENC, seed=3)
    return jparams, to_port(jparams), path


def _engines(setup, threads=1, prefetch=False, **kw):
    """(JAX engine, port engine over the stand-in backend), speculative,
    each on its own model object (the engine sets its route margin)."""
    jparams, params, path = setup
    jmodel = JNllbModel(JNllbSpec(**SPEC), compute_dtype=jnp.float32)
    model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device="cpu")
    jarena = JArena(JStore(path), 2 * E, compute_dtype=jnp.float32, num_threads=threads)
    jtracer = JTracer(16, N_MOE, E, num_encoder_layers=N_ENC)
    jeng = JEngine(jmodel, jparams, jarena, tracer=jtracer, predictor=JPredictor(jtracer),
                   prefetch=prefetch, speculative=True, **kw)
    arena = ExpertArena(ExpertStore(path), 2 * E, compute_dtype=torch.float32, device="cpu",
                        num_threads=threads)
    tracer = ExpertTracer(16, N_MOE, E, num_encoder_layers=N_ENC)
    eng = Seq2SeqOffloadEngine(model, params, arena, tracer=tracer,
                               predictor=ExpertPredictor(tracer), prefetch=prefetch,
                               speculative=True, graph_backend=StandIn(), **kw)
    return jeng, eng


def _slot_inputs(rng, B, S_enc):
    """A slot tree (f32 weights and biases of S_SLOTS slots), the encoder
    mask and cross K/V, as numpy."""
    D, F, H = SPEC["d_model"], SPEC["decoder_ffn_dim"], SPEC["num_heads"]
    tree = {"gate": rng.standard_normal((S_SLOTS, D, F)) * 0.2,
            "down": rng.standard_normal((S_SLOTS, F, D)) * 0.2,
            "gate_bias": rng.standard_normal((S_SLOTS, F)) * 0.02,
            "down_bias": rng.standard_normal((S_SLOTS, D)) * 0.02}
    mask = np.ones((B, S_enc), np.float32)
    mask[1, 4:] = 0.0
    cross = [tuple(rng.standard_normal((B, S_enc, H, D // H)) for _ in range(2))
             for _ in range(SPEC["decoder_layers"])]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return ({k: f32(v) for k, v in tree.items()}, mask,
            [(f32(k), f32(v)) for k, v in cross])


def _rows(rng):
    """[L_moe, E] slot rows: every expert in a distinct slot or not
    resident (-1)."""
    rows = np.stack([rng.permutation(S_SLOTS)[:E] for _ in range(N_MOE)]).astype(np.int32)
    rows[rng.random(rows.shape) < 0.25] = -1
    return rows


@pytest.mark.parametrize("attention", ["flash", "naive"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_block_graph_replays_equal_jax(setup, k, attention):
    """``_spec_block_fn(k)`` through the graph cache with the stand-in, at
    step0 = 0, 3 and 7 with new slot rows and tokens each time, against the
    JAX engine's jitted block on the same inputs: tokens and traces equal,
    the K/V caches within 1e-4. One capture, three replays."""
    jeng, eng = _engines(setup)
    rng = np.random.default_rng(k)
    B, S_enc = 3, 6
    try:
        tree_np, mask_np, cross_np = _slot_inputs(rng, B, S_enc)
        tree = {n: torch.from_numpy(a) for n, a in tree_np.items()}
        jtree = {n: jnp.asarray(a) for n, a in tree_np.items()}
        mask, jmask = torch.from_numpy(mask_np), jnp.asarray(mask_np)
        cross = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in cross_np]
        jcross = [(jnp.asarray(a), jnp.asarray(b)) for a, b in cross_np]
        kvs, jkvs = eng.model.init_cache(B, 16), jeng.model.init_cache(B, 16)
        for step0 in (0, 3, 7):
            rows = _rows(rng)
            tok0 = rng.integers(3, SPEC["vocab_size"], (B, 1)).astype(np.int32)
            jtoks, jkvs, jtr = jeng._spec_block_fn(k)(
                jeng.params, jtree, {}, jnp.asarray(rows), jnp.asarray(tok0), step0, jkvs,
                jmask, jcross)
            with port_attention(attention), torch.inference_mode():
                toks, kvs, tr = eng._spec_block_fn(k)(
                    tree, torch.from_numpy(rows), torch.from_numpy(tok0), step0, kvs, mask,
                    cross)
            np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
            for a, b in zip(kvs, jkvs):
                np.testing.assert_allclose(a.k.numpy(), np.asarray(b.k), rtol=TOL, atol=TOL)
                np.testing.assert_allclose(a.v.numpy(), np.asarray(b.v), rtol=TOL, atol=TOL)
        st = eng.graph_stats()
        assert (st["captures"], st["recaptures"], st["replays"]) == (1, 0, 3)
        assert st["warmup_steps"] == k and eng.graphs.backend.captured == 1
        assert eng.executed_steps == 3 * k
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


def test_spec_step_graph_replays_equal_jax(setup):
    """The speculative whole step through the graph cache, at steps 0, 3,
    6 and 7 with new slot rows and tokens: logits within 1e-4 of the JAX
    engine's jitted step, traces equal, one capture."""
    jeng, eng = _engines(setup)
    rng = np.random.default_rng(21)
    B, S_enc = 3, 6
    try:
        tree_np, mask_np, cross_np = _slot_inputs(rng, B, S_enc)
        tree = {n: torch.from_numpy(a) for n, a in tree_np.items()}
        jtree = {n: jnp.asarray(a) for n, a in tree_np.items()}
        mask, jmask = torch.from_numpy(mask_np), jnp.asarray(mask_np)
        cross = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in cross_np]
        jcross = [(jnp.asarray(a), jnp.asarray(b)) for a, b in cross_np]
        kvs, jkvs = eng.model.init_cache(B, 16), jeng.model.init_cache(B, 16)
        for step in (0, 3, 6, 7):
            rows = _rows(rng)
            tok = rng.integers(3, SPEC["vocab_size"], (B, 1)).astype(np.int32)
            pos = np.full((B, 1), step, np.int32)
            jlog, jkvs, jtr = jeng._spec_step(
                jeng.params, jtree, {}, jnp.asarray(rows), jnp.asarray(tok), jnp.asarray(pos),
                step, jkvs, jmask, jcross)
            with torch.inference_mode():
                log, kvs, tr = eng._spec_step(
                    tree, torch.from_numpy(rows), torch.from_numpy(tok), torch.from_numpy(pos),
                    step, kvs, mask, cross)
            np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
        assert eng.graph_stats()["captures"] == 1 and eng.graph_stats()["replays"] == 4
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()


# ---- whole generations: graphs on and off ----------------------------------


GEN = dict(max_new_tokens=8, attention_mask=MASK, eos_token_id=None)


@pytest.mark.parametrize("k,mode", [(1, "whole"), (2, "whole"), (4, "whole"), (4, "prefix")])
def test_engine_graphs_on_and_off_agree(setup, monkeypatch, k, mode):
    """The speculative engine with the stand-in backend and with
    ``graphs=False``, one fetch worker and no prefetch: equal tokens,
    executions, executed steps and arena counters, equal to the JAX
    engine's tokens. A second request of the same shape captures
    nothing new."""
    jparams, params, path = setup
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    jeng, eng = _engines(setup, spec_block=k)
    model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device="cpu")
    tracer = ExpertTracer(16, N_MOE, E, num_encoder_layers=N_ENC)
    eager = Seq2SeqOffloadEngine(
        model, params, ExpertArena(ExpertStore(path), 2 * E, compute_dtype=torch.float32,
                                   device="cpu", num_threads=1),
        tracer=tracer, predictor=ExpertPredictor(tracer), prefetch=False, speculative=True,
        spec_block=k, graphs=False)
    try:
        want = jeng.generate(IDS, **GEN)
        got = eng.generate(IDS, **GEN)
        base = eager.generate(IDS, **GEN)
        assert eager.graphs is None and eager.graph_stats() == {}
        np.testing.assert_array_equal(got.sequences, base.sequences)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        assert eng.replay_counts == eager.replay_counts == jeng.replay_counts
        assert eng.executed_steps == eager.executed_steps
        assert eng.stats() == eager.stats()
        assert eng.decode_window_stats() == eager.decode_window_stats()
        st = eng.graph_stats()
        assert st["captures"] >= 1 and st["recaptures"] == 0
        assert st["replays"] == sum(eng.replay_counts)
        again = eng.generate(IDS, **GEN)
        np.testing.assert_array_equal(again.sequences, eager.generate(IDS, **GEN).sequences)
        assert eng.graph_stats()["captures"] == st["captures"]
    finally:
        jeng.arena.shutdown()
        eng.arena.shutdown()
        eager.arena.shutdown()


@pytest.mark.parametrize("k,mode", [(2, "whole"), (2, "prefix"), (4, "whole"), (4, "prefix")])
def test_engine_graph_outputs_survive_replays(monkeypatch, k, mode):
    """bf16 weights, packed int4 slots through K3's plain version, an arena
    of E + 2 slots with prefetch and two workers, so that blocks run again
    on a miss: the graph's outputs, which every replay overwrites, are
    copied wherever the engine keeps them across one (the next block's
    start token, a prefix's accepted tokens), so graph and eager greedy
    tokens stay equal over two requests."""
    from moe_infinity_tpu_torch.store.blob import SyntheticStore

    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    # wide enough that greedy tokens rarely repeat, so a stale start token shows
    spec = dict(SPEC, vocab_size=300, d_model=256, num_heads=2, encoder_ffn_dim=512,
                decoder_ffn_dim=512, num_experts=8)
    D, F, E = spec["d_model"], spec["decoder_ffn_dim"], spec["num_experts"]
    fields = [("fc1.weight", (D, F // 2), "int4"), ("fc1.weight.scale", (F,), "float32"),
              ("fc1.bias", (F,), "float32"), ("fc2.weight", (F, D // 2), "int4"),
              ("fc2.weight.scale", (D,), "float32"), ("fc2.bias", (D,), "float32")]
    store = SyntheticStore(N_MOE, E, fields, meta={"arch": "nllb", "num_encoder_moe_layers":
                                                   N_ENC}, seed=k, distinct_records=True)
    model = NllbModel(NllbSpec(**spec), compute_dtype=torch.bfloat16, device="cpu")
    params, _ = model.init_random(torch.Generator().manual_seed(k), with_experts=False)
    seqs, engines = {}, []
    try:
        for graphs in (True, False):
            tracer = ExpertTracer(16, N_MOE, E, num_encoder_layers=N_ENC)
            eng = Seq2SeqOffloadEngine(
                model, params, ExpertArena(store, E + 2, compute_dtype=torch.bfloat16,
                                           device="cpu", num_threads=2),
                tracer=tracer, predictor=ExpertPredictor(tracer), prefetch=True,
                impl="pallas", speculative=True, spec_block=k, graphs=graphs,
                graph_backend=StandIn() if graphs else None)
            engines.append(eng)
            gen = dict(max_new_tokens=16, attention_mask=MASK, eos_token_id=None)
            seqs[graphs] = [eng.generate(IDS, **gen).sequences for _ in range(2)]
        for a, b in zip(seqs[True], seqs[False]):
            np.testing.assert_array_equal(a, b)
        assert max(engines[0].replay_counts) > 1
    finally:
        for eng in engines:
            eng.arena.shutdown()


# the decoder-only engine: a tiny Mixtral (3 layers, 8 experts top-2, f32)
MIXTRAL = dict(
    vocab_size=160, hidden_size=48, intermediate_size=96, num_layers=3, num_heads=6,
    num_kv_heads=2, head_dim=8, num_experts=8, top_k=2, rms_eps=1e-5, rope_theta=1e6,
    tie_embeddings=False,
)
PROMPTS = np.array([[5, 17, 31, 7], [9, 4, 2, 61]])


@pytest.fixture(scope="module")
def mixtral_setup(tmp_path_factory):
    jmodel = JMixtralModel(JMixtralSpec(**MIXTRAL), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(6), expert_dtype=jnp.float32)
    path = write_decoder_store(tmp_path_factory.mktemp("torch_graphs_mixtral") / "store",
                               jtree["layers"], "mixtral")
    model = MixtralModel(MixtralSpec(**MIXTRAL), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, model, to_port(jparams), path


@pytest.mark.parametrize("k,mode", [(1, "whole"), (2, "whole"), (2, "prefix"), (3, "prefix")])
def test_decoder_engine_graphs_on_and_off_agree(mixtral_setup, monkeypatch, k, mode):
    """The decoder-only ``OffloadEngine`` under ``Generator``: the whole step
    (k = 1) or the k-step blocks as replays of graphs captured by the
    stand-in backend equal the eager engine (``graphs=False``) and the JAX
    engine over two requests of 10 tokens: tokens, executions, counters. An
    arena of 12 slots (20 for blocks of 2, all 24 experts for blocks of 3:
    a block's union is larger), one worker, no prefetch: steps run again on
    a miss, so replays outnumber captures. Every execution is a replay; the
    second request captures nothing new."""
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    jmodel, jparams, model, params, path = mixtral_setup
    gen = dict(max_new_tokens=10, eos_token_id=None)
    slots = {1: 12, 2: 20}.get(k, 24)
    jarena = JArena(JStore(path), slots, compute_dtype=jnp.float32, num_threads=1)
    jeng = JOffloadEngine(jmodel, jparams, jarena, prefetch=False, speculative=True,
                          spec_block=k)
    engines, seqs = {}, {}
    try:
        want = [JGenerator(stepper=jeng, max_seq_len=64).generate(PROMPTS, **gen).sequences
                for _ in range(2)]
        for graphs in (True, False):
            arena = ExpertArena(ExpertStore(path), slots, compute_dtype=torch.float32,
                                device="cpu", num_threads=1)
            eng = engines[graphs] = OffloadEngine(
                model, params, arena, prefetch=False, speculative=True, spec_block=k,
                graphs=graphs, graph_backend=StandIn() if graphs else None)
            g = Generator(stepper=eng, max_seq_len=64)
            seqs[graphs] = [g.generate(PROMPTS, **gen).sequences]
            if graphs:
                first = eng.graph_stats()
            seqs[graphs].append(g.generate(PROMPTS, **gen).sequences)
        eng, eager = engines[True], engines[False]
        for a, b, w in zip(seqs[True], seqs[False], want):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, w)
        assert eng.replay_counts == eager.replay_counts == jeng.replay_counts
        assert max(eng.replay_counts) > 1 and eng.spec_block == k
        assert eng.executed_steps == eager.executed_steps
        assert eng.stats() == eager.stats() == jeng.stats()
        assert eager.graphs is None and eager.graph_stats() == {}
        st = eng.graph_stats()
        assert st["recaptures"] == 0 and st["replays"] == sum(eng.replay_counts)
        assert 1 <= st["captures"] == first["captures"] < st["replays"]
    finally:
        jarena.shutdown()
        for e in engines.values():
            e.arena.shutdown()


@pytest.mark.parametrize("graphs", [False, True])
def test_dropped_engine_frees_its_arena_at_once(setup, graphs):
    """No reference cycle keeps an engine, its graphs or its arena's slots
    alive once the caller drops them: the card's memory comes back without
    waiting for a garbage collection."""
    import gc
    import weakref

    _, params, path = setup
    model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device="cpu")
    tracer = ExpertTracer(16, N_MOE, E, num_encoder_layers=N_ENC)
    arena = ExpertArena(ExpertStore(path), 2 * E, compute_dtype=torch.float32, device="cpu")
    eng = Seq2SeqOffloadEngine(model, params, arena, tracer=tracer,
                               predictor=ExpertPredictor(tracer), speculative=True,
                               spec_block=4, graphs=graphs,
                               graph_backend=StandIn() if graphs else None)
    eng.generate(IDS, **GEN)
    arena.shutdown()
    refs = [weakref.ref(o) for o in (eng, arena, arena.pytree()["gate"])]
    gc.disable()
    try:
        del eng, arena
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.mark.parametrize("eos", [None, "first"])
def test_generator_graphs_on_and_off_agree(tiny, eos):
    """The resident Seq2SeqGenerator with the stand-in backend and with
    ``graphs=False``: equal tokens with and without EOS, each step's logits
    bit for bit over 8 steps, one capture for two requests of a shape."""
    _, _, _, model, params, tree = tiny
    for_layer = ResidentProvider.for_layer
    ids, mask = IDS[:2], MASK[:2]
    graphed = Seq2SeqGenerator(model, params, tree, for_layer, graph_backend=StandIn())
    eager = Seq2SeqGenerator(model, params, tree, for_layer, graphs=False)
    eos_id = None
    if eos:
        first = eager.generate(ids, max_new_tokens=1, attention_mask=mask, eos_token_id=None)
        eos_id = int(first.sequences[0, 1])
    gen = dict(max_new_tokens=8, attention_mask=mask, eos_token_id=eos_id)
    got, want = graphed.generate(ids, **gen), eager.generate(ids, **gen)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)
    assert got.stats["decode_steps"] == want.stats["decode_steps"]
    np.testing.assert_array_equal(graphed.generate(ids, **gen).sequences, want.sequences)
    assert graphed.graph_stats()["captures"] == 1 and eager.graph_stats() == {}
    with torch.inference_mode():
        pm = torch.as_tensor(mask)
        cross = model.cross_kv(params, model.encode(
            params, tree, torch.as_tensor(ids, dtype=torch.int32), pm, for_layer))
        steps = [g.decoder(2, 16, pm, cross) for g in (graphed, eager)]
        cur = torch.full((2, 1), 2, dtype=torch.int32)
        for step in range(8):
            (lg, ng), (le, ne) = (s(cur, step) for s in steps)
            assert torch.equal(lg, le) and torch.equal(ng, ne), step
            cur = ne[:, None].to(torch.int32)


@pytest.mark.parametrize("k", [1, 4])
def test_stream_blocks_graphs_on_and_off_agree(setup, k):
    """Stream decode through the stand-in backend and eagerly, from U = 2 on
    sharpened weights: equal tokens and executions; one graph per (k, U)
    met, each execution a replay after its capture, none recaptured."""
    from torch_port_helpers import sharpen_seq2seq

    jparams, _, path = setup
    params = to_port(sharpen_seq2seq(jax.tree.map(lambda a: a, jparams)))
    runs = {}
    for graphs in (True, False):
        store = ExpertStore(path)
        arena = ExpertArena(store, E, compute_dtype=torch.float32, device="cpu", num_threads=1,
                            pinned_tier=PinnedExpertTier(store, device="cpu",
                                                         shared_record=False))
        model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device="cpu")
        eng = Seq2SeqOffloadEngine(model, params, arena, prefetch=False, speculative=True,
                                   spec_block=k, stream_decode=True, stream_unique=2,
                                   graphs=graphs, graph_backend=StandIn() if graphs else None)
        try:
            runs[graphs] = (eng.generate(IDS, **GEN).sequences, eng.replay_counts,
                            eng.graph_stats(), eng._stream_U)
        finally:
            arena.shutdown()
    (seq_g, ex_g, st, u_g), (seq_e, ex_e, st_e, u_e) = runs[True], runs[False]
    np.testing.assert_array_equal(seq_g, seq_e)
    assert ex_g == ex_e and u_g == u_e and max(ex_g) > 1 and st_e == {}
    assert st["recaptures"] == 0 and st["replays"] == sum(ex_g)
    assert st["captures"] == st["graphs"] == len({2, 4} & set(range(2, u_g + 1)))


@pytest.mark.parametrize("k,mode", [(1, "whole"), (4, "whole"), (4, "prefix")])
def test_direct_stacks_graphs_on_and_off_agree(setup, monkeypatch, k, mode):
    """Speculative steps and blocks with the two deepest layers direct (a
    layer-aligned tier) through the stand-in backend and eagerly: equal
    tokens and executions; the graphs read the direct stacks by address, so
    a stack that moves is captured anew."""
    monkeypatch.setenv("MOE_SPEC_BLOCK_MODE", mode)
    _, params, path = setup
    engines = []
    for graphs in (True, False):
        store = ExpertStore(path)
        arena = ExpertArena(store, 2 * E, compute_dtype=torch.float32, device="cpu",
                            num_threads=1, pinned_tier=PinnedExpertTier(
                                store, device="cpu", shared_record=False, align_rows=E))
        model = NllbModel(NllbSpec(**SPEC), compute_dtype=torch.float32, device="cpu")
        engines.append(Seq2SeqOffloadEngine(
            model, params, arena, prefetch=False, speculative=True, spec_block=k,
            max_direct_layers=2, graphs=graphs, graph_backend=StandIn() if graphs else None))
    g, e = engines
    try:
        assert g._direct_mlis == {N_MOE - 2, N_MOE - 1}
        np.testing.assert_array_equal(g.generate(IDS, **GEN).sequences,
                                      e.generate(IDS, **GEN).sequences)
        assert g.replay_counts == e.replay_counts
        assert g.graph_stats()["recaptures"] == 0
        stack = g._direct[str(N_MOE - 1)]
        stack["gate"] = stack["gate"].clone()  # moved: the graphs must not replay over it
        g._direct_split[N_MOE - 1][0]["gate"] = stack["gate"]
        np.testing.assert_array_equal(g.generate(IDS, **GEN).sequences,
                                      e.generate(IDS, **GEN).sequences)
        assert g.graph_stats()["recaptures"] > 0
    finally:
        g.arena.shutdown()
        e.arena.shutdown()


def test_generator_graphs_serve_concurrent_requests():
    """Fault F3: two threads send their own 6-token prompt 10 times each, 24
    new tokens, to one resident generator with graphs (the stand-in backend),
    whose graph and decoder buffers per shape the two share. Every output
    equals the isolated eager run's (before the generator's lock, 16 of the
    20 differed)."""
    import threading

    from moe_infinity_tpu.models.nllb import NllbModel as JModel, NllbSpec as JSpec
    from torch_port_helpers import int4_expert_tree, sharpen_seq2seq

    jmodel = JModel(JSpec(**TINY_NLLB), compute_dtype=jnp.float32)
    jparams, _ = jmodel.init_random(jax.random.PRNGKey(3), with_experts=False)
    params = to_port(sharpen_seq2seq(jparams))
    tree = to_port(int4_expert_tree(np.random.default_rng(3), TINY_NLLB, 2))
    model = NllbModel(NllbSpec(**TINY_NLLB), compute_dtype=torch.float32, device="cpu")
    for_layer = ResidentProvider.for_layer
    graphed = Seq2SeqGenerator(model, params, tree, for_layer, impl="pallas",
                               graph_backend=StandIn())
    eager = Seq2SeqGenerator(model, params, tree, for_layer, impl="pallas", graphs=False)
    prompts = [np.array([[5, 31, 8, 77, 40, 2]]), np.array([[9, 3, 44, 61, 17, 2]])]
    gen = dict(max_new_tokens=24, eos_token_id=None)
    want = [eager.generate(p, **gen).sequences for p in prompts]
    assert not np.array_equal(want[0], want[1])  # the race would show
    got = [[None] * 10 for _ in prompts]
    errors = []

    def serve(i):
        try:
            for n in range(10):
                got[i][n] = graphed.generate(prompts[i], **gen).sequences
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    same = sum(np.array_equal(g, want[i]) for i in range(2) for g in got[i])
    assert same == 20, f"{same} of 20 outputs equal the isolated runs"
    assert graphed.graph_stats()["captures"] == 1


# ---- the graph cache -------------------------------------------------------


class _Counting:
    """A stand-in whose graph counts 2 K3 launches and 1 K1 launch a replay."""

    def capture(self, fn):
        out = fn()

        def replay():
            for o, n in zip(out, fn()):
                o.copy_(n)

        return replay, out, {"gmm": 2, "flash_decode": 1}


def test_graph_cache_keys_pointers_and_counts():
    """A graph replays with new inputs; a tensor it reads that moved is
    captured anew (counted); a new shape is a new capture; replays add the
    launches counted at capture."""
    w = torch.arange(6, dtype=torch.float32)
    cache = GraphCache(_Counting(), "cpu")
    reset_launches()

    def fn(x, step):
        return (x * w[step], )

    for i in range(3):
        (out,) = cache.run("f", fn, {"x": torch.full((2,), float(i)), "step": i}, [w])
        assert torch.equal(out, torch.full((2,), float(i * i)))
    assert launch_counts()["gmm"] == 6 and launch_counts()["flash_decode"] == 3
    w = w.clone()  # moved: the graph would read the old storage
    cache.run("f", fn, {"x": torch.ones(2), "step": 1}, [w])
    cache.run("f", fn, {"x": torch.ones(3), "step": 1}, [w])  # another shape
    assert cache.stats() == {"graphs": 2, "captures": 2, "recaptures": 1, "replays": 5,
                             "capture_s": cache.stats()["capture_s"], "warmup_steps": 3}
    reset_launches()


def test_grown_keeps_outgrown_buffers(monkeypatch):
    """``_build.grown`` (the per-stream tickets and split scratch): a buffer
    large enough is returned as it is; a larger request makes a new one of
    at least twice the size and keeps the outgrown one (a graph captured
    before may hold its address), never freeing it; under a capture a
    buffer may not be made."""
    from moe_infinity_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_retired", [])
    cache = {}

    def make(n):
        return torch.zeros(n)

    a = _build.grown(cache, "s", 10, make, False)
    assert a.numel() == 10 and _build.grown(cache, "s", 8, make, True) is a
    b = _build.grown(cache, "s", 12, make, False)
    assert b.numel() == 20 and cache["s"] is b and _build._retired == [a]
    c = _build.grown(cache, "s", 100, make, False)
    assert c.numel() == 100 and _build._retired[1] is b
    assert sum(t.numel() for t in _build._retired) < c.numel()
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        _build.grown(cache, "s", 101, make, True)
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        _build.grown(cache, "t", 1, make, True)
    assert cache["s"] is c and "t" not in cache
