"""Dense-layer paging on the CPU (``runtime/dense_arena.py``, the engines'
paged layers, ``MoE``'s residency decision) against the JAX package,
mirroring tests/test_dense_paging.py:

* the arena's ring, its heterogeneous groups and its slot split equal to
  the JAX arena's; a landing never lands into the slot of a layer that is
  still acquired (the JAX lease's guarantee; on the card stream order adds
  the event fences, tests/test_torch_cuda_offload.py);
* with one worker and no prefetch window (``ahead=0``) the order of events
  is fixed: the dense hits and misses of the ring and of the three engines
  (``PagedDenseEngine`` for OPT, ``OffloadEngine`` for Mixtral,
  ``Seq2SeqOffloadEngine`` for NLLB over the combined stack) equal the JAX
  arena's, and their tokens the JAX engine's and the resident path's;
* through ``MoE``: OPT paged against HF and the JAX facade (``dense_paging``
  on, and chosen by "auto" on a tiny budget), Mixtral, Switch and NLLB with
  paged dense layers and offloaded experts at once (speculative decode
  forced off), each against HF and the JAX facade.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.entrypoints.api import MoE as JMoE
from moe_infinity_tpu.runtime.dense_arena import DenseLayerArena as JDenseArena
from moe_infinity_tpu_torch.entrypoints.api import MoE
from moe_infinity_tpu_torch.runtime.dense_arena import (
    DenseLayerArena,
    tree_flatten,
    tree_unflatten,
)

from torch_port_helpers import jax_to_numpy, one_intra_op_thread  # noqa: F401
from torch_port_helpers import port_attention, to_port


# ---------------------------------------------------------------------------
# the arena
# ---------------------------------------------------------------------------

def _layer(i, shape=(8, 16)):
    rng = np.random.default_rng(i)
    return {"w": rng.normal(size=shape).astype(np.float32),
            "b": rng.normal(size=shape[1]).astype(np.float32)}


def _port(layers):
    return [{k: torch.from_numpy(v) for k, v in lt.items()} for lt in layers]


def _arenas(layers, slots, **kw):
    return (DenseLayerArena(_port(layers), slots, device="cpu", **kw),
            JDenseArena(layers, slots, **kw))


def test_tree_flatten_order_equals_jax():
    tree = {"b": [torch.ones(2), None, {"z": torch.zeros(1), "a": torch.ones(3)}],
            "a": (torch.zeros(4),)}
    leaves, treedef = tree_flatten(tree)
    jleaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tree))
    assert [tuple(t.shape) for t in leaves] == [tuple(a.shape) for a in jleaves]
    back = tree_unflatten(treedef, leaves)
    assert back["b"][1] is None and back["b"][2]["a"] is leaves[2]
    assert isinstance(back["a"], tuple)


def test_arena_sequential_ring():
    L = 6
    arena = DenseLayerArena(_port([_layer(i) for i in range(L)]), 3, device="cpu", ahead=1)
    try:
        for _round in range(3):
            for li in range(L):
                slot = arena.acquire(li)
                got = arena.tree(arena.group_of(li))[0][slot]  # leaf 0: "b"
                np.testing.assert_array_equal(got.numpy(), _layer(li)["b"])
                assert torch.equal(arena.layer_view(li, slot)["w"],
                                   torch.from_numpy(_layer(li)["w"]))
                arena.release(li)
        st = arena.stats()
        # layer 0 misses cold; how many more miss depends on how fast the
        # window's landings are (the CPU's copies are quick)
        assert st["dense_misses"] >= 1 and st["dense_misses"] + st["dense_hits"] == 3 * L
        assert st["dense_hits"] > 0  # the prefetch ahead landed some
        c = arena.copy_stats()
        assert c["landings"] >= L and c["bytes_landed"] == c["landings"] * arena.layer_bytes[0]
    finally:
        arena.shutdown()


@pytest.mark.parametrize("L,slots", [(4, 4), (6, 3), (5, 2)])
def test_ring_counters_equal_jax(L, slots):
    """One worker, no window: every acquire is a hit exactly when its layer
    is resident, so both arenas take the same path through the ring."""
    layers = [_layer(i) for i in range(L)]
    arena, jarena = _arenas(layers, slots, ahead=0, num_threads=1)
    try:
        for a in (arena, jarena):
            for _round in range(3):
                for li in range(L):
                    a.acquire(li)
                    a.release(li)
        assert arena.stats() == jarena.stats()
        assert arena.layer_to_slot == jarena.layer_to_slot
    finally:
        arena.shutdown()
        jarena.shutdown()


@pytest.mark.parametrize("shapes,slots", [
    ([(8, 16), (4, 4), (8, 16), (4, 4)], 4),
    ([(8, 16)] * 5 + [(4, 4)], 3),
    ([(8, 16), (4, 4), (2, 2)] * 4, 7),
    ([(8, 16)] * 9 + [(4, 4)] * 3, 5),
])
def test_arena_groups_equal_jax(shapes, slots):
    layers = [_layer(i, s) for i, s in enumerate(shapes)]
    arena, jarena = _arenas(layers, slots, ahead=1)
    try:
        assert [arena.group_of(i) for i in range(len(layers))] == \
               [jarena.group_of(i) for i in range(len(layers))]
        assert [g["num_slots"] for g in arena._groups] == \
               [g["num_slots"] for g in jarena._groups]
        assert arena.num_slots == jarena.num_slots
        for li in list(range(len(layers))) + [0, len(layers) - 1]:
            slot = arena.acquire(li)
            got = arena.tree(arena.group_of(li))[0][slot]
            np.testing.assert_array_equal(got.numpy(), layers[li]["b"])
            arena.release(li)
    finally:
        arena.shutdown()
        jarena.shutdown()


def test_landing_waits_for_the_acquired_layers():
    """Two slots, both layers acquired: an acquire of a third layer waits;
    neither held slot is overwritten until one is released (what the JAX
    lease guarantees, and what the JAX arena does here too)."""
    layers = [_layer(i) for i in range(4)]
    for arena in _arenas(layers, 2, ahead=0, num_threads=1):
        try:
            s0, s1 = arena.acquire(0), arena.acquire(1)
            got = {}
            t = threading.Thread(target=lambda: got.setdefault("slot", arena.acquire(2)))
            t.start()
            time.sleep(0.2)
            assert 2 not in arena.layer_to_slot and "slot" not in got
            for li, s in ((0, s0), (1, s1)):
                np.testing.assert_array_equal(np.asarray(arena.tree(0)[0][s]), layers[li]["b"])
            arena.release(0)
            t.join(timeout=10)
            assert got["slot"] == s0
            np.testing.assert_array_equal(np.asarray(arena.tree(0)[0][s1]), layers[1]["b"])
            arena.release(1)
            arena.release(2)
        finally:
            arena.shutdown()


def test_unread_landings_counted():
    """A prefetched layer evicted before any acquire read it is counted (the
    wrapped window's cost over a combined stack)."""
    layers = [_layer(i) for i in range(6)]
    arena = DenseLayerArena(_port(layers), 2, device="cpu", ahead=1, num_threads=1)
    try:
        for li in (0, 1, 3, 4):  # skipping 2: its prefetch is never read
            arena.acquire(li)
            arena.release(li)
            time.sleep(0.05)
        c = arena.copy_stats()
        assert c["unread_landings"] >= 1
        assert c["unread_bytes"] == c["unread_landings"] * arena.layer_bytes[2]
    finally:
        arena.shutdown()


# ---------------------------------------------------------------------------
# the engines over a dense arena with one worker and no window: counters
# and tokens equal the JAX engine's
# ---------------------------------------------------------------------------

def test_paged_dense_engine_equals_jax(tmp_path):
    from transformers import OPTConfig, OPTForCausalLM

    from moe_infinity_tpu.models.opt import OPTModel as JOPT
    from moe_infinity_tpu.models.opt import OPTSpec as JSpec
    from moe_infinity_tpu.runtime.dense_arena import PagedDenseEngine as JPaged
    from moe_infinity_tpu.runtime.generate import Generator as JGenerator
    from moe_infinity_tpu.runtime.generate import ResidentStepper as JResident
    from moe_infinity_tpu_torch.models.opt import OPTModel, OPTSpec
    from moe_infinity_tpu_torch.runtime.dense_arena import PagedDenseEngine
    from moe_infinity_tpu_torch.runtime.generate import Generator

    cfg = OPTConfig(vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=4,
                    num_attention_heads=4, max_position_embeddings=64)
    jmodel = JOPT(JSpec.from_hf(cfg), compute_dtype=jnp.float32)
    model = OPTModel(OPTSpec.from_hf(cfg), compute_dtype=torch.float32, device="cpu")
    torch.manual_seed(3)
    hf = OPTForCausalLM(cfg).eval()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}

    class Dense:  # the DenseArchive protocol over the HF weights
        def get(self, name):
            return sd[name]

        def tensor(self, name):
            return torch.from_numpy(sd[name])

    jparams = jmodel.load_params(Dense())
    params = model.load_params(Dense())
    prompt = np.array([[5, 9, 33, 7], [1, 2, 3, 4]])
    want = JGenerator(stepper=JResident(jmodel, jparams, {}, lambda e, m: e),
                      max_seq_len=64).generate(prompt, max_new_tokens=6).sequences
    jlayers = jax_to_numpy(jparams.pop("layers"))
    layers = params.pop("layers")
    jarena = JDenseArena(jlayers, 2, ahead=0, num_threads=1)
    arena = DenseLayerArena(layers, 2, device="cpu", ahead=0, num_threads=1)
    try:
        jgot = JGenerator(stepper=JPaged(jmodel, jparams, jarena), max_seq_len=64).generate(
            prompt, max_new_tokens=6).sequences
        with port_attention("naive"):
            got = Generator(stepper=PagedDenseEngine(model, params, arena),
                            max_seq_len=64).generate(prompt, max_new_tokens=6).sequences
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(jgot, want)
        assert arena.stats() == jarena.stats() and arena.stats()["dense_misses"] > 0
    finally:
        arena.shutdown()
        jarena.shutdown()


def _nllb_setup(tmp_path, n_layers=4):
    from moe_infinity_tpu.models.nllb import NllbModel as JNllb
    from moe_infinity_tpu.models.nllb import NllbSpec as JSpec
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from torch_port_helpers import write_nllb_store

    spec = dict(vocab_size=96, d_model=32, num_heads=4, encoder_layers=n_layers,
                decoder_layers=n_layers, encoder_ffn_dim=64, decoder_ffn_dim=64,
                encoder_sparse_step=2, decoder_sparse_step=2, num_experts=4, pad_token_id=1,
                decoder_start_token_id=2, max_positions=64, scale_embedding=True)
    jmodel = JNllb(JSpec(**spec), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(5))
    path = write_nllb_store(tmp_path / "s", jtree["layers"], "float32", n_layers // 2, seed=3)
    model = NllbModel(NllbSpec(**spec), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, model, to_port(jparams), path


def test_seq2seq_engine_paged_equals_jax(tmp_path):
    from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
    from moe_infinity_tpu.runtime.engine_seq2seq import Seq2SeqOffloadEngine as JS2S
    from moe_infinity_tpu.store.blob import ExpertStore as JStore
    from moe_infinity_tpu_torch.runtime.arena import ExpertArena
    from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine
    from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
    from moe_infinity_tpu_torch.store.blob import ExpertStore

    jmodel, jparams, model, params, path = _nllb_setup(tmp_path)
    ids = np.array([[5, 31, 8, 77, 40, 2], [9, 3, 44, 2, 1, 1]])
    gen = dict(max_new_tokens=6, attention_mask=(ids != 1).astype(np.float32),
               eos_token_id=None)
    provider = ResidentProvider.from_store(ExpertStore(path), dtype=torch.float32, device="cpu")
    with port_attention("naive"):
        base = Seq2SeqGenerator(model, params, provider.pytree(),
                                ResidentProvider.for_layer).generate(ids, **gen).sequences

    def stacked(p, conv):
        layers = list(p["enc_blocks"]) + list(p["dec_blocks"])
        top = {k: v for k, v in p.items() if k not in ("enc_blocks", "dec_blocks")}
        top["enc_blocks"], top["dec_blocks"] = [{}], [{}]
        return top, conv(layers)

    jtop, jlayers = stacked(jparams, jax_to_numpy)
    top, layers = stacked(params, lambda x: x)
    jarena = JDenseArena(jlayers, 4, ahead=0, num_threads=1)
    arena = DenseLayerArena(layers, 4, device="cpu", ahead=0, num_threads=1)
    jx = JArena(JStore(path), 8, compute_dtype=jnp.float32, num_threads=1)
    px = ExpertArena(ExpertStore(path), 8, compute_dtype=torch.float32, device="cpu",
                     num_threads=1)
    try:
        assert arena.L == 8 and [g["num_slots"] for g in arena._groups] == \
               [g["num_slots"] for g in jarena._groups]
        jeng = JS2S(jmodel, jtop, jx, prefetch=False, dense_arena=jarena)
        eng = Seq2SeqOffloadEngine(model, top, px, prefetch=False, dense_arena=arena)
        with pytest.raises(ValueError, match="speculative decode requires"):
            Seq2SeqOffloadEngine(model, top, px, dense_arena=arena, speculative=True)
        want = jeng.generate(ids, **gen).sequences
        with port_attention("naive"):
            got = eng.generate(ids, **gen).sequences
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, base)
        s, js = eng.stats(), jeng.stats()
        assert {k: s[k] for k in js} == js
        assert s["dense_misses"] > 0
    finally:
        for a in (arena, jarena, jx, px):
            a.shutdown()


def test_decoder_engine_paged_equals_jax(tmp_path):
    from moe_infinity_tpu.models.mixtral import MixtralModel as JMixtral
    from moe_infinity_tpu.models.mixtral import MixtralSpec as JSpec
    from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
    from moe_infinity_tpu.runtime.engine import OffloadEngine as JEngine
    from moe_infinity_tpu.runtime.generate import Generator as JGenerator
    from moe_infinity_tpu.store.blob import ExpertStore as JStore
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
    from moe_infinity_tpu_torch.runtime.arena import ExpertArena
    from moe_infinity_tpu_torch.runtime.engine import OffloadEngine
    from moe_infinity_tpu_torch.runtime.generate import Generator
    from moe_infinity_tpu_torch.store.blob import ExpertStore
    from torch_port_helpers import write_decoder_store

    spec = dict(vocab_size=160, hidden_size=48, intermediate_size=96, num_layers=3,
                num_heads=6, num_kv_heads=2, head_dim=8, num_experts=8, top_k=2, rms_eps=1e-5,
                rope_theta=1e6, tie_embeddings=False)
    jmodel = JMixtral(JSpec(**spec), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(3), expert_dtype=jnp.float32)
    path = write_decoder_store(tmp_path / "s", jtree["layers"], "mixtral", "float32")
    model = MixtralModel(MixtralSpec(**spec), compute_dtype=torch.float32, device="cpu")
    params = to_port(jparams)
    jlayers = jax_to_numpy(jparams["layers"])
    layers = params["layers"]
    jtop = dict(jparams, layers=[None] * 3)
    top = dict(params, layers=[None] * 3)
    jarena = JDenseArena(jlayers, 2, ahead=0, num_threads=1)
    arena = DenseLayerArena(layers, 2, device="cpu", ahead=0, num_threads=1)
    jx = JArena(JStore(path), 8, compute_dtype=jnp.float32, num_threads=1)
    px = ExpertArena(ExpertStore(path), 8, compute_dtype=torch.float32, device="cpu",
                     num_threads=1)
    prompt = np.array([[5, 17, 31, 7], [9, 4, 2, 61]])
    try:
        with pytest.raises(ValueError, match="speculative decode requires"):
            OffloadEngine(model, top, px, dense_arena=arena, speculative=True)
        jeng = JEngine(jmodel, jtop, jx, prefetch=False, dense_arena=jarena)
        eng = OffloadEngine(model, top, px, prefetch=False, dense_arena=arena)
        want = JGenerator(stepper=jeng, max_seq_len=64).generate(prompt, max_new_tokens=6)
        with port_attention("naive"):
            got = Generator(stepper=eng, max_seq_len=64).generate(prompt, max_new_tokens=6)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        assert eng.stats() == jeng.stats() and eng.stats()["dense_misses"] > 0
    finally:
        for a in (arena, jarena, jx, px):
            a.shutdown()


# ---------------------------------------------------------------------------
# through MoE: the residency decision, against HF and the JAX facade
# ---------------------------------------------------------------------------

def _hf_tokens(hf, prompt, n, pad):
    return hf.generate(torch.tensor(prompt), max_new_tokens=n, do_sample=False,
                       eos_token_id=None, pad_token_id=pad).numpy()


def _facades(path, tmp_path, cfg):
    return (MoE(path, dict(cfg, offload_path=str(tmp_path / "port")), device="cpu"),
            JMoE(path, dict(cfg, offload_path=str(tmp_path / "jax"))))


@pytest.fixture(scope="module")
def tiny_opt_ckpt(tmp_path_factory):
    from transformers import OPTConfig, OPTForCausalLM

    cfg = OPTConfig(vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=4,
                    num_attention_heads=4, max_position_embeddings=64,
                    do_layer_norm_before=True, torch_dtype=torch.float32,
                    architectures=["OPTForCausalLM"], pad_token_id=1, bos_token_id=2,
                    eos_token_id=2)
    torch.manual_seed(11)
    hf = OPTForCausalLM(cfg).eval()
    path = tmp_path_factory.mktemp("torch_optpg") / "ckpt"
    hf.save_pretrained(path, safe_serialization=True)
    return str(path), hf


@pytest.mark.parametrize("cfg", [
    {"dense_paging": "on", "dense_slots": 2},
    {"device_memory_bytes": 120_000},  # "auto" pages: the stack exceeds the budget
], ids=["on", "auto"])
def test_opt_paged_matches_resident(tiny_opt_ckpt, tmp_path, cfg):
    path, hf = tiny_opt_ckpt
    prompt = np.array([[5, 9, 33, 7]])
    want = _hf_tokens(hf, prompt, 8, 1)
    eng, jeng = _facades(path, tmp_path, dict(cfg, expert_dtype="float32", max_seq_len=64))
    try:
        assert eng.dense_arena is not None and jeng.dense_arena is not None
        assert eng.dense_arena.num_slots == jeng.dense_arena.num_slots
        assert type(eng.engine).__name__ == "PagedDenseEngine"
        got = eng.generate(prompt, max_new_tokens=8, eos_token_id=None)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jeng.generate(prompt, max_new_tokens=8,
                                                         eos_token_id=None))
        assert eng.stats()["dense_misses"] > 0
    finally:
        eng.shutdown()
        jeng.shutdown()


def _moe_paging_case(path, hf, tmp_path, prompt, pad, cfg, L):
    want = _hf_tokens(hf, prompt, 6, pad)
    base = dict(expert_dtype="float32", max_seq_len=64, dense_paging="on", num_slots=5,
                speculative_decode=True)  # ignored under paging
    eng, jeng = _facades(path, tmp_path, dict(base, **cfg))
    try:
        assert eng.dense_arena is not None and eng.dense_arena.L == L
        assert eng.dense_arena.num_slots == jeng.dense_arena.num_slots
        assert eng.engine is not None and not eng.engine.speculative
        assert eng.batcher is None and eng.s2s_batcher is None
        got = eng.generate(prompt, max_new_tokens=6, eos_token_id=None)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jeng.generate(prompt, max_new_tokens=6,
                                                         eos_token_id=None))
        st = eng.stats()
        assert st["dense_misses"] >= 1 and "hit_rate" in st  # the expert arena lives too
        assert st["dense_misses"] + st["dense_hits"] >= L
        return eng
    finally:
        eng.shutdown()
        jeng.shutdown()


def test_mixtral_dense_paging_plus_expert_offload(tmp_path):
    from transformers import MixtralConfig, MixtralForCausalLM

    cfg = MixtralConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
                        num_local_experts=4, num_experts_per_tok=2,
                        max_position_embeddings=64, torch_dtype=torch.float32,
                        architectures=["MixtralForCausalLM"])
    torch.manual_seed(13)
    hf = MixtralForCausalLM(cfg).eval()
    hf.save_pretrained(tmp_path / "ckpt", safe_serialization=True)
    eng = _moe_paging_case(str(tmp_path / "ckpt"), hf, tmp_path, np.array([[5, 9, 33, 7, 21]]),
                           0, {"dense_slots": 2, "max_batch_size": 2}, 3)
    assert eng.dense_arena.num_slots == 2


def test_switch_dense_paging_plus_expert_offload(tmp_path):
    from transformers import (
        SwitchTransformersConfig,
        SwitchTransformersForConditionalGeneration,
    )

    cfg = SwitchTransformersConfig(
        vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=4, num_decoder_layers=4,
        num_heads=4, num_experts=4, expert_capacity=8, num_sparse_encoder_layers=2,
        num_sparse_decoder_layers=2, relative_attention_num_buckets=8,
        relative_attention_max_distance=16, dropout_rate=0.0, router_jitter_noise=0.0,
        decoder_start_token_id=0, eos_token_id=1, pad_token_id=0, torch_dtype=torch.float32,
        architectures=["SwitchTransformersForConditionalGeneration"])
    torch.manual_seed(17)
    hf = SwitchTransformersForConditionalGeneration(cfg).eval()
    hf.save_pretrained(tmp_path / "ckpt", safe_serialization=True)
    eng = _moe_paging_case(str(tmp_path / "ckpt"), hf, tmp_path, np.array([[5, 9, 33, 7, 1]]),
                           0, {}, 8)
    # the preludes' one-element stubs: Switch's T5 tables only
    assert list(eng.params["enc_blocks"][0]) == ["rel_bias"]
    assert list(eng.params["dec_blocks"][0]) == ["rel_bias"]


def test_nllb_dense_paging_plus_expert_offload(tmp_path):
    from transformers import NllbMoeConfig, NllbMoeForConditionalGeneration

    cfg = NllbMoeConfig(
        vocab_size=96, d_model=32, encoder_layers=6, decoder_layers=6,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, encoder_sparse_step=2, decoder_sparse_step=2, num_experts=4,
        max_position_embeddings=64, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, moe_token_dropout=0.0, router_jitter_noise=0.0,
        pad_token_id=1, bos_token_id=0, eos_token_id=2, decoder_start_token_id=2,
        torch_dtype=torch.float32, architectures=["NllbMoeForConditionalGeneration"])
    torch.manual_seed(19)
    hf = NllbMoeForConditionalGeneration(cfg).eval()
    hf.save_pretrained(tmp_path / "ckpt", safe_serialization=True)
    eng = _moe_paging_case(str(tmp_path / "ckpt"), hf, tmp_path, np.array([[5, 9, 33, 7, 2]]),
                           1, {"dense_slots": 8}, 12)
    # under pressure: each 3-member structure group gets 2 slots
    assert eng.dense_arena.num_slots < eng.dense_arena.L
