"""The port's Snowflake Arctic (``models/arctic.py``) against the JAX
package's ``moe_infinity_tpu/models/arctic.py`` on the CPU, at f32 unless a
case says otherwise: a tiny Arctic with rep 7 (7 query heads over 1 kv
head, head dim 8, as the published 56 over 8), the parallel residual
(``out = x + attn + residual_mlp + moe(post_norm(x))``), and a variant with
``moe_layer_frequency`` 2, whose dense layers take ``dense_layer``. Weights
come from the JAX model's init_random through the bridge (the query and key
projections x40 in both); expert stores are written from its expert tree at
f32, int8 and float8_e4m3fn by the JAX writer.

Held: the spec from a ``config.json``, also one that omits the optional
fields (the JAX ``from_hf``'s defaults); init_random's shapes; one layer's
outputs and the whole model's logits (the port's plain kernels against the
JAX kernels in interpret mode, 1e-5 per layer and 5e-5
for the whole model's logits at f32 (f32 sums in another order), 2e-2 at bf16); greedy tokens
through ``Generator``, the ``ContinuousBatcher`` and the ``OffloadEngine``
per layer (with the dense layers in its loop), speculative and in blocks,
eagerly and through the graph stand-in, with the JAX engine's executions
and counters (prefetch off, one worker); ``MoE`` from a seed-written
checkpoint at f32, int8 and fp8 against the JAX ``MoE``, the port's ingest
byte-equal to the JAX ingest."""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.arctic import ArcticModel as JArcticModel
from moe_infinity_tpu.models.arctic import ArcticSpec as JArcticSpec
from moe_infinity_tpu.runtime.generate import Generator as JGenerator
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch.models.arctic import ArcticModel, ArcticSpec
from moe_infinity_tpu_torch.runtime.generate import Generator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

from torch_decoder_family import (
    ONE,
    TWO,
    Family,
    StandIn,
    batcher_against_jax,
    facade_tokens_equal,
    facades,
    jax_pallas_interpreted,
    random_tensors,
    run_engines,
    same_counters,
    stores_byte_equal,
    write_checkpoint,
)
from torch_port_helpers import jax_kernels_interpreted, np32, one_intra_op_thread, to_port

E = 8
TINY = dict(
    vocab_size=96, hidden_size=56, intermediate_size=32, num_layers=2, num_heads=7,
    num_kv_heads=1, head_dim=8, num_experts=E, top_k=2, moe_layer_frequency=1,
    parallel_attn_mlp_res=True, rms_eps=1e-5, rope_theta=1e4,
)
# every other layer dense, and the MoE branch reading the post-attention x
DENSE = dict(TINY, num_layers=4, moe_layer_frequency=2, parallel_attn_mlp_res=False)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _family(spec, seed, root):
    jmodel = JArcticModel(JArcticSpec(**spec), compute_dtype=jnp.float32)
    model = ArcticModel(ArcticSpec(**spec), compute_dtype=torch.float32, device="cpu")
    return Family("arctic", jmodel, model, seed, root)


@pytest.fixture(scope="module", params=["parallel", "dense"])
def arctic(request, tmp_path_factory):
    spec = TINY if request.param == "parallel" else DENSE
    return _family(spec, 5, tmp_path_factory.mktemp(f"arctic_{request.param}"))


# ---- the spec and the parameters -------------------------------------------------

# Snowflake/snowflake-arctic-instruct's config.json (the fields the model
# reads), cut to 1 layer
ARCTIC_CONFIG = {
    "architectures": ["ArcticForCausalLM"], "model_type": "arctic",
    "vocab_size": 32000, "hidden_size": 7168, "intermediate_size": 4864,
    "num_hidden_layers": 1, "num_attention_heads": 56, "num_key_value_heads": 8,
    "num_local_experts": 128, "num_experts_per_tok": 2, "moe_layer_frequency": 1,
    "parallel_attn_mlp_res": True, "rms_norm_eps": 1e-5, "rope_theta": 10000,
    "max_position_embeddings": 4096, "bos_token_id": 1, "eos_token_id": 2,
    "torch_dtype": "bfloat16",
}
OPTIONAL = ("moe_layer_frequency", "parallel_attn_mlp_res", "rope_theta")


@pytest.mark.parametrize("fields", ["published", "minimal"])
def test_spec_from_config_json_matches_jax(tmp_path, fields):
    cfg = dict(ARCTIC_CONFIG)
    if fields == "minimal":  # the JAX from_hf's getattr defaults fill them in
        for k in OPTIONAL:
            cfg.pop(k)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    got = ArcticSpec.from_hf(read_hf_config(str(tmp_path)))
    want = JArcticSpec.from_hf(SimpleNamespace(**cfg))  # as the JAX facade reads it
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == 128 and got.num_heads // got.num_kv_heads == 7
    if fields == "minimal":
        assert (got.moe_layer_frequency, got.parallel_attn_mlp_res, got.rope_theta) == \
            (1, False, 1e6)


@pytest.mark.parametrize("spec", [TINY, DENSE], ids=["parallel", "dense"])
@pytest.mark.parametrize("expert_dtype", ["bf16", "int8", "fp8"])
def test_init_random_shapes_match_jax(spec, expert_dtype):
    model = ArcticModel(ArcticSpec(**spec), compute_dtype=torch.bfloat16, device="cpu")
    params, tree = model.init_random(torch.Generator().manual_seed(0), expert_dtype=expert_dtype)
    jparams, jtree = JArcticModel(JArcticSpec(**spec), compute_dtype=jnp.bfloat16).init_random(
        jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(got) == {jax.tree_util.keystr(k) for k, _ in flat}
    for k, v in flat:
        t = got[jax.tree_util.keystr(k)]
        assert tuple(t.shape) == v.shape and str(t.dtype).split(".")[-1] == str(v.dtype), k
    assert len(tree["layers"]) == len(jtree["layers"])
    for w, jw in zip(tree["layers"], jtree["layers"]):
        assert {k for k in w if not k.endswith("_scale")} == set(jw)
        for k, v in jw.items():
            assert tuple(w[k].shape) == v.shape


def test_layers_match_jax(arctic):
    """Each layer of the model: ``pre_moe`` and ``apply_moe`` on MoE layers
    (rep 7 attention, the residual MLP, routing renormalised over the top
    2), ``dense_layer`` on the others."""
    from moe_infinity_tpu.models.layers import KVCache as JKV
    from moe_infinity_tpu_torch.models.layers import KVCache

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 56)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    for li in range(arctic.model.spec.num_layers):
        jpl, pl = arctic.jparams["layers"][li], arctic.params["layers"][li]
        jkv = JKV.empty(2, 16, 1, 8, jnp.float32)
        kv = KVCache.empty(2, 16, 1, 8, torch.float32, "cpu")
        mli = arctic.model.moe_layer_index(li)
        assert mli == arctic.jmodel.moe_layer_index(li)
        if mli is None:
            want, _ = arctic.jmodel.dense_layer(jpl, jnp.asarray(x), jkv, jnp.asarray(pos), 0)
            got, _ = arctic.model.dense_layer(pl, torch.tensor(x), kv, torch.tensor(pos), 0)
            np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-5, atol=1e-5)
            continue
        jx, jh, jcw, jids, _ = arctic.jmodel.pre_moe(jpl, jnp.asarray(x), jkv,
                                                     jnp.asarray(pos), 0)
        tx, th, tcw, tids, _ = arctic.model.pre_moe(pl, torch.tensor(x), kv,
                                                    torch.tensor(pos), 0)
        for a, b in ((tx, jx), (th, jh), (tcw, jcw)):
            np.testing.assert_allclose(np32(a), np.asarray(b), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(np32(tcw).sum(-1), 1.0, rtol=1e-6)  # renormalised
        w, sm, b = JProvider.for_layer(arctic.jtree, mli)
        want = arctic.jmodel.apply_moe(jpl, jx, jh, jcw, jids, w, sm, b, "ragged")
        tw, tsm, tb = ResidentProvider.for_layer(arctic.tree, mli)
        got = arctic.model.apply_moe(pl, tx, th, tcw, tids, tw, tsm, tb, "ragged")
        np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["ragged", "pallas"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_logits_match_jax_kernels(arctic, monkeypatch, impl, dtype):
    """Prefill of 6 tokens then 3 decode steps, the port's plain kernels
    against the JAX kernels in interpret mode (K2 at rep 7, K1, K3)."""
    jdt, tdt, tol = ((jnp.float32, torch.float32, 5e-5) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 2e-2))
    spec = dataclasses.asdict(arctic.model.spec)
    jmodel = JArcticModel(JArcticSpec(**spec), compute_dtype=jdt)
    model = ArcticModel(ArcticSpec(**spec), compute_dtype=tdt, device="cpu")
    jp = jax.tree.map(lambda a: a.astype(jdt) if a.ndim >= 2 else a, arctic.jparams)
    jtree = jax.tree.map(lambda a: a.astype(jdt) if a.ndim == 3 else a, arctic.jtree)
    params, tree = to_port(jp), to_port(jtree)
    tokens = np.array([[3, 17, 5, 60, 2, 41]], np.int32)
    with jax_kernels_interpreted(monkeypatch):
        jkv, kv = jmodel.init_cache(1, 16), model.init_cache(1, 16)
        pos = np.arange(6, dtype=np.int32)[None]
        want, jkv, _ = jmodel.forward(jp, jtree, jnp.asarray(tokens), jnp.asarray(pos), jkv, 0,
                                      for_layer=JProvider.for_layer, impl=impl)
        got, kv, _ = model.forward(params, tree, torch.tensor(tokens), torch.tensor(pos), kv, 0,
                                   for_layer=ResidentProvider.for_layer, impl=impl)
        np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=tol, atol=tol)
        for step in range(6, 9):
            tok = np.array([[int(np.asarray(want)[0, -1].argmax())]], np.int32)
            p = np.array([[step]], np.int32)
            want, jkv, _ = jmodel.forward(jp, jtree, jnp.asarray(tok), jnp.asarray(p), jkv, step,
                                          for_layer=JProvider.for_layer, impl=impl)
            got, kv, _ = model.forward(params, tree, torch.tensor(tok), torch.tensor(p), kv,
                                       step, for_layer=ResidentProvider.for_layer, impl=impl)
            np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=tol,
                                       atol=tol)


# ---- generation -------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ragged", "gather", "pallas"])
@pytest.mark.parametrize("quant", ["float32", "float8_e4m3fn"])
def test_generator_tokens_equal_jax(arctic, monkeypatch, impl, quant):
    jax_pallas_interpreted(monkeypatch)
    prompt = np.array([[7, 31, 4, 90, 12], [3, 3, 50, 8, 1]])
    got = arctic.resident(quant, impl).generate(prompt, max_new_tokens=8, eos_token_id=None)
    want = arctic.jax_resident(quant, impl).generate(prompt, max_new_tokens=8,
                                                     eos_token_id=None)
    np.testing.assert_array_equal(got.sequences, want.sequences)


@pytest.mark.parametrize("chunk", [1, 3])
def test_batcher_tokens_equal_jax_generator(arctic, chunk):
    batcher_against_jax(arctic, chunk)


def test_left_padded_batch_equals_jax(arctic):
    gen = Generator(arctic.model, arctic.params, arctic.tree, ResidentProvider.for_layer,
                    max_seq_len=64)
    jgen = JGenerator(arctic.jmodel, arctic.jparams, arctic.jtree, JProvider.for_layer,
                      max_seq_len=64)
    prompt = np.array([[0, 0, 7, 31, 4], [3, 3, 50, 8, 1]])
    kw = dict(max_new_tokens=6, eos_token_id=None, pad_token_id=0)
    np.testing.assert_array_equal(gen.generate(prompt, **kw).sequences,
                                  jgen.generate(prompt, **kw).sequences)


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
