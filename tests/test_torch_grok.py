"""The port's Grok-1 (``models/grok.py``) against the JAX package's
``moe_infinity_tpu/models/grok.py`` on the CPU, at f32 unless a case says
otherwise: a tiny Grok with rep 6 (6 query heads over 1 kv head, head dim
8, as the published 48 over 8), the softcap and score scale of the
published config, GELU-gated experts and the embedding and output
multipliers. Weights come from the JAX model's init_random through the
bridge (the query and key projections x40 in both, so that attention is
sharp enough for the softcap to act); expert stores are written from its
expert tree at f32, int8 and float8_e4m3fn by the JAX writer.

Held: the spec from a ``config.json``; init_random's shapes; one layer's
outputs and the whole model's logits (the port's plain kernels against the
JAX kernels in interpret mode, 1e-5 per layer and 5e-5
for the whole model's logits at f32 (f32 sums in another order); bf16 to 2e-2, the JAX suite's
tolerance); greedy tokens equal through ``Generator`` (ragged, gather,
pallas) and the ``ContinuousBatcher`` (mirroring
tests/test_continuous.py::test_continuous_grok_arctic). The
``OffloadEngine`` and ``MoE`` cases are in tests/test_torch_grok_offload.py,
which shares this file's spec, family fixture and config."""

import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.grok import GrokModel as JGrokModel
from moe_infinity_tpu.models.grok import GrokSpec as JGrokSpec
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch.models.grok import GrokModel, GrokSpec
from moe_infinity_tpu_torch.runtime.generate import Generator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

from torch_decoder_family import (
    Family,
    batcher_against_jax,
    jax_pallas_interpreted,
    random_tensors,
)
from torch_port_helpers import jax_kernels_interpreted, np32, one_intra_op_thread, to_port

L, E = 2, 8
TINY = dict(
    vocab_size=96, hidden_size=48, intermediate_size=32, num_layers=L, num_heads=6,
    num_kv_heads=1, head_dim=8, num_experts=E, top_k=2, rms_eps=1e-5,
    attn_output_multiplier=0.08838834764831845, max_attn_value=30.0,
    embedding_multiplier_scale=78.38367176906169, output_multiplier_scale=0.5773502691896257,
)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.fixture(scope="module")
def grok(tmp_path_factory):
    jmodel = JGrokModel(JGrokSpec(**TINY), compute_dtype=jnp.float32)
    model = GrokModel(GrokSpec(**TINY), compute_dtype=torch.float32, device="cpu")
    return Family("grok", jmodel, model, 7, tmp_path_factory.mktemp("grok"))


# ---- the spec and the parameters -------------------------------------------------

# hpcai-tech/grok-1's config.json (the fields the model reads), cut to 1 layer
GROK1_CONFIG = {
    "architectures": ["Grok1ModelForCausalLM"], "model_type": "grok-1",
    "vocab_size": 131072, "hidden_size": 6144, "intermediate_size": 32768,
    "num_hidden_layers": 1, "num_attention_heads": 48, "num_key_value_heads": 8,
    "num_experts": 8, "num_experts_per_tok": 2, "rms_norm_eps": 1e-5,
    "attn_output_multiplier": 0.08838834764831845, "max_attn_value": 30.0,
    "embedding_multiplier_scale": 78.38367176906169,
    "output_multiplier_scale": 0.5773502691896257, "max_position_embeddings": 8192,
    "bos_token_id": 1, "eos_token_id": 2, "torch_dtype": "bfloat16",
}


def test_spec_from_config_json_matches_jax(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(GROK1_CONFIG))
    got = GrokSpec.from_hf(read_hf_config(str(tmp_path)))
    want = JGrokSpec.from_hf(SimpleNamespace(**GROK1_CONFIG))  # as the JAX facade reads it
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == 128 and got.num_heads // got.num_kv_heads == 6


@pytest.mark.parametrize("expert_dtype", ["bf16", "int8", "int4", "fp8"])
def test_init_random_shapes_match_jax(expert_dtype):
    model = GrokModel(GrokSpec(**TINY), compute_dtype=torch.bfloat16, device="cpu")
    params, tree = model.init_random(torch.Generator().manual_seed(0), expert_dtype=expert_dtype)
    jparams, jtree = JGrokModel(JGrokSpec(**TINY), compute_dtype=jnp.bfloat16).init_random(
        jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_flatten_with_path(params)[0]}
    assert set(got) == {jax.tree_util.keystr(k) for k, _ in flat}
    for k, v in flat:
        t = got[jax.tree_util.keystr(k)]
        assert tuple(t.shape) == v.shape and str(t.dtype).split(".")[-1] == str(v.dtype), k
    assert "lm_head" not in params  # the head reads the embedding, as JAX's
    for w, jw in zip(tree["layers"], jtree["layers"]):
        base = {k.rstrip("4"): v for k, v in w.items() if not k.endswith("_scale")}
        assert set(base) == set(jw)
        for k, v in jw.items():
            packed = expert_dtype == "int4"
            want = v.shape[:-1] + ((v.shape[-1] // 2,) if packed else (v.shape[-1],))
            assert tuple(base[k].shape) == want
    if expert_dtype == "fp8":
        w = tree["layers"][0]
        assert w["gate"].dtype == torch.float8_e4m3fn and w["gate_scale"].shape == (E, 32)
        assert torch.isfinite(w["gate"].float()).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embed_scale_in_the_compute_dtype(grok, dtype):
    """The embedding times ``embedding_multiplier_scale``: JAX multiplies by
    a Python float, which takes the array's dtype, so bf16(x * bf16(s))."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jmodel = JGrokModel(JGrokSpec(**TINY), compute_dtype=jdt)
    model = GrokModel(GrokSpec(**TINY), compute_dtype=tdt, device="cpu")
    tok = np.arange(40, dtype=np.int32)[None]
    want = jmodel.embed(grok.jparams, jnp.asarray(tok))
    got = model.embed(grok.params, torch.tensor(tok))
    assert got.dtype == tdt
    np.testing.assert_array_equal(np32(got), np.asarray(want, np.float32))


def test_layer_matches_jax(grok):
    """One layer's attention (rep 6, softcap 30, scale 0.0884), norms,
    routing (top-2 of the softmax, not renormalised) and GELU experts."""
    from moe_infinity_tpu.models.layers import KVCache as JKV
    from moe_infinity_tpu_torch.models.layers import KVCache

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    jpl, pl = grok.jparams["layers"][0], grok.params["layers"][0]
    jkv = JKV.empty(2, 16, 1, 8, jnp.float32)
    kv = KVCache.empty(2, 16, 1, 8, torch.float32, "cpu")
    jx, jh, jcw, jids, _ = grok.jmodel.pre_moe(jpl, jnp.asarray(x), jkv, jnp.asarray(pos), 0)
    tx, th, tcw, tids, _ = grok.model.pre_moe(pl, torch.tensor(x), kv, torch.tensor(pos), 0)
    for a, b in ((tx, jx), (th, jh), (tcw, jcw)):
        np.testing.assert_allclose(np32(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert not np.allclose(np32(tcw).sum(-1), 1.0)  # no renormalisation
    w, sm, b = JProvider.for_layer(grok.jtree, 0)
    want = grok.jmodel.apply_moe(jpl, jx, jh, jcw, jids, w, sm, b, "ragged")
    tw, tsm, tb = ResidentProvider.for_layer(grok.tree, 0)
    got = grok.model.apply_moe(pl, tx, th, tcw, tids, tw, tsm, tb, "ragged")
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["ragged", "pallas"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_logits_match_jax_kernels(grok, monkeypatch, impl, dtype):
    """Prefill of 6 tokens then 3 decode steps: the port's plain kernels
    against the JAX kernels in interpret mode (K2 with softcap at rep 6, K1
    for the steps, K3 for the pallas impl)."""
    jdt, tdt, tol = ((jnp.float32, torch.float32, 5e-5) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 2e-2))
    jmodel = JGrokModel(JGrokSpec(**TINY), compute_dtype=jdt)
    model = GrokModel(GrokSpec(**TINY), compute_dtype=tdt, device="cpu")
    jp = jax.tree.map(lambda a: a.astype(jdt) if a.ndim >= 2 else a, grok.jparams)
    params = to_port(jp)
    tree = grok.tree if dtype == "f32" else to_port(
        jax.tree.map(lambda a: a.astype(jdt) if a.ndim == 3 else a, grok.jtree))
    jtree = grok.jtree if dtype == "f32" else jax.tree.map(
        lambda a: a.astype(jdt) if a.ndim == 3 else a, grok.jtree)
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
def test_generator_tokens_equal_jax(grok, monkeypatch, impl, quant):
    jax_pallas_interpreted(monkeypatch)
    prompt = np.array([[7, 31, 4, 90, 12], [3, 3, 50, 8, 1]])
    got = grok.resident(quant, impl).generate(prompt, max_new_tokens=8, eos_token_id=None)
    want = grok.jax_resident(quant, impl).generate(prompt, max_new_tokens=8, eos_token_id=None)
    np.testing.assert_array_equal(got.sequences, want.sequences)


@pytest.mark.parametrize("chunk", [1, 3])
def test_batcher_tokens_equal_jax_generator(grok, chunk):
    batcher_against_jax(grok, chunk)


def test_left_padded_batch_equals_jax(grok):
    """Two prompts of different lengths, left-padded (``pad_offsets``)."""
    gen = Generator(grok.model, grok.params, grok.tree, ResidentProvider.for_layer,
                    max_seq_len=64)
    from moe_infinity_tpu.runtime.generate import Generator as JGenerator

    jgen = JGenerator(grok.jmodel, grok.jparams, grok.jtree, JProvider.for_layer,
                      max_seq_len=64)
    prompt = np.array([[0, 0, 7, 31, 4], [3, 3, 50, 8, 1]])
    kw = dict(max_new_tokens=6, eos_token_id=None, pad_token_id=0)
    np.testing.assert_array_equal(gen.generate(prompt, **kw).sequences,
                                  jgen.generate(prompt, **kw).sequences)


# ---- a seed-written checkpoint (test_torch_grok_offload.py, test_torch_pod_engine.py) ----

def _checkpoint_tensors(cfg, seed):
    D, F, E_ = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_experts"]
    hd = D // cfg["num_attention_heads"]
    kvd = cfg["num_key_value_heads"] * hd
    shapes = {"model.embed_tokens.weight": (cfg["vocab_size"], D), "model.norm.scale": (D,)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for n in ("pre_attn_norm", "post_attn_norm", "pre_moe_norm", "post_moe_norm"):
            shapes[p + n + ".scale"] = (D,)
        shapes.update({p + "attn.q_proj.weight": (D, D), p + "attn.k_proj.weight": (kvd, D),
                       p + "attn.v_proj.weight": (kvd, D), p + "attn.o_proj.weight": (D, D),
                       p + "moe_block.gate.weight": (E_, D)})
        for e in range(E_):
            q = f"{p}moe_block.experts.{e}."
            shapes.update({q + "linear.weight": (F, D), q + "linear_v.weight": (F, D),
                           q + "linear_1.weight": (D, F)})
    return random_tensors(shapes, seed)


TINY_CONFIG = dict(GROK1_CONFIG, vocab_size=128, hidden_size=48, intermediate_size=32,
                   num_hidden_layers=2, num_attention_heads=6, num_key_value_heads=1,
                   torch_dtype="float32")
