"""The port's NLLB-MoE slice against the JAX package on a tiny model
(d_model 256, 2 heads so head_dim 128, FFN 512, 8 experts, 2+2 blocks,
sparse_step 2). The same weights, made once with the JAX model's
init_random, feed both through the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
from moe_infinity_tpu.runtime.generate import Seq2SeqGenerator as JGenerator
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

from torch_port_helpers import (
    TINY_NLLB,
    int4_expert_tree,
    jax_kernels_interpreted,
    np32,
    port_attention,
    to_port,
    one_intra_op_thread,
)

# right-padded batch (NLLB pads with token 1), and an unpadded one
PADDED_IDS = np.array([[5, 31, 8, 77, 40, 2], [9, 3, 44, 2, 1, 1]])
PADDED_MASK = (PADDED_IDS != 1).astype(np.float32)
FULL_IDS = np.array([[5, 31, 8, 77, 2], [9, 3, 44, 60, 2]])


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.fixture(scope="module")
def f32_models():
    jmodel = JNllbModel(JNllbSpec(**TINY_NLLB), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(7), expert_dtype=jnp.float32)
    model = NllbModel(NllbSpec(**TINY_NLLB), compute_dtype=torch.float32, device="cpu")
    return jmodel, jparams, jtree, model, to_port(jparams), to_port(jtree)


def _jax_first_step(jmodel, jparams, jtree, ids, mask, impl):
    for_layer = JProvider.for_layer
    m = jnp.asarray(mask)
    enc = jmodel.encode(jparams, jtree, jnp.asarray(ids, jnp.int32), m, for_layer, impl)
    cross = jmodel.cross_kv(jparams, enc)
    kvs = jmodel.init_cache(ids.shape[0], 16)
    start = jnp.full((ids.shape[0], 1), 2, jnp.int32)
    logits, _, _ = jmodel.decode_step(
        jparams, jtree, start, jnp.zeros_like(start), kvs, jnp.int32(0), m, cross,
        for_layer, impl,
    )
    return np.asarray(enc), np.asarray(logits)


def _port_first_step(model, params, tree, ids, mask, impl):
    for_layer = ResidentProvider.for_layer
    m = torch.tensor(mask)
    enc = model.encode(params, tree, torch.tensor(ids, dtype=torch.int32), m, for_layer, impl)
    cross = model.cross_kv(params, enc)
    kvs = model.init_cache(ids.shape[0], 16)
    start = torch.full((ids.shape[0], 1), 2, dtype=torch.int32)
    logits, _, _ = model.decode_step(params, tree, start, torch.zeros_like(start), kvs, 0,
                                     m, cross, for_layer, impl)
    return np32(enc), np32(logits)


@pytest.mark.parametrize("padded", [False, True])
def test_encode_and_first_step_f32(f32_models, padded):
    jmodel, jparams, jtree, model, params, tree = f32_models
    ids = PADDED_IDS if padded else FULL_IDS
    mask = PADDED_MASK if padded else np.ones(ids.shape, np.float32)
    jenc, jlogits = _jax_first_step(jmodel, jparams, jtree, ids, mask, "ragged")
    with port_attention("naive"):
        enc, logits = _port_first_step(model, params, tree, ids, mask, "ragged")
    np.testing.assert_allclose(enc, jenc, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("padded", [False, True])
def test_generate_greedy_tokens_equal_jax(f32_models, padded):
    jmodel, jparams, jtree, model, params, tree = f32_models
    ids = PADDED_IDS if padded else FULL_IDS
    mask = PADDED_MASK if padded else None
    want = JGenerator(jmodel, jparams, jtree, JProvider.for_layer).generate(
        ids, max_new_tokens=8, attention_mask=mask, eos_token_id=2
    )
    with port_attention("naive"):
        got = Seq2SeqGenerator(model, params, tree, ResidentProvider.for_layer).generate(
            ids, max_new_tokens=8, attention_mask=mask, eos_token_id=2
        )
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.num_generated, want.num_generated)


def test_generate_without_eos_runs_all_steps(f32_models):
    jmodel, jparams, jtree, model, params, tree = f32_models
    want = JGenerator(jmodel, jparams, jtree, JProvider.for_layer).generate(
        PADDED_IDS, max_new_tokens=6, attention_mask=PADDED_MASK, eos_token_id=None
    )
    with port_attention("naive"):
        got = Seq2SeqGenerator(model, params, tree, ResidentProvider.for_layer).generate(
            PADDED_IDS, max_new_tokens=6, attention_mask=PADDED_MASK, eos_token_id=None
        )
    assert got.sequences.shape == (2, 7)
    assert got.stats["decode_steps"] == 6
    np.testing.assert_array_equal(got.sequences, want.sequences)


def test_kernel_path_int4_matches_jax_kernels(monkeypatch):
    """Port: plain K1/K2/K3 (the CPU side of its kernels) with packed int4
    experts. JAX: its Pallas kernels in interpret mode. Tolerance 3e-2, as
    the JAX suite uses for the packed gmm FFN: both round the expert inputs
    to bf16, and a last-bit difference upstream can flip one such rounding,
    moving an output by a bf16 ulp."""
    spec = TINY_NLLB
    jmodel = JNllbModel(JNllbSpec(**spec), compute_dtype=jnp.float32)
    jparams, _ = jmodel.init_random(jax.random.PRNGKey(3), with_experts=False)
    tree_np = int4_expert_tree(np.random.default_rng(5), spec, n_layers=2)
    jtree = jax.tree.map(jnp.asarray, tree_np)
    model = NllbModel(NllbSpec(**spec), compute_dtype=torch.float32, device="cpu")
    params, tree = to_port(jparams), to_port(tree_np)
    with jax_kernels_interpreted(monkeypatch):
        jenc, jlogits = _jax_first_step(jmodel, jparams, jtree, PADDED_IDS,
                                        PADDED_MASK, "pallas")
    enc, logits = _port_first_step(model, params, tree, PADDED_IDS, PADDED_MASK, "pallas")
    np.testing.assert_allclose(enc, jenc, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(logits, jlogits, rtol=3e-2, atol=3e-2)


def test_init_random_structure_matches_jax():
    spec = TINY_NLLB
    jmodel = JNllbModel(JNllbSpec(**spec), compute_dtype=jnp.float32)
    jparams, _ = jmodel.init_random(jax.random.PRNGKey(0), with_experts=False)
    model = NllbModel(NllbSpec(**spec), compute_dtype=torch.bfloat16, device="cpu")
    g = torch.Generator().manual_seed(0)
    params, tree = model.init_random(g)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    assert sorted(flat) == sorted(jax.tree_util.keystr(p) for p, _ in jflat)
    for p, v in jflat:
        got = flat[jax.tree_util.keystr(p)]
        assert tuple(got.shape) == v.shape
        assert got.dtype == (torch.bfloat16 if v.ndim >= 2 and "router" not in
                             jax.tree_util.keystr(p) else torch.float32)
    E, D, F = spec["num_experts"], spec["d_model"], spec["encoder_ffn_dim"]
    assert len(tree["layers"]) == 2
    for layer in tree["layers"]:
        assert tuple(layer["gate4"].shape) == (E, D, F // 2)
        assert tuple(layer["down4"].shape) == (E, F, D // 2)
        assert layer["gate4"].dtype == torch.int8
        assert tuple(layer["gate_scale"].shape) == (E, F)
        assert tuple(layer["down_scale"].shape) == (E, D)
        w = layer["gate_scale"]
        assert 0.003 <= float(w.min()) and float(w.max()) <= 0.0056


def test_generate_rejects_sampling(f32_models):
    """Sampling keywords are served (runtime/sampling.py): a greedy run with
    a repetition penalty and logprobs equals the JAX generator's (tokens,
    top tokens, logprobs within 1e-5), and a sampled run is fixed by its
    seed."""
    jmodel, jparams, jtree, model, params, tree = f32_models
    gen = Seq2SeqGenerator(model, params, tree, ResidentProvider.for_layer)
    kw = dict(max_new_tokens=4, eos_token_id=None, repetition_penalty=1.4, logprobs=2)
    want = JGenerator(jmodel, jparams, jtree, JProvider.for_layer).generate(FULL_IDS, **kw)
    with port_attention("naive"):
        got = gen.generate(FULL_IDS, **kw)
        np.testing.assert_array_equal(got.sequences, want.sequences)
        np.testing.assert_array_equal(got.top_tokens, want.top_tokens)
        np.testing.assert_allclose(got.token_logprobs, want.token_logprobs, atol=1e-5)
        sampled = dict(max_new_tokens=4, eos_token_id=None, temperature=0.7, seed=3)
        np.testing.assert_array_equal(gen.generate(FULL_IDS, **sampled).sequences,
                                      gen.generate(FULL_IDS, **sampled).sequences)


def test_cuda_entry_point_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        NllbModel(NllbSpec(**TINY_NLLB), compute_dtype=torch.float32)
