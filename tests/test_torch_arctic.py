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
fields (the JAX ``from_hf``'s defaults); init_random's shapes; each layer's
outputs (1e-5); greedy tokens through ``Generator`` and the
``ContinuousBatcher``. The whole model's logits through the kernels are in
tests/test_torch_arctic_kernels.py, the ``OffloadEngine`` and ``MoE`` from a
checkpoint in tests/test_torch_arctic_offload.py, so that the three files
run on three workers."""

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
    Family,
    batcher_against_jax,
    jax_pallas_interpreted,
)
from torch_port_helpers import np32, one_intra_op_thread

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
