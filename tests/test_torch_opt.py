"""The port's OPT (``models/opt.py``) and its facade plan on the CPU against
the JAX package and HF, mirroring tests/test_opt.py:

* ``OPTModel.forward`` against the JAX model's on the same params (from
  the JAX ``load_params`` through ``bridge``): the prefill's and a decode
  step's logits at f32 (rtol = atol = 1e-4) and bf16 (2e-2, the JAX
  suite's bf16 tolerance), both attention paths: the einsum oracle and
  the plain versions of K1 and K2; at head dim 8 and at OPT-2.7B's 80
  (hidden 160 over 2 heads), as the facade's greedy tokens below;
* ``load_params`` equal to the JAX model's, the ingest byte-equal to the
  JAX ingest (no expert records), ``read_hf_config`` giving
  ``AutoConfig``'s spec for OPT-66B's published and a minimal
  ``config.json``;
* the facade's greedy tokens against the JAX facade's and HF ``generate``,
  batch 1 and a batched prefill (rows of one length, as in JAX), resident
  through ``ResidentStepper``; rows left-padded with the pad id against the
  JAX facade;
* the refusals: the post-norm variant, a projected embedding, and on the
  card a head dim above 256 (OPT-2.7B's 80 is built).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import AutoConfig, OPTConfig, OPTForCausalLM

from moe_infinity_tpu.entrypoints.api import MoE as JMoE
from moe_infinity_tpu.models.opt import OPTModel as JOPTModel
from moe_infinity_tpu.models.opt import OPTSpec as JOPTSpec
from moe_infinity_tpu.store.blob import DenseArchive as JDense
from moe_infinity_tpu.store.ingest import ingest_checkpoint as j_ingest
from moe_infinity_tpu_torch.entrypoints.api import MoE
from moe_infinity_tpu_torch.models.layers import KVCache
from moe_infinity_tpu_torch.models.opt import OPTModel, OPTSpec
from moe_infinity_tpu_torch.store.blob import DenseArchive
from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
from moe_infinity_tpu_torch.utils import hf_config as phc

from torch_port_helpers import np32, one_intra_op_thread, port_attention, to_port  # noqa: F401

TINY = dict(vocab_size=128, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=64, do_layer_norm_before=True,
            torch_dtype=torch.float32, architectures=["OPTForCausalLM"],
            pad_token_id=1, bos_token_id=2, eos_token_id=2)
# facebook/opt-66b's config.json, the fields the port reads
OPT_66B = {"architectures": ["OPTForCausalLM"], "model_type": "opt",
           "activation_function": "relu", "do_layer_norm_before": True, "ffn_dim": 36864,
           "hidden_size": 9216, "max_position_embeddings": 2048, "num_attention_heads": 72,
           "num_hidden_layers": 64, "vocab_size": 50272, "word_embed_proj_dim": 9216,
           "torch_dtype": "float16", "pad_token_id": 1, "bos_token_id": 2, "eos_token_id": 2}


# the tiny geometry (head dim 8), and one at OPT-2.7B's head dim 80 (hidden
# 160 over 2 heads), which K1 and K2 run on their padded instance on the card
GEOMETRIES = {"dh8": TINY, "dh80": dict(TINY, hidden_size=160, ffn_dim=320,
                                        num_attention_heads=2)}


@pytest.fixture(scope="module")
def opt_ckpts(tmp_path_factory):
    """geometry -> (checkpoint path, HF model), each made once per module."""
    made = {}

    def get(geometry):
        if geometry not in made:
            torch.manual_seed(9)
            hf = OPTForCausalLM(OPTConfig(**GEOMETRIES[geometry])).eval()
            path = tmp_path_factory.mktemp(f"torch_opt_{geometry}") / "ckpt"
            hf.save_pretrained(path, safe_serialization=True)
            made[geometry] = (str(path), hf)
        return made[geometry]

    return get


@pytest.fixture(scope="module")
def opt_stores(opt_ckpts, tmp_path_factory):
    """geometry -> (root, JAX ingest meta, port ingest meta), made once."""
    made = {}

    def get(geometry):
        if geometry not in made:
            path, _ = opt_ckpts(geometry)
            root = tmp_path_factory.mktemp(f"torch_opt_stores_{geometry}")
            j_meta = j_ingest(path, str(root / "jax"), AutoConfig.from_pretrained(path),
                              expert_dtype="float32")
            p_meta = ingest_checkpoint(path, str(root / "port"), phc.read_hf_config(path),
                                       expert_dtype="float32")
            made[geometry] = (root, j_meta, p_meta)
        return made[geometry]

    return get


@pytest.fixture(scope="module")
def tiny_opt(opt_ckpts):
    return opt_ckpts("dh8")


@pytest.fixture(scope="module")
def stores(opt_stores):
    return opt_stores("dh8")


def _models(path, dtype):
    jspec = JOPTSpec.from_hf(AutoConfig.from_pretrained(path))
    pspec = OPTSpec.from_hf(phc.read_hf_config(path))
    assert dataclasses.asdict(pspec) == dataclasses.asdict(jspec)
    return (JOPTModel(jspec, compute_dtype=getattr(jnp, dtype)),
            OPTModel(pspec, compute_dtype=getattr(torch, dtype), device="cpu"))


def test_ingest_byte_equal_to_jax(stores):
    import filecmp
    import os

    root, j_meta, p_meta = stores
    assert p_meta == j_meta
    a, b = root / "jax", root / "port"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for f in names:
        assert filecmp.cmp(a / f, b / f, shallow=False), f
    assert j_meta["num_experts"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_params_equal_jax(tiny_opt, stores, dtype):
    path, _ = tiny_opt
    jmodel, model = _models(path, dtype)
    want = to_port(jmodel.load_params(JDense(str(stores[0] / "jax"))))
    got = model.load_params(DenseArchive(str(stores[0] / "port")))

    def flat(t, prefix=""):
        if isinstance(t, dict):
            return {k2: v for k, s in t.items() for k2, v in flat(s, f"{prefix}{k}.").items()}
        if isinstance(t, list):
            return {k2: v for i, s in enumerate(t) for k2, v in flat(s, f"{prefix}{i}.").items()}
        return {prefix: t}

    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("attn", ["naive", "flash"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_forward_logits_equal_jax(opt_ckpts, opt_stores, dtype, tol, attn, geometry):
    from moe_infinity_tpu.models.layers import KVCache as JKV

    path, _ = opt_ckpts(geometry)
    stores = opt_stores(geometry)
    jmodel, model = _models(path, dtype)
    assert model.spec.head_dim == {"dh8": 8, "dh80": 80}[geometry]
    jparams = jmodel.load_params(JDense(str(stores[0] / "jax")))
    params = to_port(jparams)
    tokens = np.array([[5, 9, 33, 7, 100], [3, 14, 15, 92, 6]], dtype=np.int32)
    B, T = tokens.shape
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jkv = jmodel.init_cache(B, 16)
    kv = model.init_cache(B, 16)
    assert isinstance(kv[0], KVCache) and isinstance(jkv[0], JKV)
    jl, jkv, _ = jmodel.forward(jparams, None, jnp.asarray(tokens), jnp.asarray(pos), jkv,
                                jnp.int32(0))
    with port_attention(attn):
        pl, kv, trace = model.forward(params, None, torch.as_tensor(tokens),
                                      torch.as_tensor(pos), kv, 0)
    assert trace is None
    np.testing.assert_allclose(np32(pl), np.asarray(jl, np.float32), rtol=tol, atol=tol)
    # one decode step at column T
    nxt = np.array([[11], [12]], dtype=np.int32)
    npos = np.full((B, 1), T, dtype=np.int32)
    jl, _, _ = jmodel.forward(jparams, None, jnp.asarray(nxt), jnp.asarray(npos), jkv,
                              jnp.int32(T))
    with port_attention(attn):
        pl, _, _ = model.forward(params, None, torch.as_tensor(nxt), torch.as_tensor(npos),
                                 kv, T)
    np.testing.assert_allclose(np32(pl), np.asarray(jl, np.float32), rtol=tol, atol=tol)


def test_embed_step_pad_offsets_equal_jax(tiny_opt, stores):
    path, _ = tiny_opt
    jmodel, model = _models(path, "float32")
    jparams = jmodel.load_params(JDense(str(stores[0] / "jax")))
    params = to_port(jparams)
    tokens = np.array([[1, 1, 5, 9], [3, 14, 15, 92]], dtype=np.int32)
    pos = np.broadcast_to(np.arange(4, dtype=np.int32), (2, 4)).copy()
    offs = np.array([2, 0], dtype=np.int32)
    want = jmodel.embed_step(jparams, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(offs))
    got = model.embed_step(params, torch.as_tensor(tokens), torch.as_tensor(pos),
                           torch.as_tensor(offs))
    np.testing.assert_array_equal(np32(got), np.asarray(want, np.float32))


def _hf_tokens(hf, prompt, n):
    return hf.generate(torch.tensor(prompt), max_new_tokens=n, do_sample=False,
                       eos_token_id=None, pad_token_id=1).numpy()


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("prompt,n", [
    (np.array([[5, 9, 33, 7]]), 8),
    (np.array([[3, 14, 15, 92, 6], [2, 71, 8, 28, 18]]), 5),  # a batched prefill
], ids=["batch1", "batched"])
def test_facade_matches_jax_and_hf(opt_ckpts, tmp_path, prompt, n, geometry):
    path, hf = opt_ckpts(geometry)
    cfg = {"expert_dtype": "float32", "max_seq_len": 64}
    eng = MoE(path, dict(cfg, offload_path=str(tmp_path / "port")), device="cpu")
    jeng = JMoE(path, dict(cfg, offload_path=str(tmp_path / "jax")))
    try:
        assert eng.arch == "opt"
        assert eng.engine is None and eng.dense_arena is None  # resident, no offload
        got = eng.generate(prompt, max_new_tokens=n, eos_token_id=None)
        np.testing.assert_array_equal(got, _hf_tokens(hf, prompt, n))
        np.testing.assert_array_equal(got, jeng.generate(prompt, max_new_tokens=n,
                                                         eos_token_id=None))
        assert eng.stats() == {} and eng.hit_rate() == 1.0
    finally:
        eng.shutdown()
        jeng.shutdown()


def test_facade_left_padded_batch_equals_jax(tiny_opt, tmp_path):
    """A batched prefill of rows left-padded with OPT's pad id: the facade
    passes no pad offsets and OPT masks no pad, as in JAX, so the tokens
    equal the JAX facade's (HF, given an attention mask, differs)."""
    path, _ = tiny_opt
    cfg = {"expert_dtype": "float32", "max_seq_len": 64}
    prompt = np.array([[1, 1, 3, 14, 15], [2, 71, 8, 28, 18], [1, 1, 1, 9, 33]])
    eng = MoE(path, dict(cfg, offload_path=str(tmp_path / "port")), device="cpu")
    jeng = JMoE(path, dict(cfg, offload_path=str(tmp_path / "jax")))
    try:
        np.testing.assert_array_equal(
            eng.generate(prompt, max_new_tokens=6, eos_token_id=None),
            jeng.generate(prompt, max_new_tokens=6, eos_token_id=None))
    finally:
        eng.shutdown()
        jeng.shutdown()


def test_facade_leaves_mesh_degrees_unused(tiny_opt, tmp_path):
    """A checkpoint with no experts under mesh degrees: the JAX facade builds
    no mesh and serves alone, and so does the port's (no process group
    needed; ``OPTModel`` takes no mesh, as JAX's); the same tokens. Under
    ``multihost`` both raise the JAX facade's ``NotImplementedError``."""
    path, hf = tiny_opt
    cfg = {"expert_dtype": "float32", "max_seq_len": 64, "expert_parallel": 2,
           "data_parallel": 2}
    prompt = np.array([[5, 9, 33, 7]])
    eng = MoE(path, dict(cfg, offload_path=str(tmp_path / "port")), device="cpu")
    jeng = JMoE(path, dict(cfg, offload_path=str(tmp_path / "jax")))
    try:
        assert eng.mesh is None and jeng.mesh is None and eng.engine is None
        got = eng.generate(prompt, max_new_tokens=6, eos_token_id=None)
        np.testing.assert_array_equal(got, jeng.generate(prompt, max_new_tokens=6,
                                                         eos_token_id=None))
        np.testing.assert_array_equal(got, _hf_tokens(hf, prompt, 6))
    finally:
        eng.shutdown()
        jeng.shutdown()
    for make in (lambda c: MoE(path, c, device="cpu"), lambda c: JMoE(path, c)):
        with pytest.raises(NotImplementedError, match="no experts"):
            make(dict(cfg, offload_path=str(tmp_path / "pod"), multihost=True))
    with pytest.raises(TypeError):
        OPTModel(OPTSpec.from_hf(OPTConfig(**TINY)), device="cpu", mesh=object())


@pytest.mark.parametrize("variant", ["published", "minimal"])
def test_config_reader_gives_autoconfigs_spec(tmp_path, variant):
    raw = dict(OPT_66B)
    if variant == "minimal":
        raw = {k: raw[k] for k in ("architectures", "model_type", "hidden_size",
                                   "num_hidden_layers", "num_attention_heads", "ffn_dim")}
    (tmp_path / "config.json").write_text(json.dumps(raw))
    auto, ours = AutoConfig.from_pretrained(str(tmp_path)), phc.read_hf_config(str(tmp_path))
    from moe_infinity_tpu.utils import hf_config as jhc

    assert phc.detect_arch(ours) == jhc.detect_arch(auto) == "opt"
    assert phc.parse_geometry(ours).__dict__ == jhc.parse_geometry(auto).__dict__
    assert phc.parse_geometry(ours).num_experts == 0
    assert (dataclasses.asdict(OPTSpec.from_hf(ours))
            == dataclasses.asdict(JOPTSpec.from_hf(auto)))
    for k in ("pad_token_id", "eos_token_id", "bos_token_id", "word_embed_proj_dim",
              "do_layer_norm_before", "max_position_embeddings", "vocab_size"):
        assert getattr(ours, k) == getattr(auto, k), k


def test_refusals():
    base = OPTConfig(**TINY)
    for kw, what in ((dict(do_layer_norm_before=False), "post-norm"),
                     (dict(word_embed_proj_dim=16), "word_embed_proj_dim")):
        cfg = OPTConfig(**dict(TINY, **kw))
        for spec_cls in (OPTSpec, JOPTSpec):
            with pytest.raises(NotImplementedError, match=what):
                spec_cls.from_hf(cfg)
    spec = OPTSpec.from_hf(base)
    assert spec.head_dim == 8
    # OPT-2.7B: 2560 / 32 = 80, on the card K1's and K2's padded instance;
    # a head dim above 256 (here 320) is refused on the card
    s27 = dataclasses.replace(spec, hidden_size=2560, num_heads=32)
    wide = dataclasses.replace(spec, hidden_size=2560, num_heads=8)
    import moe_infinity_tpu_torch.models.opt as opt_mod

    orig = opt_mod.resolve_device
    opt_mod.resolve_device = lambda d: torch.device(d)
    try:
        assert OPTModel(s27, device="cuda").spec.head_dim == 80
        with pytest.raises(NotImplementedError, match="queue 2 part 3"):
            OPTModel(wide, device="cuda")
        OPTModel(dataclasses.replace(spec, hidden_size=9216, num_heads=72), device="cuda")
    finally:
        opt_mod.resolve_device = orig
    assert OPTModel(wide, device="cpu").spec.head_dim == 320  # plain versions on the CPU
