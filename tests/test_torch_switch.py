"""The port's Switch Transformers (``models/switch.py``) and T5 relative bias
(``models/layers.py``) against the JAX package on the CPU, on tiny models
built with the JAX ``SwitchModel.init_random`` and carried across with
``bridge``: 4+4 (or 2+2) blocks, every second sparse, d_model 32 or 64,
d_kv 8 or 16, 4 experts, expert capacity 2 (tokens dropped) or 8.

* T5 buckets and position biases are exact over every relative position in
  [-4096, 4096], bidirectional and not, at Switch-large's (32, 128) and at
  the tiny geometry's (8, 16).
* ``switch_route`` gives the JAX ids, weights (0 for dropped tokens) and
  runner-ups at margin 2.
* ``encode`` and ``decode_step`` agree at f32 with rtol = atol = 1e-4 (as
  ``tests/test_torch_nllb.py``) and at bf16 with 3e-2, with plain experts
  and with gated ones (an ``up`` role, the tanh GELU).
* Greedy tokens through ``Seq2SeqGenerator`` equal the JAX generator's at
  f32, on a padded batch at capacity 2.
* K2's plain version at head dim 64 with the three bias forms of Switch's
  path equals JAX ``flash_attend`` in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models import layers as jlayers
from moe_infinity_tpu.models.switch import SwitchModel as JSwitchModel
from moe_infinity_tpu.models.switch import SwitchSpec as JSwitchSpec
from moe_infinity_tpu.ops import flash_attention as jfa
from moe_infinity_tpu.runtime.generate import Seq2SeqGenerator as JGenerator
from moe_infinity_tpu.runtime.providers import ResidentProvider as JResident
from moe_infinity_tpu_torch import bridge
from moe_infinity_tpu_torch.models import layers
from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec
from moe_infinity_tpu_torch.ops import flash_attention as fa
from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

from torch_port_helpers import (
    jax_to_numpy,
    mesh_apply_ff,
    np32,
    one_intra_op_thread,
    port_attention,
    to_port,
)

SPEC = dict(
    vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_heads=4,
    num_encoder_layers=4, num_decoder_layers=4,
    encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=4, expert_capacity=2, rel_buckets=8, rel_max_distance=16,
    rms_eps=1e-6, tie_embeddings=True, is_gated=False, dense_act_gelu=False,
    decoder_start_token_id=0,
)
IDS = np.array([[5, 31, 8, 77, 40, 2], [9, 3, 44, 2, 0, 0]])
MASK = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 0, 0]], dtype=np.float32)
TOL = dict(rtol=1e-4, atol=1e-4)


def _models(dtype="float32", seed=0, gated=False, **over):
    """(JAX model, JAX params, JAX experts, port model, params, experts) of
    one geometry; ``gated`` adds an ``up`` role to the experts and selects
    the tanh GELU."""
    spec = dict(SPEC, **over)
    if gated:
        spec.update(is_gated=True, dense_act_gelu=True)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    jmodel = JSwitchModel(JSwitchSpec(**spec), compute_dtype=jdt)
    jparams, jexperts = jmodel.init_random(jax.random.PRNGKey(seed))
    if gated:
        rng = np.random.default_rng(seed)
        for lay in jexperts["layers"]:
            lay["up"] = jnp.asarray(rng.standard_normal(lay["gate"].shape) * 0.02, jdt)
    model = SwitchModel(SwitchSpec(**spec), compute_dtype=tdt, device="cpu")
    return jmodel, jparams, jexperts, model, to_port(jparams), to_port(jexperts)


# ---- T5 relative bias ---------------------------------------------------------


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 16)])
def test_t5_relative_bucket_exact(buckets, max_distance, bidirectional):
    rel = np.arange(-4096, 4097, dtype=np.int32)
    want = np.asarray(jlayers.t5_relative_bucket(jnp.asarray(rel), bidirectional, buckets,
                                                 max_distance))
    got = layers.t5_relative_bucket(torch.as_tensor(rel), bidirectional, buckets, max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_t5_position_bias_exact(bidirectional):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((32, 16)).astype(np.float32)
    q = np.arange(40, 57, dtype=np.int32)
    k = np.arange(300, dtype=np.int32)
    want = np.asarray(jlayers.t5_position_bias(jnp.asarray(table), jnp.asarray(q),
                                               jnp.asarray(k), bidirectional, 32, 128))
    got = layers.t5_position_bias(torch.as_tensor(table), torch.as_tensor(q),
                                  torch.as_tensor(k), bidirectional, 32, 128)
    assert got.shape == (1, 16, 17, 300)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- spec, init, bridge -------------------------------------------------------


def test_spec_geometry_equals_jax():
    from transformers import SwitchTransformersConfig

    cfg = SwitchTransformersConfig(
        vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=6, num_decoder_layers=4,
        num_heads=4, num_experts=4, expert_capacity=8, num_sparse_encoder_layers=3,
        num_sparse_decoder_layers=2, relative_attention_num_buckets=8,
        relative_attention_max_distance=16, is_gated_act=True, dense_act_fn="gelu_new",
        decoder_start_token_id=0)
    js, s = JSwitchSpec.from_hf(cfg), SwitchSpec.from_hf(cfg)
    assert vars(js) == vars(s)
    for spec_kw in (SPEC, dict(SPEC, encoder_sparse_step=1, decoder_sparse_step=3)):
        js, s = JSwitchSpec(**spec_kw), SwitchSpec(**spec_kw)
        assert s.num_moe_layers == js.num_moe_layers
        for dec in (False, True):
            for i in range(4):
                assert s.is_sparse(i, dec) == js.is_sparse(i, dec)
                if s.is_sparse(i, dec):
                    assert s.moe_layer_id(i, dec) == js.moe_layer_id(i, dec)


@pytest.mark.parametrize("tie", [True, False])
def test_init_random_and_bridge_match_jax_tree(tie):
    """The port's init_random builds the JAX tree's keys and shapes (packed
    int4 experts at half the output width), and the bridge carries the JAX
    trees across leaf for leaf (bf16 by its bits)."""
    spec = dict(SPEC, tie_embeddings=tie)
    jmodel = JSwitchModel(JSwitchSpec(**spec), compute_dtype=jnp.bfloat16)
    jparams, jexperts = jmodel.init_random(jax.random.PRNGKey(1))
    model = SwitchModel(SwitchSpec(**spec), compute_dtype=torch.bfloat16, device="cpu")
    params, experts = model.init_random(torch.Generator().manual_seed(1))
    shapes = lambda t: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), t)  # noqa: E731
    tshapes = lambda t: {  # noqa: E731
        k: tshapes(v) if isinstance(v, dict) else [tshapes(x) for x in v]
        if isinstance(v, list) else (tuple(v.shape), str(v.dtype).split(".")[-1])
        for k, v in t.items()}
    assert tshapes(params) == shapes(jparams)
    assert tshapes(experts) == shapes(jexperts)
    _, packed = model.init_random(torch.Generator().manual_seed(1), expert_dtype="int4")
    lay = packed["layers"][0]
    assert lay["gate4"].shape == (4, 32, 32) and lay["down4"].shape == (4, 64, 16)
    assert lay["gate_scale"].shape == (4, 64) and lay["down_scale"].shape == (4, 32)
    ported = to_port(jparams)
    assert ported["dec_blocks"][0]["rel_bias"].dtype == torch.float32
    assert ported["enc_blocks"][1]["q"].dtype == torch.bfloat16
    back = bridge.to_numpy(ported)
    for a, b in zip(jax.tree.leaves(jax_to_numpy(jparams)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    _, params0 = model.init_random(torch.Generator().manual_seed(1), with_experts=False)
    assert params0 is None


def test_unported_options_raise():
    _, _, _, model, params, experts = _models()
    # per-row positions are ported (tests/test_torch_continuous_s2s.py holds
    # them to JAX); they take one token per row
    with pytest.raises(ValueError, match="one token per row"):
        model.decode_step(params, experts, torch.zeros(2, 2, dtype=torch.int32),
                          torch.zeros(2, 2, dtype=torch.int32), model.init_cache(2, 8), 0,
                          torch.ones(2, 6), None, ResidentProvider.for_layer,
                          row_offsets=torch.zeros(2, dtype=torch.int32))
    # a mesh is served: its ranks (threads here, ``ThreadMesh``), each on its
    # slice of a layer's experts (the slots over the expert axis, d_ff over
    # the model axis), give the unsharded layer's output
    g = torch.Generator().manual_seed(2)
    h = torch.randn(2, 3, SPEC["d_model"], generator=g)
    ids = torch.randint(0, SPEC["num_experts"], (2, 3, 1), generator=g, dtype=torch.int32)
    cw = torch.rand(2, 3, 1, generator=g)
    layer = ResidentProvider.for_layer(experts, 0)
    want = model.apply_ff(torch.zeros_like(h), h, cw, ids, *layer, "ragged")
    for sizes in (dict(expert=2), dict(model=2), dict(model=2, expert=2)):
        for got in mesh_apply_ff(lambda mesh: SwitchModel(SwitchSpec(**SPEC), torch.float32,
                                                          "cpu", mesh=mesh),
                                 layer, h, cw, ids, sizes):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SwitchModel(SwitchSpec(**SPEC))


# ---- routing ------------------------------------------------------------------


@pytest.mark.parametrize("margin", [0, 2])
def test_switch_route_equals_jax(margin):
    """Capacity 2 over sequences of 12 tokens and 4 experts drops tokens;
    ids, combine weights (0 where dropped) and runner-ups equal JAX's. Equal
    logits (a zeroed router row) put the lower expert first, as top_k."""
    jmodel, jparams, _, model, params, _ = _models()
    b = dict(jparams["enc_blocks"][1])
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 12, 32)).astype(np.float32)
    router = np.asarray(b["router"]).copy()
    router[2] = router[3] = 0.0  # experts 2 and 3 tie on every token
    b["router"] = jnp.asarray(router)
    tb = dict(params["enc_blocks"][1], router=torch.as_tensor(router))
    jcw, jids, jtr = jmodel.switch_route(b, jnp.asarray(h), margin)
    cw, ids, tr = model.switch_route(tb, torch.as_tensor(h), margin)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jtr))
    np.testing.assert_allclose(cw.numpy(), np.asarray(jcw), rtol=1e-6, atol=1e-7)
    assert (cw.numpy() == 0).sum() > 0  # some tokens were dropped
    assert tr.shape == (3, 12, 1 + margin) and tr.dtype == torch.int32


# ---- encode and decode --------------------------------------------------------


def _encode_decode(jmodel, jparams, jexperts, model, params, experts, steps=4, margin=0):
    """Encode IDS/MASK in both packages, then ``steps`` greedy decode steps
    fed JAX's tokens: [(JAX, port)] encoder outputs and per-step logits and
    traces (JAX's stacked)."""
    jmodel.route_margin = model.route_margin = margin
    tok, m = jnp.asarray(IDS, jnp.int32), jnp.asarray(MASK)
    jenc = jmodel.encode(jparams, jexperts, tok, m, JResident.for_layer)
    pm = torch.as_tensor(MASK)
    with torch.inference_mode():
        enc = model.encode(params, experts, torch.as_tensor(IDS, dtype=torch.int32), pm,
                           ResidentProvider.for_layer)
        cross = model.cross_kv(params, enc)
        kv = model.init_cache(2, 16)
    out = [(jenc, enc)]
    jcross, jkv = jmodel.cross_kv(jparams, jenc), jmodel.init_cache(2, 16)
    cur = np.zeros((2, 1), np.int32)
    for step in range(steps):
        pos = np.full((2, 1), step, np.int32)
        jlog, jkv, jtr = jmodel.decode_step(jparams, jexperts, jnp.asarray(cur),
                                            jnp.asarray(pos), jkv, jnp.int32(step), m,
                                            jcross, JResident.for_layer)
        with torch.inference_mode():
            log, kv, tr = model.decode_step(params, experts, torch.as_tensor(cur),
                                            torch.as_tensor(pos), kv, step, pm, cross,
                                            ResidentProvider.for_layer)
        out.append((jlog, log))
        out.append((np.stack([np.asarray(t) for t in jtr]), tr))
        cur = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)
    return out


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("d_model,d_kv,capacity", [(32, 8, 2), (64, 16, 8)])
def test_encode_decode_equal_jax_f32(gated, d_model, d_kv, capacity):
    jm, jp, je, m, p, e = _models(gated=gated, d_model=d_model, d_kv=d_kv,
                                  expert_capacity=capacity)
    pairs = _encode_decode(jm, jp, je, m, p, e)
    for i, (want, got) in enumerate(pairs):
        if i and i % 2 == 0:  # a trace: [L, B, 1] ids against [L, B, 1, 1]
            np.testing.assert_array_equal(got.numpy()[..., 0], want)
        else:
            np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), **TOL)


def test_decode_trace_with_margin_equals_jax():
    pairs = _encode_decode(*_models(), steps=3, margin=2)
    for want, got in pairs[2::2]:
        assert got.shape == (2, 2, 1, 3)
        np.testing.assert_array_equal(got.numpy(), want)


def test_encode_decode_equal_jax_bf16():
    """bf16 compute, capacity 8: the encoder output and the decode logits
    within 3e-2 of the JAX package's."""
    jm, jp, je, m, p, e = _models("bfloat16", seed=2, expert_capacity=8)
    pairs = _encode_decode(jm, jp, je, m, p, e, steps=2)
    for i, (want, got) in enumerate(pairs):
        if not (i and i % 2 == 0):
            np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=3e-2,
                                       atol=3e-2)


@pytest.mark.parametrize("impl", ["ragged", "gather", "dense"])
def test_generator_greedy_tokens_equal_jax(impl):
    """A padded batch at capacity 2 (tokens dropped in the encoder), 8 greedy
    tokens through ``Seq2SeqGenerator`` on the CPU (the attention kernels'
    plain versions, and the einsum oracle) equal the JAX generator's."""
    jm, jp, je, m, p, e = _models(seed=4)
    jgen = JGenerator(jm, jp, je, JResident.for_layer)
    gen = Seq2SeqGenerator(m, p, e, ResidentProvider.for_layer, impl=impl)
    kw = dict(max_new_tokens=8, attention_mask=MASK, eos_token_id=None)
    want = jgen.generate(IDS, **kw)
    got = gen.generate(IDS, **kw)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    with port_attention("naive"):
        np.testing.assert_array_equal(gen.generate(IDS, **kw).sequences, want.sequences)


# ---- K2 at head dim 64 ----------------------------------------------------------


@pytest.mark.parametrize("form", ["BHTS", "1H1S", "B11S"])
def test_flash_attend_plain_dh64_equals_jax_interpret(form):
    """K2's plain version at head dim 64, scale 1.0, with Switch's three bias
    forms (encoder T5 plus pad, decoder self T5 at one causal query, cross
    pad), equals JAX ``flash_attend`` run by its Pallas kernel in interpret
    mode; the pad rows carry finfo(f32).min, as the models' biases do."""
    rng = np.random.default_rng(7)
    B, H, Dh = 2, 4, 64
    T, S = (16, 16) if form == "BHTS" else (1, 32)
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, H, Dh)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    pad = np.where(np.arange(S)[None] < np.array([[S], [S - 5]]), 0.0,
                   np.finfo(np.float32).min).astype(np.float32)[:, None, None, :]
    table = rng.standard_normal((32, H)).astype(np.float32)
    causal = form == "1H1S"
    if form == "BHTS":
        pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
        bias = np.asarray(jlayers.t5_position_bias(jnp.asarray(table), jnp.arange(T),
                                                   jnp.arange(S), True)) + pad
    elif form == "1H1S":
        pos = np.full((B, 1), 20, np.int32)
        bias = np.array(jlayers.t5_position_bias(jnp.asarray(table), jnp.asarray(pos[0]),
                                                   jnp.arange(S), False))
    else:
        pos = np.zeros((B, 1), np.int32)
        bias = pad
    want = jfa.flash_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            jnp.int32(S), scale=1.0, causal=causal, bias=jnp.asarray(bias),
                            interpret=True)
    got = fa.flash_attend(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                          torch.as_tensor(pos), S, scale=1.0, causal=causal,
                          bias=torch.as_tensor(bias))
    assert got.shape == (B, T, H, Dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_wrappers_take_head_dim_64_and_raise_otherwise(monkeypatch):
    """On CUDA tensors K1, K2 and K4 take head dims 64 and 128 on instances
    of their own and every other dim up to 256 on a padded instance of
    width 128 or 256 (each counted under its own name, launched from its own
    library), and raise above 256; the launch itself is replaced, so this
    runs on the CPU."""
    seen = []

    def fake(stem, name, argtypes):
        def call(*args):
            seen.append((stem, name, args[-2]))  # the head dim, before the stream
            return 0
        return call

    monkeypatch.setattr(fa._build, "function", fake)
    monkeypatch.setattr(fa._build, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(fa._build, "check_aligned", lambda *a, **k: None)
    for Dh, suffix, stem in ((64, "_dh64", "flash_attention"), (128, "", "flash_attention"),
                             (32, "_pad128", "flash_attention_pad128"),
                             (96, "_pad128", "flash_attention_pad128"),
                             (256, "_pad256", "flash_attention_pad256")):
        B, T, H, S = 2, 16, 4, 24
        q = torch.zeros(B, T, H, Dh)
        k = torch.zeros(B, S, H, Dh)
        before = dict(fa.LAUNCHES)
        fa._attend_cuda(q, k, k, torch.zeros(B, T, dtype=torch.int32), S, scale=1.0,
                        causal=False, logit_softcap=None, bias=None, pad_mask=None)
        fa._attend_cuda(q[:, :1], k, k, torch.zeros(B, 1, dtype=torch.int32), S, scale=1.0,
                        causal=False, logit_softcap=None, bias=torch.zeros(1, H, 1, S),
                        pad_mask=None)
        fa._decode_cuda(q[:, 0], k, k, torch.zeros(B, dtype=torch.int32), S, scale=1.0,
                        causal=True, logit_softcap=None, pad_mask=None)
        for name, n in (("flash_attend", 2), ("flash_decode", 1)):
            assert fa.LAUNCHES[name + suffix] == before[name + suffix] + n
        assert [(s, d) for s, _, d in seen[-3:]] == [(stem, Dh)] * 3
    for Dh in (257, 320):
        with pytest.raises(ValueError, match="head_dim 1 to 256"):
            fa._decode_cuda(torch.zeros(1, 4, Dh), torch.zeros(1, 8, 4, Dh),
                            torch.zeros(1, 8, 4, Dh), torch.zeros(1, dtype=torch.int32), 8,
                            scale=1.0, causal=True, logit_softcap=None, pad_mask=None)
