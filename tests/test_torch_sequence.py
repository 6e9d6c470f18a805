"""The port's sequence-parallel prefill and decode
(``moe_infinity_tpu_torch/parallel/sequence.py``: ``sp_prefill``,
``caches_from_sp``, ``SPDecoder``) against the JAX package's on a ``seq``
mesh of the 8 host devices tests/conftest.py provides, the same weights
carried across by ``bridge`` and the port's ranks as threads of a
``ThreadMesh``. Tolerances are the JAX suite's (tests/test_sequence_parallel.py):
2e-4 for whole models, 3e-4 for Grok and Arctic; greedy tokens equal at f32.
The encoders (``sp_encode``) are in tests/test_torch_sp_encode.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.parallel import MeshPlan as JMeshPlan
from moe_infinity_tpu.parallel import make_mesh as jmake_mesh
from moe_infinity_tpu.parallel.sequence import SPDecoder as JSPDecoder
from moe_infinity_tpu.parallel.sequence import caches_from_sp as jcaches_from_sp
from moe_infinity_tpu.parallel.sequence import sp_prefill as jsp_prefill
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch.parallel.sequence import SPDecoder, caches_from_sp, sp_prefill
from moe_infinity_tpu_torch.runtime.generate import ResidentStepper
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from torch_port_helpers import ThreadMesh, one_intra_op_thread, run_ranks, to_port  # noqa: F401

MIXTRAL = dict(
    vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=8, num_kv_heads=4, head_dim=8, num_experts=8, top_k=2,
    rms_eps=1e-6, rope_theta=1e6, tie_embeddings=False,
)
DS = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=48, num_layers=3, num_heads=4,
    kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
    v_head_dim=32, num_experts=8, top_k=2, n_shared_experts=1,
    first_k_dense_replace=1, topk_method="greedy", n_group=None,
    topk_group=None, routed_scaling_factor=1.0, rms_eps=1e-6,
    rope_theta=10000.0, tie_embeddings=False, q_lora_rank=None,
)
GROK = dict(
    vocab_size=96, hidden_size=48, intermediate_size=64,
    num_layers=2, num_heads=6, num_kv_heads=2, head_dim=8,
    num_experts=4, top_k=2, rms_eps=1e-6,
    embedding_multiplier_scale=1.0, output_multiplier_scale=1.0,
    attn_output_multiplier=0.12, max_attn_value=30.0,
)
ARCTIC = dict(
    vocab_size=96, hidden_size=48, intermediate_size=64,
    num_layers=2, num_heads=6, num_kv_heads=2, head_dim=8,
    num_experts=4, top_k=2, rms_eps=1e-6, rope_theta=1e4,
    moe_layer_frequency=1,
)
S = 4  # the ring


def _family(name):
    """(JAX model, port model, JAX params, JAX experts) of a tiny model of
    ``name`` at f32, JAX ``init_random`` weights."""
    if name == "mixtral":
        from moe_infinity_tpu.models.mixtral import MixtralModel as J, MixtralSpec as JS
        from moe_infinity_tpu_torch.models.mixtral import MixtralModel as Pm, MixtralSpec as PS
        fields, seed = MIXTRAL, 0
    elif name.startswith("mla"):
        from moe_infinity_tpu.models.deepseek_v2 import DeepseekV2ModelJax as J
        from moe_infinity_tpu.models.deepseek_v2 import DeepseekV2Spec as JS
        from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model as Pm
        from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Spec as PS
        fields = dict(DS, q_lora_rank=24) if name == "mla-q24" else DS
        seed = 3 if name == "mla-q24" else 2
    elif name == "grok":
        from moe_infinity_tpu.models.grok import GrokModel as J, GrokSpec as JS
        from moe_infinity_tpu_torch.models.grok import GrokModel as Pm, GrokSpec as PS
        fields, seed = GROK, 6
    else:
        from moe_infinity_tpu.models.arctic import ArcticModel as J, ArcticSpec as JS
        from moe_infinity_tpu_torch.models.arctic import ArcticModel as Pm, ArcticSpec as PS
        fields = dict(ARCTIC, parallel_attn_mlp_res=(name == "arctic"))
        seed = 6
    jspec = JS(**fields)
    jmodel = J(jspec, compute_dtype=jnp.float32)
    jparams, jexperts = jmodel.init_random(jax.random.PRNGKey(seed))
    model = Pm(PS(**dataclasses.asdict(jspec)), torch.float32, "cpu")
    return jmodel, model, jparams, jexperts


@pytest.fixture(scope="module")
def mixtral():
    return _family("mixtral")


@pytest.fixture(scope="module")
def mla():
    return _family("mla")


def _port_prefill(model, params, experts, tokens, s=S):
    """Every thread's logits shard and KV shards."""
    return run_ranks(lambda mesh: sp_prefill(model, params, experts, tokens, mesh,
                                             for_layer=ResidentProvider.for_layer),
                     ThreadMesh.grid(seq=s))


@pytest.mark.parametrize("name,B,T,tol", [
    ("mixtral", 2, 16, 2e-4), ("mla", 2, 8, 2e-4), ("mla-q24", 2, 8, 2e-4),
    ("grok", 2, 8, 3e-4), ("arctic", 2, 8, 3e-4), ("arctic_seq", 2, 8, 3e-4),
])
def test_sp_prefill_matches_jax(rng, mixtral, mla, name, B, T, tol):
    """Each rank's logits and K/V shards are its time block of JAX's: the
    ring over the rank's block (llama-style, MLA's latent ring with and
    without ``q_lora_rank``, first-k dense layers and shared experts,
    Grok's softcap and post-norms, Arctic's parallel and sequential
    residual)."""
    jmodel, model, jparams, jexperts = {"mixtral": mixtral, "mla": mla}.get(name) or _family(name)
    tokens = rng.integers(0, model.spec.vocab_size, (B, T)).astype(np.int32)
    want, jkvs = jsp_prefill(jmodel, jparams, jexperts, jnp.asarray(tokens),
                             jmake_mesh(JMeshPlan(seq=S)), for_layer=JProvider.for_layer)
    ranks = _port_prefill(model, to_port(jparams), to_port(jexperts), tokens)
    Tl = T // S
    for r, (logits, kvs) in enumerate(ranks):
        blk = slice(r * Tl, (r + 1) * Tl)
        np.testing.assert_allclose(logits.numpy(), np.asarray(want)[:, blk], rtol=tol, atol=tol)
        assert len(kvs) == model.spec.num_layers
        for c, jc in zip(kvs, jkvs):
            np.testing.assert_allclose(c.k.numpy(), np.asarray(jc.k)[:, blk], rtol=tol, atol=tol)
            np.testing.assert_allclose(c.v.numpy(), np.asarray(jc.v)[:, blk], rtol=tol, atol=tol)
    if name.startswith("mla"):  # MLA caches hold (latent, rope key) per layer
        s = model.spec
        assert ranks[0][1][0].k.shape == (B, Tl, 1, s.kv_lora_rank)
        assert ranks[0][1][0].v.shape == (B, Tl, 1, s.qk_rope_head_dim)


def _jax_decode(jmodel, jparams, jexperts, logits, kvs, T, steps):
    """Greedy decode on JAX's regular path from caches (the JAX suite's)."""
    toks = []
    cur = jnp.argmax(logits[:, -1, :], -1).astype(jnp.int32)[:, None]
    for i in range(steps):
        toks.append(int(cur[0, 0]))
        logits, kvs, _ = jmodel.forward(jparams, jexperts, cur, jnp.full((1, 1), T + i, jnp.int32),
                                        kvs, jnp.int32(T + i), for_layer=JProvider.for_layer,
                                        impl="gather")
        cur = jnp.argmax(logits[:, -1, :], -1).astype(jnp.int32)[:, None]
    return toks


@pytest.mark.parametrize("family", ["mixtral", "mla"])
def test_caches_from_sp_continue_on_the_regular_path(rng, mixtral, mla, family):
    """The shards gathered by ``caches_from_sp`` into [1, 32] caches, the
    same on every rank and equal to JAX's, continued by the port's
    ``ResidentStepper.decode_scan``: the greedy tokens of JAX's decode
    continued from its own ``caches_from_sp``."""
    jmodel, model, jparams, jexperts = mixtral if family == "mixtral" else mla
    T, CAP, STEPS = 8, 32, 4
    tokens = rng.integers(0, 128, (1, T)).astype(np.int32)
    jlogits, jkvs = jsp_prefill(jmodel, jparams, jexperts, jnp.asarray(tokens),
                                jmake_mesh(JMeshPlan(seq=S)), for_layer=JProvider.for_layer)
    jcaches = jcaches_from_sp(jkvs, CAP)
    want = _jax_decode(jmodel, jparams, jexperts, jlogits, jcaches, T, STEPS)
    params, experts = to_port(jparams), to_port(jexperts)

    def rank(mesh):
        logits, kvs = sp_prefill(model, params, experts, tokens, mesh,
                                 for_layer=ResidentProvider.for_layer)
        caches = caches_from_sp(kvs, CAP, mesh)
        gathered = [(c.k.clone(), c.v.clone()) for c in caches]  # decode_scan writes on
        last = mesh.all_reduce(logits[:, -1] * (mesh.axis_index("seq") == S - 1), "seq")
        stepper = ResidentStepper(model, params, experts, ResidentProvider.for_layer,
                                  impl="gather", graphs=False)
        tok0 = last.argmax(-1).to(torch.int32)[:, None]
        scan, _ = stepper.decode_scan(tok0, torch.full((1,), T, dtype=torch.int32), caches,
                                      STEPS - 1)
        return gathered, [int(tok0[0, 0])] + scan[0].tolist()

    for caches, toks in run_ranks(rank, ThreadMesh.grid(seq=S)):
        for (k, v), jc in zip(caches, jcaches):
            assert k.shape == jc.k.shape and v.shape == jc.v.shape
            np.testing.assert_allclose(k.numpy(), np.asarray(jc.k), rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(v.numpy(), np.asarray(jc.v), rtol=2e-4, atol=2e-4)
        assert toks == want


@pytest.mark.parametrize("family,T", [("mixtral", 8), ("mla", 8), ("mixtral", 11)],
                         ids=["mixtral", "mla", "mixtral-ragged"])
def test_sp_decoder_matches_jax(rng, mixtral, mla, family, T):
    """``SPDecoder.generate`` on 4 ranks: the frozen shards, the replicated
    tail (the ragged prompt's 3 remainder tokens ride it), greedy tokens
    equal to JAX's ``SPDecoder`` on every rank."""
    jmodel, model, jparams, jexperts = mixtral if family == "mixtral" else mla
    STEPS = 6
    tokens = rng.integers(0, 128, (1, T)).astype(np.int32)
    jdec = JSPDecoder(jmodel, jparams, jexperts, jmake_mesh(JMeshPlan(seq=S)),
                      for_layer=JProvider.for_layer, tail_cap=16)
    want = jdec.generate(tokens, max_new_tokens=STEPS)
    params, experts = to_port(jparams), to_port(jexperts)

    def rank(mesh):
        dec = SPDecoder(model, params, experts, mesh, for_layer=ResidentProvider.for_layer,
                        tail_cap=16)
        return dec.generate(tokens, max_new_tokens=STEPS), dec.last_logits

    for got, last in run_ranks(rank, ThreadMesh.grid(seq=S)):
        np.testing.assert_array_equal(got, want)
        assert last.shape == (1, model.spec.vocab_size)


def test_sequence_parallel_errors(mixtral):
    """JAX's ``ValueError``s, word for word, and a step before a prefill."""
    _, model, jparams, jexperts = mixtral
    params, experts = to_port(jparams), to_port(jexperts)
    fl = ResidentProvider.for_layer

    def rank(mesh):
        errs = []
        for call in (
            lambda: sp_prefill(model, params, experts, np.zeros((1, 6), np.int32), mesh,
                               for_layer=fl),
            lambda: caches_from_sp(sp_prefill(model, params, experts,
                                              np.zeros((1, 8), np.int32), mesh,
                                              for_layer=fl)[1], 4, mesh),
        ):
            with pytest.raises(ValueError) as e:
                call()
            errs.append(str(e.value))
        dec = SPDecoder(model, params, experts, mesh, for_layer=fl, tail_cap=4)
        with pytest.raises(RuntimeError, match=r"call prefill\(\) first"):
            dec.step(3, 0)
        for ids, n in ((np.zeros((2, 8), np.int32), 2), (np.zeros((1, 3), np.int32), 2),
                       (np.zeros((1, 7), np.int32), 2)):
            with pytest.raises(ValueError) as e:
                dec.generate(ids, max_new_tokens=n)
            errs.append(str(e.value))
        dec.prefill(np.zeros((1, 4), np.int32))
        with pytest.raises(ValueError) as e:
            dec.step(3, 4)
        errs.append(str(e.value))
        return errs

    errs = run_ranks(rank, ThreadMesh.grid(seq=S))[0]
    assert errs == [
        "prompt length 6 not divisible by seq=4",
        "prefill length 8 exceeds cache 4",
        "SPDecoder.generate supports batch size 1",
        "prompt length 3 is shorter than the ring size 4",
        "prompt remainder (3) + max_new_tokens (2) > tail_cap 4",
        "decode tail exhausted (4); raise tail_cap",
    ]
