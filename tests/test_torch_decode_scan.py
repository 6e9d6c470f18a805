"""``decode_scan`` of the port (``runtime/generate.py``) against the JAX
package's on the same numpy-made weights, at f32 on the CPU:

* ``ResidentStepper.decode_scan`` on tiny Mixtral (K1's plain version) and
  tiny DeepSeek-V2 (MLA through K5's plain version, planned from the cache's
  capacity; a latent of 128, which K5 takes): greedy tokens equal, the returned caches within 1e-5 (both
  frameworks' f32 sums, a few ulps apart);
* ``Seq2SeqGenerator.decode_scan`` on tiny NLLB and Switch: tokens equal to
  the JAX ``decode_scan``'s, which tests/test_switch_parity.py holds to
  ``generate``;
* a sampled scan (temperature, top-p, repetition and frequency penalties,
  a logit bias) equal to a per-step loop of the port's ``sample_step`` from
  the same seed, the counts updated in place; the draws of a scan depend on
  its seed alone;
* the graph path through the CPU's capture stand-in (``StandIn``): blocks
  of ``SCAN_BLOCK`` steps and a remainder, each block's graph captured
  before the state is loaded (a capture's warm-up moves the state on), the
  tokens and caches bit-equal to the eager path, one graph per block length,
  none captured again at another start position.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models import deepseek_v2 as jds
from moe_infinity_tpu.models.mixtral import MixtralModel as JMixtralModel
from moe_infinity_tpu.models.mixtral import MixtralSpec as JMixtralSpec
from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
from moe_infinity_tpu.models.switch import SwitchModel as JSwitchModel
from moe_infinity_tpu.models.switch import SwitchSpec as JSwitchSpec
from moe_infinity_tpu.runtime import generate as jgen
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model, DeepseekV2Spec
from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec
from moe_infinity_tpu_torch.runtime import generate as gen
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.runtime.sampling import (
    SamplingParams,
    init_state,
    sample_step,
)

from torch_port_helpers import StandIn, one_intra_op_thread, to_port

TOL = 1e-5
MIXTRAL = dict(
    vocab_size=128, hidden_size=48, intermediate_size=96, num_layers=2,
    num_heads=6, num_kv_heads=2, head_dim=8, num_experts=4, top_k=2,
    rms_eps=1e-6, rope_theta=1e4, tie_embeddings=False,
)
DEEPSEEK = dict(
    vocab_size=128, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=128, num_layers=3, num_heads=4,
    q_lora_rank=None, kv_lora_rank=128, qk_nope_head_dim=32,
    qk_rope_head_dim=16, v_head_dim=32, num_experts=8, top_k=2,
    n_shared_experts=1, first_k_dense_replace=1, topk_method="greedy",
    n_group=None, topk_group=None, routed_scaling_factor=1.0,
    rms_eps=1e-6, rope_theta=10000.0, tie_embeddings=False,
)
NLLB = dict(
    vocab_size=96, d_model=32, num_heads=4, encoder_layers=4, decoder_layers=4,
    encoder_ffn_dim=64, decoder_ffn_dim=64, encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=4, pad_token_id=1, decoder_start_token_id=2, max_positions=64,
    scale_embedding=True,
)
SWITCH = dict(
    vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_heads=4,
    num_encoder_layers=4, num_decoder_layers=4,
    encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=4, expert_capacity=2, rel_buckets=8, rel_max_distance=16,
    rms_eps=1e-6, tie_embeddings=True, is_gated=False, dense_act_gelu=False,
    decoder_start_token_id=0,
)
PROMPT = np.array([[5, 31, 8, 77, 12], [9, 3, 44, 6, 21]])
SRC = np.array([[5, 31, 8, 77, 40, 2], [9, 3, 44, 2, 1, 1]])
CAP, STEPS = 32, 11  # 11 steps: a block of SCAN_BLOCK and a remainder of 3


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _decoder(arch):
    """(JAX stepper, port model, params, experts) of a tiny f32 model with
    the same weights."""
    if arch == "mixtral":
        jmodel = JMixtralModel(JMixtralSpec(**MIXTRAL), compute_dtype=jnp.float32)
        model = MixtralModel(MixtralSpec(**MIXTRAL), torch.float32, "cpu")
    else:
        jmodel = jds.DeepseekV2ModelJax(jds.DeepseekV2Spec(**DEEPSEEK), compute_dtype=jnp.float32)
        model = DeepseekV2Model(DeepseekV2Spec(**DEEPSEEK), torch.float32, "cpu")
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(3))
    jstep = jgen.ResidentStepper(jmodel, jparams, jtree, JProvider.for_layer)
    return jstep, model, to_port(jparams), to_port(jtree)


def _prefill_jax(jstep):
    kv = jstep.init_cache(2, CAP)
    T = PROMPT.shape[1]
    pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (2, T))
    logits, kv, _ = jstep.forward(jnp.asarray(PROMPT, jnp.int32), pos, kv, jnp.int32(0))
    return np.asarray(jnp.argmax(logits[:, -1, :], -1)).astype(np.int32)[:, None], kv


def _prefill(stepper):
    kv = stepper.init_cache(2, CAP)
    T = PROMPT.shape[1]
    pos = torch.arange(T, dtype=torch.int32).expand(2, T)
    stepper.forward(torch.tensor(PROMPT, dtype=torch.int32), pos, kv, 0)
    return kv


def _caches_np(kv):
    return [np.asarray(a, np.float32) for c in kv for a in (c.k, c.v)]


@pytest.mark.parametrize("arch", ["mixtral", "deepseek"])
def test_resident_decode_scan_matches_jax(arch):
    jstep, model, params, tree = _decoder(arch)
    tok0, jkv = _prefill_jax(jstep)
    pos0 = np.full((2,), PROMPT.shape[1], np.int32)
    jtoks, jkv = jstep.decode_scan(jnp.asarray(tok0), jnp.asarray(pos0), jkv, STEPS)
    stepper = gen.ResidentStepper(model, params, tree, ResidentProvider.for_layer)
    kv = _prefill(stepper)
    toks, kv = stepper.decode_scan(torch.tensor(tok0), torch.tensor(pos0), kv, STEPS)
    assert toks.dtype == torch.int64 and tuple(toks.shape) == (2, STEPS)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    for got, want in zip(_caches_np(kv), _caches_np(jkv)):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["mixtral", "deepseek"])
def test_resident_graph_scan_equals_eager(arch):
    """Through the capture stand-in: bit-equal tokens and caches, two graphs
    (the block and the remainder), replays continuing the state, and a
    second call at another start position replaying the same graphs."""
    _, model, params, tree = _decoder(arch)
    eager = gen.ResidentStepper(model, params, tree, ResidentProvider.for_layer)
    backend = StandIn()
    graphed = gen.ResidentStepper(model, params, tree, ResidentProvider.for_layer,
                                  graph_backend=backend)
    tok0 = torch.tensor([[7], [19]], dtype=torch.int32)
    for start in (PROMPT.shape[1], PROMPT.shape[1] + 2):
        pos0 = torch.full((2,), start, dtype=torch.int32)
        want, wkv = eager.decode_scan(tok0, pos0, _prefill(eager), STEPS)
        got, gkv = graphed.decode_scan(tok0, pos0, _prefill(graphed), STEPS)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for g, w in zip(_caches_np(gkv), _caches_np(wkv)):
            np.testing.assert_array_equal(g[:, :start + STEPS - 1], w[:, :start + STEPS - 1])
    stats = graphed.graph_stats()
    assert stats["graphs"] == 2 and stats["captures"] == 2 and stats["recaptures"] == 0
    assert stats["replays"] == 2 * len(gen._scan_blocks(STEPS)) and backend.captured == 2
    assert eager.graph_stats() == {}


def _s2s(arch):
    if arch == "nllb":
        jmodel = JNllbModel(JNllbSpec(**NLLB), compute_dtype=jnp.float32)
        model = NllbModel(NllbSpec(**NLLB), compute_dtype=torch.float32, device="cpu")
    else:
        jmodel = JSwitchModel(JSwitchSpec(**SWITCH), compute_dtype=jnp.float32)
        model = SwitchModel(SwitchSpec(**SWITCH), compute_dtype=torch.float32, device="cpu")
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(5))
    return jmodel, jparams, jtree, model, to_port(jparams), to_port(jtree)


@pytest.mark.parametrize("arch", ["nllb", "switch"])
def test_seq2seq_decode_scan_matches_jax(arch):
    jmodel, jparams, jtree, model, params, tree = _s2s(arch)
    mask = (SRC != 1).astype(np.float32)
    jg = jgen.Seq2SeqGenerator(jmodel, jparams, jtree, JProvider.for_layer)
    want, _ = jg.decode_scan(SRC, STEPS, attention_mask=mask)
    g = gen.Seq2SeqGenerator(model, params, tree, ResidentProvider.for_layer)
    got, kvs = g.decode_scan(SRC, STEPS, attention_mask=mask)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert kvs[0].max_len == gen._bucket_len(STEPS + 1)
    # the graph path (stand-in) gives the same tokens
    gg = gen.Seq2SeqGenerator(model, params, tree, ResidentProvider.for_layer,
                              graph_backend=StandIn())
    np.testing.assert_array_equal(gg.decode_scan(SRC, STEPS, attention_mask=mask)[0].numpy(),
                                  np.asarray(want))
    assert gg.graph_stats()["graphs"] == 2


SAMPLED = SamplingParams(temperature=0.8, top_p=0.9, repetition_penalty=1.1,
                         frequency_penalty=0.3, logit_bias=((3, 2.0), (17, -1.5)))


def _per_step(model, params, tree, tok0, pos0, kv, n, sp, seed):
    """The reference: a loop of the port's forward and ``sample_step``."""
    state = init_state(sp, 2, model.spec.vocab_size, seed=seed)
    tok, out = tok0.clone(), []
    for i in range(n):
        pos = pos0 + i
        logits, _, _ = model.forward(params, tree, tok, pos[:, None], kv, int(pos[0]),
                                     for_layer=ResidentProvider.for_layer)
        so, state = sample_step(logits[:, -1, :], state, sp)
        out.append(so.token)
        tok = so.token[:, None].to(torch.int32)
    return torch.stack(out, 1)


@pytest.mark.parametrize("graphs", [False, True])
def test_sampled_scan_equals_per_step_sampler(graphs):
    _, model, params, tree = _decoder("mixtral")
    kw = {"graph_backend": StandIn()} if graphs else {"graphs": False}
    stepper = gen.ResidentStepper(model, params, tree, ResidentProvider.for_layer, **kw)
    tok0 = torch.tensor([[7], [19]], dtype=torch.int32)
    pos0 = torch.full((2,), PROMPT.shape[1], dtype=torch.int32)
    want = _per_step(model, params, tree, tok0, pos0, _prefill(stepper), STEPS, SAMPLED, 4)
    got, _ = stepper.decode_scan(tok0, pos0, _prefill(stepper), STEPS, sampling=SAMPLED, seed=4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    again, _ = stepper.decode_scan(tok0, pos0, _prefill(stepper), STEPS, sampling=SAMPLED,
                                   seed=4)
    torch.testing.assert_close(again, want, rtol=0, atol=0)
    other, _ = stepper.decode_scan(tok0, pos0, _prefill(stepper), STEPS, sampling=SAMPLED,
                                   seed=5)
    assert not torch.equal(other, want)


def test_scan_blocks():
    assert gen._scan_blocks(32) == [gen.SCAN_BLOCK] * (32 // gen.SCAN_BLOCK)
    assert gen._scan_blocks(3) == [3] and gen._scan_blocks(0) == []
    assert sum(gen._scan_blocks(STEPS)) == STEPS
