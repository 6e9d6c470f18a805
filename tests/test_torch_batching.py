"""The port's batchers (``runtime/batching.py``, ``runtime/continuous_s2s.py``)
on the CPU against the JAX package, mirroring tests/test_batching.py case for
case: the decoder-only wave batcher (``DynamicBatcher``, left padding) on a
tiny Mixtral, the seq2seq wave batcher (``Seq2SeqDynamicBatcher``) and the
seq2seq continuous batcher (``Seq2SeqContinuousBatcher``: staggered joins,
slot reuse, the Switch family, a failed step) on a tiny NLLB and Switch.
f32, weights made once by the JAX models' ``init_random`` and carried over
by the bridge; each request's greedy tokens must equal the JAX generator's
isolated run, token for token. The Mixtral's query and key projections are
scaled (x40) so that attention is sharp, and the seq2seq models'
embeddings and attention projections (``sharpen_seq2seq``) so that their
tokens depend on the source and move along a sequence: with init_random's
weights a row fed another row's pad columns, cross K/V or position would
go unseen. Every future waits at most ``TIMEOUT`` s and every batcher is
shut down in a ``finally``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.mixtral import MixtralModel as JMixtralModel
from moe_infinity_tpu.models.mixtral import MixtralSpec as JMixtralSpec
from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
from moe_infinity_tpu.models.switch import SwitchModel as JSwitchModel
from moe_infinity_tpu.models.switch import SwitchSpec as JSwitchSpec
from moe_infinity_tpu.runtime.generate import Generator as JGenerator
from moe_infinity_tpu.runtime.generate import Seq2SeqGenerator as JSeq2SeqGenerator
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec
from moe_infinity_tpu_torch.runtime.batching import DynamicBatcher, Seq2SeqDynamicBatcher
from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import sharpen_seq2seq, to_port, wait_for

TIMEOUT = 60
MIXTRAL = dict(  # the spec of tests/test_batching.py
    vocab_size=128, hidden_size=48, intermediate_size=96, num_layers=2,
    num_heads=6, num_kv_heads=2, head_dim=8, num_experts=4, top_k=2,
    rms_eps=1e-6, rope_theta=1e4, tie_embeddings=False,
)
NLLB = dict(  # tests/test_batching.py's s2s_setup
    vocab_size=96, d_model=32, num_heads=4, encoder_layers=2, decoder_layers=2,
    encoder_ffn_dim=64, decoder_ffn_dim=64, encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=4, pad_token_id=1, decoder_start_token_id=2, max_positions=64,
    scale_embedding=True,
)
SWITCH = dict(  # tests/test_batching.py's Switch family
    vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=2,
    num_decoder_layers=2, encoder_sparse_step=2, decoder_sparse_step=2, num_experts=4,
    expert_capacity=8, rel_buckets=8, rel_max_distance=16, rms_eps=1e-6,
    tie_embeddings=True, is_gated=False, dense_act_gelu=False, decoder_start_token_id=0,
)


def _memo(fn):
    cache = {}

    def want(prompt, n):
        key = (tuple(int(t) for t in prompt), n)
        if key not in cache:
            cache[key] = fn(np.asarray(prompt)[None], n)
        return cache[key]

    return want


@pytest.fixture(scope="module")
def mixtral():
    jmodel = JMixtralModel(JMixtralSpec(**MIXTRAL), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(2))
    for layer in jparams["layers"]:
        layer["q"], layer["k"] = layer["q"] * 40.0, layer["k"] * 40.0
    jgen = JGenerator(jmodel, jparams, jtree, JProvider.for_layer, max_seq_len=64)
    model = MixtralModel(MixtralSpec(**MIXTRAL), compute_dtype=torch.float32, device="cpu")
    want = _memo(lambda p, n: jgen.generate(p, max_new_tokens=n).sequences[0])
    return model, to_port(jparams), to_port(jtree), want


def _seq2seq(jmodel_cls, jspec_cls, model_cls, spec_cls, spec, seed):
    jmodel = jmodel_cls(jspec_cls(**spec), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(seed))
    sharpen_seq2seq(jparams)
    jgen = JSeq2SeqGenerator(jmodel, jparams, jtree, JProvider.for_layer)
    model = model_cls(spec_cls(**spec), compute_dtype=torch.float32, device="cpu")
    want = _memo(lambda p, n: jgen.generate(p, max_new_tokens=n,
                                            eos_token_id=None).sequences[0])
    return model, to_port(jparams), to_port(jtree), want


@pytest.fixture(scope="module")
def nllb():
    return _seq2seq(JNllbModel, JNllbSpec, NllbModel, NllbSpec, NLLB, 6)


@pytest.fixture(scope="module")
def switch():
    return _seq2seq(JSwitchModel, JSwitchSpec, SwitchModel, SwitchSpec, SWITCH, 3)


# ---- decoder-only wave batching ---------------------------------------------

def test_batched_matches_individual(mixtral):
    model, params, tree, want = mixtral
    batcher = DynamicBatcher(model, params, tree, ResidentProvider.for_layer,
                             max_batch_size=4, max_wait_s=0.2, max_seq_len=64)
    try:
        prompts = [np.array([5, 31, 8]), np.array([9, 3, 44, 6, 17]),  # left padding
                   np.array([77])]
        futures = [batcher.submit(p, max_new_tokens=6) for p in prompts]
        for p, f in zip(prompts, futures):
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT), want(p, 6))
    finally:
        batcher.shutdown()


def test_eos_stops_per_sequence(mixtral):
    model, params, tree, want = mixtral
    batcher = DynamicBatcher(model, params, tree, ResidentProvider.for_layer,
                             max_batch_size=4, max_wait_s=0.2, max_seq_len=64)
    try:
        p = np.array([5, 31, 8])
        ref = want(p, 8)
        eos = int(ref[4])  # stop at the 2nd generated token (or before)
        got = batcher.submit(p, max_new_tokens=8, eos_token_id=eos).result(timeout=TIMEOUT)
        np.testing.assert_array_equal(got, ref[:np.where(ref[3:] == eos)[0][0] + 4])
    finally:
        batcher.shutdown()


# ---- seq2seq wave batching ----------------------------------------------------

def test_s2s_batched_matches_individual(nllb):
    """Ragged sources batched in one wave equal serial generation: right
    padding under the mask moves no position."""
    model, params, tree, want = nllb
    batcher = Seq2SeqDynamicBatcher(model, params, tree, ResidentProvider.for_layer,
                                    max_batch_size=4, max_wait_s=0.2)
    try:
        prompts = [np.array([5, 31, 8, 77, 2]), np.array([9, 4, 61]),
                   np.array([12, 3, 44, 7, 90, 15, 2])]
        futs = [batcher.submit(p, max_new_tokens=6, eos_token_id=None) for p in prompts]
        for p, f in zip(prompts, futs):
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT), want(p, 6))
    finally:
        batcher.shutdown()


def test_s2s_eos_stops_per_request(nllb):
    model, params, tree, want = nllb
    p1, p2 = np.array([5, 31, 8]), np.array([9, 4, 61, 7])
    g1 = want(p1, 5)
    batcher = Seq2SeqDynamicBatcher(model, params, tree, ResidentProvider.for_layer,
                                    max_batch_size=2, max_wait_s=0.2)
    try:
        f1 = batcher.submit(p1, max_new_tokens=5, eos_token_id=int(g1[1]))
        f2 = batcher.submit(p2, max_new_tokens=5, eos_token_id=None)
        r1, r2 = f1.result(timeout=TIMEOUT), f2.result(timeout=TIMEOUT)
        assert len(r1) == 2 and r1[1] == g1[1]  # stopped at its eos
        np.testing.assert_array_equal(r2, want(p2, 5))  # ran to its budget
    finally:
        batcher.shutdown()


# ---- seq2seq continuous batching ----------------------------------------------

def _continuous(model_bundle, **kw):
    model, params, tree, _ = model_bundle
    cfg = dict(max_batch_size=3, max_src_len=16, max_decode_len=16)
    cfg.update(kw)
    return Seq2SeqContinuousBatcher(model, params, tree, ResidentProvider.for_layer, **cfg)


def _staggered(batcher, want, p1, n1, p2, n2):
    """Submit p2 once p1's slot has decoded two tokens, so that it joins
    mid-flight; both must equal their isolated runs."""
    f1 = batcher.submit(p1, max_new_tokens=n1, eos_token_id=None)
    wait_for(lambda: len(batcher._slots[0].generated) >= 2 or f1.done(), TIMEOUT,
             "the first request's second token")
    assert not f1.done(), "the first request ended before the second joined"
    f2 = batcher.submit(p2, max_new_tokens=n2, eos_token_id=None)
    np.testing.assert_array_equal(f1.result(timeout=TIMEOUT), want(p1, n1))
    np.testing.assert_array_equal(f2.result(timeout=TIMEOUT), want(p2, n2))


def test_s2s_continuous_staggered_matches_isolated(nllb):
    """A request joining mid-decode: per-row positions (row_offsets), the
    slot's own cross K/V rows and mask row."""
    batcher = _continuous(nllb, idle_sleep_s=0.002)
    try:
        _staggered(batcher, nllb[3], np.array([5, 31, 8, 77, 2]), 12, np.array([9, 4, 61]), 6)
        assert batcher.step_stats()["joins"] == 2
    finally:
        batcher.shutdown()


def test_s2s_continuous_slot_reuse(nllb):
    """More requests than slots: freed slots seat new requests, and a previous
    occupant's K/V past the causal bound never leaks."""
    want = nllb[3]
    batcher = _continuous(nllb, max_batch_size=2)
    try:
        prompts = [np.array([5, 31, 8]), np.array([9, 4, 61, 7]), np.array([12, 3]),
                   np.array([44, 7, 90, 15, 2]), np.array([77])]
        news = [5, 7, 3, 6, 5]
        futs = [batcher.submit(p, max_new_tokens=n, eos_token_id=None)
                for p, n in zip(prompts, news)]
        for p, n, f in zip(prompts, news, futs):
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT), want(p, n))
    finally:
        batcher.shutdown()


def test_s2s_continuous_switch_family(switch):
    """Switch: the per-row T5 bias [B, H, 1, S] gathered from each row's
    own position."""
    batcher = _continuous(switch, max_batch_size=2)
    try:
        _staggered(batcher, switch[3], np.array([5, 31, 8, 7]), 10, np.array([9, 4, 61]), 5)
    finally:
        batcher.shutdown()


def test_s2s_continuous_survives_step_failure(nllb):
    """A failed shared step fails the active futures; the caches are zeroed
    in place and the scheduler keeps serving exactly."""
    want = nllb[3]
    batcher = _continuous(nllb, max_batch_size=2)
    orig = batcher._step
    state = {"armed": True}

    def poisoned(*a, **k):
        if state["armed"]:
            state["armed"] = False
            raise RuntimeError("injected step failure")
        return orig(*a, **k)

    batcher._step = poisoned
    try:
        f = batcher.submit(np.array([5, 31]), max_new_tokens=4, eos_token_id=None)
        with pytest.raises(RuntimeError, match="injected"):
            f.result(timeout=TIMEOUT)
        batcher._step = orig
        p = np.array([9, 4, 61])
        got = batcher.submit(p, max_new_tokens=5, eos_token_id=None).result(timeout=TIMEOUT)
        np.testing.assert_array_equal(got, want(p, 5))
        assert batcher._thread.is_alive()
    finally:
        batcher.shutdown()
    assert not batcher._thread.is_alive()
