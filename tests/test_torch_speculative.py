"""The port's prompt-lookup speculation (``runtime/speculative.py``) on the
CPU against the JAX package, mirroring tests/test_speculative.py case for
case: ``ngram_draft`` on fixed contexts, the decoder's output equal token for
token to the JAX ``Generator``'s sequential greedy decode at k = 2 and 4,
drafts accepted on a repetitive model, EOS inside an accepted run, and
``speculative_tokens`` through the ``MoE`` facade against the port's plain
facade and the JAX facade. A tiny Mixtral at f32 (the spec of
tests/test_speculative.py), weights made by the JAX model's init_random and
carried over by the bridge, its query and key projections scaled x40 in both
packages so that attention is sharp (a verification step fed wrong
positions would show); the acceptance case keeps init_random's weights,
on which the tiny model loops on a token and drafts are accepted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.entrypoints.api import MoE as JMoE
from moe_infinity_tpu.models.mixtral import MixtralModel as JMixtralModel
from moe_infinity_tpu.models.mixtral import MixtralSpec as JMixtralSpec
from moe_infinity_tpu.runtime.generate import Generator as JGenerator
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu.runtime.speculative import ngram_draft as jngram_draft
from moe_infinity_tpu_torch.entrypoints.api import MoE
from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
from moe_infinity_tpu_torch.runtime.generate import Generator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.runtime.speculative import SpeculativeDecoder, ngram_draft

from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import save_tiny_checkpoint, to_port

SPEC = dict(
    vocab_size=128, hidden_size=48, intermediate_size=96, num_layers=2,
    num_heads=6, num_kv_heads=2, head_dim=8, num_experts=4, top_k=2,
    rms_eps=1e-6, rope_theta=1e4, tie_embeddings=False,
)


class TestNgramDraft:
    @staticmethod
    def _both(ctx, k, **kw):
        got = ngram_draft(np.asarray(ctx), k, **kw)
        want = jngram_draft(np.asarray(ctx), k, **kw)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
        return got

    def test_matches_repeated_span(self):
        d = self._both([1, 2, 3, 9, 9, 1, 2, 3], 2, max_ngram=3)
        np.testing.assert_array_equal(d, [9, 9])  # follows the earlier [1, 2, 3]

    def test_no_match_returns_none(self):
        assert self._both([1, 2, 3, 4, 5], 3) is None

    def test_pads_short_continuation(self):
        d = self._both([7, 8, 5, 7, 8], 4, max_ngram=2)
        np.testing.assert_array_equal(d, [5, 7, 8, 8])


def _generators(sharpen: float):
    jmodel = JMixtralModel(JMixtralSpec(**SPEC), compute_dtype=jnp.float32)
    jparams, jtree = jmodel.init_random(jax.random.PRNGKey(4))
    for layer in jparams["layers"]:
        layer["q"], layer["k"] = layer["q"] * sharpen, layer["k"] * sharpen
    jgen = JGenerator(jmodel, jparams, jtree, JProvider.for_layer, max_seq_len=128)
    model = MixtralModel(MixtralSpec(**SPEC), compute_dtype=torch.float32, device="cpu")
    gen = Generator(model, to_port(jparams), to_port(jtree), ResidentProvider.for_layer,
                    max_seq_len=128)
    return jgen, gen


@pytest.fixture(scope="module")
def setup():
    return _generators(40.0)


@pytest.fixture(scope="module")
def looping():
    """init_random's weights as they are: the tiny model loops on a token."""
    return _generators(1.0)


@pytest.mark.parametrize("k", [2, 4])
def test_exact_greedy_equivalence(setup, k):
    jgen, gen = setup
    spec = SpeculativeDecoder(gen.stepper, spec_tokens=k, max_seq_len=128)
    for prompt in (np.array([5, 31, 8]),
                   np.array([7, 7, 7, 7, 7, 7]),  # repetitive: drafts accept
                   np.array([1, 2, 3, 4, 1, 2, 3, 4, 1, 2])):
        want = jgen.generate(prompt[None], max_new_tokens=16).sequences
        got = spec.generate(prompt[None], max_new_tokens=16)
        np.testing.assert_array_equal(got.sequences, want)


def test_acceptance_happens(looping):
    """The tiny model loops on a token, so the repeat-last draft matches its
    greedy choice: drafts are accepted and 24 tokens take fewer steps."""
    jgen, gen = looping
    spec = SpeculativeDecoder(gen.stepper, spec_tokens=4, max_seq_len=128)
    r = spec.generate(np.array([[5, 31]]), max_new_tokens=24)
    assert r.stats["spec_accepted"] > 0
    assert r.stats["spec_steps"] < 24
    np.testing.assert_array_equal(
        r.sequences, jgen.generate(np.array([[5, 31]]), max_new_tokens=24).sequences)


def test_eos_inside_accepted_run(setup):
    """The first greedy token as EOS: both paths stop at once."""
    jgen, gen = setup
    prompt = np.array([[5, 31, 8]])
    eos = int(jgen.generate(prompt, max_new_tokens=6).sequences[0, 3])
    want = jgen.generate(prompt, max_new_tokens=6, eos_token_id=eos).sequences
    got = SpeculativeDecoder(gen.stepper, spec_tokens=3, max_seq_len=128).generate(
        prompt, max_new_tokens=6, eos_token_id=eos)
    n = min(got.sequences.shape[1], want.shape[1])
    np.testing.assert_array_equal(got.sequences[:, :n], want[:, :n])
    assert got.num_generated[0] == 1


def test_facade_speculative(tmp_path):
    """``speculative_tokens`` through the facade: the port's plain facade's
    tokens, and the JAX speculative facade's."""
    path, _ = save_tiny_checkpoint("mixtral", tmp_path / "ckpt", seed=13)
    base = {"expert_dtype": "float32", "max_seq_len": 64, "max_batch_size": 1}
    plain = MoE(path, dict(base, offload_path=str(tmp_path / "store")), device="cpu")
    spec = MoE(path, dict(base, speculative_tokens=3, offload_path=str(tmp_path / "store")),
               device="cpu")
    jspec = JMoE(path, dict(base, speculative_tokens=3, offload_path=str(tmp_path / "jax")))
    try:
        prompt = np.array([[5, 9, 33, 5, 9]])
        want = plain.generate(prompt, max_new_tokens=10)
        got = spec.generate(prompt, max_new_tokens=10)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jspec.generate(prompt, max_new_tokens=10))
        assert spec.last_result.stats["spec_steps"] >= 1
        assert spec.last_result.stats == jspec.last_result.stats
    finally:
        plain.shutdown()
        spec.shutdown()
        jspec.shutdown()
