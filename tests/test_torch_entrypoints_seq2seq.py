"""The port's ``MoE`` facade on encoder-decoder checkpoints (Switch, NLLB)
on the CPU against the JAX facade, mirroring
tests/test_entrypoints_seq2seq.py: at f32 and ``max_batch_size`` 1 the
port's greedy tokens equal the JAX facade's (and HF ``generate``'s) on the
resident plan (``Seq2SeqGenerator``) and on the offload plan
(``Seq2SeqOffloadEngine``, per layer and speculative), with equal expert
counters when prefetch is off; sampled and penalised requests with logprobs
run through both plans. Mirroring the rest of that file: at the default
``max_batch_size`` (8) concurrent greedy requests from threads batch
through ``Seq2SeqContinuousBatcher`` (``s2s_batcher="wave"``: the wave
batcher), and an offload plan with ``speculative_decode`` batches them over
the engine's arena; each equals HF ``generate`` and the JAX facade's
tokens. Requests the batchers do not take go to the generator."""

import concurrent.futures as cf

import numpy as np
import pytest
import torch

from moe_infinity_tpu.entrypoints.api import MoE as JMoE
from moe_infinity_tpu_torch.entrypoints.api import MoE
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import save_tiny_checkpoint

PROMPT = np.array([[5, 31, 8, 77]])
BASE = {"expert_dtype": "float32", "max_batch_size": 1}
PLANS = {
    "resident": BASE,
    "offload": dict(BASE, device_memory_bytes=1, dense_paging="off", num_slots=4,
                    prefetch=False, num_threads=1),
    "speculative": dict(BASE, device_memory_bytes=1, dense_paging="off", num_slots=8,
                        prefetch=False, num_threads=1, speculative_decode=True,
                        speculative_block=2),
}


@pytest.fixture(scope="module", params=["switch", "nllb"])
def ckpt(request, tmp_path_factory):
    path, hf = save_tiny_checkpoint(request.param, tmp_path_factory.mktemp(request.param) / "c",
                                    seed=3)
    with torch.no_grad():
        want = hf.generate(torch.tensor(PROMPT), max_new_tokens=6, do_sample=False).numpy()
    return request.param, path, want


@pytest.mark.parametrize("plan", list(PLANS))
def test_greedy_equals_jax_facade(ckpt, tmp_path, plan):
    family, path, want = ckpt
    cfg = PLANS[plan]
    j = JMoE(path, dict(cfg, offload_path=str(tmp_path / "jax")))
    p = MoE(path, dict(cfg, offload_path=str(tmp_path / "port")), device="cpu")
    try:
        assert p.arch == family and (p.engine is not None) == (plan != "resident")
        got = p.generate(PROMPT, max_new_tokens=6)
        np.testing.assert_array_equal(got, j.generate(PROMPT, max_new_tokens=6))
        n = min(got.shape[1], want.shape[1])
        np.testing.assert_array_equal(got[:, :n], want[:, :n])
        assert p.stats() == j.stats()
        if plan != "resident":
            assert p.stats()["visits"] > 0
        # a greedy request with a penalty and logprobs: same tokens and
        # logprobs as the JAX facade's (one token a step, no blocks)
        kw = dict(max_new_tokens=5, repetition_penalty=1.3, logprobs=3, eos_token_id=None)
        np.testing.assert_array_equal(p.generate(PROMPT, **kw), j.generate(PROMPT, **kw))
        r, jr = p.last_result, j.last_result
        np.testing.assert_array_equal(r.top_tokens, jr.top_tokens)
        np.testing.assert_allclose(r.token_logprobs, jr.token_logprobs, atol=1e-5)
        # sampled: fixed by the seed
        skw = dict(max_new_tokens=5, do_sample=True, top_k=8, seed=5, eos_token_id=None)
        np.testing.assert_array_equal(p.generate(PROMPT, **skw), p.generate(PROMPT, **skw))
    finally:
        j.shutdown()
        p.shutdown()


def test_seq2seq_batchers_raise(ckpt, tmp_path):
    """The continuous batcher refuses a source past ``max_src_len`` and a
    budget past its cache; the facade sends such requests, and any it does
    not batch (sampled, with an attention mask), to the generator."""
    from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher

    _, path, _ = ckpt
    p = MoE(path, {"expert_dtype": "float32", "max_seq_len": 16,
                   "offload_path": str(tmp_path)}, device="cpu")
    try:
        assert isinstance(p.s2s_batcher, Seq2SeqContinuousBatcher)
        with pytest.raises(ValueError, match="max_src_len"):
            p.s2s_batcher.submit(np.arange(3, 20), max_new_tokens=4)
        with pytest.raises(ValueError, match="capacity"):
            p.s2s_batcher.submit(PROMPT[0], max_new_tokens=16)
        steps = p.s2s_batcher.step_stats()["steps"]
        ref = p.generator.generate(PROMPT, max_new_tokens=4, eos_token_id=None).sequences
        for kw in (dict(attention_mask=np.ones_like(PROMPT)), dict(repetition_penalty=1.3)):
            out = p.generate(PROMPT, max_new_tokens=4, eos_token_id=None, **kw)
            assert out.shape == (1, 5)
        np.testing.assert_array_equal(
            p.generate(PROMPT, max_new_tokens=4, eos_token_id=None, attention_mask=np.ones_like(
                PROMPT)), ref)
        assert p.s2s_batcher.step_stats()["steps"] == steps  # none went through the batcher
    finally:
        p.shutdown()


CONCURRENT = [np.array([[5, 31, 8, 77]]), np.array([[9, 4, 61]]), np.array([[12, 3, 44, 7, 90]])]


def _hf_each(hf, prompts, n):
    with torch.no_grad():
        return [hf.generate(torch.tensor(q), max_new_tokens=n, do_sample=False).numpy()
                for q in prompts]


def _concurrently(engine, prompts, n, **kw):
    with cf.ThreadPoolExecutor(len(prompts)) as ex:
        futs = [ex.submit(engine.generate, q, max_new_tokens=n, **kw) for q in prompts]
        return [f.result(timeout=120) for f in futs]


def _prefix_equal(got, want):
    n = min(got.shape[1], want.shape[1])
    np.testing.assert_array_equal(got[:, :n], want[:, :n])


@pytest.mark.parametrize("batcher", ["continuous", "wave"])
def test_concurrent_batching_equals_jax_facade(ckpt, tmp_path, batcher):
    """The facade at its default max_batch_size: concurrent greedy calls
    batch and each equals HF's and the JAX facade's tokens."""
    from moe_infinity_tpu_torch.runtime.batching import Seq2SeqDynamicBatcher
    from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher

    _, path, _ = ckpt
    hf = _hf_model(path)
    cfg = {"expert_dtype": "float32", "s2s_batcher": batcher}
    j = JMoE(path, dict(cfg, offload_path=str(tmp_path / "jax")))
    p = MoE(path, dict(cfg, offload_path=str(tmp_path / "port")), device="cpu")
    try:
        cls = Seq2SeqContinuousBatcher if batcher == "continuous" else Seq2SeqDynamicBatcher
        assert isinstance(p.s2s_batcher, cls) and p.engine is None
        gots = _concurrently(p, CONCURRENT, 6)
        for q, got, want in zip(CONCURRENT, gots, _hf_each(hf, CONCURRENT, 6)):
            _prefix_equal(got, want)
            np.testing.assert_array_equal(got, j.generate(q, max_new_tokens=6))
        if batcher == "continuous":
            assert p.s2s_batcher.step_stats()["joins"] == len(CONCURRENT)
    finally:
        j.shutdown()
        p.shutdown()


def test_offload_continuous_batching(ckpt, tmp_path):
    """An offload plan with speculative_decode and batch slots: the
    continuous batcher serves concurrent requests over the engine's arena,
    equal to HF's and the JAX facade's tokens."""
    from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher

    _, path, _ = ckpt
    hf = _hf_model(path)
    cfg = {"expert_dtype": "float32", "device_memory_bytes": 1, "dense_paging": "off",
           "num_slots": 6, "speculative_decode": True, "max_batch_size": 2, "max_seq_len": 32}
    j = JMoE(path, dict(cfg, offload_path=str(tmp_path / "jax")))
    p = MoE(path, dict(cfg, offload_path=str(tmp_path / "port")), device="cpu")
    try:
        assert isinstance(p.s2s_batcher, Seq2SeqContinuousBatcher)
        assert p.s2s_batcher.engine is p.engine
        prompts = CONCURRENT[:2]
        gots = _concurrently(p, prompts, 6)
        for q, got, want in zip(prompts, gots, _hf_each(hf, prompts, 6)):
            _prefix_equal(got, want)
            np.testing.assert_array_equal(got, j.generate(q, max_new_tokens=6))
        assert p.s2s_batcher.replay_counts
        assert p.stats().get("speculative_steps", 0) > 0
    finally:
        j.shutdown()
        p.shutdown()


def test_concurrent_generator_requests_with_graphs(ckpt, tmp_path, monkeypatch):
    """Fault F3 through the facade: at ``max_batch_size`` 1 every request
    goes to the resident generator, whose decode runs as graphs (the CPU
    stand-in backend, as on the card) over buffers shared per shape.
    Concurrent calls from threads, several per prompt, each equal the same
    prompt's call alone. The tiny checkpoints' weights are sharpened in
    place (``sharpen_seq2seq``) so that tokens depend on the prompt."""
    from moe_infinity_tpu_torch.runtime import generate
    from torch_port_helpers import StandIn, sharpen_seq2seq

    init = generate.Seq2SeqGenerator.__init__

    def with_backend(self, *a, **kw):
        init(self, *a, graph_backend=StandIn(), **kw)

    monkeypatch.setattr(generate.Seq2SeqGenerator, "__init__", with_backend)
    _, path, _ = ckpt
    p = MoE(path, {"expert_dtype": "float32", "max_batch_size": 1, "moe_impl": "pallas",
                   "offload_path": str(tmp_path)}, device="cpu")
    try:
        assert p.generator.graphs is not None and p.s2s_batcher is None
        sharpen_seq2seq(p.params)  # the generator's own dict
        prompts = [CONCURRENT[0], CONCURRENT[2]]
        alone = [p.generate(q, max_new_tokens=12, eos_token_id=None) for q in prompts]
        assert not np.array_equal(alone[0][:, 1:], alone[1][:, 1:])
        got = _concurrently(p, prompts * 4, 12, eos_token_id=None)
        for i, out in enumerate(got):
            np.testing.assert_array_equal(out, alone[i % 2])
    finally:
        p.shutdown()


def _hf_model(path):
    import transformers

    cfg = transformers.AutoConfig.from_pretrained(path)
    cls = getattr(transformers, cfg.architectures[0])
    return cls.from_pretrained(path).eval()
