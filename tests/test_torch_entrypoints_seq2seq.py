"""The port's ``MoE`` facade on encoder-decoder checkpoints (Switch, NLLB)
on the CPU against the JAX facade, mirroring
tests/test_entrypoints_seq2seq.py: at f32 and ``max_batch_size`` 1 the
port's greedy tokens equal the JAX facade's (and HF ``generate``'s) on the
resident plan (``Seq2SeqGenerator``) and on the offload plan
(``Seq2SeqOffloadEngine``, per layer and speculative), with equal expert
counters when prefetch is off; sampled and penalised requests with logprobs
run through both plans; ``max_batch_size`` > 1 raises, naming item 15."""

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
    _, path, _ = ckpt
    for cfg in ({"expert_dtype": "float32"},  # max_batch_size 8 by default
                dict(PLANS["offload"], max_batch_size=4)):
        with pytest.raises(NotImplementedError, match="item 15"):
            MoE(path, dict(cfg, offload_path=str(tmp_path)), device="cpu")
