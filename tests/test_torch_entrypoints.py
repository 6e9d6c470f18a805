"""The port's ``MoE`` facade and OpenAI server (``moe_infinity_tpu_torch/
entrypoints/``) on the CPU against the JAX package's, mirroring the
single-card tests of tests/test_entrypoints.py on its tiny Mixtral
checkpoint (HF ``MixtralForCausalLM``, seed 1, f32, sharded safetensors):

* greedy tokens equal to the JAX ``MoE``'s and to HF ``generate``: the
  resident plan through the continuous batcher and at ``max_batch_size``
  1, the offload plan per layer, speculative with blocks of 1 and 2 and
  through the batcher over its arena (``max_batch_size`` 2), and prompt-lookup
  speculation (``speculative_tokens``); with prefetch off and one fetch
  worker ``stats()`` equals JAX's; prompt lookup on an offload plan holds
  the arena's client_lock, so concurrent calls never overlap;
* EOS from the config (and a list of EOS ids), ``logit_bias`` forcing and
  banning, sampled requests fixed by their seed;
* the server: greedy JSON equal to the JAX server's apart from ids and
  timestamps, then ``n``, ``best_of``, stop strings, logprobs, chat, chat
  streaming and ``/metrics``;
* DeepSeek-V2 through the facade, resident and offload, against JAX's;
* the long-context lane (``sequence_parallel``) on two gloo ranks, and
  raising beside another degree; the mesh's degrees
  are served, or left unused as the JAX facade leaves them (Grok-1 and
  Arctic are served: tests/test_torch_grok.py and
  tests/test_torch_arctic.py; every load mode is served:
  tests/test_torch_native_store.py and tests/test_torch_native_sched.py;
  ``multihost``: tests/test_torch_pod_engine.py and test_torch_multihost.py).
"""

import concurrent.futures as cf
import copy
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from moe_infinity_tpu.entrypoints.api import MoE as JMoE
from moe_infinity_tpu_torch.entrypoints.api import MoE
from torch_mesh_workers import spawn_ranks
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import save_tiny_checkpoint, word_tokenizer

PROMPT = np.array([[5, 9, 33]])


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    path, hf = save_tiny_checkpoint("mixtral", tmp_path_factory.mktemp("api") / "ckpt", seed=1)
    word_tokenizer(path)
    return path, hf


def _hf(hf, prompt, n, **kw):
    return hf.generate(torch.tensor(prompt), max_new_tokens=n, do_sample=False,
                       pad_token_id=0, **kw).numpy()


def _both(path, tmp_path, cfg):
    """The JAX facade and the port's, each over its own store."""
    j = JMoE(path, dict(cfg, offload_path=str(tmp_path / "jax")))
    p = MoE(path, dict(cfg, offload_path=str(tmp_path / "port")), device="cpu")
    return j, p


BASE = {"expert_dtype": "float32", "max_seq_len": 64}
OFFLOAD = dict(BASE, device_memory_bytes=1, dense_paging="off", prefetch=False, num_threads=1)
# a budget that leaves both facades' paged plans an arena of tens of slots
# (58 at the JAX facade's sizing; the port's takes the tiny store's 8): the
# JAX facade's default 16 GiB sized it at 629,143
PAGED_BUDGET = 1_500_000


@pytest.mark.parametrize("cfg,plan", [
    (dict(BASE, max_batch_size=1), "generator"),
    (dict(BASE, max_batch_size=2, kv_page_size=8), "batcher"),
    (dict(OFFLOAD, num_slots=4), "per-layer"),
    (dict(OFFLOAD, num_slots=8, speculative_decode=True, speculative_block=1,
          max_batch_size=1), "spec-k1"),
    (dict(OFFLOAD, num_slots=8, speculative_decode=True, speculative_block=2,
          max_batch_size=1), "spec-k2"),
    # the batcher over the offload engine's arena (8 slots: both layers' experts)
    (dict(OFFLOAD, num_slots=8, speculative_decode=True, max_batch_size=2,
          kv_page_size=8), "arena-batcher"),
    (dict(BASE, max_batch_size=1, speculative_tokens=2), "prompt-lookup"),
], ids=lambda v: v if isinstance(v, str) else "")
def test_greedy_equals_jax_and_hf(tiny_ckpt, tmp_path, cfg, plan):
    path, hf = tiny_ckpt
    j, p = _both(path, tmp_path, cfg)
    try:
        assert (p.batcher is not None) == plan.endswith("batcher")
        assert (p.engine is not None) == (plan not in ("generator", "batcher", "prompt-lookup"))
        if plan.startswith("spec"):
            assert p.engine.speculative and p.engine.spec_block == cfg["speculative_block"]
        n = 7 if plan.startswith("spec") else 6
        want = _hf(hf, PROMPT, n, eos_token_id=None)
        got = p.generate(PROMPT, max_new_tokens=n, eos_token_id=None)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(j.generate(PROMPT, max_new_tokens=n, eos_token_id=None),
                                      want)
        if p.engine is not None:
            assert p.stats() == j.stats()
            assert p.stats()["visits"] > 0
        else:
            assert p.hit_rate() == 1.0 and p.stats() == {}
        if plan == "prompt-lookup":
            assert p.last_result.stats == j.last_result.stats
            assert p.last_result.stats["spec_steps"] >= 1
        if plan.endswith("batcher"):  # concurrent requests batch and still match
            prompts = [np.array([[5, 9, 33]]), np.array([[7, 21, 4, 90]])]
            with cf.ThreadPoolExecutor(2) as ex:
                gots = list(ex.map(lambda q: p.generate(q, max_new_tokens=5), prompts))
            for q, g in zip(prompts, gots):
                np.testing.assert_array_equal(g, _hf(hf, q, 5))
    finally:
        j.shutdown()
        p.shutdown()


@pytest.fixture(scope="module")
def port_generator(tiny_ckpt, tmp_path_factory):
    path, _ = tiny_ckpt
    p = MoE(path, dict(BASE, max_batch_size=1,
                       offload_path=str(tmp_path_factory.mktemp("gen"))), device="cpu")
    yield p
    p.shutdown()


def test_stops_at_config_eos(tiny_ckpt, tmp_path):
    """HF semantics: eos_token_id defaults from the model config; a head
    biased to EOS stops after one token. A list of EOS ids stops on any."""
    path, hf = tiny_ckpt
    biased = copy.deepcopy(hf)
    eos = biased.config.eos_token_id
    with torch.no_grad():
        biased.lm_head.weight[eos] += 100.0
    ckpt = tmp_path / "eos_ckpt"
    biased.save_pretrained(ckpt, safe_serialization=True)
    p = MoE(str(ckpt), dict(BASE, offload_path=str(tmp_path / "st")), device="cpu")
    try:
        want = _hf(biased, PROMPT, 8)
        assert want.shape[1] == PROMPT.shape[1] + 1
        np.testing.assert_array_equal(p.generate(PROMPT, max_new_tokens=8), want)
        out = p.generate(PROMPT, max_new_tokens=8, eos_token_id=[99, eos])
        assert out.shape[1] == PROMPT.shape[1] + 1 and out[0, -1] == eos
    finally:
        p.shutdown()


def test_logit_bias_forces_and_bans(port_generator, tiny_ckpt):
    p, (_, hf) = port_generator, tiny_ckpt
    forced = p.generate(PROMPT, max_new_tokens=4, logit_bias={100: 100.0})
    assert (forced[0, 3:] == 100).all()
    free = p.generate(PROMPT, max_new_tokens=4, eos_token_id=None)
    banned = p.generate(PROMPT, max_new_tokens=4, eos_token_id=None,
                        logit_bias={int(free[0, 3]): -100.0})
    assert banned[0, 3] != free[0, 3]
    np.testing.assert_array_equal(
        banned, hf.generate(torch.tensor(PROMPT), max_new_tokens=4, do_sample=False,
                            pad_token_id=0, eos_token_id=None,
                            sequence_bias={(int(free[0, 3]),): -100.0}).numpy())


def test_sampled_generate_fixed_by_seed(port_generator):
    kw = dict(max_new_tokens=6, eos_token_id=None, do_sample=True, top_p=0.9, top_k=20)
    a = port_generator.generate(PROMPT, seed=7, **kw)
    assert np.array_equal(a, port_generator.generate(PROMPT, seed=7, **kw))
    assert any(not np.array_equal(a, port_generator.generate(PROMPT, seed=s, **kw))
               for s in (8, 9, 10))
    # temperature 0 is greedy whatever the other knobs say
    np.testing.assert_array_equal(
        port_generator.generate(PROMPT, max_new_tokens=6, eos_token_id=None, temperature=0.0,
                                top_p=0.5, seed=3),
        port_generator.generate(PROMPT, max_new_tokens=6, eos_token_id=None))


def test_deepseek_through_the_facade(tmp_path):
    path, hf = save_tiny_checkpoint("deepseek", tmp_path / "ds", seed=11)
    prompt = np.array([[5, 9, 33, 2]])
    want = _hf(hf, prompt, 6, eos_token_id=None)
    for name, cfg in (("resident", dict(BASE, max_batch_size=1)),
                      ("offload", dict(OFFLOAD, num_slots=8)),
                      ("speculative", dict(OFFLOAD, num_slots=16, speculative_decode=True,
                                           speculative_block=2, max_batch_size=1))):
        j, p = _both(path, tmp_path / name, cfg)
        try:
            got = p.generate(prompt, max_new_tokens=6, eos_token_id=None)
            np.testing.assert_array_equal(
                got, j.generate(prompt, max_new_tokens=6, eos_token_id=None))
            np.testing.assert_array_equal(got, want)
            assert p.stats() == j.stats()
        finally:
            j.shutdown()
            p.shutdown()


# ---------------------------------------------------------------------------
# plans that are not ported raise, naming their item
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg,item", [
    (dict(data_parallel=2), None),
    (dict(multihost=True), "expert_parallel > 1"),
    (dict(expert_parallel=2), None),
    (dict(tensor_parallel=2), None),
    (dict(sequence_parallel=2), "item 18c"),  # the long-context lane, served
    (dict(expert_parallel=2, device_memory_bytes=1, dense_paging="off"), "served"),
    (dict(expert_parallel=2, tensor_parallel=2, dense_paging="on",
          device_memory_bytes=PAGED_BUDGET), "served"),
    (dict(sequence_parallel=2, expert_parallel=2), "exclusive"),
    (dict(sequence_parallel=2, device_memory_bytes=1, dense_paging="off"), "served"),
])
def test_unported_plans_raise(tiny_ckpt, tmp_path, cfg, item):
    """Multihost without an expert axis raises the JAX facade's own
    ``ValueError``, sequence parallelism with another degree its
    ``NotImplementedError``; the resident mesh's degrees are served: two
    gloo ranks on the CPU (tests/torch_mesh_workers.py) each return the
    one-rank facade's greedy tokens, and without a process group of the
    plan's size the facade raises. The long-context lane
    (``sequence_parallel=2``) on two gloo ranks returns the JAX facade's
    greedy tokens for a prompt at least one ring long (through the ring:
    its hops sent bytes) and for a shorter one (the resident path, no hop).
    An offload plan or paged dense layers leave the degrees unused, as the
    JAX facade does (no mesh, no process group needed): the same plan and
    tokens as the JAX facade's."""
    path, _ = tiny_ckpt
    config = dict(BASE, offload_path=str(tmp_path / "st"), **cfg)
    if item == "item 18c":
        prompts = [np.array([[5, 9, 33, 7, 2, 40, 11, 3, 8]]), np.array([[5]])]
        j = JMoE(path, dict(config, offload_path=str(tmp_path / "jax")))
        try:
            want = [j.generate(p, max_new_tokens=6) for p in prompts]
        finally:
            j.shutdown()
        # the store first, on its own: two ranks ingesting one directory race
        MoE(path, dict(BASE, offload_path=config["offload_path"]), device="cpu").shutdown()
        ranks = spawn_ranks("sp_facade", 2, tmp_path / "ranks", dict(
            path=path, config=config, prompts=prompts, new_tokens=6))
        for r, got in enumerate(ranks):
            assert got["lane"] and got["coords"]["seq"] == r
            for toks, w in zip(got["tokens"], want):
                np.testing.assert_array_equal(toks.numpy(), w)
            assert got["hop_bytes"][0] > 0 and got["hop_bytes"][1] == got["hop_bytes"][0]
        return
    if item == "exclusive":
        msg = "sequence_parallel is currently exclusive with data/tensor/expert_parallel"
        with pytest.raises(NotImplementedError, match=msg):
            JMoE(path, dict(config, offload_path=str(tmp_path / "jax")))
        with pytest.raises(NotImplementedError, match=msg):
            MoE(path, config, device="cpu")
        return
    if item is None:
        with pytest.raises(RuntimeError, match="process group"):
            MoE(path, config, device="cpu")
        one = MoE(path, dict(BASE, offload_path=str(tmp_path / "st")), device="cpu")
        try:
            want = one.generate(np.array([[5, 9, 33], [7, 2, 40]]), max_new_tokens=3)
        finally:
            one.shutdown()
        ranks = spawn_ranks("facade", 2, tmp_path / "ranks", dict(
            path=path, config=config, prompt=np.array([[5, 9, 33], [7, 2, 40]]),
            new_tokens=3))
        for r in ranks:
            np.testing.assert_array_equal(r["tokens"].numpy(), want)
        return
    if item == "served":
        j, p = _both(path, tmp_path, dict(BASE, **cfg))
        try:
            assert p.mesh is None and j.mesh is None
            assert type(p.engine).__name__ == type(j.engine).__name__ == "OffloadEngine"
            assert (p.dense_arena is None) == (j.dense_arena is None)
            got = p.generate(PROMPT, max_new_tokens=6, eos_token_id=None)
            np.testing.assert_array_equal(got, j.generate(PROMPT, max_new_tokens=6,
                                                          eos_token_id=None))
        finally:
            j.shutdown()
            p.shutdown()
        return
    if item == "expert_parallel > 1":
        with pytest.raises(ValueError, match=item):
            JMoE(path, dict(config, offload_path=str(tmp_path / "jax")))
        with pytest.raises(ValueError, match=item):
            MoE(path, config, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=item):
        MoE(path, config, device="cpu")


@pytest.mark.parametrize("cfg", [
    dict(dense_paging="on", device_memory_bytes=PAGED_BUDGET),
    dict(device_memory_bytes=1),  # dense_paging "auto" pages, the experts offload
    dict(host_fallback=True),
    dict(device_memory_bytes=1, dense_paging="off", host_fallback=True,
         host_fallback_timeout_s=0.0, prefetch=False),
], ids=["paging-on", "paging-auto", "host-fallback", "fallback-offload"])
def test_paging_and_host_fallback_plans_served(tiny_ckpt, tmp_path, cfg):
    """Plans that raised before dense paging and the host fallback were
    ported: the same tokens as the JAX facade and HF, the same plan."""
    path, hf = tiny_ckpt
    j, p = _both(path, tmp_path, dict(BASE, **cfg))
    try:
        assert (p.dense_arena is None) == (j.dense_arena is None)
        assert (p.engine is None) == (j.engine is None)
        if p.engine is not None and hasattr(p.engine, "host_fallback"):
            assert p.engine.host_fallback == j.engine.host_fallback
        got = p.generate(PROMPT, max_new_tokens=6, eos_token_id=None)
        np.testing.assert_array_equal(got, j.generate(PROMPT, max_new_tokens=6,
                                                      eos_token_id=None))
        np.testing.assert_array_equal(got, _hf(hf, PROMPT, 6, eos_token_id=None))
    finally:
        j.shutdown()
        p.shutdown()


# Grok-1, Arctic and OPT are served (tests/test_torch_grok.py,
# test_torch_arctic.py, test_torch_opt.py); OPT's post-norm variant (350m) is
# not, in either package, and is refused before anything is ingested
@pytest.mark.parametrize("arch", ["OPTForCausalLM"])
def test_unported_families_raise(tmp_path, arch):
    (tmp_path / "config.json").write_text(json.dumps(
        {"architectures": [arch], "do_layer_norm_before": False}))
    with pytest.raises(NotImplementedError, match="post-norm"):
        MoE(str(tmp_path), {"offload_path": str(tmp_path / "st")}, device="cpu")
    assert not (tmp_path / "st").exists()


def test_package_exports_the_entry_point():
    import moe_infinity_tpu_torch

    from moe_infinity_tpu_torch import MoE as top

    assert top is MoE and "MoE" in moe_infinity_tpu_torch.__all__
    with pytest.raises(AttributeError):
        moe_infinity_tpu_torch.NotAName  # noqa: B018


def test_cuda_without_a_card_raises(tiny_ckpt, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MoE(tiny_ckpt[0], dict(BASE, offload_path=str(tmp_path)))


# ---------------------------------------------------------------------------
# the server, against the JAX server
# ---------------------------------------------------------------------------


def _serve(build, engine, tokenizer):
    srv = build(engine, tokenizer, "tiny-mixtral", "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def servers(tiny_ckpt, tmp_path_factory):
    """The JAX and the port's server over the default resident plan (a
    continuous batcher of 8 slots), one word-level tokenizer."""
    from transformers import AutoTokenizer

    from moe_infinity_tpu.entrypoints.openai.server import build_server as j_build
    from moe_infinity_tpu_torch.entrypoints.openai.server import build_server as p_build

    path, _ = tiny_ckpt
    tmp = tmp_path_factory.mktemp("srv")
    j, p = _both(path, tmp, dict(BASE, kv_page_size=8))
    assert p.batcher is not None
    tok = AutoTokenizer.from_pretrained(path)
    js, ju = _serve(j_build, j, tok)
    ps, pu = _serve(p_build, p, tok)
    yield ju, pu, p, tok
    js.shutdown()
    ps.shutdown()
    j.shutdown()
    p.shutdown()


def _post(url, payload, raw=False):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.status == 200
        body = r.read()
    return body.decode() if raw else json.loads(body)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        assert r.status == 200
        return json.loads(r.read())


def _strip(resp):
    return {k: v for k, v in resp.items() if k not in ("id", "created")}


@pytest.mark.parametrize("route,payload", [
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 4, "temperature": 0.0}),
    ("/v1/completions", {"prompt": ["tok3 tok9", "hello"], "max_tokens": 3,
                         "temperature": 0.0, "echo": True}),
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 3, "temperature": 0.0,
                         "logit_bias": {"126": 100.0}}),
    ("/v1/completions", {"prompt": "tok5 tok9 tok33", "max_tokens": 6, "temperature": 0.0,
                         "stop": ["tok97"]}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hello"}],
                              "max_tokens": 4, "temperature": 0.0}),
])
def test_greedy_json_equals_jax_server(servers, route, payload):
    ju, pu, _, _ = servers
    assert _strip(_post(pu + route, payload)) == _strip(_post(ju + route, payload))


def test_health_models_and_metrics(servers):
    ju, pu, _, _ = servers
    assert _get(pu + "/health") == _get(ju + "/health") == {"status": "ok"}
    assert _get(pu + "/v1/models") == _get(ju + "/v1/models")
    _post(pu + "/v1/completions", {"prompt": "hello", "max_tokens": 2, "temperature": 0.0,
                                   "logit_bias": {"124": -100}})
    m = _get(pu + "/metrics")
    assert m["requests"] >= 1 and m["tokens_generated"] >= 2 and m["model"] == "tiny-mixtral"
    assert m["expert_cache"] == {}


def test_logprobs_equal_jax_server(servers):
    ju, pu, _, _ = servers
    payload = {"prompt": "hello world", "max_tokens": 4, "temperature": 0.0, "logprobs": 3}
    a, b = _post(pu + "/v1/completions", payload), _post(ju + "/v1/completions", payload)
    la, lb = a["choices"][0]["logprobs"], b["choices"][0]["logprobs"]
    assert a["choices"][0]["text"] == b["choices"][0]["text"]
    assert la["tokens"] == lb["tokens"] and la["text_offset"] == lb["text_offset"]
    np.testing.assert_allclose(la["token_logprobs"], lb["token_logprobs"], atol=1e-5)
    for ta, tb in zip(la["top_logprobs"], lb["top_logprobs"]):
        assert list(ta) == list(tb) and len(ta) == 3
        np.testing.assert_allclose(list(ta.values()), list(tb.values()), atol=1e-5)
    for tok_lp, tops in zip(la["token_logprobs"], la["top_logprobs"]):
        assert abs(tok_lp - max(tops.values())) < 1e-4


def test_sampled_n_and_best_of(servers):
    _, pu, _, _ = servers
    payload = {"prompt": "hello world", "max_tokens": 6, "temperature": 0.8, "top_p": 0.9,
               "top_k": 20, "presence_penalty": 0.3, "frequency_penalty": 0.2,
               "repetition_penalty": 1.1, "seed": 7}
    a = _post(pu + "/v1/completions", payload)
    assert a["choices"][0]["text"] == _post(pu + "/v1/completions", payload)["choices"][0]["text"]
    n3 = _post(pu + "/v1/completions", {"prompt": "hello world", "max_tokens": 4,
                                        "temperature": 0.9, "n": 3, "seed": 2, "logprobs": 2})
    assert [c["index"] for c in n3["choices"]] == [0, 1, 2]
    assert n3["usage"]["completion_tokens"] >= 3
    assert all(len(c["logprobs"]["tokens"]) > 0 for c in n3["choices"])
    best = {"prompt": "hello world", "max_tokens": 4, "temperature": 1.2, "n": 1,
            "best_of": 4, "seed": 3}
    r1, r2 = _post(pu + "/v1/completions", best), _post(pu + "/v1/completions", best)
    assert len(r1["choices"]) == 1 and r1["choices"][0]["text"] == r2["choices"][0]["text"]
    # the OpenAI default temperature (1.0) samples
    d = _post(pu + "/v1/completions", {"prompt": "hello world", "max_tokens": 4, "seed": 1})
    assert d["object"] == "text_completion"


def test_stop_string(servers):
    _, pu, _, _ = servers
    free = _post(pu + "/v1/completions", {"prompt": "tok5 tok9 tok33", "max_tokens": 6,
                                          "temperature": 0.0})["choices"][0]["text"]
    first = free.split()[0]
    resp = _post(pu + "/v1/completions", {"prompt": "tok5 tok9 tok33", "max_tokens": 6,
                                          "temperature": 0.0, "stop": [first]})
    assert first not in resp["choices"][0]["text"]
    assert resp["choices"][0]["finish_reason"] == "stop"


def test_chat_streaming_joins_to_the_chat_text(servers):
    ju, pu, p, tok = servers
    req = {"messages": [{"role": "user", "content": "hello world"}], "max_tokens": 4,
           "temperature": 0.0, "logit_bias": {"124": -100}}
    plain = _post(pu + "/v1/chat/completions", req)["choices"][0]["message"]["content"]
    body = _post(pu + "/v1/chat/completions", dict(req, stream=True), raw=True)
    chunks = [json.loads(line[6:]) for line in body.splitlines()
              if line.startswith("data: ") and line != "data: [DONE]"]
    deltas = [c["choices"][0]["delta"].get("content") for c in chunks
              if c["choices"][0]["delta"].get("content")]
    assert " ".join(deltas) == plain and len(deltas) == 4
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop" and "data: [DONE]" in body
    ids = tok("user: hello world\nassistant:", return_tensors="np").input_ids
    ref = p.generate(ids, max_new_tokens=4, logit_bias={124: -100})[0, ids.shape[1]:]
    assert deltas == [tok.decode([int(t)]) for t in ref]
    jbody = _post(ju + "/v1/chat/completions", dict(req, stream=True), raw=True)
    jchunks = [_strip(json.loads(line[6:])) for line in jbody.splitlines()
               if line.startswith("data: ") and line != "data: [DONE]"]
    assert [_strip(c) for c in chunks] == jchunks


def test_offload_prompt_lookup_holds_the_client_lock(tiny_ckpt, tmp_path):
    """Prompt lookup on an offload plan at ``max_batch_size`` 1: two
    concurrent ``generate`` calls never run the engine's forward at once
    (each holds the arena's client_lock), and each gives HF's tokens."""
    path, hf = tiny_ckpt
    p = MoE(path, dict(OFFLOAD, num_slots=8, speculative_tokens=2, max_batch_size=1,
                       offload_path=str(tmp_path)), device="cpu")
    forward = p.engine.forward
    guard = threading.Lock()
    state = {"inside": 0, "most": 0, "calls": 0}

    def watched(*a, **k):
        with guard:
            state["inside"] += 1
            state["calls"] += 1
            state["most"] = max(state["most"], state["inside"])
        try:
            time.sleep(0.01)  # widen the window another caller could enter
            return forward(*a, **k)
        finally:
            with guard:
                state["inside"] -= 1

    try:
        assert p.engine is not None and p.batcher is None
        p.engine.forward = watched
        prompts = [np.array([[5, 9, 33, 5, 9]]), np.array([[7, 21, 4, 7, 21]])]
        with cf.ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(p.generate, q, max_new_tokens=6, eos_token_id=None)
                    for q in prompts]
            gots = [f.result(timeout=120) for f in futs]
        assert state["calls"] >= 4 and state["most"] == 1
        for q, g in zip(prompts, gots):
            np.testing.assert_array_equal(g, _hf(hf, q, 6, eos_token_id=None))
        assert p.last_result.stats["spec_steps"] >= 1
    finally:
        p.shutdown()


def test_offload_server_serializes_requests(tiny_ckpt, tmp_path):
    """An offload plan has no batcher: requests serialize on the engine lock
    and the arena's client_lock, and their text equals the facade's."""
    from transformers import AutoTokenizer

    from moe_infinity_tpu_torch.entrypoints.openai.server import build_server

    path, _ = tiny_ckpt
    p = MoE(path, dict(OFFLOAD, num_slots=4, offload_path=str(tmp_path)), device="cpu")
    tok = AutoTokenizer.from_pretrained(path)
    srv, url = _serve(build_server, p, tok)
    try:
        prompts = ["hello world", "tok7 tok21 tok4"]
        payloads = [{"prompt": q, "max_tokens": 4, "temperature": 0.0} for q in prompts]
        with cf.ThreadPoolExecutor(2) as ex:
            outs = list(ex.map(lambda d: _post(url + "/v1/completions", d), payloads))
        for q, o in zip(prompts, outs):
            ids = tok(q, return_tensors="np").input_ids
            gen = p.generate(ids, max_new_tokens=4, eos_token_id=tok.eos_token_id)[0, ids.shape[1]:]
            gen = [int(t) for t in gen if t != tok.eos_token_id]
            assert o["choices"][0]["text"] == tok.decode(gen, skip_special_tokens=True)
        assert _get(url + "/metrics")["expert_cache"]["visits"] > 0
    finally:
        srv.shutdown()
        p.shutdown()
