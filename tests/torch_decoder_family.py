"""Shared parity checks of the port's Grok-1 and Arctic models against the
JAX package's (tests/test_torch_grok.py, tests/test_torch_arctic.py): the
same tiny models built in both packages from the JAX model's init_random
(through the bridge), expert stores written from that tree with the JAX
ExpertStoreWriter (``write_decoder_store``), and greedy tokens compared
through ``Generator``, ``ContinuousBatcher`` and the ``OffloadEngine``; with
prefetch off and one fetch worker the engine's executions and counters must
equal the JAX engine's. Tiny seed-written checkpoints of both families feed
the ``MoE`` facades. Everything runs at f32 on the CPU unless a case says
otherwise."""

from __future__ import annotations

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
from moe_infinity_tpu.runtime.engine import OffloadEngine as JEngine
from moe_infinity_tpu.runtime.generate import Generator as JGenerator
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.continuous import ContinuousBatcher
from moe_infinity_tpu_torch.runtime.engine import OffloadEngine
from moe_infinity_tpu_torch.runtime.generate import Generator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store.blob import ExpertStore

from torch_port_helpers import StandIn, to_port, write_decoder_store  # noqa: F401

ONE = np.array([[5, 17, 31, 7]])
TWO = np.array([[5, 17, 31, 7], [9, 4, 2, 61]])
QUANTS = ("float32", "int8", "float8_e4m3fn")


class Family:
    """One family's tiny model in both packages and its expert stores."""

    def __init__(self, arch, jmodel, model, seed, root, sharpen=40.0):
        self.arch, self.jmodel, self.model = arch, jmodel, model
        self.jparams, jtree = jmodel.init_random(jax.random.PRNGKey(seed))
        # sharper attention (x40 on the query and key projections, in both
        # packages): with std-0.02 weights it is near uniform, and a wrong
        # position, mask or softcap would go unseen
        for layer in self.jparams["layers"]:
            layer["q"], layer["k"] = layer["q"] * sharpen, layer["k"] * sharpen
        self.jtree = jtree
        self.params = to_port(self.jparams)
        self.tree = to_port(jtree)
        self.E = model.spec.num_experts
        self.stores = {q: write_decoder_store(root / q, jtree["layers"], arch, q)
                       for q in QUANTS}

    def resident(self, quant="float32", impl="ragged"):
        """The port's resident Generator over ``quant``'s store."""
        provider = ResidentProvider.from_store(ExpertStore(self.stores[quant]),
                                               dtype=torch.float32, device="cpu")
        return Generator(self.model, self.params, provider.pytree(),
                         ResidentProvider.for_layer, impl=impl, max_seq_len=64)

    def jax_resident(self, quant="float32", impl="ragged"):
        provider = JProvider(JStore(self.stores[quant]), dtype=jnp.float32)
        return JGenerator(self.jmodel, self.jparams, provider.pytree(), JProvider.for_layer,
                          impl=impl, max_seq_len=64)

    def engines(self, quant, slots, **kw):
        """(port engine, JAX engine) over ``quant``'s store: one fetch
        worker, no prefetch, a tracer each."""
        from moe_infinity_tpu.memory import ExpertPredictor as JPredictor
        from moe_infinity_tpu.memory import ExpertTracer as JTracer
        from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer

        path = self.stores[quant]
        n = ExpertStore(path).num_layers
        arena = ExpertArena(ExpertStore(path), slots, compute_dtype=torch.float32,
                            device="cpu", num_threads=1)
        jarena = JArena(JStore(path), slots, compute_dtype=jnp.float32, num_threads=1)
        tr, jtr = ExpertTracer(16, n, self.E), JTracer(16, n, self.E)
        graphs = kw.pop("graphs", False)
        backend = kw.pop("graph_backend", None)
        eng = OffloadEngine(self.model, self.params, arena, tracer=tr,
                            predictor=ExpertPredictor(tr), prefetch=False, graphs=graphs,
                            graph_backend=backend, **kw)
        jeng = JEngine(self.jmodel, self.jparams, jarena, tracer=jtr,
                       predictor=JPredictor(jtr), prefetch=False, **kw)
        return eng, jeng


def jax_pallas_interpreted(monkeypatch):
    """Run the JAX package's K3 (``gffn_pallas``) in interpret mode, as its
    own CPU tests do."""
    import functools

    from moe_infinity_tpu.ops import gmm as jgmm

    monkeypatch.setattr(jgmm, "gffn_pallas", functools.partial(jgmm.gffn_pallas,
                                                               interpret=True))


def run_engines(eng, jeng, prompt, n, **kw):
    """(port tokens, JAX tokens) of one greedy request through each engine's
    Generator; both arenas are shut down afterwards."""
    try:
        want = JGenerator(stepper=jeng, max_seq_len=64).generate(prompt, max_new_tokens=n, **kw)
        got = Generator(stepper=eng, max_seq_len=64).generate(prompt, max_new_tokens=n, **kw)
        return got.sequences, want.sequences
    finally:
        eng.arena.shutdown()
        jeng.arena.shutdown()


def same_counters(eng, jeng):
    assert eng.replay_counts == jeng.replay_counts
    assert eng.stats() == jeng.stats()
    assert eng.hit_rate() == jeng.hit_rate()
    got_ns, want_ns = eng.node_stats(), jeng.node_stats()
    for k in want_ns:
        np.testing.assert_array_equal(got_ns[k], want_ns[k], err_msg=k)


def batcher_against_jax(fam: Family, chunk: int):
    """Two requests through the port's ContinuousBatcher, the second seated
    while the first decodes (chunked prefill of ``chunk`` tokens), against
    the JAX Generator's isolated runs, as
    tests/test_continuous.py::test_continuous_grok_arctic does."""
    jgen = JGenerator(fam.jmodel, fam.jparams, fam.jtree, JProvider.for_layer, max_seq_len=64)
    p1, p2 = np.array([5, 31, 8, 7, 2]), np.array([9, 3, 44])
    want1 = jgen.generate(p1[None], max_new_tokens=6).sequences[0]
    want2 = jgen.generate(p2[None], max_new_tokens=5).sequences[0]
    b = ContinuousBatcher(fam.model, fam.params, fam.tree, ResidentProvider.for_layer,
                          max_batch_size=2, page_size=8, num_pages=48, max_cols=96,
                          prefill_chunk=chunk)
    try:
        holder, ready, seen = {}, threading.Event(), []

        def on_token(tok):
            seen.append(tok)
            if len(seen) == 2:
                holder["f"] = b.submit(p2, max_new_tokens=5)
                ready.set()

        f1 = b.submit(p1, max_new_tokens=6, on_token=on_token)
        np.testing.assert_array_equal(f1.result(timeout=120), want1)
        assert ready.wait(60)
        np.testing.assert_array_equal(holder["f"].result(timeout=120), want2)
    finally:
        b.shutdown()


# ---------------------------------------------------------------------------
# tiny seed-written checkpoints of the two families
# ---------------------------------------------------------------------------

def write_checkpoint(path, config: dict, tensors: dict) -> str:
    """``config.json`` and the tensors (numpy f32) as two safetensors shards
    with an index."""
    from safetensors.numpy import save_file

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    names = sorted(tensors)
    half = len(names) // 2
    weight_map = {}
    for i, part in enumerate((names[:half], names[half:])):
        fname = f"model-{i + 1:05d}-of-00002.safetensors"
        save_file({n: np.ascontiguousarray(tensors[n]) for n in part}, str(path / fname))
        weight_map.update({n: fname for n in part})
    (path / "model.safetensors.index.json").write_text(
        json.dumps({"metadata": {}, "weight_map": weight_map}))
    return str(path)


def random_tensors(shapes: dict, seed: int, qk_scale: float = 40.0) -> dict:
    """f32 tensors normal with std 0.02 (norm scales one, the query and key
    projections x ``qk_scale``), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if len(shape) == 1:
            out[name] = np.ones(shape, np.float32)
            continue
        a = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        if ".q_proj." in name or ".k_proj." in name:
            a *= qk_scale
        out[name] = a
    return out


def facades(path, tmp_path, cfg):
    """The JAX ``MoE`` and the port's over the same checkpoint, each with its
    own store."""
    from moe_infinity_tpu.entrypoints.api import MoE as JMoE
    from moe_infinity_tpu_torch.entrypoints.api import MoE

    j = JMoE(path, dict(cfg, offload_path=str(tmp_path / "jax")))
    p = MoE(path, dict(cfg, offload_path=str(tmp_path / "port")), device="cpu")
    return j, p


def facade_tokens_equal(p, j, prompt, exact: bool, n: int = 6):
    """Greedy tokens of the port's facade ``p`` against the JAX facade ``j``.
    ``exact`` (f32 compute): every token equal. Else (bf16 compute, the
    facades' rule for quantized experts) the prefill's top-2 log-probs agree
    within 2e-2 (the JAX suite's bf16 tolerance) and its token is equal
    unless the JAX run's top-2 margin is below that; later steps are not
    held, since the two frameworks round bf16 at different places and the
    differences compound over the steps (exactness with quantized experts is
    held at f32 by the engine tests)."""
    kw = dict(max_new_tokens=n, eos_token_id=None)
    if exact:
        np.testing.assert_array_equal(p.generate(prompt, **kw), j.generate(prompt, **kw))
        return
    a = p.generator.generate(prompt, logprobs=2, **kw)
    b = j.generator.generate(prompt, logprobs=2, **kw)
    lp_a, lp_b = np.asarray(a.top_logprobs)[0, 0], np.asarray(b.top_logprobs)[0, 0]
    np.testing.assert_allclose(lp_a, lp_b, rtol=0, atol=2e-2)
    if lp_b[0] - lp_b[1] >= 2e-2:
        t = prompt.shape[1]
        assert a.sequences[0, t] == b.sequences[0, t]


def stores_byte_equal(tmp_path):
    """The port's ingest wrote the JAX ingest's files."""
    for f in ("experts.blob", "experts.index.json", "dense.blob", "dense.index.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
