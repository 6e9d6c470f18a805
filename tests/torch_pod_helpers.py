"""Helpers of the pod tests (tests/test_torch_pod_engine.py,
tests/test_torch_pod_tp.py): a gated store, the JAX package's pod engine
and the port's ranks as threads (``ThreadMesh``) run alike on a tiny Mixtral
store, the comparison of the two, and the facade's ``multihost`` plan on a
thread per rank. pytest does not collect it (no ``test_`` prefix)."""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import torch

from moe_infinity_tpu.models.mixtral import MixtralModel as JMixtral
from moe_infinity_tpu.models.mixtral import MixtralSpec as JSpec
from moe_infinity_tpu.parallel import MeshPlan as JPlan
from moe_infinity_tpu.parallel import make_mesh as jmake_mesh
from moe_infinity_tpu.parallel.pod import PodOffloadExecutor as JExec
from moe_infinity_tpu.runtime.generate import Generator as JGenerator
from moe_infinity_tpu.runtime.pod_engine import PodOffloadEngine as JPodEngine
from moe_infinity_tpu.store.blob import DenseArchive as JDense
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu.store.ingest import ingest_checkpoint as jingest
from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
from moe_infinity_tpu_torch.parallel.pod import PodOffloadExecutor
from moe_infinity_tpu_torch.runtime.generate import Generator
from moe_infinity_tpu_torch.runtime.pod_engine import PodOffloadEngine
from moe_infinity_tpu_torch.store.blob import DenseArchive, ExpertStore
from torch_port_helpers import ThreadMesh, run_ranks, save_tiny_checkpoint

E = 4
PROMPT = np.array([[5, 9, 33, 7]])
TWO = np.array([[5, 9, 33, 7], [3, 14, 15, 9]])
NEW = 6
CAP = 64


def tiny_mixtral(root, expert_dtypes=("float32",)):
    """(HF config, HF model, {expert dtype: store dir}, checkpoint path): the
    tiny Mixtral of tests/test_pod_engine.py (seed 7), ingested by the JAX
    ingest once per expert dtype."""
    from transformers import AutoConfig

    path, hf = save_tiny_checkpoint("mixtral", root / "ckpt", seed=7)
    cfg = AutoConfig.from_pretrained(path)
    stores = {}
    for dt in expert_dtypes:
        stores[dt] = str(root / f"store_{dt}")
        jingest(path, stores[dt], cfg, expert_dtype=dt, dense_dtype="float32")
    return cfg, hf, stores, path


class Gate:
    """Holds every fetch of a gated store until ``release``: the arena's
    fetch workers (threads named ``arena-fetch-*``) wait, every other reader
    (the host executor's) passes at once."""

    def __init__(self):
        self.open = threading.Event()

    def wait(self):
        if threading.current_thread().name.startswith("arena-fetch"):
            self.open.wait(timeout=120.0)

    def release(self):
        self.open.set()


def gated(base):
    class GatedStore(base):
        gate = None

        def get_expert(self, layer, expert, prio=0, gen=0):
            if self.gate is not None:
                self.gate.wait()
            return super().get_expert(layer, expert, prio=prio, gen=gen)

    return GatedStore


PortStore = gated(ExpertStore)


class GateWrap:
    """A store (or column view) whose fetches wait on ``gate``."""

    def __init__(self, inner, gate):
        self._inner, self._gate = inner, gate

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def get_expert(self, layer, expert, **kw):
        self._gate.wait()
        return self._inner.get_expert(layer, expert, **kw)


def hf_greedy(hf, prompt, n):
    with torch.no_grad():
        return hf.generate(torch.tensor(prompt), max_new_tokens=n, do_sample=False,
                           eos_token_id=None, pad_token_id=0).numpy()


def _arena_key(coords, dp):
    return coords["expert"] if dp == 1 else (coords["data"], coords["expert"])


def _counters(st):
    return {k: st[k] for k in ("visits", "hits", "misses", "evictions")}


def jax_run(tiny, plan, s_local, prompt, n=NEW, *, gate_coords=(), host_fallback=False,
            speculative=False, spec_block=1, prefetch=False, store_dir=None):
    """The JAX pod engine: prefill logits, then ``Generator`` tokens, and the
    per-coordinate counters, barrier joins and host executions after both."""
    from moe_infinity_tpu.memory import ExpertPredictor as JPredictor
    from moe_infinity_tpu.memory import ExpertTracer as JTracer

    cfg, _, default_dir, _ = tiny
    store_dir = store_dir or default_dir
    mesh = jmake_mesh(JPlan(**plan))
    model = JMixtral(JSpec.from_hf(cfg), compute_dtype=jnp.float32, mesh=mesh)
    params = model.load_params(JDense(store_dir))
    ex = JExec(mesh, JStore(store_dir), s_local, compute_dtype=jnp.float32, num_threads=1,
               host_fallback=host_fallback, host_fallback_timeout=0.02)
    gate = Gate()
    for key in gate_coords:  # the arenas share one store: gate this arena's alone
        ex.arenas[key].store = GateWrap(ex.arenas[key].store, gate)
    kw = {}
    if prefetch:
        tracer = JTracer(16, model.spec.num_layers, E)
        kw = dict(tracer=tracer, predictor=JPredictor(tracer))
    eng = JPodEngine(model, params, ex, prefetch=prefetch, impl="ragged",
                     speculative=speculative, spec_block=spec_block, **kw)
    try:
        B, T = prompt.shape
        kv = eng.init_cache(B, CAP)
        pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
        logits = np.asarray(eng.forward(jnp.asarray(prompt, jnp.int32), pos, kv, 0)[0])
        seqs = JGenerator(stepper=eng, max_seq_len=CAP).generate(prompt, max_new_tokens=n).sequences
        return dict(logits=logits, seqs=np.asarray(seqs),
                    counters={k: _counters(a.hit_stats()) for k, a in ex.arenas.items()},
                    joins=ex.barrier_joins, host=ex.host_exec_count,
                    replays=list(eng.replay_counts))
    finally:
        gate.release()
        ex.shutdown()


def port_spec(cfg):
    return MixtralSpec(**dataclasses.asdict(JSpec.from_hf(cfg)))


def port_run(tiny, sizes, s_local, prompt, n=NEW, *, gate_coords=(), host_fallback=False,
             speculative=False, spec_block=1, prefetch=False, store_dir=None, check=None,
             timeout=120.0):
    """The port's ranks as threads of a ``ThreadMesh`` of ``sizes``, each
    building its model, executor and engine: what ``jax_run`` returns, per
    rank (counters of its own arena, keyed as JAX keys it). gate_coords: the
    arena keys whose stores never land a record, or a predicate on a rank's
    coordinates."""
    from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer

    cfg, _, default_dir, _ = tiny
    store_dir = store_dir or default_dir
    spec = port_spec(cfg)
    gate = Gate()

    def rank(mesh):
        store = PortStore(store_dir)
        dp = mesh.shape["data"]
        gated_here = (gate_coords(mesh.coords) if callable(gate_coords)
                      else _arena_key(mesh.coords, dp) in gate_coords)
        if gated_here:
            store.gate = gate
        model = MixtralModel(spec, torch.float32, "cpu", mesh=mesh, shard_dense=False)
        params = model.load_params(DenseArchive(store_dir))
        ex = PodOffloadExecutor(mesh, store, s_local, compute_dtype=torch.float32, device="cpu",
                                num_threads=1, host_fallback=host_fallback,
                                host_fallback_timeout=0.02)
        kw = {}
        if prefetch:
            tracer = ExpertTracer(16, spec.num_layers, E)
            kw = dict(tracer=tracer, predictor=ExpertPredictor(tracer))
        eng = PodOffloadEngine(model, params, ex, prefetch=prefetch, impl="ragged",
                               speculative=speculative, spec_block=spec_block, **kw)
        try:
            if check is not None:
                check(mesh, ex, eng)
            B, T = prompt.shape
            pos = torch.arange(T, dtype=torch.int32).expand(B, T)
            logits = eng.forward(torch.tensor(prompt, dtype=torch.int32), pos,
                                 eng.init_cache(B, CAP), 0)[0]
            seqs = Generator(stepper=eng, max_seq_len=CAP).generate(
                prompt, max_new_tokens=n).sequences
            key = _arena_key(mesh.coords, dp)
            return dict(coords=dict(mesh.coords), logits=logits.numpy(), seqs=seqs,
                        counters={key: _counters(ex.arena.hit_stats())},
                        joins=ex.barrier_joins, host=ex.host_exec_count,
                        replays=list(eng.replay_counts), stats=eng.stats())
        finally:
            try:  # every rank has read its counters before any gated fetch lands
                mesh.barrier()
            finally:
                gate.release()
                ex.shutdown()

    return run_ranks(rank, ThreadMesh.grid(**sizes), timeout=timeout)


def assert_matches_jax(ranks, want, *, counters=True):
    """Every rank's tokens equal JAX's, its prefill logits within 1e-5; with
    ``counters``, model column 0's arena counters equal the JAX arena's of
    its coordinate, and every rank's barrier joins and host executions
    equal JAX's (every rank counts every exchange and every delta)."""
    for r in ranks:
        np.testing.assert_array_equal(r["seqs"], want["seqs"])
        np.testing.assert_allclose(r["logits"], want["logits"], rtol=0, atol=1e-5)
        if counters:
            assert r["joins"] == want["joins"]
            assert r["host"] == want["host"]
            if r["coords"]["model"] == 0:
                (key, got), = r["counters"].items()
                assert got == want["counters"][key], key


def facade_ranks(monkeypatch, path, store_dir, sizes, config, prompt, n, **gen_kw):
    """``MoE(..., multihost=True)`` on a thread per rank of a ``ThreadMesh``
    (``global_mesh`` returns the thread's mesh; the store is ingested once
    before): each rank's tokens, engine and stats."""
    from moe_infinity_tpu_torch.entrypoints.api import MoE
    from moe_infinity_tpu_torch.parallel import multihost
    from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
    from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

    cfg = dict(config, offload_path=store_dir, multihost=True)
    ingest_checkpoint(path, store_dir, read_hf_config(path), expert_dtype=cfg["expert_dtype"])
    local = threading.local()
    monkeypatch.setattr(multihost, "global_mesh", lambda plan, **kw: local.mesh)

    def rank(mesh):
        local.mesh = mesh
        moe = MoE(path, cfg, device="cpu")
        try:
            toks = moe.generate(prompt, max_new_tokens=n, **gen_kw)
            return dict(tokens=toks, engine=type(moe.engine).__name__, stats=moe.stats(),
                        hit_rate=moe.hit_rate(), arenas=len(moe.engine.executor.arenas))
        finally:
            moe.shutdown()

    return run_ranks(rank, ThreadMesh.grid(**sizes))


def _jax_facade(path, store_dir, config, prompt, n, **gen_kw):
    from moe_infinity_tpu.entrypoints.api import MoE as JMoE

    j = JMoE(path, dict(config, offload_path=store_dir, multihost=True))
    try:
        return type(j.engine).__name__, j.generate(prompt, max_new_tokens=n, **gen_kw)
    finally:
        j.shutdown()
