"""The port's offload across ranks (``moe_infinity_tpu_torch/parallel/pod.py``,
``runtime/pod_engine.py``) on the CPU, its ranks as threads
(``torch_port_helpers.ThreadMesh``), against the JAX package's single-process
``PodOffloadEngine`` on the 8 host devices, following tests/test_pod_engine.py
case by case on its tiny Mixtral (HF ``MixtralForCausalLM``, f32, 4 experts,
2 layers; the store written by the JAX ingest and read by both):

* coordinate affinity of the slot row;
* greedy tokens equal (to JAX's and HF's), prefill logits within 1e-5, and,
  with prefetch off and one fetch worker, each coordinate's hits, misses and
  evictions, ``barrier_joins`` and ``host_exec_count`` equal to JAX's: per
  layer under EP, with prefetch and the tracer, the host fallback (a
  coordinate whose store never lands a record), speculative blocks (fewer
  barrier joins than per layer), DP x EP and its host fallback;
* a rank that raises inside the exchange, or falls behind, makes every
  other rank raise naming the step;
* the facade's ``multihost`` plan for Mixtral, DeepSeek-V2, Grok-1 and Switch
  (``global_mesh`` replaced by each thread's mesh) against the JAX
  facade's tokens.

The TP x EP cases are tests/test_torch_pod_tp.py; ranks as processes over
gloo, tests/test_torch_multihost.py."""

import threading
import time

import numpy as np
import pytest
import torch

from moe_infinity_tpu_torch.models.mixtral import MixtralModel
from moe_infinity_tpu_torch.parallel.pod import PodOffloadExecutor
from moe_infinity_tpu_torch.runtime.generate import Generator
from moe_infinity_tpu_torch.runtime.pod_engine import PodOffloadEngine
from moe_infinity_tpu_torch.store.blob import DenseArchive, ExpertStore
from torch_pod_helpers import (
    CAP,
    E,
    NEW,
    PROMPT,
    TWO,
    _jax_facade,
    assert_matches_jax,
    facade_ranks,
    hf_greedy,
    jax_run,
    port_run,
    port_spec,
    tiny_mixtral,
)
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import ThreadMesh, run_ranks, save_tiny_checkpoint


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg, hf, stores, path = tiny_mixtral(tmp_path_factory.mktemp("torch_pod"))
    return cfg, hf, stores["float32"], path


# ---------------------------------------------------------------------------
# the executor and the per-layer engine
# ---------------------------------------------------------------------------


def test_executor_coord_affinity(tiny):
    """Every expert resolves to a global slot inside its owner's range, the
    same row on every rank; each rank's arena holds its coordinate only."""
    _, _, store_dir, _ = tiny

    def rank(mesh):
        ex = PodOffloadExecutor(mesh, ExpertStore(store_dir), 2, compute_dtype=torch.float32,
                                device="cpu", num_threads=1)
        try:
            assert set(ex.arenas) == {mesh.coords["expert"]}
            assert ex.plan.local_experts() == [mesh.coords["expert"]]
            keys = [(0, e) for e in range(E)]
            row, missing = ex.ensure_step(0, keys)
            ex.release_step(keys)
            assert not missing
            assert sorted(ex.arena.key_to_slot) == [(0, mesh.coords["expert"])]
            return row
        finally:
            ex.shutdown()

    rows = run_ranks(rank, ThreadMesh.grid(expert=4))
    for row in rows:
        np.testing.assert_array_equal(row, rows[0])
    for e in range(E):
        assert e * 2 <= rows[0][e] < (e + 1) * 2  # coordinate e owns expert e


def test_pod_engine_greedy_matches_jax_and_hf(tiny):
    _, hf, _, _ = tiny
    want = jax_run(tiny, dict(expert=4), 2, PROMPT)
    np.testing.assert_array_equal(want["seqs"], hf_greedy(hf, PROMPT, NEW))
    ranks = port_run(tiny, dict(expert=4), 2, PROMPT)
    assert_matches_jax(ranks, want)
    assert ranks[0]["stats"]["pod_coords"] == [0] and ranks[3]["stats"]["pod_coords"] == [3]
    assert all(r["counters"][r["coords"]["expert"]]["visits"] > 0 for r in ranks)


def test_pod_engine_with_prefetch_and_tracer(tiny):
    """Prefetch on (the tracer and predictor on every rank, each rank
    ordering its own coordinate's experts): tokens and logits as JAX's."""
    want = jax_run(tiny, dict(expert=2), 2, PROMPT, 5, prefetch=True)
    assert_matches_jax(port_run(tiny, dict(expert=2), 2, PROMPT, 5, prefetch=True), want,
                       counters=False)


def test_pod_engine_host_fallback_exact(tiny):
    """Coordinate 1's store never lands a record: its experts miss the
    deadline on every layer, every rank adds the same host delta, and the
    tokens, counters and host executions equal JAX's."""
    want = jax_run(tiny, dict(expert=4), 2, PROMPT, 4, gate_coords=(1,), host_fallback=True)
    assert want["host"] > 0
    assert_matches_jax(port_run(tiny, dict(expert=4), 2, PROMPT, 4, gate_coords=(1,),
                                host_fallback=True), want)


def test_pod_engine_speculative_blocks(tiny):
    """Blocks of 4 over the pod snapshot: tokens equal to JAX's and HF's,
    fewer barrier joins than the per-layer path, both joins and the
    executions per block equal to JAX's."""
    _, hf, _, _ = tiny
    new = 8
    per_layer = jax_run(tiny, dict(expert=2), 4, PROMPT, new)
    spec = jax_run(tiny, dict(expert=2), 4, PROMPT, new, speculative=True, spec_block=4)
    np.testing.assert_array_equal(spec["seqs"], hf_greedy(hf, PROMPT, new))
    got_pl = port_run(tiny, dict(expert=2), 4, PROMPT, new)
    got = port_run(tiny, dict(expert=2), 4, PROMPT, new, speculative=True, spec_block=4)
    assert_matches_jax(got_pl, per_layer)
    assert_matches_jax(got, spec)
    for r in got:
        assert r["stats"]["speculative_steps"] > 0 and r["replays"] == spec["replays"]
        assert r["joins"] < got_pl[0]["joins"]


def test_pod_engine_dp_ep_greedy_matches_jax(tiny):
    """data=2 x expert=2: a rank per (d, c), each row of the batch through
    its own data row's arenas ([dp, E] tables), both sequences exact."""
    _, hf, _, _ = tiny
    want = jax_run(tiny, dict(data=2, expert=2), 3, TWO)
    np.testing.assert_array_equal(want["seqs"], hf_greedy(hf, TWO, NEW))
    ranks = port_run(tiny, dict(data=2, expert=2), 3, TWO)
    assert_matches_jax(ranks, want)
    assert {tuple(r["counters"]) for r in ranks} == {((0, 0),), ((0, 1),), ((1, 0),), ((1, 1),)}


def test_pod_engine_dp_ep_host_fallback_exact(tiny):
    """Data row 1's arenas never land: its misses take the host path for
    its batch slice alone; tokens, counters and host executions as JAX's."""
    gate = ((1, 0), (1, 1))
    want = jax_run(tiny, dict(data=2, expert=2), 3, TWO, 4, gate_coords=gate,
                   host_fallback=True)
    assert want["host"] > 0
    assert_matches_jax(port_run(tiny, dict(data=2, expert=2), 3, TWO, 4, gate_coords=gate,
                                host_fallback=True), want)


def test_prefetch_coordinator_warms_each_ranks_share(tiny):
    """``PodPrefetchCoordinator``: the leader publishes a step's expert set
    (``PrefetchHints``, one instance shared by the threads, as one store
    serves every process), every rank warms its coordinate's share and
    joins the barrier (a fetch through the process group's store, and one
    of a step nobody published: tests/test_torch_multihost.py)."""
    from moe_infinity_tpu_torch.parallel.multihost import PrefetchHints
    from moe_infinity_tpu_torch.parallel.pod import PodExpertPlan, PodPrefetchCoordinator
    from moe_infinity_tpu_torch.runtime.arena import ExpertArena

    _, _, store_dir, _ = tiny
    hints = PrefetchHints("pod_test")
    keys = [(0, 0), (1, 3), (0, 2)]

    def rank(mesh):
        arena = ExpertArena(ExpertStore(store_dir), 2, compute_dtype=torch.float32,
                            device="cpu", num_threads=1)
        coord = PodPrefetchCoordinator(arena, PodExpertPlan(mesh, E), mesh=mesh, hints=hints)
        try:
            if mesh.rank == 0:
                coord.lead(0, keys)
            mesh.barrier()
            mine = coord.ensure(0)
            return mine, sorted(arena.key_to_slot)
        finally:
            arena.shutdown()

    out = run_ranks(rank, ThreadMesh.grid(expert=2))
    assert out[0] == ([(0, 0)], [(0, 0)])  # coordinate 0 owns experts 0 and 1
    assert out[1] == ([(1, 3), (0, 2)], [(0, 2), (1, 3)])


def test_pod_engines_refuse_graphs_and_sharded_dense(tiny):
    """Under a mesh the engines run eagerly: ``graphs=True`` raises, naming
    the collectives; a Mixtral whose dense weights are sharded over the model
    axis, or a model with no expert axis, is refused."""
    cfg, _, store_dir, _ = tiny
    spec = port_spec(cfg)

    def rank(mesh):
        ex = PodOffloadExecutor(mesh, ExpertStore(store_dir), 2, compute_dtype=torch.float32,
                                device="cpu", num_threads=1)
        try:
            model = MixtralModel(spec, torch.float32, "cpu", mesh=mesh, shard_dense=False)
            with pytest.raises(ValueError, match="cannot be captured"):
                PodOffloadEngine(model, {}, ex, graphs=True)
            with pytest.raises(ValueError, match="shard_dense=False"):
                PodOffloadEngine(MixtralModel(spec, torch.float32, "cpu", mesh=mesh), {}, ex)
            with pytest.raises(ValueError, match="expert-axis mesh"):
                PodOffloadEngine(MixtralModel(spec, torch.float32, "cpu"), {}, ex)
        finally:
            ex.shutdown()

    run_ranks(rank, ThreadMesh.grid(model=2, expert=2))


# ---------------------------------------------------------------------------
# failures reach every rank
# ---------------------------------------------------------------------------


def _run_all(fn, meshes, timeout=60.0):
    """fn(mesh) on a thread per rank: each rank's result or exception."""
    out = [None] * len(meshes)

    def go(i, m):
        try:
            out[i] = fn(m)
        except BaseException as e:  # noqa: BLE001 - returned to the test
            out[i] = e

    threads = [threading.Thread(target=go, args=(i, m), daemon=True)
               for i, m in enumerate(meshes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    return out


@pytest.mark.parametrize("fault", ["raises", "falls-behind"])
def test_a_failed_rank_makes_every_rank_raise(tiny, fault):
    """Rank 1's acquire raises at the prefill's second MoE layer (it still
    joins the exchange, with its error flag), or it stops answering: every
    rank raises, rank 0 with a ``RuntimeError`` naming the step, within the
    mesh's timeout, and no rank hangs."""
    cfg, _, store_dir, _ = tiny
    spec = port_spec(cfg)

    def rank(mesh):
        model = MixtralModel(spec, torch.float32, "cpu", mesh=mesh, shard_dense=False)
        params = model.load_params(DenseArchive(store_dir))
        ex = PodOffloadExecutor(mesh, ExpertStore(store_dir), 2, compute_dtype=torch.float32,
                                device="cpu", num_threads=1)
        eng = PodOffloadEngine(model, params, ex, prefetch=False)
        if mesh.rank == 1:
            acquire = ex.arena.acquire

            def planted(keys, layer):
                if layer == 1:
                    if fault == "raises":
                        raise RuntimeError("planted acquire failure")
                    time.sleep(6.0)
                return acquire(keys, layer)

            ex.arena.acquire = planted
        try:
            t0 = time.monotonic()
            try:
                Generator(stepper=eng, max_seq_len=CAP).generate(PROMPT, max_new_tokens=2)
            except Exception as e:  # noqa: BLE001 - returned with its delay
                return e, time.monotonic() - t0
            return None, time.monotonic() - t0
        finally:
            ex.shutdown()

    out = _run_all(rank, ThreadMesh.grid(timeout=2.0, expert=2))
    (e0, t0), (e1, _t1) = out
    assert isinstance(e0, RuntimeError) and e1 is not None
    if fault == "raises":
        assert "planted" in str(e1)
        assert "pod step 1: rank 1 failed" in str(e0)
    else:
        assert "pod step 1: the host exchange did not complete" in str(e0)
        assert t0 < 5.0  # raised at the 2 s timeout, not after rank 1's 6 s


# ---------------------------------------------------------------------------
# the facade's multihost plans, ranks as threads
# ---------------------------------------------------------------------------


FACADE = {"expert_dtype": "float32", "max_seq_len": 64, "prefetch": True}


@pytest.mark.parametrize("family,slots", [("mixtral", 2), ("deepseek", 3), ("switch", 2)])
def test_facade_pod_plan(monkeypatch, tmp_path, family, slots):
    """The facade composes the pod itself under ``multihost`` (expert=4):
    ``PodOffloadEngine`` (``PodSeq2SeqOffloadEngine`` for Switch) with one
    arena a rank, greedy tokens equal to the JAX facade's and to HF's."""
    path, hf = save_tiny_checkpoint(family, tmp_path / "ckpt", seed=23)
    cfg = dict(FACADE, expert_parallel=4, num_slots=slots)
    prompt = np.array([[5, 31, 8, 77]]) if family == "switch" else PROMPT
    kw = {} if family == "switch" else {"eos_token_id": None}
    jname, want = _jax_facade(path, str(tmp_path / "jax"), cfg, prompt, NEW, **kw)
    ranks = facade_ranks(monkeypatch, path, str(tmp_path / "port"), dict(expert=4), cfg,
                         prompt, NEW, **kw)
    if family != "switch":
        np.testing.assert_array_equal(want, hf_greedy(hf, prompt, NEW))
    for r in ranks:
        assert r["engine"] == jname and r["arenas"] == 1
        np.testing.assert_array_equal(r["tokens"], want)
        assert r["stats"]["visits"] > 0


def test_facade_pod_plan_grok(monkeypatch, tmp_path):
    """Grok-1 (softcapped attention, the post-MoE norm) under the facade's
    multihost plan at expert=4, against the JAX facade's tokens."""
    from test_torch_grok import TINY_CONFIG, _checkpoint_tensors
    from torch_decoder_family import write_checkpoint

    path = write_checkpoint(tmp_path / "ckpt", TINY_CONFIG, _checkpoint_tensors(TINY_CONFIG, 3))
    cfg = dict(FACADE, expert_parallel=4, num_slots=2)
    jname, want = _jax_facade(path, str(tmp_path / "jax"), cfg, PROMPT, NEW, eos_token_id=None)
    for r in facade_ranks(monkeypatch, path, str(tmp_path / "port"), dict(expert=4), cfg,
                          PROMPT, NEW, eos_token_id=None):
        assert r["engine"] == jname == "PodOffloadEngine"
        np.testing.assert_array_equal(r["tokens"], want)
