"""Rank workers of tests/test_torch_parallel.py, test_torch_ring_attention.py
and test_torch_entrypoints.py: each runs in a process of its own
(``spawn``), joins a gloo process group through a ``file://``
rendezvous, runs one task on the CPU and saves what it computed with
``torch.save``. Imports torch and the port only (no JAX), so that a rank
starts quickly; pytest does not collect it (no ``test_`` prefix).

``spawn_ranks`` starts the ranks, joins each with a timeout, terminates any
that is still alive, and raises unless every rank exited 0."""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from moe_infinity_tpu_torch import bridge
from moe_infinity_tpu_torch.parallel import mesh as pm


def spawn_ranks(task: str, world: int, tmp_path, args: dict, timeout: float = 120.0,
                dead=()):
    """Run ``task`` on ``world`` gloo ranks within ``timeout`` seconds in
    all; returns each rank's result (None for a rank of ``dead``, which may
    exit without one)."""
    os.makedirs(tmp_path, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    init = f"file://{tmp_path}/rendezvous"
    procs = [ctx.Process(target=run, args=(task, r, world, init, str(tmp_path), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    if hung:
        raise AssertionError(f"ranks {hung} of {task} did not finish in {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(c for r, c in enumerate(codes) if r not in dead):
        errs = [open(f"{tmp_path}/rank{r}.err").read() for r in range(world)
                if os.path.exists(f"{tmp_path}/rank{r}.err")]
        raise AssertionError(f"{task}: exit codes {codes}\n" + "\n".join(errs))
    return [None if r in dead else torch.load(f"{tmp_path}/rank{r}.pt") for r in range(world)]


def run(task, rank, world, init, out_dir, args):
    torch.set_num_threads(1)
    try:
        # a task of SELF_INIT starts its process group itself (the facade's
        # coordinator_address); one of NO_BARRIER may have lost a peer
        if task not in SELF_INIT:
            dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        try:
            result = TASKS[task](rank, **args)
            if task not in NO_BARRIER:
                dist.barrier()
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        torch.save(result, f"{out_dir}/rank{rank}.pt")
    except BaseException:
        with open(f"{out_dir}/rank{rank}.err", "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _t(tree):
    return bridge.to_torch(tree, "cpu")


def ep_ffn(rank, *, plan, x, ids, cw, slot, weights, biases=None, joint=False):
    """This rank's rows of ``grouped_ffn_ep`` and where they go."""
    from moe_infinity_tpu_torch.ops.moe import grouped_ffn_ep

    mesh = pm.make_mesh(pm.MeshPlan(**plan))
    w = _t(weights)
    if joint:  # the slot stack over (data, expert), data-major
        w = {k: pm.local_slice(v, pm.Sharding(mesh, ((pm.DATA, pm.EXPERT),))) for k, v in w.items()}
    else:
        w = pm.shard_params(w, pm.expert_shardings(mesh, w))
    b = None if biases is None else pm.shard_params(_t(biases), pm.expert_shardings(mesh, _t(biases)))
    dp, d = mesh.shape[pm.DATA], mesh.axis_index(pm.DATA)
    T = x.shape[0]
    lo, hi = d * T // dp, (d + 1) * T // dp
    out = grouped_ffn_ep(torch.tensor(x[lo:hi]), torch.tensor(ids[lo:hi]),
                         torch.tensor(cw[lo:hi]), torch.tensor(slot), w, "silu",
                         mesh=mesh, biases=b, impl="ragged")
    return {"lo": lo, "out": out}


def mixtral(rank, *, plan, spec, params, experts, tokens, cap, new_tokens):
    """The sharded Mixtral's prefill logits (the whole batch, gathered),
    its greedy ``Generator`` tokens and its greedy ``decode_scan``."""
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
    from moe_infinity_tpu_torch.runtime.generate import Generator, ResidentStepper
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

    mesh = pm.make_mesh(pm.MeshPlan(**plan))
    model = MixtralModel(MixtralSpec(**spec), torch.float32, "cpu", mesh=mesh)
    p, e = _t(params), _t(experts)
    if mesh.shape[pm.MODEL] > 1:
        p = pm.shard_params(p, pm.mixtral_param_shardings(mesh, p))
    e = pm.shard_params(e, pm.expert_shardings(mesh, e))
    stepper = ResidentStepper(model, p, e, ResidentProvider.for_layer, graphs=False)
    if mesh.shape[pm.DATA] > 1:
        stepper.set_data_sharding(mesh)
    B, T = tokens.shape
    kv = stepper.init_cache(B, cap)
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    logits, kv, _ = stepper.forward(torch.tensor(tokens, dtype=torch.int32), pos, kv, 0)
    tok0 = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    scan, _ = stepper.decode_scan(tok0, torch.full((B,), T, dtype=torch.int32), kv, new_tokens)
    seqs = Generator(stepper=stepper).generate(tokens, max_new_tokens=new_tokens,
                                               cache_len=cap).sequences
    return {"logits": logits, "scan": scan, "generate": torch.from_numpy(seqs),
            "kv_heads": kv[0].k.shape[2], "rows": kv[0].k.shape[0]}


def facade(rank, *, path, config, prompt, new_tokens):
    """``MoE(...)`` on a mesh: the greedy tokens every rank returns."""
    from moe_infinity_tpu_torch.entrypoints.api import MoE

    moe = MoE(path, config, device="cpu")
    try:
        out = moe.generate(np.asarray(prompt), max_new_tokens=new_tokens)
        mesh = moe.mesh
        return {"tokens": torch.from_numpy(out), "coords": mesh.coords,
                "slots": moe.generator.stepper.experts["layers"][0]["gate"].shape[0]}
    finally:
        moe.shutdown()


def pod_facade(rank, *, path, plans, prompt, new_tokens, port=None):
    """``MoE(..., multihost=True)`` under each config of ``plans`` (the
    first over ``coordinator_address`` when ``port`` is given: the facade
    initialises the process group), then ``PrefetchHints`` and the host
    channel through the real process group: each plan's greedy tokens and
    engine, the hints one rank published, the host reductions."""
    from moe_infinity_tpu_torch.entrypoints.api import MoE
    from moe_infinity_tpu_torch.parallel.mesh import WORLD
    from moe_infinity_tpu_torch.parallel.multihost import PrefetchHints, global_mesh

    out = {"plans": []}
    for i, config in enumerate(plans):
        if i == 0 and port is not None:
            config = dict(config, coordinator_address=f"localhost:{port}", num_processes=2,
                          process_id=rank)
        moe = MoE(path, config, device="cpu")
        try:
            toks = moe.generate(np.asarray(prompt), max_new_tokens=new_tokens, eos_token_id=None)
            out["plans"].append({"tokens": torch.from_numpy(toks),
                                 "engine": type(moe.engine).__name__,
                                 "coords": dict(moe.mesh.coords), "stats": moe.stats()})
        finally:
            moe.shutdown()
    hints = PrefetchHints("pod_test")
    if rank == 0:
        hints.publish(3, [(0, 1), (1, 2)])
    out["hints"] = hints.fetch(3, timeout_ms=20000)
    dist.barrier()
    if rank == 1:
        hints.delete(3)
    try:
        hints.fetch(4, timeout_ms=200)  # never published: raises after its timeout
        out["unpublished"] = "returned"
    except RuntimeError as e:
        out["unpublished"] = str(e)
    mesh = global_mesh(pm.MeshPlan(expert=2), timeout=30.0)
    t = torch.tensor([rank, 10 - rank], dtype=torch.int32)
    out["max"] = mesh.host_all_reduce(t.clone(), "max", *WORLD).tolist()
    out["min"] = mesh.host_all_reduce(t.clone(), "min", *WORLD).tolist()
    out["bcast"] = mesh.host_broadcast(t.clone(), *WORLD).tolist()
    mesh.barrier(30.0)
    return out


def pod_fail(rank, *, store_dir, spec, fault, timeout):
    """Two pod ranks of a Mixtral; rank 1's acquire at MoE layer 1 raises
    (``fault="raises"``) or its process exits (``"dies"``). Rank 0 returns
    the error it raised and the seconds it took."""
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
    from moe_infinity_tpu_torch.parallel.multihost import global_mesh
    from moe_infinity_tpu_torch.parallel.pod import PodOffloadExecutor
    from moe_infinity_tpu_torch.runtime.generate import Generator
    from moe_infinity_tpu_torch.runtime.pod_engine import PodOffloadEngine
    from moe_infinity_tpu_torch.store.blob import DenseArchive, ExpertStore

    mesh = global_mesh(pm.MeshPlan(expert=2), timeout=timeout)
    model = MixtralModel(MixtralSpec(**spec), torch.float32, "cpu", mesh=mesh, shard_dense=False)
    params = model.load_params(DenseArchive(store_dir))
    ex = PodOffloadExecutor(mesh, ExpertStore(store_dir), 2, compute_dtype=torch.float32,
                            device="cpu", num_threads=1)
    if rank == 1:
        acquire = ex.arena.acquire

        def planted(keys, layer):
            if layer == 1:
                if fault == "dies":
                    os._exit(3)
                raise RuntimeError("planted acquire failure")
            return acquire(keys, layer)

        ex.arena.acquire = planted
    t0 = time.monotonic()
    try:
        Generator(stepper=PodOffloadEngine(model, params, ex, prefetch=False)).generate(
            np.array([[5, 9, 33, 7]]), max_new_tokens=2)
        err = None
    except Exception as e:  # noqa: BLE001 - returned to the test
        err = f"{type(e).__name__}: {e}"
    finally:
        ex.shutdown()
    return {"error": err, "seconds": time.monotonic() - t0}


def ring(rank, *, world, q, k, v, q1, tail_k, tail_v, g):
    """The real mesh's ring hop and ``all_reduce(max)`` on a ``seq`` axis of
    ``world`` gloo ranks, then ``ring_attend`` and ``sp_decode_attention``
    over them (the shards of ``k``/``v`` by rank)."""
    from moe_infinity_tpu_torch.ops.ring_attention import ring_attend, sp_decode_attention

    mesh = pm.make_mesh(pm.MeshPlan(seq=world))
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    out = {"hop": mesh.ring_hop(t, "seq"),
           "hop_bf16": mesh.ring_hop(t.to(torch.bfloat16), "seq"),
           "hop_bytes": mesh.hop_bytes,
           "max": mesh.all_reduce(torch.tensor([rank, -rank, 7], dtype=torch.float32), "seq",
                                  op="max"),
           "sum": mesh.all_reduce(torch.tensor([rank, 1], dtype=torch.int32), "seq")}
    q, k, v = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    out["attend"] = ring_attend(q, k, v, mesh)
    Ts = k.shape[1] // world
    out["decode"] = sp_decode_attention(torch.tensor(q1), k[:, rank * Ts:(rank + 1) * Ts],
                                        v[:, rank * Ts:(rank + 1) * Ts], torch.tensor(tail_k),
                                        torch.tensor(tail_v), g, mesh)
    return out


def sp_facade(rank, *, path, config, prompts, new_tokens):
    """``MoE(..., sequence_parallel=2)``: each prompt's greedy tokens and the
    bytes this rank's ring hops had sent after it."""
    from moe_infinity_tpu_torch.entrypoints.api import MoE

    moe = MoE(path, config, device="cpu")
    try:
        out = {"tokens": [], "hop_bytes": [], "lane": moe.sp_decoder is not None,
               "coords": dict(moe.mesh.coords)}
        for p in prompts:
            out["tokens"].append(torch.from_numpy(
                moe.generate(np.asarray(p), max_new_tokens=new_tokens)))
            out["hop_bytes"].append(moe.mesh.hop_bytes)
        return out
    finally:
        moe.shutdown()


TASKS = {"ep_ffn": ep_ffn, "ring": ring, "sp_facade": sp_facade, "mixtral": mixtral, "facade": facade, "pod_facade": pod_facade,
         "pod_facade_coordinator": pod_facade, "pod_fail": pod_fail}
SELF_INIT = {"pod_facade_coordinator"}
NO_BARRIER = {"pod_fail"}
