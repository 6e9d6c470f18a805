"""Rank workers of tests/test_torch_parallel.py: each runs in a process of
its own (``spawn``), joins a gloo process group through a ``file://``
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


def spawn_ranks(task: str, world: int, tmp_path, args: dict, timeout: float = 120.0):
    """Run ``task`` on ``world`` gloo ranks within ``timeout`` seconds in
    all; returns each rank's result."""
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
    if any(codes):
        errs = [open(f"{tmp_path}/rank{r}.err").read() for r in range(world)
                if os.path.exists(f"{tmp_path}/rank{r}.err")]
        raise AssertionError(f"{task}: exit codes {codes}\n" + "\n".join(errs))
    return [torch.load(f"{tmp_path}/rank{r}.pt") for r in range(world)]


def run(task, rank, world, init, out_dir, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        try:
            result = TASKS[task](rank, **args)
            dist.barrier()
        finally:
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


TASKS = {"ep_ffn": ep_ffn, "mixtral": mixtral, "facade": facade}
