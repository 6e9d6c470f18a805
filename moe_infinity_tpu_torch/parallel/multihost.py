"""Several processes, one mesh, from ``moe_infinity_tpu/parallel/multihost.py``.

The JAX package runs multi-host serving as one SPMD program over a global
(data, model, expert) mesh, booted by ``jax.distributed`` and coordinated
through its key-value store. The port runs one process per rank over
``torch.distributed``: ``init_multihost`` starts the default process group
(the facade calls it only under ``multihost`` with a ``coordinator_address``;
otherwise the caller owns the group, e.g. ``torchrun`` and
``init_process_group``), ``global_mesh`` lays the ranks out as the pod path
wants them, and ``PrefetchHints`` publishes small JSON payloads through the
process group's key-value store (the one the rendezvous made).
"""

from __future__ import annotations

import json
import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from moe_infinity_tpu_torch.parallel.mesh import Mesh, MeshPlan, make_mesh

# seconds a pod exchange waits for a peer before it raises: long enough for a
# rank's first call to build its kernels while the others wait
POD_TIMEOUT_S = 300.0


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    timeout: float = POD_TIMEOUT_S,
) -> None:
    """Initialise the default process group over ``tcp://coordinator``
    (host:port) as rank ``process_id`` of ``num_processes``; without a
    coordinator, over ``env://`` when ``torchrun``'s variables are set. Does
    nothing when a group exists already, or for one process. The backend is
    NCCL when every rank of this host has a card of its own
    (``LOCAL_WORLD_SIZE``, else ``num_processes``, at most the cards), else
    gloo (ranks sharing a card stage their CUDA tensors through the host)."""
    if not dist.is_available() or dist.is_initialized():
        return
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("init_multihost over a coordinator needs num_processes and process_id")
        init, world, rank = f"tcp://{coordinator}", num_processes, process_id
    elif "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return
    if world <= 1:
        return
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if cards >= local else "gloo"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout))


def global_mesh(plan: MeshPlan, *, timeout: float = POD_TIMEOUT_S) -> Mesh:
    """The mesh over every rank, as the pod path wants it: ``model``
    innermost under TP x EP (``tp_inner``), so that an expert coordinate's
    columns are neighbouring ranks, as JAX's keeps them on one host. Its
    groups' collectives raise after ``timeout`` seconds without a peer."""
    return make_mesh(plan, tp_inner=plan.model > 1, timeout=timeout)


class PrefetchHints:
    """Pod-wide prefetch hints: one rank publishes a step's predicted expert
    set, every rank fetches it. Rides the default process group's
    key-value store; without a process group, a process-local dict (one
    process, tests)."""

    def __init__(self, namespace: str = "moe_prefetch"):
        self.namespace = namespace
        self._local = {}
        self._store = None
        if dist.is_available() and dist.is_initialized():
            from torch.distributed import distributed_c10d

            self._store = distributed_c10d._get_default_store()

    def _key(self, step) -> str:
        return f"{self.namespace}/{step}"

    def publish(self, step, keys: Sequence[tuple]) -> None:
        payload = json.dumps([list(k) for k in keys])
        if self._store is not None:
            self._store.set(self._key(step), payload)
        else:
            self._local[step] = payload

    def fetch(self, step, timeout_ms: int = 5000):
        """The keys published for ``step``; waits at most ``timeout_ms``
        for them (raises ``RuntimeError`` after it)."""
        if self._store is not None:
            key = self._key(step)
            self._store.wait([key], timedelta(milliseconds=timeout_ms))
            payload = self._store.get(key).decode()
        else:
            payload = self._local.get(step, "[]")
        return [tuple(k) for k in json.loads(payload)]

    def delete(self, step) -> None:
        """Drop a published entry (keeps the store bounded over a long run;
        call after every rank has fetched it)."""
        if self._store is not None:
            try:
                self._store.delete_key(self._key(step))
            except Exception:  # noqa: BLE001 - cleanup is best-effort
                pass
        else:
            self._local.pop(step, None)
