"""Meshes of ranks and their sharding plans, from
``moe_infinity_tpu/parallel/mesh.py``.

The JAX package places a model declaratively: a ``jax.sharding.Mesh`` of
(data, model, expert, seq) axes, ``NamedSharding``s on the param and expert
trees, and collectives that XLA inserts. The port runs SPMD over
``torch.distributed``: one process per rank, each holding its own slice of
every sharded tensor and calling the same code on the same inputs, with the
collectives written out where GSPMD would insert them. The caller starts the
processes and initialises the process group (``torchrun``, a test,
``chip_smoke.py``, or ``multihost.init_multihost``) and picks its backend;
nothing here does.

Axes:
  data   - batch rows (``runtime/generate.py::ResidentStepper.set_data_sharding``)
  model  - tensor parallelism: Mixtral's attention heads and vocabulary, and
           the experts' d_ff (``common/arch.py::TP_MODEL_DIMS``)
  expert - expert parallelism: dim 0 of every stacked expert array
  seq    - sequence parallelism: not ported (ROADMAP item 18c)

Collectives are ``all_reduce``, ``broadcast`` and ``barrier`` only: a gather
is an ``all_reduce`` of a zero-filled buffer holding each rank's part. Gloo
takes CUDA tensors for those three alone (staging them through the host),
which is how two ranks share one card; over NCCL, with one rank a card, the
same code runs unchanged.

The host channel: the pod protocol (``parallel/pod.py``) exchanges small
host-side tables every MoE layer (slot fragments, resident sets, error
flags). CPU tensors cannot ride NCCL groups, so ``make_mesh`` also makes a
gloo group for every group it makes (the same groups when the default
backend is gloo), and ``Mesh.host_all_reduce``, ``host_broadcast`` and
``barrier`` run over those. Every wait there is bounded: a group made with a
``timeout`` raises ``RuntimeError`` when a peer does not arrive within it.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA, MODEL, EXPERT, SEQ = "data", "model", "expert", "seq"
AXES = (DATA, MODEL, EXPERT, SEQ)
# the ranks a host exchange or barrier spans: the whole mesh
WORLD = AXES
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


@dataclass(frozen=True)
class MeshPlan:
    data: int = 1
    model: int = 1
    expert: int = 1
    seq: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.expert * self.seq


class Mesh:
    """This process's place in a grid of ranks: ``shape`` (axis -> size, as a
    JAX mesh's), its coordinate on each axis, and a process group for each
    line of ranks along an axis (and each (model, expert) plane)."""

    def __init__(self, plan: MeshPlan, grid: np.ndarray, rank: int,
                 groups: Dict[Tuple[str, ...], Any], host_groups: Dict[Tuple[str, ...], Any],
                 timeout: Optional[float] = None):
        self.plan = plan
        self.grid = grid  # [data, model, expert, seq] -> rank
        self.rank = rank
        self.shape = dict(zip(AXES, grid.shape))
        self.coords = dict(zip(AXES, (int(i) for i in np.argwhere(grid == rank)[0])))
        self.timeout = timeout
        self._groups = groups
        self._host_groups = host_groups

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def _live(self, axes) -> Tuple[str, ...]:
        return tuple(a for a in AXES if a in axes and self.shape[a] > 1)

    @staticmethod
    def _group(groups, live):
        group = groups.get(live)
        if group is None:
            raise ValueError(f"no process group over {live}")
        return group

    def all_reduce(self, t: torch.Tensor, *axes: str) -> torch.Tensor:
        """Sum ``t`` in place over the ranks that share this rank's
        coordinates on every axis but ``axes``; axes of size 1 take no
        collective."""
        live = self._live(axes)
        if live:
            dist.all_reduce(t, group=self._group(self._groups, live))
        return t

    def host_all_reduce(self, t: torch.Tensor, op: str, *axes: str) -> torch.Tensor:
        """Reduce the CPU tensor ``t`` in place (``op``: "sum", "max" or
        "min") over the ranks that share this rank's coordinates off
        ``axes`` (``WORLD``: every rank), over the host channel. Raises
        ``RuntimeError`` when a peer does not arrive within the mesh's
        timeout."""
        live = self._live(axes)
        if live:
            dist.all_reduce(t, op=_OPS[op], group=self._group(self._host_groups, live))
        return t

    def host_broadcast(self, t: torch.Tensor, *axes: str) -> torch.Tensor:
        """The CPU tensor ``t`` of the first rank (the lowest) of this rank's
        line over ``axes``, in place on every rank of it."""
        live = self._live(axes)
        if live:
            group = self._group(self._host_groups, live)
            dist.broadcast(t, src=min(dist.get_process_group_ranks(group)), group=group)
        return t

    def barrier(self, timeout: Optional[float] = None) -> None:
        """Wait for every rank of the mesh, at most ``timeout`` seconds (the
        mesh's by default); raises ``RuntimeError`` naming a rank that did
        not arrive (gloo's ``monitored_barrier``)."""
        live = self._live(WORLD)
        if live:
            secs = timeout if timeout is not None else (self.timeout or 1800.0)
            dist.monitored_barrier(group=self._group(self._host_groups, live),
                                   timeout=timedelta(seconds=secs))

    def gather_rows(self, t: torch.Tensor, lo: int, total: int, axis: str) -> torch.Tensor:
        """The [total, ...] tensor whose rows [lo, lo + len(t)) are this
        rank's ``t``, from every rank of ``axis`` (an ``all_reduce`` of a
        zero-filled buffer)."""
        full = t.new_zeros((total, *t.shape[1:]))
        full[lo:lo + t.shape[0]] = t
        return self.all_reduce(full, axis)

    def gather_cols(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The last dim of ``t`` gathered over ``axis`` in coordinate order
        (each rank holds an equal slice)."""
        n = self.shape[axis]
        if n == 1:
            return t
        w = t.shape[-1]
        full = t.new_zeros((*t.shape[:-1], w * n))
        i = self.axis_index(axis)
        full[..., i * w:(i + 1) * w] = t
        return self.all_reduce(full, axis)


def rank_grid(plan: MeshPlan, *, tp_inner: bool = False) -> np.ndarray:
    """[data, model, expert, seq] -> rank, as JAX's ``make_mesh`` places
    device r (``seq`` innermost; ``tp_inner``: ``model`` varies fastest
    after it, instead of ``expert``)."""
    ranks = np.arange(plan.num_devices)
    if tp_inner:
        return ranks.reshape(plan.data, plan.expert, plan.model, plan.seq).transpose(0, 2, 1, 3)
    return ranks.reshape(plan.data, plan.model, plan.expert, plan.seq)


def make_mesh(plan: MeshPlan, *, tp_inner: bool = False,
              timeout: Optional[float] = None) -> Mesh:
    """The mesh of ``plan`` over the initialised default process group, rank
    r at the coordinate JAX's ``make_mesh`` gives device r (``rank_grid``).
    It makes a group for every set of axes above size 1 (each axis line,
    each plane of two or three axes, the whole mesh), and a gloo group
    beside each where the default backend is not gloo (the host channel).
    Every rank makes every group, in the same order, as ``dist.new_group``
    requires. timeout: seconds a collective of these groups waits for a
    peer before it raises (the backend's default when None). Raises when no
    process group is initialised or its world size is not the plan's."""
    if plan.seq > 1:
        raise NotImplementedError(
            "a seq mesh axis (sequence parallelism) is not ported (ROADMAP queue-1 item 18c)")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a mesh of {plan} needs an initialised torch.distributed process group "
            "(one process per rank: torchrun, or init_process_group in each)")
    world = dist.get_world_size()
    if world != plan.num_devices:
        raise ValueError(f"{plan} needs {plan.num_devices} ranks, the process group has {world}")
    grid = rank_grid(plan, tp_inner=tp_inner)
    rank = dist.get_rank()
    kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
    host_too = dist.get_backend() != "gloo"
    live = [a for a in AXES if grid.shape[AXES.index(a)] > 1]
    groups, host_groups = {}, {}
    for n in range(1, len(live) + 1):
        for axes in itertools.combinations(live, n):
            dims = [AXES.index(a) for a in axes]
            rest = [d for d in range(4) if d not in dims]
            moved = np.moveaxis(grid, rest + dims, list(range(4)))
            for idx in itertools.product(*(range(grid.shape[d]) for d in rest)):
                members = [int(r) for r in moved[idx].reshape(-1)]
                g = dist.new_group(members, **kw)
                h = dist.new_group(members, backend="gloo", **kw) if host_too else g
                if rank in members:
                    groups[axes], host_groups[axes] = g, h
    return Mesh(plan, grid, rank, groups, host_groups, timeout)


# ---------------------------------------------------------------------------
# sharding plans: each leaf's spec, then each rank's slice of it
# ---------------------------------------------------------------------------


class Sharding(NamedTuple):
    """A leaf's placement, the counterpart of a ``NamedSharding``: per dim,
    None (whole), an axis, or a tuple of axes (sharded over their product,
    the first varying slowest)."""

    mesh: Mesh
    spec: tuple


def _ns(mesh: Mesh, *spec) -> Sharding:
    return Sharding(mesh, spec)


def local_slice(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` (a copy, so the whole one
    can be freed). Raises when a sharded dim does not divide evenly."""
    mesh = sharding.mesh
    out = t
    for dim, axes in enumerate(sharding.spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, i = 1, 0
        for a in axes:
            n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.axis_index(a)
        if n == 1:
            continue
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {axes} ({n})")
        out = out.narrow(dim, i * size // n, size // n)
    return out if out is t else out.clone()


def _map(fn, tree, key=None):
    """fn(leaf, its innermost dict key) over a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, key) for v in tree)
    return fn(tree, key)


def mixtral_param_shardings(mesh: Mesh, params: Dict[str, Any]) -> Dict[str, Any]:
    """Shardings of ``MixtralModel.load_params``'s tree, as JAX's: dense
    weights in HF ``[out, in]`` layout, q/k/v by output rows (heads) over
    ``model``, o by input columns, embed and lm_head by vocabulary rows;
    norms and the router replicated."""
    rep = _ns(mesh)

    def layer_spec(pl):
        return {
            "input_norm": rep,
            "post_norm": rep,
            "q": _ns(mesh, MODEL, None),
            "k": _ns(mesh, MODEL, None),
            "v": _ns(mesh, MODEL, None),
            "o": _ns(mesh, None, MODEL),
            "router": rep,
        }

    out = {
        "embed": _ns(mesh, MODEL, None),
        "final_norm": rep,
        "layers": [layer_spec(pl) for pl in params["layers"]],
    }
    if "lm_head" in params:
        out["lm_head"] = _ns(mesh, MODEL, None)
    return out


_UNCUT = ("gateup", "gateup4", "gate4", "up4", "down4", "gateup_scale")


def expert_shardings(mesh: Mesh, expert_tree: Dict[str, Any]) -> Dict[str, Any]:
    """Every stacked expert array (2-D or more) on dim 0 over ``expert``;
    slot maps replicated. With a model axis above 1 the d_ff dim
    (``TP_MODEL_DIMS``, by the leaf's key) is sharded over ``model`` too,
    as ``ops.moe.grouped_ffn_ep`` computes it. Raises for a fused
    ``gateup`` or a packed int4 array under a model axis (``TP_MODEL_DIMS``
    says why)."""
    from moe_infinity_tpu_torch.common.arch import TP_MODEL_DIMS

    tp = mesh.shape[MODEL]

    def spec_for(leaf, key):
        if not (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2):
            return _ns(mesh)
        spec = [EXPERT] + [None] * (leaf.dim() - 1)
        if tp > 1:
            if key in _UNCUT:
                raise ValueError(
                    f"expert array {key!r} cannot be cut over the model axis: serve "
                    "unfused (fuse_gateup off) with int8, fp8 or 16-bit experts")
            mdim = TP_MODEL_DIMS.get(key)
            if mdim is not None and mdim < leaf.dim():
                spec[mdim] = MODEL
        return _ns(mesh, *spec)

    return _map(spec_for, expert_tree)


def shard_params(tree, shardings):
    """Each rank's slice of every leaf of ``tree`` by its sharding (a leaf
    that is not a tensor, or is replicated, is kept as it is)."""

    def go(t, s):
        if isinstance(t, dict):
            return {k: go(v, s[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v, sv) for v, sv in zip(t, s))
        if isinstance(t, torch.Tensor) and any(a is not None for a in s.spec):
            return local_slice(t, s)
        return t

    return go(tree, shardings)


def mesh_device(device: Optional[str] = None) -> torch.device:
    """A rank's default device: ``cuda:(rank % device_count)`` (with one
    card, ``cuda:0`` for every rank), or ``device`` when it names one."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev
