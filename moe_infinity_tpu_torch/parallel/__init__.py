"""Parallel serving over ``torch.distributed``, from
``moe_infinity_tpu/parallel``: the resident mesh (``mesh.py``), several
processes (``multihost.py``) and expert-parallel offload across ranks
(``pod.py``). Sequence parallelism (``sequence.py``) is not ported: its names
raise ``NotImplementedError`` naming ROADMAP item 18c."""

from moe_infinity_tpu_torch.parallel.mesh import (
    MeshPlan,
    expert_shardings,
    make_mesh,
    mixtral_param_shardings,
    shard_params,
)
from moe_infinity_tpu_torch.parallel.pod import (
    PodExpertPlan,
    PodOffloadExecutor,
    PodPrefetchCoordinator,
    PodSpecView,
)

_LATER = {"sp_prefill": "18c", "sp_encode": "18c", "SPDecoder": "18c", "caches_from_sp": "18c"}

__all__ = [
    "MeshPlan",
    "make_mesh",
    "mixtral_param_shardings",
    "expert_shardings",
    "shard_params",
    "PodExpertPlan",
    "PodPrefetchCoordinator",
    "PodOffloadExecutor",
    "PodSpecView",
]


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"moe_infinity_tpu_torch.parallel.{name} is not ported "
            f"(ROADMAP queue-1 item {_LATER[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
