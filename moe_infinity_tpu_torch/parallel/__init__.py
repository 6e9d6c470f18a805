"""Parallel serving over ``torch.distributed``, from
``moe_infinity_tpu/parallel``: the resident mesh (``mesh.py``). Pod offload
(``pod.py``) and sequence parallelism (``sequence.py``) are not ported: their
names raise ``NotImplementedError`` naming ROADMAP items 18b and 18c."""

from moe_infinity_tpu_torch.parallel.mesh import (
    MeshPlan,
    expert_shardings,
    make_mesh,
    mixtral_param_shardings,
    shard_params,
)

_LATER = {
    "PodExpertPlan": "18b", "PodPrefetchCoordinator": "18b",
    "sp_prefill": "18c", "sp_encode": "18c", "SPDecoder": "18c", "caches_from_sp": "18c",
}

__all__ = [
    "MeshPlan",
    "make_mesh",
    "mixtral_param_shardings",
    "expert_shardings",
    "shard_params",
]


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"moe_infinity_tpu_torch.parallel.{name} is not ported "
            f"(ROADMAP queue-1 item {_LATER[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
