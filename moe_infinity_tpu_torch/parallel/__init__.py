"""Parallel serving over ``torch.distributed``, from
``moe_infinity_tpu/parallel``: the resident mesh (``mesh.py``), several
processes (``multihost.py``), expert-parallel offload across ranks
(``pod.py``) and sequence parallelism (``sequence.py``: ring-attention
prefill and encode, decode over the frozen time shards)."""

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
from moe_infinity_tpu_torch.parallel.sequence import (
    SPDecoder,
    caches_from_sp,
    sp_encode,
    sp_prefill,
)

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
    "sp_prefill",
    "sp_encode",
    "caches_from_sp",
    "SPDecoder",
]
