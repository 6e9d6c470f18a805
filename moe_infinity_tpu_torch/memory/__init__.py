"""EAMC tracing, prediction, prefetch planning and the cache policy of the
port (host numpy, copies of ``moe_infinity_tpu/memory/``)."""

from moe_infinity_tpu_torch.memory.cache_policy import CacheStats, ExpertCachePolicy
from moe_infinity_tpu_torch.memory.predictor import ExpertPredictor
from moe_infinity_tpu_torch.memory.prefetch_plan import adaptive_prefetch_budget, plan_prefetch
from moe_infinity_tpu_torch.memory.tracer import ExpertTracer, TraceEntry

__all__ = [
    "ExpertTracer",
    "TraceEntry",
    "ExpertPredictor",
    "ExpertCachePolicy",
    "CacheStats",
    "plan_prefetch",
    "adaptive_prefetch_budget",
]
