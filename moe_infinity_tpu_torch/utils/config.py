"""Engine configuration, from ``moe_infinity_tpu/utils/config.py``.

The same fields, defaults and JSON round trip as the JAX package's
``EngineConfig`` (so one engine JSON serves both packages), plus validation
of the fields whose values the port reads: the dense-paging mode, the load
mode, the seq2seq batcher, the sizes and the parallel degrees. Which plans
the port serves is the facade's business (``entrypoints/api.py::MoE``):
it raises ``NotImplementedError`` for the rest, naming the ROADMAP item.

The device is not a field: ``MoE(path, config, device="cuda")`` takes it
as a keyword.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class EngineConfig:
    # ---- storage tiers -------------------------------------------------
    offload_path: str = ""
    """Directory holding the converted expert store (blob + index + name map).
    Must be unique per model, like the reference's `offload_path`."""

    load_mode: str = "mmap"
    """Host tier for the expert blob: mmap (page cache) | ram (pinned full
    copy) | direct (native O_DIRECT reads) | sched (native priority
    scheduler: on-demand reads preempt prefetch reads at block
    granularity, csrc/sched.cc)."""

    # ---- tracing / prediction ------------------------------------------
    trace_capacity: int = 1000
    """Max number of finished per-sequence expert-activation matrices kept
    for cosine-similarity prediction (EAMC collection bound)."""

    trace_path: Optional[str] = None
    """Optional .npz file to load/persist the EAMC trace collection."""

    prefetch: bool = True
    """Enable activation-aware prefetching (on by default)."""

    # ---- memory budgets -------------------------------------------------
    device_memory_ratio: float = 0.9
    """Fraction of the device's memory the engine may use (weights + arena
    + KV): on the card, of ``torch.cuda.get_device_properties(...).
    total_memory``; on the CPU, of the JAX package's 16 GiB constant, so
    that plans match the JAX facade's in tests."""

    host_memory_ratio: float = 0.9
    """Fraction of host RAM usable for the pinned expert tier."""

    device_memory_bytes: Optional[int] = None
    """Absolute override of the per-chip HBM budget (wins over ratio).
    Useful for tests and for `device_memory_ratio` sweeps."""

    num_slots: Optional[int] = None
    """Number of expert slots in the HBM arena. Default: derived from the
    device memory budget after dense weights + KV cache are accounted."""

    dense_paging: str = "auto"
    """Page the DENSE layer stack through a slot arena when it does not fit
    the HBM budget (the reference pages dense nodes the same way it pages
    experts, model_topology.cpp:518-530): auto | on | off. `auto` enables
    paging only when the dense side exceeds the budget's dense share; `on`
    forces it (tests/benchmarks); `off` requires the dense side resident
    (raises if it cannot fit)."""

    dense_slots: Optional[int] = None
    """Number of layer slots in the dense paging arena. Default: derived
    from the budget share left after expert slots and KV."""

    host_fallback: bool = False
    """Run-on-host escape hatch (per-layer offload paths): a routed expert
    that cannot be made resident within host_fallback_timeout_s executes on
    the HOST from the store record while the device program contributes 0
    through a reserved zero slot — a miss bounds step latency instead of
    stalling it (the reference left CPU execution commented out,
    task_scheduler.cpp:143-151). Output stays exact."""

    host_fallback_timeout_s: float = 0.25
    """Deadline for making a routed expert resident before it runs on the
    host (host_fallback=True only)."""

    pinned_tier: bool = False
    """Stage the expert store in the device's pinned_host memory at load:
    every fetch becomes a single device-side DMA program (record sliced
    out of the tier straight into its arena slot) instead of a host read +
    H2D upload — ~100x lower fetch latency, fully overlapping compute.
    Costs one bulk staging pass and host RAM for the full expert table
    (the reference's pinned HostMemoryPool, memory_pool.cpp:62-76)."""

    # ---- compute --------------------------------------------------------
    expert_dtype: str = "bfloat16"
    """Storage dtype of offloaded experts: bfloat16 | int8 | int4 | float8_e4m3fn."""

    dequant_on_write: bool = False
    """Offload plan only: dequantize expert uploads into compute-dtype
    arena slots (quantized bytes still ride the interconnect). Default
    keeps slots quantized and fuses dequant into the expert matmul."""

    use_pallas: Optional[bool] = None
    """Kept for the JAX package's JSON; the port does not read it (the
    kernels are chosen by ``moe_impl``/``prefill_impl`` and the tensors'
    device)."""

    moe_impl: str = "ragged"
    """Grouped expert-FFN implementation for decode-sized steps (T=1):
    ragged | gather | pallas | dense. `gather` is the fastest exact path at
    small token counts (reads exactly the routed experts' bytes, no sort)."""

    prefill_impl: Optional[str] = None
    """Grouped expert-FFN implementation for prefill-sized steps (T>1);
    None = same as moe_impl. At large T the grouped-GEMM impls (`ragged` /
    `pallas` gmm) read each routed expert's weights once instead of once
    per (token, k) row, so their HBM traffic is O(E) not O(T*K)."""

    num_threads: int = 4
    """Host worker threads for the prefetch/fetch controller (the reference
    uses this for per-GPU exec threads; here it sizes the DMA controller)."""

    # ---- generation -----------------------------------------------------
    max_seq_len: int = 2048
    """Static KV-cache sequence capacity per slot (paged KV page count
    derives from this)."""

    kv_page_size: int = 128
    """Tokens per KV-cache page."""

    max_batch_size: int = 8
    """Continuous-batching slot count."""

    prefill_chunk: int = 8
    """Prompt tokens ingested per shared step in the continuous batcher
    (chunked prefill). 1 = hole-free single-token piggyback prefill."""

    s2s_batcher: str = "continuous"
    """Seq2seq concurrent-serving strategy: "continuous" (requests join
    the decode batch mid-flight via per-row decode positions) or "wave"
    (requests coalesce into aligned batched waves)."""

    fold_mla: bool = False
    """DeepSeek/MLA models: fold w_uk + attention scale into the q
    projection and w_uv into o_proj (fewer decode ops; exact up to f32
    re-association)."""

    fuse_gateup: bool = False
    """Resident plans: concatenate gate+up expert weights so the grouped
    FFN runs one matmul for both projections (exact)."""

    speculative_tokens: int = 0
    """Greedy batch-1 decode: draft this many tokens per step via prompt-
    lookup (n-gram) speculation and verify in one forward (exact; 0 = off)."""

    speculative_decode: bool = False
    """Offload plans: run each decode step as ONE compiled program over
    the arena's current slots, verify the routed ids on host, and replay
    after loading misses (exact; zero per-layer host sync). Requires the
    arena to hold one step's union of routed experts across MoE layers."""

    speculative_block: int = 1
    """With speculative_decode: run this many GREEDY decode steps per
    compiled program (one lax.scan block, verified + replayed as a unit)
    — amortizes per-program dispatch by the block size. Sampled/logprobs
    requests fall back to single-step automatically; an arena too small
    for a block's expert union downgrades to 1 at runtime."""

    # ---- parallelism ----------------------------------------------------
    data_parallel: int = 1
    tensor_parallel: int = 1
    expert_parallel: int = 1
    """Mesh axis sizes (data, model, expert). Their product is the world
    size of the process group the caller initialised (one process per
    rank, ``parallel/mesh.py``); 1/1/1 means one rank."""

    sequence_parallel: int = 1
    """Long-context ring size: > 1 shards prompts over a `seq` mesh axis
    (ring-attention prefill + SP decode over the frozen shards). Batch-1
    greedy requests with prompts >= the ring size ride it; currently
    exclusive with tensor/expert_parallel."""

    multihost: bool = False
    """Multi-host offload serving in the JAX package (a pod engine over an
    expert-axis mesh). Not ported: the facade raises for it (ROADMAP
    item 18b)."""

    coordinator_address: str = ""
    """Coordinator address (host:port) of a multi-host run; the port
    does not serve multihost (ROADMAP item 18b)."""

    num_processes: int = 0
    process_id: int = -1
    """Explicit process topology for CPU multi-process tests; ignored when
    coordinator_address is empty."""

    # ---- misc -----------------------------------------------------------
    seed: int = 0
    log_level: str = "INFO"

    def __post_init__(self) -> None:
        if self.trace_path is not None:
            self.trace_path = os.path.abspath(self.trace_path)
            if os.path.isdir(self.trace_path):
                raise ValueError("trace_path must be a file, not a directory")
        if not 0.0 < self.device_memory_ratio <= 1.0:
            raise ValueError("device_memory_ratio must be in (0, 1]")
        if not 0.0 < self.host_memory_ratio <= 1.0:
            raise ValueError("host_memory_ratio must be in (0, 1]")
        if self.expert_dtype not in ("bfloat16", "float32", "float16", "int8", "int4", "float8_e4m3fn"):
            raise ValueError(f"unsupported expert_dtype {self.expert_dtype!r}")
        impls = ("ragged", "gather", "pallas", "dense")
        if self.moe_impl not in impls:
            raise ValueError(f"moe_impl must be one of {impls}")
        if self.prefill_impl is not None and self.prefill_impl not in impls:
            raise ValueError(f"prefill_impl must be one of {impls} or None")
        if self.load_mode not in ("mmap", "ram", "direct", "sched"):
            raise ValueError(f"unknown load_mode {self.load_mode!r}")
        if self.dense_paging not in ("auto", "on", "off"):
            raise ValueError("dense_paging must be auto, on or off")
        if self.s2s_batcher not in ("continuous", "wave"):
            raise ValueError("s2s_batcher must be continuous or wave")
        for name in ("max_seq_len", "kv_page_size", "max_batch_size", "prefill_chunk",
                     "num_threads", "speculative_block", "data_parallel",
                     "tensor_parallel", "expert_parallel", "sequence_parallel"):
            if int(getattr(self, name)) < 1:
                raise ValueError(f"{name} must be at least 1")
        if self.speculative_tokens < 0:
            raise ValueError("speculative_tokens must be at least 0")
        for name in ("num_slots", "dense_slots", "device_memory_bytes"):
            v = getattr(self, name)
            if v is not None and int(v) < 1:
                raise ValueError(f"{name} must be at least 1 or None")

    # -- constructors mirroring the reference API -------------------------
    @classmethod
    def load_from_json(cls, config: Dict[str, Any]) -> "EngineConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(config) - known
        if unknown:
            raise ValueError(f"unknown EngineConfig keys: {sorted(unknown)}")
        return cls(**config)

    @classmethod
    def load_from_file(cls, path: str) -> "EngineConfig":
        with open(path) as f:
            return cls.load_from_json(json.load(f))

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @property
    def perfect_cache_file(self) -> str:
        return os.path.join(self.offload_path, "perfect_cache")
