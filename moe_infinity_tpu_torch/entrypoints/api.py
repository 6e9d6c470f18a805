"""User-facing MoE engine facade, from ``moe_infinity_tpu/entrypoints/api.py``.

``MoE(checkpoint, config, device="cuda").generate(input_ids, ...)``:

  1. read the checkpoint's ``config.json`` (``utils/hf_config.py``, no
     ``transformers``) and detect the architecture;
  2. ingest the checkpoint into the expert-major offload store and the dense
     archive (``store/ingest.py``; a warm start when the store exists);
  3. build the port's model and load its dense params onto the device;
  4. pick the plan: the dense layers resident, or paged through a
     ``DenseLayerArena`` when they do not fit their share of the budget
     (``dense_paging``); every expert resident when the experts fit the
     device budget, otherwise the slot-arena offload engine under the EAMC
     tracer, predictor and prefetch; a dense-only model (OPT) through
     ``ResidentStepper`` or, paged, ``PagedDenseEngine``;
  5. drive generation through ``Generator`` (decoder-only), a
     ``ContinuousBatcher`` for concurrent requests (decoder-only at
     ``max_batch_size`` > 1: over the resident experts, or over the offload
     engine's arena with ``speculative_decode``), ``Seq2SeqGenerator`` or
     the offload engines; encoder-decoder models at ``max_batch_size`` > 1
     batch concurrent greedy requests through ``Seq2SeqContinuousBatcher``
     (``s2s_batcher`` "continuous", the default: resident, or over the
     offload engine with ``speculative_decode``) or the wave batcher
     ``Seq2SeqDynamicBatcher`` ("wave", resident); ``speculative_tokens``
     > 0 serves greedy batch-1 decoder-only requests by prompt lookup
     (``runtime/speculative.py``).

The device budget is ``device_memory_bytes``, else the device's memory
times ``device_memory_ratio``: ``torch.cuda.get_device_properties`` on the
card, and the JAX package's 16 GiB on the CPU, so that the CPU tests plan as
the JAX facade does. CUDA graphs are on wherever the port has them: the
seq2seq generator, batcher and engines (NLLB and Switch) and the
decoder-only offload engine for every model whose step sets ``graph_step``
(Mixtral, Grok-1, Arctic), where ``moe_impl`` can be captured
(``ops.moe.capturable``: not "ragged"); DeepSeek's offload engine runs eagerly. Experts are stored as
``expert_dtype`` says: bf16, f32, f16, int8, int4 or ``float8_e4m3fn``.

With paged dense layers the expert plan is offload and decoding takes the
per-layer path (no speculative decode, no batcher), eagerly.
``host_fallback`` gives the expert arena its zero slot and lets the offload
engines run a missed expert on the host (``runtime/host_exec.py``).

The store opens in ``load_mode``: ``mmap``, ``ram``, or the native
reader's ``direct`` and ``sched`` (``store/native.py``, built at first use).
Checkpoints may be plain, GPTQ or DeepSeek-V3's block-fp8 ones
(``store/ingest.py``).

A resident mesh (``data_parallel``, ``tensor_parallel`` and
``expert_parallel``, ``parallel/mesh.py``) runs SPMD, one process per rank:
the caller initialises ``torch.distributed`` (e.g. ``torchrun
--nproc-per-node N``) and every rank builds ``MoE(...)`` and calls
``generate`` with the same inputs. Each rank's device is
``cuda:(rank % device_count)``; the experts are sharded on their slots over
the expert axis and on d_ff over the model axis, Mixtral's dense weights by
heads and vocabulary over the model axis (other families replicate theirs,
as the JAX facade does), and the batch rows over the data axis. A mesh serves
through the generators only (no batcher), eagerly (its collectives are not
captured in CUDA graphs), with unfused experts. The mesh is built only for a
resident plan (a rank's share of the experts fits its budget, dense layers
not paged); otherwise the degrees go unused, as in the JAX facade (logged),
and each process serves alone: a checkpoint with no experts, paged dense
layers, an offload plan without ``multihost``.

``multihost`` serves offload across ranks (``runtime/pod_engine.py``: each
rank's expert coordinate in its own arena, a slot-row exchange every MoE
layer), with ``coordinator_address`` initialising the process group
(``parallel/multihost.py``) or the caller's group otherwise. It needs
``expert_parallel`` > 1 and resident dense layers, and seq2seq models take
``data_parallel`` 1, as in the JAX facade.

``sequence_parallel`` above 1 raises ``NotImplementedError`` naming ROADMAP
queue-1 item 18c.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from moe_infinity_tpu_torch import resolve_device
from moe_infinity_tpu_torch.ops.moe import capturable
from moe_infinity_tpu_torch.runtime.engine import _not_ported
from moe_infinity_tpu_torch.utils.config import EngineConfig
from moe_infinity_tpu_torch.utils.logger import get_logger

logger = get_logger("api")

_SEQ2SEQ_ARCHS = ("switch", "nllb")
# the JAX facade's default budget: the HBM of the TPU it was written for
_JAX_DEFAULT_HBM = 16 * 2**30


def _registry() -> Dict[str, tuple]:
    from moe_infinity_tpu_torch.models.arctic import ArcticModel, ArcticSpec
    from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model, DeepseekV2Spec
    from moe_infinity_tpu_torch.models.grok import GrokModel, GrokSpec
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec
    from moe_infinity_tpu_torch.models.opt import OPTModel, OPTSpec
    from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec

    return {
        "mixtral": (MixtralSpec, MixtralModel),
        "deepseek": (DeepseekV2Spec, DeepseekV2Model),
        "deepseek_v3": (DeepseekV2Spec, DeepseekV2Model),
        "switch": (SwitchSpec, SwitchModel),
        "nllb": (NllbSpec, NllbModel),
        "grok": (GrokSpec, GrokModel),
        "arctic": (ArcticSpec, ArcticModel),
        "opt": (OPTSpec, OPTModel),
    }


def _dense_bytes_estimate(dense, compute_itemsize: int) -> int:
    """Device bytes of the dense side after load_params' casting rule
    (matrices in the compute dtype, 1-D tensors in f32)."""
    total = 0
    for name in dense.names():
        shape = dense.shape(name)
        n = int(np.prod(shape, dtype=np.int64))
        total += n * (compute_itemsize if len(shape) >= 2 else 4)
    return total


def _tensor_bytes(tree) -> int:
    from moe_infinity_tpu_torch.runtime.graphs import flat_tensors

    return sum(t.numel() * t.element_size() for t in flat_tensors(tree))


def _to_device(tree, device):
    from moe_infinity_tpu_torch.runtime.dense_arena import tree_map

    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


def _check_config(config: EngineConfig) -> None:
    """Raise for the options whose plans the port does not serve."""
    if config.sequence_parallel > 1:
        raise _not_ported(f"sequence_parallel={config.sequence_parallel}", "18c")


def _rank_share_bytes(params, shardings, plan) -> int:
    """A rank's bytes of ``params`` under ``shardings`` (a tree of
    ``parallel.mesh.Sharding``): each leaf over the product of its sharded
    axes' sizes in ``plan``."""
    if isinstance(params, dict):
        return sum(_rank_share_bytes(v, shardings[k], plan) for k, v in params.items())
    if isinstance(params, (list, tuple)):
        return sum(_rank_share_bytes(v, sv, plan) for v, sv in zip(params, shardings))
    if not isinstance(params, torch.Tensor):
        return 0
    n = 1
    for axes in shardings.spec:
        for a in ((axes,) if isinstance(axes, str) else (axes or ())):
            n *= getattr(plan, a)
    return params.numel() * params.element_size() // n


def _mesh_plan(config: EngineConfig):
    """The resident mesh's ``MeshPlan``, or None for one rank."""
    from moe_infinity_tpu_torch.parallel.mesh import MeshPlan

    plan = MeshPlan(data=config.data_parallel, model=config.tensor_parallel,
                    expert=config.expert_parallel)
    return plan if plan.num_devices > 1 else None


class MoE:
    """``MoE(checkpoint, config, device="cuda")``: config is an
    ``EngineConfig``, a dict of its fields, or None (defaults, with the
    offload store next to the checkpoint). ``device="cpu"`` runs the plain
    PyTorch versions of the kernels."""

    def __init__(
        self,
        model_name_or_path: Union[str, os.PathLike],
        config: Union[EngineConfig, Dict[str, Any], None] = None,
        *,
        device="cuda",
    ):
        from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
        from moe_infinity_tpu_torch.runtime.generate import Generator, ResidentStepper
        from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
        from moe_infinity_tpu_torch.store.blob import DenseArchive, ExpertStore
        from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
        from moe_infinity_tpu_torch.utils.hf_config import (
            detect_arch,
            parse_geometry,
            read_hf_config,
        )

        if config is None:
            config = EngineConfig()
        elif isinstance(config, dict):
            config = EngineConfig.load_from_json(config)
        self.config = config
        _check_config(config)
        self.mesh = None
        plan = _mesh_plan(config)
        if config.multihost and config.coordinator_address:
            from moe_infinity_tpu_torch.parallel.multihost import init_multihost

            init_multihost(config.coordinator_address,
                           num_processes=config.num_processes or None,
                           process_id=None if config.process_id < 0 else config.process_id)
        if (plan is not None or config.multihost) and torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            from moe_infinity_tpu_torch.parallel.mesh import mesh_device

            device = mesh_device(device)  # each rank's own card
        self.device = resolve_device(device)
        checkpoint = str(model_name_or_path)
        if not config.offload_path:
            config.offload_path = os.path.join(
                checkpoint if os.path.isdir(checkpoint) else ".", "moe_tpu_store")

        self.hf_config = read_hf_config(checkpoint)
        self.arch = detect_arch(self.hf_config)
        registry = _registry()
        if self.arch not in registry:
            raise NotImplementedError(f"arch {self.arch!r} not wired into the MoE entry point; "
                                      f"available: {sorted(registry)}")
        self.geometry = parse_geometry(self.hf_config)
        seq2seq = self.arch in _SEQ2SEQ_ARCHS

        # the spec first: a variant the model does not take is refused before
        # anything is ingested
        spec_cls, model_cls = registry[self.arch]
        spec = spec_cls.from_hf(self.hf_config)
        ingest_checkpoint(checkpoint, config.offload_path, self.hf_config,
                          expert_dtype=config.expert_dtype)
        dense = DenseArchive(config.offload_path)

        compute_dtype = torch.float32 if config.expert_dtype == "float32" else torch.bfloat16
        # the mesh, if any, comes with the plan below (the model is rebuilt on it)
        self.model = model_cls(spec, compute_dtype, device=self.device)

        # ---- the budget, and dense residency before any device load ----
        budget = config.device_memory_bytes
        if budget is None:
            total = (torch.cuda.get_device_properties(self.device).total_memory
                     if self.device.type == "cuda" else _JAX_DEFAULT_HBM)
            budget = int(total * config.device_memory_ratio)
        self.budget = budget
        dense_est = _dense_bytes_estimate(dense, torch.finfo(compute_dtype).bits // 8)
        # the dense share of the budget: all of it for a dense-only model, a
        # part otherwise (experts and K/V take the rest)
        dense_share = 1.0 if self.geometry.num_experts == 0 else 0.6
        page_dense = config.dense_paging == "on" or (
            config.dense_paging == "auto" and dense_est > budget * dense_share)
        self.dense_arena = None
        if page_dense:
            self._page_dense_layers(dense, model_cls, seq2seq, budget)
        else:
            self.params = self.model.load_params(dense)
            if config.fold_mla and hasattr(self.model, "fold_mla_params"):
                self.params = self.model.fold_mla_params(self.params)

        self.batcher = None
        self.s2s_batcher = None
        self.engine = None
        self.last_result = None
        self._spec = None  # the prompt-lookup decoder, made at its first request

        # ---- dense-only models (OPT): no experts, no residency plan -----
        if self.geometry.num_experts == 0:
            if config.multihost:
                raise NotImplementedError(
                    "multihost pod serving needs an MoE architecture "
                    "(expert-parallel mesh); this checkpoint has no experts")
            self._unused_degrees(plan, "a checkpoint with no experts")
            if self.dense_arena is not None:
                from moe_infinity_tpu_torch.runtime.dense_arena import PagedDenseEngine

                self.engine = PagedDenseEngine(self.model, self.params, self.dense_arena)
                stepper = self.engine
            else:
                stepper = ResidentStepper(self.model, self.params, {},
                                          lambda experts, mli: experts)
            self.generator = Generator(stepper=stepper, max_seq_len=config.max_seq_len)
            return

        store = ExpertStore(config.offload_path, load_mode=config.load_mode)
        expert_bytes = store.stride * store.num_layers * store.num_experts
        dense_bytes = _tensor_bytes(self.params)
        if self.dense_arena is not None:
            # the paged stack takes its arena's slots, not its full size
            dense_bytes += self.dense_arena.device_bytes
        if config.multihost:
            self._serve_pod(store, model_cls, spec, compute_dtype, budget, dense_bytes, seq2seq)
            return
        pinned_tier = None
        if config.pinned_tier:
            from moe_infinity_tpu_torch.store.pinned import PinnedExpertTier

            pinned_tier = PinnedExpertTier(store, device=self.device)
        paged = self.dense_arena is not None
        if plan is not None and not paged:
            # a resident mesh serves when a rank's share of the experts fits
            share = expert_bytes // (plan.model * plan.expert)
            dense_share = dense_bytes
            if self.arch == "mixtral" and plan.model > 1:
                from moe_infinity_tpu_torch.parallel.mesh import mixtral_param_shardings

                dense_share = _rank_share_bytes(
                    self.params, mixtral_param_shardings(None, self.params), plan)
            if share <= budget - dense_share:
                self._build_mesh(plan, model_cls, spec, compute_dtype)
                expert_bytes, dense_bytes = share, dense_share
        if plan is not None and self.mesh is None:
            self._unused_degrees(plan, "paged dense layers" if paged
                                 else "an offload plan without multihost")
        # paged dense layers need the engine's per-layer path
        fits = expert_bytes <= budget - dense_bytes and not paged
        # CUDA graphs of the decode step where the grouped FFN can be
        # captured; a decoder-only model also says whether its step can be
        # one (graph_step). A mesh's collectives are not captured.
        graphs = capturable(config.moe_impl) and self.mesh is None and (
            seq2seq or getattr(self.model, "graph_step", False))

        def offload_parts():
            from moe_infinity_tpu_torch.runtime.arena import ExpertArena

            num_slots = config.num_slots or max(
                store.num_experts, int((budget - dense_bytes) // store.stride))
            logger.info("offload plan: %d arena slots of %d (L x E) experts",
                        num_slots, store.num_layers * store.num_experts)
            arena = ExpertArena(store, num_slots, compute_dtype=compute_dtype,
                                device=self.device, num_threads=config.num_threads,
                                dequant_on_write=config.dequant_on_write,
                                reserve_zero_slot=config.host_fallback,
                                pinned_tier=pinned_tier)
            tracer = ExpertTracer(config.trace_capacity, store.num_layers, store.num_experts,
                                  store.meta.get("num_encoder_moe_layers", 0))
            if config.trace_path and os.path.exists(config.trace_path):
                tracer.load_trace(config.trace_path)
            return dict(arena=arena, tracer=tracer, predictor=ExpertPredictor(tracer),
                        prefetch=config.prefetch, impl=config.moe_impl,
                        prefill_impl=config.prefill_impl,
                        # paged dense layers force the per-layer path
                        speculative=config.speculative_decode and not paged,
                        spec_block=config.speculative_block, graphs=graphs,
                        dense_arena=self.dense_arena, host_fallback=config.host_fallback,
                        host_fallback_timeout=config.host_fallback_timeout_s)

        def resident_experts():
            logger.info("experts fit the device (%.2f GB <= %.2f GB budget): resident plan",
                        expert_bytes / 2**30, (budget - dense_bytes) / 2**30)
            tree = ResidentProvider.from_store(store, dtype=compute_dtype,
                                               device=self.device).pytree()
            if self.mesh is not None:
                from moe_infinity_tpu_torch.parallel.mesh import expert_shardings, shard_params

                return shard_params(tree, expert_shardings(self.mesh, tree))
            if config.fuse_gateup:
                from moe_infinity_tpu_torch.ops.moe import fuse_gateup

                tree["layers"] = [fuse_gateup(w) for w in tree["layers"]]
            return tree

        # ---- seq2seq: the enc-dec generator or the enc-dec offload engine,
        # and a batcher for concurrent greedy requests
        if seq2seq:
            from moe_infinity_tpu_torch.runtime.continuous_s2s import Seq2SeqContinuousBatcher

            batched = config.max_batch_size > 1 and self.mesh is None
            s2s = dict(impl=config.moe_impl, max_batch_size=config.max_batch_size,
                       max_src_len=config.max_seq_len, max_decode_len=config.max_seq_len)
            if fits:
                from moe_infinity_tpu_torch.runtime.generate import Seq2SeqGenerator

                experts = resident_experts()
                self.generator = Seq2SeqGenerator(
                    self.model, self.params, experts, ResidentProvider.for_layer,
                    impl=config.moe_impl, graphs=graphs)
                if batched and config.s2s_batcher == "continuous":
                    self.s2s_batcher = Seq2SeqContinuousBatcher(
                        self.model, self.params, experts, ResidentProvider.for_layer,
                        graphs=graphs, **s2s)
                elif batched:
                    from moe_infinity_tpu_torch.runtime.batching import Seq2SeqDynamicBatcher

                    self.s2s_batcher = Seq2SeqDynamicBatcher(
                        self.model, self.params, experts, ResidentProvider.for_layer,
                        impl=config.moe_impl, max_batch_size=config.max_batch_size,
                        max_seq_len=config.max_seq_len)
            else:
                from moe_infinity_tpu_torch.runtime.engine_seq2seq import Seq2SeqOffloadEngine

                parts = offload_parts()
                self.engine = Seq2SeqOffloadEngine(self.model, self.params, parts.pop("arena"),
                                                   **parts)
                self.generator = self.engine  # the same generate() surface
                # concurrent offload serving: joins encode through the
                # engine's per-layer path, each shared step is one verified
                # speculative execution over the arena
                if (batched and config.speculative_decode and not paged
                        and config.s2s_batcher == "continuous"):
                    self.s2s_batcher = Seq2SeqContinuousBatcher(
                        self.model, self.params, None, None, engine=self.engine, **s2s)
                elif batched:
                    # the wave batcher needs a resident expert tree, and
                    # offload batching rides speculative decode; concurrent
                    # generate() calls still serialize on the arena's client_lock
                    logger.warning(
                        "seq2seq offload plan: concurrent batching needs "
                        "speculative_decode=True and s2s_batcher='continuous' (got %s/%s); "
                        "requests will serialize",
                        config.speculative_decode, config.s2s_batcher)
            return

        # ---- decoder-only: resident stepper or the offload engine -------
        if fits:
            experts = resident_experts()
            stepper = ResidentStepper(self.model, self.params, experts,
                                      ResidentProvider.for_layer, impl=config.moe_impl,
                                      prefill_impl=config.prefill_impl,
                                      graphs=self.mesh is None)
            if config.data_parallel > 1:
                stepper.set_data_sharding(self.mesh)
        else:
            from moe_infinity_tpu_torch.runtime.engine import OffloadEngine

            parts = offload_parts()
            self.engine = OffloadEngine(self.model, self.params, parts.pop("arena"), **parts)
            stepper = self.engine
        self.generator = Generator(stepper=stepper, max_seq_len=config.max_seq_len)

        # continuous batching for concurrent serving: over the resident
        # experts, or (with speculative_decode) over the offload engine's
        # arena, every batched step one verified speculative execution
        if (config.max_batch_size > 1 and not paged and self.mesh is None
                and "key_valid" in self.model.forward.__code__.co_varnames
                and (fits or config.speculative_decode)):
            from moe_infinity_tpu_torch.runtime.continuous import ContinuousBatcher

            page_size = min(config.kv_page_size, config.max_seq_len)
            pages = max(8, (config.max_seq_len // page_size) * (config.max_batch_size + 1))
            common = dict(impl=config.moe_impl, max_batch_size=config.max_batch_size,
                          page_size=page_size, num_pages=pages, max_cols=config.max_seq_len,
                          prefill_chunk=config.prefill_chunk)
            if fits:
                self.batcher = ContinuousBatcher(
                    self.model, self.params, experts, ResidentProvider.for_layer, **common)
            else:
                self.batcher = ContinuousBatcher(
                    self.model, self.params, None, None, arena=self.engine.arena,
                    tracer=self.engine.tracer, predictor=self.engine.predictor,
                    prefetch=config.prefetch, **common)

    def _unused_degrees(self, plan, why: str) -> None:
        if plan is not None:
            logger.info("%s: data/tensor/expert parallel %d/%d/%d unused (no mesh); this "
                        "process serves alone", why, plan.data, plan.model, plan.expert)

    def _build_mesh(self, plan, model_cls, spec, compute_dtype) -> None:
        """The resident mesh: the model rebuilt on it, Mixtral's dense
        weights sharded over its model axis."""
        from moe_infinity_tpu_torch.parallel.mesh import (
            make_mesh,
            mixtral_param_shardings,
            shard_params,
        )

        self.mesh = make_mesh(plan)  # raises without a process group of the plan's size
        self.model = model_cls(spec, self.model.dtype, device=self.device, mesh=self.mesh)
        if self.arch == "mixtral" and plan.model > 1:
            self.params = shard_params(self.params, mixtral_param_shardings(self.mesh, self.params))

    def _serve_pod(self, store, model_cls, spec, compute_dtype, budget: int, dense_bytes: int,
                   seq2seq: bool) -> None:
        """``multihost``: offload across ranks (``runtime/pod_engine.py``)
        over ``global_mesh``, slots a coordinate from this rank's budget, as
        the JAX facade's two multihost branches plan it."""
        from moe_infinity_tpu_torch.memory import ExpertPredictor, ExpertTracer
        from moe_infinity_tpu_torch.parallel.mesh import MeshPlan
        from moe_infinity_tpu_torch.parallel.multihost import global_mesh
        from moe_infinity_tpu_torch.parallel.pod import PodOffloadExecutor
        from moe_infinity_tpu_torch.runtime.generate import Generator
        from moe_infinity_tpu_torch.runtime.pod_engine import (
            PodOffloadEngine,
            PodSeq2SeqOffloadEngine,
        )

        config = self.config
        ep, tp = config.expert_parallel, config.tensor_parallel
        if ep <= 1:
            raise ValueError("multihost serving needs expert_parallel > 1 (the expert axis "
                             "spans every addressable device)")
        if seq2seq and config.data_parallel != 1:
            raise NotImplementedError(
                "seq2seq multihost serving composes model x expert (data_parallel must be 1; "
                "the decoder-only pod path additionally composes the data axis)")
        if self.dense_arena is not None:
            # dense layers have no sparsity to exploit: paging them refetches
            # all their bytes every token, where expert slots hit their cache
            raise NotImplementedError(
                "multihost serving keeps the dense side resident by design (dense layers "
                "have no sparsity to exploit; shard them over the model axis instead)")
        dp = 1 if seq2seq else config.data_parallel
        self.mesh = global_mesh(MeshPlan(data=dp, model=tp, expert=ep))
        kw = {"shard_dense": False} if self.arch == "mixtral" else {}
        self.model = model_cls(spec, compute_dtype, device=self.device, mesh=self.mesh, **kw)
        # TP x EP: a slot holds 1/tp of a record, so the budget affords tp x the slots
        per_coord = config.num_slots or max(-(-store.num_experts // ep),
                                            int((budget - dense_bytes) * tp // store.stride))
        logger.info("pod offload plan: data axis %d x model axis %d x expert axis %d, "
                    "%d slots/coordinate", dp, tp, ep, per_coord)
        executor = PodOffloadExecutor(self.mesh, store, per_coord, compute_dtype=compute_dtype,
                                      device=self.device, num_threads=config.num_threads,
                                      host_fallback=config.host_fallback,
                                      host_fallback_timeout=config.host_fallback_timeout_s)
        tracer = ExpertTracer(config.trace_capacity, store.num_layers, store.num_experts,
                              store.meta.get("num_encoder_moe_layers", 0))
        if config.trace_path and os.path.exists(config.trace_path):
            tracer.load_trace(config.trace_path)
        common = dict(tracer=tracer, predictor=ExpertPredictor(tracer), prefetch=config.prefetch,
                      impl=config.moe_impl)
        if seq2seq:
            self.engine = PodSeq2SeqOffloadEngine(self.model, self.params, executor,
                                                  prefill_impl=config.prefill_impl, **common)
            self.generator = self.engine  # the same generate() surface
        else:
            self.engine = PodOffloadEngine(self.model, self.params, executor,
                                           speculative=config.speculative_decode,
                                           spec_block=config.speculative_block, **common)
            self.generator = Generator(stepper=self.engine, max_seq_len=config.max_seq_len)

    def _page_dense_layers(self, dense, model_cls, seq2seq: bool, budget: int):
        """Load the layer stack to the host and page it through a
        ``DenseLayerArena``; the rest of the params goes to the device. A
        seq2seq stack is the encoder's blocks then the decoder's, and its
        ``enc_blocks``/``dec_blocks`` become one-element stubs holding only
        what the preludes read (Switch's ``rel_bias``)."""
        from moe_infinity_tpu_torch.runtime.dense_arena import DenseLayerArena

        config = self.config
        host = model_cls(self.model.spec, self.model.dtype, device="cpu").load_params(dense)
        if seq2seq:
            enc, dec = host.pop("enc_blocks"), host.pop("dec_blocks")
            layers = list(enc) + list(dec)
            self.params = _to_device(host, self.device)
            for name, blocks in (("enc_blocks", enc), ("dec_blocks", dec)):
                self.params[name] = [{"rel_bias": blocks[0]["rel_bias"].to(self.device)}
                                     if "rel_bias" in blocks[0] else {}]
        else:
            layers = host.pop("layers")
            self.params = _to_device(host, self.device)
        top_bytes = _tensor_bytes(self.params)
        layer_bytes = max(1, int(np.mean([_tensor_bytes(lt) for lt in layers])))
        avail = max(0, budget - top_bytes - budget // 10)
        want = avail // layer_bytes if self.geometry.num_experts == 0 \
            else int(0.45 * avail) // layer_bytes
        slots = min(config.dense_slots or max(2, int(want)), len(layers))
        logger.info("dense paging: %d layer slots of %d layers (%.2f GB/layer)",
                    slots, len(layers), layer_bytes / 2**30)
        self.dense_arena = DenseLayerArena(layers, slots, device=self.device,
                                           num_threads=config.num_threads)
        if not seq2seq:
            # the engines never read params["layers"] when paging
            self.params["layers"] = [None] * len(layers)

    # ---- generation -----------------------------------------------------
    def generate(self, input_ids, **kwargs) -> np.ndarray:
        """HF-like generate: max_new_tokens, eos_token_id (default: the
        config's; a list stops on any member), pad_token_id, do_sample
        (True defaults the temperature to 1.0), temperature, top_k, top_p,
        min_p, the penalties, logit_bias, logprobs, seed. Returns [B, T']
        ids. Concurrent batch-1 callers share a batcher when one is active:
        on an encoder-decoder model plain greedy requests only (any sampling
        knob, logprobs, logit_bias, an attention_mask or a decoder start
        token goes to the generator); greedy batch-1 requests of a
        decoder-only model with ``speculative_tokens`` take prompt-lookup
        speculation and the rest run the generator, both under the arena's
        ``client_lock`` on an offload plan."""
        from moe_infinity_tpu_torch.runtime.continuous import RequestSampling
        from moe_infinity_tpu_torch.runtime.sampling import normalize_logit_bias

        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu().numpy()
        arr = np.atleast_2d(np.asarray(input_ids))
        cfg_eos = getattr(self.hf_config, "eos_token_id", None)
        if isinstance(cfg_eos, (list, tuple)) and not cfg_eos:
            cfg_eos = None
        kwargs.setdefault("eos_token_id", cfg_eos)
        # the seq2seq batchers are plain batched greedy: any knob they do not
        # take routes to the full generator
        if (self.s2s_batcher is not None and arr.shape[0] == 1
                and not kwargs.get("logprobs")
                and not kwargs.get("do_sample")
                and float(kwargs.get("temperature", 0.0) or 0.0) == 0.0
                and not kwargs.get("logit_bias")
                and not kwargs.get("collect_trace")
                and float(kwargs.get("repetition_penalty", 1.0)) == 1.0
                and not kwargs.get("presence_penalty")
                and not kwargs.get("frequency_penalty")
                and kwargs.get("attention_mask") is None
                and kwargs.get("decoder_start_token_id") is None
                and arr.shape[1] <= self.config.max_seq_len
                # the continuous batcher's decode cache is max_seq_len columns
                and kwargs.get("max_new_tokens", 32) + 1 <= self.config.max_seq_len):
            out = self.s2s_batcher.generate(
                arr[0], max_new_tokens=kwargs.get("max_new_tokens", 32),
                eos_token_id=kwargs.get("eos_token_id"))
            return out[None]
        if (self.batcher is not None and arr.shape[0] == 1
                and not kwargs.get("logprobs") and not kwargs.get("collect_trace")):
            do_sample = kwargs.get("do_sample")
            temp = kwargs.get("temperature", 1.0 if do_sample else 0.0)
            if do_sample is False or (do_sample is None and temp == 0.0):
                temp = 0.0
            out = self.batcher.generate(
                arr[0],
                max_new_tokens=kwargs.get("max_new_tokens", 32),
                eos_token_id=kwargs.get("eos_token_id"),
                sampling=RequestSampling(
                    temperature=float(temp),
                    logit_bias=normalize_logit_bias(kwargs.get("logit_bias")),
                    top_k=int(kwargs.get("top_k", 0) or 0),
                    top_p=float(kwargs.get("top_p", 1.0)),
                    min_p=float(kwargs.get("min_p", 0.0)),
                    repetition_penalty=float(kwargs.get("repetition_penalty", 1.0)),
                    presence_penalty=float(kwargs.get("presence_penalty", 0.0)),
                    frequency_penalty=float(kwargs.get("frequency_penalty", 0.0)),
                    seed=int(kwargs.get("seed", 0)),
                ),
            )
            return out[None]
        kw = dict(kwargs)
        # HF semantics: do_sample=True defaults the temperature to 1.0;
        # without it, greedy (an explicit temperature still wins)
        kw.setdefault("temperature", 1.0 if kw.get("do_sample") else 0.0)
        kw.pop("max_length", None)
        kw.setdefault("max_new_tokens", 32)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        # a direct engine run must not protect arena keys, nor replay the
        # engine's graphs, while another run holds its own
        lock = (self.engine.arena.client_lock if self.engine is not None
                else contextlib.nullcontext())
        # prompt-lookup speculation: greedy batch-1 decoder-only requests
        if (self.config.speculative_tokens > 0 and arr.shape[0] == 1
                and kw["temperature"] == 0.0 and not kw.get("logprobs")
                and not kw.get("logit_bias") and hasattr(self.generator, "stepper")):
            from moe_infinity_tpu_torch.runtime.speculative import SpeculativeDecoder

            if self._spec is None:
                self._spec = SpeculativeDecoder(
                    self.generator.stepper, spec_tokens=self.config.speculative_tokens,
                    max_seq_len=self.config.max_seq_len)
            with lock:
                result = self._spec.generate(arr, kw["max_new_tokens"],
                                             eos_token_id=kw.get("eos_token_id"),
                                             pad_token_id=kw.get("pad_token_id", 0))
        else:
            with lock:
                result = self.generator.generate(arr, **kw)
        self.last_result = result
        return result.sequences

    # ---- observability ---------------------------------------------------
    def hit_rate(self) -> float:
        return self.engine.hit_rate() if self.engine else 1.0

    def stats(self) -> dict:
        out = self.engine.stats() if self.engine else {}
        # batched offload serving: the batcher drives the arena, so its
        # speculative counters are the live ones
        if self.batcher is not None and self.batcher.arena is not None:
            out.update(self.batcher.stats())
        if self.s2s_batcher is not None and getattr(self.s2s_batcher, "engine", None):
            out.update(self.s2s_batcher.stats())
        return out

    def save_trace(self, path: Optional[str] = None) -> None:
        """Persist the EAMC trace collection ('knowledge checkpoint')."""
        if self.engine and self.engine.tracer:
            self.engine.tracer.save_trace(path or self.config.trace_path)

    def shutdown(self) -> None:
        # the batchers first: their scheduler threads launch on the device and
        # may hold arena keys
        if self.batcher is not None:
            self.batcher.shutdown()
        if self.s2s_batcher is not None:
            self.s2s_batcher.shutdown()
        if self.dense_arena is not None:
            self.dense_arena.shutdown()  # idempotent
        if self.engine is not None:
            # a pod engine's arena is its executor's (every rank's own)
            getattr(self.engine, "executor", self.engine.arena).shutdown()
