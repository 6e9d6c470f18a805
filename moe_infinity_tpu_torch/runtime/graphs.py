"""CUDA graphs of the decode: the port's counterpart of the JAX engines'
jitted step and block (``jax.jit`` of ``Seq2SeqGenerator._step``, of the
speculative whole step and of the ``lax.scan`` of a k-step block), for the
seq2seq paths (NLLB, Switch) and the decoder-only ``OffloadEngine``
(Mixtral).

A ``StepGraph`` is one function captured once and replayed: static input
buffers (the token, the step as a 0-d int32, the arena's slot rows), the
graph with its static outputs, and the kernel launches counted while it
was captured. ``replay`` copies the inputs into the buffers on the current
stream, replays there, and returns the static outputs, which the next
replay overwrites: a caller that keeps one across replays clones it.

A ``GraphCache`` keys each graph by the shapes and dtypes of its inputs and
of the tensors its function reads by address (weights, the arena's slots,
the K/V caches, the cross K/V, the encoder mask), and remembers those
tensors' ``data_ptr``s. A pointer that moved under a key means the graph
would replay over memory that may be freed: the cache captures anew
(counted in ``recaptures``) and never replays the old graph. A key without
a graph is captured; a capture that fails raises. Nothing here runs a step
eagerly in its place.

The capture backend is an argument. ``CudaGraphBackend`` runs the function
once on its own stream (the warm-up a capture needs: cuBLAS's handle for
that stream, the kernels' ``cudaFuncSetAttribute`` on their first launch,
and ``ops/_build.py``'s ticket counters and split scratch for that stream,
which a capture may not make; a later warm-up that outgrows them gets
larger ones, and the outgrown ones, whose addresses earlier graphs hold,
are kept for the life of the process, ``_build.grown``), then captures it
there into one memory pool
that all graphs of the backend share. Capture errors are
thread-local, so the arena's fetch workers keep copying meanwhile. Tests on
the CPU pass a stand-in with the same ``capture`` contract.
"""

from __future__ import annotations

import functools
import gc
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from moe_infinity_tpu_torch.models.layers import KVCache
from moe_infinity_tpu_torch.ops import add_launches, launch_counts
from moe_infinity_tpu_torch.ops.moe import capturable


class CudaGraphBackend:
    """Captures on its own stream into one shared memory pool."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()

    def capture(self, fn: Callable[[], tuple], generators: Sequence[torch.Generator] = ()):
        """(replay, static outputs, launches per replay) of ``fn``, after one
        warm-up run of it on the capture stream, ordered after the current
        stream's queued work and before its next. ``generators``: the CUDA
        generators ``fn`` draws from, registered with the graph so that each
        replay draws at the generator's offset then and moves it on by what
        the captured draws take (a captured draw of an unregistered one
        raises)."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            fn()
        cur.wait_stream(self.stream)
        before = launch_counts()
        # capture_begin/end rather than ``torch.cuda.graph``, whose entry
        # synchronizes the device and empties the allocators' caches: the
        # encoder's next blocks and the fetch path's staging buffers would
        # then be allocated anew
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        # no cyclic garbage collection inside the capture: a collection there
        # that frees another graph destroys its executable in the middle of
        # the capture, which invalidates it (on the card, a CUDA error 901 at
        # the next launch)
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    out = fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is already invalid; the first error is the one
                    raise
                graph.capture_end()
        finally:
            if gc_was_on:
                gc.enable()
        after = launch_counts()
        launches = {k: n - before[k] for k, n in after.items() if n != before[k]}
        add_launches({k: -n for k, n in launches.items()})  # the capture ran nothing
        return graph.replay, out, launches


class StepGraph:
    """One captured function with its static inputs and outputs."""

    def __init__(self, backend, fn: Callable[..., tuple], inputs: Dict[str, object],
                 device, ptrs: Tuple[int, ...], generators: Sequence[torch.Generator] = ()):
        self.ptrs = ptrs
        self.inputs = {
            name: (torch.empty_like(v) if isinstance(v, torch.Tensor)
                   else torch.zeros((), dtype=torch.int32, device=device))
            for name, v in inputs.items()
        }
        self._load(inputs)
        kw = {"generators": generators} if generators else {}
        self._replay, self.outputs, self.launches = backend.capture(
            functools.partial(fn, **self.inputs), **kw)

    def _load(self, inputs):
        for name, v in inputs.items():
            buf = self.inputs[name]
            if isinstance(v, torch.Tensor):
                buf.copy_(v)
            else:
                buf.fill_(int(v))

    def replay(self, **inputs) -> tuple:
        self._load(inputs)
        self._replay()
        add_launches(self.launches)
        return self.outputs


def _sig(t) -> tuple:
    return (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else ("int",)


class GraphCache:
    """The graphs of one owner (an engine or a generator), by shape."""

    def __init__(self, backend, device):
        self.backend = backend
        self.device = torch.device(device)
        self._graphs: Dict[tuple, StepGraph] = {}
        # captures of new keys, captures after a pointer moved, replays,
        # seconds spent capturing (warm-ups included), and the decoder
        # steps the warm-ups ran on the device
        self.captures = self.recaptures = self.replays = self.warmup_steps = 0
        self.capture_s = 0.0

    def run(self, name: str, fn: Callable[..., tuple], inputs: Dict[str, object],
            closes_over: Sequence[torch.Tensor], steps: int = 1) -> tuple:
        """Replay the graph of ``name`` at these shapes with ``inputs``
        (tensors or ints), capturing ``fn(**buffers)`` first if there is
        none. ``closes_over``: every tensor ``fn`` reads by address.
        ``steps``: decoder steps one run of ``fn`` executes."""
        return self.replay(self.get(name, fn, inputs, closes_over, steps), inputs)

    def get(self, name: str, fn: Callable[..., tuple], inputs: Dict[str, object],
            closes_over: Sequence[torch.Tensor], steps: int = 1,
            generators: Sequence[torch.Generator] = ()) -> StepGraph:
        """The graph of ``name`` at these shapes, captured if there is none
        (its warm-up runs ``fn`` once on copies of ``inputs``); not replayed.
        ``generators``: the CUDA generators ``fn`` draws from."""
        key = (name, tuple((n, _sig(v)) for n, v in inputs.items()),
               tuple(_sig(t) for t in closes_over))
        ptrs = tuple(t.data_ptr() for t in closes_over)
        g = self._graphs.get(key)
        if g is None or g.ptrs != ptrs:
            if g is None:
                self.captures += 1
            else:
                self.recaptures += 1
            t0 = time.perf_counter()
            # the old graph goes only after the new one is captured: on the
            # card a capture into a pool with no live graph left failed (an
            # internal assertion of PyTorch's caching allocator)
            g = self._graphs[key] = StepGraph(self.backend, fn, inputs, self.device, ptrs,
                                              generators)
            self.capture_s += time.perf_counter() - t0
            self.warmup_steps += steps
        return g

    def replay(self, g: StepGraph, inputs: Dict[str, object]) -> tuple:
        """One replay of ``g`` (from ``get``) with ``inputs``."""
        self.replays += 1
        return g.replay(**inputs)

    def stats(self) -> dict:
        return {"graphs": len(self._graphs), "captures": self.captures,
                "recaptures": self.recaptures, "replays": self.replays,
                "capture_s": round(self.capture_s, 3), "warmup_steps": self.warmup_steps}


def graph_cache(graphs: bool, graph_backend, device, impl: str) -> Optional[GraphCache]:
    """The ``GraphCache`` of a decode step whose grouped FFN runs ``impl``,
    or None when the step runs eagerly: ``graphs`` off, or a CPU device and
    no backend given. A capture on the card (``CudaGraphBackend``, the
    default there) refuses an impl that cannot run inside a graph
    (``ops.moe.capturable``) with a ``ValueError``; a stand-in backend runs
    the step eagerly and takes any impl."""
    device = torch.device(device)
    if not graphs or (graph_backend is None and device.type != "cuda"):
        return None
    on_card = graph_backend is None or isinstance(graph_backend, CudaGraphBackend)
    if on_card and not capturable(impl):
        raise ValueError(
            f"moe impl {impl!r} reads its group sizes on the host and cannot run inside a "
            "CUDA graph: pass graphs=False or another impl (e.g. 'pallas')")
    return GraphCache(graph_backend or CudaGraphBackend(device), device)


def flat_tensors(tree) -> list:
    """Every tensor of a nested dict/list/tuple, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, KVCache):
        return [tree.k, tree.v]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in flat_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in flat_tensors(v)]
    return []


class DecodeBuffers:
    """The decoder state a graph reads by address, owned by its engine or
    generator so that one graph per shape serves every request: the K/V
    caches per (B, capacity), the encoder mask and the cross K/V per
    (B, S_enc). Each request's mask and cross K/V are copied in; the caches
    need no reset, since a step writes its column before it reads it and the
    causal bound keeps it off the columns after its own."""

    def __init__(self, model):
        self.model = model
        self._kvs: Dict[tuple, list] = {}
        self._enc: Dict[tuple, tuple] = {}

    def caches(self, B: int, cap: int) -> list:
        """The K/V caches of (B, cap), made at the first request of the shape."""
        kvs = self._kvs.get((B, cap))
        if kvs is None:
            kvs = self._kvs[(B, cap)] = self.model.init_cache(B, cap)
        return kvs

    def take(self, B: int, cap: int, mask, cross):
        """(kvs, mask, cross) for one request, the last two its own copied
        into the owner's buffers."""
        kvs = self.caches(B, cap)
        key = (B, mask.shape[1])
        enc = self._enc.get(key)
        if enc is None:
            enc = self._enc[key] = (torch.empty_like(mask),
                                    [(torch.empty_like(k), torch.empty_like(v)) for k, v in cross])
        enc[0].copy_(mask)
        for (k, v), (k_new, v_new) in zip(enc[1], cross):
            k.copy_(k_new)
            v.copy_(v_new)
        return kvs, enc[0], enc[1]


def step_positions(step, B: int, device) -> torch.Tensor:
    """[B, 1] int32 positions of a one-token step at ``step`` (an int, or a
    0-d tensor on the device, which a graph reads at replay)."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.int32).reshape(1, 1).expand(B, 1)
    return torch.full((B, 1), step, dtype=torch.int32, device=device)
