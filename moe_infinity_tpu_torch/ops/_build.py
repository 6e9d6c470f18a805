"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``_build/<name>-<hash>.so``, the hash covering the
sources, headers and flags), loaded with ``ctypes``. All stale libraries
build in parallel at first use, one ``nvcc`` per source. Host C++ (the
native store's ``csrc/aio_reader.cc`` and ``sched.cc``) compiles with
``g++`` (or ``c++``) into the same ``_build/`` directory, under a hash of
its sources and flags (``build_host``). Nothing here runs at import time: a
machine without ``nvcc`` can import every module of the port and run its
plain PyTorch versions.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}
_tickets: Dict[tuple, torch.Tensor] = {}  # (device, stream) -> zeroed counters
_workspaces: Dict[tuple, torch.Tensor] = {}  # (device, stream) -> f32 scratch
_retired: List[torch.Tensor] = []  # outgrown buffers, kept: a graph may hold their address
BUILD_SECONDS: Dict[str, float] = {}  # each nvcc of the last build_all, from its start


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale ``csrc/*.cu``, all ``nvcc`` processes at once.
    Returns {source stem: library path}. Raises with nvcc's output if any
    build fails. ptxas's register/spill report lands in ``<lib>.log``."""
    BUILD_DIR.mkdir(exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    stale = {k: v for k, v in targets.items() if not v[1].exists()}
    if stale:
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for stem, (src, out) in stale.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            with open(out.with_suffix(".log"), "w") as log:
                procs[stem] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                               tmp, out)
        BUILD_SECONDS.clear()
        while len(BUILD_SECONDS) < len(procs):
            for stem, (proc, _, _) in procs.items():
                if stem not in BUILD_SECONDS and proc.poll() is not None:
                    BUILD_SECONDS[stem] = round(time.perf_counter() - t0, 1)
            time.sleep(0.05)
        errors = []
        for stem, (proc, tmp, out) in procs.items():
            if proc.returncode != 0:
                log = out.with_suffix(".log").read_text()
                errors.append(f"nvcc failed for {stem}.cu:\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)  # atomic: a reader never sees half a file
        if errors:
            raise RuntimeError("\n".join(errors))
    return {stem: out for stem, (_, out) in targets.items()}


CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]


def cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++``."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) found: the native store cannot be built")


def build_host(name: str, sources: List[str]) -> Path:
    """Compile the host C++ files ``csrc/<sources>`` into one shared library,
    ``_build/<name>-<hash>.so`` (the hash covering the sources, the compiler
    and its flags), unless it exists. Returns its path; raises with the
    compiler's output if the build fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    compiler = cxx()
    h.update(compiler.encode())
    for src in sources:
        h.update((CSRC / src).read_bytes())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler, *CXX_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in sources)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{os.path.basename(compiler)} failed for {name} "
                           f"({' '.join(sources)}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a reader never sees half a file
    return out


def function(stem: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``name`` of ``csrc/<stem>.cu`` (built on demand), typed
    with ``argtypes``; every entry point returns cudaGetLastError()."""
    fn = _fns.get((stem, name))
    if fn is None:
        with _lock:
            lib = _libs.get(stem)
            if lib is None:
                lib = ctypes.CDLL(str(build_all()[stem]))
                _libs[stem] = lib
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(stem, name)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a refused launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(fn, dev: torch.device, *args) -> int:
    """Call the C entry point ``fn(*args, stream)`` under a device guard for
    ``dev``, on that device's current stream: the kernel launches on the
    device its tensors live on whatever device is current, and its
    once-per-device set-up (the dynamic shared-memory limit) is made for
    that device. (A CPU ``dev`` takes no guard: the tests that stand in for
    the kernel call the wrappers with CPU tensors.)"""
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        return fn(*args, stream_ptr(dev))


def _stream_buffer(cache, what, dev, n, make) -> torch.Tensor:
    """The buffer of ``cache`` for the current stream, grown to ``n``. Under
    a CUDA graph capture it must exist already: one made there would come
    from the graph's pool, so the capture's warm-up on the same stream makes
    it (``runtime/graphs.py``)."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    return grown(cache, key, n, make, torch.cuda.is_current_stream_capturing(), what)


def grown(cache, key, n, make, capturing: bool, what: str = "buffer") -> torch.Tensor:
    """``cache[key]`` with at least ``n`` elements, made with ``make(n)`` where
    it is missing or too small. A buffer that is outgrown is never freed: a
    CUDA graph captured before the growth holds its address in its kernel
    arguments and goes on replaying over it, so it moves to ``_retired`` for
    the life of the process. A new buffer is at least twice the size of the
    one it replaces, so the retired ones of a key add up to less than the
    live one. ``capturing``: a buffer may not be made (raises)."""
    buf = cache.get(key)
    if buf is not None and buf.numel() >= n:
        return buf
    if capturing:
        raise RuntimeError(
            f"{what} for {n} elements would be made inside a CUDA graph capture; "
            "run the captured function once on the capture stream first")
    if buf is not None:
        _retired.append(buf)
        n = max(n, 2 * buf.numel())
    buf = cache[key] = make(n)
    return buf


def tickets(dev, n: int) -> torch.Tensor:
    """``n`` int32 counters, zero between launches, for a kernel's merge of
    its splits: the last split of an output tile to finish draws the last
    ticket, merges, and sets the counter back to 0 (so they read 0 after
    every graph replay too). One buffer per device and stream, shared by the
    kernels, since launches on one stream run in order; it only grows, and
    an outgrown one is kept (``grown``)."""
    return _stream_buffer(_tickets, "ticket counters", dev, n, lambda n: torch.zeros(
        max(4096, n), dtype=torch.int32, device=dev))


def workspace(dev, n: int) -> torch.Tensor:
    """``n`` f32 of scratch for a kernel's split partials, kept per device and
    stream as ``tickets`` is; it only grows, so no call allocates one, and an
    outgrown one is kept (``grown``)."""
    return _stream_buffer(_workspaces, "split scratch", dev, n, lambda n: torch.empty(
        max(1 << 20, n), dtype=torch.float32, device=dev))


def same_device(*tensors) -> torch.device:
    """The one CUDA device all given tensors (None skipped) live on."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
    return dev


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def check_aligned(name: str, t: torch.Tensor, nbytes: int = 16) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name} must be {nbytes}-byte aligned")
