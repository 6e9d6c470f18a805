"""ctypes binding of the port's native store, from
``moe_infinity_tpu/store/native.py``: ``csrc/aio_reader.cc`` (O_DIRECT
positioned reads of expert records, so cold reads bypass the page cache, and
a thread-pooled batch read) and ``csrc/sched.cc`` (the priority scheduler of
record reads).

The library is the port's own: ``ops/_build.py::build_host`` compiles both
sources with the host's C++ compiler into the git-ignored ``_build/`` at
first use (never at import). There is no fallback: a build or a load that
fails raises with the compiler's output, and a blob that cannot be opened
raises, so a store asked for ``direct`` or ``sched`` never reads through the
memory map instead. A file system that refuses O_DIRECT is opened buffered,
as the JAX package's C++ does; ``is_direct`` says which open took effect.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

ALIGN = 4096
_SOURCES = ["aio_reader.cc", "sched.cc"]
_lib = None
_lib_lock = threading.Lock()


def _load_lib() -> ctypes.CDLL:
    """The native store library, built on first use; raises if the build or
    the load fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from moe_infinity_tpu_torch.ops._build import build_host

        lib = ctypes.CDLL(str(build_host("mtstore", _SOURCES)))
        lib.mtstore_open.restype = ctypes.c_void_p
        lib.mtstore_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.mtstore_read.restype = ctypes.c_int
        lib.mtstore_read.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
        ]
        lib.mtstore_read_batch.restype = ctypes.c_int
        lib.mtstore_read_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.mtstore_close.argtypes = [ctypes.c_void_p]
        lib.mtstore_is_direct.restype = ctypes.c_int
        lib.mtstore_is_direct.argtypes = [ctypes.c_void_p]
        lib.mtstore_set_threads.argtypes = [ctypes.c_int]
        lib.mtsched_create.restype = ctypes.c_void_p
        lib.mtsched_create.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ]
        lib.mtsched_submit.restype = ctypes.c_int
        lib.mtsched_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
        ]
        lib.mtsched_set_gen.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.mtsched_escalate.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.mtsched_wait.restype = ctypes.c_int
        lib.mtsched_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.mtsched_poll.restype = ctypes.c_int
        lib.mtsched_poll.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.mtsched_pending.restype = ctypes.c_int
        lib.mtsched_pending.argtypes = [ctypes.c_void_p]
        lib.mtsched_is_direct.restype = ctypes.c_int
        lib.mtsched_is_direct.argtypes = [ctypes.c_void_p]
        lib.mtsched_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def aligned_empty(nbytes: int) -> np.ndarray:
    """uint8 buffer whose data pointer is 4096-aligned (an O_DIRECT target)."""
    raw = np.empty(nbytes + ALIGN, dtype=np.uint8)
    off = (-raw.ctypes.data) % ALIGN
    return raw[off: off + nbytes]


class NativeBlobReader:
    """O_DIRECT reader over one blob file with fixed-stride records."""

    def __init__(self, blob_path: str, *, direct: bool = True, threads: int = 4):
        lib = _load_lib()
        self._lib = lib
        lib.mtstore_set_threads(threads)
        self._h = lib.mtstore_open(blob_path.encode(), 1 if direct else 0)
        if not self._h:
            raise OSError(f"mtstore_open failed for {blob_path}")
        self.is_direct = bool(lib.mtstore_is_direct(self._h))

    def read(self, offset: int, size: int, out: Optional[np.ndarray] = None) -> np.ndarray:
        if out is None:
            out = aligned_empty(size)
        rc = self._lib.mtstore_read(self._h, offset, size, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise OSError(f"mtstore_read failed at {offset}+{size}")
        return out

    def read_batch(self, requests: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        """[(offset, size), ...] -> list of buffers, read in parallel."""
        n = len(requests)
        outs = [aligned_empty(sz) for _, sz in requests]
        offs = (ctypes.c_uint64 * n)(*[o for o, _ in requests])
        szs = (ctypes.c_uint64 * n)(*[s for _, s in requests])
        ptrs = (ctypes.c_void_p * n)(*[o.ctypes.data_as(ctypes.c_void_p).value for o in outs])
        if self._lib.mtstore_read_batch(self._h, n, offs, szs, ptrs) != 0:
            raise OSError("mtstore_read_batch failed")
        return outs

    def close(self) -> None:
        if self._h:
            self._lib.mtstore_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class NativeFetchScheduler:
    """Block-granular priority-preemptive reads over one blob (csrc/sched.cc).

    The C++ side owns the service order: priority-0 (on-demand) requests
    drain whole while priority >= 1 prefetches read one ``block_bytes`` chunk
    per pass and yield when higher-priority work arrives. Waiters block in C
    with the GIL released.

    Keys are (layer, expert); one outstanding request per key (the arena's
    ``_fetching`` set guarantees this upstream).
    """

    def __init__(self, blob_path: str, *, block_bytes: int = 1 << 20, threads: int = 2,
                 direct: bool = True):
        lib = _load_lib()
        self._lib = lib
        self._h = lib.mtsched_create(blob_path.encode(), block_bytes, threads,
                                     1 if direct else 0)
        if not self._h:
            raise OSError(f"mtsched_create failed for {blob_path}")
        self.is_direct = bool(lib.mtsched_is_direct(self._h))
        self._bufs = {}  # key -> buffer kept alive while in flight

    @staticmethod
    def _key(layer: int, expert: int) -> int:
        return layer * 1_000_000 + expert

    def submit(self, layer: int, expert: int, offset: int, size: int, *, prio: int = 0,
               gen: int = 0) -> np.ndarray:
        """Enqueue a record read; returns the destination buffer (filled
        once ``wait`` returns)."""
        buf = aligned_empty(size)
        k = self._key(layer, expert)
        rc = self._lib.mtsched_submit(self._h, k, offset, size,
                                      buf.ctypes.data_as(ctypes.c_void_p), prio, gen)
        if rc != 0:
            raise RuntimeError(f"duplicate in-flight fetch (L{layer},E{expert})")
        self._bufs[k] = buf
        return buf

    def wait(self, layer: int, expert: int, timeout_ms: int = -1) -> np.ndarray:
        """The filled buffer of a submitted read. A cancelled prefetch is
        revived at on-demand priority (a waiter needs the bytes)."""
        k = self._key(layer, expert)
        st = self._lib.mtsched_wait(self._h, k, timeout_ms)
        buf = self._bufs.pop(k, None)
        if st == 1:
            return buf
        if st == -3:
            self._bufs[k] = buf  # still in flight; the caller may wait again
            raise TimeoutError(f"fetch (L{layer},E{expert}) timed out")
        raise OSError(f"fetch (L{layer},E{expert}) failed (status {st})")

    def escalate(self, layer: int, expert: int) -> None:
        """Boost a queued or in-service read to on-demand priority."""
        self._lib.mtsched_escalate(self._h, self._key(layer, expert))

    def set_gen(self, gen: int) -> None:
        """Cancel queued prefetches from generations before ``gen``."""
        self._lib.mtsched_set_gen(self._h, gen)

    def pending(self) -> int:
        return self._lib.mtsched_pending(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.mtsched_destroy(self._h)
            self._h = None
        self._bufs.clear()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
