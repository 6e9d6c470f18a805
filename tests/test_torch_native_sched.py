"""The port's native priority fetch scheduler
(``moe_infinity_tpu_torch/store/native.py::NativeFetchScheduler`` over its
own ``csrc/sched.cc``), mirroring tests/test_native_sched.py and
tests/test_native_tsan.py:

* reads of the right bytes; an on-demand read preempts a prefetch in
  flight (block-granular); escalating a queued prefetch makes it finish
  first; ``set_gen`` cancels queued prefetches of older generations;
  ``wait`` revives a cancelled request; the same orders from the JAX
  package's scheduler on the same blob;
* ``ExpertStore(load_mode="sched")`` equal to ``mmap``;
* ``MoE`` with ``load_mode`` "sched" (offload plan) equal in tokens to
  ``mmap``, to the JAX facade in "sched" and to HF;
* the slot arena escalates a read in flight when a caller blocks on its key
  (a recording store shows the call, as it does for the JAX arena);
* a ThreadSanitizer stress of the port's ``sched.cc`` (six threads
  hammering submit, wait, escalate, set_gen and poll), skipped only where
  tests/test_native_tsan.py skips: without a C++ toolchain.

Every comparison is exact.
"""

import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from moe_infinity_tpu.store.native import NativeFetchScheduler as JSched
from moe_infinity_tpu_torch.store.native import NativeFetchScheduler
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import save_tiny_checkpoint, wait_for

CXX = shutil.which("g++") or shutil.which("c++")
pytestmark = pytest.mark.skipif(CXX is None, reason="no C++ toolchain")
CSRC = Path(__file__).resolve().parent.parent / "moe_infinity_tpu_torch" / "csrc"
BOTH = pytest.mark.parametrize("cls", [NativeFetchScheduler, JSched], ids=["port", "jax"])


@pytest.fixture
def blob(tmp_path):
    """A blob of 32 records x 1 MiB with recognizable contents."""
    n, rec = 32, 1 << 20
    path = tmp_path / "blob.bin"
    np.repeat(np.arange(n, dtype=np.uint8), rec).tofile(path)
    return str(path), n, rec


@BOTH
def test_sched_reads_correct_bytes(blob, cls):
    path, n, rec = blob
    s = cls(path, block_bytes=64 << 10, threads=2)
    try:
        for i in (0, 7, 31):
            s.submit(0, i, i * rec, rec, prio=1, gen=0)
        for i in (0, 7, 31):
            out = s.wait(0, i)
            assert out.shape == (rec,) and (out == i).all(), i
        assert s.pending() == 0
    finally:
        s.close()


def _finish_order(s, eids):
    done = []

    def waiter(eid):
        s.wait(0, eid)
        done.append(eid)

    ts = [threading.Thread(target=waiter, args=(e,)) for e in eids]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    return done


@BOTH
def test_on_demand_preempts_prefetch(blob, cls):
    """One service thread and a long prefetch in flight: an on-demand
    request submitted after it completes first (the prefetch yields at a
    block boundary)."""
    path, n, rec = blob
    s = cls(path, block_bytes=32 << 10, threads=1)
    try:
        s.submit(0, 100, 0, 24 * rec, prio=1, gen=0)
        s.submit(0, 200, 31 * rec, rec, prio=0, gen=0)  # on-demand
        assert _finish_order(s, (100, 200)) == [200, 100]
    finally:
        s.close()


@BOTH
def test_escalate_inflight_read(blob, cls):
    """Two queued prefetches on one thread; escalating the second makes it
    beat the first (which yields at its next block boundary)."""
    path, n, rec = blob
    s = cls(path, block_bytes=32 << 10, threads=1)
    try:
        s.submit(0, 1, 0, 16 * rec, prio=1, gen=0)
        s.submit(0, 2, 16 * rec, 8 * rec, prio=1, gen=0)
        s.escalate(0, 2)
        assert _finish_order(s, (1, 2)) == [2, 1]
    finally:
        s.close()


@BOTH
def test_set_gen_cancels_queued_prefetch(blob, cls):
    path, n, rec = blob
    s = cls(path, block_bytes=32 << 10, threads=1)
    try:
        s.submit(0, 1, 0, 16 * rec, prio=1, gen=1)  # occupies the thread
        s.submit(0, 2, 16 * rec, rec, prio=1, gen=1)  # queued
        s.set_gen(2)
        deadline = time.time() + 10
        st = 0
        while time.time() < deadline:
            st = s._lib.mtsched_poll(s._h, s._key(0, 2))
            if st == -2:
                break
            time.sleep(0.005)
        assert st == -2, st
        # the read in service still completes
        assert (s.wait(0, 1) == np.repeat(np.arange(16, dtype=np.uint8), rec)).all()
    finally:
        s.close()


@BOTH
def test_wait_revives_cancelled_request(blob, cls):
    """A waiter on a cancelled prefetch needs the bytes now: ``wait``
    revives it at on-demand priority instead of failing."""
    path, n, rec = blob
    s = cls(path, block_bytes=32 << 10, threads=1)
    try:
        s.submit(0, 5, 3 * rec, rec, prio=1, gen=1)
        s.set_gen(2)
        assert (s.wait(0, 5) == 3).all()
    finally:
        s.close()


def test_duplicate_submit_and_timeout(blob):
    path, n, rec = blob
    s = NativeFetchScheduler(path, block_bytes=32 << 10, threads=1)
    try:
        s.submit(0, 1, 0, 24 * rec, prio=1, gen=0)
        with pytest.raises(RuntimeError, match="duplicate in-flight fetch"):
            s.submit(0, 1, 0, rec, prio=0, gen=0)
        with pytest.raises(TimeoutError):
            s.wait(0, 1, timeout_ms=0)
        assert (s.wait(0, 1) == np.repeat(np.arange(24, dtype=np.uint8), rec)).all()
        with pytest.raises(OSError, match="status -4"):  # never submitted
            s.wait(0, 9)
    finally:
        s.close()


def test_store_sched_mode_matches_mmap(tmp_path):
    from moe_infinity_tpu_torch.store.blob import ExpertStore, ExpertStoreWriter
    from moe_infinity_tpu_torch.utils.dtypes import bf16_bits

    fields = [("w", (8, 16), "bfloat16"), ("w.scale", (16,), "float32")]
    w = ExpertStoreWriter(str(tmp_path), 2, 3, fields, meta={"arch": "mixtral"})
    rng = np.random.default_rng(0)
    for layer in range(2):
        for e in range(3):
            w.write_tensor(layer, e, "w", bf16_bits(rng.standard_normal((8, 16))))
            w.write_tensor(layer, e, "w.scale", rng.standard_normal(16).astype(np.float32))
    w.finalize()
    ref = ExpertStore(str(tmp_path), load_mode="mmap")
    sch = ExpertStore(str(tmp_path), load_mode="sched")
    for layer in range(2):
        for e in range(3):
            a, b = ref.get_expert(layer, e), sch.get_expert(layer, e, prio=1, gen=0)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    sch.escalate(0, 0)  # nothing in flight


def test_moe_offload_sched_mode_equals_mmap_jax_and_hf(tmp_path):
    """tests/test_native_sched.py's e2e case: the tiny Mixtral through the
    offload plan with the native scheduler under the arena."""
    from moe_infinity_tpu.entrypoints.api import MoE as JMoE
    from moe_infinity_tpu_torch.entrypoints.api import MoE

    path, hf = save_tiny_checkpoint("mixtral", tmp_path / "ckpt", seed=3)
    prompt = np.array([[5, 9, 33, 17]])
    cfg = {"expert_dtype": "float32", "max_seq_len": 64, "device_memory_bytes": 1,
           "num_slots": 5}
    outs = {}
    for mode in ("mmap", "sched"):
        m = MoE(path, dict(cfg, load_mode=mode, offload_path=str(tmp_path / f"p_{mode}")),
                device="cpu")
        try:
            assert m.engine is not None and m.engine.arena.store.load_mode == mode
            outs[mode] = m.generate(prompt, max_new_tokens=6)
        finally:
            m.shutdown()
    j = JMoE(path, dict(cfg, load_mode="sched", offload_path=str(tmp_path / "jax")))
    try:
        want = j.generate(prompt, max_new_tokens=6)
    finally:
        j.shutdown()
    hf_out = hf.generate(torch.tensor(prompt), max_new_tokens=6, do_sample=False,
                         pad_token_id=0).numpy()
    np.testing.assert_array_equal(outs["sched"], outs["mmap"])
    np.testing.assert_array_equal(outs["sched"], want)
    np.testing.assert_array_equal(outs["sched"], hf_out)


# ---------------------------------------------------------------------------
# the arena escalates a blocked in-flight read
# ---------------------------------------------------------------------------


class _RecordingStore:
    """An expert store whose read of ``gated`` blocks until ``release`` is
    set, recording every ``get_expert`` priority and every ``escalate``."""

    def __init__(self, store, gated):
        self._store, self.gated = store, gated
        self.release, self.started = threading.Event(), threading.Event()
        self.reads, self.escalations = [], []

    def __getattr__(self, name):
        return getattr(self._store, name)

    def get_expert(self, layer, expert, *, prio=0, gen=0):
        self.reads.append(((layer, expert), prio))
        if (layer, expert) == self.gated:
            self.started.set()
            assert self.release.wait(30)
        return self._store.get_expert(layer, expert, prio=prio, gen=gen)

    def escalate(self, layer, expert):
        self.escalations.append((layer, expert))


@pytest.fixture(scope="module")
def mixtral_store(tmp_path_factory):
    from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
    from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

    root = tmp_path_factory.mktemp("sched_arena")
    path, _ = save_tiny_checkpoint("mixtral", root / "ckpt", seed=4)
    ingest_checkpoint(path, str(root / "store"), read_hf_config(path), expert_dtype="float32")
    return str(root / "store")


def _arena_escalations(make_arena, store, key):
    """Prefetch ``key`` (its read blocks in the store), then acquire it from
    another thread; returns the store's record."""
    arena = make_arena(store)
    try:
        arena.prefetch([key])
        assert store.started.wait(30)  # a worker is reading it at prefetch priority
        t = threading.Thread(target=arena.acquire, args=([key], key[0]))
        t.start()
        wait_for(lambda: store.escalations, what="the arena's escalate call")
        store.release.set()
        t.join(30)
        assert not t.is_alive() and arena.is_resident(key)
        arena.release([key])
    finally:
        arena.shutdown()
    return store.reads, store.escalations


def test_arena_escalates_blocked_inflight_read(mixtral_store):
    from moe_infinity_tpu.runtime.arena import PRIO_ONDEMAND as J_ONDEMAND
    from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
    from moe_infinity_tpu.store.blob import ExpertStore as JStore
    from moe_infinity_tpu_torch.runtime.arena import PRIO_ONDEMAND, ExpertArena
    from moe_infinity_tpu_torch.store.blob import ExpertStore

    key = (1, 2)
    reads, esc = _arena_escalations(
        lambda st: ExpertArena(st, 4, device="cpu", compute_dtype=torch.float32, num_threads=1),
        _RecordingStore(ExpertStore(mixtral_store, load_mode="sched"), key), key)
    jreads, jesc = _arena_escalations(
        lambda st: JArena(st, 4, num_threads=1),
        _RecordingStore(JStore(mixtral_store, load_mode="sched"), key), key)
    assert esc == jesc == [key]
    assert reads == jreads and reads[0][0] == key and reads[0][1] != PRIO_ONDEMAND
    assert PRIO_ONDEMAND == J_ONDEMAND


# ---------------------------------------------------------------------------
# ThreadSanitizer
# ---------------------------------------------------------------------------


def test_sched_tsan_stress(tmp_path):
    exe = tmp_path / "sched_stress_tsan"
    build = subprocess.run(
        [CXX, "-O1", "-g", "-std=c++17", "-fsanitize=thread", "-pthread", "-o", str(exe),
         str(CSRC / "sched.cc"), str(CSRC / "sched_stress.cc")],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stdout + build.stderr
    proc = subprocess.run([str(exe), str(tmp_path)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "STRESS_OK" in proc.stdout
    assert "WARNING: ThreadSanitizer" not in proc.stdout + proc.stderr
