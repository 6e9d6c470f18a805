"""The port's native store reader (``moe_infinity_tpu_torch/store/native.py``
over its own ``csrc/aio_reader.cc``) and ``ExpertStore``'s load modes,
mirroring tests/test_native_store.py:

* ``aligned_empty``; direct and batch reads equal to the memory map, and to
  the JAX package's reader on the same files;
* ``ExpertStore`` byte-equal across ``mmap``, ``ram``, ``direct`` and
  ``sched`` (records, tensors, experts), and equal to the JAX store in each
  mode; ``is_direct`` reports which open took effect;
* the slot arena over a ``direct`` and a ``sched`` store: slots byte-equal
  to the records, counters equal to the arena over ``mmap``;
* no fallback: a failed build or a failed open raises, and never reads
  through the memory map instead.

Every comparison is exact.
"""

import concurrent.futures as cf
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu.store.blob import ExpertStoreWriter as JWriter
from moe_infinity_tpu_torch.ops import _build
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.store import native
from moe_infinity_tpu_torch.store.blob import ExpertStore, ExpertStoreWriter
from moe_infinity_tpu_torch.store.native import NativeBlobReader, NativeFetchScheduler, aligned_empty
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import write_nllb_store

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None, reason="no C++ toolchain")

MODES = ("mmap", "ram", "direct", "sched")


@pytest.fixture(scope="module")
def small_store(tmp_path_factory):
    """tests/test_native_store.py's store, written by the port's writer."""
    path = str(tmp_path_factory.mktemp("native") / "store")
    rng = np.random.default_rng(3)
    fields = [("a.weight", (64, 32), "float32"), ("b.weight", (32,), "float32")]
    w = ExpertStoreWriter(path, num_layers=2, num_experts=3, fields=fields)
    data = {}
    for layer in range(2):
        for e in range(3):
            a = rng.standard_normal((64, 32)).astype(np.float32)
            b = rng.standard_normal(32).astype(np.float32)
            w.write_tensor(layer, e, "a.weight", a)
            w.write_tensor(layer, e, "b.weight", b)
            data[(layer, e)] = (a, b)
    w.finalize()
    return path, data


@pytest.fixture(scope="module")
def mixed_store(tmp_path_factory):
    """Fields of every store dtype (bf16 bits, int8, packed int4, fp8
    codes, f32 scales), written by the JAX writer."""
    import ml_dtypes

    path = str(tmp_path_factory.mktemp("native_mixed") / "store")
    rng = np.random.default_rng(5)
    fields = [("w.bf16", (8, 16), "bfloat16"), ("w.i8", (16, 8), "int8"),
              ("w.i4", (16, 4), "int4"), ("w.f8", (8, 8), "float8_e4m3fn"),
              ("w.scale", (16,), "float32")]
    w = JWriter(path, 3, 4, fields, meta={"arch": "mixtral"})
    for layer in range(3):
        for e in range(4):
            w.write_tensor(layer, e, "w.bf16",
                           rng.standard_normal((8, 16)).astype(ml_dtypes.bfloat16))
            w.write_tensor(layer, e, "w.i8", rng.integers(-127, 127, (16, 8), dtype=np.int8))
            w.write_tensor(layer, e, "w.i4", rng.integers(-128, 127, (16, 4), dtype=np.int8))
            w.write_tensor(layer, e, "w.f8",
                           rng.standard_normal((8, 8)).astype(ml_dtypes.float8_e4m3fn))
            w.write_tensor(layer, e, "w.scale", rng.standard_normal(16).astype(np.float32))
    w.finalize()
    return path


def test_aligned_empty():
    buf = aligned_empty(10000)
    assert buf.ctypes.data % 4096 == 0
    assert buf.nbytes == 10000


def test_direct_reads_match_mmap(small_store):
    path, data = small_store
    st_mmap = ExpertStore(path, load_mode="mmap")
    st_direct = ExpertStore(path, load_mode="direct")
    for (layer, e), (a, b) in data.items():
        np.testing.assert_array_equal(st_direct.get_tensor(layer, e, "a.weight"), a)
        np.testing.assert_array_equal(st_direct.get_tensor(layer, e, "b.weight"), b)
        rec_d = st_direct.get_record(layer, e)
        assert rec_d.ctypes.data % 4096 == 0
        np.testing.assert_array_equal(st_mmap.get_record(layer, e), rec_d)
    np.testing.assert_array_equal(st_direct.get_expert(1, 2)["a.weight"], data[(1, 2)][0])


def test_batch_read_equals_mmap_and_jax_reader(small_store):
    from moe_infinity_tpu.store.native import NativeBlobReader as JReader

    path, _ = small_store
    st = ExpertStore(path, load_mode="mmap")
    keys = [(0, 0), (1, 1), (0, 2), (1, 0)]
    reqs = [(st._record_base(*k), st.stride) for k in keys]
    reader = NativeBlobReader(os.path.join(path, "experts.blob"))
    jreader = JReader(os.path.join(path, "experts.blob"))
    try:
        outs, jouts = reader.read_batch(reqs), jreader.read_batch(reqs)
        for k, out, jout in zip(keys, outs, jouts):
            np.testing.assert_array_equal(out, np.asarray(st.get_record(*k)))
            assert out.tobytes() == jout.tobytes()
        assert reader.is_direct == jreader.is_direct
        assert ExpertStore(path, load_mode="direct").is_direct == reader.is_direct
    finally:
        reader.close()
        jreader.close()


@pytest.mark.parametrize("mode", MODES)
def test_modes_byte_equal(mixed_store, mode):
    """Every mode reads the bytes the memory map reads, and the JAX store
    in the same mode reads the same."""
    ref = ExpertStore(mixed_store, load_mode="mmap")
    st = ExpertStore(mixed_store, load_mode=mode)
    jst = JStore(mixed_store, load_mode=mode)
    assert st.load_mode == mode
    if mode in ("mmap", "ram"):
        assert not st.is_direct
    for layer in range(3):
        for e in range(4):
            rec = st.get_record(layer, e, prio=layer % 2, gen=0)
            assert rec.tobytes() == ref.get_record(layer, e).tobytes()
            assert rec.tobytes() == np.asarray(jst.get_record(layer, e)).tobytes()
            got = st.get_expert(layer, e, prio=1, gen=0)
            want = ref.get_expert(layer, e)
            assert list(got) == list(want)
            for name in want:
                assert got[name].dtype == want[name].dtype, name
                assert got[name].tobytes() == want[name].tobytes(), name
                t = st.get_tensor(layer, e, name)
                assert t.shape == want[name].shape and t.tobytes() == want[name].tobytes()
                assert t.tobytes() == np.asarray(jst.get_tensor(layer, e, name)).tobytes()
    st.escalate(0, 0)  # nothing in flight: does nothing, in every mode


def test_concurrent_reads_in_every_mode(mixed_store):
    ref = ExpertStore(mixed_store)
    keys = [(layer, e) for layer in range(3) for e in range(4)] * 4
    for mode in MODES:
        st = ExpertStore(mixed_store, load_mode=mode)
        with cf.ThreadPoolExecutor(4) as ex:
            recs = list(ex.map(lambda k: bytes(st.get_record(*k, prio=1)), keys[:12])) + \
                list(ex.map(lambda k: bytes(st.get_record(*k)), keys[12:24]))
        for k, r in zip(keys, recs):
            assert r == ref.get_record(*k).tobytes(), (mode, k)


@pytest.fixture(scope="module")
def nllb_stores(tmp_path_factory):
    spec = dict(vocab_size=96, d_model=32, num_heads=4, encoder_layers=4, decoder_layers=4,
                encoder_ffn_dim=64, decoder_ffn_dim=64, encoder_sparse_step=2,
                decoder_sparse_step=2, num_experts=8, pad_token_id=1,
                decoder_start_token_id=2, max_positions=64, scale_embedding=True)
    _, jtree = JNllbModel(JNllbSpec(**spec), compute_dtype=jnp.float32).init_random(
        jax.random.PRNGKey(9))
    root = tmp_path_factory.mktemp("native_arena")
    return {q: write_nllb_store(root / q, jtree["layers"], q, 2, seed=2)
            for q in ("float32", "int4")}


ROLE_TAILS = {"gate": "fc1.weight", "gate4": "fc1.weight", "gate_scale": "fc1.weight.scale",
              "gate_bias": "fc1.bias", "down": "fc2.weight", "down4": "fc2.weight",
              "down_scale": "fc2.weight.scale", "down_bias": "fc2.bias"}


@pytest.mark.parametrize("quant", ["float32", "int4"])
@pytest.mark.parametrize("mode", ["direct", "sched"])
def test_arena_over_native_store(nllb_stores, quant, mode):
    """The fetch path on the native reader: every slot byte-equal to its
    record, and the counters equal to the same acquires over the memory map
    (one worker, no prefetch)."""
    path = nllb_stores[quant]
    seq = [[(0, 1), (0, 2)], [(1, 3)], [(0, 1), (2, 5)], [(3, 0), (3, 7), (1, 3)],
           [(2, 6)], [(0, 2), (3, 7)]]
    stats = {}
    for m in ("mmap", mode):
        store = ExpertStore(path, load_mode=m)
        arena = ExpertArena(store, 4, device="cpu", compute_dtype=torch.float32, num_threads=1)
        try:
            for layer, keys in enumerate(seq):
                arena.acquire(keys, layer=layer % 4)
                ref = ExpertStore(path)
                for key in keys:
                    slot = arena.key_to_slot[key]
                    rec = ref.get_expert(*key)
                    for akey, t in arena.pytree().items():
                        np.testing.assert_array_equal(t[slot].numpy(), rec[ROLE_TAILS[akey]],
                                                      err_msg=f"{m}/{key}/{akey}")
                arena.release(keys)
            stats[m] = (arena.hit_stats(), arena.fetch_stats()["fetches_store"])
        finally:
            arena.shutdown()
    assert stats[mode] == stats["mmap"]


# ---------------------------------------------------------------------------
# no fallback
# ---------------------------------------------------------------------------


@pytest.fixture
def failing_build(tmp_path, monkeypatch):
    """A build directory with no library in it and a compiler that fails."""
    fake = tmp_path / "bad-cxx"
    fake.write_text("#!/bin/sh\necho 'error: no compiler here' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "_lib", None)
    return fake


def test_failed_build_raises_and_never_reads_the_memory_map(small_store, failing_build,
                                                            monkeypatch):
    path, _ = small_store
    reads = []
    monkeypatch.setattr(ExpertStore, "_fields_from",
                        lambda self, rec: reads.append(rec) or {})
    for mode in ("direct", "sched"):
        with pytest.raises(RuntimeError, match="(?s)bad-cxx failed for mtstore.*no compiler here"):
            ExpertStore(path, load_mode=mode)
    with pytest.raises(RuntimeError, match="failed for mtstore"):
        NativeBlobReader(os.path.join(path, "experts.blob"))
    with pytest.raises(RuntimeError, match="failed for mtstore"):
        NativeFetchScheduler(os.path.join(path, "experts.blob"))
    assert not reads and native._lib is None
    assert not list((_build.BUILD_DIR).glob("mtstore-*.so"))


def test_failed_open_raises(tmp_path, small_store):
    missing = str(tmp_path / "nothing.blob")
    with pytest.raises(OSError, match="mtstore_open failed"):
        NativeBlobReader(missing)
    with pytest.raises(OSError, match="mtsched_create failed"):
        NativeFetchScheduler(missing)
    path, _ = small_store
    st = ExpertStore(path, load_mode="direct")
    with pytest.raises(OSError, match="mtstore_read failed"):  # a read past the blob's end
        st._native.read(st.blob_nbytes, st.stride)
    with pytest.raises(ValueError, match="unknown load_mode"):
        ExpertStore(path, load_mode="tape")


def test_library_is_the_ports_own(small_store):
    path, _ = small_store
    ExpertStore(path, load_mode="direct")
    lib = native._load_lib()
    built = list(_build.BUILD_DIR.glob("mtstore-*.so"))
    assert built and any(os.path.samefile(lib._name, p) for p in built)
    assert "moe_infinity_tpu_torch" in os.path.realpath(lib._name)
