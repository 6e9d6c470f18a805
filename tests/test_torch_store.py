"""The port's expert store (``store/blob.py``, ``store/quant.py``,
``utils/dtypes.py``) against the JAX package's. Stores are written from the
JAX NllbModel.init_random weights with the JAX ExpertStoreWriter and opened
by both packages; every comparison is byte for byte."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu.store import blob as jblob
from moe_infinity_tpu.store import quant as jquant
from moe_infinity_tpu_torch.ops.moe import pack_int4, unpack_int4
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store import blob, quant
from moe_infinity_tpu_torch.utils import dtypes

from torch_port_helpers import write_nllb_store, one_intra_op_thread

SPEC = dict(
    vocab_size=96, d_model=32, num_heads=4, encoder_layers=4, decoder_layers=4,
    encoder_ffn_dim=64, decoder_ffn_dim=64, encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=4, pad_token_id=1, decoder_start_token_id=2, max_positions=64,
    scale_embedding=True,
)

FIELD_SETS = [
    [("w1.weight", (16, 8), "bfloat16"), ("w2.weight", (8, 16), "bfloat16")],
    [("fc1.weight", (32, 32), "int4"), ("fc1.weight.scale", (64,), "float32"),
     ("fc1.bias", (64,), "float32"), ("fc2.weight", (64, 16), "int4"),
     ("fc2.weight.scale", (32,), "float32"), ("fc2.bias", (32,), "float32")],
    [("a", (3, 5), "int8"), ("a.scale", (5,), "float32"), ("b", (7,), "float16"),
     ("c", (130, 3), "float32")],
]


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    jmodel = JNllbModel(JNllbSpec(**SPEC), compute_dtype=jnp.float32)
    _, jtree = jmodel.init_random(jax.random.PRNGKey(5))
    root = tmp_path_factory.mktemp("torch_store")
    return {q: write_nllb_store(root / q, jtree["layers"], q, 2, seed=1)
            for q in ("float32", "int4")}


@pytest.mark.parametrize("fields", FIELD_SETS)
def test_record_layout_matches_jax(fields):
    got, stride = blob.build_record_layout(fields)
    want, jstride = jblob.build_record_layout(fields)
    assert stride == jstride and stride % blob.ALIGN == 0
    assert [(f.name, f.shape, f.dtype, f.offset, f.nbytes) for f in got] == \
        [(f.name, f.shape, f.dtype, f.offset, f.nbytes) for f in want]
    assert all(f.offset % 128 == 0 for f in got)


@pytest.mark.parametrize("quant_dtype", ["float32", "int4"])
def test_store_records_byte_equal_jax(stores, quant_dtype):
    path = stores[quant_dtype]
    got, want = blob.ExpertStore(path), jblob.ExpertStore(path)
    assert (got.num_layers, got.num_experts, got.stride, got.meta) == \
        (want.num_layers, want.num_experts, want.stride, want.meta)
    assert got.field_names == want.field_names
    for layer in range(got.num_layers):
        for e in range(got.num_experts):
            assert np.array_equal(got.get_record(layer, e), want.get_record(layer, e))
            ge, we = got.get_expert(layer, e), want.get_expert(layer, e)
            for name in got.field_names:
                assert ge[name].dtype == we[name].dtype and np.array_equal(ge[name], we[name])
                assert np.array_equal(got.get_tensor(layer, e, name), we[name])
    with pytest.raises(IndexError):
        got.get_record(got.num_layers, 0)


@pytest.mark.parametrize("fields", FIELD_SETS)
def test_writer_bytes_equal_jax_writer(tmp_path, fields):
    """The port's writer (bf16 taken as uint16 bits) gives the same blob and
    index as the JAX writer."""
    rng = np.random.default_rng(7)
    arrays = {}
    for name, shape, dt in fields:
        if dt in ("int8", "int4"):
            arrays[name] = rng.integers(-128, 128, shape).astype(np.int8)
        else:
            arrays[name] = rng.standard_normal(shape).astype(np.float32)
    jw = jblob.ExpertStoreWriter(str(tmp_path / "jax"), 2, 3, fields, meta={"k": 1})
    w = blob.ExpertStoreWriter(str(tmp_path / "port"), 2, 3, fields, meta={"k": 1})
    for layer in range(2):
        for e in range(3):
            for name, _, dt in fields:
                a = arrays[name] + layer + e if dt not in ("int8", "int4") else arrays[name]
                if dt == "bfloat16":
                    jw.write_tensor(layer, e, name, a.astype(ml_dtypes.bfloat16))
                    w.write_tensor(layer, e, name, dtypes.bf16_bits(a))
                elif dt == "float16":
                    jw.write_tensor(layer, e, name, a.astype(np.float16))
                    w.write_tensor(layer, e, name, a.astype(np.float16))
                else:
                    jw.write_tensor(layer, e, name, a)
                    w.write_tensor(layer, e, name, a)
    jw.finalize()
    w.finalize()
    for f in ("experts.blob", "experts.index.json"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes()


def test_writer_validates_shape_and_dtype(tmp_path):
    w = blob.ExpertStoreWriter(str(tmp_path), 1, 2, FIELD_SETS[0])
    w.write_tensor(0, 0, "w1.weight", np.zeros((16, 8), np.uint16))
    assert w._written[0, 0] and not w._written[0, 1]
    with pytest.raises(ValueError, match="shape"):
        w.write_tensor(0, 0, "w1.weight", np.zeros((8, 8), np.uint16))
    with pytest.raises(ValueError, match="dtype"):
        w.write_tensor(0, 0, "w1.weight", np.zeros((16, 8), np.float32))


@pytest.mark.parametrize("distinct", [False, True])
@pytest.mark.parametrize("fields", FIELD_SETS)
def test_synthetic_store_byte_equal_jax(fields, distinct):
    kw = dict(meta={"arch": "nllb"}, seed=11, distinct_records=distinct, cache_records=2)
    got = blob.SyntheticStore(3, 4, fields, **kw)
    want = jblob.SyntheticStore(3, 4, fields, **kw)
    assert got.stride == want.stride and got.field_names == want.field_names
    for layer, e in [(0, 0), (2, 3), (1, 2), (0, 0), (2, 1)]:  # past the LRU cache
        ge, we = got.get_expert(layer, e), want.get_expert(layer, e)
        for name in got.field_names:
            assert ge[name].tobytes() == we[name].tobytes(), (layer, e, name)
            assert got.get_tensor(layer, e, name).tobytes() == we[name].tobytes()


def test_int4_pack_unpack_matches_jax_and_k3_layout():
    rng = np.random.default_rng(3)
    v = rng.integers(-8, 8, (5, 6, 32)).astype(np.int8)
    packed = quant.pack_int4_np(v)
    np.testing.assert_array_equal(packed, jquant.pack_int4_np(v))
    # the split-nibble layout that ops.moe.pack_int4 and K3 take
    np.testing.assert_array_equal(packed, pack_int4(torch.from_numpy(v)).numpy())
    np.testing.assert_array_equal(quant.unpack_int4_np(packed), v)
    np.testing.assert_array_equal(quant.unpack_int4_np(packed), jquant.unpack_int4_np(packed))
    np.testing.assert_array_equal(unpack_int4(torch.from_numpy(packed)).numpy(), v)


@pytest.mark.parametrize("qdt", ["int8", "int4"])
def test_quantize_rowwise_matches_jax(qdt):
    w = np.random.default_rng(4).standard_normal((16, 24)).astype(np.float32)
    q, s = quant.quantize_rowwise(w, qdt)
    jq, js = jquant.quantize_rowwise(w, qdt)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    if qdt == "int4":  # q [out/2, in]: unpack along out first
        q, jq = quant.unpack_int4_np(q.T).T, jquant.unpack_int4_np(jq.T).T
    back = quant.dequantize_rowwise(q, s)
    np.testing.assert_array_equal(back, jquant.dequantize_rowwise(jq, js))
    # worst-case error of row-wise rounding is half a step
    assert (np.abs(back - w) <= s[:, None] * 0.5 + 1e-6).all()


def test_fp8_and_other_load_modes_raise(stores):
    """fp8 fields are served (their codes as uint8 bytes, byte-equal to the
    JAX quantizer: tests/test_torch_fp8.py); every load mode of the JAX store
    is served (tests/test_torch_native_store.py), and another raises, as
    JAX's does."""
    assert dtypes.np_dtype("float8_e4m3fn") == np.uint8
    q, s = quant.quantize_rowwise(np.ones((2, 2), np.float32), "float8_e4m3fn")
    jq, js = jquant.quantize_rowwise(np.ones((2, 2), np.float32), "float8_e4m3fn")
    assert q.tobytes() == np.asarray(jq).view(np.uint8).tobytes() and s.tobytes() == js.tobytes()
    for mode in ("ram", "direct"):
        st, ref = blob.ExpertStore(stores["float32"], load_mode=mode), \
            blob.ExpertStore(stores["float32"])
        assert st.get_record(0, 0).tobytes() == ref.get_record(0, 0).tobytes()
    with pytest.raises(ValueError, match="unknown load_mode"):
        blob.ExpertStore(stores["float32"], load_mode="tape")
    with pytest.raises(ValueError, match="unknown load_mode"):
        jblob.ExpertStore(stores["float32"], load_mode="tape")


def test_dtypes_bridge():
    x = np.random.default_rng(5).standard_normal(4096) * 0.02
    bits = dtypes.bf16_bits(x)
    np.testing.assert_array_equal(bits, x.astype(ml_dtypes.bfloat16).view(np.uint16))
    assert dtypes.dtype_name(np.uint16) == "bfloat16"
    assert dtypes.dtype_name(np.int8) == "int8"
    t = dtypes.to_tensor(bits, "bfloat16")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(ml_dtypes.bfloat16).astype(np.float32))
    ro = np.frombuffer(x.astype(np.float32).tobytes(), np.float32)  # read-only
    dst = torch.empty(4096, dtype=torch.bfloat16)
    dtypes.host_copy(dst, ro, "float32")  # cast on the host
    torch.testing.assert_close(dst, torch.from_numpy(ro.copy()).to(torch.bfloat16), rtol=0, atol=0)
    dst32 = torch.empty(4096)
    dtypes.host_copy(dst32, ro, "float32")  # same dtype: through numpy
    np.testing.assert_array_equal(dst32.numpy(), ro)


@pytest.mark.parametrize("quant_dtype", ["float32", "int4"])
def test_resident_provider_from_store_matches_jax(stores, quant_dtype):
    path = stores[quant_dtype]
    got = ResidentProvider.from_store(blob.ExpertStore(path), dtype=torch.float32, device="cpu")
    want = JProvider(jblob.ExpertStore(path), dtype=jnp.float32)
    gt, wt = got.pytree(), want.pytree()
    np.testing.assert_array_equal(gt["slot_map"].numpy(), np.asarray(wt["slot_map"]))
    for gl, wl in zip(gt["layers"], wt["layers"]):
        assert set(gl) == set(wl)
        for k in gl:
            np.testing.assert_array_equal(gl[k].numpy(), np.asarray(wl[k]), err_msg=k)
    assert got.nbytes() == want.hbm_bytes()
