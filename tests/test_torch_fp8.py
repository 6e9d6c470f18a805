"""float8_e4m3fn experts in the port against the JAX package, on the same
numpy inputs: the rounding of ``utils.dtypes.fp8_bits`` against
``ml_dtypes`` on the neighbourhood of every code (ties, subnormals, the
overflow bound, NaN and infinities), ``store/quant.py``'s row-wise fp8
byte-equal to the JAX quantizer (row maxima, zero rows), the writer,
``SyntheticStore`` and arena slots byte-equal to the JAX store and arena,
``gmm_plain`` with fp8 weights against the JAX gmm in interpret mode, and
every grouped-FFN impl against the JAX one. Tolerances: bytes are equal;
gmm 1e-5 (both take bf16(x) x bf16(w) products exactly and sum in f32, in
another order); the grouped FFN 1e-5 at f32 and 2e-2 at bf16 (the JAX
suite's gmm tolerance, tests/test_gmm.py:49)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from moe_infinity_tpu.ops import gmm as jgmm
from moe_infinity_tpu.ops import moe as jmoe
from moe_infinity_tpu.runtime.arena import ExpertArena as JArena
from moe_infinity_tpu.store import blob as jblob
from moe_infinity_tpu.store import quant as jquant
from moe_infinity_tpu_torch.ops import gmm as gm
from moe_infinity_tpu_torch.ops import moe
from moe_infinity_tpu_torch.runtime.arena import ExpertArena
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from moe_infinity_tpu_torch.store import blob, quant
from moe_infinity_tpu_torch.utils import dtypes

from torch_port_helpers import np32, write_decoder_store, one_intra_op_thread

F8 = ml_dtypes.float8_e4m3fn


def _neighbourhoods() -> np.ndarray:
    """f32 values around every finite e4m3 value (a few f32 ulps each way),
    the midpoints between neighbours and one ulp either side of each, the
    overflow bound 464 and its neighbours, values far past it, infinities
    and NaN, with both signs."""
    vals = np.arange(256, dtype=np.uint8).view(F8).astype(np.float32)
    vals = np.unique(vals[np.isfinite(vals)])
    bits = vals.view(np.uint32).astype(np.int64)
    near = (bits[:, None] + np.arange(-3, 4)[None, :]).ravel()
    near = near[(near >= 0) & (near < 2**31)].astype(np.uint32).view(np.float32)
    mids = ((vals[:-1].astype(np.float64) + vals[1:]) / 2).astype(np.float32)
    edge = np.array([448, 460, 463.99997, 464, 464.00003, 470, 479, 480, 500, 1e6, 3e38,
                     np.inf, np.nan, 2.0**-6, 2.0**-7, 2.0**-9, 2.0**-10, 3 * 2.0**-11,
                     1e-30, 0.0], np.float32)
    x = np.concatenate([near, mids, np.nextafter(mids, np.float32(np.inf)),
                        np.nextafter(mids, np.float32(-np.inf)), edge])
    return np.concatenate([x, -x])


def test_fp8_bits_match_ml_dtypes():
    x = _neighbourhoods()
    np.testing.assert_array_equal(dtypes.fp8_bits(x), x.astype(F8).view(np.uint8))
    # f64 input rounds through f32, as ml_dtypes does
    x64 = np.random.default_rng(0).standard_normal(200_000) * 0.02
    np.testing.assert_array_equal(dtypes.fp8_bits(x64), x64.astype(F8).view(np.uint8))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(dtypes.fp8_values(codes),
                                  codes.view(F8).astype(np.float32))


def _rows(kind: str) -> np.ndarray:
    """[out, in] weights whose quantization probes ``kind``."""
    rng = np.random.default_rng(11)
    x = _neighbourhoods()
    x = x[np.isfinite(x) & (np.abs(x) <= 448)]
    if kind == "neighbourhoods":  # row maximum 448: scale 1, w / s = w exactly
        n = 64
        x = np.concatenate([x, np.zeros((-len(x)) % (n - 1), np.float32)]).reshape(-1, n - 1)
        return np.concatenate([np.full((len(x), 1), 448.0, np.float32), x], axis=1)
    if kind == "row_maxima":  # any maximum: the quotient of the largest is 448 or a hair off
        w = rng.standard_normal((96, 40)).astype(np.float32) * rng.uniform(1e-4, 10, (96, 1))
        w[::3, 5] = -np.abs(w[::3]).max(axis=1) * 1.5  # a negative row maximum
        return w.astype(np.float32)
    if kind == "zero_rows":  # scale 1.0 and zero codes
        w = rng.standard_normal((8, 16)).astype(np.float32)
        w[[0, 3, 7]] = 0.0
        w[5] = -0.0
        return w
    if kind == "subnormal":  # most quotients below 2^-6
        w = (rng.standard_normal((32, 64)) * 1e-3).astype(np.float32)
        w[:, 0] = 448.0 * 2.0**-4
        w[:, 1] = np.float32(448.0 * 2.0**-4) * np.float32(2.0**-7)  # quotient 2^-7
        return w
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["neighbourhoods", "row_maxima", "zero_rows", "subnormal"])
def test_quantize_rowwise_fp8_byte_equal_jax(kind):
    w = _rows(kind)
    q, s = quant.quantize_rowwise(w, "float8_e4m3fn")
    jq, js = jquant.quantize_rowwise(w, "float8_e4m3fn")
    assert q.dtype == np.uint8 and q.shape == w.shape
    assert s.dtype == np.float32 and s.tobytes() == js.tobytes()
    assert q.tobytes() == np.asarray(jq).view(np.uint8).tobytes()
    back = quant.dequantize_rowwise(q, s)
    np.testing.assert_array_equal(back, jquant.dequantize_rowwise(jq, js))
    # e4m3 keeps 3 mantissa bits: a normal code is within 1/16 of its value
    normal = np.abs(w / s[:, None]) >= 2.0**-6
    assert (np.abs(back - w)[normal] <= np.abs(w)[normal] / 16 + 1e-30).all()


def test_store_dtypes_and_tensor_view():
    assert dtypes.np_dtype("float8_e4m3fn") == np.uint8
    assert dtypes.torch_dtype("float8_e4m3fn") == torch.float8_e4m3fn
    assert dtypes.dtype_name(np.uint8) == "uint8"  # a plain byte array stays bytes
    codes = np.arange(256, dtype=np.uint8).reshape(16, 16)
    t = dtypes.to_tensor(codes, "float8_e4m3fn")
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(t.view(torch.uint8).numpy(), codes)
    dst = torch.empty(16, 16, dtype=torch.float8_e4m3fn)
    dtypes.host_copy(dst, codes, "float8_e4m3fn")
    np.testing.assert_array_equal(dst.view(torch.uint8).numpy(), codes)
    dst16 = torch.empty(16, 16, dtype=torch.bfloat16)  # a cast goes through the values
    dtypes.host_copy(dst16, codes, "float8_e4m3fn")
    np.testing.assert_array_equal(dst16.float().numpy(), dtypes.fp8_values(codes))
    fields = [("w", (16, 16), "float8_e4m3fn")]
    layout, _ = blob.build_record_layout(fields)
    jlayout, _ = jblob.build_record_layout(fields)
    assert layout[0].nbytes == jlayout[0].nbytes == 256


FP8_FIELDS = [("linear.weight", (32, 64), "float8_e4m3fn"),
              ("linear.weight.scale", (64,), "float32"),
              ("linear_1.weight", (64, 32), "float8_e4m3fn"),
              ("linear_1.weight.scale", (32,), "float32"),
              ("linear_v.weight", (32, 64), "float8_e4m3fn"),
              ("linear_v.weight.scale", (64,), "float32")]


def test_writer_bytes_equal_jax_writer(tmp_path):
    rng = np.random.default_rng(3)
    jw = jblob.ExpertStoreWriter(str(tmp_path / "jax"), 2, 3, FP8_FIELDS, meta={"arch": "grok"})
    w = blob.ExpertStoreWriter(str(tmp_path / "port"), 2, 3, FP8_FIELDS, meta={"arch": "grok"})
    for layer in range(2):
        for e in range(3):
            for name, shape, dt in FP8_FIELDS:
                a = (rng.standard_normal(shape) * 40).astype(np.float32)
                if dt == "float8_e4m3fn":
                    jw.write_tensor(layer, e, name, a.astype(F8))
                    w.write_tensor(layer, e, name, dtypes.fp8_bits(a))
                else:
                    jw.write_tensor(layer, e, name, a)
                    w.write_tensor(layer, e, name, a)
    jw.finalize()
    w.finalize()
    for f in ("experts.blob", "experts.index.json"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes()
    with pytest.raises(ValueError, match="dtype"):
        w2 = blob.ExpertStoreWriter(str(tmp_path / "bad"), 1, 1, FP8_FIELDS)
        w2.write_tensor(0, 0, "linear.weight", np.zeros((32, 64), np.int8))


@pytest.mark.parametrize("distinct", [False, True])
def test_synthetic_store_fp8_byte_equal_jax(distinct):
    kw = dict(meta={"arch": "grok"}, seed=4, distinct_records=distinct)
    got = blob.SyntheticStore(2, 3, FP8_FIELDS, **kw)
    want = jblob.SyntheticStore(2, 3, FP8_FIELDS, **kw)
    assert got.stride == want.stride
    for layer, e in ((0, 0), (1, 2), (0, 1)):
        g, w = got.get_expert(layer, e), want.get_expert(layer, e)
        for name, _, dt in FP8_FIELDS:
            assert g[name].tobytes() == np.asarray(w[name]).tobytes(), name
            if dt == "float8_e4m3fn":
                assert g[name].dtype == np.uint8


def test_synthetic_store_fp8_pieces_continue_one_draw(monkeypatch):
    """A field drawn in pieces equals one draw's codes (the piece size is a
    bound on host memory, not part of the record)."""
    fields = [("w", (40, 50), "float8_e4m3fn")]
    whole = blob.SyntheticStore(1, 1, fields, seed=9).get_tensor(0, 0, "w")
    monkeypatch.setattr(blob, "_FP8_PIECE", 333)
    pieces = blob.SyntheticStore(1, 1, fields, seed=9).get_tensor(0, 0, "w")
    np.testing.assert_array_equal(whole, pieces)


def _grok_tree(rng, E, D, F, layers=2):
    """A numpy expert tree of f32 weights (compute layout)."""
    return [{"gate": (rng.standard_normal((E, D, F)) * 0.05).astype(np.float32),
             "up": (rng.standard_normal((E, D, F)) * 0.05).astype(np.float32),
             "down": (rng.standard_normal((E, F, D)) * 0.05).astype(np.float32)}
            for _ in range(layers)]


@pytest.fixture(scope="module")
def fp8_store(tmp_path_factory):
    rng = np.random.default_rng(21)
    tree = _grok_tree(rng, 4, 16, 32)
    return write_decoder_store(tmp_path_factory.mktemp("fp8") / "s", tree, "grok",
                               "float8_e4m3fn")


def test_store_records_byte_equal_jax(fp8_store):
    got, want = blob.ExpertStore(fp8_store), jblob.ExpertStore(fp8_store)
    assert [(f.name, f.shape, f.dtype) for f in got.fields] == \
        [(f.name, f.shape, f.dtype) for f in want.fields]
    for layer in range(2):
        for e in range(4):
            assert np.array_equal(got.get_record(layer, e), want.get_record(layer, e))
            for name in got.field_names:
                assert got.get_tensor(layer, e, name).tobytes() == \
                    np.asarray(want.get_tensor(layer, e, name)).tobytes()


def test_resident_provider_keeps_fp8(fp8_store):
    tree = ResidentProvider.from_store(blob.ExpertStore(fp8_store), dtype=torch.float32,
                                       device="cpu").pytree()
    w = tree["layers"][1]
    assert w["gate"].dtype == w["up"].dtype == w["down"].dtype == torch.float8_e4m3fn
    assert w["gate_scale"].dtype == torch.float32
    rec = blob.ExpertStore(fp8_store).get_expert(1, 3)
    np.testing.assert_array_equal(w["down"][3].view(torch.uint8).numpy(), rec["linear_1.weight"])


@pytest.mark.parametrize("slots", [4, 6])
def test_arena_slots_byte_equal_jax_arena(fp8_store, slots):
    """The port's slots hold the store's codes as float8_e4m3fn, as the JAX
    arena's ``jnp.float8_e4m3fn`` slots do: byte for byte after the same
    acquires (one worker, LRU), with equal slot rows and counters."""
    arena = ExpertArena(blob.ExpertStore(fp8_store), slots, compute_dtype=torch.float32,
                        device="cpu", num_threads=1, policy="lru")
    jarena = JArena(jblob.ExpertStore(fp8_store), slots, policy="lru",
                    compute_dtype=jnp.float32, num_threads=1)
    try:
        tree = arena.pytree()
        assert {k: t.dtype for k, t in tree.items()} == {
            "gate": torch.float8_e4m3fn, "up": torch.float8_e4m3fn,
            "down": torch.float8_e4m3fn, "gate_scale": torch.float32,
            "up_scale": torch.float32, "down_scale": torch.float32}
        for step, keys in enumerate([[(0, 1), (0, 2)], [(1, 0), (1, 3)], [(0, 3), (0, 0)],
                                     [(1, 1), (1, 2)], [(0, 1), (0, 2)]]):
            layer = keys[0][0]
            for a in (arena, jarena):
                a.acquire(keys, layer)
                a.release(keys)
            np.testing.assert_array_equal(arena.slot_map(layer), jarena.slot_map(layer))
            jtree = jarena.pytree()
            for k, t in tree.items():
                jt = np.asarray(jtree[k])
                if t.dtype == torch.float8_e4m3fn:
                    assert t.view(torch.uint8).numpy().tobytes() == jt.view(np.uint8).tobytes(), k
                else:
                    assert t.numpy().tobytes() == jt.tobytes(), k
        assert arena.hit_stats() == jarena.hit_stats()
    finally:
        arena.shutdown()
        jarena.shutdown()


# ---- K3 and the grouped FFN ------------------------------------------------

def _fp8_weights(rng, S, D, F):
    codes = (rng.standard_normal((S, D, F)) * 64).astype(np.float32).astype(F8)
    return codes, rng.uniform(2.5e-4, 3.75e-4, (S, F)).astype(np.float32)


@pytest.mark.parametrize("sizes", [[3, 0, 5, 1], [1, 1], [70, 2, 0, 64]])
def test_gmm_plain_fp8_matches_jax_interpret(sizes):
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    G, T, D, F = len(sizes), sum(sizes), 64, 256
    x = rng.standard_normal((T, D)).astype(np.float32)
    codes, scale = _fp8_weights(rng, G + 1, D, F)
    gs = np.asarray(sizes, np.int32)
    gid = np.arange(G, dtype=np.int32) + 1  # rows into w past slot 0
    want = jgmm.gmm(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(gs), jnp.asarray(scale),
                    group_ids=jnp.asarray(gid), num_groups=G, interpret=True)
    w = torch.from_numpy(codes.view(np.uint8)).view(torch.float8_e4m3fn)
    got = gm.gmm(torch.tensor(x), w, torch.tensor(gs), torch.tensor(scale),
                 group_ids=torch.tensor(gid))
    assert gm.LAUNCHES["gmm_fp8"] == 0  # the plain version on the CPU
    tol = 1e-5 * float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(np32(got), np.asarray(want), rtol=1e-5, atol=tol)


def test_gmm_plain_fp8_is_bf16_products():
    """Every code converts exactly: the plain version's products are those of
    the codes' values, each of them a bf16 value."""
    codes = np.arange(256, dtype=np.uint8)
    codes = codes[np.isfinite(codes.view(F8).astype(np.float32))][:240].reshape(1, 16, 15)
    codes = np.concatenate([codes, codes[..., :1]], axis=-1)  # F 16
    w = torch.from_numpy(codes).view(torch.float8_e4m3fn)
    vals = codes.view(F8).astype(np.float32)
    assert np.array_equal(vals.astype(ml_dtypes.bfloat16).astype(np.float32), vals)
    x = torch.eye(16)
    got = gm.gmm(x, w, torch.tensor([16], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), vals[0])


@pytest.mark.parametrize("impl", ["ragged", "gather", "dense", "pallas"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("activation", ["gelu", "silu"])
def test_grouped_ffn_fp8_matches_jax(monkeypatch, impl, dtype, activation):
    """Each impl with fp8 experts against the JAX impl of the same name (the
    JAX gather rounds x to fp8 for the gate and up products, and the port's
    does too; the pallas impl runs the JAX kernel in interpret mode and K3's
    plain version)."""
    rng = np.random.default_rng(5)
    T, D, F, E, K = 6, 32, 64, 4, 2
    x = (rng.standard_normal((T, D)) * 2).astype(np.float32)
    ids = np.stack([rng.permutation(E)[:K] for _ in range(T)]).astype(np.int32)
    cw = rng.uniform(0.1, 1.0, (T, K)).astype(np.float32)
    jw, w = {}, {}
    for role, shape in (("gate", (E, D, F)), ("up", (E, D, F)), ("down", (E, F, D))):
        codes, scale = _fp8_weights(rng, shape[0], shape[1], shape[2])
        jw[role], jw[role + "_scale"] = jnp.asarray(codes), jnp.asarray(scale)
        w[role] = torch.from_numpy(codes.view(np.uint8)).view(torch.float8_e4m3fn)
        w[role + "_scale"] = torch.tensor(scale)
    jdt, tdt, tol = ((jnp.float32, torch.float32, 1e-5) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 2e-2))
    if impl == "pallas":
        import functools
        monkeypatch.setattr(jgmm, "gffn_pallas",
                            functools.partial(jgmm.gffn_pallas, interpret=True))
    slot = np.arange(E, dtype=np.int32)
    want = jmoe.grouped_ffn(jnp.asarray(x, jdt), jnp.asarray(ids), jnp.asarray(cw),
                            jnp.asarray(slot), jw, activation, impl=impl)
    got = moe.grouped_ffn(torch.tensor(x).to(tdt), torch.tensor(ids), torch.tensor(cw),
                          torch.tensor(slot), w, activation, impl=impl)
    assert got.dtype == tdt
    np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_gather_rounds_x_as_jax_does_past_the_fp8_range():
    """The JAX gather casts x to the slab's type: past 464 that is NaN, as
    ``jnp``'s cast gives it (torch's own cast would saturate to 448)."""
    x = torch.tensor([[500.0, 1.0, 448.0, -470.0, 3.3]])
    got = moe._as_operand(x, torch.float8_e4m3fn)
    want = np.asarray(jnp.asarray(x.numpy()).astype(jnp.float8_e4m3fn).astype(jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
