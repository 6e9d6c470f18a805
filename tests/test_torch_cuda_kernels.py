"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip without a CUDA device. On a machine with
one, run them with ``python3 -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernels.py`` (``--noconftest``: the repo conftest imports
jax, which that machine need not have).
Tolerance 2e-2 (rtol and atol) for bf16 operands, as the JAX suite's gmm
tests, and 2e-3 for f32 attention (summation order only). K3's e4m3 weights
are exact in bf16, so they take the bf16 tolerance; K1, K2 and K4 run at
Grok-1's rep 6 with its softcap and score scale and at Arctic's rep 7, and
on their zero-padded instances (head dims 80, 33, 200, 256) and row groups
(rep 16)."""

import pytest
import torch

from moe_infinity_tpu_torch.ops import flash_attention as fa
from moe_infinity_tpu_torch.ops import gmm as gm
from moe_infinity_tpu_torch.ops.moe import grouped_ffn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _gen(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    return g


def _close(got, want, tol):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,pad,softcap,causal", [
    (1, False, None, True), (2, True, None, True), (4, False, 30.0, True),
    (2, True, None, False), (6, True, 30.0, True), (7, True, None, True),
])
def test_flash_decode_kernel(dev, dtype, rep, pad, softcap, causal):
    g = _gen(dev)
    B, Hkv, S, Dh = 3, 4, 48, 128
    H = Hkv * rep
    q = torch.randn(B, 1, H, Dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    pos = torch.tensor([[3], [20], [47]], dtype=torch.int32, device=dev)
    mask = torch.rand(B, S, generator=g, device=dev) > 0.3 if pad else None
    if pad:
        mask[2] = False  # a row with no valid key returns 0
    kw = dict(causal=causal, logit_softcap=softcap, pad_mask=mask)
    got = fa.flash_decode(q, k, v, pos, 40, **kw)
    want = fa.flash_decode_plain(q[:, 0], k, v, pos[:, 0], 40, scale=Dh ** -0.5, **kw)
    _close(got[:, 0], want, 2e-3 if dtype == torch.float32 else 2e-2)
    if pad:
        assert bool((got[2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,causal,bias,pad", [
    (37, True, None, False), (64, False, "B11S", False), (20, False, "1HTS", True),
    (1, False, "B11S", False), (33, True, "B1TS", True),
])
def test_flash_attend_kernel(dev, dtype, T, causal, bias, pad):
    g = _gen(dev)
    B, H, Hkv, S, Dh = 2, 4, 2, 70, 128
    q = torch.randn(B, T, H, Dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    pos = (5 + torch.arange(T, device=dev, dtype=torch.int32)).expand(B, T).contiguous()
    shape = {"B11S": (B, 1, 1, S), "1HTS": (1, H, T, S), "B1TS": (B, 1, T, S)}.get(bias)
    b = torch.randn(*shape, generator=g, device=dev) if shape else None
    mask = torch.rand(B, S, generator=g, device=dev) > 0.3 if pad else None
    kw = dict(causal=causal, bias=b, pad_mask=mask)
    got = fa.flash_attend(q, k, v, pos, 60, **kw)
    want = fa.flash_attend_plain(q, k, v, pos, 60, scale=Dh ** -0.5, **kw)
    _close(got, want, 2e-3 if dtype == torch.float32 else 2e-2)


def _fp8(dev, g, *shape):
    """float8_e4m3fn weights of std 64 (clamped to e4m3's 448) from ``g``."""
    return (torch.randn(*shape, generator=g, device=dev) * 64).clamp_(-448, 448).to(
        torch.float8_e4m3fn)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "fp8"])
def test_gmm_kernel(dev, kind):
    g = _gen(dev)
    S, D, F, T = 6, 384, 512, 40
    sizes = torch.tensor([9, 0, 14, 1, 0, 16], dtype=torch.int32, device=dev)
    x = torch.randn(T, D, generator=g, device=dev)
    scale = None
    if kind == "bf16":
        w = (torch.randn(S, D, F, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    elif kind == "fp8":
        w, scale = _fp8(dev, g, S, D, F), torch.rand(S, F, generator=g, device=dev) * 4e-4
    else:
        Fw = F // 2 if kind == "int4" else F
        w = torch.randint(-128, 128, (S, D, Fw), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(S, F, generator=g, device=dev) * 0.01
    packed = kind == "int4"
    got = gm.gmm(x, w, sizes, scale, packed=packed)
    want = gm.gmm_plain(x, w, sizes, scale, packed=packed)
    _close(got, want, 2e-2)
    assert bool((got[sizes.sum():] == 0).all())


def test_gmm_kernel_skewed_groups_split_into_chunks(dev):
    """A group routing many rows spreads over many blocks (64-row chunks)."""
    g = _gen(dev)
    S, D, F = 8, 512, 1024
    sizes = torch.tensor([0, 150, 3, 0, 21, 1, 0, 8], dtype=torch.int32, device=dev)
    T = int(sizes.sum())
    x = torch.randn(T, D, generator=g, device=dev)
    w = torch.randint(-128, 128, (S, D, F // 2), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand(S, F, generator=g, device=dev) * 0.01
    got = gm.gmm(x, w, sizes, scale, packed=True)
    want = gm.gmm_plain(x, w, sizes, scale, packed=True)
    _close(got, want, 2e-2)


def _gmm_inputs(dev, kind, sizes, D, F, rows_past=0, S=None):
    g = _gen(dev)
    S = S or len(sizes)
    T = sum(sizes) + rows_past
    x = torch.randn(T, D, generator=g, device=dev)
    scale = None
    if kind == "bf16":
        w = (torch.randn(S, D, F, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    elif kind == "fp8":
        w, scale = _fp8(dev, g, S, D, F), torch.rand(S, F, generator=g, device=dev) * 4e-4
    else:
        Fw = F // 2 if kind == "int4" else F
        w = torch.randint(-128, 128, (S, D, Fw), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(S, F, generator=g, device=dev) * 0.01
    return x, w, torch.tensor(sizes, dtype=torch.int32, device=dev), scale


@pytest.mark.parametrize("kind,F", [("bf16", 320), ("int8", 704), ("int4", 1408),
                                    ("fp8", 336)])
@pytest.mark.parametrize("sizes", [
    [0, 1, 15, 16, 17, 0, 63, 64, 65, 150],  # the 64-row chunks' and m16 tiles' edges
    [64, 64],  # the last group ends at a chunk edge
    [37, 27, 0],  # ... and at T
])
def test_gmm_kernel_chunk_edges(dev, kind, F, sizes):
    """Also D=328 (8 past the last whole 64-deep k-tile), a half column tile,
    and rows past the last group, which stay zero."""
    x, w, sz, scale = _gmm_inputs(dev, kind, sizes, 328, F, rows_past=5)
    got = gm.gmm(x, w, sz, scale, packed=kind == "int4")
    want = gm.gmm_plain(x, w, sz, scale, packed=kind == "int4")
    _close(got, want, 2e-2)
    assert bool((got[sum(sizes):] == 0).all())


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "fp8"])
def test_gmm_kernel_several_splits_against_one(dev, kind, monkeypatch):
    """NLLB's decode down projection (8 rows, D=8192) under the plan's
    splits, then under one; the split run repeats to the bit (the tickets
    are back at 0 after every call)."""
    x, w, sz, scale = _gmm_inputs(dev, kind, [3, 1, 0, 4], 8192, 1024)
    packed = kind == "int4"
    assert gm._gmm_plan(8, 4, 8192, w.shape[2]).splits > 1
    split = [gm.gmm(x, w, sz, scale, packed=packed) for _ in range(3)]
    monkeypatch.setattr(gm, "_GMM_BLOCKS", 1)
    assert gm._gmm_plan(8, 4, 8192, w.shape[2]).splits == 1
    one = gm.gmm(x, w, sz, scale, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(split[0], split[1]) and torch.equal(split[0], split[2])
    # the same f32 sums in another order: within 3e-5 of the largest output
    torch.testing.assert_close(split[0], one, rtol=0, atol=3e-5 * one.abs().max().item())
    _close(one, gm.gmm_plain(x, w, sz, scale, packed=packed), 2e-2)


def test_gmm_kernel_fp8_codes_exactly(dev):
    """Every e4m3 code through the kernel's conversion: an identity x picks
    the weight rows, each code's value exactly (NaN where the code is NaN)."""
    codes = torch.arange(256, dtype=torch.uint8, device=dev).reshape(16, 16)
    w = codes.repeat(1, 8).contiguous().view(torch.float8_e4m3fn)[None]  # [1, 16, 128]
    x = torch.eye(16, device=dev)
    sizes = torch.tensor([16], dtype=torch.int32, device=dev)
    before = gm.LAUNCHES["gmm_fp8"]
    got = gm.gmm(x, w, sizes)
    assert gm.LAUNCHES["gmm_fp8"] == before + 1
    want = w[0].float()  # x = I: out = w exactly
    torch.cuda.synchronize()
    nan = torch.isnan(want).any(0, keepdim=True).expand_as(want)  # 0 * NaN spreads a column
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


@pytest.mark.parametrize("T,sizes,D,F", [
    (2, [1, 1], 6144, 32768),  # Grok-1's batch-1 gate: 256 column tiles, one split
    (2, [1, 1], 32768, 6144),  # ... and down: 512 k-tiles in 3 splits
    (2, [1, 1], 7168, 4864),  # Arctic's gate: 38 column tiles, 4 splits
    (2, [1, 1], 4864, 7168),  # ... and down
    (16, [3, 1, 2, 4, 0, 2, 3, 1], 6144, 4096),  # a W = 8 step's rows over 8 experts
])
def test_gmm_kernel_fp8_grok_arctic_widths(dev, T, sizes, D, F):
    x, w, sz, scale = _gmm_inputs(dev, "fp8", sizes, D, F, rows_past=T - sum(sizes))
    got = gm.gmm(x, w, sz, scale)
    _close(got, gm.gmm_plain(x, w, sz, scale), 2e-2)


def test_gmm_kernel_on_a_second_stream_without_a_host_sync(dev):
    """A split call queued on another stream takes that stream's tickets
    and workspace; no call reads the group sizes on the host."""
    x, w, sz, scale = _gmm_inputs(dev, "int8", [5, 0, 3], 4096, 512)
    want = gm.gmm_plain(x, w, sz, scale)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = gm.gmm(x, w, sz, scale)
        with torch.cuda.stream(side):
            got = gm.gmm(x, w, sz, scale)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    side.synchronize()
    _close(got, want, 2e-2)
    assert torch.equal(first, got)


def test_gmm_kernel_compacted_ids_and_offset(dev):
    g = _gen(dev)
    L, S, D, F, T = 3, 16, 256, 256, 12
    w = torch.randint(-128, 128, (L * S, D, F // 2), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand(L * S, F, generator=g, device=dev) * 0.01
    x = torch.randn(T, D, generator=g, device=dev)
    ids = torch.tensor([2, 7, 11, 0, 0], dtype=torch.int32, device=dev)
    sizes = torch.tensor([5, 3, 4, 0, 0], dtype=torch.int32, device=dev)
    got = gm.gmm(x, w, sizes, scale, group_offset=S, group_ids=ids, packed=True)
    want = gm.gmm_plain(x, w, sizes, scale, group_offset=S, group_ids=ids, packed=True)
    _close(got, want, 2e-2)


def test_grouped_ffn_pallas_kernel_matches_plain(dev):
    g = _gen(dev)
    T, D, F, E, K = 24, 256, 512, 16, 2
    x = torch.randn(T, D, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.stack([torch.randperm(E, generator=g, device=dev)[:K] for _ in range(T)])
    cw = torch.rand(T, K, generator=g, device=dev)
    slot = torch.arange(E, dtype=torch.int32, device=dev)
    slot[3] = -1  # a non-resident expert contributes nothing
    w = {
        "gate4": torch.randint(-128, 128, (E, D, F // 2), generator=g, device=dev, dtype=torch.int8),
        "gate_scale": torch.rand(E, F, generator=g, device=dev) * 0.005,
        "down4": torch.randint(-128, 128, (E, F, D // 2), generator=g, device=dev, dtype=torch.int8),
        "down_scale": torch.rand(E, D, generator=g, device=dev) * 0.005,
    }
    b = {"gate_bias": torch.randn(E, F, generator=g, device=dev) * 0.1,
         "down_bias": torch.randn(E, D, generator=g, device=dev) * 0.1}
    got = grouped_ffn(x, ids, cw, slot, w, "relu", biases=b, impl="pallas")
    cpu = {k: v.cpu() for k, v in w.items()}
    want = grouped_ffn(x.cpu(), ids.cpu(), cw.cpu(), slot.cpu(), cpu, "relu",
                       biases={k: v.cpu() for k, v in b.items()}, impl="pallas")
    _close(got.cpu(), want, 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,holes,softcap", [
    (4, True, None), (8, False, None), (4, False, 30.0), (1, True, None),
    (6, True, 30.0), (7, True, None),
])
def test_paged_flash_decode_kernel(dev, dtype, rep, holes, softcap):
    """Shuffled page table, hole mask, a row of length 0 (gives 0) and a
    row past the table's columns (clamped to P * page)."""
    g = _gen(dev)
    B, Hkv, Dh, page, P, NP = 4, 2, 128, 16, 6, 40
    H = Hkv * rep
    q = torch.randn(B, H, Dh, generator=g, device=dev).to(dtype)
    pk = torch.randn(NP, page, Hkv, Dh, generator=g, device=dev).to(dtype)
    pv = torch.randn(NP, page, Hkv, Dh, generator=g, device=dev).to(dtype)
    table = torch.stack([torch.randperm(NP, generator=g, device=dev)[:P]
                         for _ in range(B)]).to(torch.int32)
    lengths = torch.tensor([37, 0, 96, 200], dtype=torch.int32, device=dev)
    mask = torch.rand(B, P * page, generator=g, device=dev) > 0.3 if holes else None
    kw = dict(logit_softcap=softcap, pad_mask=mask)
    got = fa.paged_flash_decode(q, pk, pv, table, lengths, **kw)
    want = fa.paged_flash_decode_plain(q, pk, pv, table, lengths, scale=Dh ** -0.5, **kw)
    _close(got, want, 2e-3 if dtype == torch.float32 else 2e-2)
    assert bool((got[1] == 0).all())


def test_paged_flash_decode_kernel_rejects_mixed_devices(dev):
    q = torch.zeros(1, 8, 128, device=dev)
    pool = torch.zeros(4, 16, 2, 128, device=dev)
    table = torch.zeros(1, 2, dtype=torch.int32)  # on the CPU
    with pytest.raises(ValueError, match="different devices"):
        fa.paged_flash_decode(q, pool, pool, table, torch.ones(1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("fused", [False, True])
def test_grouped_ffn_pallas_gated_int8_kernel_matches_plain(dev, fused):
    """Mixtral's SiLU-gated FFN on K3: gate + up (two launches) or fused
    gateup (one), int8 weights with per-channel scales."""
    from moe_infinity_tpu_torch.ops.moe import fuse_gateup

    g = _gen(dev)
    T, D, F, E, K = 8, 512, 768, 8, 2
    x = torch.randn(T, D, generator=g, device=dev).to(torch.bfloat16)
    ids = torch.stack([torch.randperm(E, generator=g, device=dev)[:K] for _ in range(T)])
    cw = torch.rand(T, K, generator=g, device=dev)
    slot = torch.arange(E, dtype=torch.int32, device=dev)
    w = {}
    for role, (d_in, d_out) in (("gate", (D, F)), ("up", (D, F)), ("down", (F, D))):
        w[role] = torch.randint(-127, 127, (E, d_in, d_out), generator=g, device=dev,
                                dtype=torch.int8)
        w[role + "_scale"] = torch.rand(E, d_out, generator=g, device=dev) * 1e-3 + 1e-3
    if fused:
        w = fuse_gateup(w)
    before = gm.LAUNCHES["gmm"]
    got = grouped_ffn(x, ids, cw, slot, w, "silu", impl="pallas")
    assert gm.LAUNCHES["gmm"] - before == (2 if fused else 3)
    cpu = {k: v.cpu() for k, v in w.items()}
    want = grouped_ffn(x.cpu(), ids.cpu(), cw.cpu(), slot.cpu(), cpu, "silu", impl="pallas")
    _close(got.cpu(), want, 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,S,kv_len,holes,scale", [
    (16, 512, 512, True, 192 ** -0.5),  # V2-Lite's batcher decode step
    (16, 64, 41, False, 1.0),  # one request, folded scale, kv_len below S
    (128, 200, 200, True, 192 ** -0.5),  # V2/V3 heads; no power of two divides S
    (5, 37, 37, True, 0.3),  # a head group that is not full
])
def test_mla_flash_decode_kernel(dev, dtype, H, S, kv_len, holes, scale):
    """K5 against its plain version: mixed types (f32 q and out, caches in
    `dtype`), a row with no valid key (gives 0), a row past kv_len."""
    g = _gen(dev)
    B, R, P = 4, 512, 64
    q_lat = torch.randn(B, H, R, generator=g, device=dev)
    q_pe = torch.randn(B, H, P, generator=g, device=dev)
    c = torch.randn(B, S, R, generator=g, device=dev).to(dtype)
    kpe = torch.randn(B, S, P, generator=g, device=dev).to(dtype)
    pos = torch.tensor([S // 5, S // 2, 7, S + 3], dtype=torch.int32, device=dev)
    mask = torch.rand(B, S, generator=g, device=dev) > 0.2 if holes else None
    if holes:
        mask[2] = False
    before = fa.LAUNCHES["mla_flash_decode"]
    got = fa.mla_flash_decode(q_lat, q_pe, c, kpe, pos, kv_len, scale=scale, pad_mask=mask)
    assert fa.LAUNCHES["mla_flash_decode"] == before + 1
    want = fa.mla_flash_decode_plain(q_lat, q_pe, c, kpe, pos, kv_len, scale=scale, pad_mask=mask)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, R)
    _close(got, want, 2e-3 if dtype == torch.float32 else 2e-2)
    if holes:
        assert bool((got[2] == 0).all())


def _mla_case(dev, H, S, lengths, dtype=torch.bfloat16):
    g = _gen(dev)
    B, R, P = len(lengths), 512, 64
    q_lat = torch.randn(B, H, R, generator=g, device=dev)
    q_pe = torch.randn(B, H, P, generator=g, device=dev)
    c = torch.randn(B, S, R, generator=g, device=dev).to(dtype)
    kpe = torch.randn(B, S, P, generator=g, device=dev).to(dtype)
    pos = torch.tensor(lengths, dtype=torch.int32, device=dev) - 1
    mask = torch.rand(B, S, generator=g, device=dev) > 0.1
    return q_lat, q_pe, c, kpe, pos, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [16, 128])
def test_mla_flash_decode_one_split_and_several(dev, dtype, H, monkeypatch):
    """The V2-Lite rows under the plan's splits, then under one split a row
    (the kernel writes the result itself): both hold to the plain version,
    and to each other within the f32 sums' reordering."""
    args = _mla_case(dev, H, 512, [113, 200, 37, 512], dtype)
    kw = dict(scale=192 ** -0.5, pad_mask=args[5])
    assert fa._mla_splits(4, H, 512)[1] > 1
    several = fa.mla_flash_decode(*args[:5], 512, **kw)
    monkeypatch.setattr(fa, "_MLA_MIN_TILES", 16)
    assert fa._mla_splits(4, H, 512)[1] == 1
    one = fa.mla_flash_decode(*args[:5], 512, **kw)
    want = fa.mla_flash_decode_plain(*args[:5], 512, **kw)
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    _close(several, want, tol)
    _close(one, want, tol)
    torch.testing.assert_close(several, one, rtol=0, atol=1e-5)


def test_mla_flash_decode_repeats_to_the_bit(dev):
    """The merge runs in split order, so a call repeats to the bit, and the
    tickets are back at 0 after every call (a long row: many splits)."""
    args = _mla_case(dev, 16, 4096, [4096, 3000, 100, 1])
    kw = dict(scale=192 ** -0.5, pad_mask=args[5])
    assert fa._mla_splits(4, 16, 4096)[1] > 8
    first = fa.mla_flash_decode(*args[:5], 4096, **kw)
    again = [fa.mla_flash_decode(*args[:5], 4096, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, a) for a in again)
    _close(first, fa.mla_flash_decode_plain(*args[:5], 4096, **kw), 2e-2)


def test_mla_flash_decode_on_a_second_stream_without_a_host_sync(dev):
    """A split call queued on another stream takes that stream's tickets and
    workspace and reads nothing on the host."""
    args = _mla_case(dev, 128, 512, [113, 200, 37, 512])
    kw = dict(scale=192 ** -0.5, pad_mask=args[5])
    want = fa.mla_flash_decode_plain(*args[:5], 512, **kw)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = fa.mla_flash_decode(*args[:5], 512, **kw)
        with torch.cuda.stream(side):
            got = fa.mla_flash_decode(*args[:5], 512, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    side.synchronize()
    _close(got, want, 2e-2)
    assert torch.equal(first, got)


def test_mla_flash_decode_kernel_rejects_what_it_does_not_take(dev):
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="queue 2 part 4's remainder"):
        fa.mla_flash_decode(z(1, 4, 640), z(1, 4, 64), z(1, 8, 640), z(1, 8, 64), pos, 8, scale=1.0)
    with pytest.raises(ValueError, match="different devices"):
        fa.mla_flash_decode(z(1, 4, 512), z(1, 4, 64), z(1, 8, 512), z(1, 8, 64),
                            torch.zeros(1, dtype=torch.int32), 8, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fa.mla_flash_decode(z(1, 4, 512), z(1, 4, 64), z(1, 8, 1024)[:, :, ::2], z(1, 8, 64),
                            pos, 8, scale=1.0)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("offset", [0, 128])
def test_gmm_kernel_deepseek_widths(dev, kind, offset):
    """D 2048, F 1408 (V2-Lite): 11 column tiles for bf16 and int8, 5.5 for
    packed int4 (the partial tile), all 64 groups passed uncompacted with
    most of them empty, and a group offset into a stacked pool."""
    g = _gen(dev)
    E, D, F, rows = 64, 2048, 1408, 24
    S = offset + E
    flat = torch.randint(0, E, (rows,), generator=g, device=dev)
    sizes = torch.zeros(E, dtype=torch.int32, device=dev)
    sizes.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    x = torch.randn(rows, D, generator=g, device=dev)
    scale = None
    if kind == "bf16":
        w = (torch.randn(S, D, F, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    else:
        Fw = F // 2 if kind == "int4" else F
        w = torch.randint(-128, 128, (S, D, Fw), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(S, F, generator=g, device=dev) * 0.01
    packed = kind == "int4"
    got = gm.gmm(x, w, sizes, scale, group_offset=offset, packed=packed)
    want = gm.gmm_plain(x, w, sizes, scale, group_offset=offset, packed=packed)
    _close(got, want, 2e-2)


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("D,F,tf", [(2048, 1408, 0), (2048, 1408, 352), (1408, 2048, 0)])
def test_gmm_kernel_tiled_is_bit_equal_to_flat(dev, kind, D, F, tf):
    """The pre-tiled layout at V2-Lite's widths: gate/up in pack_tiled's
    default slabs (tf 128) and in slabs of 352 (a 128-column tile then reads
    two slabs), down in slabs of 512, at group offset 128 into a stacked
    pool: the kernel's products and their order are the flat call's, so the
    outputs are bit-equal; counted under gmm_tiled."""
    g = _gen(dev)
    E, rows, offset = 64, 24, 128
    S = offset + E
    flat = torch.randint(0, E, (rows,), generator=g, device=dev)
    sizes = torch.zeros(E, dtype=torch.int32, device=dev)
    sizes.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    x = torch.randn(rows, D, generator=g, device=dev)
    scale = None
    if kind == "bf16":
        w = (torch.randn(S, D, F, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    else:
        w = torch.randn(S, D, F, generator=g, device=dev) * 40
        w = w.clamp(-128, 127).to(torch.int8) if kind == "int8" else w.to(torch.float8_e4m3fn)
        scale = torch.rand(S, F, generator=g, device=dev) * 0.01
    wt = gm.pack_tiled(w, tf)
    width = tf or {1408: 128, 2048: 512}[F]
    assert wt.shape[1:] == (F // width, D, width)
    before = gm.LAUNCHES["gmm_tiled"]
    got = gm.gmm(x, wt, sizes, scale, group_offset=offset)
    assert gm.LAUNCHES["gmm_tiled"] == before + 1
    assert torch.equal(got, gm.gmm(x, w, sizes, scale, group_offset=offset))
    _close(got, gm.gmm_plain(x, wt, sizes, scale, group_offset=offset), 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,P", [(256, 32), (384, 64)])
def test_mla_flash_decode_padded_widths(dev, dtype, R, P):
    """K5's padded instance at R 256 and 384 against its plain version:
    V2-Lite's rows (113, 200, 37 and 512 live keys) with holes, a row with
    no valid key (gives 0), counted under mla_flash_decode_pad."""
    g = _gen(dev)
    B, H, S = 4, 16, 512
    q_lat = torch.randn(B, H, R, generator=g, device=dev)
    q_pe = torch.randn(B, H, P, generator=g, device=dev)
    c = torch.randn(B, S, R, generator=g, device=dev).to(dtype)
    kpe = torch.randn(B, S, P, generator=g, device=dev).to(dtype)
    pos = torch.tensor([112, 199, 36, 511], dtype=torch.int32, device=dev)
    mask = torch.rand(B, S, generator=g, device=dev) > 0.1
    mask[2] = False
    before = fa.LAUNCHES["mla_flash_decode_pad"]
    got = fa.mla_flash_decode(q_lat, q_pe, c, kpe, pos, S, scale=0.07, pad_mask=mask)
    assert fa.LAUNCHES["mla_flash_decode_pad"] == before + 1
    want = fa.mla_flash_decode_plain(q_lat, q_pe, c, kpe, pos, S, scale=0.07, pad_mask=mask)
    assert tuple(got.shape) == (B, H, R)
    _close(got, want, 2e-3 if dtype == torch.float32 else 2e-2)
    assert bool((got[2] == 0).all())


@pytest.mark.parametrize("moe_impl", ["gmm", "gather"])
def test_deepseek_fused_step_kernels_match_cpu(dev, moe_impl):
    """A narrow DeepSeek model at R 512, P 64 on the card (K5, and K3 with a
    group offset) against the same weights on the CPU (the plain versions):
    prefill and one-token logits of the fused runner, f32."""
    from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model, DeepseekV2Spec
    from moe_infinity_tpu_torch.runtime.fused import FusedRunner

    spec = DeepseekV2Spec(
        vocab_size=512, hidden_size=256, intermediate_size=512, moe_intermediate_size=192,
        num_layers=3, num_heads=16, q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, num_experts=8, top_k=2, n_shared_experts=2,
        first_k_dense_replace=1, topk_method="greedy", n_group=None, topk_group=None,
        routed_scaling_factor=1.0, rms_eps=1e-6, rope_theta=10000.0, tie_embeddings=False,
    )
    model = DeepseekV2Model(spec, torch.float32, device=dev)
    params, tree = model.init_random(_gen(dev))
    cpu_model = DeepseekV2Model(spec, torch.float32, device="cpu")
    to_cpu = lambda t: (  # noqa: E731
        {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict)
        else [to_cpu(v) for v in t] if isinstance(t, list) else t.cpu())
    tok = torch.randint(1, 512, (2, 9), generator=_gen(dev), device=dev, dtype=torch.int32)
    pos = torch.arange(9, dtype=torch.int32, device=dev).expand(2, 9)
    out = {}
    for name, m, p, t in (("card", model, params, tree),
                          ("cpu", cpu_model, to_cpu(params), to_cpu(tree))):
        runner = FusedRunner(m, p, m.stack_experts(t["layers"], layout="flat"), moe_impl=moe_impl)
        d = m.device
        kv = runner.init_cache(2, 32)
        before = dict(fa.LAUNCHES), dict(gm.LAUNCHES)
        l1, kv = runner.prefill(tok.to(d), pos.to(d), kv, 0)
        l2, kv = runner.prefill(tok[:, :1].to(d), torch.full((2, 1), 9, dtype=torch.int32, device=d),
                                kv, 9)
        out[name] = (l1.cpu(), l2.cpu())
        k5 = fa.LAUNCHES["mla_flash_decode"] - before[0]["mla_flash_decode"]
        k3 = gm.LAUNCHES["gmm"] - before[1]["gmm"]
        assert k5 == (3 if name == "card" else 0)
        assert k3 == (12 if name == "card" and moe_impl == "gmm" else 0)
    for a, b in zip(out["card"], out["cpu"]):
        _close(a, b, 2e-2 if moe_impl == "gmm" else 2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep", [1, 2, 4, 6, 7, 8])
def test_decode_body_split_edges(dev, dtype, rep):
    """The decode body where its split plan has edges, through K4 and, on the
    gathered rows, K1: a row of 0 live keys beside a long one, splits that lie
    wholly in holes, a live length that is no multiple of the tile."""
    g = _gen(dev)
    B, Hkv, Dh, page, P, NP = 3, 2, 128, 16, 64, 200
    S, H = P * page, Hkv * rep
    kc, ns = fa._decode_splits(B * Hkv, S)
    assert kc == 64 and ns == 16  # keys 128-383 cover four whole splits
    q = torch.randn(B, H, Dh, generator=g, device=dev).to(dtype)
    pk = torch.randn(NP, page, Hkv, Dh, generator=g, device=dev).to(dtype)
    pv = torch.randn(NP, page, Hkv, Dh, generator=g, device=dev).to(dtype)
    table = torch.randperm(NP, generator=g, device=dev)[:B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([0, 1000, 333], dtype=torch.int32, device=dev)
    mask = torch.rand(B, S, generator=g, device=dev) > 0.1
    mask[1, 128:384] = False
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    want = fa.paged_flash_decode_plain(q, pk, pv, table, lengths, scale=Dh ** -0.5, pad_mask=mask)
    before = dict(fa.LAUNCHES)
    got = fa.paged_flash_decode(q, pk, pv, table, lengths, pad_mask=mask)
    short = fa.paged_flash_decode(q, pk, pv, table, lengths, pad_mask=mask, max_len=1000)
    low = fa.paged_flash_decode(q, pk, pv, table, lengths, pad_mask=mask, max_len=200)
    idx = table.long()
    got1 = fa.flash_decode(q[:, None], pk[idx].reshape(B, S, Hkv, Dh),
                           pv[idx].reshape(B, S, Hkv, Dh), (lengths - 1)[:, None], S,
                           pad_mask=mask)[:, 0]
    assert fa.LAUNCHES["paged_flash_decode"] == before["paged_flash_decode"] + 3
    assert fa.LAUNCHES["flash_decode"] == before["flash_decode"] + 1
    for out in (got, short, low, got1):  # a bound that is too small costs time only
        _close(out, want, tol)
        assert bool((out[0] == 0).all())


def test_decode_body_never_reads_a_hole(dev):
    """NaN in masked keys and past a row's length never reaches the result."""
    g = _gen(dev)
    B, H, Hkv, Dh, S = 2, 8, 2, 128, 300
    q = torch.randn(B, 1, H, Dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(torch.bfloat16)
    mask = torch.rand(B, S, generator=g, device=dev) > 0.3
    pos = torch.tensor([[150], [299]], dtype=torch.int32, device=dev)
    want = fa.flash_decode_plain(q[:, 0], k, v, pos[:, 0], 280, scale=Dh ** -0.5, pad_mask=mask)
    k[~mask], v[~mask] = float("nan"), float("nan")
    k[0, 151:], v[0, 151:] = float("nan"), float("nan")
    k[1, 280:], v[1, 280:] = float("nan"), float("nan")
    got = fa.flash_decode(q, k, v, pos, 280, pad_mask=mask)[:, 0]
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want, 2e-2)
    got2 = fa.flash_attend(q.expand(B, 16, H, Dh).contiguous(), k, v,
                           pos.expand(B, 16).contiguous(), 280, pad_mask=mask)
    assert bool(torch.isfinite(got2.float()).all())  # the tensor-core kernel too
    _close(got2[:, 0], want, 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("bias", ["B11S", "1H1S", "11TS", "BHTS", None])
def test_flash_attend_few_rows_route(dev, dtype, T, bias):
    """K2 with at most 8 query rows per kv head (the decode body): every bias
    broadcast form, causal=False, a row with no valid key, one launch."""
    g = _gen(dev)
    B, Hkv, rep, Dh, S = 3, 2, 4, 128, 200
    H = Hkv * rep
    q = torch.randn(B, T, H, Dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    pos = (70 + torch.arange(T, dtype=torch.int32, device=dev)).expand(B, T).contiguous()
    shape = {"B11S": (B, 1, 1, S), "1H1S": (1, H, 1, S), "11TS": (1, 1, T, S),
             "BHTS": (B, H, T, S)}.get(bias)
    b = torch.randn(*shape, generator=g, device=dev) if shape else None
    mask = torch.rand(B, S, generator=g, device=dev) > 0.2
    mask[1] = False
    kw = dict(causal=bias is None, bias=b, pad_mask=mask)
    before = fa.LAUNCHES["flash_attend"]
    got = fa.flash_attend(q, k, v, pos, 150, **kw)
    assert fa.LAUNCHES["flash_attend"] == before + 1
    want = fa.flash_attend_plain(q, k, v, pos, 150, scale=Dh ** -0.5, **kw)
    _close(got, want, 2e-3 if dtype == torch.float32 else 2e-2)
    assert bool((got[1] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 16, 17, 64])
@pytest.mark.parametrize("S,kv_len,softcap", [(64, 64, None), (300, 266, None), (200, 200, 30.0)])
def test_flash_attend_gqa_rep4(dev, dtype, T, S, kv_len, softcap):
    """K2 at GQA rep 4 across its routes (the decode body at T = 1, the
    tensor-core kernel with one and with two key halves, the f32 kernel):
    causal with a hole mask, the queries ending at the last live column."""
    g = _gen(dev)
    B, Hkv, rep, Dh = 2, 2, 4, 128
    H = Hkv * rep
    q = torch.randn(B, T, H, Dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    pos = (kv_len - T + torch.arange(T, dtype=torch.int32, device=dev)).expand(B, T).contiguous()
    mask = torch.rand(B, S, generator=g, device=dev) > 0.15
    mask[:, max(kv_len - T, 0):kv_len] = True
    kw = dict(causal=True, logit_softcap=softcap, pad_mask=mask)
    got = fa.flash_attend(q, k, v, pos, kv_len, **kw)
    want = fa.flash_attend_plain(q, k, v, pos, kv_len, scale=Dh ** -0.5, **kw)
    _close(got, want, 2e-3 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 2, 16, 40])
@pytest.mark.parametrize("rep,softcap,scale", [(6, 30.0, 0.08838834764831845), (7, None, None)])
def test_flash_attend_gqa_rep6_rep7(dev, dtype, T, rep, softcap, scale):
    """K2 at Grok-1's rep 6 (softcap 30, scale 0.0884) and Arctic's rep 7:
    T = 1 takes the decode body (6 or 7 rows), T = 2 the tensor-core kernel
    with 12 or 14 rows, whose blocks of 4 units straddle query chunks;
    sharp scores (q and k x3) so that the softcap acts."""
    g = _gen(dev)
    B, Hkv, Dh, S, kv_len = 2, 8, 128, 300, 266
    H = Hkv * rep
    q = (torch.randn(B, T, H, Dh, generator=g, device=dev) * 3).to(dtype)
    k = (torch.randn(B, S, Hkv, Dh, generator=g, device=dev) * 3).to(dtype)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    pos = (kv_len - T + torch.arange(T, dtype=torch.int32, device=dev)).expand(B, T).contiguous()
    mask = torch.rand(B, S, generator=g, device=dev) > 0.15
    mask[:, kv_len - T:kv_len] = True
    kw = dict(causal=True, logit_softcap=softcap, pad_mask=mask)
    got = fa.flash_attend(q, k, v, pos, kv_len, scale=scale, **kw)
    want = fa.flash_attend_plain(q, k, v, pos, kv_len, scale=scale or Dh ** -0.5, **kw)
    _close(got, want, 2e-3 if dtype == torch.float32 else 2e-2)


# ---- head dim 64 (Switch's T5 attention) --------------------------------------


def _pad_rows(dev, B, S):
    """[B, 1, 1, S] f32 pad bias, finfo(f32).min past rows of S, 3S/4, S/2 and
    5 keys, as the Switch model's."""
    lens = torch.tensor([S, 3 * S // 4, S // 2, 5], device=dev)[torch.arange(B) % 4]
    keep = torch.arange(S, device=dev)[None, :] < lens[:, None]
    return torch.where(keep, 0.0, torch.finfo(torch.float32).min)[:, None, None, :]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["encoder16", "encoder64", "self", "cross"])
def test_flash_attend_dh64_switch_shapes(dev, dtype, form):
    """K2 at head dim 64 with Switch's biases, scale 1.0: the encoder's T5
    plus pad ``[B, H, T, T]`` (the tensor-core or f32 body), the decoder's
    T5 ``[1, H, 1, S]`` at one causal query and cross-attention's pad
    ``[B, 1, 1, S]`` (the decode body); counted under ``flash_attend_dh64``."""
    from moe_infinity_tpu_torch.models.layers import t5_position_bias

    g = _gen(dev)
    B, H, Dh = 8, 16, 64
    table = torch.randn(32, H, generator=g, device=dev) * 0.5
    T, S = (int(form[7:]),) * 2 if form.startswith("encoder") else (1, 128 if form == "self" else 16)
    q = torch.randn(B, T, H, Dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, H, Dh, generator=g, device=dev).to(dtype)
    cols = torch.arange(S, dtype=torch.int32, device=dev)
    if form == "self":
        pos = torch.full((B, 1), 64, dtype=torch.int32, device=dev)
        bias, causal = t5_position_bias(table, pos[0], cols, False), True
    else:
        pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T).contiguous()
        bias, causal = _pad_rows(dev, B, S), False
        if form != "cross":
            bias = t5_position_bias(table, pos[0], cols, True) + bias
    before = fa.LAUNCHES["flash_attend_dh64"]
    got = fa.flash_attend(q, k, v, pos, S, scale=1.0, causal=causal, bias=bias)
    assert fa.LAUNCHES["flash_attend_dh64"] == before + 1
    want = fa.flash_attend_plain(q, k, v, pos, S, scale=1.0, causal=causal, bias=bias)
    _close(got, want, 2e-3 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,rep,S,kv_len", [(16, 1, 64, 64), (17, 4, 300, 266), (64, 1, 200, 200),
                                            (9, 1, 40, 33)])
def test_flash_attend_dh64_tiles(dev, dtype, T, rep, S, kv_len):
    """K2 at head dim 64 past the decode body (T * rep > 8): one 64-key half
    and two, causal with holes, GQA, a softcap."""
    g = _gen(dev)
    B, Hkv, Dh = 3, 2, 64
    H = Hkv * rep
    q = torch.randn(B, T, H, Dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, Dh, generator=g, device=dev).to(dtype)
    pos = (kv_len - T + torch.arange(T, dtype=torch.int32, device=dev)).expand(B, T).contiguous()
    mask = torch.rand(B, S, generator=g, device=dev) > 0.2
    mask[:, kv_len - T:kv_len] = True
    kw = dict(causal=True, logit_softcap=30.0, pad_mask=mask)
    got = fa.flash_attend(q, k, v, pos, kv_len, **kw)
    want = fa.flash_attend_plain(q, k, v, pos, kv_len, scale=Dh ** -0.5, **kw)
    _close(got, want, 2e-3 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rep,S", [(1, 48), (4, 48), (2, 4000)])
def test_flash_decode_and_paged_dh64(dev, dtype, rep, S):
    """K1 and K4 at head dim 64 (4000 keys split the rows over blocks),
    holes and a row with no valid key; K4 over the same rows paged equals
    K1 on them gathered."""
    g = _gen(dev)
    B, Hkv, Dh, page = 3, 4, 64, 16
    H = Hkv * rep
    P = -(-S // page)
    S = P * page
    q = torch.randn(B, H, Dh, generator=g, device=dev).to(dtype)
    pk = torch.randn(B * P + 5, page, Hkv, Dh, generator=g, device=dev).to(dtype)
    pv = torch.randn(B * P + 5, page, Hkv, Dh, generator=g, device=dev).to(dtype)
    table = torch.randperm(B * P + 5, generator=g, device=dev)[:B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([S, S // 3, 7], dtype=torch.int32, device=dev)
    holes = torch.rand(B, S, generator=g, device=dev) > 0.2
    holes[2] = False
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    got = fa.paged_flash_decode(q, pk, pv, table, lengths, pad_mask=holes)
    _close(got, fa.paged_flash_decode_plain(q, pk, pv, table, lengths, scale=Dh ** -0.5,
                                            pad_mask=holes), tol)
    idx = table.long()
    k, v = pk[idx].reshape(B, S, Hkv, Dh), pv[idx].reshape(B, S, Hkv, Dh)
    before = fa.LAUNCHES["flash_decode_dh64"]
    got1 = fa.flash_decode(q[:, None], k, v, (lengths - 1)[:, None], S, pad_mask=holes)[:, 0]
    assert fa.LAUNCHES["flash_decode_dh64"] == before + 1
    _close(got1, got, tol)
    assert bool((got[2] == 0).all() and (got1[2] == 0).all())


def test_head_dims_other_than_64_and_128_raise(dev):
    """Head dims 32 and 96 run on the padded instance of width 128 and hold
    against the plain version (K2's few-row route, a per-head bias); a head
    dim above 256 raises."""
    g = _gen(dev)
    for Dh in (32, 96):
        q, k, v = (torch.randn(2, n, 4, Dh, generator=g, device=dev) for n in (1, 8, 8))
        pos = torch.zeros(2, 1, dtype=torch.int32, device=dev)
        bias = torch.randn(1, 4, 1, 8, generator=g, device=dev)
        before = fa.LAUNCHES["flash_attend_pad128"]
        got = fa.flash_attend(q, k, v, pos, 8, causal=False, bias=bias)
        assert fa.LAUNCHES["flash_attend_pad128"] == before + 1
        _close(got, fa.flash_attend_plain(q, k, v, pos, 8, scale=Dh ** -0.5, causal=False,
                                          bias=bias), 2e-3)
    q = torch.zeros(2, 1, 4, 320, device=dev)
    with pytest.raises(ValueError, match="head_dim 1 to 256"):
        fa.flash_attend(q, q, q, torch.zeros(2, 1, dtype=torch.int32, device=dev), 1,
                        bias=torch.zeros(1, 4, 1, 1, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [80, 33, 200, 256, 128])
@pytest.mark.parametrize("rep", [1, 16])
def test_padded_head_dims_and_rep16(dev, dtype, Dh, rep):
    """K4, K1 and K2 (both routes) at OPT-2.7B's head dim 80, an odd one
    (33: rows of no multiple of 16 bytes), two above 128 (the width-256
    instance) and 128, at rep 1 and 16 (two blocks of 8 rows a kv head):
    rows of 100, 0 and 77 live keys with holes over two splits, against the
    plain versions, each launch counted under its instance's name."""
    g = _gen(dev)
    B, Hkv, page, P, NP = 3, 2, 16, 8, 40
    S, H = P * page, Hkv * rep
    sfx = fa._instance(Dh)[2]
    assert fa._decode_splits(B * Hkv * fa._row_groups(rep), S)[1] == 2  # the merge runs
    q = torch.randn(B, H, Dh, generator=g, device=dev).to(dtype)
    pk = torch.randn(NP, page, Hkv, Dh, generator=g, device=dev).to(dtype)
    pv = torch.randn(NP, page, Hkv, Dh, generator=g, device=dev).to(dtype)
    table = torch.randperm(NP, generator=g, device=dev)[:B * P].reshape(B, P).to(torch.int32)
    lengths = torch.tensor([100, 0, 77], dtype=torch.int32, device=dev)
    holes = torch.rand(B, S, generator=g, device=dev) > 0.2
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    before = dict(fa.LAUNCHES)
    got = fa.paged_flash_decode(q, pk, pv, table, lengths, pad_mask=holes)
    _close(got, fa.paged_flash_decode_plain(q, pk, pv, table, lengths, scale=Dh ** -0.5,
                                            pad_mask=holes), tol)
    assert bool((got[1] == 0).all())
    idx = table.long()
    k, v = pk[idx].reshape(B, S, Hkv, Dh), pv[idx].reshape(B, S, Hkv, Dh)
    got1 = fa.flash_decode(q[:, None], k, v, (lengths - 1)[:, None], S, pad_mask=holes)[:, 0]
    _close(got1, got, tol)
    T = 20
    qq = torch.randn(B, T, H, Dh, generator=g, device=dev).to(dtype)
    pos = (60 + torch.arange(T, dtype=torch.int32, device=dev)).expand(B, T).contiguous()
    kw = dict(causal=True, pad_mask=holes)
    _close(fa.flash_attend(qq, k, v, pos, 90, **kw),
           fa.flash_attend_plain(qq, k, v, pos, 90, scale=Dh ** -0.5, **kw), tol)
    bias = torch.randn(B, 1, 1, S, generator=g, device=dev)
    kw = dict(causal=False, bias=bias, pad_mask=holes)
    q1, pos1 = qq[:, :1].contiguous(), pos[:, :1].contiguous()
    _close(fa.flash_attend(q1, k, v, pos1, S, **kw),
           fa.flash_attend_plain(q1, k, v, pos1, S, scale=Dh ** -0.5, **kw), tol)
    for name in ("paged_flash_decode", "flash_decode"):
        assert fa.LAUNCHES[name + sfx] == before[name + sfx] + 1
    assert fa.LAUNCHES["flash_attend" + sfx] == before["flash_attend" + sfx] + 2


# ---- stream_gather (csrc/stream.cu) -----------------------------------------

def _stream_source(dev, n_rec, seg_rows, promote=(), shapes=((64, 256), (512,), (256, 32))):
    """A StreamSource over page-locked segments of int8/f32 records (the
    segments in ``promote`` on the card), and the records stacked on the
    host."""
    from moe_infinity_tpu_torch.ops.stream import StreamSource

    g = torch.Generator().manual_seed(n_rec)
    fields, stacks = {}, {}
    for i, shape in enumerate(shapes):
        if len(shape) == 2:
            full = torch.randint(-128, 128, (n_rec,) + shape, dtype=torch.int8, generator=g)
        else:
            full = torch.randn((n_rec,) + shape, generator=g)
        segs = []
        for s, lo in enumerate(range(0, n_rec, seg_rows)):
            seg = full[lo:lo + seg_rows].clone().pin_memory()
            segs.append(seg.to(dev) if s in promote else seg)
        fields[f"role{i}"], stacks[f"role{i}"] = segs, full
    return StreamSource(fields, rec_row=None, seg_rows=seg_rows), stacks


@pytest.mark.parametrize("U,promote", [(8, ()), (64, ()), (13, (1,))])
def test_stream_gather_kernel(dev, U, promote):
    """The gather kernel against its plain version and the host's indexing:
    records across segments (the last one shorter), rows of -1 reading
    nothing (zeros), a promoted (device) segment among pinned ones; launches
    counted."""
    from moe_infinity_tpu_torch.ops import stream as st

    n_rec, seg_rows = 100, 30
    source, stacks = _stream_source(dev, n_rec, seg_rows, promote)
    g = torch.Generator().manual_seed(U)
    rows = torch.randint(0, n_rec, (U,), generator=g, dtype=torch.int32)
    rows[::5] = -1
    before = st.LAUNCHES["stream_gather"]
    got = st.stream_gather(source, rows.to(dev))
    torch.cuda.synchronize()
    assert st.LAUNCHES["stream_gather"] == before + 1
    plain = st.stream_gather_plain(source.fields, seg_rows, rows)
    for role, full in stacks.items():
        want = full[rows.clamp(min=0).long()]
        want[rows < 0] = 0
        assert torch.equal(got[role].cpu(), want), role
        assert torch.equal(plain[role], want), role


def test_stream_gather_refuses_pageable_segments(dev):
    from moe_infinity_tpu_torch.ops.stream import StreamSource, stream_gather

    src = StreamSource({"w": [torch.zeros(4, 64, dtype=torch.int8)]}, rec_row=None, seg_rows=4)
    with pytest.raises(ValueError, match="not readable by the card"):
        stream_gather(src, torch.zeros(2, dtype=torch.int32, device=dev))
