"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: they skip without a CUDA device. On a machine with
one, run them with ``python3 -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernels.py`` (``--noconftest``: the repo conftest imports
jax, which that machine need not have).
Tolerance 2e-2 (rtol and atol) for bf16 operands, as the JAX suite's gmm
tests, and 2e-3 for f32 attention (summation order only)."""

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
    (2, True, None, False),
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


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_gmm_kernel(dev, kind):
    g = _gen(dev)
    S, D, F, T = 6, 384, 512, 40
    sizes = torch.tensor([9, 0, 14, 1, 0, 16], dtype=torch.int32, device=dev)
    x = torch.randn(T, D, generator=g, device=dev)
    scale = None
    if kind == "bf16":
        w = (torch.randn(S, D, F, generator=g, device=dev) * 0.05).to(torch.bfloat16)
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
    """A group routing many rows spreads over many blocks (8-row chunks)."""
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
