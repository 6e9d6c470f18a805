"""K5 (the port's absorbed-MLA decode) as far as the CPU can see the kernel:
the split planner, the wrapper's launch arguments, and a plain-PyTorch
emulation of the kernel's arithmetic held against ``mla_flash_decode_plain``
and against the JAX ``mla_flash_decode`` in interpret mode on the same numpy
inputs.

The emulation follows the bf16 kernel: 64-key tiles zero-filled where a key
is not valid; q and p split into bf16 halves hi = bf16(x), lo = bf16(x - hi)
with each product taken as hi.k + lo.k; the score product in four parts of
the 576 columns summed in f32; an online softmax per tile; each tile's p.c
in a fresh sum added as acc * alpha + tile; the splits padded to clusters
of up to 8, each cluster's (m, l, acc) merged in split order, then the
clusters holding a live split in cluster order.

Tolerance 2e-5 (rtol = atol): the halves keep about 16 significant bits of
q and p (a relative error of 2^-17 = 7.6e-6 each), which the softmax and the
sums carry to about 1e-5 of the result; the f32 summation order differs
besides. A single bf16 product (hi alone) misses that tolerance by far,
which the last emulation test shows."""

import ctypes
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.ops import flash_attention as jfa
from moe_infinity_tpu_torch.ops import _build
from moe_infinity_tpu_torch.ops import flash_attention as fa

from torch_port_helpers import one_intra_op_thread

TOL = 2e-5
R, P = fa._MLA_R, fa._MLA_P
TILE = fa._MLA_TILE
NEG = -1e30


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _halves(x, lo=True):
    hi = _bf16(x)
    return hi, (_bf16(x - hi) if lo else torch.zeros_like(x))


def _emulate(q_lat, q_pe, c, kpe, pos, kv_len, scale, mask=None, *, plan=None, lo=True):
    """K5's bf16 kernel at f32 on the CPU: returns [B, H, R]. ``plan`` (keys
    per split, splits) overrides the wrapper's; ``lo=False`` drops the low
    halves of q and p (a single bf16 product)."""
    B, H, _ = q_lat.shape
    S = c.shape[1]
    kc, ns = plan or fa._mla_splits(B, H, max(0, min(kv_len, S)))
    assert kc % TILE == 0 and ns * kc >= min(kv_len, S)
    cl = fa._mla_cluster(ns)
    ns = -(-ns // cl) * cl
    tile, parts_k = 64, 4  # the kernel's key tile; parts of a key's score product
    qh, ql = _halves(torch.cat([q_lat, q_pe], -1).float(), lo)
    keys = torch.cat([c, kpe], -1).float()
    cols = [slice(i * (R + P) // parts_k, (i + 1) * (R + P) // parts_k) for i in range(parts_k)]
    out = torch.zeros(B, H, R)
    for b in range(B):
        row_len = max(0, min(kv_len, S, int(pos[b]) + 1))
        live = min(ns, max(1, -(-row_len // kc)))
        parts = []
        for split in range(ns):
            k0, k1 = split * kc, min(split * kc + kc, row_len)
            m, l, acc = torch.full((H,), NEG), torch.zeros(H), torch.zeros(H, R)
            for t0 in range(k0, k1, tile):
                idx = torch.arange(t0, t0 + tile)
                valid = idx < k1
                if mask is not None:
                    valid &= mask[b, idx.clamp(max=S - 1)]
                kt = torch.where(valid[:, None], keys[b, idx.clamp(max=S - 1)], 0.0)
                s = sum(qh[b, :, sl] @ kt[:, sl].T + ql[b, :, sl] @ kt[:, sl].T
                        for sl in cols)
                s = torch.where(valid, s * scale, NEG)
                mn = torch.maximum(m, s.amax(1))
                alpha = torch.exp(m - mn)
                p = torch.where(valid, torch.exp(s - mn[:, None]), 0.0)
                l, m = l * alpha + p.sum(1), mn
                ph, pl = _halves(p, lo)
                acc = acc * alpha[:, None] + (ph @ kt[:, :R] + pl @ kt[:, :R])
            parts.append((m, l, acc))
        # each cluster of cl splits, then the clusters holding a live split
        clusters = [_combine(parts[i:i + cl]) for i in range(0, ns, cl)]
        M, L, A = clusters[0] if ns == cl else _combine(clusters[:-(-live // cl)])
        out[b] = torch.where(L[:, None] > 0, A / torch.where(L > 0, L, 1.0)[:, None], 0.0)
    return out


def _combine(parts):
    """(m, l, acc) states combined in order, as the kernel's merge does."""
    M = torch.stack([p[0] for p in parts]).amax(0)
    L, A = torch.zeros_like(M), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L, A = L + l * w, A + acc * w[:, None]
    return M, L, A


def _inputs(rng, B, H, S, lengths, holes=0.1):
    a = dict(
        q_lat=rng.normal(size=(B, H, R)).astype(np.float32),
        q_pe=rng.normal(size=(B, H, P)).astype(np.float32),
        c=rng.normal(size=(B, S, R)).astype(np.float32),
        kpe=rng.normal(size=(B, S, P)).astype(np.float32),
        pos=np.array(lengths, np.int32) - 1,
        mask=rng.random((B, S)) > holes if holes else None,
    )
    t = {k: None if v is None else torch.tensor(v) for k, v in a.items()}
    t["c"], t["kpe"] = _bf16(t["c"]), _bf16(t["kpe"])  # the cache holds bf16 values
    return a, t


def _plain(t, kv_len, scale, mask="mask"):
    return fa.mla_flash_decode_plain(t["q_lat"], t["q_pe"], t["c"].bfloat16(),
                                     t["kpe"].bfloat16(), t["pos"], kv_len, scale=scale,
                                     pad_mask=t[mask] if mask else None)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


# ---- the emulation against the plain version and the JAX kernel -------------------

@pytest.mark.parametrize("H", [16, 5, 128])
@pytest.mark.parametrize("holes", [0.1, 0.0])
def test_emulation_matches_plain(rng, H, holes):
    """Rows of 113, 200 (its splits past key 128 are live), 37 and 0 keys
    (one row with no valid key at all), lengths that are no multiple of the
    tile, S=256: at H 16 the plan has two splits of 128 keys a row."""
    S = 256
    a, t = _inputs(rng, 4, H, S, [113, 200, 37, 0], holes)
    scale = 192 ** -0.5
    got = _emulate(t["q_lat"], t["q_pe"], t["c"], t["kpe"], t["pos"], S, scale, t["mask"])
    assert torch.all(got[3] == 0)
    _close(got, _plain(t, S, scale, "mask" if holes else None))


@pytest.mark.parametrize("plan", [(32, 8), (64, 4), (96, 3), (256, 1), (32, 12), (32, 24)])
def test_emulation_matches_plain_under_any_plan(rng, plan):
    """Splits of one to eight tiles; (96, 3): a cluster of 4 with a padded
    split; (32, 12) and (32, 24): two and three clusters, splits and a whole
    cluster past every row's live keys (S = 256, rows of at most 200)."""
    S = 256
    a, t = _inputs(rng, 3, 16, S, [200, 65, 31])
    t["mask"][1, 32:64] = False  # a whole split of row 1 in holes
    got = _emulate(t["q_lat"], t["q_pe"], t["c"], t["kpe"], t["pos"], S, 0.07, t["mask"],
                   plan=plan)
    _close(got, _plain(t, S, 0.07))


@pytest.mark.parametrize("H", [16, 128])
def test_capacity_plan_adds_nothing_past_the_live_keys(rng, H):
    """A step of ``decode_scan`` hands K5 the cache's capacity (256 here)
    while its rows hold 20, 5, 1 and 0 keys: the plan from the capacity has
    splits wholly past every row's live keys, which join the merge as
    empty states. They add nothing (no NaN from an all-masked split), so
    the result equals the live-length plan's (one split) and the plain
    version's."""
    S = 256
    a, t = _inputs(rng, 4, H, S, [20, 5, 1, 0])
    args = (t["q_lat"], t["q_pe"], t["c"], t["kpe"], t["pos"])
    capacity = _emulate(*args, S, 0.07, t["mask"])
    live = _emulate(*args, 20, 0.07, t["mask"])
    kc, ns = fa._mla_splits(4, H, S)
    assert ns * kc == S and kc < S and fa._mla_splits(4, H, 20)[1] == 1
    assert torch.isfinite(capacity).all() and torch.all(capacity[3] == 0)
    _close(capacity, live)
    _close(capacity, _plain(t, S, 0.07))


@pytest.mark.parametrize("H", [16, 5])
def test_emulation_matches_pallas_interpret(rng, H):
    """The JAX kernel in interpret mode on the same numpy inputs (bf16
    caches), at the kernel's widths R 512 and P 64, S 64, rows past kv_len."""
    S = 64
    a, t = _inputs(rng, 2, H, S, [40, 64])
    scale = 0.05
    want = jfa.mla_flash_decode(
        jnp.asarray(a["q_lat"]), jnp.asarray(a["q_pe"]), jnp.asarray(a["c"], jnp.bfloat16),
        jnp.asarray(a["kpe"], jnp.bfloat16), jnp.asarray(a["pos"]), jnp.int32(50),
        scale=scale, pad_mask=jnp.asarray(a["mask"]), interpret=True)
    assert want is not None  # the TPU wrapper took the shape
    got = _emulate(t["q_lat"], t["q_pe"], t["c"], t["kpe"], t["pos"], 50, scale, t["mask"])
    _close(got, np.asarray(want))


def test_a_single_bf16_product_misses_the_tolerance(rng):
    """Without the low halves (q and p rounded to bf16) the emulation is off
    by far more than TOL: the halves are what keeps f32 precision."""
    S = 256
    a, t = _inputs(rng, 2, 16, S, [200, 256])
    want = _plain(t, S, 192 ** -0.5)
    full = _emulate(t["q_lat"], t["q_pe"], t["c"], t["kpe"], t["pos"], S, 192 ** -0.5, t["mask"])
    hi = _emulate(t["q_lat"], t["q_pe"], t["c"], t["kpe"], t["pos"], S, 192 ** -0.5, t["mask"],
                  lo=False)
    err_full = (full - want).abs().max().item()
    err_hi = (hi - want).abs().max().item()
    assert err_full < TOL and err_hi > 10 * TOL


# ---- the planner -----------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 4, 16])
@pytest.mark.parametrize("H", [5, 16, 128])
@pytest.mark.parametrize("live_max", [0, 1, 31, 32, 33, 113, 512, 1000, 8192, 163840])
@pytest.mark.parametrize("min_tiles", [1, 2])
def test_every_plan_covers_each_live_key_once(B, H, live_max, min_tiles, monkeypatch):
    """Splits of whole tiles; for every row length up to ``live_max`` the
    live splits (split 0 always; then those starting below the row's
    length) padded to whole clusters cover its keys exactly once, and the
    kernel's 64-key tiles of a split too."""
    monkeypatch.setattr(fa, "_MLA_MIN_TILES", min_tiles)
    kc, ns = fa._mla_splits(B, H, live_max)
    assert kc % TILE == 0 and ns >= 1 and ns * kc >= live_max
    assert ns == 1 or (ns - 1) * kc < live_max  # no planned split lies past live_max
    cl = fa._mla_cluster(ns)
    ns = -(-ns // cl) * cl
    for row_len in sorted({0, 1, live_max // 3, max(0, live_max - 1), live_max}):
        seen = np.zeros(row_len, np.int32)
        for split in range(ns):  # a split past the row's keys owns none
            k0, k1 = split * kc, min(split * kc + kc, row_len)
            for t0 in range(k0, k1, 64):
                seen[t0:min(t0 + 64, k1)] += 1
        assert np.all(seen == 1)


def test_a_split_reads_a_few_tiles_and_the_blocks_stay_near_the_target():
    """Partials (32 KB a head tile) stay small beside the keys a split reads;
    long rows spread over about _MLA_BLOCKS blocks."""
    for B, H, live in ((4, 16, 512), (4, 128, 512), (4, 16, 8192), (1, 16, 8192)):
        kc, ns = fa._mla_splits(B, H, live)
        assert kc >= fa._MLA_MIN_TILES * TILE
        groups = -(-H // 16)
        assert B * groups * ns <= max(fa._MLA_BLOCKS, B * groups * -(-live // kc))


def test_the_planner_takes_integers_only():
    assert list(inspect.signature(fa._mla_splits).parameters) == ["B", "H", "live_max"]


# ---- the wrapper's launch, with the kernel replaced --------------------------------

_NAMES = ["q_lat", "q_pe", "c", "kpe", "qpos", "mask", "part_acc", "part_ml", "tickets", "out",
          "B", "H", "S", "R", "P", "kv_len", "kc", "NS", "CL", "scale", "is_bf16", "stream"]


@pytest.fixture
def fake_kernel(monkeypatch):
    """_mla_cuda on CPU tensors with the C entry point replaced by a recorder,
    the workspace and tickets by tensors of their own, and every host read
    of a tensor's value made to raise."""
    calls, given = [], {}

    def function(stem, name, argtypes):
        assert (stem, name) == ("flash_attention", "mit_mla_flash_decode")
        assert len(argtypes) == len(_NAMES)
        return lambda *args: calls.append(dict(zip(_NAMES, args))) or 0

    def workspace(dev, n):
        given["workspace"] = torch.empty(n)
        return given["workspace"]

    def tickets(dev, n):
        given["tickets"] = torch.zeros(n, dtype=torch.int32)
        return given["tickets"]

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "workspace", workspace)
    monkeypatch.setattr(_build, "tickets", tickets)

    def host_read(*a, **k):
        raise AssertionError("the CUDA path read a tensor's value on the host")

    for attr in ("item", "tolist", "numpy", "__bool__", "__int__", "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, attr, host_read)
    return calls, given


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,S,kv_len", [
    (4, 16, 512, 512),  # V2-Lite's batcher step: one cluster a row, no scratch
    (4, 128, 512, 512),  # V2/V3 heads: 8 head groups
    (1, 16, 64, 41),  # one split
    (4, 16, 8192, 8192),  # long rows: clusters of 8, merged through scratch
])
def test_one_call_is_one_launch_without_a_host_read(fake_kernel, dtype, B, H, S, kv_len):
    calls, given = fake_kernel
    z = torch.zeros
    before = fa.LAUNCHES["mla_flash_decode"]
    out = fa._mla_cuda(z(B, H, R), z(B, H, P), z(B, S, R, dtype=dtype), z(B, S, P, dtype=dtype),
                       z(B, dtype=torch.int32), kv_len, scale=1.0,
                       pad_mask=torch.ones(B, S, dtype=torch.bool))
    assert fa.LAUNCHES["mla_flash_decode"] == before + 1
    fa.LAUNCHES["mla_flash_decode"] = before  # nothing was launched
    assert out.shape == (B, H, R) and out.dtype == torch.float32
    (call,) = calls
    kc, ns = fa._mla_splits(B, H, min(kv_len, S))
    cl = fa._mla_cluster(ns)
    ns = -(-ns // cl) * cl
    assert (call["kc"], call["NS"], call["CL"]) == (kc, ns, cl)
    assert cl in (1, 2, 4, 8) and ns % cl == 0
    assert call["is_bf16"] == int(dtype == torch.bfloat16) and call["out"].value == out.data_ptr()
    if ns == cl:
        assert not given and call["part_acc"].value is None and call["tickets"].value is None
        return
    ws = given["workspace"]
    n_acc = B * (ns // cl) * H * R
    assert ws.numel() == n_acc + B * ns * H * 2
    assert call["part_acc"].value == ws.data_ptr()
    assert call["part_ml"].value == ws.data_ptr() + 4 * n_acc
    assert given["tickets"].numel() == B * -(-H // 16) * cl
    assert call["tickets"].value == given["tickets"].data_ptr()


def test_a_device_kv_len_plans_from_the_capacity(fake_kernel, monkeypatch):
    """``mla_flash_decode`` given its ``kv_len`` as a 0-d tensor (a step of
    ``decode_scan``) reads it nowhere on the host (the fixture makes every
    host read raise) and launches the capacity's plan with ``kv_len = S``;
    the plain version then equals the live-length call."""
    calls, _ = fake_kernel
    monkeypatch.setattr(fa, "mla_flash_decode_plain", fa._mla_cuda)  # the CPU call launches
    B, H, S = 4, 16, 256
    z = torch.zeros
    before = fa.LAUNCHES["mla_flash_decode"]
    fa.mla_flash_decode(z(B, H, R), z(B, H, P), z(B, S, R, dtype=torch.bfloat16),
                        z(B, S, P, dtype=torch.bfloat16), z(B, dtype=torch.int32),
                        torch.tensor(21, dtype=torch.int32), scale=1.0)
    fa.LAUNCHES["mla_flash_decode"] = before
    (call,) = calls
    kc, ns = fa._mla_splits(B, H, S)
    assert (call["kv_len"], call["kc"], call["NS"]) == (S, kc, ns)


def test_a_device_kv_len_gives_the_live_result(rng):
    a, t = _inputs(rng, 2, 16, 64, [21, 9])
    got = fa.mla_flash_decode(t["q_lat"], t["q_pe"], t["c"], t["kpe"], t["pos"],
                              torch.tensor(21, dtype=torch.int32), scale=0.07,
                              pad_mask=t["mask"])
    torch.testing.assert_close(got, _plain(t, 21, 0.07), rtol=0, atol=0)
