"""K3 (the port's grouped matmul) as far as the CPU can see the kernel: the
split planner, the wrapper's launch arguments, and a plain-PyTorch emulation
of the kernel's algorithm (64-row chunks of one group, m16 row tiles,
128-column tiles, 64-deep k-tiles with zero-filled tails, per-split f32
partials summed in split order, the scale after the sum) held against
``gmm_plain``, which the parity tests hold against the JAX kernel, for
bf16, int8, packed int4 and float8_e4m3fn weights.
Tolerance 1e-5 at f32: the two differ in summation order only. The
emulation rounds its sums to nearest; the tensor cores round each step's
sum toward zero, which ``chip_smoke.py``'s ``[rounding]`` lines measure."""

import ctypes
import inspect

import numpy as np
import pytest
import torch

from moe_infinity_tpu_torch.ops import _build
from moe_infinity_tpu_torch.ops import gmm as gm
from moe_infinity_tpu_torch.ops.moe import unpack_int4

from torch_port_helpers import one_intra_op_thread

TOL = 1e-5
KT, BN, BM = gm._K_TILE, gm._TILE_COLS, gm._ROWS_PER_CHUNK


# ---- the planner ---------------------------------------------------------------

@pytest.mark.parametrize("T,G,D,Fw,splits", [
    (8, 8, 8192, 1024, 5),  # NLLB decode down: 8 column tiles x 8 chunks
    (8, 8, 2048, 4096, 2),  # NLLB decode gate
    (24, 24, 2048, 1408, 1),  # V2-Lite bf16 gate and up, groups compacted
    (24, 64, 2048, 1408, 1),  # ... and uncompacted, as the fused runner passes them
    (24, 24, 1408, 2048, 1),  # V2-Lite bf16 down
    (24, 24, 2048, 704, 2),  # V2-Lite packed int4 gate: 5.5 column tiles
    (24, 24, 1408, 1024, 2),  # V2-Lite packed int4 down
    (8, 8, 4096, 14336, 1),  # Mixtral decode gate: 112 tiles x 8 chunks fill the card
    (8, 8, 14336, 4096, 2),  # Mixtral decode down
    (128, 8, 4096, 14336, 1),  # Mixtral W=16 chunk step
    (512, 128, 2048, 4096, 1),  # NLLB prefill gate
    (512, 128, 8192, 1024, 1),  # NLLB prefill down
    (3, 2, 256, 256, 1),  # too shallow to split
    (2, 2, 6144, 32768, 1),  # Grok-1's batch-1 gate: 256 column tiles
    (2, 2, 32768, 6144, 3),  # Grok-1's down: 512 k-tiles
    (2, 2, 7168, 4864, 4),  # Arctic's gate: 38 column tiles
    (2, 2, 4864, 7168, 3),  # Arctic's down
])
def test_split_choice(T, G, D, Fw, splits):
    plan = gm._gmm_plan(T, G, D, Fw)
    assert plan.splits == splits
    assert plan.tiles == -(-Fw // BN)
    assert plan.chunks == -(-T // BM) + G


@pytest.mark.parametrize("D", [8, 64, 328, 1408, 2048, 4096, 8192, 14336])
@pytest.mark.parametrize("T,G,Fw", [(1, 1, 256), (8, 8, 1024), (24, 64, 704), (512, 128, 4096)])
def test_splits_are_whole_k_tiles_covering_each_once(D, T, G, Fw):
    plan = gm._gmm_plan(T, G, D, Fw)
    nk = -(-D // KT)
    covered = np.zeros(nk, int)
    for z in range(plan.splits):
        lo, hi = z * plan.ktiles, min(nk, (z + 1) * plan.ktiles)
        assert lo < hi  # no split is empty: each one draws its ticket
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # the kernel's own reading of the plan: ceil(nk / splits) k-tiles each
    assert plan.ktiles == -(-nk // plan.splits)
    if plan.splits > 1:
        assert plan.ktiles >= gm._GMM_MIN_KTILES


@pytest.mark.parametrize("T,G,D,Fw", [
    (8, 8, 8192, 1024), (8, 8, 2048, 4096), (24, 24, 2048, 704), (1, 1, 65536, 128),
    (8, 8, 14336, 4096), (24, 24, 1408, 1024),
])
def test_a_short_grid_is_split_to_a_few_blocks_per_sm(T, G, D, Fw):
    plan = gm._gmm_plan(T, G, D, Fw)
    busy = plan.tiles * min(G, T)
    assert plan.splits > 1
    # enough blocks, or as many splits as the depth allows; no more than needed
    assert busy * plan.splits >= gm._GMM_BLOCKS or plan.ktiles < 2 * gm._GMM_MIN_KTILES
    assert busy * (plan.splits - 1) < gm._GMM_BLOCKS


@pytest.mark.parametrize("T,G,D,Fw", [(8, 8, 4096, 14336), (512, 128, 8192, 1024), (80, 80, 8192, 1024)])
def test_a_full_grid_takes_one_split(T, G, D, Fw):
    plan = gm._gmm_plan(T, G, D, Fw)
    assert plan.tiles * min(G, T) >= gm._GMM_BLOCKS
    assert plan.splits == 1 and plan.ktiles == -(-D // KT)


def test_the_planner_takes_integers_only():
    assert list(inspect.signature(gm._gmm_plan).parameters) == ["T", "G", "D", "Fw"]


# ---- the wrapper's launch, with the kernel replaced ------------------------------

_NAMES = ["x", "w", "scale", "sizes", "gids", "part", "tickets", "goff", "G", "max_chunks",
          "rows_per_chunk", "T", "D", "Fw", "F", "kind", "splits", "tf", "out", "stream"]


@pytest.fixture
def fake_kernel(monkeypatch):
    """_gmm_cuda on CPU tensors with the C entry point replaced by a recorder
    and every host read of a tensor's value made to raise."""
    calls = []

    def function(stem, name, argtypes):
        assert (stem, name) == ("gmm", "mit_gmm") and len(argtypes) == len(_NAMES)
        return lambda *args: calls.append(dict(zip(_NAMES, args))) or 0

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "tickets", lambda dev, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(_build, "workspace", lambda dev, n: torch.empty(n))

    def host_read(*a, **k):
        raise AssertionError("the CUDA path read a tensor's value on the host")

    for attr in ("item", "tolist", "numpy", "__bool__", "__int__", "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, attr, host_read)
    return calls


@pytest.mark.parametrize("kind,T,G,D,Fw,splits", [
    ("int4", 8, 8, 8192, 1024, 5),  # NLLB decode down: split, workspace and tickets
    ("int8", 8, 8, 4096, 14336, 1),  # Mixtral decode gate: one split, no workspace
    ("bf16", 24, 24, 1408, 1024, 2),
    ("bf16", 24, 64, 2048, 1408, 1),  # uncompacted groups
    ("fp8", 2, 2, 1024, 4096, 4),  # e4m3: its own kind, counted under gmm_fp8
    ("fp8", 16, 8, 512, 2048, 2),
])
def test_one_call_is_one_launch_without_a_host_read(fake_kernel, kind, T, G, D, Fw, splits):
    dt = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}.get(kind, torch.int8)
    w = torch.zeros(G, D, Fw, dtype=dt)
    F = 2 * Fw if kind == "int4" else Fw
    scale = None if kind == "bf16" else torch.ones(G, F)
    sizes = torch.zeros(G, dtype=torch.int32)
    ids = torch.arange(G, dtype=torch.int32)
    name = "gmm_fp8" if kind == "fp8" else "gmm"
    before = dict(gm.LAUNCHES)
    out = gm._gmm_cuda(torch.zeros(T, D), w, sizes, scale, 0, ids, packed=kind == "int4")
    assert gm.LAUNCHES[name] == before[name] + 1  # the e4m3 kind counts under its name
    gm.LAUNCHES.update(before)  # nothing was launched
    assert out.shape == (T, F) and out.dtype == torch.float32
    (call,) = fake_kernel
    assert call["splits"] == splits and call["T"] == T and call["F"] == F
    assert call["Fw"] == call["tf"] == Fw  # flat: one slab as wide as the row
    assert call["rows_per_chunk"] == BM and call["max_chunks"] == -(-T // BM) + G
    assert call["kind"] == {"bf16": 0, "int8": 1, "int4": 2, "fp8": 3}[kind]
    assert (call["part"].value is None) == (splits == 1)
    assert (call["tickets"].value is None) == (splits == 1)


# ---- the kernel's algorithm in plain PyTorch -----------------------------------

def _slot(w, gw):
    """Slot gw's stored [D, Fw] read element by element through the kernel's
    addressing, ((gw nf + c / tf) D + d) tf + c % tf: tf = Fw for a flat
    [S, D, Fw] weight, the slab width for a tiled [S, Fw / tf, D, tf] one."""
    nf, D, tf = w.shape[1:] if w.dim() == 4 else (1, *w.shape[1:])
    flat = w.reshape(-1)
    bits = flat.view(torch.uint8) if w.dtype == torch.float8_e4m3fn else flat
    d, c = torch.arange(D)[:, None], torch.arange(nf * tf)[None, :]
    got = bits[((gw * nf + c // tf) * D + d) * tf + c % tf]
    return got.view(w.dtype) if w.dtype == torch.float8_e4m3fn else got


def _emulate(x, w, sizes, scale=None, offset=0, ids=None, *, packed=False, splits=None):
    """K3's algorithm at f32: returns [T, F]. ``splits`` overrides the plan's."""
    T, D = x.shape
    Fw = w.shape[1] * w.shape[3] if w.dim() == 4 else w.shape[2]
    G = len(sizes)
    plan = gm._gmm_plan(T, G, D, Fw)
    nk = -(-D // KT)
    splits = splits or plan.splits
    kps = -(-nk // splits)
    assert (splits - 1) * kps < nk
    ids = list(range(G)) if ids is None else ids
    xb = x.to(torch.bfloat16).float()
    out = torch.zeros(T, 2 * Fw if packed else Fw)
    start = 0
    for g, n in enumerate(sizes):
        gw = ids[g] + offset
        wg = unpack_int4(_slot(w, gw)).float() if packed else _slot(w, gw).to(torch.bfloat16).float()
        halves = [wg[:, :Fw], wg[:, Fw:]] if packed else [wg]
        for c0 in range(0, n, BM):  # the group's chunks
            r0, nr = start + c0, min(BM, n - c0)
            mts = -(-nr // 16)
            xt = torch.zeros(mts * 16, nk * KT)  # zero-filled rows and D tail
            xt[:nr, :D] = xb[r0:r0 + nr]
            for col0 in range(0, plan.tiles * BN, BN):  # column tiles
                cols = torch.arange(col0, min(col0 + BN, Fw))
                for h, wh in enumerate(halves):
                    wt = torch.zeros(nk * KT, len(cols))  # zero-filled D tail
                    wt[:D] = wh[:, cols]
                    parts = []
                    for z in range(splits):
                        acc = torch.zeros(mts * 16, len(cols))
                        for kt in range(z * kps, min(nk, (z + 1) * kps)):
                            acc += xt[:, kt * KT:(kt + 1) * KT] @ wt[kt * KT:(kt + 1) * KT]
                        parts.append(acc)
                    total = parts[0]
                    for p in parts[1:]:  # split order, as the last split sums them
                        total = total + p
                    oc = h * Fw + cols
                    if scale is not None:
                        total = total * scale[gw, oc]
                    out[r0:r0 + nr, oc] = total[:nr]
        start += n
    return out


def _weights(rng, kind, S, D, F):
    if kind == "bf16":
        return torch.tensor(rng.standard_normal((S, D, F)) * 0.1, dtype=torch.float32
                            ).bfloat16(), None, False
    scale = torch.tensor(rng.uniform(0.001, 0.02, (S, F)), dtype=torch.float32)
    if kind == "int8":
        return torch.tensor(rng.integers(-128, 128, (S, D, F)), dtype=torch.int8), scale, False
    if kind == "fp8":  # about int8's spread, in e4m3's 3-bit steps
        vals = torch.tensor(rng.standard_normal((S, D, F)) * 64, dtype=torch.float32)
        return vals.clamp(-448, 448).to(torch.float8_e4m3fn), scale, False
    return torch.tensor(rng.integers(-128, 128, (S, D, F // 2)), dtype=torch.int8), scale, True


EDGE_SIZES = [0, 1, 15, 16, 17, 0, 63, 64, 65, 150]


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "fp8"])
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_emulation_matches_gmm_plain_at_the_chunk_edges(rng, kind, splits):
    """Groups of every edge size with empty ones between, 3 rows past the
    last group, D=200 (8 past the last whole k-tile), 1.5 column tiles."""
    D, F = 200, 384 if kind == "int4" else 192
    T = sum(EDGE_SIZES) + 3
    w, scale, packed = _weights(rng, kind, len(EDGE_SIZES), D, F)
    x = torch.tensor(rng.standard_normal((T, D)), dtype=torch.float32)
    sizes = torch.tensor(EDGE_SIZES, dtype=torch.int32)
    got = _emulate(x, w, EDGE_SIZES, scale, packed=packed, splits=splits)
    want = gm.gmm_plain(x, w, sizes, scale, packed=packed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    assert bool((got[sum(EDGE_SIZES):] == 0).all())


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "fp8"])
@pytest.mark.parametrize("sizes,ids", [
    ([64, 64], None),  # the last group ends at a chunk edge
    ([37, 27, 0, 0], [5, 2, 0, 0]),  # ... and at T; compacted ids, padded empty groups
    ([3, 1, 4, 0], [1, 5, 6, 0]),
])
def test_emulation_matches_gmm_plain_with_ids_and_offset(rng, kind, sizes, ids):
    S, off, D, F = 8, 4, 320, 256
    w, scale, packed = _weights(rng, kind, S + off, D, F)
    T = sum(sizes)
    x = torch.tensor(rng.standard_normal((T, D)), dtype=torch.float32)
    for splits in (None, 3):  # the plan's, and several
        got = _emulate(x, w, sizes, scale, off, ids, packed=packed, splits=splits)
        want = gm.gmm_plain(x, w, torch.tensor(sizes, dtype=torch.int32), scale, off,
                            None if ids is None else torch.tensor(ids), packed=packed)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_emulation_at_a_planned_split(rng):
    """A short, deep call (NLLB's decode down projection cut to 3 groups):
    the plan splits it, and the split sums agree."""
    D, F, sizes = 8192, 256, [3, 0, 5]
    assert gm._gmm_plan(8, 3, D, F // 2).splits > 1
    w, scale, packed = _weights(rng, "int4", 3, D, F)
    x = torch.tensor(rng.standard_normal((8, D)), dtype=torch.float32)
    got = _emulate(x, w, sizes, scale, packed=packed)
    want = gm.gmm_plain(x, w, torch.tensor(sizes, dtype=torch.int32), scale, packed=packed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)



@pytest.mark.parametrize("toward_zero", [False, True])
def test_the_rounding_witness_rounds_as_it_says(rng, toward_zero):
    """``chip_smoke.gmm_rounding`` emulates the kernel's f32 accumulator with
    ``_to_f32``: to nearest it is the f32 cast; toward zero it never grows a
    magnitude and is the f32 value next to the cast's, toward zero, or the
    cast itself."""
    import chip_smoke

    t = torch.tensor(rng.standard_normal(4096) * 10.0 ** rng.integers(-3, 4, 4096),
                     dtype=torch.float64)
    t[:3] = torch.tensor([0.0, 1.0, -2.5])  # exact in f32
    r = chip_smoke._to_f32(t, toward_zero)
    near = t.float()
    assert r.dtype == torch.float32
    if not toward_zero:
        assert torch.equal(r, near)
        return
    assert bool((r.double().abs() <= t.abs()).all())
    nxt = torch.nextafter(near, torch.zeros_like(near))
    assert bool(((r == near) | (r == nxt)).all())
    assert torch.equal(r[:3], near[:3])
    assert bool((r != near).any())  # some casts rounded up in magnitude


def test_emulation_at_grok_and_arctic_widths(rng):
    """fp8 weights at a slice of Grok-1's down projection (D 32768: 512
    k-tiles over the planned splits) and at Arctic's 38 column tiles of
    F 4864: the emulation and the plain version agree."""
    for T, sizes, D, F in ((2, [1, 1], 32768, 128), (2, [1, 1], 512, 4864)):
        w, scale, _ = _weights(rng, "fp8", 2, D, F)
        x = torch.tensor(rng.standard_normal((T, D)), dtype=torch.float32)
        assert gm._gmm_plan(T, 2, D, F).splits > 1
        got = _emulate(x, w, sizes, scale)
        want = gm.gmm_plain(x, w, torch.tensor(sizes, dtype=torch.int32), scale)
        tol = TOL * float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=tol)
