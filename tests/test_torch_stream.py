"""The port's stream-gather grouped FFN (``ops/stream.py``) on the CPU against
the JAX package's ``moe_infinity_tpu.ops.stream``, mirroring
tests/test_stream_gffn.py: the same numpy weights, split into the same tier
segments, feed ``gffn_stream`` in both packages. Across segment boundaries,
with overflow past U masked and flagged, and with unstaged experts masked
and flagged, the outputs agree within 1e-5 (f32, sums in another order),
and ``stream_overflow`` gives the same verdicts. Through K3's plain version
(``impl="pallas"``) the stream's output equals the resident grouped FFN's
over the whole stacks bit for bit: the same records through the same
arithmetic. ``static_unique`` equals ``np.unique`` padded, and the gather's
plain version equals numpy's indexing, rows of -1 reading zeros."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.ops.moe import grouped_ffn as jgrouped_ffn
from moe_infinity_tpu.ops.stream import StreamSource as JSource
from moe_infinity_tpu.ops.stream import gffn_stream as jgffn_stream
from moe_infinity_tpu.ops.stream import stream_overflow as jstream_overflow
from moe_infinity_tpu_torch.ops import launch_counts
from moe_infinity_tpu_torch.ops.moe import grouped_ffn, pack_int4
from moe_infinity_tpu_torch.ops.stream import (
    StreamSource,
    gffn_stream,
    static_unique,
    stream_gather,
    stream_gather_plain,
    stream_overflow,
    stream_records,
)

from torch_port_helpers import one_intra_op_thread  # noqa: F401

E, D, F = 10, 8, 16
SEG_ROWS = 3  # several segments per gather
TOL = 1e-5


def _make(seed=0, staged=None):
    """(port source, JAX source, resident weights as torch and as numpy,
    rng) over gate/up/down f32 stacks of E experts, the staged ones in
    tier rows of SEG_ROWS-row segments."""
    rng = np.random.default_rng(seed)
    w = {"gate": rng.standard_normal((E, D, F)).astype(np.float32) * 0.1,
         "up": rng.standard_normal((E, D, F)).astype(np.float32) * 0.1,
         "down": rng.standard_normal((E, F, D)).astype(np.float32) * 0.1}
    staged = list(range(E)) if staged is None else staged
    rec_row = np.full(E, -1, np.int32)
    for row, e in enumerate(staged):
        rec_row[e] = row

    def segs(a):
        stacked = a[staged]
        return [stacked[i:i + SEG_ROWS] for i in range(0, len(staged), SEG_ROWS)]

    source = StreamSource({k: [torch.tensor(s) for s in segs(a)] for k, a in w.items()},
                          rec_row=rec_row, seg_rows=SEG_ROWS)
    jsource = JSource({k: [jnp.asarray(s) for s in segs(a)] for k, a in w.items()},
                      rec_row=rec_row, seg_rows=SEG_ROWS)
    return source, jsource, {k: torch.tensor(a) for k, a in w.items()}, w, rng


def _inputs(rng, T, ids):
    x = rng.standard_normal((T, D)).astype(np.float32)
    cw = rng.uniform(0.2, 1.0, ids.shape).astype(np.float32)
    return x, ids.astype(np.int32), cw


def _both(source, jsource, x, ids, cw, U, impl="ragged"):
    got = gffn_stream(torch.tensor(x), torch.tensor(ids), torch.tensor(cw), source, "silu",
                      max_unique=U, impl=impl)
    want = jgffn_stream(jnp.asarray(x), jnp.asarray(ids), jnp.asarray(cw), jsource, "silu",
                        max_unique=U)
    return got, np.asarray(want)


def _resident(resident, x, ids, cw, keep=None, impl="ragged"):
    cw = cw if keep is None else cw * keep
    return grouped_ffn(torch.tensor(x), torch.tensor(ids), torch.tensor(cw),
                       torch.arange(E, dtype=torch.int32), resident, "silu", impl=impl)


def test_stream_matches_resident_across_segments():
    source, jsource, resident, _, rng = _make(1)
    x, ids, cw = _inputs(rng, 6, rng.integers(0, E, (6, 2)))
    got, want = _both(source, jsource, x, ids, cw, E)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), _resident(resident, x, ids, cw).numpy(),
                               rtol=TOL, atol=TOL)
    assert not stream_overflow(ids, E, source.rec_row)
    assert not jstream_overflow(ids, E, source.rec_row)


def test_stream_overflow_masks_and_flags():
    source, jsource, resident, _, rng = _make(2)
    T, U = 8, 4
    ids = (np.arange(T * 2) % E).reshape(T, 2)  # more distinct experts than U
    x, ids, _ = _inputs(rng, T, ids)
    cw = np.full((T, 2), 0.5, np.float32)
    got, want = _both(source, jsource, x, ids, cw, U)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # the first U distinct ids (ascending, 0..3) contribute; the rest zero
    keep = (ids < U).astype(np.float32)
    np.testing.assert_allclose(got.numpy(), _resident(resident, x, ids, cw, keep).numpy(),
                               rtol=TOL, atol=TOL)
    for verdict in (stream_overflow, jstream_overflow):
        assert verdict(ids, U, source.rec_row)
        assert not verdict(ids[:1, :1], U, source.rec_row)


def test_stream_unstaged_masks_and_flags():
    staged = [0, 1, 2, 3, 4, 5, 6, 8]  # 7 and 9 unstaged
    source, jsource, resident, _, rng = _make(3, staged=staged)
    ids = np.array([[0, 7], [1, 2], [9, 3], [4, 8], [5, 6]])
    x, ids, cw = _inputs(rng, 5, ids)
    got, want = _both(source, jsource, x, ids, cw, E)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    keep = (~np.isin(ids, [7, 9])).astype(np.float32)
    np.testing.assert_allclose(got.numpy(), _resident(resident, x, ids, cw, keep).numpy(),
                               rtol=TOL, atol=TOL)
    for verdict in (stream_overflow, jstream_overflow):
        assert verdict(ids, E, source.rec_row)
        assert not verdict(ids[[1, 4]], E, source.rec_row)


@pytest.mark.parametrize("U", [3, 6, 10])
def test_stream_kernel_path_equals_resident_exactly(U):
    """NLLB's record (packed int4 gate and down with f32 scales and biases,
    the arena's keys) through K3's plain version: at a U that holds every
    distinct routed id the stream's output equals the resident grouped
    FFN's over the whole stacks bit for bit; below it, the resident one
    with the overflowed experts' weights zeroed, likewise."""
    rng = np.random.default_rng(U)
    Dq, Fq = 32, 64
    w = {"gate4": pack_int4(torch.tensor(rng.integers(-8, 8, (E, Dq, Fq)), dtype=torch.int8)),
         "gate_scale": torch.tensor(rng.uniform(0.003, 0.006, (E, Fq)), dtype=torch.float32),
         "down4": pack_int4(torch.tensor(rng.integers(-8, 8, (E, Fq, Dq)), dtype=torch.int8)),
         "down_scale": torch.tensor(rng.uniform(0.003, 0.006, (E, Dq)), dtype=torch.float32),
         "gate_bias": torch.tensor(rng.standard_normal((E, Fq)) * 0.02, dtype=torch.float32),
         "down_bias": torch.tensor(rng.standard_normal((E, Dq)) * 0.02, dtype=torch.float32)}
    order = rng.permutation(E)  # tier rows in another order than the ids
    rec_row = np.empty(E, np.int32)
    rec_row[order] = np.arange(E)
    source = StreamSource({k: [a[order][i:i + 4] for i in range(0, E, 4)] for k, a in w.items()},
                          rec_row=rec_row, seg_rows=4, max_unique=U, impl="pallas")
    T = 6
    x = torch.tensor(rng.standard_normal((T, Dq)), dtype=torch.float32)
    ids = torch.tensor([[1, 4], [4, 7], [2, 1], [9, 7], [4, 2], [1, 9]], dtype=torch.int32)
    cw = torch.tensor(rng.uniform(0.2, 1.0, (T, 2)), dtype=torch.float32)
    got = grouped_ffn(x, ids, cw, torch.arange(E, dtype=torch.int32), source, "relu")
    keep = ids < int(np.unique(ids.numpy())[min(U, 5) - 1]) + 1  # the first U distinct ids
    weights = {k: v for k, v in w.items() if "bias" not in k}
    biases = {k: v for k, v in w.items() if "bias" in k}
    want = grouped_ffn(x, ids, cw * keep, torch.arange(E, dtype=torch.int32), weights, "relu",
                       biases=biases, impl="pallas")
    assert torch.equal(got, want)
    assert stream_overflow(ids.numpy(), U, rec_row) == (U < 5)
    assert launch_counts()["stream_gather"] == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("case", ["more_slots", "fewer_slots", "duplicates", "one"])
def test_static_unique_equals_np_unique(case):
    rng = np.random.default_rng(len(case))
    flat = {"more_slots": rng.permutation(20)[:7],
            "fewer_slots": rng.integers(0, 50, 40),
            "duplicates": np.repeat(rng.integers(0, 9, 5), 4),
            "one": np.array([3])}[case]
    size = {"more_slots": 12, "fewer_slots": 6, "duplicates": 8, "one": 2}[case]
    got = static_unique(torch.tensor(flat, dtype=torch.int32), size, 99).numpy()
    uniq = np.unique(flat)[:size]
    want = np.concatenate([uniq, np.full(size - uniq.size, 99)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["few", "overflow", "unstaged"])
def test_stream_records_counts_the_rows_the_gather_reads(case):
    """The host's count of the records a layer's gather read equals the
    present rows (>= 0) that ``gffn_stream`` hands the gather: padding past
    the distinct experts and unstaged experts read nothing."""
    rec_row = np.arange(E, dtype=np.int32)
    rec_row[[7, 9]] = -1 if case == "unstaged" else rec_row[[7, 9]]
    ids, U, want = {"few": (np.array([[2, 5], [5, 2]]), 8, 2),
                    "overflow": ((np.arange(16) % E).reshape(8, 2), 4, 4),
                    "unstaged": (np.array([[0, 7], [9, 3], [3, 0]]), 8, 2)}[case]
    uniq = static_unique(torch.tensor(ids).reshape(-1), U, E)
    rr = torch.tensor(rec_row)
    rows = torch.where(uniq < E, rr[uniq.clamp(max=E - 1)], -1)
    assert stream_records(ids, U, rec_row) == int((rows >= 0).sum()) == want


def test_gather_plain_reads_rows_across_segments():
    """``stream_gather`` on CPU rows runs the plain version: each role's
    record at its row, rows of -1 reading nothing (zeros), across segments of
    3 and a shorter last one."""
    source, _, _, w, _ = _make(4)
    rows = torch.tensor([9, -1, 3, 5, 0, 2, 8, -1], dtype=torch.int32)
    before = launch_counts()["stream_gather"]
    got = stream_gather(source, rows)
    assert launch_counts()["stream_gather"] == before
    plain = stream_gather_plain(source.fields, SEG_ROWS, rows)
    r = rows.clamp(min=0).numpy()
    absent = (rows < 0).numpy()
    for k, a in w.items():
        want = a[r].copy()
        want[absent] = 0
        np.testing.assert_array_equal(got[k].numpy(), want)
        assert torch.equal(plain[k], got[k])


def test_jax_source_segments_are_the_ports():
    """The two packages' sources hold the same bytes segment by segment."""
    source, jsource, _, _, _ = _make(5, staged=[1, 3, 5, 7, 9, 0])
    for k, segs in source.fields.items():
        assert len(segs) == len(jsource.fields[k]) == 2
        for a, b in zip(segs, jsource.fields[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert jax.tree_util.tree_structure(jsource) is not None
