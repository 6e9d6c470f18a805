"""TP x EP across ranks (``moe_infinity_tpu_torch/store/column.py``,
``parallel/pod.py``) on the CPU, following tests/test_pod_tp.py case by case:
``ColumnShardStore`` against the JAX package's (the slices reassemble the
record, one shared base read, int4 repacked per column, block scales
refused), then the port's ranks as threads (``ThreadMesh``) against the JAX
``PodOffloadEngine`` on the 8 host devices: model=2 x expert=2, data=2 x
model=2 x expert=2, both speculative, the TP host fallback, quantized stores
against the pure-EP path, and NLLB (biases on the d_ff columns, ``fc2.bias``
added once) through the facade's ``multihost`` plan. Each model column is a
rank of its own, whose arena runs over its column's view; the columns' residency
is agreed at every exchange, so an expert one column lacks is a miss on all
of them (the last case plants that)."""

import numpy as np
import pytest
import torch

from moe_infinity_tpu.store.blob import ExpertStore as JStore
from moe_infinity_tpu.store.column import ColumnShardStore as JColumn
from moe_infinity_tpu.store.column import column_views as jcolumn_views
from moe_infinity_tpu_torch.store.blob import ExpertStore
from moe_infinity_tpu_torch.store.column import ColumnShardStore, column_views
from moe_infinity_tpu_torch.store.quant import unpack_int4_np
from torch_pod_helpers import (
    PROMPT,
    TWO,
    _jax_facade,
    assert_matches_jax,
    facade_ranks,
    hf_greedy,
    jax_run,
    port_run,
    tiny_mixtral,
)
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import save_tiny_checkpoint

E = 4


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_mixtral(tmp_path_factory.mktemp("torch_pod_tp"),
                        expert_dtypes=("float32", "int8", "int4"))


def _as(tiny, dt="float32"):
    """The (cfg, hf, store, path) tuple of ``torch_pod_helpers`` for one store."""
    cfg, hf, stores, path = tiny
    return cfg, hf, stores[dt], path


# ---------------------------------------------------------------------------
# ColumnShardStore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "int8", "int4"])
def test_column_store_equals_jax(tiny, dt):
    """Each column view's fields and records are the JAX view's byte for
    byte; gate/up's columns and down's rows reassemble the record (int4
    through unpacking: split-wise packing is repacked per column); scales
    slice with gate/up and replicate for down."""
    _, _, stores, _ = tiny
    store, jstore = ExpertStore(stores[dt]), JStore(stores[dt])
    views, jviews = column_views(store, 2), jcolumn_views(jstore, 2)
    full = store.get_expert(0, 1)
    parts = []
    for v, jv in zip(views, jviews):
        assert [(f.name, f.shape, f.dtype) for f in v.fields] == \
               [(f.name, f.shape, f.dtype) for f in jv.fields]
        rec, jrec = v.get_expert(0, 1), jv.get_expert(0, 1)
        assert sorted(rec) == sorted(jrec)
        for k in rec:
            np.testing.assert_array_equal(rec[k], jrec[k])
        parts.append(rec)
    unpack = unpack_int4_np if dt == "int4" else (lambda a: a)
    for name, axis in (("w1.weight", 1), ("w3.weight", 1), ("w2.weight", 0)):
        np.testing.assert_array_equal(
            np.concatenate([unpack(p[name]) for p in parts], axis=axis), unpack(full[name]))
    if dt != "float32":
        s = full["w1.weight.scale"]
        np.testing.assert_array_equal(parts[0]["w1.weight.scale"], s[: s.shape[0] // 2])
        np.testing.assert_array_equal(parts[1]["w2.weight.scale"], full["w2.weight.scale"])
    if dt == "float32":
        assert views[0]._field_by_name["w1.weight"].shape == (32, 32)
        assert views[0]._field_by_name["w2.weight"].shape == (32, 32)


def test_column_store_shares_base_read(tiny):
    """The columns of one process share one base read of a record."""
    _, _, stores, _ = tiny

    class CountingStore(ExpertStore):
        reads = 0

        def get_expert(self, layer, expert, **kw):
            CountingStore.reads += 1
            return super().get_expert(layer, expert, **kw)

    views = column_views(CountingStore(stores["float32"]), 2)
    views[0].get_expert(1, 2)
    views[1].get_expert(1, 2)
    assert CountingStore.reads == 1
    views[0].get_expert(1, 2)  # a fresh cycle reads again
    assert CountingStore.reads == 2


def test_column_store_block_scales_rejected(tiny):
    _, _, stores, _ = tiny
    store = ExpertStore(stores["float32"])

    class FakeField:
        name = "w1.weight.scale"
        shape = (4, 4)
        dtype = "float32"

    class FakeBlockStore:
        def __getattr__(self, name):
            return getattr(store, name)

        @property
        def fields(self):
            return list(store.fields) + [FakeField()]

        @property
        def field_names(self):
            return store.field_names + ["w1.weight.scale"]

    for cls in (ColumnShardStore, JColumn):
        with pytest.raises(NotImplementedError, match="BLOCK"):
            cls(FakeBlockStore(), 0, 2)


# ---------------------------------------------------------------------------
# the engines over column ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan,slots,prompt,speculative", [
    (dict(model=2, expert=2), 2, PROMPT, False),
    (dict(data=2, model=2, expert=2), 2, TWO, False),
    (dict(model=2, expert=2), E, PROMPT, True),
    (dict(data=2, model=2, expert=2), E, TWO, True),
], ids=["tp-ep", "dp-tp-ep", "tp-spec", "dp-tp-spec"])
def test_pod_tp_matches_jax(tiny, plan, slots, prompt, speculative):
    """Column-sharded slots on ranks of their own: tokens equal to JAX's and
    HF's, prefill logits within 1e-5, column 0's counters, barrier joins and
    (speculative) executions equal to JAX's; no column ever disagreed."""
    _, hf, _, _ = tiny
    want = jax_run(_as(tiny), plan, slots, prompt, speculative=speculative)
    np.testing.assert_array_equal(want["seqs"], hf_greedy(hf, prompt, 6))
    ranks = port_run(_as(tiny), plan, slots, prompt, speculative=speculative)
    assert_matches_jax(ranks, want)
    for r in ranks:
        assert r["stats"]["column_disagreements"] == 0
        if speculative:
            assert r["replays"] == want["replays"] and r["replays"]


def test_pod_tp_host_fallback_exact(tiny):
    """Every store never lands a record: every routed expert is -1 on every
    column, each rank adds the whole host delta once; tokens exact, host
    executions and counters equal to JAX's."""
    plan = dict(model=2, expert=2)
    want = jax_run(_as(tiny), plan, 2, PROMPT, 4, gate_coords=(0, 1), host_fallback=True)
    assert want["host"] > 0
    assert_matches_jax(port_run(_as(tiny), plan, 2, PROMPT, 4, gate_coords=(0, 1),
                                host_fallback=True), want)


def test_pod_tp_column_agreement(tiny):
    """Only column 1 of coordinate 0 never lands a record (the columns of
    a coordinate disagree): coordinate 0's experts count as missing on both
    columns, so no column computes half an expert beside the host's whole
    one. Tokens, logits, host executions and barrier joins equal JAX's with
    coordinate 0's whole arena held back; column 0 of coordinate 0 counts the
    keys it held that column 1 lacked."""
    plan = dict(model=2, expert=2)
    want = jax_run(_as(tiny), plan, 2, PROMPT, 4, gate_coords=(0,), host_fallback=True)
    ranks = port_run(_as(tiny), plan, 2, PROMPT, 4, host_fallback=True,
                     gate_coords=lambda c: (c["expert"], c["model"]) == (0, 1))
    assert_matches_jax(ranks, want, counters=False)
    for r in ranks:
        assert r["host"] == want["host"] > 0 and r["joins"] == want["joins"]
    held = [r for r in ranks if (r["coords"]["expert"], r["coords"]["model"]) == (0, 0)]
    assert held[0]["stats"]["column_disagreements"] > 0


@pytest.mark.parametrize("dt", ["int8", "int4"])
def test_pod_tp_quantized_matches_pure_ep(tiny, dt):
    """model=2 over a quantized store (int4 repacked per column) gives the
    pure-EP path's tokens, and the JAX engine's at model=2."""
    tp2 = port_run(_as(tiny, dt), dict(model=2, expert=2), E, PROMPT)
    tp1 = port_run(_as(tiny, dt), dict(expert=2), E, PROMPT)
    want = jax_run(_as(tiny, dt), dict(model=2, expert=2), E, PROMPT)
    for r in tp2:
        np.testing.assert_array_equal(r["seqs"], tp1[0]["seqs"])
        np.testing.assert_array_equal(r["seqs"], want["seqs"])


def test_pod_tp_seq2seq_nllb_facade(monkeypatch, tmp_path):
    """NLLB (fc1/fc2 biases) under the facade's multihost plan at model=2 x
    expert=2: ``PodSeq2SeqOffloadEngine``, fc2.bias added once by the sum
    over (expert, model); tokens equal to the JAX facade's and HF's."""
    path, hf = save_tiny_checkpoint("nllb", tmp_path / "ckpt", seed=29)
    cfg = {"expert_dtype": "float32", "max_seq_len": 64, "prefetch": False,
           "expert_parallel": 2, "tensor_parallel": 2, "num_slots": 2}
    prompt = np.array([[5, 31, 8, 77, 2]])
    jname, want = _jax_facade(path, str(tmp_path / "jax"), cfg, prompt, 6)
    with torch.no_grad():
        ref = hf.generate(torch.tensor(prompt), max_new_tokens=6, do_sample=False).numpy()
    n = min(want.shape[1], ref.shape[1])
    np.testing.assert_array_equal(want[:, :n], ref[:, :n])
    for r in facade_ranks(monkeypatch, path, str(tmp_path / "port"), dict(model=2, expert=2),
                          cfg, prompt, 6):
        assert r["engine"] == jname == "PodSeq2SeqOffloadEngine"
        np.testing.assert_array_equal(r["tokens"], want)
