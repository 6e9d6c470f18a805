"""Offload across ranks as real processes: two gloo ranks spawned by
tests/torch_mesh_workers.py (torch and the port only, a ``file://``
rendezvous, each rank joined with a timeout), the counterpart of JAX's
tests/test_multihost.py (which JAX marks slow; here the plans share one
spawn to stay inside the tier-1 run):

* ``MoE(..., multihost=True, expert_parallel=2)`` end to end, the first plan
  over ``coordinator_address`` (the facade initialises the process group,
  ``parallel/multihost.py::init_multihost``), then per layer with prefetch,
  speculative blocks, and NLLB (``PodSeq2SeqOffloadEngine``): every rank's
  greedy tokens equal one process's offload facade;
* ``PrefetchHints`` through the process group's store (published by one
  rank, fetched by the other, a fetch of nothing raising after its
  timeout) and the host channel (``host_all_reduce``, ``host_broadcast``,
  ``barrier``);
* a rank whose acquire raises, or whose process dies, inside the exchange:
  the other raises ``RuntimeError`` naming the step within the mesh's
  timeout, and no rank hangs."""

import dataclasses
import socket

import numpy as np
import pytest

from moe_infinity_tpu.models.mixtral import MixtralSpec as JSpec
from moe_infinity_tpu_torch.entrypoints.api import MoE
from torch_mesh_workers import spawn_ranks
from torch_pod_helpers import tiny_mixtral
from torch_port_helpers import one_intra_op_thread  # noqa: F401
from torch_port_helpers import save_tiny_checkpoint

PROMPT = np.array([[5, 9, 33, 7]])
OFFLOAD = {"expert_dtype": "float32", "max_seq_len": 64, "num_slots": 4, "num_threads": 1,
           "device_memory_bytes": 1, "dense_paging": "off"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ingest(path, plans):
    """Each plan's store, written once before the ranks start (two ranks
    ingesting into one directory at once would race)."""
    from moe_infinity_tpu_torch.store.ingest import ingest_checkpoint
    from moe_infinity_tpu_torch.utils.hf_config import read_hf_config

    for p in plans:
        ingest_checkpoint(path, p["offload_path"], read_hf_config(path), expert_dtype="float32")
    return plans


def _one_process(path, store, config, prompt, **kw):
    moe = MoE(path, dict(config, offload_path=store), device="cpu")
    try:
        return moe.generate(prompt, max_new_tokens=6, **kw)
    finally:
        moe.shutdown()


def test_multihost_facade_and_hints_over_gloo(tmp_path):
    mix, _ = save_tiny_checkpoint("mixtral", tmp_path / "mixtral", seed=7)
    nllb, _ = save_tiny_checkpoint("nllb", tmp_path / "nllb", seed=29)
    pod = dict(OFFLOAD, multihost=True, expert_parallel=2, num_slots=2)
    plans = _ingest(mix, [
        dict(pod, offload_path=str(tmp_path / "s0"), prefetch=False),
        dict(pod, offload_path=str(tmp_path / "s1"), prefetch=True, num_threads=2),
        dict(pod, offload_path=str(tmp_path / "s2"), prefetch=False, num_slots=4,
             speculative_decode=True, speculative_block=2),
    ])
    want = _one_process(mix, str(tmp_path / "one"), dict(OFFLOAD, prefetch=False), PROMPT,
                        eos_token_id=None)
    ranks = spawn_ranks("pod_facade_coordinator", 2, tmp_path / "ranks", dict(
        path=mix, plans=plans, prompt=PROMPT, new_tokens=6, port=_free_port()), timeout=120.0)
    for r, got in enumerate(ranks):
        for p in got["plans"]:
            assert p["engine"] == "PodOffloadEngine" and p["coords"]["expert"] == r
            np.testing.assert_array_equal(p["tokens"].numpy(), want)
        assert got["plans"][2]["stats"]["speculative_steps"] > 0
        assert got["hints"] == [(0, 1), (1, 2)]
        assert "timeout" in got["unpublished"].lower()
        assert got["max"] == [1, 10] and got["min"] == [0, 9] and got["bcast"] == [0, 10]
    # NLLB through PodSeq2SeqOffloadEngine on the same two ranks' kind
    src = np.array([[5, 31, 8, 77, 2]])
    want = _one_process(nllb, str(tmp_path / "one_nllb"), dict(OFFLOAD, prefetch=False), src)
    ranks = spawn_ranks("pod_facade", 2, tmp_path / "ranks_nllb", dict(
        path=nllb, plans=_ingest(nllb, [dict(pod, offload_path=str(tmp_path / "s3"),
                                             prefetch=False)]),
        prompt=src, new_tokens=6), timeout=120.0)
    for got in ranks:
        assert got["plans"][0]["engine"] == "PodSeq2SeqOffloadEngine"
        np.testing.assert_array_equal(got["plans"][0]["tokens"].numpy(), want)


@pytest.mark.parametrize("fault", ["raises", "dies"])
def test_a_failed_process_makes_the_other_raise(tmp_path, fault):
    cfg, _, stores, _ = tiny_mixtral(tmp_path)
    spec = dataclasses.asdict(JSpec.from_hf(cfg))
    ranks = spawn_ranks("pod_fail", 2, tmp_path / "ranks", dict(
        store_dir=stores["float32"], spec=spec, fault=fault, timeout=20.0), timeout=120.0,
        dead=(1,) if fault == "dies" else ())
    err, secs = ranks[0]["error"], ranks[0]["seconds"]
    assert err is not None and err.startswith("RuntimeError: pod step 1")
    if fault == "raises":
        assert "rank 1 failed" in err and "planted" in ranks[1]["error"]
    else:
        assert "did not complete" in err
    assert secs < 20.0  # within the mesh's timeout
