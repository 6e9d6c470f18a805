"""The port's resident mesh (``parallel/mesh.py``, ``ops.moe.grouped_ffn_ep``,
Mixtral's tensor-parallel branch, ``ResidentStepper.set_data_sharding`` and
the facade's mesh plan) on gloo ranks on the CPU, against the JAX package's
sharded functions on the 8 host devices tests/conftest.py provides.

Each case spawns its ranks (``tests/torch_mesh_workers.py``, which imports
torch only) with a ``file://`` rendezvous in ``tmp_path``: no ports, so
xdist workers do not collide. A rank that hangs is terminated after its
timeout and the case fails. Tolerances are the JAX suite's own
(tests/test_parallel.py): 1e-5 for the grouped FFN, 2e-4 for the forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from moe_infinity_tpu.models.mixtral import MixtralModel as JMixtralModel
from moe_infinity_tpu.models.mixtral import MixtralSpec as JMixtralSpec
from moe_infinity_tpu.ops.moe import grouped_ffn_ep as jgrouped_ffn_ep
from moe_infinity_tpu.parallel import MeshPlan as JMeshPlan
from moe_infinity_tpu.parallel import expert_shardings as jexpert_shardings
from moe_infinity_tpu.parallel import make_mesh as jmake_mesh
from moe_infinity_tpu.parallel import mixtral_param_shardings as jmixtral_param_shardings
from moe_infinity_tpu.parallel import shard_params as jshard_params
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch import parallel
from moe_infinity_tpu_torch.entrypoints.api import MoE
from moe_infinity_tpu_torch.models.mixtral import MixtralModel, MixtralSpec
from moe_infinity_tpu_torch.runtime.generate import Generator, ResidentStepper
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

from torch_mesh_workers import spawn_ranks
from torch_port_helpers import jax_to_numpy, one_intra_op_thread, save_tiny_checkpoint, to_port

SPEC = dict(
    vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=8, num_kv_heads=4, head_dim=8, num_experts=8, top_k=2,
    rms_eps=1e-6, rope_theta=1e6, tie_embeddings=False,
)
B, T, CAP, NEW = 4, 8, 16, 4


def _jax_mesh(plan):
    return jmake_mesh(JMeshPlan(**plan))


@pytest.mark.parametrize("plan,joint", [
    (dict(expert=2), False),
    (dict(data=2, expert=2), False),
    (dict(data=2, expert=2), True),
    (dict(model=2, expert=2), False),
], ids=["ep2", "dp2-ep2", "dp2-ep2-joint", "tp2-ep2-bias"])
def test_grouped_ffn_ep_matches_jax(rng, tmp_path, plan, joint):
    """Under a model axis the experts hold d_ff halves and carry NLLB's
    biases: ``gate_bias`` cut with d_ff, ``down_bias`` added on model
    coordinate 0 alone, the sum running over the (model, expert) plane."""
    Tn, D, F, E, K = 16, 64, 128, 8, 2
    x = rng.standard_normal((Tn, D)).astype(np.float32)
    ids = rng.integers(0, E, (Tn, K)).astype(np.int32)
    cw = rng.uniform(0, 1, (Tn, K)).astype(np.float32)
    dp = plan.get("data", 1)
    S = dp * E if joint else E  # the joint mode: one copy of every expert per data row
    w = {r: (rng.standard_normal(shape) * 0.1).astype(np.float32)
         for r, shape in (("gate", (S, D, F)), ("up", (S, D, F)), ("down", (S, F, D)))}
    b = ({r: rng.standard_normal(shape).astype(np.float32)
          for r, shape in (("gate_bias", (S, F)), ("down_bias", (S, D)))}
         if "model" in plan else None)
    slot = (np.stack([d * E + np.arange(E) for d in range(dp)]) if joint
            else np.arange(E)).astype(np.int32)
    mesh = _jax_mesh(plan)
    if joint:
        w_s = {k: jax.device_put(v, NamedSharding(mesh, P(("data", "expert"), None, None)))
               for k, v in w.items()}
    else:
        w_s = jshard_params(w, jexpert_shardings(mesh, w))
    b_s = None if b is None else jshard_params(b, jexpert_shardings(mesh, b))
    x_s = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    slot_s = jax.device_put(slot, NamedSharding(mesh, P("data", None) if joint else P()))
    want = np.asarray(jax.jit(lambda x, i, c, s, w, b: jgrouped_ffn_ep(
        x, i, c, s, w, "silu", mesh=mesh, biases=b))(x_s, ids, cw, slot_s, w_s, b_s))
    ranks = spawn_ranks("ep_ffn", int(np.prod(list(plan.values()))), tmp_path, dict(
        plan=plan, x=x, ids=ids, cw=cw, slot=slot, weights=w, biases=b, joint=joint))
    for r in ranks:
        got = r["out"].numpy()
        np.testing.assert_allclose(got, want[r["lo"]:r["lo"] + got.shape[0]], rtol=1e-5, atol=1e-5)


def test_grouped_ffn_ep_launches_the_unsharded_grid(rng, monkeypatch):
    """Through K3's wrapper (``impl="pallas"``; its plain version on the
    CPU) each expert rank hands K3 the unsharded call's rows and groups, the
    integers its launch plan (``ops/gmm.py::_gmm_plan``) is made from, and
    the ranks' sum is the unsharded output."""
    from moe_infinity_tpu_torch.ops import gmm as gm
    from moe_infinity_tpu_torch.ops.moe import grouped_ffn, grouped_ffn_ep
    from torch_port_helpers import ThreadMesh, run_ranks

    Tn, D, F, E, K = 12, 32, 64, 8, 2
    x = torch.tensor(rng.standard_normal((Tn, D)), dtype=torch.float32)
    ids = torch.tensor(rng.integers(0, E, (Tn, K)), dtype=torch.int32)
    cw = torch.tensor(rng.uniform(0, 1, (Tn, K)), dtype=torch.float32)
    w = {r: torch.tensor(rng.standard_normal(shape) * 0.1, dtype=torch.bfloat16)
         for r, shape in (("gate", (E, D, F)), ("up", (E, D, F)), ("down", (E, F, D)))}
    slot = torch.arange(E, dtype=torch.int32)
    seen, plain = [], gm.compact_groups

    def compact(sorted_slots, num_groups):
        seen.append((sorted_slots.shape[0], num_groups))
        return plain(sorted_slots, num_groups)

    monkeypatch.setattr(gm, "compact_groups", compact)
    want = grouped_ffn(x, ids, cw, slot, w, "silu", impl="pallas")
    unsharded = list(seen)

    def rank(mesh):
        wl = parallel.shard_params(w, parallel.expert_shardings(mesh, w))
        return grouped_ffn_ep(x, ids, cw, slot, wl, "silu", mesh=mesh, impl="pallas")

    got = run_ranks(rank, ThreadMesh.grid(expert=2))
    assert len(seen) == 3 * len(unsharded) and set(seen) == set(unsharded)
    for out in got:
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tp_inner", [False, True], ids=["model-outer", "tp-inner"])
def test_rank_grid_matches_jax_make_mesh(tp_inner):
    """Rank r sits where JAX's ``make_mesh`` puts device r."""
    from moe_infinity_tpu_torch.parallel.mesh import rank_grid

    plan = dict(data=2, model=2, expert=2)
    devices = jax.devices()
    want = np.vectorize(devices.index)(jmake_mesh(JMeshPlan(**plan), tp_inner=tp_inner).devices)
    np.testing.assert_array_equal(rank_grid(parallel.MeshPlan(**plan), tp_inner=tp_inner), want)


@pytest.fixture(scope="module")
def mixtral():
    """JAX f32 weights, the prompt, and the unsharded port's logits, greedy
    tokens and decode_scan."""
    jmodel = JMixtralModel(JMixtralSpec(**SPEC), compute_dtype=jnp.float32)
    jparams, jexperts = jmodel.init_random(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, 128, (B, T)).astype(np.int32)
    model = MixtralModel(MixtralSpec(**SPEC), torch.float32, "cpu")
    stepper = ResidentStepper(model, to_port(jparams), to_port(jexperts),
                              ResidentProvider.for_layer, graphs=False)
    kv = stepper.init_cache(B, CAP)
    pos = torch.arange(T, dtype=torch.int32).expand(B, T)
    logits, kv, _ = stepper.forward(torch.tensor(tokens), pos, kv, 0)
    tok0 = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    scan, _ = stepper.decode_scan(tok0, torch.full((B,), T, dtype=torch.int32), kv, NEW)
    seqs = Generator(stepper=stepper).generate(tokens, max_new_tokens=NEW, cache_len=CAP)
    return jmodel, jparams, jexperts, tokens, scan, seqs.sequences


def _jax_sharded_forward(jmodel_single, jparams, jexperts, tokens, plan):
    """JAX's sharded forward (tests/test_parallel.py) on a mesh of ``plan``."""
    mesh = _jax_mesh(plan)
    model = JMixtralModel(JMixtralSpec(**SPEC), compute_dtype=jnp.float32, mesh=mesh)
    p_s = jshard_params(jparams, jmixtral_param_shardings(mesh, jparams))
    e_s = jshard_params(jexperts, jexpert_shardings(mesh, jexperts))
    kv = [type(c)(jax.device_put(c.k, NamedSharding(mesh, P("data", None, None, None))),
                  jax.device_put(c.v, NamedSharding(mesh, P("data", None, None, None))))
          for c in model.init_cache(B, CAP)]
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    tok_s = jax.device_put(jnp.asarray(tokens), NamedSharding(mesh, P("data", None)))
    got, _, _ = jax.jit(lambda p, e, t, pos, kv: model.forward(
        p, e, t, pos, kv, jnp.int32(0), for_layer=JProvider.for_layer))(
        p_s, e_s, tok_s, positions, kv)
    return np.asarray(got)


@pytest.mark.parametrize("plan", [dict(model=2), dict(data=2, expert=2)], ids=["tp2", "dp2-ep2"])
def test_sharded_mixtral_matches_jax(mixtral, tmp_path, plan):
    """The sharded forward's logits within 2e-4 of JAX's sharded forward;
    greedy tokens (``Generator`` and ``decode_scan``) equal to the
    unsharded port's on every rank; each rank holds Hkv / tp KV heads and,
    under data parallelism, B / dp cache rows."""
    jmodel, jparams, jexperts, tokens, scan, seqs = mixtral
    want = _jax_sharded_forward(jmodel, jparams, jexperts, tokens, plan)
    ranks = spawn_ranks("mixtral", int(np.prod(list(plan.values()))), tmp_path, dict(
        plan=plan, spec=SPEC, params=jax_to_numpy(jparams), experts=jax_to_numpy(jexperts),
        tokens=tokens, cap=CAP, new_tokens=NEW))
    for r in ranks:
        np.testing.assert_allclose(r["logits"].numpy(), want, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(r["scan"], scan, rtol=0, atol=0)
        np.testing.assert_array_equal(r["generate"].numpy(), seqs)
        assert r["kv_heads"] == SPEC["num_kv_heads"] // plan.get("model", 1)
        assert r["rows"] == B // plan.get("data", 1)


def test_facade_expert_parallel_returns_unsharded_tokens(tmp_path):
    path, _ = save_tiny_checkpoint("mixtral", tmp_path / "ckpt", seed=1)
    config = {"expert_dtype": "float32", "max_seq_len": 64, "offload_path": str(tmp_path / "st")}
    prompt = np.array([[5, 31, 8, 77, 12]])
    single = MoE(path, config, device="cpu")
    try:
        want = single.generate(prompt, max_new_tokens=6)
        E = single.generator.stepper.experts["layers"][0]["gate"].shape[0]
    finally:
        single.shutdown()
    ranks = spawn_ranks("facade", 2, tmp_path / "ranks", dict(
        path=path, config=dict(config, expert_parallel=2), prompt=prompt, new_tokens=6))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["tokens"].numpy(), want)
        assert got["coords"]["expert"] == r and got["slots"] == E // 2


def test_mesh_needs_a_process_group_of_its_size():
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(parallel.MeshPlan(expert=2))
    with pytest.raises(NotImplementedError, match="item 18c"):
        parallel.make_mesh(parallel.MeshPlan(seq=2))
    with pytest.raises(NotImplementedError, match="item 18c"):
        parallel.SPDecoder
    # offload across ranks is served (tests/test_torch_pod_engine.py)
    assert parallel.PodExpertPlan.__module__ == "moe_infinity_tpu_torch.parallel.pod"
