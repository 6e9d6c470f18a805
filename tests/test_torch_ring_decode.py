"""The port's ``ring_attend`` and ``sp_decode_attention``
(``moe_infinity_tpu_torch/ops/ring_attention.py``) against the JAX
package's on the same numpy inputs, the port's ranks as threads of a
``ThreadMesh`` and the JAX functions under ``shard_map`` on a ``seq`` mesh of
the 8 host devices tests/conftest.py provides; then the real
``parallel.mesh.Mesh`` (its ring hop and ``all_reduce(max)``) on four gloo
ranks spawned by tests/torch_mesh_workers.py. Split from
tests/test_torch_ring_attention.py, whose helpers it shares. Tolerance
2e-5, the JAX suite's for the ring primitives
(tests/test_sequence_parallel.py)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from moe_infinity_tpu.ops.ring_attention import ring_attend as jring_attend
from moe_infinity_tpu.ops.ring_attention import sp_decode_attention as jsp_decode_attention
from moe_infinity_tpu.parallel import MeshPlan as JMeshPlan
from moe_infinity_tpu.parallel import make_mesh as jmake_mesh
from moe_infinity_tpu_torch.ops.ring_attention import ring_attend, sp_decode_attention
from test_torch_ring_attention import B, DH, H, TOL, _inputs
from torch_mesh_workers import spawn_ranks
from torch_port_helpers import ThreadMesh, one_intra_op_thread, run_ranks  # noqa: F401


def test_ring_attend_gathers_the_whole_output(rng):
    """``ring_attend`` splits whole inputs over the axis and every rank
    returns the whole output, as JAX's returns its global array."""
    q, k, v = _inputs(rng, 16, 4)
    want = np.asarray(jring_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jmake_mesh(JMeshPlan(seq=4))))
    got = run_ranks(lambda m: ring_attend(torch.tensor(q), torch.tensor(k), torch.tensor(v), m),
                    ThreadMesh.grid(seq=4))
    for out in got:
        np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="not divisible by seq=4"):
        run_ranks(lambda m: ring_attend(torch.tensor(q[:, :14]), torch.tensor(k[:, :14]),
                                        torch.tensor(v[:, :14]), m), ThreadMesh.grid(seq=4))


def _decode_inputs(rng, T, C, hkv):
    q1 = rng.standard_normal((B, 1, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, T, hkv, DH)).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, DH)).astype(np.float32)
    tk = rng.standard_normal((B, C, hkv, DH)).astype(np.float32)
    tv = rng.standard_normal((B, C, hkv, DH)).astype(np.float32)
    return q1, k, v, tk, tv


def _jax_decode(s, q1, k, v, tk, tv, g, **kw):
    shard, rep = P(None, "seq", None, None), P()
    fn = jax.shard_map(partial(jsp_decode_attention, axis_name="seq", **kw),
                       mesh=jmake_mesh(JMeshPlan(seq=s)),
                       in_specs=(rep, shard, shard, rep, rep, rep), out_specs=rep,
                       check_vma=False)
    return np.asarray(fn(q1, k, v, tk, tv, jnp.int32(g)))


@pytest.mark.parametrize("softcap", [None, 30.0], ids=["plain", "softcap"])
def test_sp_decode_attention_matches_jax(rng, softcap):
    """Frozen shards on 4 ranks and a tail of 8 columns, 3 of them valid:
    the merge of the partials (max over the ranks, the rescaled sums) and
    the tail folded in, the same on every rank."""
    T, C, g = 16, 8, 3
    q1, k, v, tk, tv = _decode_inputs(rng, T, C, 4)
    want = _jax_decode(4, q1, k, v, tk, tv, g, logit_softcap=softcap)
    Ts = T // 4

    def rank(mesh):
        i = mesh.axis_index("seq")
        blk = slice(i * Ts, (i + 1) * Ts)
        return sp_decode_attention(torch.tensor(q1), torch.tensor(k[:, blk]),
                                   torch.tensor(v[:, blk]), torch.tensor(tk), torch.tensor(tv),
                                   g, mesh, logit_softcap=softcap)

    for out in run_ranks(rank, ThreadMesh.grid(seq=4)):
        np.testing.assert_allclose(out.numpy(), want, rtol=TOL, atol=TOL)


def test_real_mesh_ring_hop_and_max_on_gloo_ranks(rng, tmp_path):
    """Four spawned gloo ranks on a ``seq`` axis: each receives its
    predecessor's tensor from ``ring_hop`` (f32 and bf16; with four ranks a
    hop's direction shows) and counts the bytes it sent, ``all_reduce``
    takes the max (and still sums by default), and ``ring_attend`` and
    ``sp_decode_attention`` over the real process group equal JAX's."""
    world = 4
    q, k, v = _inputs(rng, 16, 4)
    q1, _, _, tk, tv = _decode_inputs(rng, 16, 8, 4)
    g = 5
    want_attend = np.asarray(jring_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jmake_mesh(JMeshPlan(seq=world))))
    want_decode = _jax_decode(world, q1, k, v, tk, tv, g)
    ranks = spawn_ranks("ring", world, tmp_path, dict(world=world, q=q, k=k, v=v, q1=q1,
                                                      tail_k=tk, tail_v=tv, g=g))
    for r, out in enumerate(ranks):
        prev = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * ((r - 1) % world)
        torch.testing.assert_close(out["hop"], prev, rtol=0, atol=0)
        torch.testing.assert_close(out["hop_bf16"], prev.to(torch.bfloat16), rtol=0, atol=0)
        assert out["hop_bytes"] == 6 * 4 + 6 * 2
        assert out["max"].tolist() == [3.0, 0.0, 7.0]
        assert out["sum"].tolist() == [6, 4]
        np.testing.assert_allclose(out["attend"].numpy(), want_attend, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out["decode"].numpy(), want_decode, rtol=TOL, atol=TOL)
