"""The port's ring attention (``moe_infinity_tpu_torch/ops/ring_attention.py``)
against the JAX package's on the same numpy inputs: ``ring_attention`` under
``shard_map`` on a ``seq`` mesh of the 8 host devices tests/conftest.py
provides, the port's ranks as threads of a ``ThreadMesh``. ``ring_attend``,
``sp_decode_attention`` and the real ``parallel.mesh.Mesh`` on gloo ranks
are in tests/test_torch_ring_decode.py, so that the two files run on two
workers. Tolerance 2e-5, the JAX suite's for the ring primitives
(tests/test_sequence_parallel.py)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from moe_infinity_tpu.models.layers import t5_position_bias as jt5_bias
from moe_infinity_tpu.ops.ring_attention import ring_attention as jring_attention
from moe_infinity_tpu.parallel import MeshPlan as JMeshPlan
from moe_infinity_tpu.parallel import make_mesh as jmake_mesh
from moe_infinity_tpu_torch.models.layers import t5_position_bias
from moe_infinity_tpu_torch.ops.ring_attention import ring_attention
from torch_port_helpers import ThreadMesh, one_intra_op_thread, run_ranks  # noqa: F401

TOL = 2e-5
B, H, DH = 2, 8, 16
BUCKETS, MAX_DIST = 8, 16


def _inputs(rng, T, hkv, scale=1.0):
    q = (rng.standard_normal((B, T, H, DH)) * scale).astype(np.float32)
    k = (rng.standard_normal((B, T, hkv, DH)) * scale).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, DH)).astype(np.float32)
    return q, k, v


def _jax_ring(mesh, s, q, k, v, **kw):
    spec = P(None, "seq", None, None)
    fn = jax.shard_map(partial(jring_attention, axis_name="seq", axis_size=s, **kw), mesh=mesh,
                       in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)
    return np.asarray(fn(q, k, v))


def _port_ring(s, q, k, v, **kw):
    """Each thread's time block through the port's ring, concatenated."""
    Tl = q.shape[1] // s

    def rank(mesh):
        i = mesh.axis_index("seq")
        blk = slice(i * Tl, (i + 1) * Tl)
        return ring_attention(torch.tensor(q[:, blk]), torch.tensor(k[:, blk]),
                              torch.tensor(v[:, blk]), mesh, **kw)

    return torch.cat(run_ranks(rank, ThreadMesh.grid(seq=s)), dim=1).numpy()


@pytest.mark.parametrize("s,hkv", [(4, 4), (2, 2)], ids=["s4-hkv4", "s2-hkv2"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize("extras", [False, True], ids=["plain", "t5-bias-softcap"])
def test_ring_attention_matches_jax(rng, s, hkv, causal, extras):
    """GQA (H=8 over 4 or 2 KV heads), causal or bidirectional; with
    ``extras`` a T5 relative bias from global positions (``bias_fn``) and
    a tanh softcap, at a logit spread that makes a rank's later blocks
    wholly masked under causal."""
    T = 16
    q, k, v = _inputs(rng, T, hkv, scale=3.0 if extras else 1.0)
    table = rng.standard_normal((BUCKETS, H)).astype(np.float32)
    jkw, pkw = dict(causal=causal), dict(causal=causal)
    if extras:
        jtab, ptab = jnp.asarray(table), torch.tensor(table)
        jkw.update(logit_softcap=30.0, bias_fn=lambda qp, kp: jt5_bias(
            jtab, qp, kp, not causal, BUCKETS, MAX_DIST))
        pkw.update(logit_softcap=30.0, bias_fn=lambda qp, kp: t5_position_bias(
            ptab, qp, kp, not causal, BUCKETS, MAX_DIST))
    want = _jax_ring(jmake_mesh(JMeshPlan(seq=s)), s, q, k, v, **jkw)
    got = _port_ring(s, q, k, v, **pkw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
