"""The port's sequence-parallel encoder (``parallel/sequence.py::sp_encode``)
against the JAX package's on a ``seq`` mesh of 4 of the 8 host devices, the
port's ranks as threads of a ``ThreadMesh``: NLLB (sinusoidal positions from
global ids) and Switch (the T5 bias through ``bias_fn``, the capacity router
exact across blocks). Tolerance 2e-4 (tests/test_sequence_parallel.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from moe_infinity_tpu.parallel import MeshPlan as JMeshPlan
from moe_infinity_tpu.parallel import make_mesh as jmake_mesh
from moe_infinity_tpu.parallel.sequence import sp_encode as jsp_encode
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch.parallel.sequence import sp_encode
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider
from torch_port_helpers import ThreadMesh, one_intra_op_thread, run_ranks, to_port  # noqa: F401

S, B, T = 4, 2, 16


def _encode_both(jmodel, model, seed, tokens, mesh_cls=ThreadMesh):
    """(JAX's sp_encode output, the port's blocks concatenated, the JAX
    model's own encode of the whole sequence)."""
    jparams, jexperts = jmodel.init_random(jax.random.PRNGKey(seed))
    want = np.asarray(jsp_encode(jmodel, jparams, jexperts, jnp.asarray(tokens),
                                 jmake_mesh(JMeshPlan(seq=S)), for_layer=JProvider.for_layer))
    whole = np.asarray(jmodel.encode(jparams, jexperts, jnp.asarray(tokens),
                                     jnp.ones(tokens.shape, jnp.float32), JProvider.for_layer,
                                     "gather"))
    params, experts = to_port(jparams), to_port(jexperts)
    got = run_ranks(lambda mesh: sp_encode(model, params, experts, tokens, mesh,
                                           for_layer=ResidentProvider.for_layer),
                    mesh_cls.grid(seq=S))
    return want, torch.cat(got, dim=1).numpy(), whole


def test_sp_encode_nllb_matches_jax(rng):
    from moe_infinity_tpu.models.nllb import NllbModel as J, NllbSpec as JS
    from moe_infinity_tpu_torch.models.nllb import NllbModel, NllbSpec

    spec = JS(vocab_size=96, d_model=32, num_heads=4, encoder_layers=4, decoder_layers=4,
              encoder_ffn_dim=64, decoder_ffn_dim=64, encoder_sparse_step=2,
              decoder_sparse_step=2, num_experts=4, pad_token_id=1, decoder_start_token_id=2,
              max_positions=64, scale_embedding=True)
    tokens = rng.integers(2, 96, (B, T)).astype(np.int32)
    want, got, whole = _encode_both(J(spec, compute_dtype=jnp.float32),
                                    NllbModel(NllbSpec(**dataclasses.asdict(spec)),
                                              torch.float32, "cpu"), 4, tokens)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, whole, rtol=2e-4, atol=2e-4)


class LocalCounts(ThreadMesh):
    """A mesh whose integer sums see this rank's part alone: the capacity
    router's count table then holds no earlier block's tokens."""

    def all_reduce(self, t, *axes, op="sum"):
        if t.dtype == torch.int32:
            return t
        return super().all_reduce(t, *axes, op=op)


def test_sp_encode_switch_capacity_exact(rng):
    """Capacity 2 over 16 tokens binds: the budget earlier blocks left
    decides which tokens drop, so the encoder equals JAX's and the whole
    sequence's encode, and counting a block's own tokens alone does not."""
    from moe_infinity_tpu.models.switch import SwitchModel as J, SwitchSpec as JS
    from moe_infinity_tpu_torch.models.switch import SwitchModel, SwitchSpec

    spec = JS(vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_heads=4, num_encoder_layers=4,
              num_decoder_layers=4, encoder_sparse_step=2, decoder_sparse_step=2,
              num_experts=4, expert_capacity=2, rel_buckets=8, rel_max_distance=16,
              rms_eps=1e-6, tie_embeddings=True, is_gated=False, dense_act_gelu=False,
              decoder_start_token_id=0)
    tokens = rng.integers(0, 96, (B, T)).astype(np.int32)
    jmodel = J(spec, compute_dtype=jnp.float32)
    model = SwitchModel(SwitchSpec(**dataclasses.asdict(spec)), torch.float32, "cpu")
    want, got, whole = _encode_both(jmodel, model, 5, tokens)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, whole, rtol=2e-4, atol=2e-4)
    _, local, _ = _encode_both(jmodel, model, 5, tokens, mesh_cls=LocalCounts)
    assert np.abs(local - want).max() > 1e-2
