"""K5 at latent widths R other than 512 and rope widths P other than 64: its
plain version (what the wrapper runs for CPU tensors) against the JAX
package's Pallas ``mla_flash_decode`` in interpret mode at each new (R, P),
the wrapper's choice of instance and what it passes the padded one (the
kernel replaced by a recorder), and a DeepSeek model at R 96, where the JAX
kernel declines and both models take the einsum. Tolerance atol 2e-3, as
tests/test_torch_mla.py (f32 summation order); tokens equal."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models import deepseek_v2 as jds
from moe_infinity_tpu.ops import flash_attention as jfa
from moe_infinity_tpu.runtime.generate import Generator as JGenerator
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch.models.deepseek_v2 import DeepseekV2Model, DeepseekV2Spec
from moe_infinity_tpu_torch.ops import _build
from moe_infinity_tpu_torch.ops import flash_attention as fa
from moe_infinity_tpu_torch.runtime.generate import Generator
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

from torch_port_helpers import np32, one_intra_op_thread, port_attention, to_port

ATOL = 2e-3
# (R, P, H): the widths chip_smoke.py's phase 2 checks on the card; P 20 is a
# rope row of 40 bytes in bf16, which the padded instance copies by element
WIDTHS = [(128, 32, 4), (256, 32, 40), (256, 64, 4), (384, 64, 4), (512, 20, 4)]


def _inputs(rng, B, H, R, P, S):
    return dict(
        q_lat=rng.normal(size=(B, H, R)).astype(np.float32),
        q_pe=rng.normal(size=(B, H, P)).astype(np.float32),
        c=rng.normal(size=(B, S, R)).astype(np.float32),
        kpe=rng.normal(size=(B, S, P)).astype(np.float32),
    )


@pytest.mark.parametrize("cache", ["f32", "bf16"])
@pytest.mark.parametrize("R,P,H", WIDTHS)
def test_plain_matches_pallas_interpret_at_new_widths(rng, R, P, H, cache):
    """B 3, S 64, rows of 41, 64 and 1 live keys, holes in the first."""
    B, S = 3, 64
    a = _inputs(rng, B, H, R, P, S)
    pos = np.array([40, 63, 0], np.int32)
    holes = np.ones((B, S), bool)
    holes[0, 3:9] = False
    scale = (R // 4 + P) ** -0.5
    jdt, tdt = (jnp.float32, torch.float32) if cache == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = jfa.mla_flash_decode(
        jnp.asarray(a["q_lat"]), jnp.asarray(a["q_pe"]), jnp.asarray(a["c"], jdt),
        jnp.asarray(a["kpe"], jdt), jnp.asarray(pos), jnp.int32(S), scale=scale,
        pad_mask=jnp.asarray(holes), interpret=True)
    got = fa.mla_flash_decode(
        torch.tensor(a["q_lat"]), torch.tensor(a["q_pe"]), torch.tensor(a["c"]).to(tdt),
        torch.tensor(a["kpe"]).to(tdt), torch.tensor(pos), S, scale=scale,
        pad_mask=torch.tensor(holes))
    assert got.shape == (B, H, R) and got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np.asarray(want), atol=ATOL, rtol=0)


def test_jax_declines_r_not_a_multiple_of_128(rng):
    """Where the JAX kernel returns None the port's wrapper raises on the
    card route, before any launch; the model never sends it such R."""
    a = _inputs(rng, 1, 2, 96, 16, 8)
    assert jfa.mla_flash_decode(*(jnp.asarray(a[k]) for k in ("q_lat", "q_pe", "c", "kpe")),
                                jnp.zeros(1, jnp.int32), jnp.int32(8), scale=1.0,
                                interpret=True) is None
    z = torch.zeros
    with pytest.raises(ValueError, match="multiple of 128"):
        fa._mla_cuda(z(1, 2, 96), z(1, 2, 16), z(1, 8, 96), z(1, 8, 16),
                     z(1, dtype=torch.int32), 8, scale=1.0, pad_mask=None)


@pytest.mark.parametrize("R,P,want", [
    ((512, 64, ("flash_attention", "mit_mla_flash_decode", "mla_flash_decode"))),
    ((128, 32, ("mla_pad", "mit_mla_flash_decode_pad", "mla_flash_decode_pad"))),
    ((512, 20, ("mla_pad", "mit_mla_flash_decode_pad", "mla_flash_decode_pad"))),
    ((384, 1, ("mla_pad", "mit_mla_flash_decode_pad", "mla_flash_decode_pad"))),
    ((256, 64, ("mla_pad", "mit_mla_flash_decode_pad", "mla_flash_decode_pad"))),
])
def test_instance_choice(R, P, want):
    assert fa._mla_instance(R, P) == want


@pytest.mark.parametrize("R,P", [(96, 64), (0, 64), (512, 0), (640, 64), (512, 65)])
def test_instance_choice_raises(R, P):
    with pytest.raises(ValueError, match="multiple of 128" if R % 128 or R == 0 or P < 1
                       else "queue 2 part 4's remainder"):
        fa._mla_instance(R, P)


@pytest.mark.parametrize("R,P", [(128, 32), (384, 64), (512, 20), (512, 64)])
def test_the_wrapper_passes_the_true_widths(monkeypatch, R, P):
    """The kernel replaced by a recorder (CPU tensors): one launch of the
    chosen instance, the true R and P (the padded instance pads nothing in
    memory), scratch of the true R, counted under the instance's name."""
    calls = []

    def function(stem, name, argtypes):
        calls.append((stem, name))
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(_build, "tickets", lambda dev, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(_build, "workspace", lambda dev, n: torch.empty(n))
    B, H, S = 2, 16, 4096  # long rows: more than one cluster, so scratch
    z = torch.zeros
    before = dict(fa.LAUNCHES)
    out = fa._mla_cuda(z(B, H, R), z(B, H, P), z(B, S, R, dtype=torch.bfloat16),
                       z(B, S, P, dtype=torch.bfloat16), z(B, dtype=torch.int32), S,
                       scale=1.0, pad_mask=None)
    stem, cname, count = fa._mla_instance(R, P)
    assert fa.LAUNCHES[count] == before[count] + 1
    fa.LAUNCHES.update(before)  # nothing was launched
    assert out.shape == (B, H, R)
    assert calls[0] == (stem, cname)
    args = calls[1]
    n_b, n_h, n_s, n_r, n_p = args[10:15]
    assert (n_b, n_h, n_s, n_r, n_p) == (B, H, S, R, P)
    NS, CL = args[17], args[18]
    assert NS > CL  # several clusters: part_acc holds B * NS / CL * H * R floats
    assert args[6].value is not None and args[8].value is not None


def test_deepseek_at_r96_takes_the_einsum_as_jax_does(monkeypatch):
    """A tiny DeepSeek at kv_lora_rank 96: its decode under flash attention
    never reaches K5 (R % 128 != 0), as the JAX model's kernel declines it,
    and the greedy tokens equal the JAX Generator's; at R 128 the same
    model's decode does reach K5."""
    spec = dict(
        vocab_size=128, hidden_size=64, intermediate_size=96, moe_intermediate_size=64,
        num_layers=2, num_heads=2, q_lora_rank=None, kv_lora_rank=96, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, num_experts=4, top_k=2, n_shared_experts=1,
        first_k_dense_replace=1, topk_method="greedy", n_group=None, topk_group=None,
        routed_scaling_factor=1.0, rms_eps=1e-6, rope_theta=10000.0, tie_embeddings=False,
    )
    calls = []
    real = fa.mla_flash_decode
    monkeypatch.setattr(fa, "mla_flash_decode", lambda *a, **k: calls.append(1) or real(*a, **k))
    prompt = np.array([[5, 31, 8, 77]])
    for R in (96, 128):
        s = dict(spec, kv_lora_rank=R)
        jmodel = jds.DeepseekV2ModelJax(jds.DeepseekV2Spec(**s), compute_dtype=jnp.float32)
        jparams, jtree = jmodel.init_random(jax.random.PRNGKey(3))
        want = JGenerator(jmodel, jparams, jtree, JProvider.for_layer, max_seq_len=16).generate(
            prompt, max_new_tokens=4).sequences
        model = DeepseekV2Model(DeepseekV2Spec(**s), compute_dtype=torch.float32, device="cpu")
        calls.clear()
        with port_attention("flash"):
            got = Generator(model, to_port(jparams), to_port(jtree), ResidentProvider.for_layer,
                            max_seq_len=16).generate(prompt, max_new_tokens=4).sequences
        np.testing.assert_array_equal(got, want)
        assert (len(calls) > 0) == (R == 128)
