"""The whole model's logits of the port's Snowflake Arctic against the JAX
package's on the CPU, on the tiny Arctic of tests/test_torch_arctic.py (split
from it, whose spec and family fixture it shares, in both variants): a
prefill of 6 tokens then 3 decode steps through the port's plain kernels
against the JAX kernels in interpret mode (K2 at rep 7, K1, K3), 5e-5 at f32
(f32 sums in another order) and 2e-2 at bf16, under the "ragged" and
"pallas" grouped FFN."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.arctic import ArcticModel as JArcticModel
from moe_infinity_tpu.models.arctic import ArcticSpec as JArcticSpec
from moe_infinity_tpu.runtime.providers import ResidentProvider as JProvider
from moe_infinity_tpu_torch.models.arctic import ArcticModel, ArcticSpec
from moe_infinity_tpu_torch.runtime.providers import ResidentProvider

from test_torch_arctic import _no_tf32, arctic  # noqa: F401
from torch_port_helpers import (  # noqa: F401
    jax_kernels_interpreted,
    np32,
    one_intra_op_thread,
    to_port,
)


@pytest.mark.parametrize("impl", ["ragged", "pallas"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_logits_match_jax_kernels(arctic, monkeypatch, impl, dtype):
    """Prefill of 6 tokens then 3 decode steps, the port's plain kernels
    against the JAX kernels in interpret mode (K2 at rep 7, K1, K3)."""
    jdt, tdt, tol = ((jnp.float32, torch.float32, 5e-5) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, 2e-2))
    spec = dataclasses.asdict(arctic.model.spec)
    jmodel = JArcticModel(JArcticSpec(**spec), compute_dtype=jdt)
    model = ArcticModel(ArcticSpec(**spec), compute_dtype=tdt, device="cpu")
    jp = jax.tree.map(lambda a: a.astype(jdt) if a.ndim >= 2 else a, arctic.jparams)
    jtree = jax.tree.map(lambda a: a.astype(jdt) if a.ndim == 3 else a, arctic.jtree)
    params, tree = to_port(jp), to_port(jtree)
    tokens = np.array([[3, 17, 5, 60, 2, 41]], np.int32)
    with jax_kernels_interpreted(monkeypatch):
        jkv, kv = jmodel.init_cache(1, 16), model.init_cache(1, 16)
        pos = np.arange(6, dtype=np.int32)[None]
        want, jkv, _ = jmodel.forward(jp, jtree, jnp.asarray(tokens), jnp.asarray(pos), jkv, 0,
                                      for_layer=JProvider.for_layer, impl=impl)
        got, kv, _ = model.forward(params, tree, torch.tensor(tokens), torch.tensor(pos), kv, 0,
                                   for_layer=ResidentProvider.for_layer, impl=impl)
        np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=tol, atol=tol)
        for step in range(6, 9):
            tok = np.array([[int(np.asarray(want)[0, -1].argmax())]], np.int32)
            p = np.array([[step]], np.int32)
            want, jkv, _ = jmodel.forward(jp, jtree, jnp.asarray(tok), jnp.asarray(p), jkv, step,
                                          for_layer=JProvider.for_layer, impl=impl)
            got, kv, _ = model.forward(params, tree, torch.tensor(tok), torch.tensor(p), kv,
                                       step, for_layer=ResidentProvider.for_layer, impl=impl)
            np.testing.assert_allclose(np32(got), np.asarray(want, np.float32), rtol=tol,
                                       atol=tol)
