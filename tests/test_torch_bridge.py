"""The weight bridge between the JAX package's pytrees and the port, and the
port's isolation from JAX."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from moe_infinity_tpu.models.nllb import NllbModel as JNllbModel
from moe_infinity_tpu.models.nllb import NllbSpec as JNllbSpec
from moe_infinity_tpu_torch import bridge

from torch_port_helpers import TINY_NLLB, jax_to_numpy, one_intra_op_thread

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_nllb_pytree_round_trip_keeps_keys_shapes_values(dtype):
    model = JNllbModel(JNllbSpec(**TINY_NLLB), compute_dtype=dtype)
    params, tree = model.init_random(jax.random.PRNGKey(1), expert_dtype=dtype)
    src = jax_to_numpy({"params": params, "experts": tree})
    port = bridge.to_torch(src, "cpu")
    back = bridge.to_numpy(port)
    want_paths = jax.tree_util.tree_flatten_with_path(src)[0]
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(back)[0]}
    assert sorted(got) == sorted(jax.tree_util.keystr(p) for p, _ in want_paths)
    for p, v in want_paths:
        g = got[jax.tree_util.keystr(p)]
        assert g.shape == v.shape and g.dtype == v.dtype
        np.testing.assert_array_equal(g, v)
    # bf16 leaves arrive as bf16 tensors with the same values
    emb = port["params"]["embed"]
    assert emb.dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    np.testing.assert_array_equal(
        emb.float().numpy(), np.asarray(params["embed"]).astype(np.float32)
    )
    assert port["experts"]["slot_map"].dtype == torch.int32


def test_bridge_bf16_bits_and_passthrough():
    a = np.asarray([1.5, -2.25, 3.0e-3], ml_dtypes.bfloat16)
    t = bridge.to_torch({"w": a.view(np.uint16), "n": 3, "none": None}, "cpu")
    assert t["w"].dtype == torch.bfloat16 and t["n"] == 3 and t["none"] is None
    np.testing.assert_array_equal(t["w"].float().numpy(), a.astype(np.float32))


def test_bridge_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.to_torch({"w": np.zeros(2, np.float32)}, "cuda")


def _port_files():
    return sorted((ROOT / "moe_infinity_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_of_jax(path):
    banned = ("jax", "jaxlib", "moe_infinity_tpu", "ml_dtypes")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in banned, f"{path.name} imports {n}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'moe_infinity_tpu', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "import moe_infinity_tpu_torch, moe_infinity_tpu_torch.bridge\n"
        "import moe_infinity_tpu_torch.models.nllb, moe_infinity_tpu_torch.runtime.generate\n"
        "import moe_infinity_tpu_torch.runtime.providers, moe_infinity_tpu_torch.ops.gmm\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
