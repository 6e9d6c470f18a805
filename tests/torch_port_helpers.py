"""Shared helpers of the port's parity tests (tests/test_torch_*.py): move
JAX arrays to the port through numpy, build tiny NLLB models in both
packages from one seed, write NLLB, Switch, Mixtral and DeepSeek expert
stores, and run each CPU test with one intra-op thread
(``one_intra_op_thread``, which every CPU test file imports)."""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from moe_infinity_tpu_torch import bridge


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """Run the test with one intra-op thread of torch's CPU pool. The tier-1
    command runs six xdist workers; with torch's default (one thread per
    core) each small op of the plain kernels opens a parallel region whose
    spinning threads six processes share eight cores with, and a test that
    takes 10 s alone took minutes. Restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


TINY_NLLB = dict(
    vocab_size=96, d_model=256, num_heads=2,  # head_dim 128, as NLLB-54B
    encoder_layers=2, decoder_layers=2,
    encoder_ffn_dim=512, decoder_ffn_dim=512,
    encoder_sparse_step=2, decoder_sparse_step=2,
    num_experts=8, pad_token_id=1, decoder_start_token_id=2,
    max_positions=64, scale_embedding=True,
)


def jax_to_numpy(tree):
    """JAX pytree -> numpy arrays, bf16 as uint16 bits and fp8 as uint8
    codes (bridge convention)."""

    def conv(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.float8_e4m3fn:
            return a.view(np.uint8)
        return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a

    return jax.tree.map(conv, tree)


def to_port(tree, device="cpu"):
    return bridge.to_torch(jax_to_numpy(tree), device)


def np32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@contextlib.contextmanager
def jax_kernels_interpreted(monkeypatch):
    """Route the JAX package through its Pallas kernels in interpret mode, as
    its own tests do, restoring the switches afterwards."""
    from moe_infinity_tpu.models import layers as jl
    from moe_infinity_tpu.ops import flash_attention as jfa
    from moe_infinity_tpu.ops import gmm as jgmm

    prev_impl, prev_interp = jl.get_attention_impl(), jfa._INTERPRET
    jl.set_attention_impl("flash")
    jfa.set_flash_interpret(True)
    monkeypatch.setattr(
        jgmm, "gffn_pallas", functools.partial(jgmm.gffn_pallas, interpret=True)
    )
    try:
        yield
    finally:
        jl.set_attention_impl(prev_impl)
        jfa.set_flash_interpret(prev_interp)


@contextlib.contextmanager
def port_attention(impl):
    from moe_infinity_tpu_torch.models import layers as tl

    prev = tl.get_attention_impl()
    tl.set_attention_impl(impl)
    try:
        yield
    finally:
        tl.set_attention_impl(prev)


def int4_expert_tree(rng, spec, n_layers):
    """Packed int4 expert tree as numpy (same arrays feed both packages)."""
    from moe_infinity_tpu.ops.moe import pack_int4

    E, D, F = spec["num_experts"], spec["d_model"], spec["encoder_ffn_dim"]
    layers = []
    for _ in range(n_layers):
        vg = rng.integers(-8, 8, (E, D, F)).astype(np.int8)
        vd = rng.integers(-8, 8, (E, F, D)).astype(np.int8)
        layers.append({
            "gate4": np.asarray(pack_int4(jnp.asarray(vg))),
            "gate_scale": rng.uniform(0.003, 0.0056, (E, F)).astype(np.float32),
            "down4": np.asarray(pack_int4(jnp.asarray(vd))),
            "down_scale": rng.uniform(0.003, 0.0056, (E, D)).astype(np.float32),
            "gate_bias": (rng.standard_normal((E, F)) * 0.02).astype(np.float32),
            "down_bias": (rng.standard_normal((E, D)) * 0.02).astype(np.float32),
        })
    return {"layers": layers, "slot_map": np.arange(E, dtype=np.int32)}


def write_nllb_store(path, expert_layers, quant, num_encoder_moe_layers, seed=0):
    """Write an NLLB expert store with the JAX package's ExpertStoreWriter
    from a JAX expert tree's layers ([E, D, F] gate, [E, F, D] down, compute
    layout). quant "float32" keeps the weights; "int4" quantizes each output
    channel (``store/quant.py``) and packs the nibbles along the output axis.
    Biases are drawn from ``seed`` (init_random's are zero). Returns the
    path."""
    from moe_infinity_tpu.store.blob import ExpertStoreWriter
    from moe_infinity_tpu.store.quant import quantize_rowwise

    g0 = np.asarray(expert_layers[0]["gate"])
    E, D, F = g0.shape
    if quant == "int4":
        fields = [("fc1.weight", (D, F // 2), "int4"), ("fc1.weight.scale", (F,), "float32"),
                  ("fc1.bias", (F,), "float32"), ("fc2.weight", (F, D // 2), "int4"),
                  ("fc2.weight.scale", (D,), "float32"), ("fc2.bias", (D,), "float32")]
    else:
        fields = [("fc1.weight", (D, F), "float32"), ("fc1.bias", (F,), "float32"),
                  ("fc2.weight", (F, D), "float32"), ("fc2.bias", (D,), "float32")]
    rng = np.random.default_rng(seed)
    w = ExpertStoreWriter(str(path), len(expert_layers), E, fields,
                          meta={"arch": "nllb", "num_encoder_moe_layers": num_encoder_moe_layers})
    for layer, lay in enumerate(expert_layers):
        for e in range(E):
            for tail, role in (("fc1", "gate"), ("fc2", "down")):
                a = np.asarray(lay[role][e], np.float32)
                if quant == "int4":
                    q, s = quantize_rowwise(a.T, "int4")  # [out/2, in] packed, scale [out]
                    w.write_tensor(layer, e, tail + ".weight", np.ascontiguousarray(q.T))
                    w.write_tensor(layer, e, tail + ".weight.scale", s)
                else:
                    w.write_tensor(layer, e, tail + ".weight", a)
                n = a.shape[1]
                w.write_tensor(layer, e, tail + ".bias",
                               (rng.standard_normal(n) * 0.02).astype(np.float32))
    w.finalize()
    return str(path)


def write_switch_store(path, expert_layers, quant, num_encoder_moe_layers, gated=False):
    """Write a Switch expert store with the JAX package's ExpertStoreWriter
    from an expert tree's layers ([E, D, F] gate, optional [E, D, F] up,
    [E, F, D] down, compute layout): the tails ``wi``/``wo``, or with
    ``gated`` ``wi_0``/``wi_1``/``wo`` and ``gated`` in the meta (the
    ``switch_gated`` roles). quant "float32" keeps the weights; "int4"
    quantizes each output channel and packs the nibbles along the output
    axis, as ``write_nllb_store`` does. Returns the path."""
    from moe_infinity_tpu.store.blob import ExpertStoreWriter
    from moe_infinity_tpu.store.quant import quantize_rowwise

    roles = (("wi_0", "gate"), ("wi_1", "up"), ("wo", "down")) if gated else (
        ("wi", "gate"), ("wo", "down"))
    E = np.asarray(expert_layers[0]["gate"]).shape[0]
    fields = []
    for tail, role in roles:
        d_in, d_out = np.asarray(expert_layers[0][role]).shape[1:]
        if quant == "int4":
            fields += [(tail + ".weight", (d_in, d_out // 2), "int4"),
                       (tail + ".weight.scale", (d_out,), "float32")]
        else:
            fields.append((tail + ".weight", (d_in, d_out), "float32"))
    meta = {"arch": "switch", "num_encoder_moe_layers": num_encoder_moe_layers}
    if gated:
        meta["gated"] = True
    w = ExpertStoreWriter(str(path), len(expert_layers), E, fields, meta=meta)
    for layer, lay in enumerate(expert_layers):
        for e in range(E):
            for tail, role in roles:
                a = np.asarray(lay[role][e], np.float32)
                if quant == "int4":
                    q, s = quantize_rowwise(a.T, "int4")  # [out/2, in] packed, scale [out]
                    w.write_tensor(layer, e, tail + ".weight", np.ascontiguousarray(q.T))
                    w.write_tensor(layer, e, tail + ".weight.scale", s)
                else:
                    w.write_tensor(layer, e, tail + ".weight", a)
    w.finalize()
    return str(path)


DECODER_TAILS = {
    "mixtral": (("w1", "gate"), ("w3", "up"), ("w2", "down")),
    "arctic": (("w1", "gate"), ("w3", "up"), ("w2", "down")),
    "grok": (("linear", "gate"), ("linear_v", "up"), ("linear_1", "down")),
    "deepseek": (("gate_proj", "gate"), ("up_proj", "up"), ("down_proj", "down")),
}


def write_decoder_store(path, expert_layers, arch, quant="float32"):
    """Write a decoder-only expert store (``arch`` a key of
    ``DECODER_TAILS``) with the JAX package's ExpertStoreWriter from one
    expert tree's layers ([E, D, F] gate and up, [E, F, D] down, compute
    layout, JAX or numpy arrays), so that both packages read the same files:
    ``<tail>.weight`` per role, as the JAX bench's Mixtral store names them.
    quant "float32" keeps the weights; "int8" and "float8_e4m3fn" quantize
    each output channel (``store/quant.py``) with an f32
    ``<tail>.weight.scale``. Returns the path."""
    from moe_infinity_tpu.store.blob import ExpertStoreWriter
    from moe_infinity_tpu.store.quant import quantize_rowwise

    roles = DECODER_TAILS[arch]
    E = np.asarray(expert_layers[0]["gate"]).shape[0]
    fields = []
    for tail, role in roles:
        d_in, d_out = np.asarray(expert_layers[0][role]).shape[1:]
        fields.append((tail + ".weight", (d_in, d_out), quant))
        if quant != "float32":
            fields.append((tail + ".weight.scale", (d_out,), "float32"))
    meta = {"arch": arch, "num_encoder_moe_layers": 0}
    if arch != "deepseek":
        meta["gated"] = True
    w = ExpertStoreWriter(str(path), len(expert_layers), E, fields, meta=meta)
    for layer, lay in enumerate(expert_layers):
        for e in range(E):
            for tail, role in roles:
                a = np.asarray(lay[role][e], np.float32)
                if quant != "float32":
                    q, s = quantize_rowwise(a.T, quant)  # [out, in], scale [out]
                    w.write_tensor(layer, e, tail + ".weight", np.ascontiguousarray(q.T))
                    w.write_tensor(layer, e, tail + ".weight.scale", s)
                else:
                    w.write_tensor(layer, e, tail + ".weight", a)
    w.finalize()
    return str(path)


# ---------------------------------------------------------------------------
# tiny HF checkpoints of the four families the port serves (random weights,
# no download), for the ingest and entry-point tests
# ---------------------------------------------------------------------------

HF_FAMILIES = ("mixtral", "deepseek", "switch", "nllb")


def tiny_hf_model(family: str, seed: int = 1, dtype=torch.float32):
    """(HF config, HF model in eval mode) of a tiny random checkpoint."""
    import transformers as tf

    common = dict(torch_dtype=dtype)
    if family == "mixtral":
        cfg = tf.MixtralConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
            num_experts_per_tok=2, vocab_size=128, max_position_embeddings=128,
            architectures=["MixtralForCausalLM"], **common)
        cls = tf.MixtralForCausalLM
    elif family == "deepseek":
        # as tests/test_deepseek_parity.py builds it
        cfg = tf.DeepseekV2Config(
            vocab_size=128, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=48, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=4, q_lora_rank=None, kv_lora_rank=32,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32, head_dim=16,
            n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=1,
            first_k_dense_replace=1, topk_method="greedy", routed_scaling_factor=1.0,
            norm_topk_prob=False, aux_loss_alpha=0.0, seq_aux=False,
            max_position_embeddings=128, architectures=["DeepseekV2ForCausalLM"],
            attention_bias=False, **common)
        cls = tf.DeepseekV2ForCausalLM
    elif family == "switch":
        # as tests/test_entrypoints_seq2seq.py builds it
        cfg = tf.SwitchTransformersConfig(
            vocab_size=96, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_decoder_layers=2, num_heads=4, num_experts=4, expert_capacity=8,
            num_sparse_encoder_layers=1, num_sparse_decoder_layers=1,
            relative_attention_num_buckets=8, relative_attention_max_distance=16,
            dropout_rate=0.0, router_jitter_noise=0.0, decoder_start_token_id=0,
            eos_token_id=1, pad_token_id=0,
            architectures=["SwitchTransformersForConditionalGeneration"], **common)
        cls = tf.SwitchTransformersForConditionalGeneration
    elif family == "nllb":
        # as tests/test_nllb_parity.py builds it
        cfg = tf.NllbMoeConfig(
            vocab_size=96, d_model=32, encoder_layers=4, decoder_layers=4,
            encoder_attention_heads=4, decoder_attention_heads=4,
            encoder_ffn_dim=64, decoder_ffn_dim=64, encoder_sparse_step=2,
            decoder_sparse_step=2, num_experts=4, max_position_embeddings=64,
            dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
            moe_token_dropout=0.0, router_jitter_noise=0.0, pad_token_id=1,
            bos_token_id=0, eos_token_id=2, decoder_start_token_id=2,
            architectures=["NllbMoeForConditionalGeneration"], **common)
        cls = tf.NllbMoeForConditionalGeneration
    else:
        raise ValueError(family)
    torch.manual_seed(seed)
    return cfg, cls(cfg).to(dtype).eval()


def save_tiny_checkpoint(family: str, path, *, safe: bool = True, shard: str = "40KB",
                         seed: int = 1, dtype=torch.float32):
    """Write a tiny HF checkpoint of ``family`` in shards (with an index);
    returns (path as str, the HF model)."""
    _, hf = tiny_hf_model(family, seed, dtype)
    hf.save_pretrained(path, safe_serialization=safe, max_shard_size=shard)
    return str(path), hf


def word_tokenizer(path=None):
    """A word-level HF tokenizer over ids 0..127 (``tok{i}``, with ``<eos>``
    124, ``<unk>`` 125, ``hello`` 126, ``world`` 127), as
    tests/test_entrypoints.py builds it; saved to ``path`` when given."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    vocab = {f"tok{i}": i for i in range(124)}
    vocab.update({"<eos>": 124, "<unk>": 125, "hello": 126, "world": 127})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    t = PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="<eos>", unk_token="<unk>")
    if path is not None:
        t.save_pretrained(path)
    return t


def sharpen_seq2seq(params, embed=8.0, qk=10.0, vo=15.0):
    """A JAX NLLB or Switch param tree with the token embedding and the
    attention projections scaled up (in place, returned). With
    ``init_random``'s std-0.02 weights the sinusoidal positions and near
    uniform attention leave the greedy tokens all but independent of the
    source, so a batcher that fed a row another row's cross K/V, mask or
    position would go unseen; scaled, the tiny models' outputs differ from
    source to source and change within a sequence."""
    params["embed"] = params["embed"] * embed
    for blk in params["enc_blocks"] + params["dec_blocks"]:
        for attn in ("self_attn", "cross_attn"):  # NLLB: nested per attention
            if attn in blk:
                for n, f in (("q", qk), ("k", qk), ("v", vo), ("o", vo)):
                    blk[attn][n] = blk[attn][n] * f
        for n, f in (("q", qk), ("k", qk), ("v", vo), ("o", vo),  # Switch: flat
                     ("cq", qk), ("ck", qk), ("cv", vo), ("co", vo)):
            if n in blk:
                blk[n] = blk[n] * f
    return params


def wait_for(cond, timeout=60.0, what="condition"):
    """Poll ``cond()`` until it holds; fail the test after ``timeout`` s."""
    import time

    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.002)


def queue_together(batcher, requests):
    """Submit every request to ``batcher`` (either package's) at once: they
    are queued on a new queue that replaces the batcher's in one assignment,
    so its first admission sees them all, whatever its thread was doing.
    ``requests``: (input_ids, kwargs of submit). Returns the futures."""
    import queue
    import types

    stage = types.SimpleNamespace(**vars(batcher))
    stage._queue = queue.Queue()
    futures = [type(batcher).submit(stage, ids, **kw) for ids, kw in requests]
    batcher._queue = stage._queue
    return futures


class StandIn:
    """A capture backend for the CPU tests (``CudaGraphBackend``'s contract):
    ``capture(fn)`` runs ``fn`` once and returns (replay, its outputs, no
    launches); ``replay()`` runs ``fn`` again with no arguments and copies
    the new outputs into the first ones."""

    def __init__(self):
        self.captured = 0

    def capture(self, fn):
        self.captured += 1
        out = fn()

        def replay():
            for o, n in zip(out, fn()):
                o.copy_(n)

        return replay, out, {}


class ThreadMesh:
    """The ranks of a mesh as threads of one process, for single-process
    tests of a model's mesh branch: ``shape``, ``coords``, ``axis_index``,
    ``all_reduce``, ``gather_rows``, ``gather_cols`` and the host channel
    (``host_all_reduce``, ``host_broadcast``, ``barrier``) and ``ring_hop``
    as ``parallel.mesh.Mesh`` has them. Every rank calls each collective at the
    same point (SPMD); a reduction combines the ranks that share this one's
    coordinates off ``axes``, in rank order, between two barriers. A
    barrier that waits longer than ``timeout`` seconds, or that a failed
    rank broke (``run_ranks``), raises ``threading.BrokenBarrierError``."""

    def __init__(self, shape, coords, rank, board):
        self.shape, self.coords, self.rank, self._board = shape, coords, rank, board
        self.hop_bytes = 0

    @classmethod
    def grid(cls, timeout=120.0, **sizes):
        """One mesh per rank of a grid of ``sizes`` (axes data, model,
        expert, seq; rank order as ``parallel.make_mesh``'s)."""
        import itertools
        import threading

        from moe_infinity_tpu_torch.parallel.mesh import AXES

        shape = {a: sizes.get(a, 1) for a in AXES}
        coords = [dict(zip(AXES, c)) for c in itertools.product(*(range(shape[a]) for a in AXES))]
        board = {"parts": {}, "coords": coords,
                 "barrier": threading.Barrier(len(coords), timeout=timeout)}
        return [cls(shape, c, r, board) for r, c in enumerate(coords)]

    def axis_index(self, axis):
        return self.coords[axis]

    def _line(self, axes):
        """The ranks of this one's line over ``axes`` (None: no live axis)."""
        live = [a for a in self.shape if a in axes and self.shape[a] > 1]
        if not live:
            return None
        coords = self._board["coords"]

        def off(r):
            return tuple(c for a, c in coords[r].items() if a not in live)

        return [r for r in range(len(coords)) if off(r) == off(self.rank)]

    def _combine(self, t, axes, fold):
        line = self._line(axes)
        if line is None:
            return t
        b = self._board
        b["parts"][self.rank] = t.clone()
        b["barrier"].wait()
        total = fold([b["parts"][r] for r in line])
        b["barrier"].wait()
        t.copy_(total)
        return t

    def all_reduce(self, t, *axes, op="sum"):
        fn = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op]

        def fold(parts):
            out = parts[0].clone()
            for p in parts[1:]:
                out = fn(out, p)
            return out

        return self._combine(t, axes, fold)

    def host_all_reduce(self, t, op, *axes):
        return self.all_reduce(t, *axes, op=op)

    def ring_hop(self, t, axis):
        """The tensor the previous rank of this one's line over ``axis``
        passed (each rank passes ``t`` to coordinate i + 1)."""
        n = self.shape[axis]
        if n == 1:
            return t
        coords = self._board["coords"]
        want = dict(self.coords, **{axis: (self.coords[axis] - 1) % n})
        prev = coords.index(want)
        b = self._board
        b["parts"][self.rank] = t.clone()
        b["barrier"].wait()
        got = b["parts"][prev]
        b["barrier"].wait()
        self.hop_bytes += t.numel() * t.element_size()
        return got

    def host_broadcast(self, t, *axes):
        return self._combine(t, axes, lambda parts: parts[0].clone())

    def barrier(self, timeout=None):
        self._board["barrier"].wait(timeout)

    def gather_rows(self, t, lo, total, axis):
        from moe_infinity_tpu_torch.parallel.mesh import Mesh

        return Mesh.gather_rows(self, t, lo, total, axis)

    def gather_cols(self, t, axis):
        from moe_infinity_tpu_torch.parallel.mesh import Mesh

        return Mesh.gather_cols(self, t, axis)


def run_ranks(fn, meshes, timeout=120.0):
    """``fn(mesh)`` on a thread per rank; returns the results in rank order
    (raises what a rank raised, or when one is still running at the
    timeout)."""
    import threading

    out, errs = [None] * len(meshes), []

    def go(i, m):
        try:
            out[i] = fn(m)
        except BaseException as e:  # reported below, in the test's thread
            errs.append(e)
            m._board["barrier"].abort()

    threads = [threading.Thread(target=go, args=(i, m), daemon=True) for i, m in enumerate(meshes)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errs:
        raise errs[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a rank did not finish in {timeout} s")
    return out


def mesh_apply_ff(make_model, layer, h, cw, ids, sizes, impl="ragged"):
    """Every rank's ``apply_ff`` of a seq2seq model under a ``ThreadMesh`` of
    ``sizes``, each on its slice of one layer's experts (``layer``: the
    weights, slot map and biases of ``ResidentProvider.for_layer``)."""
    from moe_infinity_tpu_torch.parallel import mesh as pm

    w, slot_map, biases = layer

    def rank(mesh):
        model = make_model(mesh)
        wl = pm.shard_params(w, pm.expert_shardings(mesh, w))
        bl = None if biases is None else pm.shard_params(biases, pm.expert_shardings(mesh, biases))
        return model.apply_ff(torch.zeros_like(h), h, cw, ids, wl, slot_map, bl, impl)

    return run_ranks(rank, ThreadMesh.grid(**sizes))
