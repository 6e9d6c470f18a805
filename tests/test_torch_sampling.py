"""The port's sampler (``moe_infinity_tpu_torch/runtime/sampling.py``) against
the JAX package's ``runtime/sampling.py`` on the same numpy inputs, mirroring
tests/test_sampling.py: the processed logits of each filter, penalty, the
full chain, min-p and logit_bias equal JAX's (exactly where the ops are the
same, within 1e-6 where an op's order differs), the sampled token equals
JAX's when the port is handed JAX's Gumbel noise (``jax.random.categorical``
is ``argmax(logits + gumbel)``, checked first), logprobs within 1e-5,
draws fixed by the seed, and sampled ``Generator`` and batcher runs on a
tiny Mixtral."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moe_infinity_tpu.runtime import sampling as J
from moe_infinity_tpu_torch.runtime import sampling as P
from torch_port_helpers import one_intra_op_thread  # noqa: F401


def _rand_logits(b=3, v=50, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, v)).astype(np.float32) * 3.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(port, jax_out, rtol=0.0):
    """Equal -inf masks; finite values equal (or within rtol)."""
    a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(jax_out)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    fa, fb = np.where(np.isinf(a), 0, a), np.where(np.isinf(b), 0, b)
    if rtol:
        np.testing.assert_allclose(fa, fb, rtol=rtol, atol=1e-6)
    else:
        np.testing.assert_array_equal(fa, fb)


def test_jax_categorical_is_argmax_plus_gumbel():
    """The premise of injecting JAX's noise: on the installed JAX a
    categorical draw is the argmax of logits plus gumbel noise of the same
    key, for whole batches and for fold_in row keys."""
    for s in range(8):
        k = jax.random.PRNGKey(s)
        logits = jnp.asarray(_rand_logits(b=3, v=40, seed=s))
        a = jax.random.categorical(k, logits, axis=-1)
        b = jnp.argmax(logits + jax.random.gumbel(k, logits.shape), axis=-1)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        kr = jax.random.fold_in(jax.random.PRNGKey(s), 5)
        assert int(jax.random.categorical(kr, logits[0])) == int(
            jnp.argmax(logits[0] + jax.random.gumbel(kr, logits[0].shape)))


class TestFilters:
    @pytest.mark.parametrize("k", [1, 5, 17, 50, 100])
    def test_top_k(self, k):
        logits = _rand_logits()
        _same(P.top_k_filter(_t(logits), k), J.top_k_filter(jnp.asarray(logits), k))

    @pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 0.95, 0.999])
    def test_top_p(self, p):
        logits = _rand_logits(seed=1)
        _same(P.top_p_filter(_t(logits), p), J.top_p_filter(jnp.asarray(logits), p))

    def test_top_p_keeps_at_least_one(self):
        logits = np.full((1, 10), -10.0, np.float32)
        logits[0, 3] = 10.0
        ours = P.top_p_filter(_t(logits), 0.0001)
        assert torch.isfinite(ours[0, 3])
        _same(ours, J.top_p_filter(jnp.asarray(logits), 0.0001))

    @pytest.mark.parametrize("p", [0.02, 0.1, 0.3, 0.7, 0.99])
    def test_min_p(self, p):
        logits = _rand_logits(b=3, v=40, seed=12)
        _same(P.min_p_filter(_t(logits), p), J.min_p_filter(jnp.asarray(logits), p))

    def test_repetition_penalty(self):
        logits = _rand_logits(b=2, v=30, seed=2)
        counts = np.zeros((2, 30), np.int32)
        for b, ids in enumerate([[1, 5, 5, 9], [0, 2, 29, 2]]):
            for t in ids:
                counts[b, t] += 1
        _same(P.apply_repetition_penalty(_t(logits), _t(counts), 1.7),
              J.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(counts), 1.7))

    def test_presence_frequency(self):
        logits = _rand_logits(b=1, v=8, seed=3)
        counts = np.array([[0, 1, 3, 0, 2, 0, 0, 1]], np.int32)
        _same(P.apply_presence_frequency(_t(logits), _t(counts), 0.5, 0.25),
              J.apply_presence_frequency(jnp.asarray(logits), jnp.asarray(counts), 0.5, 0.25),
              rtol=1e-6)


def _both(kw, b, v, **init):
    """The same params and initial state in both packages."""
    pj, pp = J.params_from_kwargs(**kw), P.params_from_kwargs(**kw)
    assert pj.greedy == pp.greedy and pj.trivial == pp.trivial
    return pj, J.init_state(pj, b, v, **init), pp, P.init_state(pp, b, v, **init)


class TestProcessLogits:
    @pytest.mark.parametrize("kw", [
        dict(temperature=0.8, do_sample=True, top_k=10, top_p=0.9, repetition_penalty=1.3),
        dict(temperature=1.3, do_sample=True, top_p=0.7, min_p=0.05, presence_penalty=0.4,
             frequency_penalty=0.2),
        dict(temperature=0.0, repetition_penalty=1.2, logit_bias={3: 4.5, 17: -2.0, 99: 1.0}),
        dict(temperature=0.6, do_sample=True, top_k=3, min_p=0.2, logit_bias={0: 2.0}),
    ])
    def test_full_chain(self, kw):
        logits = _rand_logits(b=2, v=40, seed=4)
        prompt = np.array([[3, 7], [11, 11]])
        pj, sj, pp, sp = _both(kw, 2, 40, prompt_ids=prompt)
        _same(P.process_logits(_t(logits), sp, pp),
              J.process_logits(jnp.asarray(logits), sj, pj), rtol=1e-6)

    def test_logit_bias_forces_and_bans_greedy(self):
        logits = _rand_logits(b=1, v=20, seed=22)
        base = int(np.argmax(logits[0]))
        forced = (base + 7) % 20
        pj, sj, pp, sp = _both(dict(temperature=0.0, logit_bias={forced: 100.0, base: -100.0}),
                               1, 20)
        assert not pp.trivial
        out, _ = P.sample_step(_t(logits), sp, pp)
        jout, _ = J.sample_step(jnp.asarray(logits), sj, pj)
        assert int(out.token[0]) == int(jout.token[0]) == forced

    def test_params_normalization_is_hashable(self):
        a = P.params_from_kwargs(logit_bias={7: 1.0, 2: -1.0})
        b = P.params_from_kwargs(logit_bias={2: -1.0, 7: 1.0})
        assert a == b and hash(a) == hash(b)
        assert P.params_from_kwargs(logit_bias={}).logit_bias is None
        assert a.logit_bias == J.params_from_kwargs(logit_bias={7: 1.0, 2: -1.0}).logit_bias


class TestSampleStep:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_token_equals_jax_with_jax_noise(self, seed):
        kw = dict(temperature=0.9, do_sample=True, top_k=12, top_p=0.9,
                  presence_penalty=0.3, repetition_penalty=1.1)
        logits = _rand_logits(b=4, v=64, seed=10 + seed)
        prompt = np.array([[1, 2], [3, 3], [5, 0], [7, 9]])
        pj, sj, pp, sp = _both(kw, 4, 64, prompt_ids=prompt)
        sj = sj._replace(key=jax.random.PRNGKey(seed))
        jout, sj2 = J.sample_step(jnp.asarray(logits), sj, pj)
        _, sub = jax.random.split(sj.key)
        noise = np.asarray(jax.random.gumbel(sub, logits.shape))
        out, sp2 = P.sample_step(_t(logits), sp, pp, noise=_t(noise))
        np.testing.assert_array_equal(out.token.numpy(), np.asarray(jout.token))
        np.testing.assert_array_equal(sp2.counts_full.numpy(), np.asarray(sj2.counts_full))
        np.testing.assert_array_equal(sp2.counts_gen.numpy(), np.asarray(sj2.counts_gen))

    def test_greedy_ignores_filters(self):
        pp = P.params_from_kwargs(temperature=0.0, top_k=5, top_p=0.9)
        assert pp.greedy
        logits = _rand_logits(b=2, v=20)
        out, _ = P.sample_step(_t(logits), P.init_state(pp, 2, 20), pp)
        np.testing.assert_array_equal(out.token.numpy(), np.argmax(logits, -1))

    def test_top_k_one_is_greedy(self):
        pp = P.params_from_kwargs(temperature=1.0, do_sample=True, top_k=1)
        logits = _rand_logits(b=4, v=33, seed=5)
        out, _ = P.sample_step(_t(logits), P.init_state(pp, 4, 33, seed=7), pp)
        np.testing.assert_array_equal(out.token.numpy(), np.argmax(logits, -1))

    def test_deterministic_given_seed(self):
        pp = P.params_from_kwargs(temperature=1.0, do_sample=True, top_p=0.9)
        logits = _t(_rand_logits(b=2, v=64, seed=6))
        draws = [P.sample_step(logits, P.init_state(pp, 2, 64, seed=s), pp)[0].token
                 for s in (3, 3, 4)]
        assert torch.equal(draws[0], draws[1])
        many = torch.stack([P.sample_step(logits, P.init_state(pp, 2, 64, seed=s), pp)[0].token
                            for s in range(20)])
        assert len(set(many[:, 0].tolist())) > 1  # the seed moves the draw

    def test_counts_update(self):
        kw = dict(temperature=0.0, presence_penalty=0.5, repetition_penalty=1.2)
        logits = _rand_logits(b=1, v=10, seed=8)
        pj, sj, pp, sp = _both(kw, 1, 10, prompt_ids=np.array([[2, 2, 4]]))
        np.testing.assert_array_equal(sp.counts_full.numpy(), np.asarray(sj.counts_full))
        out, sp = P.sample_step(_t(logits), sp, pp)
        jout, sj = J.sample_step(jnp.asarray(logits), sj, pj)
        assert int(out.token[0]) == int(jout.token[0])
        np.testing.assert_array_equal(sp.counts_full.numpy(), np.asarray(sj.counts_full))
        np.testing.assert_array_equal(sp.counts_gen.numpy(), np.asarray(sj.counts_gen))

    def test_logprobs(self):
        logits = _rand_logits(b=2, v=12, seed=9)
        pj, sj, pp, sp = _both(dict(temperature=0.0, logprobs=3), 2, 12)
        out, _ = P.sample_step(_t(logits), sp, pp)
        jout, _ = J.sample_step(jnp.asarray(logits), sj, pj)
        np.testing.assert_allclose(out.logprob.numpy(), np.asarray(jout.logprob), atol=1e-5)
        np.testing.assert_allclose(out.top_logprobs.numpy(), np.asarray(jout.top_logprobs),
                                   atol=1e-5)
        np.testing.assert_array_equal(out.top_tokens.numpy(), np.asarray(jout.top_tokens))
        np.testing.assert_array_equal(out.top_tokens[:, 0].numpy(), out.token.numpy())


class TestRows:
    def _rows(self, temps, top_k, top_p, min_p, rep, pres, freq):
        args = (temps, top_k, top_p, min_p, rep, pres, freq)
        return J.RowParams.from_lists(*args), P.RowParams.from_lists(*args)

    def test_sample_rows_equals_jax_with_jax_noise(self):
        B, V = 4, 48
        logits = _rand_logits(b=B, v=V, seed=31)
        rng = np.random.default_rng(3)
        cf = rng.integers(0, 3, (B, V)).astype(np.int32)
        cg = np.minimum(cf, rng.integers(0, 2, (B, V))).astype(np.int32)
        bias = np.zeros((B, V), np.float32)
        bias[1, 7] = 3.0
        rj, rp = self._rows([0.0, 0.7, 1.2, 0.9], [0, 5, 0, 10], [1.0, 0.8, 0.95, 0.5],
                            [0.0, 0.0, 0.1, 0.0], [1.0, 1.3, 1.0, 1.1], [0.0, 0.2, 0.0, 0.5],
                            [0.0, 0.1, 0.3, 0.0])
        seeds, counters = [0, 11, 12, 13], [0, 4, 0, 9]
        jt = J.sample_rows(jnp.asarray(logits), jnp.asarray(seeds, jnp.int32),
                           jnp.asarray(counters, jnp.int32), jnp.asarray(cf), jnp.asarray(cg),
                           rj, jnp.asarray(bias))
        noise = np.stack([np.asarray(jax.random.gumbel(
            jax.random.fold_in(jax.random.PRNGKey(s), c), (V,))) for s, c in zip(seeds, counters)])
        pt = P.sample_rows(_t(logits), seeds, counters, _t(cf), _t(cg), rp, _t(bias),
                           noise=_t(noise))
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))

    def test_min_p_in_row_sampler(self):
        logits = _rand_logits(b=2, v=24, seed=14)
        _, rp = self._rows([1.0, 1.0], [0, 0], [1.0, 1.0], [0.999, 0.0], [1.0, 1.0],
                           [0.0, 0.0], [0.0, 0.0])
        z = torch.zeros((2, 24), dtype=torch.int32)
        toks = P.sample_rows(_t(logits), [1, 2], [0, 0], z, z, rp)
        assert int(toks[0]) == int(np.argmax(logits[0]))

    def test_bias_in_row_sampler(self):
        logits = _rand_logits(b=2, v=24, seed=23)
        bias = np.zeros((2, 24), np.float32)
        bias[0, 5] = 100.0
        _, rp = self._rows([0.0, 0.0], [0, 0], [1.0, 1.0], [0.0, 0.0], [1.0, 1.0],
                           [0.0, 0.0], [0.0, 0.0])
        z = torch.zeros((2, 24), dtype=torch.int32)
        toks = P.sample_rows(_t(logits), [None, None], [0, 0], z, z, rp, _t(bias)).numpy()
        assert toks[0] == 5 and toks[1] == int(np.argmax(logits[1]))

    def test_row_draws_depend_on_seed_and_counter_only(self):
        """A row samples the same whatever its neighbours are."""
        logits = _rand_logits(b=3, v=40, seed=15)
        _, rp = self._rows([1.0] * 3, [0] * 3, [1.0] * 3, [0.0] * 3, [1.0] * 3, [0.0] * 3,
                           [0.0] * 3)
        z = torch.zeros((3, 40), dtype=torch.int32)
        a = P.sample_rows(_t(logits), [5, 6, 7], [2, 0, 1], z, z, rp)
        b = P.sample_rows(_t(logits), [5, 9, 8], [2, 4, 1], z, z, rp)
        assert int(a[0]) == int(b[0]) and int(a[2]) == int(b[2])

    def test_update_and_reset_counts(self):
        B, V, W = 3, 10, 2
        toks = np.array([[1, 2], [3, 3], [4, 0]])
        valid = np.array([[True, True], [True, False], [True, True]])
        gen = np.array([[True, False], [False, False], [True, True]])
        z = np.zeros((B, V), np.int32)
        jf, jg = J.update_counts(jnp.asarray(z), jnp.asarray(z), jnp.asarray(toks),
                                 jnp.asarray(valid), jnp.asarray(gen))
        pf, pg = P.update_counts(_t(z.copy()), _t(z.copy()), _t(toks), _t(valid), _t(gen))
        np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
        keep = np.array([True, False, True])
        jf, jg = J.reset_rows(jf, jg, jnp.asarray(keep))
        pf, pg = P.reset_rows(pf, pg, _t(keep.astype(np.int32)))
        np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))


# ---------------------------------------------------------------------------
# sampled generation on a tiny Mixtral (weights from the JAX init_random)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_mixtral():
    from moe_infinity_tpu.models.mixtral import MixtralModel as JM
    from moe_infinity_tpu.models.mixtral import MixtralSpec
    from moe_infinity_tpu.runtime.providers import ResidentProvider as JRP
    from moe_infinity_tpu_torch.models.mixtral import MixtralModel as PM
    from moe_infinity_tpu_torch.runtime.providers import ResidentProvider as PRP
    from torch_port_helpers import to_port

    spec = MixtralSpec(vocab_size=64, hidden_size=32, intermediate_size=56, num_layers=2,
                       num_heads=4, num_kv_heads=2, head_dim=8, num_experts=4, top_k=2,
                       rms_eps=1e-6, rope_theta=1e4, tie_embeddings=False)
    jm = JM(spec, compute_dtype=jnp.float32)
    params, experts = jm.init_random(jax.random.PRNGKey(11))
    pm = PM(spec, compute_dtype=torch.float32, device="cpu")
    return (jm, params, experts, JRP.for_layer), (pm, to_port(params), to_port(experts),
                                                  PRP.for_layer)


def test_sampled_generator_deterministic_and_logprobs(tiny_mixtral):
    from moe_infinity_tpu.runtime.generate import Generator as JG
    from moe_infinity_tpu_torch.runtime.generate import Generator as PG

    _, port = tiny_mixtral
    gen = PG(*port)
    ids = np.array([[5, 9, 3]])
    kw = dict(max_new_tokens=8, temperature=0.9, do_sample=True, top_k=10, top_p=0.95,
              repetition_penalty=1.1, presence_penalty=0.2, frequency_penalty=0.1)
    a = gen.generate(ids, seed=4, **kw).sequences
    b = gen.generate(ids, seed=4, **kw).sequences
    assert a.shape == (1, 11)
    np.testing.assert_array_equal(a, b)
    assert not all(np.array_equal(a, gen.generate(ids, seed=s, **kw).sequences)
                   for s in (5, 6, 7))
    # logprobs of a greedy run: tokens, chosen and top logprobs against JAX
    ids2 = np.array([[5, 9, 3], [2, 7, 1]])
    r = gen.generate(ids2, max_new_tokens=4, logprobs=5)
    jr = JG(*tiny_mixtral[0]).generate(ids2, max_new_tokens=4, logprobs=5)
    np.testing.assert_array_equal(r.sequences, jr.sequences)
    assert r.top_logprobs.shape == (2, 4, 5)
    np.testing.assert_array_equal(r.top_tokens, jr.top_tokens)
    np.testing.assert_allclose(r.token_logprobs, jr.token_logprobs, atol=1e-5)
    np.testing.assert_allclose(r.top_logprobs, jr.top_logprobs, atol=1e-5)
    np.testing.assert_array_equal(r.top_tokens[:, :, 0], r.sequences[:, 3:])
    # greedy penalised and biased runs equal JAX's token for token
    for kw2 in (dict(repetition_penalty=1.5, presence_penalty=0.5),
                dict(logit_bias={7: 100.0}), dict(logit_bias={int(r.sequences[0, 3]): -100.0})):
        np.testing.assert_array_equal(
            gen.generate(ids, max_new_tokens=6, **kw2).sequences,
            JG(*tiny_mixtral[0]).generate(ids, max_new_tokens=6, **kw2).sequences)


def test_sampled_requests_through_the_batcher(tiny_mixtral):
    """Per-request sampling in the continuous batcher: a sampled request
    gives the same tokens alone and beside other requests; greedy and
    penalised greedy requests equal the JAX Generator's."""
    import concurrent.futures as cf

    from moe_infinity_tpu.runtime.generate import Generator as JG
    from moe_infinity_tpu_torch.runtime.continuous import ContinuousBatcher

    _, (pm, params, experts, for_layer) = tiny_mixtral
    bat = ContinuousBatcher(pm, params, experts, for_layer, max_batch_size=3, page_size=8,
                            num_pages=32, max_cols=64, prefill_chunk=4)
    try:
        sampled = dict(temperature=0.9, top_k=10, top_p=0.9, seed=3)
        alone = bat.generate(np.array([5, 9, 3]), max_new_tokens=6, **sampled)
        p_pen, p_bias = np.array([7, 2, 11, 4]), np.array([1, 8])
        with cf.ThreadPoolExecutor(3) as ex:
            f_s = ex.submit(bat.generate, np.array([5, 9, 3]), max_new_tokens=6, **sampled)
            f_p = ex.submit(bat.generate, p_pen, max_new_tokens=5, repetition_penalty=1.5,
                            frequency_penalty=0.3)
            f_b = ex.submit(bat.generate, p_bias, max_new_tokens=4, logit_bias={9: 100.0})
            together, pen, biased = f_s.result(), f_p.result(), f_b.result()
        np.testing.assert_array_equal(alone, together)
        jg = JG(*tiny_mixtral[0])
        want = jg.generate(p_pen[None], max_new_tokens=5, repetition_penalty=1.5,
                           frequency_penalty=0.3).sequences[0]
        np.testing.assert_array_equal(pen, want)
        assert (biased[2:] == 9).all()
    finally:
        bat.shutdown()
