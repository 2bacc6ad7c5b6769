"""The port's speculative decoding against the JAX package's
(``deepspeed_tpu/inference/speculative.py``), on tiny f32 models (caches
f32 on both sides).

Greedy is EXACT: the drafters propose what JAX's propose, ``verify_accept``
returns JAX's accepted lengths and stop tokens on greedy rows, and every
engine flavour (plain, chunked decode, split-fuse, int8, prefix cache,
ZeRO-Inference, a model drafter, empty proposals, preemption) emits with
speculation on the tokens it emits with speculation off, and the JAX
engine's.  Temperature rows are distributional (the port draws from a
``torch.Generator``, JAX from its keys, C-w1): over 4000 seeded rows the
emitted first token's frequencies lie within 5 sigma (at least 0.01) of
``softmax(logits / T)``, as the JAX test bounds them, and their total
variation from it within 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config import SpeculativeConfig as JSpeculativeConfig
from deepspeed_tpu.inference import speculative as js
from deepspeed_tpu.inference.serving import (gpt2_serving_engine as
                                             jax_gpt2_engine,
                                             llama_serving_engine as
                                             jax_llama_engine)
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu_torch.config import Config, SpeculativeConfig
from deepspeed_tpu_torch.inference import speculative as ts
from deepspeed_tpu_torch.inference.kernels import PageAllocator
from deepspeed_tpu_torch.inference.serving import (gpt2_serving_engine,
                                                   llama_serving_engine,
                                                   serving_engine)
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

KW = dict(max_batch=2, page_size=8, num_pages=32, max_seq=64,
          prefill_bucket=8)
# a repetitive prompt (the n-gram drafter matches the motif), and
# irregular ones that exercise rejection and the empty proposal
PROMPTS = {
    "rep": ([7, 8, 9, 7, 8, 9, 7, 8], 10),
    "plain": ([5, 9, 2], 6),
    "mixed": ([17, 3, 3, 8, 1], 5),
}


@pytest.fixture(scope="module")
def gpt2_model():
    cfg = jg.GPT2Config.tiny(dim=64, n_layers=2, n_heads=4, max_seq_len=64)
    jp = jg.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tg.GPT2Config.tiny(dim=64, n_layers=2, n_heads=4, max_seq_len=64)
    return cfg, tcfg, jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def llama_model():
    cfg = jl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    jp = jl.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tl.LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    return cfg, tcfg, jp, from_jax_params(jax.device_get(jp), device="cpu")


def serve_all(eng, prompts=PROMPTS, temperature=0.0):
    for rid, (p, n) in prompts.items():
        eng.submit(rid, p, max_new_tokens=n, temperature=temperature)
    out = eng.run()
    assert eng.check_leaks() == []
    return out


def port(builder, tp, tcfg, **kw):
    return builder(tp, tcfg, device="cpu", cache_dtype=torch.float32,
                   **dict(KW, **kw))


def jax_ref(builder, jp, cfg, **kw):
    return builder(jp, cfg, cache_dtype=jnp.float32, **dict(KW, **kw))


# ---------------------------------------------------------------- drafter
NGRAM_CASES = [
    # (max_ngram, min_ngram, history, k)
    (3, 1, [1, 2, 3, 9, 4, 1, 2, 3], 2),       # longest match wins
    (2, 2, [1, 2, 5, 1, 2, 6, 1, 2], 1),       # most recent occurrence
    (3, 1, [4, 9, 1, 2, 4], 2),                # shorter n-gram fallback
    (3, 1, [1, 2, 3, 4, 5], 4),                # nothing matches
    (3, 2, [1, 2], 4),                         # short history
    (3, 2, [1, 2, 1, 2], 0),                   # k = 0
    (2, 1, [3, 7, 3], 8),                      # self-extension on a loop
    (2, 1, [1, 2, 9, 1, 2], 6),                # history, then the cycle
]


class TestNgramDrafter:
    @pytest.mark.parametrize("case", NGRAM_CASES)
    def test_proposes_what_jax_proposes(self, case):
        mx, mn, toks, k = case
        want = js.NgramDrafter(max_ngram=mx, min_ngram=mn).propose(toks, k)
        assert ts.NgramDrafter(max_ngram=mx, min_ngram=mn).propose(
            toks, k) == want

    def test_expected_drafts(self):
        d = ts.NgramDrafter(max_ngram=3, min_ngram=1)
        assert d.propose([1, 2, 3, 9, 4, 1, 2, 3], 2) == [9, 4]
        assert ts.NgramDrafter(max_ngram=2, min_ngram=1).propose(
            [3, 7, 3], 8) == [7, 3, 7, 3, 7, 3, 7, 3]

    def test_random_histories_match_jax(self):
        rng = np.random.default_rng(3)
        for _ in range(200):
            toks = rng.integers(0, 5, rng.integers(0, 40)).tolist()
            k = int(rng.integers(0, 7))
            lb = int(rng.integers(1, 30))
            assert ts.NgramDrafter(3, 1, lookback=lb).propose(toks, k) == \
                js.NgramDrafter(3, 1, lookback=lb).propose(toks, k)

    def test_validation(self):
        with pytest.raises(ValueError, match="min_ngram"):
            ts.NgramDrafter(max_ngram=2, min_ngram=3)
        with pytest.raises(ValueError, match="min_ngram"):
            ts.NgramDrafter(max_ngram=2, min_ngram=0)
        with pytest.raises(ValueError, match="lookback"):
            ts.NgramDrafter(lookback=0)


class TestModelDrafter:
    def test_propose_matches_jax(self, gpt2_model):
        cfg, tcfg, jp, tp = gpt2_model
        jd = js.ModelDrafter(jp, cfg, draft_tokens=3, window=16)
        d = ts.ModelDrafter(tp, tcfg, draft_tokens=3, window=16,
                            device="cpu")
        for hist in ([5, 9, 2, 7, 7, 2], [1], list(range(3, 30))):
            out = d.propose(hist, 3)
            assert len(out) == 3 and all(isinstance(t, int) for t in out)
            assert out == jd.propose(hist, 3)
            assert d.propose(hist, 3) == out          # deterministic
            assert d.propose(hist, 2) == out[:2]      # k clamps
        assert d.propose([5, 9], 0) == []

    def test_unknown_family_rejected(self):
        with pytest.raises(TypeError, match="no draft forward"):
            ts.ModelDrafter({}, object(), draft_tokens=2, device="cpu")


# ----------------------------------------------------------------- config
class TestSpeculativeConfig:
    def test_coerce_forms(self):
        assert not SpeculativeConfig.coerce(None).enabled
        assert SpeculativeConfig.coerce(True).enabled
        assert not SpeculativeConfig.coerce(False).enabled
        sc = SpeculativeConfig.coerce({"draft_tokens": 6})
        assert sc.enabled and sc.draft_tokens == 6
        assert SpeculativeConfig.coerce(sc) is sc
        with pytest.raises(TypeError):
            SpeculativeConfig.coerce(3)

    def test_build_drafter_like_jax(self):
        d = ts.build_drafter(SpeculativeConfig.coerce(
            {"max_ngram": 4, "min_ngram": 2}))
        assert isinstance(d, ts.NgramDrafter)
        assert (d.max_ngram, d.min_ngram) == (4, 2)
        with pytest.raises(ValueError) as want:
            js.build_drafter(JSpeculativeConfig(enabled=True,
                                                drafter="model"))
        with pytest.raises(ValueError) as got:
            ts.build_drafter(SpeculativeConfig(enabled=True,
                                               drafter="model"))
        assert str(got.value) == str(want.value)

    def test_config_block_reaches_init_serving(self, gpt2_model):
        from deepspeed_tpu_torch import init_serving

        cfg, tcfg, jp, tp = gpt2_model
        c = Config.from_dict({"speculative": {"draft_tokens": 3}})
        eng = init_serving(tp, tcfg, config=c, device="cpu", **KW)
        assert eng._spec_on and eng.speculative.draft_tokens == 3
        assert isinstance(eng.drafter, ts.NgramDrafter)

    def test_needs_chunk_prefill_fn(self):
        from deepspeed_tpu_torch.inference.serving import ServingEngine

        with pytest.raises(ValueError, match="chunk_prefill_fn"):
            ServingEngine(None, None, None, n_layers=1, n_kv=1, head_dim=8,
                          device="cpu", speculative=True)

    def test_encoder_families_reject_speculation(self):
        from deepspeed_tpu_torch.models.bert import BertConfig

        with pytest.raises(NotImplementedError, match="speculative"):
            serving_engine({}, BertConfig.tiny(dim=32, n_layers=1,
                                               n_heads=2),
                           speculative=True, device="cpu")


# ----------------------------------------------------------- verify math
def _keys(n, k1, seed=0):
    return jax.random.split(jax.random.PRNGKey(seed),
                            n * k1).reshape(n, k1, 2)


def _both(lg, drafts, dlens, temps, seed=0):
    """(port, JAX) verify_accept results as numpy."""
    n, k1 = lg.shape[:2]
    jn, jstop = js.verify_accept(jnp.asarray(lg), jnp.asarray(drafts),
                                 jnp.asarray(dlens), _keys(n, k1, seed),
                                 jnp.asarray(temps))
    tn, tstop = ts.verify_accept(torch.from_numpy(lg),
                                 torch.from_numpy(drafts),
                                 torch.from_numpy(dlens),
                                 torch.Generator().manual_seed(seed), temps)
    return (tn.numpy(), tstop.numpy()), (np.asarray(jn), np.asarray(jstop))


class TestVerifyAccept:
    def test_greedy_full_accept_and_bonus(self):
        V, K = 11, 3
        lg = np.full((1, K + 1, V), -10.0, np.float32)
        for j in range(K + 1):
            lg[0, j, j + 1] = 10.0
        (n, stop), (jn, jstop) = _both(lg, np.array([[1, 2, 3]], np.int32),
                                       np.array([3], np.int32),
                                       np.zeros((1,), np.float32))
        assert n[0] == 3 and stop[0, 3] == 4
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(stop, jstop)

    def test_greedy_rejection_takes_target_argmax(self):
        V, K = 11, 3
        lg = np.full((1, K + 1, V), -10.0, np.float32)
        for j in range(K + 1):
            lg[0, j, j + 1] = 10.0
        (n, stop), _ = _both(lg, np.array([[1, 9, 3]], np.int32),
                             np.array([3], np.int32),
                             np.zeros((1,), np.float32))
        assert n[0] == 1 and stop[0, 1] == 2

    def test_empty_draft_is_plain_decode_step(self):
        V, K = 7, 2
        lg = np.full((2, K + 1, V), -5.0, np.float32)
        lg[:, 0, 4] = 5.0
        (n, stop), _ = _both(lg, np.zeros((2, K), np.int32),
                             np.zeros((2,), np.int32),
                             np.zeros((2,), np.float32))
        assert np.all(n == 0) and np.all(stop[:, 0] == 4)

    def test_greedy_rows_equal_jax_on_random_inputs(self):
        """Random logits with planted ties (first occurrence wins on both
        sides), drafts that follow the argmax for a random prefix."""
        rng = np.random.default_rng(0)
        B, K, V = 16, 4, 50
        lg = rng.standard_normal((B, K + 1, V)).astype(np.float32)
        lg[:4, :, 7] = lg[:4, :, 3] = 9.0        # ties: 3 wins
        am = lg.argmax(-1)
        drafts = rng.integers(0, V, (B, K)).astype(np.int32)
        for b in range(B):
            j = rng.integers(0, K + 1)
            drafts[b, :j] = am[b, :j]
        dlens = rng.integers(0, K + 1, B).astype(np.int32)
        (n, stop), (jn, jstop) = _both(lg, drafts, dlens,
                                       np.zeros((B,), np.float32))
        np.testing.assert_array_equal(n, jn)
        np.testing.assert_array_equal(stop, jstop)

    def test_temperature_first_token_marginal_is_exact(self):
        N, V = 4000, 5
        logits = np.array([1.5, 0.2, -0.5, 0.8, -1.0], np.float32)
        temp = 0.7
        p = np.asarray(jax.nn.softmax(jnp.asarray(logits) / temp))
        d = 0
        lg = np.broadcast_to(logits, (N, 2, V)).copy()
        n, stop = ts.verify_accept(
            torch.from_numpy(lg), torch.full((N, 1), d),
            torch.ones((N,), dtype=torch.int32),
            torch.Generator().manual_seed(7), np.full((N,), temp))
        n, stop = n.numpy(), stop.numpy()
        emitted = np.where(n == 1, d, stop[:, 0])
        freq = np.bincount(emitted, minlength=V) / N
        tol = 5 * np.sqrt(p * (1 - p) / N)
        assert abs(n.mean() - p[d]) < tol[d], (n.mean(), p[d])
        assert np.all(np.abs(freq - p) < np.maximum(tol, 0.01)), (freq, p)
        assert 0.5 * np.abs(freq - p).sum() < 0.05

    def test_temperature_exhausted_draft_samples_full_target(self):
        N, V = 4000, 4
        logits = np.array([2.0, 0.0, -1.0, 1.0], np.float32)
        p = np.asarray(jax.nn.softmax(jnp.asarray(logits)))
        lg = np.broadcast_to(logits, (N, 2, V)).copy()
        _, stop = ts.verify_accept(torch.from_numpy(lg),
                                   torch.zeros((N, 1), dtype=torch.int64),
                                   torch.zeros((N,), dtype=torch.int32),
                                   torch.Generator().manual_seed(3),
                                   np.ones((N,), np.float32))
        freq = np.bincount(stop.numpy()[:, 0], minlength=V) / N
        assert np.all(np.abs(freq - p) < 0.05), freq
        assert 0.5 * np.abs(freq - p).sum() < 0.05

    def test_mixed_batch_greedy_rows_unaffected_by_draws(self):
        """Greedy rows of a batch that also draws keep JAX's greedy
        result, whatever the temperature rows drew."""
        rng = np.random.default_rng(1)
        B, K, V = 6, 3, 20
        lg = rng.standard_normal((B, K + 1, V)).astype(np.float32)
        drafts = lg[:, :K].argmax(-1).astype(np.int32)
        dlens = np.full((B,), K, np.int32)
        temps = np.array([0, 0.8, 0, 1.2, 0, 0.5], np.float32)
        (n, stop), (jn, jstop) = _both(lg, drafts, dlens, temps)
        g = temps == 0
        np.testing.assert_array_equal(n[g], jn[g])
        np.testing.assert_array_equal(stop[g], jstop[g])


# --------------------------------------------------------- greedy identity
class TestGreedyIdentity:
    """Speculation on must emit the greedy tokens of speculation off, and
    the JAX engine's, on every engine flavour."""

    def _check(self, model, builder, jbuilder, prompts=PROMPTS, **kw):
        cfg, tcfg, jp, tp = model
        want = serve_all(port(builder, tp, tcfg,
                              **{k: v for k, v in kw.items()
                                 if k not in ("speculative", "drafter")}),
                         prompts)
        eng = port(builder, tp, tcfg, **kw)
        got = serve_all(eng, prompts)
        jkw = {k: v for k, v in kw.items() if k != "drafter"}
        assert got == want == serve_all(jax_ref(jbuilder, jp, cfg, **jkw),
                                        prompts)
        return eng

    def test_plain_gpt2(self, gpt2_model):
        eng = self._check(gpt2_model, gpt2_serving_engine, jax_gpt2_engine,
                          speculative={"draft_tokens": 4})
        assert eng.spec_verify_sweeps > 0
        assert eng.spec_emitted_tokens == \
            eng.spec_accepted_tokens + eng.spec_verify_slots
        assert eng.spec_accepted_tokens + eng.spec_rejected_tokens == \
            eng.spec_drafted_tokens

    def test_chunked_decode_baseline(self, gpt2_model):
        self._check(gpt2_model, gpt2_serving_engine, jax_gpt2_engine,
                    decode_chunk=2, speculative={"draft_tokens": 3})

    def test_split_fuse(self, gpt2_model):
        long = {"long": (list(range(2, 21)), 6), **PROMPTS}
        self._check(gpt2_model, gpt2_serving_engine, jax_gpt2_engine,
                    prompts=long, prefill_chunk=4,
                    speculative={"draft_tokens": 3})

    def test_int8(self, gpt2_model):
        cfg, tcfg, jp, tp = gpt2_model
        want = serve_all(port(gpt2_serving_engine, tp, tcfg,
                              weight_dtype="int8", quant_group_size=16))
        got = serve_all(port(gpt2_serving_engine, tp, tcfg,
                             weight_dtype="int8", quant_group_size=16,
                             speculative={"draft_tokens": 4}))
        assert got == want

    def test_prefix_cache(self, gpt2_model):
        prefix = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
        prompts = {f"u{i}": (prefix + [20 + i, 30 + i], 8)
                   for i in range(4)}
        eng = self._check(gpt2_model, gpt2_serving_engine, jax_gpt2_engine,
                          prompts=prompts, prefix_cache=True,
                          speculative={"draft_tokens": 4})
        assert eng.prefix_cache_hits > 0

    def test_zero_inference(self, llama_model):
        """One verify sweep = one full layer-weight stream scoring K+1
        positions: token-identical to the resident engine, and with an
        oracle drafter (replaying the known output, so acceptance is
        perfect) the streamed bytes per generated token drop."""
        cfg, tcfg, jp, tp = llama_model
        want = serve_all(port(llama_serving_engine, tp, tcfg))
        zi = {"enabled": True, "tier": "host", "hbm_budget_bytes": None}
        base = port(llama_serving_engine, tp, tcfg, zero_inference=zi)
        assert serve_all(base) == want
        spec = port(llama_serving_engine, tp, tcfg, zero_inference=zi,
                    speculative={"draft_tokens": 4})
        assert serve_all(spec) == want == serve_all(jax_ref(
            jax_llama_engine, jp, cfg, zero_inference=zi,
            speculative={"draft_tokens": 4}))

        class Oracle(ts.Drafter):
            def propose(self, tokens, k):
                t = list(tokens)
                for full in want.values():
                    if full[:len(t)] == t:
                        return full[len(t):len(t) + k]
                return []

        orac = port(llama_serving_engine, tp, tcfg, zero_inference=zi,
                    drafter=Oracle(), speculative={"draft_tokens": 4})
        assert serve_all(orac) == want
        gen = sum(len(v) - len(PROMPTS[r][0]) for r, v in want.items())
        mean_len = orac.spec_emitted_tokens / orac.spec_verify_slots
        assert mean_len > 2.0, mean_len
        assert orac.zi_bytes_uploaded / gen < base.zi_bytes_uploaded / gen
        assert orac.spec_verify_sweeps * 2 <= base.decode_steps

    def test_model_drafter(self, gpt2_model):
        cfg, tcfg, jp, tp = gpt2_model
        drafter = ts.ModelDrafter(tp, tcfg, draft_tokens=3, window=16,
                                  device="cpu")
        eng = self._check(gpt2_model, gpt2_serving_engine, jax_gpt2_engine,
                          speculative={"drafter": "ngram",
                                       "draft_tokens": 3},
                          drafter=drafter)
        assert eng.drafter is drafter and eng.spec_drafted_tokens > 0

    def test_ngram_empty_proposals_degrade_gracefully(self, gpt2_model):
        eng = self._check(gpt2_model, gpt2_serving_engine, jax_gpt2_engine,
                          prompts={"d": ([11, 23, 37, 41], 4)},
                          speculative={"draft_tokens": 4, "max_ngram": 4})
        assert eng.spec_verify_sweeps > 0

    def test_speculation_still_emits_under_preemption(self, gpt2_model):
        eng = self._check(gpt2_model, gpt2_serving_engine, jax_gpt2_engine,
                          num_pages=14, speculative={"draft_tokens": 4})
        assert eng.spec_verify_sweeps > 0

    def test_llama_and_temperature_rows_finish(self, llama_model):
        cfg, tcfg, jp, tp = llama_model
        eng = port(llama_serving_engine, tp, tcfg,
                   speculative={"draft_tokens": 3})
        out = serve_all(eng, temperature=0.8)
        assert all(len(out[r]) == len(p) + n
                   for r, (p, n) in PROMPTS.items())


# -------------------------------------------------------- rollback safety
class TestRollbackCOW:
    def test_writable_semantics(self):
        a = PageAllocator(8, cache_pages=8)
        pages = a.allocate("s1", 2)
        assert a.writable(pages[0]) and a.writable(pages[1])
        a.publish(pages[0], b"k0")
        assert not a.writable(pages[0])
        a.share("s2", [pages[1]])
        assert not a.writable(pages[1])
        assert not a.writable(99)

    def test_frontier_guard_raises_on_published_page(self, gpt2_model):
        cfg, tcfg, jp, tp = gpt2_model
        eng = port(gpt2_serving_engine, tp, tcfg, prefix_cache=True,
                   speculative={"draft_tokens": 4})
        eng.submit("x", [5, 9, 2, 7, 1, 3, 2, 8, 4], max_new_tokens=8)
        eng.step()
        b, s = next((b, s) for b, s in enumerate(eng.slots)
                    if s is not None)
        frontier = int(eng._table_host[b, s.seq_len // eng.page_size])
        eng.allocator.publish(frontier, b"poison-test-key")
        with pytest.raises(RuntimeError, match="COW invariant"):
            eng._check_frontier_writable([(b, s)], 5)

    def test_rollback_never_mutates_published_pages(self, gpt2_model):
        cfg, tcfg, jp, tp = gpt2_model
        prefix = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
        eng = port(gpt2_serving_engine, tp, tcfg, prefix_cache=True,
                   speculative={"draft_tokens": 4})
        eng.submit("u0", prefix + [21, 31], max_new_tokens=8)
        eng.run()
        published = sorted(eng.allocator.key_of)
        assert published
        k_before = eng.cache.k[:, :, published].clone()
        v_before = eng.cache.v[:, :, published].clone()
        for i in range(1, 3):
            eng.submit(f"u{i}", prefix + [21 + i, 31 + i], max_new_tokens=8)
        eng.run()
        assert torch.equal(eng.cache.k[:, :, published], k_before)
        assert torch.equal(eng.cache.v[:, :, published], v_before)
