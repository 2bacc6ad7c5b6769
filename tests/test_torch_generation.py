"""``inference/generation.py`` of the port against the JAX package's.

Greedy generation is held to identity: llama-tiny and gpt2-tiny in f32
(cache dtype f32 on both sides), through the dense and the paged
generators, with and without EOS padding, and ``greedy_draft_fn``'s
drafts.  ``cached_attention`` is held at 1e-5 (the same f32 einsums and
softmax, summed in another order).  Sampling draws from a
``torch.Generator`` (JAX's threefry bits have no PyTorch twin), so top-k
and top-p are held to their support: every draw lies inside the kept set,
and a row whose kept set is one token always draws it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import generation as jgen
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu_torch.inference import generation as tgen
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params, init_params

torch.set_num_threads(1)

FAMILIES = {"llama": (jl, tl, "llama"), "gpt2": (jg, tg, "gpt2")}


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jm, tm, prefix) in FAMILIES.items():
        cfg = (jm.LlamaConfig if name == "llama" else jm.GPT2Config).tiny()
        tcfg = (tm.LlamaConfig if name == "llama" else tm.GPT2Config).tiny()
        jp = jax.device_get(jm.init_params(jax.random.PRNGKey(3), cfg))
        out[name] = (prefix, cfg, tcfg, jp, from_jax_params(jp, device="cpu"))
    return out


def _prompts(B=3, T=7, seed=0):
    return np.random.default_rng(seed).integers(1, 256, (B, T)).astype(
        np.int32)


def _generators(models, family, paged, eos=None):
    prefix, cfg, tcfg, jp, tp = models[family]
    kind = "_paged_generator" if paged else "_generator"
    extra = dict(page_size=8) if paged else {}
    jgen_ = getattr(jgen, prefix + kind)(jp, cfg, eos_token_id=eos,
                                         cache_dtype=jnp.float32, **extra)
    tgen_ = getattr(tgen, prefix + kind)(tp, tcfg, eos_token_id=eos,
                                         cache_dtype=torch.float32,
                                         device="cpu", **extra)
    return jgen_, tgen_


@pytest.mark.parametrize("family", ["llama", "gpt2"])
@pytest.mark.parametrize("paged", [False, True])
def test_greedy_generate_identical_to_jax(models, family, paged):
    jg_, tg_ = _generators(models, family, paged)
    prompts = _prompts()
    want = np.asarray(jg_.generate(jnp.asarray(prompts), max_new_tokens=9))
    got = tg_.generate(prompts, max_new_tokens=9)
    assert got.dtype == torch.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    # a token the rows emit, as EOS: finished rows pad with it
    eos = int(want[1, 7 + 2])
    jg_, tg_ = _generators(models, family, paged, eos=eos)
    want = np.asarray(jg_.generate(jnp.asarray(prompts), max_new_tokens=9))
    got = tg_.generate(prompts, max_new_tokens=9).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1, 7 + 2:] == eos).all()


def test_all_rows_at_eos_stop_early_and_pad(models):
    _, tg_ = _generators(models, "gpt2", False)
    prompts = _prompts(B=1)
    first = int(tg_.generate(prompts, max_new_tokens=1)[0, -1])
    jg_, tg_ = _generators(models, "gpt2", False, eos=first)
    got = tg_.generate(prompts, max_new_tokens=6).numpy()
    want = np.asarray(jg_.generate(jnp.asarray(prompts), max_new_tokens=6))
    np.testing.assert_array_equal(got, want)
    assert (got[0, 7:] == first).all() and got.shape == (1, 13)


def test_cached_attention_matches_jax():
    rng = np.random.default_rng(1)
    B, T, H, KV, D, maxT, start = 2, 3, 4, 2, 16, 12, 5
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    kc = rng.normal(size=(B, maxT, KV, D)).astype(np.float32)
    vc = rng.normal(size=(B, maxT, KV, D)).astype(np.float32)
    nk = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    nv = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    jo, jk, jv = jgen.cached_attention(*map(jnp.asarray, (q, kc, vc, nk, nv)),
                                       start)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, tk2, tv2 = tgen.cached_attention(torch.from_numpy(q), tk, tv,
                                         torch.from_numpy(nk),
                                         torch.from_numpy(nv), start)
    assert tk2 is tk and tv2 is tv                # written in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # a start past the end clamps the write as dynamic_update_slice does
    jo, jk, _ = jgen.cached_attention(*map(jnp.asarray, (q, kc, vc, nk, nv)),
                                      11)
    tk = torch.from_numpy(kc.copy())
    to, _, _ = tgen.cached_attention(torch.from_numpy(q), tk,
                                     torch.from_numpy(vc.copy()),
                                     torch.from_numpy(nk),
                                     torch.from_numpy(nv), 11)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)


def test_budget_and_position_table_raise(models):
    _, tg_ = _generators(models, "llama", False)
    with pytest.raises(ValueError, match="KV cache budget"):
        tg_.generate(_prompts(), max_new_tokens=9, max_seq=12)
    for paged in (False, True):
        _, tg_ = _generators(models, "gpt2", paged)
        with pytest.raises(ValueError, match="position table"):
            tg_.generate(_prompts(T=120), max_new_tokens=9)
        assert tg_.generate(_prompts(T=119), max_new_tokens=9).shape == \
            (3, 128)
    jg_, _ = _generators(models, "gpt2", False)
    with pytest.raises(ValueError, match="position table"):
        jg_.generate(jnp.asarray(_prompts(T=120)), max_new_tokens=9)


@pytest.mark.parametrize("cache", ["KVCache", "PagedKVCache"])
def test_cache_alloc_defaults_to_cuda(cache, monkeypatch):
    """``device=None`` means CUDA for both caches, so without CUDA the
    allocation raises instead of building a CPU cache."""
    from deepspeed_tpu_torch.inference.kernels import PagedKVCache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cache == "KVCache":
        alloc = functools.partial(tgen.KVCache.alloc, 2, 2, 4, 8, 16)
    else:
        alloc = functools.partial(PagedKVCache.alloc, 2, 2, 8, 4, 8, 2, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        alloc()
    assert alloc(device="cpu").k.device.type == "cpu"


def test_top_k_and_top_p_draw_inside_the_kept_set():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (4, 64)).astype(np.float32)
    logits[3] = -10.0
    logits[3, 17] = 10.0                          # top-p keeps one token
    t = torch.from_numpy(logits)
    gen = torch.Generator().manual_seed(0)
    order = np.argsort(-logits, axis=-1)
    top5 = [set(order[b, :5]) for b in range(4)]
    probs = np.exp(logits / 0.7 - (logits / 0.7).max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    nucleus = []
    for b in range(4):
        p = probs[b, order[b]]
        keep = np.cumsum(p) - p < 0.6
        nucleus.append(set(order[b][keep]))
    seen_k, seen_p = set(), set()
    for _ in range(200):
        k = tgen.sample_logits(t, gen, temperature=0.7, top_k=5).numpy()
        p = tgen.sample_logits(t, gen, temperature=0.7, top_p=0.6).numpy()
        assert k.dtype == np.int32 and p.dtype == np.int32
        for b in range(4):
            assert k[b] in top5[b] and p[b] in nucleus[b]
        assert p[3] == 17
        seen_k.add(int(k[0]))
        seen_p.add(int(p[0]))
    assert len(seen_k) > 1 and seen_p == nucleus[0]
    greedy = tgen.sample_logits(t, gen, temperature=0.0).numpy()
    np.testing.assert_array_equal(greedy, np.asarray(jnp.argmax(
        jnp.asarray(logits), axis=-1)))


@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_greedy_draft_fn_equal_to_jax(models, family):
    _, cfg, tcfg, jp, tp = models[family]
    jstep, jalloc = jgen.cached_step_alloc(
        (jl if family == "llama" else jg).forward_with_cache, cfg,
        jnp.float32)
    tstep, talloc = tgen.cached_step_alloc(
        (tl if family == "llama" else tg).forward_with_cache, tcfg,
        torch.float32, device="cpu")
    window = _prompts(B=2, T=6, seed=4)
    want = np.asarray(jgen.greedy_draft_fn(jstep, jalloc, 6, 4)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(window)))
    got = tgen.greedy_draft_fn(tstep, talloc, 6, 4)(
        tp, torch.from_numpy(window))
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mixtral_builders_wait_for_their_model():
    """models/mixtral.py has landed: both functions return generators
    (their tokens are held to JAX's in test_torch_serving_mixtral.py)."""
    from deepspeed_tpu_torch.models.mixtral import MixtralConfig

    cfg = MixtralConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    prompt = _prompts(B=2, T=5, seed=2)
    for fn, kw in ((tgen.mixtral_generator, {}),
                   (tgen.mixtral_paged_generator, {"page_size": 8})):
        gen = fn(params, cfg, cache_dtype=torch.float32, device="cpu", **kw)
        assert isinstance(gen, tgen.Generator)
        out = gen.generate(prompt, max_new_tokens=3)
        assert out.shape == (2, 8)
        np.testing.assert_array_equal(out[:, :5].numpy(), prompt)
