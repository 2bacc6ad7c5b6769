"""The port's ZeRO-Inference (weight-streamed serving) against the JAX
package's, on tiny f32 models (cache f32 on both sides).

The oracle is the resident engine: the streamed engine runs the same
stem, per-layer blocks and head (``paged_layered_fns``, which
``forward_paged`` itself runs), so greedy tokens are IDENTICAL, streamed
against resident in the port and against the JAX ZI engine, for partial
residency, tied embeddings, the NVMe tier, int8 (streamed int8 against
resident int8), split-fuse with decode chunks and deeper prefetch, and
Mixtral.  ``plan_residency`` returns JAX's dicts over a grid of budgets;
the routing (``init_serving``, the registry's GPT-2 refusal, the
``quantized_resident`` refusal) matches JAX's messages.  The JAX NVMe tier
runs on its pure-Python aio arm here (its native pool is not driven).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import zero_inference as jzi
from deepspeed_tpu.inference.serving import (llama_serving_engine as
                                             jax_llama_engine,
                                             mixtral_serving_engine as
                                             jax_mixtral_engine,
                                             serving_engine as jax_registry)
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.models import mixtral as jm
from deepspeed_tpu_torch import init_serving
from deepspeed_tpu_torch.inference import zero_inference as tzi
from deepspeed_tpu_torch.inference.serving import (llama_serving_engine,
                                                   mixtral_serving_engine,
                                                   serving_engine)
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.models import mixtral as tm
from deepspeed_tpu_torch.weights import from_jax_params
from test_torch_aio import bounded

torch.set_num_threads(1)

KW = dict(max_batch=3, page_size=8, num_pages=32, max_seq=64,
          prefill_bucket=8)
PROMPTS = {"a": ([5, 9, 2], 6), "b": ([17, 3, 3, 8, 1], 5),
           "c": ([40, 2], 7)}


def _llama(n_layers=3, **kw):
    cfg = jl.LlamaConfig.tiny(dim=64, n_layers=n_layers, n_heads=4,
                              n_kv_heads=2, **kw)
    jp = jl.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tl.LlamaConfig.tiny(dim=64, n_layers=n_layers, n_heads=4,
                               n_kv_heads=2, **kw)
    return cfg, tcfg, jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def model():
    return _llama()


def _serve(eng, prompts=PROMPTS):
    for rid, (p, n) in prompts.items():
        eng.submit(rid, p, max_new_tokens=n)
    out = eng.run()
    assert eng.check_leaks() == []
    return out


def _port(tp, tcfg, builder=llama_serving_engine, **kw):
    return builder(tp, tcfg, device="cpu", cache_dtype=torch.float32,
                   **dict(KW, **kw))


def _jax(jp, cfg, builder=jax_llama_engine, **kw):
    return builder(jp, cfg, cache_dtype=jnp.float32, **dict(KW, **kw))


# ------------------------------------------------------------- planner
PLAN_GRID = [dict(n_layers=10, layer_bytes=100, stem_head_bytes=50,
                  cache_bytes=30, budget=b, prefetch_depth=d)
             for b in (None, 280, 281, 379, 380, 700, 1079, 1080, 10_000)
             for d in (1, 2)]


@pytest.mark.parametrize("kw", PLAN_GRID,
                         ids=[f"{k['budget']}-d{k['prefetch_depth']}"
                              for k in PLAN_GRID])
def test_plan_residency_matches_jax(kw):
    try:
        want = jzi.plan_residency(**kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tzi.plan_residency(**kw)
        assert str(got.value) == str(e)
        return
    assert tzi.plan_residency(**kw) == want


def test_plan_below_floor_raises():
    with pytest.raises(ValueError, match="streaming floor"):
        tzi.plan_residency(n_layers=4, layer_bytes=100, stem_head_bytes=50,
                           cache_bytes=50, budget=250, prefetch_depth=1)


# ------------------------------------------------------------- serving
def test_every_layer_streamed_matches_resident_and_jax(model):
    cfg, tcfg, jp, tp = model
    want = _serve(_jax(jp, cfg))
    resident = _serve(_port(tp, tcfg))
    eng = _port(tp, tcfg, zero_inference={"hbm_budget_bytes": None})
    jeng = _jax(jp, cfg, zero_inference={"hbm_budget_bytes": None})
    assert isinstance(eng, tzi.ZeroInferenceServingEngine)
    got = _serve(eng)
    assert got == resident == want == _serve(jeng)
    assert eng.plan == jeng.plan
    # every sweep re-streamed every layer, one upload each
    assert eng.plan["n_streamed"] == cfg.n_layers
    assert eng.zi_layer_h2d_uploads == cfg.n_layers * eng.zi_layer_sweeps
    assert eng.zi_bytes_uploaded == \
        eng.zi_layer_h2d_uploads * eng.plan["layer_bytes"]
    jc = jeng.registry.snapshot()["counters"]
    assert eng.zi_layer_sweeps == jc["zi_layer_sweeps"]
    assert eng.zi_bytes_uploaded == jc["zi_bytes_uploaded"]


def test_weight_image_exceeds_budget_token_identical(model):
    """A budget one byte under the image: some layers stream; the plan is
    JAX's and the tokens the resident engine's."""
    cfg, tcfg, jp, tp = model
    bf16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    image = sum(x.nbytes for x in jax.tree.leaves(bf16))
    tb = from_jax_params(jax.device_get(bf16), device="cpu")
    zi = {"hbm_budget_bytes": image - 1, "tier": "host"}
    eng = llama_serving_engine(tb, tcfg, device="cpu", zero_inference=zi,
                               **KW)
    jeng = jax_llama_engine(bf16, cfg, zero_inference=zi, **KW)
    assert eng.plan == jeng.plan
    assert eng.plan["weight_image_bytes"] == image
    assert eng.plan["n_streamed"] > 0
    assert eng.hbm_weight_working_set_bytes() < image + \
        eng.plan["cache_bytes"]
    resident = llama_serving_engine(tb, tcfg, device="cpu", **KW)
    assert _serve(eng) == _serve(resident)


def test_partial_residency_pins_leading_layers():
    cfg, tcfg, jp, tp = _llama(n_layers=5)
    lp = jax.tree.leaves(jp["blocks"])
    layer_bytes = sum(a.nbytes // cfg.n_layers for a in lp)
    stem_head = (jp["embed"].nbytes + jp["lm_head"].nbytes
                 + jp["final_norm"].nbytes)
    cache = 2 * cfg.n_layers * cfg.n_kv_heads * 32 * 8 * cfg.head_dim * 4
    budget = stem_head + cache + 4 * layer_bytes
    zi = {"hbm_budget_bytes": budget}
    eng = _port(tp, tcfg, zero_inference=zi)
    jeng = _jax(jp, cfg, zero_inference=zi)
    assert eng.plan == jeng.plan
    assert eng.plan["n_resident"] == 2 and eng.plan["n_streamed"] == 3
    got = _serve(eng)
    assert got == _serve(_port(tp, tcfg)) == _serve(jeng)
    # only the streamed suffix crossed the link
    assert eng.zi_layer_h2d_uploads == 3 * eng.zi_layer_sweeps


def test_tied_embeddings_charged_once():
    cfg, tcfg, jp, tp = _llama(n_layers=2, tie_embeddings=True)
    eng = _port(tp, tcfg, zero_inference={})
    jeng = _jax(jp, cfg, zero_inference={})
    assert eng.plan["stem_head_bytes"] == \
        jp["embed"].nbytes + jp["final_norm"].nbytes
    assert eng.plan == jeng.plan
    assert eng._head["embed"] is eng._stem["embed"]
    assert _serve(eng) == _serve(_port(tp, tcfg)) == _serve(jeng)


@bounded
def test_nvme_tier_matches_host_tier_and_jax(model, tmp_path,
                                             monkeypatch):
    import deepspeed_tpu.io.aio as jaio

    # the reference's native pool is not driven here: JAX's NVMe tier
    # reads on its pure-Python arm
    monkeypatch.setattr(jaio, "_ensure_lib", lambda: None)
    cfg, tcfg, jp, tp = model
    host = _serve(_port(tp, tcfg, zero_inference={}))
    eng = _port(tp, tcfg, zero_inference={
        "tier": "nvme", "nvme_path": str(tmp_path / "port")})
    jeng = _jax(jp, cfg, zero_inference={
        "tier": "nvme", "nvme_path": str(tmp_path / "jax")})
    assert eng.tier.rpools[0].native
    assert _serve(eng) == host == _serve(jeng)
    # the alternating slots fenced every streamed layer once a sweep
    assert eng._reader.hits + eng._reader.stalls == \
        cfg.n_layers * eng.zi_layer_sweeps
    assert eng._reader.depth == 1


def test_int8_streamed_matches_resident_int8(model):
    cfg, tcfg, jp, tp = model
    want = _serve(_port(tp, tcfg, weight_dtype="int8"))
    eng = _port(tp, tcfg, weight_dtype="int8", zero_inference={})
    assert _serve(eng) == want
    # the tier holds the codes and scales: int8 bytes cross the link
    assert all(d in (torch.int8, torch.float32) for d in eng._dtypes)
    # zero_inference.dtype overrides weight_dtype
    eng2 = _port(tp, tcfg, zero_inference={"dtype": "int8"})
    assert _serve(eng2) == want


def test_split_fuse_and_chunked_decode(model):
    cfg, tcfg, jp, tp = model
    kw = dict(decode_chunk=4, prefill_chunk=8)
    long_prompt = np.random.default_rng(5).integers(
        1, cfg.vocab_size, 21).tolist()
    prompts = dict(PROMPTS, long=(long_prompt, 5))
    want = _serve(_jax(jp, cfg, **kw), prompts)
    eng = _port(tp, tcfg, zero_inference={"prefetch_depth": 2}, **kw)
    assert eng._reader.depth == 2 and len(eng._rings[0]) == 3
    assert _serve(eng, prompts) == _serve(_port(tp, tcfg, **kw),
                                          prompts) == want


def test_mixtral_streams():
    cfg = jm.MixtralConfig.tiny(num_experts=4)
    jp = jm.init_params(jax.random.PRNGKey(2), cfg)
    tcfg = tm.MixtralConfig.tiny(num_experts=4)
    tp = from_jax_params(jax.device_get(jp), device="cpu")
    eng = _port(tp, tcfg, builder=mixtral_serving_engine, zero_inference={})
    want = _serve(_jax(jp, cfg, builder=jax_mixtral_engine))
    assert _serve(eng) == want == _serve(
        _port(tp, tcfg, builder=mixtral_serving_engine))
    # int8 keeps the router exact on the streamed path too
    q = _port(tp, tcfg, builder=mixtral_serving_engine, weight_dtype="int8",
              zero_inference={})
    from deepspeed_tpu_torch.inference.quantized import QuantizedTensor

    assert isinstance(q._template["w1"], QuantizedTensor)
    assert not isinstance(q._template["gate"], QuantizedTensor)
    assert _serve(q) == _serve(_port(tp, tcfg, builder=mixtral_serving_engine,
                                     weight_dtype="int8"))


def test_layered_fns_match_forward_paged(model):
    """``forward_paged`` IS stem + blocks + head: the factoring returns the
    same logits as the whole forward on a fresh cache."""
    from deepspeed_tpu_torch.inference.kernels import PagedKVCache

    cfg, tcfg, jp, tp = model
    toks = torch.tensor([[5, 9, 2, 7, 1, 3, 2, 8]])

    def cache():
        return PagedKVCache.alloc(tcfg.n_layers, tcfg.n_kv_heads, 8, 8,
                                  tcfg.head_dim, 1, 32, torch.float32,
                                  device="cpu")

    want, _ = tl.forward_paged(tp, toks, tcfg, cache())
    stem, block, head = tl.paged_layered_fns(tcfg)
    c = cache()
    x, cos, sin = stem(tp, toks, c.seq_lens)
    for l in range(tcfg.n_layers):
        lp = {k: v[l] for k, v in tp["blocks"].items()}
        x = block(lp, x, cos, sin, c.k[l], c.v[l], c.table, c.seq_lens,
                  continuation=False, prefill=True)
    assert torch.equal(head(tp, x), want)


# -------------------------------------------------------------- wiring
def test_init_serving_routes_zero_inference(model):
    cfg, tcfg, jp, tp = model
    eng = init_serving(tp, tcfg, device="cpu",
                       config={"zero_inference": {"enabled": True}}, **KW)
    assert isinstance(eng, tzi.ZeroInferenceServingEngine)
    assert eng.plan["n_streamed"] == tcfg.n_layers
    eng2 = init_serving(tp, tcfg, device="cpu", config={}, **KW)
    assert not isinstance(eng2, tzi.ZeroInferenceServingEngine)


def test_registry_rejects_gpt2_like_jax():
    cfg = jg.GPT2Config.tiny(dim=64, n_layers=2, n_heads=4, max_seq_len=256)
    jp = jg.init_params(jax.random.PRNGKey(0), cfg)
    tcfg = tg.GPT2Config.tiny(dim=64, n_layers=2, n_heads=4,
                              max_seq_len=256)
    tp = from_jax_params(jax.device_get(jp), device="cpu")
    kw = dict(zero_inference={"enabled": True}, max_batch=1, page_size=8,
              num_pages=16, max_seq=32)
    with pytest.raises(NotImplementedError) as want:
        jax_registry(jp, cfg, **kw)
    with pytest.raises(NotImplementedError) as got:
        serving_engine(tp, tcfg, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_quantized_resident_refused_like_jax(model):
    cfg, tcfg, jp, tp = model
    kvt = {"quantize_cold": True, "quantized_resident": True}
    with pytest.raises(NotImplementedError) as want:
        jax_llama_engine(jp, cfg, zero_inference={}, prefix_cache={},
                         kv_tier=kvt, **KW)
    with pytest.raises(NotImplementedError) as got:
        llama_serving_engine(tp, tcfg, device="cpu", zero_inference={},
                             prefix_cache={}, kv_tier=kvt, **KW)
    assert str(got.value) == str(want.value)


def test_unknown_family_and_dtype_raise(model):
    cfg, tcfg, jp, tp = model
    with pytest.raises(NotImplementedError, match="llama/mixtral"):
        tzi.zero_inference_serving_engine(tp, tcfg, {}, family="gpt2",
                                          device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="int8"):
        _port(tp, tcfg, weight_dtype="int4", zero_inference={})


def test_per_layer_source_serves(model):
    """``blocks`` may be a (lazy) sequence of per-layer trees: a model
    larger than the host's spare memory is drawn one layer at a time."""
    cfg, tcfg, jp, tp = model

    class Layers:
        def __init__(self):
            self.drawn = []

        def __len__(self):
            return tcfg.n_layers

        def __getitem__(self, l):
            self.drawn.append(l)
            return {k: v[l].clone() for k, v in tp["blocks"].items()}

    src = Layers()
    eng = _port(dict(tp, blocks=src), tcfg, zero_inference={})
    # each layer drawn once, in order (layer 0 also sizes the plan)
    assert src.drawn == list(range(tcfg.n_layers))
    assert _serve(eng) == _serve(_port(tp, tcfg))
    with pytest.raises(ValueError, match="layer trees"):
        _port(dict(tp, blocks=[{}]), tcfg, zero_inference={})


# --------------------------------------------------------- the reader
def _tier_items(tier, n=5):
    rng = np.random.default_rng(0)
    items = {l: rng.standard_normal((4, 6)).astype(np.float32)
             for l in range(n)}
    for l, a in items.items():
        tier.put(f"x{l}", a)
    tier.fence_all()
    return items


def test_reader_ram_path_pumps_depth_ahead():
    """The RAM tier's pump keeps ``depth`` uploads ahead of the item being
    consumed (the ring holds depth + 1), counts every item as a hit and
    its bytes, per sweep too."""
    from deepspeed_tpu_torch.infinity import _RamTier
    from deepspeed_tpu_torch.param_stream import TierLayerReader

    tier = _RamTier()
    items = _tier_items(tier)
    issued = []

    def up(bufs, l):
        issued.append(l)
        return bufs[0]

    r = TierLayerReader(tier, lambda l: [f"x{l}"], [(4, 6)], [np.float32],
                        up, depth=2)
    seen = []
    for l, buf in r.sweep([0, 1, 2, 3, 4]):
        # while l is consumed, the next `depth` uploads were issued
        assert issued[-1] == min(l + 2, 4)
        np.testing.assert_array_equal(buf, items[l])
        seen.append(l)
    assert seen == [0, 1, 2, 3, 4] and r.depth == 2
    assert r.last_sweep == {"bytes": 5 * 96, "hits": 5, "stalls": 0}
    list(r.sweep([4, 2]))
    assert r.last_sweep["bytes"] == 2 * 96 and r.bytes_read == 7 * 96


@bounded
def test_reader_nvme_path_fences_one_ahead(tmp_path):
    """An NVMe tier forces depth 1: each item's fence is timed through
    ``on_wait``, the next item's reads are submitted before the current
    one is handed over, and hits + stalls count every item."""
    from deepspeed_tpu_torch.infinity import _NvmeTier
    from deepspeed_tpu_torch.param_stream import TierLayerReader

    tier = _NvmeTier(str(tmp_path))
    items = _tier_items(tier)
    waits = []
    r = TierLayerReader(tier, lambda l: [f"x{l}"], [(4, 6)], [np.float32],
                        lambda bufs, l: bufs[0].copy(), depth=3)
    assert r.depth == 1
    got = dict(r.sweep(range(5), on_wait=waits.append))
    assert len(waits) == 5 and all(w >= 0 for w in waits)
    for l, a in items.items():
        np.testing.assert_array_equal(got[l], a)
    assert r.hits + r.stalls == 5 and r.last_sweep["bytes"] == 5 * 96
