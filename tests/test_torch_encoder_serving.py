"""Encoder-family serving of the port against the JAX engines
(``deepspeed_tpu/inference/encoder_serving.py``) on ``BertConfig.tiny()``
and ``CNNConfig()`` with the same weights, on the same queues: the same
requests in the same lots (``stats``), each request's result at 1e-5 in
f32 (the forwards agree to ~1e-6 on the CPU, test_torch_bert.py), and each
request equal to its own solo forward at 1e-5 (a request's result does not
depend on its lot-mates: pad tokens attend only to pads).  Int8 weights
are held to the JAX int8 engine at 1e-4 (both dequantize the same codes to
bf16 and promote against f32 activations; test_torch_gpt2.py's int8
tolerance) and to bf16 at the JAX test's 0.15.  The registry refuses what
the JAX registry refuses, with the same exception and message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import encoder_serving as jes
from deepspeed_tpu.inference.serving import serving_engine as jserving
from deepspeed_tpu.models import bert as jb
from deepspeed_tpu.models import cnn as jc
from deepspeed_tpu_torch.inference import encoder_serving as tes
from deepspeed_tpu_torch.inference.serving import serving_engine
from deepspeed_tpu_torch.models import bert as tb
from deepspeed_tpu_torch.models import cnn as tc
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    cfg = jb.BertConfig.tiny()
    jp = jax.device_get(jb.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, tb.BertConfig.tiny(), jp, from_jax_params(jp, device="cpu")


@pytest.fixture(scope="module")
def cnn_model():
    jp = jax.device_get(jc.init_params(jax.random.PRNGKey(0), jc.CNNConfig()))
    return jp, from_jax_params(jp, device="cpu")


def _reqs(lens, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return {f"r{i}": rng.integers(1, vocab, n).tolist()
            for i, n in enumerate(lens)}


def _serve(eng, reqs):
    for rid, toks in reqs.items():
        eng.submit(rid, toks)
    return eng.run()


def _solo(tcfg, tp, toks, head):
    t = torch.tensor([toks], dtype=torch.int32)
    h = tb.forward(tp, t, tcfg, attention_mask=torch.ones_like(t))
    if head == "pooled":
        return tb.pooled_output(tp, h)[0].numpy()
    if head == "mlm":
        return tb.mlm_logits(tp, h, tcfg)[0].numpy()
    return h[0].numpy()


@pytest.mark.parametrize("head,lens,max_batch,buckets", [
    ("pooled", [5, 12, 33, 7, 40, 3], 4, None),
    ("mlm", [6, 17], 2, None),
    ("hidden", [4, 40, 5, 6], 8, (8, 64)),
])
def test_heads_match_jax_engine_and_solo(model, head, lens, max_batch,
                                         buckets):
    cfg, tcfg, jp, tp = model
    kw = {"max_batch": max_batch}
    if buckets:
        kw["buckets"] = buckets
    reqs = _reqs(lens, seed=len(lens))
    jeng = jes.bert_serving_engine(jp, cfg, head=head, **kw)
    teng = tes.bert_serving_engine(tp, tcfg, head=head, device="cpu", **kw)
    assert teng.buckets == jeng.buckets
    want, got = _serve(jeng, reqs), _serve(teng, reqs)
    assert set(got) == set(reqs) and teng.stats == jeng.stats
    assert teng.stats["requests"] == len(reqs)
    for rid, toks in reqs.items():
        assert got[rid].dtype == np.float32
        if head == "pooled":
            assert got[rid].shape == (tcfg.dim,)
        else:
            width = tcfg.vocab_size if head == "mlm" else tcfg.dim
            assert got[rid].shape == (len(toks), width)
        np.testing.assert_allclose(got[rid], np.asarray(want[rid]), **TOL)
        np.testing.assert_allclose(got[rid], _solo(tcfg, tp, toks, head),
                                   **TOL)


def test_lots_are_formed_in_arrival_order(model):
    """A long request does not drag short ones into its bucket: the three
    short ones share the 8-bucket lot, the long one rides its own."""
    cfg, tcfg, jp, tp = model
    reqs = _reqs([4, 40, 5, 6], seed=2)
    eng = tes.bert_serving_engine(tp, tcfg, max_batch=8, buckets=(8, 64),
                                  device="cpu")
    lots = []
    fn = eng._fn
    eng._fn = lambda p, t, m: (lots.append((tuple(t.shape),
                                            m.sum(1).tolist())),
                               fn(p, t, m))[1]
    _serve(eng, reqs)
    assert lots == [((8, 8), [4, 5, 6, 0, 0, 0, 0, 0]),
                    ((8, 64), [40, 0, 0, 0, 0, 0, 0, 0])]
    assert eng.stats == {"lots": 2, "rows_padded": 12, "requests": 4}


def test_oversize_refused_and_buckets_clamped(model):
    cfg, tcfg, jp, tp = model
    eng = tes.bert_serving_engine(tp, tcfg, device="cpu")
    assert eng.buckets == (32, 64)
    with pytest.raises(ValueError, match="bucket"):
        eng.submit("x", list(range(1, tcfg.max_seq_len + 10)))
    with pytest.raises(ValueError, match="empty"):
        eng.submit("y", [])
    short = tb.BertConfig.tiny(max_seq_len=16)
    jshort = jb.BertConfig.tiny(max_seq_len=16)
    sp = from_jax_params(jax.device_get(
        jb.init_params(jax.random.PRNGKey(2), jshort)), device="cpu")
    eng = tes.bert_serving_engine(sp, short, device="cpu")
    assert eng.buckets == (16,) == jes.bert_serving_engine(
        jb.init_params(jax.random.PRNGKey(2), jshort), jshort).buckets
    with pytest.raises(ValueError, match="bucket"):
        eng.submit("x", list(range(1, 22)))
    with pytest.raises(ValueError, match="head"):
        tes.bert_serving_engine(tp, tcfg, head="cls", device="cpu")


def test_int8_close_to_jax_int8_and_to_bf16(model):
    cfg, tcfg, jp, tp = model
    reqs = {"x": [2, 9, 4, 7], "y": list(range(3, 40))}
    want = _serve(jes.bert_serving_engine(jp, cfg, weight_dtype="int8"), reqs)
    eng = tes.bert_serving_engine(tp, tcfg, weight_dtype="int8",
                                  device="cpu")
    # every matrix but the tied embedding is int8; the skip list is JAX's
    blocks = eng.params["blocks"]
    assert blocks["wqkv"].q.dtype == torch.int8
    assert blocks["bqkv"].dtype == torch.float32
    assert eng.params["embed"].dtype == torch.float32
    assert eng.params["pooler"]["w"].q.dtype == torch.int8
    got = _serve(eng, reqs)
    base = _serve(tes.bert_serving_engine(tp, tcfg, device="cpu"), reqs)
    for rid in reqs:
        np.testing.assert_allclose(got[rid], np.asarray(want[rid]),
                                   rtol=1e-4, atol=1e-4)
        assert float(np.max(np.abs(got[rid] - base[rid]))) < 0.15
    with pytest.raises(NotImplementedError, match="int8"):
        tes.bert_serving_engine(tp, tcfg, weight_dtype="int4", device="cpu")


def test_registry_dispatches_the_encoder_families(model, cnn_model):
    _, tcfg, _, tp = model
    eng = serving_engine(tp, tcfg, device="cpu", tracing={}, history={})
    assert isinstance(eng, tes.EncoderServingEngine)
    assert _serve(eng, {"x": [3, 5, 8]})["x"].shape == (tcfg.dim,)
    eng = serving_engine(cnn_model[1], tc.CNNConfig(), max_batch=2,
                         device="cpu")
    assert isinstance(eng, tes.CNNServingEngine)
    eng.submit("a", np.zeros((32, 32, 3), np.float32))
    assert eng.run()["a"].shape == (10,)


REFUSED = [
    ("kernels", {"paged_attention": "xla"}), ("comm", {"quantized_serving":
                                                        True}),
    ("speculative", {"draft_tokens": 2}), ("slo", {}), ("prefix_cache", True),
    ("kv_tier", True), ("faults", {}), ("shed_queue_depth", 4),
    ("shed_expired_deadline", True), ("zero_inference", {"enabled": True}),
]


@pytest.mark.parametrize("block,value", REFUSED,
                         ids=[b for b, _ in REFUSED])
def test_registry_refuses_with_the_jax_messages(model, block, value):
    cfg, tcfg, jp, tp = model
    with pytest.raises(NotImplementedError) as want:
        jserving(jp, cfg, **{block: value})
    with pytest.raises(NotImplementedError) as got:
        serving_engine(tp, tcfg, device="cpu", **{block: value})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [{"weight_dtype": "int8"}, {"mesh": object()}])
def test_registry_refuses_cnn_options_and_unknown_configs(cnn_model, kw):
    jp, tp = cnn_model
    with pytest.raises(NotImplementedError) as want:
        jserving(jp, jc.CNNConfig(), **kw)
    with pytest.raises(NotImplementedError) as got:
        serving_engine(tp, tc.CNNConfig(), device="cpu", **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(TypeError) as want:
        jserving(jp, object())
    with pytest.raises(TypeError) as got:
        serving_engine(tp, object(), device="cpu")
    assert str(got.value) == str(want.value)


def test_unported_blocks_raise(model):
    _, tcfg, _, tp = model
    # telemetry is ported: the JAX engine's counters beside ``stats``
    eng = tes.bert_serving_engine(tp, tcfg, device="cpu", telemetry=True)
    eng.submit("a", [3, 7, 9])
    eng.run()
    counters = eng.registry.snapshot()["counters"]
    assert counters["encoder_lots"] == eng.stats["lots"] == 1
    assert counters["encoder_requests"] == 1
    # a mesh is served (test_torch_tp_gpt2_bert.py); it must be a MeshSpec,
    # and a sharded one without the model's specs is refused as JAX does
    from deepspeed_tpu.topology import MeshSpec as JMesh
    from deepspeed_tpu_torch.topology import AXES, MeshSpec

    with pytest.raises(TypeError, match="MeshSpec"):
        tes.bert_serving_engine(tp, tcfg, device="cpu", mesh=object())
    with pytest.raises(ValueError) as want:
        jes.EncoderServingEngine(lambda p, t, m: t, {}, mesh=JMesh.build(
            {"model": 2}, devices=jax.devices()[:2]))
    with pytest.raises(ValueError) as got:
        tes.EncoderServingEngine(lambda p, t, m: t, {}, device="cpu",
                                 mesh=MeshSpec(sizes={
                                     a: 2 if a == "model" else 1
                                     for a in AXES}))
    assert str(got.value) == str(want.value)
    off = tes.bert_serving_engine(tp, tcfg, device="cpu", telemetry=False)
    assert not off.registry.enabled
    assert tes.CNNServingEngine({}, device="cpu",
                                telemetry={}).registry.enabled


def test_cnn_lots_match_jax_engine_and_solo(cnn_model):
    jp, tp = cnn_model
    rng = np.random.default_rng(0)
    imgs = {f"i{k}": rng.normal(size=(32, 32, 3)).astype(np.float32)
            for k in range(6)}
    jeng = jes.CNNServingEngine(jp, max_batch=4)
    teng = tes.CNNServingEngine(tp, max_batch=4, device="cpu")
    want, got = _serve(jeng, imgs), _serve(teng, imgs)
    assert teng.stats == jeng.stats == {"lots": 2, "requests": 6}
    for rid, img in imgs.items():
        np.testing.assert_allclose(got[rid], np.asarray(want[rid]), **TOL)
        solo = tc.forward(tp, torch.from_numpy(img[None]))[0].numpy()
        np.testing.assert_allclose(got[rid], solo, **TOL)
    with pytest.raises(ValueError, match="shape"):
        teng.submit("a", np.zeros((16, 16, 3), np.float32))


def test_engines_without_device_raise_on_cpu(model, cnn_model, monkeypatch):
    _, tcfg, _, tp = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving_engine(tp, tcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving_engine(cnn_model[1], tc.CNNConfig())
