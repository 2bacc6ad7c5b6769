"""GPT-2's and BERT's tensor-parallel layouts in the port
(``gpt2.param_specs`` / ``bert.param_specs``, the fused-QKV placement of
:class:`~deepspeed_tpu_torch.topology.FusedSpec`, GPT-2 tp serving and
training, BERT's sharded lots and training) against the JAX package.

Gloo ranks are spawned once for W = 2 (model 2) and once for W = 4 (model 4
for serving and BERT training, data 2 x model 2 for GPT-2 training) by
``tests/_torch_dist.py``.
Oracles and tolerances:

- spec trees: JAX's ``param_specs``, leaf for leaf;
- served f32 tokens: IDENTICAL to JAX's single-device engine (f32 caches);
  int8 (group 16): identical to JAX's int8 engine, whose codes and scales
  each rank holds its block of, bit for bit;
- ``init_inference`` logits: 1e-5 in f32, the bf16 bound 0.06 in int8
  (tests/test_torch_serving_tp.py);
- training: JAX's engine on the same mesh of its virtual CPU devices at the
  JAX TP test's 5e-3 (tests/test_models.py:82); the gathered tree before a
  step and the stage-0 checkpoint read into one rank are bit for bit;
- BERT heads: JAX's ``EncoderServingEngine`` with ``specs_tree`` over the
  same mesh, 1e-5 in f32 and 1e-4 in int8 (test_torch_encoder_serving.py);
- BERT training over data 2 x model 2 with 10 and 15 labels on the data
  ranks: JAX's engine at the same 5e-3 (the masked mean is global).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_dist as td
import deepspeed_tpu as dstpu
from deepspeed_tpu.inference import engine as jie
from deepspeed_tpu.inference.encoder_serving import (
    bert_serving_engine as jbert_serve)
from deepspeed_tpu.inference.quantized import quantize_params
from deepspeed_tpu.inference.serving import gpt2_serving_engine as jserve
from deepspeed_tpu.models import bert as jb
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu.topology import MeshSpec as JMesh
from deepspeed_tpu_torch import initialize, topology
from deepspeed_tpu_torch.inference.serving import GPT2_INT8_SKIP
from deepspeed_tpu_torch.models import bert as tb
from deepspeed_tpu_torch.models import gpt2 as tg

torch.set_num_threads(1)
PROMPTS = {"a": ([5, 9, 2], 6), "b": ([17, 3, 3, 8, 1], 5),
           "c": ([40, 2], 7)}
KW = dict(max_batch=2, page_size=8, num_pages=32, max_seq=64,
          prefill_bucket=8)
BERT_QUEUE = [[3, 7, 9, 4], [12, 5], [8, 8, 1, 2, 6, 30, 2], [44]]
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = dict(rtol=0, atol=0.06)
TP_TOL = dict(rtol=5e-3, atol=5e-3)          # tests/test_models.py:82
F32_TOL = dict(rtol=1e-5, atol=1e-5)
INT8_TOL = dict(rtol=1e-4, atol=1e-4)
STAGES = {"2": [0, 1], "4": [0, 1, 2, 3]}
STEPS = 3


@functools.lru_cache(maxsize=None)
def _inputs():
    cfg, bcfg = jg.GPT2Config.tiny(), jb.BertConfig.tiny()
    gp = jax.device_get(jg.init_params(jax.random.PRNGKey(0), cfg))
    bp = jax.device_get(jb.init_params(jax.random.PRNGKey(1), bcfg))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    train = rng.integers(0, cfg.vocab_size, (STEPS, 4, 13)).astype(np.int32)
    B, T = 4, 16
    btoks = rng.integers(0, 256, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 11:] = 0
    mask[3, 5:] = 0
    bbatch = {"tokens": btoks, "attention_mask": mask,
              "token_type_ids": rng.integers(0, 2, (B, T)).astype(np.int32),
              "mlm_labels": np.where(rng.random((B, T)) < 0.3, btoks,
                                     -100).astype(np.int32)}
    return cfg, bcfg, gp, bp, toks, train, bbatch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import concurrent.futures as cf

    _, _, gp, bp, toks, train, bbatch = _inputs()
    d = str(tmp_path_factory.mktemp("tp_gpt2"))
    spec = {"prompts": PROMPTS, "kw": KW, "bert_queue": BERT_QUEUE,
            "stages": STAGES, "dir": d}
    arrays = {"gpt2": gp, "bert": bp, "fwd_tokens": toks, "tokens": train,
              "bert_batch": bbatch}
    with cf.ThreadPoolExecutor(2) as ex:
        futs = {W: ex.submit(td.run_ranks, "tp_gpt2_bert", W, spec, arrays,
                             timeout=240) for W in (2, 4)}
        return {W: f.result() for W, f in futs.items()}, d


def _specs_tuple(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def test_spec_trees_equal_jax():
    assert tg.param_specs(tg.GPT2Config.tiny()) == _specs_tuple(
        jg.param_specs(jg.GPT2Config.tiny()))
    assert tb.param_specs(tb.BertConfig.tiny()) == _specs_tuple(
        jb.param_specs(jb.BertConfig.tiny()))
    # the fused QKV leaves carry their three parts, nothing else does
    assert tg.param_specs(tg.GPT2Config.tiny())["blocks"]["qkv_w"].parts == 3
    assert tb.param_specs(tb.BertConfig.tiny())["blocks"]["bqkv"].parts == 3


@functools.lru_cache(maxsize=None)
def _jax_tokens(**extra):
    cfg, _, gp, _, _, _, _ = _inputs()
    eng = jserve(jax.tree.map(jnp.asarray, gp), cfg,
                 cache_dtype=jnp.float32, **dict(KW, **extra))
    for rid, (p, n) in PROMPTS.items():
        eng.submit(rid, p, max_new_tokens=n)
    res = eng.run()
    return {rid: [int(t) for t in res[rid]] for rid in PROMPTS}


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("name,extra", [
    ("tp", ()), ("split", (("prefill_chunk", 4), ("decode_chunk", 2))),
    ("int8", (("weight_dtype", "int8"), ("quant_group_size", 16)))])
def test_gpt2_tp_serving_tokens_match_jax(runs, W, name, extra):
    want = _jax_tokens(**dict(extra))
    for o in runs[0][W]:
        assert {rid: o[f"gpt2_{name}/{rid}"].tolist()
                for rid in PROMPTS} == want
        assert int(o[f"gpt2_{name}/cache_heads"]) == 4 // W


def _fused_block(a, m, W):
    """Rank m's [q_m | k_m | v_m] of a fused last dim."""
    n = a.shape[-1] // 3
    c = n // W
    return np.concatenate([a[..., p * n + m * c: p * n + (m + 1) * c]
                           for p in range(3)], axis=-1)


@pytest.mark.parametrize("W", [2, 4])
def test_gpt2_rank_holds_its_heads_of_q_k_v(runs, W):
    _, _, gp, _, _, _, _ = _inputs()
    q = quantize_params(jax.tree.map(jnp.asarray, gp), group_size=16,
                        skip_paths=GPT2_INT8_SKIP)["blocks"]["qkv_w"]
    for m, o in enumerate(runs[0][W]):
        np.testing.assert_array_equal(
            o["gpt2_tp/qkv_w"], _fused_block(gp["blocks"]["qkv_w"], m, W))
        np.testing.assert_array_equal(
            o["gpt2_tp/qkv_b"], _fused_block(gp["blocks"]["qkv_b"], m, W))
        np.testing.assert_array_equal(o["gpt2_int8/qkv_q"],
                                      _fused_block(np.asarray(q.q), m, W))
        np.testing.assert_array_equal(o["gpt2_int8/qkv_scale"],
                                      _fused_block(np.asarray(q.scale), m, W))


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_gpt2_init_inference_over_the_mesh_matches_jax(runs, W, dtype):
    cfg, _, gp, _, toks, _, _ = _inputs()
    eng = jie.init_inference(apply_fn=functools.partial(jg.forward, cfg=cfg),
                             params=jax.tree.map(jnp.asarray, gp),
                             dtype=dtype, quant_group_size=16)
    want = np.asarray(eng(jnp.asarray(toks)))
    tol = LOGIT_TOL if dtype == "float32" else BF16_ATOL
    got = [o[f"gpt2_ie_{dtype}/logits"] for o in runs[0][W]]
    for g in got:
        np.testing.assert_allclose(g, want, **tol)
        np.testing.assert_array_equal(g, got[0])


@functools.lru_cache(maxsize=None)
def _jax_train(W, stage, what="gpt2"):
    cfg, bcfg, gp, bp, _, train, bbatch = _inputs()
    sizes = {"model": 2} if W == 2 else {"data": 2, "model": 2}
    if what == "bert":
        sizes = {"model": W}
    if what == "bert_dm":
        sizes = {"data": 2, "model": 2}
    conf = {"train_batch_size": 4, "bf16": {"enabled": False},
            "gradient_clipping": 1.0, "mesh": sizes,
            "zero_optimization": {"stage": stage},
            "optimizer": {"type": "adamw",
                          "params": {"lr": 3e-3, "weight_decay": 0.1}}}
    mesh = JMesh.build(sizes, devices=jax.devices()[:W])
    if what == "gpt2":
        loss, p0, specs = jg.loss_fn(cfg), gp, jg.param_specs(cfg)
        batches = [{"tokens": jnp.asarray(train[i])} for i in range(STEPS)]
    else:
        loss, p0, specs = jb.loss_fn(bcfg), bp, jb.param_specs(bcfg)
        if what == "bert_dm":
            bbatch = td.bert_unequal_batch()
        batches = [{k: jnp.asarray(v) for k, v in bbatch.items()}] * 2
    eng, _, _, _ = dstpu.initialize(
        loss_fn=loss, params=jax.tree.map(jnp.asarray, p0), config=conf,
        mesh=mesh, param_specs=specs)
    losses = [float(eng.train_batch(b)) for b in batches]
    return np.asarray(losses), jax.device_get(eng.module_params())


@pytest.mark.parametrize("W,stage", [(2, 0), (2, 1), (4, 0), (4, 1), (4, 2),
                                     (4, 3)])
def test_gpt2_tp_training_matches_jax(runs, W, stage):
    want, jp = _jax_train(W, stage)
    ranks = runs[0][W]
    got = ranks[0][f"gpt2_train{stage}/losses"]
    for o in ranks[1:]:
        np.testing.assert_array_equal(o[f"gpt2_train{stage}/losses"], got)
    np.testing.assert_allclose(got, want, **TP_TOL)
    for k, v in td._flatten(jp).items():
        np.testing.assert_allclose(ranks[0][f"gpt2_train{stage}/params/{k}"],
                                   v, err_msg=k, **TP_TOL)


@pytest.mark.parametrize("W", [2, 4])
def test_gpt2_tp_gather_and_checkpoint_invert_the_placement(runs, W):
    res, d = runs
    cfg, _, gp, _, _, _, _ = _inputs()
    # the gathered tree before any step is the one-rank tree, bit for bit
    for o in res[W]:
        for k, v in td._flatten(gp).items():
            np.testing.assert_array_equal(o[f"gpt2_train/init/{k}"], v,
                                          err_msg=k)
    # the stage-0 checkpoint read into one rank equals the ranks' gather
    one = initialize(
        loss_fn=tg.loss_fn(tg.GPT2Config.tiny()),
        params=td._tree_params({f"g/{k}": v for k, v in
                                td._flatten(gp).items()}, "g"),
        config={"train_batch_size": 4, "bf16": {"enabled": False},
                "optimizer": {"type": "adamw"}},
        device="cpu", dist_init_required=False,
        mesh=topology.MeshSpec(sizes={a: 1 for a in topology.AXES}))[0]
    one.load_checkpoint(f"{d}/gpt2_w{W}")
    got = {k: td._np(v) for k, v in td._flatten(one.module_params()).items()}
    for k in td._flatten(gp):
        np.testing.assert_array_equal(
            got[k], res[W][0][f"gpt2_train0/params/{k}"], err_msg=k)


@pytest.mark.parametrize("remat", ["save_attn", "offload_attn"])
def test_gpt2_tp_remat_matches_no_remat(runs, remat):
    for W in (2, 4):
        for o in runs[0][W]:
            np.testing.assert_array_equal(o[f"gpt2_{remat}/losses"],
                                          o["gpt2_train0/losses"])


@functools.lru_cache(maxsize=None)
def _jax_bert(W, head, wdt):
    _, bcfg, _, bp, _, _, _ = _inputs()
    mesh = JMesh.build({"model": W}, devices=jax.devices()[:W])
    eng = jbert_serve(jax.tree.map(jnp.asarray, bp), bcfg, head=head,
                      mesh=mesh, weight_dtype=wdt, max_batch=2,
                      quant_group_size=16)
    for i, q in enumerate(BERT_QUEUE):
        eng.submit(i, q)
    res = eng.run()
    from deepspeed_tpu.topology import set_current_mesh

    set_current_mesh(None)
    return res, eng.stats["lots"]


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("head", ["pooled", "mlm", "hidden"])
@pytest.mark.parametrize("wdt", ["bfloat16", "int8"])
def test_bert_sharded_lots_match_jax(runs, W, head, wdt):
    want, lots = _jax_bert(W, head, wdt)
    tol = F32_TOL if wdt == "bfloat16" else INT8_TOL
    for o in runs[0][W]:
        assert int(o[f"bert_{head}_{wdt}/lots"]) == lots
        for i in range(len(BERT_QUEUE)):
            np.testing.assert_allclose(o[f"bert_{head}_{wdt}/{i}"],
                                       np.asarray(want[i]), **tol)


@pytest.mark.parametrize("W", [2, 4])
def test_bert_training_over_model_matches_jax(runs, W):
    want, jp = _jax_train(W, 0, "bert")
    for o in runs[0][W]:
        np.testing.assert_allclose(o["bert_train/losses"], want, **TP_TOL)
    for k, v in td._flatten(jp).items():
        np.testing.assert_allclose(runs[0][W][0][f"bert_train/params/{k}"],
                                   v, err_msg=k, **TP_TOL)


def test_bert_training_over_data_and_model_matches_jax(runs):
    """data 2 x model 2 with 10 and 15 labels on the data ranks: the MLM
    mean over the global microbatch (ROADMAP C-f7)."""
    want, jp = _jax_train(4, 0, "bert_dm")
    for o in runs[0][4]:
        np.testing.assert_allclose(o["bert_train_dm/losses"], want,
                                   **TP_TOL)
    for k, v in td._flatten(jp).items():
        np.testing.assert_allclose(runs[0][4][0][f"bert_train_dm/params/{k}"],
                                   v, err_msg=k, **TP_TOL)
