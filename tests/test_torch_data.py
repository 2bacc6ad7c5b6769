"""The port's data pipeline against the JAX package on the CPU: the
``DataLoader``'s global batches over seeds and epochs (shuffled or not,
``drop_last`` either way) and its splitmix64 shuffle, bit for bit;
``pack_documents`` / ``PackedDataLoader`` tokens and segment ids bit for
bit (empty, over-long, carry-over and short-final-batch cases); the
curriculum's schedules, truncation and difficulty sampling; and
``initialize(training_data=...)`` and a curriculum-driven train run through
the engine (f32 losses at test_torch_train.py's 1e-4 relative)."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu import engine as jeng
from deepspeed_tpu.data import curriculum as jcur
from deepspeed_tpu.data import loader as jloader
from deepspeed_tpu.data import packing as jpack
from deepspeed_tpu.io import native as jnative
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.topology import MeshSpec
from deepspeed_tpu_torch import initialize
from deepspeed_tpu_torch.data import curriculum as tcur
from deepspeed_tpu_torch.data import loader as tloader
from deepspeed_tpu_torch.data import packing as tpack
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)


def _dataset(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.integers(0, 100, (3,)).astype(np.int32),
             "y": np.int32(i)} for i in range(n)]


def _equal_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("n,seed,epoch", [(1, 0, 0), (2, 3, 1), (23, 0, 0),
                                          (23, 7, 5), (257, 42, 2**33 + 1)])
def test_splitmix64_shuffle_is_the_reference_mirror(n, seed, epoch):
    np.testing.assert_array_equal(
        tloader._splitmix64_shuffle(n, seed, epoch),
        jnative._splitmix64_shuffle(n, seed, epoch))


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("seed", [0, 42])
def test_loader_batches_match_jax_over_epochs(shuffle, drop_last, seed):
    data = _dataset(23, seed)
    jl_ = jloader.DataLoader(data, batch_size=4, shuffle=shuffle, seed=seed,
                             drop_last=drop_last)
    tl_ = tloader.DataLoader(data, batch_size=4, shuffle=shuffle, seed=seed,
                             drop_last=drop_last)
    assert len(tl_) == len(jl_) == (5 if drop_last else 6)
    for epoch in range(3):
        jl_.set_epoch(epoch)
        tl_.set_epoch(epoch)
        _equal_batches(list(tl_), list(jl_))


def test_repeating_loader_advances_the_epoch_as_jax():
    data = _dataset(9, 1)
    jr = jloader.RepeatingLoader(jloader.DataLoader(data, batch_size=4,
                                                    seed=1))
    tr = tloader.RepeatingLoader(tloader.DataLoader(data, batch_size=4,
                                                    seed=1))
    _equal_batches([next(tr) for _ in range(7)], [next(jr) for _ in range(7)])
    assert tr.loader.epoch == jr.loader.epoch == 3


def test_tuple_and_array_collate_match_jax():
    items = [(np.arange(3) + i, np.float32(i)) for i in range(4)]
    for j, t in zip(jloader._default_collate(items),
                    tloader._default_collate(items)):
        np.testing.assert_array_equal(t, j)
    arrs = [np.full((2,), i) for i in range(3)]
    np.testing.assert_array_equal(tloader._default_collate(arrs),
                                  jloader._default_collate(arrs))


def _docs(seed, n, lo, hi, vocab=500):
    rng = np.random.default_rng(seed)
    docs = [list(rng.integers(1, vocab, int(rng.integers(lo, hi))))
            for _ in range(n)]
    docs[n // 3] = []                       # an empty document
    docs[n // 2] = list(range(1, 3 * hi))   # longer than any row
    return docs


@pytest.mark.parametrize("seq_len", [8, 16, 33])
def test_pack_documents_bit_equal(seq_len):
    docs = _docs(seq_len, 30, 1, 12)
    tt, ts = tpack.pack_documents(docs, seq_len, pad_id=7)
    jt, js = jpack.pack_documents(docs, seq_len, pad_id=7)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(ts, js)
    assert tt.dtype == jt.dtype and ts.dtype == js.dtype
    assert (tpack.packing_efficiency(ts) == jpack.packing_efficiency(js))


@pytest.mark.parametrize("rows,seq_len,fill,n", [
    (2, 16, 4, 40),     # carry-over between windows, padded last batch
    (3, 8, 1, 17),      # one-row windows
    (4, 32, 2, 5),      # fewer rows than one batch: all padding rows
    (1, 12, 3, 0),      # no documents at all
])
def test_packed_loader_bit_equal(rows, seq_len, fill, n):
    docs = _docs(rows * seq_len, n, 1, seq_len) if n else []
    got = list(tpack.PackedDataLoader(docs, rows, seq_len, fill_factor=fill))
    want = list(jpack.PackedDataLoader(docs, rows, seq_len,
                                       fill_factor=fill))
    _equal_batches(got, want)
    for b in got:
        assert b["tokens"].shape == (rows, seq_len + 1)
    with pytest.raises(ValueError):
        tpack.PackedDataLoader(docs, 0, seq_len)


CURRICULA = {
    "linear": {"enabled": True, "min_difficulty": 8, "max_difficulty": 64,
               "schedule_type": "fixed_linear",
               "schedule_config": {"total_curriculum_step": 10,
                                   "difficulty_step": 8}},
    "root": {"enabled": True, "min_difficulty": 5, "max_difficulty": 100,
             "schedule_type": "fixed_root",
             "schedule_config": {"total_curriculum_step": 7,
                                 "difficulty_step": 3, "root_degree": 3}},
    "discrete": {"enabled": True, "schedule_type": "fixed_discrete",
                 "schedule_config": {"difficulty": [16, 32, 48],
                                     "max_step": [2, 5]}},
    "disabled": {"enabled": False, "max_difficulty": 77},
}


@pytest.mark.parametrize("name", CURRICULA)
def test_curriculum_schedule_matches_jax(name):
    jc = jcur.CurriculumConfig.from_dict(CURRICULA[name])
    tc = tcur.CurriculumConfig.from_dict(CURRICULA[name])
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    js, ts = jcur.CurriculumScheduler(jc), tcur.CurriculumScheduler(tc)
    assert ([ts.get_difficulty(s) for s in range(14)]
            == [js.get_difficulty(s) for s in range(14)])


@pytest.mark.parametrize("bad", [
    {"schedule_type": "fixed_discrete",
     "schedule_config": {"difficulty": [1, 2], "max_step": []}},
    {"schedule_type": "cosine"}])
def test_bad_curriculum_raises_as_jax(bad):
    with pytest.raises(ValueError) as want:
        jcur.CurriculumScheduler(jcur.CurriculumConfig.from_dict(bad))
    with pytest.raises(ValueError) as got:
        tcur.CurriculumScheduler(tcur.CurriculumConfig.from_dict(bad))
    assert str(got.value) == str(want.value)


def test_truncation_and_sampling_match_jax():
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 9, (2, 17)).astype(np.int32),
             "segment_ids": np.ones((2, 17), np.int32),
             "scale": np.float32(2.0), "loss_mask": np.ones((2, 17))}
    sched = {n: mod.CurriculumScheduler(mod.CurriculumConfig.from_dict(
        CURRICULA["linear"])) for n, mod in (("j", jcur), ("t", tcur))}
    for step in (0, 3, 20):
        want = jcur.apply_seqlen_curriculum(batch, sched["j"], step)
        got = tcur.apply_seqlen_curriculum(batch, sched["t"], step)
        _equal_batches([got], [want])
    tb = tcur.truncate_to_difficulty(torch.from_numpy(batch["tokens"]), 5)
    np.testing.assert_array_equal(
        tb.numpy(), np.asarray(jcur.truncate_to_difficulty(
            jnp.asarray(batch["tokens"]), 5)))
    assert tcur.ENGINE_SEQ_KEYS == jcur.ENGINE_SEQ_KEYS
    diffs = rng.random(50) * 10
    ji, ti = jcur.DifficultyIndexer(diffs, 3), tcur.DifficultyIndexer(diffs, 3)
    for ceiling in (0.0, 2.5, 11.0):
        np.testing.assert_array_equal(ti.eligible(ceiling),
                                      ji.eligible(ceiling))
        np.testing.assert_array_equal(ti.sample(8, ceiling),
                                      ji.sample(8, ceiling))


def _conf(**over):
    conf = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw",
                          "params": {"lr": 3e-3, "weight_decay": 0.1}}}
    conf.update(over)
    return conf


def test_initialize_returns_the_jax_dataloader():
    data = _dataset(18, 5)
    conf = _conf(seed=9)
    params = {"w": np.zeros((3,), np.float32)}
    _, _, dl, _ = initialize(loss_fn=lambda p, b: p["w"].sum(),
                             params=params, config=conf,
                             training_data=data, device="cpu")
    stub = types.SimpleNamespace(optimizer=None, lr_schedule=None)
    jdl = jeng._finish_initialize(stub, dstpu.Config.from_dict(conf),
                                  data)[2]
    assert isinstance(dl, tloader.DataLoader)
    assert (dl.batch_size, dl.seed) == (jdl.batch_size, jdl.seed) == (4, 9)
    _equal_batches(list(dl), list(jdl))
    assert initialize(loss_fn=lambda p, b: p["w"].sum(), params=params,
                      config=conf, device="cpu")[2] is None


def test_curriculum_drives_the_train_step_as_jax():
    """Packed batches through a seqlen curriculum (8 tokens, then 16):
    the same difficulty at every step, and the losses of the JAX engine."""
    cfg = jl.LlamaConfig.tiny()
    jp = jax.device_get(jl.init_params(jax.random.PRNGKey(0), cfg))
    conf = _conf(curriculum_learning={
        "enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8,
        "max_difficulty": 16, "schedule_config": {
            "total_curriculum_step": 2, "difficulty_step": 8}})
    mesh = MeshSpec.build({"data": 1}, devices=jax.devices()[:1])
    je, _, _, _ = dstpu.initialize(
        loss_fn=jl.loss_fn(cfg), params=jax.tree.map(jnp.asarray, jp),
        config=dict(conf), mesh=mesh)
    te, _, _, _ = initialize(loss_fn=tl.loss_fn(tl.LlamaConfig.tiny()),
                             params=from_jax_params(jp, device="cpu"),
                             config=dict(conf), device="cpu")
    assert isinstance(te.config.curriculum, tcur.CurriculumConfig)
    docs = _docs(1, 40, 2, 14, vocab=cfg.vocab_size)
    batches = list(tpack.PackedDataLoader(docs, 4, 16))[:4]
    diffs, jlosses, tlosses = [], [], []
    for b in batches:
        diffs.append((te.curriculum_difficulty(), je.curriculum_difficulty()))
        jlosses.append(float(je.train_batch(b)))
        tlosses.append(float(te.train_batch(b)))
    assert diffs == [(8, 8), (8, 8), (16, 16), (16, 16)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
