"""The port's serving control plane (``inference/control_plane.py`` on the
paged engine) against the JAX engine, on tiny Llama in f32 with f32 caches
(greedy tokens are compared for identity there, ROADMAP C-w2):

- the same seeded ``slot`` fault plan (three named requests: one failed in
  prefill, two in decode), the same queue-depth shedding and a request
  whose tier deadline expired in the queue (its arrival passed through
  ``submit(arrival=)``, so the verdict does not hang on the wall clock)
  give the same typed results per request — tokens, ``RequestShed``
  reasons, ``RequestFailed`` reasons and generated counts — in both
  engines; the failed requests' neighbours keep their tokens;
- the finished, failed and shed counts reconcile with the submissions
  across the typed results, the telemetry counters and the SLO tracker;
  ``check_leaks()`` is empty after every mix of failures;
- every block on (telemetry sinks off, tracing, slo, history, incidents,
  devprof sampling every phase) leaves the tokens of the engine with the
  blocks off unchanged, and ``statusz`` / ``healthz`` / ``requestz`` /
  ``historyz`` carry the JAX engine's keys (JAX's engine there without
  devprof, whose warmup compiles every program; the devprof block is held
  to the JAX module's in test_torch_devprof_profiler_monitor.py);
- a ``kv_corrupt`` rule on the KV tier's demotes is caught by the promote
  crc and the span re-prefills to the same tokens;
- ``take_queued`` and ``abandon_inflight`` release everything, and a
  dropped engine with every block on frees without the cycle collector;
- the encoder families refuse the paged-only blocks as JAX's registry
  does.

Every engine is shut down (its fault plan cleared) in a ``finally``."""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from deepspeed_tpu.inference import serving as jsv
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu_torch import faults as tfaults
from deepspeed_tpu_torch.inference import serving as tsv
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

BASE = dict(max_batch=3, page_size=8, num_pages=40, max_seq=64,
            prefill_bucket=8, prefill_chunk=8)
SLO = {"tiers": {"gold": {"ttft_s": 1e3, "deadline_s": 1e3},
                 "late": {"deadline_s": 5.0}},
       "default_tier": "gold"}
FAULTS = {"seed": 7, "rules": [
    {"subsystem": "slot", "match": "r1", "count": 1},            # prefill
    {"subsystem": "slot", "match": "r2", "after": 3, "count": 1},
    {"subsystem": "slot", "match": "r4", "after": 4, "count": 1}]}
CP = dict(slo=SLO, faults=FAULTS, shed_queue_depth=6,
          shed_expired_deadline=True)


@pytest.fixture(scope="module")
def model():
    cfg = jl.LlamaConfig.tiny()
    host = td.numpy_params(jl.init_params, cfg, seed=0)
    jp = jax.tree.map(jnp.asarray, host)
    tp = from_jax_params(host, device="cpu")
    return cfg, tl.LlamaConfig.tiny(), jp, tp


def _prompts(n=8, seed=3):
    rng = np.random.default_rng(seed)
    return {f"r{i}": rng.integers(1, 256, int(rng.integers(9, 20))).tolist()
            for i in range(n)}


def _engine(model, side, **kw):
    cfg, tcfg, jp, tp = model
    opts = dict(BASE, **kw)
    if side == "jax":
        return jsv.llama_serving_engine(jp, cfg, cache_dtype=jnp.float32,
                                        **opts)
    return tsv.llama_serving_engine(tp, tcfg, cache_dtype=torch.float32,
                                    device="cpu", **opts)


def _typed(res):
    """A typed result of either package as plain data."""
    if isinstance(res, list):
        return ("tokens", [int(t) for t in res])
    name = type(res).__name__
    if name == "RequestShed":
        return ("shed", res.reason, res.tier)
    return ("failed", res.reason, res.error, res.tier, res.generated)


def _drive(eng, prompts, new_tokens=8):
    late = eng.submit("late", [5, 6, 7, 8, 9], max_new_tokens=4,
                      tier="late", arrival=time.perf_counter() - 100.0)
    assert late is None
    sheds = {}
    for rid, p in prompts.items():
        out = eng.submit(rid, p, max_new_tokens=new_tokens)
        if out is not None:
            sheds[rid] = out
    res = eng.run()
    return {rid: _typed(r) for rid, r in res.items()}, sheds


def _reconcile(eng, typed, submitted):
    kinds = [v[0] for v in typed.values()]
    n_tok, n_shed, n_fail = (kinds.count(k)
                             for k in ("tokens", "shed", "failed"))
    assert n_tok + n_shed + n_fail == submitted == len(typed)
    c = eng.registry.snapshot()["counters"]
    assert c["serving_shed_requests"] == n_shed
    assert c["serving_failed_requests"] == n_fail
    life = [t["lifetime"] for t in
            eng.slo_tracker.snapshot()["tiers"].values()]
    assert sum(x["shed"] for x in life) == n_shed
    assert sum(x["failed"] for x in life) == n_fail
    # a failure is counted failed AND violated (the user got nothing)
    assert sum(x["attained"] + x["violated"] for x in life) == \
        n_tok + n_fail
    rb = eng.statusz()["robustness"]
    assert (rb["shed_requests"], rb["failed_requests"]) == (n_shed, n_fail)


def test_faults_and_shedding_give_jax_typed_results(model):
    prompts = _prompts()
    out = {}
    for side in ("jax", "torch"):
        eng = _engine(model, side, **CP)
        try:
            typed, sheds = _drive(eng, prompts)
            assert eng.check_leaks() == []
            _reconcile(eng, typed, len(prompts) + 1)
            out[side] = typed, sorted(sheds)
        finally:
            eng.shutdown()
    assert out["torch"] == out["jax"]
    typed = out["torch"][0]
    assert typed["late"] == ("shed", "deadline", "late")
    assert [r for r, v in typed.items() if v[0] == "shed"
            and v[1] == "queue_depth"] == ["r5", "r6", "r7"]
    failed = {r: v for r, v in typed.items() if v[0] == "failed"}
    assert sorted(failed) == ["r1", "r2", "r4"]
    assert all(v[1] == "slot_exception" and "InjectedFault" in v[2]
               for v in failed.values())
    assert failed["r1"][4] == 0 and failed["r2"][4] > 0
    assert tfaults.active_plan() is None


def test_neighbours_of_failed_slots_keep_their_tokens(model):
    prompts = _prompts()
    plain = _engine(model, "torch")
    eng = _engine(model, "torch", faults=FAULTS)
    try:
        for e in (plain, eng):
            for rid, p in prompts.items():
                e.submit(rid, p, max_new_tokens=8)
        want, got = plain.run(), eng.run()
        assert eng.check_leaks() == [] and plain.check_leaks() == []
    finally:
        eng.shutdown()
    for rid, toks in got.items():
        if isinstance(toks, list):
            assert toks == want[rid], rid
        else:
            assert isinstance(toks, tsv.RequestFailed), rid
    assert sum(isinstance(v, tsv.RequestFailed) for v in got.values()) == 3


ALL_ON = dict(telemetry={"enabled": True}, tracing={"sample_rate": 1.0},
              slo=SLO, history={"sample_interval_s": 0.01},
              incidents={"eval_interval_s": 0.01},
              devprof={"sample_rate": 1.0})


def test_blocks_on_leave_tokens_unchanged_and_documents_match_jax(
        model, tmp_path):
    prompts = _prompts(n=5, seed=4)
    on = dict(ALL_ON, incidents={"eval_interval_s": 0.01,
                                 "dir": str(tmp_path / "inc")},
              tracing={"sample_rate": 1.0, "dump_dir": str(tmp_path)})
    off = _engine(model, "torch", telemetry=False, tracing=False)
    eng = _engine(model, "torch", **on)
    # devprof's warmup compiles every JAX program: its block is held to
    # the JAX module's in test_torch_devprof_profiler_monitor.py
    je = _engine(model, "jax", **dict(on, devprof=None))
    try:
        for e in (off, eng, je):
            for rid, p in prompts.items():
                e.submit(rid, p, max_new_tokens=6)
        want, got = off.run(), eng.run()
        jgot = je.run()
        assert got == want == {k: list(map(int, v))
                               for k, v in jgot.items()}
        assert eng.check_leaks() == []
        docs = {"statusz": (eng.statusz(), je.statusz()),
                "healthz": (eng.healthz(), je.healthz()),
                "requestz": (eng.requestz("r1"), je.requestz("r1")),
                "historyz": (eng.historyz(), je.historyz())}
        for name, (t, j) in docs.items():
            json.dumps(t)
            assert set(t) == set(j), name
        st = docs["statusz"][0]
        for key in ("kv", "prefix_cache", "kv_tier", "speculative",
                    "robustness", "slo", "incidents"):
            assert set(st[key]) == set(docs["statusz"][1][key]), key
        assert docs["requestz"][0]["state"] == "finished"
        assert [e["phase"] for e in docs["requestz"][0]["events"]][:2] == \
            ["queued", "admitted"]
        dev = eng.profilez()
        assert dev["enabled"] and dev["device_seconds"]["decode"] > 0
        assert dev["device_seconds"]["prefill"] > 0
        h = eng.registry.snapshot()["histograms"]
        assert h["serving_ttft_seconds"]["count"] == len(prompts)
    finally:
        for e in (off, eng, je):
            e.shutdown()


def test_dropped_engine_with_every_block_frees_without_the_cycle_collector(
        model, tmp_path):
    """The exporter's providers and tick hooks, the incident manager's
    statusz and an attached watchdog hold the engine weakly: on the card a
    dropped engine's weights and KV pool must come back at ``del``."""
    import gc
    import weakref

    from deepspeed_tpu_torch.utils.watchdog import Watchdog

    on = dict(ALL_ON, incidents={"eval_interval_s": 0.01,
                                 "dir": str(tmp_path / "inc")},
              telemetry={"prometheus_path": str(tmp_path / "m.prom")},
              faults=FAULTS, shed_queue_depth=6,
              shed_expired_deadline=True, prefix_cache={},
              kv_tier={"demote_watermark": 0.0})
    eng = _engine(model, "torch", **on)
    wd = Watchdog(timeout_s=600.0, abort_on_timeout=False)
    eng.attach_watchdog(wd)
    for rid, p in _prompts(n=4).items():
        eng.submit(rid, p, max_new_tokens=4)
    eng.run()
    eng.shutdown()
    gone = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert gone() is None
    finally:
        gc.enable()


def test_kv_corrupt_pages_re_prefill_to_the_same_tokens(model):
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 256, 20).tolist()
    waves = [{f"{w}{i}": shared + rng.integers(1, 256, 4).tolist()
              for i in range(3)} for w in "ab"]
    kvt = {"prefix_cache": {}, "kv_tier": {"demote_watermark": 0.0}}
    outs = []
    for faults in (None, {"rules": [{"subsystem": "kv_corrupt"}]}):
        eng = _engine(model, "torch", faults=faults, **kvt)
        try:
            out = {}
            for i, wave in enumerate(waves):
                if i:
                    eng.step()              # the idle step demotes
                for rid, p in wave.items():
                    eng.submit(rid, p, max_new_tokens=6)
                out.update(eng.run())
                assert eng.check_leaks() == []
            outs.append((out, eng.kv_tier_checksum_failures,
                         eng.allocator.demoted))
        finally:
            eng.shutdown()
    (clean, n0, d0), (hit, n1, d1) = outs
    assert hit == clean and n0 == 0 and d0 > 0 and n1 > 0


def test_take_queued_and_abandon_inflight_release_everything(model):
    eng = _engine(model, "torch", slo=SLO)
    try:
        for rid, p in _prompts(n=6).items():
            eng.submit(rid, p, max_new_tokens=8)
        eng.step()
        eng.step()
        queued = eng.take_queued()
        inflight = eng.abandon_inflight()
        assert len(queued) + len(inflight) == 6 and inflight
        assert not eng.has_work and eng.check_leaks() == []
        assert eng.healthz()["ready"] and eng.mesh_info()["devices"] == 1
    finally:
        eng.shutdown()
    assert not eng.healthz()["ready"]
    with pytest.raises(tsv.EngineClosed):
        eng.submit("x", [1, 2])


@pytest.mark.parametrize("block", [
    {"faults": {}}, {"shed_queue_depth": 2}, {"shed_expired_deadline": True},
    {"slo": {}}])
def test_encoder_families_refuse_paged_only_blocks_like_jax(model, block):
    from deepspeed_tpu.models import bert as jb
    from deepspeed_tpu_torch.models import bert as tb

    with pytest.raises(NotImplementedError) as want:
        jsv.serving_engine({}, jb.BertConfig.tiny(), **block)
    with pytest.raises(NotImplementedError) as got:
        tsv.serving_engine({}, tb.BertConfig.tiny(), device="cpu", **block)
    assert str(got.value) == str(want.value)
