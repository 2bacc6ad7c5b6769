"""The port's KV fabric (``deepspeed_tpu_torch/kv_fabric.py``) and the
serving engine's fleet verbs against the JAX package's, on tiny GPT-2 and
tiny Llama with the same weights (``weights.from_jax_params``), f32 on the
CPU.

- ``export_pages`` entries are byte-equal to JAX's, crc32s included, for
  the same pages (the JAX engine's pages are scattered into the port's
  cache first; before that the port's own pages are held to JAX's at
  atol 1e-5, the f32 forward's difference), dense and ``quantize_cold``;
- admission: a deadline stops a slow fetch part-way, an in-fabric
  corruption falls back to re-prefill — tokens identical to JAX's single
  engine either way;
- a migration on an affinity miss, a migration whose export fails, and a
  prefill -> decode handoff (``fleet.roles``) give tokens, placements and
  fabric counts identical to JAX's ``fleet_router`` on the same traffic;
- an int8-resident engine exports its codes and scales verbatim and
  another admits them, token-identical to the exporter (the JAX engine is
  no oracle for ``quantized_resident``, ROADMAP C-f2)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import faults as jfaults
from deepspeed_tpu import fleet as jfleet
from deepspeed_tpu.inference.serving import serving_engine as jax_engine
from deepspeed_tpu.kv_fabric import KVFabric as JaxFabric
from deepspeed_tpu.models import gpt2 as jg
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu_torch import faults
from deepspeed_tpu_torch import fleet as tfleet
from deepspeed_tpu_torch.faults import FaultPlan
from deepspeed_tpu_torch.inference.prefix_cache import page_keys
from deepspeed_tpu_torch.inference.serving import serving_engine
from deepspeed_tpu_torch.kv_fabric import KVFabric
from deepspeed_tpu_torch.models import gpt2 as tg
from deepspeed_tpu_torch.models import llama as tl
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)

KW = dict(max_batch=2, page_size=8, num_pages=24, max_seq=64,
          prefill_bucket=8)
TIER = {"host_pool_bytes": 64 << 20}
KV_ATOL = 1e-5      # the f32 forwards of the two packages


@pytest.fixture(scope="module")
def gpt2():
    dims = dict(dim=64, n_layers=2, n_heads=4, max_seq_len=128)
    jc, tc = jg.GPT2Config.tiny(**dims), tg.GPT2Config.tiny(**dims)
    jp = jg.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def llama():
    dims = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2)
    jc, tc = jl.LlamaConfig.tiny(**dims), tl.LlamaConfig.tiny(**dims)
    jp = jl.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, from_jax_params(jax.device_get(jp), device="cpu")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    faults.clear_fault_plan()
    jfaults.clear_fault_plan()
    yield
    faults.clear_fault_plan()
    jfaults.clear_fault_plan()


def shared_prefix_prompts(vocab, n=4, seed=1, prefix_len=40, tail_len=3):
    rng = np.random.default_rng(seed)
    pref = rng.integers(1, vocab, prefix_len).tolist()
    return [pref + rng.integers(1, vocab, tail_len).tolist()
            for _ in range(n)]


def port_engine(model, **over):
    _, tc, _, tp = model
    kw = dict(KW, prefix_cache=True, kv_tier=dict(TIER), device="cpu",
              cache_dtype=torch.float32)
    kw.update(over)
    return serving_engine(tp, tc, **kw)


def jax_oracle(model, ps, max_new=6):
    jc, _, jp, _ = model
    eng = jax_engine(jp, jc, cache_dtype=jnp.float32, **KW)
    for i, p in enumerate(ps):
        eng.submit(f"o{i}", p, max_new_tokens=max_new)
    out = eng.run()
    eng.shutdown()
    return [out[f"o{i}"] for i in range(len(ps))]


@pytest.mark.parametrize("quantize", [False, True])
def test_export_entries_byte_equal_to_jax(gpt2, quantize):
    jc, _, jp, _ = gpt2
    tier = dict(TIER, quantize_cold=quantize)
    p = shared_prefix_prompts(jc.vocab_size, n=1, seed=3)[0]
    je = jax_engine(jp, jc, cache_dtype=jnp.float32, prefix_cache=True,
                    kv_tier=dict(tier), **KW)
    te = port_engine(gpt2, kv_tier=dict(tier))
    for e in (je, te):
        e.submit("w", p, max_new_tokens=4)
        e.run()
    keys = page_keys(p, KW["page_size"])
    pages = [te.allocator.index[k] for k in keys
             if k in te.allocator.index]
    jpages = [je.allocator.index[k] for k in keys[:len(pages)]]
    assert len(pages) == 5
    jk, jv = je._fetch_pages_host(jpages)
    tk, tv = te._fetch_pages_host(pages)
    np.testing.assert_allclose(tk, jk, atol=KV_ATOL, rtol=0)
    np.testing.assert_allclose(tv, jv, atol=KV_ATOL, rtol=0)
    te._upload_promoted(pages, np.asarray(jk), np.asarray(jv))
    jfab, tfab = JaxFabric(True), KVFabric(True)
    je.attach_fabric(jfab)
    te.attach_fabric(tfab)
    assert te.export_pages(keys) == je.export_pages(keys) == 5
    for k in keys[:5]:
        a, b = tfab.entries[k], jfab.entries[k]
        assert (a.buffers, a.checksums, a.nbytes, a.quantized, a.dtype) \
            == (b.buffers, b.checksums, b.nbytes, b.quantized, b.dtype)
        for x, y in zip(a.data, b.data):
            assert x.dtype == y.dtype
            assert x.tobytes() == np.asarray(y).tobytes()
    assert tfab.occupancy() == jfab.occupancy()
    assert te.check_leaks() == [] and je.check_leaks() == []
    je.shutdown()
    te.shutdown()


def _warm_and_export(model, prompt, fab, **over):
    src = port_engine(model, **over)
    src.submit("w", prompt, max_new_tokens=6)
    src.run()
    src.attach_fabric(fab)
    keys = page_keys(prompt, src.page_size)
    return src, src.export_pages(keys), keys


def test_corrupt_in_fabric_falls_back_to_reprefill(gpt2):
    ps = shared_prefix_prompts(gpt2[0].vocab_size, n=2, seed=9)
    want = jax_oracle(gpt2, ps)
    fab = KVFabric(True)
    plan = FaultPlan([{"subsystem": "fabric", "mode": "error",
                       "match": "corrupt", "count": 2}])
    faults.install_fault_plan(plan)
    src, n_exp, _ = _warm_and_export(gpt2, ps[0], fab)
    faults.clear_fault_plan(plan)
    assert n_exp == 5 and fab.corrupted == 2
    dst = port_engine(gpt2)
    dst.attach_fabric(fab)
    for i, p in enumerate(ps):
        dst.admit_fabric(page_keys(p, dst.page_size))
        dst.submit(f"m{i}", p, max_new_tokens=6)
    out = dst.run()
    assert [out[f"m{i}"] for i in range(len(ps))] == want
    assert dst.kv_tier_checksum_failures > 0
    assert dst.kv_tier_fallback_events > 0
    assert dst.check_leaks() == [] and src.check_leaks() == []
    src.shutdown()
    dst.shutdown()


def test_admission_deadline_stops_a_slow_fetch(gpt2):
    ps = shared_prefix_prompts(gpt2[0].vocab_size, n=1, seed=10)
    fab = KVFabric(True)
    src, n_exp, keys = _warm_and_export(gpt2, ps[0], fab)
    assert n_exp == 5
    faults.install_fault_plan(FaultPlan([
        {"subsystem": "fabric", "mode": "latency", "latency_s": 0.05,
         "match": "fetch"}]))
    dst = port_engine(gpt2)
    dst.attach_fabric(fab)
    n = dst.admit_fabric(keys, deadline=time.perf_counter() + 0.08)
    faults.clear_fault_plan()
    assert 0 < n < n_exp                    # partial, chain-valid
    dst.submit("m", ps[0], max_new_tokens=6)
    assert dst.run()["m"] == jax_oracle(gpt2, ps)[0]
    assert dst.check_leaks() == []
    with pytest.raises(ValueError, match="kv_tier"):
        port_engine(gpt2, kv_tier=None).attach_fabric(fab)
    src.shutdown()
    dst.shutdown()


def _fleet_run(mod, model, plan, waves, fleet, faults_=None, max_new=6):
    """Serve ``waves`` (lists of (rid, prompt)) through a fabric fleet of
    ``mod``; returns the outputs, each request's first placement and the
    fabric counts."""
    jc, tc, jp, tp = model
    port = mod is tfleet
    kw = dict(KW, prefix_cache=True, kv_tier=dict(TIER))
    kw.update(dict(device="cpu", cache_dtype=torch.float32) if port
              else dict(cache_dtype=jnp.float32))
    r = mod.fleet_router(tp if port else jp, tc if port else jc,
                         fleet=fleet, fabric=True, faults=faults_, **kw)
    placed = {}
    for wave in waves:
        for rid, p in wave:
            r.submit(rid, p, max_new_tokens=max_new)
            placed[rid] = r.requests[rid].replica
        r.run()
    out = dict(r.finished)
    st = r.statusz()["fleet"]
    fab = {k: st["fabric"][k] for k in (
        "migrations", "migration_fallbacks", "handoffs", "exports",
        "fetches", "export_failures")}
    assert r.check_leaks() == [] and r.orphaned() == []
    r.shutdown()
    return out, placed, fab


@pytest.mark.parametrize("case", ["migration", "export_fault", "handoff"])
def test_fleet_fabric_paths_identical_to_jax(gpt2, case):
    ps = shared_prefix_prompts(gpt2[0].vocab_size, n=4, seed=11)
    traffic = [[(f"m{i}", p) for i, p in enumerate(ps)]]
    fleet = {"replicas": 2, "affinity": False, "digest_refresh_steps": 1}
    rules = None
    if case == "handoff":
        fleet = {"replicas": 3, "digest_refresh_steps": 1,
                 "roles": {"prefill": 1, "decode": 2}}
    else:
        traffic.insert(0, [("w", ps[0])])
    if case == "export_fault":
        rules = {"rules": [{"subsystem": "fabric", "mode": "error",
                            "match": "export", "count": 1}]}
    want = _fleet_run(jfleet, gpt2, None, traffic, fleet, rules)
    got = _fleet_run(tfleet, gpt2, None, traffic, fleet, rules)
    assert got == want
    out, _, fab = got
    assert [out[f"m{i}"] for i in range(4)] == jax_oracle(gpt2, ps)
    if case == "migration":
        assert fab["migrations"] >= 1 and fab["migration_fallbacks"] == 0
    elif case == "export_fault":
        assert fab["migration_fallbacks"] >= 1
        assert fab["export_failures"] >= 1
    else:
        assert fab["handoffs"] == 4 and fab["migrations"] >= 1


def test_handoff_on_llama_split_fuse_identical_to_jax(llama):
    ps = shared_prefix_prompts(llama[0].vocab_size, n=3, seed=15)
    fleet = {"replicas": 2, "digest_refresh_steps": 1,
             "roles": {"prefill": 1, "decode": 1}}
    traffic = [[(f"d{i}", p) for i, p in enumerate(ps)]]
    assert _fleet_run(tfleet, llama, None, traffic, fleet) == \
        _fleet_run(jfleet, llama, None, traffic, fleet)


def test_int8_resident_chain_exports_and_admits_verbatim(llama):
    tier = dict(TIER, quantize_cold=True, quantized_resident=True)
    ps = shared_prefix_prompts(llama[0].vocab_size, n=2, seed=21)
    fab = KVFabric(True)
    src, n_exp, keys = _warm_and_export(llama, ps[0], fab,
                                        kv_tier=dict(tier))
    assert n_exp == 5
    planes = src._fetch_pages_host([src.allocator.index[k]
                                    for k in keys[:n_exp]])
    for j, k in enumerate(keys[:n_exp]):
        e = fab.entries[k]
        assert e.quantized and len(e.data) == 4
        for a, plane in zip(e.data, planes):
            np.testing.assert_array_equal(a, plane[:, :, j])
    src.submit("s1", ps[1], max_new_tokens=6)
    want = src.run()["s1"]
    dst = port_engine(llama, kv_tier=dict(tier))
    dst.attach_fabric(fab)
    assert dst.admit_fabric(page_keys(ps[1], dst.page_size)) == n_exp
    dst.submit("s1", ps[1], max_new_tokens=6)
    assert dst.run()["s1"] == want
    assert dst.kv_tier_quant_resident_promotes > 0
    assert dst.kv_tier_fallback_events == 0
    assert dst.check_leaks() == [] and src.check_leaks() == []
    src.shutdown()
    dst.shutdown()
