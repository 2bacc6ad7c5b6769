"""HF checkpoints in and out of the port (``integrations/hf.py``,
``inference/injection.py``, ``io/safetensors.py``) against the JAX
package: the port's ``save_pretrained`` read by the JAX ``from_pretrained``
and the JAX file read by the port's (leaves bit for bit, f32 tiny-Llama
logits at the JAX test's 1e-4); the port's safetensors files against the
installed ``safetensors`` package both ways, BF16 included, and sharded
checkpoints; a ``pytorch_model.bin`` directory; the Mixtral converter
against JAX's ``_mixtral_weights`` on one synthetic HF state dict (exact)
and its ``forward_eval`` logits at 1e-4; an unknown architecture raises."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as lib_save_file

from deepspeed_tpu.inference import injection as jinj
from deepspeed_tpu.integrations import hf as jhf
from deepspeed_tpu.models import llama as jl
from deepspeed_tpu.models import mixtral as jm
from deepspeed_tpu_torch import from_pretrained, inject, save_pretrained
from deepspeed_tpu_torch._tree import tree_leaves, tree_leaves_with_path
from deepspeed_tpu_torch.inference import injection as tinj
from deepspeed_tpu_torch.integrations import hf as thf
from deepspeed_tpu_torch.io import safetensors as tst
from deepspeed_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def llama_tiny():
    cfg = jl.LlamaConfig.tiny(attn_impl="reference")
    params = jax.tree.map(lambda x: np.asarray(x, np.float32),
                          jl.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, params


def _tokens(seed=1, shape=(2, 8)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _same_tree(jtree, ttree):
    jl_ = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl_ = tree_leaves_with_path(ttree)
    assert len(jl_) == len(tl_)
    for (jp, a), (tp, b) in zip(jl_, tl_):
        assert "/".join(k.key for k in jp) == tp
        np.testing.assert_array_equal(
            b.float().numpy(), np.asarray(a, np.float32), err_msg=tp)


def test_jax_checkpoint_into_the_port(llama_tiny, tmp_path):
    cfg, params = llama_tiny
    jhf.save_pretrained(params, cfg, str(tmp_path))
    fn, tp, tcfg, specs = from_pretrained(str(tmp_path), dtype=torch.float32,
                                          device="cpu")
    assert specs is None                 # no TP spec trees before A9
    assert (tcfg.dim, tcfg.n_layers, tcfg.n_kv_heads) == (
        cfg.dim, cfg.n_layers, cfg.n_kv_heads)
    _same_tree(params, tp)
    toks = _tokens()
    want = jl.forward(params, jnp.asarray(toks), cfg)
    np.testing.assert_allclose(fn(tp, torch.from_numpy(toks)).numpy(),
                               np.asarray(want), **TOL)
    # the JAX file (written by the safetensors package) read by the
    # port's reader: every tensor bit for bit
    path = str(tmp_path / "model.safetensors")
    mine = tst.SafeTensorsFile(path)
    with safe_open(path, framework="np") as f:
        assert sorted(f.keys()) == sorted(mine.keys())
        for k in f.keys():
            np.testing.assert_array_equal(mine.get(k).numpy(),
                                          f.get_tensor(k))


def test_port_checkpoint_into_jax(llama_tiny, tmp_path):
    cfg, params = llama_tiny
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jhf.save_pretrained(params, cfg, str(jdir))
    nbytes = save_pretrained(from_jax_params(params, device="cpu"), cfg,
                             str(tdir))
    assert nbytes == os.path.getsize(tdir / "model.safetensors")
    assert json.loads((tdir / "config.json").read_text()) == \
        json.loads((jdir / "config.json").read_text())
    fn, jp, jcfg, _ = jhf.from_pretrained(str(tdir), dtype=jnp.float32)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the same tensors, names, dtypes and shapes as the JAX exporter's
    with safe_open(str(jdir / "model.safetensors"), "np") as fj, \
            safe_open(str(tdir / "model.safetensors"), "np") as ft:
        assert sorted(fj.keys()) == sorted(ft.keys())
        for k in fj.keys():
            a, b = fj.get_tensor(k), ft.get_tensor(k)
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert ft.metadata() == {"format": "pt"}


def test_bf16_load_and_bf16_tree_export(llama_tiny, tmp_path):
    cfg, params = llama_tiny
    jhf.save_pretrained(params, cfg, str(tmp_path / "a"))
    _, tp, _, _ = from_pretrained(str(tmp_path / "a"), device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    _, jp, _, _ = jhf.from_pretrained(str(tmp_path / "a"))    # bf16 too
    _same_tree(jp, tp)
    # bf16 -> f32 file -> bf16 is exact
    save_pretrained(tp, cfg, str(tmp_path / "b"))
    _, back, _, _ = from_pretrained(str(tmp_path / "b"), device="cpu")
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert torch.equal(a, b)


def test_pytorch_bin_directory(llama_tiny, tmp_path):
    cfg, params = llama_tiny
    jhf.save_pretrained(params, cfg, str(tmp_path / "st"))
    with safe_open(str(tmp_path / "st" / "model.safetensors"), "pt") as f:
        sd = {k: f.get_tensor(k) for k in f.keys()}
    bdir = tmp_path / "bin"
    bdir.mkdir()
    names = sorted(sd)
    torch.save({k: sd[k] for k in names[::2]},
               bdir / "pytorch_model-00001-of-00002.bin")
    torch.save({k: sd[k].to(torch.bfloat16) for k in names[1::2]},
               bdir / "pytorch_model-00002-of-00002.bin")
    (bdir / "config.json").write_text(
        (tmp_path / "st" / "config.json").read_text())
    loaded = thf.load_state_dict(str(bdir))
    assert sorted(loaded) == names
    assert loaded[names[1]].dtype == torch.bfloat16
    _, tp, _, _ = from_pretrained(str(bdir), dtype=torch.float32,
                                  device="cpu")
    _, jp, _, _ = jhf.from_pretrained(str(bdir), dtype=jnp.float32)
    _same_tree(jp, tp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int64, torch.int32,
                                   torch.int8, torch.uint8, torch.bool])
def test_safetensors_against_the_package(dtype, tmp_path):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(5, 7, generator=g) * 50)
    x = x > 0 if dtype == torch.bool else x.to(dtype)
    tensors = {"x": x, "scalar": x.reshape(-1)[:1].reshape(()).clone(),
               "empty": x[:0].clone(), "col": x[:, 2:3].contiguous()}
    tst.save_file(tensors, str(tmp_path / "mine.safetensors"),
                  {"note": "port"})
    with safe_open(str(tmp_path / "mine.safetensors"), "pt") as f:
        assert f.metadata() == {"note": "port"}
        for k, t in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == t.dtype and torch.equal(got, t), k
    lib_save_file(tensors, str(tmp_path / "lib.safetensors"))
    back = tst.load_file(str(tmp_path / "lib.safetensors"))
    assert sorted(back) == sorted(tensors)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


def test_sharded_safetensors_and_fresh_maps(llama_tiny, tmp_path):
    cfg, params = llama_tiny
    jhf.save_pretrained(params, cfg, str(tmp_path / "one"))
    with safe_open(str(tmp_path / "one" / "model.safetensors"), "pt") as f:
        sd = {k: f.get_tensor(k) for k in f.keys()}
    names = sorted(sd)
    sharded = tmp_path / "two"
    sharded.mkdir()
    lib_save_file({k: sd[k] for k in names[:7]},
                  str(sharded / "model-00001-of-00002.safetensors"))
    tst.save_file({k: sd[k] for k in names[7:]},
                  str(sharded / "model-00002-of-00002.safetensors"))
    (sharded / "config.json").write_text(
        (tmp_path / "one" / "config.json").read_text())
    lazy = thf.load_state_dict(str(sharded))
    assert isinstance(lazy, thf.ShardedStateDict) and len(lazy) == len(sd)
    a, b = lazy[names[0]], lazy[names[0]]
    assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()  # not cached
    a.zero_()                           # a private map: the file is intact
    assert torch.equal(lazy[names[0]], sd[names[0]])
    _, tp, _, _ = from_pretrained(str(sharded), dtype=torch.float32,
                                  device="cpu")
    _same_tree(params, tp)


def test_rejects_bad_headers(tmp_path):
    p = tmp_path / "bad.safetensors"
    tst.save_file({"x": torch.zeros(4)}, str(p))
    raw = bytearray(p.read_bytes())
    p.write_bytes(bytes(raw[:-4]))      # the data is cut short
    with pytest.raises(ValueError, match="spans"):
        tst.SafeTensorsFile(str(p))
    with pytest.raises(ValueError, match="repeated"):
        tst.write_file(str(tmp_path / "r.safetensors"),
                       [("a", torch.float32, (1,)), ("a", torch.float32,
                                                      (1,))],
                       lambda n: torch.zeros(1))
    with pytest.raises(ValueError, match="header says"):
        tst.write_file(str(tmp_path / "s.safetensors"),
                       [("a", torch.float32, (2,))],
                       lambda n: torch.zeros(3))
    assert not (tmp_path / "s.safetensors").exists()


def _mixtral_hf(cfg, seed=0):
    """A synthetic HF Mixtral state dict (HF names, [out, in] matrices)."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.dim, cfg.ffn_dim, cfg.num_experts
    kvd = cfg.n_kv_heads * (d // cfg.n_heads)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(cfg.vocab_size, d),
          "model.norm.weight": 1 + w(d), "lm_head.weight": w(cfg.vocab_size,
                                                             d)}
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        sd.update({
            pre + "input_layernorm.weight": 1 + w(d),
            pre + "post_attention_layernorm.weight": 1 + w(d),
            pre + "self_attn.q_proj.weight": w(d, d),
            pre + "self_attn.k_proj.weight": w(kvd, d),
            pre + "self_attn.v_proj.weight": w(kvd, d),
            pre + "self_attn.o_proj.weight": w(d, d),
            pre + "block_sparse_moe.gate.weight": w(E, d)})
        for e in range(E):
            moe = pre + f"block_sparse_moe.experts.{e}."
            sd.update({moe + "w1.weight": w(f, d), moe + "w3.weight": w(f, d),
                       moe + "w2.weight": w(d, f)})
    return sd


def _mixtral_hf_config(cfg):
    return {"architectures": ["MixtralForCausalLM"],
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.ffn_dim,
            "num_local_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.top_k,
            "max_position_embeddings": cfg.max_seq_len,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps}


def test_mixtral_converter_and_forward_eval_match_jax():
    jcfg = jm.MixtralConfig.tiny()
    sd = _mixtral_hf(jcfg)
    hf_cfg = _mixtral_hf_config(jcfg)
    want_tree = jinj._mixtral_weights(sd, jinj._mixtral_config(hf_cfg))
    fn, tp, tcfg, specs = inject("MixtralForCausalLM", hf_cfg,
                                 {k: torch.from_numpy(v)
                                  for k, v in sd.items()},
                                 dtype=torch.float32, device="cpu")
    assert specs is None and tcfg.num_experts == jcfg.num_experts
    _same_tree(want_tree, tp)
    jfn, jp, _, _ = jinj.inject("MixtralForCausalLM", hf_cfg, sd,
                                dtype=jnp.float32)
    toks = _tokens(3, (2, 12))
    np.testing.assert_allclose(fn(tp, torch.from_numpy(toks)).numpy(),
                               np.asarray(jfn(jp, jnp.asarray(toks))), **TOL)
    # numpy values in the state dict are taken as they are
    _, tp2, _, _ = tinj.inject("mixtral", hf_cfg, sd, dtype=torch.float32,
                               device="cpu")
    for a, b in zip(tree_leaves(tp2), tree_leaves(tp)):
        assert torch.equal(a, b)


def test_policies_and_unknown_arch():
    with pytest.raises(ValueError, match="no injection policy"):
        tinj.get_policy("gpt_neox")
    with pytest.raises(ValueError, match="no injection policy"):
        inject("BloomForCausalLM", {})
    for arch in ("llama", "LlamaForCausalLM", "mixtral",
                 "MixtralForCausalLM"):
        assert tinj.get_policy(arch).arch.lower() == arch.lower()
    fn, params, cfg, specs = inject("llama", {"hidden_size": 64,
                                              "num_hidden_layers": 2,
                                              "num_attention_heads": 4,
                                              "vocab_size": 256},
                                    attn_impl="reference")
    assert params is None and specs is None and cfg.attn_impl == "reference"
    with pytest.raises(NotImplementedError, match="ring"):
        inject("llama", {"hidden_size": 64, "num_attention_heads": 4},
               attn_impl="ring")


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        thf.load_state_dict(str(tmp_path))
