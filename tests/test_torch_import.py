"""The PyTorch port imports without JAX and never reaches the JAX
package; its entry points refuse to fall back to the CPU silently."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "torch_decode_profile.py",
    ROOT / "tools" / "torch_flash_fwd_bench.py",
    ROOT / "tools" / "torch_flash_bwd_bench.py"]


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['deepspeed_tpu'] = None\n"
        "sys.modules['safetensors'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import deepspeed_tpu_torch\n"
        "from deepspeed_tpu_torch.inference import serving, kernels, "
        "paged_attention_cuda, prefix_cache, kv_tier, quantized\n"
        "from deepspeed_tpu_torch.inference import engine as ie\n"
        "from deepspeed_tpu_torch.inference import InferenceEngine, "
        "init_inference, init_serving\n"
        "from deepspeed_tpu_torch import faults, param_stream, env_report\n"
        "from deepspeed_tpu_torch.models import llama, gpt2, mixtral, bert, "
        "cnn\n"
        "from deepspeed_tpu_torch.inference import encoder_serving\n"
        "from deepspeed_tpu_torch.ops import rounding\n"
        "from deepspeed_tpu_torch import BertConfig, CNNConfig, "
        "bert_serving_engine, CNNServingEngine, EncoderServingEngine, "
        "stochastic_round_bf16, stochastic_round_tree\n"
        "from deepspeed_tpu_torch.models import BertConfig as B2\n"
        "from deepspeed_tpu_torch.ops import attention, attention_cuda, "
        "sampling_cuda, fused_ops, _build, optim, adam_cuda, losses, "
        "quant, quant_cuda\n"
        "from deepspeed_tpu_torch import weights, engine, config, "
        "precision, lr_schedules\n"
        "from deepspeed_tpu_torch import initialize, TrainingEngine, "
        "fused_adam, init_inference, init_serving\n"
        "from deepspeed_tpu_torch import checkpoint, remat, timers\n"
        "from deepspeed_tpu_torch.data import loader, packing, curriculum\n"
        "from deepspeed_tpu_torch import DataLoader, PackedDataLoader, "
        "from_jax_train_state, zero_to_fp32\n"
        "from deepspeed_tpu_torch.inference import zero_inference, "
        "speculative\n"
        "from deepspeed_tpu_torch.io import aio\n"
        "from deepspeed_tpu_torch.utils import ctypes_build\n"
        "from deepspeed_tpu_torch import infinity\n"
        "from deepspeed_tpu_torch.io import native, safetensors\n"
        "from deepspeed_tpu_torch.ops import cpu_adam\n"
        "from deepspeed_tpu_torch.inference import injection\n"
        "from deepspeed_tpu_torch.integrations import hf, trainer\n"
        "from deepspeed_tpu_torch import lora, distill, hybrid\n"
        "from deepspeed_tpu_torch import from_pretrained, save_pretrained, "
        "inject, LoRAConfig, init_lora, lora_loss_fn, merge_lora, "
        "Distiller, Trainer, TrainingArguments, HostBufferPool, "
        "ShuffleIndexService, cpu_adam_step, init_hybrid_engine, "
        "HybridEngine\n"
        "from deepspeed_tpu_torch import offload\n"
        "from deepspeed_tpu_torch.param_stream import ParamStreamEngine, "
        "LayeredModel\n"
        "from deepspeed_tpu_torch.infinity import InfinityEngine\n"
        "from deepspeed_tpu_torch import ParamStreamEngine as P2, "
        "InfinityEngine as I2, LayeredModel as L2, NvmeSwapper\n"
        "from deepspeed_tpu_torch import comm, topology, mesh, zero, "
        "launcher, comm_compress\n"
        "from deepspeed_tpu_torch.comm import collectives\n"
        "from deepspeed_tpu_torch.parallel import tensor_parallel, "
        "sequence_parallel, ring_attention, pipeline, moe\n"
        "from deepspeed_tpu_torch.inference import sharded\n"
        "from deepspeed_tpu_torch.ops import onebit\n"
        "from deepspeed_tpu_torch.utils import trace\n"
        "from deepspeed_tpu_torch import transport, kv_fabric, obs_wire, "
        "fleet, autoscale, proc_fleet, replica_child\n"
        "from deepspeed_tpu_torch.fleet import fleet_router, FleetRouter\n"
        "from deepspeed_tpu_torch.autoscale import FleetAutoscaler\n"
        "from deepspeed_tpu_torch.proc_fleet import proc_fleet_router, "
        "ProcEngine\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and (m in ('jax', 'deepspeed_tpu') "
        "or m.startswith(('jax.', 'deepspeed_tpu.')))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path)
           if m == "jax" or m.startswith("jax.") or m == "deepspeed_tpu"
           or m.startswith("deepspeed_tpu.")]
    assert not bad, f"{path.name} imports {bad}"


def test_serving_engine_without_device_raises_on_cpu(monkeypatch):
    from deepspeed_tpu_torch.inference.serving import serving_engine
    from deepspeed_tpu_torch.models.llama import LlamaConfig
    from deepspeed_tpu_torch.weights import init_params

    cfg = LlamaConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving_engine(params, cfg)
    eng = serving_engine(params, cfg, device="cpu")
    assert eng.device.type == "cpu"


def test_initialize_without_device_raises_on_cpu(monkeypatch):
    from deepspeed_tpu_torch import initialize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {"w": torch.zeros(3)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize(loss_fn=lambda p, b: p["w"].sum(), params=params,
                   config={})
    eng, _, _, _ = initialize(loss_fn=lambda p, b: p["w"].sum(),
                              params=params, config={}, device="cpu")
    assert eng.device.type == "cpu"


def test_resolve_device_rules(monkeypatch):
    from deepspeed_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_new_modules_are_scanned():
    """The serving-extension modules, the HF / LoRA / hybrid / host
    natives slice and the offload engines sit among the scanned files (the AST scan above covers
    every module of the package)."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"deepspeed_tpu_torch/io/aio.py",
            "deepspeed_tpu_torch/infinity.py",
            "deepspeed_tpu_torch/utils/ctypes_build.py",
            "deepspeed_tpu_torch/inference/zero_inference.py",
            "deepspeed_tpu_torch/inference/speculative.py",
            "deepspeed_tpu_torch/io/native.py",
            "deepspeed_tpu_torch/io/safetensors.py",
            "deepspeed_tpu_torch/ops/cpu_adam.py",
            "deepspeed_tpu_torch/inference/injection.py",
            "deepspeed_tpu_torch/integrations/hf.py",
            "deepspeed_tpu_torch/integrations/trainer.py",
            "deepspeed_tpu_torch/lora.py",
            "deepspeed_tpu_torch/distill.py",
            "deepspeed_tpu_torch/hybrid.py",
            "deepspeed_tpu_torch/offload.py",
            "deepspeed_tpu_torch/param_stream.py"} <= names


def test_fleet_modules_are_scanned():
    """The serving fleet's modules and the child replica's entry point sit
    among the scanned files."""
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {f"deepspeed_tpu_torch/{m}.py" for m in (
        "transport", "kv_fabric", "obs_wire", "fleet", "autoscale",
        "proc_fleet", "replica_child")} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_safetensors_or_ml_dtypes_import(path):
    """The card's machine has neither package: the port reads and writes
    safetensors itself and rounds bf16 with torch."""
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("safetensors", "ml_dtypes")]
    assert not bad, f"{path.name} imports {bad}"


def test_host_natives_are_the_ports_own_copies():
    """The port builds its host runtime and CPU Adam from its own sources
    into build/, never the JAX package's ``csrc/`` files or libraries."""
    from deepspeed_tpu_torch.io import native
    from deepspeed_tpu_torch.ops import cpu_adam

    for mod, src in ((native, "hostruntime.cpp"), (cpu_adam, "cpu_adam.cpp")):
        assert Path(mod._SRC) == ROOT / "deepspeed_tpu_torch" / "csrc" / \
            "host" / src
        assert Path(mod._LIB).parent == ROOT / "build" / \
            "deepspeed_tpu_torch" / "host"


def test_host_aio_is_the_ports_own_copy():
    """The port builds its aio from its own source into build/, never the
    JAX package's ``csrc/aio.cpp`` or its committed library."""
    from deepspeed_tpu_torch.io import aio

    assert Path(aio._SRC) == ROOT / "deepspeed_tpu_torch" / "csrc" / \
        "host" / "aio.cpp"
    assert Path(aio._LIB).parent == ROOT / "build" / "deepspeed_tpu_torch" \
        / "host"
