"""The port stands alone: no file of ``rtp_llm_tpu_torch/`` nor
``chip_smoke.py`` / ``chip_ab.py`` / ``chip_ab_attention.py`` imports JAX or the JAX package,
importing the port loads
neither, and its entry points default to the GPU (raising without one)."""

import ast
import os
import subprocess
import sys

import pytest

import torch

torch.set_num_threads(1)  # six test workers share the host's cores: one intra-op thread each

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rtp_llm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "rtp_llm_tpu")


def _port_files():
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "chip_ab.py", "chip_ab_attention.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imported_roots(f)
           if m in FORBIDDEN]
    assert bad == []


def test_the_4bit_modules_are_covered():
    rel = {os.path.relpath(f, PKG) for f in _port_files()}
    assert {"ops/quant_gemm.py", "quant/__init__.py", "quant/gptq_awq.py",
            "quant/weight_only.py"} <= rel


def test_the_frontend_modules_are_covered():
    rel = {os.path.relpath(f, PKG) for f in _port_files()}
    assert {"frontend/tool_detectors.py", "frontend/output_parsers.py",
            "frontend/legacy_templates.py", "frontend/qwen_agent_renderer.py",
            "frontend/glm4_renderer.py", "frontend/deepseek_renderer.py",
            "frontend/kimi_renderer.py", "utils/metrics.py", "utils/access_logger.py",
            "config/server_args.py"} <= rel


def test_the_beam_and_lora_modules_are_covered():
    rel = {os.path.relpath(f, PKG) for f in _port_files()}
    assert {"engine/beam.py", "lora/__init__.py", "lora/lora.py", "ops/lora.py"} <= rel


def test_importing_every_module_loads_neither():
    code = (
        "import importlib, pkgutil, sys\n"
        "import rtp_llm_tpu_torch\n"
        "for m in pkgutil.walk_packages(rtp_llm_tpu_torch.__path__, 'rtp_llm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (FORBIDDEN,)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from rtp_llm_tpu_torch.config import EngineConfig
    from rtp_llm_tpu_torch.config.model_config import ModelConfig
    from rtp_llm_tpu_torch.convert import weights_from_jax
    from rtp_llm_tpu_torch.device import resolve_device
    from rtp_llm_tpu_torch.loader import CheckpointLoader
    from rtp_llm_tpu_torch.models import LlamaFamilyModel
    from rtp_llm_tpu_torch.server.server import build_engine

    cfg = ModelConfig(num_layers=1, hidden_size=8, num_attention_heads=2,
                      num_kv_heads=1, head_dim=4, max_position_embeddings=8)
    for call in (lambda: resolve_device(None), lambda: LlamaFamilyModel(cfg),
                 lambda: CheckpointLoader(cfg), lambda: weights_from_jax({}),
                 lambda: build_engine("/nonexistent", EngineConfig())):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu").type == "cpu"
