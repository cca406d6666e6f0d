"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no script under ``tools/`` imports ``jax``,
``jaxlib`` or the JAX package ``repro`` (the card's machine has none of
them)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_scan_sees_the_port():
    assert len(FILES) > 20
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"src/repro_torch/train/pipeline.py",
            "src/repro_torch/checkpoint/npz.py",
            "src/repro_torch/checkpoint/__init__.py",
            "src/repro_torch/kernels/flash_decode.py",
            "src/repro_torch/models/lm.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/core/grad_stats.py",
            "src/repro_torch/experiments/runner.py",
            "src/repro_torch/launch/experiment.py",
            "src/repro_torch/data/tokens.py",
            "src/repro_torch/data/loader.py",
            "src/repro_torch/core/lamb.py",
            "src/repro_torch/core/adamw.py",
            "src/repro_torch/models/flash_attn.py",
            "src/repro_torch/launch/overrides.py",
            "src/repro_torch/configs/shapes.py",
            "src/repro_torch/configs/qwen3_14b.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/configs/granite_moe_3b_a800m.py",
            "src/repro_torch/models/mla.py",
            "src/repro_torch/configs/deepseek_v2_236b.py",
            "src/repro_torch/models/ssm.py",
            "src/repro_torch/configs/falcon_mamba_7b.py",
            "src/repro_torch/configs/zamba2_7b.py",
            "src/repro_torch/models/encdec.py",
            "src/repro_torch/configs/whisper_base.py",
            "src/repro_torch/configs/paligemma_3b.py"} <= names


@pytest.mark.parametrize("module", [
    "repro_torch.train.pipeline", "repro_torch.checkpoint",
    "repro_torch.checkpoint.npz", "repro_torch.kernels.lars_kernels",
    "repro_torch.kernels.flash_decode", "repro_torch.models.layers",
    "repro_torch.models.mlp", "repro_torch.models.attention",
    "repro_torch.models.lm", "repro_torch.serve",
    "repro_torch.serve.sampling", "repro_torch.serve.cache",
    "repro_torch.serve.scheduler", "repro_torch.serve.engine",
    "repro_torch.launch.serve", "repro_torch.configs.smollm_135m",
    "repro_torch.core.grad_stats", "repro_torch.experiments",
    "repro_torch.experiments.spec", "repro_torch.experiments.record",
    "repro_torch.experiments.report", "repro_torch.experiments.runner",
    "repro_torch.launch.experiment", "repro_torch.data.tokens",
    "repro_torch.data.loader", "repro_torch.core.lamb",
    "repro_torch.core.adamw", "repro_torch.launch.train",
    "repro_torch.models.flash_attn", "repro_torch.launch.overrides",
    "repro_torch.configs.shapes", "repro_torch.configs.qwen3_14b",
    "repro_torch.configs.qwen2_72b", "repro_torch.configs.minitron_8b",
    "repro_torch.models.moe", "repro_torch.configs.granite_moe_3b_a800m",
    "repro_torch.models.mla", "repro_torch.configs.deepseek_v2_236b",
    "repro_torch.models.ssm", "repro_torch.configs.falcon_mamba_7b",
    "repro_torch.configs.zamba2_7b", "repro_torch.bridge",
    "repro_torch.models.encdec", "repro_torch.configs.whisper_base",
    "repro_torch.configs.paligemma_3b", "repro_torch.kernels.build"])
def test_new_modules_import_without_a_card(module):
    """Importing builds nothing and needs no CUDA: kernels build inside
    the call that launches them."""
    import importlib
    importlib.import_module(module)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
