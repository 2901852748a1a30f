"""The port and chip_smoke.py stand alone: no JAX, nothing of ``repro``.

Every module is imported in a fresh interpreter where ``import jax`` fails
(``sys.modules["jax"] = None``), and every source is scanned for a
``jax`` / ``jaxlib`` / ``repro`` import.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PKG.rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_source_imports_no_jax_and_no_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_every_module_imports_with_jax_blocked():
    assert "repro_torch.configs.roberta" in MODULES
    assert "repro_torch.configs.gemma_7b" in MODULES
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import importlib\n"
        f"for m in {MODULES!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'jaxlib') and v is not None\n"
        "               for k, v in sys.modules.items())\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """No CUDA device: non-zero exit and no result line. The same holds
    for a copy of the script alone, without the rest of the repo."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, env=env,
                             cwd=str(cwd), timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize("module", [
    "repro_torch.distributed.compression", "repro_torch.serving.speculative",
    "repro_torch.core.dmrg", "repro_torch.train.train_step"])
def test_training_and_speculative_modules_are_scanned(module):
    """The modules of the rest of training and of speculative decode are
    among those imported with JAX blocked and scanned above (copies of
    ``src/repro/distributed/compression.py`` and
    ``src/repro/serving/speculative.py`` must not import them)."""
    assert module in MODULES
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert path in SOURCES
    assert not [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("module", [
    "repro_torch.kernels.quant", "repro_torch.kernels.tt_linear",
    "repro_torch.kernels.paged_attention", "repro_torch.models.layers",
    "repro_torch.serving.engine"])
def test_quantized_slice_modules_are_scanned(module):
    """The quantized slice's modules are among those imported with JAX
    blocked and scanned above (a copy of ``src/repro/kernels/quant.py``
    must not import it)."""
    assert module in MODULES
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert path in SOURCES
    assert not [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("module", [
    "repro_torch.serving.adapter_registry", "repro_torch.serving.chaos",
    "repro_torch.serving.scheduler"])
def test_registry_and_chaos_modules_are_scanned(module):
    """The paged adapter registry and the chaos harness are among the
    modules imported with JAX blocked and scanned above (copies of
    ``src/repro/serving/adapter_registry.py`` and ``chaos.py`` must not
    import them)."""
    assert module in MODULES
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert path in SOURCES
    assert not [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
