"""repro_torch stands alone: importing it and every submodule loads neither
jax nor the reference package, and no file of the port (or the chip smoke
script) imports them."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_CHECK = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_import_loads_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    result = subprocess.run([sys.executable, "-c", _CHECK], env=env,
                            capture_output=True, text=True, timeout=120,
                            check=True)
    count, bad = result.stdout.split(maxsplit=1)
    assert int(count) >= 40           # every submodule was imported
    assert bad.strip() == "[]"


def test_learner_slice_imports_neither_jax_nor_repro():
    """The IMPALA slice's modules on their own, as a user imports them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys\n"
            "import repro_torch.agents.impala, repro_torch.replay, "
            "repro_torch.adders, repro_torch.optim\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    result = subprocess.run([sys.executable, "-c", code], env=env,
                            capture_output=True, text=True, timeout=120,
                            check=True)
    assert result.stdout.strip() == "[]"


def test_scoring_slice_imports_neither_jax_nor_repro():
    """The model-zoo scoring slice's modules on their own."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys\n"
            "import repro_torch.launch.steps, repro_torch.configs, "
            "repro_torch.models.ssm, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.ssd_scan\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    result = subprocess.run([sys.executable, "-c", code], env=env,
                            capture_output=True, text=True, timeout=120,
                            check=True)
    assert result.stdout.strip() == "[]"


@pytest.mark.parametrize("module", [
    "repro_torch.experiments", "repro_torch.agents.dqn",
    "repro_torch.checkpoint", "repro_torch.resilience",
    "repro_torch.telemetry.hub", "repro_torch.core.loggers",
    "repro_torch.envs", "repro_torch.networks.lstm",
    "repro_torch.agents.r2d2", "repro_torch.agents.dqfd",
    "repro_torch.agents.r2d3", "repro_torch.policies.learning",
    "repro_torch.policies.builder", "repro_torch.policies.actors"])
def test_dqn_slice_imports_neither_jax_nor_repro(module):
    """The DQN spine's and the sequence learners' modules, each on its own
    in a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys\nimport {module}\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    result = subprocess.run([sys.executable, "-c", code], env=env,
                            capture_output=True, text=True, timeout=120,
                            check=True)
    assert result.stdout.strip() == "[]"


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py",
                            ROOT / "scripts" / "tensor_core_probe.py",
                            ROOT / "scripts" / "latency_probe.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots
