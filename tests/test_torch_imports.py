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


@pytest.mark.parametrize("module", [
    "repro_torch.distributed", "repro_torch.learners",
    "repro_torch.replay.service", "repro_torch.agents.builders"])
def test_distributed_slice_imports_neither_jax_nor_repro(module):
    """The distributed slice's modules, each on its own in a fresh
    interpreter."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys\nimport {module}\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    result = subprocess.run([sys.executable, "-c", code], env=env,
                            capture_output=True, text=True, timeout=120,
                            check=True)
    assert result.stdout.strip() == "[]"


@pytest.mark.parametrize("module", [
    "repro_torch.resilience.failover", "repro_torch.resilience.chaos",
    "repro_torch.distributed.launchers"])
def test_resilience_slice_imports_neither_jax_nor_repro(module):
    """The fault-tolerance slice's modules, each on its own in a fresh
    interpreter."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys\nimport {module}\n"
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    result = subprocess.run([sys.executable, "-c", code], env=env,
                            capture_output=True, text=True, timeout=120,
                            check=True)
    assert result.stdout.strip() == "[]"


def test_respawned_actor_child_imports_neither_jax_nor_repro(tmp_path):
    """An actor killed by a chaos schedule and respawned by the elastic
    launcher comes back as a fresh spawn child: both lives load neither jax
    nor the reference package and start no CUDA context."""
    import json

    import torch

    from repro_torch.experiments import run_distributed_experiment
    from repro_torch.resilience import ChaosPolicy, RestartPolicy
    from torch_factories import ProbedCatchFactory, make_dqn_catch_config

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = make_dqn_catch_config(
            seed=0, launcher="multiprocess", inference="server",
            eval_episodes=0, env_factory=ProbedCatchFactory(tmp_path),
            restart_policy=RestartPolicy(max_restarts=1,
                                         backoff_base_s=0.05),
            chaos=ChaosPolicy(kill_after_steps=30,
                              kill_targets=("actor/0",)))
        result = run_distributed_experiment(config, num_actors=1,
                                            max_actor_steps=100,
                                            timeout_s=120)
    finally:
        torch.set_num_threads(threads)
    # one actor: its node is "actor", its chaos schedule "actor/0"
    assert result.extras["resilience"]["restarts"] == {"actor": 1}
    reports = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(reports) == 2, reports
    assert all(r == {"modules": [], "cuda_initialized": False}
               for r in reports)


def test_spawned_actor_child_imports_neither_jax_nor_repro(tmp_path):
    """An actor the multiprocess launcher spawns (here with
    ``inference="server"``, so it holds no network) loads neither jax nor
    the reference package, whatever its parent has loaded, and starts no
    CUDA context."""
    import json

    import torch

    from repro_torch.experiments import run_distributed_experiment
    from torch_factories import ProbedCatchFactory, make_dqn_catch_config

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        config = make_dqn_catch_config(
            seed=0, launcher="multiprocess", inference="server",
            eval_episodes=0, env_factory=ProbedCatchFactory(tmp_path))
        result = run_distributed_experiment(config, num_actors=1,
                                            max_actor_steps=100,
                                            timeout_s=120)
    finally:
        torch.set_num_threads(threads)
    assert result.counts["actor_steps"] >= 100
    reports = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(reports) == 1, reports
    assert reports[0] == {"modules": [], "cuda_initialized": False}


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
                            ROOT / "scripts" / "latency_probe.py",
                            ROOT / "scripts" / "acceptance_repeats.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_repro(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots
