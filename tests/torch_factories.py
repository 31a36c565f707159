"""Picklable factories for the port's tests: the twins of
``tests/conftest.py``'s DQN- and transformer-on-Catch smoke presets, with
builders on the CPU unless a test asks for the card.

The multiprocess launcher pickles a worker's builder factory and
environment factory by reference and its spawned children import them
from here, so this module is module-level classes only and imports
neither jax nor the reference package: a child loads torch and the port,
nothing else.
"""
import dataclasses

from repro_torch.agents.dqn import DQNBuilder, DQNConfig
from repro_torch.envs import Catch
from repro_torch.experiments import ExperimentConfig
from repro_torch.policies import (TransformerPolicyBuilder,
                                  TransformerPolicyConfig)

CPU = "cpu"

# The reference's decode backend "jnp" is the port's "grouped".
BACKENDS = {"jnp": "grouped"}


class DQNCatchBuilderFactory:
    """``spec -> DQNBuilder`` over conftest's Catch smoke preset; keyword
    knobs override ``DQNConfig`` fields."""

    DEFAULTS = dict(min_replay_size=50, samples_per_insert=4.0,
                    batch_size=16, n_step=1, epsilon=0.2)

    def __init__(self, seed: int = 0, device=CPU, **cfg_overrides):
        self.seed = seed
        self.device = device
        self.cfg_kwargs = dict(self.DEFAULTS, **cfg_overrides)

    def __call__(self, spec):
        return DQNBuilder(spec, DQNConfig(**self.cfg_kwargs), seed=self.seed,
                          device=self.device)


class TransformerCatchBuilderFactory:
    """``spec -> TransformerPolicyBuilder`` over conftest's Catch smoke
    preset; keyword knobs override ``TransformerPolicyConfig`` fields, and
    a reference backend name maps to the port's."""

    DEFAULTS = dict(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                    head_dim=16, d_ff=64, window=4, sequence_length=10,
                    period=10, batch_size=8, min_replay_size=10,
                    samples_per_insert=0.0, backend="jnp")

    def __init__(self, seed: int = 0, device=CPU, **cfg_overrides):
        self.seed = seed
        self.device = device
        self.cfg_kwargs = dict(self.DEFAULTS, **cfg_overrides)
        backend = self.cfg_kwargs["backend"]
        self.cfg_kwargs["backend"] = BACKENDS.get(backend, backend)

    def __call__(self, spec):
        return TransformerPolicyBuilder(
            spec, TransformerPolicyConfig(**self.cfg_kwargs), seed=self.seed,
            device=self.device)


class CatchEnvFactory:
    """``seed -> Catch``."""

    def __call__(self, seed):
        return Catch(seed=seed)


catch_env_factory = CatchEnvFactory()


def _config(factory_cls, cfg_cls, seed, builder_seed, device, env_factory,
            knobs):
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    return ExperimentConfig(
        builder_factory=factory_cls(
            seed=seed if builder_seed is None else builder_seed,
            device=device,
            **{k: v for k, v in knobs.items() if k in fields}),
        environment_factory=env_factory, seed=seed,
        **{k: v for k, v in knobs.items() if k not in fields})


def make_dqn_catch_config(*, seed: int = 0, builder_seed: int = None,
                          device=CPU, env_factory=catch_env_factory,
                          **knobs):
    """conftest's ``make_dqn_catch_config`` for the port: ``DQNConfig``
    field names go to the builder factory, everything else to the
    config."""
    return _config(DQNCatchBuilderFactory, DQNConfig, seed, builder_seed,
                   device, env_factory, knobs)


def make_transformer_catch_config(*, seed: int = 0, builder_seed: int = None,
                                  device=CPU, env_factory=catch_env_factory,
                                  **knobs):
    """conftest's ``make_transformer_catch_config`` for the port."""
    return _config(TransformerCatchBuilderFactory, TransformerPolicyConfig,
                   seed, builder_seed, device, env_factory, knobs)


class ProbedCatchFactory:
    """``seed -> Catch`` that, at an environment's second ``reset`` (after
    the worker has built its actor and acted for an episode), writes what
    its process has loaded to ``<directory>/<pid>.json``: the modules of
    jax or of the reference package, and whether torch has started a CUDA
    context."""

    def __init__(self, directory):
        self.directory = str(directory)

    def __call__(self, seed):
        return _ProbedCatch(self.directory, seed)


class _ProbedCatch(Catch):
    def __init__(self, directory, seed):
        super().__init__(seed=seed)
        self._directory = directory
        self._resets = 0

    def reset(self):
        self._resets += 1
        if self._resets == 2:
            import json
            import os
            import sys

            import torch
            loaded = sorted(m for m in sys.modules
                            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
            path = os.path.join(self._directory, f"{os.getpid()}.json")
            with open(path, "w") as f:
                json.dump({"modules": loaded,
                           "cuda_initialized": torch.cuda.is_initialized()},
                          f)
        return super().reset()
