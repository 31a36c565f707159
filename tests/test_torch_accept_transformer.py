"""The reference's transformer-policy learning acceptance on the port
(``tests/test_policies.py::test_transformer_policy_learns_catch``): the
preset of ``tests/conftest.py``'s ``TransformerCatchBuilderFactory``
(seed 0, 250 episodes, no periodic eval, 20 eval episodes) through
``repro_torch.experiments.run_experiment`` on the CPU.  The final eval
must beat the mean of the first 30 train returns."""
import dataclasses

import numpy as np

from repro_torch.envs import Catch
from repro_torch.experiments import ExperimentConfig, run_experiment
from repro_torch.policies import (TransformerPolicyBuilder,
                                  TransformerPolicyConfig)
from torch_threads import one_torch_thread  # noqa: F401

# The reference's decode backend "jnp" is the port's "grouped".
BACKENDS = {"jnp": "grouped"}


class TransformerCatchBuilderFactory:
    """The port's ``spec -> TransformerPolicyBuilder`` over the reference's
    Catch smoke preset; keyword knobs override ``TransformerPolicyConfig``
    fields, and a reference backend name maps to the port's."""

    DEFAULTS = dict(num_layers=1, d_model=32, num_heads=2, num_kv_heads=1,
                    head_dim=16, d_ff=64, window=4, sequence_length=10,
                    period=10, batch_size=8, min_replay_size=10,
                    samples_per_insert=0.0, backend="jnp")

    def __init__(self, seed: int = 0, device="cpu", **cfg_overrides):
        self.seed = seed
        self.device = device
        self.cfg_kwargs = dict(self.DEFAULTS, **cfg_overrides)
        backend = self.cfg_kwargs["backend"]
        self.cfg_kwargs["backend"] = BACKENDS.get(backend, backend)

    def __call__(self, spec):
        return TransformerPolicyBuilder(
            spec, TransformerPolicyConfig(**self.cfg_kwargs), seed=self.seed,
            device=self.device)


def make_transformer_catch_config(*, seed: int = 0, **knobs):
    """conftest's ``make_transformer_catch_config`` for the port."""
    fields = {f.name for f in dataclasses.fields(TransformerPolicyConfig)}
    return ExperimentConfig(
        builder_factory=TransformerCatchBuilderFactory(
            seed=seed, **{k: v for k, v in knobs.items() if k in fields}),
        environment_factory=lambda s: Catch(seed=s), seed=seed,
        **{k: v for k, v in knobs.items() if k not in fields})


def test_factory_maps_the_reference_backend():
    assert TransformerCatchBuilderFactory().cfg_kwargs["backend"] == "grouped"
    assert TransformerCatchBuilderFactory(backend="ref").cfg_kwargs[
        "backend"] == "ref"


def test_transformer_policy_learns_catch():
    """Acceptance: TransformerPolicyBuilder trains DQN-style on Catch
    through run_experiment (single process, local KV-cache decode)."""
    config = make_transformer_catch_config(seed=0, num_episodes=250,
                                           eval_every=0, eval_episodes=20)
    result = run_experiment(config)
    assert result.learner_steps > 0
    early = np.mean(result.train_returns[:30])
    final = result.final_eval_return
    assert np.isfinite(final)
    assert final > early, (f"no improvement: eval {final:.2f} vs "
                           f"early-train {early:.2f}")
