"""Experiments layer: config-driven runs over the AgentBuilder protocol.

    config = ExperimentConfig(builder_factory=..., environment_factory=...)
    result = run_experiment(config)                        # §2.2
    result = run_offline_experiment(config, num_learner_steps)   # §2.6

``run_distributed_experiment`` (§2.4) raises ``NotImplementedError`` until
ROADMAP slice 7.
"""
from repro_torch.experiments.config import (  # noqa: F401
    ExperimentConfig, ExperimentResult)
from repro_torch.experiments.run import (  # noqa: F401
    run_distributed_experiment, run_experiment, run_offline_experiment)
