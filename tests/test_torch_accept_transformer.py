"""The reference's transformer-policy learning acceptance on the port
(``tests/test_policies.py::test_transformer_policy_learns_catch``): the
preset of ``tests/conftest.py``'s ``TransformerCatchBuilderFactory``
(seed 0, 250 episodes, no periodic eval, 20 eval episodes) through
``repro_torch.experiments.run_experiment`` on the CPU.  The final eval
must beat the mean of the first 30 train returns."""
import numpy as np

from repro_torch.experiments import run_experiment
from torch_factories import (TransformerCatchBuilderFactory,
                             make_transformer_catch_config)
from torch_threads import one_torch_thread  # noqa: F401


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
