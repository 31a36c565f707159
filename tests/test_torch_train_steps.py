"""One ``make_train_step`` of every family in repro_torch against the JAX
package's, on reduced configs (the hybrid with a tail block): the BC
objective for the six families and a step under ``remat="full"`` (the
DQN objective's steps are in ``test_torch_train.py``).

Each case runs the JAX package's steps once and the port's twice
(``torch_train_cases.run_both``, ``check_step``): each port step from
the JAX package's state after the step before, and free-running.  Under
Adam the stepped run holds the metrics and Adam's moments (the step's
grads) after steps 1 and 3; under SGD the stepped run holds the metrics,
the grads and the params, and the free-running one the metrics and the
params, after steps 1 and 3 (Adam's normalisation amplifies a grad near 0
into an O(lr) weight difference; SGD's update is linear in the grads).
Tolerance: 1e-5 of each leaf's largest magnitude.

SGD's grads are held after step 1 only: after step 3 Whisper's ``lnx``
scale grads (largest ~9e-4, each a sum of terms of ~1e-2 that cancel)
are ~2e-8 from their float64 value in either package (2.4e-8 here, 1.9e-8
in the JAX package), above 1e-5 of the leaf; Adam's moments hold every
step's grads within the rule, since their history outweighs that
noise."""
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from torch_train_cases import FAMILIES, check_run, run_both

OPTIMIZERS = ["adam", "sgd"]


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_bc_train_step_matches(family, optimizer):
    for n, cfg, jstate, jm, stepped, free in run_both(
            family, "bc", 3, optimizer=optimizer):
        if n in (1, 3):
            check_run(cfg, jstate, jm, stepped, free, f"{family} step {n}")


def test_train_step_under_full_remat_matches_the_reference():
    """``remat="full"`` in the port against the JAX package's "none" (the
    reference's remat changes no value): one SGD step on the hybrid."""
    for n, cfg, jstate, jm, stepped, free in run_both(
            "hybrid", "bc", 1, optimizer="sgd", remat="full"):
        check_run(cfg, jstate, jm, stepped, free, "hybrid full remat")
