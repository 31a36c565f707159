"""Step functions and drivers over the model zoo (the JAX package's
``repro.launch``).

Ported so far: ``steps`` (``TrainState``, ``init_train_state``,
``make_train_step``, ``make_prefill_step``, ``make_serve_step``,
``make_batched_prefill_step``), ``train`` (``make_corpus_sampler`` and
the training driver ``main``, on one device without a mesh) and ``serve``
(``BatchedServer``).  The mesh, sharding and dry-run modules are still to
be ported.
"""
from repro_torch.launch.steps import (  # noqa: F401
    TrainState, init_train_state, make_batched_prefill_step,
    make_prefill_step, make_serve_step, make_train_step)
