"""Step functions, drivers and the launch layer over the model zoo (the JAX
package's ``repro.launch``).

``steps`` (``TrainState``, ``init_train_state``, ``make_train_step``,
``make_prefill_step``, ``make_serve_step``, ``make_batched_prefill_step``),
``train`` (``make_corpus_sampler`` and the training driver ``main``, under
the one-device host mesh), ``serve`` (``BatchedServer``), ``mesh`` (the
production and host meshes over ``torch.distributed``, and the NVIDIA
H100's datasheet figures), ``param_sharding`` (logical axes of every param
leaf), ``specs`` (fake-tensor stand-ins of every step's inputs),
``hlo_analysis`` (the ``Analysis`` record and the per-rank counter of a
traced step), ``dryrun`` (every arch x shape traced on a fake 256- or
512-rank mesh) and ``perf`` (tagged dry-run variants).
"""
from repro_torch.launch.steps import (  # noqa: F401
    TrainState, init_train_state, make_batched_prefill_step,
    make_prefill_step, make_serve_step, make_train_step)
