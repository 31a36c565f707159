"""Step functions and drivers over the model zoo (the JAX package's
``repro.launch``).

Ported so far: ``steps`` (``make_prefill_step``, ``make_serve_step``,
``make_batched_prefill_step``) and ``serve`` (``BatchedServer``).
"""
