"""Step functions over the model zoo (the JAX package's ``repro.launch``).

Ported so far: ``steps.make_prefill_step``, actor-side batched scoring.
"""
