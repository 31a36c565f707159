"""Hand-written CUDA kernels for Hopper, replacing the Pallas TPU kernels of
``repro.kernels``.

Each kernel ships in parts:
  csrc/<name>.cu  — the CUDA C++ source, built by ``build.py`` with nvcc
  <name>.py       — the ctypes wrapper, with its launch count
  ops.py          — public entry points: kernel on CUDA, plain version on CPU
  ref.py          — plain PyTorch versions, the allclose oracles
"""
