"""Small MLP torsos for the classic-control agents (plain init/apply
functions over lists of ``{"w", "b"}`` dicts).

Convention: ``mlp_apply(params, x)`` expects ``x`` of shape (batch,
features).  Agents flatten observations with :func:`flatten_obs`
(spec-aware), so actors can pass single unbatched observations and learners
batched ones.  Weights keep the reference's leaves: ``w`` is ``(in, out)``,
``b`` is ``(out,)``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.models.layers import dense_init


def flatten_obs(obs, spec_shape) -> torch.Tensor:
    """(..., *spec_shape) -> (batch, prod(spec_shape)); adds batch dim if
    absent."""
    obs = torch.as_tensor(obs).float()
    feat = int(np.prod(spec_shape)) if spec_shape else 1
    return (obs.reshape(-1, feat) if obs.numel() != feat
            else obs.reshape(1, feat))


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             device="cuda", dtype=torch.float32):
    """One layer per consecutive pair of ``sizes``: a truncated normal
    (+-2) weight scaled by ``in ** -0.5`` drawn from ``generator`` (a CPU
    generator, so one seed gives the same weights on every device), and a
    zero bias."""
    return [{"w": dense_init(generator, m, n, device, dtype),
             "b": torch.zeros((n,), dtype=dtype, device=device)}
            for m, n in zip(sizes[:-1], sizes[1:])]


def mlp_apply(params, x, activate_final: bool = False):
    h = torch.as_tensor(x).float()
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1 or activate_final:
            h = torch.relu(h)
    return h


class MLP:
    def __init__(self, layer_sizes: Sequence[int]):
        self.layer_sizes = tuple(layer_sizes)

    def init(self, generator: torch.Generator, in_dim: int, device="cuda"):
        return mlp_init(generator, (in_dim,) + self.layer_sizes, device)

    apply = staticmethod(mlp_apply)
