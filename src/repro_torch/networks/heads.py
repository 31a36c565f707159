"""Agent heads: the dueling Q head (Wang et al. 2015).

The C51 categorical critic and the tanh-Gaussian policy head of the JAX
package's ``networks/heads.py`` come with the agents that use them
(ROADMAP slice 6).
"""
from __future__ import annotations

import torch

from repro_torch.networks.mlp import mlp_apply, mlp_init


def dueling_init(generator: torch.Generator, in_dim: int, hidden: int,
                 num_actions: int, device="cuda"):
    return {
        "value": mlp_init(generator, (in_dim, hidden, 1), device),
        "advantage": mlp_init(generator, (in_dim, hidden, num_actions),
                              device),
    }


def dueling_apply(params, h):
    v = mlp_apply(params["value"], h)
    a = mlp_apply(params["advantage"], h)
    return v + a - torch.mean(a, dim=-1, keepdim=True)
