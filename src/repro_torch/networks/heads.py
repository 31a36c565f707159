"""Agent heads: dueling Q (Wang et al. 2015), C51 categorical critic
(Bellemare et al. 2017), and tanh-Gaussian policies for continuous control.

``categorical_apply`` makes its atoms on the logits' device at each call,
as the JAX package does; a learner that runs every step makes them once,
outside its step (``agents/continuous.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.networks.mlp import mlp_apply, mlp_init


# ------------------------------------------------------------- dueling
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


# ------------------------------------------------------------- C51
class CategoricalParams(NamedTuple):
    logits: torch.Tensor     # (..., num_atoms)
    atoms: torch.Tensor      # (num_atoms,)

    def mean(self) -> torch.Tensor:
        probs = torch.softmax(self.logits, dim=-1)
        return torch.sum(probs * self.atoms, dim=-1)


def categorical_init(generator: torch.Generator, in_dim: int,
                     num_atoms: int = 51, device="cuda"):
    return {"head": mlp_init(generator, (in_dim, num_atoms), device)}


def categorical_apply(params, h, vmin: float, vmax: float,
                      num_atoms: int = 51) -> CategoricalParams:
    logits = mlp_apply(params["head"], h)
    atoms = torch.linspace(vmin, vmax, num_atoms, device=logits.device)
    return CategoricalParams(logits, atoms)


def l2_project(z_p, p, z_q):
    """Project distribution (z_p, p) onto support z_q (C51 projection Π).

    ``z_p`` and ``p`` are (..., n_p) over any leading batch axes, ``z_q``
    is (n_q,); the result is (..., n_q)."""
    vmin, vmax = z_q[0], z_q[-1]
    d_pos = torch.cat([z_q[1:], z_q[-1:]], 0) - z_q
    d_neg = z_q - torch.cat([z_q[:1], z_q[:-1]], 0)
    z_p = torch.clamp(z_p, vmin, vmax)[..., None, :]    # (..., 1, n_p)
    z_q_ = z_q[..., :, None]                            # (n_q, 1)
    d_pos = torch.where(d_pos == 0, 1.0, d_pos)[..., :, None]
    d_neg = torch.where(d_neg == 0, 1.0, d_neg)[..., :, None]
    delta = z_p - z_q_                                  # (..., n_q, n_p)
    d_sign = delta >= 0.0
    delta_hat = torch.where(d_sign, delta / d_pos, -delta / d_neg)
    p = p[..., None, :]
    return torch.sum(torch.clamp(1.0 - delta_hat, 0.0, 1.0) * p, dim=-1)


# ------------------------------------------------------------- gaussian policy
def gaussian_policy_init(generator: torch.Generator, in_dim: int,
                         hidden: int, action_dim: int, device="cuda"):
    return {"net": mlp_init(generator, (in_dim, hidden, 2 * action_dim),
                            device)}


def gaussian_policy_apply(params, h, min_scale: float = 1e-3):
    out = mlp_apply(params["net"], h)
    mean, raw_scale = torch.chunk(out, 2, dim=-1)
    scale = F.softplus(raw_scale) + min_scale
    return mean, scale
