"""LSTM core for recurrent agents (R2D2, §3.2).

Parameters keep the JAX package's leaves: ``wi (in, 4H)``, ``wh (H, 4H)``
and ``b (4H,)``, with the gates in the order i, g, f, o along the last
axis, so a JAX tree copies across through numpy (``params_from_jax``).
``lstm_unroll`` is a Python loop over time where the reference scans.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models.layers import truncated_normal
from repro_torch.networks.mlp import mlp_apply, mlp_init


class LSTMState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


def lstm_init(generator: torch.Generator, in_dim: int, hidden: int,
              device="cuda", dtype=torch.float32):
    """Truncated normal (+-2) input and recurrent weights scaled by their
    fan-in ** -0.5, drawn from ``generator`` (a CPU generator), and a zero
    bias."""
    return {
        "wi": truncated_normal(generator, (in_dim, 4 * hidden),
                               in_dim ** -0.5, device, dtype),
        "wh": truncated_normal(generator, (hidden, 4 * hidden),
                               hidden ** -0.5, device, dtype),
        "b": torch.zeros((4 * hidden,), dtype=dtype, device=device),
    }


def lstm_initial_state(hidden: int, batch: int = 1,
                       device="cuda") -> LSTMState:
    return LSTMState(torch.zeros((batch, hidden), device=device),
                     torch.zeros((batch, hidden), device=device))


def lstm_apply(params, x, state: LSTMState):
    """x: (batch, in_dim) one step. Returns (out, new_state)."""
    gates = x @ params["wi"] + state.h @ params["wh"] + params["b"]
    i, g, f, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * state.c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, LSTMState(h, c)


def lstm_unroll(params, xs, state: LSTMState):
    """xs: (T, batch, in_dim). Returns (outs (T, batch, H), final_state)."""
    outs = []
    for x in xs:
        h, state = lstm_apply(params, x, state)
        outs.append(h)
    return torch.stack(outs), state


def params_from_jax(params, device="cuda"):
    """A JAX parameter tree (an ``LSTMNetwork``'s or ``lstm_init``'s, numpy
    or JAX leaves) as the port's: the same names, each leaf a tensor on
    ``device``."""
    return tree.map(lambda x: torch.tensor(np.asarray(x), device=device),
                    params)


class LSTMNetwork:
    """MLP torso -> LSTM core -> linear head, for R2D2-style agents."""

    def __init__(self, torso_sizes: Sequence[int], hidden: int, out_dim: int):
        self.torso_sizes = tuple(torso_sizes)
        self.hidden = hidden
        self.out_dim = out_dim

    def init(self, generator: torch.Generator, in_dim: int, device="cuda"):
        torso_in = (in_dim,) + self.torso_sizes
        return {
            "torso": mlp_init(generator, torso_in, device),
            "lstm": lstm_init(generator, self.torso_sizes[-1], self.hidden,
                              device),
            "head": mlp_init(generator, (self.hidden, self.out_dim), device),
        }

    def initial_state(self, batch: int = 1, device="cuda") -> LSTMState:
        return lstm_initial_state(self.hidden, batch, device)

    def apply(self, params, obs, state: LSTMState):
        h = mlp_apply(params["torso"], obs, activate_final=True)
        h, state = lstm_apply(params["lstm"], h, state)
        return mlp_apply(params["head"], h), state

    def unroll(self, params, obs_seq, state: LSTMState):
        """obs_seq: (T, batch, feat)."""
        h = mlp_apply(params["torso"], obs_seq, activate_final=True)
        outs, final = lstm_unroll(params["lstm"], h, state)
        return mlp_apply(params["head"], outs), final
