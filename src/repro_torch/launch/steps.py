"""Step functions over the model zoo.

``train_step`` is the Acme *learner* update (default objective: behaviour
cloning / offline next-token CE, section 3.7 of the paper; ``dqn`` gives
the double-DQN TD objective of section 3.2 with the LM head as
Q-values).  ``prefill_step`` scores full sequences: actor-side batched
inference, the greedy action at every position and the logits at the last
one.  ``serve_step`` decodes one token against a KV/SSM cache, and the
batched prefill step pushes a whole prompt through the cache in one call.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.models import layers, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.optim import Optimizer, apply_updates, periodic_update
from repro_torch.sharding import shard


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor          # 0-d int32 on the params' device
    target_params: Any = None   # dqn objective only


def init_train_state(generator, cfg: ArchConfig, opt: Optimizer, *,
                     device="cuda", param_dtype=torch.float32,
                     objective="bc") -> TrainState:
    """Params from ``transformer.init(generator, ...)``, the optimizer's
    state over them, step 0 and, for ``"dqn"``, a target network that is
    a copy of the params (a tensor of its own, not the params')."""
    params = transformer.init(generator, cfg, device, param_dtype)
    target = (tree.map(lambda p: p.clone(), params) if objective == "dqn"
              else None)
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32, device=device),
                      target)


def _bc_loss(params, cfg, batch, remat):
    feats, aux = transformer.forward_features(params, cfg, batch, remat=remat)
    feats = shard(feats, "batch", None, "d_model")   # gather seq for the CE scan
    table = transformer.unembed_table(params, cfg)
    loss = layers.chunked_cross_entropy(feats[:, :-1], table,
                                        batch["labels"][:, 1:],
                                        valid_vocab=cfg.vocab_size)
    metrics = {"ce": loss}
    for k, v in aux.items():
        loss = loss + v
        metrics[k] = v
    metrics["loss"] = loss
    return loss, metrics


def _dqn_loss(params, target_params, cfg, batch, remat):
    """Double-DQN 1-step TD over the token MDP; logits = Q(o_t, .)."""
    q, aux = transformer.forward(params, cfg, batch, remat=remat)
    with torch.no_grad():           # no gradient reaches the target
        q_target, _ = transformer.forward(target_params, cfg, batch,
                                          remat=remat)
    q, q_target = q.float(), q_target.float()
    a_star = torch.argmax(q[:, 1:], dim=-1)                      # online argmax
    next_v = torch.gather(q_target[:, 1:], -1, a_star[..., None])[..., 0]
    y = batch["rewards"][:, :-1] + batch["discounts"][:, :-1] * \
        next_v.detach()
    q_taken = torch.gather(q[:, :-1], -1,
                           batch["labels"][:, 1:].long()[..., None])[..., 0]
    loss = 0.5 * torch.mean(torch.square(y - q_taken))
    for v in aux.values():
        loss = loss + v
    return loss, {"loss": loss, "td": loss}


def make_train_step(cfg: ArchConfig, opt: Optimizer, *, objective="bc",
                    remat="full", target_period: int = 100,
                    microbatches: int = 1):
    """``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds ``"tokens"`` and ``"labels"`` (b, s), ``"rewards"``
    and ``"discounts"`` (b, s) for ``"dqn"``, and a VLM's ``"vision"`` or
    Whisper's ``"frames"``, as tensors or arrays; every leaf goes to the
    params' device.  ``microbatches > 1`` is gradient accumulation: the
    batch is split along axis 0 and the microbatches run in turn, so
    activation memory is divided by M while the update is the same (the
    mean of the microbatch grads, accumulated in float32 from zeros as
    ``acc + g / M``; the metrics are their mean).  The step builds new
    params, optimizer state and target: it writes no tensor of ``state``
    in place."""
    if objective not in ("bc", "dqn"):
        raise ValueError(objective)

    def grad_fn(params, target_params, batch):
        leaves, treedef = tree.flatten(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            p = tree.unflatten(treedef, live)
            if objective == "bc":
                loss, metrics = _bc_loss(p, cfg, batch, remat)
            else:
                loss, metrics = _dqn_loss(p, target_params, cfg, batch, remat)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        return (tree.unflatten(treedef, grads),
                {k: v.detach() for k, v in metrics.items()})

    def accumulate(params, target_params, batch):
        if microbatches == 1:
            return grad_fn(params, target_params, batch)
        size = next(iter(batch.values())).shape[0] // microbatches
        leaves, treedef = tree.flatten(params)
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        metrics = None
        for i in range(microbatches):
            # the JAX package reshapes the batch and scans; a slice of a
            # batch sharded on its rows gathers them, so each microbatch
            # is put back on the batch axes (a no-op on plain tensors)
            mbatch = {k: shard(v[i * size:(i + 1) * size], "batch",
                               *[None] * (v.dim() - 1))
                      for k, v in batch.items()}
            g, m = grad_fn(params, target_params, mbatch)
            torch._foreach_add_(acc, torch._foreach_div(
                [x.float() for x in tree.leaves(g)], microbatches))
            if metrics is None:
                metrics = {k: torch.zeros_like(v) for k, v in m.items()}
            metrics = {k: metrics[k] + m[k] / microbatches for k in metrics}
        return tree.unflatten(treedef, acc), metrics

    def train_step(state: TrainState, batch):
        device = state.step.device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        grads, metrics = accumulate(state.params, state.target_params, batch)
        with torch.no_grad():
            if objective == "dqn":
                target = periodic_update(state.params, state.target_params,
                                         state.step, target_period)
            else:
                target = state.target_params
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            del grads                   # freed before the new params
            params = apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1, target), metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, *, remat="none", chunk: int = 1024):
    """Actor-side batched scoring: greedy actions per position + last-position
    logits, computed over seq chunks so full (b, s, V) logits never live.

    The step takes ``(params, {"tokens": (b, s)})``, plus ``"vision"``
    (b, V, d_model) for a VLM or ``"frames"`` (b, encoder_seq, d_model)
    for Whisper (moved to the device and dtype of the embedding table),
    and returns ``{"actions": (b, s) int32, "last_logits": (b,
    padded_V)}`` on the device of the params."""

    def prefill_step(params, batch):
        feats, _ = transformer.forward_features(params, cfg, batch,
                                                remat=remat)
        table = transformer.unembed_table(params, cfg)
        s = feats.shape[1]
        c = chunk if s % chunk == 0 else s
        actions = [
            torch.argmax(transformer.mask_pad_logits(
                layers.unembed(table, feats[:, i:i + c]), cfg), dim=-1)
            for i in range(0, s, c)]
        last_logits = transformer.mask_pad_logits(
            layers.unembed(table, feats[:, -1]), cfg)
        return {"actions": torch.cat(actions, dim=1).to(torch.int32),
                "last_logits": last_logits}

    return prefill_step


def _greedy(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def make_serve_step(cfg: ArchConfig, *, backend: str = "auto"):
    """One-token incremental decode against the cache: ``serve_step(params,
    cache, token (b, 1), pos) -> (next_token (b, 1) int32, logits (b,
    padded_V), cache)``, the cache updated in place.  ``backend`` selects
    the decode-attention path: ``"auto"`` (the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors), ``"kernel"``, ``"ref"`` or
    ``"grouped"`` (the grouped-GQA einsum, the JAX package's ``"jnp"``)."""

    def serve_step(params, cache, token, pos):
        logits, cache = transformer.decode_step(params, cfg, cache, token, pos,
                                                backend=backend)
        return _greedy(logits), logits, cache
    return serve_step


def make_batched_prefill_step(cfg: ArchConfig):
    """Whole-prompt prefill THROUGH the decode cache in one call — the
    batched replacement for stepping ``serve_step`` once per prompt token.
    Dense and MoE archs with the stacked ``"kv"`` cache layout only
    (``transformer.prefill`` raises otherwise).

    Returns ``prefill_step(params, cache, tokens, lengths=None) ->
    (next_token (b, 1) int32, logits (b, padded_V), cache)`` where
    ``tokens`` is right-padded (b, s) and ``lengths`` masks the padding;
    decode then continues at position ``lengths[i]`` (or ``s``)."""

    def prefill_step(params, cache, tokens, lengths=None):
        logits, cache = transformer.prefill(params, cfg, cache, tokens,
                                            lengths=lengths)
        return _greedy(logits), logits, cache
    return prefill_step
