"""GQA attention: full-sequence and prefill paths + single-token decode.

Supports RoPE, Qwen3 qk-norm and sliding-window (banded) masking.  GQA K/V
are stored with ``num_kv_heads`` (cache compression); the plain
full-sequence and prefill paths broadcast them to the full head count, and
the kernels (flash attention on the full-sequence path, decode attention)
index the KV head of each query head directly.

Positions are 1-D ``(seq,)`` — shared across the batch — on the full and
prefill paths; ``decode_attention`` takes per-row ``(b,)`` positions (or
one scalar for all rows), so continuous-batching servers can decode
requests that are at different depths of their episodes in ONE dispatch.

Caches are dicts ``{"k", "v"}`` of ``(batch, length, kv_heads, head_dim)``
tensors, and the decode and prefill paths write the new K/V into them IN
PLACE (the JAX package returns updated copies); both still return the
cache, so callers read the same as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kernels_ref
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig

NEG_INF = -1e30


def attn_init(generator, cfg: ArchConfig, device="cuda", dtype=torch.float32):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": layers.truncated_normal(generator, (d, h, hd), d ** -0.5,
                                      device, dtype),
        "wk": layers.truncated_normal(generator, (d, kv, hd), d ** -0.5,
                                      device, dtype),
        "wv": layers.truncated_normal(generator, (d, kv, hd), d ** -0.5,
                                      device, dtype),
        "wo": layers.truncated_normal(generator, (h, hd, d), (h * hd) ** -0.5,
                                      device, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), device=device, dtype=dtype)
        p["k_norm"] = torch.ones((hd,), device=device, dtype=dtype)
    return p


def _project_qkv(params, cfg: ArchConfig, x, positions):
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qk_norm:
        q = layers.head_rmsnorm(params["q_norm"], q, cfg.rmsnorm_eps)
        k = layers.head_rmsnorm(params["k_norm"], k, cfg.rmsnorm_eps)
    if cfg.rope_theta > 0:
        # positions: (s,) shared across the batch, or (b, s) per-row
        pos2d = positions if positions.dim() == 2 else positions[None, :]
        q = layers.apply_rope(q, pos2d, cfg.rope_theta)
        k = layers.apply_rope(k, pos2d, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k, q_per_kv: int):
    """(b, s, kv, hd) -> (b, s, h, hd)."""
    if q_per_kv == 1:
        return k
    return torch.repeat_interleave(k, q_per_kv, dim=2)


def attention(params, cfg: ArchConfig, x, positions, *, causal=True):
    """Full-sequence self-attention over x: (b, s, d); positions: (s,).

    The scores and softmax run in ``ops.flash_attention`` (the CUDA kernel
    on CUDA tensors, its plain version on CPU tensors), which takes q and
    the unrepeated GQA K/V, after RoPE and qk-norm, as (b, heads, s,
    head_dim) views of the (b, s, heads, head_dim) tensors, without copies;
    the kernel writes its output in the model's order too.  Both mask by
    index, not by ``positions``: every
    caller passes contiguous positions (``arange(seq)``), and the causal
    and window masks depend only on q_pos - k_pos, so this is exact.
    Positions are not checked on the device, which would cost a sync per
    call.  The JAX package scans over query chunks to bound memory at long
    sequence lengths; the plain version computes one block.
    """
    q, k, v = _project_qkv(params, cfg, x, positions)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=cfg.sliding_window)
    return torch.einsum("bhsk,hkd->bsd", out, params["wo"])


# ------------------------------------------------------------------ decode
def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cuda"):
    """One layer's cache. Sliding-window archs use a ring buffer of size W."""
    length = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_backend(backend: str, device: torch.device) -> str:
    """Resolve the decode backend for tensors on ``device``.

    ``"auto"`` is the CUDA kernel for CUDA tensors and the plain version
    (``kernels/ref.py``) for CPU tensors.  ``"kernel"`` on a CPU tensor
    raises: there is no fallback.  ``"ref"`` forces the plain version and
    ``"grouped"`` the grouped-GQA einsum path (the JAX package's ``"jnp"``).
    """
    if backend == "auto":
        return "kernel" if device.type == "cuda" else "ref"
    if backend == "kernel" and device.type != "cuda":
        raise ValueError(
            f"decode backend 'kernel' needs CUDA tensors, got {device}")
    if backend not in ("kernel", "ref", "grouped"):
        raise ValueError(f"unknown decode backend {backend!r}")
    return backend


def decode_attention(params, cfg: ArchConfig, x, cache, pos, *,
                     backend: str = "grouped"):
    """One-token decode. x: (b, 1, d); pos: scalar (current index, shared)
    or ``(b,)`` per-row positions (continuous batching: rows at different
    episode depths decoded in one dispatch).

    K is stored after RoPE.  Writes the new K/V into ``cache`` in place and
    returns (out (b, 1, d), cache).

    ``backend`` selects the score/softmax path once the cache is updated
    (see ``_decode_backend``): ``"kernel"`` (the CUDA flash-decoding kernel,
    per-row valid prefix lengths), ``"ref"`` (its plain version),
    ``"grouped"`` (grouped-GQA einsum) or ``"auto"``.
    """
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).long()
    if pos.dim() == 0:
        pos = pos.expand(b)
    q, k_new, v_new = _project_qkv(params, cfg, x, pos[:, None])

    length = cache["k"].shape[1]
    slot = torch.remainder(pos, length) if cfg.sliding_window else pos
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]

    backend = _decode_backend(backend, x.device)
    if backend in ("kernel", "ref"):
        # Both mask a VALID PREFIX per row.  That is exactly the occupancy
        # of our caches: a linear cache holds slots [0, pos] and a full ring
        # holds all L slots — min(pos+1, L) either way.  Ring wraparound
        # scrambles chronological order, but softmax attention is
        # permutation-invariant over the key set and K is stored post-RoPE,
        # so prefix masking stays correct after wrap.  Both index the KV
        # head of each query head directly (no repeat).
        lengths = torch.clamp(pos + 1, max=length).to(torch.int32)
        if backend == "kernel":
            out_h = ops.decode_attention(q[:, 0].contiguous(), k, v, lengths)
        else:
            out_h = kernels_ref.decode_attention_ref(q[:, 0], k.to(q.dtype),
                                                     v.to(q.dtype), lengths)
        out = torch.einsum("bhk,hkd->bd", out_h.to(q.dtype), params["wo"])
        return out[:, None], cache

    # grouped GQA (no KV repeat): with sq == 1 every tensor here is tiny
    # except the cache itself, which is read exactly once.
    slots = torch.arange(length, device=x.device)
    pos_col = pos[:, None]
    if cfg.sliding_window:
        # slot s holds token pos - ((pos - s) mod L); valid if that is >= 0
        valid = pos_col - torch.remainder(pos_col - slots, length) >= 0
    else:
        valid = slots <= pos_col
    k, v = k.to(q.dtype), v.to(q.dtype)
    qg = q.reshape(b, 1, k.shape[2], cfg.q_per_kv, cfg.head_dim)
    scores = torch.einsum("bqngh,bsnh->bngqs", qg, k) * cfg.head_dim ** -0.5
    scores = torch.where(valid.reshape(b, 1, 1, 1, length), scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    out = torch.einsum("bngqs,bsnh->bqngh", p, v)
    out = out.reshape(b, 1, cfg.num_heads, cfg.head_dim)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache


def prefill_attention(params, cfg: ArchConfig, x, cache, positions,
                      lengths=None):
    """Batched prompt prefill THROUGH the decode cache: one call writes the
    whole prompt's K/V into slots [0, s) in place and returns full-sequence
    outputs.

    x: (b, s, d); positions: (s,) shared across rows (prompts are
    left-aligned at 0..s-1); lengths: optional (b,) valid prompt lengths —
    keys at or beyond a row's length are masked out (shorter prompts and
    zero-padded batch slots), though their outputs are still computed
    (callers read only positions < length).  Returns (out, cache).

    The prompt must fit the cache (s <= cache length): continuous-batching
    callers re-prefill from a bounded window rather than wrap mid-prompt.
    """
    s = x.shape[1]
    length = cache["k"].shape[1]
    if s > length:
        raise ValueError(f"prompt of {s} tokens exceeds cache length {length}")
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    cache["k"][:, :s] = k_new.to(cache["k"].dtype)
    cache["v"][:, :s] = v_new.to(cache["v"].dtype)

    k = _repeat_kv(k_new, cfg.q_per_kv)
    v = _repeat_kv(v_new, cfg.q_per_kv)
    scores = torch.einsum("bqhk,bshk->bhqs", q, k) * cfg.head_dim ** -0.5
    mask = positions[:, None] >= positions[None, :]
    if cfg.sliding_window is not None:
        mask &= (positions[:, None] - positions[None, :]) < cfg.sliding_window
    mask = mask[None, None]                                # (1, 1, s, s)
    if lengths is not None:
        mask = mask & (positions[None, None, None, :]
                       < lengths[:, None, None, None])
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    out = torch.einsum("bhqs,bshk->bqhk", p, v)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache
