"""GQA attention: full-sequence and prefill paths + single-token decode.

Supports RoPE, Qwen3 qk-norm, sliding-window (banded) masking, and
non-causal and cross attention for the Whisper encoder-decoder.  GQA K/V
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
cache, so callers read the same as in the reference.  A cache may hold
another dtype than the params (``transformer.init_cache`` defaults to
bfloat16): the decode kernel reads a bfloat16 cache under float32 queries
as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kernels_ref
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig
from repro_torch.sharding import current_rules, distributed, shard

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
    q = shard(q, "batch", "seq", "heads", "head_dim")
    k = shard(k, "batch", "kv_seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "kv_seq", "kv_heads", "head_dim")
    return q, k, v


def _repeat_kv(k, q_per_kv: int):
    """(b, s, kv, hd) -> (b, s, h, hd), sharded on the full head axis."""
    if q_per_kv == 1:
        return k
    k = torch.repeat_interleave(k, q_per_kv, dim=2)
    return shard(k, "batch", "kv_seq", "heads", "head_dim")


def _project_q(params, cfg: ArchConfig, x):
    """Cross-attention's query: qk-normed where the config has it, without
    RoPE (the JAX package's ``_project_qkv(rope=False)``, which also
    projects K/V from ``x`` and throws them away)."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    if cfg.qk_norm:
        q = layers.head_rmsnorm(params["q_norm"], q, cfg.rmsnorm_eps)
    return q


def attention(params, cfg: ArchConfig, x, positions, *, causal=True,
              kv=None):
    """Full-sequence attention over x: (b, s, d); positions: (s,).  ``kv``
    = (k, v), each (b, sk, kv_heads, head_dim), overrides K/V
    (cross-attention; call it with ``causal=False``): q is then projected
    without RoPE.

    The scores and softmax run in ``ops.flash_attention`` (the CUDA kernel
    on CUDA tensors, its plain version on CPU tensors), which takes q and
    the unrepeated GQA K/V, after RoPE and qk-norm, as (b, heads, s,
    head_dim) views of the (b, s, heads, head_dim) tensors, without copies;
    the kernel writes its output in the model's order too (on DTensors
    K/V are repeated to the full head count first).  Both mask by
    index, not by ``positions``: every
    caller passes contiguous positions (``arange(seq)``), and the causal
    and window masks depend only on q_pos - k_pos, so this is exact.
    Positions are not checked on the device, which would cost a sync per
    call.  The plain version scans queries in chunks of 1024 when that
    divides sq, as the JAX package does, to bound its memory at long
    sequence lengths; the kernel bounds its own.

    Under sharding rules (``repro_torch.sharding``) the layout hints sit on
    q, K/V and the output around the ``ops.flash_attention`` call, where
    the JAX package also pins its scores: those live inside the call here.
    When the ``q_seq`` rule resolves to a mesh axis (heads that do not
    divide the model axis), attention is sequence-parallel: q is sharded
    on its positions, K/V are gathered whole, and queries are not chunked
    (a chunk would gather the sharded positions).
    """
    if kv is None:
        q, k, v = _project_qkv(params, cfg, x, positions)
    else:
        q, (k, v) = _project_q(params, cfg, x), kv
    sq = q.shape[1]
    if distributed(k):
        # DTensors: K/V repeated to every query head, sharded on heads as
        # the JAX package repeats them, so the plain version's products
        # shard on heads (it repeats nothing then); plain tensors, the
        # kernel's route included, keep the GQA K/V
        k = _repeat_kv(k, cfg.q_per_kv)
        v = _repeat_kv(v, cfg.q_per_kv)
    # sequence-parallel attention: when the q_seq rule maps to a mesh axis
    # (heads not divisible by the model axis), shard query positions and
    # compute un-chunked — scores are (b, h, sq/P, sk), already small.
    rules = current_rules()
    seq_par = False
    if rules is not None:
        spec = rules.mesh_axes(("q_seq",), (sq,))
        if spec and spec[0] is not None:
            seq_par = True
            q = shard(q, "batch", "q_seq", "heads", "head_dim")
            k = shard(k, "batch", None, None, None)
            v = shard(v, "batch", None, None, None)
    unchunked = {"q_chunk": sq} if seq_par else {}
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=cfg.sliding_window, **unchunked)
    # hints in the (b, s, h, hd) order; a plain tensor comes back as the
    # same (b, h, s, hd) view
    out = out.transpose(1, 2)
    out = shard(out, "batch", "q_seq" if seq_par else None, "heads",
                "head_dim")
    out = shard(out, "batch", "seq", "heads", "head_dim").transpose(1, 2)
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


def _grouped_out(params, cfg: ArchConfig, q, k, v, valid):
    """Grouped-GQA scores, softmax and output projection (no KV repeat):
    with sq == 1 every tensor here is tiny except the cache itself, which
    is read once.  ``valid``: (b, length) bools, or None for every key."""
    b = q.shape[0]
    k, v = k.to(q.dtype), v.to(q.dtype)
    qg = q.reshape(b, 1, k.shape[2], cfg.q_per_kv, cfg.head_dim)
    scores = torch.einsum("bqngh,bsnh->bngqs", qg, k) * cfg.head_dim ** -0.5
    if valid is not None:
        scores = torch.where(valid.reshape(b, 1, 1, 1, -1), scores,
                             torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    out = torch.einsum("bngqs,bsnh->bqngh", p, v)
    out = out.reshape(b, 1, cfg.num_heads, cfg.head_dim)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def _kernel_out(params, q, k, v, lengths, backend):
    """The decode kernel (``"kernel"``) or its plain version (``"ref"``)
    over the valid prefix ``lengths`` of each row, then the output
    projection.  Both index the KV head of each query head directly (no
    repeat); the kernel reads a bfloat16 cache under float32 queries as it
    is, and a cache wider than bfloat16 queries is narrowed first, as the
    JAX package casts every cache to q's dtype."""
    if backend == "kernel":
        if q.dtype == torch.bfloat16 and k.dtype != q.dtype:
            k, v = k.to(q.dtype), v.to(q.dtype)
        out_h = ops.decode_attention(q[:, 0].contiguous(), k, v, lengths)
    else:
        out_h = kernels_ref.decode_attention_ref(q[:, 0], k.to(q.dtype),
                                                 v.to(q.dtype), lengths)
    out = torch.einsum("bhk,hkd->bd", out_h.to(q.dtype), params["wo"])
    return out[:, None]


def _write_slots(cache_t, slot, new):
    """``cache_t[r, slot[r]] = new[r, 0]`` for every row r, in place: a
    scatter along the length axis, which leaves every other axis where it
    is (a cache sharded on batch and heads takes it as it is).  A one-byte
    cache (float8) is written through a byte view: the CPU's scatter has
    no float8 kernel, and a copy moves the same bits."""
    b = cache_t.shape[0]
    index = slot.reshape(b, 1, 1, 1).expand(b, 1, *cache_t.shape[2:])
    new = new.to(cache_t.dtype)
    if cache_t.element_size() == 1:
        cache_t, new = cache_t.view(torch.uint8), new.view(torch.uint8)
    cache_t.scatter_(1, index, new)


def decode_attention(params, cfg: ArchConfig, x, cache, pos, *,
                     cross_kv=None, backend: str = "grouped"):
    """One-token decode. x: (b, 1, d); pos: scalar (current index, shared)
    or ``(b,)`` per-row positions (continuous batching: rows at different
    episode depths decoded in one dispatch).

    K is stored after RoPE.  Writes the new K/V into ``cache`` in place and
    returns (out (b, 1, d), cache).  With ``cross_kv`` = (k, v), each (b,
    encoder_len, kv_heads, head_dim) (Whisper's cross-attention), only q is
    projected, without RoPE, it attends to every encoder key, and ``cache``
    is passed through untouched.

    ``backend`` selects the score/softmax path once the cache is updated
    (see ``_decode_backend``): ``"kernel"`` (the CUDA flash-decoding kernel,
    per-row valid prefix lengths), ``"ref"`` (its plain version),
    ``"grouped"`` (grouped-GQA einsum) or ``"auto"``.
    """
    b = x.shape[0]
    backend = _decode_backend(backend, x.device)
    if cross_kv is not None:
        q, (k, v) = _project_q(params, cfg, x), cross_kv
        if backend == "grouped":
            return _grouped_out(params, cfg, q, k, v, None), cache
        lengths = torch.full((b,), k.shape[1], dtype=torch.int32,
                             device=x.device)
        return _kernel_out(params, q, k, v, lengths, backend), cache

    pos = torch.as_tensor(pos, device=x.device).long()
    if pos.dim() == 0:
        pos = pos.expand(b)
    q, k_new, v_new = _project_qkv(params, cfg, x, pos[:, None])

    length = cache["k"].shape[1]
    slot = torch.remainder(pos, length) if cfg.sliding_window else pos
    _write_slots(cache["k"], slot, k_new)
    _write_slots(cache["v"], slot, v_new)
    k, v = cache["k"], cache["v"]

    if backend in ("kernel", "ref"):
        # Both mask a VALID PREFIX per row.  That is exactly the occupancy
        # of our caches: a linear cache holds slots [0, pos] and a full ring
        # holds all L slots — min(pos+1, L) either way.  Ring wraparound
        # scrambles chronological order, but softmax attention is
        # permutation-invariant over the key set and K is stored post-RoPE,
        # so prefix masking stays correct after wrap.
        lengths = torch.clamp(pos + 1, max=length).to(torch.int32)
        return _kernel_out(params, q, k, v, lengths, backend), cache

    slots = torch.arange(length, device=x.device)
    pos_col = pos[:, None]
    if cfg.sliding_window:
        # slot s holds token pos - ((pos - s) mod L); valid if that is >= 0
        valid = pos_col - torch.remainder(pos_col - slots, length) >= 0
    else:
        valid = slots <= pos_col
    return _grouped_out(params, cfg, q, k, v, valid), cache


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

    On the card the scores and softmax run in ``ops.flash_attention``
    (causal, the config's window) over the prompt's own K/V, without the
    ``lengths`` mask: under the causal mask a row's query at a position
    below its length sees only keys below it, so the mask changes only rows
    at or past the length, which callers never read.  On the CPU the JAX
    package's masked softmax runs as it is.

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

    if ops._on_card(x):
        out = ops.flash_attention(q.transpose(1, 2), k_new.transpose(1, 2),
                                  v_new.transpose(1, 2), causal=True,
                                  window=cfg.sliding_window)
        return torch.einsum("bhsk,hkd->bsd", out, params["wo"]), cache
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
