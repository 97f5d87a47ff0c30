"""Attention: GQA with RoPE, optional QKV bias, sliding windows, caches.

Mirrors `repro.models.attention` for one device. Full-sequence attention
(prefill, the encoder, cross-attention over the encoder's output) goes to
the flash kernel and decode (self and cross) to the decode kernel
(`repro_torch.kernels.ops`); the route follows the device, not
``cfg.attn_impl``: CUDA tensors always launch the hand-written kernels,
CPU tensors run their plain versions. ``cfg.attn_impl`` stays in the
config for parity with the reference and chooses nothing here.

GQA layout: query heads are ordered grouped (h = g * rep + j), so head h
reads KV group h // rep, as in the reference.

The int8 KV cache (``cfg.kv_cache_dtype == "int8"``) holds absmax int8
K/V with per-(token, head) float32 scales. The reference decodes such a
cache outside its Pallas kernel (`repro/models/attention.py:347`), with
the k-scale on the scores and the v-scale folded into the softmax
weights; the port does the same in PyTorch operations on the cache's
device (`decode_attention_int8`, which counts its calls), chosen by the
cache's dtype.

Tensor parallelism (under a live mesh, `repro_torch.parallel.axes`): the
reference's ``constrain`` points place Q/K/V on ``heads`` / ``kv_heads``
over ``model`` after `_tp_align_heads` made the head counts divisible by
the model axis. The kernels then run on each rank's own heads: their
wrappers receive the DTensors' local shards, made contiguous (the ctypes
kernels read raw pointers), and the output goes back as a DTensor with
the query's placements. Decode writes its new K/V into the rank's own
shard of the cache. The head-aligned cache (``cfg.kv_cache_align``,
`ModelConfig.cache_heads`) stores the KV heads replicated to that count,
so that the cache shards evenly over ``model`` and decode needs no
collective for it.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import (_dtype, normal_init, rope_cos_sin,
                                       rotate, row_parallel)
from repro_torch.parallel.axes import (axis_size, constrain, current_mesh,
                                       is_dtensor, like, local, redistribute,
                                       replicated, shard_offsets)


class AttnCache(NamedTuple):
    """Decode-time KV cache. ``k``/``v``: [..., B, W, G, Dh] (W = window or
    max_seq); ``pos_buf``: [..., B, W] absolute position per slot (-1 =
    empty), which makes rolling (SWA) and linear caches uniform. The
    model's caches carry a leading layer axis.

    With ``cfg.kv_cache_dtype == "int8"``, k/v hold per-(token, head)
    absmax-scaled int8 and ``k_scale``/``v_scale`` [..., B, W, G] float32
    carry the scales; they are None otherwise."""

    k: torch.Tensor
    v: torch.Tensor
    pos_buf: torch.Tensor
    k_scale: Any = None
    v_scale: Any = None


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Absmax int8 over the trailing (head_dim) axis.
    x: [..., Dh] -> (int8 [..., Dh], float32 scale [...])."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device=None, *, cross: bool = False,
                   n_layers_scale: Optional[int] = None) -> dict:
    """One attention layer's projections. ``cross``: a cross-attention
    layer (no QKV bias); ``n_layers_scale``: the depth that scales the
    output projection (default ``cfg.n_layers``; the encoder's is
    ``cfg.enc_layers``)."""
    d = cfg.d_model
    h, g, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    pdt = _dtype(cfg.param_dtype)
    dev = device or gen.device
    depth = n_layers_scale or cfg.n_layers
    p = {
        "wq": normal_init(gen, (d, h, dh), 0.02, pdt, dev),
        "wk": normal_init(gen, (d, g, dh), 0.02, pdt, dev),
        "wv": normal_init(gen, (d, g, dh), 0.02, pdt, dev),
        "wo": normal_init(gen, (h, dh, d), 0.02 / (2 * depth) ** 0.5,
                          pdt, dev),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((h, dh), dtype=pdt, device=dev)
        p["bk"] = torch.zeros((g, dh), dtype=pdt, device=dev)
        p["bv"] = torch.zeros((g, dh), dtype=pdt, device=dev)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor, cdt: torch.dtype
          ) -> torch.Tensor:
    """x [B,S,D] @ w [D,N,Dh] -> [B,S,N,Dh]."""
    d, n, dh = w.shape
    return torch.matmul(x, w.to(cdt).reshape(d, n * dh)).unflatten(
        -1, (n, dh))


def _project_qkv(x, x_kv, p, cfg: ModelConfig):
    cdt = _dtype(cfg.dtype)
    x = constrain(x, "batch", None, None)
    x_kv = x if x_kv is None else constrain(x_kv, "batch", None, None)
    q = _proj(x, constrain(p["wq"], None, "heads", None), cdt)
    k = _proj(x_kv, constrain(p["wk"], None, "kv_heads", None), cdt)
    v = _proj(x_kv, constrain(p["wv"], None, "kv_heads", None), cdt)
    if "bq" in p:
        q = q + constrain(p["bq"], "heads", None).to(cdt)
        k = k + constrain(p["bk"], "kv_heads", None).to(cdt)
        v = v + constrain(p["bv"], "kv_heads", None).to(cdt)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor, cdt: torch.dtype
              ) -> torch.Tensor:
    """out [B,S,H,Dh] @ wo [H,Dh,D] -> [B,S,D] (under a mesh: float32,
    a partial sum over ``model`` when the heads are split over it; see
    `layers.row_parallel`)."""
    wo = constrain(wo, "heads", None, None)
    out = constrain(out, "batch", None, "heads", None)
    h, dh, d = wo.shape
    return row_parallel(out.flatten(-2), wo.reshape(h * dh, d), cdt)


def _tp_align_heads(q, k, v):
    """Align head counts to the tensor-parallel width (the reference's
    Megatron GQA layout), exactly:

      * H, G both divisible by TP: untouched;
      * H divisible, TP divisible by G: KV heads replicated to TP
        (adjacent copies keep the grouped q -> kv mapping);
      * otherwise: KV replicated to H (MHA) and Q, K, V zero-padded to
        the next multiple of TP; the caller slices the padded heads off.

    Returns (q, k, v, h_orig). A head dimension that is changed here is
    not sharded (its count does not divide TP), so each rank changes its
    own copy and the global shape follows."""
    tp = axis_size("model")
    h, g = q.shape[-2], k.shape[-2]
    if tp <= 1 or (h % tp == 0 and g % tp == 0):
        return q, k, v, h
    if h % tp == 0 and tp % g == 0 and g < tp:
        k, v = (_repeat_heads(t, tp // g) for t in (k, v))
        return q, k, v, h
    if h // g > 1:
        k, v = (_repeat_heads(t, h // g) for t in (k, v))
    h_pad = -(-h // tp) * tp
    if h_pad != h:
        q, k, v = (_pad_heads(t, h_pad) for t in (q, k, v))
    return q, k, v, h


def _repeat_heads(x, rep: int):
    """Each head of x [..., G, Dh] repeated ``rep`` times in place (G*rep
    heads). Rank-local for a DTensor: a rank's shard of the repeated
    heads is the repeat of its shard of the heads."""
    out = local(x).repeat_interleave(rep, dim=-2)
    shape = tuple(x.shape[:-2]) + (x.shape[-2] * rep, x.shape[-1])
    return like(out, x, shape)


def _pad_heads(x, n: int):
    """x [..., H, Dh] zero-padded to n heads (H not sharded)."""
    loc = local(x)
    pad = loc.new_zeros(tuple(loc.shape[:-2]) + (n - x.shape[-2],
                                                 loc.shape[-1]))
    shape = tuple(x.shape[:-2]) + (n, x.shape[-1])
    return like(torch.cat([loc, pad], dim=-2), x, shape)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        cfg: ModelConfig, *, causal: bool,
                        window: int = 0, q_offset: int = 0
                        ) -> torch.Tensor:
    """q: [B, Sq, H, Dh]; k, v: [B, Skv, G, Dh]; returns [B, Sq, H, Dh].

    The flash kernel on the card, its plain blocked version on the CPU
    (both online-softmax over 64 x 64 tiles with an f32 carry); the
    reference's chunk sizes ``cfg.attn_q_chunk``/``attn_kv_chunk`` are
    passed for parity and do not change the result. With grad mode on and
    an input that requires grad, the call goes through `FlashAttention`,
    which launches the same kernel and gives it a backward."""
    if current_mesh() is not None:
        return _mesh_flash(q, k, v, cfg, causal, window, q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, int(window),
                                    int(q_offset))
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, bq=cfg.attn_q_chunk,
                                bkv=cfg.attn_kv_chunk)


def _on_local_heads(fn, q, k, v):
    """Attention under a live mesh: heads aligned (`_tp_align_heads`) and
    sharded over ``model`` (the reference's constrain points), ``fn`` (a
    kernel call) on each rank's contiguous local q, k, v, the output a
    DTensor placed as the query, the padded heads cut off."""
    h_orig = q.shape[2]
    q, k, v, _ = _tp_align_heads(q, k, v)
    q, k, v = (constrain(t, "batch", None, "heads", None) for t in (q, k, v))
    out = fn(*(local(t).contiguous() for t in (q, k, v)))
    out = like(out.contiguous(), q, q.shape)
    if q.shape[2] != h_orig:               # padded heads never reach wo
        out = constrain(out, "batch", None, None, None)[:, :, :h_orig]
    return out


def _mesh_flash(q, k, v, cfg: ModelConfig, causal: bool, window: int,
                q_offset: int):
    """Full-sequence attention under a live mesh: the flash kernel on each
    rank's heads."""
    def flash(ql, kl, vl):
        if torch.is_grad_enabled() and (ql.requires_grad or kl.requires_grad
                                        or vl.requires_grad):
            return FlashAttention.apply(ql, kl, vl, causal, int(window),
                                        int(q_offset))
        return kops.flash_attention(ql, kl, vl, causal=causal, window=window,
                                    q_offset=q_offset)
    return _on_local_heads(flash, q, k, v)


BWD_TILE = 128   # query rows a step of the backward: [B, H, 128, Skv] f32


class FlashAttention(torch.autograd.Function):
    """The flash kernel under autograd (training).

    Forward: `kops.flash_attention` on the detached inputs, exactly as
    serving calls it (the kernel on CUDA tensors, its plain version on CPU
    tensors); q, k, v and the output are saved. Backward: the analytic
    softmax-attention gradient in PyTorch operations (`attention_backward`),
    the gradient the reference takes with XLA through its blockwise
    attention; the reference has no backward kernel either. ``calls`` and
    ``backward_calls`` count the two directions."""

    calls = 0
    backward_calls = 0

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        out = kops.flash_attention(q.detach(), k.detach(), v.detach(),
                                   causal=causal, window=window,
                                   q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.masks = (causal, window, q_offset)
        FlashAttention.calls += 1
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out = ctx.saved_tensors
        FlashAttention.backward_calls += 1
        dq, dk, dv = attention_backward(q, k, v, out, d_out, *ctx.masks)
        return dq, dk, dv, None, None, None


def attention_backward(q, k, v, out, d_out, causal: bool, window: int = 0,
                       q_offset: int = 0, tile: int = BWD_TILE):
    """dq, dk, dv of softmax attention from the saved q, k, v and the
    forward's output ``out``, one tile of ``tile`` query rows at a time
    (so [B, H, tile, Skv] float32 bounds the memory), in float32:

        S = q k^T Dh^-1/2 under the causal / window / ``q_offset`` masks
        P = exp(S - logsumexp S);  D = rowsum(dO o)
        dV = P^T dO;  dS = P (dO V^T - D)
        dQ = dS K Dh^-1/2;  dK = dS^T Q Dh^-1/2

    with each KV group summing its heads' dK and dV (GQA). A tile reads
    only the keys its masks leave it. A row that sees no key gets no
    gradient. Shapes as `blockwise_attention`'s; each gradient comes back
    in its input's dtype."""
    b, sq, h, dh = q.shape
    skv, g = k.shape[1], k.shape[2]
    r = h // g
    scale = dh ** -0.5
    kf, vf = k.float(), v.float()
    dq = torch.empty((b, sq, g, r, dh), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((b, skv, g, dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i0 in range(0, sq, tile):
        i1 = min(i0 + tile, sq)
        lo = max(0, q_offset + i0 - window + 1) if window else 0
        hi = min(skv, q_offset + i1) if causal else skv
        if lo >= hi:
            dq[:, i0:i1] = 0.0
            continue
        qt = q[:, i0:i1].float().reshape(b, i1 - i0, g, r, dh)
        dot = d_out[:, i0:i1].float().reshape(b, i1 - i0, g, r, dh)
        ot = out[:, i0:i1].float().reshape(b, i1 - i0, g, r, dh)
        kt, vt = kf[:, lo:hi], vf[:, lo:hi]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qt, kt) * scale
        qpos = q_offset + torch.arange(i0, i1, device=q.device)
        kpos = torch.arange(lo, hi, device=q.device)
        mask = torch.ones((i1 - i0, hi - lo), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = s.masked_fill(~mask, float("-inf"))
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        p = torch.exp(s - lse.clamp(min=-3e38)).masked_fill(~mask, 0.0)
        dd = (dot * ot).sum(dim=-1).permute(0, 2, 3, 1)[..., None]
        ds = p * (torch.einsum("bqgrd,bkgd->bgrqk", dot, vt) - dd)
        dq[:, i0:i1] = torch.einsum("bgrqk,bkgd->bqgrd", ds, kt) * scale
        dk[:, lo:hi] += torch.einsum("bgrqk,bqgrd->bkgd", ds, qt) * scale
        dv[:, lo:hi] += torch.einsum("bgrqk,bqgrd->bkgd", p, dot)
    return (dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_layer(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
                    causal: bool = True,
                    use_rope: bool = True,
                    x_kv: Optional[torch.Tensor] = None,
                    cache: Optional[AttnCache] = None,
                    positions: Optional[torch.Tensor] = None,
                    cross_kv: Optional[tuple] = None,
                    window: Optional[int] = None,
                    return_kv: bool = False,
                    rope: Optional[tuple] = None,
                    valid: Optional[torch.Tensor] = None,
                    ) -> tuple[torch.Tensor, Optional[object]]:
    """One attention layer (``window`` defaults to ``cfg.swa_window``).

    Modes:
      * full-sequence (cache=None): prefill, the encoder; x: [B,S,D]; keys
        and values from ``x_kv`` (default x); ``causal`` and ``use_rope``
        as the reference's (the encoder is bidirectional and rope-free).
        With ``return_kv`` the second result is the projected (k, v) after
        rope, [B,S,G,Dh] each, for the decode cache.
      * decode (cache given): x: [B,1,D], positions: [B] absolute
        position of the new token. The new k/v are written into
        ``cache`` in place (slot ``pos % W``; quantised to int8 with their
        scales for an int8 cache), and ``cache`` is returned; the
        reference returns an updated copy instead.
      * cross attention: ``cross_kv=(k, v)`` [B,Skv,G,Dh] precomputed from
        the encoder (no cache update, no rope, no mask): the flash kernel
        with ``causal=False`` for a prompt, the decode kernel over every
        slot for one token (``valid``: the [B, Skv] int8 all-ones mask,
        made here when not given).

    ``rope``: the rotary (cos, sin) of these positions
    (`layers.rope_cos_sin`), which the decoder computes once for all its
    layers; computed here when not given.

    ``valid`` (decode): the [B, W] int8 slot validity of this step. The
    decoder writes the new positions into every layer's ``pos_buf`` and
    computes it once for all its layers (`decode_valid`), where the
    reference does both in each layer.
    """
    cdt = _dtype(cfg.dtype)
    window = cfg.swa_window if window is None else window
    b = x.shape[0]

    if cross_kv is not None:
        k, v = cross_kv
        q = _proj(constrain(x, "batch", None, None),
                  constrain(p["wq"], None, "heads", None), cdt)
        if "bq" in p:
            q = q + constrain(p["bq"], "heads", None).to(cdt)
        if x.shape[1] == 1:   # decode: q len 1, all encoder slots valid
            if valid is None:
                valid = torch.ones(k.shape[:2], dtype=torch.int8,
                                   device=local(k).device)
            if current_mesh() is not None:
                rows = local(constrain(valid, "batch", None))
                out = _on_local_heads(lambda ql, kl, vl: _decode_attention(
                    ql, kl.to(cdt), vl.to(cdt), rows, cfg), q, k, v)
            else:
                out = _decode_attention(q, k.to(cdt), v.to(cdt), valid, cfg)
        else:
            out = blockwise_attention(q, k, v, cfg, causal=False)
        return _out_proj(out, p["wo"], cdt), None

    q, k, v = _project_qkv(x, x if x_kv is None else x_kv, p, cfg)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)

    if cache is None:
        if use_rope:
            rope = rope or rope_cos_sin(_prefill_positions(x, positions),
                                        q.shape[-1], cfg.rope_theta)
            q, k = rotate(q, rope), rotate(k, rope)
        out = blockwise_attention(q, k, v, cfg, causal=causal,
                                  window=window)
        o = _out_proj(out, p["wo"], cdt)
        if return_kv:
            # collected K/V feed the decode cache: placed like the cache
            # (positions over `model` under the training rules)
            k = constrain(k, "batch", "cache_seq", None, None)
            v = constrain(v, "batch", "cache_seq", None, None)
            return o, (k, v)
        return o, None

    # ---- decode path -----------------------------------------------------
    if x.shape[1] != 1:
        raise ValueError(f"decode takes one token per row, got x "
                         f"{list(x.shape)}")
    pos = positions                                     # [B] int
    if use_rope:
        rope = rope or rope_cos_sin(pos[:, None], q.shape[-1],
                                    cfg.rope_theta)
        q, k = rotate(q, rope), rotate(k, rope)
    if cache.k.shape[2] != k.shape[2]:   # aligned cache: replicate kv heads
        k, v = (_repeat_heads(t, cache.k.shape[2] // k.shape[2])
                for t in (k, v))
    if is_dtensor(cache.k):
        out = _mesh_decode(q, k, v, cache, pos, valid, cfg)
        return _out_proj(out, p["wo"], cdt), cache
    w = cache.k.shape[1]
    rows = torch.arange(b, device=x.device)
    slot = pos.long() % w                   # rolling for SWA; linear: pos
    if cache.k_scale is not None:
        kq, ks = quantize_kv(k[:, 0])
        vq, vs = quantize_kv(v[:, 0])
        cache.k[rows, slot], cache.k_scale[rows, slot] = kq, ks
        cache.v[rows, slot], cache.v_scale[rows, slot] = vq, vs
        out = decode_attention_int8(q, cache.k, cache.v, valid,
                                    cache.k_scale, cache.v_scale)
    else:
        cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)
        out = _decode_attention(q, cache.k.to(cdt), cache.v.to(cdt), valid,
                                cfg)
    return _out_proj(out, p["wo"], cdt), cache


def _decode_placements(cache_k) -> tuple:
    """Placements of a decode step's q / new k, v [B, 1, H, Dh] that
    match a cache [B, W, G, Dh]: the cache's batch and head shards, every
    other mesh axis replicated (a cache split over positions is gathered
    for the kernel, and each position's owner writes it)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                 else Replicate() for p in cache_k.placements)


def _write_local(buf: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                 w0: int) -> None:
    """Write ``new`` [Bl, ...] into the rank's cache shard buf [Bl, Wl,
    ...] at global slots ``slot`` [Bl], the rows whose slot lies in the
    shard's positions [w0, w0 + Wl) only (no host synchronisation)."""
    wl = buf.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)
    hit = (slot >= w0) & (slot < w0 + wl)
    at = (slot - w0).clamp(0, wl - 1)
    keep = hit.view((-1,) + (1,) * (new.ndim - 1))
    buf[rows, at] = torch.where(keep, new.to(buf.dtype), buf[rows, at])


def _mesh_decode(q, k, v, cache: AttnCache, pos, valid, cfg: ModelConfig):
    """One decode step's attention under a live mesh. The cache and
    ``valid`` are DTensors; q, k, v are placed on the cache's batch and
    head shards; each rank writes its rows' new K/V into its own shard of
    the cache in place, and the decode kernel (or the int8 route) runs on
    the rank's heads. Returns the output [B, 1, H, Dh] as a DTensor."""
    from torch.distributed.tensor import Replicate, Shard

    pl = _decode_placements(cache.k)
    q, k, v = (redistribute(replicated(t), pl) for t in (q, k, v))
    b0, w0 = shard_offsets(cache.k)[:2]
    bl = local(cache.k).shape[0]
    slot = pos.long()[b0:b0 + bl] % cache.k.shape[1]
    quant = cache.k_scale is not None
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(local(k)[:, 0]), \
            quantize_kv(local(v)[:, 0])
        for buf, new in ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
                         (cache.v_scale, vs)):
            _write_local(local(buf), new, slot, w0)
    else:
        _write_local(local(cache.k), local(k)[:, 0], slot, w0)
        _write_local(local(cache.v), local(v)[:, 0], slot, w0)

    def whole(t):                     # every position of the rank's rows
        if t is None:
            return None
        full = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1
                     else p for p in t.placements)
        return local(redistribute(t, full))
    kk, vv = whole(cache.k), whole(cache.v)
    ql, vld = local(q).contiguous(), local(valid)
    if quant:
        out = decode_attention_int8(ql, kk, vv, vld, whole(cache.k_scale),
                                    whole(cache.v_scale))
    else:
        cdt = _dtype(cfg.dtype)
        out = _decode_attention(ql, kk.to(cdt).contiguous(),
                                vv.to(cdt).contiguous(), vld, cfg)
    return like(out.contiguous(), q, q.shape)


def decode_valid(pos_buf: torch.Tensor, pos: torch.Tensor,
                 window: int) -> torch.Tensor:
    """[B, W] int8: 1 where a cache slot holds a key the token at ``pos``
    may see (written, not after ``pos``, inside the window).
    pos_buf: [B, W] slot positions (-1 = empty); pos: [B]."""
    valid = pos_buf <= pos[:, None]
    if window:
        valid &= pos_buf > (pos[:, None] - window)
    valid &= pos_buf >= 0
    return valid.to(torch.int8)


def _prefill_positions(x: torch.Tensor, positions=None) -> torch.Tensor:
    """[B, S] positions of a full-sequence pass (default 0..S-1)."""
    b, s = x.shape[:2]
    pos = torch.arange(s, device=x.device) if positions is None \
        else positions
    return torch.broadcast_to(pos, (b, s))


def _decode_attention(q, k, v, valid, cfg: ModelConfig):
    """q: [B,1,H,Dh]; k,v: [B,W,G,Dh]; valid: [B,W] int8. The decode
    kernel on the card, its plain version on the CPU."""
    return kops.decode_attention(q, k, v, valid, bkv=cfg.attn_kv_chunk)


def decode_attention_int8(q, k, v, valid, k_scale, v_scale
                          ) -> torch.Tensor:
    """One-token attention over an int8 cache, the reference's own route
    for it (`repro/models/attention.py` `_decode_attention` with scales):
    PyTorch operations in float32 on the cache's device, the k-scale on
    the scores and the v-scale folded into the softmax weights, so the
    dequantised cache is never made. q: [B,1,H,Dh]; k, v: [B,W,G,Dh]
    int8; valid: [B,W] (int8 or bool); k_scale, v_scale: [B,W,G] float32.
    Returns [B,1,H,Dh] in q's dtype. ``decode_attention_int8.calls``
    counts the calls."""
    decode_attention_int8.calls += 1
    b, _, h, dh = q.shape
    g = k.shape[2]
    qg = q.reshape(b, g, h // g, dh).float()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k.float()) * dh ** -0.5
    s = s * k_scale.permute(0, 2, 1)[:, :, None, :]       # [B,G,1,W]
    s = torch.where(valid.bool()[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1) * v_scale.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bgrk,bkgd->bgrd", p, v.float())
    return out.reshape(b, 1, h, dh).to(q.dtype)


decode_attention_int8.calls = 0


def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int,
                    device: torch.device, *,
                    window: Optional[int] = None) -> AttnCache:
    """An empty cache of W = min(window, max_seq) slots; ``window``
    defaults to ``cfg.swa_window`` (or ``max_seq`` without one). An int8
    cache carries zero [B, W, G] float32 scales (G: `cfg.cache_heads`,
    the KV heads as the cache stores them)."""
    w = window if window is not None else (cfg.swa_window or max_seq)
    w = min(w, max_seq)
    g, dh = cfg.cache_heads, cfg.resolved_head_dim
    kv_dt = _dtype(cfg.kv_cache_dtype)
    shp = (batch, w, g, dh)
    quant = cfg.kv_cache_dtype == "int8"

    def scales():
        return torch.zeros((batch, w, g), dtype=torch.float32,
                           device=device) if quant else None
    return AttnCache(
        torch.zeros(shp, dtype=kv_dt, device=device),
        torch.zeros(shp, dtype=kv_dt, device=device),
        torch.full((batch, w), -1, dtype=torch.int32, device=device),
        k_scale=scales(), v_scale=scales())
