"""Attention: GQA with RoPE, optional QKV bias, sliding windows, caches.

Mirrors `repro.models.attention` for one device. Full-sequence attention
(prefill) goes to the flash kernel and decode to the decode kernel
(`repro_torch.kernels.ops`); the route follows the device, not
``cfg.attn_impl``: CUDA tensors always launch the hand-written kernels,
CPU tensors run their plain versions. ``cfg.attn_impl`` stays in the
config for parity with the reference and chooses nothing here.

GQA layout: query heads are ordered grouped (h = g * rep + j), so head h
reads KV group h // rep, as in the reference.

The reference's ``constrain`` and ``_tp_align_heads`` are the identity on
one device and are not ported, nor is its head-aligned cache
(``cfg.kv_cache_align``): they come with the mesh slice, and such a config
raises. The int8 KV cache (``cfg.kv_cache_dtype == "int8"``) raises: it
comes with a later slice, and the reference's Pallas path does not take
it either.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (_dtype, normal_init, rope_cos_sin,
                                       rotate)

def check_cache_layout(cfg: ModelConfig) -> None:
    """Raise for the cache layouts this slice does not port."""
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "kv_cache_dtype='int8' (the quantised KV cache) is not ported "
            "yet: it comes with a later serving slice")
    if cfg.cache_heads != cfg.n_kv_heads:
        raise NotImplementedError(
            "kv_cache_align (a cache with replicated KV heads) is not "
            "ported yet: it comes with the mesh slice")


class AttnCache(NamedTuple):
    """Decode-time KV cache. ``k``/``v``: [..., B, W, G, Dh] (W = window or
    max_seq); ``pos_buf``: [..., B, W] absolute position per slot (-1 =
    empty), which makes rolling (SWA) and linear caches uniform. The
    model's caches carry a leading layer axis."""

    k: torch.Tensor
    v: torch.Tensor
    pos_buf: torch.Tensor


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   device=None) -> dict:
    d = cfg.d_model
    h, g, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    pdt = _dtype(cfg.param_dtype)
    dev = device or gen.device
    p = {
        "wq": normal_init(gen, (d, h, dh), 0.02, pdt, dev),
        "wk": normal_init(gen, (d, g, dh), 0.02, pdt, dev),
        "wv": normal_init(gen, (d, g, dh), 0.02, pdt, dev),
        "wo": normal_init(gen, (h, dh, d), 0.02 / (2 * cfg.n_layers) ** 0.5,
                          pdt, dev),
    }
    if cfg.qkv_bias:
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


def _project_qkv(x, p, cfg: ModelConfig):
    cdt = _dtype(cfg.dtype)
    q = _proj(x, p["wq"], cdt)
    k = _proj(x, p["wk"], cdt)
    v = _proj(x, p["wv"], cdt)
    if "bq" in p:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor, cdt: torch.dtype
              ) -> torch.Tensor:
    """out [B,S,H,Dh] @ wo [H,Dh,D] -> [B,S,D]."""
    h, dh, d = wo.shape
    return torch.matmul(out.flatten(-2), wo.to(cdt).reshape(h * dh, d))


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, int(window),
                                    int(q_offset))
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, bq=cfg.attn_q_chunk,
                                bkv=cfg.attn_kv_chunk)


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
                    cache: Optional[AttnCache] = None,
                    positions: Optional[torch.Tensor] = None,
                    return_kv: bool = False,
                    rope: Optional[tuple] = None,
                    valid: Optional[torch.Tensor] = None,
                    ) -> tuple[torch.Tensor, Optional[object]]:
    """One causal self-attention layer with rope (the decoder's; the
    reference's cross-attention and rope-free encoder modes come with the
    audio slice), windowed by ``cfg.swa_window``.

    Modes:
      * full-sequence (cache=None): prefill; x: [B,S,D]. With
        ``return_kv`` the second result is the projected (k, v) after
        rope, [B,S,G,Dh] each, for the decode cache.
      * decode (cache given): x: [B,1,D], positions: [B] absolute
        position of the new token. The new k/v are written into
        ``cache`` in place (slot ``pos % W``), and ``cache`` is returned;
        the reference returns an updated copy instead.

    ``rope``: the rotary (cos, sin) of these positions
    (`layers.rope_cos_sin`), which the decoder computes once for all its
    layers; computed here when not given.

    ``valid`` (decode): the [B, W] int8 slot validity of this step. The
    decoder writes the new positions into every layer's ``pos_buf`` and
    computes it once for all its layers (`decode_valid`), where the
    reference does both in each layer.
    """
    cdt = _dtype(cfg.dtype)
    window = cfg.swa_window
    b = x.shape[0]
    q, k, v = _project_qkv(x, p, cfg)

    if cache is None:
        rope = rope or rope_cos_sin(_prefill_positions(x, positions),
                                    q.shape[-1], cfg.rope_theta)
        q, k = rotate(q, rope), rotate(k, rope)
        out = blockwise_attention(q, k, v, cfg, causal=True, window=window)
        o = _out_proj(out, p["wo"], cdt)
        return o, ((k, v) if return_kv else None)

    # ---- decode path -----------------------------------------------------
    if x.shape[1] != 1:
        raise ValueError(f"decode takes one token per row, got x "
                         f"{list(x.shape)}")
    pos = positions                                     # [B] int
    rope = rope or rope_cos_sin(pos[:, None], q.shape[-1], cfg.rope_theta)
    q, k = rotate(q, rope), rotate(k, rope)
    w = cache.k.shape[1]
    rows = torch.arange(b, device=x.device)
    slot = pos.long() % w                   # rolling for SWA; linear: pos
    cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)
    out = _decode_attention(q, cache.k.to(cdt), cache.v.to(cdt), valid, cfg)
    return _out_proj(out, p["wo"], cdt), cache


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


def init_attn_cache(cfg: ModelConfig, batch: int, max_seq: int,
                    device: torch.device, *,
                    window: Optional[int] = None) -> AttnCache:
    """An empty cache of W = min(window, max_seq) slots; ``window``
    defaults to ``cfg.swa_window`` (or ``max_seq`` without one)."""
    check_cache_layout(cfg)
    w = window if window is not None else (cfg.swa_window or max_seq)
    w = min(w, max_seq)
    g, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    kv_dt = _dtype(cfg.kv_cache_dtype)
    shp = (batch, w, g, dh)
    return AttnCache(
        torch.zeros(shp, dtype=kv_dt, device=device),
        torch.zeros(shp, dtype=kv_dt, device=device),
        torch.full((batch, w), -1, dtype=torch.int32, device=device))
