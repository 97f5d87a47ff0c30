"""Public model API of the serving path (mirrors `repro.models.model`).

  init_params        random parameters from a `torch.Generator`
  params_from_numpy  the reference's parameter pytree (as numpy) carried
                     into the port's parameters
  prefill            full-sequence forward -> (last-position logits, caches)
  decode_step        one token per row against the caches
  init_cache         the empty decode cache
  loss_fn            the training loss (next-token cross-entropy)

Parameters and caches carry a leading stacked layer axis, as in the
reference. Unlike the reference, `decode_step` updates the caches in
place (the [L, B, W, G, Dh] pool, or the SSM conv and state pool, is
written, not copied) and returns the same object. Every family is
ported (dense, vlm, moe, ssm, hybrid, audio), with the bf16 and the int8
KV cache. ``cache_specs`` and ``param_specs`` wait for the mesh slice
(queue 1 item 9).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (AttnCache, check_cache_layout,
                                          init_attn_cache, quantize_kv)
from repro_torch.models.layers import _dtype, embed, rms_norm, unembed
from repro_torch.models.ssm import init_ssm_cache
from repro_torch.models.transformer import (check_family, decoder_forward,
                                            encdec_decoder_forward,
                                            encoder_forward,
                                            init_model_params)


def init_params(key: Union[int, torch.Generator], cfg: ModelConfig, *,
                device: DeviceLike = None) -> dict:
    """Random parameters. ``key`` is a `torch.Generator` (the parameters
    are drawn and kept on its device) or an int seed: then a CPU generator
    draws them, leaf by leaf, and each leaf is copied to ``device``
    (default cuda), so one seed gives the same parameters on every device
    (CUDA's Philox stream is not the CPU's)."""
    if isinstance(key, torch.Generator):
        return init_model_params(key, cfg)
    gen = torch.Generator().manual_seed(int(key))
    return init_model_params(gen, cfg, resolve_device(device))


def _tensor(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":        # ml_dtypes: torch has no numpy view
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def params_from_numpy(tree: dict, cfg: ModelConfig, *,
                      device: DeviceLike = None) -> dict:
    """The reference's parameter pytree (`repro.models.model.init_params`
    output, leaves converted to numpy) as the port's parameters on
    ``device``: the same nesting and names, [L, ...] stacked blocks (and
    the hybrid family's ``shared`` block, the audio family's
    ``enc_blocks`` and ``enc_norm``), each leaf in its own dtype."""
    check_family(cfg)
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return _tensor(t, dev)
    return conv({k: tree[k] for k in ("embed", "blocks", "final_norm",
                                      "shared", "enc_blocks", "enc_norm")
                 if k in tree})


def _token_nll(h: torch.Tensor, labels: torch.Tensor, params: dict,
               cfg: ModelConfig) -> torch.Tensor:
    """Per-token negative log-likelihood [B, S] in float32; h: [B,S,D]
    (final-normed).

    With ``cfg.loss_chunk`` (and S a multiple of it larger than it), the
    cross-entropy runs one sequence chunk at a time, each chunk under
    checkpoint while autograd records: only one chunk's [B, chunk, V]
    float32 logits is alive, in the forward and in the backward."""
    def ce(hc, lc):
        logits = unembed(hc, params["embed"], cfg).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return lse - gold                                   # [B, s]

    s = h.shape[1]
    chunk = cfg.loss_chunk
    if chunk and s > chunk and s % chunk == 0:
        if torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            def run(hc, lc):
                return checkpoint(ce, hc, lc, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            run = ce
        return torch.cat([run(h[:, i:i + chunk], labels[:, i:i + chunk])
                          for i in range(0, s, chunk)], dim=1)
    return ce(h, labels)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *,
            seq_sharded: bool = True) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (+ ``cfg.moe_aux_coef`` x the MoE
    load-balance aux, summed over the layers; 0 for the other families),
    as the reference's.

    batch: tokens [B,S] and labels [B,S] integer tensors, an optional
    loss_mask [B,S] float32, for the vision frontend patches
    [B, vis_tokens, D] (their positions are masked out of the loss), and
    for the audio family frames [B, enc_seq, D] (the encoder's input).
    Returns (loss, {"loss", "ce", "moe_aux", "tokens"}), float32 scalar
    tensors. ``seq_sharded`` is the reference's sequence sharding, which
    has no effect on one device."""
    del seq_sharded
    check_family(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch.get("loss_mask")
    h = embed(tokens, params["embed"], cfg)
    if cfg.family == "audio":
        enc = encoder_forward(params, batch["frames"].to(h.dtype), cfg)
        h, aux, _ = encdec_decoder_forward(params, h, cfg, enc_out=enc)
    else:
        if cfg.frontend == "vision":
            vt = cfg.vis_tokens
            h = torch.cat([batch["patches"].to(h.dtype), h[:, vt:]], dim=1)
            pmask = (torch.arange(h.shape[1], device=h.device) >= vt) \
                .float()[None]
            mask = pmask if mask is None else mask * pmask
        h, aux, _ = decoder_forward(params, h, cfg)
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    nll = _token_nll(h, labels, params, cfg)
    if mask is None:
        ce_loss = nll.mean()
        denom = torch.tensor(float(nll.numel()), device=nll.device)
    else:
        denom = torch.clamp(mask.sum(), min=1.0)
        ce_loss = (nll * mask).sum() / denom
    loss = ce_loss + cfg.moe_aux_coef * aux
    return loss, {"loss": loss, "ce": ce_loss, "moe_aux": aux,
                  "tokens": denom}


def _cache_from_kv(k: torch.Tensor, v: torch.Tensor, w: int,
                   cfg: ModelConfig) -> AttnCache:
    """The decode cache from collected K/V [..., S, G, Dh].

    Linear caches (w >= s) are a pad with ``pos_buf = -1`` on the empty
    slots; rolling (sliding-window, w < s) caches scatter the last ``w``
    positions to slot ``pos % w``. An int8 cache (``cfg.kv_cache_dtype``)
    holds `quantize_kv` of the K/V and their [..., W, G] float32 scales,
    0 on the empty slots."""
    check_cache_layout(cfg)
    s = k.shape[-3]
    kvdt = _dtype(cfg.kv_cache_dtype)
    dev = k.device
    lead = tuple(k.shape[:-3])
    tail = tuple(k.shape[-2:])
    scales = None
    if cfg.kv_cache_dtype == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks, vs)

    def empty(shape, dtype):
        return torch.zeros(lead + (w,) + shape, dtype=dtype, device=dev)
    kc, vc = empty(tail, kvdt), empty(tail, kvdt)
    sc = [empty(tail[:1], torch.float32) for _ in range(2)] \
        if scales else None
    if w >= s:
        src, slots = slice(None), slice(0, s)
        pos = torch.full((w,), -1, dtype=torch.int32, device=dev)
        pos[:s] = torch.arange(s, dtype=torch.int32, device=dev)
    else:
        srcpos = torch.arange(s - w, s, device=dev)
        src, slots = slice(s - w, s), srcpos % w
        pos = torch.zeros((w,), dtype=torch.int32, device=dev)
        pos[slots] = srcpos.to(torch.int32)
    kc[..., slots, :, :] = k[..., src, :, :].to(kvdt)
    vc[..., slots, :, :] = v[..., src, :, :].to(kvdt)
    if scales:
        for buf, x in zip(sc, scales):
            buf[..., slots, :] = x[..., src, :]
    return AttnCache(kc, vc, pos.expand(lead + (w,)).contiguous(),
                     *(sc or ()))


def prefill(params: dict, batch: dict, cfg: ModelConfig, *,
            max_seq: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward returning (last-position logits [B,V],
    caches). ``batch["tokens"]``: [B,S] integer tensor (and
    ``batch["patches"]`` [B, vis_tokens, D] for the vision frontend,
    ``batch["frames"]`` [B, enc_seq, D] for the audio family, whose caches
    are {"self": AttnCache, "cross_k", "cross_v"}: the decoder's
    self-attention cache, linear over ``max_seq``, and every layer's
    cross K/V [L, B, enc_seq, G, Dh] in the activation dtype).
    ``max_seq`` sets the decode cache capacity (default: the prompt
    length; pass prompt + generation budget for serving)."""
    check_family(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    max_seq = max_seq or s
    h = embed(tokens, params["embed"], cfg)
    if cfg.family == "audio":
        cdt = _dtype(cfg.dtype)
        enc = encoder_forward(params, batch["frames"].to(h.dtype), cfg)
        h, _, col = encdec_decoder_forward(params, h, cfg, enc_out=enc,
                                           collect=True)
        caches = {"self": _cache_from_kv(*col["self"], max_seq, cfg),
                  "cross_k": col["cross_k"].to(cdt),
                  "cross_v": col["cross_v"].to(cdt)}
    else:
        if cfg.frontend == "vision":
            vt = cfg.vis_tokens
            h = torch.cat([batch["patches"].to(h.dtype), h[:, vt:]], dim=1)
        h, _, col = decoder_forward(params, h, cfg, collect=True)
        caches = {}
        if "ssm" in col:
            caches["ssm"] = col["ssm"]
        if "attn" in col:
            # the hybrid family's shared-attention caches are linear over
            # max_seq whatever cfg.swa_window says, as in the reference
            w = max_seq if cfg.family == "hybrid" \
                else min(cfg.swa_window or max_seq, max_seq)
            k, v = col["attn"]
            caches["attn"] = _cache_from_kv(k, v, w, cfg)
    h_last = rms_norm(h[:, -1:], params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(h_last, params["embed"], cfg)[:, 0]
    return logits, caches


def decode_step(params: dict, tokens: torch.Tensor, caches: dict,
                positions: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """One decoding step. tokens: [B,1]; positions: [B] absolute position
    of the new token. Returns (logits [B,V], caches), the caches updated
    in place."""
    h = embed(tokens, params["embed"], cfg)
    forward = encdec_decoder_forward if cfg.family == "audio" \
        else decoder_forward
    h, _, caches = forward(params, h, cfg, caches=caches,
                           positions=positions)
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(h, params["embed"], cfg)[:, 0]
    return logits, caches


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device: DeviceLike = None) -> dict:
    """The empty decode cache: {"attn": AttnCache} with [L, B, W, G, Dh]
    k/v (zeros; int8 with [L, B, W, G] float32 scales for an int8 cache)
    and [L, B, W] pos_buf (-1); for the ssm family {"ssm": SSMCache} with
    [L, B, K-1, conv_dim] conv inputs and [L, B, H, P, N] float32 states
    (zeros; ``max_seq`` does not size them); for the hybrid family both,
    the SSM cache over the L layers and the K/V cache over the
    n_layers // hybrid_attn_every applications of the shared block,
    linear over ``max_seq``; for the audio family {"self": AttnCache,
    "cross_k", "cross_v"}, the cross K/V [L, B, enc_seq, G, Dh] zeros in
    the activation dtype."""
    check_family(cfg)
    dev = resolve_device(device)

    def stack(layer, n):
        return type(layer)(
            *(None if x is None else
              x.unsqueeze(0).repeat((n,) + (1,) * x.ndim) for x in layer))
    if cfg.family == "ssm":
        return {"ssm": stack(init_ssm_cache(cfg, batch, dev), cfg.n_layers)}
    if cfg.family == "hybrid":
        return {"ssm": stack(init_ssm_cache(cfg, batch, dev), cfg.n_layers),
                "attn": stack(init_attn_cache(cfg, batch, max_seq, dev,
                                              window=max_seq),
                              cfg.n_layers // cfg.hybrid_attn_every)}
    attn = stack(init_attn_cache(cfg, batch, max_seq, dev), cfg.n_layers)
    if cfg.family == "audio":
        cross = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"self": attn,
                **{name: torch.zeros(cross, dtype=_dtype(cfg.dtype),
                                     device=dev)
                   for name in ("cross_k", "cross_v")}}
    return {"attn": attn}
