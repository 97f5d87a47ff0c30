"""Model assembly for the dense family (and the dense backbone of vlm),
the ssm family (Mamba2) and the hybrid family (zamba2: Mamba2 blocks with
one weight-shared attention + MLP block after every
``hybrid_attn_every`` of them).

Mirrors `repro.models.transformer`: parameters are nested dicts whose
per-layer leaves are stacked on a leading layer axis ([L, ...]), as the
reference stacks them for its scan over layers; the port loops over the
layers in Python over views of the stacked tensors (`unstack`). The
decode caches are stacked the same way ([L, B, W, G, Dh] K/V, [L, B, ...]
SSM conv and state); the hybrid family's K/V cache is stacked over the
shared block's applications instead ([n_apps, B, W, G, Dh]), one cache
each.

The other families raise `NotImplementedError` naming the slice that
ports them: ``moe`` and ``audio`` come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (AttnCache, _prefill_positions,
                                          attention_layer, decode_valid,
                                          init_attention)
from repro_torch.models.layers import (init_embeddings, init_mlp,
                                       init_rms_norm, mlp, rms_norm,
                                       rope_cos_sin)
from repro_torch.models.ssm import (SSMCache, init_ssm, ssm_block,
                                    ssm_prefill_with_cache)

FAMILY_SLICES = {
    "moe": "a later slice (the expert-parallel MoE FFN)",
    "audio": "a later slice (whisper's encoder-decoder)",
}


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family this slice does not port."""
    if cfg.family in FAMILY_SLICES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: it comes "
            f"with {FAMILY_SLICES[cfg.family]}")
    if cfg.family not in ("dense", "vlm", "ssm", "hybrid"):
        raise ValueError(f"unknown family {cfg.family!r}")


def _stack(trees: list) -> dict:
    """Per-layer parameter dicts -> one dict of [L, ...] tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _init_dense_block(gen: torch.Generator, cfg: ModelConfig,
                      dev: torch.device) -> dict:
    return {"ln1": init_rms_norm(cfg.d_model, dev),
            "attn": init_attention(gen, cfg, dev),
            "ln2": init_rms_norm(cfg.d_model, dev),
            "ffn": init_mlp(gen, cfg, dev)}


def _init_ssm_block(gen: torch.Generator, cfg: ModelConfig,
                    dev: torch.device) -> dict:
    return {"ln": init_rms_norm(cfg.d_model, dev),
            "ssm": init_ssm(gen, cfg, dev)}


_BLOCK_INIT = {"dense": _init_dense_block, "vlm": _init_dense_block,
               "ssm": _init_ssm_block, "hybrid": _init_ssm_block}


def init_model_params(gen: torch.Generator, cfg: ModelConfig,
                      device: Optional[torch.device] = None) -> dict:
    """Random parameters drawn from ``gen`` on its device, each leaf moved
    to ``device`` (default: the generator's) as soon as it is drawn."""
    check_family(cfg)
    dev = device or gen.device
    block_init = _BLOCK_INIT[cfg.family]
    params = {"embed": init_embeddings(gen, cfg, dev),
              "blocks": _stack([block_init(gen, cfg, dev)
                                for _ in range(cfg.n_layers)]),
              "final_norm": init_rms_norm(cfg.d_model, dev)}
    if cfg.family == "hybrid":
        # the one attention + MLP block that every application shares
        params["shared"] = _init_dense_block(gen, cfg, dev)
    return params


def unstack(blocks: dict, n: int) -> list:
    """Every layer's parameters at once: views from one `torch.unbind` of
    each stacked leaf. Its backward stacks the layers' gradients in one
    operation, where indexing layer by layer would add a zero-padded
    [L, ...] gradient per layer."""
    flat = {k: unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in blocks.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def _dots_policy(ctx, func, *args, **kwargs):
    """``remat="dots"``: keep the outputs of matrix products, recompute
    the rest (the reference's ``checkpoint_dots``)."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if func in (aten.mm.default, aten.bmm.default, aten.addmm.default,
                aten.baddbmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat`` (the reference's ``_remat``): "full"
    saves only its inputs and recomputes it in the backward, "dots" saves
    the outputs of its matrix products as well, "none" saves everything.
    Remat changes memory, never a value. It applies only where autograd
    records (grad mode on), so serving and ``no_grad`` never enter it."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    from torch.utils.checkpoint import checkpoint
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = _dots_context
    elif cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r}")
    return lambda *args: checkpoint(fn, *args, **kw)


def _attn_ffn_block(h, bp, cfg: ModelConfig, *, cache, positions,
                    return_kv=False, rope=None, valid=None):
    """One pre-norm attention + SwiGLU block; returns (h, cache or the
    collected K/V). The dense block adds no auxiliary loss."""
    resid = h
    x = rms_norm(h, bp["ln1"]["scale"], cfg.norm_eps)
    attn_out, new_cache = attention_layer(x, bp["attn"], cfg, cache=cache,
                                          positions=positions,
                                          return_kv=return_kv, rope=rope,
                                          valid=valid)
    h = resid + attn_out
    resid = h
    x = rms_norm(h, bp["ln2"]["scale"], cfg.norm_eps)
    h = resid + mlp(x, bp["ffn"], cfg)
    return h, new_cache


def decoder_forward(params: dict, h: torch.Tensor, cfg: ModelConfig, *,
                    caches: Optional[dict] = None,
                    positions: Optional[torch.Tensor] = None,
                    collect: bool = False):
    """Run the decoder blocks. h: [B, S, D] embedded input.

    ``caches`` ({"attn": AttnCache}, {"ssm": SSMCache} or, for the hybrid
    family, both) selects decode: each layer writes its new k/v (or conv
    and state) into its slice of the cache in place. Returns (h, aux,
    new_caches); ``collect=True`` (prefill) returns the per-layer K/V after
    rope, stacked to [L, B, S, G, Dh], as ``{"attn": (k, v)}``, the SSM
    decode cache as ``{"ssm": SSMCache}`` of [L, B, ...] leaves, or both
    (the hybrid family's K/V stacked over its applications).
    """
    check_family(cfg)
    decode = caches is not None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    convs, states, ks, vs = [], [], [], []
    layers = unstack(params["blocks"], cfg.n_layers)
    if cfg.family == "ssm":
        h = _ssm_layers(layers, h, cfg, range(cfg.n_layers), caches,
                        collect, convs, states)
    else:
        # the rotary angles of these positions, shared by every layer
        pos = positions[:, None] if decode \
            else _prefill_positions(h, positions)
        rope = rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
        valid = _write_positions(caches["attn"], positions, cfg) \
            if decode else None
        if cfg.family == "hybrid":
            # groups of `every` Mamba2 layers, each followed by the shared
            # attention + MLP block against its own application's K/V
            # cache; the layers past the last whole group run with no
            # attention after them, as in the reference
            every = cfg.hybrid_attn_every
            n_apps = cfg.n_layers // every
            for g in range(n_apps + 1):
                h = _ssm_layers(layers, h, cfg,
                                range(g * every,
                                      min((g + 1) * every, cfg.n_layers)),
                                caches, collect, convs, states)
                if g < n_apps:
                    h = _attn_app(h, params["shared"], cfg, caches, g,
                                  positions, collect, rope, valid, ks, vs)
        else:
            for i in range(cfg.n_layers):
                h = _attn_app(h, layers[i], cfg, caches, i, positions,
                              collect, rope, valid, ks, vs)
    if decode:
        return h, aux, caches
    if not collect:
        return h, aux, None
    out = {}
    if convs:
        out["ssm"] = SSMCache(torch.stack(convs), torch.stack(states))
    if ks:
        out["attn"] = (torch.stack(ks), torch.stack(vs))
    return h, aux, out


def _write_positions(cache: AttnCache, positions: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Write each row's new position into every stacked cache's pos_buf
    ([L, B, W]: every layer's, or every application's, cache holds the
    same positions) at once and derive the slot validity once, rather than
    in each attention layer as the reference does; returns the [B, W]
    int8 validity."""
    pb = cache.pos_buf
    rows = torch.arange(pb.shape[1], device=pb.device)
    pb[:, rows, positions.long() % pb.shape[-1]] = positions.to(pb.dtype)
    return decode_valid(pb[0], positions, cfg.swa_window)


def _attn_app(h, bp, cfg: ModelConfig, caches, i: int, positions,
              collect: bool, rope, valid, ks: list, vs: list):
    """One attention + MLP block against slice ``i`` of the stacked K/V
    cache (decode), collecting its K/V (prefill), or under ``cfg.remat``
    (a training forward: neither)."""
    if caches is None and not collect:
        return _remat(lambda h, bp: _attn_ffn_block(
            h, bp, cfg, cache=None, positions=positions, rope=rope)[0],
            cfg)(h, bp)
    cache = None
    if caches is not None:
        c = caches["attn"]
        cache = AttnCache(c.k[i], c.v[i], c.pos_buf[i])
    h, kv = _attn_ffn_block(h, bp, cfg, cache=cache, positions=positions,
                            return_kv=collect, rope=rope, valid=valid)
    if collect:
        ks.append(kv[0])
        vs.append(kv[1])
    return h


def _ssm_block_residual(h, bp, cfg: ModelConfig):
    x = rms_norm(h, bp["ln"]["scale"], cfg.norm_eps)
    return h + ssm_block(x, bp["ssm"], cfg)[0]


def _ssm_layers(layers: list, h: torch.Tensor, cfg: ModelConfig,
                which, caches: Optional[dict], collect: bool,
                convs: list, states: list) -> torch.Tensor:
    """Mamba2 blocks ``which`` of ``layers`` (each layer's parameters;
    pre-norm, with a residual): decode writes each layer's new conv and
    state into the pool in place; prefill (``collect``) appends each
    layer's `ssm_prefill_with_cache` cache to ``convs`` and ``states``; a
    training forward (neither) runs each block under ``cfg.remat``."""
    for i in which:
        bp = layers[i]
        if caches is None and not collect:
            h = _remat(lambda h, bp: _ssm_block_residual(h, bp, cfg),
                       cfg)(h, bp)
            continue
        x = rms_norm(h, bp["ln"]["scale"], cfg.norm_eps)
        if caches is not None:
            pool = caches["ssm"]
            out, new = ssm_block(x, bp["ssm"], cfg,
                                 cache=SSMCache(pool.conv[i], pool.state[i]))
            pool.conv[i].copy_(new.conv)
            pool.state[i].copy_(new.state)
        elif collect:
            out, new = ssm_prefill_with_cache(x, bp["ssm"], cfg)
            convs.append(new.conv)
            states.append(new.state)
        h = h + out
    return h

