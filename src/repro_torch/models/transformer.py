"""Model assembly for every family: dense (and the dense backbone of
vlm), moe (mixtral, grok-1: attention + the top-k expert FFN), ssm
(Mamba2), hybrid (zamba2: Mamba2 blocks with one weight-shared attention
+ MLP block after every ``hybrid_attn_every`` of them) and audio
(whisper: a bidirectional rope-free encoder over frame embeddings, and a
causal decoder with cross-attention to its output).

Mirrors `repro.models.transformer`: parameters are nested dicts whose
per-layer leaves are stacked on a leading layer axis ([L, ...]), as the
reference stacks them for its scan over layers; the port loops over the
layers in Python over views of the stacked tensors (`unstack`). The
decode caches are stacked the same way ([L, B, W, G, Dh] K/V, [L, B, ...]
SSM conv and state); the hybrid family's K/V cache is stacked over the
shared block's applications instead ([n_apps, B, W, G, Dh]), one cache
each; the audio family's self-attention cache is an [L, ...] `AttnCache`
beside the [L, B, enc_seq, G, Dh] cross K/V.

The MoE FFN runs the reference's single-device branch
(`moe.moe_ffn_local`); its expert-parallel branch over the mesh comes with
the mesh slice (queue 1 item 9).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (AttnCache, _prefill_positions,
                                          _proj, attention_layer,
                                          decode_valid, init_attention)
from repro_torch.models.layers import (_dtype, init_embeddings, init_mlp,
                                       init_rms_norm, mlp, rms_norm,
                                       rope_cos_sin)
from repro_torch.models.ssm import (SSMCache, init_ssm, ssm_block,
                                    ssm_prefill_with_cache)

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the reference does not have."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def _init_stacked(n: int, init) -> dict:
    """``n`` layers' parameters as one dict of [n, ...] tensors, drawn by
    ``init()`` one layer at a time and copied into the stacked tensors as
    it is drawn: memory holds the stack and one layer, not every layer
    twice (mixtral's 8-layer cut is 40.9 GB)."""
    def empty(x):
        if isinstance(x, dict):
            return {k: empty(v) for k, v in x.items()}
        return x.new_empty((n,) + tuple(x.shape))

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v
    out = None
    for i in range(n):
        layer = init()
        if out is None:
            out = empty(layer)
        put(out, layer, i)
        del layer
    return out


def _init_dense_block(gen: torch.Generator, cfg: ModelConfig,
                      dev: torch.device) -> dict:
    return {"ln1": init_rms_norm(cfg.d_model, dev),
            "attn": init_attention(gen, cfg, dev),
            "ln2": init_rms_norm(cfg.d_model, dev),
            "ffn": init_mlp(gen, cfg, dev)}


def _init_moe_block(gen: torch.Generator, cfg: ModelConfig,
                    dev: torch.device) -> dict:
    return {"ln1": init_rms_norm(cfg.d_model, dev),
            "attn": init_attention(gen, cfg, dev),
            "ln2": init_rms_norm(cfg.d_model, dev),
            "ffn": moe_lib.init_moe(gen, cfg, dev)}


def _init_ssm_block(gen: torch.Generator, cfg: ModelConfig,
                    dev: torch.device) -> dict:
    return {"ln": init_rms_norm(cfg.d_model, dev),
            "ssm": init_ssm(gen, cfg, dev)}


def _init_encdec_dec_block(gen: torch.Generator, cfg: ModelConfig,
                           dev: torch.device) -> dict:
    return {"ln1": init_rms_norm(cfg.d_model, dev),
            "self_attn": init_attention(gen, cfg, dev),
            "ln2": init_rms_norm(cfg.d_model, dev),
            "cross_attn": init_attention(gen, cfg, dev, cross=True),
            "ln3": init_rms_norm(cfg.d_model, dev),
            "ffn": init_mlp(gen, cfg, dev, gated=False)}


def _init_enc_block(gen: torch.Generator, cfg: ModelConfig,
                    dev: torch.device) -> dict:
    return {"ln1": init_rms_norm(cfg.d_model, dev),
            "attn": init_attention(gen, cfg, dev,
                                   n_layers_scale=cfg.enc_layers),
            "ln2": init_rms_norm(cfg.d_model, dev),
            "ffn": init_mlp(gen, cfg, dev, gated=False)}


_BLOCK_INIT = {"dense": _init_dense_block, "vlm": _init_dense_block,
               "moe": _init_moe_block, "ssm": _init_ssm_block,
               "hybrid": _init_ssm_block, "audio": _init_encdec_dec_block}


def init_model_params(gen: torch.Generator, cfg: ModelConfig,
                      device: Optional[torch.device] = None) -> dict:
    """Random parameters drawn from ``gen`` on its device, each leaf moved
    to ``device`` (default: the generator's) as soon as it is drawn."""
    check_family(cfg)
    dev = device or gen.device
    block_init = _BLOCK_INIT[cfg.family]
    params = {"embed": init_embeddings(gen, cfg, dev),
              "blocks": _init_stacked(cfg.n_layers,
                                      lambda: block_init(gen, cfg, dev)),
              "final_norm": init_rms_norm(cfg.d_model, dev)}
    if cfg.family == "hybrid":
        # the one attention + MLP block that every application shares
        params["shared"] = _init_dense_block(gen, cfg, dev)
    if cfg.is_encdec:
        params["enc_blocks"] = _init_stacked(
            cfg.enc_layers, lambda: _init_enc_block(gen, cfg, dev))
        params["enc_norm"] = init_rms_norm(cfg.d_model, dev)
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


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux scalar): the reference's
    single-device branch (no mesh), token-local dispatch over all B x S
    tokens."""
    b, s, d = x.shape
    out, aux = moe_lib.moe_ffn_local(x.reshape(-1, d), p, cfg)
    return out.reshape(b, s, d), aux


def _attn_ffn_block(h, bp, cfg: ModelConfig, *, cache, positions,
                    return_kv=False, rope=None, valid=None):
    """One pre-norm attention + FFN block (SwiGLU, or the MoE FFN where
    ``cfg.n_experts``); returns (h, aux, cache or the collected K/V). The
    dense FFN adds a zero auxiliary loss."""
    resid = h
    x = rms_norm(h, bp["ln1"]["scale"], cfg.norm_eps)
    attn_out, new_cache = attention_layer(x, bp["attn"], cfg, cache=cache,
                                          positions=positions,
                                          return_kv=return_kv, rope=rope,
                                          valid=valid)
    h = resid + attn_out
    resid = h
    x = rms_norm(h, bp["ln2"]["scale"], cfg.norm_eps)
    if cfg.n_experts:
        ffn_out, aux = moe_ffn(x, bp["ffn"], cfg)
    else:
        ffn_out = mlp(x, bp["ffn"], cfg)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return resid + ffn_out, aux, new_cache


def decoder_forward(params: dict, h: torch.Tensor, cfg: ModelConfig, *,
                    caches: Optional[dict] = None,
                    positions: Optional[torch.Tensor] = None,
                    collect: bool = False):
    """Run the decoder blocks. h: [B, S, D] embedded input.

    ``caches`` ({"attn": AttnCache}, {"ssm": SSMCache} or, for the hybrid
    family, both) selects decode: each layer writes its new k/v (or conv
    and state) into its slice of the cache in place. Returns (h, aux,
    new_caches), aux the MoE load-balance loss summed over the layers (0
    for the other families); ``collect=True`` (prefill) returns the
    per-layer K/V after rope, stacked to [L, B, S, G, Dh], as
    ``{"attn": (k, v)}``, the SSM decode cache as ``{"ssm": SSMCache}`` of
    [L, B, ...] leaves, or both (the hybrid family's K/V stacked over its
    applications).
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
                    h, _ = _attn_app(h, params["shared"], cfg, caches, g,
                                     positions, collect, rope, valid, ks, vs)
        else:
            for i in range(cfg.n_layers):
                h, a = _attn_app(h, layers[i], cfg, caches, i, positions,
                                 collect, rope, valid, ks, vs)
                aux = aux + a
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


def _layer_cache(c: AttnCache, i: int) -> AttnCache:
    """Slice ``i`` of a stacked cache (views: decode writes through)."""
    return AttnCache(*(None if x is None else x[i] for x in c))


def _attn_app(h, bp, cfg: ModelConfig, caches, i: int, positions,
              collect: bool, rope, valid, ks: list, vs: list):
    """One attention + FFN block against slice ``i`` of the stacked K/V
    cache (decode), collecting its K/V (prefill), or under ``cfg.remat``
    (a training forward: neither); returns (h, the block's aux)."""
    if caches is None and not collect:
        return _remat(lambda h, bp: _attn_ffn_block(
            h, bp, cfg, cache=None, positions=positions, rope=rope)[:2],
            cfg)(h, bp)
    cache = None if caches is None else _layer_cache(caches["attn"], i)
    h, aux, kv = _attn_ffn_block(h, bp, cfg, cache=cache,
                                 positions=positions, return_kv=collect,
                                 rope=rope, valid=valid)
    if collect:
        ks.append(kv[0])
        vs.append(kv[1])
    return h, aux


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



# ---------------------------------------------------------------------------
# encoder (whisper) and enc-dec forward
# ---------------------------------------------------------------------------

def _enc_block(h, bp, cfg: ModelConfig):
    """One encoder block: bidirectional rope-free attention (the flash
    kernel with ``causal=False``) and the plain gelu MLP, pre-norm."""
    x = rms_norm(h, bp["ln1"]["scale"], cfg.norm_eps)
    h = h + attention_layer(x, bp["attn"], cfg, causal=False,
                            use_rope=False)[0]
    x = rms_norm(h, bp["ln2"]["scale"], cfg.norm_eps)
    return h + mlp(x, bp["ffn"], cfg, act="gelu")


def encoder_forward(params: dict, h: torch.Tensor, cfg: ModelConfig, *,
                    seq_sharded: bool = False) -> torch.Tensor:
    """The encoder over frame embeddings h [B, enc_seq, D] (each block
    under ``cfg.remat`` in a training forward), final-normed.
    ``seq_sharded`` is the reference's sharding and has no effect on one
    device."""
    del seq_sharded
    for bp in unstack(params["enc_blocks"], cfg.enc_layers):
        h = _remat(lambda h, bp: _enc_block(h, bp, cfg), cfg)(h, bp)
    return rms_norm(h, params["enc_norm"]["scale"], cfg.norm_eps)


def _encdec_block(h, bp, cfg: ModelConfig, *, enc_out=None, cache=None,
                  cross_kv=None, positions=None, return_kv=False,
                  rope=None, valid=None, cross_valid=None):
    """One decoder block: causal self-attention with rope (decode: against
    ``cache``), cross-attention to the encoder (K/V from ``cross_kv``, or
    projected from ``enc_out`` without bias), the plain gelu MLP, each
    pre-norm. Returns (h, self cache or collected K/V, cross k, cross v)."""
    cdt = _dtype(cfg.dtype)
    x = rms_norm(h, bp["ln1"]["scale"], cfg.norm_eps)
    a_out, new_self = attention_layer(
        x, bp["self_attn"], cfg, causal=True, cache=cache,
        positions=positions, return_kv=return_kv, rope=rope, valid=valid)
    h = h + a_out
    x = rms_norm(h, bp["ln2"]["scale"], cfg.norm_eps)
    if cross_kv is None:
        cross_kv = (_proj(enc_out, bp["cross_attn"]["wk"], cdt),
                    _proj(enc_out, bp["cross_attn"]["wv"], cdt))
    h = h + attention_layer(x, bp["cross_attn"], cfg, cross_kv=cross_kv,
                            valid=cross_valid)[0]
    x = rms_norm(h, bp["ln3"]["scale"], cfg.norm_eps)
    h = h + mlp(x, bp["ffn"], cfg, act="gelu")
    return h, new_self, cross_kv[0], cross_kv[1]


def encdec_decoder_forward(params: dict, h: torch.Tensor,
                           cfg: ModelConfig, *,
                           enc_out: Optional[torch.Tensor] = None,
                           caches: Optional[dict] = None,
                           positions: Optional[torch.Tensor] = None,
                           seq_sharded: bool = True,
                           collect: bool = False):
    """Whisper decoder. Training (each block under ``cfg.remat``) and
    prefill: cross-attention K/V projected per block from ``enc_out``.
    Decode (``caches`` = {"self": AttnCache, "cross_k", "cross_v"}): the
    cross K/V come from the caches, and each layer writes its new self k/v
    into its slice of the self cache in place. ``collect=True`` (prefill):
    also return the per-layer self K/V (after rope) and cross K/V,
    stacked, as {"self": (k, v), "cross_k", "cross_v"}. Returns (h, aux
    (0), new_caches). ``seq_sharded`` has no effect on one device."""
    del seq_sharded
    decode = caches is not None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    layers = unstack(params["blocks"], cfg.n_layers)
    pos = positions[:, None] if decode else _prefill_positions(h, positions)
    rope = rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
    if not decode and not collect:
        for bp in layers:
            h = _remat(lambda h, bp, enc: _encdec_block(
                h, bp, cfg, enc_out=enc, positions=positions,
                rope=rope)[0], cfg)(h, bp, enc_out)
        return h, aux, None
    valid = cross_valid = None
    if decode:
        valid = _write_positions(caches["self"], positions, cfg)
        cross_valid = torch.ones(caches["cross_k"].shape[1:3],
                                 dtype=torch.int8, device=h.device)
    ks, vs, cks, cvs = [], [], [], []
    for i, bp in enumerate(layers):
        h, kv, ck, cv = _encdec_block(
            h, bp, cfg, enc_out=enc_out,
            cache=_layer_cache(caches["self"], i) if decode else None,
            cross_kv=(caches["cross_k"][i], caches["cross_v"][i])
            if decode else None,
            positions=positions, return_kv=collect, rope=rope, valid=valid,
            cross_valid=cross_valid)
        if collect:
            ks.append(kv[0])
            vs.append(kv[1])
            cks.append(ck)
            cvs.append(cv)
    if decode:
        return h, aux, caches
    return h, aux, {"self": (torch.stack(ks), torch.stack(vs)),
                    "cross_k": torch.stack(cks),
                    "cross_v": torch.stack(cvs)}
