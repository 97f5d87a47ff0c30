"""Public model API of the serving path (mirrors `repro.models.model`).

  init_params        random parameters from a `torch.Generator`
  init_params_sharded  the same parameters placed on a mesh, each rank
                     drawing them and keeping only its own shards
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
KV cache.

``cache_specs`` and ``param_specs`` give every cache and parameter leaf
its logical axes, the reference's; `repro_torch.parallel.axes` maps them
onto a mesh. Under a live mesh (``use_sharding``) the same entry points
take and return DTensors, placed at the reference's constrain points.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (AttnCache, _repeat_heads,
                                          init_attn_cache, quantize_kv)
from repro_torch.models.layers import _dtype, embed, rms_norm, unembed
from repro_torch.models.ssm import SSMCache, init_ssm_cache
from repro_torch.models.transformer import (check_family, decoder_forward,
                                            encdec_decoder_forward,
                                            encoder_forward,
                                            init_model_params)
from repro_torch.parallel.axes import (_reduce, constrain, from_local,
                                       is_dtensor, local, redistribute,
                                       replicated)


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


def init_params_sharded(key: Union[int, torch.Generator], cfg: ModelConfig,
                        mesh, rules, *, device: DeviceLike = None) -> dict:
    """``init_params(key, cfg)`` placed on ``mesh`` as
    ``runtime.elastic.reshard_tree(params, mesh, param_specs(params),
    rules)`` places it, with no rank ever holding the whole model: the
    same draws in the same order, and each rank keeps only its own shard
    of a layer's leaves before the next layer is drawn, and copies only
    that to ``device`` (default: the generator's device for a generator,
    else cuda). A rank holds its shards and one layer's draw (on the
    generator's device). Every rank of ``mesh`` calls it with the same
    ``key``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.parallel.axes import (_is_shard, sanitized_spec,
                                           spec_placements)

    if mesh.get_coordinate() is None:
        raise ValueError("init_params_sharded: this rank is not in the mesh")
    if isinstance(key, torch.Generator):
        gen, dev = key, torch.device(device) if device else key.device
    else:
        gen = torch.Generator().manual_seed(int(key))
        dev = resolve_device(device)

    def placements(name, shape):
        axes = _leaf_axes(name, len(shape))
        return spec_placements(sanitized_spec(shape, axes, rules, mesh),
                               mesh)

    def keep(name, leaf, n):
        stacked = (n,) if n else ()
        part = leaf
        for i, p in enumerate(placements(name, stacked + tuple(leaf.shape))):
            if _is_shard(p):
                if p.dim < len(stacked):
                    raise ValueError(f"{name}: a layer axis sharded over "
                                     f"the mesh")
                part = part.chunk(mesh.size(i), dim=p.dim - len(stacked))[
                    mesh.get_local_rank(i)]
        return part.contiguous().to(dev)
    with FakeTensorMode():            # the global shapes, nothing drawn
        shapes = init_model_params(torch.Generator().manual_seed(0), cfg)
    shards = init_model_params(gen, cfg, None, keep)

    def placed(tree, like):
        return {k: placed(v, like[k]) if isinstance(v, dict) else
                from_local(v, mesh, placements(k, tuple(like[k].shape)),
                           tuple(like[k].shape))
                for k, v in tree.items()}
    return placed(shards, shapes)


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
        if is_dtensor(logits):
            return _vocab_parallel_nll(logits, lc)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
        return lse - gold                                   # [B, s]

    h = constrain(h, "batch", None, None)
    labels = constrain(labels, "batch", None)

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


def _vocab_parallel_nll(logits, labels):
    """lse - gold of DTensor logits [B, s, V] split over the vocabulary
    (and possibly the batch): each rank's max, sum of exponentials and
    gold logit over its vocabulary slice, summed across the slices (the
    max reduced without a gradient, as a stabiliser). Returns [B, s]."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    lg, lab = local(logits), local(redistribute(
        replicated(labels), [p if isinstance(p, Shard) and p.dim == 0
                             else Replicate() for p in logits.placements]))
    v0 = sum(mesh.get_local_rank(i) * lg.shape[-1]
             for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == vdim)
    split = [i for i, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == vdim]
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in logits.placements]
    part = [Partial() if i in split else p for i, p in enumerate(rows)]
    shape = tuple(logits.shape[:-1])

    def total(x, op=None):
        if op is not None:                      # max: no gradient
            x = x.detach()
            for i in split:
                x = _reduce(x, mesh.get_group(i), op)
            return x
        return local(redistribute(from_local(x, mesh, part, shape), rows))
    m = total(lg.amax(dim=-1), torch.distributed.ReduceOp.MAX)
    se = total(torch.exp(lg - m[..., None]).sum(dim=-1))
    idx = lab.long() - v0
    hit = (idx >= 0) & (idx < lg.shape[-1])
    gold = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])
    gold = total((gold[..., 0] * hit))
    return from_local(m + torch.log(se) - gold, mesh, rows, shape)


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
    tensors. ``seq_sharded``: under a mesh, the hidden state between
    blocks is split over the sequence (the reference's sequence
    parallelism); no effect on one device."""
    check_family(cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch.get("loss_mask")
    seq = "seq" if seq_sharded else None
    h = embed(tokens, params["embed"], cfg)
    if cfg.family == "audio":
        enc = encoder_forward(params, batch["frames"].to(h.dtype), cfg)
        h = constrain(h, "batch", seq, None)
        h, aux, _ = encdec_decoder_forward(params, h, cfg, enc_out=enc,
                                           seq_sharded=seq_sharded)
    else:
        if cfg.frontend == "vision":
            vt = cfg.vis_tokens
            h = _with_patches(batch["patches"], h, vt)
            pmask = (torch.arange(h.shape[1], device=h.device) >= vt) \
                .float()[None]
            mask = pmask if mask is None else mask * pmask
        h = constrain(h, "batch", seq, None)
        h, aux, _ = decoder_forward(params, h, cfg,
                                    seq_sharded=seq_sharded)
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    nll = _token_nll(h, labels, params, cfg)
    if mask is None:
        ce_loss = _total(nll) / nll.numel()
        denom = torch.tensor(float(nll.numel()), device=local(nll).device)
    else:
        mask = constrain(mask, "batch", None)
        denom = torch.clamp(_total(mask), min=1.0)
        ce_loss = _total(nll * mask) / denom
    loss = ce_loss + cfg.moe_aux_coef * aux
    return loss, {"loss": loss, "ce": ce_loss, "moe_aux": aux,
                  "tokens": denom}


def _with_patches(patches, h, vt: int):
    """The first ``vt`` positions of the embedded tokens h [B,S,D] taken
    by the vision frontend's patch embeddings (both placed on the batch
    first under a mesh)."""
    h = constrain(h, "batch", None, None)
    patches = constrain(patches, "batch", None, None).to(h.dtype)
    return torch.cat([patches, h[:, vt:]], dim=1)


def _total(x: torch.Tensor) -> torch.Tensor:
    """Sum of every element (replicated under a mesh: the ranks' partial
    sums reduced by the port's transport)."""
    return constrain(x.sum())


def _cache_from_kv(k: torch.Tensor, v: torch.Tensor, w: int,
                   cfg: ModelConfig) -> AttnCache:
    """The decode cache from collected K/V [..., S, G, Dh].

    Linear caches (w >= s) are a pad with ``pos_buf = -1`` on the empty
    slots; rolling (sliding-window, w < s) caches scatter the last ``w``
    positions to slot ``pos % w``. An int8 cache (``cfg.kv_cache_dtype``)
    holds `quantize_kv` of the K/V and their [..., W, G] float32 scales,
    0 on the empty slots. The aligned cache (`cfg.cache_heads` > the K/V's
    heads) stores each KV head repeated, as the reference's.

    Under a live mesh the K/V are DTensors: each rank builds the cache of
    its rows and heads from every position (the positions gathered where
    they were split), and the cache is then placed on the reference's
    cache axes (`cache_specs`)."""
    if is_dtensor(k):
        return _cache_from_kv_mesh(k, v, w, cfg)
    if cfg.cache_heads != k.shape[-2]:
        k, v = (_repeat_heads(t, cfg.cache_heads // k.shape[-2])
                for t in (k, v))
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


def _cache_from_kv_mesh(k, v, w: int, cfg: ModelConfig) -> AttnCache:
    from torch.distributed.tensor import Replicate, Shard

    sdim = k.ndim - 3
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim >= sdim
               else p for p in k.placements)
    k, v = redistribute(k, pl), redistribute(v, pl)
    c = _cache_from_kv(local(k), local(v), w, cfg)
    lead = tuple(k.shape[:sdim])
    mesh = k.device_mesh

    def wrap(x, tail):
        return from_local(x, mesh, pl, lead + (w,) + tail)
    g, dh = cfg.cache_heads, k.shape[-1]
    c = AttnCache(wrap(c.k, (g, dh)), wrap(c.v, (g, dh)),
                  wrap(c.pos_buf, ()),
                  *(wrap(x, (g,)) for x in c[3:] if x is not None))
    axes = _ATTN_CACHE_AXES_Q if cfg.kv_cache_dtype == "int8" \
        else _ATTN_CACHE_AXES
    cut = len(axes.k) - k.ndim               # no layer axis: drop it
    return AttnCache(*(None if x is None else constrain(x, *ax[cut:])
                       for x, ax in zip(c, axes)))


def prefill(params: dict, batch: dict, cfg: ModelConfig, *,
            max_seq: Optional[int] = None,
            seq_sharded: bool = False) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward returning (last-position logits [B,V],
    caches). ``batch["tokens"]``: [B,S] integer tensor (and
    ``batch["patches"]`` [B, vis_tokens, D] for the vision frontend,
    ``batch["frames"]`` [B, enc_seq, D] for the audio family, whose caches
    are {"self": AttnCache, "cross_k", "cross_v"}: the decoder's
    self-attention cache, linear over ``max_seq``, and every layer's
    cross K/V [L, B, enc_seq, G, Dh] in the activation dtype).
    ``max_seq`` sets the decode cache capacity (default: the prompt
    length; pass prompt + generation budget for serving). ``seq_sharded``:
    under a mesh, the sequence is split over ``model`` between blocks."""
    check_family(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    max_seq = max_seq or s
    h = embed(tokens, params["embed"], cfg)
    if cfg.family == "audio":
        cdt = _dtype(cfg.dtype)
        enc = encoder_forward(params, batch["frames"].to(h.dtype), cfg)
        h = constrain(h, "batch", "seq", None)
        h, _, col = encdec_decoder_forward(params, h, cfg, enc_out=enc,
                                           collect=True,
                                           seq_sharded=seq_sharded)
        caches = {"self": _cache_from_kv(*col["self"], max_seq, cfg),
                  "cross_k": col["cross_k"].to(cdt),
                  "cross_v": col["cross_v"].to(cdt)}
    else:
        if cfg.frontend == "vision":
            vt = cfg.vis_tokens
            h = _with_patches(batch["patches"], h, vt)
        h = constrain(h, "batch", "seq", None)
        h, _, col = decoder_forward(params, h, cfg, collect=True,
                                    seq_sharded=seq_sharded)
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
    h = constrain(h, "batch", None, None)
    h_last = rms_norm(h[:, -1:], params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(h_last, params["embed"], cfg)[:, 0]
    return logits, caches


def decode_step(params: dict, tokens: torch.Tensor, caches: dict,
                positions: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """One decoding step. tokens: [B,1]; positions: [B] absolute position
    of the new token. Returns (logits [B,V], caches), the caches updated
    in place."""
    h = constrain(embed(tokens, params["embed"], cfg), "batch", None, None)
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


# ---------------------------------------------------------------------------
# cache and parameter sharding specs
# ---------------------------------------------------------------------------

_ATTN_CACHE_AXES = AttnCache(
    k=("layers", "batch", "cache_seq", "kv_heads", None),
    v=("layers", "batch", "cache_seq", "kv_heads", None),
    pos_buf=("layers", "batch", "cache_seq"),
)
_ATTN_CACHE_AXES_Q = _ATTN_CACHE_AXES._replace(
    k_scale=("layers", "batch", "cache_seq", "kv_heads"),
    v_scale=("layers", "batch", "cache_seq", "kv_heads"),
)
_SSM_CACHE_AXES = SSMCache(
    conv=("layers", "batch", None, "ffn"),
    state=("layers", "batch", "heads", None, None),
)


def cache_specs(cfg: ModelConfig) -> dict:
    """Logical sharding axes for every leaf of ``init_cache``'s tree."""
    fam = cfg.family
    attn_axes = (_ATTN_CACHE_AXES_Q if cfg.kv_cache_dtype == "int8"
                 else _ATTN_CACHE_AXES)
    if fam in ("dense", "vlm", "moe"):
        return {"attn": attn_axes}
    if fam == "ssm":
        return {"ssm": _SSM_CACHE_AXES}
    if fam == "hybrid":
        return {"ssm": _SSM_CACHE_AXES, "attn": attn_axes}
    if fam == "audio":
        cross = ("layers", "batch", None, "kv_heads", None)
        return {"self": attn_axes, "cross_k": cross, "cross_v": cross}
    raise ValueError(fam)


# Base logical axes per parameter name (without the stacked layer axis).
_PARAM_AXES = {
    "tok": ("vocab", "embed_p"),
    "unembed": ("embed_p", "vocab"),
    "wq": ("embed_p", "heads", None),
    "wk": ("embed_p", "kv_heads", None),
    "wv": ("embed_p", "kv_heads", None),
    "wo": ("heads", None, "embed_p"),
    "bq": ("heads", None),
    "bk": ("kv_heads", None),
    "bv": ("kv_heads", None),
    "w1": ("embed_p", "ffn"),
    "w3": ("embed_p", "ffn"),
    "w2": ("ffn", "embed_p"),
    "router": (None, None),
    "in_proj": ("embed_p", "ffn"),
    "conv_w": (None, "ffn"),
    "conv_b": ("ffn",),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "gated_norm": ("ffn",),
    "out_proj": ("ffn", "embed_p"),
    "scale": (None,),
}


def _leaf_axes(name: str, ndim: int) -> tuple:
    base = _PARAM_AXES[name]
    if ndim == len(base):
        return base
    if ndim == len(base) + 1:                  # stacked over layers
        return ("layers",) + base
    if ndim == len(base) + 2 and name in ("w1", "w2", "w3"):
        return ("layers", "experts") + base    # stacked MoE experts
    raise ValueError(f"param {name!r} with ndim {ndim}")


def param_specs(params: dict) -> dict:
    """Logical sharding axes for every parameter leaf, by the leaf's name
    (the same nesting as ``params``; a leaf may be a tensor or anything
    with ``.ndim``, a meta tensor of `input_specs` included)."""
    def f(tree):
        return {k: f(v) if isinstance(v, dict) else _leaf_axes(k, v.ndim)
                for k, v in tree.items()}
    return f(params)
