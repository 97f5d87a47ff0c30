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

Under a live mesh (`repro_torch.parallel.axes.use_sharding`) the hidden
state is a DTensor placed at the reference's constrain points (batch,
and the sequence between blocks under the training rules), and the MoE
FFN takes the reference's expert-parallel branches over ``model``: an
all-to-all dispatch for a prompt, the weights-stationary branch for one
token a row. With no mesh, or a ``model`` axis of 1, it runs the
single-device branch (`moe.moe_ffn_local`).
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
                                       init_rms_norm, matmul_f32, mlp,
                                       rms_norm, rope_cos_sin)
from repro_torch.models.ssm import (SSMCache, init_ssm, ssm_block,
                                    ssm_prefill_with_cache)
from repro_torch.parallel.axes import (all_gather_tiled, all_to_all,
                                       axis_index, axis_size, constrain,
                                       current_mesh, from_local, full_tensor,
                                       is_dtensor, like, local, psum,
                                       psum_local, redistribute, replicated,
                                       sanitized_spec, shard_offsets,
                                       spec_placements)
from repro_torch.parallel.axes import PartitionSpec as P

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def check_family(cfg: ModelConfig) -> None:
    """Raise for a family the reference does not have."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def _keep(tree: dict, keep, n: int) -> dict:
    """``keep(name, leaf, n)`` applied to every leaf of ``tree``."""
    return {k: _keep(v, keep, n) if isinstance(v, dict) else keep(k, v, n)
            for k, v in tree.items()}


def _init_stacked(n: int, init, keep=None) -> dict:
    """``n`` layers' parameters as one dict of [n, ...] tensors, drawn by
    ``init()`` one layer at a time and copied into the stacked tensors as
    it is drawn: memory holds the stack and one layer, not every layer
    twice (mixtral's 8-layer cut is 40.9 GB). With ``keep``, each layer's
    leaves pass through ``keep(name, leaf, n)`` before they are stacked
    (a rank's own shard, say)."""
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
        if keep is not None:
            layer = _keep(layer, keep, n)
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
                      device: Optional[torch.device] = None,
                      keep=None) -> dict:
    """Random parameters drawn from ``gen`` on its device, each leaf moved
    to ``device`` (default: the generator's) as soon as it is drawn. With
    ``keep``, every leaf passes through ``keep(name, leaf, n)`` as it is
    drawn (``n`` the layers of a stacked leaf, 0 for the others), before
    the next layer is drawn; the draws and their order do not change."""
    check_family(cfg)
    dev = device or gen.device
    block_init = _BLOCK_INIT[cfg.family]

    def kept(tree):
        return tree if keep is None else _keep(tree, keep, 0)
    params = {"embed": kept(init_embeddings(gen, cfg, dev)),
              "blocks": _init_stacked(cfg.n_layers,
                                      lambda: block_init(gen, cfg, dev),
                                      keep),
              "final_norm": kept(init_rms_norm(cfg.d_model, dev))}
    if cfg.family == "hybrid":
        # the one attention + MLP block that every application shares
        params["shared"] = kept(_init_dense_block(gen, cfg, dev))
    if cfg.is_encdec:
        params["enc_blocks"] = _init_stacked(
            cfg.enc_layers, lambda: _init_enc_block(gen, cfg, dev), keep)
        params["enc_norm"] = kept(init_rms_norm(cfg.d_model, dev))
    return params


def unstack(blocks: dict, n: int) -> list:
    """Every layer's parameters at once: views from one `torch.unbind` of
    each stacked leaf. Its backward stacks the layers' gradients in one
    operation, where indexing layer by layer would add a zero-padded
    [L, ...] gradient per layer."""
    flat = {k: unstack(v, n) if isinstance(v, dict) else
            [_select0(v, i) for i in range(n)] if is_dtensor(v) else
            torch.unbind(v) for k, v in blocks.items()}
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


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig,
            seq_sharded: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux scalar).

    No mesh, or a ``model`` axis of 1: the reference's single-device
    branch, token-local dispatch over all B x S tokens (under a mesh with
    ``model`` 1 the tokens and weights are gathered first, so the
    dispatch sees every token as the reference's does).

    Otherwise expert parallelism over ``model``, the reference's two
    branches on each rank's local tensors (its ``shard_map`` bodies):
    with TP >= E each expert lives on dup = TP / E ranks, each holding an
    F-slice of it; with E > TP each rank owns E / TP whole experts.
    A prompt (S > 1) is routed on the rank's own tokens and its expert
    buffers travel by one all-to-all out and one back, the dup F-slice
    partials summed at home; one token a row (S == 1) keeps the weights
    in their storage sharding and moves the tokens instead (all-gathered
    over the batch axes, contracted over the D shard (sum over ``data``)
    and the F shard (sum over ``model``))."""
    b, s, d = x.shape
    mesh = current_mesh()
    tp = axis_size("model")
    if mesh is None or tp == 1:
        if mesh is not None:
            xs = constrain(x, "batch", "seq" if seq_sharded else None, None)
            pf = {k: full_tensor(replicated(v)) for k, v in p.items()}
            out, aux = moe_lib.moe_ffn_local(
                full_tensor(xs).reshape(-1, d), pf, cfg)
            return (constrain(replicated(out.reshape(b, s, d)),
                              "batch", "seq" if seq_sharded else None, None),
                    replicated(aux))
        out, aux = moe_lib.moe_ffn_local(x.reshape(-1, d), p, cfg)
        return out.reshape(b, s, d), aux

    e, f = cfg.n_experts, cfg.d_ff
    if tp % e == 0:
        dup, e_loc = tp // e, 1
    elif e % tp == 0:
        dup, e_loc = 1, e // tp
    else:
        raise ValueError(f"EP needs tp % E == 0 or E % tp == 0; "
                         f"got E={e}, tp={tp}")
    f_loc = f // dup
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    router = full_tensor(constrain(p["router"], None, None))

    if s == 1:
        # ---- decode: weights-stationary TP-MoE -------------------------
        xd_spec = sanitized_spec(x.shape, ("batch", None, None))
        xs = redistribute(replicated(x), spec_placements(xd_spec, mesh))
        gather_axes = () if xd_spec[0] is None else (
            (xd_spec[0],) if isinstance(xd_spec[0], str)
            else tuple(xd_spec[0]))
        ws = {k: local(redistribute(replicated(p[k]), spec_placements(
            P(None, "data", "model") if k != "w2"
            else P(None, "model", "data"), mesh)))
            for k in ("w1", "w3", "w2")}
        y, aux = _moe_decode_local(local(xs), router, ws, cfg, shape,
                                   gather_axes)
        return like(y, xs, x.shape), replicated(aux)

    x_spec = sanitized_spec(x.shape, ("batch", "seq" if seq_sharded
                                      else None, None))
    xs = redistribute(replicated(x), spec_placements(x_spec, mesh))
    token_axes = tuple(a for part in x_spec if part
                       for a in ((part,) if isinstance(part, str) else part))
    ws = {k: _ep_weight(p[k], k, e, dup, f_loc, mesh)
          for k in ("w1", "w3", "w2")}
    y, aux = _moe_prefill_local(local(xs), router, ws, cfg, tp, e, dup,
                                e_loc, token_axes)
    return like(y, xs, x.shape), replicated(aux)


def _ep_weight(w, name: str, e: int, dup: int, f_loc: int, mesh):
    """The rank's expert(-slice) of a stored expert weight in the
    expert-parallel layout, gathered over ``data`` (the fsdp shard,
    ZeRO-3 style): w1 / w3 [E, D, F] -> [e_loc, D, F / dup], w2 [E, F, D]
    -> [e_loc, F / dup, D]. With E > TP the experts are re-split over
    ``model`` (an all-to-all of the F shards); with TP >= E the expert's
    whole F is gathered and the rank keeps its slice."""
    from torch.distributed.tensor import Replicate, Shard

    fdim = 2 if name != "w2" else 1
    model = mesh.mesh_dim_names.index("model")
    w = replicated(w, mesh)
    if dup == 1:
        pl = [Replicate()] * mesh.ndim
        pl[model] = Shard(0)
        return local(redistribute(w, pl))
    full = local(redistribute(w, [Replicate()] * mesh.ndim))
    m = mesh.get_local_rank("model")
    ex, j = m // dup, m % dup
    return full[ex:ex + 1].narrow(fdim, j * f_loc, f_loc)


def _moe_prefill_local(x_loc, router, ws, cfg: ModelConfig, tp: int,
                       e: int, dup: int, e_loc: int, token_axes):
    """The reference's all-to-all body on one rank's tokens x_loc [bl,
    sl, D]; returns (y [bl, sl, D], aux averaged over the token axes)."""
    bl, sl, d = x_loc.shape
    buf, meta, aux = moe_lib.route_and_dispatch(x_loc.reshape(-1, d),
                                                router, cfg)
    cap = buf.shape[1]
    # pack destinations: expert e -> ranks [e*dup, (e+1)*dup)
    if dup > 1:
        send = buf[:, None].expand(e, dup, cap, d).reshape(tp, cap, d)
    else:
        send = buf.reshape(tp, e_loc * cap, d)
    recv = all_to_all(send, "model")
    if e_loc > 1:          # sources sent [e_loc, cap, d]; regroup by expert
        xin = recv.reshape(tp, e_loc, cap, d).transpose(0, 1) \
            .reshape(e_loc, tp * cap, d)
    else:
        xin = recv.reshape(1, tp * cap, d)
    out_e = moe_lib.expert_gemms(xin, ws["w1"], ws["w3"], ws["w2"], cfg)
    if e_loc > 1:
        back = out_e.reshape(e_loc, tp, cap, d).transpose(0, 1) \
            .reshape(tp, e_loc * cap, d)
    else:
        back = out_e.reshape(tp, cap, d)
    ret = all_to_all(back, "model")
    if dup > 1:                            # sum the F-slice partials
        out_buf = ret.reshape(e, dup, cap, d).float().sum(dim=1) \
            .to(ret.dtype)
    else:
        out_buf = ret.reshape(e, cap, d)
    y = moe_lib.combine(out_buf, meta, d, cfg)
    for ax in token_axes:
        aux = psum(aux, ax) / axis_size(ax)
    return y.reshape(bl, sl, d), aux


def _moe_decode_local(x_loc, router, ws, cfg: ModelConfig, shape: dict,
                      gather_axes):
    """The reference's weights-stationary body: x_loc [bl, 1, D]; ws the
    rank's storage shards w1 / w3 [E, D/data, F/model], w2 [E, F/model,
    D/data]. Returns (y [bl, 1, D], aux)."""
    bl, _, d = x_loc.shape
    x_all = x_loc.reshape(bl, d)
    for ax in gather_axes:
        x_all = all_gather_tiled(x_all, ax, 0)
    buf, meta, aux = moe_lib.route_and_dispatch(x_all, router, cfg)
    has_data = "data" in shape
    if has_data:                          # this rank's D shard
        d_shard = d // shape["data"]
        lo = axis_index("data") * d_shard
        buf_d = buf[:, :, lo:lo + d_shard]
    else:
        buf_d = buf
    # the partial products accumulated and summed across ranks in
    # float32 (the operands in the weights' dtype), then rounded once to
    # the weights' dtype, as one product accumulates
    w1, w3, w2 = ws["w1"], ws["w3"], ws["w2"]
    xd = buf_d.to(w1.dtype)
    h1, h3 = matmul_f32(xd, w1), matmul_f32(xd, w3)
    if has_data:
        h1, h3 = psum_local(h1, "data"), psum_local(h3, "data")
    hh = torch.nn.functional.silu(h1.to(w1.dtype)) * h3.to(w1.dtype)
    out_p = matmul_f32(hh, w2)
    out_p = psum_local(out_p, "model").to(w2.dtype)     # finish F
    out_buf = all_gather_tiled(out_p, "data", 2) if has_data else out_p
    y_all = moe_lib.combine(out_buf.to(buf.dtype), meta, d, cfg)
    off = 0
    for ax in gather_axes:
        off = off * shape[ax] + axis_index(ax)
    return y_all[off * bl:(off + 1) * bl].reshape(bl, 1, d), aux


def _attn_ffn_block(h, bp, cfg: ModelConfig, *, cache, positions,
                    return_kv=False, rope=None, valid=None,
                    seq_sharded=False):
    """One pre-norm attention + FFN block (SwiGLU, or the MoE FFN where
    ``cfg.n_experts``); returns (h, aux, cache or the collected K/V). The
    dense FFN adds a zero auxiliary loss."""
    seq = "seq" if seq_sharded else None
    resid = h
    x = rms_norm(h, bp["ln1"]["scale"], cfg.norm_eps)
    attn_out, new_cache = attention_layer(x, bp["attn"], cfg, cache=cache,
                                          positions=positions,
                                          return_kv=return_kv, rope=rope,
                                          valid=valid)
    h = constrain(resid + _placed(attn_out, resid, seq), "batch", seq, None)
    resid = h
    x = rms_norm(h, bp["ln2"]["scale"], cfg.norm_eps)
    if cfg.n_experts:
        ffn_out, aux = moe_ffn(x, bp["ffn"], cfg, seq_sharded)
    else:
        ffn_out = mlp(x, bp["ffn"], cfg)
        aux = _zero_aux(h)
    h = resid + _placed(ffn_out, resid, seq)
    return constrain(h, "batch", seq, None), aux, new_cache


def _zero_aux(h) -> torch.Tensor:
    """A float32 zero scalar on h's device (replicated under a mesh)."""
    z = torch.zeros((), dtype=torch.float32, device=local(h).device)
    return replicated(z) if current_mesh() is not None else z


def decoder_forward(params: dict, h: torch.Tensor, cfg: ModelConfig, *,
                    caches: Optional[dict] = None,
                    positions: Optional[torch.Tensor] = None,
                    collect: bool = False, seq_sharded: bool = False):
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
    if positions is not None:
        positions = full_tensor(positions)
    aux = _zero_aux(h)
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
                                 collect, rope, valid, ks, vs,
                                 seq_sharded=seq_sharded)
                aux = aux + a
    if decode:
        return h, aux, caches
    if not collect:
        return h, aux, None
    out = {}
    if convs:
        out["ssm"] = SSMCache(stack(convs), stack(states))
    if ks:
        out["attn"] = (stack(ks), stack(vs))
    return h, aux, out


def stack(ts: list) -> torch.Tensor:
    """`torch.stack` of tensors along a new leading axis; DTensors of one
    placement are stacked shard by shard (their placements shift by
    one dimension)."""
    if not is_dtensor(ts[0]):
        return torch.stack(ts)
    from torch.distributed.tensor import Shard

    ref = ts[0]
    pl = [Shard(p.dim + 1) if isinstance(p, Shard) else p
          for p in ref.placements]
    return from_local(torch.stack([local(t) for t in ts]), ref.device_mesh,
                      pl, (len(ts),) + tuple(ref.shape))


def _write_positions(cache: AttnCache, positions: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """Write each row's new position into every stacked cache's pos_buf
    ([L, B, W]: every layer's, or every application's, cache holds the
    same positions) at once and derive the slot validity once, rather than
    in each attention layer as the reference does; returns the [B, W]
    int8 validity."""
    pb = cache.pos_buf
    if is_dtensor(pb):
        return _write_positions_mesh(pb, positions, cfg)
    rows = torch.arange(pb.shape[1], device=pb.device)
    pb[:, rows, positions.long() % pb.shape[-1]] = positions.to(pb.dtype)
    return decode_valid(pb[0], positions, cfg.swa_window)


def _write_positions_mesh(pb, positions: torch.Tensor, cfg: ModelConfig):
    """`_write_positions` on the rank's shard of a [L, B, W] pos_buf
    DTensor (its rows and, where the positions are split, the slots it
    owns); returns the [B, W] int8 validity as a DTensor split over the
    batch as the cache is, every position of the rank's rows local."""
    from torch.distributed.tensor import Replicate, Shard

    pbl = local(pb)
    _, b0, w0 = shard_offsets(pb)
    bl, wl = pbl.shape[1:]
    pos = positions[b0:b0 + bl]
    slot = pos.long() % pb.shape[-1]
    rows = torch.arange(bl, device=pbl.device)
    hit = (slot >= w0) & (slot < w0 + wl)
    at = (slot - w0).clamp(0, wl - 1)
    pbl[:, rows, at] = torch.where(hit, pos.to(pbl.dtype), pbl[:, rows, at])
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else Replicate()
          for p in pb.placements]
    rows_only = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                 for p in pl]
    first = from_local(pbl[0], pb.device_mesh, pl, tuple(pb.shape[1:]))
    valid = decode_valid(local(redistribute(first, rows_only)), pos,
                         cfg.swa_window)
    return from_local(valid, pb.device_mesh, rows_only, tuple(pb.shape[1:]))


def _layer_cache(c: AttnCache, i: int) -> AttnCache:
    """Slice ``i`` of a stacked cache (views: decode writes through; a
    DTensor's slice is a view of its shard)."""
    return AttnCache(*(None if x is None else _select0(x, i) for x in c))


def _select0(x, i: int):
    if not is_dtensor(x):
        return x[i]
    from torch.distributed.tensor import Shard

    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in x.placements]
    return from_local(local(x)[i], x.device_mesh, pl, tuple(x.shape[1:]))


def _attn_app(h, bp, cfg: ModelConfig, caches, i: int, positions,
              collect: bool, rope, valid, ks: list, vs: list,
              seq_sharded: bool = False):
    """One attention + FFN block against slice ``i`` of the stacked K/V
    cache (decode), collecting its K/V (prefill), or under ``cfg.remat``
    (a training forward: neither); returns (h, the block's aux)."""
    if caches is None and not collect:
        return _remat(lambda h, bp: _attn_ffn_block(
            h, bp, cfg, cache=None, positions=positions, rope=rope,
            seq_sharded=seq_sharded)[:2], cfg)(h, bp)
    cache = None if caches is None else _layer_cache(caches["attn"], i)
    h, aux, kv = _attn_ffn_block(h, bp, cfg, cache=cache,
                                 positions=positions, return_kv=collect,
                                 rope=rope, valid=valid,
                                 seq_sharded=seq_sharded)
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
            slot = SSMCache(_select0(pool.conv, i), _select0(pool.state, i))
            out, new = ssm_block(x, bp["ssm"], cfg, cache=slot)
            for dst, src in zip(slot, new):
                local(dst).copy_(local(src))
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
    h = h + _placed(attention_layer(x, bp["attn"], cfg, causal=False,
                                    use_rope=False)[0], h, None)
    x = rms_norm(h, bp["ln2"]["scale"], cfg.norm_eps)
    return h + _placed(mlp(x, bp["ffn"], cfg, act="gelu"), h, None)


def _placed(out, h, seq):
    """A block's branch output placed as its residual ``h`` (batch, and
    ``seq`` over the sequence) and in its dtype (under a mesh the
    row-parallel products come in float32; identity on one device)."""
    return constrain(out, "batch", seq, None).to(h.dtype)


def encoder_forward(params: dict, h: torch.Tensor, cfg: ModelConfig, *,
                    seq_sharded: bool = False) -> torch.Tensor:
    """The encoder over frame embeddings h [B, enc_seq, D] (each block
    under ``cfg.remat`` in a training forward), final-normed.
    ``seq_sharded`` is the reference's sharding and has no effect on one
    device."""
    del seq_sharded
    h = constrain(h, "batch", None, None)
    for bp in unstack(params["enc_blocks"], cfg.enc_layers):
        h = _remat(lambda h, bp: _enc_block(h, bp, cfg), cfg)(h, bp)
    return rms_norm(h, params["enc_norm"]["scale"], cfg.norm_eps)


def _encdec_block(h, bp, cfg: ModelConfig, *, enc_out=None, cache=None,
                  cross_kv=None, positions=None, return_kv=False,
                  rope=None, valid=None, cross_valid=None, seq=None):
    """One decoder block: causal self-attention with rope (decode: against
    ``cache``), cross-attention to the encoder (K/V from ``cross_kv``, or
    projected from ``enc_out`` without bias), the plain gelu MLP, each
    pre-norm. Returns (h, self cache or collected K/V, cross k, cross v).
    ``seq``: under a mesh, the hidden state's placement over the sequence
    between sublayers (the reference's constrain points)."""
    cdt = _dtype(cfg.dtype)
    x = rms_norm(h, bp["ln1"]["scale"], cfg.norm_eps)
    a_out, new_self = attention_layer(
        x, bp["self_attn"], cfg, causal=True, cache=cache,
        positions=positions, return_kv=return_kv, rope=rope, valid=valid)
    h = h + _placed(a_out, h, seq)
    x = rms_norm(h, bp["ln2"]["scale"], cfg.norm_eps)
    if cross_kv is None:
        enc = constrain(enc_out, "batch", None, None)
        cross_kv = tuple(
            _proj(enc, constrain(bp["cross_attn"][w], None, "kv_heads", None),
                  cdt) for w in ("wk", "wv"))
    h = h + _placed(attention_layer(x, bp["cross_attn"], cfg,
                                    cross_kv=cross_kv, valid=cross_valid)[0],
                    h, seq)
    x = rms_norm(h, bp["ln3"]["scale"], cfg.norm_eps)
    h = h + _placed(mlp(x, bp["ffn"], cfg, act="gelu"), h, seq)
    return constrain(h, "batch", seq, None), new_self, cross_kv[0], \
        cross_kv[1]


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
    (0), new_caches). ``seq_sharded``: under a mesh, the hidden state is
    split over the sequence between blocks (not in decode)."""
    decode = caches is not None
    seq = "seq" if seq_sharded and not decode else None
    if positions is not None:
        positions = full_tensor(positions)
    aux = _zero_aux(h)
    layers = unstack(params["blocks"], cfg.n_layers)
    pos = positions[:, None] if decode else _prefill_positions(h, positions)
    rope = rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
    if not decode and not collect:
        for bp in layers:
            h = _remat(lambda h, bp, enc: _encdec_block(
                h, bp, cfg, enc_out=enc, positions=positions,
                rope=rope, seq=seq)[0], cfg)(h, bp, enc_out)
        return h, aux, None
    valid = cross_valid = None
    if decode:
        valid = _write_positions(caches["self"], positions, cfg)
        cross_valid = torch.ones(caches["cross_k"].shape[1:3],
                                 dtype=torch.int8, device=local(h).device)
    ks, vs, cks, cvs = [], [], [], []
    for i, bp in enumerate(layers):
        h, kv, ck, cv = _encdec_block(
            h, bp, cfg, enc_out=enc_out,
            cache=_layer_cache(caches["self"], i) if decode else None,
            cross_kv=(_select0(caches["cross_k"], i),
                      _select0(caches["cross_v"], i)) if decode else None,
            positions=positions, return_kv=collect, rope=rope, valid=valid,
            cross_valid=cross_valid, seq=seq)
        if collect:
            ks.append(kv[0])
            vs.append(kv[1])
            cks.append(ck)
            cvs.append(cv)
    if decode:
        return h, aux, caches
    return h, aux, {"self": (stack(ks), stack(vs)),
                    "cross_k": stack(cks), "cross_v": stack(cvs)}
