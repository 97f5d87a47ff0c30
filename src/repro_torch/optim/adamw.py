"""AdamW on parameter trees (NamedTuples, tuples, lists or dicts of
tensors).

Moments are kept in ``opt.moment_dtype`` (float32 by default); the update
math runs in float32 regardless. ``per_row=True`` treats the leading axis
of every leaf as independent rows, each with its own global-norm clip over
that row's slice of all leaves: the batch dimension written out where the
reference vmaps `adamw_update` over rows (`repro.tune.optimizer`). The
step count stays one shared scalar either way. Nothing here reads a
tensor back to the host, so a loop of updates stays on the device.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0          # global-norm clip; 0 disables
    moment_dtype: str = "float32"


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32 scalar
    mu: Any                         # first moments  (tree like params)
    nu: Any                         # second moments (tree like params)


def _mdt(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure (NamedTuples,
    tuples, lists and dicts; anything else is a leaf)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs)
                            for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def adamw_init(params: Any, opt: AdamWConfig) -> AdamWState:
    mdt = _mdt(opt.moment_dtype)
    leaf = tree_leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaf.device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: Any, *, per_row: bool = False) -> torch.Tensor:
    """sqrt of the sum of squares over all leaves; ``per_row`` keeps the
    leading axis ([B]: one norm per row over that row of every leaf)."""
    def sq(x):
        x = x.float()
        if per_row:
            return torch.sum((x * x).reshape(x.shape[0], -1), dim=1)
        return torch.sum(x * x)
    return torch.sqrt(torch.sum(torch.stack([sq(x)
                                             for x in tree_leaves(tree)]),
                                dim=0))


def clip_by_global_norm(grads: Any, max_norm: float, *,
                        per_row: bool = False) -> tuple[Any, torch.Tensor]:
    norm = global_norm(grads, per_row=per_row)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)

    def clip(g):
        sc = scale.reshape(scale.shape + (1,) * (g.ndim - scale.ndim))
        return (g.float() * sc).to(g.dtype)
    return tree_map(clip, grads), norm


def adamw_update(grads: Any, state: AdamWState, params: Any,
                 opt: AdamWConfig, lr: Optional[float] = None, *,
                 per_row: bool = False, stats: bool = True
                 ) -> tuple[Any, AdamWState, dict]:
    """One AdamW step; returns ``(new_params, new_state, stats)``. ``lr``
    overrides ``opt.lr`` (schedules); ``per_row`` clips each row of the
    leading axis by its own global norm. ``stats=False`` leaves
    ``grad_norm`` out of the stats, so that with ``clip_norm=0`` no norm
    is computed (eager PyTorch would launch it and throw it away)."""
    lr = opt.lr if lr is None else lr
    out = {"lr": lr}
    if opt.clip_norm:
        grads, out["grad_norm"] = clip_by_global_norm(
            grads, opt.clip_norm, per_row=per_row)
    elif stats:
        out["grad_norm"] = global_norm(grads, per_row=per_row)
    if not stats:
        out.pop("grad_norm", None)
    step = state.step + 1
    stepf = step.to(torch.float32)
    c1 = 1.0 - opt.b1 ** stepf
    c2 = 1.0 - opt.b2 ** stepf
    mdt = _mdt(opt.moment_dtype)

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = opt.b1 * m.float() + (1 - opt.b1) * g32
        v32 = opt.b2 * v.float() + (1 - opt.b2) * g32 * g32
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + opt.eps)
        if opt.weight_decay:
            delta = delta + opt.weight_decay * p.float()
        new_p = p.float() - lr * delta
        return _Updated(new_p.to(p.dtype), m32.to(mdt), v32.to(mdt))

    flat = tree_map(upd, params, grads, state.mu, state.nu)
    return (tree_map(lambda u: u.p, flat),
            AdamWState(step, tree_map(lambda u: u.m, flat),
                       tree_map(lambda u: u.v, flat)),
            out)


class _Updated:
    """One leaf's (param, mu, nu) after the update: a leaf to
    `tree_map`, so trees of tuples split back apart unambiguously."""

    __slots__ = ("p", "m", "v")

    def __init__(self, p, m, v):
        self.p, self.m, self.v = p, m, v
