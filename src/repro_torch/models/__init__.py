"""The LLM model stack: configs in `repro_torch.configs`; every family's
layers, attention, MoE FFN and assembly here (serving and the training
loss)."""

from repro_torch.models.model import (cache_specs, decode_step, init_cache,
                                      init_params, loss_fn, param_specs,
                                      params_from_numpy, prefill)

__all__ = [
    "init_params",
    "loss_fn",
    "params_from_numpy",
    "prefill",
    "decode_step",
    "init_cache",
    "cache_specs",
    "param_specs",
]
