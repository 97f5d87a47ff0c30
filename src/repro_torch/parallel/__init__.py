from repro_torch.parallel.axes import (
    LogicalRules,
    TRAIN_RULES,
    SSM_PREFILL_RULES,
    DECODE_RULES,
    SINGLE_DEVICE_RULES,
    axis_size,
    constrain,
    current_mesh,
    current_rules,
    logical_to_spec,
    row_mesh,
    use_sharding,
)

__all__ = [
    "LogicalRules",
    "TRAIN_RULES",
    "SSM_PREFILL_RULES",
    "DECODE_RULES",
    "SINGLE_DEVICE_RULES",
    "axis_size",
    "constrain",
    "current_mesh",
    "current_rules",
    "logical_to_spec",
    "row_mesh",
    "use_sharding",
]
