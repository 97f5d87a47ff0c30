from repro_torch.data.pipeline import (SyntheticLM, batch_at,  # noqa: F401
                                       global_batch_sharding, host_shard)
