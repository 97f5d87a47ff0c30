"""Runtime support. This slice carries only the elastic-capacity
arithmetic that `repro_torch.fleet.grid.elastic_policy` needs."""
