"""Plain references the benchmark holds the port's outputs against.

Plain PyTorch, written from the paper's definitions and the port's
documented semantics: nothing here imports `repro_torch`, `repro` or
JAX, and nothing takes a value the port derived. Every function takes a
``dtype``, so the same code computed in a lower precision is the control
that the comparison has to reject.
"""
