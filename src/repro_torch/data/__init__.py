"""Deterministic synthetic data streams (numpy)."""
from repro_torch.data.synthetic import ClassificationTasks, LMStream  # noqa: F401
