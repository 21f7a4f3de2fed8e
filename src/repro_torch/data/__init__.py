"""Deterministic, shardable, resumable synthetic data pipeline."""
from .synthetic import DataConfig, SyntheticLM, calibration_batches
