"""Deterministic data pipeline (restart-exact; see pipeline.py)."""
from repro_torch.data.pipeline import (DataConfig, DataIterator,  # noqa: F401
                                       host_batch)
