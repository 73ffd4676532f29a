"""Atomic, resumable checkpointing (see checkpoint.py)."""
from repro_torch.checkpoint.checkpoint import (latest_step,  # noqa: F401
                                               restore, restore_latest, save,
                                               save_async)
