"""Checkpoints (port of `repro.checkpoint`): atomic, verified, async."""
from .manager import (CheckpointCorrupt, CheckpointManager, latest_step,  # noqa: F401
                      list_steps, load_manifest, path_key, restore_latest_intact,
                      restore_pytree, restore_tenant_latest_intact, restore_tenant_pytree,
                      save_pytree, sweep_tmp_dirs)
