from .checkpointer import (CheckpointCorruptError, CheckpointError,
                           checkpoint_steps, latest_step, load_checkpoint,
                           load_manifest, prune_checkpoints,
                           restore_latest_valid, restore_train_state,
                           save_checkpoint, snapshot_tree,
                           verify_checkpoint)
