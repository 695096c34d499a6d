"""Training substrate of the port (counterpart of the JAX package's
``train/``): optimizer, train step and checkpoints."""

from .optimizer import (AdamWConfig, adamw_init, adamw_update, global_norm,
                        clip_by_global_norm, ef8_init, ef8_compress,
                        warmup_cosine)
from .train_loop import TrainConfig, TrainState, make_train_step, init_state
from .checkpoint import save_checkpoint, restore_checkpoint, latest_step

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "ef8_init", "ef8_compress",
           "warmup_cosine", "TrainConfig", "TrainState", "make_train_step",
           "init_state", "save_checkpoint", "restore_checkpoint",
           "latest_step"]
