"""Training substrate of the port: AdamW (float32 or 8-bit states),
the cosine schedule, gradient clipping, and the train / serve step
factories."""
from repro_torch.train.optimizer import (AdamWState, adamw_init,
                                         adamw_update, clip_by_global_norm,
                                         cosine_schedule)
from repro_torch.train.steps import (TrainState, init_train_state,
                                     make_serve_steps, make_train_step)

__all__ = ["AdamWState", "TrainState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "init_train_state",
           "make_serve_steps", "make_train_step"]
