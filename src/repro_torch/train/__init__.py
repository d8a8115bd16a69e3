"""Step factories of the port.  Only the serving pair is ported
(``make_serve_steps``); the train step, AdamW and the schedules come
with the training slice (ROADMAP queue 1 item 2(d))."""
from repro_torch.train.steps import make_serve_steps

__all__ = ["make_serve_steps"]
