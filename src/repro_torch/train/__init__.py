"""Train and serving steps, the optimizer and checkpointing."""
from .optimizer import OptConfig, OptState  # noqa: F401
from .step import (make_loss_fn, make_prefill_logits,  # noqa: F401
                   make_prefill_step, make_serve_step, make_train_step)
