"""Training on one device: chunked cross-entropy, AdamW, the train step
with microbatch accumulation and per-layer recomputation, checkpoints in
the reference's format, int8 gradient compression and the straggler
watchdog (the reference's ``repro.train``)."""

from .loss import chunked_cross_entropy  # noqa: F401
from .optimizer import adamw_init, adamw_update  # noqa: F401
from .train_step import TrainState, make_train_step  # noqa: F401
