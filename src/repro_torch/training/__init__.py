"""Training (port of `repro.training`): AdamW, the train step with
microbatch accumulation and data-parallel gradient reduction, and int8
gradient compression with error feedback."""
from .compression import compress_int8, decompress_int8, error_feedback_allreduce  # noqa: F401
from .optimizer import (AdamWState, adamw_init, adamw_update, cosine_schedule,  # noqa: F401
                        global_norm)
from .train_step import (accumulate_grads, loss_fn, make_train_step,  # noqa: F401
                         named_parameters)
