"""Training (port of `repro.training`): AdamW (ZeRO-1 moments on a
tensor-parallel mesh), the train step with microbatch accumulation, data-
and tensor-parallel gradient reduction, and int8 gradient compression with
error feedback."""
from .compression import compress_int8, decompress_int8, error_feedback_allreduce  # noqa: F401
from .optimizer import (AdamWState, Zero1Plan, adamw_init, adamw_update,  # noqa: F401
                        cosine_schedule, global_norm, zero1_init, zero1_plan, zero1_update)
from .train_step import (accumulate_grads, init_state, loss_fn, make_train_step,  # noqa: F401
                         named_parameters)
