from repro_torch.models.config import ArchConfig  # noqa: F401
from repro_torch.models.model import (DecodeModel, decode_forward, forward,
                                      init_cache, init_params, loss_fn,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, param_schema,
                                      params_from_jax)  # noqa: F401
