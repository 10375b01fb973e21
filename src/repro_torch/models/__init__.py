from repro_torch.models.config import ArchConfig  # noqa: F401
from repro_torch.models.model import (DecodeModel, decode_forward,
                                      init_cache, init_params,
                                      make_serve_step, param_schema,
                                      params_from_jax)  # noqa: F401
