from .factory import get_model
from .medformer import MedFormer
from .params import (flax_from_state_dict, init_params, load_flax_params,
                     params_from_flax, train_state_from_jax)

__all__ = ["MedFormer", "get_model", "init_params", "load_flax_params",
           "params_from_flax", "flax_from_state_dict", "train_state_from_jax"]
