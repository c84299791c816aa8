from .factory import get_model
from .medformer import MedFormer
from .params import init_params, load_flax_params, params_from_flax

__all__ = ["MedFormer", "get_model", "init_params", "load_flax_params",
           "params_from_flax"]
