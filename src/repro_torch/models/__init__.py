from .model import LM
from .params import ParamDef, init_params, param_count

__all__ = ["LM", "ParamDef", "init_params", "param_count"]
