from .pipeline import SyntheticLMData, batch_logical_axes, batch_specs

__all__ = ["SyntheticLMData", "batch_specs", "batch_logical_axes"]
