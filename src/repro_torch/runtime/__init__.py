from .fault_tolerance import (FailureInjector, FaultTolerantLoop,
                              StragglerPolicy)

__all__ = ["FaultTolerantLoop", "FailureInjector", "StragglerPolicy"]
