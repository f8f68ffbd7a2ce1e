from .ref import sim_dense_plain, sim_sparse_plain
from .sim import (SparseResult, dense_plan, sim_dense, sim_sparse,
                  sparse_plan, stage_plan)

__all__ = ["sim_dense", "sim_sparse", "sim_dense_plain", "sim_sparse_plain",
           "stage_plan", "dense_plan", "sparse_plan", "SparseResult"]
