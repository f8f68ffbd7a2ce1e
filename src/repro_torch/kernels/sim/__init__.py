from .ref import sim_dense_plain, sim_sparse_plain
from .sim import SparseResult, sim_dense, sim_sparse, stage_plan

__all__ = ["sim_dense", "sim_sparse", "sim_dense_plain", "sim_sparse_plain",
           "stage_plan", "SparseResult"]
