from .maxplus import NEG_INF, maxplus_matmul
from .ops import longest_path
from .ref import maxplus_matmul_plain, maxplus_matmul_ref

__all__ = ["NEG_INF", "maxplus_matmul", "longest_path", "maxplus_matmul_plain",
           "maxplus_matmul_ref"]
