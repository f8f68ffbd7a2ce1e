// The simulators' opcode space and its evaluation, shared by sim_dense.cu
// and sim_sparse.cu.
//
// The enum is the order of _OPS in repro_torch/core/sim_vec.py (the tests
// read it from this file and compare). Each case is the interpreter's
// PE_OPS formula with the reference's 16-bit masks; values stay in
// [0, 0xFFFF], so uint32 arithmetic is exact. Predicated ops take the
// predicate as their last argument.

#pragma once

#include <stdint.h>

namespace {

enum SimOp {
  kOp_zero, kOp_pass, kOp_add, kOp_sub, kOp_mul, kOp_and, kOp_or, kOp_xor,
  kOp_shr, kOp_shl, kOp_min, kOp_max, kOp_abs, kOp_gt, kOp_lt, kOp_eq,
  kOp_ne, kOp_ge, kOp_le, kOp_mux, kOp_sel, kOp_phi, kOp_steer, kOp_rom,
  kOp_acc, kOp_accp,
};

constexpr uint32_t kMask = 0xFFFFu;

// op over (a0, a1, a2); a ROM gathers table[rom, a0 % tab_len[rom]] from a
// row-major [n_rom, max_tab] matrix. acc and accp keep state and are
// evaluated by the sparse kernel itself.
__device__ __forceinline__ uint32_t sim_op(int op, uint32_t a0, uint32_t a1,
                                           uint32_t a2, int rom,
                                           const int* table, int max_tab,
                                           const int* tab_len) {
  switch (op) {
    case kOp_pass: return a0;
    case kOp_add: return (a0 + a1) & kMask;
    case kOp_sub: return (a0 - a1) & kMask;
    case kOp_mul: return (a0 * a1) & kMask;
    case kOp_and: return a0 & a1;
    case kOp_or: return a0 | a1;
    case kOp_xor: return a0 ^ a1;
    case kOp_shr: return (a0 >> (a1 & 0xFu)) & kMask;
    case kOp_shl: return (a0 << (a1 & 0xFu)) & kMask;
    case kOp_min: return min(a0, a1);
    case kOp_max: return max(a0, a1);
    case kOp_abs: return a0 < 0x8000u ? a0 : (0u - a0) & kMask;
    case kOp_gt: return a0 > a1;
    case kOp_lt: return a0 < a1;
    case kOp_eq: return a0 == a1;
    case kOp_ne: return a0 != a1;
    case kOp_ge: return a0 >= a1;
    case kOp_le: return a0 <= a1;
    case kOp_mux: return (a0 & 1u) ? a1 : a2;
    case kOp_sel:
    case kOp_phi: return (a2 & 1u) ? a0 : a1;
    case kOp_steer: return (a1 & 1u) ? a0 : 0u;
    case kOp_rom:
      return static_cast<uint32_t>(
          table[rom * max_tab + static_cast<int>(a0 % static_cast<uint32_t>(
                                                          tab_len[rom]))]);
    default: return 0u;                     // kOp_zero
  }
}

}  // namespace
