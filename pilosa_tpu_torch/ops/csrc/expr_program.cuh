// Postfix bitmap-expression interpreter shared by the expression-count
// and TopN block-count kernels.
//
// A PQL bitmap tree (and/or/xor/andnot over leaf rows) arrives as a
// program of (opcode, argument) int32 pairs built by
// pilosa_tpu_torch/ops/cuda_kernels.py:compile_program. The running
// value lives in a register (`acc`); only a subtree evaluated while
// another result waits spills to a small per-thread stack. The compiler
// orders children Sethi-Ullman style (the deeper child first, with the
// reversed andnot forms where needed), so a left fold of any width needs
// no stack at all and any tree of L leaves needs at most
// floor(log2 L) stack slots — far below MAX_STACK for every leaf count
// that fits on the card.
//
// Leaves are addressed through a device array of base pointers, one
// [S, W] u32 slab per leaf, so resident slabs are read where they lie.
//
// Three interpreters: eval_program runs the program over one 16-byte word
// group, reading every instruction and leaf pointer from global memory
// (the TopN block count's); StagedProgram / eval_program_u run it over U
// word groups at once from a copy of the program in shared memory (the
// expression count's), so the U loads of an instruction are independent
// and the decode is paid once for U groups; eval_program_window runs it
// over one group with the loads of P instructions in flight at once (the
// materializing expr_words').
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pilosa {

enum Opcode : int32_t {
  OP_LOAD = 0,          // acc = leaf[arg]
  OP_AND_LEAF = 1,      // acc = acc & leaf[arg]
  OP_OR_LEAF = 2,       // acc = acc | leaf[arg]
  OP_XOR_LEAF = 3,      // acc = acc ^ leaf[arg]
  OP_ANDNOT_LEAF = 4,   // acc = acc & ~leaf[arg]
  OP_RANDNOT_LEAF = 5,  // acc = leaf[arg] & ~acc
  OP_PUSH = 6,          // stack[sp++] = acc
  OP_AND_POP = 7,       // acc = stack[--sp] & acc
  OP_OR_POP = 8,        // acc = stack[--sp] | acc
  OP_XOR_POP = 9,       // acc = stack[--sp] ^ acc
  OP_ANDNOT_POP = 10,   // acc = stack[--sp] & ~acc
  OP_RANDNOT_POP = 11,  // acc = acc & ~stack[--sp]
};

constexpr int MAX_STACK = 32;

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint4 andnot4(uint4 a, uint4 b) {
  return make_uint4(a.x & ~b.x, a.y & ~b.y, a.z & ~b.z, a.w & ~b.w);
}
__device__ __forceinline__ int popc4(uint4 a) {
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
}

// Leaf `leaf`'s 16-byte word group `off` (an index into the slab viewed
// as uint4, row offset included).
__device__ __forceinline__ uint4 leaf_words(const long long* __restrict__ ptrs,
                                            int leaf, size_t off) {
  const uint4* base = reinterpret_cast<const uint4*>(__ldg(ptrs + leaf));
  return __ldg(base + off);
}

// Evaluate the program over one 16-byte word group of every leaf.
__device__ __forceinline__ uint4 eval_program(const int2* __restrict__ prog,
                                              int n_ins,
                                              const long long* __restrict__ ptrs,
                                              size_t off, uint4* stack) {
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  int sp = 0;
  for (int k = 0; k < n_ins; ++k) {
    const int2 ins = __ldg(prog + k);
    switch (ins.x) {
      case OP_LOAD: acc = leaf_words(ptrs, ins.y, off); break;
      case OP_AND_LEAF: acc = and4(acc, leaf_words(ptrs, ins.y, off)); break;
      case OP_OR_LEAF: acc = or4(acc, leaf_words(ptrs, ins.y, off)); break;
      case OP_XOR_LEAF: acc = xor4(acc, leaf_words(ptrs, ins.y, off)); break;
      case OP_ANDNOT_LEAF:
        acc = andnot4(acc, leaf_words(ptrs, ins.y, off));
        break;
      case OP_RANDNOT_LEAF:
        acc = andnot4(leaf_words(ptrs, ins.y, off), acc);
        break;
      case OP_PUSH: stack[sp++] = acc; break;
      case OP_AND_POP: acc = and4(stack[--sp], acc); break;
      case OP_OR_POP: acc = or4(stack[--sp], acc); break;
      case OP_XOR_POP: acc = xor4(stack[--sp], acc); break;
      case OP_ANDNOT_POP: acc = andnot4(stack[--sp], acc); break;
      case OP_RANDNOT_POP: acc = andnot4(acc, stack[--sp]); break;
      default: break;
    }
  }
  return acc;
}

// The first STAGED instructions of a program, each with the base pointer
// of the leaf it reads, copied to shared memory once per CTA. Later
// instructions are read from global memory, as eval_program reads them:
// no cap on program length or leaf count.
template <int STAGED>
struct StagedProgram {
  int op[STAGED];
  const uint4* leaf[STAGED];

  // Every thread of the CTA calls this; it ends with a barrier.
  __device__ __forceinline__ void stage(const int2* __restrict__ prog,
                                        int n_ins,
                                        const long long* __restrict__ ptrs) {
    const int n = n_ins < STAGED ? n_ins : STAGED;
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int2 ins = __ldg(prog + k);
      op[k] = ins.x;
      leaf[k] = ins.x < OP_PUSH ? reinterpret_cast<const uint4*>(
                                      __ldg(ptrs + ins.y))
                                : nullptr;
    }
    __syncthreads();
  }

  __device__ __forceinline__ int fetch(const int2* __restrict__ prog,
                                       const long long* __restrict__ ptrs,
                                       int k, const uint4** base) const {
    if (k < STAGED) {
      *base = leaf[k];
      return op[k];
    }
    const int2 ins = __ldg(prog + k);
    *base = ins.x < OP_PUSH
                ? reinterpret_cast<const uint4*>(__ldg(ptrs + ins.y))
                : nullptr;
    return ins.x;
  }
};

// Evaluate the program over U word groups of every leaf at once: groups
// off + u * stride for u < U, of which those at or past `end` read as
// zero words (and count zero: no opcode turns zeros into ones). Each
// leaf-reading instruction issues its U loads before it combines any.
// `stack` holds MAX_STACK slots of U groups.
template <int U, int STAGED>
__device__ __forceinline__ void eval_program_u(
    const StagedProgram<STAGED>& sp_prog, const int2* __restrict__ prog,
    int n_ins, const long long* __restrict__ ptrs, size_t off, size_t stride,
    size_t end, uint4 (&acc)[U], uint4 (*stack)[U]) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int u = 0; u < U; ++u) acc[u] = zero;
  int sp = 0;
  for (int k = 0; k < n_ins; ++k) {
    const uint4* base;
    const int op = sp_prog.fetch(prog, ptrs, k, &base);
    if (op < OP_PUSH) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t g = off + u * stride;
        v[u] = g < end ? __ldg(base + g) : zero;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        switch (op) {
          case OP_LOAD: acc[u] = v[u]; break;
          case OP_AND_LEAF: acc[u] = and4(acc[u], v[u]); break;
          case OP_OR_LEAF: acc[u] = or4(acc[u], v[u]); break;
          case OP_XOR_LEAF: acc[u] = xor4(acc[u], v[u]); break;
          case OP_ANDNOT_LEAF: acc[u] = andnot4(acc[u], v[u]); break;
          default: acc[u] = andnot4(v[u], acc[u]); break;  // RANDNOT
        }
      }
      continue;
    }
    if (op == OP_PUSH) {
#pragma unroll
      for (int u = 0; u < U; ++u) stack[sp][u] = acc[u];
      ++sp;
      continue;
    }
    --sp;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint4 top = stack[sp][u];
      switch (op) {
        case OP_AND_POP: acc[u] = and4(top, acc[u]); break;
        case OP_OR_POP: acc[u] = or4(top, acc[u]); break;
        case OP_XOR_POP: acc[u] = xor4(top, acc[u]); break;
        case OP_ANDNOT_POP: acc[u] = andnot4(top, acc[u]); break;
        default: acc[u] = andnot4(acc[u], top); break;  // RANDNOT_POP
      }
    }
  }
}

// Evaluate the program over one 16-byte word group `off` of every leaf,
// P instructions at a time: the loads of a window's leaf-reading
// instructions are all issued before any of them is combined (a leaf
// load never depends on the running value), so P loads a thread are in
// flight where eval_program_u keeps one instruction's. This is the
// materializing interpreter (expr_words.cu): at one slice row a
// 1000-leaf fold has too few word groups to hide a load's latency any
// other way. `stack` holds MAX_STACK groups.
template <int P, int STAGED>
__device__ __forceinline__ uint4 eval_program_window(
    const StagedProgram<STAGED>& sp_prog, const int2* __restrict__ prog,
    int n_ins, const long long* __restrict__ ptrs, size_t off,
    uint4* stack) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 acc = zero;
  int sp = 0;
  for (int k0 = 0; k0 < n_ins; k0 += P) {
    int op[P];
    uint4 v[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      op[j] = -1;
      v[j] = zero;
      if (k0 + j < n_ins) {
        const uint4* base;
        op[j] = sp_prog.fetch(prog, ptrs, k0 + j, &base);
        if (op[j] < OP_PUSH) v[j] = __ldg(base + off);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      switch (op[j]) {
        case OP_LOAD: acc = v[j]; break;
        case OP_AND_LEAF: acc = and4(acc, v[j]); break;
        case OP_OR_LEAF: acc = or4(acc, v[j]); break;
        case OP_XOR_LEAF: acc = xor4(acc, v[j]); break;
        case OP_ANDNOT_LEAF: acc = andnot4(acc, v[j]); break;
        case OP_RANDNOT_LEAF: acc = andnot4(v[j], acc); break;
        case OP_PUSH: stack[sp++] = acc; break;
        case OP_AND_POP: acc = and4(stack[--sp], acc); break;
        case OP_OR_POP: acc = or4(stack[--sp], acc); break;
        case OP_XOR_POP: acc = xor4(stack[--sp], acc); break;
        case OP_ANDNOT_POP: acc = andnot4(stack[--sp], acc); break;
        case OP_RANDNOT_POP: acc = andnot4(acc, stack[--sp]); break;
        default: break;  // past the program's end
      }
    }
  }
  return acc;
}

// Sum `v` over the block; the result is valid in thread 0.
template <int BLOCK>
__device__ __forceinline__ int block_sum(int v, int* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0;
  if (threadIdx.x < BLOCK / 32) v = smem[threadIdx.x];
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

}  // namespace pilosa
