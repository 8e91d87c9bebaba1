// Expression count: out[s] = sum(popcount(expr(leaves[:, s]))) for every
// slice row s.
//
// Replaces the TPU kernel expr_count_rows_pallas
// (pilosa_tpu/ops/pallas_kernels.py, wrapper :129-153, body :111-121),
// which the JAX serving path reaches through mesh._rows_popcount /
// _exprs_hi_lo.
//
// Bound: device-memory bytes. Each leaf word is read once and nothing
// but one int32 per slice row is written, so the least time is
// L * S * W * 4 bytes over 3.35 TB/s. Design: one CTA per slice row, in
// one launch. The CTA stages the program and its leaves' base pointers
// in shared memory (StagedProgram, expr_program.cuh), then each thread
// walks its share of the row U 16-byte word groups at a time: every
// instruction issues U independent coalesced loads (read-only path) and
// evaluates on U register accumulators (eval_program_u), so U groups of
// each leaf are in flight per thread and the decode is paid once for U.
// __popc per group, a warp-then-shared-memory reduce, and thread 0
// stores out[s]: each output written once, no memset, no atomics. At the
// serving shape (S = 256, W = 32768) two 512-thread CTAs fit an SM, so
// the grid runs in one wave. Exact in any order (integer sums).
//
// The batched entry (pilosa_expr_count_batch) is the counterpart of the
// JAX count batch, count_exprs_program / mesh._exprs_hi_lo
// (pilosa_tpu/parallel/programs.py:133, mesh.py:627-646): K programs
// over one shared leaf set in one launch, block s * K + k counting
// program k over row s, so the K CTAs of a row run together and a leaf
// row that several programs read (a filtered Sum's filter, a Count
// batch's common leaf) comes from device memory once and from the 50 MB
// L2 for the others. Its bound is the distinct leaves' bytes once. The
// single entry is the same kernel's K = 1 form, compiled without the
// offsets table (BATCH = false).
#include "expr_program.cuh"

namespace {

constexpr int BLOCK = 512;
constexpr int U = 4;         // word groups of each leaf in flight a thread
constexpr int STAGED = 512;  // instructions staged in shared memory

// BATCH = false is the single entry's code, unchanged by the batched one.
template <bool BATCH>
__global__ void __launch_bounds__(BLOCK, 2)
expr_count_kernel(const long long* __restrict__ ptrs,
                  const int2* __restrict__ prog,
                  const long long* __restrict__ offs, int n_ins,
                  int k_exprs, long long w4, int* __restrict__ out) {
  __shared__ pilosa::StagedProgram<STAGED> staged;
  __shared__ int smem[BLOCK / 32];
  uint4 stack[pilosa::MAX_STACK][U];
  // Block s * K + k counts program k over slice row s: the K programs
  // of one row run side by side, so a leaf row they share is read from
  // device memory once and from L2 after that.
  int k = 0;
  size_t s = blockIdx.x;
  if constexpr (BATCH) {
    k = static_cast<int>(blockIdx.x % k_exprs);
    s = blockIdx.x / k_exprs;
    prog += offs[k];
    n_ins = static_cast<int>(offs[k + 1] - offs[k]);
  }
  staged.stage(prog, n_ins, ptrs);
  const size_t row = s * static_cast<size_t>(w4);
  const size_t end = row + static_cast<size_t>(w4);
  int count = 0;
  for (size_t i = row + threadIdx.x; i < end;
       i += static_cast<size_t>(BLOCK) * U) {
    uint4 acc[U];
    pilosa::eval_program_u<U>(staged, prog, n_ins, ptrs, i, BLOCK, end,
                              acc, stack);
#pragma unroll
    for (int u = 0; u < U; ++u) count += pilosa::popc4(acc[u]);
  }
  count = pilosa::block_sum<BLOCK>(count, smem);
  if (threadIdx.x == 0) {
    if constexpr (BATCH) {
      out[static_cast<size_t>(k) * (gridDim.x / k_exprs) + s] = count;
    } else {
      out[s] = count;
    }
  }
}

}  // namespace

// ptrs: device array of n_leaves slab base pointers, each [n_slices, w]
// u32, 16-byte aligned; prog: device array of n_ins (opcode, arg) pairs;
// out: [n_slices] int32, every entry written. Returns the launch's
// cudaGetLastError().
extern "C" int pilosa_expr_count(const void* ptrs, const void* prog,
                                 int n_ins, long long n_slices, long long w,
                                 void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_slices == 0) return static_cast<int>(cudaGetLastError());
  if (n_slices > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  expr_count_kernel<false><<<static_cast<unsigned>(n_slices), BLOCK, 0,
                             st>>>(
      static_cast<const long long*>(ptrs), static_cast<const int2*>(prog),
      nullptr, n_ins, 1, w / 4, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The batched entry: K programs over one shared leaf set in one launch.
// prog: the K programs' (opcode, arg) pairs back to back; offs: K + 1
// device int64 offsets into prog (program k is prog[offs[k], offs[k+1]));
// out: [k_exprs, n_slices] int32, every entry written.
extern "C" int pilosa_expr_count_batch(const void* ptrs, const void* prog,
                                       const void* offs, int k_exprs,
                                       long long n_slices, long long w,
                                       void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_slices == 0 || k_exprs == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  if (k_exprs < 0 || n_slices * k_exprs > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  expr_count_kernel<true><<<static_cast<unsigned>(n_slices * k_exprs), BLOCK,
                            0, st>>>(
      static_cast<const long long*>(ptrs), static_cast<const int2*>(prog),
      static_cast<const long long*>(offs), 0, k_exprs, w / 4,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
