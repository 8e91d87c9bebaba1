// Expression words: out[s, w] = expr(leaves[:, s, w]) for every slice
// row s and word w — the materializing form of the expression count.
//
// Replaces the XLA programs materialize_program and bsi_range_program
// (pilosa_tpu/parallel/programs.py:265 and :282), which the JAX serving
// path reaches through mesh.materialize_expr_sharded (:1144) and
// mesh.bsi_range_sharded (:1164) for a bitmap-returning
// Union/Intersect/Difference of many leaves and for a field Range. The
// JAX package computes both outside Pallas; a torch fold here would be
// one elementwise launch a leaf (999 of them for a 1000-row Union).
//
// Bound: device-memory bytes. Every leaf word is read once and every
// output word written once, so the least time is (L + 1) * S * W * 4
// bytes over 3.35 TB/s. Every output word group is stored once: no
// memset, no atomics. Two designs:
//
// - Any program (pilosa_expr_words): one thread a 16-byte word group at
//   a time, the S * W / 4 groups of the output walked grid-stride by a
//   grid sized to the card (a few CTAs an SM). Each CTA stages the first
//   STAGED instructions and their leaves' base pointers in shared memory
//   once (StagedProgram; a longer program reads the rest from global
//   memory, no cap on its length), then each thread runs the program P
//   instructions at a time with the loads of a window issued together
//   (eval_program_window, expr_program.cuh). Small outputs take
//   64-thread CTAs, large ones 128.
// - A flat fold (pilosa_expr_fold_words): a load of leaf 0, then one
//   leaf opcode for every other leaf — a Union, Intersect, Xor or
//   Difference of rows. At one slice row (BASELINE configuration 2: one
//   slice, 1000 leaves) the output has only 8,192 word groups, too few
//   threads to keep the card's memory busy, so the LEAVES are split
//   too: a CTA of FOLD_WARPS warps takes 32 word groups (one a lane),
//   warp w folds its share of leaves 1..L-1 with FOLD_P loads in
//   flight, the partials meet in shared memory and warp 0 combines them
//   with leaf 0 (a Difference folds the rest with OR and stores
//   leaf0 & ~rest). It beats the first design at 256 slices too (a
//   16-leaf Union: 213 against 301 us on an H100 SXM, kernel_ab), so
//   every flat fold of more than FOLD_WARPS leaves takes it.
#include "expr_program.cuh"

namespace {

constexpr int MAX_BLOCK = 128;
constexpr int P = 16;          // instructions whose loads are in flight
constexpr int STAGED = 1024;   // instructions staged in shared memory
constexpr int CTAS_PER_SM = 8; // grid = at most this many CTAs an SM

__global__ void __launch_bounds__(MAX_BLOCK)
expr_words_kernel(const long long* __restrict__ ptrs,
                  const int2* __restrict__ prog, int n_ins,
                  long long n_groups, uint4* __restrict__ out) {
  __shared__ pilosa::StagedProgram<STAGED> staged;
  uint4 stack[pilosa::MAX_STACK];
  staged.stage(prog, n_ins, ptrs);
  // Leaves and output share the [S, W] layout: group g is word group
  // g % (W / 4) of slice row g / (W / 4) in every one of them.
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t g = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < static_cast<size_t>(n_groups); g += stride) {
    out[g] = pilosa::eval_program_window<P>(staged, prog, n_ins, ptrs, g,
                                            stack);
  }
}

constexpr int FOLD_WARPS = 8;   // warps a CTA, each a share of the leaves
constexpr int FOLD_P = 8;       // loads a lane has in flight
constexpr int FOLD_GROUPS = 32; // word groups a CTA: one a lane

// Fold of two word groups for the flat program of leaf opcode OP; the
// rest of a Difference folds with OR.
template <int OP>
__device__ __forceinline__ uint4 fold2(uint4 a, uint4 b) {
  if (OP == pilosa::OP_AND_LEAF) return pilosa::and4(a, b);
  if (OP == pilosa::OP_XOR_LEAF) return pilosa::xor4(a, b);
  return pilosa::or4(a, b);
}

template <int OP>
__global__ void __launch_bounds__(FOLD_WARPS * 32)
expr_fold_words_kernel(const long long* __restrict__ ptrs,
                       const int2* __restrict__ prog, int n_ins,
                       long long n_groups, uint4* __restrict__ out) {
  __shared__ const uint4* leaf[STAGED];
  __shared__ uint4 part[FOLD_WARPS][FOLD_GROUPS];
  const int staged = n_ins < STAGED ? n_ins : STAGED;
  for (int k = threadIdx.x; k < staged; k += blockDim.x) {
    leaf[k] = reinterpret_cast<const uint4*>(__ldg(ptrs + __ldg(prog + k).y));
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t g = static_cast<size_t>(blockIdx.x) * FOLD_GROUPS + lane;
  const bool live = g < static_cast<size_t>(n_groups);
  const uint4 ident = OP == pilosa::OP_AND_LEAF
                          ? make_uint4(~0u, ~0u, ~0u, ~0u)
                          : make_uint4(0u, 0u, 0u, 0u);
  // Warp w's share of instructions 1..n_ins-1.
  const long long rest = n_ins - 1;
  const int lo = 1 + static_cast<int>(rest * warp / FOLD_WARPS);
  const int hi = 1 + static_cast<int>(rest * (warp + 1) / FOLD_WARPS);
  uint4 acc = ident;
  if (live) {
    for (int k0 = lo; k0 < hi; k0 += FOLD_P) {
      uint4 v[FOLD_P];
#pragma unroll
      for (int j = 0; j < FOLD_P; ++j) {
        const int k = k0 + j;
        if (k < hi) {
          const uint4* base =
              k < STAGED ? leaf[k]
                         : reinterpret_cast<const uint4*>(
                               __ldg(ptrs + __ldg(prog + k).y));
          v[j] = __ldg(base + g);
        } else {
          v[j] = ident;
        }
      }
#pragma unroll
      for (int j = 0; j < FOLD_P; ++j) acc = fold2<OP>(acc, v[j]);
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && live) {
    const uint4 head = __ldg(leaf[0] + g);
#pragma unroll
    for (int w = 1; w < FOLD_WARPS; ++w) acc = fold2<OP>(acc, part[w][lane]);
    out[g] = OP == pilosa::OP_ANDNOT_LEAF ? pilosa::andnot4(head, acc)
                                          : fold2<OP>(head, acc);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0) {
      n = 132;  // H100 SXM
    }
  }
  return n;
}

}  // namespace

// ptrs: device array of n_leaves slab base pointers, each [n_slices, w]
// u32, 16-byte aligned; prog: device array of n_ins (opcode, arg) pairs;
// out: [n_slices, w] u32, 16-byte aligned, every word written. Returns
// the launch's cudaGetLastError().
extern "C" int pilosa_expr_words(const void* ptrs, const void* prog,
                                 int n_ins, long long n_slices, long long w,
                                 void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_groups = n_slices * (w / 4);
  if (n_groups == 0) return static_cast<int>(cudaGetLastError());
  const long long most = static_cast<long long>(sm_count()) * CTAS_PER_SM;
  const int block = n_groups >= most * MAX_BLOCK ? MAX_BLOCK : 64;
  long long grid = (n_groups + block - 1) / block;
  if (grid > most) grid = most;
  expr_words_kernel<<<static_cast<unsigned>(grid), block, 0, st>>>(
      static_cast<const long long*>(ptrs), static_cast<const int2*>(prog),
      n_ins, n_groups, static_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The flat-fold entry: prog is a load of leaf 0, then fold_op (one of
// OP_AND_LEAF, OP_OR_LEAF, OP_XOR_LEAF, OP_ANDNOT_LEAF) for every other
// instruction; the other arguments as for pilosa_expr_words. The
// leaf-split kernel takes a fold with at least FOLD_WARPS leaves past
// the first (a warp's share); a narrower one goes to pilosa_expr_words.
extern "C" int pilosa_expr_fold_words(const void* ptrs, const void* prog,
                                      int n_ins, int fold_op,
                                      long long n_slices, long long w,
                                      void* out, void* stream) {
  const long long n_groups = n_slices * (w / 4);
  if (n_groups == 0 || n_ins - 1 < FOLD_WARPS) {
    return pilosa_expr_words(ptrs, prog, n_ins, n_slices, w, out, stream);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid =
      static_cast<unsigned>((n_groups + FOLD_GROUPS - 1) / FOLD_GROUPS);
  const auto* p = static_cast<const long long*>(ptrs);
  const auto* ins = static_cast<const int2*>(prog);
  auto* o = static_cast<uint4*>(out);
  switch (fold_op) {
    case pilosa::OP_AND_LEAF:
      expr_fold_words_kernel<pilosa::OP_AND_LEAF>
          <<<grid, FOLD_WARPS * 32, 0, st>>>(p, ins, n_ins, n_groups, o);
      break;
    case pilosa::OP_OR_LEAF:
      expr_fold_words_kernel<pilosa::OP_OR_LEAF>
          <<<grid, FOLD_WARPS * 32, 0, st>>>(p, ins, n_ins, n_groups, o);
      break;
    case pilosa::OP_XOR_LEAF:
      expr_fold_words_kernel<pilosa::OP_XOR_LEAF>
          <<<grid, FOLD_WARPS * 32, 0, st>>>(p, ins, n_ins, n_groups, o);
      break;
    case pilosa::OP_ANDNOT_LEAF:
      expr_fold_words_kernel<pilosa::OP_ANDNOT_LEAF>
          <<<grid, FOLD_WARPS * 32, 0, st>>>(p, ins, n_ins, n_groups, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
