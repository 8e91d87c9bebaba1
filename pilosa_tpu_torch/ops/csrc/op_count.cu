// Pairwise op count: out[r] = sum(popcount(a[r] OP b[r])) for every row r,
// OP in and/or/xor/andnot.
//
// Replaces the TPU kernel op_count_rows_pallas / _op_count_padded
// (pilosa_tpu/ops/pallas_kernels.py, pallas_call :86, body _count_kernel
// :68-77, wrapper :226-254), which the JAX package reaches through
// ops.kernels.op_count — the benchmark of record (bench.py) counts
// Intersect over 16 rows of 2^30 bits with it.
//
// Bound: device-memory bytes. Every word of a and b is read once and one
// int32 per row is written, so the least time is (2 * R * W * 4 + R * 4)
// bytes over 3.35 TB/s; the work per byte (one bitwise op and a quarter
// of a popcount per byte) is far below the card's compute rate. Design:
// the grid is (word chunk, row). A CTA owns CHUNK 16-byte word groups of
// one row; each thread keeps UNROLL independent `uint4` loads of each
// operand in flight (streaming loads: the data is read once), applies OP
// and __popc, and the CTA reduces in the warp and then in shared memory
// before one integer atomicAdd into out[r] — exact in any order, since a
// row holds fewer than 2^31 bits (the wrapper checks). A single long row
// is spread over its chunks by the same grid: the TPU wrapper's fold into
// 8 rows existed only for tile padding and is not carried over.
//
// Alignment: rows need not start on 16 bytes (a row of W % 4 != 0 words,
// or a view at an odd word offset). Each row takes an aligned head: its
// first words up to the next 16-byte boundary, and the words after its
// last whole 16-byte group, are counted one 32-bit word at a time by the
// row's first CTA. This needs a and b to share their offset modulo 16
// bytes (then every row of both does); the wrapper raises otherwise and
// never copies. Right and simple first: TMA and persistent CTAs are
// later work.
#include "expr_program.cuh"

namespace {

constexpr int BLOCK = 256;
constexpr int UNROLL = 8;                      // uint4 loads per operand
constexpr long long CHUNK = BLOCK * UNROLL * 2;  // groups per CTA (64 KiB)
constexpr unsigned MAX_GRID_Y = 65535;

enum Op : int { OP_AND = 0, OP_OR = 1, OP_XOR = 2, OP_ANDNOT = 3 };

template <int OP>
__device__ __forceinline__ unsigned apply(unsigned a, unsigned b) {
  if (OP == OP_AND) return a & b;
  if (OP == OP_OR) return a | b;
  if (OP == OP_XOR) return a ^ b;
  return a & ~b;
}

template <int OP>
__device__ __forceinline__ int count4(uint4 a, uint4 b) {
  return __popc(apply<OP>(a.x, b.x)) + __popc(apply<OP>(a.y, b.y)) +
         __popc(apply<OP>(a.z, b.z)) + __popc(apply<OP>(a.w, b.w));
}

template <int OP>
__global__ void __launch_bounds__(BLOCK)
op_count_kernel(const unsigned* __restrict__ a, const unsigned* __restrict__ b,
                long long n_rows, long long w, int* __restrict__ out) {
  __shared__ int smem[BLOCK / 32];
  for (long long r = blockIdx.y; r < n_rows; r += gridDim.y) {
    const unsigned* ra = a + static_cast<size_t>(r) * static_cast<size_t>(w);
    const unsigned* rb = b + static_cast<size_t>(r) * static_cast<size_t>(w);
    // Words before the row's first 16-byte boundary (the same for b).
    long long head = ((16 - (reinterpret_cast<uintptr_t>(ra) & 15)) & 15) / 4;
    if (head > w) head = w;
    const long long n4 = (w - head) / 4;
    const uint4* va = reinterpret_cast<const uint4*>(ra + head);
    const uint4* vb = reinterpret_cast<const uint4*>(rb + head);
    const long long begin = static_cast<long long>(blockIdx.x) * CHUNK;
    const long long end = begin + CHUNK < n4 ? begin + CHUNK : n4;
    int count = 0;
    for (long long i0 = begin + threadIdx.x; i0 < end;
         i0 += static_cast<long long>(BLOCK) * UNROLL) {
      uint4 xa[UNROLL], xb[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const long long i = i0 + static_cast<long long>(k) * BLOCK;
        if (i < end) {
          xa[k] = __ldcs(va + i);
          xb[k] = __ldcs(vb + i);
        } else {
          xa[k] = make_uint4(0u, 0u, 0u, 0u);
          xb[k] = xa[k];
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) count += count4<OP>(xa[k], xb[k]);
    }
    if (blockIdx.x == 0) {
      // The scalar head and tail words of the row.
      const long long tail0 = head + 4 * n4;
      for (long long t = threadIdx.x; t < head; t += BLOCK)
        count += __popc(apply<OP>(__ldg(ra + t), __ldg(rb + t)));
      for (long long t = tail0 + threadIdx.x; t < w; t += BLOCK)
        count += __popc(apply<OP>(__ldg(ra + t), __ldg(rb + t)));
    }
    count = pilosa::block_sum<BLOCK>(count, smem);
    if (threadIdx.x == 0 && count) atomicAdd(out + r, count);
    __syncthreads();  // smem is reused by the next row's sum
  }
}

template <int OP>
cudaError_t launch(const void* a, const void* b, long long n_rows,
                   long long w, void* out, cudaStream_t st) {
  const long long chunks = (w / 4 + CHUNK - 1) / CHUNK;
  dim3 grid(static_cast<unsigned>(chunks > 0 ? chunks : 1),
            static_cast<unsigned>(n_rows < MAX_GRID_Y ? n_rows : MAX_GRID_Y));
  op_count_kernel<OP><<<grid, BLOCK, 0, st>>>(
      static_cast<const unsigned*>(a), static_cast<const unsigned*>(b),
      n_rows, w, static_cast<int*>(out));
  return cudaGetLastError();
}

}  // namespace

// a, b: [n_rows, w] u32, contiguous, with the same address modulo 16
// bytes; op: 0 and, 1 or, 2 xor, 3 andnot (a & ~b); out: [n_rows] int32.
// Returns the launch's cudaGetLastError() (cudaErrorInvalidValue for an
// unknown op).
extern "C" int pilosa_op_count(const void* a, const void* b, long long n_rows,
                               long long w, int op, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op < OP_AND || op > OP_ANDNOT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(out, 0, n_rows * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows == 0 || w == 0) return static_cast<int>(cudaGetLastError());
  switch (op) {
    case OP_AND: err = launch<OP_AND>(a, b, n_rows, w, out, st); break;
    case OP_OR: err = launch<OP_OR>(a, b, n_rows, w, out, st); break;
    case OP_XOR: err = launch<OP_XOR>(a, b, n_rows, w, out, st); break;
    default: err = launch<OP_ANDNOT>(a, b, n_rows, w, out, st); break;
  }
  return static_cast<int>(err);
}
