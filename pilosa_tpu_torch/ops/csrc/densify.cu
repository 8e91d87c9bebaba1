// Densify: bucketed sparse (lane, value) slots -> dense u32 words.
//
// Replaces the TPU kernel densify_pallas
// (pilosa_tpu/ops/pallas_kernels.py, wrapper :294-339, body :283-291),
// the cold upload of sparse rows (parallel.residency leaf_slab /
// candidate_block -> mesh.densify_sharded).
//
// Input contract (unchanged, ops/packed.py bucket_prepared): lane and val
// are [T, subs, G] u32; slot g of 128-word group s of row t holds one set
// word's lane (0-127) and value; val == 0 slots are padding. Within a
// group every nonzero slot names a distinct word, so each store lands on
// its own word and plain stores suffice — the TPU's one-hot OR passes
// (Mosaic had no dynamic lane access) become a direct scatter here.
//
// Bound: device-memory bytes: the slots are read once (8 bytes each) and
// the dense block written once (T * subs * 128 * 4 bytes), so the least
// time is their sum over 3.35 TB/s. Design, as the TPU kernel builds each
// output tile in fast memory and writes it once: the T * subs groups lie
// in order in both the slots and the output, and a CTA owns a tile of
// TILE whole groups of them. It zeroes the tile in shared memory, reads
// the tile's slots (one contiguous run of u32s, coalesced), stores each
// nonzero value at its lane of its group, and after a barrier writes the
// tile out with coalesced 16-byte stores. Each slot is read once and each
// output word written once, in one launch with no memset. Any T and subs
// (the last tile may be partial) and any G (G = 0 writes zeros).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int LANES = 128;             // words of a bucket group
constexpr int TILE = 32;               // groups of a CTA's tile
constexpr int TILE_WORDS = TILE * LANES;  // 16 KiB of shared memory

__global__ void __launch_bounds__(BLOCK)
densify_kernel(const unsigned* __restrict__ lane,
               const unsigned* __restrict__ val, long long n_groups,
               unsigned g_slots, unsigned* __restrict__ out) {
  __shared__ uint4 tile4[TILE_WORDS / 4];
  unsigned* tile = reinterpret_cast<unsigned*>(tile4);
  const long long group0 = static_cast<long long>(blockIdx.x) * TILE;
  const int n = n_groups - group0 < TILE ? static_cast<int>(n_groups - group0)
                                         : TILE;

  for (int k = threadIdx.x; k < n * (LANES / 4); k += BLOCK)
    tile4[k] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  const long long slot0 = group0 * g_slots;
  const unsigned n_slots = static_cast<unsigned>(n) * g_slots;
  for (unsigned k = threadIdx.x; k < n_slots; k += BLOCK) {
    const unsigned v = __ldg(val + slot0 + k);
    const unsigned l = __ldg(lane + slot0 + k) & (LANES - 1);
    if (v != 0u) tile[(k / g_slots) * LANES + l] = v;
  }
  __syncthreads();

  uint4* dst = reinterpret_cast<uint4*>(out) + group0 * (LANES / 4);
  for (int k = threadIdx.x; k < n * (LANES / 4); k += BLOCK)
    dst[k] = tile4[k];
}

}  // namespace

// lane, val: [t_rows, subs, g_slots] u32; out: [t_rows, subs * 128] u32,
// 16-byte aligned. Returns the launch's cudaGetLastError().
extern "C" int pilosa_densify(const void* lane, const void* val,
                              long long t_rows, long long subs,
                              long long g_slots, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_groups = t_rows * subs;
  if (n_groups == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (n_groups + TILE - 1) / TILE;
  if (blocks > 0x7fffffffLL || g_slots * TILE > 0xffffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  densify_kernel<<<static_cast<unsigned>(blocks), BLOCK, 0, st>>>(
      static_cast<const unsigned*>(lane), static_cast<const unsigned*>(val),
      n_groups, static_cast<unsigned>(g_slots), static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
