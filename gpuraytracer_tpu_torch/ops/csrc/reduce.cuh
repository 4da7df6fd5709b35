// Fixed-order reductions shared by the port's backward kernels (sm_90a):
// shade_bwd_kernel (shade_kernels.cu), mis_bwd_kernel (mis_bwd_kernels.cu)
// and soft_bwd_kernel (soft_kernels.cu).
//
// A backward kernel scatters per-lane cotangent rows into a per-primitive
// table and sums per-lane scalars.  It does so without float atomics, so that
// two launches on equal inputs give equal bits: the lanes of a warp that
// recorded the same primitive are summed by a butterfly of shuffles and added
// by one lane to that warp's own copy of the table in shared memory; warps are
// then summed in index order into one partial per block, and
// reduce_partials_kernel sums the partials in block order in float64.  The
// grouped backwards keep one table per warp in global memory instead, on a
// persistent grid that persistent_blocks sizes; mis_bwd_grouped_kernel
// scatters by warp_scatter_peers, and so do shade_bwd_kernel and its grouped
// tier (shade_kernels.cu says why).
#pragma once

#include <cuda_runtime.h>

#include "occupancy.cuh"

namespace grt {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int REDUCE_X = 32;  // reduce_partials_kernel: elements per block
constexpr int REDUCE_Y = 8;   //   and block-strided partial sums per element

__device__ __forceinline__ float warp_sum(float v) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(FULL_MASK, v, m);
  return v;
}

// Adds row[0 .. NCOL) of every lane with `act` to table[key * NCOL ...], the
// lanes that share a key summed first, one key at a time in the order of the
// lowest lane that holds it.  `rem` is __ballot_sync(FULL_MASK, act), which
// the caller may already hold.  Every lane of the warp must call it.
template <int NCOL>
__device__ __forceinline__ void warp_scatter_rows(unsigned rem, bool act, int key,
                                                  const float* row, float* table,
                                                  int lane) {
  while (rem != 0u) {
    const int leader = __ffs(rem) - 1;
    const int k = __shfl_sync(FULL_MASK, key, leader);
    const bool mine = act && (key == k);
    rem &= ~__ballot_sync(FULL_MASK, mine);
    for (int c = 0; c < NCOL; ++c) {
      const float v = warp_sum(mine ? row[c] : 0.0f);
      if (lane == leader) table[k * NCOL + c] += v;
    }
  }
}

// The grouped backward's scatter: adds row[0 .. NCOL) of every lane with
// `act` to table[key * NCOL ...] without shuffles.  __match_any_sync groups
// the lanes by key; the lowest lane of a group sums the group's rows in lane
// order, reading the other lanes' rows from shared memory (`row` is this
// lane's, lane l's lies at row + (l - lane) * stride), and adds the sum once;
// a lane alone with its key adds its own row.  The leaders of a warp's groups
// run side by side.  Every lane of the warp must call it after writing its
// row; the caller orders the adds before the next scatter (__syncwarp).
template <int NCOL>
__device__ __forceinline__ void warp_scatter_peers(bool act, int key, const float* row,
                                                   int stride, float* table, int lane) {
  const unsigned peers = __match_any_sync(FULL_MASK, act ? key : -1);
  __syncwarp();  // the rows are written
  if (!act || lane != __ffs(peers) - 1) return;
  float sum[NCOL];
  for (int c = 0; c < NCOL; ++c) sum[c] = row[c];
  for (unsigned m = peers & (peers - 1u); m != 0u; m &= m - 1u) {
    const float* r = row + (__ffs(m) - 1 - lane) * stride;
    for (int c = 0; c < NCOL; ++c) sum[c] += r[c];
  }
  float* dst = table + key * NCOL;
  for (int c = 0; c < NCOL; ++c) dst[c] += sum[c];
}

// Sums the per-block partials [blocks, count] into out [count], in block
// order, in float64: element e is the sum over y of the sums of blocks
// y, y + REDUCE_Y, ... — the same order on every launch.
__global__ void __launch_bounds__(REDUCE_X * REDUCE_Y)
reduce_partials_kernel(const float* __restrict__ partials, int blocks, int count,
                       float* __restrict__ out) {
  __shared__ double s_sum[REDUCE_Y][REDUCE_X];
  const int e = blockIdx.x * REDUCE_X + threadIdx.x;
  double acc = 0.0;
  if (e < count) {
    for (int b = threadIdx.y; b < blocks; b += REDUCE_Y) {
      acc += (double)partials[(size_t)b * count + e];
    }
  }
  s_sum[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < count) {
    double total = 0.0;
    for (int y = 0; y < REDUCE_Y; ++y) total += s_sum[y][threadIdx.x];
    out[e] = (float)total;
  }
}

// Launches reduce_partials_kernel on `stream` for [blocks, count] partials.
inline void launch_reduce_partials(const float* partials, int blocks, int count,
                                   float* out, cudaStream_t stream) {
  const dim3 rblock(REDUCE_X, REDUCE_Y);
  reduce_partials_kernel<<<(count + REDUCE_X - 1) / REDUCE_X, rblock, 0, stream>>>(
      partials, blocks, count, out);
}

// Blocks of a grouped backward's persistent grid on the current device, for
// blocks of `threads` threads with `smem` bytes of dynamic shared memory: the
// blocks the card holds at once, at most one per threads / 32 of the `tiles`
// 32-item tiles, and at most as many as keep one table of `row_floats` floats
// per warp within `table_bytes`.  0 means the occupancy query failed.
template <class Kernel>
inline int persistent_blocks(Kernel kernel, int threads, size_t smem, int tiles,
                             size_t row_floats, size_t table_bytes = (size_t)1 << 30) {
  int dev = 0, sms = 0;
  const int per_sm = blocks_per_sm(kernel, threads, smem);
  if (per_sm <= 0 || cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
      || sms <= 0) {
    return 0;
  }
  const int warps = threads / 32;
  const size_t cap = table_bytes / (sizeof(float) * warps * row_floats);
  int blocks = sms * per_sm;
  if (blocks > (tiles + warps - 1) / warps) blocks = (tiles + warps - 1) / warps;
  if ((size_t)blocks > cap) blocks = (int)cap;
  return blocks > 0 ? blocks : 1;
}

}  // namespace grt
