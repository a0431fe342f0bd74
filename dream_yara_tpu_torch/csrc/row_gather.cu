// Row gather on Hopper (sm_90a): out[i, :] = table[clamp(idx[i], 0, nb - 1), :].
//
// Replaces three TPU kernels that compute this one function and differ only
// in how they hid memory latency on the TPU:
//   tools/proto_pallas_rank.py::_vmem_kernel — the whole fused rank table
//     held in VMEM, one dynamic vector load per query;
//   tools/proto_pallas_rank.py::_dma_kernel — rows padded to 128 words,
//     fetched from HBM by waves of 16 row DMAs;
//   tools/proto_probe_dma.py::_ring_kernel — 512 B rows of a GiB-sized
//     table, with a ring of nbuf row DMAs kept in flight.
// In the port it serves the fused-row fetch of every FM rank query
// (ops/rank.py) and the block-row fetch of the blocked IBF classifier
// (ops/ibf_query.py). The plain edition is ops/row_gather.py.
//
// Bounds. The kernel moves 2 * Q * row_bytes bytes (read rows, write out),
// but what bounds it is the latency of Q random row fetches: a 4.35 MB
// fused table sits in the 50 MB L2, a 128 MiB or 1.5 GiB IBF table does
// not, and each row is one or a few 32 B sectors from a random place.
// Design. Each thread moves one 16-byte vector (int4) of one output row, so
// neighbouring threads read neighbouring addresses of a row (a 96 B fused
// row is 6 vectors, a 256 B or 512 B block row 16 or 32) and write `out`
// fully coalesced. Each thread issues UNROLL independent loads before its
// stores, and the grid is large, so many fetches are in flight on every SM:
// on Hopper, warps in flight do what the TPU's DMA ring did. The row width
// in vectors is a template constant for the three widths the port uses, so
// the row/column split is a multiply, not a division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr long long MAX_BLOCKS = 1LL << 20;  // the loop strides past this

template <typename Idx, int V>  // V: int4 vectors per row, 0 = runtime v_rt
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const int4* __restrict__ table, long long nb, int v_rt,
                  const Idx* __restrict__ idx, long long total,
                  int4* __restrict__ out) {
  const long long vpr = V > 0 ? V : v_rt;
  const long long step = static_cast<long long>(gridDim.x) * THREADS * UNROLL;
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS * UNROLL
                        + threadIdx.x;
       base < total; base += step) {
    int4 vals[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long t = base + static_cast<long long>(u) * THREADS;
      if (t < total) {
        const long long row = t / vpr;
        const long long col = t - row * vpr;
        long long r = static_cast<long long>(__ldg(idx + row));
        r = r < 0 ? 0 : (r >= nb ? nb - 1 : r);
        vals[u] = __ldg(table + r * vpr + col);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long t = base + static_cast<long long>(u) * THREADS;
      if (t < total) out[t] = vals[u];
    }
  }
}

template <typename Idx>
void launch(const int4* table, long long nb, int vpr, const Idx* idx,
            long long q, int4* out, cudaStream_t stream) {
  const long long total = q * vpr;
  long long blocks = (total + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (vpr) {
    case 6:
      row_gather_kernel<Idx, 6><<<grid, THREADS, 0, stream>>>(table, nb, vpr, idx, total, out);
      break;
    case 16:
      row_gather_kernel<Idx, 16><<<grid, THREADS, 0, stream>>>(table, nb, vpr, idx, total, out);
      break;
    case 32:
      row_gather_kernel<Idx, 32><<<grid, THREADS, 0, stream>>>(table, nb, vpr, idx, total, out);
      break;
    default:
      row_gather_kernel<Idx, 0><<<grid, THREADS, 0, stream>>>(table, nb, vpr, idx, total, out);
  }
}

}  // namespace

// table: (nb, row_bytes / 4) int32, 16-byte aligned, row_bytes a positive
// multiple of 16; idx: (q,) int32 (idx_bytes 4) or int64 (idx_bytes 8);
// out: (q, row_bytes / 4) int32, 16-byte aligned. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue (nothing launched) for
// arguments outside that contract.
extern "C" int dy_row_gather(const void* table, long long nb, int row_bytes,
                             const void* idx, int idx_bytes, long long q,
                             void* out, cudaStream_t stream) {
  if (nb <= 0 || q < 0 || row_bytes <= 0 || row_bytes % 16 != 0
      || (idx_bytes != 4 && idx_bytes != 8)
      || reinterpret_cast<uintptr_t>(table) % 16 != 0
      || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q == 0) return static_cast<int>(cudaSuccess);
  const int vpr = row_bytes / 16;
  const int4* tab = static_cast<const int4*>(table);
  int4* dst = static_cast<int4*>(out);
  if (idx_bytes == 4)
    launch<int32_t>(tab, nb, vpr, static_cast<const int32_t*>(idx), q, dst, stream);
  else
    launch<int64_t>(tab, nb, vpr, static_cast<const int64_t*>(idx), q, dst, stream);
  return static_cast<int>(cudaGetLastError());
}
