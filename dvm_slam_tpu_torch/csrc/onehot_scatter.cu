// Bundle adjustment's adjoint scatter (K2) and point gather (K3) on Hopper (sm_90a).
//
// K2 replaces the Pallas TPU kernel dvm_slam_tpu/ops/pallas_scatter.py::_adjoint_kernel
// (wrapper `onehot_adjoint_pallas`):
//   out[l,g,p] = sum_f vals[l,g,f] * (pidx[l,f] == p)
// with pidx < 0 or >= P contributing nothing and duplicate indices accumulating.
// On the TPU that is a one-hot matmul whose tiles are built in VMEM for the MXU.
// On a GPU it is a segmented scatter-add, and no one-hot is built. Each output
// element is owned by one thread and summed in ascending f, with no float
// atomics, so the result is the same on every run.
//
// Design: one block per (row l, tile of 256 columns); thread t owns column
// p0 + t for every plane g. The block first compacts, in ascending f, the
// features of row l whose index falls in its tile (warp ballots plus a prefix
// over the 8 warps). Then, for each chunk of 8 value planes, it stages
// vals[l, g0:g0+8, :] in shared memory with reads that coalesce along f, and
// each thread adds the staged values of the compacted features of its column.
// Every output element is written, zeros where nothing lands.
//
// What bounds it on this card: at BA's shapes (L=20, G=30, F=512, P=4096) it
// reads 1.2 MB (each of the 16 tiles of a row re-reads that row's values, from
// L2) and writes 9.8 MB, with ~15k additions in all. So it is bound by the
// write of the output and by launch latency, not by arithmetic; the writes
// are coalesced (consecutive threads, consecutive columns).
//
// K3 replaces dvm_slam_tpu/ops/pallas_scatter.py::_gather_kernel (wrapper
// `onehot_gather_pallas`): out[l,g,f] = pts[g, pidx[l,f]], and 0 where pidx is
// outside [0, P). One thread per (l, f) loops over g. It is a pure copy, bit
// identical to the plain row gather, and bound by launch latency (at L=20,
// F=512, G=3 it moves 123 KB out and reads at most as much).
//
// C interface (ctypes): each entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // columns per K2 tile, threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kGChunk = 8;             // value planes staged at once (ops/scatter_kernel.py G_CHUNK)

__global__ void __launch_bounds__(kThreads)
onehot_adjoint_kernel(const float* __restrict__ vals, const int* __restrict__ pidx,
                      float* __restrict__ out, int G, int F, int P) {
  extern __shared__ float smem[];
  float* s_vals = smem;                                          // [kGChunk][F]
  int* s_feat = reinterpret_cast<int*>(smem + kGChunk * F);      // [F] compacted f, ascending
  int* s_col = s_feat + F;                                       // [F] its column in the tile
  __shared__ int s_warp[kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int l = blockIdx.y;
  const int p0 = blockIdx.x * kThreads;
  const int p_end = min(p0 + kThreads, P);
  const int* row = pidx + static_cast<int64_t>(l) * F;

  // 1. ordered compaction of the features whose index falls in [p0, p_end)
  int n = 0;
  for (int base = 0; base < F; base += kThreads) {
    const int f = base + t;
    const int p = f < F ? row[f] : -1;
    const bool hit = p >= p0 && p < p_end;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int off = n, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (hit) {
      const int pos = off + __popc(mask & ((1u << lane) - 1u));
      s_feat[pos] = f;
      s_col[pos] = p - p0;
    }
    n += total;
    __syncthreads();  // s_warp is rewritten by the next round
  }

  // 2. per chunk of planes: stage the rows, then sum each column in ascending f
  const int p = p0 + t;
  for (int g0 = 0; g0 < G; g0 += kGChunk) {
    const int gn = min(kGChunk, G - g0);
    float acc[kGChunk];
#pragma unroll
    for (int j = 0; j < kGChunk; ++j) acc[j] = 0.f;
    if (n > 0) {  // uniform across the block
      const float* src = vals + (static_cast<int64_t>(l) * G + g0) * F;
      for (int i = t; i < gn * F; i += kThreads) s_vals[i] = src[i];
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        if (s_col[i] == t) {
          const int f = s_feat[i];
#pragma unroll
          for (int j = 0; j < kGChunk; ++j) {
            if (j < gn) acc[j] += s_vals[j * F + f];
          }
        }
      }
      __syncthreads();  // s_vals is rewritten by the next chunk
    }
    if (p < P) {
      float* dst = out + (static_cast<int64_t>(l) * G + g0) * P + p;
#pragma unroll
      for (int j = 0; j < kGChunk; ++j) {
        if (j < gn) dst[static_cast<int64_t>(j) * P] = acc[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
onehot_gather_kernel(const float* __restrict__ pts, const int* __restrict__ pidx,
                     float* __restrict__ out, int L, int G, int F, int P) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(L) * F) return;
  const int64_t l = i / F;
  const int64_t f = i % F;
  const int p = pidx[i];
  const bool ok = p >= 0 && p < P;
  float* dst = out + l * G * F + f;
  for (int g = 0; g < G; ++g) {
    dst[static_cast<int64_t>(g) * F] = ok ? pts[static_cast<int64_t>(g) * P + p] : 0.f;
  }
}

}  // namespace

extern "C" int onehot_adjoint(const void* vals, const void* pidx, void* out,
                              int L, int G, int F, int P, void* stream) {
  if (static_cast<int64_t>(L) * G * P > 0) {
    const size_t smem = static_cast<size_t>(kGChunk + 2) * F * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          onehot_adjoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid((P + kThreads - 1) / kThreads, L);
    onehot_adjoint_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int*>(pidx),
        static_cast<float*>(out), G, F, P);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int onehot_gather(const void* pts, const void* pidx, void* out,
                             int L, int G, int F, int P, void* stream) {
  const int64_t n = static_cast<int64_t>(L) * F;
  if (n * G > 0) {
    const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
    onehot_gather_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(pts), static_cast<const int*>(pidx),
        static_cast<float*>(out), L, G, F, P);
  }
  return static_cast<int>(cudaGetLastError());
}
