// Bundle adjustment's adjoint scatter (K2) and point gather (K3) on Hopper (sm_90a).
//
// K2 replaces the Pallas TPU kernel dvm_slam_tpu/ops/pallas_scatter.py::_adjoint_kernel
// (wrapper `onehot_adjoint_pallas`):
//   out[l,g,p] = sum_f vals[l,g,f] * (pidx[l,f] == p)
// with pidx < 0 or >= P contributing nothing and duplicate indices accumulating.
// On the TPU that is a one-hot matmul whose tiles are built in VMEM for the MXU.
// On a GPU it is a segmented scatter-add, and no one-hot is built. Each output
// element is summed by one thread from 0 in ascending f, with no float
// atomics, so the result is the same on every run, and the same as the first
// port of this kernel's, which added in that order too.
//
// What bounds it: at the System's BA window (L=32, G=30, F=512, P=4096) it
// must write the 15.73 MB output and read 1.97 MB of values and 0.07 MB of
// indices, 17.76 MB in all: 5.30 us at 3.35 TB/s. The ~15k additions are
// nothing. The first port took 47 us on the device at every L, so a chain of
// dependent steps per block, not the bytes, set its time: each block staged
// all 30 planes of its row (64 KB; 32 MB of L2 reads per call) in 16
// dependent loads a thread per chunk of 8 planes, and every thread scanned
// the whole hit list (O(256 n)). This design keeps a block's chain to two
// round trips to memory and then writes the output once, coalesced:
//
// One block of 4 warps per (row l, tile of 128 columns); warp w sums the
// tile's columns c with c % 4 == w. A warp
//  1. loads the row's 512 indices at once (16 a lane) and compacts, in
//     ascending f, the features whose index falls on one of its columns
//     (ballots), while the block zeroes a [128 columns, 32 planes] tile of
//     sums in shared memory;
//  2. loads, per 32 of those features, plane j of each on lane j, all loads
//     in flight. `bundle_adjust` stores its values feature-major ([L,F,30])
//     and hands them over as an [L,G,F] view, so one feature's 30 planes are
//     one 128-byte line: a gather of whole lines, 1/32 of the sectors that
//     plane-major values cost;
//  3. adds them, in ascending f, to its plane of their columns in the tile
//     (a run of features on one column in a register): every lane runs the
//     same loop, and each column's sum is the ascending-f sum, with no sort;
//  4. after the block's barrier, writes planes w, w + 4, ... of the tile,
//     zeros included, one float4 per lane.
// The tile's layout (tile_at) keeps both the adds and the 16-byte reads free
// of bank conflicts. A block uses 24 KB of static shared memory (no attribute
// call; all 1024 blocks of L=32 run at once); at L=8 the grid is 256 blocks,
// so even the init BA fills the 132 SMs. Longer rows are compacted in chunks of 512
// features and more than 32 planes summed in groups: each keeps ascending f.
//
// K3 replaces dvm_slam_tpu/ops/pallas_scatter.py::_gather_kernel (wrapper
// `onehot_gather_pallas`): out[l,g,f] = pts[g, pidx[l,f]], and 0 where pidx is
// outside [0, P). A pure copy, bit-identical to the plain row gather. At L=32,
// F=512 it moves 0.31 MB (0.09 us at 3.35 TB/s), far under any launch, so it
// is built to cost no more than its launch: one thread per row l and four
// consecutive f, one 16-byte load of the indices, `pts` read through the
// read-only path, one 16-byte store per plane (a scalar tail when F or the
// index pointer does not allow it).
//
// C interface (ctypes): each entry returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kVec = 4;                  // columns per lane in the stores: 16 bytes a plane
constexpr int kTile = kLanes * kVec;     // 128 columns per warp
constexpr int kFChunk = 512;             // features compacted per pass
constexpr int kLoads = kFChunk / kLanes; // index loads a lane keeps in flight
constexpr int kGGroup = kLanes;          // value planes summed per pass: lane j sums plane j
constexpr int kHitCap = 32;              // features whose values a lane holds at once
constexpr int kWarps = 4;                // warps per tile; warp w sums the columns c % 4 == w

// Position of (plane j, column c) in the tile of sums: column c's 32 planes
// fill one 128-byte row, plane j at slot j ^ (c / 4). The 32 lanes adding
// their planes to one column hit 32 banks, and so do the lanes reading one
// plane of columns 4t + v (lane t, v fixed) for the 16-byte stores.
__device__ __forceinline__ int tile_at(int j, int c) {
  return c * kGGroup + (j ^ (c >> 2));
}

// Compacts, in ascending f, the features u * 32 + lane of a chunk whose index
// p[u] falls in [p0, p_end) on a column c with c % kWarps == warp into hit[]
// as (column << 16) | (f - f0). Returns their number. Called by a whole warp.
__device__ int compact_hits(const int (&p)[kLoads], int p0, int p_end, int warp, int* hit) {
  const int lane = threadIdx.x & (kLanes - 1);
  int n = 0;
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int c = p[u] - p0;
    const bool in = p[u] >= p0 && p[u] < p_end && (c & (kWarps - 1)) == warp;
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    if (in) hit[n + __popc(mask & ((1u << lane) - 1u))] = (c << 16) | (u * kLanes + lane);
    n += __popc(mask);
  }
  __syncwarp();
  return n;
}

__global__ void __launch_bounds__(kLanes * kWarps)
onehot_adjoint_kernel(const float* __restrict__ vals, const int* __restrict__ pidx,
                      float* __restrict__ out, int G, int F, int P,
                      int64_t sL, int64_t sG, int64_t sF) {
  __shared__ int s_hit[kWarps][kFChunk];
  __shared__ __align__(16) float s_out[kTile * kGGroup];   // the tile's sums, at tile_at(j, c)

  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x >> 5;
  const int l = blockIdx.y;
  const int p0 = blockIdx.x * kTile;
  const int p_end = min(p0 + kTile, P);
  const int c0 = lane * kVec;                  // this lane's first column in the stores
  const int* row = pidx + static_cast<int64_t>(l) * F;
  float* orow = out + static_cast<int64_t>(l) * G * P + p0 + c0;
  const bool vec = (P % kVec) == 0 && p0 + c0 + kVec <= P;
  int* hit = s_hit[warp];

  for (int gb = 0; gb < G; gb += kGGroup) {
    const int gn = min(kGGroup, G - gb);
    const float* vplane = vals + l * sL + (gb + lane) * sG;   // lane j's plane, gb + j
    for (int f0 = 0; f0 < F; f0 += kFChunk) {
      int p[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {   // the chunk's indices, all loads in flight
        const int f = f0 + u * kLanes + lane;
        p[u] = f < F ? __ldg(row + f) : -1;
      }
      if (f0 == 0) {  // zero the sums while the loads are in flight
        for (int i = threadIdx.x; i < kTile * kGGroup / 4; i += kLanes * kWarps) {
          reinterpret_cast<float4*>(s_out)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      const int n = compact_hits(p, p0, p_end, warp, hit);
      __syncthreads();  // the sums are zeroed
      for (int w0 = 0; w0 < n; w0 += kHitCap) {
        const int wn = min(kHitCap, n - w0);
        // lane j loads plane j of the warp's next 32 features, all in flight
        float x[kHitCap];
#pragma unroll
        for (int k = 0; k < kHitCap; ++k) {
          x[k] = (k < wn && lane < gn)
                     ? __ldg(vplane + static_cast<int64_t>(f0 + (hit[w0 + k] & 0xffff)) * sF)
                     : 0.f;
        }
        // and adds them to its plane of their columns in ascending f; a run
        // of features on one column is summed in a register
        int cur = hit[w0] >> 16;
        float acc = s_out[tile_at(lane, cur)];
#pragma unroll
        for (int k = 0; k < kHitCap; ++k) {
          if (k < wn) {
            const int c = hit[w0 + k] >> 16;
            if (c != cur) {
              s_out[tile_at(lane, cur)] = acc;
              cur = c;
              acc = s_out[tile_at(lane, c)];
            }
            acc += x[k];
          }
        }
        s_out[tile_at(lane, cur)] = acc;
        __syncwarp();  // hit is rewritten by the next chunk
      }
    }
    __syncthreads();  // every warp's sums are in

    // every output element is written, zeros where nothing landed; warp w
    // writes planes w, w + 4, ...
    for (int j = warp; j < gn; j += kWarps) {
      float4 a;
      a.x = s_out[tile_at(j, c0)];
      a.y = s_out[tile_at(j, c0 + 1)];
      a.z = s_out[tile_at(j, c0 + 2)];
      a.w = s_out[tile_at(j, c0 + 3)];
      float* dst = orow + static_cast<int64_t>(gb + j) * P;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = a;
      } else {
        const float e[kVec] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          if (p0 + c0 + v < P) dst[v] = e[v];
        }
      }
    }
    __syncthreads();  // s_out is zeroed for the next group of planes
  }
}

template <bool kVecIdx>
__global__ void __launch_bounds__(128)
onehot_gather_kernel(const float* __restrict__ pts, const int* __restrict__ pidx,
                     float* __restrict__ out, int L, int G, int F, int P) {
  const int nq = (F + kVec - 1) / kVec;            // groups of 4 features a row
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(L) * nq) return;
  const int64_t l = i / nq;
  const int f = static_cast<int>(i % nq) * kVec;
  const int* src = pidx + l * F + f;
  float* dst = out + l * G * F + f;
  if (kVecIdx) {  // F % 4 == 0 and a 16-byte aligned index row: vector loads and stores
    const int4 q = __ldg(reinterpret_cast<const int4*>(src));
    const bool ok0 = q.x >= 0 && q.x < P, ok1 = q.y >= 0 && q.y < P;
    const bool ok2 = q.z >= 0 && q.z < P, ok3 = q.w >= 0 && q.w < P;
    for (int g = 0; g < G; ++g) {
      const float* t = pts + static_cast<int64_t>(g) * P;
      *reinterpret_cast<float4*>(dst + static_cast<int64_t>(g) * F) =
          make_float4(ok0 ? __ldg(t + q.x) : 0.f, ok1 ? __ldg(t + q.y) : 0.f,
                      ok2 ? __ldg(t + q.z) : 0.f, ok3 ? __ldg(t + q.w) : 0.f);
    }
  } else {
    const int m = min(kVec, F - f);
    for (int v = 0; v < m; ++v) {
      const int p = __ldg(src + v);
      const bool ok = p >= 0 && p < P;
      for (int g = 0; g < G; ++g) {
        dst[static_cast<int64_t>(g) * F + v] = ok ? __ldg(pts + static_cast<int64_t>(g) * P + p) : 0.f;
      }
    }
  }
}

}  // namespace

extern "C" int onehot_adjoint(const void* vals, const void* pidx, void* out, int L, int G,
                              int F, int P, long long sL, long long sG, long long sF,
                              void* stream) {
  if (static_cast<int64_t>(L) * G * P > 0) {
    const dim3 grid((P + kTile - 1) / kTile, L);
    onehot_adjoint_kernel<<<grid, kLanes * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int*>(pidx),
        static_cast<float*>(out), G, F, P, sL, sG, sF);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int onehot_gather(const void* pts, const void* pidx, void* out, int L, int G,
                             int F, int P, void* stream) {
  const int64_t n = static_cast<int64_t>(L) * ((F + kVec - 1) / kVec);
  if (n * G > 0) {
    const int blocks = static_cast<int>((n + 127) / 128);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* p = static_cast<const float*>(pts);
    const auto* idx = static_cast<const int*>(pidx);
    auto* o = static_cast<float*>(out);
    if (F % kVec == 0 && (reinterpret_cast<uintptr_t>(pidx) & 15) == 0) {
      onehot_gather_kernel<true><<<blocks, 128, 0, st>>>(p, idx, o, L, G, F, P);
    } else {
      onehot_gather_kernel<false><<<blocks, 128, 0, st>>>(p, idx, o, L, G, F, P);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
