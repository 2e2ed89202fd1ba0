// Fused ORB orientation + steered rBRIEF for every pyramid level of a frame
// in one launch, one warp per keypoint (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel dvm_slam_tpu/ops/pallas_orb.py:55 `_kernel`
// (wrapper `orient_and_describe`), which runs once per pyramid level. It
// computes what the XLA reference dvm_slam_tpu/ops/orb_descriptor.py::
// orient_and_describe computes, for each level in turn:
//   * the intensity-centroid moments m01, m10 over the radius-15 circular mask
//     (x^2 + y^2 <= 226) of the raw level, around the rounded centre clamped
//     to [15, W-16] x [15, H-16]; angle = atan2(m01, m10);
//   * 256 steered BRIEF tests on the blurred level: pattern offsets rotated by
//     (ca, sa) = (m10, m01) / |m|, rounded half to even, samples taken around
//     the UNCLAMPED rounded centre and clamped to the image edge; bit = v1 < v2.
// The TPU kernel's one-hot row/column matmuls and (8,128)-aligned DMA windows
// exist only for Mosaic; none of that is carried over.
//
// What bounds it on this card: latency, not bytes. A frame of 8 levels at
// 600x350 (1,250 keypoint slots) moves ~5.5 MB, under 2 us of HBM time, and
// the images sit in L2. A launch per level costs ~4 us of launch and tail
// each, and a 256-thread block per keypoint would sum its moments through 8
// barrier-separated tree steps. So:
//   * one launch per frame: the levels' pointers, sizes and keypoint offsets
//     travel by value in a kernel parameter (no upload, no sync), and each
//     keypoint finds its level from the offsets;
//   * one warp per keypoint, 4 per block, so a frame's keypoints fill the 132
//     SMs in a single wave; no block-wide barrier and no shared memory;
//   * the raw window is read straight from global memory (each element once,
//     32 consecutive elements per load), and so are the 512 data-dependent
//     BRIEF samples of the blurred level: they fall in a 37x37 window that L1
//     holds, and staging the 39x39 window in shared memory first cost more
//     (1,521 loads a keypoint instead of 512) than it saved.
//
// Bit parity with the plain PyTorch twin (ops/orb_descriptor.py), which sums
// the moments in the order of 256 threads, one per descriptor bit:
//   * lane l plays the threads t = l + 32j, j = 0..7: it sums patch
//     elements t, t+256, t+512, t+768 in turn; the tree steps of width 128,
//     64 and 32 pair j with j+4, j+2 and j+1 in registers, and the steps of
//     width 16..1 are __shfl_down_sync. These are the additions of the twin's
//     `_thread_tree_sum`, in its order;
//   * this file is compiled with --fmad=false, so a*b+c is never contracted
//     into an FMA (that would move the rotated offsets across .5 boundaries);
//   * rintf rounds half to even like torch.round (roundf would not).
// Lane l runs BRIEF tests l + 32j, so each of its 8 byte stores is part of one
// 32-byte coalesced store of the warp.
//
// C interface (ctypes): returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a level count outside [1, 64].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 64 levels hold 8 frames of 8 levels: `extract_batch` describes every
// agent's frame in one launch. The table travels by value (about 1.8 KB at
// 64 levels, under the 4 KB kernel-parameter limit).
constexpr int kMaxLevels = 64;
constexpr int kHalf = 15;                    // orientation patch radius
constexpr int kPatch = 2 * kHalf + 1;        // 31
constexpr int kBits = 256;                   // descriptor bits = threads of the twin's order
constexpr int kLanes = 32;
constexpr int kVirt = kBits / kLanes;        // 8 virtual threads per lane
constexpr int kRawN = kPatch * kPatch;       // 961
constexpr int kSlots = (kRawN + kBits - 1) / kBits;  // 4
constexpr int kWarps = 4;                    // keypoints per block
constexpr unsigned kFull = 0xffffffffu;

struct LevelTable {
  const float* raw[kMaxLevels];
  const float* blur[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels + 1];  // keypoint k lies on level lv iff start[lv] <= k < start[lv+1]
  int n_levels;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kWarps * kLanes)
orb_describe_levels_kernel(const LevelTable table, const float* __restrict__ xy,
                           const int4* __restrict__ pattern, float* __restrict__ angle,
                           uint8_t* __restrict__ desc, int n) {
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= n) return;  // whole warps leave; only warp-level syncs follow

  // the keypoint's level: the last level whose range starts at or before k
  // (empty levels are passed over); fields picked with constant indices so
  // the table stays in parameter space
  int lv = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) lv += (i < table.n_levels && table.start[i] <= k) ? 1 : 0;
  const float* raw = table.raw[0];
  const float* blur = table.blur[0];
  int h = table.h[0], w = table.w[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (lv == i) {
      raw = table.raw[i];
      blur = table.blur[i];
      h = table.h[i];
      w = table.w[i];
    }
  }

  const int cx = static_cast<int>(rintf(xy[2 * k]));
  const int cy = static_cast<int>(rintf(xy[2 * k + 1]));

  // intensity-centroid moments over the circular mask; the clamped window
  // lies inside the level (the wrapper takes levels of at least 31x31)
  const int mcx = clampi(cx, kHalf, w - kHalf - 1);
  const int mcy = clampi(cy, kHalf, h - kHalf - 1);
  const float* win = raw + (mcy - kHalf) * w + (mcx - kHalf);
  float a01[kVirt], a10[kVirt];
#pragma unroll
  for (int j = 0; j < kVirt; ++j) {
    float s01 = 0.f, s10 = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int i = lane + kLanes * j + kBits * s;
      if (i < kRawN) {
        const int yy = i / kPatch - kHalf;
        const int xx = i % kPatch - kHalf;
        const float m = (xx * xx + yy * yy <= kHalf * kHalf + 1) ? 1.f : 0.f;
        const float pm = win[(yy + kHalf) * w + xx + kHalf] * m;
        s01 = s01 + pm * static_cast<float>(yy);
        s10 = s10 + pm * static_cast<float>(xx);
      }
    }
    a01[j] = s01;
    a10[j] = s10;
  }
  // tree steps of width 128, 64, 32: virtual thread t = l + 32j takes t + width
#pragma unroll
  for (int half = kVirt / 2; half > 0; half >>= 1) {
#pragma unroll
    for (int j = 0; j < half; ++j) {
      a01[j] = a01[j] + a01[j + half];
      a10[j] = a10[j] + a10[j + half];
    }
  }
  // widths 16..1 across lanes; lane 0 ends with the sum
  float m01 = a01[0], m10 = a10[0];
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    m01 = m01 + __shfl_down_sync(kFull, m01, off);
    m10 = m10 + __shfl_down_sync(kFull, m10, off);
  }
  m01 = __shfl_sync(kFull, m01, 0);
  m10 = __shfl_sync(kFull, m10, 0);
  if (lane == 0) angle[k] = atan2f(m01, m10);

  // steering direction straight from the moments (every lane, same value)
  const float rlen = sqrtf(m01 * m01 + m10 * m10);
  const bool safe = rlen > 1e-9f;
  const float inv = safe ? 1.f / rlen : 0.f;
  const float ca = safe ? m10 * inv : 1.f;
  const float sa = safe ? m01 * inv : 0.f;

  uint8_t* out = desc + static_cast<int64_t>(k) * kBits;
#pragma unroll
  for (int j = 0; j < kVirt; ++j) {
    const int b = lane + kLanes * j;
    const int4 q = pattern[b];
    const float px1 = static_cast<float>(q.x), py1 = static_cast<float>(q.y);
    const float px2 = static_cast<float>(q.z), py2 = static_cast<float>(q.w);
    // row offset = round(x sin + y cos), column offset = round(x cos - y sin),
    // each sample clamped to the image around the unclamped centre
    const int rx1 = static_cast<int>(rintf(px1 * ca - py1 * sa));
    const int ry1 = static_cast<int>(rintf(px1 * sa + py1 * ca));
    const int rx2 = static_cast<int>(rintf(px2 * ca - py2 * sa));
    const int ry2 = static_cast<int>(rintf(px2 * sa + py2 * ca));
    const float v1 = blur[clampi(cy + ry1, 0, h - 1) * w + clampi(cx + rx1, 0, w - 1)];
    const float v2 = blur[clampi(cy + ry2, 0, h - 1) * w + clampi(cx + rx2, 0, w - 1)];
    out[b] = v1 < v2 ? 1 : 0;
  }
}

}  // namespace

// `table` holds 5 * n_levels + 1 values: the raw pointers, the
// blurred pointers, the heights, the widths, then the keypoint offsets
// (offsets[0] = 0, offsets[n_levels] = n). xy is [n,2] f32, pattern [256,4]
// i32, angle [n] f32 and desc [n,256] u8, all contiguous on one device.
extern "C" int orb_describe_levels(const long long* table, int n_levels, const void* xy,
                                   const void* pattern, void* angle, void* desc, int n,
                                   void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  LevelTable t = {};
  for (int i = 0; i < n_levels; ++i) {
    t.raw[i] = reinterpret_cast<const float*>(table[i]);
    t.blur[i] = reinterpret_cast<const float*>(table[n_levels + i]);
    t.h[i] = static_cast<int>(table[2 * n_levels + i]);
    t.w[i] = static_cast<int>(table[3 * n_levels + i]);
  }
  for (int i = 0; i <= n_levels; ++i) t.start[i] = static_cast<int>(table[4 * n_levels + i]);
  t.n_levels = n_levels;
  if (n > 0) {
    const int blocks = (n + kWarps - 1) / kWarps;
    orb_describe_levels_kernel<<<blocks, kWarps * kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        t, static_cast<const float*>(xy), static_cast<const int4*>(pattern),
        static_cast<float*>(angle), static_cast<uint8_t*>(desc), n);
  }
  return static_cast<int>(cudaGetLastError());
}
