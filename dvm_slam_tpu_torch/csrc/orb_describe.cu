// Fused ORB orientation + steered rBRIEF, one CTA per keypoint (Hopper, sm_90a).
//
// Replaces the Pallas TPU kernel dvm_slam_tpu/ops/pallas_orb.py::_kernel
// (wrapper `orient_and_describe`). It computes what the XLA reference
// dvm_slam_tpu/ops/orb_descriptor.py::orient_and_describe computes:
//   * the intensity-centroid moments m01, m10 over the radius-15 circular mask
//     of the raw level, around the rounded centre clamped to
//     [15, W-16] x [15, H-16]; angle = atan2(m01, m10);
//   * 256 steered BRIEF tests on the blurred level: pattern offsets rotated by
//     (ca, sa) = (m10, m01) / |m|, rounded half to even, samples clamped to the
//     image edge; bit = v1 < v2.
// The TPU kernel's one-hot row/column matmuls and (8,128)-aligned DMA windows
// exist only for Mosaic; none of that is carried over.
//
// What bounds it on this card: latency and random shared-memory reads. Each
// keypoint reads ~2.4 KB (a 31x31 raw and a 39x39 blurred window) and writes
// 260 B, so the whole frame moves ~3 MB — nothing for HBM. One CTA per
// keypoint stages both windows in shared memory (~12 KB with the reduction
// buffers), so the 512 data-dependent samples of the descriptor never leave
// the SM.
//
// Bit parity with the plain PyTorch twin (ops/orb_descriptor.py):
//   * thread t sums patch elements t, t+256, t+512, t+768 in turn, then a
//     pairwise tree halves the 256 partial sums — the twin's
//     `_thread_tree_sum` performs the same additions in the same order;
//   * this file is compiled with --fmad=false, so a*b+c is never contracted
//     into an FMA (that would move the rotated offsets across .5 boundaries);
//   * rintf rounds half to even like torch.round (roundf would not).
//
// C interface (ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalf = 15;                    // orientation patch radius
constexpr int kPatch = 2 * kHalf + 1;        // 31
constexpr int kBHalf = 19;                   // BRIEF window radius (13*sqrt(2) < 19)
constexpr int kBPatch = 2 * kBHalf + 1;      // 39
constexpr int kThreads = 256;                // one thread per descriptor bit
constexpr int kRawN = kPatch * kPatch;       // 961
constexpr int kSlots = (kRawN + kThreads - 1) / kThreads;  // 4

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads)
orb_describe_kernel(const float* __restrict__ raw, const float* __restrict__ blur,
                    const float* __restrict__ xy, const int* __restrict__ pattern,
                    float* __restrict__ angle, uint8_t* __restrict__ desc,
                    int h, int w) {
  __shared__ float s_raw[kRawN];
  __shared__ float s_blur[kBPatch * kBPatch];
  __shared__ float s01[kThreads];
  __shared__ float s10[kThreads];

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int cx = static_cast<int>(rintf(xy[2 * k]));
  const int cy = static_cast<int>(rintf(xy[2 * k + 1]));
  const int mcx = clampi(cx, kHalf, w - kHalf - 1);
  const int mcy = clampi(cy, kHalf, h - kHalf - 1);

  // stage the windows; edge-clamped reads == the reference's index clipping
  for (int i = t; i < kRawN; i += kThreads) {
    const int r = clampi(mcy + i / kPatch - kHalf, 0, h - 1);
    const int c = clampi(mcx + i % kPatch - kHalf, 0, w - 1);
    s_raw[i] = raw[r * w + c];
  }
  for (int i = t; i < kBPatch * kBPatch; i += kThreads) {
    const int r = clampi(cy + i / kBPatch - kBHalf, 0, h - 1);
    const int c = clampi(cx + i % kBPatch - kBHalf, 0, w - 1);
    s_blur[i] = blur[r * w + c];
  }
  __syncthreads();

  // intensity-centroid moments over the circular mask
  float a01 = 0.f, a10 = 0.f;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = t + s * kThreads;
    if (i < kRawN) {
      const int yy = i / kPatch - kHalf;
      const int xx = i % kPatch - kHalf;
      const float m = (xx * xx + yy * yy <= kHalf * kHalf + 1) ? 1.f : 0.f;
      const float pm = s_raw[i] * m;
      a01 = a01 + pm * static_cast<float>(yy);
      a10 = a10 + pm * static_cast<float>(xx);
    }
  }
  s01[t] = a01;
  s10[t] = a10;
  __syncthreads();
  for (int width = kThreads / 2; width > 0; width >>= 1) {
    if (t < width) {
      s01[t] = s01[t] + s01[t + width];
      s10[t] = s10[t] + s10[t + width];
    }
    __syncthreads();
  }
  const float m01 = s01[0];
  const float m10 = s10[0];
  if (t == 0) angle[k] = atan2f(m01, m10);

  // steering direction straight from the moments (every thread, same value)
  const float rlen = sqrtf(m01 * m01 + m10 * m10);
  const bool safe = rlen > 1e-9f;
  const float inv = safe ? 1.f / rlen : 0.f;
  const float ca = safe ? m10 * inv : 1.f;
  const float sa = safe ? m01 * inv : 0.f;

  // thread t: BRIEF test t
  const float px1 = static_cast<float>(pattern[4 * t + 0]);
  const float py1 = static_cast<float>(pattern[4 * t + 1]);
  const float px2 = static_cast<float>(pattern[4 * t + 2]);
  const float py2 = static_cast<float>(pattern[4 * t + 3]);
  const int rx1 = clampi(static_cast<int>(rintf(px1 * ca - py1 * sa)), -kBHalf, kBHalf);
  const int ry1 = clampi(static_cast<int>(rintf(px1 * sa + py1 * ca)), -kBHalf, kBHalf);
  const int rx2 = clampi(static_cast<int>(rintf(px2 * ca - py2 * sa)), -kBHalf, kBHalf);
  const int ry2 = clampi(static_cast<int>(rintf(px2 * sa + py2 * ca)), -kBHalf, kBHalf);
  const float v1 = s_blur[(ry1 + kBHalf) * kBPatch + rx1 + kBHalf];
  const float v2 = s_blur[(ry2 + kBHalf) * kBPatch + rx2 + kBHalf];
  desc[static_cast<int64_t>(k) * kThreads + t] = v1 < v2 ? 1 : 0;
}

}  // namespace

extern "C" int orb_describe(const void* raw, const void* blur, const void* xy,
                            const void* pattern, void* angle, void* desc,
                            int n, int h, int w, void* stream) {
  if (n > 0) {
    orb_describe_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(raw), static_cast<const float*>(blur),
        static_cast<const float*>(xy), static_cast<const int*>(pattern),
        static_cast<float*>(angle), static_cast<uint8_t*>(desc), h, w);
  }
  return static_cast<int>(cudaGetLastError());
}
