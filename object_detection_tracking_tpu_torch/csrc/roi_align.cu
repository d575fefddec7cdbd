// Multilevel FPN ROIAlign forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel object_detection_tracking_tpu/ops/pallas/
// roi_align_pallas.py (`_kernel` :138, launched by `_roi_align_levels`
// behind `multilevel_roi_align_pallas`). It computes exactly what the plain
// PyTorch `multilevel_roi_align` in ops/roi_align.py computes: per ROI, the
// canonical FPN level (passed in as int32, computed by the wrapper with the
// shared `fpn_map_rois_to_levels`, so the two versions cannot disagree at a
// floor(log2) boundary); a 2P x 2P grid of tf.crop_and_resize fpcoor
// samples (y(i) = y0 + sh * (i + 0.5) - 0.5, zero outside [0, H-1]); each
// sample bilinear over its 4 neighbours; the 2x2 mean; float32 out.
// Invalid (NMS-suppressed) slots write exact zeros.
//
// No level demotion: the Pallas kernel moves elongated boxes to a coarser
// level only because its fixed 40x48 VMEM window cannot hold them
// (roi_align_pallas.py:81-96, :475-493). This kernel reads device memory
// directly and has no window, so the demotion — a TPU workaround — is gone.
// The Pallas kernel also rounds its y-contraction back to bf16
// (:272-275); here every sum stays in float32.
//
// What bounds it on the H100: bytes. The least traffic is the float32
// output (8 x 1000 x 7 x 7 x 256 x 4 B = 401 MB at the main path's proposal
// launch) and the feature pixels the valid boxes touch, each moved once.
// Beyond that the kernel gathers: every bin reads its 16 neighbour pixel
// rows (8 KB at C = 256 bf16), almost all of them hits in L1 or L2, since
// neighbouring samples and overlapping boxes share pixels.
//
// Why the Pallas design is not carried over: it copies each ROI's whole
// window into VMEM by DMA and contracts it with hat-weight matrices. On
// Hopper the window does not fit: a p2 box spans up to ~29 x 29 pixels of
// its level, 430 KB at C = 256 bf16, against the 227 KB of shared memory a
// block can use; and the matmul form stood in for gathers that the TPU's
// scalar core could not issue. What carries over is the goal: read each
// ROI's window once, close together in time. The design:
//   * one block per ROI, in the order given (image-major on the main path),
//     so the rows of a window are read together and an image's overlapping
//     proposals are in flight together; its 8 warps stride over the P x P
//     bins (49 bins balance over 8 warps; P rows would leave one idle);
//   * lane-owned sample coordinates: lane i computes x- and y-sample i (and
//     i + 32, for 2P up to 64) with IEEE round-to-nearest intrinsics in the
//     plain ops' order, so no sample crosses the in-map boundary differently
//     from the plain version; a bin takes its four samples from their lanes
//     by __shfl_sync: no shared table, no barrier;
//   * 16-byte gathers: a lane owns 8 consecutive bf16 channels (4 float32),
//     so at C = 256 bf16 one warp instruction reads a whole 512-byte pixel
//     row; all 16 neighbour loads of a bin are issued read-only
//     (ld.global.nc) before its arithmetic, which runs in float32
//     registers. Where C is not a multiple of the vector width, or a level
//     does not start on 16 bytes, the same kernel runs its scalar path, one
//     channel per lane and load;
//   * streaming stores (st.global.cs, 16 bytes on the vector path), so the
//     output does not evict the features from L2; an invalid ROI's block
//     writes its P x P x C zeros the same way and reads nothing;
//   * no shared memory: the carveout prefers L1, which holds the pixels that
//     a bin's samples and the next bins share.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (object_detection_tracking_tpu_torch/native.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;

struct Levels {
  const void* ptr[4];
  int h[4];
  int w[4];
  int stride[4];
};

// One sample coordinate `a` on an axis of `extent` pixels: its lower
// neighbour (clamped into the map), or -1 when `a` lies outside [0, extent-1]
// and the sample is 0; and its fraction past floor(a).
__device__ __forceinline__ void setup_sample(float a, int extent, int* lo,
                                             float* frac) {
  const bool in = (a >= 0.f) && (a <= (float)(extent - 1));
  const float f0 = floorf(a);
  *frac = __fsub_rn(a, f0);
  const int l = min(max((int)f0, 0), extent - 1);
  *lo = in ? l : -1;
}

// fpcoor sample i of a crop of `size` samples over [lo, hi] (box in level
// coordinates): lo + ((hi - lo) / size) * (i + 0.5) - 0.5, rounded step by
// step like the plain version's separate tensor ops.
__device__ __forceinline__ float sample_coord(float lo, float hi, int size,
                                              int i) {
  const float spacing = __fdiv_rn(__fsub_rn(hi, lo), (float)size);
  return __fsub_rn(__fadd_rn(lo, __fmul_rn(spacing, (float)i + 0.5f)), 0.5f);
}

// kVec channels of T, read by one load instruction, and channel j of them
// as float (bf16 -> float is exact: the bits go to the top half).
template <typename T, int kVec>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ float get(const Raw& r, int j) {
    const unsigned w = j < 2 ? r.x : j < 4 ? r.y : j < 6 ? r.z : r.w;
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <>
struct Chunk<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  static __device__ __forceinline__ float get(const Raw& r, int) {
    return __uint_as_float((unsigned)r << 16);
  }
};

template <>
struct Chunk<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float get(const Raw& r, int j) {
    return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
  }
};

template <>
struct Chunk<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ float get(const Raw& r, int) { return r; }
};

// kVec consecutive floats to p with streaming (evict-first) stores: 16
// bytes at a time on the vector path.
template <int kVec>
__device__ __forceinline__ void store_cs(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 1) {
    __stcs(p, v[0]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      __stcs(reinterpret_cast<float4*>(p + i),
             make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
    }
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 2) roi_align_fwd_kernel(
    Levels lv, const float* __restrict__ boxes, const int* __restrict__ levels,
    const bool* __restrict__ valid, float* __restrict__ out,
    int rois_per_image, int c, int pool) {
  using Ch = Chunk<T, kVec>;
  const int roi = blockIdx.x;
  const int bins = pool * pool;
  float* dst = out + (size_t)roi * bins * c;
  if (valid != nullptr && !valid[roi]) {
    const float zero[kVec] = {};
    for (int i = threadIdx.x * kVec; i < bins * c; i += kThreads * kVec) {
      store_cs<kVec>(dst + i, zero);
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = levels[roi];
  const int h = lv.h[l];
  const int w = lv.w[l];
  const float s = (float)lv.stride[l];
  const float* box = boxes + (size_t)roi * 4;
  const float bx0 = __fdiv_rn(__ldg(box + 0), s);
  const float by0 = __fdiv_rn(__ldg(box + 1), s);
  const float bx1 = __fdiv_rn(__ldg(box + 2), s);
  const float by1 = __fdiv_rn(__ldg(box + 3), s);
  const int size2 = 2 * pool;
  // this lane's samples i = lane and lane + 32 on each axis (those past
  // 2P are never asked for)
  int xs_lo[2], ys_lo[2];
  float xs_f[2], ys_f[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = lane + 32 * k;
    setup_sample(sample_coord(bx0, bx1, size2, i), w, &xs_lo[k], &xs_f[k]);
    setup_sample(sample_coord(by0, by1, size2, i), h, &ys_lo[k], &ys_f[k]);
  }

  const T* feat = static_cast<const T*>(lv.ptr[l]) +
                  (size_t)(roi / rois_per_image) * h * w * c;
  for (int bin = warp; bin < bins; bin += kWarps) {   // warp-uniform
    const int py = bin / pool;
    const int px = bin - py * pool;
    // the bin's 2 y- and 2 x-samples, from the lanes that own them: the
    // neighbours' row offsets y * w and columns, and the bilinear weights
    int row[2][2], col[2][2];
    float wy[2][2], wx[2][2];
    bool yin[2], xin[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int sy = 2 * py + k;
      const int sx = 2 * px + k;
      const int ly = __shfl_sync(kFullMask, sy < 32 ? ys_lo[0] : ys_lo[1],
                                 sy & 31);
      const float fy = __shfl_sync(kFullMask, sy < 32 ? ys_f[0] : ys_f[1],
                                   sy & 31);
      const int lx = __shfl_sync(kFullMask, sx < 32 ? xs_lo[0] : xs_lo[1],
                                 sx & 31);
      const float fx = __shfl_sync(kFullMask, sx < 32 ? xs_f[0] : xs_f[1],
                                   sx & 31);
      yin[k] = ly >= 0;
      xin[k] = lx >= 0;
      const int y0 = max(ly, 0);
      const int x0 = max(lx, 0);
      row[k][0] = y0 * w;
      row[k][1] = min(y0 + 1, h - 1) * w;
      col[k][0] = x0;
      col[k][1] = min(x0 + 1, w - 1);
      // the 2x2 mean's 1/4 goes into the y weights (a power of two: exact)
      wy[k][0] = 0.25f * (1.f - fy);
      wy[k][1] = 0.25f * fy;
      wx[k][0] = 1.f - fx;
      wx[k][1] = fx;
    }

    float* o = dst + (size_t)bin * c;
    for (int c0 = lane * kVec; c0 < c; c0 += 32 * kVec) {
      // all 16 neighbour loads of the bin first: sample (ky, kx), corner
      // (ry, rx); a sample outside the map reads nothing and adds 0
      typename Ch::Raw raw[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int ky = q >> 3, kx = (q >> 2) & 1, ry = (q >> 1) & 1,
                  rx = q & 1;
        raw[q] = (yin[ky] && xin[kx])
                     ? Ch::load(feat + (size_t)(row[ky][ry] + col[kx][rx]) * c
                                + c0)
                     : typename Ch::Raw{};
      }
      float acc[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int ky = q >> 3, kx = (q >> 2) & 1, ry = (q >> 1) & 1,
                  rx = q & 1;
        const float wt = wy[ky][ry] * wx[kx][rx];
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          acc[j] = fmaf(Ch::get(raw[q], j), wt, acc[j]);
        }
      }
      store_cs<kVec>(o + c0, acc);
    }
  }
}

// The kernel holds no shared memory: give the SM's 256 KB to L1. Set once
// per instantiation, before its first launch.
template <typename T, int kVec>
cudaError_t launch(const dim3& grid, cudaStream_t st, const Levels& lv,
                   const float* b, const int* lvl, const bool* v, float* o,
                   int rois_per_image, int c, int pool) {
  static const cudaError_t carveout = cudaFuncSetAttribute(
      roi_align_fwd_kernel<T, kVec>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxL1);
  if (carveout != cudaSuccess) return carveout;
  roi_align_fwd_kernel<T, kVec><<<grid, kThreads, 0, st>>>(
      lv, b, lvl, v, o, rois_per_image, c, pool);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// features f0..f3: NHWC [num_images, h_l, w_l, channels], float32 or bf16.
// boxes [num_images * rois_per_image, 4] float32 image coords; levels int32
// 0..3; valid bool or NULL (all valid); out [rois, pool, pool, channels]
// float32. One block per ROI. The vector path needs channels a multiple of
// 8 (bf16) or 4 (float32) and every level and `out` on 16 bytes; anything
// else runs the scalar path. Launches on `stream`, returns the launch's
// cudaError_t.
extern "C" int roi_align_forward(
    const void* f0, const void* f1, const void* f2, const void* f3,
    int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
    int s0, int s1, int s2, int s3,
    const void* boxes, const void* levels, const void* valid, void* out,
    int num_images, int rois_per_image, int channels, int pool, int is_bf16,
    void* stream) {
  Levels lv;
  lv.ptr[0] = f0; lv.ptr[1] = f1; lv.ptr[2] = f2; lv.ptr[3] = f3;
  lv.h[0] = h0; lv.h[1] = h1; lv.h[2] = h2; lv.h[3] = h3;
  lv.w[0] = w0; lv.w[1] = w1; lv.w[2] = w2; lv.w[3] = w3;
  lv.stride[0] = s0; lv.stride[1] = s1; lv.stride[2] = s2; lv.stride[3] = s3;
  const dim3 grid(num_images * rois_per_image);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  const int* lvl = static_cast<const int*>(levels);
  const bool* v = static_cast<const bool*>(valid);
  float* o = static_cast<float*>(out);
  const bool vec = aligned16(f0) && aligned16(f1) && aligned16(f2) &&
                   aligned16(f3) && aligned16(out) &&
                   channels % (is_bf16 ? 8 : 4) == 0;
  cudaError_t err;
  if (is_bf16) {
    err = vec ? launch<__nv_bfloat16, 8>(grid, st, lv, b, lvl, v, o,
                                         rois_per_image, channels, pool)
              : launch<__nv_bfloat16, 1>(grid, st, lv, b, lvl, v, o,
                                         rois_per_image, channels, pool);
  } else {
    err = vec ? launch<float, 4>(grid, st, lv, b, lvl, v, o, rois_per_image,
                                 channels, pool)
              : launch<float, 1>(grid, st, lv, b, lvl, v, o, rois_per_image,
                                 channels, pool);
  }
  return static_cast<int>(err);
}
