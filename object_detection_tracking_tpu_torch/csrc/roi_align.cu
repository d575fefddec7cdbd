// Multilevel FPN ROIAlign for Hopper (sm_90a): the forward (B1), its
// gradient to the features (B1b) and its gradient to the boxes (B1e); the
// two gradients follow the forward in this file.
//
// Replaces the Pallas TPU kernel object_detection_tracking_tpu/ops/pallas/
// roi_align_pallas.py (`_kernel` :138, launched by `_roi_align_levels`
// behind `multilevel_roi_align_pallas`). It computes exactly what the plain
// PyTorch `multilevel_roi_align` in ops/roi_align.py computes: per ROI, its
// level (int32 from the caller: the canonical FPN level, computed by the
// wrapper with the shared `fpn_map_rois_to_levels` so the two versions
// cannot disagree at a floor(log2) boundary, or the caller's own, as
// EfficientDet pools each detection from the level of its anchor; clamped
// here into the levels given); a 2P x 2P grid of tf.crop_and_resize fpcoor
// samples (y(i) = y0 + sh * (i + 0.5) - 0.5, zero outside [0, H-1]); each
// sample bilinear over its 4 neighbours; the 2x2 mean; float32 out.
// Invalid (NMS-suppressed) slots write exact zeros. Like the Pallas kernel
// it takes any number of levels up to kMaxLevels: four (Faster R-CNN's
// p2..p5) or five (EfficientDet's P3..P7, down to 4 x 4 pixels).
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
//     row, and a wider row (EfficientDet d6/d7: C = 384, 48 chunks) takes
//     a second pass of the warp's first lanes; all 16 neighbour loads of a bin are issued read-only
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

#include <atomic>

namespace {

// A kernel's attribute belongs to the current device's context: a process
// that launches on several cards sets it on each, once (bit d of `done`
// marks device d; a device past 63 sets it at every launch).
template <typename Set>
cudaError_t once_per_device(std::atomic<unsigned long long>& done, Set set) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = set();
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr int kMaxLevels = 5;

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int stride[kMaxLevels];
  int count;   // levels in use, 1..kMaxLevels
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

// One ROI's sample coordinates, spread over a warp: lane i holds x- and
// y-sample i and i + 32 of the 2P x 2P grid (those past 2P are never asked
// for) as the lower neighbour (-1: outside the map) and the fraction.
struct LaneSamples {
  int xs_lo[2], ys_lo[2];
  float xs_f[2], ys_f[2];
};

__device__ __forceinline__ LaneSamples lane_samples(const float* box, float s,
                                                    int h, int w, int size2,
                                                    int lane) {
  const float bx0 = __fdiv_rn(__ldg(box + 0), s);
  const float by0 = __fdiv_rn(__ldg(box + 1), s);
  const float bx1 = __fdiv_rn(__ldg(box + 2), s);
  const float by1 = __fdiv_rn(__ldg(box + 3), s);
  LaneSamples ls;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = lane + 32 * k;
    setup_sample(sample_coord(bx0, bx1, size2, i), w, &ls.xs_lo[k],
                 &ls.xs_f[k]);
    setup_sample(sample_coord(by0, by1, size2, i), h, &ls.ys_lo[k],
                 &ls.ys_f[k]);
  }
  return ls;
}

// The 16 taps of output bin (py, px): its 2 y- and 2 x-samples, taken from
// the lanes that own them, as the neighbours' row offsets y * w and
// columns, the bilinear weights (the 2x2 mean's 1/4, a power of two and so
// exact, folded into the y weights), and whether each sample lies in the
// map. Tap (ky, kx, ry, rx) is neighbour (ry, rx) of sample (ky, kx).
struct BinTaps {
  int row[2][2], col[2][2];
  float wy[2][2], wx[2][2];
  bool yin[2], xin[2];
};

__device__ __forceinline__ BinTaps bin_taps(const LaneSamples& ls, int py,
                                            int px, int h, int w) {
  BinTaps t;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int sy = 2 * py + k;
    const int sx = 2 * px + k;
    const int ly = __shfl_sync(kFullMask, sy < 32 ? ls.ys_lo[0] : ls.ys_lo[1],
                               sy & 31);
    const float fy = __shfl_sync(kFullMask, sy < 32 ? ls.ys_f[0] : ls.ys_f[1],
                                 sy & 31);
    const int lx = __shfl_sync(kFullMask, sx < 32 ? ls.xs_lo[0] : ls.xs_lo[1],
                               sx & 31);
    const float fx = __shfl_sync(kFullMask, sx < 32 ? ls.xs_f[0] : ls.xs_f[1],
                                 sx & 31);
    t.yin[k] = ly >= 0;
    t.xin[k] = lx >= 0;
    const int y0 = max(ly, 0);
    const int x0 = max(lx, 0);
    t.row[k][0] = y0 * w;
    t.row[k][1] = min(y0 + 1, h - 1) * w;
    t.col[k][0] = x0;
    t.col[k][1] = min(x0 + 1, w - 1);
    t.wy[k][0] = 0.25f * (1.f - fy);
    t.wy[k][1] = 0.25f * fy;
    t.wx[k][0] = 1.f - fx;
    t.wx[k][1] = fx;
  }
  return t;
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
  const int l = min(max(levels[roi], 0), lv.count - 1);
  const int h = lv.h[l];
  const int w = lv.w[l];
  const LaneSamples ls = lane_samples(boxes + (size_t)roi * 4,
                                      (float)lv.stride[l], h, w, 2 * pool,
                                      lane);
  const T* feat = static_cast<const T*>(lv.ptr[l]) +
                  (size_t)(roi / rois_per_image) * h * w * c;
  for (int bin = warp; bin < bins; bin += kWarps) {   // warp-uniform
    const int py = bin / pool;
    const BinTaps t = bin_taps(ls, py, bin - py * pool, h, w);
    float* o = dst + (size_t)bin * c;
    for (int c0 = lane * kVec; c0 < c; c0 += 32 * kVec) {
      // all 16 neighbour loads of the bin first: sample (ky, kx), corner
      // (ry, rx); a sample outside the map reads nothing and adds 0
      typename Ch::Raw raw[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int ky = q >> 3, kx = (q >> 2) & 1, ry = (q >> 1) & 1,
                  rx = q & 1;
        raw[q] = (t.yin[ky] && t.xin[kx])
                     ? Ch::load(feat + (size_t)(t.row[ky][ry] + t.col[kx][rx])
                                * c + c0)
                     : typename Ch::Raw{};
      }
      float acc[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int ky = q >> 3, kx = (q >> 2) & 1, ry = (q >> 1) & 1,
                  rx = q & 1;
        const float wt = t.wy[ky][ry] * t.wx[kx][rx];
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
  static std::atomic<unsigned long long> done{0};
  const cudaError_t carveout = once_per_device(done, [] {
    return cudaFuncSetAttribute(roi_align_fwd_kernel<T, kVec>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxL1);
  });
  if (carveout != cudaSuccess) return carveout;
  roi_align_fwd_kernel<T, kVec><<<grid, kThreads, 0, st>>>(
      lv, b, lvl, v, o, rois_per_image, c, pool);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// features f0..f{num_levels-1}: NHWC [num_images, h_l, w_l, channels],
// float32 or bf16, num_levels 1..5 (the slots past it are ignored). boxes
// [num_images * rois_per_image, 4] float32 image coords; levels int32 (any
// value: clamped into 0..num_levels-1); valid bool or NULL (all valid); out
// [rois, pool, pool, channels] float32. One block per ROI. The vector path
// needs channels a multiple of 8 (bf16) or 4 (float32) and every level in
// use and `out` on 16 bytes; anything else runs the scalar path. Launches
// on `stream`, returns the launch's cudaError_t (cudaErrorInvalidValue
// for a level count outside 1..5).
extern "C" int roi_align_forward(
    const void* f0, const void* f1, const void* f2, const void* f3,
    const void* f4, int h0, int w0, int h1, int w1, int h2, int w2, int h3,
    int w3, int h4, int w4, int s0, int s1, int s2, int s3, int s4,
    int num_levels, const void* boxes, const void* levels, const void* valid,
    void* out, int num_images, int rois_per_image, int channels, int pool,
    int is_bf16, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* const fl[kMaxLevels] = {f0, f1, f2, f3, f4};
  const int hl[kMaxLevels] = {h0, h1, h2, h3, h4};
  const int wl[kMaxLevels] = {w0, w1, w2, w3, w4};
  const int sl[kMaxLevels] = {s0, s1, s2, s3, s4};
  Levels lv;
  lv.count = num_levels;
  bool aligned = aligned16(out);
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < num_levels;
    lv.ptr[l] = used ? fl[l] : nullptr;
    lv.h[l] = used ? hl[l] : 0;
    lv.w[l] = used ? wl[l] : 0;
    lv.stride[l] = used ? sl[l] : 1;
    aligned &= !used || aligned16(fl[l]);
  }
  const dim3 grid(num_images * rois_per_image);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  const int* lvl = static_cast<const int*>(levels);
  const bool* v = static_cast<const bool*>(valid);
  float* o = static_cast<float*>(out);
  const bool vec = aligned && channels % (is_bf16 ? 8 : 4) == 0;
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


// ---------------------------------------------------------------------------
// B1b: the gradient of the forward above with respect to the features.
//
// The JAX package has no Pallas kernel for it: its trainable ROIAlign
// (object_detection_tracking_tpu/ops/pallas/roi_align_pallas.py
// `multilevel_roi_align_trainable` :584) runs the Pallas forward and takes
// the backward `_mra_bwd` (:600-607) as XLA's VJP of the exact gather
// `_xla_multilevel` (:577): a scatter-add of each output gradient, times
// the bilinear weight and the 2x2 mean's 1/4, into the four neighbours the
// forward read, then a cast to the features' dtype. This is that function,
// written by hand. Its spec is autograd of the plain `multilevel_roi_align`
// (ops/roi_align.py `multilevel_roi_align_vjp`); the boxes' gradient is
// B1e's, at the end of this file.
//
// What bounds it on the H100: bytes. The function reads grad_out once
// (float32) and writes every gradient element once, in the features'
// dtype: 51 MB and 178 MB at the training step's launches. A scatter that
// adds into a float32 copy of the levels and casts it afterwards moves that
// copy three more times (zero fill, atomics, cast). So the owner computes:
//   * one work item owns one output tile: kTileH x kTileW pixels of one
//     level of one image, over one slice of 32 * kVec channels. It
//     accumulates the tile in shared memory in float32 and writes it once,
//     in the features' dtype, with streaming stores (16 bytes a thread: 8
//     bf16 or 4 float32 channels). A tile that no ROI reaches writes zeros
//     and reads nothing;
//   * which ROIs reach a tile: each ROI's tap footprint on its level, the
//     rows from the lower neighbour of its first in-map y-sample to the
//     upper neighbour (clamped at h - 1) of its last, and the columns
//     likewise, computed with the forward's own `sample_coord` /
//     `setup_sample`, so that it cannot disagree with where a tap lands
//     (plain version: ops/roi_align.py `roi_tap_footprint`). A first launch
//     of one block (the plan) computes the footprints, counts the ROIs that
//     reach each tile, and orders the tiles by that count, most first. A
//     tile's work item scans its image's N footprints (16 bytes each, in
//     L2) and compacts those that meet it into a shared list, in ROI order;
//     an empty tile, known from the plan, skips the scan;
//   * the tiles' load is uneven: at the training step a few tiles near the
//     objects hold 30-40 ROIs and most hold none. So the tile launch is
//     persistent (a few blocks per SM take items from a queue in the
//     plan's order: the longest start first), and within a tile two warps
//     share each pixel row, taking its ROIs in turn;
//   * no atomics on the gradient: warp w owns its own float32 copy of a
//     tile row (row w / kCopies; the write-out adds the row's kCopies
//     copies in order), lane i channels [kVec * i, kVec * i + kVec) of the
//     slice. For each of its ROIs whose footprint holds the row, the warp
//     places the ROI's samples (lane i: bin i), finds by ballot the y-taps
//     on its row and the bins with an x-tap in the tile, and adds each
//     tap's (g * wy) * wx into shared memory, branch-free: a tap outside
//     the tile or a sample outside the map goes to a scratch column. Every
//     element has one writer and a fixed order of additions (ROI order,
//     then sample order, then the copies), so the result is bitwise the
//     same from run to run. Products and sums are written with _rn
//     intrinsics, which nvcc does not fuse into an FMA: each product is the
//     plain autograd's bit for bit, and only the order of the additions
//     differs from it;
//   * a lane reads its 4 float32 channels of grad_out in 16 bytes (kVec =
//     4; C a multiple of 4 and grad_out on 16 bytes), else one channel per
//     lane (kVec = 1). Beyond the bound, a bin whose taps straddle a tile
//     border is read once by each tile it reaches (chip_smoke.py
//     roi_bwd_design_ms counts those bytes). What holds it above the bound
//     at the training step is the tap loop's instruction count in the few
//     busy tiles, not bytes (PERF.md).

namespace {

constexpr int kTileH = 4;                  // pixel rows of a tile
constexpr int kCopies = kWarps / kTileH;   // warps (and sums) per row
constexpr int kTileW = 16;
constexpr int kPlanThreads = 1024;
constexpr int kPlanMaxPairs = 8192;   // (image, tile) pairs sorted on chip
constexpr int kScanPer = 2;                  // footprints a thread scans
constexpr int kScan = kScanPer * kThreads;   // per round

struct GradLevels {
  void* ptr[4];          // the level's gradient, [num_images, h, w, c]
  int h[4];
  int w[4];
  int stride[4];
  int tiles_x[4];        // tiles across the level
  int first_tile[5];     // the level's first tile; [4]: tiles per image
};

// The inclusive range of pixels that the taps of `size2` fpcoor samples
// over [lo, hi] reach on an axis of `extent` pixels: the lower neighbour of
// the first in-map sample to the upper neighbour of the last; last < 0 when
// no sample lies in the map.
__device__ __forceinline__ void tap_span(float lo, float hi, int size2,
                                         int extent, int* first, int* last) {
  int a = extent, b = -1;
  for (int i = 0; i < size2; ++i) {
    int l;
    float f;
    setup_sample(sample_coord(lo, hi, size2, i), extent, &l, &f);
    if (l >= 0) {
      a = min(a, l);
      b = max(b, l);
    }
  }
  *first = a;
  *last = b < 0 ? -1 : min(b + 1, extent - 1);
}

// A box in the coordinates of a level of stride s, {x0, y0, x1, y1},
// divided as lane_samples divides it.
__device__ __forceinline__ float4 level_box(const float* box, float s) {
  return make_float4(
      __fdiv_rn(__ldg(box + 0), s), __fdiv_rn(__ldg(box + 1), s),
      __fdiv_rn(__ldg(box + 2), s), __fdiv_rn(__ldg(box + 3), s));
}

// ROI r's footprint {r0, r1, c0, c1} (inclusive) on its level, {0, -1, 0,
// -1} when none of its taps lands in the map.
__device__ __forceinline__ int4 roi_footprint(const GradLevels& lv,
                                              const float* __restrict__ boxes,
                                              const int* __restrict__ levels,
                                              int r, int pool) {
  const int l = min(max(levels[r], 0), 3);
  const float4 b = level_box(boxes + (size_t)r * 4, (float)lv.stride[l]);
  int r0, r1, c0, c1;
  tap_span(b.y, b.w, 2 * pool, lv.h[l], &r0, &r1);
  tap_span(b.x, b.z, 2 * pool, lv.w[l], &c0, &c1);
  return (r1 < 0 || c1 < 0) ? make_int4(0, -1, 0, -1)
                            : make_int4(r0, r1, c0, c1);
}

// One block plans the tile launch: every ROI's footprint (a thread each)
// into `footprint`; the ROIs that reach each (image, tile) pair, counted in
// shared memory; and `order`, the pairs by that count, most first (a
// counting sort; ties in any order), so that the longest tiles start first
// and do not trail the launch, an empty pair i written as ~i so that its
// tile skips the scan; and zeroes the tile launch's `queue`. Above
// kPlanMaxPairs pairs `order` is the identity (every tile scans).
__global__ void __launch_bounds__(kPlanThreads) roi_bwd_plan_kernel(
    GradLevels lv, const float* __restrict__ boxes,
    const int* __restrict__ levels, int4* __restrict__ footprint,
    int* __restrict__ order, int* __restrict__ queue, int num_images,
    int rois_per_image, int pool) {
  __shared__ int count[kPlanMaxPairs];
  __shared__ int bucket[kPlanThreads];   // by count, most first
  __shared__ int warp_sum[kPlanThreads / 32];
  const int tiles = lv.first_tile[4];
  const int pairs = num_images * tiles;
  const bool sort = pairs <= kPlanMaxPairs;
  for (int i = threadIdx.x; i < kPlanMaxPairs; i += kPlanThreads) count[i] = 0;
  bucket[threadIdx.x] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < num_images * rois_per_image;
       r += kPlanThreads) {
    const int4 f = roi_footprint(lv, boxes, levels, r, pool);
    footprint[r] = f;
    if (!sort || f.y < 0) continue;
    const int l = min(max(levels[r], 0), 3);
    int* row = count + (r / rois_per_image) * tiles + lv.first_tile[l];
    for (int ty = f.x / kTileH; ty <= f.y / kTileH; ++ty) {
      for (int tx = f.z / kTileW; tx <= f.w / kTileW; ++tx) {
        atomicAdd(row + ty * lv.tiles_x[l] + tx, 1);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) *queue = 0;
  if (!sort) {   // not counted: every tile scans
    for (int i = threadIdx.x; i < pairs; i += kPlanThreads) order[i] = i;
    return;
  }
  for (int i = threadIdx.x; i < pairs; i += kPlanThreads) {
    atomicAdd(&bucket[kPlanThreads - 1 - min(count[i], kPlanThreads - 1)],
              1);
  }
  __syncthreads();
  // exclusive prefix sum of the buckets, one per thread
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int v = bucket[threadIdx.x];
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    x += lane >= o ? y : 0;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, w, o);
      w += lane >= o ? y : 0;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  bucket[threadIdx.x] = x - v + (warp > 0 ? warp_sum[warp - 1] : 0);
  __syncthreads();
  for (int i = threadIdx.x; i < pairs; i += kPlanThreads) {
    const int b = kPlanThreads - 1 - min(count[i], kPlanThreads - 1);
    order[atomicAdd(&bucket[b], 1)] = count[i] == 0 ? ~i : i;
  }
}

// One ROI's samples spread over a warp by bin: lane i holds samples 2i
// and 2i + 1 of each axis (those of bin i; bins past P are never asked
// for), placed by the forward's `sample_coord` / `setup_sample`.
struct BinSamples {
  int y_lo[2], x_lo[2];
  float y_f[2], x_f[2];
};

__device__ __forceinline__ BinSamples bin_samples(const float* box, float s,
                                                  int h, int w, int size2,
                                                  int lane) {
  const float4 b = level_box(box, s);
  BinSamples bs;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = 2 * lane + k;
    setup_sample(sample_coord(b.x, b.z, size2, i), w, &bs.x_lo[k],
                 &bs.x_f[k]);
    setup_sample(sample_coord(b.y, b.w, size2, i), h, &bs.y_lo[k],
                 &bs.y_f[k]);
  }
  return bs;
}

template <int kVec>
struct Vec {
  float v[kVec];
};

// The lane's kVec floats of grad_out at p, or zeros when `on` is false.
template <int kVec>
__device__ __forceinline__ Vec<kVec> load_g(const float* p, bool on) {
  Vec<kVec> g{};
  if (on) {
    if constexpr (kVec == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      g.v[0] = q.x; g.v[1] = q.y; g.v[2] = q.z; g.v[3] = q.w;
    } else {
      g.v[0] = __ldg(p);
    }
  }
  return g;
}

// acc[col] += gy * wx for the lane's kVec floats of column col (`acc`:
// column 0 of the warp's row); gy = g * wy, so each tap adds the plain
// autograd's product (g * wy) * wx.
template <int kVec>
__device__ __forceinline__ void add_tap(float* acc, int col,
                                        const Vec<kVec>& gy, float wx) {
  float* p = acc + col * 32 * kVec;
  if constexpr (kVec == 4) {
    float4 v = *reinterpret_cast<float4*>(p);
    v.x = __fadd_rn(v.x, __fmul_rn(gy.v[0], wx));
    v.y = __fadd_rn(v.y, __fmul_rn(gy.v[1], wx));
    v.z = __fadd_rn(v.z, __fmul_rn(gy.v[2], wx));
    v.w = __fadd_rn(v.w, __fmul_rn(gy.v[3], wx));
    *reinterpret_cast<float4*>(p) = v;
  } else {
    *p = __fadd_rn(*p, __fmul_rn(gy.v[0], wx));
  }
}

// One warp adds ROI r's taps on pixel row y (level coordinates) of the
// tile starting at column tx0 into its row of shared memory `acc` (the
// lane's kVec floats at column 0; column kTileW is scratch). Lane i holds
// bin i's samples and its four x-taps' tile columns, packed a byte each
// (kTileW for a tap outside the tile or a sample outside the map, so that
// every tap is added, branch-free); the warp walks the y-taps on its row
// and, for each, the bins with an x-tap in the tile: one grad_out load
// (the next bin's issued first), g * wy once, four read-modify-writes.
// Warp-uniform: every lane calls it.
template <int kVec>
__device__ __forceinline__ void add_roi_row(
    float* acc, const float* __restrict__ boxes,
    const float* __restrict__ grad_out, int r, float stride, int h, int w,
    int y, int tx0, int pool, int c, int c0, int lane, bool lane_on) {
  const BinSamples bs = bin_samples(boxes + (size_t)r * 4, stride, h, w,
                                    2 * pool, lane);
  unsigned cols = 0;
  bool y_hit = false;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ly = bs.y_lo[k];
    y_hit |= ly >= 0 && (ly == y || min(ly + 1, h - 1) == y);
    const int lx = bs.x_lo[k];
    const int lo = lx - tx0;
    const int hi = min(lx + 1, w - 1) - tx0;
    const unsigned a = (lx >= 0 && (unsigned)lo < (unsigned)kTileW)
                           ? lo : kTileW;
    const unsigned b = (lx >= 0 && (unsigned)hi < (unsigned)kTileW)
                           ? hi : kTileW;
    cols |= (a | b << 8) << (16 * k);
  }
  const bool in_bin = lane < pool;
  const unsigned ym = __ballot_sync(kFullMask, in_bin && y_hit);
  const unsigned xm = __ballot_sync(kFullMask, in_bin &&
                                    cols != kTileW * 0x01010101u);
  if (ym == 0 || xm == 0) return;
  const float* g_roi = grad_out + (size_t)r * pool * pool * c + c0 +
                       lane * kVec;
  for (unsigned my = ym; my != 0; my &= my - 1) {       // warp-uniform
    const int py = __ffs(my) - 1;
    const float* g_row = g_roi + (size_t)py * pool * c;
#pragma unroll
    for (int ky = 0; ky < 2; ++ky) {
      const int ly = __shfl_sync(kFullMask, bs.y_lo[ky], py);
      const float fy = __shfl_sync(kFullMask, bs.y_f[ky], py);
#pragma unroll
      for (int ry = 0; ry < 2; ++ry) {
        // neighbour ry of the sample: the lower, or the upper (clamped)
        if (ly < 0 || (ry == 0 ? ly : min(ly + 1, h - 1)) != y) continue;
        const float wy = ry == 0 ? 0.25f * (1.f - fy) : 0.25f * fy;
        unsigned mx = xm;
        int px = __ffs(mx) - 1;
        mx &= mx - 1;
        Vec<kVec> g = load_g<kVec>(g_row + (size_t)px * c, lane_on);
        while (true) {                                   // warp-uniform
          const int next = mx != 0 ? __ffs(mx) - 1 : -1;
          mx &= mx - 1;
          const Vec<kVec> g_next = load_g<kVec>(
              g_row + (size_t)max(next, 0) * c, lane_on && next >= 0);
          const unsigned pc = __shfl_sync(kFullMask, cols, px);
          const float f0 = __shfl_sync(kFullMask, bs.x_f[0], px);
          const float f1 = __shfl_sync(kFullMask, bs.x_f[1], px);
          Vec<kVec> gy;
#pragma unroll
          for (int j = 0; j < kVec; ++j) gy.v[j] = __fmul_rn(g.v[j], wy);
          add_tap<kVec>(acc, pc & 0xff, gy, 1.f - f0);
          add_tap<kVec>(acc, (pc >> 8) & 0xff, gy, f0);
          add_tap<kVec>(acc, (pc >> 16) & 0xff, gy, 1.f - f1);
          add_tap<kVec>(acc, pc >> 24, gy, f1);
          if (next < 0) break;
          px = next;
          g = g_next;
        }
      }
    }
  }
}

// kN float values of the tile, the sum of the row's kCopies partial sums
// taken in copy order (`src`: copy 0; the next copy `copy_stride` floats
// on), or zeros (src == nullptr), to dst in T with one streaming store:
// kN = 8 (bf16, 16 bytes), 4 (bf16 8 bytes, float32 16 bytes) or 1.
template <typename T, int kN>
__device__ __forceinline__ void store_values(T* dst, const float* src,
                                             int copy_stride) {
  float v[kN] = {};
  if (src != nullptr) {
#pragma unroll
    for (int k = 0; k < kCopies; ++k) {
      const float* q = src + k * copy_stride;
#pragma unroll
      for (int i = 0; i < kN; i += 4) {
        float x[4];
        if constexpr (kN == 1) {
          x[0] = q[0];
        } else {
          const float4 f = *reinterpret_cast<const float4*>(q + i);
          x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
        }
#pragma unroll
        for (int j = 0; j < (kN < 4 ? kN : 4); ++j) {
          v[i + j] = k == 0 ? x[j] : __fadd_rn(v[i + j], x[j]);
        }
      }
    }
  }
  if constexpr (sizeof(T) == 4) {
    if constexpr (kN == 1) {
      __stcs(reinterpret_cast<float*>(dst), v[0]);
    } else {
      __stcs(reinterpret_cast<float4*>(dst),
             make_float4(v[0], v[1], v[2], v[3]));
    }
  } else if constexpr (kN == 1) {
    __stcs(reinterpret_cast<unsigned short*>(dst),
           __bfloat16_as_ushort(__float2bfloat16_rn(v[0])));
  } else {
    unsigned u[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&b);
    }
    if constexpr (kN == 8) {
      __stcs(reinterpret_cast<uint4*>(dst), make_uint4(u[0], u[1], u[2],
                                                       u[3]));
    } else {
      __stcs(reinterpret_cast<uint2*>(dst), make_uint2(u[0], u[1]));
    }
  }
}

// The block's tile (or zeros, when no ROI reached it: `tile` == nullptr)
// to the level's gradient `out` (at the image and the slice's first
// channel), kN channels per store, skipping pixels past the map's edge.
template <typename T, int kN, int kVec>
__device__ __forceinline__ void write_tile(T* out, const float* tile, int cs,
                                           int ty0, int tx0, int h, int w,
                                           int c) {
  const int per_px = cs / kN;
  for (int q = threadIdx.x; q < kTileH * kTileW * per_px; q += kThreads) {
    const int p = q / per_px;
    const int k = q - p * per_px;
    const int yy = ty0 + p / kTileW;
    const int xx = tx0 + p % kTileW;
    if (yy >= h || xx >= w) continue;
    const int cell = (p / kTileW) * kCopies * (kTileW + 1) + p % kTileW;
    store_values<T, kN>(out + ((size_t)yy * w + xx) * c + k * kN,
                        tile != nullptr ? tile + cell * 32 * kVec + k * kN
                                        : nullptr,
                        (kTileW + 1) * 32 * kVec);
  }
}

// Work item `item` of the tile launch: one channel slice of the (image,
// tile) pair at position item / slices of the plan's order. `smem`: the
// tile, [kTileH][kCopies][kTileW + 1][32 * kVec] floats, warp w owning slot
// w (row w / kCopies, copy w % kCopies), column kTileW scratch; `list` and
// `warp_hits`: the scan's.
template <typename T, int kVec>
__device__ __forceinline__ void tile_item(
    const GradLevels& lv, const float* __restrict__ boxes,
    const int* __restrict__ levels, const int4* __restrict__ footprint,
    const int* __restrict__ order, const float* __restrict__ grad_out,
    int rois_per_image, int c, int pool, int chunk, int item, float4* smem,
    int* list, int* warp_hits) {
  float* tile = reinterpret_cast<float*>(smem);

  // the channel slice, and the (image, tile) pair: ~pair for an empty tile
  const int slices = (c + 32 * kVec - 1) / (32 * kVec);
  const int code = __ldg(order + item / slices);
  const int pair = code < 0 ? ~code : code;
  const int img = pair / lv.first_tile[4];
  int t = pair - img * lv.first_tile[4];
  int l = 0;
  while (l < 3 && t >= lv.first_tile[l + 1]) ++l;
  t -= lv.first_tile[l];
  const int h = lv.h[l];
  const int w = lv.w[l];
  const int ty0 = (t / lv.tiles_x[l]) * kTileH;
  const int tx0 = (t % lv.tiles_x[l]) * kTileW;
  const int c0 = (item % slices) * 32 * kVec;
  const int cs = min(32 * kVec, c - c0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int y = ty0 + warp / kCopies;               // the warp's row
  const int copy = warp % kCopies;
  const bool lane_on = lane * kVec < cs;
  float* acc = tile + (warp * (kTileW + 1) * 32 + lane) * kVec;
  const float stride = (float)lv.stride[l];
  const int roi0 = img * rois_per_image;

  // the image's footprints, kScan at a time (all loads issued first):
  // compact those that meet the tile (in ROI order) and add their taps (an
  // empty tile skips it). The kCopies warps of a row take its ROIs in turn.
  bool zeroed = false;                               // block-uniform
  int turn = 0;
  const int scan = code < 0 ? 0 : rois_per_image;
  for (int base = 0; base < scan; base += kScan) {
    bool hit[kScanPer];
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      const int i = base + k * kThreads + threadIdx.x;
      hit[k] = false;
      if (i < rois_per_image) {
        const int4 f = __ldg(footprint + roi0 + i);
        hit[k] = min(max(__ldg(levels + roi0 + i), 0), 3) == l &&
                 f.x <= ty0 + kTileH - 1 && f.y >= ty0 &&
                 f.z <= tx0 + kTileW - 1 && f.w >= tx0;
      }
    }
    unsigned m[kScanPer];
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      m[k] = __ballot_sync(kFullMask, hit[k]);
      if (lane == 0) warp_hits[k * kWarps + warp] = __popc(m[k]);
    }
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      int pos = total + __popc(m[k] & ((1u << lane) - 1u));
#pragma unroll
      for (int q = 0; q < kWarps; ++q) {
        const int n = warp_hits[k * kWarps + q];
        pos += q < warp ? n : 0;
        total += n;
      }
      if (hit[k]) list[pos] = roi0 + base + k * kThreads + threadIdx.x;
    }
    if (total > 0) {
      if (!zeroed) {
        for (int q = threadIdx.x;
             q < kTileH * kCopies * (kTileW + 1) * 8 * kVec;
             q += kThreads) {
          smem[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        zeroed = true;
      }
      __syncthreads();
      if (y < h) {
        for (int k = 0; k < total; ++k) {            // warp-uniform
          const int r = list[k];
          const int4 f = __ldg(footprint + r);
          if (y < f.x || y > f.y || turn++ % kCopies != copy) continue;
          add_roi_row<kVec>(acc, boxes, grad_out, r, stride, h, w, y, tx0,
                            pool, c, c0, lane, lane_on);
        }
      }
    }
    __syncthreads();   // before list and warp_hits are written again
  }

  // the tile, once, in T: `chunk` channels per store
  T* out = static_cast<T*>(lv.ptr[l]) + (size_t)img * h * w * c + c0;
  const float* src = zeroed ? tile : nullptr;
  if constexpr (kVec == 1) {
    write_tile<T, 1, kVec>(out, src, cs, ty0, tx0, h, w, c);
  } else if constexpr (sizeof(T) == 2) {
    if (chunk == 8) {
      write_tile<T, 8, kVec>(out, src, cs, ty0, tx0, h, w, c);
    } else {
      write_tile<T, 4, kVec>(out, src, cs, ty0, tx0, h, w, c);
    }
  } else {
    write_tile<T, 4, kVec>(out, src, cs, ty0, tx0, h, w, c);
  }
}

// Persistent: a few blocks per SM take the `items` work items in the plan's
// order, the first gridDim.x by block index, the rest from the queue
// (`queue`, zeroed by the plan), each block claiming its next item while it
// works on the current one: the heaviest tiles start first, and an empty
// tile costs its stores and little else.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 3) roi_align_bwd_tile_kernel(
    GradLevels lv, const float* __restrict__ boxes,
    const int* __restrict__ levels, const int4* __restrict__ footprint,
    const int* __restrict__ order, int* __restrict__ queue,
    const float* __restrict__ grad_out, int rois_per_image, int c, int pool,
    int chunk, int items) {
  extern __shared__ float4 smem[];
  __shared__ int list[kScan];
  __shared__ int warp_hits[kScanPer * kWarps];
  __shared__ int next;
  for (int item = blockIdx.x; item < items;) {
    if (threadIdx.x == 0) next = gridDim.x + atomicAdd(queue, 1);
    tile_item<T, kVec>(lv, boxes, levels, footprint, order, grad_out,
                       rois_per_image, c, pool, chunk, item, smem, list,
                       warp_hits);
    __syncthreads();
    item = next;
    __syncthreads();   // every thread has read `next`
  }
}

template <typename T, int kVec>
cudaError_t launch_bwd(int items, cudaStream_t st, const GradLevels& lv,
                       const float* b, const int* lvl, const int4* fp,
                       const int* order, int* queue, const float* g,
                       int rois_per_image, int c, int pool, int chunk) {
  constexpr int kSmem =
      kTileH * kCopies * (kTileW + 1) * 32 * kVec * sizeof(float);
  const auto kernel = roi_align_bwd_tile_kernel<T, kVec>;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t attr = once_per_device(done, [kernel] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  });
  if (attr != cudaSuccess) return attr;
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, kSmem);
  }
  if (err != cudaSuccess) return err;
  const int blocks = min(items, max(1, sms * per_sm));
  kernel<<<blocks, kThreads, kSmem, st>>>(lv, b, lvl, fp, order, queue, g,
                                          rois_per_image, c, pool, chunk,
                                          items);
  return cudaGetLastError();
}

}  // namespace

// The gradient of roi_align_forward (no `valid`) with respect to the four
// feature levels. out: bf16 when is_bf16, else float32, num_images *
// channels * sum_l h_l * w_l elements, level l at the offset of the levels
// before it (NHWC each); every element is written. scratch: `scratch_len`
// int32, at least 4 per ROI (the footprints), one per (image, tile) pair
// of kTileH x kTileW pixels (the planned order) and one (the work queue).
// boxes as in roi_align_forward; levels int32 (clamped into 0..3 here);
// grad_out float32 [rois, pool, pool, channels]. Two launches on
// `stream`: the plan (one block), then the tiles (persistent blocks, a few
// per SM, over one item per channel slice and (image, tile) pair).
// Returns the first failing launch's cudaError_t (cudaErrorInvalidValue
// for a short scratch). The vector path needs channels a multiple of 4,
// grad_out on 16 bytes and every level on 16 bytes (float32) or 8 (bf16);
// anything else runs the scalar path.
extern "C" int roi_align_backward(
    void* out, void* scratch, int scratch_len,
    int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
    int s0, int s1, int s2, int s3,
    const void* boxes, const void* levels, const void* grad_out,
    int num_images, int rois_per_image, int channels, int pool, int is_bf16,
    void* stream) {
  const int hl[4] = {h0, h1, h2, h3};
  const int wl[4] = {w0, w1, w2, w3};
  const int sl[4] = {s0, s1, s2, s3};
  const size_t elem = is_bf16 ? 2 : 4;
  GradLevels lv;
  size_t offset = 0;
  lv.first_tile[0] = 0;
  bool aligned = true, aligned16_all = true;
  for (int l = 0; l < 4; ++l) {
    lv.ptr[l] = static_cast<char*>(out) + offset * elem;
    lv.h[l] = hl[l];
    lv.w[l] = wl[l];
    lv.stride[l] = sl[l];
    lv.tiles_x[l] = (wl[l] + kTileW - 1) / kTileW;
    lv.first_tile[l + 1] = lv.first_tile[l] +
                           lv.tiles_x[l] * ((hl[l] + kTileH - 1) / kTileH);
    offset += (size_t)num_images * hl[l] * wl[l] * channels;
    const uintptr_t a = reinterpret_cast<uintptr_t>(lv.ptr[l]);
    aligned &= (a & (is_bf16 ? 7 : 15)) == 0;
    aligned16_all &= (a & 15) == 0;
  }
  const int n = num_images * rois_per_image;
  const int pairs = num_images * lv.first_tile[4];
  if (pairs == 0 || channels == 0) return 0;
  if ((size_t)scratch_len < 4 * (size_t)n + pairs + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  const int* lvl = static_cast<const int*>(levels);
  int4* fp = static_cast<int4*>(scratch);
  int* order = static_cast<int*>(scratch) + 4 * (size_t)n;
  int* queue = order + pairs;
  const float* g = static_cast<const float*>(grad_out);
  roi_bwd_plan_kernel<<<1, kPlanThreads, 0, st>>>(
      lv, b, lvl, fp, order, queue, num_images, rois_per_image, pool);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = channels % 4 == 0 && aligned16(g) && aligned;
  const int slice = vec ? 128 : 32;
  const int items = pairs * ((channels + slice - 1) / slice);
  if (is_bf16) {
    const int chunk = !vec ? 1 : (channels % 8 == 0 && aligned16_all) ? 8 : 4;
    err = vec ? launch_bwd<__nv_bfloat16, 4>(items, st, lv, b, lvl, fp, order,
                                             queue, g, rois_per_image,
                                             channels, pool, chunk)
              : launch_bwd<__nv_bfloat16, 1>(items, st, lv, b, lvl, fp, order,
                                             queue, g, rois_per_image,
                                             channels, pool, chunk);
  } else {
    err = vec ? launch_bwd<float, 4>(items, st, lv, b, lvl, fp, order, queue,
                                     g, rois_per_image, channels, pool, 4)
              : launch_bwd<float, 1>(items, st, lv, b, lvl, fp, order, queue,
                                     g, rois_per_image, channels, pool, 1);
  }
  return static_cast<int>(err);
}


// ---------------------------------------------------------------------------
// B1e: the gradient of the forward above with respect to the boxes.
//
// The JAX package has no Pallas kernel for it either: the small-object
// heads' loss (object_detection_tracking_tpu/models/faster_rcnn.py
// `_so_train_loss` :823) pools boxes decoded from the box head's output
// through the exact gather (ops/roi_align.py:136-181), and XLA's autodiff
// takes the gradient back into those boxes. Its spec here is autograd of
// the plain `multilevel_roi_align` with respect to the boxes
// (ops/roi_align.py `multilevel_roi_align_box_vjp`).
//
// The function. Sample (sy, sx) of a ROI's 2P x 2P grid sits at
// iy(sy) = y0 / s + ((y1 - y0) / s / 2P) (sy + 0.5) - 0.5 on its level
// (stride s), likewise ix(sx); an in-map sample is the bilinear mix of its
// four clipped neighbours with fractions fy = iy - floor(iy), fx. Of all
// that, only fy and fx carry a gradient (floor, the clipping and the
// level's choice are piecewise constant), so with g = dL/dout of the
// sample's bin and the 2x2 mean's 1/4:
//   dL/diy(sy) = sum over its bins' samples and channels of
//                g / 4 * (bot - top),   top = v00 (1 - fx) + v01 fx,
//                                       bot = v10 (1 - fx) + v11 fx;
//   dL/dix(sx) = sum of g / 4 * ((1 - fy)(v01 - v00) + fy (v11 - v10));
// and then through the grid's linear dependence on the box, in the plain
// autograd's order: with G = sum_s dL/di(s) and G' = sum_s dL/di(s) (s +
// 0.5), dL/dlo = (G - G' / 2P) / s and dL/dhi = (G' / 2P) / s. A sample
// outside the map adds nothing; one on the last row (iy = h - 1) has both
// neighbours on that row, so its bot - top is 0, as in the plain version.
//
// The design. One block per ROI, as in the forward, whose sample placement
// (`lane_samples`, `bin_taps`) and 16 neighbour loads per bin it reuses:
// the warps stride over the P x P bins; a lane owns kVec channels and reads
// their grad_out with the neighbours, and adds its share of the bin's four
// samples' two sums in float32 registers; the warp reduces the eight sums by
// shuffles, and lane 0 adds them into the warp's own row of shared sample
// sums. After a barrier warp 0 adds the rows in warp order, takes the two
// moments per axis and writes the ROI's 4 floats. No atomics, so two
// launches agree bit for bit. Bytes bound it: grad_out read once (float32)
// and the feature pixels the taps reach, as for the forward; what is
// written is 16 bytes a ROI.

namespace {

// kVec float32 values of grad_out at p (16-byte loads on the vector path).
template <int kVec>
__device__ __forceinline__ void load_grad(const float* p, float (&g)[kVec]) {
  if constexpr (kVec == 1) {
    g[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      g[i] = q.x; g[i + 1] = q.y; g[i + 2] = q.z; g[i + 3] = q.w;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 2) roi_align_box_grad_kernel(
    Levels lv, const float* __restrict__ boxes,
    const int* __restrict__ levels, const float* __restrict__ grad_out,
    float* __restrict__ out, int rois_per_image, int c, int pool) {
  using Ch = Chunk<T, kVec>;
  __shared__ float sum_y[kWarps][64];   // dL/diy by sample, one row a warp
  __shared__ float sum_x[kWarps][64];
  const int roi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int size2 = 2 * pool;
  sum_y[warp][lane] = sum_y[warp][lane + 32] = 0.f;
  sum_x[warp][lane] = sum_x[warp][lane + 32] = 0.f;
  __syncwarp();

  const int l = min(max(levels[roi], 0), lv.count - 1);
  const int h = lv.h[l];
  const int w = lv.w[l];
  const float s = (float)lv.stride[l];
  const LaneSamples ls = lane_samples(boxes + (size_t)roi * 4, s, h, w,
                                      size2, lane);
  const T* feat = static_cast<const T*>(lv.ptr[l]) +
                  (size_t)(roi / rois_per_image) * h * w * c;
  const float* g_roi = grad_out + (size_t)roi * pool * pool * c;
  for (int bin = warp; bin < pool * pool; bin += kWarps) {   // warp-uniform
    const int py = bin / pool;
    const int px = bin - py * pool;
    const BinTaps t = bin_taps(ls, py, px, h, w);
    // the bin's samples (ky, kx): sum over the lane's channels of
    // g * (bot - top) and of g * d/dix (with the 1/4 folded in t.wy)
    float ay[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float ax[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int c0 = lane * kVec; c0 < c; c0 += 32 * kVec) {
      typename Ch::Raw raw[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int ky = q >> 3, kx = (q >> 2) & 1, ry = (q >> 1) & 1,
                  rx = q & 1;
        raw[q] = (t.yin[ky] && t.xin[kx])
                     ? Ch::load(feat + (size_t)(t.row[ky][ry] + t.col[kx][rx])
                                * c + c0)
                     : typename Ch::Raw{};
      }
      float g[kVec];
      load_grad<kVec>(g_roi + (size_t)bin * c + c0, g);
#pragma unroll
      for (int ky = 0; ky < 2; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
          const int q = ky * 8 + kx * 4;   // corner (0, 0) of the sample
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float v00 = Ch::get(raw[q], j);
            const float v01 = Ch::get(raw[q + 1], j);
            const float v10 = Ch::get(raw[q + 2], j);
            const float v11 = Ch::get(raw[q + 3], j);
            const float top = v00 * t.wx[kx][0] + v01 * t.wx[kx][1];
            const float bot = v10 * t.wx[kx][0] + v11 * t.wx[kx][1];
            ay[ky][kx] = fmaf(g[j], bot - top, ay[ky][kx]);
            const float dx = (v01 - v00) * t.wy[ky][0] +
                             (v11 - v10) * t.wy[ky][1];
            ax[ky][kx] = fmaf(g[j], dx, ax[ky][kx]);
          }
        }
      }
    }
#pragma unroll
    for (int ky = 0; ky < 2; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 2; ++kx) {
        ay[ky][kx] = warp_sum(ay[ky][kx]);
        ax[ky][kx] = warp_sum(ax[ky][kx]);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        sum_y[warp][2 * py + k] += 0.25f * (ay[k][0] + ay[k][1]);
        sum_x[warp][2 * px + k] += ax[0][k] + ax[1][k];
      }
    }
    __syncwarp();
  }
  __syncthreads();

  if (warp == 0) {
    // per axis, G = sum_s dL/di(s) and G' = sum_s dL/di(s) (s + 0.5); lane
    // i holds samples i and i + 32
    float m[4] = {0.f, 0.f, 0.f, 0.f};   // G_y, G'_y, G_x, G'_x
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = lane + 32 * k;
      if (i < size2) {
        float gy = 0.f, gx = 0.f;
        for (int q = 0; q < kWarps; ++q) {
          gy += sum_y[q][i];
          gx += sum_x[q][i];
        }
        const float at = (float)i + 0.5f;
        m[0] += gy;
        m[1] = fmaf(gy, at, m[1]);
        m[2] += gx;
        m[3] = fmaf(gx, at, m[3]);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = warp_sum(m[k]);
    if (lane == 0) {
      const float sp_y = __fdiv_rn(m[1], (float)size2);
      const float sp_x = __fdiv_rn(m[3], (float)size2);
      float* o = out + (size_t)roi * 4;
      o[0] = __fdiv_rn(m[2] - sp_x, s);   // x0
      o[1] = __fdiv_rn(m[0] - sp_y, s);   // y0
      o[2] = __fdiv_rn(sp_x, s);          // x1
      o[3] = __fdiv_rn(sp_y, s);          // y1
    }
  }
}

template <typename T, int kVec>
cudaError_t launch_box_grad(const dim3& grid, cudaStream_t st,
                            const Levels& lv, const float* b, const int* lvl,
                            const float* g, float* o, int rois_per_image,
                            int c, int pool) {
  static std::atomic<unsigned long long> done{0};
  const cudaError_t carveout = once_per_device(done, [] {
    return cudaFuncSetAttribute(roi_align_box_grad_kernel<T, kVec>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxL1);
  });
  if (carveout != cudaSuccess) return carveout;
  roi_align_box_grad_kernel<T, kVec><<<grid, kThreads, 0, st>>>(
      lv, b, lvl, g, o, rois_per_image, c, pool);
  return cudaGetLastError();
}

}  // namespace

// The gradient of roi_align_forward (no `valid`) with respect to the
// boxes. f0..f3: the four levels as in roi_align_forward (float32 or bf16);
// boxes float32 [rois, 4] image coords; levels int32 (clamped into 0..3
// here); grad_out float32 [rois, pool, pool, channels]; out float32
// [rois, 4] (x0, y0, x1, y1), every element written. One block per ROI,
// pool <= 32. The vector path needs channels a multiple of 8 (bf16) or 4
// (float32) and every level and grad_out on 16 bytes; anything else runs
// the scalar path. Launches on `stream`, returns the launch's cudaError_t.
extern "C" int roi_align_box_grad(
    const void* f0, const void* f1, const void* f2, const void* f3,
    int h0, int w0, int h1, int w1, int h2, int w2, int h3, int w3,
    int s0, int s1, int s2, int s3,
    const void* boxes, const void* levels, const void* grad_out, void* out,
    int num_images, int rois_per_image, int channels, int pool, int is_bf16,
    void* stream) {
  if (pool < 1 || pool > 32) return static_cast<int>(cudaErrorInvalidValue);
  const void* const fl[4] = {f0, f1, f2, f3};
  const int hl[4] = {h0, h1, h2, h3};
  const int wl[4] = {w0, w1, w2, w3};
  const int sl[4] = {s0, s1, s2, s3};
  Levels lv;
  lv.count = 4;
  bool aligned = aligned16(grad_out);
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < 4;
    lv.ptr[l] = used ? fl[l] : nullptr;
    lv.h[l] = used ? hl[l] : 0;
    lv.w[l] = used ? wl[l] : 0;
    lv.stride[l] = used ? sl[l] : 1;
    aligned &= !used || aligned16(fl[l]);
  }
  const int n = num_images * rois_per_image;
  if (n == 0) return 0;
  const dim3 grid(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  const int* lvl = static_cast<const int*>(levels);
  const float* g = static_cast<const float*>(grad_out);
  float* o = static_cast<float*>(out);
  const bool vec = aligned && channels % (is_bf16 ? 8 : 4) == 0;
  cudaError_t err;
  if (is_bf16) {
    err = vec ? launch_box_grad<__nv_bfloat16, 8>(grid, st, lv, b, lvl, g, o,
                                                  rois_per_image, channels,
                                                  pool)
              : launch_box_grad<__nv_bfloat16, 1>(grid, st, lv, b, lvl, g, o,
                                                  rois_per_image, channels,
                                                  pool);
  } else {
    err = vec ? launch_box_grad<float, 4>(grid, st, lv, b, lvl, g, o,
                                          rois_per_image, channels, pool)
              : launch_box_grad<float, 1>(grid, st, lv, b, lvl, g, o,
                                          rois_per_image, channels, pool);
  }
  return static_cast<int>(err);
}
