// Exact greedy NMS keep masks for Hopper (sm_90a), with no host sync
// (kernel N1).
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's
// device-side fixpoint, `_greedy_keep` in object_detection_tracking_tpu/
// ops/nms.py (:33-53), whose convergence test stays on the device inside a
// `lax.while_loop`. The port's plain version (ops/nms.py
// `greedy_keep_plain`) runs the same Jacobi fixpoint and tests it on the
// host every few steps, which blocks the issuing thread and cannot be held
// by torch.export or a CUDA-graph capture. This kernel computes the
// fixpoint's unique solution directly:
//
//   keep[i] = valid[i] & ~OR_{j<i} (keep[j] & m[j, i]),
//   m[j, i] = IOU(j, i) > thres & valid[j] & valid[i]   (strict, float32)
//
// over score-sorted boxes, independently for each group (an image and an
// FPN level, or an image and a class), so the keep masks are bit-equal to
// the plain version's.
//
// Two launches on the caller's stream, no allocation (the wrapper passes
// the scratch), no sync:
//   (a) nms_mask: one 64-thread block per 64 x 64 tile of the upper
//       triangle of m of one group; thread t holds row j = 64 * row_tile +
//       t and writes the 64-bit word of the later boxes of the column tile
//       that j suppresses. The column tile's boxes are staged in shared
//       memory. IOU follows ops/boxes.py pairwise_iou's operations in its
//       order with IEEE round-to-nearest intrinsics (no FMA contraction),
//       NaN propagated as torch.minimum/maximum/clamp_min do, and
//       `union > 0 ? inter / union : 0`, compared with the threshold as a
//       float32, as torch compares a float32 tensor with a Python float.
//   (b) nms_scan: one warp per group walks the sorted boxes once, 64 at a
//       time. The removed-set of the group lives in shared memory, one bit
//       a box. For a 64-box block, the block's own words of m (the diagonal
//       tile) are held in two registers a lane and read by __shfl_sync, so
//       the serial decisions are register operations; then each lane ORs
//       the kept rows into its share of the later removed words, loading
//       kBatch rows' words before it uses them.
//
// What bounds it on the H100: neither bytes nor operations at the path's
// sizes (the proposals' 40 groups of 1000 boxes: 0.7 MB in and out, 2e7
// IOUs); the scan's chain of dependent decisions (one per box) and the
// launch latency do. The mask (N x ceil(N / 64) words a group, 5.1 MB at
// the proposals) is written and read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;
constexpr int kBatch = 8;  // kept rows whose words a lane loads at once
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// torch.minimum / torch.maximum: NaN if either is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? nan_f() : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}
// torch.clamp_min(x, 0): NaN stays NaN
__device__ __forceinline__ float clamp0(float x) {
  return x != x ? x : fmaxf(x, 0.0f);
}

// IOU(j, i) > thres, in pairwise_iou's operations and order (ops/boxes.py)
__device__ __forceinline__ bool suppresses(const float* bj, const float* bi,
                                           float thres) {
  const float w = clamp0(__fsub_rn(tmin(bj[2], bi[2]), tmax(bj[0], bi[0])));
  const float h = clamp0(__fsub_rn(tmin(bj[3], bi[3]), tmax(bj[1], bi[1])));
  const float inter = __fmul_rn(w, h);
  const float aj = __fmul_rn(__fsub_rn(bj[2], bj[0]), __fsub_rn(bj[3], bj[1]));
  const float ai = __fmul_rn(__fsub_rn(bi[2], bi[0]), __fsub_rn(bi[3], bi[1]));
  const float uni = __fsub_rn(__fadd_rn(aj, ai), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thres;
}

__global__ void __launch_bounds__(kTile)
    nms_mask(const float* __restrict__ boxes,
             const unsigned char* __restrict__ valid, u64* __restrict__ mask,
             int n, int words, float thres) {
  const int ct = blockIdx.x, rt = blockIdx.y;
  if (ct < rt) return;  // m[j, i] is zero below the diagonal: never read
  const size_t g = blockIdx.z;
  boxes += g * n * 4;
  valid += g * n;
  mask += g * n * words;
  __shared__ float cbox[kTile][4];
  __shared__ unsigned char cvalid[kTile];
  const int t = threadIdx.x;
  const int ci = ct * kTile + t;
  if (ci < n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) cbox[t][c] = boxes[(size_t)ci * 4 + c];
    cvalid[t] = valid[ci];
  }
  __syncthreads();
  const int j = rt * kTile + t;
  if (j >= n) return;
  float bj[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) bj[c] = boxes[(size_t)j * 4 + c];
  u64 bits = 0;
  if (valid[j]) {
    const int cnt = min(kTile, n - ct * kTile);
    for (int k = 0; k < cnt; ++k) {
      if (ct * kTile + k > j && cvalid[k] && suppresses(bj, cbox[k], thres)) {
        bits |= 1ull << k;
      }
    }
  }
  mask[(size_t)j * words + ct] = bits;
}

__global__ void __launch_bounds__(32)
    nms_scan(const u64* __restrict__ mask,
             const unsigned char* __restrict__ valid,
             unsigned char* __restrict__ keep, int n, int words) {
  extern __shared__ u64 removed[];
  const size_t g = blockIdx.x;
  mask += g * n * words;
  valid += g * n;
  keep += g * n;
  const int lane = threadIdx.x;
  for (int w = lane; w < words; w += 32) removed[w] = 0;
  __syncwarp();
  for (int nb = 0; nb < words; ++nb) {
    const int base = nb * kTile;
    const int r0 = base + lane, r1 = base + 32 + lane;
    // the diagonal tile's words and the block's valid bits
    const u64 d0 = r0 < n ? mask[(size_t)r0 * words + nb] : 0ull;
    const u64 d1 = r1 < n ? mask[(size_t)r1 * words + nb] : 0ull;
    const u64 vbits =
        (u64)__ballot_sync(kFull, r0 < n && valid[r0]) |
        ((u64)__ballot_sync(kFull, r1 < n && valid[r1]) << 32);
    u64 cur = removed[nb];
    u64 kept = 0;
    const int cnt = min(kTile, n - base);
    for (int k = 0; k < cnt; ++k) {
      const u64 row = __shfl_sync(kFull, k < 32 ? d0 : d1, k & 31);
      if (((vbits & ~cur) >> k) & 1ull) {
        kept |= 1ull << k;
        cur |= row;
      }
    }
    if (r0 < n) keep[r0] = (kept >> lane) & 1ull;
    if (r1 < n) keep[r1] = (kept >> (32 + lane)) & 1ull;
    // the kept rows into the later removed words, a word per lane; the
    // rows' loads are issued kBatch at a time, so their latencies overlap
    for (int w = nb + 1 + lane; w < words; w += 32) {
      u64 acc = removed[w];
      u64 rest = kept;
      while (rest) {
        u64 row[kBatch];
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          row[t] = 0ull;
          if (rest) {
            const int k = __ffsll((long long)rest) - 1;
            rest &= rest - 1;
            row[t] = mask[(size_t)(base + k) * words + w];
          }
        }
#pragma unroll
        for (int t = 0; t < kBatch; ++t) acc |= row[t];
      }
      removed[w] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

// keep [groups, n] (bool) of score-sorted boxes [groups, n, 4] float32 and
// valid [groups, n] (bool), all contiguous; mask: scratch of groups x n x
// ceil(n / 64) 64-bit words. Returns a cudaError_t (0 on success).
extern "C" int nms_keep(const void* boxes, const void* valid, void* keep,
                        void* mask, int groups, int n, float thres,
                        void* stream) {
  if (groups <= 0 || n <= 0) return 0;
  const int words = (n + kTile - 1) / kTile;
  const size_t smem = (size_t)words * sizeof(u64);
  if (groups > 65535 || words > 65535 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask<<<dim3(words, words, groups), kTile, 0, s>>>(
      static_cast<const float*>(boxes),
      static_cast<const unsigned char*>(valid), static_cast<u64*>(mask), n,
      words, thres);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan<<<groups, 32, smem, s>>>(
      static_cast<const u64*>(mask), static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(keep), n, words);
  return static_cast<int>(cudaGetLastError());
}
