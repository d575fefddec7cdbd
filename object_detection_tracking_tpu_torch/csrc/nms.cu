// Exact greedy NMS keep masks for Hopper (sm_90a), in one launch, with no
// scratch in device memory and no host sync (kernel N1).
//
// Replaces no Pallas kernel: it is the counterpart of the JAX package's
// device-side fixpoint, `_greedy_keep` in object_detection_tracking_tpu/
// ops/nms.py (:33-53), whose convergence test stays on the device inside a
// `lax.while_loop`. The port's plain version (ops/nms.py
// `greedy_keep_plain`) runs the same Jacobi fixpoint and tests it on the
// host every few steps. This kernel computes the fixpoint's unique
// solution directly:
//
//   keep[i] = valid[i] & ~OR_{j<i} (keep[j] & m[j, i]),
//   m[j, i] = IOU(j, i) > thres & valid[j] & valid[i]   (strict, float32)
//
// over score-sorted boxes, independently for each group (an image and an
// FPN level, or an image and a class), so the keep masks are bit-equal to
// the plain version's.
//
// Design. A group's boxes (16 bytes each), their areas, its valid bits,
// removed set and kept words live in shared memory; the only device memory
// written is `keep`. The boxes are taken in the greedy order, 64 (a word)
// at a time:
//   0. up front, in parallel: the diagonal 64 x 64 tile of every word, as
//      column words (bit j of colw[i]: box j of the same word, j < i,
//      suppresses box i; IOU is symmetric in pairwise_iou's operations):
//      a warp's lanes hold the word's 64 rows, and the warp walks the
//      word's valid columns, two ballots a column;
//   1. the word's kept set is resolved by one warp: Jacobi sweeps
//      (kept = cand & ~{i : colw[i] & kept}, two ballots a sweep) from
//      kept = cand = valid & ~removed until nothing changes, which is the
//      greedy answer for the word (the fixpoint argument above, within a
//      word);
//   2. only the kept rows of the word are tested, and only against the
//      later boxes that are valid and not yet removed: in each warp the
//      lanes hold the kept rows (lane t the t-th and the (32 + t)-th), and
//      a warp item walks the candidates of 32 later boxes (or of a slice
//      of them, where the items are fewer than the warps), one vote a
//      candidate, whose box is read once for all kept rows; an item's
//      removed bits are ORed into the removed set (a shared-memory
//      atomicOr).
// So the IOUs tested are the diagonal tiles and (kept box, later candidate)
// pairs: the pairs the bound in chip_smoke.py counts, or fewer.
//
// Launch regime, chosen from `groups` and the card's SM count (nms_plan):
//   * groups more than half the SMs (the predictions' 120, EfficientDet's
//     720): one CTA of kThreads threads a group;
//   * fewer groups (the proposals' 40, the training step's 10, the
//     small-object heads' 24): a thread-block cluster of C CTAs a group, C
//     a power of two up to kMaxCluster and the group's word count, the
//     largest with groups x C within the SMs (2, 8 and 4 CTAs at
//     those three on an H100's 132 SMs). CTA r owns the words w with
//     w % C == r (their
//     diagonal tiles, removed words and keep bytes); the owner of the
//     current word resolves it and stores the kept word into every CTA's
//     shared memory (distributed shared memory), and a cluster barrier
//     publishes it before every CTA tests it against its own later boxes.
// Per word: one cluster barrier (or __syncthreads) and one __syncthreads.
//
// IOU follows ops/boxes.py pairwise_iou's operations in its order with
// IEEE round-to-nearest intrinsics (no FMA contraction), NaN propagated as
// torch.minimum/maximum/clamp_min do, `union > 0 ? inter / union : 0`,
// compared with the threshold as a float32. Where the intersection is +-0
// or NaN (disjoint or degenerate boxes, NaN coordinates), the IOU is 0
// whatever the union, so the test is exactly `0 > thres` and the areas,
// union and division are skipped. A box's area is computed once, with the
// same two intrinsics.
//
// What bounds it on the H100: neither bytes nor operations at the path's
// sizes (the proposals' 40 groups of 1000 boxes: 0.7 MB in and out, ~1e7
// IOUs). The kept rows' tests, a few hundred cycles a candidate's step on
// a warp, take about three quarters of the time at the proposals; the
// chain of dependent per-word decisions (16 words at 1000 boxes, 32 at
// 2000: each a resolve and a barrier or two) and the launch take the
// rest, the design's floor (PERF.md, tools/torch_nms_ab.py --floor). The
// cluster spreads each word's tests over C SMs. Measured and not kept:
// four candidates a step (more instructions, no faster), an approximate
// reciprocal before the division, a vote on overlap before the tests,
// flags in place of the cluster barrier, 8 or 32 warps, clusters past
// the SM count, the resolve in order on one thread.
//
// Limits: n <= kMaxN (8192) boxes a group (the shared memory of one CTA);
// boxes 16-byte aligned.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxN = 8192;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float tmin(float a, float b) {
  float d;  // torch.minimum: NaN if either is NaN
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float tmax(float a, float b) {
  float d;  // torch.maximum: NaN if either is NaN
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IOU(j, i) > thres, in pairwise_iou's operations and order (ops/boxes.py);
// aj, ai: box_area of bj, bi
__device__ __forceinline__ bool suppresses(float4 bj, float aj, float4 bi,
                                           float ai, float thres) {
  // clamp_min(x, 0) keeps NaN: max.NaN
  const float w = tmax(__fsub_rn(tmin(bj.z, bi.z), tmax(bj.x, bi.x)), 0.0f);
  const float h = tmax(__fsub_rn(tmin(bj.w, bi.w), tmax(bj.y, bi.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  if (!(inter > 0.0f)) return 0.0f > thres;  // +-0 or NaN: IOU 0
  const float uni = __fsub_rn(__fadd_rn(aj, ai), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thres;
}

// shared memory of one CTA for n boxes in `words` words
__host__ __device__ constexpr size_t smem_bytes(int n, int words) {
  return (size_t)n * sizeof(float4) + (size_t)words * kTile * sizeof(u64) +
         3 * (size_t)words * sizeof(u64) + (size_t)n * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
    nms_keep_kernel(const float4* __restrict__ boxes,
                    const unsigned char* __restrict__ valid,
                    unsigned char* __restrict__ keep, int n, int words,
                    int csize, float thres) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* box = reinterpret_cast<float4*>(smem);
  u64* colw = reinterpret_cast<u64*>(box + n);  // words * 64
  u64* vbits = colw + (size_t)words * kTile;
  u64* removed = vbits + words;
  u64* kept = removed + words;
  float* area = reinterpret_cast<float*>(kept + words);
  unsigned* vbits32 = reinterpret_cast<unsigned*>(vbits);
  unsigned* removed32 = reinterpret_cast<unsigned*>(removed);

  const int rank = csize > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t g = blockIdx.x / csize;
  boxes += g * n;
  valid += g * n;
  keep += g * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < n; i += kThreads) {
    const float4 b = boxes[i];
    box[i] = b;
    area[i] = box_area(b);
  }
  for (int q = warp; q < 2 * words; q += kWarps) {
    const int i = 32 * q + lane;
    const unsigned v = __ballot_sync(kFull, i < n && valid[i]);
    if (lane == 0) {
      vbits32[q] = v;
      removed32[q] = 0u;
    }
  }
  __syncthreads();

  // 0. the diagonal tiles of the owned words, as column words: items
  // (word, half of its columns); lanes hold rows lane and 32 + lane of the
  // word, and the warp walks the half's valid columns, one ballot a half
  const int owned = rank < words ? (words - 1 - rank) / csize + 1 : 0;
  for (int item = warp; item < 2 * owned; item += kWarps) {
    const int w = rank + csize * (item >> 1), base = w * kTile;
    const float4 r0 = box[min(base + lane, n - 1)];
    const float4 r1 = box[min(base + 32 + lane, n - 1)];
    const float a0 = area[min(base + lane, n - 1)];
    const float a1 = area[min(base + 32 + lane, n - 1)];
    const bool v0 = (vbits32[2 * w] >> lane) & 1u;
    const bool v1 = (vbits32[2 * w + 1] >> lane) & 1u;
    const int h = item & 1;
    unsigned cols = vbits32[2 * w + h];
    for (int c = 0; c < 32; ++c) {
      const int ci = 32 * h + c, i = base + ci;
      u64 bits = 0ull;
      if ((cols >> c) & 1u) {  // uniform across the warp
        const float4 bi = box[i];
        const float ai = area[i];
        const bool s0 = v0 && lane < ci && suppresses(r0, a0, bi, ai, thres);
        const bool s1 =
            v1 && 32 + lane < ci && suppresses(r1, a1, bi, ai, thres);
        bits = (u64)__ballot_sync(kFull, s0) |
               ((u64)__ballot_sync(kFull, s1) << 32);
      }
      if (lane == 0) colw[i] = bits;
    }
  }
  if (csize > 1) {
    cg::this_cluster().sync();  // every CTA running, its tiles done
  } else {
    __syncthreads();
  }

  for (int b = 0; b < words; ++b) {
    // 1. the owner resolves word b (its removed word is final) and stores
    // the kept word into every CTA of the cluster
    if (b % csize == rank && warp == 0) {
      const u64 cand = vbits[b] & ~removed[b];
      const u64 c0 = colw[b * kTile + lane], c1 = colw[b * kTile + 32 + lane];
      u64 k = cand;
      while (true) {
        const u64 hit = (u64)__ballot_sync(kFull, (c0 & k) != 0ull) |
                        ((u64)__ballot_sync(kFull, (c1 & k) != 0ull) << 32);
        const u64 next = cand & ~hit;
        if (next == k) break;
        k = next;
      }
      if (csize > 1) {
        if (lane < csize) {
          *cg::this_cluster().map_shared_rank(kept + b, lane) = k;
        }
      } else if (lane == 0) {
        kept[b] = k;
      }
    }
    if (csize > 1) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }

    // 2. word b's kept rows against this CTA's later candidates: lanes
    // hold kept rows t = lane and 32 + lane of the word, a warp item walks
    // the candidates of a slice of 32 later boxes, one vote a candidate
    const u64 kb = kept[b];
    const int first = b + 1;
    const int c0 = first + ((rank - first) % csize + csize) % csize;
    const int chunks = c0 < words ? 2 * ((words - 1 - c0) / csize + 1) : 0;
    if (kb != 0ull && chunks > 0) {
      const int kn = __popcll(kb);
      const unsigned klo = (unsigned)kb, khi = (unsigned)(kb >> 32);
      const int nlo = __popc(klo);
      const int t0 = lane, t1 = 32 + lane;
      const int p0 = t0 < nlo ? __fns(klo, 0, t0 + 1)
                              : 32 + __fns(khi, 0, t0 - nlo + 1);
      const int p1 = 32 + __fns(khi, 0, t1 - nlo + 1);
      const bool h0 = t0 < kn, h1 = t1 < kn;
      const int j0 = b * kTile + (h0 ? p0 : 0), j1 = b * kTile + (h1 ? p1 : 0);
      const float4 r0 = box[j0], r1 = box[j1];
      const float a0 = area[j0], a1 = area[j1];
      int lg = 0;  // slices of a chunk: 2^lg, its columns mod 2^lg
      while (lg < 5 && (chunks << lg) < kWarps) ++lg;
      const unsigned smask = (unsigned)(0xffffffffull / ((1ull << (1 << lg)) - 1ull));
      for (int item = warp; item < (chunks << lg); item += kWarps) {
        const int chunk = item >> lg, sl = item & ((1 << lg) - 1);
        const int w32 = 2 * (c0 + csize * (chunk >> 1)) + (chunk & 1);
        unsigned cand = vbits32[w32] & ~removed32[w32] & (smask << sl);
        unsigned hits = 0u;
        while (cand) {  // uniform across the warp
          const int c = __ffs(cand) - 1;
          cand &= cand - 1u;
          const int i = 32 * w32 + c;
          const float4 bi = box[i];
          const float ai = area[i];
          const bool s = (h0 && suppresses(r0, a0, bi, ai, thres)) ||
                         (h1 && suppresses(r1, a1, bi, ai, thres));
          if (__any_sync(kFull, s)) hits |= 1u << c;
        }
        if (lane == 0 && hits) atomicOr(removed32 + w32, hits);
      }
    }
    if (csize == 1 || (b + 1) % csize == rank) __syncthreads();
  }

  // every kept word is here: the owned words' keep bytes
  for (int t = tid; t < owned * kTile; t += kThreads) {
    const int w = rank + csize * (t / kTile), i = w * kTile + t % kTile;
    if (i < n) keep[i] = (unsigned char)((kept[w] >> (t % kTile)) & 1ull);
  }
}

// A kernel's attribute belongs to the current device's context: set once
// per device (bit d of `done`; a device past 63 sets it at every launch).
cudaError_t set_smem_once() {
  static std::atomic<unsigned long long> done{0};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(nms_keep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxN, kMaxN / kTile));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

struct Plan {
  int cluster, ctas, threads, smem;
};

cudaError_t make_plan(int groups, int n, Plan* p) {
  if (groups <= 0 || n <= 0 || n > kMaxN) return cudaErrorInvalidValue;
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  const int words = (n + kTile - 1) / kTile;
  int c = 1;
  if (groups < sms) {
    while (2 * c <= kMaxCluster && 2 * c <= words &&
           (long long)groups * 2 * c <= (long long)sms) {
      c *= 2;
    }
  }
  if ((long long)groups * c > 0x7fffffffLL) return cudaErrorInvalidValue;
  p->cluster = c;
  p->ctas = groups * c;
  p->threads = kThreads;
  p->smem = (int)smem_bytes(n, words);
  return cudaSuccess;
}

}  // namespace

// The launch nms_keep makes for `groups` groups of n boxes on the current
// device: out[0..3] = cluster size, CTAs, threads a CTA, shared bytes a
// CTA. Returns a cudaError_t (cudaErrorInvalidValue for n > 8192).
extern "C" int nms_plan(int groups, int n, int* out) {
  Plan p;
  const cudaError_t err = make_plan(groups, n, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.cluster;
  out[1] = p.ctas;
  out[2] = p.threads;
  out[3] = p.smem;
  return 0;
}

// keep [groups, n] (bool) of score-sorted boxes [groups, n, 4] float32
// (16-byte aligned) and valid [groups, n] (bool), all contiguous. One
// launch on `stream`, no allocation, no sync. Returns a cudaError_t (0 on
// success; cudaErrorInvalidValue for n > 8192).
extern "C" int nms_keep(const void* boxes, const void* valid, void* keep,
                        int groups, int n, float thres, void* stream) {
  if (groups <= 0 || n <= 0) return 0;
  Plan p;
  cudaError_t err = make_plan(groups, n, &p);
  if (err == cudaSuccess) err = set_smem_once();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, nms_keep_kernel,
                           static_cast<const float4*>(boxes),
                           static_cast<const unsigned char*>(valid),
                           static_cast<unsigned char*>(keep), n,
                           (n + kTile - 1) / kTile, p.cluster, thres);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
