// A stack of stride-1 ResNet bottleneck blocks, inference, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel object_detection_tracking_tpu/ops/pallas/
// resnet_stage_pallas.py (`fused_bottleneck_stage` :110, body `kernel`
// :155). It computes exactly what the plain PyTorch `fused_bottleneck_stage`
// in ops/resnet_stage.py computes, block after block:
//
//   l1  = relu(x  . W1 + b1)            cast to the activation dtype
//   l2  = relu(l1 * W2 + b2)            3x3, zero padding 1, cast
//   l3  = l2 . W3 + b3                  cast
//   sc  = x . Wsc + bsc (first block only, cast) or x
//   out = relu(l3 + sc)                 added in the activation dtype
//
// with frozen BN folded into the weights by the wrapper (f32 biases) and
// every sum in float32. The activations are NHWC; every conv is an
// implicit GEMM: M = B*H*W pixels, N = output channels, K = C_in for a
// 1x1 and 9*C_in for the 3x3, whose taps are gathered from the input with
// out-of-image taps read as zero. Weights are [K, N] matrices, K in
// (dy, dx, c) order. One launch per conv: three per block, four on a block
// with a shortcut conv; `bottleneck_stage_forward` runs the whole stack on
// one stream.
//
// What bounds it on the H100: operations. At the ActEV path's stages (B=8,
// 1088x1920) the convs are 4.1 TFLOP per forward (c2 0.44, c3 tail 0.44,
// c4 tail 3.2), 4.1 ms at the 989 TFLOP/s of dense bf16; the stack's input
// and output are 0.1-0.7 GB per stage, 0.04-0.2 ms at 3.35 TB/s. So the
// design puts the bf16 products on the tensor cores:
//   * a block computes a 128-pixel x 64- or 128-channel output tile with 8
//     warps, each a 32 x (BN/2) tile of 16x16x16 bf16 WMMA products with
//     float32 accumulators;
//   * K runs in 32-deep stages, double-buffered in shared memory, filled by
//     16-byte cp.async copies (zero-filled for out-of-image taps and ragged
//     edges), so the gather of the next stage overlaps this stage's MMAs;
//   * the epilogue (bias, cast, residual add, relu) stages each 16x16
//     accumulator tile through shared memory and writes 16-byte vectors.
// float32 activations take plain FMA (not TF32) on the same tiles, so that
// the f32 check against the plain version holds to float32 rounding.
//
// Not done here (first perf work, ROADMAP): the Pallas kernel's point is to
// keep l1/l2 of a pixel tile on chip; here every intermediate goes through
// device memory (l1, l2: 2 x M x width; the shortcut's output; one block
// output), about 5 round trips per block. Keeping a row tile's l1/l2 in
// shared memory, TMA loads and wgmma are the next design.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (object_detection_tracking_tpu_torch/native.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // output pixels per block

// One conv of the stack, with its epilogue.
struct Conv {
  const void* in;      // [M, C] NHWC activations
  const void* w;       // [K, N] folded weights, K = taps * C
  const float* bias;   // [N] folded-BN offset
  const void* res;     // [M, N] residual to add before the relu, or null
  void* out;           // [M, N]
  long long M;         // pixels, B * H * W
  int H, W;            // image extents, for the 3x3 taps
  int C, N, K;
  int taps;            // 1 (1x1) or 9 (3x3, zero padding 1)
  int relu;            // relu after the bias (a residual always ends in relu)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; with pred false it reads
// nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Bias, then the Pallas kernel's rounding points: a residual conv casts
// l3 to T, adds the residual in T (one rounding of the f32 sum) and relus;
// otherwise an optional relu and the cast.
template <typename T>
__device__ __forceinline__ T epilogue(const Conv& a, float acc, long long m,
                                      int n) {
  float v = acc + a.bias[n];
  if (a.res != nullptr) {
    const float l3 = to_f32(from_f32<T>(v));
    const float r = to_f32(static_cast<const T*>(a.res)[m * a.N + n]);
    return from_f32<T>(fmaxf(l3 + r, 0.0f));
  }
  if (a.relu) v = fmaxf(v, 0.0f);
  return from_f32<T>(v);
}

// Tile geometry per activation type: bf16 stages 32 of K, f32 16, so that
// both double-buffered stages fit the 48 KB of static shared memory.
template <typename T, int BN>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);           // elements per copy
  static constexpr int BK = sizeof(T) == 2 ? 32 : 16;  // K per stage
  static constexpr int LDA = BK + VEC;                 // padded row pitches
  static constexpr int LDB = BN + VEC;
  static constexpr int A_ELEMS = kBM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int A_VECS_PER_ROW = BK / VEC;  // 4 for both types
  static constexpr int A_ROWS_PER_PASS = kThreads / A_VECS_PER_ROW;
  static constexpr int A_PASSES = kBM / A_ROWS_PER_PASS;
  static constexpr int B_VECS_PER_ROW = BN / VEC;
  static constexpr int B_VECS = BK * B_VECS_PER_ROW;
  static constexpr int SMEM_BYTES = 2 * STAGE * (int)sizeof(T);
};

// Fills one stage of the A (gathered activations) and B (weights) tiles.
// The pixels a thread copies are fixed over the K loop, so their image
// coordinates are computed once.
template <typename T, int BN>
struct Loader {
  using G = Tile<T, BN>;
  const T* in;
  const T* w;
  long long m[G::A_PASSES];  // -1 past the last pixel
  int y[G::A_PASSES], x[G::A_PASSES];
  int kc;                    // this thread's K offset inside a stage
  int n0;

  __device__ void init(const Conv& a, long long m0, int n0_, int tid) {
    in = static_cast<const T*>(a.in);
    w = static_cast<const T*>(a.w);
    n0 = n0_;
    kc = (tid % G::A_VECS_PER_ROW) * G::VEC;
    const long long hw = (long long)a.H * a.W;
#pragma unroll
    for (int p = 0; p < G::A_PASSES; ++p) {
      const long long mm =
          m0 + tid / G::A_VECS_PER_ROW + p * G::A_ROWS_PER_PASS;
      m[p] = mm < a.M ? mm : -1;
      const long long pix = mm % hw;
      y[p] = (int)(pix / a.W);
      x[p] = (int)(pix % a.W);
    }
  }

  __device__ void load(const Conv& a, T* stage, int k0, int tid) const {
    T* As = stage;
    T* Bs = stage + G::A_ELEMS;
    const int k = k0 + kc;
    int dy = 0, dx = 0, c = k;
    if (a.taps == 9) {
      const int tap = k / a.C;
      c = k - tap * a.C;
      dy = tap / 3 - 1;
      dx = tap % 3 - 1;
    }
#pragma unroll
    for (int p = 0; p < G::A_PASSES; ++p) {
      const int row = tid / G::A_VECS_PER_ROW + p * G::A_ROWS_PER_PASS;
      const int yy = y[p] + dy, xx = x[p] + dx;
      const bool ok = m[p] >= 0 && k < a.K && yy >= 0 && yy < a.H &&
                      xx >= 0 && xx < a.W;
      const T* src =
          ok ? in + (m[p] + (long long)dy * a.W + dx) * a.C + c : in;
      cp_async16(As + row * G::LDA + kc, src, ok);
    }
    for (int v = tid; v < G::B_VECS; v += kThreads) {
      const int kr = v / G::B_VECS_PER_ROW;
      const int nc = (v % G::B_VECS_PER_ROW) * G::VEC;
      const int kk = k0 + kr, n = n0 + nc;
      const bool ok = kk < a.K && n < a.N;
      const T* src = ok ? w + (long long)kk * a.N + n : w;
      cp_async16(Bs + kr * G::LDB + nc, src, ok);
    }
  }
};

// bf16: tensor cores (WMMA 16x16x16, f32 accumulators).
template <int BN>
__global__ void __launch_bounds__(kThreads) bneck_conv_bf16(const Conv a) {
  namespace wmma = nvcuda::wmma;
  using G = Tile<bf16, BN>;
  constexpr int WN = BN / 2;  // warp tile 32 x WN; 4 x 2 warps
  constexpr int FN = WN / 16;
  __shared__ __align__(128) unsigned char smem_raw[G::SMEM_BYTES];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  Loader<bf16, BN> ld;
  ld.init(a, m0, n0, tid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][FN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ktiles = (a.K + G::BK - 1) / G::BK;
  ld.load(a, smem, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles)
      ld.load(a, smem + ((kt + 1) & 1) * G::STAGE, (kt + 1) * G::BK, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* As = smem + (kt & 1) * G::STAGE;
    const bf16* Bs = As + G::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < G::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * G::LDA + kk,
                               G::LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * G::LDB + wn * WN + j * 16,
                               G::LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: each warp stages one 16x16 tile at a time in its own 1 KB of
  // the (now idle) pipeline buffers; a lane owns 8 consecutive channels of
  // one pixel and writes them as one 16-byte vector (N % 8 == 0)
  float* stage = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane / 2, c0 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long m = m0 + wm * 32 + i * 16 + r;
      const int n = n0 + wn * WN + j * 16 + c0;
      if (m < a.M && n < a.N) {
        __align__(16) bf16 o[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          o[q] = epilogue<bf16>(a, stage[r * 16 + c0 + q], m, n + q);
        *reinterpret_cast<uint4*>(static_cast<bf16*>(a.out) + m * a.N + n) =
            *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
  }
}

// f32: plain FMA on the same tiles; a thread owns 8 pixels x BN/16
// channels (channels strided by 16, so B reads are conflict-free).
template <int BN>
__global__ void __launch_bounds__(kThreads) bneck_conv_f32(const Conv a) {
  using G = Tile<float, BN>;
  constexpr int TN = BN / 16;
  __shared__ __align__(128) unsigned char smem_raw[G::SMEM_BYTES];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  Loader<float, BN> ld;
  ld.init(a, m0, n0, tid);

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int ktiles = (a.K + G::BK - 1) / G::BK;
  ld.load(a, smem, 0, tid);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles)
      ld.load(a, smem + ((kt + 1) & 1) * G::STAGE, (kt + 1) * G::BK, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* As = smem + (kt & 1) * G::STAGE;
    const float* Bs = As + G::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < G::BK; ++kk) {
      float av[8], bv[TN];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[(ty * 8 + i) * G::LDA + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk * G::LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty * 8 + i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < a.N) out[m * a.N + n] = epilogue<float>(a, acc[i][j], m, n);
    }
  }
}

template <int BN>
cudaError_t launch(const Conv& a, bool is_bf16, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.M + kBM - 1) / kBM), (a.N + BN - 1) / BN);
  if (is_bf16)
    bneck_conv_bf16<BN><<<grid, kThreads, 0, stream>>>(a);
  else
    bneck_conv_f32<BN><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run_conv(const Conv& a, bool is_bf16, cudaStream_t stream) {
  return a.N <= 64 ? launch<64>(a, is_bf16, stream)
                   : launch<128>(a, is_bf16, stream);
}

}  // namespace

// The whole stack on `stream`. params: per block w1, b1, w2, b2, w3, b3
// and, after the first block's six when has_shortcut, wsc, bsc. Scratch
// (allocated by the wrapper, activation dtype): l1 and l2 [M, width], sc
// [M, c_out] when has_shortcut, tmp [M, c_out] when n_blocks > 1. The
// block outputs alternate between out and tmp so that the last lands in
// out. Returns the first CUDA error, or 0.
extern "C" int bottleneck_stage_forward(
    const void* x, void* out, void* l1, void* l2, void* sc, void* tmp,
    const void* const* params, int n_blocks, int has_shortcut, int batch,
    int h, int w, int c_in, int width, int c_out, int is_bf16,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf = is_bf16 != 0;
  const long long M = (long long)batch * h * w;
  const void* cur = x;
  int cin = c_in;
  int p = 0;
  cudaError_t err;
  for (int i = 0; i < n_blocks; ++i) {
    const void* w1 = params[p++];
    const float* b1 = static_cast<const float*>(params[p++]);
    const void* w2 = params[p++];
    const float* b2 = static_cast<const float*>(params[p++]);
    const void* w3 = params[p++];
    const float* b3 = static_cast<const float*>(params[p++]);
    void* dst = ((n_blocks - 1 - i) % 2 == 0) ? out : tmp;

    const Conv c1 = {cur, w1, b1, nullptr, l1, M, h, w, cin, width, cin, 1, 1};
    if ((err = run_conv(c1, bf, s)) != cudaSuccess) return (int)err;
    const Conv c2 = {l1, w2, b2, nullptr, l2, M, h, w,
                     width, width, 9 * width, 9, 1};
    if ((err = run_conv(c2, bf, s)) != cudaSuccess) return (int)err;
    const void* res = cur;
    if (i == 0 && has_shortcut) {
      const void* wsc = params[p++];
      const float* bsc = static_cast<const float*>(params[p++]);
      const Conv cs = {cur, wsc, bsc, nullptr, sc, M, h, w,
                       cin, c_out, cin, 1, 0};
      if ((err = run_conv(cs, bf, s)) != cudaSuccess) return (int)err;
      res = sc;
    }
    const Conv c3 = {l2, w3, b3, res, dst, M, h, w, width, c_out, width, 1, 0};
    if ((err = run_conv(c3, bf, s)) != cudaSuccess) return (int)err;
    cur = dst;
    cin = c_out;
  }
  return (int)cudaGetLastError();
}
