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
// 1x1 and 9*C_in for the 3x3 in (dy, dx, c) order, whose taps are gathered
// from the input with out-of-image taps read as zero. One launch per conv:
// three per block, four on a block with a shortcut conv;
// `bottleneck_stage_forward` runs the whole stack on one stream.
//
// What bounds it on the H100, per conv, with l1, l2, the shortcut's output
// and each block's output going through device memory (ActEV path, B=8,
// 1088x1920): the 3x3s are bound by operations (77 GFLOP at the c4 tail,
// 0.078 ms at the 989 TFLOP/s of dense bf16); the 1x1s on 256 or more
// channels by bytes (the c4 tail's conv3 reads l2 and the residual and
// writes the block's output, 0.30 GB, 0.09 ms at 3.35 TB/s). Summed over
// the convs, that floor is 7.9 ms per forward; the stack's own bound
// (x in, the output out, all operations) is 4.1 ms. The bf16 design runs
// each conv towards its floor:
//   * an output tile of 128 pixels x BN channels is computed by two
//     warpgroups, each issuing wgmma.mma_async m64nBNk16 (bf16 in, f32
//     accumulators in registers) on its 64-pixel half, both operands read
//     from shared memory;
//   * K is staged 64 deep (128 bytes per row: one 128-byte swizzle atom)
//     in a ring of STAGES buffers in dynamic shared memory. The weights,
//     stored K-major [N, K] by the wrapper, arrive by TMA (2D tensor map,
//     128B swizzle, zero fill past N and K), completion on an mbarrier per
//     stage, and so does a 1x1's activation tile, a [128, 64] box of the
//     [M, C] matrix; the 3x3's activations are gathered by 16-byte
//     cp.async (per-pixel coordinates computed once; out-of-image taps and
//     ragged edges zero-filled) straight into the same swizzled layout,
//     then fenced to the async proxy. STAGES - 1 - LAG stages of loads are
//     in flight while one is multiplied; LAG = 1 lets a stage's MMAs run
//     on while the next stage is awaited (the wide 3x3, bound by
//     operations), LAG = 0 gives their slot to one more load (the rest);
//   * the tile shape follows the conv (`run_conv`): the short-K 1x1s,
//     bound by bytes, take 64-wide tiles in a 2-stage ring, four blocks
//     per SM, so that one block's prologue and epilogue overlap another's
//     loads; the wide 3x3 256-wide tiles, one block per SM;
//   * the epilogue works on the accumulator fragments in registers: + the
//     f32 bias (staged in shared memory), the Pallas kernel's rounding
//     points (cast l3, add the residual in the activation dtype, relu), a
//     transpose inside each 4-lane quad so that a lane holds 8 consecutive
//     channels; every residual vector is read before the first output
//     vector is written, all as 16 bytes; ragged M and N edges are masked;
//   * tiles walk N fastest, so the blocks that share an activation tile
//     run together and read it from device memory once.
// float32 activations take plain FMA (not TF32) on 128 x 64/128 tiles,
// double-buffered by cp.async, so that the f32 check against the plain
// version holds to float32 rounding.
//
// Not done here (next B2 slice, ROADMAP): keeping a pixel tile's l1/l2 on
// chip across the three convs of a block (one launch per block), which
// moves the floor from 7.9 ms to the 4.1 ms bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (object_detection_tracking_tpu_torch/native.py).
// No link flag: the tensor-map encoder is looked up in libcuda at run
// time (cudaGetDriverEntryPointByVersion).

#include <cuda.h>  // CUtensorMap and its enums (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps: two warpgroups on the bf16 path
constexpr int kBM = 128;       // output pixels per block

// One conv of the stack, with its epilogue.
struct Conv {
  const void* in;      // [M, C] NHWC activations
  const void* w;       // folded weights: f32 [K, N]; bf16 [N, K] (K-major)
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

// ---------------------------------------------------------------------------
// float32: plain FMA

// The f32 tile: 128 pixels x BN channels, K staged 16 deep, double-
// buffered in 48 KB of static shared memory.
template <int BN>
struct Tile {
  static constexpr int VEC = 4;  // floats per 16-byte copy
  static constexpr int BK = 16;  // K per stage
  static constexpr int LDA = BK + VEC;  // padded row pitches
  static constexpr int LDB = BN + VEC;
  static constexpr int A_ELEMS = kBM * LDA;
  static constexpr int B_ELEMS = BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int A_VECS_PER_ROW = BK / VEC;
  static constexpr int A_ROWS_PER_PASS = kThreads / A_VECS_PER_ROW;
  static constexpr int A_PASSES = kBM / A_ROWS_PER_PASS;
  static constexpr int B_VECS_PER_ROW = BN / VEC;
  static constexpr int B_VECS = BK * B_VECS_PER_ROW;
  static constexpr int SMEM_BYTES = 2 * STAGE * (int)sizeof(float);
};

// Fills one stage of the A (gathered activations) and B (weights, [K, N])
// tiles. The pixels a thread copies are fixed over the K loop, so their
// image coordinates are computed once.
template <int BN>
struct Loader {
  using G = Tile<BN>;
  const float* in;
  const float* w;
  long long m[G::A_PASSES];  // -1 past the last pixel
  int y[G::A_PASSES], x[G::A_PASSES];
  int kc;                    // this thread's K offset inside a stage
  int n0;

  __device__ void init(const Conv& a, long long m0, int n0_, int tid) {
    in = static_cast<const float*>(a.in);
    w = static_cast<const float*>(a.w);
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

  __device__ void load(const Conv& a, float* stage, int k0, int tid) const {
    float* As = stage;
    float* Bs = stage + G::A_ELEMS;
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
      const float* src =
          ok ? in + (m[p] + (long long)dy * a.W + dx) * a.C + c : in;
      cp_async16(As + row * G::LDA + kc, src, ok);
    }
    for (int v = tid; v < G::B_VECS; v += kThreads) {
      const int kr = v / G::B_VECS_PER_ROW;
      const int nc = (v % G::B_VECS_PER_ROW) * G::VEC;
      const int kk = k0 + kr, n = n0 + nc;
      const bool ok = kk < a.K && n < a.N;
      const float* src = ok ? w + (long long)kk * a.N + n : w;
      cp_async16(Bs + kr * G::LDB + nc, src, ok);
    }
  }
};

// Bias, then the optional relu (an f32 residual add rounds nowhere).
__device__ __forceinline__ float epilogue_f32(const Conv& a, float acc,
                                              long long m, int n) {
  float v = acc + a.bias[n];
  if (a.res != nullptr)
    return fmaxf(v + static_cast<const float*>(a.res)[m * a.N + n], 0.0f);
  return a.relu ? fmaxf(v, 0.0f) : v;
}

// A thread owns 8 pixels x BN/16 channels (channels strided by 16, so B
// reads are conflict-free).
template <int BN>
__global__ void __launch_bounds__(kThreads) bneck_conv_f32(const Conv a) {
  using G = Tile<BN>;
  constexpr int TN = BN / 16;
  __shared__ __align__(128) unsigned char smem_raw[G::SMEM_BYTES];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  Loader<BN> ld;
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
      if (n < a.N) out[m * a.N + n] = epilogue_f32(a, acc[i][j], m, n);
    }
  }
}

template <int BN>
cudaError_t launch_f32(const Conv& a, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.M + kBM - 1) / kBM), (a.N + BN - 1) / BN);
  bneck_conv_f32<BN><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by a TMA / cp.async ring

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box at (k0, n0) of a 2D tensor map into shared memory; the
// bytes complete on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int k0, int n0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(k0),
      "r"(n0)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across the
// asynchronous MMAs that own the registers.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are 128
// bytes (64 bf16 of K) in the 128-byte swizzle: 8-row atoms of 1 KB, one
// after the other (stride byte offset 1024), layout type 1 (B128). The
// leading byte offset is unused for swizzled K-major tiles. Adding 2 to it
// moves the start 32 bytes (16 of K) along the rows.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, A and B K-major in shared
// memory (no transpose), D accumulated (scale-d 1). Thread t of the
// warpgroup holds d[4j + 2h + v] = D[16 (t/32) + (t%32)/4 + 8h,
// 8j + 2 (t%4) + v].
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// Bytes of one ring stage: the A tile (128 pixels x 64 of K) and the B
// tile (BN channels x 64 of K), each 1 KB-aligned for the swizzle.
template <int BN, int STAGES>
struct Ring {
  static_assert(STAGES >= 2, "a ring needs two stages");
  static constexpr int BK = 64;
  static constexpr int A_BYTES = kBM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // + up to 1 KB to align the ring, one 8-byte mbarrier per stage and the
  // tile's BN biases
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + 1024 + 8 * STAGES + 4 * BN;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// Inside each 4-lane quad (lanes 4r..4r+3, lane q = lane % 4): lane q holds
// w[i] = word q of chunk i; afterwards o[k] = word k of chunk q, i.e. all
// of chunk q. Three exchanges; register indices stay compile-time.
__device__ __forceinline__ void quad_transpose(const uint32_t (&w)[4],
                                               uint32_t (&o)[4], int q) {
  o[0] = o[1] = o[2] = o[3] = pick4(w, q);  // o[q]: this lane's own word
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    // partner q ^ r sends its word q, which lands in o[q ^ r]
    const uint32_t got = __shfl_xor_sync(0xffffffffu, pick4(w, q ^ r), r);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k == (q ^ r)) o[k] = got;
  }
}

// One bf16 conv: a 128 x BN output tile per block, K in 64-deep stages.
// LAG (0 or 1) groups of MMAs stay in flight across a stage boundary, so
// STAGES - 1 - LAG stages of loads are in flight while one is multiplied.
template <int TAPS, int BN, int STAGES, int LAG>
__device__ __forceinline__ void conv_wgmma(const Conv& a,
                                           const CUtensorMap* wmap,
                                           const CUtensorMap* xmap) {
  using R = Ring<BN, STAGES>;
  constexpr int AHEAD = STAGES - 1 - LAG;  // stages loaded ahead
  static_assert(AHEAD >= 1 && LAG >= 0 && LAG <= 1, "bad ring");
  constexpr int NACC = BN / 2;  // f32 accumulators per thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * R::STAGE_BYTES);
  float* sbias = reinterpret_cast<float*>(full + STAGES);  // [BN]

  const int tid = threadIdx.x;
  const int n_tiles = (a.N + BN - 1) / BN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < BN) sbias[tid] = n0 + tid < a.N ? a.bias[n0 + tid] : 0.0f;
  __syncthreads();

  // A 1x1's activation tile comes by TMA like the weights. The 3x3's is
  // gathered: thread tid copies 16-byte chunk tid % 8 (8 of K) of rows
  // tid / 8 + 32 p, p < 4, whose image coordinates are fixed over the K
  // loop; with the 128B swizzle, chunk c of row r lands at chunk
  // c ^ (r % 8) of its 128-byte row (r % 8 is the same for all four rows).
  const bf16* in = static_cast<const bf16*>(a.in);
  const int chunk = tid & 7;
  const int a_off = (tid >> 3) * 128 + ((chunk ^ ((tid >> 3) & 7)) << 4);
  const long long hw = (long long)a.H * a.W;
  long long pm[4];  // -1 past the last pixel
  int py[4], px[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long mm = m0 + (tid >> 3) + 32 * p;
    pm[p] = mm < a.M ? mm : -1;
    const long long pix = mm % hw;
    py[p] = (int)(pix / a.W);
    px[p] = (int)(pix % a.W);
  }

  auto load = [&](int kt) {
    const int slot = kt % STAGES;
    unsigned char* As = smem + slot * R::STAGE_BYTES;
    unsigned char* Bs = As + R::A_BYTES;
    const int k0 = kt * R::BK;
    if (tid == 0) {
      mbar_expect_tx(&full[slot],
                     TAPS == 1 ? R::A_BYTES + R::B_BYTES : R::B_BYTES);
      if (TAPS == 1) tma_load_2d(As, xmap, &full[slot], k0, (int)m0);
      tma_load_2d(Bs, wmap, &full[slot], k0, n0);
    }
    if (TAPS == 1) return;
    const int k = k0 + chunk * 8;
    const int tap = k / a.C;
    const int c = k - tap * a.C, dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int yy = py[p] + dy, xx = px[p] + dx;
      const bool ok = pm[p] >= 0 && k < a.K && yy >= 0 && yy < a.H &&
                      xx >= 0 && xx < a.W;
      const bf16* src =
          ok ? in + (pm[p] + (long long)dy * a.W + dx) * a.C + c : in;
      cp_async16(As + a_off + p * 32 * 128, src, ok);
    }
  };

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  // warpgroup wg multiplies pixel rows 64 wg .. 64 wg + 63 of the tile
  const int wg = tid >> 7;
  const uint64_t a_desc = desc_sw128(smem + wg * 64 * 128);
  const uint64_t b_desc = desc_sw128(smem + R::A_BYTES);
  constexpr uint64_t kStageDesc = R::STAGE_BYTES >> 4;

  const int ktiles = (a.K + R::BK - 1) / R::BK;
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    // this thread's copies of stage kt are in; fence them to the async
    // proxy, then the barrier publishes everyone's. It also shows that
    // both warpgroups have retired the MMAs of stage kt - 1 - LAG (wait
    // below), so its slot can be refilled.
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (kt + AHEAD < ktiles) load(kt + AHEAD);
    cp_async_commit();

    const int slot = kt % STAGES;
    mbar_wait(&full[slot], (kt / STAGES) & 1);  // the TMA copies
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R::BK / 16; ++kk)
      Wgmma<BN>::mma(acc, a_desc + slot * kStageDesc + 2 * kk,
                     b_desc + slot * kStageDesc + 2 * kk);
    wgmma_commit();
    wgmma_wait<LAG>();  // the MMAs of stage kt - LAG are done
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue from the fragments: thread (warp w, lane l) holds rows
  // r0 = 16 w + l/4 and r0 + 8 of its warpgroup's half, and channels
  // 8 j + 2 (l % 4) + {0, 1} of every 8-channel chunk j. Each group of
  // four chunks is rounded, then transposed inside the quad, so that lane
  // q holds chunk 4 g + q of its row whole.
  constexpr int G = BN / 32;
  const int lane = tid & 31, q = lane & 3;
  const long long row0 = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const bf16* res = static_cast<const bf16*>(a.res);
  bf16* out = static_cast<bf16*>(a.out);
  uint32_t o[G][2][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * g + i, c = 8 * j + 2 * q;
        float v0 = acc[4 * j + 2 * h] + sbias[c];
        float v1 = acc[4 * j + 2 * h + 1] + sbias[c + 1];
        if (res == nullptr && a.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        w[i] = pack_bf16x2(v0, v1);  // l1, l2, the shortcut or l3, rounded
      }
      quad_transpose(w, o[g][h], q);
    }
  }
  if (res != nullptr) {
    // all residual loads before the first store: a store may alias them
    // for all the compiler knows, so it would keep them behind it
    uint4 r[G][2];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = row0 + 8 * h;
        const int n = n0 + 32 * g + 8 * q;
        r[g][h] = m < a.M && n < a.N
                      ? *reinterpret_cast<const uint4*>(res + m * a.N + n)
                      : make_uint4(0, 0, 0, 0);
      }
    // relu(l3 + residual), the sum of the two bf16 values rounded once
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t rw[4] = {r[g][h].x, r[g][h].y, r[g][h].z, r[g][h].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 l3 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&o[g][h][k]));
          const float2 rv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&rw[k]));
          o[g][h][k] = pack_bf16x2(fmaxf(l3.x + rv.x, 0.0f),
                                   fmaxf(l3.y + rv.y, 0.0f));
        }
      }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = row0 + 8 * h;
      const int n = n0 + 32 * g + 8 * q;
      if (m < a.M && n < a.N)
        *reinterpret_cast<uint4*>(out + m * a.N + n) = make_uint4(
            o[g][h][0], o[g][h][1], o[g][h][2], o[g][h][3]);
    }
}

// Two entry points, so that a profile tells the conv kinds apart.
template <int BN, int STAGES, int LAG>
__global__ void __launch_bounds__(kThreads, 1)
    bneck_conv1x1_bf16(const Conv a, const __grid_constant__ CUtensorMap w,
                       const __grid_constant__ CUtensorMap x) {
  conv_wgmma<1, BN, STAGES, LAG>(a, &w, &x);
}

template <int BN, int STAGES, int LAG>
__global__ void __launch_bounds__(kThreads, 1)
    bneck_conv3x3_bf16(const Conv a, const __grid_constant__ CUtensorMap w) {
  conv_wgmma<9, BN, STAGES, LAG>(a, &w, nullptr);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once at run time (so the
// library links without -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2D bf16 row-major [rows, inner] matrix's tensor map for boxes of 64
// of the inner dimension (one 128-byte swizzle row) by box_rows rows.
bool encode_2d(EncodeTiled encode, CUtensorMap* map, const void* base,
               long long inner, long long rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int STAGES, int LAG>
cudaError_t launch_wgmma(const Conv& a, cudaStream_t stream) {
  using R = Ring<BN, STAGES>;
  // dynamic shared memory above 48 KB, set once per kernel
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      bneck_conv1x1_bf16<BN, STAGES, LAG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM_BYTES);
  static const cudaError_t attr9 = cudaFuncSetAttribute(
      bneck_conv3x3_bf16<BN, STAGES, LAG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM_BYTES);
  if (attr1 != cudaSuccess) return attr1;
  if (attr9 != cudaSuccess) return attr9;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;

  // the weights, [N, K] bf16 row-major: K is the inner dimension; for a
  // 1x1 also the activations, [M, C = K]. Boxes of 64 of K by BN rows
  // (weights) or 128 pixels (activations), zero past the edges.
  CUtensorMap wmap, xmap;
  if (!encode_2d(encode, &wmap, a.w, a.K, a.N, BN) ||
      (a.taps == 1 && !encode_2d(encode, &xmap, a.in, a.K, a.M, kBM)))
    return cudaErrorInvalidValue;

  const long long blocks = ((a.M + kBM - 1) / kBM) * ((a.N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL || a.M > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  if (a.taps == 9)
    bneck_conv3x3_bf16<BN, STAGES, LAG>
        <<<(unsigned)blocks, kThreads, R::SMEM_BYTES, stream>>>(a, wmap);
  else
    bneck_conv1x1_bf16<BN, STAGES, LAG>
        <<<(unsigned)blocks, kThreads, R::SMEM_BYTES, stream>>>(a, wmap,
                                                                 xmap);
  return cudaGetLastError();
}

// Tile shape by the conv's K and N, from timing each conv of the ActEV
// path alone under several shapes. A short K (the 1x1s on 64-256
// channels, bound by bytes) takes 64-wide tiles and a 2-stage ring, four
// blocks per SM, so that blocks' prologues and epilogues overlap each
// other; a narrow N 64-wide tiles with three stages; a longer 1x1, or a
// 3x3 up to 128 channels, 128-wide tiles, two blocks per SM; the wide 3x3
// (bound by operations) 256-wide tiles, four stages and its MMAs
// overlapping the next stage's wait, one block per SM.
cudaError_t run_conv(const Conv& a, bool is_bf16, cudaStream_t stream) {
  if (!is_bf16)
    return a.N <= 64 ? launch_f32<64>(a, stream) : launch_f32<128>(a, stream);
  if (a.K <= 256) return launch_wgmma<64, 2, 0>(a, stream);
  if (a.N <= 64) return launch_wgmma<64, 3, 0>(a, stream);
  if (a.taps == 1 || a.N <= 128) return launch_wgmma<128, 3, 0>(a, stream);
  return launch_wgmma<256, 4, 1>(a, stream);
}

}  // namespace

// The whole stack on `stream`. params: per block w1, b1, w2, b2, w3, b3
// and, after the first block's six when has_shortcut, wsc, bsc; weights
// f32 [K, N] or bf16 [N, K]. Scratch (allocated by the wrapper, activation
// dtype): l1 and l2 [M, width], sc [M, c_out] when has_shortcut, tmp
// [M, c_out] when n_blocks > 1. The block outputs alternate between out
// and tmp so that the last lands in out. Returns the first CUDA error, or
// 0.
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
