// Planar Galois-ring matmul over GR(2^e, D), e <= 32, D <= 16 and the
// two-level (3, 7) tower (D = 21), for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gr_matmul.py:_kernel
// (launched by gr_matmul_planar).  Same function:
//
//   A (batch, D, T, R) x B (batch, D, R, S) -> C (batch, D, T, S), uint32,
//   conv[CONVPOS(i, j)] += A[i] @ B[j]   (wrapping mod 2^32)
//   C[d] = (sum_c FOLD[c, d] * conv[c]) & mask
//
// Design for Hopper, not a block-by-block copy of the TPU version:
//  * One block of 256 threads owns a BM x BN output tile for all D planes
//    of one batch entry (grid z = batch, so the N worker products of a CDMM
//    round are one launch).  Grid x covers S and grid y covers T: the CDMM
//    shapes are very skinny (encode is 8x2 @ 2x2M), so S carries the
//    parallelism.
//  * The reduction over R is a loop inside the block through shared-memory
//    tiles of A's and B's D planes; it takes the place of the TPU's
//    sequential ("arbitrary") grid axis.
//  * Each thread keeps the K conv accumulators of its TM x TM outputs as
//    uint32_t registers, where wrapping is defined.  The tower shape
//    (D0 = degrees[0], D1 = degrees[1]) is a template parameter, so
//    CONVPOS(i, j) is a compile-time constant after unrolling and the
//    accumulators are indexed statically (no local-memory arrays).
//  * FOLD (K x D) and the e-bit mask come in as kernel parameters (constant
//    bank), the table sized per tower (5460 bytes for (3, 7): parameters
//    above 4 KB need CUDA 12.1); the fold-and-mask epilogue writes each
//    output once.
//  * Ragged edges are masked in the tile loads and the final store: no
//    padded copies of the operands.
//
// What bounds it: the uint32 multiply-adds run on the CUDA cores (INT32 is
// half the FP32 lanes; no tensor-core path in this version).  At the CDMM
// worker shape (1024x2048 @ 2048x1024, D = 3) there are 9 products per
// output per k against 2*D loads from shared memory, so it is bounded by
// operations; the skinny encode/decode/RMFE shapes are bounded by bytes.
//
// C interface (loaded with ctypes): every pointer and the stream are
// void*/uint32_t*, the functions return cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

template <int N>
struct FoldTable {
  uint32_t f[N];  // row-major (K, D)
};

template <int D0, int D1>
struct Cfg {
  static constexpr int D = D0 * D1;
  static constexpr int K = (2 * D0 - 1) * (2 * D1 - 1);
  // TM x TM outputs per thread: the largest of 4, 2, 1 whose accumulators
  // plus operand registers fit in 128
  static constexpr int TM = (K * 16 + 2 * D * 4 <= 128)   ? 4
                            : (K * 4 + 2 * D * 2 <= 128) ? 2
                                                         : 1;
  static constexpr int BM = 16 * TM;  // tile rows (T)
  static constexpr int BN = 16 * TM;  // tile cols (S)
  // depth of one shared-memory stage: both tiles within 48 KB static smem
  static constexpr int BK = (2 * D * BM * 16 * 4 <= 48 * 1024) ? 16 : 8;
};

__host__ __device__ constexpr int convpos(int i, int j, int d0) {
  return (i / d0 + j / d0) * (2 * d0 - 1) + (i % d0 + j % d0);
}

template <int D0, int D1>
__device__ __forceinline__ void mac(
    const uint32_t* As, const uint32_t* Bs, int k, int tx, int ty,
    uint32_t (&acc)[Cfg<D0, D1>::K][Cfg<D0, D1>::TM][Cfg<D0, D1>::TM]) {
  using G = Cfg<D0, D1>;
  uint32_t a[G::D][G::TM], b[G::D][G::TM];
#pragma unroll
  for (int d = 0; d < G::D; ++d) {
#pragma unroll
    for (int m = 0; m < G::TM; ++m) {
      a[d][m] = As[(d * G::BK + k) * G::BM + ty + 16 * m];
      b[d][m] = Bs[(d * G::BK + k) * G::BN + tx + 16 * m];
    }
  }
#pragma unroll
  for (int i = 0; i < G::D; ++i) {
#pragma unroll
    for (int j = 0; j < G::D; ++j) {
      const int c = convpos(i, j, D0);
#pragma unroll
      for (int m = 0; m < G::TM; ++m) {
#pragma unroll
        for (int n = 0; n < G::TM; ++n) acc[c][m][n] += a[i][m] * b[j][n];
      }
    }
  }
}

template <int D0, int D1>
__global__ void __launch_bounds__(kThreads)
    gr_matmul_kernel(const uint32_t* __restrict__ A,
                     const uint32_t* __restrict__ B, uint32_t* __restrict__ C,
                     int T, int R, int S,
                     const FoldTable<Cfg<D0, D1>::K * Cfg<D0, D1>::D> fold,
                     uint32_t mask) {
  using G = Cfg<D0, D1>;
  constexpr int D = G::D, K = G::K, TM = G::TM;
  constexpr int BM = G::BM, BN = G::BN, BK = G::BK;
  __shared__ uint32_t As[D * BK * BM];  // [d][k][m]
  __shared__ uint32_t Bs[D * BK * BN];  // [d][k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t z = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const uint32_t* Ab = A + z * D * (int64_t)T * R;
  const uint32_t* Bb = B + z * D * (int64_t)R * S;

  uint32_t acc[K][TM][TM];
#pragma unroll
  for (int c = 0; c < K; ++c)
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TM; ++n) acc[c][m][n] = 0u;

  for (int k0 = 0; k0 < R; k0 += BK) {
    // A tile: consecutive threads read consecutive r (row-major A[d][t][r])
    for (int idx = tid; idx < D * BM * BK; idx += kThreads) {
      const int k = idx % BK, m = (idx / BK) % BM, d = idx / (BK * BM);
      const int gr = row0 + m, gk = k0 + k;
      As[(d * BK + k) * BM + m] =
          (gr < T && gk < R) ? Ab[((int64_t)d * T + gr) * R + gk] : 0u;
    }
    // B tile: consecutive threads read consecutive s (row-major B[d][r][s])
    for (int idx = tid; idx < D * BK * BN; idx += kThreads) {
      const int n = idx % BN, k = (idx / BN) % BK, d = idx / (BN * BK);
      const int gk = k0 + k, gc = col0 + n;
      Bs[(d * BK + k) * BN + n] =
          (gk < R && gc < S) ? Bb[((int64_t)d * R + gk) * S + gc] : 0u;
    }
    __syncthreads();
    if constexpr (D <= 4) {
#pragma unroll
      for (int k = 0; k < BK; ++k) mac<D0, D1>(As, Bs, k, tx, ty, acc);
    } else {
#pragma unroll 1
      for (int k = 0; k < BK; ++k) mac<D0, D1>(As, Bs, k, tx, ty, acc);
    }
    __syncthreads();
  }

  // fold-and-mask epilogue
  uint32_t* Cb = C + z * D * (int64_t)T * S;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int row = row0 + ty + 16 * m;
#pragma unroll
    for (int n = 0; n < TM; ++n) {
      const int col = col0 + tx + 16 * n;
      if (row < T && col < S) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          uint32_t v = 0u;
#pragma unroll
          for (int c = 0; c < K; ++c) v += fold.f[c * D + d] * acc[c][m][n];
          Cb[((int64_t)d * T + row) * S + col] = v & mask;
        }
      }
    }
  }
}

template <int D0, int D1>
int launch(const uint32_t* A, const uint32_t* B, uint32_t* C, int batch, int T,
           int R, int S, const uint32_t* fold_host, uint32_t mask,
           cudaStream_t stream) {
  using G = Cfg<D0, D1>;
  FoldTable<G::K * G::D> fold;
  memcpy(fold.f, fold_host, sizeof(fold.f));
  dim3 grid((S + G::BN - 1) / G::BN, (T + G::BM - 1) / G::BM, batch);
  gr_matmul_kernel<D0, D1>
      <<<grid, kThreads, 0, stream>>>(A, B, C, T, R, S, fold, mask);
  return (int)cudaGetLastError();
}

template <int D0, int D1>
int tile(int* bm, int* bn, int* bk) {
  using G = Cfg<D0, D1>;
  *bm = G::BM;
  *bn = G::BN;
  *bk = G::BK;
  return 0;
}

}  // namespace

// Every tower shape with D = D0 * D1 <= 16: one level (D1 = 1) or two
// coprime levels (three coprime levels already need D >= 30); and (3, 7),
// the ring of batch_ep_rmfe at n = 8 over Z_2^32, which ElasticStream
// plans for a group of eight products (K = 65 accumulators: TM = 1).
#define GR_TOWERS(X)                                                         \
  X(1, 1) X(2, 1) X(3, 1) X(4, 1) X(5, 1) X(6, 1) X(7, 1) X(8, 1) X(9, 1)    \
  X(10, 1) X(11, 1) X(12, 1) X(13, 1) X(14, 1) X(15, 1) X(16, 1) X(2, 3)     \
  X(2, 5) X(2, 7) X(3, 2) X(3, 4) X(3, 5) X(4, 3) X(5, 2) X(5, 3) X(7, 2)     \
  X(3, 7)

extern "C" {

// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for a
// tower shape that has no instantiation.  fold_host: (K, D) uint32 row-major.
int gr_matmul_planar_u32(const void* A, const void* B, void* C, int batch,
                         int T, int R, int S, int d0, int d1,
                         const uint32_t* fold_host, uint32_t mask,
                         void* stream) {
  const uint32_t* a = static_cast<const uint32_t*>(A);
  const uint32_t* b = static_cast<const uint32_t*>(B);
  uint32_t* c = static_cast<uint32_t*>(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d0 * 32 + d1) {
#define GR_LAUNCH(x, y) \
  case x * 32 + y:      \
    return launch<x, y>(a, b, c, batch, T, R, S, fold_host, mask, st);
    GR_TOWERS(GR_LAUNCH)
#undef GR_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The (BM, BN, BK) tile the kernel uses for a tower shape; -1 if none.
int gr_matmul_tile(int d0, int d1, int* bm, int* bn, int* bk) {
  switch (d0 * 32 + d1) {
#define GR_TILE(x, y) \
  case x * 32 + y:    \
    return tile<x, y>(bm, bn, bk);
    GR_TOWERS(GR_TILE)
#undef GR_TILE
    default:
      return -1;
  }
}

}  // extern "C"
