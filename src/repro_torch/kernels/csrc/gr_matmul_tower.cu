// Skinny Galois-ring matmul over the rings the skinny kernel has no
// instantiation for (the (3, 7) tower first), e <= 32, for sm_90a: the
// encodes and decodes of a CDMM round over those rings, T <= 16, R <= 16.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gr_matmul.py:_kernel
// (launched by gr_matmul_planar) for those calls.  Same function, in the
// port's interleaved layout end to end:
//
//   A (batch, T, R, D) x B (batch, R, S, D) -> C (batch, T, S, D), uint32,
//   C[t, s, k] = (sum_{r, i, j} A[t, r, i] B[r, s, j] FOLD[CONVPOS(i, j), k]) & mask
//
// Why not gr_matmul_skinny.cu's scheme: it keeps K conv accumulators a
// column, and at the (3, 7) tower K = 65 (and the fold is K * D = 1365
// multiply-adds a column, more than the 441 D^2 products themselves at
// R = 2).  Instead every element of A is lifted to its multiplication
// matrix over Z_q,
//
//   M(a)[j, k] = sum_i a_i FOLD[CONVPOS(i, j), k],  so  (a b)_k = sum_j M(a)[j, k] b_j,
//
// and C[t, s, :] = sum_r M(A[t, r])^T B[r, s, :]: D^2 multiply-adds per
// (t, r, s), D accumulators a column, no fold.
//
// What bounds it: operations on the CUDA cores.  At the (3, 7) decode
// (8 x 8 @ 8 x 131072) it needs 3.70e9 uint32 multiply-adds, 0.221 ms at
// the H100's INT32 rate, against 0.053 ms to move B and C once.
//
// Design:
//  * The block's prologue lifts all of A (T R matrices of D x D words,
//    113 KB at T = R = 8) into shared memory from FOLD (a kernel parameter,
//    copied to shared memory first): a thread computes one column k of
//    M(A[t, r]), FOLD's column k and the D coefficients of A[t, r] in
//    registers, every index fixed at compile time.  Rows are padded to DP
//    (a multiple of 4) words, so the main loop reads them as 16-byte
//    vectors.  Every block redoes the lift (a few % of its work at the
//    (3, 7) shapes); nothing goes through the host or another launch.
//  * Each thread owns CPT consecutive columns and a chunk of TC rows of C:
//    TC * CPT * D accumulators.  For every r it loads its CPT * D words of
//    B from global memory (the widest vector the alignment allows), then
//    for every row of the chunk and every j reads M(A[t, r])[j, :] as
//    uint4 broadcasts (all lanes read one address) and feeds each word to
//    CPT multiply-adds.  Each byte of C is written once; B is read T / TC
//    times, from L2 after the first.
//  * The tower (D0, D1), threads NT, rows TC and columns CPT are template
//    parameters (TOWER_CONFIGS); the autotuner (repro_torch.kernels.
//    autotune) times them per shape.  Ragged columns, and operands whose
//    rows are not aligned to the vector, take 4-byte loads and stores.
//
// C interface (loaded with ctypes); the functions return cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxT = 16;
constexpr int kMaxR = 16;
constexpr int kSmemCap = 227 * 1024;
constexpr int kMaxDevices = 64;

template <int N>
struct FoldTable {
  uint32_t f[N];  // row-major (K, D)
};

__host__ __device__ constexpr int convpos(int i, int j, int d0) {
  return (i / d0 + j / d0) * (2 * d0 - 1) + (i % d0 + j % d0);
}

template <int D0, int D1>
struct Tower {
  static constexpr int D = D0 * D1;
  static constexpr int K = (2 * D0 - 1) * (2 * D1 - 1);
  static constexpr int DP = (D + 3) & ~3;  // a lifted row, padded to 16 bytes
  static constexpr int Q = DP / 4;
  // shared memory: the lifted A, FOLD and A itself, in words
  __host__ __device__ static constexpr int64_t words(int T, int R) {
    return (int64_t)T * R * D * DP + K * D + (int64_t)T * R * D;
  }
};

// CPT * D consecutive words from `src` into `dst`: vectors of V words when
// `full`, else `valid` words and zeros past them
template <int W, int V>
__device__ __forceinline__ void load_run(uint32_t (&dst)[W], const uint32_t* __restrict__ src,
                                         bool full, int valid) {
  if (full) {
    if constexpr (V == 4) {
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + q);
        dst[4 * q] = v.x, dst[4 * q + 1] = v.y, dst[4 * q + 2] = v.z, dst[4 * q + 3] = v.w;
      }
    } else if constexpr (V == 2) {
#pragma unroll
      for (int q = 0; q < W / 2; ++q) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + q);
        dst[2 * q] = v.x, dst[2 * q + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < W; ++q) dst[q] = __ldg(src + q);
    }
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) dst[q] = q < valid ? src[q] : 0u;
  }
}

template <int W, int V>
__device__ __forceinline__ void store_run(uint32_t* __restrict__ dst, const uint32_t (&src)[W],
                                          bool full, int valid) {
  if (full) {
    if constexpr (V == 4) {
#pragma unroll
      for (int q = 0; q < W / 4; ++q)
        reinterpret_cast<uint4*>(dst)[q] =
            make_uint4(src[4 * q], src[4 * q + 1], src[4 * q + 2], src[4 * q + 3]);
    } else if constexpr (V == 2) {
#pragma unroll
      for (int q = 0; q < W / 2; ++q)
        reinterpret_cast<uint2*>(dst)[q] = make_uint2(src[2 * q], src[2 * q + 1]);
    } else {
#pragma unroll
      for (int q = 0; q < W; ++q) dst[q] = src[q];
    }
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q)
      if (q < valid) dst[q] = src[q];
  }
}

template <int D0, int D1, int NT, int TC, int CPT>
__global__ void __launch_bounds__(NT)
    gr_matmul_tower_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                           uint32_t* __restrict__ C, int T, int R, int S,
                           const __grid_constant__ FoldTable<Tower<D0, D1>::K * Tower<D0, D1>::D> fold,
                           uint32_t mask, int vec) {
  using G = Tower<D0, D1>;
  constexpr int D = G::D, K = G::K, DP = G::DP, Q = G::Q, W = CPT * D;
  constexpr int V = W % 4 == 0 ? 4 : W % 2 == 0 ? 2 : 1;
  extern __shared__ uint4 smem4[];
  uint32_t* Ms = reinterpret_cast<uint32_t*>(smem4);  // [t][r][j][DP]
  uint32_t* Fs = Ms + T * R * D * DP;                  // [c][k]
  uint32_t* As = Fs + K * D;                           // [t][r][i]
  const int tid = threadIdx.x;
  const int64_t z = blockIdx.y;
  const uint32_t* Ab = A + z * T * R * D;
  const uint32_t* Bb = B + z * R * (int64_t)S * D;
  uint32_t* Cb = C + z * T * (int64_t)S * D;

  for (int idx = tid; idx < K * D; idx += NT) Fs[idx] = fold.f[idx];
  for (int idx = tid; idx < T * R * D; idx += NT) As[idx] = Ab[idx];
  __syncthreads();
  // the lift: item (t r, k) is column k of M(A[t, r]) (zeros in the padding)
  for (int item = tid; item < T * R * DP; item += NT) {
    const int tr = item / DP, k = item - tr * DP;
    uint32_t* dst = Ms + tr * D * DP + k;
    if (k >= D) {
#pragma unroll
      for (int j = 0; j < D; ++j) dst[j * DP] = 0u;
      continue;
    }
    uint32_t a[D], f[K];
#pragma unroll
    for (int i = 0; i < D; ++i) a[i] = As[tr * D + i];
#pragma unroll
    for (int c = 0; c < K; ++c) f[c] = Fs[c * D + k];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      uint32_t v = 0u;
#pragma unroll
      for (int i = 0; i < D; ++i) v += a[i] * f[convpos(i, j, D0)];
      dst[j * DP] = v;
    }
  }
  __syncthreads();

  const int c0 = (blockIdx.x * NT + tid) * CPT;  // first column of this thread
  if (c0 >= S) return;
  const bool full = vec && c0 + CPT <= S;
  const int valid = (S - c0 < CPT ? S - c0 : CPT) * D;
  const uint4* M4 = reinterpret_cast<const uint4*>(Ms);
  for (int t0 = 0; t0 < T; t0 += TC) {
    uint32_t acc[TC][CPT][D];
#pragma unroll
    for (int tt = 0; tt < TC; ++tt)
#pragma unroll
      for (int n = 0; n < CPT; ++n)
#pragma unroll
        for (int k = 0; k < D; ++k) acc[tt][n][k] = 0u;
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      uint32_t b[W];
      load_run<W, V>(b, Bb + ((int64_t)r * S + c0) * D, full, valid);
#pragma unroll
      for (int tt = 0; tt < TC; ++tt) {
        if (t0 + tt < T) {
          const uint4* m = M4 + ((t0 + tt) * R + r) * D * Q;
#pragma unroll
          for (int j = 0; j < D; ++j) {
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              const uint4 mv = m[j * Q + q];
              const uint32_t w4[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (4 * q + u < D) {
#pragma unroll
                  for (int n = 0; n < CPT; ++n) acc[tt][n][4 * q + u] += w4[u] * b[n * D + j];
                }
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      if (t0 + tt < T) {
        uint32_t out[W];
#pragma unroll
        for (int n = 0; n < CPT; ++n)
#pragma unroll
          for (int k = 0; k < D; ++k) out[n * D + k] = acc[tt][n][k] & mask;
        store_run<W, V>(Cb + ((int64_t)(t0 + tt) * S + c0) * D, out, full, valid);
      }
    }
  }
}

template <int D0, int D1, int NT, int TC, int CPT>
int launch(const uint32_t* A, const uint32_t* B, uint32_t* C, int batch, int T, int R, int S,
           const uint32_t* fold_host, uint32_t mask, cudaStream_t stream) {
  using G = Tower<D0, D1>;
  constexpr int W = CPT * G::D;
  constexpr int V = W % 4 == 0 ? 4 : W % 2 == 0 ? 2 : 1;
  const int64_t smem = 4 * G::words(T, R);
  if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // once per device (the attribute persists): launches may be captured
    // in a CUDA graph
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!raised[dev]) {
      e = cudaFuncSetAttribute(gr_matmul_tower_kernel<D0, D1, NT, TC, CPT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
      if (e != cudaSuccess) return (int)e;
      raised[dev] = true;
    }
  }
  FoldTable<G::K * G::D> fold;
  memcpy(fold.f, fold_host, sizeof(fold.f));
  // vector paths need every row of B and C to start on a vector boundary
  const int vec = ((int64_t)S * G::D) % V == 0 &&
                  ((uintptr_t)B | (uintptr_t)C) % (4 * V) == 0;
  const int64_t cols = (int64_t)NT * CPT;
  dim3 grid((unsigned)((S + cols - 1) / cols), batch);
  gr_matmul_tower_kernel<D0, D1, NT, TC, CPT>
      <<<grid, NT, smem, stream>>>(A, B, C, T, R, S, fold, mask, vec);
  return (int)cudaGetLastError();
}

constexpr int tower_key(int d0, int d1, int nt, int tc, int cpt) {
  return (((d0 * 32 + d1) * 1024 + nt) * 32 + tc) * 32 + cpt;
}

}  // namespace

// (d0, d1, NT, TC, CPT) instantiations: every tower of the simt kernel that
// gr_matmul_skinny.cu has none for, each tower's default first.  The
// Python mirror is repro_torch.kernels.gr_matmul.TOWER_CONFIGS.
#define TOWER_CONFIGS(X)                                                          \
  X(3, 7, 256, 1, 4) X(3, 7, 256, 2, 2) X(3, 7, 256, 4, 1) X(3, 7, 128, 2, 2)     \
  X(9, 1, 256, 2, 2) X(11, 1, 256, 2, 2) X(13, 1, 256, 2, 2) X(15, 1, 256, 2, 2)  \
  X(2, 7, 256, 2, 2) X(3, 5, 256, 2, 2) X(5, 3, 256, 2, 2) X(7, 2, 256, 2, 2)

extern "C" {

// A (batch, T, R, D), B (batch, R, S, D) -> C (batch, T, S, D), all uint32
// words, contiguous, with the (threads, tc, cpt) instantiation of the
// tower (d0, d1).  Returns cudaGetLastError() after the launch, and
// cudaErrorInvalidValue for a configuration without an instantiation, T or
// R outside 1..16, or a lifted A beyond 227 KB of shared memory.
// fold_host: (K, D) uint32 row-major.
int gr_matmul_tower_u32(const void* A, const void* B, void* C, int batch, int T, int R, int S,
                        int d0, int d1, int threads, int tc, int cpt, const uint32_t* fold_host,
                        uint32_t mask, void* stream) {
  if (T < 1 || T > kMaxT || R < 1 || R > kMaxR) return (int)cudaErrorInvalidValue;
  const uint32_t* a = static_cast<const uint32_t*>(A);
  const uint32_t* b = static_cast<const uint32_t*>(B);
  uint32_t* c = static_cast<uint32_t*>(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tower_key(d0, d1, threads, tc, cpt)) {
#define TOWER_LAUNCH(x, y, nt, tr, cp) \
  case tower_key(x, y, nt, tr, cp):    \
    return launch<x, y, nt, tr, cp>(a, b, c, batch, T, R, S, fold_host, mask, st);
    TOWER_CONFIGS(TOWER_LAUNCH)
#undef TOWER_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The instantiations of the tower (d0, d1), default first: writes up to
// `cap` (threads, tc, cpt) triples to `out` and returns how many there are.
int gr_matmul_tower_configs(int d0, int d1, int* out, int cap) {
  int n = 0;
#define TOWER_CONFIG(x, y, nt, tr, cp) \
  if (x == d0 && y == d1) {            \
    if (n < cap) {                     \
      out[3 * n] = nt;                 \
      out[3 * n + 1] = tr;             \
      out[3 * n + 2] = cp;             \
    }                                  \
    ++n;                               \
  }
  TOWER_CONFIGS(TOWER_CONFIG)
#undef TOWER_CONFIG
  return n;
}

// Dynamic shared memory a launch over the tower (d0, d1) at (T, R) asks
// for (the same for every instantiation of the tower); -1 without one.
int64_t gr_matmul_tower_smem(int d0, int d1, int T, int R) {
#define TOWER_SMEM(x, y, nt, tr, cp) \
  if (x == d0 && y == d1) return 4 * Tower<x, y>::words(T, R);
  TOWER_CONFIGS(TOWER_SMEM)
#undef TOWER_SMEM
  return -1;
}

}  // extern "C"
