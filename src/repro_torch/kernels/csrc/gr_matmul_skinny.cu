// Skinny Galois-ring matmul over GR(2^e, D), e <= 32, for sm_90a: the
// bandwidth route of the port's gr_matmul, for T <= 64 and R <= 32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gr_matmul.py:_kernel
// (launched by gr_matmul_planar) for the skinny calls of a CDMM round: RMFE
// phi/psi (2x2 @ 2x4M, 2x3 @ 3x4M), the Vandermonde encodes (8x2 @ 2x2M;
// 64x8 @ 8x1M for 64 workers) and the Lagrange decode (4x4 @ 4x1M; 32x32 @
// 32x128K).  Same function, in the port's interleaved layout end to end:
//
//   A (batch, T, R, D) x B (batch, R, S, D) -> C (batch, T, S, D), uint32,
//   conv[CONVPOS(i, j)] += A[.., i] * B[.., j]   (wrapping mod 2^32)
//   C[.., d] = (sum_c FOLD[c, d] * conv[c]) & mask
//
// What bounds it: bytes at T, R <= 16.  A is at most 64 x 32 x D words; B
// and C are R x S x D and T x S x D words with S in the millions, and each
// column of C costs T * R * D^2 multiply-adds: below the card's byte rate
// times its INT32 rate up to T, R = 16, and above it for the widest calls
// (a 64 x 8 encode or a 32 x 32 decode over GR(2^32, 6) needs 5-20
// multiply-adds a byte, the card 5), which the INT32 rate then bounds.
// Either way the design moves each byte of B and C once, with no padded
// rows (the general kernel in gr_matmul.cu tiles T by 64 and wastes most of
// the tile here):
//  * A block stages A (all of it) and its slab of B (all R rows, NB columns)
//    in shared memory with 16-byte loads, then each thread owns CPT
//    consecutive columns (CPT * D words, a whole number of 16-byte vectors)
//    and computes all T rows for them from shared memory: K conv
//    accumulators per column in registers, fold, mask, and 16-byte stores of
//    C.  Grid x covers S, grid y the batch.
//  * The tower shape (D0, D1) is a template parameter, so CONVPOS(i, j) and
//    the accumulator indices are compile-time constants.  Instantiated where
//    the K x CPT accumulators fit comfortably in registers (K * CPT <= 64).
//  * So are the threads per block (NT) and a multiple CM of the columns per
//    thread: a block covers NT * CPT * CM columns.  The default is NT = 128,
//    CM = 1; SKINNY_CONFIGS adds two more for the towers with D <= 4, which
//    the autotuner (repro_torch.kernels.autotune) times per shape.
//  * The B slab is sized from the block's shared memory (two blocks an SM,
//    kSmemCap = 100 KB, where they fit).  A widened call (T or R past 16)
//    whose slab would not fit splits its rows of C among G = kGroups = 4
//    groups of its NT threads that share one slab of NT / G * CPT columns,
//    each group taking every G-th row (a template instantiation of its own,
//    so the kernel every other call runs is unchanged); any other call
//    halves its NT threads instead, down to 32.  So a 32 x 32 decode over
//    GR(2^32, 6) runs 128 threads in 4 groups on a 48 KB slab, three blocks
//    an SM, where one group would need 192 KB and 32 threads 72 KB (three
//    warps an SM).  A block that still needs more than kSmemCap runs alone
//    on its SM, up to kSmemMax; beyond that the call is refused (the Python
//    mirror, skinny_smem_bytes, keeps such calls off this route).
//  * Ragged columns, and operands whose rows are not 16-byte aligned, take
//    4-byte loads and stores in the same kernel.
//
// C interface (loaded with ctypes); the functions return cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxD = 16;
constexpr int kMaxK = 45;
constexpr int kMaxT = 64;
constexpr int kMaxR = 32;
// dynamic shared memory a block asks for before its thread count stops
// halving, and the most a launch may ask for (above 48 KB needs the
// attribute)
constexpr int kSmemCap = 100 * 1024;
constexpr int kSmemMax = 227 * 1024;
// row groups of a widened call whose slab of B would not fit otherwise
constexpr int kGroups = 4;
constexpr int kMaxDevices = 64;

struct FoldTable {
  uint32_t f[kMaxK * kMaxD];
};

__host__ __device__ constexpr int convpos(int i, int j, int d0) {
  return (i / d0 + j / d0) * (2 * d0 - 1) + (i % d0 + j % d0);
}

template <int D0, int D1, int CM = 1>
struct Skinny {
  static constexpr int D = D0 * D1;
  static constexpr int K = (2 * D0 - 1) * (2 * D1 - 1);
  // columns per thread: CPT * D words make whole 16-byte vectors
  static constexpr int CPT = ((D % 4 == 0) ? 1 : (D % 2 == 0) ? 2 : 4) * CM;
  static constexpr int W = CPT * D;  // words per thread per row
};

// NG = kGroups: NT threads in NG groups share the slab's columns, each
// group taking every NG-th row of C (a widened call whose slab would not
// fit otherwise); NG = 1: every thread takes every row, at NT or fewer
// threads
template <int D0, int D1, int NT, int CM, int NG>
__global__ void __launch_bounds__(NT)
    gr_matmul_skinny_kernel(const uint32_t* __restrict__ A,
                            const uint32_t* __restrict__ B,
                            uint32_t* __restrict__ C, int T, int R, int S,
                            const FoldTable fold, uint32_t mask, int vec) {
  using G = Skinny<D0, D1, CM>;
  constexpr int D = G::D, K = G::K, CPT = G::CPT, W = G::W;
  static_assert(K * CPT <= 64, "accumulators would spill");
  extern __shared__ uint4 smem4[];
  uint32_t* As = reinterpret_cast<uint32_t*>(smem4);
  const int a_words = (T * R * D + 3) & ~3;
  uint32_t* Bs = As + a_words;  // [r][NB * D]

  const int tid = threadIdx.x;
  const int cols = NG > 1 ? NT / NG : blockDim.x;  // threads a row of C
  const int NB = cols * CPT;
  const int row_words = NB * D;
  const int64_t z = blockIdx.y;
  const int s0 = blockIdx.x * NB;
  const int ncols = min(NB, S - s0);
  const uint32_t* Ab = A + z * T * R * D;
  const uint32_t* Bb = B + z * R * (int64_t)S * D;
  uint32_t* Cb = C + z * T * (int64_t)S * D;

  for (int idx = tid; idx < T * R * D; idx += blockDim.x) As[idx] = Ab[idx];
  if (vec && ncols == NB) {
    const int row_vecs = row_words / 4;
#pragma unroll 4
    for (int idx = tid; idx < R * row_vecs; idx += blockDim.x) {
      const int r = idx / row_vecs, v = idx - r * row_vecs;
      const uint4* src =
          reinterpret_cast<const uint4*>(Bb + ((int64_t)r * S + s0) * D);
      reinterpret_cast<uint4*>(Bs + r * row_words)[v] = __ldg(src + v);
    }
  } else {
    const int valid = ncols * D;
    for (int idx = tid; idx < R * row_words; idx += blockDim.x) {
      const int r = idx / row_words, w = idx - r * row_words;
      Bs[idx] = w < valid ? Bb[((int64_t)r * S + s0) * D + w] : 0u;
    }
  }
  __syncthreads();

  const int c0 = (NG > 1 ? tid % cols : tid) * CPT;  // first column of this thread in the slab
  if (c0 >= ncols) return;
  const bool full = vec && c0 + CPT <= ncols;
  for (int t = NG > 1 ? tid / cols : 0; t < T; t += NG) {
    uint32_t acc[K][CPT];
#pragma unroll
    for (int c = 0; c < K; ++c)
#pragma unroll
      for (int n = 0; n < CPT; ++n) acc[c][n] = 0u;
    for (int r = 0; r < R; ++r) {
      uint32_t b[W];
      const uint4* bs = reinterpret_cast<const uint4*>(Bs + r * row_words + c0 * D);
#pragma unroll
      for (int q = 0; q < W / 4; ++q) {
        const uint4 v = bs[q];
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
      const uint32_t* a = As + (t * R + r) * D;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const uint32_t ai = a[i];
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const int c = convpos(i, j, D0);
#pragma unroll
          for (int n = 0; n < CPT; ++n) acc[c][n] += ai * b[n * D + j];
        }
      }
    }
    uint32_t out[W];
#pragma unroll
    for (int n = 0; n < CPT; ++n) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        uint32_t v = 0u;
#pragma unroll
        for (int c = 0; c < K; ++c) v += fold.f[c * D + d] * acc[c][n];
        out[n * D + d] = v & mask;
      }
    }
    uint32_t* dst = Cb + ((int64_t)t * S + s0 + c0) * D;
    if (full) {
#pragma unroll
      for (int q = 0; q < W / 4; ++q)
        reinterpret_cast<uint4*>(dst)[q] =
            make_uint4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
    } else {
#pragma unroll
      for (int n = 0; n < CPT; ++n) {
        if (c0 + n < ncols) {
#pragma unroll
          for (int d = 0; d < D; ++d) dst[n * D + d] = out[n * D + d];
        }
      }
    }
  }
}

// A block's threads and row groups for a (T, R) call, and its dynamic
// shared memory in bytes: all of A and an R-row slab of B for th / g
// threads' columns.  Past kSmemCap, a widened call (T or R past 16, T >=
// kGroups) splits its rows among kGroups groups of its NT threads; any
// other halves its threads while it needs more, down to 32.
template <int D0, int D1, int NT, int CM>
size_t block_smem(int T, int R, int* threads, int* groups) {
  using G = Skinny<D0, D1, CM>;
  const size_t a_words = (T * R * G::D + 3) & ~3;
  auto smem_for = [&](int th, int g) { return 4 * (a_words + (size_t)R * (th / g) * G::W); };
  int th = NT, g = 1;
  if (smem_for(th, g) > (size_t)kSmemCap && (T > 16 || R > 16) && T >= kGroups)
    g = kGroups;
  while (g == 1 && th > 32 && smem_for(th, g) > (size_t)kSmemCap) th /= 2;
  *threads = th;
  *groups = g;
  return smem_for(th, g);
}

template <int D0, int D1, int NT, int CM>
int launch(const uint32_t* A, const uint32_t* B, uint32_t* C, int batch, int T,
           int R, int S, const FoldTable& fold, uint32_t mask,
           cudaStream_t stream) {
  using G = Skinny<D0, D1, CM>;
  int threads = NT, groups = 1;
  const size_t smem = block_smem<D0, D1, NT, CM>(T, R, &threads, &groups);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // once per device (the attribute persists): launches may be captured
    // in a CUDA graph
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!raised[dev]) {
      e = cudaFuncSetAttribute(gr_matmul_skinny_kernel<D0, D1, NT, CM, 1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(gr_matmul_skinny_kernel<D0, D1, NT, CM, kGroups>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (e != cudaSuccess) return (int)e;
      raised[dev] = true;
    }
  }
  // 16-byte paths need every row of B and C to start on a 16-byte boundary
  const int vec = ((int64_t)S * G::D) % 4 == 0 &&
                  ((uintptr_t)B | (uintptr_t)C) % 16 == 0;
  const int nb = threads / groups * G::CPT;
  dim3 grid((S + nb - 1) / nb, batch);
  if (groups > 1)
    gr_matmul_skinny_kernel<D0, D1, NT, CM, kGroups><<<grid, threads, smem, stream>>>(
        A, B, C, T, R, S, fold, mask, vec);
  else
    gr_matmul_skinny_kernel<D0, D1, NT, CM, 1><<<grid, threads, smem, stream>>>(
        A, B, C, T, R, S, fold, mask, vec);
  return (int)cudaGetLastError();
}

constexpr int skinny_key(int d0, int d1, int nt, int cm) {
  return ((d0 * 32 + d1) * 1024 + nt) * 8 + cm;
}

}  // namespace

// Tower shapes with K * CPT <= 64 (see Skinny): the Python mirror is
// repro_torch.kernels.gr_matmul.skinny_cols.
#define SKINNY_TOWERS(X)                                                    \
  X(1, 1) X(2, 1) X(3, 1) X(4, 1) X(5, 1) X(6, 1) X(7, 1) X(8, 1) X(10, 1)  \
  X(12, 1) X(14, 1) X(16, 1) X(2, 3) X(2, 5) X(3, 2) X(3, 4) X(4, 3) X(5, 2)

// (d0, d1, NT, CM) beyond each tower's default (128, 1), which every tower
// of SKINNY_TOWERS has; the Python mirror is
// repro_torch.kernels.gr_matmul.SKINNY_CONFIGS.
#define SKINNY_EXTRA(X)                                                  \
  X(1, 1, 256, 1) X(1, 1, 128, 2) X(2, 1, 256, 1) X(2, 1, 128, 2)        \
  X(3, 1, 256, 1) X(3, 1, 128, 2) X(4, 1, 256, 1) X(4, 1, 128, 2)

extern "C" {

// A (batch, T, R, D), B (batch, R, S, D) -> C (batch, T, S, D), all uint32
// words, contiguous, with the (threads, cm) instantiation of the tower
// (d0, d1).  Returns cudaGetLastError() after the launch, and
// cudaErrorInvalidValue for a configuration without an instantiation,
// T > 64, R > 32, or a block beyond 227 KB of shared memory.
int gr_matmul_skinny_u32(const void* A, const void* B, void* C, int batch,
                         int T, int R, int S, int d0, int d1, int threads,
                         int cm, const uint32_t* fold_host, uint32_t mask,
                         void* stream) {
  const int D = d0 * d1, K = (2 * d0 - 1) * (2 * d1 - 1);
  if (D > kMaxD || K > kMaxK || T > kMaxT || R > kMaxR || T < 1 || R < 1)
    return (int)cudaErrorInvalidValue;
  FoldTable fold;
  memset(&fold, 0, sizeof(fold));
  memcpy(fold.f, fold_host, sizeof(uint32_t) * K * D);
  const uint32_t* a = static_cast<const uint32_t*>(A);
  const uint32_t* b = static_cast<const uint32_t*>(B);
  uint32_t* c = static_cast<uint32_t*>(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (skinny_key(d0, d1, threads, cm)) {
#define SKINNY_LAUNCH4(x, y, nt, m) \
  case skinny_key(x, y, nt, m):     \
    return launch<x, y, nt, m>(a, b, c, batch, T, R, S, fold, mask, st);
#define SKINNY_LAUNCH(x, y) SKINNY_LAUNCH4(x, y, 128, 1)
    SKINNY_TOWERS(SKINNY_LAUNCH)
    SKINNY_EXTRA(SKINNY_LAUNCH4)
#undef SKINNY_LAUNCH
#undef SKINNY_LAUNCH4
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of a (T, R) launch with the (threads, cm)
// instantiation of the tower (d0, d1), in bytes (threads_out, groups_out:
// the block's threads and row groups); -1 without the instantiation.  The
// Python mirror is repro_torch.kernels.gr_matmul.skinny_smem_bytes.
long long gr_matmul_skinny_smem(int d0, int d1, int threads, int cm, int T, int R,
                                int* threads_out, int* groups_out) {
  switch (skinny_key(d0, d1, threads, cm)) {
#define SKINNY_SMEM4(x, y, nt, m) \
  case skinny_key(x, y, nt, m):   \
    return (long long)block_smem<x, y, nt, m>(T, R, threads_out, groups_out);
#define SKINNY_SMEM(x, y) SKINNY_SMEM4(x, y, 128, 1)
    SKINNY_TOWERS(SKINNY_SMEM)
    SKINNY_EXTRA(SKINNY_SMEM4)
#undef SKINNY_SMEM
#undef SKINNY_SMEM4
    default:
      return -1;
  }
}

// Columns per thread of the default instantiation for a tower shape; -1 if
// none.
int gr_matmul_skinny_cols(int d0, int d1) {
  switch (d0 * 32 + d1) {
#define SKINNY_COLS(x, y) \
  case x * 32 + y:        \
    return Skinny<x, y>::CPT;
    SKINNY_TOWERS(SKINNY_COLS)
#undef SKINNY_COLS
    default:
      return -1;
  }
}

// The instantiations of the tower (d0, d1), default first: writes up to
// `cap` (threads, cm) pairs to `out` and returns how many there are.
int gr_matmul_skinny_configs(int d0, int d1, int* out, int cap) {
  int n = 0;
  auto add = [&](int nt, int m) {
    if (n < cap) {
      out[2 * n] = nt;
      out[2 * n + 1] = m;
    }
    ++n;
  };
#define SKINNY_DEFAULT(x, y) \
  if (x == d0 && y == d1) add(128, 1);
#define SKINNY_MORE(x, y, nt, m) \
  if (x == d0 && y == d1) add(nt, m);
  SKINNY_TOWERS(SKINNY_DEFAULT)
  SKINNY_EXTRA(SKINNY_MORE)
#undef SKINNY_DEFAULT
#undef SKINNY_MORE
  return n;
}

}  // extern "C"
