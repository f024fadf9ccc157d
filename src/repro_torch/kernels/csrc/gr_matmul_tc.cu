// Galois-ring matmul over GR(2^e, D), e <= 32, on the int8 tensor cores of
// sm_90a: the port's route for the CDMM worker products.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gr_matmul.py:_kernel
// (launched by gr_matmul_planar) for large T and S.  Same function:
//
//   A (batch, T, R, D) x B (batch, R, S, D) -> C (batch, T, S, D), uint32,
//   conv[CONVPOS(i, j)] += A[.., i] @ B[.., j]   (wrapping mod 2^32)
//   C[.., d] = (sum_c FOLD[c, d] * conv[c]) & mask
//
// The arithmetic: split every operand word into L = ceil(e/8) unsigned
// bytes, x = sum_a 2^(8a) x_a.  Mod 2^e (and so mod 2^32 before the mask)
//
//   A[i] @ B[j] = sum_{a+b<L} 2^(8(a+b)) (A[i]_a @ B[j]_b),
//
// and each A_a @ B_b is a u8 x u8 -> s32 tensor-core product.  A chain of at
// most floor((2^31-1)/255^2) = 33,025 byte products stays below 2^31, so it
// is exact whatever the accumulator's overflow rule.
//
// What bounds it: operations.  At the worker shape (8 x 1024x2048 @
// 2048x1024 over GR(2^32, 3)) it needs 8 * 9 * 10 byte products of 1024 x
// 2048 x 1024, 1.56 ms at the 1,979 TOP/s int8 peak, against 9.25 ms for the
// same work as uint32 multiply-adds on the CUDA cores (gr_matmul.cu).
//
// Design:
//  * A limb pre-pass (gr_matmul_tc_limbs) reads the interleaved int32
//    operands once and writes u8 limb planes, K-major for both operands as
//    the 8-bit MMAs need them: A as (batch, D, L, Tp, Rp) and B, transposed
//    through shared memory, as (batch, D, L, Sp, Rp).  It zero-pads T and S
//    to the block tile and R to the stage depth, so the main loop has no
//    edge checks.  It writes as many bytes as it reads.
//  * The main kernel: WM x WN warps per block, each warp a 16 x 8 tile, so a
//    (16 WM) x (8 WN) block tile; the default is 2 x 4 warps, 32 x 32.  A
//    ring of ST shared-memory stages, each holding a 64-deep slab of all
//    D * L limb planes of both operands, is filled with cp.async (16-byte
//    copies, rows padded to 80 bytes so that ldmatrix is free of bank
//    conflicts).  For every 32-deep step each warp loads the D * L
//    fragments of B (ldmatrix.x2) and of A (ldmatrix.x4) once, then
//    issues mma.sync.m16n8k32.row.col.s32.u8.u8.s32 for every (i, j, a, b)
//    with a + b < L into the int32 fragment of (CONVPOS(i, j), a + b), in an
//    order that keeps two MMAs into one fragment at least D + 1 apart, so
//    that each warp has independent MMAs in flight while one completes.
//  * The block tile (WM, WN) and the stage count ST are template
//    parameters beside the tower: a stage holds (BM + BN) * D * L * kRow
//    bytes, at most 227 KB in all, while a warp's K * L + K fragments and
//    accumulators do not depend on the tile.  TC_CONFIGS lists the
//    instantiations, the default of each tower first; the autotuner
//    (repro_torch.kernels.autotune) times them and picks per shape.
//  * Every 256 of R (kChunk) the fragments are flushed into K uint32
//    accumulators, acc[c] += frag[c][s] << 8s (exact mod 2^32), and zeroed.
//    A fragment then holds at most 256 * D * L <= 4,096 byte products.  The
//    shift-adds cost K * L per output per 256 of R, against
//    D^2 * L(L+1)/2 * 256 tensor-core multiply-adds.
//  * The epilogue folds by FOLD, masks to e bits and writes C in the
//    interleaved (batch, T, S, D) layout directly.
//  * The tower shape (D0, D1) is a template parameter, so CONVPOS(i, j) and
//    every fragment and accumulator index are compile-time constants; L is a
//    run-time argument (the fragments for L = 4 are always allocated, and
//    the MMAs with a + b >= L are skipped).  Instantiated for single-level
//    towers with D <= 4 (Z_2^e and GR(2^e, 2..4)), whose K * L + K
//    fragments and accumulators fit in registers; other towers take the
//    general kernel.
//
// Instruction choice: mma.sync with ldmatrix, not wgmma.  wgmma is the only
// way to the full tensor-core rate, but its shared-memory descriptors and
// core-matrix layouts for 8-bit K-major operands, and its 64-row warpgroup
// tiles (which would need the K * L fragments of 64 x N outputs per
// warpgroup), are a larger step.  mma.sync already moves the bound from the
// CUDA cores to the tensor cores; wgmma is the next step for this kernel.
//
// C interface (loaded with ctypes); the functions return cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int KS = 64;         // bytes of R per pipeline stage
constexpr int kRow = KS + 16;  // shared-memory row stride: conflict-free ldmatrix
constexpr int kChunk = 256;    // flush period in R
constexpr int kMaxL = 4;       // e <= 32
constexpr int kMaxD = 4;
constexpr int kMaxK = 7;
constexpr int kSmemMax = 227 * 1024;
constexpr int kMaxDevices = 64;

struct FoldTable {
  uint32_t f[kMaxK * kMaxD];
};

__host__ __device__ constexpr int convpos(int i, int j, int d0) {
  return (i / d0 + j / d0) * (2 * d0 - 1) + (i % d0 + j % d0);
}

// one instantiation: tower (D0, D1), WM x WN warps of 16 x 8, ST stages
template <int D0, int D1, int WM, int WN, int ST>
struct Tc {
  static constexpr int D = D0 * D1;
  static constexpr int K = (2 * D0 - 1) * (2 * D1 - 1);
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = 16 * WM;  // block tile rows (T)
  static constexpr int BN = 8 * WN;   // block tile columns (S)
  static constexpr int STAGES = ST;
  static_assert(ST >= 2, "the pipeline refills the stage read one step earlier");
  // shared memory of all stages for L limbs
  static constexpr int smem(int L) { return ST * D * L * (BM + BN) * kRow; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a (16x32 u8, row) @ b (32x8 u8, col), s32 accumulate, no saturation
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// limb pre-pass
// ---------------------------------------------------------------------------

// X (batch, rows, cols, D) -> Y (batch, D, L, rows_p, cols_p): one thread
// per 4 consecutive columns, one 4-byte store per (d, l) plane.
template <int D>
__global__ void limbs_rows_kernel(const uint32_t* __restrict__ X,
                                  uint32_t* __restrict__ Y, int batch, int rows,
                                  int cols, int L, int rows_p, int cols_p) {
  const int cq = cols_p / 4;
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= (int64_t)batch * rows_p * cq) return;
  const int c4 = idx % cq;
  const int64_t rest = idx / cq;
  const int row = rest % rows_p;
  const int64_t z = rest / rows_p;
  uint32_t x[4][D];
  const uint32_t* src = X + ((z * rows + row) * cols + 4 * c4) * D;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int d = 0; d < D; ++d)
      x[k][d] = (row < rows && 4 * c4 + k < cols) ? src[k * D + d] : 0u;
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      uint32_t packed = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) packed |= ((x[k][d] >> (8 * l)) & 0xFFu) << (8 * k);
      Y[(((z * D + d) * L + l) * rows_p + row) * (int64_t)cq + c4] = packed;
    }
  }
}

// X (batch, rows, cols, D) -> Y (batch, D, L, cols_p, rows_p): a 32 x 32
// tile of X through shared memory, read along cols and written along rows.
template <int D>
__global__ void __launch_bounds__(256)
    limbs_cols_kernel(const uint32_t* __restrict__ X, uint32_t* __restrict__ Y,
                      int rows, int cols, int L, int rows_p, int cols_p) {
  __shared__ uint32_t tile[32][32 * D + 1];
  const int64_t z = blockIdx.z;
  const int r0 = blockIdx.y * 32, c0 = blockIdx.x * 32;
  const uint32_t* Xb = X + z * rows * (int64_t)cols * D;
  for (int idx = threadIdx.x; idx < 32 * 32 * D; idx += blockDim.x) {
    const int rr = idx / (32 * D), w = idx - rr * (32 * D);
    const int r = r0 + rr, c = c0 + w / D;
    tile[rr][w] = (r < rows && c < cols) ? Xb[((int64_t)r * cols + c0) * D + w] : 0u;
  }
  __syncthreads();
  // 8 words of 4 bytes cover the tile's 32 rows; one word per thread and step
  const int rq = rows_p / 4;
  for (int idx = threadIdx.x; idx < D * L * 32 * 8; idx += blockDim.x) {
    const int r4 = idx & 7, cc = (idx >> 3) & 31, dl = idx >> 8;
    const int d = dl / L, l = dl - d * L;
    uint32_t packed = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      packed |= ((tile[4 * r4 + k][cc * D + d] >> (8 * l)) & 0xFFu) << (8 * k);
    Y[(((z * D + d) * L + l) * cols_p + c0 + cc) * (int64_t)rq + r0 / 4 + r4] = packed;
  }
}

template <int D>
int launch_limbs(const uint32_t* X, uint32_t* Y, int batch, int rows, int cols,
                 int L, int rows_p, int cols_p, int transpose, cudaStream_t st) {
  if (transpose) {
    // output (cols_p, rows_p): rows_p is the K-major axis
    dim3 grid(cols_p / 32, rows_p / 32, batch);
    limbs_cols_kernel<D><<<grid, 256, 0, st>>>(X, Y, rows, cols, L, rows_p, cols_p);
  } else {
    const int64_t n = (int64_t)batch * rows_p * (cols_p / 4);
    limbs_rows_kernel<D><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        X, Y, batch, rows, cols, L, rows_p, cols_p);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// main kernel
// ---------------------------------------------------------------------------

template <int D0, int D1, int WM, int WN, int ST>
__global__ void __launch_bounds__(32 * WM * WN, 1)
    gr_matmul_tc_kernel(const uint8_t* __restrict__ A8,
                        const uint8_t* __restrict__ B8, uint32_t* __restrict__ C,
                        int T, int S, int Tp, int Sp, int Rp, int L,
                        const FoldTable fold, uint32_t mask) {
  using G = Tc<D0, D1, WM, WN, ST>;
  constexpr int D = G::D, K = G::K, STAGES = G::STAGES;
  constexpr int kThreads = G::kThreads, BM = G::BM, BN = G::BN;
  static_assert(D1 == 1, "the MMA order assumes a single-level tower");
  extern __shared__ __align__(16) uint8_t smem[];
  const int P = D * L;  // limb planes per operand
  const int a_stage = P * BM * kRow;
  const int stage = P * (BM + BN) * kRow;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / WN) * 16, wn = (warp % WN) * 8;
  const int64_t z = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const uint8_t* Ab = A8 + z * P * (int64_t)Tp * Rp;
  const uint8_t* Bb = B8 + z * P * (int64_t)Sp * Rp;
  const int ktiles = Rp / KS;

  // one stage: P * (BM + BN) rows of KS bytes, four 16-byte pieces each
  auto load_stage = [&](int kt, int st) {
    uint8_t* sA = smem + st * stage;
    const int pieces = P * (BM + BN) * (KS / 16);
    for (int idx = tid; idx < pieces; idx += kThreads) {
      const int q = idx & 3, row = idx >> 2;
      const uint8_t* src;
      if (row < P * BM) {
        const int p = row / BM, m = row - p * BM;
        src = Ab + ((int64_t)p * Tp + m0 + m) * Rp;
      } else {
        const int rb = row - P * BM;
        const int p = rb / BN, n = rb - p * BN;
        src = Bb + ((int64_t)p * Sp + n0 + n) * Rp;
      }
      cp_async16(smem_addr(sA + row * kRow + q * 16), src + kt * KS + q * 16);
    }
  };

  int frag[K][kMaxL][4];
  uint32_t acc[K][4];
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[c][e] = 0u;
#pragma unroll
      for (int s = 0; s < kMaxL; ++s) frag[c][s][e] = 0;
    }
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix row addresses of this lane within a plane
  const int a_row = wm + (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = wn + (lane & 7), b_col = ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nk = kt + STAGES - 1;  // refills the stage read at kt - 1
      if (nk < ktiles) load_stage(nk, nk % STAGES);
      cp_async_commit();
    }
    const uint8_t* sA = smem + (kt % STAGES) * stage;
    const uint8_t* sB = sA + a_stage;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 32) {
      uint32_t bf[D][kMaxL][2];
#pragma unroll
      for (int j = 0; j < D; ++j)
#pragma unroll
        for (int y = 0; y < kMaxL; ++y)
          if (y < L)
            ldmatrix_x2(bf[j][y],
                        smem_addr(sB + ((j * L + y) * BN + b_row) * kRow + kk + b_col));
      uint32_t af[D][kMaxL][4];
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int x = 0; x < kMaxL; ++x)
          if (x < L)
            ldmatrix_x4(af[i][x],
                        smem_addr(sA + ((i * L + x) * BM + a_row) * kRow + kk + a_col));
      // limb pairs (x, y) in an order where neighbouring pairs feed
      // different shifts x + y; within a pair, the D^2 products walk the
      // conv diagonals c = i + j (single-level tower) rank by rank, so that
      // two MMAs into one fragment are at least D + 1 apart
#pragma unroll
      for (int x = 0; x < kMaxL; ++x)
#pragma unroll
        for (int y = 0; y < kMaxL; ++y)
          if (x + y < L)
#pragma unroll
            for (int rank = 0; rank < D; ++rank)
#pragma unroll
              for (int c = 0; c < K; ++c) {
                const int i = (c < D ? 0 : c - D + 1) + rank, j = c - i;
                if (i < D && j >= 0) mma_u8(frag[c][x + y], af[i][x], bf[j][y]);
              }
    }
    if ((kt + 1) % (kChunk / KS) == 0 || kt + 1 == ktiles) {
#pragma unroll
      for (int c = 0; c < K; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t v = 0u;
#pragma unroll
          for (int s = 0; s < kMaxL; ++s) {
            v += static_cast<uint32_t>(frag[c][s][e]) << (8 * s);
            frag[c][s][e] = 0;
          }
          acc[c][e] += v;
        }
      }
    }
  }
  cp_async_wait<0>();

  // fold-and-mask epilogue into the interleaved layout; the m16n8 fragment
  // of a lane holds rows g, g + 8 and columns 2q, 2q + 1 of the warp tile
  const int g = lane >> 2, q = lane & 3;
  uint32_t* Cb = C + z * T * (int64_t)S * D;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = m0 + wm + g + (e >> 1) * 8;
    const int col = n0 + wn + 2 * q + (e & 1);
    if (row < T && col < S) {
      uint32_t* dst = Cb + ((int64_t)row * S + col) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        uint32_t v = 0u;
#pragma unroll
        for (int c = 0; c < K; ++c) v += fold.f[c * D + d] * acc[c][e];
        dst[d] = v & mask;
      }
    }
  }
}

template <int D0, int D1, int WM, int WN, int ST>
int launch(const uint8_t* A8, const uint8_t* B8, uint32_t* C, int batch, int T,
           int S, int Tp, int Sp, int Rp, int L, const FoldTable& fold,
           uint32_t mask, cudaStream_t stream) {
  using G = Tc<D0, D1, WM, WN, ST>;
  if (Tp % G::BM || Sp % G::BN) return (int)cudaErrorInvalidValue;
  const int smem = G::smem(L);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  // raise the kernel's shared-memory limit once per device (the attribute
  // persists), not on every launch: launches may be captured in a CUDA graph
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    const int cap = G::smem(kMaxL) < kSmemMax ? G::smem(kMaxL) : kSmemMax;
    e = cudaFuncSetAttribute(gr_matmul_tc_kernel<D0, D1, WM, WN, ST>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = cap;
  }
  dim3 grid(Sp / G::BN, Tp / G::BM, batch);
  gr_matmul_tc_kernel<D0, D1, WM, WN, ST><<<grid, G::kThreads, smem, stream>>>(
      A8, B8, C, T, S, Tp, Sp, Rp, L, fold, mask);
  return (int)cudaGetLastError();
}

constexpr int tc_key(int d0, int d1, int wm, int wn, int st) {
  return (((d0 * 32 + d1) * 16 + wm) * 16 + wn) * 8 + st;
}

}  // namespace

// (d0, d1, WM, WN, ST) instantiations: single-level towers with D <= 4,
// each tower's default (the autotuner's fallback) first.  The Python mirror
// is repro_torch.kernels.gr_matmul.TC_CONFIGS.
#define TC_CONFIGS(X)                                                    \
  X(1, 1, 2, 4, 3) X(1, 1, 2, 4, 4) X(1, 1, 4, 4, 3) X(1, 1, 2, 2, 4)    \
  X(2, 1, 2, 4, 3) X(2, 1, 2, 4, 4) X(2, 1, 4, 2, 3) X(2, 1, 2, 2, 4)    \
  X(3, 1, 2, 4, 3) X(3, 1, 2, 4, 2) X(3, 1, 4, 2, 2) X(3, 1, 2, 2, 3)    \
  X(4, 1, 2, 4, 2) X(4, 1, 4, 2, 2) X(4, 1, 1, 8, 2) X(4, 1, 2, 2, 2)

extern "C" {

// Limb pre-pass: X (batch, rows, cols, D) uint32 -> Y uint8 limb planes,
// (batch, D, L, rows_p, cols_p), or (batch, D, L, cols_p, rows_p) with
// transpose, zero-padded.  rows_p, cols_p must be multiples of 32 (the
// K-major one of 64).
int gr_matmul_tc_limbs(const void* X, void* Y, int batch, int rows, int cols,
                       int d, int L, int rows_p, int cols_p, int transpose,
                       void* stream) {
  if (L < 1 || L > kMaxL || rows_p % 32 || cols_p % 32)
    return (int)cudaErrorInvalidValue;
  const uint32_t* x = static_cast<const uint32_t*>(X);
  uint32_t* y = static_cast<uint32_t*>(Y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: return launch_limbs<1>(x, y, batch, rows, cols, L, rows_p, cols_p, transpose, st);
    case 2: return launch_limbs<2>(x, y, batch, rows, cols, L, rows_p, cols_p, transpose, st);
    case 3: return launch_limbs<3>(x, y, batch, rows, cols, L, rows_p, cols_p, transpose, st);
    case 4: return launch_limbs<4>(x, y, batch, rows, cols, L, rows_p, cols_p, transpose, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A8 (batch, D, L, Tp, Rp), B8 (batch, D, L, Sp, Rp) u8 limb planes ->
// C (batch, T, S, D) uint32 with the (wm, wn, st) instantiation of the
// tower (d0, d1); cudaErrorInvalidValue if it has none, if Tp, Sp are not
// multiples of its block tile, Rp of KS, or its stages exceed 227 KB at L.
// fold_host: (K, D) uint32 row-major.
int gr_matmul_tc_u32(const void* A8, const void* B8, void* C, int batch, int T,
                     int S, int Tp, int Sp, int Rp, int L, int d0, int d1,
                     int wm, int wn, int stages, const uint32_t* fold_host,
                     uint32_t mask, void* stream) {
  const int D = d0 * d1, K = (2 * d0 - 1) * (2 * d1 - 1);
  if (D > kMaxD || K > kMaxK || L < 1 || L > kMaxL || Rp % KS)
    return (int)cudaErrorInvalidValue;
  FoldTable fold;
  memset(&fold, 0, sizeof(fold));
  memcpy(fold.f, fold_host, sizeof(uint32_t) * K * D);
  const uint8_t* a = static_cast<const uint8_t*>(A8);
  const uint8_t* b = static_cast<const uint8_t*>(B8);
  uint32_t* c = static_cast<uint32_t*>(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc_key(d0, d1, wm, wn, stages)) {
#define TC_LAUNCH(x, y, m, n, s)                                        \
  case tc_key(x, y, m, n, s):                                           \
    return launch<x, y, m, n, s>(a, b, c, batch, T, S, Tp, Sp, Rp, L, fold, \
                                 mask, st);
    TC_CONFIGS(TC_LAUNCH)
#undef TC_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The instantiations of the tower (d0, d1), default first: writes up to
// `cap` (wm, wn, stages) triples to `out` and returns how many there are.
int gr_matmul_tc_configs(int d0, int d1, int* out, int cap) {
  int n = 0;
#define TC_CONFIG(x, y, m, n_, s)  \
  if (x == d0 && y == d1) {        \
    if (n < cap) {                 \
      out[3 * n] = m;              \
      out[3 * n + 1] = n_;         \
      out[3 * n + 2] = s;          \
    }                              \
    ++n;                           \
  }
  TC_CONFIGS(TC_CONFIG)
#undef TC_CONFIG
  return n;
}

// KS of the tc kernel, the multiple its limb planes' R is padded to.
int gr_matmul_tc_depth() { return KS; }

}  // extern "C"
