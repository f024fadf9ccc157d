// The general route (simt) of the port's Galois-ring matmul over
// GR(2^e, D), e <= 32, D <= 16 and the two-level (3, 7) tower (D = 21),
// for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gr_matmul.py:_kernel
// (launched by gr_matmul_planar).  Same function, in the port's
// interleaved layout end to end (no planar copy of either operand):
//
//   A (batch, T, R, D) x B (batch, R, S, D) -> C (batch, T, S, D), uint32,
//   conv[CONVPOS(i, j)] += A[.., i] * B[.., j]   (wrapping mod 2^32)
//   C[.., d] = (sum_c FOLD[c, d] * conv[c]) & mask
//
// The route takes every call the others leave (ops.pick_route): products
// below 64 rows over GR(2^e, D <= 4) (the worker products of
// CodedQuantMatmul at decode batch sizes and of examples/coded_inference,
// ep's 48-row worker blocks), the lifted rings' calls with D1 t < 64 or
// s < 64, the towers (5, 2), (5, 3), (7, 2) and (3, 7), and whatever a
// caller hands it directly.  Two kernels, one per regime; which one a call
// runs is fixed by its ring and t (thin_applies):
//
// 1. The thin kernel (simt_thin_kernel): single-level GR(2^e, D), D <= 4,
//    t <= 64, on the int8 tensor cores.
//
//    What bounds it: bytes.  B (R x S x D words) is the big operand; A is
//    at most 64 rows.  At 8 tokens of gemma2-2b's FFN (16 x 4x1152 @
//    1152x4608 over GR(2^32, 4)) B is 1.36 GB, 0.41 ms at 3.35 TB/s, while
//    its 10 byte products a word product take 0.11 ms of int8 operations
//    with no padding, and 1.3-2.6 ms as uint32 multiply-adds on the CUDA
//    cores with the 16-row padding of a CUDA-core tile.  So the design
//    reads B once, as it lies, and keeps the tensor cores' padding small:
//
//    * The fold goes into A, not after the products: over Z_2^32 the
//      product is C[t, s, m] = sum_(k, r) M(A)[(t, m), (k, r)] B[r, s, k]
//      with M(a)[k, m] = (a x^k)_m, a's multiplication matrix (columns
//      x^k a, reduced by the ring's modulus).  So every (t, m) is one row
//      of a plain product over Z_2^32: D t rows (4 t at D = 4) fill the 16
//      rows of an mma.sync tile that t alone would leave at 1/16 - 1/4,
//      and each output needs one accumulator per limb shift instead of one
//      per (conv position, shift): 4 registers a 16 x 8 tile and shift
//      instead of 4 K.  The byte products are the same ten a word product
//      that tc keeps (ref.gr_matmul_limbs_ref).
//    * A block owns floor(64 / D) whole values of t (up to 64 rows of
//      M(A): one to four m16 tiles), BN columns of s and one batch entry,
//      and walks a contiguous range of R in stages of 32 rows.  Each stage
//      brings 32 rows x BN x D words of B and the block's rows of A (all t
//      of them, 32 x D words each) into shared memory with 16-byte
//      cp.async (4-byte where a row is not 16-byte aligned; A zero-filled
//      past R, so B's rows past R and S need no loads) through a ring of 3
//      stages, so B streams from device memory once while the tensor cores
//      work on the stage before.
//    * Once a stage, the block lifts its rows of A: M(A[t, r]) by the
//      recurrence x^(k+1) a = x (x^k a), D - 1 multiply-adds a coefficient
//      (the modulus row FOLD[D] passed in), split into byte limbs with
//      __byte_perm and stored in the mma.sync A-fragment order, 16 bytes a
//      lane (LDS.128).  A costs D^2 multiply-adds an element a block and
//      stage; at t <= 64 that is at most a fifth of the tensor work.
//    * mma.sync.m16n8k32.u8.u8.s32: the 32-deep step is one coefficient k
//      of 32 rows of r.  A lane's B fragment (4 rows of r, one column s) is
//      packed from the words as they lie in shared memory with __byte_perm
//      (4 words -> 4 limb registers in 8 permutes): no limb pre-pass and no
//      second read of B.  Lane (g, i) takes rows 4q + i (+16), so the 8
//      lanes of a 16-byte load phase hit 8 distinct 16-byte bank groups
//      (rows padded by 8 words).  Every (x, y) with x + y < L feeds
//      accumulator x + y; wgmma's 64-row tiles would waste at least 75% at
//      t <= 16, so mma.sync it is.
//    * Warps: one or two m16 tiles (D t <= 32) take one row of four warps,
//      each warp on all of them and its own n8 tiles (RC x NN a warp;
//      THIN_CONFIGS); three or four take two rows of four warps, each on
//      two m16 tiles and one n8 tile, at 128 registers, so that 16 warps an
//      SM hide the stage's lift and the mma.sync latencies.  Two blocks an
//      SM, at most 113 KB of shared memory each.  (Four more warps of a
//      block lifting and loading for the MMA warps, handing stages over by
//      named barriers at one block an SM, ran slower.)  The s32
//      accumulators wrap mod 2^32 (no .satfinite), and so does every
//      shift-add, so no chain needs a flush.
//    * Grid: (t chunks x s tiles x R splits x batch), flattened, t chunks
//      fastest so that the chunks of one s tile share B in L2.  Where that
//      leaves fewer than four waves of two blocks an SM, R is split
//      (thin_plan: up to 8 ways, the fewest that fill the last wave to 90%)
//      and each split adds its partial result into C (zeroed by the
//      wrapper) with wrapping 32-bit atomics: exact, since the fold is
//      linear mod 2^32 and the mask is a ring map.  With e < 32 the last
//      split of each tile to finish (a counter per tile, zeroed by the
//      wrapper, after a __threadfence) masks the tile once.
//
// 2. The tile kernel (gr_matmul_kernel): every other call, on the CUDA
//    cores, on the interleaved layout.  One block of 256 threads owns a BM x BN output tile for all D planes
//    of one batch entry; the reduction over R is a loop inside the block
//    through shared-memory tiles of A's and B's D planes (rows padded by
//    one word, so the transposing stores hit distinct banks), read from
//    the interleaved operands with consecutive threads on consecutive
//    words; each thread keeps the K conv accumulators of its TM x TM
//    outputs in registers (the tower shape is a template parameter, so
//    CONVPOS is a compile-time constant); FOLD (K x D) and the mask come
//    in as kernel parameters; the fold-and-mask epilogue writes each
//    output once.  What bounds it: operations, uint32 multiply-adds on the
//    CUDA cores, at the shapes that reach it (t > 64: the worker products
//    that phase 4 of chip_smoke.py times simt beside).  Which
//    instantiation takes which ring:
//    * GR(2^e, D <= 4) past 64 rows: this kernel; thin shapes go to (1).
//    * GR(2^e, D) for D = 5..16 and the towers (2, 3), (2, 5), (2, 7),
//      (3, 2), (3, 4), (3, 5), (4, 3): this kernel at every t.  Lifted onto
//      Z_2^32 the thin kernel's lift would cost D^2 multiply-adds an
//      element of A a block and stage and hold D^2 t x 32 words of M(A) a
//      stage (64 KB at D = 16, t = 4), against B stages D times wider; the
//      calls that reach simt at these rings are rare (tc, tc_left, skinny
//      and tower take the main path's), so they keep the CUDA cores.
//    * The towers (5, 2), (5, 3), (7, 2) (no tensor-core inner ring) and
//      (3, 7) (K = 65 accumulators an output: TM = 1): this kernel.
//
// C interface (loaded with ctypes): every pointer and the stream are
// void*/uint32_t*, the launches return cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

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
  // shared-memory rows, padded by one word against bank conflicts
  static constexpr int BMP = BM + 1;
  static constexpr int BNP = BN + 1;
  // depth of one shared-memory stage: both tiles within 48 KB static smem
  static constexpr int BK = (D * 16 * (BMP + BNP) * 4 <= 48 * 1024) ? 16 : 8;
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
      a[d][m] = As[(d * G::BK + k) * G::BMP + ty + 16 * m];
      b[d][m] = Bs[(d * G::BK + k) * G::BNP + tx + 16 * m];
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
  // the tile loads unroll at D <= 4 only: past it ptxas trades registers
  // for spills (the (5, 1) instantiation)
  constexpr int kLoadUnroll = D <= 4 ? 4 : 1;
  __shared__ uint32_t As[D * BK * G::BMP];  // [d][k][m]
  __shared__ uint32_t Bs[D * BK * G::BNP];  // [d][k][n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t z = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const uint32_t* Ab = A + z * (int64_t)T * R * D;
  const uint32_t* Bb = B + z * (int64_t)R * S * D;

  uint32_t acc[K][TM][TM];
#pragma unroll
  for (int c = 0; c < K; ++c)
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TM; ++n) acc[c][m][n] = 0u;

  for (int k0 = 0; k0 < R; k0 += BK) {
    // A tile: thread (m, k) reads the D words of A[t][r][.], consecutive
    // threads the consecutive k of one row (D k words in a run) and store
    // planes that are one word apart in banks (rows padded to BMP)
#pragma unroll (kLoadUnroll)
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      const int k = idx % BK, m = idx / BK;
      const int gr = row0 + m, gk = k0 + k;
      const bool ok = gr < T && gk < R;
      const uint32_t* src = Ab + ((int64_t)gr * R + gk) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) As[(d * BK + k) * G::BMP + m] = ok ? src[d] : 0u;
    }
    // B tile: thread (k, n) reads the D words of B[r][s][.], consecutive
    // threads the consecutive s of one row
#pragma unroll (kLoadUnroll)
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int n = idx % BN, k = idx / BN;
      const int gk = k0 + k, gc = col0 + n;
      const bool ok = gk < R && gc < S;
      const uint32_t* src = Bb + ((int64_t)gk * S + gc) * D;
#pragma unroll
      for (int d = 0; d < D; ++d) Bs[(d * BK + k) * G::BNP + n] = ok ? src[d] : 0u;
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

  // fold-and-mask epilogue, D consecutive words of C[t][s][.] a thread
  uint32_t* Cb = C + z * (int64_t)T * S * D;
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
          Cb[((int64_t)row * S + col) * D + d] = v & mask;
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

// -- the thin kernel: t <= 64 over GR(2^e, D <= 4) on the int8 tensor cores --

namespace thin {

constexpr int kBK = 32;        // rows of r a stage: one 32-deep MMA step a coefficient
constexpr int kStages = 3;
constexpr int kRows = 64;      // rows (t, m) of M(A) a block: floor(64 / D) whole t
constexpr int kPad = 8;        // words past each row of a B stage
constexpr int kMaxT = 64;
constexpr int kMaxD = 4;
constexpr int kMaxSplits = 8;
constexpr int kBlocksPerSm = 2;
constexpr int kSmemMax = 113 * 1024;  // two blocks an SM

// How a call is cut: wm x wn warps of rc m16 tiles x nn n8 tiles each (a
// block of 8 wn nn columns), a block of t_blk whole t (chunks of them), R
// in stages of 32 split `splits` ways.  The Python mirror is
// repro_torch.kernels.gr_matmul.simt_grid.
struct Plan {
  int rc, nn, wm, wn, bn, t_blk, chunks, col_tiles, splits, n_st, rsb, smem;
  long long blocks;
};

// r-splits: one where the units (chunks x s tiles x batch) fill four waves
// of two blocks an SM; else the fewest splits up to 8 (and the stages)
// whose last wave is at least 90% full, else the fullest
inline int choose_splits(long long units, int sms, int n_st) {
  const long long slots = (long long)kBlocksPerSm * sms;
  const int most = n_st < kMaxSplits ? n_st : kMaxSplits;
  if (units >= 4 * slots || most <= 1) return 1;
  int best = 1;
  long long best_num = units, best_den = ((units + slots - 1) / slots) * slots;
  for (int s = 1; s <= most; ++s) {
    const long long num = units * s, den = ((num + slots - 1) / slots) * slots;
    if (10 * num >= 9 * den) return s;
    if (num * best_den > best_num * den) {
      best = s;
      best_num = num;
      best_den = den;
    }
  }
  return best;
}

inline Plan make_plan(int D, long long batch, int T, int R, int S, int sms, int splits) {
  Plan p;
  p.t_blk = T < kRows / D ? T : kRows / D;
  // B's stage rows stay at most 128 words.  One or two m16 tiles: one row
  // of four warps, each on all of them and on nn n8 tiles (at most 4 tiles
  // a warp); three or four: two rows of four warps at 128 registers a
  // thread, each warp on two m16 tiles and one n8 tile
  const int mt = (D * p.t_blk + 15) / 16;
  const int bn_max = D == 1 ? 128 : D == 2 ? 64 : 32;
  if (mt <= 2) {
    p.rc = mt, p.wm = 1, p.wn = 4;
    p.nn = bn_max / 32 < 4 / p.rc ? bn_max / 32 : 4 / p.rc;
  } else {
    p.rc = 2, p.wm = 2, p.wn = 4, p.nn = 1;
  }
  p.bn = 8 * p.wn * p.nn;
  p.chunks = (T + p.t_blk - 1) / p.t_blk;
  p.col_tiles = (S + p.bn - 1) / p.bn;
  p.n_st = (R + kBK - 1) / kBK;
  p.rsb = p.bn * D + kPad;
  // the ring (B and A a stage) and M(A)'s fragments: rc wm m16 tiles x D
  // coefficients x 4 limbs x 32 lanes x 16 bytes
  p.smem = 4 * kStages * (kBK * p.rsb + p.t_blk * kBK * D) + p.rc * p.wm * D * 2048;
  const long long units = (long long)p.chunks * p.col_tiles * batch;
  if (splits <= 0) splits = choose_splits(units, sms, p.n_st);
  const int cap = p.n_st < kMaxSplits ? (p.n_st > 1 ? p.n_st : 1) : kMaxSplits;
  p.splits = splits < cap ? splits : cap;
  p.blocks = units * p.splits;
  return p;
}

struct Args {
  const uint32_t* A;
  const uint32_t* B;
  uint32_t* C;
  unsigned* done;  // a counter per tile (e < 32 and splits > 1), else null
  int T, R, S;
  int t_blk, chunks, col_tiles, splits, n_st, vec_a, vec_b, L;
  uint32_t mask;
  uint32_t xd[kMaxD];  // x^D reduced: FOLD's row D
};

__device__ __forceinline__ void cp16(uint32_t* dst, const uint32_t* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(uint32_t* dst, const uint32_t* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// out[x] holds byte x of w0..w3 in its bytes 0..3
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                           uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ void mma_u8(uint32_t (&c)[4], const uint4& a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// the compile-time shape of an instantiation: NT threads, BN columns, RSB
// words a row of a B stage
template <int D, int RC, int NN, int WM, int WN>
struct Shape {
  static constexpr int NT = 32 * WM * WN;
  static constexpr int BN = 8 * WN * NN;
  static constexpr int RSB = BN * D + kPad;
};

// one stage: 32 rows of r from r0 of B (BN columns from s0, all D words)
// and of the block's nt rows of A.  A is zero past R, so M(A) is zero at
// those depths and B's rows past R need no zeros (whatever the stage holds
// there meets a zero); B's columns past S give outputs that are not stored
template <int D, int RC, int NN, int WM, int WN>
__device__ __forceinline__ void load_stage(const Args& p, uint32_t* bs, uint32_t* as,
                                           const uint32_t* Bz, const uint32_t* Az, int r0,
                                           int s0, int ncols, int nt, int tid) {
  using G = Shape<D, RC, NN, WM, WN>;
  constexpr int row_w = G::BN * D;
  const int valid_w = ncols * D, rows = p.R - r0 < kBK ? p.R - r0 : kBK;
  if (p.vec_b) {
    constexpr int cpr = row_w / 4;
    const int vcpr = valid_w / 4;
    for (int idx = tid; idx < rows * vcpr; idx += G::NT) {
      const int row = idx / vcpr, c = idx - row * vcpr;
      cp16(bs + row * G::RSB + 4 * c, Bz + ((int64_t)(r0 + row) * p.S + s0) * D + 4 * c, true);
    }
    static_assert(cpr * 4 == row_w, "B rows are whole 16-byte vectors");
  } else {
    for (int idx = tid; idx < rows * valid_w; idx += G::NT) {
      const int row = idx / valid_w, w = idx - row * valid_w;
      cp4(bs + row * G::RSB + w, Bz + ((int64_t)(r0 + row) * p.S + s0) * D + w, true);
    }
  }
  constexpr int arow = kBK * D;
  const int avalid = (p.R - r0 < kBK ? p.R - r0 : kBK) * D;
  if (p.vec_a) {
    constexpr int cpr = arow / 4;
    for (int idx = tid; idx < nt * cpr; idx += G::NT) {
      const int row = idx / cpr, c = idx - row * cpr;
      const bool ok = 4 * c < avalid;
      cp16(as + row * arow + 4 * c, ok ? Az + ((int64_t)row * p.R + r0) * D + 4 * c : Az, ok);
    }
  } else {
    for (int idx = tid; idx < nt * arow; idx += G::NT) {
      const int row = idx / arow, w = idx - row * arow;
      const bool ok = w < avalid;
      cp4(as + row * arow + w, ok ? Az + ((int64_t)row * p.R + r0) * D + w : Az, ok);
    }
  }
}

// M(A) of the stage's rows into the fragment buffer af: fragment (m16 tile
// mi, coefficient k, limb x) holds 16 bytes a lane, registers {row g, row g
// + 8} x {rows of r 4q + i, 16 + 4q + i} of lane (g, i), byte q.  A task
// (t, half h, i) lifts A[t, 16h + 4q + i] for q = 0..3 and packs them; at
// D > 1 two warps share a task, one storing the first half of the
// coefficients k and the other the rest (each runs the recurrence as far
// as it stores), so that every warp of the block lifts.
template <int D, int NT>
__device__ __forceinline__ void lift_stage(const Args& p, const uint32_t* as, uint32_t* af,
                                           int nt, int tid) {
  constexpr int KS = D > 1 ? 2 : 1, KMID = (D + 1) / 2;
  const int tasks = nt * 8, padded = (tasks + 31) / 32 * 32;
  for (int job = tid; job < padded * KS; job += NT) {
    const int kh = (job >> 5) % KS, task = (job / (32 * KS)) * 32 + (job & 31);
    if (task >= tasks) continue;
    const int tt = task >> 3, h = (task >> 2) & 1, i = task & 3;
    const int klo = kh ? KMID : 0, khi = kh || KS == 1 ? D : KMID;
    uint32_t v[4][D];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t* src = as + (tt * kBK + 16 * h + 4 * q + i) * D;
      if constexpr (D == 4) {
        const uint4 w = *reinterpret_cast<const uint4*>(src);
        v[q][0] = w.x, v[q][1] = w.y, v[q][2] = w.z, v[q][3] = w.w;
      } else if constexpr (D == 2) {
        const uint2 w = *reinterpret_cast<const uint2*>(src);
        v[q][0] = w.x, v[q][1] = w.y;
      } else {
#pragma unroll
        for (int c = 0; c < D; ++c) v[q][c] = src[c];
      }
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k >= khi) break;
      if (k > 0) {  // x^k a = x (x^(k-1) a): shift up, fold the top by x^D
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t top = v[q][D - 1];
#pragma unroll
          for (int m = D - 1; m > 0; --m) v[q][m] = v[q][m - 1] + top * p.xd[m];
          v[q][0] = top * p.xd[0];
        }
      }
      if (k < klo) continue;
#pragma unroll
      for (int m = 0; m < D; ++m) {
        uint32_t limb[4];
        transpose4(v[0][m], v[1][m], v[2][m], v[3][m], limb);
        const int rho = tt * D + m, rr = rho & 15;
        const int lane = (rr & 7) * 4 + i, reg = (rr >> 3) + 2 * h;
        uint32_t* dst = af + ((((rho >> 4) * D + k) * 4) * 32 + lane) * 4 + reg;
#pragma unroll
        for (int x = 0; x < 4; ++x) dst[x * 128] = limb[x];
      }
    }
  }
}

// one stage's products of this warp's tiles: for each coefficient k, B's
// fragments of its n8 tiles packed from the words in shared memory, then
// M(A)'s fragments of its m16 tiles and every (x, y) with x + y < L
template <int D, int RC, int NN, int WM, int WN>
__device__ __forceinline__ void mma_stage(const Args& p, const uint32_t* bs, const uint32_t* af,
                                          int wm, int wn, int mt_valid, int lane,
                                          uint32_t (&acc)[RC][NN][4][4]) {
  using G = Shape<D, RC, NN, WM, WN>;
  const int g = lane >> 2, i = lane & 3;
  uint32_t w[NN][2][4][D];  // B[r = 16h + 4q + i, n, 0..D-1]
#pragma unroll
  for (int j = 0; j < NN; ++j) {
    const int col = ((wn * NN + j) * 8 + g) * D;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t* src = bs + (16 * h + 4 * q + i) * G::RSB + col;
        if constexpr (D == 4) {
          const uint4 v = *reinterpret_cast<const uint4*>(src);
          w[j][h][q][0] = v.x, w[j][h][q][1] = v.y, w[j][h][q][2] = v.z, w[j][h][q][3] = v.w;
        } else if constexpr (D == 2) {
          const uint2 v = *reinterpret_cast<const uint2*>(src);
          w[j][h][q][0] = v.x, w[j][h][q][1] = v.y;
        } else {
#pragma unroll
          for (int c = 0; c < D; ++c) w[j][h][q][c] = src[c];
        }
      }
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    uint32_t b[NN][2][4];
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        transpose4(w[j][h][0][k], w[j][h][1][k], w[j][h][2][k], w[j][h][3][k], b[j][h]);
#pragma unroll
    for (int mi = 0; mi < RC; ++mi) {
      const int m = wm * RC + mi;
      if (m >= mt_valid) continue;
      const uint4* ap = reinterpret_cast<const uint4*>(af) + (m * D + k) * 4 * 32 + lane;
      uint4 a[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) a[x] = ap[x * 32];
#pragma unroll
      for (int j = 0; j < NN; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; x + y < 4; ++y)
            if (p.L == 4 || x + y < p.L) mma_u8(acc[mi][j][x + y], a[x], b[j][0][y], b[j][1][y]);
    }
  }
}

template <int D, int RC, int NN, int WM, int WN>
__global__ void __launch_bounds__(Shape<D, RC, NN, WM, WN>::NT, kBlocksPerSm)
    simt_thin_kernel(const Args p) {
  using G = Shape<D, RC, NN, WM, WN>;
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_last;
  const int stage_words = kBK * G::RSB + p.t_blk * kBK * D;
  uint32_t* af = smem + kStages * stage_words;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WN, wn = warp % WN;
  long long bid = blockIdx.x;
  const int chunk = (int)(bid % p.chunks);
  bid /= p.chunks;
  const int ct = (int)(bid % p.col_tiles);
  bid /= p.col_tiles;
  const int split = (int)(bid % p.splits);
  const long long z = bid / p.splits;

  const int t0 = chunk * p.t_blk;
  const int nt = p.T - t0 < p.t_blk ? p.T - t0 : p.t_blk;
  const int rows = nt * D, mt_valid = (rows + 15) / 16;
  const int s0 = ct * G::BN, ncols = p.S - s0 < G::BN ? p.S - s0 : G::BN;
  const uint32_t* Bz = p.B + z * (int64_t)p.R * p.S * D;
  const uint32_t* Az = p.A + (z * (int64_t)p.T + t0) * p.R * D;
  const int st_b = (int)((long long)split * p.n_st / p.splits);
  const int st_e = (int)((long long)(split + 1) * p.n_st / p.splits);

  uint32_t acc[RC][NN][4][4];
#pragma unroll
  for (int a = 0; a < RC; ++a)
#pragma unroll
    for (int b = 0; b < NN; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int d = 0; d < 4; ++d) acc[a][b][c][d] = 0u;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (st_b + s < st_e) {
      uint32_t* st = smem + s * stage_words;
      load_stage<D, RC, NN, WM, WN>(p, st, st + kBK * G::RSB, Bz, Az, (st_b + s) * kBK, s0,
                                    ncols, nt, tid);
    }
    cp_commit();
  }
  for (int stage = st_b; stage < st_e; ++stage) {
    const int it = stage - st_b;
    uint32_t* cur = smem + (it % kStages) * stage_words;
    cp_wait<kStages - 2>();
    __syncthreads();  // the stage has landed; every warp is done with the last one
    const int next = stage + kStages - 1;
    if (next < st_e) {
      uint32_t* st = smem + ((it + kStages - 1) % kStages) * stage_words;
      load_stage<D, RC, NN, WM, WN>(p, st, st + kBK * G::RSB, Bz, Az, next * kBK, s0, ncols,
                                    nt, tid);
    }
    cp_commit();
    lift_stage<D, G::NT>(p, cur + kBK * G::RSB, af, nt, tid);
    __syncthreads();
    mma_stage<D, RC, NN, WM, WN>(p, cur, af, wm, wn, mt_valid, lane, acc);
  }
  cp_wait<0>();

  // sum the limb shifts, mask (or add into C), C[t0 + rho / D, s0 + col, rho % D]
  const int g = lane >> 2, i = lane & 3;
  uint32_t* Cz = p.C + (z * (int64_t)p.T + t0) * p.S * D;
#pragma unroll
  for (int mi = 0; mi < RC; ++mi)
#pragma unroll
    for (int j = 0; j < NN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rho = (wm * RC + mi) * 16 + g + 8 * (e >> 1);
        const int col = (wn * NN + j) * 8 + 2 * i + (e & 1);
        if (rho >= rows || col >= ncols) continue;
        const uint32_t v = acc[mi][j][0][e] + (acc[mi][j][1][e] << 8) +
                           (acc[mi][j][2][e] << 16) + (acc[mi][j][3][e] << 24);
        uint32_t* dst = Cz + ((int64_t)(rho / D) * p.S + s0 + col) * D + rho % D;
        if (p.splits == 1)
          *dst = v & p.mask;
        else
          atomicAdd(dst, v);
      }
  if (p.splits > 1 && p.done != nullptr) {
    // the last split of this tile to finish masks it once
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const long long tile = (z * p.col_tiles + ct) * p.chunks + chunk;
      s_last = atomicAdd(p.done + tile, 1u) == (unsigned)(p.splits - 1);
    }
    __syncthreads();
    if (s_last) {
      __threadfence();
      const int run = ncols * D;
      for (int idx = tid; idx < nt * run; idx += G::NT) {
        const int tt = idx / run, w = idx - tt * run;
        uint32_t* dst = Cz + ((int64_t)tt * p.S + s0) * D + w;
        __stcg(dst, __ldcg(dst) & p.mask);
      }
    }
  }
}

// (D, rc, nn, wm, wn) instantiations; the Python mirror is
// repro_torch.kernels.gr_matmul.SIMT_THIN_CONFIGS
#define THIN_CONFIGS(X)                                                           \
  X(1, 1, 4, 1, 4) X(1, 2, 2, 1, 4) X(1, 2, 1, 2, 4) X(2, 1, 2, 1, 4)             \
  X(2, 2, 2, 1, 4) X(2, 2, 1, 2, 4) X(3, 1, 1, 1, 4) X(3, 2, 1, 1, 4)             \
  X(3, 2, 1, 2, 4) X(4, 1, 1, 1, 4) X(4, 2, 1, 1, 4) X(4, 2, 1, 2, 4)

template <int D, int RC, int NN, int WM, int WN>
int launch_thin(const Args& a, const Plan& p, cudaStream_t stream) {
  // once per device (the attributes persist): launches may be captured in
  // a CUDA graph
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(simt_thin_kernel<D, RC, NN, WM, WN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(simt_thin_kernel<D, RC, NN, WM, WN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  simt_thin_kernel<D, RC, NN, WM, WN>
      <<<(unsigned)p.blocks, Shape<D, RC, NN, WM, WN>::NT, p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

constexpr int thin_key(int d, int rc, int nn, int wm, int wn) {
  return (((d * 8 + rc) * 8 + nn) * 8 + wm) * 8 + wn;
}

}  // namespace thin

// the thin kernel takes single-level rings with D <= 4 up to 64 rows
inline bool thin_applies(int d0, int d1, int T) {
  return d1 == 1 && d0 <= thin::kMaxD && T <= thin::kMaxT;
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

// A (batch, T, R, D), B (batch, R, S, D) -> C (batch, T, S, D), uint32
// words, contiguous.  fold_host: (K, D) uint32 row-major; L = ceil(e / 8);
// sms: the card's SM count; splits: the thin kernel's R splits (>= 1, at
// most its stages and 8; gr_matmul_simt_grid's choice), each added into C,
// which must then be zero, as `done` must be (a counter per tile of the
// grid, e < 32 only; else null).  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a tower
// shape that has no instantiation.
int gr_matmul_simt_u32(const void* A, const void* B, void* C, void* done, int batch,
                       int T, int R, int S, int d0, int d1, const uint32_t* fold_host,
                       uint32_t mask, int L, int sms, int splits, void* stream) {
  const uint32_t* a = static_cast<const uint32_t*>(A);
  const uint32_t* b = static_cast<const uint32_t*>(B);
  uint32_t* c = static_cast<uint32_t*>(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (thin_applies(d0, d1, T)) {
    const int D = d0;
    if (splits < 1 || L < 1 || L > 4) return (int)cudaErrorInvalidValue;
    const thin::Plan p = thin::make_plan(D, batch, T, R, S, sms, splits);
    if (p.blocks > 0x7fffffffLL || (p.splits > 1 && mask != 0xFFFFFFFFu && done == nullptr))
      return (int)cudaErrorInvalidValue;
    thin::Args args;
    args.A = a, args.B = b, args.C = c, args.done = static_cast<unsigned*>(done);
    args.T = T, args.R = R, args.S = S, args.t_blk = p.t_blk;
    args.chunks = p.chunks, args.col_tiles = p.col_tiles, args.splits = p.splits;
    args.n_st = p.n_st, args.L = L, args.mask = mask;
    args.vec_a = ((long long)R * D) % 4 == 0 && (uintptr_t)A % 16 == 0;
    args.vec_b = ((long long)S * D) % 4 == 0 && (uintptr_t)B % 16 == 0;
    for (int m = 0; m < thin::kMaxD; ++m) args.xd[m] = (D > 1 && m < D) ? fold_host[D * D + m] : 0u;
    switch (thin::thin_key(D, p.rc, p.nn, p.wm, p.wn)) {
#define THIN_LAUNCH(x, y, z, w, v)    \
  case thin::thin_key(x, y, z, w, v): \
    return thin::launch_thin<x, y, z, w, v>(args, p, st);
      THIN_CONFIGS(THIN_LAUNCH)
#undef THIN_LAUNCH
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
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

// The tile a call with T rows of the tower (d0, d1) runs: the thin
// kernel's (t a block, bn, 32), or the tile kernel's (BM, BN, BK); -1 if
// the tower has no instantiation.
int gr_matmul_tile(int d0, int d1, int T, int* bm, int* bn, int* bk) {
  if (thin_applies(d0, d1, T)) {
    const thin::Plan p = thin::make_plan(d0, 1, T, 1, 1, 1, 1);
    *bm = p.t_blk;
    *bn = p.bn;
    *bk = thin::kBK;
    return 0;
  }
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

// The grid of a call on a card of `sms` SMs, as (thin, blocks, t chunks,
// s tiles, splits, rc, nn, wm, wn, dynamic shared memory) into out[0..9];
// the tile kernel's: (0, blocks, t tiles, s tiles, 1, 0, 0, 0, 0, 0).
// Returns -1 for a tower shape without an instantiation.
int gr_matmul_simt_grid(int d0, int d1, int batch, int T, int R, int S, int sms,
                        long long* out) {
  if (thin_applies(d0, d1, T)) {
    const thin::Plan p = thin::make_plan(d0, batch, T, R, S, sms, 0);
    const long long v[10] = {1, p.blocks, p.chunks, p.col_tiles, p.splits,
                             p.rc, p.nn, p.wm, p.wn, p.smem};
    memcpy(out, v, sizeof(v));
    return 0;
  }
  int bm = 0, bn = 0, bk = 0;
  if (gr_matmul_tile(d0, d1, T, &bm, &bn, &bk) != 0) return -1;
  const long long rows = (T + bm - 1) / bm, cols = (S + bn - 1) / bn;
  const long long v[10] = {0, rows * cols * batch, rows, cols, 1, 0, 0, 0, 0, 0};
  memcpy(out, v, sizeof(v));
  return 0;
}

}  // extern "C"
