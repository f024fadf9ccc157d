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
// and each A_a @ B_b is a u8 x u8 -> s32 tensor-core product.  Every
// product of conv plane c and shift s = a + b goes into one int32
// accumulator (c, s); the end combines conv[c] = sum_s acc(c, s) << 8s and
// folds.  The accumulators wrap mod 2^32 (integer wgmma without .satfinite;
// chip_smoke.py phase 2 holds a chain past 2^31 and past 2^32 against the
// plain version), and a shift-add is exact mod 2^32, so no flush is needed
// at any R.  (Within R <= 2048, which every main-path call keeps, no chain
// reaches 2^31 at all: D * L <= 16 byte products per element of R.)
//
// What bounds it: operations.  At the worker shape (8 x 1024x2048 @
// 2048x1024 over GR(2^32, 3)) it needs 8 * 9 * 10 byte products of 1024 x
// 2048 x 1024, 1.56 ms at the 1,979 TOP/s int8 peak.  Three things stand
// between a kernel and that rate on Hopper: only wgmma reaches the full
// tensor-core rate (mma.sync runs at a fraction of it); the K * L
// accumulators per output (20 at D = 3, 28 at D = 4) fill the register
// file long before a tile reaches the sizes GEMMs use, so every operand
// byte feeds few MACs; and at those small tiles the shared memory and L2
// must deliver operands at close to their peak rates.
//
// Design:
//  * A limb pre-pass (gr_matmul_tc_limbs) reads the interleaved int32
//    operands once and writes u8 limb planes, K-major for both operands as
//    the 8-bit MMAs need them: A as (batch, D, L, Tp, Rp) and B, transposed
//    through shared memory, as (batch, D, L, Sp, Rp).  It zero-pads T and S
//    to 32 and R to KS.  It writes as many bytes as it reads.
//  * The main kernel is warp-specialised: 3 warpgroups a block, one block
//    an SM.  Warpgroup 2 is the producer: it drops to 40 registers
//    (setmaxnreg) and one of its threads issues, for each KS-deep step of
//    R, two TMA loads (cp.async.bulk.tensor.3d) into a ring of ST stages:
//    a box of KS x 64 rows x all D * L limb planes of A and one of KS x BN
//    rows x all planes of B, 64-byte swizzled, completed on the stage's
//    full mbarrier.  The tensor maps are encoded on the host at every call
//    (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//    the library needs no -lcuda) and passed as __grid_constant__
//    parameters, so a launch captures in a CUDA graph.  TMA zero-fills
//    rows past the planes' ends, so T and S need no padding to the tile.
//  * Warpgroups 0 and 1 are consumers (setmaxnreg up to 232).  Both work on
//    the same 64 x BN output tile, and each owns half of its (c, s)
//    accumulators, the halves balanced by MMA count (Plan below).  For
//    every 32-deep step a consumer loads each A plane it needs into
//    registers once (ldmatrix from the swizzled stage) and issues
//    wgmma.mma_async.m64nBNk32.s32.u8.u8 with A from registers and B from
//    shared memory (a descriptor per B plane) for every (i, j, a, b) with
//    a + b < L whose accumulator it owns.  A is register-sourced because
//    at these N an A read by every wgmma from shared memory would need more
//    than the SM's 128 B a clock.  A planes alternate between two register
//    buffers: each plane's wgmmas form one commit group, and waiting for at
//    most one group in flight frees the buffer the next plane loads into.
//    At the end of a stage a consumer waits for its wgmmas and releases the
//    stage (empty mbarrier, one arrival a warp).
//  * Tile sizes follow the register file: a thread holds NP * BN / 2
//    accumulator registers (NP = ceil(K * L / 2)), so BN = 128 at D = 1,
//    64 or 48 at D = 2, 32 at D = 3 and 24 or 16 at D = 4.  A 64 x 32 tile
//    gives a third more MACs per operand byte than the 32 x 32 block tile
//    the earlier mma.sync kernel used; a cluster of 2 along S multicasting
//    A's box would raise it further (not tried).
//  * The epilogue: each consumer folds its accumulators into partial
//    results, sum over its (c, s) of FOLD[c, d] * (acc << 8s) (all mod
//    2^32), trades half of them with the other consumer through shared
//    memory (the stages' space, free by then), adds, masks to e bits and
//    writes C in the interleaved (batch, T, S, D) layout directly.
//  * Template parameters: the tower (D0, D1 = 1), BN, the stage count ST
//    and L, so every conv position, accumulator slot and plane offset is a
//    compile-time constant (static_for unrolls over them).  TC_CONFIGS
//    lists the (BN, ST) instantiations, the default of each tower first;
//    each is built for L = 1..4.  The autotuner (repro_torch.kernels.
//    autotune) times them and picks per shape.
//  * The box is 64 bytes deep, not 128: a 128-byte box of every limb plane
//    of both operands would hold 147 KB a stage at D = 3, L = 4 (one stage
//    in all); at 64 the ring holds 2-4 stages.
//  * The towers of TC_LIFT_TOWERS (D0, D1) run as products over their
//    inner ring GR(2^e, D0): A is read as it lies, at D1 times its depth,
//    by the limb pre-pass of the inner ring, and B goes through a lift
//    pre-pass (gr_matmul_tc_lift, below) that writes the limb planes of its
//    outer-level lift M(B) directly; the main kernel runs the inner ring's
//    instantiation (T, D1 S, D1 R) with the inner FOLD, and its (T, D1 S,
//    D0) output is C.  The (3, 7) tower's K = 65 accumulators a output (260
//    with limbs) never meet the register file: the inner ring's 5 x 4 do.
//    A single-level GR(2^e, D) with 5 <= D <= 16 is the tower (1, D) over
//    Z_2^e (FOLD = kron(FOLD, [[1]]), so RED is its FOLD): A (T, R, D) is
//    A' (T, D R) over Z_2^e, M(B) is (D R, D S), and the main kernel runs its
//    D = 1 instantiation (BN = 128, K * L = 4 accumulators an output), with
//    the D^2 word products per (t, r, s) the conv scheme has.  Widening the
//    own instantiations to D = 5..8 instead would put 36-60 accumulators
//    on every output and BN below 16.
//  * What the lift costs in memory: M(B)'s limb planes are D1 times B's
//    size (L bytes for every 4-byte word of B, D1^2 / D1 times the words):
//    3.2 GB for 16 x (2048 x 512) over the (3, 4) tower and 4.8 GB for
//    64 x (2048 x 256) over GR(2^32, 6), the two largest worker products
//    chip_smoke.py drives, beside A's planes (1.6 and 1.6 GB).  Both fit
//    the card: the whole round of those paths (batch_ep_rmfe at 2048^3, n
//    = 4 on 16 workers and n = 2 on 64) peaks at 7.78 and 9.13 GB of
//    torch.cuda.max_memory_allocated, operands and shares included (an
//    H100 80GB HBM3 at 700 W).
//
//  * The tc_left route (gr_matmul_tc_left.cu: its pre-passes and main
//    kernel) takes a lifted ring's calls whose left operand is small.  The
//    shared device and host helpers are in gr_matmul_tc_common.cuh.
//
// Measured (chip_smoke.py, an H100 80GB HBM3 at 700 W): at the worker
// shape the pre-pass and this kernel take 2.42 ms, 65% of the int8 bound
// (the mma.sync kernel it replaces took 7.27 ms); lifted, 37.7 ms over the
// (3, 4) tower (66%), 15.1 and 2.43 ms over GR(2^32, 6) and GR(2^32, 5) as
// (1, D) (41 and 45%: the D = 1 tile does 107 byte products per byte it
// loads and waits on L2); every instantiation enters with 168 registers
// and spills nothing; the accumulators wrap.
//
// C interface (loaded with ctypes); the functions return cudaGetLastError().
#include "gr_matmul_tc_common.cuh"

namespace {

constexpr int kMaxD = 4;         // inner degree of the wgmma kernels
constexpr int kMaxK = 7;

struct FoldTable {
  uint32_t f[kMaxK * kMaxD];
};

// The accumulators of a single-level tower of degree D with L limbs: pair
// q = c * L + s for conv plane c < K = 2D - 1 and shift s < L, fed by
// count(c) * (s + 1) MMAs a 32-deep step.  Greedily, heaviest first, each
// pair goes to the consumer with fewer MMAs that still has room; a
// consumer holds at most NP = ceil(K * L / 2) pairs.  Evaluated once, at
// compile time (kT).
template <int D, int L>
struct Plan {
  static constexpr int K = 2 * D - 1;
  static constexpr int NQ = K * L;
  static constexpr int NP = (NQ + 1) / 2;
  static constexpr int P = D * L;  // A planes, p = i * L + a
  struct Table {
    int owner[NQ];      // consumer of pair q
    int slot[NQ];       // its accumulator index there
    int pairs[2];       // pairs a consumer owns
    bool needs[2][P];   // does consumer w multiply by A plane p?
    int rank[2][P];     // A planes consumer w needs before plane p
    int planes[2];      // A planes consumer w needs
  };
  __host__ __device__ static constexpr int count(int c) {
    return (c < D ? c : 2 * D - 2 - c) + 1;
  }
  __host__ __device__ static constexpr int mmas(int q) { return count(q / L) * (q % L + 1); }
  __host__ __device__ static constexpr Table build() {
    Table t{};
    bool done[NQ] = {};
    int load[2] = {0, 0};
    for (int n = 0; n < NQ; ++n) {
      int best = -1;
      for (int q = 0; q < NQ; ++q)
        if (!done[q] && (best < 0 || mmas(q) > mmas(best))) best = q;
      const int w = t.pairs[0] < NP && (t.pairs[1] >= NP || load[0] <= load[1]) ? 0 : 1;
      done[best] = true;
      t.owner[best] = w;
      t.slot[best] = t.pairs[w]++;
      load[w] += mmas(best);
    }
    for (int w = 0; w < 2; ++w) {
      for (int p = 0; p < P; ++p) {
        t.rank[w][p] = t.planes[w];
        for (int j = 0; j < D; ++j)
          for (int b = 0; p % L + b < L; ++b)
            if (t.owner[(p / L + j) * L + p % L + b] == w) t.needs[w][p] = true;
        t.planes[w] += t.needs[w][p];
      }
    }
    return t;
  }
  static constexpr Table kT = build();
};

// Plan<D, L>'s entries as scalar constants: device code may use a scalar
// static constexpr member, not the table itself
template <int D, int L, int Q>
struct PairAt {  // accumulator pair q
  static constexpr int owner = Plan<D, L>::kT.owner[Q];
  static constexpr int slot = Plan<D, L>::kT.slot[Q];
};

template <int D, int L, int W, int Pl>
struct PlaneAt {  // A plane p for consumer W
  static constexpr bool needs = Plan<D, L>::kT.needs[W][Pl];
  static constexpr int rank = Plan<D, L>::kT.rank[W][Pl];
};

template <int D, int L, int W>
struct ConsumerAt {
  static constexpr int pairs = Plan<D, L>::kT.pairs[W];
  static constexpr int planes = Plan<D, L>::kT.planes[W];
};

constexpr int KS = 64;           // bytes of R per pipeline stage: one 64-byte swizzle row
constexpr int kBM = 64;          // rows of the block tile: one wgmma M
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 * 40 + 256 * 232 = 384 * 168
constexpr int kAlign = 1024;     // slack to align the stages in dynamic shared memory

// one instantiation: tower (D0, D1), block tile 64 x BN, ST stages, L limbs
template <int D0, int D1, int BN, int ST, int L>
struct Tc {
  static constexpr int D = D0 * D1;
  static constexpr int P = D * L;  // limb planes an operand
  static constexpr int kABytes = P * kBM * KS;
  static constexpr int kTx = P * (kBM + BN) * KS;  // bytes a stage's two loads bring
  static constexpr int kStage = (kTx + 1023) / 1024 * 1024;
  // the epilogue's trade: 2 consumers x D x BN / 4 words x 128 threads
  static constexpr int kXch = D * BN * 256;
  static constexpr int kRing = ST * kStage > kXch ? ST * kStage : kXch;
  static constexpr int kSmem = kAlign + kRing + 16 * ST;  // + full and empty mbarriers
  static_assert(D1 == 1, "the accumulator plan assumes a single-level tower");
  static_assert(ST >= 2, "the ring refills a stage while the other is read");
  static_assert(BN % 16 == 0 || BN == 24, "wgmma u8 takes N = 16, 24, 32, 48, 64, ...");
};

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
// lift pre-pass: the B operand of a two-level tower
// ---------------------------------------------------------------------------
//
// GR(2^e, (D0, D1)) keeps an element as D1 outer coefficients, each an
// element of the inner ring GR(2^e, D0) (flat index = outer * D0 + inner),
// and FOLD = kron(RED, FOLD0): RED (2 D1 - 1, D1) reduces the powers of the
// outer variable over Z_q, FOLD0 is the inner ring's fold.  So a tower
// product is an inner-ring product of lifted operands:
//
//   A (T, R, D0 D1), read as it lies, is A' (T, D1 R, D0);
//   M(B)[(r, i), (s, m)] = sum_j RED[i + j, m] * B[r, s, j]   (D1 R x D1 S)
//   C' = A' (x)_D0 M(B) (T, D1 S, D0) is C (T, S, D0 D1) as it lies,
//
// with D0^2 D1^2 word products per (t, r, s), as the tower product has.
// The main kernel runs C' at the inner ring's instantiation and FOLD0.
//
// This pass reads B (batch, R, S, D0 D1) once and writes the limb planes
// of M(B) straight in the layout the main kernel reads for B: (batch, D0,
// L, Sp, Rp) u8, K-major, zero-padded to Sp >= D1 S and Rp >= D1 R.  The
// RED combination runs in uint32 (wrapping) before the bytes are split, so
// the int32 M(B), D1 times B's size, never goes to device memory.
//
// A block is (batch entry, s, 128 rows of r), one warp per outer index m:
// lane g owns rows r = 4g .. 4g + 3, i.e. 4 D1 consecutive bytes of every
// output row (s' = D1 s + m, r'), which it computes from its 4 D1 words
// of B and the column RED[., m] (registers, indices fixed at compile
// time), then stages through shared memory so that the warp writes D1
// runs of 128 contiguous bytes per (inner coefficient d, limb l).
constexpr int kMaxD1 = 16;       // a single-level GR(2^e, 16) as the tower (1, 16)
constexpr int kLiftRows = 128;  // rows of r a block: 32 lanes x 4

struct RedTable {
  uint32_t f[(2 * kMaxD1 - 1) * kMaxD1];  // row-major (2 D1 - 1, D1)
};

template <int D0, int D1>
__global__ void __launch_bounds__(32 * D1)
    lift_cols_kernel(const uint32_t* __restrict__ X, uint32_t* __restrict__ Y, int R, int S,
                     int L, int Rp, int Sp, const __grid_constant__ RedTable red) {
  constexpr int D = D0 * D1;
  constexpr int DX = D | 1;  // odd stride: the 32 lanes' rows fall in distinct banks
  __shared__ uint32_t tile[kLiftRows * DX];    // row 4g + rr at (rr * 32 + g) * DX
  __shared__ uint32_t stage[D1][32 * D1];      // a warp's output words of one (d, l)
  const int64_t z = blockIdx.z;
  const int s = blockIdx.x, r0 = blockIdx.y * kLiftRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t* Xb = X + z * R * (int64_t)S * D;
  for (int idx = threadIdx.x; idx < kLiftRows * D; idx += 32 * D1) {
    const int rl = idx / D, w = idx - rl * D, r = r0 + rl;
    tile[((rl & 3) * 32 + (rl >> 2)) * DX + w] =
        (r < R && s < S) ? Xb[((int64_t)r * S + s) * D + w] : 0u;
  }
  __syncthreads();
  const int m = warp;
  uint32_t rm[2 * D1 - 1];  // RED[., m]: a warp-uniform read of the parameter bank
#pragma unroll
  for (int k = 0; k < 2 * D1 - 1; ++k) rm[k] = red.f[k * D1 + m];
  const int row = D1 * s + m;  // s' of this warp's output rows
  const int words = Rp / 4, w0 = blockIdx.y * (kLiftRows * D1 / 4);
  uint32_t* out = stage[warp];
  for (int d = 0; d < D0; ++d) {
    uint32_t v[4 * D1];  // byte p = 4 D1-run position rr * D1 + i
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      uint32_t x[D1];
#pragma unroll
      for (int j = 0; j < D1; ++j) x[j] = tile[(rr * 32 + lane) * DX + j * D0 + d];
#pragma unroll
      for (int i = 0; i < D1; ++i) {
        uint32_t acc = 0u;
#pragma unroll
        for (int j = 0; j < D1; ++j) acc += rm[i + j] * x[j];
        v[rr * D1 + i] = acc;
      }
    }
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int u = 0; u < D1; ++u) {
        uint32_t packed = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) packed |= ((v[4 * u + k] >> (8 * l)) & 0xFFu) << (8 * k);
        out[lane * D1 + u] = packed;
      }
      __syncwarp();
      uint32_t* Yrow = Y + (((z * D0 + d) * L + l) * (int64_t)Sp + row) * words;
#pragma unroll
      for (int u = 0; u < D1; ++u) {
        const int q = u * 32 + lane, w = w0 + q;
        if (row < Sp && w < words) Yrow[w] = out[q];
      }
      __syncwarp();
    }
  }
}

template <int D0, int D1>
int launch_lift(const uint32_t* X, uint32_t* Y, int batch, int R, int S, int L, int Rp, int Sp,
                const RedTable& red, cudaStream_t st) {
  // every s' < Sp and every word of Rp: blocks past S and R write zeros
  const int rows = (Rp + D1 - 1) / D1;
  dim3 grid((Sp + D1 - 1) / D1, (rows + kLiftRows - 1) / kLiftRows, batch);
  lift_cols_kernel<D0, D1><<<grid, 32 * D1, 0, st>>>(X, Y, R, S, L, Rp, Sp, red);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// main kernel
// ---------------------------------------------------------------------------

// Consumer warpgroup W: the 32-deep steps of every stage, then its half of
// the epilogue.  `smem` is the 1024-aligned ring, `full`/`empty` the
// stages' mbarriers (8 bytes apart).
template <int D0, int D1, int BN, int ST, int L, int W>
__device__ __forceinline__ void consume(uint8_t* smem, uint32_t full, uint32_t empty,
                                        int ktiles, uint32_t* __restrict__ C, int T, int S,
                                        int64_t z, int m0, int n0, const FoldTable& fold,
                                        uint32_t mask) {
  using G = Tc<D0, D1, BN, ST, L>;
  constexpr int D = G::D, P = G::P, E = BN / 2, EH = E / 2;
  using Me = ConsumerAt<D, L, W>;
  constexpr int NPW = Me::pairs > 0 ? Me::pairs : 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;

  uint32_t acc[NPW][E];
#pragma unroll
  for (int n = 0; n < NPW; ++n)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[n][e] = 0u;

  // ldmatrix.x4 rows of this lane: its warp's 16 rows, two 16-byte chunks
  // of each 32-deep step (the m16n8k32 A fragment, which wgmma's register
  // A operand repeats per warp); the 64-byte swizzle XORs the chunk with
  // bits 1-2 of the row
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_chunk = lane >> 4, a_swz = (a_row >> 1) & 3;
  const uint32_t ring = smem_addr(smem);
  uint32_t abuf[2][4];
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t sA = ring + stage * G::kStage;
    const uint32_t sB = sA + G::kABytes;
    static_for<0, KS / 32>([&](auto KK) {
      constexpr int kk = decltype(KK)::value;
      const uint32_t a_lane = sA + a_row * KS + (((2 * kk + a_chunk) ^ a_swz) << 4);
      static_for<0, P>([&](auto PI) {
        constexpr int p = decltype(PI)::value, i = p / L, a = p % L;
        using Plane = PlaneAt<D, L, W, p>;
        [[maybe_unused]] constexpr int buf = (kk * Me::planes + Plane::rank) & 1;
        if constexpr (Plane::needs) {
          ldmatrix_x4(abuf[buf], a_lane + p * kBM * KS);
          wgmma_fence();
          static_for<0, D * L>([&](auto JB) {
            constexpr int j = decltype(JB)::value / L, b = decltype(JB)::value % L;
            if constexpr (a + b < L) {
              constexpr int q = (i + j) * L + a + b;
              using Pair = PairAt<D, L, q>;
              if constexpr (Pair::owner == W)
                Wgmma<BN>::mma(acc[Pair::slot], abuf[buf],
                               sw64_desc(sB + (j * L + b) * BN * KS + kk * 32));
            }
          });
          wgmma_commit();
          wgmma_wait<1>();
        }
      });
    });
    wgmma_wait<0>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    if (++stage == ST) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();

  // epilogue: partial(e, d) = sum over this consumer's (c, s) of
  // FOLD[c, d] * (acc << 8s), mod 2^32.  Consumer W finishes the outputs of
  // fragment entries e in [W * EH, (W + 1) * EH) and hands the other half
  // of its partials to the other consumer through shared memory, laid out
  // (consumer, d, e - half, thread) so that a warp's stores and loads are
  // conflict-free.
  named_barrier_sync(1, 128 * kConsumers);  // both consumers are done with the ring
  uint32_t* xch = reinterpret_cast<uint32_t*>(smem);
  uint32_t mine[EH][D];
  static_for<0, E>([&](auto EI) {
    constexpr int e = decltype(EI)::value;
    uint32_t v[D];
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = 0u;
    static_for<0, Plan<D, L>::NQ>([&](auto QI) {
      constexpr int q = decltype(QI)::value, c = q / L, s = q % L;
      using Pair = PairAt<D, L, q>;
      if constexpr (Pair::owner == W) {
        const uint32_t x = acc[Pair::slot][e] << (8 * s);
#pragma unroll
        for (int d = 0; d < D; ++d) v[d] += fold.f[c * D + d] * x;
      }
    });
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if constexpr (e / EH == W)
        mine[e % EH][d] = v[d];
      else
        xch[((W * D + d) * EH + e % EH) * 128 + tid] = v[d];
    }
  });
  named_barrier_sync(1, 128 * kConsumers);
  // the s32 accumulator fragment: entry e of a thread is row g (+ 8 for
  // e % 4 >= 2) of its warp's 16, column 8 * (e / 4) + 2 * (lane % 4) + e % 2
  const int g = lane >> 2, qd = lane & 3;
  uint32_t* Cb = C + z * T * (int64_t)S * D;
#pragma unroll
  for (int el = 0; el < EH; ++el) {
    const int e = W * EH + el;
    const int row = m0 + warp * 16 + g + ((e >> 1) & 1) * 8;
    const int col = n0 + 8 * (e >> 2) + 2 * qd + (e & 1);
    if (row < T && col < S) {
      uint32_t* dst = Cb + ((int64_t)row * S + col) * D;
#pragma unroll
      for (int d = 0; d < D; ++d)
        dst[d] = (mine[el][d] + xch[(((1 - W) * D + d) * EH + el) * 128 + tid]) & mask;
    }
  }
}

template <int D0, int D1, int BN, int ST, int L>
__global__ void __launch_bounds__(kThreads, 1)
    gr_matmul_tc_kernel(const __grid_constant__ CUtensorMap mapA,
                        const __grid_constant__ CUtensorMap mapB, uint32_t* __restrict__ C,
                        int T, int S, int Rp, const FoldTable fold, uint32_t mask) {
  using G = Tc<D0, D1, BN, ST, L>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  const uint32_t full = smem_addr(smem + G::kRing), empty = full + 8 * ST;
  const int64_t z = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int ktiles = Rp / KS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty + 8 * s, 4 * kConsumers);    // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t bar = full + 8 * stage;
        const uint32_t sA = smem_addr(smem) + stage * G::kStage;
        mbar_expect_tx(bar, G::kTx);
        tma_load_3d(sA, &mapA, bar, kt * KS, m0, (int)z * G::P);
        tma_load_3d(sA + G::kABytes, &mapB, bar, kt * KS, n0, (int)z * G::P);
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if (wg == 0)
      consume<D0, D1, BN, ST, L, 0>(smem, full, empty, ktiles, C, T, S, z, m0, n0, fold, mask);
    else
      consume<D0, D1, BN, ST, L, 1>(smem, full, empty, ktiles, C, T, S, z, m0, n0, fold, mask);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D0, int D1, int BN, int ST, int L>
int launch(const uint8_t* A8, const uint8_t* B8, uint32_t* C, int batch, int T, int S, int Tp,
           int Sp, int Rp, const FoldTable& fold, uint32_t mask, cudaStream_t stream) {
  using G = Tc<D0, D1, BN, ST, L>;
  if (G::kSmem > kSmemMax || (T + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  // raise the kernel's shared-memory limit once per device (the attribute
  // persists), not on every launch: launches may be captured in a CUDA graph
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(gr_matmul_tc_kernel<D0, D1, BN, ST, L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = 1;
  }
  CUtensorMap mapA, mapB;
  int err = encode_planes(&mapA, A8, batch * G::P, Tp, Rp, kBM, G::P, KS, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0)
    err = encode_planes(&mapB, B8, batch * G::P, Sp, Rp, BN, G::P, KS, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != 0) return err;
  dim3 grid((S + BN - 1) / BN, (T + kBM - 1) / kBM, batch);
  gr_matmul_tc_kernel<D0, D1, BN, ST, L><<<grid, kThreads, G::kSmem, stream>>>(
      mapA, mapB, C, T, S, Rp, fold, mask);
  return (int)cudaGetLastError();
}

template <int D0, int D1, int BN, int ST>
int launch_l(const uint8_t* A8, const uint8_t* B8, uint32_t* C, int batch, int T, int S, int Tp,
             int Sp, int Rp, int L, const FoldTable& fold, uint32_t mask, cudaStream_t st) {
  switch (L) {
#define TC_LAUNCH_L(l) \
  case l:              \
    return launch<D0, D1, BN, ST, l>(A8, B8, C, batch, T, S, Tp, Sp, Rp, fold, mask, st);
    TC_LAUNCH_L(1) TC_LAUNCH_L(2) TC_LAUNCH_L(3) TC_LAUNCH_L(4)
#undef TC_LAUNCH_L
    default: return (int)cudaErrorInvalidValue;
  }
}

constexpr int tc_key(int d0, int d1, int bn, int st) {
  return ((d0 * 32 + d1) * 256 + bn) * 8 + st;
}

}  // namespace

// (d0, d1, BN, ST) instantiations: single-level towers with D <= 4, each
// tower's default (the autotuner's fallback) first; each is built for
// L = 1..4.  The Python mirror is repro_torch.kernels.gr_matmul.TC_CONFIGS.
#define TC_CONFIGS(X)                                        \
  X(1, 1, 128, 4) X(1, 1, 64, 4)                             \
  X(2, 1, 64, 3) X(2, 1, 48, 3) X(2, 1, 32, 4)               \
  X(3, 1, 32, 3) X(3, 1, 32, 2) X(3, 1, 24, 3)               \
  X(4, 1, 24, 2) X(4, 1, 16, 2)

// Towers (d0, d1) with a lift pre-pass: each runs the main kernel at the
// instantiations of its inner ring (d0, 1).  A single-level GR(2^e, D) with
// D > kMaxD is the tower (1, D) over Z_2^e; the two-level towers are those
// with an inner degree <= kMaxD.  The Python mirror is
// repro_torch.kernels.gr_matmul.TC_LIFT_TOWERS.
#define TC_LIFT_TOWERS(X)                                                 \
  X(1, 5) X(1, 6) X(1, 7) X(1, 8) X(1, 9) X(1, 10) X(1, 11) X(1, 12)      \
  X(1, 13) X(1, 14) X(1, 15) X(1, 16)                                     \
  X(2, 3) X(2, 5) X(2, 7) X(3, 2) X(3, 4) X(3, 5) X(3, 7) X(4, 3)

namespace {

// The tower the tc route runs (d0, d1) as: a single-level ring past the
// kernel's own instantiations as (1, D), every other as it is.
void view(int& d0, int& d1) {
  if (d1 == 1 && d0 > kMaxD) {
    d1 = d0;
    d0 = 1;
  }
}

bool lifted(int d0, int d1) {
#define TC_LIFTED(x, y) \
  if (x == d0 && y == d1) return true;
  TC_LIFT_TOWERS(TC_LIFTED)
#undef TC_LIFTED
  return false;
}

}  // namespace

extern "C" {

// Limb pre-pass: X (batch, rows, cols, D) uint32 -> Y uint8 limb planes,
// (batch, D, L, rows_p, cols_p), or (batch, D, L, cols_p, rows_p) with
// transpose, zero-padded.  rows_p, cols_p must be multiples of 32 (the
// K-major one of KS).
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

// Lift pre-pass of a lifted tower (d0, d1) of TC_LIFT_TOWERS (a single-level
// GR(2^e, D) as (1, D)): B (batch, R, S, d0 d1) uint32 -> the limb planes of
// M(B), (batch, d0, L, Sp, Rp) u8, K-major and zero-padded; red_host:
// (2 d1 - 1, d1) uint32 row-major (a single-level ring's FOLD).  Rp must be
// a multiple of KS and at least d1 R, Sp a multiple of 32 and at least d1 S.
int gr_matmul_tc_lift(const void* B, void* Y, int batch, int R, int S, int d0, int d1, int L,
                      int Rp, int Sp, const uint32_t* red_host, void* stream) {
  if (d1 < 2 || d1 > kMaxD1 || L < 1 || L > kMaxL || Rp % KS || Sp % 32 || Rp < d1 * R ||
      Sp < d1 * S)
    return (int)cudaErrorInvalidValue;
  RedTable red;
  memset(&red, 0, sizeof(red));
  memcpy(red.f, red_host, sizeof(uint32_t) * (2 * d1 - 1) * d1);
  const uint32_t* x = static_cast<const uint32_t*>(B);
  uint32_t* y = static_cast<uint32_t*>(Y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d0 * 32 + d1) {
#define TC_LIFT_LAUNCH(a, b) \
  case a * 32 + b:           \
    return launch_lift<a, b>(x, y, batch, R, S, L, Rp, Sp, red, st);
    TC_LIFT_TOWERS(TC_LIFT_LAUNCH)
#undef TC_LIFT_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// A8 (batch, D, L, Tp, Rp), B8 (batch, D, L, Sp, Rp) u8 limb planes ->
// C (batch, T, S, D) uint32 with the (bn, stages) instantiation of the
// tower (d0, d1); cudaErrorInvalidValue if it has none, if Rp is not a
// multiple of KS, if its shared memory exceeds 227 KB at L, or if the grid
// would. fold_host: (K, D) uint32 row-major.
int gr_matmul_tc_u32(const void* A8, const void* B8, void* C, int batch, int T,
                     int S, int Tp, int Sp, int Rp, int L, int d0, int d1,
                     int bn, int stages, const uint32_t* fold_host,
                     uint32_t mask, void* stream) {
  const int D = d0 * d1, K = (2 * d0 - 1) * (2 * d1 - 1);
  if (D > kMaxD || K > kMaxK || L < 1 || L > kMaxL || Rp % KS || Tp < T || Sp < S)
    return (int)cudaErrorInvalidValue;
  FoldTable fold;
  memset(&fold, 0, sizeof(fold));
  memcpy(fold.f, fold_host, sizeof(uint32_t) * K * D);
  const uint8_t* a = static_cast<const uint8_t*>(A8);
  const uint8_t* b = static_cast<const uint8_t*>(B8);
  uint32_t* c = static_cast<uint32_t*>(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tc_key(d0, d1, bn, stages)) {
#define TC_LAUNCH(x, y, n, s)                                                          \
  case tc_key(x, y, n, s):                                                             \
    return launch_l<x, y, n, s>(a, b, c, batch, T, S, Tp, Sp, Rp, L, fold, mask, st);
    TC_CONFIGS(TC_LAUNCH)
#undef TC_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The instantiations of the tower (d0, d1), default first: writes up to
// `cap` (bn, stages) pairs to `out` and returns how many there are.  A
// lifted tower (a single-level ring with D > 4 among them) runs its inner
// ring's.
int gr_matmul_tc_configs(int d0, int d1, int* out, int cap) {
  view(d0, d1);
  if (lifted(d0, d1)) d1 = 1;
  int n = 0;
#define TC_CONFIG(x, y, n_, s)   \
  if (x == d0 && y == d1) {      \
    if (n < cap) {               \
      out[2 * n] = n_;           \
      out[2 * n + 1] = s;        \
    }                            \
    ++n;                         \
  }
  TC_CONFIGS(TC_CONFIG)
#undef TC_CONFIG
  return n;
}

// Dynamic shared memory a launch of the (bn, stages) instantiation of the
// tower (d0, d1) at L limbs asks for (a lifted tower: its inner ring's); -1
// without one.
int gr_matmul_tc_smem(int d0, int d1, int bn, int stages, int L) {
  view(d0, d1);
  if (lifted(d0, d1)) d1 = 1;
  switch (tc_key(d0, d1, bn, stages) * 8 + L) {
#define TC_SMEM(x, y, n, s)                                   \
  case tc_key(x, y, n, s) * 8 + 1: return Tc<x, y, n, s, 1>::kSmem; \
  case tc_key(x, y, n, s) * 8 + 2: return Tc<x, y, n, s, 2>::kSmem; \
  case tc_key(x, y, n, s) * 8 + 3: return Tc<x, y, n, s, 3>::kSmem; \
  case tc_key(x, y, n, s) * 8 + 4: return Tc<x, y, n, s, 4>::kSmem;
    TC_CONFIGS(TC_SMEM)
#undef TC_SMEM
    default:
      return -1;
  }
}

// KS of the tc kernel, the multiple its limb planes' R is padded to.
int gr_matmul_tc_depth() { return KS; }

}  // extern "C"
