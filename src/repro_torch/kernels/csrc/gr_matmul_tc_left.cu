// Galois-ring matmul over a lifted ring, e <= 32, whose left operand is
// small, on the int8 tensor cores of sm_90a: the tc_left route, which takes
// the decodes and encodes of a CDMM round over the rings the tc route
// lifts (t <= 64 rows against up to millions of columns).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gr_matmul.py:_kernel
// (launched by gr_matmul_planar) for those calls.  Over GR(2^e, D) (a
// single-level ring or a two-level tower of TC_LIFT_TOWERS, D <= 21) it
// lifts the small A to its multiplication matrices over Z_2^e and reads B
// as it lies:
//
//   M(A)[(t, m), (r, k)] = sum_i A[t, r, i] FOLD[CONVPOS(i, k), m]   (D T x D R)
//   B'[(r, k), s] = B[r, s, k]                                        (D R x S)
//   C[t, s, m] = (M(A) B')[(t, m), s]                        over Z_2^e,
//
// D^2 word products per (t, r, s), as the ring's product has, and no fold:
// (a b)_m = sum_k M(a)[k, m] b_k.  A lift pre-pass writes M(A)'s limb
// planes (left_lift_kernel, from a table MT[i][k][m] = FOLD[CONVPOS(i, k),
// m]), a stack pre-pass B''s (stack_cols_kernel), and the main kernel
// multiplies them with the tc kernel's arithmetic (gr_matmul_tc.cu) at
// D = 1: L byte limbs, u8 x u8 -> s32 wgmma into one accumulator a shift
// s = a + b, which wrap mod 2^32, then sum_s acc(s) << 8s and the mask.
//
// Why over Z_2^e: lifting only the outer level (M(A) over the inner ring
// GR(2^e, D0), as this route first did) leaves K L accumulators an output
// (20 at D0 = 3, L = 4), so a warpgroup's tile is 16 or 32 columns wide and
// its wgmmas are narrow; at D = 1 there are L, and a tile is 64 or 80 wide,
// for the same int8 work.  Versions of this kernel over the inner ring (its
// accumulators split between the consumers as the tc kernel does, or each
// consumer holding a 16-wide tile's) were slower on the card at every
// call of the 64-worker rounds.
//
// What bounds it: at the (3, 7) encode a the 5.6 GB of C written (1.68 ms
// at 3.35 TB/s) and nearly as much int8 work (1.43 ms with the tiles'
// padding); at the decodes the int8 work.  What holds the kernel above
// that on the card: B's planes read from L2 once for every one or two row
// tiles, and a tile's store (PERF.md).  The design:
//  * Persistent and warp-specialised: about one block an SM, each keeping
//    its row tiles of M(A) and walking its column tiles; a producer
//    warpgroup (one thread issuing TMA) loads the next tiles' stages ahead.
//    The blocks of one column step run together, so B's planes come from
//    HBM about once.
//  * Two row tiles a block where both fit in shared memory beside four B
//    stages (the encodes, the R = 33 decode): each consumer warpgroup holds
//    all L accumulators of its row tile's 64 x BN tile, both read every
//    stage of B, so B comes from L2 once for two row tiles, and a stage is
//    released a step late, its wgmmas running on under the next step's.
//    Otherwise one row tile a block, resident where it fits beside two
//    stages (the (3, 7) decode, 672 deep), else A's box streaming in every
//    stage: the consumers take its column tiles in turn, a pair of named
//    barriers handing the tensor cores from one to the other, each step
//    drained before its stage is released (with three stages, a late
//    release starves the loads).
//  * Row tiles of whole t: floor(64 / D) values of t a tile (63 rows at
//    D = 21), so a tile's C is floor(64 / D) contiguous runs of BN D words.
//    The epilogue writes them into shared memory and sends each run with
//    one bulk copy (cp.async.bulk), whose reads of shared memory finish in
//    the background while the consumer's next tile runs (two output buffers
//    a consumer where they fit); where runs are not 16-byte aligned (S D
//    not a multiple of 4) the consumer stores words.  (16-byte stores from
//    the consumers, or from the producer warpgroup's idle warps, were
//    slower on the card.)
//  * 32-byte stages (the 32-byte swizzle, one wgmma k32 step a stage), so
//    K pads to 32: 84 -> 96 at the (3, 7) encode a, 672 stays 672 at its
//    decode.
//  * Template parameters: the tile width BN (TC_LEFT_CONFIGS; the wrapper
//    takes the widest whose layout pairs row tiles, else keeps A resident),
//    the limbs L (each built for L = 1..4) and PAIR; D, the depth and the
//    shared-memory layout are arguments.
//
// C interface (loaded with ctypes); the functions return cudaGetLastError().
#include "gr_matmul_tc_common.cuh"

namespace {

constexpr int kDepth = 32;        // bytes of K a stage: one 32-byte swizzle row, one wgmma k32
constexpr int kRows = 64;         // rows of a tile: one wgmma M
constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;  // 128 * 40 + 256 * 232 = 384 * 168
constexpr int kAlign = 1024;      // slack to align the regions in dynamic shared memory
constexpr int kMaxStages = 8;
constexpr int kPairStages = 4;    // stages two row tiles a block, or two output buffers, must leave
constexpr int kBarBytes = 8 * (2 * kMaxStages + 1);  // full and empty a stage, A's
constexpr int kMaxDeg = 21;       // the (3, 7) tower

// ---------------------------------------------------------------------------
// lift pre-pass: M(A)'s limb planes
// ---------------------------------------------------------------------------
//
// A (batch, T, R, D) -> Y (batch, L, Tp, Rp) u8, byte l of M(A[t, r])[k, m]
// at row t D + m, column r D + k, zero-padded; M(a)[k, m] = sum_i a_i
// MT[(i D + k) D + m].  A is a decode or encode matrix (at most 64 x 33
// elements): one thread per 4 consecutive bytes of a row, D multiply-adds
// each, one 4-byte store a limb plane.
__global__ void __launch_bounds__(256)
    left_lift_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ MT,
                     uint32_t* __restrict__ Y, int T, int R, int D, int L, int Tp, int Rp) {
  const int words = Rp / 4;
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= (int64_t)Tp * words) return;
  const int64_t z = blockIdx.y;
  const int row = (int)(idx / words), q = (int)(idx - (int64_t)row * words);
  const int t = row / D, m = row - t * D;
  uint32_t v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int col = 4 * q + u, r = col / D, k = col - r * D;
    uint32_t acc = 0u;
    if (t < T && r < R) {
      const uint32_t* a = A + ((z * T + t) * (int64_t)R + r) * D;
      for (int i = 0; i < D; ++i) acc += a[i] * MT[(i * D + k) * D + m];
    }
    v[u] = acc;
  }
  for (int l = 0; l < L; ++l) {
    const int sh = 8 * l;
    Y[((z * L + l) * Tp + row) * (int64_t)words + q] =
        ((v[0] >> sh) & 0xFFu) | (((v[1] >> sh) & 0xFFu) << 8) | (((v[2] >> sh) & 0xFFu) << 16) |
        (((v[3] >> sh) & 0xFFu) << 24);
  }
}

// ---------------------------------------------------------------------------
// stack pre-pass: B''s limb planes
// ---------------------------------------------------------------------------
//
// B (batch, R, S, D) -> Y (batch, L, Sp, Rp) u8, byte l of B[r, s, k] at
// row s, column D r + k, zero-padded to the 32-byte depth: it reads B once
// and writes L bytes for every 4-byte word, and the padding, no more.
//
// A block is (batch entry, SB columns of s, KB bytes of K).  KB is all of
// Rp where a tile of 16 columns fits kStackSmem, so that no block covers
// rows of r that are all zeros (every call of the 64-worker rounds: an
// encode's r is 4 or 8, a decode's 32 or 33), else Rp split evenly.  It
// reads the SB D contiguous words of each row of r its bytes of K touch
// into shared memory laid out by output row s, K-contiguous, at a row
// stride of KB + 8 words, four rows' loads in flight a thread; then every
// thread packs 4 consecutive K bytes of one row from one 16-byte load and
// writes one word per limb plane, a warp's words running along K and then
// s.  SB is the most of 128, 64, 32, 16 columns whose tile fits
// kStackSmem.
constexpr int kStackSmem = 48 * 1024;  // dynamic shared memory a block may take without opting in
constexpr int kStackRows = 4;          // rows of r whose loads a thread keeps in flight

// KB and SB of a launch (bytes of K and columns of s a block covers)
void stack_block(int Rp, int& KB, int& SB) {
  const auto fits = [](int kb, int sb) { return sb * (kb + 8) * 4 <= kStackSmem; };
  KB = Rp;
  for (int n = 2; !fits(KB, 16); ++n) KB = ((Rp + n - 1) / n + 15) / 16 * 16;
  SB = 128;
  while (SB > 16 && !fits(KB, SB)) SB /= 2;
}

template <int D>
__global__ void __launch_bounds__(256)
    stack_cols_kernel(const uint32_t* __restrict__ X, uint32_t* __restrict__ Y, int R, int S,
                      int L, int Rp, int Sp, int SB, int KB) {
  extern __shared__ uint4 stack_smem[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(stack_smem);  // [s][(r, k) - k0]
  const int KP = KB + 8;  // words a tile row: a multiple of 4, 8 mod 32
  const int64_t z = blockIdx.z;
  const int s0 = blockIdx.x * SB, k0 = blockIdx.y * KB;
  const int kb = Rp - k0 < KB ? Rp - k0 : KB;            // this block's bytes of K
  const int r0 = k0 / D, r1 = (k0 + kb + D - 1) / D;     // the rows of r they touch
  const uint32_t* Xb = X + z * R * (int64_t)S * D;
  for (int w = threadIdx.x; w < SB * D; w += blockDim.x) {
    const int cc = w / D, k = w - cc * D;
    const bool col = s0 + cc < S;
    uint32_t* row = tile + cc * KP;
    for (int rb = r0; rb < r1; rb += kStackRows) {
      uint32_t v[kStackRows];
#pragma unroll
      for (int u = 0; u < kStackRows; ++u) {
        const int r = rb + u;
        v[u] = col && r < R && r < r1 ? Xb[((int64_t)r * S + s0) * D + w] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kStackRows; ++u) {
        const int kk = (rb + u) * D + k - k0;
        if (kk >= 0 && kk < kb) row[kk] = v[u];
      }
    }
  }
  __syncthreads();
  const int w4 = kb / 4, words = Rp / 4, wb = k0 / 4;
  const int64_t plane = (int64_t)Sp * words;  // words of one limb plane
  for (int idx = threadIdx.x; idx < SB * w4; idx += blockDim.x) {
    const int cc = idx / w4, q = idx - cc * w4;  // row s0 + cc, word q of K
    if (s0 + cc >= Sp) continue;
    const uint4 x = *reinterpret_cast<const uint4*>(&tile[cc * KP + 4 * q]);
    uint32_t* dst = Y + z * L * plane + (int64_t)(s0 + cc) * words + wb + q;
    for (int l = 0; l < L; ++l) {
      const int sh = 8 * l;
      dst[l * plane] = ((x.x >> sh) & 0xFFu) | (((x.y >> sh) & 0xFFu) << 8) |
                       (((x.z >> sh) & 0xFFu) << 16) | (((x.w >> sh) & 0xFFu) << 24);
    }
  }
}

template <int D>
int launch_stack(const uint32_t* X, uint32_t* Y, int batch, int R, int S, int L, int Rp, int Sp,
                 cudaStream_t st) {
  // every s < Sp and every word of Rp: blocks past S and R write zeros
  int KB, SB;
  stack_block(Rp, KB, SB);
  dim3 grid((Sp + SB - 1) / SB, (Rp + KB - 1) / KB, batch);
  stack_cols_kernel<D><<<grid, 256, SB * (KB + 8) * 4, st>>>(X, Y, R, S, L, Rp, Sp, SB, KB);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// main kernel
// ---------------------------------------------------------------------------

constexpr int round_1k(int x) { return (x + 1023) / 1024 * 1024; }

// one instantiation: a consumer's tile 64 x BN, L limbs
template <int BN, int L>
struct Left {
  static constexpr int kABox = L * kRows * kDepth;  // one stage of M(A): 64 rows of every plane
  static constexpr int kBBox = L * BN * kDepth;     // one stage of B': BN rows of every plane
  // a consumer's output buffer: its tile, 64 x BN words (the whole-t runs
  // take at most 64 rows)
  static constexpr int kOut = BN * 256;
  static_assert(BN % 8 == 0, "wgmma u8 takes N = 8, 16, 24, ...; runs are 32-byte multiples");
};

// The shared-memory layout of a launch, which depends on the depth:
// [A's row tiles][stages][consumer 0's output buffers][consumer 1's][mbarriers]
struct Layout {
  int pair;         // the consumers on two row tiles, sharing every stage of B
  int resident;     // the block's row tiles of M(A) are kept for its life
  int stages;       // stages of the ring
  int a_bytes;      // the resident row tiles (0 when A streams)
  int stage_bytes;  // a stage: B's box, after A's box when A streams
  int b_offset;     // B's box within a stage
  int buffers;      // output buffers a consumer: with 2 a tile's bulk copies drain through the next
  int smem;         // dynamic shared memory a block asks for
};

// The first that fits: two row tiles resident, with two output buffers a
// consumer or one, at kPairStages stages (a stage is released a step
// late); one row tile resident, with two buffers at kPairStages stages or
// one at two; one row tile streaming, A's box in every stage, likewise.
Layout layout(int L, int bn, int Rp) {
  const int a_box = L * kRows * kDepth, b_box = round_1k(L * bn * kDepth);
  const int64_t a_tile = (int64_t)(Rp / kDepth) * a_box;
  const int tries[6][4] = {{1, 1, 2, kPairStages}, {1, 1, 1, kPairStages}, {0, 1, 2, kPairStages},
                           {0, 1, 1, 2}, {0, 0, 2, kPairStages}, {0, 0, 1, 2}};
  Layout g{};
  for (const auto& x : tries) {
    g.pair = x[0];
    g.resident = x[1];
    g.buffers = x[2];
    const int fixed = kAlign + 2 * g.buffers * bn * 256 + kBarBytes;
    const int64_t a_all = g.resident ? (g.pair + 1) * a_tile : 0;
    g.a_bytes = (int)(a_all < kSmemMax ? a_all : kSmemMax);
    g.stage_bytes = g.resident ? b_box : a_box + b_box;
    g.b_offset = g.resident ? 0 : a_box;
    const int room = (kSmemMax - fixed - g.a_bytes) / g.stage_bytes;
    g.stages = room < kMaxStages ? room : kMaxStages;
    g.smem = fixed + g.a_bytes + g.stages * g.stage_bytes;
    if (g.stages >= x[3]) return g;
  }
  return g;  // fewer than two stages: no launch
}

// Consumer warpgroup W on its row tile (first t t0, tt of them) and the
// block's column tiles i (column tile first + i step): with PAIR every tile,
// both consumers on every stage of the ring (each its own row tile of A),
// a stage released a step late so that its wgmmas run on under the next
// step's; else the tiles i = W, W + 2, ..., in turn with the other
// consumer (named barriers 1 + W: W may issue), a stage released once its
// step is done.  Each tile ends in an epilogue into the consumer's output
// buffers `out`, in turn (named barrier 3 + W: the consumer's own).
template <int BN, int L, int PAIR, int W>
__device__ __forceinline__ void consume(uint8_t* smem, uint8_t* ring, uint32_t* out, uint32_t full,
                                        uint32_t empty, uint32_t abar, const Layout& lay,
                                        int ktiles, int first, int step, int col_tiles,
                                        uint32_t* __restrict__ C, int T, int S, int D, int64_t z,
                                        int t0, int tt, uint32_t mask, int bulk) {
  using G = Left<BN, L>;
  constexpr int E = BN / 2;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int run = BN * D;                     // words of one t's run of a tile
  const int nt = T - t0 < tt ? T - t0 : tt;   // t of this row tile that exist (may be none)
  const int tiles = (col_tiles - first + step - 1) / step;  // the block's

  // the s32 accumulator fragment: entry e of a thread is row g (+ 8 for
  // e % 4 >= 2) of its warp's 16, column 8 * (e / 4) + 2 * (lane % 4) +
  // e % 2.  Row rho = (t, m) of the tile lands at word t run + m of the
  // output buffer; rows past the tile's whole t are dropped (-1)
  const int g = lane >> 2, qd = lane & 3;
  int row_at[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rho = warp * 16 + g + 8 * h, tl = rho / D;
    row_at[h] = tl < tt ? tl * run + (rho - tl * D) : -1;
  }
  // ldmatrix.x4 rows of this lane: its warp's 16 rows, the two 16-byte
  // chunks of the 32-byte row (the m16n8k32 A fragment); the 32-byte
  // swizzle XORs the chunk with bit 2 of the row
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_lane = a_row * kDepth + (((lane >> 4) ^ ((a_row >> 2) & 1)) << 4);
  // this consumer's resident row tile (with PAIR the second is W's)
  const uint32_t a_base = smem_addr(smem) + (PAIR ? W * ktiles * G::kABox : 0);
  const uint32_t ring_base = smem_addr(ring);
  const bool issuer = warp == 0;  // its lanes issue this consumer's bulk copies
  uint32_t abuf[L][4];  // limb a's A fragment, one a limb
  if (lay.resident) mbar_wait(abar, 0);
  for (int i = PAIR ? 0 : W; i < tiles; i += PAIR ? 1 : 2) {
    // the other consumer's wgmmas of the tile before are issued
    if (!PAIR && i > 0) named_barrier_sync(1 + W, 128 * kConsumers);
    uint32_t acc[L][E];
#pragma unroll
    for (int n = 0; n < L; ++n)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[n][e] = 0u;
    const int q0 = i * ktiles;  // the tile's first stage of the ring, counted from 0
    int stage = q0 % lay.stages, last = stage;
    uint32_t phase = (q0 / lay.stages) & 1;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t sS = ring_base + stage * lay.stage_bytes;
      const uint32_t sA = (lay.resident ? a_base + kt * G::kABox : sS) + a_lane;
      const uint32_t sB = sS + lay.b_offset;
      // limb a of A against limb b of B, into the accumulator of s = a + b,
      // one commit group a limb; before limb a's fragment is reloaded, its
      // group of the last step (L - 1 groups ago) must be done
      static_for<0, L>([&](auto AI) {
        constexpr int a = decltype(AI)::value;
        wgmma_wait<L - 1>();
        ldmatrix_x4(abuf[a], sA + a * kRows * kDepth);
        wgmma_fence();
        static_for<0, L - a>([&](auto BI) {
          constexpr int b = decltype(BI)::value;
          Wgmma<BN>::mma(acc[a + b], abuf[a], sw32_desc(sB + b * BN * kDepth));
        });
        wgmma_commit();
      });
      if constexpr (PAIR) {
        // every group of the last step is done: release its stage
        if (kt > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * last);
        }
      } else {
        // every wgmma of the tile issued: the other consumer may issue its own
        if (kt == ktiles - 1 && i + 1 < tiles) named_barrier_arrive(2 - W, 128 * kConsumers);
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * stage);
      }
      last = stage;
      if (++stage == lay.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if constexpr (PAIR) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * last);
    }

    // epilogue: C = sum_s (acc(s) << 8s) mod 2^32, masked, into an output
    // buffer as the tile's runs, once the bulk copies of this consumer's
    // tile before last (two buffers) or last (one) are done reading it
    uint32_t* ob = out + ((PAIR ? i : i >> 1) % lay.buffers) * (BN * 64);
    if (issuer) {
      if (lay.buffers == 2)
        bulk_wait_read<1>();
      else
        bulk_wait_read<0>();
    }
    named_barrier_sync(3 + W, 128);
    static_for<0, E>([&](auto EI) {
      constexpr int e = decltype(EI)::value, h = (e >> 1) & 1;
      uint32_t v = 0u;
#pragma unroll
      for (int sh = 0; sh < L; ++sh) v += acc[sh][e] << (8 * sh);
      if (row_at[h] >= 0) ob[row_at[h] + (8 * (e >> 2) + 2 * qd + (e & 1)) * D] = v & mask;
    });
    if (bulk) fence_proxy_async();
    named_barrier_sync(3 + W, 128);
    // the tile's runs: C[t0 + tl, n0 .. n0 + cols) for every t of the tile
    const int n0 = (first + i * step) * BN, cols = S - n0 < BN ? S - n0 : BN;
    uint32_t* Cz = C + ((z * T + t0) * (int64_t)S + n0) * D;
    if (bulk) {
      if (issuer) {
        for (int tl = lane; tl < nt; tl += 32)
          bulk_store(Cz + (int64_t)tl * S * D, smem_addr(ob + tl * run), cols * D * 4);
        bulk_commit();
      }
    } else {
      const int words = cols * D;
      for (int idx = tid; idx < nt * words; idx += 128) {
        const int tl = idx / words, w = idx - tl * words;
        Cz[(int64_t)tl * S * D + w] = ob[tl * run + w];
      }
    }
  }
  if (issuer) bulk_wait_all();
}

// A block: row tile u (with PAIR the pair 2 u, 2 u + 1; row tiles of
// floor(64 / D) whole t each) of batch entry z against the column tiles
// first, first + step, ... (blockIdx.x = u + units first, units the row
// tiles or pairs).
template <int BN, int L, int PAIR>
__global__ void __launch_bounds__(kThreads, 1)
    gr_matmul_tc_left_kernel(const __grid_constant__ CUtensorMap mapA,
                             const __grid_constant__ CUtensorMap mapB, uint32_t* __restrict__ C,
                             int T, int S, int D, int ktiles, int units, int tt, int col_tiles,
                             const Layout lay, uint32_t mask, int bulk) {
  using G = Left<BN, L>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kAlign - (smem_addr(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  uint8_t* ring = smem + lay.a_bytes;
  uint32_t* out = reinterpret_cast<uint32_t*>(ring + lay.stages * lay.stage_bytes);
  const uint32_t full = smem_addr(out + 2 * lay.buffers * (G::kOut / 4));
  const uint32_t empty = full + 8 * kMaxStages;
  const uint32_t abar = empty + 8 * kMaxStages;
  const int u = blockIdx.x % units, first = blockIdx.x / units;
  const int step = gridDim.x / units;
  const int64_t z = blockIdx.z;
  if (threadIdx.x == 0) {
    for (int s = 0; s < lay.stages; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's expect_tx
      // one arrival a warp of the consumer (PAIR: both consumers) of the stage
      mbar_init(empty + 8 * s, 4 * (PAIR ? kConsumers : 1));
    }
    mbar_init(abar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      const int zp = (int)z * L;
      const int m0 = (PAIR ? 2 * u : u) * tt * D;  // the first row of the block's row tiles
      if (lay.resident) {  // the row tiles of M(A), once
        mbar_expect_tx(abar, lay.a_bytes);
        for (int w = 0; w <= PAIR; ++w)
          for (int kt = 0; kt < ktiles; ++kt)
            tma_load_3d(smem_addr(smem) + (w * ktiles + kt) * G::kABox, &mapA, abar,
                        kt * kDepth, m0 + w * tt * D, zp);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int ct = first; ct < col_tiles; ct += step) {
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          const uint32_t dst = smem_addr(ring) + stage * lay.stage_bytes;
          mbar_expect_tx(bar, lay.resident ? G::kBBox : G::kABox + G::kBBox);
          if (!lay.resident) tma_load_3d(dst, &mapA, bar, kt * kDepth, m0, zp);
          tma_load_3d(dst + lay.b_offset, &mapB, bar, kt * kDepth, ct * BN, zp);
          if (++stage == lay.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    uint32_t* ob = out + wg * lay.buffers * (G::kOut / 4);
    const int t0 = ((PAIR ? 2 * u : u) + (PAIR ? wg : 0)) * tt;  // this consumer's row tile
    if (wg == 0)
      consume<BN, L, PAIR, 0>(smem, ring, ob, full, empty, abar, lay, ktiles, first, step,
                              col_tiles, C, T, S, D, z, t0, tt, mask, bulk);
    else
      consume<BN, L, PAIR, 1>(smem, ring, ob, full, empty, abar, lay, ktiles, first, step,
                              col_tiles, C, T, S, D, z, t0, tt, mask, bulk);
  }
}

// The grid of a launch on `sms` SMs: row tiles of floor(64 / D) whole t,
// taken two a block (a unit) with `pair`, column tiles bn wide, and about
// one block an SM: `groups` blocks on each unit of each batch entry, each
// walking every groups-th column tile.
struct Grid {
  int row_tiles;
  int units;
  int64_t col_tiles;
  int groups;
};

Grid grid_of(int pair, int bn, int batch, int T, int S, int D, int sms) {
  Grid g{};
  const int tt = kRows / D;
  g.row_tiles = (T + tt - 1) / tt;
  g.units = pair ? (g.row_tiles + 1) / 2 : g.row_tiles;
  g.col_tiles = ((int64_t)S + bn - 1) / bn;
  int64_t groups = sms / ((int64_t)g.units * batch);
  if (groups < 1) groups = 1;
  if (groups > g.col_tiles) groups = g.col_tiles;
  g.groups = (int)groups;
  return g;
}

template <int BN, int L, int PAIR>
int launch(const uint8_t* A8, const uint8_t* B8, uint32_t* C, int batch, int T, int S, int Tp,
           int Sp, int Rp, int D, uint32_t mask, const Layout& lay, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const Grid g = grid_of(PAIR, BN, batch, T, S, D, sms);
  if (g.col_tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  // every launch asks for at most kSmemMax: raise the kernel's limit once
  // per device (the attribute persists), not on every launch, which may be
  // captured in a CUDA graph
  static int smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(gr_matmul_tc_left_kernel<BN, L, PAIR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = 1;
  }
  CUtensorMap mapA, mapB;
  int err = encode_planes(&mapA, A8, batch * L, Tp, Rp, kRows, L, kDepth,
                          CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == 0)
    err = encode_planes(&mapB, B8, batch * L, Sp, Rp, BN, L, kDepth, CU_TENSOR_MAP_SWIZZLE_32B);
  if (err != 0) return err;
  // every run starts 16-byte aligned, and is a multiple of 16 bytes, where
  // S D is a multiple of 4 words
  const int bulk = (int64_t)S * D % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  dim3 grid((unsigned)(g.units * g.groups), 1, batch);
  gr_matmul_tc_left_kernel<BN, L, PAIR><<<grid, kThreads, lay.smem, stream>>>(
      mapA, mapB, C, T, S, D, Rp / kDepth, g.units, kRows / D, (int)g.col_tiles, lay, mask,
      bulk);
  return (int)cudaGetLastError();
}

template <int BN, int L>
int launch_pair(const uint8_t* A8, const uint8_t* B8, uint32_t* C, int batch, int T, int S, int Tp,
                int Sp, int Rp, int D, uint32_t mask, cudaStream_t stream) {
  const Layout lay = layout(L, BN, Rp);
  if (lay.stages < 2) return (int)cudaErrorInvalidValue;
  return lay.pair ? launch<BN, L, 1>(A8, B8, C, batch, T, S, Tp, Sp, Rp, D, mask, lay, stream)
                  : launch<BN, L, 0>(A8, B8, C, batch, T, S, Tp, Sp, Rp, D, mask, lay, stream);
}

}  // namespace

// Tile widths BN of the tc_left kernel (a consumer's 64 x BN tile, its L
// accumulators BN / 2 registers each), the default first; each is built
// for L = 1..4.  The Python mirror is
// repro_torch.kernels.gr_matmul.TC_LEFT_CONFIGS.
#define TC_LEFT_CONFIGS(X) X(80) X(64)

// The degrees D of the rings the route takes (those of TC_LIFT_TOWERS in
// gr_matmul_tc.cu: GR(2^e, 5..16) and the two-level towers' 6, 10, 12, 14,
// 15 and 21), for which the stack pre-pass is built.  The Python mirror is
// repro_torch.kernels.gr_matmul.TC_LEFT_DEGREES.
#define TC_LEFT_DEGREES(X) \
  X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16) X(21)

extern "C" {

// Lift pre-pass: A (batch, T, R, D) uint32 -> the limb planes of M(A),
// (batch, L, Tp, Rp) u8, K-major and zero-padded; mt_dev: the table MT
// (D, D, D) uint32 on the device, MT[i][k][m] = FOLD[CONVPOS(i, k), m].
// Tp, Rp must be multiples of 32 and at least D T, D R.
int gr_matmul_tc_left_lift(const void* A, const void* mt_dev, void* Y, int batch, int T, int R,
                           int D, int L, int Tp, int Rp, void* stream) {
  if (D < 2 || D > kMaxDeg || L < 1 || L > kMaxL || Tp % 32 || Rp % 32 || Tp < D * T ||
      Rp < D * R || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)Tp * (Rp / 4);
  dim3 grid((unsigned)((n + 255) / 256), batch);
  left_lift_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(A), static_cast<const uint32_t*>(mt_dev),
      static_cast<uint32_t*>(Y), T, R, D, L, Tp, Rp);
  return (int)cudaGetLastError();
}

// Stack pre-pass: B (batch, R, S, D) uint32 -> the limb planes of B'
// (B[r, s, k] at row s, column D r + k), (batch, L, Sp, Rp) u8, K-major and
// zero-padded.  Rp must be a multiple of 32 and at least D R, Sp a
// multiple of 32 and at least S; D one of TC_LEFT_DEGREES.
int gr_matmul_tc_stack(const void* B, void* Y, int batch, int R, int S, int D, int L, int Rp,
                       int Sp, void* stream) {
  if (L < 1 || L > kMaxL || Rp % 32 || Sp % 32 || Rp < D * R || Sp < S || batch < 1 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  const uint32_t* x = static_cast<const uint32_t*>(B);
  uint32_t* y = static_cast<uint32_t*>(Y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define TC_STACK_LAUNCH(d) \
  case d:                  \
    return launch_stack<d>(x, y, batch, R, S, L, Rp, Sp, st);
    TC_LEFT_DEGREES(TC_STACK_LAUNCH)
#undef TC_STACK_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// A8 (batch, L, Tp, Rp): the limb planes of M(A) (rows (t, m), depth
// (r, k)); B8 (batch, L, Sp, Rp): B''s (rows s, depth (r, k)) -> C (batch,
// T, S, D) uint32, with the tile width bn; cudaErrorInvalidValue without
// that instantiation, unless Rp is a multiple of 32, Tp >= D T and Sp >= S,
// or if two stages do not fit.
int gr_matmul_tc_left_u32(const void* A8, const void* B8, void* C, int batch, int T, int S,
                          int Tp, int Sp, int Rp, int L, int D, int bn, uint32_t mask,
                          void* stream) {
  if (D < 2 || D > kMaxDeg || L < 1 || L > kMaxL || Rp < kDepth || Rp % kDepth || T < 1 ||
      S < 1 || Tp < D * T || Sp < S || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const uint8_t* a = static_cast<const uint8_t*>(A8);
  const uint8_t* b = static_cast<const uint8_t*>(B8);
  uint32_t* c = static_cast<uint32_t*>(C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn * 8 + L) {
#define TC_LEFT_LAUNCH(n)                                                              \
  case n * 8 + 1: return launch_pair<n, 1>(a, b, c, batch, T, S, Tp, Sp, Rp, D, mask, st); \
  case n * 8 + 2: return launch_pair<n, 2>(a, b, c, batch, T, S, Tp, Sp, Rp, D, mask, st); \
  case n * 8 + 3: return launch_pair<n, 3>(a, b, c, batch, T, S, Tp, Sp, Rp, D, mask, st); \
  case n * 8 + 4: return launch_pair<n, 4>(a, b, c, batch, T, S, Tp, Sp, Rp, D, mask, st);
    TC_LEFT_CONFIGS(TC_LEFT_LAUNCH)
#undef TC_LEFT_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tile widths, default first: writes up to `cap` to `out` and returns
// how many there are.
int gr_matmul_tc_left_configs(int* out, int cap) {
  int n = 0;
#define TC_LEFT_CONFIG(n_)  \
  if (n < cap) out[n] = n_; \
  ++n;
  TC_LEFT_CONFIGS(TC_LEFT_CONFIG)
#undef TC_LEFT_CONFIG
  return n;
}

// The shared-memory layout of a launch at L limbs, tile width bn and depth
// Rp: returns the dynamic shared memory it asks for and writes (two row
// tiles a block, A resident, stages, output buffers a consumer) to out.
int gr_matmul_tc_left_layout(int L, int bn, int Rp, int* out) {
  const Layout g = layout(L, bn, Rp);
  out[0] = g.pair;
  out[1] = g.resident;
  out[2] = g.stages;
  out[3] = g.buffers;
  return g.smem;
}

// The grid of a launch at L limbs and tile width bn over a call of batch
// entries of (T x R) @ (R x S) of degree D, with depth Rp, on `sms` SMs (a
// launch takes the card's): returns its blocks and writes (row tiles,
// column tiles) to out; -1 if two stages do not fit.
int gr_matmul_tc_left_grid(int L, int bn, int batch, int T, int S, int D, int Rp, int sms,
                           int64_t* out) {
  const Layout lay = layout(L, bn, Rp);
  if (lay.stages < 2 || D < 1 || batch < 1 || sms < 1) return -1;
  const Grid g = grid_of(lay.pair, bn, batch, T, S, D, sms);
  out[0] = g.row_tiles;
  out[1] = g.col_tiles;
  return g.units * g.groups * batch;
}

// The stage depth, the multiple tc_left's limb planes' K is padded to.
int gr_matmul_tc_left_depth() { return kDepth; }

}  // extern "C"
