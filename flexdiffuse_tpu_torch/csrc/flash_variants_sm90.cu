// Attention variants T1–T6 redesigned for Hopper (sm_90a): the second path
// of ops/flash_variants.py::attn_opt, ::attn_h, ::pipelined_attention,
// ::flash_tt2, ::flash_ttv3 and ::attn_variants, beside their first ports
// in flash_variants.cu (kept, and taken only when the caller forces
// path='mma').
//
// Replaces the Pallas kernels of the JAX package's flash-kernel tools:
//   T1 tools/flash_opt.py::make_kernel (:56)  v0 one kv chain an instance,
//      vU the kv loop unrolled, vG G ∈ {2, 4} q chains an instance
//   T2 tools/flash_opt.py::make_kernel_h (:120)  every head of a q tile in
//      one instance
//   T3 tools/flash_pipelined.py::_pipelined_kernel (:22)  QKᵀ of kv tile j+1
//      issued before the softmax of tile j
//   T4 tools/flash_tt.py::_flash_tt2_kernel (:87)  [B, H, D, S] operands
//   T5 tools/flash_tt3.py::_ttv3_kernel (:41)  [B, H, D, S], exp2, the row
//      sum folded into P·V (ttv3), with exp2 on bf16 pairs (ttv4), or
//      summed a tile at a time and rounded (no-fold)
//   T6 tools/flash_variants.py::make_kernel (:26)  v0 exp (T1 v0's code),
//      v1 exp2 with log2 e in q's scale, v2 exp2 with l from the 16-bit P
// T1, T2, T3 and T6 v0 compute what their plain twin
// (ops/flash_variants.py::plain_exp) does: q̃ = round16(q · round16(scale))
// in q's dtype, s = q̃·kᵀ in fp32, p = exp(s − m) with the running row max
// m, l = Σ p in fp32, P rounded to the 16-bit type for P·V, and the output
// O/l. The exponential runs as one FFMA by log2 e into ex2.approx
// (sm90.cuh). T6 v1 and v2 (plain_attn_variants) scale q by
// round16(scale·log2 e) and take p = exp2(s − m), the same FFMA by 1; v2
// sums l over round16(p), the very values the P·V wgmma reads. Domain:
// contiguous, 16-byte aligned bf16/fp16 [B, H, S, D], Sq and Skv multiples
// of 64 (Sq of 64·G for vG), d a multiple of 8 up to 128; anything else
// returns cudaErrorInvalidValue.
//
// What bounds them on this card: as K1 (flash_attention.cu), one ex2 per
// score on the 16-lane MUFU unit at SD's d = 40 (0.064 ms at
// (2,8,4096,40)), above the tensor cores (0.043 ms) and the bytes; in
// practice each consumer warpgroup's dependent chain per kv tile. Each
// variant is a different answer to that chain.
//
// Shared by all four (K1's building blocks, sm90.cuh): TMA loads of Q, K
// and V through 3-D tensor maps [B·H, S, D] into tiles of 64 rows, stored
// with the 128-byte swizzle at DP <= 64 and the 32-byte one above (DP = d
// rounded up to 16); wgmma m64n64k16 for S = q̃·K_jᵀ (both K-major in
// shared memory) and m64n{DP}k16 for O += P·V_j (P from registers, V
// MN-major); one producer warpgroup whose thread(s) issue every TMA load
// and give their registers to the consumers (setmaxnreg; T1/T6 have none,
// below); consumer warpgroups of 64 q rows that take turns to issue their
// wgmma (ping-pong, sm90::Turns; T1/T6's own ChainBars). q̃ is made
// where TMA put Q: each consumer scales its Q tile in place once per (q
// tile, head), in the swizzled layout (the scaling is elementwise; the
// zero-filled columns stay zero), then fence.proxy.async orders those
// writes before the wgmma that read it. O·(1/l) is stored from registers.
//
// T3, score-ahead (pipelined_sm90_kernel): one block per (b·h, 128 q rows)
// with two consumers that share one ring of 4 K/V stages. Per kv tile j
// each consumer, in its turn, issues P_{j-1}·V_{j-1} and S_{j+1} =
// q̃·K_{j+1}ᵀ into its second score set, then runs the softmax of S_j (in
// the first set, complete since the last tile) while both products are on
// the tensor cores, waits for them, rescales O and converts S_j to P_j. So
// the score latency never sits on the chain (K1 issues S_j with
// P_{j-1}·V_{j-1} and waits for S_j before its softmax). The two sets swap
// roles each tile (the loop is unrolled by two). A stage is freed once
// P_j·V_j is done, one tile after S_{j+2} needed the next one, hence 4
// stages. What ptxas needs to keep the wgmma asynchronous: no register an
// unfinished wgmma owns is written (the softmax writes only the completed
// set; O and P change only after the wait) and no wgmma is issued under a
// branch of its own (a conditional issue made it serialise them all,
// C7514); and registers: with three consumers a thread gets 128, and two
// score sets of 32 on top of O spilled, serialised the wgmma (C7512) and
// ran slower, so there are two. At DP = 128 two still spill 40 bytes
// (C7512).
//
// T2, heads in one instance (heads_sm90_kernel): one instance per (b,
// 64-row q tile) owns every head of that q tile, as the TPU kernel does.
// The parallelism inside it comes from the heads: C consumer warpgroups (3
// up to DP = 64, 2 above) each run a different head's kv loop (heads c,
// c + C, ...) with their own q̃, m, l and O in registers, in K1's schedule
// (S_j issued with P_{j-1}·V_{j-1}, the softmax of S_j beside that
// product). Each consumer has its own ring of 3 K/V stages and one or two
// Q tiles, fed by its own producer warp, which runs straight across head
// boundaries: the next head's Q and first tiles load while this head
// finishes, so a head switch drains nothing. Consumers with fewer heads (H
// not a multiple of C) take their remaining turns without issuing, so the
// ping-pong's barriers stay balanced. What this costs against K1: K1's
// consumers share each K/V tile, T2's each stream their own head's, three
// times the tiles per block; the stamps (tools/variant_stamps.py) put a
// consumer's time at d = 40 largely in waiting for its tile or for a turn
// held by a consumer that waits for its tile.
// Where the instances fill at most half of the card (B·Sq/64 <= 66), the
// wrapper splits each instance's kv range over a cluster of `parts` CTAs
// (2; the kernel also takes 4; ops/flash_variants.py::plan_attn_h; DP <=
// 96, where the merge buffers fit beside the rings): the cluster is then
// the instance. After each head, ranks 1.. leave their unnormalised O,
// their row max m and quad-partial row sum l in their own shared memory
// and, once their warpgroup has written it, arrive on rank 0's barrier
// (one arrival each: 128 remote arrivals on one barrier serialise); rank 0
// reads them through distributed shared memory, merges in rank order,
// o = Σ o_r·e^(m_r − m), l likewise with m = max m_r, frees their buffers
// (a remote arrive) and stores the head. ops/flash_variants.py::
// plain_split_exp is the split's twin.
//
// T1 and T6, chains (chains_sm90_kernel): one template for the six
// configurations, which differ only in how many q chains share a K/V tile,
// the base of the exponential (a runtime factor, with q's scale) and where
// l is summed (kL16, T6 v2). Each block has G consumer warpgroups of 64 q
// rows in K1's schedule (S_j issued with P_{j-1}·V_{j-1}, the softmax of
// S_j beside that product, the consumers taking turns to issue when G > 1)
// and no producer warpgroup or warp: warp 0 of the last consumer issues
// the TMA loads, one box a lane, refilling a stage once every consumer has
// released it (at once when it is the only one). ptxas allots a thread
// 16384 / (32 · ⌈warps an SM / 4⌉) registers, rounded down to 8, whatever
// setmaxnreg asks later: a 17th warp of producer cost every thread a
// quarter of its registers (96 instead of 128), which spilled vG2 and vG4
// at DP 48 and serialised their wgmma (C7512). The TPU variants' Hopper
// forms (ChainsTiling):
//   v0 (and T6 v0, v1, v2): one consumer, 128 threads; the independent
//      chains of an SM come from resident blocks: 3 an SM up to DP = 64
//      (3 K/V stages, 57 KB of shared memory and up to 168 registers a
//      thread each), 2 above (2 stages).
//   vU: v0's block with a ring of 4 stages (3 blocks an SM up to DP = 64,
//      2 at DP 80 and 96, 1 above, by shared memory), the kv loop written
//      out two tiles a turn of the loop.
//   vG: G consumers sharing one ring of 3 stages, 256 (G = 2) or 512
//      (G = 4) threads and 128 registers a thread (two vG2 blocks an SM up
//      to DP = 64, one above; one vG4 block); vG4 takes 32-row kv tiles
//      above DP = 96, where O, S and P at 64 rows would not fit.
// What bounds them: the K/V stream, then the softmax. A single-chain
// block streams every K/V tile for 64 q rows; the stamps put over half of
// v0's time in waiting for its tile while the boxes were a 64-column slab
// wide with d = 40 (the zero columns past d are filled by TMA, not read,
// yet cost like data). So up to DP = 64 the boxes are d columns wide, the
// slab's pitch and swizzle kept, and the columns past d zeroed once
// (PERF.md §6). Sharing a K/V load between the blocks of a cluster (TMA
// multicast to 2 or 4 q tiles of a head) ran slower at both main shapes
// and was dropped. Where the blocks number at most the
// card's SMs (vG2 and vG4 at the 1024-token head), the plans of T1 and T6
// v0 split the kv range over a cluster of 2 blocks
// (ops/flash_variants.py::chains_parts), merged as T2's split but once:
// ranks 1.. leave (o, m, l) where Q and the ring were, rank 0 reads them
// through distributed shared memory; the twin is plain_split_exp. The
// exp2 variants (T6 v1, v2) are never split.
//
// T4 and T5, the same kernel over [B, H, D, S] (its Form: TtExp, TtFold,
// TtFoldBf16, TtTile). The TPU kernels share each K/V block among 512 q
// rows, so vG4's four chains are also the faithful form; where Sq is not a
// multiple of 256, or DP > 96 (O, S and P of a 64-column tile would not
// fit 128 registers), the plan takes vG2's or v0's tiles
// (ops/flash_variants.py::tt_chains). The layout changes only the
// operands and the store: each tile is d rows of 64 columns, exactly one
// 128-byte swizzle span a row, loaded by one TMA box of 64 columns by d
// rows (no column past the data), the rows d..DP-1 zeroed once; S = q̃ᵀ·K_j
// takes both operands MN-major (wgmma with both transpose bits), O +=
// P·V_jᵀ takes V_j K-major (the RS form with kTransB = 0); O·(1/l) is
// staged transposed in the consumer's Q tile and stored by one TMA box.
// The rounding points are the kept twins': T4 exp, fp32 l (and T1's kv
// split, twin plain_split_exp over the transposed views); T5 exp2 with
// log2 e in q's scale, l = Σ round16(p) from a row of ones in V (ttv3, N =
// round16(d + 1): 48 at d = 40, 96 at d = 80; the ones are V's last padded
// row, DP - 1, not row d as in the kept kernel, so that l is a register
// known at compile time), ttv4 exp2 of the argument rounded to bf16, two
// a PTX instruction (ex2.approx.ftz.bf16x2, which ptxas issues as two
// MUFU.EX2.BF16), no-fold each 64-column tile's row sum rounded to the
// 16-bit type. T5 is never split. Domain: T1's over [B, H, D, S], d <= 120
// with the fold.
//
// K1 over [D, S] (flash_attention_ds_sm90): the Hopper path of
// ops/flash_attention.py::flash_attention_tt and ::flash_attention_cm,
// which replace the JAX package's flexdiffuse_tpu/ops/flash_attention.py::
// flash_attention_tt (:202) and ::flash_attention_cm (:260), both running
// _flash_tt_kernel (:126) under their own grids. It is T4's kernel (TtExp,
// its tilings and kv split) with K1's arithmetic: q unscaled and p = 2^(s·c
// − m·c), c = scale·log2 e in fp32. A plane's columns are runs of sq q (o)
// and skv K/V columns: [B, H, D, S] is B·H planes of one run, [H, D, B, S]
// (the channel-major UNet's layout) H planes of B runs, the trailing (B,
// S) one axis of the tensor maps; a q tile (never across runs: sq is a
// multiple of its 64·chains rows) reads its run's K/V, kv0 = run·skv
// columns on, as the TPU kernel's index map picks the batch's K/V block.
// So both layouts are the same instantiations, and the head split of the
// channel-major interior reaches the kernel with no copy. Bound as T4.

#include <type_traits>
#include <utility>

#include "flash_common.cuh"
#include "sm90.cuh"

// The build: ops/flash_attention.build compiles this file BUILD_PARTS times
// at once (-DBUILD_PART=p) and links the objects. The (kernel, dtype, width)
// units are spread over the parts; part 0 also holds the launcher table and
// the entry points. A compile without these macros holds everything.
#ifndef BUILD_PARTS
#define BUILD_PARTS 1
#define BUILD_PART 0
#endif

namespace {

constexpr int kRows = 64;      // q rows per consumer warpgroup (one wgmma M)
constexpr int kKv = 64;        // kv rows per tile (one wgmma N of S)
constexpr int kMaxWidths = 8;  // DP = 16, 32, ..., 128
constexpr int kSmemLimit = 232448;   // bytes of shared memory a block may use

// The swizzle span of a head width's tiles: 128 bytes (one slab of 64
// columns) up to DP = 64, 32 bytes (slabs of 16 columns, none past DP)
// above, as K1's.
template <int DP>
constexpr int kPitchOf = DP <= 64 ? 128 : 32;

using sm90::Geometry;
using sm90::Regs;
using sm90::Turns;

// T3's tiles (ops/flash_variants.py::PIPELINED_TILES says the same).
template <int DP>
struct PipelinedTiling {
  static constexpr int kConsumers = 2;
  static constexpr int kStages = 4;
  using G = Geometry<kPitchOf<DP>, DP>;
  static constexpr int kQ = G::bytes(kRows);
  static constexpr int kTile = G::bytes(kKv);
  static constexpr int kK = kConsumers * kQ;        // the K stages
  static constexpr int kV = kK + kStages * kTile;   // the V stages
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
  static_assert(kBytes <= kSmemLimit, "T3 shared memory");
};

// T2's tiles (ops/flash_variants.py::HEADS_TILES): per consumer a ring
// of kStages K/V stages and kQBufs Q tiles (two where they fit), and where
// the kv split is allowed (kSplit, up to DP = 96) a merge buffer of 128
// threads x (DP / 8 + 1) float4s. A fourth stage, where it fits, left the
// time unchanged: what holds a consumer's tile back is not the ring's depth
// (PERF.md §6).
template <int DP>
struct HeadsTiling {
  static constexpr int kConsumers = DP <= 64 ? 3 : 2;
  static constexpr int kStages = 3;
  static constexpr bool kSplit = DP <= 96;
  using G = Geometry<kPitchOf<DP>, DP>;
  static constexpr int kQ = G::bytes(kRows);
  static constexpr int kTile = G::bytes(kKv);
  static constexpr int kMergeF4 = DP / 8 + 1;   // o in float4s, then m, l
  static constexpr int kPart = kSplit ? 128 * kMergeF4 * 16 : 0;
  // Per consumer: the ring, its full and empty barriers, the merge buffer,
  // part_full and part_free; then per Q tile its bytes, q_full and q_empty.
  static constexpr int kFixed =
      kConsumers * (2 * kStages * kTile + kPart + (2 * kStages + 2) * 8) +
      1024;
  static constexpr int kQBufs =
      kFixed + kConsumers * 2 * (kQ + 16) <= kSmemLimit ? 2 : 1;
  static constexpr int kBytes = kFixed + kConsumers * kQBufs * (kQ + 16);
  static_assert(kBytes <= kSmemLimit, "T2 shared memory");
  // Byte offsets of consumer c's pieces from the 1024-aligned base.
  __host__ __device__ static constexpr int q_tile(int c, int b) {
    return (c * kQBufs + b) * kQ;
  }
  __host__ __device__ static constexpr int k_tile(int c, int s) {
    return kConsumers * kQBufs * kQ + (c * kStages + s) * kTile;
  }
  __host__ __device__ static constexpr int v_tile(int c, int s) {
    return k_tile(kConsumers, 0) + (c * kStages + s) * kTile;
  }
  __host__ __device__ static constexpr int part(int c) {
    return v_tile(kConsumers, 0) + c * kPart;
  }
  static constexpr int kBarsPerConsumer = 2 * kStages + 2 * kQBufs + 2;
  __host__ __device__ static constexpr int bars(int c) {
    return part(kConsumers) + c * kBarsPerConsumer * 8;
  }
};

// The chains kernel's tilings (chains_sm90_kernel's Cfg): v0 one chain a
// block, vU v0 with a deeper ring, vG2 and vG4 two and four chains.
enum Chains : int { kV0 = 0, kVU = 1, kVG2 = 2, kVG4 = 3 };

// How the row sum l is formed (the twins' rounding points,
// ops/flash_variants.py::plain_variant).
enum RowSum : int {
  kSumP,      // Σ p in fp32 (T1, T2, T3, T4, T6 v0 and v1)
  kSumP16,    // Σ round16(p), the values P·V reads (T6 v2)
  kSumFold,   // P·V's last column, V's last row all ones (T5 ttv3, ttv4)
  kSumTile,   // each 64-column tile's Σ round16(p), rounded, then summed
              // (T5 no-fold)
};

// The chains kernel's form (its second template argument beside the
// tiling): [S, D] operands (T1, T6) or [D, S] ones (T4, T5), the row sum,
// and whether exp2 runs on bf16 argument pairs (T5 ttv4).
template <bool kDS_, int kSum_, bool kBf16Exp_ = false>
struct Form {
  static constexpr bool kDS = kDS_;
  static constexpr int kSum = kSum_;
  static constexpr bool kBf16Exp = kBf16Exp_;
};
// Named types, so that the kernels' names say their form
// (tools/ptxas_report.py --match 'chains.*Tt' shows T4's and T5's).
struct Bhsd : Form<false, kSumP> {};               // T1, T6 v0 and v1
struct Bhsd16 : Form<false, kSumP16> {};           // T6 v2
struct TtExp : Form<true, kSumP> {};               // T4
struct TtFold : Form<true, kSumFold> {};           // T5 ttv3
struct TtFoldBf16 : Form<true, kSumFold, true> {}; // T5 ttv4
struct TtTile : Form<true, kSumTile> {};           // T5 no-fold

constexpr int kSmemPerSm = 233472;   // an SM's shared memory, bytes

// T1's, T4's, T5's and T6's tiles (ops/flash_variants.py::CHAINS_TILES
// and chains_tiling say the same): kChains consumer warpgroups of 64 q
// rows sharing a ring of kStages K/V tiles of kN rows; kBlocks blocks an
// SM, the fewer of what the registers (kByRegs, the __launch_bounds__ that
// sets a thread's share) and the shared memory (with the 1 KB the card
// reserves a block) allow. Over [D, S] a tile is DP rows of 64 columns,
// 128 bytes each (one swizzle span): the kv tile stays 64 columns, so vG4
// takes [D, S] operands only up to DP 96 (kOffered), where O, S and P fit
// its 128 registers.
template <int DP, int Cfg, typename F>
struct ChainsTiling {
  static constexpr bool kDS = F::kDS;
  static constexpr bool kNarrow = DP <= 64;
  static constexpr int kChains = Cfg == kVG2 ? 2 : Cfg == kVG4 ? 4 : 1;
  static constexpr bool kOffered = !(kDS && kChains == 4 && DP > 96);
  static constexpr bool kUnroll = Cfg == kVU;
  static constexpr int kN = !kDS && kChains == 4 && DP > 96 ? 32 : 64;
  static constexpr int kStages =
      kUnroll ? 4 : (kChains > 1 || kNarrow) ? 3 : 2;
  static constexpr int kThreads = 128 * kChains;
  using G = Geometry<kPitchOf<DP>, DP>;
  static constexpr int kQ = kDS ? DP * 128 : G::bytes(kRows);
  static constexpr int kTile = kDS ? DP * 2 * kN : G::bytes(kN);
  static constexpr int kK = kChains * kQ;            // the K stages
  static constexpr int kV = kK + kStages * kTile;    // the V stages
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
  // The kv split's merge buffer, (o, m, l) as float4s per thread, goes
  // where Q and the ring were: where it fits, the split is allowed (not
  // for T5, which is never split).
  static constexpr int kMergeF4 = DP / 8 + 1;
  static constexpr bool kSplit = (!kDS || F::kSum == kSumP) &&
                                 kChains * 128 * kMergeF4 * 16 <= kBars;
  static constexpr int kByRegs =
      kChains == 1 ? (kNarrow ? 3 : 2) : (kChains == 2 && kNarrow) ? 2 : 1;
  static constexpr int kBySmem = kSmemPerSm / (kBytes + 1024);
  static constexpr int kBlocks = kByRegs < kBySmem ? kByRegs : kBySmem;
  static_assert(kBlocks >= 1 && kBytes <= kSmemLimit, "chains tiles");
};

// The chains kernels the library holds, by kind: 0-3 T1 v0 (also T6 v0
// and v1), vU, vG2, vG4; 4 T6 v2; then T4, T5 ttv3, ttv4 and no-fold, each
// at v0's, vG2's and vG4's tiles (kinds 5 + 3·form + 0, 1, 2).
template <int Kind>
struct ChainKind;
#define CHAIN_KIND(kind, cfg, form)          \
  template <>                                \
  struct ChainKind<kind> {                   \
    static constexpr int kCfg = cfg;         \
    using F = form;                          \
  }
CHAIN_KIND(0, kV0, Bhsd);
CHAIN_KIND(1, kVU, Bhsd);
CHAIN_KIND(2, kVG2, Bhsd);
CHAIN_KIND(3, kVG4, Bhsd);
CHAIN_KIND(4, kV0, Bhsd16);
CHAIN_KIND(5, kV0, TtExp);
CHAIN_KIND(6, kVG2, TtExp);
CHAIN_KIND(7, kVG4, TtExp);
CHAIN_KIND(8, kV0, TtFold);
CHAIN_KIND(9, kVG2, TtFold);
CHAIN_KIND(10, kVG4, TtFold);
CHAIN_KIND(11, kV0, TtFoldBf16);
CHAIN_KIND(12, kVG2, TtFoldBf16);
CHAIN_KIND(13, kVG4, TtFoldBf16);
CHAIN_KIND(14, kV0, TtTile);
CHAIN_KIND(15, kVG2, TtTile);
CHAIN_KIND(16, kVG4, TtTile);
#undef CHAIN_KIND
constexpr int kChainKinds = 17;
constexpr int kTtKinds = 5;   // the first T4/T5 kind

// ------------------------------------------------------------ device helpers

template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t w);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t w) {
  return __half22float2(*reinterpret_cast<__half2*>(&w));
}

// x rounded to T, as a float.
template <typename T>
__device__ __forceinline__ float round16(float x) {
  return unpack2<T>(Ops<T>::pack(x, 0.f)).x;
}

template <typename T>
__device__ __forceinline__ uint32_t scale2(uint32_t w, float c16) {
  const float2 x = unpack2<T>(w);
  return Ops<T>::pack(x.x * c16, x.y * c16);
}

// q̃ = round16(q · c16) in place over a tile of `bytes` bytes, by the 128
// threads of one consumer (t = 0..127): the product of two 16-bit values is
// exact in fp32 and rounds once, as the twin's 16-bit multiply. The fence
// orders these writes before the wgmma (async proxy) that read them; the
// caller then syncs the warpgroup.
template <typename T>
__device__ __forceinline__ void scale_q(unsigned char* tile, int bytes,
                                        float c16, int t) {
  uint4* p = reinterpret_cast<uint4*>(tile);
  for (int i = t; i < bytes / 16; i += 128) {
    uint4 w = p[i];
    w.x = scale2<T>(w.x, c16);
    w.y = scale2<T>(w.y, c16);
    w.z = scale2<T>(w.z, c16);
    w.w = scale2<T>(w.w, c16);
    p[i] = w;
  }
  sm90::fence_proxy_async();
}

// An arrival on an mbarrier of another block of the cluster (its address
// from sm90::map_rank), ordering before it at cluster scope this thread's
// earlier memory accesses and those a barrier ordered before them.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile(
      "fence.acq_rel.cluster;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

// Clock stamps per phase, compiled in only with -DFV_STAMPS (one build
// part; tools/variant_stamps.py): the cycles thread 0 of consumer 0 of
// block (0, 0, 0) spends in each phase of its kv loop, summed over the
// launches since the last read, per kernel (0 T2, 1 T3, 2 T1/T6). Each
// stamp charges the cycles since the one before to its phase.
enum Phase : int {
  kTurn,      // waiting for this consumer's turn to issue
  kTile,      // waiting for a K/V tile (TMA)
  kIssue,     // issuing the wgmma
  kWaitS,     // waiting for S (T2, T1/T6)
  kSoftmax,   // the online softmax of one tile
  kWaitAll,   // waiting for the products in flight
  kTail,      // rescaling O, converting S to P, freeing the stage
  kOther,     // the rest: Q, the first tile, head switches, merges, stores
  kPhases
};
#ifdef FV_STAMPS
__device__ unsigned long long fv_stamps[3][kPhases];
#endif
struct Stamps {
#ifdef FV_STAMPS
  bool on;
  long long t;
  __device__ __forceinline__ explicit Stamps(int consumer) {
    on = consumer == 0 && threadIdx.x % 128 == 0 && blockIdx.x == 0 &&
         blockIdx.y == 0 && blockIdx.z == 0;
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(t));
  }
  __device__ __forceinline__ void operator()(int kernel, int phase) {
    if (!on) return;
    long long now;
    asm volatile("mov.u64 %0, %%clock64;\n" : "=l"(now));
    fv_stamps[kernel][phase] += now - t;
    t = now;
  }
#else
  __device__ __forceinline__ explicit Stamps(int) {}
  __device__ __forceinline__ void operator()(int, int) {}
#endif
};

// A 16-byte load from another block's shared memory (its address from
// sm90::map_rank). Not volatile, unlike sm90::ld_cluster, so that the
// loads of one merge issue back to back instead of each waiting for the
// last; the barrier wait before them orders them.
__device__ __forceinline__ float4 ld_dsmem(uint32_t addr) {
  float4 v;
  asm("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "r"(addr));
  return v;
}

// sm90::mbar_wait with acquire at cluster scope: what other blocks of the
// cluster wrote before their arrivals is visible after it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t a = sm90::smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// exp2 of two fp32 arguments rounded to bf16, in one instruction (sm_90),
// the two bf16 results packed.
__device__ __forceinline__ uint32_t ex2_bf16x2(float x0, float x1) {
  __nv_bfloat162 in = __floats2bfloat162_rn(x0, x1);
  uint32_t out;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n"
      : "=r"(out)
      : "r"(*reinterpret_cast<uint32_t*>(&in)));
  return out;
}

// One consumer warpgroup's 64 q rows of one head: O, and for rows g and
// g + 8 of the warp's 16 the running max of the raw scores and the
// quad-partial row sum (the whole row's with kSumTile). Thread t of the
// warpgroup. Kv tiles of N rows; the form F says how the operands lie and
// how l is formed (kSumFold keeps l in O's last column).
template <typename T, int DP, int N = kKv, typename F = Bhsd>
struct Rows {
  static constexpr int kPitch = kPitchOf<DP>;
  static constexpr int kSum = F::kSum;
  using G = Geometry<kPitch, DP>;
  // A [D, S] tile: DP rows of 64 columns, one 128-byte swizzle span each.
  using Gt = Geometry<128, kKv>;
  static_assert(!F::kDS || N == kKv, "[D, S] tiles are 64 columns wide");
  float o[DP / 2];
  float m_run[2];
  float l_run[2];
  int tq;

  __device__ __forceinline__ explicit Rows(int t) : tq(t % 4) { reset(); }

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    m_run[0] = m_run[1] = -INFINITY;
    l_run[0] = l_run[1] = 0.f;
  }

  // S = q̃·K_jᵀ, 64 x N, DP / 16 k-steps (not committed). Over [D, S]
  // q̃ and K_j are stored [d][64] (k rows, m or n columns): both operands
  // MN-major, a k-step 16 rows of 128 bytes.
  static __device__ __forceinline__ void issue_s(float (&sc)[N / 2],
                                                 const unsigned char* s_q,
                                                 const unsigned char* sk) {
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      if constexpr (F::kDS) {
        sm90::Wgmma<T, N, 1>::ss(sc, Gt::mnmajor(s_q + ks * 16 * 128, DP),
                                 Gt::mnmajor(sk + ks * 16 * 128, DP),
                                 ks > 0);
      } else {
        sm90::Wgmma<T, N>::ss(sc, G::kmajor(s_q + G::kstep(ks, kRows)),
                              G::kmajor(sk + G::kstep(ks, N)), ks > 0);
      }
    }
  }

  // O += P·V_j; the accumulator n-blocks 2kt, 2kt + 1 of S are the A
  // fragment of k-step kt (not committed). Over [D, S] V_j is stored
  // [d][64 kv]: B K-major, a k-step 32 bytes along each row.
  __device__ __forceinline__ void issue_pv(const uint32_t (&pa)[N / 16][4],
                                           const unsigned char* sv) {
#pragma unroll
    for (int kt = 0; kt < N / 16; ++kt) {
      if constexpr (F::kDS) {
        sm90::WgmmaRs<T, DP, 0>::rs(o, pa[kt],
                                    Gt::kmajor(sv + Gt::kstep(kt, DP)), 1);
      } else {
        sm90::WgmmaRs<T, DP>::rs(o, pa[kt],
                                 G::mnmajor(sv + kt * 16 * kPitch, N), 1);
      }
    }
  }

  // mx[r][i] = max(mx[r][i], mx[r][i + W]), then W / 2, ... 1 (K1's tree).
  template <int W>
  static __device__ __forceinline__ void fold_max(float (&mx)[2][N / 8]) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      mx[0][i] = fmaxf(mx[0][i], mx[0][i + W]);
      mx[1][i] = fmaxf(mx[1][i], mx[1][i + W]);
    }
    if constexpr (W > 1) fold_max<W / 2>(mx);
  }

  // The online softmax of one tile in place (every column is valid: Skv is
  // a multiple of the tile): updates m and l, leaves
  // P = 2^(s·c − m·c) in sc (c = log2 e: e^(s − m); c = 1: 2^(s − m);
  // with F::kBf16Exp the argument rounded to bf16 and a bf16 result)
  // and the factor O must be scaled by in alpha.
  __device__ __forceinline__ void softmax(float (&sc)[N / 2],
                                          float (&alpha)[2],
                                          float c = kLog2e) {
    float mx[2][N / 8];
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      mx[0][i] = fmaxf(sc[4 * i], sc[4 * i + 1]);
      mx[1][i] = fmaxf(sc[4 * i + 2], sc[4 * i + 3]);
    }
    fold_max<N / 16>(mx);
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = fmaxf(m_run[r], mx[r][0]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      // m is finite; on the first tile m_run is -inf and alpha 0. An
      // unchanged max gives alpha 1 exactly.
      mc[r] = __fmul_rn(m, c);
      alpha[r] = sm90::ex2(__fmul_rn(m_run[r] - m, c));
      m_run[r] = m;
    }
    float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      if constexpr (F::kBf16Exp) {
        // Columns 2tq, 2tq + 1 of a row: one ex2 for the pair. The fold
        // sums P·V's 16-bit P, so no row sum here.
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 p = unpack2<__nv_bfloat16>(
              ex2_bf16x2(__fmaf_rn(sc[4 * i + 2 * r], c, -mc[r]),
                         __fmaf_rn(sc[4 * i + 2 * r + 1], c, -mc[r])));
          sc[4 * i + 2 * r] = p.x;
          sc[4 * i + 2 * r + 1] = p.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              sm90::ex2(__fmaf_rn(sc[4 * i + e], c, -mc[e >> 1]));
          sc[4 * i + e] = p;
          if constexpr (kSum == kSumP) {
            rs[e >> 1][i & 1] += p;
          } else if constexpr (kSum != kSumFold) {
            rs[e >> 1][i & 1] += round16<T>(p);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (kSum == kSumTile) {
        // The tile's whole row sum, rounded as the TPU kernel rounds the
        // sum of its 16-bit block (flash_tt3.py:68-69).
        float s = rs[r][0] + rs[r][1];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        l_run[r] = l_run[r] * alpha[r] + round16<T>(s);
      } else if constexpr (kSum != kSumFold) {
        l_run[r] = l_run[r] * alpha[r] + (rs[r][0] + rs[r][1]);
      }
    }
  }

  // O·alpha, skipped where every row of the warp kept its max (alpha is 1
  // exactly then), as it mostly does after the first tiles.
  __device__ __forceinline__ void rescale(const float (&alpha)[2]) {
    if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
  }

  static __device__ __forceinline__ void to_p(const float (&sc)[N / 2],
                                              uint32_t (&pa)[N / 16][4]) {
#pragma unroll
    for (int kt = 0; kt < N / 16; ++kt) {
      pa[kt][0] = Ops<T>::pack(sc[8 * kt], sc[8 * kt + 1]);
      pa[kt][1] = Ops<T>::pack(sc[8 * kt + 2], sc[8 * kt + 3]);
      pa[kt][2] = Ops<T>::pack(sc[8 * kt + 4], sc[8 * kt + 5]);
      pa[kt][3] = Ops<T>::pack(sc[8 * kt + 6], sc[8 * kt + 7]);
    }
  }

  // 1/l of rows g and g + 8: the quad's partial sums added, or the whole
  // row's (kSumTile), or O's last column DP - 1, held by the quad's last
  // thread (kSumFold: a register known at compile time; picking column d
  // at run time put O on the stack and serialised the wgmma, C7514).
  __device__ __forceinline__ void inv_l(float (&inv)[2], int d) const {
    if constexpr (kSum == kSumFold) {
      const int last = (threadIdx.x % 32) | 3;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        inv[r] = 1.f / __shfl_sync(0xffffffffu, o[DP / 2 - 3 + 2 * r], last);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        if constexpr (kSum != kSumTile) {
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
        }
        inv[r] = 1.f / l;
      }
    }
  }

  // O·(1/l) into rows row0 .. row0 + 63 of one head's [S, d] output (rows
  // >= sq dropped), two 16-bit columns a store.
  __device__ __forceinline__ void store(T* out, int row0, int sq, int d,
                                        int warp, int g) {
    float inv[2];
    inv_l(inv, d);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + warp * 16 + g + 8 * r;
      if (row >= sq) continue;
      T* dst = out + (size_t)row * d;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int col = 8 * i + 2 * tq;
        if (col < d) {   // d is a multiple of 8: col + 1 < d too
          *reinterpret_cast<uint32_t*>(dst + col) = Ops<T>::pack(
              o[4 * i + 2 * r] * inv[r], o[4 * i + 2 * r + 1] * inv[r]);
        }
      }
    }
  }

  // O·(1/l) transposed into `tile`, [DP][64 q] as a [D, S] box lies
  // (Gt's swizzle), for a TMA store of its first d rows; the caller
  // fences and syncs the warpgroup before the store.
  __device__ __forceinline__ void stage_ds(unsigned char* tile, int d,
                                           int warp, int g) {
    float inv[2];
    inv_l(inv, d);
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        *reinterpret_cast<T*>(
            tile + Gt::offset(8 * i + 2 * tq + (e & 1),
                              warp * 16 + g + 8 * (e >> 1), DP)) =
            Ops<T>::cast(o[4 * i + e] * inv[e >> 1]);
      }
    }
  }
};

// ---------------------------------------------------------------- T3 kernel

template <typename T, int DP>
__global__ void __launch_bounds__((PipelinedTiling<DP>::kConsumers + 1) * 128,
                                  1)
    pipelined_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          T* __restrict__ out, int sq, int skv, int d,
                          float scale) {
  using L = PipelinedTiling<DP>;
  using G = typename L::G;
  constexpr int C = L::kConsumers, S = L::kStages, kPitch = kPitchOf<DP>;
  static_assert(C == 2 || C == 3, "consumers");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + S;

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows * C;
  const int n = skv / kKv;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], C);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    sm90::regs_dec<Regs<C>::kProducer>();
    if (threadIdx.x == 0) {
      sm90::prefetch_map(&tm_q);
      sm90::prefetch_map(&tm_k);
      sm90::prefetch_map(&tm_v);
      sm90::mbar_expect_tx(q_full, C * L::kQ);
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int sl = 0; sl < G::kSlabs; ++sl) {
          sm90::tma_load_3d(smem + c * L::kQ + sl * kRows * kPitch, &tm_q,
                            q_full, sl * G::kSlabCols, q0 + c * kRows, bh);
        }
      }
      for (int j = 0; j < n; ++j) {
        const int s = j % S;
        if (j >= S) sm90::mbar_wait(&kv_empty[s], ((j / S) & 1) ^ 1);
        sm90::mbar_expect_tx(&kv_full[s], 2 * L::kTile);
        unsigned char* sk = smem + L::kK + s * L::kTile;
        unsigned char* sv = smem + L::kV + s * L::kTile;
#pragma unroll
        for (int sl = 0; sl < G::kSlabs; ++sl) {
          sm90::tma_load_3d(sk + sl * kKv * kPitch, &tm_k, &kv_full[s],
                            sl * G::kSlabCols, j * kKv, bh);
        }
#pragma unroll
        for (int sl = 0; sl < G::kSlabs; ++sl) {
          sm90::tma_load_3d(sv + sl * kKv * kPitch, &tm_v, &kv_full[s],
                            sl * G::kSlabCols, j * kKv, bh);
        }
      }
    }
    return;
  }

  // Consumer warpgroup cw: q rows q0 + 64·cw ... + 63.
  sm90::regs_inc<Regs<C>::kConsumer>();
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int g = (t % 32) / 4;
  unsigned char* s_q = smem + cw * L::kQ;
  Rows<T, DP> st(t);
  float sa[kKv / 2], sb[kKv / 2];
  uint32_t pa[kKv / 16][4];
  float alpha[2];
  Stamps stamp(cw);
  auto issue_s = [&](float (&acc)[kKv / 2], int j) {
    stamp(1, kIssue);
    sm90::mbar_wait(&kv_full[j % S], (j / S) & 1);
    stamp(1, kTile);
    sm90::wgmma_fence();
    st.issue_s(acc, s_q, smem + L::kK + (j % S) * L::kTile);
    sm90::wgmma_commit();
  };
  auto issue_pv = [&](int j) {
    sm90::fence_regs(st.o);
    sm90::wgmma_fence();
    st.issue_pv(pa, smem + L::kV + (j % S) * L::kTile);
    sm90::wgmma_commit();
  };
  // P_j·V_j has completed (and S_j long before): the stage goes back.
  auto release = [&](int j) {
    if (t == 0) sm90::mbar_arrive(&kv_empty[j % S]);
  };
  // Every wgmma is issued and waited for in straight-line code (no wgmma
  // under a branch of its own), so that ptxas can see which one a wait
  // retires; a conditional issue made it serialise them all (C7514).
  // Tile j (1 <= j < n - 1): in this consumer's turn P_{j-1}·V_{j-1} and
  // S_{j+1} into `nxt`; the softmax of S_j (in `cur`, complete) while both
  // are on the tensor cores; then O and P.
  auto mid = [&](float (&cur)[kKv / 2], float (&nxt)[kKv / 2], int j) {
    stamp(1, kOther);
    Turns<C>::wait(cw);
    stamp(1, kTurn);
    issue_pv(j - 1);
    issue_s(nxt, j + 1);
    Turns<C>::pass(cw);
    stamp(1, kIssue);
    st.softmax(cur, alpha);
    stamp(1, kSoftmax);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(nxt);
    sm90::fence_regs(st.o);
    sm90::fence_regs(pa);
    stamp(1, kWaitAll);
    release(j - 1);
    st.rescale(alpha);
    Rows<T, DP>::to_p(cur, pa);
    stamp(1, kTail);
  };
  // The last tile, n - 1 >= 1: no score left to issue.
  auto last = [&](float (&cur)[kKv / 2], int j) {
    Turns<C>::wait(cw);
    issue_pv(j - 1);
    Turns<C>::pass(cw);
    st.softmax(cur, alpha);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st.o);
    sm90::fence_regs(pa);
    release(j - 1);
    st.rescale(alpha);
    Rows<T, DP>::to_p(cur, pa);
  };

  if (cw == C - 1) sm90::named_arrive<4>(256);   // opens consumer 0's turn
  sm90::mbar_wait(q_full, 0);
  scale_q<T>(s_q, L::kQ, round16<T>(scale), t);
  sm90::consumer_sync<C>(cw);
  // Tile 0: S_0 (and S_1), the softmax of S_0 beside S_1.
  Turns<C>::wait(cw);
  if (n > 1) {
    issue_s(sa, 0);
    issue_s(sb, 1);
    Turns<C>::pass(cw);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sa);
    st.softmax(sa, alpha);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sb);
    Rows<T, DP>::to_p(sa, pa);
    // S_j lives in sa for even j, sb for odd j.
    int j = 1;
    for (; j + 2 < n; j += 2) {
      mid(sb, sa, j);
      mid(sa, sb, j + 1);
    }
    if (j + 2 == n) {
      mid(sb, sa, j);
      last(sa, j + 1);
    } else {
      last(sb, j);
    }
  } else {
    issue_s(sa, 0);
    Turns<C>::pass(cw);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sa);
    st.softmax(sa, alpha);
    Rows<T, DP>::to_p(sa, pa);
  }
  // The last product; the last consumer's arrival would open a turn no one
  // takes.
  Turns<C>::wait(cw);
  issue_pv(n - 1);
  if (cw != C - 1) Turns<C>::pass(cw);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(st.o);
  sm90::fence_regs(pa);
  release(n - 1);
  st.store(out + (size_t)bh * sq * d, q0 + cw * kRows, sq, d, warp, g);
  stamp(1, kOther);
}

// ---------------------------------------------------------------- T2 kernel

template <typename T, int DP>
__global__ void __launch_bounds__((HeadsTiling<DP>::kConsumers + 1) * 128, 1)
    heads_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      T* __restrict__ out, int heads, int sq, int skv, int d,
                      float scale, int parts) {
  using L = HeadsTiling<DP>;
  using G = typename L::G;
  constexpr int C = L::kConsumers, S = L::kStages, QB = L::kQBufs,
                kPitch = kPitchOf<DP>;
  static_assert(C == 2 || C == 3, "consumers");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  // Consumer c's barriers: full[S], empty[S], q_full[QB], q_empty[QB],
  // part_full, part_free.
  auto bars = [&](int c) {
    return reinterpret_cast<uint64_t*>(smem + L::bars(c));
  };

  const int wg = threadIdx.x / 128;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  // The kv split: cluster rank blockIdx.z takes tiles [t0, t1).
  const int rank = blockIdx.z;
  const int n_all = skv / kKv;
  const int per = (n_all + parts - 1) / parts;
  const int t0 = rank * per;
  const int n = min(n_all, t0 + per) - t0;

  if (threadIdx.x == 0) {
    for (int c = 0; c < C; ++c) {
      uint64_t* bar = bars(c);
      for (int i = 0; i < 2 * S + 2 * QB; ++i) sm90::mbar_init(&bar[i], 1);
      sm90::mbar_init(&bar[2 * S + 2 * QB], max(parts - 1, 1));
      sm90::mbar_init(&bar[2 * S + 2 * QB + 1], 1);
    }
    sm90::fence_barrier_init();
  }
  if (parts > 1) {
    sm90::cluster_sync();
  } else {
    __syncthreads();
  }

  if (wg == 0) {
    // Producer: lane 0 of warp c feeds consumer c, head after head.
    sm90::regs_dec<Regs<C>::kProducer>();
    const int c = threadIdx.x / 32;
    if (c >= C || threadIdx.x % 32 != 0) return;
    if (c == 0) {
      sm90::prefetch_map(&tm_q);
      sm90::prefetch_map(&tm_k);
      sm90::prefetch_map(&tm_v);
    }
    uint64_t* full = bars(c);
    uint64_t* empty = full + S;
    uint64_t* q_full = empty + S;
    uint64_t* q_empty = q_full + QB;
    int ring = 0;   // tiles loaded into this ring so far
    int r = 0;   // this consumer's heads so far
    for (int h = c; h < heads; h += C, ++r) {
      const int plane = b * heads + h;
      const int qb = r % QB;
      if (r >= QB) sm90::mbar_wait(&q_empty[qb], ((r / QB) & 1) ^ 1);
      sm90::mbar_expect_tx(&q_full[qb], L::kQ);
      unsigned char* s_q = smem + L::q_tile(c, qb);
#pragma unroll
      for (int sl = 0; sl < G::kSlabs; ++sl) {
        sm90::tma_load_3d(s_q + sl * kRows * kPitch, &tm_q, &q_full[qb],
                          sl * G::kSlabCols, q0, plane);
      }
      for (int j = t0; j < t0 + n; ++j, ++ring) {
        const int s = ring % S;
        if (ring >= S) sm90::mbar_wait(&empty[s], ((ring / S) & 1) ^ 1);
        sm90::mbar_expect_tx(&full[s], 2 * L::kTile);
        unsigned char* sk = smem + L::k_tile(c, s);
        unsigned char* sv = smem + L::v_tile(c, s);
#pragma unroll
        for (int sl = 0; sl < G::kSlabs; ++sl) {
          sm90::tma_load_3d(sk + sl * kKv * kPitch, &tm_k, &full[s],
                            sl * G::kSlabCols, j * kKv, plane);
        }
#pragma unroll
        for (int sl = 0; sl < G::kSlabs; ++sl) {
          sm90::tma_load_3d(sv + sl * kKv * kPitch, &tm_v, &full[s],
                            sl * G::kSlabCols, j * kKv, plane);
        }
      }
    }
    return;
  }

  // Consumer warpgroup c: heads c, c + C, ... of q rows q0 ... q0 + 63.
  sm90::regs_inc<Regs<C>::kConsumer>();
  const int c = wg - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int g = (t % 32) / 4;
  uint64_t* full = bars(c);
  uint64_t* empty = full + S;
  uint64_t* q_full = empty + S;
  uint64_t* q_empty = q_full + QB;
  uint64_t* part_full = q_empty + QB;
  uint64_t* part_free = part_full + 1;
  float4* part = reinterpret_cast<float4*>(smem + L::part(c));

  Rows<T, DP> st(t);
  float sc[kKv / 2];
  uint32_t pa[kKv / 16][4];
  float alpha[2];
  // Every consumer takes the turns of the most heads any consumer has,
  // n + 1 a head, so that the ping-pong's barrier phases all complete.
  const int rounds = (heads + C - 1) / C * (n + 1);
  int round = 0;
  auto my_turn = [&] { Turns<C>::wait(c); };
  auto next_turn = [&] {
    ++round;
    if (round < rounds || c != C - 1) Turns<C>::pass(c);
  };
  Stamps stamp(c);
  // The ring's i-th tile (counted over every head of this consumer).
  auto issue_s = [&](const unsigned char* s_q, int i) {
    stamp(0, kIssue);
    sm90::mbar_wait(&full[i % S], (i / S) & 1);
    stamp(0, kTile);
    sm90::wgmma_fence();
    st.issue_s(sc, s_q, smem + L::k_tile(c, i % S));
    sm90::wgmma_commit();
  };
  auto issue_pv = [&](int i) {
    sm90::fence_regs(st.o);
    sm90::wgmma_fence();
    st.issue_pv(pa, smem + L::v_tile(c, i % S));
    sm90::wgmma_commit();
  };
  // After P·V of the ring's i-th tile has completed: its stage goes back.
  auto pv_done = [&](int i) {
    sm90::fence_regs(st.o);
    sm90::fence_regs(pa);
    if (t == 0) sm90::mbar_arrive(&empty[i % S]);
  };

  if (c == C - 1) sm90::named_arrive<4>(256);   // opens consumer 0's turn
  int ring = 0;   // the ring's tiles consumed so far
  int r = 0;   // this consumer's heads so far
  for (int h = c; h < heads; h += C, ++r) {
    const int qb = r % QB;
    unsigned char* s_q = smem + L::q_tile(c, qb);
    sm90::mbar_wait(&q_full[qb], (r / QB) & 1);
    scale_q<T>(s_q, L::kQ, round16<T>(scale), t);
    sm90::consumer_sync<C>(c);
    // Once S of the head's last tile has completed, its Q tile goes back.
    auto q_done = [&] {
      if (t == 0) sm90::mbar_arrive(&q_empty[qb]);
    };
    // K1's schedule: S_0, then per tile S_j and P_{j-1}·V_{j-1} together,
    // the softmax of S_j while that product is on the tensor cores.
    stamp(0, kOther);
    my_turn();
    stamp(0, kTurn);
    issue_s(s_q, ring);
    next_turn();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    if (n == 1) q_done();
    st.softmax(sc, alpha);
    Rows<T, DP>::to_p(sc, pa);
    for (int j = 1; j < n; ++j) {
      stamp(0, kOther);
      my_turn();
      stamp(0, kTurn);
      issue_s(s_q, ring + j);
      issue_pv(ring + j - 1);
      next_turn();
      stamp(0, kIssue);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      stamp(0, kWaitS);
      if (j == n - 1) q_done();
      st.softmax(sc, alpha);
      stamp(0, kSoftmax);
      sm90::wgmma_wait<0>();
      pv_done(ring + j - 1);
      stamp(0, kWaitAll);
      st.rescale(alpha);
      Rows<T, DP>::to_p(sc, pa);
      stamp(0, kTail);
    }
    my_turn();
    issue_pv(ring + n - 1);
    next_turn();
    sm90::wgmma_wait<0>();
    pv_done(ring + n - 1);
    ring += n;

    if (parts > 1 && rank > 0) {
      // This part of the head: (o, m, l) into this block's merge buffer
      // once rank 0 has read the last head's, then rank 0 is told.
      if (r > 0) mbar_wait_cluster(part_free, (r - 1) & 1);
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        part[i * 128 + t] = make_float4(st.o[4 * i], st.o[4 * i + 1],
                                        st.o[4 * i + 2], st.o[4 * i + 3]);
      }
      part[(DP / 8) * 128 + t] =
          make_float4(st.m_run[0], st.m_run[1], st.l_run[0], st.l_run[1]);
      // One arrival for the warpgroup (128 remote arrivals on one barrier
      // serialise): the barrier orders every thread's writes before it.
      sm90::consumer_sync<C>(c);
      if (t == 0) mbar_arrive_cluster(sm90::map_rank(part_full, 0));
    } else {
      if (parts > 1) {
        // Merge the other ranks' parts into this one's, in rank order.
        mbar_wait_cluster(part_full, r & 1);
        float4 ml[4];
        float m[2] = {st.m_run[0], st.m_run[1]};
#pragma unroll
        for (int p = 1; p < 4; ++p) {
          if (p < parts) {
            ml[p] = ld_dsmem(sm90::map_rank(part + (DP / 8) * 128 + t, p));
          }
        }
#pragma unroll
        for (int p = 1; p < 4; ++p) {
          if (p < parts) {
            m[0] = fmaxf(m[0], ml[p].x);
            m[1] = fmaxf(m[1], ml[p].y);
          }
        }
        float a[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          a[rr] = sm90::ex2(__fmul_rn(st.m_run[rr] - m[rr], kLog2e));
          st.l_run[rr] *= a[rr];
        }
#pragma unroll
        for (int i = 0; i < DP / 8; ++i) {
          st.o[4 * i] *= a[0];
          st.o[4 * i + 1] *= a[0];
          st.o[4 * i + 2] *= a[1];
          st.o[4 * i + 3] *= a[1];
        }
#pragma unroll
        for (int p = 1; p < 4; ++p) {
          if (p < parts) {
            a[0] = sm90::ex2(__fmul_rn(ml[p].x - m[0], kLog2e));
            a[1] = sm90::ex2(__fmul_rn(ml[p].y - m[1], kLog2e));
            st.l_run[0] += ml[p].z * a[0];
            st.l_run[1] += ml[p].w * a[1];
            float4 x[DP / 8];
#pragma unroll
            for (int i = 0; i < DP / 8; ++i) {
              x[i] = ld_dsmem(sm90::map_rank(part + i * 128 + t, p));
            }
#pragma unroll
            for (int i = 0; i < DP / 8; ++i) {
              st.o[4 * i] += x[i].x * a[0];
              st.o[4 * i + 1] += x[i].y * a[0];
              st.o[4 * i + 2] += x[i].z * a[1];
              st.o[4 * i + 3] += x[i].w * a[1];
            }
          }
        }
        sm90::consumer_sync<C>(c);   // every thread has read the parts
        if (t == 0) {
#pragma unroll
          for (int p = 1; p < 4; ++p) {
            if (p < parts) mbar_arrive_cluster(sm90::map_rank(part_free, p));
          }
        }
      }
      st.store(out + (size_t)(b * heads + h) * sq * d, q0, sq, d, warp, g);
    }
    st.reset();
  }
  // Turns this consumer has no head for.
  while (round < rounds) {
    my_turn();
    next_turn();
  }
  // A block leaves only once rank 0 has read its last part.
  if (parts > 1 && rank > 0 && r > 0) {
    mbar_wait_cluster(part_free, (r - 1) & 1);
  }
  stamp(0, kOther);
}

// -------------------------------------------------------------- T1/T6 kernel

// Named barrier kId + i (i < kCount; immediates, as sm90::named_barrier's)
// among `threads` threads: synced on, or arrived on without waiting.
template <int kId, int kCount>
__device__ __forceinline__ void sync_nth(int i, int threads) {
  if (i == 0) {
    sm90::named_barrier<kId>(threads);
  } else if constexpr (kCount > 1) {
    sync_nth<kId + 1, kCount - 1>(i - 1, threads);
  }
}
template <int kId, int kCount>
__device__ __forceinline__ void arrive_nth(int i, int threads) {
  if (i == 0) {
    sm90::named_arrive<kId>(threads);
  } else if constexpr (kCount > 1) {
    arrive_nth<kId + 1, kCount - 1>(i - 1, threads);
  }
}

// The barriers of C chains (1, 2 or 4 consumers): consumer cw's own 128
// threads sync on 1 + cw; its turn to issue (sm90::Turns' ping-pong, for C
// consumers) is barrier 1 + C + cw, which it waits on and the consumer
// before it arrives on.
template <int C>
struct ChainBars {
  static __device__ __forceinline__ void sync(int cw) {
    sync_nth<1, C>(cw, 128);
  }
  static __device__ __forceinline__ void wait_turn(int cw) {
    sync_nth<1 + C, C>(cw, 256);
  }
  static __device__ __forceinline__ void pass_turn(int cw) {
    arrive_nth<1 + C, C>(cw + 1 == C ? 0 : cw + 1, 256);
  }
};

template <typename T, int DP, int Cfg, typename F>
__global__ void __launch_bounds__(ChainsTiling<DP, Cfg, F>::kThreads,
                                  ChainsTiling<DP, Cfg, F>::kBlocks)
    chains_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       T* __restrict__ out, int sq, int skv, int d,
                       float qscale, float c, int parts, int q_bytes,
                       int kv_bytes) {
  using L = ChainsTiling<DP, Cfg, F>;
  using G = typename L::G;
  using R = Rows<T, DP, L::kN, F>;
  constexpr int C = L::kChains, S = L::kStages, N = L::kN,
                kPitch = kPitchOf<DP>;
  static_assert(C == 1 || C == 2 || C == 4, "chains");
  static_assert(L::kOffered, "chains tiling not offered for this form");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + S;

  const int cw = threadIdx.x / 128;   // consumer warpgroup
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int g = (t % 32) / 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows * C;
  // Over [D, S] a plane's columns are runs of sq q (o) and skv K/V columns
  // (one run for T4/T5, B for the channel-major K1, flash_attention_ds_sm90):
  // this block's q tile lies in run q0 / sq and reads that run's K/V.
  const int kv0 = F::kDS ? q0 / sq * skv : 0;
  // The kv split: cluster rank blockIdx.z takes tiles [t0, t0 + n).
  const int rank = blockIdx.z;
  const int n_all = skv / N;
  const int per = (n_all + parts - 1) / parts;
  const int t0 = rank * per;
  const int n = min(n_all, t0 + per) - t0;
  // The producer warp: warp 0 of the last consumer, which in each round
  // issues its wgmma last. Its lanes issue the boxes of a K/V tile at once.
  const bool producer = cw == C - 1 && warp == 0;

  // Tile j of this block's range into its stage: one lane expects the
  // bytes, lanes 0 .. 2·slabs − 1 load one K or V box each (over [D, S]
  // lanes 0 and 1: one box of 64 columns by d rows each).
  auto load = [&](int j) {
    const int s = j % S;
    if (lane == 0) sm90::mbar_expect_tx(&kv_full[s], 2 * kv_bytes);
    if constexpr (F::kDS) {
      if (lane < 2) {
        sm90::tma_load_3d(smem + (lane ? L::kV : L::kK) + s * L::kTile,
                          lane ? &tm_v : &tm_k, &kv_full[s],
                          kv0 + (t0 + j) * N, 0, bh);
      }
    } else if (lane < 2 * G::kSlabs) {
      const int sl = lane % G::kSlabs;
      const bool is_v = lane >= G::kSlabs;
      sm90::tma_load_3d(smem + (is_v ? L::kV : L::kK) + s * L::kTile +
                            sl * N * kPitch,
                        is_v ? &tm_v : &tm_k, &kv_full[s],
                        sl * G::kSlabCols, (t0 + j) * N, bh);
    }
  };

  if (producer && lane == 0) {
    sm90::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(&kv_full[s], 1);
      sm90::mbar_init(&kv_empty[s], C);
    }
    sm90::fence_barrier_init();
  }
  if (kv_bytes < L::kTile) {
    // Boxes of d columns (over [D, S] d rows) leave the tiles' last
    // columns (rows) to DP unwritten: zeros once, which the wgmma read
    // (and TMA never overwrites). With the fold (DP > d), V's last row
    // DP - 1 in every stage is then all ones, so column DP - 1 of P·V is
    // Σ round16(p).
    for (int i = threadIdx.x; i < L::kBars / 16; i += L::kThreads) {
      uint32_t w = 0;
      if constexpr (F::kSum == kSumFold) {
        const int at = i * 16 - L::kV;   // into the V stages
        if (at >= 0 && at % L::kTile / 128 == DP - 1) {
          w = Ops<T>::pack(1.f, 1.f);
        }
      }
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(w, w, w, w);
    }
    sm90::fence_proxy_async();
  }
  __syncthreads();
  if (producer) {
    if (lane == 0) {
      sm90::prefetch_map(&tm_q);
      sm90::prefetch_map(&tm_k);
      sm90::prefetch_map(&tm_v);
      sm90::mbar_expect_tx(q_full, C * q_bytes);
    }
    if constexpr (F::kDS) {
      if (lane < C) {
        sm90::tma_load_3d(smem + lane * L::kQ, &tm_q, q_full,
                          q0 + lane * kRows, 0, bh);
      }
    } else if (lane < C * G::kSlabs) {
      const int w = lane / G::kSlabs, sl = lane % G::kSlabs;
      sm90::tma_load_3d(smem + w * L::kQ + sl * kRows * kPitch, &tm_q,
                        q_full, sl * G::kSlabCols, q0 + w * kRows, bh);
    }
    for (int j = 0; j < S && j < n; ++j) load(j);
  }
  __syncwarp();

  unsigned char* s_q = smem + cw * L::kQ;
  R st(t);
  float sc[N / 2];
  uint32_t pa[N / 16][4];
  float alpha[2];
  Stamps stamp(cw);
  auto my_turn = [&] {
    if constexpr (C > 1) ChainBars<C>::wait_turn(cw);
  };
  // The last consumer's last arrival would open a turn no one takes.
  auto next_turn = [&](bool last) {
    if constexpr (C > 1) {
      if (!last || cw != C - 1) ChainBars<C>::pass_turn(cw);
    }
  };
  auto issue_s = [&](int j) {
    sm90::mbar_wait(&kv_full[j % S], (j / S) & 1);
    stamp(2, kTile);
    sm90::wgmma_fence();
    R::issue_s(sc, s_q, smem + L::kK + (j % S) * L::kTile);
    sm90::wgmma_commit();
  };
  auto issue_pv = [&](int j) {
    sm90::fence_regs(st.o);
    sm90::wgmma_fence();
    st.issue_pv(pa, smem + L::kV + (j % S) * L::kTile);
    sm90::wgmma_commit();
  };
  // After P_j·V_j has completed: the stage goes back, and the producer
  // warp refills it with tile j + S once every consumer has released it
  // (at once with one consumer: its own release is the last).
  auto pv_done = [&](int j) {
    sm90::fence_regs(st.o);
    sm90::fence_regs(pa);
    if constexpr (C > 1) {
      if (t == 0) sm90::mbar_arrive(&kv_empty[j % S]);
    }
    if (producer && j + S < n) {
      if constexpr (C > 1) {
        if (lane == 0) sm90::mbar_wait(&kv_empty[j % S], (j / S) & 1);
        __syncwarp();
      }
      load(j + S);
    }
    __syncwarp();
  };
  // Kv tile j >= 1: S_j and P_{j-1}·V_{j-1} issued together in this
  // consumer's turn, the softmax of S_j while P_{j-1}·V_{j-1} is on the
  // tensor cores, O rescaled once that product is done. Each wgmma is
  // issued and waited for in this straight-line code.
  auto tile = [&](int j) {
    stamp(2, kOther);
    my_turn();
    stamp(2, kTurn);
    issue_s(j);
    issue_pv(j - 1);
    next_turn(false);
    stamp(2, kIssue);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(sc);
    stamp(2, kWaitS);
    st.softmax(sc, alpha, c);
    stamp(2, kSoftmax);
    sm90::wgmma_wait<0>();
    pv_done(j - 1);
    stamp(2, kWaitAll);
    st.rescale(alpha);
    R::to_p(sc, pa);
    stamp(2, kTail);
  };

  if constexpr (C > 1) {
    if (cw == C - 1) arrive_nth<1 + C, C>(0, 256);   // consumer 0's turn
  }
  stamp(2, kOther);
  sm90::mbar_wait(q_full, 0);
  scale_q<T>(s_q, L::kQ, round16<T>(qscale), t);
  ChainBars<C>::sync(cw);
  my_turn();
  issue_s(0);
  next_turn(false);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  st.softmax(sc, alpha, c);
  R::to_p(sc, pa);
  if constexpr (L::kUnroll) {
    // vU: two tiles a turn of the loop, so the compiler sees both.
    int j = 1;
    for (; j + 1 < n; j += 2) {
      tile(j);
      tile(j + 1);
    }
    if (j < n) tile(j);
  } else {
    for (int j = 1; j < n; ++j) tile(j);
  }
  stamp(2, kOther);
  my_turn();
  issue_pv(n - 1);
  next_turn(true);
  sm90::wgmma_wait<0>();
  pv_done(n - 1);

  T* dst = out + (size_t)bh * sq * d;
  // The rows of this consumer into the output: over [S, D] from registers;
  // over [D, S] staged transposed in its own Q tile (no wgmma reads it
  // any more) and stored by one TMA box of 64 columns by d rows, so no
  // padded row (the fold's ones among them) is written.
  auto store = [&] {
    if constexpr (F::kDS) {
      unsigned char* box = smem + cw * L::kQ;
      st.stage_ds(box, d, warp, g);
      sm90::fence_proxy_async();
      ChainBars<C>::sync(cw);
      if (t == 0) {
        sm90::tma_store_3d(&tm_o, box, q0 + cw * kRows, 0, bh);
        sm90::tma_store_commit_and_wait();
      }
    } else {
      st.store(dst, q0 + cw * kRows, sq, d, warp, g);
    }
  };
  if (parts > 1) {
    // The split's merge, as T2's: once every consumer of the block is done
    // with its tiles, ranks 1.. leave (o, m, l) where Q and the ring were,
    // a float4 per thread and index, and rank 0 reads them through
    // distributed shared memory and merges them in rank order.
    float4* part = reinterpret_cast<float4*>(smem) + cw * 128 * L::kMergeF4;
    __syncthreads();
    if (rank > 0) {
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        part[i * 128 + t] = make_float4(st.o[4 * i], st.o[4 * i + 1],
                                        st.o[4 * i + 2], st.o[4 * i + 3]);
      }
      part[(DP / 8) * 128 + t] =
          make_float4(st.m_run[0], st.m_run[1], st.l_run[0], st.l_run[1]);
    }
    sm90::cluster_sync();
    if (rank == 0) {
      float m[2] = {st.m_run[0], st.m_run[1]};
      for (int p = 1; p < parts; ++p) {
        const float4 ml = ld_dsmem(sm90::map_rank(part + (DP / 8) * 128 + t,
                                                  p));
        m[0] = fmaxf(m[0], ml.x);
        m[1] = fmaxf(m[1], ml.y);
      }
      float a[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        a[r] = sm90::ex2(__fmul_rn(st.m_run[r] - m[r], c));
        st.l_run[r] *= a[r];
      }
      st.rescale(a);
      for (int p = 1; p < parts; ++p) {
        const float4 ml = ld_dsmem(sm90::map_rank(part + (DP / 8) * 128 + t,
                                                  p));
        a[0] = sm90::ex2(__fmul_rn(ml.x - m[0], c));
        a[1] = sm90::ex2(__fmul_rn(ml.y - m[1], c));
        st.l_run[0] += ml.z * a[0];
        st.l_run[1] += ml.w * a[1];
#pragma unroll
        for (int i = 0; i < DP / 8; ++i) {
          const float4 x = ld_dsmem(sm90::map_rank(part + i * 128 + t, p));
          st.o[4 * i] += x.x * a[0];
          st.o[4 * i + 1] += x.y * a[0];
          st.o[4 * i + 2] += x.z * a[1];
          st.o[4 * i + 3] += x.w * a[1];
        }
      }
      store();
    }
    sm90::cluster_sync();   // no block leaves before rank 0 has read it
  } else {
    store();
  }
  stamp(2, kOther);
}

// ------------------------------------------------------------- the launches

// Q's map in 64-row boxes, K's and V's in N-row ones, each box `box`
// columns (a slab's by default).
template <typename T, int DP, int N = kKv>
bool encode_maps(CUtensorMap* tm_q, CUtensorMap* tm_k, CUtensorMap* tm_v,
                 const void* q, const void* k, const void* v, int planes,
                 int sq, int skv, int d,
                 int box = Geometry<kPitchOf<DP>, DP>::kSlabCols) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kPitch = kPitchOf<DP>;
  return sm90::encode_slab_map(tm_q, q, kBf16, planes, sq, d, kRows, box,
                               kPitch) &&
         sm90::encode_slab_map(tm_k, k, kBf16, planes, skv, d, N, box,
                               kPitch) &&
         sm90::encode_slab_map(tm_v, v, kBf16, planes, skv, d, N, box,
                               kPitch);
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  }
  return err;
}

template <typename T, int DP>
int launch_pipelined(const void* q, const void* k, const void* v, void* o,
                     int batch, int heads, int sq, int skv, int d,
                     float scale, int parts, cudaStream_t stream) {
  using L = PipelinedTiling<DP>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (parts != 1 || !encode_maps<T, DP>(&tm_q, &tm_k, &tm_v, q, k, v,
                                         batch * heads, sq, skv, d)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = pipelined_sm90_kernel<T, DP>;
  cudaError_t err = prepare(kernel, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  const int block_q = kRows * L::kConsumers;
  const dim3 grid((sq + block_q - 1) / block_q, batch * heads);
  kernel<<<grid, (L::kConsumers + 1) * 128, L::kBytes, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(o), sq, skv, d, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_heads(const void* q, const void* k, const void* v, void* o,
                 int batch, int heads, int sq, int skv, int d, float scale,
                 int parts, cudaStream_t stream) {
  using L = HeadsTiling<DP>;
  const int n_all = skv / kKv;
  const int per = (n_all + parts - 1) / parts;
  // parts 1, 2 or 4, each part at least one tile, a split only where the
  // merge buffers fit.
  if ((parts != 1 && parts != 2 && parts != 4) ||
      (parts > 1 && !L::kSplit) || (parts - 1) * per >= n_all) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_maps<T, DP>(&tm_q, &tm_k, &tm_v, q, k, v, batch * heads, sq,
                          skv, d)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = heads_sm90_kernel<T, DP>;
  cudaError_t err = prepare(kernel, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = parts;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sq / kRows, batch, parts);
  cfg.blockDim = dim3((L::kConsumers + 1) * 128);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = parts > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, tm_q, tm_k, tm_v, static_cast<T*>(o),
                           heads, sq, skv, d, scale, parts);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// [D, S] maps over [B·H, d, S] for Q, K, V and O, each box 64 columns
// (one 128-byte swizzle span) by d rows.
inline bool encode_ds_maps(CUtensorMap* tm_q, CUtensorMap* tm_k,
                           CUtensorMap* tm_v, CUtensorMap* tm_o,
                           const void* q, const void* k, const void* v,
                           const void* o, bool bf16, int planes, int sq,
                           int skv, int d) {
  return sm90::encode_slab_map(tm_q, q, bf16, planes, d, sq, d, kKv, 128) &&
         sm90::encode_slab_map(tm_k, k, bf16, planes, d, skv, d, kKv, 128) &&
         sm90::encode_slab_map(tm_v, v, bf16, planes, d, skv, d, kKv, 128) &&
         sm90::encode_slab_map(tm_o, o, bf16, planes, d, sq, d, kKv, 128);
}

// Chains kernel kind Kind (ChainKind): q scaled by round16(qscale), p =
// 2^(s·c − m·c); the kv range split over a cluster of `parts` (1, 2 or 4)
// blocks. T1/T6 take [B, H, S, D] tensors, T4/T5 [B, H, D, S] ones; a
// [D, S] kind also takes `batches` runs of sq (skv) columns a plane
// ([H, D, B, S]: batch·heads = H planes of B runs).
template <typename T, int DP, int Kind>
int launch_chains(const void* q, const void* k, const void* v, void* o,
                  int batch, int heads, int sq, int skv, int d, float qscale,
                  float c, int parts, int batches, cudaStream_t stream) {
  using F = typename ChainKind<Kind>::F;
  using L = ChainsTiling<DP, ChainKind<Kind>::kCfg, F>;
  using G = typename L::G;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int block_q = kRows * L::kChains;
  // Up to DP = 64 (one slab) the [S, D] boxes are d columns wide, so that
  // no zero column past d crosses from L2 to the SM; the slab's pitch and
  // swizzle stay, and the kernel zeroes the columns the boxes leave. The
  // [D, S] boxes are d rows: the kernel zeroes the rows to DP.
  const int box = L::kNarrow ? d : G::kSlabCols;
  const int q_bytes = L::kDS ? d * 128 : G::kSlabs * kRows * box * 2;
  const int kv_bytes = L::kDS ? d * 2 * L::kN : G::kSlabs * L::kN * box * 2;
  const int n_all = skv / L::kN;
  const int per = (n_all + parts - 1) / parts;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  // parts 1, 2 or 4, each part at least one tile, a split only where the
  // merge buffers fit.
  if (sq % block_q != 0 || (parts != 1 && parts != 2 && parts != 4) ||
      (parts > 1 && !L::kSplit) || (parts - 1) * per >= n_all ||
      batches < 1 || (batches > 1 && !L::kDS)) {
    return (int)cudaErrorInvalidValue;
  }
  if (L::kDS ? !encode_ds_maps(&tm_q, &tm_k, &tm_v, &tm_o, q, k, v, o, kBf16,
                               batch * heads, batches * sq, batches * skv, d)
             : !encode_maps<T, DP, L::kN>(&tm_q, &tm_k, &tm_v, q, k, v,
                                          batch * heads, sq, skv, d, box)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!L::kDS) tm_o = tm_q;   // unused over [S, D]
  auto kernel = chains_sm90_kernel<T, DP, ChainKind<Kind>::kCfg, F>;
  cudaError_t err = prepare(kernel, L::kBytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = parts;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batches * sq / block_q, batch * heads, parts);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = parts > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, tm_q, tm_k, tm_v, tm_o,
                           static_cast<T*>(o), sq, skv, d, qscale, c, parts,
                           q_bytes, kv_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The [D, S] products alone, the unit check of sm90.cuh's MN-major SS and
// K-major RS wgmma forms: one warpgroup loads q, k and v of one [d, 64]
// plane as T4/T5 load them (rows d..DP-1 zero), takes S = qᵀ·k (64 x 64)
// by Rows::issue_s and O = round16(S)·vᵀ (64 x DP) by Rows::issue_pv, and
// writes both in fp32, row-major.
template <typename T, int DP>
__global__ void __launch_bounds__(128)
    ds_probe_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    float* __restrict__ s_out, float* __restrict__ o_out,
                    int d) {
  using R = Rows<T, DP, kKv, TtExp>;
  constexpr int kTile = DP * 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 3 * kTile);
  const int t = threadIdx.x, warp = t / 32, g = (t % 32) / 4, tq = t % 4;
  for (int i = t; i < 3 * kTile / 16; i += 128) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }
  sm90::fence_proxy_async();
  if (t == 0) {
    sm90::mbar_init(bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (t == 0) {
    sm90::mbar_expect_tx(bar, 3 * d * 128);
    sm90::tma_load_3d(smem, &tm_q, bar, 0, 0, 0);
    sm90::tma_load_3d(smem + kTile, &tm_k, bar, 0, 0, 0);
    sm90::tma_load_3d(smem + 2 * kTile, &tm_v, bar, 0, 0, 0);
  }
  sm90::mbar_wait(bar, 0);
  R st(t);
  float sc[kKv / 2];
  uint32_t pa[kKv / 16][4];
  sm90::wgmma_fence();
  R::issue_s(sc, smem, smem + kTile);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
#pragma unroll
  for (int i = 0; i < kKv / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s_out[(warp * 16 + g + 8 * (e >> 1)) * kKv + 8 * i + 2 * tq + (e & 1)] =
          sc[4 * i + e];
    }
  }
  R::to_p(sc, pa);
  sm90::fence_regs(st.o);
  sm90::wgmma_fence();
  st.issue_pv(pa, smem + 2 * kTile);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(st.o);
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o_out[(warp * 16 + g + 8 * (e >> 1)) * DP + 8 * i + 2 * tq + (e & 1)] =
          st.o[4 * i + e];
    }
  }
}

template <typename T, int DP>
int launch_probe(const void* q, const void* k, const void* v, float* s,
                 float* o, int d, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!sm90::encode_slab_map(&tm_q, q, kBf16, 1, d, kKv, d, kKv, 128) ||
      !sm90::encode_slab_map(&tm_k, k, kBf16, 1, d, kKv, d, kKv, 128) ||
      !sm90::encode_slab_map(&tm_v, v, kBf16, 1, d, kKv, d, kKv, 128)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int kBytes = 3 * DP * 128 + 8 + 1024;
  auto kernel = ds_probe_kernel<T, DP>;
  cudaError_t err = prepare(kernel, kBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 128, kBytes, stream>>>(tm_q, tm_k, tm_v, s, o, d);
  return (int)cudaGetLastError();
}

using ProbeLauncher = int (*)(const void*, const void*, const void*, float*,
                              float*, int, cudaStream_t);
template <typename T, int... W>
ProbeLauncher probe_launcher(int w, std::integer_sequence<int, W...>) {
  constexpr ProbeLauncher kTable[] = {&launch_probe<T, 16 * (W + 1)>...};
  return kTable[w];
}

}  // namespace

using VariantLauncher = int (*)(const void*, const void*, const void*, void*,
                                int, int, int, int, int, float, int,
                                cudaStream_t);
using ChainLauncher = int (*)(const void*, const void*, const void*, void*,
                              int, int, int, int, int, float, float, int, int,
                              cudaStream_t);
namespace flash_variants_sm90 {
// [kernel: 0 T2, 1 T3][dtype][DP / 16 - 1] and [ChainKind][dtype][DP / 16 -
// 1], filled when the library loads (null where a kind is not offered).
extern VariantLauncher launchers[2][2][kMaxWidths];
extern ChainLauncher chain_launchers[kChainKinds][2][kMaxWidths];
#if BUILD_PART == 0
VariantLauncher launchers[2][2][kMaxWidths] = {};
ChainLauncher chain_launchers[kChainKinds][2][kMaxWidths] = {};
#endif
}  // namespace flash_variants_sm90

namespace {

// Unit u = (kernel·2 + dtype)·8 + width index, in part u % BUILD_PARTS;
// T2 and T3 are kernels 0 and 1, chains kind K kernel 2 + K.
// The stamped build (one part) holds only bf16 at the main shapes' widths,
// DP = 48 and 80, and 96 (the fold's at d = 80).
#ifdef FV_STAMPS
template <int DT, int W>
constexpr bool kStamped = DT == 0 && (W == 2 || W == 4 || W == 5);
#else
template <int DT, int W>
constexpr bool kStamped = true;
#endif
template <int K, int DT, int W>
void enter_unit() {
  constexpr int u = (K * 2 + DT) * kMaxWidths + W;
  if constexpr (u % BUILD_PARTS == BUILD_PART && kStamped<DT, W>) {
    using T = std::conditional_t<DT == 0, __nv_bfloat16, __half>;
    constexpr int dp = 16 * (W + 1);
    if constexpr (K < 2) {
      flash_variants_sm90::launchers[K][DT][W] =
          K == 0 ? &launch_heads<T, dp> : &launch_pipelined<T, dp>;
    } else if constexpr (ChainsTiling<dp, ChainKind<K - 2>::kCfg,
                                      typename ChainKind<K - 2>::F>::
                             kOffered) {
      flash_variants_sm90::chain_launchers[K - 2][DT][W] =
          &launch_chains<T, dp, K - 2>;
    }
  }
}

template <int K, int... W>
void enter_kernel(std::integer_sequence<int, W...>) {
  (enter_unit<K, 0, W>(), ...);
  (enter_unit<K, 1, W>(), ...);
}

template <int... K>
bool enter_units(std::integer_sequence<int, K...>) {
  (enter_kernel<K>(std::make_integer_sequence<int, kMaxWidths>{}), ...);
  return true;
}

[[maybe_unused]] const bool kEntered =
    enter_units(std::make_integer_sequence<int, 2 + kChainKinds>{});

}  // namespace

#if BUILD_PART == 0
namespace {

int run(int kernel, const void* q, const void* k, const void* v, void* o,
        int batch, int heads, int sq, int skv, int d, float scale, int dtype,
        int parts, void* stream) {
  const int rows = kernel == 0 ? batch : batch * heads;
  if (dtype < 0 || dtype > 1 || batch < 1 || heads < 1 || rows > 65535 ||
      batch * heads > 65535 || sq < kRows || skv < kKv || sq % kRows != 0 ||
      skv % kKv != 0 || d < 8 || d > 128 || d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const VariantLauncher launch =
      flash_variants_sm90::launchers[kernel][dtype][(d + 15) / 16 - 1];
  if (launch == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  return launch(q, k, v, o, batch, heads, sq, skv, d, scale, parts,
                static_cast<cudaStream_t>(stream));
}

// Chains kernel kind `kind` with natural exp (q scaled by `scale`) or exp2
// (by scale·log2 e, in double as the kept kernels round it); with `fold`
// the head is padded to round16(d + 1), d <= 120.
int run_chains(int kind, bool base2, const void* q, const void* k,
               const void* v, void* o, int batch, int heads, int sq, int skv,
               int d, float scale, int dtype, int parts, bool fold,
               void* stream) {
  if (dtype < 0 || dtype > 1 || batch < 1 || heads < 1 ||
      batch * heads > 65535 || sq < kRows || skv < kKv || sq % kRows != 0 ||
      skv % kKv != 0 || d < 8 || d > (fold ? 120 : 128) || d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const ChainLauncher launch = flash_variants_sm90::chain_launchers
      [kind][dtype][((fold ? d + 1 : d) + 15) / 16 - 1];
  if (launch == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  const float qscale =
      base2 ? (float)((double)scale * 1.4426950408889634) : scale;
  return launch(q, k, v, o, batch, heads, sq, skv, d, qscale,
                base2 ? 1.f : kLog2e, parts, 1,
                static_cast<cudaStream_t>(stream));
}

// T4/T5's tiling index of `chains` q chains a block (v0's, vG2's, vG4's);
// -1 for another count.
int tt_tiling(int chains) {
  return chains == 1 ? 0 : chains == 2 ? 1 : chains == 4 ? 2 : -1;
}

}  // namespace

// Plain C entry points (bound with ctypes): contiguous [B, H, S, D] q, k, v,
// o (T4/T5: [B, H, D, S]), 16-byte aligned; dtype 0 = bf16, 1 = fp16. Each
// launches on `stream` and returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or option outside the domain).

// T2: every head of a q tile in one instance; `parts` (1, 2 or 4) splits
// the kv range over a cluster of that many blocks.
extern "C" int flash_opt_attn_h_sm90(const void* q, const void* k,
                                     const void* v, void* o, int batch,
                                     int heads, int sq, int skv, int d,
                                     float scale, int dtype, int parts,
                                     void* stream) {
  return run(0, q, k, v, o, batch, heads, sq, skv, d, scale, dtype, parts,
             stream);
}

// The [D, S] products of one [d, 64] plane (ds_probe_kernel): `s` [64, 64]
// and `o` [64, round16(d)] fp32.
extern "C" int flash_variants_sm90_probe(const void* q, const void* k,
                                         const void* v, void* s, void* o,
                                         int d, int dtype, void* stream) {
  if (dtype < 0 || dtype > 1 || d < 8 || d > 128 || d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto widths = std::make_integer_sequence<int, kMaxWidths>{};
  const ProbeLauncher launch =
      dtype == 0 ? probe_launcher<__nv_bfloat16>((d + 15) / 16 - 1, widths)
                 : probe_launcher<__half>((d + 15) / 16 - 1, widths);
  return launch(q, k, v, static_cast<float*>(s), static_cast<float*>(o), d,
                static_cast<cudaStream_t>(stream));
}

#ifdef FV_STAMPS
// The stamps so far, [kernel][phase] cycles, into `out`; zeroes them.
extern "C" int flash_variants_sm90_stamps(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, fv_stamps, sizeof(fv_stamps));
  if (err == cudaSuccess) {
    static const unsigned long long zeros[3][kPhases] = {};
    err = cudaMemcpyToSymbol(fv_stamps, zeros, sizeof(zeros));
  }
  return (int)err;
}
#endif

// T3: S of the next kv tile issued before this tile's softmax.
extern "C" int flash_pipelined_attn_sm90(const void* q, const void* k,
                                         const void* v, void* o, int batch,
                                         int heads, int sq, int skv, int d,
                                         float scale, int dtype,
                                         void* stream) {
  return run(1, q, k, v, o, batch, heads, sq, skv, d, scale, dtype, 1,
             stream);
}

// T1: `variant` 0 = v0, 1 = vU, 2 = vG with G = 2, 3 = vG with G = 4;
// `parts` (1, 2 or 4) splits the kv range over a cluster of that many
// blocks.
extern "C" int flash_opt_attn_sm90(const void* q, const void* k,
                                   const void* v, void* o, int batch,
                                   int heads, int sq, int skv, int d,
                                   float scale, int dtype, int variant,
                                   int parts, void* stream) {
  if (variant < 0 || variant > 3) return (int)cudaErrorInvalidValue;
  return run_chains(variant, false, q, k, v, o, batch, heads, sq, skv, d,
                    scale, dtype, parts, false, stream);
}

// T6: `variant` 0 = exp (T1 v0's instantiation), 1 = exp2, 2 = exp2 with
// the row sum of the 16-bit P; `parts` as T1's.
extern "C" int flash_variants_attn_sm90(const void* q, const void* k,
                                        const void* v, void* o, int batch,
                                        int heads, int sq, int skv, int d,
                                        float scale, int dtype, int variant,
                                        int parts, void* stream) {
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  return run_chains(variant == 2 ? 4 : 0, variant > 0, q, k, v, o, batch,
                    heads, sq, skv, d, scale, dtype, parts, false, stream);
}

// T4: [B, H, D, S], natural exp, fp32 l; `chains` (1, 2 or 4) q chains of
// 64 rows a block; `parts` splits the kv range as T1's.
extern "C" int flash_tt2_attn_sm90(const void* q, const void* k,
                                   const void* v, void* o, int batch,
                                   int heads, int sq, int skv, int d,
                                   float scale, int dtype, int chains,
                                   int parts, void* stream) {
  const int tiling = tt_tiling(chains);
  if (tiling < 0) return (int)cudaErrorInvalidValue;
  return run_chains(kTtKinds + tiling, false, q, k, v, o, batch, heads, sq,
                    skv, d, scale, dtype, parts, false, stream);
}

// T5: [B, H, D, S], exp2; `sum_fold` the row sum from P·V (ttv3), with
// `bf16_p` exp2 on bf16 arguments (ttv4); neither, the per-tile rounded
// row sum (no-fold). `chains` as T4's; never split.
extern "C" int flash_ttv3_attn_sm90(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int heads, int sq, int skv, int d,
                                    float scale, int dtype, int bf16_p,
                                    int sum_fold, int chains, void* stream) {
  const int tiling = tt_tiling(chains);
  if (tiling < 0 || (bf16_p && !sum_fold)) return (int)cudaErrorInvalidValue;
  const int form = sum_fold ? (bf16_p ? 2 : 1) : 3;
  return run_chains(kTtKinds + 3 * form + tiling, true, q, k, v, o, batch,
                    heads, sq, skv, d, scale, dtype, 1, sum_fold != 0,
                    stream);
}

// K1 over [D, S] planes (ops/flash_attention.py::flash_attention_tt and
// ::flash_attention_cm, the Hopper path): T4's kernel (its `chains` tiling,
// `parts` as T4's) with K1's arithmetic: q unscaled (round16(1) = 1) and
// p = 2^(s·c − m·c), c = scale·log2 e in fp32, as K1's Hopper path forms
// it. `planes` planes of d rows, each `batches` runs of sq q (o) columns
// and of skv K/V columns: [B, H, D, S] is B·H planes of one run, [H, D, B,
// S] H planes of B runs; a q tile reads its own run's K/V.
extern "C" int flash_attention_ds_sm90(const void* q, const void* k,
                                       const void* v, void* o, int planes,
                                       int batches, int sq, int skv, int d,
                                       float scale, int dtype, int chains,
                                       int parts, void* stream) {
  const int tiling = tt_tiling(chains);
  if (tiling < 0 || dtype < 0 || dtype > 1 || planes < 1 ||
      planes > 65535 || batches < 1 || sq < kRows || skv < kKv ||
      sq % kRows != 0 || skv % kKv != 0 || d < 8 || d > 128 || d % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const ChainLauncher launch = flash_variants_sm90::chain_launchers
      [kTtKinds + tiling][dtype][(d + 15) / 16 - 1];
  if (launch == nullptr) return (int)cudaErrorInvalidDeviceFunction;
  return launch(q, k, v, o, planes, 1, sq, skv, d, 1.f, scale * kLog2e,
                parts, batches, static_cast<cudaStream_t>(stream));
}
#endif  // BUILD_PART == 0
