// Fused contiguous EFTA flash attention (forward) for NVIDIA Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/efta_attention.py::_efta_kernel (the Pallas
// TPU kernel launched by efta_attention_pallas). One launch attends
// q (B, H, Sq, D) to contiguous k, v (B, Hkv, Skv, D) and runs the paper's
// EFTA scheme inside the same pass, per KV block of block_kv keys:
//   * GEMM I with the NVR clip, stride-s_kv tensor-checksum ABFT against
//     Q * fold(K)^T, locate-and-correct;
//   * causal, sliding-window and ragged kv_len masks; running max with a
//     shadow max;
//   * EXP under the 80/g_kv cap, checked by the linear product fold, plus
//     an exact recompute backstop;
//   * rowsum with a shadow rowsum and the SNVR tracker r;
//   * GEMM II with the V column checksums carried through every rescale
//     (and, with unified=0, an output check after every block);
//   * finalize: SNVR bound, |o| <= running max|V| clamp, unified output
//     verify and correct.
//
// What bounds it on this card. At the serve path's prefill shapes (gpt2:
// Sq = Skv up to 512, D 64, one 512-key block) the least time is HBM bytes
// (q, k, v, out: 3.1 MB, 0.94 us); the causal GEMMs are 0.4 GFLOP, 0.4 us at
// the bf16 tensor rate. What sets this kernel's time instead is the scalar
// work around the GEMMs: every row walks all 512 keys of its block through a
// dozen dependent phases (the ABFT fold covers masked columns too, so
// nothing inside a block is skipped), three exponentials per score among
// them. The first design ran them in per-row loops of a few threads each,
// 20 block barriers and f32 FMA GEMMs, on one warp per scheduler.
//
// Design:
//   * Rows in groups of 16, four warps a group. A thread block takes one or
//     two groups (16 or 32 rows) of ONE reference query tile (grid (B*H,
//     n_q * n_sub)); two blocks fit an SM. The group's four warps split the
//     tensor-core products by columns (GEMM I: keys of the chunk; GEMM II:
//     8-column n-tiles of D) and every row phase by rows (4 each).
//   * Row phases inside a warp. A lane owns fold columns (row r, i) of the
//     stride-s_kv fold, the keys c = l * s_kv + i, and lanes of one row
//     combine with xor shuffles: the ABFT fold of S, masked max and its
//     shadow, EXP with its product-fold check and the recompute backstop,
//     rowsum and shadow rowsum, SNVR tracker, the output checksums. No
//     block barrier separates them.
//   * Tensor cores in bf16. S = Q K^T over each 64-key chunk and P V run on
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate) with ldmatrix operands;
//     p is rounded to bf16 for GEMM II only. The f32 instantiation keeps
//     the sequential f32 FMA loops of the first kernel (TF32 would break the
//     1e-5 bound and the thresholds); everything else is shared.
//   * The checksum products stay f32 FMAs on CUDA cores: Q fold(K)^T, the V
//     column checksums and the O-checksum updates (1/g_kv of GEMM I's work).
//   * Scores in shared memory. Each group keeps its 16 x block_kv f32 scores
//     (locate-and-correct needs the whole row before the softmax); the EXP
//     pass keeps a fold column's g_kv <= 32 probabilities in a per-thread
//     array (L1-cached local memory; fully unrolled into registers the pass
//     ran slower on the card) and writes p over s, so one buffer serves
//     both.
//     Rows are padded to block_kv + s_kv floats, so the fold reads (s_kv
//     lanes per row, 32 / s_kv rows per access) hit distinct banks.
//   * Streamed K and V. 64-key chunks (fewer where shared memory is short)
//     go through a 2-3 stage cp.async ring shared by the block's warps: the
//     next chunk is in flight while the current one is used. K is read once
//     per block for GEMM I and its fold alike; V's column checksums (and its
//     max|V|) are folded from the staged chunk by the whole block.
//   * Which KV blocks run (causal, window, kv_len skipping), and which the
//     running max|V| covers, is decided per reference tile (row // block_q),
//     and each block counts over its real rows (r < nrows), so the per-block
//     partial counts sum to the reference's tile counts.
//   * Each thread block writes its own (5,) partial counts and the wrapper
//     sums them: no atomics, so counts and values are deterministic and a
//     retry reproduces the clean values bit for bit.
//   * Numerics as efta_paged.cu (efta_common.cuh): f32 arithmetic, p rounded
//     to T for GEMM II while the O checksums use the f32 p, NaN-propagating
//     min/max, shadows read through opaque(), folds summed in segment order,
//     -fmad=false.
//
// Wide KV blocks. The layout above holds a group's 16 x block_kv scores in
// shared memory, lanes fold s_kv <= 32 columns of a row, and the EXP pass
// keeps g_kv <= 32 probabilities a thread: block_kv up to 1,024. The
// reference kernel takes any block that divides the sequence, and the dry
// run's cells use 2,048 (s_kv 64) and 32,768 (s_kv 128, g_kv 256); at 2,048
// keys 64 rows of f32 scores are 512 KB, which no SM holds, and the check's
// unit is the whole KV block (locate-and-correct needs a whole row of it
// before the softmax). Two more layouts take such blocks.
//
// The cluster layout (efta_attention_kernel_cluster,
// efta_attention_cluster.cuh), wherever it holds the shapes (g_kv <= 32,
// s_kv a power of two, D <= 256, unified output verification). What bounds
// it is the operations: at deepseek-coder-33b's 32k prefill (56 heads of
// 128 on 8, causal, block_kv 2,048) 1.54e13 FLOP at 989 TFLOP/s, 15.6 ms;
// its bytes (q, k, v, out once, 1.07 GB) take 0.32 ms. The stride-s_kv
// fold sums column l * s_kv + i over l, so a fold residue i and all its
// g_kv segments are a unit that needs no other: GEMM I's checksum against
// Q fold(K)^T (fold(K)[i] reads only those keys), locate-and-correct and
// the EXP product fold.
//   * A cluster of n thread blocks (CTAs; 8 at 2,048 and 4,096 keys)
//     shares one tile of 16 W query rows (64 at D 128 in bf16, 32 at D
//     256). CTA `rank` owns the residues rank * s_kv / n .. + s_kv / n and
//     loads only their keys (strips of s_kv / n consecutive keys every s_kv
//     keys; 256 keys a CTA at 2,048), so its scores and p stay in its own
//     shared memory, and so do its K folds: no global workspace, no round
//     trip of a score off chip (the workspace layout sent each score
//     through L2 eight to ten times).
//   * Its row phases are the narrow layout's: lanes on (row, residue)
//     pairs of one warp, g_kv scores a lane, xor shuffles over the
//     residues; every warp of the CTA busy on its own 4 rows at once, not
//     a row at a time, and no serial tail on one lane.
//   * A row crosses CTAs three times, through distributed shared memory
//     (barrier.cluster, then plain loads of mapa's addresses): the partial
//     block max (every CTA combines the parts in one fixed order, so all
//     hold the same m, and a ROWMAX SEU flips the same value everywhere);
//     the partial rowsum and shadow rowsum (the SNVR term follows from the
//     block max);
//     and, once at the end, the partial O, O checksums and max|V|, which
//     each CTA sums in rank order for its TR / n rows before the SNVR
//     bound and the unified verify. Per-residue events (GEMM I, EXP) are
//     counted by the owning CTA, per-row ones by rank 0 (ROWMAX) or by the
//     CTA that finalizes the row (ROWSUM, output); a key-column SEU strikes
//     the CTA that owns its residue, and a GEMM II SEU the sum of the
//     partials (rank 0 adds the flip's change of it).
//   * K and V are read once a KV block for the whole tile (64 rows a pass,
//     against 32), in chunks of 128 keys through a ring of 2 or 3 slots
//     that runs on across blocks (the next block's K is in flight during
//     this block's V pass); V once for all of D, not once per 64-column
//     slice. A producer warpgroup issues the copies (cp.async) and does
//     nothing else; each slot has two mbarriers, `full` (its copies have
//     landed) and `empty` (every consumer warp is done with it), so a
//     consumer waits only for the chunk it reads. setmaxnreg leaves the
//     producer 32 registers a thread and the 512 consumer threads 112
//     (one producer warp alone would put five warps on one SM
//     sub-partition and cap every thread at 96). The producer passes each
//     cluster barrier before the first slot whose release follows it.
//   * bf16 chunks and Q lie in shared memory as 8 x 8 core matrices (128
//     contiguous bytes each), wgmma's layout without swizzle, which
//     ldmatrix also reads without bank conflicts. Where a tile has 64
//     rows, GEMM I is wgmma m64 x KC / 4 keys a warpgroup, Q and K
//     straight from shared memory, and GEMM II a partial P_own V_own on
//     wgmma m64 x D / 4 columns a warpgroup (D 64, 128, 256), p from
//     registers and V from shared memory as it stands (N-major), each
//     chunk's products back to back in a loop of compile-time length (a
//     branch among them makes ptxas serialize them); else mma.sync, 4
//     n-tiles of 8 a warp, V through ldmatrix.trans.
//   * In bf16 the checksum products run on the tensor cores too, each at
//     (about) f32's precision: the K folds (K^T times a matrix of 1s and
//     segment weights: exact products, f32 sums), GEMM I's checksums Q
//     fold(K)^T (TF32: Q is TF32 exactly, fold(K) split into high and low
//     parts), the V column checksums (V times the fold's 0 / weight
//     matrix) and the O-checksum products (p and the V checksums split
//     into high and low bf16 parts: hi hi + hi lo + lo hi, about 2^-15 of
//     each product). The f32 instantiation keeps FMAs for all of them.
//   * The EXP pass keeps a residue's g_kv probabilities in a per-thread
//     array, and a row whose block lies wholly inside its mask computes no
//     mask; the product-fold check and the exact recompute backstop stay,
//     as in the reference. Indices divide by a multiply-high (a predicated
//     division path costs issue slots in every loop), NaN-propagating
//     min / max are single instructions, and the kernel is instantiated
//     for D <= 128 and D <= 256 so that GEMM II's accumulators hold no
//     unused registers.
//   * The tiles run heaviest first (causal: the last query tiles), so the
//     short tiles fill the tail of the launch.
// What is left (PERF.md section 6 has the measured phase split): the row
// phases run latency-bound on the 16 consumer warps that 64 rows and 227
// KB of shared memory allow an SM, between barriers that every warp of
// the cluster must reach.
// The workspace layout (the second kernel, WIDE = true), for what the
// cluster layout does not hold (g_kv > 32, as at 32,768 keys, or the
// per-step output check, whose count follows the summation order that a
// split over CTAs changes):
//   * each thread block owns one slot of a global workspace that the
//     wrapper allocates: the group's scores (then p) and the raw
//     probabilities of the EXP pass, 16 x block_kv floats each, plus the
//     K-fold planes where they do not fit shared memory either. A
//     persistent grid (at most the thread blocks that fit the card at
//     once) walks the (bh, tile) pairs, so the workspace is slots x slot
//     bytes, not tiles x slot bytes;
//   * the row phases take one row at a time with the whole warp: a lane
//     owns fold columns i = lane + 32 t of it, and lanes combine with
//     32-wide xor shuffles;
//   * the EXP pass writes each raw probability to the workspace as it forms
//     the fold product, and its second walk reads back exactly the values
//     that product checked (nothing is recomputed unchecked: the recompute
//     is the correction, as in the reference).
// The tile layout (efta_attention_kernel_tile and its fold pass,
// efta_attention_tile.cuh) takes the first layout's prefill shapes in bf16
// wherever it holds them: unified output verification, query tiles of at
// least 64 rows with four row groups allowed and a query tile's KV block
// of at least 8,192 scores (below that, as at gpt2's and t5's 64-token
// buckets, the fold pass and a CTA's fixed costs outweigh what the layout
// saves), block_kv <= 1,024 with s_kv a power of two from 2 to 32 and g_kv
// <= 32, D <= 128, and 64 rows of f32 scores beside the ring in shared
// memory (1,024-key blocks do not fit).
// What held the first layout back at these shapes (PERF.md section 6 has
// its phase split): every thread block folded K, V's column checksums and
// max|V| of each KV block it streamed, though they depend on K and V alone
// (at kimi-k2's bucket 512, 128 thread blocks repeated the folds of each
// block); its V pass streamed V once per 16- to 64-column slice of D
// through a ring gated by block barriers (seven times at D 112, with half
// the warps of a slice idle); the checksum products ran as f32 FMAs.
//   * A fold pass, once per (KV head, KV block), before the tile kernel:
//     the K-fold planes, the V column checksums (split into bf16 high and
//     low parts, the B operand of the O-checksum products) and max|V|,
//     summed in segment order as the first layout sums them, into a
//     scratch tensor that the wrapper allocates (one slot a KV head and KV
//     block). Each entry is a chain of dependent loads and adds, so each
//     (KV head, KV block) is spread over blocks of 256 threads, one
//     checksum entry a thread.
//   * One CTA a tile of 64 query rows: four consumer warpgroups and a
//     producer warpgroup that streams the block's K chunks, then its V
//     chunks with their checksum rows, through an mbarrier ring (the
//     cluster layout's machinery, efta_hopper.cuh). GEMM I is wgmma m64 x
//     KC / 4 keys a warpgroup, Q and K from shared memory; GEMM II wgmma
//     m64 over the D / 8 n-tiles split among the four warpgroups (32, 32,
//     24 and 24 columns at D 112), p from registers, V read once for all
//     of D. The output accumulator stays in registers across KV blocks:
//     64 rows of scores and the ring leave no room for it.
//   * The row phases are the first layout's: lanes on (row, residue)
//     pairs, four rows a warp, 16 warps an SM, and a row needs no other
//     CTA, so the counts follow the first layout's.
//   * The checksum products on the tensor cores, as the cluster layout's:
//     Q fold(K)^T in TF32 with fold(K) split into high and low parts (two
//     warps a product, each over half of D, where s_kv <= 8 leaves fewer
//     products than a group has warps), and the O-checksum products on
//     mma.sync with p and the V checksums split into bf16 high and low
//     parts, each warpgroup a share of the keys of one checksum n-tile,
//     the shares summed in order.
// The decode layout (efta_attention_kernel_dscore, _dexp and _dstate,
// efta_attention_decode.cuh) takes one query row a query tile (block_q 1:
// the cross-attention decode of t5 and the VLM) under unified output
// verification. What bounds it is the bytes: at the VLM's (B 8, 32 heads
// of 128 on 8, 1,600 keys) K and V are 52 MB, 15.7 us, and its GEMMs
// 0.1 GFLOP. What held the first layout back there: one real row in a
// 16-row group, every row phase on one warp's s_kv lanes with g_kv keys a
// lane in series, every query head's CTA folding its KV head's blocks
// again (K folds, V checksums, max|V|), the VLM's 25 blocks walked in
// series by 256 CTAs and t5's one block by 64.
//   * A unit is a request's KV head with all its query rows (up to 8): K
//     and V are read, and folded, once a KV head. Each KV block is split
//     into parts of whole fold residues (at most 128 keys a CTA: t5's
//     512-key block into 4 parts of 4 residues), since a residue's fold
//     check needs all its segments and no other residue's.
//   * The work that does not read the running state runs on (unit, KV
//     block, part) CTAs side by side: the score pass (GEMM I, K folds, the
//     fold check with locate and correct, the partial block max) and the
//     EXP pass, which first replays the running max and its shadow in
//     block order from the block maxima (a prefix max over a warp's
//     lanes: the max is exact in any order), then EXP, its checks, the
//     rowsum terms, V's checksums and max|V|, P V and the O-checksum
//     products from zero.
//   * The state pass folds the running state in block order, one CTA a
//     query row: acc = alpha acc + P V, l, the shadow l, r and the O
//     checksums, the sequential order of the plain version (no merge of
//     partial states of spans, which would move what a state SEU strikes);
//     then the SNVR bound, the clamp and the unified verify.
//   * Scores, checksum products, block maxima and each part's products
//     pass between the kernels through a workspace the wrapper allocates
//     (one slot a unit and KV block), staged with cp.async; each CTA
//     writes its own counts.
//   * In bf16 GEMM I and P V run on mma.sync m16n8k16 with the unit's rows
//     in a 16-row tile: one instruction where each lane would issue a
//     hundred FMAs, which bounded these short CTAs more than the idle half
//     of the tile. The f32 instantiation keeps f32 FMAs; the checksum
//     products stay f32 FMAs in both, spread over the lanes of a warp.
//   * The folded scores of the fold check are summed in segment order, as
//     the plain version sums them: a correction moves a struck score by
//     the difference of the two sums, so their rounding must match.
// The check's unit stays the reference's KV block in all five layouts.
// Every tiling the first layout fits and the tile and decode layouts do
// not take keeps the first kernel (same outputs and counts). PERF.md
// section 6 has each layout's times beside the bound.
//
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "efta_common.cuh"
#include "efta_hopper.cuh"

// Phase clocks (efta_common.cuh, -DEFTA_PHASE_CLOCKS): k is setup, K pass,
// fold check, max, EXP, V pass, block tail, finalize, cluster waits,
// K-chunk waits, V-chunk waits, V checksums and O-checksum products (the
// cluster layout's marks). tools/b2_phase_split.py reads the split.

namespace {

constexpr int WPG = 4;         // warps per 16-row group
constexpr int MAX_GROUPS = 2;  // row groups per thread block
constexpr int MAX_G = 32;  // fold segments of the EXP pass's per-thread array
constexpr size_t SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;
constexpr int F_SITE = 0, F_BLOCK = 1, F_BH = 2, F_ROW = 3, F_COL = 4,
              F_BIT = 5, F_ON = 6;

// shared-memory layout of one thread block (byte offsets)
struct Layout {
  int ldk;  // ring / q row stride, elements of T
  int lds;  // score row stride, floats
  int ldo;  // accumulator row stride, floats
  int ldf;  // K-fold row stride, floats (16-byte rows)
  size_t ring, qs, kf, sp, acc, sc1, vcs, oc, row, red, total;
};

// the wide path's workspace slot (float offsets): the group rows' scores,
// then p, at its start, the EXP pass's raw probabilities at pb, and the
// K-fold planes at kf where shared memory cannot hold them (g_kf)
struct Slot {
  size_t pb, kf, floats;
  int g_kf;
};

// W row groups of 16 rows, WPG warps each; `wide`: scores and raw
// probabilities in the workspace, `g_kf`: the K-fold planes too
Layout make_layout(int W, int KC, int ST, int D, int Bc, int skv, int sout,
                   int esz, int wide = 0, int g_kf = 0) {
  Layout L;
  const int TR = 16 * W;
  // bf16 rows padded by 16 bytes: ldmatrix reads 8 rows on 8 bank groups;
  // f32 rows padded by one float for the FMA path's column reads
  L.ldk = esz == 2 ? D + 8 : D + 1;
  L.lds = wide ? Bc : Bc + (skv < 32 ? skv : 0);
  L.lds += L.lds & 1;  // float2 reads of p
  L.ldo = D + 1;
  L.ldf = D + 4;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) & ~(size_t)15;
    return o;
  };
  L.ring = take((size_t)ST * KC * L.ldk * esz);
  L.qs = take((size_t)TR * L.ldk * esz);
  L.kf = take(wide && g_kf ? 0 : 2 * (size_t)skv * L.ldf * 4);
  L.sp = take(wide ? 0 : (size_t)TR * L.lds * 4);
  L.acc = take((size_t)TR * L.ldo * 4);
  L.sc1 = take((size_t)TR * skv * 4);
  L.vcs = take(2 * (size_t)KC * sout * 4);
  L.oc = take(4 * (size_t)TR * sout * 4);
  L.row = take(8 * (size_t)TR * 4);
  L.red = take((size_t)W * WPG * 8 * 4);
  L.total = off;
  return L;
}

Slot make_slot(const Layout& L, int W, int skv, int g_kf) {
  Slot S;
  S.pb = (size_t)16 * W * L.lds;
  S.kf = 2 * S.pb;
  S.floats = S.kf + (g_kf ? 2 * (size_t)skv * L.ldf : 0);
  S.g_kf = g_kf;
  return S;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int* rep;
  int BH, grp, Sq, Skv, D, block_q, block_kv, n_q, n_kv, kv_len, s_kv,
      s_out, causal, window;
  int W, KC, ST, DS, n_sub;
  Layout L;
  float scale, eps1, eps2, eps3, cap, cap_g, cap_m, upper;
  int mode, unified, shadow_rowsum, shadow_rowmax;
  int fault[8];
  // the wide path's workspace, one slot a thread block, and its layout
  float* ws;
  Slot S;
};

// columns of one PV n-slice: the largest multiple of 16 up to 64 dividing D
int slice_of(int D) {
  for (int ds = 64; ds >= 16; ds -= 16)
    if (D % ds == 0) return ds;
  return 0;
}

#include "efta_attention_cluster.cuh"
#include "efta_attention_tile.cuh"
#include "efta_attention_decode.cuh"

// cl: CTAs a cluster of the cluster layout, 0 for the others; tile: the
// tile layout; dc: the decode layout's residue parts a KV block (0: another
// layout)
struct Tiling {
  int W, KC, ST, per_sm, wide, g_kf, cl, tile, dc;
};

// row groups per block (2 or 1, each of 16 rows and WPG warps), keys per
// streamed chunk and ring stages: two blocks per SM if any choice fits half
// of its shared memory (16 warps an SM hide each other's latency), else
// one; then the most rows, the widest chunk and the deepest ring. That is
// the first layout, wherever it fits. Else the wide path, with the K-fold
// planes in shared memory if any choice fits them there, and the widest
// chunk first: at block_kv 2,048 its barrier-separated chunk steps (a K
// pass and D / 64 V passes over block_kv / KC chunks each), more than the
// warps an SM, set the time.
// Past the first layout, the cluster layout wherever it holds the shapes:
// unified output verification (the per-step check's count follows the
// summation order, which the split over CTAs changes), s_kv a power of two
// split over a portable cluster of 8, 4 or 2 CTAs with at most 32
// residues a CTA, g_kv <= 32, D <= 256; chunks of 128 or 64 keys before
// narrower ones, then the most rows, the widest chunk, the most CTAs (the
// fewest keys a CTA) and the deepest ring.
// Else (g_kv > 32 as at 32,768 keys, or unified = 0) the workspace path.
// Before all of them, the tile layout wherever it holds the shapes (bf16,
// unified, block_q >= 64 and block_q x block_kv >= 8,192, max_groups >= 4,
// block_kv <= 1,024, s_kv a power of two from 2 to 32, g_kv <= 32, D <=
// 128) and fits: the widest chunk (128, 64, 32 keys), then the deepest
// ring.
// Before every other, the decode layout wherever it holds the shapes:
// block_q 1, unified output verification (the per-step check's count
// follows the summation order, which its split over CTAs changes), D <=
// 256, and at most DC_KEYS keys a CTA for some divisor of s_kv (g_kv <=
// 128); every dtype, causal mask, window and kv_len.
// python mirror: repro_torch/kernels/efta_attention.py::tiling
bool choose_tiles(int block_q, int Bc, int D, int skv, int sout, int esz,
                  int max_groups, int unified, Tiling* t) {
  if (Bc % 16 || D % 16 || skv < 1 || Bc % skv || sout <= 0 || D % sout ||
      slice_of(D) == 0)
    return false;
  if (block_q == 1 && unified && D <= 2 * DC_STATE_THREADS) {
    const DLayout L = make_decode_layout(D, Bc, skv, sout, esz);
    if (L.parts > 0 && decode_smem(L) <= SMEM_LIMIT) {
      *t = Tiling{1, L.keys, 1, 1, 0, 0, 0, 0, L.parts};
      return true;
    }
  }
  if (esz == 2 && unified && block_q >= 16 * TL_GROUPS &&
      (long long)block_q * Bc >= TL_MIN_SCORES && max_groups >= TL_GROUPS &&
      Bc <= 1024 && skv >= 2 && skv <= 32 &&
      !(skv & (skv - 1)) && Bc / skv <= MAX_G && D <= 32 * TL_NT)
    for (int kc = 128; kc >= 32; kc /= 2)
      for (int st = 3; st >= 2; --st)
        if (kc <= Bc && Bc % kc == 0 &&
            make_tile_layout(kc, st, D, Bc, skv, sout).total <= SMEM_LIMIT) {
          *t = Tiling{TL_GROUPS, kc, st, 1, 0, 0, 0, 1, 0};
          return true;
        }
  int wmax = (block_q + 15) / 16;
  if (wmax > max_groups) wmax = max_groups;
  if (wmax > MAX_GROUPS) wmax = MAX_GROUPS;
  auto fits = [&](int w, int kc, int st, int per_sm, int wide, int g_kf) {
    if (Bc % kc || make_layout(w, kc, st, D, Bc, skv, sout, esz, wide,
                               g_kf).total > SMEM_LIMIT / per_sm)
      return false;
    *t = Tiling{w, kc, st, per_sm, wide, g_kf, 0, 0, 0};
    return true;
  };
  if (skv >= 2 && skv <= 32 && !(skv & (skv - 1)) && Bc / skv <= MAX_G)
    for (int per_sm = 2; per_sm >= 1; --per_sm)
      for (int w = wmax; w >= 1; --w)
        for (int kc = 64; kc >= 16; kc /= 2)
          for (int st = 3; st >= 2; --st)
            if (fits(w, kc, st, per_sm, 0, 0)) return true;
  int wcl = (block_q + 15) / 16;
  if (wcl > max_groups) wcl = max_groups;
  if (wcl > CL_GROUPS) wcl = CL_GROUPS;
  if (unified && skv >= 2 && !(skv & (skv - 1)) && Bc / skv <= MAX_G &&
      D <= 32 * CL_NT)
    for (int wide_kc = 1; wide_kc >= 0; --wide_kc)
      for (int w = wcl; w >= 1; --w)
        for (int kc = wide_kc ? 128 : 32; kc >= (wide_kc ? 64 : 16);
             kc /= 2)
          for (int n = 8; n >= 2; n /= 2)
            for (int st = 3; st >= 2; --st) {
              if (skv % n || skv / n > 32 || (Bc / n) % kc ||
                  make_cluster_layout(w, kc, st, D, Bc, skv, sout, esz, n)
                          .total > SMEM_LIMIT)
                continue;
              *t = Tiling{w, kc, st, 1, 0, 0, n, 0, 0};
              return true;
            }
  for (int g_kf = 0; g_kf <= 1; ++g_kf)
    for (int kc = 64; kc >= 16; kc /= 2)
      for (int per_sm = 2; per_sm >= 1; --per_sm)
        for (int w = wmax; w >= 1; --w)
          for (int st = 3; st >= 2; --st)
            if (fits(w, kc, st, per_sm, 1, g_kf)) return true;
  return false;
}

// The body of one (bh, tile) pair, its rows against every KV block they
// see, is efta_attention_pair.cuh, included in both kernels: the narrow
// path's (one pair a thread block, the code of the first layout alone) and
// the wide path's (a persistent grid: thread block b walks the pairs b,
// b + gridDim.x, ... in workspace slot b).
template <typename T>
__global__ void __launch_bounds__(32 * WPG * MAX_GROUPS, 2)
    efta_attention_kernel(const Params P) {
  constexpr bool WIDE = false;
  const int bh = blockIdx.x, tile = blockIdx.y;
#include "efta_attention_pair.cuh"
}

template <typename T>
__global__ void __launch_bounds__(32 * WPG * MAX_GROUPS, 2)
    efta_attention_kernel_wide(const Params P) {
  constexpr bool WIDE = true;
  const int per_bh = P.n_q * P.n_sub;
  for (int id = blockIdx.x; id < P.BH * per_bh; id += gridDim.x) {
    const int bh = id / per_bh, tile = id - bh * per_bh;
#include "efta_attention_pair.cuh"
    __syncthreads();  // shared memory free for the next pair
  }
}

template <typename T, bool WIDE>
cudaError_t launch(const Params& p, int slots, cudaStream_t stream) {
  const size_t bytes = p.L.total;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  void (*kernel)(const Params) =
      WIDE ? efta_attention_kernel_wide<T> : efta_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid = WIDE ? dim3(slots) : dim3(p.BH, p.n_q * p.n_sub);
  kernel<<<grid, 32 * WPG * p.W, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int wide, int slots,
                     cudaStream_t stream) {
  return wide ? launch<T, true>(p, slots, stream)
              : launch<T, false>(p, slots, stream);
}

// the cluster layout: n CTAs for each (bh, tile) pair, cluster (n, 1, 1);
// refused (the error returned) where no cluster of that shape fits the card
template <typename T>
cudaError_t launch_cluster(const CParams& c, cudaStream_t stream) {
  const size_t bytes = c.L.total;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  void (*kernel)(const CParams) = c.P.D <= 128
                                      ? efta_attention_kernel_cluster<T, 4>
                                      : efta_attention_kernel_cluster<T, 8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.n * c.P.BH * c.P.n_q * c.P.n_sub);
  cfg.blockDim = dim3(32 * WPG * c.P.W + PRODUCER_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters <= 0) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, c);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the tile layout: the fold pass (where EFTA is on), then one CTA for each
// (bh, tile) pair
cudaError_t launch_tile(const TParams& c, cudaStream_t stream) {
  const size_t bytes = c.L.total;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (c.P.mode != 0) {
    efta_attention_kernel_fold<<<dim3(c.P.n_kv * c.F.splits,
                                      c.P.BH / c.P.grp),
                                 TL_FOLD_THREADS, 0, stream>>>(c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      efta_attention_kernel_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  efta_attention_kernel_tile<<<c.P.BH * c.P.n_q * c.P.n_sub,
                               32 * WPG * TL_GROUPS + PRODUCER_THREADS, bytes,
                               stream>>>(c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Thread blocks per reference query tile (block_q rows) for these shapes
// (the decode layout: its residue parts a KV block), or 0 when no tiling
// fits one SM's shared memory. dtype as below; unified as the launch's.
// With `tiling` (11 ints, or NULL) also the choice: {row groups W, keys a
// chunk (the decode layout: a CTA), ring stages, thread blocks an SM, wide
// path, K folds in the workspace, shared-memory bytes (the decode layout:
// its largest pass's), workspace floats a slot (the tile layout: fold-pass
// floats a KV head and KV block; the decode layout: a unit and KV block),
// CTAs a cluster (0: not the cluster layout), the tile layout, the decode
// layout's residue parts}.
int efta_attention_tiles(int dtype, int block_q, int block_kv, int D,
                         int s_kv, int s_out, int max_groups, int unified,
                         int* tiling) {
  Tiling t;
  const int esz = dtype == 0 ? 4 : 2;
  if (block_q <= 0 || !choose_tiles(block_q, block_kv, D, s_kv, s_out, esz,
                                    max_groups, unified, &t))
    return 0;
  if (tiling) {
    const Layout L = make_layout(t.W, t.KC, t.ST, D, block_kv, s_kv, s_out,
                                 esz, t.wide, t.g_kf);
    const DLayout DL = make_decode_layout(D, block_kv, s_kv, s_out, esz);
    const int smem =
        t.dc ? (int)decode_smem(DL)
        : t.tile ? (int)make_tile_layout(t.KC, t.ST, D, block_kv, s_kv, s_out)
                     .total
        : t.cl ? (int)make_cluster_layout(t.W, t.KC, t.ST, D, block_kv, s_kv,
                                          s_out, esz, t.cl).total
               : (int)L.total;
    const int floats =
        t.dc     ? DL.floats
        : t.tile ? make_fold(D, block_kv, s_kv, s_out).floats
        : t.wide ? (int)make_slot(L, t.W, s_kv, t.g_kf).floats
                 : 0;
    const int v[11] = {t.W,    t.KC, t.ST,   t.per_sm, t.wide, t.g_kf,
                       smem,   floats, t.cl, t.tile,   t.dc};
    for (int i = 0; i < 11; ++i) tiling[i] = v[i];
  }
  if (t.dc) return t.dc;
  return (block_q + 16 * t.W - 1) / (16 * t.W) * (t.cl ? t.cl : 1);
}

#ifdef EFTA_PHASE_CLOCKS
// the phase clocks' 16 sums (cycles), then zeroed
int efta_attention_phase_clocks(unsigned long long* out) {
  return efta_read_phase_clocks(out);
}
#endif

const char* efta_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). q and out are
// (BH, Sq, D), k and v (BH / grp, Skv, D), all contiguous device arrays;
// rep is (BH, n_q * tiles, 5) int32. max_groups caps the 16-row groups per
// thread block (the wrapper passes 4; the first two layouts take at most
// 2). Where the tiling takes the wide path, ws holds `slots` workspace slots
// (efta_attention_tiles gives the floats a slot) and the grid is `slots`
// thread blocks; else both are unused: the cluster layout allocates
// nothing, and rep then holds a row of counts for each CTA of a tile's
// cluster. The tile layout takes `slots` = BH / grp x n_kv fold-pass slots.
// The decode layout takes BH / grp x ceil(grp / 8) x n_q x n_kv workspace
// slots, and rep is (BH, n_q x (n_kv x parts + 1), 5): a row of counts for
// each part of each KV block (the score and EXP passes) and one for the
// state pass. The launch goes on `stream`.
int efta_attention_launch(int dtype, const void* q, const void* k,
                          const void* v, void* out, void* rep, int BH,
                          int grp, int Sq, int Skv, int D, int block_q,
                          int block_kv, int n_q, int n_kv, int kv_len,
                          int s_kv, int s_out, int causal, int window,
                          float scale, float eps1, float eps2, float eps3,
                          float cap, float cap_g, float cap_m, float upper,
                          int mode, int unified, int shadow_rowsum,
                          int shadow_rowmax, int max_groups, int f0, int f1,
                          int f2, int f3, int f4, int f5, int f6, int f7,
                          void* ws, int slots, void* stream) {
  if (BH <= 0 || grp <= 0 || BH % grp || D <= 0 || s_kv <= 0 ||
      s_out <= 0 || D % s_out || block_q <= 0 || block_kv <= 0 ||
      n_q * block_q != Sq || n_kv * block_kv != Skv || block_kv < s_kv)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.rep = (int*)rep;
  p.BH = BH;
  p.grp = grp;
  p.Sq = Sq;
  p.Skv = Skv;
  p.D = D;
  p.block_q = block_q;
  p.block_kv = block_kv;
  p.n_q = n_q;
  p.n_kv = n_kv;
  p.kv_len = kv_len;
  p.s_kv = s_kv;
  p.s_out = s_out;
  p.causal = causal;
  p.window = window;
  const int esz = dtype == 0 ? 4 : 2;
  Tiling t;
  if (!choose_tiles(block_q, block_kv, D, s_kv, s_out, esz, max_groups,
                    unified, &t))
    return (int)cudaErrorInvalidValue;
  p.W = t.W;
  p.KC = t.KC;
  p.ST = t.ST;
  p.DS = slice_of(D);
  p.L = make_layout(p.W, p.KC, p.ST, D, block_kv, s_kv, s_out, esz, t.wide,
                    t.g_kf);
  p.ws = (float*)ws;
  p.S = make_slot(p.L, p.W, s_kv, t.wide && t.g_kf);
  p.n_sub = (block_q + 16 * p.W - 1) / (16 * p.W);
  const long long dc_units =
      (long long)BH / grp * ((grp + DC_ROWS - 1) / DC_ROWS) * n_q;
  if (t.dc ? (ws == nullptr || slots != dc_units * n_kv ||
              dc_units > 65535 || (long long)n_kv * t.dc > 0x7fffffff ||
              (long long)BH * n_q * (n_kv * t.dc + 1) > 0x7fffffff)
      : t.cl ? (long long)t.cl * BH * n_q * p.n_sub > 0x7fffffff
      : t.tile ? (ws == nullptr || slots != BH / grp * n_kv ||
                  (long long)BH * n_q * p.n_sub > 0x7fffffff ||
                  BH / grp > 65535 ||
                  (long long)n_kv *
                          make_fold(D, block_kv, s_kv, s_out).splits >
                      0x7fffffff)
      : t.wide ? (ws == nullptr || slots <= 0 ||
                  (long long)BH * n_q * p.n_sub > 0x7fffffff)
               : (long long)n_q * p.n_sub > 65535)
    return (int)cudaErrorInvalidValue;
  p.scale = scale;
  p.eps1 = eps1;
  p.eps2 = eps2;
  p.eps3 = eps3;
  p.cap = cap;
  p.cap_g = cap_g;
  p.cap_m = cap_m;
  p.upper = upper;
  p.mode = mode;
  p.unified = unified;
  p.shadow_rowsum = shadow_rowsum;
  p.shadow_rowmax = shadow_rowmax;
  const int f[8] = {f0, f1, f2, f3, f4, f5, f6, f7};
  for (int i = 0; i < 8; ++i) p.fault[i] = f[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (t.dc) {
    DParams c;
    c.P = p;
    c.L = make_decode_layout(D, block_kv, s_kv, s_out, esz);
    c.n_rg = (grp + DC_ROWS - 1) / DC_ROWS;
    return (int)(dtype == 0 ? launch_decode<float>(c, s)
                            : launch_decode<__nv_bfloat16>(c, s));
  }
  if (t.tile) {
    TParams c;
    c.P = p;
    c.L = make_tile_layout(t.KC, t.ST, D, block_kv, s_kv, s_out);
    c.F = make_fold(D, block_kv, s_kv, s_out);
    return (int)launch_tile(c, s);
  }
  if (t.cl) {
    CParams c;
    c.P = p;
    c.L = make_cluster_layout(t.W, t.KC, t.ST, D, block_kv, s_kv, s_out, esz,
                              t.cl);
    c.n = t.cl;
    return (int)(dtype == 0 ? launch_cluster<float>(c, s)
                            : launch_cluster<__nv_bfloat16>(c, s));
  }
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(p, t.wide, slots, s)
                 : dispatch<__nv_bfloat16>(p, t.wide, slots, s);
  return (int)err;
}

}  // extern "C"
