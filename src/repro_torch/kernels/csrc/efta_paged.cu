// Fused block-table EFTA paged attention for NVIDIA Hopper (sm_90a).
//
// Replaces src/repro/kernels/efta_paged.py::_paged_kernel (the Pallas TPU
// kernel launched by efta_paged_attention_pallas). One launch attends every
// request of a mixed serve batch straight off its block table and runs the
// paper's EFTA scheme inside the same pass:
//   * site 6 (kv): every streamed K/V block is re-folded (encode_kv_tile)
//     and compared with its resident checksum pair (block_fold_bad);
//   * GEMM I with the NVR clip and stride-s_kv tensor-checksum ABFT, with
//     locate-and-correct;
//   * per-row causal-in-chunk, sliding-window and q_len masks;
//   * running max with a shadow max;
//   * EXP under the 80/g_kv cap, checked by the linear product fold, plus
//     an exact recompute backstop;
//   * rowsum with a shadow rowsum and the SNVR tracker r;
//   * GEMM II with the V column checksums carried through every rescale;
//   * finalize: SNVR bound, |o| <= max|V| clamp, unified output verify and
//     correct.
//
// What bounds it on this card: HBM bytes. Each (request, kv head) streams
// its K/V blocks plus the four resident checksum planes; at cs = 8, bs = 16
// the planes are as many bytes again as the K/V they guard, and the
// arithmetic per byte is small (grp * C rows per block). The bound is a few
// microseconds; what set the first kernel's 0.5 ms was latency: one
// 128-thread block per (request, kv head) walked its ~34 blocks one after
// the other, a dozen dependent phases and 15 block barriers per 16-token
// block, mostly on idle rows (a decode tile had 1 real row of 32).
//
// Design:
//   * Warps over rows and over blocks. A thread block has W row groups of
//     16 group-major rows (W = ceil(grp * C / 16) up to 4; decode takes
//     one) and G block slots: compute warp (rg, g) takes block g of every
//     step of G consecutive KV blocks for the group's rows. Grid (B, Hkv,
//     n_tiles), n_tiles = ceil(grp * C / (16 W)).
//   * Each step runs in three phases separated by block barriers:
//       A. per slot, in parallel: the block's K fold at the ABFT stride and
//          V column checksums, GEMM I and its ABFT check and correction,
//          the masked block max of each row (none of it reads the running
//          state);
//       B. per slot, in parallel: the running max through the step's
//          blocks replayed in order (shadow check, SEU and correction at
//          the block they belong to), then the block's EXP with its
//          product-fold check and backstop, rowsum and shadow, SNVR term,
//          GEMM II from zero and the O-checksum products;
//       C. the step's blocks folded into the running state in block order
//          (l, shadow l, r, acc, O checksums: alpha * old + new, the rowsum
//          and GEMM II SEUs at their block), rows spread over the warps.
//     Every value is formed by the same operations in the same order as a
//     walk over the blocks one at a time, so detection vectors equal the
//     sequential plain version's: a split of the blocks over warps with a
//     merge of partial states would not (an SEU on the running state
//     would strike one span's partial value instead; see
//     tests/test_torch_paged_split.py).
//   * Row reductions run inside a warp with xor shuffles: a lane owns fold
//     columns (row r, i), keys c = l * s_kv + i.
//   * Verify warps. With EFTA on, G more warps re-fold each slot's K and V
//     against the resident planes (site 6, row tile 0 only, so det[5]
//     counts each (b, h, j) once) and keep max|V|, beside phase A.
//   * Prefetch. Each step's K, V and (tile 0) resident planes are copied by
//     cp.async through the block table into a 2-3 stage ring, so the next
//     step's blocks are in flight while one is used.
//   * Tensor cores in bf16: GEMM I and GEMM II on mma.sync.m16n8k16 with
//     ldmatrix operands, p rounded to bf16 for GEMM II only. The f32
//     instantiation keeps sequential f32 FMAs (TF32 would break the 1e-5
//     bound and the thresholds). The checksum products (Q fold(K)^T, V
//     column checksums, O-checksum updates) stay f32 FMAs.
//   * Every row below grp * C is computed, padding rows (past the request's
//     q_len) too: the reference counts their checks, and a resident flip
//     makes their GEMM I ABFT fire like a query row's.
//   * Each block writes its own (6,) partial counts and the wrapper sums
//     them: no atomics, so counts and values are deterministic and a retry or
//     a block repair reproduces the clean values bit for bit.
//   * Numerics (efta_common.cuh): f32 arithmetic, NaN-propagating min/max,
//     shadows read through opaque(), folds in segment order, -fmad=false.
//
// The tile layout (efta_paged_kernel_tile and its fold pass,
// efta_paged_tile.cuh) takes the chunk path in bf16 wherever it holds the
// shapes: unified output verification, grp x C >= 64 rows (gpt2's prefill
// steps, the moe heads' C 64 steps, speculative steps of 64 rows or
// more), 16-key blocks at ABFT stride 4, D a multiple of 16 up to 128.
// What held the first layout back there (PERF.md section 6 has its phase
// split): each compute warp folded K at the ABFT stride and V's column
// checksums of its block, so every block was folded once per row group and
// again in each row tile (28-32 times per request and KV head at the moe
// heads); K, V and the planes were streamed once per row tile; three block
// barriers a step of 16-key blocks; and phase C's rescale of the 16 x D
// accumulator ran on G warps a row group, one warp at arctic's D 128 (G
// 1), 64 elements a lane a block in series.
//   * A fold pass, once per (request, KV head, running block), before the
//     tile kernel: the K folds as bf16 high and low parts, laid out as 16
//     more rows of GEMM I's B operand, the V column checksums and max|V|,
//     summed in segment order as the first layout sums them, and the site-6
//     check against the resident planes, which writes the bad plane (det
//     [5] is its sum over the running blocks, taken by row tile 0).
//   * One CTA a tile of 64 rows of one (request, KV head): four consumer
//     warpgroups and a producer warpgroup that gathers each step's four
//     blocks through the block table (K, its fold rows, V, V's checksums)
//     into an mbarrier ring of two or three stages (efta_hopper.cuh's
//     machinery, as B2's tile layout). GEMM I: warpgroup k takes block k of
//     the step as one wgmma m64 n32 over D (16 keys and the 16 fold rows:
//     the scores and the checksum products Q fold(K)^T at once). Row phases
//     on every warp, four rows each, lanes on (block, row, residue): the
//     fold check and block max, the running max replayed through the step's
//     blocks in order, EXP with its checks, then the rowsum, shadow, SNVR
//     and O-checksum chains in block order. GEMM II: a wgmma m64 a block in
//     block order over warpgroup k's share of D, p from registers, from
//     zero, then acc = alpha acc + P V in registers; two consumer barriers
//     a step.
// The decode layout (efta_paged_kernel_decode, efta_paged_decode.cuh)
// takes the launches of one chunk row (C 1) with unified output
// verification, bf16 or f32, 16-key blocks at ABFT stride 4, D a multiple
// of 16 up to 256, wherever one CTA's share of the table fits its shared
// memory. What held the first layout back there (PERF.md section 6): one CTA
// a (request, KV head) walked every block of the request in series, three
// block barriers a step of G blocks, on a 16-row tile whose real rows are
// the group's grp (1 at gpt2, 7-8 at the moe heads).
//   * A cluster of 8 CTAs a (request, KV head, 16 query heads); CTA k takes
//     a contiguous span of the running blocks, so the unit's blocks are
//     gathered and checked by 8 SMs at once.
//   * Phase A on the span (state-independent: site 6, GEMM I, the fold
//     check, the block max), then exchange 1 over distributed shared memory:
//     each CTA replays the running max in block order from every earlier
//     block's maximum (a prefix max by shuffles, the shadow max and its SEU
//     at their block); phase B on the span (EXP and its checks, the rowsum
//     terms, P V and the O-checksum products from zero), each block's
//     partials stored into the shared memory of the CTA that owns the row;
//     exchange 2: each owner folds its rows' running state in block order
//     and finalizes them. One launch; no workspace; two cluster barriers.
// The long-table layout (efta_paged_kernel_lscore, _lexp and _lstate,
// efta_paged_long.cuh) takes the decode layout's shapes where a CTA's share
// of the table does not fit the cluster (wide tables: the serve engine's
// default cache of 4,096 tokens at the moe heads, long contexts). There the
// first layout walked every running block in one CTA a (request, KV head).
//   * The decode layout's phases as three launches over a global workspace
//     of a slot a (unit, running block): a score pass (site 6 on K, GEMM I,
//     the fold check, block and group maxima), an EXP pass (the running max
//     entering each group of blocks from the earlier groups' maxima, the
//     block's running max, site 6 on V, EXP and its checks, the row terms,
//     P V and the O-checksum products), and a state pass a (unit, row) that
//     folds the running state in block order and finalizes.
//   * Shared memory is fixed (G blocks a CTA at a time), the first two
//     passes' CTAs walk groups of running blocks with a stride, and the
//     wrapper allocates the workspace a call, as the tile layout's.
// Every tiling the first layout takes and the tile, decode and long-table
// layouts do not keeps the first kernel, whose code is unchanged.
//
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "efta_common.cuh"
#include "efta_hopper.cuh"

// Phase clocks: efta_common.cuh (-DEFTA_PHASE_CLOCKS); tools/b1_phase_split.py
// names each layout's marks. -DEFTA_PAGED_FIRST_LAYOUT, which only that
// tool's `--layout narrow` build sets, keeps every shape on the first
// layout, as the kernel ran before the tile and decode layouts;
// -DEFTA_PAGED_NO_DECODE_LAYOUT, which only its `--layout long` build
// sets, gives the decode layout's shapes to the long-table layout.
#ifdef EFTA_PAGED_FIRST_LAYOUT
constexpr bool FIRST_LAYOUT_ONLY = true;
#else
constexpr bool FIRST_LAYOUT_ONLY = false;
#endif
#ifdef EFTA_PAGED_NO_DECODE_LAYOUT
constexpr bool NO_DECODE_LAYOUT = true;
#else
constexpr bool NO_DECODE_LAYOUT = false;
#endif

namespace {

constexpr int MAX_THREADS = 512;  // compute + verify warps per block
constexpr int MAX_G = 32;          // fold segments of the EXP pass's array
constexpr size_t SMEM_LIMIT = 232448;
constexpr unsigned FULL = 0xffffffffu;
constexpr int P_SITE = 0, P_BLOCK = 1, P_B = 2, P_H = 3, P_ROW = 4,
              P_COL = 5, P_BIT = 6, P_ON = 7;
// per-row values a compute warp hands from one phase to the next
constexpr int RB_BM = 0, RB_MSUB = 1, RB_ALPHA = 2, RB_PS = 3, RB_PS2 = 4,
              RB_RT = 5, RB_M = 6, RB_N = 8;

size_t up16(size_t b) { return (b + 15) & ~(size_t)15; }

// shared-memory layout (byte offsets). W row groups of 16 rows; each has G
// compute warps, warp (rg, g) taking block g of every group of G blocks.
struct Layout {
  int ldk;  // K / V / q row stride, elements of T
  int lds;  // score row stride, floats
  int ldo;  // accumulator and P V row stride, floats
  int ldf;  // K-fold row stride, floats (16-byte rows)
  size_t kv_bytes, plane_bytes, blk;  // one block's copy: K, V, 4 planes
  size_t ring;                        // ST stages of G blocks
  size_t c_sp, c_kf, c_vcs, c_pv, c_sc1, c_ocb, c_rb, c_all;  // per warp
  size_t r_qs, r_acc, r_oc, r_row, r_all;                     // per group
  size_t cw, rgs, bts, red, total;
};

Layout make_layout(int W, int G, int ST, int D, int bs, int cs, int skv,
                   int sout, int esz, int mb) {
  Layout L;
  L.ldk = esz == 2 ? D + 8 : D + 1;
  L.lds = bs + (skv < 32 ? skv : 0);
  L.lds += L.lds & 1;
  L.ldo = D + 1;
  L.ldf = D + 4;
  L.kv_bytes = up16((size_t)bs * L.ldk * esz);
  L.plane_bytes = up16((size_t)cs * D * esz);
  L.blk = 2 * L.kv_bytes + 4 * L.plane_bytes;
  L.c_sp = 0;
  L.c_kf = L.c_sp + up16((size_t)16 * L.lds * 4);
  L.c_vcs = L.c_kf + up16(2 * (size_t)skv * L.ldf * 4);
  L.c_pv = L.c_vcs + up16(2 * (size_t)bs * sout * 4);
  L.c_sc1 = L.c_pv + up16((size_t)16 * L.ldo * 4);
  L.c_ocb = L.c_sc1 + up16((size_t)16 * skv * 4);
  L.c_rb = L.c_ocb + up16(2 * (size_t)16 * sout * 4);
  L.c_all = L.c_rb + up16((size_t)RB_N * 16 * 4);
  L.r_qs = 0;
  L.r_acc = L.r_qs + up16((size_t)16 * L.ldk * esz);
  L.r_oc = L.r_acc + up16((size_t)16 * L.ldo * 4);
  L.r_row = L.r_oc + up16(2 * (size_t)16 * sout * 4);
  L.r_all = L.r_row + up16(8 * 16 * 4);
  L.ring = 0;
  L.cw = L.ring + (size_t)ST * G * L.blk;
  L.rgs = L.cw + (size_t)W * G * L.c_all;
  L.bts = L.rgs + (size_t)W * L.r_all;
  L.red = L.bts + up16((size_t)mb * 4);
  L.total = L.red + up16((size_t)(MAX_THREADS / 32) * 8 * 4);
  return L;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* kc1;
  const void* kc2;
  const void* vc1;
  const void* vc2;
  const int* bt;
  const int* kv_lens;
  const int* q_lens;
  void* out;
  int* rep;
  int* bad;
  int B, Hkv, R, chunk, D, bs, cs, mb, s_kv, s_out, window, n_tiles;
  int W, G, ST, DS;
  Layout L;
  float scale, kv_thr, eps1, eps2, eps3;
  int mode, unified, shadow_rowsum, shadow_rowmax;
  int fault[8];
};

int slice_of(int D) {
  for (int ds = 64; ds >= 16; ds -= 16)
    if (D % ds == 0) return ds;
  return 0;
}

// row groups W (the fewest of 16 rows that cover grp * C, at most 4, fewer
// where shared memory is short), blocks per step G (as many as the warps
// and shared memory allow: the work of G blocks runs side by side) and
// ring stages
bool choose_tiles(int R, int D, int bs, int cs, int skv, int sout, int esz,
                  int mb, int* W, int* G, int* ST) {
  if (R <= 0 || D % 16 || bs % 16 || bs > 64 || skv < 2 || skv > 32 ||
      (skv & (skv - 1)) || bs % skv || bs / skv > MAX_G || sout <= 0 ||
      sout > 32 || D % sout || cs <= 0 || bs % cs || slice_of(D) == 0)
    return false;
  int want = (R + 15) / 16;
  if (want > 4) want = 4;
  for (int w = want; w >= 1; --w) {
    for (int g = 8; g >= 1; --g) {
      if ((w * g + g) * 32 > MAX_THREADS) continue;
      for (int st = 3; st >= 2; --st) {
        if (make_layout(w, g, st, D, bs, cs, skv, sout, esz, mb).total <=
            SMEM_LIMIT) {
          *W = w;
          *G = g;
          *ST = st;
          return true;
        }
      }
    }
  }
  return false;
}

// checksum.block_fold_bad(encode_kv_tile(x, cs), stored) for one (bs, D)
// tile x (row stride ldx) and its resident (cs, D) planes, by one warp. In
// bf16 each lane takes 8 columns at a time (16-byte loads).
template <typename T>
__device__ bool warp_fold_bad(const T* x, int ldx, const T* c1g,
                              const T* c2g, int cs, int bs, int D, float thr,
                              int lane) {
  constexpr int V = sizeof(T) == 2 ? 8 : 1;  // columns per load
  const int n = cs * D;
  float a1 = 0.f, a2 = 0.f;
  for (int e = lane * V; e < n; e += 32 * V) {
    float c1[V], c2[V];
    load_row<T, V>(c1, c1g + e);
    load_row<T, V>(c2, c2g + e);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a1 += fabsf(c1[k]);
      a2 += fabsf(c2[k]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    a1 += __shfl_xor_sync(FULL, a1, o);
    a2 += __shfl_xor_sync(FULL, a2, o);
  }
  const float floor1 = nan_max(a1 / (float)n, 1e-6f);
  const float floor2 = nan_max(a2 / (float)n, 1e-6f);
  const int g = bs / cs;
  const Div dD(D);
  bool ok = true;
  for (int e = lane * V; e < n; e += 32 * V) {
    const int i = dD.q(e), d = e - i * D;
    float f1[V], f2[V], c1[V], c2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) f1[k] = f2[k] = 0.f;
    for (int l = 0; l < g; ++l) {
      float xv[V];
      load_row<T, V>(xv, x + (l * cs + i) * ldx + d);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        f1[k] = f1[k] + xv[k];
        f2[k] = f2[k] + (float)(l + 1) * xv[k];
      }
    }
    load_row<T, V>(c1, c1g + e);
    load_row<T, V>(c2, c2g + e);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      ok = ok && (fabsf(c1[k] - f1[k]) <= thr * nan_max(fabsf(c1[k]), floor1));
      ok = ok && (fabsf(c2[k] - f2[k]) <= thr * nan_max(fabsf(c2[k]), floor2));
    }
  }
  return __any_sync(FULL, !ok) != 0;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) efta_paged_kernel(const Params P) {
  constexpr bool BF = sizeof(T) == 2;
  const Layout& L = P.L;
  const int b = blockIdx.x, h = blockIdx.y, tile = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int NT = blockDim.x;
  const int W = P.W, G = P.G, ST = P.ST, R = P.R, D = P.D, bs = P.bs,
            cs = P.cs, skv = P.s_kv, sout = P.s_out, C = P.chunk, mb = P.mb,
            DS = P.DS;
  const int ldk = L.ldk, lds = L.lds, ldo = L.ldo, ldf = L.ldf;
  const int row0 = tile * 16 * W;
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const int g_kv = bs / skv, g_out = D / sout;
  const float MASK_VALUE = (float)MASK_D;
  const float MASK_HALF = (float)(MASK_D / 2);
  const float cap = (float)(80.0 / g_kv);
  const float cap_g = (float)(80.0 / g_kv * g_kv);
  const float cap_m = (float)(80.0 / g_kv - 1e-3);
  const int kv_len = P.kv_lens[b], q_len = P.q_lens[b];
  const int window = P.window;
  const int base = kv_len - q_len;
  const size_t bh = (size_t)b * P.Hkv + h;
  const int gq = lane >> 2, t4 = lane & 3;  // mma fragment row, column
  const Div dD(D), dskv(skv), dsout(sout), dC(C), dbs(bs), dDS(DS),
      dper(D * (int)sizeof(T) / 16);
  const bool f_bh = P.fault[P_ON] == 1 && P.fault[P_B] == b &&
                    P.fault[P_H] == h;
  const int f_col = P.fault[P_COL], f_bit = P.fault[P_BIT],
            f_site = P.fault[P_SITE], f_blk = P.fault[P_BLOCK];
  // GEMM I and II on tensor cores in bf16; with the per-step output check
  // (unified = 0) sequential f32 FMAs, the plain version's order, whose
  // count of columns at the check's absolute threshold follows it
  const bool tc = BF && P.unified;
  PHASE_INIT

  // warps 0 .. W*G-1 compute (row group rg, block slot gs); with EFTA on,
  // G more verify the slots' blocks against their resident planes
  const int ncw = W * G;
  const bool compute = w < ncw;
  const bool verifier = ft && !compute;
  const int rg = compute ? w / G : 0;
  const int gs = compute ? w - rg * G : w - ncw;
  const int grow0 = row0 + 16 * rg;
  // the group's rows below R: every one is computed and counted, query or
  // padding, as the reference counts them (a resident flip makes a padding
  // row's GEMM I check fire too)
  const int nrw = compute ? max(0, min(16, R - grow0)) : 0;
  const bool gact = nrw > 0;
  // rows the per-row phases run: the real ones, rounded up to whole passes
  // of the warp (32 / s_kv rows each); rows past R never reach the output
  const int rpp = 32 / skv;
  const int prow = min(16, (nrw + rpp - 1) / rpp * rpp);
  const int fr = P.fault[P_ROW] - grow0;
  const bool f_grp = f_bh && fr >= 0 && fr < nrw;
  T* og = (T*)P.out + (bh * R + grow0) * D;
  int* rep = P.rep + (bh * P.n_tiles + tile) * 6;

  // the running blocks form one interval [j_lo, j_lo + n_run)
  auto runs = [&](int j) {
    return j * bs < kv_len && base - (j * bs + bs - 1) < window;
  };
  int j_lo = 0;
  while (j_lo < mb && !runs(j_lo)) ++j_lo;
  int n_run = 0;
  while (j_lo + n_run < mb && runs(j_lo + n_run)) ++n_run;
  const bool planes = ft && tile == 0;
  if (tile == 0) {
    // the bad plane of every block that does not run (or is not verified)
    for (int j = tid; j < mb; j += NT)
      if (!(ft && j >= j_lo && j < j_lo + n_run)) P.bad[bh * mb + j] = 0;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + L.ring;
  auto cw_of = [&](int slot) {  // a compute warp's region: (rg, slot)
    return smem + L.cw + (size_t)(rg * G + slot) * L.c_all;
  };
  unsigned char* cwp = cw_of(gs);
  float* sp = (float*)(cwp + L.c_sp);
  float* kf1 = (float*)(cwp + L.c_kf);
  float* kf2 = kf1 + skv * ldf;
  float* vcs1 = (float*)(cwp + L.c_vcs);
  float* vcs2 = vcs1 + bs * sout;
  float* pvb = (float*)(cwp + L.c_pv);
  float* sc1 = (float*)(cwp + L.c_sc1);
  float* ocb1 = (float*)(cwp + L.c_ocb);
  float* ocb2 = ocb1 + 16 * sout;
  float* rb = (float*)(cwp + L.c_rb);
  unsigned char* rgp = smem + L.rgs + (size_t)rg * L.r_all;
  T* qs = (T*)(rgp + L.r_qs);
  float* acc = (float*)(rgp + L.r_acc);
  float* oc1 = (float*)(rgp + L.r_oc);
  float* oc2 = oc1 + 16 * sout;
  float* m_s = (float*)(rgp + L.r_row);
  float* l_s = m_s + 16;
  float* lsh_s = l_s + 16;
  float* r_s = lsh_s + 16;
  float* lsafe_s = r_s + 16;
  float* red = (float*)(smem + L.red);
  int* bts = (int*)(smem + L.bts);  // the running blocks' pool ids
  for (int k = tid; k < n_run; k += NT) bts[k] = P.bt[(size_t)b * mb + j_lo + k];

  if (compute && gs == 0 && gact) {
    const T* qg = (const T*)P.q + (bh * R + grow0) * D;
    for (int e = lane; e < 16 * D; e += 32) {
      const int r = e / D, d = e - r * D;
      qs[r * ldk + d] = r < nrw ? qg[r * D + d] : from_f<T>(0.f);
      acc[r * ldo + d] = 0.f;
    }
    for (int e = lane; e < 16 * sout; e += 32) oc1[e] = oc2[e] = 0.f;
    if (lane < 16) {
      m_s[lane] = MASK_VALUE;
      l_s[lane] = lsh_s[lane] = r_s[lane] = 0.f;
    }
  }
  float vm = 0.f;  // a verify warp's share of max|V|
  int det[6] = {0, 0, 0, 0, 0, 0};

  // ---- the load stream: step s copies blocks j_lo + s*G + k (k < G) into
  //      ring stage s % ST ----
  const int n_steps = (n_run + G - 1) / G;
  __syncthreads();  // the block ids are in
  auto issue = [&](int step) {
    const int n0 = step * G, gv = min(G, n_run - n0);
    unsigned char* stage = ring + (size_t)(step % ST) * G * L.blk;
    for (int k = 0; k < gv; ++k) {
      const int bid = bts[n0 + k];
      const size_t blk = (size_t)bid * P.Hkv + h;
      unsigned char* slot = stage + (size_t)k * L.blk;
      for (int t = 0; t < 2; ++t) {
        const T* src = (const T*)(t ? P.v : P.k) + blk * bs * D;
        T* dst = (T*)(slot + t * L.kv_bytes);
        if constexpr (BF) {
          const int per = D / 8;
          for (int e = tid; e < bs * per; e += NT) {
            const int c = dper.q(e), p8 = e - c * per;
            cp_async16(dst + c * ldk + p8 * 8, src + (size_t)c * D + p8 * 8);
          }
        } else {
          for (int e = tid; e < bs * D; e += NT) {
            const int c = dD.q(e), d = e - c * D;
            cp_async4(dst + c * ldk + d, src + (size_t)c * D + d);
          }
        }
      }
      if (planes) {
        const void* pl[4] = {P.kc1, P.kc2, P.vc1, P.vc2};
        const int n16 = cs * D * (int)sizeof(T) / 16;
        for (int t = 0; t < 4; ++t) {
          const unsigned char* src =
              (const unsigned char*)pl[t] + blk * cs * D * sizeof(T);
          unsigned char* dst = slot + 2 * L.kv_bytes + t * L.plane_bytes;
          for (int e = tid; e < n16; e += NT)
            cp_async16(dst + 16 * e, src + 16 * e);
        }
      }
    }
  };
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_steps) issue(s);
    cp_async_commit();
  }
  __syncthreads();
  PHASE_MARK(0)

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait(ST - 2);
    __syncthreads();  // step's blocks landed; the stage refilled next is free
    if (step + ST - 1 < n_steps) issue(step + ST - 1);
    cp_async_commit();
    PHASE_MARK(1)
    const int n0 = step * G, gv = min(G, n_run - n0);
    const bool mine = gs < gv;  // this warp has a block in the step
    const int j = j_lo + n0 + gs, kv_start = j * bs;
    const unsigned char* slot =
        ring + ((size_t)(step % ST) * G + gs) * L.blk;
    const T* ks = (const T*)slot;
    const T* vs = (const T*)(slot + L.kv_bytes);
    const bool hit = f_grp && f_blk == j;

    // ---- phase A: each slot's block, state-independent ----
    if (verifier && mine) {
      // site 6 (kv): resident block verify (tile 0), and max|V|
      if (planes) {
        const T* pl = (const T*)(slot + 2 * L.kv_bytes);
        const size_t ps = L.plane_bytes / sizeof(T);
        const bool bad_k = warp_fold_bad<T>(ks, ldk, pl, pl + ps, cs, bs, D,
                                            P.kv_thr, lane);
        const bool bad_v = warp_fold_bad<T>(vs, ldk, pl + 2 * ps, pl + 3 * ps,
                                            cs, bs, D, P.kv_thr, lane);
        const bool flag = (bad_k || bad_v) && bts[n0 + gs] > 0;
        if (lane == 0) {
          det[5] += flag;
          P.bad[bh * mb + j] = flag;
        }
      }
      constexpr int V = BF ? 8 : 1;
      for (int e = lane * V; e < bs * D; e += 32 * V) {
        const int c = dD.q(e), d = e - c * D;
        float xv[V];
        load_row<T, V>(xv, vs + c * ldk + d);
#pragma unroll
        for (int k = 0; k < V; ++k) vm = nan_max(vm, fabsf(xv[k]));
      }
    } else if (compute && gact && mine) {
      if (ft) {
        // tensor checksums of K at the ABFT stride, V column checksums
#pragma unroll 2
        for (int e = lane; e < skv * D; e += 32) {
          const int i = dD.q(e), d = e - i * D;
          float f1 = 0.f, f2 = 0.f;
#pragma unroll 4
          for (int l = 0; l < g_kv; ++l) {
            const float x = to_f(ks[(l * skv + i) * ldk + d]);
            f1 = f1 + x;
            f2 = f2 + (float)(l + 1) * x;
          }
          kf1[i * ldf + d] = f1;
          kf2[i * ldf + d] = f2;
        }
#pragma unroll 2
        for (int e = lane; e < bs * sout; e += 32) {
          const int c = dsout.q(e), i = e - c * sout;
          float f1 = 0.f, f2 = 0.f;
#pragma unroll 8
          for (int l = 0; l < g_out; ++l) {
            const float x = to_f(vs[c * ldk + l * sout + i]);
            f1 = f1 + x;
            f2 = f2 + (float)(l + 1) * x;
          }
          vcs1[e] = f1;
          vcs2[e] = f2;
        }
      }

      // GEMM I (f32 accumulate) + NVR clip
      if (tc) {
        if constexpr (BF) {
          const int nt_n = bs / 8;
          float c[8][4];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
          const int l16 = lane & 15;
          for (int ksx = 0; ksx < D / 16; ++ksx) {
            uint32_t a[4];
            ldmatrix_x4(a, qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldk +
                               ksx * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              if (nt < nt_n) {
                uint32_t bb[2];
                ldmatrix_x2(bb, ks + (nt * 8 + (l16 & 7)) * ldk + ksx * 16 +
                                    (l16 >> 3) * 8);
                mma_bf16(c[nt], a, bb);
              }
            }
          }
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt < nt_n) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = gq + (e >> 1) * 8;
                const int col = nt * 8 + 2 * t4 + (e & 1);
                float sv = c[nt][e] * P.scale;
                if (hit && f_site == S_GEMM1 && r == fr && col == f_col)
                  sv = flip_bit(sv, f_bit);
                if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
                sp[r * lds + col] = sv;
              }
            }
          }
        }
      } else {
        for (int e = lane; e < prow * bs; e += 32) {
          const int r = dbs.q(e), c = e - r * bs;
          float a = 0.f;
#pragma unroll 4
          for (int d = 0; d < D; ++d)
            a = fmaf(to_f(qs[r * ldk + d]), to_f(ks[c * ldk + d]), a);
          float sv = a * P.scale;
          if (hit && f_site == S_GEMM1 && r == fr && c == f_col)
            sv = flip_bit(sv, f_bit);
          if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
          sp[r * lds + c] = sv;
        }
      }
      __syncwarp();

      if (ft) {
        // CCG: checksum GEMMs, verify, locate + correct
        for (int p = lane; p < prow * skv; p += 32) {
          const int r = dskv.q(p), i = p - r * skv;
          float a1 = 0.f, a2 = 0.f;
          qk_fold<T>(qs + r * ldk, kf1 + i * ldf, kf2 + i * ldf, D, &a1, &a2);
          const float c1 = a1 * P.scale, c2 = a2 * P.scale;
          sc1[p] = c1;
          float sum1 = 0.f, sum2 = 0.f;
#pragma unroll 4
          for (int l = 0; l < g_kv; ++l) {
            const float x = sp[r * lds + l * skv + i];
            sum1 = sum1 + x;
            sum2 = sum2 + (float)(l + 1) * x;
          }
          const float d1 = c1 - sum1, d2 = c2 - sum2;
          const bool bad = fabsf(d1) > P.eps1;
          if (r < nrw) det[0] += bad;
          if (correct && bad) sp[r * lds + seg_of(d1, d2, g_kv) * skv + i] += d1;
        }
        __syncwarp();
      }

      // per-row mask and block max: s_kv lanes per row
      for (int p = lane; p < prow * skv; p += 32) {
        const int r = dskv.q(p), i = p - r * skv;
        const int crow = dC.r(grow0 + r);
        const int qpos = base + crow;
        float bm = MASK_VALUE;
#pragma unroll 4
        for (int l = 0; l < g_kv; ++l) {
          const int col = kv_start + l * skv + i;
          const bool mk = col <= qpos && qpos - col < window && crow < q_len;
          bm = nan_max(bm, mk ? sp[r * lds + l * skv + i] : MASK_VALUE);
        }
        for (int o = skv >> 1; o > 0; o >>= 1)
          bm = nan_max(bm, __shfl_xor_sync(FULL, bm, o));
        if (i == 0) rb[RB_BM * 16 + r] = bm;
      }
    }
    PHASE_MARK(2)
    __syncthreads();
    PHASE_MARK(3)

    // ---- phase B: each slot's block, at its place in the sequence ----
    if (compute && gact && mine) {
      // the running max through the step's blocks 0 .. gs, in order, with
      // the shadow check (counted by the warp whose block it is)
      if (lane < prow) {
        const int r = lane;
        float mp = m_s[r], mn = mp;
        for (int k = 0; k <= gs; ++k) {
          const float bm = ((float*)(cw_of(k) + L.c_rb))[RB_BM * 16 + r];
          mp = mn;
          mn = nan_max(mp, bm);
          if (f_grp && f_site == S_ROWMAX && f_blk == j_lo + n0 + k &&
              r == fr)
            mn = flip_bit(mn, f_bit);
          if (ft && P.shadow_rowmax) {
            const float mc = nan_max(opaque(mp), bm);
            const bool bad = mn != mc;
            if (k == gs && r < nrw) det[2] += bad;
            if (correct && bad) mn = mc;
          }
        }
        const bool alive = mn > MASK_HALF;
        rb[RB_MSUB * 16 + r] = alive ? mn : 0.f;
        rb[RB_ALPHA * 16 + r] = alive ? expf(mp - mn) : 1.f;
        rb[RB_M * 16 + r] = mn;
      }
      __syncwarp();

      // EXP with checksum reuse (paper Case 2), backstop, mask, rowsum
      // (+ shadow); p is written over s
      for (int p = lane; p < prow * skv; p += 32) {
        const int r = dskv.q(p), i = p - r * skv;
        const int crow = dC.r(grow0 + r);
        const int qpos = base + crow;
        const float ms = rb[RB_MSUB * 16 + r];
        float* srow = sp + r * lds + i;
        float pr[MAX_G];
        float prod = 1.f;
        bool col_ok = true;
#pragma unroll 4
        for (int l = 0; l < g_kv; ++l) {
          const float sv = srow[l * skv];
          float x = expf(nan_min(sv - ms, cap));
          if (hit && f_site == S_EXP && r == fr && l * skv + i == f_col)
            x = flip_bit(x, f_bit);
          pr[l] = x;
          prod = prod * x;
          col_ok = col_ok && !((sv - ms) > cap_m);
        }
        if (ft) {
          const float pc1 = expf(nan_min(sc1[p] - (float)g_kv * ms, cap_g));
          const float ref = nan_max(fabsf(pc1), 1e-20f);
          const bool bad = col_ok && (fabsf(prod - pc1) > P.eps2 * ref + 1e-20f);
          if (r < nrw) det[1] += bad;
          if (correct && bad) {
#pragma unroll 4
            for (int l = 0; l < g_kv; ++l)
              pr[l] = expf(nan_min(srow[l * skv] - ms, cap));
          }
        }
        float ps = 0.f, ps2 = 0.f;
#pragma unroll 4
        for (int l = 0; l < g_kv; ++l) {
          float x = pr[l];
          if (ft && P.shadow_rowmax && correct) {
            // exact recompute backstop
            const float rc = expf(nan_min(srow[l * skv] - ms, cap));
            const bool slipped = x != rc;
            if (r < nrw) det[1] += slipped;
            if (slipped) x = rc;
          }
          const int col = kv_start + l * skv + i;
          const bool mk = col <= qpos && qpos - col < window && crow < q_len;
          x = mk ? x : 0.f;
          srow[l * skv] = x;
          ps = ps + x;
          ps2 = ps2 + opaque(x);
        }
        for (int o = skv >> 1; o > 0; o >>= 1) {
          ps = ps + __shfl_xor_sync(FULL, ps, o);
          ps2 = ps2 + opaque(__shfl_xor_sync(FULL, ps2, o));
        }
        if (i == 0) {
          rb[RB_PS * 16 + r] = ps;
          rb[RB_PS2 * 16 + r] = ps2;
          const float bm = rb[RB_BM * 16 + r];
          rb[RB_RT * 16 + r] = bm > MASK_HALF ? expf(bm - ms) : 0.f;
        }
      }
      __syncwarp();

      // GEMM II of the block (f32 accumulate, from zero)
      for (int sl = 0; sl < D / DS; ++sl) {
        if (tc) {
          if constexpr (BF) {
            float pv[8][4];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) pv[nt][0] = pv[nt][1] = pv[nt][2] = pv[nt][3] = 0.f;
            for (int ksx = 0; ksx < bs / 16; ++ksx) {
              const int k = ksx * 16 + 2 * t4;
              const float2 x0 = *(const float2*)(sp + gq * lds + k);
              const float2 x1 = *(const float2*)(sp + (gq + 8) * lds + k);
              const float2 x2 = *(const float2*)(sp + gq * lds + k + 8);
              const float2 x3 = *(const float2*)(sp + (gq + 8) * lds + k + 8);
              const uint32_t a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                                     pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
#pragma unroll
              for (int np = 0; np < 4; ++np) {
                if (np * 16 < DS) {
                  uint32_t bb[4];
                  ldmatrix_x4_trans(bb, vs + (ksx * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) * ldk +
                                            sl * DS + np * 16 + (lane >> 4) * 8);
                  mma_bf16(pv[2 * np], a, bb);
                  mma_bf16(pv[2 * np + 1], a, bb + 2);
                }
              }
            }
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              if (nt * 8 < DS) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const int r = gq + (e >> 1) * 8;
                  const int col = sl * DS + nt * 8 + 2 * t4 + (e & 1);
                  pvb[r * ldo + col] = pv[nt][e];
                }
              }
            }
          }
        } else {
          for (int e = lane; e < prow * DS; e += 32) {
            const int r = dDS.q(e), col = sl * DS + (e - r * DS);
            float a = 0.f;
#pragma unroll 4
            for (int c = 0; c < bs; ++c)
              a = fmaf(round_to<T>(sp[r * lds + c]), to_f(vs[c * ldk + col]),
                       a);
            pvb[r * ldo + col] = a;
          }
        }
      }
      if (ft) {
        // the block's O-checksum products
        for (int p = lane; p < prow * sout; p += 32) {
          const int r = dsout.q(p), i = p - r * sout;
          float a1 = 0.f, a2 = 0.f;
#pragma unroll 8
          for (int c = 0; c < bs; ++c) {
            const float pf = sp[r * lds + c];
            a1 = fmaf(pf, vcs1[c * sout + i], a1);
            a2 = fmaf(pf, vcs2[c * sout + i], a2);
          }
          ocb1[p] = a1;
          ocb2[p] = a2;
        }
      }
    }
    PHASE_MARK(4)
    __syncthreads();
    PHASE_MARK(3)

    // ---- phase C: the step's blocks into the running state, in order:
    //      rescale + rowsum (+ shadow), SNVR, GEMM II + O checksums ----
    if (compute && gact && !(ft && !P.unified)) {
      // every (row, column) of acc, every row's scalars and every O
      // checksum by its own lane of the group's G warps
      const int gl = gs * 32 + lane, gn = G * 32;
      for (int e = gl; e < prow * D; e += gn) {
        const int r = dD.q(e), d = e - r * D;
        float an = acc[r * ldo + d];
        for (int k = 0; k < gv; ++k) {
          const unsigned char* ck = cw_of(k);
          const float a = ((const float*)(ck + L.c_rb))[RB_ALPHA * 16 + r];
          an = a * an + ((const float*)(ck + L.c_pv))[r * ldo + d];
          if (f_grp && f_site == S_GEMM2 && f_blk == j_lo + n0 + k &&
              r == fr && d == f_col)
            an = flip_bit(an, f_bit);
        }
        acc[r * ldo + d] = an;
      }
      for (int r = gl; r < prow; r += gn) {
        float l = l_s[r], lsh = lsh_s[r], rr = r_s[r];
        for (int k = 0; k < gv; ++k) {
          const float* rbk = (const float*)(cw_of(k) + L.c_rb);
          const float a = rbk[RB_ALPHA * 16 + r];
          float ln = a * l + rbk[RB_PS * 16 + r];
          if (f_grp && f_site == S_ROWSUM && f_blk == j_lo + n0 + k &&
              r == fr)
            ln = flip_bit(ln, f_bit);
          l = ln;
          if (ft && P.shadow_rowsum) lsh = a * lsh + rbk[RB_PS2 * 16 + r];
          rr = a * rr + rbk[RB_RT * 16 + r];
        }
        l_s[r] = l;
        lsh_s[r] = lsh;
        r_s[r] = rr;
        m_s[r] = ((const float*)(cw_of(gv - 1) + L.c_rb))[RB_M * 16 + r];
      }
      if (ft) {
        for (int e = gl; e < prow * sout; e += gn) {
          const int r = dsout.q(e);
          float o1 = oc1[e], o2 = oc2[e];
          for (int k = 0; k < gv; ++k) {
            const unsigned char* ck = cw_of(k);
            const float a = ((const float*)(ck + L.c_rb))[RB_ALPHA * 16 + r];
            const float* ob = (const float*)(ck + L.c_ocb);
            o1 = a * o1 + ob[e];
            o2 = a * o2 + ob[16 * sout + e];
          }
          oc1[e] = o1;
          oc2[e] = o2;
        }
      }
    } else if (compute && gact) {
      // with the per-step output check: a row at a time, its check after
      // every block
      for (int r = gs; r < prow; r += G) {
        float l = l_s[r], lsh = lsh_s[r], rr = r_s[r];
        float o1 = 0.f, o2 = 0.f;
        if (lane < sout) {
          o1 = oc1[r * sout + lane];
          o2 = oc2[r * sout + lane];
        }
        for (int k = 0; k < gv; ++k) {
          const unsigned char* ck = cw_of(k);
          const float* rbk = (const float*)(ck + L.c_rb);
          const float a = rbk[RB_ALPHA * 16 + r];
          const bool hk = f_grp && f_blk == j_lo + n0 + k && r == fr;
          float ln = a * l + rbk[RB_PS * 16 + r];
          if (hk && f_site == S_ROWSUM) ln = flip_bit(ln, f_bit);
          l = ln;
          if (P.shadow_rowsum) lsh = a * lsh + rbk[RB_PS2 * 16 + r];
          rr = a * rr + rbk[RB_RT * 16 + r];
          const float* pvk = (const float*)(ck + L.c_pv) + r * ldo;
          for (int d = lane; d < D; d += 32) {
            float an = a * acc[r * ldo + d] + pvk[d];
            if (hk && f_site == S_GEMM2 && d == f_col) an = flip_bit(an, f_bit);
            acc[r * ldo + d] = an;
          }
          if (lane < sout) {
            const float* ob = (const float*)(ck + L.c_ocb);
            o1 = a * o1 + ob[r * sout + lane];
            o2 = a * o2 + ob[16 * sout + r * sout + lane];
          }
          __syncwarp();
          if (lane < sout) {
            float s1 = 0.f;
            for (int q = 0; q < g_out; ++q)
              s1 = s1 + acc[r * ldo + q * sout + lane];
            if (r < nrw) det[4] += fabsf(o1 - s1) > P.eps3;
          }
          __syncwarp();
        }
        if (lane == 0) {
          l_s[r] = l;
          lsh_s[r] = lsh;
          r_s[r] = rr;
          m_s[r] = ((const float*)(cw_of(gv - 1) + L.c_rb))[RB_M * 16 + r];
        }
        if (lane < sout) {
          oc1[r * sout + lane] = o1;
          oc2[r * sout + lane] = o2;
        }
      }
    }
    PHASE_MARK(5)
  }

  // ---- max|V| from the verify warps (read only by the clamp) ----
  for (int o = 16; o > 0; o >>= 1) vm = nan_max(vm, __shfl_xor_sync(FULL, vm, o));
  __syncthreads();
  if (lane == 0) red[w] = vm;
  __syncthreads();
  float vmax = 0.f;
  if (ft)
    for (int i = ncw; i < NT / 32; ++i) vmax = nan_max(vmax, red[i]);

  if (compute && gact) {
    // ---- finalize, a row per warp at a time: SNVR on l + unified output
    //      verification ----
    const float bound = vmax * 1.001f + 1e-6f;
    for (int r = gs; r < nrw; r += G) {
      const int crow = dC.r(grow0 + r);
      float lf = l_s[r];
      if (ft) {
        const float rf = r_s[r];
        const float upper = (float)min(base + crow + 1, kv_len) + 1e-3f;
        const bool in_range = lf >= rf - 1e-3f && lf <= upper && isfinite(lf);
        bool bad;
        float fallback;
        if (P.shadow_rowsum) {
          const float lsh = lsh_s[r];
          const bool mism = fabsf(lf - lsh) > 1e-5f * nan_max(fabsf(lsh), 1e-6f);
          bad = (!in_range || mism) && rf > 0.f;
          const bool fb_ok = lsh >= rf - 1e-3f && lsh <= upper && isfinite(lsh);
          fallback = fb_ok ? lsh : rf;
        } else {
          bad = !in_range && rf > 0.f;
          fallback = rf;
        }
        if (lane == 0) det[3] += bad;
        if (correct && bad) lf = fallback;
      }
      const float ls = lf == 0.f ? 1.f : lf;
      for (int d = lane; d < D; d += 32) {
        float o = acc[r * ldo + d] / ls;
        if (ft && correct) o = (isfinite(o) && fabsf(o) <= bound) ? o : 0.f;
        acc[r * ldo + d] = o;
      }
      __syncwarp();
      if (ft && lane < sout) {
        const int i = lane;
        float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
        for (int q = 0; q < g_out; ++q) {
          const float x = acc[r * ldo + q * sout + i];
          s1 = s1 + x;
          s2 = s2 + (float)(q + 1) * x;
        }
        const float d1 = oc1[r * sout + i] / ls - s1;
        const float d2 = oc2[r * sout + i] / ls - s2;
        const bool bad = !(fabsf(d1) <= P.eps3);
        det[4] += bad;
        if (correct && bad) acc[r * ldo + seg_of(d1, d2, g_out) * sout + i] += d1;
      }
      __syncwarp();
      for (int d = lane; d < D; d += 32) og[r * D + d] = from_f<T>(acc[r * ldo + d]);
    }
  }
  PHASE_MARK(6)

  // ---- the block's partial counts: warps in order, no atomics ----
  int* redi = (int*)(red + MAX_THREADS / 32);
  for (int k = 0; k < 6; ++k) {
    int v = det[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) redi[w * 6 + k] = v;
  }
  __syncthreads();
  if (tid < 6) {
    int tot = 0;
    for (int i = 0; i < NT / 32; ++i) tot += redi[i * 6 + tid];
    rep[tid] = tot;
  }
  PHASE_MARK(7)
  PHASE_FLUSH
}

#include "efta_paged_tile.cuh"
#include "efta_paged_decode.cuh"
#include "efta_paged_long.cuh"

// the tile layout's rule: bf16, unified output verification, grp x C >= 64
// rows, 16-key blocks at ABFT stride 4, D a multiple of 16 up to 128, s_out
// up to 32; three ring stages, else two, within the SM's shared memory
bool choose_ptile(int R, int D, int bs, int cs, int skv, int sout, int esz,
                  int unified, int* ST) {
  if (FIRST_LAYOUT_ONLY || esz != 2 || !unified || R < PT_ROWS || bs != PT_BS || skv != PT_SKV ||
      D % 16 || D > 32 * PT_NT2 || sout <= 0 || sout > 32 || D % sout ||
      cs <= 0 || bs % cs || (cs * D * esz) % 16)
    return false;
  for (int st = 3; st >= 2; --st) {
    if (make_ptile_layout(st, D, sout).total <= SMEM_LIMIT) {
      *ST = st;
      return true;
    }
  }
  return false;
}

// the decode layout's rule: one chunk row, unified output verification,
// 16-key blocks at ABFT stride 4, D a multiple of 16 up to 256, s_out up to
// 32, and a CTA's share of the table (ceil(mb / 8) blocks: V and the
// partials exchange 2 reads) within the SM's shared memory. Blocks a
// phase-A step: the most (at most PD_KG) that leave room for two CTAs an
// SM, else the most that fit one
bool choose_pdecode(int R, int C, int D, int bs, int cs, int skv, int sout,
                    int esz, int unified, int mb, int* KG) {
  if (FIRST_LAYOUT_ONLY || NO_DECODE_LAYOUT || C != 1 || !unified ||
      R <= 0 || mb <= 0 || bs != PD_BS || skv != PD_SKV || D <= 0 ||
      D % 16 || D > 256 || sout <= 0 || sout > 32 || D % sout || cs <= 0 ||
      bs % cs || (cs * D * esz) % 16)
    return false;
  const int span = (mb + PD_CTAS - 1) / PD_CTAS;
  const size_t caps[2] = {PD_SMEM_PAIR, SMEM_LIMIT};
  for (int c = 0; c < 2; ++c) {
    for (int kg = span < PD_KG ? span : PD_KG; kg >= 1; --kg) {
      if (make_pdecode_layout(kg, R, D, cs, sout, esz, mb).total <=
          caps[c]) {
        *KG = kg;
        return true;
      }
    }
  }
  return false;
}

// the long-table layout's rule: the decode layout's shapes (one chunk row,
// unified output verification, 16-key blocks at ABFT stride 4, D a multiple
// of 16 up to 256, s_out up to 32) at any table width. Blocks a group G:
// the most (at most PL_G) whose score and EXP passes leave room for three
// CTAs an SM, else two, else one; CTAs a unit in those passes GY: one a
// group, at most PL_GY
bool choose_plong(int R, int C, int D, int bs, int cs, int skv, int sout,
                  int esz, int unified, int mb, int* G, int* GY) {
  if (FIRST_LAYOUT_ONLY || C != 1 || !unified || R <= 0 || mb <= 0 ||
      bs != PD_BS || skv != PD_SKV || D <= 0 || D % 16 || D > 256 ||
      sout <= 0 || sout > 32 || D % sout || cs <= 0 || bs % cs ||
      (cs * D * esz) % 16)
    return false;
  const size_t caps[3] = {PL_SMEM_TRIPLE, PD_SMEM_PAIR, SMEM_LIMIT};
  for (int c = 0; c < 3; ++c) {
    for (int g = PL_G; g >= 1; --g) {
      const PLLayout L = make_plong_layout(g, R, D, cs, sout, esz);
      if (L.total <= caps[c] && L.e_total <= caps[c]) {
        const int groups = (mb + g - 1) / g;
        *G = g;
        *GY = groups < PL_GY ? groups : PL_GY;
        return true;
      }
    }
  }
  return false;
}

// the long-table layout: the score, EXP and state passes, in turn
template <typename T>
cudaError_t launch_plong(const PLParams& c, cudaStream_t stream) {
  const size_t a = c.L.total, e = c.L.e_total,
               st = plong_state_smem(c.P.D, c.P.s_out);
  if (a > SMEM_LIMIT || e > SMEM_LIMIT || st > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      efta_paged_kernel_lscore<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(efta_paged_kernel_lexp<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)e);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(efta_paged_kernel_lstate<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)st);
  if (err != cudaSuccess) return err;
  const unsigned units = (unsigned)(c.P.B * c.P.Hkv * c.n_rg);
  const dim3 grid(units, c.GY);
  efta_paged_kernel_lscore<T><<<grid, PL_THREADS, a, stream>>>(c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  efta_paged_kernel_lexp<T><<<grid, PL_THREADS, e, stream>>>(c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  efta_paged_kernel_lstate<T><<<dim3(units, PD_ROWS), PL_ST_THREADS, st,
                                stream>>>(c);
  return cudaGetLastError();
}

// the decode layout: one launch, a cluster of PD_CTAS CTAs a unit
template <typename T>
cudaError_t launch_pdecode(const PDParams& c, cudaStream_t stream) {
  const size_t bytes = c.L.total;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      efta_paged_kernel_decode<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(PD_CTAS * c.P.B * c.P.Hkv * c.n_rg);
  cfg.blockDim = dim3(PD_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = PD_CTAS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, efta_paged_kernel_decode<T>, c);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the tile layout: the fold pass, then one CTA for each 64-row tile
cudaError_t launch_ptile(const PTParams& c, cudaStream_t stream) {
  const size_t bytes = c.L.total;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  efta_paged_kernel_fold<<<dim3(c.P.mb, c.P.Hkv, c.P.B), PT_FOLD_THREADS, 0,
                           stream>>>(c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(efta_paged_kernel_tile,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  efta_paged_kernel_tile<<<dim3(c.P.n_tiles, c.P.Hkv, c.P.B),
                           PT_NT + PRODUCER_THREADS, bytes, stream>>>(c);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = p.L.total;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      efta_paged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B, p.Hkv, p.n_tiles);
  const int warps = p.W * p.G + (p.mode != 0 ? p.G : 0);
  efta_paged_kernel<T><<<grid, 32 * warps, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Row tiles per (request, kv head) for these shapes (the decode layout:
// CTAs, 8 a unit of 16 rows; the long-table layout: the count rows of its
// CTAs, GY + 16 a unit), or 0 when the kernel takes no tiling of them.
// dtype as below; unified and the chunk width C as the launch's.
// With `tiling` (8 ints, or NULL) also the choice:
// {row groups W, blocks a step G, ring stages ST, shared-memory bytes, the
// scratch's floats a (request, KV head, block) (0 but on the tile and the
// long-table layouts), the tile layout, CTAs a cluster (0 but on the
// decode layout), the long-table layout}. On the long-table layout G is
// the blocks of a group, ST the CTAs a unit of its score and EXP passes
// (GY) and smem the larger pass's bytes.
int efta_paged_tiling(int dtype, int R, int D, int bs, int cs, int s_kv,
                      int s_out, int mb, int unified, int chunk,
                      int* tiling) {
  const int esz = dtype == 0 ? 4 : 2;
  int W = 0, G = 0, ST = 0, smem = 0, floats = 0, n = 0, cl = 0, lg = 0;
  const bool pt = choose_ptile(R, D, bs, cs, s_kv, s_out, esz, unified, &ST);
  if (choose_pdecode(R, chunk, D, bs, cs, s_kv, s_out, esz, unified, mb,
                     &G)) {
    W = PD_ROWS / 16;
    ST = 1;
    smem = (int)make_pdecode_layout(G, R, D, cs, s_out, esz, mb).total;
    cl = PD_CTAS;
    n = (R + PD_ROWS - 1) / PD_ROWS * PD_CTAS;
  } else if (choose_plong(R, chunk, D, bs, cs, s_kv, s_out, esz, unified, mb,
                          &G, &ST)) {
    const PLLayout L = make_plong_layout(G, R, D, cs, s_out, esz);
    const int n_rg = (R + PD_ROWS - 1) / PD_ROWS;
    W = PD_ROWS / 16;
    smem = (int)(L.total > L.e_total ? L.total : L.e_total);
    floats = n_rg * make_plong_slot(R, D, s_out).floats;
    lg = 1;
    n = n_rg * (ST + PD_ROWS);
  } else if (pt) {
    W = PT_ROWS / 16;
    G = PT_G;
    smem = (int)make_ptile_layout(ST, D, s_out).total;
    floats = make_pfold(D, s_out).floats;
    n = (R + PT_ROWS - 1) / PT_ROWS;
  } else {
    if ((cs * D * esz) % 16 ||
        !choose_tiles(R, D, bs, cs, s_kv, s_out, esz, mb, &W, &G, &ST))
      return 0;
    smem = (int)make_layout(W, G, ST, D, bs, cs, s_kv, s_out, esz, mb).total;
    n = (R + 16 * W - 1) / (16 * W);
  }
  if (tiling) {
    const int v[8] = {W, G, ST, smem, floats, pt && !cl && !lg ? 1 : 0, cl,
                      lg};
    for (int i = 0; i < 8; ++i) tiling[i] = v[i];
  }
  return n;
}

#ifdef EFTA_PHASE_CLOCKS
// the phase clocks' 16 sums (cycles), then zeroed
int efta_paged_phase_clocks(unsigned long long* out) {
  return efta_read_phase_clocks(out);
}
#endif

const char* efta_paged_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16 (q, pools, checksum planes and out).
// Pointers are device pointers; rep is (B, Hkv, tiles, 6) int32 (tiles as
// efta_paged_tiling returns them; the decode layout's are CTAs). Where the
// tiling takes the tile layout, ws holds the fold pass's (B, Hkv, mb) slots,
// and where it takes the long-table layout, the workspace's (efta_paged_
// tiling gives the floats a slot); else it is unused. The launches go on
// `stream`.
int efta_paged_launch(int dtype, const void* q, const void* k, const void* v,
                      const void* kc1, const void* kc2, const void* vc1,
                      const void* vc2, const void* bt, const void* kv_lens,
                      const void* q_lens, void* out, void* rep, void* bad,
                      int B, int Hkv, int R, int chunk, int D, int bs, int cs,
                      int mb, int s_kv, int s_out, int window, float scale,
                      float kv_thr, float eps1, float eps2, float eps3,
                      int mode, int unified, int shadow_rowsum,
                      int shadow_rowmax, int f0, int f1, int f2, int f3,
                      int f4, int f5, int f6, int f7, void* ws, void* stream) {
  if (B <= 0 || Hkv <= 0 || R <= 0 || mb <= 0 || chunk <= 0 || bs % cs ||
      bs % s_kv || D % s_out || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kc1 = kc1;
  p.kc2 = kc2;
  p.vc1 = vc1;
  p.vc2 = vc2;
  p.bt = (const int*)bt;
  p.kv_lens = (const int*)kv_lens;
  p.q_lens = (const int*)q_lens;
  p.out = out;
  p.rep = (int*)rep;
  p.bad = (int*)bad;
  p.B = B;
  p.Hkv = Hkv;
  p.R = R;
  p.chunk = chunk;
  p.D = D;
  p.bs = bs;
  p.cs = cs;
  p.mb = mb;
  p.s_kv = s_kv;
  p.s_out = s_out;
  p.window = window;
  p.scale = scale;
  p.kv_thr = kv_thr;
  p.eps1 = eps1;
  p.eps2 = eps2;
  p.eps3 = eps3;
  p.mode = mode;
  p.unified = unified;
  p.shadow_rowsum = shadow_rowsum;
  p.shadow_rowmax = shadow_rowmax;
  const int f[8] = {f0, f1, f2, f3, f4, f5, f6, f7};
  for (int i = 0; i < 8; ++i) p.fault[i] = f[i];
  cudaStream_t s = (cudaStream_t)stream;
  const int esz = dtype == 0 ? 4 : 2;
  int KG = 0;
  if (choose_pdecode(R, chunk, D, bs, cs, s_kv, s_out, esz, unified, mb,
                     &KG)) {
    PDParams c;
    c.P = p;
    c.KG = KG;
    c.n_rg = (R + PD_ROWS - 1) / PD_ROWS;
    c.P.n_tiles = c.n_rg * PD_CTAS;
    c.L = make_pdecode_layout(KG, R, D, cs, s_out, esz, mb);
    if ((long long)PD_CTAS * B * Hkv * c.n_rg > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    return (int)(dtype == 0 ? launch_pdecode<float>(c, s)
                            : launch_pdecode<__nv_bfloat16>(c, s));
  }
  int G = 0, GY = 0;
  if (choose_plong(R, chunk, D, bs, cs, s_kv, s_out, esz, unified, mb, &G,
                   &GY)) {
    PLParams c;
    c.P = p;
    c.G = G;
    c.GY = GY;
    c.n_rg = (R + PD_ROWS - 1) / PD_ROWS;
    c.P.n_tiles = c.n_rg * (GY + PD_ROWS);
    c.L = make_plong_layout(G, R, D, cs, s_out, esz);
    c.S = make_plong_slot(R, D, s_out);
    c.ws = (float*)ws;
    if (ws == nullptr || (long long)B * Hkv * c.n_rg > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    return (int)(dtype == 0 ? launch_plong<float>(c, s)
                            : launch_plong<__nv_bfloat16>(c, s));
  }
  if (choose_ptile(R, D, bs, cs, s_kv, s_out, esz, unified, &p.ST)) {
    p.n_tiles = (R + PT_ROWS - 1) / PT_ROWS;
    if (ws == nullptr || B > 65535) return (int)cudaErrorInvalidValue;
    PTParams c;
    c.P = p;
    c.L = make_ptile_layout(p.ST, D, s_out);
    c.F = make_pfold(D, s_out);
    c.ws = (float*)ws;
    return (int)launch_ptile(c, s);
  }
  if ((cs * D * esz) % 16 ||
      !choose_tiles(R, D, bs, cs, s_kv, s_out, esz, mb, &p.W, &p.G, &p.ST))
    return (int)cudaErrorInvalidValue;
  p.DS = slice_of(D);
  p.L = make_layout(p.W, p.G, p.ST, D, bs, cs, s_kv, s_out, esz, mb);
  p.n_tiles = (R + 16 * p.W - 1) / (16 * p.W);
  if (p.n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      dtype == 0 ? launch<float>(p, s) : launch<__nv_bfloat16>(p, s);
  return (int)err;
}

}  // extern "C"
