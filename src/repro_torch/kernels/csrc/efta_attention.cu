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
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "efta_common.cuh"

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

// W row groups of 16 rows, WPG warps each
Layout make_layout(int W, int KC, int ST, int D, int Bc, int skv, int sout,
                   int esz) {
  Layout L;
  const int TR = 16 * W;
  // bf16 rows padded by 16 bytes: ldmatrix reads 8 rows on 8 bank groups;
  // f32 rows padded by one float for the FMA path's column reads
  L.ldk = esz == 2 ? D + 8 : D + 1;
  L.lds = Bc + (skv < 32 ? skv : 0);
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
  L.kf = take(2 * (size_t)skv * L.ldf * 4);
  L.sp = take((size_t)TR * L.lds * 4);
  L.acc = take((size_t)TR * L.ldo * 4);
  L.sc1 = take((size_t)TR * skv * 4);
  L.vcs = take(2 * (size_t)KC * sout * 4);
  L.oc = take(4 * (size_t)TR * sout * 4);
  L.row = take(8 * (size_t)TR * 4);
  L.red = take((size_t)W * WPG * 8 * 4);
  L.total = off;
  return L;
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
};

// columns of one PV n-slice: the largest multiple of 16 up to 64 dividing D
int slice_of(int D) {
  for (int ds = 64; ds >= 16; ds -= 16)
    if (D % ds == 0) return ds;
  return 0;
}

// row groups per block (2 or 1, each of 16 rows and WPG warps), keys per
// streamed chunk and ring stages: two blocks per SM if any choice fits half
// of its shared memory (16 warps an SM hide each other's latency), else
// one; then the most rows, the widest chunk and the deepest ring
bool choose_tiles(int block_q, int Bc, int D, int skv, int sout, int esz,
                  int max_groups, int* W, int* KC, int* ST) {
  if (Bc % 16 || D % 16 || skv < 2 || skv > 32 || (skv & (skv - 1)) ||
      Bc % skv || Bc / skv > MAX_G || sout <= 0 || D % sout ||
      slice_of(D) == 0)
    return false;
  int wmax = (block_q + 15) / 16;
  if (wmax > max_groups) wmax = max_groups;
  if (wmax > MAX_GROUPS) wmax = MAX_GROUPS;
  for (int per_sm = 2; per_sm >= 1; --per_sm) {
    for (int w = wmax; w >= 1; --w) {
      for (int kc = 64; kc >= 16; kc /= 2) {
        if (Bc % kc) continue;
        for (int st = 3; st >= 2; --st) {
          if (make_layout(w, kc, st, D, Bc, skv, sout, esz).total <=
              SMEM_LIMIT / per_sm) {
            *W = w;
            *KC = kc;
            *ST = st;
            return true;
          }
        }
      }
    }
  }
  return false;
}

template <typename T>
__global__ void __launch_bounds__(32 * WPG * MAX_GROUPS, 2)
    efta_attention_kernel(const Params P) {
  constexpr bool BF = sizeof(T) == 2;
  constexpr int RPW = 16 / WPG;  // rows per warp in the row phases
  const Layout& L = P.L;
  const int bh = blockIdx.x, tile = blockIdx.y;
  const int iq = tile / P.n_sub, sub = tile - iq * P.n_sub;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int NT = blockDim.x;
  const int W = P.W, KC = P.KC, ST = P.ST, D = P.D, Bc = P.block_kv,
            skv = P.s_kv, sout = P.s_out, DS = P.DS;
  const int ldk = L.ldk, lds = L.lds, ldo = L.ldo, ldf = L.ldf;
  const int TR = 16 * W;
  const int q_start = iq * P.block_q;    // the reference tile's first row
  const int r0 = q_start + sub * TR;     // this block's first row
  const int nrows = min(TR, P.block_q - sub * TR);
  // warp w = (row group rg of 16 rows, warp wk of the group's WPG)
  const int rg = w / WPG, wk = w - rg * WPG;
  const int gr0 = 16 * rg;                        // the group's first row
  const bool gact = nrows > gr0;
  const int wr = RPW * wk;                        // the warp's rows in it
  const int nrw = max(0, min(RPW, nrows - gr0 - wr));  // of them real
  const bool wact = nrw > 0;
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const int g_kv = Bc / skv, g_out = D / sout;
  const int nc = Bc / KC, NS = D / DS;
  // GEMM I and II on tensor cores in bf16. With the per-step output check
  // (unified = 0) both stay sequential f32 FMAs, the plain version's order:
  // that check compares the unnormalised accumulator with an absolute
  // threshold, so hundreds of its columns sit at the threshold in bf16 and
  // its count follows the summation order.
  const bool tc = BF && P.unified;
  const float MASK_VALUE = (float)MASK_D;
  const float MASK_HALF = (float)(MASK_D / 2);
  const int g = lane >> 2, t4 = lane & 3;
  const Div dD(D), dskv(skv), dsout(sout), dper(D * (int)sizeof(T) / 16);
  // lane pairs of the row phases: (row r < RPW, fold column i), s_kv lanes
  // per row; passes of 32 lanes, the lanes past RPW * s_kv idle
  const int npr = RPW * skv, npr32 = (npr + 31) & ~31;
  const int npo = RPW * sout;
  // the SEU's row relative to the group (out of [0, 16) = not here)
  const bool f_blk = P.fault[F_ON] == 1 && P.fault[F_BH] == bh &&
                     P.fault[F_ROW] - r0 >= 0 &&
                     P.fault[F_ROW] - r0 < nrows;
  const int fg = P.fault[F_ROW] - r0 - gr0;       // group row
  const bool f_grp = f_blk && fg >= 0 && fg < 16;
  const int f_site = P.fault[F_SITE], f_col = P.fault[F_COL],
            f_bit = P.fault[F_BIT];

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = (T*)(smem + L.ring);
  T* qs = (T*)(smem + L.qs);
  float* kf1 = (float*)(smem + L.kf);
  float* kf2 = kf1 + skv * ldf;
  // the group's rows; row phases index them with wr + r
  float* sp = (float*)(smem + L.sp) + gr0 * lds;
  float* acc = (float*)(smem + L.acc) + gr0 * ldo;
  float* sc1 = (float*)(smem + L.sc1) + gr0 * skv;
  float* vcs1 = (float*)(smem + L.vcs);
  float* vcs2 = vcs1 + KC * sout;
  float* oc1 = (float*)(smem + L.oc) + gr0 * sout;
  float* oc2 = oc1 + TR * sout;
  float* ocb1 = oc2 + TR * sout;
  float* ocb2 = ocb1 + TR * sout;
  float* m_s = (float*)(smem + L.row) + gr0;
  float* l_s = m_s + TR;
  float* lsh_s = l_s + TR;
  float* r_s = lsh_s + TR;
  float* msub_s = r_s + TR;
  float* alpha_s = msub_s + TR;
  float* bmax_s = alpha_s + TR;
  float* lsafe_s = bmax_s + TR;
  float* red = (float*)(smem + L.red);

  const T* qg = (const T*)P.q + ((size_t)bh * P.Sq + r0) * D;
  const size_t kvh = (size_t)(bh / P.grp);
  const T* kg = (const T*)P.k + kvh * P.Skv * D;
  const T* vg = (const T*)P.v + kvh * P.Skv * D;
  for (int e = tid; e < TR * D; e += NT) {
    const int r = e / D, d = e - r * D;
    qs[r * ldk + d] = r < nrows ? qg[r * D + d] : from_f<T>(0.f);
  }
  for (int e = tid; e < TR * ldo; e += NT) ((float*)(smem + L.acc))[e] = 0.f;
  for (int e = tid; e < 2 * TR * sout; e += NT)
    ((float*)(smem + L.oc))[e] = 0.f;
  for (int r = tid; r < TR; r += NT) {
    float* m0 = (float*)(smem + L.row);
    m0[r] = MASK_VALUE;
    m0[TR + r] = m0[2 * TR + r] = m0[3 * TR + r] = 0.f;  // l, lsh, r
  }
  float vm = 0.f;  // this thread's share of the running max|V|
  int det[5] = {0, 0, 0, 0, 0};
  __syncthreads();

  for (int j = 0; j < P.n_kv; ++j) {
    const int kv_start = j * Bc;
    // block skipping, decided for the whole reference tile
    bool run = kv_start < P.kv_len &&
               q_start - (kv_start + Bc - 1) < P.window;
    if (P.causal) run = run && kv_start <= q_start + P.block_q - 1;
    if (!run) continue;
    const bool hit = f_grp && P.fault[F_BLOCK] == j;

    // ---- the block's load stream: K chunks, then V chunks per n-slice ----
    const int nload = nc + NS * nc;
    auto issue = [&](int idx) {
      const int ck = idx < nc ? idx : (idx - nc) % nc;
      const T* src = (idx < nc ? kg : vg) + (size_t)(kv_start + ck * KC) * D;
      T* dst = ring + (idx % ST) * KC * ldk;
      if constexpr (BF) {
        const int per = D / 8;  // 16-byte pieces per row
        for (int e = tid; e < KC * per; e += NT) {
          const int c = dper.q(e), p8 = e - c * per;
          cp_async16(dst + c * ldk + p8 * 8, src + (size_t)c * D + p8 * 8);
        }
      } else {
        for (int e = tid; e < KC * D; e += NT) {
          const int c = dD.q(e), d = e - c * D;
          cp_async4(dst + c * ldk + d, src + (size_t)c * D + d);
        }
      }
    };
    for (int s = 0; s < ST - 1; ++s) {
      if (s < nload) issue(s);
      cp_async_commit();
    }
    // chunk idx has landed for every thread, and every warp is done with
    // the slot the next prefetch overwrites
    auto acquire = [&](int idx) -> const T* {
      cp_async_wait(ST - 2);
      __syncthreads();
      if (idx + ST - 1 < nload) issue(idx + ST - 1);
      cp_async_commit();
      return ring + (idx % ST) * KC * ldk;
    };

    // ---- K pass: GEMM I + NVR clip into the scores, K folds ----
    for (int ck = 0; ck < nc; ++ck) {
      const T* kb = acquire(ck);
      const int c0 = ck * KC;
      if (gact && tc) {
        if constexpr (BF) {
          // the group's 16 rows x this warp's n-tiles (keys nt * 8 ..)
          float c[2][4];
#pragma unroll
          for (int k = 0; k < 2; ++k) c[k][0] = c[k][1] = c[k][2] = c[k][3] = 0.f;
          const int l16 = lane & 15;
          for (int ks = 0; ks < D / 16; ++ks) {
            uint32_t a[4];
            ldmatrix_x4(a, qs + (gr0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    ldk + ks * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const int nt = wk + WPG * k;
              if (nt * 8 < KC) {
                uint32_t b[2];
                ldmatrix_x2(b, kb + (nt * 8 + (l16 & 7)) * ldk + ks * 16 +
                                   (l16 >> 3) * 8);
                mma_bf16(c[k], a, b);
              }
            }
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int nt = wk + WPG * k;
            if (nt * 8 < KC) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = g + (e >> 1) * 8;
                const int col = c0 + nt * 8 + 2 * t4 + (e & 1);
                float sv = c[k][e] * P.scale;
                if (hit && f_site == S_GEMM1 && r == fg && col == f_col)
                  sv = flip_bit(sv, f_bit);
                if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
                sp[r * lds + col] = sv;
              }
            }
          }
        }
      } else if (gact) {
        // sequential f32 FMAs over d on CUDA cores, a lane per key, the
        // warp's RPW rows
        {
          const T* qw = qs + (gr0 + wr) * ldk;
          for (int cb = 0; cb < KC; cb += 32) {
            const int c = cb + lane;
            if (c < KC) {
              float a[RPW];
#pragma unroll
              for (int r = 0; r < RPW; ++r) a[r] = 0.f;
              const T* kr = kb + c * ldk;
#pragma unroll 4
              for (int d = 0; d < D; ++d) {
                const float kv = to_f(kr[d]);
#pragma unroll
                for (int r = 0; r < RPW; ++r)
                  a[r] = fmaf(to_f(qw[r * ldk + d]), kv, a[r]);
              }
#pragma unroll
              for (int r = 0; r < RPW; ++r) {
                float sv = a[r] * P.scale;
                if (hit && f_site == S_GEMM1 && wr + r == fg && c0 + c == f_col)
                  sv = flip_bit(sv, f_bit);
                if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
                sp[(wr + r) * lds + c0 + c] = sv;
              }
            }
          }
        }
      }
      if (ft) {
        // fold this chunk's K rows into the tensor checksums, segments in
        // order (key c = l * s_kv + i); each thread keeps its own entries
#pragma unroll 2
        for (int e = tid; e < skv * D; e += NT) {
          const int i = dD.q(e), d = e - i * D;
          float f1 = ck ? kf1[i * ldf + d] : 0.f;
          float f2 = ck ? kf2[i * ldf + d] : 0.f;
          int c = c0 + dskv.r(i - dskv.r(c0) + skv);
          float wl = (float)(dskv.q(c) + 1);  // the segment's weight l + 1
#pragma unroll 4
          for (; c < c0 + KC; c += skv, wl += 1.f) {
            const float x = to_f(kb[(c - c0) * ldk + d]);
            f1 = f1 + x;
            f2 = f2 + wl * x;
          }
          kf1[i * ldf + d] = f1;
          kf2[i * ldf + d] = f2;
        }
      }
    }
    __syncthreads();  // the K folds and every warp's scores are complete

    if (wact) {
      if (ft) {
        // ---- checksum GEMMs on the folded K, verify, locate + correct ----
        for (int b0 = 0; b0 < npr32; b0 += 32) {
          const int p = b0 + lane;
          if (p < npr) {
            const int r = wr + dskv.q(p), i = dskv.r(p);
            const T* qr = qs + (gr0 + r) * ldk;
            float a1 = 0.f, a2 = 0.f;
            qk_fold<T>(qr, kf1 + i * ldf, kf2 + i * ldf, D, &a1, &a2);
            const float c1 = a1 * P.scale, c2 = a2 * P.scale;
            sc1[r * skv + i] = c1;
            float sum1 = 0.f, sum2 = 0.f;
#pragma unroll 8
            for (int l = 0; l < g_kv; ++l) {
              const float x = sp[r * lds + l * skv + i];
              sum1 = sum1 + x;
              sum2 = sum2 + (float)(l + 1) * x;
            }
            const float d1 = c1 - sum1, d2 = c2 - sum2;
            const bool bad = fabsf(d1) > P.eps1;
            if (r - wr < nrw) det[0] += bad;
            if (correct && bad)
              sp[r * lds + seg_of(d1, d2, g_kv) * skv + i] += d1;
          }
        }
        __syncwarp();
      }

      // ---- mask, running max (+ shadow): s_kv lanes per row ----
      for (int b0 = 0; b0 < npr32; b0 += 32) {
        const int p = b0 + lane;
        const bool valid = p < npr;
        const int r = wr + dskv.q(p), i = dskv.r(p);
        const int row_abs = r0 + gr0 + r;
        float bm = MASK_VALUE;
        if (valid) {
#pragma unroll 8
          for (int l = 0; l < g_kv; ++l) {
            const int col = kv_start + l * skv + i;
            const bool mk = col < P.kv_len && (!P.causal || col <= row_abs) &&
                            row_abs - col < P.window;
            bm = nan_max(bm, mk ? sp[r * lds + l * skv + i] : MASK_VALUE);
          }
        }
        for (int o = skv >> 1; o > 0; o >>= 1)
          bm = nan_max(bm, __shfl_xor_sync(FULL, bm, o));
        if (valid && i == 0) {
          const float mp = m_s[r];
          float mn = nan_max(mp, bm);
          if (hit && f_site == S_ROWMAX && r == fg) mn = flip_bit(mn, f_bit);
          if (ft && P.shadow_rowmax) {
            const float mc = nan_max(opaque(mp), bm);
            const bool bad = mn != mc;
            if (r - wr < nrw) det[2] += bad;
            if (correct && bad) mn = mc;
          }
          m_s[r] = mn;
          const bool alive = mn > MASK_HALF;
          msub_s[r] = alive ? mn : 0.f;
          alpha_s[r] = alive ? expf(mp - mn) : 1.f;
          bmax_s[r] = bm;
        }
      }
      __syncwarp();

      // ---- EXP with checksum reuse (paper Case 2), backstop, mask, rowsum
      //      (+ shadow) and the SNVR tracker; p is written over s ----
      for (int b0 = 0; b0 < npr32; b0 += 32) {
        const int p = b0 + lane;
        const bool valid = p < npr;
        const int r = wr + dskv.q(p), i = dskv.r(p);
        const int row_abs = r0 + gr0 + r;
        float ps = 0.f, ps2 = 0.f;
        if (valid) {
          const float ms = msub_s[r];
          float* srow = sp + r * lds + i;
          float pr[MAX_G];
          float prod = 1.f;
          bool col_ok = true;
#pragma unroll 4
          for (int l = 0; l < g_kv; ++l) {
            const float sv = srow[l * skv];
            float x = expf(nan_min(sv - ms, P.cap));
            if (hit && f_site == S_EXP && r == fg && l * skv + i == f_col)
              x = flip_bit(x, f_bit);
            pr[l] = x;
            prod = prod * x;
            col_ok = col_ok && !((sv - ms) > P.cap_m);
          }
          if (ft) {
            const float pc1 =
                expf(nan_min(sc1[r * skv + i] - (float)g_kv * ms, P.cap_g));
            const float ref = nan_max(fabsf(pc1), 1e-20f);
            const bool bad =
                col_ok && (fabsf(prod - pc1) > P.eps2 * ref + 1e-20f);
            if (r - wr < nrw) det[1] += bad;
            if (correct && bad) {
#pragma unroll 4
              for (int l = 0; l < g_kv; ++l)
                pr[l] = expf(nan_min(srow[l * skv] - ms, P.cap));
            }
          }
#pragma unroll 4
          for (int l = 0; l < g_kv; ++l) {
            float x = pr[l];
            const float sv = srow[l * skv];
            if (ft && P.shadow_rowmax && correct) {
              // exact recompute backstop
              const float rc = expf(nan_min(sv - ms, P.cap));
              const bool slipped = x != rc;
              if (r - wr < nrw) det[1] += slipped;
              if (slipped) x = rc;
            }
            const int col = kv_start + l * skv + i;
            const bool mk = col < P.kv_len && (!P.causal || col <= row_abs) &&
                            row_abs - col < P.window;
            x = mk ? x : 0.f;
            srow[l * skv] = x;
            ps = ps + x;
            ps2 = ps2 + opaque(x);
          }
        }
        for (int o = skv >> 1; o > 0; o >>= 1) {
          ps = ps + __shfl_xor_sync(FULL, ps, o);
          ps2 = ps2 + opaque(__shfl_xor_sync(FULL, ps2, o));
        }
        if (valid && i == 0) {
          const float a = alpha_s[r];
          float ln = a * l_s[r] + ps;
          if (hit && f_site == S_ROWSUM && r == fg) ln = flip_bit(ln, f_bit);
          l_s[r] = ln;
          if (ft && P.shadow_rowsum) lsh_s[r] = a * lsh_s[r] + ps2;
          const float bm = bmax_s[r];
          r_s[r] = a * r_s[r] + (bm > MASK_HALF ? expf(bm - msub_s[r]) : 0.f);
        }
      }
    }

    // ---- V pass: GEMM II per n-slice, V column checksums, max|V| ----
    for (int sl = 0; sl < NS; ++sl) {
      float pv[2][4];    // tensor cores: this warp's two n-tiles
      float pf[RPW][2];  // FMAs: [row][2 columns of the slice]
#pragma unroll
      for (int k = 0; k < 2; ++k) pv[k][0] = pv[k][1] = pv[k][2] = pv[k][3] = 0.f;
#pragma unroll
      for (int r = 0; r < RPW; ++r) pf[r][0] = pf[r][1] = 0.f;
      // this warp's n-tiles of the slice (mma): 8 columns each
      for (int ck = 0; ck < nc; ++ck) {
        const T* vb = acquire(nc + sl * nc + ck);
        const int c0 = ck * KC;
        if (sl == 0 && ft) {
          // this chunk's V column checksums, by the whole block (reading
          // every element of the chunk, so also its max|V|)
#pragma unroll 2
          for (int e = tid; e < KC * sout; e += NT) {
            const int c = dsout.q(e), i = e - c * sout;
            float f1 = 0.f, f2 = 0.f;
#pragma unroll 8
            for (int l = 0; l < g_out; ++l) {
              const float x = to_f(vb[c * ldk + l * sout + i]);
              f1 = f1 + x;
              f2 = f2 + (float)(l + 1) * x;
              vm = nan_max(vm, fabsf(x));
            }
            vcs1[e] = f1;
            vcs2[e] = f2;
          }
          __syncthreads();
          // the O-checksum products of this warp's rows
          if (wact) {
            for (int p = lane; p < npo; p += 32) {
              const int r = wr + dsout.q(p), i = dsout.r(p);
              const float* prow = sp + r * lds + c0;
              float a1 = ck ? ocb1[r * sout + i] : 0.f;
              float a2 = ck ? ocb2[r * sout + i] : 0.f;
#pragma unroll 8
              for (int c = 0; c < KC; ++c) {
                a1 = fmaf(prow[c], vcs1[c * sout + i], a1);
                a2 = fmaf(prow[c], vcs2[c * sout + i], a2);
              }
              ocb1[r * sout + i] = a1;
              ocb2[r * sout + i] = a2;
            }
          }
        }
        if (!gact) continue;
        if (tc) {
          if constexpr (BF) {
            if (wk * 8 < DS) {
              for (int ks = 0; ks < KC / 16; ++ks) {
                const int k = c0 + ks * 16 + 2 * t4;
                const float2 x0 = *(const float2*)(sp + g * lds + k);
                const float2 x1 = *(const float2*)(sp + (g + 8) * lds + k);
                const float2 x2 = *(const float2*)(sp + g * lds + k + 8);
                const float2 x3 = *(const float2*)(sp + (g + 8) * lds + k + 8);
                const uint32_t a[4] = {
                    pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                    pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
                const int l16 = lane & 15;
#pragma unroll
                for (int kk = 0; kk < 2; ++kk) {
                  const int nt = wk + WPG * kk;
                  if (nt * 8 < DS) {
                    uint32_t b[2];
                    ldmatrix_x2_trans(
                        b, vb + (ks * 16 + l16) * ldk + sl * DS + nt * 8);
                    mma_bf16(pv[kk], a, b);
                  }
                }
              }
            }
          }
        } else if (wact) {
          // sequential FMAs over the keys, in order: the warp's RPW rows
#pragma unroll 2
          for (int c = 0; c < KC; ++c) {
            const T* vr = vb + c * ldk + sl * DS;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int d = lane + 32 * h;
              if (d < DS) {
                const float x = to_f(vr[d]);
#pragma unroll
                for (int r = 0; r < RPW; ++r)
                  pf[r][h] = fmaf(round_to<T>(sp[(wr + r) * lds + c0 + c]), x,
                                  pf[r][h]);
              }
            }
          }
        }
      }
      if (!gact) continue;
      // ---- rescale + accumulate this slice (the GEMM II SEU site) ----
      if (tc) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int nt = wk + WPG * k;
          if (nt * 8 < DS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = g + (e >> 1) * 8;
              const int col = sl * DS + nt * 8 + 2 * t4 + (e & 1);
              float an = alpha_s[r] * acc[r * ldo + col] + pv[k][e];
              if (hit && f_site == S_GEMM2 && r == fg && col == f_col)
                an = flip_bit(an, f_bit);
              acc[r * ldo + col] = an;
            }
          }
        }
      } else if (wact) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = lane + 32 * h;
          if (d < DS) {
            const int col = sl * DS + d;
#pragma unroll
            for (int rr = 0; rr < RPW; ++rr) {
              const int r = wr + rr;
              float an = alpha_s[r] * acc[r * ldo + col] + pf[rr][h];
              if (hit && f_site == S_GEMM2 && r == fg && col == f_col)
                an = flip_bit(an, f_bit);
              acc[r * ldo + col] = an;
            }
          }
        }
      }
    }
    if (ft) {
      if (wact) {
        for (int p = lane; p < npo; p += 32) {
          const int r = wr + dsout.q(p), i = dsout.r(p);
          const int e = r * sout + i;
          oc1[e] = alpha_s[r] * oc1[e] + ocb1[e];
          oc2[e] = alpha_s[r] * oc2[e] + ocb2[e];
        }
      }
      if (!P.unified) {
        // per-step output check (EFTA without unified verification)
        __syncthreads();  // every warp's columns of acc are in
        if (wact) {
          for (int p = lane; p < npo; p += 32) {
            const int r = wr + dsout.q(p), i = dsout.r(p);
            float s1 = 0.f;
            for (int l = 0; l < g_out; ++l)
              s1 = s1 + acc[r * ldo + l * sout + i];
            if (r - wr < nrw) det[4] += fabsf(oc1[r * sout + i] - s1) > P.eps3;
          }
        }
      }
    }
    __syncthreads();  // the ring is free for the next block's prologue
  }

  // ---- the block's running max|V| (only ever read by the clamp) ----
  for (int o = 16; o > 0; o >>= 1)
    vm = nan_max(vm, __shfl_xor_sync(FULL, vm, o));
  __syncthreads();  // every warp is past its last use of red, acc is in
  if (lane == 0) red[w] = vm;
  __syncthreads();
  float vmax = red[0];
  for (int i = 1; i < NT / 32; ++i) vmax = nan_max(vmax, red[i]);

  if (wact) {
    // ---- finalize: SNVR on l + unified output verification ----
    if (lane < RPW) {
      const int r = wr + lane;
      float lf = l_s[r];
      if (ft) {
        const float rf = r_s[r];
        const bool in_range =
            lf >= rf - 1e-3f && lf <= P.upper && isfinite(lf);
        bool bad;
        float fallback;
        if (P.shadow_rowsum) {
          const float lsh = lsh_s[r];
          const bool mism =
              fabsf(lf - lsh) > 1e-5f * nan_max(fabsf(lsh), 1e-6f);
          bad = (!in_range || mism) && rf > 0.f;
          const bool fb_ok =
              lsh >= rf - 1e-3f && lsh <= P.upper && isfinite(lsh);
          fallback = fb_ok ? lsh : rf;
        } else {
          bad = !in_range && rf > 0.f;
          fallback = rf;
        }
        if (lane < nrw) det[3] += bad;
        if (correct && bad) lf = fallback;
      }
      lsafe_s[r] = lf == 0.f ? 1.f : lf;
    }
    __syncwarp();
    const float bound = vmax * 1.001f + 1e-6f;
#pragma unroll 4
    for (int e = lane; e < RPW * D; e += 32) {
      const int r = wr + dD.q(e), d = dD.r(e);
      float o = acc[r * ldo + d] / lsafe_s[r];
      if (ft && correct) o = (isfinite(o) && fabsf(o) <= bound) ? o : 0.f;
      acc[r * ldo + d] = o;
    }
    __syncwarp();
    if (ft) {
      for (int p = lane; p < npo; p += 32) {
        const int r = wr + dsout.q(p), i = dsout.r(p);
        const float ls = lsafe_s[r];
        float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
        for (int l = 0; l < g_out; ++l) {
          const float x = acc[r * ldo + l * sout + i];
          s1 = s1 + x;
          s2 = s2 + (float)(l + 1) * x;
        }
        const float d1 = oc1[r * sout + i] / ls - s1;
        const float d2 = oc2[r * sout + i] / ls - s2;
        const bool bad = !(fabsf(d1) <= P.eps3);
        if (r - wr < nrw) det[4] += bad;
        if (correct && bad) acc[r * ldo + seg_of(d1, d2, g_out) * sout + i] += d1;
      }
      __syncwarp();
    }
    T* og = (T*)P.out + ((size_t)bh * P.Sq + r0 + gr0 + wr) * D;
    for (int e = lane; e < nrw * D; e += 32) {
      const int r = e / D, d = e - r * D;
      og[e] = from_f<T>(acc[(wr + r) * ldo + d]);
    }
  }
  // ---- the block's partial counts: warps in order, no atomics ----
  int* redi = (int*)(red + NT / 32);
  for (int k = 0; k < 5; ++k) {
    int v = det[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) redi[w * 5 + k] = v;
  }
  __syncthreads();
  if (tid < 5) {
    int tot = 0;
    for (int i = 0; i < NT / 32; ++i) tot += redi[i * 5 + tid];
    P.rep[((size_t)bh * P.n_q * P.n_sub + tile) * 5 + tid] = tot;
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = p.L.total;
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      efta_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.BH, p.n_q * p.n_sub);
  efta_attention_kernel<T><<<grid, 32 * WPG * p.W, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Thread blocks per reference query tile (block_q rows) for these shapes,
// or 0 when no tiling fits one SM's shared memory. dtype as below.
int efta_attention_tiles(int dtype, int block_q, int block_kv, int D,
                         int s_kv, int s_out, int max_groups) {
  int W, KC, ST;
  if (block_q <= 0 ||
      !choose_tiles(block_q, block_kv, D, s_kv, s_out, dtype == 0 ? 4 : 2,
                    max_groups, &W, &KC, &ST))
    return 0;
  return (block_q + 16 * W - 1) / (16 * W);
}

const char* efta_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). q and out are
// (BH, Sq, D), k and v (BH / grp, Skv, D), all contiguous device arrays;
// rep is (BH, n_q * tiles, 5) int32. max_groups caps the 16-row groups per
// thread block (the wrapper passes 2). The launch goes on `stream`.
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
                          void* stream) {
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
  if (!choose_tiles(block_q, block_kv, D, s_kv, s_out, esz, max_groups, &p.W,
                    &p.KC, &p.ST))
    return (int)cudaErrorInvalidValue;
  p.DS = slice_of(D);
  p.L = make_layout(p.W, p.KC, p.ST, D, block_kv, s_kv, s_out, esz);
  p.n_sub = (block_q + 16 * p.W - 1) / (16 * p.W);
  if ((long long)n_q * p.n_sub > 65535) return (int)cudaErrorInvalidValue;
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
  const cudaError_t err =
      dtype == 0 ? launch<float>(p, s) : launch<__nv_bfloat16>(p, s);
  return (int)err;
}

}  // extern "C"
