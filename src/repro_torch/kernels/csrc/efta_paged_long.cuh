// Kernel B1's long-table layout, for launches of one chunk row (C 1) that
// the decode layout does not hold (a CTA's share of a wide block table, V
// and the partials of ceil(mb / 8) blocks, past its shared memory: the moe
// heads from 2-3k tokens of table, the engine's default 4,096-token cache
// among them). Included by efta_paged.cu inside its anonymous namespace,
// after efta_paged_decode.cuh, whose block constants (PD_BS, PD_SKV,
// PD_GKV, PD_LDS, PD_ROWS) it shares.
//
// Three launches over a global workspace, a slot of floats a (unit,
// running block); a unit is (request, KV head, up to PD_ROWS of its query
// heads), as in the decode layout. Shared memory does not depend on the
// table's width (the table row is read a group at a time), and the work
// follows the running blocks: a CTA of the first two passes takes groups
// y, y + GY, ... of G running blocks and leaves when they run out.
//   * Score pass, grid (unit, GY): per group, K and (site 6) K's two
//     resident planes gathered through the table by cp.async; a warp a
//     block: K's site-6 check (its flag into the slot), GEMM I (mma.sync in
//     bf16, f32 FMAs in f32), the fold check with locate and correct (the K
//     folds formed on the fly in segment order), the masked block max; the
//     scores, the checksum products Q fold(K)^T and the block max into the
//     slot, and the group's max of each row into its first block's slot.
//   * EXP pass, grid (unit, GY): the running max entering the group from
//     the earlier groups' maxima (exact in any order: a max), with an SEU
//     on the running max at an earlier block applied as the sequential walk
//     applies it; then through the group's blocks, a lane a block, the
//     shadow max and the SEU at their block; per block, a warp: V's site-6
//     check (the block's bad plane from both flags), EXP with its
//     product-fold check and backstop under the 80/g_kv cap, the rowsum,
//     shadow rowsum and SNVR terms, V's column checksums and max|V|, P V
//     from zero (mma.sync in bf16) and the O-checksum products, all into
//     the slot.
//   * State pass, grid (unit, row): each row's running state folded in
//     block order from the slots, acc = alpha_j acc + PV_j with l, the
//     shadow l, r and the O checksums, the operations of the first layout's
//     phase C in the same order, the rowsum and GEMM II SEUs at their
//     block; then the finalize (SNVR bound, |o| <= max|V| clamp, unified
//     output verify and correct).
// No partial states are merged (tests/test_torch_paged_split.py): each
// value is formed as a walk over the blocks one at a time forms it, so
// counts and bad planes equal the sequential plain version's. Each CTA
// writes its own counts into its row of rep (the score and EXP passes of
// a (unit, y) share a row, at disjoint sites), summed by the wrapper.
// What bounds it: HBM bytes, K, V and the four resident planes read once,
// and the workspace written once and read once (P V and the O-checksum
// products of every (row, block) are most of it).

// blocks a group at most (a warp a block), CTAs a unit in the score and EXP
// passes at most, threads a CTA of the state pass
constexpr int PL_G = 8, PL_GY = 64, PL_THREADS = 256, PL_ST_THREADS = 128;
constexpr int PL_WARPS = PL_THREADS / 32;
// shared bytes a CTA at most for three CTAs an SM (228 KB, 1 KB of it
// reserved a CTA)
constexpr size_t PL_SMEM_TRIPLE = 76800;
// a block's row scalars in the EXP pass, [row][PL_RN]: block max,
// subtracted max, alpha
constexpr int PL_BM = 0, PL_MS = 1, PL_AL = 2, PL_RN = 3;

// a unit's workspace holds these fields of each running block (a slot of
// S.floats): alpha and the rowsum, shadow rowsum and SNVR terms [ru][4];
// the scores [ru][16]; the checksum products [ru][4]; P V [ru][D]; the
// block max [ru]; the group maxima; the O-checksum products [ru][2 sout];
// K's site-6 flag; max|V|. It is laid out a field at a time (PLWs): field
// f takes mb times its floats a block from mb * S.f on, block n's at n
// times them, so that a row's group maxima ([ru][mb]: row r's group g at
// r mb + g) and the blocks' max|V| are contiguous
struct PLSlot {
  int gat, s, sc1, pv, bm, gm, ocb, bk, vm, floats;
};

PLSlot make_plong_slot(int R, int D, int sout) {
  PLSlot S;
  const int ru = R < PD_ROWS ? R : PD_ROWS;
  int off = 0;
  auto take = [&](int n) {
    const int o = off;
    off += n;
    return o;
  };
  S.gat = take(ru * 4);
  S.s = take(ru * PD_BS);
  S.sc1 = take(ru * PD_SKV);
  S.pv = take(ru * D);
  S.bm = take(ru);
  S.gm = take(ru);
  S.ocb = take(ru * 2 * sout);
  S.bk = take(1);
  S.vm = take(1);
  S.floats = (off + 3) & ~3;  // 16-byte slots
  return S;
}

// shared-memory layouts (byte offsets) of the score and the EXP pass
struct PLLayout {
  int ldk, ru;
  size_t tile, pl;  // one block's K (or V) tile; where its two planes start
  // score pass: q; G stages of K and its planes; G score tiles and
  // checksum products; the block maxima [G][ru]; the count reduction
  size_t q, kslot, ring, sslot, sc, bmx, red, total;
  // EXP pass: G slots of V, its planes, p, the checksum products and the
  // row scalars; the running max entering the group; each warp's V column
  // checksums; the count reduction
  size_t e_s, e_sc1, e_row, eslot, slots, e_min, vc, e_red, e_total;
};

PLLayout make_plong_layout(int G, int R, int D, int cs, int sout, int esz) {
  PLLayout L;
  L.ldk = esz == 2 ? D + 8 : D + 1;
  L.ru = R < PD_ROWS ? R : PD_ROWS;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) & ~(size_t)15;
    return o;
  };
  const size_t ru = L.ru, planes = 2 * (size_t)cs * D * esz;
  L.tile = (size_t)PD_BS * L.ldk * esz;
  take(L.tile);
  L.pl = take(planes);
  L.kslot = off;
  off = 0;
  take(ru * PD_LDS * 4);
  take(ru * PD_SKV * 4);
  L.sslot = off;
  off = 0;
  L.q = take((size_t)PD_ROWS * L.ldk * esz);
  L.ring = take((size_t)G * L.kslot);
  L.sc = take((size_t)G * L.sslot);
  L.bmx = take((size_t)G * ru * 4);
  L.red = take((size_t)PL_WARPS * 8 * 4);
  L.total = off;
  off = 0;
  take(L.tile);
  take(planes);
  L.e_s = take(ru * PD_LDS * 4);
  L.e_sc1 = take(ru * PD_SKV * 4);
  L.e_row = take(ru * PL_RN * 4);
  L.eslot = off;
  off = 0;
  L.slots = take((size_t)G * L.eslot);
  L.e_min = take((size_t)PD_ROWS * 4);
  L.vc = take((size_t)PL_WARPS * 2 * PD_BS * sout * 4);
  L.e_red = take((size_t)PL_WARPS * 8 * 4);
  L.e_total = off;
  return L;
}

// the fields of one unit's workspace
struct PLWs {
  float* base;  // the unit's first float: ws + u mb S.floats
  int mb, ru, D, sout;
  PLSlot S;
  __device__ float* f(int off, size_t per, int n) const {
    return base + (size_t)mb * off + per * n;
  }
  __device__ float* gat(int n) const { return f(S.gat, 4 * ru, n); }
  __device__ float* s(int n) const { return f(S.s, PD_BS * ru, n); }
  __device__ float* sc1(int n) const { return f(S.sc1, PD_SKV * ru, n); }
  __device__ float* pv(int n) const { return f(S.pv, (size_t)D * ru, n); }
  __device__ float* bm(int n) const { return f(S.bm, ru, n); }
  __device__ float* gm(int r) const { return f(S.gm, mb, r); }
  __device__ float* ocb(int n) const { return f(S.ocb, 2 * sout * ru, n); }
  __device__ float* bk() const { return f(S.bk, 0, 0); }
  __device__ float* vm() const { return f(S.vm, 0, 0); }
};

struct PLParams {
  Params P;   // P.L, W, G, ST, DS unused; P.n_tiles = n_rg (GY + PD_ROWS)
  PLLayout L;
  PLSlot S;
  int G;      // blocks a group
  int GY;     // CTAs a unit in the score and EXP passes
  int n_rg;   // units a (request, KV head): ceil(R / PD_ROWS)
  float* ws;  // (units, mb) slots of S.floats
};

__device__ __forceinline__ PLWs pl_ws(const PLParams& C, int u) {
  PLWs W;
  W.base = C.ws + (size_t)u * C.P.mb * C.S.floats;
  W.mb = C.P.mb;
  W.ru = C.L.ru;
  W.D = C.P.D;
  W.sout = C.P.s_out;
  W.S = C.S;
  return W;
}

// the unit's running blocks: j PD_BS < kv_len and qpos - (j PD_BS + PD_BS -
// 1) < window, one interval [j_lo, j_lo + n_run) of the table
struct PLUnit {
  int rg, bh, b, h, row0, nr, kv_len, q_len, qpos, j_lo, n_run;
};

__device__ __forceinline__ PLUnit pl_unit(const Params& P, int n_rg, int u) {
  PLUnit U;
  U.rg = u % n_rg;
  U.bh = u / n_rg;
  U.b = U.bh / P.Hkv;
  U.h = U.bh - U.b * P.Hkv;
  U.row0 = U.rg * PD_ROWS;
  U.nr = min(PD_ROWS, P.R - U.row0);
  U.kv_len = P.kv_lens[U.b];
  U.q_len = P.q_lens[U.b];
  U.qpos = U.kv_len - U.q_len;  // the chunk row's position
  const int past = U.qpos - P.window - (PD_BS - 1);  // j PD_BS > past runs
  U.j_lo = past < 0 ? 0 : past / PD_BS + 1;
  U.n_run = max(0, min(P.mb, (U.kv_len + PD_BS - 1) / PD_BS) - U.j_lo);
  return U;
}

// the CTA's counts (det[6] a thread) summed, warps in order, into the
// sites of `row` that `mask` names; every thread of the CTA calls it
__device__ void pl_put_counts(int* det, int mask, int* red, int* row) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nw = blockDim.x >> 5;
  for (int k = 0; k < 6; ++k) {
    int v = det[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    det[k] = v;
  }
  __syncthreads();
  if (lane == 0)
    for (int k = 0; k < 6; ++k) red[w * 8 + k] = det[k];
  __syncthreads();
  if (tid < 6 && (mask >> tid & 1)) {
    int tot = 0;
    for (int i = 0; i < nw; ++i) tot += red[i * 8 + tid];
    row[tid] = tot;
  }
}

// a tile of PD_BS rows of D elements of T from the pool (row stride D)
// into shared memory (row stride ldk) by cp.async, the CTA's threads
template <typename T>
__device__ __forceinline__ void pl_gather_tile(T* dst, const T* src, int D,
                                               int ldk, int tid) {
  if constexpr (sizeof(T) == 2) {
    const int per8 = D / 8;
    for (int e = tid; e < PD_BS * per8; e += PL_THREADS) {
      const int c = e / per8, p8 = e - c * per8;
      cp_async16(dst + c * ldk + p8 * 8, src + (size_t)c * D + p8 * 8);
    }
  } else {
    for (int e = tid; e < PD_BS * D; e += PL_THREADS) {
      const int c = e / D, d = e - c * D;
      cp_async4(dst + c * ldk + d, src + (size_t)c * D + d);
    }
  }
}

// two resident planes (cs x D of T each, contiguous a block) into shared
// memory, one after the other
__device__ __forceinline__ void pl_gather_planes(unsigned char* dst,
                                                 const void* p1,
                                                 const void* p2, size_t off,
                                                 int bytes, int tid) {
  const void* pl[2] = {p1, p2};
  const int n16 = bytes / 16;
  for (int t = 0; t < 2; ++t) {
    const unsigned char* src = (const unsigned char*)pl[t] + off;
    for (int e = tid; e < n16; e += PL_THREADS)
      cp_async16(dst + (size_t)t * bytes + 16 * e, src + 16 * e);
  }
}

// ---- the score pass ----
template <typename T>
__global__ void __launch_bounds__(PL_THREADS, 3)
    efta_paged_kernel_lscore(const PLParams C) {
  constexpr bool BF = sizeof(T) == 2;
  const Params& P = C.P;
  const PLLayout& L = C.L;
  PHASE_INIT
  const int u = blockIdx.x, y = blockIdx.y;
  const PLUnit U = pl_unit(P, C.n_rg, u);
  const int b = U.b, h = U.h, bh = U.bh, nr = U.nr, j_lo = U.j_lo;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int D = P.D, cs = P.cs, mb = P.mb, G = C.G, ldk = L.ldk;
  const int ru = L.ru;
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const float MASK_VALUE = (float)MASK_D;
  const int gq = lane >> 2, t4 = lane & 3;
  const bool f_unit = P.fault[P_ON] == 1 && P.fault[P_B] == b &&
                      P.fault[P_H] == h;
  const int fr = P.fault[P_ROW] - U.row0;
  const bool f_grp = f_unit && fr >= 0 && fr < nr;
  const int f_col = P.fault[P_COL], f_bit = P.fault[P_BIT],
            f_site = P.fault[P_SITE], f_blk = P.fault[P_BLOCK];
  const bool planes = ft && U.rg == 0;
  const int n_grp = (U.n_run + G - 1) / G;
  const int* btr = P.bt + (size_t)b * mb;
  int det[6] = {0, 0, 0, 0, 0, 0};
  extern __shared__ __align__(16) unsigned char smem[];
  if (y == 0 && U.rg == 0)
    // the bad plane of every block that does not run (or is not verified)
    for (int j = tid; j < mb; j += PL_THREADS)
      if (!(ft && j >= j_lo && j < j_lo + U.n_run))
        P.bad[(size_t)bh * mb + j] = 0;
  T* qs = (T*)(smem + L.q);
  auto kst = [&](int k) { return smem + L.ring + (size_t)k * L.kslot; };
  auto sst = [&](int k) { return smem + L.sc + (size_t)k * L.sslot; };
  float* bmx = (float*)(smem + L.bmx);
  const PLWs ws = pl_ws(C, u);
  if (y < n_grp) {
    const T* qg = (const T*)P.q + ((size_t)bh * P.R + U.row0) * D;
    if constexpr (BF) {
      const int per8 = D / 8;
      for (int e = tid; e < nr * per8; e += PL_THREADS) {
        const int r = e / per8, p8 = e - r * per8;
        cp_async16(qs + r * ldk + p8 * 8, qg + (size_t)r * D + p8 * 8);
      }
    } else {
      for (int e = tid; e < nr * D; e += PL_THREADS) {
        const int r = e / D, d = e - r * D;
        cp_async4(qs + r * ldk + d, qg + (size_t)r * D + d);
      }
    }
    // the tile's rows past the unit's: zero (GEMM I reads 16 rows)
    for (int e = tid; e < (PD_ROWS - nr) * ldk; e += PL_THREADS)
      qs[nr * ldk + e] = from_f<T>(0.f);
  }
  const bool split = 2 * G <= PL_WARPS;  // verify warps of their own
  PHASE_MARK(0)
  for (int g = y; g < n_grp; g += C.GY) {
    const int k0 = g * G, gv = min(G, U.n_run - k0);
    for (int k = 0; k < gv; ++k) {
      const size_t blk = (size_t)btr[j_lo + k0 + k] * P.Hkv + h;
      pl_gather_tile<T>((T*)kst(k), (const T*)P.k + blk * PD_BS * D, D, ldk,
                        tid);
      if (planes)
        pl_gather_planes(kst(k) + L.pl, P.kc1, P.kc2,
                         blk * cs * D * sizeof(T), cs * D * (int)sizeof(T),
                         tid);
    }
    cp_async_commit();
    cp_async_wait(0);
    __syncthreads();  // the group's blocks (and q) landed
    PHASE_MARK(1)
    const int kc = w < G ? w : (split && w < 2 * G ? w - G : -1);
    if (kc >= 0 && kc < gv) {
      const int k = kc, n = k0 + k, j = j_lo + n, kv_start = j * PD_BS;
      const T* ks = (const T*)kst(k);
      float* sS = (float*)sst(k);
      float* sc1 = sS + ru * PD_LDS;
      const bool verify = split ? w >= G : true;
      const bool compute = split ? w < G : true;
      if (verify && planes) {
        // site 6 (kv), K's half: the block against its resident planes
        const T* pl = (const T*)(kst(k) + L.pl);
        const bool bad_k = warp_fold_bad<T>(ks, ldk, pl, pl + (size_t)cs * D,
                                            cs, PD_BS, D, P.kv_thr, lane);
        if (lane == 0) ws.bk()[n] = bad_k ? 1.f : 0.f;
      }
      if (compute) {
        const bool hit = f_grp && f_blk == j && f_site == S_GEMM1;
        // GEMM I (f32 accumulate) + NVR clip
        auto put = [&](int r, int col, float acc) {
          float sv = acc * P.scale;
          if (hit && r == fr && col == f_col) sv = flip_bit(sv, f_bit);
          if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
          sS[r * PD_LDS + col] = sv;
        };
        if constexpr (BF) {
          float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          const int l16 = lane & 15;
          for (int ksx = 0; ksx < D / 16; ++ksx) {
            uint32_t a[4];
            ldmatrix_x4(a, qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldk +
                               ksx * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              uint32_t bb[2];
              ldmatrix_x2(bb, ks + (nt * 8 + (l16 & 7)) * ldk + ksx * 16 +
                                  (l16 >> 3) * 8);
              mma_bf16(c[nt], a, bb);
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = gq + (e >> 1) * 8;
              if (r < nr) put(r, nt * 8 + 2 * t4 + (e & 1), c[nt][e]);
            }
        } else {
          for (int e = lane; e < nr * PD_BS; e += 32) {
            const int r = e / PD_BS, c = e - r * PD_BS;
            float a = 0.f;
#pragma unroll 4
            for (int d = 0; d < D; ++d)
              a = fmaf(to_f(qs[r * ldk + d]), to_f(ks[c * ldk + d]), a);
            put(r, c, a);
          }
        }
        __syncwarp();
        if (ft) {
          // the fold check: Q fold(K)^T with the folds formed in segment
          // order, then the folded scores in segment order (as the plain
          // version sums them: a struck score moves by d1); locate and
          // correct. bf16: 8 lanes a residue i, each on 8 columns of every
          // 64 of D, the folds formed once for 4 rows at a time and the
          // products summed over the 8 lanes (the order the decode layout
          // takes at one row); f32: a lane a (row, residue) pair
          auto check = [&](int r, int i, float a1, float a2) {
            const int p = r * PD_SKV + i;
            const float c1 = a1 * P.scale, c2 = a2 * P.scale;
            sc1[p] = c1;
            float s1 = 0.f, s2 = 0.f;
#pragma unroll
            for (int l = 0; l < PD_GKV; ++l) {
              const float x = sS[r * PD_LDS + l * PD_SKV + i];
              s1 = s1 + x;
              s2 = s2 + (float)(l + 1) * x;
            }
            const float d1 = c1 - s1, d2 = c2 - s2;
            const bool bad = fabsf(d1) > P.eps1;
            det[0] += bad;
            if (correct && bad)
              sS[r * PD_LDS + seg_of(d1, d2, PD_GKV) * PD_SKV + i] += d1;
          };
          if constexpr (BF) {
            const int i = lane >> 3, sub = lane & 7;
            for (int r0 = 0; r0 < nr; r0 += 4) {
              float a1[4] = {0.f, 0.f, 0.f, 0.f}, a2[4] = {0.f, 0.f, 0.f, 0.f};
              for (int d = sub * 8; d < D; d += 64) {
                float x[PD_GKV][8], f1[8], f2[8];
#pragma unroll
                for (int l = 0; l < PD_GKV; ++l)
                  load_row<T, 8>(x[l], ks + (l * PD_SKV + i) * ldk + d);
#pragma unroll
                for (int m = 0; m < 8; ++m) {
                  f1[m] = 0.f;
                  f2[m] = 0.f;
#pragma unroll
                  for (int l = 0; l < PD_GKV; ++l) {
                    f1[m] = f1[m] + x[l][m];
                    f2[m] = f2[m] + (float)(l + 1) * x[l][m];
                  }
                }
#pragma unroll
                for (int rr = 0; rr < 4; ++rr) {
                  if (r0 + rr >= nr) break;
                  float qv[8];
                  load_row<T, 8>(qv, qs + (r0 + rr) * ldk + d);
#pragma unroll
                  for (int m = 0; m < 8; ++m) {
                    a1[rr] = fmaf(qv[m], f1[m], a1[rr]);
                    a2[rr] = fmaf(qv[m], f2[m], a2[rr]);
                  }
                }
              }
#pragma unroll
              for (int rr = 0; rr < 4; ++rr)
                for (int o = 4; o > 0; o >>= 1) {
                  a1[rr] = a1[rr] + __shfl_xor_sync(FULL, a1[rr], o);
                  a2[rr] = a2[rr] + __shfl_xor_sync(FULL, a2[rr], o);
                }
              if (sub == 0)
#pragma unroll
                for (int rr = 0; rr < 4; ++rr)
                  if (r0 + rr < nr) check(r0 + rr, i, a1[rr], a2[rr]);
            }
          } else {
            for (int p = lane; p < nr * PD_SKV; p += 32) {
              const int r = p / PD_SKV, i = p & (PD_SKV - 1);
              float a1 = 0.f, a2 = 0.f;
#pragma unroll 4
              for (int d = 0; d < D; ++d) {
                float f1 = 0.f, f2 = 0.f;
#pragma unroll
                for (int l = 0; l < PD_GKV; ++l) {
                  const float x = to_f(ks[(l * PD_SKV + i) * ldk + d]);
                  f1 = f1 + x;
                  f2 = f2 + (float)(l + 1) * x;
                }
                const float qv = to_f(qs[r * ldk + d]);
                a1 = fmaf(qv, f1, a1);
                a2 = fmaf(qv, f2, a2);
              }
              check(r, i, a1, a2);
            }
          }
          __syncwarp();
        }
        // the masked block max of each row: PD_SKV lanes a row
        for (int p0 = 0; p0 < nr * PD_SKV; p0 += 32) {
          const int p = p0 + lane;
          const bool valid = p < nr * PD_SKV;
          const int r = valid ? p / PD_SKV : 0, i = p & (PD_SKV - 1);
          float bm = MASK_VALUE;
#pragma unroll
          for (int l = 0; l < PD_GKV; ++l) {
            const int col = kv_start + l * PD_SKV + i;
            const bool mk = col <= U.qpos && U.qpos - col < P.window &&
                            U.q_len > 0;
            bm = nan_max(bm, mk ? sS[r * PD_LDS + l * PD_SKV + i] : MASK_VALUE);
          }
          for (int o = PD_SKV >> 1; o > 0; o >>= 1)
            bm = nan_max(bm, __shfl_xor_sync(FULL, bm, o));
          if (valid && i == 0) {
            bmx[k * ru + r] = bm;
            ws.bm(n)[r] = bm;
          }
        }
        __syncwarp();
        // the scores and the checksum products out to the slot
        for (int e = lane; e < nr * PD_BS; e += 32) {
          const int r = e / PD_BS, c = e - r * PD_BS;
          ws.s(n)[e] = sS[r * PD_LDS + c];
        }
        if (ft)
          for (int e = lane; e < nr * PD_SKV; e += 32) ws.sc1(n)[e] = sc1[e];
      }
    }
    PHASE_MARK(2)
    __syncthreads();  // the block maxima are in; the stages are free
    if (tid < nr) {
      // the group's max of the row, blocks in order (a max: exact)
      float gm = MASK_VALUE;
      for (int k = 0; k < gv; ++k) gm = nan_max(gm, bmx[k * ru + tid]);
      ws.gm(tid)[g] = gm;
    }
  }
  PHASE_MARK(2)
  pl_put_counts(det, 0x19, (int*)(smem + L.red),
                P.rep + ((size_t)bh * P.n_tiles + U.rg * C.GY + y) * 6);
  PHASE_MARK(3)
  PHASE_FLUSH
}

// ---- the EXP pass ----
template <typename T>
__global__ void __launch_bounds__(PL_THREADS, 3)
    efta_paged_kernel_lexp(const PLParams C) {
  constexpr bool BF = sizeof(T) == 2;
  const Params& P = C.P;
  const PLLayout& L = C.L;
  PHASE_INIT
  const int u = blockIdx.x, y = blockIdx.y;
  const PLUnit U = pl_unit(P, C.n_rg, u);
  const int b = U.b, h = U.h, bh = U.bh, nr = U.nr, j_lo = U.j_lo;
  const int n_run = U.n_run;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int D = P.D, cs = P.cs, sout = P.s_out, mb = P.mb, G = C.G;
  const int ldk = L.ldk, ru = L.ru;
  const int g_out = D / sout;
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const float MASK_VALUE = (float)MASK_D;
  const float MASK_HALF = (float)(MASK_D / 2);
  const float cap = (float)(80.0 / PD_GKV);
  const float cap_g = (float)(80.0 / PD_GKV * PD_GKV);
  const float cap_m = (float)(80.0 / PD_GKV - 1e-3);
  const int gq = lane >> 2, t4 = lane & 3;
  const bool f_unit = P.fault[P_ON] == 1 && P.fault[P_B] == b &&
                      P.fault[P_H] == h;
  const int fr = P.fault[P_ROW] - U.row0;
  const bool f_grp = f_unit && fr >= 0 && fr < nr;
  const int f_col = P.fault[P_COL], f_bit = P.fault[P_BIT],
            f_site = P.fault[P_SITE], f_blk = P.fault[P_BLOCK];
  const bool mflip = f_grp && f_site == S_ROWMAX && f_blk >= j_lo &&
                     f_blk - j_lo < n_run;
  const bool planes = ft && U.rg == 0;
  const int n_grp = (n_run + G - 1) / G;
  const int* btr = P.bt + (size_t)b * mb;
  int det[6] = {0, 0, 0, 0, 0, 0};
  extern __shared__ __align__(16) unsigned char smem[];
  auto eslot = [&](int k) { return smem + L.slots + (size_t)k * L.eslot; };
  float* s_min = (float*)(smem + L.e_min);
  const PLWs ws = pl_ws(C, u);
  float* vc1 = (float*)(smem + L.vc) + (size_t)w * 2 * PD_BS * sout;
  float* vc2 = vc1 + PD_BS * sout;

  // the running max of row r entering group g, by one warp: the earlier
  // groups' maxima (the score pass's), and where the SEU strikes the
  // running max at an earlier block, that block's value flipped as the
  // sequential step flips it (checked against the shadow max, put back in
  // correct mode), every later max taken from the struck value
  auto m_enter = [&](int r, int g) {
    auto gmax = [&](int a, int e) {
      float x = MASK_VALUE;
      const float* gm = ws.gm(r);
      for (int gi = a + lane; gi < e; gi += 32) x = nan_max(x, gm[gi]);
      for (int o = 16; o > 0; o >>= 1)
        x = nan_max(x, __shfl_xor_sync(FULL, x, o));
      return x;
    };
    auto bmax = [&](int a, int e) {
      float x = MASK_VALUE;
      for (int n = a + lane; n < e; n += 32) x = nan_max(x, ws.bm(n)[r]);
      for (int o = 16; o > 0; o >>= 1)
        x = nan_max(x, __shfl_xor_sync(FULL, x, o));
      return x;
    };
    const int nf = mflip && r == fr ? f_blk - j_lo : -1;
    const int gf = nf >= 0 ? nf / G : -1;
    if (gf < 0 || gf >= g) return gmax(0, g);
    const float a = nan_max(gmax(0, gf), bmax(gf * G, nf + 1));
    float mn = flip_bit(a, f_bit);
    if (ft && P.shadow_rowmax && correct && mn != opaque(a)) mn = a;
    return nan_max(nan_max(mn, bmax(nf + 1, min(gf * G + G, n_run))),
                   gmax(gf + 1, g));
  };

  PHASE_MARK(4)
  for (int g = y; g < n_grp; g += C.GY) {
    const int k0 = g * G, gv = min(G, n_run - k0);
    // V and its planes through the table; the score pass's scores,
    // checksum products and block maxima from the slots
    for (int k = 0; k < gv; ++k) {
      const size_t blk = (size_t)btr[j_lo + k0 + k] * P.Hkv + h;
      pl_gather_tile<T>((T*)eslot(k), (const T*)P.v + blk * PD_BS * D, D,
                        ldk, tid);
      if (planes)
        pl_gather_planes(eslot(k) + L.pl,
                         P.vc1, P.vc2, blk * cs * D * sizeof(T),
                         cs * D * (int)sizeof(T), tid);
      const int n = k0 + k;
      float* sS = (float*)(eslot(k) + L.e_s);
      for (int e = tid; e < nr * (PD_BS / 4); e += PL_THREADS) {
        const int r = e / (PD_BS / 4), c4 = e - r * (PD_BS / 4);
        cp_async16(sS + r * PD_LDS + 4 * c4, ws.s(n) + r * PD_BS + 4 * c4);
      }
      float* sc1 = (float*)(eslot(k) + L.e_sc1);
      if (ft)
        for (int r = tid; r < nr; r += PL_THREADS)
          cp_async16(sc1 + r * PD_SKV, ws.sc1(n) + r * PD_SKV);
      float* row = (float*)(eslot(k) + L.e_row);
      for (int r = tid; r < nr; r += PL_THREADS)
        cp_async4(row + r * PL_RN + PL_BM, ws.bm(n) + r);
    }
    cp_async_commit();
    for (int r = w; r < nr; r += PL_WARPS) {
      const float m = m_enter(r, g);
      if (lane == 0) s_min[r] = m;
    }
    cp_async_wait(0);
    __syncthreads();  // the group's blocks and the maxima entering it
    PHASE_MARK(5)

    // the running max through the group's blocks, a warp a row, a lane a
    // block (the decode layout's exchange 1 from the entering max)
    for (int r = w; r < nr; r += PL_WARPS) {
      const float m = s_min[r];
      const bool valid = lane < gv;
      float* rw = (float*)(eslot(valid ? lane : 0) + L.e_row) + r * PL_RN;
      const float bm = valid ? rw[PL_BM] : -INFINITY;
      float x = bm;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float yv = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x = nan_max(yv, x);
      }
      float v = nan_max(m, x);
      const int fl = mflip && r == fr ? f_blk - j_lo - k0 : -1;
      bool badf = false;
      if (fl >= 0 && fl < gv) {
        // the SEU as the sequential step applies it: the step's m flipped,
        // against the shadow max (the unflipped value), put back in correct
        // mode; every later block's max from the struck value
        const float a = __shfl_sync(FULL, v, fl);
        float mn = flip_bit(a, f_bit);
        if (ft && P.shadow_rowmax) {
          badf = mn != opaque(a);
          if (correct && badf) mn = a;
        }
        float x2 = lane > fl ? bm : -INFINITY;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float yv = __shfl_up_sync(FULL, x2, o);
          if (lane >= o) x2 = nan_max(yv, x2);
        }
        if (lane == fl) v = mn;
        if (lane > fl) v = nan_max(mn, x2);
      }
      float vp = __shfl_up_sync(FULL, v, 1);
      if (lane == 0) vp = m;
      if (valid) {
        // the shadow max, a block at a time: it differs from m where the
        // SEU struck, or (detect mode) wherever m carries a NaN
        if (ft && P.shadow_rowmax) det[2] += lane == fl ? badf : isnan(v);
        const bool alive = v > MASK_HALF;
        rw[PL_MS] = alive ? v : 0.f;
        rw[PL_AL] = alive ? expf(vp - v) : 1.f;
      }
    }
    __syncthreads();
    PHASE_MARK(6)

    // a warp a block
    for (int k = w; k < gv; k += PL_WARPS) {
      const int n = k0 + k, j = j_lo + n, kv_start = j * PD_BS;
      unsigned char* sl = eslot(k);
      const T* vs = (const T*)sl;
      float* sS = (float*)(sl + L.e_s);
      const float* sc1 = (const float*)(sl + L.e_sc1);
      const float* row = (const float*)(sl + L.e_row);
      const bool hit = f_grp && f_blk == j && f_site == S_EXP;
      if (planes) {
        // site 6 (kv), V's half, and the block's flag from both halves
        const T* pl = (const T*)(sl + L.pl);
        const bool bad_v = warp_fold_bad<T>(vs, ldk, pl, pl + (size_t)cs * D,
                                            cs, PD_BS, D, P.kv_thr, lane);
        const bool flag = (bad_v || ws.bk()[n] != 0.f) && btr[j] > 0;
        if (lane == 0) {
          det[5] += flag;
          P.bad[(size_t)bh * mb + j] = flag;
        }
      }
      // EXP with checksum reuse (paper Case 2), backstop, mask, rowsum
      // (+ shadow); p is written over s
      for (int p0 = 0; p0 < nr * PD_SKV; p0 += 32) {
        const int p = p0 + lane;
        const bool valid = p < nr * PD_SKV;
        const int r = valid ? p / PD_SKV : 0, i = p & (PD_SKV - 1);
        const float ms = row[r * PL_RN + PL_MS];
        float* srow = sS + r * PD_LDS + i;
        float pr[PD_GKV];
        float prod = 1.f;
        bool col_ok = true;
#pragma unroll
        for (int l = 0; l < PD_GKV; ++l) {
          const float sv = srow[l * PD_SKV];
          float x = expf(nan_min(sv - ms, cap));
          if (hit && valid && r == fr && l * PD_SKV + i == f_col)
            x = flip_bit(x, f_bit);
          pr[l] = x;
          prod = prod * x;
          col_ok = col_ok && !((sv - ms) > cap_m);
        }
        if (ft) {
          const float pc1 =
              expf(nan_min(sc1[r * PD_SKV + i] - (float)PD_GKV * ms, cap_g));
          const float ref = nan_max(fabsf(pc1), 1e-20f);
          const bool bad =
              col_ok && (fabsf(prod - pc1) > P.eps2 * ref + 1e-20f);
          if (valid) det[1] += bad;
          if (correct && bad) {
#pragma unroll
            for (int l = 0; l < PD_GKV; ++l)
              pr[l] = expf(nan_min(srow[l * PD_SKV] - ms, cap));
          }
        }
        float ps = 0.f, ps2 = 0.f;
#pragma unroll
        for (int l = 0; l < PD_GKV; ++l) {
          float x = pr[l];
          if (ft && P.shadow_rowmax && correct) {
            // exact recompute backstop
            const float rc = expf(nan_min(srow[l * PD_SKV] - ms, cap));
            const bool slipped = x != rc;
            if (valid) det[1] += slipped;
            if (slipped) x = rc;
          }
          const int col = kv_start + l * PD_SKV + i;
          const bool mk = col <= U.qpos && U.qpos - col < P.window &&
                          U.q_len > 0;
          x = mk ? x : 0.f;
          if (valid) srow[l * PD_SKV] = x;
          ps = ps + x;
          ps2 = ps2 + opaque(x);
        }
        for (int o = PD_SKV >> 1; o > 0; o >>= 1) {
          ps = ps + __shfl_xor_sync(FULL, ps, o);
          ps2 = ps2 + opaque(__shfl_xor_sync(FULL, ps2, o));
        }
        if (valid && i == 0) {
          const float bm = row[r * PL_RN + PL_BM];
          *(float4*)(ws.gat(n) + r * 4) =
              make_float4(row[r * PL_RN + PL_AL], ps, ps2,
                          bm > MASK_HALF ? expf(bm - ms) : 0.f);
        }
      }
      float vm = 0.f;  // the block's max|V| (read by the clamp)
      if (ft) {
        // V column checksums of the block, segments in order, and max|V|
        for (int e = lane; e < PD_BS * sout; e += 32) {
          const int c = e / sout, i = e - c * sout;
          float f1 = 0.f, f2 = 0.f;
          for (int l = 0; l < g_out; ++l) {
            const float x = to_f(vs[c * ldk + l * sout + i]);
            f1 = f1 + x;
            f2 = f2 + (float)(l + 1) * x;
            vm = nan_max(vm, fabsf(x));
          }
          vc1[e] = f1;
          vc2[e] = f2;
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        vm = nan_max(vm, __shfl_xor_sync(FULL, vm, o));
      if (lane == 0) ws.vm()[n] = vm;
      __syncwarp();
      // GEMM II of the block (f32 accumulate, from zero)
      float* pv = ws.pv(n);
      if constexpr (BF) {
        // p rounded to bf16 as mma's A (rows past the unit's read its last
        // row; their products are not kept)
        const int ra = min(gq, nr - 1), rb = min(gq + 8, nr - 1);
        const float2 x0 = *(const float2*)(sS + ra * PD_LDS + 2 * t4);
        const float2 x1 = *(const float2*)(sS + rb * PD_LDS + 2 * t4);
        const float2 x2 = *(const float2*)(sS + ra * PD_LDS + 2 * t4 + 8);
        const float2 x3 = *(const float2*)(sS + rb * PD_LDS + 2 * t4 + 8);
        const uint32_t a[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                               pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) *
                                         ldk + np * 16 + (lane >> 4) * 8);
          float o4[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          mma_bf16(o4[0], a, bb);
          mma_bf16(o4[1], a, bb + 2);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int r = gq + h2 * 8;
              if (r < nr)
                *(float2*)(pv + r * D + np * 16 + nt * 8 + 2 * t4) =
                    make_float2(o4[nt][2 * h2], o4[nt][2 * h2 + 1]);
            }
        }
      } else {
        for (int e = lane; e < nr * D; e += 32) {
          const int r = e / D, col = e - r * D;
          float a = 0.f;
#pragma unroll 4
          for (int c = 0; c < PD_BS; ++c)
            a = fmaf(round_to<T>(sS[r * PD_LDS + c]), to_f(vs[c * ldk + col]),
                     a);
          pv[e] = a;
        }
      }
      if (ft) {
        // the block's O-checksum products
        for (int p = lane; p < nr * sout; p += 32) {
          const int r = p / sout, i = p - r * sout;
          float a1 = 0.f, a2 = 0.f;
#pragma unroll 8
          for (int c = 0; c < PD_BS; ++c) {
            const float pf = sS[r * PD_LDS + c];
            a1 = fmaf(pf, vc1[c * sout + i], a1);
            a2 = fmaf(pf, vc2[c * sout + i], a2);
          }
          ws.ocb(n)[r * 2 * sout + i] = a1;
          ws.ocb(n)[r * 2 * sout + sout + i] = a2;
        }
      }
      __syncwarp();  // vc1 / vc2 are the next block's
    }
    PHASE_MARK(7)
    __syncthreads();  // the slots in shared memory are free
  }
  PHASE_MARK(7)
  pl_put_counts(det, 0x26, (int*)(smem + L.e_red),
                P.rep + ((size_t)bh * P.n_tiles + U.rg * C.GY + y) * 6);
  PHASE_MARK(8)
  PHASE_FLUSH
}

// the state pass: blocks a stage, stages in flight
constexpr int PL_SC = 16, PL_SST = 4;

// a block's floats in a stage of the state pass: alpha and the row terms
// [4], P V [D], the O-checksum products [2 sout] (16-byte rows)
__host__ __device__ __forceinline__ int plong_stage_row(int D, int sout) {
  return 4 + D + ((2 * sout + 3) & ~3);
}

// the state pass's shared bytes: PL_SST stages of PL_SC blocks of its row;
// acc [D], the O checksums [2][sout], l, shadow l, r, safe l, max|V| (8
// floats), each warp's max|V| (8 ints), the count reduction
size_t plong_state_smem(int D, int sout) {
  return ((size_t)PL_SST * PL_SC * plong_stage_row(D, sout) + D + 2 * sout +
          16) * 4 +
         (PL_ST_THREADS / 32) * 8 * 4;
}

// ---- the state pass: a CTA a (unit, row) ----
template <typename T>
__global__ void __launch_bounds__(PL_ST_THREADS)
    efta_paged_kernel_lstate(const PLParams C) {
  const Params& P = C.P;
  PHASE_INIT
  const int u = blockIdx.x, r = blockIdx.y;
  const PLUnit U = pl_unit(P, C.n_rg, u);
  const int b = U.b, h = U.h, bh = U.bh, nr = U.nr, j_lo = U.j_lo;
  const int n_run = U.n_run;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int D = P.D, sout = P.s_out;
  const int g_out = D / sout;
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const bool f_unit = P.fault[P_ON] == 1 && P.fault[P_B] == b &&
                      P.fault[P_H] == h;
  const bool fr_row = f_unit && P.fault[P_ROW] - U.row0 == r;
  const int f_col = P.fault[P_COL], f_bit = P.fault[P_BIT],
            f_site = P.fault[P_SITE], f_blk = P.fault[P_BLOCK];
  int det[6] = {0, 0, 0, 0, 0, 0};
  extern __shared__ __align__(16) unsigned char smem[];
  const int per = plong_stage_row(D, sout);  // a block's floats a stage
  float* stg = (float*)smem;
  float* facc = stg + (size_t)PL_SST * PL_SC * per;
  float* foc1 = facc + D;
  float* foc2 = foc1 + sout;
  float* sc = foc2 + sout;  // l, shadow l, r, safe l, max|V|
  int* red = (int*)(sc + 8);
  const PLWs ws = pl_ws(C, u);
  const bool live = r < nr;
  PHASE_MARK(9)
  if (live) {
    // max|V| over the unit's running blocks (0 where EFTA is off)
    float vm = 0.f;
    for (int n = tid; n < n_run; n += PL_ST_THREADS)
      vm = nan_max(vm, ws.vm()[n]);
    for (int o = 16; o > 0; o >>= 1)
      vm = nan_max(vm, __shfl_xor_sync(FULL, vm, o));
    if (lane == 0) red[w] = __float_as_int(vm);
    // the row's state, a thread an element, from zero
    for (int e = tid; e < D + 2 * sout + 3; e += PL_ST_THREADS) facc[e] = 0.f;
    // the row's alpha, row terms, P V and O-checksum products of each
    // block, PL_SC blocks a stage, PL_SST - 1 stages in flight
    const int n_ch = (n_run + PL_SC - 1) / PL_SC;
    const int q4 = D / 4;
    auto issue = [&](int c) {
      if (c >= n_ch) return;
      float* st = stg + (size_t)(c % PL_SST) * PL_SC * per;
      const int n0 = c * PL_SC, nn = min(PL_SC, n_run - n0);
      for (int e = tid; e < nn * (q4 + 1); e += PL_ST_THREADS) {
        const int k = e / (q4 + 1), p = e - k * (q4 + 1);
        if (p == 0)
          cp_async16(st + k * per, ws.gat(n0 + k) + r * 4);
        else
          cp_async16(st + k * per + 4 + 4 * (p - 1),
                     ws.pv(n0 + k) + (size_t)r * D + 4 * (p - 1));
      }
      if (ft)
        for (int e = tid; e < nn * 2 * sout; e += PL_ST_THREADS) {
          const int k = e / (2 * sout), i = e - k * 2 * sout;
          cp_async4(st + k * per + 4 + D + i,
                    ws.ocb(n0 + k) + r * 2 * sout + i);
        }
    };
    for (int c = 0; c < PL_SST - 1; ++c) {
      issue(c);
      cp_async_commit();
    }
    __syncthreads();  // the state is zeroed
    const int items = D + sout + 1;
    for (int c = 0; c < n_ch; ++c) {
      issue(c + PL_SST - 1);
      cp_async_commit();
      cp_async_wait(PL_SST - 1);
      __syncthreads();  // stage c landed
      const float* st = stg + (size_t)(c % PL_SST) * PL_SC * per;
      const int n0 = c * PL_SC, nn = min(PL_SC, n_run - n0);
      // a thread an element of the row's state, the stage's blocks in order
      for (int it = tid; it < items; it += PL_ST_THREADS) {
        if (it < D) {
          const int d = it;
          float an = facc[d];
          for (int k = 0; k < nn; ++k) {
            an = st[k * per] * an + st[k * per + 4 + d];
            if (fr_row && f_site == S_GEMM2 && f_blk == j_lo + n0 + k &&
                d == f_col)
              an = flip_bit(an, f_bit);
          }
          facc[d] = an;
        } else if (it < D + sout) {
          const int i = it - D;
          float o1 = foc1[i], o2 = foc2[i];
          if (ft)
            for (int k = 0; k < nn; ++k) {
              const float a = st[k * per];
              o1 = a * o1 + st[k * per + 4 + D + i];
              o2 = a * o2 + st[k * per + 4 + D + sout + i];
            }
          foc1[i] = o1;
          foc2[i] = o2;
        } else {
          float l = sc[0], lsh = sc[1], rr = sc[2];
          for (int k = 0; k < nn; ++k) {
            const float4 g = *(const float4*)(st + k * per);
            float ln = g.x * l + g.y;
            if (fr_row && f_site == S_ROWSUM && f_blk == j_lo + n0 + k)
              ln = flip_bit(ln, f_bit);
            l = ln;
            if (ft && P.shadow_rowsum) lsh = g.x * lsh + g.z;
            rr = g.x * rr + g.w;
          }
          sc[0] = l;
          sc[1] = lsh;
          sc[2] = rr;
        }
      }
      __syncthreads();  // stage c is free
    }
    cp_async_wait(0);
    PHASE_MARK(10)
    if (tid == 0) {
      float vmax = 0.f;
      for (int i = 0; i < PL_ST_THREADS / 32; ++i)
        vmax = nan_max(vmax, __int_as_float(red[i]));
      sc[4] = vmax;
      // finalize: SNVR on l
      float lf = sc[0];
      if (ft) {
        const float rf = sc[2];
        const float upper = (float)min(U.qpos + 1, U.kv_len) + 1e-3f;
        const bool in_range = lf >= rf - 1e-3f && lf <= upper && isfinite(lf);
        bool bad;
        float fallback;
        if (P.shadow_rowsum) {
          const float lsh = sc[1];
          const bool mism =
              fabsf(lf - lsh) > 1e-5f * nan_max(fabsf(lsh), 1e-6f);
          bad = (!in_range || mism) && rf > 0.f;
          const bool fb_ok =
              lsh >= rf - 1e-3f && lsh <= upper && isfinite(lsh);
          fallback = fb_ok ? lsh : rf;
        } else {
          bad = !in_range && rf > 0.f;
          fallback = rf;
        }
        det[3] += bad;
        if (correct && bad) lf = fallback;
      }
      sc[3] = lf == 0.f ? 1.f : lf;
    }
    __syncthreads();
    // + the unified output verification
    const float ls = sc[3];
    const float bound = sc[4] * 1.001f + 1e-6f;
    for (int d = tid; d < D; d += PL_ST_THREADS) {
      float o = facc[d] / ls;
      if (ft && correct) o = (isfinite(o) && fabsf(o) <= bound) ? o : 0.f;
      facc[d] = o;
    }
    __syncthreads();
    if (ft)
      for (int i = tid; i < sout; i += PL_ST_THREADS) {
        float s1 = 0.f, s2 = 0.f;
        for (int q = 0; q < g_out; ++q) {
          const float x = facc[q * sout + i];
          s1 = s1 + x;
          s2 = s2 + (float)(q + 1) * x;
        }
        const float d1 = foc1[i] / ls - s1;
        const float d2 = foc2[i] / ls - s2;
        const bool bad = !(fabsf(d1) <= P.eps3);
        det[4] += bad;
        if (correct && bad) facc[seg_of(d1, d2, g_out) * sout + i] += d1;
      }
    __syncthreads();
    T* og = (T*)P.out + ((size_t)bh * P.R + U.row0 + r) * D;
    for (int d = tid; d < D; d += PL_ST_THREADS) og[d] = from_f<T>(facc[d]);
  }
  PHASE_MARK(11)
  pl_put_counts(det, 0x3f, red + 8,
                P.rep + ((size_t)bh * P.n_tiles + C.n_rg * C.GY +
                         U.rg * PD_ROWS + r) * 6);
  PHASE_MARK(12)
  PHASE_FLUSH
}
