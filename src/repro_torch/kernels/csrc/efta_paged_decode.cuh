// Kernel B1's decode layout, for launches of one chunk row (C 1: the decode
// step of the paged serve engine; the design note is at the head of
// efta_paged.cu). Included by efta_paged.cu inside its anonymous namespace,
// after Params, warp_fold_bad, the fault-descriptor indices and
// efta_hopper.cuh.
//
// One launch, a cluster of PD_CTAS CTAs a unit. A unit is (request, KV
// head, up to PD_ROWS of its query heads). The unit's running blocks form
// one interval of the block table; CTA `rank` takes the contiguous span
// [rank * per, rank * per + per) of it (per = ceil(n_run / PD_CTAS)).
//   * Phase A, each CTA on its span: K, V and (site 6) the four resident
//     planes gathered through the block table by cp.async, KG blocks a step;
//     per block, one warp: the site-6 check (a second warp where 2 KG warps
//     fit), GEMM I (mma.sync in bf16, f32 FMAs in f32), the fold check with
//     locate and correct (the K folds formed on the fly in segment order as
//     the first layout forms them; in bf16 the checksum products of a few
//     rows split over lanes), the masked block max.
//   * Exchange 1 (barrier.cluster): each CTA replays the running max in
//     block order from the block maxima of every block up to its span's
//     last, read over distributed shared memory, a lane a block (a prefix
//     max by shuffles: the max is exact in any order), with the shadow max
//     and its SEU at the block they belong to; the subtracted max of its
//     own blocks, and their alpha, stored into the row's owner (CTA
//     r % PD_CTAS for row r).
//   * Phase B, each CTA on its span, a warp a block: EXP with its
//     product-fold check and backstop under the 80/g_kv cap, the rowsum,
//     shadow rowsum and SNVR terms, V's column checksums and max|V|, P V
//     from zero (mma.sync in bf16) and the O-checksum products; each
//     block's terms, P V and O-checksum products stored into the row's
//     owner over distributed shared memory (stores do not wait on the
//     far side; the barrier makes them visible).
//   * Exchange 2 (barrier.cluster): each owner folds its rows' running
//     state in block order from its own shared memory, acc = alpha_j acc +
//     PV_j with l, the shadow l, r and the O checksums, the operations of
//     the first layout's phase C in the same order; the rowsum and GEMM II
//     SEUs at their block; then the finalize (SNVR bound, |o| <= max|V|
//     clamp, unified output verify and correct). No CTA touches a peer's
//     shared memory past the second barrier, so none waits for another to
//     end.
// No partial states of spans are merged (tests/test_torch_paged_split.py):
// each value is formed as a walk over the blocks one at a time forms it,
// so counts and bad planes equal the sequential plain version's. Each CTA
// writes its own (6,) partial counts, summed by the wrapper: no atomics.

// CTAs a cluster (portable), query heads a unit (an mma tile of rows),
// threads a CTA, KV blocks a phase-A step at most
constexpr int PD_CTAS = 8, PD_ROWS = 16, PD_THREADS = 256, PD_KG = 4;
constexpr int PD_WARPS = PD_THREADS / 32;
// keys a block, the ABFT stride, fold segments, score row stride (floats)
constexpr int PD_BS = 16, PD_SKV = 4, PD_GKV = PD_BS / PD_SKV;
constexpr int PD_LDS = PD_BS + 4;
// shared bytes a CTA at most for two CTAs an SM (228 KB, 1 KB of it
// reserved a CTA)
constexpr size_t PD_SMEM_PAIR = 115712;
// a block's row scalars, [row][PD_RN]: block max, subtracted max
constexpr int PD_BM = 0, PD_MS = 1, PD_RN = 2;

// shared-memory layout of one CTA (byte offsets)
struct PDLayout {
  int ldk;   // K / V / q row stride, elements of T
  int ldo;   // P V row stride, floats
  int ru;    // rows a unit: min(R, PD_ROWS)
  int ro;    // rows a CTA owns at exchange 2
  int span;  // blocks a CTA at most: ceil(mb / PD_CTAS)
  int nb;    // blocks a unit at most: span * PD_CTAS
  // one span block's slot: V, the scores (then p), the checksum products
  // Q fold(K)^T at fold 1, the row scalars
  size_t s_v, s_s, s_sc1, s_row, slot;
  size_t k_pl, kslot;  // one K stage: K, then the four resident planes
  // the request's table row; q; the span's slots; the K stages (phase B:
  // each warp's V column checksums); what the owned rows' blocks store
  // here: alpha and the rowsum, shadow rowsum and SNVR terms [ro][nb][4],
  // P V [ro][nb][ldo], the two O-checksum products [ro][nb][2 sout]; the
  // owned rows' state; each CTA's max|V|; the count reduction
  size_t bts, q, slots, kring, gat, fpv, focb, fin, vmx, red, total;
};

PDLayout make_pdecode_layout(int KG, int R, int D, int cs, int sout, int esz,
                             int mb) {
  PDLayout L;
  L.ldk = esz == 2 ? D + 8 : D + 1;
  L.ldo = D + 4;
  L.ru = R < PD_ROWS ? R : PD_ROWS;
  L.ro = (L.ru + PD_CTAS - 1) / PD_CTAS;
  L.span = (mb + PD_CTAS - 1) / PD_CTAS;
  L.nb = L.span * PD_CTAS;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) & ~(size_t)15;
    return o;
  };
  const size_t ru = L.ru, tile = (size_t)PD_BS * L.ldk * esz;
  L.s_v = take(tile);
  L.s_s = take(ru * PD_LDS * 4);
  L.s_sc1 = take(ru * PD_SKV * 4);
  L.s_row = take(ru * PD_RN * 4);
  L.slot = off;
  off = 0;
  take(tile);
  L.k_pl = take(4 * (size_t)cs * D * esz);
  L.kslot = off;
  off = 0;
  L.bts = take((size_t)mb * 4);
  L.q = take((size_t)PD_ROWS * L.ldk * esz);
  L.slots = take((size_t)L.span * L.slot);
  const size_t ks = (size_t)KG * L.kslot,
               vc = (size_t)PD_WARPS * 2 * PD_BS * sout * 4;
  L.kring = take(ks > vc ? ks : vc);
  const size_t rb = (size_t)L.ro * L.nb;
  L.gat = take(rb * 4 * 4);
  L.fpv = take(rb * L.ldo * 4);
  L.focb = take(rb * 2 * sout * 4);
  // acc [ro][ldo], the O checksums [2][ro][sout], l, shadow l, r, safe l
  L.fin = take(((size_t)L.ro * L.ldo + 2 * (size_t)L.ro * sout +
                4 * (size_t)L.ro) * 4);
  L.vmx = take(PD_CTAS * 4);
  L.red = take((size_t)PD_WARPS * 8 * 4);
  L.total = off;
  return L;
}

struct PDParams {
  Params P;  // P.L, W, G, ST, DS unused; P.n_tiles = n_rg * PD_CTAS
  PDLayout L;
  int KG;    // blocks a phase-A step
  int n_rg;  // units a (request, KV head): ceil(R / PD_ROWS)
};

// grid (PD_CTAS x units), cluster (PD_CTAS, 1, 1); unit u = (b Hkv + h)
// n_rg + rg
template <typename T>
__global__ void __launch_bounds__(PD_THREADS, 3)
    efta_paged_kernel_decode(const PDParams C) {
  constexpr bool BF = sizeof(T) == 2;
  const Params& P = C.P;
  const PDLayout& L = C.L;
  PHASE_INIT
  const unsigned rank = cluster_rank();
  const int u = blockIdx.x / PD_CTAS;
  const int rg = u % C.n_rg, bh = u / C.n_rg;
  const int b = bh / P.Hkv, h = bh - b * P.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int D = P.D, cs = P.cs, sout = P.s_out, mb = P.mb, R = P.R;
  const int ldk = L.ldk, ldo = L.ldo, KG = C.KG, nb_all = L.nb;
  const int g_out = D / sout;
  const int row0 = rg * PD_ROWS, nr = min(PD_ROWS, R - row0);
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const float MASK_VALUE = (float)MASK_D;
  const float MASK_HALF = (float)(MASK_D / 2);
  const float cap = (float)(80.0 / PD_GKV);
  const float cap_g = (float)(80.0 / PD_GKV * PD_GKV);
  const float cap_m = (float)(80.0 / PD_GKV - 1e-3);
  const int window = P.window;
  const int gq = lane >> 2, t4 = lane & 3;
  const bool f_unit = P.fault[P_ON] == 1 && P.fault[P_B] == b &&
                      P.fault[P_H] == h;
  const int fr = P.fault[P_ROW] - row0;
  const bool f_grp = f_unit && fr >= 0 && fr < nr;
  const int f_col = P.fault[P_COL], f_bit = P.fault[P_BIT],
            f_site = P.fault[P_SITE], f_blk = P.fault[P_BLOCK];
  const bool planes = ft && rg == 0;
  int det[6] = {0, 0, 0, 0, 0, 0};
  extern __shared__ __align__(16) unsigned char smem[];
  // the request's table row, in flight while kv_len is read
  int* bts = (int*)(smem + L.bts);
  for (int j = tid; j < mb; j += PD_THREADS)
    cp_async4(bts + j, P.bt + (size_t)b * mb + j);
  cp_async_commit();
  const int kv_len = P.kv_lens[b], q_len = P.q_lens[b];
  const int qpos = kv_len - q_len;  // the chunk row's position

  // the running blocks, j PD_BS < kv_len and qpos - (j PD_BS + PD_BS - 1)
  // < window, form one interval [j_lo, j_lo + n_run); this CTA's span of it
  // starts at n0 (index within the interval)
  const int past = qpos - window - (PD_BS - 1);  // j PD_BS > past runs
  const int j_lo = past < 0 ? 0 : past / PD_BS + 1;
  const int n_run = max(0, min(mb, (kv_len + PD_BS - 1) / PD_BS) - j_lo);
  const int per = max(1, (n_run + PD_CTAS - 1) / PD_CTAS);
  const int n0 = min(n_run, (int)rank * per);
  const int nmine = min(n_run, n0 + per) - n0;
  const int n_end = n0 + nmine;  // blocks up to this CTA's last
  if (rank == 0 && rg == 0)
    // the bad plane of every block that does not run (or is not verified)
    for (int j = tid; j < mb; j += PD_THREADS)
      if (!(ft && j >= j_lo && j < j_lo + n_run)) P.bad[(size_t)bh * mb + j] = 0;

  T* qs = (T*)(smem + L.q);
  auto slot = [&](int k) { return smem + L.slots + (size_t)k * L.slot; };
  auto kst = [&](int k) { return smem + L.kring + (size_t)k * L.kslot; };
  float* gat = (float*)(smem + L.gat);
  float* fpv = (float*)(smem + L.fpv);
  float* focb = (float*)(smem + L.focb);
  float* vmx = (float*)(smem + L.vmx);
  int* red = (int*)(smem + L.red);
  // where block n's terms for row r go: its owner, CTA r % PD_CTAS, at
  // [r / PD_CTAS][n]
  auto owned = [&](int r, int n) {
    return (size_t)(r / PD_CTAS) * nb_all + n;
  };

  // ---- phase A: the span's blocks, KG a step ----
  auto issue = [&](int step) {
    const int k0 = step * KG, gv = min(KG, nmine - k0);
    for (int k = 0; k < gv; ++k) {
      const int bid = bts[j_lo + n0 + k0 + k];
      const size_t blk = (size_t)bid * P.Hkv + h;
      for (int t = 0; t < 2; ++t) {
        const T* src = (const T*)(t ? P.v : P.k) + blk * PD_BS * D;
        T* dst = (T*)(t ? slot(k0 + k) + L.s_v : kst(k));
        if constexpr (BF) {
          const int per8 = D / 8;
          for (int e = tid; e < PD_BS * per8; e += PD_THREADS) {
            const int c = e / per8, p8 = e - c * per8;
            cp_async16(dst + c * ldk + p8 * 8, src + (size_t)c * D + p8 * 8);
          }
        } else {
          for (int e = tid; e < PD_BS * D; e += PD_THREADS) {
            const int c = e / D, d = e - c * D;
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
          unsigned char* dst = kst(k) + L.k_pl + (size_t)t * cs * D * sizeof(T);
          for (int e = tid; e < n16; e += PD_THREADS)
            cp_async16(dst + 16 * e, src + 16 * e);
        }
      }
    }
  };
  cp_async_wait(0);
  __syncthreads();  // the table row is in
  if (nmine > 0) {
    const T* qg = (const T*)P.q + ((size_t)bh * R + row0) * D;
    if constexpr (BF) {
      const int per8 = D / 8;
      for (int e = tid; e < nr * per8; e += PD_THREADS) {
        const int r = e / per8, p8 = e - r * per8;
        cp_async16(qs + r * ldk + p8 * 8, qg + (size_t)r * D + p8 * 8);
      }
    } else {
      for (int e = tid; e < nr * D; e += PD_THREADS) {
        const int r = e / D, d = e - r * D;
        cp_async4(qs + r * ldk + d, qg + (size_t)r * D + d);
      }
    }
    // the tile's rows past the unit's: zero (GEMM I reads 16 rows)
    for (int e = tid; e < (PD_ROWS - nr) * ldk; e += PD_THREADS)
      qs[nr * ldk + e] = from_f<T>(0.f);
  }
  const int n_steps = (nmine + KG - 1) / KG;
  const bool split = 2 * KG <= PD_WARPS;  // verify warps of their own
  PHASE_MARK(0)
  for (int step = 0; step < n_steps; ++step) {
    issue(step);
    cp_async_commit();
    cp_async_wait(0);
    __syncthreads();  // the step's blocks (and q) landed
    PHASE_MARK(1)
    const int k0 = step * KG, gv = min(KG, nmine - k0);
    const int kc = w < KG ? w : (split && w < 2 * KG ? w - KG : -1);
    if (kc >= 0 && kc < gv) {
      const int k = k0 + kc, j = j_lo + n0 + k, kv_start = j * PD_BS;
      unsigned char* sl = slot(k);
      const T* ks = (const T*)kst(kc);
      const T* vs = (const T*)(sl + L.s_v);
      float* sS = (float*)(sl + L.s_s);
      float* sc1 = (float*)(sl + L.s_sc1);
      float* row = (float*)(sl + L.s_row);
      const bool verify = split ? w >= KG : true;
      const bool compute = split ? w < KG : true;
      if (verify && planes) {
        // site 6 (kv): the block against its resident planes
        const T* pl = (const T*)(kst(kc) + L.k_pl);
        const size_t ps = (size_t)cs * D;
        const bool bad_k = warp_fold_bad<T>(ks, ldk, pl, pl + ps, cs, PD_BS, D,
                                            P.kv_thr, lane);
        const bool bad_v = warp_fold_bad<T>(vs, ldk, pl + 2 * ps, pl + 3 * ps,
                                            cs, PD_BS, D, P.kv_thr, lane);
        const bool flag = (bad_k || bad_v) && bts[j] > 0;
        if (lane == 0) {
          det[5] += flag;
          P.bad[(size_t)bh * mb + j] = flag;
        }
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
          // the fold check, lp lanes a (row, residue) pair (a power of two:
          // 8 at one row, 1 from 5 rows; in f32 1): Q fold(K)^T with the
          // folds formed in segment order, each lane a share of D, summed
          // over the pair's lanes; the folded scores in segment order (as
          // the plain version sums them: a struck score moves by d1);
          // locate and correct
          int lp = 1;
          if constexpr (BF)
            while (lp < 8 && nr * PD_SKV * lp * 2 <= 32) lp <<= 1;
          for (int p0 = 0; p0 < nr * PD_SKV; p0 += 32 / lp) {
            const int p = p0 + lane / lp, sub = lane & (lp - 1);
            const bool valid = p < nr * PD_SKV;
            const int r = valid ? p / PD_SKV : 0, i = p & (PD_SKV - 1);
            float a1 = 0.f, a2 = 0.f;
            if constexpr (BF) {
              // 8 columns a step, 16-byte loads
              for (int d = sub * 8; valid && d < D; d += lp * 8) {
                float qv[8], x[PD_GKV][8];
                load_row<T, 8>(qv, qs + r * ldk + d);
#pragma unroll
                for (int l = 0; l < PD_GKV; ++l)
                  load_row<T, 8>(x[l], ks + (l * PD_SKV + i) * ldk + d);
#pragma unroll
                for (int m = 0; m < 8; ++m) {
                  float f1 = 0.f, f2 = 0.f;
#pragma unroll
                  for (int l = 0; l < PD_GKV; ++l) {
                    f1 = f1 + x[l][m];
                    f2 = f2 + (float)(l + 1) * x[l][m];
                  }
                  a1 = fmaf(qv[m], f1, a1);
                  a2 = fmaf(qv[m], f2, a2);
                }
              }
              for (int o = lp >> 1; o > 0; o >>= 1) {
                a1 = a1 + __shfl_xor_sync(FULL, a1, o);
                a2 = a2 + __shfl_xor_sync(FULL, a2, o);
              }
            } else if (valid) {
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
            }
            if (!valid || sub != 0) continue;
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
            const bool mk = col <= qpos && qpos - col < window && q_len > 0;
            bm = nan_max(bm, mk ? sS[r * PD_LDS + l * PD_SKV + i] : MASK_VALUE);
          }
          for (int o = PD_SKV >> 1; o > 0; o >>= 1)
            bm = nan_max(bm, __shfl_xor_sync(FULL, bm, o));
          if (valid && i == 0) row[r * PD_RN + PD_BM] = bm;
        }
      }
    }
    PHASE_MARK(2)
    __syncthreads();  // the K stages are free for the next step
  }
  PHASE_MARK(2)
  cluster_sync();  // every block max of the unit is in
  PHASE_MARK(3)

  // ---- exchange 1: the running max through blocks 0 .. n_end - 1, a warp
  //      a row, a lane a block ----
  if (nmine > 0) {
    const bool mflip = f_grp && f_site == S_ROWMAX && f_blk >= j_lo &&
                       f_blk - j_lo < n_run;
    for (int r = w; r < nr; r += PD_WARPS) {
      float m = MASK_VALUE;
      for (int c0 = 0; c0 < n_end; c0 += 32) {
        const int n = c0 + lane;
        float bm = -INFINITY;
        if (n < n_end) {
          const int o = n / per, k = n - o * per;
          bm = at_rank((const float*)(slot(k) + L.s_row), o)[r * PD_RN + PD_BM];
        }
        float x = bm;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(FULL, x, o);
          if (lane >= o) x = nan_max(y, x);
        }
        float v = nan_max(m, x);
        const int fl = mflip && r == fr ? f_blk - j_lo - c0 : -1;
        bool badf = false;
        if (fl >= 0 && fl < 32 && fl < n_end - c0) {
          // the SEU as the sequential step applies it: the step's m
          // flipped, against the shadow max (the unflipped value), put back
          // in correct mode; every later block's max from the struck value
          const float a = __shfl_sync(FULL, v, fl);
          float mn = flip_bit(a, f_bit);
          if (ft && P.shadow_rowmax) {
            badf = mn != opaque(a);
            if (correct && badf) mn = a;
          }
          float x2 = lane > fl ? bm : -INFINITY;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const float y = __shfl_up_sync(FULL, x2, o);
            if (lane >= o) x2 = nan_max(y, x2);
          }
          if (lane == fl) v = mn;
          if (lane > fl) v = nan_max(mn, x2);
        }
        float vp = __shfl_up_sync(FULL, v, 1);
        if (lane == 0) vp = m;
        if (n >= n0 && n < n_end) {
          // the shadow max, a block at a time: it differs from m where the
          // SEU struck, or (detect mode) wherever m carries a NaN
          if (ft && P.shadow_rowmax) det[2] += lane == fl ? badf : isnan(v);
          const bool alive = v > MASK_HALF;
          float* rw = (float*)(slot(n - n0) + L.s_row) + r * PD_RN;
          rw[PD_MS] = alive ? v : 0.f;
          *to_rank(gat + owned(r, n) * 4, r % PD_CTAS) =
              alive ? expf(vp - v) : 1.f;
        }
        m = __shfl_sync(FULL, v, 31);
      }
    }
  }
  __syncthreads();
  PHASE_MARK(4)

  // ---- phase B: the span's blocks, a warp a block ----
  float* vc1 = (float*)(smem + L.kring) + (size_t)w * 2 * PD_BS * sout;
  float* vc2 = vc1 + PD_BS * sout;
  float vm = 0.f;  // this thread's share of max|V| (read by the clamp)
  for (int k = w; k < nmine; k += PD_WARPS) {
    const int j = j_lo + n0 + k, kv_start = j * PD_BS;
    unsigned char* sl = slot(k);
    const T* vs = (const T*)(sl + L.s_v);
    float* sS = (float*)(sl + L.s_s);
    const float* sc1 = (const float*)(sl + L.s_sc1);
    const float* row = (const float*)(sl + L.s_row);
    const int n = n0 + k;  // the block's index among the running ones
    const bool hit = f_grp && f_blk == j && f_site == S_EXP;
    // EXP with checksum reuse (paper Case 2), backstop, mask, rowsum
    // (+ shadow); p is written over s
    for (int p0 = 0; p0 < nr * PD_SKV; p0 += 32) {
      const int p = p0 + lane;
      const bool valid = p < nr * PD_SKV;
      const int r = valid ? p / PD_SKV : 0, i = p & (PD_SKV - 1);
      const float ms = row[r * PD_RN + PD_MS];
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
        const bool bad = col_ok && (fabsf(prod - pc1) > P.eps2 * ref + 1e-20f);
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
        const bool mk = col <= qpos && qpos - col < window && q_len > 0;
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
        const float bm = row[r * PD_RN + PD_BM];
        float* g = to_rank(gat + owned(r, n) * 4, r % PD_CTAS);
        g[1] = ps;
        g[2] = ps2;
        g[3] = bm > MASK_HALF ? expf(bm - ms) : 0.f;
      }
    }
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
    __syncwarp();
    // GEMM II of the block (f32 accumulate, from zero)
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
        ldmatrix_x4_trans(bb, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldk +
                                  np * 16 + (lane >> 4) * 8);
        float pv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        mma_bf16(pv[0], a, bb);
        mma_bf16(pv[1], a, bb + 2);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int r = gq + h2 * 8;
            if (r < nr)
              *to_rank((float2*)(fpv + owned(r, n) * ldo + np * 16 + nt * 8 +
                                 2 * t4),
                       r % PD_CTAS) =
                  make_float2(pv[nt][2 * h2], pv[nt][2 * h2 + 1]);
          }
      }
    } else {
      for (int e = lane; e < nr * D; e += 32) {
        const int r = e / D, col = e - r * D;
        float a = 0.f;
#pragma unroll 4
        for (int c = 0; c < PD_BS; ++c)
          a = fmaf(round_to<T>(sS[r * PD_LDS + c]), to_f(vs[c * ldk + col]), a);
        *to_rank(fpv + owned(r, n) * ldo + col, r % PD_CTAS) = a;
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
        float* o = to_rank(focb + owned(r, n) * 2 * sout, r % PD_CTAS);
        o[i] = a1;
        o[sout + i] = a2;
      }
    }
    __syncwarp();  // vc1 / vc2 are the next block's
  }
  // this CTA's max|V|, stored into every CTA's vmx[rank]
  for (int o = 16; o > 0; o >>= 1) vm = nan_max(vm, __shfl_xor_sync(FULL, vm, o));
  if (lane == 0) red[w] = __float_as_int(vm);
  __syncthreads();
  if (tid < PD_CTAS) {
    float v = 0.f;
    for (int i = 0; i < PD_WARPS; ++i) v = nan_max(v, __int_as_float(red[i]));
    *to_rank(vmx + rank, tid) = v;
  }
  PHASE_MARK(5)
  cluster_sync();  // every block's partials are in
  PHASE_MARK(6)

  // ---- exchange 2: the owned rows' running state, in block order, from
  //      what their blocks stored here ----
  const int n_own = rank < (unsigned)nr ? (nr - 1 - (int)rank) / PD_CTAS + 1 : 0;
  float* facc = (float*)(smem + L.fin);
  float* foc1 = facc + (size_t)L.ro * ldo;
  float* foc2 = foc1 + L.ro * sout;
  float* fl_s = foc2 + L.ro * sout;       // l
  float* flsh_s = fl_s + L.ro;            // shadow l
  float* fr_s = flsh_s + L.ro;            // SNVR tracker r
  float* fls_s = fr_s + L.ro;             // safe l
  float vmax = 0.f;
  for (int o = 0; o < PD_CTAS; ++o) vmax = nan_max(vmax, vmx[o]);
  {
    // a thread an element of the owned rows' state
    const int items = D + sout + 1;
    for (int e = tid; e < n_own * items; e += PD_THREADS) {
      const int t = e / items, it = e - t * items;
      const int r = (int)rank + PD_CTAS * t;
      const float4* g4 = (const float4*)(gat + (size_t)t * nb_all * 4);
      const bool fr_row = f_grp && r == fr;
      if (it < D) {
        const int d = it;
        const float* pv = fpv + (size_t)t * nb_all * ldo + d;
        float an = 0.f;
#pragma unroll 4
        for (int n = 0; n < n_run; ++n) {
          an = g4[n].x * an + pv[(size_t)n * ldo];
          if (fr_row && f_site == S_GEMM2 && f_blk == j_lo + n && d == f_col)
            an = flip_bit(an, f_bit);
        }
        facc[t * ldo + d] = an;
      } else if (it < D + sout) {
        const int i = it - D;
        const float* ob = focb + (size_t)t * nb_all * 2 * sout + i;
        float o1 = 0.f, o2 = 0.f;
        if (ft)
#pragma unroll 4
          for (int n = 0; n < n_run; ++n) {
            const float a = g4[n].x;
            o1 = a * o1 + ob[(size_t)n * 2 * sout];
            o2 = a * o2 + ob[(size_t)n * 2 * sout + sout];
          }
        foc1[t * sout + i] = o1;
        foc2[t * sout + i] = o2;
      } else {
        float l = 0.f, lsh = 0.f, rr = 0.f;
        for (int n = 0; n < n_run; ++n) {
          const float4 g = g4[n];
          float ln = g.x * l + g.y;
          if (fr_row && f_site == S_ROWSUM && f_blk == j_lo + n)
            ln = flip_bit(ln, f_bit);
          l = ln;
          if (ft && P.shadow_rowsum) lsh = g.x * lsh + g.z;
          rr = g.x * rr + g.w;
        }
        fl_s[t] = l;
        flsh_s[t] = lsh;
        fr_s[t] = rr;
      }
    }
  }
  __syncthreads();
  PHASE_MARK(7)

  // ---- finalize the owned rows: SNVR on l + unified output verification
  for (int t = tid; t < n_own; t += PD_THREADS) {
    float lf = fl_s[t];
    if (ft) {
      const float rf = fr_s[t];
      const float upper = (float)min(qpos + 1, kv_len) + 1e-3f;
      const bool in_range = lf >= rf - 1e-3f && lf <= upper && isfinite(lf);
      bool bad;
      float fallback;
      if (P.shadow_rowsum) {
        const float lsh = flsh_s[t];
        const bool mism = fabsf(lf - lsh) > 1e-5f * nan_max(fabsf(lsh), 1e-6f);
        bad = (!in_range || mism) && rf > 0.f;
        const bool fb_ok = lsh >= rf - 1e-3f && lsh <= upper && isfinite(lsh);
        fallback = fb_ok ? lsh : rf;
      } else {
        bad = !in_range && rf > 0.f;
        fallback = rf;
      }
      det[3] += bad;
      if (correct && bad) lf = fallback;
    }
    fls_s[t] = lf == 0.f ? 1.f : lf;
  }
  __syncthreads();
  const float bound = vmax * 1.001f + 1e-6f;
  for (int e = tid; e < n_own * D; e += PD_THREADS) {
    const int t = e / D, d = e - t * D;
    float o = facc[t * ldo + d] / fls_s[t];
    if (ft && correct) o = (isfinite(o) && fabsf(o) <= bound) ? o : 0.f;
    facc[t * ldo + d] = o;
  }
  __syncthreads();
  if (ft)
    for (int p = tid; p < n_own * sout; p += PD_THREADS) {
      const int t = p / sout, i = p - t * sout;
      float s1 = 0.f, s2 = 0.f;
      for (int q = 0; q < g_out; ++q) {
        const float x = facc[t * ldo + q * sout + i];
        s1 = s1 + x;
        s2 = s2 + (float)(q + 1) * x;
      }
      const float ls = fls_s[t];
      const float d1 = foc1[p] / ls - s1;
      const float d2 = foc2[p] / ls - s2;
      const bool bad = !(fabsf(d1) <= P.eps3);
      det[4] += bad;
      if (correct && bad) facc[t * ldo + seg_of(d1, d2, g_out) * sout + i] += d1;
    }
  __syncthreads();
  T* og = (T*)P.out + ((size_t)bh * R + row0) * D;
  for (int e = tid; e < n_own * D; e += PD_THREADS) {
    const int t = e / D, d = e - t * D;
    og[((int)rank + PD_CTAS * t) * D + d] = from_f<T>(facc[t * ldo + d]);
  }

  // ---- the CTA's partial counts: warps in order, no atomics ----
  for (int k = 0; k < 6; ++k) {
    int v = det[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    det[k] = v;
  }
  __syncthreads();  // red's max|V| words are read
  if (lane == 0)
    for (int k = 0; k < 6; ++k) red[w * 8 + k] = det[k];
  __syncthreads();
  if (tid < 6) {
    int tot = 0;
    for (int i = 0; i < PD_WARPS; ++i) tot += red[i * 8 + tid];
    P.rep[((size_t)u * PD_CTAS + rank) * 6 + tid] = tot;
  }
  PHASE_MARK(8)
  PHASE_FLUSH
}
