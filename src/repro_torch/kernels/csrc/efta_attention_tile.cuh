// Kernel B2's tile layout, for the narrow path's prefill regimes in bf16
// (the design note is at the head of efta_attention.cu). Included by
// efta_attention.cu inside its anonymous namespace, after Params, WPG, the
// fault-descriptor indices and efta_hopper.cuh.
//
// Two kernels a launch. The fold pass (efta_attention_kernel_fold) reads
// each (KV head, KV block) of K and V once and writes what depends on them
// alone to a scratch tensor that the wrapper allocates: the two K-fold
// planes, the V column checksums (as bf16 high and low parts, the B
// operand of the O-checksum products) and max|V|. The tile kernel
// (efta_attention_kernel_tile) then runs a tile of 64 query rows against
// every KV block the tile sees, one CTA a tile: 16 consumer warps (four
// warpgroups) and a producer warpgroup that streams the K and V chunks,
// with each V chunk's checksum rows, through a ring of mbarriers.

// 16-row groups a CTA: one 64-row wgmma tile
constexpr int TL_GROUPS = 4;
// GEMM II n-tiles of 8 columns a warpgroup at most (D <= 128), and GEMM I's
// (chunks of up to 128 keys)
constexpr int TL_NT = 4, TL_KT = 4;
// the least scores of a query tile's KV block (block_q x block_kv) the
// layout takes: at 64 x 64 the fold pass and a CTA's fixed costs outweigh
// what it saves
constexpr int TL_MIN_SCORES = 8192;
// the fold pass's threads a block, one V checksum entry a thread
constexpr int TL_FOLD_THREADS = 256;

// the fold pass's output for one (KV head, KV block), offsets in floats:
// the K-fold planes [2][s_kv][D] (f32), the V column checksums [block_kv]
// [ldc] as bf16 high parts, then as low parts (both checksums' 2 s_out
// columns, padded to the n-tile, + 8), and max|V| of each of the `splits`
// thread blocks that share the (KV head, KV block) (padded to 16 bytes)
struct TFold {
  int ldc, vc, vmax, floats, splits;
};

TFold make_fold(int D, int Bc, int skv, int sout) {
  TFold F;
  F.ldc = ((2 * sout + 7) & ~7) + 8;
  F.splits = (Bc * F.ldc + TL_FOLD_THREADS - 1) / TL_FOLD_THREADS;
  F.vc = 2 * skv * D;
  F.vmax = F.vc + Bc * F.ldc;  // Bc x ldc bf16 pairs
  F.floats = F.vmax + ((F.splits + 3) & ~3);
  return F;
}

// shared-memory layout of one CTA of the tile layout (byte offsets)
struct TLayout {
  int lds;  // score row stride, floats
  int ldo;  // the output's row stride at the finalize, floats
  int ldf;  // K-fold row stride, floats
  size_t slot;  // one ring slot: a chunk of KC keys and its checksum rows
  size_t ring, qs, kf, sp, sc1, oc, row, red, bar, total;
};

// KC keys a streamed chunk, ST ring stages
TLayout make_tile_layout(int KC, int ST, int D, int Bc, int skv, int sout) {
  TLayout L;
  const int TR = 16 * TL_GROUPS;
  const TFold F = make_fold(D, Bc, skv, sout);
  L.lds = (Bc + (skv < 32 ? skv : 0) + 3) & ~3;  // float4 reads of p
  L.ldo = D + 1;
  L.ldf = D + 4;
  L.slot = (size_t)KC * D * 2 + (size_t)KC * F.ldc * 4;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) & ~(size_t)15;
    return o;
  };
  const size_t sc = (size_t)TR * L.lds, fin = (size_t)TR * L.ldo;
  L.ring = take(ST * L.slot);
  L.qs = take((size_t)TR * D * 2);
  L.kf = take(2 * (size_t)skv * L.ldf * 4);
  // the scores, then p; at the end the output rows
  L.sp = take(4 * (sc > fin ? sc : fin));
  // GEMM I's checksum products Q fold(K)^T, both folds
  L.sc1 = take(2 * (size_t)TR * skv * 4);
  L.oc = take(2 * (size_t)TR * sout * 4);
  // m, l, shadow l, r, m or 0, alpha, block max, safe l; max|V|
  L.row = take((8 * (size_t)TR + 4) * 4);
  L.red = take((size_t)TL_GROUPS * WPG * 8 * 4);
  L.bar = take(2 * (size_t)ST * 8);
  L.total = off;
  return L;
}

struct TParams {
  Params P;  // P.ws: the fold pass's output; P.L and P.S are unused
  TLayout L;
  TFold F;
};

// a 16-row group's four warps (named barriers 2 .. 5; 1 is consumer_sync)
__device__ __forceinline__ void group_sync(int rg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(2 + rg), "r"(32 * WPG) : "memory");
}

// grid (n_kv splits, B Hkv): `splits` blocks of TL_FOLD_THREADS a (KV
// block, KV head), each a share of its K-fold entries and of its V
// checksum entries (one V entry a thread): every entry is a chain of
// dependent loads and adds, so the pass is latency-bound and wants many
// threads. Sums in segment order, as the plain version and the
// narrow layout: the K folds f1 = sum_l K[l s_kv + i], f2 = sum_l (l + 1)
// K[l s_kv + i]; the V column checksums likewise over the columns l s_out
// + i of a key.
__global__ void __launch_bounds__(TL_FOLD_THREADS)
    efta_attention_kernel_fold(const TParams C) {
  using T = __nv_bfloat16;
  const Params& P = C.P;
  const TFold& F = C.F;
  const int sp = blockIdx.x % F.splits, j = blockIdx.x / F.splits,
            kvh = blockIdx.y;
  const int D = P.D, Bc = P.block_kv, skv = P.s_kv, sout = P.s_out,
            ldc = F.ldc;
  const int g_kv = Bc / skv, g_out = D / sout;
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t base = ((size_t)kvh * P.Skv + (size_t)j * Bc) * D;
  const T* kb = (const T*)P.k + base;
  const T* vb = (const T*)P.v + base;
  float* out = P.ws + ((size_t)kvh * P.n_kv + j) * F.floats;
  const Div dD(D), dldc(ldc);
  const int nk = (skv * D + F.splits - 1) / F.splits,
            nv = (Bc * ldc + F.splits - 1) / F.splits;
  for (int e = sp * nk + tid; e < min(skv * D, (sp + 1) * nk);
       e += TL_FOLD_THREADS) {
    const int i = dD.q(e), d = e - i * D;
    float f1 = 0.f, f2 = 0.f;
#pragma unroll 8
    for (int l = 0; l < g_kv; ++l) {
      const float x = to_f(kb[(size_t)(l * skv + i) * D + d]);
      f1 = f1 + x;
      f2 = f2 + (float)(l + 1) * x;
    }
    out[e] = f1;
    out[skv * D + e] = f2;
  }
  T* vch = (T*)(out + F.vc);
  T* vcl = vch + (size_t)Bc * ldc;
  float vm = 0.f;
  for (int e = sp * nv + tid; e < min(Bc * ldc, (sp + 1) * nv);
       e += TL_FOLD_THREADS) {
    const int c = dldc.q(e), col = e - c * ldc;
    float val = 0.f;
    if (col < 2 * sout) {
      const int i = col < sout ? col : col - sout;
      float f1 = 0.f, f2 = 0.f;
#pragma unroll 8
      for (int l = 0; l < g_out; ++l) {
        const float x = to_f(vb[(size_t)c * D + l * sout + i]);
        f1 = f1 + x;
        f2 = f2 + (float)(l + 1) * x;
        vm = nan_max(vm, fabsf(x));
      }
      val = col < sout ? f1 : f2;
    }
    const T hi = __float2bfloat16(val);
    vch[e] = hi;
    vcl[e] = __float2bfloat16(val - __bfloat162float(hi));
  }
  __shared__ float red[TL_FOLD_THREADS / 32];
  for (int o = 16; o > 0; o >>= 1)
    vm = nan_max(vm, __shfl_xor_sync(FULL, vm, o));
  if (lane == 0) red[tid >> 5] = vm;
  __syncthreads();
  if (tid == 0) {
    float v = red[0];
    for (int i = 1; i < TL_FOLD_THREADS / 32; ++i) v = nan_max(v, red[i]);
    out[F.vmax + sp] = v;
  }
}

// grid: one CTA for each (bh, tile) pair, the last tiles (causal: the
// longest) first.
__global__ void __launch_bounds__(32 * WPG * TL_GROUPS + PRODUCER_THREADS, 1)
    efta_attention_kernel_tile(const TParams C) {
  using T = __nv_bfloat16;
  const Params& P = C.P;
  const TLayout& L = C.L;
  const TFold& F = C.F;
  constexpr int RPW = 16 / WPG;  // rows per warp in the row phases
  constexpr int TR = 16 * TL_GROUPS;
  constexpr int NT = 32 * WPG * TL_GROUPS;  // the consumer threads
  PHASE_INIT
  const int n_t = P.n_q * P.n_sub;
  const int bh = blockIdx.x % P.BH, tile = n_t - 1 - blockIdx.x / P.BH;
  const int iq = tile / P.n_sub, sub = tile - iq * P.n_sub;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int KC = P.KC, ST = P.ST, D = P.D, Bc = P.block_kv, skv = P.s_kv,
            sout = P.s_out;
  const int lds = L.lds, ldo = L.ldo, ldf = L.ldf, ldc = F.ldc;
  const int q_start = iq * P.block_q;  // the reference tile's first row
  const int r0 = q_start + sub * TR;   // this CTA's first row
  const int nrows = min(TR, P.block_q - sub * TR);
  // warp w = (warpgroup rg, warp wk of it). Row phases: the 16 rows of
  // group rg, RPW a warp. wgmma: rows 16 wk .. of the tile, warpgroup rg's
  // part of the columns.
  const int rg = w / WPG, wk = w - rg * WPG;
  const int gr0 = 16 * rg;
  const bool gact = nrows > gr0;
  const int wr = RPW * wk;
  const int nrw = max(0, min(RPW, nrows - gr0 - wr));
  const bool wact = nrw > 0;
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const int g_kv = Bc / skv, g_out = D / sout;
  const int nc = Bc / KC;
  // GEMM II: warpgroup rg's n-tiles nt2 (of D / 8, split as evenly as they
  // go) from column col2
  const int ntd = D / 8, ntb = ntd / 4, ntr = ntd - 4 * ntb;
  const int nt2 = ntb + (rg < ntr ? 1 : 0);
  const int col2 = 8 * (rg * ntb + min(rg, ntr));
  // the O-checksum products: n-tile rg of the 2 s_out checksum columns,
  // rows 16 wk ..
  const int ncol = (2 * sout + 7) & ~7, nct = ncol / 8;
  const bool och = ft && rg < nct && nrows > 16 * wk;
  const float MASK_VALUE = (float)MASK_D;
  const float MASK_HALF = (float)(MASK_D / 2);
  const int g = lane >> 2, t4 = lane & 3;
  const FDiv dD(D), dskv(skv), dsout(sout), dper(D / 8);
  // lane pairs of the row phases: (row r < RPW, residue i < s_kv)
  const int npr = RPW * skv, npr32 = (npr + 31) & ~31;
  // the SEU: its row in the tile, in the group
  const int f_row = P.fault[F_ROW] - r0;
  const bool f_blk = P.fault[F_ON] == 1 && P.fault[F_BH] == bh &&
                     f_row >= 0 && f_row < nrows;
  const int fg = f_row - gr0;
  const bool f_grp = f_blk && fg >= 0 && fg < 16;
  const int f_site = P.fault[F_SITE], f_col = P.fault[F_COL],
            f_bit = P.fault[F_BIT];

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = (T*)(smem + L.qs);
  float* kf1 = (float*)(smem + L.kf);
  float* kf2 = kf1 + skv * ldf;
  float* sp0 = (float*)(smem + L.sp);  // by tile row
  float* sp = sp0 + gr0 * lds;
  float* sc1 = (float*)(smem + L.sc1) + gr0 * skv;
  float* sc2 = sc1 + TR * skv;
  float* oc1 = (float*)(smem + L.oc);  // by tile row
  float* oc2 = oc1 + TR * sout;
  float* row0 = (float*)(smem + L.row);
  float* m_s = row0 + gr0;
  float* l_s = m_s + TR;
  float* lsh_s = l_s + TR;
  float* r_s = lsh_s + TR;
  float* msub_s = r_s + TR;
  float* alpha_s = msub_s + TR;
  float* bmax_s = alpha_s + TR;
  float* red = (float*)(smem + L.red);
  uint64_t* full = (uint64_t*)(smem + L.bar);  // a ring slot has landed
  uint64_t* empty = full + ST;                 // every warp is done with it

  const T* qg = (const T*)P.q + ((size_t)bh * P.Sq + r0) * D;
  const size_t kvh = (size_t)(bh / P.grp);
  const T* kg = (const T*)P.k + kvh * P.Skv * D;
  const T* vg = (const T*)P.v + kvh * P.Skv * D;
  const float* fold = P.ws + kvh * P.n_kv * (size_t)F.floats;
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, PRODUCER_THREADS);
      mbar_init(empty + s, NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the ring's mbarriers are ready

  // the KV blocks the tile runs, decided for the whole reference tile:
  // kv_len, the window and the causal mask each bound them from one side,
  // so they are j_lo .. j_hi
  int j_lo = P.n_kv, j_hi = -1;
  for (int j = 0; j < P.n_kv; ++j) {
    const int kv_start = j * Bc;
    bool run = kv_start < P.kv_len &&
               q_start - (kv_start + Bc - 1) < P.window;
    if (P.causal) run = run && kv_start <= q_start + P.block_q - 1;
    if (run) {
      j_lo = min(j_lo, j);
      j_hi = j;
    }
  }
  // ---- one load stream over those blocks: for each, its K chunks, then
  //      its V chunks with their checksum rows, through a ring of ST slots
  //      with two mbarriers each. The producer warpgroup issues the copies
  //      (cp.async); a slot's `full` mbarrier completes when they have
  //      landed, and its `empty` one when every consumer warp is done with
  //      the chunk, and only then is the slot refilled ----
  const int nb = max(0, j_hi - j_lo + 1), nload = 2 * nc * nb;
  if (tid >= NT) {
    producer_regs();
    const int t0 = tid - NT, per = D / 8, npc = KC * ldc / 8;
    for (int idx = 0; idx < nload; ++idx) {
      const int slot = idx % ST;
      if (idx >= ST) mbar_wait(empty + slot, (idx / ST + 1) & 1);
      const int jb = idx / (2 * nc), li = idx - jb * 2 * nc;
      const bool isv = li >= nc;
      const int ck = isv ? li - nc : li, j = j_lo + jb;
      const T* src = (isv ? vg : kg) + ((size_t)j * Bc + ck * KC) * D;
      T* dst = (T*)(smem + L.ring + slot * L.slot);
      // 16-byte pieces, eight neighbouring threads on one core matrix
      for (int e = t0; e < KC * per; e += PRODUCER_THREADS) {
        const int rest = e >> 3, cg = dper.q(rest);
        const int c = cg * 8 + (e & 7), p8 = rest - cg * per;
        cp_async16(dst + cm(c, p8 * 8, D), src + (size_t)c * D + p8 * 8);
      }
      if (isv && ft) {
        // the chunk's rows of the V column checksums, high then low parts
        const T* vh = (const T*)(fold + (size_t)j * F.floats + F.vc) +
                      (size_t)ck * KC * ldc;
        const T* vl = vh + (size_t)Bc * ldc;
        T* dh = dst + KC * D;
        for (int e = t0; e < 2 * npc; e += PRODUCER_THREADS) {
          const bool lo = e >= npc;
          const int p = lo ? e - npc : e;
          cp_async16(dh + (lo ? KC * ldc : 0) + p * 8, (lo ? vl : vh) + p * 8);
        }
      }
      mbar_arrive_cp_async(full + slot);
    }
    return;
  }
  consumer_regs();
  // Q, and the running state, while the producer streams the first chunks
  for (int e = tid; e < TR * (D / 8); e += NT) {
    const int r = dper.q(e), d = (e - r * (D / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < nrows) x = *(const uint4*)(qg + (size_t)r * D + d);
    *(uint4*)(qs + cm(r, d, D)) = x;
  }
  for (int e = tid; e < 2 * TR * sout; e += NT) oc1[e] = 0.f;
  for (int r = tid; r < TR; r += NT) {
    row0[r] = MASK_VALUE;
    // l, lsh, r, and alpha, which rows past the tile's also read
    row0[TR + r] = row0[2 * TR + r] = row0[3 * TR + r] = 0.f;
    row0[5 * TR + r] = 1.f;
  }
  int det[5] = {0, 0, 0, 0, 0};
  fence_async_smem();  // Q is an operand of wgmma
  consumer_sync(NT);
  PHASE_MARK(0)
  // chunk idx has landed (and is visible to wgmma's async proxy)
  auto acquire = [&](int idx) -> const T* {
    mbar_wait(full + idx % ST, (idx / ST) & 1);
    fence_async_smem();
    return (const T*)(smem + L.ring + (idx % ST) * L.slot);
  };
  // this warp is done with chunk idx
  auto release = [&](int idx) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + idx % ST);
  };

  // the output accumulator of this thread: rows 16 wk + g (+ 8), columns
  // col2 + 8 k + 2 t4 (+ 1), wgmma's layout
  float acc[TL_NT * 4];
#pragma unroll
  for (int e = 0; e < TL_NT * 4; ++e) acc[e] = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int kv_start = j * Bc;
    const int g0 = (j - j_lo) * 2 * nc;  // the block's first chunk
    const bool hit = f_grp && P.fault[F_BLOCK] == j;
    const bool thit = f_blk && P.fault[F_BLOCK] == j;
    if (ft) {
      // the block's K-fold planes, in flight through the K pass
      const float* kfg = fold + (size_t)j * F.floats;
      const int per4 = D / 4;
      for (int e = tid; e < 2 * skv * per4; e += NT) {
        const int i = e / per4, d = (e - i * per4) * 4;
        cp_async16(kf1 + i * ldf + d, kfg + i * D + d);
      }
      cp_async_commit();
    }

    // ---- K pass: GEMM I + NVR clip into the scores: the tile's 64 rows x
    //      keys rg KC / 4 .. of each chunk, on wgmma, Q and the chunk
    //      straight from shared memory, K-major, 16 d a step ----
    for (int ck = 0; ck < nc; ++ck) {
      PHASE_MARK(1)
      const T* kb = acquire(g0 + ck);
      PHASE_MARK(9)
      const int c0 = ck * KC;
      float c[TL_KT * 4];
#pragma unroll
      for (int e = 0; e < TL_KT * 4; ++e) c[e] = 0.f;
      const uint64_t da = wg_desc(qs, 128, 16 * D);
      const uint64_t db = wg_desc(kb + cm(rg * (KC / 4), 0, D), 128, 16 * D);
      // nothing but the products between the fence and the wait: a branch
      // among them makes ptxas serialize them
      auto gemm1 = [&](auto nn) {
        constexpr int N = decltype(nn)::value;
        reg_fence(c, TL_KT * 4);
        wg_fence();
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss<N>(c, da + 16 * ks, db + 16 * ks);
        wg_commit_wait();
        reg_fence(c, TL_KT * 4);
      };
      if (KC == 128)
        gemm1(IC<32>());
      else if (KC == 64)
        gemm1(IC<16>());
      else
        gemm1(IC<8>());
      const bool hit1 = thit && f_site == S_GEMM1;
#pragma unroll
      for (int k = 0; k < TL_KT; ++k) {
        if (k * 32 < KC) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * wk + g + (e >> 1) * 8;
            const int col = c0 + rg * (KC / 4) + k * 8 + 2 * t4 + (e & 1);
            float sv = c[4 * k + e] * P.scale;
            if (hit1 && r == f_row && col == f_col) sv = flip_bit(sv, f_bit);
            if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
            sp0[r * lds + col] = sv;
          }
        }
      }
      release(g0 + ck);
    }
    if (ft) cp_async_wait(0);
    PHASE_MARK(1)
    consumer_sync(NT);  // every warp's scores and the K folds are in
    PHASE_MARK(8)
    if (ft) {
      // ---- the checksum products Q fold(K)^T of the group's rows on the
      //      tensor cores in TF32: Q's bf16 values are TF32 exactly,
      //      fold(K) is split into high and low TF32 parts, products are
      //      exact and summed in f32 (about f32's 2^-24) ----
      const int nci = (skv + 7) / 8;  // n-tiles of residues
      for (int it = wk; gact && it < 2 * nci; it += WPG) {
        const int which = it / nci, nt = it - which * nci;
        const float* kf = which ? kf2 : kf1;
        const int i = nt * 8 + g;  // this lane's column of B
        // rows gr0 + g and + 8 of Q: element d of a row at d / 8 * 64 +
        // d % 8 of its core-matrix row
        const unsigned short* qb =
            (const unsigned short*)(qs + cm(gr0 + g, 0, D));
        float cc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int ks = 0; ks < D / 8; ++ks) {
          const int d0 = ks * 8 + t4, q0 = ks * 64 + t4;
          const uint32_t a[4] = {(uint32_t)qb[q0] << 16,
                                 (uint32_t)qb[8 * D + q0] << 16,
                                 (uint32_t)qb[q0 + 4] << 16,
                                 (uint32_t)qb[8 * D + q0 + 4] << 16};
          const float b0 = i < skv ? kf[i * ldf + d0] : 0.f;
          const float b1 = i < skv ? kf[i * ldf + d0 + 4] : 0.f;
          const uint32_t bh[2] = {to_tf32(b0), to_tf32(b1)};
          const uint32_t bl[2] = {to_tf32(b0 - __uint_as_float(bh[0])),
                                  to_tf32(b1 - __uint_as_float(bh[1]))};
          mma_tf32(cc, a, bh);
          mma_tf32(cc, a, bl);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + (e >> 1) * 8, col = nt * 8 + 2 * t4 + (e & 1);
          if (col < skv) (which ? sc2 : sc1)[r * skv + col] = cc[e] * P.scale;
        }
      }
      group_sync(rg);  // the group's checksum products are in
    }

    PHASE_MARK(2)

    if (wact) {
      // ---- in one pass over the block: the fold of S verified against
      //      the checksum products (locate + correct), and the masked
      //      block max and running max (+ shadow); s_kv lanes a row ----
      for (int b0 = 0; b0 < npr32; b0 += 32) {
        const int p = b0 + lane;
        const bool valid = p < npr;
        const int r = wr + dskv.q(p), i = dskv.r(p);
        const int row_abs = r0 + gr0 + r;
        float* scol = sp + r * lds + i;
        // every key of the block visible to this row: no mask to compute
        const bool whole = kv_start + Bc <= P.kv_len &&
                           (!P.causal || kv_start + Bc - 1 <= row_abs) &&
                           row_abs - kv_start < P.window;
        auto visible = [&](int l) {
          const int col = kv_start + l * skv + i;
          return col < P.kv_len && (!P.causal || col <= row_abs) &&
                 row_abs - col < P.window;
        };
        float bm = MASK_VALUE;
        if (valid) {
          float sum1 = 0.f, sum2 = 0.f;
          if (whole) {
#pragma unroll 8
            for (int l = 0; l < g_kv; ++l) {
              const float x = scol[l * skv];
              sum1 = sum1 + x;
              sum2 = sum2 + (float)(l + 1) * x;
              bm = fmax_nan(bm, x);
            }
          } else {
#pragma unroll 8
            for (int l = 0; l < g_kv; ++l) {
              const float x = scol[l * skv];
              sum1 = sum1 + x;
              sum2 = sum2 + (float)(l + 1) * x;
              bm = fmax_nan(bm, visible(l) ? x : MASK_VALUE);
            }
          }
          if (ft) {
            const float d1 = sc1[r * skv + i] - sum1;
            const float d2 = sc2[r * skv + i] - sum2;
            const bool bad = fabsf(d1) > P.eps1;
            if (r - wr < nrw) det[0] += bad;
            if (correct && bad) {
              scol[seg_of(d1, d2, g_kv) * skv] += d1;
              // the max of the corrected column
              bm = MASK_VALUE;
              for (int l = 0; l < g_kv; ++l)
                bm = fmax_nan(bm, visible(l) ? scol[l * skv] : MASK_VALUE);
            }
          }
        }
        for (int o = skv >> 1; o > 0; o >>= 1)
          bm = fmax_nan(bm, __shfl_xor_sync(FULL, bm, o));
        if (valid && i == 0) {
          const float mp = m_s[r];
          float mn = fmax_nan(mp, bm);
          if (hit && f_site == S_ROWMAX && r == fg) mn = flip_bit(mn, f_bit);
          if (ft && P.shadow_rowmax) {
            const float mc = fmax_nan(opaque(mp), bm);
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
      PHASE_MARK(3)

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
          float pr[MAX_G];  // L1-cached local memory: fewer live registers
          float prod = 1.f;
          bool col_ok = true;
#pragma unroll 4
          for (int l = 0; l < g_kv; ++l) {
            const float sv = srow[l * skv];
            float x = expf(min_cap(sv - ms, P.cap));
            if (hit && f_site == S_EXP && r == fg && l * skv + i == f_col)
              x = flip_bit(x, f_bit);
            pr[l] = x;
            prod = prod * x;
            col_ok = col_ok && !((sv - ms) > P.cap_m);
          }
          if (ft) {
            const float pc1 =
                expf(min_cap(sc1[r * skv + i] - (float)g_kv * ms, P.cap_g));
            const float ref = fmax_nan(fabsf(pc1), 1e-20f);
            const bool bad =
                col_ok && (fabsf(prod - pc1) > P.eps2 * ref + 1e-20f);
            if (r - wr < nrw) det[1] += bad;
            if (correct && bad) {
#pragma unroll 4
              for (int l = 0; l < g_kv; ++l)
                pr[l] = expf(min_cap(srow[l * skv] - ms, P.cap));
            }
          }
          const bool whole = kv_start + Bc <= P.kv_len &&
                             (!P.causal || kv_start + Bc - 1 <= row_abs) &&
                             row_abs - kv_start < P.window;
#pragma unroll 4
          for (int l = 0; l < g_kv; ++l) {
            float x = pr[l];
            const float sv = srow[l * skv];
            if (ft && P.shadow_rowmax && correct) {
              // exact recompute backstop
              const float rc = expf(min_cap(sv - ms, P.cap));
              const bool slipped = x != rc;
              if (r - wr < nrw) det[1] += slipped;
              if (slipped) x = rc;
            }
            if (!whole) {
              const int col = kv_start + l * skv + i;
              const bool mk = col < P.kv_len &&
                              (!P.causal || col <= row_abs) &&
                              row_abs - col < P.window;
              x = mk ? x : 0.f;
            }
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
    PHASE_MARK(4)
    consumer_sync(NT);  // every row's p and alpha are in
    PHASE_MARK(8)

    // ---- V pass: P V on wgmma, rows 16 wk .. x warpgroup rg's columns,
    //      p from registers, V from shared memory as it stands (N-major);
    //      the O-checksum products of n-tile rg of the checksum columns on
    //      mma.sync, p and the checksums split into bf16 high and low parts
    //      (hi hi + hi lo + lo hi: about 2^-15 of each product) ----
    float pv[TL_NT * 4];
#pragma unroll
    for (int e = 0; e < TL_NT * 4; ++e) pv[e] = 0.f;
    float oca[4] = {0.f, 0.f, 0.f, 0.f};
    const float* prow = sp0 + 16 * wk * lds;
    const int l16 = lane & 15;
    for (int ck = 0; ck < nc; ++ck) {
      PHASE_MARK(5)
      const T* vb = acquire(g0 + nc + ck);
      PHASE_MARK(10)
      const T* vch = vb + KC * D;
      const T* vcl = vch + KC * ldc;
      const int c0 = ck * KC;
      // p of rows 16 wk + g, + 8 at keys k, k + 1, k + 8, k + 9 (k = c0 +
      // 16 ks + 2 t4): f32, and as mma_bf16's a
      auto p_frag = [&](int ks, float2* x, uint32_t* a) {
        const int k = c0 + ks * 16 + 2 * t4;
        x[0] = *(const float2*)(prow + g * lds + k);
        x[1] = *(const float2*)(prow + (g + 8) * lds + k);
        x[2] = *(const float2*)(prow + g * lds + k + 8);
        x[3] = *(const float2*)(prow + (g + 8) * lds + k + 8);
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = pack_bf16(x[u].x, x[u].y);
      };
      // wgmma's B: V's columns col2 .., core matrices 128 bytes apart along
      // N and 16 D bytes (8 keys) along K; a loop of compile-time length
      // with nothing but p's fragments and the products (a branch or a
      // runtime trip count among them makes ptxas serialize the products)
      const uint64_t dv = wg_desc(vb + cm(0, col2, D), 16 * D, 128);
      auto gemm2 = [&](auto nn, auto kk) {
        constexpr int N = decltype(nn)::value, KS = decltype(kk)::value;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          float2 x[4];
          uint32_t a[4];
          p_frag(ks, x, a);
          wg_fence();  // a was written since the last product
          wgmma_rs<N>(pv, a, dv + 2 * D * ks);
        }
        wg_commit_wait();
        reg_fence(pv, TL_NT * 4);
      };
      auto by_n = [&](auto kk) {
        if (nt2 == 4)
          gemm2(IC<32>(), kk);
        else if (nt2 == 3)
          gemm2(IC<24>(), kk);
        else if (nt2 == 2)
          gemm2(IC<16>(), kk);
        else
          gemm2(IC<8>(), kk);
      };
      if (KC == 128)
        by_n(IC<8>());
      else if (KC == 64)
        by_n(IC<4>());
      else
        by_n(IC<2>());
      PHASE_MARK(5)
      for (int ks = 0; och && ks < KC / 16; ++ks) {
        float2 x[4];
        uint32_t a[4], al[4];
        p_frag(ks, x, a);
#pragma unroll
        for (int u = 0; u < 4; ++u) al[u] = pack_bf16_lo(x[u].x, x[u].y, a[u]);
        uint32_t bh[2], bl[2];
        ldmatrix_x2_trans(bh, vch + (ks * 16 + l16) * ldc + rg * 8);
        ldmatrix_x2_trans(bl, vcl + (ks * 16 + l16) * ldc + rg * 8);
        mma_bf16(oca, a, bh);
        mma_bf16(oca, a, bl);
        mma_bf16(oca, al, bh);
      }
      PHASE_MARK(12)
      release(g0 + nc + ck);
    }
    // ---- rescale + accumulate (the GEMM II SEU site) ----
    {
      const float* alpha_v = row0 + 5 * TR + 16 * wk;
      const bool hit2 = thit && f_site == S_GEMM2;
#pragma unroll
      for (int k = 0; k < TL_NT; ++k) {
        if (k < nt2) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + (e >> 1) * 8;
            const int col = col2 + k * 8 + 2 * t4 + (e & 1);
            float an = alpha_v[r] * acc[4 * k + e] + pv[4 * k + e];
            if (hit2 && 16 * wk + r == f_row && col == f_col)
              an = flip_bit(an, f_bit);
            acc[4 * k + e] = an;
          }
        }
      }
      if (och) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * wk + g + (e >> 1) * 8;
          const int col = rg * 8 + 2 * t4 + (e & 1);
          if (col < 2 * sout) {
            float* o = col < sout ? oc1 + r * sout + col
                                  : oc2 + r * sout + col - sout;
            *o = alpha_v[g + (e >> 1) * 8] * *o + oca[e];
          }
        }
      }
    }
    PHASE_MARK(5)
    consumer_sync(NT);  // every warp is done with this block's p and alpha
    PHASE_MARK(6)
  }

  // ---- finalize: the output rows into shared memory (over the scores),
  //      SNVR on l, unified output verification ----
  float* fo = sp0;
#pragma unroll
  for (int k = 0; k < TL_NT; ++k) {
    if (k < nt2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * wk + g + (e >> 1) * 8;
        fo[r * ldo + col2 + k * 8 + 2 * t4 + (e & 1)] = acc[4 * k + e];
      }
    }
  }
  float* lb = row0 + TR;         // l by tile row
  float* lsafe = row0 + 7 * TR;  // by tile row
  float* vmax_s = row0 + 8 * TR;
  if (tid == 0) {
    // the running max|V| of the blocks the tile ran (only ever read by the
    // clamp)
    float v = 0.f;
    if (ft)
      for (int j = j_lo; j <= j_hi; ++j)
        for (int i = 0; i < F.splits; ++i)
          v = fmax_nan(v, fold[(size_t)j * F.floats + F.vmax + i]);
    *vmax_s = v;
  }
  for (int r = tid; r < TR; r += NT) {
    float lf = lb[r];
    if (ft) {
      const float rf = row0[3 * TR + r];
      const bool in_range =
          lf >= rf - 1e-3f && lf <= P.upper && isfinite(lf);
      bool bad;
      float fallback;
      if (P.shadow_rowsum) {
        const float lsh = row0[2 * TR + r];
        const bool mism =
            fabsf(lf - lsh) > 1e-5f * fmax_nan(fabsf(lsh), 1e-6f);
        bad = (!in_range || mism) && rf > 0.f;
        const bool fb_ok =
            lsh >= rf - 1e-3f && lsh <= P.upper && isfinite(lsh);
        fallback = fb_ok ? lsh : rf;
      } else {
        bad = !in_range && rf > 0.f;
        fallback = rf;
      }
      if (r < nrows) det[3] += bad;
      if (correct && bad) lf = fallback;
    }
    lsafe[r] = lf == 0.f ? 1.f : lf;
  }
  PHASE_MARK(7)
  consumer_sync(NT);
  PHASE_MARK(8)
  const float bound = *vmax_s * 1.001f + 1e-6f;
  for (int e = tid; e < TR * D; e += NT) {
    const int r = dD.q(e), d = e - r * D;
    float o = fo[r * ldo + d] / lsafe[r];
    if (ft && correct) o = (isfinite(o) && fabsf(o) <= bound) ? o : 0.f;
    fo[r * ldo + d] = o;
  }
  PHASE_MARK(7)
  consumer_sync(NT);
  PHASE_MARK(8)
  if (ft) {
    for (int p = tid; p < TR * sout; p += NT) {
      const int r = dsout.q(p), i = dsout.r(p);
      const float ls = lsafe[r];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
      for (int l = 0; l < g_out; ++l) {
        const float x = fo[r * ldo + l * sout + i];
        s1 = s1 + x;
        s2 = s2 + (float)(l + 1) * x;
      }
      const float d1 = oc1[p] / ls - s1;
      const float d2 = oc2[p] / ls - s2;
      const bool bad = !(fabsf(d1) <= P.eps3);
      if (r < nrows) det[4] += bad;
      if (correct && bad) fo[r * ldo + seg_of(d1, d2, g_out) * sout + i] += d1;
    }
    PHASE_MARK(7)
    consumer_sync(NT);
    PHASE_MARK(8)
  }
  // two elements a store (D is even)
  __nv_bfloat162* og =
      (__nv_bfloat162*)((T*)P.out + ((size_t)bh * P.Sq + r0) * D);
  for (int e = tid; e < nrows * D / 2; e += NT) {
    const int r = dD.q(2 * e), d = 2 * e - r * D;
    og[e] = __floats2bfloat162_rn(fo[r * ldo + d], fo[r * ldo + d + 1]);
  }
  // ---- this CTA's counts: warps in order, no atomics ----
  int* redi = (int*)red;
  for (int k = 0; k < 5; ++k) {
    int v = det[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) redi[w * 5 + k] = v;
  }
  consumer_sync(NT);
  if (tid < 5) {
    int tot = 0;
    for (int i = 0; i < NT / 32; ++i) tot += redi[i * 5 + tid];
    P.rep[((size_t)bh * n_t + tile) * 5 + tid] = tot;
  }
  PHASE_MARK(7)
  PHASE_FLUSH
}
