// Kernel B2's cluster layout, for KV blocks past the narrow layout (the
// design note is at the head of efta_attention.cu). Included by
// efta_attention.cu inside its anonymous namespace, after Params, WPG and
// the fault-descriptor indices; its Hopper helpers (the cluster's barrier
// and distributed shared memory, wgmma, mbarriers, setmaxnreg) are
// efta_hopper.cuh's.
//
// A cluster of n thread blocks (CTAs) takes one tile of TR = 16 W query
// rows against every KV block the tile sees. CTA `rank` owns the fold
// residues i0 = rank * rc .. i0 + rc - 1 (rc = s_kv / n) with all g_kv
// segments of each: the keys l * s_kv + i0 + ii, kc = block_kv / n of them,
// kept in local order c = l * rc + ii. Its scores, the K folds, the fold
// check, locate-and-correct and the EXP product fold stay in its own shared
// memory; a row crosses CTAs at the block max, at the rowsum and at the
// final output only, through distributed shared memory.

// 16-row groups (of WPG warps) a CTA at most, and the GEMM II n-tiles
// (bf16) or 32-column strips (f32) a warp at most: D <= 256 (the kernel
// is instantiated for 4, D <= 128, and 8: fewer live registers)
constexpr int CL_GROUPS = 4;
constexpr int CL_NT = 8;
// GEMM I n-tiles of 8 keys a warp at most: chunks of up to 128 keys
constexpr int CL_KT = 4;

// shared-memory layout of one CTA of the cluster layout (byte offsets)
struct CLayout {
  int ldk;  // ring / q row stride, elements of T (bf16: core matrices)
  int lds;  // score row stride, floats
  int ldo;  // partial O row stride, floats
  int ldf;  // K-fold row stride, floats
  size_t ring, qs, kf, sp, acc, sc1, vcs, oc, row, xch, red, bar, total;
};

// W row groups, KC keys a streamed chunk, ST ring stages, n CTAs a cluster
CLayout make_cluster_layout(int W, int KC, int ST, int D, int Bc, int skv,
                            int sout, int esz, int n) {
  CLayout L;
  const int TR = 16 * W, rc = skv / n, kc = Bc / n, rpc = TR / n;
  L.ldk = esz == 2 ? D : D + 1;
  L.lds = kc + (rc < 32 ? rc : 0);
  L.lds = (L.lds + 3) & ~3;  // float4 reads of p
  L.ldo = D + 1;
  L.ldf = D + 4;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) & ~(size_t)15;
    return o;
  };
  const size_t fin = (size_t)rpc * L.ldo + 2 * (size_t)rpc * sout;
  L.ring = take((size_t)ST * KC * L.ldk * esz);
  L.qs = take((size_t)TR * L.ldk * esz);
  L.kf = take(2 * (size_t)rc * L.ldf * 4);
  // the scores, then p; at the end this CTA's rows of O and their checksums
  L.sp = take(4 * ((size_t)TR * L.lds > fin ? (size_t)TR * L.lds : fin));
  L.acc = take((size_t)TR * L.ldo * 4);
  // GEMM I's checksum products, Q fold(K)^T (bf16: both folds)
  L.sc1 = take((esz == 2 ? 2 : 1) * (size_t)TR * rc * 4);
  // the chunk's V column checksums: bf16, high and low parts, [key][2 sout
  // columns padded to the n-tile, + 8]; f32, float2 [key][i]
  L.vcs = take(esz == 2 ? 2 * (size_t)KC * (((2 * sout + 7) & ~7) + 8) * 2
                        : 2 * (size_t)KC * sout * 4);
  L.oc = take(4 * (size_t)TR * sout * 4);
  L.row = take(8 * (size_t)TR * 4);
  // exchanged: partial block max, rowsum and shadow rowsum a row; max|V|
  // and the GEMM II SEU's partial value
  L.xch = take((3 * (size_t)TR + 2) * 4);
  L.red = take((size_t)W * WPG * 8 * 4);
  // the ring's mbarriers: a slot is full, a slot is free
  L.bar = take(2 * (size_t)ST * 8);
  L.total = off;
  return L;
}

struct CParams {
  Params P;  // P.L and the workspace fields are unused
  CLayout L;
  int n;  // CTAs a cluster
};

static_assert(WPG == 4, "a 16-row group's warps are one warpgroup");

// grid: n CTAs for each (bh, tile) pair, the last tiles (causal: the
// longest) first; cluster dimension (n, 1, 1). NTW: GEMM II n-tiles a warp
// at most (D <= 32 NTW).
template <typename T, int NTW>
__global__ void __launch_bounds__(32 * WPG * CL_GROUPS + PRODUCER_THREADS, 1)
    efta_attention_kernel_cluster(const CParams C) {
  const Params& P = C.P;
  const CLayout& L = C.L;
  constexpr bool BF = sizeof(T) == 2;
  constexpr int RPW = 16 / WPG;  // rows per warp in the row phases
  PHASE_INIT
  const int n = C.n;
  const unsigned rank = cluster_rank();
  const int n_t = P.n_q * P.n_sub;
  const int cid = blockIdx.x / n;
  const int bh = cid % P.BH, tile = n_t - 1 - cid / P.BH;
  const int iq = tile / P.n_sub, sub = tile - iq * P.n_sub;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int NT = blockDim.x - PRODUCER_THREADS;  // the consumer threads
  const int W = P.W, KC = P.KC, ST = P.ST, D = P.D, Bc = P.block_kv,
            skv = P.s_kv, sout = P.s_out;
  // this CTA's fold residues i0 + ii (ii < rc) and its kc keys
  const int rc = skv / n, i0 = rank * rc, kc = Bc / n;
  const int ldk = L.ldk, lds = L.lds, ldo = L.ldo, ldf = L.ldf;
  const int TR = 16 * W;
  const int q_start = iq * P.block_q;    // the reference tile's first row
  const int r0 = q_start + sub * TR;     // the cluster's first row
  const int nrows = min(TR, P.block_q - sub * TR);
  // warp w = (row group rg of 16 rows, warp wk of the group's WPG)
  const int rg = w / WPG, wk = w - rg * WPG;
  const int gr0 = 16 * rg;
  const bool gact = nrows > gr0;
  const int wr = RPW * wk;
  const int nrw = max(0, min(RPW, nrows - gr0 - wr));
  const bool wact = nrw > 0;
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const bool lead = rank == 0;  // counts the per-row events of the loop
  const int g_kv = Bc / skv, g_out = D / sout;
  const int nc = kc / KC;
  // wgmma where a tile has 64 rows (bf16): GEMM I, m64 x KC / 4 keys a
  // warpgroup; GEMM II, m64 x D / 4 columns a warpgroup at D 64, 128 and
  // 256. Warp w then holds rows 16 (w % WPG) .. of the products and part
  // w / WPG of their columns; else mma.sync, warp w on its group's rows.
  const bool wg1 = BF && W == CL_GROUPS && KC >= 32;
  const bool wg2 = BF && W == CL_GROUPS && KC >= 32 &&
                   (D == 64 || D == 128 || D == 256);
  const float MASK_VALUE = (float)MASK_D;
  const float MASK_HALF = (float)(MASK_D / 2);
  const int g = lane >> 2, t4 = lane & 3;
  const FDiv dD(D), drc(rc), dsout(sout), dper(D * (int)sizeof(T) / 16);
  // lane pairs of the row phases: (row r < RPW, residue ii < rc)
  const int npr = RPW * rc, npr32 = (npr + 31) & ~31;
  const int npo = RPW * sout;
  // the SEU: its row in the tile, in the group; a key column's SEU
  // strikes the CTA that owns the column's residue, at its local column
  const int f_row = P.fault[F_ROW] - r0;
  const bool f_blk = P.fault[F_ON] == 1 && P.fault[F_BH] == bh &&
                     f_row >= 0 && f_row < nrows;
  const int fg = f_row - gr0;
  const bool f_grp = f_blk && fg >= 0 && fg < 16;
  const int f_site = P.fault[F_SITE], f_col = P.fault[F_COL],
            f_bit = P.fault[F_BIT];
  const int f_lcol = f_col >= 0 && f_col < Bc && (f_col % skv) / rc == (int)rank
                         ? (f_col / skv) * rc + f_col % rc
                         : -1;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = (T*)(smem + L.ring);
  T* qs = (T*)(smem + L.qs);
  float* kf1 = (float*)(smem + L.kf);
  float* kf2 = kf1 + rc * ldf;
  float* sp0 = (float*)(smem + L.sp);  // by tile row
  float* sp = sp0 + gr0 * lds;
  float* acc0 = (float*)(smem + L.acc);
  float* acc = acc0 + gr0 * ldo;
  float* sc1 = (float*)(smem + L.sc1) + gr0 * rc;
  float* sc2 = sc1 + TR * rc;  // bf16
  float2* vcs = (float2*)(smem + L.vcs);  // f32: [key][i], both checksums
  // bf16: both checksums as n columns of a B operand, high and low parts
  const int ncol = (2 * sout + 7) & ~7, ldc = ncol + 8, nct = ncol / 8;
  __nv_bfloat16* vch = (__nv_bfloat16*)(smem + L.vcs);
  __nv_bfloat16* vcl = vch + KC * ldc;
  __nv_bfloat162 vmb = __floats2bfloat162_rn(0.f, 0.f);  // bf16: max|V|
  float* oc10 = (float*)(smem + L.oc);
  float* oc1 = oc10 + gr0 * sout;
  float* oc2 = oc1 + TR * sout;
  float* ocb1 = oc2 + TR * sout;
  float* ocb2 = ocb1 + TR * sout;
  float* row0 = (float*)(smem + L.row);
  float* m_s = row0 + gr0;
  float* l_s = m_s + TR;
  float* lsh_s = l_s + TR;
  float* r_s = lsh_s + TR;
  float* msub_s = r_s + TR;
  float* alpha_s = msub_s + TR;
  float* bmax_s = alpha_s + TR;
  float* xmax = (float*)(smem + L.xch);  // by tile row
  float* xsum = xmax + TR;
  float* xsum2 = xsum + TR;
  float* xone = xsum2 + TR;
  float* red = (float*)(smem + L.red);
  uint64_t* full = (uint64_t*)(smem + L.bar);  // a ring slot has landed
  uint64_t* empty = full + ST;                 // every warp is done with it

  const T* qg = (const T*)P.q + ((size_t)bh * P.Sq + r0) * D;
  const size_t kvh = (size_t)(bh / P.grp);
  const T* kg = (const T*)P.k + kvh * P.Skv * D;
  const T* vg = (const T*)P.v + kvh * P.Skv * D;
  {
    constexpr int V = 16 / sizeof(T);  // elements a 16-byte piece
    const int per = D / V;
    for (int e = tid; e < TR * per; e += NT) {
      const int r = e / per, d = (e - r * per) * V;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < nrows) x = *(const uint4*)(qg + (size_t)r * D + d);
      if constexpr (BF) {
        *(uint4*)(qs + cm(r, d, D)) = x;
      } else {
        T* dst = qs + r * ldk + d;
        dst[0] = __uint_as_float(x.x);
        dst[1] = __uint_as_float(x.y);
        dst[2] = __uint_as_float(x.z);
        dst[3] = __uint_as_float(x.w);
      }
    }
  }
  for (int e = tid; e < TR * ldo; e += NT) acc0[e] = 0.f;
  for (int e = tid; e < 2 * TR * sout; e += NT) oc10[e] = 0.f;
  for (int r = tid; r < TR; r += NT) {
    row0[r] = MASK_VALUE;
    // l, lsh, r, and alpha, which rows past the tile's also read
    row0[TR + r] = row0[2 * TR + r] = row0[3 * TR + r] = 0.f;
    row0[5 * TR + r] = 1.f;
  }
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, PRODUCER_THREADS);
      mbar_init(empty + s, NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float vm = 0.f;  // this thread's share of the running max|V|
  int det[5] = {0, 0, 0, 0, 0};
  if constexpr (BF) fence_async_smem();  // Q is an operand of wgmma
  __syncthreads();
  PHASE_MARK(0)

  // the KV blocks the tile runs, decided for the whole reference tile (so
  // for the whole cluster): kv_len, the window and the causal mask each
  // bound them from one side, so they are j_lo .. j_hi
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
  // ---- one load stream over those blocks: for each, this CTA's K chunks,
  //      then its V chunks, through a ring of ST slots with two mbarriers
  //      each. The producer warpgroup issues the copies (cp.async); a
  //      slot's `full` mbarrier completes when they have landed, and its
  //      `empty` one when every consumer warp is done with the chunk, and
  //      only then is the slot refilled. The next block's first chunks are
  //      in flight while this block's V pass runs ----
  const int nb = max(0, j_hi - j_lo + 1), nload = 2 * nc * nb;
  // chunk idx's copies (cp.async) by threads t0, t0 + stride, ...
  auto copy = [&](int idx, int t0, int stride) {
    const int slot = idx % ST;
    const int jb = idx / (2 * nc), li = idx - jb * 2 * nc;
    const int ck = li < nc ? li : li - nc;
    const T* src = (li < nc ? kg : vg) + (size_t)((j_lo + jb) * Bc + i0) * D;
    T* dst = ring + slot * KC * ldk;
    if constexpr (BF) {
      // 16-byte pieces, eight neighbouring threads on one core matrix
      const int per = D / 8;
      for (int e = t0; e < KC * per; e += stride) {
        const int rest = e >> 3, cg = dper.q(rest);
        const int c = cg * 8 + (e & 7), p8 = rest - cg * per;
        const int lc = ck * KC + c;  // local key: segment lc / rc
        const int key = drc.q(lc) * skv + drc.r(lc);
        cp_async16(dst + cm(c, p8 * 8, D), src + (size_t)key * D + p8 * 8);
      }
    } else {
      for (int e = t0; e < KC * D; e += stride) {
        const int c = dD.q(e), d = e - c * D;
        const int lc = ck * KC + c;
        const int key = drc.q(lc) * skv + drc.r(lc);
        cp_async4(dst + c * ldk + d, src + (size_t)key * D + d);
      }
    }
  };
  if (tid >= NT) {
    // the producer warpgroup, with few registers so that each consumer
    // thread has CONSUMER_REGS (setmaxnreg moves them a warpgroup at a
    // time). It takes part in every cluster barrier, in the consumers'
    // order: before it waits for a slot it passes the barriers that come
    // before the consumers free that slot (each block has two, and the
    // block of a GEMM II SEU a third after its V pass; two more end the
    // kernel), so no wait of it can hold up a barrier.
    producer_regs();
    const int fb = P.fault[F_BLOCK] - j_lo;
    const int sblk =
        f_blk && f_site == S_GEMM2 && fb >= 0 && fb < nb ? fb : nb;
    auto before = [&](int jb) { return 2 * jb + (sblk < jb ? 1 : 0); };
    int passed = 0;
    for (int idx = 0; idx < nload; ++idx) {
      const int slot = idx % ST;
      if (idx >= ST) {
        const int c = idx - ST, jb = c / (2 * nc);
        const int need = before(jb) + (c - jb * 2 * nc >= nc ? 2 : 0);
        for (; passed < need; ++passed) cluster_sync();
        mbar_wait(empty + slot, (idx / ST + 1) & 1);
      }
      copy(idx, tid - NT, PRODUCER_THREADS);
      mbar_arrive_cp_async(full + slot);
    }
    for (const int total = before(nb) + 2; passed < total; ++passed)
      cluster_sync();
    return;
  }
  consumer_regs();
  // chunk idx has landed (and is visible to wgmma's async proxy)
  auto acquire = [&](int idx) -> const T* {
    mbar_wait(full + idx % ST, (idx / ST) & 1);
    if constexpr (BF) fence_async_smem();
    return ring + (idx % ST) * KC * ldk;
  };
  // this warp is done with chunk idx
  auto release = [&](int idx) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + idx % ST);
  };

  for (int j = j_lo; j <= j_hi; ++j) {
    const int kv_start = j * Bc;
    const int g0 = (j - j_lo) * 2 * nc;  // the block's first chunk
    const bool hit = f_grp && P.fault[F_BLOCK] == j;
    const bool thit = f_blk && P.fault[F_BLOCK] == j;

    // ---- K pass: GEMM I + NVR clip into the scores, K folds ----
    for (int ck = 0; ck < nc; ++ck) {
      PHASE_MARK(1)
      const T* kb = acquire(g0 + ck);
      PHASE_MARK(9)
      const int c0 = ck * KC;
      if constexpr (BF) {
        if (wg1) {
          // the tile's 64 rows x keys rg KC / 4 .. of the chunk, on wgmma:
          // Q and the chunk straight from shared memory, K-major, 16 d a
          // step (two core matrices, 256 bytes, along K)
          float c[CL_KT * 4];
#pragma unroll
          for (int e = 0; e < CL_KT * 4; ++e) c[e] = 0.f;
          const uint64_t da = wg_desc(qs, 128, 16 * D);
          const uint64_t db = wg_desc(kb + cm(rg * (KC / 4), 0, D), 128,
                                      16 * D);
          // nothing but the products between the fence and the wait: a
          // branch among them makes ptxas serialize them
          auto gemm1 = [&](auto nn) {
            constexpr int N = decltype(nn)::value;
            reg_fence(c, CL_KT * 4);
            wg_fence();
            for (int ks = 0; ks < D / 16; ++ks)
              wgmma_ss<N>(c, da + 16 * ks, db + 16 * ks);
            wg_commit_wait();
            reg_fence(c, CL_KT * 4);
          };
          if (KC == 128)
            gemm1(IC<32>());
          else if (KC == 64)
            gemm1(IC<16>());
          else
            gemm1(IC<8>());
          const bool hit1 = thit && f_site == S_GEMM1;
#pragma unroll
          for (int k = 0; k < CL_KT; ++k) {
            if (k * 32 < KC) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = 16 * wk + g + (e >> 1) * 8;
                const int col = c0 + rg * (KC / 4) + k * 8 + 2 * t4 + (e & 1);
                float sv = c[4 * k + e] * P.scale;
                if (hit1 && r == f_row && col == f_lcol)
                  sv = flip_bit(sv, f_bit);
                if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
                sp0[r * lds + col] = sv;
              }
            }
          }
        }
      }
      if (gact && !wg1) {
        if constexpr (BF) {
          // the group's 16 rows x this warp's n-tiles (keys nt * 8 ..)
          float c[CL_KT][4];
#pragma unroll
          for (int k = 0; k < CL_KT; ++k) c[k][0] = c[k][1] = c[k][2] = c[k][3] = 0.f;
          const int l16 = lane & 15;
          for (int ks = 0; ks < D / 16; ++ks) {
            uint32_t a[4];
            ldmatrix_x4(a, qs + cm(gr0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                   ks * 16 + (lane >> 4) * 8, D));
#pragma unroll
            for (int k = 0; k < CL_KT; ++k) {
              const int nt = wk + WPG * k;
              if (nt * 8 < KC) {
                uint32_t b[2];
                ldmatrix_x2(b, kb + cm(nt * 8 + (l16 & 7),
                                       ks * 16 + (l16 >> 3) * 8, D));
                mma_bf16(c[k], a, b);
              }
            }
          }
#pragma unroll
          for (int k = 0; k < CL_KT; ++k) {
            const int nt = wk + WPG * k;
            if (nt * 8 < KC) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = g + (e >> 1) * 8;
                const int col = c0 + nt * 8 + 2 * t4 + (e & 1);
                float sv = c[k][e] * P.scale;
                if (hit && f_site == S_GEMM1 && r == fg && col == f_lcol)
                  sv = flip_bit(sv, f_bit);
                if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
                sp[r * lds + col] = sv;
              }
            }
          }
        } else {
          // sequential f32 FMAs over d, a lane per key, the warp's rows
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
                if (hit && f_site == S_GEMM1 && wr + r == fg && c0 + c == f_lcol)
                  sv = flip_bit(sv, f_bit);
                if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
                sp[(wr + r) * lds + c0 + c] = sv;
              }
            }
          }
        }
      }
      if (ft && BF) {
        // fold this chunk's keys into the tensor checksums of this CTA's
        // residues on the tensor cores: fold(K)^T (d x residues) += K^T
        // (d x keys, ldmatrix.trans of the chunk) times the matrix of the
        // keys' residues (1) and segment weights (l + 1): exact products,
        // f32 sums, accumulated in kf1 / kf2 across the chunks
        const int nci = (rc + 7) / 8, items = (D / 16) * nci;
        const bool rep16 = 16 % rc == 0;
        for (int it = w; it < items; it += NT / 32) {
          const int mt = it / nci, nt = it - mt * nci;
          const int i = nt * 8 + g;  // this lane's column of B: a residue
          float f1[4], f2[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ie = nt * 8 + 2 * t4 + (e & 1);
            const int de = mt * 16 + g + (e >> 1) * 8;
            f1[e] = ck && ie < rc ? kf1[ie * ldf + de] : 0.f;
            f2[e] = ck && ie < rc ? kf2[ie * ldf + de] : 0.f;
          }
          // B rows k = 2 t + 8 h + u of each 16 keys: key c0 + 16 ks + k
          float eb[4], es[4];
#pragma unroll
          for (int hu = 0; hu < 4; ++hu) {
            const int k = c0 + 2 * t4 + 8 * (hu >> 1) + (hu & 1);
            const bool on = i < rc && drc.r(k) == i;
            eb[hu] = on ? (float)(drc.q(k) + 1) : 0.f;
            es[hu] = on ? (float)(16 / rc) : 0.f;
          }
          const uint32_t b1[2] = {
              pack_bf16(eb[0] != 0.f ? 1.f : 0.f, eb[1] != 0.f ? 1.f : 0.f),
              pack_bf16(eb[2] != 0.f ? 1.f : 0.f, eb[3] != 0.f ? 1.f : 0.f)};
          for (int ks = 0; ks < KC / 16; ++ks) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, kb + cm(ks * 16 + (lane & 7) + (lane >> 4) * 8,
                                         mt * 16 + ((lane >> 3) & 1) * 8, D));
            uint32_t b2[2], bo[2];
            if (rep16) {
              b2[0] = pack_bf16(eb[0], eb[1]);
              b2[1] = pack_bf16(eb[2], eb[3]);
              bo[0] = b1[0];
              bo[1] = b1[1];
#pragma unroll
              for (int hu = 0; hu < 4; ++hu) eb[hu] = eb[hu] + es[hu];
            } else {
              float w2[4], w1[4];
#pragma unroll
              for (int hu = 0; hu < 4; ++hu) {
                const int k = c0 + 16 * ks + 2 * t4 + 8 * (hu >> 1) + (hu & 1);
                const bool on = i < rc && drc.r(k) == i;
                w1[hu] = on ? 1.f : 0.f;
                w2[hu] = on ? (float)(drc.q(k) + 1) : 0.f;
              }
              b2[0] = pack_bf16(w2[0], w2[1]);
              b2[1] = pack_bf16(w2[2], w2[3]);
              bo[0] = pack_bf16(w1[0], w1[1]);
              bo[1] = pack_bf16(w1[2], w1[3]);
            }
            mma_bf16(f1, a, bo);
            mma_bf16(f2, a, b2);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ie = nt * 8 + 2 * t4 + (e & 1);
            const int de = mt * 16 + g + (e >> 1) * 8;
            if (ie < rc) {
              kf1[ie * ldf + de] = f1[e];
              kf2[ie * ldf + de] = f2[e];
            }
          }
        }
      } else if (ft) {
        // fold this chunk's keys into the tensor checksums of this CTA's
        // residues, segments in order (local key c = l * rc + ii)
#pragma unroll 2
        for (int e = tid; e < rc * D; e += NT) {
          const int i = dD.q(e), d = e - i * D;
          float f1 = ck ? kf1[i * ldf + d] : 0.f;
          float f2 = ck ? kf2[i * ldf + d] : 0.f;
          int c = c0 + drc.r(i - drc.r(c0) + rc);
          float wl = (float)(drc.q(c) + 1);  // the segment's weight l + 1
#pragma unroll 4
          for (; c < c0 + KC; c += rc, wl += 1.f) {
            const float x = to_f(kb[(c - c0) * ldk + d]);
            f1 = f1 + x;
            f2 = f2 + wl * x;
          }
          kf1[i * ldf + d] = f1;
          kf2[i * ldf + d] = f2;
        }
      }
      release(g0 + ck);
    }
    consumer_sync(NT);  // the K folds and every warp's scores are complete
    PHASE_MARK(1)
    if constexpr (BF) {
      if (ft) {
        // ---- the checksum products Q fold(K)^T of the group's rows on the
        //      tensor cores in TF32: Q's bf16 values are TF32 exactly,
        //      fold(K) is split into high and low TF32 parts, products are
        //      exact and summed in f32 (about f32's 2^-24) ----
        const int nci = (rc + 7) / 8;  // n-tiles of residues
        for (int it = wk; gact && it < 2 * nci; it += WPG) {
          const int which = it / nci, nt = it - which * nci;
          const float* kf = which ? kf2 : kf1;
          const int i = nt * 8 + g;  // this lane's column of B
          // rows gr0 + g and + 8 of Q: element d of a row at d / 8 * 64 +
          // d % 8 of its core-matrix row
          const unsigned short* qb =
              (const unsigned short*)(qs + cm(gr0 + g, 0, D));
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
          for (int ks = 0; ks < D / 8; ++ks) {
            const int d0 = ks * 8 + t4, q0 = ks * 64 + t4;
            const uint32_t a[4] = {(uint32_t)qb[q0] << 16,
                                   (uint32_t)qb[8 * D + q0] << 16,
                                   (uint32_t)qb[q0 + 4] << 16,
                                   (uint32_t)qb[8 * D + q0 + 4] << 16};
            const float b0 = i < rc ? kf[i * ldf + d0] : 0.f;
            const float b1 = i < rc ? kf[i * ldf + d0 + 4] : 0.f;
            const uint32_t bh[2] = {to_tf32(b0), to_tf32(b1)};
            const uint32_t bl[2] = {to_tf32(b0 - __uint_as_float(bh[0])),
                                    to_tf32(b1 - __uint_as_float(bh[1]))};
            mma_tf32(c, a, bh);
            mma_tf32(c, a, bl);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + (e >> 1) * 8, col = nt * 8 + 2 * t4 + (e & 1);
            if (col < rc) (which ? sc2 : sc1)[r * rc + col] = c[e] * P.scale;
          }
        }
      }
      consumer_sync(NT);  // the group's checksum products are in
    }

    if (wact) {
      if (ft) {
        // ---- checksum GEMMs on the folded K, verify, locate + correct:
        //      this CTA's residues only ----
        for (int b0 = 0; b0 < npr32; b0 += 32) {
          const int p = b0 + lane;
          if (p < npr) {
            const int r = wr + drc.q(p), i = drc.r(p);
            float c1, c2;
            if constexpr (BF) {
              c1 = sc1[r * rc + i];
              c2 = sc2[r * rc + i];
            } else {
              const T* qr = qs + (gr0 + r) * ldk;
              float a1 = 0.f, a2 = 0.f;
              qk_fold<T>(qr, kf1 + i * ldf, kf2 + i * ldf, D, &a1, &a2);
              c1 = a1 * P.scale;
              c2 = a2 * P.scale;
              sc1[r * rc + i] = c1;
            }
            float sum1 = 0.f, sum2 = 0.f;
#pragma unroll 8
            for (int l = 0; l < g_kv; ++l) {
              const float x = sp[r * lds + l * rc + i];
              sum1 = sum1 + x;
              sum2 = sum2 + (float)(l + 1) * x;
            }
            const float d1 = c1 - sum1, d2 = c2 - sum2;
            const bool bad = fabsf(d1) > P.eps1;
            if (r - wr < nrw) det[0] += bad;
            if (correct && bad)
              sp[r * lds + seg_of(d1, d2, g_kv) * rc + i] += d1;
          }
        }
        __syncwarp();
      }
      PHASE_MARK(2)

      // ---- mask, this CTA's part of the block max: rc lanes a row ----
      for (int b0 = 0; b0 < npr32; b0 += 32) {
        const int p = b0 + lane;
        const bool valid = p < npr;
        const int r = wr + drc.q(p), i = drc.r(p);
        const int row_abs = r0 + gr0 + r;
        // every key of the block visible to this row: no mask to compute
        const bool full = kv_start + Bc <= P.kv_len &&
                          (!P.causal || kv_start + Bc - 1 <= row_abs) &&
                          row_abs - kv_start < P.window;
        float bm = MASK_VALUE;
        if (valid) {
          if (full) {
#pragma unroll 8
            for (int l = 0; l < g_kv; ++l)
              bm = fmax_nan(bm, sp[r * lds + l * rc + i]);
          } else {
#pragma unroll 8
            for (int l = 0; l < g_kv; ++l) {
              const int col = kv_start + l * skv + i0 + i;
              const bool mk = col < P.kv_len &&
                              (!P.causal || col <= row_abs) &&
                              row_abs - col < P.window;
              bm = fmax_nan(bm, mk ? sp[r * lds + l * rc + i] : MASK_VALUE);
            }
          }
        }
        for (int o = rc >> 1; o > 0; o >>= 1)
          bm = fmax_nan(bm, __shfl_xor_sync(FULL, bm, o));
        if (valid && i == 0) xmax[gr0 + r] = bm;
      }
    }
    PHASE_MARK(3)
    cluster_sync();  // exchange 1: every CTA's part of the block max
    PHASE_MARK(8)

    if (wact) {
      // ---- running max (+ shadow), the same in every CTA: lane ii of a
      //      row reads the parts of ranks ii, ii + rc, ... ----
      for (int b0 = 0; b0 < npr32; b0 += 32) {
        const int p = b0 + lane;
        const bool valid = p < npr;
        const int r = wr + drc.q(p), i = drc.r(p);
        float bm = MASK_VALUE;
        if (valid)
          for (int c = i; c < n; c += rc)
            bm = fmax_nan(bm, *at_rank(xmax + gr0 + r, c));
        for (int o = rc >> 1; o > 0; o >>= 1)
          bm = fmax_nan(bm, __shfl_xor_sync(FULL, bm, o));
        if (valid && i == 0) {
          const float mp = m_s[r];
          float mn = fmax_nan(mp, bm);
          if (hit && f_site == S_ROWMAX && r == fg) mn = flip_bit(mn, f_bit);
          if (ft && P.shadow_rowmax) {
            const float mc = fmax_nan(opaque(mp), bm);
            const bool bad = mn != mc;
            if (lead && r - wr < nrw) det[2] += bad;
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

      // ---- EXP with checksum reuse (paper Case 2), backstop, mask, this
      //      CTA's part of the rowsum (+ shadow); p is written over s ----
      for (int b0 = 0; b0 < npr32; b0 += 32) {
        const int p = b0 + lane;
        const bool valid = p < npr;
        const int r = wr + drc.q(p), i = drc.r(p);
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
            {
              const float sv = srow[l * rc];
              float x = expf(min_cap(sv - ms, P.cap));
              if (hit && f_site == S_EXP && r == fg && l * rc + i == f_lcol)
                x = flip_bit(x, f_bit);
              pr[l] = x;
              prod = prod * x;
              col_ok = col_ok && !((sv - ms) > P.cap_m);
            }
          }
          if (ft) {
            const float pc1 =
                expf(min_cap(sc1[r * rc + i] - (float)g_kv * ms, P.cap_g));
            const float ref = fmax_nan(fabsf(pc1), 1e-20f);
            const bool bad =
                col_ok && (fabsf(prod - pc1) > P.eps2 * ref + 1e-20f);
            if (r - wr < nrw) det[1] += bad;
            if (correct && bad) {
#pragma unroll 4
              for (int l = 0; l < g_kv; ++l)
                pr[l] = expf(min_cap(srow[l * rc] - ms, P.cap));
            }
          }
          const bool full = kv_start + Bc <= P.kv_len &&
                            (!P.causal || kv_start + Bc - 1 <= row_abs) &&
                            row_abs - kv_start < P.window;
#pragma unroll 4
          for (int l = 0; l < g_kv; ++l) {
            {
              float x = pr[l];
              const float sv = srow[l * rc];
              if (ft && P.shadow_rowmax && correct) {
                // exact recompute backstop
                const float rc_ = expf(min_cap(sv - ms, P.cap));
                const bool slipped = x != rc_;
                if (r - wr < nrw) det[1] += slipped;
                if (slipped) x = rc_;
              }
              if (!full) {
                const int col = kv_start + l * skv + i0 + i;
                const bool mk = col < P.kv_len &&
                                (!P.causal || col <= row_abs) &&
                                row_abs - col < P.window;
                x = mk ? x : 0.f;
              }
              srow[l * rc] = x;
              ps = ps + x;
              ps2 = ps2 + opaque(x);
            }
          }
        }
        for (int o = rc >> 1; o > 0; o >>= 1) {
          ps = ps + __shfl_xor_sync(FULL, ps, o);
          ps2 = ps2 + opaque(__shfl_xor_sync(FULL, ps2, o));
        }
        if (valid && i == 0) {
          xsum[gr0 + r] = ps;
          xsum2[gr0 + r] = ps2;
        }
      }
    }
    PHASE_MARK(4)
    cluster_sync();  // exchange 2: every CTA's part of the rowsums
    PHASE_MARK(8)
    if (wact) {
      // ---- rowsum (+ shadow) and the SNVR tracker, the same in every
      //      CTA: lane ii of a row sums the parts of ranks ii, ii + rc, ...
      //      and the lanes combine in one fixed order ----
      for (int b0 = 0; b0 < npr32; b0 += 32) {
        const int p = b0 + lane;
        const bool valid = p < npr;
        const int r = wr + drc.q(p), i = drc.r(p);
        float ps = 0.f, ps2 = 0.f;
        if (valid)
          for (int c = i; c < n; c += rc) {
            ps = ps + *at_rank(xsum + gr0 + r, c);
            ps2 = ps2 + opaque(*at_rank(xsum2 + gr0 + r, c));
          }
        for (int o = rc >> 1; o > 0; o >>= 1) {
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

    // ---- V pass: this CTA's partial P V over all of D, V read once; V
    //      column checksums, the O-checksum products, max|V| ----
    // tensor cores: this warp's n-tiles wk + WPG kk of its group's rows,
    // or (wgmma) n-tiles kk of columns rg D / 4 .. of rows 16 wk ..
    float pv[NTW][4];
    float pf[RPW][NTW];  // FMAs: [row][column lane + 32 h]
    // bf16: the O-checksum products of n-tile ot of the checksum columns,
    // rows vr0 ..
    float oca[4] = {0.f, 0.f, 0.f, 0.f};
    const int vr0 = wg2 ? 16 * wk : gr0, ot = wg2 ? rg : wk;
#pragma unroll
    for (int k = 0; k < NTW; ++k) pv[k][0] = pv[k][1] = pv[k][2] = pv[k][3] = 0.f;
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int h = 0; h < NTW; ++h) pf[r][h] = 0.f;
    for (int ck = 0; ck < nc; ++ck) {
      PHASE_MARK(5)
      const T* vb = acquire(g0 + nc + ck);
      PHASE_MARK(10)
      const int c0 = ck * KC;
      if (ft) {
        // every warp is done with the last chunk's checksums
        if (ck) consumer_sync(NT);
        if constexpr (BF) {
          // this chunk's V column checksums on the tensor cores: V (keys x
          // D) times the matrix of 0s and fold weights (D x the two
          // checksums' columns), exact products summed in f32; stored as
          // high and low bf16 parts (B of the O-checksum products), and
          // max|V| from the same fragments
          const int items = (KC / 16) * nct;
          for (int it = w; it < items; it += NT / 32) {
            const int mt = it / nct, nt = it - mt * nct;
            const int n = nt * 8 + g;  // this lane's column of B
            const int ci = n < sout ? n : n - sout;
            // where s_out divides 16 each k-step's B repeats the first's,
            // the weighted column's weights grown by 16 / s_out
            const bool rep16 = 16 % sout == 0;
            float eb[4], es[4];
#pragma unroll
            for (int hu = 0; hu < 4; ++hu) {
              const int k = 2 * t4 + 8 * (hu >> 1) + (hu & 1);
              const int seg = dsout.q(k), res = k - seg * sout;
              const bool on = n < 2 * sout && res == ci;
              eb[hu] = !on ? 0.f : n < sout ? 1.f : (float)(seg + 1);
              es[hu] = on && n >= sout ? (float)(16 / sout) : 0.f;
            }
            float cv[4] = {0.f, 0.f, 0.f, 0.f};
            for (int ks = 0; ks < D / 16; ++ks) {
              uint32_t a[4];
              ldmatrix_x4(a, vb + cm(mt * 16 + (lane & 7) +
                                         ((lane >> 3) & 1) * 8,
                                     ks * 16 + (lane >> 4) * 8, D));
              if (nt == 0 && correct) {
#pragma unroll
                for (int k = 0; k < 4; ++k)
                  vmb = __hmax2_nan(vmb, __habs2(*(const __nv_bfloat162*)&a[k]));
              }
              uint32_t b[2];
              if (rep16) {
                b[0] = pack_bf16(eb[0], eb[1]);
                b[1] = pack_bf16(eb[2], eb[3]);
#pragma unroll
                for (int hu = 0; hu < 4; ++hu) eb[hu] = eb[hu] + es[hu];
              } else {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  float e[2];
#pragma unroll
                  for (int u = 0; u < 2; ++u) {
                    const int k = ks * 16 + 2 * t4 + 8 * h + u;
                    const int seg = dsout.q(k), res = k - seg * sout;
                    e[u] = n >= 2 * sout || res != ci ? 0.f
                           : n < sout               ? 1.f
                                                    : (float)(seg + 1);
                  }
                  b[h] = pack_bf16(e[0], e[1]);
                }
              }
              mma_bf16(cv, a, b);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = mt * 16 + g + (e >> 1) * 8;
              const int col = nt * 8 + 2 * t4 + (e & 1);
              const __nv_bfloat16 hi = __float2bfloat16(cv[e]);
              vch[key * ldc + col] = hi;
              vcl[key * ldc + col] = __float2bfloat16(cv[e] - __bfloat162float(hi));
            }
          }
        } else {
          // this chunk's V column checksums, by the whole CTA (reading
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
              if (correct) vm = fmax_nan(vm, fabsf(x));
            }
            vcs[e] = make_float2(f1, f2);
          }
        }
        consumer_sync(NT);
        PHASE_MARK(11)
        if constexpr (!BF) {
          // the O-checksum products of this warp's rows, keys in order
          if (wact) {
            for (int p = lane; p < npo; p += 32) {
              const int r = wr + dsout.q(p), i = dsout.r(p);
              const float* prow = sp + r * lds + c0;
              const float2* vc = vcs + i;
              float a1 = ck ? ocb1[r * sout + i] : 0.f;
              float a2 = ck ? ocb2[r * sout + i] : 0.f;
#pragma unroll 2
              for (int c = 0; c < KC; c += 4) {
                const float4 x = *(const float4*)(prow + c);
                const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  const float2 y = vc[(c + u) * sout];
                  a1 = fmaf(xs[u], y.x, a1);
                  a2 = fmaf(xs[u], y.y, a2);
                }
              }
              ocb1[r * sout + i] = a1;
              ocb2[r * sout + i] = a2;
            }
          }
        }
        PHASE_MARK(12)
      }
      if constexpr (BF) {
        const int l16 = lane & 15;
        // the O-checksum products of rows vr0 .. against n-tile ot of the
        // checksum columns, p and the checksums each split into bf16 high
        // and low parts (hi hi + hi lo + lo hi: about 2^-15 of each
        // product, against the f32 products' 2^-24)
        const bool och = ft && ot < nct && nrows > vr0;
        const float* prow = sp0 + vr0 * lds;
        // p of rows vr0 + g, + 8 at keys k, k + 1, k + 8, k + 9 (k = c0 +
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
        if (wg2) {
          // wgmma's B: V's columns rg D / 4 .., N-major, core matrices 128
          // bytes apart along N and 16 D bytes (8 keys) along K; nothing
          // but the products in the loop (a branch among them makes ptxas
          // serialize them)
          const uint64_t dv =
              wg_desc(vb + cm(0, rg * (D / 4), D), 16 * D, 128);
          // a loop of compile-time length with nothing but p's fragments
          // and the products (a branch or a runtime trip count among them
          // makes ptxas serialize the products)
          auto gemm2 = [&](auto nn, auto kk) {
            constexpr int N = decltype(nn)::value, KS = decltype(kk)::value;
            if constexpr (N <= 8 * NTW) {
#pragma unroll
              for (int ks = 0; ks < KS; ++ks) {
                float2 x[4];
                uint32_t a[4];
                p_frag(ks, x, a);
                wg_fence();  // a was written since the last product
                wgmma_rs<N>(&pv[0][0], a, dv + 2 * D * ks);
              }
              wg_commit_wait();
              reg_fence(&pv[0][0], NTW * 4);
            }
          };
          auto by_d = [&](auto kk) {
            if (D == 128)
              gemm2(IC<32>(), kk);
            else if (D == 64)
              gemm2(IC<16>(), kk);
            else
              gemm2(IC<64>(), kk);
          };
          if (KC == 128)
            by_d(IC<8>());
          else if (KC == 64)
            by_d(IC<4>());
          else
            by_d(IC<2>());
        }
        for (int ks = 0; ks < KC / 16 && (wg2 ? och : gact); ++ks) {
          float2 x[4];
          uint32_t a[4];
          p_frag(ks, x, a);
          if (!wg2) {
#pragma unroll
            for (int kk = 0; kk < NTW; ++kk) {
              const int nt = wk + WPG * kk;
              if (nt * 8 < D) {
                uint32_t b[2];
                ldmatrix_x2_trans(b, vb + cm(ks * 16 + l16, nt * 8, D));
                mma_bf16(pv[kk], a, b);
              }
            }
          }
          if (och) {
            uint32_t al[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) al[u] = pack_bf16_lo(x[u].x, x[u].y, a[u]);
            uint32_t bh[2], bl[2];
            ldmatrix_x2_trans(bh, vch + (ks * 16 + l16) * ldc + ot * 8);
            ldmatrix_x2_trans(bl, vcl + (ks * 16 + l16) * ldc + ot * 8);
            mma_bf16(oca, a, bh);
            mma_bf16(oca, a, bl);
            mma_bf16(oca, al, bh);
          }
        }
      } else if (wact) {
        // sequential FMAs over this CTA's keys, in its order: the warp's
        // RPW rows, columns lane + 32 h
#pragma unroll 2
        for (int c = 0; c < KC; ++c) {
          const T* vr = vb + c * ldk;
#pragma unroll
          for (int h = 0; h < NTW; ++h) {
            const int d = lane + 32 * h;
            if (d < D) {
              const float x = to_f(vr[d]);
#pragma unroll
              for (int r = 0; r < RPW; ++r)
                pf[r][h] = fmaf(sp[(wr + r) * lds + c0 + c], x, pf[r][h]);
            }
          }
        }
      }
      release(g0 + nc + ck);
    }
    // ---- rescale + accumulate the partial O ----
    const float* alpha_v = row0 + 5 * TR + vr0;  // bf16: rows vr0 ..
    if constexpr (BF) {
      if (wg2 || gact) {
        float* ar = acc0 + vr0 * ldo;
#pragma unroll
        for (int k = 0; k < NTW; ++k) {
          const int col0 = wg2 ? rg * (D / 4) + k * 8 : (wk + WPG * k) * 8;
          if (wg2 ? k * 8 < D / 4 : col0 < D) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = g + (e >> 1) * 8;
              const int col = col0 + 2 * t4 + (e & 1);
              ar[r * ldo + col] = alpha_v[r] * ar[r * ldo + col] + pv[k][e];
            }
          }
        }
      }
    } else if (gact) {
      if (wact) {
#pragma unroll
        for (int h = 0; h < NTW; ++h) {
          const int d = lane + 32 * h;
          if (d < D) {
#pragma unroll
            for (int rr = 0; rr < RPW; ++rr) {
              const int r = wr + rr;
              acc[r * ldo + d] = alpha_s[r] * acc[r * ldo + d] + pf[rr][h];
            }
          }
        }
      }
    }
    if (ft) {
      if constexpr (BF) {
        if (nrows > vr0 && ot < nct) {
          float* o1 = oc10 + vr0 * sout;
          float* o2 = o1 + TR * sout;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = g + (e >> 1) * 8;
            const int col = ot * 8 + 2 * t4 + (e & 1);
            if (col < 2 * sout) {
              float* o = col < sout ? o1 + r * sout + col
                                    : o2 + r * sout + col - sout;
              *o = alpha_v[r] * *o + oca[e];
            }
          }
        }
      } else if (wact) {
        for (int p = lane; p < npo; p += 32) {
          const int r = wr + dsout.q(p), i = dsout.r(p);
          const int e = r * sout + i;
          oc1[e] = alpha_s[r] * oc1[e] + ocb1[e];
          oc2[e] = alpha_s[r] * oc2[e] + ocb2[e];
        }
      }
    }
    PHASE_MARK(5)
    if (thit && f_site == S_GEMM2) {
      // the GEMM II SEU strikes the accumulator, the sum of the CTAs'
      // partials: rank 0 adds the flip's change of that sum to its own
      const bool in = f_col >= 0 && f_col < D;
      consumer_sync(NT);  // every warp's columns of acc are in
      if (tid == 0) xone[1] = in ? acc0[f_row * ldo + f_col] : 0.f;
      cluster_sync();
      if (lead && tid == 0 && in) {
        float t = 0.f;
        for (int c = 0; c < n; ++c) t = t + *at_rank(xone + 1, c);
        acc0[f_row * ldo + f_col] += flip_bit(t, f_bit) - t;
      }
    }
    consumer_sync(NT);  // every warp is done with this block's p and acc
    PHASE_MARK(6)
  }

  // ---- this CTA's max|V| ----
  if constexpr (BF)
    vm = fmax_nan(vm, fmax_nan(__low2float(vmb), __high2float(vmb)));
  for (int o = 16; o > 0; o >>= 1)
    vm = fmax_nan(vm, __shfl_xor_sync(FULL, vm, o));
  if (lane == 0) red[w] = vm;
  consumer_sync(NT);
  if (tid == 0) {
    float v = red[0];
    for (int i = 1; i < NT / 32; ++i) v = fmax_nan(v, red[i]);
    xone[0] = v;
  }
  PHASE_MARK(7)
  cluster_sync();  // exchange 3: partial O, O checksums and max|V| are in
  PHASE_MARK(8)
  float vmax = *at_rank(xone, 0);
  for (int c = 1; c < n; ++c) vmax = fmax_nan(vmax, *at_rank(xone, c));

  // ---- finalize this CTA's rows rlo .. rlo + rpc - 1: the partials
  //      summed in rank order, SNVR on l, unified output verification ----
  const int rpc = TR / n, rlo = rank * rpc;
  float* fo = (float*)(smem + L.sp);
  float* fc1 = fo + rpc * ldo;
  float* fc2 = fc1 + rpc * sout;
  for (int e = tid; e < rpc * D; e += NT) {
    const int rr = dD.q(e), d = e - rr * D;
    float s = 0.f;
    for (int c = 0; c < n; ++c) s = s + *at_rank(acc0 + (rlo + rr) * ldo + d, c);
    fo[rr * ldo + d] = s;
  }
  if (ft) {
    for (int e = tid; e < rpc * sout; e += NT) {
      const float* a1 = oc10 + rlo * sout + e;
      float s1 = 0.f, s2 = 0.f;
      for (int c = 0; c < n; ++c) {
        s1 = s1 + *at_rank(a1, c);
        s2 = s2 + *at_rank(a1 + TR * sout, c);
      }
      fc1[e] = s1;
      fc2[e] = s2;
    }
  }
  float* lb = row0 + TR;         // l by tile row
  float* lsafe = row0 + 7 * TR;  // by tile row
  for (int rr = tid; rr < rpc; rr += NT) {
    const int r = rlo + rr;
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
  consumer_sync(NT);
  const float bound = vmax * 1.001f + 1e-6f;
  for (int e = tid; e < rpc * D; e += NT) {
    const int rr = dD.q(e), d = e - rr * D;
    float o = fo[rr * ldo + d] / lsafe[rlo + rr];
    if (ft && correct) o = (isfinite(o) && fabsf(o) <= bound) ? o : 0.f;
    fo[rr * ldo + d] = o;
  }
  consumer_sync(NT);
  if (ft) {
    for (int p = tid; p < rpc * sout; p += NT) {
      const int rr = dsout.q(p), i = dsout.r(p);
      const float ls = lsafe[rlo + rr];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
      for (int l = 0; l < g_out; ++l) {
        const float x = fo[rr * ldo + l * sout + i];
        s1 = s1 + x;
        s2 = s2 + (float)(l + 1) * x;
      }
      const float d1 = fc1[p] / ls - s1;
      const float d2 = fc2[p] / ls - s2;
      const bool bad = !(fabsf(d1) <= P.eps3);
      if (rlo + rr < nrows) det[4] += bad;
      if (correct && bad) fo[rr * ldo + seg_of(d1, d2, g_out) * sout + i] += d1;
    }
    consumer_sync(NT);
  }
  const int nreal = max(0, min(rpc, nrows - rlo));
  T* og = (T*)P.out + ((size_t)bh * P.Sq + r0 + rlo) * D;
  for (int e = tid; e < nreal * D; e += NT) {
    const int rr = dD.q(e), d = e - rr * D;
    og[e] = from_f<T>(fo[rr * ldo + d]);
  }
  // ---- this CTA's partial counts: warps in order, no atomics ----
  int* redi = (int*)(red + NT / 32);
  for (int k = 0; k < 5; ++k) {
    int v = det[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) redi[w * 5 + k] = v;
  }
  consumer_sync(NT);
  if (tid < 5) {
    int tot = 0;
    for (int i = 0; i < NT / 32; ++i) tot += redi[i * 5 + tid];
    P.rep[(((size_t)bh * n_t + tile) * n + rank) * 5 + tid] = tot;
  }
  PHASE_MARK(7)
  cluster_sync();  // no CTA leaves while another may read its memory
  PHASE_MARK(8)
  PHASE_FLUSH
}
