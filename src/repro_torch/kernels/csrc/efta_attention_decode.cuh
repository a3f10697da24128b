// Kernel B2's decode layout, for launches with one query row a reference
// query tile (block_q 1: the cross-attention decode of t5 and the VLM; the
// design note is at the head of efta_attention.cu). Included by
// efta_attention.cu inside its anonymous namespace, after Params, the
// fault-descriptor indices and efta_hopper.cuh.
//
// Three kernels a launch, each spread over the whole card:
//   * the score pass (efta_attention_kernel_dscore), one CTA a (unit, KV
//     block, part): GEMM I of the unit's query rows against the part's
//     keys, the K folds of its fold residues, the fold check with locate
//     and correct, the partial block max; scores, checksum products and
//     partial maxima to the workspace;
//   * the EXP pass (efta_attention_kernel_dexp), the same grid: the running
//     max replayed in block order from the block maxima (the shadow max
//     and its SEU with it), EXP with its product-fold check and backstop,
//     the rowsum terms, the V column checksums and max|V|, P V and the
//     O-checksum products from zero, to the workspace;
//   * the state pass (efta_attention_kernel_dstate), one CTA a query row:
//     the running state folded in block order (m, l, shadow l, r, the
//     accumulator, the O checksums), the SNVR bound, the |o| <= max|V|
//     clamp and the unified output verify.
// A unit is (KV head of a request, group of up to DC_ROWS of its query
// heads, query tile). A part is s_kv / parts fold residues of a KV block
// and all their g_kv segments: the keys l s_kv + i, i in the part's
// residues. Each CTA writes its own partial counts (the score pass GEMM I,
// the EXP pass EXP, the state pass the rest), summed by the wrapper.
// Indices divide with Div (efta_common.cuh: a shift and a mask for the
// powers of two these shapes have): FDiv's multiplier costs a 64-bit
// division to form, which CTAs this short do not earn back.

// query rows of a unit (a warp each in the row phases; the score and EXP
// passes launch DC_THREADS threads or 32 x max(rows, 4), see launch_decode)
constexpr int DC_ROWS = 8;
// keys a CTA of the score and EXP passes at most (fewer, larger CTAs
// measured faster at t5's block: 128 keys against 64 or 256)
constexpr int DC_KEYS = 128;
constexpr int DC_THREADS = 32 * DC_ROWS;
// the state pass: threads a CTA (D <= 2 x this), KV blocks staged a step
constexpr int DC_STATE_THREADS = 128;
constexpr int DC_CHAIN = 32;

// the layout of one launch's shapes: residue parts a KV block, keys and
// residues a part, strides; the workspace slot of one (unit, KV block)
// (float offsets: the scores in block column order, the checksum products
// Q fold(K)^T, the parts' block maxima, then per part P V, the two O
// checksums, the rowsum and shadow rowsum terms and max|V|); each kernel's
// shared bytes
struct DLayout {
  int parts, keys, res, ldk, ldf, chain;
  int s, sc1, bm, part, part_floats, floats;
  int p_oc1, p_oc2, p_ps, p_ps2, p_vm;
  size_t a_q, a_s, a_kf, a_flag, a_total;  // the K strip at 0
  size_t b_s, b_p, b_sc1, b_vc, b_ocp, b_ms, b_red, b_stage, b_total;
  size_t c_stage, c_pv, c_oc, c_o, c_run, c_alpha, c_rterm, c_tail, c_total;
};

// the fewest parts (a divisor of s_kv) that leave at most DC_KEYS keys a
// CTA, a multiple of 16 (an mma k-step of GEMM II); 0 where none does
// (g_kv > DC_KEYS)
int decode_parts(int Bc, int skv) {
  for (int p = 1; p <= skv; ++p)
    if (skv % p == 0 && Bc % (16 * p) == 0 && Bc / p <= DC_KEYS) return p;
  return 0;
}

DLayout make_decode_layout(int D, int Bc, int skv, int sout, int esz) {
  DLayout L;
  auto up4 = [](int n) { return (n + 3) & ~3; };
  L.parts = decode_parts(Bc, skv);
  const int parts = L.parts > 0 ? L.parts : 1;
  L.keys = Bc / parts;
  L.res = skv / parts;
  L.ldk = esz == 2 ? D + 8 : D + 4;  // 16-byte rows on distinct banks
  L.ldf = D + 4;
  // KV blocks the state pass stages a step
  L.chain = DC_CHAIN / parts > 1 ? DC_CHAIN / parts : 1;
  const int R = DC_ROWS;
  L.s = 0;
  L.sc1 = up4(R * Bc);
  L.bm = L.sc1 + up4(R * skv);
  L.part = L.bm + up4(parts * R);
  L.p_oc1 = R * D;
  L.p_oc2 = L.p_oc1 + up4(R * sout);
  L.p_ps = L.p_oc2 + up4(R * sout);
  L.p_ps2 = L.p_ps + R;
  L.p_vm = L.p_ps2 + R;
  L.part_floats = L.p_vm + 4;
  L.floats = L.part + parts * L.part_floats;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) & ~(size_t)15;
    return o;
  };
  take((size_t)L.keys * L.ldk * esz);  // the part's K (V) strip
  L.a_q = take((size_t)16 * L.ldk * esz);  // an mma tile of 16 rows
  L.a_s = take((size_t)R * L.keys * 4);
  L.a_kf = take(2 * (size_t)L.res * L.ldf * 4);
  L.a_flag = take((size_t)R * L.res * 4);  // the fold check's verdicts
  L.a_total = off;
  off = L.a_q;
  L.b_s = take((size_t)R * L.keys * 4);
  L.b_p = take((size_t)R * L.keys * 4);
  L.b_sc1 = take((size_t)R * L.res * 4);
  L.b_vc = take(2 * (size_t)L.keys * sout * 4);
  // O-checksum partial sums: a (row, column) and key group a thread
  L.b_ocp = take(2 * (size_t)(R * sout > DC_THREADS ? R * sout : DC_THREADS) *
                 4);
  L.b_ms = take((size_t)R * 4);
  L.b_red = take((size_t)(DC_THREADS / 32) * 4);
  L.b_stage = take((size_t)DC_CHAIN * parts * R * 4);
  L.b_total = off;
  off = 0;
  // per staged block and part: block max, rowsum, shadow rowsum, max|V|;
  // its P V row and its two O-checksum rows
  L.c_stage = take((size_t)L.chain * parts * 4 * 4);
  L.c_pv = take((size_t)L.chain * parts * D * 4);
  L.c_oc = take((size_t)L.chain * parts * 2 * sout * 4);
  L.c_o = take((size_t)D * 4);
  L.c_run = take((size_t)L.chain * 4);
  L.c_alpha = take((size_t)L.chain * 4);
  L.c_rterm = take((size_t)L.chain * 4);  // the SNVR tracker's terms
  // safe l, max|V|, each warp's output-check count
  L.c_tail = take((size_t)(2 + DC_STATE_THREADS / 32) * 4);
  L.c_total = off;
  return L;
}

// the shared bytes of the largest of the three passes
size_t decode_smem(const DLayout& L) {
  size_t m = L.a_total > L.b_total ? L.a_total : L.b_total;
  return m > L.c_total ? m : L.c_total;
}

struct DParams {
  Params P;  // P.ws: the workspace, one slot a (unit, KV block)
  DLayout L;
  int n_rg;  // row groups a KV head: ceil(grp / DC_ROWS)
};

// one unit's rows: its query tile, the first of its query heads (bh), its
// real rows, the KV head, and the SEU's row among them (-1: none here)
struct DUnit {
  int iq, bh0, nr, kvh, fr;
  __device__ DUnit(const Params& P, int n_rg, int unit) {
    iq = unit % P.n_q;
    const int t = unit / P.n_q;
    const int rg = t % n_rg;
    kvh = t / n_rg;
    bh0 = kvh * P.grp + rg * DC_ROWS;
    nr = min(DC_ROWS, P.grp - rg * DC_ROWS);
    const int f = P.fault[F_BH] - bh0;
    fr = P.fault[F_ON] == 1 && P.fault[F_ROW] == iq && f >= 0 && f < nr
             ? f
             : -1;
  }
};

// whether the query tile iq runs KV block j (causal, window, kv_len), as
// the other layouts decide it for a one-row tile
__device__ __forceinline__ bool dc_runs(const Params& P, int iq, int j) {
  const int kv_start = j * P.block_kv;
  bool run = kv_start < P.kv_len && iq - (kv_start + P.block_kv - 1) <
                                        P.window;
  if (P.causal) run = run && kv_start <= iq;
  return run;
}

// key column c (absolute) is visible to query row iq
__device__ __forceinline__ bool dc_visible(const Params& P, int iq, int c) {
  return c < P.kv_len && (!P.causal || c <= iq) && iq - c < P.window;
}

// the counts of (bh, query tile iq) in count slot `slot`: the parts of
// every KV block (score and EXP passes), then the state pass's
__device__ __forceinline__ int* dc_rep(const Params& P, int parts, int bh,
                                       int iq, int slot) {
  const int n_sub = P.n_kv * parts + 1;
  return P.rep + (((size_t)bh * P.n_q + iq) * n_sub + slot) * 5;
}

// The running max after each of 32 KV blocks, a lane a block (`bm` its
// block max, -inf where the block does not run), from `m` before the
// first: a prefix max by shuffles (the max is exact in any order; -inf is
// its identity, so a block that does not run leaves m as it is), with the
// ROWMAX SEU at lane `f` (-1: none here) as the sequential step applies
// it: the step's m flipped, against the shadow max (the same max, so the
// unflipped value), in correct mode put back where they differ, and every
// later block's max taken from the struck value. *bad: whether the shadow
// disagreed (the same on every lane). The EXP and state passes replay it
// alike, as a whole warp.
__device__ __forceinline__ float dc_scan_max(const Params& P, float m,
                                             float bm, int lane, int f,
                                             bool* bad) {
  float x = bm;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = nan_max(y, x);
  }
  float v = nan_max(m, x);
  *bad = false;
  if (f >= 0) {
    const float a = __shfl_sync(FULL, v, f);
    float mn = flip_bit(a, P.fault[F_BIT]);
    if (P.mode != 0 && P.shadow_rowmax) {
      *bad = mn != opaque(a);
      if (P.mode == 2 && *bad) mn = a;
    }
    float x2 = lane > f ? bm : -INFINITY;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, x2, o);
      if (lane >= o) x2 = nan_max(y, x2);
    }
    if (lane == f) v = mn;
    if (lane > f) v = nan_max(mn, x2);
  }
  return v;
}

// a dot product of two f32 rows in shared memory (16-byte aligned), FMAs
// in column order: GEMM I of the f32 instantiation
__device__ __forceinline__ float dc_dot(const float* a, const float* b,
                                        int D) {
  float s = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

// the part's strip of K or V (rows l * res + ii <- keys l s_kv + i0 + ii of
// the block at `src`) into shared memory, 16-byte cp.async pieces
template <typename T>
__device__ __forceinline__ void dc_load_strip(T* dst, const T* src,
                                              const DLayout& L, int D,
                                              int skv) {
  constexpr int VE = 16 / sizeof(T);
  const int per = D / VE;
  const Div dper(per), dres(L.res);
  for (int e = threadIdx.x; e < L.keys * per; e += blockDim.x) {
    const int kk = dper.q(e), pc = e - kk * per;
    const int l = dres.q(kk), ii = kk - l * L.res;
    cp_async16(dst + kk * L.ldk + pc * VE,
               src + ((size_t)l * skv + ii) * D + pc * VE);
  }
}

// grid (n_kv x parts, units)
template <typename T>
__global__ void __launch_bounds__(DC_THREADS)
    efta_attention_kernel_dscore(const DParams C) {
  const Params& P = C.P;
  const DLayout& L = C.L;
  PHASE_INIT
  const int parts = L.parts, keys = L.keys, res = L.res;
  const int j = blockIdx.x / parts, pt = blockIdx.x - j * parts;
  const DUnit u(P, C.n_rg, blockIdx.y);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nthr = blockDim.x, nwarp = nthr >> 5;
  const int D = P.D, Bc = P.block_kv, skv = P.s_kv, ldk = L.ldk,
            ldf = L.ldf;
  const int g_kv = Bc / skv, i0 = pt * res, kv_start = j * Bc;
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const float MASK_VALUE = (float)MASK_D;
  const int slot = j * parts + pt;
  if (!dc_runs(P, u.iq, j)) {
    if (tid < u.nr) dc_rep(P, parts, u.bh0 + tid, u.iq, slot)[0] = 0;
    return;
  }
  const bool hit = u.fr >= 0 && P.fault[F_SITE] == S_GEMM1 &&
                   P.fault[F_BLOCK] == j;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = (T*)smem;
  T* qs = (T*)(smem + L.a_q);
  float* ss = (float*)(smem + L.a_s);
  float* kf1 = (float*)(smem + L.a_kf);
  float* kf2 = kf1 + res * ldf;
  float* ws = P.ws + ((size_t)blockIdx.y * P.n_kv + j) * L.floats;

  dc_load_strip<T>(ks,
                   (const T*)P.k +
                       ((size_t)u.kvh * P.Skv + kv_start + i0) * D,
                   L, D, skv);
  {
    constexpr int VE = 16 / sizeof(T);
    const int per = D / VE;
    const Div dper(per);
    const T* qg = (const T*)P.q + ((size_t)u.bh0 * P.Sq + u.iq) * D;
    for (int e = tid; e < u.nr * per; e += nthr) {
      const int r = dper.q(e), pc = e - r * per;
      cp_async16(qs + r * ldk + pc * VE,
                 qg + (size_t)r * P.Sq * D + pc * VE);
    }
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();
  PHASE_MARK(0)

  // ---- GEMM I + NVR clip: every (row, key) pair of the part ----
  const Div dkeys(keys), dres(res);
  auto put_score = [&](int r, int kk, float acc) {
    const int l = dres.q(kk), col = l * skv + i0 + (kk - l * res);
    float sv = acc * P.scale;
    if (hit && r == u.fr && col == P.fault[F_COL])
      sv = flip_bit(sv, P.fault[F_BIT]);
    if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
    ss[r * keys + kk] = sv;
  };
  if constexpr (sizeof(T) == 2) {
    // mma.sync m16n8k16: the unit's rows (of a 16-row tile; the rows past
    // them are not read back) x 8 keys a warp's n-tile, all of D
    const int g = lane >> 2, t4 = lane & 3, l16 = lane & 15;
    for (int nt = w; nt * 8 < keys; nt += nwarp) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kq = 0; kq < D / 16; ++kq) {
        uint32_t a[4], b[2];
        ldmatrix_x4(a, qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldk +
                           kq * 16 + (lane >> 4) * 8);
        ldmatrix_x2(b, ks + (nt * 8 + (l16 & 7)) * ldk + kq * 16 +
                           (l16 >> 3) * 8);
        mma_bf16(c, a, b);
      }
      if (g < u.nr) {
        put_score(g, nt * 8 + 2 * t4, c[0]);
        put_score(g, nt * 8 + 2 * t4 + 1, c[1]);
      }
    }
  } else {
    for (int e = tid; e < u.nr * keys; e += nthr) {
      const int r = dkeys.q(e), kk = e - r * keys;
      put_score(r, kk, dc_dot(qs + r * ldk, ks + kk * ldk, D));
    }
  }
  // ---- the part's K folds, segments in order, two columns a thread ----
  if (ft) {
    const int half = D / 2;
    const Div dhalf(half);
    for (int e = tid; e < res * half; e += nthr) {
      const int ii = dhalf.q(e), d = 2 * (e - ii * half);
      float f1a = 0.f, f1b = 0.f, f2a = 0.f, f2b = 0.f;
#pragma unroll 4
      for (int l = 0; l < g_kv; ++l) {
        const T* x = ks + (l * res + ii) * ldk + d;
        const float xa = to_f(x[0]), xb = to_f(x[1]), wl = (float)(l + 1);
        f1a = f1a + xa;
        f1b = f1b + xb;
        f2a = f2a + wl * xa;
        f2b = f2b + wl * xb;
      }
      *reinterpret_cast<float2*>(kf1 + ii * ldf + d) = make_float2(f1a, f1b);
      *reinterpret_cast<float2*>(kf2 + ii * ldf + d) = make_float2(f2a, f2b);
    }
  }
  __syncthreads();
  PHASE_MARK(1)

  // ---- the fold check: each (row, residue) pair on `lp` lanes (a power
  //      of two; the pairs of all rows spread over every warp), each lane a
  //      share of D for the checksum products Q fold(K)^T, summed over the
  //      lanes by shuffles; then the check, locate and correct ----
  int* flag = (int*)(smem + L.a_flag);
  if (ft) {
    const int pairs = u.nr * res;
    int lp = 32;
    while (lp > 1 && pairs * lp > nthr) lp >>= 1;
    const int per_warp = 32 / lp, sub = lane & (lp - 1);
    for (int base = w * per_warp; base < pairs;
         base += (nwarp) * per_warp) {
      const int pr = base + lane / lp;
      const bool valid = pr < pairs;
      const int r = valid ? dres.q(pr) : 0, ii = pr - r * res;
      float a1 = 0.f, a2 = 0.f;
      if (valid)
        for (int c = sub * 8; c < D; c += lp * 8) {
          float x[8];
          load_row<T, 8>(x, qs + r * ldk + c);
          const float* k1 = kf1 + ii * ldf + c;
          const float* k2 = kf2 + ii * ldf + c;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            a1 = fmaf(x[k], k1[k], a1);
            a2 = fmaf(x[k], k2[k], a2);
          }
        }
      for (int o = lp >> 1; o > 0; o >>= 1) {
        a1 = a1 + __shfl_xor_sync(FULL, a1, o);
        a2 = a2 + __shfl_xor_sync(FULL, a2, o);
      }
      if (valid && sub == 0) {
        // the folded scores in segment order, as the plain version sums
        // them: locate and correct move a struck score by d1, whose
        // rounding then matches
        const float* srow = ss + r * keys + ii;
        float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
        for (int l = 0; l < g_kv; ++l) {
          const float x = srow[l * res];
          s1 = s1 + x;
          s2 = s2 + (float)(l + 1) * x;
        }
        const float c1 = a1 * P.scale, c2 = a2 * P.scale;
        ws[L.sc1 + r * skv + i0 + ii] = c1;
        const float d1 = c1 - s1, d2 = c2 - s2;
        const bool bad = fabsf(d1) > P.eps1;
        flag[pr] = bad;
        if (correct && bad)
          ss[r * keys + seg_of(d1, d2, g_kv) * res + ii] += d1;
      }
    }
    __syncthreads();
  }
  PHASE_MARK(2)

  // ---- a warp a row: its fold-check count and its partial block max ----
  if (w < u.nr) {
    const int r = w;
    const float* srow = ss + r * keys;
    int det = 0;
    if (ft)
      for (int ii = lane; ii < res; ii += 32) det += flag[r * res + ii];
    float bm = MASK_VALUE;
    for (int kk = lane; kk < keys; kk += 32) {
      const int l = dres.q(kk);
      const int c = kv_start + l * skv + i0 + (kk - l * res);
      bm = nan_max(bm, dc_visible(P, u.iq, c) ? srow[kk] : MASK_VALUE);
    }
    for (int o = 16; o > 0; o >>= 1) {
      bm = nan_max(bm, __shfl_xor_sync(FULL, bm, o));
      det += __shfl_xor_sync(FULL, det, o);
    }
    if (lane == 0) {
      ws[L.bm + pt * DC_ROWS + r] = bm;
      dc_rep(P, parts, u.bh0 + r, u.iq, slot)[0] = det;
    }
  }
  __syncthreads();  // the corrected scores are in
  // ---- the scores to the workspace, in block column order ----
  for (int e = tid; e < u.nr * keys; e += nthr) {
    const int r = dkeys.q(e), kk = e - r * keys;
    const int l = dres.q(kk);
    ws[L.s + r * Bc + l * skv + i0 + (kk - l * res)] = ss[e];
  }
  PHASE_MARK(3)
  PHASE_FLUSH
}

// grid (n_kv x parts, units)
template <typename T>
__global__ void __launch_bounds__(DC_THREADS)
    efta_attention_kernel_dexp(const DParams C) {
  const Params& P = C.P;
  const DLayout& L = C.L;
  PHASE_INIT
  const int parts = L.parts, keys = L.keys, res = L.res;
  const int j = blockIdx.x / parts, pt = blockIdx.x - j * parts;
  const DUnit u(P, C.n_rg, blockIdx.y);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nthr = blockDim.x, nwarp = nthr >> 5;
  const int D = P.D, Bc = P.block_kv, skv = P.s_kv, sout = P.s_out,
            ldk = L.ldk;
  const int g_kv = Bc / skv, g_out = D / sout, i0 = pt * res,
            kv_start = j * Bc;
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const float MASK_HALF = (float)(MASK_D / 2);
  const int slot = j * parts + pt;
  if (!dc_runs(P, u.iq, j)) {
    if (tid < u.nr) {
      int* rp = dc_rep(P, parts, u.bh0 + tid, u.iq, slot);
      rp[1] = rp[2] = rp[3] = rp[4] = 0;
    }
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  T* vs = (T*)smem;
  float* ss = (float*)(smem + L.b_s);
  float* pb = (float*)(smem + L.b_p);
  float* sc1 = (float*)(smem + L.b_sc1);
  float* vc1 = (float*)(smem + L.b_vc);
  float* vc2 = vc1 + keys * sout;
  float* ms_s = (float*)(smem + L.b_ms);
  float* red = (float*)(smem + L.b_red);
  float* stage = (float*)(smem + L.b_stage);
  const size_t unit_slot = (size_t)blockIdx.y * P.n_kv;
  const float* wj = P.ws + (unit_slot + j) * L.floats;
  float* part = P.ws + (unit_slot + j) * L.floats + L.part +
                (size_t)pt * L.part_floats;

  // V, then the score pass's scores, checksum products and (per KV block
  // chunk) block maxima of this part: cp.async, all in flight at once
  dc_load_strip<T>(vs,
                   (const T*)P.v +
                       ((size_t)u.kvh * P.Skv + kv_start + i0) * D,
                   L, D, skv);
  cp_async_commit();
  const Div dkeys(keys), dres(res), dsout(sout), dpr(parts * u.nr),
      dnr(u.nr);
  for (int e = tid; e < u.nr * keys; e += nthr) {
    const int r = dkeys.q(e), kk = e - r * keys;
    const int l = dres.q(kk);
    cp_async4(ss + e, wj + L.s + r * Bc + l * skv + i0 + (kk - l * res));
  }
  for (int e = tid; e < u.nr * res; e += nthr) {
    const int r = dres.q(e), ii = e - r * res;
    cp_async4(sc1 + e, wj + L.sc1 + r * skv + i0 + ii);
  }
  auto stage_maxima = [&](int jb, int n) {
    for (int e = tid; e < n * parts * u.nr; e += nthr) {
      const int jj = dpr.q(e), rem = e - jj * parts * u.nr;
      const int p = dnr.q(rem), r = rem - p * u.nr;
      if (dc_runs(P, u.iq, jb + jj))
        cp_async4(stage + e, P.ws + (unit_slot + jb + jj) * L.floats + L.bm +
                                 p * DC_ROWS + r);
    }
  };
  stage_maxima(0, min(DC_CHAIN, j + 1));
  cp_async_commit();
  // ---- the running max, replayed in block order up to this block ----
  {
    float m = (float)MASK_D;
    const bool mflip = u.fr >= 0 && P.fault[F_SITE] == S_ROWMAX;
    for (int jb = 0; jb <= j; jb += DC_CHAIN) {
      const int n = min(DC_CHAIN, j + 1 - jb);
      if (jb > 0) {
        stage_maxima(jb, n);
        cp_async_commit();
      }
      cp_async_wait(0);
      __syncthreads();
      if (w < u.nr) {
        float bm = -INFINITY;
        if (lane < n && dc_runs(P, u.iq, jb + lane)) {
          const float* st = stage + lane * parts * u.nr + w;
          bm = st[0];
          for (int p = 1; p < parts; ++p) bm = nan_max(bm, st[p * u.nr]);
        }
        const int fl = P.fault[F_BLOCK] - jb;
        const bool fhit = mflip && w == u.fr && fl >= 0 && fl < n &&
                          dc_runs(P, u.iq, P.fault[F_BLOCK]);
        bool bad;
        const float v = dc_scan_max(P, m, bm, lane, fhit ? fl : -1, &bad);
        if (lane == j - jb) ms_s[w] = v > MASK_HALF ? v : 0.f;
        m = __shfl_sync(FULL, v, n - 1);
      }
      __syncthreads();
    }
  }
  PHASE_MARK(4)

  // ---- row phases, a warp a row: EXP (paper Case 2), its product-fold
  //      check and backstop, mask, the rowsum terms; p over the raw p ----
  if (w < u.nr) {
    const int r = w;
    const float ms = ms_s[r];
    const float* srow = ss + r * keys;
    float* prow = pb + r * keys;
    const bool ehit = r == u.fr && P.fault[F_SITE] == S_EXP &&
                      P.fault[F_BLOCK] == j;
    int det = 0;
    for (int kk = lane; kk < keys; kk += 32) {
      float x = expf(nan_min(srow[kk] - ms, P.cap));
      if (ehit) {
        const int l = dres.q(kk);
        if (l * skv + i0 + (kk - l * res) == P.fault[F_COL])
          x = flip_bit(x, P.fault[F_BIT]);
      }
      prow[kk] = x;
    }
    __syncwarp();
    if (ft) {
      for (int ii = lane; ii < res; ii += 32) {
        float prod = 1.f;
        bool col_ok = true;
#pragma unroll 4
        for (int l = 0; l < g_kv; ++l) {
          prod = prod * prow[l * res + ii];
          col_ok = col_ok && !((srow[l * res + ii] - ms) > P.cap_m);
        }
        const float pc1 =
            expf(nan_min(sc1[r * res + ii] - (float)g_kv * ms, P.cap_g));
        const float ref = nan_max(fabsf(pc1), 1e-20f);
        const bool bad =
            col_ok && (fabsf(prod - pc1) > P.eps2 * ref + 1e-20f);
        det += bad;
        if (correct && bad)
          for (int l = 0; l < g_kv; ++l)
            prow[l * res + ii] = expf(nan_min(srow[l * res + ii] - ms, P.cap));
      }
      __syncwarp();
    }
    float s1 = 0.f, s2 = 0.f;
    for (int kk = lane; kk < keys; kk += 32) {
      const float sv = srow[kk];
      float x = prow[kk];
      if (ft && P.shadow_rowmax && correct) {
        // exact recompute backstop
        const float rc = expf(nan_min(sv - ms, P.cap));
        const bool slipped = x != rc;
        det += slipped;
        if (slipped) x = rc;
      }
      const int l = dres.q(kk);
      x = dc_visible(P, u.iq, kv_start + l * skv + i0 + (kk - l * res)) ? x
                                                                         : 0.f;
      prow[kk] = x;
      s1 = s1 + x;
      s2 = s2 + opaque(x);
    }
    for (int o = 16; o > 0; o >>= 1) {
      s1 = s1 + __shfl_xor_sync(FULL, s1, o);
      s2 = s2 + opaque(__shfl_xor_sync(FULL, s2, o));
      det += __shfl_xor_sync(FULL, det, o);
    }
    if (lane == 0) {
      part[L.p_ps + r] = s1;
      part[L.p_ps2 + r] = s2;
      int* rp = dc_rep(P, parts, u.bh0 + r, u.iq, slot);
      rp[1] = det;
      rp[2] = rp[3] = rp[4] = 0;
    }
  }
  PHASE_MARK(5)
  __syncthreads();  // every row's p is in (V landed before the replay)
  PHASE_MARK(6)

  // ---- the V column checksums of the part's keys and their max|V| ----
  float vm = 0.f;
  if (ft) {
    for (int e = tid; e < keys * sout; e += nthr) {
      const int kk = dsout.q(e), i = e - kk * sout;
      float f1 = 0.f, f2 = 0.f;
#pragma unroll 8
      for (int l = 0; l < g_out; ++l) {
        const float x = to_f(vs[kk * ldk + l * sout + i]);
        f1 = f1 + x;
        f2 = f2 + (float)(l + 1) * x;
        vm = nan_max(vm, fabsf(x));
      }
      vc1[e] = f1;
      vc2[e] = f2;
    }
  }
  __syncthreads();
  // ---- GEMM II from zero, p rounded to T ----
  if constexpr (sizeof(T) == 2) {
    // mma.sync m16n8k16: the unit's rows x 8 columns of D a warp's n-tile,
    // p from shared memory packed to bf16 (rows past the unit's as 0), V
    // through ldmatrix.trans
    const int g = lane >> 2, t4 = lane & 3, l16 = lane & 15;
    for (int nt = w; nt * 8 < D; nt += nwarp) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kq = 0; kq < keys / 16; ++kq) {
        const int k = kq * 16 + 2 * t4;
        float2 x0 = make_float2(0.f, 0.f), x2 = x0;
        if (g < u.nr) {
          x0 = *reinterpret_cast<const float2*>(pb + g * keys + k);
          x2 = *reinterpret_cast<const float2*>(pb + g * keys + k + 8);
        }
        const uint32_t a[4] = {pack_bf16(x0.x, x0.y), 0u,
                               pack_bf16(x2.x, x2.y), 0u};
        uint32_t b[2];
        ldmatrix_x2_trans(b, vs + (kq * 16 + l16) * ldk + nt * 8);
        mma_bf16(c, a, b);
      }
      if (g < u.nr)
        *reinterpret_cast<float2*>(part + g * D + nt * 8 + 2 * t4) =
            make_float2(c[0], c[1]);
    }
  } else {
    const int half = D / 2;
    const Div dhalf(half);
    for (int e = tid; e < u.nr * half; e += nthr) {
      const int r = dhalf.q(e), d = 2 * (e - r * half);
      const float* prow = pb + r * keys;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < keys; ++kk) {
        const float pr = prow[kk];
        const T* vr = vs + kk * ldk + d;
        a0 = fmaf(pr, to_f(vr[0]), a0);
        a1 = fmaf(pr, to_f(vr[1]), a1);
      }
      *reinterpret_cast<float2*>(part + r * D + d) = make_float2(a0, a1);
    }
  }
  // ---- the O-checksum products (the f32 p): each (row, column) over
  //      groups of keys side by side, then the groups summed in order ----
  if (ft) {
    float* ocp = (float*)(smem + L.b_ocp);
    const int noc = u.nr * sout;
    // at most 8 groups: their sum is a chain too
    int kg = nthr / noc;
    kg = kg < 1 ? 1 : kg > 8 ? 8 : kg;
    const int kpg = (keys + kg - 1) / kg;
    const Div dkg(kg);
    for (int e = tid; e < noc * kg; e += nthr) {
      const int o = dkg.q(e), gi = e - o * kg;
      const int r = dsout.q(o), i = o - r * sout;
      const float* prow = pb + r * keys;
      float a1 = 0.f, a2 = 0.f;
      const int k1 = min(keys, (gi + 1) * kpg);
      for (int kk = gi * kpg; kk < k1; ++kk) {
        a1 = fmaf(prow[kk], vc1[kk * sout + i], a1);
        a2 = fmaf(prow[kk], vc2[kk * sout + i], a2);
      }
      ocp[2 * e] = a1;
      ocp[2 * e + 1] = a2;
    }
    __syncthreads();
    for (int o = tid; o < noc; o += nthr) {
      const int r = dsout.q(o), i = o - r * sout;
      float a1 = ocp[2 * o * kg], a2 = ocp[2 * o * kg + 1];
      for (int gi = 1; gi < kg; ++gi) {
        a1 = a1 + ocp[2 * (o * kg + gi)];
        a2 = a2 + ocp[2 * (o * kg + gi) + 1];
      }
      part[L.p_oc1 + r * sout + i] = a1;
      part[L.p_oc2 + r * sout + i] = a2;
    }
  }
  // ---- the part's max|V| ----
  for (int o = 16; o > 0; o >>= 1)
    vm = nan_max(vm, __shfl_xor_sync(FULL, vm, o));
  if (lane == 0) red[w] = vm;
  __syncthreads();
  if (tid == 0) {
    float v = red[0];
    for (int i = 1; i < nwarp; ++i) v = nan_max(v, red[i]);
    part[L.p_vm] = v;
  }
  PHASE_MARK(7)
  PHASE_FLUSH
}

// grid (units, min(grp, DC_ROWS)): one CTA a query row
template <typename T>
__global__ void __launch_bounds__(DC_STATE_THREADS)
    efta_attention_kernel_dstate(const DParams C) {
  const Params& P = C.P;
  const DLayout& L = C.L;
  PHASE_INIT
  const DUnit u(P, C.n_rg, blockIdx.x);
  const int r = blockIdx.y;
  if (r >= u.nr) return;
  const int parts = L.parts;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int D = P.D, sout = P.s_out, g_out = D / sout;
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const float MASK_HALF = (float)(MASK_D / 2);
  const int bh = u.bh0 + r;
  const bool rhit = r == u.fr;
  const int f_site = P.fault[F_SITE], f_blk = P.fault[F_BLOCK],
            f_col = P.fault[F_COL], f_bit = P.fault[F_BIT];
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = (float*)(smem + L.c_stage);  // [jj][p][4]
  float* pv_s = (float*)(smem + L.c_pv);      // [jj][p][D]
  float* oc_s = (float*)(smem + L.c_oc);      // [jj][p][2][s_out]
  float* o_s = (float*)(smem + L.c_o);
  int* run_s = (int*)(smem + L.c_run);
  float* alpha_s = (float*)(smem + L.c_alpha);
  float* rterm_s = (float*)(smem + L.c_rterm);
  float* tail = (float*)(smem + L.c_tail);
  int* redi = (int*)(tail + 2);
  const size_t unit_slot = (size_t)blockIdx.x * P.n_kv;

  // state: m, l, shadow l, r on thread 0; the accumulator columns d =
  // tid, tid + 128; the O checksums i = tid < s_out
  float m = (float)MASK_D, l = 0.f, lsh = 0.f, rr = 0.f, vmax = 0.f;
  int det2 = 0, det3 = 0, det4 = 0;
  float acc[2] = {0.f, 0.f}, oc1 = 0.f, oc2 = 0.f;
  const Div dparts(parts), dD4(D / 4), dsout(sout);
  const int nd4 = D / 4;
  for (int jb = 0; jb < P.n_kv; jb += L.chain) {
    const int n = min(L.chain, P.n_kv - jb);
    // the chunk's per-part terms by cp.async, all in flight at once: block
    // max, rowsum, shadow rowsum, max|V|; the P V row; the O-checksum rows
    for (int e = tid; e < n * parts; e += DC_STATE_THREADS) {
      const int jj = dparts.q(e), p = e - jj * parts;
      if (!dc_runs(P, u.iq, jb + jj)) continue;
      const float* wj = P.ws + (unit_slot + jb + jj) * L.floats;
      const float* pp = wj + L.part + (size_t)p * L.part_floats;
      cp_async4(stage + 4 * e, wj + L.bm + p * DC_ROWS + r);
      cp_async4(stage + 4 * e + 1, pp + L.p_ps + r);
      cp_async4(stage + 4 * e + 2, pp + L.p_ps2 + r);
      cp_async4(stage + 4 * e + 3, pp + L.p_vm);
    }
    for (int e = tid; e < n * parts * nd4; e += DC_STATE_THREADS) {
      const int jp = dD4.q(e), d4 = e - jp * nd4;
      const int jj = dparts.q(jp), p = jp - jj * parts;
      if (!dc_runs(P, u.iq, jb + jj)) continue;
      cp_async16(pv_s + jp * D + 4 * d4,
                 P.ws + (unit_slot + jb + jj) * L.floats + L.part +
                     (size_t)p * L.part_floats + r * D + 4 * d4);
    }
    if (ft)
      for (int e = tid; e < n * parts * 2 * sout; e += DC_STATE_THREADS) {
        const int jpc = dsout.q(e), i = e - jpc * sout;
        const int jp = jpc >> 1, which = jpc & 1;
        const int jj = dparts.q(jp), p = jp - jj * parts;
        if (!dc_runs(P, u.iq, jb + jj)) continue;
        cp_async4(oc_s + e, P.ws + (unit_slot + jb + jj) * L.floats + L.part +
                                (size_t)p * L.part_floats +
                                (which ? L.p_oc2 : L.p_oc1) + r * sout + i);
      }
    cp_async_commit();
    cp_async_wait(0);
    __syncthreads();
    // each block's terms, its parts combined in order, a thread a block
    if (tid < n) {
      run_s[tid] = dc_runs(P, u.iq, jb + tid);
      if (run_s[tid]) {
        float* st = stage + 4 * tid * parts;
        for (int p = 1; p < parts; ++p) {
          st[0] = nan_max(st[0], st[4 * p]);
          st[1] = st[1] + st[4 * p + 1];
          st[2] = st[2] + st[4 * p + 2];
          st[3] = nan_max(st[3], st[4 * p + 3]);
        }
      }
    }
    __syncthreads();
    // the running max by a warp scan (its SEU and shadow with it); then a
    // lane a block: the rescale factor, m or 0, the SNVR tracker's term
    if (w == 0) {
      const bool run = lane < n && run_s[lane];
      const float bm = run ? stage[4 * lane * parts] : -INFINITY;
      const int fl = f_blk - jb;
      const bool fhit = rhit && f_site == S_ROWMAX && fl >= 0 && fl < n &&
                        dc_runs(P, u.iq, f_blk);
      bool bad;
      const float v = dc_scan_max(P, m, bm, lane, fhit ? fl : -1, &bad);
      if (lane == 0) det2 += bad;
      float mp = __shfl_up_sync(FULL, v, 1);
      if (lane == 0) mp = m;
      if (run) {
        const bool alive = v > MASK_HALF;
        const float msub = alive ? v : 0.f;
        alpha_s[lane] = alive ? expf(mp - v) : 1.f;
        rterm_s[lane] = bm > MASK_HALF ? expf(bm - msub) : 0.f;
      }
      m = __shfl_sync(FULL, v, n - 1);
    }
    __syncthreads();
    // l, the shadow l and r in block order
    if (tid == 0) {
      for (int jj = 0; jj < n; ++jj) {
        if (!run_s[jj]) continue;
        const float* st = stage + 4 * jj * parts;
        const float alpha = alpha_s[jj];
        float ln = alpha * l + st[1];
        if (rhit && f_site == S_ROWSUM && f_blk == jb + jj)
          ln = flip_bit(ln, f_bit);
        l = ln;
        if (ft && P.shadow_rowsum) lsh = alpha * lsh + st[2];
        rr = alpha * rr + rterm_s[jj];
        if (ft) vmax = nan_max(vmax, st[3]);
      }
    }
    // ---- the accumulator and the O checksums, rescaled and summed in
    //      block order (the GEMM II SEU site), each block's parts summed
    //      in order ----
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = tid + DC_STATE_THREADS * h;
      if (d < D) {
        float a = acc[h];
        for (int jj = 0; jj < n; ++jj) {
          if (!run_s[jj]) continue;
          const float* pr = pv_s + jj * parts * D + d;
          float pv = pr[0];
          for (int p = 1; p < parts; ++p) pv = pv + pr[p * D];
          float an = alpha_s[jj] * a + pv;
          if (rhit && f_site == S_GEMM2 && f_blk == jb + jj && d == f_col)
            an = flip_bit(an, f_bit);
          a = an;
        }
        acc[h] = a;
      }
    }
    if (ft && tid < sout) {
      for (int jj = 0; jj < n; ++jj) {
        if (!run_s[jj]) continue;
        const float* pr = oc_s + jj * parts * 2 * sout + tid;
        float b1 = pr[0], b2 = pr[sout];
        for (int p = 1; p < parts; ++p) {
          b1 = b1 + pr[p * 2 * sout];
          b2 = b2 + pr[p * 2 * sout + sout];
        }
        oc1 = alpha_s[jj] * oc1 + b1;
        oc2 = alpha_s[jj] * oc2 + b2;
      }
    }
    __syncthreads();  // the stage and alpha are free for the next blocks
  }
  PHASE_MARK(8)

  // ---- finalize: SNVR on l + unified output verification ----
  if (tid == 0) {
    float lf = l;
    if (ft) {
      const bool in_range = lf >= rr - 1e-3f && lf <= P.upper && isfinite(lf);
      bool bad;
      float fallback;
      if (P.shadow_rowsum) {
        const bool mism = fabsf(lf - lsh) > 1e-5f * nan_max(fabsf(lsh), 1e-6f);
        bad = (!in_range || mism) && rr > 0.f;
        const bool fb_ok = lsh >= rr - 1e-3f && lsh <= P.upper && isfinite(lsh);
        fallback = fb_ok ? lsh : rr;
      } else {
        bad = !in_range && rr > 0.f;
        fallback = rr;
      }
      det3 += bad;
      if (correct && bad) lf = fallback;
    }
    tail[0] = lf == 0.f ? 1.f : lf;
    tail[1] = vmax;
  }
  __syncthreads();
  const float ls = tail[0], bound = tail[1] * 1.001f + 1e-6f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int d = tid + DC_STATE_THREADS * h;
    if (d < D) {
      float o = acc[h] / ls;
      if (ft && correct) o = (isfinite(o) && fabsf(o) <= bound) ? o : 0.f;
      o_s[d] = o;
    }
  }
  __syncthreads();
  if (ft && tid < sout) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
    for (int k = 0; k < g_out; ++k) {
      const float x = o_s[k * sout + tid];
      s1 = s1 + x;
      s2 = s2 + (float)(k + 1) * x;
    }
    const float d1 = oc1 / ls - s1, d2 = oc2 / ls - s2;
    const bool bad = !(fabsf(d1) <= P.eps3);
    det4 += bad;
    if (correct && bad) o_s[seg_of(d1, d2, g_out) * sout + tid] += d1;
  }
  __syncthreads();
  T* og = (T*)P.out + ((size_t)bh * P.Sq + u.iq) * D;
  for (int d = tid; d < D; d += DC_STATE_THREADS) og[d] = from_f<T>(o_s[d]);
  // ---- the row's counts: threads in order, no atomics ----
  for (int o = 16; o > 0; o >>= 1) det4 += __shfl_xor_sync(FULL, det4, o);
  if (lane == 0) redi[w] = det4;
  __syncthreads();
  if (tid == 0) {
    int tot = 0;
    for (int i = 0; i < DC_STATE_THREADS / 32; ++i) tot += redi[i];
    int* rp = dc_rep(P, parts, bh, u.iq, P.n_kv * parts);
    rp[0] = rp[1] = 0;
    rp[2] = det2;
    rp[3] = det3;
    rp[4] = tot;
  }
  PHASE_MARK(9)
  PHASE_FLUSH
}

// the three passes on `stream`; each launch's error returned
template <typename T>
cudaError_t launch_decode(const DParams& c, cudaStream_t stream) {
  const DLayout& L = c.L;
  const int units = c.P.BH / c.P.grp * c.n_rg * c.P.n_q;
  const dim3 grid(c.P.n_kv * L.parts, units);
  cudaError_t err = cudaFuncSetAttribute(
      efta_attention_kernel_dscore<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.a_total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(efta_attention_kernel_dexp<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.b_total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(efta_attention_kernel_dstate<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.c_total);
  if (err != cudaSuccess) return err;
  // eight warps where the grid leaves SMs with fewer than two CTAs (t5's
  // 256: the per-key work of one row spreads wider), else a warp a row
  // and at least four (the VLM's 1,600: more CTAs resident an SM); on the
  // card each measured faster at its own grid
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int nr = c.P.grp < DC_ROWS ? c.P.grp : DC_ROWS;
  const int threads = (long long)grid.x * grid.y < 2LL * sms
                          ? DC_THREADS
                          : 32 * (nr > 4 ? nr : 4);
  efta_attention_kernel_dscore<T><<<grid, threads, L.a_total, stream>>>(c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  efta_attention_kernel_dexp<T><<<grid, threads, L.b_total, stream>>>(c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  efta_attention_kernel_dstate<T>
      <<<dim3(units, c.P.grp < DC_ROWS ? c.P.grp : DC_ROWS),
         DC_STATE_THREADS, L.c_total, stream>>>(c);
  return cudaGetLastError();
}
