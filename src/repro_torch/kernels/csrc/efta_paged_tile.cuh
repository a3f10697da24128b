// Kernel B1's tile layout, for the chunk path in bf16 (grp x C >= 64; the
// design note is at the head of efta_paged.cu). Included by efta_paged.cu
// inside its anonymous namespace, after Params, warp_fold_bad, the
// fault-descriptor indices and efta_hopper.cuh.
//
// Two kernels a launch. The fold pass (efta_paged_kernel_fold) takes each
// (request, KV head, running block) once and writes what depends on that
// block alone into a scratch tensor that the wrapper allocates: the K folds
// at the ABFT stride as bf16 high and low parts (16 rows of wgmma's B
// operand, beside the block's 16 keys), the V column checksums, max|V|, and
// the site-6 check against the resident planes (the bad plane). The tile
// kernel (efta_paged_kernel_tile) then runs 64 rows of one (request, KV
// head) against every running block, one CTA a tile: 16 consumer warps
// (four warpgroups) and a producer warpgroup that gathers each step's K
// and V blocks through the block table into an mbarrier ring.

// rows a CTA: one wgmma M tile; its consumer warpgroups
constexpr int PT_ROWS = 64, PT_WG = 4;
constexpr int PT_NT = 32 * 4 * PT_WG;  // consumer threads
// KV blocks a step (one a warpgroup in GEMM I), keys a block, the ABFT
// stride, rows a warp in the row phases
constexpr int PT_G = 4, PT_BS = 16, PT_SKV = 4, PT_RPW = 4;
constexpr int PT_GKV = PT_BS / PT_SKV;
// GEMM II n-tiles of 8 columns a warpgroup at most (D <= 128)
constexpr int PT_NT2 = 4;
constexpr int PT_FOLD_THREADS = 128;

// the fold pass's output for one (request, KV head, block), offsets in
// floats: 16 rows x D bf16 in 8 x 8 core matrices (rows 4 p + i: the K fold
// f1 high part at residue i (p 0), f2 high (1), f1 low (2), f2 low (3)),
// the V column checksums [16 keys][ldv] f32 (f1 at column i < s_out, f2
// at s_out + i), max|V| (padded to 16 bytes)
struct PFold {
  int ldv, vcs, vmax, floats;
};

PFold make_pfold(int D, int sout) {
  PFold F;
  F.ldv = (2 * sout + 3) & ~3;
  F.vcs = 8 * D;
  F.vmax = F.vcs + PT_BS * F.ldv;
  F.floats = F.vmax + 4;
  return F;
}

// shared-memory layout of one CTA of the tile layout (byte offsets)
struct PTLayout {
  int lds;      // score row stride, floats
  int ldo;      // the output's row stride at the finalize, floats
  size_t slot;  // one block: K and its fold rows (32 x D), V (16 x D), the
                // V column checksums (16 x ldv f32)
  size_t ring, qs, sp, sc, row, oc, red, bar, total;
};

// ST ring stages of PT_G blocks
PTLayout make_ptile_layout(int ST, int D, int sout) {
  PTLayout L;
  const PFold F = make_pfold(D, sout);
  L.lds = PT_G * PT_BS + 4;  // (row, residue) lanes of 2 blocks: no conflict
  L.ldo = D + 1;
  L.slot = (size_t)48 * D * 2 + (size_t)(F.vmax - F.vcs) * 4;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t o = off;
    off += (bytes + 15) & ~(size_t)15;
    return o;
  };
  const size_t sc2 = 2 * (size_t)PT_ROWS * L.lds,
               fin = (size_t)PT_ROWS * L.ldo;
  L.ring = take((size_t)ST * PT_G * L.slot);
  L.qs = take((size_t)PT_ROWS * D * 2);
  // two steps' scores, then p (GEMM II of one step runs beside GEMM I of
  // the next); at the end the output rows
  L.sp = take(4 * (sc2 > fin ? sc2 : fin));
  // GEMM I's checksum products Q fold(K)^T: [block][fold][row][residue]
  L.sc = take((size_t)PT_G * 2 * PT_ROWS * PT_SKV * 4);
  // m, l, shadow l, r, safe l; a step's block max, m after the block,
  // rowsum, shadow rowsum, SNVR term [block][row]; alpha [2][block][row];
  // max|V|
  L.row = take(((5 + 5 * PT_G + 2 * PT_G) * (size_t)PT_ROWS + 4) * 4);
  L.oc = take(2 * (size_t)PT_ROWS * sout * 4);
  L.red = take((size_t)(PT_NT / 32) * 8 * 4);
  L.bar = take(2 * (size_t)ST * 8);
  L.total = off;
  return L;
}

struct PTParams {
  Params P;  // P.L is unused; P.ST: ring stages
  PTLayout L;
  PFold F;
  float* ws;  // the fold pass's output, (B, Hkv, mb) slots of F.floats
};

// grid (mb, Hkv, B): one block of 128 threads a (table block, KV head,
// request). The block's K and V are staged in shared memory by 16-byte
// loads first (each entry below is a chain of dependent loads and adds;
// from global memory the pass was latency-bound). Sums in segment order,
// as the first layout forms them: the K folds f1 = sum_l K[l s_kv + i], f2
// = sum_l (l + 1) K[l s_kv + i], the V column checksums likewise over the
// columns l s_out + i of a key.
__global__ void __launch_bounds__(PT_FOLD_THREADS)
    efta_paged_kernel_fold(const PTParams C) {
  using T = __nv_bfloat16;
  const Params& P = C.P;
  const PFold& F = C.F;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int D = P.D, cs = P.cs, sout = P.s_out, mb = P.mb;
  const int g_out = D / sout, ldv = F.ldv;
  const size_t bh = (size_t)b * P.Hkv + h;
  const int kv_len = P.kv_lens[b], base = kv_len - P.q_lens[b];
  const bool runs =
      j * PT_BS < kv_len && base - (j * PT_BS + PT_BS - 1) < P.window;
  if (P.mode == 0 || !runs) {
    // a block that does not run (or is not verified) is not bad
    if (tid == 0) P.bad[bh * mb + j] = 0;
    return;
  }
  const int bid = P.bt[(size_t)b * mb + j];
  const size_t blk = (size_t)bid * P.Hkv + h;
  const T* kb = (const T*)P.k + blk * PT_BS * D;
  const T* vb = (const T*)P.v + blk * PT_BS * D;
  float* out = C.ws + (bh * mb + j) * (size_t)F.floats;
  T* ext = (T*)out;
  __shared__ __align__(16) T kv[2][PT_BS * 32 * PT_NT2];
  __shared__ float red[PT_FOLD_THREADS / 32];
  __shared__ int badkv[2];
  float vm = 0.f;
  for (int e = tid; e < 2 * PT_BS * D / 8; e += PT_FOLD_THREADS) {
    const int t = e >= PT_BS * D / 8, o = (e - t * PT_BS * D / 8) * 8;
    const uint4 x = *(const uint4*)((t ? vb : kb) + o);
    *(uint4*)(&kv[t][o]) = x;
    if (t) {
      float f[8];
      load_row<T, 8>(f, &kv[t][o]);
#pragma unroll
      for (int k = 0; k < 8; ++k) vm = fmax_nan(vm, fabsf(f[k]));
    }
  }
  __syncthreads();
  const Div dD(D);
  for (int e = tid; e < PT_SKV * D; e += PT_FOLD_THREADS) {
    const int i = dD.q(e), d = e - i * D;
    float f1 = 0.f, f2 = 0.f;
#pragma unroll
    for (int l = 0; l < PT_GKV; ++l) {
      const float x = to_f(kv[0][(l * PT_SKV + i) * D + d]);
      f1 = f1 + x;
      f2 = f2 + (float)(l + 1) * x;
    }
    const T h1 = __float2bfloat16(f1), h2 = __float2bfloat16(f2);
    ext[cm(i, d, D)] = h1;
    ext[cm(PT_SKV + i, d, D)] = h2;
    ext[cm(2 * PT_SKV + i, d, D)] = __float2bfloat16(f1 - __bfloat162float(h1));
    ext[cm(3 * PT_SKV + i, d, D)] = __float2bfloat16(f2 - __bfloat162float(h2));
  }
  for (int e = tid; e < PT_BS * ldv; e += PT_FOLD_THREADS) {
    const int c = e / ldv, col = e - c * ldv;
    float val = 0.f;
    if (col < 2 * sout) {
      const int i = col < sout ? col : col - sout;
      float f1 = 0.f, f2 = 0.f;
      for (int l = 0; l < g_out; ++l) {
        const float x = to_f(kv[1][c * D + l * sout + i]);
        f1 = f1 + x;
        f2 = f2 + (float)(l + 1) * x;
      }
      val = col < sout ? f1 : f2;
    }
    out[F.vcs + e] = val;
  }
  for (int o = 16; o > 0; o >>= 1)
    vm = fmax_nan(vm, __shfl_xor_sync(FULL, vm, o));
  if (lane == 0) red[w] = vm;
  // site 6 (kv): the block re-folded against its resident planes, K by
  // warp 0 and V by warp 1
  if (w < 2) {
    const size_t po = blk * cs * D;
    const bool bad =
        w == 0 ? warp_fold_bad<T>(kv[0], D, (const T*)P.kc1 + po,
                                  (const T*)P.kc2 + po, cs, PT_BS, D,
                                  P.kv_thr, lane)
               : warp_fold_bad<T>(kv[1], D, (const T*)P.vc1 + po,
                                  (const T*)P.vc2 + po, cs, PT_BS, D,
                                  P.kv_thr, lane);
    if (lane == 0) badkv[w] = bad;
  }
  __syncthreads();
  if (tid == 0) {
    float v = red[0];
    for (int i = 1; i < PT_FOLD_THREADS / 32; ++i) v = fmax_nan(v, red[i]);
    out[F.vmax] = v;
    P.bad[bh * mb + j] = (badkv[0] || badkv[1]) && bid > 0;
  }
}

// grid (tiles, Hkv, B): one CTA a 64-row tile of one (request, KV head)
__global__ void __launch_bounds__(PT_NT + PRODUCER_THREADS, 1)
    efta_paged_kernel_tile(const PTParams C) {
  using T = __nv_bfloat16;
  const Params& P = C.P;
  const PTLayout& L = C.L;
  const PFold& F = C.F;
  PHASE_INIT
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int ST = P.ST, D = P.D, R = P.R, mb = P.mb, sout = P.s_out,
            ldv = F.ldv;
  const int lds = L.lds, ldo = L.ldo;
  const int row0 = tile * PT_ROWS;
  const int nrows = min(PT_ROWS, R - row0);  // rows below R: counted
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const int g_out = D / sout;
  const float MASK_VALUE = (float)MASK_D;
  const float MASK_HALF = (float)(MASK_D / 2);
  const float cap = (float)(80.0 / PT_GKV);
  const float cap_g = (float)(80.0 / PT_GKV * PT_GKV);
  const float cap_m = (float)(80.0 / PT_GKV - 1e-3);
  const int kv_len = P.kv_lens[b], q_len = P.q_lens[b];
  const int window = P.window, base = kv_len - q_len;
  const size_t bh = (size_t)b * P.Hkv + h;
  const int g = lane >> 2, t4 = lane & 3;
  const Div dC(P.chunk);
  const FDiv dD(D), dsout(sout), dper(D / 8);
  // the SEU: its row in the tile
  const int f_row = P.fault[P_ROW] - row0;
  const bool f_t = P.fault[P_ON] == 1 && P.fault[P_B] == b &&
                   P.fault[P_H] == h && f_row >= 0 && f_row < nrows;
  const int f_site = P.fault[P_SITE], f_blk = P.fault[P_BLOCK],
            f_col = P.fault[P_COL], f_bit = P.fault[P_BIT];

  // the running blocks form one interval [j_lo, j_lo + n_run)
  auto runs = [&](int j) {
    return j * PT_BS < kv_len && base - (j * PT_BS + PT_BS - 1) < window;
  };
  int j_lo = 0;
  while (j_lo < mb && !runs(j_lo)) ++j_lo;
  int n_run = 0;
  while (j_lo + n_run < mb && runs(j_lo + n_run)) ++n_run;
  const int n_steps = (n_run + PT_G - 1) / PT_G;

  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = (T*)(smem + L.qs);
  float* sp_all = (float*)(smem + L.sp);
  float* sc = (float*)(smem + L.sc);
  float* m_s = (float*)(smem + L.row);
  float* l_s = m_s + PT_ROWS;
  float* lsh_s = l_s + PT_ROWS;
  float* r_s = lsh_s + PT_ROWS;
  float* lsafe_s = r_s + PT_ROWS;
  float* bm_s = lsafe_s + PT_ROWS;  // [block][row], and so on
  float* mn_s = bm_s + PT_G * PT_ROWS;
  float* ps_s = mn_s + PT_G * PT_ROWS;
  float* ps2_s = ps_s + PT_G * PT_ROWS;
  float* rt_s = ps2_s + PT_G * PT_ROWS;
  float* alpha_all = rt_s + PT_G * PT_ROWS;  // [2][block][row]
  float* vmax_s = alpha_all + 2 * PT_G * PT_ROWS;
  float* oc1 = (float*)(smem + L.oc);  // [row][s_out]
  float* oc2 = oc1 + PT_ROWS * sout;
  int* redi = (int*)(smem + L.red);
  uint64_t* full = (uint64_t*)(smem + L.bar);  // a stage has landed
  uint64_t* empty = full + ST;                 // every warp is done with it
  auto slot_of = [&](int step, int k) {
    return smem + L.ring + ((size_t)(step % ST) * PT_G + k) * L.slot;
  };
  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, PRODUCER_THREADS);
      mbar_init(empty + s, PT_NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the ring's mbarriers are ready

  // ---- the load stream: step s gathers blocks j_lo + 4 s + k (k < 4)
  //      through the block table into ring stage s % ST: K into rows 0..15
  //      of the block's 32-row B operand and its fold rows (from the fold
  //      pass) into rows 16..31, V, and V's column checksums. The producer
  //      warpgroup issues the copies (cp.async); a stage's `full` mbarrier
  //      completes when they have landed, its `empty` one when every
  //      consumer warp is done with it, and only then is it refilled ----
  if (tid >= PT_NT) {
    producer_regs();
    const int t0 = tid - PT_NT, per = D / 8;
    for (int s = 0; s < n_steps; ++s) {
      const int stage = s % ST;
      if (s >= ST) mbar_wait(empty + stage, (s / ST + 1) & 1);
      const int gv = min(PT_G, n_run - s * PT_G);
      for (int k = 0; k < gv; ++k) {
        const int j = j_lo + s * PT_G + k;
        const size_t blk = (size_t)P.bt[(size_t)b * mb + j] * P.Hkv + h;
        unsigned char* slot = slot_of(s, k);
        for (int t = 0; t < 2; ++t) {
          const T* src = (const T*)(t ? P.v : P.k) + blk * PT_BS * D;
          T* dst = (T*)slot + (t ? 32 * D : 0);
          // 16-byte pieces, eight neighbouring threads on one core matrix
          for (int e = t0; e < PT_BS * per; e += PRODUCER_THREADS) {
            const int rest = e >> 3, cg = dper.q(rest);
            const int c = cg * 8 + (e & 7), p8 = rest - cg * per;
            cp_async16(dst + cm(c, p8 * 8, D), src + (size_t)c * D + p8 * 8);
          }
        }
        if (ft) {
          const float* fo = C.ws + (bh * mb + j) * (size_t)F.floats;
          unsigned char* fd = slot + (size_t)16 * D * 2;
          for (int e = t0; e < 2 * D; e += PRODUCER_THREADS)
            cp_async16(fd + 16 * e, fo + 4 * e);
          unsigned char* vd = slot + (size_t)96 * D;
          for (int e = t0; e < PT_BS * ldv / 4; e += PRODUCER_THREADS)
            cp_async16(vd + 16 * e, fo + F.vcs + 4 * e);
        }
      }
      mbar_arrive_cp_async(full + stage);
    }
    return;
  }
  consumer_regs();
  // Q, and the running state, while the producer streams the first blocks
  {
    const T* qg = (const T*)P.q + (bh * R + row0) * D;
    for (int e = tid; e < PT_ROWS * (D / 8); e += PT_NT) {
      const int r = dper.q(e), d = (e - r * (D / 8)) * 8;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < nrows) x = *(const uint4*)(qg + (size_t)r * D + d);
      *(uint4*)(qs + cm(r, d, D)) = x;
    }
  }
  for (int e = tid; e < 2 * PT_ROWS * sout; e += PT_NT) oc1[e] = 0.f;
  for (int r = tid; r < PT_ROWS; r += PT_NT) {
    m_s[r] = MASK_VALUE;
    l_s[r] = lsh_s[r] = r_s[r] = 0.f;
  }
  int det[6] = {0, 0, 0, 0, 0, 0};
  fence_async_smem();  // Q is an operand of wgmma
  consumer_sync(PT_NT);
  PHASE_MARK(0)

  // warp w = (warpgroup wg, warp wk of it). GEMM I: block wg of the step,
  // rows 16 wk ..; GEMM II: rows 16 wk .., warpgroup wg's columns; the row
  // phases: rows 4 w .. 4 w + 3, all blocks of the step
  const int wg = w >> 2, wk = w & 3;
  // GEMM II: warpgroup wg's n-tiles nt2 (of D / 8, split as evenly as they
  // go) from column col2
  const int ntd = D / 8, ntb = ntd / 4, ntr = ntd - 4 * ntb;
  const int nt2 = ntb + (wg < ntr ? 1 : 0);
  const int col2 = 8 * (wg * ntb + min(wg, ntr));
  // the output accumulator of this thread: rows 16 wk + g (+ 8), columns
  // col2 + 8 k + 2 t4 (+ 1), wgmma's layout
  float acc[PT_NT2 * 4];
#pragma unroll
  for (int e = 0; e < PT_NT2 * 4; ++e) acc[e] = 0.f;
  // the row phases' lanes: (block 2 t + lane / 16, row lane / 4 % 4,
  // residue lane % 4) in pass t
  const int rq = (lane >> 2) & 3, iq = lane & 3;
  const int rl = PT_RPW * w + rq;  // the lane's row in the tile
  const int crow = dC.r(row0 + rl);
  const int qpos = base + crow;
  const bool qv = crow < q_len, counted = rl < nrows;

  for (int s = 0; s < n_steps; ++s) {
    const int stage = s % ST, buf = s & 1;
    const int gv = min(PT_G, n_run - s * PT_G), j0 = j_lo + s * PT_G;
    float* sp = sp_all + (size_t)buf * PT_ROWS * lds;
    float* alpha_s = alpha_all + buf * PT_G * PT_ROWS;
    mbar_wait(full + stage, (s / ST) & 1);
    fence_async_smem();
    __syncwarp();  // wgmma wants the warp converged
    PHASE_MARK(1)

    // ---- GEMM I + NVR clip: warpgroup wg takes block wg of the step, its
    //      16 keys and its 16 fold rows (the checksum products Q fold(K)^T,
    //      high and low parts summed) as one m64 n32 product over D ----
    if (wg < gv) {
      const int j = j0 + wg;
      const T* kb = (const T*)slot_of(s, wg);
      float c[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) c[e] = 0.f;
      const uint64_t da = wg_desc(qs, 128, 16 * D);
      const uint64_t db = wg_desc(kb, 128, 16 * D);
      reg_fence(c, 16);
      wg_fence();
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss<32>(c, da + 16 * ks, db + 16 * ks);
      wg_commit_wait();
      reg_fence(c, 16);
      const bool hit1 = f_t && f_site == S_GEMM1 && f_blk == j;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = 16 * wk + g + ((e & 3) >> 1) * 8;
        const int col = (e >> 2) * 8 + 2 * t4 + (e & 1);
        float sv = c[e] * P.scale;
        if (hit1 && r == f_row && col == f_col) sv = flip_bit(sv, f_bit);
        if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
        sp[r * lds + wg * PT_BS + col] = sv;
      }
      if (ft) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * wk + g + (e >> 1) * 8;
          const int col = 2 * t4 + (e & 1);  // fold (col / 4), residue
          sc[((wg * 2 + (col >> 2)) * PT_ROWS + r) * PT_SKV + (col & 3)] =
              (c[8 + e] + c[12 + e]) * P.scale;
        }
      }
    }
    PHASE_MARK(2)
    consumer_sync(PT_NT);  // every block's scores and checksum products
    PHASE_MARK(3)

    // ---- the row phases of rows 4 w .., lanes on (block, row, residue):
    //      the fold of S verified against the checksum products (locate +
    //      correct), the masked block max ----
    float bmr[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int k = 2 * t + (lane >> 4);
      const bool valid = k < gv;
      const int kv_start = (j0 + k) * PT_BS;
      float* scol = sp + rl * lds + k * PT_BS + iq;
      float bm = MASK_VALUE;
      if (valid) {
        if (ft) {
          float sum1 = 0.f, sum2 = 0.f;
#pragma unroll
          for (int l = 0; l < PT_GKV; ++l) {
            const float x = scol[l * PT_SKV];
            sum1 = sum1 + x;
            sum2 = sum2 + (float)(l + 1) * x;
          }
          const float* sck = sc + (k * 2 * PT_ROWS + rl) * PT_SKV + iq;
          const float d1 = sck[0] - sum1;
          const float d2 = sck[PT_ROWS * PT_SKV] - sum2;
          const bool bad = fabsf(d1) > P.eps1;
          if (counted) det[0] += bad;
          if (correct && bad) scol[seg_of(d1, d2, PT_GKV) * PT_SKV] += d1;
        }
#pragma unroll
        for (int l = 0; l < PT_GKV; ++l) {
          const int col = kv_start + l * PT_SKV + iq;
          const bool mk = col <= qpos && qpos - col < window && qv;
          bm = fmax_nan(bm, mk ? scol[l * PT_SKV] : MASK_VALUE);
        }
      }
      for (int o = PT_SKV >> 1; o > 0; o >>= 1)
        bm = fmax_nan(bm, __shfl_xor_sync(FULL, bm, o));
      bmr[t] = bm;
      if (valid && iq == 0) bm_s[k * PT_ROWS + rl] = bm;
    }
    __syncwarp();
    PHASE_MARK(4)

    // ---- the running max through the step's blocks 0 .. k, in order, with
    //      the shadow check (counted at the lane's own block), then EXP
    //      with checksum reuse (paper Case 2), backstop, mask, rowsum (+
    //      shadow); p is written over s ----
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int k = 2 * t + (lane >> 4);
      const bool valid = k < gv;
      float ps = 0.f, ps2 = 0.f, ms = 0.f;
      if (valid) {
        float mp = m_s[rl], mn = mp;
        for (int kk = 0; kk <= k; ++kk) {
          const float bm = bm_s[kk * PT_ROWS + rl];
          mp = mn;
          mn = fmax_nan(mp, bm);
          if (f_t && f_site == S_ROWMAX && f_blk == j0 + kk && rl == f_row)
            mn = flip_bit(mn, f_bit);
          if (ft && P.shadow_rowmax) {
            const float mc = fmax_nan(opaque(mp), bm);
            const bool bad = mn != mc;
            if (kk == k && iq == 0 && counted) det[2] += bad;
            if (correct && bad) mn = mc;
          }
        }
        const bool alive = mn > MASK_HALF;
        ms = alive ? mn : 0.f;
        if (iq == 0) {
          alpha_s[k * PT_ROWS + rl] = alive ? expf(mp - mn) : 1.f;
          mn_s[k * PT_ROWS + rl] = mn;
        }
        const int kv_start = (j0 + k) * PT_BS;
        const bool hit = f_t && f_site == S_EXP && f_blk == j0 + k &&
                         rl == f_row;
        float* srow = sp + rl * lds + k * PT_BS + iq;
        float pr[PT_GKV];
        float prod = 1.f;
        bool col_ok = true;
#pragma unroll
        for (int l = 0; l < PT_GKV; ++l) {
          const float sv = srow[l * PT_SKV];
          float x = expf(min_cap(sv - ms, cap));
          if (hit && l * PT_SKV + iq == f_col) x = flip_bit(x, f_bit);
          pr[l] = x;
          prod = prod * x;
          col_ok = col_ok && !((sv - ms) > cap_m);
        }
        if (ft) {
          const float sc1 = sc[(k * 2 * PT_ROWS + rl) * PT_SKV + iq];
          const float pc1 = expf(min_cap(sc1 - (float)PT_GKV * ms, cap_g));
          const float ref = fmax_nan(fabsf(pc1), 1e-20f);
          const bool bad =
              col_ok && (fabsf(prod - pc1) > P.eps2 * ref + 1e-20f);
          if (counted) det[1] += bad;
          if (correct && bad) {
#pragma unroll
            for (int l = 0; l < PT_GKV; ++l)
              pr[l] = expf(min_cap(srow[l * PT_SKV] - ms, cap));
          }
        }
#pragma unroll
        for (int l = 0; l < PT_GKV; ++l) {
          float x = pr[l];
          if (ft && P.shadow_rowmax && correct) {
            // exact recompute backstop
            const float rc = expf(min_cap(srow[l * PT_SKV] - ms, cap));
            const bool slipped = x != rc;
            if (counted) det[1] += slipped;
            if (slipped) x = rc;
          }
          const int col = kv_start + l * PT_SKV + iq;
          const bool mk = col <= qpos && qpos - col < window && qv;
          x = mk ? x : 0.f;
          srow[l * PT_SKV] = x;
          ps = ps + x;
          ps2 = ps2 + opaque(x);
        }
      }
      for (int o = PT_SKV >> 1; o > 0; o >>= 1) {
        ps = ps + __shfl_xor_sync(FULL, ps, o);
        ps2 = ps2 + opaque(__shfl_xor_sync(FULL, ps2, o));
      }
      if (valid && iq == 0) {
        ps_s[k * PT_ROWS + rl] = ps;
        ps2_s[k * PT_ROWS + rl] = ps2;
        rt_s[k * PT_ROWS + rl] =
            bmr[t] > MASK_HALF ? expf(bmr[t] - ms) : 0.f;
      }
    }
    __syncwarp();
    PHASE_MARK(5)

    // ---- the step's blocks into the running state, in block order:
    //      rescale + rowsum (+ shadow), SNVR, m; the O checksums ----
    if (lane < PT_RPW) {
      const int r = PT_RPW * w + lane;
      float l = l_s[r], lsh = lsh_s[r], rr = r_s[r];
      for (int k = 0; k < gv; ++k) {
        const float a = alpha_s[k * PT_ROWS + r];
        float ln = a * l + ps_s[k * PT_ROWS + r];
        if (f_t && f_site == S_ROWSUM && f_blk == j0 + k && r == f_row)
          ln = flip_bit(ln, f_bit);
        l = ln;
        if (ft && P.shadow_rowsum) lsh = a * lsh + ps2_s[k * PT_ROWS + r];
        rr = a * rr + rt_s[k * PT_ROWS + r];
      }
      l_s[r] = l;
      lsh_s[r] = lsh;
      r_s[r] = rr;
      m_s[r] = mn_s[(gv - 1) * PT_ROWS + r];
    }
    if (ft) {
      // each block's O-checksum products p V_cs from zero, then o = alpha
      // o + the product: lanes on (row, checksum column)
      const int nc = 2 * sout;
      for (int p = lane; p < PT_RPW * nc; p += 32) {
        const int rr = p / nc, col = p - rr * nc;
        const int r = PT_RPW * w + rr;
        float* op = col < sout ? oc1 + r * sout + col
                               : oc2 + r * sout + col - sout;
        float o = *op;
        for (int k = 0; k < gv; ++k) {
          const float* vk = (const float*)(slot_of(s, k) + (size_t)96 * D);
          const float* pk = sp + r * lds + k * PT_BS;
          float a1 = 0.f;
#pragma unroll
          for (int c = 0; c < PT_BS; ++c) a1 = fmaf(pk[c], vk[c * ldv + col], a1);
          o = alpha_s[k * PT_ROWS + r] * o + a1;
        }
        *op = o;
      }
    }
    PHASE_MARK(6)
    consumer_sync(PT_NT);  // every row's p and alpha are in
    __syncwarp();
    PHASE_MARK(7)

    // ---- GEMM II, a block at a time in block order: P V on wgmma, rows 16
    //      wk .. x warpgroup wg's columns, p from registers, V from shared
    //      memory as it stands (N-major), from zero; then acc = alpha acc +
    //      P V (the GEMM II SEU site) ----
    if (nt2 > 0) {
      const float* prow = sp + 16 * wk * lds;
      for (int k = 0; k < gv; ++k) {
        const T* vb = (const T*)slot_of(s, k) + 32 * D;
        const int kp = k * PT_BS + 2 * t4;
        float2 x[4];
        x[0] = *(const float2*)(prow + g * lds + kp);
        x[1] = *(const float2*)(prow + (g + 8) * lds + kp);
        x[2] = *(const float2*)(prow + g * lds + kp + 8);
        x[3] = *(const float2*)(prow + (g + 8) * lds + kp + 8);
        uint32_t a[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = pack_bf16(x[u].x, x[u].y);
        float pv[PT_NT2 * 4];
#pragma unroll
        for (int e = 0; e < PT_NT2 * 4; ++e) pv[e] = 0.f;
        const uint64_t dv = wg_desc(vb + cm(0, col2, D), 16 * D, 128);
        // nothing but the product between the fence and the wait: a branch
        // among them makes ptxas serialize the products
        auto gemm2 = [&](auto nn) {
          constexpr int N = decltype(nn)::value;
          reg_fence(pv, PT_NT2 * 4);
          wg_fence();
          wgmma_rs<N>(pv, a, dv);
          wg_commit_wait();
          reg_fence(pv, PT_NT2 * 4);
        };
        if (nt2 == 4)
          gemm2(IC<32>());
        else if (nt2 == 3)
          gemm2(IC<24>());
        else if (nt2 == 2)
          gemm2(IC<16>());
        else
          gemm2(IC<8>());
        const float* al = alpha_s + k * PT_ROWS + 16 * wk;
        const float a0 = al[g], a8 = al[g + 8];
        const bool hit2 = f_t && f_site == S_GEMM2 && f_blk == j0 + k;
#pragma unroll
        for (int kk = 0; kk < PT_NT2; ++kk) {
          if (kk < nt2) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 16 * wk + g + (e >> 1) * 8;
              const int col = col2 + kk * 8 + 2 * t4 + (e & 1);
              float an = (e < 2 ? a0 : a8) * acc[4 * kk + e] + pv[4 * kk + e];
              if (hit2 && r == f_row && col == f_col) an = flip_bit(an, f_bit);
              acc[4 * kk + e] = an;
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + stage);
    PHASE_MARK(8)
  }

  // ---- finalize: the output rows into shared memory (over the scores),
  //      SNVR on l, unified output verification ----
  consumer_sync(PT_NT);  // every warp is done with the last step's p
  PHASE_MARK(7)
  float* fo = sp_all;
#pragma unroll
  for (int kk = 0; kk < PT_NT2; ++kk) {
    if (kk < nt2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * wk + g + (e >> 1) * 8;
        fo[r * ldo + col2 + kk * 8 + 2 * t4 + (e & 1)] = acc[4 * kk + e];
      }
    }
  }
  if (tid == 0) {
    // max|V| of the running blocks (only ever read by the clamp)
    float v = 0.f;
    if (ft)
      for (int k = 0; k < n_run; ++k)
        v = fmax_nan(v, C.ws[(bh * mb + j_lo + k) * (size_t)F.floats +
                             F.vmax]);
    *vmax_s = v;
    // site 6 (kv): the fold pass's flags, counted once a (request, KV
    // head, block), by tile 0
    if (ft && tile == 0)
      for (int k = 0; k < n_run; ++k) det[5] += P.bad[bh * mb + j_lo + k];
  }
  for (int r = tid; r < PT_ROWS; r += PT_NT) {
    float lf = l_s[r];
    if (ft) {
      const float rf = r_s[r];
      const float upper =
          (float)min(base + dC.r(row0 + r) + 1, kv_len) + 1e-3f;
      const bool in_range = lf >= rf - 1e-3f && lf <= upper && isfinite(lf);
      bool bad;
      float fallback;
      if (P.shadow_rowsum) {
        const float lsh = lsh_s[r];
        const bool mism =
            fabsf(lf - lsh) > 1e-5f * fmax_nan(fabsf(lsh), 1e-6f);
        bad = (!in_range || mism) && rf > 0.f;
        const bool fb_ok = lsh >= rf - 1e-3f && lsh <= upper && isfinite(lsh);
        fallback = fb_ok ? lsh : rf;
      } else {
        bad = !in_range && rf > 0.f;
        fallback = rf;
      }
      if (r < nrows) det[3] += bad;
      if (correct && bad) lf = fallback;
    }
    lsafe_s[r] = lf == 0.f ? 1.f : lf;
  }
  consumer_sync(PT_NT);
  const float bound = *vmax_s * 1.001f + 1e-6f;
  for (int e = tid; e < PT_ROWS * D; e += PT_NT) {
    const int r = dD.q(e), d = e - r * D;
    float o = fo[r * ldo + d] / lsafe_s[r];
    if (ft && correct) o = (isfinite(o) && fabsf(o) <= bound) ? o : 0.f;
    fo[r * ldo + d] = o;
  }
  consumer_sync(PT_NT);
  if (ft) {
    for (int p = tid; p < PT_ROWS * sout; p += PT_NT) {
      const int r = dsout.q(p), i = p - r * sout;
      const float ls = lsafe_s[r];
      float s1 = 0.f, s2 = 0.f;
      for (int q = 0; q < g_out; ++q) {
        const float x = fo[r * ldo + q * sout + i];
        s1 = s1 + x;
        s2 = s2 + (float)(q + 1) * x;
      }
      const float d1 = oc1[p] / ls - s1;
      const float d2 = oc2[p] / ls - s2;
      const bool bad = !(fabsf(d1) <= P.eps3);
      if (r < nrows) det[4] += bad;
      if (correct && bad) fo[r * ldo + seg_of(d1, d2, g_out) * sout + i] += d1;
    }
    consumer_sync(PT_NT);
  }
  // two elements a store (D is even)
  __nv_bfloat162* og = (__nv_bfloat162*)((T*)P.out + (bh * R + row0) * D);
  for (int e = tid; e < nrows * D / 2; e += PT_NT) {
    const int r = dD.q(2 * e), d = 2 * e - r * D;
    og[e] = __floats2bfloat162_rn(fo[r * ldo + d], fo[r * ldo + d + 1]);
  }
  PHASE_MARK(9)
  // ---- this CTA's counts: warps in order, no atomics ----
  for (int k = 0; k < 6; ++k) {
    int v = det[k];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) redi[w * 6 + k] = v;
  }
  consumer_sync(PT_NT);
  if (tid < 6) {
    int tot = 0;
    for (int i = 0; i < PT_NT / 32; ++i) tot += redi[i * 6 + tid];
    P.rep[(bh * P.n_tiles + tile) * 6 + tid] = tot;
  }
  PHASE_FLUSH
}
