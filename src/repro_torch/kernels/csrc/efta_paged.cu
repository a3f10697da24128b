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
// the planes are as many bytes again as the K/V they guard. The arithmetic
// per byte is small (decode rows: grp * C of them per block).
//
// Design: a simple CUDA-core loop, written to be right first; a later PR
// redesigns it (wgmma, TMA, a persistent grid).
//   * Grid (B, Hkv, n_row_tiles); a row tile is TILE_ROWS of the grp * C
//     group-major rows. The TPU grid's sequential block axis is the loop
//     over j inside the thread block; blocks carry nothing between them.
//   * All row-local state (m, l, shadow l, r, acc, the two O checksums)
//     lives in the tile's shared memory. max|V| is computed identically by
//     every tile. The site-6 verify and the bad plane run in row tile 0
//     only, so det[5] counts each (b, h, j) once.
//   * Each tile writes its own (6,) partial counts and the wrapper sums
//     them: no atomics, so counts and values are deterministic and a retry
//     or a block repair reproduces the clean values bit for bit.
//   * Storage type T is float or __nv_bfloat16; all arithmetic is f32. The
//     checksum products are f32 FMAs on CUDA cores (never TF32). GEMM II
//     rounds p to T first, as the reference does (p.astype(v.dtype)); the
//     O checksums use the unrounded f32 p.
//   * Shadow computations stay redundant: the shadow rowmax and the shadow
//     rowsum read their inputs through opaque() (efta_common.cuh), so nvcc
//     cannot merge the shadow with its primary. Both keep the primary's
//     order of operations, so a corrected value equals the clean value bit
//     for bit.
//   * Built with -fmad=false: the reference's elementwise multiply-adds
//     round twice, and so do the ones here; dot products use explicit fmaf.
//
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "efta_common.cuh"

namespace {

constexpr int TILE_ROWS = 32;
constexpr int NT = 128;  // threads per block
constexpr int P_SITE = 0, P_BLOCK = 1, P_B = 2, P_H = 3, P_ROW = 4,
              P_COL = 5, P_BIT = 6, P_ON = 7;

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
  float scale, kv_thr, eps1, eps2, eps3;
  int mode, unified, shadow_rowsum, shadow_rowmax;
  int fault[8];
};

// checksum.block_fold_bad(encode_kv_tile(x, cs), stored): x is the (bs, D)
// tile in shared memory (row stride ld); stored planes are (cs, D) in T.
template <typename T>
__device__ bool block_fold_bad(const float* x, int ld, const T* c1g,
                               const T* c2g, int cs, int bs, int D,
                               float thr, float* red) {
  float a1 = 0.f, a2 = 0.f;
  for (int e = threadIdx.x; e < cs * D; e += NT) {
    a1 += fabsf(to_f(c1g[e]));
    a2 += fabsf(to_f(c2g[e]));
  }
  a1 = block_sum<NT>(a1, red);
  a2 = block_sum<NT>(a2, red);
  const float n = (float)(cs * D);
  const float floor1 = nan_max(a1 / n, 1e-6f);
  const float floor2 = nan_max(a2 / n, 1e-6f);
  const int g = bs / cs;
  bool ok = true;
  for (int e = threadIdx.x; e < cs * D; e += NT) {
    const int i = e / D, d = e - (e / D) * D;
    float f1 = 0.f, f2 = 0.f;
    for (int l = 0; l < g; ++l) {
      const float xv = x[(l * cs + i) * ld + d];
      f1 = f1 + xv;
      f2 = f2 + (float)(l + 1) * xv;
    }
    const float c1 = to_f(c1g[e]), c2 = to_f(c2g[e]);
    ok = ok && (fabsf(c1 - f1) <= thr * nan_max(fabsf(c1), floor1));
    ok = ok && (fabsf(c2 - f2) <= thr * nan_max(fabsf(c2), floor2));
  }
  return __syncthreads_or(!ok) != 0;
}

size_t smem_floats(int D, int bs, int s_kv, int s_out) {
  const size_t ld = D + 1;
  return (size_t)TILE_ROWS * ld          // q tile
         + 2 * (size_t)bs * ld           // K, V tiles
         + 2 * (size_t)TILE_ROWS * bs    // s, p
         + 2 * (size_t)TILE_ROWS * s_kv  // sc1, sc2
         + 2 * (size_t)s_kv * ld         // K tensor checksums
         + 2 * (size_t)bs * s_out        // V column checksums
         + (size_t)TILE_ROWS * ld        // acc / o
         + 2 * (size_t)TILE_ROWS * s_out // O checksums
         + 8 * (size_t)TILE_ROWS         // row state
         + NT / 32;                      // reduction scratch
}

template <typename T>
__global__ void __launch_bounds__(NT) efta_paged_kernel(const Params P) {
  const int b = blockIdx.x, h = blockIdx.y, tile = blockIdx.z;
  const int tid = threadIdx.x;
  const int R = P.R, D = P.D, bs = P.bs, cs = P.cs, skv = P.s_kv,
            sout = P.s_out, C = P.chunk, mb = P.mb;
  const int ld = D + 1;  // padded row stride: no bank conflicts across rows
  const int row0 = tile * TILE_ROWS;
  const int nrows = min(TILE_ROWS, R - row0);
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const int g_kv = bs / skv;
  const int g_out = D / sout;
  const float MASK_VALUE = (float)MASK_D;
  const float MASK_HALF = (float)(MASK_D / 2);
  const float cap = (float)(80.0 / g_kv);
  const float cap_g = (float)(80.0 / g_kv * g_kv);
  const float cap_m = (float)(80.0 / g_kv - 1e-3);
  const int kv_len = P.kv_lens[b], q_len = P.q_lens[b];
  const int window = P.window;
  const int base = kv_len - q_len;
  const bool f_here = P.fault[P_ON] == 1 && P.fault[P_B] == b &&
                      P.fault[P_H] == h;
  const int f_row = P.fault[P_ROW] - row0;  // tile-local; may be out of range
  const int f_col = P.fault[P_COL], f_bit = P.fault[P_BIT];

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + TILE_ROWS * ld;
  float* vs = ks + bs * ld;
  float* s = vs + bs * ld;
  float* p = s + TILE_ROWS * bs;
  float* sc1 = p + TILE_ROWS * bs;
  float* sc2 = sc1 + TILE_ROWS * skv;
  float* kf1 = sc2 + TILE_ROWS * skv;
  float* kf2 = kf1 + skv * ld;
  float* vcs1 = kf2 + skv * ld;
  float* vcs2 = vcs1 + bs * sout;
  float* acc = vcs2 + bs * sout;
  float* oc1 = acc + TILE_ROWS * ld;
  float* oc2 = oc1 + TILE_ROWS * sout;
  float* m_s = oc2 + TILE_ROWS * sout;
  float* l_s = m_s + TILE_ROWS;
  float* lsh_s = l_s + TILE_ROWS;
  float* r_s = lsh_s + TILE_ROWS;
  float* msub_s = r_s + TILE_ROWS;
  float* alpha_s = msub_s + TILE_ROWS;
  float* bmax_s = alpha_s + TILE_ROWS;
  float* lsafe_s = bmax_s + TILE_ROWS;
  float* red = lsafe_s + TILE_ROWS;

  const size_t bh = (size_t)b * P.Hkv + h;
  const T* qg = (const T*)P.q + (bh * R + row0) * D;
  for (int e = tid; e < TILE_ROWS * D; e += NT) {
    const int r = e / D, d = e - r * D;
    qs[r * ld + d] = r < nrows ? to_f(qg[r * D + d]) : 0.f;
    acc[r * ld + d] = 0.f;
  }
  for (int e = tid; e < TILE_ROWS * sout; e += NT) oc1[e] = oc2[e] = 0.f;
  if (tid < TILE_ROWS) {
    m_s[tid] = MASK_VALUE;
    l_s[tid] = lsh_s[tid] = r_s[tid] = 0.f;
  }
  float vmax = 0.f;  // uniform across the block
  int det[6] = {0, 0, 0, 0, 0, 0};
  __syncthreads();

  for (int j = 0; j < mb; ++j) {
    const int kv_start = j * bs;
    const bool run = kv_start < kv_len && base - (kv_start + bs - 1) < window;
    if (!run) {
      if (tile == 0 && tid == 0) P.bad[bh * mb + j] = 0;
      continue;
    }
    const bool hit = f_here && P.fault[P_BLOCK] == j;
    const int bid = P.bt[(size_t)b * mb + j];
    const bool real = bid > 0;
    const size_t blk = (size_t)bid * P.Hkv + h;
    const T* kg = (const T*)P.k + blk * bs * D;
    const T* vg = (const T*)P.v + blk * bs * D;
    for (int e = tid; e < bs * D; e += NT) {
      const int c = e / D, d = e - c * D;
      ks[c * ld + d] = to_f(kg[e]);
      vs[c * ld + d] = to_f(vg[e]);
    }
    __syncthreads();

    if (ft) {
      // ---- site 6 (kv): resident block verify, row tile 0 only ----
      if (tile == 0) {
        const size_t cofs = blk * cs * D;
        const bool bad_k = block_fold_bad<T>(
            ks, ld, (const T*)P.kc1 + cofs, (const T*)P.kc2 + cofs, cs, bs,
            D, P.kv_thr, red);
        const bool bad_v = block_fold_bad<T>(
            vs, ld, (const T*)P.vc1 + cofs, (const T*)P.vc2 + cofs, cs, bs,
            D, P.kv_thr, red);
        const bool flag = (bad_k || bad_v) && real;
        if (tid == 0) {
          det[5] += flag;
          P.bad[bh * mb + j] = flag;
        }
      }
      // running max|V|: the convex-combination bound for the finalize NVR
      float vm = 0.f;
      for (int e = tid; e < bs * D; e += NT) {
        const int c = e / D, d = e - c * D;
        vm = nan_max(vm, fabsf(vs[c * ld + d]));
      }
      vmax = nan_max(vmax, block_max_nan<NT>(vm, red));
      // tensor checksums of K at the ABFT stride
      for (int e = tid; e < skv * D; e += NT) {
        const int i = e / D, d = e - i * D;
        float f1 = 0.f, f2 = 0.f;
        for (int l = 0; l < g_kv; ++l) {
          const float x = ks[(l * skv + i) * ld + d];
          f1 = f1 + x;
          f2 = f2 + (float)(l + 1) * x;
        }
        kf1[i * ld + d] = f1;
        kf2[i * ld + d] = f2;
      }
    } else if (tile == 0 && tid == 0) {
      P.bad[bh * mb + j] = 0;
    }

    // ---- GEMM I (f32 accumulate) + NVR clip ----
    for (int e = tid; e < TILE_ROWS * bs; e += NT) {
      const int r = e / bs, c = e - r * bs;
      const float* qr = qs + r * ld;
      const float* kr = ks + c * ld;
      float a = 0.f;
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
      float sv = a * P.scale;
      if (hit && P.fault[P_SITE] == S_GEMM1 && r == f_row && c == f_col)
        sv = flip_bit(sv, f_bit);
      if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
      s[e] = sv;
    }
    __syncthreads();

    if (ft) {
      // ---- CCG: checksum GEMMs, verify, locate + correct ----
      for (int e = tid; e < TILE_ROWS * skv; e += NT) {
        const int r = e / skv, i = e - r * skv;
        const float* qr = qs + r * ld;
        float a1 = 0.f, a2 = 0.f;
        for (int d = 0; d < D; ++d) {
          a1 = fmaf(qr[d], kf1[i * ld + d], a1);
          a2 = fmaf(qr[d], kf2[i * ld + d], a2);
        }
        const float c1 = a1 * P.scale, c2 = a2 * P.scale;
        sc1[e] = c1;
        sc2[e] = c2;
        float sum1 = 0.f, sum2 = 0.f;
        for (int l = 0; l < g_kv; ++l) {
          const float x = s[r * bs + l * skv + i];
          sum1 = sum1 + x;
          sum2 = sum2 + (float)(l + 1) * x;
        }
        const float d1 = c1 - sum1, d2 = c2 - sum2;
        const bool bad = fabsf(d1) > P.eps1;
        if (r < nrows) det[0] += bad;
        if (correct && bad) s[r * bs + seg_of(d1, d2, g_kv) * skv + i] += d1;
      }
      __syncthreads();
    }

    // ---- per-row mask, running max (+ shadow) ----
    if (tid < TILE_ROWS) {
      const int r = tid;
      const int crow = (row0 + r) % C;
      const int qpos = base + crow;
      float bm = MASK_VALUE;
      for (int c = 0; c < bs; ++c) {
        const int col = kv_start + c;
        const bool mk = col <= qpos && qpos - col < window && crow < q_len;
        bm = nan_max(bm, mk ? s[r * bs + c] : MASK_VALUE);
      }
      const float mp = m_s[r];
      float mn = nan_max(mp, bm);
      if (hit && P.fault[P_SITE] == S_ROWMAX && r == f_row)
        mn = flip_bit(mn, f_bit);
      if (ft && P.shadow_rowmax) {
        const float mc = nan_max(opaque(mp), bm);
        const bool bad = mn != mc;
        if (r < nrows) det[2] += bad;
        if (correct && bad) mn = mc;
      }
      m_s[r] = mn;
      const bool alive = mn > MASK_HALF;
      msub_s[r] = alive ? mn : 0.f;
      alpha_s[r] = alive ? expf(mp - mn) : 1.f;
      bmax_s[r] = bm;
    }
    __syncthreads();

    // ---- EXP with checksum reuse (paper Case 2) ----
    for (int e = tid; e < TILE_ROWS * bs; e += NT) {
      const int r = e / bs, c = e - r * bs;
      float pr = expf(nan_min(s[e] - msub_s[r], cap));
      if (hit && P.fault[P_SITE] == S_EXP && r == f_row && c == f_col)
        pr = flip_bit(pr, f_bit);
      p[e] = pr;
    }
    __syncthreads();
    if (ft) {
      for (int e = tid; e < TILE_ROWS * skv; e += NT) {
        const int r = e / skv, i = e - r * skv;
        const float ms = msub_s[r];
        const float pc1 = expf(nan_min(sc1[e] - (float)g_kv * ms, cap_g));
        float prod = 1.f;
        bool col_ok = true;
        for (int l = 0; l < g_kv; ++l) {
          const int idx = r * bs + l * skv + i;
          prod = prod * p[idx];
          col_ok = col_ok && !((s[idx] - ms) > cap_m);
        }
        const float ref = nan_max(fabsf(pc1), 1e-20f);
        const bool bad = col_ok && (fabsf(prod - pc1) > P.eps2 * ref + 1e-20f);
        if (r < nrows) det[1] += bad;
        if (correct && bad) {
          for (int l = 0; l < g_kv; ++l) {
            const int idx = r * bs + l * skv + i;
            p[idx] = expf(nan_min(s[idx] - ms, cap));
          }
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < TILE_ROWS * bs; e += NT) {
      const int r = e / bs, c = e - r * bs;
      float pr = p[e];
      if (ft && P.shadow_rowmax && correct) {
        // exact recompute backstop
        const float rc = expf(nan_min(s[e] - msub_s[r], cap));
        const bool slipped = pr != rc;
        if (r < nrows) det[1] += slipped;
        if (slipped) pr = rc;
      }
      const int crow = (row0 + r) % C;
      const int qpos = base + crow;
      const int col = kv_start + c;
      const bool mk = col <= qpos && qpos - col < window && crow < q_len;
      p[e] = mk ? pr : 0.f;
    }
    __syncthreads();

    // ---- rescale + rowsum (+ shadow), SNVR tracker ----
    if (tid < TILE_ROWS) {
      const int r = tid;
      const float a = alpha_s[r];
      float ps = 0.f;
      for (int c = 0; c < bs; ++c) ps = ps + p[r * bs + c];
      float ln = a * l_s[r] + ps;
      if (hit && P.fault[P_SITE] == S_ROWSUM && r == f_row)
        ln = flip_bit(ln, f_bit);
      l_s[r] = ln;
      if (ft && P.shadow_rowsum) {
        float ps2 = 0.f;
        for (int c = 0; c < bs; ++c) ps2 = ps2 + opaque(p[r * bs + c]);
        lsh_s[r] = a * lsh_s[r] + ps2;
      }
      const float bm = bmax_s[r];
      r_s[r] = a * r_s[r] + (bm > MASK_HALF ? expf(bm - msub_s[r]) : 0.f);
    }
    // V column checksums (independent of the rows above)
    if (ft) {
      for (int e = tid; e < bs * sout; e += NT) {
        const int c = e / sout, i = e - c * sout;
        float f1 = 0.f, f2 = 0.f;
        for (int l = 0; l < g_out; ++l) {
          const float x = vs[c * ld + l * sout + i];
          f1 = f1 + x;
          f2 = f2 + (float)(l + 1) * x;
        }
        vcs1[e] = f1;
        vcs2[e] = f2;
      }
    }
    __syncthreads();

    // ---- GEMM II + rescale, checksums carried ----
    for (int e = tid; e < TILE_ROWS * D; e += NT) {
      const int r = e / D, d = e - r * D;
      float a = 0.f;
      for (int c = 0; c < bs; ++c)
        a = fmaf(round_to<T>(p[r * bs + c]), vs[c * ld + d], a);
      float an = alpha_s[r] * acc[r * ld + d] + a;
      if (hit && P.fault[P_SITE] == S_GEMM2 && r == f_row && d == f_col)
        an = flip_bit(an, f_bit);
      acc[r * ld + d] = an;
    }
    if (ft) {
      for (int e = tid; e < TILE_ROWS * sout; e += NT) {
        const int r = e / sout, i = e - r * sout;
        float a1 = 0.f, a2 = 0.f;
        for (int c = 0; c < bs; ++c) {
          const float pf = p[r * bs + c];
          a1 = fmaf(pf, vcs1[c * sout + i], a1);
          a2 = fmaf(pf, vcs2[c * sout + i], a2);
        }
        oc1[e] = alpha_s[r] * oc1[e] + a1;
        oc2[e] = alpha_s[r] * oc2[e] + a2;
      }
    }
    __syncthreads();
    if (ft && !P.unified) {
      // per-step output check (EFTA without unified verification)
      for (int e = tid; e < TILE_ROWS * sout; e += NT) {
        const int r = e / sout, i = e - r * sout;
        float s1 = 0.f;
        for (int l = 0; l < g_out; ++l) s1 = s1 + acc[r * ld + l * sout + i];
        if (r < nrows) det[4] += fabsf(oc1[e] - s1) > P.eps3;
      }
      __syncthreads();
    }
  }

  // ---- finalize: SNVR on l + unified output verification ----
  if (tid < TILE_ROWS) {
    const int r = tid;
    const int crow = (row0 + r) % C;
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
      if (r < nrows) det[3] += bad;
      if (correct && bad) lf = fallback;
    }
    lsafe_s[r] = lf == 0.f ? 1.f : lf;
  }
  __syncthreads();
  const float bound = vmax * 1.001f + 1e-6f;
  for (int e = tid; e < TILE_ROWS * D; e += NT) {
    const int r = e / D, d = e - r * D;
    float o = acc[r * ld + d] / lsafe_s[r];
    if (ft && correct) o = (isfinite(o) && fabsf(o) <= bound) ? o : 0.f;
    acc[r * ld + d] = o;
  }
  __syncthreads();
  if (ft) {
    for (int e = tid; e < TILE_ROWS * sout; e += NT) {
      const int r = e / sout, i = e - r * sout;
      const float ls = lsafe_s[r];
      float s1 = 0.f, s2 = 0.f;
      for (int l = 0; l < g_out; ++l) {
        const float x = acc[r * ld + l * sout + i];
        s1 = s1 + x;
        s2 = s2 + (float)(l + 1) * x;
      }
      const float d1 = oc1[e] / ls - s1, d2 = oc2[e] / ls - s2;
      const bool bad = !(fabsf(d1) <= P.eps3);
      if (r < nrows) det[4] += bad;
      if (correct && bad) acc[r * ld + seg_of(d1, d2, g_out) * sout + i] += d1;
    }
    __syncthreads();
  }
  T* og = (T*)P.out + (bh * R + row0) * D;
  for (int e = tid; e < nrows * D; e += NT) {
    const int r = e / D, d = e - r * D;
    og[e] = from_f<T>(acc[r * ld + d]);
  }
  int* rep = P.rep + (bh * P.n_tiles + tile) * 6;
  for (int k = 0; k < 6; ++k) {
    const int t = block_sum_int<NT>(det[k], (int*)red);
    if (tid == 0) rep[k] = t;
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.D, p.bs, p.s_kv, p.s_out) * sizeof(float);
  if (bytes > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      efta_paged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.B, p.Hkv, p.n_tiles);
  efta_paged_kernel<T><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int efta_paged_tile_rows() { return TILE_ROWS; }

const char* efta_paged_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16 (q, pools, checksum planes and out).
// Pointers are device pointers; the launch goes on `stream`.
int efta_paged_launch(int dtype, const void* q, const void* k, const void* v,
                      const void* kc1, const void* kc2, const void* vc1,
                      const void* vc2, const void* bt, const void* kv_lens,
                      const void* q_lens, void* out, void* rep, void* bad,
                      int B, int Hkv, int R, int chunk, int D, int bs, int cs,
                      int mb, int s_kv, int s_out, int window, float scale,
                      float kv_thr, float eps1, float eps2, float eps3,
                      int mode, int unified, int shadow_rowsum,
                      int shadow_rowmax, int f0, int f1, int f2, int f3,
                      int f4, int f5, int f6, int f7, void* stream) {
  if (B <= 0 || Hkv <= 0 || R <= 0 || mb <= 0 || bs % cs || bs % s_kv ||
      D % s_out || Hkv > 65535)
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
  p.n_tiles = (R + TILE_ROWS - 1) / TILE_ROWS;
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
  if (p.n_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      dtype == 0 ? launch<float>(p, s) : launch<__nv_bfloat16>(p, s);
  return (int)err;
}

}  // extern "C"
