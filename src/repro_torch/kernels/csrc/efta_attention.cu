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
// What bounds it on this card: at the serve path's prefill shapes (gpt2:
// Sq = Skv up to 512, D 64) the two GEMMs' operations, not HBM bytes — the
// kernel reads q, k, v once per query tile and writes o once. This first
// kernel runs them as f32 FMAs on CUDA cores (a later PR moves them to
// wgmma), so it is far from the bf16 tensor-core bound.
//
// Design (a simple CUDA-core kernel, right first):
//   * The TPU kernel's tile (block_q = 128 rows x block_kv = 512 keys of
//     f32 scores, 256 KB) does not fit an SM. A thread block takes TR <= 16
//     rows of ONE reference query tile (grid (B*H, n_q * n_sub)); the scores
//     and probabilities of its rows over the whole KV block stay in shared
//     memory, while K and V stream through in chunks of KC keys.
//   * The sequential KV-block axis of the TPU grid is a loop inside the
//     thread block. Which blocks run (causal, window, kv_len skipping), and
//     which blocks the running max|V| covers, is decided per reference tile
//     (row // block_q), so detections and clamped outputs match the
//     reference tiling whatever TR is.
//   * K is folded into the (s_kv, D) tensor checksums in its own pass over
//     the chunks, in the reference's segment order, BEFORE sc = Q fold(K)^T
//     is formed: the check compares S with an independent product.
//   * Each thread block writes its own (5,) partial counts and the wrapper
//     sums them: no atomics, so counts and values are deterministic and a
//     retry reproduces the clean values bit for bit.
//   * Numerics as efta_paged.cu (efta_common.cuh): f32 arithmetic, f32 FMAs
//     for every product (never TF32), p rounded to T for GEMM II while the
//     O checksums use the f32 p, NaN-propagating min/max, shadows read
//     through opaque(), folds summed in segment order, -fmad=false.
//
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() after the launch.

#include "efta_common.cuh"

namespace {

constexpr int NT = 128;     // threads per block
constexpr int MAX_TR = 16;  // query rows per block
constexpr size_t SMEM_LIMIT = 232448;
constexpr int F_SITE = 0, F_BLOCK = 1, F_BH = 2, F_ROW = 3, F_COL = 4,
              F_BIT = 5, F_ON = 6;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int* rep;
  int BH, grp, Sq, Skv, D, block_q, block_kv, n_q, n_kv, kv_len, s_kv,
      s_out, causal, window;
  int TR, KC, n_sub;
  float scale, eps1, eps2, eps3, cap, cap_g, cap_m, upper;
  int mode, unified, shadow_rowsum, shadow_rowmax;
  int fault[8];
};

size_t smem_floats(int TR, int KC, int D, int Bc, int s_kv, int s_out) {
  const size_t ld = D + 1;  // padded row stride: no bank conflicts
  return 3 * (size_t)TR * ld        // q rows, acc, the block's P V
         + 2 * (size_t)TR * Bc      // s, p over the whole KV block
         + 2 * (size_t)s_kv * ld    // K tensor checksums
         + 2 * (size_t)TR * s_kv    // sc1, sc2
         + (size_t)KC * ld          // the streamed K or V chunk
         + 2 * (size_t)KC * s_out   // V column checksums of the chunk
         + 4 * (size_t)TR * s_out   // O checksums: block sums, running
         + 8 * (size_t)TR           // row state
         + 2 * (size_t)NT           // row-reduction partials (+ shadow)
         + NT / 32;                 // block reductions
}

// rows per block (a power of two <= 16 and <= block_q) and keys per chunk:
// the largest pair that fits the SM's shared memory
bool choose_tiles(int block_q, int Bc, int D, int s_kv, int s_out, int* TR,
                  int* KC) {
  int tr = 1;
  while (tr * 2 <= MAX_TR && tr * 2 <= block_q) tr *= 2;
  for (; tr >= 1; tr /= 2) {
    for (int kc = 64; kc >= 8; kc /= 2) {
      const int k = kc < Bc ? kc : Bc;
      if (smem_floats(tr, k, D, Bc, s_kv, s_out) * sizeof(float) <=
          SMEM_LIMIT) {
        *TR = tr;
        *KC = k;
        return true;
      }
    }
  }
  return false;
}

template <typename T>
__global__ void __launch_bounds__(NT) efta_attention_kernel(const Params P) {
  const int bh = blockIdx.x, tile = blockIdx.y;
  const int iq = tile / P.n_sub, sub = tile - iq * P.n_sub;
  const int tid = threadIdx.x;
  const int TR = P.TR, KC = P.KC, D = P.D, Bc = P.block_kv, skv = P.s_kv,
            sout = P.s_out;
  const int ld = D + 1;
  const int q_start = iq * P.block_q;      // the reference tile's first row
  const int r0 = q_start + sub * TR;       // this block's first row
  const int nrows = min(TR, P.block_q - sub * TR);
  const bool ft = P.mode != 0, correct = P.mode == 2;
  const int g_kv = Bc / skv;
  const int g_out = D / sout;
  const float MASK_VALUE = (float)MASK_D;
  const float MASK_HALF = (float)(MASK_D / 2);
  const int TPR = NT / TR;  // threads per row in the row reductions
  const int my_row = tid / TPR, my_lane = tid - (tid / TPR) * TPR;
  const int f_row = P.fault[F_ROW] - r0;  // block-local row
  const bool f_here = P.fault[F_ON] == 1 && P.fault[F_BH] == bh &&
                      f_row >= 0 && f_row < nrows;
  const int f_site = P.fault[F_SITE], f_col = P.fault[F_COL],
            f_bit = P.fault[F_BIT];

  extern __shared__ float smem[];
  float* qs = smem;
  float* acc = qs + TR * ld;
  float* pv = acc + TR * ld;
  float* s = pv + TR * ld;
  float* p = s + TR * Bc;
  float* kf1 = p + TR * Bc;
  float* kf2 = kf1 + skv * ld;
  float* sc1 = kf2 + skv * ld;
  float* sc2 = sc1 + TR * skv;
  float* buf = sc2 + TR * skv;
  float* vcs1 = buf + KC * ld;
  float* vcs2 = vcs1 + KC * sout;
  float* ocb1 = vcs2 + KC * sout;
  float* ocb2 = ocb1 + TR * sout;
  float* oc1 = ocb2 + TR * sout;
  float* oc2 = oc1 + TR * sout;
  float* m_s = oc2 + TR * sout;
  float* l_s = m_s + TR;
  float* lsh_s = l_s + TR;
  float* r_s = lsh_s + TR;
  float* msub_s = r_s + TR;
  float* alpha_s = msub_s + TR;
  float* bmax_s = alpha_s + TR;
  float* lsafe_s = bmax_s + TR;
  float* part = lsafe_s + TR;
  float* part2 = part + NT;
  float* red = part2 + NT;

  const T* qg = (const T*)P.q + ((size_t)bh * P.Sq + r0) * D;
  const size_t kvh = (size_t)(bh / P.grp);
  const T* kg = (const T*)P.k + kvh * P.Skv * D;
  const T* vg = (const T*)P.v + kvh * P.Skv * D;
  for (int e = tid; e < TR * D; e += NT) {
    const int r = e / D, d = e - r * D;
    qs[r * ld + d] = r < nrows ? to_f(qg[r * D + d]) : 0.f;
    acc[r * ld + d] = 0.f;
  }
  for (int e = tid; e < TR * sout; e += NT) oc1[e] = oc2[e] = 0.f;
  if (tid < TR) {
    m_s[tid] = MASK_VALUE;
    l_s[tid] = lsh_s[tid] = r_s[tid] = 0.f;
  }
  float vmax = 0.f;  // uniform across the block
  int det[5] = {0, 0, 0, 0, 0};
  __syncthreads();

  for (int j = 0; j < P.n_kv; ++j) {
    const int kv_start = j * Bc;
    // block skipping, decided for the whole reference tile
    bool run = kv_start < P.kv_len &&
               q_start - (kv_start + Bc - 1) < P.window;
    if (P.causal) run = run && kv_start <= q_start + P.block_q - 1;
    if (!run) continue;
    const bool hit = f_here && P.fault[F_BLOCK] == j;

    // ---- K pass: GEMM I (f32 accumulate) + NVR clip, K folds ----
    if (ft) {
      for (int e = tid; e < skv * D; e += NT) {
        const int i = e / D, d = e - i * D;
        kf1[i * ld + d] = kf2[i * ld + d] = 0.f;
      }
    }
    for (int c0 = 0; c0 < Bc; c0 += KC) {
      const int n = min(KC, Bc - c0);
      __syncthreads();  // earlier readers of buf are done
      for (int e = tid; e < n * D; e += NT) {
        const int c = e / D, d = e - c * D;
        buf[c * ld + d] = to_f(kg[(size_t)(kv_start + c0 + c) * D + d]);
      }
      __syncthreads();
      for (int e = tid; e < TR * n; e += NT) {
        const int r = e / n, c = e - r * n;
        const float* qr = qs + r * ld;
        const float* kr = buf + c * ld;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        float sv = a * P.scale;
        if (hit && f_site == S_GEMM1 && r == f_row && c0 + c == f_col)
          sv = flip_bit(sv, f_bit);
        if (ft) sv = isfinite(sv) ? fminf(fmaxf(sv, -1e6f), 1e6f) : 0.f;
        s[r * Bc + c0 + c] = sv;
      }
      if (ft) {
        // fold this chunk's K rows into the tensor checksums, segments in
        // order (key c = l * s_kv + i; keys past g_kv * s_kv are not folded)
        for (int e = tid; e < skv * D; e += NT) {
          const int i = e / D, d = e - i * D;
          float f1 = kf1[i * ld + d], f2 = kf2[i * ld + d];
          for (int c = c0 + ((i - c0 % skv) + skv) % skv; c < c0 + n;
               c += skv) {
            const int l = c / skv;
            if (l >= g_kv) break;
            const float x = buf[(c - c0) * ld + d];
            f1 = f1 + x;
            f2 = f2 + (float)(l + 1) * x;
          }
          kf1[i * ld + d] = f1;
          kf2[i * ld + d] = f2;
        }
      }
    }
    __syncthreads();

    if (ft) {
      // ---- checksum GEMMs on the folded K, verify, locate + correct ----
      for (int e = tid; e < TR * skv; e += NT) {
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
          const float x = s[r * Bc + l * skv + i];
          sum1 = sum1 + x;
          sum2 = sum2 + (float)(l + 1) * x;
        }
        const float d1 = c1 - sum1, d2 = c2 - sum2;
        const bool bad = fabsf(d1) > P.eps1;
        if (r < nrows) det[0] += bad;
        if (correct && bad) s[r * Bc + seg_of(d1, d2, g_kv) * skv + i] += d1;
      }
      __syncthreads();
    }

    // ---- mask, running max (+ shadow) ----
    {
      const int row_abs = r0 + my_row;
      float bm = MASK_VALUE;
      for (int c = my_lane; c < Bc; c += TPR) {
        const int col = kv_start + c;
        const bool mk = col < P.kv_len && (!P.causal || col <= row_abs) &&
                        row_abs - col < P.window;
        bm = nan_max(bm, mk ? s[my_row * Bc + c] : MASK_VALUE);
      }
      part[tid] = bm;
    }
    __syncthreads();
    if (my_lane == 0) {
      const int r = my_row;
      float bm = part[r * TPR];
      for (int t = 1; t < TPR; ++t) bm = nan_max(bm, part[r * TPR + t]);
      const float mp = m_s[r];
      float mn = nan_max(mp, bm);
      if (hit && f_site == S_ROWMAX && r == f_row) mn = flip_bit(mn, f_bit);
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
    for (int e = tid; e < TR * Bc; e += NT) {
      const int r = e / Bc, c = e - r * Bc;
      float pr = expf(nan_min(s[e] - msub_s[r], P.cap));
      if (hit && f_site == S_EXP && r == f_row && c == f_col)
        pr = flip_bit(pr, f_bit);
      p[e] = pr;
    }
    __syncthreads();
    if (ft) {
      for (int e = tid; e < TR * skv; e += NT) {
        const int r = e / skv, i = e - r * skv;
        const float ms = msub_s[r];
        const float pc1 = expf(nan_min(sc1[e] - (float)g_kv * ms, P.cap_g));
        float prod = 1.f;
        bool col_ok = true;
        for (int l = 0; l < g_kv; ++l) {
          const int idx = r * Bc + l * skv + i;
          prod = prod * p[idx];
          col_ok = col_ok && !((s[idx] - ms) > P.cap_m);
        }
        const float ref = nan_max(fabsf(pc1), 1e-20f);
        const bool bad = col_ok && (fabsf(prod - pc1) > P.eps2 * ref + 1e-20f);
        if (r < nrows) det[1] += bad;
        if (correct && bad) {
          for (int l = 0; l < g_kv; ++l) {
            const int idx = r * Bc + l * skv + i;
            p[idx] = expf(nan_min(s[idx] - ms, P.cap));
          }
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < TR * Bc; e += NT) {
      const int r = e / Bc, c = e - r * Bc;
      float pr = p[e];
      if (ft && P.shadow_rowmax && correct) {
        // exact recompute backstop
        const float rc = expf(nan_min(s[e] - msub_s[r], P.cap));
        const bool slipped = pr != rc;
        if (r < nrows) det[1] += slipped;
        if (slipped) pr = rc;
      }
      const int row_abs = r0 + r, col = kv_start + c;
      const bool mk = col < P.kv_len && (!P.causal || col <= row_abs) &&
                      row_abs - col < P.window;
      p[e] = mk ? pr : 0.f;
    }
    __syncthreads();

    // ---- rescale + rowsum (+ shadow, same order), SNVR tracker ----
    {
      float ps = 0.f, ps2 = 0.f;
      for (int c = my_lane; c < Bc; c += TPR) ps = ps + p[my_row * Bc + c];
      part[tid] = ps;
      if (ft && P.shadow_rowsum) {
        for (int c = my_lane; c < Bc; c += TPR)
          ps2 = ps2 + opaque(p[my_row * Bc + c]);
        part2[tid] = ps2;
      }
    }
    __syncthreads();
    if (my_lane == 0) {
      const int r = my_row;
      const float a = alpha_s[r];
      float ps = part[r * TPR];
      for (int t = 1; t < TPR; ++t) ps = ps + part[r * TPR + t];
      float ln = a * l_s[r] + ps;
      if (hit && f_site == S_ROWSUM && r == f_row) ln = flip_bit(ln, f_bit);
      l_s[r] = ln;
      if (ft && P.shadow_rowsum) {
        float ps2 = opaque(part2[r * TPR]);
        for (int t = 1; t < TPR; ++t) ps2 = ps2 + opaque(part2[r * TPR + t]);
        lsh_s[r] = a * lsh_s[r] + ps2;
      }
      const float bm = bmax_s[r];
      r_s[r] = a * r_s[r] + (bm > MASK_HALF ? expf(bm - msub_s[r]) : 0.f);
    }

    // ---- V pass: GEMM II, V column checksums, running max|V| ----
    for (int e = tid; e < TR * D; e += NT) {
      const int r = e / D, d = e - r * D;
      pv[r * ld + d] = 0.f;
    }
    for (int e = tid; e < TR * sout; e += NT) ocb1[e] = ocb2[e] = 0.f;
    float vm = 0.f;
    for (int c0 = 0; c0 < Bc; c0 += KC) {
      const int n = min(KC, Bc - c0);
      __syncthreads();
      for (int e = tid; e < n * D; e += NT) {
        const int c = e / D, d = e - c * D;
        buf[c * ld + d] = to_f(vg[(size_t)(kv_start + c0 + c) * D + d]);
      }
      __syncthreads();
      if (ft) {
        for (int e = tid; e < n * D; e += NT) {
          const int c = e / D, d = e - c * D;
          vm = nan_max(vm, fabsf(buf[c * ld + d]));
        }
        for (int e = tid; e < n * sout; e += NT) {
          const int c = e / sout, i = e - c * sout;
          float f1 = 0.f, f2 = 0.f;
          for (int l = 0; l < g_out; ++l) {
            const float x = buf[c * ld + l * sout + i];
            f1 = f1 + x;
            f2 = f2 + (float)(l + 1) * x;
          }
          vcs1[e] = f1;
          vcs2[e] = f2;
        }
        __syncthreads();
      }
      for (int e = tid; e < TR * D; e += NT) {
        const int r = e / D, d = e - r * D;
        const float* pr = p + r * Bc + c0;
        float a = pv[r * ld + d];
        for (int c = 0; c < n; ++c)
          a = fmaf(round_to<T>(pr[c]), buf[c * ld + d], a);
        pv[r * ld + d] = a;
      }
      if (ft) {
        for (int e = tid; e < TR * sout; e += NT) {
          const int r = e / sout, i = e - r * sout;
          const float* pr = p + r * Bc + c0;
          float a1 = ocb1[e], a2 = ocb2[e];
          for (int c = 0; c < n; ++c) {
            a1 = fmaf(pr[c], vcs1[c * sout + i], a1);
            a2 = fmaf(pr[c], vcs2[c * sout + i], a2);
          }
          ocb1[e] = a1;
          ocb2[e] = a2;
        }
      }
    }
    __syncthreads();
    if (ft) vmax = nan_max(vmax, block_max_nan<NT>(vm, red));

    // ---- rescale + accumulate, O checksums carried ----
    for (int e = tid; e < TR * D; e += NT) {
      const int r = e / D, d = e - r * D;
      float an = alpha_s[r] * acc[r * ld + d] + pv[r * ld + d];
      if (hit && f_site == S_GEMM2 && r == f_row && d == f_col)
        an = flip_bit(an, f_bit);
      acc[r * ld + d] = an;
    }
    if (ft) {
      for (int e = tid; e < TR * sout; e += NT) {
        const int r = e / sout;
        oc1[e] = alpha_s[r] * oc1[e] + ocb1[e];
        oc2[e] = alpha_s[r] * oc2[e] + ocb2[e];
      }
    }
    __syncthreads();
    if (ft && !P.unified) {
      // per-step output check (EFTA without unified verification)
      for (int e = tid; e < TR * sout; e += NT) {
        const int r = e / sout, i = e - r * sout;
        float s1 = 0.f;
        for (int l = 0; l < g_out; ++l) s1 = s1 + acc[r * ld + l * sout + i];
        if (r < nrows) det[4] += fabsf(oc1[e] - s1) > P.eps3;
      }
      __syncthreads();
    }
  }

  // ---- finalize: SNVR on l + unified output verification ----
  if (tid < TR) {
    const int r = tid;
    float lf = l_s[r];
    if (ft) {
      const float rf = r_s[r];
      const bool in_range = lf >= rf - 1e-3f && lf <= P.upper && isfinite(lf);
      bool bad;
      float fallback;
      if (P.shadow_rowsum) {
        const float lsh = lsh_s[r];
        const bool mism = fabsf(lf - lsh) > 1e-5f * nan_max(fabsf(lsh), 1e-6f);
        bad = (!in_range || mism) && rf > 0.f;
        const bool fb_ok = lsh >= rf - 1e-3f && lsh <= P.upper && isfinite(lsh);
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
  for (int e = tid; e < TR * D; e += NT) {
    const int r = e / D, d = e - r * D;
    float o = acc[r * ld + d] / lsafe_s[r];
    if (ft && correct) o = (isfinite(o) && fabsf(o) <= bound) ? o : 0.f;
    acc[r * ld + d] = o;
  }
  __syncthreads();
  if (ft) {
    for (int e = tid; e < TR * sout; e += NT) {
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
  T* og = (T*)P.out + ((size_t)bh * P.Sq + r0) * D;
  for (int e = tid; e < nrows * D; e += NT) {
    const int r = e / D, d = e - r * D;
    og[e] = from_f<T>(acc[r * ld + d]);
  }
  int* rep = P.rep + ((size_t)bh * P.n_q * P.n_sub + tile) * 5;
  for (int k = 0; k < 5; ++k) {
    const int t = block_sum_int<NT>(det[k], (int*)red);
    if (tid == 0) rep[k] = t;
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes =
      smem_floats(p.TR, p.KC, p.D, p.block_kv, p.s_kv, p.s_out) *
      sizeof(float);
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      efta_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.BH, p.n_q * p.n_sub);
  efta_attention_kernel<T><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Thread blocks per reference query tile (block_q rows) for these shapes,
// or 0 when no tiling fits one SM's shared memory.
int efta_attention_tiles(int block_q, int block_kv, int D, int s_kv,
                         int s_out) {
  int TR, KC;
  if (block_q <= 0 || !choose_tiles(block_q, block_kv, D, s_kv, s_out, &TR,
                                    &KC))
    return 0;
  return (block_q + TR - 1) / TR;
}

const char* efta_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). q and out are
// (BH, Sq, D), k and v (BH / grp, Skv, D), all contiguous device arrays;
// rep is (BH, n_q * tiles, 5) int32. The launch goes on `stream`.
int efta_attention_launch(int dtype, const void* q, const void* k,
                          const void* v, void* out, void* rep, int BH,
                          int grp, int Sq, int Skv, int D, int block_q,
                          int block_kv, int n_q, int n_kv, int kv_len,
                          int s_kv, int s_out, int causal, int window,
                          float scale, float eps1, float eps2, float eps3,
                          float cap, float cap_g, float cap_m, float upper,
                          int mode, int unified, int shadow_rowsum,
                          int shadow_rowmax, int f0, int f1, int f2, int f3,
                          int f4, int f5, int f6, int f7, void* stream) {
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
  if (!choose_tiles(block_q, block_kv, D, s_kv, s_out, &p.TR, &p.KC))
    return (int)cudaErrorInvalidValue;
  p.n_sub = (block_q + p.TR - 1) / p.TR;
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
