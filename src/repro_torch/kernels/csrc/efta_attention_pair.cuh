// The body of kernel B2 for one (bh, tile) pair, included inside both
// kernels of efta_attention.cu (not a header of its own): they define T,
// the Params P, the pair's bh and tile, and WIDE (the second layout: scores
// and raw probabilities in workspace slot blockIdx.x).
  constexpr bool BF = sizeof(T) == 2;
  constexpr int RPW = 16 / WPG;  // rows per warp in the row phases
  PHASE_INIT
  const Layout& L = P.L;
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
  // the wide path's workspace slot (this thread block's)
  float* ws = WIDE ? P.ws + (size_t)blockIdx.x * P.S.floats : nullptr;
  float* kf1 = WIDE && P.S.g_kf ? ws + P.S.kf : (float*)(smem + L.kf);
  float* kf2 = kf1 + skv * ldf;
  // the group's rows; row phases index them with wr + r
  float* sp = (WIDE ? ws : (float*)(smem + L.sp)) + gr0 * lds;
  // raw probabilities of the wide EXP pass, as sp
  float* pb = WIDE ? ws + P.S.pb + gr0 * lds : nullptr;
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
  PHASE_MARK(0)

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
      PHASE_MARK(1)
      const T* kb = acquire(ck);
      PHASE_MARK(9)
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
    PHASE_MARK(1)

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
      PHASE_MARK(2)

      // ---- mask, running max (+ shadow): s_kv lanes per row ----
      if constexpr (WIDE) {
        // a row at a time over the whole warp, lanes own columns lane + 32t
        for (int r = wr; r < wr + RPW; ++r) {
          const int row_abs = r0 + gr0 + r;
          float bm = MASK_VALUE;
          for (int i = lane; i < skv; i += 32) {
#pragma unroll 8
            for (int l = 0; l < g_kv; ++l) {
              const int col = kv_start + l * skv + i;
              const bool mk = col < P.kv_len &&
                              (!P.causal || col <= row_abs) &&
                              row_abs - col < P.window;
              bm = nan_max(bm, mk ? sp[r * lds + l * skv + i] : MASK_VALUE);
            }
          }
          for (int o = 16; o > 0; o >>= 1)
            bm = nan_max(bm, __shfl_xor_sync(FULL, bm, o));
          if (lane == 0) {
            const float mp = m_s[r];
            float mn = nan_max(mp, bm);
            if (hit && f_site == S_ROWMAX && r == fg)
              mn = flip_bit(mn, f_bit);
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
      } else {
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
              const bool mk = col < P.kv_len &&
                              (!P.causal || col <= row_abs) &&
                              row_abs - col < P.window;
              bm = nan_max(bm, mk ? sp[r * lds + l * skv + i] : MASK_VALUE);
            }
          }
          for (int o = skv >> 1; o > 0; o >>= 1)
            bm = nan_max(bm, __shfl_xor_sync(FULL, bm, o));
          if (valid && i == 0) {
            const float mp = m_s[r];
            float mn = nan_max(mp, bm);
            if (hit && f_site == S_ROWMAX && r == fg)
              mn = flip_bit(mn, f_bit);
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
      }
      __syncwarp();
      PHASE_MARK(3)

      // ---- EXP with checksum reuse (paper Case 2), backstop, mask, rowsum
      //      (+ shadow) and the SNVR tracker; p is written over s ----
      if constexpr (WIDE) {
        for (int r = wr; r < wr + RPW; ++r) {
          const int row_abs = r0 + gr0 + r;
          const float ms = msub_s[r];
          float ps = 0.f, ps2 = 0.f;
          for (int i = lane; i < skv; i += 32) {
            float* srow = sp + r * lds + i;
            float* prow = pb + r * lds + i;
            float prod = 1.f;
            bool col_ok = true;
#pragma unroll 4
            for (int l = 0; l < g_kv; ++l) {
              const float sv = srow[l * skv];
              float x = expf(nan_min(sv - ms, P.cap));
              if (hit && f_site == S_EXP && r == fg && l * skv + i == f_col)
                x = flip_bit(x, f_bit);
              prow[l * skv] = x;  // read back below: what prod checked
              prod = prod * x;
              col_ok = col_ok && !((sv - ms) > P.cap_m);
            }
            bool redo = false;
            if (ft) {
              const float pc1 = expf(
                  nan_min(sc1[r * skv + i] - (float)g_kv * ms, P.cap_g));
              const float ref = nan_max(fabsf(pc1), 1e-20f);
              const bool bad =
                  col_ok && (fabsf(prod - pc1) > P.eps2 * ref + 1e-20f);
              if (r - wr < nrw) det[1] += bad;
              redo = correct && bad;
            }
#pragma unroll 4
            for (int l = 0; l < g_kv; ++l) {
              const float sv = srow[l * skv];
              float x = redo ? expf(nan_min(sv - ms, P.cap)) : prow[l * skv];
              if (ft && P.shadow_rowmax && correct) {
                // exact recompute backstop
                const float rc = expf(nan_min(sv - ms, P.cap));
                const bool slipped = x != rc;
                if (r - wr < nrw) det[1] += slipped;
                if (slipped) x = rc;
              }
              const int col = kv_start + l * skv + i;
              const bool mk = col < P.kv_len &&
                              (!P.causal || col <= row_abs) &&
                              row_abs - col < P.window;
              x = mk ? x : 0.f;
              srow[l * skv] = x;
              ps = ps + x;
              ps2 = ps2 + opaque(x);
            }
          }
          for (int o = 16; o > 0; o >>= 1) {
            ps = ps + __shfl_xor_sync(FULL, ps, o);
            ps2 = ps2 + opaque(__shfl_xor_sync(FULL, ps2, o));
          }
          if (lane == 0) {
            const float a = alpha_s[r];
            float ln = a * l_s[r] + ps;
            if (hit && f_site == S_ROWSUM && r == fg)
              ln = flip_bit(ln, f_bit);
            l_s[r] = ln;
            if (ft && P.shadow_rowsum) lsh_s[r] = a * lsh_s[r] + ps2;
            const float bm = bmax_s[r];
            r_s[r] = a * r_s[r] +
                     (bm > MASK_HALF ? expf(bm - msub_s[r]) : 0.f);
          }
        }
      } else {
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
              const bool mk = col < P.kv_len &&
                              (!P.causal || col <= row_abs) &&
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
            if (hit && f_site == S_ROWSUM && r == fg)
              ln = flip_bit(ln, f_bit);
            l_s[r] = ln;
            if (ft && P.shadow_rowsum) lsh_s[r] = a * lsh_s[r] + ps2;
            const float bm = bmax_s[r];
            r_s[r] = a * r_s[r] +
                     (bm > MASK_HALF ? expf(bm - msub_s[r]) : 0.f);
          }
        }
      }
    }

    PHASE_MARK(4)
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
        PHASE_MARK(5)
        const T* vb = acquire(nc + sl * nc + ck);
        PHASE_MARK(10)
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
          PHASE_MARK(11)
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
          PHASE_MARK(12)
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
    PHASE_MARK(5)
    __syncthreads();  // the ring is free for the next block's prologue
    PHASE_MARK(6)
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
  PHASE_MARK(7)
  PHASE_FLUSH
