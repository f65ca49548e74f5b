// Chunkwise stabilised mLSTM, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mlstm_kernel`
// (src/repro/kernels/mlstm_chunk.py:22, launched by `mlstm_chunk` at :73
// through `pl.pallas_call` at :88). Per (batch, head) and per chunk of L
// steps, in order, with the state (C, n, m) carried from chunk to chunk:
//     F = cumsum(lf),  g = li - F,  run_t = max(m0, max_{s<=t} g_s),
//     m_t = F_t + run_t,  W[t,s] = exp(g_s - run_t) for s <= t, else 0,
//     w_t = exp(m0 - run_t),  n_t = W K + w_t n0,
//     h_t = ((Q K^T .* W) V + w_t q_t C0) / max(|q_t . n_t|, exp(-m_t)),
//     C = exp(m0 - run_L) C0 + sum_s exp(g_s - run_L) k_s v_s^T,  n likewise,
//     m = m_L.
// These are the reference's exponents (`_mlstm_chunk_body`,
// src/repro/models/xlstm.py:59) with F_t - m_t = -run_t cancelled by hand.
// The denominator keeps the reference's order, the vector n_t first and then
// its dot with q_t: where |q_t . n_t| nears 0 (it does in random-weight
// models) h_t is ill-conditioned, and summing the same terms in another
// order (rowsum(Q K^T .* W) + w_t q_t . n0) moved h there by more than the
// reference's own rounding. For margin that dot product is summed in fp64,
// and so are the gates' scans (64 scalars a chunk), whose differences
// g_s - run_t of numbers in the hundreds are the exponents of W; the other
// Dh-term dot products are summed as 32 partial sums of 32 terms. Beyond
// the TPU kernel it takes an initial state, returns the final one, and
// takes a last chunk shorter than L. All else is fp32 on CUDA cores: no
// tensor cores (no TF32), no fast-math.
//
// Design. The Pallas kernel keeps C (Dh x Dh) whole in VMEM and walks the
// chunks as a sequential grid axis. At xlstm-1.3b's Dh = 1024, C is 4 MiB
// per (batch, head), far beyond one SM's 227 KB, and CUDA blocks run in no
// order. So the work is split in two kernels:
//   1. `mlstm_qk`, one CTA per (b*h, chunk), all in parallel: what needs no
//      state, into scratch buffers. That is the L x L product Q K^T, and
//      nloc_t = sum_{s<=t} exp(g_s - c_t) k_s with c_t = max_{s<=t} g_s,
//      which is W K up to the factor exp(c_t - run_t).
//   2. `mlstm_scan`, one CTA per (b*h, 32-column slice e of the values),
//      each walking the chunks in order inside the CTA. h[:, e] and C[:, e]
//      need only columns e of V and C, so the CTA holds its slice of C
//      (Dh x 32 fp32, 128 KiB at Dh = 1024) in dynamic shared memory for the
//      whole walk. What every slice shares is cheap given pass 1: the gates'
//      scans (L scalars), the weighted scores (L x L from the scratch), and
//      n (Dh floats) with q . n_t, which each CTA keeps and computes itself.
// Pass 1 holds what every column slice would otherwise recompute: two
// L x L x Dh products, Dh/32 times over. Keeping them in one pass costs a
// write and Dh/32 reads of the scratch per chunk, far less than those
// products.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 without tensor cores, 3.35 TB/s):
// (6 L^2 Dh + 4 L Dh^2) operations per chunk and head against reading q, k,
// v and writing h once (16 S Dh bytes per head). At the xlstm-1.3b prefill
// (Dh = 1024, L = 64) it is bound by the operations. This first version
// streams q and k through shared memory in 32-column tiles (the next tile's
// loads in flight in registers while this one is used) with register tiles
// of 2x4 and 1x4, so the products are bound by shared-memory reads and by
// 8 warps an SM; wgmma in TF32 or bf16 and TMA are for later.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LMAX = 64;          // largest chunk
constexpr int E = 32;             // value columns of C per scan CTA
constexpr int DT = 32;            // key columns per streamed q/k tile
constexpr int THREADS = 256;
constexpr int LDT = DT + 1;       // padded row stride of the q/k tiles
constexpr int LDS = LMAX + 1;     // padded row stride of the score tile
constexpr int MAX_DH = 1024;

// ------------------------------------------------ pass 1: Q K^T and n_loc
// CTA (c, bh), for the chunk's rows t, s < L_c (zero past L_c):
//   qk[bh][c][t][s] = q_t . k_s,
//   nloc[t] = sum_{s<=t} exp(g_s - c_t) k_s, with c_t = max_{s<=t} g_s,
// the intra-chunk part of n_t up to the factor exp(c_t - run_t), which
// needs the carried m0 and is applied in pass 2. Neither needs the state.
// QK^T: 256 threads, each a 4x4 tile (t = ty + 16 i, s = tx + 16 j);
// nloc: each 2 rows (t = uy, uy + 32) x 4 columns (4 ux ..) of a key tile.
__global__ void __launch_bounds__(THREADS) mlstm_qk(const float* __restrict__ q,
                                                    const float* __restrict__ k,
                                                    const float* __restrict__ li,
                                                    const float* __restrict__ lf,
                                                    float* __restrict__ qk,
                                                    float* __restrict__ nloc,
                                                    int S, int Dh, int chunk) {
  __shared__ float qs[LMAX * LDT];
  __shared__ float ks[LMAX * LDT];
  __shared__ float wl[LMAX * LDS];   // exp(g_s - c_t), s <= t
  __shared__ double gs[LMAX], cm[LMAX];
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int t0 = c * chunk, Lc = min(chunk, S - t0);
  const size_t base = ((size_t)bh * S + t0) * Dh;
  if (tid == 0) {     // the same scan as pass 2's, so c_t is the same
    double F = 0.0, run = -INFINITY;
    for (int t = 0; t < Lc; ++t) {
      F += lf[(size_t)bh * S + t0 + t];
      const double g = li[(size_t)bh * S + t0 + t] - F;
      run = fmax(run, g);
      gs[t] = g;
      cm[t] = run;
    }
  }
  __syncthreads();
  for (int i = tid; i < LMAX * LMAX; i += THREADS) {
    const int t = i / LMAX, s = i % LMAX;
    wl[t * LDS + s] = (s <= t && t < Lc) ? expf((float)(gs[s] - cm[t])) : 0.f;
  }
  const int tx = tid & 15, ty = tid >> 4;
  const int ux = tid & 7, uy = tid >> 3;
  float acc[4][4] = {};
  for (int d0 = 0; d0 < Dh; d0 += DT) {
    for (int i = tid; i < LMAX * DT; i += THREADS) {
      const int r = i / DT, j = i % DT;
      const bool ok = r < Lc;
      const size_t off = base + (size_t)r * Dh + d0 + j;
      qs[r * LDT + j] = ok ? q[off] : 0.f;
      ks[r * LDT + j] = ok ? k[off] : 0.f;
    }
    __syncthreads();
    float part[4][4] = {};       // a sum of DT terms, then added to the total
#pragma unroll 8
    for (int j = 0; j < DT; ++j) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty + 16 * i) * LDT + j];
        b[i] = ks[(tx + 16 * i) * LDT + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) part[i][jj] = fmaf(a[i], b[jj], part[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] += part[i][jj];
    float nl[2][4] = {};
#pragma unroll 8
    for (int s = 0; s < LMAX; ++s) {
      const float w0 = wl[uy * LDS + s], w1 = wl[(uy + 32) * LDS + s];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float kv = ks[s * LDT + 4 * ux + u];
        nl[0][u] = fmaf(w0, kv, nl[0][u]);
        nl[1][u] = fmaf(w1, kv, nl[1][u]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = uy + 32 * r;
      if (t < Lc)
        *reinterpret_cast<float4*>(nloc + base + (size_t)t * Dh + d0 + 4 * ux) =
            make_float4(nl[r][0], nl[r][1], nl[r][2], nl[r][3]);
    }
    __syncthreads();
  }
  float* out = qk + ((size_t)bh * gridDim.x + c) * LMAX * LMAX;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) out[(ty + 16 * i) * LMAX + tx + 16 * jj] = acc[i][jj];
}

// ------------------------------------------------- pass 2: the chunk walk
struct ScanParams {
  const float *q, *k, *v, *li, *lf;
  const float *C0, *n0, *m0;      // initial state; null: C = 0, n = 0, m = -1e30
  const float *qk, *nloc;         // pass 1's outputs
  float *h, *C, *n, *m;           // h and the final state
  int S, Dh, chunk, nc;
};

__host__ __device__ constexpr int scan_smem_floats(int Dh) {
  return Dh * E          // Cs: this CTA's columns of C
         + Dh            // ns: n, whole
         + LMAX * E      // vs: the chunk's columns of V
         + LMAX * LDS    // ss: Q K^T .* W
         + 3 * LMAX * LDT  // qs, ks, nt: a 32-column tile of q, wk-weighted k, nloc
         + 5 * LMAX;     // per-step gate terms
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// CTA (e-slice, bh); 256 threads. Output layout: thread (ty, tx) owns h rows
// t = ty and ty + 32 at columns 4 tx .. 4 tx + 3 of the slice; in the state
// update it owns row d0 + ty of the current key tile at the same columns.
__global__ void __launch_bounds__(THREADS, 1) mlstm_scan(ScanParams p) {
  extern __shared__ __align__(16) float smem[];
  const int Dh = p.Dh, S = p.S;
  float* Cs = smem;
  float* ns = Cs + Dh * E;
  float* vs = ns + Dh;
  float* ss = vs + LMAX * E;
  float* qs = ss + LMAX * LDS;
  float* ks = qs + LMAX * LDT;
  float* nt = ks + LMAX * LDT;    // a tile of nloc
  float* ws = nt + LMAX * LDT;    // exp(m0 - run_t): weight of the carried state
  float* lo = ws + LMAX;          // exp(-m_t): floor of the denominator
  float* wk = lo + LMAX;          // exp(g_s - run_L): weight of k_s v_s^T in C
  float* den = wk + LMAX;         // the denominator
  float* an = den + LMAX;         // exp(c_t - run_t): nloc's factor
  // The gates' scans in fp64: F grows to hundreds within a chunk when the
  // forget gates are small, and g_s - run_t, a difference of two such
  // numbers, would lose its low bits in fp32 (the exponents of W, of the
  // state's weights and of the stabiliser all are such differences)
  __shared__ double Fs[LMAX];     // F_t (first the raw lf_t)
  __shared__ double gs[LMAX];     // g_t (first the raw li_t)
  __shared__ double rn[LMAX];     // run_t
  __shared__ double cm[LMAX];     // c_t
  __shared__ double sc[2];        // m0 of the chunk, run_L
  __shared__ float mc;            // m, carried from chunk to chunk

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int e0 = blockIdx.x * E, bh = blockIdx.y;
  const size_t base = (size_t)bh * S * Dh;     // q, k, v, h of this (b, h)
  const size_t gbase = (size_t)bh * S;         // li, lf

  for (int i = tid; i < Dh * E; i += THREADS) {
    const int d = i / E, e = i % E;
    Cs[i] = p.C0 ? p.C0[((size_t)bh * Dh + d) * Dh + e0 + e] : 0.f;
  }
  for (int d = tid; d < Dh; d += THREADS) ns[d] = p.n0 ? p.n0[(size_t)bh * Dh + d] : 0.f;
  if (tid == 0) mc = p.m0 ? p.m0[bh] : -1e30f;

  for (int c = 0; c < p.nc; ++c) {
    const int t0 = c * p.chunk, Lc = min(p.chunk, S - t0);
    // ---- gates: the scans in order in one thread, then the exponentials
    if (tid < Lc) {
      Fs[tid] = p.lf[gbase + t0 + tid];
      gs[tid] = p.li[gbase + t0 + tid];
    }
    __syncthreads();
    if (tid == 0) {     // the same scan as pass 1's, so c_t is the same
      const double m0 = mc;
      double F = 0.0, cmax = -INFINITY;
      for (int t = 0; t < Lc; ++t) {
        F += Fs[t];
        const double g = gs[t] - F;
        cmax = fmax(cmax, g);
        Fs[t] = F;
        gs[t] = g;
        rn[t] = fmax(m0, cmax);
        cm[t] = cmax;
      }
      sc[0] = m0;
      sc[1] = rn[Lc - 1];
      mc = (float)(F + sc[1]);    // m_L, carried to the next chunk
    }
    __syncthreads();
    if (tid < LMAX) {
      const bool ok = tid < Lc;
      ws[tid] = ok ? expf((float)(sc[0] - rn[tid])) : 0.f;
      lo[tid] = ok ? expf((float)(-(Fs[tid] + rn[tid]))) : 1.f;
      wk[tid] = ok ? expf((float)(gs[tid] - sc[1])) : 0.f;
      an[tid] = ok ? expf((float)(cm[tid] - rn[tid])) : 0.f;
    }
    // ---- weighted scores from pass 1, and this slice's columns of V
    const float* qkc = p.qk + ((size_t)bh * p.nc + c) * LMAX * LMAX;
    for (int i = tid; i < LMAX * LMAX; i += THREADS) {
      const int t = i / LMAX, s = i % LMAX;
      ss[t * LDS + s] = (s <= t && t < Lc) ? qkc[i] * expf((float)(gs[s] - rn[t])) : 0.f;
    }
    for (int i = tid; i < LMAX * E; i += THREADS) {
      const int s = i / E, e = i % E;
      vs[i] = s < Lc ? p.v[base + (size_t)(t0 + s) * Dh + e0 + e] : 0.f;
    }
    __syncthreads();
    const float decay = expf((float)(sc[0] - sc[1]));   // exp(F_L + m0 - m_L)
    // ---- intra-chunk: (Q K^T .* W) V
    // (rows and columns past L_c are zero, so the loop runs over LMAX and unrolls)
    float4 hin[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll 8
    for (int s = 0; s < LMAX; ++s) {
      const float4 b = ld4(vs + s * E + 4 * tx);
      fma4(hin[0], ss[ty * LDS + s], b);
      fma4(hin[1], ss[(ty + 32) * LDS + s], b);
    }
    // ---- inter-chunk: q C0 and q . n_t, then the state update, tile by tile;
    // n_t = exp(c_t - run_t) nloc_t + w_state_t n0 as the reference forms it
    float4 hst[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
    // q_t . n_t in fp64: where it nears 0, h_t's error is this sum's
    double qn = 0.0;
    // the next tile of q and k is loaded into registers while this one is
    // used: its loads are in flight during the products
    constexpr int PER = LMAX * DT / THREADS;
    float qr[PER], kr[PER], nr[PER];
    auto fetch = [&](int d0) {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = tid + u * THREADS, r = i / DT, j = i % DT;
        const size_t off = base + (size_t)(t0 + r) * Dh + d0 + j;
        qr[u] = r < Lc ? p.q[off] : 0.f;
        kr[u] = r < Lc ? p.k[off] : 0.f;
        nr[u] = r < Lc ? p.nloc[off] : 0.f;
      }
    };
    fetch(0);
    for (int d0 = 0; d0 < Dh; d0 += DT) {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = tid + u * THREADS, r = i / DT, j = i % DT;
        qs[r * LDT + j] = qr[u];
        ks[r * LDT + j] = kr[u] * wk[r];
        nt[r * LDT + j] = nr[u];
      }
      __syncthreads();
      if (d0 + DT < Dh) fetch(d0 + DT);
      // reads rows d0 .. d0 + DT of C and n as they were before this chunk;
      // each tile's DT terms are summed apart and then added to the totals,
      // which keeps the rounding of the Dh-term sums near a blocked GEMM's
      float4 part[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll 8
      for (int j = 0; j < DT; ++j) {
        const float4 b = ld4(Cs + (d0 + j) * E + 4 * tx);
        fma4(part[0], qs[ty * LDT + j], b);
        fma4(part[1], qs[(ty + 32) * LDT + j], b);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        hst[r].x += part[r].x;
        hst[r].y += part[r].y;
        hst[r].z += part[r].z;
        hst[r].w += part[r].w;
      }
      if (tid < LMAX) {
        const float a = an[tid], w = ws[tid];
#pragma unroll 8
        for (int j = 0; j < DT; ++j)
          qn = fma((double)qs[tid * LDT + j],
                   (double)fmaf(a, nt[tid * LDT + j], w * ns[d0 + j]), qn);
      }
      __syncthreads();
      // then updates them: row d0 + ty of C at this thread's columns, and n
      {
        float* crow = Cs + (d0 + ty) * E + 4 * tx;
        const float4 c4 = ld4(crow);
        float4 acc = make_float4(decay * c4.x, decay * c4.y, decay * c4.z, decay * c4.w);
        float nsum = 0.f;
#pragma unroll 8
        for (int s = 0; s < LMAX; ++s) {
          const float kw = ks[s * LDT + ty];
          fma4(acc, kw, ld4(vs + s * E + 4 * tx));
          nsum += kw;
        }
        *reinterpret_cast<float4*>(crow) = acc;
        if (tx == 0) ns[d0 + ty] = fmaf(decay, ns[d0 + ty], nsum);
      }
      __syncthreads();
    }
    // ---- h = (intra + w_state q C0) / max(|q . n_t|, exp(-m_t))
    if (tid < LMAX) den[tid] = fmaxf(fabsf((float)qn), lo[tid]);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = ty + 32 * r;
      if (t < Lc) {
        const float w = ws[t], dn = den[t];
        float4 o;
        o.x = (hin[r].x + w * hst[r].x) / dn;
        o.y = (hin[r].y + w * hst[r].y) / dn;
        o.z = (hin[r].z + w * hst[r].z) / dn;
        o.w = (hin[r].w + w * hst[r].w) / dn;
        *reinterpret_cast<float4*>(p.h + base + (size_t)(t0 + t) * Dh + e0 + 4 * tx) = o;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < Dh * E; i += THREADS) {
    const int d = i / E, e = i % E;
    p.C[((size_t)bh * Dh + d) * Dh + e0 + e] = Cs[i];
  }
  for (int e = tid; e < E; e += THREADS) p.n[(size_t)bh * Dh + e0 + e] = ns[e0 + e];
  if (blockIdx.x == 0 && tid == 0) p.m[bh] = mc;
}

}  // namespace

extern "C" {

// q, k, v, h: (BH, S, Dh); li, lf: (BH, S); C0/C: (BH, Dh, Dh); n0/n: (BH,
// Dh); m0/m: (BH); qk: (BH, ceil(S / chunk), 64, 64) and nloc: (BH, S, Dh)
// scratch. C0, n0 and m0
// may be null (the empty state). Dh % 32 == 0, Dh <= 1024, 1 <= chunk <= 64.
// Returns a cudaError_t; 0 on success.
int mlstm_chunk_fwd(const float* q, const float* k, const float* v, const float* li,
                    const float* lf, const float* C0, const float* n0, const float* m0,
                    float* h, float* C, float* n, float* m, float* qk, float* nloc, int BH,
                    int S, int Dh, int chunk, cudaStream_t stream) {
  if (BH < 1 || S < 1 || Dh % E || Dh % DT || Dh > MAX_DH || chunk < 1 || chunk > LMAX)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + chunk - 1) / chunk;
  mlstm_qk<<<dim3(nc, BH), THREADS, 0, stream>>>(q, k, li, lf, qk, nloc, S, Dh, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = scan_smem_floats(Dh) * (int)sizeof(float);
  err = cudaFuncSetAttribute(mlstm_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ScanParams p{q, k, v, li, lf, C0, n0, m0, qk, nloc, h, C, n, m, S, Dh, chunk, nc};
  mlstm_scan<<<dim3(Dh / E, BH), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

const char* mlstm_chunk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
