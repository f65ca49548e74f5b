// Chunkwise stabilised mLSTM, backward, for Hopper (sm_90a).
//
// The gradient of the function `mlstm_chunk.cu` computes: given q, k, v, li,
// lf (k pre-scaled), the initial state (C0, n0, m0) where there is one, the
// forward's h, and dh with the final state's dC, dn, dm where autograd passes
// them, it returns dq, dk, dv, dli, dlf and the initial state's dC0, dn0,
// dm0. It replaces JAX's autodiff of the chunk scan over `_mlstm_chunk_body`
// (src/repro/models/xlstm.py:59-116); the TPU kernel whose function this is
// the gradient of is `_mlstm_kernel` (src/repro/kernels/mlstm_chunk.py:22,
// `pl.pallas_call` at :88), which has no backward of its own. Per chunk of L
// steps, with the forward's notation (W[t,s] = exp(g_s - run_t) for s <= t,
// P = (Q K^T) .* W, w_t = exp(m0 - run_t), wk_s = exp(g_s - run_L), a_t =
// sum_s P[t,s] + w_t q_t . n0, D_t = max(|a_t|, exp(-m_t)), h = N / D):
//   dN_t = dh_t / D_t;  a_t's gradient da_t = -sign(a_t) (dh_t . h_t) / D_t
//   where |a_t| wins, else the floor's: dm_t = dh_t . h_t;
//   dP = dN V^T + da (s <= t);  dS = dP .* W;  dq += dS K;  dk += dS^T Q;
//   dv += P^T dN;  and from the state the chunk starts from, C0_c, and the
//   gradient its output state receives, dC_c (the reverse walk below):
//   dq_t += w_t (C0_c dN_t + da_t n0_c),  dk_s += wk_s (dC_c v_s + dn_c),
//   dv_s += wk_s dC_c^T k_s,  dC_{c-1} = decay_c dC_c + sum_t w_t q_t dN_t^T;
//   the gates: every exponent is g_s - run_t, so each weight's gradient goes
//   to g_s and to run_t, and run_t = max(m0, max_{s<=t} g_s) hands it on to
//   the g at the running argmax or to the chunk's m0, and so to the chunk
//   before (torch's rule: the later index of a tie; half each where m0 ties).
//
// Design: six passes, all on CUDA cores in fp32, with the gates' scans and
// every exponent's difference in fp64 as the forward has them; no atomics,
// and every sum across CTAs is a partial written by one CTA and added in a
// fixed order, so two calls give the same bits.
//   1. `bwd_gates`, a CTA per (b, h): the forward's gates again, bit for bit.
//   2. `bwd_states`, a CTA per (64 x 64 tile of C, b h): the forward's walk
//      again, writing the state each chunk starts from (C_c, n_c). The
//      backward recomputes them rather than having the forward save them:
//      the forward stays as it is, and the nc Dh^2 floats (1 GiB at B=2,
//      H=4, S=2048, Dh=1024) live only during this call.
//   3. `bwd_local`, a CTA per (chunk, b h): the intra-chunk L x L terms
//      (Q K^T, dN V^T, dS, P), D_t and da_t again, and the first dq, dk, dv.
//   4. `bwd_walk`, a CTA per (64 x 64 tile of dC, b h): the only sequential
//      part, over the chunks in reverse, writing the gradient each chunk's
//      output state receives (dC_c, dn_c), and at the end dC0, dn0.
//   5. `bwd_inter`, a CTA per (64-wide tile, kind, chunk, b h): the state's
//      terms, four L x Dh x 64 products a tile pair (C0_c dN, dC_c V, Q C0_c,
//      K dC_c), added to dq, dk (row tiles) and dv (column tiles); partial
//      sums of dw_t, dwk_s and d(decay) a tile.
//   6. `bwd_gates_back`, a CTA per (b, h): the gates' gradients in fp64,
//      chunk by chunk in parallel, then the chain of m0 from chunk to chunk.
// Bound on an H100 SXM at xlstm-1.3b's training shape (B=2, H=4, S=2048,
// Dh=1024, L=64): the function's backward does about twice the forward's
// operations, 0.16 ms at the bf16 tensor-core rate, against 0.14 ms of
// reading q, k, v, dh and writing dq, dk, dv in fp32: operations bound.
// This design does ~12 L Dh^2 + 10 L^2 Dh operations a chunk on CUDA cores
// in fp32 (67 TFLOP/s): a floor of ~3 ms, and it writes and reads the
// chunk states and their gradients (2 GiB) besides. Tensor cores (the
// forward's split-bf16 products) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LMAX = 64;          // largest chunk, rows of every chunk tile
constexpr int T = 64;             // edge of a product's output tile
constexpr int KT = 32;            // depth of one product step
constexpr int LDP = T + 4;        // row of a shared tile; keeps float4 alignment
constexpr int THREADS = 256;
constexpr int MAX_DH = 1024;

__host__ __device__ inline int tiles(int Dh) { return (Dh + T - 1) / T; }

struct Scratch {
  double* g;      // (BH, S): g_t = li_t - F_t
  double* run;    // (BH, S): run_t
  float4* step;   // (BH, S): {w_t, wk_t, exp(-m_t), D_t}
  float* decay;   // (BH, nc)
  double2* chain; // (BH, nc): first {F_L, max g}, then {m0, run_L} of each chunk
  float* Cs;      // (BH, nc, Dh, Dh): C at the start of each chunk
  float* ns;      // (BH, nc, Dh): n at the start of each chunk
  float* dCs;     // (BH, nc, Dh, Dh): the gradient of each chunk's output C
  float* dns;     // (BH, nc, Dh)
  float* da;      // (BH, S): the gradient of a_t
  float* dmf;     // (BH, S): the floor's gradient of m_t
  double* qn0;    // (BH, S): q_t . n0 of its chunk
  double* zr;     // (BH, S): sum_s dP[t,s] P[t,s]
  double* zc;     // (BH, S): sum_t dP[t,s] P[t,s]
  float* dwp;     // (P, BH, S): partial sums of dN_t . (C0^T q_t) a column tile
  float* dwkp;    // (P, BH, S): partial sums of k_s . (dC v_s + dn) a row tile
  float* ddp;     // (P, BH, nc): partial sums of <dC, C0> + dn . n0 a row tile
  double* dg;     // (BH, S)
  double* dF;     // (BH, S)
  double2* dmc;   // (BH, nc): {dm0 of the chunk without dm_out, its share of it}
  double* dmo;    // (BH, nc): the gradient of each chunk's output m
  int* arg;       // (BH, nc): the running argmax of each chunk's last step
};

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

inline size_t scratch_layout(Scratch* s, char* base, int BH, int S, int Dh, int nc) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base + off;
    off = align256(off + bytes);
    return p;
  };
  const size_t n = (size_t)BH * S, m = (size_t)BH * nc, P = tiles(Dh);
  Scratch x;
  x.g = reinterpret_cast<double*>(take(n * 8));
  x.run = reinterpret_cast<double*>(take(n * 8));
  x.step = reinterpret_cast<float4*>(take(n * 16));
  x.decay = reinterpret_cast<float*>(take(m * 4));
  x.chain = reinterpret_cast<double2*>(take(m * 16));
  x.Cs = reinterpret_cast<float*>(take(m * Dh * Dh * 4));
  x.ns = reinterpret_cast<float*>(take(m * Dh * 4));
  x.dCs = reinterpret_cast<float*>(take(m * Dh * Dh * 4));
  x.dns = reinterpret_cast<float*>(take(m * Dh * 4));
  x.da = reinterpret_cast<float*>(take(n * 4));
  x.dmf = reinterpret_cast<float*>(take(n * 4));
  x.qn0 = reinterpret_cast<double*>(take(n * 8));
  x.zr = reinterpret_cast<double*>(take(n * 8));
  x.zc = reinterpret_cast<double*>(take(n * 8));
  x.dwp = reinterpret_cast<float*>(take(P * n * 4));
  x.dwkp = reinterpret_cast<float*>(take(P * n * 4));
  x.ddp = reinterpret_cast<float*>(take(P * m * 4));
  x.dg = reinterpret_cast<double*>(take(n * 8));
  x.dF = reinterpret_cast<double*>(take(n * 8));
  x.dmc = reinterpret_cast<double2*>(take(m * 16));
  x.dmo = reinterpret_cast<double*>(take(m * 8));
  x.arg = reinterpret_cast<int*>(take(m * 4));
  if (s) *s = x;
  return off;
}

// acc[i][j] += sum_k A[k][4 ty + i] B[k][4 tx + j], A and B shared tiles of
// rows of LDP floats, k in [0, K): a 64 x 64 output, 4 x 4 a thread.
template <int K>
__device__ __forceinline__ void mm(float (&acc)[4][4], const float* sA, const float* sB,
                                   int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(sA + k * LDP + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(sB + k * LDP + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Tile loads into shared memory from a row-major source of row stride `ld`:
// rows [0, rows) x columns [0, cols) of the source (zero elsewhere), each
// row r scaled by scale(r). `nat` keeps the layout (s[r][c], r < 64 rows of
// depth); `tr` transposes (s[c][r], c < KT).
template <class Scale>
__device__ __forceinline__ void load_nat(float* s, const float* src, size_t ld, int rows,
                                         int cols, int depth, Scale scale) {
  for (int i = threadIdx.x; i < depth * T; i += THREADS) {
    const int r = i / T, c = i % T;
    s[r * LDP + c] = (r < rows && c < cols) ? src[(size_t)r * ld + c] * scale(r) : 0.f;
  }
}
template <class Scale>
__device__ __forceinline__ void load_tr(float* s, const float* src, size_t ld, int rows,
                                        int cols, Scale scale) {
  for (int i = threadIdx.x; i < T * KT; i += THREADS) {
    const int r = i / KT, c = i % KT;
    s[c * LDP + r] = (r < rows && c < cols) ? src[(size_t)r * ld + c] * scale(r) : 0.f;
  }
}
struct One {
  __device__ float operator()(int) const { return 1.f; }
};

// A sum over the 16 threads of a half-warp (tx = 0 .. 15), in a fixed order.
__device__ __forceinline__ double sum16(double x) {
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ double sum32(double x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// --------------------------------------------------- pass 1: the gates
// The forward's `mlstm_gates` again, so every weight is the forward's bit
// for bit: each chunk's fp64 scan in parallel, the carried m0 in order
// (rounded to fp32 between chunks), then each step's weights.
__global__ void __launch_bounds__(128) bwd_gates(const float* __restrict__ li,
                                                 const float* __restrict__ lf,
                                                 const float* __restrict__ m0p, Scratch sc,
                                                 int S, int chunk, int nc) {
  const int bh = blockIdx.x;
  const size_t gb = (size_t)bh * S;
  double2* ch = sc.chain + (size_t)bh * nc;
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    double F = 0.0, cmax = -INFINITY;
    for (int t = 0; t < Lc; ++t) {
      F += lf[gb + t0 + t];
      const double g = li[gb + t0 + t] - F;
      cmax = fmax(cmax, g);
      sc.g[gb + t0 + t] = g;
    }
    ch[c] = make_double2(F, cmax);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = m0p ? m0p[bh] : -1e30f;
    for (int c = 0; c < nc; ++c) {
      const double2 fc = ch[c];
      const double m0 = m, run_l = fmax(m0, fc.y);
      ch[c] = make_double2(m0, run_l);
      m = (float)(fc.x + run_l);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    const double m0 = ch[c].x, run_l = ch[c].y;
    double F = 0.0, cmax = -INFINITY;
    for (int t = 0; t < Lc; ++t) {
      F += lf[gb + t0 + t];
      const double g = sc.g[gb + t0 + t];
      cmax = fmax(cmax, g);
      const double run = fmax(m0, cmax);
      sc.run[gb + t0 + t] = run;
      sc.step[gb + t0 + t] = make_float4(expf((float)(m0 - run)), expf((float)(g - run_l)),
                                         expf((float)(-(F + run))), 0.f);
    }
    sc.decay[(size_t)bh * nc + c] = expf((float)(m0 - run_l));
  }
}

// ------------------------------------------- pass 2: the chunk-start states
// CTA (tile (dt, et) of C, bh): C[d][e] for 64 d x 64 e, 4 x 4 a thread, over
// the chunks in order; before chunk c's update the tile goes to Cs[c]. The
// CTAs of column tile 0 carry n for their 64 d as well.
__global__ void __launch_bounds__(THREADS) bwd_states(const float* __restrict__ k,
                                                      const float* __restrict__ v,
                                                      const float* __restrict__ C0,
                                                      const float* __restrict__ n0, Scratch sc,
                                                      int S, int Dh, int chunk, int nc) {
  __shared__ __align__(16) float ka[LMAX * LDP];
  __shared__ __align__(16) float vb[LMAX * LDP];
  __shared__ float wks[LMAX];
  const int P = tiles(Dh), bh = blockIdx.y;
  const int d0 = T * (blockIdx.x / P), e0 = T * (blockIdx.x % P);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool carry_n = e0 == 0 && tid < T && d0 + tid < Dh;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + 4 * ty + i, e = e0 + 4 * tx + j;
      acc[i][j] = (C0 && d < Dh && e < Dh) ? C0[((size_t)bh * Dh + d) * Dh + e] : 0.f;
    }
  float n = (carry_n && n0) ? n0[(size_t)bh * Dh + d0 + tid] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    const size_t gb = (size_t)bh * S + t0;
    float* out = sc.Cs + ((size_t)bh * nc + c) * Dh * Dh;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + 4 * ty + i, e = e0 + 4 * tx + j;
        if (d < Dh && e < Dh) out[(size_t)d * Dh + e] = acc[i][j];
      }
    if (carry_n) sc.ns[((size_t)bh * nc + c) * Dh + d0 + tid] = n;
    if (tid < LMAX) wks[tid] = tid < Lc ? sc.step[gb + tid].y : 0.f;
    __syncthreads();
    // k .* wk rounded as the forward rounds it (`__fmul_rn`)
    load_nat(ka, k + gb * Dh + d0, Dh, Lc, Dh - d0, LMAX,
             [&](int r) { return wks[r]; });
    load_nat(vb, v + gb * Dh + e0, Dh, Lc, Dh - e0, LMAX, One());
    __syncthreads();
    const float decay = sc.decay[(size_t)bh * nc + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= decay;
    mm<LMAX>(acc, ka, vb, ty, tx);
    if (carry_n) {
      float sum = 0.f;
      for (int s = 0; s < LMAX; ++s) sum += ka[s * LDP + tid];
      n = fmaf(decay, n, sum);
    }
    __syncthreads();
  }
}

// ------------------------------------------- pass 3: each chunk's own terms
// CTA (c, bh), 256 threads, dynamic shared memory (LocalSmem):
//   A. S = Q K^T and G = dH V^T over Dh, 32 columns a step; per row, dh . h
//      and q . n0 (fp64);
//   B. per row: W, P = S .* W, a_t = sum_s P (fp64) + w_t q_t . n0, D_t, da_t,
//      the floor's dm_t; per element: dP = G / D + da (s <= t), dS = dP .* W,
//      Z = dP .* P and its row and column sums (fp64);
//   C. over Dh, 64 columns a step: dq = dS K, dk = dS^T Q, dv = P^T dN.
struct LocalSmem {
  static constexpr int TILES = 0;                   // A: 4 [KT][LDP]; C: 3 [T][LDP]
  static constexpr int SP = TILES + 3 * T * LDP;    // S, then P       [t][s]
  static constexpr int SG = SP + T * LDP;           // G, then dS      [t][s]
  static constexpr int ST = SG + T * LDP;           // dS transposed   [s][t]
  static constexpr int ROW = ST + T * LDP;          // D, da, w, wk, dhh, qn0 (2 each)
  static constexpr int FLOATS = ROW + 8 * LMAX;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(4 * KT <= 3 * T, "phase A's tiles fit phase C's");
  static_assert(BYTES <= 232448, "over the 227 KiB a CTA may use");
};

__global__ void __launch_bounds__(THREADS) bwd_local(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ h, const float* __restrict__ dh, Scratch sc,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int S, int Dh,
    int chunk, int nc) {
  using L = LocalSmem;
  extern __shared__ __align__(16) float smem[];
  float* sD = smem + L::ROW;
  float* sda = sD + LMAX;
  double* sdhh = reinterpret_cast<double*>(sda + LMAX);   // 8-byte aligned: ROW is even
  double* sqn = sdhh + LMAX;
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16, warp = tid / 32, lane = tid % 32;
  const int t0 = c * chunk, Lc = min(chunk, S - t0);
  const size_t gb = (size_t)bh * S + t0, base = gb * Dh;
  const float* n0 = sc.ns + ((size_t)bh * nc + c) * Dh;
  // ---- A. per row: dh . h and q . n0, in fp64
  for (int t = warp; t < LMAX; t += THREADS / 32) {
    double x = 0.0, y = 0.0;
    if (t < Lc) {
      const size_t r = base + (size_t)t * Dh;
      for (int d = lane; d < Dh; d += 32) {
        x = fma((double)dh[r + d], (double)h[r + d], x);
        y = fma((double)q[r + d], (double)n0[d], y);
      }
    }
    x = sum32(x);
    y = sum32(y);
    if (lane == 0) {
      sdhh[t] = x;
      sqn[t] = y;
    }
  }
  // ---- A. S = Q K^T, G = dH V^T
  float* qT = smem + L::TILES;
  float* kT = qT + KT * LDP;
  float* hT = kT + KT * LDP;
  float* vT = hT + KT * LDP;
  float accS[4][4], accG[4][4];
  zero(accS);
  zero(accG);
  for (int d0 = 0; d0 < Dh; d0 += KT) {
    load_tr(qT, q + base + d0, Dh, Lc, KT, One());
    load_tr(kT, k + base + d0, Dh, Lc, KT, One());
    load_tr(hT, dh + base + d0, Dh, Lc, KT, One());
    load_tr(vT, v + base + d0, Dh, Lc, KT, One());
    __syncthreads();
    mm<KT>(accS, qT, kT, ty, tx);
    mm<KT>(accG, hT, vT, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      smem[L::SP + (4 * ty + i) * LDP + 4 * tx + j] = accS[i][j];
      smem[L::SG + (4 * ty + i) * LDP + 4 * tx + j] = accG[i][j];
    }
  __syncthreads();
  // ---- B. per row t (a warp; lanes s and s + 32): a_t, D_t, da_t
  const double* g = sc.g + gb;
  const double* run = sc.run + gb;
  for (int t = warp; t < LMAX; t += THREADS / 32) {
    double a = 0.0;
    for (int s = lane; s < LMAX; s += 32) {
      const bool in = s <= t && t < Lc;
      const float w = in ? expf((float)(g[s] - run[t])) : 0.f;
      a += (double)(smem[L::SP + t * LDP + s] * w);
    }
    a = sum32(a);
    if (lane == 0) {
      float D = 1.f, da = 0.f;
      if (t < Lc) {
        float4 st = sc.step[gb + t];
        const float af = (float)(a + (double)st.x * sqn[t]), ab = fabsf(af), lo = st.z;
        D = fmaxf(ab, lo);
        // torch.maximum's rule: the larger gets the gradient, a tie half each
        const float to_a = ab > lo ? 1.f : (ab == lo ? 0.5f : 0.f);
        const double dD = -sdhh[t] / D;
        const float sgn = af > 0.f ? 1.f : (af < 0.f ? -1.f : 0.f);
        da = (float)(dD * to_a * sgn);
        sc.dmf[gb + t] = (float)(-dD * (1.f - to_a) * lo);
        sc.da[gb + t] = da;
        sc.qn0[gb + t] = sqn[t];
        st.w = D;
        sc.step[gb + t] = st;
      }
      sD[t] = D;
      sda[t] = da;
    }
  }
  __syncthreads();
  // ---- B. per element: P, dS, Z (Z to phase A's tiles, free now)
  float* sZ = smem + L::TILES;
  for (int t = warp; t < LMAX; t += THREADS / 32) {
    double zr = 0.0;
    for (int s = lane; s < LMAX; s += 32) {
      const bool in = s <= t && t < Lc;
      const float w = in ? expf((float)(g[s] - run[t])) : 0.f;
      const float p = smem[L::SP + t * LDP + s] * w;
      const float dp = in ? smem[L::SG + t * LDP + s] / sD[t] + sda[t] : 0.f;
      const float ds = dp * w, z = dp * p;
      smem[L::SP + t * LDP + s] = p;
      smem[L::SG + t * LDP + s] = ds;
      smem[L::ST + s * LDP + t] = ds;
      sZ[t * LDP + s] = z;
      zr += (double)z;
    }
    zr = sum32(zr);
    if (lane == 0 && t < Lc) sc.zr[gb + t] = zr;
  }
  __syncthreads();
  if (tid < Lc) {
    double zc = 0.0;
    for (int t = 0; t < LMAX; ++t) zc += (double)sZ[t * LDP + tid];
    sc.zc[gb + tid] = zc;
  }
  __syncthreads();
  // ---- C. dq = dS K, dk = dS^T Q, dv = P^T dN, 64 columns a step
  float* kN = smem + L::TILES;
  float* qN = kN + T * LDP;
  float* nN = qN + T * LDP;
  for (int d0 = 0; d0 < Dh; d0 += T) {
    load_nat(kN, k + base + d0, Dh, Lc, Dh - d0, LMAX, One());
    load_nat(qN, q + base + d0, Dh, Lc, Dh - d0, LMAX, One());
    load_nat(nN, dh + base + d0, Dh, Lc, Dh - d0, LMAX, [&](int r) { return 1.f / sD[r]; });
    __syncthreads();
    float aq[4][4], ak[4][4], av[4][4];
    zero(aq);
    zero(ak);
    zero(av);
    mm<LMAX>(aq, smem + L::ST, kN, ty, tx);
    mm<LMAX>(ak, smem + L::SG, qN, ty, tx);
    mm<LMAX>(av, smem + L::SP, nN, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, d = d0 + 4 * tx + j;
        if (r < Lc && d < Dh) {
          const size_t o = base + (size_t)r * Dh + d;
          dq[o] = aq[i][j];
          dk[o] = ak[i][j];
          dv[o] = av[i][j];
        }
      }
    __syncthreads();
  }
}

// --------------------------------------------------- pass 4: the reverse walk
// CTA (tile (dt, et) of dC, bh), over the chunks from the last: the tile
// goes to dCs[c] (the gradient chunk c's output state receives), then dC =
// decay_c dC + sum_t (w_t q_t) (dh_t / D_t)^T. Column tile 0 carries dn =
// decay_c dn + sum_t w_t da_t q_t. After chunk 0: dC0, dn0.
__global__ void __launch_bounds__(THREADS) bwd_walk(const float* __restrict__ q,
                                                    const float* __restrict__ dh,
                                                    const float* __restrict__ dCf,
                                                    const float* __restrict__ dnf, Scratch sc,
                                                    float* __restrict__ dC0,
                                                    float* __restrict__ dn0, int S, int Dh,
                                                    int chunk, int nc) {
  __shared__ __align__(16) float qa[LMAX * LDP];
  __shared__ __align__(16) float nb[LMAX * LDP];
  __shared__ float ws[LMAX], inv[LMAX], das[LMAX];
  const int P = tiles(Dh), bh = blockIdx.y;
  const int d0 = T * (blockIdx.x / P), e0 = T * (blockIdx.x % P);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const bool carry_n = e0 == 0 && tid < T && d0 + tid < Dh;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + 4 * ty + i, e = e0 + 4 * tx + j;
      acc[i][j] = (dCf && d < Dh && e < Dh) ? dCf[((size_t)bh * Dh + d) * Dh + e] : 0.f;
    }
  float dn = (carry_n && dnf) ? dnf[(size_t)bh * Dh + d0 + tid] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    const size_t gb = (size_t)bh * S + t0;
    float* out = sc.dCs + ((size_t)bh * nc + c) * Dh * Dh;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + 4 * ty + i, e = e0 + 4 * tx + j;
        if (d < Dh && e < Dh) out[(size_t)d * Dh + e] = acc[i][j];
      }
    if (carry_n) sc.dns[((size_t)bh * nc + c) * Dh + d0 + tid] = dn;
    if (tid < LMAX) {
      const bool in = tid < Lc;
      const float4 st = in ? sc.step[gb + tid] : make_float4(0.f, 0.f, 0.f, 1.f);
      ws[tid] = st.x;
      inv[tid] = 1.f / st.w;
      das[tid] = in ? sc.da[gb + tid] : 0.f;
    }
    __syncthreads();
    load_nat(qa, q + gb * Dh + d0, Dh, Lc, Dh - d0, LMAX, [&](int r) { return ws[r]; });
    load_nat(nb, dh + gb * Dh + e0, Dh, Lc, Dh - e0, LMAX, [&](int r) { return inv[r]; });
    __syncthreads();
    const float decay = sc.decay[(size_t)bh * nc + c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= decay;
    mm<LMAX>(acc, qa, nb, ty, tx);
    if (carry_n) {
      float sum = 0.f;
      for (int t = 0; t < LMAX; ++t) sum = fmaf(qa[t * LDP + tid], das[t], sum);
      dn = fmaf(decay, dn, sum);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + 4 * ty + i, e = e0 + 4 * tx + j;
      if (dC0 && d < Dh && e < Dh) dC0[((size_t)bh * Dh + d) * Dh + e] = acc[i][j];
    }
  if (carry_n && dn0) dn0[(size_t)bh * Dh + d0 + tid] = dn;
}

// ------------------------------------------------- pass 5: the state's terms
// CTA (tile p of 64 columns, kind, c, bh). Kind 0, rows d of C0_c and dC_c:
//   X = dN C0_c^T and Y = V dC_c^T over all e, 32 a step;
//   dq_t[d] += w_t (X + da_t n0[d]),  dk_s[d] += wk_s (Y + dn[d]);
//   partials: dwk_s = sum_d k_s[d] (Y + dn[d]),  <dC_c, C0_c> + dn . n0.
// Kind 1, columns e of C0_c and dC_c:
//   U = Q C0_c and R = K dC_c over all d;  dv_s[e] += wk_s R;
//   partial: dw_t = sum_e dN_t[e] U[t][e].
__global__ void __launch_bounds__(THREADS) bwd_inter(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dh, Scratch sc, float* __restrict__ dq, float* __restrict__ dk,
    float* __restrict__ dv, int S, int Dh, int chunk, int nc) {
  __shared__ __align__(16) float sa[KT * LDP], sb[KT * LDP], sc2[KT * LDP], sd[KT * LDP];
  __shared__ float ws[LMAX], wks[LMAX], inv[LMAX], das[LMAX];
  __shared__ double red[THREADS / 32];
  const int P = tiles(Dh), kind = blockIdx.x / P, p = blockIdx.x % P;
  const int c = blockIdx.y, bh = blockIdx.z, tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int t0 = c * chunk, Lc = min(chunk, S - t0), x0 = T * p;
  const size_t gb = (size_t)bh * S + t0, base = gb * Dh, BHS = (size_t)gridDim.z * S;
  const size_t sidx = (size_t)bh * nc + c;
  const float* C = sc.Cs + sidx * Dh * Dh;
  const float* dC = sc.dCs + sidx * Dh * Dh;
  const float* n0 = sc.ns + sidx * Dh;
  const float* dn = sc.dns + sidx * Dh;
  if (tid < LMAX) {
    const bool in = tid < Lc;
    const float4 st = in ? sc.step[gb + tid] : make_float4(0.f, 0.f, 0.f, 1.f);
    ws[tid] = st.x;
    wks[tid] = st.y;
    inv[tid] = 1.f / st.w;
    das[tid] = in ? sc.da[gb + tid] : 0.f;
  }
  __syncthreads();
  float a1[4][4], a2[4][4];
  zero(a1);
  zero(a2);
  if (kind == 0) {
    double dd = 0.0;
    for (int e0 = 0; e0 < Dh; e0 += KT) {
      load_tr(sa, dh + base + e0, Dh, Lc, KT, [&](int r) { return inv[r]; });
      load_tr(sc2, v + base + e0, Dh, Lc, KT, One());
      // C0_c and dC_c rows x0.., columns e0..: read by the same thread, so
      // <dC, C0> over this tile is summed here
      for (int i = tid; i < T * KT; i += THREADS) {
        const int r = i / KT, e = i % KT;
        const bool ok = x0 + r < Dh;
        const size_t o = (size_t)(x0 + r) * Dh + e0 + e;
        const float cv = ok ? C[o] : 0.f, dcv = ok ? dC[o] : 0.f;
        sb[e * LDP + r] = cv;
        sd[e * LDP + r] = dcv;
        dd = fma((double)cv, (double)dcv, dd);
      }
      __syncthreads();
      mm<KT>(a1, sa, sb, ty, tx);
      mm<KT>(a2, sc2, sd, ty, tx);
      __syncthreads();
    }
    if (tid < T && x0 + tid < Dh) dd = fma((double)dn[x0 + tid], (double)n0[x0 + tid], dd);
    dd = sum32(dd);
    if (tid % 32 == 0) red[tid / 32] = dd;
    double part[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, d = x0 + 4 * tx + j;
        if (r < Lc && d < Dh) {
          const size_t o = base + (size_t)r * Dh + d;
          dq[o] += ws[r] * (a1[i][j] + das[r] * n0[d]);
          const float y = a2[i][j] + dn[d];
          dk[o] += wks[r] * y;
          part[i] = fma((double)k[o], (double)y, part[i]);
        }
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double s = sum16(part[i]);
      const int r = 4 * ty + i;
      if (tx == 0 && r < Lc) sc.dwkp[p * BHS + gb + r] = (float)s;
    }
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int w = 0; w < THREADS / 32; ++w) s += red[w];
      sc.ddp[(size_t)p * gridDim.z * nc + sidx] = (float)s;
    }
  } else {
    for (int d0 = 0; d0 < Dh; d0 += KT) {
      load_tr(sa, q + base + d0, Dh, Lc, KT, One());
      load_tr(sc2, k + base + d0, Dh, Lc, KT, One());
      load_nat(sb, C + (size_t)d0 * Dh + x0, Dh, KT, Dh - x0, KT, One());
      load_nat(sd, dC + (size_t)d0 * Dh + x0, Dh, KT, Dh - x0, KT, One());
      __syncthreads();
      mm<KT>(a1, sa, sb, ty, tx);
      mm<KT>(a2, sc2, sd, ty, tx);
      __syncthreads();
    }
    double part[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ty + i, e = x0 + 4 * tx + j;
        if (r < Lc && e < Dh) {
          const size_t o = base + (size_t)r * Dh + e;
          dv[o] += wks[r] * a2[i][j];
          part[i] = fma((double)(dh[o] * inv[r]), (double)a1[i][j], part[i]);
        }
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const double s = sum16(part[i]);
      const int r = 4 * ty + i;
      if (tx == 0 && r < Lc) sc.dwp[p * BHS + gb + r] = (float)s;
    }
  }
}

// ------------------------------------------------- pass 6: the gates' gradients
// CTA bh, a thread a chunk (in parallel), in fp64: the gradients of g and of
// run_t from the weights (Z, dw_t w_t, dwk_s wk_s, d(decay) decay) and of
// m_t (the floor), run_t's routed to the running argmax's g or to m0. The
// gradient chunk c's output m receives (dm_out: the next chunk's m0, or the
// final dm) enters linearly at its last step, so a first sweep leaves it
// out, thread 0 chains it from the last chunk back, and a second sweep adds
// it and writes dli = dg and dlf = the in-chunk reverse cumsum of dF = dm - dg.
__global__ void __launch_bounds__(128) bwd_gates_back(Scratch sc, const float* __restrict__ dmf_p,
                                                      float* __restrict__ dli,
                                                      float* __restrict__ dlf,
                                                      float* __restrict__ dm0, int S, int Dh,
                                                      int chunk, int nc) {
  const int bh = blockIdx.x, P = tiles(Dh);
  const size_t BHS = (size_t)gridDim.x * S, BHN = (size_t)gridDim.x * nc;
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    const size_t gb = (size_t)bh * S + t0, ci = (size_t)bh * nc + c;
    const double m0 = sc.chain[ci].x, decay = sc.decay[ci];
    double* dg = sc.dg + gb;
    double* dF = sc.dF + gb;
    double ddecay = 0.0;
    for (int p = 0; p < P; ++p) ddecay += sc.ddp[p * BHN + ci];
    double dm0 = ddecay * decay, tail = ddecay * decay;   // tail: -drun at the last step
    // the weights' gradients; dF holds drun_t for now
    for (int t = 0; t < Lc; ++t) {
      const float4 st = sc.step[gb + t];
      double dw = (double)sc.da[gb + t] * sc.qn0[gb + t], dwk = 0.0;
      for (int p = 0; p < P; ++p) {
        dw += sc.dwp[p * BHS + gb + t];
        dwk += sc.dwkp[p * BHS + gb + t];
      }
      dg[t] = sc.zc[gb + t] + dwk * st.y;
      tail += dwk * st.y;
      dm0 += dw * st.x;
      dF[t] = -sc.zr[gb + t] - dw * st.x + sc.dmf[gb + t];
    }
    dF[Lc - 1] -= tail;
    // route each drun_t: to the running argmax's g (torch's cummax: the
    // later index of a tie) where max g beats m0, to m0 where it loses,
    // half each on a tie
    double cm = -INFINITY, share = 0.0;
    int arg = 0;
    for (int t = 0; t < Lc; ++t) {
      const double gt = sc.g[gb + t];
      if (gt >= cm) {
        cm = gt;
        arg = t;
      }
      share = cm > m0 ? 0.0 : (cm < m0 ? 1.0 : 0.5);
      dg[arg] += (1.0 - share) * dF[t];
      dm0 += share * dF[t];
    }
    // dF_t = dm_t - dg_t (m_t = F_t + run_t, g_t = li_t - F_t)
    for (int t = 0; t < Lc; ++t) dF[t] = sc.dmf[gb + t] - dg[t];
    sc.dmc[ci] = make_double2(dm0, share);   // share: of the last step's run
    sc.arg[ci] = arg;                        // the last step's argmax
  }
  __syncthreads();
  if (threadIdx.x == 0) {                    // dm_out of each chunk, from the last
    double d = dmf_p ? dmf_p[bh] : 0.0;
    for (int c = nc - 1; c >= 0; --c) {
      const size_t ci = (size_t)bh * nc + c;
      const double2 x = sc.dmc[ci];
      sc.dmo[ci] = d;
      d = x.x + x.y * d;
    }
    if (dm0) dm0[bh] = (float)d;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    const size_t gb = (size_t)bh * S + t0, ci = (size_t)bh * nc + c;
    const double share = sc.dmc[ci].y, d = sc.dmo[ci];
    double* dg = sc.dg + gb;
    double* dF = sc.dF + gb;
    const int arg = sc.arg[ci];
    dg[arg] += (1.0 - share) * d;            // m_out = F_L + run_L
    dF[arg] -= (1.0 - share) * d;
    dF[Lc - 1] += d;
    double acc = 0.0;
    for (int t = Lc - 1; t >= 0; --t) {
      acc += dF[t];
      dlf[gb + t] = (float)acc;
      dli[gb + t] = (float)dg[t];
    }
  }
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer that mlstm_chunk_bwd needs.
size_t mlstm_chunk_bwd_scratch_bytes(int BH, int S, int Dh, int chunk) {
  const int nc = (S + chunk - 1) / chunk;
  return scratch_layout(nullptr, nullptr, BH, S, Dh, nc);
}

// q, k, v, h, dh, dq, dk, dv: (BH, S, Dh); li, lf, dli, dlf: (BH, S);
// C0/dC/dC0: (BH, Dh, Dh); n0/dn/dn0: (BH, Dh); m0/dm/dm0: (BH); all fp32
// and contiguous; scratch: 256-byte aligned, of mlstm_chunk_bwd_scratch_bytes().
// C0, n0, m0 may be null (the empty state), as may dC, dn, dm (no gradient
// of the final state) and dC0, dn0, dm0 (none wanted). Dh % 32 == 0, Dh <=
// 1024, 1 <= chunk <= min(64, S). Launches six kernels
// on `stream`; returns a cudaError_t, 0 on success.
int mlstm_chunk_bwd(const float* q, const float* k, const float* v, const float* li,
                    const float* lf, const float* C0, const float* n0, const float* m0,
                    const float* h, const float* dh, const float* dC, const float* dn,
                    const float* dm, float* dq, float* dk, float* dv, float* dli, float* dlf,
                    float* dC0, float* dn0, float* dm0, void* scratch, int BH, int S, int Dh,
                    int chunk, cudaStream_t stream) {
  if (BH < 1 || S < 1 || Dh < 32 || Dh % 32 || Dh > MAX_DH || chunk < 1 || chunk > LMAX ||
      chunk > S)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + chunk - 1) / chunk, P = tiles(Dh);
  Scratch sc;
  scratch_layout(&sc, static_cast<char*>(scratch), BH, S, Dh, nc);
  static const cudaError_t set = cudaFuncSetAttribute(
      bwd_local, cudaFuncAttributeMaxDynamicSharedMemorySize, LocalSmem::BYTES);
  if (set != cudaSuccess) return (int)set;
  bwd_gates<<<BH, 128, 0, stream>>>(li, lf, m0, sc, S, chunk, nc);
  bwd_states<<<dim3(P * P, BH), THREADS, 0, stream>>>(k, v, C0, n0, sc, S, Dh, chunk, nc);
  bwd_local<<<dim3(nc, BH), THREADS, LocalSmem::BYTES, stream>>>(q, k, v, h, dh, sc, dq, dk,
                                                                  dv, S, Dh, chunk, nc);
  bwd_walk<<<dim3(P * P, BH), THREADS, 0, stream>>>(q, dh, dC, dn, sc, dC0, dn0, S, Dh, chunk,
                                                     nc);
  bwd_inter<<<dim3(2 * P, nc, BH), THREADS, 0, stream>>>(q, k, v, dh, sc, dq, dk, dv, S, Dh,
                                                         chunk, nc);
  bwd_gates_back<<<BH, 128, 0, stream>>>(sc, dm, dli, dlf, dm0, S, Dh, chunk, nc);
  return (int)cudaGetLastError();
}

const char* mlstm_chunk_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
