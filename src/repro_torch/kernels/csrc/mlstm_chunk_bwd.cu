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
//   w_t's gradient from the state, dN_t . (C0_c^T q_t) = q_t . (C0_c dN_t);
//   the gates: every exponent is g_s - run_t, so each weight's gradient goes
//   to g_s and to run_t, and run_t = max(m0, max_{s<=t} g_s) hands it on to
//   the g at the running argmax or to the chunk's m0, and so to the chunk
//   before (torch's rule: the later index of a tie; half each where m0 ties).
//
// Design. The Dh^2-sized work, the chunk-start states C0_c, the reverse
// walk of dC_c and the state terms C0_c dN, dC_c V and dC_c^T K, runs on the
// tensor cores as the forward's walk does: each fp32 operand split into three
// bf16 pieces and the six products that fp32 needs summed in fp32 wgmma
// accumulators (mlstm_split.cuh), so every fp32 tolerance holds
// (tests/test_torch_mlstm_precision.py emulates it); the gates' scans and
// every exponent's difference stay in fp64. No atomics: every sum across CTAs
// is a partial written by one CTA and added in a fixed order, so two calls
// give the same bits. Nine launches:
//   1. `bwd_gates`, a CTA per (b, h): the forward's gates again, bit for bit.
//   2. `bwd_split`, a CTA per (chunk, b h): the walks' operands k .* wk, v,
//      dh and k in pieces, and each chunk's sum of k .* wk (n's increment).
//   3. `bwd_local`, a CTA per (chunk, b h), CUDA cores: n at the chunk's
//      start (the recurrence over earlier chunks' increments), the L x L
//      terms (Q K^T, dN V^T, dS, P), D_t and da_t, the first dq, dk, dv, and
//      the chunk's sum of w_t da_t q_t (dn's increment).
//   4. `bwd_split` again: q .* (w / D) in pieces, once D is known.
//   5-7. `bwd_walk_states`, `bwd_walk_dc`, `bwd_walk_dct`: three walks over
//      the chunks, each a CTA per (128 rows a, 256 columns b, b h) of two
//      warpgroups holding a state Z[a, b] as fp32 wgmma accumulators (64 x
//      256 a warpgroup, 128 registers), with the forward walk's TMA ring
//      (warp 0 loads R and Q tiles five ahead into a 6-stage ring of
//      mbarrier-guarded slots, P's 128 columns a chunk into a chunk buffer).
//      Per chunk: first the state term O[a, t] = sum_b Z[a, b] R[t, b] (A =
//      Z split in registers, B = R, K-major), written as a partial sum over
//      the CTA's 256 b; then Z = decay Z + sum_s P[s, a] Q[s, b] (A and B
//      MN-major from shared memory).
//        5. forward, Z = C0 (a = d, b = e): P = k .* wk, Q = v; O = C0 dh^T
//           (dq's and w's terms); C0_c goes out in fp32 in the threads'
//           own register order (coalesced, 1 GiB at the training shape).
//        6. reverse, Z = dC (a = d, b = e): P = q .* (w / D), Q = dh; O =
//           dC v^T (dk's term); <dC_c, C0_c> from the states of 5, each
//           thread its own elements (read a tile ahead), for d(decay); dC0
//           at the end.
//        7. reverse, Z = dC^T (a = e, b = d): P = dh, Q = q .* (w / D); O =
//           dC^T k^T (dv's term).
//      So the state terms are folded into the walks, read from the
//      registers that hold C0_c or dC_c: dC_c never goes to memory, and C0_c
//      only in fp32 for the one dot. A walk holds its state in one
//      orientation, and a state term takes it as A, contracting over b: dC
//      v^T over e and dC^T k^T over d need both, so the dC walk runs twice
//      (the second's update is its only repeated work); holding both at
//      once would need 256 accumulator registers a thread.
//   8. `bwd_terms`, a CTA per (chunk, b h), CUDA cores: adds each walk's
//      partial sums in order into dq, dk, dv, with the rows' dot products
//      that w_t's and wk_s's gradients need, dn by its recurrence, and
//      d(decay) = <dC, C0> + dn . n0.
//   9. `bwd_gates_back`, a CTA per (b, h): the gates' gradients in fp64,
//      chunk by chunk in parallel, then the chain of m0 from chunk to chunk.
// Bound on an H100 SXM at xlstm-1.3b's training shape (B=2, H=4, S=2048,
// Dh=1024, L=64): the function's backward does about twice the forward's
// operations, 0.15 ms at the bf16 tensor-core rate, against 0.14 ms of
// reading q, k, v, dh and writing dq, dk, dv in fp32: operations bound.
// This design's floor: three walks of 2 x 2 L Dh^2 operations a chunk and
// head, each six times on the tensor cores (6 x 12 L Dh^2), 1.25 ms at the
// bf16 rate; beside that it moves 4.8 GB (the chunk-start states written
// and read, 2.1 GB; the walks' partial sums written and read, 1.6 GB; the
// operands' pieces written and read, 1.0 GB), 1.42 ms at 3.35 TB/s, most
// of it under the walks' products. The 4 L^2 Dh-sized local terms stay on
// CUDA cores in fp32 (0.16 ms of operations at 67 TFLOP/s).
// ptxas (sm_90a): bwd_walk_*<4> 222-255 registers, no spills; the other
// passes 32-79 registers, no spills.

#include <math.h>

#include "mlstm_split.cuh"   // split3, wgmma_rs6/ss6, descriptors, TMA (hopper.cuh)

namespace {

constexpr int LMAX = 64;          // largest chunk, rows of every chunk tile
constexpr int T = 64;             // edge of a product's output tile
constexpr int KT = 32;            // depth of one product step
constexpr int LDP = T + 4;        // row of a shared tile; keeps float4 alignment
constexpr int THREADS = 256;
constexpr int MAX_DH = 1024;

// The walks' CTAs: EB rows a (two warpgroups of 64) x nj tiles of 64 columns
// b, ds blocks of columns and eb blocks of rows a head.
constexpr int WALK_THREADS = 2 * WG;
constexpr int EB = 2 * 64;
constexpr int KB = 256;           // columns b a CTA at most (4 tiles, 128 registers)
constexpr int STAGES = 6;         // ring of R or Q tiles
constexpr int TILE = LMAX * 128;  // 64 rows x 64 bf16
constexpr int STAGE_BYTES = PIECES * TILE;
constexpr int CHUNK_BYTES = 2 * PIECES * TILE;   // P's 128 columns a

struct WalkShape {
  int nj, ds, eb;
};
inline WalkShape walk_shape(int Dh) {
  const int tiles = (Dh + 63) / 64, ds = (Dh + KB - 1) / KB;
  return {(tiles + ds - 1) / ds, ds, (Dh + EB - 1) / EB};
}

struct Scratch {
  double* g;      // (BH, S): g_t = li_t - F_t
  double* run;    // (BH, S): run_t
  float4* step;   // (BH, S): {w_t, wk_t, exp(-m_t), D_t}
  float* decay;   // (BH, nc)
  double2* chain; // (BH, nc): first {F_L, max g}, then {m0, run_L} of each chunk
  float* ksum;    // (BH, nc, Dh): sum_s wk_s k_s of each chunk
  float* ns;      // (BH, nc, Dh): n at the start of each chunk
  float* qda;     // (BH, nc, Dh): sum_t w_t da_t q_t of each chunk
  float* da;      // (BH, S): the gradient of a_t
  float* dmf;     // (BH, S): the floor's gradient of m_t
  double* qn0;    // (BH, S): q_t . n0 of its chunk
  double* zr;     // (BH, S): sum_s dP[t,s] P[t,s]
  double* zc;     // (BH, S): sum_t dP[t,s] P[t,s]
  double* dw;     // (BH, S): q_t . (C0 dN_t), the state's share of w_t's gradient
  double* dwk;    // (BH, S): k_s . (dC v_s + dn)
  double* ddec;   // (BH, nc): <dC, C0> + dn . n0 of each chunk
  double* ddp;    // (BH, nc, n_cta, 8): walk 6's <dC, C0> a warp
  float4* cs;     // (BH, nc, n_cta, 8 nj, 256): C0_c as walk 5's threads hold it
  float* xp;      // (ds, BH, S, Dh): partial sums of C0 dh^T, a column block each
  float* yp;      // (ds, BH, S, Dh): of dC v^T
  float* rp;      // (ds, BH, S, Dh): of dC^T k^T
  __nv_bfloat16* kwx;   // (3 BH, S, Dp): k .* wk in pieces
  __nv_bfloat16* vx;    // v
  __nv_bfloat16* dhx;   // dh
  __nv_bfloat16* kx;    // k
  __nv_bfloat16* qwx;   // q .* (w / D)
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
  const WalkShape ws = walk_shape(Dh);
  const size_t n = (size_t)BH * S, m = (size_t)BH * nc, n_cta = (size_t)ws.eb * ws.ds;
  const size_t x = PIECES * n * padded(Dh) * 2;
  Scratch r;
  r.g = reinterpret_cast<double*>(take(n * 8));
  r.run = reinterpret_cast<double*>(take(n * 8));
  r.step = reinterpret_cast<float4*>(take(n * 16));
  r.decay = reinterpret_cast<float*>(take(m * 4));
  r.chain = reinterpret_cast<double2*>(take(m * 16));
  r.ksum = reinterpret_cast<float*>(take(m * Dh * 4));
  r.ns = reinterpret_cast<float*>(take(m * Dh * 4));
  r.qda = reinterpret_cast<float*>(take(m * Dh * 4));
  r.da = reinterpret_cast<float*>(take(n * 4));
  r.dmf = reinterpret_cast<float*>(take(n * 4));
  r.qn0 = reinterpret_cast<double*>(take(n * 8));
  r.zr = reinterpret_cast<double*>(take(n * 8));
  r.zc = reinterpret_cast<double*>(take(n * 8));
  r.dw = reinterpret_cast<double*>(take(n * 8));
  r.dwk = reinterpret_cast<double*>(take(n * 8));
  r.ddec = reinterpret_cast<double*>(take(m * 8));
  r.ddp = reinterpret_cast<double*>(take(m * n_cta * 8 * 8));
  r.cs = reinterpret_cast<float4*>(take(m * n_cta * ws.nj * 8 * WALK_THREADS * 16));
  r.xp = reinterpret_cast<float*>(take(ws.ds * n * Dh * 4));
  r.yp = reinterpret_cast<float*>(take(ws.ds * n * Dh * 4));
  r.rp = reinterpret_cast<float*>(take(ws.ds * n * Dh * 4));
  r.kwx = reinterpret_cast<__nv_bfloat16*>(take(x));
  r.vx = reinterpret_cast<__nv_bfloat16*>(take(x));
  r.dhx = reinterpret_cast<__nv_bfloat16*>(take(x));
  r.kx = reinterpret_cast<__nv_bfloat16*>(take(x));
  r.qwx = reinterpret_cast<__nv_bfloat16*>(take(x));
  r.dg = reinterpret_cast<double*>(take(n * 8));
  r.dF = reinterpret_cast<double*>(take(n * 8));
  r.dmc = reinterpret_cast<double2*>(take(m * 16));
  r.dmo = reinterpret_cast<double*>(take(m * 8));
  r.arg = reinterpret_cast<int*>(take(m * 4));
  if (s) *s = r;
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

// ------------------------------------------- passes 2 and 4: the pieces
// CTA (c, bh): the chunk's rows of the walks' operands, split into three
// bf16 pieces (four columns a thread; the pad columns to Dp are 0). Mode 0:
// k .* wk (rounded as the forward rounds it, `__fmul_rn`), v, dh and k, and
// the chunk's sum of k .* wk over its steps (n's increment, the plain
// version's order); mode 1, once bwd_local has D: q .* (w / D).
__global__ void __launch_bounds__(THREADS) bwd_split(const float* __restrict__ q,
                                                     const float* __restrict__ k,
                                                     const float* __restrict__ v,
                                                     const float* __restrict__ dh, Scratch sc,
                                                     int S, int Dh, int chunk, int nc,
                                                     int mode) {
  __shared__ float scale[LMAX];
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x, BH = gridDim.y;
  const int t0 = c * chunk, Lc = min(chunk, S - t0), Dp = padded(Dh), quads = Dp / 4;
  const size_t gb = (size_t)bh * S + t0, slab = (size_t)BH * S * Dp;
  if (tid < Lc) {
    const float4 st = sc.step[gb + tid];
    scale[tid] = mode == 0 ? st.y : st.x / st.w;
  }
  __syncthreads();
  auto put = [&](__nv_bfloat16* x, size_t off, float4 val) {   // four columns, 8 bytes a piece
    __nv_bfloat16 p[4][PIECES];
    split3(val.x, p[0]);
    split3(val.y, p[1]);
    split3(val.z, p[2]);
    split3(val.w, p[3]);
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const __nv_bfloat162 lo = __halves2bfloat162(p[0][i], p[1][i]);
      const __nv_bfloat162 hi = __halves2bfloat162(p[2][i], p[3][i]);
      *reinterpret_cast<uint2*>(x + i * slab + off) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
  };
  // q, k, v are 8-byte aligned (the wrapper checks), dh only 4-byte
  auto get2 = [&](const float* x, size_t off, bool in) {
    if (!in) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float2 a = *reinterpret_cast<const float2*>(x + off);
    const float2 b = *reinterpret_cast<const float2*>(x + off + 2);
    return make_float4(a.x, a.y, b.x, b.y);
  };
  auto get1 = [&](const float* x, size_t off, bool in) {
    return in ? make_float4(x[off], x[off + 1], x[off + 2], x[off + 3])
              : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto mul = [](float4 x, float s) {
    return make_float4(__fmul_rn(x.x, s), __fmul_rn(x.y, s), __fmul_rn(x.z, s), __fmul_rn(x.w, s));
  };
  for (int i = tid; i < Lc * quads; i += THREADS) {
    const int t = i / quads, d = 4 * (i % quads);
    const bool in = d < Dh;                      // Dh % 4 == 0: a quad is in or out
    const size_t src = (gb + t) * Dh + d, xo = (gb + t) * Dp + d;
    const float s = scale[t];
    if (mode == 0) {
      const float4 kv = get2(k, src, in);
      put(sc.kwx, xo, mul(kv, s));
      put(sc.kx, xo, kv);
      put(sc.vx, xo, get2(v, src, in));
      put(sc.dhx, xo, get1(dh, src, in));
    } else {
      put(sc.qwx, xo, mul(get2(q, src, in), s));
    }
  }
  if (mode == 0) {
    float* ksum = sc.ksum + ((size_t)bh * nc + c) * Dh;
    for (int d = tid; d < Dh; d += THREADS) {
      float sum = 0.f;
      for (int s = 0; s < Lc; ++s) sum += __fmul_rn(k[(gb + s) * Dh + d], scale[s]);
      ksum[d] = sum;
    }
  }
}

// ------------------------------------------- pass 3: each chunk's own terms
// CTA (c, bh), 256 threads, dynamic shared memory (LocalSmem):
//   0. n0 of the chunk: n = decay n + ksum over the chunks before it;
//   A. S = Q K^T and G = dH V^T over Dh, 32 columns a step; per row, dh . h
//      and q . n0 (fp64);
//   B. per row: W, P = S .* W, a_t = sum_s P (fp64) + w_t q_t . n0, D_t, da_t,
//      the floor's dm_t; per element: dP = G / D + da (s <= t), dS = dP .* W,
//      Z = dP .* P and its row and column sums (fp64);
//   C. over Dh, 64 columns a step: dq = dS K, dk = dS^T Q, dv = P^T dN, and
//      dn's increment sum_t w_t da_t q_t.
struct LocalSmem {
  static constexpr int TILES = 0;                   // A: 4 [KT][LDP]; C: 3 [T][LDP]
  static constexpr int SP = TILES + 3 * T * LDP;    // S, then P       [t][s]
  static constexpr int SG = SP + T * LDP;           // G, then dS      [t][s]
  static constexpr int ST = SG + T * LDP;           // dS transposed   [s][t]
  static constexpr int ROW = ST + T * LDP;          // D, da, dhh, qn0 (2 each), w
  static constexpr int NS = ROW + 8 * LMAX;         // n0 of the chunk
  static constexpr int FLOATS = NS + MAX_DH;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(4 * KT <= 3 * T, "phase A's tiles fit phase C's");
  static_assert(BYTES <= 232448, "over the 227 KiB a CTA may use");
};

__global__ void __launch_bounds__(THREADS) bwd_local(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ h, const float* __restrict__ dh, const float* __restrict__ n0p,
    Scratch sc, float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int S,
    int Dh, int chunk, int nc) {
  using L = LocalSmem;
  extern __shared__ __align__(16) float smem[];
  float* sD = smem + L::ROW;
  float* sda = sD + LMAX;
  double* sdhh = reinterpret_cast<double*>(sda + LMAX);   // 8-byte aligned: ROW is even
  double* sqn = sdhh + LMAX;
  float* sw = reinterpret_cast<float*>(sqn + LMAX);
  float* n0 = smem + L::NS;
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16, warp = tid / 32, lane = tid % 32;
  const int t0 = c * chunk, Lc = min(chunk, S - t0);
  const size_t gb = (size_t)bh * S + t0, base = gb * Dh, ci = (size_t)bh * nc + c;
  // ---- 0. n0 of the chunk, as the forward carries n
  {
    const float* decay = sc.decay + (size_t)bh * nc;
    const float* ksum = sc.ksum + (size_t)bh * nc * Dh;
    for (int d = tid; d < Dh; d += THREADS) {
      float n = n0p ? n0p[(size_t)bh * Dh + d] : 0.f;
      for (int j = 0; j < c; ++j) n = fmaf(decay[j], n, ksum[(size_t)j * Dh + d]);
      n0[d] = n;
      sc.ns[ci * Dh + d] = n;
    }
  }
  __syncthreads();
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
      float D = 1.f, da = 0.f, wt = 0.f;
      if (t < Lc) {
        float4 st = sc.step[gb + t];
        const float af = (float)(a + (double)st.x * sqn[t]), ab = fabsf(af), lo = st.z;
        D = fmaxf(ab, lo);
        // torch.maximum's rule: the larger gets the gradient, a tie half each
        const float to_a = ab > lo ? 1.f : (ab == lo ? 0.5f : 0.f);
        const double dD = -sdhh[t] / D;
        const float sgn = af > 0.f ? 1.f : (af < 0.f ? -1.f : 0.f);
        da = (float)(dD * to_a * sgn);
        wt = st.x;
        sc.dmf[gb + t] = (float)(-dD * (1.f - to_a) * lo);
        sc.da[gb + t] = da;
        sc.qn0[gb + t] = sqn[t];
        st.w = D;
        sc.step[gb + t] = st;
      }
      sD[t] = D;
      sda[t] = da;
      sw[t] = wt;
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
    if (tid < T && d0 + tid < Dh) {          // dn's increment over the chunk
      float sum = 0.f;
      for (int t = 0; t < LMAX; ++t) sum = fmaf(qN[t * LDP + tid] * sw[t], sda[t], sum);
      sc.qda[ci * Dh + d0 + tid] = sum;
    }
    __syncthreads();
  }
}

// ---------------------------------------------- passes 5-7: the three walks
// CTA (block ab of EB rows a, block `part` of NJ tiles of 64 columns b, bh),
// two warpgroups, each holding Z[a, b] for its 64 rows a as NJ fp32 m64n64
// accumulators. Over the chunks (in order, or from the last), per chunk:
//   1. O = Z R^T over the CTA's columns (A = Z split in registers, B = R's
//      chunk rows, K-major, from the ring), out to the partial sums op[part];
//   2. STATES: Z (the state the chunk starts from) out to cs, in the
//      threads' register order; DC: dotted with those (a partial a warp);
//   3. Z = decay Z + P^T Q (A = P's chunk rows, MN-major, from the chunk
//      buffer; B = Q's, MN-major, from the ring).
// Warp 0 issues the TMA loads into a 6-stage ring of R and Q tiles (R's NJ,
// then Q's NJ of each chunk) five ahead, and P's 128 columns a chunk into
// the chunk buffer: the forward walk's scheme (mlstm_chunk.cu pass 4), with
// the whole warp, not thread 0, taking the producer's branch.
struct WalkSmem {
  static constexpr int BAR = 0;     // full[STAGES], empty[STAGES], cfull, cempty
  static constexpr int RING = 1024;
  static constexpr int CHUNK = RING + STAGES * STAGE_BYTES;   // P's piece p, half w at (2p + w) TILE
  static constexpr int SMEM = 1024 + CHUNK + CHUNK_BYTES;     // + alignment slack
  static_assert(SMEM <= 232448, "over the 227 KiB a CTA may use");
};

// The walks, by what they do besides the product and the update: the
// chunk-start states go forward and out; dC goes in reverse, dotted with
// them, and out at the end; dC^T goes in reverse. Fixed at compile time: a
// branch at run time around the accumulators made ptxas serialize the wgmma.
enum WalkKind { STATES = 0, DC = 1, DCT = 2 };

struct WalkArgs {
  const float* init;     // Z before the first chunk, (a, b) at bh Dh^2 + a sa + b sb; null: 0
  int init_sa, init_sb;
  float* fin;            // DC: null, or Z after the last chunk, (BH, Dh, Dh) as [a][b]
  float* op;             // (ds, BH, S, Dh): partial sums of O[t][a]
  float4* cs;            // (BH, nc, n_cta, 8 NJ, 256): Z at each chunk's start (STATES
                         // writes, DC reads)
  double* ddp;           // DC: (BH, nc, n_cta, 8) the dot <Z, cs> a warp
  const float* decay;    // (BH, nc)
  int BH, S, Dh, chunk, nc, ds;
};

template <int NJ, int KIND>
__device__ __forceinline__ void walk_body(const CUtensorMap* tm_r, const CUtensorMap* tm_q,
                                          const CUtensorMap* tm_p, const WalkArgs& a) {
  using L = WalkSmem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1 KiB alignment: the 128-byte swizzle repeats every 1024 bytes, and TMA
  // and wgmma agree on it only from such a boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));   // the same, generic
  const uint32_t bar_full = base + L::BAR, bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_cfull = bar_empty + 8 * STAGES, bar_cempty = bar_cfull + 8;
  const int S = a.S, Dh = a.Dh, chunk = a.chunk, nc = a.nc, DS = a.ds;
  const int bh = blockIdx.y, ab = blockIdx.x / DS, part = blockIdx.x % DS;
  const int b_base = part * NJ * 64;
  auto chunk_at = [&](int i) { return KIND == STATES ? i : nc - 1 - i; };

  // rows past a chunk of fewer than 64 steps are never loaded: zero them once
  for (int i = threadIdx.x; i < (L::SMEM - 1024 - L::RING) / 16; i += WALK_THREADS)
    reinterpret_cast<uint4*>(gen + L::RING)[i] = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, WALK_THREADS / 32);    // every warp
    }
    mbar_init(bar_cfull, 1);
    mbar_init(bar_cempty, WALK_THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Ring load n: tile n % NJ of R (first NJ of a chunk) or of Q (next NJ) of
  // the walk's chunk n / (2 NJ), piece p at slab p BH + bh.
  // Warp 0 issues the loads, its lane 0 alone inside the PTX: the warp is
  // the unit of the branch (its index broadcast from lane 0, so the compiler
  // knows it is uniform), and no wgmma wait lands in a divergent path.
  const uint32_t box = chunk * 128;
  const int n_loads = 2 * NJ * nc;
  const bool issue = (threadIdx.x & 31) == 0;
  auto load_tile = [&](int n) {
    const int st = n % STAGES, c = chunk_at(n / (2 * NJ)), j = n % (2 * NJ);
    const uint32_t full = bar_full + 8 * st, dst = base + L::RING + st * STAGE_BYTES;
    const CUtensorMap* map = j < NJ ? tm_r : tm_q;
    mbar_wait(bar_empty + 8 * st, ((n / STAGES) & 1) ^ 1);   // round 0 passes
    mbar_expect_tx_if(full, PIECES * box, issue);
    for (int p = 0; p < PIECES; ++p)
      tma_load_3d_if(dst + p * TILE, map, b_base + 64 * (j % NJ), c * chunk, p * a.BH + bh,
                     full, issue);
  };
  auto load_chunk = [&](int i) {
    const int c = chunk_at(i);
    const uint32_t ch = base + L::CHUNK;
    mbar_wait(bar_cempty, (i & 1) ^ 1);
    mbar_expect_tx_if(bar_cfull, PIECES * 2 * box, issue);
    for (int p = 0; p < PIECES; ++p)
      for (int w = 0; w < 2; ++w)
        tma_load_3d_if(ch + (2 * p + w) * TILE, tm_p, EB * ab + 64 * w, c * chunk,
                       p * a.BH + bh, bar_cfull, issue);
  };
  const bool producer = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0) == 0;
  if (producer) {
    for (int n = 0; n < STAGES - 1 && n < n_loads; ++n) load_tile(n);
    load_chunk(0);
  }
  // freeing ring load n lets load n + STAGES - 1 in (into the slot of n - 1)
  auto release = [&](int n, int lane) {
    mbar_arrive_if(bar_empty + 8 * (n % STAGES), lane == 0);
    if (producer && n + STAGES - 1 < n_loads) load_tile(n + STAGES - 1);
  };

  {
    // the warpgroup, broadcast from lane 0 so the compiler knows it is uniform
    const int w = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / WG, 0);
    const int tid = threadIdx.x % WG, lane = tid & 31;
    const int r = (tid >> 5) * 16 + (lane >> 2);          // rows r, r + 8 of the block
    const int q2 = 2 * (lane & 3);                        // column pair in a block of 8
    const int a_w = EB * ab + 64 * w;                     // this warpgroup's rows a
    // accumulator element i: row r + 8 ((i >> 1) & 1), column 8 (i >> 2) + q2 + (i & 1)
    auto row_of = [&](int i) { return r + 8 * ((i >> 1) & 1); };
    auto col_of = [&](int i) { return 8 * (i >> 2) + q2 + (i & 1); };
    const size_t n_cta = gridDim.x, cta = blockIdx.x;

    float cacc[NJ][32];                   // Z[a_w + row, b_base + 64 j + column]
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int x = a_w + row_of(i), y = b_base + 64 * j + col_of(i);
        cacc[j][i] = (a.init && x < Dh && y < Dh)
                         ? a.init[(size_t)bh * Dh * Dh + (size_t)x * a.init_sa +
                                  (size_t)y * a.init_sb]
                         : 0.f;
      }

    uint32_t a1[2][4], a2[2][4], a3[2][4];   // A fragments of Z, two in turn
    for (int ci = 0, it = 0; ci < nc; ++ci) {
      const int c = chunk_at(ci), t0 = c * chunk, Lc = min(chunk, S - t0);
      const size_t gb = (size_t)bh * S + t0;
      const uint32_t ch = base + L::CHUNK;
      float hq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) hq[i] = 0.f;
      // ---- 1. O = Z R^T over this CTA's columns, a k-step a group, with
      // the fragments of the next built while the last is on the tensor cores
#pragma unroll
      for (int g = 0; g < 4 * NJ; ++g) {
        const int j = g / 4, kk = g % 4, b = g & 1;
        const int st = (it + j) % STAGES;
        const uint32_t tr = base + L::RING + st * STAGE_BYTES;
        if (g >= 2) {
          wgmma_wait<1>();                // group g - 2, which read buffer b, is done
          pin(a1);
          pin(a2);
          pin(a3);
          if ((g - 2) % 4 == 3) release(it + j - 1, lane);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split3_pair(cacc[j][8 * kk + 2 * i], cacc[j][8 * kk + 2 * i + 1], a1[b][i], a2[b][i],
                      a3[b][i]);
        if (kk == 0) mbar_wait(bar_full + 8 * st, ((it + j) / STAGES) & 1);
        const uint64_t rd[PIECES] = {desc_kmajor(tr, kk), desc_kmajor(tr + TILE, kk),
                                     desc_kmajor(tr + 2 * TILE, kk)};
        wgmma_fence();
        wgmma_rs6(hq, a1[b], a2[b], a3[b], rd);
        wgmma_commit();
      }
      wgmma_wait<0>();
      pin(a1);
      pin(a2);
      pin(a3);
      pin(hq);
      release(it + NJ - 1, lane);
      it += NJ;
      float* op = a.op + ((size_t)part * a.BH * S + gb) * Dh;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int t = col_of(i), x = a_w + row_of(i);
        if (t < Lc && x < Dh) op[(size_t)t * Dh + x] = hq[i];
      }
      // ---- 2 and 3. Z out or dotted, then Z = decay Z + P^T Q, a tile a group.
      // DC loads each tile's states one tile ahead, while the tensor cores
      // work, and dots them with Z before its decay
      const float decay = a.decay[(size_t)bh * nc + c];
      float4* cs = a.cs + (((size_t)bh * nc + c) * n_cta + cta) * (8 * NJ) * WALK_THREADS +
                   threadIdx.x;
      double dd = 0.0;
      float4 xs[8];
      if constexpr (KIND == DC) {
#pragma unroll
        for (int m = 0; m < 8; ++m) xs[m] = cs[m * WALK_THREADS];
      }
      mbar_wait(bar_cfull, ci & 1);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int st = (it + j) % STAGES;
        const uint32_t tq = base + L::RING + st * STAGE_BYTES;
        if constexpr (KIND == STATES) {
#pragma unroll
          for (int m = 0; m < 8; ++m)
            cs[(8 * j + m) * WALK_THREADS] = make_float4(cacc[j][4 * m], cacc[j][4 * m + 1],
                                                         cacc[j][4 * m + 2], cacc[j][4 * m + 3]);
        }
        if constexpr (KIND == DC) {
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            dd = fma((double)cacc[j][4 * m], (double)xs[m].x, dd);
            dd = fma((double)cacc[j][4 * m + 1], (double)xs[m].y, dd);
            dd = fma((double)cacc[j][4 * m + 2], (double)xs[m].z, dd);
            dd = fma((double)cacc[j][4 * m + 3], (double)xs[m].w, dd);
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) cacc[j][i] *= decay;
        mbar_wait(bar_full + 8 * st, ((it + j) / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t qd[PIECES] = {desc_mnmajor(tq, kk), desc_mnmajor(tq + TILE, kk),
                                       desc_mnmajor(tq + 2 * TILE, kk)};
          const uint64_t pd[PIECES] = {desc_mnmajor(ch + w * TILE, kk),
                                       desc_mnmajor(ch + (2 + w) * TILE, kk),
                                       desc_mnmajor(ch + (4 + w) * TILE, kk)};
          wgmma_ss6<1>(cacc[j], pd, qd);
        }
        wgmma_commit();
        if constexpr (KIND == DC) {
          if (j + 1 < NJ) {
#pragma unroll
            for (int m = 0; m < 8; ++m) xs[m] = cs[(8 * (j + 1) + m) * WALK_THREADS];
          }
        }
        if (j > 0) {                      // tile j - 1's group is done: free its stage
          wgmma_wait<1>();
          pin(cacc[j - 1]);
          release(it + j - 1, lane);
        }
      }
      wgmma_wait<0>();
      pin(cacc[NJ - 1]);
      release(it + NJ - 1, lane);
      it += NJ;
      mbar_arrive_if(bar_cempty, lane == 0);
      if (producer && ci + 1 < nc) load_chunk(ci + 1);
      if constexpr (KIND == DC) {
        dd = sum32(dd);
        if (lane == 0) a.ddp[(((size_t)bh * nc + c) * n_cta + cta) * 8 + threadIdx.x / 32] = dd;
      }
    }
    if (KIND == DC && a.fin) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int x = a_w + row_of(i), y = b_base + 64 * j + col_of(i);
          if (x < Dh && y < Dh) a.fin[((size_t)bh * Dh + x) * Dh + y] = cacc[j][i];
        }
    }
  }
}

// The three walks: one body under three names, so a profile tells them apart.
#define MLSTM_BWD_WALK(name, kind)                                                            \
  template <int NJ>                                                                         \
  __global__ void __launch_bounds__(WALK_THREADS, 1)                                        \
      name(const __grid_constant__ CUtensorMap tm_r, const __grid_constant__ CUtensorMap tm_q, \
           const __grid_constant__ CUtensorMap tm_p, const WalkArgs a) {                     \
    walk_body<NJ, kind>(&tm_r, &tm_q, &tm_p, a);                                            \
  }
MLSTM_BWD_WALK(bwd_walk_states, STATES)   // 5: C0_c, forward
MLSTM_BWD_WALK(bwd_walk_dc, DC)           // 6: dC_c, reverse
MLSTM_BWD_WALK(bwd_walk_dct, DCT)         // 7: dC_c^T, reverse
#undef MLSTM_BWD_WALK

// ------------------------------------------------- pass 8: the state's terms
// CTA (c, bh): dn (the gradient chunk c's output n receives) by dn = decay dn
// + qda from the last chunk back, d(decay) = walk 6's partials of <dC, C0>
// then dn . n0, in order; then a warp a row, four columns a lane at a time,
// each walk's partial sums added in order:
//   X = C0 dh_t / D_t:   dq_t += w_t (X + da_t n0),  dw_t = q_t . X;
//   Y = dC v_s + dn:     dk_s += wk_s Y,             dwk_s = k_s . Y;
//   R = dC^T k_s:        dv_s += wk_s R.
// Chunk 0's CTA writes dn0.
__global__ void __launch_bounds__(THREADS) bwd_terms(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ dnf,
    Scratch sc, float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dn0, int S, int Dh, int chunk, int nc, int ds, int n_cta) {
  __shared__ float sn[MAX_DH], sdn[MAX_DH];
  __shared__ double red[THREADS / 32];
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = c * chunk, Lc = min(chunk, S - t0);
  const size_t gb = (size_t)bh * S + t0, ci = (size_t)bh * nc + c;
  const size_t part = (size_t)gridDim.y * S * Dh;
  const float* decay = sc.decay + (size_t)bh * nc;
  const float* qda = sc.qda + (size_t)bh * nc * Dh;
  double dd = 0.0;
  for (int d = tid; d < Dh; d += THREADS) {
    float dn = dnf ? dnf[(size_t)bh * Dh + d] : 0.f;
    for (int j = nc - 1; j > c; --j) dn = fmaf(decay[j], dn, qda[(size_t)j * Dh + d]);
    const float n = sc.ns[ci * Dh + d];
    sn[d] = n;
    sdn[d] = dn;
    dd = fma((double)dn, (double)n, dd);
    if (c == 0 && dn0) dn0[(size_t)bh * Dh + d] = fmaf(decay[0], dn, qda[d]);
  }
  dd = sum32(dd);
  if (lane == 0) red[warp] = dd;
  __syncthreads();
  if (tid == 0) {
    const double* p = sc.ddp + ci * n_cta * 8;
    double s = 0.0;
    for (int i = 0; i < n_cta * 8; ++i) s += p[i];
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
    sc.ddec[ci] = s;
  }
  for (int t = warp; t < Lc; t += THREADS / 32) {
    const float4 st = sc.step[gb + t];
    const float w = st.x, wk = st.y, inv = 1.f / st.w, da = sc.da[gb + t];
    const size_t row = (gb + t) * Dh;
    double xw = 0.0, yw = 0.0;
    for (int d = 4 * lane; d < Dh; d += 128) {
      float4 x = *reinterpret_cast<const float4*>(sc.xp + row + d);
      float4 y = *reinterpret_cast<const float4*>(sc.yp + row + d);
      float4 r = *reinterpret_cast<const float4*>(sc.rp + row + d);
      for (int p = 1; p < ds; ++p) {
        const float4 xo = *reinterpret_cast<const float4*>(sc.xp + p * part + row + d);
        const float4 yo = *reinterpret_cast<const float4*>(sc.yp + p * part + row + d);
        const float4 ro = *reinterpret_cast<const float4*>(sc.rp + p * part + row + d);
        x = make_float4(x.x + xo.x, x.y + xo.y, x.z + xo.z, x.w + xo.w);
        y = make_float4(y.x + yo.x, y.y + yo.y, y.z + yo.z, y.w + yo.w);
        r = make_float4(r.x + ro.x, r.y + ro.y, r.z + ro.z, r.w + ro.w);
      }
      float4 gq = *reinterpret_cast<float4*>(dq + row + d);
      float4 gk = *reinterpret_cast<float4*>(dk + row + d);
      float4 gv = *reinterpret_cast<float4*>(dv + row + d);
      const float xs[4] = {x.x * inv, x.y * inv, x.z * inv, x.w * inv};
      const float ys[4] = {y.x + sdn[d], y.y + sdn[d + 1], y.z + sdn[d + 2], y.w + sdn[d + 3]};
      gq.x += w * (xs[0] + da * sn[d]);
      gq.y += w * (xs[1] + da * sn[d + 1]);
      gq.z += w * (xs[2] + da * sn[d + 2]);
      gq.w += w * (xs[3] + da * sn[d + 3]);
      gk.x += wk * ys[0];
      gk.y += wk * ys[1];
      gk.z += wk * ys[2];
      gk.w += wk * ys[3];
      gv.x += wk * r.x;
      gv.y += wk * r.y;
      gv.z += wk * r.z;
      gv.w += wk * r.w;
      *reinterpret_cast<float4*>(dq + row + d) = gq;
      *reinterpret_cast<float4*>(dk + row + d) = gk;
      *reinterpret_cast<float4*>(dv + row + d) = gv;
#pragma unroll
      for (int u = 0; u < 4; ++u) {   // q and k are only 8-byte aligned
        xw = fma((double)q[row + d + u], (double)xs[u], xw);
        yw = fma((double)k[row + d + u], (double)ys[u], yw);
      }
    }
    xw = sum32(xw);
    yw = sum32(yw);
    if (lane == 0) {
      sc.dw[gb + t] = xw;
      sc.dwk[gb + t] = yw;
    }
  }
}

// ------------------------------------------------- pass 9: the gates' gradients
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
                                                      float* __restrict__ dm0, int S,
                                                      int chunk, int nc) {
  const int bh = blockIdx.x;
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const int t0 = c * chunk, Lc = min(chunk, S - t0);
    const size_t gb = (size_t)bh * S + t0, ci = (size_t)bh * nc + c;
    const double m0 = sc.chain[ci].x, decay = sc.decay[ci];
    double* dg = sc.dg + gb;
    double* dF = sc.dF + gb;
    const double ddecay = sc.ddec[ci];
    double dm0 = ddecay * decay, tail = ddecay * decay;   // tail: -drun at the last step
    // the weights' gradients; dF holds drun_t for now
    for (int t = 0; t < Lc; ++t) {
      const float4 st = sc.step[gb + t];
      const double dw = (double)sc.da[gb + t] * sc.qn0[gb + t] + sc.dw[gb + t];
      const double dwk = sc.dwk[gb + t];
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

// Walk `which` (a WalkKind): its three operands' tensor maps (R, Q, P), then
// the launch.
template <int NJ>
cudaError_t launch_walk(int which, const __nv_bfloat16* r, const __nv_bfloat16* q,
                        const __nv_bfloat16* p, const WalkArgs& a, int n_cta,
                        cudaStream_t stream) {
  using Kernel = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, WalkArgs);
  const Kernel kernels[3] = {bwd_walk_states<NJ>, bwd_walk_dc<NJ>, bwd_walk_dct<NJ>};
  static const cudaError_t set[3] = {
      cudaFuncSetAttribute(kernels[0], cudaFuncAttributeMaxDynamicSharedMemorySize, WalkSmem::SMEM),
      cudaFuncSetAttribute(kernels[1], cudaFuncAttributeMaxDynamicSharedMemorySize, WalkSmem::SMEM),
      cudaFuncSetAttribute(kernels[2], cudaFuncAttributeMaxDynamicSharedMemorySize, WalkSmem::SMEM)};
  if (set[which] != cudaSuccess) return set[which];
  const int Dp = padded(a.Dh);
  CUtensorMap tr, tq, tp;
  if (!tensor_map_pieces(&tr, r, Dp, a.S, PIECES * a.BH, a.chunk) ||
      !tensor_map_pieces(&tq, q, Dp, a.S, PIECES * a.BH, a.chunk) ||
      !tensor_map_pieces(&tp, p, Dp, a.S, PIECES * a.BH, a.chunk))
    return cudaErrorInvalidValue;
  kernels[which]<<<dim3(n_cta, a.BH), WALK_THREADS, WalkSmem::SMEM, stream>>>(tr, tq, tp, a);
  return cudaGetLastError();
}

cudaError_t walk(int which, int nj, const __nv_bfloat16* r, const __nv_bfloat16* q,
                 const __nv_bfloat16* p, const WalkArgs& a, int n_cta, cudaStream_t stream) {
  switch (nj) {
    case 1: return launch_walk<1>(which, r, q, p, a, n_cta, stream);
    case 2: return launch_walk<2>(which, r, q, p, a, n_cta, stream);
    case 3: return launch_walk<3>(which, r, q, p, a, n_cta, stream);
    default: return launch_walk<4>(which, r, q, p, a, n_cta, stream);
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
// 1024, 1 <= chunk <= min(64, S). Launches nine kernels on `stream`; returns
// a cudaError_t, 0 on success.
int mlstm_chunk_bwd(const float* q, const float* k, const float* v, const float* li,
                    const float* lf, const float* C0, const float* n0, const float* m0,
                    const float* h, const float* dh, const float* dC, const float* dn,
                    const float* dm, float* dq, float* dk, float* dv, float* dli, float* dlf,
                    float* dC0, float* dn0, float* dm0, void* scratch, int BH, int S, int Dh,
                    int chunk, cudaStream_t stream) {
  if (BH < 1 || S < 1 || Dh < 32 || Dh % 32 || Dh > MAX_DH || chunk < 1 || chunk > LMAX ||
      chunk > S)
    return (int)cudaErrorInvalidValue;
  const int nc = (S + chunk - 1) / chunk;
  const WalkShape ws = walk_shape(Dh);
  const int n_cta = ws.eb * ws.ds;
  Scratch sc;
  scratch_layout(&sc, static_cast<char*>(scratch), BH, S, Dh, nc);
  static const cudaError_t set = cudaFuncSetAttribute(
      bwd_local, cudaFuncAttributeMaxDynamicSharedMemorySize, LocalSmem::BYTES);
  if (set != cudaSuccess) return (int)set;
  const dim3 chunks(nc, BH);
  bwd_gates<<<BH, 128, 0, stream>>>(li, lf, m0, sc, S, chunk, nc);
  bwd_split<<<chunks, THREADS, 0, stream>>>(q, k, v, dh, sc, S, Dh, chunk, nc, 0);
  bwd_local<<<chunks, THREADS, LocalSmem::BYTES, stream>>>(q, k, v, h, dh, n0, sc, dq, dk, dv,
                                                           S, Dh, chunk, nc);
  bwd_split<<<chunks, THREADS, 0, stream>>>(q, k, v, dh, sc, S, Dh, chunk, nc, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 5. C0_c: Z = C (a = d, b = e), O = C0 dh^T
  WalkArgs a{C0, Dh, 1, nullptr, sc.xp, sc.cs, nullptr, sc.decay, BH, S, Dh, chunk, nc, ws.ds};
  err = walk(STATES, ws.nj, sc.dhx, sc.vx, sc.kwx, a, n_cta, stream);
  if (err != cudaSuccess) return (int)err;
  // 6. dC_c: Z = dC (a = d, b = e), O = dC v^T, <dC_c, C0_c>; dC0
  a = WalkArgs{dC, Dh, 1, dC0, sc.yp, sc.cs, sc.ddp, sc.decay, BH, S, Dh, chunk, nc, ws.ds};
  err = walk(DC, ws.nj, sc.vx, sc.dhx, sc.qwx, a, n_cta, stream);
  if (err != cudaSuccess) return (int)err;
  // 7. dC_c again: Z = dC^T (a = e, b = d), O = dC^T k^T
  a = WalkArgs{dC, 1, Dh, nullptr, sc.rp, sc.cs, nullptr, sc.decay, BH, S, Dh, chunk, nc, ws.ds};
  err = walk(DCT, ws.nj, sc.kx, sc.qwx, sc.dhx, a, n_cta, stream);
  if (err != cudaSuccess) return (int)err;
  bwd_terms<<<chunks, THREADS, 0, stream>>>(q, k, dn, sc, dq, dk, dv, dn0, S, Dh, chunk, nc,
                                            ws.ds, n_cta);
  bwd_gates_back<<<BH, 128, 0, stream>>>(sc, dm, dli, dlf, dm0, S, chunk, nc);
  return (int)cudaGetLastError();
}

const char* mlstm_chunk_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
