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
// Beyond the TPU kernel it takes an initial state, returns the final one,
// and takes a last chunk shorter than L. Inputs and outputs are fp32.
//
// Precision. Random-weight xlstm-1.3b is ill-conditioned: where |q_t . n_t|
// nears 0, h_t amplifies any rounding, so the kernel keeps fp32's accuracy
// throughout. The gates' scans and every exponent's difference are fp64 (F
// reaches hundreds within a chunk); q_t . n_t is summed in fp64 with n_t
// formed as the reference forms it; the Dh-wide products go to the tensor
// cores with each fp32 operand split into three bf16 pieces (24 bits), of
// whose nine products the six that fp32 needs are summed in fp32. Two
// pieces (three products, 16 bits) hold tests/test_kernels.py's 3e-4 on
// random inputs but not where the denominator cancels; single-pass TF32 or
// bf16 hold it nowhere (tests/test_torch_mlstm_precision.py).
//
// Design. The TPU kernel keeps C (Dh x Dh, 4 MiB at xlstm-1.3b's Dh = 1024)
// in VMEM and walks the chunks as a sequential grid axis. Here C lives in
// registers, as the walk's wgmma accumulators, and five kernels share the
// work so that only the walk is sequential, and only over Dh^2-sized terms:
//   1. `mlstm_gates`, a CTA per (b, h): the gates' fp64 scans, the carried
//      stabiliser chunk to chunk, each step's weights (w_t, wk_t, exp(-m_t))
//      and each chunk's decay; S floats of work, not Dh-wide.
//   2. `mlstm_prep`, a CTA per (chunk, b h, block of 256 keys), all in
//      parallel on CUDA cores: Q K^T (64 x 64, a partial sum per block), n's
//      intra-chunk part W K dotted with q (fp64), n's per-chunk increment,
//      and the walk's operands q, k .* wk and v cut into bf16 pieces.
//   3. `mlstm_den`, a CTA per (chunk, b h): the weighted scores Q K^T .* W
//      in pieces; n0 of the chunk by the recurrence over earlier chunks'
//      increments; den_t = max(|q_t . n_t|, exp(-m_t)) once per row, where
//      every column slice of the previous design repeated it.
//   4. `mlstm_walk`, a CTA per (128 values e, 256 keys d, b h), 256 threads:
//      two warpgroups, each holding C^T[64 e, 256 d] as 4 fp32 m64n64
//      accumulators (128 registers), walk the chunks in order. Per chunk:
//      h^T = C0^T Q^T (wgmma with C0^T split in registers as A, q by TMA as
//      B), scaled by w_t, plus this key block's share of V^T (Q K^T .* W)^T
//      (both from shared memory), written out as a partial sum; then C^T =
//      decay C^T + V^T (k .* wk) (V^T transposed and k .* wk read MN-major
//      through the descriptors). Thread 0 issues the TMA loads, five tiles
//      ahead in a 6-stage ring of mbarrier-guarded slots (q, then k .* wk,
//      64 keys x 64 steps x 3 pieces a slot) and one chunk buffer (V's 128
//      values and the scores); a separate producer warp would put three
//      warps on one SM sub-partition, and ptxas then caps every thread at
//      168 registers (setmaxnreg or not) and spills the state.
//   5. `mlstm_out`: h = the key blocks' partial sums, in order, / den_t.
// At Dh = 1024, B H = 4 that is 128 walk CTAs, one wave on 132 SMs; the
// key blocks of one e-block share nothing while they run (as a thread-block
// cluster reducing h through distributed shared memory, they did not all
// fit the card at once and ran in two waves).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 67 fp32 without tensor
// cores, 3.35 TB/s): at the xlstm-1.3b prefill (B=1, H=4, S=4096, Dh=1024,
// L=64) the function's own operations, once each at the bf16 rate, take
// 0.08 ms, under the 0.09 ms of reading q, k, v and writing h once: the
// function is bound by its bytes. This design's own work is bound by its
// operations: the walk's six bf16 products of 4 L Dh^2 operations per chunk
// and head take 0.43 ms and the CUDA-core 4 L^2 Dh 0.06 ms, so the split's
// 6x is most of the kernel's floor. The design itself moves about 1.3 GB
// through device memory (the operands' pieces, 288 MiB, and the walk's
// partial sums of h, 256 MiB, each written and read), 0.4 ms of bytes.
// ptxas (sm_90a): mlstm_walk<4> 224 registers, no spills; the other passes
// 32-62 registers, no spills.

#include <math.h>

#include "mlstm_split.cuh"   // split3, wgmma_rs6/ss6, descriptors, TMA (hopper.cuh)

namespace {

constexpr int LMAX = 64;          // largest chunk, rows of every chunk tile
constexpr int DT = 32;            // key columns per tile of the CUDA-core passes
constexpr int THREADS = 256;      // CUDA-core passes
constexpr int LDT = DT + 1;       // padded row stride of their q/k tiles
constexpr int MAX_DH = 1024;

// ------------------------------------------------------------ scratch
// One buffer, laid out by `Scratch`; the wrapper allocates
// mlstm_chunk_scratch_bytes() of it. The walk's tensor-core operands are
// split x = x1 + x2 + x3 into three bf16 pieces, piece p at slab p BH + bh of
// a (3 BH, S, Dp) array, Dp = Dh rounded up to 64 (the pad is 0).
struct Scratch {
  double* g;       // (BH, S): g_t = li_t - F_t, in fp64
  double* run;     // (BH, S): run_t = max(m0, max_{s<=t} g_s), in fp64
  float4* step;    // (BH, S): {w_t = exp(m0 - run_t), wk_t = exp(g_t - run_L),
                   //           lo_t = exp(-m_t), den_t}
  float* decay;    // (BH, nc): exp(m0 - run_L) of each chunk
  double2* chain;  // (BH, nc): first {F_L, c_L}, then {m0, run_L} of each chunk
  double* qnl;     // (P, BH, S): q_t . (W K)_t over key block p, in fp64
  float* qkp;      // (BH, nc, P, 64, 64): Q K^T over key block p
  float* ksum;     // (BH, nc, Dh): sum_s wk_s k_s of each chunk
  float* hp;       // (P, BH, S, Dh): the walk's partial sums of h's numerator
  __nv_bfloat16* qx;    // (3 BH, S, Dp): q, split
  __nv_bfloat16* kwx;   // (3 BH, S, Dp): k_t wk_t, split
  __nv_bfloat16* vx;    // (3 BH, S, Dp): v, split
  __nv_bfloat16* swx;   // (3 BH nc, 64, 64): Q K^T .* W of each chunk, split
};

constexpr int KB = 256;           // keys per block of passes 2 and 4 (4 walk tiles)
__host__ __device__ inline int key_blocks(int Dh) { return (Dh + KB - 1) / KB; }

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

inline size_t scratch_layout(Scratch* s, char* base, int BH, int S, int Dh, int nc) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base + off;
    off = align256(off + bytes);
    return p;
  };
  const size_t n = (size_t)BH * S, m = (size_t)BH * nc, x = PIECES * n * padded(Dh) * 2;
  const int P = key_blocks(Dh);
  char* g = take(n * 8);
  char* run = take(n * 8);
  char* step = take(n * 16);
  char* decay = take(m * 4);
  char* chain = take(m * 16);
  char* qnl = take(P * n * 8);
  char* qkp = take(m * P * LMAX * LMAX * 4);
  char* ksum = take(m * Dh * 4);
  char* hp = take(P * n * Dh * 4);
  char* qx = take(x);
  char* kwx = take(x);
  char* vx = take(x);
  char* swx = take(PIECES * m * LMAX * LMAX * 2);
  if (s) *s = Scratch{reinterpret_cast<double*>(g), reinterpret_cast<double*>(run),
                      reinterpret_cast<float4*>(step), reinterpret_cast<float*>(decay),
                      reinterpret_cast<double2*>(chain), reinterpret_cast<double*>(qnl),
                      reinterpret_cast<float*>(qkp), reinterpret_cast<float*>(ksum),
                      reinterpret_cast<float*>(hp), reinterpret_cast<__nv_bfloat16*>(qx),
                      reinterpret_cast<__nv_bfloat16*>(kwx), reinterpret_cast<__nv_bfloat16*>(vx),
                      reinterpret_cast<__nv_bfloat16*>(swx)};
  return off;
}

// ----------------------------------------------- pass 1: the gates' scans
// CTA bh. The gates decide every weight, and m carries from chunk to chunk
// through them alone, so one small pass does all of it in fp64 (F reaches
// hundreds within a chunk when the forget gates are small, and every
// exponent below is a difference of two such numbers): each chunk's own scan
// (F_L, c_L = max g), in parallel; the carried m0 of each chunk, in order
// (rounded to fp32 between chunks, as the plain version carries it); then
// each step's weights.
__global__ void __launch_bounds__(128) mlstm_gates(const float* __restrict__ li,
                                                   const float* __restrict__ lf,
                                                   const float* __restrict__ m0p, Scratch sc,
                                                   float* __restrict__ m_out, int S, int chunk,
                                                   int nc) {
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
      m = (float)(fc.x + run_l);          // m_L, carried to the next chunk
    }
    m_out[bh] = m;
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

// --------------------------------------- pass 2: each chunk's local terms
// CTA (c, bh, key block p of KB keys), all in parallel, on CUDA cores; W[t,s]
// = exp(g_s - run_t) for s <= t < L_c, else 0; over the block's keys:
//   qkp[t][s] = q_t . k_s                    Q K^T, a partial sum,
//   qnl[t] = q_t . (W K)_t, in fp64          n's intra-chunk part, dotted,
//   ksum = sum_s wk_s k_s                    n's increment over the chunk;
// and the walk's operands q, k_t wk_t and v, split into three bf16 pieces
// (each element once).
// 256 threads: Q K^T in 4x4 tiles (t = ty + 16 i, s = tx + 16 j); W K in 2
// rows (t = uy, uy + 32) x 4 columns (4 ux ..) of each 32-column key tile.
__global__ void __launch_bounds__(THREADS) mlstm_prep(const float* __restrict__ q,
                                                      const float* __restrict__ k,
                                                      const float* __restrict__ v, Scratch sc,
                                                      int S, int Dh, int chunk, int nc) {
  constexpr int LDS = LMAX + 1;
  __shared__ float qs[LMAX * LDT];
  __shared__ float ks[LMAX * LDT];
  __shared__ float wl[LMAX * LDS];
  __shared__ float wks[LMAX];
  const int c = blockIdx.x, bh = blockIdx.y, p = blockIdx.z, tid = threadIdx.x;
  const int t0 = c * chunk, Lc = min(chunk, S - t0);
  const int P = gridDim.z, d_lo = p * KB, d_hi = min(Dh, d_lo + KB);
  const size_t gb = (size_t)bh * S + t0, base = gb * Dh;
  for (int i = tid; i < LMAX * LMAX; i += THREADS) {
    const int t = i / LMAX, s = i % LMAX;
    wl[t * LDS + s] =
        (s <= t && t < Lc) ? expf((float)(sc.g[gb + s] - sc.run[gb + t])) : 0.f;
  }
  if (tid < LMAX) wks[tid] = tid < Lc ? sc.step[gb + tid].y : 0.f;
  const int tx = tid & 15, ty = tid >> 4;
  const int ux = tid & 7, uy = tid >> 3;
  float* ksum = sc.ksum + ((size_t)bh * nc + c) * Dh;
  const int Dp = padded(Dh), BH = gridDim.y;
  // element (t, d) of this chunk's rows, in pieces, in a (3 BH, S, Dp) array
  const size_t slab = (size_t)BH * S * Dp;
  auto put = [&](__nv_bfloat16* x, size_t off, float2 val) {   // two columns
    __nv_bfloat16 p0[PIECES], p1[PIECES];
    split3(val.x, p0);
    split3(val.y, p1);
    for (int i = 0; i < PIECES; ++i)
      *reinterpret_cast<__nv_bfloat162*>(x + i * slab + gb * Dp + off) =
          __halves2bfloat162(p0[i], p1[i]);
  };
  __syncthreads();
  float acc[4][4] = {};
  double qn[2] = {0.0, 0.0};
  for (int d0 = d_lo; d0 < d_hi; d0 += DT) {
    for (int i = tid; i < LMAX * DT / 2; i += THREADS) {   // two columns a thread
      const int r = i / (DT / 2), j = 2 * (i % (DT / 2));
      const bool ok = r < Lc;
      const size_t off = base + (size_t)r * Dh + d0 + j;
      const float2 qv = ok ? *reinterpret_cast<const float2*>(q + off) : make_float2(0.f, 0.f);
      const float2 kv = ok ? *reinterpret_cast<const float2*>(k + off) : make_float2(0.f, 0.f);
      qs[r * LDT + j] = qv.x;
      qs[r * LDT + j + 1] = qv.y;
      ks[r * LDT + j] = kv.x;
      ks[r * LDT + j + 1] = kv.y;
      if (ok) {
        const size_t xo = (size_t)r * Dp + d0 + j;
        put(sc.qx, xo, qv);
        put(sc.kwx, xo, make_float2(__fmul_rn(kv.x, wks[r]), __fmul_rn(kv.y, wks[r])));
        put(sc.vx, xo, *reinterpret_cast<const float2*>(v + off));
      }
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
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        qn[r] = fma((double)qs[(uy + 32 * r) * LDT + 4 * ux + u], (double)nl[r][u], qn[r]);
    if (tid < DT) {   // the plain version's kw = k * wk, then its sum over s
      float sum = 0.f;
      for (int s = 0; s < LMAX; ++s) sum += __fmul_rn(ks[s * LDT + tid], wks[s]);
      ksum[d0 + tid] = sum;
    }
    __syncthreads();
  }
  const int pad = (Dp - Dh) / 2;
  for (int i = tid; p == P - 1 && i < Lc * pad; i += THREADS) {    // the pad, 2 a thread
    const size_t xo = (size_t)(i / pad) * Dp + Dh + 2 * (i % pad);
    put(sc.qx, xo, make_float2(0.f, 0.f));
    put(sc.kwx, xo, make_float2(0.f, 0.f));
    put(sc.vx, xo, make_float2(0.f, 0.f));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the 8 lanes of a row differ in their low 3 bits
    for (int off = 1; off < 8; off <<= 1) qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], off);
    const int t = uy + 32 * r;
    if (ux == 0 && t < Lc) sc.qnl[(size_t)p * BH * S + gb + t] = qn[r];
  }
  float* out = sc.qkp + (((size_t)bh * nc + c) * P + p) * LMAX * LMAX;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) out[(ty + 16 * i) * LMAX + tx + 16 * jj] = acc[i][jj];
}

// ---------------------------------------- pass 3: n and the denominators
// CTA (c, bh), all in parallel: the weighted scores Q K^T .* W from pass 2's
// key blocks, split into three bf16 pieces for the walk; n0 of chunk c by the
// recurrence n = decay n + ksum over the chunks before it (the plain
// version's order, recomputed per chunk: nc Dh-vectors from L2); then, for
// each row t,
//   den_t = max(|qnl_t + w_t (q_t . n0)|, exp(-m_t)),  q_t . n0 in fp64:
// where |q_t . n_t| nears 0, h_t's error is this sum's. The last chunk's CTA
// writes the final n.
__global__ void __launch_bounds__(THREADS) mlstm_den(const float* __restrict__ q,
                                                     const float* __restrict__ n0p, Scratch sc,
                                                     float* __restrict__ n_out, int S, int Dh,
                                                     int chunk, int nc) {
  __shared__ float ns[MAX_DH];
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int t0 = c * chunk, Lc = min(chunk, S - t0);
  const size_t gb = (size_t)bh * S + t0;
  const float* decay = sc.decay + (size_t)bh * nc;
  const float* ksum = sc.ksum + (size_t)bh * nc * Dh;
  const int P = key_blocks(Dh), BH = gridDim.y;
  const float* qkp = sc.qkp + ((size_t)bh * nc + c) * P * LMAX * LMAX;
  const size_t sw = ((size_t)bh * nc + c) * LMAX * LMAX, slab = (size_t)BH * nc * LMAX * LMAX;
  for (int i = tid; i < LMAX * LMAX; i += THREADS) {
    const int t = i / LMAX, s = i % LMAX;
    float qk = qkp[i];
    for (int p = 1; p < P; ++p) qk += qkp[(size_t)p * LMAX * LMAX + i];
    const float w = (s <= t && t < Lc) ? expf((float)(sc.g[gb + s] - sc.run[gb + t])) : 0.f;
    __nv_bfloat16 pc[PIECES];
    split3(__fmul_rn(qk, w), pc);
    for (int k = 0; k < PIECES; ++k) sc.swx[k * slab + sw + i] = pc[k];
  }
  for (int d = tid; d < Dh; d += THREADS) {
    float n = n0p ? n0p[(size_t)bh * Dh + d] : 0.f;
#pragma unroll 8
    for (int j = 0; j < c; ++j) n = fmaf(decay[j], n, ksum[(size_t)j * Dh + d]);
    ns[d] = n;
    if (c == nc - 1) n_out[(size_t)bh * Dh + d] = fmaf(decay[c], n, ksum[(size_t)c * Dh + d]);
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int t = warp; t < Lc; t += THREADS / 32) {
    const float* qr = q + (gb + t) * Dh;
    double acc = 0.0;
    for (int d = lane; d < Dh; d += 32) acc = fma((double)qr[d], (double)ns[d], acc);
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      float4 st = sc.step[gb + t];
      double qn = sc.qnl[gb + t];
      for (int p = 1; p < P; ++p) qn += sc.qnl[(size_t)p * BH * S + gb + t];
      qn += (double)st.x * acc;
      st.w = fmaxf(fabsf((float)qn), st.z);
      sc.step[gb + t] = st;
    }
  }
}

// ------------------------------------------------- pass 4: the chunk walk
// Over the chunks in order, with C held transposed, C^T[e, d], as fp32 wgmma
// accumulators. CTA (e-block of 128 values, key block `part` of NJ tiles of
// 64 keys, bh); the DS key blocks of one e-block share nothing while they
// run, each writing its own partial sums of h.
// Two warpgroups of 64 values e each, 64 x 64 NJ of C^T in registers; their
// thread 0 also issues the TMA loads, STAGES - 1 tiles ahead (a third
// warpgroup or warp as producer would put three warps on a sub-partition,
// and ptxas then caps every thread at 168 registers, setmaxnreg or not, and
// spills the state). Per chunk, for each warpgroup's 64 x 64 block of h^T:
//   1. h^T = C0^T Q^T over the CTA's keys: A = C0^T from the accumulators,
//      split in registers, B = q from shared memory (K-major);
//   2. h^T = w_t h^T + its share of V^T (Q K^T .* W)^T: A = V^T (MN-major),
//      B = the weighted scores (K-major), k-steps part, part + DS, ..; out
//      to the partial sums hp[part] (pass 5 adds the DS of them up);
//   3. C^T = decay C^T + V^T (k .* wk): A = V^T, B = k .* wk (MN-major).
// Every product takes its operands in three bf16 pieces and sums the six
// products that fp32 needs in fp32 (wgmma_rs6, wgmma_ss6).
constexpr int WALK_THREADS = 2 * WG;
constexpr int EB = 2 * 64;                // values e per CTA
constexpr int STAGES = 6;                 // ring of q or k .* wk tiles
constexpr int TILE = LMAX * 128;          // 64 rows x 64 bf16
constexpr int STAGE_BYTES = PIECES * TILE;
constexpr int CHUNK_BYTES = 3 * PIECES * TILE;   // V (2 e-blocks) and the scores

struct WalkSmem {
  static constexpr int BAR = 0;     // full[STAGES], empty[STAGES], cfull, cempty
  static constexpr int WS = 512;    // w_t of the chunk, a copy per warpgroup
  static constexpr int RING = 1024;
  static constexpr int CHUNK = RING + STAGES * STAGE_BYTES;   // the chunk buffer
  static constexpr int SW = 2 * PIECES * TILE;                // V's piece p at 2 p TILE
  static constexpr int SMEM = 1024 + CHUNK + CHUNK_BYTES;  // + alignment slack
  static_assert(SMEM <= 232448, "over the 227 KiB a CTA may use");
};

struct WalkArgs {
  const float* C0;       // null: C = 0
  float* C;
  float* hp;             // (DS, BH, S, Dh): partial sums of h's numerator
  const float4* step;
  const float* decay;
  int BH, S, Dh, chunk, nc, ds;
};

template <int NJ>
__global__ void __launch_bounds__(WALK_THREADS, 1)
mlstm_walk(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_kw,
           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_s,
           const WalkArgs a) {
  using L = WalkSmem;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1 KiB alignment: the 128-byte swizzle repeats every 1024 bytes, and TMA
  // and wgmma agree on it only from such a boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));   // the same, generic
  const uint32_t bar_full = base + L::BAR, bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_cfull = bar_empty + 8 * STAGES, bar_cempty = bar_cfull + 8;
  const int S = a.S, Dh = a.Dh, chunk = a.chunk, nc = a.nc, DS = a.ds;
  const int bh = blockIdx.y, eb = blockIdx.x / DS, part = blockIdx.x % DS;
  const int d_base = part * NJ * 64;

  // rows past a chunk of fewer than 64 steps are never loaded: zero them once
  for (int i = threadIdx.x; i < (L::SMEM - 1024 - L::RING) / 16; i += WALK_THREADS)
    reinterpret_cast<uint4*>(gen + L::RING)[i] = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * WG / 32);        // every warp
    }
    mbar_init(bar_cfull, 1);
    mbar_init(bar_cempty, 2 * WG / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The loads, in the order of use: ring load n is tile n % NJ of q (first
  // NJ of a chunk) or of k .* wk (next NJ) of chunk n / (2 NJ), piece p at
  // slab p BH + bh; chunk c's V (the CTA's values) and weighted scores go to
  // the chunk buffer. Issued by thread 0, each into a slot both warpgroups
  // have freed.
  const uint32_t box = chunk * 128;
  const int n_loads = 2 * NJ * nc;
  auto load_tile = [&](int n) {
    const int st = n % STAGES, c = n / (2 * NJ), j = n % (2 * NJ);
    const uint32_t full = bar_full + 8 * st, dst = base + L::RING + st * STAGE_BYTES;
    const CUtensorMap* map = j < NJ ? &tm_q : &tm_kw;
    mbar_wait(bar_empty + 8 * st, ((n / STAGES) & 1) ^ 1);   // round 0 passes
    mbar_expect_tx(full, PIECES * box);
    for (int p = 0; p < PIECES; ++p)
      tma_load_3d(dst + p * TILE, map, d_base + 64 * (j % NJ), c * chunk, p * a.BH + bh, full);
  };
  auto load_chunk = [&](int c) {
    const int t0 = c * chunk;
    const uint32_t full = bar_cfull, ch = base + L::CHUNK;
    mbar_wait(bar_cempty, (c & 1) ^ 1);
    mbar_expect_tx(full, PIECES * (2 * box + TILE));
    for (int p = 0; p < PIECES; ++p) {
      for (int w = 0; w < 2; ++w)
        tma_load_3d(ch + (2 * p + w) * TILE, &tm_v, EB * eb + 64 * w, t0, p * a.BH + bh, full);
      tma_load_3d(ch + L::SW + p * TILE, &tm_s, 0, 0, (p * a.BH + bh) * nc + c, full);
    }
  };
  const bool producer = threadIdx.x == 0;
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
    const int e_w = EB * eb + 64 * w;                     // this warpgroup's values
    // accumulator element i: row r + 8 ((i >> 1) & 1), column 8 (i >> 2) + q2 + (i & 1)
    auto row_of = [&](int i) { return r + 8 * ((i >> 1) & 1); };
    auto col_of = [&](int i) { return 8 * (i >> 2) + q2 + (i & 1); };

    float cacc[NJ][32];                   // C^T[e_w + row, d_base + 64 j + column]
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = e_w + row_of(i), d = d_base + 64 * j + col_of(i);
        cacc[j][i] = (a.C0 && e < Dh && d < Dh) ? a.C0[((size_t)bh * Dh + d) * Dh + e] : 0.f;
      }

    uint32_t a1[2][4], a2[2][4], a3[2][4];   // A fragments of C0^T, two in turn
    for (int c = 0, it = 0; c < nc; ++c) {
      const int t0 = c * chunk, Lc = min(chunk, S - t0);
      const size_t gb = (size_t)bh * S + t0;
      const uint32_t ch = base + L::CHUNK;
      // this chunk's w_t, for step 2: loaded now, read after the products
      float* ws = reinterpret_cast<float*>(gen + L::WS) + w * LMAX;
      if (tid < LMAX) ws[tid] = tid < Lc ? a.step[gb + tid].x : 0.f;
      float hq[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) hq[i] = 0.f;
      // ---- 1. h^T = C0^T Q^T over this CTA's keys, a k-step a group, with
      // the fragments of the next built while the last is on the tensor cores
#pragma unroll
      for (int g = 0; g < 4 * NJ; ++g) {
        const int j = g / 4, kk = g % 4, b = g & 1;
        const int st = (it + j) % STAGES;
        const uint32_t tq = base + L::RING + st * STAGE_BYTES;
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
        const uint64_t qd[PIECES] = {desc_kmajor(tq, kk), desc_kmajor(tq + TILE, kk),
                                     desc_kmajor(tq + 2 * TILE, kk)};
        wgmma_fence();
        wgmma_rs6(hq, a1[b], a2[b], a3[b], qd);
        wgmma_commit();
      }
      wgmma_wait<0>();
      pin(a1);
      pin(a2);
      pin(a3);
      pin(hq);
      release(it + NJ - 1, lane);
      it += NJ;
      // ---- 2. h^T = w_t h^T + (a share of) V^T (Q K^T .* W)^T, out as a
      // partial sum
      bar_sync(1 + w, WG);                // ws written by the warpgroup
#pragma unroll
      for (int i = 0; i < 32; ++i) hq[i] *= ws[col_of(i)];
      mbar_wait(bar_cfull, c & 1);
      wgmma_fence();
      for (int kk = part; kk < 4; kk += DS) {
        const uint64_t sd[PIECES] = {desc_kmajor(ch + L::SW, kk),
                                     desc_kmajor(ch + L::SW + TILE, kk),
                                     desc_kmajor(ch + L::SW + 2 * TILE, kk)};
        const uint64_t vk[PIECES] = {desc_mnmajor(ch + w * TILE, kk),
                                     desc_mnmajor(ch + (2 + w) * TILE, kk),
                                     desc_mnmajor(ch + (4 + w) * TILE, kk)};
        wgmma_ss6<0>(hq, vk, sd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(hq);
      float* hp = a.hp + ((size_t)part * a.BH * S + gb) * Dh;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int t = col_of(i), e = e_w + row_of(i);
        if (t < Lc && e < Dh) hp[(size_t)t * Dh + e] = hq[i];
      }
      // ---- 3. C^T = decay C^T + V^T (k .* wk), a tile a group
      const float decay = a.decay[(size_t)bh * nc + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int st = (it + j) % STAGES;
        const uint32_t tk = base + L::RING + st * STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < 32; ++i) cacc[j][i] *= decay;
        mbar_wait(bar_full + 8 * st, ((it + j) / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t kd[PIECES] = {desc_mnmajor(tk, kk), desc_mnmajor(tk + TILE, kk),
                                       desc_mnmajor(tk + 2 * TILE, kk)};
          const uint64_t vk[PIECES] = {desc_mnmajor(ch + w * TILE, kk),
                                       desc_mnmajor(ch + (2 + w) * TILE, kk),
                                       desc_mnmajor(ch + (4 + w) * TILE, kk)};
          wgmma_ss6<1>(cacc[j], vk, kd);
        }
        wgmma_commit();
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
      if (producer && c + 1 < nc) load_chunk(c + 1);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = e_w + row_of(i), d = d_base + 64 * j + col_of(i);
        if (e < Dh && d < Dh) a.C[((size_t)bh * Dh + d) * Dh + e] = cacc[j][i];
      }
  }
}

// ------------------------------------------------------ pass 5: h itself
// A CTA a row (b h, t), four values a thread: h = (the key blocks' partial
// sums of the numerator, in order) / den_t.
__global__ void __launch_bounds__(MAX_DH / 4) mlstm_out(const float* __restrict__ hp,
                                                        const float4* __restrict__ step,
                                                        float* __restrict__ h, int rows, int Dh,
                                                        int DS) {
  const size_t row = blockIdx.x, i = row * (Dh / 4) + threadIdx.x;
  const size_t part = (size_t)rows * (Dh / 4);
  const float4* p = reinterpret_cast<const float4*>(hp);
  float4 x[MAX_DH / KB];
#pragma unroll
  for (int k = 0; k < MAX_DH / KB; ++k)
    if (k < DS) x[k] = p[k * part + i];
  float4 s = x[0];
#pragma unroll
  for (int k = 1; k < MAX_DH / KB; ++k)
    if (k < DS) {
      s.x += x[k].x;
      s.y += x[k].y;
      s.z += x[k].z;
      s.w += x[k].w;
    }
  const float dn = step[row].w;
  reinterpret_cast<float4*>(h)[i] = make_float4(s.x / dn, s.y / dn, s.z / dn, s.w / dn);
}

template <int NJ>
cudaError_t launch_walk(const Scratch& sc, const WalkArgs& a, float* h, cudaStream_t stream) {
  const int Dp = padded(a.Dh);
  CUtensorMap tq, tk, tv, ts;
  if (!tensor_map_pieces(&tq, sc.qx, Dp, a.S, PIECES * a.BH, a.chunk) ||
      !tensor_map_pieces(&tk, sc.kwx, Dp, a.S, PIECES * a.BH, a.chunk) ||
      !tensor_map_pieces(&tv, sc.vx, Dp, a.S, PIECES * a.BH, a.chunk) ||
      !tensor_map_pieces(&ts, sc.swx, LMAX, LMAX, PIECES * a.BH * a.nc, LMAX))
    return cudaErrorInvalidValue;
  static const cudaError_t set = cudaFuncSetAttribute(
      mlstm_walk<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, WalkSmem::SMEM);
  if (set != cudaSuccess) return set;
  mlstm_walk<NJ><<<dim3((a.Dh + EB - 1) / EB * a.ds, a.BH), WALK_THREADS, WalkSmem::SMEM,
                   stream>>>(tq, tk, tv, ts, a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_out<<<a.BH * a.S, a.Dh / 4, 0, stream>>>(a.hp, a.step, h, a.BH * a.S, a.Dh, a.ds);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer that mlstm_chunk_fwd needs.
size_t mlstm_chunk_scratch_bytes(int BH, int S, int Dh, int chunk) {
  const int nc = (S + chunk - 1) / chunk;
  return scratch_layout(nullptr, nullptr, BH, S, Dh, nc);
}

// q, k, v, h: (BH, S, Dh); li, lf: (BH, S); C0/C: (BH, Dh, Dh); n0/n: (BH,
// Dh); m0/m: (BH); all fp32 and contiguous; scratch: 256-byte aligned, of
// mlstm_chunk_scratch_bytes(). C0, n0 and m0 may be null (the empty state).
// Dh % 32 == 0, Dh <= 1024, 1 <= chunk <= min(64, S). Launches five
// kernels on `stream`; returns a cudaError_t, 0 on success.
int mlstm_chunk_fwd(const float* q, const float* k, const float* v, const float* li,
                    const float* lf, const float* C0, const float* n0, const float* m0,
                    float* h, float* C, float* n, float* m, void* scratch, int BH, int S,
                    int Dh, int chunk, cudaStream_t stream) {
  if (BH < 1 || S < 1 || Dh < 32 || Dh % 32 || Dh > MAX_DH || chunk < 1 || chunk > LMAX ||
      chunk > S)
    return (int)cudaErrorInvalidValue;
  // the walk's key blocks: as few as hold C^T in registers (4 tiles of 64)
  const int tiles = (Dh + 63) / 64, split = key_blocks(Dh);
  const int nc = (S + chunk - 1) / chunk, NJ = (tiles + split - 1) / split;
  Scratch sc;
  scratch_layout(&sc, static_cast<char*>(scratch), BH, S, Dh, nc);
  mlstm_gates<<<BH, 128, 0, stream>>>(li, lf, m0, sc, m, S, chunk, nc);
  mlstm_prep<<<dim3(nc, BH, key_blocks(Dh)), THREADS, 0, stream>>>(q, k, v, sc, S, Dh, chunk, nc);
  mlstm_den<<<dim3(nc, BH), THREADS, 0, stream>>>(q, n0, sc, n, S, Dh, chunk, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const WalkArgs a{C0, C, sc.hp, sc.step, sc.decay, BH, S, Dh, chunk, nc, split};
  switch (NJ) {
    case 1: return (int)launch_walk<1>(sc, a, h, stream);
    case 2: return (int)launch_walk<2>(sc, a, h, stream);
    case 3: return (int)launch_walk<3>(sc, a, h, stream);
    default: return (int)launch_walk<4>(sc, a, h, stream);
  }
}

const char* mlstm_chunk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
