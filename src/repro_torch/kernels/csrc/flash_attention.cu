// GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py:25, launched by `flash_attention`
// at :73 through `pl.pallas_call` at :94). It computes
//     O = softmax(Q K^T * Dh^-0.5 [+ causal mask]) V
// with q (B, H, Sq, Dh), k and v (B, KH, Sk, Dh), H = KH * G: q head h reads
// kv head h / G, so a kv tile serves every q head of its group without a
// copy of K or V. Beyond the TPU kernel it takes a query offset (query row i
// sits at position q_offset + i under the causal mask), any Sq and Sk (the
// ragged edge is masked here, where the Pallas kernel asserted S % block == 0
// and Sq == Sk), Dh of 32, 64 or 128, and bf16 or fp32 inputs. Sums are fp32.
//
// Design. The Pallas grid walks the kv blocks of one q block in order and
// carries (m, l, acc) in VMEM scratch between grid steps. CUDA blocks run in
// no order, so here one CTA owns one (b*h, 64-row q tile) and a loop inside
// the CTA walks the kv tiles, staging each in shared memory; (m, l, acc) stay
// in registers for the whole loop and the score tile never reaches device
// memory. Under the causal mask the loop stops at the last kv tile that any
// row of the q tile can see (the Pallas kernel's `pl.when` skip at :61). A
// row whose every score is masked gets p = 0 and l floored at 1e-30, so it
// yields 0 rather than NaN, as the Pallas kernel (:50-51) does.
//   * bf16: 4 warps, 16 q rows each. Q K^T and P V run on the tensor cores
//     with mma.sync m16n8k16 (bf16 in, fp32 accumulate); the fp32 score
//     fragment is re-packed in registers as the A operand of P V, and P is
//     rounded to bf16 there, as the JAX model's flash rounds P to v's dtype
//     (src/repro/models/attention.py:113).
//   * fp32: no tensor-core path keeps fp32 exact, so 256 threads work in
//     CUDA-core FMAs, four threads to a q row; P goes through shared memory.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): the causal prefill
// does 2*B*H*S^2*Dh operations on 2*(2*B*H + 2*B*KH)*S*Dh bytes, so at the
// qwen3-8b prefill shape (H=32, KH=8, Dh=128, S=4096) it is bound by the
// operations (0.139 ms against 0.025 ms for the bytes). This first version
// uses mma.sync with synchronous tile loads; wgmma, TMA and a producer warp
// that overlaps loads with the products are the way to that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q rows per CTA
constexpr int BK = 64;       // kv rows per shared-memory tile (bf16 kernel)
constexpr int BKF = 32;      // kv rows per shared-memory tile (fp32 kernel)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, KH, Sq, Sk, q_offset, causal;
  float scale;
};

// Number of kv positions that some row of q tile [q0, q0 + BQ) can see.
__device__ __forceinline__ int kv_extent(const Params& p, int q0) {
  if (!p.causal) return p.Sk;
  const int q_last = min(p.Sq, q0 + BQ) - 1;
  return max(0, min(p.Sk, p.q_offset + q_last + 1));
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int col) {
  return col < p.Sk && (!p.causal || col <= qpos);
}

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col); fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + ROWS) of a (n_rows, DH) bf16 matrix into shared
// memory with row stride LD, in 16-byte pieces; rows past n_rows are zero.
template <int DH, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int n_rows) {
  constexpr int CHUNKS = DH / 8;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = i % CHUNKS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * DH + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(128) flash_fwd_bf16(Params p) {
  constexpr int LD = DH + 8;   // padded row stride: fragment loads miss no bank twice
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;    // mma fragment row group, column pair
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KH);
  // heaviest causal tiles first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * p.Sq * DH;
  const size_t kv_off = ((size_t)b * p.KH + kvh) * p.Sk * DH;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + (size_t)bh * p.Sq * DH;

  load_tile_bf16<DH, BQ, LD, 128>(Qs, qg, q0, p.Sq);
  __syncthreads();
  const int r0 = warp * 16 + g;             // this thread's rows: r0 and r0 + 8
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    qf[ks][0] = ld32(Qs + r0 * LD + ks * 16 + t * 2);
    qf[ks][1] = ld32(Qs + (r0 + 8) * LD + ks * 16 + t * 2);
    qf[ks][2] = ld32(Qs + r0 * LD + ks * 16 + 8 + t * 2);
    qf[ks][3] = ld32(Qs + (r0 + 8) * LD + ks * 16 + 8 + t * 2);
  }

  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};      // running max, log2 units
  float l[2] = {0.f, 0.f};                  // this thread's share of the row sum
  const float sl2 = p.scale * 1.4426950408889634f;
  const int qpos[2] = {p.q_offset + q0 + r0, p.q_offset + q0 + r0 + 8};
  const int kv_end = kv_extent(p, q0);

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                        // the previous tile is consumed
    load_tile_bf16<DH, BK, LD, 128>(Ks, kg, k0, p.Sk);
    load_tile_bf16<DH, BK, LD, 128>(Vs, vg, k0, p.Sk);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = Ks + (n * 8 + g) * LD + t * 2;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        mma_bf16(s[n], qf[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + t * 2 + (e & 1);
        const float x = visible(p, qpos[e >> 1], col) ? s[n][e] * sl2 : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      base[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] - base[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[n][e] - base[e >> 1]);   // exp2(-inf) = 0
        s[n][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the C fragments of score columns [16kk, 16kk + 16) are the A fragment
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* v0 = Vs + (kk * 16 + t * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const __nv_bfloat16* vp = v0 + n * 8;
        const uint32_t b0 = pack_bf16(vp[0], vp[LD]);
        const uint32_t b1 = pack_bf16(vp[8 * LD], vp[9 * LD]);
        mma_bf16(o[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= p.Sq) continue;
    __nv_bfloat16* orow = og + (size_t)row * DH + t * 2;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * r] * l[r], o[n][2 * r + 1] * l[r]);
  }
}

// ------------------------------------------------------------------ fp32

template <int DH>
__global__ void __launch_bounds__(256) flash_fwd_f32(Params p) {
  constexpr int LDQ = DH + 1, LDK = DH + 1, LDP = BKF + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // BQ x LDQ
  float* Ks = Qs + BQ * LDQ;                        // BKF x LDK
  float* Vs = Ks + BKF * LDK;                       // BKF x DH
  float* Ps = Vs + BKF * DH;                        // BQ x LDP

  const int row = threadIdx.x >> 2, sub = threadIdx.x & 3;   // 4 threads a row
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const float* qg = static_cast<const float*>(p.q) + (size_t)bh * p.Sq * DH;
  const size_t kv_off = ((size_t)b * p.KH + kvh) * p.Sk * DH;
  const float* kg = static_cast<const float*>(p.k) + kv_off;
  const float* vg = static_cast<const float*>(p.v) + kv_off;
  float* og = static_cast<float*>(p.o) + (size_t)bh * p.Sq * DH;

  for (int i = threadIdx.x; i < BQ * DH; i += 256) {
    const int r = i / DH, d = i % DH;
    Qs[r * LDQ + d] = q0 + r < p.Sq ? qg[(size_t)(q0 + r) * DH + d] : 0.f;
  }

  float o[DH / 4];
#pragma unroll
  for (int i = 0; i < DH / 4; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int qpos = p.q_offset + q0 + row;
  const int kv_end = kv_extent(p, q0);

  for (int k0 = 0; k0 < kv_end; k0 += BKF) {
    __syncthreads();
    for (int i = threadIdx.x; i < BKF * DH; i += 256) {
      const int r = i / DH, d = i % DH;
      const bool in = k0 + r < p.Sk;
      Ks[r * LDK + d] = in ? kg[(size_t)(k0 + r) * DH + d] : 0.f;
      Vs[r * DH + d] = in ? vg[(size_t)(k0 + r) * DH + d] : 0.f;
    }
    __syncthreads();

    float s[BKF / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKF / 4; ++j) {
      const int c = sub + 4 * j;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) acc = fmaf(Qs[row * LDQ + d], Ks[c * LDK + d], acc);
      s[j] = visible(p, qpos, k0 + c) ? acc * p.scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float corr = m == -INFINITY ? 0.f : expf(m - base);
    m = m_new;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < BKF / 4; ++j) {
      const float pj = expf(s[j] - base);
      Ps[row * LDP + sub + 4 * j] = pj;
      ls += pj;
    }
    l = l * corr + ls;
#pragma unroll
    for (int i = 0; i < DH / 4; ++i) o[i] *= corr;
    __syncwarp();                           // a row's P is written within its warp
#pragma unroll 4
    for (int c = 0; c < BKF; ++c) {
      const float pc = Ps[row * LDP + c];
#pragma unroll
      for (int i = 0; i < DH / 4; ++i) o[i] = fmaf(pc, Vs[c * DH + sub + 4 * i], o[i]);
    }
  }

  l += __shfl_xor_sync(0xffffffff, l, 1);
  l += __shfl_xor_sync(0xffffffff, l, 2);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  if (q0 + row < p.Sq) {
#pragma unroll
    for (int i = 0; i < DH / 4; ++i)
      og[(size_t)(q0 + row) * DH + sub + 4 * i] = o[i] * inv;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int B, int threads,
                   size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, B * p.H);
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DH>
cudaError_t dispatch(const Params& p, int B, int is_bf16, cudaStream_t stream) {
  if (is_bf16)
    return launch(flash_fwd_bf16<DH>, p, B, 128,
                  (size_t)(BQ + 2 * BK) * (DH + 8) * sizeof(__nv_bfloat16), stream);
  return launch(flash_fwd_f32<DH>, p, B, 256,
                (size_t)(BQ * (DH + 1) + BKF * (DH + 1) + BKF * DH + BQ * (BKF + 1)) *
                    sizeof(float),
                stream);
}

}  // namespace

// q (B, H, Sq, Dh), k and v (B, KH, Sk, Dh), o (B, H, Sq, Dh): contiguous,
// on the current device, all bf16 (is_bf16 = 1) or all fp32. H % KH == 0.
// Launches on `stream` and does not synchronise. Returns the cudaError_t of
// the launch (0 on success); Dh outside {32, 64, 128} returns
// cudaErrorInvalidValue.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int H, int KH, int Sq, int Sk, int Dh,
                                   int q_offset, int causal, float scale, int is_bf16,
                                   void* stream) {
  const Params p{q, k, v, o, H, KH, Sq, Sk, q_offset, causal, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return dispatch<32>(p, B, is_bf16, st);
    case 64: return dispatch<64>(p, B, is_bf16, st);
    case 128: return dispatch<128>(p, B, is_bf16, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
