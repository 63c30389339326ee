// Flash attention, forward and backward, hand-written for Hopper (sm_90a).
// Three kernels, one per TPU kernel they replace:
//
//   flash_fwd_kernel  replaces ray_tpu/ops/flash_attention.py::_flash_kernel
//                     (online-softmax forward, causal tile skip, lse)
//   flash_dq_kernel   replaces ray_tpu/ops/flash_attention.py::_dq_kernel
//                     (dQ = sm * sum_kv dS K, P rebuilt from lse)
//   flash_dkv_kernel  replaces ray_tpu/ops/flash_attention.py::_dkv_kernel
//                     (dV = sum_q P^T dO, dK = sm * sum_q dS^T Q)
//
// They compute what the Pallas kernels compute, not block by block:
//
// - q, k, v, dO are read in place as [B, T, H, D] (row stride H*D); the
//   Pallas wrappers' transposes to [BH, T, D] are a TPU layout artefact.
// - lse and delta are [B*H, T] f32 rows, not the [BH, T, 128] lane
//   broadcast Mosaic needs.
// - The sequential kv (or q) grid axis becomes a loop inside one CTA; the
//   other two grid axes (tile, b*h) are the CUDA grid. Nothing is
//   reduced across CTAs, so there are no atomics and results are
//   deterministic.
// - Ragged T is masked inside the kernels (rows past T load as zeros,
//   columns past T are masked, rows past T are not written), so every T
//   runs here; the reference's XLA fallback for T without a 128-multiple
//   divisor has no counterpart.
//
// Numerics follow the reference: scores in f32 from (q * sm_scale) . k;
// masked scores are the finite NEG_INF; the forward rounds p to v's
// dtype before p . V (so bf16 outputs match JAX's) while l sums the f32
// p; the backward rebuilds p = exp(s - lse) and dS = p * (dO . V^T -
// delta) in f32 and writes dq/dk/dv in the input dtype.
//
// What bounds them on an H100: at the training shape (T 1024, D 64,
// bf16) each kernel does ~D/2 flops per byte it must move, so the
// tensor cores' 989 TFLOP/s (not the 3.35 TB/s) set the bound: ~20 us
// forward, ~26 us dQ, ~35 us dK/dV causal. This first version is the
// simple one: 64 x 64 tiles of f32 FMA on CUDA cores from shared memory
// (each thread owns a 4 x 8 block of scores and a 4 x D/8 block of the
// accumulator, rows spaced 16 apart and columns 8 apart so a warp reads
// shared memory without bank conflicts), so it runs at the CUDA cores'
// rate, far from the bound. Tensor-core tiles (mma/wgmma), TMA/cp.async
// double buffering and split work for short causal rows are later work.
//
// Each extern "C" entry launches on the given stream and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a head dim it has no
// instantiation for); the Python wrapper raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite, as flash_attention.py's NEG_INF
constexpr int kThreads = 128;      // 4 warps
constexpr int BT = 64;             // rows of a q tile and of a kv tile
constexpr int LD = BT + 1;         // padded row of a transposed tile
// Thread t owns tile rows rg + 16*i (i < 4) and columns cg + 8*j (j < 8),
// rg = t / 8, cg = t % 8: the 8 threads of one row group are 8
// consecutive lanes, so row reductions are three xor shuffles.
constexpr int RI = 4;
constexpr int CJ = 8;

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back (p.astype(v.dtype) in the reference).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 1; off < CJ; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < CJ; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Stage rows row0 .. row0+BT-1 of one (b, h) slice, transposed and
// scaled, into xt[D][LD] (f32). base points at element (b, 0, h, 0);
// row t lives at base + t * HD. Rows past Tn load as zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_t(float* xt, const T* base, int row0,
                                        int Tn, int HD, float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CH = D / VEC;
  for (int e = threadIdx.x; e < BT * CH; e += kThreads) {
    const int r = e / CH;
    const int c = (e - r * CH) * VEC;
    float v[VEC];
    if (row0 + r < Tn) {
      Vec16<T>::load(base + (size_t)(row0 + r) * HD + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) xt[(c + i) * LD + r] = v[i] * scale;
  }
}

// The same rows untransposed into xs[BT][D].
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* xs, const T* base, int row0,
                                           int Tn, int HD) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CH = D / VEC;
  for (int e = threadIdx.x; e < BT * CH; e += kThreads) {
    const int r = e / CH;
    const int c = (e - r * CH) * VEC;
    float v[VEC];
    if (row0 + r < Tn) {
      Vec16<T>::load(base + (size_t)(row0 + r) * HD + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) xs[r * D + c + i] = v[i];
  }
}

// acc[i][j] += sum_d at[d][rg + 16 i] * bt[d][cg + 8 j]: a 64 x 64 tile of
// A . B^T from two transposed tiles.
template <int D>
__device__ __forceinline__ void tile_abt(float (&acc)[RI][CJ], const float* at,
                                         const float* bt, int rg, int cg) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RI], b[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = at[d * LD + rg + 16 * i];
#pragma unroll
    for (int j = 0; j < CJ; ++j) b[j] = bt[d * LD + cg + 8 * j];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Tn, int H, float scale) {
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* qt = smem;            // [D][LD], q * scale
  float* kt = qt + D * LD;     // [D][LD]
  float* vs = kt + D * LD;     // [BT][D]
  float* ps = vs + BT * D;     // [BT][LD], p rounded to v's dtype

  const int nt = (Tn + BT - 1) / BT;
  const int q0 = (nt - 1 - blockIdx.x) * BT;  // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int HD = H * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const int rg = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;

  stage_t<T, D>(qt, q + base, q0, Tn, HD, scale);
  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }

  const int last_row = min(q0 + BT, Tn) - 1;
  const int n_kv = CAUSAL ? last_row / BT + 1 : nt;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BT;
    __syncthreads();  // the previous tile's kt / vs / ps are consumed
    stage_t<T, D>(kt, k + base, k0, Tn, HD, 1.f);
    stage_rows<T, D>(vs, v + base, k0, Tn, HD);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    tile_abt<D>(s, qt, kt, rg, cg);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = rg + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kc = k0 + cg + 8 * j;
        const bool live = kc < Tn && (!CAUSAL || kc <= q0 + r);
        s[i][j] = live ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[r * LD + cg + 8 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float pa[RI], vb[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pa[i] = ps[(rg + 16 * i) * LD + kk];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) vb[jd] = vs[kk * D + cg + 8 * jd];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd)
          acc[i][jd] = fmaf(pa[i], vb[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row < Tn) {
      T* o = out + base + (size_t)row * HD;
      const float inv = 1.f / l[i];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd)
        o[cg + 8 * jd] = from_f32<T>(acc[i][jd] * inv);
      if (lse != nullptr && cg == 0)
        lse[(size_t)bh * Tn + row] = m[i] + logf(l[i]);
    }
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Tn, int H, float scale) {
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* qt = smem;            // [D][LD], q * scale
  float* dot = qt + D * LD;    // [D][LD], dO
  float* kt = dot + D * LD;    // [D][LD]
  float* vt = kt + D * LD;     // [D][LD]
  float* dss = vt + D * LD;    // [BT][LD], dS

  const int nt = (Tn + BT - 1) / BT;
  const int q0 = (nt - 1 - blockIdx.x) * BT;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int HD = H * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const int rg = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;

  stage_t<T, D>(qt, q + base, q0, Tn, HD, scale);
  stage_t<T, D>(dot, dout + base, q0, Tn, HD, 1.f);
  float row_lse[RI], row_delta[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + rg + 16 * i;
    row_lse[i] = row < Tn ? lse[(size_t)bh * Tn + row] : 0.f;
    row_delta[i] = row < Tn ? delta[(size_t)bh * Tn + row] : 0.f;
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc[i][jd] = 0.f;
  }

  const int last_row = min(q0 + BT, Tn) - 1;
  const int n_kv = CAUSAL ? last_row / BT + 1 : nt;
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * BT;
    __syncthreads();
    stage_t<T, D>(kt, k + base, k0, Tn, HD, 1.f);
    stage_t<T, D>(vt, v + base, k0, Tn, HD, 1.f);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<D>(s, qt, kt, rg, cg);
    tile_abt<D>(dp, dot, vt, rg, cg);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kc = k0 + cg + 8 * j;
        const bool live = kc < Tn && (!CAUSAL || kc <= q0 + r);
        const float p = live ? expf(s[i][j] - row_lse[i]) : 0.f;
        dss[r * LD + cg + 8 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();

    // acc[i][jd] += sum_c dS[r_i][c] * K[c][cg + 8 jd], K read from kt.
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float da[RI], kb[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) da[i] = dss[(rg + 16 * i) * LD + kk];
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) kb[jd] = kt[(cg + 8 * jd) * LD + kk];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd)
          acc[i][jd] = fmaf(da[i], kb[jd], acc[i][jd]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row < Tn) {
      T* o = dq + base + (size_t)row * HD;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd)
        o[cg + 8 * jd] = from_f32<T>(acc[i][jd] * scale);
    }
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Tn, int H, float scale) {
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* kt = smem;            // [D][LD]
  float* vt = kt + D * LD;     // [D][LD]
  float* qt = vt + D * LD;     // [D][LD], q * scale
  float* dot = qt + D * LD;    // [D][LD], dO
  float* pt = dot + D * LD;    // [BT][LD], P^T (kv row, q column)
  float* dst = pt + BT * LD;   // [BT][LD], dS^T
  float* lse_s = dst + BT * LD;   // [BT]
  float* delta_s = lse_s + BT;    // [BT]

  const int nt = (Tn + BT - 1) / BT;
  const int k0 = blockIdx.x * BT;  // low kv tiles see the most q rows
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int HD = H * D;
  const size_t base = (size_t)b * Tn * HD + (size_t)h * D;
  const int rg = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;

  stage_t<T, D>(kt, k + base, k0, Tn, HD, 1.f);
  stage_t<T, D>(vt, v + base, k0, Tn, HD, 1.f);
  float acc_k[RI][DJ], acc_v[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int jd = 0; jd < DJ; ++jd) acc_k[i][jd] = acc_v[i][jd] = 0.f;

  // Under causal masking q tiles before the kv tile see none of it.
  for (int t = CAUSAL ? blockIdx.x : 0; t < nt; ++t) {
    const int q0 = t * BT;
    __syncthreads();
    stage_t<T, D>(qt, q + base, q0, Tn, HD, scale);
    stage_t<T, D>(dot, dout + base, q0, Tn, HD, 1.f);
    for (int e = threadIdx.x; e < BT; e += kThreads) {
      const int row = q0 + e;
      lse_s[e] = row < Tn ? lse[(size_t)bh * Tn + row] : 0.f;
      delta_s[e] = row < Tn ? delta[(size_t)bh * Tn + row] : 0.f;
    }
    __syncthreads();

    // Transposed scores: s[i][j] for kv row rg + 16 i, q column cg + 8 j.
    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<D>(s, kt, qt, rg, cg);
    tile_abt<D>(dp, vt, dot, rg, cg);

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = cg + 8 * j;
        const int qr = q0 + c;
        const bool live = qr < Tn && (!CAUSAL || qr >= k0 + r);
        const float p = live ? expf(s[i][j] - lse_s[c]) : 0.f;
        pt[r * LD + c] = p;
        dst[r * LD + c] = p * (dp[i][j] - delta_s[c]);
      }
    }
    __syncthreads();

    // dv += P^T dO, dk += dS^T (q * scale); dO and q read from their
    // transposed tiles.
#pragma unroll 2
    for (int qq = 0; qq < BT; ++qq) {
      float pa[RI], da[RI], ob[DJ], qb[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        pa[i] = pt[(rg + 16 * i) * LD + qq];
        da[i] = dst[(rg + 16 * i) * LD + qq];
      }
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) {
        ob[jd] = dot[(cg + 8 * jd) * LD + qq];
        qb[jd] = qt[(cg + 8 * jd) * LD + qq];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) {
          acc_v[i][jd] = fmaf(pa[i], ob[jd], acc_v[i][jd]);
          acc_k[i][jd] = fmaf(da[i], qb[jd], acc_k[i][jd]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = k0 + rg + 16 * i;
    if (row < Tn) {
      T* ok = dk + base + (size_t)row * HD;
      T* ov = dv + base + (size_t)row * HD;
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) {
        ok[cg + 8 * jd] = from_f32<T>(acc_k[i][jd]);
        ov[cg + 8 * jd] = from_f32<T>(acc_v[i][jd]);
      }
    }
  }
}

constexpr size_t fwd_smem(int D) {
  return (size_t)(2 * D * LD + BT * D + BT * LD) * sizeof(float);
}
constexpr size_t dq_smem(int D) {
  return (size_t)(4 * D * LD + BT * LD) * sizeof(float);
}
constexpr size_t dkv_smem(int D) {
  return (size_t)(4 * D * LD + 2 * BT * LD + 2 * BT) * sizeof(float);
}

// Above 48 KB a kernel takes dynamic shared memory only after opting in.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int D, bool C>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int Tn, int H, float scale,
                       cudaStream_t s) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D, C>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + BT - 1) / BT, B * H);
  flash_fwd_kernel<T, D, C><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Tn, H, scale);
  return cudaGetLastError();
}

template <typename T, int D, bool C>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int Tn, int H, float scale,
                      cudaStream_t s) {
  const size_t smem = dq_smem(D);
  cudaError_t err = allow_smem(flash_dq_kernel<T, D, C>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + BT - 1) / BT, B * H);
  flash_dq_kernel<T, D, C><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Tn, H, scale);
  return cudaGetLastError();
}

template <typename T, int D, bool C>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int Tn, int H, float scale,
                       cudaStream_t s) {
  const size_t smem = dkv_smem(D);
  cudaError_t err = allow_smem(flash_dkv_kernel<T, D, C>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tn + BT - 1) / BT, B * H);
  flash_dkv_kernel<T, D, C><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Tn, H, scale);
  return cudaGetLastError();
}

// Calls F<T, D, causal>::run(args...) for the runtime (dtype, D, causal);
// cudaErrorInvalidValue when there is no such instantiation.
template <template <typename, int, bool> class F, typename... A>
cudaError_t dispatch(int dtype, int D, int causal, A... args) {
#define RTT_CASE(T, DD)                                              \
  if (D == DD)                                                       \
    return causal ? F<T, DD, true>::run(args...)                     \
                  : F<T, DD, false>::run(args...);
  if (dtype == 0) {
    RTT_CASE(float, 32)
    RTT_CASE(float, 64)
    RTT_CASE(float, 128)
  } else if (dtype == 1) {
    RTT_CASE(__nv_bfloat16, 32)
    RTT_CASE(__nv_bfloat16, 64)
    RTT_CASE(__nv_bfloat16, 128)
  }
#undef RTT_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int D, bool C>
struct Fwd {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         void* out, float* lse, int B, int Tn, int H,
                         float scale, cudaStream_t s) {
    return launch_fwd<T, D, C>(q, k, v, out, lse, B, Tn, H, scale, s);
  }
};

template <typename T, int D, bool C>
struct Dq {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int B, int Tn, int H,
                         float scale, cudaStream_t s) {
    return launch_dq<T, D, C>(q, k, v, dout, lse, delta, dq, B, Tn, H, scale,
                              s);
  }
};

template <typename T, int D, bool C>
struct Dkv {
  static cudaError_t run(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int B,
                         int Tn, int H, float scale, cudaStream_t s) {
    return launch_dkv<T, D, C>(q, k, v, dout, lse, delta, dk, dv, B, Tn, H,
                               scale, s);
  }
};

}  // namespace

// q, k, v, out: [B, T, H, D] contiguous; lse: [B*H, T] f32 or null (the
// inference variant skips its write). dtype: 0 = float32, 1 = bfloat16.
extern "C" int rtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int T, int H, int D,
                             float scale, int causal, int dtype,
                             void* stream) {
  return static_cast<int>(dispatch<Fwd>(
      dtype, D, causal, q, k, v, out, static_cast<float*>(lse), B, T, H,
      scale, static_cast<cudaStream_t>(stream)));
}

// dout, dq: [B, T, H, D]; lse, delta: [B*H, T] f32.
extern "C" int rtt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int T, int H,
                            int D, float scale, int causal, int dtype,
                            void* stream) {
  return static_cast<int>(dispatch<Dq>(
      dtype, D, causal, q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dq, B, T, H, scale,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int rtt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int T, int H, int D, float scale, int causal,
                             int dtype, void* stream) {
  return static_cast<int>(dispatch<Dkv>(
      dtype, D, causal, q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dk, dv, B, T, H, scale,
      static_cast<cudaStream_t>(stream)));
}
