// Fused cross-entropy over a tied embedding, hand-written for Hopper
// (sm_90a). Three kernels, one per TPU kernel they replace:
//
//   xent_fwd_kernel  replaces ray_tpu/ops/fused_xent.py::_fwd_kernel
//                    (per row: logsumexp of x . E^T over the vocabulary and
//                    the raw target logit, without the [N, V] logits)
//   xent_bwd_kernel<ROW_PANEL = true>
//                    replaces ray_tpu/ops/fused_xent.py::_dx_kernel
//                    (dx = sum_v dlog[:, v] E[v])
//   xent_bwd_kernel<ROW_PANEL = false>
//                    replaces ray_tpu/ops/fused_xent.py::_de_kernel
//                    (dE = sum_n dlog[n, :]^T x[n])
//
// with dlog = c_lse * exp(s - lse) + c_tgt * onehot(target), s = x . E^T
// rebuilt per tile from the forward's saved lse, exactly as the shared
// _recompute_dlog does. Inputs are read in the activation dtype and cast
// to f32 (bf16 products are exact in f32), every sum is f32, and dx / dE
// are written as f32 (the wrapper casts at the autograd boundary, as the
// reference's custom_vjp does).
//
// What carries over from the Pallas kernels and what does not:
//
// - The sequential grid axis (vocab blocks for fwd/dx, row blocks for dE)
//   becomes a loop inside one CTA; nothing is reduced across CTAs, so there
//   are no atomics and results are deterministic.
// - The Pallas blocks do not fit an SM: the dx scratch is [256, 1024] f32
//   (1 MB) and the dE scratch [384, 1024] f32 (1.5 MB). Here a CTA owns a
//   *panel* of RT = 32 rows (x rows for fwd/dx, embedding rows for dE) and
//   keeps its [32, D] f32 accumulator in registers (D / 8 floats a thread
//   for 256 threads: 128 at D = 1024). It streams the other operand in
//   tiles of ST = 128 rows: (A) the [32 x 128] score tile, D streamed
//   through shared memory in chunks of KC = 32 columns (both chunks staged
//   transposed in f32); (B) dlog formed in registers and parked in shared
//   memory; (C) dlog times the tile's rows, staged VK = 16 rows at a time.
// - lse, the cotangents and the targets are [N] rows, not [N, 128] lane
//   broadcasts, and ragged N and V are masked inside the kernels (rows past
//   N load as zeros and are not written; columns past V are masked), so no
//   shape leaves the kernel path.
//
// What bounds them on an H100: at bench.py's loss shape (N 24576, V 50304,
// D 1024, bf16) the forward does 2 N V D = 2.53 TFLOP and dx / dE 5.07 each
// against ~0.2 GB of inputs, so the tensor cores' 989 TFLOP/s set the
// bound (2.56 / 5.12 / 5.12 ms). This first version is the simple one: f32
// FMA on CUDA cores from shared memory (each thread owns a 4 x 4 block of
// scores, read as one broadcast float4 and one float4 per k, and a 4-row
// block of the accumulator across D), so it runs at the CUDA cores' rate,
// far from the bound. Tensor-core tiles (mma.sync / wgmma), TMA and a
// producer warp are later work.
//
// Each extern "C" entry launches on the given stream and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a width it has no
// instantiation for); the Python wrapper raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;   // finite, as fused_xent.py's _NEG
constexpr int kThreads = 256;    // 8 warps
constexpr int RT = 32;           // panel rows per CTA
constexpr int ST = 128;          // stream rows per tile
constexpr int KC = 32;           // D columns per staged chunk
constexpr int VK = 16;           // stream rows per accumulate stage
constexpr int LDP = RT + 4;      // padded row of a transposed panel chunk
constexpr int LDS = ST + 4;      // padded row of a transposed stream chunk
// Thread t: warp ty = t / 32 owns panel rows 4 ty .. 4 ty + 3; lane tx owns
// stream columns 4 tx .. 4 tx + 3 of the score tile.

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

// Stage columns k0 .. k0 + KC - 1 of rows row0 .. row0 + ROWS - 1 of a
// [n, D] matrix, transposed to dst[KC][ld] (f32). Rows past n are zeros.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_chunk_t(float* dst, int ld,
                                              const T* src, int row0, int n,
                                              int k0) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CH = KC / VEC;
  for (int e = threadIdx.x; e < ROWS * CH; e += kThreads) {
    const int r = e / CH;
    const int c = (e - r * CH) * VEC;
    float v[VEC];
    if (row0 + r < n) {
      Vec16<T>::load(src + (size_t)(row0 + r) * D + k0 + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[(c + i) * ld + r] = v[i];
  }
}

// Stage whole rows row0 .. row0 + VK - 1 of a [n, D] matrix into
// dst[VK][D] (f32). Rows past n are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0,
                                           int n) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int CH = D / VEC;
  for (int e = threadIdx.x; e < VK * CH; e += kThreads) {
    const int r = e / CH;
    const int c = (e - r * CH) * VEC;
    float v[VEC];
    if (row0 + r < n) {
      Vec16<T>::load(src + (size_t)(row0 + r) * D + c, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[r * D + c + i] = v[i];
  }
}

// s[i][j] = panel row (p0 + 4 ty + i) . stream row (s0 + 4 tx + j), over
// all of D, in f32. pt / st are the chunk buffers. Starts and ends at a
// point where every thread may overwrite pt / st.
template <typename T, int D>
__device__ __forceinline__ void score_tile(float (&s)[4][4], float* pt,
                                           float* st, const T* P, int p0,
                                           int np, const T* S, int s0,
                                           int ns) {
  const int ty = threadIdx.x >> 5;
  const int tx = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int k0 = 0; k0 < D; k0 += KC) {
    __syncthreads();  // the previous chunk is consumed
    stage_chunk_t<T, D, RT>(pt, LDP, P, p0, np, k0);
    stage_chunk_t<T, D, ST>(st, LDS, S, s0, ns, k0);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(pt + k * LDP + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(st + k * LDS + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// x [N, D], e [V, D], tgt_ids [N] i32 -> lse [N], tgt [N] f32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ x, const T* __restrict__ e,
                    const int* __restrict__ tgt_ids, float* __restrict__ lse,
                    float* __restrict__ tgt, int N, int V) {
  __shared__ __align__(16) float pt[KC * LDP];
  __shared__ __align__(16) float st[KC * LDS];
  const int ty = threadIdx.x >> 5;
  const int tx = threadIdx.x & 31;
  const int p0 = blockIdx.x * RT;

  float m[4], l[4], tg[4];
  int id[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = p0 + 4 * ty + i;
    m[i] = kNeg;
    l[i] = 0.f;
    tg[i] = 0.f;
    id[i] = row < N ? tgt_ids[row] : -1;
  }

  for (int v0 = 0; v0 < V; v0 += ST) {
    float s[4][4];
    score_tile<T, D>(s, pt, st, x, p0, N, e, v0, V);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = v0 + 4 * tx + j;
        const bool valid = col < V;
        if (valid && col == id[i]) tg[i] += s[i][j];
        s[i][j] = valid ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + warp_sum(rs);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = p0 + 4 * ty + i;
    const float t = warp_sum(tg[i]);
    if (tx == 0 && row < N) {
      lse[row] = m[i] + logf(l[i]);
      tgt[row] = t;
    }
  }
}

// Vector width and count of the accumulator columns a lane owns: lane tx
// owns columns tx * VW + 32 * VW * j + w (j < NJ, w < VW), so a warp reads
// one contiguous row segment per j.
template <int D>
struct AccCols {
  static constexpr int VW = D >= 128 ? 4 : D / 32;
  static constexpr int NJ = D / (32 * VW);
  static_assert(VW == 2 || VW == 4, "D must be 64 or a multiple of 128");
  static_assert(NJ * 32 * VW == D, "D must be 64 or a multiple of 128");
};

template <int VW>
__device__ __forceinline__ void lds_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  }
}

template <int VW>
__device__ __forceinline__ void st_vec(float* p, const float* v) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

template <int D>
constexpr size_t bwd_smem() {
  return (size_t)(KC * LDP + KC * LDS + ST * LDP + VK * D + 4 * ST) *
         sizeof(float);
}

// ROW_PANEL (dx): the panel is RT rows of x, the stream is E, out = dx
// [N, D]. !ROW_PANEL (dE): the panel is RT rows of E, the stream is x, out
// = dE [V, D]. lse, c_lse, c_tgt [N] f32 and tgt_ids [N] i32 are per x row.
template <typename T, int D, bool ROW_PANEL>
__global__ void __launch_bounds__(kThreads, 1)
    xent_bwd_kernel(const T* __restrict__ x, const T* __restrict__ e,
                    const int* __restrict__ tgt_ids,
                    const float* __restrict__ lse,
                    const float* __restrict__ c_lse,
                    const float* __restrict__ c_tgt, float* __restrict__ out,
                    int N, int V) {
  using C = AccCols<D>;
  extern __shared__ __align__(16) float smem[];
  float* pt = smem;                 // [KC][LDP]
  float* st = pt + KC * LDP;        // [KC][LDS]
  float* dl = st + KC * LDS;        // [ST][LDP], dlog (stream row, panel row)
  float* rs = dl + ST * LDP;        // [VK][D], stream rows for (C)
  float* st_lse = rs + VK * D;      // [ST] stream-row stats (dE only)
  float* st_cl = st_lse + ST;
  float* st_ct = st_cl + ST;
  int* st_id = reinterpret_cast<int*>(st_ct + ST);

  const T* P = ROW_PANEL ? x : e;
  const T* S = ROW_PANEL ? e : x;
  const int np = ROW_PANEL ? N : V;
  const int ns = ROW_PANEL ? V : N;
  const int ty = threadIdx.x >> 5;
  const int tx = threadIdx.x & 31;
  const int p0 = blockIdx.x * RT;

  // dx: the panel rows' stats, once.
  float r_lse[4], r_cl[4], r_ct[4];
  int r_id[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = p0 + 4 * ty + i;
    const bool live = ROW_PANEL && row < N;
    r_lse[i] = live ? lse[row] : 0.f;
    r_cl[i] = live ? c_lse[row] : 0.f;
    r_ct[i] = live ? c_tgt[row] : 0.f;
    r_id[i] = live ? tgt_ids[row] : -1;
  }

  float acc[4][C::NJ][C::VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int w = 0; w < C::VW; ++w) acc[i][j][w] = 0.f;

  for (int s0 = 0; s0 < ns; s0 += ST) {
    if (!ROW_PANEL) {
      // dE: this tile's x-row stats (the previous tile's readers are past
      // the barriers of its accumulate stage).
      for (int r = threadIdx.x; r < ST; r += kThreads) {
        const int row = s0 + r;
        const bool live = row < N;
        st_lse[r] = live ? lse[row] : 0.f;
        st_cl[r] = live ? c_lse[row] : 0.f;
        st_ct[r] = live ? c_tgt[row] : 0.f;
        st_id[r] = live ? tgt_ids[row] : -1;
      }
    }
    // (A) scores; its barriers also publish the stats above.
    float s[4][4];
    score_tile<T, D>(s, pt, st, P, p0, np, S, s0, ns);

    // (B) dlog, parked as dl[stream row][panel row].
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pr = p0 + 4 * ty + i;   // panel row
        const int sr = s0 + 4 * tx + j;   // stream row
        float v_lse, v_cl, v_ct;
        int v_id, vocab;
        bool valid;
        if (ROW_PANEL) {
          v_lse = r_lse[i];
          v_cl = r_cl[i];
          v_ct = r_ct[i];
          v_id = r_id[i];
          vocab = sr;
          valid = pr < N && sr < V;
        } else {
          const int c = 4 * tx + j;
          v_lse = st_lse[c];
          v_cl = st_cl[c];
          v_ct = st_ct[c];
          v_id = st_id[c];
          vocab = pr;
          valid = pr < V && sr < N;
        }
        float d = 0.f;
        if (valid) {
          d = v_cl * expf(s[i][j] - v_lse);
          if (vocab == v_id) d += v_ct;
        }
        dl[(4 * tx + j) * LDP + 4 * ty + i] = d;
      }
    }

    // (C) acc[i][col] += sum_r dl[r][i] * stream[s0 + r][col].
    for (int r0 = 0; r0 < ST; r0 += VK) {
      __syncthreads();  // dl is complete; the previous rows are consumed
      stage_rows<T, D>(rs, S, s0 + r0, ns);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < VK; ++r) {
        const float4 d4 =
            *reinterpret_cast<const float4*>(dl + (r0 + r) * LDP + 4 * ty);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) {
          float ev[C::VW];
          lds_vec<C::VW>(rs + r * D + tx * C::VW + 32 * C::VW * j, ev);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int w = 0; w < C::VW; ++w)
              acc[i][j][w] = fmaf(dv[i], ev[w], acc[i][j][w]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = p0 + 4 * ty + i;
    if (row < np) {
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
        st_vec<C::VW>(out + (size_t)row * D + tx * C::VW + 32 * C::VW * j,
                      acc[i][j]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_fwd(const void* x, const void* e, const int* ids,
                       float* lse, float* tgt, int N, int V, cudaStream_t s) {
  xent_fwd_kernel<T, D><<<(N + RT - 1) / RT, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(e), ids, lse, tgt, N,
      V);
  return cudaGetLastError();
}

template <typename T, int D, bool ROW_PANEL>
cudaError_t launch_bwd(const void* x, const void* e, const int* ids,
                       const float* lse, const float* cl, const float* ct,
                       float* out, int N, int V, cudaStream_t s) {
  constexpr size_t smem = bwd_smem<D>();
  // Above 48 KB a kernel takes dynamic shared memory only after opting in.
  cudaError_t err = cudaFuncSetAttribute(
      xent_bwd_kernel<T, D, ROW_PANEL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int panels = ROW_PANEL ? N : V;
  xent_bwd_kernel<T, D, ROW_PANEL>
      <<<(panels + RT - 1) / RT, kThreads, smem, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(e), ids, lse, cl,
          ct, out, N, V);
  return cudaGetLastError();
}

// Calls F<T, D>::run(args...) for the runtime (dtype, D);
// cudaErrorInvalidValue when there is no such instantiation.
template <template <typename, int> class F, typename... A>
cudaError_t dispatch(int dtype, int D, A... args) {
#define RTT_CASE(T, DD) \
  if (D == DD) return F<T, DD>::run(args...);
#define RTT_WIDTHS(T) \
  RTT_CASE(T, 64)     \
  RTT_CASE(T, 128)    \
  RTT_CASE(T, 256)    \
  RTT_CASE(T, 512)    \
  RTT_CASE(T, 768)    \
  RTT_CASE(T, 1024)
  if (dtype == 0) {
    RTT_WIDTHS(float)
  } else if (dtype == 1) {
    RTT_WIDTHS(__nv_bfloat16)
  }
#undef RTT_WIDTHS
#undef RTT_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int D>
struct Fwd {
  static cudaError_t run(const void* x, const void* e, const int* ids,
                         float* lse, float* tgt, int N, int V,
                         cudaStream_t s) {
    return launch_fwd<T, D>(x, e, ids, lse, tgt, N, V, s);
  }
};

template <typename T, int D>
struct Dx {
  static cudaError_t run(const void* x, const void* e, const int* ids,
                         const float* lse, const float* cl, const float* ct,
                         float* out, int N, int V, cudaStream_t s) {
    return launch_bwd<T, D, true>(x, e, ids, lse, cl, ct, out, N, V, s);
  }
};

template <typename T, int D>
struct De {
  static cudaError_t run(const void* x, const void* e, const int* ids,
                         const float* lse, const float* cl, const float* ct,
                         float* out, int N, int V, cudaStream_t s) {
    return launch_bwd<T, D, false>(x, e, ids, lse, cl, ct, out, N, V, s);
  }
};

}  // namespace

// x [N, D], e [V, D] contiguous in one dtype (0 = float32, 1 = bfloat16);
// targets [N] int32; lse, tgt [N] float32 outputs.
extern "C" int rtt_xent_fwd(const void* x, const void* e, const void* targets,
                            void* lse, void* tgt, int N, int V, int D,
                            int dtype, void* stream) {
  return static_cast<int>(dispatch<Fwd>(
      dtype, D, x, e, static_cast<const int*>(targets),
      static_cast<float*>(lse), static_cast<float*>(tgt), N, V,
      static_cast<cudaStream_t>(stream)));
}

// lse, c_lse, c_tgt [N] float32; dx [N, D] float32 output.
extern "C" int rtt_xent_dx(const void* x, const void* e, const void* targets,
                           const void* lse, const void* c_lse,
                           const void* c_tgt, void* dx, int N, int V, int D,
                           int dtype, void* stream) {
  return static_cast<int>(dispatch<Dx>(
      dtype, D, x, e, static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(c_lse),
      static_cast<const float*>(c_tgt), static_cast<float*>(dx), N, V,
      static_cast<cudaStream_t>(stream)));
}

// dE [V, D] float32 output.
extern "C" int rtt_xent_de(const void* x, const void* e, const void* targets,
                           const void* lse, const void* c_lse,
                           const void* c_tgt, void* de, int N, int V, int D,
                           int dtype, void* stream) {
  return static_cast<int>(dispatch<De>(
      dtype, D, x, e, static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(c_lse),
      static_cast<const float*>(c_tgt), static_cast<float*>(de), N, V,
      static_cast<cudaStream_t>(stream)));
}
