// Decode and paged attention over a KV cache, hand-written for Hopper
// (sm_90a). Three kernels, one per TPU kernel they replace:
//
//   decode_kernel        replaces ray_tpu/ops/decode_attention.py::_decode_kernel
//                        (single query per (row, head) over a contiguous
//                        [B, S, H, D] cache, read in place: the TPU wrapper's
//                        transpose to [BH, S, D] and head padding are gone)
//   paged_decode_kernel  replaces ray_tpu/ops/decode_attention.py::_paged_kernel
//                        (single query per (row, head), decode tick)
//   paged_mq_kernel      replaces ray_tpu/ops/decode_attention.py::_paged_mq_kernel
//                        (W queries per (row, head) with the staircase mask
//                        col <= pos + i: chunked prefill and spec verify)
//
// Both compute what the Pallas kernels compute -- softmax(q K^T * D^-0.5)
// V over the logical positions a row may see, f32 accumulation, output in
// the input dtype -- but are not carried over block by block:
//
// - The pool is read in place, [n_blocks, bs, H, D] through strides. The
//   TPU wrappers transpose the whole pool to head-major on every call
//   (34 MB per layer per call at the serving shape); nothing here does.
// - D is not padded to 128, and pos / tables are read by each block from
//   device memory instead of riding in as broadcast [BH, 128] rows.
//
// What bounds them on an H100: both are device-memory bound. Decode does
// ~1 flop per byte of K/V it reads (4*D flops per position against 4*D
// bytes in bf16); prefill at C = 64 does ~C flops per byte of K/V, still
// under the card's ~295 flop/byte balance point. So the design goal is to
// read each K/V row that a row may see exactly once, 16 bytes per thread,
// with enough loads in flight, and to skip blocks past the last visible
// position at run time:
//
// - decode (both): one CTA per (b, h), the same device code
//   (decode_attend) over a map from position to cache row. Groups of GP
//   threads own one key row each (16-byte vector loads, so a group reads
//   one whole row in one instruction): GP is D / VEC rounded up to a
//   power of two, and the lanes past D idle (bf16 D 96 is 12 lanes of a
//   16-lane group), so every head dim that is a multiple of 8 up to 128
//   runs unpadded. The CTA walks the visible positions NG = 256 / GP rows
//   at a time, U steps unrolled so U K rows and U V rows are in flight
//   per group. Each group keeps its own online-softmax state (m, l, acc),
//   so the loop needs no block-wide synchronisation; the groups' states
//   are merged once through shared memory at the end.
// - multi-query: one CTA per (b*h, tile of QT = 256 / BS query rows). Each
//   logical block's K and V tile is staged in shared memory (f32, columns
//   past D zero up to the kernel's width DP, 32, 64 or 128) and shared by
//   the QT rows; one thread per (row, column) score, row reductions by
//   warp shuffles, P and the per-row rescale go through shared memory to
//   the P V product, whose outputs stay in registers. Padded query rows
//   reuse the last real row's mask and are not written. It takes block
//   sizes 8, 16 and 32; the Python wrapper presents any other multiple of
//   8 as one of them (a [n, 64, H, D] pool is a [2n, 32, H, D] pool).
//
// Simple and right first: wgmma, TMA and split-K over long contexts are
// later work. Each extern "C" entry launches on the given stream and
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it has
// no instantiation for); the Python wrapper raises on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // finite, as decode_attention.py's NEG_INF
constexpr int kThreads = 256;

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Where cache position t of row b lives, as a row index into storage seen
// as [rows, H, D]: through the block table (paged pool [n_blocks, bs, H, D])
// or directly (contiguous cache [B, S, H, D]).
struct PagedRows {
  const int* tables;  // [B, mb] i32
  int bs, mb;
  __device__ int limit() const { return mb * bs; }
  __device__ size_t row(int b, int t) const {
    return (size_t)tables[(size_t)b * mb + t / bs] * bs + t % bs;
  }
};

struct DenseRows {
  int S;
  __device__ int limit() const { return S; }
  __device__ size_t row(int b, int t) const { return (size_t)b * S + t; }
};

// Single-query attention for one (b, h) per CTA: q [B, H, D]; k, v seen as
// [rows, H, D] through `rows`; pos [B] i32; out [B, H, D]. Row b attends
// to positions 0..min(pos[b], rows.limit() - 1). Groups of GP lanes read a
// key row; lanes at or past D / VEC idle (D a multiple of VEC, at most
// GP * VEC).
template <typename T, int GP, int U, typename Rows>
__device__ __forceinline__ void decode_attend(const T* __restrict__ q,
                                              const T* __restrict__ k_pool,
                                              const T* __restrict__ v_pool,
                                              Rows rows,
                                              const int* __restrict__ pos,
                                              T* __restrict__ out, int H,
                                              int D, float scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int NG = kThreads / GP;  // key rows per CTA step
  static_assert(GP <= 32 && 32 % GP == 0, "bad lane group");

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = threadIdx.x / GP;
  const int gl = threadIdx.x - g * GP;
  const bool lane_live = gl * VEC < D;

  float qf[VEC];
  if (lane_live) {
    Vec16<T>::load(q + (size_t)bh * D + gl * VEC, qf);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) qf[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) qf[i] *= scale;

  const int last = min(pos[b], rows.limit() - 1);

  float m = kNegInf, l = 0.f;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  // t0 is uniform across the CTA, so every lane reaches every shuffle.
  for (int t0 = 0; t0 <= last; t0 += NG * U) {
    float kf[U][VEC], vf[U][VEC];
    bool live[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * NG + g;
      live[u] = t <= last;
      if (live[u] && lane_live) {
        const size_t row = rows.row(b, t) * H + h;
        Vec16<T>::load(k_pool + row * D + gl * VEC, kf[u]);
        Vec16<T>::load(v_pool + row * D + gl * VEC, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
    float s[U];
    float smax = kNegInf;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) d += qf[i] * kf[u][i];
#pragma unroll
      for (int off = GP / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      s[u] = live[u] ? d : kNegInf;
      smax = fmaxf(smax, s[u]);
    }
    const float m_new = fmaxf(m, smax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (live[u]) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += p * vf[u][i];
      }
    }
    m = m_new;
  }

// Merge the NG per-group softmax states. A group that saw no live row
  // holds (m = -1e30, l = 0, acc = 0) and drops out with weight exp(-huge).
  __shared__ float sm_m[NG];
  __shared__ float sm_l[NG];
  __shared__ float sm_acc[NG][GP * VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sm_acc[g][gl * VEC + i] = acc[i];
  if (gl == 0) {
    sm_m[g] = m;
    sm_l[g] = l;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mx = kNegInf;
    for (int gg = 0; gg < NG; ++gg) mx = fmaxf(mx, sm_m[gg]);
    float lsum = 0.f, o = 0.f;
    for (int gg = 0; gg < NG; ++gg) {
      const float w = expf(sm_m[gg] - mx);
      lsum += sm_l[gg] * w;
      o += sm_acc[gg][d] * w;
    }
    out[(size_t)bh * D + d] = from_f32<T>(o / lsum);
  }
}

// q [B, H, D]; pools [n_blocks, bs, H, D]; tables [B, mb] i32; pos [B] i32;
// out [B, H, D]. Row b attends to logical positions 0..min(pos[b], mb*bs-1).
template <typename T, int GP, int U>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int H, int D, int bs, int mb, float scale) {
  decode_attend<T, GP, U>(q, k_pool, v_pool, PagedRows{tables, bs, mb}, pos,
                          out, H, D, scale);
}

// q [B, H, D]; k, v [B, S, H, D] read in place; pos [B] i32; out [B, H, D].
// Row b attends to positions 0..min(pos[b], S-1).
template <typename T, int GP, int U>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ pos,
                  T* __restrict__ out, int H, int D, int S, float scale) {
  decode_attend<T, GP, U>(q, k, v, DenseRows{S}, pos, out, H, D, scale);
}

// q [B, W, H, D]; pools [n_blocks, BS, H, D]; tables [B, mb] i32; pos [B]
// i32; out [B, W, H, D]. Query i of row b sees logical positions
// <= pos[b] + i (and < mb * BS). D <= DP: shared tiles are DP wide, zero
// past D.
template <typename T, int DP, int BS>
__global__ void __launch_bounds__(kThreads)
    paged_mq_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ pos, T* __restrict__ out, int W,
                    int H, int D, int mb, float scale) {
  constexpr int QT = kThreads / BS;         // query rows per CTA
  constexpr int OSTEP = kThreads / DP;      // output rows per thread pass
  constexpr int NR = QT * DP / kThreads;    // outputs per thread
  static_assert(BS <= 32 && 32 % BS == 0, "bad block size");
  static_assert(kThreads % DP == 0 && NR >= 1, "bad head dim");

  __shared__ float qs[QT][DP + 1];  // +1: conflict-free column walks
  __shared__ float ks[BS][DP + 1];
  __shared__ float vs[BS][DP + 1];
  __shared__ float ps[QT][BS + 1];
  __shared__ float cs[QT];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int i0 = blockIdx.y * QT;
  const int tid = threadIdx.x;
  const int p0 = pos[b];
  const int* tbl = tables + (size_t)b * mb;

  for (int e = tid; e < QT * DP; e += kThreads) {
    const int i = e / DP, d = e - (e / DP) * DP;
    const int qi = min(i0 + i, W - 1);  // padded rows copy the last real row
    qs[i][d] =
        d < D ? to_f32(q[((size_t)(b * W + qi) * H + h) * D + d]) * scale
              : 0.f;
  }

  // Score role: thread (si, st) owns score column st of query row si.
  const int si = tid / BS;
  const int st = tid - si * BS;
  const int limit = p0 + min(i0 + si, W - 1);
  float m = kNegInf, l = 0.f;

  // Output role: thread owns (oi0 + r * OSTEP, od) for r < NR.
  const int od = tid % DP;
  const int oi0 = tid / DP;
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;

  // Runtime block skip: nothing past the tile's last real row's horizon.
  const int last_row = min(i0 + QT, W) - 1;
  const int n_blk = min((p0 + last_row) / BS + 1, mb);
  for (int j = 0; j < n_blk; ++j) {
    __syncthreads();  // the previous block's ks/vs/ps are consumed
    const size_t base = (size_t)tbl[j] * BS;
    for (int e = tid; e < BS * DP; e += kThreads) {
      const int t = e / DP, d = e - (e / DP) * DP;
      const size_t off = ((base + t) * H + h) * D + d;
      ks[t][d] = d < D ? to_f32(k_pool[off]) : 0.f;
      vs[t][d] = d < D ? to_f32(v_pool[off]) : 0.f;
    }
    __syncthreads();

    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < DP; ++d) s += qs[si][d] * ks[st][d];
    s = (j * BS + st <= limit) ? s : kNegInf;
    float bmax = s;
#pragma unroll
    for (int off = BS / 2; off > 0; off >>= 1)
      bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
    const float m_new = fmaxf(m, bmax);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    float psum = p;
#pragma unroll
    for (int off = BS / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * corr + psum;
    m = m_new;
    ps[si][st] = p;
    if (st == 0) cs[si] = corr;
    __syncthreads();

#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int oi = oi0 + r * OSTEP;
      float a = acc[r] * cs[oi];
#pragma unroll
      for (int t = 0; t < BS; ++t) a += ps[oi][t] * vs[t][od];
      acc[r] = a;
    }
  }
  __syncthreads();
  if (st == 0) cs[si] = l;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int oi = oi0 + r * OSTEP;
    const int qi = i0 + oi;
    if (qi < W && od < D)
      out[((size_t)(b * W + qi) * H + h) * D + od] =
          from_f32<T>(acc[r] / cs[oi]);
  }
}

// Threads per key row for a runtime head dim: D / VEC rounded up to a
// power of two (0 when D is not a multiple of VEC in 1 .. 32 * VEC).
template <typename T>
int lane_group(int D) {
  constexpr int VEC = Vec16<T>::N;
  if (D <= 0 || D % VEC != 0 || D > 32 * VEC) return 0;
  int gp = 1;
  while (gp * VEC < D) gp *= 2;
  return gp;
}

// Calls F<T, GP>::run(args...) for the lane group of head dim D; false when
// there is none.
template <template <typename, int> class F, typename T, typename... A>
bool dispatch_group(int D, A... args) {
  switch (lane_group<T>(D)) {
    case 1: F<T, 1>::run(args...); return true;
    case 2: F<T, 2>::run(args...); return true;
    case 4: F<T, 4>::run(args...); return true;
    case 8: F<T, 8>::run(args...); return true;
    case 16: F<T, 16>::run(args...); return true;
    case 32: F<T, 32>::run(args...); return true;
    default: return false;
  }
}

template <typename T, int GP>
struct PagedDecode {
  static void run(const void* q, const void* k, const void* v,
                  const int* tables, const int* pos, void* out, int B, int H,
                  int D, int bs, int mb, float scale, cudaStream_t stream) {
    paged_decode_kernel<T, GP, 4><<<B * H, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), tables, pos, static_cast<T*>(out), H, D, bs,
        mb, scale);
  }
};

template <typename T, int GP>
struct DenseDecode {
  static void run(const void* q, const void* k, const void* v, const int* pos,
                  void* out, int B, int H, int D, int S, float scale,
                  cudaStream_t stream) {
    decode_kernel<T, GP, 4><<<B * H, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), pos, static_cast<T*>(out), H, D, S, scale);
  }
};

template <typename T, int DP, int BS>
void launch_mq(const void* q, const void* k, const void* v, const int* tables,
               const int* pos, void* out, int B, int W, int H, int D, int mb,
               float scale, cudaStream_t stream) {
  constexpr int QT = kThreads / BS;
  const dim3 grid(B * H, (W + QT - 1) / QT);
  paged_mq_kernel<T, DP, BS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, pos, static_cast<T*>(out), W, H, D, mb,
      scale);
}

template <typename T, int DP>
bool dispatch_mq_bs(int bs, const void* q, const void* k, const void* v,
                    const int* tables, const int* pos, void* out, int B, int W,
                    int H, int D, int mb, float scale, cudaStream_t s) {
  switch (bs) {
    case 8: launch_mq<T, DP, 8>(q, k, v, tables, pos, out, B, W, H, D, mb, scale, s); return true;
    case 16: launch_mq<T, DP, 16>(q, k, v, tables, pos, out, B, W, H, D, mb, scale, s); return true;
    case 32: launch_mq<T, DP, 32>(q, k, v, tables, pos, out, B, W, H, D, mb, scale, s); return true;
    default: return false;
  }
}

// Head dims that are multiples of 8 up to 128, on the narrowest of the
// 32-, 64- and 128-wide tiles that holds them.
template <typename T>
bool dispatch_mq(int D, int bs, const void* q, const void* k, const void* v,
                 const int* tables, const int* pos, void* out, int B, int W,
                 int H, int mb, float scale, cudaStream_t s) {
  if (D <= 0 || D % 8 != 0 || D > 128) return false;
  if (D <= 32)
    return dispatch_mq_bs<T, 32>(bs, q, k, v, tables, pos, out, B, W, H, D, mb, scale, s);
  if (D <= 64)
    return dispatch_mq_bs<T, 64>(bs, q, k, v, tables, pos, out, B, W, H, D, mb, scale, s);
  return dispatch_mq_bs<T, 128>(bs, q, k, v, tables, pos, out, B, W, H, D, mb, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D a multiple of 8 up to 128 (the
// multi-query kernel's block size bs one of 8, 16, 32).
extern "C" int rtt_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const void* tables,
                                const void* pos, void* out, int B, int H,
                                int D, int bs, int mb, float scale, int dtype,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_group<PagedDecode, float>(D, q, k_pool, v_pool, t, p, out, B, H, D, bs, mb, scale, s);
  else if (dtype == 1)
    ok = dispatch_group<PagedDecode, __nv_bfloat16>(D, q, k_pool, v_pool, t, p, out, B, H, D, bs, mb, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// q [B, H, D]; k, v [B, S, H, D] contiguous; pos [B] i32; out [B, H, D].
extern "C" int rtt_decode(const void* q, const void* k, const void* v,
                          const void* pos, void* out, int B, int S, int H,
                          int D, float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_group<DenseDecode, float>(D, q, k, v, p, out, B, H, D, S, scale, s);
  else if (dtype == 1)
    ok = dispatch_group<DenseDecode, __nv_bfloat16>(D, q, k, v, p, out, B, H, D, S, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtt_paged_mq(const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* pos, void* out, int B, int W, int H,
                            int D, int bs, int mb, float scale, int dtype,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* p = static_cast<const int*>(pos);
  bool ok = false;
  if (dtype == 0)
    ok = dispatch_mq<float>(D, bs, q, k_pool, v_pool, t, p, out, B, W, H, mb, scale, s);
  else if (dtype == 1)
    ok = dispatch_mq<__nv_bfloat16>(D, bs, q, k_pool, v_pool, t, p, out, B, W, H, mb, scale, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
