// CSR graph attention for Hopper (sm_90a): GATConv's aggregation, forward.
//
//   out[v, hC:(h+1)C] = sum_{u in N_in(v)} a[v, u, h] x[u, hC:(h+1)C]
//   a[v, :, h]        = softmax_u(LeakyReLU(s_src[u, h] + s_dst[v, h]))
//
// for every head h of H over rows of W = H * C columns; a row without
// in-edges gives 0. The wrapper (ops/gat_attn.py) hands it GATConv's CSR,
// self-loops removed and one added per row.
//
// Replaces no TPU kernel: the JAX package has no multi-head GAT. Added
// because a full-graph GAT eval cannot run on products without it: the
// per-edge message buffer [E, H, C] of the plain scatter softmax would be
// 64.3 M x 1024 x 2 B = 132 GB for the pair's bf16 layers.
//
// Bound on the H100: memory. The least a call must move is x, the scores
// and the CSR read once and out written once (the products pair at W =
// 1024 bf16: 10.5 GB, 3.1 ms at 3.35 TB/s). Like the SpMM's gather
// (csrc/spmm.cu), it reads one source row per EDGE, which the 50 MB L2
// cannot hold for 2.45 M rows: 64.3 M x 2 KB = 132 GB a call, ~40 ms at
// the memory rate. Its design is the SpMM's, with the softmax's weights:
//
// 1. Edge-balanced segments (ops/spmm.py::segment_schedule, S = 256 edges,
//    longest first), one warp each. A row of one segment is normalised,
//    cast and written directly. A row of several writes its fp32 partial
//    sums with each head's max and sum of weights; gat_attn_combine_kernel
//    merges a row's partials by log-sum-exp in segment order. No float
//    atomics, so every call gives the same bits.
// 2. Per segment, the lanes first take each head's largest score over the
//    segment's edges (32 bytes of scores an edge against the row's 2 KB),
//    then, for every batch of 32 edges, each lane works out one edge's
//    weights exp(score - max) into shared memory, and the warp adds the
//    weighted source rows, staged through the SpMM's per-lane cp.async
//    ring: no accumulator is ever rescaled.
// 3. Loads are 16 bytes wide where the row allows. A vector that straddles
//    two heads (C = 47) weighs each element by its own head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <int B> struct Raw;
template <> struct Raw<2> { using T = unsigned short; };
template <> struct Raw<4> { using T = unsigned int; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype does
}

// p[i] = v[i] for i < V, in aligned pieces of at most 16 bytes.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  constexpr int kBytes = V * (int)sizeof(T);
  constexpr int kPiece = kBytes > 16 ? 16 : kBytes;
  constexpr int kPer = kPiece / (int)sizeof(T);
  using R = typename Raw<kPiece>::T;
#pragma unroll
  for (int k = 0; k < V / kPer; ++k) {
    R r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < kPer; ++i) e[i] = from_f32<T>(v[k * kPer + i]);
    *reinterpret_cast<R*>(p + k * kPer) = r;
  }
}

constexpr int kWarpsPerBlock = 8;
constexpr int kLoadsPerLane = 4;  // vector loads each lane keeps in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One B-byte vector from device memory to shared memory without waiting
// (cp.async; 16-byte pieces skip L1). cp.async takes no 2-byte piece: a
// 2-byte vector is a plain load and store.
template <int B> __device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  } else if constexpr (B == 2) {
    *reinterpret_cast<unsigned short*>(dst) = *reinterpret_cast<const unsigned short*>(src);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(B)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float leaky_relu(float v, float slope) {
  return v > 0.0f ? v : v * slope;
}

// Edges in flight per lane for T vectors a lane: kLoadsPerLane loads.
__host__ __device__ constexpr int edges_in_flight(int T) {
  return T >= kLoadsPerLane ? 1 : kLoadsPerLane / T;
}

// One warp per segment. Lane l owns vectors l, l + 32, ..., l + 32 (T - 1)
// of each column pass; a pass's rounds take U edges each, edge k's copy
// issued U edges before it is added. HM >= H is the register arrays' size;
// kVecHead: every vector lies inside one head (C % V == 0).
template <typename T, int V, int NT, int HM, bool kVecHead>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_attn_segment_kernel(const int32_t* __restrict__ indices, const T* __restrict__ x,
                        const float* __restrict__ s_src, const float* __restrict__ s_dst,
                        const int64_t* __restrict__ seg_start, const int32_t* __restrict__ seg_len,
                        const int32_t* __restrict__ seg_dst, const int32_t* __restrict__ seg_row,
                        T* __restrict__ out, float* __restrict__ partial,
                        float* __restrict__ part_ml, int64_t nseg, int64_t w, int heads, int c,
                        float slope) {
  using R = typename Raw<V * sizeof(T)>::T;
  constexpr int U = edges_in_flight(NT);
  static_assert(32 % U == 0, "a round must lie within one batch of 32 edges");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t s = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (s >= nseg) return;  // uniform across the warp
  const int32_t* idx = indices + seg_start[s];
  const int len = seg_len[s];
  const int dst = seg_dst[s];
  const int64_t row = seg_row[s];
  // this lane's ring (slot u's vector t at ring[(u * NT + t) * 32]), then
  // the warp's weights of the current batch [32][HM] and its sums [HM]
  R* ring = reinterpret_cast<R*>(smem_raw) + warp * (U * NT * 32) + lane;
  float* wts = reinterpret_cast<float*>(smem_raw + kWarpsPerBlock * U * NT * 32 * sizeof(R)) +
               warp * (33 * HM);
  float* sums = wts + 32 * HM;

  float sd[HM], mx[HM], l[HM];
#pragma unroll
  for (int h = 0; h < HM; ++h) {
    sd[h] = h < heads ? s_dst[row * heads + h] : 0.0f;
    mx[h] = -INFINITY;
    l[h] = 0.0f;
  }
  // 1. each head's largest score over the segment's edges
  for (int k = lane; k < len; k += 32) {
    const float* sj = s_src + (int64_t)idx[k] * heads;
#pragma unroll
    for (int h = 0; h < HM; ++h)
      if (h < heads) mx[h] = fmaxf(mx[h], leaky_relu(sj[h] + sd[h], slope));
  }
#pragma unroll
  for (int h = 0; h < HM; ++h)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], o));

  const int64_t nvec = w / V;
  const int rounds = (len + U - 1) / U;
  // 2. per column pass, the weighted sum of the source rows
  for (int64_t vbase = 0; vbase < nvec; vbase += 32 * NT) {
    const bool first = vbase == 0;
    int col[NT];
    bool live[NT];
    int hd[NT][kVecHead ? 1 : V];  // the head of each owned element
    float acc[NT][V];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int64_t vi = vbase + t * 32 + lane;
      live[t] = vi < nvec;
      col[t] = live[t] ? (int)(vi * V) : 0;
#pragma unroll
      for (int i = 0; i < (kVecHead ? 1 : V); ++i) hd[t][i] = (col[t] + i) / c;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[t][i] = 0.0f;
    }
    // source indices of edges [32 b, 32 b + 32) and of the batch after
    int cur = lane < len ? idx[lane] : 0;
    int nxt = 32 + lane < len ? idx[32 + lane] : 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t src = __shfl_sync(kFull, cur, u);
      if (u < len) {
        const T* rowp = x + src * w;
#pragma unroll
        for (int t = 0; t < NT; ++t)
          if (live[t]) cp_async<sizeof(R)>(ring + (u * NT + t) * 32, rowp + col[t]);
      }
      cp_commit();
    }
    for (int r = 0; r < rounds; ++r) {
      const int k0 = r * U, k1 = k0 + U;
      if ((k0 & 31) == 0) {  // a new batch: each lane one edge's weights
        __syncwarp();
        if (k0 + lane < len) {
          const float* sj = s_src + (int64_t)cur * heads;
#pragma unroll
          for (int h = 0; h < HM; ++h) {
            if (h >= heads) continue;
            const float p = expf(leaky_relu(sj[h] + sd[h], slope) - mx[h]);
            wts[lane * HM + h] = p;
            if (first) l[h] += p;
          }
        }
        __syncwarp();
      }
      const bool turn = (k1 & 31) == 0;  // the next round starts the next batch
      const int from = turn ? nxt : cur;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u;
        cp_wait<U - 1>();
        if (k < len) {
          const float* wk = wts + (k & 31) * HM;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            if (!live[t]) continue;
            const R rv = ring[(u * NT + t) * 32];
            const T* e = reinterpret_cast<const T*>(&rv);
            if constexpr (kVecHead) {
              const float a = wk[hd[t][0]];
#pragma unroll
              for (int i = 0; i < V; ++i) acc[t][i] = fmaf(a, to_f32(e[i]), acc[t][i]);
            } else {
#pragma unroll
              for (int i = 0; i < V; ++i) acc[t][i] = fmaf(wk[hd[t][i]], to_f32(e[i]), acc[t][i]);
            }
          }
        }
        const int64_t src = __shfl_sync(kFull, from, (k1 + u) & 31);
        if (k1 + u < len) {
          const T* rowp = x + src * w;
#pragma unroll
          for (int t = 0; t < NT; ++t)
            if (live[t]) cp_async<sizeof(R)>(ring + (u * NT + t) * 32, rowp + col[t]);
        }
        cp_commit();
      }
      if (turn) {
        cur = nxt;
        nxt = k1 + 32 + lane < len ? idx[k1 + 32 + lane] : 0;
      }
    }
    if (first) {
      // the weights' sums, in a fixed butterfly order (the same on every lane)
#pragma unroll
      for (int h = 0; h < HM; ++h)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) l[h] += __shfl_xor_sync(kFull, l[h], o);
      __syncwarp();
      if (lane < heads) {
#pragma unroll
        for (int h = 0; h < HM; ++h)
          if (h == lane) sums[h] = l[h];
      }
      if (dst < 0 && lane == 0) {  // a split row's segment: its max and sum
        float* ml = part_ml + (int64_t)(-1 - dst) * 2 * heads;
#pragma unroll
        for (int h = 0; h < HM; ++h)
          if (h < heads) {
            ml[h] = mx[h];
            ml[heads + h] = l[h];
          }
      }
      __syncwarp();
    }
    if (dst >= 0) {  // the row's only segment: normalise, cast, write
      T* o = out + (int64_t)dst * w;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (!live[t]) continue;
        float v[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float den = sums[hd[t][kVecHead ? 0 : i]];
          v[i] = den > 0.0f ? acc[t][i] / den : 0.0f;  // no edges: 0
        }
        store_vec<T, V>(o + col[t], v);
      }
    } else {  // one segment of a split row: its fp32 partial sums
      float* p = partial + (int64_t)(-1 - dst) * w;
#pragma unroll
      for (int t = 0; t < NT; ++t)
        if (live[t]) store_vec<float, V>(p + col[t], acc[t]);
    }
  }
}

// One warp per split row: its segments' partials merged by log-sum-exp in
// segment order, normalised, cast and written.
template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_attn_combine_kernel(const int32_t* __restrict__ comb_row, const int64_t* __restrict__ comb_ptr,
                        const float* __restrict__ partial, const float* __restrict__ part_ml,
                        T* __restrict__ out, int64_t nsplit, int64_t w, int heads, int c) {
  const int lane = threadIdx.x & 31;
  const int64_t j = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= nsplit) return;
  const int64_t row = comb_row[j];
  const int64_t p0 = comb_ptr[j], p1 = comb_ptr[j + 1];
  for (int64_t col = lane; col < w; col += 32) {
    const int h = (int)(col / c);
    float m = -INFINITY;
    for (int64_t p = p0; p < p1; ++p) m = fmaxf(m, part_ml[p * 2 * heads + h]);
    float num = 0.0f, den = 0.0f;
    for (int64_t p = p0; p < p1; ++p) {
      const float sc = expf(part_ml[p * 2 * heads + h] - m);
      den = fmaf(part_ml[p * 2 * heads + heads + h], sc, den);
      num = fmaf(partial[p * w + col], sc, num);
    }
    out[row * w + col] = from_f32<T>(num / den);
  }
}

struct Args {
  const int32_t* indices;
  const void* x;
  const float* s_src;
  const float* s_dst;
  const int64_t* seg_start;
  const int32_t* seg_len;
  const int32_t* seg_dst;
  const int32_t* seg_row;
  int64_t nseg;
  const int32_t* comb_row;
  const int64_t* comb_ptr;
  int64_t nsplit;
  float* partial;
  float* part_ml;
  void* out;
  int64_t w;
  int heads;
  int c;
  float slope;
  cudaStream_t stream;
};

template <typename T, int V, int NT, int HM, bool kVecHead>
cudaError_t launch(const Args& a) {
  using R = typename Raw<V * sizeof(T)>::T;
  constexpr int U = edges_in_flight(NT);
  constexpr int smem = kWarpsPerBlock * (U * NT * 32 * (int)sizeof(R) + 33 * HM * 4);
  static_assert(smem <= 48 * 1024, "the rings and weights must fit the default shared memory");
  const int64_t blocks = (a.nseg + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gat_attn_segment_kernel<T, V, NT, HM, kVecHead>
      <<<(unsigned)blocks, kWarpsPerBlock * 32, smem, a.stream>>>(
          a.indices, static_cast<const T*>(a.x), a.s_src, a.s_dst, a.seg_start, a.seg_len,
          a.seg_dst, a.seg_row, static_cast<T*>(a.out), a.partial, a.part_ml, a.nseg, a.w,
          a.heads, a.c, a.slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 0) return err;
  const int64_t cblocks = (a.nsplit + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gat_attn_combine_kernel<T><<<(unsigned)cblocks, kWarpsPerBlock * 32, 0, a.stream>>>(
      a.comb_row, a.comb_ptr, a.partial, a.part_ml, static_cast<T*>(a.out), a.nsplit, a.w,
      a.heads, a.c);
  return cudaGetLastError();
}

// NT from the vectors a row holds: 1, 2 or 4 a lane per column pass.
template <typename T, int V, int HM, bool kVecHead>
cudaError_t launch_t(const Args& a) {
  const int64_t nvec = a.w / V;
  if (nvec <= 32) return launch<T, V, 1, HM, kVecHead>(a);
  if (nvec <= 64) return launch<T, V, 2, HM, kVecHead>(a);
  return launch<T, V, 4, HM, kVecHead>(a);
}

template <typename T, int HM>
cudaError_t launch_v(const Args& a, int v) {
  constexpr int kWide = 16 / (int)sizeof(T);  // 16-byte vectors
  const bool in_head = a.c % v == 0;
  if (v == kWide) {
    return in_head ? launch_t<T, kWide, HM, true>(a) : launch_t<T, kWide, HM, false>(a);
  }
  if constexpr (kWide == 8) {
    if (v == 4) return in_head ? launch_t<T, 4, HM, true>(a) : launch_t<T, 4, HM, false>(a);
  }
  return launch_t<T, 1, HM, true>(a);
}

}  // namespace

// Plain C entry point (bound with ctypes). indices int32 [E] of a CSR whose
// rows are destinations; x [N, w] and out [N, w] row-major contiguous,
// float32 (flag 0) or bfloat16 (flag 1), w = heads * c; s_src and s_dst
// float32 [N, heads], heads <= 16. The schedule (ops/spmm.py::
// segment_schedule): seg_start int64, seg_len, seg_dst and seg_row int32
// [nseg] (seg_dst = the output row, or -1 - the segment's partial slot;
// seg_row = the row), comb_row int32 [nsplit], comb_ptr int64 [nsplit + 1];
// partial fp32 [comb_ptr[nsplit], w] and part_ml fp32 [comb_ptr[nsplit],
// 2 heads] are scratch. Launches on `stream`, does not synchronise, and
// returns the first cudaGetLastError() of the launches (0 = success).
extern "C" int ngt_gat_attn(const void* indices, const void* x, const void* s_src,
                            const void* s_dst, const void* seg_start, const void* seg_len,
                            const void* seg_dst, const void* seg_row, long long nseg,
                            const void* comb_row, const void* comb_ptr, long long nsplit,
                            void* partial, void* part_ml, void* out, long long w, int heads,
                            int x_bf16, float slope, int device, void* stream) {
  if (nseg <= 0 || w <= 0) return 0;
  if (heads < 1 || heads > 16 || w % heads) return (int)cudaErrorInvalidValue;
  int cur = -1;
  cudaGetDevice(&cur);
  if (cur != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  const int size = x_bf16 ? 2 : 4;
  int v = 16 / size;  // widest load: 16 bytes
  while (v > 1) {
    const bool ok = w % v == 0 && reinterpret_cast<uintptr_t>(x) % (v * size) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % (v * size) == 0;
    if (ok) break;
    v >>= 1;
  }
  if (v != 16 / size && !(x_bf16 && v == 4)) v = 1;  // the widths instantiated
  Args a{static_cast<const int32_t*>(indices), x, static_cast<const float*>(s_src),
         static_cast<const float*>(s_dst), static_cast<const int64_t*>(seg_start),
         static_cast<const int32_t*>(seg_len), static_cast<const int32_t*>(seg_dst),
         static_cast<const int32_t*>(seg_row), nseg, static_cast<const int32_t*>(comb_row),
         static_cast<const int64_t*>(comb_ptr), nsplit, static_cast<float*>(partial),
         static_cast<float*>(part_ml), out, w, heads, (int)(w / heads), slope,
         static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (x_bf16) {
    err = heads <= 8 ? launch_v<__nv_bfloat16, 8>(a, v) : launch_v<__nv_bfloat16, 16>(a, v);
  } else {
    err = heads <= 8 ? launch_v<float, 8>(a, v) : launch_v<float, 16>(a, v);
  }
  return (int)err;
}
