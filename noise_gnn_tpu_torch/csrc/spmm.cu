// CSR segment-sum / segment-mean SpMM for Hopper (sm_90a).
//
//   out[v] = scale(v) * sum_{u in N_in(v)} x[u],   scale = 1/max(deg(v), 1)
//            for mean, 1 for sum; rows with no in-edges give 0.
//
// Replaces the Pallas TPU kernel noise_gnn_tpu/ops/pallas_spmm.py:147
// (_reduce_kernel_chunked) together with the XLA gather that feeds it
// (pallas_spmm.py:56-83, :481-501). It ports the semantics, not the TPU
// schedule: the one-hot MXU reduce, chunk maps, super-groups, aliased output
// and gather padding all served the TPU's gather engine and have no use here.
//
// Design: one warp per destination row. The warp loads 32 of the row's
// source indices at a time into registers and broadcasts them with
// __shfl_sync; for each source every lane reads V contiguous features (one
// 2/4/8/16-byte load) of the source row directly from device memory and adds
// them to fp32 registers. The row is scaled and written once, in the output
// dtype. No [E, F] message buffer exists. Row offsets src * F are int64.
// The vector width V is the widest whose loads stay aligned for every row:
// F % V == 0 and both base pointers aligned (products' raw F = 100 in bf16
// is a 200-byte row, so it takes 8-byte loads, not 16-byte ones).
//
// Bound on the H100: memory. A call must read x and the indices once and
// write out once (eval pair shape, N = 2.45 M, F = 512 bf16: ~5.3 GB, ~1.6 ms
// at 3.35 TB/s). This design reads each source row once per EDGE, not once
// per node, so a 2.5 GB table read at random misses the 50 MB L2 and the
// kernel moves ~deg-avg times the bound's bytes; hub rows (power-law
// in-degree) give one warp a long serial loop. Both are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// acc[i] += p[i] for i < V, with one aligned load of V * sizeof(Tin) bytes.
template <typename Tin, int V>
__device__ __forceinline__ void load_add(const Tin* __restrict__ p, float* acc) {
  using R = typename Raw<V * sizeof(Tin)>::T;
  const R r = *reinterpret_cast<const R*>(p);
  const Tin* e = reinterpret_cast<const Tin*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] += to_f32(e[i]);
}

// p[i] = v[i] * s for i < V, in aligned pieces of at most 16 bytes.
template <typename Tout, int V>
__device__ __forceinline__ void store_scaled(Tout* __restrict__ p, const float* v, float s) {
  constexpr int kBytes = V * (int)sizeof(Tout);
  constexpr int kPiece = kBytes > 16 ? 16 : kBytes;
  constexpr int kPer = kPiece / (int)sizeof(Tout);
  using R = typename Raw<kPiece>::T;
#pragma unroll
  for (int k = 0; k < V / kPer; ++k) {
    R r;
    Tout* e = reinterpret_cast<Tout*>(&r);
#pragma unroll
    for (int i = 0; i < kPer; ++i) e[i] = from_f32<Tout>(v[k * kPer + i] * s);
    *reinterpret_cast<R*>(p + k * kPer) = r;
  }
}

constexpr int kWarpsPerBlock = 8;

// One warp per row; each lane owns T vectors of V columns per column pass.
template <typename Tin, typename Tout, int V, int T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_kernel(const int64_t* __restrict__ indptr, const int32_t* __restrict__ indices,
                const Tin* __restrict__ x, Tout* __restrict__ out, int64_t n_rows,
                int64_t f, int mean) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  const int64_t start = indptr[row];
  const int64_t end = indptr[row + 1];
  const int64_t deg = end - start;
  const float scale = mean ? 1.0f / (float)(deg > 1 ? deg : 1) : 1.0f;
  const int64_t nvec = f / V;
  Tout* out_row = out + row * f;

  for (int64_t vbase = 0; vbase < nvec; vbase += 32 * T) {
    float acc[T][V];
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[t][i] = 0.0f;

    for (int64_t e0 = start; e0 < end; e0 += 32) {
      const int cnt = (int)(end - e0 < 32 ? end - e0 : 32);
      const int mine = lane < cnt ? indices[e0 + lane] : 0;
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int64_t src = __shfl_sync(0xffffffffu, mine, j);
        const Tin* x_row = x + src * f;
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int64_t vi = vbase + t * 32 + lane;
          if (vi < nvec) load_add<Tin, V>(x_row + vi * V, acc[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int64_t vi = vbase + t * 32 + lane;
      if (vi < nvec) store_scaled<Tout, V>(out_row + vi * V, acc[t], scale);
    }
  }
}

struct Args {
  const int64_t* indptr;
  const int32_t* indices;
  const void* x;
  void* out;
  int64_t n_rows;
  int64_t f;
  int mean;
  cudaStream_t stream;
};

template <typename Tin, typename Tout, int V, int T>
void launch(const Args& a) {
  const int64_t blocks = (a.n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spmm_csr_kernel<Tin, Tout, V, T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, a.stream>>>(
      a.indptr, a.indices, static_cast<const Tin*>(a.x), static_cast<Tout*>(a.out), a.n_rows,
      a.f, a.mean);
}

template <typename Tin, typename Tout, int V>
void launch_t(const Args& a, int t) {
  if (t == 1) launch<Tin, Tout, V, 1>(a);
  else if (t == 2) launch<Tin, Tout, V, 2>(a);
  else launch<Tin, Tout, V, 4>(a);
}

template <typename Tin, typename Tout>
void launch_v(const Args& a, int v, int t) {
  if constexpr (sizeof(Tin) == 2) {
    if (v == 8) return launch_t<Tin, Tout, 8>(a, t);
  }
  if (v == 4) launch_t<Tin, Tout, 4>(a, t);
  else if (v == 2) launch_t<Tin, Tout, 2>(a, t);
  else launch_t<Tin, Tout, 1>(a, t);
}

}  // namespace

// Plain C entry point (bound with ctypes). indptr int64 [n_rows + 1],
// indices int32 [E], x [N_src, f] and out [n_rows, f] row-major contiguous,
// float32 (flag 0) or bfloat16 (flag 1). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() of the launch (0 = success).
extern "C" int ngt_spmm_csr(const void* indptr, const void* indices, const void* x, void* out,
                            long long n_rows, long long f, int x_bf16, int out_bf16, int mean,
                            int device, void* stream) {
  if (n_rows <= 0 || f <= 0) return 0;
  int cur = -1;
  cudaGetDevice(&cur);
  if (cur != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  const int in_size = x_bf16 ? 2 : 4;
  const int out_size = out_bf16 ? 2 : 4;
  int v = 16 / in_size;  // widest load: 16 bytes
  while (v > 1) {
    const int out_piece = v * out_size > 16 ? 16 : v * out_size;
    const bool ok = f % v == 0 && reinterpret_cast<uintptr_t>(x) % (v * in_size) == 0 &&
                    reinterpret_cast<uintptr_t>(out) % out_piece == 0;
    if (ok) break;
    v >>= 1;
  }
  const long long nvec = f / v;
  const int t = nvec <= 32 ? 1 : (nvec <= 64 ? 2 : 4);
  Args a{static_cast<const int64_t*>(indptr), static_cast<const int32_t*>(indices), x, out,
         n_rows, f, mean, static_cast<cudaStream_t>(stream)};
  if (x_bf16 && out_bf16) launch_v<__nv_bfloat16, __nv_bfloat16>(a, v, t);
  else if (x_bf16) launch_v<__nv_bfloat16, float>(a, v, t);
  else if (out_bf16) launch_v<float, __nv_bfloat16>(a, v, t);
  else launch_v<float, float>(a, v, t);
  return (int)cudaGetLastError();
}
