// Gather-ring probe for Hopper (sm_90a): per-block gathers through a ring of
// asynchronous bulk copies (TMA) in shared memory.
//
// Replaces the Pallas TPU kernel tools/exp_dma_gather.py:56 (make().kernel),
// a throughput probe for per-block DMA gathers. Grid step (p, c) of that
// kernel walks the `chunk` indices idx[c * chunk + i] and copies the aligned
// 8-row block x3[idx[...]] ([8, F] f32) into slot i % depth of a ring of
// `depth` blocks in VMEM, keeping up to `depth` copies in flight with one DMA
// semaphore per slot. Here one thread block does one grid step, so the grid
// is P * E / chunk blocks; each keeps the ring in dynamic shared memory, and
// a copy is one 1-D TMA bulk copy (cp.async.bulk ... mbarrier::complete_tx)
// issued by one elected thread, with one mbarrier per slot whose expected
// transaction count is the block's byte count: the counterpart of one DMA
// descriptor and its semaphore.
//
// Ring reuse. The TPU kernel starts the copy for index i + depth into a slot
// before it waits for copy i into that slot, so what a slot ends up holding
// is a race there. This kernel waits on the slot's barrier (phase parity)
// before it reissues the slot, so its result is defined: slot s of chunk
// (p, c) holds x3[idx[c * chunk + i_s]], where i_s is the largest i < chunk
// with i = s (mod depth). The block writes its final ring to
// out[p, c] : [depth, 8, F]; out[P - 1, E / chunk - 1, 0] is what the TPU
// kernel returns.
//
// Bound on the H100: memory. Every copy reads 32 F bytes of device memory at
// a random block (P * E * 32 F bytes: 17.18 GB at the probe's shapes, ~5.1 ms
// at 3.35 TB/s); the indices and the ring writes add ~1.2%. The design keeps
// `depth` copies in flight per block and as many blocks per SM as shared
// memory allows; the chunk's indices are staged in shared memory first, so
// the issuing thread never waits on an index load. Block offsets are int64
// (idx * 32 F reaches 1 GB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also sets the number of bytes the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D TMA bulk copy global -> shared; completion is counted on `bar`.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__host__ __device__ inline size_t bar_bytes(int depth) {
  return ((size_t)depth * 8 + 127) / 128 * 128;  // keeps the ring 128-byte aligned
}

// Shared memory: [depth mbarriers | ring of depth blocks | chunk indices].
__global__ void __launch_bounds__(kThreads)
gather_ring_kernel(const float* __restrict__ x3, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int nchunks, int chunk, int depth, int block_floats) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + bar_bytes(depth));
  int32_t* sidx = reinterpret_cast<int32_t*>(ring + (size_t)depth * block_floats);
  const uint32_t block_bytes = (uint32_t)block_floats * 4u;
  const int c = blockIdx.x % nchunks;

  const int32_t* cidx = idx + (int64_t)c * chunk;
  for (int i = threadIdx.x; i < chunk; i += kThreads) sidx[i] = cidx[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    auto issue = [&](int i) {
      const int s = i % depth;
      const uint32_t bar = smem_u32(&bars[s]);
      mbar_expect_tx(bar, block_bytes);
      bulk_g2s(smem_u32(ring + (size_t)s * block_floats),
               x3 + (int64_t)sidx[i] * block_floats, block_bytes, bar);
    };
    for (int i = 0; i < depth; ++i) issue(i);
    for (int i = 0; i < chunk; ++i) {
      // copy i is the (i / depth)-th into its slot: wait for it, then reuse the slot
      mbar_wait(smem_u32(&bars[i % depth]), (uint32_t)(i / depth) & 1u);
      if (i + depth < chunk) issue(i + depth);
    }
  }
  __syncthreads();
  // every copy has landed; each thread observes its slot's last phase itself
  // so that the bulk copies' writes are visible to it
  for (int s = 0; s < depth; ++s)
    mbar_wait(smem_u32(&bars[s]), (uint32_t)((chunk - 1 - s) / depth) & 1u);

  float4* dst = reinterpret_cast<float4*>(out + (int64_t)blockIdx.x * depth * block_floats);
  const float4* src = reinterpret_cast<const float4*>(ring);
  const int n4 = depth * block_floats / 4;
  for (int k = threadIdx.x; k < n4; k += kThreads) dst[k] = src[k];
}

}  // namespace

// Shared memory one block needs, in bytes (the wrapper checks it against
// the card's limit before launching).
extern "C" long long ngt_gather_ring_smem(int chunk, int depth, int f) {
  return (long long)(bar_bytes(depth) + (size_t)depth * 8 * f * 4 + (size_t)chunk * 4);
}

// Plain C entry point (bound with ctypes). x3 [n_blocks, 8, f] f32 and idx
// [nchunks * chunk] int32 (block ids) in device memory, x3 16-byte aligned;
// out [passes, nchunks, depth, 8, f] f32; 1 <= depth <= chunk. Launches on
// `stream`, does not synchronise, and returns the first CUDA error of the
// set-up or the launch (0 = success).
extern "C" int ngt_gather_ring(const void* x3, const void* idx, void* out, int passes,
                               int nchunks, int chunk, int depth, int f, int device,
                               void* stream) {
  if (passes <= 0 || nchunks <= 0) return 0;
  int cur = -1;
  cudaGetDevice(&cur);
  if (cur != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  const int smem = (int)ngt_gather_ring_smem(chunk, depth, f);
  cudaError_t err = cudaFuncSetAttribute(gather_ring_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)passes * nchunks;
  gather_ring_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x3), static_cast<const int32_t*>(idx), static_cast<float*>(out),
      nchunks, chunk, depth, 8 * f);
  return (int)cudaGetLastError();
}
