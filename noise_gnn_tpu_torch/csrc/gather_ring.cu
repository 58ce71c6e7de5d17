// Gather-ring probe for Hopper (sm_90a): per-block gathers through a ring of
// asynchronous bulk copies (TMA) in shared memory, one copy multicast to
// every pass of a chunk held by a thread-block cluster.
//
// Replaces the Pallas TPU kernel tools/exp_dma_gather.py:56 (make().kernel),
// a throughput probe for per-block DMA gathers. Grid step (p, c) of that
// kernel walks the `chunk` indices idx[c * chunk + i] and copies the aligned
// 8-row block x3[idx[...]] ([8, F] f32) into slot i % depth of a ring of
// `depth` blocks in VMEM, keeping up to `depth` copies in flight with one DMA
// semaphore per slot. Here one thread block does one grid step and keeps the
// ring in dynamic shared memory; a copy is one 1-D TMA bulk copy
// (cp.async.bulk ... mbarrier::complete_tx) counted on one "full" mbarrier
// per slot: the counterpart of one DMA descriptor and its semaphore.
//
// Ring reuse. The TPU kernel starts the copy for index i + depth into a slot
// before it waits for copy i into that slot, so what a slot ends up holding
// is a race there. Here a slot is reissued only after the copy into it has
// landed, so the result is defined: slot s of step (p, c) holds
// x3[idx[c * chunk + i_s]], where i_s is the largest i < chunk with
// i = s (mod depth). The block writes its final ring to out[p, c] :
// [depth, 8, F]; out[P - 1, E / chunk - 1, 0] is what the TPU kernel returns.
//
// Bound on the H100: memory. The least a call must move is each distinct
// block once, the ids and the rings written (0.20-0.26 GB at the probe's
// shapes). But the P passes make P * E copies of 32 F bytes (17.18 GB at
// the probe's shapes: 5.1 ms at 3.35 TB/s), all landing in shared memory,
// and every pass copies the same blocks in the same order. Measured on the
// H100, three things held the single-block, one-thread design back: the
// pass-major grid kept the passes of a chunk apart in time, so their
// re-reads missed L2; each copy was read from L2 or device memory on its
// own; and a deep ring (one block an SM) was bound by its one thread's
// work per copy, not by round trips (depth 16 and 24 took the same time),
// where even an integer division per copy showed.
//
// What the design does about it:
// - Chunk-major grid: block b is pass b % P of chunk b / P, so the passes
//   of a chunk are adjacent in launch order and run side by side.
// - Clusters of C blocks (C = 1, 2, 4 or 8 dividing P, picked by the
//   wrapper's ops/gather_ring.py::cluster_size) hold C consecutive passes
//   of one chunk; rank r is pass q * C + r. Copy i is issued by rank i % C
//   as one multicast bulk copy (.multicast::cluster, ctaMask = all C
//   ranks): it is read once from L2 or device memory, lands at the same
//   offset in all C rings and completes its bytes on each block's full
//   barrier of that slot. Reads fall C-fold and the C passes run in step.
//   Each rank stages only the ids it issues. C = 1 launches no cluster and
//   takes no handshake.
// - Empty handshake: a slot may take copy i + depth only once copy i has
//   landed in every block of the cluster. Each block has one "empty"
//   mbarrier per slot (arrival count C). When a block sees copy i land on
//   its full barrier, it arms the slot's next phase (expect_tx) and then
//   arrives (mapa + mbarrier.arrive.shared::cluster) on that slot's empty
//   barrier in the rank that issues copy i + depth, which waits there
//   before it issues. So at most `depth` copies are in flight per block, and
//   every phase is armed before its bytes can be issued. The arrive and the
//   waits keep their default block-scope semantics: the order that matters
//   is carried by the barriers themselves (cluster-scope release/acquire
//   measured 1.7-3.8x slower with clusters).
// - One chain of slots per warp: slots are independent, so lane 0 of warp w
//   runs slots w, w + W, ..., doing all of the above for them in order, with
//   masks and shifts for C. A deep ring's per-copy work is spread over W
//   threads instead of one. W = depth / 2, from 1 to 8: two slots a chain
//   measured faster than one at every depth up to 16 (at depth 2 one chain
//   kept the passes of a chunk in step; two chains cost it 12-82%).
// - Cluster barriers after the barriers' init and before exit: no multicast
//   or remote arrive reaches a block before its barriers exist or after it
//   has left.
// Block offsets are int64 (idx * 32 F reaches 1 GB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;  // at most 8 chains of slots, one per warp
constexpr int kMaxCluster = 8;  // the portable limit; 16 measured slower
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// All threads of all blocks of the cluster; release before, acquire after.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
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

// One arrival on the barrier at offset `bar` in the shared memory of the
// cluster's block `rank` (this block's own included).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// Whether the phase of the given parity has completed.
__device__ __forceinline__ bool mbar_done(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_done(bar, parity)) {
  }
}

// 1-D TMA bulk copy global -> this block's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The same copy into every block of `mask`, at the same offsets, counted on
// each block's barrier at the same offset.
__device__ __forceinline__ void bulk_g2s_multicast(uint32_t dst, const void* src,
                                                   uint32_t bytes, uint32_t bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// Full and empty barriers and each empty barrier's phase parity, padded so
// that the ring is 128-byte aligned.
__host__ __device__ inline size_t bar_bytes(int depth) {
  return ((size_t)depth * 17 + 127) / 128 * 128;
}

__host__ __device__ inline size_t smem_bytes(int chunk, int depth, int f, int csize) {
  return bar_bytes(depth) + (size_t)depth * 8 * f * 4 + (size_t)(chunk + csize - 1) / csize * 4;
}

// Shared memory: [depth full | depth empty | depth empty parities | ring of
// depth blocks | the ids this rank issues]; all but the ids at the same
// offsets in every block of a cluster.
__global__ void __launch_bounds__(kMaxWarps * 32)
gather_ring_kernel(const float* __restrict__ x3, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int passes, int nchunks, int chunk, int depth,
                   int block_floats) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + depth;
  uint8_t* empty_parity = reinterpret_cast<uint8_t*>(empty + depth);
  float* ring = reinterpret_cast<float*>(smem + bar_bytes(depth));
  int32_t* sidx = reinterpret_cast<int32_t*>(ring + (size_t)depth * block_floats);
  const uint32_t block_bytes = (uint32_t)block_floats * 4u;
  const int p = blockIdx.x % passes, c = blockIdx.x / passes;  // chunk-major
  const int csize = (int)cluster_blocks(), rank = (int)cluster_rank();

  const int32_t* cidx = idx + (int64_t)c * chunk;
  const int mine = (chunk - rank + csize - 1) / csize;  // copies rank, rank + C, ...
  for (int k = threadIdx.x; k < mine; k += blockDim.x) sidx[k] = cidx[rank + k * csize];
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), csize);
      empty_parity[s] = 0;
      // arm the first copy into each slot before any block may issue it
      mbar_expect_tx(smem_u32(&full[s]), block_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (csize > 1) {
    cluster_arrive();
    cluster_wait();
  }

  // Warp w's lane 0 runs the chain of slots w, w + W, ... (W chains): for
  // each copy into them, in order, it waits for the copy to land, arms the
  // slot's next phase, signals the rank that issues the next copy into the
  // slot and, where that is this rank, waits for every block's signal and
  // issues it. Slots are independent, so the chains need no ordering.
  const int warp = threadIdx.x / 32;
  const int chains = max(1, min(depth / 2, kMaxWarps));
  if (threadIdx.x % 32 == 0 && warp < chains) {
    // C is a power of two: copy i is issued by rank i & (C - 1), as the
    // (i >> log2 C)-th of that rank's copies (no division per copy)
    const int cmask = csize - 1, cshift = __ffs(csize) - 1;
    const uint16_t mask = (uint16_t)((1u << csize) - 1u);
    auto issue = [&](int i, int s) {  // copy i, into slot s
      const uint32_t dst = smem_u32(ring + (size_t)s * block_floats);
      const float* src = x3 + (int64_t)sidx[i >> cshift] * block_floats;
      if (csize == 1)
        bulk_g2s(dst, src, block_bytes, smem_u32(&full[s]));
      else
        bulk_g2s_multicast(dst, src, block_bytes, smem_u32(&full[s]), mask);
    };
    for (int s = warp; s < depth; s += chains)
      if ((s & cmask) == rank) issue(s, s);
    uint32_t parity = 0;
    for (int base = 0; base < chunk; base += depth, parity ^= 1u) {
      for (int s = warp, i = base + warp; s < depth && i < chunk; s += chains, i += chains) {
        mbar_wait(smem_u32(&full[s]), parity);
        const int j = i + depth;  // the next copy into slot s
        if (j >= chunk) continue;
        mbar_expect_tx(smem_u32(&full[s]), block_bytes);
        const int issuer = j & cmask;
        if (csize > 1) mbar_arrive_remote(smem_u32(&empty[s]), (uint32_t)issuer);
        if (issuer != rank) continue;
        if (csize > 1) {  // copy i must have landed in every block
          mbar_wait(smem_u32(&empty[s]), empty_parity[s]);
          empty_parity[s] ^= 1;
        }
        issue(j, s);
      }
    }
  }
  __syncthreads();
  // every copy has landed; each thread observes its slot's last phase itself
  // so that the bulk copies' writes are visible to it
  for (int s = 0; s < depth; ++s)
    mbar_wait(smem_u32(&full[s]), (uint32_t)((chunk - 1 - s) / depth) & 1u);
  if (csize > 1) cluster_arrive();

  float4* dst = reinterpret_cast<float4*>(out + ((int64_t)p * nchunks + c) * depth * block_floats);
  const float4* src = reinterpret_cast<const float4*>(ring);
  const int n4 = depth * block_floats / 4;
  for (int k = threadIdx.x; k < n4; k += blockDim.x) dst[k] = src[k];
  if (csize > 1) cluster_wait();  // no block leaves while another may still reach it
}

// Once per device: dynamic shared memory up to the card's limit.
cudaError_t prepare(int device) {
  static bool done[64] = {};
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      gather_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return err;
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaGetDevice(&cur);
  if (cur != device) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
  }
  return prepare(device);
}

cudaLaunchConfig_t launch_config(unsigned blocks, int depth, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr, int csize) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(32 * (depth < kMaxWarps ? depth : kMaxWarps));
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = csize > 1;  // C = 1 launches no cluster
  return cfg;
}

}  // namespace

// Shared memory one block needs, in bytes, for clusters of `csize` blocks
// (the wrapper checks it against the card's limit before launching).
extern "C" long long ngt_gather_ring_smem(int chunk, int depth, int f, int csize) {
  return (long long)smem_bytes(chunk, depth, f, csize);
}

// Clusters of `csize` blocks that can be resident at once on `device`
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
extern "C" int ngt_gather_ring_active_clusters(int chunk, int depth, int f, int csize,
                                               int device) {
  if (csize < 1 || csize > kMaxCluster || (csize & (csize - 1)))
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config((unsigned)csize, depth, (int)smem_bytes(chunk, depth, f, csize), 0, &attr, csize);
  cfg.numAttrs = 1;  // the query takes a cluster size, 1 included
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, gather_ring_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// Plain C entry point (bound with ctypes). x3 [n_blocks, 8, f] f32 and idx
// [nchunks * chunk] int32 (block ids) in device memory, x3 16-byte aligned;
// out [passes, nchunks, depth, 8, f] f32; 1 <= depth <= chunk; clusters of
// `csize` blocks, csize 1, 2, 4 or 8 dividing `passes`. Launches on `stream`,
// does not synchronise, and returns the first CUDA error of the set-up or
// the launch (0 = success).
extern "C" int ngt_gather_ring(const void* x3, const void* idx, void* out, int passes,
                               int nchunks, int chunk, int depth, int f, int csize, int device,
                               void* stream) {
  if (passes <= 0 || nchunks <= 0) return 0;
  if (csize < 1 || csize > kMaxCluster || (csize & (csize - 1)) || passes % csize)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config((unsigned)((long long)passes * nchunks), depth,
                    (int)smem_bytes(chunk, depth, f, csize), static_cast<cudaStream_t>(stream),
                    &attr, csize);
  err = cudaLaunchKernelEx(&cfg, gather_ring_kernel, static_cast<const float*>(x3),
                           static_cast<const int32_t*>(idx), static_cast<float*>(out), passes,
                           nchunks, chunk, depth, 8 * f);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
