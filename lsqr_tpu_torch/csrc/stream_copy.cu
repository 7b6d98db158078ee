// The streaming-ceiling probe for Hopper (sm_90a): x <- x * 1.0000001 in
// place, f32 (ops/roofline.py: stream_copy, stream_ceiling).
//
// Replaces bench.py: bench_roofline's stream_copy / _copy_kernel, the JAX
// package's measured streaming ceiling: a (1024, 2^18) f32 array in (16,
// 65536) VMEM blocks, input aliased to output, chained 20 times.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (8 bytes) for one multiply; at the default shape 2 GiB per call, so
// 0.641 ms at 3.35 TB/s.
//
// What the design does about it: the TPU grid of VMEM blocks becomes one
// block per 16 KB, each thread four 16-byte (float4) loads in flight before
// its four stores, neighbouring threads on neighbouring addresses, the
// shape of PyTorch's own elementwise kernel (a grid-stride loop with
// streaming cache hints was slower on the H100); a second small launch
// multiplies the last len % 4 floats (the pointer must be
// 16-byte aligned; the wrapper checks). The multiply is the same single f32
// rounding as the TPU kernel's and the plain version's, so all three agree
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // float4s a thread: a block covers 4096 floats
constexpr float kScale = 1.0000001f;

__global__ void __launch_bounds__(kThreads) stream_copy_kernel(float4* __restrict__ x4,
                                                               long long len4) {
  const long long base = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  float4 v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (base + k * kThreads < len4) v[k] = x4[base + k * kThreads];
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (base + k * kThreads < len4) {
      v[k].x *= kScale;
      v[k].y *= kScale;
      v[k].z *= kScale;
      v[k].w *= kScale;
      x4[base + k * kThreads] = v[k];
    }
  }
}

// the last len % 4 floats
__global__ void stream_copy_tail(float* __restrict__ x, long long from, long long len) {
  const long long i = from + threadIdx.x;
  if (i < len) x[i] *= kScale;
}

}  // namespace

extern "C" {

int lsqr_stream_copy_f32(void* x, long long len, void* stream) {
  const long long len4 = len / 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_block = static_cast<long long>(kThreads) * kUnroll;
  if (len4 > 0) {
    stream_copy_kernel<<<static_cast<unsigned>((len4 + per_block - 1) / per_block), kThreads, 0,
                         s>>>(static_cast<float4*>(x), len4);
  }
  if (len > 4 * len4) stream_copy_tail<<<1, 4, 0, s>>>(static_cast<float*>(x), 4 * len4, len);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
