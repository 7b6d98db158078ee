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
// block per kThreads float4s, each thread one 16-byte (float4) load and
// store, neighbouring threads on neighbouring addresses; a second small
// launch multiplies the last len % 4 floats (the pointer must be 16-byte
// aligned; the wrapper checks). Of the launch shapes that
// tools/stream_copy_designs.py builds and times against x.mul_, PyTorch's
// vectorized elementwise kernel (128 threads, two float4 a thread), blocks
// of 1024 threads with one float4 a thread were the fastest on the H100:
// ~0.7% under x.mul_, where four float4 a thread in 256-thread blocks
// trailed it by ~0.6%; streaming cache hints and a reversed block order
// were slower (PERF.md). The multiply is the same single f32 rounding as
// the TPU kernel's, the plain version's and x.mul_'s, so all agree bit for
// bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kScale = 1.0000001f;

__global__ void __launch_bounds__(kThreads) stream_copy_kernel(float4* __restrict__ x4,
                                                               long long len4) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < len4) {
    float4 v = x4[i];
    v.x *= kScale;
    v.y *= kScale;
    v.z *= kScale;
    v.w *= kScale;
    x4[i] = v;
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
  if (len4 > 0) {
    stream_copy_kernel<<<static_cast<unsigned>((len4 + kThreads - 1) / kThreads), kThreads, 0,
                         s>>>(static_cast<float4*>(x), len4);
  }
  if (len > 4 * len4) stream_copy_tail<<<1, 4, 0, s>>>(static_cast<float*>(x), 4 * len4, len);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
