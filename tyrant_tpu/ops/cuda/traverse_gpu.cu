// CUDA kernels for closest-hit and any-hit BVH traversal, bound as XLA FFI
// handlers (tyrant_closest_hit / tyrant_any_hit on the CUDA platform).
//
// One thread per ray (kernel.cu:331-343 extend, 630-646 connect), launched
// like the reference's kernels: 128 threads a block, __launch_bounds__(128, 8).
// A plain grid: persistent threads claiming rays from an atomic counter (the
// reference's work stealing, kernel.cu:211-224) measured no faster on the
// H100 (PERF.md).  The traversal itself is traverse.h, shared with the host
// build.
//
// Build (ops/cuda/__init__.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I<jax.ffi.include_dir()> traverse_gpu.cu

#include <cuda_runtime.h>

#include "traverse.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 128;

__global__ __launch_bounds__(kBlock, 8) void closest_kernel(
    tyrant::Bvh bvh, const float* origin, const float* direction,
    const float* t_init, int64_t n, float* t_out, int32_t* id_out) {
  int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tyrant::Ray r = tyrant::make_ray(origin, direction, i);
  float t;
  int id;
  tyrant::closest_hit(bvh, r, t_init[i], &t, &id);
  t_out[i] = t;
  id_out[i] = id;
}

__global__ __launch_bounds__(kBlock, 8) void any_kernel(
    tyrant::Bvh bvh, const float* origin, const float* direction,
    const float* max_dist, const bool* active, int64_t n, bool* occluded) {
  int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  tyrant::Ray r = tyrant::make_ray(origin, direction, i);
  occluded[i] = tyrant::any_hit(bvh, r, max_dist[i], active[i]);
}

tyrant::Bvh make_bvh(ffi::Buffer<ffi::F32>& nodes,
                     ffi::Buffer<ffi::S32>& miss,
                     ffi::Buffer<ffi::F32>& leaves) {
  return {nodes.typed_data(), miss.typed_data(), leaves.typed_data(),
          int(nodes.dimensions()[0])};
}

int64_t n_blocks(int64_t n) { return (n + kBlock - 1) / kBlock; }

ffi::Error launched() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error closest_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> origin,
                        ffi::Buffer<ffi::F32> direction,
                        ffi::Buffer<ffi::F32> t_init,
                        ffi::Buffer<ffi::F32> nodes,
                        ffi::Buffer<ffi::S32> miss,
                        ffi::Buffer<ffi::F32> leaves,
                        ffi::ResultBuffer<ffi::F32> t_out,
                        ffi::ResultBuffer<ffi::S32> id_out) {
  int64_t n = t_init.element_count();
  if (n == 0) return ffi::Error::Success();
  closest_kernel<<<n_blocks(n), kBlock, 0, stream>>>(
      make_bvh(nodes, miss, leaves), origin.typed_data(),
      direction.typed_data(), t_init.typed_data(), n, t_out->typed_data(),
      id_out->typed_data());
  return launched();
}

ffi::Error any_impl(cudaStream_t stream, ffi::Buffer<ffi::F32> origin,
                    ffi::Buffer<ffi::F32> direction,
                    ffi::Buffer<ffi::F32> max_dist,
                    ffi::Buffer<ffi::PRED> active,
                    ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::S32> miss,
                    ffi::Buffer<ffi::F32> leaves,
                    ffi::ResultBuffer<ffi::PRED> occluded) {
  int64_t n = max_dist.element_count();
  if (n == 0) return ffi::Error::Success();
  any_kernel<<<n_blocks(n), kBlock, 0, stream>>>(
      make_bvh(nodes, miss, leaves), origin.typed_data(),
      direction.typed_data(), max_dist.typed_data(), active.typed_data(), n,
      occluded->typed_data());
  return launched();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TyrantClosestHit, closest_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(TyrantAnyHit, any_impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::PRED>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::PRED>>());
