// Host build of traverse.h, bound as XLA FFI handlers for the CPU platform
// under the same target names as the CUDA kernels.  It exists so that the CPU
// tests run the kernels' traversal code and their Python wrapper; rendering
// on a CPU uses the XLA cascade (ops/traverse.py).
//
// Build (ops/cuda/__init__.py does this at first use):
//   g++ -std=c++17 -O2 -shared -fPIC -I<jax.ffi.include_dir()> traverse_cpu.cc

#include "traverse.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

tyrant::Bvh make_bvh(ffi::Buffer<ffi::F32>& nodes,
                     ffi::Buffer<ffi::S32>& miss,
                     ffi::Buffer<ffi::F32>& leaves) {
  return {nodes.typed_data(), miss.typed_data(), leaves.typed_data(),
          int(nodes.dimensions()[0])};
}

ffi::Error closest_impl(ffi::Buffer<ffi::F32> origin,
                        ffi::Buffer<ffi::F32> direction,
                        ffi::Buffer<ffi::F32> t_init,
                        ffi::Buffer<ffi::F32> nodes,
                        ffi::Buffer<ffi::S32> miss,
                        ffi::Buffer<ffi::F32> leaves,
                        ffi::ResultBuffer<ffi::F32> t_out,
                        ffi::ResultBuffer<ffi::S32> id_out) {
  tyrant::Bvh bvh = make_bvh(nodes, miss, leaves);
  int64_t n = t_init.element_count();
  for (int64_t i = 0; i < n; ++i) {
    tyrant::Ray r = tyrant::make_ray(origin.typed_data(),
                                     direction.typed_data(), i);
    int id;
    tyrant::closest_hit(bvh, r, t_init.typed_data()[i],
                        t_out->typed_data() + i, &id);
    id_out->typed_data()[i] = id;
  }
  return ffi::Error::Success();
}

ffi::Error any_impl(ffi::Buffer<ffi::F32> origin,
                    ffi::Buffer<ffi::F32> direction,
                    ffi::Buffer<ffi::F32> max_dist,
                    ffi::Buffer<ffi::PRED> active,
                    ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::S32> miss,
                    ffi::Buffer<ffi::F32> leaves,
                    ffi::ResultBuffer<ffi::PRED> occluded) {
  tyrant::Bvh bvh = make_bvh(nodes, miss, leaves);
  int64_t n = max_dist.element_count();
  for (int64_t i = 0; i < n; ++i) {
    tyrant::Ray r = tyrant::make_ray(origin.typed_data(),
                                     direction.typed_data(), i);
    occluded->typed_data()[i] = tyrant::any_hit(
        bvh, r, max_dist.typed_data()[i], active.typed_data()[i]);
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TyrantClosestHit, closest_impl,
                              ffi::Ffi::Bind()
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
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::PRED>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::PRED>>());
