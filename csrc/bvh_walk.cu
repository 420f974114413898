// CUDA BVH walk for XLA's foreign function interface (target rt_bvh_walk).
//
// One thread per ray; each thread walks the child-pair rows with its own
// stack in local memory (Aila & Laine, "Understanding the Efficiency of Ray
// Traversal on GPUs", 2009). Inputs and outputs are those of the XLA walk
// (tpu_raytracing/ops/traverse.py::_walk_xla): the kernel only tightens the
// incoming (t_best, best) of active rays and copies inactive ones through.
// No atomics: results are deterministic.
//
// Build: tpu_raytracing/ops/bvh_walk_cuda.py (or `make -C csrc cuda`).
#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#define RT_HD __host__ __device__
#include "bvh_walk.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 128;

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    walk_kernel(const float* __restrict__ rows, const float* __restrict__ tris,
                const float* __restrict__ origin,
                const float* __restrict__ direction,
                const float* __restrict__ t_min,
                const float* __restrict__ t_best_in,
                const int32_t* __restrict__ best_in,
                const bool* __restrict__ active, float* __restrict__ t_best_out,
                int32_t* __restrict__ best_out, int64_t n, int root) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  float t_best = t_best_in[i];
  int best = best_in[i];
  if (active[i] && root != rt::kDone && !(kAnyHit && best >= 0)) {
    const rt::Ray r =
        rt::make_ray(origin + 3 * i, direction + 3 * i, t_min[i]);
    rt::walk<kAnyHit>(rows, tris, root, r, t_best, best);
  }
  t_best_out[i] = t_best;
  best_out[i] = best;
}

ffi::Error WalkImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> rows,
                    ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> origin,
                    ffi::Buffer<ffi::F32> direction,
                    ffi::Buffer<ffi::F32> t_min, ffi::Buffer<ffi::F32> t_best,
                    ffi::Buffer<ffi::S32> best, ffi::Buffer<ffi::PRED> active,
                    ffi::ResultBuffer<ffi::F32> t_best_out,
                    ffi::ResultBuffer<ffi::S32> best_out, int32_t root,
                    bool any_hit) {
  const int64_t n = static_cast<int64_t>(t_min.element_count());
  if (rows.dimensions().size() != 2 || rows.dimensions()[1] != 16 ||
      tris.dimensions().size() != 2 || tris.dimensions()[1] != 9) {
    return ffi::Error::InvalidArgument(
        "rt_bvh_walk: rows must be (M, 16) and tris (T, 9)");
  }
  if (static_cast<int64_t>(origin.element_count()) != 3 * n ||
      static_cast<int64_t>(direction.element_count()) != 3 * n ||
      static_cast<int64_t>(t_best.element_count()) != n ||
      static_cast<int64_t>(best.element_count()) != n ||
      static_cast<int64_t>(active.element_count()) != n) {
    return ffi::Error::InvalidArgument(
        "rt_bvh_walk: ray arrays must be (B, 3) and (B,)");
  }
  if (n == 0) return ffi::Error::Success();
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  auto launch = any_hit ? walk_kernel<true> : walk_kernel<false>;
  launch<<<blocks, kBlock, 0, stream>>>(
      rows.typed_data(), tris.typed_data(), origin.typed_data(),
      direction.typed_data(), t_min.typed_data(), t_best.typed_data(),
      best.typed_data(), active.typed_data(), t_best_out->typed_data(),
      best_out->typed_data(), n, root);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("rt_bvh_walk launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RtBvhWalk, WalkImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()   // rows
                                  .Arg<ffi::Buffer<ffi::F32>>()   // tris
                                  .Arg<ffi::Buffer<ffi::F32>>()   // origin
                                  .Arg<ffi::Buffer<ffi::F32>>()   // direction
                                  .Arg<ffi::Buffer<ffi::F32>>()   // t_min
                                  .Arg<ffi::Buffer<ffi::F32>>()   // t_best
                                  .Arg<ffi::Buffer<ffi::S32>>()   // best
                                  .Arg<ffi::Buffer<ffi::PRED>>()  // active
                                  .Ret<ffi::Buffer<ffi::F32>>()   // t_best
                                  .Ret<ffi::Buffer<ffi::S32>>()   // best
                                  .Attr<int32_t>("root")
                                  .Attr<bool>("any_hit"));
