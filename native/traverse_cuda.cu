// CUDA build of the traversal kernel (traverse.h): one thread per ray,
// each with its own stack, every instance looped inside the thread — the
// reference's render megakernel design (raycast.cu:21-142). The handler
// only enqueues the kernel on XLA's stream.
#include <cuda_runtime.h>

#include "traverse_ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
    traverse_kernel(trt::Call c) {
  int64_t r = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (r >= c.num_rays) return;
  trt::trace(c.tables, c.org, c.dir, r, c.mode, c.t, c.tri, c.inst, c.u, c.v,
             c.n);
}

}  // namespace

static ffi::Error TraverseCuda(
    cudaStream_t stream, ffi::Buffer<ffi::S32> nodes,
    ffi::Buffer<ffi::F32> tris, ffi::Buffer<ffi::F32> inst,
    ffi::Buffer<ffi::S32> inst_root, ffi::Buffer<ffi::F32> org,
    ffi::Buffer<ffi::F32> dir, ffi::ResultBuffer<ffi::F32> t,
    ffi::ResultBuffer<ffi::S32> tri, ffi::ResultBuffer<ffi::S32> hit_inst,
    ffi::ResultBuffer<ffi::F32> u, ffi::ResultBuffer<ffi::F32> v,
    ffi::ResultBuffer<ffi::F32> n, int32_t mode) {
  trt::Call c;
  ffi::Error err = trt::make_call(nodes, tris, inst, inst_root, org, dir, t,
                                  tri, hit_inst, u, v, n, mode, c);
  if (!err.success()) return err;
  if (c.num_rays == 0) return ffi::Error::Success();
  int64_t blocks = (c.num_rays + kBlock - 1) / kBlock;
  traverse_kernel<<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(c);
  cudaError_t launch = cudaGetLastError();
  if (launch != cudaSuccess) {
    return ffi::Error::Internal(std::string("trt_traverse launch: ") +
                                cudaGetErrorString(launch));
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    TrtTraverseCuda, TraverseCuda,
    TRT_TRAVERSE_BINDING(ffi::Ffi::Bind().Ctx<ffi::PlatformStream<cudaStream_t>>()));
