// Host build of the traversal kernel (traverse.h), registered as a CPU
// FFI target so the CPU test suite runs the kernel's own code against
// the brute-force oracle. One thread walks the rays in order.
#include "traverse_ffi.h"

namespace ffi = xla::ffi;

static ffi::Error TraverseCpu(
    ffi::Buffer<ffi::S32> nodes, ffi::Buffer<ffi::F32> tris,
    ffi::Buffer<ffi::F32> inst, ffi::Buffer<ffi::S32> inst_root,
    ffi::Buffer<ffi::F32> org, ffi::Buffer<ffi::F32> dir,
    ffi::ResultBuffer<ffi::F32> t, ffi::ResultBuffer<ffi::S32> tri,
    ffi::ResultBuffer<ffi::S32> hit_inst, ffi::ResultBuffer<ffi::F32> u,
    ffi::ResultBuffer<ffi::F32> v, ffi::ResultBuffer<ffi::F32> n,
    int32_t mode) {
  trt::Call c;
  ffi::Error err = trt::make_call(nodes, tris, inst, inst_root, org, dir, t,
                                  tri, hit_inst, u, v, n, mode, c);
  if (!err.success()) return err;
  for (int64_t r = 0; r < c.num_rays; ++r) {
    trt::trace(c.tables, c.org, c.dir, r, c.mode, c.t, c.tri, c.inst, c.u,
               c.v, c.n);
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(TrtTraverseCpu, TraverseCpu,
                              TRT_TRAVERSE_BINDING(ffi::Ffi::Bind()));
