// XLA FFI binding of the traversal, shared by the CUDA and host handlers:
// argument checks and the handler signature. Each handler supplies only
// how the rays are launched.
#pragma once

#include <string>

#include "traverse.h"
#include "xla/ffi/api/ffi.h"

namespace trt {

namespace ffi = xla::ffi;

struct Call {
  Tables tables;
  const float* org;
  const float* dir;
  int64_t num_rays;
  int mode;
  float* t;
  int32_t* tri;
  int32_t* inst;
  float* u;
  float* v;
  float* n;
};

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Validates the buffers of one call and gathers their pointers.
inline ffi::Error make_call(
    ffi::Buffer<ffi::S32> nodes, ffi::Buffer<ffi::F32> tris,
    ffi::Buffer<ffi::F32> inst, ffi::Buffer<ffi::S32> inst_root,
    ffi::Buffer<ffi::F32> org, ffi::Buffer<ffi::F32> dir,
    ffi::ResultBuffer<ffi::F32> t, ffi::ResultBuffer<ffi::S32> tri,
    ffi::ResultBuffer<ffi::S32> hit_inst, ffi::ResultBuffer<ffi::F32> u,
    ffi::ResultBuffer<ffi::F32> v, ffi::ResultBuffer<ffi::F32> n,
    int32_t mode, Call& call) {
  if (nodes.element_count() % 16 != 0 || tris.element_count() % 12 != 0 ||
      inst.element_count() != 10 * inst_root.element_count()) {
    return ffi::Error::InvalidArgument(
        "trt_traverse: nodes must be [N, 16], tris [T, 12], inst [I, 10]");
  }
  int64_t rays = static_cast<int64_t>(dir.element_count()) / 3;
  if (static_cast<int64_t>(org.element_count()) != 3 * rays ||
      static_cast<int64_t>(t->element_count()) != rays ||
      static_cast<int64_t>(tri->element_count()) != rays ||
      static_cast<int64_t>(hit_inst->element_count()) != rays) {
    return ffi::Error::InvalidArgument(
        "trt_traverse: origins, directions and hit outputs disagree on the "
        "ray count");
  }
  int64_t attr_rays = (mode & kWantAttrs) ? rays : 0;
  if (static_cast<int64_t>(u->element_count()) != attr_rays ||
      static_cast<int64_t>(v->element_count()) != attr_rays ||
      static_cast<int64_t>(n->element_count()) != 3 * attr_rays) {
    return ffi::Error::InvalidArgument(
        "trt_traverse: u/v/n outputs must hold one record per ray exactly "
        "when attributes are requested");
  }
  if (!aligned16(nodes.untyped_data()) || !aligned16(tris.untyped_data())) {
    return ffi::Error::InvalidArgument(
        "trt_traverse: node and triangle tables must be 16-byte aligned");
  }
  call.tables = {nodes.typed_data(), tris.typed_data(), inst.typed_data(),
                 inst_root.typed_data(),
                 static_cast<int32_t>(inst_root.element_count())};
  call.org = org.typed_data();
  call.dir = dir.typed_data();
  call.num_rays = rays;
  call.mode = mode;
  call.t = t->typed_data();
  call.tri = tri->typed_data();
  call.inst = hit_inst->typed_data();
  call.u = u->typed_data();
  call.v = v->typed_data();
  call.n = n->typed_data();
  return ffi::Error::Success();
}

}  // namespace trt

// Argument list of both handlers, in ffi_call order.
#define TRT_TRAVERSE_BINDING(ctx)                    \
  ctx.Arg<xla::ffi::Buffer<xla::ffi::S32>>()         \
      .Arg<xla::ffi::Buffer<xla::ffi::F32>>()        \
      .Arg<xla::ffi::Buffer<xla::ffi::F32>>()        \
      .Arg<xla::ffi::Buffer<xla::ffi::S32>>()        \
      .Arg<xla::ffi::Buffer<xla::ffi::F32>>()        \
      .Arg<xla::ffi::Buffer<xla::ffi::F32>>()        \
      .Ret<xla::ffi::Buffer<xla::ffi::F32>>()        \
      .Ret<xla::ffi::Buffer<xla::ffi::S32>>()        \
      .Ret<xla::ffi::Buffer<xla::ffi::S32>>()        \
      .Ret<xla::ffi::Buffer<xla::ffi::F32>>()        \
      .Ret<xla::ffi::Buffer<xla::ffi::F32>>()        \
      .Ret<xla::ffi::Buffer<xla::ffi::F32>>()        \
      .Attr<int32_t>("mode")
