// Four consecutive elements of T as one 16-byte access (two for double):
// shared-memory tiles of K3 (value_mo.cu) and the AO buffer of K7
// (pbc_sweep.cu). The address is 16-byte aligned.
#pragma once

#include <cuda_runtime.h>

namespace pq {

template <typename T>
__device__ __forceinline__ void ld4(const T* p, T* r) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
  } else {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    r[0] = a.x, r[1] = a.y, r[2] = b.x, r[3] = b.y;
  }
}

template <typename T>
__device__ __forceinline__ void st4(T* p, T a, T b, T c, T d) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(a, b);
    reinterpret_cast<double2*>(p)[1] = make_double2(c, d);
  }
}

}  // namespace pq
