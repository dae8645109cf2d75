// Kernel 3: value-only AOs contracted with a coefficient matrix, one thread
// per point, in the kernel's own body.
//
// Replaces pyqmc_tpu/ops/gto_pallas.py:build_pallas_value_mo (wrappers
// fused_value_mo_t and fused_value_mo). out[j, m] = sum_a AO_a(X_m) C[a, j],
// with C in concat row order (the order the AOs are visited: l-group,
// shell, m), written as (norb, M) so that neighbouring threads write
// neighbouring addresses. No AO array is stored: each shell's values are
// folded into NC register accumulators as soon as they are computed.
//
// What bounds it: operations. Per point the contraction is nao * norb
// multiply-adds (489 x 64 on the diamond supercell's replicated-shell
// basis) against about 5 exps per shell; the inputs are 12 bytes a point
// and the output 4 norb. C is staged in shared memory where it fits (f32:
// 125 KB at 489 x 64), so every thread of a warp reads the same C entry
// (a broadcast); otherwise it is read through L1/L2. More than NC = 64
// orbitals are done in passes of 64, each evaluating the AOs again.
#include <cuda_runtime.h>

#include "ao_shell.cuh"

namespace pq {

constexpr int VMO_THREADS = 256;

// acc[j] += sum over the group's AOs a of AO_a(x, y, z) C[a, c0 + j]
template <typename T, int L, int NC>
__device__ __forceinline__ void contract_group(const T* tab, const int* grp, T x, T y, T z,
                                               const T* C, int norb, int c0, T* acc) {
  constexpr int NS = 2 * L + 1;
  const int S = grp[G_S], row0 = grp[G_ROW];
  for (int si = 0; si < S; ++si) {
    T val[NS];
    shell_one<T, L, 0>(tab, grp, si, x, y, z, val, nullptr, nullptr, nullptr, nullptr);
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const T v = val[q];
      const T* crow = C + (size_t)(row0 + si * NS + q) * norb + c0;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        if (c0 + j < norb) acc[j] += v * crow[j];
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(VMO_THREADS)
    value_mo_kernel(const T* __restrict__ X, const T* __restrict__ C_g, T* __restrict__ out,
                    const T* __restrict__ tab_g, int ntab, const int* __restrict__ meta_g,
                    int nmeta, int M, int norb, int c_in_smem) {
  T* tab;
  int* meta;
  unsigned char* rest = stage_tables<T>(tab_g, ntab, meta_g, nmeta, &tab, &meta);
  __syncthreads();
  const T* C = C_g;
  if (c_in_smem) {
    T* cs = reinterpret_cast<T*>(rest);
    const int nc = meta[T_NAO] * norb;
    for (int i = threadIdx.x; i < nc; i += blockDim.x) cs[i] = C_g[i];
    C = cs;
  }
  __syncthreads();
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const T x = X[3 * (size_t)m], y = X[3 * (size_t)m + 1], z = X[3 * (size_t)m + 2];
  const int ngroups = meta[T_NGROUPS];
  const int* groups = meta + meta[T_I_GROUPS];
  for (int c0 = 0; c0 < norb; c0 += NC) {
    T acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[j] = T(0);
    for (int gi = 0; gi < ngroups; ++gi) {
      const int* grp = groups + gi * GROUP_INTS;
      switch (grp[G_L]) {
        case 0: contract_group<T, 0, NC>(tab, grp, x, y, z, C, norb, c0, acc); break;
        case 1: contract_group<T, 1, NC>(tab, grp, x, y, z, C, norb, c0, acc); break;
        case 2: contract_group<T, 2, NC>(tab, grp, x, y, z, C, norb, c0, acc); break;
        default: contract_group<T, 3, NC>(tab, grp, x, y, z, C, norb, c0, acc); break;
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (c0 + j < norb) out[(size_t)(c0 + j) * M + m] = acc[j];
  }
}

template <typename T, int NC>
int launch_value_mo_nc(const T* X, const T* C, T* out, const T* tab, int ntab, const int* meta,
                       int nmeta, int M, int norb, int nao, cudaStream_t stream) {
  const size_t base = tables_bytes(ntab, nmeta, sizeof(T));
  const size_t cbytes = (size_t)nao * norb * sizeof(T);
  const int c_in_smem = base + cbytes <= 200 * 1024 ? 1 : 0;
  const size_t smem = base + (c_in_smem ? cbytes : 0);
  cudaError_t err = cudaFuncSetAttribute(value_mo_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + VMO_THREADS - 1) / VMO_THREADS;
  value_mo_kernel<T, NC><<<blocks, VMO_THREADS, smem, stream>>>(X, C, out, tab, ntab, meta,
                                                                 nmeta, M, norb, c_in_smem);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_value_mo(const T* X, const T* C, T* out, const T* tab, int ntab, const int* meta,
                    int nmeta, int M, int norb, int nao, cudaStream_t stream) {
  if (norb <= 8)
    return launch_value_mo_nc<T, 8>(X, C, out, tab, ntab, meta, nmeta, M, norb, nao, stream);
  if (norb <= 32)
    return launch_value_mo_nc<T, 32>(X, C, out, tab, ntab, meta, nmeta, M, norb, nao, stream);
  return launch_value_mo_nc<T, 64>(X, C, out, tab, ntab, meta, nmeta, M, norb, nao, stream);
}

}  // namespace pq

extern "C" {

int pq_value_mo_f32(const void* X, const void* C, void* out, const void* tab, int ntab,
                    const void* meta, int nmeta, int M, int norb, int nao, void* stream) {
  return pq::launch_value_mo<float>((const float*)X, (const float*)C, (float*)out,
                                    (const float*)tab, ntab, (const int*)meta, nmeta, M, norb,
                                    nao, (cudaStream_t)stream);
}

int pq_value_mo_f64(const void* X, const void* C, void* out, const void* tab, int ntab,
                    const void* meta, int nmeta, int M, int norb, int nao, void* stream) {
  return pq::launch_value_mo<double>((const double*)X, (const double*)C, (double*)out,
                                     (const double*)tab, ntab, (const int*)meta, nmeta, M, norb,
                                     nao, (cudaStream_t)stream);
}

}  // extern "C"
