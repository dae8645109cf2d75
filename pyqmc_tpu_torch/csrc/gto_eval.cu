// Kernel 6: AO values, gradients and laplacians at many points, one thread
// per point.
//
// Replaces pyqmc_tpu/ops/gto_pallas.py:build_pallas_evaluator (wrapper
// fused_eval_gto2). The outputs are written transposed, ao (nao, M),
// grad (3 nao, M) with row ax * nao + a, and lap (nao, M), in AO order
// (the concat row r of a shell's AO goes to row aorow[r]), so neighbouring
// threads write neighbouring addresses; the wrapper hands them back as
// transposed views (pyqmc_tpu_torch/ops/gto_kernels.py:EvalGTO2).
//
// What bounds it: bytes. Each point writes 5 nao values (9.8 KB at the
// diamond supercell's 489 AOs in f32) against about 5 exps and 60 flops
// per shell; the tables sit in shared memory.
#include <cuda_runtime.h>

#include "ao_shell.cuh"

namespace pq {

constexpr int GTO_THREADS = 128;

// one l-group's AOs at point m, written to their AO rows
template <typename T, int L>
__device__ __forceinline__ void write_group(const T* tab, const int* grp, const int* aorow, T x,
                                            T y, T z, T* ao, T* grad, T* lap, int nao, int M,
                                            int m) {
  constexpr int NS = 2 * L + 1;
  const int S = grp[G_S], row0 = grp[G_ROW];
  const size_t sM = (size_t)M;
  for (int si = 0; si < S; ++si) {
    T v[NS], gx[NS], gy[NS], gz[NS], lp[NS];
    shell_one<T, L, 2>(tab, grp, si, x, y, z, v, gx, gy, gz, lp);
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const size_t r = (size_t)aorow[row0 + si * NS + q];
      ao[r * sM + m] = v[q];
      grad[r * sM + m] = gx[q];
      grad[(r + nao) * sM + m] = gy[q];
      grad[(r + 2 * (size_t)nao) * sM + m] = gz[q];
      lap[r * sM + m] = lp[q];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(GTO_THREADS)
    gto_eval_kernel(const T* __restrict__ X, T* __restrict__ ao, T* __restrict__ grad,
                    T* __restrict__ lap, const T* __restrict__ tab_g, int ntab,
                    const int* __restrict__ meta_g, int nmeta, int M) {
  T* tab;
  int* meta;
  stage_tables<T>(tab_g, ntab, meta_g, nmeta, &tab, &meta);
  __syncthreads();
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const T x = X[3 * (size_t)m], y = X[3 * (size_t)m + 1], z = X[3 * (size_t)m + 2];
  const int nao = meta[T_NAO], ngroups = meta[T_NGROUPS];
  const int* groups = meta + meta[T_I_GROUPS];
  const int* aorow = meta + meta[T_I_AOROW];
  for (int gi = 0; gi < ngroups; ++gi) {
    const int* grp = groups + gi * GROUP_INTS;
    switch (grp[G_L]) {
      case 0: write_group<T, 0>(tab, grp, aorow, x, y, z, ao, grad, lap, nao, M, m); break;
      case 1: write_group<T, 1>(tab, grp, aorow, x, y, z, ao, grad, lap, nao, M, m); break;
      case 2: write_group<T, 2>(tab, grp, aorow, x, y, z, ao, grad, lap, nao, M, m); break;
      default: write_group<T, 3>(tab, grp, aorow, x, y, z, ao, grad, lap, nao, M, m); break;
    }
  }
}

template <typename T>
int launch_gto_eval(const T* X, T* ao, T* grad, T* lap, const T* tab, int ntab, const int* meta,
                    int nmeta, int M, cudaStream_t stream) {
  const size_t smem = tables_bytes(ntab, nmeta, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(gto_eval_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + GTO_THREADS - 1) / GTO_THREADS;
  gto_eval_kernel<T><<<blocks, GTO_THREADS, smem, stream>>>(X, ao, grad, lap, tab, ntab, meta,
                                                            nmeta, M);
  return (int)cudaGetLastError();
}

}  // namespace pq

extern "C" {

int pq_gto_eval_f32(const void* X, void* ao, void* grad, void* lap, const void* tab, int ntab,
                    const void* meta, int nmeta, int M, void* stream) {
  return pq::launch_gto_eval<float>((const float*)X, (float*)ao, (float*)grad, (float*)lap,
                                    (const float*)tab, ntab, (const int*)meta, nmeta, M,
                                    (cudaStream_t)stream);
}

int pq_gto_eval_f64(const void* X, void* ao, void* grad, void* lap, const void* tab, int ntab,
                    const void* meta, int nmeta, int M, void* stream) {
  return pq::launch_gto_eval<double>((const double*)X, (double*)ao, (double*)grad, (double*)lap,
                                     (const double*)tab, ntab, (const int*)meta, nmeta, M,
                                     (cudaStream_t)stream);
}

}  // extern "C"
