// One shell's spherical AOs at one point, for the kernels that evaluate
// the basis shell by shell: K3 (value_mo.cu, values), K6 (gto_eval.cu,
// values, gradients and laplacians) and K7 (pbc_sweep.cu, values and
// gradients, one shell per lane of a warp).
//
// For f = P(x, y, z) g(r^2), P a degree-l monomial and
// g = sum_p c_p exp(-a_p r^2), with g_k = sum_p c_p a_p^k exp(-a_p r^2):
//   grad f = (grad P) g0 - 2 P g1 r
//   lap  f = (lap P) g0 - (4 l + 6) P g1 + 4 P g2 r^2        (ops/gto.py)
// The cartesian monomials (lx from l down, then ly) are mapped to the 2l+1
// spherical AOs with the group's cart->sph weights.
//
// Tables. A float table `tab` and an int table `meta`; the l-groups are laid
// out as in sj_device.cuh (GroupSlot). K3 and K6 read the header below
// (pyqmc_tpu_torch/ops/gto_kernels.py:GTOTables writes it); K7 has its own
// header (pbc_sweep.cu) over the same group records.
#pragma once

#include "sj_device.cuh"

namespace pq {

enum GtoSlot { T_NAO = 0, T_NGROUPS, T_I_GROUPS, T_I_AOROW, T_HEADER };

// MODE 0: values; 1: values and gradients; 2: values, gradients, laplacians.
template <typename T, int L, int MODE>
__device__ __forceinline__ void shell_one(const T* tab, const int* grp, int si, T x, T y, T z,
                                          T* val, T* gx, T* gy, T* gz, T* lap) {
  constexpr int NS = 2 * L + 1;
  const int P = grp[G_P];
  const T* cen = tab + grp[G_F_CEN] + 3 * si;
  const T* alpha = tab + grp[G_F_ALPHA] + si * P;
  const T* coef = tab + grp[G_F_COEF] + si * P;
  const T* cw = tab + grp[G_F_CW];
  const T rx = x - cen[0], ry = y - cen[1], rz = z - cen[2];
  const T r2 = rx * rx + ry * ry + rz * rz;
  T g0 = T(0), g1 = T(0), g2 = T(0);
  for (int p = 0; p < P; ++p) {
    const T a = alpha[p];
    const T ep = coef[p] * dexp(-a * r2);
    g0 += ep;
    if (MODE >= 1) g1 += a * ep;
    if (MODE >= 2) g2 += a * a * ep;
  }
  T px[L + 1], py[L + 1], pz[L + 1];
  px[0] = py[0] = pz[0] = T(1);
#pragma unroll
  for (int k = 1; k <= L; ++k) {
    px[k] = px[k - 1] * rx;
    py[k] = py[k - 1] * ry;
    pz[k] = pz[k - 1] * rz;
  }
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    val[q] = T(0);
    if (MODE >= 1) gx[q] = gy[q] = gz[q] = T(0);
    if (MODE >= 2) lap[q] = T(0);
  }
  int c = 0;
#pragma unroll
  for (int i = L; i >= 0; --i) {
#pragma unroll
    for (int j = L - i; j >= 0; --j) {
      const int k = L - i - j;
      const T Pm = px[i] * py[j] * pz[k];
      const T vt = Pm * g0;
      T gtx = T(0), gty = T(0), gtz = T(0), lt = T(0);
      if (MODE >= 1) {
        const T m2g1 = T(-2) * Pm * g1;
        gtx = m2g1 * rx + (i > 0 ? T(i) * px[i > 0 ? i - 1 : 0] * py[j] * pz[k] * g0 : T(0));
        gty = m2g1 * ry + (j > 0 ? T(j) * px[i] * py[j > 0 ? j - 1 : 0] * pz[k] * g0 : T(0));
        gtz = m2g1 * rz + (k > 0 ? T(k) * px[i] * py[j] * pz[k > 0 ? k - 1 : 0] * g0 : T(0));
      }
      if (MODE >= 2) {
        T lapP = T(0);
        if (i >= 2) lapP += T(i * (i - 1)) * px[i >= 2 ? i - 2 : 0] * py[j] * pz[k];
        if (j >= 2) lapP += T(j * (j - 1)) * px[i] * py[j >= 2 ? j - 2 : 0] * pz[k];
        if (k >= 2) lapP += T(k * (k - 1)) * px[i] * py[j] * pz[k >= 2 ? k - 2 : 0];
        lt = lapP * g0 - T(4 * L + 6) * Pm * g1 + T(4) * Pm * g2 * r2;
      }
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const T w = cw[c * NS + q];
        val[q] += w * vt;
        if (MODE >= 1) {
          gx[q] += w * gtx;
          gy[q] += w * gty;
          gz[q] += w * gtz;
        }
        if (MODE >= 2) lap[q] += w * lt;
      }
      ++c;
    }
  }
}

// Copy a float table and an int table into dynamic shared memory (the
// float table first, aligned for T; the ints after it). Returns the first
// byte past them, 16-byte aligned, for the caller's own buffers. The caller
// synchronises the block before reading them.
template <typename T>
__device__ __forceinline__ unsigned char* stage_tables(const T* __restrict__ tab_g, int ntab,
                                                       const int* __restrict__ meta_g, int nmeta,
                                                       T** tab, int** meta) {
  extern __shared__ __align__(16) unsigned char pq_smem[];
  T* t = reinterpret_cast<T*>(pq_smem);
  int* m = reinterpret_cast<int*>(t + ntab);
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) t[i] = tab_g[i];
  for (int i = threadIdx.x; i < nmeta; i += blockDim.x) m[i] = meta_g[i];
  *tab = t;
  *meta = m;
  const size_t used = (size_t)ntab * sizeof(T) + (size_t)nmeta * sizeof(int);
  return pq_smem + ((used + 15) / 16) * 16;
}

__host__ __device__ inline size_t tables_bytes(int ntab, int nmeta, size_t tsize) {
  return ((ntab * tsize + (size_t)nmeta * sizeof(int) + 15) / 16) * 16;
}

}  // namespace pq
