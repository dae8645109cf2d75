// AO value and value+gradient device functions: the counterparts of
// _emit_ao_valgrad and _emit_ao_val in pyqmc_tpu/ops/move_pallas.py, for one
// point per thread instead of a (3, T) tile of points.
//
// For f = P(x, y, z) g(r^2), P a degree-l monomial and
// g = sum_p c_p exp(-a_p r^2):  grad f = (grad P) g0 - 2 P g1 r,
// with g_k = sum_p c_p a_p^k exp(-a_p r^2) (ops/gto.py). The cartesian
// monomials are mapped to 2l+1 spherical AOs with the cart->sph weights of
// the group. AOs are visited in concat order (l-group, shell, m) and handed
// to a functor sink(row, value, gx, gy, gz); callers contract them on the fly
// so no AO array is stored.
#pragma once

#include "sj_device.cuh"

namespace pq {

template <typename T, int L, bool GRAD, typename Sink>
__device__ __forceinline__ void shell_group(const T* tab, const int* grp, T x, T y, T z,
                                            Sink& sink) {
  constexpr int NS = 2 * L + 1;
  constexpr int NC = (L + 1) * (L + 2) / 2;
  const int S = grp[G_S], P = grp[G_P];
  const T* cen = tab + grp[G_F_CEN];
  const T* alpha = tab + grp[G_F_ALPHA];
  const T* coef = tab + grp[G_F_COEF];
  const T* cw = tab + grp[G_F_CW];
  const int row0 = grp[G_ROW];
  for (int si = 0; si < S; ++si) {
    const T rx = x - cen[3 * si], ry = y - cen[3 * si + 1], rz = z - cen[3 * si + 2];
    const T r2 = rx * rx + ry * ry + rz * rz;
    T g0 = T(0), g1 = T(0);
    for (int p = 0; p < P; ++p) {
      const T a = alpha[si * P + p];
      const T ep = coef[si * P + p] * dexp(-a * r2);
      g0 += ep;
      if (GRAD) g1 += a * ep;
    }
    T px[L + 1], py[L + 1], pz[L + 1];
    px[0] = py[0] = pz[0] = T(1);
#pragma unroll
    for (int k = 1; k <= L; ++k) {
      px[k] = px[k - 1] * rx;
      py[k] = py[k - 1] * ry;
      pz[k] = pz[k - 1] * rz;
    }
    T val[NS], gx[NS], gy[NS], gz[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) val[q] = gx[q] = gy[q] = gz[q] = T(0);
    int c = 0;
#pragma unroll
    for (int i = L; i >= 0; --i) {
#pragma unroll
      for (int j = L - i; j >= 0; --j) {
        const int k = L - i - j;
        const T Pm = px[i] * py[j] * pz[k];
        const T vt = Pm * g0;
        T gtx = T(0), gty = T(0), gtz = T(0);
        if (GRAD) {
          const T m2g1 = T(-2) * Pm * g1;
          gtx = m2g1 * rx + (i > 0 ? T(i) * px[i > 0 ? i - 1 : 0] * py[j] * pz[k] * g0 : T(0));
          gty = m2g1 * ry + (j > 0 ? T(j) * px[i] * py[j > 0 ? j - 1 : 0] * pz[k] * g0 : T(0));
          gtz = m2g1 * rz + (k > 0 ? T(k) * px[i] * py[j] * pz[k > 0 ? k - 1 : 0] * g0 : T(0));
        }
#pragma unroll
        for (int q = 0; q < NS; ++q) {
          const T w = cw[c * NS + q];
          val[q] += w * vt;
          if (GRAD) {
            gx[q] += w * gtx;
            gy[q] += w * gty;
            gz[q] += w * gtz;
          }
        }
        ++c;
      }
    }
    (void)NC;
#pragma unroll
    for (int q = 0; q < NS; ++q) sink(row0 + si * NS + q, val[q], gx[q], gy[q], gz[q]);
  }
}

// Visit every AO at (x, y, z) in concat order.
template <typename T, bool GRAD, typename Sink>
__device__ __forceinline__ void ao_eval(const T* tab, const int* meta, T x, T y, T z,
                                        Sink& sink) {
  const int ngroups = meta[M_NGROUPS];
  const int* groups = meta + meta[M_I_GROUPS];
  for (int gi = 0; gi < ngroups; ++gi) {
    const int* grp = groups + gi * GROUP_INTS;
    switch (grp[G_L]) {
      case 0: shell_group<T, 0, GRAD>(tab, grp, x, y, z, sink); break;
      case 1: shell_group<T, 1, GRAD>(tab, grp, x, y, z, sink); break;
      case 2: shell_group<T, 2, GRAD>(tab, grp, x, y, z, sink); break;
      default: shell_group<T, 3, GRAD>(tab, grp, x, y, z, sink); break;
    }
  }
}

}  // namespace pq
