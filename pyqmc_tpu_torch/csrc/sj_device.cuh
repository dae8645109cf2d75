// Shared device code of the Slater-Jastrow kernels: the layout of the packed
// parameter tables, math helpers for float/double, the Jastrow radial bases
// and the one-electron Jastrow terms.
//
// Tables. Every kernel takes one float buffer `tab` (type T) and one int32
// buffer `meta`, both copied into shared memory once per block. `meta`
// starts with the header below; its offsets point into `tab` (F_ offsets) or
// into `meta` itself (I_ offsets). pyqmc_tpu_torch/ops/move_sweep.py
// (SJTables) writes the same layout; the two must change together.
#pragma once

#include <cuda_runtime.h>

namespace pq {

enum MetaSlot {
  M_NELEC = 0,
  M_NUP,
  M_NDN,
  M_NAO,
  M_NATOM,      // Jastrow atoms (0 without a Jastrow)
  M_NA,         // e-ion basis functions
  M_NB,         // e-e basis functions
  M_NGROUPS,    // AO l-groups
  M_HASJ,       // 1 when a Jastrow factor is present
  M_F_CA,       // (nao, nup) MO coefficients, concat AO row order
  M_F_CB,       // (nao, ndn)
  M_F_ACOEFF,   // (natom, na, 2)
  M_F_BCOEFF,   // (nb, 3)
  M_F_ATOMS,    // (natom, 3)
  M_F_ABAS,     // (na, 2): param, rcut
  M_F_BBAS,     // (nb, 2)
  M_I_AKIND,    // (na,) 0 polypade, 1 cutoffcusp
  M_I_BKIND,    // (nb,)
  M_I_GROUPS,   // (ngroups, GROUP_INTS)
  M_NQATOMS,    // ECP quadrature atoms (0 for the sweep)
  M_I_QATOMS,   // (nqatoms, QATOM_INTS)
  M_F_RMAX,     // ECP cutoff radius
  M_HEADER
};

// per l-group: l, S shells, P primitives, F offsets of centers (S,3),
// alpha (S,P), coef (S,P), cart->sph weights (ncart, 2l+1), first concat row
enum GroupSlot { G_L = 0, G_S, G_P, G_F_CEN, G_F_ALPHA, G_F_COEF, G_F_CW, G_ROW, GROUP_INTS };

// per ECP quadrature atom: points, F offset of (npts, 4) [x, y, z, weight],
// channels, I offset of (nchan, CHAN_INTS), F offset of the atom's coords
enum QAtomSlot { Q_NPTS = 0, Q_F_PTS, Q_NCHAN, Q_I_CHANS, Q_F_COORD, QATOM_INTS };

// per nonlocal channel: l, terms, F offset of (nterm, 3) [coeff, exp, power]
enum ChanSlot { C_L = 0, C_NTERM, C_F_TERMS, CHAN_INTS };

constexpr int LMAX = 3;        // highest AO angular momentum the kernels take
constexpr int BASIS_POLYPADE = 0;
constexpr int BASIS_CUTOFFCUSP = 1;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

template <typename T>
__device__ __forceinline__ T clamp01(T x) {
  return x < T(0) ? T(0) : (x > T(1) ? T(1) : x);
}

// Copy the tables into dynamic shared memory: tab first (aligned for T),
// meta right after it.
template <typename T>
__device__ __forceinline__ void load_tables(const T* __restrict__ tab_g, int ntab,
                                            const int* __restrict__ meta_g, int nmeta,
                                            T** tab, int** meta) {
  extern __shared__ __align__(16) unsigned char pq_smem[];
  T* t = reinterpret_cast<T*>(pq_smem);
  int* m = reinterpret_cast<int*>(t + ntab);
  for (int i = threadIdx.x; i < ntab; i += blockDim.x) t[i] = tab_g[i];
  for (int i = threadIdx.x; i < nmeta; i += blockDim.x) m[i] = meta_g[i];
  __syncthreads();
  *tab = t;
  *meta = m;
}

// Radial Jastrow basis of one kind: value and f'(r)/r (models/func3d.py).
template <typename T, int KIND>
__device__ __forceinline__ void basis_kind(T param, T rcut, T r, T& v, T& fo) {
  const bool inside = r < rcut;
  if (KIND == BASIS_POLYPADE) {
    const T x = clamp01(r / rcut);
    const T z = x * x * (T(6) - T(8) * x + T(3) * x * x);
    const T dzdx = T(12) * x * (T(1) - x) * (T(1) - x);
    const T den = T(1) + param * z;
    const T f = (T(1) - z) / den;
    const T dfdz = -(T(1) + param) / (den * den);
    const T fp = dfdz * dzdx / rcut;
    const T fo_ = r > T(1e-12) ? fp / r : T(12) * dfdz / (rcut * rcut);
    v = inside ? f : T(0);
    fo = inside ? fo_ : T(0);
  } else {
    const T y = clamp01(r / rcut);
    const T p = y - y * y + y * y * y / T(3);
    const T pp = (T(1) - y) * (T(1) - y);
    const T den = T(1) + param * p;
    const T c0 = (T(1) / T(3)) / (T(1) + param / T(3));
    const T f = rcut * (p / den - c0);
    const T dfdr = pp / (den * den);
    const T rsafe = r > T(1e-12) ? r : T(1e-12);
    v = inside ? f : T(0);
    fo = inside ? dfdr / rsafe : T(0);
  }
}

// Radial Jastrow basis of a kind known at run time.
template <typename T>
__device__ __forceinline__ void basis_eval(int kind, T param, T rcut, T r, T& v, T& fo) {
  if (kind == BASIS_POLYPADE)
    basis_kind<T, BASIS_POLYPADE>(param, rcut, r, v, fo);
  else
    basis_kind<T, BASIS_CUTOFFCUSP>(param, rcut, r, v, fo);
}

// Jastrow terms of electron e (spin s) placed at (x, y, z): the e-ion sum
// and the e-e sum over every other electron at its position in `pos`
// (rows 3j + axis, row stride `stride`). Returns u; adds the gradient to g
// when GRAD.
template <typename T, bool GRAD>
__device__ __forceinline__ T jastrow_terms(const T* tab, const int* meta, T x, T y, T z,
                                           int e, int s, const T* pos, size_t stride,
                                           T* g) {
  const int natom = meta[M_NATOM], na = meta[M_NA], nb = meta[M_NB];
  const int nup = meta[M_NUP], nelec = meta[M_NELEC];
  const T* atoms = tab + meta[M_F_ATOMS];
  const T* acoeff = tab + meta[M_F_ACOEFF];
  const T* bcoeff = tab + meta[M_F_BCOEFF];
  const T* abas = tab + meta[M_F_ABAS];
  const T* bbas = tab + meta[M_F_BBAS];
  const int* akind = meta + meta[M_I_AKIND];
  const int* bkind = meta + meta[M_I_BKIND];
  T u = T(0);
  for (int I = 0; I < natom; ++I) {
    const T dx = x - atoms[3 * I], dy = y - atoms[3 * I + 1], dz = z - atoms[3 * I + 2];
    const T r = dsqrt(dx * dx + dy * dy + dz * dz);
    for (int k = 0; k < na; ++k) {
      T v, fo;
      basis_eval<T>(akind[k], abas[2 * k], abas[2 * k + 1], r, v, fo);
      const T w = acoeff[(I * na + k) * 2 + s];
      u += w * v;
      if (GRAD) {
        g[0] += w * fo * dx;
        g[1] += w * fo * dy;
        g[2] += w * fo * dz;
      }
    }
  }
  for (int j = 0; j < nelec; ++j) {
    if (j == e) continue;
    const T dx = x - pos[(size_t)(3 * j) * stride];
    const T dy = y - pos[(size_t)(3 * j + 1) * stride];
    const T dz = z - pos[(size_t)(3 * j + 2) * stride];
    const T r = dsqrt(dx * dx + dy * dy + dz * dz);
    const int ch = s + (j >= nup ? 1 : 0);
    for (int k = 0; k < nb; ++k) {
      T v, fo;
      basis_eval<T>(bkind[k], bbas[2 * k], bbas[2 * k + 1], r, v, fo);
      const T w = bcoeff[k * 3 + ch];
      u += w * v;
      if (GRAD) {
        g[0] += w * fo * dx;
        g[1] += w * fo * dy;
        g[2] += w * fo * dz;
      }
    }
  }
  return u;
}

// Legendre polynomial P_l(x), l <= 6 (observables/ecp.py legendre).
template <typename T>
__device__ __forceinline__ T legendre(int l, T x) {
  const T x2 = x * x;
  switch (l) {
    case 0: return T(1);
    case 1: return x;
    case 2: return T(0.5) * (T(3) * x2 - T(1));
    case 3: return T(0.5) * (T(5) * x2 * x - T(3) * x);
    case 4: return T(0.125) * (T(35) * x2 * x2 - T(30) * x2 + T(3));
    case 5: return T(0.125) * (T(63) * x2 * x2 * x - T(70) * x2 * x + T(15) * x);
    default: return T(0.0625) * (T(231) * x2 * x2 * x2 - T(315) * x2 * x2 + T(105) * x2 - T(5));
  }
}

// r^k for a small integer k (negative allowed).
template <typename T>
__device__ __forceinline__ T ipow(T r, int k) {
  T out = T(1);
  const int m = k < 0 ? -k : k;
  for (int i = 0; i < m; ++i) out *= r;
  return k < 0 ? T(1) / out : out;
}

}  // namespace pq
