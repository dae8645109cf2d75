// Shared device code of the Slater-Jastrow kernels: the layout of the packed
// parameter tables, math helpers for float/double, the Jastrow radial bases
// and the ECP's Legendre projectors and radial powers.
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
