// Device code shared by the kernels that integrate the nonlocal ECP on a
// spherical quadrature (ecp_energy.cu, tmove_sweep.cu): the radial channels
// of one atom and one quadrature point's matrix-element weight and position.
// Quadrature order, rsafe, the r < rmax mask, the (2l+1) factor and the
// r^(n-2) powers follow the Pallas kernels (move_pallas.py:246-275, 871-897,
// 1265-1286): powers are taken of r itself by repeated multiplication
// (`ipow`), where the plain chain clamps r at 1e-12 first; the two differ
// only for an electron on a nucleus.
#pragma once

#include "sj_device.cuh"

namespace pq {

constexpr int MAXCHAN = 8;  // nonlocal channels per atom (ops/move_sweep.py MAX_CHANNELS)

// One electron against one quadrature atom: the displacement from the atom,
// its length, and (2l+1) v_l(r) [r < rmax] for every channel.
template <typename T>
struct QuadAtom {
  const int* q;      // the atom's QATOM_INTS
  const int* chans;  // (nchan, CHAN_INTS)
  const T* coord;
  T dx, dy, dz, r, rsafe;
  T vch[MAXCHAN];

  __device__ __forceinline__ void set(const T* tab, const int* meta, const int* qatom, T ex,
                                      T ey, T ez, T rmax, bool radial) {
    q = qatom;
    chans = meta + q[Q_I_CHANS];
    coord = tab + q[Q_F_COORD];
    dx = ex - coord[0];
    dy = ey - coord[1];
    dz = ez - coord[2];
    r = dsqrt(dx * dx + dy * dy + dz * dz);
    rsafe = r > T(1e-12) ? r : T(1e-12);
    if (!radial) return;
    const T inside = r < rmax ? T(1) : T(0);
    const int nchan = q[Q_NCHAN];
    for (int c = 0; c < nchan; ++c) {
      const int* ch = chans + c * CHAN_INTS;
      const T* terms = tab + ch[C_F_TERMS];
      T v = T(0);
      for (int m = 0; m < ch[C_NTERM]; ++m)
        v += terms[3 * m] * ipow(r, (int)terms[3 * m + 2] - 2) * dexp(-terms[3 * m + 1] * r * r);
      vch[c] = T(2 * ch[C_L] + 1) * v * inside;
    }
  }

  // Quadrature point ip rotated by R (row-major 3x3): its position on the
  // sphere through the electron (ax, ay, az); returns the weight
  // T_q = w_q sum_l (2l+1) v_l(r) P_l(cos theta_q) when `radial` was set.
  __device__ __forceinline__ T point(const T* tab, const T* R, int ip, T& ax, T& ay, T& az,
                                     bool weight) const {
    const T* p = tab + q[Q_F_PTS] + 4 * ip;
    const T ddx = R[0] * p[0] + R[1] * p[1] + R[2] * p[2];
    const T ddy = R[3] * p[0] + R[4] * p[1] + R[5] * p[2];
    const T ddz = R[6] * p[0] + R[7] * p[1] + R[8] * p[2];
    ax = coord[0] + r * ddx;
    ay = coord[1] + r * ddy;
    az = coord[2] + r * ddz;
    if (!weight) return T(0);
    const T costh = (ddx * dx + ddy * dy + ddz * dz) / rsafe;
    T Tq = T(0);
    const int nchan = q[Q_NCHAN];
    for (int c = 0; c < nchan; ++c) Tq += vch[c] * legendre(chans[c * CHAN_INTS + C_L], costh);
    return Tq * p[3];
  }
};

}  // namespace pq
