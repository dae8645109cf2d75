// Device code shared by the kernels that move an electron: the sink that
// contracts AOs with the MO coefficients on the fly, and the accept-side
// update of a walker's state (vmc_sweep.cu, dmc_sweep.cu, tmove_sweep.cu).
#pragma once

#include "sj_device.cuh"

namespace pq {

template <typename T, int NMAX>
struct MoSink {
  const T* C;  // (nao, n) concat-row order
  int n;
  T mo[4][NMAX];
  __device__ __forceinline__ void operator()(int row, T v, T gx, T gy, T gz) {
    const T* c = C + row * n;
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n) {
        const T cj = c[j];
        mo[0][j] += v * cj;
        mo[1][j] += gx * cj;
        mo[2][j] += gy * cj;
        mo[3][j] += gz * cj;
      }
    }
  }
};

// Accept-side update of one electron's move to the point whose orbitals
// `sink` holds: Sherman-Morrison on the inverse (row `row` of the orbital
// matrix replaced), phase and log|det|, and the electron's orbital cache
// row [value; gradient]. S is the walker's state column (row r at
// S[r * st]); oinv, omog, oph are the first rows of the spin's inverse,
// orbital cache and phase (log|det| follows the phase).
template <typename T, int NMAX>
__device__ __forceinline__ void accept_update(T* S, size_t st, const MoSink<T, NMAX>& sink,
                                              int oinv, int omog, int oph, int n, int row) {
  // t_j = sum_k mo_k inv[k, j]; replace row `row`
  T tvec[NMAX];
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    T acc = T(0);
    if (j < n) {
#pragma unroll
      for (int k = 0; k < NMAX; ++k)
        if (k < n) acc += sink.mo[0][k] * S[(oinv + k * n + j) * st];
    }
    tvec[j] = acc;
  }
  T rsm = T(0);
#pragma unroll
  for (int j = 0; j < NMAX; ++j)
    if (j == row) rsm = tvec[j];
  for (int i = 0; i < n; ++i) {
    const T col = S[(oinv + i * n + row) * st];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n && j != row) {
        T& a = S[(oinv + i * n + j) * st];
        a = a - col * tvec[j] / rsm;
      }
    }
    S[(oinv + i * n + row) * st] = col / rsm;
  }
  const T absr = dabs(rsm);
  const T safe = absr == T(0) ? T(1) : absr;
  S[oph * st] = S[oph * st] * (rsm / safe);
  S[(oph + 1) * st] = S[(oph + 1) * st] + dlog(safe);
  // orbital cache row of this electron: [value; gradient]
#pragma unroll
  for (int slot = 0; slot < 4; ++slot)
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n) S[(omog + (row * 4 + slot) * n + j) * st] = sink.mo[slot][j];
}

}  // namespace pq
