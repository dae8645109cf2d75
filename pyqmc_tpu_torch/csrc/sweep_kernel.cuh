// One sweep of single-electron moves over all electrons of a Slater-Jastrow
// wavefunction, one thread per walker: the kernel template behind
// vmc_sweep.cu (DMC = false) and dmc_sweep.cu (DMC = true).
//
// Replaces pyqmc_tpu/ops/move_pallas.py:build_fused_sweep, the Pallas TPU
// kernel, and computes what it computes with the same algebra: drift at the
// old position from the cached orbital values and gradients, the proposal on
// the pre-drawn gauss, AO value+gradient at the proposal contracted with the
// MO coefficients, the determinant ratio, the Jastrow delta and gradient,
// drift limiting, acceptance |ratio|^2 * t_prob > unif, then the
// Sherman-Morrison update of the inverse, phase and log|det|, the orbital
// cache row and the Jastrow U (sj_update.cuh). The two modes differ where
// the Pallas kernel branches on `mode`:
//   drift limiting   vmc: norm capped at drift_cutoff;
//                    dmc: Umrigar, v * (sqrt(1 + 2 v^2 tau) - 1) / (v^2 tau)
//                    with v^2 tau floored at 1e-12;
//   fixed node       dmc: a move with ratio <= 0 is rejected;
//   outputs          dmc: per walker, the squared displacement
//                    |gauss + tau * drift_old|^2 summed over every proposal
//                    (r2p) and over the accepted ones (r2a).
//
// Layout: walker-minor, as in the Pallas wrapper. Element r of walker w is
// at [r * nconf + w], so neighbouring threads touch neighbouring addresses.
// The walker's state column is copied from `state_in` to `state_out` and
// then updated in place there (L1/L2-resident for the whole sweep). Rows:
//   pos (3 nelec) | inv_up (nup^2) | inv_dn (ndn^2) | phase_up | logdet_up |
//   phase_dn | logdet_dn | mog_up (nup*4*nup) | mog_dn (ndn*4*ndn) | u
// `sums` holds the per-walker outputs: row 0 the accepted moves, and in dmc
// mode row 1 r2p and row 2 r2a. The basis, MO and Jastrow tables sit in
// shared memory (sj_device.cuh).
//
// What bounds it: the exp-heavy AO evaluation (one exp per primitive per
// shell, 23 AOs for ccECP H2O, per electron move) and occupancy: 2048
// walkers are 2048 threads, under one warp per SM of an H100. The design
// keeps the whole sweep in one launch, so the state crosses device memory
// once per step. A later version splits each walker over a warp.
#pragma once

#include <cuda_runtime.h>

#include "gto_device.cuh"
#include "sj_device.cuh"
#include "sj_update.cuh"

namespace pq {

// Drift limiting: cap the norm (vmc) or Umrigar's form (dmc).
template <typename T, bool DMC>
__device__ __forceinline__ void limdrift(T* g, T tstep, T cutoff) {
  T scale;
  if (DMC) {
    const T v2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2];
    const T taueff = v2 * tstep > T(1e-12) ? v2 * tstep : T(1e-12);
    scale = (dsqrt(T(1) + T(2) * taueff) - T(1)) / taueff;
  } else {
    const T tot = dsqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    scale = tot > cutoff ? cutoff / tot : T(1);
  }
  g[0] *= scale;
  g[1] *= scale;
  g[2] *= scale;
}

template <typename T, int NMAX, bool DMC>
__global__ void sweep_kernel(const T* __restrict__ state_in, T* __restrict__ state_out,
                             const T* __restrict__ gauss, const T* __restrict__ unif,
                             T* __restrict__ sums, const T* __restrict__ tab_g, int ntab,
                             const int* __restrict__ meta_g, int nmeta, int nconf, int nrows,
                             T tstep, T drift_cutoff) {
  T* tab;
  int* meta;
  load_tables<T>(tab_g, ntab, meta_g, nmeta, &tab, &meta);
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nconf) return;
  const size_t st = (size_t)nconf;
  T* S = state_out + w;  // row r of this walker: S[r * st]
  for (int r = 0; r < nrows; ++r) S[r * st] = state_in[r * st + w];

  const int nelec = meta[M_NELEC], nup = meta[M_NUP], ndn = meta[M_NDN];
  const bool hasj = meta[M_HASJ] != 0;
  const int off_invu = 3 * nelec;
  const int off_invd = off_invu + nup * nup;
  const int off_phu = off_invd + ndn * ndn;
  const int off_mogu = off_phu + 4;
  const int off_mogd = off_mogu + 4 * nup * nup;
  const int off_u = off_mogd + 4 * ndn * ndn;
  T nacc = T(0), r2p = T(0), r2a = T(0);

  for (int e = 0; e < nelec; ++e) {
    const int s = e < nup ? 0 : 1;
    const int n = s ? ndn : nup;
    const int row = s ? e - nup : e;
    const int oinv = s ? off_invd : off_invu;
    const int omog = s ? off_mogd : off_mogu;
    const int oph = off_phu + 2 * s;  // phase; log|det| follows
    const T ex = S[(3 * e) * st], ey = S[(3 * e + 1) * st], ez = S[(3 * e + 2) * st];

    // drift at the current position: det-ratio contraction on the cache
    T invrow[NMAX];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) invrow[j] = j < n ? S[(oinv + j * n + row) * st] : T(0);
    T r4[4];
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NMAX; ++j)
        if (j < n) acc += S[(omog + (row * 4 + slot) * n + j) * st] * invrow[j];
      r4[slot] = acc;
    }
    T g_old[3] = {r4[1] / r4[0], r4[2] / r4[0], r4[3] / r4[0]};
    T u_old = T(0);
    if (hasj) {
      T gj[3] = {T(0), T(0), T(0)};
      u_old = jastrow_terms<T, true>(tab, meta, ex, ey, ez, e, s, S, st, gj);
      g_old[0] += gj[0];
      g_old[1] += gj[1];
      g_old[2] += gj[2];
    }
    limdrift<T, DMC>(g_old, tstep, drift_cutoff);

    // proposal (open boundary: no wrap)
    const T gax = gauss[(3 * e) * st + w], gay = gauss[(3 * e + 1) * st + w],
            gaz = gauss[(3 * e + 2) * st + w];
    const T nx = ex + gax + tstep * g_old[0];
    const T ny = ey + gay + tstep * g_old[1];
    const T nz = ez + gaz + tstep * g_old[2];

    // orbitals and gradients at the proposal
    MoSink<T, NMAX> sink;
    sink.C = tab + (s ? meta[M_F_CB] : meta[M_F_CA]);
    sink.n = n;
#pragma unroll
    for (int slot = 0; slot < 4; ++slot)
#pragma unroll
      for (int j = 0; j < NMAX; ++j) sink.mo[slot][j] = T(0);
    ao_eval<T, true>(tab, meta, nx, ny, nz, sink);

    T ratio = T(0), gn[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int j = 0; j < NMAX; ++j) {
      if (j < n) {
        ratio += sink.mo[0][j] * invrow[j];
        gn[0] += sink.mo[1][j] * invrow[j];
        gn[1] += sink.mo[2][j] * invrow[j];
        gn[2] += sink.mo[3][j] * invrow[j];
      }
    }
    gn[0] /= ratio;
    gn[1] /= ratio;
    gn[2] /= ratio;
    T du = T(0);
    if (hasj) {
      T gj[3] = {T(0), T(0), T(0)};
      const T u_new = jastrow_terms<T, true>(tab, meta, nx, ny, nz, e, s, S, st, gj);
      du = u_new - u_old;
      ratio *= dexp(du);
      gn[0] += gj[0];
      gn[1] += gj[1];
      gn[2] += gj[2];
    }
    limdrift<T, DMC>(gn, tstep, drift_cutoff);

    // Metropolis-Hastings acceptance
    const T forward = gax * gax + gay * gay + gaz * gaz;
    const T bx = gax + tstep * (g_old[0] + gn[0]);
    const T by = gay + tstep * (g_old[1] + gn[1]);
    const T bz = gaz + tstep * (g_old[2] + gn[2]);
    const T backward = bx * bx + by * by + bz * bz;
    const T t_prob = dexp((forward - backward) / (T(2) * tstep));
    T accept_prob = dabs(ratio) * dabs(ratio) * t_prob;
    if (DMC && ratio <= T(0)) accept_prob = T(0);  // fixed node
    const bool accept = accept_prob > unif[e * st + w];
    if (DMC) {
      const T px = gax + tstep * g_old[0], py = gay + tstep * g_old[1],
              pz = gaz + tstep * g_old[2];
      const T r2 = px * px + py * py + pz * pz;
      r2p += r2;
      if (accept) r2a += r2;
    }
    if (!accept) continue;
    nacc += T(1);

    accept_update<T, NMAX>(S, st, sink, oinv, omog, oph, n, row);
    S[(3 * e) * st] = nx;
    S[(3 * e + 1) * st] = ny;
    S[(3 * e + 2) * st] = nz;
    if (hasj) S[off_u * st] = S[off_u * st] + du;
  }
  sums[w] = nacc;
  if (DMC) {
    sums[st + w] = r2p;
    sums[2 * st + w] = r2a;
  }
}

template <typename T, bool DMC>
int launch_sweep(const T* state_in, T* state_out, const T* gauss, const T* unif, T* sums,
                 const T* tab, int ntab, const int* meta, int nmeta, int nconf, int nrows,
                 int nmax, double tstep, double drift_cutoff, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (nconf + threads - 1) / threads;
  const size_t smem = (size_t)ntab * sizeof(T) + (size_t)nmeta * sizeof(int);
  if (nmax <= 4) {
    sweep_kernel<T, 4, DMC><<<blocks, threads, smem, stream>>>(
        state_in, state_out, gauss, unif, sums, tab, ntab, meta, nmeta, nconf, nrows, T(tstep),
        T(drift_cutoff));
  } else {
    sweep_kernel<T, 16, DMC><<<blocks, threads, smem, stream>>>(
        state_in, state_out, gauss, unif, sums, tab, ntab, meta, nmeta, nconf, nrows, T(tstep),
        T(drift_cutoff));
  }
  return (int)cudaGetLastError();
}

}  // namespace pq
