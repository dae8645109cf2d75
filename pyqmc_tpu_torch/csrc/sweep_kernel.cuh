// One sweep of single-electron moves over all electrons of a Slater-Jastrow
// wavefunction, a group of G lanes per walker: the kernel template behind
// vmc_sweep.cu (DMC = false) and dmc_sweep.cu (DMC = true).
//
// Replaces pyqmc_tpu/ops/move_pallas.py:build_fused_sweep, the Pallas TPU
// kernel, and computes what it computes with the same algebra: drift at the
// old position from the cached orbital values and gradients, the proposal on
// the pre-drawn gauss, AO value+gradient at the proposal contracted with the
// MO coefficients, the determinant ratio, the Jastrow delta and gradient,
// drift limiting, acceptance |ratio|^2 * t_prob > unif, then the
// Sherman-Morrison update of the inverse, phase and log|det|, the orbital
// cache row and the Jastrow U. The two modes differ where the Pallas kernel
// branches on `mode`:
//   drift limiting   vmc: norm capped at drift_cutoff;
//                    dmc: Umrigar, v * (sqrt(1 + 2 v^2 tau) - 1) / (v^2 tau)
//                    with v^2 tau floored at 1e-12;
//   fixed node       dmc: a move with ratio <= 0 is rejected;
//   outputs          dmc: per walker, the squared displacement
//                    |gauss + tau * drift_old|^2 summed over every proposal
//                    (r2p) and over the accepted ones (r2a).
//
// Layout: walker-major. The state row of walker w is state_in[w * nrows +
// r], rows
//   pos (3 nelec) | inv_up (nup^2) | inv_dn (ndn^2) | phase_up | logdet_up |
//   phase_dn | logdet_dn | mog_up (nup*4*nup) | mog_dn (ndn*4*ndn) | u
// gauss is (nconf, nelec, 3), unif (nelec, nconf); `sums` holds the
// per-walker outputs: row 0 the accepted moves, and in dmc mode row 1 r2p
// and row 2 r2a.
//
// Design (lane_group.cuh). A walker is a group of G lanes of one warp (G
// a template parameter, set by each kernel's LANES: 16 for both modes), a
// block holds 128 / G walkers, so 2048 walkers fill 256 blocks on the
// card's 132 SMs. The tables, the plan and each walker's state row, gauss
// and unif are staged once per sweep in shared memory (the state row read
// and written back coalesced, one walker-major row per group). Per move:
//   1. every lane: the drift from the cached orbital row against the
//      inverse column (the same bits on every lane); the Jastrow at the old
//      position, its terms dealt over the lanes one basis kind at a time
//      and summed by the butterfly; the proposal;
//   2. the Jastrow terms at the proposal, dealt the same way; the
//      proposal's AO primitives dealt over the lanes, then its shells, one
//      per lane, into the walker's AO buffer, then the (slot, orbital) sums
//      of the contraction with C, one per lane;
//   3. lane 0: the ratio, the new drift, t_prob and the decision (and in
//      dmc mode the node test, r2p and r2a), broadcast by shuffle;
//   4. on accept, the Sherman-Morrison update and the cache row dealt over
//      the lanes; lane 0 the phase, log|det|, position and U.
//
// What bounds it: latency. 2048 walkers at G = 16 are under 8 warps per SM,
// and each move is a chain of short dealt passes between group
// synchronisations: at G = 16 about 3 Jastrow terms at each position (a
// square root and six or seven IEEE divisions each), 3 primitives, a shell
// and a 23-term dot product per lane; the two Jastrow passes are the
// longest. The card's operation bound is about 1 us per 2048-walker sweep,
// its memory time less.
#pragma once

#include <cuda_runtime.h>

#include "lane_group.cuh"
#include "sj_device.cuh"

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

// A walker's shared memory, in elements of T: the state row, gauss, unif,
// the primitive terms (E0, E1), the AO buffer (value and gradient per
// concat row), the orbital row at the proposal (4 slots of NMAX), and two
// NMAX rows of Sherman-Morrison scratch.
struct SweepSmem {
  int st, gs, un, E, aob, mo, tv, ic, total;
};

__host__ __device__ inline SweepSmem sweep_smem(int nrows, int nelec, int nprim, int nao,
                                                int nmax) {
  SweepSmem m;
  m.st = 0;
  m.gs = m.st + nrows;
  m.un = m.gs + 3 * nelec;
  m.E = m.un + nelec;
  m.aob = m.E + 2 * nprim;
  m.mo = m.aob + 4 * nao;
  m.tv = m.mo + 4 * nmax;
  m.ic = m.tv + nmax;
  m.total = m.ic + nmax;
  return m;
}

template <typename T, int NMAX, int G, bool DMC>
__global__ void __launch_bounds__(lg::THREADS)
    sweep_kernel(const T* __restrict__ state_in, T* __restrict__ state_out,
                 const T* __restrict__ gauss, const T* __restrict__ unif, T* __restrict__ sums,
                 const T* __restrict__ tab_g, int ntab, const int* __restrict__ meta_g, int nmeta,
                 const int* __restrict__ plan_g, int nplan, int nconf, int nrows, int W, T tstep,
                 T drift_cutoff) {
  T* tab;
  int* meta;
  int* plan;
  unsigned char* rest = lg::stage<T>(tab_g, ntab, meta_g, nmeta, plan_g, nplan, &tab, &meta,
                                     &plan);
  const lg::Group<G> grp;
  const int gi = threadIdx.x / G;
  const int w = blockIdx.x * W + gi;
  // the walker's state row, gauss and unif, read by its group (coalesced)
  const int nelec = meta_g[M_NELEC], nao = meta_g[M_NAO];
  const SweepSmem lay = sweep_smem(nrows, nelec, plan_g[lg::PL_NPRIM], nao, NMAX);
  T* ws = reinterpret_cast<T*>(rest) + (size_t)gi * lay.total;
  T* S = ws + lay.st;
  T* gs = ws + lay.gs;
  T* un = ws + lay.un;
  if (w < nconf) {
    for (int r = grp.lane; r < nrows; r += G) S[r] = state_in[(size_t)w * nrows + r];
    for (int r = grp.lane; r < 3 * nelec; r += G) gs[r] = gauss[(size_t)w * 3 * nelec + r];
    for (int e = grp.lane; e < nelec; e += G) un[e] = unif[(size_t)e * nconf + w];
  }
  __syncthreads();
  if (w >= nconf) return;  // the whole group: no block barrier follows

  T* E = ws + lay.E;
  T* aob = ws + lay.aob;
  T* mo = ws + lay.mo;
  const int nup = meta[M_NUP], ndn = meta[M_NDN];
  const bool hasj = meta[M_HASJ] != 0;
  const lg::JastrowTab<T> jt(tab, meta, plan);
  const int off_invu = 3 * nelec;
  const int off_invd = off_invu + nup * nup;
  const int off_phu = off_invd + ndn * ndn;
  const int off_mogu = off_phu + 4;
  const int off_mogd = off_mogu + 4 * nup * nup;
  const int off_u = off_mogd + 4 * ndn * ndn;
  T nacc = T(0), r2p = T(0), r2a = T(0);  // lane 0's

  for (int e = 0; e < nelec; ++e) {
    const int s = e < nup ? 0 : 1;
    const int n = s ? ndn : nup;
    const int row = s ? e - nup : e;
    const int oinv = s ? off_invd : off_invu;
    const int omog = s ? off_mogd : off_mogu;
    const int oph = off_phu + 2 * s;  // phase; log|det| follows
    const T ex = S[3 * e], ey = S[3 * e + 1], ez = S[3 * e + 2];

    // 1. drift at the current position: det-ratio contraction on the cache
    T invrow[NMAX];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) invrow[j] = j < n ? S[oinv + j * n + row] : T(0);
    T r4[4];
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < NMAX; ++j)
        if (j < n) acc += S[omog + (row * 4 + slot) * n + j] * invrow[j];
      r4[slot] = acc;
    }
    T g_old[3] = {r4[1] / r4[0], r4[2] / r4[0], r4[3] / r4[0]};
    T u_old = T(0);
    if (hasj) {
      T gj[3];
      u_old = lg::jastrow_group<T, true, G>(grp, jt, ex, ey, ez, e, s, S, gj);
      g_old[0] += gj[0];
      g_old[1] += gj[1];
      g_old[2] += gj[2];
    }
    limdrift<T, DMC>(g_old, tstep, drift_cutoff);

    // proposal (open boundary: no wrap)
    const T gax = gs[3 * e], gay = gs[3 * e + 1], gaz = gs[3 * e + 2];
    const T nx = ex + gax + tstep * g_old[0];
    const T ny = ey + gay + tstep * g_old[1];
    const T nz = ez + gaz + tstep * g_old[2];

    // 2. the Jastrow at the proposal, its items dealt over the lanes one
    // basis kind at a time; the orbitals and gradients there
    T gjn[3] = {T(0), T(0), T(0)};
    T u_new = lg::jastrow_lane<T, true, G>(jt, grp.lane, nx, ny, nz, e, s, S, gjn);
    const T* C = tab + (s ? meta[M_F_CB] : meta[M_F_CA]);
    lg::orbitals_grad<T, NMAX, G>(grp, tab, meta, plan, nx, ny, nz, C, n, E, aob, mo);
    if (hasj) {
      u_new = grp.sum(u_new);
      gjn[0] = grp.sum(gjn[0]);
      gjn[1] = grp.sum(gjn[1]);
      gjn[2] = grp.sum(gjn[2]);
    }

    // 3. the ratio, the new drift and the walker's one decision (lane 0)
    int accept = 0;
    T du = T(0);
    if (grp.lane == 0) {
      T ratio = T(0), gn[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int j = 0; j < NMAX; ++j) {
        if (j < n) {
          ratio += mo[j] * invrow[j];
          gn[0] += mo[NMAX + j] * invrow[j];
          gn[1] += mo[2 * NMAX + j] * invrow[j];
          gn[2] += mo[3 * NMAX + j] * invrow[j];
        }
      }
      gn[0] /= ratio;
      gn[1] /= ratio;
      gn[2] /= ratio;
      if (hasj) {
        du = u_new - u_old;
        ratio *= dexp(du);
        gn[0] += gjn[0];
        gn[1] += gjn[1];
        gn[2] += gjn[2];
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
      accept = accept_prob > un[e] ? 1 : 0;
      if (DMC) {
        const T px = gax + tstep * g_old[0], py = gay + tstep * g_old[1],
                pz = gaz + tstep * g_old[2];
        const T r2 = px * px + py * py + pz * pz;
        r2p += r2;
        if (accept) r2a += r2;
      }
    }
    if (!grp.bcast(accept, 0)) continue;

    // 4. the update, dealt over the lanes
    lg::accept_update<T, NMAX, G>(grp, S, mo, ws + lay.tv, ws + lay.ic, oinv, omog, oph, n,
                                  row);
    if (grp.lane == 0) {
      nacc += T(1);
      S[3 * e] = nx;
      S[3 * e + 1] = ny;
      S[3 * e + 2] = nz;
      if (hasj) S[off_u] = S[off_u] + du;
    }
    grp.sync();
  }
  for (int r = grp.lane; r < nrows; r += G) state_out[(size_t)w * nrows + r] = S[r];
  if (grp.lane == 0) {
    sums[w] = nacc;
    if (DMC) {
      sums[(size_t)nconf + w] = r2p;
      sums[2 * (size_t)nconf + w] = r2a;
    }
  }
}

template <typename T, int NMAX, int G, bool DMC>
int launch_sweep_g(const T* state_in, T* state_out, const T* gauss, const T* unif, T* sums,
                   const T* tab, int ntab, const int* meta, int nmeta, const int* plan, int nplan,
                   int nconf, int nrows, int nelec, int nao, int nprim, double tstep,
                   double drift_cutoff, cudaStream_t stream) {
  const size_t base = lg::staged_bytes(ntab, nmeta, nplan, sizeof(T));
  const size_t per_walker = (size_t)sweep_smem(nrows, nelec, nprim, nao, NMAX).total * sizeof(T);
  const int W = lg::walkers_per_block(G, base, per_walker);
  if (W == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = base + W * per_walker;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_kernel<T, NMAX, G, DMC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (nconf + W - 1) / W;
  sweep_kernel<T, NMAX, G, DMC><<<blocks, W * G, smem, stream>>>(
      state_in, state_out, gauss, unif, sums, tab, ntab, meta, nmeta, plan, nplan, nconf, nrows,
      W, T(tstep), T(drift_cutoff));
  return (int)cudaGetLastError();
}

// nmax: electrons of the larger spin (the NMAX 4 or 16 instance); G: the
// kernel's lanes per walker (vmc_sweep.cu, dmc_sweep.cu).
template <typename T, int G, bool DMC>
int launch_sweep(const T* state_in, T* state_out, const T* gauss, const T* unif, T* sums,
                 const T* tab, int ntab, const int* meta, int nmeta, const int* plan, int nplan,
                 int nconf, int nrows, int nelec, int nao, int nprim, int nmax, double tstep,
                 double drift_cutoff, cudaStream_t stream) {
  if (nmax <= 4)
    return launch_sweep_g<T, 4, G, DMC>(state_in, state_out, gauss, unif, sums, tab, ntab, meta,
                                        nmeta, plan, nplan, nconf, nrows, nelec, nao, nprim,
                                        tstep, drift_cutoff, stream);
  if (nmax <= 16)
    return launch_sweep_g<T, 16, G, DMC>(state_in, state_out, gauss, unif, sums, tab, ntab, meta,
                                         nmeta, plan, nplan, nconf, nrows, nelec, nao, nprim,
                                         tstep, drift_cutoff, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace pq
