// Casula T-move sweep over all electrons of a Slater-Jastrow wavefunction,
// one thread per walker.
//
// Replaces pyqmc_tpu/ops/move_pallas.py:build_fused_tmove_sweep, the Pallas
// TPU kernel (method/dmc.py tmove_sweep over observables/ecp.py
// tmove_quadrature). Per electron, in order:
//   1. the nonlocal quadrature around every ECP atom on the walker's own
//      rotation: w_q = -tau T_q (ecp_device.cuh) and the wavefunction ratio
//      r_q at the point (value-only AOs contracted with the MO coefficients
//      and the inverse column, times the Jastrow value ratio);
//   2. heat-bath selection among {stay} + the points with amplitudes
//      max(0, w_q r_q): choice = #{categories whose cumulative probability
//      lies below u_sel}, category 0 = stay, then the points in quadrature
//      order (atoms by ascending grid size, as SJTables packs them);
//   3. the reverse amplitudes seen from the chosen point m,
//      max(0, w_q r_q / r_m) and, for q = m, max(0, w_m / r_m), with
//      1 / r_m only where |r_m| > 1e-30; acceptance norm / back_norm > u_acc;
//   4. on acceptance the move to the chosen point: AO value+gradient there,
//      Sherman-Morrison and cache update (sj_update.cuh), Jastrow U.
// A walker that stays or is rejected is left untouched, so step 4 is skipped
// for it (the Pallas kernel evaluates and masks; the result is the same).
//
// Per-point storage: the Pallas kernel keeps every point's w, r, position
// and Jastrow value in unrolled lists and picks with a select chain. A
// per-thread array indexed at run time would go to local memory under a
// compile-time cap, so w_q and r_q go to a walker-minor global scratch of
// (2 nq_total, nconf) that the wrapper allocates (coalesced, L1/L2
// resident, no cap on the number of points), and the chosen point's
// position and Jastrow value are recomputed from its index with the same
// arithmetic.
//
// Layout: the walker-minor state of sweep_kernel.cuh, copied from
// `state_in` to `state_out` and updated in place there; rot (9 nelec,
// nconf) row-major 3x3 per electron; u_sel, u_acc (nelec, nconf).
//
// What bounds it: FP work, nq_total value-only AO evaluations and Jastrow
// value passes per electron (6 for ccECP H2O, 48 per walker) at 2048
// threads, under one warp per SM of an H100; its memory time (one pass
// over the state and the streams) is three orders of magnitude below that.
#include <cuda_runtime.h>

#include "ecp_device.cuh"
#include "gto_device.cuh"
#include "sj_device.cuh"
#include "sj_update.cuh"

namespace pq {

// Orbital values at one point, contracted with the MO coefficients.
template <typename T, int NMAX>
struct ValueSink {
  const T* C;  // (nao, n) concat-row order
  int n;
  T mo[NMAX];
  __device__ __forceinline__ void operator()(int row, T v, T, T, T) {
    const T* c = C + row * n;
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n) mo[j] += v * c[j];
  }
};

template <typename T>
__device__ __forceinline__ T pos_part(T x) {
  return x > T(0) ? x : T(0);
}

template <typename T, int NMAX>
__global__ void tmove_sweep_kernel(const T* __restrict__ state_in, T* __restrict__ state_out,
                                   const T* __restrict__ rot, const T* __restrict__ usel,
                                   const T* __restrict__ uacc, T* __restrict__ scratch,
                                   const T* __restrict__ tab_g, int ntab,
                                   const int* __restrict__ meta_g, int nmeta, int nconf,
                                   int nrows, T tau) {
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
  const T rmax = tab[meta[M_F_RMAX]];
  const int nqa = meta[M_NQATOMS];
  const int* qatoms = meta + meta[M_I_QATOMS];
  int nqt = 0;
  for (int qa = 0; qa < nqa; ++qa) nqt += qatoms[qa * QATOM_INTS + Q_NPTS];
  T* Wq = scratch + w;                      // w_q at Wq[q * st]
  T* Rq = scratch + (size_t)nqt * st + w;   // r_q at Rq[q * st]

  for (int e = 0; e < nelec; ++e) {
    const int s = e < nup ? 0 : 1;
    const int n = s ? ndn : nup;
    const int row = s ? e - nup : e;
    const int oinv = s ? off_invd : off_invu;
    const int omog = s ? off_mogd : off_mogu;
    const int oph = off_phu + 2 * s;  // phase; log|det| follows
    const T* C = tab + (s ? meta[M_F_CB] : meta[M_F_CA]);
    const T ex = S[(3 * e) * st], ey = S[(3 * e + 1) * st], ez = S[(3 * e + 2) * st];
    T invrow[NMAX];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) invrow[j] = j < n ? S[(oinv + j * n + row) * st] : T(0);
    T R[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = rot[(9 * e + k) * st + w];
    const T u_old = hasj ? jastrow_terms<T, false>(tab, meta, ex, ey, ez, e, s, S, st, nullptr)
                         : T(0);

    // 1. quadrature: w_q and r_q of every point, and the forward norm
    QuadAtom<T> atom;
    T amp_sum = T(0);
    int q = 0;
    for (int qa = 0; qa < nqa; ++qa) {
      atom.set(tab, meta, qatoms + qa * QATOM_INTS, ex, ey, ez, rmax, true);
      for (int ip = 0; ip < atom.q[Q_NPTS]; ++ip, ++q) {
        T ax, ay, az;
        const T wq = -tau * atom.point(tab, R, ip, ax, ay, az, true);
        ValueSink<T, NMAX> sink;
        sink.C = C;
        sink.n = n;
#pragma unroll
        for (int j = 0; j < NMAX; ++j) sink.mo[j] = T(0);
        ao_eval<T, false>(tab, meta, ax, ay, az, sink);
        T rq = T(0);
#pragma unroll
        for (int j = 0; j < NMAX; ++j)
          if (j < n) rq += sink.mo[j] * invrow[j];
        if (hasj) {
          const T uq = jastrow_terms<T, false>(tab, meta, ax, ay, az, e, s, S, st, nullptr);
          rq *= dexp(uq - u_old);
        }
        Wq[q * st] = wq;
        Rq[q * st] = rq;
        amp_sum += pos_part(wq * rq);
      }
    }
    const T norm = T(1) + amp_sum;

    // 2. heat-bath selection: category 0 = stay, then the points in order
    const T us = usel[e * st + w];
    T cum = T(1) / norm;
    int choice = us > cum ? 1 : 0;
    for (q = 0; q < nqt; ++q) {
      cum += pos_part(Wq[q * st] * Rq[q * st]) / norm;
      choice += us > cum ? 1 : 0;
    }
    if (choice == 0) continue;  // stay
    const int qsel = choice - 1 < nqt - 1 ? choice - 1 : nqt - 1;

    // 3. reverse amplitudes from the chosen point, and the acceptance
    const T r_m = Rq[qsel * st], w_m = Wq[qsel * st];
    const T inv_r = dabs(r_m) > T(1e-30) ? T(1) / r_m : T(0);
    T back_sum = T(0);
    for (q = 0; q < nqt; ++q)
      back_sum += q == qsel ? pos_part(w_m * inv_r) : pos_part(Wq[q * st] * Rq[q * st] * inv_r);
    if (!(norm / (T(1) + back_sum) > uacc[e * st + w])) continue;

    // 4. move to the chosen point: find its atom, recompute its position
    int ip = qsel, qa = 0;
    while (ip >= qatoms[qa * QATOM_INTS + Q_NPTS]) {
      ip -= qatoms[qa * QATOM_INTS + Q_NPTS];
      ++qa;
    }
    atom.set(tab, meta, qatoms + qa * QATOM_INTS, ex, ey, ez, rmax, false);
    T nx, ny, nz;
    atom.point(tab, R, ip, nx, ny, nz, false);
    const T u_m = hasj ? jastrow_terms<T, false>(tab, meta, nx, ny, nz, e, s, S, st, nullptr)
                       : T(0);
    MoSink<T, NMAX> sink;
    sink.C = C;
    sink.n = n;
#pragma unroll
    for (int slot = 0; slot < 4; ++slot)
#pragma unroll
      for (int j = 0; j < NMAX; ++j) sink.mo[slot][j] = T(0);
    ao_eval<T, true>(tab, meta, nx, ny, nz, sink);
    accept_update<T, NMAX>(S, st, sink, oinv, omog, oph, n, row);
    S[(3 * e) * st] = nx;
    S[(3 * e + 1) * st] = ny;
    S[(3 * e + 2) * st] = nz;
    if (hasj) S[off_u * st] = S[off_u * st] + (u_m - u_old);
  }
}

template <typename T>
int launch_tmove_sweep(const T* state_in, T* state_out, const T* rot, const T* usel,
                       const T* uacc, T* scratch, const T* tab, int ntab, const int* meta,
                       int nmeta, int nconf, int nrows, int nmax, double tau,
                       cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (nconf + threads - 1) / threads;
  const size_t smem = (size_t)ntab * sizeof(T) + (size_t)nmeta * sizeof(int);
  if (nmax <= 4) {
    tmove_sweep_kernel<T, 4><<<blocks, threads, smem, stream>>>(
        state_in, state_out, rot, usel, uacc, scratch, tab, ntab, meta, nmeta, nconf, nrows,
        T(tau));
  } else {
    tmove_sweep_kernel<T, 16><<<blocks, threads, smem, stream>>>(
        state_in, state_out, rot, usel, uacc, scratch, tab, ntab, meta, nmeta, nconf, nrows,
        T(tau));
  }
  return (int)cudaGetLastError();
}

}  // namespace pq

extern "C" {

int pq_tmove_sweep_f32(const void* state_in, void* state_out, const void* rot, const void* usel,
                       const void* uacc, void* scratch, const void* tab, int ntab,
                       const void* meta, int nmeta, int nconf, int nrows, int nmax, double tau,
                       void* stream) {
  return pq::launch_tmove_sweep<float>(
      (const float*)state_in, (float*)state_out, (const float*)rot, (const float*)usel,
      (const float*)uacc, (float*)scratch, (const float*)tab, ntab, (const int*)meta, nmeta,
      nconf, nrows, nmax, tau, (cudaStream_t)stream);
}

int pq_tmove_sweep_f64(const void* state_in, void* state_out, const void* rot, const void* usel,
                       const void* uacc, void* scratch, const void* tab, int ntab,
                       const void* meta, int nmeta, int nconf, int nrows, int nmax, double tau,
                       void* stream) {
  return pq::launch_tmove_sweep<double>(
      (const double*)state_in, (double*)state_out, (const double*)rot, (const double*)usel,
      (const double*)uacc, (double*)scratch, (const double*)tab, ntab, (const int*)meta, nmeta,
      nconf, nrows, nmax, tau, (cudaStream_t)stream);
}

}  // extern "C"
