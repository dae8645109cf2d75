// Casula T-move sweep over all electrons of a Slater-Jastrow wavefunction,
// a group of G lanes per walker.
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
//      order (atoms by ascending grid size, as SJTables packs them), the
//      cumulative sum taken in that order by one lane, so that the choice
//      depends only on the rounding of the r_q;
//   3. the reverse amplitudes seen from the chosen point m,
//      max(0, w_q r_q / r_m) and, for q = m, max(0, w_m / r_m), with
//      1 / r_m only where |r_m| > 1e-30; acceptance norm / back_norm > u_acc;
//   4. on acceptance the move to the chosen point: AO value+gradient there,
//      Sherman-Morrison and cache update, Jastrow U (its value at the point
//      kept from step 1).
// A walker that stays or is rejected is left untouched, so step 4 is skipped
// for it (the Pallas kernel evaluates and masks; the result is the same).
//
// Design (lane_group.cuh): a walker is a group of G = LANES lanes of one warp,
// 128 / G walkers a block. The walker's state row, rotations and uniforms sit
// in shared memory for the sweep, and so do every point's w_q, r_q, position
// and Jastrow value (no device-memory scratch). Step 1 is dealt over the lanes
// as flat lists: the points (weight and position), then the (point, primitive)
// exponentials and the (point, Jastrow pair) terms in one pass, then the
// (point, shell) AOs, then the (point, orbital) sums of the contraction, then
// per point the ratio; each lane keeps its own Jastrow partial of every point,
// summed over the lanes in lane order. Lane 0 takes steps 2 and 3 and
// broadcasts the chosen point (or none) by shuffle; step 4 is dealt over the
// lanes as in K1 (sweep_kernel.cuh).
//
// Layout: walker-major state rows as in sweep_kernel.cuh; rot (nconf,
// nelec, 9), row-major 3x3 per electron; u_sel, u_acc (nelec, nconf).
//
// What bounds it: latency, as K1: per electron a chain of dealt passes over
// nq_total points (6 for ccECP H2O); its operation bound is about 2 us per
// 2048-walker sweep.
#include <cuda_runtime.h>

#include "ecp_device.cuh"
#include "lane_group.cuh"
#include "sj_device.cuh"

namespace pq {

// lanes per walker: the fastest of 8, 16 and 32 at 2048 ccECP H2O walkers
// on an H100 (tools/time_k1_k5.py, PERF.md)
constexpr int LANES = 32;

template <typename T>
__device__ __forceinline__ T pos_part(T x) {
  return x > T(0) ? x : T(0);
}

// A walker's shared memory, in elements of T: the state row, rotations,
// u_sel, u_acc; per point its position, w_q, r_q and Jastrow value; the
// primitive terms (nq points, or E0 and E1 of the move), the AOs (nq points'
// values, or the move's values and gradients), the orbital rows (nq points,
// or the move's 4 slots), each lane's Jastrow partial per point, and two
// NMAX rows of Sherman-Morrison scratch.
struct TmoveSmem {
  int st, rot, us, ua, qp, wq, rq, uq, E, ao, mo, jp, tv, ic, total;
};

__host__ __device__ inline TmoveSmem tmove_smem(int nrows, int nelec, int nprim, int nao,
                                                int nq, int nmax, int G) {
  const int nq2 = nq > 2 ? nq : 2, nq4 = nq > 4 ? nq : 4;
  TmoveSmem m;
  m.st = 0;
  m.rot = m.st + nrows;
  m.us = m.rot + 9 * nelec;
  m.ua = m.us + nelec;
  m.qp = m.ua + nelec;
  m.wq = m.qp + 3 * nq;
  m.rq = m.wq + nq;
  m.uq = m.rq + nq;
  m.E = m.uq + nq;
  m.ao = m.E + nq2 * nprim;
  m.mo = m.ao + nq4 * nao;
  m.jp = m.mo + nq4 * nmax;
  m.tv = m.jp + nq * G;
  m.ic = m.tv + nmax;
  m.total = m.ic + nmax;
  return m;
}

// One basis kind's Jastrow items of electron e (spin s) at each of the nq
// points qp, (point, item) pairs dealt over the lanes: each lane adds its
// terms to its own partial of the point, jp[q * G + lane].
template <typename T, int K, int G>
__device__ __forceinline__ void jastrow_points(const lg::JastrowTab<T>& jt, int lane, int nq,
                                               const T* qp, int e, int s, const T* pos, T* jp) {
  const int cnt = jt.count(K);
  for (int i = lane; i < nq * cnt; i += G) {
    const int q = i / cnt;
    jp[q * G + lane] += jt.template eval<K, false>(
        jt.template item<K>(i - q * cnt, qp[3 * q], qp[3 * q + 1], qp[3 * q + 2], e, s, pos),
        nullptr);
  }
}

template <typename T, int NMAX, int G>
__global__ void __launch_bounds__(lg::THREADS)
    tmove_sweep_kernel(const T* __restrict__ state_in, T* __restrict__ state_out,
                       const T* __restrict__ rot, const T* __restrict__ usel,
                       const T* __restrict__ uacc, const T* __restrict__ tab_g, int ntab,
                       const int* __restrict__ meta_g, int nmeta, const int* __restrict__ plan_g,
                       int nplan, int nconf, int nrows, int nq, int W, T tau) {
  T* tab;
  int* meta;
  int* plan;
  unsigned char* rest = lg::stage<T>(tab_g, ntab, meta_g, nmeta, plan_g, nplan, &tab, &meta,
                                     &plan);
  const lg::Group<G> grp;
  const int gi = threadIdx.x / G;
  const int w = blockIdx.x * W + gi;
  const int nelec = meta_g[M_NELEC], nao = meta_g[M_NAO];
  const TmoveSmem lay = tmove_smem(nrows, nelec, plan_g[lg::PL_NPRIM], nao, nq, NMAX, G);
  T* ws = reinterpret_cast<T*>(rest) + (size_t)gi * lay.total;
  T* S = ws + lay.st;
  T* rt = ws + lay.rot;
  T* us = ws + lay.us;
  T* ua = ws + lay.ua;
  if (w < nconf) {
    for (int r = grp.lane; r < nrows; r += G) S[r] = state_in[(size_t)w * nrows + r];
    for (int r = grp.lane; r < 9 * nelec; r += G) rt[r] = rot[(size_t)w * 9 * nelec + r];
    for (int e = grp.lane; e < nelec; e += G) {
      us[e] = usel[(size_t)e * nconf + w];
      ua[e] = uacc[(size_t)e * nconf + w];
    }
  }
  __syncthreads();
  if (w >= nconf) return;  // the whole group: no block barrier follows

  T* qp = ws + lay.qp;
  T* wq = ws + lay.wq;
  T* rq = ws + lay.rq;
  T* uq = ws + lay.uq;
  T* E = ws + lay.E;
  T* ao = ws + lay.ao;
  T* mo = ws + lay.mo;
  T* jp = ws + lay.jp;
  const int nup = meta[M_NUP], ndn = meta[M_NDN];
  const int nprim = plan[lg::PL_NPRIM], nshell = plan[lg::PL_NSHELL];
  const bool hasj = meta[M_HASJ] != 0;
  const lg::JastrowTab<T> jt(tab, meta, plan);
  const int off_invu = 3 * nelec;
  const int off_invd = off_invu + nup * nup;
  const int off_phu = off_invd + ndn * ndn;
  const int off_mogu = off_phu + 4;
  const int off_mogd = off_mogu + 4 * nup * nup;
  const int off_u = off_mogd + 4 * ndn * ndn;
  const T rmax = tab[meta[M_F_RMAX]];
  const int* qatoms = meta + meta[M_I_QATOMS];

  for (int e = 0; e < nelec; ++e) {
    const int s = e < nup ? 0 : 1;
    const int n = s ? ndn : nup;
    const int row = s ? e - nup : e;
    const int oinv = s ? off_invd : off_invu;
    const int omog = s ? off_mogd : off_mogu;
    const int oph = off_phu + 2 * s;  // phase; log|det| follows
    const T* C = tab + (s ? meta[M_F_CB] : meta[M_F_CA]);
    const T ex = S[3 * e], ey = S[3 * e + 1], ez = S[3 * e + 2];
    T invrow[NMAX];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) invrow[j] = j < n ? S[oinv + j * n + row] : T(0);
    const T u_old =
        hasj ? lg::jastrow_group<T, false, G>(grp, jt, ex, ey, ez, e, s, S, nullptr) : T(0);

    // 1. the points: weight and position, this lane's Jastrow partials reset
    {
      T R[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = rt[9 * e + k];
      for (int q = grp.lane; q < nq; q += G) {
        int ip = q, qa = 0;
        while (ip >= qatoms[qa * QATOM_INTS + Q_NPTS]) {
          ip -= qatoms[qa * QATOM_INTS + Q_NPTS];
          ++qa;
        }
        QuadAtom<T> atom;
        atom.set(tab, meta, qatoms + qa * QATOM_INTS, ex, ey, ez, rmax, true);
        wq[q] = -tau * atom.point(tab, R, ip, qp[3 * q], qp[3 * q + 1], qp[3 * q + 2], true);
      }
      for (int q = 0; q < nq; ++q) jp[q * G + grp.lane] = T(0);
    }
    grp.sync();
    // the (point, primitive) exponentials and the (point, pair) Jastrow terms
    for (int i = grp.lane; i < nq * nprim; i += G) {
      const int q = i / nprim;
      lg::prim_item<T, false>(tab, plan, i - q * nprim, qp[3 * q], qp[3 * q + 1], qp[3 * q + 2],
                              E + q * nprim);
    }
    jastrow_points<T, BASIS_POLYPADE, G>(jt, grp.lane, nq, qp, e, s, S, jp);
    jastrow_points<T, BASIS_CUTOFFCUSP, G>(jt, grp.lane, nq, qp, e, s, S, jp);
    grp.sync();
    // the (point, shell) AO values
    for (int i = grp.lane; i < nq * nshell; i += G) {
      const int q = i / nshell;
      lg::shell_item<T, false>(tab, meta, plan, i - q * nshell, qp[3 * q], qp[3 * q + 1],
                               qp[3 * q + 2], E + q * nprim, ao + q * nao, 1);
    }
    grp.sync();
    // the (point, orbital) sums of the contraction, AO rows in concat order
    for (int i = grp.lane; i < nq * n; i += G) {
      const int q = i / n, j = i - q * n;
      T acc = T(0);
      for (int r = 0; r < nao; ++r) acc += ao[q * nao + r] * C[r * n + j];
      mo[q * NMAX + j] = acc;
    }
    grp.sync();
    // per point the ratio: orbitals against the inverse column, times the
    // Jastrow value ratio
    for (int q = grp.lane; q < nq; q += G) {
      T r = T(0);
#pragma unroll
      for (int j = 0; j < NMAX; ++j)
        if (j < n) r += mo[q * NMAX + j] * invrow[j];
      if (hasj) {
        T u = T(0);
#pragma unroll
        for (int l = 0; l < G; ++l) u += jp[q * G + l];
        uq[q] = u;
        r *= dexp(u - u_old);
      }
      rq[q] = r;
    }
    grp.sync();

    // 2-3. lane 0: heat-bath selection in quadrature order, the reverse
    // amplitudes and the acceptance; the chosen point, or -1, to the group
    int qsel = -1;
    if (grp.lane == 0) {
      T amp_sum = T(0);
      for (int q = 0; q < nq; ++q) amp_sum += pos_part(wq[q] * rq[q]);
      const T norm = T(1) + amp_sum;
      const T u_s = us[e];
      T cum = T(1) / norm;
      int choice = u_s > cum ? 1 : 0;
      for (int q = 0; q < nq; ++q) {
        cum += pos_part(wq[q] * rq[q]) / norm;
        choice += u_s > cum ? 1 : 0;
      }
      if (choice > 0) {
        const int m = choice - 1 < nq - 1 ? choice - 1 : nq - 1;
        const T r_m = rq[m], w_m = wq[m];
        const T inv_r = dabs(r_m) > T(1e-30) ? T(1) / r_m : T(0);
        T back_sum = T(0);
        for (int q = 0; q < nq; ++q)
          back_sum += q == m ? pos_part(w_m * inv_r) : pos_part(wq[q] * rq[q] * inv_r);
        if (norm / (T(1) + back_sum) > ua[e]) qsel = m;
      }
    }
    qsel = grp.bcast(qsel, 0);
    if (qsel < 0) continue;  // stay

    // 4. the move to the chosen point, dealt over the lanes
    const T nx = qp[3 * qsel], ny = qp[3 * qsel + 1], nz = qp[3 * qsel + 2];
    lg::orbitals_grad<T, NMAX, G>(grp, tab, meta, plan, nx, ny, nz, C, n, E, ao, mo);
    lg::accept_update<T, NMAX, G>(grp, S, mo, ws + lay.tv, ws + lay.ic, oinv, omog, oph, n,
                                  row);
    if (grp.lane == 0) {
      S[3 * e] = nx;
      S[3 * e + 1] = ny;
      S[3 * e + 2] = nz;
      if (hasj) S[off_u] = S[off_u] + (uq[qsel] - u_old);
    }
    grp.sync();
  }
  for (int r = grp.lane; r < nrows; r += G) state_out[(size_t)w * nrows + r] = S[r];
}

template <typename T, int NMAX, int G>
int launch_tmove_g(const T* state_in, T* state_out, const T* rot, const T* usel, const T* uacc,
                   const T* tab, int ntab, const int* meta, int nmeta, const int* plan, int nplan,
                   int nconf, int nrows, int nelec, int nao, int nprim, int nq, double tau,
                   cudaStream_t stream) {
  const size_t base = lg::staged_bytes(ntab, nmeta, nplan, sizeof(T));
  const size_t per_walker =
      (size_t)tmove_smem(nrows, nelec, nprim, nao, nq, NMAX, G).total * sizeof(T);
  const int W = lg::walkers_per_block(G, base, per_walker);
  if (W == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = base + W * per_walker;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tmove_sweep_kernel<T, NMAX, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (nconf + W - 1) / W;
  tmove_sweep_kernel<T, NMAX, G><<<blocks, W * G, smem, stream>>>(
      state_in, state_out, rot, usel, uacc, tab, ntab, meta, nmeta, plan, nplan, nconf, nrows, nq,
      W, T(tau));
  return (int)cudaGetLastError();
}

// nmax: electrons of the larger spin (the NMAX 4 or 16 instance).
template <typename T>
int launch_tmove_sweep(const T* state_in, T* state_out, const T* rot, const T* usel,
                       const T* uacc, const T* tab, int ntab, const int* meta, int nmeta,
                       const int* plan, int nplan, int nconf, int nrows, int nelec, int nao,
                       int nprim, int nq, int nmax, double tau, cudaStream_t stream) {
  if (nmax <= 4)
    return launch_tmove_g<T, 4, LANES>(state_in, state_out, rot, usel, uacc, tab, ntab, meta,
                                       nmeta, plan, nplan, nconf, nrows, nelec, nao, nprim, nq,
                                       tau, stream);
  if (nmax <= 16)
    return launch_tmove_g<T, 16, LANES>(state_in, state_out, rot, usel, uacc, tab, ntab, meta,
                                        nmeta, plan, nplan, nconf, nrows, nelec, nao, nprim, nq,
                                        tau, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace pq

extern "C" {

int pq_tmove_sweep_f32(const void* state_in, void* state_out, const void* rot, const void* usel,
                       const void* uacc, const void* tab, int ntab, const void* meta, int nmeta,
                       const void* plan, int nplan, int nconf, int nrows, int nelec, int nao,
                       int nprim, int nq, int nmax, double tau, void* stream) {
  return pq::launch_tmove_sweep<float>(
      (const float*)state_in, (float*)state_out, (const float*)rot, (const float*)usel,
      (const float*)uacc, (const float*)tab, ntab, (const int*)meta, nmeta, (const int*)plan,
      nplan, nconf, nrows, nelec, nao, nprim, nq, nmax, tau, (cudaStream_t)stream);
}

int pq_tmove_sweep_f64(const void* state_in, void* state_out, const void* rot, const void* usel,
                       const void* uacc, const void* tab, int ntab, const void* meta, int nmeta,
                       const void* plan, int nplan, int nconf, int nrows, int nelec, int nao,
                       int nprim, int nq, int nmax, double tau, void* stream) {
  return pq::launch_tmove_sweep<double>(
      (const double*)state_in, (double*)state_out, (const double*)rot, (const double*)usel,
      (const double*)uacc, (const double*)tab, ntab, (const int*)meta, nmeta, (const int*)plan,
      nplan, nconf, nrows, nelec, nao, nprim, nq, nmax, tau, (cudaStream_t)stream);
}

}  // extern "C"
