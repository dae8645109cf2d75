// Kernel 7: the Metropolis sweep of a periodic Slater-Jastrow wavefunction
// with real (TRIM) k-point orbitals, one warp per walker.
//
// Replaces pyqmc_tpu/ops/move_pallas_pbc.py:build_fused_sweep_pbc in both
// of its modes. A template over `bool DMC` as sweep_kernel.cuh is; both
// instances are built and bound here (pq_pbc_sweep_*, the vmc mode, and
// pq_pbc_dmc_sweep_*, the dmc mode; pyqmc_tpu_torch/ops/move_sweep_pbc.py).
// Per electron move, with the algebra of the Pallas kernel:
//   drift at the current position from the cached orbital row and the
//   inverse column, plus the Jastrow gradient; the proposal on the
//   pre-drawn gauss, folded into the supercell (frac -> floor -> back) with
//   the wrap delta kept; the folded point folded again into the primitive
//   cell, each orbital column taking the sign cos(k . wA) > 0 ? 1 : -1 of
//   its k-point (TRIM phases are +-1); the replicated-shell AOs (values and
//   gradients) contracted with the folded coefficients R on the fly; the
//   Jastrow minimal image by rounding with the supercell constants;
//   acceptance |ratio|^2 t_prob > unif; the Sherman-Morrison update of the
//   inverse, phase, log|det|, the orbital cache row and U.
// The dmc mode differs where the Pallas kernel branches on `mode`:
//   drift limiting  Umrigar's, v * (sqrt(1 + 2 taueff) - 1) / taueff with
//                   taueff = max(|v|^2 tau, 1e-12), at the old and the new
//                   position (move_pallas_pbc.py:415-423; limdrift in
//                   sweep_kernel.cuh);
//   fixed node      a move with ratio <= 0 is rejected (:505-507); the
//                   ratio is a butterfly sum times exp(du), the same bits
//                   on every lane, and lane 0's decision is broadcast;
//   outputs         per walker, r2p, the sum over every proposal of
//                   |gauss + tau drift_old|^2 with the limited old drift,
//                   and r2a, the same sum over the accepted moves only
//                   (:510-516, :583-588), in rows 1 and 2 of `sums`.
//
// Design. One warp is one walker; lane j owns orbital column j of the
// moving electron's spin (at most 32 per spin), so its four accumulators
// (value and gradient of mo_j) and its column of the inverse update are
// its own. The AOs are evaluated shell by shell, one shell per lane, into
// a per-warp shared buffer; then every lane runs over the buffer's AOs
// with its own column of R. The Jastrow sums run over atoms and electrons
// split across the lanes and end in a butterfly reduction, which leaves
// the same bits on every lane, so the accept decision is the warp's. R
// (nao_repl x (nup + ndn), concat row order) sits in shared memory where
// it fits (f32: 125 KB at the diamond supercell's 489 x 64) and is read
// through L2 otherwise; the basis and lattice tables sit in shared memory.
// The walker's state row (walker-major: row r of walker w at
// [w * nrows + r], so the lanes of a warp touch neighbouring addresses) is
// copied from state_in to state_out and updated there; its positions are
// mirrored in the warp's shared buffer for the Jastrow sums. Every warp
// reads and writes only its own walker, so a block holding fewer walkers
// than warps, or a grid of many blocks, is safe.
//
// What bounds it: latency. Per move a lane does about 7 shell evaluations
// (183 shells over 32 lanes) and 489 x 4 multiply-adds against shared
// memory; 500 walkers are 500 warps, under 4 per SM of an H100.
#include <cuda_runtime.h>

#include "ao_shell.cuh"
#include "sweep_kernel.cuh"

namespace pq {

enum PbcSlot {
  P_NELEC = 0,
  P_NUP,
  P_NDN,
  P_NAO,       // replicated-shell AOs
  P_NGROUPS,
  P_I_GROUPS,  // (ngroups, GROUP_INTS), sj_device.cuh
  P_NK,
  P_F_KPTS,    // (nk, 3)
  P_I_KORB,    // (nup + ndn,) k index of each orbital column
  P_F_SLAT,    // supercell lattice (3, 3), rows are vectors
  P_F_SLATI,   // its inverse
  P_F_PLAT,    // primitive lattice
  P_F_PLATI,
  P_HASJ,
  P_NATOM,
  P_NA,
  P_NB,
  P_F_ATOMS,
  P_F_ABAS,
  P_F_BBAS,
  P_I_AKIND,
  P_I_BKIND,
  P_F_ACOEFF,  // (natom, na, 2)
  P_F_BCOEFF,  // (nb, 3)
  P_HEADER
};

constexpr int PBC_WARPS = 4;  // walkers per block
constexpr unsigned FULL = 0xffffffffu;
constexpr int AOB_PER_LANE = 4 * (2 * LMAX + 1);

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float drint(float x) { return rintf(x); }
__device__ __forceinline__ double drint(double x) { return rint(x); }
__device__ __forceinline__ float dfloor(float x) { return floorf(x); }
__device__ __forceinline__ double dfloor(double x) { return floor(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }

// row vector times a 3x3 matrix (row-major): f_j = sum_i v_i M[i][j]
template <typename T>
__device__ __forceinline__ void frac3(const T* M, T x, T y, T z, T& a, T& b, T& c) {
  a = x * M[0] + y * M[3] + z * M[6];
  b = x * M[1] + y * M[4] + z * M[7];
  c = x * M[2] + y * M[5] + z * M[8];
}

// rounding minimal image with the supercell lattice
template <typename T>
__device__ __forceinline__ void mi_super(const T* lat, const T* lati, T& dx, T& dy, T& dz) {
  T fx, fy, fz;
  frac3(lati, dx, dy, dz, fx, fy, fz);
  frac3(lat, fx - drint(fx), fy - drint(fy), fz - drint(fz), dx, dy, dz);
}

// Jastrow terms of electron e (spin s) at (x, y, z), the sums split over
// the lanes: returns u on every lane and the gradient in g.
template <typename T>
__device__ __forceinline__ T jastrow_warp(const T* tab, const int* meta, T x, T y, T z, int e,
                                          int s, const T* pos, int lane, T* g) {
  const int natom = meta[P_NATOM], na = meta[P_NA], nb = meta[P_NB];
  const int nup = meta[P_NUP], nelec = meta[P_NELEC];
  const T* lat = tab + meta[P_F_SLAT];
  const T* lati = tab + meta[P_F_SLATI];
  const T* atoms = tab + meta[P_F_ATOMS];
  const T* acoeff = tab + meta[P_F_ACOEFF];
  const T* bcoeff = tab + meta[P_F_BCOEFF];
  const T* abas = tab + meta[P_F_ABAS];
  const T* bbas = tab + meta[P_F_BBAS];
  const int* akind = meta + meta[P_I_AKIND];
  const int* bkind = meta + meta[P_I_BKIND];
  T u = T(0), gx = T(0), gy = T(0), gz = T(0);
  for (int I = lane; I < natom; I += 32) {
    T dx = x - atoms[3 * I], dy = y - atoms[3 * I + 1], dz = z - atoms[3 * I + 2];
    mi_super(lat, lati, dx, dy, dz);
    const T r = dsqrt(dx * dx + dy * dy + dz * dz);
    for (int k = 0; k < na; ++k) {
      T v, fo;
      basis_eval<T>(akind[k], abas[2 * k], abas[2 * k + 1], r, v, fo);
      const T w = acoeff[(I * na + k) * 2 + s];
      u += w * v;
      gx += w * fo * dx;
      gy += w * fo * dy;
      gz += w * fo * dz;
    }
  }
  for (int j = lane; j < nelec; j += 32) {
    if (j == e) continue;
    T dx = x - pos[3 * j], dy = y - pos[3 * j + 1], dz = z - pos[3 * j + 2];
    mi_super(lat, lati, dx, dy, dz);
    const T r = dsqrt(dx * dx + dy * dy + dz * dz);
    const int ch = s + (j >= nup ? 1 : 0);
    for (int k = 0; k < nb; ++k) {
      T v, fo;
      basis_eval<T>(bkind[k], bbas[2 * k], bbas[2 * k + 1], r, v, fo);
      const T w = bcoeff[k * 3 + ch];
      u += w * v;
      gx += w * fo * dx;
      gy += w * fo * dy;
      gz += w * fo * dz;
    }
  }
  g[0] = warp_sum(gx);
  g[1] = warp_sum(gy);
  g[2] = warp_sum(gz);
  return warp_sum(u);
}

// One l-group's AOs (values and gradients) at (x, y, z), one shell per
// lane per round, contracted with column `col` of R by every active lane.
template <typename T, int L>
__device__ __forceinline__ void group_warp(const T* tab, const int* grp, T x, T y, T z,
                                           const T* R, int ntot, int col, bool act, T* aob,
                                           int lane, T* mo) {
  constexpr int NS = 2 * L + 1;
  const int S = grp[G_S], row0 = grp[G_ROW];
  for (int base = 0; base < S; base += 32) {
    const int si = base + lane;
    if (si < S) {
      T v[NS], gx[NS], gy[NS], gz[NS];
      shell_one<T, L, 1>(tab, grp, si, x, y, z, v, gx, gy, gz, nullptr);
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        T* b = aob + (lane * NS + q) * 4;
        b[0] = v[q];
        b[1] = gx[q];
        b[2] = gy[q];
        b[3] = gz[q];
      }
    }
    __syncwarp();
    if (act) {
      const int cnt = S - base < 32 ? S - base : 32;
      for (int t = 0; t < cnt; ++t) {
#pragma unroll
        for (int q = 0; q < NS; ++q) {
          const T* b = aob + (t * NS + q) * 4;
          const T rv = R[(size_t)(row0 + (base + t) * NS + q) * ntot + col];
          mo[0] += b[0] * rv;
          mo[1] += b[1] * rv;
          mo[2] += b[2] * rv;
          mo[3] += b[3] * rv;
        }
      }
    }
    __syncwarp();
  }
}

template <typename T, bool DMC>
__global__ void __launch_bounds__(32 * PBC_WARPS)
    pbc_sweep_kernel(const T* __restrict__ state_in, T* __restrict__ state_out,
                     const T* __restrict__ gauss, const T* __restrict__ unif,
                     T* __restrict__ wrapd, T* __restrict__ sums, const T* __restrict__ R_g,
                     const T* __restrict__ tab_g, int ntab, const int* __restrict__ meta_g,
                     int nmeta, int nconf, int nrows, T tstep, T drift_cutoff, int r_in_smem) {
  T* tab;
  int* meta;
  unsigned char* rest = stage_tables<T>(tab_g, ntab, meta_g, nmeta, &tab, &meta);
  __syncthreads();
  const int nelec = meta[P_NELEC], nup = meta[P_NUP], ndn = meta[P_NDN];
  const int ntot = nup + ndn;
  const size_t rcount = (size_t)meta[P_NAO] * ntot;
  const T* R = R_g;
  if (r_in_smem) {
    T* rs = reinterpret_cast<T*>(rest);
    for (size_t i = threadIdx.x; i < rcount; i += blockDim.x) rs[i] = R_g[i];
    R = rs;
    rest += ((rcount * sizeof(T) + 15) / 16) * 16;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* pos = reinterpret_cast<T*>(rest) + (size_t)warp * (3 * nelec + 32 * AOB_PER_LANE);
  T* aob = pos + 3 * nelec;
  __syncthreads();
  const int w = blockIdx.x * PBC_WARPS + warp;
  if (w >= nconf) return;  // the whole warp: no block-wide barrier follows

  const T* Sin = state_in + (size_t)w * nrows;
  T* S = state_out + (size_t)w * nrows;
  T* wd = wrapd + (size_t)w * 3 * nelec;
  for (int r = lane; r < nrows; r += 32) S[r] = Sin[r];
  for (int r = lane; r < 3 * nelec; r += 32) {
    pos[r] = Sin[r];
    wd[r] = T(0);
  }
  __syncwarp();

  const bool hasj = meta[P_HASJ] != 0;
  const T* slat = tab + meta[P_F_SLAT];
  const T* slati = tab + meta[P_F_SLATI];
  const T* plat = tab + meta[P_F_PLAT];
  const T* plati = tab + meta[P_F_PLATI];
  const T* kpts = tab + meta[P_F_KPTS];
  const int* korb = meta + meta[P_I_KORB];
  const int ngroups = meta[P_NGROUPS];
  const int* groups = meta + meta[P_I_GROUPS];
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
    const bool act = lane < n;
    const T ex = pos[3 * e], ey = pos[3 * e + 1], ez = pos[3 * e + 2];

    // drift at the current position: the cached orbital row against the
    // inverse column, lane j holding term j
    const T invrow = act ? S[oinv + lane * n + row] : T(0);
    T r4[4];
#pragma unroll
    for (int slot = 0; slot < 4; ++slot)
      r4[slot] = warp_sum(act ? S[omog + (row * 4 + slot) * n + lane] * invrow : T(0));
    T g_old[3] = {r4[1] / r4[0], r4[2] / r4[0], r4[3] / r4[0]};
    T u_old = T(0);
    if (hasj) {
      T gj[3];
      u_old = jastrow_warp<T>(tab, meta, ex, ey, ez, e, s, pos, lane, gj);
      g_old[0] += gj[0];
      g_old[1] += gj[1];
      g_old[2] += gj[2];
    }
    limdrift<T, DMC>(g_old, tstep, drift_cutoff);

    // proposal, folded into the supercell
    const T* ga = gauss + ((size_t)w * nelec + e) * 3;
    const T gax = ga[0], gay = ga[1], gaz = ga[2];
    T fx, fy, fz;
    frac3(slati, ex + gax + tstep * g_old[0], ey + gay + tstep * g_old[1],
          ez + gaz + tstep * g_old[2], fx, fy, fz);
    const T wx = dfloor(fx), wy = dfloor(fy), wz = dfloor(fz);
    T nx, ny, nz;
    frac3(slat, fx - wx, fy - wy, fz - wz, nx, ny, nz);

    // primitive fold and this lane's TRIM sign
    T px, py, pz;
    frac3(plati, nx, ny, nz, px, py, pz);
    const T vx = dfloor(px), vy = dfloor(py), vz = dfloor(pz);
    T xf, yf, zf, cx, cy, cz;
    frac3(plat, px - vx, py - vy, pz - vz, xf, yf, zf);
    frac3(plat, vx, vy, vz, cx, cy, cz);
    const int col = s * nup + lane;
    T sg = T(1);
    if (act) {
      const T* k = kpts + 3 * korb[col];
      sg = dcos(cx * k[0] + cy * k[1] + cz * k[2]) > T(0) ? T(1) : T(-1);
    }

    // orbital value and gradient of column `col` at the proposal
    T mo[4] = {T(0), T(0), T(0), T(0)};
    for (int gi = 0; gi < ngroups; ++gi) {
      const int* grp = groups + gi * GROUP_INTS;
      switch (grp[G_L]) {
        case 0: group_warp<T, 0>(tab, grp, xf, yf, zf, R, ntot, col, act, aob, lane, mo); break;
        case 1: group_warp<T, 1>(tab, grp, xf, yf, zf, R, ntot, col, act, aob, lane, mo); break;
        case 2: group_warp<T, 2>(tab, grp, xf, yf, zf, R, ntot, col, act, aob, lane, mo); break;
        default: group_warp<T, 3>(tab, grp, xf, yf, zf, R, ntot, col, act, aob, lane, mo); break;
      }
    }
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) mo[slot] *= sg;

    T ratio = warp_sum(mo[0] * invrow);
    T gn[3] = {warp_sum(mo[1] * invrow) / ratio, warp_sum(mo[2] * invrow) / ratio,
               warp_sum(mo[3] * invrow) / ratio};
    T du = T(0);
    if (hasj) {
      T gj[3];
      const T u_new = jastrow_warp<T>(tab, meta, nx, ny, nz, e, s, pos, lane, gj);
      du = u_new - u_old;
      ratio *= dexp(du);
      gn[0] += gj[0];
      gn[1] += gj[1];
      gn[2] += gj[2];
    }
    limdrift<T, DMC>(gn, tstep, drift_cutoff);

    // Metropolis-Hastings acceptance (the same bits on every lane; lane 0's
    // decision is broadcast all the same)
    const T forward = gax * gax + gay * gay + gaz * gaz;
    const T bx = gax + tstep * (g_old[0] + gn[0]);
    const T by = gay + tstep * (g_old[1] + gn[1]);
    const T bz = gaz + tstep * (g_old[2] + gn[2]);
    const T backward = bx * bx + by * by + bz * bz;
    const T t_prob = dexp((forward - backward) / (T(2) * tstep));
    T accept_prob = dabs(ratio) * dabs(ratio) * t_prob;
    if (DMC && ratio <= T(0)) accept_prob = T(0);  // fixed node
    const bool accept =
        __shfl_sync(FULL, (int)(accept_prob > unif[(size_t)w * nelec + e]), 0) != 0;
    if (DMC) {
      const T qx = gax + tstep * g_old[0], qy = gay + tstep * g_old[1],
              qz = gaz + tstep * g_old[2];
      const T r2 = qx * qx + qy * qy + qz * qz;
      r2p += r2;
      if (accept) r2a += r2;
    }
    if (accept) {
      nacc += T(1);
      // Sherman-Morrison: t_j = sum_k mo_k inv[k, j]; lane j updates
      // column j of the inverse, using the old column `row` (invrow)
      T t = T(0);
      for (int k = 0; k < n; ++k) {
        const T mk = __shfl_sync(FULL, mo[0], k);
        if (act) t += mk * S[oinv + k * n + lane];
      }
      const T rsm = __shfl_sync(FULL, t, row);
      for (int i = 0; i < n; ++i) {
        const T coli = __shfl_sync(FULL, invrow, i);
        if (act) {
          T* a = S + oinv + i * n + lane;
          *a = lane == row ? coli / rsm : *a - coli * t / rsm;
        }
      }
      if (act) {
#pragma unroll
        for (int slot = 0; slot < 4; ++slot) S[omog + (row * 4 + slot) * n + lane] = mo[slot];
      }
      if (lane == 0) {
        const T absr = dabs(rsm);
        const T safe = absr == T(0) ? T(1) : absr;
        S[oph] = S[oph] * (rsm / safe);
        S[oph + 1] = S[oph + 1] + dlog(safe);
        pos[3 * e] = S[3 * e] = nx;
        pos[3 * e + 1] = S[3 * e + 1] = ny;
        pos[3 * e + 2] = S[3 * e + 2] = nz;
        wd[3 * e] += wx;
        wd[3 * e + 1] += wy;
        wd[3 * e + 2] += wz;
        if (hasj) S[off_u] = S[off_u] + du;
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    sums[w] = nacc;
    if (DMC) {
      sums[(size_t)nconf + w] = r2p;
      sums[2 * (size_t)nconf + w] = r2a;
    }
  }
}

template <typename T, bool DMC>
int launch_pbc_sweep(const T* state_in, T* state_out, const T* gauss, const T* unif, T* wrapd,
                     T* sums, const T* R, const T* tab, int ntab, const int* meta, int nmeta,
                     int nconf, int nrows, double tstep, double drift_cutoff, int nao, int ntot,
                     int nelec, cudaStream_t stream) {
  const size_t base = tables_bytes(ntab, nmeta, sizeof(T));
  const size_t rbytes = (((size_t)nao * ntot * sizeof(T) + 15) / 16) * 16;
  const size_t wbytes = (size_t)PBC_WARPS * (3 * nelec + 32 * AOB_PER_LANE) * sizeof(T);
  const int r_in_smem = base + rbytes + wbytes <= 220 * 1024 ? 1 : 0;
  const size_t smem = base + (r_in_smem ? rbytes : 0) + wbytes;
  cudaError_t err = cudaFuncSetAttribute(pbc_sweep_kernel<T, DMC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (nconf + PBC_WARPS - 1) / PBC_WARPS;
  pbc_sweep_kernel<T, DMC><<<blocks, 32 * PBC_WARPS, smem, stream>>>(
      state_in, state_out, gauss, unif, wrapd, sums, R, tab, ntab, meta, nmeta, nconf, nrows,
      T(tstep), T(drift_cutoff), r_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace pq

extern "C" {

int pq_pbc_sweep_f32(const void* state_in, void* state_out, const void* gauss, const void* unif,
                     void* wrapd, void* sums, const void* R, const void* tab, int ntab,
                     const void* meta, int nmeta, int nconf, int nrows, int nao, int ntot,
                     int nelec, double tstep, double drift_cutoff, void* stream) {
  return pq::launch_pbc_sweep<float, false>(
      (const float*)state_in, (float*)state_out, (const float*)gauss, (const float*)unif,
      (float*)wrapd, (float*)sums, (const float*)R, (const float*)tab, ntab, (const int*)meta,
      nmeta, nconf, nrows, tstep, drift_cutoff, nao, ntot, nelec, (cudaStream_t)stream);
}

int pq_pbc_sweep_f64(const void* state_in, void* state_out, const void* gauss, const void* unif,
                     void* wrapd, void* sums, const void* R, const void* tab, int ntab,
                     const void* meta, int nmeta, int nconf, int nrows, int nao, int ntot,
                     int nelec, double tstep, double drift_cutoff, void* stream) {
  return pq::launch_pbc_sweep<double, false>(
      (const double*)state_in, (double*)state_out, (const double*)gauss, (const double*)unif,
      (double*)wrapd, (double*)sums, (const double*)R, (const double*)tab, ntab,
      (const int*)meta, nmeta, nconf, nrows, tstep, drift_cutoff, nao, ntot, nelec,
      (cudaStream_t)stream);
}

int pq_pbc_dmc_sweep_f32(const void* state_in, void* state_out, const void* gauss,
                         const void* unif, void* wrapd, void* sums, const void* R, const void* tab,
                         int ntab, const void* meta, int nmeta, int nconf, int nrows, int nao,
                         int ntot, int nelec, double tstep, void* stream) {
  return pq::launch_pbc_sweep<float, true>(
      (const float*)state_in, (float*)state_out, (const float*)gauss, (const float*)unif,
      (float*)wrapd, (float*)sums, (const float*)R, (const float*)tab, ntab, (const int*)meta,
      nmeta, nconf, nrows, tstep, 0.0, nao, ntot, nelec, (cudaStream_t)stream);
}

int pq_pbc_dmc_sweep_f64(const void* state_in, void* state_out, const void* gauss,
                         const void* unif, void* wrapd, void* sums, const void* R, const void* tab,
                         int ntab, const void* meta, int nmeta, int nconf, int nrows, int nao,
                         int ntot, int nelec, double tstep, void* stream) {
  return pq::launch_pbc_sweep<double, true>(
      (const double*)state_in, (double*)state_out, (const double*)gauss, (const double*)unif,
      (double*)wrapd, (double*)sums, (const double*)R, (const double*)tab, ntab,
      (const int*)meta, nmeta, nconf, nrows, tstep, 0.0, nao, ntot, nelec,
      (cudaStream_t)stream);
}

}  // extern "C"
