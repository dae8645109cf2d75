// Nonlocal ECP energy of a Slater-Jastrow wavefunction, a group of G lanes
// per walker, one launch.
//
// Replaces pyqmc_tpu/ops/move_pallas.py:build_fused_ecp_energy, the Pallas
// TPU kernel. Per walker: nl = sum_e sum_q T_q ratio_q over the electrons e
// and the quadrature points q around every nonlocal atom (the point on the
// sphere through the electron, rotated by the electron's own rotation),
// with T_q the radial channels times the Legendre projectors and
//   ratio_q = (sum_k ao_k(x_q) wvec_k) exp(u_q - u_old),
// wvec = C_s inv[:, row(e)] folded once per electron (the Pallas kernel's
// form: one nao-long dot per point), u the electron's Jastrow terms at the
// point and at its own position. Quadrature order, rsafe, the r < rmax
// mask, the (2l+1) factor and the r^(n-2) powers are ecp_device.cuh's.
//
// Design (lane_group.cuh): a walker is a group of G = LANES lanes of one
// warp, 128 / G walkers a block (fewer where their shared memory would not
// fit). The lanes stage the walker's positions, inverses and rotations
// into shared memory from where they lie (a walker stride and, for the
// inverses, row and column strides: no transposed copy), then deal two
// lists of items over the lanes:
//   1. the (electron, AO row) sums of the fold;
//   2. the walker's positions: every (electron, point) of the quadrature
//      (its T_q and position, its AO values shell by shell from the plan's
//      live primitives, dotted with the electron's wvec as they come, and
//      its Jastrow u), then every electron's own position (its u_old).
// A position is one lane's whole item, so the lanes of a warp run the
// same code on different points without branching apart (the Jastrow's
// distance once per atom and electron, then its bases), with no index
// arithmetic per term and only each position's results in shared memory.
// Dealing finer items (each exponential, shell and Jastrow term on its
// own, over shared-memory scratch) was slower than the one thread per
// (walker, electron) it replaces, and two positions side by side per lane
// gained 3% for spilled registers (PERF.md). Then each lane adds T_q
// ratio_q of its points in order and the group sums the lanes' partials by
// the butterfly: no second kernel, no atomics, no scratch in device
// memory, the same bits from run to run. The arithmetic of each term is
// ecp_device.cuh's, sj_device.cuh's and lane_group.cuh's, term for term
// the plain version's; only the order of the sums changes.
//
// Layout: positions (nconf, nelec, 3), walker stride pos_sw; inv_up and
// inv_dn (nconf, n, n) with strides (sw, si, sj); rot (nelec, nconf, 3, 3)
// contiguous, row-major 3x3; out (nconf,).
//
// What bounds it: latency and instruction issue: per walker 56 positions
// (ccECP H2O: 48 points and 8 electrons) of 41 exponentials, 11 shells
// and 40 Jastrow terms with their divisions, two rounds of 32 lanes; its
// operation bound is about 2 us per 2048 walkers.
#include <cuda_runtime.h>

#include "ecp_device.cuh"
#include "lane_group.cuh"
#include "sj_device.cuh"

namespace pq {

// lanes per walker: the fastest of 8, 16 and 32 at 2048 ccECP H2O walkers
// on an H100 (tools/time_k1_k5.py, PERF.md). ops/ecp_energy.py mirrors it
// and the layout below.
constexpr int LANES = 32;

// A walker's shared memory, in elements of T: positions, both inverses
// (row-major), rotations, the folded wvec (nelec, nao); per (electron,
// point) T_q and the Slater ratio; per position (the points, then the
// electrons' own) the Jastrow u.
struct EcpSmem {
  int pos, inv, rot, wv, tq, sr, uq, total;
};

__host__ __device__ inline EcpSmem ecp_smem(int nelec, int nup, int ndn, int nao, int nq) {
  EcpSmem m;
  m.pos = 0;
  m.inv = m.pos + 3 * nelec;
  m.rot = m.inv + nup * nup + ndn * ndn;
  m.wv = m.rot + 9 * nelec;
  m.tq = m.wv + nelec * nao;
  m.sr = m.tq + nelec * nq;
  m.uq = m.sr + nelec * nq;
  m.total = m.uq + nelec * (nq + 1);
  return m;
}

// One shell's 2L+1 AO values at (rx, ry, rz) from its radial sum g0,
// dotted with f (the shell's rows of wvec), added to acc in row order.
template <typename T, int L>
__device__ __forceinline__ T shell_dot(const T* cw, T rx, T ry, T rz, T g0, const T* f, T acc) {
  T v[2 * L + 1];
  lg::shell_rows<T, L, false>(cw, rx, ry, rz, g0, T(0), v, 1);
#pragma unroll
  for (int q = 0; q < 2 * L + 1; ++q) acc += v[q] * f[q];
  return acc;
}

// The Slater part of a point's ratio, sum_k ao_k(x, y, z) f_k over the AO
// rows in concat order: shell by shell, its radial sum over its live
// primitives in order (the plan's; lane_group.cuh prim_item and
// shell_item's terms).
template <typename T>
__device__ __forceinline__ T ao_dot(const T* tab, const int* meta, const int* plan, T x, T y,
                                    T z, const T* f) {
  const int nprim = plan[lg::PL_NPRIM], nshell = plan[lg::PL_NSHELL];
  const int* prims = plan + lg::PL_HEADER;
  const int* shells = prims + lg::PRIM_INTS * nprim;
  T acc = T(0);
  for (int i = 0; i < nshell; ++i) {
    const int* s = shells + lg::SHELL_INTS * i;
    const int* grp = meta + meta[M_I_GROUPS] + s[0] * GROUP_INTS;
    const T* cen = tab + grp[G_F_CEN] + 3 * s[1];
    const T rx = x - cen[0], ry = y - cen[1], rz = z - cen[2];
    const T r2 = rx * rx + ry * ry + rz * rz;
    T g0 = T(0);
#pragma unroll 4
    for (int k = s[2]; k < s[2] + s[3]; ++k) {
      const int* p = prims + lg::PRIM_INTS * k;
      g0 += tab[p[2]] * dexp(-tab[p[1]] * r2);
    }
    const int l = grp[G_L];
    const T* cw = tab + grp[G_F_CW];
    const T* fr = f + grp[G_ROW] + s[1] * (2 * l + 1);
    switch (l) {
      case 0: acc = shell_dot<T, 0>(cw, rx, ry, rz, g0, fr, acc); break;
      case 1: acc = shell_dot<T, 1>(cw, rx, ry, rz, g0, fr, acc); break;
      case 2: acc = shell_dot<T, 2>(cw, rx, ry, rz, g0, fr, acc); break;
      default: acc = shell_dot<T, 3>(cw, rx, ry, rz, g0, fr, acc); break;
    }
  }
  return acc;
}

// A Jastrow basis's value at r, its kind known at run time (the same for
// every lane: all lanes walk the same bases).
template <typename T>
__device__ __forceinline__ T basis_value(int kind, T param, T rcut, T r) {
  T v, fo;
  if (kind == BASIS_POLYPADE)
    basis_kind<T, BASIS_POLYPADE>(param, rcut, r, v, fo);
  else
    basis_kind<T, BASIS_CUTOFFCUSP>(param, rcut, r, v, fo);
  return v;
}

// The Jastrow u of electron e placed at (x, y, z): per atom, then per
// other electron j (at pos[3 j]), the distance once and every basis at it
// (the basis loops unrolled, so that a lane's terms overlap).
template <typename T>
__device__ __forceinline__ T jastrow_u(const T* tab, const int* meta, T x, T y, T z, int e,
                                       const T* pos) {
  const int natom = meta[M_NATOM], na = meta[M_NA], nb = meta[M_NB];
  const int nup = meta[M_NUP], nelec = meta[M_NELEC];
  const T* atoms = tab + meta[M_F_ATOMS];
  const T* abas = tab + meta[M_F_ABAS];
  const T* bbas = tab + meta[M_F_BBAS];
  const int* akind = meta + meta[M_I_AKIND];
  const int* bkind = meta + meta[M_I_BKIND];
  const int s = e < nup ? 0 : 1;
  T u = T(0);
  for (int I = 0; I < natom; ++I) {
    const T dx = x - atoms[3 * I], dy = y - atoms[3 * I + 1], dz = z - atoms[3 * I + 2];
    const T r = dsqrt(dx * dx + dy * dy + dz * dz);
    const T* w = tab + meta[M_F_ACOEFF] + 2 * I * na + s;
#pragma unroll 4
    for (int k = 0; k < na; ++k)
      u += w[2 * k] * basis_value(akind[k], abas[2 * k], abas[2 * k + 1], r);
  }
  for (int j = 0; j < nelec; ++j) {
    if (j == e) continue;
    const T dx = x - pos[3 * j], dy = y - pos[3 * j + 1], dz = z - pos[3 * j + 2];
    const T r = dsqrt(dx * dx + dy * dy + dz * dz);
    const T* w = tab + meta[M_F_BCOEFF] + s + (j >= nup ? 1 : 0);
#pragma unroll 4
    for (int k = 0; k < nb; ++k)
      u += w[3 * k] * basis_value(bkind[k], bbas[2 * k], bbas[2 * k + 1], r);
  }
  return u;
}

// (THREADS, 1) lifts ptxas' register cap for many resident blocks: without
// it the float32 instances were held to 64 registers and spilled; at 95,
// five blocks still fit an SM, more than 2048 walkers (512 blocks) need.
template <typename T, int NMAX, int G>
__global__ void __launch_bounds__(lg::THREADS, 1)
    ecp_energy_kernel(const T* __restrict__ pos, int pos_sw, const T* __restrict__ invu,
                      int invu_sw, int invu_si, int invu_sj, const T* __restrict__ invd,
                      int invd_sw, int invd_si, int invd_sj, const T* __restrict__ rot,
                      T* __restrict__ out, const T* __restrict__ tab_g, int ntab,
                      const int* __restrict__ meta_g, int nmeta, const int* __restrict__ plan_g,
                      int nplan, int nconf, int nq, int W) {
  T* tab;
  int* meta;
  int* plan;
  unsigned char* rest = lg::stage<T>(tab_g, ntab, meta_g, nmeta, plan_g, nplan, &tab, &meta,
                                     &plan);
  const lg::Group<G> grp;
  const int gi = threadIdx.x / G;
  const int w = blockIdx.x * W + gi;
  const int nelec = meta_g[M_NELEC], nup = meta_g[M_NUP], ndn = meta_g[M_NDN];
  const int nao = meta_g[M_NAO];
  const EcpSmem lay = ecp_smem(nelec, nup, ndn, nao, nq);
  T* ws = reinterpret_cast<T*>(rest) + (size_t)gi * lay.total;
  T* P = ws + lay.pos;
  T* iv = ws + lay.inv;
  T* rt = ws + lay.rot;
  if (w < nconf) {
    const T* pw = pos + (size_t)w * pos_sw;
    for (int r = grp.lane; r < 3 * nelec; r += G) P[r] = pw[r];
    const T* iu = invu + (size_t)w * invu_sw;
    for (int r = grp.lane; r < nup * nup; r += G) {
      const int i = r / nup, j = r - i * nup;
      iv[r] = iu[(size_t)i * invu_si + (size_t)j * invu_sj];
    }
    const T* id = invd + (size_t)w * invd_sw;
    for (int r = grp.lane; r < ndn * ndn; r += G) {
      const int i = r / ndn, j = r - i * ndn;
      iv[nup * nup + r] = id[(size_t)i * invd_si + (size_t)j * invd_sj];
    }
    for (int r = grp.lane; r < 9 * nelec; r += G) {
      const int e = r / 9;
      rt[r] = rot[((size_t)e * nconf + w) * 9 + (r - 9 * e)];
    }
  }
  __syncthreads();
  if (w >= nconf) return;  // the whole group: no block barrier follows

  T* wv = ws + lay.wv;
  T* tq = ws + lay.tq;
  T* sr = ws + lay.sr;
  T* uq = ws + lay.uq;
  const bool hasj = meta[M_HASJ] != 0;

  // 1. the fold wvec[e][k] = sum_j C_s[k, j] inv_s[j, row(e)]
  for (int i = grp.lane; i < nelec * nao; i += G) {
    const int e = i / nao, k = i - e * nao;
    const int s = e < nup ? 0 : 1;
    const int n = s ? ndn : nup, row = s ? e - nup : e;
    const T* C = tab + (s ? meta[M_F_CB] : meta[M_F_CA]) + k * n;
    const T* inv = iv + (s ? nup * nup : 0);
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n) acc += C[j] * inv[j * n + row];
    wv[i] = acc;
  }
  grp.sync();

  // 2. the positions: each (electron, point) with its weight, Slater ratio
  // and Jastrow u, then each electron's own position with its u_old
  const int npts = nelec * nq;
  const T rmax = tab[meta[M_F_RMAX]];
  const int* qatoms = meta + meta[M_I_QATOMS];
  for (int p = grp.lane; p < npts + (hasj ? nelec : 0); p += G) {
    int e;
    T x, y, z;
    if (p < npts) {
      e = p / nq;
      int ip = p - e * nq, qa = 0;
      while (ip >= qatoms[qa * QATOM_INTS + Q_NPTS]) {
        ip -= qatoms[qa * QATOM_INTS + Q_NPTS];
        ++qa;
      }
      QuadAtom<T> atom;
      atom.set(tab, meta, qatoms + qa * QATOM_INTS, P[3 * e], P[3 * e + 1], P[3 * e + 2], rmax,
               true);
      tq[p] = atom.point(tab, rt + 9 * e, ip, x, y, z, true);
      sr[p] = ao_dot(tab, meta, plan, x, y, z, wv + e * nao);
    } else {
      e = p - npts;
      x = P[3 * e];
      y = P[3 * e + 1];
      z = P[3 * e + 2];
    }
    if (hasj) uq[p] = jastrow_u(tab, meta, x, y, z, e, P);
  }
  grp.sync();

  // 3. nl = sum_e sum_q T_q ratio_q: each lane its points in order, then
  // the butterfly over the lanes
  T nl = T(0);
  for (int p = grp.lane; p < npts; p += G) {
    T r = sr[p];
    if (hasj) r *= dexp(uq[p] - uq[npts + p / nq]);
    nl += tq[p] * r;
  }
  nl = grp.sum(nl);
  if (grp.lane == 0) out[w] = nl;
}

template <typename T, int NMAX, int G>
int launch_ecp_g(const T* pos, int pos_sw, const T* invu, int invu_sw, int invu_si, int invu_sj,
                 const T* invd, int invd_sw, int invd_si, int invd_sj, const T* rot, T* out,
                 const T* tab, int ntab, const int* meta, int nmeta, const int* plan, int nplan,
                 int nconf, int nelec, int nup, int ndn, int nao, int nq, cudaStream_t stream) {
  const size_t base = lg::staged_bytes(ntab, nmeta, nplan, sizeof(T));
  const size_t per_walker = (size_t)ecp_smem(nelec, nup, ndn, nao, nq).total * sizeof(T);
  const int W = lg::walkers_per_block(G, base, per_walker);
  if (W == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = base + W * per_walker;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ecp_energy_kernel<T, NMAX, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (nconf + W - 1) / W;
  ecp_energy_kernel<T, NMAX, G><<<blocks, W * G, smem, stream>>>(
      pos, pos_sw, invu, invu_sw, invu_si, invu_sj, invd, invd_sw, invd_si, invd_sj, rot, out,
      tab, ntab, meta, nmeta, plan, nplan, nconf, nq, W);
  return (int)cudaGetLastError();
}

// nmax: electrons of the larger spin (the NMAX 4 or 16 instance).
template <typename T>
int launch_ecp_energy(const T* pos, int pos_sw, const T* invu, int invu_sw, int invu_si,
                      int invu_sj, const T* invd, int invd_sw, int invd_si, int invd_sj,
                      const T* rot, T* out, const T* tab, int ntab, const int* meta, int nmeta,
                      const int* plan, int nplan, int nconf, int nelec, int nup, int ndn, int nao,
                      int nq, int nmax, cudaStream_t stream) {
  if (nmax <= 4)
    return launch_ecp_g<T, 4, LANES>(pos, pos_sw, invu, invu_sw, invu_si, invu_sj, invd, invd_sw,
                                     invd_si, invd_sj, rot, out, tab, ntab, meta, nmeta, plan,
                                     nplan, nconf, nelec, nup, ndn, nao, nq, stream);
  if (nmax <= 16)
    return launch_ecp_g<T, 16, LANES>(pos, pos_sw, invu, invu_sw, invu_si, invu_sj, invd,
                                      invd_sw, invd_si, invd_sj, rot, out, tab, ntab, meta, nmeta,
                                      plan, nplan, nconf, nelec, nup, ndn, nao, nq, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace pq

extern "C" {

int pq_ecp_energy_f32(const void* pos, int pos_sw, const void* invu, int invu_sw, int invu_si,
                      int invu_sj, const void* invd, int invd_sw, int invd_si, int invd_sj,
                      const void* rot, void* out, const void* tab, int ntab, const void* meta,
                      int nmeta, const void* plan, int nplan, int nconf, int nelec, int nup,
                      int ndn, int nao, int nq, int nmax, void* stream) {
  return pq::launch_ecp_energy<float>(
      (const float*)pos, pos_sw, (const float*)invu, invu_sw, invu_si, invu_sj,
      (const float*)invd, invd_sw, invd_si, invd_sj, (const float*)rot, (float*)out,
      (const float*)tab, ntab, (const int*)meta, nmeta, (const int*)plan, nplan, nconf, nelec,
      nup, ndn, nao, nq, nmax, (cudaStream_t)stream);
}

int pq_ecp_energy_f64(const void* pos, int pos_sw, const void* invu, int invu_sw, int invu_si,
                      int invu_sj, const void* invd, int invd_sw, int invd_si, int invd_sj,
                      const void* rot, void* out, const void* tab, int ntab, const void* meta,
                      int nmeta, const void* plan, int nplan, int nconf, int nelec, int nup,
                      int ndn, int nao, int nq, int nmax, void* stream) {
  return pq::launch_ecp_energy<double>(
      (const double*)pos, pos_sw, (const double*)invu, invu_sw, invu_si, invu_sj,
      (const double*)invd, invd_sw, invd_si, invd_sj, (const double*)rot, (double*)out,
      (const double*)tab, ntab, (const int*)meta, nmeta, (const int*)plan, nplan, nconf, nelec,
      nup, ndn, nao, nq, nmax, (cudaStream_t)stream);
}

}  // extern "C"
