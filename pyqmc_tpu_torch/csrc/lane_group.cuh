// Device code of the molecular kernels that give each walker a group of G
// lanes of one warp: K1/K4 (sweep_kernel.cuh), K5 (tmove_sweep.cu) and K2
// (ecp_energy.cu, which reads the plan and the AO rows but deals whole
// quadrature points).
//
// A group is G = 8, 16 or 32 consecutive lanes of a warp. Its lanes share
// the walker's state in shared memory and deal the move's work among them:
// the AO primitives, the AO shells, the (slot, orbital) sums of the
// contraction with the MO coefficients, the Jastrow terms and the entries
// of the Sherman-Morrison update. The group synchronises with
// __syncwarp over its own mask and sums by an xor butterfly over its lanes,
// which leaves the same bits on every lane (a + b == b + a in IEEE
// arithmetic), so no lane has to broadcast a sum. No block barrier is used
// after the tables are staged.
//
// The arithmetic of each term is that of sj_device.cuh and ao_shell.cuh,
// term for term the plain version's: only the order of the sums over
// Jastrow terms changes (a shell's primitives and the contraction's AO rows
// are summed in order by one lane).
//
// The plan (ops/move_sweep.py SJTables.plan, int32): a header (PlanSlot);
// nprim primitives with a nonzero coefficient, shell by shell in concat
// order, each the F offsets of its shell's center, its exponent and its
// coefficient; nshell shells in concat order, each its l-group, its index
// in the group, its first primitive and its primitive count; the e-ion
// Jastrow pairs (atom, basis) of the polypade bases, then of the cutoffcusp
// ones; the e-e bases of each kind. Dealing primitives rather than shells
// keeps the lanes even: for ccECP H2O three of the eleven shells hold 26 of
// the 41 primitives (the padding of each l-group's primitive table to its
// longest shell is skipped; its coefficients are 0, so the sums are
// unchanged). Dealing the Jastrow pairs one basis kind at a time keeps the
// lanes of an iteration on one branch of the basis.
#pragma once

#include <cuda_runtime.h>

#include "ao_shell.cuh"
#include "sj_device.cuh"

namespace pq {
namespace lg {

// plan header: primitives, shells, e-ion pairs of each basis kind
// (polypade, cutoffcusp), e-e bases of each kind
enum PlanSlot { PL_NPRIM = 0, PL_NSHELL, PL_NION, PL_NBK = PL_NION + 2, PL_HEADER = PL_NBK + 2 };
constexpr int PRIM_INTS = 3;   // F offsets of the center, the exponent, the coefficient
constexpr int SHELL_INTS = 4;  // l-group, shell in the group, first primitive, primitives
constexpr int THREADS = 128;   // threads of a block when its walkers fit in shared memory

template <int G>
struct Group {
  static_assert(G == 8 || G == 16 || G == 32, "a group is 8, 16 or 32 lanes");
  unsigned mask;
  int lane;
  __device__ __forceinline__ Group() {
    const int wl = threadIdx.x & 31;
    lane = wl & (G - 1);
    mask = G == 32 ? 0xffffffffu : ((1u << (G & 31)) - 1u) << (wl - lane);
  }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  // the sum over the group's lanes, the same bits on every lane
  template <typename T>
  __device__ __forceinline__ T sum(T v) const {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off, G);
    return v;
  }
  __device__ __forceinline__ int bcast(int v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
};

// Copy the tables and the AO plan into dynamic shared memory (after the
// tables, as stage_tables lays them out); returns the first byte past them,
// 16-byte aligned. The caller synchronises the block before reading them.
template <typename T>
__device__ __forceinline__ unsigned char* stage(const T* __restrict__ tab_g, int ntab,
                                                const int* __restrict__ meta_g, int nmeta,
                                                const int* __restrict__ plan_g, int nplan,
                                                T** tab, int** meta, int** plan) {
  unsigned char* rest = stage_tables<T>(tab_g, ntab, meta_g, nmeta, tab, meta);
  int* p = reinterpret_cast<int*>(rest);
  for (int i = threadIdx.x; i < nplan; i += blockDim.x) p[i] = plan_g[i];
  *plan = p;
  return rest + ((nplan * sizeof(int) + 15) / 16) * 16;
}

__host__ __device__ inline size_t staged_bytes(int ntab, int nmeta, int nplan, size_t tsize) {
  return tables_bytes(ntab, nmeta, tsize) + ((nplan * sizeof(int) + 15) / 16) * 16;
}

// Walkers per block: THREADS / G, fewer where their shared memory would
// pass the 227 KB a block may hold; 0 if not even one fits.
__host__ inline int walkers_per_block(int G, size_t base, size_t per_walker) {
  const size_t limit = 227 * 1024;
  int W = THREADS / G;
  while (W > 0 && base + W * per_walker > limit) --W;
  return W;
}

// Primitive k of the plan at (x, y, z): c exp(-a r^2) into E[k] and, for
// gradients, a c exp(-a r^2) into E[nprim + k] (ao_shell.cuh's g0, g1 terms).
template <typename T, bool GRAD>
__device__ __forceinline__ void prim_item(const T* tab, const int* plan, int k, T x, T y, T z,
                                          T* E) {
  const int* p = plan + PL_HEADER + PRIM_INTS * k;
  const T* c = tab + p[0];
  const T rx = x - c[0], ry = y - c[1], rz = z - c[2];
  const T r2 = rx * rx + ry * ry + rz * rz;
  const T a = tab[p[1]];
  const T ep = tab[p[2]] * dexp(-a * r2);
  E[k] = ep;
  if (GRAD) E[plan[PL_NPRIM] + k] = a * ep;
}

// The 2L+1 spherical AOs of a shell from its radial sums g0 (and g1): the
// monomials and their gradients, mapped with the group's cart->sph weights
// cw (ao_shell.cuh:shell_one). out[q * stride] is AO q's value and, for
// gradients, out[q * stride + 1..3] its gradient.
template <typename T, int L, bool GRAD>
__device__ __forceinline__ void shell_rows(const T* cw, T rx, T ry, T rz, T g0, T g1, T* out,
                                           int stride) {
  constexpr int NS = 2 * L + 1;
  T px[L + 1], py[L + 1], pz[L + 1];
  px[0] = py[0] = pz[0] = T(1);
#pragma unroll
  for (int k = 1; k <= L; ++k) {
    px[k] = px[k - 1] * rx;
    py[k] = py[k - 1] * ry;
    pz[k] = pz[k - 1] * rz;
  }
  T val[NS], gx[NS], gy[NS], gz[NS];
#pragma unroll
  for (int q = 0; q < NS; ++q) val[q] = gx[q] = gy[q] = gz[q] = T(0);
  int c = 0;
#pragma unroll
  for (int i = L; i >= 0; --i) {
#pragma unroll
    for (int j = L - i; j >= 0; --j) {
      const int k = L - i - j;
      const T Pm = px[i] * py[j] * pz[k];
      const T vt = Pm * g0;
      T gtx = T(0), gty = T(0), gtz = T(0);
      if (GRAD) {
        const T m2g1 = T(-2) * Pm * g1;
        gtx = m2g1 * rx + (i > 0 ? T(i) * px[i > 0 ? i - 1 : 0] * py[j] * pz[k] * g0 : T(0));
        gty = m2g1 * ry + (j > 0 ? T(j) * px[i] * py[j > 0 ? j - 1 : 0] * pz[k] * g0 : T(0));
        gtz = m2g1 * rz + (k > 0 ? T(k) * px[i] * py[j] * pz[k > 0 ? k - 1 : 0] * g0 : T(0));
      }
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const T w = cw[c * NS + q];
        val[q] += w * vt;
        if (GRAD) {
          gx[q] += w * gtx;
          gy[q] += w * gty;
          gz[q] += w * gtz;
        }
      }
      ++c;
    }
  }
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    T* o = out + q * stride;
    o[0] = val[q];
    if (GRAD) {
      o[1] = gx[q];
      o[2] = gy[q];
      o[3] = gz[q];
    }
  }
}

// Shell i of the plan at (x, y, z), its primitives' terms in E: its AOs at
// their concat rows of `out` (row r at out[r * stride]).
template <typename T, bool GRAD>
__device__ __forceinline__ void shell_item(const T* tab, const int* meta, const int* plan, int i,
                                           T x, T y, T z, const T* E, T* out, int stride) {
  const int nprim = plan[PL_NPRIM];
  const int* s = plan + PL_HEADER + PRIM_INTS * nprim + SHELL_INTS * i;
  const int* grp = meta + meta[M_I_GROUPS] + s[0] * GROUP_INTS;
  const int si = s[1], k0 = s[2], k1 = s[2] + s[3];
  T g0 = T(0), g1 = T(0);
  for (int k = k0; k < k1; ++k) {
    g0 += E[k];
    if (GRAD) g1 += E[nprim + k];
  }
  const T* cen = tab + grp[G_F_CEN] + 3 * si;
  const T rx = x - cen[0], ry = y - cen[1], rz = z - cen[2];
  const T* cw = tab + grp[G_F_CW];
  const int l = grp[G_L];
  T* o = out + (size_t)(grp[G_ROW] + si * (2 * l + 1)) * stride;
  switch (l) {
    case 0: shell_rows<T, 0, GRAD>(cw, rx, ry, rz, g0, g1, o, stride); break;
    case 1: shell_rows<T, 1, GRAD>(cw, rx, ry, rz, g0, g1, o, stride); break;
    case 2: shell_rows<T, 2, GRAD>(cw, rx, ry, rz, g0, g1, o, stride); break;
    default: shell_rows<T, 3, GRAD>(cw, rx, ry, rz, g0, g1, o, stride); break;
  }
}

// The Jastrow's tables, read from shared memory once per kernel. Electron
// e's terms at (x, y, z) are dealt as items, one basis kind K at a time:
// first the kind's e-ion pairs, then its e-e pairs (basis, other electron)
// with every other electron at its position in pos (3 per electron),
// count(K) items in all. The arithmetic of each term is that of
// sj_device.cuh:basis_kind.
template <typename T>
struct JastrowTab {
  const T *atoms, *abas, *bbas, *acoeff, *bcoeff;
  const int* ion[2];  // (atom, basis) pairs of kind K
  const int* bk[2];   // e-e bases of kind K
  int nion[2], nbk[2], na, nup, nelec;
  __device__ __forceinline__ JastrowTab(const T* tab, const int* meta, const int* plan) {
    atoms = tab + meta[M_F_ATOMS];
    abas = tab + meta[M_F_ABAS];
    bbas = tab + meta[M_F_BBAS];
    acoeff = tab + meta[M_F_ACOEFF];
    bcoeff = tab + meta[M_F_BCOEFF];
    na = meta[M_NA];
    nup = meta[M_NUP];
    nelec = meta[M_NELEC];
    const bool on = meta[M_HASJ] != 0;
    const int* p = plan + PL_HEADER + PRIM_INTS * plan[PL_NPRIM] + SHELL_INTS * plan[PL_NSHELL];
#pragma unroll
    for (int K = 0; K < 2; ++K) {
      nion[K] = on ? plan[PL_NION + K] : 0;
      nbk[K] = on ? plan[PL_NBK + K] : 0;
    }
    ion[0] = p;
    ion[1] = p + 2 * plan[PL_NION];
    bk[0] = p + 2 * (plan[PL_NION] + plan[PL_NION + 1]);
    bk[1] = bk[0] + plan[PL_NBK];
  }

  __device__ __forceinline__ int count(int K) const { return nion[K] + (nelec - 1) * nbk[K]; }

  // One term before its basis: the displacement, the basis parameters and
  // the coefficient. The items' branches only choose these, so the lanes of
  // an iteration share one path through the basis.
  struct Term {
    T dx, dy, dz, param, rcut, w;
  };

  // e-ion pair i of kind K, electron of spin s at (x, y, z)
  template <int K>
  __device__ __forceinline__ Term ion_term(int i, T x, T y, T z, int s) const {
    const int I = ion[K][2 * i], k = ion[K][2 * i + 1];
    const T* at = atoms + 3 * I;
    return Term{x - at[0], y - at[1], z - at[2], abas[2 * k], abas[2 * k + 1],
                acoeff[(I * na + k) * 2 + s]};
  }

  // e-e basis k at displacement d, coefficient channel ch
  __device__ __forceinline__ Term ee_term(int k, T dx, T dy, T dz, int ch) const {
    return Term{dx, dy, dz, bbas[2 * k], bbas[2 * k + 1], bcoeff[k * 3 + ch]};
  }

  // item i < count(K) of electron e (spin s) at (x, y, z)
  template <int K>
  __device__ __forceinline__ Term item(int i, T x, T y, T z, int e, int s, const T* pos) const {
    if (i < nion[K]) return ion_term<K>(i, x, y, z, s);
    const int r = i - nion[K], kk = r / (nelec - 1), jj = r - kk * (nelec - 1);
    const int j = jj < e ? jj : jj + 1;
    return ee_term(bk[K][kk], x - pos[3 * j], y - pos[3 * j + 1], z - pos[3 * j + 2],
                   s + (j >= nup ? 1 : 0));
  }

  // the term's u (returned) and, for gradients, its gradient added to g
  template <int K, bool GRAD>
  __device__ __forceinline__ T eval(const Term& t, T* g) const {
    const T r = dsqrt(t.dx * t.dx + t.dy * t.dy + t.dz * t.dz);
    T v, fo;
    basis_kind<T, K>(t.param, t.rcut, r, v, fo);
    if (GRAD) {
      g[0] += t.w * fo * t.dx;
      g[1] += t.w * fo * t.dy;
      g[2] += t.w * fo * t.dz;
    }
    return t.w * v;
  }
};

// This lane's share of electron e's Jastrow at (x, y, z): the items lane,
// lane + G, ... of each basis kind; u returned, the gradient added to g
// (GRAD).
template <typename T, bool GRAD, int G>
__device__ __forceinline__ T jastrow_lane(const JastrowTab<T>& jt, int lane, T x, T y, T z,
                                          int e, int s, const T* pos, T* g) {
  constexpr int PP = BASIS_POLYPADE, CC = BASIS_CUTOFFCUSP;
  T u = T(0);
  for (int i = lane; i < jt.count(PP); i += G)
    u += jt.template eval<PP, GRAD>(jt.template item<PP>(i, x, y, z, e, s, pos), g);
  for (int i = lane; i < jt.count(CC); i += G)
    u += jt.template eval<CC, GRAD>(jt.template item<CC>(i, x, y, z, e, s, pos), g);
  return u;
}

// The Jastrow of electron e at (x, y, z), dealt over the group's lanes and
// summed by the butterfly: u returned, its gradient in g (GRAD).
template <typename T, bool GRAD, int G>
__device__ __forceinline__ T jastrow_group(const Group<G>& grp, const JastrowTab<T>& jt, T x,
                                           T y, T z, int e, int s, const T* pos, T* g) {
  T gl[3] = {T(0), T(0), T(0)};
  const T u = grp.sum(jastrow_lane<T, GRAD, G>(jt, grp.lane, x, y, z, e, s, pos, gl));
  if (GRAD) {
    g[0] = grp.sum(gl[0]);
    g[1] = grp.sum(gl[1]);
    g[2] = grp.sum(gl[2]);
  }
  return u;
}

// The AOs with gradients at one point, dealt over the group: primitives
// into E, then shells into aob (row r: value and gradient at aob[4 r]),
// then the contraction with the spin's MO coefficients C (nao, n) into mo
// (slot-major, row stride NMAX), rows summed in concat order. Ends
// synchronised.
template <typename T, int NMAX, int G>
__device__ __forceinline__ void orbitals_grad(const Group<G>& grp, const T* tab, const int* meta,
                                              const int* plan, T x, T y, T z, const T* C, int n,
                                              T* E, T* aob, T* mo) {
  const int nprim = plan[PL_NPRIM], nshell = plan[PL_NSHELL], nao = meta[M_NAO];
  for (int k = grp.lane; k < nprim; k += G) prim_item<T, true>(tab, plan, k, x, y, z, E);
  grp.sync();
  for (int i = grp.lane; i < nshell; i += G)
    shell_item<T, true>(tab, meta, plan, i, x, y, z, E, aob, 4);
  grp.sync();
  for (int t = grp.lane; t < 4 * n; t += G) {
    const int slot = t / n, j = t - slot * n;
    T acc = T(0);
    for (int r = 0; r < nao; ++r) acc += aob[4 * r + slot] * C[r * n + j];
    mo[slot * NMAX + j] = acc;
  }
  grp.sync();
}

// Accept-side update of electron `row` of a spin moved to the point whose
// orbitals [value; gradient] are in mo (slot-major, stride NMAX), dealt over
// the group: Sherman-Morrison on the
// inverse at S[oinv] (row `row` of the orbital matrix replaced), phase and
// log|det| at S[oph], S[oph + 1] (lane 0), the orbital cache row at S[omog].
// tv and ic are NMAX-element scratch rows of the walker. Ends synchronised.
template <typename T, int NMAX, int G>
__device__ __forceinline__ void accept_update(const Group<G>& grp, T* S, const T* mo, T* tv,
                                              T* ic, int oinv, int omog, int oph, int n,
                                              int row) {
  // t_j = sum_k mo_k inv[k, j], and the inverse's column `row` before it changes
  for (int j = grp.lane; j < n; j += G) {
    T acc = T(0);
    for (int k = 0; k < n; ++k) acc += mo[k] * S[oinv + k * n + j];
    tv[j] = acc;
    ic[j] = S[oinv + j * n + row];
  }
  grp.sync();
  const T rsm = tv[row];
  for (int t = grp.lane; t < n * n; t += G) {
    const int i = t / n, j = t - i * n;
    T& a = S[oinv + t];
    a = j == row ? ic[i] / rsm : a - ic[i] * tv[j] / rsm;
  }
  for (int t = grp.lane; t < 4 * n; t += G) {
    const int slot = t / n, j = t - slot * n;
    S[omog + (row * 4 + slot) * n + j] = mo[slot * NMAX + j];
  }
  if (grp.lane == 0) {
    const T absr = dabs(rsm);
    const T safe = absr == T(0) ? T(1) : absr;
    S[oph] = S[oph] * (rsm / safe);
    S[oph + 1] = S[oph + 1] + dlog(safe);
  }
  grp.sync();
}

}  // namespace lg
}  // namespace pq
