// Kernel 7: the Metropolis sweep of a periodic Slater-Jastrow wavefunction
// with real (TRIM) k-point orbitals, a group of warps per walker.
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
//   fixed node      a move with ratio <= 0 is rejected (:505-507);
//   outputs         per walker, r2p, the sum over every proposal of
//                   |gauss + tau drift_old|^2 with the limited old drift,
//                   and r2a, the same sum over the accepted moves only
//                   (:510-516, :583-588), in rows 1 and 2 of `sums`.
//
// Design. A walker is a group of PBC_WARPS = 4 warps (128 threads), and a
// block holds PBC_WALKERS = 4 walkers; the groups of a block share the
// tables and R and synchronise only among themselves (named barrier 1 + g
// of 128 threads; barrier 0 is used only before the early return of a
// group past the last walker, so every thread of a group reaches every
// barrier it waits at). Per move, four group barriers separate:
//   1. every warp: the drift from the cached orbital row (loaded a move
//      ahead) against the inverse column, butterfly sums with the same
//      bits on every warp; the old-position Jastrow terms that the move
//      before left (below); the proposal and its folds; then the 183
//      shells in passes of up to 32 shells of one l-group, one per lane,
//      the passes dealt to the warps in turn (7 passes on the diamond
//      basis, two on the busiest warp), values and gradients into the
//      walker's shared AO buffer; and the Jastrow terms,
//      each warp a quarter of the items (atoms, then electrons), one per
//      lane: electron e's at its proposal and, in the same pass, the next
//      electron's at its position, the pair of the two kept apart for
//      both of e's positions, so that the next move's old-position terms
//      follow from this move's decision without a pass of their own;
//   2. the contraction: warp w runs over a quarter of the AO rows, lane j
//      holding the value and gradient sums of column j of the moving
//      electron's spin, into a shared partial;
//   3. every warp: the partials summed in warp order (the same bits on
//      every warp); the Sherman-Morrison row t_j over the warp's quarter of
//      the inverse rows; warp 0: the ratio, the new drift and t_prob, and
//      thread 0 alone the accept decision (and the node test), written to
//      shared memory;
//   4. on accept, every warp updates its quarter of the inverse rows and
//      one slot of the cached orbital row; thread 0 phase, log|det|, U,
//      the position and the wrap delta (registers and shared memory until
//      the sweep ends).
// The walker's inverses live in shared memory for the sweep (rows padded to
// n + 1, so a column and a row are both conflict-free), as do its positions
// and wrap deltas; they go back to state_out at the end. The rest of the
// state row (walker-major: row r of walker w at [w * nrows + r]) is copied
// from state_in to state_out and updated there. R is staged once per block
// in shared memory, transposed (column j's rows together, stride
// r_stride), where it fits: f32 at the diamond supercell's 489 x 64 takes
// 126 KB, the block 219 KB, one block of 16 warps per SM and 125 blocks
// for 500 walkers; f64 reads R through L1/L2. Staging R wins over reading
// it through L1: four walkers' registers (4 x 128 threads at up to 128
// registers) fill an SM's register file either way, and shared R leaves
// the L1 to the state rows. The Jastrow's radial bases take one division
// each (basis_recip) where sj_device.cuh's basis_kind takes six.
//
// ptxas (sm_90a): pbc_sweep_kernel<float, *> 128 registers, 64 bytes of
// stack, no spill; <double, *> 128 registers, 284-332 bytes spilled (the
// f64 instances serve the parity checks). Eight warps per walker (64
// registers) spill and were slower.
//
// What bounds it: latency and shared-memory traffic. Per move every warp
// runs dependent chains (shell exps, Jastrow bases, butterflies) between
// four barriers, and the contraction reads each AO row's four values as a
// broadcast; 16 warps per SM hide little of it. The operation bound is
// 0.087 ms per 500-walker sweep.
#include <cuda_runtime.h>

#include "ao_shell.cuh"
#include "sweep_kernel.cuh"
#include "vec4.cuh"

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
  P_F_JCONST,  // (na + nb, 2): 1 / rcut and, for a cutoffcusp basis, its c0
  P_HEADER
};

constexpr int PBC_WARPS = 4;                // warps per walker
constexpr int PBC_WALKERS = 4;              // walkers per block
constexpr int PBC_GROUP = 32 * PBC_WARPS;   // threads per walker
constexpr int PBC_THREADS = PBC_WALKERS * PBC_GROUP;
constexpr int PBC_NMAX = 32;                // orbitals per spin (one lane each)
constexpr unsigned FULL = 0xffffffffu;

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

// The walker's shared buffer, in elements of T (each part a multiple of 4
// elements, so 16-byte aligned): positions, wrap deltas, the AO buffer (value and
// gradient of each concat row), the two inverses (rows padded to
// PBC_NMAX + 1), the contraction's partials (warp, slot, lane), the
// Sherman-Morrison partials (warp, lane), the Jastrow data of the next
// move's old position (two buffers by the parity of the electron: warp
// partials, then the pair term with the electron before it at its old and
// at its new position), the Jastrow partials at the proposal (warp, [u, gx,
// gy, gz]) and the accept flag.
struct WalkerSmem {
  int pos, wrap, aob, inv, red, tred, jnext, jpair, jnew, dec, total;
};

__host__ __device__ inline int align4(int n) { return (n + 3) / 4 * 4; }

// Row stride of R transposed in shared memory (column j's rows at
// [j * stride]): a multiple of 4 whose quarter is odd, so that the 16-byte
// loads of eight neighbouring columns fall in distinct bank groups.
__host__ __device__ inline int r_stride(int nao) {
  const int a = align4(nao);
  return (a / 4) % 2 ? a : a + 4;
}

__host__ __device__ inline WalkerSmem walker_smem(int nelec, int nao) {
  WalkerSmem m;
  m.pos = 0;
  m.wrap = m.pos + align4(3 * nelec);
  m.aob = m.wrap + align4(3 * nelec);
  m.inv = m.aob + 4 * align4(nao);
  m.red = m.inv + align4(2 * PBC_NMAX * (PBC_NMAX + 1));
  m.tred = m.red + 4 * PBC_GROUP;
  m.jnext = m.tred + PBC_GROUP;
  m.jpair = m.jnext + 2 * 4 * PBC_WARPS;
  m.jnew = m.jpair + 2 * 8;
  m.dec = m.jnew + 4 * PBC_WARPS;
  m.total = m.dec + 4;
  return m;
}

__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(PBC_GROUP) : "memory");
}

// Radial Jastrow basis: value and f'(r)/r, basis_kind's (sj_device.cuh)
// with its divisions by rcut and r turned into products with the
// reciprocals ircut (the table's) and ir, and one reciprocal of the
// denominator: one division per basis where basis_kind has six, which
// were most of the Jastrow's time.
template <typename T>
__device__ __forceinline__ void basis_recip(int kind, T param, T rcut, T ircut, T c0, T r, T ir,
                                           T& v, T& fo) {
  const bool inside = r < rcut;
  const T x = clamp01(r * ircut);
  if (kind == BASIS_POLYPADE) {
    const T z = x * x * (T(6) - T(8) * x + T(3) * x * x);
    const T dzdx = T(12) * x * (T(1) - x) * (T(1) - x);
    const T rden = T(1) / (T(1) + param * z);
    const T f = (T(1) - z) * rden;
    const T dfdz = -(T(1) + param) * rden * rden;
    const T fo_ = r > T(1e-12) ? dfdz * dzdx * ircut * ir : T(12) * dfdz * ircut * ircut;
    v = inside ? f : T(0);
    fo = inside ? fo_ : T(0);
  } else {
    const T p = x - x * x + x * x * x / T(3);
    const T pp = (T(1) - x) * (T(1) - x);
    const T rden = T(1) / (T(1) + param * p);
    const T f = rcut * (p * rden - c0);
    const T dfdr = pp * rden * rden;
    v = inside ? f : T(0);
    fo = inside ? dfdr * (r > T(1e-12) ? ir : T(1e12)) : T(0);
  }
}

// The warps' Jastrow partials summed in warp order: u, and the gradient in g.
template <typename T>
__device__ __forceinline__ T jastrow_total(const T* part, T* g) {
  T u = T(0);
  g[0] = g[1] = g[2] = T(0);
#pragma unroll
  for (int w = 0; w < PBC_WARPS; ++w) {
    u += part[4 * w];
    g[0] += part[4 * w + 1];
    g[1] += part[4 * w + 2];
    g[2] += part[4 * w + 3];
  }
  return u;
}

// The Jastrow terms of two electrons in one pass over the items, so that
// each thread runs two independent chains:
//   A  electron e at its proposal (xa, ya, za), spin s: every atom and every
//      other electron, into partA[warp];
//   B  when `next`, electron e + 1 at its position (xb, yb, zb), spin s1:
//      every atom and every electron but e and e + 1 into partB[warp]; its
//      pair term with electron e, e at its position into pair[0..3] and at
//      its proposal into pair[4..7] (the extra item natom + nelec). The
//      next move's old-position terms then follow from this move's
//      decision without a pass of their own.
// Each warp takes a quarter of the items (the atoms, then the electrons,
// then the extra item), one per lane, so that the four schedulers of an SM
// share the work.
template <typename T>
__device__ __forceinline__ void jastrow_two(const T* tab, const int* meta, T xa, T ya, T za,
                                            int e, int s, bool next, T xb, T yb, T zb, int s1,
                                            const T* pos, int warp, int lane, T* partA, T* partB,
                                            T* pair) {
  const int natom = meta[P_NATOM], na = meta[P_NA], nb = meta[P_NB];
  const int nup = meta[P_NUP], nelec = meta[P_NELEC];
  const T* lat = tab + meta[P_F_SLAT];
  const T* lati = tab + meta[P_F_SLATI];
  const int nitem = natom + nelec + (next ? 1 : 0);
  const int per = (nitem + PBC_WARPS - 1) / PBC_WARPS;
  const int end = (warp + 1) * per < nitem ? (warp + 1) * per : nitem;
  T ua = T(0), ax = T(0), ay = T(0), az = T(0), ub = T(0), bx = T(0), by = T(0), bz = T(0);
  for (int it = warp * per + lane; it < end; it += 32) {
    const bool atom = it < natom;
    const bool extra = it == natom + nelec;
    const int j = extra ? e : it - natom;  // the other electron
    const bool to_a = atom || (!extra && j != e);
    // B's destination: 0 none, 1 partB, 2 the pair at e's position, 3 at its proposal
    const int to_b = !next ? 0 : atom ? 1 : extra ? 3 : j == e ? 2 : j == e + 1 ? 0 : 1;
    if (!to_a && to_b == 0) continue;
    const T* c = atom ? tab + meta[P_F_ATOMS] + 3 * it : pos + 3 * j;
    const T cx = extra ? xa : c[0], cy = extra ? ya : c[1], cz = extra ? za : c[2];
    T dax = xa - cx, day = ya - cy, daz = za - cz;
    T dbx = xb - cx, dby = yb - cy, dbz = zb - cz;
    mi_super(lat, lati, dax, day, daz);
    mi_super(lat, lati, dbx, dby, dbz);
    const T ra = dsqrt(dax * dax + day * day + daz * daz);
    const T rb = dsqrt(dbx * dbx + dby * dby + dbz * dbz);
    const T ira = T(1) / ra, irb = T(1) / rb;
    const int nk = atom ? na : nb;
    const T* bas = tab + meta[atom ? P_F_ABAS : P_F_BBAS];
    const T* jc = tab + meta[P_F_JCONST] + (atom ? 0 : 2 * na);
    const int* kind = meta + meta[atom ? P_I_AKIND : P_I_BKIND];
    const T* ca = atom ? tab + meta[P_F_ACOEFF] + it * na * 2 + s
                       : tab + meta[P_F_BCOEFF] + s + (j >= nup ? 1 : 0);
    const T* cb = atom ? tab + meta[P_F_ACOEFF] + it * na * 2 + s1
                       : tab + meta[P_F_BCOEFF] + s1 + (j >= nup ? 1 : 0);
    const int cstride = atom ? 2 : 3;
    T iua = T(0), iax = T(0), iay = T(0), iaz = T(0);
    T iub = T(0), ibx = T(0), iby = T(0), ibz = T(0);
    for (int k = 0; k < nk; ++k) {
      T va, foa, vb, fob;
      const int kk = kind[k];
      const T param = bas[2 * k], rcut = bas[2 * k + 1], ircut = jc[2 * k], c0 = jc[2 * k + 1];
      basis_recip<T>(kk, param, rcut, ircut, c0, ra, ira, va, foa);
      basis_recip<T>(kk, param, rcut, ircut, c0, rb, irb, vb, fob);
      const T wa = ca[k * cstride], wb = cb[k * cstride];
      iua += wa * va;
      iax += wa * foa * dax;
      iay += wa * foa * day;
      iaz += wa * foa * daz;
      iub += wb * vb;
      ibx += wb * fob * dbx;
      iby += wb * fob * dby;
      ibz += wb * fob * dbz;
    }
    if (to_a) {
      ua += iua;
      ax += iax;
      ay += iay;
      az += iaz;
    }
    if (to_b == 1) {
      ub += iub;
      bx += ibx;
      by += iby;
      bz += ibz;
    } else if (to_b >= 2) {
      T* p = pair + 4 * (to_b - 2);
      p[0] = iub, p[1] = ibx, p[2] = iby, p[3] = ibz;
    }
  }
  ua = warp_sum(ua);
  ax = warp_sum(ax);
  ay = warp_sum(ay);
  az = warp_sum(az);
  ub = warp_sum(ub);
  bx = warp_sum(bx);
  by = warp_sum(by);
  bz = warp_sum(bz);
  if (lane == 0) {
    T* p = partA + 4 * warp;
    p[0] = ua, p[1] = ax, p[2] = ay, p[3] = az;
    if (next) {
      p = partB + 4 * warp;
      p[0] = ub, p[1] = bx, p[2] = by, p[3] = bz;
    }
  }
}

// One shell's AO values and gradients at (x, y, z) into the AO buffer, at
// its concat rows.
template <typename T, int L>
__device__ __forceinline__ void shell_to_aob(const T* tab, const int* grp, int si, T x, T y, T z,
                                             T* aob) {
  constexpr int NS = 2 * L + 1;
  T v[NS], gx[NS], gy[NS], gz[NS];
  shell_one<T, L, 1>(tab, grp, si, x, y, z, v, gx, gy, gz, nullptr);
  T* b = aob + (size_t)(grp[G_ROW] + si * NS) * 4;
#pragma unroll
  for (int q = 0; q < NS; ++q) st4<T>(b + 4 * q, v[q], gx[q], gy[q], gz[q]);
}

template <typename T, bool DMC>
__global__ void __launch_bounds__(PBC_THREADS, 1)
    pbc_sweep_kernel(const T* __restrict__ state_in, T* __restrict__ state_out,
                     const T* __restrict__ gauss, const T* __restrict__ unif,
                     T* __restrict__ wrapd, T* __restrict__ sums, const T* __restrict__ R_g,
                     const T* __restrict__ tab_g, int ntab, const int* __restrict__ meta_g,
                     int nmeta, int nconf, int nrows, T tstep, T drift_cutoff, int r_in_smem) {
  T* tab;
  int* meta;
  unsigned char* rest = stage_tables<T>(tab_g, ntab, meta_g, nmeta, &tab, &meta);
  __syncthreads();
  const int nelec = meta[P_NELEC], nup = meta[P_NUP], ndn = meta[P_NDN], nao = meta[P_NAO];
  const int ntot = nup + ndn;
  // R transposed into shared memory where it fits, its padding rows zero
  const int rst = r_stride(nao);
  T* Rs = reinterpret_cast<T*>(rest);
  if (r_in_smem) {
    for (int i = threadIdx.x; i < ntot * rst; i += blockDim.x) {
      const int j = i / rst, r = i % rst;
      Rs[i] = r < nao ? R_g[(size_t)r * ntot + j] : T(0);
    }
    rest += (((size_t)ntot * rst * sizeof(T) + 15) / 16) * 16;
  }
  const WalkerSmem lay = walker_smem(nelec, nao);
  const int g = threadIdx.x / PBC_GROUP, t = threadIdx.x % PBC_GROUP;
  const int warp = t / 32, lane = t % 32;
  T* ws = reinterpret_cast<T*>(rest) + (size_t)g * lay.total;
  T* pos = ws + lay.pos;
  T* wsum = ws + lay.wrap;
  T* aob = ws + lay.aob;
  T* red = ws + lay.red;
  T* tred = ws + lay.tred;
  T* jnext = ws + lay.jnext;
  T* jpair = ws + lay.jpair;
  T* jnew = ws + lay.jnew;
  T* dec = ws + lay.dec;
  __syncthreads();
  const int w = blockIdx.x * PBC_WALKERS + g;
  if (w >= nconf) return;  // the whole group: only its own barrier follows
  const int bar = 1 + g;

  const int off_invu = 3 * nelec;
  const int off_invd = off_invu + nup * nup;
  const int off_phu = off_invd + ndn * ndn;
  const int off_mogu = off_phu + 4;
  const int off_mogd = off_mogu + 4 * nup * nup;
  const int off_u = off_mogd + 4 * ndn * ndn;
  const T* Sin = state_in + (size_t)w * nrows;
  T* S = state_out + (size_t)w * nrows;
  T* wd = wrapd + (size_t)w * 3 * nelec;
  for (int r = t; r < nrows; r += PBC_GROUP) S[r] = Sin[r];
  for (int r = t; r < 3 * nelec; r += PBC_GROUP) {
    pos[r] = Sin[r];
    wsum[r] = T(0);
  }
  // the inverses, row k of spin s at inv_s[k * (n + 1)]
  T* inv_up = ws + lay.inv;
  T* inv_dn = inv_up + PBC_NMAX * (PBC_NMAX + 1);
  for (int i = t; i < nup * nup; i += PBC_GROUP)
    inv_up[(i / nup) * (nup + 1) + i % nup] = Sin[off_invu + i];
  for (int i = t; i < ndn * ndn; i += PBC_GROUP)
    inv_dn[(i / ndn) * (ndn + 1) + i % ndn] = Sin[off_invd + i];

  const bool hasj = meta[P_HASJ] != 0;
  const T* slat = tab + meta[P_F_SLAT];
  const T* slati = tab + meta[P_F_SLATI];
  const T* plat = tab + meta[P_F_PLAT];
  const T* plati = tab + meta[P_F_PLATI];
  const T* kpts = tab + meta[P_F_KPTS];
  const int* korb = meta + meta[P_I_KORB];
  const int ngroups = meta[P_NGROUPS];
  const int* groups = meta + meta[P_I_GROUPS];
  // the shells in passes of up to 32 of one l-group, one shell per lane,
  // the passes dealt to the warps in turn: no warp runs two l's at once
  int npass = 0;
  for (int gi = 0; gi < ngroups; ++gi) npass += (groups[gi * GROUP_INTS + G_S] + 31) / 32;
  // this warp's AO rows of the contraction, in fours (the AO buffer's and
  // R's padding rows are zero)
  const int rows_per_warp = align4((nao + PBC_WARPS - 1) / PBC_WARPS);
  const int r_begin = warp * rows_per_warp;
  const int r_end = r_begin + rows_per_warp < nao ? r_begin + rows_per_warp : nao;
  for (int r = 4 * nao + t; r < 4 * align4(nao); r += PBC_GROUP) aob[r] = T(0);
  // thread 0's: the counts, phases and log|det| of both spins, U
  T nacc = T(0), r2p = T(0), r2a = T(0);
  T ph_up = Sin[off_phu], lgd_up = Sin[off_phu + 1];
  T ph_dn = Sin[off_phu + 2], lgd_dn = Sin[off_phu + 3];
  T uj = hasj ? Sin[off_u] : T(0);
  // the moving electron's cached orbital row (lane j: column j), loaded a
  // move ahead
  T mg[4];
#pragma unroll
  for (int slot = 0; slot < 4; ++slot)
    mg[slot] = lane < nup ? Sin[off_mogu + slot * nup + lane] : T(0);
  group_sync(bar);
  // electron 0's Jastrow at its position (buffer 0); later electrons' come
  // from the move before theirs
  if (hasj)
    jastrow_two<T>(tab, meta, pos[0], pos[1], pos[2], 0, 0, false, T(0), T(0), T(0), 0, pos,
                   warp, lane, jnext, nullptr, nullptr);
  group_sync(bar);

  for (int e = 0; e < nelec; ++e) {
    const int s = e < nup ? 0 : 1;
    const int n = s ? ndn : nup;
    const int row = s ? e - nup : e;
    const int ld = n + 1;
    T* inv = s ? inv_dn : inv_up;
    const int omog = s ? off_mogd : off_mogu;
    const bool act = lane < n;
    const T ex = pos[3 * e], ey = pos[3 * e + 1], ez = pos[3 * e + 2];

    // 1. drift at the current position: the cached orbital row against
    // the inverse column, lane j holding term j (every warp the same bits),
    // and the Jastrow terms that the move before left
    const T invrow = act ? inv[lane * ld + row] : T(0);
    const T* ga = gauss + ((size_t)w * nelec + e) * 3;
    const T gax = ga[0], gay = ga[1], gaz = ga[2];
    const T ue = unif[(size_t)w * nelec + e];
    T r4[4];
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) r4[slot] = warp_sum(mg[slot] * invrow);

    // the proposal, its folds and this lane's TRIM sign; the AOs and the
    // Jastrow terms there, and the next electron's at its position
    T g_old[3] = {r4[1] / r4[0], r4[2] / r4[0], r4[3] / r4[0]};
    T u_old = T(0);
    if (hasj) {
      T gj[3];
      const int b = e & 1;
      u_old = jastrow_total<T>(jnext + 4 * PBC_WARPS * b, gj);
      if (e > 0) {  // the pair with electron e - 1 where the last decision left it
        const T* p = jpair + 8 * b + (dec[0] != T(0) ? 4 : 0);
        u_old += p[0];
        gj[0] += p[1];
        gj[1] += p[2];
        gj[2] += p[3];
      }
      g_old[0] += gj[0];
      g_old[1] += gj[1];
      g_old[2] += gj[2];
    }
    limdrift<T, DMC>(g_old, tstep, drift_cutoff);
    T fx, fy, fz;
    frac3(slati, ex + gax + tstep * g_old[0], ey + gay + tstep * g_old[1],
          ez + gaz + tstep * g_old[2], fx, fy, fz);
    const T wx = dfloor(fx), wy = dfloor(fy), wz = dfloor(fz);
    T nx, ny, nz;
    frac3(slat, fx - wx, fy - wy, fz - wz, nx, ny, nz);
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
    for (int ps = warp; ps < npass; ps += PBC_WARPS) {
      int gi = 0, pg = ps;  // pass pg of l-group gi
      while (pg >= (groups[gi * GROUP_INTS + G_S] + 31) / 32) {
        pg -= (groups[gi * GROUP_INTS + G_S] + 31) / 32;
        ++gi;
      }
      const int* grp = groups + gi * GROUP_INTS;
      const int si = 32 * pg + lane;
      if (si >= grp[G_S]) continue;
      switch (grp[G_L]) {
        case 0: shell_to_aob<T, 0>(tab, grp, si, xf, yf, zf, aob); break;
        case 1: shell_to_aob<T, 1>(tab, grp, si, xf, yf, zf, aob); break;
        case 2: shell_to_aob<T, 2>(tab, grp, si, xf, yf, zf, aob); break;
        default: shell_to_aob<T, 3>(tab, grp, si, xf, yf, zf, aob); break;
      }
    }
    if (hasj) {
      const bool next = e + 1 < nelec;
      const int b1 = (e + 1) & 1;
      const T xb = next ? pos[3 * e + 3] : T(0), yb = next ? pos[3 * e + 4] : T(0),
              zb = next ? pos[3 * e + 5] : T(0);
      jastrow_two<T>(tab, meta, nx, ny, nz, e, s, next, xb, yb, zb, e + 1 < nup ? 0 : 1, pos,
                     warp, lane, jnew, jnext + 4 * PBC_WARPS * b1, jpair + 8 * b1);
    }
    group_sync(bar);

    // 2. this warp's rows of the contraction, column `col` of R
    {
      T mo[4] = {T(0), T(0), T(0), T(0)};
      if (r_in_smem) {  // four rows of R's column a load
        const T* Rc = Rs + (act ? col : 0) * rst;
#pragma unroll 2
        for (int r = r_begin; r < r_end; r += 4) {
          T rv[4];
          ld4<T>(Rc + r, rv);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            T b[4];
            ld4<T>(aob + 4 * (r + q), b);
            mo[0] += b[0] * rv[q];
            mo[1] += b[1] * rv[q];
            mo[2] += b[2] * rv[q];
            mo[3] += b[3] * rv[q];
          }
        }
      } else {
        const T* Rc = R_g + (act ? col : 0);
#pragma unroll 4
        for (int r = r_begin; r < r_end; ++r) {
          const T rv = Rc[(size_t)r * ntot];
          T b[4];
          ld4<T>(aob + 4 * r, b);
          mo[0] += b[0] * rv;
          mo[1] += b[1] * rv;
          mo[2] += b[2] * rv;
          mo[3] += b[3] * rv;
        }
      }
#pragma unroll
      for (int slot = 0; slot < 4; ++slot) red[(warp * 4 + slot) * 32 + lane] = mo[slot];
    }
    group_sync(bar);

    // 3. the orbital row at the proposal (every warp the same bits), this
    // warp's part of t_j = sum_k mo_k inv[k, j], and the decision
    T mo[4];
#pragma unroll
    for (int slot = 0; slot < 4; ++slot) {
      T m = T(0);
#pragma unroll
      for (int ww = 0; ww < PBC_WARPS; ++ww) m += red[(ww * 4 + slot) * 32 + lane];
      mo[slot] = m * sg;
    }
    {
      constexpr int KPW = PBC_NMAX / PBC_WARPS;
      T tp = T(0);
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk) {
        const int k = warp * KPW + kk;
        const T mk = __shfl_sync(FULL, mo[0], k);
        if (act && k < n) tp += mk * inv[k * ld + lane];
      }
      tred[warp * 32 + lane] = tp;
    }
    if (e + 1 < nelec) {  // the next electron's cached row (not changed by this move)
      const int s1 = e + 1 < nup ? 0 : 1, n1 = s1 ? ndn : nup, row1 = s1 ? e + 1 - nup : e + 1;
      const int omog1 = s1 ? off_mogd : off_mogu;
#pragma unroll
      for (int slot = 0; slot < 4; ++slot)
        mg[slot] = lane < n1 ? S[omog1 + (row1 * 4 + slot) * n1 + lane] : T(0);
    }
    T du = T(0);
    if (warp == 0) {
      T ratio = warp_sum(mo[0] * invrow);
      T gn[3] = {warp_sum(mo[1] * invrow) / ratio, warp_sum(mo[2] * invrow) / ratio,
                 warp_sum(mo[3] * invrow) / ratio};
      if (hasj) {
        T gj[3];
        const T u_new = jastrow_total<T>(jnew, gj);
        du = u_new - u_old;
        ratio *= dexp(du);
        gn[0] += gj[0];
        gn[1] += gj[1];
        gn[2] += gj[2];
      }
      limdrift<T, DMC>(gn, tstep, drift_cutoff);
      if (lane == 0) {  // the walker's one decision (Metropolis-Hastings, fixed node)
        const T forward = gax * gax + gay * gay + gaz * gaz;
        const T bx = gax + tstep * (g_old[0] + gn[0]);
        const T by = gay + tstep * (g_old[1] + gn[1]);
        const T bz = gaz + tstep * (g_old[2] + gn[2]);
        const T backward = bx * bx + by * by + bz * bz;
        const T t_prob = dexp((forward - backward) / (T(2) * tstep));
        T accept_prob = dabs(ratio) * dabs(ratio) * t_prob;
        if (DMC && ratio <= T(0)) accept_prob = T(0);  // fixed node
        const bool accept = accept_prob > ue;
        dec[0] = accept ? T(1) : T(0);
        if (DMC) {
          const T qx = gax + tstep * g_old[0], qy = gay + tstep * g_old[1],
                  qz = gaz + tstep * g_old[2];
          const T r2 = qx * qx + qy * qy + qz * qz;
          r2p += r2;
          if (accept) r2a += r2;
        }
      }
    }
    group_sync(bar);

    // 4. on accept, Sherman-Morrison: column j of the inverse takes t_j and
    // the old column `row` (invrow, lane i holding row i); warp w updates
    // rows w, w + 4, ...
    if (dec[0] != T(0)) {
      T tj = T(0);
#pragma unroll
      for (int ww = 0; ww < PBC_WARPS; ++ww) tj += tred[ww * 32 + lane];
      const T rsm = __shfl_sync(FULL, tj, row);
      const T irsm = T(1) / rsm;
      for (int i = warp; i < n; i += PBC_WARPS) {
        const T coli = __shfl_sync(FULL, invrow, i);
        if (act) {
          T* a = inv + i * ld + lane;
          *a = lane == row ? coli * irsm : *a - coli * tj * irsm;
        }
      }
      for (int slot = warp; slot < 4; slot += PBC_WARPS)
        if (act) S[omog + (row * 4 + slot) * n + lane] = mo[slot];
      if (t == 0) {
        nacc += T(1);
        const T absr = dabs(rsm);
        const T safe = absr == T(0) ? T(1) : absr;
        T& ph = s ? ph_dn : ph_up;
        T& lgd = s ? lgd_dn : lgd_up;
        ph = ph * (rsm / safe);
        lgd = lgd + dlog(safe);
        pos[3 * e] = nx;
        pos[3 * e + 1] = ny;
        pos[3 * e + 2] = nz;
        wsum[3 * e] += wx;
        wsum[3 * e + 1] += wy;
        wsum[3 * e + 2] += wz;
        uj += du;
      }
    }
    group_sync(bar);
  }
  for (int r = t; r < 3 * nelec; r += PBC_GROUP) {
    S[r] = pos[r];
    wd[r] = wsum[r];
  }
  for (int i = t; i < nup * nup; i += PBC_GROUP)
    S[off_invu + i] = inv_up[(i / nup) * (nup + 1) + i % nup];
  for (int i = t; i < ndn * ndn; i += PBC_GROUP)
    S[off_invd + i] = inv_dn[(i / ndn) * (ndn + 1) + i % ndn];
  if (t == 0) {
    S[off_phu] = ph_up;
    S[off_phu + 1] = lgd_up;
    S[off_phu + 2] = ph_dn;
    S[off_phu + 3] = lgd_dn;
    if (hasj) S[off_u] = uj;
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
  const size_t rbytes = (((size_t)ntot * r_stride(nao) * sizeof(T) + 15) / 16) * 16;
  const size_t wbytes = (size_t)PBC_WALKERS * walker_smem(nelec, nao).total * sizeof(T);
  const size_t limit = 227 * 1024;
  const int r_in_smem = base + rbytes + wbytes <= limit ? 1 : 0;
  const size_t smem = base + (r_in_smem ? rbytes : 0) + wbytes;
  if (smem > limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(pbc_sweep_kernel<T, DMC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (nconf + PBC_WALKERS - 1) / PBC_WALKERS;
  pbc_sweep_kernel<T, DMC><<<blocks, PBC_THREADS, smem, stream>>>(
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
