// Nonlocal ECP energy of a Slater-Jastrow wavefunction, one thread per
// (walker, electron), then an in-order sum over electrons.
//
// Replaces pyqmc_tpu/ops/move_pallas.py:build_fused_ecp_energy, the Pallas
// TPU kernel. Per electron: wvec = C_s @ inv[:, row] once; per quadrature
// point: the rotated point on the sphere through the electron around each
// nonlocal atom, the radial channels times Legendre projectors, value-only
// AOs dotted with wvec (the Slater ratio) and the Jastrow value ratio.
// Quadrature order, rsafe, the r < rmax mask, the (2l+1) factor and the
// r^(n-2) powers follow the Pallas kernel (ecp_device.cuh).
//
// Layout: walker-minor (row r of walker w at [r * nconf + w]); thread
// t = e * nconf + w, so a warp reads one electron's rows of 32 walkers
// contiguously. wvec goes to a (nao, nelec * nconf) scratch the wrapper
// allocates, the per-electron energies to an (nelec, nconf) scratch; the
// second kernel sums them in electron order with no atomics, so results
// repeat bit for bit.
//
// What bounds it: exp-heavy FP work, one AO evaluation and one e-e Jastrow
// pass per quadrature point (6 points per electron for ccECP H2O, 48 per
// walker). 16384 threads at production size fill about one warp per
// scheduler on an H100.
#include <cuda_runtime.h>

#include "ecp_device.cuh"
#include "gto_device.cuh"
#include "sj_device.cuh"

namespace pq {

template <typename T>
struct DotSink {
  const T* wvec;  // row k at wvec[k * stride]
  size_t stride;
  T acc;
  __device__ __forceinline__ void operator()(int row, T v, T, T, T) {
    acc += v * wvec[row * stride];
  }
};

template <typename T>
__global__ void ecp_partial_kernel(const T* __restrict__ pos, const T* __restrict__ invu,
                                   const T* __restrict__ invd, const T* __restrict__ rot,
                                   T* __restrict__ wvec, T* __restrict__ partial,
                                   const T* __restrict__ tab_g, int ntab,
                                   const int* __restrict__ meta_g, int nmeta, int nconf) {
  T* tab;
  int* meta;
  load_tables<T>(tab_g, ntab, meta_g, nmeta, &tab, &meta);
  const int nelec = meta[M_NELEC], nup = meta[M_NUP], ndn = meta[M_NDN], nao = meta[M_NAO];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nelec * nconf) return;
  const int e = t / nconf;
  const int w = t - e * nconf;
  const size_t st = (size_t)nconf;
  const size_t wst = (size_t)nelec * nconf;
  const int s = e < nup ? 0 : 1;
  const int n = s ? ndn : nup;
  const int row = s ? e - nup : e;
  const T* inv = (s ? invd : invu) + w;
  const T* C = tab + (s ? meta[M_F_CB] : meta[M_F_CA]);

  // fold the MO coefficients with the inverse column once per electron
  T* wv = wvec + t;
  for (int k = 0; k < nao; ++k) {
    T acc = T(0);
    for (int j = 0; j < n; ++j) acc += C[k * n + j] * inv[(j * n + row) * st];
    wv[k * wst] = acc;
  }

  const T* P = pos + w;
  const T ex = P[(3 * e) * st], ey = P[(3 * e + 1) * st], ez = P[(3 * e + 2) * st];
  const bool hasj = meta[M_HASJ] != 0;
  const T u_old = hasj ? jastrow_terms<T, false>(tab, meta, ex, ey, ez, e, s, P, st, nullptr)
                       : T(0);
  T R[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = rot[(9 * e + k) * st + w];
  const T rmax = tab[meta[M_F_RMAX]];

  T nl = T(0);
  const int nq = meta[M_NQATOMS];
  const int* qatoms = meta + meta[M_I_QATOMS];
  QuadAtom<T> atom;
  for (int qa = 0; qa < nq; ++qa) {
    atom.set(tab, meta, qatoms + qa * QATOM_INTS, ex, ey, ez, rmax, true);
    for (int ip = 0; ip < atom.q[Q_NPTS]; ++ip) {
      T ax, ay, az;
      const T Tq = atom.point(tab, R, ip, ax, ay, az, true);
      DotSink<T> sink;
      sink.wvec = wv;
      sink.stride = wst;
      sink.acc = T(0);
      ao_eval<T, false>(tab, meta, ax, ay, az, sink);
      T rq = sink.acc;
      if (hasj) {
        const T uq = jastrow_terms<T, false>(tab, meta, ax, ay, az, e, s, P, st, nullptr);
        rq *= dexp(uq - u_old);
      }
      nl += Tq * rq;
    }
  }
  partial[e * st + w] = nl;
}

template <typename T>
__global__ void ecp_reduce_kernel(const T* __restrict__ partial, T* __restrict__ out, int nelec,
                                  int nconf) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nconf) return;
  T acc = T(0);
  for (int e = 0; e < nelec; ++e) acc += partial[(size_t)e * nconf + w];
  out[w] = acc;
}

template <typename T>
int launch_ecp_energy(const T* pos, const T* invu, const T* invd, const T* rot, T* wvec,
                      T* partial, T* out, const T* tab, int ntab, const int* meta, int nmeta,
                      int nelec, int nconf, cudaStream_t stream) {
  const int threads = 128;
  const size_t smem = (size_t)ntab * sizeof(T) + (size_t)nmeta * sizeof(int);
  const int total = nelec * nconf;
  ecp_partial_kernel<T><<<(total + threads - 1) / threads, threads, smem, stream>>>(
      pos, invu, invd, rot, wvec, partial, tab, ntab, meta, nmeta, nconf);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  ecp_reduce_kernel<T><<<(nconf + threads - 1) / threads, threads, 0, stream>>>(partial, out,
                                                                                 nelec, nconf);
  return (int)cudaGetLastError();
}

}  // namespace pq

extern "C" {

int pq_ecp_energy_f32(const void* pos, const void* invu, const void* invd, const void* rot,
                      void* wvec, void* partial, void* out, const void* tab, int ntab,
                      const void* meta, int nmeta, int nelec, int nconf, void* stream) {
  return pq::launch_ecp_energy<float>((const float*)pos, (const float*)invu, (const float*)invd,
                                      (const float*)rot, (float*)wvec, (float*)partial,
                                      (float*)out, (const float*)tab, ntab, (const int*)meta,
                                      nmeta, nelec, nconf, (cudaStream_t)stream);
}

int pq_ecp_energy_f64(const void* pos, const void* invu, const void* invd, const void* rot,
                      void* wvec, void* partial, void* out, const void* tab, int ntab,
                      const void* meta, int nmeta, int nelec, int nconf, void* stream) {
  return pq::launch_ecp_energy<double>((const double*)pos, (const double*)invu,
                                       (const double*)invd, (const double*)rot, (double*)wvec,
                                       (double*)partial, (double*)out, (const double*)tab, ntab,
                                       (const int*)meta, nmeta, nelec, nconf,
                                       (cudaStream_t)stream);
}

}  // extern "C"
