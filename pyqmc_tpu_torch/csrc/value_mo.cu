// Kernel 3: value-only AOs contracted with a coefficient matrix, as a tiled
// contraction whose A operand is computed rather than loaded.
//
// Replaces pyqmc_tpu/ops/gto_pallas.py:build_pallas_value_mo (wrappers
// fused_value_mo_t and fused_value_mo). out[j, m] = sum_a AO_a(X_m) C[a, j],
// with C in concat row order (the order the AOs are visited: l-group,
// shell, m), written as (norb, M).
//
// What bounds it: operations. Per point the contraction is nao * norb
// multiply-adds (489 x 64 on the diamond supercell's replicated-shell
// basis: 62.6k operations) against about 11k for the shells (about 5 exps
// per shell); the inputs are 12 bytes a point and the output 4 norb.
//
// Design. A block owns a tile of TP = 128 points and NC orbital columns
// (NC = 8, 32 or 64; more than 64 orbitals are done in passes of 64 along
// gridDim.y, each evaluating the AOs again). It walks the basis in the
// chunks of GTOTables.chunks (ops/gto_kernels.py): whole shells of one
// l-group, at most KA = 32 AOs. The A tile (the chunk's AO values at the
// tile's points) and the C tile (the chunk's rows of C) are both double
// buffered, so one barrier per chunk suffices: between two barriers the
// threads fetch chunk ch + 1's rows of C by cp.async (16 bytes a copy,
// columns past norb zero-filled), evaluate chunk ch + 1's shells at the
// tile's points with shell_one (values only) into the other A tile, and
// contract chunk ch. The contraction is register-blocked: each thread
// holds 4 points x 8 orbitals of accumulators and reads A and C as 16-byte
// vectors, 3 shared loads per 32 multiply-adds; a warp's 8 x 4 thread
// layout reads 128 bytes of A and 128 of C per load, one shared-memory
// wavefront each. No orbital mask sits in the loop: the padded columns are
// computed and not stored. The epilogue stages the tile through shared
// memory (over the A and C tiles) and writes each orbital row's 128 points
// with neighbouring threads on neighbouring addresses. The basis tables
// are read through L1. Shared memory per block: 49.5 KB (f32, NC = 64);
// the registers set the occupancy, 3 blocks of 256 threads per SM. In FP32
// on the CUDA cores (FFMA); TF32 stays off.
//
// ptxas (sm_90a): value_mo_kernel<float, *> 80 registers (the bound of 3
// blocks per SM), 192-216 bytes of stack, 244-268 bytes spilled;
// <double, *> 252 registers, no spill. The contraction alone runs at the
// card's FFMA issue rate; the shells (807 exps per point on the diamond
// basis, in dependent chains) do not overlap it, since every warp of the
// co-resident blocks evaluates and contracts at the same time. Producer
// warps that evaluate while consumer warps contract (named barriers) were
// slower on this card, with four or eight producer warps per block: the
// producers cannot hide the exp chains' latency in the registers left.
#include <cuda_runtime.h>

#include "ao_shell.cuh"
#include "vec4.cuh"

namespace pq {

constexpr int VMO_TP = 128;  // points per block
constexpr int VMO_KA = 32;   // AOs per chunk at most (ops/gto_kernels.py:CHUNK_AOS)

// the chunk table's header slots, after ao_shell.cuh's (ops/gto_kernels.py)
enum VmoSlot { T_NCHUNKS = T_HEADER, T_I_CHUNKS };
// per chunk: l-group, first shell in the group, shells, first concat row
enum ChunkSlot { K_GROUP = 0, K_SHELL0, K_NSHELL, K_ROW0, CHUNK_INTS };

// threads of a block with NC orbital columns: 4 points x 8 orbitals each
template <int NC>
struct VmoGeom {
  static constexpr int TX = NC / 8;                // thread columns
  static constexpr int THREADS = VMO_TP / 4 * TX;  // 32, 128, 256
};

// Global memory into shared memory, asynchronously (cp.async), BYTES = 4,
// 8 or 16 of them; zero-filled when !ok (src-size 0: nothing is read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
  else if constexpr (BYTES == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until this thread's copies have all landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Phase A: the chunk's shells (group grp, shells si0 .. si0 + ns) at the
// tile's points into A (row s * NS + q, point p).
template <typename T, int L, int NT>
__device__ __forceinline__ void eval_chunk(const T* tab, const int* grp, int si0, int ns,
                                           const T* xs, T* As) {
  constexpr int NS = 2 * L + 1;
  for (int i = threadIdx.x; i < ns * VMO_TP; i += NT) {
    const int p = i % VMO_TP, s = i / VMO_TP;
    T v[NS];
    shell_one<T, L, 0>(tab, grp, si0 + s, xs[p], xs[VMO_TP + p], xs[2 * VMO_TP + p], v, nullptr,
                       nullptr, nullptr, nullptr);
#pragma unroll
    for (int q = 0; q < NS; ++q) As[(s * NS + q) * VMO_TP + p] = v[q];
  }
}

template <typename T, int NT>
__device__ __forceinline__ void eval_chunk_l(const T* tab, const int* grp, int si0, int ns,
                                             const T* xs, T* As) {
  switch (grp[G_L]) {
    case 0: eval_chunk<T, 0, NT>(tab, grp, si0, ns, xs, As); break;
    case 1: eval_chunk<T, 1, NT>(tab, grp, si0, ns, xs, As); break;
    case 2: eval_chunk<T, 2, NT>(tab, grp, si0, ns, xs, As); break;
    default: eval_chunk<T, 3, NT>(tab, grp, si0, ns, xs, As); break;
  }
}

// The chunk's nk rows of C (from concat row r0, columns c0 ..) into the
// shared tile dst (nk, NC); columns past norb zero. 16 bytes a copy where
// the rows allow it (norb a multiple of 16 / sizeof(T)), else one element.
template <typename T, int NC, int NT>
__device__ __forceinline__ void load_c(const T* C, int r0, int nk, int c0, int norb, T* dst) {
  constexpr int V = 16 / sizeof(T);
  const T* src = C + (size_t)r0 * norb + c0;
  if (norb % V == 0) {
    for (int i = threadIdx.x; i < nk * (NC / V); i += NT) {
      const int k = i / (NC / V), j = (i % (NC / V)) * V;
      const bool ok = c0 + j < norb;
      cp_async<16>(dst + k * NC + j, ok ? src + (size_t)k * norb + j : C, ok);
    }
  } else {
    for (int i = threadIdx.x; i < nk * NC; i += NT) {
      const int k = i / NC, j = i % NC;
      const bool ok = c0 + j < norb;
      cp_async<sizeof(T)>(dst + i, ok ? src + (size_t)k * norb + j : C, ok);
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(VmoGeom<NC>::THREADS,
                                  (sizeof(T) == 4 ? 768 : 256) / VmoGeom<NC>::THREADS)
    value_mo_kernel(const T* __restrict__ X, const T* __restrict__ C, T* __restrict__ out,
                    const T* __restrict__ tab, const int* __restrict__ meta, int M, int norb) {
  constexpr int TP = VMO_TP, KA = VMO_KA, TX = VmoGeom<NC>::TX, NT = VmoGeom<NC>::THREADS;
  // a warp is LY points-of-4 by LX orbitals-of-8; WX warps side by side
  constexpr int LX = TX >= 4 ? 4 : TX, LY = 32 / LX, WX = TX / LX;
  extern __shared__ __align__(16) unsigned char pq_smem[];
  T* xs = reinterpret_cast<T*>(pq_smem);  // (3, TP)
  T* As = xs + 3 * TP;                    // 2 x (KA, TP)
  T* Cs = As + 2 * KA * TP;               // 2 x (KA, NC)
  T* Os = As;                             // epilogue (NC, TP), over A and C
  const int tid = threadIdx.x, lane = tid % 32, wi = tid / 32;
  const int tx = (wi % WX) * LX + lane / LY, ty = (wi / WX) * LY + lane % LY;
  const int m0 = blockIdx.x * TP, c0 = blockIdx.y * NC;
  const int nchunks = meta[T_NCHUNKS];
  const int* chunks = meta + meta[T_I_CHUNKS];
  const int* groups = meta + meta[T_I_GROUPS];

  for (int i = tid; i < TP; i += NT) {
    const int m = m0 + i;
    const bool ok = m < M;  // the ragged tail evaluates the origin, never stored
    xs[i] = ok ? X[3 * (size_t)m] : T(0);
    xs[TP + i] = ok ? X[3 * (size_t)m + 1] : T(0);
    xs[2 * TP + i] = ok ? X[3 * (size_t)m + 2] : T(0);
  }
  // chunk ch: its l-group, first shell, shells, first concat row, rows
  auto chunk = [&](int ch, const int*& grp, int& si0, int& ns, int& r0, int& nk) {
    const int* ck = chunks + ch * CHUNK_INTS;
    grp = groups + ck[K_GROUP] * GROUP_INTS;
    si0 = ck[K_SHELL0], ns = ck[K_NSHELL], r0 = ck[K_ROW0];
    nk = ns * (2 * grp[G_L] + 1);
  };
  const int* grp;
  int si0, ns, r0, nk;
  chunk(0, grp, si0, ns, r0, nk);
  load_c<T, NC, NT>(C, r0, nk, c0, norb, Cs);
  cp_async_commit();
  __syncthreads();  // the points
  eval_chunk_l<T, NT>(tab, grp, si0, ns, xs, As);
  cp_async_wait_all();

  T acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);

  // Chunk ch's tiles are complete at the barrier that opens iteration ch;
  // during it the threads fetch chunk ch + 1's C and evaluate its A into
  // the other buffers (whose last readers passed the same barrier), then
  // contract chunk ch.
  for (int ch = 0; ch < nchunks; ++ch) {
    const int cur = ch & 1, nxt = cur ^ 1;
    const int nk_cur = nk;
    __syncthreads();
    if (ch + 1 < nchunks) {
      chunk(ch + 1, grp, si0, ns, r0, nk);
      load_c<T, NC, NT>(C, r0, nk, c0, norb, Cs + nxt * KA * NC);
      cp_async_commit();
      eval_chunk_l<T, NT>(tab, grp, si0, ns, xs, As + nxt * KA * TP);
    }
    const T* ap = As + cur * KA * TP + 4 * ty;
    const T* cp = Cs + cur * KA * NC + 8 * tx;
#pragma unroll 4
    for (int k = 0; k < nk_cur; ++k) {
      T a[4], c[8];
      ld4<T>(ap + k * TP, a);
      ld4<T>(cp + k * NC, c);
      ld4<T>(cp + k * NC + 4, c + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * c[j];
    }
    cp_async_wait_all();
  }
  __syncthreads();  // every contraction done: the epilogue tile overlays A and C

#pragma unroll
  for (int j = 0; j < 8; ++j)
    st4<T>(Os + (8 * tx + j) * TP + 4 * ty, acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
  __syncthreads();
  for (int i = tid; i < NC * TP; i += NT) {
    const int c = i / TP, p = i % TP;
    if (c0 + c < norb && m0 + p < M) out[(size_t)(c0 + c) * M + m0 + p] = Os[i];
  }
}

template <typename T, int NC>
int launch_value_mo_nc(const T* X, const T* C, T* out, const T* tab, const int* meta, int M,
                       int norb, cudaStream_t stream) {
  constexpr int NT = VmoGeom<NC>::THREADS;
  const size_t smem = (size_t)(3 * VMO_TP + 2 * VMO_KA * (VMO_TP + NC)) * sizeof(T);
  static_assert(NC * VMO_TP <= 2 * VMO_KA * (VMO_TP + NC), "epilogue tile over A and C");
  cudaError_t err = cudaFuncSetAttribute(value_mo_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + VMO_TP - 1) / VMO_TP, (norb + NC - 1) / NC);
  value_mo_kernel<T, NC><<<grid, NT, smem, stream>>>(X, C, out, tab, meta, M, norb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_value_mo(const T* X, const T* C, T* out, const T* tab, const int* meta, int M,
                    int norb, cudaStream_t stream) {
  if (norb <= 8) return launch_value_mo_nc<T, 8>(X, C, out, tab, meta, M, norb, stream);
  if (norb <= 32) return launch_value_mo_nc<T, 32>(X, C, out, tab, meta, M, norb, stream);
  return launch_value_mo_nc<T, 64>(X, C, out, tab, meta, M, norb, stream);
}

}  // namespace pq

extern "C" {

// ntab, nmeta and nao are the tables' sizes and C's rows; the kernel reads
// the tables through L1 and takes the chunks from meta.
int pq_value_mo_f32(const void* X, const void* C, void* out, const void* tab, int ntab,
                    const void* meta, int nmeta, int M, int norb, int nao, void* stream) {
  (void)ntab, (void)nmeta, (void)nao;
  return pq::launch_value_mo<float>((const float*)X, (const float*)C, (float*)out,
                                    (const float*)tab, (const int*)meta, M, norb,
                                    (cudaStream_t)stream);
}

int pq_value_mo_f64(const void* X, const void* C, void* out, const void* tab, int ntab,
                    const void* meta, int nmeta, int M, int norb, int nao, void* stream) {
  (void)ntab, (void)nmeta, (void)nao;
  return pq::launch_value_mo<double>((const double*)X, (const double*)C, (double*)out,
                                     (const double*)tab, (const int*)meta, M, norb,
                                     (cudaStream_t)stream);
}

}  // extern "C"
