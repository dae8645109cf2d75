// The drift-diffusion sweep of fixed-node DMC: the dmc mode of the sweep
// kernel template in sweep_kernel.cuh, which holds the design notes.
//
// Replaces pyqmc_tpu/ops/move_pallas.py:build_fused_sweep (mode="dmc"), the
// Pallas TPU kernel: Umrigar drift limiting, rejection of moves across the
// node (ratio <= 0), and the per-walker sums r2p (every proposal) and r2a
// (accepted proposals) of |gauss + tau * drift_old|^2 that the effective
// time step tdamp = r2a / r2p needs. `sums` is (3, nconf): accepted moves,
// r2p, r2a.
//
// What bounds it: as the vmc mode, the latency of each move's chain of
// dealt passes; the two extra outputs add 2 * nconf values to the pass
// over the state.
#include "sweep_kernel.cuh"

// lanes per walker: the fastest of 8, 16 and 32 at 2048 ccECP H2O walkers
// on an H100 (tools/time_k1_k5.py, PERF.md)
constexpr int LANES = 16;

extern "C" {

int pq_dmc_sweep_f32(const void* state_in, void* state_out, const void* gauss, const void* unif,
                     void* sums, const void* tab, int ntab, const void* meta, int nmeta,
                     const void* plan, int nplan, int nconf, int nrows, int nelec, int nao,
                     int nprim, int nmax, double tstep,
                     void* stream) {
  return pq::launch_sweep<float, LANES, true>(
      (const float*)state_in, (float*)state_out, (const float*)gauss, (const float*)unif,
      (float*)sums, (const float*)tab, ntab, (const int*)meta, nmeta, (const int*)plan, nplan,
      nconf, nrows, nelec, nao, nprim, nmax, tstep, 0.0,
      (cudaStream_t)stream);
}

int pq_dmc_sweep_f64(const void* state_in, void* state_out, const void* gauss, const void* unif,
                     void* sums, const void* tab, int ntab, const void* meta, int nmeta,
                     const void* plan, int nplan, int nconf, int nrows, int nelec, int nao,
                     int nprim, int nmax, double tstep,
                     void* stream) {
  return pq::launch_sweep<double, LANES, true>(
      (const double*)state_in, (double*)state_out, (const double*)gauss, (const double*)unif,
      (double*)sums, (const double*)tab, ntab, (const int*)meta, nmeta, (const int*)plan, nplan,
      nconf, nrows, nelec, nao, nprim, nmax, tstep, 0.0,
      (cudaStream_t)stream);
}

}  // extern "C"
