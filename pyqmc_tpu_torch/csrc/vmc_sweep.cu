// The Metropolis sweep of VMC: the vmc mode of the sweep kernel template
// in sweep_kernel.cuh, which holds the design notes.
//
// Replaces pyqmc_tpu/ops/move_pallas.py:build_fused_sweep (mode="vmc").
#include "sweep_kernel.cuh"

// lanes per walker: the fastest of 8, 16 and 32 at 2048 ccECP H2O walkers
// on an H100 (tools/time_k1_k5.py, PERF.md)
constexpr int LANES = 16;

extern "C" {

int pq_vmc_sweep_f32(const void* state_in, void* state_out, const void* gauss, const void* unif,
                     void* sums, const void* tab, int ntab, const void* meta, int nmeta,
                     const void* plan, int nplan, int nconf, int nrows, int nelec, int nao,
                     int nprim, int nmax, double tstep, double drift_cutoff,
                     void* stream) {
  return pq::launch_sweep<float, LANES, false>(
      (const float*)state_in, (float*)state_out, (const float*)gauss, (const float*)unif,
      (float*)sums, (const float*)tab, ntab, (const int*)meta, nmeta, (const int*)plan, nplan,
      nconf, nrows, nelec, nao, nprim, nmax, tstep, drift_cutoff,
      (cudaStream_t)stream);
}

int pq_vmc_sweep_f64(const void* state_in, void* state_out, const void* gauss, const void* unif,
                     void* sums, const void* tab, int ntab, const void* meta, int nmeta,
                     const void* plan, int nplan, int nconf, int nrows, int nelec, int nao,
                     int nprim, int nmax, double tstep, double drift_cutoff,
                     void* stream) {
  return pq::launch_sweep<double, LANES, false>(
      (const double*)state_in, (double*)state_out, (const double*)gauss, (const double*)unif,
      (double*)sums, (const double*)tab, ntab, (const int*)meta, nmeta, (const int*)plan, nplan,
      nconf, nrows, nelec, nao, nprim, nmax, tstep, drift_cutoff,
      (cudaStream_t)stream);
}

}  // extern "C"
