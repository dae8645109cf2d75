// The Metropolis sweep of VMC: the vmc mode of the sweep kernel template
// in sweep_kernel.cuh, which holds the design notes.
//
// Replaces pyqmc_tpu/ops/move_pallas.py:build_fused_sweep (mode="vmc").
#include "sweep_kernel.cuh"

extern "C" {

int pq_vmc_sweep_f32(const void* state_in, void* state_out, const void* gauss, const void* unif,
                     void* sums, const void* tab, int ntab, const void* meta, int nmeta, int nconf,
                     int nrows, int nmax, double tstep, double drift_cutoff, void* stream) {
  return pq::launch_sweep<float, false>(
      (const float*)state_in, (float*)state_out, (const float*)gauss, (const float*)unif,
      (float*)sums, (const float*)tab, ntab, (const int*)meta, nmeta, nconf, nrows, nmax, tstep,
      drift_cutoff, (cudaStream_t)stream);
}

int pq_vmc_sweep_f64(const void* state_in, void* state_out, const void* gauss, const void* unif,
                     void* sums, const void* tab, int ntab, const void* meta, int nmeta, int nconf,
                     int nrows, int nmax, double tstep, double drift_cutoff, void* stream) {
  return pq::launch_sweep<double, false>(
      (const double*)state_in, (double*)state_out, (const double*)gauss, (const double*)unif,
      (double*)sums, (const double*)tab, ntab, (const int*)meta, nmeta, nconf, nrows, nmax, tstep,
      drift_cutoff, (cudaStream_t)stream);
}

}  // extern "C"
