#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's seven paths (pyqmc_tpu_torch, never jax), float32: on
ccECP/cc-pVDZ H2O Slater-Jastrow, 2048 walkers, with the energy
accumulator and its nonlocal ECP quadrature every step, VMC in 50-step
blocks and fixed-node DMC with T-moves (`rundmc`) in 10-step blocks; on
the 2x2x2 diamond-C supercell (`diamond_setup`, 500 walkers, 64
electrons, k-point Slater-Jastrow, Ewald, downselected ECP) periodic VMC
and periodic fixed-node DMC with T-moves, both in 10-step blocks; and on
the same H2O with the full-valence CASCI(8e,8o) expansion, 1,098
determinants (`h2o_casci_setup`, 2048 walkers), VMC and DMC with T-moves;
the wavefunction optimization of the two-body Jastrow and then of the two-
and three-body Jastrow; and BASELINE config 3, the CASCI expansion times the
two- and three-body Jastrow (`h2o_casci_j3_setup`, 2048 walkers), VMC and
DMC with T-moves; and BASELINE config 5, the diamond supercell at a general
twist (complex orbitals) with VMC and DMC with T-moves, and its two-twist
average; and the observables (density matrices, S^2, S(q), symmetry) on
H2O and the diamond, and the excited states of H2O (overlap sampling and
the ensemble optimization); and the front door: the molecular front end
(basis and ECP library, integrals, SCF, CASCI) from a geometry string on
the host, the recipes OPTIMIZE, VMC and DMC on the card from its SCF, and
the He and H-atom anchors; the VMC, DMC and optimizer restart from
checkpoint contents and their profiler traces, and the complex-orbital
optimization; and the walker mesh (one NCCL rank, two gloo ranks sharing
the card) through VMC, DMC with its global comb, the line minimization,
the overlap sampling, the VMC recipe and the diamond's VMC; and the slab
Ewald sum.

  0. the card's name and power limit (nvidia-smi); no CUDA device -> fail
  1. build the CUDA kernels from csrc/ (one nvcc per source, side by side)
  2. each of the four kernels against its plain PyTorch version on the
     card, at the main path's shapes, from one state and one set of random
     streams:
       float64: positions and every state leaf to 1e-9, the same moves
       accepted, r2p / r2a of the dmc sweep to 1e-9, ECP energy to rtol
       1e-9;
       float32: ECP energy to rtol 1e-4; for the sweeps, the walkers whose
       accept decisions differ are counted (<= 1%) and the walkers that
       agree must match to 1e-4 (positions, phases, log|det|, Jastrow U,
       orbital caches, r2p, r2a). In float32 the kernel and the plain
       version sum in other orders, so a move whose acceptance probability
       lies within rounding of its uniform, a proposal within rounding of
       the node (dmc sweep) or a selection uniform within rounding of a
       cumulative probability (T-move sweep) can flip, after which that
       walker's chain differs; float64 leaves no such flips at this size.
       The inverses of agreeing walkers match to 1e-4 in norm, relative,
       times max(1, cond/100), cond being the largest condition number of
       the walker's orbital matrices along the sweep: the rounding error
       of an inverse updated in float32 grows with it, and it is large
       near a node.
     The vmc sweep and the ECP energy run at tstep 0.5, the dmc sweep and
     the T-move sweep at tstep 0.02, and the T-move sweep once more at
     tau 0.5, where a sizeable share of walkers takes a T-move (printed).
     Then each kernel's time beside its plain version's (CUDA events) and
     its bound: the larger of its bytes over 3.35 TB/s and its float32
     operations over 67 TFLOP/s, both counted from this run's shapes and
     accepted moves (`kernel_bounds`); for K1, K2, K4 and K5, the kernels
     redesigned for this card (a group of lanes per walker), also the
     device time of one launch from CUDA events over 50 launches of the C
     entry point back to back, the wrapper's time the same way, and the
     bound's share of the device time (`redesigned_times`).
     Last, the float64 blocks: one 10-step VMC block (K1, K2) and one
     10-step DMC block with T-moves (K4, K5, K2) of 512 walkers, each run
     through make_vmc_block / make_dmc_block with the kernels and with
     fused=False (and a plain ECP energy) on the same streams: positions,
     the state leaves after every step (a probe accumulator keeps them),
     every energy and the weights agree to 1e-9 (absolute, and relative
     for large entries), the acceptances exactly (at 512 walkers the
     means of accepted moves are exact in both summation orders). This
     holds the kernels over a whole chain.
  3. the VMC path through the entry points: h2o_setup + vmc(), 4 blocks
     x 50 steps with the kernels; the launch counts must be 200 sweeps and
     200 ECP evaluations; energies finite; the mean total energy of the
     last two blocks in (-17.2, -16.8) Ha and the acceptance in
     (0.5, 0.75). These windows catch a missing ECP (+1 Ha) or a
     low-precision matmul bias; they are no bar for speed. The energy
     must repeat the lane-group kernels' chain (H2O_VMC_E) within 1e-4
     Ha: the H2O draws do not change. It must also lie within 3 combined
     standard errors of the chain of the one-thread-per-walker kernels
     (H2O_VMC_E_ONE_THREAD): the standard error of the pinned mean is the
     scatter of the blocks after the first (reblock_by2's first level)
     over the square root of the blocks it averages, the same for the
     earlier chain, so the combined one is sqrt(2) times it.
  4. one 5-step VMC block with the kernels and one with the plain
     versions, timed in turns (plain, kernel, kernel, plain)
  5. one kernel-path VMC block under torch.profiler: the device's busy
     time (the sum of its kernel and copy times), the launches per step,
     the kernels that take most device time and the port's kernels' device
     time per launch (phase 2's CUDA-event times include the wrappers'
     host work); the idle share against the traced block's wall time and
     against phase 4's untraced kernel block
  6. the DMC path through the entry points: h2o_setup (default device) +
     rundmc(), 6 blocks x 10 steps at tstep 0.02 after 5 VMC warm-up
     blocks. Launch counts: 60 dmc sweeps, 60 T-move sweeps, 50 vmc sweeps
     (the warm-up) and 50 + 1 + 6 * 11 = 117 ECP evaluations (warm-up
     steps, the energy that sets e_trial, and per block its first energy
     plus one per step). Every energy and weight finite; block mean weight
     in (0.5, 2); acceptance above 0.9; the mean total energy of the last
     three blocks in (-17.6, -16.9) Ha and not above the warm-up VMC
     energy by more than 0.05 Ha. These windows catch a missing ECP, a
     broken branching weight or a sign error in the T-moves. The energy
     must repeat H2O_DMC_E within 1e-4 Ha and lie within 3 combined
     standard errors of H2O_DMC_E_ONE_THREAD, as in phase 3.
  7. one 10-step DMC block with the kernels and one with the plain
     versions, timed in turns, then one kernel-path DMC block under
     torch.profiler as in phase 5
  8. the periodic kernels against their plain versions at the diamond
     supercell's shapes, float64 and float32, with the tolerances of phase
     2: K7 in both modes (the periodic sweep; wrap counts too, and in the
     dmc mode r2p and r2a, at tstep 0.02 and at tstep 0.5, where half of
     the walkers get unif = 0 so that their rejections are the node's;
     the moves that wrapped and the node rejections are printed; the
     diamond's 32 x 32
     orbital matrices reach path condition numbers of 1e6, so in float32
     the leaves other than the inverses are held to the plain version in
     float64 from the same inputs: over the walkers whose decisions agree
     in all three runs, each leaf's largest error of the kernel against it
     must be at most 3 times the plain float32 version's plus 1e-5, and
     the walkers where the kernel is farther than that are counted; the
     inverses keep phase 2's 1e-4 x max(1, cond/100) gate), K6 (AO
     values, gradients, laplacians at one kinetic-energy chunk, 16,000
     points) and K3 (MOs at
     one ECP chunk, 252,000 points; and at H2O's 23 AOs on its ECP
     points); K3 and K6 to 1e-9 (f64) and 1e-4 (f32) of their entries plus
     the largest entry's magnitude (sums of 489 terms). Times and bounds as
     in phase 2; for K3 (at 252,000 points and at the T-move quadrature's
     48,000) and K7 (both modes), the kernels redesigned for this card,
     also the device time of one launch from CUDA events over 50 launches
     of the C entry point back to back, the wrapper's time the same way,
     and the bound's share of the device time (`redesigned_times`).
  9. the periodic VMC path through the entry points: diamond_setup(500) on
     the default device + vmc(), 8 blocks x 10 steps; launch counts per
     block exactly 10 K7, 20 K6 and 40 K3 (1, 2 and 4 per step); the energy
     per primitive cell of the last 4 blocks within max(5 x combined SEM,
     0.02 Ha) of the JAX package's CPU reference (tools/
     diamond_jax_reference.py) and the acceptance within 0.05 of its
     acceptance
  10. one periodic 1-step block with the kernels and one with the plain
     versions (make_vmc_block(fused=False): the plain sweep, the orbitals
     without K3 and K6), timed in turns,
     then one 10-step kernel block under torch.profiler as in phase 5
  11. the periodic DMC path through the entry points: diamond_setup(500)
     on the default device + rundmc(), 2 blocks x 10 steps at tstep 0.02
     after 4 VMC warm-up blocks. Launch counts exactly: 40 K7-vmc (the
     warm-up), 10 K7-dmc per block, none of K1, K2, K4, K5 (the T-move
     sweep stays plain on a lattice, as in the JAX package), K6 and K3 as
     each energy issues them (2 and 4) and K3 once per electron per
     T-move sweep (the dense quadrature's ratios). Every energy and weight
     finite; each block's mean weight within a factor of 2 of the weight
     that its e_trial and its energy predict (`predicted_weights`: the
     weights rise while e_trial lags the energy's fall from the warm-up
     VMC's, beyond 2 in the JAX package's runs on this schedule, so the
     fixed window (0.5, 2) of phase 6 would reject the reference itself);
     acceptance above 0.9; the energy per primitive cell of both
     blocks within max(5 x combined SEM, 0.02 Ha) of the JAX package's CPU
     reference on the same schedule (tools/diamond_dmc_jax_reference.py)
     and not above the warm-up VMC energy per cell by more than 0.02 Ha
  12. the T-move sweep of one step alone (CUDA events), then one periodic
     1-step DMC block with the plain versions (make_dmc_block(fused=False))
     and one with the kernels, timed in turns, then a 1-step kernel block
     under torch.profiler as in phase 5 (the profiler's read-back of a
     10-step block's 1.4 million device events took minutes)
  13. K3 at the multi-determinant path's shapes (2048 walkers of
     h2o_casci_setup, 23 AOs, 16 columns: the energy's 98,304 ECP points
     and one electron's 12,288 T-move points), in both layouts against its
     plain version, float64 to 1e-9 and float32 to 1e-4 of each entry plus
     the largest entry's magnitude; the device time of one launch (CUDA
     events over 50 launches of the C entry point), the wrappers' times,
     the plain version's, the bound (`value_mo_bound`) and the device ns
     per point beside the diamond's (phase 8)
  14. the CASCI anchor: h2o_casci_setup(jastrow=False), the bare
     multi-determinant Slater, + vmc(), 5 blocks x 50 steps; launch counts
     exactly 50 K3 per block (one per energy: the plain ECP chain's flat
     ratio call) and none of the others; the mean of the blocks after the
     first 2 within 5 x max(SEM, 1e-3) of E_CASCI (the reference's
     criterion, tests/integration/test_casci.py) and more than 3 SEM below
     E_HF, so that a port keeping only the leading determinant fails
  15. multi-Slater-Jastrow VMC: h2o_casci_setup (default device) + vmc(),
     4 blocks x 50 steps, 50 K3 per block and nothing else; the mean of the
     blocks after the first 2 within max(5 x combined SEM, 0.005 Ha) of the
     JAX package's CPU reference on the same schedule
     (tools/h2o_casci_jax_reference.py) and the acceptance within 0.05 of
     its; then one 5-step block with K3 and one inside plain_orbitals() on
     the same streams, timed in turns: positions and acceptance identical
     (the sweep reads no value-only orbitals), energies within 1e-5
     relative; then a 3-step block under torch.profiler as in phase 5; then
     the pieces of a step alone (CUDA events): the plain sweep, the kinetic,
     ECP and Coulomb energies, the recompute; then the per-walker ECP
     energies (before the mean) with K3 against plain orbitals on one set of
     rotations, to 1e-4 of each walker's energy plus the largest one's
     magnitude
  16. multi-Slater-Jastrow DMC: rundmc() from phase 15's walkers, 2 blocks
     x 10 steps at tstep 0.02 with T-moves after 2 VMC warm-up blocks;
     launch counts exactly: K3 once per energy and once per electron per
     T-move sweep, none of K1, K2, K4, K5 (their gates take the determinant
     of the first n orbitals only); block mean weights in (0.5, 2),
     acceptance above 0.9, the energy of the 2 blocks in (-17.6,
     -16.9) Ha and at most 0.05 Ha above the warm-up VMC's; then one
     kernel-path block timed, the T-move and drift-diffusion sweeps alone,
     and a 1-step block under torch.profiler
  17. wavefunction optimization of the H2O Jastrow: generate_wf on the
     committed checkpoint (33 free coefficients: 24 acoeff, 9 bcoeff), 4 x
     10 VMC steps of equilibration (K1 only), then line_minimization with
     its defaults (10 x 10 SR steps, 6 step lengths by correlated
     sampling) for 20 iterations; launches exactly 100 K1 and 107 K2 per
     iteration and nothing else; every record finite, the last iteration's
     energy at least 0.1 Ha below the first's, the parameters moved; each
     iteration's energy, |g|, tau, stall flag and wall time (SR VMC blocks,
     host solve, correlated sampling). Then 6 x 50 VMC steps with the
     optimized parameters (300 K1, 300 K2): the mean of the blocks after
     the first below -17.10 Ha and within max(5 x combined SEM, 0.01 Ha) of
     the JAX package's CPU reference on the same schedule
     (tools/h2o_opt_jax_reference.py). With the optimized parameters, one
     10-step block with the kernels and one with fused=False and a plain
     ECP energy on one set of streams (phase 2's float32 tolerances: at
     most 1% of the walkers' chains apart, the energies of the others to
     1e-4 relative), and the last iteration's 7 parameter sets' correlated
     energies with K2 and plain on one rotation draw (energies to 1e-4
     relative, ess to 1e-4). One step's SR averages in float32 and float64
     on the same walkers (S, its conditioning and the SR step: printed).
     One 10-step SR block timed and traced under torch.profiler as in
     phase 5, and the SR step's pieces alone (CUDA events)
  18. DMC with the optimized Jastrow: rundmc() from phase 17's walkers, 2
     VMC warm-up blocks, 30 x 10 steps at tstep 0.02 with T-moves; launch
     counts as in phase 6 (per block 10 K4, 10 K5, 11 K2, plus the
     warm-up's K1 and K2); block weights in (0.5, 2), acceptance above
     0.9; the energy of blocks 11-30 in (-17.27, -17.22) Ha and at least
     0.03 Ha below phase 17's VMC energy; its distance to the README's
     tau = 0.02 value (the JAX package on a TPU) printed

  19. the new wavefunctions' contracts on the card, float64, 64 walkers:
     testwf.run_all on ThreeBodyJastrow, GeminalJastrow, GPSJastrow (seeded
     nonzero coefficients) and MultiplyWF(Slater, JastrowSpin,
     ThreeBodyJastrow) (generate_wf(jastrow3=True)); the JAX package's AddWF
     checks (tests/unit/test_more_wfs.py:39-49) on AddWF(ground
     determinant, single excitation); a ThreeBodyJastrow with the
     cutoffcusp function in its b basis in float32, whose f'/r is 1e12 at
     the self pair's r = 0: its U, gradients and laplacians at the walkers'
     own positions and its ECP-style ratios finite and within
     CUSP32_RTOL of the same in float64
  20. the three-body Jastrow optimized at 2048 walkers, float32:
     generate_wf(mol, mf, jastrow3=True) (276 free coefficients) from phase
     17's optimized two-body coefficients with ccoeff at zero and phase 17's
     walkers; line_minimization for 6 iterations of 5 x 10 SR steps (a third
     factor is outside the K1/K2 gates: plain sweep and ECP chain, K3 once
     per energy, exactly 57 per iteration); each iteration's energy, |g|,
     SR step and launches; then 3 x 25 VMC steps (75 K3): every energy
     finite, the mean of the blocks after the first no higher than phase
     17's by 3 combined SEM and within J3_OPT_BOUND of the JAX CPU
     reference on the same schedule (tools/h2o_j3_jax_reference.py opt)
  21. BASELINE config 3 VMC: h2o_casci_j3_setup (the CASCI expansion x the
     two- and three-body Jastrow on the committed coefficients) + vmc(), 4
     x 50 steps, exactly 50 K3 per block and nothing else; the mean of the
     blocks after the first within 3 combined SEM of the JAX CPU reference
     at the same coefficients (tools/h2o_j3_jax_reference.py vmc); a
     512-walker 3-step float32 block with K3 and one inside
     plain_orbitals() on one set of streams (positions and acceptance
     identical, energies to 1e-5 relative: K3's gate is float32, so a
     float64 block launches none); a 3-step block under torch.profiler;
     the pieces of a step alone and the three-body Jastrow's share of the
     sweep, kinetic energy, ECP ratios and recompute; the per-walker ECP
     energies with K3 against plain orbitals as in phase 15
  22. config 3 DMC: rundmc() from phase 21's walkers, 2 VMC warm-up blocks
     and 2 x 10 steps at tstep 0.02 with T-moves; K3 exactly once per
     energy and once per electron per T-move sweep (91 per block), none of
     the others; phase 16's windows; the T-move and drift-diffusion sweeps
     alone

  23. BASELINE config 5's kernels on the general twist (diamond_twist_setup:
     the diamond supercell's k-points shifted by (0.023, -0.017, 0.011),
     complex orbitals), float64 and float32 (`twist_k3`): K3's pair launch
     over [Re R | Im R] (489 AOs x 128 columns) against its plain version
     at the ECP chunk's 252,000 points and the T-move quadrature's 48,000,
     as the pair columns and as the complex MO values; the per-walker ECP
     energies before the mean with K3 against plain orbitals (1e-9, 1e-4 of
     each entry plus the largest one's magnitude); in float32 K3's device
     time at that shape beside its bound; then testwf.run_all on the
     general-twist Slater-Jastrow in float64 at 64 of phase 9's walkers
     (at initial_guess's, piled near the nuclei, testwf's finite-difference
     laplacian is roundoff-bound)
  24. general-twist VMC: diamond_twist_setup(500) on the default device +
     vmc() from phase 9's walkers, 3 blocks x 10 steps; per block exactly
     20 K6 and 40 K3 (the pair launch) and no K7 (a complex wavefunction
     runs the plain sweep); the energy per cell of the blocks after the
     first within max(5 x combined SEM, 0.02 Ha) of the JAX package's CPU
     reference (tools/diamond_twist_jax_reference.py vmc), the acceptance
     within 0.05 of its; a 1-step block under torch.profiler (step time,
     device busy time, idle share, events per step); the pieces of a step
     alone and the largest condition number of the orbital matrices along
     one sweep
  25. general-twist DMC with T-moves: rundmc() from phase 24's walkers (VMC
     equilibrated, so no warm-up) and 2 x 10 steps at tstep 0.02; launch counts
     exactly (K6 and K3 per energy, K3 once per electron per T-move sweep,
     no sweep kernel); each block's weight within a factor of 2 of the
     weight its e_trial and energy predict (phase 11's window), acceptance
     above 0.9; the energy per cell of both blocks within max(5 x
     combined SEM, 0.02 Ha) of the JAX CPU reference on the same DMC
     schedule (tools/diamond_twist_jax_reference.py dmc) and not above the
     warm-up VMC's by more than 0.02 Ha
  26. the two-twist average: twist_average_vmc over the union of the 8
     TRIM k-points and the same 8 shifted (diamond_twist_average_setup),
     3 blocks x 10 steps per twist, the TRIM twist from phase 9's walkers
     and the general one from phase 24's: exactly two twists, real mode
     at the TRIM one only; per twist launches exactly (K7 10 per block at
     the TRIM twist, none at the general one; K6 and K3 as in phase 24);
     each twist's energy per cell (twist_average_vmc's rule: the blocks
     after the first) within max(5 x combined SEM, 0.02 Ha) of its JAX CPU
     reference (tools/diamond_twist_jax_reference.py average), and the
     reported average the mean of the two

  27. the observables in VMC: h2o_setup (phase 3's wavefunction) + vmc(),
     3 blocks x 20 steps with accumulate_every 2 and the energy, the OBDM
     of each spin in all 23 MOs, the TBDM of spins (0, 1) and (0, 0) in the
     8 lowest MOs (the CASCI active space), S^2 and the symmetry operations
     C2z, sigma(xz), sigma(yz) about the origin; launch counts exactly (60
     K1, 30 K2, and per accumulated step 60 K3: 3 per OBDM, 3 + 2 per up
     electron per TBDM, 2 per exchanged pair for S^2); the blocks after
     the first: the OBDM's occupied diagonal per spin, its trace, S^2 and
     sum_ij TBDM^(up,down)[i, j, i, j] over the occupied i, j each within
     max(5 x combined SEM, 0.02) of the JAX CPU reference on the same
     schedule (tools/observables_jax_reference.py h2o); each symmetry
     value's block mean within 1e-3 of +1 (the RHF ground state is totally
     symmetric) and at 99% of the final walkers within 1e-3; each new K3
     use (OBDM, TBDM, S^2) against plain_orbitals() on the same walkers and
     draws, float32, within 1e-3 of each entry plus the walker's largest
     (S^2: the largest walker's); one call of each accumulator timed
  28. DMC with the mixed-estimator OBDM: rundmc() from phase 27's walkers,
     2 VMC warm-up blocks and 4 x 10 steps at tstep 0.02 with T-moves and
     the OBDM of each spin (its own auxiliary points); launches exactly
     (per block 10 K4, 10 K5, 11 K2 and 60 K3); the energy of the last 3
     blocks in phase 6's (-17.6, -16.9) Ha; the occupied diagonals within
     0.05 of phase 27's
  29. the periodic observables: diamond_setup(500) + vmc() from phase 9's
     walkers, 3 x 10 steps with the energy, the KOBDM of each spin and
     SqAccumulator(cell) (728 q); launches exactly (per step phase 9's
     1 K7, 2 K6, 4 K3 and 3 K3 per KOBDM); normalize_obdm's diagonal per
     orbital within max(5 x combined SEM, 0.02) of the JAX CPU reference
     (tools/observables_jax_reference.py diamond), S(q) on the outermost
     q-shell within 0.1 of 1; the KOBDMs against plain_orbitals() per
     walker (1e-3), S(q) and spinSq per walker against float64 on the same
     positions (1e-4); one KTBDM evaluation of spins (0, 1) at 64 walkers
     (64 x 32^4 entries) with K3 against plain
  30. the excited states: h2o_excited_setup (state 0 phase 3's
     Slater-Jastrow, state 1 the up electron moved from MO 3 to MO 4):
     sample_overlap, 3 x 10 steps with the energy and an adapted S^2 (the
     plain two-state sweep; K2 for state 0's energy, K3 for state 1's ECP
     chain and every S^2 testvalue, exactly); the blocks after the first:
     normalized |O01| below 0.1, E1 above E0 + 0.1 Ha, E0, E1 and each
     state's S^2 within max(5 x combined SEM, 0.02 Ha or 0.05) of the JAX
     CPU reference (tools/observables_jax_reference.py excited), S^2 within
     0.1 of 0 and 0.15 of 1; state 1's S^2 and ECP energy per walker with
     K3 against plain; the sweep alone and a traced 2-step block (idle
     share); then optimize_ensemble (state 0 frozen, the superposition of
     the ground and excited determinants with det_coeff (0.5, 0.8), its
     det_coeff optimized; penalty 4, tau 0.3, 2 iterations of 2 x 10
     steps): launches exactly, every record finite, each iteration's |O01|
     and E1 within max(5 x combined SEM, 0.05) of the reference's, the
     ground determinant's share printed after every iteration and below
     0.580 after the last (the JAX test's bound)

  31. the front end on the host, from the geometry string of
     __graft_entry__._h2o_setup: Molecule(..., basis="ccecp-ccpvdz",
     ecp="ccecp") from the port's own basis and ECP library, its shell
     table and ECP equal to the committed checkpoint's (system/io.load_npz:
     23 AOs, exponents and coefficients to 1e-12 relative); the integrals,
     ecp_matrix and run_scf: e_tot within 1e-5 Ha of the checkpoint's and
     1e-8 of the JAX package's own SCF (tools/recipes_jax_reference.py
     scf); run_casci(mf, 8, (4, 4)) at the committed expansion's tol: E_CASCI
     within 1e-5 Ha of the committed one and the same determinant set; the
     SCF of He/STO-3G, H2/STO-3G at 1.4 bohr, H2O/STO-3G and the H atom in
     cc-pVDZ (UHF) within 1e-5 Ha of the JAX package's. The host seconds
     of each step are printed.
  32. the recipes on the card from phase 31's SCF (2048 walkers):
     OPTIMIZE(mf=mf, max_iterations=5) (per iteration exactly 100 K1 and
     107 K2, the first also OPTIMIZE's 40 equilibration K1), VMC(params=)
     8 x 25 steps from new walkers (200 K1, 200 K2), the mean of the blocks
     after the first 2 within 5 x sqrt(SEM^2 + the reference's SEM^2 + the
     spread of its runs^2) (at least 0.005 Ha) of the JAX CPU reference on
     the same schedule (tools/recipes_jax_reference.py), DMC(params=,
     tstep=0.02) 2 warm-up + 6 x 10 steps (launches as phase 6; weights in
     (0.5, 2), acceptance above 0.9, the last 3 blocks in (-17.6, -16.9) Ha
     and not above the warm-up VMC by more than 0.05 Ha; the JAX reference
     printed); then the bare CASCI expansion of phase 31 through
     generate_wf(mol, mf, jastrow=False, mc=...) from the VMC's walkers, 4
     x 20 steps (exactly one K3 per energy, nothing else), the mean of the
     blocks after the first within 5 x max(SEM, 1e-3) of phase 31's E_CASCI
     (phase 14's window); last README's quick start through the port's api
     (all-electron H2O/STO-3G: OPTIMIZE(nconfig=1000), VMC(nconfig=2000),
     depth cut): K1 only, exactly, and a finite VMC energy below the SCF's
  33. the anchors: He/STO-3G Slater VMC (generate_wf(jastrow=False), 400
     walkers, 12 x 20 steps, K1 only) within 5 SEM of its SCF energy; DMC of
     the H atom in cc-pVDZ (the JAX package's recipe test system, 200
     walkers, 2 warm-up + 30 x 10 steps at tstep 0.02; its empty down-spin
     channel runs the plain sweeps, so no kernel launches) within 5 SEM of
     -0.5 Ha
  34. the restart and traces of VMC, DMC and the optimizer (h2o_setup, 2048
     walkers): one VMC
     block and rundmc's first block with profile_dir= (utils/profiling.trace),
     each trace naming exactly the block's K1 and K2, or K4, K5 and K2,
     launches; rundmc for 2 warm-up + 3 blocks holding its restart contents
     in a dict (checkpoint=, what hdf_file= reads back from a file; this
     machine has no h5py), then resumed from them for 3 more: blocks 3-5,
     no warm-up launch, the first resumed block's e_est the mean of the
     saved e_est and its energy and e_trial following it, the block equal
     (1e-5 relative) to the block run by hand from the saved walkers,
     weights, e_trial, e_est and esigma on the generator folded at block 3,
     every energy in phase 6's (-17.6, -16.9) Ha; line_minimization of
     generate_wf's Jastrow (4 x 10 SR steps per iteration) for 2 iterations,
     resumed to 4 from its contents, against 4 uninterrupted ones: iterations
     [2, 3] only, parameter vectors and energies within 1e-6 relative;
     launches exact
  35. the complex-orbital optimization: phase 31's SCF of H2O, its
     occupied MO coefficients times i plus uniform noise in [-0.1, 0.1)
     (default_rng(7), JAX tests/integration/test_complex_linemin.py),
     MultiplyWF(Slater, JastrowSpin); both spins' mo_coeff, acoeff and
     bcoeff optimized (SR's complex channel) for 4 iterations of 5 x 10 SR
     steps at 2048 walkers, then VMC 4 x 20 steps: the last iteration's
     energy below the first's by more than 3 x (err_first + err_last), the
     parameters complex64 and finite, exactly one K3 launch per energy
     (the plain complex sweep launches none), the VMC's blocks after the
     first within 5 x sqrt(SEM^2 + SEM_ref^2 + spread^2) of
     tools/complex_opt_jax_reference.py's; one step's SR averages
     (dpidpjI, S and the step) in float32 against float64 on the same
     walkers printed. Phases 34-35 take at most 60 s; the total is printed
     beside phase 17's time, the host's yardstick
  36. the walker mesh (parallel/mesh.py) on H2O at 2048 walkers in all:
     (a) walker_mesh() in this process, one rank over NCCL: VMC 2 x 10 and
     rundmc 1 warm-up + 2 x 10, each equal to the same run without a mesh
     bit for bit, launches exact (10 K1 and 10 K2 per VMC block; 10 K4, 10
     K5 and 11 K2 per DMC block); (b) two ranks sharing the card over gloo
     (spawned processes, 1024 walkers each, FileStore rendezvous) run VMC 2
     x 10 and rundmc 1 + 2 x 10 with the global comb against one process of
     2048 walkers fed their concatenated streams
     (tests/torch_mesh_ranks.py:emulated_ranks, which imports no JAX): VMC
     positions within 1e-5 (0 expected), block energies 1e-5 relative,
     after the last comb at most 1% of walkers with another parent, DMC
     energies within 1e-4 Ha, every weight of the population equal, each
     rank's launches exact; the gloo collectives that take CUDA tensors
     printed; (c) one line_minimization iteration (4 x 10 SR steps) on the
     two ranks in float32 and in float64: the parameters equal on both
     ranks, within 1e-5 relative of the one-process run in float64 (the
     float32 distance printed: the SR solve carries the float32 averages'
     reduction-order differences through S + 1e-3); (d) the one-rank mesh
     through sample_overlap 1 x 10 (10 K2, 10 K3), the VMC recipe 2 x 10
     and the diamond's VMC 1 x 10 at 500 walkers (10 K7, 20 K6, 40 K3),
     each equal to its run without a mesh bit for bit; the walker-steps/s
     of (a) and (b) printed
  37. Ewald2D on the card: the NaCl monolayer's ii_const / 2 equal to
     -1.6155426267 (1e-8 relative), and the energies of 2048 random
     walkers of 4 electrons within 0.5 bohr of its plane against psi_host
     summed on the host: 1e-9 in float64, 1e-5 relative to the largest in
     float32. Phases 36-37 take at most 60 s

Any failure raises, so the exit code is not 0. The line before the last is
a JSON object of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import json
import subprocess
import time

import numpy as np
import torch

NCONF = 2048
NSTEPS = 50
TSTEP = 0.5
DMC_TSTEP = 0.02
DMC_NSTEPS = 10
TIMED_NSTEPS = 5  # phases 4-5: the VMC blocks timed in turns and traced
DMC_NBLOCKS = 6
DMC_WARMUP = 5
TMOVE_BIG_TAU = 0.5
DIAMOND_NCONF = 500
DIAMOND_NSTEPS = 10
DIAMOND_NBLOCKS = 8
DIAMOND_NLAST = 4  # blocks averaged for the energy check
DIAMOND_NCELL = 8  # primitive cells in the 2x2x2 supercell
# tools/diamond_jax_reference.py on the CPU, float64 (see PERF.md)
DIAMOND_REF = {"e_cell": -10.182775221948061, "sem": 0.007186578622671951,
               "acceptance": 0.6213392469618056}  # 128 walkers, 36 x 10 steps after 4 blocks
PBC_DMC_BIG_TSTEP = 0.5
DIAMOND_DMC_WARMUP = 4  # rundmc's VMC warm-up blocks (10 steps at tstep 0.5)
DIAMOND_DMC_NBLOCKS = 2
DIAMOND_DMC_NLAST = 2  # blocks averaged for the energy check
PBC_TRACE_NSTEPS = 1  # phases 12 and 16's traced blocks (141,000 device events a step)
PBC_TIMED_NSTEPS = 1  # phases 10 and 12: the kernel and plain blocks timed in turns
# tools/diamond_dmc_jax_reference.py 32 6 2 4 2 3 on the CPU, float64, the
# same schedule: 6 runs of 32 walkers, E/cell of the last 2 blocks, its
# standard error over the runs, and each block's mean weight (geometric
# mean over the runs; printed, not checked) (see PERF.md)
DIAMOND_DMC_REF = {"e_cell": -10.723081883729476, "sem": 0.06392524781317865,
                   "e_vmc_cell": -10.153945381096266, "acceptance": 0.98709716796875,
                   "weights": [1.4012265906093078, 2.8029435387316846]}
# H2O energies (phase 3: E of the last 2 VMC blocks; phase 6: E of the last
# 3 DMC blocks). With the one-thread-per-walker K1, K4 and K5 the float32
# chains gave these bits on every card; the lane-group kernels sum in other
# orders, so the chains left them, and the energies must lie within 3
# combined standard errors of them:
H2O_VMC_E_ONE_THREAD = -16.987856
H2O_DMC_E_ONE_THREAD = -17.221627
# and the lane-group kernels' chains, to 1e-4 Ha (bit for bit so far), so
# that work on other paths cannot move them unnoticed:
H2O_VMC_E = -16.987946
H2O_DMC_E = -17.221626
BLOCK_CHECK_NCONF = 512  # walkers of phase 2's float64 blocks (a power of 2: exact means)
# the multi-determinant path (phases 13-16): h2o_casci_setup, 2048 walkers
CASCI_NBLOCKS = 5  # phase 14: 50-step VMC blocks of the bare CASCI expansion
CASCI_NWARM = 2  # blocks dropped before a mean (phases 14 and 15)
CASCI_SJ_NBLOCKS = 4  # phase 15: 50-step multi-Slater-Jastrow VMC blocks
CASCI_DMC_WARMUP = 2  # phase 16: rundmc's VMC warm-up blocks (10 steps at tstep 0.5)
CASCI_DMC_NBLOCKS = 2
CASCI_DMC_NLAST = 2
CASCI_CHECK_NSTEPS = 5  # phase 15's K3 and plain-orbital blocks on one set of streams
CASCI_TRACE_NSTEPS = 3  # phase 15's traced block (the profiler's events of a
# 50-step block take minutes to read back)
# tools/h2o_casci_jax_reference.py 256 10 2 8 on the CPU, float64, the same
# schedule (tstep 0.5, 50-step blocks, the first 2 dropped): 8 runs of 256
# walkers, the mean of their kept blocks and its standard error over the
# runs (see PERF.md)
CASCI_SJ_REF = {"e": -17.003278882783047, "sem": 0.0020749883021948198,
                "acceptance": 0.6176443481445313}
# the optimization path (phases 17-18): generate_wf on the committed H2O, 2048 walkers
OPT_NPARAMS = 33  # generate_jastrow's defaults: 24 acoeff + 9 bcoeff (cusp row frozen)
OPT_EQUIL_BLOCKS = 4  # 10-step VMC blocks before the optimizer, as recipes.OPTIMIZE
OPT_ITERATIONS = 20  # line_minimization's iterations, as tools/h2o_anchor.py
OPT_VMC_BLOCKS = 6  # 50-step VMC blocks with the optimized Jastrow, the first dropped
OPT_CHECK_NSTEPS = 10  # the kernel-against-plain block and the traced SR block
OPT_DMC_WARMUP = 2
OPT_DMC_NBLOCKS = 30
OPT_DMC_NSKIP = 10  # DMC blocks dropped before the energy
# tools/h2o_opt_jax_reference.py 2048 3 20 11 on the CPU, float64, the same
# schedule: 3 runs of 2048 walkers, the mean of their optimized VMC
# energies and its standard error over the runs (see PERF.md)
H2O_OPT_REF = {"e": -17.184953303274973, "sem": 0.0006963918607397805}
# README "Correctness anchors": T-move DMC at tau 0.02 with the optimized
# Jastrow, the JAX package on a TPU (printed beside phase 18, not checked)
H2O_DMC_README = (-17.2429, 0.0013)
# the wavefunctions of phases 19-22 and BASELINE config 3 (h2o_casci_j3_setup)
WF_CHECK_NCONF = 64  # phase 19: run_all on the card, float64
CUSP32_RTOL = 1e-4  # phase 19: float32 against float64, relative to the largest |value|
J3_NPARAMS = 276  # phase 20: 33 two-body + 243 three-body (ccoeff) coefficients
J3_ITERATIONS = 6  # phase 20: line_minimization iterations of J3_SR_BLOCKS x 10 SR steps
J3_SR_BLOCKS = 5
J3_VMC_BLOCKS, J3_VMC_NSTEPS = 3, 25  # VMC blocks with the optimized J2 x J3, the first dropped
J3_OPT_BOUND = 0.01  # Ha: phase 20's VMC against J3_OPT_REF (PERF.md, set before the first run)
# tools/h2o_j3_jax_reference.py opt 2048 2 61 on the CPU, float64, phases 17 and
# 20's schedules: 2 runs of 2048 walkers, the mean of their optimized VMC
# energies and its standard error over the runs (see PERF.md)
J3_OPT_REF = {"e": -17.19870129539305, "sem": 0.0007760304331529966}
CONFIG3_NBLOCKS = 4  # phase 21: 50-step VMC blocks, the first dropped
CONFIG3_CHECK_NCONF, CONFIG3_CHECK_NSTEPS = 512, 3  # phase 21's K3 against plain block
CONFIG3_TRACE_NSTEPS = 3
CONFIG3_DMC_WARMUP, CONFIG3_DMC_NBLOCKS, CONFIG3_DMC_NLAST = 2, 2, 2  # phase 22, as phase 16
# tools/h2o_j3_jax_reference.py vmc 256 8 71 on the CPU, float64, phase 21's
# schedule at the committed coefficients: 8 runs of 256 walkers (see PERF.md)
CONFIG3_REF = {"e": -17.193638541019272, "sem": 0.0011872010833002958,
               "acceptance": 0.592219482421875}
# BASELINE config 5 (phases 23-26): diamond_twist_setup, the 2x2x2 supercell at the
# general twist of benchmarks/c_solid_benchmark.py:130 (complex orbitals), 500 walkers
TWIST_NBLOCKS = 3  # phase 24: 10-step VMC blocks from phase 9's walkers, the first dropped
TWIST_NSKIP = 1
TWIST_TRACE_NSTEPS = 1  # phase 24's traced block
# phase 25, from phase 24's equilibrated VMC walkers, so without a VMC warm-up
TWIST_DMC_WARMUP, TWIST_DMC_NBLOCKS, TWIST_DMC_NLAST = 0, 2, 2
TWIST_AVG_NBLOCKS = 3  # phase 26: 10-step blocks per twist, averaged after max(1, 3 // 4)
# tools/diamond_twist_jax_reference.py on the CPU, float64 (see PERF.md): vmc 64 4 8 4 3
# (4 runs of 64 walkers, 8 blocks kept after 4), phase 24's energy per cell
TWIST_VMC_REF = {"e_cell": -10.181446452474983, "sem": 0.008945233221813065,
                 "acceptance": 0.6205337524414062}
# dmc 32 6 2 4 2 3: 6 runs of 32 walkers, 4 VMC warm-up blocks, 2 DMC blocks, E/cell of
# both and its standard error over the runs, each block's weight (geometric mean)
TWIST_DMC_REF = {"e_cell": -10.687292935344358, "sem": 0.05079940139022643,
                 "e_vmc_cell": -10.254492971456186, "acceptance": 0.9875610351562499,
                 "weights": [1.1971367375551287, 2.088208568112148]}
# average 64 4 8 4 3: per twist (the TRIM one, the general one; sorted as
# twist_average_vmc runs them) 4 runs of 64 walkers, 8 blocks after 4 of
# equilibration, averaged by twist_average_vmc's rule
TWIST_AVG_REF = {"twists": [{"e_cell": -10.189744350181359, "sem": 0.01872049891038652},
                            {"e_cell": -10.18950655135714, "sem": 0.005427665391170084}],
                 "e_cell_average": -10.189625450769249, "e_cell_average_sem": 0.009745725101965072}
# the observables and the excited states (phases 27-30)
OBS_NBLOCKS, OBS_NSTEPS, OBS_EVERY, OBS_NSKIP = 3, 20, 2, 1  # phase 27: VMC, first block dropped
OBS_NCAS = 8  # the TBDMs' orbitals: the CASCI(8e,8o) active space of data/h2o_ccecp_cas88.npz
OBS_NOCC = 4  # occupied orbitals per spin of H2O
# the point group of H2O in the yz plane, its C2 axis on z, about the origin
OBS_SYM = {"c2z": np.diag([-1.0, -1.0, 1.0]), "sxz": np.diag([1.0, -1.0, 1.0]),
           "syz": np.diag([-1.0, 1.0, 1.0])}
OBS_K3_RTOL = 1e-3  # the new K3 uses against plain_orbitals(), float32, per walker
OBS_DMC_WARMUP, OBS_DMC_NBLOCKS, OBS_DMC_NLAST = 2, 4, 3  # phase 28
PBC_OBS_NBLOCKS = 3  # phase 29: 10-step VMC blocks from phase 9's walkers
KTBDM_NCONF = 64  # phase 29's one KTBDM evaluation
EXC_NBLOCKS, EXC_NSKIP = 3, 1  # phase 30's sample_overlap, 10-step blocks
# phase 30's optimize_ensemble; the first ENS_ITERATIONS of the reference's 4 iterations
ENS_ITERATIONS, ENS_NBLOCKS, ENS_PENALTY, ENS_TAU = 2, 2, 4.0, 0.3
ENS_FRAC0_BOUND = 0.5 / float(np.hypot(0.5, 0.8)) + 0.05  # the JAX test's bound, 0.580
# tools/observables_jax_reference.py on the CPU, float64, each schedule of its
# phase; each entry (mean over the runs, standard error over the runs' means)
# (see PERF.md): h2o 512 8 81 (phase 27; 8 runs of 512 walkers)
OBS_REF = {"obdm0_diag": ([1.00218678, 1.00363991, 1.01147956, 0.99872726], [0.00633176,
    0.00776608, 0.00611262, 0.01273368]), "obdm1_diag": ([0.98906569, 0.9951664, 0.98942051,
    0.98849455], [0.00370454, 0.00853451, 0.00362554, 0.00925649]), "obdm0_trace": (4.03693546,
    0.03325624), "obdm1_trace": (3.95698885, 0.02688583), "s2": (8.039e-05, 9.947e-05),
    "tbdm01_occ": (15.92980094, 0.1614828), "energy": (-17.00071819, 0.00485726)}
# diamond 64 4 91 (phase 29; 4 runs of 64 walkers, after 4 equilibration blocks)
PBC_OBS_REF = {"kobdm0_normalized_diag": ([0.999874, 0.999605, 0.999909, 0.999553, 0.999485,
    1.000463, 1.000278, 0.999779, 1.000369, 0.999272, 1.000465, 1.000171, 1.000701, 0.999493,
    0.999703, 1.000303, 1.000113, 1.000015, 0.999846, 1.000025, 1.000262, 0.999762, 0.999775,
    1.000323, 1.000243, 1.000502, 0.999883, 0.999734, 1.000223, 0.999881, 1.000446, 1.00022],
    [0.000381, 0.000251, 0.000405, 0.000462, 0.000418, 0.000177, 0.000362, 0.000268, 0.000325,
    0.000234, 0.000202, 0.000573, 0.000326, 0.000297, 0.000371, 0.00017, 0.000822, 0.000596,
    0.000475, 0.000426, 0.000697, 0.000399, 0.000376, 0.000504, 0.00035, 0.000687, 0.000446,
    0.000318, 0.000184, 0.000281, 0.000639, 0.000414]), "kobdm1_normalized_diag": ([0.999684,
    1.000055, 0.999577, 1.000492, 1.0, 1.000425, 0.999644, 1.000203, 0.999553, 0.99961, 0.999778,
    1.000172, 0.999993, 0.999606, 0.999931, 0.999135, 0.999867, 0.999261, 0.999432, 1.000323,
    0.999843, 1.000027, 0.999739, 0.999856, 0.99957, 1.000347, 0.999901, 1.000287, 0.999423,
    1.000095, 1.000082, 1.000454], [0.000366, 0.000154, 0.000339, 0.000378, 0.00055, 8.3e-05,
    0.000164, 0.000343, 0.000267, 0.00058, 0.00061, 0.000459, 0.000299, 0.000767, 0.000378,
    0.000161, 0.000554, 0.000381, 0.000171, 0.000234, 0.000271, 0.000491, 0.000376, 0.000177,
    0.000277, 0.000286, 0.000462, 0.000522, 0.000346, 0.000124, 0.000299, 0.000714]), "sq_outer":
    (1.000227, 0.006508), "e_cell": (-10.196934, 0.017944)}
# excited 512 8 101 (phase 30; 8 runs of 512 walkers; ens_* per iteration of
# optimize_ensemble, ens_frac0 after its last)
EXC_REF = {"e0": (-16.97963223, 0.00715419), "e1": (-16.58830466, 0.00856158), "s2_0": (0.00011238,
    0.00012291), "s2_1": (1.00246336, 0.00165961), "o01": (0.01198926, 0.00168403), "ens_o01":
    ([0.53989845, 0.21298853, 0.04828623, 0.0430098], [0.00422022, 0.0161845, 0.01192906,
    0.01036828]), "ens_e1": ([-16.75456327, -16.62073176, -16.60701541, -16.54743905], [0.0290876,
    0.027128, 0.02678173, 0.02074364]), "ens_frac0": ([0.05709011], [0.00941567])}
# the front door (phases 31-33): the molecular front end from a geometry string, the
# recipes and the anchors; the geometry of __graft_entry__._h2o_setup, bohr
H2O_ATOM = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
FRONT_END_TOL = 1e-5  # Ha: the SCF and CASCI against the committed checkpoint, the SCF pins
SCF_SYSTEMS = {"he_sto3g": ("He 0 0 0", dict(basis="sto-3g")),
               "h2_sto3g": ("H 0 0 0; H 0 0 1.4", dict(basis="sto-3g")),
               "h2o_sto3g": (H2O_ATOM, dict(basis="sto-3g")),
               "h_ccpvdz_uhf": ("H 0 0 0", dict(basis="ccpvdz", spin=1))}
# tools/recipes_jax_reference.py scf: the JAX package's run_scf of these systems and of
# the ccECP H2O, float64
SCF_PINS = {"he_sto3g": -2.8077839575399755, "h2_sto3g": -1.116714325062571,
            "h2o_sto3g": -74.96302780172712, "h_ccpvdz_uhf": -0.49927840341958324,
            "h2o_ccecp": -16.92653440946893}
RECIPE_SEED = 13
RECIPE_OPT_ITERATIONS = 5  # phase 32: OPTIMIZE's line_minimization iterations (its defaults)
RECIPE_VMC_NBLOCKS, RECIPE_VMC_NSTEPS, RECIPE_VMC_NSKIP = 8, 25, 2  # VMC(params=), new walkers
RECIPE_DMC_NBLOCKS, RECIPE_DMC_WARMUP, RECIPE_DMC_NLAST = 6, 2, 3  # DMC(params=), 10-step blocks
# tools/recipes_jax_reference.py 2048 4 5 13 1 on the CPU, float64, phase 32's schedule:
# 4 runs of 2048 walkers (seeds 13, 23, 33, 43); the mean of their VMC energies, its
# standard error and the spread (standard deviation) of the runs' means (see PERF.md)
RECIPE_REF = {"e_vmc": -17.1804199808164, "sem_vmc": 0.0014426636818832778,
              "spread_vmc": 0.0028853273637665555, "e_dmc": -17.22220302494739,
              "sem_dmc": 0.003022346136309868, "spread_dmc": 0.006044692272619736}
CASCI_FD_NBLOCKS, CASCI_FD_NSTEPS, CASCI_FD_NSKIP = 4, 20, 1  # phase 32's CASCI VMC
QUICK_OPT_ITERATIONS, QUICK_SR_BLOCKS, QUICK_VMC_NBLOCKS = 2, 2, 4  # the quick start, cut
HE_NCONF, HE_NBLOCKS, HE_NSTEPS, HE_NSKIP = 400, 12, 20, 2  # phase 33's He VMC
H_NCONF, H_DMC_WARMUP, H_NBLOCKS, H_NSKIP = 200, 2, 30, 4  # phase 33's H-atom DMC
# the restart and traces of VMC, DMC and the optimizer (phase 34): H2O (h2o_setup), 2048 walkers
TRACE_NSTEPS = 10  # the traced VMC and DMC blocks (profile_dir=)
RESTART_DMC_WARMUP, RESTART_DMC_NBLOCKS = 2, 3  # DMC run, then resumed for as many blocks
RESTART_OPT_SPLIT, RESTART_OPT_ITERATIONS, RESTART_OPT_SR_BLOCKS = 2, 4, 4  # linemin, 10-step SR
RESTART_RTOL = 1e-6  # the resumed line minimization against the uninterrupted one
# the complex-orbital optimization (phase 35): H2O from phase 31's SCF, mo_coeff times i plus
# uniform noise in [-0.1, 0.1) (default_rng(7)), both spins' mo_coeff, acoeff, bcoeff optimized
COMPLEX_ITERATIONS, COMPLEX_SR_BLOCKS = 4, 5  # line_minimization, 10-step SR blocks
COMPLEX_VMC_NBLOCKS, COMPLEX_VMC_NSTEPS, COMPLEX_VMC_NSKIP = 4, 20, 1
COMPLEX_SEED = 17
# tools/complex_opt_jax_reference.py 2048 4 4 5 17 2 on the CPU, float64, phase 35's
# schedule: 4 runs of 2048 walkers (seeds 17, 27, 37, 47); the mean of their VMC energies
# (blocks after the first), its standard error and the spread of the runs' means, and their
# first and last iterations' energies (see PERF.md)
COMPLEX_REF = {"e_vmc": -17.168437806445134, "sem_vmc": 0.0030806459486583853,
               "spread_vmc": 0.0061612918973167705, "e_first": -16.261685685878643,
               "e_last": -17.147101696302954}
# the walker mesh (phase 36): H2O (h2o_setup), 2048 walkers in all, 10-step blocks
MESH_VMC_NBLOCKS, MESH_DMC_WARMUP, MESH_DMC_NBLOCKS = 2, 1, 2
MESH_SR_BLOCKS = 4  # (c) one line_minimization iteration of 4 x 10 SR steps
MESH_OVERLAP_NSTEPS = 10  # (d) one sample_overlap block
MESH_RANK_TIMEOUT = 600.0  # s the parent waits for the two ranks of (b)-(c)
MESH_POS_ATOL = 1e-5  # (b) VMC positions of two ranks against one process (0 expected)
MESH_VMC_RTOL = 1e-5  # (b) VMC block energies, relative
MESH_DMC_ATOL = 1e-4  # (b) DMC block energies, Ha
MESH_PARENT_SHARE = 0.01  # (b) walkers with another parent after the last comb, at most
MESH_OPT_RTOL = 1e-5  # (c) float64 parameters against one process, relative to the largest
# the slab Ewald sum (phase 37): the NaCl monolayer (square, 2 x 2 ions, nearest neighbours
# 1 bohr apart), its Madelung constant per ion pair, and random walkers near its plane
NACL_MADELUNG = 1.6155426267
EWALD2D_NCONF, EWALD2D_NELEC = 2048, 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores, data sheet


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def leaves(state):
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in leaves(s)]


def cast_tree(tree, dtype):
    """The tree's tensors in `dtype`'s precision, complex ones complex."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if tree.is_complex():
        return tree.to(torch.complex128 if dtype == torch.float64 else torch.complex64)
    return tree.to(dtype)


def randomize_jastrow(params, seed):
    """Nonzero e-ion and perturbed e-e coefficients, so the kernels' Jastrow
    paths are all exercised (the defaults have acoeff = 0)."""
    rng = np.random.default_rng(seed)
    p = {k: dict(v) for k, v in params.items()}
    j = p["wf1"]
    j["acoeff"] = torch.as_tensor(rng.normal(scale=0.1, size=tuple(j["acoeff"].shape)),
                                  dtype=j["acoeff"].dtype, device=j["acoeff"].device)
    j["bcoeff"] = j["bcoeff"] + torch.as_tensor(
        rng.normal(scale=0.05, size=tuple(j["bcoeff"].shape)), dtype=j["bcoeff"].dtype,
        device=j["bcoeff"].device)
    return p


# --- the kernels' bounds --------------------------------------------------------

def kernel_bounds(wf, ecp_acc, nconf, accepted, itemsize=4):
    """{kernel: (bytes, operations)} of one launch at `nconf` walkers.

    Bytes: every input read once and every output written once (state
    columns, random streams, tables, per-walker results); scratch that a
    kernel writes and reads back itself is not counted. Operations: the
    floating-point operations of the arithmetic in csrc/ (an add, multiply,
    divide, compare-and-select, sqrt, exp or log counts one; a
    multiply-add two), for the primitives, channels and bases this system
    has. The work that depends on the data is counted from this run:
    `accepted` {kernel: accepted moves in the compared launch}; a rejected
    move skips the Sherman-Morrison and cache update, a walker that stays
    skips the T-move's last AO pass.
    """
    slater, jastrow = wf.wfs
    nup, ndn = slater.nup, slater.ndn
    nelec, n = nup + ndn, max(nup, ndn)
    spec = slater.orbitals.spec

    def ao_ops(grad, sink_per_row):
        total = 0
        for g in spec.groups:
            l = g.l
            comps = [(i, j, l - i - j) for i in range(l, -1, -1) for j in range(l - i, -1, -1)]
            nc, ns = len(comps), 2 * l + 1
            nonzero = sum(1 for c in comps for x in c if x > 0)
            for coef in g.coef:
                prims = int(np.count_nonzero(coef))
                ops = 8 + prims * (6 if grad else 4) + 3 * l + 3 * nc + 2 * nc * ns
                if grad:
                    ops += 5 * nc + 5 * nonzero + 6 * nc * ns
                total += ops + ns * sink_per_row
        return total

    basis_ops = {("polypade", False): 12, ("polypade", True): 22,
                 ("cutoffcusp", False): 15, ("cutoffcusp", True): 20}

    def jastrow_ops(grad):
        per_term = 2 + (7 if grad else 0)
        a = sum(basis_ops[(b.kind, grad)] + per_term for b in jastrow.a_basis)
        b = sum(basis_ops[(b.kind, grad)] + per_term for b in jastrow.b_basis)
        return jastrow.natom * (9 + a) + (nelec - 1) * (9 + b)

    legendre_ops = {0: 0, 1: 0, 2: 3, 3: 5, 4: 7, 5: 10, 6: 12}

    def quad_ops(per_point):
        """One electron's quadrature: per atom the radial channels, per
        point the rotation, position, cos(theta), projectors and `per_point`."""
        total = 0
        for a, naip in zip(ecp_acc.nl_atoms, ecp_acc.atom_naip):
            chans = a.nonlocal_channels
            total += 9 + sum(2 + sum(6 + abs(p - 2) for p in ch.powers) for ch in chans)
            total += naip * (15 + 6 + 6 + 1 + sum(legendre_ops[ch.l] + 2 for ch in chans)
                             + per_point)
        return total

    update_ops = 2 * n * n + n * (3 * (n - 1) + 1) + 4 + 1  # Sherman-Morrison, phase, U
    nq = ecp_acc.nq_total
    nao = spec.nao
    rows = 3 * nelec + nup * nup + ndn * ndn + 4 + 4 * nup * nup + 4 * ndn * ndn + 1
    tab_bytes = wf_tables_bytes(wf, ecp_acc, itemsize)
    out = {}
    for name, dmc in (("vmc_sweep", False), ("dmc_sweep", True)):
        move = (8 * n + 3 + 2 * (jastrow_ops(True) + 3) + 2 * (14 if dmc else 10) + 6
                + ao_ops(True, 8 * n) + 8 * n + 3 + 3 + 3 + 5 + 9 + 5 + 4 + 2 + 1
                + (13 if dmc else 0))
        ops = nconf * nelec * move + accepted[name] * update_ops
        rows_io = 2 * rows + 3 * nelec + nelec + (3 if dmc else 1)
        out[name] = (rows_io * nconf * itemsize + tab_bytes, ops)
    point = ao_ops(False, 2) + jastrow_ops(False) + 3 + 2
    per_electron = 2 * nao * n + jastrow_ops(False) + quad_ops(point) + 1
    out["ecp_energy"] = ((3 * nelec + nup * nup + ndn * ndn + 9 * nelec + 1) * nconf * itemsize
                         + wf_tables_bytes(wf, ecp_acc, itemsize), nconf * nelec * per_electron)
    point = ao_ops(False, 2 * n) + 2 * n + jastrow_ops(False) + 3 + 1 + 3
    per_electron = jastrow_ops(False) + quad_ops(point) + 1 + 1 + 5 * nq
    moved = (5 * nq + 3 + 9 + 21 + jastrow_ops(False) + ao_ops(True, 8 * n) + update_ops + 2)
    out["tmove_sweep"] = ((2 * rows + 9 * nelec + 2 * nelec) * nconf * itemsize + tab_bytes,
                          nconf * nelec * per_electron + accepted["tmove_sweep"] * moved)
    return out


def wf_tables_bytes(wf, ecp_acc, itemsize):
    from pyqmc_tpu_torch.ops.move_sweep import SJTables

    t = SJTables(*wf.wfs, ecp_acc=ecp_acc)
    return t.ntab * itemsize + 4 * len(t._meta)


def bound_ms(nbytes, ops):
    """(the least milliseconds the card could take, what bounds it)."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --- phase 2: kernels against their plain versions ------------------------------

def path_conds(wf, params, pos, pos_new, stride=1):
    """Per walker and spin, the largest condition number of the orbital
    matrices along a sweep from pos to pos_new (after move k the first k
    electrons sit at their new positions; every `stride`-th k and the
    last), from float64 orbital values (the value rows of the state's
    orbital cache); and the exact (float64) state at pos_new."""
    p64 = cast_tree(params, torch.float64)
    slater = wf.wfs[0]
    nup = slater.nup
    conds = {"up": [], "dn": []}
    nelec = pos.shape[1]
    for k in sorted(set(range(0, nelec + 1, stride)) | {nelec}):
        x = torch.cat([pos_new[:, :k], pos[:, k:]], dim=1).double()
        mo_up, mo_dn = slater.orbitals.eval(p64["wf0"], x, 0)
        conds["up"].append(torch.linalg.cond(mo_up[:, :nup]))
        conds["dn"].append(torch.linalg.cond(mo_dn[:, nup:]))
    sl_mid = wf.recompute(p64, pos_new.double())[0]
    return {k: torch.amax(torch.stack(v), dim=0).reshape(-1) for k, v in conds.items()}, sl_mid


def compare_sweeps(label, dtype, wf, params, pos, out_k, out_p, extras=(), exact=None):
    """One sweep's kernel output against its plain version's: (positions,
    state) pairs, plus `extras`, per-walker tensors as (name, kernel,
    plain). Returns the measured numbers; raises on disagreement.

    exact: the plain version's float64 output from the same inputs as
    (positions, state, [each extra]), or None. Given it, the float32
    leaves other than the inverses are held to
    it instead of to 1e-4 of the plain float32 version: over the walkers
    whose decisions agree in all three runs, each leaf's largest error
    (over 1 + |exact|) of the kernel must be at most 3 times the plain
    version's plus 1e-5; the walkers where the kernel's own error exceeds
    that bound are counted. The inverses are held to 1e-4 x max(1,
    cond/100) either way."""
    (pk, sk), (pp, sp) = out_k, out_p
    moved_k = torch.any(pk != pos, dim=-1)
    moved_p = torch.any(pp != pos, dim=-1)
    differ = torch.any(moved_k != moved_p, dim=1)  # (nconf,)
    ndiff = int(torch.sum(differ))
    res = {"accepted_moves": int(torch.sum(moved_k)),
           "walkers_moved": int(torch.sum(torch.any(moved_k, dim=1))),
           "walkers_with_flipped_accepts": ndiff}
    if dtype == torch.float64:
        check(ndiff == 0, f"f64 {label}: {ndiff} walkers with differing accepts")
        worst = 0.0
        for a, b in zip([pk] + leaves(sk) + [e[1] for e in extras],
                        [pp] + leaves(sp) + [e[2] for e in extras]):
            err = torch.abs(a - b)
            worst = max(worst, float(torch.max(err)))
            # 1e-9 absolute, and relative for inverse entries near a node
            check(bool(torch.all(err <= 1e-9 * (1 + torch.abs(b)))),
                  f"f64 {label}: state differs, max abs err {float(torch.max(err)):.3e}")
        res["max_abs_err"] = worst
        return res
    check(ndiff <= 0.01 * pos.shape[0], f"f32 {label}: {ndiff} walkers with differing accepts")
    agree = ~differ
    # The inverses are updated move by move (Sherman-Morrison), so their
    # float32 error follows the largest condition number of the orbital
    # matrices along the sweep. Those matrices, and the exact final
    # inverses, come from float64 recomputes.
    conds, sl_mid = path_conds(wf, params, pos, pp)
    cond_w = torch.maximum(conds["up"], conds["dn"])
    sl_k, j_k = sk
    sl_p, j_p = sp
    names = ["positions", "phase_up", "phase_dn", "logdet_up", "logdet_dn", "u", "mog_up",
             "mog_dn"] + [e[0] for e in extras]
    pairs = [(pk, pp), (sl_k.phase_up, sl_p.phase_up), (sl_k.phase_dn, sl_p.phase_dn),
             (sl_k.logdet_up, sl_p.logdet_up), (sl_k.logdet_dn, sl_p.logdet_dn), (j_k.u, j_p.u),
             (sl_k.mog_up, sl_p.mog_up), (sl_k.mog_dn, sl_p.mog_dn)]
    pairs += [(e[1], e[2]) for e in extras]
    if exact is not None:
        px, sx, extras_x = exact
        sl_x, j_x = sx
        xs = [px, sl_x.phase_up, sl_x.phase_dn, sl_x.logdet_up, sl_x.logdet_dn, j_x.u,
              sl_x.mog_up, sl_x.mog_dn] + list(extras_x)
        agree3 = agree & ~torch.any(torch.any(px != pos.double(), dim=-1) != moved_k, dim=1)
        res["walkers_agreeing_with_float64"] = int(torch.sum(agree3))
    nconf = pos.shape[0]
    worst = 0.0
    for i, (name, (a, b)) in enumerate(zip(names, pairs)):
        err = (torch.abs(a - b).reshape(nconf, -1).double()
               / (1 + torch.abs(b).reshape(nconf, -1).double())).amax(dim=1)
        err = torch.where(agree, err, torch.zeros_like(err))
        worst = max(worst, float(torch.max(torch.abs(a - b)[agree])))
        if exact is None:
            check(bool(torch.all(err <= 1e-4)),
                  f"f32 {label}: agreeing walkers' {name} differ by {float(torch.max(err)):.3e}")
            continue

        def vs_exact(v):
            x = xs[i].double().reshape(nconf, -1)
            e = (torch.abs(v.double().reshape(nconf, -1) - x) / (1 + torch.abs(x))).amax(dim=1)
            return torch.where(agree3, e, torch.zeros_like(e))

        ek, ep = vs_exact(a), vs_exact(b)
        w = int(torch.argmax(err))
        res[name] = {"max_err_over_1_plus_abs": float(err[w]), "path_cond_there": float(cond_w[w]),
                     "kernel_max_err_vs_float64": float(torch.max(ek)),
                     "plain_max_err_vs_float64": float(torch.max(ep)),
                     "walkers_kernel_err_above_3_plain_plus_1e-5": int(torch.sum(
                         ek > 3 * ep + 1e-5))}
        check(res[name]["kernel_max_err_vs_float64"]
              <= 3 * res[name]["plain_max_err_vs_float64"] + 1e-5,
              f"f32 {label}: agreeing walkers' {name} farther from float64 than 3 x the plain "
              f"version's error + 1e-5: {json.dumps(res[name])}")
    res["max_abs_err"] = worst
    for spin, inv_k, inv_p, inv_x in [("up", sl_k.inv_up, sl_p.inv_up, sl_mid.inv_up),
                                      ("dn", sl_k.inv_dn, sl_p.inv_dn, sl_mid.inv_dn)]:
        cond = conds[spin]

        def nrel(a, b):
            return (torch.linalg.norm((a.double() - b.double()).flatten(1), dim=1)
                    / torch.linalg.norm(b.double().flatten(1), dim=1))

        rel = nrel(inv_k, inv_p)
        entry = torch.amax(torch.abs(inv_k - inv_p) / (1 + torch.abs(inv_p)), dim=(1, 2, 3))
        w = int(torch.argmax(torch.where(agree, entry, torch.zeros_like(entry))))
        res[f"inverse_{spin}"] = {
            "max_entry_err_over_1_plus_abs": float(entry[w]), "at_walker": w,
            "path_cond_there": float(cond[w]), "norm_rel_err_there": float(rel[w]),
            "kernel_err_vs_exact_there": float(nrel(inv_k, inv_x)[w]),
            "plain_err_vs_exact_there": float(nrel(inv_p, inv_x)[w]),
            "max_norm_rel_err_path_cond_le_100": (
                float(torch.max(rel[agree & (cond <= 100)]))
                if bool(torch.any(agree & (cond <= 100))) else None),
            "max_norm_rel_err_over_path_cond": float(torch.max((rel / cond)[agree])),
            "walkers_path_cond_gt_100": int(torch.sum(cond > 100)),
            "median_path_cond": float(torch.median(cond))}
        bound = 1e-4 * torch.clamp(cond / 100, min=1.0)
        bad = agree & ~(rel <= bound)
        check(not bool(torch.any(bad)),
              f"f32 {label}: {int(torch.sum(bad))} agreeing walkers' {spin} inverses differ "
              f"beyond 1e-4 * max(1, cond/100): {json.dumps(res[f'inverse_{spin}'])}")
    return res


def compare_kernels(dtype):
    """Phase 2 for one dtype: all four kernels. Returns the measured numbers."""
    from pyqmc_tpu_torch.configs import Geometry
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams
    from pyqmc_tpu_torch.method.vmc import draw_streams
    from pyqmc_tpu_torch.observables.energy import kinetic_energy
    from pyqmc_tpu_torch.ops.ecp_energy import build_fused_ecp_energy
    from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep
    from pyqmc_tpu_torch.ops.tmove_sweep import build_fused_tmove_sweep

    mol, wf, params, configs, acc = h2o_setup(NCONF, device="cuda", dtype=dtype, seed=11)
    params = randomize_jastrow(params, 12)
    pos, wrap = configs.positions, configs.wrap
    nelec = pos.shape[1]
    state = wf.recompute(params, pos)
    gen = torch.Generator(device="cuda").manual_seed(13)
    streams = draw_streams(gen, 1, nelec, NCONF, TSTEP, pos.device, dtype)
    gauss, unif, rot = streams["gauss"][0], streams["unif"][0], streams["rot"][0]
    dstreams = draw_dmc_streams(gen, 1, nelec, NCONF, DMC_TSTEP, pos.device, dtype)
    dgauss, dunif = dstreams["gauss"][0], dstreams["unif"][0]
    tqrot, u_sel, u_acc = dstreams["tqrot"][0], dstreams["u_sel"][0], dstreams["u_acc"][0]
    ecp_acc = acc["energy"].ecp_acc
    sweep = build_fused_sweep(wf, Geometry(), TSTEP)
    dsweep = build_fused_sweep(wf, Geometry(), DMC_TSTEP, mode="dmc")
    tmove = build_fused_tmove_sweep(wf, Geometry(), ecp_acc, DMC_TSTEP)
    tmove_big = build_fused_tmove_sweep(wf, Geometry(), ecp_acc, TMOVE_BIG_TAU)
    ecp = build_fused_ecp_energy(wf, ecp_acc)
    check(None not in (sweep, dsweep, tmove, tmove_big, ecp),
          "main path is outside the kernels' gates")
    res = {}

    # K2, the ECP energy
    ek = ecp.kernel(params, pos, state, rot)
    ep = ecp.plain(params, pos, state, rot)
    torch.cuda.synchronize()
    scale = float(torch.mean(torch.abs(ep)))
    ecp_err = torch.abs(ek - ep)
    res["ecp_energy"] = {"max_abs_err": float(torch.max(ecp_err))}
    # rtol with an absolute floor at the mean magnitude for walkers whose
    # channels cancel to ~0
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    check(bool(torch.all(ecp_err <= tol * (torch.abs(ep) + scale))),
          f"{dtype} ECP energy differs: max abs err {res['ecp_energy']['max_abs_err']:.3e}")

    # K1, the vmc sweep
    pk, _, sk, acck = sweep.kernel(params, pos, wrap, state, gauss, unif)
    pp, _, sp, accp = sweep.plain(params, pos, wrap, state, gauss, unif)
    res["vmc_sweep"] = compare_sweeps("vmc sweep", dtype, wf, params, pos, (pk, sk), (pp, sp))
    res["vmc_sweep"]["acceptance"] = float(acck) / nelec
    if dtype == torch.float64:
        check(float(acck) == float(accp), f"f64 vmc acceptance {float(acck)} != {float(accp)}")

    # K4, the dmc sweep
    pk, _, sk, (acck, r2pk, r2ak) = dsweep.kernel(params, pos, wrap, state, dgauss, dunif)
    pp, _, sp, (accp, r2pp, r2ap) = dsweep.plain(params, pos, wrap, state, dgauss, dunif)
    res["dmc_sweep"] = compare_sweeps("dmc sweep", dtype, wf, params, pos, (pk, sk), (pp, sp),
                                      extras=[("r2p", r2pk, r2pp), ("r2a", r2ak, r2ap)])
    res["dmc_sweep"]["acceptance"] = float(acck) / nelec
    res["dmc_sweep"]["mean_tdamp"] = float(torch.mean(r2ak / r2pk))
    if dtype == torch.float64:
        check(float(acck) == float(accp), f"f64 dmc acceptance {float(acck)} != {float(accp)}")

    # K5, the T-move sweep, at the main path's tau and at a large one
    for name, fn in (("tmove_sweep", tmove), ("tmove_sweep_big_tau", tmove_big)):
        pk, _, sk = fn.kernel(params, pos, wrap, state, tqrot, u_sel, u_acc)
        pp, _, sp = fn.plain(params, pos, wrap, state, tqrot, u_sel, u_acc)
        res[name] = compare_sweeps(f"T-move sweep tau={fn.tau}", dtype, wf, params, pos,
                                   (pk, sk), (pp, sp))
        res[name]["tau"] = fn.tau
        res[name]["share_of_walkers_taking_a_tmove"] = res[name]["walkers_moved"] / NCONF
    check(res["tmove_sweep_big_tau"]["walkers_moved"] >= 0.02 * NCONF,
          f"only {res['tmove_sweep_big_tau']['walkers_moved']} walkers took a T-move at "
          f"tau {TMOVE_BIG_TAU}: the comparison would show nothing")
    if dtype == torch.float64:
        return res

    # times at the main path's shapes, float32
    calls = {
        "vmc_sweep": (sweep, (params, pos, wrap, state, gauss, unif)),
        "ecp_energy": (ecp, (params, pos, state, rot)),
        "dmc_sweep": (dsweep, (params, pos, wrap, state, dgauss, dunif)),
        "tmove_sweep": (tmove, (params, pos, wrap, state, tqrot, u_sel, u_acc)),
    }
    for name, (fn, args) in calls.items():
        res[name]["ms"] = cuda_ms(lambda: fn.kernel(*args), 20)
        res[name]["plain_ms"] = cuda_ms(lambda: fn.plain(*args), 5)
    accepted = {k: res[k]["accepted_moves"] for k in ("vmc_sweep", "dmc_sweep", "tmove_sweep")}
    for name, (nbytes, ops) in kernel_bounds(wf, ecp_acc, NCONF, accepted).items():
        ms, by = bound_ms(nbytes, ops)
        res[name].update({"bytes": nbytes, "operations": ops, "bound_ms": ms, "bound_by": by})
    res["redesigned"] = redesigned_times(wf, Geometry(), res, calls)
    # the rest of a step, plain PyTorch on the main path
    res["kinetic_ms"] = cuda_ms(lambda: kinetic_energy(wf, params, state, pos), 5)
    res["coulomb_ms"] = cuda_ms(lambda: acc["energy"].coulomb.energy(pos), 5)
    return res


class StateProbe:
    """An accumulator that keeps a copy of the state leaves after every
    step (make_vmc_block calls .avg, make_dmc_block the object itself); it
    adds no averages."""

    def __init__(self):
        self.steps = []

    def avg(self, wf, params, state, positions, rot=None, u_sel=None):
        self.steps.append([t.clone() for t in leaves(state)])
        return {}

    __call__ = avg


def compare_blocks():
    """Phase 2's float64 blocks: a 10-step VMC block (K1, K2), then from its
    walkers a 10-step DMC block with T-moves (K4, K5, K2), each with the
    kernels and with the plain versions (fused=False and a plain ECP
    energy) on the same streams, BLOCK_CHECK_NCONF walkers. Returns the
    measured numbers; raises on disagreement."""
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams, make_dmc_block
    from pyqmc_tpu_torch.method.vmc import draw_streams, make_vmc_block
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.observables.ecp import ECPAccumulator
    from pyqmc_tpu_torch.ops import ecp_energy, move_sweep, tmove_sweep

    dtype, nconf, nsteps = torch.float64, BLOCK_CHECK_NCONF, 10
    mol, wf, params, configs, acc = h2o_setup(nconf, device="cuda", dtype=dtype, seed=11)
    params = randomize_jastrow(params, 12)
    nelec = configs.positions.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(19)
    energy = {True: acc["energy"],
              False: EnergyAccumulator(mol, ecp_acc=ECPAccumulator(mol, fused=False))}
    counters = {"vmc_sweep": move_sweep.LAUNCHES, "dmc_sweep": move_sweep.DMC_LAUNCHES,
                "tmove_sweep": tmove_sweep.LAUNCHES, "ecp_energy": ecp_energy.LAUNCHES}

    def both(label, run, launches):
        """run(fused, probe) -> (positions, wrap, [weights,] averages), with
        the kernels and plain; every output held to the other's."""
        out = {}
        for fused in (True, False):
            before = {k: c.n for k, c in counters.items()}
            probe = StateProbe()
            out[fused] = (run(fused, probe), probe.steps)
            n = {k: c.n - before[k] for k, c in counters.items()}
            want = launches if fused else {k: 0 for k in counters}
            check(n == {**{k: 0 for k in counters}, **want},
                  f"f64 {label} block ({'kernels' if fused else 'plain'}) launched {n}")
        (ko, ksteps), (po, psteps) = out[True], out[False]
        *kt, kavg = ko
        *pt, pavg = po
        check(torch.equal(kt[1], pt[1]), f"f64 {label} block: wrap counts differ")
        pairs = [(kt[0], pt[0])] + ([(kt[2], pt[2])] if len(kt) > 2 else [])
        pairs += [(a, b) for ka, pa in zip(ksteps, psteps) for a, b in zip(ka, pa)]
        pairs += [(kavg[k], pavg[k]) for k in sorted(kavg) if k != "acceptance"]
        worst = 0.0
        for a, b in pairs:
            err = torch.abs(a - b)
            worst = max(worst, float(torch.max(err)))
            check(bool(torch.all(err <= 1e-9 * (1 + torch.abs(b)))),
                  f"f64 {label} block: kernels and plain differ by {float(torch.max(err)):.3e}")
        check(float(kavg["acceptance"]) == float(pavg["acceptance"]),
              f"f64 {label} block acceptance {float(kavg['acceptance'])} != "
              f"{float(pavg['acceptance'])}")
        return ko, {"max_abs_err": worst, "steps": len(ksteps),
                    "acceptance": float(kavg["acceptance"]),
                    "energytotal": float(kavg["energytotal"])}

    res = {"walkers": nconf}
    vst = draw_streams(gen, nsteps, nelec, nconf, TSTEP, "cuda", dtype)

    def vmc_run(fused, probe):
        block = make_vmc_block(wf, {"energy": energy[fused], "probe": probe}, configs.geometry,
                               TSTEP, nsteps, fused=fused)
        return block(params, configs.positions, configs.wrap, gen, streams=vst)

    (pos, wrap, vavg), res["vmc_block"] = both(
        "VMC", vmc_run, {"vmc_sweep": nsteps, "ecp_energy": nsteps})
    dst = draw_dmc_streams(gen, nsteps, nelec, nconf, DMC_TSTEP, "cuda", dtype)
    e_trial = float(vavg["energytotal"])
    weights = torch.ones(nconf, dtype=dtype, device="cuda")

    def dmc_run(fused, probe):
        block, _ = make_dmc_block(wf, energy[fused], configs.geometry, DMC_TSTEP, nsteps,
                                  accumulators={"probe": probe}, fused=fused)
        return block(params, pos, wrap, weights, gen, e_trial, e_trial, 0.5, streams=dst)

    (dpos, _, _, _), res["dmc_block"] = both(
        "DMC", dmc_run, {"dmc_sweep": nsteps, "tmove_sweep": nsteps, "ecp_energy": nsteps + 1})
    res["dmc_block"]["walkers_moved_by_tmoves_or_drift"] = int(torch.sum(torch.any(
        (dpos != pos).reshape(nconf, -1), dim=1)))
    return res


# --- phase 8: the periodic kernels against their plain versions ------------------

def ao_shell_ops(spec, mode):
    """Floating-point operations of one point's AO evaluation in
    csrc/ao_shell.cuh:shell_one (mode 0 values, 1 with gradients, 2 with
    laplacians), counted as in kernel_bounds."""
    total = 0
    for g in spec.groups:
        l = g.l
        comps = [(i, j, l - i - j) for i in range(l, -1, -1) for j in range(l - i, -1, -1)]
        nc, ns = len(comps), 2 * l + 1
        nonzero = sum(1 for c in comps for x in c if x > 0)
        for coef in g.coef:
            prims = int(np.count_nonzero(coef))
            ops = 8 + prims * (4 + 2 * mode) + 3 * l + 3 * nc + 2 * nc * ns
            if mode >= 1:
                ops += 5 * nc + 5 * nonzero + 6 * nc * ns
            if mode >= 2:
                ops += 8 * nc + 6 * nonzero + 2 * nc * ns
            total += ops
    return total


def kernel_bounds_pbc(wf, geometry, nconf, accepted, m_value_mo, m_gto_eval, itemsize=4):
    """{kernel: (bytes, operations)} of one launch of K7 (both modes), K3
    and K6 at the diamond shapes: every input read once, every output
    written once; K7's Sherman-Morrison counted for this run's accepted
    moves, `accepted` {"pbc_sweep": n, "pbc_dmc_sweep": n}. The dmc mode
    adds per move Umrigar's drift limit in place of the cap (twice), the
    node test, and the squared displacement with its two sums; per walker
    it writes r2p and r2a."""
    from pyqmc_tpu_torch.ops.gto_kernels import GTOTables
    from pyqmc_tpu_torch.ops.move_sweep_pbc import PBCTables

    slater, jastrow = wf.wfs
    orb = slater.orbitals
    spec = orb._repl_spec
    nup, ndn = slater.nup, slater.ndn
    nelec, n, nao, ntot = nup + ndn, max(nup, ndn), spec.nao, nup + ndn
    g = GTOTables(spec)
    gtab = g._tab.size * itemsize + 4 * g._meta.size
    t = PBCTables(geometry, slater, jastrow, orb)
    ptab = t.ntab * itemsize + 4 * t._meta.size
    out = {}
    out["value_mo"] = ((3 + ntot) * m_value_mo * itemsize + nao * ntot * itemsize + gtab,
                       m_value_mo * (ao_shell_ops(spec, 0) + 2 * nao * ntot))
    out["gto_eval"] = ((3 + 5 * nao) * m_gto_eval * itemsize + gtab,
                       m_gto_eval * ao_shell_ops(spec, 2))
    basis_ops = {"polypade": 22, "cutoffcusp": 20}
    jas = (jastrow.natom * (9 + 9 + sum(basis_ops[b.kind] + 9 for b in jastrow.a_basis))
           + (nelec - 1) * (9 + 9 + sum(basis_ops[b.kind] + 9 for b in jastrow.b_basis)))
    move = (8 * n + 2 * jas + 2 * 10 + 27 * 4 + 9 + n * (5 + ao_shell_ops(spec, 1) / n
                                                         + 8 * nao) + 8 * n + 30)
    update = 2 * n * n + 3 * n * n + 4 * n + 6
    rows = 3 * nelec + nup * nup + ndn * ndn + 4 + 4 * nup * nup + 4 * ndn * ndn + 1
    for name, dmc in (("pbc_sweep", False), ("pbc_dmc_sweep", True)):
        # Umrigar's limit (15 per call, the cap 10), the node test, r2
        # (|gauss + tau drift_old|^2: 11) and its two sums
        extra = 2 * (15 - 10) + 1 + 11 + 2 if dmc else 0
        out[name] = ((2 * rows + 3 * nelec + nelec + 3 * nelec + (3 if dmc else 1)) * nconf
                     * itemsize + nao * ntot * itemsize + ptab,
                     int(nconf * nelec * (move + extra) + accepted[name] * update))
    return out


def all_plain(fn):
    """fn with the orbitals evaluated without K3 and K6: a plain version
    throughout."""
    from pyqmc_tpu_torch.models.orbitals import plain_orbitals

    def run(*args):
        with plain_orbitals():
            return fn(*args)

    return run


def per_walker_ecp(phase, wf, params, state, pos, rot, ecp, u_sel=None, tol=1e-4):
    """The per-walker ECP energies (before the mean) with K3 against plain
    orbitals on one set of rotations, to tol of each walker's energy plus the
    largest one's magnitude: a block's mean energy cannot see K3's float32
    rounding (its relative differences print 0.0), these can. Returns the
    largest absolute and relative differences."""
    from pyqmc_tpu_torch.models.orbitals import plain_orbitals

    with plain_orbitals():
        e_p = ecp(wf, params, state, pos, rot, u_sel)
    e_k = ecp(wf, params, state, pos, rot, u_sel)
    err = close_rel(f"{phase} per-walker ECP energy, K3 against plain", e_k, e_p, tol)
    rel = float(torch.max(torch.abs(e_k - e_p) / torch.abs(e_p)))
    print(f"{phase}: per-walker ECP energies, K3 against plain orbitals on one set of rotations: "
          f"max abs difference {err:.3e} Ha, max relative {rel:.3e}, over {e_p.shape[0]} walkers "
          f"(largest |E_ecp| {float(torch.max(torch.abs(e_p))):.4f} Ha)", flush=True)
    return err, rel


def close_rel(label, k, p, tol):
    """|k - p| <= tol (|p| + max |p|) entrywise; returns the max abs error."""
    err = torch.abs(k - p)
    scale = float(torch.max(torch.abs(p)))
    check(bool(torch.all(err <= tol * (torch.abs(p) + scale))),
          f"{label}: max abs err {float(torch.max(err)):.3e} (max |plain| {scale:.3e})")
    return float(torch.max(err))


def compare_pbc_kernels(dtype):
    """Phase 8 for one dtype: K7, K6 and K3 at the diamond shapes, K3 at
    H2O's. Returns the measured numbers."""
    from pyqmc_tpu_torch.entry import diamond_setup, h2o_setup
    from pyqmc_tpu_torch.method.vmc import draw_streams
    from pyqmc_tpu_torch.observables.ecp import systematic_downselect
    from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep

    sup, wf, params, configs, acc = diamond_setup(DIAMOND_NCONF, device="cuda", dtype=dtype,
                                                  seed=21)
    params = randomize_jastrow(params, 22)
    pos, wrap = configs.positions, configs.wrap
    nelec = pos.shape[1]
    orb = wf.wfs[0].orbitals
    state = wf.recompute(params, pos)
    gen = torch.Generator(device="cuda").manual_seed(23)
    streams = draw_streams(gen, 1, nelec, DIAMOND_NCONF, TSTEP, pos.device, dtype,
                           downselect=True)
    gauss, unif = streams["gauss"][0], streams["unif"][0]
    sweep = build_fused_sweep(wf, configs.geometry, TSTEP)
    check(type(sweep).__name__ == "FusedSweepPBC", "the diamond wavefunction is outside K7's gate")
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    res = {}

    # K7, the periodic sweep
    sweep_plain = all_plain(sweep.plain)
    pk, wk, sk, acck = sweep.kernel(params, pos, wrap, state, gauss, unif)
    pp, wp, sp, accp = sweep_plain(params, pos, wrap, state, gauss, unif)
    exact = None
    if dtype == torch.float32:  # the plain version in float64 from the same inputs
        p64 = cast_tree(params, torch.float64)
        px, wx, sx, _ = sweep_plain(p64, pos.double(), wrap, wf.recompute(p64, pos.double()),
                                    gauss.double(), unif.double())
        exact = (px, sx, [wx])
    torch.cuda.synchronize()
    res["pbc_sweep"] = compare_sweeps("periodic sweep", dtype, wf, params, pos, (pk, sk), (pp, sp),
                                      extras=[("wrap", wk.to(dtype), wp.to(dtype))], exact=exact)
    res["pbc_sweep"]["acceptance"] = float(acck) / nelec
    res["pbc_sweep"]["walkers_with_a_wrap"] = int(torch.sum(torch.any(
        (wk != wrap).reshape(DIAMOND_NCONF, -1), dim=1)))
    if dtype == torch.float64:  # the same count of accepted moves (means summed in two orders)
        check(abs(float(acck) - float(accp)) * DIAMOND_NCONF < 0.5,
              f"f64 periodic acceptance {float(acck)} != {float(accp)}")

    # K7's dmc mode, at DMC's tstep and at a large one where moves wrap and
    # cross nodes often; there the first half of the walkers gets unif = 0,
    # so that every move of theirs that is rejected is rejected by the node
    for name, tau in (("pbc_dmc_sweep", DMC_TSTEP), ("pbc_dmc_sweep_big_tstep", PBC_DMC_BIG_TSTEP)):
        dsweep = build_fused_sweep(wf, configs.geometry, tau, mode="dmc")
        dst = draw_streams(gen, 1, nelec, DIAMOND_NCONF, tau, pos.device, dtype)
        dgauss, dunif = dst["gauss"][0], dst["unif"][0].clone()
        half = DIAMOND_NCONF // 2
        if tau != DMC_TSTEP:
            dunif[:, :half] = 0.0
        dplain = all_plain(dsweep.plain)
        pk, wk, sk, (acck, r2pk, r2ak) = dsweep.kernel(params, pos, wrap, state, dgauss, dunif)
        pp, wp, sp, (accp, r2pp, r2ap) = dplain(params, pos, wrap, state, dgauss, dunif)
        exact = None
        if dtype == torch.float32:
            p64 = cast_tree(params, torch.float64)
            px, wx, sx, (_, r2px, r2ax) = dplain(p64, pos.double(), wrap,
                                                 wf.recompute(p64, pos.double()),
                                                 dgauss.double(), dunif.double())
            exact = (px, sx, [wx, r2px, r2ax])
        torch.cuda.synchronize()
        res[name] = compare_sweeps(
            f"periodic dmc sweep tstep={tau}", dtype, wf, params, pos, (pk, sk), (pp, sp),
            extras=[("wrap", wk.to(dtype), wp.to(dtype)), ("r2p", r2pk, r2pp),
                    ("r2a", r2ak, r2ap)], exact=exact)
        moved = torch.any(pk != pos, dim=-1)
        res[name].update({
            "tstep": tau, "acceptance": float(acck) / nelec,
            "moves_wrapped": int(torch.sum(torch.any(wk != wrap, dim=-1))),
            "mean_tdamp": float(torch.mean(r2ak / r2pk))})
        if tau != DMC_TSTEP:
            res[name]["node_rejections_of_the_walkers_with_unif_0"] = int(
                torch.sum(~moved[:half]))
            check(res[name]["node_rejections_of_the_walkers_with_unif_0"] > 0
                  and res[name]["moves_wrapped"] > 0,
                  f"tstep {tau}: no node rejection or no wrap to compare: {json.dumps(res[name])}")
        if dtype == torch.float64:
            check(abs(float(acck) - float(accp)) * DIAMOND_NCONF < 0.5,
                  f"f64 periodic dmc acceptance {float(acck)} != {float(accp)}")
        if name == "pbc_dmc_sweep":
            dmc_call = (dsweep, dplain, (params, pos, wrap, state, dgauss, dunif))

    # K6 at one kinetic-energy chunk: 32 electrons x 500 walkers
    chunk = max(1, 16384 // DIAMOND_NCONF)
    X6, _ = orb._fold(pos[:, :chunk].reshape(-1, 3))
    ev2 = orb._eval2
    out_k, out_p = ev2.kernel(X6), ev2.plain(X6)
    res["gto_eval"] = {"points": X6.shape[0], "max_abs_err": max(
        close_rel(f"{dtype} K6 {name}", a, b, tol)
        for name, a, b in zip(("ao", "grad", "lap"), out_k, out_p))}

    # K3 at one ECP chunk: 21 electrons x 500 walkers x 24 selected points
    ecp = acc["energy"].ecp_acc
    k3 = 262144 // (DIAMOND_NCONF * ecp.nselect)
    aux, T = ecp.quadrature_geometry(pos[:, :k3].transpose(0, 1), streams["rot"][0][:k3])
    idx, _ = systematic_downselect(T, ecp.nselect, streams["u_sel"][0][:k3])
    aux = torch.gather(aux, 2, idx[..., None].expand(*idx.shape, 3)).reshape(-1, 3)
    X3, _ = orb._fold(aux)
    R = orb._folded_coeff(params["wf0"], dtype)
    vm = orb._value_mo
    res["value_mo"] = {"points": X3.shape[0], "max_abs_err": close_rel(
        f"{dtype} K3", vm.kernel_t(X3, R), vm.plain_t(X3, R), tol)}

    # K3 at H2O's 23 AOs, on its ECP points of all 8 electrons
    _, hwf, hparams, hconf, hacc = h2o_setup(NCONF, device="cuda", dtype=dtype, seed=11)
    hgen = torch.Generator(device="cuda").manual_seed(13)
    hst = draw_streams(hgen, 1, 8, NCONF, TSTEP, hconf.positions.device, dtype)
    hx, _ = hacc["energy"].ecp_acc.quadrature_geometry(hconf.positions.transpose(0, 1),
                                                       hst["rot"][0])
    hx = hx.reshape(-1, 3)
    hp = hparams["wf0"]
    hC = torch.cat([hp["mo_coeff_alpha"], hp["mo_coeff_beta"]], dim=1)
    hvm = hwf.wfs[0].orbitals._value_mo
    res["value_mo_h2o"] = {"points": hx.shape[0], "max_abs_err": close_rel(
        f"{dtype} K3 H2O", hvm.kernel_t(hx, hC), hvm.plain_t(hx, hC), tol)}
    if dtype == torch.float64:
        return res

    dsweep, dplain, dargs = dmc_call
    calls = {"pbc_sweep": (lambda: sweep.kernel(params, pos, wrap, state, gauss, unif),
                           lambda: sweep_plain(params, pos, wrap, state, gauss, unif), 5, 1),
             "pbc_dmc_sweep": (lambda: dsweep.kernel(*dargs), lambda: dplain(*dargs), 5, 1),
             "gto_eval": (lambda: ev2.kernel(X6), lambda: ev2.plain(X6), 10, 3),
             "value_mo": (lambda: vm.kernel_t(X3, R), lambda: vm.plain_t(X3, R), 10, 3),
             "value_mo_h2o": (lambda: hvm.kernel_t(hx, hC), lambda: hvm.plain_t(hx, hC), 20, 5)}
    for name, (kern, plain, nk, np_) in calls.items():
        res[name]["ms"] = cuda_ms(kern, nk)
        res[name]["plain_ms"] = cuda_ms(plain, np_)
    accepted = {k: res[k]["accepted_moves"] for k in ("pbc_sweep", "pbc_dmc_sweep")}
    bounds = kernel_bounds_pbc(wf, configs.geometry, DIAMOND_NCONF, accepted, X3.shape[0],
                               X6.shape[0])
    for name, (nbytes, ops) in bounds.items():
        ms, by = bound_ms(nbytes, ops)
        res[name].update({"bytes": nbytes, "operations": ops, "bound_ms": ms, "bound_by": by})
    # K3 at the T-move quadrature's size: one electron's 96 points per walker
    aux, _ = ecp.quadrature_geometry(pos[:, 0], streams["rot"][0][0])
    Xq, _ = orb._fold(aux.reshape(-1, 3))
    res["redesigned"] = redesigned_times(wf, configs.geometry, res, {
        "value_mo": (vm, (X3, R)), "value_mo_48000": (vm, (Xq, R)),
        "pbc_sweep": (sweep, (params, pos, wrap, state, gauss, unif)),
        "pbc_dmc_sweep": (dsweep, dargs)})
    # the rest of a periodic step, each piece alone (wrappers and plain ops)
    from pyqmc_tpu_torch.observables.energy import kinetic_energy

    res["kinetic_ms"] = cuda_ms(lambda: kinetic_energy(wf, params, state, pos), 3)
    res["ewald_ms"] = cuda_ms(lambda: acc["energy"].coulomb.energy(pos), 3)
    res["ecp_ms"] = cuda_ms(lambda: ecp(wf, params, state, pos, streams["rot"][0],
                                        streams["u_sel"][0]), 3)
    res["recompute_ms"] = cuda_ms(lambda: wf.recompute(params, pos), 3)
    nbytes = (3 + 8) * hx.shape[0] * 4 + 23 * 8 * 4
    ops = hx.shape[0] * (ao_shell_ops(hwf.wfs[0].orbitals.spec, 0) + 2 * 23 * 8)
    ms, by = bound_ms(nbytes, ops)
    res["value_mo_h2o"].update({"bytes": nbytes, "operations": ops, "bound_ms": ms, "bound_by": by})
    return res


def redesigned_times(wf, geometry, res, calls, reps=50):
    """The kernels redesigned for this card (K3 at 252,000 and 48,000
    points, K7 in both modes; K1, K2, K4, K5), `calls` {name: (wrapper, its
    arguments)}: the device time of one launch (CUDA events over `reps`
    launches of the C entry point, back to back after a warm-up, its
    arguments packed once), the wrapper's time (the same over wrapper
    calls, host packing included), the bound and its share of the device
    time. Returns {name: numbers}."""
    from pyqmc_tpu_torch.ops import _build

    out = {}
    for name, (fn, args) in calls.items():
        if name.startswith("value_mo"):
            _, held, largs = fn.pack(*args)
            entry, wrapper = "pq_value_mo", lambda: fn.kernel_t(*args)
            nbytes, ops = kernel_bounds_pbc(wf, geometry, DIAMOND_NCONF,
                                            {"pbc_sweep": 0, "pbc_dmc_sweep": 0},
                                            args[0].shape[0], 1)["value_mo"]
            bms, by = bound_ms(nbytes, ops)
            out[name] = {"points": args[0].shape[0]}
        else:
            entry, _, held, largs = fn.pack(*args)
            wrapper = lambda: fn.kernel(*args)
            bms, by = res[name]["bound_ms"], res[name]["bound_by"]
            out[name] = {}
        dev = cuda_ms(lambda: _build.launch(entry, torch.float32, *largs), reps)
        out[name].update({"device_ms": dev, "wrapper_ms": cuda_ms(wrapper, reps),
                          "bound_ms": bms, "bound_by": by, "bound_share": bms / dev})
        del held
    return out


# --- phase 13: K3 at the multi-determinant path's shapes -----------------------

def value_mo_bound(spec, m, ncol, itemsize=4):
    """(bytes, operations) of one K3 launch at m points and ncol columns of
    the basis `spec`, counted as kernel_bounds_pbc counts K3: the points,
    the output and C read or written once, the tables; the AO evaluation
    and the contraction."""
    from pyqmc_tpu_torch.ops.gto_kernels import GTOTables

    g = GTOTables(spec)
    nbytes = ((3 + ncol) * m * itemsize + spec.nao * ncol * itemsize + g._tab.size * itemsize
              + 4 * g._meta.size)
    return nbytes, m * (ao_shell_ops(spec, 0) + 2 * spec.nao * ncol)


def casci_k3(dtype, reps=50):
    """K3 on the points the multi-determinant path gives it, 2048 H2O
    walkers of h2o_casci_setup and 16 columns (8 orbitals per spin): the
    energy's ECP quadrature (8 electrons x 6 points per walker) and one
    electron's T-move quadrature (6 points per walker). Both layouts
    against the plain version, to 1e-9 (float64) or 1e-4 (float32) of each
    entry plus the largest entry's magnitude: the transposed (norb, M) one
    the kernel writes and the row one (M, norb) of eval mode 0, which the
    path reads. In float32 also the device time of one launch (CUDA events
    over `reps` launches of the C entry point back to back), the wrappers'
    times the same way, the plain version's and the bound."""
    from pyqmc_tpu_torch.entry import h2o_casci_setup
    from pyqmc_tpu_torch.method.vmc import draw_streams
    from pyqmc_tpu_torch.ops import _build

    _, wf, params, configs, acc = h2o_casci_setup(NCONF, device="cuda", dtype=dtype, seed=11)
    orb = wf.wfs[0].orbitals
    vm = orb._value_mo
    C = torch.cat([params["wf0"]["mo_coeff_alpha"], params["wf0"]["mo_coeff_beta"]], dim=1)
    rot = draw_streams(torch.Generator(device="cuda").manual_seed(13), 1, 8, NCONF, TSTEP,
                       "cuda", dtype)["rot"][0]
    ecp = acc["energy"].ecp_acc
    pos = configs.positions
    points = {"energy": ecp.quadrature_geometry(pos.transpose(0, 1), rot)[0].reshape(-1, 3),
              "tmove": ecp.quadrature_geometry(pos[:, 0], rot[0])[0].reshape(-1, 3)}
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    res = {}
    for name, X in points.items():
        plain = vm.plain_t(X, C)
        res[name] = {"points": X.shape[0], "columns": C.shape[1], "max_abs_err": max(
            close_rel(f"{dtype} K3 {name} (norb, M)", vm.kernel_t(X, C), plain, tol),
            close_rel(f"{dtype} K3 {name} (M, norb)", vm(X, C), plain.T, tol))}
        if dtype == torch.float64:
            continue
        out, held, largs = vm.pack(X, C)
        nbytes, ops = value_mo_bound(orb.spec, X.shape[0], C.shape[1])
        bms, by = bound_ms(nbytes, ops)
        dev = cuda_ms(lambda: _build.launch("pq_value_mo", torch.float32, *largs), reps)
        res[name].update({
            "device_ms": dev, "wrapper_ms": cuda_ms(lambda: vm.kernel_t(X, C), reps),
            "wrapper_rows_ms": cuda_ms(lambda: vm(X, C), reps),
            "plain_ms": cuda_ms(lambda: vm.plain_t(X, C), 5), "bytes": nbytes, "operations": ops,
            "bound_ms": bms, "bound_by": by, "bound_share": bms / dev,
            "device_ns_per_point": dev * 1e6 / X.shape[0]})
        del held
    return res


# --- traces -----------------------------------------------------------------------

def traced(run):
    """Runs run() under torch.profiler (device activity only). Returns
    (device busy us, device events, top 5 {name: ms}, the port's kernels
    {name: [launches, ms per launch]}, wall s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name, ours = {}, {}
    nkern = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            nkern += 1
            us = e.time_range.elapsed_us()
            per_name[e.name] = per_name.get(e.name, 0.0) + us
            if "pq::" in e.name:  # csrc/ kernels live in namespace pq
                name = e.name.split("pq::")[1].split("(")[0]
                n, tot = ours.get(name, (0, 0.0))
                ours[name] = (n + 1, tot + us)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    ours = {k: [n, tot / n / 1e3] for k, (n, tot) in ours.items()}
    return sum(per_name.values()), nkern, {k[:80]: v / 1e3 for k, v in top}, ours, wall


def report_trace(phase, what, nsteps, trace, untraced_s):
    busy_us, nkern, top, ours, t_traced = trace
    print(f"{phase}: traced {what} {t_traced:.4f} s wall, device busy {busy_us / 1e6:.4f} s "
          f"({nkern} device events, {nkern / nsteps:.0f} per step); idle share "
          f"{1 - busy_us / 1e6 / t_traced:.4f} of the traced block, "
          f"{1 - busy_us / 1e6 / untraced_s:.4f} of the untraced block; the port's kernels "
          f"[launches, device ms per launch]: {json.dumps(ours)}; top device time (ms): "
          f"{json.dumps(top)}", flush=True)
    check(busy_us > 0, "the profiler recorded no device time")
    return ours


def predicted_weights(blocks, e_trial0, tstep, nsteps):
    """Each DMC block's mean weight as its trial energy and its energy
    predict it. Per step the population's mean weight grows by exp(tstep
    (E_T - E)), E being the weighted mean local energy that the block
    records, and branching keeps it; so a block that starts at w holds w
    exp(k tstep (E_T - E)) after its k-th step. E_T is e_trial0 (the
    warm-up's mean local energy) in block 0 and the e_trial that rundmc
    reports for the block before in each later block. The effective time
    step (about 0.97 of tstep here) and the clipping of the branching
    exponent are left out: on the JAX package's runs the prediction is
    within 20% of the weights."""
    out, logw, e_t = [], 0.0, e_trial0
    for b in blocks:
        g = tstep * (e_t - b["energytotal"])
        out.append(float(np.exp(logw) * np.mean(np.exp(g * np.arange(1, nsteps + 1)))))
        logw += nsteps * g
        e_t = b["e_trial"]
    return out


def against_pins(phase, what, e, block_energies, nmean, pin, pin_one_thread):
    """The H2O chain's energy e, the mean of the last nmean of
    block_energies, against its pins: `pin` within 1e-4 Ha, and
    `pin_one_thread` within 3 combined standard errors. The standard error
    of e is the scatter of the blocks after the first (reblock_by2's first
    level) over sqrt(nmean); the earlier chain ran the same schedule, so
    its standard error is taken equal and the combined one is sqrt(2)
    times it."""
    from pyqmc_tpu_torch.reblock import reblock_by2

    _, n, _, se, _ = reblock_by2(np.asarray(block_energies[1:], dtype=float))[0]
    sem = se * np.sqrt(n) / np.sqrt(nmean)
    comb = float(np.sqrt(2) * sem)
    print(f"{phase}: H2O {what} E={e:.6f} Ha +- {sem:.6f} (blocks after the first); "
          f"pinned {pin:.6f}; one-thread-per-walker kernels' chain {pin_one_thread:.6f}, "
          f"{abs(e - pin_one_thread) / comb:.2f} combined standard errors ({comb:.6f}) away",
          flush=True)
    check(abs(e - pin_one_thread) <= 3 * comb,
          f"the H2O {what} energy {e} is more than 3 combined standard errors ({comb}) from "
          f"{pin_one_thread}, the one-thread-per-walker kernels' chain")
    check(abs(e - pin) <= 1e-4, f"the H2O {what} chain moved: E {e} against {pin}")


def timed_in_turns(fns, run, order=("plain", "kernel", "kernel", "plain")):
    """run(name, fn) for fn in `order`; returns mean seconds of each and
    the times."""
    times = {"kernel": [], "plain": []}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name, fns[name])
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    return float(np.mean(times["kernel"])), float(np.mean(times["plain"])), times


def casci_phases(t_start, card, counters, per_point_64):
    """Phases 13-16, the multi-determinant path: K3 at its shapes, the
    CASCI anchor, multi-Slater-Jastrow VMC and DMC. `counters` {kernel:
    launch counter}; per_point_64 the device ns per point of K3 at the
    diamond's shapes (phase 8). Returns (K3's float64 and float32 numbers,
    the launches of the VMC and the DMC runs, the VMC trace's kernels)."""
    from pyqmc_tpu_torch.entry import h2o_casci_setup
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams, make_dmc_block, rundmc
    from pyqmc_tpu_torch.method.vmc import draw_streams, make_vmc_block, vmc
    from pyqmc_tpu_torch.models.orbitals import plain_orbitals
    from pyqmc_tpu_torch.observables.energy import kinetic_energy
    from pyqmc_tpu_torch.ops.move_sweep import sweep_plain
    from pyqmc_tpu_torch.ops.tmove_sweep import tmove_sweep_plain
    from pyqmc_tpu_torch.system.io import load_expansion_npz

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.n for k, c in counters.items()}

    print(f"phase 13 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 13: K3 at the multi-determinant path's shapes against its plain version
    c64 = casci_k3(torch.float64)
    print("phase 13 float64: " + json.dumps(c64), flush=True)
    c32 = casci_k3(torch.float32)
    print(f"phase 13 float32, {card}: {json.dumps(c32)}; device ns per point "
          f"{c32['energy']['device_ns_per_point']:.4f} (energy) and "
          f"{c32['tmove']['device_ns_per_point']:.4f} (T-moves) at 23 AOs x 16 columns against "
          f"{per_point_64:.4f} at the diamond's 489 AOs x 64 columns", flush=True)

    print(f"phase 14 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 14: the CASCI anchor, VMC of the bare multi-determinant Slater
    cas = load_expansion_npz()
    mol, wf, params, configs, acc = h2o_casci_setup(NCONF, dtype=torch.float32, jastrow=False)
    check(configs.positions.device.type == "cuda", "h2o_casci_setup's default device is not the GPU")
    gen = torch.Generator(device="cuda").manual_seed(37)
    reset_counts()
    t0 = time.perf_counter()
    cblocks, _ = vmc(wf, params, configs, nblocks=CASCI_NBLOCKS, nsteps_per_block=NSTEPS,
                     tstep=TSTEP, accumulators=acc, generator=gen)
    torch.cuda.synchronize()
    t_cas = time.perf_counter() - t0
    claunches = read_counts()
    for b in cblocks:
        print(f"phase 14 block {b['block']}: E={b['energytotal']:.6f} ecp={b['energyecp']:.6f} "
              f"acc={b['acceptance']:.4f} host time {b['block time']:.3f} s", flush=True)
        check(all(np.isfinite(v) for k, v in b.items() if k.startswith("energy")),
              f"non-finite energies in CASCI block {b['block']}")
    # one K3 launch per energy: the plain ECP chain's one flat ratio call
    check(claunches == {**{k: 0 for k in counters}, "value_mo": CASCI_NBLOCKS * NSTEPS},
          f"kernel launches on the CASCI VMC path: {claunches}")
    e_cas = np.array([b["energytotal"] for b in cblocks[CASCI_NWARM:]])
    m_cas, sem_cas = float(np.mean(e_cas)), float(np.std(e_cas, ddof=1) / np.sqrt(len(e_cas)))
    print(f"phase 14: launches {claunches}, E(last {len(e_cas)} blocks)={m_cas:.6f} +- "
          f"{sem_cas:.6f} Ha; E_CASCI {cas['e_casci']:.6f}, "
          f"{abs(m_cas - cas['e_casci']) / max(sem_cas, 1e-3):.2f} x max(SEM, 1e-3) away; E_HF "
          f"{cas['e_hf']:.6f}, {(cas['e_hf'] - m_cas) / sem_cas:.2f} SEM below it; {t_cas:.2f} s "
          f"for {CASCI_NBLOCKS} blocks", flush=True)
    check(abs(m_cas - cas["e_casci"]) <= 5 * max(sem_cas, 1e-3),
          f"CASCI VMC energy {m_cas} +- {sem_cas} off E_CASCI {cas['e_casci']} by more than "
          f"5 x max(SEM, 1e-3)")
    check(cas["e_hf"] - m_cas > 3 * sem_cas,
          f"CASCI VMC energy {m_cas} +- {sem_cas} not 3 SEM below E_HF {cas['e_hf']}")

    print(f"phase 15 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 15: multi-Slater-Jastrow VMC through the entry points
    mol, wf, params, configs, acc = h2o_casci_setup(NCONF, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(41)
    reset_counts()
    t0 = time.perf_counter()
    sblocks, sconfigs = vmc(wf, params, configs, nblocks=CASCI_SJ_NBLOCKS,
                            nsteps_per_block=NSTEPS, tstep=TSTEP, accumulators=acc, generator=gen)
    torch.cuda.synchronize()
    t_sj = time.perf_counter() - t0
    slaunches = read_counts()
    for b in sblocks:
        print(f"phase 15 block {b['block']}: E={b['energytotal']:.6f} ecp={b['energyecp']:.6f} "
              f"ke={b['energyke']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
        check(all(np.isfinite(v) for k, v in b.items() if k.startswith("energy")),
              f"non-finite energies in multi-Slater-Jastrow block {b['block']}")
    check(slaunches == {**{k: 0 for k in counters}, "value_mo": CASCI_SJ_NBLOCKS * NSTEPS},
          f"kernel launches on the multi-Slater-Jastrow VMC path: {slaunches}")
    e_sj = np.array([b["energytotal"] for b in sblocks[CASCI_NWARM:]])
    m_sj, sem_sj = float(np.mean(e_sj)), float(np.std(e_sj, ddof=1) / np.sqrt(len(e_sj)))
    a_sj = float(np.mean([b["acceptance"] for b in sblocks[CASCI_NWARM:]]))
    sref = CASCI_SJ_REF
    swindow = max(5 * float(np.hypot(sem_sj, sref["sem"])), 0.005)
    print(f"phase 15: launches {slaunches}, E(last {len(e_sj)} blocks)={m_sj:.6f} +- "
          f"{sem_sj:.6f} Ha, acc={a_sj:.4f}; JAX CPU reference {sref['e']:.6f} +- "
          f"{sref['sem']:.6f} Ha, acc {sref['acceptance']:.4f}; window {swindow:.6f} Ha; "
          f"{t_sj:.2f} s for {CASCI_SJ_NBLOCKS} blocks", flush=True)
    check(abs(m_sj - sref["e"]) <= swindow,
          f"multi-Slater-Jastrow VMC energy {m_sj} off the JAX reference {sref['e']} by more "
          f"than {swindow}")
    check(abs(a_sj - sref["acceptance"]) <= 0.05,
          f"multi-Slater-Jastrow acceptance {a_sj} off the JAX reference's {sref['acceptance']}")
    # one block with K3 and one without, on the same streams, timed in turns
    sblock = make_vmc_block(wf, acc, sconfigs.geometry, TSTEP, CASCI_CHECK_NSTEPS)
    sst = draw_streams(gen, CASCI_CHECK_NSTEPS, 8, NCONF, TSTEP, "cuda", torch.float32)
    sout = {}

    def plain_block():
        with plain_orbitals():
            return sblock(params, sconfigs.positions, sconfigs.wrap, gen, streams=sst)

    sfns = {"kernel": lambda: sblock(params, sconfigs.positions, sconfigs.wrap, gen, streams=sst),
            "plain": plain_block}
    reset_counts()
    stk, stp, stimes = timed_in_turns(sfns, lambda name, fn: sout.__setitem__(name, fn()),
                                      order=("plain", "kernel"))
    check(read_counts() == {**{k: 0 for k in counters}, "value_mo": CASCI_CHECK_NSTEPS},
          f"the multi-Slater-Jastrow blocks' launches: {read_counts()} (the plain one must "
          "launch none)")
    (kp, _, kavg), (pp, _, pavg) = sout["kernel"], sout["plain"]
    check(torch.equal(kp, pp), "the K3 and plain multi-Slater-Jastrow blocks moved differently")
    check(float(kavg["acceptance"]) == float(pavg["acceptance"]),
          f"acceptance {float(kavg['acceptance'])} with K3, {float(pavg['acceptance'])} without")
    rel = {k: abs(float(kavg[k]) - float(pavg[k])) / abs(float(pavg[k]))
           for k in kavg if k.startswith("energy") and k != "energyii"}
    check(all(r <= 1e-5 for r in rel.values()), f"K3 against plain block energies: {rel}")
    print(f"phase 15: {CASCI_CHECK_NSTEPS}-step multi-Slater-Jastrow block with K3 {stk:.4f} s "
          f"({NCONF * CASCI_CHECK_NSTEPS / stk:.1f} walker-steps/s), plain orbitals {stp:.4f} s "
          f"({NCONF * CASCI_CHECK_NSTEPS / stp:.1f} walker-steps/s); positions and acceptance "
          "identical, "
          f"energies' relative differences {json.dumps(rel)}", flush=True)
    tblock = make_vmc_block(wf, acc, sconfigs.geometry, TSTEP, CASCI_TRACE_NSTEPS)
    ours_sj = report_trace(
        "phase 15", f"{CASCI_TRACE_NSTEPS}-step multi-Slater-Jastrow VMC block",
        CASCI_TRACE_NSTEPS, traced(lambda: tblock(params, sconfigs.positions, sconfigs.wrap, gen)),
        stk * CASCI_TRACE_NSTEPS / CASCI_CHECK_NSTEPS)
    # the pieces of a step, each alone (CUDA events, host work included)
    spos, swrap = sconfigs.positions, sconfigs.wrap
    sstate = wf.recompute(params, spos)
    ecp = acc["energy"].ecp_acc
    pieces = {
        "vmc_sweep_ms": cuda_ms(lambda: sweep_plain(wf, sconfigs.geometry, TSTEP, 1.0, params, spos,
                                                    swrap, sstate, sst["gauss"][0],
                                                    sst["unif"][0]), 2),
        "kinetic_ms": cuda_ms(lambda: kinetic_energy(wf, params, sstate, spos), 3),
        "ecp_ms": cuda_ms(lambda: ecp(wf, params, sstate, spos, sst["rot"][0]), 3),
        "coulomb_ms": cuda_ms(lambda: acc["energy"].coulomb.energy(spos), 3),
        "recompute_ms": cuda_ms(lambda: wf.recompute(params, spos), 3)}
    print(f"phase 15: pieces of a step alone, ms: {json.dumps(pieces)}", flush=True)
    per_walker_ecp("phase 15", wf, params, sstate, spos, sst["rot"][0], ecp)

    print(f"phase 16 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 16: multi-Slater-Jastrow DMC with T-moves, from phase 15's walkers
    reset_counts()
    t0 = time.perf_counter()
    mblocks, mconfigs, mweights = rundmc(
        wf, params, sconfigs,
        nblocks=CASCI_DMC_NBLOCKS, nsteps_per_block=DMC_NSTEPS, tstep=DMC_TSTEP,
        energy_acc=acc["energy"], generator=gen, warmup_vmc_blocks=CASCI_DMC_WARMUP)
    torch.cuda.synchronize()
    t_mdmc = time.perf_counter() - t0
    mlaunches = read_counts()
    for b in mblocks:
        print(f"phase 16 block {b['block']}: E={b['energytotal']:.6f} w={b['weight']:.5f} "
              f"e_trial={b['e_trial']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
    # K3 once per energy (the warm-up's steps, the energy that sets e_trial,
    # per block its first and one per step) and once per electron of each
    # T-move sweep (the dense quadrature's ratios)
    nwarm = CASCI_DMC_WARMUP * 10
    k3_block = 1 + DMC_NSTEPS * (1 + 8)
    mexpect = {**{k: 0 for k in counters},
               "value_mo": nwarm + 1 + CASCI_DMC_NBLOCKS * k3_block}
    check(mlaunches == mexpect,
          f"kernel launches on the multi-Slater-Jastrow DMC path: {mlaunches}, expected {mexpect}")
    for b in mblocks:
        check(all(np.isfinite(v) for v in b.values()), f"non-finite value in DMC block {b}")
        check(0.5 < b["weight"] < 2.0, f"block mean weight {b['weight']} outside (0.5, 2)")
        check(b["acceptance"] > 0.9, f"DMC acceptance {b['acceptance']} not above 0.9")
    check(bool(torch.all(torch.isfinite(mweights))) and bool(torch.all(mweights > 0)),
          "final multi-Slater-Jastrow weights are not finite and positive")
    e_mdmc = float(np.mean([b["energytotal"] for b in mblocks[-CASCI_DMC_NLAST:]]))
    e_mwarm = 2 * mblocks[0]["e_est"] - mblocks[0]["energytotal"]
    check(-17.6 < e_mdmc < -16.9, f"DMC energy {e_mdmc} outside (-17.6, -16.9) Ha")
    check(e_mdmc < e_mwarm + 0.05, f"DMC energy {e_mdmc} above the warm-up VMC energy {e_mwarm}")
    mfn = make_dmc_block(wf, acc["energy"], mconfigs.geometry, DMC_TSTEP, DMC_NSTEPS)[0]
    mlast = mblocks[-1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, _, mavg = mfn(params, mconfigs.positions, mconfigs.wrap, mweights, gen,
                        mlast["e_trial"], mlast["e_est"], 0.5)
    check(bool(torch.isfinite(mavg["energytotal"])), "non-finite timed DMC block energy")
    torch.cuda.synchronize()
    t_mblock = time.perf_counter() - t0
    print(f"phase 16: launches {mlaunches} ({k3_block} K3 per block), E(last "
          f"{CASCI_DMC_NLAST} blocks)={e_mdmc:.6f} Ha, warm-up VMC E={e_mwarm:.6f} Ha, "
          f"{t_mdmc:.2f} s for {CASCI_DMC_WARMUP} warm-up + {CASCI_DMC_NBLOCKS} DMC blocks; one "
          f"{DMC_NSTEPS}-step block {t_mblock:.4f} s ({NCONF * DMC_NSTEPS / t_mblock:.1f} "
          f"walker-steps/s)", flush=True)
    dst = draw_dmc_streams(gen, 1, 8, NCONF, DMC_TSTEP, "cuda", torch.float32)
    mpos, mwrap = mconfigs.positions, mconfigs.wrap
    mstate = wf.recompute(params, mpos)
    pieces.update({
        "tmove_sweep_ms": cuda_ms(lambda: tmove_sweep_plain(
            wf, mconfigs.geometry, ecp, DMC_TSTEP, params, mpos, mwrap, mstate, dst["tqrot"][0],
            dst["u_sel"][0], dst["u_acc"][0]), 2),
        "dmc_sweep_ms": cuda_ms(lambda: sweep_plain(
            wf, mconfigs.geometry, DMC_TSTEP, 1.0, params, mpos, mwrap, mstate, dst["gauss"][0],
            dst["unif"][0], mode="dmc"), 2)})
    print(f"phase 16: the T-move and drift-diffusion sweeps alone, ms: "
          f"{pieces['tmove_sweep_ms']:.2f}, {pieces['dmc_sweep_ms']:.2f}", flush=True)
    mtrace = make_dmc_block(wf, acc["energy"], mconfigs.geometry, DMC_TSTEP, PBC_TRACE_NSTEPS)[0]
    report_trace("phase 16", f"{PBC_TRACE_NSTEPS}-step multi-Slater-Jastrow DMC block",
                 PBC_TRACE_NSTEPS, traced(lambda: mtrace(params, mpos, mwrap, mweights, gen,
                                                         mlast["e_trial"], mlast["e_est"], 0.5)),
                 t_mblock * PBC_TRACE_NSTEPS / DMC_NSTEPS)
    return c64, c32, slaunches, mlaunches, ours_sj


class WalkerEnergies:
    """An energy accumulator that keeps each step's positions and per-walker
    total energies, and averages as EnergyAccumulator.avg does (so it
    launches what the energy launches)."""

    def __init__(self, energy):
        self.energy = energy
        self.ecp_acc = energy.ecp_acc
        self.steps = []

    def avg(self, wf, params, state, positions, rot=None, u_sel=None):
        d = self.energy(wf, params, state, positions, rot, u_sel)
        self.steps.append((positions.clone(), d["total"].clone()))
        return {k: torch.mean(v, dim=0) for k, v in d.items()}


def sr_precision(wf, params, lt, energy, pos, rot):
    """One step's SR averages on the same walkers and rotations in float32
    and float64: the overlap matrices' relative difference (with the
    complex channel's terms where the parameters are complex, and then
    dpidpjI's own), the float64 one's condition number (regularized as
    delta_p does) and the relative difference of the SR steps."""
    from pyqmc_tpu_torch.observables.sr import StochasticReconfiguration

    sr = StochasticReconfiguration(energy, lt)
    out = {}
    for dtype in (torch.float32, torch.float64):
        p, x, r = cast_tree(params, dtype), pos.to(dtype), rot.to(dtype)
        a = {k: v[None].double().cpu().numpy()
             for k, v in sr.avg(wf, p, wf.recompute(p, x), x, r).items()}
        dp = a["dp"][0]
        S = a["dpidpj"][0] - np.outer(dp, dp)
        if "dpI" in a:
            S = S + a["dpidpjI"][0] - np.outer(a["dpI"][0], a["dpI"][0])
        out[dtype] = (S, sr.delta_p([1.0], a)[0][0], a.get("dpidpjI"))
    (s32, d32, i32), (s64, d64, i64) = out[torch.float32], out[torch.float64]
    reg = s64 + sr.eps * np.eye(len(s64))
    res = {"S_rel_diff": float(np.linalg.norm(s32 - s64) / np.linalg.norm(s64)),
           "cond_S_reg": float(np.linalg.cond(reg)),
           "step_rel_diff": float(np.linalg.norm(d32 - d64) / np.linalg.norm(d64))}
    if i64 is not None:
        res["dpidpjI_rel_diff"] = float(np.linalg.norm(i32 - i64) / np.linalg.norm(i64))
    return res


def optimization_phases(t_start, card, counters, vmc_step_s):
    """Phases 17-18: the H2O Jastrow optimized with SR and correlated-
    sampling line minimization, its VMC, and DMC with it. `counters`
    {kernel: launch counter}; vmc_step_s the VMC step of phase 4's kernel
    block (printed beside the SR step). Returns the launch counts and numbers
    that the kernels' line carries."""
    from pyqmc_tpu_torch.configs import initial_guess
    from pyqmc_tpu_torch.method import linemin
    from pyqmc_tpu_torch.method.dmc import rundmc
    from pyqmc_tpu_torch.method.vmc import draw_streams, make_vmc_block, vmc
    from pyqmc_tpu_torch.models.orbitals import plain_orbitals
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.observables.ecp import ECPAccumulator
    from pyqmc_tpu_torch.observables.sr import StochasticReconfiguration
    from pyqmc_tpu_torch.observables.transform import LinearTransform
    from pyqmc_tpu_torch.system.io import load_npz
    from pyqmc_tpu_torch.wftools import generate_wf

    none = {k: 0 for k in counters}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.n for k, c in counters.items()}

    print(f"phase 17 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t_phase = time.perf_counter()
    # phase 17: the Jastrow optimized through the entry points, default device
    mol, mf = load_npz()
    wf, params0, to_opt = generate_wf(mol, mf, dtype=torch.float32)
    check(params0["wf1"]["acoeff"].device.type == "cuda", "generate_wf's default device is not the GPU")
    lt = LinearTransform(params0, to_opt)
    print(f"phase 17: LinearTransform.nparams {lt.nparams} (acoeff {lt.sizes[3]}, bcoeff "
          f"{lt.sizes[4]})", flush=True)
    check(lt.nparams == OPT_NPARAMS, f"{lt.nparams} optimized parameters, not {OPT_NPARAMS}")
    energy = EnergyAccumulator(mol)
    configs = initial_guess(mol, NCONF, generator=torch.Generator().manual_seed(43), device="cuda",
                            dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(47)
    reset_counts()
    t0 = time.perf_counter()
    _, configs = vmc(wf, params0, configs, nblocks=OPT_EQUIL_BLOCKS, nsteps_per_block=10,
                     tstep=TSTEP, generator=gen)
    torch.cuda.synchronize()
    t_equil = time.perf_counter() - t0
    check(read_counts() == {**none, "vmc_sweep": OPT_EQUIL_BLOCKS * 10},
          f"kernel launches of the equilibration: {read_counts()}")
    infos = []
    reset_counts()
    t0 = time.perf_counter()
    params, oconfigs, records = linemin.line_minimization(
        wf, params0, configs, lt, energy, generator=gen, max_iterations=OPT_ITERATIONS,
        callback=lambda rec, info: infos.append(info))
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    olaunches = read_counts()
    nit = len(records)
    nsr, ncand = 10 * 10, 6  # SR steps and line-search candidates per iteration
    oexpect = {**none, "vmc_sweep": nit * nsr, "ecp_energy": nit * (nsr + 1 + ncand)}
    for rec, info in zip(records, infos):
        sec = info["seconds"]
        print(f"phase 17 iteration {rec['iteration']}: E={rec['energy']:.6f} +- "
              f"{rec['energy_err']:.6f} |g|={rec['gnorm']:.4f} tau={rec['tau']} "
              f"stalled={rec['stalled']} line energies "
              f"{[round(float(e), 5) for e in rec['line_energies']]} ess "
              f"{[round(float(e), 3) for e in info['ess']]}; wall s: SR VMC {sec['vmc']:.3f}, "
              f"solve {sec['solve']:.4f}, correlated sampling {sec['correlated']:.3f}", flush=True)
        check(all(bool(np.all(np.isfinite(rec[k])))
                  for k in ("energy", "energy_err", "gnorm", "line_energies")),
              f"non-finite optimization record {rec}")
    check(olaunches == oexpect, f"kernel launches of the optimization: {olaunches}, expected "
          f"{oexpect}")
    drop = records[0]["energy"] - records[-1]["energy"]
    dx = float(torch.linalg.norm((lt.serialize(params) - lt.serialize(params0)).double()))
    split = {k: float(np.mean([i["seconds"][k] for i in infos])) for k in infos[0]["seconds"]}
    print(f"phase 17: launches {olaunches} ({nsr} K1 and {nsr + 1 + ncand} K2 per iteration), "
          f"{nit} iterations in {t_opt:.2f} s ({t_opt / nit:.3f} s each; mean split, s: "
          f"{json.dumps(split)}), equilibration {t_equil:.2f} s; E {records[0]['energy']:.6f} -> "
          f"{records[-1]['energy']:.6f} Ha (drop {drop:.4f}); |x - x0| {dx:.4f}; {card}",
          flush=True)
    check(drop >= 0.1, f"the optimization lowered the energy by {drop} Ha, not 0.1")
    check(dx > 0, "the optimization left the parameters where they were")

    # the optimized VMC
    reset_counts()
    t0 = time.perf_counter()
    vblocks, vconfigs = vmc(wf, params, oconfigs, nblocks=OPT_VMC_BLOCKS, nsteps_per_block=NSTEPS,
                            tstep=TSTEP, accumulators={"energy": energy}, generator=gen)
    torch.cuda.synchronize()
    t_vmc = time.perf_counter() - t0
    vlaunches = read_counts()
    for b in vblocks:
        print(f"phase 17 VMC block {b['block']}: E={b['energytotal']:.6f} "
              f"ecp={b['energyecp']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
        check(all(np.isfinite(v) for k, v in b.items() if k.startswith("energy")),
              f"non-finite energies in optimized VMC block {b['block']}")
    check(vlaunches == {**none, "vmc_sweep": OPT_VMC_BLOCKS * NSTEPS,
                        "ecp_energy": OPT_VMC_BLOCKS * NSTEPS},
          f"kernel launches of the optimized VMC: {vlaunches}")
    e_v = np.array([b["energytotal"] for b in vblocks[1:]])
    m_v, sem_v = float(np.mean(e_v)), float(np.std(e_v, ddof=1) / np.sqrt(len(e_v)))
    oref = H2O_OPT_REF
    owindow = max(5 * float(np.hypot(sem_v, oref["sem"])), 0.01)
    print(f"phase 17: optimized VMC E(blocks 2-{OPT_VMC_BLOCKS})={m_v:.6f} +- {sem_v:.6f} Ha, acc "
          f"{np.mean([b['acceptance'] for b in vblocks[1:]]):.4f}; unoptimized pin "
          f"{H2O_VMC_E:.6f}; JAX CPU reference {oref['e']:.6f} +- {oref['sem']:.6f} Ha, "
          f"{(m_v - oref['e']) / np.hypot(sem_v, oref['sem']):.2f} combined SEM away, window "
          f"{owindow:.6f} Ha; {t_vmc:.2f} s", flush=True)
    check(m_v < -17.10, f"optimized VMC energy {m_v} not below -17.10 Ha")
    check(abs(m_v - oref["e"]) <= owindow,
          f"optimized VMC energy {m_v} off the JAX reference {oref['e']} by more than {owindow}")

    # the optimized parameters reach the kernels: kernels against plain on one set of streams
    plain_energy = EnergyAccumulator(mol, ecp_acc=ECPAccumulator(mol, fused=False))
    cst = draw_streams(gen, OPT_CHECK_NSTEPS, 8, NCONF, TSTEP, "cuda", torch.float32)
    runs = {}
    for fused, en in ((True, energy), (False, plain_energy)):
        probe = WalkerEnergies(en)
        block = make_vmc_block(wf, {"energy": probe}, vconfigs.geometry, TSTEP, OPT_CHECK_NSTEPS,
                               fused=fused)
        reset_counts()
        out = block(params, vconfigs.positions, vconfigs.wrap, gen, streams=cst)
        runs[fused] = (out, probe.steps, read_counts())
    check(runs[True][2] == {**none, "vmc_sweep": OPT_CHECK_NSTEPS, "ecp_energy": OPT_CHECK_NSTEPS},
          f"the kernel block's launches: {runs[True][2]}")
    check(runs[False][2] == none, f"the plain block launched {runs[False][2]}")
    worst = 0.0
    for (kx, ke), (px, pe) in zip(runs[True][1], runs[False][1]):
        agree = torch.amax(torch.abs(kx - px).reshape(NCONF, -1), dim=1) <= 1e-4
        rel = torch.abs(ke - pe)[agree] / torch.abs(pe)[agree]
        worst = max(worst, float(torch.max(rel)))
    apart = int(torch.sum(~agree))
    kacc, pacc = float(runs[True][0][2]["acceptance"]), float(runs[False][0][2]["acceptance"])
    print(f"phase 17: optimized parameters, {OPT_CHECK_NSTEPS}-step block with kernels against "
          f"plain: {apart} of {NCONF} walkers' chains apart, acceptance {kacc:.5f} and "
          f"{pacc:.5f}, energies of the others within {worst:.3e} relative", flush=True)
    check(apart <= 0.01 * NCONF, f"{apart} walkers' chains apart (more than 1%)")
    check(worst <= 1e-4, f"kernel and plain energies differ by {worst} relative")

    # the last iteration's parameter sets, correlated energies with K2 and plain
    last = infos[-1]
    crot, _ = linemin.draw_ecp_streams(gen, 8, last["positions"].shape[0], "cuda", torch.float32)
    reset_counts()
    ce = {}
    for name, en, scope in (("kernel", energy, contextlib.nullcontext),
                            ("plain", plain_energy, plain_orbitals)):
        with scope():  # plain: the ECP chain's ratios without K3
            ce[name] = linemin.correlated_energies(linemin.make_correlated_sampler(wf, en),
                                                   last["params0"], last["candidates"],
                                                   last["positions"], crot)
    check(read_counts() == {**none, "ecp_energy": 1 + ncand},
          f"the correlated samplers' launches: {read_counts()}")
    ce_rel = float(np.max(np.abs(ce["kernel"][0] - ce["plain"][0]) / np.abs(ce["plain"][0])))
    ess_diff = float(np.max(np.abs(ce["kernel"][1] - ce["plain"][1])))
    print(f"phase 17: the last iteration's {1 + ncand} parameter sets, correlated energies with "
          f"K2 {[round(float(e), 6) for e in ce['kernel'][0]]} against plain, {ce_rel:.3e} "
          f"relative apart, ess {ess_diff:.3e} apart", flush=True)
    check(ce_rel <= 1e-4, f"K2 and plain correlated energies {ce_rel} relative apart")
    check(ess_diff <= 1e-4, f"K2 and plain effective sample sizes {ess_diff} apart")

    # float32 against float64 SR averages on the same walkers and rotations
    prec = sr_precision(wf, params, lt, energy, vconfigs.positions, crot)
    print(f"phase 17: one step's SR averages, float32 against float64 on the same walkers: "
          f"{json.dumps(prec)}", flush=True)

    # one SR block timed, then traced; the SR step's pieces alone
    sr = StochasticReconfiguration(energy, lt)
    sblock = make_vmc_block(wf, {"pgrad": sr}, vconfigs.geometry, TSTEP, OPT_CHECK_NSTEPS)
    spos, swrap = vconfigs.positions, vconfigs.wrap
    sblock(params, spos, swrap, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sblock(params, spos, swrap, gen)
    torch.cuda.synchronize()
    t_sr = time.perf_counter() - t0
    ours_sr = report_trace("phase 17", f"{OPT_CHECK_NSTEPS}-step SR VMC block", OPT_CHECK_NSTEPS,
                           traced(lambda: sblock(params, spos, swrap, gen)), t_sr)
    sstate = wf.recompute(params, spos)
    srot = crot
    pieces = {"pgradient_ms": cuda_ms(lambda: wf.pgradient(params, spos), 3),
              "energy_ms": cuda_ms(lambda: energy(wf, params, sstate, spos, srot), 3),
              "sr_avg_ms": cuda_ms(lambda: sr.avg(wf, params, sstate, spos, srot), 3),
              "recompute_ms": cuda_ms(lambda: wf.recompute(params, spos), 3)}
    print(f"phase 17: SR VMC step {t_sr / OPT_CHECK_NSTEPS * 1e3:.2f} ms ({OPT_CHECK_NSTEPS}-step "
          f"block {t_sr:.4f} s) against the VMC step's {vmc_step_s * 1e3:.2f} ms (phase 4); "
          f"pieces alone (CUDA events), ms: {json.dumps(pieces)}; {card}", flush=True)
    t17 = time.perf_counter() - t_phase

    print(f"phase 18 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 18: DMC with the optimized Jastrow, from phase 17's walkers
    reset_counts()
    t0 = time.perf_counter()
    dblocks, dconfigs, dweights = rundmc(
        wf, params, vconfigs, nblocks=OPT_DMC_NBLOCKS, nsteps_per_block=DMC_NSTEPS,
        tstep=DMC_TSTEP, energy_acc=energy, generator=gen, warmup_vmc_blocks=OPT_DMC_WARMUP)
    torch.cuda.synchronize()
    t18 = time.perf_counter() - t0
    dlaunches = read_counts()
    for b in dblocks:
        print(f"phase 18 block {b['block']}: E={b['energytotal']:.6f} w={b['weight']:.5f} "
              f"e_trial={b['e_trial']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
    nwarm = OPT_DMC_WARMUP * 10  # rundmc's warm-up blocks have 10 steps
    dexpect = {**none, "vmc_sweep": nwarm, "dmc_sweep": OPT_DMC_NBLOCKS * DMC_NSTEPS,
               "tmove_sweep": OPT_DMC_NBLOCKS * DMC_NSTEPS,
               "ecp_energy": nwarm + 1 + OPT_DMC_NBLOCKS * (DMC_NSTEPS + 1)}
    check(dlaunches == dexpect, f"kernel launches of the optimized DMC: {dlaunches}, expected "
          f"{dexpect}")
    for b in dblocks:
        check(all(np.isfinite(v) for v in b.values()), f"non-finite value in DMC block {b}")
        check(0.5 < b["weight"] < 2.0, f"block mean weight {b['weight']} outside (0.5, 2)")
        check(b["acceptance"] > 0.9, f"DMC acceptance {b['acceptance']} not above 0.9")
    check(bool(torch.all(torch.isfinite(dweights))) and bool(torch.all(dweights > 0)),
          "final optimized DMC weights are not finite and positive")
    e_d = np.array([b["energytotal"] for b in dblocks[OPT_DMC_NSKIP:]])
    m_d = float(np.mean(e_d))
    from pyqmc_tpu_torch.reblock import reblock_summary

    sem_d = float(reblock_summary(e_d, nblocks=min(8, len(e_d)))["standard error"])
    readme, readme_sem = H2O_DMC_README
    print(f"phase 18: launches {dlaunches}, E(blocks {OPT_DMC_NSKIP + 1}-{OPT_DMC_NBLOCKS})="
          f"{m_d:.6f} +- {sem_d:.6f} Ha, {m_v - m_d:.4f} Ha below the optimized VMC; README "
          f"tau=0.02 value {readme:.4f}({readme_sem * 1e4:.0f}) (the JAX package on a TPU), "
          f"{m_d - readme:+.4f} Ha, {(m_d - readme) / np.hypot(sem_d, readme_sem):+.2f} combined "
          f"SEM; {t18:.2f} s for {OPT_DMC_WARMUP} warm-up + {OPT_DMC_NBLOCKS} blocks "
          f"({NCONF * DMC_NSTEPS * OPT_DMC_NBLOCKS / t18:.1f} walker-steps/s); phases 17-18 "
          f"{t17 + t18:.1f} s", flush=True)
    check(-17.27 < m_d < -17.22, f"optimized DMC energy {m_d} outside (-17.27, -17.22) Ha")
    check(m_d <= m_v - 0.03, f"optimized DMC energy {m_d} not 0.03 Ha below the VMC's {m_v}")
    return {"opt": olaunches, "opt_vmc": vlaunches, "opt_dmc": dlaunches, "iterations": nit,
            "sr": ours_sr, "params": params, "configs": vconfigs, "e_vmc": m_v, "sem_vmc": sem_v,
            "seconds17": t17}


def wavefunction_contracts(card):
    """Phase 19: testwf.run_all on the new wavefunctions on the card, float64,
    WF_CHECK_NCONF walkers, seeded nonzero coefficients; the JAX package's
    AddWF subset on AddWF(ground determinant, single excitation); a cusp b
    basis in float32 against float64."""
    from pyqmc_tpu_torch.configs import initial_guess
    from pyqmc_tpu_torch.models import testwf
    from pyqmc_tpu_torch.models.addwf import AddWF
    from pyqmc_tpu_torch.models.func3d import default_ee_basis
    from pyqmc_tpu_torch.models.generic_jastrow import GeminalJastrow, GPSJastrow
    from pyqmc_tpu_torch.models.jastrow3 import ThreeBodyJastrow
    from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu_torch.system.io import load_npz
    from pyqmc_tpu_torch.wftools import generate_jastrow3, generate_wf

    mol, mf = load_npz()
    f64 = {"device": "cuda", "dtype": torch.float64}
    rng = np.random.default_rng(53)

    def normal(scale, like):
        return torch.as_tensor(rng.normal(scale=scale, size=tuple(like.shape)), **f64)

    j3 = generate_jastrow3(mol)[0]
    p_j3 = {"ccoeff": normal(0.05, j3.make_params(**f64)["ccoeff"])}
    gem = GeminalJastrow(mol)
    p_gem = {"gcoeff": normal(0.02, gem.make_params(**f64)["gcoeff"])}
    gps = GPSJastrow(mol)
    p_gps = gps.make_params(**f64)
    p_gps["alpha"] = normal(0.1, p_gps["alpha"])
    prod, p_prod, _ = generate_wf(mol, mf, jastrow3=True, **f64)
    p_prod["wf1"]["acoeff"] = normal(0.1, p_prod["wf1"]["acoeff"])
    p_prod["wf2"]["ccoeff"] = normal(0.05, p_prod["wf2"]["ccoeff"])
    configs = initial_guess(mol, WF_CHECK_NCONF, generator=torch.Generator().manual_seed(59),
                            **f64)
    seconds = {}
    for name, wf, params in (("ThreeBodyJastrow", j3, p_j3), ("GeminalJastrow", gem, p_gem),
                             ("GPSJastrow", gps, p_gps),
                             ("MultiplyWF(Slater, JastrowSpin, ThreeBodyJastrow)", prod, p_prod)):
        t0 = time.perf_counter()
        testwf.run_all(wf, params, configs, torch.Generator().manual_seed(61))
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 3)
    # the JAX package's AddWF subset (tests/unit/test_more_wfs.py:39-49)
    ca = mf.mo_coeff[0]
    zero = np.zeros(1, dtype=np.int64)
    excited = Slater(mol, None, DeterminantExpansion(occ_up=np.array([[0, 1, 2, 4]]),
                                                     occ_dn=np.array([[0, 1, 2, 3]]),
                                                     map_up=zero, map_dn=zero),
                     (ca[:, :5], ca[:, :4]))
    add = AddWF(Slater.from_mean_field(mf), excited)
    p_add = add.make_params(**f64)
    p_add["coeff"] = torch.tensor([0.9, 0.35], **f64)
    t0 = time.perf_counter()
    for i, fn in enumerate((testwf.test_updateinternals, testwf.test_testvalue,
                            testwf.test_testvalue_many, testwf.test_gradient,
                            testwf.test_gradient_laplacian)):
        fn(add, p_add, configs, torch.Generator().manual_seed(67 + i))
    torch.cuda.synchronize()
    seconds["AddWF"] = round(time.perf_counter() - t0, 3)
    # float32 with a cusp b basis: the self pair (r = 0) meets f'/r = 1e12
    # and must give no inf or nan (ThreeBodyJastrow zeroes its table there)
    t0 = time.perf_counter()
    cusp = ThreeBodyJastrow(mol, b_basis=default_ee_basis(2))
    c = rng.normal(scale=0.05, size=tuple(cusp.make_params(**f64)["ccoeff"].shape))
    shift = 0.3 * torch.randn((8, WF_CHECK_NCONF, 6, 3), dtype=torch.float64,
                              generator=torch.Generator().manual_seed(71)).cuda()
    out = {}
    for dt in (torch.float32, torch.float64):
        p = {"ccoeff": torch.tensor(c, device="cuda", dtype=dt)}
        pos = configs.positions.to(dt)
        st = cusp.recompute(p, pos)
        g, lap = cusp.gradient_laplacian_many(p, st, tuple(range(8)), pos)
        ratios = cusp.testvalue_aux_all(p, st, pos.transpose(0, 1)[:, :, None, :] + shift.to(dt))
        out[dt] = {"u": st.u, "grad": g, "lap": lap, "ratio": ratios}
    cusp_err = {}
    for k, v in out[torch.float32].items():
        ref = out[torch.float64][k]
        check(bool(torch.all(torch.isfinite(v))), f"float32 cusp-basis three-body {k} not finite")
        cusp_err[k] = float(torch.max(torch.abs(v.double() - ref)) / torch.max(torch.abs(ref)))
        check(cusp_err[k] <= CUSP32_RTOL,
              f"float32 cusp-basis three-body {k} {cusp_err[k]:.3g} from float64 "
              f"(tolerance {CUSP32_RTOL})")
    torch.cuda.synchronize()
    seconds["ThreeBodyJastrow cusp float32"] = round(time.perf_counter() - t0, 3)
    print(f"phase 19: run_all passed on the card (float64, {WF_CHECK_NCONF} walkers), s: "
          f"{json.dumps(seconds)}; {card}", flush=True)
    print(f"phase 19: cusp-basis three-body Jastrow, float32 finite, largest error relative to "
          f"float64: {json.dumps(cusp_err)} (tolerance {CUSP32_RTOL})", flush=True)


def config3_phases(t_start, card, counters, opt):
    """Phases 19-22: the new wavefunctions' contracts, the three-body Jastrow
    optimized at 2048 walkers, BASELINE config 3 VMC and DMC with T-moves.
    `counters` {kernel: launch counter}; `opt` what optimization_phases
    returns (phase 17's optimized parameters, walkers and VMC energy).
    Returns the launch counts and numbers the kernels' line carries."""
    from pyqmc_tpu_torch.entry import h2o_casci_j3_setup
    from pyqmc_tpu_torch.method import linemin
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams, make_dmc_block, rundmc
    from pyqmc_tpu_torch.method.vmc import draw_streams, make_vmc_block, vmc
    from pyqmc_tpu_torch.models.orbitals import plain_orbitals
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.observables.energy import kinetic_energy
    from pyqmc_tpu_torch.observables.transform import LinearTransform
    from pyqmc_tpu_torch.ops.move_sweep import sweep_plain
    from pyqmc_tpu_torch.ops.tmove_sweep import tmove_sweep_plain
    from pyqmc_tpu_torch.system.io import load_npz
    from pyqmc_tpu_torch.wftools import generate_wf

    none = {k: 0 for k in counters}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.n for k, c in counters.items()}

    print(f"phase 19 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t19 = time.perf_counter()
    wavefunction_contracts(card)
    t19 = time.perf_counter() - t19

    print(f"phase 20 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t20 = time.perf_counter()
    # phase 20: the two- and three-body Jastrow optimized from phase 17's two-body one
    mol, mf = load_npz()
    wf, params0, to_opt = generate_wf(mol, mf, jastrow3=True, dtype=torch.float32)
    check(params0["wf2"]["ccoeff"].device.type == "cuda",
          "generate_wf's default device is not the GPU")
    params0["wf1"] = {k: v.clone() for k, v in opt["params"]["wf1"].items()}
    lt = LinearTransform(params0, to_opt)
    check(lt.nparams == J3_NPARAMS, f"{lt.nparams} optimized parameters, not {J3_NPARAMS}")
    energy = EnergyAccumulator(mol)
    gen = torch.Generator(device="cuda").manual_seed(71)
    its = []

    def per_iteration(rec, info):
        its.append((rec, info, read_counts()))
        reset_counts()

    reset_counts()
    t0 = time.perf_counter()
    params, oconfigs, records = linemin.line_minimization(
        wf, params0, opt["configs"], lt, energy, generator=gen, max_iterations=J3_ITERATIONS,
        vmc_blocks=J3_SR_BLOCKS, callback=per_iteration)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    nsr, ncand = J3_SR_BLOCKS * 10, 6
    for rec, info, n in its:
        sec = info["seconds"]
        print(f"phase 20 iteration {rec['iteration']}: E={rec['energy']:.6f} +- "
              f"{rec['energy_err']:.6f} |g|={rec['gnorm']:.4f} tau={rec['tau']} SR step "
              f"{sec['vmc'] / nsr * 1e3:.2f} ms (SR VMC {sec['vmc']:.3f} s, solve "
              f"{sec['solve']:.4f}, correlated sampling {sec['correlated']:.3f}); launches "
              f"{json.dumps({k: v for k, v in n.items() if v})}", flush=True)
        check(all(bool(np.all(np.isfinite(rec[k])))
                  for k in ("energy", "energy_err", "gnorm", "line_energies")),
              f"non-finite optimization record {rec}")
        # K3 once per energy: each SR step's, the correlated sampler's reference and candidates'
        check(n == {**none, "value_mo": nsr + 1 + ncand},
              f"kernel launches of a three-body optimization iteration: {n}")
    dx = float(torch.linalg.norm((lt.serialize(params) - lt.serialize(params0)).double()))
    check(dx > 0, "the optimization left the parameters where they were")
    reset_counts()
    t0 = time.perf_counter()
    vblocks, vconfigs = vmc(wf, params, oconfigs, nblocks=J3_VMC_BLOCKS,
                            nsteps_per_block=J3_VMC_NSTEPS,
                            tstep=TSTEP, accumulators={"energy": energy}, generator=gen)
    torch.cuda.synchronize()
    t_vmc = time.perf_counter() - t0
    vlaunches = read_counts()
    for b in vblocks:
        print(f"phase 20 VMC block {b['block']}: E={b['energytotal']:.6f} "
              f"ecp={b['energyecp']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
        check(all(np.isfinite(v) for k, v in b.items() if k.startswith("energy")),
              f"non-finite energies in three-body VMC block {b['block']}")
    check(vlaunches == {**none, "value_mo": J3_VMC_BLOCKS * J3_VMC_NSTEPS},
          f"kernel launches of the three-body VMC: {vlaunches}")
    e_v = np.array([b["energytotal"] for b in vblocks[1:]])
    m_v, sem_v = float(np.mean(e_v)), float(np.std(e_v, ddof=1) / np.sqrt(len(e_v)))
    ref = J3_OPT_REF
    below17 = opt["e_vmc"] - m_v
    comb17 = float(np.hypot(sem_v, opt["sem_vmc"]))
    print(f"phase 20: {len(records)} iterations in {t_opt:.2f} s ({t_opt / len(records):.3f} s "
          f"each), E {records[0]['energy']:.6f} -> {records[-1]['energy']:.6f} Ha, |x - x0| "
          f"{dx:.4f}; optimized VMC E(blocks 2-{J3_VMC_BLOCKS})={m_v:.6f} +- {sem_v:.6f} Ha, "
          f"{below17:.6f} Ha below phase 17's {opt['e_vmc']:.6f} +- {opt['sem_vmc']:.6f} "
          f"({below17 / comb17:.2f} combined SEM); JAX CPU reference {ref['e']:.6f} +- "
          f"{ref['sem']:.6f} Ha, {m_v - ref['e']:+.6f} Ha (bound {J3_OPT_BOUND} Ha); VMC "
          f"{t_vmc:.2f} s; {card}", flush=True)
    check(m_v <= opt["e_vmc"] + 3 * comb17,
          f"three-body VMC energy {m_v} above phase 17's {opt['e_vmc']} by more than 3 combined "
          "SEM")
    check(abs(m_v - ref["e"]) <= J3_OPT_BOUND,
          f"three-body VMC energy {m_v} off the JAX reference {ref['e']} by more than "
          f"{J3_OPT_BOUND} Ha")
    t20 = time.perf_counter() - t20

    print(f"phase 21 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t21 = time.perf_counter()
    # phase 21: BASELINE config 3 VMC through the entry point, on the committed coefficients
    mol, wf, params, configs, acc = h2o_casci_j3_setup(NCONF, dtype=torch.float32)
    check(configs.positions.device.type == "cuda", "h2o_casci_j3_setup's default device is not "
          "the GPU")
    gen = torch.Generator(device="cuda").manual_seed(73)
    reset_counts()
    t0 = time.perf_counter()
    cblocks, cconfigs = vmc(wf, params, configs, nblocks=CONFIG3_NBLOCKS, nsteps_per_block=NSTEPS,
                            tstep=TSTEP, accumulators=acc, generator=gen)
    torch.cuda.synchronize()
    t_c3 = time.perf_counter() - t0
    c3launches = read_counts()
    for b in cblocks:
        print(f"phase 21 block {b['block']}: E={b['energytotal']:.6f} ecp={b['energyecp']:.6f} "
              f"ke={b['energyke']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
        check(all(np.isfinite(v) for k, v in b.items() if k.startswith("energy")),
              f"non-finite energies in config 3 block {b['block']}")
    check(c3launches == {**none, "value_mo": CONFIG3_NBLOCKS * NSTEPS},
          f"kernel launches of config 3 VMC: {c3launches}")
    e_c = np.array([b["energytotal"] for b in cblocks[1:]])
    m_c, sem_c = float(np.mean(e_c)), float(np.std(e_c, ddof=1) / np.sqrt(len(e_c)))
    a_c = float(np.mean([b["acceptance"] for b in cblocks[1:]]))
    cref = CONFIG3_REF
    cwindow = 3 * float(np.hypot(sem_c, cref["sem"]))
    step_ms = float(np.mean([b["block time"] for b in cblocks[1:]])) / NSTEPS * 1e3
    zc = (m_c - cref["e"]) / np.hypot(sem_c, cref["sem"])
    print(f"phase 21: launches {c3launches}, E(blocks 2-{CONFIG3_NBLOCKS})={m_c:.6f} +- "
          f"{sem_c:.6f} Ha, acc={a_c:.4f}; JAX CPU reference {cref['e']:.6f} +- {cref['sem']:.6f} "
          f"Ha, acc {cref['acceptance']:.4f}, {zc:+.2f} combined SEM (window {cwindow:.6f} Ha); "
          f"step {step_ms:.1f} ms ({NCONF / step_ms * 1e3:.1f} walker-steps/s), {t_c3:.2f} s for "
          f"{CONFIG3_NBLOCKS} blocks; {card}", flush=True)
    check(abs(m_c - cref["e"]) <= cwindow,
          f"config 3 VMC energy {m_c} off the JAX reference {cref['e']} by more than 3 combined "
          f"SEM ({cwindow})")
    # a K3 block and a plain-orbital block on one set of streams
    n = CONFIG3_CHECK_NCONF
    kpos, kwrap = cconfigs.positions[:n].clone(), cconfigs.wrap[:n].clone()
    kblock = make_vmc_block(wf, acc, cconfigs.geometry, TSTEP, CONFIG3_CHECK_NSTEPS)
    kst = draw_streams(gen, CONFIG3_CHECK_NSTEPS, 8, n, TSTEP, "cuda", torch.float32)
    reset_counts()
    kp, _, kavg = kblock(params, kpos, kwrap, None, streams=kst)
    check(read_counts() == {**none, "value_mo": CONFIG3_CHECK_NSTEPS},
          f"the config 3 K3 block's launches: {read_counts()}")
    with plain_orbitals():
        pp, _, pavg = kblock(params, kpos, kwrap, None, streams=kst)
    check(read_counts() == {**none, "value_mo": CONFIG3_CHECK_NSTEPS},
          f"the config 3 plain-orbital block launched {read_counts()}")
    check(torch.equal(kp, pp), "the K3 and plain-orbital config 3 blocks moved differently")
    check(float(kavg["acceptance"]) == float(pavg["acceptance"]),
          f"acceptance {float(kavg['acceptance'])} with K3, {float(pavg['acceptance'])} without")
    rel = {k: abs(float(kavg[k]) - float(pavg[k])) / abs(float(pavg[k]))
           for k in kavg if k.startswith("energy") and k != "energyii"}
    check(all(r <= 1e-5 for r in rel.values()), f"K3 against plain config 3 energies: {rel}")
    print(f"phase 21: {n}-walker {CONFIG3_CHECK_NSTEPS}-step block with K3 against plain orbitals "
          f"on one set of streams: positions and acceptance identical, energies' relative "
          f"differences {json.dumps(rel)}", flush=True)
    tblock = make_vmc_block(wf, acc, cconfigs.geometry, TSTEP, CONFIG3_TRACE_NSTEPS)
    ours_c3 = report_trace(
        "phase 21", f"{CONFIG3_TRACE_NSTEPS}-step config 3 VMC block", CONFIG3_TRACE_NSTEPS,
        traced(lambda: tblock(params, cconfigs.positions, cconfigs.wrap, gen)),
        step_ms * CONFIG3_TRACE_NSTEPS / 1e3)
    # the pieces of a step, each alone, and the three-body Jastrow's share of each
    cpos, cwrap = cconfigs.positions, cconfigs.wrap
    cstate = wf.recompute(params, cpos)
    cst = draw_streams(gen, 1, 8, NCONF, TSTEP, "cuda", torch.float32)
    ecp = acc["energy"].ecp_acc
    j3, pj3, sj3 = wf.wfs[2], params["wf2"], cstate[2]
    moved = cpos + 0.1
    half = torch.arange(NCONF, device="cuda") % 2 == 0

    def j3_sweep():
        s = sj3
        for e in range(8):
            _, aux = j3.move_begin(pj3, s, e, s.positions[:, e])
            _, _, saved = j3.move_finish(pj3, s, e, moved[:, e], aux)
            s = j3.updateinternals(pj3, s, e, moved[:, e], half, saved)

    aux = cpos.transpose(0, 1)[:, :, None, :] + 0.3 * torch.randn(
        (8, NCONF, 6, 3), generator=gen, device="cuda")
    pieces = {
        "vmc_sweep_ms": cuda_ms(lambda: sweep_plain(wf, cconfigs.geometry, TSTEP, 1.0, params,
                                                    cpos, cwrap, cstate, cst["gauss"][0],
                                                    cst["unif"][0]), 2),
        "j3_sweep_ms": cuda_ms(j3_sweep, 2),
        "kinetic_ms": cuda_ms(lambda: kinetic_energy(wf, params, cstate, cpos), 3),
        "j3_kinetic_ms": cuda_ms(lambda: j3.gradient_laplacian_many(pj3, sj3, tuple(range(8)),
                                                                    cpos), 3),
        "ecp_ms": cuda_ms(lambda: ecp(wf, params, cstate, cpos, cst["rot"][0]), 3),
        "j3_ecp_ratios_ms": cuda_ms(lambda: j3.testvalue_aux_all(pj3, sj3, aux), 3),
        "coulomb_ms": cuda_ms(lambda: acc["energy"].coulomb.energy(cpos), 3),
        "recompute_ms": cuda_ms(lambda: wf.recompute(params, cpos), 3),
        "j3_recompute_ms": cuda_ms(lambda: j3.recompute(pj3, cpos), 3)}
    print(f"phase 21: pieces of a step alone (CUDA events, host work included), ms: "
          f"{json.dumps(pieces)}; {card}", flush=True)
    per_walker_ecp("phase 21", wf, params, cstate, cpos, cst["rot"][0], ecp)
    t21 = time.perf_counter() - t21

    print(f"phase 22 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t22 = time.perf_counter()
    # phase 22: config 3 DMC with T-moves from phase 21's walkers
    reset_counts()
    t0 = time.perf_counter()
    dblocks, dconfigs, dweights = rundmc(
        wf, params, cconfigs, nblocks=CONFIG3_DMC_NBLOCKS, nsteps_per_block=DMC_NSTEPS,
        tstep=DMC_TSTEP, energy_acc=acc["energy"], generator=gen,
        warmup_vmc_blocks=CONFIG3_DMC_WARMUP)
    torch.cuda.synchronize()
    t_dmc = time.perf_counter() - t0
    dlaunches = read_counts()
    for b in dblocks:
        print(f"phase 22 block {b['block']}: E={b['energytotal']:.6f} w={b['weight']:.5f} "
              f"e_trial={b['e_trial']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
    # K3 once per energy and once per electron of each T-move sweep, as in phase 16
    nwarm = CONFIG3_DMC_WARMUP * 10
    k3_block = 1 + DMC_NSTEPS * (1 + 8)
    dexpect = {**none, "value_mo": nwarm + 1 + CONFIG3_DMC_NBLOCKS * k3_block}
    check(dlaunches == dexpect,
          f"kernel launches of config 3 DMC: {dlaunches}, expected {dexpect}")
    for b in dblocks:
        check(all(np.isfinite(v) for v in b.values()), f"non-finite value in DMC block {b}")
        check(0.5 < b["weight"] < 2.0, f"block mean weight {b['weight']} outside (0.5, 2)")
        check(b["acceptance"] > 0.9, f"DMC acceptance {b['acceptance']} not above 0.9")
    check(bool(torch.all(torch.isfinite(dweights))) and bool(torch.all(dweights > 0)),
          "final config 3 weights are not finite and positive")
    e_d = float(np.mean([b["energytotal"] for b in dblocks[-CONFIG3_DMC_NLAST:]]))
    e_warm = 2 * dblocks[0]["e_est"] - dblocks[0]["energytotal"]
    check(-17.6 < e_d < -16.9, f"config 3 DMC energy {e_d} outside (-17.6, -16.9) Ha")
    check(e_d < e_warm + 0.05, f"config 3 DMC energy {e_d} above the warm-up VMC energy {e_warm}")
    dstep_ms = float(np.mean([b["block time"] for b in dblocks])) / DMC_NSTEPS * 1e3
    dst = draw_dmc_streams(gen, 1, 8, NCONF, DMC_TSTEP, "cuda", torch.float32)
    dpos, dwrap = dconfigs.positions, dconfigs.wrap
    dstate = wf.recompute(params, dpos)
    k3 = counters["value_mo"].n
    sweeps = {
        "tmove_sweep_ms": cuda_ms(lambda: tmove_sweep_plain(
            wf, dconfigs.geometry, ecp, DMC_TSTEP, params, dpos, dwrap, dstate, dst["tqrot"][0],
            dst["u_sel"][0], dst["u_acc"][0]), 2),
        "dmc_sweep_ms": cuda_ms(lambda: sweep_plain(
            wf, dconfigs.geometry, DMC_TSTEP, 1.0, params, dpos, dwrap, dstate, dst["gauss"][0],
            dst["unif"][0], mode="dmc"), 2)}
    check(counters["value_mo"].n - k3 == 3 * 8, "the T-move sweep did not launch K3 once per "
          "electron")
    print(f"phase 22: launches {dlaunches} ({k3_block} K3 per block), E(last "
          f"{CONFIG3_DMC_NLAST} blocks)={e_d:.6f} Ha, warm-up VMC E={e_warm:.6f} Ha; step "
          f"{dstep_ms:.1f} ms ({NCONF / dstep_ms * 1e3:.1f} walker-steps/s), {t_dmc:.2f} s for "
          f"{CONFIG3_DMC_WARMUP} warm-up + {CONFIG3_DMC_NBLOCKS} DMC blocks; the T-move and "
          f"drift-diffusion sweeps alone, ms: {json.dumps(sweeps)}; {card}", flush=True)
    t22 = time.perf_counter() - t22
    print(f"phases 19-22: {t19:.1f} + {t20:.1f} + {t21:.1f} + {t22:.1f} = "
          f"{t19 + t20 + t21 + t22:.1f} s", flush=True)
    nit = len(records)
    return {"j3_opt_per_iteration": sum(n["value_mo"] for _, _, n in its) // nit,
            "j3_opt_vmc": vlaunches["value_mo"], "config3_vmc": c3launches["value_mo"],
            "config3_dmc": dlaunches["value_mo"], "config3_trace": ours_c3}


# --- phases 23-26: BASELINE config 5, the general twist and the two-twist average --

def twist_k3(dtype, reps=50):
    """Phase 23's kernel checks on the general twist (diamond_twist_setup,
    500 walkers): K3's pair launch over [Re R | Im R] (489 AOs x 128
    columns) against its plain version at the ECP chunk's points (21
    electrons x 500 walkers x 24 selected points) and at the T-move
    quadrature's (one electron's 96 points per walker), as the pair
    columns and as the complex MO values the path reads; then the
    per-walker ECP energies (before the mean) with K3 against plain orbitals
    on one set of rotations and selection uniforms. float64 to 1e-9,
    float32 to 1e-4 of each entry plus the largest entry's magnitude. In
    float32 also the device time of one launch (CUDA events over `reps`
    launches of the C entry point), the wrapper's, the plain version's and
    the bound (`value_mo_bound`)."""
    from pyqmc_tpu_torch.entry import diamond_twist_setup
    from pyqmc_tpu_torch.method.vmc import draw_streams
    from pyqmc_tpu_torch.models.orbitals import _pair, plain_orbitals
    from pyqmc_tpu_torch.observables.ecp import systematic_downselect
    from pyqmc_tpu_torch.ops import _build

    sup, wf, params, configs, acc = diamond_twist_setup(DIAMOND_NCONF, device="cuda", dtype=dtype,
                                                        seed=41)
    params = randomize_jastrow(params, 42)
    pos = configs.positions
    nelec = pos.shape[1]
    orb = wf.wfs[0].orbitals
    check(not orb.real_mode and params["wf0"]["mo_coeff_alpha"][0].is_complex(),
          "diamond_twist_setup's orbitals are not in the complex mode")
    ecp = acc["energy"].ecp_acc
    gen = torch.Generator(device="cuda").manual_seed(43)
    st = draw_streams(gen, 1, nelec, DIAMOND_NCONF, TSTEP, "cuda", dtype, downselect=True)
    rot, u = st["rot"][0], st["u_sel"][0]
    k3 = 262144 // (DIAMOND_NCONF * ecp.nselect)
    aux, T = ecp.quadrature_geometry(pos[:, :k3].transpose(0, 1), rot[:k3])
    idx, _ = systematic_downselect(T, ecp.nselect, u[:k3])
    aux = torch.gather(aux, 2, idx[..., None].expand(*idx.shape, 3)).reshape(-1, 3)
    tq, _ = ecp.quadrature_geometry(pos[:, 0], rot[0])
    points = {"ecp_chunk": aux, "tmove": tq.reshape(-1, 3)}
    C = _pair(orb._folded_coeff(params["wf0"], dtype))
    vm = orb._value_mo
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    res = {}
    for name, X in points.items():
        Xf, _ = orb._fold(X)
        plain = vm.plain_t(Xf, C)
        err = close_rel(f"{dtype} K3 pair {name} (2 norb, M)", vm.kernel_t(Xf, C), plain, tol)
        with plain_orbitals():
            mo_p = orb.eval(params["wf0"], X, 0)
        mo_k = orb.eval(params["wf0"], X, 0)
        err_mo = max(close_rel(f"{dtype} K3 {name} complex MOs, spin {s}", k, p, tol)
                     for s, (k, p) in enumerate(zip(mo_k, mo_p)))
        res[name] = {"points": Xf.shape[0], "columns": C.shape[1], "max_abs_err": err,
                     "max_abs_err_complex_mo": err_mo}
        if dtype == torch.float32:
            out, held, largs = vm.pack(Xf, C)
            nbytes, ops = value_mo_bound(orb._repl_spec, Xf.shape[0], C.shape[1])
            bms, by = bound_ms(nbytes, ops)
            dev = cuda_ms(lambda: _build.launch("pq_value_mo", torch.float32, *largs), reps)
            res[name].update({
                "device_ms": dev, "wrapper_ms": cuda_ms(lambda: vm.kernel_t(Xf, C), reps),
                "plain_ms": cuda_ms(lambda: vm.plain_t(Xf, C), 5), "bytes": nbytes,
                "operations": ops, "bound_ms": bms, "bound_by": by, "bound_share": bms / dev})
            del held
    err, rel = per_walker_ecp(f"phase 23 {dtype}", wf, params, wf.recompute(params, pos), pos, rot,
                              ecp, u, tol)
    res["ecp_per_walker"] = {"max_abs_err": err, "max_rel_err": rel}
    return res


def twist_phases(t_start, card, counters, gamma_configs):
    """Phases 23-26, BASELINE config 5: the kernels on the general twist and
    the complex wavefunction's contracts, general-twist VMC and DMC with
    T-moves, and the two-twist average. `gamma_configs` phase 9's final
    walkers (the TRIM supercell VMC), from which phase 24 and the average's
    TRIM twist start. Returns the launch counts and numbers the kernels'
    line carries."""
    from pyqmc_tpu_torch.configs import Configs
    from pyqmc_tpu_torch.entry import diamond_twist_average_setup, diamond_twist_setup
    from pyqmc_tpu_torch.method.dmc import rundmc
    from pyqmc_tpu_torch.method.twist_average import twist_average_vmc
    from pyqmc_tpu_torch.method.vmc import draw_streams, make_vmc_block, vmc
    from pyqmc_tpu_torch.models import testwf
    from pyqmc_tpu_torch.observables.energy import kinetic_energy
    from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep, sweep_plain

    none = {k: 0 for k in counters}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.n for k, c in counters.items()}

    def copy_configs(c):
        return Configs.create(c.positions.clone(), c.geometry, wrap=c.wrap.clone())

    print(f"phase 23 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t23 = time.perf_counter()
    # phase 23: K3's pair launch and the per-walker ECP energies on the general twist
    k64 = twist_k3(torch.float64)
    print("phase 23 float64: " + json.dumps(k64), flush=True)
    k32 = twist_k3(torch.float32)
    print(f"phase 23 float32, {card}: " + json.dumps(k32), flush=True)
    # the complex wavefunction's contracts on the card, float64, at 64 of
    # phase 9's equilibrated walkers: at initial_guess's walkers (electrons
    # piled near the nuclei, |lap psi / psi| ~ 100) the finite-difference
    # laplacian of testwf (step 1e-4) is roundoff-bound, its error growing as
    # the step shrinks, and crossed the JAX package's 1e-4 on the card
    _, cwf, cparams, cconf, _ = diamond_twist_setup(WF_CHECK_NCONF, device="cuda",
                                                    dtype=torch.float64, seed=44)
    cconf = Configs.create(gamma_configs.positions[:WF_CHECK_NCONF].double(), cconf.geometry,
                           wrap=gamma_configs.wrap[:WF_CHECK_NCONF].clone())
    cparams = randomize_jastrow(cparams, 45)
    reset_counts()
    t0 = time.perf_counter()
    testwf.run_all(cwf, cparams, cconf, torch.Generator().manual_seed(46))
    check(read_counts() == none, f"float64 run_all launched kernels: {read_counts()}")
    print(f"phase 23: testwf.run_all on the general-twist Slater-Jastrow, {WF_CHECK_NCONF} "
          f"walkers, float64: passed in {time.perf_counter() - t0:.1f} s", flush=True)
    t23 = time.perf_counter() - t23

    print(f"phase 24 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t24 = time.perf_counter()
    # phase 24: general-twist VMC through the entry point, from phase 9's walkers
    sup, wf, params, configs, acc = diamond_twist_setup(DIAMOND_NCONF, dtype=torch.float32)
    check(configs.positions.device.type == "cuda",
          "diamond_twist_setup's default device is not the GPU")
    check(params["wf0"]["mo_coeff_alpha"][0].dtype == torch.complex64,
          "the general twist's coefficients are not complex64")
    check(build_fused_sweep(wf, configs.geometry, TSTEP) is None,
          "a complex wavefunction passed K7's gate")
    configs = Configs.create(gamma_configs.positions.clone(), configs.geometry,
                             wrap=gamma_configs.wrap.clone())
    nelec, nsel = sum(sup.nelec), acc["energy"].ecp_acc.nselect
    per_step = {"gto_eval": -(-nelec // max(1, 16384 // DIAMOND_NCONF)),
                "value_mo": -(-nelec // max(1, 262144 // (DIAMOND_NCONF * nsel)))}
    gen = torch.Generator(device="cuda").manual_seed(47)
    inner = make_vmc_block(wf, acc, configs.geometry, TSTEP, DIAMOND_NSTEPS)
    per_block = []

    def counted_block(*args):
        before = read_counts()
        out = inner(*args)
        per_block.append({k: v - before[k] for k, v in read_counts().items()})
        return out

    reset_counts()
    t0 = time.perf_counter()
    vblocks, vconfigs = vmc(wf, params, configs, nblocks=TWIST_NBLOCKS,
                            nsteps_per_block=DIAMOND_NSTEPS, tstep=TSTEP, accumulators=acc,
                            generator=gen, block_fn=counted_block)
    torch.cuda.synchronize()
    t_vmc = time.perf_counter() - t0
    vlaunches = read_counts()
    for b, n in zip(vblocks, per_block):
        print(f"phase 24 block {b['block']}: E/cell={b['energytotal'] / DIAMOND_NCELL:.6f} "
              f"ecp/cell={b['energyecp'] / DIAMOND_NCELL:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s launches {json.dumps(n)}", flush=True)
        check(n == {k: DIAMOND_NSTEPS * per_step.get(k, 0) for k in counters},
              f"kernel launches in a general-twist VMC block: {n}")
        check(all(np.isfinite(v) for k, v in b.items() if k.startswith("energy")),
              f"non-finite energies in general-twist block {b['block']}")
    kept = vblocks[TWIST_NSKIP:]
    e_cells = np.array([b["energytotal"] / DIAMOND_NCELL for b in kept])
    e_v, sem_v = float(np.mean(e_cells)), float(np.std(e_cells, ddof=1) / np.sqrt(len(e_cells)))
    a_v = float(np.mean([b["acceptance"] for b in kept]))
    vref = TWIST_VMC_REF
    vwindow = max(5 * float(np.hypot(sem_v, vref["sem"])), 0.02)
    step_s = float(np.mean([b["block time"] for b in kept])) / DIAMOND_NSTEPS
    print(f"phase 24: launches {vlaunches}, E/cell(blocks {TWIST_NSKIP + 1}-{TWIST_NBLOCKS})="
          f"{e_v:.6f} +- {sem_v:.6f} Ha, acc={a_v:.4f}; JAX CPU reference {vref['e_cell']:.6f} "
          f"+- {vref['sem']:.6f} Ha, acc {vref['acceptance']:.4f}; window {vwindow:.6f} Ha; "
          f"step {step_s * 1e3:.1f} ms ({DIAMOND_NCONF / step_s:.1f} walker-steps/s), "
          f"{t_vmc:.2f} s for {TWIST_NBLOCKS} blocks; {card}", flush=True)
    check(abs(e_v - vref["e_cell"]) <= vwindow,
          f"general-twist E/cell {e_v} off the JAX reference {vref['e_cell']} by more than "
          f"{vwindow}")
    check(abs(a_v - vref["acceptance"]) <= 0.05,
          f"general-twist acceptance {a_v} off the JAX reference's {vref['acceptance']}")
    tblock = make_vmc_block(wf, acc, configs.geometry, TSTEP, TWIST_TRACE_NSTEPS)
    walk = {"pos": vconfigs.positions.clone(), "wrap": vconfigs.wrap.clone()}

    def trace_run():
        walk["pos"], walk["wrap"], _ = tblock(params, walk["pos"], walk["wrap"], gen)

    ours_v = report_trace("phase 24", f"{TWIST_TRACE_NSTEPS}-step general-twist VMC block",
                          TWIST_TRACE_NSTEPS, traced(trace_run), step_s * TWIST_TRACE_NSTEPS)
    # the pieces of a step alone, and the largest condition number of the
    # orbital matrices along one sweep (float64 values, after every 8th move)
    vpos, vwrap = vconfigs.positions, vconfigs.wrap
    vstate = wf.recompute(params, vpos)
    vst = draw_streams(gen, 1, nelec, DIAMOND_NCONF, TSTEP, "cuda", torch.float32,
                       downselect=True)
    swept = sweep_plain(wf, configs.geometry, TSTEP, 1.0, params, vpos, vwrap, vstate,
                        vst["gauss"][0], vst["unif"][0])
    conds, _ = path_conds(wf, params, vpos, swept[0], stride=8)
    ecp = acc["energy"].ecp_acc
    pieces = {
        "vmc_sweep_ms": cuda_ms(lambda: sweep_plain(wf, configs.geometry, TSTEP, 1.0, params, vpos,
                                                    vwrap, vstate, vst["gauss"][0],
                                                    vst["unif"][0]), 1),
        "kinetic_ms": cuda_ms(lambda: kinetic_energy(wf, params, vstate, vpos), 3),
        "ecp_ms": cuda_ms(lambda: ecp(wf, params, vstate, vpos, vst["rot"][0], vst["u_sel"][0]),
                          3),
        "ewald_ms": cuda_ms(lambda: acc["energy"].coulomb.energy(vpos), 3),
        "recompute_ms": cuda_ms(lambda: wf.recompute(params, vpos), 3)}
    cmax = {k: float(torch.max(v)) for k, v in conds.items()}
    print(f"phase 24: pieces of a step alone (CUDA events, host work included), ms: "
          f"{json.dumps(pieces)}; the largest condition number of the orbital matrices along "
          f"one sweep {json.dumps(cmax)}; {card}", flush=True)
    t24 = time.perf_counter() - t24

    print(f"phase 25 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t25 = time.perf_counter()
    # phase 25: general-twist DMC with T-moves, from phase 24's walkers
    gen = torch.Generator(device="cuda").manual_seed(48)
    reset_counts()
    t0 = time.perf_counter()
    dblocks, dconfigs, dweights = rundmc(
        wf, params, copy_configs(vconfigs), nblocks=TWIST_DMC_NBLOCKS,
        nsteps_per_block=DMC_NSTEPS, tstep=DMC_TSTEP, energy_acc=acc["energy"], generator=gen,
        warmup_vmc_blocks=TWIST_DMC_WARMUP)
    torch.cuda.synchronize()
    t_dmc = time.perf_counter() - t0
    dlaunches = read_counts()
    for b in dblocks:
        print(f"phase 25 block {b['block']}: E/cell={b['energytotal'] / DIAMOND_NCELL:.6f} "
              f"ecp/cell={b['energyecp'] / DIAMOND_NCELL:.6f} w={b['weight']:.5f} "
              f"e_trial/cell={b['e_trial'] / DIAMOND_NCELL:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
    # per energy 2 K6 and 4 K3; per T-move sweep one K3 per electron; no sweep kernel
    nwarm = TWIST_DMC_WARMUP * 10
    dblock = {"gto_eval": (DMC_NSTEPS + 1) * per_step["gto_eval"],
              "value_mo": (DMC_NSTEPS + 1) * per_step["value_mo"] + DMC_NSTEPS * nelec}
    dexpect = {**none,
               "gto_eval": (nwarm + 1) * per_step["gto_eval"]
               + TWIST_DMC_NBLOCKS * dblock["gto_eval"],
               "value_mo": (nwarm + 1) * per_step["value_mo"]
               + TWIST_DMC_NBLOCKS * dblock["value_mo"]}
    check(dlaunches == dexpect,
          f"kernel launches of general-twist DMC: {dlaunches}, expected {dexpect}")
    e_dwarm_total = 2 * dblocks[0]["e_est"] - dblocks[0]["energytotal"]
    w_pred = predicted_weights(dblocks, e_dwarm_total, DMC_TSTEP, DMC_NSTEPS)
    for b, wp in zip(dblocks, w_pred):
        check(all(np.isfinite(v) for v in b.values()),
              f"non-finite value in general-twist DMC block {b}")
        check(0.5 < b["weight"] / wp < 2.0,
              f"general-twist block {b['block']} mean weight {b['weight']} not within a factor 2 "
              f"of the {wp} that its e_trial and energy predict")
        check(b["acceptance"] > 0.9, f"general-twist DMC acceptance {b['acceptance']} not above 0.9")
    check(bool(torch.all(torch.isfinite(dweights))) and bool(torch.all(dweights > 0)),
          "final general-twist weights are not finite and positive")
    d_cells = np.array([b["energytotal"] / DIAMOND_NCELL for b in dblocks[-TWIST_DMC_NLAST:]])
    e_d = float(np.mean(d_cells))
    sem_d = float(np.std(d_cells, ddof=1) / np.sqrt(len(d_cells)))
    e_dwarm = e_dwarm_total / DIAMOND_NCELL
    dref = TWIST_DMC_REF
    dwindow = max(5 * float(np.hypot(sem_d, dref["sem"])), 0.02)
    dstep_s = float(np.mean([b["block time"] for b in dblocks])) / DMC_NSTEPS
    print(f"phase 25: launches {dlaunches} ({json.dumps(dblock)} per block), E/cell(last "
          f"{TWIST_DMC_NLAST} blocks)={e_d:.6f} +- {sem_d:.6f} Ha, warm-up VMC E/cell="
          f"{e_dwarm:.6f} Ha, block weights {[round(b['weight'], 4) for b in dblocks]}, predicted "
          f"{[round(w, 4) for w in w_pred]}; JAX CPU reference {dref['e_cell']:.6f} +- "
          f"{dref['sem']:.6f} Ha (warm-up VMC {dref['e_vmc_cell']:.6f}, block weights "
          f"{[round(w, 4) for w in dref['weights']]}); window {dwindow:.6f} Ha; step "
          f"{dstep_s * 1e3:.1f} ms ({DIAMOND_NCONF / dstep_s:.1f} walker-steps/s), {t_dmc:.2f} s "
          f"for {TWIST_DMC_WARMUP} warm-up + {TWIST_DMC_NBLOCKS} DMC blocks; {card}", flush=True)
    check(abs(e_d - dref["e_cell"]) <= dwindow,
          f"general-twist DMC E/cell {e_d} off the JAX reference {dref['e_cell']} by more than "
          f"{dwindow}")
    check(e_d < e_dwarm + 0.02,
          f"general-twist DMC E/cell {e_d} above the warm-up VMC energy {e_dwarm} by more than "
          "0.02 Ha")
    t25 = time.perf_counter() - t25

    print(f"phase 26 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t26 = time.perf_counter()
    # phase 26: the two-twist average, the TRIM twist from phase 9's walkers
    # and the general one from phase 24's
    _, args = diamond_twist_average_setup(DIAMOND_NCONF, dtype=torch.float32)
    starts, marks = [gamma_configs, vconfigs], []

    def configs_factory(ti):
        marks.append(read_counts())
        return copy_configs(starts[ti])

    args["configs_factory"] = configs_factory
    gen = torch.Generator(device="cuda").manual_seed(49)
    reset_counts()
    t0 = time.perf_counter()
    records, avg = twist_average_vmc(**args, generator=gen, nblocks=TWIST_AVG_NBLOCKS,
                                     nsteps_per_block=DIAMOND_NSTEPS, tstep=TSTEP)
    torch.cuda.synchronize()
    t_avg = time.perf_counter() - t0
    marks.append(read_counts())
    check(len(records) == 2 and [r["real_mode"] for r in records] == [True, False],
          f"the union mesh gave twists {[(r['twist'], r['real_mode']) for r in records]}")
    alaunches = [{k: marks[i + 1][k] - marks[i][k] for k in counters} for i in range(2)]
    nstep = TWIST_AVG_NBLOCKS * DIAMOND_NSTEPS
    aexpect = [{**none, "pbc_sweep": nstep, **{k: nstep * v for k, v in per_step.items()}},
               {**none, **{k: nstep * v for k, v in per_step.items()}}]
    check(alaunches == aexpect,
          f"kernel launches per twist: {alaunches}, expected {aexpect} (K7 on the TRIM twist "
          "only)")
    warm = max(1, TWIST_AVG_NBLOCKS // 4)
    aref = TWIST_AVG_REF
    per_twist = []
    for r, ref in zip(records, aref["twists"]):
        e = np.array([b["energytotal"] / DIAMOND_NCELL for b in r["data"][warm:]])
        m, s = float(np.mean(e)), float(np.std(e, ddof=1) / np.sqrt(len(e)))
        window = max(5 * float(np.hypot(s, ref["sem"])), 0.02)
        per_twist.append({"twist": [round(float(x), 6) for x in r["twist"]],
                          "real_mode": r["real_mode"], "e_cell": m, "sem": s,
                          "reference": ref["e_cell"], "reference_sem": ref["sem"],
                          "window": window,
                          "acceptance": float(np.mean([b["acceptance"] for b in r["data"][warm:]])),
                          "block_time_s": [round(b["block time"], 4) for b in r["data"]]})
        check(all(np.isfinite(b["energytotal"]) for b in r["data"]),
              f"non-finite energies at twist {r['twist']}")
        check(abs(m - ref["e_cell"]) <= window,
              f"twist {r['twist']} E/cell {m} off its JAX reference {ref['e_cell']} by more than "
              f"{window}")
    e_avg = float(avg["energytotal"]) / DIAMOND_NCELL
    e_mean = float(np.mean([t["e_cell"] for t in per_twist]))
    check(abs(e_avg - e_mean) <= 1e-9 * abs(e_mean),
          f"the reported average {e_avg} is not the mean {e_mean} of the twists")
    print(f"phase 26: two twists, launches {json.dumps(alaunches)}; per twist "
          f"{json.dumps(per_twist)}; average E/cell {e_avg:.6f} Ha (JAX CPU reference "
          f"{aref['e_cell_average']:.6f} +- {aref['e_cell_average_sem']:.6f}); {t_avg:.2f} s for "
          f"{TWIST_AVG_NBLOCKS} blocks per twist; {card}", flush=True)
    t26 = time.perf_counter() - t26
    print(f"phases 23-26: {t23:.1f} + {t24:.1f} + {t25:.1f} + {t26:.1f} = "
          f"{t23 + t24 + t25 + t26:.1f} s", flush=True)
    return {"k64": k64, "k32": k32, "vmc": vlaunches, "dmc": dlaunches, "average": alaunches,
            "vmc_trace": ours_v}


# --- phases 27-30: the observables and the excited states --------------------------

def per_walker_close(label, k, p, tol):
    """k against p entry by entry, |k - p| <= tol (|p| + the walker's
    largest |p|); returns the largest |k - p| over the walker's largest |p|."""
    kp, pp = k.reshape(k.shape[0], -1), p.reshape(p.shape[0], -1)
    scale = torch.amax(torch.abs(pp), dim=1, keepdim=True)
    err = torch.abs(kp - pp)
    worst = float(torch.max(err / torch.clamp(scale, min=1e-30)))
    check(bool(torch.all(err <= tol * (torch.abs(pp) + scale))),
          f"{label}: largest error {worst:.3e} of the walker's largest entry")
    return worst


def k3_against_plain(phase, label, fn, counters, tol=OBS_K3_RTOL, per_walker=True):
    """fn() with K3 and inside plain_orbitals() on the same inputs: every
    output key held per walker (per_walker) or against the largest entry
    (close_rel). Returns ({key: the largest error over the walker's, or the
    whole output's, largest |entry|}, K3 launches of the kernel call)."""
    from pyqmc_tpu_torch.models.orbitals import plain_orbitals

    with plain_orbitals():
        p = fn()
    before = counters["value_mo"].n
    k = fn()
    n_k3 = counters["value_mo"].n - before
    check(n_k3 > 0, f"{phase} {label}: K3 was not launched")
    errs = {}
    for key in p:
        check(bool(torch.all(torch.isfinite(k[key]))), f"{phase} {label} {key}: not finite")
        name = f"{phase} {label} {key}, K3 against plain"
        if per_walker:
            errs[key] = per_walker_close(name, k[key], p[key], tol)
        else:
            scale = max(float(torch.max(torch.abs(p[key]))), 1e-30)
            errs[key] = close_rel(name, k[key], p[key], tol) / scale
    where = "the walker's" if per_walker else "all walkers'"
    print(f"{phase}: {label} with K3 ({n_k3} launches) against plain_orbitals() on the same "
          f"walkers and draws, largest error over {where} largest |entry|: "
          f"{json.dumps({k_: float(f'{v:.3e}') for k_, v in errs.items()})}", flush=True)
    return errs, n_k3


def windowed(label, x, sem, ref, floor):
    """x +- sem against ref = (mean, sem), entry by entry, within max(5 x
    combined SEM, floor); returns the largest distance in combined SEMs."""
    x, sem = np.atleast_1d(np.asarray(x, float)), np.atleast_1d(np.asarray(sem, float))
    rm, rs = np.atleast_1d(np.asarray(ref[0], float)), np.atleast_1d(np.asarray(ref[1], float))
    comb = np.hypot(sem, rs)
    window = np.maximum(5 * comb, floor)
    check(bool(np.all(np.abs(x - rm) <= window)),
          f"{label} {np.round(x, 6).tolist()} off the JAX CPU reference {np.round(rm, 6).tolist()} "
          f"by more than {np.round(window, 6).tolist()}")
    return float(np.max(np.abs(x - rm) / np.maximum(comb, 1e-12)))


def mean_sem(rows):
    """Mean over blocks and its standard error (rows: a list of arrays)."""
    a = np.asarray(rows, dtype=np.float64)
    return np.mean(a, axis=0), np.std(a, axis=0, ddof=1) / np.sqrt(len(a))


def observables_phases(t_start, card, counters, gamma_configs):
    """Phases 27-30: the observables of H2O in VMC and (the OBDM) in DMC,
    the periodic KOBDM, KTBDM and S(q) on the diamond, and the excited
    states of H2O (overlap sampling, ensemble optimization). gamma_configs:
    phase 9's final walkers. Returns the launch counts per phase."""
    from pyqmc_tpu_torch.configs import Configs
    from pyqmc_tpu_torch.entry import diamond_setup, h2o_excited_setup, h2o_setup
    from pyqmc_tpu_torch.method.dmc import rundmc
    from pyqmc_tpu_torch.method.ensemble import optimize_ensemble
    from pyqmc_tpu_torch.method.sample_many import make_overlap_block, sample_overlap
    from pyqmc_tpu_torch.method.vmc import vmc
    from pyqmc_tpu_torch.observables.ecp import rotations_from_quaternions
    from pyqmc_tpu_torch.observables.obdm import (KOBDMAccumulator, OBDMAccumulator,
                                                  normalize_obdm)
    from pyqmc_tpu_torch.observables.s2 import S2Accumulator
    from pyqmc_tpu_torch.observables.sq import SqAccumulator
    from pyqmc_tpu_torch.observables.symmetry import SymmetryAccumulator
    from pyqmc_tpu_torch.observables.tbdm import KTBDMAccumulator, TBDMAccumulator
    from pyqmc_tpu_torch.system.io import load_npz

    none = {k: 0 for k in counters}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.n for k, c in counters.items()}

    def draws_of(acc, nconf, seed):
        """One step's draws of an accumulator, from a generator of its own."""
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return {k: v[0] for k, v in acc.draw(gen, 1, nconf, "cuda", torch.float32).items()}

    out = {}
    print(f"phase 27 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t27 = time.perf_counter()
    # phase 27: the molecular observables in VMC, phase 3's wavefunction
    mol, wf, params, configs, acc = h2o_setup(NCONF, dtype=torch.float32)
    _, mf = load_npz()
    mo = mf.mo_coeff[0]
    accs = {"energy": acc["energy"], "obdm0": OBDMAccumulator(mol, mo, spin=0),
            "obdm1": OBDMAccumulator(mol, mo, spin=1),
            "tbdm01": TBDMAccumulator(mol, mo[:, :OBS_NCAS], spin=(0, 1)),
            "tbdm00": TBDMAccumulator(mol, mo[:, :OBS_NCAS], spin=(0, 0)),
            "s2": S2Accumulator(mol),
            "sym": SymmetryAccumulator(mol, list(OBS_SYM.values()), names=list(OBS_SYM))}
    nup, ndn = mol.nelec
    gen = torch.Generator(device="cuda").manual_seed(61)
    reset_counts()
    t0 = time.perf_counter()
    oblocks, oconfigs = vmc(wf, params, configs, nblocks=OBS_NBLOCKS, nsteps_per_block=OBS_NSTEPS,
                            tstep=TSTEP, accumulators=accs, generator=gen,
                            accumulate_every=OBS_EVERY)
    torch.cuda.synchronize()
    t_obs = time.perf_counter() - t0
    olaunches = read_counts()
    nacc = OBS_NBLOCKS * (-(-OBS_NSTEPS // OBS_EVERY))
    # K3 per accumulated step: each OBDM 3 (the orbitals at r' and at the
    # electrons, testvalue_many), each TBDM 3 + 2 per electron e1 (testvalue,
    # testvalue_many), S^2 2 per pair; the symmetry's recomputes take mode-1
    # orbitals, which K3 does not serve
    k3_step = 2 * 3 + (3 + 2 * nup) + (3 + 2 * nup) + 2 * nup * ndn
    oexpect = {**none, "vmc_sweep": OBS_NBLOCKS * OBS_NSTEPS, "ecp_energy": nacc,
               "value_mo": nacc * k3_step}
    check(olaunches == oexpect, f"phase 27 launches {olaunches}, expected {oexpect}")
    for b in oblocks:
        check(all(np.all(np.isfinite(v)) for k, v in b.items() if k != "block"),
              f"phase 27: non-finite averages in block {b['block']}")
        print(f"phase 27 block {b['block']}: E={b['energytotal']:.6f} acc={b['acceptance']:.4f} "
              f"S2={b['s2S2']:.6f} sym {json.dumps({k: round(b['sym' + k], 7) for k in OBS_SYM})} "
              f"obdm0 diag {np.round(np.diag(b['obdm0value'])[:OBS_NOCC], 4).tolist()} "
              f"host time {b['block time']:.3f} s", flush=True)
    kept = oblocks[OBS_NSKIP:]

    def tbdm_occ(t):
        return float(sum(t[i, j, i, j] for i in range(OBS_NOCC) for j in range(OBS_NOCC)))

    quantities = {
        "obdm0_diag": [np.diag(b["obdm0value"])[:OBS_NOCC] for b in kept],
        "obdm1_diag": [np.diag(b["obdm1value"])[:OBS_NOCC] for b in kept],
        "obdm0_trace": [np.trace(b["obdm0value"]) for b in kept],
        "obdm1_trace": [np.trace(b["obdm1value"]) for b in kept],
        "s2": [b["s2S2"] for b in kept], "tbdm01_occ": [tbdm_occ(b["tbdm01value"]) for b in kept]}
    obs27 = {}
    for name, rows in quantities.items():
        m, s = mean_sem(rows)
        d = windowed(f"phase 27 {name}", m, s, OBS_REF[name], 0.02)
        obs27[name] = {"mean": np.round(m, 6).tolist(), "sem": np.round(s, 6).tolist(),
                       "reference": OBS_REF[name][0], "reference_sem": OBS_REF[name][1],
                       "combined_sem_distance": round(d, 3)}
    sym_means = {k: float(np.mean([b["sym" + k] for b in kept])) for k in OBS_SYM}
    for k, v in sym_means.items():
        check(abs(v - 1.0) <= 1e-3, f"phase 27: symmetry {k} block mean {v} is not within 1e-3 of 1")
    print(f"phase 27: launches {olaunches} ({k3_step} K3 per accumulated step, {nacc} steps); "
          f"{t_obs:.2f} s for {OBS_NBLOCKS} x {OBS_NSTEPS} steps ({t_obs / nacc:.4f} s per "
          f"accumulated step and its sweep); observables against the JAX CPU reference: "
          f"{json.dumps(obs27)}; symmetry block means {json.dumps(sym_means)}; {card}", flush=True)
    # per walker, at the final walkers: the symmetry values, and each new K3
    # use against plain orbitals on one set of draws
    x = oconfigs.positions
    st = wf.recompute(params, x)
    sym = accs["sym"](wf, params, st, x)
    devs = {k: float(torch.max(torch.abs(v - 1.0))) for k, v in sym.items()}
    within = {k: float(torch.mean((torch.abs(v - 1.0) <= 1e-3).to(torch.float64)))
              for k, v in sym.items()}
    print(f"phase 27: symmetry per walker at the final walkers, largest |value - 1| "
          f"{json.dumps(devs)}, share within 1e-3 {json.dumps(within)}", flush=True)
    for k in OBS_SYM:
        check(within[k] >= 0.99, f"phase 27: only {within[k]} of the walkers have {k} within 1e-3 "
              "of 1")
    k3_27 = {}
    for i, name in enumerate(("obdm0", "obdm1", "tbdm01", "tbdm00")):
        d = draws_of(accs[name], x.shape[0], 300 + i)
        k3_27[name] = k3_against_plain("phase 27", name, lambda a=accs[name], d=d: a(
            wf, params, st, x, draws=d), counters)[0]
    k3_27["s2"] = k3_against_plain("phase 27", "s2", lambda: accs["s2"](wf, params, st, x),
                                   counters, per_walker=False)[0]
    pieces = {}
    for name in ("energy", "obdm0", "tbdm01", "s2", "sym"):
        kw = {"draws": draws_of(accs[name], x.shape[0], 310)} if hasattr(accs[name], "draw") else {}
        rot = torch.eye(3, device="cuda").expand(nup + ndn, x.shape[0], 3, 3)
        pieces[name] = round(cuda_ms(lambda a=accs[name], kw=kw: a(wf, params, st, x, rot, **kw),
                                     1), 3)
    print(f"phase 27: one accumulator call alone (CUDA events, host work included), ms: "
          f"{json.dumps(pieces)}; {card}", flush=True)
    out["27"] = olaunches
    t27 = time.perf_counter() - t27

    print(f"phase 28 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t28 = time.perf_counter()
    # phase 28: DMC with the mixed-estimator OBDM, from phase 27's walkers
    dacc = {"obdm0": accs["obdm0"], "obdm1": accs["obdm1"]}
    gen = torch.Generator(device="cuda").manual_seed(67)
    reset_counts()
    t0 = time.perf_counter()
    dblocks, _, _ = rundmc(wf, params, oconfigs, nblocks=OBS_DMC_NBLOCKS,
                           nsteps_per_block=DMC_NSTEPS, tstep=DMC_TSTEP, energy_acc=acc["energy"],
                           accumulators=dacc, generator=gen, warmup_vmc_blocks=OBS_DMC_WARMUP)
    torch.cuda.synchronize()
    t_dmc = time.perf_counter() - t0
    dlaunches = read_counts()
    per_block = {"dmc_sweep": DMC_NSTEPS, "tmove_sweep": DMC_NSTEPS,
                 "ecp_energy": DMC_NSTEPS + 1, "value_mo": DMC_NSTEPS * 2 * 3}
    warm = 10 * OBS_DMC_WARMUP
    dexpect = {**none, "vmc_sweep": warm, "ecp_energy": warm + 1 + OBS_DMC_NBLOCKS * 11,
               **{k: OBS_DMC_NBLOCKS * v for k, v in per_block.items() if k != "ecp_energy"}}
    check(dlaunches == dexpect, f"phase 28 launches {dlaunches}, expected {dexpect}")
    for b in dblocks:
        check(all(np.all(np.isfinite(v)) for k, v in b.items()),
              f"phase 28: non-finite averages in block {b['block']}")
        print(f"phase 28 block {b['block']}: E={b['energytotal']:.6f} w={b['weight']:.5f} "
              f"acc={b['acceptance']:.4f} obdm0 diag "
              f"{np.round(np.diag(b['obdm0value'])[:OBS_NOCC], 4).tolist()} obdm1 diag "
              f"{np.round(np.diag(b['obdm1value'])[:OBS_NOCC], 4).tolist()}", flush=True)
    e_dmc = float(np.mean([b["energytotal"] for b in dblocks[-OBS_DMC_NLAST:]]))
    check(-17.6 < e_dmc < -16.9, f"phase 28: DMC energy {e_dmc} outside phase 6's (-17.6, -16.9)")
    dmc_diag = {}
    for s in (0, 1):
        dd = np.mean([np.diag(b[f"obdm{s}value"])[:OBS_NOCC] for b in dblocks], axis=0)
        vd = np.asarray(obs27[f"obdm{s}_diag"]["mean"])
        check(bool(np.all(np.abs(dd - vd) <= 0.05)),
              f"phase 28: the mixed-estimator OBDM diagonal {dd} (spin {s}) off phase 27's {vd} "
              "by more than 0.05")
        dmc_diag[s] = np.round(dd, 5).tolist()
    print(f"phase 28: launches {dlaunches} (per block {json.dumps(per_block)}), E(last "
          f"{OBS_DMC_NLAST} blocks)={e_dmc:.6f} Ha, OBDM occupied diagonal per spin "
          f"{json.dumps(dmc_diag)} (VMC {obs27['obdm0_diag']['mean']}, "
          f"{obs27['obdm1_diag']['mean']}); {t_dmc:.2f} s; {card}", flush=True)
    out["28"] = dlaunches
    t28 = time.perf_counter() - t28

    print(f"phase 29 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t29 = time.perf_counter()
    # phase 29: the periodic observables on the diamond, from phase 9's walkers
    sup, pwf, pparams, _, pacc = diamond_setup(DIAMOND_NCONF, dtype=torch.float32)
    orb = pwf.wfs[0].orbitals
    sq = SqAccumulator(sup)
    paccs = {"energy": pacc["energy"], "kobdm0": KOBDMAccumulator(sup, orb, spin=0),
             "kobdm1": KOBDMAccumulator(sup, orb, spin=1), "sq": sq}
    start = Configs.create(gamma_configs.positions.clone(), gamma_configs.geometry,
                           wrap=gamma_configs.wrap.clone())
    gen = torch.Generator(device="cuda").manual_seed(71)
    reset_counts()
    t0 = time.perf_counter()
    qblocks, qconfigs = vmc(pwf, pparams, start, nblocks=PBC_OBS_NBLOCKS,
                            nsteps_per_block=DIAMOND_NSTEPS, tstep=TSTEP, accumulators=paccs,
                            generator=gen)
    torch.cuda.synchronize()
    t_pobs = time.perf_counter() - t0
    qlaunches = read_counts()
    nstep = PBC_OBS_NBLOCKS * DIAMOND_NSTEPS
    # per step: phase 9's sweep, K6 per kinetic chunk and K3 per ECP chunk
    # (1, 2 and 4 at 500 walkers), and 3 K3 for each KOBDM
    nelec, nsel = sum(sup.nelec), pacc["energy"].ecp_acc.nselect
    n_k6 = -(-nelec // max(1, 16384 // DIAMOND_NCONF))
    n_k3 = -(-nelec // max(1, 262144 // (DIAMOND_NCONF * nsel)))
    qexpect = {**none, "pbc_sweep": nstep, "gto_eval": n_k6 * nstep,
               "value_mo": (n_k3 + 2 * 3) * nstep}
    check(qlaunches == qexpect, f"phase 29 launches {qlaunches}, expected {qexpect}")
    rows = {s: [] for s in (0, 1)}
    qn = np.linalg.norm(sq.qlist, axis=1)
    outer = qn > qn.max() * (1 - 1e-9) - 1e-9
    sq_outer = []
    for b in qblocks:
        check(all(np.all(np.isfinite(v)) for k, v in b.items()),
              f"phase 29: non-finite averages in block {b['block']}")
        for s in (0, 1):
            rows[s].append(np.diag(normalize_obdm(b[f"kobdm{s}value_re"], b[f"kobdm{s}norm"])))
        sq_outer.append(float(np.mean(b["sqSq"][outer])))
        print(f"phase 29 block {b['block']}: E/cell={b['energytotal'] / DIAMOND_NCELL:.6f} "
              f"acc={b['acceptance']:.4f} S(q) outer shell {sq_outer[-1]:.4f} host time "
              f"{b['block time']:.3f} s", flush=True)
    kobdm29 = {}
    for s in (0, 1):
        m, se = mean_sem(rows[s])
        key = f"kobdm{s}_normalized_diag"
        d = windowed(f"phase 29 {key}", m, se, PBC_OBS_REF[key], 0.02)
        kobdm29[s] = {"min": round(float(m.min()), 6), "max": round(float(m.max()), 6),
                      "combined_sem_distance": round(d, 3)}
    m_outer = float(np.mean(sq_outer))
    check(abs(m_outer - 1.0) <= 0.1, f"phase 29: S(q) on the outermost shell {m_outer}, not 1")
    print(f"phase 29: launches {qlaunches}; normalized KOBDM diagonal per spin "
          f"{json.dumps(kobdm29)} (JAX CPU reference per orbital within max(5 x combined SEM, "
          f"0.02)); S(q) on the outermost q-shell ({int(outer.sum())} of {len(qn)} q) "
          f"{m_outer:.5f} (JAX {PBC_OBS_REF['sq_outer'][0]:.5f}); {t_pobs:.2f} s for "
          f"{PBC_OBS_NBLOCKS} x {DIAMOND_NSTEPS} steps; {card}", flush=True)
    x = qconfigs.positions
    st = pwf.recompute(pparams, x)
    k3_29 = {}
    for s in (0, 1):
        d = draws_of(paccs[f"kobdm{s}"], x.shape[0], 320 + s)
        k3_29[f"kobdm{s}"] = k3_against_plain("phase 29", f"kobdm{s}", lambda a=paccs[f"kobdm{s}"],
                                              d=d: a(pwf, pparams, st, x, draws=d), counters)[0]
    sq32 = sq(pwf, pparams, st, x)
    sq64 = SqAccumulator(sup)(pwf, pparams, st, x.to(torch.float64))
    sq_err = {k: close_rel(f"phase 29 {k} per walker, float32 against float64", sq32[k],
                           sq64[k].to(torch.float32), 1e-4) for k in sq32}
    ktbdm = KTBDMAccumulator(sup, orb, spin=(0, 1))
    xs = x[:KTBDM_NCONF]
    st_s = pwf.recompute(pparams, xs)
    d = draws_of(ktbdm, KTBDM_NCONF, 330)
    t0 = time.perf_counter()
    k3_29["ktbdm01"], n_kt = k3_against_plain("phase 29", f"ktbdm01 at {KTBDM_NCONF} walkers",
                                              lambda: ktbdm(pwf, pparams, st_s, xs, draws=d),
                                              counters)
    t_kt = time.perf_counter() - t0
    print(f"phase 29: S(q) and spinSq per walker, float32 against float64 on the same "
          f"positions: {json.dumps({k: float(f'{v:.3e}') for k, v in sq_err.items()})}; KTBDM "
          f"(spins 0, 1; output {KTBDM_NCONF} x 32^4) with K3 and plain {t_kt:.2f} s together",
          flush=True)
    out["29"] = qlaunches
    t29 = time.perf_counter() - t29

    print(f"phase 30 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t30 = time.perf_counter()
    # phase 30: the excited states of H2O
    xmol, wfs, plist, xconfigs, xacc, ens = h2o_excited_setup(NCONF, dtype=torch.float32)
    s2 = S2Accumulator(xmol)
    gen = torch.Generator(device="cuda").manual_seed(73)
    reset_counts()
    t0 = time.perf_counter()
    xdata, xcfg = sample_overlap(wfs, plist, xconfigs, gen, nblocks=EXC_NBLOCKS, nsteps=10,
                                 tstep=TSTEP, energy_acc=xacc["energy"], accumulators={"s2": s2})
    torch.cuda.synchronize()
    t_ovl = time.perf_counter() - t0
    xlaunches = read_counts()
    nstep = EXC_NBLOCKS * 10
    # per step: state 0's energy on K2; state 1's (outside K2's gate) the
    # flat ECP chain, one K3; S^2 of each state 2 K3 per pair; the sweep plain
    xexpect = {**none, "ecp_energy": nstep, "value_mo": nstep * (1 + 2 * 2 * nup * ndn)}
    check(xlaunches == xexpect, f"phase 30 sample_overlap launches {xlaunches}, expected {xexpect}")
    rows = []
    for dd in xdata:
        N = dd["overlap"]
        rows.append({"e0": dd["energy0_num"] / dd["energy0_den"],
                     "e1": dd["energy1_num"] / dd["energy1_den"],
                     "s2_0": dd["s20_S2_num"] / dd["state0_den"],
                     "s2_1": dd["s21_S2_num"] / dd["state1_den"],
                     "o01": float(abs(N[0, 1]) / np.sqrt(abs(N[0, 0] * N[1, 1]))),
                     "acceptance": dd["acceptance"]})
        check(all(np.isfinite(v) for v in rows[-1].values()),
              f"phase 30: non-finite overlap block {dd['block']}")
        print(f"phase 30 overlap block {dd['block']}: "
              + json.dumps({k: round(float(v), 6) for k, v in rows[-1].items()})
              + f" host time {dd['block time']:.3f} s", flush=True)
    kept = rows[EXC_NSKIP:]
    res = {}
    for k, floor in (("e0", 0.02), ("e1", 0.02), ("s2_0", 0.05), ("s2_1", 0.05)):
        m, se = mean_sem([r[k] for r in kept])
        d = windowed(f"phase 30 {k}", m, se, EXC_REF[k], floor)
        res[k] = {"mean": round(float(m), 6), "sem": round(float(se), 6),
                  "reference": EXC_REF[k][0], "reference_sem": EXC_REF[k][1],
                  "combined_sem_distance": round(d, 3)}
    o01 = float(np.mean([r["o01"] for r in kept]))
    check(o01 < 0.1, f"phase 30: normalized |O01| {o01} not below 0.1")
    check(res["e1"]["mean"] > res["e0"]["mean"] + 0.1,
          f"phase 30: E1 {res['e1']['mean']} not above E0 {res['e0']['mean']} + 0.1 Ha")
    check(abs(res["s2_0"]["mean"]) < 0.1, f"phase 30: state 0's S^2 {res['s2_0']['mean']} not 0")
    check(abs(res["s2_1"]["mean"] - 1.0) < 0.15, f"phase 30: state 1's S^2 {res['s2_1']['mean']}")
    print(f"phase 30: sample_overlap launches {xlaunches}; |O01| {o01:.5f} (JAX "
          f"{EXC_REF['o01'][0]:.5f}); {json.dumps(res)}; {t_ovl:.2f} s for {nstep} steps "
          f"({t_ovl / nstep:.4f} s per overlap step with both energies and S^2); {card}",
          flush=True)
    # per walker: state 1's S^2 and ECP energy with K3 against plain orbitals
    x = xcfg.positions
    sts = [w.recompute(p, x) for w, p in zip(wfs, plist)]
    k3_30 = {"s2_state1": k3_against_plain("phase 30", "state 1's S^2", lambda: s2(
        wfs[1], plist[1], sts[1], x), counters, per_walker=False)[0]}
    rot = rotations_from_quaternions(torch.randn((nup + ndn, x.shape[0], 4), generator=gen,
                                                 device="cuda"))
    k3_30["ecp_state1"] = per_walker_ecp("phase 30 state 1", wfs[1], plist[1], sts[1], x, rot,
                                         xacc["energy"].ecp_acc)[1]
    # the sweep alone and a traced step with the energies
    sweep_only = make_overlap_block(wfs, xcfg.geometry, TSTEP, 2)
    with_energy = make_overlap_block(wfs, xcfg.geometry, TSTEP, 2, energy_acc=xacc["energy"])
    walk = {"pos": x, "wrap": xcfg.wrap}

    def run_block(fn):
        walk["pos"], walk["wrap"], _ = fn(plist, walk["pos"], walk["wrap"], gen)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    run_block(sweep_only)
    t_sweep = (time.perf_counter() - t0) / 2
    t0 = time.perf_counter()
    run_block(with_energy)
    t_energy = (time.perf_counter() - t0) / 2
    report_trace("phase 30", "2-step overlap block with both energies", 2,
                 traced(lambda: run_block(with_energy)), 2 * t_energy)
    print(f"phase 30: overlap step alone: the two-state sweep {t_sweep:.4f} s, with both "
          f"energies {t_energy:.4f} s (plain sweep; predicted 0.2-0.4 s); {card}", flush=True)
    # optimize_ensemble: state 0 frozen, the superposition's det_coeff
    t1 = ens["transforms"][1]
    shares = []
    deserialize = t1.deserialize

    def recording(base, flat):
        new = deserialize(base, flat)
        c = new["wf0"]["det_coeff"].double().cpu().numpy()
        shares.append(float(abs(c[0]) / np.linalg.norm(c)))
        print(f"phase 30 ensemble iteration {len(shares) - 1}: det_coeff "
              f"{np.round(c, 6).tolist()}, ground share |c0|/|c| {shares[-1]:.5f}", flush=True)
        return new

    t1.deserialize = recording
    gen = torch.Generator(device="cuda").manual_seed(79)
    _, _, _, econfigs, _, _ = h2o_excited_setup(NCONF, dtype=torch.float32, seed=1)
    reset_counts()
    t0 = time.perf_counter()
    eparams, records = optimize_ensemble(**ens, configs=econfigs, energy_acc=xacc["energy"],
                                         generator=gen, max_iterations=ENS_ITERATIONS,
                                         penalty=ENS_PENALTY, tau=ENS_TAU, nblocks=ENS_NBLOCKS,
                                         nsteps=10, tstep=TSTEP)
    torch.cuda.synchronize()
    t_ens = time.perf_counter() - t0
    t1.deserialize = deserialize
    elaunches = read_counts()
    nstep = ENS_NBLOCKS * 10
    # per iteration: every overlap step's two energies (K2 for state 0, one
    # K3 for the superposition's flat ECP chain) and the gradient's energy
    eexpect = {**none, "ecp_energy": ENS_ITERATIONS * nstep,
               "value_mo": ENS_ITERATIONS * (nstep + 1)}
    check(elaunches == eexpect, f"phase 30 optimize_ensemble launches {elaunches}, expected "
          f"{eexpect}")
    traj = {"o01": [], "e1": []}
    for r in records:
        N = r["overlap"]
        traj["o01"].append(float(abs(N[0, 1]) / np.sqrt(abs(N[0, 0] * N[1, 1]))))
        traj["e1"].append(float(r["energy1"]))
    check(all(np.isfinite(v) for v in traj["e1"] + traj["o01"]), "phase 30: non-finite records")
    for it in range(ENS_ITERATIONS):
        for k, floor in (("o01", 0.05), ("e1", 0.05)):
            ref = EXC_REF[f"ens_{k}"]
            # one run of 2048 walkers scatters about as the mean of 4 of the
            # reference's 8 runs of 512 does: its standard error is taken as
            # sqrt(2) times the reference's
            windowed(f"phase 30 ensemble iteration {it} {k}", traj[k][it],
                     np.sqrt(2) * ref[1][it], (ref[0][it], ref[1][it]), floor)
    check(shares[-1] < ENS_FRAC0_BOUND,
          f"phase 30: the ground share {shares[-1]} not below {ENS_FRAC0_BOUND}")
    print(f"phase 30: optimize_ensemble launches {elaunches}; per iteration |O01| "
          f"{np.round(traj['o01'], 5).tolist()} (JAX {EXC_REF['ens_o01'][0]}), E1 "
          f"{np.round(traj['e1'], 5).tolist()} (JAX {EXC_REF['ens_e1'][0]}), ground share "
          f"{np.round(shares, 5).tolist()} (JAX after the last {EXC_REF['ens_frac0'][0]}; bound "
          f"{ENS_FRAC0_BOUND:.4f}); {t_ens:.2f} s, {t_ens / ENS_ITERATIONS:.3f} s per iteration "
          f"({ENS_NBLOCKS} x 10 overlap steps and a gradient); {card}", flush=True)
    out["30_overlap"], out["30_ensemble"] = xlaunches, elaunches
    t30 = time.perf_counter() - t30
    print(f"phases 27-30: {t27:.1f} + {t28:.1f} + {t29:.1f} + {t30:.1f} = "
          f"{t27 + t28 + t29 + t30:.1f} s", flush=True)
    out["k3_errors"] = {"27": k3_27, "29": k3_29, "30": k3_30}
    return out



def same_tree(a, b, rtol=1e-12):
    """The same nesting of lists and dicts, numbers within rtol."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k], rtol) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            same_tree(x, y, rtol) for x, y in zip(a, b))
    return bool(np.isclose(float(a), float(b), rtol=rtol, atol=0.0))


def determinant_set(exp):
    return {(tuple(int(o) for o in exp["occ_up"][u]), tuple(int(o) for o in exp["occ_dn"][d]))
            for u, d in zip(exp["map_up"], exp["map_dn"])}


def front_door_phases(t_start, card, counters):
    """Phases 31-33, the front door: the molecular front end on the host
    from a geometry string, the recipes on the card from its SCF, and the He
    and H anchors. Returns the launch counts of each run and phase 31's
    SCF of H2O."""
    from pyqmc_tpu_torch.api import (DMC, OPTIMIZE, VMC, Molecule, generate_wf, initial_guess,
                                     run_casci, run_scf)
    from pyqmc_tpu_torch.method.vmc import vmc
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.system import integrals
    from pyqmc_tpu_torch.system.ecp_integrals import ecp_matrix
    from pyqmc_tpu_torch.system.io import load_expansion_npz, load_npz

    none = {k: 0 for k in counters}
    out = {}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.n for k, c in counters.items()}

    def host(label, fn, seconds):
        t0 = time.perf_counter()
        r = fn()
        seconds[label] = round(time.perf_counter() - t0, 3)
        return r

    print(f"phase 31 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 31: the front end on the host, from the geometry string
    sec = {}
    mol = host("Molecule", lambda: Molecule(H2O_ATOM, basis="ccecp-ccpvdz", ecp="ccecp"), sec)
    ref_mol, ref_mf = load_npz()
    check(mol.nao == ref_mol.nao == 23 and mol.nelec == ref_mol.nelec == (4, 4),
          f"nao {mol.nao}, nelec {mol.nelec} against the checkpoint's {ref_mol.nao}, "
          f"{ref_mol.nelec}")
    check(np.array_equal(mol.atom_charges, ref_mol.atom_charges)
          and np.allclose(mol.atom_coords, ref_mol.atom_coords, rtol=0, atol=1e-12),
          "atom charges or coordinates differ from the checkpoint's")
    for a, b in zip(mol.shells, ref_mol.shells):
        check((a.atom, a.l, a.ao_offset) == (b.atom, b.l, b.ao_offset)
              and same_tree(list(a.exps), list(b.exps)) and same_tree(list(a.coeffs),
                                                                      list(b.coeffs)),
              f"shell {a} differs from the checkpoint's {b}")
    check(same_tree(mol.ecp, ref_mol.ecp), "the ccECP library differs from the checkpoint's ECP")
    cache = {}
    S, T = host("overlap and kinetic", lambda: integrals.overlap_kinetic(mol), sec)
    V = host("nuclear", lambda: integrals.nuclear(mol), sec)
    ERI = host("ERI", lambda: integrals.eri(mol), sec)
    host("ecp_matrix", lambda: ecp_matrix(mol), sec)
    cache.update(S=S, T=T, V=V, ERI=ERI)
    mf = host("run_scf (integrals cached, ecp_matrix rebuilt)",
              lambda: run_scf(mol, integrals_cache=cache), sec)
    check(mf.converged and abs(mf.e_tot - ref_mf.e_tot) <= FRONT_END_TOL,
          f"SCF e_tot {mf.e_tot} off the checkpoint's {ref_mf.e_tot} by more than "
          f"{FRONT_END_TOL}")
    check(abs(mf.e_tot - SCF_PINS["h2o_ccecp"]) <= 1e-8,
          f"SCF e_tot {mf.e_tot} off the JAX package's {SCF_PINS['h2o_ccecp']}")
    cas = load_expansion_npz()
    energies, roots = host("run_casci(8e, 8o)", lambda: run_casci(
        mf, cas["ncas"], cas["nelecas"], tol=cas["tol"]), sec)
    exp, coeff = roots[0]
    mine = determinant_set({"occ_up": exp.occ_up, "occ_dn": exp.occ_dn, "map_up": exp.map_up,
                            "map_dn": exp.map_dn})
    theirs = determinant_set(cas)
    check(abs(energies[0] - cas["e_casci"]) <= FRONT_END_TOL,
          f"E_CASCI {energies[0]} off the committed {cas['e_casci']} by more than "
          f"{FRONT_END_TOL}")
    check(mine == theirs, f"the CASCI determinant set differs from the committed one: "
          f"{len(mine ^ theirs)} determinants in one set only")
    # the coefficients' magnitudes (an MO's sign may differ from the checkpoint's)
    ref_c = {(tuple(cas["occ_up"][u]), tuple(cas["occ_dn"][d])): c
             for u, d, c in zip(cas["map_up"], cas["map_dn"], cas["det_coeff"])}
    dc = max(abs(abs(c) - abs(ref_c[(tuple(exp.occ_up[u]), tuple(exp.occ_dn[d]))]))
             for u, d, c in zip(exp.map_up, exp.map_dn, coeff))
    pins = {}
    for name, (atom, kw) in SCF_SYSTEMS.items():
        e = host(f"run_scf {name}", lambda: run_scf(Molecule(atom, **kw)).e_tot, sec)
        pins[name] = e
        check(abs(e - SCF_PINS[name]) <= FRONT_END_TOL,
              f"{name} SCF {e} off the JAX package's {SCF_PINS[name]} by more than "
              f"{FRONT_END_TOL}")
    print(f"phase 31: SCF e_tot {mf.e_tot:.9f} (checkpoint {ref_mf.e_tot:.9f}, "
          f"{abs(mf.e_tot - ref_mf.e_tot):.2e} away; the JAX package {SCF_PINS['h2o_ccecp']:.9f}); "
          f"E_CASCI {energies[0]:.9f} (committed {cas['e_casci']:.9f}, "
          f"{abs(energies[0] - cas['e_casci']):.2e} away), {len(coeff)} determinants, the "
          f"committed set, largest ||c| - |c_ref|| {dc:.2e}; SCF pins "
          f"{json.dumps({k: round(v, 9) for k, v in pins.items()})} (the JAX package's "
          f"{json.dumps(SCF_PINS)}); host seconds {json.dumps(sec)}", flush=True)
    out["phase31_seconds"] = sec

    print(f"phase 32 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 32: the recipes on the card from phase 31's SCF
    per_it, last = [], {"n": none}

    def per_iteration(record, info):
        now = read_counts()
        per_it.append({k: now[k] - last["n"][k] for k in now})
        last["n"] = now

    reset_counts()
    t0 = time.perf_counter()
    wf, params, records = OPTIMIZE(mol, mf=mf, nconfig=NCONF, max_iterations=RECIPE_OPT_ITERATIONS,
                                   seed=RECIPE_SEED, callback=per_iteration)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    for r, n in zip(records, per_it):
        print(f"phase 32 OPTIMIZE iteration {r['iteration']}: E={r['energy']:.6f} "
              f"+- {r['energy_err']:.6f} |g|={r['gnorm']:.4f} tau={r['tau']} launches "
              f"{json.dumps(n)}", flush=True)
        check(np.isfinite(r["energy"]) and np.isfinite(r["gnorm"]),
              f"non-finite OPTIMIZE record {r}")
    # per iteration 10 x 10 SR steps (K1, K2) and the correlated energies of
    # the reference and the 6 step lengths (K2); the first iteration also
    # holds OPTIMIZE's 4 x 10 equilibration steps (K1)
    for i, n in enumerate(per_it):
        want = {**none, "vmc_sweep": 100 + (OPT_EQUIL_BLOCKS * 10 if i == 0 else 0),
                "ecp_energy": 107}
        check(n == want, f"OPTIMIZE iteration {i} launched {n}, expected {want}")
    check(len(records) == RECIPE_OPT_ITERATIONS, f"{len(records)} OPTIMIZE records")
    out["phase32_optimize"] = read_counts()

    reset_counts()
    t0 = time.perf_counter()
    vblocks, vconfigs = VMC(mol, mf=mf, params=params, nconfig=NCONF, nblocks=RECIPE_VMC_NBLOCKS,
                            nsteps_per_block=RECIPE_VMC_NSTEPS, seed=RECIPE_SEED)
    torch.cuda.synchronize()
    t_vmc = time.perf_counter() - t0
    vl = read_counts()
    nv = RECIPE_VMC_NBLOCKS * RECIPE_VMC_NSTEPS
    check(vl == {**none, "vmc_sweep": nv, "ecp_energy": nv}, f"the VMC recipe launched {vl}")
    out["phase32_vmc"] = vl
    ev = np.array([b["energytotal"] for b in vblocks])
    check(bool(np.all(np.isfinite(ev))), f"non-finite VMC recipe energies {ev}")
    kept = ev[RECIPE_VMC_NSKIP:]
    e_vmc, sem_vmc = float(np.mean(kept)), float(np.std(kept, ddof=1) / np.sqrt(len(kept)))
    ref = RECIPE_REF
    window = max(5 * float(np.sqrt(sem_vmc**2 + ref["sem_vmc"]**2 + ref["spread_vmc"]**2)),
                 0.005)
    print(f"phase 32 VMC blocks {np.round(ev, 6).tolist()}, acceptance "
          f"{[round(b['acceptance'], 4) for b in vblocks]}", flush=True)
    print(f"phase 32: OPTIMIZE {RECIPE_OPT_ITERATIONS} iterations {t_opt:.2f} s, last E "
          f"{records[-1]['energy']:.6f}; VMC(params=) E(blocks after {RECIPE_VMC_NSKIP})="
          f"{e_vmc:.6f} +- {sem_vmc:.6f} Ha in {t_vmc:.2f} s; the JAX CPU reference "
          f"{ref['e_vmc']:.6f} +- {ref['sem_vmc']:.6f} (spread of its runs {ref['spread_vmc']:.6f}),"
          f" window {window:.6f} Ha, {abs(e_vmc - ref['e_vmc']) / window * 5:.2f} x the "
          f"combined SEM and spread away; launches {json.dumps(vl)}", flush=True)
    check(abs(e_vmc - ref["e_vmc"]) <= window,
          f"the VMC recipe's {e_vmc} off the JAX reference {ref['e_vmc']} by more than {window}")

    reset_counts()
    t0 = time.perf_counter()
    dblocks, dconfigs, weights = DMC(mol, mf=mf, params=params, nconfig=NCONF,
                                     nblocks=RECIPE_DMC_NBLOCKS, nsteps_per_block=DMC_NSTEPS,
                                     tstep=DMC_TSTEP, warmup_vmc_blocks=RECIPE_DMC_WARMUP,
                                     seed=RECIPE_SEED)
    torch.cuda.synchronize()
    t_dmc = time.perf_counter() - t0
    dl = read_counts()
    nwarm = RECIPE_DMC_WARMUP * 10
    dwant = {**none, "vmc_sweep": nwarm, "dmc_sweep": RECIPE_DMC_NBLOCKS * DMC_NSTEPS,
             "tmove_sweep": RECIPE_DMC_NBLOCKS * DMC_NSTEPS,
             "ecp_energy": nwarm + 1 + RECIPE_DMC_NBLOCKS * (DMC_NSTEPS + 1)}
    check(dl == dwant, f"the DMC recipe launched {dl}, expected {dwant}")
    out["phase32_dmc"] = dl
    for b in dblocks:
        check(all(np.isfinite(v) for v in b.values()), f"non-finite value in DMC block {b}")
        check(0.5 < b["weight"] < 2.0, f"block mean weight {b['weight']} outside (0.5, 2)")
        check(b["acceptance"] > 0.9, f"DMC acceptance {b['acceptance']} not above 0.9")
    check(bool(torch.all(torch.isfinite(weights))) and bool(torch.all(weights > 0)),
          "final DMC weights are not finite and positive")
    ed = np.array([b["energytotal"] for b in dblocks])
    e_dmc = float(np.mean(ed[-RECIPE_DMC_NLAST:]))
    e_warm = 2 * dblocks[0]["e_est"] - dblocks[0]["energytotal"]
    # one run's mean of 3 blocks: the spread of the reference's runs stands in
    # for its standard error
    dwindow = max(5 * float(np.hypot(ref["sem_dmc"], ref["spread_dmc"])), 0.02)
    print(f"phase 32: DMC(params=, tstep {DMC_TSTEP}) blocks {np.round(ed, 6).tolist()}, weights "
          f"{[round(b['weight'], 4) for b in dblocks]}; E(last {RECIPE_DMC_NLAST})={e_dmc:.6f} Ha "
          f"(the JAX CPU reference {ref['e_dmc']:.6f} +- {ref['sem_dmc']:.6f}, spread "
          f"{ref['spread_dmc']:.6f}; window {dwindow:.6f}), warm-up VMC {e_warm:.6f}, "
          f"{t_dmc:.2f} s; launches "
          f"{json.dumps(dl)}", flush=True)
    check(-17.6 < e_dmc < -16.9, f"DMC recipe energy {e_dmc} outside (-17.6, -16.9) Ha")
    check(abs(e_dmc - ref["e_dmc"]) <= dwindow,
          f"the DMC recipe's {e_dmc} off the JAX reference {ref['e_dmc']} by more than {dwindow}")
    check(e_dmc < e_warm + 0.05, f"DMC recipe energy {e_dmc} above its warm-up VMC {e_warm}")

    # the bare CASCI expansion of phase 31 through generate_wf(mc=), from the
    # VMC recipe's walkers
    cwf, cparams, _ = generate_wf(mol, mf, jastrow=False, mc=roots[0])
    cacc = {"energy": EnergyAccumulator(mol)}
    reset_counts()
    t0 = time.perf_counter()
    cblocks, _ = vmc(cwf, cparams, vconfigs, nblocks=CASCI_FD_NBLOCKS,
                     nsteps_per_block=CASCI_FD_NSTEPS, tstep=TSTEP, accumulators=cacc,
                     generator=torch.Generator(device=vconfigs.positions.device).manual_seed(
                         RECIPE_SEED + 5))
    torch.cuda.synchronize()
    t_cas = time.perf_counter() - t0
    cl = read_counts()
    # one K3 launch per energy (the plain ECP chain's flat ratio call)
    check(cl == {**none, "value_mo": CASCI_FD_NBLOCKS * CASCI_FD_NSTEPS},
          f"the CASCI VMC launched {cl}")
    out["phase32_casci_vmc"] = cl
    ec = np.array([b["energytotal"] for b in cblocks])
    check(bool(np.all(np.isfinite(ec))), f"non-finite CASCI VMC energies {ec}")
    kc = ec[CASCI_FD_NSKIP:]
    m_cas, sem_cas = float(np.mean(kc)), float(np.std(kc, ddof=1) / np.sqrt(len(kc)))
    print(f"phase 32: CASCI VMC (generate_wf(mc=run_casci root), jastrow=False) blocks "
          f"{np.round(ec, 6).tolist()}; E(blocks after {CASCI_FD_NSKIP})={m_cas:.6f} +- "
          f"{sem_cas:.6f} Ha against E_CASCI {energies[0]:.6f}, "
          f"{abs(m_cas - energies[0]) / max(sem_cas, 1e-3):.2f} x max(SEM, 1e-3) away; "
          f"{t_cas:.2f} s; launches {json.dumps(cl)}", flush=True)
    check(abs(m_cas - energies[0]) <= 5 * max(sem_cas, 1e-3),
          f"CASCI VMC energy {m_cas} +- {sem_cas} off E_CASCI {energies[0]} by more than "
          f"5 x max(SEM, 1e-3)")

    # README's quick start through the port's api: all-electron H2O/STO-3G
    reset_counts()
    t0 = time.perf_counter()
    qmol = Molecule(H2O_ATOM, basis="sto-3g")
    _, qparams, qrecords = OPTIMIZE(qmol, nconfig=1000, max_iterations=QUICK_OPT_ITERATIONS,
                                    vmc_blocks=QUICK_SR_BLOCKS)
    qblocks, _ = VMC(qmol, params=qparams, nconfig=2000, nblocks=QUICK_VMC_NBLOCKS)
    torch.cuda.synchronize()
    t_quick = time.perf_counter() - t0
    ql = read_counts()
    qwant = {**none, "vmc_sweep": OPT_EQUIL_BLOCKS * 10
             + QUICK_OPT_ITERATIONS * QUICK_SR_BLOCKS * 10 + QUICK_VMC_NBLOCKS * 10}
    check(ql == qwant, f"the quick start launched {ql}, expected {qwant}")
    out["phase32_quick_start"] = ql
    eq = np.array([b["energytotal"] for b in qblocks])
    e_quick = float(np.mean(eq[1:]))
    print(f"phase 32: quick start (H2O/STO-3G, OPTIMIZE nconfig 1000 x {QUICK_OPT_ITERATIONS} "
          f"iterations of {QUICK_SR_BLOCKS} x 10 SR steps, VMC nconfig 2000 x "
          f"{QUICK_VMC_NBLOCKS} x 10 steps): iterations "
          f"{[round(r['energy'], 6) for r in qrecords]}, VMC blocks {np.round(eq, 6).tolist()}, "
          f"E(blocks after the first)={e_quick:.6f} Ha against the SCF's "
          f"{SCF_PINS['h2o_sto3g']:.6f}; {t_quick:.2f} s with both SCFs; launches "
          f"{json.dumps(ql)}", flush=True)
    check(bool(np.all(np.isfinite(eq))) and e_quick < SCF_PINS["h2o_sto3g"],
          f"the quick start's VMC energy {e_quick} is not finite and below the SCF's")

    print(f"phase 33 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 33: the anchors. He/STO-3G Slater VMC equals its SCF energy
    he = Molecule("He 0 0 0", basis="sto-3g")
    he_mf = run_scf(he)
    hwf, hparams, _ = generate_wf(he, he_mf, jastrow=False)
    hconfigs = initial_guess(he, HE_NCONF, generator=torch.Generator().manual_seed(RECIPE_SEED))
    reset_counts()
    t0 = time.perf_counter()
    hblocks, _ = vmc(hwf, hparams, hconfigs, nblocks=HE_NBLOCKS, nsteps_per_block=HE_NSTEPS,
                     tstep=TSTEP, accumulators={"energy": EnergyAccumulator(he)},
                     generator=torch.Generator(device=hconfigs.positions.device).manual_seed(
                         RECIPE_SEED + 6))
    torch.cuda.synchronize()
    t_he = time.perf_counter() - t0
    hl = read_counts()
    check(hl == {**none, "vmc_sweep": HE_NBLOCKS * HE_NSTEPS}, f"the He VMC launched {hl}")
    out["phase33_he_vmc"] = hl
    eh = np.array([b["energytotal"] for b in hblocks])[HE_NSKIP:]
    m_he, sem_he = float(np.mean(eh)), float(np.std(eh, ddof=1) / np.sqrt(len(eh)))
    print(f"phase 33: He/STO-3G Slater VMC ({HE_NCONF} walkers, {HE_NBLOCKS} x {HE_NSTEPS} steps,"
          f" the first {HE_NSKIP} blocks dropped) E={m_he:.6f} +- {sem_he:.6f} Ha against its "
          f"SCF {he_mf.e_tot:.6f}, {abs(m_he - he_mf.e_tot) / sem_he:.2f} SEM away; {t_he:.2f} s; "
          f"launches {json.dumps(hl)}", flush=True)
    check(abs(m_he - he_mf.e_tot) <= 5 * sem_he,
          f"He VMC {m_he} +- {sem_he} off its SCF {he_mf.e_tot} by more than 5 SEM")

    # DMC of the H atom (an empty down-spin channel: the plain sweeps)
    reset_counts()
    t0 = time.perf_counter()
    hd, _, hw = DMC(Molecule("H 0 0 0", basis="ccpvdz", spin=1), nconfig=H_NCONF,
                    nblocks=H_NBLOCKS, nsteps_per_block=DMC_NSTEPS,
                    warmup_vmc_blocks=H_DMC_WARMUP, seed=RECIPE_SEED)
    torch.cuda.synchronize()
    t_h = time.perf_counter() - t0
    hdl = read_counts()
    check(hdl == none, f"the H-atom DMC launched {hdl}: its empty spin channel must run plain")
    out["phase33_h_dmc"] = hdl
    eH = np.array([b["energytotal"] for b in hd])
    check(bool(np.all(np.isfinite(eH))) and bool(torch.all(torch.isfinite(hw))),
          "non-finite H-atom DMC energies or weights")
    kH = eH[H_NSKIP:]
    m_h, sem_h = float(np.mean(kH)), float(np.std(kH, ddof=1) / np.sqrt(len(kH)))
    print(f"phase 33: H-atom DMC ({H_NCONF} walkers, {H_DMC_WARMUP} warm-up + {H_NBLOCKS} x "
          f"{DMC_NSTEPS} steps at tstep {DMC_TSTEP}, the first {H_NSKIP} blocks dropped) "
          f"E={m_h:.6f} +- {sem_h:.6f} Ha, {abs(m_h + 0.5) / sem_h:.2f} SEM from -0.5; weights "
          f"{[round(b['weight'], 4) for b in hd]}; {t_h:.2f} s; launches {json.dumps(hdl)}",
          flush=True)
    check(abs(m_h + 0.5) <= 5 * sem_h, f"H-atom DMC {m_h} +- {sem_h} off -0.5 by more than 5 SEM")
    print(f"phases 31-33 end at {time.perf_counter() - t_start:.1f} s", flush=True)
    return out, mf


def trace_kernels(logdir):
    """{kernel: device launches} of the port's kernels in the Chrome trace
    that utils/profiling.trace wrote under logdir (its one file); K1 and K4
    are the two modes of pq::sweep_kernel<T, NMAX, G, DMC>."""
    import glob
    import os

    files = glob.glob(os.path.join(logdir, "*.json"))
    check(len(files) == 1, f"profile_dir {logdir} holds {files}, not one trace")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") != "kernel" or "pq::" not in name:
            continue
        head = name.split("pq::")[1].split("(")[0]
        if head.startswith("sweep_kernel<"):
            key = "dmc_sweep" if head.rstrip(">").endswith("true") else "vmc_sweep"
        else:
            key = head.split("<")[0].replace("_kernel", "")
        out[key] = out.get(key, 0) + 1
    return out


def restart_phases(t_start, card, counters):
    """Phase 34: the traces of vmc and rundmc (profile_dir=) and the restart of DMC
    and of the line minimization from checkpoint contents held in a dict
    (checkpoint=, the contents that hdf_file= reads back; this machine has
    no h5py), on H2O at 2048 walkers, float32. Returns the launch counts."""
    import tempfile

    from pyqmc_tpu_torch.configs import Configs
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.dmc import make_dmc_block, rundmc
    from pyqmc_tpu_torch.method.linemin import line_minimization
    from pyqmc_tpu_torch.method.vmc import fold_generator, vmc
    from pyqmc_tpu_torch.observables.transform import LinearTransform
    from pyqmc_tpu_torch.system.io import load_npz
    from pyqmc_tpu_torch.wftools import generate_wf

    none = {k: 0 for k in counters}
    out = {}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.n for k, c in counters.items()}

    print(f"phase 34 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t_phase = time.perf_counter()
    mol, wf, params, configs, acc = h2o_setup(NCONF)
    energy = acc["energy"]
    n = TRACE_NSTEPS
    # (a) one traced block of vmc and of rundmc
    with tempfile.TemporaryDirectory() as vdir, tempfile.TemporaryDirectory() as ddir:
        reset_counts()
        t0 = time.perf_counter()
        _, vcfg = vmc(wf, params, configs, nblocks=1, nsteps_per_block=n, accumulators=acc,
                      generator=torch.Generator(device="cuda").manual_seed(71), profile_dir=vdir)
        torch.cuda.synchronize()
        t_vt = time.perf_counter() - t0
        vl = read_counts()
        vt = trace_kernels(vdir)
        reset_counts()
        t0 = time.perf_counter()
        _, dcfg, _ = rundmc(wf, params, vcfg, nblocks=1, nsteps_per_block=n, tstep=DMC_TSTEP,
                            energy_acc=energy, warmup_vmc_blocks=1, profile_dir=ddir,
                            generator=torch.Generator(device="cuda").manual_seed(73))
        torch.cuda.synchronize()
        t_dt = time.perf_counter() - t0
        dl = read_counts()
        dt = trace_kernels(ddir)
    vexp = {"vmc_sweep": n, "ecp_energy": n}
    check(vl == {**none, **vexp}, f"phase 34: the traced VMC block launched {vl}")
    check(vt == vexp, f"phase 34: the VMC trace names {vt}, not the block's launches {vexp}")
    dexp = {"dmc_sweep": n, "tmove_sweep": n, "ecp_energy": n + 1}
    check(dl == {**none, "vmc_sweep": 10, "ecp_energy": 10 + 1 + n + 1,
                 "dmc_sweep": n, "tmove_sweep": n},
          f"phase 34: the traced DMC run launched {dl}")
    check(dt == dexp, f"phase 34: the DMC trace names {dt}, not its first block's {dexp}")
    out["phase34_trace"] = {k: vl[k] + dl[k] for k in counters}
    print(f"phase 34: profile_dir traces name the kernels: VMC block {json.dumps(vt)} "
          f"({t_vt:.2f} s with the trace), DMC's first block {json.dumps(dt)} ({t_dt:.2f} s with "
          f"the warm-up block and the trace)", flush=True)

    # (b) DMC, then resumed from the checkpoint contents of its last block
    kw = dict(nsteps_per_block=DMC_NSTEPS, tstep=DMC_TSTEP, energy_acc=energy)
    seed = 79
    ckpt = {}
    reset_counts()
    t0 = time.perf_counter()
    d1, _, w1 = rundmc(wf, params, dcfg, nblocks=RESTART_DMC_NBLOCKS,
                       warmup_vmc_blocks=RESTART_DMC_WARMUP, checkpoint=ckpt,
                       generator=torch.Generator(device="cuda").manual_seed(seed), **kw)
    l1 = read_counts()
    saved = dict(ckpt)
    check(saved["block"] == RESTART_DMC_NBLOCKS - 1 and torch.equal(saved["weights"], w1),
          f"phase 34: the checkpoint holds block {saved['block']} and other weights")
    reset_counts()
    d2, _, w2 = rundmc(wf, params, dcfg, nblocks=RESTART_DMC_NBLOCKS, checkpoint=ckpt,
                       generator=torch.Generator(device="cuda").manual_seed(seed), **kw)
    torch.cuda.synchronize()
    t_dmc = time.perf_counter() - t0
    l2 = read_counts()
    per_block = {"dmc_sweep": DMC_NSTEPS, "tmove_sweep": DMC_NSTEPS, "ecp_energy": DMC_NSTEPS + 1}
    nb, nw = RESTART_DMC_NBLOCKS, RESTART_DMC_WARMUP * 10
    check(l1 == {**none, "vmc_sweep": nw, **{k: nb * v for k, v in per_block.items()},
                 "ecp_energy": nw + 1 + nb * per_block["ecp_energy"]},
          f"phase 34: the first DMC run launched {l1}")
    check(l2 == {**none, **{k: nb * v for k, v in per_block.items()}},
          f"phase 34: the resumed DMC run launched {l2} (no warm-up)")
    out["phase34_dmc_resumed"] = l2
    blocks = [b["block"] for b in d2]
    check(blocks == list(range(nb, 2 * nb)), f"phase 34: the resumed DMC ran blocks {blocks}")
    # the window starts from the saved e_est, and e_trial follows it
    b0 = d2[0]
    e_est = 0.5 * (float(saved["e_est"]) + b0["energytotal"])
    check(abs(b0["e_est"] - e_est) < 1e-4 and abs(b0["e_trial"] - (e_est - np.log(b0["weight"])))
          < 1e-4, f"phase 34: the resumed e_est {b0['e_est']}, e_trial {b0['e_trial']} do not "
          f"continue the saved e_est {float(saved['e_est'])}")
    # the first resumed block is the block of the saved walkers, weights, e_trial, e_est and
    # esigma on the generator folded at the first block
    block, _ = make_dmc_block(wf, energy, dcfg.geometry, DMC_TSTEP, DMC_NSTEPS)
    _, _, _, avg = block(params, saved["configs"].positions.clone(), saved["configs"].wrap.clone(),
                         saved["weights"].clone(),
                         fold_generator(torch.Generator(device="cuda").manual_seed(seed), nb),
                         saved["e_trial"], saved["e_est"], saved["esigma"])
    by_hand = {k: float(avg[k]) for k in ("energytotal", "weight", "acceptance")}
    apart = max(abs(b0[k] - v) / abs(v) for k, v in by_hand.items())
    check(apart <= 1e-5, f"phase 34: the resumed first block {b0} is not the block of the saved "
          f"contents {by_hand} ({apart} relative)")
    for b in d1 + d2:
        check(all(np.isfinite(v) for v in b.values()) and -17.6 < b["energytotal"] < -16.9,
              f"phase 34: DMC block {b['block']} energy {b['energytotal']} outside phase 6's "
              "(-17.6, -16.9) Ha or not finite")
    check(bool(torch.all(torch.isfinite(w2))) and bool(torch.all(w2 > 0)),
          "phase 34: non-finite or non-positive weights after the resumed DMC")
    print(f"phase 34: DMC {RESTART_DMC_WARMUP} warm-up + blocks {[b['block'] for b in d1]} "
          f"E={[round(b['energytotal'], 6) for b in d1]} e_trial="
          f"{[round(b['e_trial'], 6) for b in d1]}, resumed from its checkpoint contents: blocks "
          f"{blocks} E={[round(b['energytotal'], 6) for b in d2]} e_trial="
          f"{[round(b['e_trial'], 6) for b in d2]} w={[round(b['weight'], 5) for b in d2]}; the "
          f"first resumed block against the block of the saved contents {apart:.2e} relative; "
          f"launches {json.dumps(l1)} then {json.dumps(l2)}; {t_dmc:.2f} s", flush=True)

    # (c) line minimization: 2 iterations, resumed to 4, against 4 uninterrupted
    lmol, lmf = load_npz()
    lwf, lp0, to_opt = generate_wf(lmol, lmf)
    lt = LinearTransform(lp0, to_opt)
    lkw = dict(vmc_blocks=RESTART_OPT_SR_BLOCKS, vmc_steps_per_block=10)
    starts = {"split": [], "full": []}

    def run(tag, iterations, ck):
        return line_minimization(lwf, lp0, vcfg, lt, energy, max_iterations=iterations,
                                 generator=torch.Generator(device="cuda").manual_seed(83),
                                 checkpoint=ck, callback=lambda rec, info: starts[tag].append(
                                     lt.serialize(info["params0"]).double().cpu().numpy()), **lkw)

    ck, ckf = {}, {}
    reset_counts()
    t0 = time.perf_counter()
    _, _, r1 = run("split", RESTART_OPT_SPLIT, ck)
    p2, _, r2 = run("split", RESTART_OPT_ITERATIONS, ck)
    torch.cuda.synchronize()
    t_split = time.perf_counter() - t0
    ll = read_counts()
    pf, _, rf = run("full", RESTART_OPT_ITERATIONS, ckf)
    per_it = {"vmc_sweep": RESTART_OPT_SR_BLOCKS * 10, "ecp_energy": RESTART_OPT_SR_BLOCKS * 10 + 7}
    check(ll == {**none, **{k: RESTART_OPT_ITERATIONS * v for k, v in per_it.items()}},
          f"phase 34: the split line minimization launched {ll}")
    out["phase34_linemin_split"] = ll
    its = [r["iteration"] for r in r2]
    check(its == list(range(RESTART_OPT_SPLIT, RESTART_OPT_ITERATIONS)),
          f"phase 34: the resumed line minimization ran iterations {its}")
    xs = starts["split"] + [lt.serialize(p2).double().cpu().numpy()]
    xf = starts["full"] + [lt.serialize(pf).double().cpu().numpy()]
    x_rel = max(float(np.max(np.abs(a - b)) / np.max(np.abs(b))) for a, b in zip(xs, xf)
                if np.max(np.abs(b)) > 0)
    e_split = [r["energy"] for r in r1 + r2]
    e_full = [r["energy"] for r in rf]
    e_rel = float(np.max(np.abs(np.subtract(e_split, e_full)) / np.abs(e_full)))
    print(f"phase 34: line minimization {RESTART_OPT_SPLIT} iterations, resumed to "
          f"{RESTART_OPT_ITERATIONS} (iterations {its}), against {RESTART_OPT_ITERATIONS} "
          f"uninterrupted: energies {[round(e, 6) for e in e_split]} and "
          f"{[round(e, 6) for e in e_full]}, taus {[r['tau'] for r in r1 + r2]} and "
          f"{[r['tau'] for r in rf]}; parameter vectors {x_rel:.2e}, energies {e_rel:.2e} relative "
          f"apart; {t_split:.2f} s for the split run", flush=True)
    check(x_rel <= RESTART_RTOL and e_rel <= RESTART_RTOL,
          f"phase 34: the resumed line minimization left the uninterrupted one's trajectory "
          f"(parameters {x_rel}, energies {e_rel} relative)")
    t34 = time.perf_counter() - t_phase
    print(f"phase 34: {t34:.1f} s; {card}", flush=True)
    out["phase34_seconds"] = t34
    return out


def complex_opt_phase(t_start, card, counters, mf):
    """Phase 35: the complex-orbital optimization of H2O from phase 31's
    SCF (the JAX package's test_complex_linemin set-up at 2048 walkers,
    float32: complex64 orbitals over K3's [Re | Im] columns, the plain
    complex sweep), then its VMC, against tools/complex_opt_jax_reference.py.
    Returns the launch counts."""
    from pyqmc_tpu_torch.configs import initial_guess
    from pyqmc_tpu_torch.method import linemin
    from pyqmc_tpu_torch.method.vmc import vmc
    from pyqmc_tpu_torch.models.jastrow import JastrowSpin
    from pyqmc_tpu_torch.models.multiply import MultiplyWF
    from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.observables.transform import LinearTransform

    none = {k: 0 for k in counters}
    out = {}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.n for k, c in counters.items()}

    print(f"phase 35 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t_phase = time.perf_counter()
    mol = mf.mol
    nup, ndn = mol.nelec
    rng = np.random.default_rng(7)
    ca = np.asarray(mf.mo_coeff[0])[:, :nup] * 1j
    cb = np.asarray(mf.mo_coeff[1])[:, :ndn] * 1j
    ca = ca + (rng.random(ca.shape) - 0.5) * 0.2
    cb = cb + (rng.random(cb.shape) - 0.5) * 0.2
    wf = MultiplyWF(Slater(mol, None, DeterminantExpansion.single(nup, ndn), (ca, cb)),
                    JastrowSpin(mol))
    params0 = wf.make_params()
    check(params0["wf0"]["mo_coeff_alpha"].dtype == torch.complex64,
          f"phase 35: mo_coeff is {params0['wf0']['mo_coeff_alpha'].dtype}, not complex64")
    to_opt = {"wf0": {"det_coeff": False, "mo_coeff_alpha": np.ones(ca.shape, dtype=bool),
                      "mo_coeff_beta": np.ones(cb.shape, dtype=bool)},
              "wf1": {"acoeff": True, "bcoeff": True}}
    lt = LinearTransform(params0, to_opt)
    check(lt.nimag > 0, "phase 35: the transform has no imaginary direction")
    energy = EnergyAccumulator(mol)
    configs = initial_guess(mol, NCONF, generator=torch.Generator().manual_seed(COMPLEX_SEED))
    gen = torch.Generator(device="cuda").manual_seed(COMPLEX_SEED + 1)
    infos = []
    reset_counts()
    t0 = time.perf_counter()
    params, oconfigs, records = linemin.line_minimization(
        wf, params0, configs, lt, energy, generator=gen, max_iterations=COMPLEX_ITERATIONS,
        vmc_blocks=COMPLEX_SR_BLOCKS, vmc_steps_per_block=10,
        callback=lambda rec, info: infos.append(info))
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    ol = read_counts()
    nsr = COMPLEX_SR_BLOCKS * 10
    # one K3 launch per energy (the ECP's ratios on the complex orbitals): each SR
    # step, and the line search's reference and 6 candidates
    check(ol == {**none, "value_mo": COMPLEX_ITERATIONS * (nsr + 7)},
          f"phase 35: the complex optimization launched {ol}")
    out["phase35_opt"] = ol
    for rec, info in zip(records, infos):
        sec = info["seconds"]
        print(f"phase 35 iteration {rec['iteration']}: E={rec['energy']:.6f} +- "
              f"{rec['energy_err']:.6f} |g|={rec['gnorm']:.4f} tau={rec['tau']} line energies "
              f"{[round(float(e), 5) for e in rec['line_energies']]}; wall s: SR VMC "
              f"{sec['vmc']:.3f}, solve {sec['solve']:.4f}, correlated sampling "
              f"{sec['correlated']:.3f}", flush=True)
        check(all(bool(np.all(np.isfinite(rec[k])))
                  for k in ("energy", "energy_err", "gnorm", "line_energies")),
              f"phase 35: non-finite optimization record {rec}")
    first, last = records[0], records[-1]
    drop_bound = 3 * (first["energy_err"] + last["energy_err"])
    check(last["energy"] < first["energy"] - drop_bound,
          f"phase 35: the last iteration's energy {last['energy']} is not below the first's "
          f"{first['energy']} by more than {drop_bound}")
    check(all(params["wf0"][k].is_complex() for k in ("mo_coeff_alpha", "mo_coeff_beta")),
          "phase 35: the optimized orbital coefficients are not complex")
    check(all(bool(torch.all(torch.isfinite(t))) for g in params.values() for t in g.values()),
          "phase 35: non-finite optimized parameters")
    reset_counts()
    t0 = time.perf_counter()
    vblocks, vconfigs = vmc(wf, params, oconfigs, nblocks=COMPLEX_VMC_NBLOCKS,
                            nsteps_per_block=COMPLEX_VMC_NSTEPS, tstep=TSTEP,
                            accumulators={"energy": energy}, generator=gen)
    torch.cuda.synchronize()
    t_vmc = time.perf_counter() - t0
    vl = read_counts()
    check(vl == {**none, "value_mo": COMPLEX_VMC_NBLOCKS * COMPLEX_VMC_NSTEPS},
          f"phase 35: the complex VMC launched {vl}")
    out["phase35_vmc"] = vl
    ev = np.array([b["energytotal"] for b in vblocks])
    check(bool(np.all(np.isfinite(ev))), f"phase 35: non-finite VMC energies {ev}")
    kept = ev[COMPLEX_VMC_NSKIP:]
    m_v, sem_v = float(np.mean(kept)), float(np.std(kept, ddof=1) / np.sqrt(len(kept)))
    ref = COMPLEX_REF
    window = 5 * float(np.sqrt(sem_v**2 + ref["sem_vmc"]**2 + ref["spread_vmc"]**2))
    # float32 against float64 SR averages on the optimized parameters and the VMC's walkers
    rot, _ = linemin.draw_ecp_streams(gen, nup + ndn, NCONF, "cuda", torch.float32)
    prec = sr_precision(wf, params, lt, energy, vconfigs.positions, rot)
    t35 = time.perf_counter() - t_phase
    print(f"phase 35: complex-orbital optimization ({lt.nparams} parameters, {lt.nimag} "
          f"imaginary directions), {COMPLEX_ITERATIONS} iterations of {COMPLEX_SR_BLOCKS} x 10 SR "
          f"steps in {t_opt:.2f} s ({t_opt / COMPLEX_ITERATIONS:.3f} s each): E "
          f"{first['energy']:.6f} -> {last['energy']:.6f} Ha (JAX {ref['e_first']:.6f} -> "
          f"{ref['e_last']:.6f}); VMC blocks {np.round(ev, 6).tolist()}, E(blocks after the "
          f"first)={m_v:.6f} +- {sem_v:.6f} Ha against the JAX CPU reference {ref['e_vmc']:.6f} "
          f"+- {ref['sem_vmc']:.6f} (spread {ref['spread_vmc']:.6f}), window {window:.6f}, "
          f"{t_vmc:.2f} s; launches {json.dumps(ol)}, {json.dumps(vl)}; one step's SR averages, "
          f"float32 against float64 on the same walkers: {json.dumps(prec)}; phase 35 "
          f"{t35:.1f} s; {card}", flush=True)
    check(abs(m_v - ref["e_vmc"]) <= window,
          f"phase 35: the complex VMC energy {m_v} off the JAX reference {ref['e_vmc']} by more "
          f"than {window}")
    out["phase35_seconds"] = t35
    return out


def kernel_counters():
    """{kernel: its wrapper's launch counter}."""
    from pyqmc_tpu_torch.ops import ecp_energy, gto_kernels, move_sweep, move_sweep_pbc
    from pyqmc_tpu_torch.ops import tmove_sweep

    return {"vmc_sweep": move_sweep.LAUNCHES, "ecp_energy": ecp_energy.LAUNCHES,
            "dmc_sweep": move_sweep.DMC_LAUNCHES, "tmove_sweep": tmove_sweep.LAUNCHES,
            "value_mo": gto_kernels.VALUE_MO_LAUNCHES,
            "gto_eval": gto_kernels.EVAL_GTO2_LAUNCHES, "pbc_sweep": move_sweep_pbc.LAUNCHES,
            "pbc_dmc_sweep": move_sweep_pbc.DMC_LAUNCHES}


def mesh_runs(mesh, counters, nconf):
    """Phase 36 (b)-(c)'s runs on H2O, `nconf` walkers in all, under `mesh`
    (each rank its share) or without one: VMC MESH_VMC_NBLOCKS x 10,
    rundmc MESH_DMC_WARMUP + MESH_DMC_NBLOCKS x 10 from its walkers, one
    line_minimization iteration of MESH_SR_BLOCKS x 10 SR steps in the
    walkers' float32 and one in float64 (the SR solve carries the float32
    averages' reduction-order differences through S + 1e-3: about 2e-3 of
    the parameters on the H100, so (c)'s gate reads the float64 one).
    Returns the whole population's results on the host, each run's
    launches and seconds."""
    from pyqmc_tpu_torch.configs import Configs
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.dmc import rundmc
    from pyqmc_tpu_torch.method.linemin import line_minimization
    from pyqmc_tpu_torch.method.vmc import vmc
    from pyqmc_tpu_torch.observables.transform import LinearTransform
    from pyqmc_tpu_torch.system.io import load_npz
    from pyqmc_tpu_torch.utils.profiling import sync
    from pyqmc_tpu_torch.wftools import generate_wf

    device = None if mesh is None else mesh.device  # None: the entry points' default, the GPU
    out = {}

    def gen(seed):
        return torch.Generator(device=configs.positions.device).manual_seed(seed)

    def counted(name, run):
        for c in counters.values():
            c.reset()
        sync()
        t0 = time.perf_counter()
        res = run()
        sync()
        out[name + "_seconds"] = time.perf_counter() - t0
        out[name + "_launches"] = {k: c.n for k, c in counters.items()}
        return res

    mol, wf, params, configs, acc = h2o_setup(nconf, device=device)
    data, vcfg = counted("vmc", lambda: vmc(
        wf, params, configs, nblocks=MESH_VMC_NBLOCKS, nsteps_per_block=10, accumulators=acc,
        generator=gen(91), mesh=mesh))
    out["vmc"] = {"energies": [b["energytotal"] for b in data],
                  "acceptance": [b["acceptance"] for b in data],
                  "positions": vcfg.positions.cpu().numpy()}
    blocks, dcfg, weights = counted("dmc", lambda: rundmc(
        wf, params, vcfg, nblocks=MESH_DMC_NBLOCKS, nsteps_per_block=10, tstep=DMC_TSTEP,
        energy_acc=acc["energy"], warmup_vmc_blocks=MESH_DMC_WARMUP, generator=gen(93),
        mesh=mesh))
    out["dmc"] = {"energies": [b["energytotal"] for b in blocks],
                  "block_weights": [b["weight"] for b in blocks],
                  "positions": dcfg.positions.cpu().numpy(), "weights": weights.cpu().numpy()}
    lmol, lmf = load_npz()
    for name, dtype in (("linemin", torch.float32), ("linemin64", torch.float64)):
        lwf, lp0, to_opt = generate_wf(lmol, lmf, device=device, dtype=dtype)
        lt = LinearTransform(lp0, to_opt)
        lcfg = Configs.create(vcfg.positions.to(dtype), vcfg.geometry, wrap=vcfg.wrap)
        lp, _, recs = counted(name, lambda: line_minimization(
            lwf, lp0, lcfg, lt, acc["energy"], generator=gen(95), max_iterations=1,
            vmc_blocks=MESH_SR_BLOCKS, vmc_steps_per_block=10, mesh=mesh))
        out[name] = {"x": lt.serialize(lp).double().cpu().numpy(),
                     "x0": lt.serialize(lp0).double().cpu().numpy(),
                     "energy": recs[0]["energy"], "tau": recs[0]["tau"],
                     "line_energies": np.asarray(recs[0]["line_energies"])}
    return out


def comb_time(mesh, nconf, reps=10):
    """(ms, bytes) of one global comb (method/dmc.py:branch with the mesh)
    of `nconf` H2O walkers in all, float32, the mean over `reps` after one
    warm-up: its gathers' buffers hold every rank's weights and positions
    (float32) and wrap counts (int32)."""
    from pyqmc_tpu_torch.method.dmc import branch
    from pyqmc_tpu_torch.utils.profiling import sync

    n = nconf // mesh.size
    g = torch.Generator(device=mesh.device).manual_seed(5)
    pos = torch.randn((n, 8, 3), generator=g, device=mesh.device)
    wrap = torch.zeros((n, 8, 3), dtype=torch.int32, device=mesh.device)
    w = torch.rand((n,), generator=g, device=mesh.device) + 0.5
    u = torch.rand((), generator=g, device=mesh.device)
    branch(pos, wrap, w, u, mesh=mesh)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        branch(pos, wrap, w, u, mesh=mesh)
    sync()
    return (time.perf_counter() - t0) / reps * 1e3, nconf * (1 + 24 + 24) * 4


def gloo_cuda_table(mesh):
    """Which collectives the gloo backend takes on CUDA tensors on this card:
    {collective: "ok", or the error's type and first line}. Each call is
    made alike on every rank, in a group of its own with a 30 s timeout."""
    import datetime

    import torch.distributed as dist

    from pyqmc_tpu_torch.utils.profiling import sync

    group = dist.new_group(backend="gloo", timeout=datetime.timedelta(seconds=30))
    x = torch.arange(4, device=mesh.device, dtype=torch.float32)
    n = mesh.size
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone(), group=group),
        "broadcast": lambda: dist.broadcast(x.clone(), 0, group=group),
        "reduce": lambda: dist.reduce(x.clone(), 0, group=group),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(n)], x,
                                              group=group),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * n, device=mesh.device), x, group=group),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // n, device=mesh.device), x.clone(), group=group),
        "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x, group=group),
    }
    table = {}
    for name, call in calls.items():
        try:
            call()
            sync()
            table[name] = "ok"
        except (RuntimeError, ValueError, NotImplementedError) as e:  # the table records it
            table[name] = f"{type(e).__name__}: {str(e).strip().splitlines()[0][:160]}"
    dist.destroy_process_group(group)
    return table


def _mesh_rank(rank, store, out_dir, nconf):
    """One of phase 36 (b)-(c)'s two ranks sharing the card over gloo; waits
    for the parent's go (the file out_dir/go) before its timed runs."""
    import os

    import torch.distributed as dist

    from pyqmc_tpu_torch.parallel.mesh import sum_over, walker_mesh

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    mesh = walker_mesh(2)
    sum_over(mesh, torch.zeros(1, device=mesh.device))  # the pair's first collective, untimed
    go = os.path.join(out_dir, "go")
    deadline = time.perf_counter() + MESH_RANK_TIMEOUT
    while not os.path.exists(go):
        check(time.perf_counter() < deadline, f"phase 36 rank {rank}: no go from the parent")
        time.sleep(0.05)
    res = mesh_runs(mesh, kernel_counters(), nconf)
    res["mesh"] = [mesh.rank, mesh.size, mesh.backend, str(mesh.device)]
    res["comb_ms"], res["comb_bytes"] = comb_time(mesh, nconf)
    res["gloo_cuda"] = gloo_cuda_table(mesh)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def mesh_phases(t_start, card, counters):
    """Phase 36: the walker mesh on H2O at 2048 walkers, float32 (the module
    docstring): (a) a one-rank NCCL mesh against no mesh, bit for bit; (b)
    two ranks sharing the card over gloo against one process on their
    streams; (c) one line minimization iteration on the two ranks; (d)
    sample_overlap, the VMC recipe and the diamond's VMC under the one-rank
    mesh against no mesh. Returns the launch counts."""
    import os
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from pyqmc_tpu_torch import recipes
    from pyqmc_tpu_torch.entry import diamond_setup, h2o_excited_setup, h2o_setup
    from pyqmc_tpu_torch.method.dmc import rundmc
    from pyqmc_tpu_torch.method.sample_many import sample_overlap
    from pyqmc_tpu_torch.method.vmc import vmc
    from pyqmc_tpu_torch.parallel.mesh import sum_over, walker_mesh
    from pyqmc_tpu_torch.system.io import load_npz
    from pyqmc_tpu_torch.utils.profiling import sync
    from tests.torch_mesh_ranks import emulated_ranks

    none = {k: 0 for k in counters}
    out = {}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.n for k, c in counters.items()}

    def gen(seed):
        return torch.Generator(device=configs.positions.device).manual_seed(seed)

    def same_blocks(a, b):
        return len(a) == len(b) and all(
            set(x) == set(y) and all(np.array_equal(x[k], y[k]) for k in x if k != "block time")
            for x, y in zip(a, b))

    def both(label, run, expect):
        """run(mesh) without a mesh and under the one-rank mesh: the same
        blocks and walkers, bit for bit, and the same launches, `expect`."""
        res = {}
        for tag, m in (("none", None), ("mesh", mesh1)):
            reset_counts()
            sync()
            t0 = time.perf_counter()
            blocks, walkers = run(m)
            sync()
            res[tag] = (blocks, walkers, read_counts(), time.perf_counter() - t0)
        (bm, wm, lm, tm), (bn, wn, ln, tn) = res["mesh"], res["none"]
        check(same_blocks(bm, bn), f"phase 36 {label}: the one-rank mesh's blocks differ from "
              "no mesh's")
        check(all(torch.equal(x, y) for x, y in zip(wm, wn)),
              f"phase 36 {label}: the one-rank mesh's walkers differ from no mesh's")
        check(lm == ln == {**none, **expect}, f"phase 36 {label}: launches {lm} and {ln}, not "
              f"{expect}")
        out["phase36" + label.translate({ord("("): None, ord(")"): None}).replace(" ", "_")
            .lower()] = lm
        print(f"phase 36 {label}: one-rank NCCL mesh equal to no mesh bit for bit, launches "
              f"{json.dumps({k: v for k, v in lm.items() if v})}; {tm:.2f} s and {tn:.2f} s",
              flush=True)
        return bm, tm

    print(f"phase 36 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t_phase = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    # (a) one rank over NCCL
    mesh1 = walker_mesh()
    check((mesh1.size, mesh1.backend) == (1, "nccl"),
          f"phase 36: walker_mesh() made {mesh1}, not one NCCL rank")
    sum_over(mesh1, torch.zeros(1, device=mesh1.device))  # the communicator's start, untimed
    mol, wf, params, configs, acc = h2o_setup(NCONF)
    nv, nd = MESH_VMC_NBLOCKS * 10, MESH_DMC_NBLOCKS * 10

    def run_vmc(m):
        data, cfg = vmc(wf, params, configs, nblocks=MESH_VMC_NBLOCKS, nsteps_per_block=10,
                        accumulators=acc, generator=gen(101), mesh=m)
        return data, (cfg.positions, cfg.wrap)

    vblocks, t_vmc = both("(a) VMC", run_vmc, {"vmc_sweep": nv, "ecp_energy": nv})

    def run_dmc(m):
        data, cfg, w = rundmc(wf, params, configs, nblocks=MESH_DMC_NBLOCKS, nsteps_per_block=10,
                              tstep=DMC_TSTEP, energy_acc=acc["energy"],
                              warmup_vmc_blocks=MESH_DMC_WARMUP, generator=gen(103), mesh=m)
        return data, (cfg.positions, cfg.wrap, w)

    nw = MESH_DMC_WARMUP * 10
    dblocks, _ = both("(a) DMC", run_dmc, {"vmc_sweep": nw, "dmc_sweep": nd, "tmove_sweep": nd,
                                           "ecp_energy": nw + 1 + nd + MESH_DMC_NBLOCKS})
    rate_a = NCONF * nv / t_vmc
    comb_a, comb_bytes = comb_time(mesh1, NCONF)
    print(f"phase 36 (a): VMC E={[round(b['energytotal'], 6) for b in vblocks]}, DMC E="
          f"{[round(b['energytotal'], 6) for b in dblocks]}; VMC {rate_a:.4e} walker-steps/s on "
          f"one rank; the global comb of {NCONF} walkers ({comb_bytes} bytes gathered) "
          f"{comb_a:.3f} ms; {card}", flush=True)

    # (b)-(c) two ranks sharing the card over gloo, spawned now that the kernels are built
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_mesh_rank, args=(os.path.join(tmp, "store"), tmp, NCONF),
                                 nprocs=2, join=False, start_method="spawn")
        try:
            # while the ranks start: one process on their concatenated streams
            with emulated_ranks(2):
                ref = mesh_runs(None, counters, NCONF)
            open(os.path.join(tmp, "go"), "w").close()
            deadline = time.perf_counter() + MESH_RANK_TIMEOUT
            while not ctx.join(timeout=5.0):
                check(time.perf_counter() < deadline, "phase 36: the two ranks did not end in "
                      f"{MESH_RANK_TIMEOUT:.0f} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
        r0, r1 = (torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                  for r in range(2))
    check(r0["mesh"][:3] == [0, 2, "gloo"] and r1["mesh"][:3] == [1, 2, "gloo"]
          and r0["mesh"][3] == r1["mesh"][3], f"phase 36: the ranks' meshes {r0['mesh']}, "
          f"{r1['mesh']}")
    for name in ("vmc", "dmc", "linemin", "linemin64"):
        for k, v in r0[name].items():
            check(np.array_equal(v, r1[name][k]), f"phase 36 (b): the ranks' {name} {k} differ")
    dv = float(np.max(np.abs(r0["vmc"]["positions"] - ref["vmc"]["positions"])))
    ev = max(abs(a - b) / abs(b) for a, b in zip(r0["vmc"]["energies"], ref["vmc"]["energies"]))
    moved = np.max(np.abs(r0["dmc"]["positions"] - ref["dmc"]["positions"]), axis=(1, 2))
    share = float(np.mean(moved > 1e-4))
    ed = max(abs(a - b) for a, b in zip(r0["dmc"]["energies"], ref["dmc"]["energies"]))
    w = r0["dmc"]["weights"]
    for r, res in enumerate((r0, r1)):
        check(res["vmc_launches"] == {**none, "vmc_sweep": nv, "ecp_energy": nv},
              f"phase 36 (b): rank {r}'s VMC launched {res['vmc_launches']}")
        check(res["dmc_launches"] == {**none, "vmc_sweep": nw, "dmc_sweep": nd, "tmove_sweep": nd,
                                      "ecp_energy": nw + 1 + nd + MESH_DMC_NBLOCKS},
              f"phase 36 (b): rank {r}'s DMC launched {res['dmc_launches']}")
        for name in ("linemin", "linemin64"):
            check(res[name + "_launches"] == {**none, "vmc_sweep": MESH_SR_BLOCKS * 10,
                                              "ecp_energy": MESH_SR_BLOCKS * 10 + 7},
                  f"phase 36 (c): rank {r}'s {name} launched {res[name + '_launches']}")
    out.update({"phase36b_rank0_vmc": r0["vmc_launches"], "phase36b_rank0_dmc":
                r0["dmc_launches"], "phase36c_rank0_linemin": r0["linemin_launches"],
                "phase36c_rank0_linemin64": r0["linemin64_launches"]})
    rate_b = NCONF * nv / max(r0["vmc_seconds"], r1["vmc_seconds"])
    print(f"phase 36 (b): two gloo ranks of {NCONF // 2} walkers on {r0['mesh'][3]} against one "
          f"process of {NCONF} on their streams: VMC positions {dv:.2e} apart (gate "
          f"{MESH_POS_ATOL}), block energies {ev:.2e} relative (gate {MESH_VMC_RTOL}): "
          f"{[round(e, 6) for e in r0['vmc']['energies']]} and "
          f"{[round(e, 6) for e in ref['vmc']['energies']]}; DMC after the global comb "
          f"{share:.4f} of the walkers with another parent (gate {MESH_PARENT_SHARE}), block "
          f"energies {ed:.2e} Ha apart (gate {MESH_DMC_ATOL}): "
          f"{[round(e, 6) for e in r0['dmc']['energies']]} and "
          f"{[round(e, 6) for e in ref['dmc']['energies']]}; the weights after the last comb "
          f"{'all' if np.all(w == w[0]) else 'not all'} {w[0]:.6f}; VMC {rate_b:.4e} walker-steps/s "
          f"on two ranks ({r0['vmc_seconds']:.2f} s and {r1['vmc_seconds']:.2f} s, one process "
          f"{ref['vmc_seconds']:.2f} s), DMC {r0['dmc_seconds']:.2f} s; {card}", flush=True)
    print(f"phase 36 (b): the global comb of {NCONF} walkers over the two gloo ranks "
          f"({r0['comb_bytes']} bytes gathered) {r0['comb_ms']:.3f} and {r1['comb_ms']:.3f} ms; "
          f"gloo collectives on CUDA tensors: {json.dumps(r0['gloo_cuda'])}", flush=True)
    check(dv <= MESH_POS_ATOL and ev <= MESH_VMC_RTOL, "phase 36 (b): the two ranks' VMC left "
          f"the one-process run's (positions {dv}, energies {ev} relative)")
    check(share <= MESH_PARENT_SHARE and ed <= MESH_DMC_ATOL, "phase 36 (b): the two ranks' DMC "
          f"left the one-process run's ({share} of the walkers, energies {ed} Ha)")
    check(np.all(w == w[0]), "phase 36 (b): the comb left the population's weights unequal")
    dx = {}
    for name in ("linemin", "linemin64"):
        lm, lr = r0[name], ref[name]
        dx[name] = float(np.max(np.abs(lm["x"] - lr["x"])) / np.max(np.abs(lr["x"])))
        check(not np.array_equal(lm["x"], lm["x0"]), f"phase 36 (c): {name}'s parameters did "
              "not move")
        print(f"phase 36 (c): one line minimization iteration ({MESH_SR_BLOCKS} x 10 SR steps, "
              f"{'float64' if name == 'linemin64' else 'float32'}) on the two ranks: parameters "
              f"equal on both ranks, {dx[name]:.2e} relative from one process; E "
              f"{lm['energy']:.6f} and {lr['energy']:.6f}, tau {lm['tau']} and {lr['tau']}; "
              f"{r0[name + '_seconds']:.2f} s", flush=True)
    check(dx["linemin64"] <= MESH_OPT_RTOL, f"phase 36 (c): the two ranks' float64 parameters "
          f"are {dx['linemin64']} relative from the one-process run's (gate {MESH_OPT_RTOL})")

    # (d) the one-rank NCCL mesh through sample_overlap, the VMC recipe and the diamond
    _, wfs, plist, xcfg, xacc, _ = h2o_excited_setup(NCONF)

    def run_overlap(m):
        data, cfg = sample_overlap(wfs, plist, xcfg, gen(107), nblocks=1,
                                   nsteps=MESH_OVERLAP_NSTEPS, energy_acc=xacc["energy"], mesh=m)
        return data, (cfg.positions,)

    # one K2 (state 0's energy) and one K3 (state 1's flat ECP chain) per step
    both("(d) sample_overlap", run_overlap, {"ecp_energy": MESH_OVERLAP_NSTEPS,
                                             "value_mo": MESH_OVERLAP_NSTEPS})
    rmol, rmf = load_npz()

    def run_recipe(m):
        data, cfg = recipes.VMC(rmol, mf=rmf, nconfig=NCONF, nblocks=MESH_VMC_NBLOCKS,
                                nsteps_per_block=10, seed=109, mesh=m)
        return data, (cfg.positions,)

    both("(d) VMC recipe", run_recipe, {"vmc_sweep": nv, "ecp_energy": nv})
    _, dwf, dparams, dcfg, dacc = diamond_setup(DIAMOND_NCONF)

    def run_diamond(m):
        data, cfg = vmc(dwf, dparams, dcfg, nblocks=1, nsteps_per_block=10, accumulators=dacc,
                        generator=gen(111), mesh=m)
        return data, (cfg.positions, cfg.wrap)

    both("(d) diamond VMC", run_diamond, {"pbc_sweep": 10, "gto_eval": 20, "value_mo": 40})
    dist.destroy_process_group()
    t36 = time.perf_counter() - t_phase
    print(f"phase 36: {t36:.1f} s; {card}", flush=True)
    out["phase36_seconds"] = t36
    return out


def ewald2d_phase(t_start, card):
    """Phase 37: the slab Ewald sum (observables/ewald2d.py) on the card in
    float64 and float32: the NaCl monolayer's Madelung constant, and the
    per-walker energies of EWALD2D_NCONF random walkers of EWALD2D_NELEC
    electrons within 0.5 bohr of its plane against psi_host summed on the
    host (float64)."""
    from pyqmc_tpu_torch.observables.ewald2d import Ewald2D

    class Monolayer:
        atom_coords = np.array([[0, 0, 0], [1, 1, 0], [1, 0, 0], [0, 1, 0]], dtype=float)
        atom_charges = np.array([1.0, 1.0, -1.0, -1.0])
        lattice = np.diag([2.0, 2.0, 30.0])

    print(f"phase 37 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    t_phase = time.perf_counter()
    ew = Ewald2D(Monolayer)
    madelung = ew.ii_const / 2.0
    check(abs(madelung + NACL_MADELUNG) <= 1e-8 * NACL_MADELUNG,
          f"phase 37: the NaCl monolayer's ii_const / 2 is {madelung}, not -{NACL_MADELUNG}")
    rng = np.random.default_rng(37)
    n, ne = EWALD2D_NCONF, EWALD2D_NELEC
    pos = np.concatenate([rng.uniform(0.0, 2.0, size=(n, ne, 2)),
                          rng.uniform(-0.5, 0.5, size=(n, ne, 1))], axis=-1)
    iu, ju = np.triu_indices(ne, 1)
    ee = ew.psi_host(pos[:, iu] - pos[:, ju]).reshape(n, -1).sum(1) + 0.5 * ne * ew.xi
    dei = pos[:, :, None, :] - Monolayer.atom_coords[None, None]
    ei = -(ew.psi_host(dei).reshape(n, ne, -1) * Monolayer.atom_charges).sum((1, 2))
    host = {"ee": ee, "ei": ei, "ii": np.full(n, ew.ii_const)}
    res = {}
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-5)):
        x = torch.as_tensor(pos, dtype=dtype, device="cuda")
        got = dict(zip(("ee", "ei", "ii"), ew.energy(x)))
        ms = cuda_ms(lambda: ew.energy(x), 5)
        if dtype == torch.float64:
            err = {k: float(np.max(np.abs(got[k].double().cpu().numpy() - v)))
                   for k, v in host.items()}
        else:  # relative to the largest magnitude
            err = {k: float(np.max(np.abs(got[k].double().cpu().numpy() - v)) / np.max(np.abs(v)))
                   for k, v in host.items()}
        res[str(dtype)] = {"err": err, "ms": ms}
        check(all(e <= tol for e in err.values()), f"phase 37: Ewald2D.energy in {dtype} is "
              f"{err} from psi_host on the host (gate {tol})")
    t37 = time.perf_counter() - t_phase
    print(f"phase 37: the NaCl monolayer's ii_const / 2 = {madelung:.10f}; energy of {n} walkers "
          f"of {ne} electrons against the host: float64 {json.dumps(res['torch.float64'])} "
          f"(absolute), float32 {json.dumps(res['torch.float32'])} (relative to the largest); "
          f"{t37:.1f} s; {card}", flush=True)
    return {"phase37_seconds": t37}


def main():
    t_start = time.perf_counter()
    # phase 0: the card (and the package: nothing is printed without both)
    check(torch.cuda.is_available(), "no CUDA device; the port's kernels run only on a GPU")
    from pyqmc_tpu_torch.models.orbitals import plain_orbitals
    from pyqmc_tpu_torch.ops import _build

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    counters = kernel_counters()
    periodic = ("value_mo", "gto_eval", "pbc_sweep", "pbc_dmc_sweep")
    h2o_kernels = ("vmc_sweep", "ecp_energy", "dmc_sweep", "tmove_sweep")

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.n for k, c in counters.items()}

    # phase 1: build
    t0 = time.perf_counter()
    libs = _build.build()
    _build.library()
    print(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for so in libs.values():
        with open(so[:-3] + ".log") as f:
            for line in f:
                if "Compiling entry function" in line or "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip().replace("ptxas info    : ", ""), flush=True)

    print(f"phase 2 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 2: kernels against their plain versions (which evaluate their
    # MO values without K3; the four kernels call no orbital evaluator)
    with plain_orbitals():
        r64 = compare_kernels(torch.float64)
        print("phase 2 float64: " + json.dumps(r64), flush=True)
        r32 = compare_kernels(torch.float32)
        print("phase 2 float32: " + json.dumps(r32), flush=True)
    print(f"phase 2: K1, K2, K4 and K5, device (CUDA events over back-to-back launches) and "
          f"wrapper ms, bound and its share of the device time, {card}: "
          f"{json.dumps(r32['redesigned'])}", flush=True)
    print("phase 2 float64 blocks: " + json.dumps(compare_blocks()), flush=True)

    print(f"phase 3 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 3: the VMC path through the entry points
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.vmc import vmc

    mol, wf, params, configs, acc = h2o_setup(NCONF, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(7)
    reset_counts()
    t0 = time.perf_counter()
    blocks, configs = vmc(wf, params, configs, nblocks=4, nsteps_per_block=NSTEPS, tstep=TSTEP,
                          accumulators=acc, generator=gen)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = read_counts()
    for b in blocks:
        print(f"phase 3 block {b['block']}: E={b['energytotal']:.6f} ecp={b['energyecp']:.6f} "
              f"ke={b['energyke']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s",
              flush=True)
    check(launches == {"vmc_sweep": 4 * NSTEPS, "ecp_energy": 4 * NSTEPS, "dmc_sweep": 0,
                       "tmove_sweep": 0, **{k: 0 for k in periodic}},
          f"kernel launches on the VMC path: {launches}")
    for b in blocks:
        check(all(np.isfinite(v) for k, v in b.items() if k.startswith("energy")),
              f"non-finite energies in block {b['block']}")
    e_last = float(np.mean([b["energytotal"] for b in blocks[-2:]]))
    a_last = float(np.mean([b["acceptance"] for b in blocks[-2:]]))
    check(-17.2 < e_last < -16.8, f"energy {e_last} outside (-17.2, -16.8) Ha")
    check(0.5 < a_last < 0.75, f"acceptance {a_last} outside (0.5, 0.75)")
    print(f"phase 3: launches {launches}, E(last 2 blocks)={e_last:.6f} Ha, acc={a_last:.4f}, "
          f"{t_main:.2f} s for 4 blocks", flush=True)
    against_pins("phase 3", "VMC", e_last, [b["energytotal"] for b in blocks], 2, H2O_VMC_E,
                 H2O_VMC_E_ONE_THREAD)

    print(f"phase 4 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 4: one VMC block with the kernels, one with the plain versions
    from pyqmc_tpu_torch.method.vmc import make_vmc_block
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.observables.ecp import ECPAccumulator

    acc_plain = {"energy": EnergyAccumulator(mol, ecp_acc=ECPAccumulator(mol, fused=False))}
    fns = {"kernel": make_vmc_block(wf, acc, configs.geometry, TSTEP, TIMED_NSTEPS, fused=True),
           "plain": make_vmc_block(wf, acc_plain, configs.geometry, TSTEP, TIMED_NSTEPS,
                                   fused=False)}
    walk = {"pos": configs.positions, "wrap": configs.wrap}

    def vmc_block(name, fn):
        walk["pos"], walk["wrap"], avg = fn(params, walk["pos"], walk["wrap"], gen)
        check(bool(torch.isfinite(avg["energytotal"])), f"non-finite {name} VMC block energy")

    tk, tp, times = timed_in_turns(fns, vmc_block)
    print(f"phase 4: {TIMED_NSTEPS}-step VMC block with kernels {tk:.4f} s "
          f"({NCONF * TIMED_NSTEPS / tk:.1f} walker-steps/s), plain {tp:.4f} s "
          f"({NCONF * TIMED_NSTEPS / tp:.1f} walker-steps/s); "
          f"runs {json.dumps(times)}", flush=True)

    print(f"phase 5 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 5: one traced kernel VMC block; the device's busy time and idle share
    ours_vmc = report_trace("phase 5", "kernel VMC block", TIMED_NSTEPS,
                            traced(lambda: vmc_block("traced", fns["kernel"])), tk)

    print(f"phase 6 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 6: the DMC path through the entry points, on the default device
    from pyqmc_tpu_torch.method.dmc import make_dmc_block, rundmc

    mol, wf, params, configs, acc = h2o_setup(NCONF, dtype=torch.float32)
    check(configs.positions.device.type == "cuda", "h2o_setup's default device is not the GPU")
    gen = torch.Generator(device="cuda").manual_seed(17)
    reset_counts()
    t0 = time.perf_counter()
    dblocks, dconfigs, weights = rundmc(
        wf, params, configs, nblocks=DMC_NBLOCKS, nsteps_per_block=DMC_NSTEPS, tstep=DMC_TSTEP,
        energy_acc=acc["energy"], generator=gen, warmup_vmc_blocks=DMC_WARMUP)
    torch.cuda.synchronize()
    t_dmc = time.perf_counter() - t0
    dlaunches = read_counts()
    for b in dblocks:
        print(f"phase 6 block {b['block']}: E={b['energytotal']:.6f} w={b['weight']:.5f} "
              f"e_trial={b['e_trial']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
    nwarm = DMC_WARMUP * 10  # rundmc's warm-up blocks have 10 steps
    expect = {"vmc_sweep": nwarm, "dmc_sweep": DMC_NBLOCKS * DMC_NSTEPS,
              "tmove_sweep": DMC_NBLOCKS * DMC_NSTEPS,
              # warm-up steps, the energy that sets e_trial, and per block its
              # first energy plus one per step
              "ecp_energy": nwarm + 1 + DMC_NBLOCKS * (DMC_NSTEPS + 1),
              **{k: 0 for k in periodic}}
    check(dlaunches == expect, f"kernel launches on the DMC path: {dlaunches}, expected {expect}")
    for b in dblocks:
        check(all(np.isfinite(v) for v in b.values()), f"non-finite value in DMC block {b}")
        check(0.5 < b["weight"] < 2.0, f"block mean weight {b['weight']} outside (0.5, 2)")
        check(b["acceptance"] > 0.9, f"DMC acceptance {b['acceptance']} not above 0.9")
    check(bool(torch.all(torch.isfinite(weights))) and bool(torch.all(weights > 0)),
          "final weights are not finite and positive")
    check(dconfigs.positions.shape == (NCONF, 8, 3), "final walkers have the wrong shape")
    e_dmc = float(np.mean([b["energytotal"] for b in dblocks[-3:]]))
    # the energy window opens with the warm-up walkers' mean local energy:
    # after block 0, e_est is the mean of that energy and block 0's
    e_warm = 2 * dblocks[0]["e_est"] - dblocks[0]["energytotal"]
    check(-17.6 < e_dmc < -16.9, f"DMC energy {e_dmc} outside (-17.6, -16.9) Ha")
    check(e_dmc < e_warm + 0.05, f"DMC energy {e_dmc} above the warm-up VMC energy {e_warm}")
    print(f"phase 6: launches {dlaunches}, E(last 3 blocks)={e_dmc:.6f} Ha, warm-up VMC "
          f"E={e_warm:.6f} Ha, {t_dmc:.2f} s for {DMC_WARMUP} warm-up + {DMC_NBLOCKS} DMC blocks",
          flush=True)
    against_pins("phase 6", "DMC", e_dmc, [b["energytotal"] for b in dblocks], 3, H2O_DMC_E,
                 H2O_DMC_E_ONE_THREAD)

    print(f"phase 7 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 7: one DMC block with the kernels, one with the plain versions, one traced
    acc_plain = EnergyAccumulator(mol, ecp_acc=ECPAccumulator(mol, fused=False))
    dfns = {"kernel": make_dmc_block(wf, acc["energy"], dconfigs.geometry, DMC_TSTEP, DMC_NSTEPS,
                                     fused=True)[0],
            "plain": make_dmc_block(wf, acc_plain, dconfigs.geometry, DMC_TSTEP, DMC_NSTEPS,
                                    fused=False)[0]}
    last = dblocks[-1]
    walk = {"pos": dconfigs.positions, "wrap": dconfigs.wrap, "w": weights}

    def dmc_block(name, fn):
        walk["pos"], walk["wrap"], walk["w"], avg = fn(
            params, walk["pos"], walk["wrap"], walk["w"], gen, last["e_trial"], last["e_est"],
            0.5)
        check(bool(torch.isfinite(avg["energytotal"])), f"non-finite {name} DMC block energy")

    reset_counts()
    dtk, dtp, dtimes = timed_in_turns(dfns, dmc_block)
    check(read_counts() == {
        "vmc_sweep": 0, "dmc_sweep": 2 * DMC_NSTEPS, "tmove_sweep": 2 * DMC_NSTEPS,
        "ecp_energy": 2 * (DMC_NSTEPS + 1), **{k: 0 for k in periodic}},
          f"the plain DMC blocks launched kernels: {read_counts()}")
    print(f"phase 7: {DMC_NSTEPS}-step DMC block with kernels {dtk:.4f} s "
          f"({NCONF * DMC_NSTEPS / dtk:.1f} walker-steps/s), plain {dtp:.4f} s "
          f"({NCONF * DMC_NSTEPS / dtp:.1f} walker-steps/s); runs {json.dumps(dtimes)}",
          flush=True)
    ours_dmc = report_trace("phase 7", "kernel DMC block", DMC_NSTEPS,
                            traced(lambda: dmc_block("traced", dfns["kernel"])), dtk)

    print(f"phase 8 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 8: the periodic kernels against their plain versions
    p64 = compare_pbc_kernels(torch.float64)
    print("phase 8 float64: " + json.dumps(p64), flush=True)
    p32 = compare_pbc_kernels(torch.float32)
    print("phase 8 float32: " + json.dumps(p32), flush=True)
    print(f"phase 8: K3 and K7, device (CUDA events over back-to-back launches) and wrapper ms, "
          f"bound and its share of the device time, {card}: {json.dumps(p32['redesigned'])}",
          flush=True)

    print(f"phase 9 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 9: the periodic VMC path through the entry points, default device
    from pyqmc_tpu_torch.entry import diamond_setup

    sup, wf, params, configs, acc = diamond_setup(DIAMOND_NCONF, dtype=torch.float32)
    check(configs.positions.device.type == "cuda", "diamond_setup's default device is not the GPU")
    gen = torch.Generator(device="cuda").manual_seed(29)
    inner = make_vmc_block(wf, acc, configs.geometry, TSTEP, DIAMOND_NSTEPS)
    per_block = []

    def counted_block(*args):
        before = read_counts()
        out = inner(*args)
        per_block.append({k: v - before[k] for k, v in read_counts().items()})
        return out

    reset_counts()
    t0 = time.perf_counter()
    pblocks, pconfigs = vmc(wf, params, configs, nblocks=DIAMOND_NBLOCKS,
                            nsteps_per_block=DIAMOND_NSTEPS, tstep=TSTEP, accumulators=acc,
                            generator=gen, block_fn=counted_block)
    torch.cuda.synchronize()
    t_pbc = time.perf_counter() - t0
    plaunches = read_counts()
    # launches per step: one sweep, one K6 per kinetic-energy chunk of
    # 16384 // nconf electrons, one K3 per ECP chunk of 262144 // (nconf
    # nselect) electrons; 1, 2 and 4 at 500 walkers
    nelec, nsel = sum(sup.nelec), acc["energy"].ecp_acc.nselect
    per_step = {"pbc_sweep": 1, "gto_eval": -(-nelec // max(1, 16384 // DIAMOND_NCONF)),
                "value_mo": -(-nelec // max(1, 262144 // (DIAMOND_NCONF * nsel)))}
    check(DIAMOND_NCONF != 500 or per_step == {"pbc_sweep": 1, "gto_eval": 2, "value_mo": 4},
          f"expected launches per step {per_step}")
    for b, n in zip(pblocks, per_block):
        print(f"phase 9 block {b['block']}: E/cell={b['energytotal'] / DIAMOND_NCELL:.6f} "
              f"ecp/cell={b['energyecp'] / DIAMOND_NCELL:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s launches {json.dumps(n)}", flush=True)
        check(n == {k: DIAMOND_NSTEPS * per_step.get(k, 0) for k in counters},
              f"kernel launches in a periodic block: {n}")
        check(all(np.isfinite(v) for k, v in b.items() if k.startswith("energy")),
              f"non-finite energies in periodic block {b['block']}")
    e_cells = np.array([b["energytotal"] / DIAMOND_NCELL for b in pblocks[-DIAMOND_NLAST:]])
    e_pbc, sem_pbc = float(np.mean(e_cells)), float(np.std(e_cells, ddof=1) / np.sqrt(len(e_cells)))
    a_pbc = float(np.mean([b["acceptance"] for b in pblocks[-DIAMOND_NLAST:]]))
    ref = DIAMOND_REF
    window = max(5 * float(np.hypot(sem_pbc, ref["sem"])), 0.02)
    print(f"phase 9: launches {plaunches}, E/cell(last {DIAMOND_NLAST} blocks)={e_pbc:.6f} "
          f"+- {sem_pbc:.6f} Ha, acc={a_pbc:.4f}; JAX CPU reference {ref['e_cell']:.6f} "
          f"+- {ref['sem']:.6f} Ha, acc {ref['acceptance']:.4f}; window {window:.6f} Ha; "
          f"{t_pbc:.2f} s for {DIAMOND_NBLOCKS} blocks", flush=True)
    check(abs(e_pbc - ref["e_cell"]) <= window,
          f"periodic E/cell {e_pbc} off the JAX reference {ref['e_cell']} by more than {window}")
    check(abs(a_pbc - ref["acceptance"]) <= 0.05,
          f"periodic acceptance {a_pbc} off the JAX reference's {ref['acceptance']}")

    print(f"phase 10 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 10: a kernel and a plain periodic block in turns, then one traced
    pfns = {"kernel": make_vmc_block(wf, acc, configs.geometry, TSTEP, PBC_TIMED_NSTEPS),
            "plain": make_vmc_block(wf, acc, configs.geometry, TSTEP, PBC_TIMED_NSTEPS,
                                    fused=False)}
    walk = {"pos": pconfigs.positions, "wrap": pconfigs.wrap}

    def pbc_block(name, fn):
        walk["pos"], walk["wrap"], avg = fn(params, walk["pos"], walk["wrap"], gen)
        check(bool(torch.isfinite(avg["energytotal"])), f"non-finite {name} periodic block energy")

    reset_counts()
    ptk, ptp, ptimes = timed_in_turns(pfns, pbc_block)
    check(read_counts() == {k: 2 * PBC_TIMED_NSTEPS * per_step.get(k, 0) for k in counters},
          f"the periodic blocks' launches: {read_counts()} (the plain blocks must launch none)")
    print(f"phase 10: {PBC_TIMED_NSTEPS}-step periodic block with kernels {ptk:.4f} s "
          f"({DIAMOND_NCONF * PBC_TIMED_NSTEPS / ptk:.1f} walker-steps/s), plain {ptp:.4f} s "
          f"({DIAMOND_NCONF * PBC_TIMED_NSTEPS / ptp:.1f} walker-steps/s); runs "
          f"{json.dumps(ptimes)}", flush=True)
    ours_pbc = report_trace("phase 10", "kernel periodic block", DIAMOND_NSTEPS,
                            traced(lambda: pbc_block("traced", inner)),
                            ptk * DIAMOND_NSTEPS / PBC_TIMED_NSTEPS)

    print(f"phase 11 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 11: the periodic DMC path through the entry points, default device
    sup, wf, params, configs, acc = diamond_setup(DIAMOND_NCONF, dtype=torch.float32)
    check(configs.positions.device.type == "cuda", "diamond_setup's default device is not the GPU")
    nelec = sum(sup.nelec)
    gen = torch.Generator(device="cuda").manual_seed(31)
    reset_counts()
    t0 = time.perf_counter()
    qblocks, qconfigs, qweights = rundmc(
        wf, params, configs, nblocks=DIAMOND_DMC_NBLOCKS, nsteps_per_block=DMC_NSTEPS,
        tstep=DMC_TSTEP, energy_acc=acc["energy"], generator=gen,
        warmup_vmc_blocks=DIAMOND_DMC_WARMUP)
    torch.cuda.synchronize()
    t_qdmc = time.perf_counter() - t0
    qlaunches = read_counts()
    # an energy evaluation launches K6 once per kinetic chunk and K3 once
    # per ECP chunk (per_step of phase 9); the T-move sweep evaluates each
    # electron's dense quadrature with one K3 launch; per DMC block: the
    # first energy, then per step a T-move sweep, a K7-dmc sweep, an energy
    nwarm = DIAMOND_DMC_WARMUP * 10  # rundmc's warm-up blocks have 10 steps
    per_block = {"pbc_dmc_sweep": DMC_NSTEPS,
                 "gto_eval": (DMC_NSTEPS + 1) * per_step["gto_eval"],
                 "value_mo": (DMC_NSTEPS + 1) * per_step["value_mo"] + DMC_NSTEPS * nelec}
    qexpect = {k: 0 for k in counters}
    qexpect.update({
        "pbc_sweep": nwarm,
        "pbc_dmc_sweep": DIAMOND_DMC_NBLOCKS * per_block["pbc_dmc_sweep"],
        # warm-up steps, the energy that sets e_trial, the blocks
        "gto_eval": (nwarm + 1) * per_step["gto_eval"]
        + DIAMOND_DMC_NBLOCKS * per_block["gto_eval"],
        "value_mo": (nwarm + 1) * per_step["value_mo"]
        + DIAMOND_DMC_NBLOCKS * per_block["value_mo"]})
    for b in qblocks:
        print(f"phase 11 block {b['block']}: E/cell={b['energytotal'] / DIAMOND_NCELL:.6f} "
              f"ecp/cell={b['energyecp'] / DIAMOND_NCELL:.6f} w={b['weight']:.5f} "
              f"e_trial/cell={b['e_trial'] / DIAMOND_NCELL:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
    check(qlaunches == qexpect,
          f"kernel launches on the periodic DMC path: {qlaunches}, expected {qexpect}")
    qref = DIAMOND_DMC_REF
    # The block mean weight follows e_trial's lag behind the energy, which
    # falls by 0.5-1 Ha per cell from the warm-up VMC's: the JAX package's
    # runs on this schedule reach block mean weights of 3.4-11.6. So
    # each block's weight is held, within a factor of 2, to the weight that
    # its e_trial and its energy predict (predicted_weights).
    e_qwarm_total = 2 * qblocks[0]["e_est"] - qblocks[0]["energytotal"]
    w_pred = predicted_weights(qblocks, e_qwarm_total, DMC_TSTEP, DMC_NSTEPS)
    for b, wp in zip(qblocks, w_pred):
        check(all(np.isfinite(v) for v in b.values()),
              f"non-finite value in periodic DMC block {b}")
        check(0.5 < b["weight"] / wp < 2.0,
              f"periodic block {b['block']} mean weight {b['weight']} not within a factor 2 of "
              f"the {wp} that its e_trial and energy predict")
        check(b["acceptance"] > 0.9, f"periodic DMC acceptance {b['acceptance']} not above 0.9")
    check(bool(torch.all(torch.isfinite(qweights))) and bool(torch.all(qweights > 0)),
          "final periodic weights are not finite and positive")
    check(qconfigs.positions.shape == (DIAMOND_NCONF, nelec, 3),
          "final periodic walkers have the wrong shape")
    q_cells = np.array([b["energytotal"] / DIAMOND_NCELL for b in qblocks[-DIAMOND_DMC_NLAST:]])
    e_q = float(np.mean(q_cells))
    a_q = float(np.mean([b["acceptance"] for b in qblocks[-DIAMOND_DMC_NLAST:]]))
    sem_q = float(np.std(q_cells, ddof=1) / np.sqrt(len(q_cells)))
    e_qwarm = e_qwarm_total / DIAMOND_NCELL
    qwindow = max(5 * float(np.hypot(sem_q, qref["sem"])), 0.02)
    print(f"phase 11: launches {qlaunches} ({json.dumps(per_block)} per block), "
          f"E/cell(last {DIAMOND_DMC_NLAST} blocks)={e_q:.6f} +- {sem_q:.6f} Ha, warm-up VMC "
          f"E/cell={e_qwarm:.6f} Ha, acc={a_q:.4f}, block weights "
          f"{[round(b['weight'], 4) for b in qblocks]}, predicted {[round(w, 4) for w in w_pred]}; "
          f"JAX CPU reference {qref['e_cell']:.6f} +- {qref['sem']:.6f} Ha (warm-up VMC "
          f"{qref['e_vmc_cell']:.6f}, acc {qref['acceptance']:.4f}, block weights "
          f"{[round(w, 4) for w in qref['weights']]}); "
          f"window {qwindow:.6f} Ha; {t_qdmc:.2f} s for {DIAMOND_DMC_WARMUP} warm-up + "
          f"{DIAMOND_DMC_NBLOCKS} DMC blocks", flush=True)
    check(abs(e_q - qref["e_cell"]) <= qwindow,
          f"periodic DMC E/cell {e_q} off the JAX reference {qref['e_cell']} by more than "
          f"{qwindow}")
    check(e_q < e_qwarm + 0.02,
          f"periodic DMC E/cell {e_q} above the warm-up VMC energy {e_qwarm} by more than 0.02 Ha")

    print(f"phase 12 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 12: a kernel and a plain periodic DMC block in turns, then one traced
    qlast = qblocks[-1]
    qfns = {"kernel": make_dmc_block(wf, acc["energy"], qconfigs.geometry, DMC_TSTEP,
                                     PBC_TIMED_NSTEPS, fused=True)[0],
            "plain": make_dmc_block(wf, acc["energy"], qconfigs.geometry, DMC_TSTEP,
                                    PBC_TIMED_NSTEPS, fused=False)[0]}
    walk = {"pos": qconfigs.positions, "wrap": qconfigs.wrap, "w": qweights}

    def qdmc_block(name, fn):
        walk["pos"], walk["wrap"], walk["w"], avg = fn(
            params, walk["pos"], walk["wrap"], walk["w"], gen, qlast["e_trial"], qlast["e_est"],
            0.5 * DIAMOND_NCELL)  # esigma: 0.5 Ha per primitive cell
        check(bool(torch.isfinite(avg["energytotal"])),
              f"non-finite {name} periodic DMC block energy")

    # the T-move sweep of one step alone (plain PyTorch with a K3 launch
    # per electron for its dense quadrature's ratios), CUDA events
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams
    from pyqmc_tpu_torch.ops.tmove_sweep import tmove_sweep_plain

    qst = draw_dmc_streams(gen, 1, nelec, DIAMOND_NCONF, DMC_TSTEP, walk["pos"].device,
                           torch.float32, downselect=True)
    qstate = wf.recompute(params, walk["pos"])
    k3 = counters["value_mo"].n
    tmove_ms = cuda_ms(lambda: tmove_sweep_plain(
        wf, qconfigs.geometry, acc["energy"].ecp_acc, DMC_TSTEP, params, walk["pos"],
        walk["wrap"], qstate, qst["tqrot"][0], qst["u_sel"][0], qst["u_acc"][0]), 1)
    check(counters["value_mo"].n - k3 == 2 * nelec,
          f"the T-move sweep launched K3 {counters['value_mo'].n - k3} times in 2 sweeps")
    # K3 at the T-move quadrature's size (one electron's 96 points per walker)
    orb = wf.wfs[0].orbitals
    aux, _ = acc["energy"].ecp_acc.quadrature_geometry(walk["pos"][:, 0], qst["tqrot"][0][0])
    Xq, _ = orb._fold(aux.reshape(-1, 3))
    Rq = orb._folded_coeff(params["wf0"], torch.float32)
    k3_ms = cuda_ms(lambda: orb._value_mo.kernel_t(Xq, Rq), 10)
    k3_bytes, k3_ops = kernel_bounds_pbc(wf, qconfigs.geometry, DIAMOND_NCONF,
                                         {"pbc_sweep": 0, "pbc_dmc_sweep": 0}, Xq.shape[0],
                                         1)["value_mo"]
    k3_bound, k3_by = bound_ms(k3_bytes, k3_ops)
    print(f"phase 12: the T-move sweep alone {tmove_ms:.2f} ms ({nelec} K3 launches); K3 at its "
          f"{Xq.shape[0]} points {k3_ms:.4f} ms (CUDA events), bound {k3_bound:.4f} ms ({k3_by})",
          flush=True)
    reset_counts()
    qtk, qtp, qtimes = timed_in_turns(qfns, qdmc_block, order=("plain", "kernel"))
    n = PBC_TIMED_NSTEPS
    timed_expect = {"pbc_dmc_sweep": n, "gto_eval": (n + 1) * per_step["gto_eval"],
                    "value_mo": (n + 1) * per_step["value_mo"] + n * nelec}
    check(read_counts() == {k: timed_expect.get(k, 0) for k in counters},
          f"the periodic DMC blocks' launches: {read_counts()} (the plain blocks must launch none)")
    print(f"phase 12: {n}-step periodic DMC block with kernels {qtk:.4f} s "
          f"({DIAMOND_NCONF * n / qtk:.1f} walker-steps/s), plain {qtp:.4f} s "
          f"({DIAMOND_NCONF * n / qtp:.1f} walker-steps/s); runs {json.dumps(qtimes)}",
          flush=True)
    qtrace = make_dmc_block(wf, acc["energy"], qconfigs.geometry, DMC_TSTEP, PBC_TRACE_NSTEPS)[0]
    ours_qdmc = report_trace("phase 12", f"{PBC_TRACE_NSTEPS}-step kernel periodic DMC block",
                             PBC_TRACE_NSTEPS, traced(lambda: qdmc_block("traced", qtrace)),
                             qtk * PBC_TRACE_NSTEPS / PBC_TIMED_NSTEPS)

    per_point_64 = (p32["redesigned"]["value_mo"]["device_ms"] * 1e6
                    / p32["redesigned"]["value_mo"]["points"])
    c64, c32, slaunches, mlaunches, ours_sj = casci_phases(t_start, card, counters, per_point_64)
    opt = optimization_phases(t_start, card, counters, tk / TIMED_NSTEPS)
    c3 = config3_phases(t_start, card, counters, opt)
    tw = twist_phases(t_start, card, counters, pconfigs)
    obs = observables_phases(t_start, card, counters, pconfigs)
    fd, h2o_mf = front_door_phases(t_start, card, counters)
    t34 = time.perf_counter()
    rs = restart_phases(t_start, card, counters)
    cx = complex_opt_phase(t_start, card, counters, h2o_mf)
    t34 = time.perf_counter() - t34
    print(f"phases 34-35: {rs['phase34_seconds']:.1f} + {cx['phase35_seconds']:.1f} = "
          f"{t34:.1f} s (their budget 60 s)", flush=True)
    t36 = time.perf_counter()
    ms = mesh_phases(t_start, card, counters)
    ew = ewald2d_phase(t_start, card)
    t36 = time.perf_counter() - t36
    print(f"phases 36-37: {ms['phase36_seconds']:.1f} + {ew['phase37_seconds']:.1f} = "
          f"{t36:.1f} s (their budget 60 s)", flush=True)
    total = time.perf_counter() - t_start
    # phase 17 (the H2O optimization; 75.2 s on the host whose total set the budget) is
    # the host's yardstick
    print(f"total {total:.1f} s; phase 17 {opt['seconds17']:.1f} s; the total scaled to a phase "
          f"17 of 75.2 s: {total * 75.2 / opt['seconds17']:.1f} s", flush=True)

    def device_ms(ours, *names):
        found = [ours[n][1] for n in ours if n.split("<")[0] in names]
        return sum(found) if found else None

    def pbc_device_ms(ours, dmc):
        """The periodic sweep's instance of one mode (template <T, DMC>)."""
        found = [v[1] for n, v in ours.items()
                 if n.startswith("pbc_sweep_kernel<") and n.rstrip(">").endswith(str(dmc).lower())]
        return sum(found) if found else None

    replaces = {"vmc_sweep": "pyqmc_tpu/ops/move_pallas.py:278",
                "ecp_energy": "pyqmc_tpu/ops/move_pallas.py:1151",
                "dmc_sweep": "pyqmc_tpu/ops/move_pallas.py:278",
                "tmove_sweep": "pyqmc_tpu/ops/move_pallas.py:727",
                "value_mo": "pyqmc_tpu/ops/gto_pallas.py:184",
                "gto_eval": "pyqmc_tpu/ops/gto_pallas.py:29",
                "pbc_sweep": "pyqmc_tpu/ops/move_pallas_pbc.py:206",
                "pbc_dmc_sweep": "pyqmc_tpu/ops/move_pallas_pbc.py:206 (dmc)"}
    kernels = []
    for name in h2o_kernels:
        on_vmc = name in ("vmc_sweep", "ecp_energy")
        n = (launches if on_vmc else dlaunches)[name]
        check(n > 0 and dlaunches[name] > 0, f"{name} was not launched on its path")
        r = r32[name]
        trace_names = {"vmc_sweep": ("sweep_kernel",), "dmc_sweep": ("sweep_kernel",),
                       "ecp_energy": ("ecp_energy_kernel",),
                       "tmove_sweep": ("tmove_sweep_kernel",)}[name]
        entry = {
            "name": name, "route": "cuda", "source": f"pyqmc_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": n, "launches_dmc_path": dlaunches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "device_ms": device_ms(ours_vmc if on_vmc else ours_dmc, *trace_names)}
        red = r32["redesigned"].get(name)
        if red is not None:
            entry.update({"device_event_ms": red["device_ms"],
                          "wrapper_event_ms": red["wrapper_ms"],
                          "bound_share": red["bound_share"]})
        # the optimization path (phases 17-18)
        entry.update({"launches_opt_per_iteration": opt["opt"][name] // opt["iterations"],
                      "launches_opt_vmc": opt["opt_vmc"][name],
                      "launches_opt_dmc": opt["opt_dmc"][name]})
        if on_vmc:
            entry["device_ms_sr_block"] = device_ms(opt["sr"], *trace_names)
        kernels.append(entry)
    for name in periodic:
        main_path = qlaunches if name == "pbc_dmc_sweep" else plaunches
        check(main_path[name] > 0 and qlaunches[name] > 0,
              f"{name} was not launched on its periodic path")
        r = p32[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"pyqmc_tpu_torch/csrc/{'pbc_sweep' if name == 'pbc_dmc_sweep' else name}.cu",
            "replaces": replaces[name],
            "launches": main_path[name],
            "launches_periodic_dmc_path": qlaunches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
        # BASELINE config 5 (phases 24-26): the general twist runs no K7; the
        # average's launches per twist (the TRIM one, the general one)
        entry.update({"launches_twist_vmc": tw["vmc"][name], "launches_twist_dmc": tw["dmc"][name],
                      "launches_twist_average": [a[name] for a in tw["average"]]})
        if name in ("pbc_sweep", "pbc_dmc_sweep"):
            entry["mode"] = "dmc" if name == "pbc_dmc_sweep" else "vmc"
            entry["device_ms"] = pbc_device_ms(ours_qdmc if name == "pbc_dmc_sweep" else ours_pbc,
                                               name == "pbc_dmc_sweep")
            if name == "pbc_dmc_sweep":
                big = p64["pbc_dmc_sweep_big_tstep"]
                entry.update({"max_abs_err_float64": p64[name]["max_abs_err"],
                              "max_abs_err_float64_big_tstep": big["max_abs_err"]})
        else:
            entry["device_ms"] = device_ms(ours_pbc, f"{name}_kernel")
            entry["device_ms_periodic_dmc"] = device_ms(ours_qdmc, f"{name}_kernel")
        red = p32["redesigned"].get(name)
        if red is not None:
            entry.update({"device_event_ms": red["device_ms"],
                          "wrapper_event_ms": red["wrapper_ms"], "bound_share": red["bound_share"]})
        if name == "value_mo":
            q = p32["redesigned"]["value_mo_48000"]
            entry.update({"points": red["points"], "points_tmove": q["points"],
                          "device_event_ms_tmove": q["device_ms"],
                          "wrapper_event_ms_tmove": q["wrapper_ms"], "bound_ms_tmove": q["bound_ms"],
                          "bound_share_tmove": q["bound_share"]})
            h = p32["value_mo_h2o"]
            entry.update({"h2o_ms": h["ms"], "h2o_plain_ms": h["plain_ms"],
                          "h2o_bound_ms": h["bound_ms"], "h2o_max_abs_err": h["max_abs_err"]})
            # the multi-determinant path (phases 13-16)
            entry.update({"launches_casci_vmc": slaunches[name],
                          "launches_casci_dmc": mlaunches[name],
                          "device_ms_casci_vmc": device_ms(ours_sj, f"{name}_kernel")})
            # the three-body optimization and BASELINE config 3 (phases 20-22)
            entry.update({"launches_j3_opt_per_iteration": c3["j3_opt_per_iteration"],
                          "launches_j3_opt_vmc": c3["j3_opt_vmc"],
                          "launches_config3_vmc": c3["config3_vmc"],
                          "launches_config3_dmc": c3["config3_dmc"],
                          "device_ms_config3_vmc": device_ms(c3["config3_trace"],
                                                             f"{name}_kernel")})
            # the general twist's pair launch, 128 columns (phase 23)
            entry["device_ms_twist_vmc"] = device_ms(tw["vmc_trace"], f"{name}_kernel")
            for shape in ("ecp_chunk", "tmove"):
                c = tw["k32"][shape]
                entry.update({f"twist_{shape}_{k}": c[k] for k in (
                    "points", "columns", "device_ms", "wrapper_ms", "plain_ms", "bound_ms",
                    "bound_by", "bound_share", "max_abs_err", "max_abs_err_complex_mo")})
                entry[f"twist_{shape}_max_abs_err_float64"] = tw["k64"][shape]["max_abs_err"]
            entry.update({"twist_ecp_per_walker_max_abs_err": tw["k32"]["ecp_per_walker"][
                "max_abs_err"], "twist_ecp_per_walker_max_abs_err_float64": tw["k64"][
                "ecp_per_walker"]["max_abs_err"]})
            for shape, c in c32.items():
                entry.update({f"casci_{shape}_{k}": c[k] for k in (
                    "points", "columns", "device_ms", "wrapper_ms", "wrapper_rows_ms", "plain_ms",
                    "bound_ms", "bound_by", "bound_share")})
                entry[f"casci_{shape}_max_abs_err"] = c["max_abs_err"]
                entry[f"casci_{shape}_max_abs_err_float64"] = c64[shape]["max_abs_err"]
        kernels.append(entry)
    # the observables and the excited states (phases 27-30), each kernel's
    # launches on each of their paths
    for entry in kernels:
        entry.update({f"launches_phase{k}": v[entry["name"]] for k, v in obs.items()
                      if k != "k3_errors"})
        if entry["name"] == "value_mo":
            entry["observables_k3_against_plain"] = obs["k3_errors"]
        # the front door (phases 32-33): each recipe run's launches
        entry.update({f"launches_{k}": v[entry["name"]] for k, v in fd.items()
                      if k != "phase31_seconds"})
        # the restarts and traces (phase 34), the complex optimization (phase 35), the
        # walker mesh (phase 36: rank 0's of the two ranks)
        entry.update({f"launches_{k}": v[entry["name"]] for k, v in {**rs, **cx, **ms}.items()
                      if not k.endswith("_seconds")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
