#!/usr/bin/env python3
"""Smoke test of quflow_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the repository root; it needs one CUDA device, nvcc, g++, and
nothing of JAX.  Twenty-six phases, one line each (phases 14-19 and
22-25 one for each of their parts); any failure ends the run with a
nonzero exit code and no result line.  The step runners replay CUDA graphs
wherever their builders' rule captures (parallel/capture.py): phases
4, 5, 7-10, 13-17, 20, 22, 23c-f and 25 run captured, callable hooks with
their steps (14a-c, 14e, 25d); the adaptive runs (``isomp``, ``magmp``
and the builders under ``tol`` off a mesh: phases 10, 11, 13, 14c-d, 17e,
21, 22d-f and 24) run one launch a step, the fixed point a WHILE node on
the card whose passes ``loop_pass`` ends (the residual, dW written back
and the exit rule in one kernel), and read their counts once a call; each
comparison with a column solve's plain version (phases 4, 7, 10, 14a-b,
14e, 15d, 22a-c, 25c) runs eagerly, inside ``config.eager()``, since a
captured plain solve is thousands of graph nodes; phases 21, 22, 24 and
25 hold the replays to eager runs.

1. device  - the card's name and power limit, as nvidia-smi reports them;
2. build   - nvcc builds csrc/shear_thomas.cu, csrc/shear_scan.cu,
             csrc/shear_block.cu, csrc/row_thomas.cu, csrc/graph_loop.cu
             and csrc/cgemm_tf32x3.cu for sm_90a, one compiler each,
             started together (seconds, ptxas register counts);
3. kernel  - ``shear_thomas`` against its plain PyTorch version on the card
             at N in {512, 1024, 2048, 4096} (the two main-path shapes and
             larger ones), batch in {1, 4, 8}, complex64 and complex128:
             bit-equal (max abs error 0); the kernel's time (CUDA graph
             replay), the plain version's (CUDA events), the bound and the
             kernel's share of it;
4. main path, complex64, N=1024 - EulerFlow initial data, ``solve`` with
             ``IsompTorch(maxit=5)`` built without ``device=``, as the README
             does (the default device, the card), 100 steps,
             energy/enstrophy logged every 20: the kernel launched exactly
             steps x maxit times plus once per energy log, enstrophy drift
             <= 1e-4, and a 10-step run through the kernel equal to one
             through the plain solve to <= 1e-5 relative; steps/s;
5. main path, complex128, N=512, 200 steps - relative drift of tr(W^2) and
             tr(W^3) <= 1e-10; steps/s;
6. scan    - ``shear_scan`` against its plain version on the card at the
             shapes of phase 3: bit-equal; times as in phase 3, of
             ``shear_thomas`` on the same input too, the relative
             difference of the two kernels, the bound and the share; then,
             untimed, bit-equal at ragged shapes that cross the kernel's
             seams (N in {1, 7, 100, 257, 1000}: below one chunk, a short
             last chunk, chunks that do not fill the cluster's blocks, a
             last tile of one or two columns; batch in {1, 3});
7. MHD path, complex64, N=1024 - MHDFlow initial data, ``solve`` with
             ``MagmpTorch(maxit=5)`` under QUFLOW_PALLAS_KERNEL=scan, 100
             steps, invariants logged every 20 (kinetic + magnetic energy,
             cross helicity, as benchmarks/mhd_device.py computes them):
             the integrator launched ``shear_scan`` exactly steps x maxit
             times and ``shear_thomas`` never (the logs' solves counted
             apart), energy drift <= 1e-4, Theta's spectrum drift
             max|dlambda|/max|lambda| <= 1e-4, 10 steps through the kernel
             equal to 10 through the plain scan to <= 1e-5 relative (and
             the difference against the Thomas kernel); steps/s;
8. MHD path, complex128, N=512, 200 steps through ``shear_scan`` -
             relative drift of tr(Theta^2) and tr(Theta^3) <= 1e-10; cross
             helicity drift; steps/s;
9. MHD path, complex64, N=4096, 5 steps of the card-resident stepper
             through ``shear_scan``: finite; launches; steps/s;
10. reference path, complex128, N=1024 - the README's call: EulerFlow
             initial data, ``solve(W0, stepsize=0.25, steps=100,
             steps_out=20)`` with no integrator and no device (``isomp``,
             tol 'auto', maxit 10, on the card), energy/enstrophy logged:
             ``shear_thomas`` launched once per fixed-point iteration (the
             stats' average times the steps) plus once per energy log, one
             host sync a call (the device loop's sums; an iteration in the
             CPU's host loop); the Casimir drift under tol 'auto'
             reported, and the gate: the same run at tol=1e-12, compsum,
             maxit=20 drifts tr(W^2), tr(W^3) <= 1e-10; 10 steps through
             the kernel equal to 10 through the plain column solve to
             <= 1e-12 relative; iterations a step, steps/s, and the share of
             host time spent in the per-iteration ``.item()``;
11. reference path, complex64, N=1024 - ``GlobalQGFlow(gamma=1).step``
             (``isomp`` with ``solve_globalqg``), 50 steps under
             QUFLOW_PALLAS_KERNEL=scan: ``shear_scan`` launched once per
             iteration and ``shear_thomas`` never; finite; enstrophy drift
             <= 1e-3 (tol 'auto' in complex64 is float32-scale); the
             seconds of the QG operator's first use (host factorization
             and upload), then steps/s;
12. the Poisson family on the card, N=1024, complex128 and complex64 -
             ``solve_poisson``, ``solve_heat``, ``solve_helmholtz``,
             ``solve_viscdamp`` (theta 1 and 0.5) and ``solve_globalqg`` on
             a seeded skew-Hermitian matrix: one launch a call, the kernel
             bit-equal to the same call with the plain column solve,
             complex128 within 1e-12 relative of a host float64 reference
             (scipy banded solves, column by column) and complex64's error
             against it reported; laplace(solve_poisson(W)) = W to 1e-10;
13. reference MHD path, complex128, N=512 - 50 steps of
             ``MHDFlow.step`` (``magmp``) at tol=1e-12, maxit=20: one
             launch per iteration (``laplace`` of Theta launches none);
             tr(Theta^2), tr(Theta^3) drift <= 1e-10; steps/s;
14. the hooked production stepper:
    a. forced-dissipative QG, complex64, N=1024 - ``GlobalQGFlow.stepper``
       with diagnostics, a timed forcing cos(t) F0 (F0 band-limited,
       l in [8, 12], 1e-2 of W0's norm) and the viscdamp Strang splitting
       (theta 0.5), 100 steps in calls of 20 on a card tensor: exactly
       steps (maxit + 2) + calls ``shear_thomas`` launches (the fixed-point
       solves, the two Strang half-steps, the diagnostics), none of the
       scan; 10 steps through the kernel equal to 10 through the plain
       solve to <= 1e-5 relative; steps/s beside phase 4's;
    b. the same under QUFLOW_PALLAS_KERNEL=scan, 20 steps in one call:
       ``shear_scan`` alone, 20 (maxit + 2) + 1 launches; 10 steps against
       the plain scan to <= 1e-5;
    c. the same configuration in complex128 at N=512 as a stepper with
       tol=1e-300, minit=maxit=5 and as ``isomp`` with the callable
       Hamiltonian, forcing and Strang splitting, 20 steps each: within
       1e-11 of max|W|; the stepper's host syncs, one a call (its counts);
    d. adaptive tol, Euler complex128, N=1024 - ``build_step_fn(tol=1e-12,
       minit=1, maxit=20, compsum=True)``, 100 steps in calls of 20: one
       launch an iteration and one host sync a call, the trajectory within 1e-11
       relative of phase 10's gate run (``isomp``, the same tol), mean
       iterations a step within 0.1 of its, tr(W^2), tr(W^3) drift
       <= 1e-10;
    e. MHD hooks, complex64, N=1024, under QUFLOW_PALLAS_KERNEL=scan -
       ``build_mhd_step_fn`` with a fixed full-state forcing and the heat
       Strang splitting (both components in one launch), 20 steps:
       20 (maxit + 2) ``shear_scan`` launches; 5 steps against the plain
       scan to <= 1e-5;
    f. ``solve`` of a card tensor with ``IsompTorch`` (complex64, N=1024,
       100 steps, outputs every 20): a card tensor back, no host copy of
       any tensor (``Tensor.cpu``/``numpy``/``item``/``tolist`` counted),
       steps/s beside phase 4's numpy figure;
15. ensembles (``batched=True``):
    a. Euler, complex64, N=1024, maxit 5, B in {1, 4, 16} members
       (EulerFlow initial data of seeds 42, 43, ...), two calls of 20
       steps: exactly 40 x 5 ``shear_thomas`` launches whatever B (one
       launch solves every member); per-state steps/s; from one profiled
       call the card's ms a step (torch.profiler, the kernels' own time),
       ``shear_thomas``'s ms a step, and the share of the step the card
       idles;
    b. each member of the B=16 ensemble against its own unbatched run
       over 10 steps: within 1e-5 of max|W|;
    c. Euler, complex128, N=512, B=8, 200 steps: tr(W^2), tr(W^3) drift
       <= 1e-10 on every member;
    d. MHD, complex64, N=1024, B=4, heat Strang splitting, 20 steps under
       QUFLOW_PALLAS_KERNEL=scan: 20 (maxit + 2) ``shear_scan`` launches,
       each fixed-point solve of B=4 and each Strang half-step of 2 B = 8
       (both components of every member); 5 steps against the plain scan
       to <= 1e-5;
    e. ``shear_thomas`` at N=1024, B=16 and ``shear_scan`` at N=1024, B=2
       against their plain versions, as in phases 3 and 6 (bit-equal,
       times, bounds);
16. persistence and distribution on the card:
    a. ``IsompTorch(warm=False)``, complex64, N=1024: two calls of 20
       steps against 20 steps, ``save_checkpoint``, ``load_checkpoint``
       and 20 steps: bit-equal;
    b. a one-rank NCCL process group through ``initialize`` and
       ``global_mesh``: phase 15a's B=16 run on the mesh, bit-equal with
       the same launches; then the mesh's adaptive runs, Euler B=16 (phase
       15a's ensemble) and MHD B=4 under QUFLOW_PALLAS_KERNEL=scan,
       complex64, N=1024, tol 1e-6, maxit 10, 5 steps: one launch of the
       composite a step, its WHILE body split around the captured
       all_reduce of the residual's key (``loop_pass``'s key mode, the
       reduce's child, ``loop_decide``; the node types of the body and of
       the reduce's graph printed), one host read a call, one all_reduce,
       one key-mode pass and one ``loop_decide`` an iteration (counted
       over the run), bit-equal to the same run off the mesh with the same
       counts; steps/s against the host loop of the same mesh (the parent
       path, ``_AdaptiveGraphs``) in turns (loop, host, host, loop), both
       bit-equal, reported only.  A one-rank group proves the mechanics,
       not the max across ranks; NCCL refuses a second rank on one card.
       Both new entries at these runs' shapes against their plain
       versions: the key mode's dW bit-equal and its key's residual within
       2 N u, ``loop_decide`` on keys through the rule's edges, the words
       and rn bit-equal; their ms (CUDA-graph replay), bounds, plain ms,
       and the library's residual and copy beside the key mode.  16b runs
       last, after phase 25: run before phase 21 in the full sequence,
       the profiles of the device loops that follow showed none of their
       WHILE bodies' kernels (phase 21 failed on it; alone, 16b and a
       device-loop profile after it pass);
17. the warm (mixed-precision) schedule, complex64, N=1024 - since
    ``warm_precision='auto'`` resolves to 'high' for complex64 at
    'highest', phases 4, 7, 14f and 16a already run it through
    ``IsompTorch()``/``MagmpTorch()``:
    a. ``IsompTorch()`` against ``IsompTorch(warm_precision=None)``, 1000
       steps in calls of 100 from the README state: exactly 5
       ``shear_thomas`` launches a step in both; the enstrophy (tr(W^2))
       drift <= 1e-4 in both and the tr(W^3) drift; the largest deviation
       of the two trajectories; the GEMM kernels a step from a profile:
       6 TF32 and 4 full-precision warm, 10 full-precision not (the
       kernels told apart by one profiled product with TF32 on and one
       with it off, named in the line);
    b. phase 15a's B=16 ensemble with warm_precision 'high' against None,
       read in turns in one process: per-state steps/s, CGEMM ms a step,
       the idle share;
    c. phase 7 (``MagmpTorch()``, warm) against the same run with
       ``warm_precision=None``: the energy and Theta spectrum gates
       (<= 1e-4 over 100 steps) in both;
    d. precision 'highest_karatsuba' against 'highest', 100 steps: the
       deviation, the GEMM ms a step of each;
    e. adaptive tol (1e-6, maxit 10) with a warm prefix of 2: the counts a
       step leave the prefix out (launches = steps x 2 + their sum);
18. the modules of the last slice on the card:
    a. ``build_shr2mat_fn``/``build_mat2shr_fn`` in complex128 against
       the host ``shr2mat``/``mat2shr`` at N=1024, lmax 10 and 128:
       within 1e-12 relative, the round trip too; ``basis_tensor``'s
       host seconds, each map's ms;
    b. ``build_synthesis_fn``/``build_analysis_fn`` at L=256 in float64
       against the host Gauss-Legendre transform within 1e-10, and the
       round trip; float32's errors; ms;
    c. ``native.solve_poisson_native`` (g++ builds native/quflow_host.cpp
       into quflow_tpu_torch/_build/) against ``solve_poisson`` on the
       card, complex128, N=512: within 1e-13 N; one launch.

19. the row-sharded solve and the tp step:
    a. ``shear_block`` (one rank's block sweeps) at N in {512, 1024,
       4096}, complex64 and complex128, batch in {1, 4}, with the row
       blocks of tp in {2, 3, 4} (3 gives uneven blocks) folded in one
       process as the ranks fold them: bit-equal to its plain version;
       the folded result within 1e-13 of ``shear_thomas`` over the whole
       column in complex128, relative to the largest entry; in complex64
       against the float64 solve of the same float32 system, within 1e-6
       or three times the serial solve's own error, the larger (a float32
       solve of the ill-conditioned low-m columns errs by ~1e-5 at
       N=4096, serial or folded), its difference from ``shear_thomas``
       reported raw and after the m=0 correction.  Then one rank's
       launches at (N, tp, B) in (1024, 2, 1), (4096, 4, 1), (1024, 2, 4)
       and (8192, 4, 1), both dtypes: each phase bit-equal to the plain
       version; the three launches and each phase alone timed (CUDA-graph
       replay), the plain version's time, the bound of its rows and the
       share, the floor of three launches separated by collectives (64 B
       an element at complex64, B=1) and its share, the kernel's
       geometry;
    b. MHD, complex64, N=1024, ``MagmpTorch()`` on a tp = 2 mesh of two
       processes sharing the card (this script run with ``--tp-rank``),
       20 steps, against one-rank ``MagmpTorch()``: within 5e-5 of the
       largest entry; each rank launches ``shear_block`` exactly 3 times
       an iteration and gathers rows 6 times; steps/s of both.  NCCL is
       tried first, then gloo; a backend that refuses two ranks on one
       card at set-up (the group's bring-up and a probe of each
       collective) is named with its message; if both refuse, the run
       fails, and so does any failure after the probe;
20. the double-word steppers, N=512: ``build_dw_step_fn`` 200 steps and
    ``build_dw_mhd_step_fn`` 50 steps, maxit 5, dw_iters 2, float64
    planes: tr(W^2), tr(W^3) and tr(Theta^2), tr(Theta^3) drift
    <= 1e-10; one ``shear_thomas`` launch an iteration; the GEMM kernels
    a step by name (6 CGEMM + 4 ZGEMM for Euler, 12 + 8 launches of its
    18 + 12 products for MHD); steps/s of the dw and the complex128 Euler
    steppers in turns, beside phase 5's.

21. CUDA-graph replay against eager, in turns in one process (eager,
    replay, replay, eager), each run built or called inside
    ``config.eager()`` for its eager turns: Euler N=1024 c64 (warm
    'high') at B=1 and B=16, Euler N=512 c128, MHD N=1024 c64 (warm,
    ``shear_scan``), phase 14d's adaptive c128 N=1024 stepper, ``isomp``
    N=1024 c128 (tol 'auto') and ``MHDFlow.step`` (``magmp``) N=512 c128
    at tol 1e-12: the final states bit-equal (or the cuBLAS kernels that
    differ named), the same launches, steps/s of each turn, from a
    profiled call of each mode the card's ms a step, kernels a step, the
    solve's launches a step against the counters' and the idle share;
    the graph pool's bytes; a replay's outputs not overwritten by the next
    call.

22. hooked runs replayed against eager, as phase 21 reads them (in turns,
    eager, replay, replay, eager), each callable hook captured with its
    step and every replay bit-equal to its eager run; a call is two calls
    of 20 steps, the second at t0 advanced by 20 steps where a hook takes
    time (a time frozen into a graph shows as a difference):
    a. forced-dissipative QG, complex64, N=1024, maxit 5, the warm
       schedule: phase 14a's timed forcing cos(t) F0 (``torch.cos`` of
       the 0-d time tensor) and viscdamp Strang step, ``shear_thomas``;
    b. the same under QUFLOW_PALLAS_KERNEL=scan, ``shear_scan``;
    c. phase 14e's MHD hooks (a constant forcing, the heat Strang step)
       under the scan, complex64, N=1024;
    d. the custom-Hamiltonian stepper, complex128, N=512: phase 14c's
       callable ``solve_globalqg`` Hamiltonian and ``solve_viscdamp``
       Strang step, the timed forcing, tol 1e-12 (the captured
       iteration);
    e. ``isomp``, complex128, N=512, with phase 14c's three callables
       (its Strang step a graph of its own); and phase 14c's stepper held
       to it within 1e-11 of max|W|, both replayed;
    f. ``magmp``, complex128, N=512, with a constant forcing, tol 1e-12;
    then 22a-c's kernels against their plain solves inside
    ``config.eager()`` (10, 10 and 5 steps, <= 1e-5); and
    g. a forcing that returns numpy raises TypeError at its runner's first
       call and one that reads time on the host raises RuntimeError, each
       naming itself and ``config.eager()``, inside which both run.

23. the row-packed and interleaved layouts, the planes stepper and the
    wrapped relayout (stepsize 0.25 hbar, ``random_initial(lmax=10,
    seed=42)``):
    a. ``row_thomas`` against its plain version at N in {512, 1024, 2048,
       4096} and ragged N in {1, 6, 7, 100, 257, 514, 1000}, R in {N,
       N//2+1}, B in {1, 4} (and 16 up to N = 1024), both dtypes; at N in
       {6, 7, 257, 514, 1000} on a d one complex value into its buffer
       and on its aligned twin, with y resident and with the launch plan
       forced to send y through the output; on rows too long for shared
       memory (c64 N=32768, c128 N=16384); one launch a solve; the
       real-lane entries of ``shear_thomas`` and ``shear_scan`` on float
       planes (L = N+1, B = 2) and on the interleaved view (L = 2(N+1)),
       there also against the complex entry on the same bytes, at N in
       {7, 100, 512, 1000, 1024, 4096}, both dtypes, at N = 100 and 1000
       on a d one value into its buffer, and each side of the first edge
       above N = 1024 of each entry's launch plan (y resident for
       ``shear_thomas``; mode, late or cluster for ``shear_scan``):
       bit-equal, one launch a solve;
    b. their times by CUDA-graph replay: ``row_thomas`` at Euler N=1024
       c64 for R = 1024 and 513, at B = 4, at c128 N=512 and at N=4096,
       each with its launch plan; the real lanes at N=1024 on float32
       planes, B = 2, and on the interleaved view, on the float64
       interleaved view at N=512 and on float32 planes at N=4096; each
       beside its bound ((16 B + 12) R N bytes; (8 B + 12) N L in
       float32, twice in float64) and share, the plain version's ms, the
       launch plan and the library's geometry of it;
    c. the Euler stepper in each layout ('wrapped', 'rolls', 'pallas',
       'scatter', 'shear_pallas_il' and its scan twin, and 'shear' under
       QUFLOW_SHEAR_INTERLEAVE=1), complex64 N=1024 100 steps (enstrophy
       drift <= 1e-4, within 1e-5 of the 'shear' run) and complex128
       N=512 200 steps (drift <= 1e-10, within 1e-11): maxit launches a
       step of the layout's kernel and none of another; 'pallas' at
       N=4096 warns and runs 5 steps on the shear path;
    d. MHD on 'rolls' and 'pallas', complex128 N=512 50 steps within
       1e-11 of the 'shear' run, complex64 N=1024 20 steps (drift gates);
    e. ``build_planes_step_fn`` at N=1024, 100 steps, warm and pure
       (enstrophy gate, 5 real-lane launches a step, the pure run within
       1e-5 of the complex 'highest_karatsuba' builder), and N=4096, 5
       steps;
    f. 'pallas', 'shear_pallas_il' and the planes stepper replayed against
       eager, as phase 21 reads them, bit-equal;
    g. 'shard' (N=512, c64 and c128) and 'scatter' (N=511) Euler on a
       tp = 2 gloo mesh of two processes sharing the card, 10 steps,
       within phase 19b's gate against one rank; ``row_thomas`` once an
       iteration, and on 'shard' one ``all_to_all`` and one ``shift`` a
       pack and an unpack.

24. the adaptive fixed point on the card (the device loop):
    a. ``loop_pass`` against its plain version at N in {1, 7, 256, 1000,
       1024, 4096} (complex64, complex128, float32 planes, MHD's two
       complex128 components) and at B=16 (N=1024, both dtypes, MHD
       complex64): dW and the state's words bit-equal, rn within 2 N u rn;
       ``loop_pass`` and ``loop_decide`` on crafted residual sequences
       (the exit by tol and at rn == tol, the stall and rn == rn_old, NaN
       to maxit, minit, the cap, a float32 edge), float32 and float64, two
       steps each: the words equal after every decision; ``loop_pass``'s
       ms (CUDA-graph replay) at 24b's shapes, N in {256, 512, 1024} in
       both dtypes and B=16, beside its bound (dW_new and dW read, dW
       written), the sequence it replaced (the residual in torch, the
       copies of rn, dW and the rest, ``loop_decide``) in turns, the
       library's residual and copy, and the plain version's; the WHILE
       node's ms a pass with an empty iteration;
    b. each run through the device loop against its ``config.eager()``
       twin (the host loop), in turns (eager, loop, loop, eager): the
       README quickstart ``solve(W0, stepsize=0.25, ...)`` with the default
       ``isomp`` at N=256 and N=1024 in complex128 (100 steps, outputs
       every 20), ``magmp`` c128 N=512, ``build_step_fn`` c128 N=1024
       under tol 1e-12, MHD c64 N=1024 under tol 1e-6, and phase 22d's
       custom-Hamiltonian stepper: bit-equal, the same iterations;
       steps/s, host and device ms a step and the idle share (the loop's
       device ms by CUDA events around the call, since the profiler need
       not show every pass of a WHILE body; beside it the idle share from
       the profile's kernel time, exact where it showed every pass),
       iterations a step, host reads a call (<= 2), launches of the solve
       and of ``loop_pass`` by counter (equal in both loops) and by
       profile; kernel ms a step split into the iteration and the pass,
       the device loop's against the host loop's; the WHILE body's nodes
       (the iteration's graph and ``loop_pass``, no copy).

25. the Runge-Kutta integrators on the card (``euler``, ``heun``, ``rk4``
    of integrators/erk.py: one step a CUDA graph, captured once for each
    configuration and replayed ``steps`` times a call, 1, 2 and 4 column
    solves a step):
    a. each method at complex64 N=1024 and complex128 N=512 from the main
       path's state, 50 steps, replayed against ``config.eager()`` as
       phase 21 reads them: bit-equal, launches exactly steps x (1, 2, 4)
       by counter and by profile, steps/s in turns, kernel ms a step and
       the idle share, the top kernels, the GEMM kernels a step told
       apart as 17a tells them (2 full-precision a solve, no TF32); each
       run again from no kept graph at 50 and 20 steps: one capture for
       both calls, the second bit-equal to eager; the drift of tr(W^2)
       and of the energy beside ``isomp``'s over the same steps
       (reported, not gated: these methods do not conserve them);
    b. ``rk4`` complex64 N=1024 under QUFLOW_PALLAS_KERNEL=scan, as 25a:
       ``shear_scan`` 4 a step, ``shear_thomas`` none, bit-equal;
    c. ``rk4`` complex64 N=1024, 10 steps replayed through ``shear_thomas``
       and ``shear_scan``, each against the same steps inside
       ``config.eager()`` through its plain version: <= 1e-5 relative;
    d. ``rk4`` complex64 N=1024 with a constant band-limited forcing
       (phase 14a's F0) captured with its step, as 25a: bit-equal; a
       forcing that returns numpy raises TypeError and one that reads the
       host raises HookError, each naming itself and ``config.eager()``,
       inside which both run;
    e. ``solve(W0, dt, steps=100, steps_out=20, integrator=rk4)`` on a
       numpy complex128 state at N=512: one capture across its five
       chunks, 400 ``shear_thomas`` launches, the state equal to the same
       solve inside ``config.eager()``; steps/s of both.

26. the 'highest' complex64 product (ops/cgemm.py, csrc/cgemm_tf32x3.cu:
    three TF32 passes over a big/small split on the tensor cores): against
    its plain version (within 2^-20 max |A||B|) and against float64, beside
    cuBLAS's float32 CGEMM, at N in {1024, 513, 100}, batched, broadcast,
    MHD's strided Theta and a tp row block; its ms at the benchmark cells'
    shapes by CUDA-graph replay (the split's and the product's from a
    profile) beside its bound (24 M N K on 495 TFLOP/s TF32), the plain
    version's and the library's (float32 CGEMM; one-pass TF32 beside it).
    Its launches are read from the paths' own runs: phases 4, 7, 14a-b,
    15a, 15d and 16b hold them to 2 (Euler) or 4 (MHD) an iteration at
    'highest' on the card and to none on the CPU.

Every path (phases 4, 5, 7-25) runs with every launch count set to 0 just
before it and read just after; a replay adds the launches its graph
recorded at capture (the warm-up's and the capture's own are taken
back), a device loop the launches of its pieces once a step and of its
iteration, and ``loop_pass``'s (split over a mesh: its key mode's, the
all_reduce's and ``loop_decide``'s), once an iteration, from the counts it
reads once a call.  Then a JSON line of the kernels
(name, source, the TPU kernel it replaces, launches on each path, error,
times and bound at the main path's shape; ``library_ms`` null for the
solves, since no PyTorch call solves banded or tridiagonal systems, and
for ``loop_pass`` the matrix inf-norm and a copy) and, last, the result
line ``{"ok": true, "device": {...}}``.

The bound of a column solve is the larger of its bytes (d, w, binv, u read
once, x written once) over 3.35 TB/s and its 10 real operations an element
(re and im: a multiply and a subtract forward, two multiplies and a
subtract backward) over the card's peak outside the tensor cores (67
TFLOP/s float32, 34 float64): NVIDIA's data sheet of the H100 SXM.
"""

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from scipy.linalg import solve_banded

from quflow_tpu_torch import (
    config,
    energy_euler,
    enstrophy,
    hbar,
    isomp,
    magmp,
    random_shr,
    shr2mat,
    solve,
)
from quflow_tpu_torch.integrators import erk, isospectral
from quflow_tpu_torch.laplacian import tridiagonal
from quflow_tpu_torch.models import EulerFlow, GlobalQGFlow, MHDFlow
from quflow_tpu_torch.ops import (
    cgemm,
    cuda_block_solve,
    cuda_build,
    cuda_graph_loop,
    cuda_row_solve,
    cuda_scan_solve,
    cuda_solve,
)
from quflow_tpu_torch.ops.cuda_block_solve import (
    BACKWARD,
    FORWARD,
    SUMMARY,
    shear_block,
    shear_block_reference,
)
from quflow_tpu_torch.ops.laplacian import (
    laplace,
    solve_globalqg,
    solve_heat,
    solve_helmholtz,
    solve_poisson,
    solve_viscdamp,
)
from quflow_tpu_torch.ops.tridiag import refine_m0, shear_operator
from quflow_tpu_torch.ops.cuda_graph_loop import (
    key_of,
    key_value,
    loop_decide,
    loop_decide_reference,
    loop_pass,
    loop_pass_reference,
    new_key,
    new_scratch,
    residual_,
)
from quflow_tpu_torch.ops.cuda_row_solve import row_thomas, row_thomas_reference
from quflow_tpu_torch.ops.cuda_scan_solve import (
    shear_scan,
    shear_scan_reference,
)
from quflow_tpu_torch.ops.cuda_solve import shear_thomas, shear_thomas_reference
from quflow_tpu_torch.parallel import capture, stepper
from quflow_tpu_torch.parallel.mesh import Mesh, all_reduce_max_
from quflow_tpu_torch.parallel.shard_shear import (
    ShardedShearOperator,
    solve_shear_blocks,
)
from quflow_tpu_torch.parallel.stepper import (
    IsompTorch,
    MagmpTorch,
    _laplace_core,
    _mhd_lap_op,
    _real_factors,
    build_dw_mhd_step_fn,
    build_dw_step_fn,
    build_mhd_step_fn,
    build_step_fn,
    to_planes,
)

#: the column solves, whose counts every single-device path reads;
#: shear_block, the row-sharded solve's kernel, is reset with them and read
#: by the tp path (phase 19b)
KERNELS = (shear_thomas, shear_scan)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.complex64: 67e12, torch.complex128: 34e12}


#: 'highest' complex64 products an iteration of the fixed point: Euler's
#: P W and (P W) P; MHD's P (W, Theta), (P W, P Theta) P, B Theta and
#: (B Theta) P
EULER_GEMMS, MHD_GEMMS = 2, 4


def reset_counts():
    for k in (*KERNELS, shear_block, row_thomas, loop_decide, loop_pass,
              cgemm.cgemm):
        k.launches = 0
    for k in KERNELS:
        k.real_launches = 0
    loop_pass.key_launches = 0
    all_reduce_max_.calls = 0


def read_counts():
    return {k.__name__: k.launches for k in KERNELS}


def read_gemm():
    """Launches of the 'highest' complex64 product (ops/cgemm.py) since
    :func:`reset_counts`; apart from :func:`read_counts`, whose dicts the
    paths compare whole with their column solves'."""
    return cgemm.cgemm.launches


def full_iterations(integrator):
    """Fixed-point iterations a step at ``integrator``'s precision: all but
    the warm schedule's prefix (stepper._schedule)."""
    warm = stepper._schedule(integrator.precision, integrator.warm_precision,
                             integrator.warm_iters, integrator.maxit,
                             integrator.dtype)[1]
    return integrator.maxit - warm


def check_gemm(device, gemms, per_step, steps, what=""):
    """Raise unless a path launched the 'highest' complex64 product
    ``per_step`` x ``steps`` times on the card, and never on the CPU
    (whose 'highest' is ``torch.matmul``)."""
    want = per_step * steps if on_card(device) else 0
    if gemms != want:
        raise AssertionError(f"{what}cgemm: {gemms} launches, expected "
                             f"{want}")


def on_card(device):
    """Whether runs on ``device`` go through the compiled runners: the
    adaptive loops then read their counts once a call (the device loop),
    where the CPU's host loop reads the residual once an iteration."""
    return torch.device(device).type == "cuda"


def ptxas_summary(log):
    """The register and spill lines of nvcc's ``-Xptxas -v`` report."""
    return " | ".join(ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln)


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the card: ``reps`` calls
    captured in one CUDA graph after a warm-up call, the graph replayed
    once and then timed by CUDA events, so that the host's time to launch
    does not enter a kernel's."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def solve_bound(N, B, dtype, rows=None):
    """The least time (ms) the card could take for a column solve of B
    complex (N, N+1) arrays, or of ``rows`` of their rows (one rank's block
    sweeps), and what bounds it: 'bytes' or 'operations' (see the
    module's note)."""
    real = 4 if dtype == torch.complex64 else 8
    elements = (N if rows is None else rows) * (N + 1)
    t_bytes = (4 * real * B + 3 * real) * elements / HBM_BYTES_PER_S
    t_ops = 10 * B * elements / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def seeded_rhs(device, N, B, dtype):
    """A random (B, N, N+1) complex ``dtype`` rhs on ``device``, seeded by
    N and B."""
    g = torch.Generator(device=device).manual_seed(1000 * N + B)
    return torch.randn(B, N, N + 1, dtype=dtype, device=device, generator=g)


def solve_inputs(device, Ns, Bs):
    """(dtype, N, B, w, binv, u, d) for both dtypes, every N and B: the
    Poisson factors and a seeded random rhs on ``device``."""
    for dtype in (torch.complex64, torch.complex128):
        for N in Ns:
            w, binv, u = _real_factors(N, dtype, device=device)
            for B in Bs:
                yield dtype, N, B, w, binv, u, seeded_rhs(device, N, B, dtype)


def bit_equal(kernel, plain, dtype, N, B, w, binv, u, d):
    """``kernel`` and ``plain`` on the same input: the kernel's result and
    the max abs error, which must be 0 (the same roundings in the same
    order)."""
    x = kernel(w, binv, u, d)
    abs_err = (x - plain(w, binv, u, d)).abs().max().item()
    if abs_err != 0.0:
        raise AssertionError(
            f"{kernel.__name__} {dtype} N={N} B={B}: max abs error "
            f"{abs_err:.3e}, not bit-equal")
    return x, abs_err


def kernel_vs_plain(device, Ns=(512, 1024, 2048, 4096), Bs=(1, 4, 8),
                    reps=20, plain_reps=2, kernel=shear_thomas,
                    plain=shear_thomas_reference, against=None):
    """Phases 3 and 6: ``kernel`` against ``plain``, one row per (dtype, N,
    B): bit-equal; at B=8 one timed call of the plain version.  With
    ``against``, that kernel's time on the same input and the relative
    difference of the two."""
    rows = []
    for dtype, N, B, w, binv, u, d in solve_inputs(device, Ns, Bs):
        x, abs_err = bit_equal(kernel, plain, dtype, N, B, w, binv, u, d)
        bound_ms, bound_by = solve_bound(N, B, dtype)
        ms = graph_ms(lambda: kernel(w, binv, u, d), reps)
        row = dict(
            dtype=str(dtype).removeprefix("torch."), N=N, B=B,
            max_abs_err=abs_err, ms=ms,
            plain_ms=cuda_ms(lambda: plain(w, binv, u, d),
                             plain_reps if B < 8 else 1),
            bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms)
        if against is not None:
            other = against(w, binv, u, d)
            row[f"vs_{against.__name__}_rel"] = (
                (x - other).abs().max() / other.abs().max()).item()
            row[f"{against.__name__}_ms"] = graph_ms(
                lambda: against(w, binv, u, d), reps)
        rows.append(row)
    return rows


def ragged_bit_equal(device, kernel, plain, Ns=(1, 7, 100, 257, 1000),
                     Bs=(1, 3)):
    """``kernel`` against ``plain`` at shapes that cross the kernel's
    seams, untimed: one row per (dtype, N, B), bit-equal or it raises."""
    return [dict(dtype=str(dtype).removeprefix("torch."), N=N, B=B,
                 max_abs_err=bit_equal(kernel, plain, dtype, N, B, *rest)[1])
            for dtype, N, B, *rest in solve_inputs(device, Ns, Bs)]


class Logger:
    """A plain-Python solve callback: energy and enstrophy per output, and
    the steps and integrator stats that solve hands to each output."""

    def __init__(self):
        self.rows = []
        self.chunks = []

    def __call__(self, W, delta_time=0.0, delta_steps=0, **stats):
        self.rows.append((float(energy_euler(W)), float(enstrophy(W))))
        if delta_steps:
            self.chunks.append((delta_steps, stats))


def main_path_c64(device, N=1024, steps=100, steps_out=20, maxit=5,
                  compare_steps=10):
    """Phase 4."""
    W0 = EulerFlow(N, np.complex64).random_initial(lmax=10, seed=42)
    # no device=: the README's call, so the default device is what runs
    integrator = IsompTorch(maxit=maxit, dtype=np.complex64)
    log = Logger()
    reset_counts()
    log(W0)
    t0 = time.perf_counter()
    W = solve(W0.copy(), stepsize=0.25, steps=steps, steps_out=steps_out,
              integrator=integrator, callback=log, progress_bar=False)
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    gemms = read_gemm()
    launches = counts["shear_thomas"]
    expected = steps * maxit + len(log.rows)
    if launches != expected or counts["shear_scan"]:
        raise AssertionError(f"launches on the main path {counts}, expected "
                             f"{expected} of shear_thomas only")
    check_gemm(device, gemms, EULER_GEMMS * full_iterations(integrator),
               steps, "the main path: ")
    if W.shape != (N, N) or W.dtype != np.complex64 or not np.isfinite(W).all():
        raise AssertionError(f"bad state: {W.shape} {W.dtype}")
    Z = np.array([r[1] for r in log.rows])
    z_drift = float(np.abs(Z - Z[0]).max() / abs(Z[0]))
    if not z_drift <= 1e-4:
        raise AssertionError(f"enstrophy drift {z_drift:.3e} > 1e-4")

    # the same steps through the kernel and through the plain solve
    dt = 0.25 * hbar(N)
    Wt = torch.from_numpy(W0).to(device)
    z = torch.zeros_like(Wt)
    Wk = build_step_fn(N, dt, steps=compare_steps, maxit=maxit,
                       dtype=np.complex64, device=device)(Wt, z, z)[0]
    with config.eager():  # the plain solve: thousands of nodes a graph
        Wp = build_step_fn(N, dt, steps=compare_steps, maxit=maxit,
                           dtype=np.complex64, device=device,
                           solver=shear_thomas_reference)(Wt, z, z)[0]
    step_rel = ((Wk - Wp).abs().max() / Wp.abs().max()).item()
    if not step_rel <= 1e-5:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-5")

    # stepper throughput alone, state resident on the card
    fn = build_step_fn(N, dt, steps=steps_out, maxit=maxit,
                       dtype=np.complex64, device=device)
    st = fn(Wt, z, z)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps // steps_out):
        st = fn(*st)
    torch.cuda.synchronize()
    stepper_s = time.perf_counter() - t0
    return dict(N=N, steps=steps, maxit=maxit, launches=launches,
                expected_launches=expected, gemm_launches=gemms,
                enstrophy_drift=z_drift,
                energy_drift=float(abs(log.rows[-1][0] - log.rows[0][0])
                                   / abs(log.rows[0][0])),
                kernel_vs_plain_10_steps=step_rel,
                solve_steps_per_s=steps / solve_s,
                stepper_steps_per_s=steps / stepper_s)


def casimirs(W):
    """[tr(W^2) (real), tr(W^3) (imaginary part)] of W (..., N, N), numpy
    (..., 2)."""
    W2 = W @ W

    def trace(A):
        return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)

    return torch.stack([trace(W2).real, trace(W2 @ W).imag], -1).cpu().numpy()


def main_path_c128(device, N=512, steps=200, maxit=5):
    """Phase 5."""
    W0 = EulerFlow(N, np.complex128).random_initial(lmax=10, seed=42)
    c0 = casimirs(torch.from_numpy(W0).to(device))
    reset_counts()
    t0 = time.perf_counter()
    W = solve(W0.copy(), stepsize=0.25, steps=steps, steps_out=steps,
              integrator=IsompTorch(maxit=maxit, dtype=np.complex128,
                                    device=device), progress_bar=False)
    sec = time.perf_counter() - t0
    launches = read_counts()
    if launches != {"shear_thomas": steps * maxit, "shear_scan": 0}:
        raise AssertionError(f"launches {launches}")
    if not np.isfinite(W).all():
        raise AssertionError("non-finite state")
    drift = np.abs(casimirs(torch.from_numpy(W).to(device)) - c0) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(W^2), tr(W^3) = {drift} > 1e-10")
    return dict(N=N, steps=steps, maxit=maxit, launches=launches,
                tr_W2_drift=drift[0], tr_W3_drift=drift[1],
                solve_steps_per_s=steps / sec)


class MHDLogger:
    """A solve callback: the MHD invariants of each output, as
    benchmarks/mhd_device.py:160-169 computes them (kinetic energy through
    the Poisson solve of ``energy_euler``, magnetic energy -<B, Theta>/2
    with B the Laplacian of Theta, cross helicity <W, Theta>), on the
    card.  Counts apart the kernel launches made by its own solves."""

    def __init__(self, N, device):
        self.lap = _mhd_lap_op(N, np.complex128, device=device)
        self.device = device
        self.rows = []
        self.launches = dict.fromkeys(read_counts(), 0)

    def __call__(self, S, delta_time=0.0, delta_steps=0, **stats):
        before = read_counts()
        kinetic = float(energy_euler(S[0]))
        St = torch.from_numpy(np.asarray(S)).to(self.device, torch.complex128)
        W, Theta = St[0], St[1]
        N = W.shape[-1]
        B = _laplace_core(Theta, self.lap)
        magnetic = -0.5 * (torch.sum(B * Theta.conj()).real / N).item()
        cross = (torch.sum(W * Theta.conj()).real / N).item()
        self.rows.append((kinetic + magnetic, cross))
        for name, n in read_counts().items():
            self.launches[name] += n - before[name]


@contextlib.contextmanager
def kernel_variable(name):
    """QUFLOW_PALLAS_KERNEL set to ``name`` inside the block only."""
    saved = os.environ.get("QUFLOW_PALLAS_KERNEL")
    os.environ["QUFLOW_PALLAS_KERNEL"] = name
    try:
        yield
    finally:
        if saved is None:
            del os.environ["QUFLOW_PALLAS_KERNEL"]
        else:
            os.environ["QUFLOW_PALLAS_KERNEL"] = saved


def theta_spectrum(S, device):
    Theta = torch.from_numpy(np.asarray(S[1])).to(device, torch.complex128)
    return torch.linalg.eigvalsh(-1j * Theta)


def mhd_c64(device, N=1024, steps=100, steps_out=20, maxit=5,
            compare_steps=10, warm_precision="auto"):
    """Phase 7, with QUFLOW_PALLAS_KERNEL=scan set for this phase only;
    phase 17c runs it again with ``warm_precision=None``."""
    S0 = MHDFlow(N, np.complex64).random_initial(lmax=10, seed=42)
    lam0 = theta_spectrum(S0, device)
    with kernel_variable("scan"):
        integrator = MagmpTorch(maxit=maxit, dtype=np.complex64, device=device,
                                warm_precision=warm_precision)
        log = MHDLogger(N, device)
        reset_counts()
        log(S0)
        t0 = time.perf_counter()
        S = solve(S0.copy(), stepsize=0.25, steps=steps, steps_out=steps_out,
                  integrator=integrator, callback=log, progress_bar=False)
        solve_s = time.perf_counter() - t0
        total = read_counts()
        gemms = read_gemm()  # the logs' products are complex128
    integ = {k: total[k] - log.launches[k] for k in total}
    if integ != {"shear_thomas": 0, "shear_scan": steps * maxit}:
        raise AssertionError(f"the integrator launched {integ}, expected "
                             f"{steps * maxit} of shear_scan only")
    check_gemm(device, gemms, MHD_GEMMS * full_iterations(integrator),
               steps)
    if sum(log.launches.values()) != len(log.rows):
        raise AssertionError(f"the logs launched {log.launches} for "
                             f"{len(log.rows)} energies")
    if (S.shape != (2, N, N) or S.dtype != np.complex64
            or not np.isfinite(S).all()):
        raise AssertionError(f"bad state: {S.shape} {S.dtype}")
    E = np.array([r[0] for r in log.rows])
    e_drift = float(np.abs(E - E[0]).max() / abs(E[0]))
    if not e_drift <= 1e-4:
        raise AssertionError(f"total energy drift {e_drift:.3e} > 1e-4")
    lam = theta_spectrum(S, device)
    spec_drift = ((lam - lam0).abs().max() / lam0.abs().max()).item()
    if not spec_drift <= 1e-4:
        raise AssertionError(f"Theta spectrum drift {spec_drift:.3e} > 1e-4")
    X = np.array([r[1] for r in log.rows])

    # the same steps through the kernel, its plain version, and shear_thomas
    dt = 0.25 * hbar(N)
    St = torch.from_numpy(S0).to(device)
    z = torch.zeros_like(St)

    def run(solver, steps=compare_steps):
        return build_mhd_step_fn(N, dt, steps=steps, maxit=maxit,
                                 dtype=np.complex64, device=device,
                                 solver=solver)

    Sk = run(shear_scan)(St, z, z)[0]
    with config.eager():  # the plain scan: thousands of nodes a graph
        Sp = run(shear_scan_reference)(St, z, z)[0]
    St_thomas = run(shear_thomas)(St, z, z)[0]
    step_rel = ((Sk - Sp).abs().max() / Sp.abs().max()).item()
    if not step_rel <= 1e-5:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-5")
    vs_thomas = ((Sk - St_thomas).abs().max() / St_thomas.abs().max()).item()

    # stepper throughput alone, state resident on the card
    fn = run(shear_scan, steps_out)
    st = fn(St, z, z)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps // steps_out):
        st = fn(*st)
    torch.cuda.synchronize()
    stepper_s = time.perf_counter() - t0
    return dict(N=N, steps=steps, maxit=maxit,
                warm_precision=integrator.warm_precision,
                integrator_launches=integ, integrator_gemm_launches=gemms,
                log_launches=log.launches, energy_drift=e_drift,
                theta_spectrum_drift=spec_drift,
                cross_helicity_drift=float(np.abs(X - X[0]).max()
                                           / abs(X[0])),
                kernel_vs_plain_10_steps=step_rel,
                scan_vs_thomas_10_steps=vs_thomas,
                solve_steps_per_s=steps / solve_s,
                stepper_steps_per_s=steps / stepper_s)


def mhd_c128(device, N=512, steps=200, maxit=5):
    """Phase 8."""
    S0 = MHDFlow(N, np.complex128).random_initial(lmax=10, seed=42)
    S0t = torch.from_numpy(S0).to(device)
    c0 = casimirs(S0t[1])
    x0 = (torch.sum(S0t[0] * S0t[1].conj()).real / N).item()
    reset_counts()
    t0 = time.perf_counter()
    S = solve(S0.copy(), stepsize=0.25, steps=steps, steps_out=steps,
              integrator=MagmpTorch(maxit=maxit, dtype=np.complex128,
                                    device=device, solver=shear_scan),
              progress_bar=False)
    sec = time.perf_counter() - t0
    launches = read_counts()
    if launches != {"shear_thomas": 0, "shear_scan": steps * maxit}:
        raise AssertionError(f"launches {launches}")
    if not np.isfinite(S).all():
        raise AssertionError("non-finite state")
    St = torch.from_numpy(S).to(device)
    drift = np.abs(casimirs(St[1]) - c0) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(Theta^2), tr(Theta^3) = "
                             f"{drift} > 1e-10")
    x1 = (torch.sum(St[0] * St[1].conj()).real / N).item()
    return dict(N=N, steps=steps, maxit=maxit, launches=launches,
                tr_Theta2_drift=drift[0], tr_Theta3_drift=drift[1],
                cross_helicity_drift=abs(x1 - x0) / abs(x0),
                solve_steps_per_s=steps / sec)


def mhd_large(device, N=4096, steps=5, maxit=5):
    """Phase 9: the card-resident stepper through shear_scan."""
    S0 = torch.from_numpy(MHDFlow(N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    z = torch.zeros_like(S0)
    dt = 0.25 * hbar(N)

    def run(steps):
        return build_mhd_step_fn(N, dt, steps=steps, maxit=maxit,
                                 dtype=np.complex64, device=device,
                                 solver=shear_scan)

    run(1)(S0, z, z)  # first call: allocations, cuBLAS set-up
    fn = run(steps)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    S = fn(S0, z, z)[0]
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counts()
    if launches != {"shear_thomas": 0, "shear_scan": steps * maxit}:
        raise AssertionError(f"launches {launches}")
    if not torch.isfinite(torch.view_as_real(S)).all().item():
        raise AssertionError("non-finite state")
    return dict(N=N, steps=steps, maxit=maxit, launches=launches,
                stepper_steps_per_s=steps / sec)


class SyncTimer:
    """Counts the host syncs of a fixed-point loop with a tolerance (one
    ``.item()`` of the residual norm an iteration: ``_read`` of
    integrators/isospectral for isomp, of parallel/stepper for the
    steppers, eager or replayed) and the host seconds spent in them, while
    installed."""

    def __init__(self, module=isospectral):
        self.module = module
        self.calls = 0
        self.seconds = 0.0

    def __enter__(self):
        self._read = self.module._read

        def timed(rn):
            t0 = time.perf_counter()
            value = self._read(rn)
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return value

        self.module._read = timed
        return self

    def __exit__(self, *exc):
        self.module._read = self._read


def chunk_iterations(log):
    """Fixed-point iterations of a solve run, from the stats its
    callback got: each chunk's average a step times its steps."""
    return round(sum(n * st["iterations"] for n, st in log.chunks))


def reference_euler(device, N=1024, steps=100, steps_out=20,
                    compare_steps=10, gate_out=None):
    """Phase 10: the README's call on the card, complex128.  ``gate_out``,
    a dict, gets the gate run's initial and final states and its
    iterations a step (phase 14d holds the stepper to them)."""
    W0 = EulerFlow(N, np.complex128).random_initial(lmax=10, seed=42)
    c0 = casimirs(torch.from_numpy(W0).to(device))
    log = Logger()
    reset_counts()
    log(W0)
    with SyncTimer() as syncs:
        t0 = time.perf_counter()
        # no integrator= and no device=: isomp, tol 'auto', maxit 10, the card
        W = solve(W0.copy(), stepsize=0.25, steps=steps, steps_out=steps_out,
                  callback=log, progress_bar=False)
        wall = time.perf_counter() - t0
    counts = read_counts()
    iterations = chunk_iterations(log)
    expected = iterations + len(log.rows)
    if counts != {"shear_thomas": expected, "shear_scan": 0}:
        raise AssertionError(f"launches {counts}, expected {expected} of "
                             f"shear_thomas: {iterations} fixed-point "
                             f"iterations and {len(log.rows)} energy logs")
    # on the card the device loop reads each call's sums once
    reads = len(log.chunks) if on_card(device) else iterations
    if syncs.calls != reads:
        raise AssertionError(f"{syncs.calls} host syncs for {iterations} "
                             f"iterations in {len(log.chunks)} calls")
    if W.shape != (N, N) or W.dtype != np.complex128 or not np.isfinite(W).all():
        raise AssertionError(f"bad state: {W.shape} {W.dtype}")
    auto_drift = np.abs(casimirs(torch.from_numpy(W).to(device)) - c0
                        ) / np.abs(c0)
    Z = np.array([r[1] for r in log.rows])

    # the conservation gate: tests/test_integrators.py's tolerance
    gate = Logger()
    reset_counts()
    t0 = time.perf_counter()
    Wg = solve(W0.copy(), stepsize=0.25, steps=steps, steps_out=steps,
               tol=1e-12, compsum=True, maxit=20, callback=gate,
               progress_bar=False)
    gate_s = time.perf_counter() - t0
    gate_iterations = chunk_iterations(gate)
    gate_counts = read_counts()
    if gate_counts["shear_thomas"] != gate_iterations + len(gate.rows):
        raise AssertionError(f"gate launches {gate_counts} for "
                             f"{gate_iterations} iterations")
    drift = np.abs(casimirs(torch.from_numpy(Wg).to(device)) - c0) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(W^2), tr(W^3) = {drift} > "
                             "1e-10 at tol=1e-12, compsum")
    if gate_out is not None:
        gate_out.update(W0=W0, W=Wg, steps=steps,
                        iterations_per_step=gate_iterations / steps)

    # the same steps through the kernel and through the plain column solve
    dt = 0.25 * hbar(N)
    Wt = torch.from_numpy(W0).to(device)
    Wk = isomp(Wt, dt, compare_steps)
    with config.eager():  # the plain solve: thousands of nodes a graph
        Wp = isomp(Wt, dt, compare_steps, hamiltonian=functools.partial(
            solve_poisson, skewh=True, solver=shear_thomas_reference))
    step_rel = ((Wk - Wp).abs().max() / Wp.abs().max()).item()
    if not step_rel <= 1e-12:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-12")
    return dict(N=N, steps=steps, launches=counts["shear_thomas"],
                expected_launches=expected,
                iterations_per_step=iterations / steps,
                syncs=syncs.calls, sync_s=syncs.seconds,
                sync_share=syncs.seconds / wall,
                solve_steps_per_s=steps / wall,
                auto_tr_W2_drift=auto_drift[0], auto_tr_W3_drift=auto_drift[1],
                auto_enstrophy_drift=float(np.abs(Z - Z[0]).max() / abs(Z[0])),
                gate_launches=gate_counts["shear_thomas"],
                gate_iterations_per_step=gate_iterations / steps,
                gate_tr_W2_drift=drift[0], gate_tr_W3_drift=drift[1],
                gate_steps_per_s=steps / gate_s,
                kernel_vs_plain_10_steps=step_rel)


def reference_qg(device, N=1024, steps=50, gamma=1.0):
    """Phase 11: GlobalQGFlow.step (isomp with solve_globalqg) in complex64
    through shear_scan."""
    flow = GlobalQGFlow(N, np.complex64, gamma=gamma)
    W0 = flow.random_initial(lmax=10, seed=42)
    z0 = enstrophy(W0.astype(np.complex128))
    stats = {}
    with kernel_variable("scan"):
        # the QG operator's first use factorizes it on the host and uploads
        # it: timed apart from the steps
        t0 = time.perf_counter()
        flow.hamiltonian(torch.from_numpy(W0).to(device))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        W = flow.step(W0.copy(), 0.25 * hbar(N), steps=steps, stats=stats)
        sec = time.perf_counter() - t0
        counts = read_counts()
    iterations = round(stats["iterations"] * steps)
    if counts != {"shear_thomas": 0, "shear_scan": iterations}:
        raise AssertionError(f"launches {counts}, expected {iterations} of "
                             "shear_scan only")
    if W.dtype != np.complex64 or not np.isfinite(W).all():
        raise AssertionError(f"bad state: {W.dtype}")
    z_drift = float(abs(enstrophy(W.astype(np.complex128)) - z0) / abs(z0))
    if not z_drift <= 1e-3:
        raise AssertionError(f"enstrophy drift {z_drift:.3e} > 1e-3")
    return dict(N=N, steps=steps, gamma=gamma, launches=counts,
                iterations_per_step=stats["iterations"],
                enstrophy_drift=z_drift, setup_s=setup_s,
                steps_per_s=steps / sec)


#: phase 12's solves: name -> (the port's call on W, the (kind, params) of
#: its shear operator, ops/tridiag.shear_operator)
FAMILIES = {
    "poisson": (lambda W, **kw: solve_poisson(W, skewh=True, **kw),
                ("poisson", ())),
    "heat": (lambda W, **kw: solve_heat(1e-3, W, skewh=True, **kw),
             ("heat", (1e-3,))),
    "helmholtz": (lambda W, **kw: solve_helmholtz(W, alpha=0.1, skewh=True,
                                                  **kw),
                  ("helmholtz", (0.1,))),
    "viscdamp_theta1": (lambda W, **kw: solve_viscdamp(
        0.1, W, nu=1e-2, alpha=0.6, theta=1, skewh=True, **kw),
        ("viscdamp", (0.1, 1e-2, 0.6, 1.0))),
    "viscdamp_theta05": (lambda W, **kw: solve_viscdamp(
        0.1, W, nu=1e-2, alpha=0.6, theta=0.5, skewh=True, **kw),
        ("viscdamp", (0.1, 1e-2, 0.6, 0.5))),
    "globalqg": (lambda W, **kw: solve_globalqg(W, gamma=0.7, skewh=True,
                                                **kw),
                 ("globalqg", (0.7,))),
}


def host_family_solve(name, W):
    """The float64 host reference of ``FAMILIES[name]``: Poisson through the
    row-packed LAPACK solve of laplacian.tridiagonal; every other family
    packed into the shear view, the trace projected, each column's
    tridiagonal system solved with scipy ``solve_banded``, the trace
    projected, unpacked, and the lower triangle mirrored."""
    N = W.shape[-1]
    if name == "poisson":
        return tridiagonal.solve_tridiagonal_lapack(
            tridiagonal.compute_tridiagonal_laplacian(N, bc=True), W)
    kind, params = FAMILIES[name][1]
    if kind == "viscdamp" and params[3] != 1:
        h, nu, alpha, theta = params
        lapW = laplace(torch.from_numpy(W), skewh=True).numpy()
        W = (1.0 - alpha * h * (1 - theta)) * W + (nu * h * (1 - theta)) * lapW
    op = shear_operator(N, kind, params)
    D = np.concatenate([W.reshape(-1), np.zeros(N, W.dtype)]).reshape(N, N + 1)
    D[:, 0] -= D[:, 0].mean()
    X = np.empty_like(D)
    ab = np.zeros((3, N))
    for j in range(N + 1):
        ab[0, 1:] = op[j, 1, :-1]
        ab[1] = op[j, 0]
        ab[2, :-1] = op[j, 1, :-1]
        X[:, j] = solve_banded((1, 1), ab, D[:, j])
    X[:, 0] -= X[:, 0].mean()
    P = X.reshape(-1)[: N * N].reshape(N, N)
    return np.tril(P) - np.tril(P, -1).conj().T


def poisson_family(device, N=1024):
    """Phase 12: every Poisson-family solve on tensors on the card, both
    dtypes: the kernel bit-equal to the plain column solve, complex128
    within 1e-12 of the host float64 reference, complex64's error beside
    it, one launch a call; laplace(solve_poisson(W)) = W."""
    rng = np.random.RandomState(12)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    W = W - W.conj().T
    W -= np.eye(N) * np.trace(W) / N
    rows = []
    for name, (call, _) in FAMILIES.items():
        ref = host_family_solve(name, W)
        row = dict(family=name)
        for dtype in (torch.complex128, torch.complex64):
            Wt = torch.from_numpy(W).to(device, dtype)
            reset_counts()
            P = call(Wt)
            launches = read_counts()
            if launches != {"shear_thomas": 1, "shear_scan": 0}:
                raise AssertionError(f"{name} {dtype}: launches {launches}")
            plain = call(Wt, solver=shear_thomas_reference)
            abs_err = (P - plain).abs().max().item()
            if abs_err != 0.0:
                raise AssertionError(f"{name} {dtype}: kernel vs plain "
                                     f"{abs_err:.3e}, not bit-equal")
            Ph = P.cpu().numpy()
            err = float(np.abs(Ph - ref).max() / np.abs(ref).max())
            tier = str(dtype).removeprefix("torch.")
            row[f"{tier}_rel_err"] = err
            row[f"{tier}_launches"] = launches["shear_thomas"]
            if dtype == torch.complex128 and not err <= 1e-12:
                raise AssertionError(f"{name} complex128: {err:.3e} > 1e-12 "
                                     "from the host reference")
        rows.append(row)
    Wt = torch.from_numpy(W).to(device)
    back = laplace(solve_poisson(Wt, skewh=True), skewh=True)
    round_trip = ((back - Wt).abs().max() / Wt.abs().max()).item()
    if not round_trip <= 1e-10:
        raise AssertionError(f"laplace(solve_poisson(W)) vs W: "
                             f"{round_trip:.3e} > 1e-10")
    return dict(N=N, families=rows, laplace_round_trip=round_trip,
                launches=sum(r["complex128_launches"] + r["complex64_launches"]
                             for r in rows))


def reference_mhd(device, N=512, steps=50):
    """Phase 13: MHDFlow.step (magmp) in complex128 at
    tests/test_mhd.py's tolerance."""
    flow = MHDFlow(N, np.complex128)
    S0 = flow.random_initial(lmax=10, seed=42)
    c0 = casimirs(torch.from_numpy(S0[1]).to(device))
    stats = {}
    reset_counts()
    t0 = time.perf_counter()
    S = flow.step(S0.copy(), 0.25 * hbar(N), steps=steps, tol=1e-12,
                  maxit=20, stats=stats)
    sec = time.perf_counter() - t0
    counts = read_counts()
    iterations = round(stats["iterations"] * steps)
    if counts != {"shear_thomas": iterations, "shear_scan": 0}:
        raise AssertionError(f"launches {counts}, expected {iterations}: one "
                             "solve of W an iteration, laplace of Theta none")
    if not np.isfinite(S).all():
        raise AssertionError("non-finite state")
    drift = np.abs(casimirs(torch.from_numpy(S[1]).to(device)) - c0
                   ) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(Theta^2), tr(Theta^3) = "
                             f"{drift} > 1e-10")
    return dict(N=N, steps=steps, launches=counts["shear_thomas"],
                iterations_per_step=stats["iterations"],
                tr_Theta2_drift=drift[0], tr_Theta3_drift=drift[1],
                steps_per_s=steps / sec)


#: phase 14's forced-dissipative QG configuration
QG_GAMMA = 1.0
VISCDAMP = ("viscdamp", dict(nu=1e-4, alpha=0.01, theta=0.5))


def band_forcing(N, dtype, device, W0, scale=1e-2):
    """A fixed skew-Hermitian band-limited matrix F0 (``random_shr(lmax=12,
    seed=7)`` with l < 8 zeroed), scaled to ``scale`` times W0's Frobenius
    norm, on ``device``."""
    omega = random_shr(lmax=12, seed=7)
    omega[:8 ** 2] = 0.0
    F0 = shr2mat(omega, N=N)
    F0 *= scale * np.linalg.norm(W0) / np.linalg.norm(F0)
    return torch.from_numpy(F0.astype(dtype)).to(device)


def qg_forcing(F0):
    """The timed forcing cos(t) F0 of phases 14 and 22.  On the card time
    comes as a 0-d tensor there and the forcing is captured with its step:
    torch.cos of it, no host read.  On the CPU it comes as a numpy scalar
    or a float, taken in F0's real precision."""
    def forcing(P, W, time=0.0):
        return torch.cos(torch.as_tensor(time, dtype=F0.real.dtype)) * F0
    return forcing


def ratio(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def finite(x):
    return bool(torch.isfinite(torch.view_as_real(x) if x.is_complex()
                               else x).all().item())


def hooked_qg(device, kernel=shear_thomas, plain=shear_thomas_reference,
              N=1024, steps=100, steps_out=20, maxit=5, compare_steps=10):
    """Phases 14a (``shear_thomas``) and 14b (under
    QUFLOW_PALLAS_KERNEL=scan, ``shear_scan``): the forced-dissipative QG
    stepper, complex64."""
    flow = GlobalQGFlow(N, np.complex64, gamma=QG_GAMMA)
    W0 = flow.random_initial(lmax=10, seed=42)
    forcing = qg_forcing(band_forcing(N, np.complex64, device, W0))
    dt = 0.25 * hbar(N)
    Wt = torch.from_numpy(W0).to(device)
    z = torch.zeros_like(Wt)

    def runner(n, **kw):
        return flow.stepper(dt, n, maxit=maxit, forcing=forcing,
                            strang_splitting=VISCDAMP, device=device, **kw)

    runner(1)(Wt, z, z, 0.0)  # first call: host factors, cuBLAS set-up
    fn = runner(steps_out, with_diagnostics=True)
    fn(Wt, z, z, 0.0)  # and its capture
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    st = (Wt, z, z)
    for k in range(steps // steps_out):
        *st, diag = fn(*st, k * steps_out * dt)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    gemms = read_gemm()
    calls = steps // steps_out
    expected = {k.__name__: 0 for k in KERNELS}
    expected[kernel.__name__] = steps * (maxit + 2) + calls
    if counts != expected:
        raise AssertionError(f"launches {counts}, expected {expected}")
    check_gemm(device, gemms, EULER_GEMMS * maxit, steps)
    W = st[0]
    if W.shape != (N, N) or W.dtype != torch.complex64 or not finite(W):
        raise AssertionError(f"bad state: {W.shape} {W.dtype}")
    if not finite(diag):
        raise AssertionError(f"non-finite diagnostics {diag}")

    # the same steps through the kernel and through its plain version
    Wk = runner(compare_steps, solver=kernel)(Wt, z, z, 0.0)[0]
    with config.eager():  # the plain solve: thousands of nodes a graph
        Wp = runner(compare_steps, solver=plain)(Wt, z, z, 0.0)[0]
    step_rel = ratio(Wk, Wp)
    if not step_rel <= 1e-5:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-5")
    return dict(N=N, steps=steps, steps_per_call=steps_out, maxit=maxit,
                launches=counts, expected_launches=expected,
                gemm_launches=gemms,
                energy=diag[0].item(), enstrophy=diag[1].item(),
                kernel_vs_plain_steps=compare_steps,
                kernel_vs_plain=step_rel, stepper_steps_per_s=steps / sec)


def hooked_vs_reference(device, N=512, steps=20, maxit=5):
    """Phase 14c: the forced-dissipative QG stepper against the reference
    loop ``isomp`` with the callable hooks, complex128."""
    flow = GlobalQGFlow(N, np.complex128, gamma=QG_GAMMA)
    W0 = flow.random_initial(lmax=10, seed=42)
    forcing = qg_forcing(band_forcing(N, np.complex128, device, W0))
    dt = 0.25 * hbar(N)
    Wt = torch.from_numpy(W0).to(device)
    z = torch.zeros_like(Wt)
    fn = flow.stepper(dt, steps, maxit=maxit, minit=maxit, tol=1e-300,
                      forcing=forcing, strang_splitting=VISCDAMP,
                      device=device)
    reset_counts()
    with SyncTimer(stepper) as syncs:
        Ws, _, _, iters = fn(Wt, z, z, 0.0)
    stepper_counts = read_counts()
    reads = 1 if on_card(device) else steps * maxit  # the counts, once
    if (iters != maxit).any() or syncs.calls != reads:
        raise AssertionError(f"iterations {iters.tolist()}, {syncs.calls} "
                             "host syncs")
    if stepper_counts["shear_thomas"] != steps * (maxit + 2):
        raise AssertionError(f"stepper launches {stepper_counts}")
    reset_counts()
    Wr = isomp(Wt, dt, steps, time=0.0, tol=1e-300, minit=maxit, maxit=maxit,
               compsum=True, forcing=forcing, **custom_qg_hooks())
    isomp_counts = read_counts()
    diff = ((Ws - Wr).abs().max() / Wr.abs().max()).item()
    if not diff <= 1e-11:
        raise AssertionError(f"stepper vs isomp: {diff:.3e} > 1e-11 of "
                             "max|W|")
    return dict(N=N, steps=steps, maxit=maxit, stepper_vs_isomp=diff,
                stepper_launches=stepper_counts["shear_thomas"],
                isomp_launches=isomp_counts["shear_thomas"],
                stepper_syncs=syncs.calls)


def adaptive_euler(device, gate, steps_out=20, tol=1e-12, maxit=20):
    """Phase 14d: adaptive tol on the Euler stepper, complex128, against
    phase 10's gate run (``gate``: its states and iterations)."""
    W0, steps = gate["W0"], gate["steps"]
    N = W0.shape[-1]
    c0 = casimirs(torch.from_numpy(W0).to(device))
    fn = build_step_fn(N, 0.25 * hbar(N), steps=steps_out, maxit=maxit,
                       dtype=np.complex128, compsum=True, tol=tol, minit=1,
                       device=device)
    Wt = torch.from_numpy(W0).to(device)
    z = torch.zeros_like(Wt)
    series = []
    reset_counts()
    with SyncTimer(stepper) as syncs:
        t0 = time.perf_counter()
        st = (Wt, z, z)
        for _ in range(steps // steps_out):
            *st, iters = fn(*st)
            series.append(iters)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    counts = read_counts()
    iterations = int(torch.cat(series).sum())
    if counts != {"shear_thomas": iterations, "shear_scan": 0}:
        raise AssertionError(f"launches {counts} for {iterations} iterations")
    reads = len(series) if on_card(device) else iterations
    if syncs.calls != reads:
        raise AssertionError(f"{syncs.calls} host syncs for {iterations} "
                             f"iterations in {len(series)} calls")
    W = st[0]
    rel = ratio(W, torch.from_numpy(gate["W"]).to(device))
    if not rel <= 1e-11:
        raise AssertionError(f"stepper vs isomp's gate run: {rel:.3e} > 1e-11")
    mean = iterations / steps
    if not abs(mean - gate["iterations_per_step"]) <= 0.1:
        raise AssertionError(f"{mean} iterations a step, isomp's gate "
                             f"{gate['iterations_per_step']}")
    drift = np.abs(casimirs(W) - c0) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(W^2), tr(W^3) = {drift}")
    return dict(N=N, steps=steps, tol=tol, maxit=maxit, launches=iterations,
                syncs=syncs.calls, sync_s=syncs.seconds,
                iterations_per_step=mean,
                isomp_iterations_per_step=gate["iterations_per_step"],
                vs_isomp_gate=rel, tr_W2_drift=drift[0], tr_W3_drift=drift[1],
                stepper_steps_per_s=steps / sec)


def hooked_mhd(device, N=1024, steps=20, maxit=5, compare_steps=5):
    """Phase 14e: the MHD stepper with a fixed full-state forcing and the
    named heat Strang splitting, complex64, under
    QUFLOW_PALLAS_KERNEL=scan."""
    S0 = MHDFlow(N, np.complex64).random_initial(lmax=10, seed=42)
    F0 = band_forcing(N, np.complex64, device, S0[0])
    F = torch.stack([F0, 0.1 * F0])
    St = torch.from_numpy(S0).to(device)
    z = torch.zeros_like(St)
    dt = 0.25 * hbar(N)
    with kernel_variable("scan"):
        def runner(n, solver=None):
            return build_mhd_step_fn(
                N, dt, steps=n, maxit=maxit, dtype=np.complex64,
                forcing=lambda P, S: F,
                strang_splitting=("heat", {"nu": 1e-4}), device=device,
                solver=solver)

        runner(1)(St, z, z)
        fn = runner(steps)
        fn(St, z, z)  # its capture
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        S = fn(St, z, z)[0]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
    if counts != {"shear_thomas": 0, "shear_scan": steps * (maxit + 2)}:
        raise AssertionError(f"launches {counts}, expected "
                             f"{steps * (maxit + 2)} of shear_scan only")
    if S.shape != (2, N, N) or not finite(S):
        raise AssertionError(f"bad state {S.shape}")
    Sk = runner(compare_steps, shear_scan)(St, z, z)[0]
    with config.eager():
        Sp = runner(compare_steps, shear_scan_reference)(St, z, z)[0]
    step_rel = ratio(Sk, Sp)
    if not step_rel <= 1e-5:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-5")
    return dict(N=N, steps=steps, maxit=maxit, launches=counts,
                kernel_vs_plain_steps=compare_steps, kernel_vs_plain=step_rel,
                stepper_steps_per_s=steps / sec)


class HostCopies:
    """Counts the calls of ``Tensor.cpu``, ``.numpy``, ``.item`` and
    ``.tolist`` while installed: each copies a tensor to the host."""

    NAMES = ("cpu", "numpy", "item", "tolist")

    def __init__(self):
        self.calls = dict.fromkeys(self.NAMES, 0)

    def __enter__(self):
        self._saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        for name, method in self._saved.items():
            def counted(t, *a, _name=name, _method=method, **kw):
                self.calls[_name] += 1
                return _method(t, *a, **kw)
            setattr(torch.Tensor, name, counted)
        return self

    def __exit__(self, *exc):
        for name, method in self._saved.items():
            setattr(torch.Tensor, name, method)


def solve_on_card(device, N=1024, steps=100, steps_out=20, maxit=5):
    """Phase 14f: ``solve`` of a card tensor through ``IsompTorch``."""
    W0 = EulerFlow(N, np.complex64).random_initial(lmax=10, seed=42)
    Wt = torch.from_numpy(W0).to(device)
    integrator = IsompTorch(maxit=maxit, dtype=np.complex64)
    integrator(Wt, 0.25 * hbar(N), steps=steps_out)  # first call: set-up
    torch.cuda.synchronize()
    reset_counts()
    with HostCopies() as copies:
        t0 = time.perf_counter()
        W = solve(Wt, stepsize=0.25, steps=steps, steps_out=steps_out,
                  integrator=integrator, progress_bar=False)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    counts = read_counts()
    if not isinstance(W, torch.Tensor) or W.device != Wt.device:
        raise AssertionError(f"solve returned {type(W)}")
    if any(copies.calls.values()):
        raise AssertionError(f"host copies of tensors: {copies.calls}")
    if counts != {"shear_thomas": steps * maxit, "shear_scan": 0}:
        raise AssertionError(f"launches {counts}")
    if W.dtype != torch.complex64 or not finite(W):
        raise AssertionError(f"bad state {W.dtype}")
    return dict(N=N, steps=steps, maxit=maxit, launches=counts,
                host_copies=copies.calls, solve_steps_per_s=steps / sec)


def kernel_table(fn, steps):
    """One call of ``fn`` (``steps`` steps) under torch.profiler, after a
    warm-up call: {kernel name: (launches a step, ms a step)} of the
    card's kernels, and the host-clock ms a step of the profiled call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel entries only: an operator's entry repeats its kernels' time
    table = {e.key: (e.count / steps, e.self_device_time_total / (1e3 * steps))
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}
    return table, wall * 1e3 / steps


def profiled(fn, st, steps=20, solve="shear_thomas", top=0):
    """One call of ``steps`` steps under torch.profiler (kernel_table): the
    card's ms a step (the kernels' own time, summed), the column solve's
    ms a step, the host-clock ms a step of the profiled call and, with
    ``top``, the ``top`` kernels by time."""
    table, wall_ms = kernel_table(lambda: fn(*st), steps)
    row = {"device_ms": sum(ms for _, ms in table.values()),
           f"{solve}_ms": sum(ms for key, (_, ms) in table.items()
                              if solve in key),
           "wall_ms_profiled": wall_ms}
    if top:
        by_time = sorted(((ms, n, key) for key, (n, ms) in table.items()
                          if ms > 0), reverse=True)
        row["kernels"] = [dict(name=key[:72], ms_a_step=ms, calls_a_step=n)
                          for ms, n, key in by_time[:top]]
    return row


def euler_members(N, B, dtype, seed=42):
    """B EulerFlow initial states (seeds seed, ..., seed + B - 1), stacked
    (B, N, N)."""
    return np.stack([EulerFlow(N, dtype).random_initial(lmax=10, seed=seed + b)
                     for b in range(B)])


class Recorded:
    """A column solve that records the ensemble size (the product of the
    leading axes) of each call, then calls ``solver``."""

    def __init__(self, solver):
        self.solver, self.batches = solver, []

    def __call__(self, w, binv, u, d):
        self.batches.append(int(np.prod(d.shape[:-2])))
        return self.solver(w, binv, u, d)


def ensemble_euler(device, N=1024, Bs=(1, 4, 16), steps_out=20, calls=2,
                   maxit=5, compare_steps=10, out=None):
    """Phase 15a-b: the batched Euler stepper, complex64, at each ensemble
    size B (members: EulerFlow initial data of seeds 42, 43, ...): launches
    (steps x maxit whatever B), per-state steps/s, and from one profiled
    call the card's ms a step and its idle share; then every member of the
    largest ensemble against its own unbatched run.  ``out`` gets the
    largest run's initial and final states (phase 16b's reference)."""
    dt = 0.25 * hbar(N)
    steps = steps_out * calls
    members = torch.from_numpy(euler_members(N, max(Bs), np.complex64)).to(
        device)
    rows = []
    for B in Bs:
        W0 = members[:B].contiguous()
        z = torch.zeros_like(W0)
        fn = build_step_fn(N, dt, steps=steps_out, maxit=maxit,
                           dtype=np.complex64, batched=True, device=device)
        fn(W0, z, z)  # first call: allocations, cuBLAS set-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        st = (W0, z, z)
        for _ in range(calls):
            st = fn(*st)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        gemms = read_gemm()
        if counts != {"shear_thomas": steps * maxit, "shear_scan": 0}:
            raise AssertionError(f"B={B}: launches {counts}, expected "
                                 f"{steps * maxit} of shear_thomas only")
        check_gemm(device, gemms, EULER_GEMMS * maxit, steps, f"B={B}: ")
        if st[0].shape != (B, N, N) or not finite(st[0]):
            raise AssertionError(f"B={B}: bad state {st[0].shape}")
        prof = profiled(fn, (W0, z, z), steps=steps_out)
        wall_ms = sec * 1e3 / steps
        rows.append(dict(
            B=B, steps=steps, launches=counts["shear_thomas"],
            gemm_launches=gemms, steps_per_s=steps / sec,
            state_steps_per_s=B * steps / sec,
            wall_ms_a_step=wall_ms, device_ms_a_step=prof["device_ms"],
            shear_thomas_ms_a_step=prof["shear_thomas_ms"],
            idle_share=1.0 - prof["device_ms"] / wall_ms))
        if out is not None and B == max(Bs):
            out.update(W0=W0, W=st[0], launches=counts["shear_thomas"],
                       gemm_launches=gemms, steps_out=steps_out,
                       calls=calls, maxit=maxit)

    # each member of the largest ensemble against its own run; the
    # tolerance, stated before the first run: 1e-5 of max|W| (complex64;
    # the batched and the single GEMMs may round apart)
    B = max(Bs)
    z = torch.zeros_like(members)
    WB = build_step_fn(N, dt, steps=compare_steps, maxit=maxit,
                       dtype=np.complex64, batched=True, device=device)(
        members, z, z)[0]
    one = build_step_fn(N, dt, steps=compare_steps, maxit=maxit,
                        dtype=np.complex64, device=device)
    worst = max(ratio(WB[b], one(members[b], z[b], z[b])[0])
                for b in range(B))
    if not worst <= 1e-5:
        raise AssertionError(f"member vs its own run over {compare_steps} "
                             f"steps: {worst:.3e} > 1e-5")
    return dict(N=N, maxit=maxit, dtype="complex64", by_B=rows,
                members_vs_own_runs_steps=compare_steps,
                members_vs_own_runs=worst)


def ensemble_c128(device, N=512, B=8, steps=200, steps_out=50, maxit=5):
    """Phase 15c: the batched Euler stepper, complex128, B members, 200
    steps: tr(W^2), tr(W^3) drift <= 1e-10 on every member."""
    W0 = torch.from_numpy(euler_members(N, B, np.complex128)).to(device)
    c0 = casimirs(W0)
    z = torch.zeros_like(W0)
    fn = build_step_fn(N, 0.25 * hbar(N), steps=steps_out, maxit=maxit,
                       dtype=np.complex128, batched=True, device=device)
    reset_counts()
    t0 = time.perf_counter()
    st = (W0, z, z)
    for _ in range(steps // steps_out):
        st = fn(*st)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = read_counts()
    if counts != {"shear_thomas": steps * maxit, "shear_scan": 0}:
        raise AssertionError(f"launches {counts}")
    if not finite(st[0]):
        raise AssertionError("non-finite state")
    drift = np.abs(casimirs(st[0]) - c0) / np.abs(c0)
    if not (drift <= 1e-10).all():
        raise AssertionError(f"Casimir drift tr(W^2), tr(W^3) by member "
                             f"{drift.tolist()} > 1e-10")
    return dict(N=N, B=B, steps=steps, maxit=maxit, launches=counts,
                max_tr_W2_drift=drift[:, 0].max(),
                max_tr_W3_drift=drift[:, 1].max(),
                state_steps_per_s=B * steps / sec)


def ensemble_mhd(device, N=1024, B=4, steps=20, maxit=5, compare_steps=5):
    """Phase 15d: the batched MHD stepper, complex64, with the named heat
    Strang splitting, under QUFLOW_PALLAS_KERNEL=scan: one launch of B
    an iteration and one of 2 B a Strang half-step."""
    S0 = torch.from_numpy(np.stack([
        MHDFlow(N, np.complex64).random_initial(lmax=10, seed=42 + b)
        for b in range(B)])).to(device)
    z = torch.zeros_like(S0)
    dt = 0.25 * hbar(N)
    with kernel_variable("scan"):
        def runner(n, solver):
            return build_mhd_step_fn(
                N, dt, steps=n, maxit=maxit, dtype=np.complex64,
                batched=True, strang_splitting=("heat", {"nu": 1e-4}),
                device=device, solver=solver)

        solver = Recorded(stepper.column_solver())
        fn = runner(steps, solver)
        fn(S0, z, z)  # first call: host factors, cuBLAS set-up, capture
        torch.cuda.synchronize()
        # the solver's Python runs where the step does: captured, at the
        # warm-up and the capture of one step; eager, at every step
        first = list(solver.batches)
        solver.batches.clear()
        reset_counts()
        t0 = time.perf_counter()
        S = fn(S0, z, z)[0]
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        gemms = read_gemm()
    expected = [2 * B] + [B] * maxit + [2 * B]
    if (counts != {"shear_thomas": 0, "shear_scan": steps * (maxit + 2)}
            or first != expected * (2 if fn.captured else steps)
            or solver.batches != ([] if fn.captured else expected * steps)):
        raise AssertionError(f"launches {counts}, ensemble sizes "
                             f"{sorted(set(first))}")
    check_gemm(device, gemms, MHD_GEMMS * maxit, steps)
    if S.shape != (B, 2, N, N) or not finite(S):
        raise AssertionError(f"bad state {S.shape}")
    Sk = runner(compare_steps, shear_scan)(S0, z, z)[0]
    with config.eager():
        Sp = runner(compare_steps, shear_scan_reference)(S0, z, z)[0]
    step_rel = ratio(Sk, Sp)
    if not step_rel <= 1e-5:
        raise AssertionError(f"{compare_steps} steps kernel vs plain: "
                             f"relative difference {step_rel:.3e} > 1e-5")
    return dict(N=N, B=B, steps=steps, maxit=maxit, launches=counts,
                gemm_launches=gemms, captured=fn.captured,
                launches_of_B=expected.count(B) * steps,
                launches_of_2B=expected.count(2 * B) * steps,
                kernel_vs_plain_steps=compare_steps, kernel_vs_plain=step_rel,
                state_steps_per_s=B * steps / sec)


def checkpoint_restart(device, N=1024, steps=20, maxit=5):
    """Phase 16a: ``IsompTorch(warm=False)`` (each call a pure function of
    the state), complex64, two calls of ``steps`` against one call, a
    checkpoint saved and loaded, and the second call: bit-equal."""
    from quflow_tpu_torch.parallel.distributed import (
        load_checkpoint,
        save_checkpoint,
    )

    W0 = torch.from_numpy(EulerFlow(N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    integ = IsompTorch(maxit=maxit, dtype=np.complex64, device=device,
                       warm=False)
    dt = 0.25 * hbar(N)
    reset_counts()
    straight = integ(integ(W0, dt, steps=steps), dt, steps=steps)
    with tempfile.TemporaryDirectory() as tmp:
        half = integ(W0, dt, steps=steps)
        path = save_checkpoint(tmp, (half,), step=steps)
        (back,) = load_checkpoint(tmp, (half,), step=steps)
        resumed = integ(back, dt, steps=steps)
    counts = read_counts()
    if counts != {"shear_thomas": 4 * steps * maxit, "shear_scan": 0}:
        raise AssertionError(f"launches {counts}")
    if back.device != W0.device or not torch.equal(resumed, straight):
        raise AssertionError("the restart through the checkpoint is not "
                             "bit-equal to the run without it")
    return dict(N=N, steps=f"{steps} + {steps}", maxit=maxit,
                checkpoint=os.path.basename(path), launches=counts,
                bit_equal=True)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


#: cudaGraphNodeType by number (CUDA 12's runtime API)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
              4: "child graph", 5: "empty", 6: "event wait",
              7: "event record", 8: "semaphore signal", 9: "semaphore wait",
              10: "memory allocation", 11: "memory free", 12: "batch memop",
              13: "conditional"}


def node_names(types):
    return [NODE_TYPES.get(t, str(t)) for t in types]


class GraphLaunches:
    """Counts the adaptive steps the device loops' composites launch, one
    graph launch a step, while installed."""

    def __enter__(self):
        self.steps = 0
        self._launch = cuda_graph_loop.Composite.launch

        def counted(composite, steps=1):
            self.steps += steps
            return self._launch(composite, steps)

        cuda_graph_loop.Composite.launch = counted
        return self

    def __exit__(self, *exc):
        cuda_graph_loop.Composite.launch = self._launch


@contextlib.contextmanager
def host_loop_mode():
    """Runners first called inside the block take a mesh's host loop
    (``_AdaptiveGraphs``, the path before the device loop held the
    mesh's all_reduce): the parent path, timed beside the device loop."""
    saved = stepper._loop_mode
    stepper._loop_mode = lambda mesh: "host"
    try:
        yield
    finally:
        stepper._loop_mode = saved


def close_programs(*runners):
    """Destroy the runners' composites now (before their process group)."""
    for run in runners:
        for program in run._programs.values():
            if hasattr(program, "loop"):
                program.loop.close()
        run._programs.clear()


def dp_adaptive(device, mesh, build, S0, steps=5, tol=1e-6, maxit=10,
                **kw):
    """One of phase 16b's adaptive runs on the mesh (complex64, batched):
    against the same run off the mesh (bit-equal, the same counts); on a
    card, one composite launch a step, one host read a call, the key-mode
    pass, the all_reduce and loop_decide once an iteration and the rule
    mode of loop_pass never, the WHILE body's nodes and the reduce's; the
    host loop of the same mesh (the parent path) bit-equal, and steps/s of
    both in turns.  On the CPU (eager) one all_reduce an iteration."""
    N = S0.shape[-1]
    z = torch.zeros_like(S0)
    args = dict(steps=steps, maxit=maxit, tol=tol, dtype=np.complex64,
                batched=True, device=device, **kw)
    dt = 0.25 * hbar(N)
    on = build(N, dt, mesh=mesh, **args)
    off = build(N, dt, **args)
    reset_counts()
    with SyncTimer(stepper) as sync, GraphLaunches() as launched:
        got = on(S0, z, z)
    counts = dict(read_counts(), cgemm=read_gemm(),
                  loop_pass=loop_pass.launches,
                  loop_pass_key=loop_pass.key_launches,
                  loop_decide=loop_decide.launches,
                  all_reduces=all_reduce_max_.calls)
    want = off(S0, z, z)
    iterations = int(got[3].sum())
    if not (torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])):
        raise AssertionError("the adaptive run on the mesh differs from the "
                             "run without it")
    out = dict(N=N, B=S0.shape[0], steps=steps, tol=tol, maxit=maxit,
               iterations=got[3].tolist(), counts=counts,
               host_reads=sync.calls, bit_equal_off_mesh=True)
    if not on_card(device):
        if counts["all_reduces"] != iterations:
            raise AssertionError(f"{counts['all_reduces']} all_reduces for "
                                 f"{iterations} iterations")
        return out
    (program,) = on._programs.values()
    loop = getattr(program, "loop", None)
    if loop is None or loop.reduce is None:
        raise AssertionError(f"the mesh's runner took {type(program)}, not "
                             f"the device loop with the mesh's reduce")
    per_iteration = (counts["loop_pass_key"], counts["loop_decide"],
                     counts["all_reduces"])
    if (launched.steps != steps or sync.calls != 1 or counts["loop_pass"]
            or per_iteration != (iterations,) * 3):
        raise AssertionError(f"{launched.steps} launches for {steps} steps, "
                             f"{sync.calls} host reads, counts {counts} for "
                             f"{iterations} iterations")
    body, n_body = loop.composite.body_nodes()
    reduce_types, n_reduce = cuda_graph_loop.graph_nodes(
        loop.pieces["reduce"].graph.raw_cuda_graph())
    if n_body != 4 or sorted(body) != [0, 0, 4, 4]:
        raise AssertionError(f"the WHILE body's nodes {node_names(body)}")
    print(f"phase 16b: WHILE body {node_names(body)}, the reduce's graph "
          f"{n_reduce} nodes {node_names(reduce_types)}", flush=True)
    with host_loop_mode():
        host = build(N, dt, mesh=mesh, **args)
        parent = host(S0, z, z)
    (parent_program,) = host._programs.values()
    if type(parent_program).__name__ != "_AdaptiveGraphs":
        raise AssertionError("the parent path did not take the host loop")
    if not (torch.equal(parent[0], got[0]) and torch.equal(parent[3],
                                                           got[3])):
        raise AssertionError("the host loop on the mesh differs from the "
                             "device loop")
    sec = {"loop": [], "host": []}
    for who in ("loop", "host", "host", "loop"):
        run = on if who == "loop" else host
        sec[who].append(timed_turn(lambda: run(S0, z, z), device)[1])
    close_programs(on, off, host)
    rate = {k: steps / float(np.median(v)) for k, v in sec.items()}
    out.update(body_nodes=node_names(body),
               reduce_nodes=node_names(reduce_types),
               reduce_node_count=n_reduce,
               composite_launches=launched.steps,
               steps_per_s=rate["loop"],
               host_loop_steps_per_s=rate["host"],
               loop_over_host=rate["loop"] / rate["host"],
               turns={k: [steps / t for t in v] for k, v in sec.items()},
               host_loop_bit_equal=True)
    return out


#: phase 16b's shapes of the split pass: (name, dtype, dW's shape)
SPLIT_TIMES = (("euler_c64_N1024_B16", torch.complex64, (16, 1024, 1024)),
               ("mhd_c64_N1024_B4", torch.complex64, (4, 2, 1024, 1024)))
#: residuals through the rule's edges, for loop_decide on keys
KEY_SEQUENCES = ([1e-3, 1e-6, 1e-9, 1e-12], [1e-3, 1e-4, 2e-4, 1e-5],
                 [float("nan")] * 6, [1e-3, float("nan"), 1e-20],
                 [1.0 / (k + 1) for k in range(8)])


def rule_bound(real):
    """The least time (ms) of one loop_decide: the key read, rn written,
    the state's header read and written and one count written, over 3.35
    TB/s (its dozen operations take far less)."""
    size = torch.empty((), dtype=real).element_size()
    n = 8 + size + 2 * cuda_graph_loop.HEADER * 8 + 8
    return n / HBM_BYTES_PER_S * 1e3, "bytes"


def rule_on_keys(device, real):
    """loop_decide on the keys of KEY_SEQUENCES, tol 1e-8 in ``real``,
    maxit 5, two steps each, against the plain rule: the words and rn
    bit-equal after every decision (else AssertionError); the decisions."""
    tol = float(torch.tensor(1e-8, dtype=real))
    decisions = 0
    for seq in KEY_SEQUENCES:
        a = cuda_graph_loop.start_(cuda_graph_loop.new_state(device, 2),
                                   tol, 5, 1)
        b = cuda_graph_loop.start_(cuda_graph_loop.new_state("cpu", 2), tol,
                                   5, 1)
        rn = torch.empty((), dtype=real, device=device)
        rn_p = torch.empty((), dtype=real)
        for _ in range(2):
            for x in seq:
                key = key_of(torch.tensor(x, dtype=real)).reshape(1)
                go = loop_decide(key.to(device), a, rn)
                loop_decide_reference(key, b, rn_p)
                decisions += 1
                same_rn = torch.equal(rn.cpu().reshape(1).view(torch.uint8),
                                      rn_p.reshape(1).view(torch.uint8))
                if not (torch.equal(a.cpu(), b) and same_rn):
                    raise AssertionError(f"loop_decide on {x!r}: words "
                                         f"{a.cpu().tolist()} against the "
                                         f"plain {b.tolist()}")
                if not bool(go):
                    break
    return decisions


def split_pass_times(device, reps=20, shapes=SPLIT_TIMES):
    """Phase 16b's entries at its runs' shapes: loop_pass's key mode
    (dW_new and dW read, dW written, the key) against its plain version
    (dW bit-equal, the key's residual within 2 N u of the plain one's),
    its ms by CUDA-graph replay, the plain version's and the library's
    residual and copy, and its bound; ``loop_decide`` on keys through the
    rule's edges (bit-equal to the plain rule) and its ms a decision by
    replay beside its bound and the plain rule's ms."""
    rows = []
    for seed, (name, dtype, shape) in enumerate(shapes):
        dW_new, dW = _pass_inputs(dtype, shape, device, 100 + seed)
        dWp, key, key_p = dW.clone(), new_key(device), new_key(device)
        scratch = new_scratch(device)
        residual_(dW_new, dW, write=True, key=key, scratch=scratch)
        loop_pass_reference(dW_new, dWp, None, write=True, key=key_p)
        a, b = key_value(int(key)), key_value(int(key_p))
        err = abs(a - b) / b
        u = torch.finfo(dW.real.dtype).eps / 2
        if not (torch.equal(dW, dWp) and err <= 2 * shape[-1] * u):
            raise AssertionError(f"the key mode {name}: dW or the key "
                                 f"{a!r} against the plain {b!r}")
        dW_new, dW = _pass_inputs(dtype, shape, device, 200 + seed)
        ms = graph_ms(lambda: residual_(dW_new, dW, write=True, key=key,
                                        scratch=scratch), reps)
        plain_ms = cuda_ms(lambda: loop_pass_reference(
            dW_new, dW, None, write=True, key=key_p), 3)
        library_ms = graph_ms(lambda: library_pass(dW_new, dW), reps)
        bound, by = loop_pass_bound(dtype, shape)
        rows.append(dict(entry="loop_pass_key", name=name, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         share=bound / ms, library_ms=library_ms,
                         max_rel_err_rn=err, max_abs_err=0.0))
        del dW_new, dW, dWp
    real = torch.float32
    decisions = rule_on_keys(device, real)
    state = cuda_graph_loop.start_(cuda_graph_loop.new_state(device), 0.0,
                                   1 << 40, 1)
    state_p = state.clone()
    key = key_of(torch.tensor(1e-3, dtype=real, device=device)).reshape(1)
    rn = torch.empty((), dtype=real, device=device)
    rn_p = torch.empty_like(rn)
    ms = graph_ms(lambda: loop_decide(key, state, rn), reps)
    plain_ms = cuda_ms(lambda: loop_decide_reference(key, state_p, rn_p),
                       reps)
    bound, by = rule_bound(real)
    rows.append(dict(entry="loop_decide", name="float32 (complex64 runs)",
                     decisions_checked=decisions + rule_on_keys(
                         device, torch.float64),
                     ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                     share=bound / ms, library_ms=None, max_abs_err=0.0))
    return rows


def nccl_dp(device, ensemble, backend=None, tol_steps=5, tol=1e-6,
            maxit=10, mhd_B=4):
    """Phase 16b: a one-rank process group (NCCL on the card) through
    ``initialize`` and ``global_mesh``: the dp ensemble of phase 15's
    largest run, bit-equal to it with the same launches; then the mesh's
    adaptive runs (:func:`dp_adaptive`), Euler on that ensemble and MHD
    on ``mhd_B`` members under the scan: on a card one launch a step, the
    all_reduce of the residual's key inside the WHILE node, once an
    iteration."""
    import gc

    import torch.distributed as dist

    from quflow_tpu_torch.parallel.distributed import global_mesh, initialize

    if not initialize(init_method=f"tcp://localhost:{free_port()}",
                      world_size=1, rank=0, backend=backend):
        raise AssertionError("the process group did not come up")
    try:
        mesh = global_mesh()
        name = dist.get_backend()
        if mesh.shape != {"dp": 1, "tp": 1}:
            raise AssertionError(f"mesh {mesh!r}")
        W0 = ensemble["W0"]
        N = W0.shape[-1]
        dt = 0.25 * hbar(N)
        z = torch.zeros_like(W0)
        fn = build_step_fn(N, dt, steps=ensemble["steps_out"],
                           maxit=ensemble["maxit"], dtype=np.complex64,
                           batched=True, mesh=mesh, device=device)
        reset_counts()
        st = (W0, z, z)
        for _ in range(ensemble["calls"]):
            st = fn(*st)
        counts = dict(read_counts(), cgemm=read_gemm())
        if (counts["shear_thomas"], counts["cgemm"]) != (
                ensemble["launches"], ensemble["gemm_launches"]):
            raise AssertionError(f"launches {counts}, phase 15: "
                                 f"{ensemble['launches']} and cgemm "
                                 f"{ensemble['gemm_launches']}")
        if not torch.equal(st[0], ensemble["W"]):
            raise AssertionError("the dp run is not bit-equal to phase 15's")
        euler = dp_adaptive(device, mesh, build_step_fn, W0, tol_steps,
                            tol, maxit)
        S0 = torch.from_numpy(np.stack([
            MHDFlow(N, np.complex64).random_initial(lmax=10, seed=42 + b)
            for b in range(mhd_B)])).to(device)
        with kernel_variable("scan"):
            mhd = dp_adaptive(device, mesh, build_mhd_step_fn, S0, tol_steps,
                              tol, maxit)
        if on_card(device) and not mhd["counts"]["shear_scan"]:
            raise AssertionError(f"the MHD run under the scan launched "
                                 f"{mhd['counts']}")
        gc.collect()
        if on_card(device):
            torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    return dict(backend=name, mesh=mesh.shape, B=W0.shape[0],
                launches=counts, bit_equal_to_phase_15=True,
                adaptive_iterations=euler["iterations"],
                all_reduces=euler["counts"]["all_reduces"],
                adaptive={f"euler_c64_N{N}_B{W0.shape[0]}": euler,
                          f"mhd_c64_N{N}_B{mhd_B}_scan": mhd},
                note="one rank: the mechanics of the all_reduce inside the "
                     "WHILE node, not the max across ranks")


def gemm_kernels(device, shape, dtype=torch.complex64, reps=3):
    """The kernels cuBLAS runs for a complex product of two ``shape``
    tensors: (those of the full-precision product only, those of the TF32
    product only), from ``reps`` profiled products of each.  A kernel both
    run (a split-K reduction, say) is in neither.  A profile that shows
    no kernel (the profiler can miss a short window) is taken again, up
    to three times."""
    g = torch.Generator(device=device).manual_seed(7)
    a, b = (torch.randn(shape, dtype=dtype, device=device, generator=g)
            for _ in range(2))

    def products():
        for _ in range(reps):
            a @ b

    def tf32_products():
        with config.tf32_matmul():
            products()

    def names(fn):
        for _ in range(3):
            table = kernel_table(fn, reps)[0]
            if table:
                return set(table)
        return set()

    full, tf32 = names(products), names(tf32_products)
    return full - tf32, tf32 - full


def is_tf32_gemm(name):
    """Whether cuBLAS's kernel ``name`` is a GEMM on tensor cores (TF32 for
    float32 operands: 'tensorop', 'tf32' in the name) and not one on the
    FP32 pipes ('ffma', 'simt'), nor the port's full-precision product
    (csrc/cgemm_tf32x3.cu, three TF32 passes)."""
    name = name.lower()
    return ("gemm" in name and ("tensorop" in name or "tf32" in name)
            and "cgemm_tf32x3" not in name)


def is_split_pass(name):
    """Whether ``name`` is the split pass of the port's full-precision
    product (csrc/cgemm_tf32x3.cu): a part of a GEMM, not one."""
    return "cgemm_tf32x3_split" in name


def gemm_split(table, full, tf32):
    """The GEMM kernels of a kernel table: ({name: launches a step} of the
    full-precision ones, the same of the TF32 ones).  A kernel is TF32 if
    the TF32 probe of gemm_kernels ran it (``tf32``) or, when neither
    probe did, if is_tf32_gemm says so; full-precision if the other probe
    ran it (``full``) or it is named like a GEMM."""
    split = ({}, {})
    for k, (count, _) in table.items():
        if is_split_pass(k):
            continue
        if k in tf32 or (k not in full and is_tf32_gemm(k)):
            split[1][k] = count
        elif k in full or "gemm" in k.lower():
            split[0][k] = count
    return split


def gemm_counts(table, full, tf32):
    """(full-precision GEMM launches a step, TF32 GEMM launches a step,
    GEMM ms a step) of a kernel table (see gemm_split)."""
    on_full, on_tf32 = gemm_split(table, full, tf32)
    ms = sum(table[k][1] for k in (*on_full, *on_tf32))
    return sum(on_full.values()), sum(on_tf32.values()), ms


def top_kernels(table, n=6):
    return [dict(name=k[:80], launches_a_step=c, ms_a_step=ms)
            for k, (c, ms) in sorted(table.items(), key=lambda kv: -kv[1][1])
            [:n]]


def warm_euler(device, N=1024, steps=1000, chunk=100, maxit=5):
    """Phase 17a: ``IsompTorch()`` (warm 'high': the first maxit - 2
    iterations on TF32 GEMMs) against ``IsompTorch(warm_precision=None)``,
    Euler complex64 from the README state, ``steps`` steps in calls of
    ``chunk`` on a card tensor: exactly maxit ``shear_thomas`` launches a
    step in both; enstrophy (tr(W^2)) drift <= 1e-4 in both (the c64
    gate) and the tr(W^3) drift; the largest deviation between the two
    trajectories at the end of each call; from one profiled call of each,
    the GEMMs a step: 2 (maxit - 2) TF32 and 4 full-precision ones warm,
    2 maxit full-precision ones not."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("cuBLAS's TF32 flag is on before phase 17a: "
                             "an earlier phase left it changed")
    W0 = torch.from_numpy(EulerFlow(N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    dt = 0.25 * hbar(N)
    c0 = casimirs(W0)
    full_k, tf32_k = gemm_kernels(device, (N, N))
    out, snaps = {}, {}
    warm_iters = maxit - 2
    expected_gemms = {"warm": (4, 2 * warm_iters), "full": (2 * maxit, 0)}
    for name, kw in (("warm", {}), ("full", {"warm_precision": None})):
        integ = IsompTorch(maxit=maxit, dtype=np.complex64, device=device, **kw)
        W = W0.clone()
        snaps[name] = []
        drift = np.zeros(2)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps // chunk):
            W = integ(W, dt, steps=chunk)
            snaps[name].append(W)
            drift = np.maximum(drift, np.abs(casimirs(W) - c0) / np.abs(c0))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        if counts != {"shear_thomas": steps * maxit, "shear_scan": 0}:
            raise AssertionError(f"{name}: launches {counts}, expected "
                                 f"{steps * maxit} of shear_thomas only")
        if not finite(W):
            raise AssertionError(f"{name}: non-finite state")
        if not drift[0] <= 1e-4:
            raise AssertionError(f"{name}: enstrophy drift {drift[0]:.3e} "
                                 "> 1e-4")
        table, _ = kernel_table(lambda: integ(W, dt, steps=2), 2)
        n_full, n_tf32, gemm_ms = gemm_counts(table, full_k, tf32_k)
        if (round(n_full, 6), round(n_tf32, 6)) != expected_gemms[name]:
            raise AssertionError(
                f"{name}: GEMMs a step {n_full} full, {n_tf32} TF32, "
                f"expected {expected_gemms[name]}; kernels "
                f"{top_kernels(table, 12)}")
        on_full, on_tf32 = gemm_split(table, full_k, tf32_k)
        out[name] = dict(warm_precision=integ.warm_precision,
                         launches=counts["shear_thomas"],
                         enstrophy_drift=drift[0], tr_W3_drift=drift[1],
                         gemms_a_step_full=n_full, gemms_a_step_tf32=n_tf32,
                         full_gemm_kernels=on_full, tf32_gemm_kernels=on_tf32,
                         gemm_ms_a_step=gemm_ms, steps_per_s=steps / sec)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the warm runs left cuBLAS's TF32 flag on")
    deviation = max(ratio(a, b) for a, b in zip(snaps["warm"], snaps["full"]))
    return dict(N=N, steps=steps, maxit=maxit, warm_iters=warm_iters,
                probe_full_kernels=sorted(full_k),
                probe_tf32_kernels=sorted(tf32_k),
                max_trajectory_deviation=deviation, **out)


def warm_ensemble(device, N=1024, B=16, steps_out=20, calls=2, maxit=5):
    """Phase 17b: phase 15a's B=16 ensemble (``build_step_fn``,
    ``batched=True``) with warm_precision 'high' against None, read in
    turns in one process (full, warm, warm, full): launches; per-state
    steps/s of each reading; from one profiled call of each, the card's
    ms a step, CGEMM ms a step (the GEMM kernels' own time) and the idle
    share (1 - device ms / the readings' median host ms a step); the
    relative difference of the two after one call."""
    members = torch.from_numpy(euler_members(N, B, np.complex64)).to(device)
    z = torch.zeros_like(members)
    dt = 0.25 * hbar(N)
    steps = steps_out * calls
    fns = {name: build_step_fn(N, dt, steps=steps_out, maxit=maxit,
                               dtype=np.complex64, batched=True,
                               warm_precision=wp, device=device)
           for name, wp in (("full", None), ("warm", "high"))}
    first = {name: fn(members, z, z)[0] for name, fn in fns.items()}
    full_k, tf32_k = gemm_kernels(device, (B, N, N))
    readings = {"full": [], "warm": []}
    launches = {}
    for name in ("full", "warm", "warm", "full"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        st = (members, z, z)
        for _ in range(calls):
            st = fns[name](*st)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        if counts != {"shear_thomas": steps * maxit, "shear_scan": 0}:
            raise AssertionError(f"{name}: launches {counts}")
        if not finite(st[0]):
            raise AssertionError(f"{name}: non-finite state")
        readings[name].append(B * steps / sec)
        launches[name] = counts["shear_thomas"]
    rows = {}
    for name, fn in fns.items():
        table, wall_ms = kernel_table(lambda: fn(members, z, z), steps_out)
        n_full, n_tf32, gemm_ms = gemm_counts(table, full_k, tf32_k)
        device_ms = sum(ms for _, ms in table.values())
        host_ms = B * 1e3 / float(np.median(readings[name]))
        rows[name] = dict(state_steps_per_s=readings[name],
                          device_ms_a_step=device_ms,
                          cgemm_ms_a_step=gemm_ms,
                          gemms_a_step_full=n_full,
                          gemms_a_step_tf32=n_tf32,
                          shear_thomas_ms_a_step=sum(
                              ms for k, (_, ms) in table.items()
                              if "shear_thomas" in k),
                          host_ms_a_step=host_ms,
                          idle_share=1.0 - device_ms / host_ms,
                          top_kernels=top_kernels(table, 4))
    speedup = (float(np.median(readings["warm"]))
               / float(np.median(readings["full"])))
    return dict(N=N, B=B, steps=steps, maxit=maxit, launches=launches,
                probe_full_kernels=sorted(full_k),
                probe_tf32_kernels=sorted(tf32_k),
                warm_vs_full_after_one_call=ratio(first["warm"],
                                                  first["full"]),
                per_state_speedup=speedup, **rows)


def warm_mhd(device, warm, **phase_7):
    """Phase 17c: phase 7's result ``warm`` (``MagmpTorch()``, now warm
    'high') against the same run (``phase_7``: mhd_c64's sizes) with
    ``warm_precision=None``: both hold the energy and Theta spectrum gates
    (<= 1e-4 over 100 steps, checked in mhd_c64)."""
    if warm["warm_precision"] != "high":
        raise AssertionError(f"MagmpTorch() resolved 'auto' to "
                             f"{warm['warm_precision']!r}")
    full = mhd_c64(device, warm_precision=None, **phase_7)
    keys = ("warm_precision", "integrator_launches",
            "integrator_gemm_launches", "energy_drift",
            "theta_spectrum_drift", "cross_helicity_drift",
            "solve_steps_per_s")
    return dict(warm={k: warm[k] for k in keys},
                full={k: full[k] for k in keys})


def karatsuba_euler(device, N=1024, steps=100, maxit=5):
    """Phase 17d: precision 'highest_karatsuba' (each complex product as
    three real float32 products) against 'highest', Euler complex64 from
    the README state, ``steps`` steps: launches, the relative deviation of
    the two, and each one's GEMM ms a step from one profiled call."""
    W0 = torch.from_numpy(EulerFlow(N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    z = torch.zeros_like(W0)
    dt = 0.25 * hbar(N)
    out, states = {}, {}
    for prec in ("highest", "highest_karatsuba"):
        fn = build_step_fn(N, dt, steps=steps, maxit=maxit,
                           dtype=np.complex64, precision=prec, device=device)
        reset_counts()
        states[prec] = fn(W0, z, z)[0]
        counts = read_counts()
        if counts != {"shear_thomas": steps * maxit, "shear_scan": 0}:
            raise AssertionError(f"{prec}: launches {counts}")
        if not finite(states[prec]):
            raise AssertionError(f"{prec}: non-finite state")
        two = build_step_fn(N, dt, steps=2, maxit=maxit, dtype=np.complex64,
                            precision=prec, device=device)
        table, wall_ms = kernel_table(lambda: two(W0, z, z), 2)
        out[prec] = dict(launches=counts["shear_thomas"],
                         gemm_ms_a_step=gemm_counts(table, set(), set())[2],
                         device_ms_a_step=sum(ms for _, ms in table.values()),
                         wall_ms_a_step_profiled=wall_ms)
    return dict(N=N, steps=steps, maxit=maxit,
                karatsuba_vs_highest=ratio(states["highest_karatsuba"],
                                           states["highest"]), **out)


def adaptive_warm(device, N=1024, steps=20, maxit=10, warm_iters=2,
                  tol=1e-6):
    """Phase 17e: ``build_step_fn(tol=...)`` with a warm prefix
    (warm_precision 'high', ``warm_iters``), Euler complex64: the per-step
    counts report only the full-precision iterations, so the launches are
    steps x warm_iters + their sum; beside, the counts without a prefix."""
    W0 = torch.from_numpy(EulerFlow(N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    z = torch.zeros_like(W0)
    dt = 0.25 * hbar(N)
    runs = {}
    for name, kw in (("warm", dict(warm_precision="high",
                                   warm_iters=warm_iters)), ("full", {})):
        fn = build_step_fn(N, dt, steps=steps, maxit=maxit, tol=tol,
                           dtype=np.complex64, device=device, **kw)
        reset_counts()
        W, _, _, counts = fn(W0, z, z)
        launches = read_counts()["shear_thomas"]
        prefix = steps * warm_iters if name == "warm" else 0
        if launches != prefix + int(counts.sum()):
            raise AssertionError(f"{name}: {launches} launches for counts "
                                 f"{counts.tolist()} and a prefix of "
                                 f"{prefix}")
        if not (counts.min() >= 1 and counts.max() <= maxit and finite(W)):
            raise AssertionError(f"{name}: counts {counts.tolist()}")
        runs[name] = dict(launches=launches, counts=counts.tolist(),
                          mean_count=float(counts.float().mean()))
    return dict(N=N, steps=steps, maxit=maxit, tol=tol, warm_iters=warm_iters,
                **runs)


def device_maps(device, N=1024, lmaxes=(10, 128)):
    """Phase 18a: ``build_shr2mat_fn``/``build_mat2shr_fn`` in complex128
    against the host ``shr2mat``/``mat2shr`` (both streaming truncated
    basis blocks) at N, each band limit: within 1e-12 relative to the
    largest entry; the seconds of ``basis_tensor``'s host build and the ms
    of each map on the card."""
    from quflow_tpu_torch import mat2shr
    from quflow_tpu_torch.quantization import torchmaps

    rows = []
    for lmax in lmaxes:
        t0 = time.perf_counter()
        torchmaps.basis_tensor(N, lmax)
        build_s = time.perf_counter() - t0
        to_mat = torchmaps.build_shr2mat_fn(N, lmax, np.complex128,
                                            device=device)
        to_shr = torchmaps.build_mat2shr_fn(N, lmax, np.complex128,
                                            device=device)
        omega = np.random.RandomState(lmax).randn((lmax + 1) ** 2)
        W_host = shr2mat(omega, N=N)
        om = torch.from_numpy(omega).to(device)
        W = to_mat(om)
        mat_err = ratio(W, torch.from_numpy(W_host).to(device))
        Wt = torch.from_numpy(W_host).to(device)
        om_host = torch.from_numpy(mat2shr(W_host, elmax=lmax)).to(device)
        shr_err = ratio(to_shr(Wt), om_host)
        trip = ratio(to_shr(W), om)
        if not max(mat_err, shr_err, trip) <= 1e-12:
            raise AssertionError(f"lmax={lmax}: shr2mat {mat_err:.3e}, "
                                 f"mat2shr {shr_err:.3e}, round trip "
                                 f"{trip:.3e} > 1e-12")
        rows.append(dict(N=N, lmax=lmax, basis_tensor_s=build_s,
                         shr2mat_rel_err=mat_err, mat2shr_rel_err=shr_err,
                         round_trip_rel_err=trip,
                         shr2mat_ms=cuda_ms(lambda: to_mat(om), 10),
                         mat2shr_ms=cuda_ms(lambda: to_shr(Wt), 10)))
    return rows


def device_sht(device, L=256):
    """Phase 18b: ``build_synthesis_fn``/``build_analysis_fn`` at L in
    float64 against the host Gauss-Legendre transform (ops/sht.py) within
    1e-10, and the round trip; float32's error against the float64 host
    reported; ms of each on the card."""
    from quflow_tpu_torch import shr2shc
    from quflow_tpu_torch.ops.sht import shanalysis, shsynthesis
    from quflow_tpu_torch.ops import sht_torch

    flm = shr2shc(np.random.RandomState(L).randn(L * L))
    planes = torch.from_numpy(np.stack([flm.real, flm.imag])).to(device)
    t0 = time.perf_counter()
    f_host = shsynthesis(flm, L, reality=True)
    host_s = time.perf_counter() - t0
    ref_f = torch.from_numpy(np.stack([f_host, np.zeros_like(f_host)])
                             ).to(device)
    fl_host = shanalysis(f_host, L, reality=True)
    ref_flm = torch.from_numpy(np.stack([fl_host.real, fl_host.imag])
                               ).to(device)
    out = dict(L=L, host_synthesis_s=host_s)
    for dtype, gate in ((np.float64, 1e-10), (np.float32, None)):
        t0 = time.perf_counter()
        syn = sht_torch.build_synthesis_fn(L, dtype, device=device)
        ana = sht_torch.build_analysis_fn(L, dtype, device=device)
        setup_s = time.perf_counter() - t0
        f = syn(planes)
        back = ana(f)
        errs = dict(synthesis=ratio(f.double(), ref_f),
                    analysis=ratio(ana(ref_f.to(f.dtype)).double(), ref_flm),
                    round_trip=ratio(back.double(), planes))
        if gate is not None and not max(errs.values()) <= gate:
            raise AssertionError(f"{np.dtype(dtype).name}: {errs} > {gate}")
        name = np.dtype(dtype).name
        out[name] = dict(**{f"{k}_rel_err": v for k, v in errs.items()},
                         setup_s=setup_s,
                         synthesis_ms=cuda_ms(lambda: syn(planes), 10),
                         analysis_ms=cuda_ms(lambda: ana(f), 10))
    return out


def native_poisson(device, N=512):
    """Phase 18c: ``native.solve_poisson_native`` (native/quflow_host.cpp
    built into quflow_tpu_torch/_build/ on the card's host) against the
    port's ``solve_poisson`` on the card, complex128: within 1e-13 N
    (tests/test_native.py's tolerance); the build's seconds, each solve's
    ms."""
    from quflow_tpu_torch import native

    rng = np.random.RandomState(N)
    W = rng.randn(N, N) + 1j * rng.randn(N, N)
    W = W - W.conj().T
    t0 = time.perf_counter()
    if not native.available():
        native.solve_poisson_native(W)  # raises with the build's reason
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    P_host = native.solve_poisson_native(W)
    host_ms = (time.perf_counter() - t0) * 1e3
    reset_counts()
    P = solve_poisson(W, skewh=True)  # numpy in: the default device, the card
    counts = read_counts()
    err = float(np.abs(P - P_host).max())
    if not err <= 1e-13 * N:
        raise AssertionError(f"native vs solve_poisson: {err:.3e} > "
                             f"{1e-13 * N:.1e}")
    if counts != {"shear_thomas": 1, "shear_scan": 0}:
        raise AssertionError(f"launches {counts}")
    Wt = torch.from_numpy(W).to(device)
    return dict(N=N, build_s=build_s, threads=native.threads(),
                max_abs_err=err, launches=counts, native_ms=host_ms,
                card_ms=cuda_ms(lambda: solve_poisson(Wt, skewh=True), 10))


#: phase 19a's shapes timed, (N, tp, B): phase 19b's path, the largest of
#: the checked shapes, a batch of several strips a block, and a rank's
#: block of a shard that a run across cards holds (where y may not stay in
#: shared memory)
BLOCK_TIMED = ((1024, 2, 1), (4096, 4, 1), (1024, 2, 4), (8192, 4, 1))
#: phase 19a's gates on the folded sweeps: complex128 against the
#: unsharded solve, relative to the largest entry; complex64 against the
#: float64 solve of the same float32 system, within 1e-6 or this many
#: times the serial float32 solve's own error, the larger (block_sweeps)
BLOCK_GATE_C128 = 1e-13
BLOCK_ACCURACY_C64 = 3.0
#: the bytes of each phase an element of one batch entry, and of the
#: factors, in units of the real type: SUMMARY reads d, w; FORWARD d, w,
#: binv, u and writes y; BACKWARD reads y, binv, u and writes x
BLOCK_PHASE_BYTES = {"summary": (2, 1), "forward": (4, 3),
                     "backward": (4, 2)}


def block_floor(N, B, dtype, rows):
    """The least ms of each phase of one rank's sweeps, and of the three,
    by the bytes that three launches separated by collectives cannot avoid
    (BLOCK_PHASE_BYTES) over 3.35 TB/s: 64 B an element at complex64, B=1,
    against solve_bound's 28."""
    real = 4 if dtype == torch.complex64 else 8
    ms = {name: 1e3 * (per * B + fac) * real * rows * (N + 1)
          / HBM_BYTES_PER_S
          for name, (per, fac) in BLOCK_PHASE_BYTES.items()}
    return ms, sum(ms.values())


def block_sweeps(device, Ns=(512, 1024, 4096), Bs=(1, 4), tps=(2, 3, 4),
                 timed=BLOCK_TIMED, reps=20, plain_reps=2):
    """Phase 19a: the row blocks of tp ranks swept by ``shear_block`` and
    folded in one process, as the ranks fold them
    (shard_shear.solve_shear_blocks), against the same with the plain
    version (bit-equal), and against the unsharded solve: in complex128
    within BLOCK_GATE_C128 of ``shear_thomas``, relative to the largest
    entry.  In complex64 a float32 solve of the ill-conditioned low-m
    columns (m = 0, +-1) errs by ~1e-5 at N=4096, serial or folded, so
    each is held against the float64 solve of the same float32 system
    (``shear_thomas`` on the factors widened), the folded one's error
    within 1e-6 or BLOCK_ACCURACY_C64 times the serial one's, the larger;
    its difference from
    ``shear_thomas`` is reported, raw and after the m=0 correction that
    every complex64 solve of the steppers applies.  Then one rank's
    launches timed at the ``timed`` (N, tp, B), both dtypes (see
    time_block).  Returns (rows, timings)."""
    rows, timings = [], []
    for dtype, N, B, w, binv, u, d in solve_inputs(device, Ns, Bs):
        whole = shear_thomas(w, binv, u, d)
        c64 = dtype == torch.complex64
        if c64:
            op = _real_factors(N, dtype, device=device, with_op=True)[3]
            exact = shear_thomas(w.double(), binv.double(), u.double(),
                                 d.to(torch.complex128))
            serial_err = ratio(whole, exact)
        for tp in tps:
            x = solve_shear_blocks(w, binv, u, d, tp, shear_block)
            plain = solve_shear_blocks(w, binv, u, d, tp,
                                       shear_block_reference)
            err = (x - plain).abs().max().item()
            if err != 0.0:
                raise AssertionError(
                    f"shear_block {dtype} N={N} B={B} tp={tp}: max abs "
                    f"error {err:.3e} against its plain version")
            row = dict(dtype=str(dtype).split(".")[-1], N=N, B=B, tp=tp,
                       max_abs_err=err, vs_shear_thomas_rel=ratio(x, whole))
            if c64:
                row.update(
                    vs_f64_rel=ratio(x, exact),
                    shear_thomas_vs_f64_rel=serial_err,
                    vs_shear_thomas_rel_m0=ratio(
                        refine_m0(x, d, op), refine_m0(whole.clone(), d, op)))
                ok = row["vs_f64_rel"] <= max(1e-6,
                                              BLOCK_ACCURACY_C64 * serial_err)
            else:
                ok = row["vs_shear_thomas_rel"] <= BLOCK_GATE_C128
            if not ok:
                raise AssertionError(f"shear_block against the unsharded "
                                     f"solve: {row}")
            rows.append(row)
    for dtype in (torch.complex64, torch.complex128):
        for N, tp, B in timed:
            w, binv, u = _real_factors(N, dtype, device=device)
            timings.append(time_block(dtype, N, tp, w, binv, u,
                                      seeded_rhs(device, N, B, dtype), reps,
                                      plain_reps))
    return rows, timings


def time_block(dtype, N, tp, w, binv, u, d, reps, plain_reps):
    """One rank's launches on the block of rank 1 of ``tp``: each phase
    (summary, forward with the backward summary, backward) bit-equal to
    the plain version; the three together and each alone in ms by
    CUDA-graph replay, the plain version's ms by CUDA events, the bound of
    its rows and the share, the floor of three launches (block_floor) and
    its share, and, on a card, the kernel's geometry."""
    opr = ShardedShearOperator(w, binv, u, Mesh(1, tp, 1, range(tp)))
    a, b = opr.rows
    D = d[..., a:b, :].contiguous()
    carry = d[..., 0, :].contiguous()  # any carry: the time is the same
    fac = (opr.w, opr.binv, opr.u)

    def three(block):
        def run():
            block(SUMMARY, *fac, D)
            y, _ = block(FORWARD, *fac, D, carry)
            block(BACKWARD, *fac, y, carry)
        return run

    y, x_end = shear_block(FORWARD, *fac, D, carry)
    y_ref, x_end_ref = shear_block_reference(FORWARD, *fac, D, carry)
    got = (shear_block(SUMMARY, *fac, D)[1], y, x_end,
           shear_block(BACKWARD, *fac, y_ref, carry)[0])
    ref = (shear_block_reference(SUMMARY, *fac, D)[1], y_ref, x_end_ref,
           shear_block_reference(BACKWARD, *fac, y_ref, carry)[0])
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    if err != 0.0:
        raise AssertionError(f"shear_block {dtype} N={N} tp={tp} "
                             f"B={D.shape[0]}: max abs error {err:.3e} "
                             "against its plain version")
    ms = graph_ms(three(shear_block), reps)
    phase_ms = {name: graph_ms(fn, reps) for name, fn in (
        ("summary", lambda: shear_block(SUMMARY, *fac, D)),
        ("forward", lambda: shear_block(FORWARD, *fac, D, carry)),
        ("backward", lambda: shear_block(BACKWARD, *fac, y, carry)))}
    plain_ms = cuda_ms(three(shear_block_reference), plain_reps)
    B, rows = D.shape[0], b - a
    bound_ms, bound_by = solve_bound(N, B, dtype, rows=rows)
    phase_floor_ms, floor_ms = block_floor(N, B, dtype, rows)
    geometry = (cuda_block_solve.geometry(B, rows, N + 1, dtype)
                if D.device.type == "cuda" else None)
    return dict(dtype=str(dtype).split(".")[-1], N=N, tp=tp, B=B,
                rows=rows, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms,
                phase_ms=phase_ms, phase_floor_ms=phase_floor_ms,
                floor_ms=floor_ms, floor_share=floor_ms / ms,
                geometry=geometry)


def check_tp_ran(tp):
    """Phase 19b's gate on its set-up: a backend may refuse two ranks on
    one card (NCCL does; the refusal is named in the phase's line), but one
    of them must bring the group up and run the phase; raises with the
    refusals when none did."""
    if not tp["ran"]:
        raise AssertionError(
            "phase 19b did not run: no backend brought up two ranks on one "
            "card (" + "; ".join(f"{b}: {m}"
                                 for b, m in tp["refusals"].items()) + ")")


def tp_rank(rank, backend, tmp, N, steps, maxit, device, dtype):
    """A rank of phase 19b, in a process of its own (``chip_smoke.py
    --tp-rank ...``): bring up the two-rank group on ``backend`` (its
    rendezvous a file in ``tmp``) and probe each collective of the tp
    step on ``device`` tensors; a refusal up to here is written to
    ``refused_<rank>.txt`` and is no failure.  Then ``MagmpTorch()`` in
    ``dtype`` on the tp = 2 mesh, ``steps`` steps of this rank's rows of
    the state in ``tmp``: its row gathers and ``shear_block`` launches,
    its seconds, and (rank 0) the gathered state, into
    ``rank_<rank>.npz``.  Any failure after the probe raises.  On the CPU
    (the rehearsal of tests/test_torch_chip_smoke.py) the plain sweeps
    are counted as the kernel's launches."""
    import torch.distributed as dist

    from quflow_tpu_torch.parallel import shard_shear
    from quflow_tpu_torch.parallel.distributed import initialize
    from quflow_tpu_torch.parallel.mesh import (
        gather_state,
        make_mesh,
        shard_state,
    )

    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    if device.type == "cpu":
        def counted_sweep(*args):
            shear_block.launches += 1
            return shear_block_reference(*args)

        shard_shear.shear_block = counted_sweep
    try:
        initialize(init_method=f"file://{os.path.join(tmp, 'init')}",
                   world_size=2, rank=rank, backend=backend)
        mesh = make_mesh(dp=1)
        x = torch.full((3, 4), 1.0 + rank, dtype=torch.complex64,
                       device=device)
        mesh.tp_gather(x)
        mesh.tp_sum(x)
        mesh.shift(x, x, torch.empty_like(x), torch.empty_like(x))
        sync()
    except Exception as exc:  # a refusal at set-up: reported, not failed
        msg = f"{type(exc).__name__}: {exc}".strip().splitlines()[0][:300]
        with open(os.path.join(tmp, f"refused_{rank}.txt"), "w") as f:
            f.write(msg)
        if dist.is_initialized():
            dist.destroy_process_group()
        return
    open(os.path.join(tmp, f"probed_{rank}"), "w").close()
    try:
        S0 = np.load(os.path.join(tmp, f"S0_{dtype}.npy"))
        piece = torch.from_numpy(shard_state(S0, mesh)).to(device)
        gathers = []
        gather = mesh.gather_rows

        def counted(*args, **kw):
            gathers.append(1)
            return gather(*args, **kw)

        mesh.gather_rows = counted
        integ = MagmpTorch(maxit=maxit, dtype=dtype, mesh=mesh, device=device)
        reset_counts()
        sync()
        t0 = time.perf_counter()
        out = integ(piece, 0.25 * hbar(N), steps=steps)
        sync()
        sec = time.perf_counter() - t0
        launches = dict(read_counts(), shear_block=shear_block.launches)
        n_gathers = len(gathers)
        mesh.gather_rows = gather
        full = gather_state(out, mesh).cpu().numpy()
        np.savez(os.path.join(tmp, f"rank_{rank}.npz"),
                 state=full if rank == 0 else np.zeros(0),
                 launches=json.dumps(launches), gathers=n_gathers,
                 seconds=sec, backend=dist.get_backend())
        dist.barrier()  # neither rank tears down while the other works
    finally:
        dist.destroy_process_group()


def run_ranks(backend, tmp, N, steps, maxit, timeout, device, dtype):
    """Two processes of ``tp_rank`` on ``backend``: None when both ran, or
    the refusal (what a rank reported, or how it ended before the probe
    passed).  A failure after the probe raises."""
    for f in os.listdir(tmp):
        if not f.startswith("S0_"):
            os.remove(os.path.join(tmp, f))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         backend, tmp, str(N), str(steps), str(maxit), str(device), dtype],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs, timed_out = [], False
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                timed_out = True
                logs.append("")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if not all(os.path.exists(os.path.join(tmp, f"probed_{r}"))
               for r in range(2)):
        # refused at set-up: what a rank wrote, else how its process ended
        for r in range(2):
            path = os.path.join(tmp, f"refused_{r}.txt")
            if os.path.exists(path):
                return open(path).read()
        if timed_out:
            return f"timed out after {timeout} s"
        tail = [ln for log in logs for ln in log.splitlines() if ln.strip()]
        return (tail[-1] if tail else "exited")[:300]
    if timed_out or any(p.returncode != 0 for p in procs):
        raise AssertionError(f"phase 19b on {backend} failed after the "
                             "group came up:\n" + "\n".join(
                                 log[-3000:] for log in logs))
    return None


#: phase 19b's tolerance of the tp run against one rank, of the largest
#: entry: tests/test_torch_distributed.py's, or TP_SPREAD times the spread
#: of two one-rank runs (see tp_mhd), the larger
TP_TOL = {"complex64": 5e-5, "complex128": 1e-12}
TP_SPREAD = 3.0


def tp_mhd(device, N=1024, steps=20, maxit=5, backends=("nccl", "gloo"),
           timeout=300):
    """Phase 19b: MHD at N, ``MagmpTorch()`` on a tp = 2 mesh of two
    processes sharing the card against one-rank ``MagmpTorch()`` on the
    same state, ``steps`` steps, complex64 (the production default, warm)
    and complex128.  Two valid one-rank runs, through ``shear_thomas``
    and through ``shear_scan``, part by their solves' roundings, which
    MHD at N=1024 grows (phase 7: 2.8e-4 in complex64 after 10 steps);
    the tp run (the block sweeps' fold, W P standing in for (P W)^H) must
    lie within TP_TOL or TP_SPREAD times that spread of the
    ``shear_thomas`` run.  Each rank launches ``shear_block`` 3 times an
    iteration and gathers rows 4 times (S, P, B, Theta B), 6 in complex64
    (the m=0 correction's two columns), checked exactly.  NCCL is tried
    first, then gloo (whose collectives stage card tensors through the
    host); a backend that refuses two ranks on one card at set-up is
    reported with its message, and if both refuse, the phase returns the
    refusals with ``ran`` false, which fails the run (check_tp_ran)."""
    dt = 0.25 * hbar(N)
    iters = steps * maxit
    out = dict(N=N, steps=steps, maxit=maxit, launches_a_solve=3)
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("complex64", "complex128"):
            S0 = MHDFlow(N, np.dtype(name)).random_initial(lmax=10, seed=42)
            np.save(os.path.join(tmp, f"S0_{name}.npy"), S0)
            S0t = torch.from_numpy(S0).to(device)
            runs = {}
            for solver in (shear_thomas, shear_scan):
                kw = dict(maxit=maxit, dtype=name, device=device,
                          solver=solver)
                MagmpTorch(**kw)(S0t, dt, steps=1)  # first use: operators
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[solver.__name__] = MagmpTorch(**kw)(S0t, dt, steps=steps)
                torch.cuda.synchronize()
                runs[solver.__name__ + "_s"] = time.perf_counter() - t0
            if "backend" not in out:
                out["refusals"] = {}
                for backend in backends:
                    refusal = run_ranks(backend, tmp, N, steps, maxit,
                                        timeout, device, name)
                    if refusal is None:
                        out["backend"] = backend
                        break
                    out["refusals"][backend] = refusal
                else:
                    return dict(out, ran=False)
            elif run_ranks(out["backend"], tmp, N, steps, maxit, timeout,
                           device, name) is not None:
                raise AssertionError(f"{out['backend']} refused the "
                                     f"{name} run after the complex64 one "
                                     "ran")
            ranks = [dict(np.load(os.path.join(tmp, f"rank_{r}.npz")))
                     for r in range(2)]
            launches = [json.loads(str(r["launches"])) for r in ranks]
            gathers = [int(r["gathers"]) for r in ranks]
            per_iter = 6 if name == "complex64" else 4
            for r in range(2):
                if launches[r] != {"shear_thomas": 0, "shear_scan": 0,
                                   "shear_block": 3 * iters}:
                    raise AssertionError(
                        f"{name} rank {r}: launches {launches[r]}, expected "
                        f"{3 * iters} of shear_block only")
                if gathers[r] != per_iter * iters:
                    raise AssertionError(
                        f"{name} rank {r}: {gathers[r]} row gathers, "
                        f"expected {per_iter * iters}")
            state = torch.from_numpy(ranks[0]["state"]).to(device)
            if not finite(state):
                raise AssertionError(f"the {name} tp run is not finite")
            ref = runs["shear_thomas"]
            spread = ratio(runs["shear_scan"], ref)
            dev = ratio(state, ref)
            tol = max(TP_TOL[name], TP_SPREAD * spread)
            if not dev <= tol:
                raise AssertionError(
                    f"{name} tp = 2 against one rank: {dev:.3e} > {tol:.3e} "
                    f"(scan against thomas {spread:.3e})")
            out[name] = dict(
                vs_one_rank=dev, scan_vs_thomas=spread, tolerance=tol,
                launches_by_rank=launches, gathers_by_rank=gathers,
                tp_steps_per_s=steps / max(float(r["seconds"])
                                           for r in ranks),
                one_rank_steps_per_s=steps / runs["shear_thomas_s"])
    return dict(out, ran=True)


def product_kernels(device, shapes, dtype, reps=3):
    """The kernels of complex ``dtype`` products of tensors of each pair of
    ``shapes``, from profiled products (a profile that shows no kernel is
    taken again, up to three times); copies and elementwise kernels left
    out."""
    names = set()
    g = torch.Generator(device=device).manual_seed(11)
    for sa, sb in shapes:
        a = torch.randn(sa, dtype=dtype, device=device, generator=g)
        b = torch.randn(sb, dtype=dtype, device=device, generator=g)
        for _ in range(3):
            table = kernel_table(lambda: [a @ b for _ in range(reps)], reps)[0]
            if table:
                names |= {k for k in table if "elementwise" not in k
                          and "copy" not in k.lower()}
                break
    return names


def dw_steppers(device, N=512, steps=200, mhd_steps=50, maxit=5, dw_iters=2,
                chunk=50):
    """Phase 20: ``build_dw_step_fn`` (``steps`` steps) and
    ``build_dw_mhd_step_fn`` (``mhd_steps``) at N, maxit 5, dw_iters 2,
    from the README states in float64 planes: relative drift of tr(W^2),
    tr(W^3) and of tr(Theta^2), tr(Theta^3) <= 1e-10; ``shear_thomas``
    launched once an iteration; the GEMM kernels a step by name from a
    profile, told apart by probed complex64 and complex128 products:
    Euler 2 (maxit - dw_iters) = 6 CGEMMs and 2 dw_iters = 4 ZGEMMs, MHD
    4 (maxit - dw_iters) = 12 and 8 (its 6 products an iteration are 4
    launches: two batched over the components); steps/s of the dw Euler
    stepper and the complex128 one (``build_step_fn``) in turns."""
    dt = 0.25 * hbar(N)
    shapes = [((N, N), (N, N)), ((1, N, N), (2, N, N)),
              ((2, N, N), (1, N, N))]
    k64 = product_kernels(device, shapes, torch.complex64)
    k128 = product_kernels(device, shapes, torch.complex128)
    c64_k, c128_k = k64 - k128, k128 - k64

    def of(name, probed, tag):
        """A GEMM kernel of the probed products or, where the profiler
        missed the probe's short window, named by cuBLAS for the type."""
        return name in probed or ("gemm" in name.lower() and tag in name)

    def gemms(fn, st):
        """The GEMM launches a step of two steps of ``fn`` by type, from a
        profile that holds every ``shear_thomas`` launch (maxit a step):
        the profiler at times loses a window's first kernels, and such a
        profile is taken again, up to three times."""
        for _ in range(3):
            table, _ = kernel_table(lambda: fn(*st), 2)
            if sum(c for k, (c, _) in table.items()
                   if "shear_thomas" in k) == maxit:
                break
        return (sum(c for k, (c, _) in table.items() if of(k, c64_k, "cf32")),
                sum(c for k, (c, _) in table.items() if of(k, c128_k, "cf64")),
                table)

    warm = maxit - dw_iters
    out = {}
    for name, build, S0, n_steps, comp, per_iter in (
            ("euler", build_dw_step_fn,
             EulerFlow(N, np.complex128).random_initial(lmax=10, seed=42),
             steps, None, 2),
            ("mhd", build_dw_mhd_step_fn,
             MHDFlow(N, np.complex128).random_initial(lmax=10, seed=42),
             mhd_steps, 1, 4)):
        St = torch.from_numpy(S0).to(device)
        c0 = casimirs(St if comp is None else St[comp])
        n_chunk = min(chunk, n_steps)
        fn = build(N, dt, steps=n_chunk, maxit=maxit, dw_iters=dw_iters,
                   device=device)
        Sp = to_planes(St)
        st = (Sp, torch.zeros_like(Sp), torch.zeros_like(Sp))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps // n_chunk):
            st = fn(*st)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = read_counts()
        if counts != {"shear_thomas": n_steps * maxit, "shear_scan": 0}:
            raise AssertionError(f"dw {name}: launches {counts}")
        S = torch.complex(st[0][0], st[0][1])
        if not finite(S):
            raise AssertionError(f"dw {name}: non-finite state")
        drift = (np.abs(casimirs(S if comp is None else S[comp]) - c0)
                 / np.abs(c0))
        if not (drift <= 1e-10).all():
            raise AssertionError(f"dw {name}: Casimir drift {drift} > 1e-10")
        two = build(N, dt, steps=2, maxit=maxit, dw_iters=dw_iters,
                    device=device)
        n64, n128, table = gemms(two, st)
        expected = (per_iter * warm, per_iter * dw_iters)
        if (round(n64, 6), round(n128, 6)) != expected:
            raise AssertionError(
                f"dw {name}: GEMM kernels a step {n64} complex64, {n128} "
                f"complex128, expected {expected}; kernels "
                f"{top_kernels(table, 12)}")
        out[name] = dict(steps=n_steps, launches=counts["shear_thomas"],
                         casimir_drift=drift.tolist(),
                         cgemm_kernels_a_step=n64, zgemm_kernels_a_step=n128,
                         products_a_step=(6 if name == "mhd" else 2) * maxit,
                         steps_per_s=n_steps / sec)
    # in turns: the dw Euler stepper and the complex128 one
    W0 = torch.from_numpy(EulerFlow(N, np.complex128).random_initial(
        lmax=10, seed=42)).to(device)
    runs = {"dw": build_dw_step_fn(N, dt, steps=chunk, maxit=maxit,
                                   dw_iters=dw_iters, device=device),
            "c128": build_step_fn(N, dt, steps=chunk, maxit=maxit,
                                  dtype=np.complex128, device=device)}
    states = {"dw": to_planes(W0), "c128": W0}
    turns = {"dw": [], "c128": []}
    for name in ("dw", "c128", "c128", "dw"):
        X = states[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name](X, torch.zeros_like(X), torch.zeros_like(X))
        torch.cuda.synchronize()
        turns[name].append(chunk / (time.perf_counter() - t0))
    return dict(N=N, maxit=maxit, dw_iters=dw_iters,
                probed_cgemm_kernels=sorted(k[:72] for k in c64_k),
                probed_zgemm_kernels=sorted(k[:72] for k in c128_k),
                turns_steps_per_s=turns, **out)


def capture_cases(device, n_large=1024, n_small=512, B=16, steps=None):
    """Phase 21's runs: name -> (make, steps a call, the column solve it
    launches).  ``make(eager)`` builds the run (inside ``config.eager()``
    when ``eager``) and returns ``(runner or None, call)``; ``call()``
    takes the run's steps from its fixed initial state and returns its
    outputs, the final state first.  ``steps``, when given, replaces every
    run's steps a call."""
    def stepper_run(build, S0, steps_, **kw):
        N = S0.shape[-1]
        z = torch.zeros_like(S0)

        def make(eager, steps=steps_):
            with config.eager() if eager else contextlib.nullcontext():
                fn = build(N, 0.25 * hbar(N), steps=steps, device=device,
                           **kw)
            return fn, lambda: fn(S0, z, z)
        return make

    def loop_run(fn, S0, steps_, **kw):
        dt = 0.25 * hbar(S0.shape[-1])

        def make(eager, steps=steps_):
            def call():
                with config.eager() if eager else contextlib.nullcontext():
                    stats = {}
                    return fn(S0, dt, steps=steps, stats=stats, **kw), stats
            return None, call
        return make

    def euler(N, dtype, B=None):
        W = (EulerFlow(N, dtype).random_initial(lmax=10, seed=42) if B is None
             else euler_members(N, B, dtype))
        return torch.from_numpy(W).to(device)

    S_mhd = torch.from_numpy(MHDFlow(n_large, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    S_mhd128 = torch.from_numpy(MHDFlow(n_small, np.complex128).random_initial(
        lmax=10, seed=42)).to(device)
    cases = {
        f"euler_c64_N{n_large}_B1_warm": (stepper_run(
            build_step_fn, euler(n_large, np.complex64), 50,
            warm_precision="high"), 50, shear_thomas),
        f"euler_c64_N{n_large}_B{B}_warm": (stepper_run(
            build_step_fn, euler(n_large, np.complex64, B), 10,
            warm_precision="high", batched=True), 10, shear_thomas),
        f"euler_c128_N{n_small}": (stepper_run(
            build_step_fn, euler(n_small, np.complex128), 50,
            dtype=np.complex128), 50, shear_thomas),
        f"mhd_c64_N{n_large}_scan_warm": (stepper_run(
            build_mhd_step_fn, S_mhd, 20, warm_precision="high",
            solver=shear_scan), 20, shear_scan),
        f"adaptive_euler_c128_N{n_large}": (stepper_run(
            build_step_fn, euler(n_large, np.complex128), 20,
            dtype=np.complex128, compsum=True, tol=1e-12, maxit=20),
            20, shear_thomas),
        f"isomp_c128_N{n_large}": (loop_run(
            isomp, euler(n_large, np.complex128), 20), 20, shear_thomas),
        f"magmp_c128_N{n_small}": (loop_run(
            MHDFlow(n_small, np.complex128).step, S_mhd128, 20, tol=1e-12,
            maxit=20), 20, shear_thomas),
    }
    if steps is None:
        return cases
    return {name: (functools.partial(make, steps=steps), steps, kernel)
            for name, (make, _, kernel) in cases.items()}


def graph_pool_bytes(runner):
    """The graph pool of a phase-21 replay: the runner's, or for isomp,
    magmp and the Runge-Kutta integrators that of the captured loop or
    step graph last used."""
    if runner is not None:
        graphs = runner.graphs
    elif isospectral._LOOPS:
        graphs = next(reversed(isospectral._LOOPS.values())).graphs
    else:
        graphs = None
    return None if graphs is None else graphs.pool_bytes()


def loop_of(runner):
    """The parallel.capture.Loop a replayed run went through, or None: a
    runner's adaptive program, or for isomp and magmp (no runner) the
    captured loop last used."""
    if runner is not None:
        return next((p.loop for p in runner._programs.values()
                     if hasattr(p, "loop")), None)
    if isospectral._LOOPS:  # a step graph of integrators/erk has none
        return getattr(next(reversed(isospectral._LOOPS.values())), "loop",
                       None)
    return None


def profiled_a_step(loop, kernel):
    """The fewest launches of ``kernel`` a step that torch.profiler shows
    of a composite step: each piece's once, the WHILE body's too.  CUPTI
    reports at least one pass of a conditional body a graph launch, but
    not always every pass (on an H100 with CUDA 12.8: one a launch for
    ``isomp`` at N=256, every pass at N=1024), so a profile of a device
    loop lies between this and the counters, which hold every pass."""
    return sum(n for g in loop.pieces.values() for k, n in g.advance
               if k is kernel)


def profile_holds(seen, counted, loop):
    """Whether a profile's ``seen`` launches a step agree with the
    counters' ``counted``: equal, or for a device loop (``loop``) between
    one WHILE pass a launch and the counters."""
    if loop is None:
        return round(seen, 6) == round(counted, 6)
    return round(profiled_a_step(*loop), 6) <= round(seen, 6) <= round(
        counted, 6)


def loop_idle(kernel_ms, host_ms, solves, counted):
    """A device loop's second idle share, from the profile's kernel time a
    step: exact where the profile showed every pass of the WHILE body
    (``solves`` equal to the counters'), else an upper bound.  The first,
    1 - the call's CUDA-event span / host ms, is a lower bound: the span
    also covers host work inside the call before the first launch."""
    return dict(kernel_ms_a_step=kernel_ms,
                idle_share_by_profile=1.0 - kernel_ms / host_ms,
                profile_saw_every_pass=round(solves, 6) == round(counted, 6))


def timed_turn(call, device):
    """One turn of a run: ``call()``'s output, its host seconds (clock
    around work that ends in a synchronize) and, on a card, the seconds
    the card's timeline spans from just before the call to its end (CUDA
    events), else None.  A device loop queues its steps back to back, so
    the span is the card's time on them, node gaps included; the profiler
    does not see every pass of a WHILE body."""
    events = None
    if on_card(device):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if events:
        events[0].record()
    out = call()
    if events:
        events[1].record()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    span = events[0].elapsed_time(events[1]) / 1e3 if events else None
    return out, sec, span


def padded_table(call, steps, device, pad=32):
    """kernel_table of ``call`` after ``pad`` spin kernels
    (``torch.cuda._sleep``) on a card: the profiler can lose a window's
    first kernels, and the spins are what it loses; they are dropped from
    the table."""
    def padded():
        if torch.device(device).type == "cuda":
            for _ in range(pad):
                torch.cuda._sleep(1)
        return call()

    table, wall_ms = kernel_table(padded, steps)
    return {k: v for k, v in table.items() if "spin_kernel" not in k}, wall_ms


def replay_vs_eager(device, cases=None, strict=False, top=0, describe=None):
    """Phase 21: each run of :func:`capture_cases` replayed (CUDA graphs)
    against the same run eager (built or called inside ``config.eager()``),
    in turns in one process (eager, replay, replay, eager) after a first
    call of each: the final states (bit-equal expected), steps/s of each
    turn, launches of the column solve a call (counters), and from one
    profiled call of each mode the card's ms a step, the kernels a step,
    the solve's launches a step (the profiled window opens with spin
    kernels, which the profiler may lose in its place; a profile short of
    the counters' is taken again, up to three times)
    and the idle share (1 - device ms / the turns' median host ms a step);
    the graph pool's bytes; a replay's outputs not overwritten by the next
    call.  With ``strict`` a replay that is not bit-equal fails the run;
    without, the kernels that differ are named.  With ``top`` each mode
    lists its ``top`` kernels by time a step; ``describe(name, table)``,
    when given, adds its dict to each mode's row from that mode's
    profile."""
    cases = capture_cases(device) if cases is None else cases
    rows = {}
    for name, (make, steps, kernel) in cases.items():
        runs = {mode: make(mode == "eager") for mode in ("eager", "replay")}
        first_s, outs, turns, launches = {}, {}, {}, {}
        for mode, (_, call) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()  # builds, uploads, and the replay's capture
            torch.cuda.synchronize()
            first_s[mode] = time.perf_counter() - t0
        spans = {}
        for mode in ("eager", "replay", "replay", "eager"):
            call = runs[mode][1]
            reset_counts()
            out, sec, span = timed_turn(call, device)
            turns.setdefault(mode, []).append(steps / sec)
            spans.setdefault(mode, []).append(span)
            n = all_counts()[kernel.__name__]
            if launches.setdefault(mode, n) != n:
                raise AssertionError(f"{name} {mode}: launches {n} and "
                                     f"{launches[mode]} in two calls")
            outs.setdefault(mode, out)
        state = {m: o[0] for m, o in outs.items()}
        diff = (state["replay"] - state["eager"]).abs().max().item()
        if launches["replay"] != launches["eager"]:
            raise AssertionError(f"{name}: launches {launches}")
        if not finite(state["replay"]):
            raise AssertionError(f"{name}: non-finite replay")
        row = dict(kernel=kernel.__name__, steps=steps,
                   bit_equal=bool(torch.equal(state["replay"],
                                              state["eager"])),
                   max_abs_diff=diff, launches_a_call=launches,
                   first_call_s=first_s, steps_per_s=turns)
        if len(outs["replay"]) > 3 and isinstance(outs["replay"][3],
                                                  torch.Tensor):
            row["iterations_equal"] = bool(torch.equal(outs["replay"][3],
                                                       outs["eager"][3]))
        elif isinstance(outs["replay"][-1], dict):
            row["iterations_a_step"] = {m: o[-1]["iterations"]
                                        for m, o in outs.items()}
            row["iterations_equal"] = (outs["replay"][-1]["iterations"]
                                       == outs["eager"][-1]["iterations"])
        names = {}
        profile_name = getattr(kernel, "profile_name", kernel.__name__)
        for mode, (runner, call) in runs.items():
            expected = launches[mode] / steps
            loop = (loop_of(runner) if mode == "replay" and on_card(device)
                    else None)
            fewest = expected if loop is None else profiled_a_step(loop,
                                                                   kernel)
            for _ in range(3):
                table, _ = padded_table(call, steps, device)
                solves = sum(c for k, (c, _) in table.items()
                             if profile_name in k)
                if solves >= fewest:
                    break
            kernel_ms = device_ms = sum(ms for _, ms in table.values())
            host_ms = 1e3 / float(np.median(turns[mode]))
            if loop is not None:  # the turns' span: the profile misses passes
                device_ms = 1e3 * float(np.median(spans[mode])) / steps
            names[mode] = set(table)
            captured = (runner.captured or runner.captured_iteration
                        if runner is not None else mode == "replay"
                        and torch.device(device).type == "cuda")
            row[mode] = dict(
                captured=captured, device_ms_a_step=device_ms,
                host_ms_a_step=host_ms, idle_share=1.0 - device_ms / host_ms,
                kernels_a_step=sum(c for c, _ in table.values()),
                solve_launches_a_step_profiled=solves,
                solve_launches_a_step_counted=expected)
            if loop is not None:
                row[mode].update(device_loop=True, device_ms_by="events",
                                 solve_launches_a_step_fewest_shown=fewest,
                                 **loop_idle(kernel_ms, host_ms, solves,
                                             expected))
            if top:
                row[mode]["top_kernels"] = top_kernels(table, top)
            if describe is not None:
                row[mode].update(describe(name, table))
            if not profile_holds(solves, expected,
                                 None if loop is None else (loop, kernel)):
                raise AssertionError(
                    f"{name} {mode}: the profile shows {solves} "
                    f"{kernel.__name__} a step, the counters {expected}"
                    + ("" if loop is None else
                       f" (one WHILE pass a launch: {fewest})"))
        row["replay"]["graph_pool_bytes"] = graph_pool_bytes(
            runs["replay"][0])
        if strict and not row["bit_equal"]:
            raise AssertionError(f"{name}: the replay differs from the eager "
                                 f"run by {diff:.3e}")
        if not row["bit_equal"]:
            # cuBLAS may pick other kernels under capture: name them; the
            # earlier phases hold the captured runs to the drift gates
            row["kernels_only_replay"] = sorted(k[:72] for k in
                                                names["replay"] - names["eager"])
            row["kernels_only_eager"] = sorted(k[:72] for k in
                                               names["eager"] - names["replay"])
            if not (row["kernels_only_replay"] or row["kernels_only_eager"]):
                raise AssertionError(f"{name}: the replay differs from the "
                                     f"eager run by {diff:.3e} on the same "
                                     "kernels")
        row["speedup"] = (float(np.median(turns["replay"]))
                          / float(np.median(turns["eager"])))
        if (not row["replay"]["captured"]
                and torch.device(device).type == "cuda"):
            raise AssertionError(f"{name}: the replay run did not capture")
        # a replay's outputs are fresh: the next call leaves them be
        runner, call = runs["replay"]
        if runner is not None:
            a = call()
            kept = a[0].clone()
            b = call()
            if not torch.equal(a[0], kept) or a[0].data_ptr() == \
                    b[0].data_ptr():
                raise AssertionError(f"{name}: a replay's output was "
                                     "overwritten by the next call")
        rows[name] = row
    return rows


def hooked_builders(device, n_large=1024, n_small=512):
    """Phase 22's stepper configurations: name -> (build, state, timed,
    QUFLOW_PALLAS_KERNEL or None), ``build(steps, solver=None)`` the
    runner, each callable hook made once here; and the c128 forcing and
    callables that ``isomp`` shares with them."""
    def qg_state(N, dtype):
        flow = GlobalQGFlow(N, dtype, gamma=QG_GAMMA)
        W0 = flow.random_initial(lmax=10, seed=42)
        forcing = qg_forcing(band_forcing(N, dtype, device, W0))
        return flow, torch.from_numpy(W0).to(device), forcing

    flow, W64, force64 = qg_state(n_large, np.complex64)
    dt64 = 0.25 * hbar(n_large)

    def qg(steps, solver=None):
        return flow.stepper(dt64, steps, maxit=5, forcing=force64,
                            strang_splitting=VISCDAMP, warm_precision="high",
                            device=device, solver=solver)

    S0 = MHDFlow(n_large, np.complex64).random_initial(lmax=10, seed=42)
    F0 = band_forcing(n_large, np.complex64, device, S0[0])
    F = torch.stack([F0, 0.1 * F0])

    def mhd(steps, solver=None):
        return build_mhd_step_fn(
            n_large, dt64, steps=steps, maxit=5, dtype=np.complex64,
            forcing=lambda P, S: F, strang_splitting=("heat", {"nu": 1e-4}),
            device=device, solver=solver)

    _, W128, force128 = qg_state(n_small, np.complex128)
    hooks = custom_qg_hooks()

    def custom(steps, solver=None):
        return build_step_fn(n_small, 0.25 * hbar(n_small), steps=steps,
                             maxit=20, dtype=np.complex128, compsum=True,
                             tol=1e-12, forcing=force128, device=device,
                             solver=solver, **hooks)

    return {
        f"qg_c64_N{n_large}_warm": (qg, W64, True, None),
        f"qg_c64_N{n_large}_warm_scan": (qg, W64, True, "scan"),
        f"mhd_c64_N{n_large}_scan": (
            mhd, torch.from_numpy(S0).to(device), False, "scan"),
        f"custom_qg_c128_N{n_small}_tol": (custom, W128, True, None),
    }, force128, hooks


def custom_qg_hooks():
    """Phase 14c's callables: the QG Hamiltonian and the viscdamp Strang
    step as functions of the state."""
    return dict(hamiltonian=functools.partial(solve_globalqg, gamma=QG_GAMMA,
                                              skewh=True),
                strang_splitting=functools.partial(solve_viscdamp, skewh=True,
                                                   **VISCDAMP[1]))


def hooked_cases(device, n_large=1024, n_small=512, steps=20):
    """Phase 22's runs, as :func:`capture_cases` gives them, each callable
    hook captured with its step: 22a-d the steppers of
    :func:`hooked_builders`, 22e ``isomp`` with phase 14c's callables and
    timed forcing, 22f ``magmp`` with a constant forcing.  A call of a run
    is two calls of ``steps`` steps, the second from the first's state
    and, for a timed run, at t0 advanced by those steps (a time baked into
    a graph would replay the first call's times); its steps are the two
    calls'.  The hooks are made once, so that ``isomp``/``magmp`` find at
    each call the loops captured at the first."""
    builders, force128, hooks = hooked_builders(device, n_large, n_small)

    def stepper_run(build, S0, timed, variable):
        dt = 0.25 * hbar(S0.shape[-1])
        z = torch.zeros_like(S0)

        def make(eager):
            with config.eager() if eager else contextlib.nullcontext(), \
                    kernel_variable(variable) if variable \
                    else contextlib.nullcontext():
                fn = build(steps)

            def call():
                st = fn(S0, z, z, *((0.0,) if timed else ()))
                return fn(*st[:3], *((steps * dt,) if timed else ()))
            return fn, call
        return make

    def loop_run(fn, S0, **kw):
        dt = 0.25 * hbar(S0.shape[-1])

        def make(eager):
            def call():
                with config.eager() if eager else contextlib.nullcontext():
                    S = fn(S0, dt, steps=steps, time=0.0, **kw)
                    stats = {}
                    return fn(S, dt, steps=steps, time=steps * dt,
                              stats=stats, **kw), stats
            return None, call
        return make

    cases = {name: (stepper_run(*spec), 2 * steps,
                    shear_scan if spec[3] == "scan" else shear_thomas)
             for name, spec in builders.items()}
    W128 = builders[f"custom_qg_c128_N{n_small}_tol"][1]
    S1 = MHDFlow(n_small, np.complex128).random_initial(lmax=10, seed=42)
    F1 = band_forcing(n_small, np.complex128, device, S1[0])
    F1 = torch.stack([F1, 0.1 * F1])
    cases[f"isomp_c128_N{n_small}"] = (loop_run(
        isomp, W128, tol=1e-300, minit=5, maxit=5, compsum=True,
        forcing=force128, **hooks), 2 * steps, shear_thomas)
    cases[f"magmp_c128_N{n_small}"] = (loop_run(
        magmp, torch.from_numpy(S1).to(device), tol=1e-12, maxit=20,
        forcing=lambda P, S: F1), 2 * steps, shear_thomas)
    return cases


def hooked_vs_plain(device, n_large=1024, compare_steps=(10, 10, 5)):
    """Phase 22a-c's kernels inside their replayed hooked steps against
    their plain versions, which run inside ``config.eager()`` (a captured
    plain solve is thousands of graph nodes): ``compare_steps`` steps of
    each of the three complex64 configurations from its state; relative
    to the largest entry, <= 1e-5."""
    builders, _, _ = hooked_builders(device, n_large=n_large)
    rows = {}
    for (name, (build, S0, timed, variable)), n in zip(
            list(builders.items())[:3], compare_steps):
        kernel, plain = ((shear_scan, shear_scan_reference)
                         if variable == "scan"
                         else (shear_thomas, shear_thomas_reference))
        z = torch.zeros_like(S0)
        t0 = (0.0,) if timed else ()
        fn = build(n, kernel)
        Sk = fn(S0, z, z, *t0)[0]
        with config.eager():
            Sp = build(n, plain)(S0, z, z, *t0)[0]
        rel = ratio(Sk, Sp)
        if not rel <= 1e-5:
            raise AssertionError(f"{name}: {n} steps kernel vs plain: "
                                 f"relative difference {rel:.3e} > 1e-5")
        rows[name] = dict(kernel=kernel.__name__, steps=n,
                          captured=fn.captured, kernel_vs_plain=rel)
    return rows


def hooked_stepper_vs_isomp(device, N=512, steps=20, maxit=5):
    """Phase 22e's second check: phase 14c's stepper (the named QG
    Hamiltonian and viscdamp step, ``maxit`` iterations a step through
    tol=1e-300) against ``isomp`` with the callables, both replayed,
    within 1e-11 of max|W|."""
    flow = GlobalQGFlow(N, np.complex128, gamma=QG_GAMMA)
    W0 = flow.random_initial(lmax=10, seed=42)
    forcing = qg_forcing(band_forcing(N, np.complex128, device, W0))
    dt = 0.25 * hbar(N)
    Wt = torch.from_numpy(W0).to(device)
    z = torch.zeros_like(Wt)
    fn = flow.stepper(dt, steps, maxit=maxit, minit=maxit, tol=1e-300,
                      forcing=forcing, strang_splitting=VISCDAMP,
                      device=device)
    Ws = fn(Wt, z, z, 0.0)[0]
    Wr = isomp(Wt, dt, steps, time=0.0, tol=1e-300, minit=maxit, maxit=maxit,
               compsum=True, forcing=forcing, **custom_qg_hooks())
    diff = ratio(Ws, Wr)
    if not diff <= 1e-11:
        raise AssertionError(f"stepper vs isomp: {diff:.3e} > 1e-11 of "
                             "max|W|")
    return dict(N=N, steps=steps, maxit=maxit, stepper_vs_isomp=diff,
                stepper_captured_iteration=fn.captured_iteration)


def numpy_forcing(P, W):
    """A forcing that a capture cannot hold: its result is numpy."""
    return np.zeros(tuple(W.shape))


def host_read_forcing(P, W, time=0.0):
    """A forcing that a capture cannot hold: it reads time on the host."""
    return 1e-3 * math.cos(time) * W


def hook_raises(device, N=512, steps=2):
    """Phase 22g: hooks that a capture cannot hold.  On a card a forcing
    that returns numpy raises TypeError at its runner's first call, and
    one that reads time on the host (``math.cos`` of the 0-d tensor)
    raises RuntimeError, each naming the hook and ``config.eager()``;
    inside ``config.eager()`` both run.  Off a card nothing is captured
    and both run."""
    W = torch.from_numpy(EulerFlow(N, np.complex128).random_initial(
        lmax=10, seed=42)).to(device)
    z = torch.zeros_like(W)
    card = torch.device(device).type == "cuda"
    rows = {}
    for forcing, error, t0 in ((numpy_forcing, TypeError, ()),
                               (host_read_forcing, RuntimeError, (0.0,))):
        def build():
            return build_step_fn(N, 0.25 * hbar(N), steps=steps,
                                 dtype=np.complex128, forcing=forcing,
                                 device=device)

        message = None
        if card:
            try:
                build()(W, z, z, *t0)
            except error as e:
                message = str(e)
            if (message is None or "config.eager()" not in message
                    or forcing.__name__ not in message):
                raise AssertionError(
                    f"{forcing.__name__}: the first call raised {message!r}, "
                    f"not {error.__name__} naming the hook and "
                    "config.eager()")
        with config.eager():
            out = build()(W, z, z, *t0)[0]
        if not finite(out):
            raise AssertionError(f"{forcing.__name__}: non-finite eager run")
        rows[forcing.__name__] = dict(
            error=error.__name__ if card else None,
            message=None if message is None else message[:160],
            eager_ran=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 23: the row-packed and interleaved layouts, the planes stepper and
# the wrapped relayout, on row_thomas and the column solves' real lanes
# ---------------------------------------------------------------------------

class RealLanes:
    """The real-lane entry of a column solve as phases 21-23 read it: its
    launches are ``<kernel>_real`` in :func:`read_layout_counts`, its
    kernels carry the column solve's name in a profile."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.__name__ = kernel.__name__ + "_real"
        self.profile_name = kernel.__name__


SHEAR_THOMAS_REAL = RealLanes(shear_thomas)
SHEAR_SCAN_REAL = RealLanes(shear_scan)


def read_layout_counts():
    """The launches of phase 23's kernels: ``row_thomas`` and the column
    solves' real-lane entries (read beside :func:`read_counts`)."""
    return {"row_thomas": row_thomas.launches,
            "shear_thomas_real": shear_thomas.real_launches,
            "shear_scan_real": shear_scan.real_launches}


def all_counts():
    return {**read_counts(), **read_layout_counts()}


def row_bound(R, N, B, dtype):
    """The least time (ms) of a row solve of B complex (R, N) arrays and
    what bounds it: (16 B + 12) R N bytes in complex64 (twice in
    complex128) over 3.35 TB/s, or 10 real operations an element over the
    peak outside the tensor cores."""
    real = 4 if dtype == torch.complex64 else 8
    t_bytes = (4 * real * B + 3 * real) * R * N / HBM_BYTES_PER_S
    t_ops = 10 * B * R * N / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def lane_bound(N, L, B, dtype):
    """The same for B real (N, L) arrays of ``dtype`` (float32, float64)
    through a real-lane entry: (8 B + 12) N L bytes in float32, 5 real
    operations an element."""
    real = 4 if dtype == torch.float32 else 8
    peak = PEAK_OPS_PER_S[torch.complex64 if real == 4 else torch.complex128]
    t_bytes = (2 * real * B + 3 * real) * N * L / HBM_BYTES_PER_S
    t_ops = 5 * B * N * L / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def _exact(kernel, plain, w, binv, u, d, what):
    x = kernel(w, binv, u, d)
    err = (x - plain(w, binv, u, d)).abs().max().item()
    if err != 0.0:
        raise AssertionError(f"{what}: max abs error {err:.3e}, not "
                             "bit-equal")
    return x, err


@contextlib.contextmanager
def row_plan_through_out():
    """``row_thomas`` with its launch plan forced to send y through the
    output (the mode of rows too long for shared memory)."""
    plan = cuda_row_solve.plan
    cuda_row_solve.plan = lambda *a, **k: plan(*a, through_out=True)
    try:
        yield
    finally:
        cuda_row_solve.plan = plan


def _row_resident(device, B, R, N, dtype):
    """Whether ``row_thomas`` keeps y resident at this shape (None on the
    CPU, which runs the plain version)."""
    if torch.device(device).type != "cuda":
        return None
    index = torch.device(device).index or 0
    return cuda_row_solve.plan(B, R, N, dtype,
                               cuda_row_solve._sms(index)).resident


def _bounded_row_factors(R, N, dtype, device, seed):
    """Random (R, N) factors of a diagonally dominant row system (|w|, |u|
    < 0.4, binv in (0.2, 0.6)), for rows longer than any pack's."""
    rng = np.random.RandomState(seed)
    real = torch.float32 if dtype == torch.complex64 else torch.float64
    return tuple(torch.from_numpy(a).to(device, real) for a in (
        rng.uniform(-0.4, 0.4, (R, N)), rng.uniform(0.2, 0.6, (R, N)),
        rng.uniform(-0.4, 0.4, (R, N))))


def layout_kernels(device, Ns=(512, 1024, 2048, 4096), Bs=(1, 4),
                   ragged=(1, 6, 7, 100, 257, 514, 1000), large_B=16,
                   offset_Ns=(6, 7, 257, 514, 1000),
                   long_rows=((torch.complex64, 32768),
                              (torch.complex128, 16384)),
                   lane_Ns=(7, 100, 512, 1000, 1024, 4096),
                   lane_offset_Ns=(100, 1000), lane_edge_Ns=None):
    """Phase 23a: ``row_thomas`` against its plain version at R = N and
    N//2+1, every N of ``Ns`` and ``ragged``, B in ``Bs`` (and ``large_B``
    up to N = 1024), both dtypes; at ``offset_Ns`` on a d whose storage
    starts one complex value into its buffer and on its aligned twin
    (B = 3), each with y resident and with the plan forced to send y
    through the output; rows too long for shared memory (``long_rows``,
    R = 3, B = 2, bounded random factors); the real-lane entries of
    ``shear_thomas`` and ``shear_scan`` against theirs (:func:`lane_kernels`
    with ``lane_Ns``, ``lane_offset_Ns`` and ``lane_edge_Ns``): every
    comparison bit-equal, one ``row_thomas`` launch a solve."""
    rows = []

    def exact(w, binv, u, d, **row):
        n = row_thomas.launches
        _, err = _exact(row_thomas, row_thomas_reference, w, binv, u, d,
                        f"row_thomas {row}")
        # a CPU tensor runs the plain version, which launches nothing
        if d.is_cuda and row_thomas.launches != n + 1:
            raise AssertionError(f"row_thomas {row}: "
                                 f"{row_thomas.launches - n} launches")
        rows.append(dict(kernel="row_thomas", **row, max_abs_err=err))

    for dtype in (torch.complex64, torch.complex128):
        name = str(dtype)[6:]
        for N in (*Ns, *ragged):
            for layout in ("wrapped", "rolls"):
                w, binv, u = _real_factors(N, dtype, device=device,
                                           layout=layout)
                R = w.shape[0]
                for B in (*Bs, *((large_B,) if N <= 1024 else ())):
                    g = torch.Generator(device=device).manual_seed(7 * N + B)
                    d = torch.randn(B, R, N, dtype=dtype, device=device,
                                    generator=g)
                    exact(w, binv, u, d, dtype=name, N=N, R=R, B=B)
                if N not in offset_Ns:
                    continue
                g = torch.Generator(device=device).manual_seed(N)
                buf = torch.randn(3 * R * N + 1, dtype=dtype, device=device,
                                  generator=g)
                for mode in ("resident", "through_out"):
                    with (row_plan_through_out() if mode == "through_out"
                          else contextlib.nullcontext()):
                        for offset, d in ((1, buf[1:]), (0, buf[:-1])):
                            exact(w, binv, u, d.view(3, R, N), dtype=name,
                                  N=N, R=R, B=3, offset=offset, mode=mode)
    for dtype, N in long_rows:
        w, binv, u = _bounded_row_factors(3, N, dtype, device, N)
        g = torch.Generator(device=device).manual_seed(N)
        d = torch.randn(2, 3, N, dtype=dtype, device=device, generator=g)
        exact(w, binv, u, d, dtype=str(dtype)[6:], N=N, R=3, B=2,
              resident=_row_resident(device, 2, 3, N, dtype))
    return rows + lane_kernels(device, lane_Ns, lane_offset_Ns, lane_edge_Ns)


def lane_views(N, dtype, device, seed, offset=False):
    """The Poisson factors and a seeded rhs of both real-lane views at N:
    ("planes", (w, binv, u), d (2, N, N+1)) and ("interleaved", factors
    with each column twice, d (1, N, 2(N+1))), real ``dtype``; with
    ``offset``, each d a view that starts one value into its buffer."""
    cplx = torch.complex64 if dtype == torch.float32 else torch.complex128
    w, binv, u = _real_factors(N, cplx, device=device)
    il = tuple(f.repeat_interleave(2, dim=-1) for f in (w, binv, u))
    g = torch.Generator(device=device).manual_seed(seed)
    out = []
    for view, fac, shape in (("planes", (w, binv, u), (2, N, N + 1)),
                             ("interleaved", il, (1, N, 2 * (N + 1)))):
        size = math.prod(shape)
        buf = torch.randn(size + int(offset), dtype=dtype, device=device,
                          generator=g)
        out.append((view, fac, buf[int(offset):].view(shape)))
    return out


def lane_plan_of(kernel, d):
    """The launch plan the real-lane entry of ``kernel`` takes for ``d`` on
    its card, as a dict (None on the CPU, which runs the plain version)."""
    if not d.is_cuda:
        return None
    B, (N, L) = d.shape[0], d.shape[-2:]
    sms = cuda_solve.sms(d.device.index or 0)
    plan = (cuda_solve.lane_plan if kernel is shear_thomas
            else cuda_scan_solve.lane_plan)
    return plan(B, N, L, d.dtype, sms)._asdict()


def lane_edges(kernel, view, dtype, sms, lo=1025, hi=4096):
    """(N - 1, N) for the first N in [lo, hi] at which the launch plan of
    ``kernel``'s real-lane entry on ``view`` changes (``shear_thomas``: y
    resident or not; ``shear_scan``: mode, late or cluster size), or ()."""
    def key(N):
        B, L = (2, N + 1) if view == "planes" else (1, 2 * (N + 1))
        if kernel is shear_thomas:
            return cuda_solve.lane_plan(B, N, L, dtype, sms).resident
        p = cuda_scan_solve.lane_plan(B, N, L, dtype, sms)
        return p.mode, p.late, p.cluster
    first = key(lo - 1)
    return next(((N - 1, N) for N in range(lo, hi + 1) if key(N) != first),
                ())


def lane_kernels(device, Ns=(7, 100, 512, 1000, 1024, 4096),
                 offset_Ns=(100, 1000), edge_Ns=None):
    """Phase 23a's real lanes: ``shear_thomas`` and ``shear_scan`` against
    their plain versions on float planes (L = N+1, B = 2) and on the
    interleaved view (L = 2(N+1), factor columns duplicated), and there
    against the complex entry on the same bytes, both dtypes, at every N
    of ``Ns``; at ``offset_Ns`` on a d one value into its buffer; and at
    ``edge_Ns`` ({(kernel name, view, dtype name): Ns}), by default each
    side of the first edge above N = 1024 of each launch plan on the card
    (:func:`lane_edges`; none on the CPU).  Every comparison bit-equal,
    one launch a solve; each row names its launch plan on a card."""
    rows = []
    if edge_Ns is None:
        edge_Ns = {}
        if torch.device(device).type == "cuda":
            sms = cuda_solve.sms(torch.device(device).index or 0)
            edge_Ns = {(k.__name__, view, str(dtype)[6:]):
                       lane_edges(k, view, dtype, sms)
                       for k in (shear_thomas, shear_scan)
                       for view in ("planes", "interleaved")
                       for dtype in (torch.float32, torch.float64)}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        for kernel, plain in ((shear_thomas, shear_thomas_reference),
                              (shear_scan, shear_scan_reference)):
            counter = kernel.__name__ + "_real"
            cases = [(N, False, None) for N in Ns]
            cases += [(N, True, None) for N in offset_Ns]
            cases += [(N, False, view) for view in ("planes", "interleaved")
                      for N in edge_Ns.get((kernel.__name__, view, name), ())]
            for N, offset, only in cases:
                for view, fac, d in lane_views(N, dtype, device, N, offset):
                    if only is not None and view != only:
                        continue
                    what = f"{counter} {view} {name} N={N} offset={offset}"
                    n = read_layout_counts()[counter]
                    x, err = _exact(kernel, plain, *fac, d, what)
                    if d.is_cuda and read_layout_counts()[counter] != n + 1:
                        raise AssertionError(f"{what}: "
                                             f"{read_layout_counts()[counter] - n}"
                                             " launches")
                    row = dict(kernel=counter, view=view, dtype=name, N=N,
                               B=d.shape[0], offset=offset,
                               edge=only is not None, max_abs_err=err,
                               plan=lane_plan_of(kernel, d))
                    if view == "interleaved":
                        cplx = torch.view_as_complex(
                            d.clone().view(1, N, N + 1, 2))
                        xc = torch.view_as_real(kernel(
                            *(f[:, ::2].contiguous() for f in fac),
                            cplx)).reshape(1, N, -1)
                        row["interleaved_vs_complex"] = (
                            x - xc).abs().max().item()
                        if row["interleaved_vs_complex"] != 0.0:
                            raise AssertionError(
                                f"{what}: the real lanes of the interleaved "
                                "view differ from the complex entry by "
                                f"{row['interleaved_vs_complex']:.3e}")
                    rows.append(row)
    return rows


#: phase 23b's ``row_thomas`` shapes: (layout, N, B, dtype); R = N on
#: 'wrapped', N//2+1 on 'rolls'
ROW_TIMES = (("wrapped", 1024, 1, torch.complex64),
             ("rolls", 1024, 1, torch.complex64),
             ("wrapped", 1024, 4, torch.complex64),
             ("wrapped", 512, 1, torch.complex128),
             ("wrapped", 4096, 1, torch.complex64))


#: phase 23b's real-lane shapes: (dtype, view, N), the first the kernel
#: line's
LANE_TIMES = ((torch.float32, "planes", 1024),
              (torch.float32, "interleaved", 1024),
              (torch.float64, "interleaved", 512),
              (torch.float32, "planes", 4096))


def layout_kernel_times(device, reps=20, plain_reps=1, row_times=ROW_TIMES,
                        lane_times=LANE_TIMES):
    """Phase 23b: by CUDA-graph replay, each new entry beside its bound and
    share, the plain version's ms (CUDA events) and, on a card, the launch
    plan and the library's report of it (geometry): ``row_thomas`` at
    ``row_times`` (Euler N=1024 complex64 B=1 for R = N ('wrapped',
    'pallas') and R = 513 ('rolls', 'scatter'), then B = 4, complex128
    N=512, and N=4096, where bytes bound it); the real-lane
    ``shear_thomas`` and ``shear_scan`` at ``lane_times`` on float planes
    (B = 2, L = N+1) and on the interleaved view (B = 1, L = 2(N+1))."""
    out = []
    on_card = torch.device(device).type == "cuda"
    index = torch.device(device).index or 0
    for layout, n, B, dtype in row_times:
        w, binv, u = _real_factors(n, dtype, device=device, layout=layout)
        R = w.shape[0]
        g = torch.Generator(device=device).manual_seed(R)
        d = torch.randn(B, R, n, dtype=dtype, device=device, generator=g)
        ms = graph_ms(lambda: row_thomas(w, binv, u, d), reps)
        bound, by = row_bound(R, n, B, dtype)
        row = dict(kernel="row_thomas", layout=layout, dtype=str(dtype)[6:],
                   R=R, N=n, B=B, ms=ms,
                   plain_ms=cuda_ms(lambda: row_thomas_reference(
                       w, binv, u, d), plain_reps),
                   bound_ms=bound, bound_by=by, share=bound / ms)
        if on_card:
            row["plan"] = cuda_row_solve.plan(
                B, R, n, dtype, cuda_row_solve._sms(index))._asdict()
            row["geometry"] = cuda_row_solve.geometry(B, R, n, dtype, index)
        out.append(row)
    for kernel, plain in ((shear_thomas, shear_thomas_reference),
                          (shear_scan, shear_scan_reference)):
        for dtype, view, N in lane_times:
            fac, d = next((f, x) for v, f, x in lane_views(N, dtype, device, N)
                          if v == view)
            B, L = d.shape[0], d.shape[-1]
            ms = graph_ms(lambda: kernel(*fac, d), reps)
            bound, by = lane_bound(N, L, B, dtype)
            row = dict(kernel=kernel.__name__ + "_real", view=view,
                       dtype=str(dtype)[6:], N=N, L=L, B=B, ms=ms,
                       plain_ms=cuda_ms(lambda: plain(*fac, d), plain_reps),
                       bound_ms=bound, bound_by=by, share=bound / ms)
            if on_card:
                row["plan"] = lane_plan_of(kernel, d)
                row["geometry"] = (
                    cuda_solve.lane_geometry(B, N, L, dtype, index)
                    if kernel is shear_thomas else
                    cuda_scan_solve.lane_geometry(B, N, L, dtype, index))
            out.append(row)
    return out


def _layout_counts_ok(name, counts, layout, n):
    """Raises unless ``counts`` (all_counts) are ``n`` launches of the
    layout's kernel and none of another: ``row_thomas`` on the row
    layouts, the real-lane ``shear_thomas`` on the interleaved ones (a
    counter's name, such as 'shear_scan_real', names it)."""
    key = ("row_thomas" if layout in stepper._ROW_LAYOUTS
           else layout if layout in counts else "shear_thomas_real")
    expected = dict.fromkeys(counts, 0)
    expected[key] = n
    if counts != expected:
        raise AssertionError(f"{name}: launches {counts}, expected {n} of "
                             f"{key} only")


#: phase 23c's layouts: name -> (layout, QUFLOW_SHEAR_INTERLEAVE,
#: QUFLOW_PALLAS_KERNEL, the counter of its solve)
STEP_LAYOUTS = {
    "wrapped": ("wrapped", None, None, "row_thomas"),
    "rolls": ("rolls", None, None, "row_thomas"),
    "pallas": ("pallas", None, None, "row_thomas"),
    "scatter": ("scatter", None, None, "row_thomas"),
    "shear_pallas_il": ("shear_pallas_il", None, None, "shear_thomas_real"),
    "shear_interleave": ("shear", "1", None, "shear_thomas_real"),
    "shear_pallas_il_scan": ("shear_pallas_il", None, "scan",
                             "shear_scan_real"),
}


@contextlib.contextmanager
def interleave_variable(value):
    """QUFLOW_SHEAR_INTERLEAVE set to ``value`` (None: unset) inside the
    block only."""
    old = os.environ.pop("QUFLOW_SHEAR_INTERLEAVE", None)
    if value is not None:
        os.environ["QUFLOW_SHEAR_INTERLEAVE"] = value
    try:
        yield
    finally:
        os.environ.pop("QUFLOW_SHEAR_INTERLEAVE", None)
        if old is not None:
            os.environ["QUFLOW_SHEAR_INTERLEAVE"] = old


def layout_steppers(device, runs=((np.complex64, 1024, 100),
                                  (np.complex128, 512, 200)),
                    maxit=5, redirect_N=4096, redirect_steps=5,
                    layouts=tuple(STEP_LAYOUTS)):
    """Phase 23c: the Euler stepper in each layout of ``layouts``, each in
    its own turn, from the README state: complex64 at N=1024 (100 steps,
    phase 4's enstrophy gate, within 1e-5 of max|W| of the 'shear' run
    with the same refine) and complex128 at N=512 (200 steps, Casimir
    drift <= 1e-10, within 1e-11); launches counted (``maxit`` a step of
    ``row_thomas`` on the row layouts, of the real-lane ``shear_thomas``
    on the interleaved ones, and none of another kernel); steps/s of a
    second, replayed call.  Then 'pallas' at N=4096 warns, runs
    ``redirect_steps`` steps on the shear path and launches no
    ``row_thomas``."""
    import warnings

    out = {}
    for dtype, N, steps in runs:
        name = np.dtype(dtype).name
        W0 = torch.from_numpy(EulerFlow(N, dtype).random_initial(
            lmax=10, seed=42)).to(device)
        z = torch.zeros_like(W0)
        c0 = casimirs(W0)
        dt = 0.25 * hbar(N)
        refs = {}

        def shear_run(refine):
            if refine not in refs:
                refs[refine] = build_step_fn(
                    N, dt, steps=steps, maxit=maxit, dtype=dtype,
                    refine=refine, device=device)(W0, z, z)[0]
            return refs[refine]

        rows = {}
        for label in layouts:
            layout, var, kvar, key = STEP_LAYOUTS[label]
            with interleave_variable(var), (kernel_variable(kvar) if kvar
                                            else contextlib.nullcontext()):
                fn = build_step_fn(N, dt, steps=steps, maxit=maxit,
                                   dtype=dtype, layout=layout, device=device)
            refine = stepper._step_setup(N, dt, maxit, dtype, None, None, 1,
                                         stepper._resolve_layout(
                                             N, None, layout))[0]
            reset_counts()
            W = fn(W0, z, z)[0]
            torch.cuda.synchronize()
            counts = all_counts()
            _layout_counts_ok(f"{label} {name}", counts, key, steps * maxit)
            if not finite(W):
                raise AssertionError(f"{label} {name}: non-finite state")
            drift = np.abs(casimirs(W) - c0) / np.abs(c0)
            vs_shear = ratio(W, shear_run(refine))
            if dtype == np.complex64:
                ok = drift[0] <= 1e-4 and vs_shear <= 1e-5
            else:
                ok = (drift <= 1e-10).all() and vs_shear <= 1e-11
            if not ok:
                raise AssertionError(f"{label} {name}: Casimir drift {drift}, "
                                     f"against 'shear' {vs_shear:.3e}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(W0, z, z)
            torch.cuda.synchronize()
            rows[label] = dict(captured=fn.captured, refine=refine,
                               launches=counts, tr_W2_drift=float(drift[0]),
                               tr_W3_drift=float(drift[1]), vs_shear=vs_shear,
                               steps_per_s=steps / (time.perf_counter() - t0))
        out[f"{name}_N{N}"] = dict(steps=steps, maxit=maxit, layouts=rows)
    if redirect_N is None:  # the CPU's rehearsal
        return out
    W0 = torch.from_numpy(EulerFlow(redirect_N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    z = torch.zeros_like(W0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fn = build_step_fn(redirect_N, 0.25 * hbar(redirect_N),
                           steps=redirect_steps, maxit=maxit, layout="pallas",
                           device=device)
    warned = [str(w.message) for w in caught
              if issubclass(w.category, UserWarning)
              and "shear_pallas" in str(w.message)]
    reset_counts()
    W = fn(W0, z, z)[0]
    counts = all_counts()
    if not warned or counts["row_thomas"] or counts["shear_thomas"] != \
            redirect_steps * maxit or not finite(W):
        raise AssertionError(f"'pallas' at N={redirect_N}: warned {warned}, "
                             f"launches {counts}")
    out[f"pallas_N{redirect_N}_redirect"] = dict(
        warning=warned[0][:120], steps=redirect_steps, launches=counts)
    return out


def layout_mhd(device, N128=512, steps128=50, N64=1024, steps64=20, maxit=5,
               layouts=("rolls", "pallas")):
    """Phase 23d: the MHD stepper on 'rolls' and 'pallas': complex128 at
    N=512, 50 steps, within 1e-11 of max|S| of the 'shear' run (quflow_tpu's
    gate, tests/test_shear_layout.py:160) and Theta's Casimirs <= 1e-10;
    complex64 at N=1024, 20 steps, the drift gates alone (Theta's spectrum
    and tr(Theta^2) <= 1e-4: complex64 MHD grows rounding differences);
    ``maxit`` ``row_thomas`` launches a step."""
    out = {}
    for dtype, N, steps in ((np.complex128, N128, steps128),
                            (np.complex64, N64, steps64)):
        name = np.dtype(dtype).name
        S0 = MHDFlow(N, dtype).random_initial(lmax=10, seed=42)
        St = torch.from_numpy(S0).to(device)
        z = torch.zeros_like(St)
        lam0 = theta_spectrum(S0, device)
        c0 = casimirs(St[1])
        dt = 0.25 * hbar(N)
        ref = None
        if dtype == np.complex128:
            ref = build_mhd_step_fn(N, dt, steps=steps, maxit=maxit,
                                    dtype=dtype, device=device)(St, z, z)[0]
        rows = {}
        for layout in layouts:
            fn = build_mhd_step_fn(N, dt, steps=steps, maxit=maxit,
                                   dtype=dtype, layout=layout, device=device)
            reset_counts()
            S = fn(St, z, z)[0]
            torch.cuda.synchronize()
            counts = all_counts()
            _layout_counts_ok(f"MHD {layout} {name}", counts, layout,
                              steps * maxit)
            if not finite(S):
                raise AssertionError(f"MHD {layout} {name}: non-finite")
            drift = np.abs(casimirs(S[1]) - c0) / np.abs(c0)
            lam = theta_spectrum(S.cpu().numpy(), device)
            spec = ((lam - lam0).abs().max() / lam0.abs().max()).item()
            row = dict(launches=counts, tr_Theta2_drift=float(drift[0]),
                       tr_Theta3_drift=float(drift[1]),
                       theta_spectrum_drift=spec)
            if ref is not None:
                row["vs_shear"] = ratio(S, ref)
                ok = (drift <= 1e-10).all() and row["vs_shear"] <= 1e-11
            else:
                ok = spec <= 1e-4 and drift[0] <= 1e-4
            if not ok:
                raise AssertionError(f"MHD {layout} {name}: {row}")
            rows[layout] = row
        out[f"{name}_N{N}"] = dict(steps=steps, maxit=maxit, layouts=rows)
    return out


def planes_stepper(device, N=1024, steps=100, maxit=5, large_N=4096,
                   large_steps=5):
    """Phase 23e: ``build_planes_step_fn`` on float32 planes of the README
    state at N=1024, 100 steps, with the warm schedule ('high_karatsuba')
    and without: the enstrophy gate (tr(W^2) drift <= 1e-4), ``maxit``
    real-lane ``shear_thomas`` launches a step (both planes in one), and
    the pure run within 1e-5 of max|W| of the complex builder at
    precision='highest_karatsuba'; then N=4096, 5 steps: launches and the
    gate."""
    out = {}
    for n, st in ((N, steps), (large_N, large_steps)):
        W0 = torch.from_numpy(EulerFlow(n, np.complex64).random_initial(
            lmax=10, seed=42)).to(device)
        Wp = torch.stack([W0.real, W0.imag]).contiguous()
        zp = torch.zeros_like(Wp)
        c0 = casimirs(W0)
        dt = 0.25 * hbar(n)
        rows = {}
        for label, kw in (("pure", {}), ("warm", dict(
                warm_precision="high_karatsuba"))):
            if n == large_N and label == "warm":
                continue
            fn = stepper.build_planes_step_fn(n, dt, steps=st, maxit=maxit,
                                              device=device, **kw)
            reset_counts()
            Pp = fn(Wp, zp, zp)[0]
            torch.cuda.synchronize()
            counts = all_counts()
            _layout_counts_ok(f"planes {label} N={n}", counts,
                              "shear_pallas_il", st * maxit)
            W = torch.complex(Pp[0], Pp[1])
            if not finite(W):
                raise AssertionError(f"planes {label} N={n}: non-finite")
            drift = np.abs(casimirs(W) - c0) / np.abs(c0)
            if not drift[0] <= 1e-4:
                raise AssertionError(f"planes {label} N={n}: tr(W^2) drift "
                                     f"{drift[0]:.3e} > 1e-4")
            rows[label] = dict(captured=fn.captured, launches=counts,
                               tr_W2_drift=float(drift[0]),
                               tr_W3_drift=float(drift[1]))
            if label == "pure":
                Wc = build_step_fn(n, dt, steps=st, maxit=maxit,
                                   precision="highest_karatsuba",
                                   device=device)(W0, torch.zeros_like(W0),
                                                  torch.zeros_like(W0))[0]
                rows[label]["vs_complex_builder"] = ratio(W, Wc)
                if not rows[label]["vs_complex_builder"] <= 1e-5:
                    raise AssertionError(f"planes N={n}: {rows[label]}")
        out[f"N{n}"] = dict(steps=st, maxit=maxit, **rows)
    return out


def layout_capture_cases(device, N=1024, steps=20):
    """Phase 23f's runs for :func:`replay_vs_eager`: 'pallas' (a row
    layout, ``row_thomas``), 'shear_pallas_il' (the real lanes) and the
    planes stepper, Euler complex64 at N from the README state."""
    W0 = torch.from_numpy(EulerFlow(N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    Wp = torch.stack([W0.real, W0.imag]).contiguous()
    dt = 0.25 * hbar(N)

    def run(build, S0, **kw):
        z = torch.zeros_like(S0)

        def make(eager, steps=steps):
            with config.eager() if eager else contextlib.nullcontext():
                fn = build(N, dt, steps=steps, device=device, **kw)
            return fn, lambda: fn(S0, z, z)
        return make

    return {
        f"pallas_c64_N{N}": (run(build_step_fn, W0, layout="pallas"), steps,
                             row_thomas),
        f"shear_pallas_il_c64_N{N}": (run(build_step_fn, W0,
                                          layout="shear_pallas_il"), steps,
                                      SHEAR_THOMAS_REAL),
        f"planes_N{N}": (run(stepper.build_planes_step_fn, Wp), steps,
                         SHEAR_THOMAS_REAL),
    }


def layout_rank(rank, tmp, cases, steps, maxit, device):
    """A rank of phase 23g, in a process of its own (``chip_smoke.py
    --layout-rank ...``): a two-rank gloo group (its rendezvous a file in
    ``tmp``), then for each ``layout:N:dtype`` of ``cases`` the Euler
    stepper on the tp = 2 mesh, ``steps`` steps of this rank's rows of the
    state in ``tmp``: the launches, the mesh's ``all_to_all``, ``shift``
    and ``gather_rows`` calls, the seconds and (rank 0) the gathered state,
    into ``<case>_rank<rank>.npz``.  On the CPU (the rehearsal) the plain
    row solve is counted as the kernel's launches."""
    import torch.distributed as dist

    from quflow_tpu_torch.parallel.distributed import initialize
    from quflow_tpu_torch.parallel.mesh import (
        gather_state,
        make_mesh,
        shard_state,
    )

    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    if device.type == "cpu":
        def counted(*args):
            row_thomas.launches += 1
            return row_thomas_reference(*args)

        stepper.row_thomas = counted
    initialize(init_method=f"file://{os.path.join(tmp, 'init')}",
               world_size=2, rank=rank, backend="gloo")
    try:
        mesh = make_mesh(dp=1)
        calls = {}
        for op in ("all_to_all", "shift", "gather_rows"):
            def counted_op(*args, _op=op, _fn=getattr(mesh, op), **kw):
                calls[_op] = calls.get(_op, 0) + 1
                return _fn(*args, **kw)
            setattr(mesh, op, counted_op)
        for case in cases.split(","):
            layout, N, dtype = case.split(":")
            N = int(N)
            W0 = np.load(os.path.join(tmp, f"W0_{N}_{dtype}.npy"))
            piece = torch.from_numpy(shard_state(W0, mesh)).to(device)
            z = torch.zeros_like(piece)
            fn = build_step_fn(N, 0.25 * hbar(N), steps=steps, maxit=maxit,
                               dtype=dtype, mesh=mesh, layout=layout,
                               device=device)
            calls.clear()
            reset_counts()
            sync()
            t0 = time.perf_counter()
            out = fn(piece, z, z)[0]
            sync()
            sec = time.perf_counter() - t0
            launches, seen = all_counts(), dict(calls)
            full = gather_state(out, mesh).cpu().numpy()
            np.savez(os.path.join(tmp, f"{case.replace(':', '_')}_rank{rank}"
                                  ".npz"),
                     state=full if rank == 0 else np.zeros(0),
                     launches=json.dumps(launches), calls=json.dumps(seen),
                     seconds=sec)
        dist.barrier()  # neither rank tears down while the other works
    finally:
        dist.destroy_process_group()


#: phase 23g's runs: (the mesh layout, its one-rank twin, N, dtype)
TP_LAYOUT_CASES = (("shard", "wrapped", 512, "complex64"),
                   ("shard", "wrapped", 512, "complex128"),
                   ("scatter", "scatter", 511, "complex64"))


def layouts_tp(device, cases=TP_LAYOUT_CASES, steps=10, maxit=5,
               timeout=300):
    """Phase 23g: 'shard' (the wrapped relayout, N=512) and 'scatter' (the
    gathered skewh rows, N=511) on a tp = 2 gloo mesh of two processes
    sharing the card (as 19b), Euler from the README state, ``steps``
    steps, against one rank: within phase 19b's gate (TP_TOL, or TP_SPREAD
    times the spread of the one-rank twin layout and 'shear' with the same
    refine, the larger).  Each rank launches ``row_thomas`` once an
    iteration and, on 'shard', one ``all_to_all`` and one ``shift`` a pack
    and an unpack (two of each an iteration); every rank gathers rows
    twice an iteration for the products, 'scatter' once more for its
    solve."""
    iters = steps * maxit
    out = dict(steps=steps, maxit=maxit, backend="gloo")
    spec = ",".join(f"{layout}:{N}:{dtype}" for layout, _, N, dtype in cases)
    with tempfile.TemporaryDirectory() as tmp:
        ones = {}
        for layout, twin, N, dtype in cases:
            W0 = EulerFlow(N, np.dtype(dtype)).random_initial(lmax=10,
                                                              seed=42)
            np.save(os.path.join(tmp, f"W0_{N}_{dtype}.npy"), W0)
            Wt = torch.from_numpy(W0).to(device)
            z = torch.zeros_like(Wt)
            dt = 0.25 * hbar(N)
            run = {lay: build_step_fn(N, dt, steps=steps, maxit=maxit,
                                      dtype=dtype, layout=lay, refine=0,
                                      device=device)(Wt, z, z)[0]
                   for lay in (twin, "shear")}
            ones[(layout, N, dtype)] = (run[twin], ratio(run["shear"],
                                                         run[twin]))
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--layout-rank",
             str(r), tmp, spec, str(steps), str(maxit), str(device)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError("phase 23g failed:\n" + "\n".join(
                log[-3000:] for log in logs))
        for layout, twin, N, dtype in cases:
            tag = f"{layout}_{N}_{dtype}"
            ranks = [dict(np.load(os.path.join(tmp, f"{tag}_rank{r}.npz")))
                     for r in range(2)]
            launches = [json.loads(str(r["launches"])) for r in ranks]
            calls = [json.loads(str(r["calls"])) for r in ranks]
            relayout = 2 * iters if layout == "shard" else 0
            want_calls = {"gather_rows": (2 if layout == "shard" else 3)
                          * iters}
            if relayout:
                want_calls.update(all_to_all=relayout, shift=relayout)
            for r in range(2):
                _layout_counts_ok(f"23g {tag} rank {r}", launches[r], layout,
                                  iters)
                if calls[r] != want_calls:
                    raise AssertionError(f"23g {tag} rank {r}: mesh calls "
                                         f"{calls[r]}, expected {want_calls}")
            state = torch.from_numpy(ranks[0]["state"]).to(device)
            one, spread = ones[(layout, N, dtype)]
            dev = ratio(state, one)
            tol = max(TP_TOL[dtype], TP_SPREAD * spread)
            if not (finite(state) and dev <= tol):
                raise AssertionError(f"23g {tag}: against one rank {dev:.3e} "
                                     f"> {tol:.3e}")
            out[tag] = dict(vs_one_rank=dev, one_rank_vs_shear=spread,
                            tolerance=tol, launches_by_rank=launches,
                            mesh_calls_by_rank=calls,
                            tp_steps_per_s=steps / max(float(r["seconds"])
                                                       for r in ranks))
    return out


#: phase 24a's residual sequences: name -> (residuals, tol, maxit, minit),
#: the edges of the exit rule (tests/test_torch_graph_loop.py's RULES)
LOOP_SEQUENCES = {
    "tol": ([1e-3, 1e-6, 1e-9, 1e-12], 1e-8, 10, 1),
    "rn_equal_tol": ([1e-3, 1e-8, 1e-9], 1e-8, 10, 1),
    "stall": ([1e-3, 1e-4, 2e-4, 1e-5], 1e-12, 10, 1),
    "rn_equal_rn_old": ([1e-3, 1e-4, 1e-4, 1e-5], 1e-12, 10, 1),
    "nan": ([float("nan")] * 6, 1e-8, 6, 1),
    "minit": ([1e-20, 1e-30, 1e-40, 1e-50], 1e-8, 10, 3),
    "maxit_cap": ([1.0 / (k + 1) for k in range(8)], 0.0, 5, 1),
    "float_edge": ([1e-3, 1e-6, 1.0000001e-8, 9.9e-9], 1e-8, 10, 1),
}
#: phase 24a's shapes held to the plain version: (name, dtype, shape) over
#: the states, ensembles, MHD's components and the float planes
LOOP_PASS_CHECKS = tuple(
    (f"{name}_N{N}", dtype, shape(N))
    for N in (1, 7, 256, 1000, 1024, 4096)
    for name, dtype, shape in (
        ("c64", torch.complex64, lambda n: (n, n)),
        ("c128", torch.complex128, lambda n: (n, n)),
        ("planes_f32", torch.float32, lambda n: (2, n, n)),
        ("mhd_c128", torch.complex128, lambda n: (2, n, n)))) + (
    ("c64_N1024_B16", torch.complex64, (16, 1024, 1024)),
    ("c128_N1024_B16", torch.complex128, (16, 1024, 1024)),
    ("mhd_c64_N1024_B16", torch.complex64, (16, 2, 1024, 1024)))
#: phase 24a's timed shapes: name -> (dtype, dW's shape, the rest's shapes
#: a pass copied before loop_pass): the shapes of 24b's runs (PWc beside
#: dW; MHD's PWc of both components and BTc) and more, both dtypes, B=16
LOOP_PASS_TIMES = {
    **{f"{c}_N{N}": (dtype, (N, N), [(N, N)])
       for c, dtype in (("c64", torch.complex64),
                        ("c128", torch.complex128))
       for N in (256, 512, 1024)},
    "mhd_c128_N512": (torch.complex128, (2, 512, 512),
                      [(2, 512, 512), (512, 512)]),
    "mhd_c64_N1024": (torch.complex64, (2, 1024, 1024),
                      [(2, 1024, 1024), (1024, 1024)]),
    "c128_N1024_B16": (torch.complex128, (16, 1024, 1024),
                       [(16, 1024, 1024)]),
}
#: real operations a value of |dW_new - dW| summed: a subtract, an
#: absolute value and an add (real); two subtracts, two multiplies, an
#: add, a square root and an add (complex, hypot's least)
LOOP_PASS_OPS = {False: 3, True: 7}
PEAK_REAL_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}


def loop_pass_bound(dtype, shape):
    """The least time (ms) of a pass over dW of ``shape``: dW_new and dW
    read once and dW written once over 3.35 TB/s, or its operations over
    the card's peak for the real type (67 / 34 TFLOP/s), the larger;
    and which bounds it."""
    n = math.prod(shape)
    size = torch.empty((), dtype=dtype).element_size()
    real = (torch.float32 if dtype in (torch.float32, torch.complex64)
            else torch.float64)
    by_bytes = 3 * n * size / HBM_BYTES_PER_S * 1e3
    by_ops = n * LOOP_PASS_OPS[dtype.is_complex] / PEAK_REAL_OPS_PER_S[
        real] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def _pass_inputs(dtype, shape, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, dtype=dtype, device=device, generator=g)
            for _ in range(2)]


def _pass_vs_plain(dW_new, dW, state):
    """loop_pass against its plain version on copies of one input: dW and
    the state's words bit-equal (else AssertionError), but for the one
    that keeps rn as rn_old, and rn's relative difference, within 2 N u
    (else AssertionError: a row's N terms summed in two orders, each
    within N u of the exact sum)."""
    dWp, sp = dW.clone(), state.clone()
    rn = torch.empty((), dtype=dW.real.dtype, device=dW.device)
    rn_p = torch.empty_like(rn)
    loop_pass(dW_new, dW, rn, state)
    loop_pass_reference(dW_new, dWp, rn_p, sp)
    words = [k for k in range(state.numel()) if k != cuda_graph_loop.LAST]
    if not (torch.equal(dW, dWp) and torch.equal(state[words], sp[words])):
        raise AssertionError(f"loop_pass {tuple(dW.shape)} {dW.dtype}: dW "
                             f"or the words {state.tolist()[:9]} against "
                             f"the plain {sp.tolist()[:9]}")
    a, b = float(rn), float(rn_p)
    if math.isnan(a) and math.isnan(b):
        return 0.0
    err = abs(a - b) / b if b else abs(a - b)
    u = torch.finfo(rn.dtype).eps / 2
    if not err <= 2 * dW.shape[-1] * u:
        raise AssertionError(f"loop_pass {tuple(dW.shape)} {dW.dtype}: rn "
                             f"{a!r} against the plain {b!r}")
    return err


def _rule_sequences(device):
    """The rule of loop_decide and of loop_pass (its residual made |x| by
    one value x in a zero difference) on each of :data:`LOOP_SEQUENCES`
    in both working precisions, over two steps, against the plain rule:
    the words equal after every decision.  Rows of each run's counts."""
    rows, worst = [], 0
    for dtype in (torch.complex64, torch.complex128):
        real = torch.float32 if dtype == torch.complex64 else torch.float64
        rnp = np.float32 if real == torch.float32 else np.float64
        for name, (seq, tol, maxit, minit) in LOOP_SEQUENCES.items():
            tol_r = float(rnp(tol))
            states = {k: cuda_graph_loop.start_(cuda_graph_loop.new_state(
                d, 2), tol_r, maxit, minit) for k, d in (
                ("decide", device), ("pass", device), ("plain", "cpu"))}
            rn = torch.empty((), dtype=real, device=device)
            decisions = 0
            for _ in range(2):
                for x in seq:
                    go = loop_decide(torch.tensor(x, dtype=real,
                                                  device=device),
                                     states["decide"])
                    dW_new = torch.zeros(3, 4, 4, dtype=dtype, device=device)
                    dW_new[1, 2, 3] = x
                    loop_pass(dW_new, torch.zeros_like(dW_new), rn,
                              states["pass"])
                    loop_decide_reference(torch.tensor(x, dtype=real),
                                          states["plain"])
                    decisions += 1
                    for k in ("decide", "pass"):
                        diff = (states[k].cpu() - states["plain"]).abs().max()
                        worst = max(worst, diff.item())
                        if diff:
                            raise AssertionError(
                                f"{k} {name} {real}: words "
                                f"{states[k].cpu().tolist()} against the "
                                f"plain {states['plain'].tolist()}")
                    if not bool(go):
                        break
            words = states["plain"].tolist()
            rows.append(dict(sequence=name, dtype=str(real).split(".")[1],
                             decisions=decisions,
                             counts=words[cuda_graph_loop.HEADER:],
                             capped=words[cuda_graph_loop.CAPPED]))
    return rows, worst


def replaced_sequence(dW_new, dW, rn, state, rests, bufs):
    """What a pass of the device loop ran after the iteration before
    loop_pass took its place: the residual in torch, its copy into rn,
    dW_new's into dW, each rest's into its static buffer, then the rule
    (``loop_decide``)."""
    rn.copy_((dW_new - dW).abs().sum(-1).max())
    dW.copy_(dW_new)
    for buf, r in zip(bufs, rests):
        buf.copy_(r)
    loop_decide(rn, state)


def library_pass(dW_new, dW):
    """One PyTorch call of the same residual, the matrix inf-norm
    (``torch.linalg.matrix_norm(ord=inf)``, its max over leading indices),
    and dW_new's copy into dW: the yardstick, used nowhere in the port."""
    torch.linalg.matrix_norm(dW_new - dW, ord=float("inf")).max()
    dW.copy_(dW_new)


def _rotated(dtype, shape, rest_shapes, device, seed, budget=128 << 20):
    """Sets of (dW_new, dW, rests, the rests' buffers), as many as make a
    run through them move ``budget`` bytes, more than the card's 50 MB L2
    (at most 64): a launch on one set finds it out of the cache, as a
    pass finds dW."""
    size = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    per = size * 2 + sum(2 * math.prod(r) * size // math.prod(shape)
                         for r in rest_shapes)
    sets = []
    for k in range(min(64, max(1, -(-budget // per)))):
        dW_new, dW = _pass_inputs(dtype, shape, device, seed + k)
        rests = [torch.randn(r, dtype=dtype, device=device)
                 for r in rest_shapes]
        sets.append((dW_new, dW, rests, [torch.empty_like(r) for r in rests]))
    return sets


def _cycled(sets, fn):
    """``fn(*set)`` over the sets in turn, one a call."""
    turn = iter(range(1 << 62))
    return lambda: fn(*sets[next(turn) % len(sets)])


def loop_pass_times(device, reps=48, checks=LOOP_PASS_TIMES):
    """loop_pass at each of ``checks`` by CUDA-graph replay (a launch with
    the rule on, as in the WHILE body), the sequence it replaced (residual,
    copies of rn, dW and the rest, ``loop_decide``) and the library's
    residual and copy, all captured, in turns (replaced, pass, pass,
    replaced), each launch on the next of a rotation of inputs larger than
    the L2 (:func:`_rotated`); its bound and share; the plain version's
    ms; and, before the times, loop_pass against its plain version on the
    first set (:func:`_pass_vs_plain`: rn's relative difference in
    ``max_rel_err_rn``), so that every shape the main path gives it is
    held to the plain version."""
    rows = []
    for name, (dtype, shape, rest_shapes) in checks.items():
        sets = _rotated(dtype, shape, rest_shapes, device, seed=len(rows))
        n = -(-reps // len(sets)) * len(sets)
        err = _pass_vs_plain(sets[0][0], sets[0][1].clone(), start_state(
            device))
        rn = torch.empty((), dtype=sets[0][1].real.dtype, device=device)
        states = [cuda_graph_loop.start_(cuda_graph_loop.new_state(device),
                                         0.0, 1 << 30, 1) for _ in "ab"]
        scratch = cuda_graph_loop.new_scratch(device)
        turns = {"replaced": [], "loop_pass": []}
        for who in ("replaced", "loop_pass", "loop_pass", "replaced"):
            if who == "replaced":
                fn = _cycled(sets, lambda a, b, r, bufs: replaced_sequence(
                    a, b, rn, states[0], r, bufs))
            else:
                fn = _cycled(sets, lambda a, b, r, bufs: loop_pass(
                    a, b, rn, states[1], scratch))
            turns[who].append(graph_ms(fn, n))
        library_ms = graph_ms(_cycled(sets, lambda a, b, r, bufs:
                                      library_pass(a, b)), n)
        dW_new, dW = sets[0][:2]
        plain_ms = cuda_ms(lambda: loop_pass_reference(dW_new, dW, rn,
                                                       states[1]), 3)
        bound, by = loop_pass_bound(dtype, shape)
        ms = float(np.median(turns["loop_pass"]))
        replaced = float(np.median(turns["replaced"]))
        N = shape[-1]
        rows.append(dict(
            name=name, dtype=str(dtype).split(".")[1], shape=list(shape),
            rests=[list(r) for r in rest_shapes], rotation=len(sets),
            plan=list(cuda_graph_loop.plan(math.prod(shape) // N, N, dtype,
                                           sm_count(device))),
            ms=ms, ms_turns=turns["loop_pass"], replaced_ms=replaced,
            replaced_ms_turns=turns["replaced"],
            saved_ms=replaced - ms, bound_ms=bound, bound_by=by,
            share=bound / ms if ms else None, plain_ms=plain_ms,
            library_ms=library_ms, max_rel_err_rn=err))
        del sets
    return rows


def sm_count(device):
    """The SM count loop_pass's plan reads: the card's, 132 on the CPU."""
    if torch.device(device).type != "cuda":
        return 132
    return cuda_solve.sms(torch.device(device).index or 0)


def start_state(device):
    """A state started for a pass held to the plain version: tol 1e-8,
    maxit 5, minit 1."""
    return cuda_graph_loop.start_(cuda_graph_loop.new_state(device), 1e-8,
                                  5, 1)


def loop_pass_vs_plain(device, reps=50, passes=64, checks=LOOP_PASS_CHECKS,
                       times=LOOP_PASS_TIMES):
    """Phase 24a: ``loop_pass`` against its plain version on the card at
    each of ``checks`` and of ``times`` (dW and the state's words
    bit-equal, rn within 2 N u: the largest relative difference in
    ``max_rel_err_rn``); the
    rule of loop_pass and of ``loop_decide`` on the crafted sequences
    against the plain rule (a NaN runs to maxit); its times at ``times``
    beside its bound, the replaced sequence's, the library's and the plain
    version's (:func:`loop_pass_times`); and the WHILE node's cost a pass
    with an empty iteration."""
    worst_rn = 0.0
    for k, (name, dtype, shape) in enumerate(checks):
        dW_new, dW = _pass_inputs(dtype, shape, device, seed=k)
        worst_rn = max(worst_rn, _pass_vs_plain(dW_new, dW,
                                                start_state(device)))
        del dW_new, dW
    sequences, worst = _rule_sequences(device)
    timed = loop_pass_times(device, reps, times)
    worst_rn = max([worst_rn] + [r["max_rel_err_rn"] for r in timed])
    main = next(r for r in timed if r["name"] == "c128_N1024")
    return dict(checked=[name for name, _, _ in checks] + list(times),
                max_rel_err_rn=worst_rn, sequences=sequences,
                max_abs_err=float(worst), times=timed,
                **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "share", "library_ms",
                                        "replaced_ms")},
                **while_pass_ms(device, passes))


def while_pass_ms(device, passes, reps=20):
    """The card's ms a pass of a WHILE node whose body is an empty graph
    and ``loop_pass`` over one float64 NaN (``passes`` passes against one:
    a NaN never settles), and the ms of a launch of one pass, by CUDA
    events."""
    if not on_card(device):
        return dict(while_pass_ms=None, one_pass_launch_ms=None)
    dW_new = torch.full((1, 1), float("nan"), dtype=torch.float64,
                        device=device)
    dW = torch.zeros_like(dW_new)
    rn = torch.empty((), dtype=torch.float64, device=device)
    sink = torch.zeros(1, device=device)
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    for piece in (lambda: None, lambda: sink.add_(1)):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=pool):
            piece()
        graphs.append(graph)
    state = cuda_graph_loop.new_state(device)
    loop = cuda_graph_loop.Composite(
        None, None, *(g.raw_cuda_graph() for g in graphs), dW_new, dW, rn,
        state, cuda_graph_loop.new_scratch(device))
    times = {}
    for n in (1, passes):
        cuda_graph_loop.start_(state, 0.0, n, 1)
        loop.launch(reps)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        cuda_graph_loop.start_(state, 0.0, n, 1)
        start.record()
        loop.launch(reps)
        end.record()
        end.synchronize()
        times[n] = start.elapsed_time(end) / reps
        if state[cuda_graph_loop.ITERATIONS].item() != n * reps:
            raise AssertionError(f"the empty WHILE ran "
                                 f"{state.tolist()[:5]} for {n} passes")
    loop.close()
    return dict(while_pass_ms=(times[passes] - times[1]) / (passes - 1),
                one_pass_launch_ms=times[1])


def loop_cases(device, n_small=256, n_large=1024, n_mhd=512, steps=100,
               steps_out=20, call_steps=20):
    """Phase 24b's runs: name -> (make, steps a call, the column solve,
    integrator calls a call).  ``make(eager)`` gives ``(runner or None,
    call)``; ``call()`` runs from a fixed initial state and returns (the
    final state, the iterations of each step or the mean a step)."""
    def quickstart(N):
        W0 = EulerFlow(N, np.complex128).random_initial(lmax=10, seed=42)

        def make(eager):
            def call():
                chunks = []

                def cb(W, delta_time=0.0, delta_steps=0, **stats):
                    if delta_steps:
                        chunks.append(delta_steps * stats["iterations"])

                with config.eager() if eager else contextlib.nullcontext():
                    # the README's call: no integrator, no device
                    W = solve(W0.copy(), stepsize=0.25, steps=steps,
                              steps_out=steps_out, callback=cb,
                              progress_bar=False)
                return torch.from_numpy(np.asarray(W)), sum(chunks) / steps
            return None, call
        return make

    def reference(fn, S0, **kw):
        dt = 0.25 * hbar(S0.shape[-1])

        def make(eager):
            def call():
                stats = {}
                with config.eager() if eager else contextlib.nullcontext():
                    S = fn(S0, dt, steps=call_steps, stats=stats, **kw)
                return S, stats["iterations"]
            return None, call
        return make

    def stepper(build, S0, t0=(), **kw):
        N = S0.shape[-1]
        z = torch.zeros_like(S0)

        def make(eager):
            with config.eager() if eager else contextlib.nullcontext():
                fn = build(N, 0.25 * hbar(N), steps=call_steps,
                           device=device, **kw)

            def call():
                out = fn(S0, z, z, *t0)
                return out[0], out[3]
            return fn, call
        return make

    def card(x):
        return torch.from_numpy(x).to(device)

    builders, _, _ = hooked_builders(device, n_large, n_mhd)
    custom, W_custom, _, _ = builders[f"custom_qg_c128_N{n_mhd}_tol"]

    def custom_make(eager):
        z = torch.zeros_like(W_custom)
        with config.eager() if eager else contextlib.nullcontext():
            fn = custom(call_steps)

        def call():
            out = fn(W_custom, z, z, 0.0)
            return out[0], out[3]
        return fn, call

    calls = steps // steps_out
    return {
        f"quickstart_isomp_c128_N{n_small}": (
            quickstart(n_small), steps, shear_thomas, calls),
        f"quickstart_isomp_c128_N{n_large}": (
            quickstart(n_large), steps, shear_thomas, calls),
        f"magmp_c128_N{n_mhd}": (reference(
            magmp, card(MHDFlow(n_mhd, np.complex128).random_initial(
                lmax=10, seed=42))), call_steps, shear_thomas, 1),
        f"euler_c128_N{n_large}_tol": (stepper(
            build_step_fn, card(EulerFlow(n_large, np.complex128)
                                .random_initial(lmax=10, seed=42)),
            dtype=np.complex128, compsum=True, tol=1e-12, maxit=20),
            call_steps, shear_thomas, 1),
        f"mhd_c64_N{n_large}_tol": (stepper(
            build_mhd_step_fn, card(MHDFlow(n_large, np.complex64)
                                    .random_initial(lmax=10, seed=42)),
            dtype=np.complex64, tol=1e-6, maxit=10),
            call_steps, shear_thomas, 1),
        f"custom_qg_c128_N{n_mhd}_tol": (custom_make, call_steps,
                                         shear_thomas, 1),
    }


#: 24a's timed shape of each 24b run (dW's and the rest's)
LOOP_RUN_TIMES = {
    "quickstart_isomp_c128_N256": "c128_N256",
    "quickstart_isomp_c128_N1024": "c128_N1024",
    "magmp_c128_N512": "mhd_c128_N512",
    "euler_c128_N1024_tol": "c128_N1024",
    "mhd_c64_N1024_tol": "mhd_c64_N1024",
    "custom_qg_c128_N512_tol": "c128_N512",
}


def _pass_split(table, passes):
    """From a profile's table: (the kernels' ms a step, loop_pass's ms a
    step as shown, loop_pass's launches a step as shown, its mean ms a
    launch)."""
    kernel_ms = sum(ms for _, ms in table.values())
    shown = [(c, ms) for k, (c, ms) in table.items() if "loop_pass" in k]
    count = sum(c for c, _ in shown)
    ms = sum(m for _, m in shown)
    return kernel_ms, ms, count, (ms / count if count else None)


def device_loop(device, cases=None, pass_times=None):
    """Phase 24b: each run of :func:`loop_cases` through the device loop
    (one launch a step, the exit on the card) against its
    ``config.eager()`` twin (the host loop, a read an iteration), in turns
    in one process (eager, loop, loop, eager) after a first call of each:
    bit-equal states and equal iterations; steps/s of each turn; host ms a
    step (the turns' median); the card's ms a step, eager from a profile
    (the kernels' own time), the loop by CUDA events around a call (the
    profile need not show every pass of a WHILE body), and the idle share,
    for the loop also from the profile (:func:`loop_idle`); host reads
    (``Tensor.item``/``tolist``) an integrator call, at most 2 in the loop
    (its counts or stats, and the 'auto' tolerance); launches of the
    column solve and of ``loop_pass`` by counter (equal in both modes: the
    host loop's residual is loop_pass with the rule off) and by profile
    (eager: every launch; the loop: between every piece and one WHILE pass
    a launch, and the counters).  Kernel ms a step split into the
    iteration and the pass: the host loop's from its profile; the loop's
    pass as loop_pass's mean ms a launch in its profile times the passes
    counted (and, with ``pass_times``, 24a's ms at the run's shape times
    them), its iteration from its profile where that showed every pass,
    else the host loop's (the same kernels, the same counts); the WHILE
    body's nodes (the iteration's graph and loop_pass)."""
    cases = loop_cases(device) if cases is None else cases
    rows = {}
    for name, (make, steps, kernel, calls) in cases.items():
        runs = {mode: make(mode == "eager") for mode in ("eager", "loop")}
        first_s, outs, turns, launches, reads = {}, {}, {}, {}, {}
        for mode, (_, call) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()  # builds, uploads, and the loop's capture
            torch.cuda.synchronize()
            first_s[mode] = time.perf_counter() - t0
        spans = {}
        for mode in ("eager", "loop", "loop", "eager"):
            call = runs[mode][1]
            reset_counts()
            with HostCopies() as copies:
                out, sec, span = timed_turn(call, device)
            turns.setdefault(mode, []).append(steps / sec)
            spans.setdefault(mode, []).append(span)
            n = dict(solve=all_counts()[kernel.__name__],
                     loop_pass=loop_pass.launches,
                     loop_decide=loop_decide.launches)
            if launches.setdefault(mode, n) != n:
                raise AssertionError(f"{name} {mode}: launches {n} and "
                                     f"{launches[mode]} in two calls")
            read = (copies.calls["item"] + copies.calls["tolist"]) / calls
            reads[mode] = max(reads.get(mode, 0), read)
            outs.setdefault(mode, out)
        state = {m: o[0] for m, o in outs.items()}
        iters = {m: o[1] for m, o in outs.items()}
        per_step = {m: (float(i.float().mean()) if isinstance(i, torch.Tensor)
                        else float(i)) for m, i in iters.items()}
        bit_equal = torch.equal(state["loop"], state["eager"])
        iterations_equal = (torch.equal(iters["loop"], iters["eager"])
                            if isinstance(iters["loop"], torch.Tensor)
                            else iters["loop"] == iters["eager"])
        if not (bit_equal and iterations_equal):
            diff = (state["loop"] - state["eager"]).abs().max().item()
            raise AssertionError(f"{name}: the device loop differs from the "
                                 f"host loop by {diff:.3e}, iterations "
                                 f"{per_step}")
        if not finite(state["loop"]):
            raise AssertionError(f"{name}: non-finite state")
        if launches["loop"] != launches["eager"]:
            raise AssertionError(f"{name}: launches {launches}")
        total = round(per_step["loop"] * steps)
        row = dict(kernel=kernel.__name__, steps=steps, integrator_calls=calls,
                   bit_equal=True, iterations_equal=True,
                   iterations_a_step=per_step["loop"],
                   launches_a_call=launches, first_call_s=first_s,
                   steps_per_s=turns, host_reads_a_call=reads)
        loop = None
        if on_card(device):
            loop = loop_of(runs["loop"][0])
            if loop is None:
                raise AssertionError(f"{name}: the loop run went through no "
                                     "device loop")
            if launches["loop"]["loop_pass"] != total or \
                    launches["loop"]["loop_decide"]:
                raise AssertionError(f"{name}: loop_pass launched "
                                     f"{launches['loop']} for {total} "
                                     "iterations")
            if reads["loop"] > 2:
                raise AssertionError(f"{name}: {reads['loop']} host reads a "
                                     "call in the device loop")
            types, count = loop.composite.body_nodes()
            if count != 2 or sorted(types) != [0, 4]:
                raise AssertionError(f"{name}: the WHILE body holds {count} "
                                     f"nodes of types {types}, not the "
                                     "iteration's graph and loop_pass")
            row["while_body_nodes"] = count
            row["iteration_nodes"] = cuda_graph_loop.graph_nodes(
                loop.pieces["body"].graph.raw_cuda_graph())[1]
        profile_name = getattr(kernel, "profile_name", kernel.__name__)
        for mode, (runner, call) in runs.items():
            counted = launches[mode]["solve"] / steps
            held = (loop, kernel) if mode == "loop" and loop else None
            fewest = counted if held is None else profiled_a_step(*held)
            for _ in range(3):
                table, _ = padded_table(call, steps, device)
                solves = sum(c for k, (c, _) in table.items()
                             if profile_name in k)
                if solves >= fewest:
                    break
            kernel_ms, pass_ms, passes, pass_launch_ms = _pass_split(
                table, per_step[mode])
            host_ms = 1e3 / float(np.median(turns[mode]))
            if held is not None:  # the turns' span: the profile misses passes
                device_ms, by = 1e3 * float(np.median(spans[mode])) / steps, \
                    "events"
            else:
                device_ms, by = kernel_ms, "profile"
            row[mode] = dict(
                host_ms_a_step=host_ms, device_ms_a_step=device_ms,
                device_ms_by=by, idle_share=1.0 - device_ms / host_ms,
                solve_launches_a_step_counted=counted,
                solve_launches_a_step_profiled=solves,
                loop_pass_a_step_profiled=passes,
                kernel_ms_a_step_profiled=kernel_ms,
                loop_pass_ms_a_launch=pass_launch_ms)
            if held is not None:
                row[mode].update(solve_launches_a_step_fewest_shown=fewest,
                                 **loop_idle(kernel_ms, host_ms, solves,
                                             counted))
            if not profile_holds(solves, counted, held):
                raise AssertionError(
                    f"{name} {mode}: the profile shows {solves} "
                    f"{kernel.__name__} a step, the counters {counted}"
                    + ("" if held is None else f", one WHILE pass a launch "
                       f"{fewest}"))
            if held is None and on_card(device) and round(passes, 6) != \
                    round(per_step[mode], 6):
                raise AssertionError(
                    f"{name} eager: the profile shows {passes} loop_pass a "
                    f"step, {per_step[mode]} iterations")
            if held is not None and not (
                    1 <= round(passes, 6) <= round(per_step["loop"], 6)):
                raise AssertionError(
                    f"{name}: the profile shows {passes} loop_pass a "
                    f"step, between 1 and {per_step['loop']} expected")
            # the split of kernel ms a step into the iteration and the pass
            if held is None:
                row[mode].update(pass_ms_a_step=pass_ms,
                                 iteration_ms_a_step=kernel_ms - pass_ms)
            elif pass_launch_ms is not None:
                every = row[mode]["profile_saw_every_pass"]
                it_ms = (kernel_ms - pass_ms if every
                         else row["eager"]["iteration_ms_a_step"])
                row[mode].update(
                    pass_ms_a_step=pass_launch_ms * per_step[mode],
                    iteration_ms_a_step=it_ms,
                    iteration_ms_by="own profile" if every
                    else "host loop's profile")
                row[mode]["kernel_ms_a_step_reckoned"] = (
                    it_ms + row[mode]["pass_ms_a_step"])
        if "kernel_ms_a_step_reckoned" in row["loop"]:
            host = row["eager"]["kernel_ms_a_step_profiled"]
            row["kernel_ms_vs_host_loop"] = (
                row["loop"]["kernel_ms_a_step_reckoned"] / host)
            row["span_ms_vs_host_loop"] = (
                row["loop"]["device_ms_a_step"] / host)
            key = LOOP_RUN_TIMES.get(name)
            if pass_times and key in pass_times:
                row["loop"]["pass_ms_a_step_by_24a"] = (
                    pass_times[key] * per_step["loop"])
        row["speedup"] = (float(np.median(turns["loop"]))
                          / float(np.median(turns["eager"])))
        rows[name] = row
    return rows


# ---------------------------------------------------------------------------
# Phase 25: the Runge-Kutta integrators on the card
# ---------------------------------------------------------------------------

#: phase 25's methods: name -> Poisson solves (column-solve launches) a step
ERK_SOLVES = {"euler": 1, "heun": 2, "rk4": 4}


def erk_shape(name):
    """(N, torch dtype) of a phase-25 run from its name,
    ``{method}_{c64|c128}_N{N}[_{what}]``."""
    _, tag, n = name.split("_")[:3]
    return int(n[1:]), {"c64": torch.complex64, "c128": torch.complex128}[tag]


def erk_run(method, S0, steps_, variable=None, **kw):
    """A phase-25 run as :func:`capture_cases` gives one: ``make(eager,
    steps)`` -> (None, call), ``call()`` the integrator ``method`` over
    ``steps`` steps of 0.25 hbar from ``S0`` (inside ``config.eager()``
    when ``eager``; under QUFLOW_PALLAS_KERNEL=``variable`` when given),
    its final state first; ``make.S0`` is the initial state."""
    fn = getattr(erk, method)
    dt = 0.25 * hbar(S0.shape[-1])

    def make(eager, steps=steps_):
        def call():
            with config.eager() if eager else contextlib.nullcontext(), \
                    kernel_variable(variable) if variable \
                    else contextlib.nullcontext():
                return (fn(S0, dt, steps=steps, **kw),)
        return None, call
    make.S0 = S0
    return make


def erk_cases(device, n_large=1024, n_small=512, steps=50):
    """Phase 25's runs replayed against eager: each method at complex64
    N=``n_large`` and complex128 N=``n_small`` from the main path's state
    (25a), ``rk4`` complex64 under QUFLOW_PALLAS_KERNEL=scan (25b) and
    with a constant band-limited forcing, made once (25d)."""
    cases = {}
    for N, dtype, tag in ((n_large, np.complex64, "c64"),
                          (n_small, np.complex128, "c128")):
        W0 = EulerFlow(N, dtype).random_initial(lmax=10, seed=42)
        W = torch.from_numpy(W0).to(device)
        for method in ERK_SOLVES:
            cases[f"{method}_{tag}_N{N}"] = (erk_run(method, W, steps),
                                            steps, shear_thomas)
        if tag == "c64":
            W64, F0 = W, band_forcing(N, dtype, device, W0)

    def band(P, W):
        return F0

    cases[f"rk4_c64_N{n_large}_scan"] = (
        erk_run("rk4", W64, steps, "scan"), steps, shear_scan)
    cases[f"rk4_c64_N{n_large}_forced"] = (
        erk_run("rk4", W64, steps, forcing=band), steps, shear_thomas)
    return cases


def close_kept_runners():
    """Close every captured runner that integrators/isospectral keeps
    between calls (its graphs and pool released)."""
    while isospectral._LOOPS:
        isospectral._LOOPS.popitem()[1].close()


@contextlib.contextmanager
def erk_captures():
    """The step graphs that integrators/erk captures inside the block, a
    list."""
    made, make = [], erk._StepGraph

    def counted(step, W):
        made.append(make(step, W))
        return made[-1]

    erk._StepGraph = counted
    try:
        yield made
    finally:
        erk._StepGraph = make


def erk_gemms(table, probes):
    """The GEMM kernels of a profile of a phase-25 run, told apart as
    phase 17a tells them (``probes`` of gemm_kernels)."""
    n_full, n_tf32, ms = gemm_counts(table, *probes)
    on_full, on_tf32 = gemm_split(table, *probes)
    return dict(gemms_a_step_full=n_full, gemms_a_step_tf32=n_tf32,
                gemm_ms_a_step=ms, full_gemm_kernels=on_full,
                tf32_gemm_kernels=on_tf32)


def erk_replays(device, cases=None, second_steps=20):
    """Phase 25a, b and d: each run of :func:`erk_cases` through
    :func:`replay_vs_eager` (strict: the replay bit-equal to eager; the
    column solve's launches by counter and by profile; steps/s in turns;
    kernel ms a step and the idle share; the top kernels), with the GEMM
    kernels of each mode's profile (2 a Poisson solve, none on TF32); then
    each run again from no kept graph, twice, at its steps and at
    ``second_steps``: one capture for both calls (none where the capture
    rule keeps runs eager: off a card), the
    second bit-equal to eager, exactly steps x (1, 2, 4) launches of its
    solve and none of the other; and the drift of tr(W^2) and of the
    energy over the run beside ``isomp``'s over the same steps (reported:
    the Runge-Kutta methods do not conserve them)."""
    cases = erk_cases(device) if cases is None else cases
    probes = {shape: gemm_kernels(device, (shape[0],) * 2, shape[1])
              for shape in {erk_shape(name) for name in cases}}
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("cuBLAS's TF32 flag is on before phase 25")
    rows = replay_vs_eager(
        device, cases, strict=True, top=6,
        describe=lambda name, table: erk_gemms(table,
                                               probes[erk_shape(name)]))
    isomp_drift = {}
    for name, (make, steps, kernel) in cases.items():
        row = rows[name]
        method = name.split("_")[0]
        solves = ERK_SOLVES[method]
        for mode in ("eager", "replay"):
            got = (round(row[mode]["gemms_a_step_full"], 6),
                   round(row[mode]["gemms_a_step_tf32"], 6))
            if got != (2 * solves, 0):
                raise AssertionError(
                    f"{name} {mode}: GEMMs a step {got} (full, TF32), "
                    f"expected ({2 * solves}, 0); kernels "
                    f"{row[mode]['top_kernels']}")
        if row["launches_a_call"]["replay"] != steps * solves:
            raise AssertionError(f"{name}: launches {row['launches_a_call']}"
                                 f", expected {steps * solves}")
        close_kept_runners()
        with erk_captures() as made:
            reset_counts()
            W = make(False)[1]()[0]
            counts = read_counts()
            reset_counts()
            W2 = make(False, steps=second_steps)[1]()[0]
            counts2 = read_counts()
        other = "shear_scan" if kernel is shear_thomas else "shear_thomas"
        for n, c in ((steps, counts), (second_steps, counts2)):
            if c != {kernel.__name__: n * solves, other: 0}:
                raise AssertionError(f"{name}: {n} steps launched {c}, "
                                     f"expected {n * solves} of "
                                     f"{kernel.__name__} only")
        if len(made) != int(capture.available(device)):
            raise AssertionError(f"{name}: {len(made)} captures in two "
                                 "calls")
        W2_eager = make(True, steps=second_steps)[1]()[0]
        if not torch.equal(W2, W2_eager):
            raise AssertionError(f"{name}: {second_steps} steps replayed "
                                 "differ from eager")
        N, dtype = erk_shape(name)
        S0 = make.S0
        if (N, dtype) not in isomp_drift:
            isomp_drift[N, dtype] = erk_drift(
                S0, isomp(S0, 0.25 * hbar(N), steps))
        row.update(captures_in_two_calls=len(made),
                   second_call=dict(steps=second_steps, bit_equal=True,
                                    launches=counts2[kernel.__name__]),
                   drift=erk_drift(S0, W), isomp_drift=isomp_drift[N, dtype])
    return rows


def erk_drift(W0, W):
    """Relative drift of tr(W^2) and of the energy from W0 to W."""
    c0, c = casimirs(W0)[0], casimirs(W)[0]
    e0, e = float(energy_euler(W0)), float(energy_euler(W))
    return dict(tr_W2=float(abs(c - c0) / abs(c0)),
                energy=abs(e - e0) / abs(e0))


def erk_vs_plain(device, N=1024, steps=10):
    """Phase 25c: ``rk4`` complex64 at N=``N``, ``steps`` steps replayed
    through ``shear_thomas`` and, under QUFLOW_PALLAS_KERNEL=scan,
    ``shear_scan``, each against the same steps inside ``config.eager()``
    through the kernel's plain version (a captured plain solve is
    thousands of graph nodes); relative to the largest entry, <= 1e-5."""
    W = torch.from_numpy(EulerFlow(N, np.complex64).random_initial(
        lmax=10, seed=42)).to(device)
    dt = 0.25 * hbar(N)
    rows = {}
    for kernel, plain, variable in (
            (shear_thomas, shear_thomas_reference, "thomas"),
            (shear_scan, shear_scan_reference, "scan")):
        with kernel_variable(variable):
            Wk = erk.rk4(W, dt, steps)
        with config.eager():
            Wp = erk.rk4(W, dt, steps, hamiltonian=functools.partial(
                solve_poisson, skewh=True, solver=plain))
        rel = ratio(Wk, Wp)
        if not rel <= 1e-5:
            raise AssertionError(f"rk4 {kernel.__name__}: {steps} steps "
                                 f"kernel vs plain {rel:.3e} > 1e-5")
        rows[kernel.__name__] = dict(N=N, steps=steps, kernel_vs_plain=rel)
    return rows


def host_norm_forcing(P, W):
    """A forcing that a capture cannot hold: it reads W's norm on the
    host."""
    return 1e-3 * float(W.abs().max()) * W


def erk_hook_raises(device, N=512, steps=2):
    """Phase 25d's second check: on a card ``rk4`` with a forcing that
    returns numpy raises TypeError, and with one that reads the host
    raises parallel.capture.HookError, each at its first call naming
    itself and ``config.eager()``, inside which both run.  Off a card
    nothing is captured and both run."""
    W = torch.from_numpy(EulerFlow(N, np.complex128).random_initial(
        lmax=10, seed=42)).to(device)
    dt = 0.25 * hbar(N)
    rows = {}
    for forcing, error in ((numpy_forcing, TypeError),
                           (host_norm_forcing, capture.HookError)):
        message = None
        if on_card(device):
            try:
                erk.rk4(W, dt, steps, forcing=forcing)
            except error as e:
                message = str(e)
            if (message is None or "config.eager()" not in message
                    or forcing.__name__ not in message):
                raise AssertionError(
                    f"{forcing.__name__}: rk4's first call raised "
                    f"{message!r}, not {error.__name__} naming the hook and "
                    "config.eager()")
        with config.eager():
            out = erk.rk4(W, dt, steps, forcing=forcing)
        if not finite(out):
            raise AssertionError(f"{forcing.__name__}: non-finite eager run")
        rows[forcing.__name__] = dict(
            error=error.__name__ if on_card(device) else None,
            message=None if message is None else message[:160],
            eager_ran=True)
    return rows


def erk_solve(device, N=512, steps=100, steps_out=20):
    """Phase 25e: ``solve(W0, dt, steps, steps_out, integrator=rk4)`` on a
    numpy complex128 state at N=``N`` (the card by default), from no kept
    graph: one capture across its steps / steps_out chunks, 4 launches a
    step, the state equal to the same solve inside ``config.eager()``;
    steps/s of both."""
    W0 = EulerFlow(N, np.complex128).random_initial(lmax=10, seed=42)
    dt = 0.25 * hbar(N)
    out, sec = {}, {}
    close_kept_runners()
    for mode in ("replay", "eager"):
        with erk_captures() as made, \
                config.eager() if mode == "eager" else \
                contextlib.nullcontext():
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[mode] = solve(W0.copy(), dt, steps=steps, steps_out=steps_out,
                              integrator=erk.rk4, progress_bar=False)
            torch.cuda.synchronize()
            sec[mode] = time.perf_counter() - t0
            counts = read_counts()
        if counts != {"shear_thomas": 4 * steps, "shear_scan": 0}:
            raise AssertionError(f"solve rk4 {mode}: launches {counts}")
        if len(made) != int(mode == "replay" and capture.available(device)):
            raise AssertionError(f"solve rk4 {mode}: {len(made)} captures "
                                 f"in {steps // steps_out} chunks")
        if mode == "replay":
            captures, launches = len(made), counts
    if not np.array_equal(out["replay"], out["eager"]):
        raise AssertionError("solve rk4: the replayed chunks differ from "
                             "eager by "
                             f"{np.abs(out['replay'] - out['eager']).max()}")
    if out["replay"].shape != (N, N) or not np.isfinite(out["replay"]).all():
        raise AssertionError("solve rk4: bad state")
    return dict(N=N, steps=steps, steps_out=steps_out,
                chunks=steps // steps_out, captures=captures,
                launches=launches, bit_equal=True,
                steps_per_s={m: steps / s for m, s in sec.items()})


def layout_paths(key, ls, lm, pl, lr, ltp):
    """Phase 23's launches of the counter ``key`` on each path that made
    some: the layouts of 23c and 23d, the planes stepper (23e), the replays
    (23f) and the tp ranks (23g)."""
    paths = {}
    for prefix, runs in (("euler", ls), ("mhd", lm)):
        for run, row in runs.items():
            for label, r in row.get("layouts", {}).items():
                paths[f"{prefix}_{run}_{label}"] = r["launches"][key]
            if "launches" in row:  # the N=4096 redirect
                paths[f"{prefix}_{run}"] = row["launches"][key]
    for run, row in pl.items():
        for label in ("pure", "warm"):
            if label in row:
                paths[f"planes_{run}_{label}"] = row[label]["launches"][key]
    for name, row in lr.items():
        if row["kernel"] == key:
            paths[f"replay_{name}"] = row["launches_a_call"]["replay"]
    for tag, row in ltp.items():
        if isinstance(row, dict) and "launches_by_rank" in row:
            for r, n in enumerate(row["launches_by_rank"]):
                paths[f"tp_{tag}_rank{r}"] = n[key]
    return {k: v for k, v in paths.items() if v}


def layout_timing(lt, key):
    """The kernel line's times of ``key`` from phase 23b: its first row
    (``row_thomas`` at R = N, a real lane on planes), every row beside."""
    rows = [r for r in lt if r["kernel"] == key]
    return {**{k: rows[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "share")},
            "by_shape": [{k: r[k] for k in ("dtype", "R", "N", "view", "L",
                                            "B", "ms", "bound_ms", "share")
                          if k in r}
                         for r in rows]}


def split_kernels(dp, split):
    """The kernels line's rows of the split pass's two entries: launches
    on phase 16b's adaptive runs on the mesh (the first, Euler B=16, as
    ``launches``), times at its first shape (Euler B=16) for the key mode,
    and the rule's."""
    runs = dp["adaptive"]
    key_rows = [r for r in split if r["entry"] == "loop_pass_key"]
    rule = next(r for r in split if r["entry"] == "loop_decide")
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "share",
              "library_ms")
    return [{
        "name": "loop_pass_key",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/graph_loop.cu",
        "replaces": "quflow_tpu/parallel/stepper.py:794 (the residual of "
                    "lax.while_loop's body, its jnp.max over the sharded "
                    "batch under a dp mesh; not Pallas)",
        "launches": next(iter(runs.values()))["counts"]["loop_pass_key"],
        "launches_by_path": {f"nccl_dp_{k}": r["counts"]["loop_pass_key"]
                             for k, r in runs.items()},
        "max_abs_err": max(r["max_abs_err"] for r in key_rows),
        "max_rel_err_rn": max(r["max_rel_err_rn"] for r in key_rows),
        **{k: key_rows[0][k] for k in fields},
        "by_shape": [{k: r[k] for k in ("name",) + fields}
                     for r in key_rows],
    }, {
        "name": "loop_decide",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/graph_loop.cu",
        "replaces": "quflow_tpu/parallel/stepper.py:782-785 (the cond of "
                    "lax.while_loop on the residual's max over the mesh; "
                    "not Pallas)",
        "launches": next(iter(runs.values()))["counts"]["loop_decide"],
        "launches_by_path": {f"nccl_dp_{k}": r["counts"]["loop_decide"]
                             for k, r in runs.items()},
        "max_abs_err": rule["max_abs_err"],
        **{k: rule[k] for k in fields},
    }]


# --- phase 26: the 'highest' complex64 product -----------------------------

#: phase 26's checks: (name, A's shape, B's shape)
CGEMM_CHECKS = (("N1024", (1024, 1024), (1024, 1024)),
                ("N513", (513, 513), (513, 513)),
                ("N100", (100, 100), (100, 100)),
                ("batched", (4, 256, 256), (4, 256, 256)),
                ("ens16", (16, 1024, 1024), (16, 1024, 1024)),
                ("broadcast_stride0", (1024, 1024), (2, 1024, 1024)),
                ("broadcast_size1", (3, 1, 100, 100), (1, 2, 100, 100)),
                ("rows_tp2", (512, 1024), (1024, 1024)),
                ("ragged", (37, 100), (100, 513)))
#: phase 26's timed products: those of the benchmark's cells
CGEMM_TIMES = (("single", (1024, 1024), (1024, 1024)),
               ("mhd_broadcast", (1024, 1024), (2, 1024, 1024)),
               ("ens16", (16, 1024, 1024), (16, 1024, 1024)))
TF32_OPS_PER_S = 495e12


def seeded_c64(shape, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, dtype=torch.complex64, device=device,
                       generator=g)


def product_errors(C, A, B):
    """(normwise, elementwise) error of ``C`` against the float64 product
    of ``A`` and ``B``: ||C - C64||_F / ||C64||_F and max |C - C64| /
    (|A| |B|) (where |A| |B| is 0, C must be exact)."""
    A64, B64 = A.to(torch.complex128), B.to(torch.complex128)
    ref = A64 @ B64
    diff = (C.to(torch.complex128) - ref).abs()
    scale = A64.abs() @ B64.abs()
    if bool((diff[scale == 0] != 0).any()):
        return math.inf, math.inf
    return ((diff.norm() / ref.abs().norm()).item(),
            (diff / scale.clamp_min(1e-300)).max().item())


def cgemm_vs_plain(device, shapes=CGEMM_CHECKS):
    """Phase 26: the kernel against its plain version, its error and
    cuBLAS's against float64, at ``shapes`` and at MHD's strided Theta
    (S[:, 1] of a (4, 2, N, N) state) and broadcast P; ``max_abs_err``
    over max |A||B|, at most 2^-20."""
    cases = [(name, seeded_c64(sa, device, 1), seeded_c64(sb, device, 2))
             for name, sa, sb in shapes]
    S = seeded_c64((4, 2, 256, 256), device, 3)
    P = seeded_c64((4, 256, 256), device, 4)
    cases += [("mhd_theta_strided", P, S[:, 1]),
              ("mhd_P_broadcast", P[:, None], S)]
    rows = []
    for name, A, B in cases:
        C = cgemm.cgemm(A, B)
        scale = (A.abs() @ B.abs()).max().item()
        err = (C - cgemm.cgemm_reference(A, B)).abs().max().item() / scale
        if not err <= 2.0 ** -20:
            raise AssertionError(f"cgemm {name}: {err:.3e} of max |A||B| "
                                 "from its plain version")
        rows.append(dict(name=name, a=list(A.shape), b=list(B.shape),
                         max_abs_err=err, errors=product_errors(C, A, B),
                         library_errors=product_errors(A @ B, A, B)))
    return rows


def cgemm_times(device, shapes=CGEMM_TIMES, reps=20):
    """Phase 26: the product's ms at ``shapes`` by CUDA-graph replay, in
    turns with the library's float32 CGEMM (library, kernel, kernel,
    library), its two kernels' ms from a profile (kernel_table), its bound
    (24 M N K on the tensor cores' TF32 peak) and share, the plain
    version's ms and the library's one-pass TF32 product's."""
    rows = []
    for name, sa, sb in shapes:
        A, B = seeded_c64(sa, device, 5), seeded_c64(sb, device, 6)
        batch = math.prod(torch.broadcast_shapes(sa[:-2], sb[:-2]))
        M, K, N = sa[-2], sa[-1], sb[-1]
        bound = 24.0 * M * N * K * batch / TF32_OPS_PER_S * 1e3
        turns = [graph_ms(fn, reps) for fn in (
            lambda: A @ B, lambda: cgemm.cgemm(A, B),
            lambda: cgemm.cgemm(A, B), lambda: A @ B)]
        ms = float(np.mean(turns[1:3]))

        def tf32():
            with config.tf32_matmul():
                return A @ B
        table = kernel_table(lambda: [cgemm.cgemm(A, B) for _ in range(10)],
                             10)[0]
        rows.append(dict(
            name=name, a=list(sa), b=list(sb), ms=ms, bound_ms=bound,
            bound_by="operations", share=bound / ms,
            kernels_ms={k[:90]: kms for k, (_, kms) in table.items()},
            plain_ms=cuda_ms(lambda: cgemm.cgemm_reference(A, B), 3),
            library_ms=float(np.mean([turns[0], turns[3]])),
            library_tf32_ms=graph_ms(tf32, reps),
            turns_library_kernel_kernel_library_ms=turns))
    return rows


def main():
    if sys.argv[1:2] == ["--tp-rank"]:  # a rank of phase 19b
        rank, backend, tmp, N, steps, maxit, device, dtype = sys.argv[2:10]
        tp_rank(int(rank), backend, tmp, int(N), int(steps), int(maxit),
                device, dtype)
        return
    if sys.argv[1:2] == ["--layout-rank"]:  # a rank of phase 23g
        rank, tmp, cases, steps, maxit, device = sys.argv[2:8]
        layout_rank(int(rank), tmp, cases, int(steps), int(maxit), device)
        return
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false; "
                 "this script needs a CUDA device")
    device = torch.device("cuda", 0)
    # phases 3-5, 10, 12, 13 and 14a, c, d, f hold shear_thomas, the
    # default column solve; phases 7, 11, 14b and 14e set the variable for
    # themselves
    os.environ.pop("QUFLOW_PALLAS_KERNEL", None)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)

    t0 = time.perf_counter()
    libs = cuda_build.build_all([cuda_solve.LIBRARY, cuda_scan_solve.LIBRARY,
                                 cuda_block_solve.LIBRARY,
                                 cuda_row_solve.LIBRARY,
                                 cuda_graph_loop.LIBRARY,
                                 cgemm.LIBRARY])
    report = " ;; ".join(
        f"{lib.name}: {ptxas_summary(lib.with_suffix('.log').read_text())}"
        for lib in libs)
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s, "
          f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"ptxas: {report}", flush=True)

    rows = kernel_vs_plain(device)
    print("phase 3 kernel vs plain: " + json.dumps(rows), flush=True)

    c64 = main_path_c64(device)
    print("phase 4 main path c64: " + json.dumps(c64), flush=True)

    c128 = main_path_c128(device)
    print("phase 5 main path c128: " + json.dumps(c128), flush=True)

    scan_rows = kernel_vs_plain(device, kernel=shear_scan,
                                plain=shear_scan_reference,
                                against=shear_thomas)
    print("phase 6 scan kernel vs plain: " + json.dumps(scan_rows), flush=True)
    ragged = ragged_bit_equal(device, shear_scan, shear_scan_reference)
    print("phase 6 scan kernel vs plain, ragged: " + json.dumps(ragged),
          flush=True)

    m64 = mhd_c64(device)
    print("phase 7 MHD c64: " + json.dumps(m64), flush=True)

    m128 = mhd_c128(device)
    print("phase 8 MHD c128: " + json.dumps(m128), flush=True)

    big = mhd_large(device)
    print("phase 9 MHD c64 N=4096: " + json.dumps(big), flush=True)

    gate = {}
    ref = reference_euler(device, gate_out=gate)
    print("phase 10 reference Euler c128 N=1024: " + json.dumps(ref),
          flush=True)

    qg = reference_qg(device)
    print("phase 11 reference QG c64 N=1024, scan: " + json.dumps(qg),
          flush=True)

    fam = poisson_family(device)
    print("phase 12 Poisson family N=1024: " + json.dumps(fam), flush=True)

    rmhd = reference_mhd(device)
    print("phase 13 reference MHD c128 N=512: " + json.dumps(rmhd),
          flush=True)

    hq = hooked_qg(device)
    hq["phase_4_stepper_steps_per_s"] = c64["stepper_steps_per_s"]
    print("phase 14a hooked QG c64 N=1024: " + json.dumps(hq), flush=True)
    with kernel_variable("scan"):
        hq_scan = hooked_qg(device, shear_scan, shear_scan_reference,
                            steps=20, steps_out=20)
    print("phase 14b hooked QG c64 N=1024, scan: " + json.dumps(hq_scan),
          flush=True)
    hvr = hooked_vs_reference(device)
    print("phase 14c hooked QG c128 N=512 vs isomp: " + json.dumps(hvr),
          flush=True)
    ad = adaptive_euler(device, gate)
    print("phase 14d adaptive tol Euler c128 N=1024: " + json.dumps(ad),
          flush=True)
    hm = hooked_mhd(device)
    print("phase 14e hooked MHD c64 N=1024, scan: " + json.dumps(hm),
          flush=True)
    card = solve_on_card(device)
    card["phase_4_solve_steps_per_s"] = c64["solve_steps_per_s"]
    print("phase 14f solve of a card tensor c64 N=1024: " + json.dumps(card),
          flush=True)

    ensemble = {}
    ens = ensemble_euler(device, out=ensemble)
    print("phase 15a-b ensembles Euler c64 N=1024: " + json.dumps(ens),
          flush=True)
    ens128 = ensemble_c128(device)
    print("phase 15c ensemble Euler c128 N=512: " + json.dumps(ens128),
          flush=True)
    ens_mhd = ensemble_mhd(device)
    print("phase 15d ensemble MHD c64 N=1024, scan: " + json.dumps(ens_mhd),
          flush=True)
    # the kernels at the ensemble sizes of these paths that phases 3 and 6
    # do not time: shear_thomas at B=16, shear_scan at B=2 (phase 14e's
    # Strang launch)
    ens_rows = kernel_vs_plain(device, Ns=(1024,), Bs=(16,))
    scan_b2 = kernel_vs_plain(device, Ns=(1024,), Bs=(2,), kernel=shear_scan,
                              plain=shear_scan_reference)
    print("phase 15e kernels at B=16 (thomas) and B=2 (scan): "
          + json.dumps(ens_rows + scan_b2), flush=True)

    ckpt = checkpoint_restart(device)
    print("phase 16a checkpoint restart c64 N=1024: " + json.dumps(ckpt),
          flush=True)

    we = warm_euler(device)
    print("phase 17a warm schedule Euler c64 N=1024: " + json.dumps(we),
          flush=True)
    wens = warm_ensemble(device)
    print("phase 17b warm ensemble Euler c64 N=1024 B=16: "
          + json.dumps(wens), flush=True)
    wm = warm_mhd(device, m64)
    print("phase 17c warm MHD c64 N=1024, scan: " + json.dumps(wm),
          flush=True)
    kara = karatsuba_euler(device)
    print("phase 17d highest_karatsuba Euler c64 N=1024: " + json.dumps(kara),
          flush=True)
    aw = adaptive_warm(device)
    print("phase 17e adaptive tol with a warm prefix c64 N=1024: "
          + json.dumps(aw), flush=True)

    maps = device_maps(device)
    print("phase 18a device quantization maps c128 N=1024: "
          + json.dumps(maps), flush=True)
    sht = device_sht(device)
    print("phase 18b device SHT L=256: " + json.dumps(sht), flush=True)
    nat = native_poisson(device)
    print("phase 18c native host Poisson vs solve_poisson c128 N=512: "
          + json.dumps(nat), flush=True)

    blocks, block_times = block_sweeps(device)
    print("phase 19a block sweeps vs plain and vs shear_thomas: "
          + json.dumps(dict(rows=blocks, timed=block_times)), flush=True)
    tp = tp_mhd(device)
    check_tp_ran(tp)
    print("phase 19b tp = 2 MHD N=1024: " + json.dumps(tp), flush=True)

    dw = dw_steppers(device)
    dw["phase_5_solve_steps_per_s"] = c128["solve_steps_per_s"]
    print("phase 20 double-word steppers c128 N=512: " + json.dumps(dw),
          flush=True)

    replays = replay_vs_eager(device)
    print("phase 21 CUDA-graph replay vs eager: " + json.dumps(replays),
          flush=True)

    hooked = replay_vs_eager(device, hooked_cases(device), strict=True,
                             top=6)
    print("phase 22a-f hooked runs, replay vs eager: " + json.dumps(hooked),
          flush=True)
    hooked_plain = hooked_vs_plain(device)
    print("phase 22a-c hooked kernels vs plain: " + json.dumps(hooked_plain),
          flush=True)
    hooked_isomp = hooked_stepper_vs_isomp(device)
    print("phase 22e hooked stepper vs isomp c128 N=512: "
          + json.dumps(hooked_isomp), flush=True)
    raises = hook_raises(device)
    print("phase 22g hooks a capture cannot hold: " + json.dumps(raises),
          flush=True)

    lk = layout_kernels(device)
    print("phase 23a row_thomas and real lanes vs plain: " + json.dumps(lk),
          flush=True)
    lt = layout_kernel_times(device)
    print("phase 23b row_thomas and real lanes, times: " + json.dumps(lt),
          flush=True)
    ls = layout_steppers(device)
    print("phase 23c Euler in each layout: " + json.dumps(ls), flush=True)
    lm = layout_mhd(device)
    print("phase 23d MHD on 'rolls' and 'pallas': " + json.dumps(lm),
          flush=True)
    pl = planes_stepper(device)
    print("phase 23e build_planes_step_fn: " + json.dumps(pl), flush=True)
    lr = replay_vs_eager(device, layout_capture_cases(device), strict=True)
    print("phase 23f layout runs, replay vs eager: " + json.dumps(lr),
          flush=True)
    ltp = layouts_tp(device)
    print("phase 23g 'shard' and 'scatter' at tp = 2: " + json.dumps(ltp),
          flush=True)

    ld = loop_pass_vs_plain(device)
    print("phase 24a loop_pass vs plain: " + json.dumps(ld), flush=True)
    dl = device_loop(device, pass_times={r["name"]: r["ms"]
                                         for r in ld["times"]})
    print("phase 24b device loop vs host loop: " + json.dumps(dl),
          flush=True)

    er = erk_replays(device)
    print("phase 25a, b, d Runge-Kutta replay vs eager: " + json.dumps(er),
          flush=True)
    ep = erk_vs_plain(device)
    print("phase 25c Runge-Kutta kernels vs plain: " + json.dumps(ep),
          flush=True)
    eraises = erk_hook_raises(device)
    print("phase 25d Runge-Kutta hooks a capture cannot hold: "
          + json.dumps(eraises), flush=True)
    es = erk_solve(device)
    print("phase 25e solve with rk4 c128 N=512: " + json.dumps(es),
          flush=True)

    cg_rows = cgemm_vs_plain(device)
    cg_times = cgemm_times(device)
    print("phase 26 the 'highest' complex64 product: " + json.dumps(
        dict(vs_plain=cg_rows, times=cg_times)), flush=True)

    # phase 16b last: see the phase list
    dp = nccl_dp(device, ensemble)
    print("phase 16b one-rank NCCL dp ensemble and adaptive runs: "
          + json.dumps(dp), flush=True)
    split = split_pass_times(device)
    print("phase 16b the split pass's entries vs plain: "
          + json.dumps(split), flush=True)

    def replayed(kernel):
        """Phase 21's, 22's, 24's and 25's replayed paths of ``kernel``:
        launches of a call."""
        paths = {f"{prefix}_{name}": row["launches_a_call"]["replay"]
                 for prefix, rows in (("replay", replays),
                                      ("hooked_replay", hooked),
                                      ("erk", er))
                 for name, row in rows.items() if row["kernel"] == kernel}
        paths.update({f"device_loop_{name}": row["launches_a_call"]["loop"][
            "solve"] for name, row in dl.items() if row["kernel"] == kernel})
        return paths

    def main_row(rows):
        return next(r for r in rows if r["dtype"] == "complex64"
                    and r["N"] == 1024 and r["B"] == 1)

    def timing(rows):
        row = main_row(rows)
        return {k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    print(json.dumps({"kernels": [{
        "name": "shear_thomas",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/shear_thomas.cu",
        "replaces": "quflow_tpu/ops/pallas_solve.py:168",
        "launches": c64["launches"],
        "launches_by_path": {
            "euler_c64_N1024": c64["launches"],
            "euler_c128_N512": c128["launches"]["shear_thomas"],
            "reference_euler_c128_N1024": ref["launches"],
            "reference_euler_c128_N1024_gate": ref["gate_launches"],
            "poisson_family_N1024": fam["launches"],
            "reference_mhd_c128_N512": rmhd["launches"],
            "hooked_qg_c64_N1024": hq["launches"]["shear_thomas"],
            "hooked_qg_c128_N512": hvr["stepper_launches"],
            "adaptive_euler_c128_N1024": ad["launches"],
            "solve_card_tensor_c64_N1024": card["launches"]["shear_thomas"],
            **{f"ensemble_euler_c64_N1024_B{r['B']}": r["launches"]
               for r in ens["by_B"]},
            "ensemble_euler_c128_N512_B8":
                ens128["launches"]["shear_thomas"],
            "checkpoint_restart_c64_N1024": ckpt["launches"]["shear_thomas"],
            "nccl_dp_euler_c64_N1024_B16": dp["launches"]["shear_thomas"],
            "warm_euler_c64_N1024": we["warm"]["launches"],
            "warm_off_euler_c64_N1024": we["full"]["launches"],
            "warm_ensemble_euler_c64_N1024_B16": wens["launches"]["warm"],
            "karatsuba_euler_c64_N1024":
                kara["highest_karatsuba"]["launches"],
            "adaptive_warm_euler_c64_N1024": aw["warm"]["launches"],
            "native_vs_solve_poisson_c128_N512":
                nat["launches"]["shear_thomas"],
            "erk_solve_rk4_c128_N512": es["launches"]["shear_thomas"],
            **replayed("shear_thomas")},
        "max_abs_err": max(r["max_abs_err"] for r in rows + ens_rows),
        **timing(rows),
        "library_ms": None,
    }, {
        "name": "shear_scan",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/shear_scan.cu",
        "replaces": "quflow_tpu/ops/pallas_scan_solve.py:114",
        "launches": m64["integrator_launches"]["shear_scan"],
        "launches_by_path": {
            "mhd_c64_N1024": m64["integrator_launches"]["shear_scan"],
            "mhd_c64_N1024_logs": m64["log_launches"]["shear_scan"],
            "mhd_c128_N512": m128["launches"]["shear_scan"],
            "mhd_c64_N4096": big["launches"]["shear_scan"],
            "reference_qg_c64_N1024": qg["launches"]["shear_scan"],
            "hooked_qg_c64_N1024": hq_scan["launches"]["shear_scan"],
            "hooked_mhd_c64_N1024": hm["launches"]["shear_scan"],
            "ensemble_mhd_c64_N1024_B4": ens_mhd["launches"]["shear_scan"],
            "warm_mhd_c64_N1024": m64["integrator_launches"]["shear_scan"],
            "warm_off_mhd_c64_N1024":
                wm["full"]["integrator_launches"]["shear_scan"],
            **replayed("shear_scan")},
        "max_abs_err": max(r["max_abs_err"]
                           for r in scan_rows + ragged + scan_b2),
        **timing(scan_rows),
        "library_ms": None,
    }, {
        "name": "shear_block",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/shear_block.cu",
        "replaces": "quflow_tpu/parallel/shard_shear.py:124 (XLA "
                    "associative_scan, not Pallas)",
        "launches": tp["complex64"]["launches_by_rank"][0]["shear_block"],
        "launches_by_path": {
            f"tp_mhd_{c}_N1024_rank{r}": n["shear_block"]
            for c in ("complex64", "complex128")
            for r, n in enumerate(tp[c]["launches_by_rank"])},
        "max_abs_err": max(r["max_abs_err"] for r in blocks + block_times),
        # one rank's three launches at phase 19b's shape (N=1024, tp=2)
        **{k: block_times[0][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by", "share",
                     "phase_ms")},
        "library_ms": None,
    }, {
        "name": "row_thomas",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/row_thomas.cu",
        "replaces": "quflow_tpu/ops/pallas_solve.py:68",
        "launches": ls["complex64_N1024"]["layouts"]["pallas"]["launches"][
            "row_thomas"],
        "launches_by_path": layout_paths("row_thomas", ls, lm, pl, lr, ltp),
        "max_abs_err": max(r["max_abs_err"] for r in lk
                           if r["kernel"] == "row_thomas"),
        **layout_timing(lt, "row_thomas"),
        "library_ms": None,
    }, {
        "name": "shear_thomas_real",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/shear_thomas.cu",
        "replaces": "quflow_tpu/ops/pallas_solve.py:219 (a real rhs)",
        "launches": ls["complex64_N1024"]["layouts"]["shear_pallas_il"][
            "launches"]["shear_thomas_real"],
        "launches_by_path": layout_paths("shear_thomas_real", ls, lm, pl, lr,
                                         ltp),
        "max_abs_err": max(r["max_abs_err"] for r in lk
                           if r["kernel"] == "shear_thomas_real"),
        **layout_timing(lt, "shear_thomas_real"),
        "library_ms": None,
    }, {
        "name": "shear_scan_real",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/shear_scan.cu",
        "replaces": "quflow_tpu/ops/pallas_scan_solve.py:162 (a real rhs)",
        "launches": ls["complex64_N1024"]["layouts"]["shear_pallas_il_scan"][
            "launches"]["shear_scan_real"],
        "launches_by_path": layout_paths("shear_scan_real", ls, lm, pl, lr,
                                         ltp),
        "max_abs_err": max(r["max_abs_err"] for r in lk
                           if r["kernel"] == "shear_scan_real"),
        **layout_timing(lt, "shear_scan_real"),
        "library_ms": None,
    }, {
        "name": "loop_pass",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/graph_loop.cu",
        "replaces": "quflow_tpu/integrators/isospectral.py:168-175 (the "
                    "residual and the cond of XLA's lax.while_loop, not "
                    "Pallas; also mhd.py:87, parallel/stepper.py:782-796, "
                    "806, 1435, 1922, 2232)",
        "launches": dl["quickstart_isomp_c128_N256"]["launches_a_call"][
            "loop"]["loop_pass"],
        "launches_by_path": {
            f"{prefix}_{name}": row["launches_a_call"][mode]["loop_pass"]
            for prefix, mode in (("device_loop", "loop"),
                                 ("host_loop", "eager"))
            for name, row in dl.items()},
        **{k: ld[k] for k in ("max_abs_err", "max_rel_err_rn", "ms",
                              "plain_ms", "bound_ms", "bound_by", "share",
                              "library_ms", "replaced_ms",
                              "while_pass_ms")},
        "by_shape": [{k: r[k] for k in ("name", "ms", "bound_ms", "share",
                                        "replaced_ms", "library_ms")}
                     for r in ld["times"]],
    }, *split_kernels(dp, split), {
        "name": "cgemm_tf32x3",
        "route": "cuda",
        "source": "quflow_tpu_torch/csrc/cgemm_tf32x3.cu",
        "replaces": "none: XLA's multi-pass 'highest' dot (quflow_tpu/"
                    "parallel/stepper.py:578-581, not Pallas)",
        "launches": c64["gemm_launches"],
        "launches_by_path": {
            "euler_c64_N1024": c64["gemm_launches"],
            "mhd_c64_N1024": m64["integrator_gemm_launches"],
            "warm_off_mhd_c64_N1024": wm["full"]["integrator_gemm_launches"],
            "hooked_qg_c64_N1024": hq["gemm_launches"],
            "hooked_qg_c64_N1024_scan": hq_scan["gemm_launches"],
            **{f"ensemble_euler_c64_N1024_B{r['B']}": r["gemm_launches"]
               for r in ens["by_B"]},
            "ensemble_mhd_c64_N1024_B4": ens_mhd["gemm_launches"],
            "nccl_dp_euler_c64_N1024_B16": dp["launches"]["cgemm"],
            **{f"nccl_dp_adaptive_{k}": r["counts"]["cgemm"]
               for k, r in dp["adaptive"].items()}},
        "max_abs_err": max(r["max_abs_err"] for r in cg_rows),
        **{k: cg_times[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "share", "library_ms")},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
