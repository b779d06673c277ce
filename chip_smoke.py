#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits nonzero:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; no CUDA device -> exit 2 before anything else;
2. build the thirteen CUDA kernels from ``ltr_lowrank_sdp_torch/csrc``
   (nvcc, sm_90a, all sources at once) and an empty kernel
   (``launch_floor.cu``), whose time through the same ctypes path and
   ``time_ms`` is the launch floor (``[launch-floor]``; every row of the
   ``kernels`` line carries it as ``launch_floor_ms``);
3. hold each kernel against its plain PyTorch version on the card, in
   float64, at the main paths' shapes: max relative error <= 1e-12, with the
   kernel's time, the plain version's time, the memory bound (bytes / 3.35
   TB/s) and, for the two SpMMs and the two LP segment sums, a yardstick
   built on one ``torch.sparse.mm`` call that computes the same function
   and that the port never calls.  K1-K4 on the n = 2^14 Delaunay MaxCut C at
   rank 20 and 64; on the n = 10^4 matrix-completion cone at rank 19 and 64,
   K1 (C = I scaled by the objective coefficient, no diagonal term, also at
   r = 1 and chained into K6 as ``apply_w`` does), K4 (U, V and ``U is V``
   on the 10^4 diagonal entries), K5 (single, ``U is V``, pair) and K6
   (alone, with an addend, r = 1, weights with zeros); K5 and K6 once more
   on a random sparse cone with several entries per constraint and a
   trace-like constraint of n entries; K5, K6 and the dense-objective
   ``apply_w`` chain (``torch.matmul`` then K6 accumulating onto it) on the
   Lovasz theta cone ``theta_sdpa(600, 60, seed=12)`` (the shape of
   Mittelmann theta12) at rank 13, 64, 102 and 1, and on the cone that phase 7
   solves, ``theta_sdpa(THETA_N, THETA_N // 4, seed=THETA_N)``, at the rank
   that solve runs at (its rank cap, 141, where a cone with m >= 20 n and
   n <= 400 starts) and 1 (the theta path's row of the ``kernels`` line); K5 on those cones' trace segments and on the
   4096-entry one, with and without the long-segment split, in all three
   modes; K5, K6 and the ``apply_w`` chain on each of the three blocks of
   the multi-block + LP main path (n = 1000, 800, 600) at the block's
   starting rank, which is the rank that solve ends at, and at 1, with the
   dense C @ Y product timed beside them; K7 and K8 at that path's LP
   shapes (60,000 entries, 20,000 columns, m = 2,400) and at ten times
   that, K7 in both modes bitwise K7's order in plain PyTorch
   (``[k7-plan]``, also in float32), K8 in every block size bitwise its
   plain version evaluated on the host, in both value types, with an
   infinity and a NaN in w, also on a cone with 500- and 40-entry columns
   (``[k8-plan]``).  K1 on the MaxCut, matrix-completion and phase 14's
   batched CSRs at r = 1, 19, 20, 33 and 64 in both value types: every
   plan of ``k1_plans`` in its three modes (C Y, C Y with the row scale
   diag_val * w folded in, the row scale alone) bitwise the planned
   launch, the folded row scale bitwise the launch given d = diag_val * w,
   the planned launch within the unit roundoff of the plain version, every
   plan timed (``[k1-plan]``).  K2 at the MaxCut path's n at r = 1, 5, 19,
   20, 33, 64 and 141 in both value types (and on the path's rank-20
   inputs in each type): every plan of ``k2_plans`` and a one-block grid
   bitwise the planned launch in both modes, the planned launch on its
   first 256 rows bitwise K2's sum order evaluated on the host
   (``diag_rowdot_order``), every plan timed (``[k2-plan]``); K3 likewise,
   which keeps K2's lane groups and dot order: every plan of ``k2_plans``
   and a one-block grid bitwise the planned launch, the planned launch on
   its first 256 rows bitwise ``diag_normal_matvec_order`` (the
   one-warp-a-row kernel's arithmetic evaluated on the host), every plan
   timed (``[k3-plan]``).  A final
   rank of phase 6 or 7 that phase 3 did not cover is held
   right after its solve.  Then the float32 kernel phase: K1-K4 on the
   MaxCut C at rank 20, K5 (pair) and K6 on the matrix-completion cone at
   rank 19, K7 (pair) and K8 on the multi-block + LP path's LP cone, each
   on float32 values against its plain version evaluated in float64 on the
   same float32 inputs (max error over the output's largest magnitude <=
   1e-5; K4, which forms its products and sums in float64, within 1e-10 of
   the sum of its terms' magnitudes), the same bits on two calls, the
   kernel's, the float32 plain version's and a float32 library call's
   time (``torch.sparse.mm`` for K1, K6, K7, K8, ``torch.linalg.vecdot``
   for K2) beside the bound at 4-byte values.  Then ``[capture-kernels]``:
   each of K1-K8 at its main path's shapes captured inside the conditional
   bodies of a CUDA graph (a WHILE of two runs, each an IF around the call;
   ``solver.devloop.DeviceGraph``, the solver's replayed loops' machinery)
   and replayed twice: every replay the eager call's bits, and the launches
   accounted from the body runs twice the eager call's.  K5 and K6 on each shard's
   layouts of the matrix-completion cone at world size 2 (row 16: a rank's
   constraint segment and its row slice of the CSR), as above, and their
   outputs there bitwise the whole layouts' (``[shard-bits]``).  Every K5 /
   K6 ``[kernel]`` line names the instantiation launched (lane group G,
   columns per lane CPL, K5's constraints per group KC, K6's warps per row
   W) with its registers and spills (``[ptxas]`` lists every
   instantiation's); wherever K6 is held, every warps-per-row value (1, 2,
   4, 8) must give the planned launch's bits, and wherever K5 is, one and
   two constraints per group; each is timed at the path's shapes
   (``[k6-warps]``, ``[k5-kc]``: the evidence for the host's choice).
   Wherever K4 is held at a path's reported rank (MaxCut, matrix
   completion, float32 MaxCut, HALLaR's layouts, the maximum stable set
   cone), every grid of ``k4_plans`` (1 block, half the planned grid,
   twice the cap), three more calls, a CUDA-graph replay and two graphs
   captured on one stream and replayed at once on two must give the
   planned launch's bits, each grid timed (``[k4-plan]``), and one call
   must be one device kernel: one kernel node in a CUDA graph captured
   from a call, and no other kernel and at most one a call in what the
   profiler records (``[k4-kernels]``).  K13
   (``gather_rowsum``, the port of the repo's one ``pl.pallas_call``) at
   the gather probe's shape (N = 8,192, M = 262,144, R = 32) and at R = 8
   and 64, float32, against its plain version evaluated in float64 (max
   |kernel - plain| / max |plain| <= 1e-5), the same bits on two calls,
   timed beside the float32 plain version (one PyTorch call, also the
   library yardstick), ``torch.bincount`` then ``torch.mv`` (two calls)
   and the bound; every plan (the gather and the two counts plans: the
   histogram in shared memory or by warp-aggregated atomics) there, at an
   M < N shape, with M = 0, at N = 16,384 to 49,152 (where the planned
   histogram turns from shared memory to the atomics) and at two skewed
   index sets (all equal, a Zipf draw) within 1e-5 as above (the gather on
   all-equal indices within its float32 rounding bound,
   ``kernels.k13_gather_bound``, instead), the same bits on two calls, the
   counts plans bitwise ``gather_rowsum_order`` (their order evaluated on
   the host), each timed (``[k13-plan]``), and the device kernels of one
   call of each plan, the kernel nodes of a CUDA graph captured from it
   (``[k13-kernels]``); then the probe twin
   (``ltr_lowrank_sdp_torch.scripts.gather_probe``) through its entry
   point, counters set to 0 just before and read just after: K13 launched,
   no plain version run, ``kernel_ok``;
4. the MaxCut main path: ``ltr_lowrank_sdp_torch.cli.main`` on the Delaunay
   graph (n = 2^14, seed 14; the kind of SuiteSparse ``delaunay_n14``, solved
   with the LoRADS MaxCut row's flags ``--phase1Tol 1e+1 --heuristicFactor
   100``), with every launch counter set to 0 just before and read just
   after: status primal_dual_optimal, DIMACS errors <= 1e-5 (primal
   infeasibility and gap recomputed in float64 on the host), the trajectory
   JSON, K1-K4 launched and no plain version run, and (``[main-counts]``,
   likewise ``[matcomp-counts]`` and ``[multiblock_lp-counts]`` after
   phases 5 and 6) the ALM / ADMM / CG counts, host syncs and final ranks
   equal to ``SOLVE_COUNTS`` (``PERF.md`` section 5), printed with K1's and
   K8's launches, K1's folded row scales, the host reads, the CUDA-graph
   replays and each graph's nodes and instantiation time; every CLI solve
   (these and phase 7b's) must run the replayed ALM and ADMM loops (graph
   replays > 0, no call of the eager inner pass or ADMM loop); then a warm
   solve (a new Solver: its graphs captured anew), a solve again on the
   same Solver (its graphs reused, the same result) and one more with the
   graph replays timed by CUDA events (the graph span share; the graphs
   refuse ``torch.profiler``, and ``[profiler-refused]`` checks that a
   solve under it raises);
5. the sparse-cone main path: matrix completion of a 5000 x 5000 rank-3
   matrix (``matcomp_problem(5000, 5000, 3, 2.0, seed=0)``: n = 10^4, the
   dimension of the LoRADS MC_10000 row, about 552,000 one-entry
   constraints) written as ``.dat-s`` and solved through the CLI with
   ``--heuristicFactor 10``, counters as above: K1, K4, K5, K6 launched, no
   plain version run, status primal_dual_optimal or primal_optimal, primal
   infeasibility <= 1e-5, gap and dual infeasibility <= 5e-5; then a warm
   solve and a window of one under the profiler;
6. the multi-block + LP main path: ``multiblock_lp_sdpa(dims=(1000, 800,
   600), m=2400, n_lp=20000, seed=0)`` (three coupled dense-objective blocks
   and an LP cone) written as ``.dat-s`` with the LP block last and solved
   through the CLI with default flags, counters as above: K5, K6, K7, K8
   launched, nothing else and no plain version run, one final rank per
   block, the same limits as phase 5 (the LP columns enter the host
   recomputation); then a warm solve and a profiler window;
7. the Lovasz theta path: ``theta_sdpa(THETA_N, THETA_N // 4, seed=THETA_N)``
   through the CLI (dense objective, rank 141 from the start): K5 and K6
   launched, nothing else, the same limits, inside ``THETA_LIMIT_S`` (no
   warm solve and no profiler window: the solve is a long one);
   7b. the ``[main-f32]``, ``[matcomp-f32]`` and ``[multiblock_lp-f32]``
   solves: phases 4-6's files through the CLI again with ``--dtype
   float32`` (the JAX package's TPU configuration), counters as above:
   the same status and one final rank per block as the float64 run, pinf
   <= 1e-5 and gap <= 5e-5 recomputed in float64 on the host, pobj within
   5e-5 relative of the float64 run's, every kernel of the path launched
   on float32 values (``kernels.counts_f32``; a float64 polish adds
   float64 launches, and its runs are printed) and no plain version run;
   then a warm solve;
8. small problems on the card: a G11-sized random MaxCut (n = 800), a small
   matrix completion (n = 400), ``random_multiblock_problem()`` with the
   Gauss-Seidel and the Jacobi sweep, the 1/10-scale multi-block + LP
   instance and ``theta_sdpa(80, 20, 80)``, each to an optimal status (the
   Jacobi sweep runs on the card nowhere else).  The MaxCut and the two
   multi-block solves are solved on the CPU too (under a second each) and
   held to its status, ranks and pobj (1e-6 relative), and the two sweeps'
   pobj to each other within their certified gaps; the CPU twins of the
   other three were cut for the script's time (the port's CPU solves of
   these families are held to the JAX package's in ``tests/test_torch_*``);
9. the rank-schedule predictor's kernels on the card, in float32 at the
   serve path's shapes: K9 on the first GATv2 layer's inputs of the dataset
   graphs ``theta_n300_d75`` (N = 9,879, 302,821 edges with the self-loops)
   and ``MC_600x600_r5`` (N = 85,080, 2,564,916), K10 on the last layer's
   output of both, on a batch of eight dataset graphs' sizes with an empty
   graph among them: max |kernel - plain| / max |plain| <= 1e-5 with the
   plain version evaluated in float64 on the same inputs (in float32 it is
   itself up to 7e-5 off over one 85,080-node segment), the same bits on
   two calls, the kernel's, the float32 plain version's and, for K10, two
   ``torch.segment_reduce`` calls' (sum and max, the part of K10 that one
   library call computes) times beside the bound; every launch plan of K9's
   shape (``kernels.k9_plans``: one tile a batch, fewer sub-warps,
   scalar loads) gives the planned launch's bits on two calls, each timed
   (``[k9-plan]``, here, at the training shapes and at every width), and so
   does every plan of K10 (``kernels.k10_plans``: rows loaded ahead,
   float4 or scalar loads; ``[k10-plan]``, here, at the training shapes and
   at every width of the width phase);
10. the serve path: ``ltr_lowrank_sdp_torch.infer.main`` with ``runs/r5_theta``
   on ``theta_n300_d75`` and with ``--batch`` on the seeded test split, the
   counters set to 0 just before and read just after: K9 three launches
   and K10 one per graph, nothing else and no plain version run; the
   schedules equal to the port's CPU run of the same command.  Then
   ``predict`` at full width on ``MC_600x600_r5``, cold and warm: K9 three
   and K10 one launch, the raw schedule within 1e-4 relative of the CPU
   run's and the rounded schedule equal (a raw value within 1e-3 of a
   half-integer may round the other way; it is printed), with the peak
   device memory and the device's busy share under the profiler;
11. predict, then solve: ``ltr_lowrank_sdp_torch.benchmark.main`` on
   ``theta_sdpa(20, 5, 20)`` written as ``hansmittel/theta20_gen.dat-s``
   (no dataset graph has its name, so the processor runs), a default and a
   scheduled solve on the card: both ``primal_dual_optimal`` or
   ``primal_optimal`` within phase 7's error limits and inside the
   benchmark's own solver time limit, the root benchmark's file schema, K9 / K10 once per prediction and K5 / K6 in the solves, no plain
   version run; the speedup is printed;
12. training: at the shapes of ``theta_n300_d75`` and ``MC_600x600_r5``
   (the first GATv2 layer's and the poolings' inputs), K9 with its dropout
   keep-scale and lse output, its backward K11, K10 with its keep-scale,
   softmax stats and tie counts, and its backward K12, each without and
   with keep-scales (p = 0.15) and K12 also on features rounded to a grid
   so that many nodes tie at a column's max: every output against the plain
   version evaluated in float64 on the kernel's inputs (max |kernel - plain|
   / max |plain| <= 1e-5, the backward's scale floored at 1e-6 of its
   largest output), the same bits on two calls, times beside the bound;
   every K12 plan (``kernels.k10_plans``) bitwise the planned launch, each
   timed (``[k12-plan]``, also at the width phase's d), one device kernel
   a call (``[k12-kernels]``: a CUDA graph captured from one call);
   K11's scratch, measured as one call's peak-memory delta beyond its
   outputs, under a fifth of E' H C 4 bytes (``[k11-scratch]``).  Then one training step at full width
   (``runs/r5_theta``'s weights, dropout 0, fixed coins) on a collated batch of the seeded test split, on
   the card in float32 and on the CPU in float64: loss within 1e-5
   relative, every gradient leaf within 1e-4 of that leaf's own largest
   value, the card's optimizer step within 1e-5 of the float64 step from the
   same gradients, and the parameters within 1e-5 of the float64 step beyond
   what a gradient within the gradient tolerance makes of Adam's first step.
   The width phase: K9 (serve, and with keep-scale and lse) and K11 on
   ``theta_n300_d75``'s edges at heads x channels 2x16, 4x12, 4x20, 2x48,
   4x24 and 4x64 (every width ``tune.py`` samples, channel counts that are
   not powers of two), 3x96 and 8x64 (rows past 256 channels: head groups)
   and 2x300 (heads past 256 channels: the wide kernels), K10 and K12 on
   its nodes at d = 96, 256 and 384 (two column blocks), seeded inputs,
   each against the plain version evaluated in float64 as above; then the
   same training step at ``--hidden-dim 96`` (4 heads of 24 channels) and
   ``--hidden-dim 512 --num-heads 8`` (8 heads of 64: head groups), weights
   from ``init_params``, held to the same tolerances, and at ``--hidden-dim
   512`` (4 heads of 128) on the two smallest graphs of the test split
   (``[train-step-h512x4]``), held to the same tolerances, with the worst
   leaf of the CPU's float32 step on that batch printed beside it (the
   CPU's float32 step and the JAX package's own float32 step miss the
   per-leaf 1e-4 at this width: ``tests/test_torch_f32_faults.py``), and
   on the three smallest (``[train-step-h512x4-3g]``): the card's float32
   kernel step against the card's float64 plain step, both with the max
   pooling's node fixed to the float64 step's, the float64 step once with
   its own LeakyReLU branches (printed: a message within float32 rounding
   of 0 takes the other branch, a jump of the function) and once with the
   card's (the worst leaf held to 1.39e-3, twice the JAX package's own
   float32 worst leaf there).
   Then the entry point
   ``ltr_lowrank_sdp_torch.train.main(["--root", "dataset", "--epochs",
   "2", "--output-dir", ...])``, every other flag at its default (full width,
   dropout 0.15, all 53 training graphs, ``MC_600x600_r5`` a batch of its
   own), counters set to 0 just before and read just after: K9 / K11 once
   per GATv2 layer and K10 / K12 once per batch (K9 / K10 also for the
   validation and test batches), no plain version run, the five output
   files, finite losses; its own steps timed (median, max, the
   ``MC_600x600_r5`` step, epoch wall, peak memory), its second epoch under
   the profiler (device busy share); ``infer`` on ``theta_n300_d75`` with
   the checkpoint just written;
13. the HALLaR path: ``hallar_solve`` on the card against the CPU on the
   reference's trace-bound min-eig case and a 40 x 40 matrix completion at a
   reduced ``maxiter_fista`` (the same outer iterations, rank and FISTA
   steps, pobj to 1e-9 and 1e-8), and the min-eig case in float32 (its
   ``<C, YY^T>`` summed in float32 in K5's segment m of the union layout,
   as the reference's ``jnp.sum``): both converge, pobj within 1e-6 of each
   other, their FISTA steps printed side by side
   (``[hallar-min-eig-f32]``); the c5 maximum stable set through ADAP-AIPP
   (``[hallar-c5-aipp]``: both converge, pobj within 1e-8, the counts side
   by side); K4's float32-summing instance (on no path since the fused
   step) at the n = 3,000 path's C and final rank against the float64 sum
   of its terms; K5 (union layout) and K6 at HALLaR's layouts on a maximum
   stable set cone of n = 1,024 (dense C as its n(n+1)/2 upper entries),
   and ``[hallar-fused]`` there: K14-K16 and K5's union layout held to
   their plain versions over machine steps in float64 and float32, AL and
   prox (each sum within gamma_N sum |terms|, each elementwise output
   within 4 eps max |plain|, K15's weights at one point and at both the
   plain bits, K16's scalars and the step's decisions the plain step's);
   then ``ltr_lowrank_sdp_torch.hallar.cli`` on
   ``matcomp_sdpa(1500, 1500, 3, 3.0, 0)`` (n = 3,000, m = 216,171, the
   size of the HALLaR binary's README example) with ``--trace_bound`` 3
   ||M||_* and default parameters, counters set to 0 just before and read
   just after: converged with pinf and gap <= 1e-5, pobj within 1e-5 of the
   LoRADS path's solve of the same file (``--heuristicFactor 10``), K5, K6
   and K14-K16 launched, nothing else (K4 neither) and no plain version
   run; solve time, outer iterations, rank, FISTA and machine steps, host
   reads and CUDA-graph replays printed; K5 and K6 held at the path's
   layouts and final rank, and ``[hallar-fused]`` there with K14-K16
   timed; the plain and the fused machine step each timed eagerly and
   replayed as a CUDA graph, with the graph nodes of a step (8 for the
   fused one); ``[k14-plan]``; one outer iteration at ``maxiter_fista`` 500 under
   the profiler;
14. the parallel modes (``ltr_lowrank_sdp_torch.parallel``): phases 4 and
   5's files solved again with every cone constraint-sharded
   (``Solver(mesh=...)``, ``launch.spawn`` of ``dryrun.sharded_solve``), at
   world size 1 (NCCL) and 2 (gloo: both ranks on this card, which NCCL
   refuses; the all-reduces go through the host, so the times say nothing
   of scaling), one start of the ranks per world size, each solve run cold
   and warm, each rank's counters set to 0 just before each solve and
   read just after: K1, K4, K5 and K6 launched and no plain version run,
   every rank's solves with rank 0's first numbers, the unsharded CLI
   solve's status and ALM / ADMM / CG counts and its pobj within 1e-9
   relative, with the all-reduce count and bytes; ``batched_alm_steps`` on
   8 Delaunay MaxCut instances of n = 2^14 at rank 20, 25 steps, on the
   two gloo ranks (batch axis 2; one K1 launch per step for a rank's 4
   instances), cold and warm, against a loop over the single instances on
   the card (1e-10), and K1 on one rank's block-diagonal CSR of its 4
   instances (row B, which the JAX package computes with a scatter-add)
   against its plain version as in phase 3; ``dryrun`` at world size 2;
16. the row-sharded mode (``mesh_axis="row"``): phase 4's file on two gloo
   ranks of this card (``[mc-row2]``), the n = 2^20 Delaunay MaxCut through
   the CLI (``[dn20]``) and row-sharded at world size 1 over NCCL
   (``[dn20-row1]``), K1-K4 on each half of that cone (``[row-kernels]``);
18. the scaling report's twin (``scripts/scaling_report.py``) at world size
   1 on its JAX configuration (random MaxCut n = 8,192, rank 16): the
   unsharded solver and the sharded one over one NCCL rank, the same inner
   iterations (``[scaling-1]``);
17. the label pipeline: the native SDPA parser (built with g++) against the
   Python tokenizer on phase 5's and 6's files (``[parse]``: identical
   arrays, each reader's seconds); the generator twin writes the dataset's
   ``maxcut_n3200_d14`` and ``MC_100x100_r2`` names and the harvest twin
   solves and processes them on the card, solves them again there, then
   runs on the CPU on one torch thread (``[harvest]``: every solve
   ``primal_dual_optimal``, the card's label trajectories equal to its
   first run's and the CPU's, the graph features equal to the CPU run's (a
   check of the host path: the same numpy processor on both sides), each
   instance's parse, first and repeated solve and processing seconds);
   ``predict_all`` over the ten
   benchmark names' cached graphs on the card against its CPU run and the
   committed ``benchmark/r_sched`` (``[predict-all]``: raw within 1e-4);
   one tuner trial (a stub for Optuna's), 2 epochs on the 20 smallest
   labelled graphs (``[tune]``: a finite val log-MAE each epoch); each
   path's counters set to 0 just before it and read just after, its
   kernels launched and no plain version run;
15. the ``kernels`` JSON line (each kernel's row, and under ``by_path`` its
   row at every main path's shapes; K9-K12's rows at the width phase's
   widths under ``widths``; a ``NAME[float32]`` row for each of K1-K8 with
   its float32 launches on the float32 run of its path; a ``NAME[shard]``
   row for K5 and K6 on a shard's layouts, row 16, with its launches on
   rank 0 of the matrix-completion path's world-size-2 sharded solve;
   ``spmm_sym_csr[batch]``, row B, with its launches on rank 0 of the
   batched steps; each kernel's launches on phase 17's paths under
   ``label_path_launches``), the
   kernels still to be ported (none), the
   solver loops carried as plain torch over the kernels, the card line
   and, last, ``{"ok": true, "device": {...}}``.

Two measurements outside the smoke run, for a Lovasz theta instance too long
for it.  The first builds the kernels, solves the one instance through the
CLI on the card and prints its status, ranks, counts and times, nothing
else; with ``--profile`` it instead runs the solve until the solver's first
time-limit check after S seconds (one per ALM outer iteration) with its
graph replays timed by CUDA events and prints their share of that window:

    python3 chip_smoke.py --theta-solve N,AVG_DEGREE,SEED --time-limit S [--logfile PATH] [--dtype float32]
    python3 chip_smoke.py --theta-solve N,AVG_DEGREE,SEED --time-limit S --profile [--dtype float32]

Phase 16 or 17 alone, after the build (phase 16 after phase 4's solve):

    python3 chip_smoke.py --row-paths
    python3 chip_smoke.py --label-paths

The sharded modes over NCCL on four cards, one rank a card (with fewer it
exits 1 with the count): phases 4-6's files constraint-sharded at world
sizes 2 and 4 (``constr-nccl``: the unsharded counts and pobj within 1e-9,
every rank equal, their kernels launched), the n = 2^20 Delaunay MaxCut
row-sharded (``row-nccl``: ``[dn20-row1/2/4]``; a world size whose counts
part from world size 1's is held to the DIMACS limits on its own and its
certified bracket of the optimum must overlap world size 1's), 16 batched
instances over four ranks (``batch4``), the dry run on a 2 x 2 mesh
(``dryrun4``) and the scaling twin at 1, 2, 4 ranks on both axes
(``scaling``, its artifacts written to ``--scaling-out``); all of them, or
the sub-phases named:

    python3 chip_smoke.py --multi-card [SUBPHASE ...] [--scaling-out DIR]

One diagnosis: the float32 training step of phase 12 at one GNN width with
K9 and K11 each swapped for its plain version in float32 or float64, each
variant's gradient error per leaf against the float64 CPU step:

    python3 chip_smoke.py --train-step HIDDEN,HEADS
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import torch

# H100 SXM: HBM3 rate, FP64 and FP32 (non-tensor-core) peaks, NVIDIA data
# sheet
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12
FP32_FLOP_PER_S = 67e12
ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_RTOL = 1e-12
MAIN_N = 2 ** 14
MAIN_SEED = 14
CHECK_RANKS = (20, 64)
REPORT_RANK = 20          # ceil(2 ln 2^14): the main path's starting rank
MAIN_FLAGS = ("--phase1Tol", "1e+1", "--heuristicFactor", "100")
# the sparse-cone main path: nuclear-norm completion of an (MC_N1, MC_N1)
# rank-3 matrix, the generator's default sampling, the flags of the JAX
# package's matrix-completion test
MC_N1 = 5000
MC_ARGS = (MC_N1, MC_N1, 3, 2.0, 0)
MC_FLAGS = ("--heuristicFactor", "10")
MC_CHECK_RANKS = (19, 64)
MC_REPORT_RANK = 19       # ceil(2 ln 10^4): that path's starting rank
MC_SMALL_ARGS = (200, 200, 2, 1.0, 0)
MAXCUT_KERNELS = ("spmm_sym_csr", "diag_rowdot", "diag_normal_matvec",
                  "sym_contract_sum")
SPARSE_KERNELS = ("spmm_sym_csr", "sym_contract_sum", "coo_contract_segsum",
                  "spmm_constr_csr")
# the multi-block + LP main path: three dense-objective blocks coupled
# through every constraint, and an LP cone; default flags
MB_DIMS = (1000, 800, 600)
MB_M = 2400
MB_NLP = 20000
MB_SEED = 0
MB_REPORT_RANK = 14       # ceil(2 ln 1000): the largest block's starting rank
MB_KERNELS = ("coo_contract_segsum", "spmm_constr_csr", "lp_constr_segsum",
              "lp_col_wsum")
MB_SMALL = dict(dims=(100, 80, 60), m=240, n_lp=2000, seed=0)
# the Lovasz theta shapes: the operators at the width of Mittelmann theta12,
# and the solve of the theta main path (the rank grows on the card in phase
# 8's theta80 solve, 9 to 21, and in a --theta-solve of the theta12 shape)
THETA12_ARGS = (600, 60, 12)
# ceil(2 ln 600), a grown rank, the rank a solve of this shape ends at, Lanczos
THETA12_RANKS = (13, 64, 102, 1)
THETA_N = 300
# m >= 20 n and n <= 400: the solve starts, and stays, at the rank cap
THETA_RANKS = (141, 1)           # the solve's rank, Lanczos
THETA_LIMIT_S = 180.0
DENSE_KERNELS = ("coo_contract_segsum", "spmm_constr_csr")
PTXAS_BY_INSTANCE = DENSE_KERNELS + ("sym_contract_sum", "gatv2_softmax_agg",
                                     "gatv2_softmax_agg_bwd",
                                     "diag_normal_matvec", "gather_rowsum",
                                     "fista_candidate", "al_value")
SLEEP_CYCLES = 50_000_000  # about 30 ms at the H100's clocks
# the rank-schedule predictor: a checkpoint of the repo's one model width
# (hidden 64, 3 GATv2 layers x 4 heads, LSTM 96 x 2), its serve path's
# graph, the largest dataset graph and the predict-then-solve instance
CKPT = os.path.join(ROOT, "runs", "r5_theta")
DATASET = os.path.join(ROOT, "dataset")
SERVE_GRAPH = "theta_n300_d75"
BIG_GRAPH = "MC_600x600_r5"
POOL_BATCH = ("maxcut_n200_d4", "G11", "theta_n95_d23", "MC_100x100_r2",
              "maxcut_n3200_d14", "theta_n460_d115", "MC_300x300_r3",
              "shmup4")
# predict-then-solve: both solves certify, in about 5 s together on the CPU
# and, the card's host-bound loop being 2.4-2.9 times slower at this size,
# about 15 s on the card (theta_sdpa(28, 7, 28): 11.3 s on the CPU, 27.0 and
# 32.5 s in two card runs); theta's iteration count is not monotone in n:
# n = 26, 30, 32, 36, 44 took 22-59 s on the CPU, n = 40 ended maxiter on
# the card
BENCH_THETA = (20, 5, 20)
GNN_TOL = 1e-5            # max |kernel - plain| / max |plain|, float32
LIB_TOL = 1e-4            # K10's float32 library yardstick, same measure
PREDICT_RTOL = 1e-4       # the raw schedule, card against CPU
HALF_INTEGER_BAND = 1e-3
SMALL_POBJ_RTOL = 1e-6    # phase 8: a small problem's pobj, card and CPU
GNN_KERNELS = ("gatv2_softmax_agg", "graph_pool")
# the training path: the default flags of the train entry point (dropout
# 0.15) over the whole dataset; the card-against-CPU step's tolerances
TRAIN_KERNELS = GNN_KERNELS + ("gatv2_softmax_agg_bwd", "graph_pool_bwd")
TRAIN_EPOCHS = 2
TRAIN_DROPOUT = 0.15
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
# the float32 slice: K1-K8 in float32 against their plain versions evaluated
# in float64 on the same float32 inputs (K4 sums in float64: held to the sum
# of its terms' magnitudes), the three main paths through the CLI with
# --dtype float32, and K9-K12 at the GNN widths the tuner samples
F32_KERNEL_TOL = 1e-5     # max |kernel - plain64| / max |plain64|
K4_F32_TOL = 1e-10        # |kernel - plain64| / sum_k |coef_k e_k|
F32_LIB_TOL = 1e-4        # a float32 library yardstick, same measure
F32_POBJ_RTOL = 5e-5      # float32 pobj against the float64 run's
F32_DEVICE_POBJ_RTOL = 1e-5   # device pobj against the host recomputation
F32_FLAGS = ("--dtype", "float32")
# heads x channels per head: every width tune.py samples, with channel
# counts that are not powers of two (12, 20, 24, 48), 4 x 64, heads of 128
# channels (2 x 128; 4 x 128 = 512, --hidden-dim 512's default heads), rows
# past 256 channels (3 x 96 = 288, 8 x 64 = 512: head groups) and heads past
# 256
# channels (2 x 300: the wide kernels); the poolings' widths (384: two
# column blocks)
GNN_WIDTHS = ((2, 16), (4, 12), (4, 20), (2, 48), (4, 24), (4, 64), (3, 96),
              (2, 128), (4, 128), (8, 64), (2, 300))
POOL_WIDTHS = (96, 256, 384)
# full-width training steps at --hidden-dim 96 (r5_theta's 4 heads) and
# 512 (--num-heads 8: 8 x 64, a row past 256 channels in head groups)
WIDE_STEPS = ((96, None), (512, 8))
# the 4 heads x 128 channels step, on the two smallest graphs of the seeded
# test split, held to GRAD_TOL as the other steps; the CPU's float32 step on
# that batch (printed, on a fixed number of threads) misses GRAD_TOL, and so
# does the JAX package's own (tests/test_torch_f32_faults.py)
SMALL_STEP = (512, 4)
SMALL_STEP_GRAPHS = 2
# the 4 x 128 step on the test split's three graphs with the max pooling's
# node fixed to the float64 step's (tests/test_torch_f32_faults.py): its
# worst leaf held to twice the JAX package's own float32 worst there (6.97e-4)
STEP_3G_GRAPHS = 3
STEP_3G_TOL = 1.39e-3
K2_RANKS = (1, 5, 19, 20, 33, 64, 141)   # [k2-plan]: every plan's bits
K2_EMU_ROWS = 256         # rows held to K2's order evaluated on the host
SMALL_STEP_THREADS = 4
# HALLaR's float32 min-eig case, card against CPU: both stop before the
# inner loop's cap (their steps differ by rounding), pobj within this of
# each other
HALLAR_F32_POBJ_RTOL = 1e-6
K4_ACC32_TOL = 1e-5       # K4 summing in float32: of the sum of |terms|
# the HALLaR path: its CLI on the matrix completion that the HALLaR binary's
# README reports (n = 3,000, m = 216,172 there; this generator gives
# 216,171), trace bound 3 ||M||_* of the planted M, default parameters
# (ADAP-FISTA); held to the LoRADS path's solve of the same file
HALLAR_MC = (1500, 1500, 3, 3.0, 0)
HALLAR_LIMIT_S = 300.0
HALLAR_KERNELS = ("coo_contract_segsum", "spmm_constr_csr",
                  "fista_candidate", "al_value", "fista_commit")
HALLAR_REPLACES = {
    "coo_contract_segsum": "ltr_lowrank_sdp_tpu/hallar/solver.py:179,184 "
                           "(AX with CX, one union layout of A and C)",
    "spmm_constr_csr": "ltr_lowrank_sdp_tpu/hallar/solver.py:188",
    "fista_candidate": "ltr_lowrank_sdp_tpu/hallar/solver.py:221-247,"
                       "198-202,291-318",
    "al_value": "ltr_lowrank_sdp_tpu/hallar/solver.py:208-214,277-284",
    "fista_commit": "ltr_lowrank_sdp_tpu/hallar/solver.py:231-232,239-247"}
# HALLaR's c5 maximum stable set through ADAP-AIPP, card against CPU: both
# converge, pobj within this of each other (the 5-cycle is chaotic in the
# reference itself: the counts are printed side by side, not held equal)
HALLAR_AIPP_POBJ_RTOL = 1e-8
HALLAR_FUSED_STEPS = 24      # machine steps held to the plain step's
HALLAR_POBJ_RTOL = 1e-5
# the path's solve: outer iterations, final rank, committed FISTA steps (the
# counts of the step's earlier designs, the torch.where step's and the two
# K15 calls'), and the graph nodes of its machine step (K14 1, K5 2 x 2 with
# C's long segment, K15's pair 1, K6 1, K16 1)
HALLAR_COUNTS = (10, 7, 100000)
HALLAR_STEP_NODES = 8
HALLAR_FUSED_RANKS = (2,)    # [hallar-fused] at these path ranks besides
                             # the final one
# [k14-plan]: K14's plans timed at N = n r of these (n, r), and at the
# threshold K14_CLUSTER_MAX_N; [hallar-fused] holds the two-launch plan on
# its own at HALLAR_K14_ABOVE, past the threshold
K14_PLAN_SHAPES = ((3000, 2), (3000, 7))
HALLAR_K14_ABOVE = (3000, 22)
HALLAR_MSS = (1024, 8, 7)    # maximum stable set: n, average degree, seed
HALLAR_PROFILE_FISTA = 500   # inner steps of the profiled outer iteration

# the repo's one pl.pallas_call: K13 at the probe's defaults, R = 8 and 64;
# every plan also at an M < N shape (the gather's plan), with no index (what
# a call costs without its work), at N from 16,384 to the largest the
# shared histogram takes (K13_MAX_SMEM_BINS: past N grid = 16 M the
# warp-aggregated atomics are planned) and at two skewed index sets of the
# default shape
GATHER_SHAPES = ((8192, 262144, 32), (8192, 262144, 8), (8192, 262144, 64))
K13_PLAN_SHAPES = ((100000, 20000, 32, None), (8192, 0, 32, None),
                   (16384, 262144, 32, None), (32768, 262144, 32, None),
                   (49152, 262144, 32, None), (8192, 262144, 32, "equal"),
                   (8192, 262144, 32, "zipf"))
# the parallel modes: each sharded main path at world size 1 (NCCL) and 2
# (gloo), held to its unsharded solve; batched ALM steps on BATCH_B MaxCut
# instances of n = 2^14
PAR_RUNS = ((1, "nccl"), (2, "gloo"))
PAR_POBJ_RTOL = 1e-9
PAR_KERNELS = ("spmm_sym_csr", "sym_contract_sum", "coo_contract_segsum",
               "spmm_constr_csr")
SHARD_REPLACES = {"coo_contract_segsum":
                  "ltr_lowrank_sdp_tpu/parallel/meshops.py:211",
                  "spmm_constr_csr":
                  "ltr_lowrank_sdp_tpu/parallel/meshops.py:220"}
BATCH_B, BATCH_RANK, BATCH_STEPS, BATCH_RHO = 8, 20, 25, 1.0
BATCH_TOL = 1e-10
# the multi-card mode (--multi-card, MULTI_CARDS cards, one NCCL rank a
# card; its sub-phases MULTI_PHASES): phases 4-6's files constraint-sharded
# ([constr-ncclN]) and the n = 2^20 Delaunay MaxCut row-sharded
# ([dn20-rowN]) at each world size of MULTI_WORLDS; BATCH4_B instances over
# MULTI_CARDS ranks ([batch4]); the dry run on a 2 x 2 mesh ([dryrun4]); the
# scaling twin at SCALING_WORLDS on both axes ([scaling]); its world-size-1
# rows in the default run ([scaling-1])
MULTI_CARDS = 4
MULTI_WORLDS = (2, 4)
MULTI_PHASES = ("constr-nccl", "row-nccl", "batch4", "dryrun4", "scaling")
BATCH4_B = 16
SCALING_WORLDS = (1, 2, 4)
# the row-sharded mode (mesh_axis="row"): bench.py:73-78's delaunay_n20_gen
# (n = 2^20, the construction of its _ensure_dn20, phase1_tol=1e+1,
# heuristic_factor=100) unsharded through the CLI and row-sharded at world
# size 1 over NCCL ([dn20]); phase 4's file row-sharded at world size 2 over
# gloo on this card ([mc-row2]); K1-K4 on each of ROW_WORLD ranks' shards of
# the n = 2^20 cone ([row-kernels])
DN20_N, DN20_SEED = 2 ** 20, 20
DN20_LIMITS = (1e-5, 5e-5, 5e-5)      # host float64 pinf, gap; dinf
ROW_POBJ_RTOL = 1e-9
ROW_WORLD = 2
ROW_REPLACES = {"spmm_sym_csr": "ltr_lowrank_sdp_tpu/ops/gatherseg.py:248 "
                "(rows sharded: solver/driver.py:169-174)",
                "diag_rowdot": "ltr_lowrank_sdp_tpu/ops/coneops.py:231 "
                "(rows sharded: solver/driver.py:169-174)",
                "diag_normal_matvec": "ltr_lowrank_sdp_tpu/ops/coneops.py:272 "
                "(rows sharded: solver/driver.py:169-174)",
                "sym_contract_sum": "ltr_lowrank_sdp_tpu/ops/coneops.py:332 "
                "(rows sharded: solver/driver.py:169-174)"}
# K1's plans ([k1-plan]): the ranks and, per value type, the bound on the
# planned launch against the plain version (2-norm relative: the unit
# roundoff, as the sums differ only by fused multiply-adds)
K1_PLAN_RANKS = (1, 19, 20, 33, 64)
K1_PLAIN_TOL = {torch.float64: 2.2e-16, torch.float32: 1.2e-7}
# PERF.md section 5's float64 rows: ALM outer /
# inner, ADMM and CG iterations, host syncs (one a chunk or pass of the
# replayed loops; the eager loops read 305, 161 and 4,252 times) and final
# ranks of each main path's CLI solve
SOLVE_COUNTS = {"main": (6, 107, 8, 46, 20, [20]),
                "matcomp": (9, 43, 1, 43, 28, [19]),
                "multiblock_lp": (10, 955, 13, 2205, 41, [14, 14, 13])}
K1_FOLDS = {}             # K1's launches with the row scale folded, per path
UNPORTED = []
# The reference's device-resident solver loops are jnp loops over the
# operators above, with no gather or segment-reduction kernel of their own;
# the port carries them as torch loops over K1-K8: the CG, the L-BFGS
# recursion and the line search inside the ALM inner pass and the ADMM
# chunks, replayed as CUDA graphs with conditional nodes.  Fusing
# their elementwise work is performance work, not a kernel still to be
# ported.
LOOPS = [
    "11 ltr_lowrank_sdp_tpu/ops/cg.py:31 cg_solve, ops/lanczos.py:23 "
    "lanczos_tridiag -> ltr_lowrank_sdp_torch/ops/cg.py (cg_device, a WHILE "
    "node of the ADMM chunk's graph), ops/lanczos.py",
    "12 ltr_lowrank_sdp_tpu/ops/lbfgs.py:71,48 direction, push_pair -> "
    "ltr_lowrank_sdp_torch/ops/lbfgs.py (direction_t, push_pair_t in the "
    "ALM pass's graph)",
    "13 ltr_lowrank_sdp_tpu/ops/lanczos.py:162 oracle_rank_gram -> "
    "ltr_lowrank_sdp_torch/ops/lanczos.py (torch.matmul + host eigh)",
    "15 ltr_lowrank_sdp_tpu/hallar/solver.py:205,258 _make_fista, "
    "_make_aipp -> ltr_lowrank_sdp_torch/hallar/solver.py (ported: the "
    "machine step on K14 fista_candidate, K5 on the union layout, K15 "
    "al_value, K6, K16 fista_commit, replayed as CUDA graphs; the prox "
    "rounds and AIPP's acceptance test plain torch on the host); "
    "ops/lanczos.py:115 lanczos_min_eig_vec -> ops/lanczos.py (torch over "
    "K6)",
]


# calls of the eager ALM pass and ADMM loop (those of a sharded solve) in
# the CLI solves, which must take the replayed loops only
EAGER_STEPS: dict = {}


def count_eager_steps() -> None:
    """Wraps the eager ALM inner pass and ADMM loop so that a call is
    counted in EAGER_STEPS."""
    from ltr_lowrank_sdp_torch.solver import admm, alm

    for cls, name in ((alm.ALMPhase, "_inner_pass_eager"),
                      (admm.ADMMPhase, "loop_eager")):
        orig = getattr(cls, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            EAGER_STEPS[_name] = EAGER_STEPS.get(_name, 0) + 1
            return _orig(self, *a, **kw)

        setattr(cls, name, counted)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after a warm-up.

    At these sizes one launch runs for a few microseconds, less than the
    host needs to issue it, so back-to-back launches would time the host.
    A sleep kernel queued first holds the stream while the host issues all
    ``iters`` calls; the events then bracket device work only."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_call_ms(fn, iters: int = 50) -> float:
    """Mean wall time of one call issued back to back, synchronized at the
    end: what a caller that launches the kernel in a loop sees."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def bound_ms(nbytes: float, flops: float, flop_rate: float = FP64_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-300))


def k56_instance(K, name, r, layout, dtype=torch.float64, mode=2) -> str:
    """The instantiation that K5 (``coo_contract_segsum``, in ``mode``: 0
    single, 1 ``U is V``, 2 pair) or K6 (``spmm_constr_csr``) launches at
    rank ``r`` on ``layout``, with its registers and spill bytes from this
    run's ``-Xptxas -v``."""
    if name == "coo_contract_segsum":
        plan = K.k5_plan(r, layout.m)
        key = (mode, plan.g, plan.cpl, plan.kc)
    else:
        plan = K.k6_plan(r, layout.n, layout.max_row)
        key = (plan.g, plan.cpl)
    kind = "f32" if dtype == torch.float32 else "f64"
    use = K.ptxas_usage(name).get(("main", kind, key))
    regs = ("registers not in this run's build log" if use is None else
            f"{use[0]} registers, spill stores / loads {use[1]} / {use[2]} "
            "bytes")
    return f"[{kind} {plan.describe()}: {regs}]"


def check_k5_kc(K, seg, U, V, tag, pair=False, timed=False) -> None:
    """K5's constraints per group (1 or 2) only say which group computes a
    constraint: both give the planned launch's bits.  ``timed`` prints each
    one's time (``[k5-kc]``), the evidence for ``k5_plan``'s choice."""
    plan = K.k5_plan(U.shape[1], seg.m)
    want = K.coo_contract_segsum(seg, U, V, pair=pair)
    want = want if pair else (want,)
    times = {}
    for kc in (1, 2):
        if plan.g == 1 or (kc == 2 and 2 * plan.cpl > K.MAX_CPL):
            continue
        p = K.K5Plan(plan.g, plan.cpl, kc)
        got = K.coo_contract_segsum_with(p, seg, U, V, pair=pair)
        got = got if pair else (got,)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K5 {tag}: KC={kc} gave other bits than {plan.describe()}")
        if timed:
            times[kc] = time_ms(
                lambda: K.coo_contract_segsum_with(p, seg, U, V, pair=pair))
    if times:
        print(f"[k5-kc] {tag} {'pair' if pair else 'U-is-V'}: planned "
              f"{plan.describe()}; "
              + ", ".join(f"KC={k} {v:.4f} ms" for k, v in times.items()),
              flush=True)


def check_k6_warps(K, csr, w, Y, tag, Z=None, beta=1.0, timed=False) -> None:
    """K6's warps per row only say which warp adds which of a row's fixed
    subtrees: every value (1, 2, 4, 8) gives the planned launch's bits.
    ``timed`` prints each one's time (``[k6-warps]``), the evidence for
    ``k6_plan``'s choice."""
    plan = K.k6_plan(Y.shape[1], csr.n, csr.max_row)
    want = K.spmm_constr_csr(csr, w, Y, Z, beta)
    times = {}
    for wpr in (1, 2, 4, 8):
        p = K.K6Plan(plan.g, plan.cpl, wpr)
        got = K.spmm_constr_csr_with(p, csr, w, Y, Z, beta)
        require(torch.equal(got, want),
                f"K6 {tag}: W={wpr} gave other bits than {plan.describe()}")
        if timed:
            times[wpr] = time_ms(
                lambda: K.spmm_constr_csr_with(p, csr, w, Y, Z, beta))
    if times:
        print(f"[k6-warps] {tag} r={Y.shape[1]}: planned {plan.describe()}; "
              + ", ".join(f"W={k} {v:.4f} ms" for k, v in times.items()),
              flush=True)


def check_k4_plans(K, rows, cols, coef, U, V, tag) -> dict:
    """K4's grid only says which block walks which chunk: every plan of
    ``k4_plans`` (1 block, half the planned grid, twice the cap) gives the
    planned launch's bits, and so do three more calls, a CUDA-graph replay,
    and two graphs captured on one stream replayed at once on two.  Prints each plan's time (``[k4-plan]``), the evidence for
    ``k4_plan``'s grid; returns the planned plan's fields for the kernels
    line."""
    dev = U.device
    plans = K.k4_plans(rows.numel(), U.shape[1], K.k4_cap(U, U is V))
    want = K.sym_contract_sum(rows, cols, coef, U, V)
    for _ in range(3):
        require(torch.equal(K.sym_contract_sum(rows, cols, coef, U, V), want),
                f"K4 {tag}: two calls gave different bits")
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        K.sym_contract_sum(rows, cols, coef, U, V)      # the graph's warm-up
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        static = K.sym_contract_sum(rows, cols, coef, U, V)
    graph.replay()
    torch.cuda.synchronize()
    require(torch.equal(static, want),
            f"K4 {tag}: a CUDA-graph replay gave other bits")
    # a second graph captured on the same stream takes a ticket of its own:
    # both replayed at once, on two streams, still give the bits
    graph2 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph2, stream=side):
        static2 = K.sym_contract_sum(rows, cols, coef, U, V)
    two = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    for s in two:
        s.wait_stream(torch.cuda.current_stream(dev))
    for _ in range(20):
        for g, s in zip((graph, graph2), two):
            with torch.cuda.stream(s):
                g.replay()
    torch.cuda.synchronize()
    require(torch.equal(static, want) and torch.equal(static2, want),
            f"K4 {tag}: two graphs replayed at once gave other bits")
    times = []
    for plan in plans:
        got = K.sym_contract_sum_with(plan, rows, cols, coef, U, V)
        require(torch.equal(got, want),
                f"K4 {tag}: {plan.describe()} gave other bits than "
                f"{plans[0].describe()}")
        times.append(time_ms(lambda: K.sym_contract_sum_with(
            plan, rows, cols, coef, U, V)))
    print(f"[k4-plan] {tag} {'U-is-V' if U is V else 'pair'}: planned "
          f"{plans[0].describe()}, the same bits over {len(plans)} plans, 3 "
          "calls, a graph replay and two graphs replayed at once; "
          + ", ".join(
              f"grid={p.grid} {t:.5f} ms" for p, t in zip(plans, times)),
          flush=True)
    return {"plan": plans[0].describe()}


def count_k4_kernels(K, rows, cols, coef, U, tag, calls=5) -> None:
    """One device kernel per K4 call, exactly: the kernel nodes of a CUDA
    graph captured from one call.  ``torch.profiler`` over ``calls`` calls
    is printed beside it and must record no other kernel and at most one a
    call; it is not held to one a call, because late in a long process it
    can drop every device record of a short window."""
    from torch.profiler import ProfilerActivity, profile

    from ltr_lowrank_sdp_torch.testing import captured_kernel_nodes

    nodes = captured_kernel_nodes(
        lambda: K.sym_contract_sum(rows, cols, coef, U, U))
    K.sym_contract_sum(rows, cols, coef, U, U)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            K.sym_contract_sum(rows, cols, coef, U, U)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    short = sorted({m.group(1) if m else n[:40] for n in names
                    for m in [re.search(r"(\w+_kernel)", n)]})
    print(f"[k4-kernels] {tag}: {nodes} kernel node(s) in a graph captured "
          f"from one call; the profiler recorded {len(names)} device "
          f"kernels in {calls} calls ({', '.join(short)})", flush=True)
    require(nodes == 1, f"K4 {tag}: {nodes} kernels in one call")
    require(len(names) <= calls
            and all("sym_contract_kernel" in n for n in names),
            f"K4 {tag}: the profiler recorded other kernels than K4's, or "
            "more than one a call")


def check_shard_bits(K, cone, mops, dev, r, tag) -> None:
    """On the card, a rank's K5 constraint segment and K6 row slice give the
    full layouts' outputs there, bit for bit (the sharded operators add
    exact zeros elsewhere)."""
    g = torch.Generator(device=dev).manual_seed(2033)
    U, V = (torch.randn((cone.n, r), generator=g, dtype=torch.float64,
                        device=dev) for _ in range(2))
    w = torch.randn(cone.m, generator=g, dtype=torch.float64, device=dev)
    lo, hi = mops.cv_range
    whole = K.coo_contract_segsum(cone.a_seg, U, V, pair=True)
    part = K.coo_contract_segsum(mops.cv_seg, U, V, pair=True)
    require(all(torch.equal(p, x[lo:hi]) for p, x in zip(part, whole)),
            f"{tag}: K5 on the shard differs from the whole layout's bits")
    a, b = mops.mm_range
    whole = K.spmm_constr_csr(cone.a_csr, w, U)
    part = K.spmm_constr_csr(mops.mm_csr, w, U)
    require(torch.equal(part[a:b], whole[a:b]) and not part[:a].any()
            and not part[b:].any(),
            f"{tag}: K6 on the shard differs from the whole layout's bits")
    print(f"[shard-bits] {tag} r={r}: K5 constraints {lo}..{hi - 1} and K6 "
          f"rows {a}..{b - 1} bitwise the whole layouts'", flush=True)


def profile_call(fn, tag: str, what: str) -> None:
    """``fn()`` under ``torch.profiler``: device busy share of the wall time
    and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    print_profile(prof, wall, tag, what)


def print_profile(prof, wall: float, tag: str, what: str,
                  graph_s: float = 0.0, replays: int = 0) -> None:
    """The device busy share of ``wall`` in a finished profile (the kernels
    the profiler recorded) and the kernels that take it; with ``replays``,
    beside it and not added to it, the graph span share: ``graph_s``, the
    device spans of that many CUDA-graph replays, first node to last with
    the gaps between nodes, over ``wall``."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        c, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values()) / 1e6
    print(f"[{tag}] {what} wall {wall:.3f} s under the profiler, device "
          f"busy {busy:.4f} s ({100 * busy / wall:.1f} %): "
          f"{len(kernels)} device kernels (profiler)"
          + (f"; graph span share {100 * graph_s / wall:.1f} %: {replays} "
             f"graph replays {graph_s:.4f} s (CUDA events, first node to "
             f"last, gaps included)" if replays else ""))
    for name, (c, us) in sorted(by_name.items(), key=lambda x: -x[1][1])[:12]:
        print(f"[{tag}] {us / 1e3:9.3f} ms {c:6d} x {name[:90]}", flush=True)


def _measure(name, tag, kern, plain, nbytes, flops, lib=None, extra=(),
             lib_ref=None):
    """Hold one kernel call against its plain version (and the ``extra``
    (kernel, plain) pairs: other operand modes, correctness only), then time
    both and the library yardstick, which must agree with the kernel or,
    where it computes only a part of the kernel's function, with
    ``lib_ref()``.  Returns the kernels-line fields."""
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    rel = max(rel_err(a, b) for a, b in zip(out_k, out_p))
    abs_err = max(float((a - b).abs().max()) for a, b in zip(out_k, out_p))
    for kx, px in extra:
        a, b = kx(), px()
        torch.cuda.synchronize()
        rel = max(rel, rel_err(a, b))
    require(rel <= KERNEL_RTOL,
            f"{name} {tag}: rel err {rel:.3e} > {KERNEL_RTOL}")
    ms, plain_ms, call_ms = time_ms(kern), time_ms(plain), host_call_ms(kern)
    lib_ms = None
    if lib is not None:
        out_l = lib()
        out_l = out_l if isinstance(out_l, tuple) else (out_l,)
        ref = out_k if lib_ref is None else (lib_ref(),)
        require(max(rel_err(a, b) for a, b in zip(ref, out_l))
                <= KERNEL_RTOL, f"{name} {tag}: library result differs")
        lib_ms = time_ms(lib)
    b_ms, b_by = bound_ms(nbytes, flops)
    lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "null"
    print(f"[kernel] {name} {tag}: max rel err {rel:.2e} (tol "
          f"{KERNEL_RTOL:g}), max abs err {abs_err:.2e}, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
          f"{lib_txt} ms, {nbytes / ms / 1e6:.1f} GB/s; host-issued call "
          f"{call_ms:.4f} ms", flush=True)
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def check_kernels(K, cone, dev):
    """Phase 3.  Returns {name: row} for the kernels line at REPORT_RANK."""
    n = cone.n
    csr = cone.c_csr
    nnz_full, nnz_up = csr.nnz, cone.c_nnz
    dv = cone.diag_val
    rows, cols, coef = cone.c_rows, cone.c_cols, cone.c_double_coef
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "sparse CSR support is beta"
        c_sparse = torch.sparse_csr_tensor(
            csr.indptr, csr.indices, csr.vals, size=(n, n),
            check_invariants=True)
    g = torch.Generator(device=dev).manual_seed(2024)
    report = {}
    for r in CHECK_RANKS:
        def rnd(*shape):
            return torch.randn(shape, generator=g, dtype=torch.float64,
                               device=dev)

        Y, U, V = rnd(n, r), rnd(n, r), rnd(n, r)
        w = rnd(n)
        f8, i4 = 8, 4
        cases = {
            # name: (kernel call, plain call, bytes, flops, library call)
            "spmm_sym_csr": (
                lambda: K.spmm_sym_csr(csr, Y, 1.0),
                lambda: K.spmm_sym_csr_plain(csr, Y, 1.0),
                (n + 1) * i4 + nnz_full * (i4 + f8) + 2 * n * r * f8,
                2.0 * nnz_full * r + n * r,
                lambda: torch.sparse.mm(c_sparse, Y)),
            # the yardstick: one call that computes the row dot of U and V
            # (the kernel also scales it and gives V's row norms)
            "diag_rowdot": (
                lambda: K.diag_rowdot(U, V, dv, 2.0, second=True),
                lambda: K.diag_rowdot_plain(U, V, dv, 2.0, second=True),
                2 * n * r * f8 + n * f8 + 2 * n * f8,
                4.0 * n * r + 3 * n, lambda: torch.linalg.vecdot(U, V)),
            "diag_normal_matvec": (
                lambda: K.diag_normal_matvec(U, V, dv),
                lambda: K.diag_normal_matvec_plain(U, V, dv),
                3 * n * r * f8 + n * f8, 4.0 * n * r + 2 * n, None),
            "sym_contract_sum": (
                lambda: K.sym_contract_sum(rows, cols, coef, U, U),
                lambda: K.sym_contract_sum_plain(rows, cols, coef, U, U),
                nnz_up * (2 * i4 + f8) + n * r * f8 + f8,
                (2.0 * r + 1) * nnz_up, None),
        }
        # the other operand modes each kernel has on the path: correctness
        extra = {
            "spmm_sym_csr": [
                (lambda: K.spmm_sym_csr(csr, Y, 0.5, w),
                 lambda: K.spmm_sym_csr_plain(csr, Y, 0.5, w)),
                (lambda: K.spmm_sym_csr(None, Y, 0.0, w),
                 lambda: K.spmm_sym_csr_plain(None, Y, 0.0, w)),
                (lambda: K.spmm_sym_csr(csr, Y[:, :1].contiguous(), 2.0, w),
                 lambda: K.spmm_sym_csr_plain(csr, Y[:, :1].contiguous(),
                                              2.0, w))],
            "diag_rowdot": [(lambda: K.diag_rowdot(U, V, dv, 1.0),
                             lambda: K.diag_rowdot_plain(U, V, dv, 1.0))],
            "diag_normal_matvec": [],
            "sym_contract_sum": [
                (lambda: K.sym_contract_sum(rows, cols, coef, U, V),
                 lambda: K.sym_contract_sum_plain(rows, cols, coef, U, V))],
        }
        lib_ref = {"diag_rowdot": lambda: torch.sum(U * V, dim=-1)}
        for name, (kern, plain, nbytes, flops, lib) in cases.items():
            row = _measure(name, f"n={n} r={r}", kern, plain, nbytes, flops,
                           lib, extra[name], lib_ref.get(name))
            if r == REPORT_RANK:
                report[name] = row
        if r == REPORT_RANK:
            report["diag_rowdot"]["plan"] = check_k2_plans(
                K, U, V, dv, f"maxcut n={n} r={r}")
            report["diag_normal_matvec"]["plan"] = check_k3_plans(
                K, U, V, dv, f"maxcut n={n} r={r}")
        if r == REPORT_RANK:
            report["sym_contract_sum"].update(check_k4_plans(
                K, rows, cols, coef, U, U, f"maxcut n={n} r={r}"))
            check_k4_plans(K, rows, cols, coef, U, V, f"maxcut n={n} r={r}")
            count_k4_kernels(K, rows, cols, coef, U, f"maxcut n={n} r={r}")
    # every rank of K2_RANKS in both value types at the MaxCut path's n: K2
    # and K3 (x, F = U, V)
    for dt in (torch.float64, torch.float32):
        for r in K2_RANKS:
            U, V = (torch.randn((n, r), generator=g, dtype=torch.float64,
                                device=dev).to(dt) for _ in range(2))
            check_k2_plans(K, U, V, dv.to(dt), f"n={n} r={r}")
            check_k3_plans(K, U, V, dv.to(dt), f"n={n} r={r}")
    return report


def check_objective_kernels(K, cone, dev, ranks, report_rank, tag,
                            alpha=0.37):
    """Phase 3 for K1 and K4 as a general cone's path calls them: K1 as
    ``alpha * C @ Y`` with no diagonal term (``apply_w``'s first launch, its
    output then K6's addend; r = 1 from the Lanczos certificate) and K4 on
    the cone's own C entries.  Returns {name: row} at ``report_rank``."""
    n, csr = cone.n, cone.c_csr
    nnz_full, nnz_up = csr.nnz, cone.c_nnz
    rows, cols, coef = cone.c_rows, cone.c_cols, cone.c_double_coef
    f8, i4 = 8, 4
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "sparse CSR support is beta"
        c_scaled = torch.sparse_csr_tensor(
            csr.indptr, csr.indices, alpha * csr.vals, size=(n, n),
            check_invariants=True)
    g = torch.Generator(device=dev).manual_seed(2026)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)

    report = {}
    w = rnd(cone.m)
    for r in (*ranks, 1):
        Y, U, V = rnd(n, r), rnd(n, r), rnd(n, r)
        shape = f"{tag} n={n} C nnz={nnz_up} r={r}"
        k1 = _measure(
            "spmm_sym_csr", f"alpha={alpha} no-d {shape}",
            lambda: K.spmm_sym_csr(csr, Y, alpha),
            lambda: K.spmm_sym_csr_plain(csr, Y, alpha),
            (n + 1) * i4 + nnz_full * (i4 + f8) + 2 * n * r * f8,
            2.0 * nnz_full * r + n * r,
            lambda: torch.sparse.mm(c_scaled, Y))
        # apply_w on this path: K1, then K6 accumulating onto K1's output
        got = K.spmm_constr_csr(cone.a_csr, w, Y,
                                Z=K.spmm_sym_csr(csr, Y, alpha))
        want = K.spmm_constr_csr_plain(
            cone.a_csr, w, Y, Z=K.spmm_sym_csr_plain(csr, Y, alpha))
        require(rel_err(got, want) <= KERNEL_RTOL,
                f"K1 then K6 {shape}: apply_w differs")
        if r == 1:
            continue        # K4 runs at the factors' rank only
        k4 = _measure(
            "sym_contract_sum", f"U-is-V {shape}",
            lambda: K.sym_contract_sum(rows, cols, coef, U, U),
            lambda: K.sym_contract_sum_plain(rows, cols, coef, U, U),
            nnz_up * (2 * i4 + f8) + n * r * f8 + f8,
            (2.0 * r + 1) * nnz_up, None,
            [(lambda: K.sym_contract_sum(rows, cols, coef, U, V),
              lambda: K.sym_contract_sum_plain(rows, cols, coef, U, V))])
        if r == report_rank:
            k4.update(check_k4_plans(K, rows, cols, coef, U, U, shape))
            report = {"spmm_sym_csr": k1, "sym_contract_sum": k4}
    return report


def check_general_kernels(K, seg, csr, dev, ranks, report_rank, tag):
    """Phase 3 for K5 and K6 on one cone's two layouts.  Returns {name: row}
    at ``report_rank``: K5 in pair mode (the ALM line search, once per inner
    iteration) and K6 alone (the ALM gradient's A*(w) R)."""
    # m: K5's constraints; mw: K6's weights (more than m on a shard's
    # layouts, whose K6 slots keep their global constraint ids)
    n, m, nnz, slots, mw = seg.n, seg.m, seg.nnz, csr.nnz, csr.m
    f8, i4 = 8, 4
    g = torch.Generator(device=dev).manual_seed(2025)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)

    report = {}
    for r in ranks:
        U, V, Z = rnd(n, r), rnd(n, r), rnd(n, r)
        w = rnd(mw)
        w0 = torch.where(torch.arange(mw, device=dev) % 3 == 0, 0.0, w)
        u1 = U[:, :1].contiguous()
        # the yardstick: one CSR product with the slot weights w[cid] * val
        # multiplied in beforehand (and equal (row, col) slots merged), so
        # it leaves out the weight gather that K6 does on every call
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s_w = torch.sparse_coo_tensor(
                torch.stack([csr.row_ids, csr.indices.long()]),
                w[csr.cid.long()] * csr.vals,
                size=(n, n)).coalesce().to_sparse_csr()
        k5_bytes = (m + 1) * i4 + nnz * (2 * i4 + f8) + m * f8
        k6_bytes = ((n + 1) * i4 + slots * (2 * i4 + f8) + mw * f8
                    + 2 * n * r * f8)
        shape = f"{tag} n={n} m={m} nnz={nnz} r={r}"
        i5 = k56_instance(K, "coo_contract_segsum", r, seg)
        i6 = k56_instance(K, "spmm_constr_csr", r, csr)
        rows = {
            "coo_contract_segsum": _measure(
                "coo_contract_segsum", f"pair {shape} {i5}",
                lambda: K.coo_contract_segsum(seg, U, V, pair=True),
                lambda: K.coo_contract_segsum_plain(seg, U, V, pair=True),
                k5_bytes + 2 * n * r * f8 + m * f8, 6.0 * nnz * r),
            "spmm_constr_csr": _measure(
                "spmm_constr_csr", f"alone {shape} slots={slots} {i6}",
                lambda: K.spmm_constr_csr(csr, w, U),
                lambda: K.spmm_constr_csr_plain(csr, w, U),
                k6_bytes, 2.0 * slots * r + slots,
                lambda: torch.sparse.mm(s_w, U)),
        }
        rows["coo_contract_segsum"]["instance"] = i5
        rows["spmm_constr_csr"]["instance"] = i6
        _measure("coo_contract_segsum", f"single {shape}",
                 lambda: K.coo_contract_segsum(seg, U, V),
                 lambda: K.coo_contract_segsum_plain(seg, U, V),
                 k5_bytes + 2 * n * r * f8, 4.0 * nnz * r)
        _measure("coo_contract_segsum", f"U-is-V {shape}",
                 lambda: K.coo_contract_segsum(seg, U, U),
                 lambda: K.coo_contract_segsum_plain(seg, U, U),
                 k5_bytes + n * r * f8, 2.0 * nnz * r)
        _measure("spmm_constr_csr", f"addend {shape}",
                 lambda: K.spmm_constr_csr(csr, w, U, Z=Z, beta=1.0),
                 lambda: K.spmm_constr_csr_plain(csr, w, U, Z=Z, beta=1.0),
                 k6_bytes + n * r * f8, 2.0 * slots * r + slots + n * r)
        _measure("spmm_constr_csr", f"zero-weights {shape}",
                 lambda: K.spmm_constr_csr(csr, w0, U, Z=Z, beta=-0.5),
                 lambda: K.spmm_constr_csr_plain(csr, w0, U, Z=Z, beta=-0.5),
                 k6_bytes + n * r * f8, 2.0 * slots * r + slots + n * r)
        _measure("spmm_constr_csr", f"r=1 {tag} n={n} m={m} slots={slots} "
                 f"{k56_instance(K, 'spmm_constr_csr', 1, csr)}",
                 lambda: K.spmm_constr_csr(csr, w, u1, Z=u1),
                 lambda: K.spmm_constr_csr_plain(csr, w, u1, Z=u1),
                 (n + 1) * i4 + slots * (2 * i4 + f8) + mw * f8 + 3 * n * f8,
                 3.0 * slots + n)
        if mw == m:
            # the ADMM normal-equation matvec: K5 then K6, nothing between
            got = K.spmm_constr_csr(csr, K.coo_contract_segsum(seg, U, V), V,
                                    Z=U)
            want = K.spmm_constr_csr_plain(
                csr, K.coo_contract_segsum_plain(seg, U, V), V, Z=U)
            require(rel_err(got, want) <= KERNEL_RTOL,
                    f"K5 then K6 {shape}: normal-equation matvec differs")
        # no atomics: the same bits on every call, and at every K6 warps
        # per row
        require(torch.equal(K.coo_contract_segsum(seg, U, V),
                            K.coo_contract_segsum(seg, U, V))
                and torch.equal(K.spmm_constr_csr(csr, w, U),
                                K.spmm_constr_csr(csr, w, U)),
                f"K5/K6 {shape}: two calls gave different bits")
        check_k6_warps(K, csr, w, U, shape, timed=True)
        check_k6_warps(K, csr, w0, U, shape, Z=Z, beta=-0.5)
        check_k6_warps(K, csr, w, u1, shape, Z=u1, timed=True)
        check_k5_kc(K, seg, U, V, shape, pair=True, timed=True)
        check_k5_kc(K, seg, U, U, shape)
        if r == report_rank:
            report = rows
    return report


def trace_cone_entries(n=4096, m=8192, nnz_per=4, seed=3):
    """``(rows, cols, vals, cid, n, m + 1)`` of a random sparse cone with
    ``nnz_per`` entries per constraint (repeats and diagonal entries
    included), one constraint with no entry, and a last, trace-like
    constraint of n diagonal entries."""
    import numpy as np

    from ltr_lowrank_sdp_torch.testing import random_sparse_cone

    cone = random_sparse_cone(np.random.default_rng(seed), n, m,
                              nnz_per=nnz_per, force_kind="sparse").cones[0]
    keep = cone.a_cid != 1
    diag = np.arange(n)
    rows = np.concatenate([cone.a_rows[keep], diag])
    cols = np.concatenate([cone.a_cols[keep], diag])
    vals = np.concatenate([cone.a_vals[keep], np.ones(n)])
    cid = np.concatenate([cone.a_cid[keep], np.full(n, m)])
    return rows, cols, vals, cid, n, m + 1


def check_long_segments(K, entries, dev, r, tag):
    """K5 on a cone with one long segment, with the long-segment split (the
    layout the port builds) and without it (every segment one warp's walk),
    all three modes, both timed in this call: same values to KERNEL_RTOL, the
    same bits on repeated calls."""
    rows, cols, vals, cid, n, m = entries
    split = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, dev)
    whole = K.SegCOO.from_coo(rows, cols, vals, cid, n, m, dev,
                              long_thresh=None)
    require(split.n_chunks > 0 and whole.n_chunks == 0,
            f"{tag}: the layout has a long segment")
    longest = int((split.seg_ptr[1:] - split.seg_ptr[:-1]).max())
    g = torch.Generator(device=dev).manual_seed(2027)
    U = torch.randn((n, r), generator=g, dtype=torch.float64, device=dev)
    V = torch.randn((n, r), generator=g, dtype=torch.float64, device=dev)
    for mode, a, b, pair in (("single", U, V, False), ("U-is-V", U, U, False),
                             ("pair", U, V, True)):
        got = K.coo_contract_segsum(split, a, b, pair=pair)
        ref = K.coo_contract_segsum(whole, a, b, pair=pair)
        plain = K.coo_contract_segsum_plain(split, a, b, pair=pair)
        again = K.coo_contract_segsum(split, a, b, pair=pair)
        torch.cuda.synchronize()
        if not pair:
            got, ref, plain, again = (got,), (ref,), (plain,), (again,)
        rel = max(max(rel_err(x, y), rel_err(x, z))
                  for x, y, z in zip(got, ref, plain))
        require(rel <= KERNEL_RTOL, f"K5 {tag} {mode}: split differs {rel:.2e}")
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"K5 {tag} {mode}: two calls gave different bits")
        ms_split = time_ms(
            lambda: K.coo_contract_segsum(split, a, b, pair=pair))
        ms_whole = time_ms(
            lambda: K.coo_contract_segsum(whole, a, b, pair=pair))
        print(f"[kernel] coo_contract_segsum long-segment {tag} n={n} m={m} "
              f"longest={longest} chunks={split.n_chunks} r={r} {mode}: with "
              f"the split {ms_split:.4f} ms, without {ms_whole:.4f} ms, max "
              f"rel err {rel:.2e}, same bits on two calls", flush=True)


def check_dense_objective(K, cone, dev, ranks, tag):
    """The dense-objective ``apply_w`` chain of a cone: ``obj_coef * C @ Y``
    by ``torch.matmul`` (no kernel of the port, as in the JAX package), then
    K6 accumulating A*(w) Y onto it, against the plain chain; the product's
    time is recorded beside the kernels'."""
    n = cone.n
    C = cone.c_dense
    require(C is not None and cone.c_csr is None,
            f"{tag}: dense objective, no CSR of it")
    g = torch.Generator(device=dev).manual_seed(2028)
    w = torch.randn(cone.m, generator=g, dtype=torch.float64, device=dev)
    for r in ranks:
        Y = torch.randn((n, r), generator=g, dtype=torch.float64, device=dev)
        got = cone.apply_w(w, Y, obj_coef=0.37)
        want = K.spmm_constr_csr_plain(cone.a_csr, w, Y,
                                       Z=0.37 * torch.matmul(C, Y))
        torch.cuda.synchronize()
        rel = rel_err(got, want)
        require(rel <= KERNEL_RTOL, f"{tag} r={r}: dense apply_w differs")
        ms = time_ms(lambda: torch.matmul(C, Y))
        chain = time_ms(lambda: cone.apply_w(w, Y, obj_coef=0.37))
        b_ms, b_by = bound_ms((n * n + 2 * n * r) * 8, 2.0 * n * n * r)
        print(f"[gemm] {tag} C @ Y n={n} r={r} float64 torch.matmul: "
              f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); apply_w chain "
              f"(matmul, scale, K6 with addend) {chain:.4f} ms, max rel err "
              f"{rel:.2e}", flush=True)


def check_dense_cone(K, pcone, dev, ranks, report_rank, tag, relabel=False):
    """Phase 3 for one dense-objective cone of a main path, at that path's
    own shapes and the ranks named: K5 and K6 (``check_general_kernels``),
    the ``apply_w`` chain (``check_dense_objective``) and, where the cone has
    a long segment, K5 with and without the split.  ``relabel`` builds the
    operators as a single-cone solve does.  Returns {name: row} at
    ``report_rank``."""
    from ltr_lowrank_sdp_torch.ops.coneops import ConeOps

    cone = ConeOps(pcone, dev, constr_relabel=relabel)
    require((pcone.kind_a, pcone.kind_c) == ("dense", "dense"),
            f"{tag} is a dense cone")
    print(f"[problem] {tag}: n={pcone.n} m={pcone.m} A upper nnz "
          f"{cone.a_seg.nnz}, full CSR slots {cone.a_csr.nnz}, chunks "
          f"{cone.a_seg.n_chunks}, rank cap {pcone.rank_max}, ranks {ranks}",
          flush=True)
    rows = check_general_kernels(K, cone.a_seg, cone.a_csr, dev, ranks,
                                 report_rank, tag)
    check_dense_objective(K, cone, dev, ranks, tag)
    if cone.a_seg.n_chunks:
        for r in ranks:
            check_long_segments(K, (pcone.a_rows, pcone.a_cols, pcone.a_vals,
                                    pcone.a_cid, pcone.n, pcone.m), dev, r,
                                tag)
    return rows


def check_lp_kernels(K, lp, dev, tag):
    """Phase 3 for K7 and K8 on one LP cone's layouts.  Returns {name: row}:
    K7 in pair mode (the ALM line search, once per inner iteration) and K8
    (the ALM gradient's LP term).  Each yardstick computes the whole
    function that the kernel's row times, around one ``torch.sparse.mm`` on
    the entries as a sparse CSR matrix: for K7 the products u * v (pair: 2 u
    * v and v * v as two columns of one right side) and the product; for K8
    the product with w as one column plus the objective term c0 * c."""
    m, n_cols, nnz = lp.m, lp.n_cols, lp.nnz
    f8, i4 = 8, 4
    g = torch.Generator(device=dev).manual_seed(2029)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)

    u, v, w = rnd(n_cols), rnd(n_cols), rnd(m)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "sparse CSR support is beta"
        a_csr = torch.sparse_csr_tensor(lp.row_ptr, lp.row_col, lp.row_val,
                                        size=(m, n_cols))
        at_csr = torch.sparse_csr_tensor(lp.col_ptr, lp.col_cid, lp.col_val,
                                         size=(n_cols, m))
    w1 = w[:, None].contiguous()
    shape = f"{tag} m={m} cols={n_cols} nnz={nnz}"
    k7_bytes = (m + 1) * i4 + nnz * (i4 + f8) + 2 * n_cols * f8
    rows = {
        "lp_constr_segsum": _measure(
            "lp_constr_segsum", f"pair {shape}",
            lambda: K.lp_constr_segsum(lp, u, v, pair=True),
            lambda: K.lp_constr_segsum_plain(lp, u, v, pair=True),
            k7_bytes + 2 * m * f8, 5.0 * nnz,
            lambda: torch.sparse.mm(
                a_csr, torch.stack((2.0 * u * v, v * v), dim=1)).unbind(1)),
        "lp_col_wsum": _measure(
            "lp_col_wsum", shape,
            lambda: K.lp_col_wsum(lp, w, 0.37),
            lambda: K.lp_col_wsum_plain(lp, w, 0.37),
            (n_cols + 1) * i4 + nnz * (i4 + f8) + m * f8 + 2 * n_cols * f8,
            2.0 * nnz + 2 * n_cols,
            lambda: 0.37 * lp.c + torch.sparse.mm(at_csr, w1).reshape(-1),
            [(lambda: K.lp_col_wsum(lp, w, 0.0),
                    lambda: K.lp_col_wsum_plain(lp, w, 0.0))]),
    }
    _measure(
        "lp_constr_segsum", f"single {shape}",
        lambda: K.lp_constr_segsum(lp, u, v),
        lambda: K.lp_constr_segsum_plain(lp, u, v),
        k7_bytes + m * f8, 3.0 * nnz,
        lambda: torch.sparse.mm(a_csr, (u * v)[:, None]).reshape(-1),
        [(lambda: K.lp_constr_segsum(lp, v, v),
          lambda: K.lp_constr_segsum_plain(lp, v, v))])
    require(torch.equal(K.lp_constr_segsum(lp, u, v),
                        K.lp_constr_segsum(lp, u, v))
            and torch.equal(K.lp_col_wsum(lp, w, 0.37),
                            K.lp_col_wsum(lp, w, 0.37)),
            f"K7/K8 {shape}: two calls gave different bits")
    check_k7_plans(K, lp, u, v, shape)
    return rows


def _tup(out):
    return out if isinstance(out, tuple) else (out,)


def check_k7_plans(K, lp, u, v, tag) -> None:
    """``[k7-plan]``: K7's one plan (a warp a constraint), in pair and
    single mode, against K7's order in plain PyTorch on the card
    (``lp_constr_segsum_order``, the same roundings) bit for bit."""
    for pair in (True, False):
        want = _tup(K.lp_constr_segsum(lp, u, v, pair=pair))
        order = _tup(K.lp_constr_segsum_order(lp, u, v, pair))
        require(all(torch.equal(a, b) for a, b in zip(order, want)),
                f"K7 {tag}: the plain order's bits differ from the kernel's")
        print(f"[k7-plan] {tag} {'pair' if pair else 'single'} (a warp a "
              f"constraint): the plain order's bits", flush=True)


def check_k1_plans(K, csr, dev, tag) -> None:
    """``[k1-plan]``: at each of K1_PLAN_RANKS and in both value types, K1
    with every plan of ``k1_plans`` in its three modes (``alpha C Y``, ``C Y
    + (dv w) o Y`` with the row scale folded in, and the row scale alone),
    each bitwise equal to the planned launch; the folded row scale bitwise
    equal to the launch given ``d = dv * w`` formed first, the planned
    launch within K1_PLAIN_TOL of the plain version.  Every plan's time is
    printed (CUDA events, ``alpha C Y``)."""
    g = torch.Generator(device=dev).manual_seed(1313)
    for dt in (torch.float64, torch.float32):
        c = as_dtype(csr, dt)
        for r in K1_PLAN_RANKS:
            def rnd(*shape):
                return torch.randn(shape, generator=g, dtype=torch.float64,
                                   device=dev).to(dt)

            Y, w = rnd(csr.n, r), rnd(csr.n)
            dv = (torch.rand(csr.n, generator=g, dtype=torch.float64,
                             device=dev) + 0.5).to(dt)
            modes = {"C": (c, Y, 0.37, None, None),
                     "C+fold": (c, Y, 1.0, dv, w),
                     "fold": (None, Y, 0.0, dv, w)}
            want = {m: K.spmm_sym_csr(*a) for m, a in modes.items()}
            require(torch.equal(want["C+fold"],
                                K.spmm_sym_csr(c, Y, 1.0, dv * w))
                    and torch.equal(want["fold"],
                                    K.spmm_sym_csr(None, Y, 0.0, dv * w)),
                    f"K1 {tag} r={r} {dt}: the folded row scale differs "
                    "from d = dv * w formed first")
            for m, args in modes.items():
                err = rel_err(want[m], K.spmm_sym_csr_plain(*args))
                require(err <= K1_PLAIN_TOL[dt],
                        f"K1 {tag} r={r} {dt} {m}: {err:.2e} from plain")
            times = {}
            for plan in K.k1_plans(r, dt):
                for m, args in modes.items():
                    require(torch.equal(K.spmm_sym_csr_with(plan, *args),
                                        want[m]),
                        f"K1 {tag} r={r} {dt} {m}: {plan.describe()} gave "
                        "other bits than the planned launch")
                times[plan.describe()] = time_ms(
                    lambda: K.spmm_sym_csr_with(plan, c, Y, 0.37))
            planned = K.k1_plan(r, dt).describe()
            print(f"[k1-plan] {tag} n={csr.n} nnz={csr.nnz} r={r} "
                  f"{str(dt)[6:]}: {len(times)} plans, every one the planned "
                  f"launch's bits in all three modes (C, C + folded row "
                  f"scale, row scale alone); planned {planned} "
                  f"{times[planned]:.5f} ms; ms by plan "
                  f"{json.dumps({k: round(v, 5) for k, v in times.items()})}",
                  flush=True)


def _nan_equal(a, b) -> bool:
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_k8_plans(K, lp, dev, tag) -> None:
    """``[k8-plan]``: K8 with every block size of ``K8_THREADS``, in
    float64 and float32, bitwise equal to the plain version evaluated on
    the host (its sequential index_add_: the CSC order, each product and
    sum rounded once), also where w holds an infinity and a NaN (a padded
    slot reads constraint 0); every block size timed."""
    g = torch.Generator(device=dev).manual_seed(88)
    host = K.LPEntries(**{f.name: (v.cpu() if torch.is_tensor(v) else v)
                          for f in dataclasses.fields(lp)
                          for v in (getattr(lp, f.name),)})
    for dt in (torch.float64, torch.float32):
        lpd, hd = as_dtype(lp, dt), as_dtype(host, dt)
        w = torch.randn(lp.m, generator=g, dtype=torch.float64,
                        device=dev).to(dt)
        bad = w.clone()
        bad[0], bad[lp.m // 2] = float("inf"), float("nan")
        times = {}
        for ww in (w, bad):
            want = K.lp_col_wsum_plain(hd, ww.cpu(), 0.37)
            for t in K.K8_THREADS:
                got = K.lp_col_wsum_with(t, lpd, ww, 0.37).cpu()
                require(_nan_equal(got, want),
                        f"K8 {tag} {dt} threads={t}: not the plain "
                        "version's bits")
                if ww is w:
                    times[t] = time_ms(
                        lambda: K.lp_col_wsum_with(t, lpd, ww, 0.37))
        planned = K.k8_plan(lp.n_cols)
        print(f"[k8-plan] {tag} cols={lp.n_cols} nnz={lp.nnz} ELL width "
              f"{lp.ell_width}, {lp.n_tail} tail columns, {str(dt)[6:]}: "
              f"every block size the plain version's bits (also with an "
              f"inf and a NaN in w); planned {planned} threads "
              f"{times[planned]:.5f} ms; ms by block size "
              f"{json.dumps({str(k): round(v, 5) for k, v in times.items()})}",
              flush=True)


def long_column_lp(dev):
    """``LPEntries`` of the multi-block + LP cone's size with a 500-entry
    and a 40-entry column added (past the ELL width: the tail list)."""
    import numpy as np

    from ltr_lowrank_sdp_torch.ops import kernels as K
    rng = np.random.default_rng(8)
    col = np.concatenate([np.repeat(np.arange(MB_NLP), 3),
                          np.full(500, 77), np.full(40, 5)])
    cid = rng.integers(0, MB_M, col.size)
    return K.LPEntries.from_coo(rng.uniform(0.5, 1.5, MB_NLP), col, cid,
                                rng.normal(size=col.size), MB_M, MB_NLP, dev)


def check_solve_counts(tag, res, counts) -> None:
    """``[{tag}-counts]``: the float64 CLI solve's ALM, ADMM and CG counts,
    host syncs and final ranks against SOLVE_COUNTS (PERF.md section 5),
    with K1's and K8's launches and the elementwise launches that K1's
    folded row scale saved."""
    got = (res.alm_outer_iters, res.alm_inner_iters, res.admm_iters,
           res.cg_iters, res.host_syncs, list(res.final_ranks))
    print(f"[{tag}-counts] status {res.status.value}; ALM outer, inner, "
          f"ADMM, CG, host syncs, final ranks {got} (PERF.md: "
          f"{SOLVE_COUNTS[tag]}); K1 launches {counts['spmm_sym_csr'][0]}, "
          f"{K1_FOLDS[tag]} of them with the row scale folded in (each saves "
          f"the elementwise launch that formed diag_val * w); K8 launches "
          f"{counts['lp_col_wsum'][0]}; host reads {res.host_syncs}, graph "
          f"replays {res.graph_replays}, graphs (name, nodes, instantiation "
          f"ms) {json.dumps(res.graphs)}", flush=True)
    require(got == SOLVE_COUNTS[tag],
            f"{tag}: counts {got}, PERF.md section 5 has {SOLVE_COUNTS[tag]}")


def check_k10_plans(K, seg, x, score, keep, train, tag) -> str:
    """``[k10-plan]``: K10 with every plan of ``k10_plans`` (rows loaded
    ahead, float4 or scalar loads), each against the planned launch bit for
    bit, each timed.  Returns the planned launch's description."""
    def call(plan):
        return K.graph_pool_with(plan, seg, x, score, keep, train)

    want = call(None)
    plans = K.k10_plans(x.shape[1], x.data_ptr() % 16 == 0)
    times = []
    for plan in plans:
        got = call(plan)
        require(all(a is b is None or torch.equal(a, b)
                    for a, b in zip(got, want)),
                f"K10 {tag} {plan.describe()}: other bits than the planned "
                "launch")
        times.append(f"{plan.describe()} {time_ms(lambda p=plan: call(p)):.5f}"
                     " ms")
    print(f"[k10-plan] {tag}{' train' if train else ''}: every plan gives "
          f"the planned launch's bits; {', '.join(times)}", flush=True)
    return plans[0].describe()


def check_k2_plans(K, U, V, dv, tag) -> str:
    """``[k2-plan]``: K2 with every plan of ``k2_plans`` (G lanes a row),
    each also on a one-block grid, in both modes, against the planned
    launch bit for bit, and the planned launch on its first K2_EMU_ROWS rows
    against ``diag_rowdot_order`` (K2's sum order evaluated on the host);
    every plan timed.  Returns the planned launch's description."""
    r = U.shape[1]
    rows = slice(0, K2_EMU_ROWS)
    host = [t[rows].cpu() for t in (U, V, dv)]
    for s, second in ((2.0, True), (1.0, False)):
        def tup(out):
            return out if second else (out,)

        want = tup(K.diag_rowdot(U, V, dv, s, second=second))
        emu = tup(K.diag_rowdot_order(*host, s, second))
        require(all(torch.equal(a[rows].cpu(), b) for a, b in zip(want, emu)),
                f"K2 {tag} second={second}: not the bits of its order")
        for plan in K.k2_plans(r, U.dtype):
            for grid in (None, 1):
                got = tup(K.diag_rowdot_with(plan, U, V, dv, s, second, grid))
                require(all(torch.equal(a, b) for a, b in zip(got, want)),
                        f"K2 {tag} {plan.describe()} grid={grid}: other "
                        "bits than the planned launch")
    planned = K.k2_plan(r, U.dtype)
    times = {p.describe(): round(time_ms(
        lambda p=p: K.diag_rowdot_with(p, U, V, dv, 2.0, True)), 5)
        for p in K.k2_plans(r, U.dtype)}
    print(f"[k2-plan] {tag} {str(U.dtype)[6:]}: every plan (and a one-block "
          f"grid) the planned launch's bits in both modes, the planned "
          f"launch the host order's on {K2_EMU_ROWS} rows; planned "
          f"{planned.describe()} {times[planned.describe()]:.5f} ms; ms by "
          f"plan {json.dumps(times)}", flush=True)
    return planned.describe()


def check_k3_plans(K, x, F, dv, tag) -> str:
    """``[k3-plan]``: K3 with every plan of ``k2_plans`` (K3 takes K2's lane
    groups), each also on a one-block grid, against the planned launch bit
    for bit, and the planned launch on its first K2_EMU_ROWS rows against
    ``diag_normal_matvec_order`` (the one-warp-a-row kernel's arithmetic
    evaluated on the host); every plan timed.  Returns the planned launch's
    description."""
    r = x.shape[1]
    rows = slice(0, K2_EMU_ROWS)
    want = K.diag_normal_matvec(x, F, dv)
    emu = K.diag_normal_matvec_order(*(t[rows].cpu() for t in (x, F, dv)))
    require(torch.equal(want[rows].cpu(), emu),
            f"K3 {tag}: not the bits of its order")
    for plan in K.k2_plans(r, x.dtype):
        for grid in (None, 1):
            require(torch.equal(
                K.diag_normal_matvec_with(plan, x, F, dv, grid), want),
                f"K3 {tag} {plan.describe()} grid={grid}: other bits than "
                "the planned launch")
    planned = K.k2_plan(r, x.dtype).describe()
    times = {p.describe(): round(time_ms(
        lambda p=p: K.diag_normal_matvec_with(p, x, F, dv)), 5)
        for p in K.k2_plans(r, x.dtype)}
    print(f"[k3-plan] {tag} {str(x.dtype)[6:]}: every plan (and a one-block "
          f"grid) the planned launch's bits, the planned launch the host "
          f"order's on {K2_EMU_ROWS} rows; planned {planned} "
          f"{times[planned]:.5f} ms; ms by plan {json.dumps(times)}",
          flush=True)
    return planned


def check_k12_plans(K, args, tag) -> str:
    """``[k12-plan]``: K12 with every plan of ``k10_plans`` (K12 walks its
    nodes in K10's layout), each against the planned launch bit for bit and
    timed, and one call one device kernel (``[k12-kernels]``: the nodes of
    a CUDA graph captured from one call).  Returns the planned launch's
    description."""
    from ltr_lowrank_sdp_torch.testing import captured_kernel_nodes

    seg, x = args[0], args[1]
    want = K.graph_pool_bwd(*args)
    plans = K.k10_plans(x.shape[1], x.data_ptr() % 16 == 0)
    times = []
    for plan in plans:
        got = K.graph_pool_bwd_with(plan, *args)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K12 {tag} {plan.describe()}: other bits than the planned "
                "launch")
        ms = time_ms(lambda p=plan: K.graph_pool_bwd_with(p, *args))
        times.append(f"{plan.describe()} {ms:.5f} ms")
    nodes = captured_kernel_nodes(lambda: K.graph_pool_bwd(*args))
    print(f"[k12-plan] {tag}: every plan gives the planned launch's bits; "
          f"{', '.join(times)}", flush=True)
    print(f"[k12-kernels] {tag}: {nodes} device kernel(s) in a CUDA graph "
          f"captured from one call", flush=True)
    require(nodes == 1, f"K12 {tag}: {nodes} kernels a call")
    return plans[0].describe()


def _measure_gnn(name, tag, kern, plain, plain64, nbytes, flops, lib=None,
                 lib_check=None):
    """Phases 9 and 12: hold one float32 kernel call against its plain
    version evaluated in float64 on the same inputs (``plain64``) and check
    the same bits on a second call, then time the kernel, the float32 plain
    version and the library yardstick (``lib_check(lib(), plain64())`` holds
    it to the part of the function it computes).  A backward kernel returns
    a tuple: each output is held to GNN_TOL of its largest value, that scale
    floored at 1e-6 of the largest output (an output whose exact value
    vanishes, such as K11's d_w_dst where every slot's message has one sign,
    is rounding).  The float32 plain version's own distance from the float64
    one is printed beside: it sums each segment into one accumulator.
    Returns the kernels-line fields."""
    def tup(out):
        return out if isinstance(out, tuple) else (out,)

    with torch.no_grad():
        out_k, out_p, ref = tup(kern()), tup(plain()), tup(plain64())
        torch.cuda.synchronize()
        keep = [i for i, b in enumerate(ref) if b.numel()]
        floor = 1e-6 * max(float(ref[i].abs().max()) for i in keep)
        scale = {i: max(float(ref[i].abs().max()), floor) for i in keep}

        def errs(out):
            return [float((out[i].double() - ref[i]).abs().max()) / scale[i]
                    for i in keep]

        err, err_plain = errs(out_k), errs(out_p)
        abs_err = max(e * scale[i] for e, i in zip(err, keep))
        require(max(err) <= GNN_TOL,
                f"{name} {tag}: max error {max(err):.3e} of the largest "
                f"value > {GNN_TOL}")
        require(all(torch.equal(a, b) for a, b in zip(tup(kern()), out_k)),
                f"{name} {tag}: two calls gave different bits")
        ms, plain_ms = time_ms(kern), time_ms(plain)
        call_ms = host_call_ms(kern)
        lib_ms = None
        if lib is not None:
            lib_check(lib(), ref[0])
            lib_ms = time_ms(lib)
    b_ms, b_by = bound_ms(nbytes, flops, FP32_FLOP_PER_S)
    lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "none"
    print(f"[kernel] {name} {tag}: max err / max |plain| "
          f"{', '.join(f'{e:.2e}' for e in err)} (tol {GNN_TOL:g}; the "
          f"float32 plain version's {', '.join(f'{e:.2e}' for e in err_plain)}"
          f"), max abs err {abs_err:.2e}, same bits on two calls, kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), library {lib_txt} ms, {nbytes / ms / 1e6:.1f} GB/s; "
          f"host-issued call {call_ms:.4f} ms", flush=True)
    return {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def check_hallar_kernels(K, ops, dev, rank, tag, positive=False):
    """K5 and K6 as HALLaR's ``_Ops`` calls them: [A(YY^T), <C, YY^T>] (K5,
    U is V, on the union layout of A and C, C's entries the segment m) and
    (C + A*(w)) Y (K6 on the one CSR of A and C, weights [w, 1]) at
    ``rank``, and K6 at r = 1 (the Lanczos matvec).  ``positive`` draws Y >=
    0, so that C's sum over a dense C has no cancellation and 1e-12 holds
    the kernel, not the order of a cancelling sum.  Returns {name: row} at
    ``rank``."""
    seg, csr = ops.ac_seg, ops.s_csr
    n, m, nnz, slots = ops.n, ops.m, seg.nnz, csr.nnz
    f8, i4 = 8, 4
    g = torch.Generator(device=dev).manual_seed(2031)
    w = torch.randn(m + 1, generator=g, dtype=torch.float64, device=dev)
    w[m] = 1.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "sparse CSR support is beta"
        s_w = torch.sparse_coo_tensor(
            torch.stack([csr.row_ids, csr.indices.long()]),
            w[csr.cid.long()] * csr.vals,
            size=(n, n)).coalesce().to_sparse_csr()
    report = {}
    for r in (rank, 1):
        Y = torch.randn((n, r), generator=g, dtype=torch.float64, device=dev)
        Y = Y.abs() if positive else Y
        shape = f"{tag} n={n} m={m} r={r}"
        i6 = k56_instance(K, "spmm_constr_csr", r, csr)
        k6 = _measure(
            "spmm_constr_csr", f"A+C {shape} slots={slots} {i6}",
            lambda: K.spmm_constr_csr(csr, w, Y),
            lambda: K.spmm_constr_csr_plain(csr, w, Y),
            (n + 1) * i4 + slots * (2 * i4 + f8) + (m + 1) * f8
            + 2 * n * r * f8, 2.0 * slots * r + slots,
            lambda: torch.sparse.mm(s_w, Y))
        require(torch.equal(K.spmm_constr_csr(csr, w, Y),
                            K.spmm_constr_csr(csr, w, Y)),
                f"K6 {shape}: two calls gave different bits")
        check_k6_warps(K, csr, w, Y, shape, timed=True)
        k6["instance"] = i6
        if r == 1:
            continue        # K5 runs at the factor's rank only
        i5 = k56_instance(K, "coo_contract_segsum", r, seg, mode=1)
        k5 = _measure(
            "coo_contract_segsum", f"U-is-V A+C union {shape} nnz={nnz} "
            f"(C {int(ops.c_rows.numel())}) {i5}",
            lambda: ops.axc(Y),
            lambda: K.coo_contract_segsum_plain(seg, Y, Y),
            (m + 2) * i4 + nnz * (2 * i4 + f8) + (m + 1) * f8 + n * r * f8,
            2.0 * nnz * r, extra=[(lambda: ops.axc(Y), lambda: K.axc_plain(
                ops.a_seg, ops.c_rows, ops.c_cols, ops.c_dbl, Y))])
        require(torch.equal(ops.axc(Y), ops.axc(Y)),
                f"K5 {shape}: two calls gave different bits")
        check_k5_kc(K, seg, Y, Y, shape, timed=True)
        k5["instance"] = i5
        report = {"coo_contract_segsum": k5, "spmm_constr_csr": k6}
    return report


def _gamma(n: int, dt) -> float:
    e = torch.finfo(dt).eps
    return n * e / (1.0 - n * e)


def _fsum(t: torch.Tensor) -> float:
    return math.fsum(t.double().flatten().cpu().tolist())


def _sum_ratio(got, terms, extra=0) -> float:
    """|got - the exact sum of ``terms``| over gamma_{N + extra} sum
    |terms|: within the bound at most 1."""
    bound = _gamma(terms.numel() + extra, terms.dtype) * _fsum(terms.abs())
    return abs(float(got) - _fsum(terms)) / max(bound, 1e-300)


def _elem_ratio(a, b) -> float:
    """max |a - b| over 4 eps max |b|: within the bound at most 1."""
    eps = torch.finfo(b.dtype).eps
    return float((a - b).abs().max()) / max(
        4 * eps * float(b.abs().max()), 1e-300)


def _k5_bounds(K, ops, Y) -> torch.Tensor:
    """K5 on the union layout: each constraint's sum of N_i r terms is
    within gamma sum |terms| of the exact one, so a kernel's and a plain
    version's within twice that of each other: that bound, (m + 1,)
    float64."""
    seg = ops.ac_seg
    aseg = K.SegCOO(n=seg.n, m=seg.m, seg_ptr=seg.seg_ptr, rows=seg.rows,
                    cols=seg.cols, coef=seg.coef.abs())
    mags = K.coo_contract_segsum_plain(aseg, Y.abs(), Y.abs().clone())
    lens = (seg.seg_ptr[1:] - seg.seg_ptr[:-1]).double()
    n = lens * Y.shape[1] + Y.shape[1]
    e = torch.finfo(Y.dtype).eps
    return 2 * (n * e / (1 - n * e)) * mags.double()


def _k5_ratio(got, plain, bound) -> float:
    return float(((got - plain).double().abs() / bound.clamp_min(1e-300))
                 .max())


def _replays_equal(fn, want) -> bool:
    """``fn()`` captured into a CUDA graph (after a warm-up on the capture
    stream) and replayed twice: whether each replay's outputs equal
    ``want`` bit for bit."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same &= all(torch.equal(a, b) for a, b in zip(out, want))
    del graph
    return same


def _k14_ratios(K, out, plain, Z, gz, W):
    """K14's (Yc, Zn, sc) against the plain version's: the elementwise
    ratio to 4 eps and the sums' ratio to gamma_N (at most 1 within)."""
    Yc, Zn, sc = out
    Ycp, Znp, scp = plain
    d = Yc - Z
    terms = [(sc[K.SC_GD], gz * d, 0), (sc[K.SC_DD], d * d, 0),
             (sc[K.SC_DNORM].double() ** 2, d * d, 3),
             (sc[K.SC_YNORM].double() ** 2, Yc * Yc, 3)]
    if W is not None:
        terms += [(sc[K.SC_WY], (Yc - W) ** 2, 0),
                  (sc[K.SC_WZ], (Zn - W) ** 2, 0)]
    require(float(sc[K.SC_TN]) == float(scp[K.SC_TN]),
            "K14: tn differs from the plain version's")
    return (max(_elem_ratio(Yc, Ycp), _elem_ratio(Zn, Znp)),
            max(_sum_ratio(a, t, x) for a, t, x in terms))


def check_hallar_fused(K, H, prob, dev, r, tag, timed=False):
    """``[hallar-fused]``: K14-K16 and K5 on the union layout against their
    plain versions on the card, in float64 and float32, on the AL and the
    prox subproblem, over HALLAR_FUSED_STEPS machine steps of ``prob`` at
    rank ``r``.  At every step both see the plain chain's state: K14's
    planned launch (one cluster up to K14_CLUSTER_MAX_N) and its two-launch
    plan, each sum within gamma_N sum |terms| of the exact sum and each
    elementwise output (Yc, Zn) within 4 eps max |plain|, tn the plain
    bits, a cluster plan the bits of its host order
    (``kernels.fista_candidate_order``); K5 per constraint; K15's pair
    against two ``al_value_plain`` calls, each value within gamma_{m+4}
    and the weights the plain bits; K15's single-point launch at each point
    the same against ``al_value_plain``, its value the bits of its host
    order (``kernels.al_value_order``) and of the pair's; K16's Y, Z, gz
    within 4 eps on the plain chain's inputs and its scalars equal; the
    fused step's grow, commit and done equal the plain step's wherever the
    plain margin exceeds the sums' bounds.  Then K14's two plans, K15's
    pair and its single point replayed from CUDA graphs give their eager
    bits.  ``timed``: K14-K16 timed beside their plain versions (float64,
    the AL subproblem); returns their rows."""
    rows = {}
    for dt in (torch.float64, torch.float32):
        ops = H._Ops(prob, dt, dev)
        n, m = ops.n, ops.m
        eps = torch.finfo(dt).eps
        g = torch.Generator(device=dev).manual_seed(2034)

        def rnd(*shape):
            return torch.randn(*shape, generator=g, dtype=torch.float64,
                               device=dev).to(dt)

        Y0 = ops.project(rnd(n, r))
        p, beta = 0.1 * rnd(m), 12.5
        params = H.HallarParams(maxiter_fista=10 ** 6)
        tol = max(params.err_tol_fista, H.STOP_TOL_EPS * eps)
        plan = K.k14_plan(n * r)
        two = K.K14Plan(0, blocks=K.fused_blocks(n * r))
        worst = dict.fromkeys(("k14 elem", "k14 sums", "k14 two-launch elem",
                               "k14 two-launch sums", "k5", "k15 value",
                               "k15 single value", "k16 elem"), 0.0)
        seen = {"commit": 0, "grow": 0, "done": 0, "near": 0,
                "scalars": 0, "order": 0, "replays": 0, "single": 0}
        for prox in (False, True):
            W = ops.project(rnd(n, r)) if prox else None
            lam = 0.5 if prox else 1.0
            val, val_grad = (H.prox_functions(ops, p, beta, W, lam) if prox
                             else H.al_functions(ops, p, beta))
            st = H.fista_init(Y0, 1.0, val_grad)
            for step in range(HALLAR_FUSED_STEPS):
                args14 = (st.Z, st.gz, st.L, st.Y, st.tk, W, ops.sqrt_tau)
                Yc, Zn, sc = K.fista_candidate(*args14)
                plain14 = K.fista_candidate_plain(*args14)
                Ycp, Znp, scp = plain14
                e, su = _k14_ratios(K, (Yc, Zn, sc), plain14, st.Z, st.gz, W)
                worst["k14 elem"] = max(worst["k14 elem"], e)
                worst["k14 sums"] = max(worst["k14 sums"], su)
                e, su = _k14_ratios(K, K.fista_candidate_with(two, *args14),
                                    plain14, st.Z, st.gz, W)
                worst["k14 two-launch elem"] = max(
                    worst["k14 two-launch elem"], e)
                worst["k14 two-launch sums"] = max(
                    worst["k14 two-launch sums"], su)
                if plan.cluster:
                    host = K.fista_candidate_order(*args14, plan)
                    require(all(torch.equal(a.cpu(), b) for a, b in
                                zip((Yc, Zn, sc), host)),
                            f"K14 {tag}: the cluster plan is not its host "
                            "order's bits")
                    seen["order"] += 1
                ax, axz = ops.axc(Yc), ops.axc(Zn)
                for y, a in ((Yc, ax), (Zn, axz)):
                    worst["k5"] = max(worst["k5"], _k5_ratio(
                        a, K.coo_contract_segsum_plain(ops.ac_seg, y, y),
                        _k5_bounds(K, ops, y)))
                wsq = (sc[K.SC_WY], sc[K.SC_WZ]) if prox else (None, None)
                wk = torch.empty(m + 1, dtype=dt, device=dev)
                wp = torch.empty(m + 1, dtype=dt, device=dev)
                pair = K.al_value_pair(ax, axz, ops.b, p, beta, lam, *wsq, wk)
                pair_p = K.al_value_pair_plain(ax, axz, ops.b, p, beta, lam,
                                               *wsq, wp)
                require(torch.equal(wk, wp), f"K15 {tag}: the weights are "
                        "not the plain version's bits")
                mags = []
                for v, vp, a, w in zip(pair, pair_p, (ax, axz), wsq):
                    res = a[:m] - ops.b
                    mags.append(lam * (abs(float(a[m])) + _fsum(
                        (p * res).abs()) + 0.5 * beta * _fsum(res * res)) + (
                        0.5 * float(w) if prox else 0.0))
                    worst["k15 value"] = max(worst["k15 value"], abs(
                        float(v) - float(vp)) / (_gamma(m + 4, dt)
                                                 * mags[-1]))
                # the single-point launch (fista_init, Subproblem.value and
                # value_grad) at each point, against al_value_plain: the
                # weights its bits, the value its host order's bits, the
                # pair's value and within gamma_{m+4}
                for q, (a, w) in enumerate(zip((ax, axz), wsq)):
                    w1 = torch.empty(m + 1, dtype=dt, device=dev)
                    w1p = torch.empty(m + 1, dtype=dt, device=dev)
                    v1 = K.al_value(a, ops.b, p, beta, lam, w, w1)
                    v1p = K.al_value_plain(a, ops.b, p, beta, lam, w, w1p)
                    require(torch.equal(w1, w1p), f"K15 {tag}: the "
                            "single-point weights are not the plain bits")
                    require(torch.equal(v1.cpu(), K.al_value_order(
                        a, ops.b, p, beta, lam, w)) and torch.equal(
                            v1, pair[q]), f"K15 {tag}: the single-point "
                            "value is not its host order's bits")
                    worst["k15 single value"] = max(
                        worst["k15 single value"], abs(float(v1) - float(
                            v1p)) / (_gamma(m + 4, dt) * mags[q]))
                seen["single"] += 2
                res, mag = ax[:m] - ops.b, mags[0]
                k5b = _k5_bounds(K, ops, Yc)
                if step == 0:
                    # each kernel replayed from a CUDA graph: its eager bits
                    wr = torch.empty(m + 1, dtype=dt, device=dev)
                    require(_replays_equal(
                        lambda: K.fista_candidate(*args14), (Yc, Zn, sc))
                        and _replays_equal(lambda: K.fista_candidate_with(
                            two, *args14), K.fista_candidate_with(
                                two, *args14))
                        and _replays_equal(lambda: K.al_value_pair(
                            ax, axz, ops.b, p, beta, lam, *wsq, wr), pair)
                        and _replays_equal(lambda: (K.al_value(
                            ax, ops.b, p, beta, lam, wsq[0]),), pair[:1]),
                        f"K14 / K15 {tag}: a replay differs from the eager "
                        "call's bits")
                    seen["replays"] += 4
                # the plain chain's step, and the fused one from its state
                stk = H.FistaState(**{f: getattr(st, f).clone()
                                      for f in st.__dataclass_fields__})
                new_p = H._machine_step(st, ops, params, val, val_grad,
                                        plain=True)
                new_k = H._machine_step(stk, ops, params, val, val_grad)
                # K16 alone on the plain chain's inputs
                wq = torch.empty(m + 1, dtype=dt, device=dev)
                fy_p, fzn_p = K.al_value_pair_plain(
                    K.axc_plain(ops.a_seg, ops.c_rows, ops.c_cols, ops.c_dbl,
                                Ycp),
                    K.axc_plain(ops.a_seg, ops.c_rows, ops.c_cols, ops.c_dbl,
                                Znp), ops.b, p, beta, lam,
                    scp[K.SC_WY] if prox else None,
                    scp[K.SC_WZ] if prox else None, wq)
                S = K.spmm_constr_csr_plain(ops.s_csr, wq, Znp)
                args = (Ycp, Znp, scp, fy_p, fzn_p, S, W, lam,
                        params.maxiter_fista, params.L_inc_fista,
                        params.L0_fista, tol)
                one = [getattr(st, f).clone() for f in
                       ("Y", "Z", "gz", "tk", "L", "k", "done", "fz")]
                want = K.fista_commit_plain(*one, *args)
                got = K.fista_commit(*[t.clone() for t in one], *args)
                worst["k16 elem"] = max(worst["k16 elem"], *(
                    _elem_ratio(a, b) for a, b in zip(got[:3], want[:3])))
                require(all(torch.equal(a, b)
                            for a, b in zip(got[3:], want[3:])),
                        f"K16 {tag}: a scalar differs from the plain "
                        "version's")
                seen["scalars"] += 1
                # the decisions of the two chains
                L0v, k0 = float(st.L), int(st.k)
                ub = float(st.fz + scp[K.SC_GD] + 0.5 * st.L * scp[K.SC_DD])
                margin = abs(float(fy_p) - (ub + 1e-12))
                gd_t, dd_t = st.gz * (Ycp - st.Z), (Ycp - st.Z) ** 2
                nn = Yc.numel()
                ax_err = float(((p.double().abs()
                                 + beta * res.double().abs())
                                * k5b[:m]).sum() + k5b[m])
                bound = 2 * (_gamma(m + 4, dt) * mag + lam * ax_err
                             + _gamma(nn, dt) * (_fsum(gd_t.abs())
                                                 + 0.5 * L0v
                                                 * _fsum(dd_t)))
                dec_p = (int(new_p.k) - k0, float(new_p.L) != L0v
                         and int(new_p.k) == k0, bool(new_p.done))
                dec_k = (int(new_k.k) - k0, float(new_k.L) != L0v
                         and int(new_k.k) == k0, bool(new_k.done))
                if margin > bound:
                    crit = L0v * float(scp[K.SC_DNORM])
                    tol_r = tol * (1 + float(scp[K.SC_YNORM]))
                    dbound = 2 * _gamma(nn + 3, dt) * (crit + tol_r)
                    if dec_p[0] == 0 or abs(crit - tol_r) > dbound:
                        require(dec_k == dec_p,
                                f"hallar fused {tag}: the fused step's "
                                f"decisions {dec_k} are not the plain "
                                f"step's {dec_p}")
                    else:
                        seen["near"] += 1
                else:
                    seen["near"] += 1
                seen["commit"] += dec_p[0]
                seen["grow"] += int(dec_p[1])
                seen["done"] += int(dec_p[2])
                st = new_p
        name = "float64" if dt == torch.float64 else "float32"
        print(f"[hallar-fused] {tag} r={r} {name}: over "
              f"{2 * HALLAR_FUSED_STEPS} machine steps (AL and prox), K14 "
              f"planned {plan.describe()}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
              + " of their bounds (at most 1); the cluster plan its host "
              f"order's bits in {seen['order']} steps; K15's weights the "
              f"plain bits and K16's scalars equal the plain version's in "
              f"{seen['scalars']} steps; {seen['single']} single-point K15 "
              f"launches the plain weights' bits, their host order's and "
              f"the pair's values; {seen['replays']} kernels replayed "
              f"from CUDA graphs with their eager bits; plain decisions "
              f"{seen['commit']} commits, {seen['grow']} grows, "
              f"{seen['done']} done, equal in the fused step wherever the "
              f"margin exceeds the bound ({seen['near']} within it)",
              flush=True)
        require(all(v <= 1.0 for v in worst.values()),
                f"hallar fused {tag} {name}: a kernel is outside its bound "
                f"({worst})")
        if timed and dt == torch.float64:
            rows = _time_fused(K, H, ops, dev, r, tag)
        del ops
    return rows


def check_k14_above(K, dev, shape, tag):
    """``[hallar-fused]`` past K14_CLUSTER_MAX_N: the planned two-launch
    plan against the plain version at (n, r) = ``shape``, float64 and
    float32, AL and prox, and replayed from a CUDA graph."""
    n, r = shape
    plan = K.k14_plan(n * r)
    require(plan.cluster == 0, f"K14 {tag}: N = {n * r} is not past the "
            "cluster plan's threshold")
    worst = [0.0, 0.0]
    g = torch.Generator(device=dev).manual_seed(2036)
    for dt in (torch.float64, torch.float32):
        Z, gz, Y, W = (torch.randn((n, r), generator=g, dtype=torch.float64,
                                   device=dev).to(dt) for _ in range(4))
        L = torch.tensor(3.5, dtype=dt, device=dev)
        tk = torch.tensor(1.75, dtype=dt, device=dev)
        for w in (None, W):
            args = (Z, gz, L, Y, tk, w, 0.5 * math.sqrt(n * r))
            out = K.fista_candidate(*args)
            ratios = _k14_ratios(K, out, K.fista_candidate_plain(*args), Z,
                                 gz, w)
            worst = [max(a, b) for a, b in zip(worst, ratios)]
            require(_replays_equal(lambda: K.fista_candidate(*args), out),
                    f"K14 {tag}: a replay differs from the eager call")
    print(f"[hallar-fused] K14 {tag} N={n * r} (n={n}, r={r}) planned "
          f"{plan.describe()}, float64 and float32, AL and prox: elem "
          f"{worst[0]:.3f}, sums {worst[1]:.3f} of their bounds (at most 1); "
          f"replayed with its eager bits", flush=True)
    require(max(worst) <= 1.0, f"K14 {tag}: outside its bound")


def _time_fused(K, H, ops, dev, r, tag):
    """K14-K16 timed beside their plain versions at rank r (float64, the AL
    subproblem, a commit every call; K15 as the machine step calls it, the
    pair, and beside it two single-point launches); rows of the kernels
    line."""
    n, m = ops.n, ops.m
    N = n * r
    f8 = 8
    g = torch.Generator(device=dev).manual_seed(2035)
    Z, gz, Y = (torch.randn((n, r), generator=g, dtype=torch.float64,
                            device=dev) for _ in range(3))
    L = torch.tensor(3.5, dtype=torch.float64, device=dev)
    tk = torch.tensor(1.75, dtype=torch.float64, device=dev)
    Yc, Zn, sc = K.fista_candidate(Z, gz, L, Y, tk, None, ops.sqrt_tau)
    ax, axz = ops.axc(Yc), ops.axc(Zn)
    p = torch.randn(m, generator=g, dtype=torch.float64, device=dev)
    w = torch.empty(m + 1, dtype=torch.float64, device=dev)
    S = K.spmm_constr_csr(ops.s_csr, ops.wbuf, Zn)
    fy = torch.tensor(-1e300, dtype=torch.float64, device=dev)
    state = [Y.clone(), Z.clone(), gz.clone(), tk.clone(), L.clone(),
             torch.zeros((), dtype=torch.int64, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.float64, device=dev)]
    args = (Yc, Zn, sc, fy, fy, S, None, 1.0, 10 ** 12, 2.0, 1.0, 1e-8)
    calls = {
        "fista_candidate": (
            lambda: K.fista_candidate(Z, gz, L, Y, tk, None, ops.sqrt_tau),
            lambda: K.fista_candidate_plain(Z, gz, L, Y, tk, None,
                                            ops.sqrt_tau),
            5 * N * f8 + 9 * f8, 16.0 * N),
        "al_value": (
            lambda: K.al_value_pair(ax, axz, ops.b, p, 12.5, 1.0, None, None,
                                    w),
            lambda: K.al_value_pair_plain(ax, axz, ops.b, p, 12.5, 1.0, None,
                                          None, w),
            (5 * m + 5) * f8, 12.0 * m),
        "fista_commit": (
            lambda: K.fista_commit(*state, *args),
            lambda: K.fista_commit_plain(*state, *args),
            6 * N * f8 + 16 * f8, 1.0 * N)}
    rows = {}
    for name, (kern, plain, nbytes, flops) in calls.items():
        ms, plain_ms = time_ms(kern), time_ms(plain)
        b_ms, b_by = bound_ms(nbytes, flops)
        print(f"[kernel] {name} {tag} n={n} m={m} r={r} float64: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), library none (no single call), "
              f"{nbytes / ms / 1e6:.1f} GB/s; host-issued call "
              f"{host_call_ms(kern):.4f} ms", flush=True)
        err = 0.0
        if name == "fista_candidate":
            err = max(float((a - b).abs().max()) for a, b in zip(
                kern(), plain()))
        elif name == "al_value":
            err = max(abs(float(a) - float(b))
                      for a, b in zip(kern(), plain()))
            singles = time_ms(lambda: (
                K.al_value(ax, ops.b, p, 12.5, 1.0),
                K.al_value(axz, ops.b, p, 12.5, 1.0, None, w)))
            print(f"[kernel] al_value pair {tag} m={m} float64: one launch "
                  f"for both points {ms:.4f} ms beside two single-point "
                  f"launches {singles:.4f} ms (a step's two calls before the "
                  "pair)",
                  flush=True)
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None}
    # K16's error: one call on copies, against its plain version
    st2 = [t.clone() for t in state]
    want = K.fista_commit_plain(*st2, *args)
    got = K.fista_commit(*[t.clone() for t in st2], *args)
    rows["fista_commit"]["max_abs_err"] = max(
        float((a.double() - b.double()).abs().max())
        for a, b in zip(got, want))
    return rows


def time_machine_step(H, ops, dev, r, tau, chunks=4):
    """The inner loop's machine step at rank ``r`` on the path's layouts,
    the plain one (the plain versions of K14-K16, K5 and K6 composed in
    torch) and the fused one, each issued eagerly and replayed as a
    captured CUDA graph (what ``run_fista`` does after its first chunk):
    host clock over ``chunks`` chunks of ``H.FISTA_CHUNK`` steps,
    synchronized; and the graph nodes of one step
    (``testing.captured_node_kinds``)."""
    from ltr_lowrank_sdp_torch.testing import captured_node_kinds

    params = H.HallarParams(maxiter_fista=10 ** 9)
    val, val_grad = H.al_functions(
        ops, torch.zeros(ops.m, dtype=torch.float64, device=dev), 10.0)
    g = torch.Generator(device=dev).manual_seed(2032)
    Y0 = ops.project(tau * torch.randn((ops.n, r), generator=g,
                                       dtype=torch.float64, device=dev))
    out = {}
    for label, plain in (("plain", True), ("fused", False)):
        def run_chunk(st, plain=plain):
            for _ in range(H.FISTA_CHUNK):
                st = H._machine_step(st, ops, params, val, val_grad,
                                     plain=plain)
            return st

        stream = torch.cuda.Stream(dev)  # as run_fista: eager on a side one
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            st = run_chunk(H.fista_init(Y0, 1.0, val_grad))     # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(chunks):
                st = run_chunk(st)
            torch.cuda.synchronize()
        eager = (time.perf_counter() - t) / (chunks * H.FISTA_CHUNK) * 1e3
        graph, st, _ = H._capture_chunk(st, run_chunk, stream)
        graph.replay()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(chunks):
            graph.replay()
        torch.cuda.synchronize()
        replayed = (time.perf_counter() - t) / (chunks * H.FISTA_CHUNK) * 1e3
        del graph
        one = H.FistaState(**{f: getattr(st, f).clone()
                              for f in st.__dataclass_fields__})
        kinds = captured_node_kinds(lambda: H._machine_step(
            one, ops, params, val, val_grad, plain=plain))
        out[label] = (eager, replayed, len(kinds))
        print(f"[hallar] {label} machine step at r={r}: eager {eager:.4f} "
              f"ms, replayed as a CUDA graph {replayed:.4f} ms "
              f"({eager / replayed:.2f}x); {len(kinds)} graph nodes a step "
              f"({kinds.count(0)} kernels)", flush=True)
    print(f"[hallar] machine step replayed: fused {out['fused'][1]:.4f} ms "
          f"against plain {out['plain'][1]:.4f} ms "
          f"({out['plain'][1] / out['fused'][1]:.2f}x), graph nodes a step "
          f"{out['fused'][2]} against {out['plain'][2]}", flush=True)
    require(out["fused"][2] == HALLAR_STEP_NODES,
            f"the fused machine step has {out['fused'][2]} graph nodes, not "
            f"{HALLAR_STEP_NODES}")
    return out


def graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Mean device time of one call replayed from a CUDA graph: ``reps``
    calls captured once (after a warm-up on the capture stream), the graph
    replayed ``replays`` times behind a sleep kernel between CUDA events:
    a call's cost inside the solver's replayed chunks, the gaps between
    graph nodes included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def run_k14_plan(K, dev):
    """``[k14-plan]``: K14's plans (float64, the AL subproblem) at N = n r
    of K14_PLAN_SHAPES and at the threshold K14_CLUSTER_MAX_N: the cluster
    plan and the two-launch plan, each against the plain version, eager
    (``time_ms``) and replayed (``graph_ms``)."""
    g = torch.Generator(device=dev).manual_seed(2037)
    for n, rr in (*K14_PLAN_SHAPES, (K.K14_CLUSTER_MAX_N // 8, 8)):
        N = n * rr
        Z, gz, Y = (torch.randn((n, rr), generator=g, dtype=torch.float64,
                                device=dev) for _ in range(3))
        L = torch.tensor(3.5, dtype=torch.float64, device=dev)
        tk = torch.tensor(1.75, dtype=torch.float64, device=dev)
        args = (Z, gz, L, Y, tk, None, 0.5 * math.sqrt(N))
        plain = K.fista_candidate_plain(*args)
        planned = K.k14_plan(N)
        for plan in (K.k14_cluster_plan(N),
                     K.K14Plan(0, blocks=K.fused_blocks(N))):
            def fn(plan=plan):
                return K.fista_candidate_with(plan, *args)

            e, su = _k14_ratios(K, fn(), plain, Z, gz, None)
            require(max(e, su) <= 1.0, f"[k14-plan] N={N} "
                    f"{plan.describe()}: outside its bound")
            mark = " (planned)" if plan == planned else ""
            print(f"[k14-plan] N={N} (n={n}, r={rr}) float64 AL "
                  f"{plan.describe()}{mark}: eager {time_ms(fn):.5f} ms, "
                  f"replayed {graph_ms(fn):.5f} ms; elem {e:.3f}, sums "
                  f"{su:.3f} of their bounds", flush=True)


def run_hallar_aipp(H, dev) -> None:
    """The c5 maximum stable set through ADAP-AIPP (``inner_solver="aipp"``,
    ``maxiter_fista`` 300) on the card against the CPU: both converge, pobj
    within HALLAR_AIPP_POBJ_RTOL; the counts side by side."""
    params = H.HallarParams(inner_solver="aipp", maxiter_fista=300)
    prob = H.build_mss_problem([(0, 1), (1, 2), (2, 3), (3, 4), (4, 0)], 5)
    res = {side: H.hallar_solve(prob, params, device=where)
           for side, where in (("gpu", dev), ("cpu", "cpu"))}
    for side, r in res.items():
        print(f"[hallar-c5-aipp] {side} converged {r.converged} pobj "
              f"{r.pobj:.12e} gap {r.rel_gap:.2e} iters {r.iters} rank "
              f"{r.final_rank} fista steps {r.fista_steps} host reads "
              f"{r.host_reads} graph replays {r.graph_replays} "
              f"{r.solve_time:.2f} s", flush=True)
    diff = abs(res["gpu"].pobj - res["cpu"].pobj) / abs(res["cpu"].pobj)
    print(f"[hallar-c5-aipp] |pobj gpu - pobj cpu| / |pobj| {diff:.3e} "
          f"(tol {HALLAR_AIPP_POBJ_RTOL:g})", flush=True)
    require(res["gpu"].converged and res["cpu"].converged
            and diff <= HALLAR_AIPP_POBJ_RTOL,
            "hallar c5 aipp: GPU and CPU part")


def hallar_min_eig_problem():
    """The reference's trace-bound min-eig case (``tests/test_hallar.py``):
    min <C, X> over tr X <= 1, X >= 0, one all-zero constraint."""
    import numpy as np

    from ltr_lowrank_sdp_torch.hallar.solver import SpectraplexProblem

    rng = np.random.default_rng(0)
    C = rng.normal(size=(12, 12))
    C = (C + C.T) / 2
    iu = np.triu_indices(12)
    return SpectraplexProblem(
        n=12, m=1, b=np.zeros(1), tau=1.0,
        c_rows=iu[0].astype(np.int32), c_cols=iu[1].astype(np.int32),
        c_vals=C[iu], a_rows=np.zeros(1, np.int32),
        a_cols=np.zeros(1, np.int32), a_vals=np.zeros(1),
        a_cid=np.zeros(1, np.int32))


def check_hallar_f32(H, dev) -> None:
    """HALLaR's float32 min-eig case on the card beside the CPU: <C, YY^T>
    sums in float32 (K5's segment m of the union layout on the card, K4's
    plain float32 sum on the CPU), as the reference's ``jnp.sum`` does.  The inner loop's
    stop step follows float32 rounding (its tolerance floored at
    ``STOP_TOL_EPS`` epsilons, ``hallar/solver.py``) and differs between
    the two: both are printed; both must stop before the cap and converge
    to pobj within HALLAR_F32_POBJ_RTOL of each other."""
    params = H.HallarParams(eps_gap=1e-4, maxiter_hallar=200,
                            lanczos_iters=24, dtype="float32")
    res = {}
    for side, where in (("gpu", dev), ("cpu", "cpu")):
        r = res[side] = H.hallar_solve(hallar_min_eig_problem(), params,
                                       device=where)
        print(f"[hallar-min-eig-f32] {side} converged {r.converged} pobj "
              f"{r.pobj:.9e} iters {r.iters} fista steps {r.fista_steps} "
              f"(cap {params.maxiter_fista} an inner solve; stopped before "
              f"it: {r.fista_steps < params.maxiter_fista * r.iters}) "
              f"{r.solve_time:.2f} s", flush=True)
    diff = abs(res["gpu"].pobj - res["cpu"].pobj) / abs(res["cpu"].pobj)
    print(f"[hallar-min-eig-f32] |pobj gpu - pobj cpu| / |pobj| {diff:.3e} "
          f"(tol {HALLAR_F32_POBJ_RTOL:g})", flush=True)
    require(res["gpu"].converged and res["cpu"].converged
            and diff <= HALLAR_F32_POBJ_RTOL,
            "hallar min-eig float32: GPU and CPU part")
    require(all(r.fista_steps < params.maxiter_fista * r.iters
                for r in res.values()),
            "hallar min-eig float32: an inner solve ran to its cap")


def check_k4_acc32(K, ops, dev, r, tag) -> None:
    """K4's float32-summing instance (HALLaR's float32 ``CX`` until its
    fused step; on no path since) on ``ops``'s C at rank r: against the float64 sum of the same float32 terms, to
    K4_ACC32_TOL of the sum of their magnitudes, the same bits on two
    calls and as its plain version on the CPU (which follows the kernel's
    order), and timed beside its plain version."""
    g = torch.Generator(device=dev).manual_seed(2032)
    Y = torch.randn((ops.n, r), generator=g, device=dev)
    rows, cols, coef = ops.c_rows, ops.c_cols, ops.c_dbl.float()

    def kern():
        return K.sym_contract_sum(rows, cols, coef, Y, Y, acc32=True)

    def plain():
        return K.sym_contract_sum_plain(rows, cols, coef, Y, Y, acc32=True)

    got = kern()
    want = K.sym_contract_sum_plain(rows, cols, coef, Y, Y)
    terms = float(torch.sum(torch.abs(coef.double() * torch.sum(
        Y.double()[rows.long()] * Y.double()[cols.long()], dim=1))))
    err = abs(float(got) - float(want)) / terms
    Yc = Y.cpu()
    cpu = K.sym_contract_sum_plain(rows.cpu(), cols.cpu(), coef.cpu(), Yc,
                                   Yc, acc32=True)
    require(got.dtype == torch.float32 and err <= K4_ACC32_TOL
            and torch.equal(kern(), got) and torch.equal(got.cpu(), cpu),
            f"K4 acc32 {tag}: error {err:.2e}, or other bits on a second "
            "call or than the CPU's plain version")
    nnz = int(rows.numel())
    b_ms, b_by = bound_ms(nnz * 12 + ops.n * r * 4 + 4,
                          (2.0 * r + 1) * nnz, FP32_FLOP_PER_S)
    print(f"[kernel-f32] sym_contract_sum acc32 {tag} C nnz={nnz} r={r}: "
          f"|kernel - float64 sum| / sum |terms| {err:.2e} (tol "
          f"{K4_ACC32_TOL:g}), same bits on two calls and as the CPU's "
          f"plain version, kernel "
          f"{time_ms(kern):.4f} ms, plain {time_ms(plain):.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)


def run_hallar_path(K, dev, tmp):
    """Phase 13, the HALLaR path.  Returns (its counts, its JSON result,
    its rows of the kernels line)."""
    import numpy as np

    from ltr_lowrank_sdp_torch import cli as lorads_cli
    from ltr_lowrank_sdp_torch.hallar import cli as hcli
    from ltr_lowrank_sdp_torch.hallar import solver as H
    from ltr_lowrank_sdp_torch.problem import canonicalize, load_problem
    from ltr_lowrank_sdp_torch.testing import (matcomp_nuclear_norm,
                                               matcomp_sdpa, write_sdpa)

    t13 = time.perf_counter()
    # GPU against CPU at a reduced maxiter_fista: the min-eig case (no
    # constraint to drift along) to 1e-9; a 40 x 40 matrix completion,
    # whose pobj is fixed only to its primal infeasibility (about 1e-8), to
    # 1e-8
    for tag, prob, params, tol in (
            ("min-eig", hallar_min_eig_problem(), H.HallarParams(
                eps_gap=1e-4, maxiter_hallar=200, lanczos_iters=24,
                maxiter_fista=1000), 1e-9),
            ("matcomp40", H.SpectraplexProblem.from_sdp_problem(
                canonicalize(matcomp_sdpa(40, 40, 3, 3.0, 0)),
                3 * matcomp_nuclear_norm(40, 40, 3, 0)),
             H.HallarParams(maxiter_fista=300), 1e-8)):
        r_gpu = H.hallar_solve(prob, params, device=dev)
        r_cpu = H.hallar_solve(prob, params, device="cpu")
        for side, r in (("gpu", r_gpu), ("cpu", r_cpu)):
            print(f"[hallar-{tag}] {side} converged {r.converged} pobj "
                  f"{r.pobj:.12e} gap {r.rel_gap:.2e} iters {r.iters} rank "
                  f"{r.final_rank} fista steps {r.fista_steps} host reads "
                  f"{r.host_reads} graph replays {r.graph_replays} "
                  f"{r.solve_time:.2f} s", flush=True)
        diff = abs(r_gpu.pobj - r_cpu.pobj) / abs(r_cpu.pobj)
        print(f"[hallar-{tag}] |pobj gpu - pobj cpu| / |pobj| {diff:.3e} "
              f"(tol {tol:g})", flush=True)
        require(r_gpu.converged and r_cpu.converged
                and (r_gpu.iters, r_gpu.final_rank, r_gpu.fista_steps)
                == (r_cpu.iters, r_cpu.final_rank, r_cpu.fista_steps),
                f"hallar {tag}: GPU and CPU part")
        require(diff <= tol, f"hallar {tag}: GPU and CPU pobj differ")
    check_hallar_f32(H, dev)
    run_hallar_aipp(H, dev)

    # the maximum stable set cone at n = 1,024: C = -ee^T stored as its
    # n(n+1)/2 upper entries, as the reference does
    n_mss, deg, seed = HALLAR_MSS
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n_mss, size=(n_mss * deg // 2, 2))
    e = np.unique(np.sort(e[e[:, 0] != e[:, 1]], axis=1), axis=0)
    mss_prob = H.build_mss_problem([tuple(x) for x in e.tolist()], n_mss)
    mss = H._Ops(mss_prob, torch.float64, dev)
    check_hallar_kernels(K, mss, dev, 8, f"mss{n_mss}", positive=True)
    del mss
    check_hallar_fused(K, H, mss_prob, dev, 8, f"mss{n_mss}")

    # the path: the .dat-s file, the LoRADS path's solve of it, then HALLaR
    path = os.path.join(tmp, "hallar_mc3000.dat-s")
    write_sdpa(path, matcomp_sdpa(*HALLAR_MC))
    tau = 3.0 * matcomp_nuclear_norm(*HALLAR_MC[:3], HALLAR_MC[4])
    print(f"[hallar] matcomp_sdpa{HALLAR_MC}: 3 ||M||_* = {tau!r}",
          flush=True)
    t = time.perf_counter()
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        lorads = lorads_cli.main([path, "--heuristicFactor", "10"])
    print(f"[hallar] LoRADS path (--heuristicFactor 10): "
          f"{lorads.status.value} pobj {lorads.pobj:.12e}, "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    require(lorads.status.value in ("primal_dual_optimal", "primal_optimal"),
            "hallar: the LoRADS path's solve did not certify")
    cfg = os.path.join(tmp, "hallar.cfg")
    with open(cfg, "w") as fh:
        fh.write(f"time_limit = {HALLAR_LIMIT_S}\n")
    out = os.path.join(tmp, "hallar.json")
    K.reset_counts()
    t = time.perf_counter()
    hcli.main(["-i", path, "--trace_bound", repr(tau), "-c", cfg,
               "-o", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {**K.counts(), **K.loop_counts()}
    with open(out) as fh:
        res = json.load(fh)
    print(f"[hallar] counts {json.dumps(counts)}")
    print(f"[hallar] cli wall {wall:.3f} s, solve {res['solve_time']:.3f} s, "
          f"outer iterations {res['iters']}, final rank "
          f"{res['final_rank']}, FISTA steps {res['fista_steps']} "
          f"({res['solve_time'] / max(res['fista_steps'], 1) * 1e3:.4f} ms "
          f"each), host reads {res['host_reads']}, graph replays "
          f"{res['graph_replays']}, launches inside them "
          f"{json.dumps(res['graph_runs'])}", flush=True)
    # one eager chunk an inner solve, the rest replays, FISTA_CHUNK steps each
    machine = (res["iters"] + res["graph_replays"]) * H.FISTA_CHUNK
    print(f"[hallar] machine steps {machine} ({res['iters']} eager chunks + "
          f"{res['graph_replays']} replays of {H.FISTA_CHUNK}): "
          f"{res['solve_time'] / machine * 1e3:.4f} ms a machine step over "
          f"the solve; {res['fista_steps'] / machine:.3f} committed steps a "
          f"machine step", flush=True)
    rel = abs(res["pobj"] - lorads.pobj) / abs(lorads.pobj)
    print(f"[hallar] converged {res['converged']} pobj {res['pobj']:.12e} "
          f"dval {res['dval']:.12e} pinf {res['pinf']:.3e} gap "
          f"{res['rel_gap']:.3e}; pobj against the LoRADS path "
          f"{rel:.3e} relative (tol {HALLAR_POBJ_RTOL:g})", flush=True)
    require(res["converged"] and res["pinf"] <= 1e-5
            and res["rel_gap"] <= 1e-5, "hallar: not converged to 1e-5")
    require(rel <= HALLAR_POBJ_RTOL,
            "hallar: pobj differs from the LoRADS path's")
    require((res["iters"], res["final_rank"], res["fista_steps"])
            == HALLAR_COUNTS, f"hallar: outer iterations, final rank and "
            f"committed steps are not {HALLAR_COUNTS}")
    for name, (launches, plain_calls) in counts.items():
        if name in HALLAR_KERNELS:
            require(launches > 0, f"{name} was not launched on the hallar "
                    "path")
        else:
            require(launches == 0, f"{name} ran on the hallar path")
        require(plain_calls == 0,
                f"{name}'s plain version ran on the hallar path")

    # the kernels at the path's layouts and final rank, then one outer
    # iteration at a reduced maxiter_fista under the profiler (a full one
    # runs some 1.6 million device kernels)
    prob = H.SpectraplexProblem.from_sdp_problem(load_problem(path), tau)
    t = time.perf_counter()
    ops = H._Ops(prob, torch.float64, dev)
    print(f"[hallar] layouts built in {time.perf_counter() - t:.3f} s: "
          f"A nnz {ops.a_seg.nnz}, A+C slots {ops.s_csr.nnz}, C nnz "
          f"{ops.c_rows.numel()}", flush=True)
    rows = check_hallar_kernels(K, ops, dev, res["final_rank"],
                                "hallar mc3000")
    check_k4_acc32(K, ops, dev, res["final_rank"], "hallar mc3000")
    time_machine_step(H, ops, dev, res["final_rank"], tau)
    run_k14_plan(K, dev)
    del ops
    rows.update(check_hallar_fused(K, H, prob, dev, res["final_rank"],
                                   "hallar mc3000", timed=True))
    for r in HALLAR_FUSED_RANKS:
        check_hallar_fused(K, H, prob, dev, r, "hallar mc3000")
    check_k14_above(K, dev, HALLAR_K14_ABOVE, "past the threshold")
    profile_call(lambda: H.hallar_solve(prob, H.HallarParams(
        maxiter_hallar=1, maxiter_fista=HALLAR_PROFILE_FISTA), device=dev),
        "hallar-profile", f"one outer iteration at maxiter_fista="
        f"{HALLAR_PROFILE_FISTA} (layouts built inside)")
    print(f"[time] phase 13 (hallar) {time.perf_counter() - t13:.1f} s",
          flush=True)
    return counts, res, rows


def gnn_inputs(model, graph, dev):
    """What K9 gets in the first GATv2 layer and K10 after the last, for one
    graph dict on the card: ``((csr, w_src, w_dst, we, we_loop, att), (seg,
    x, score))``."""
    import torch.nn.functional as F

    from ltr_lowrank_sdp_torch.models.checkpoint import graph_tensors
    from ltr_lowrank_sdp_torch.ops import kernels as K

    enc = model.encoder
    x, ei, ea, batch, _, _ = graph_tensors(graph, dev)
    csr = K.EdgeCSR.from_edge_index(ei, x.shape[0])
    seg = K.GraphSegments.from_batch(batch, 1)
    with torch.no_grad():
        h = enc.node_encoder(x)
        e = enc.edge_encoder(ea)
        conv = enc.convs[0]
        layer1 = (csr, conv.lin_src(h), conv.lin_dst(h), conv.lin_edge(e),
                  conv.lin_edge(torch.mean(e, dim=0)), conv.att[0])
        for conv, norm in zip(enc.convs, enc.norms):
            h = F.leaky_relu(norm(conv(h, csr, e)), 0.2) + h
        pool = (seg, h, enc.attn_pool.score(h))
    return layer1, pool


def k9_plan_text(K, att) -> str:
    heads, ch = att.shape
    return f"[{K.k9_plan(heads, ch).describe()}]"


def k11_plan_text(K, heads, ch) -> str:
    """K11's calls for heads x ch: each head group's plan."""
    return "[" + "; ".join(
        f"heads {h0}+{hg}: {K.k11_plan(hg, ch).describe()}"
        for h0, hg in K.k11_groups(heads, ch)) + "]"


def check_k9_plans(K, g, args, keep, tag) -> None:
    """``[k9-plan]``: every launch plan of K9's shape (one tile a batch,
    fewer sub-warps, scalar loads; ``k9_plans``) gives the planned launch's
    bits, out and (with ``keep``, the training instance) lse and the scores,
    on two calls each; each one's time beside, the evidence for
    ``k9_plan``'s choice."""
    heads, ch = args[-1].shape
    train = keep is not None

    def launch(plan):
        sc = torch.empty((g.n_slots, heads), device=args[0].device) \
            if train else None
        out, lse = K.gatv2_softmax_agg_with(plan, g, *args, keep=keep,
                                            with_lse=train, scores=sc)
        return out, lse, sc

    want = launch(None)
    parts = []
    for plan in K.k9_plans(heads, ch):
        def call(plan=plan):
            return launch(plan)

        for _ in range(2):
            got = call()
            require(all(torch.equal(a, b) for a, b in zip(got, want)
                        if a is not None),
                f"K9 {tag} {plan.describe()}: other bits than the planned "
                "launch's")
        parts.append(f"{plan.describe()} {time_ms(call):.4f} ms")
    print(f"[k9-plan] {tag}{' train' if train else ''}: every plan gives the "
          f"planned launch's bits on two calls; {'; '.join(parts)}",
          flush=True)


def check_gatv2(K, args, tag):
    """Phase 9 for K9 at one graph's first-layer shapes."""
    g, w_src, w_dst, we, we_loop, att = args
    hc, e_all = w_src.shape[1], g.n_real + g.n
    f4, i4 = 4, 4
    # every input read once (the gathered w_src rows at most once each, the
    # edge terms once), the output written once; about 8 operations per
    # edge and channel (3 adds, the LeakyReLU, the att product, the
    # rescaled accumulation)
    nbytes = ((g.n + 1) * i4 + 2 * e_all * i4 + 3 * g.n * hc * f4
              + g.n_real * hc * f4 + hc * f4 + att.numel() * f4)
    row = _measure_gnn(
        "gatv2_softmax_agg", f"{tag} N={g.n} E'={e_all} heads x ch="
        f"{att.shape[0]}x{att.shape[1]} {k9_plan_text(K, att)}",
        lambda: K.gatv2_softmax_agg(*args),
        lambda: K.gatv2_softmax_agg_plain(*args),
        lambda: K.gatv2_softmax_agg_plain(g, *(t.double() for t in args[1:])),
        nbytes, 8.0 * e_all * hc)
    check_k9_plans(K, g, args[1:], None, tag)
    return row


def check_graph_pool(K, seg, x, score, tag):
    """Phase 9 for K10 on one set of graphs.  The yardstick is two
    ``torch.segment_reduce`` calls, sum and max: the mean and max parts of
    K10's function (no library call computes the attention part)."""
    n, d = x.shape
    B = seg.num_graphs
    counts = (seg.ptr[1:] - seg.ptr[:-1]).long()

    def lib():
        return (torch.segment_reduce(x, "sum", lengths=counts, axis=0),
                torch.segment_reduce(x, "max", lengths=counts, axis=0))

    def lib_check(out, ref):
        # the library sums in float32 in its own order: held at LIB_TOL
        keep = counts > 0
        mean = out[0] / counts.clamp_min(1)[:, None]
        for got, want in ((mean, ref[:, :d]), (out[1], ref[:, d:2 * d])):
            err = float((got[keep].double() - want[keep]).abs().max()
                        / want[keep].abs().max())
            require(err <= LIB_TOL,
                    f"graph_pool {tag}: segment_reduce differs {err:.2e}")

    nbytes = (n * d + n + 2 * (B + 1) + 2 * seg.n_chunks + 3 * B * d) * 4
    plan = check_k10_plans(K, seg, x, score, None, False, tag)
    row = _measure_gnn(
        "graph_pool", f"{tag} B={B} N={n} d={d} chunks={seg.n_chunks} "
        f"{plan}",
        lambda: K.graph_pool(seg, x, score),
        lambda: K.graph_pool_plain(seg, x, score),
        lambda: K.graph_pool_plain(seg, x.double(), score.double()), nbytes,
        5.0 * n * d + 4.0 * n, lib, lib_check)
    row["plan"] = plan
    return row


def _keep(shape, dev, seed):
    """A dropout keep-scale at the training path's rate."""
    u = torch.rand(shape, generator=torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    return (u < 1.0 - TRAIN_DROPOUT).float() / (1.0 - TRAIN_DROPOUT)


def k9_train(K, g, args, keep):
    """K9's training instance as the autograd node launches it -> (out,
    lse, scores): K11 takes K9's own scores."""
    sc = torch.empty((g.n_slots, args[-1].shape[0]), dtype=torch.float32,
                     device=args[0].device)
    out, lse = K._gatv2_forward(g, *args, keep, True, scores=sc)
    return out, lse, sc


def check_gatv2_chain(K, g, args, keep, dout, tag) -> None:
    """``[k9-k11-chain]``: K11 on K9's own lse, out and scores, as training
    runs them, against the float64 forward and backward of the same float32
    inputs: every output to GNN_TOL of its largest value (floored as in
    :func:`_measure_gnn`), or to twice the float32 plain chain's own error
    where that chain comes near GNN_TOL itself.  d_w_dst, d_we_loop and
    d_att are sums that cancel, which hold only where K11's softmax weights
    are the ones K9 aggregated with."""
    out, lse, sc = k9_train(K, g, args, keep)
    got = K.gatv2_softmax_agg_bwd(g, *args, keep, lse, out, dout, sc)
    a64 = tuple(t.double() for t in args)
    k64 = None if keep is None else keep.double()
    o64, l64 = K._gatv2_plain(g, *a64, k64)
    want = K.gatv2_softmax_agg_bwd_plain(g, *a64, k64, l64, o64,
                                         dout.double())
    o32, l32 = K._gatv2_plain(g, *args, keep)
    plain = K.gatv2_softmax_agg_bwd_plain(g, *args, keep, l32, o32, dout)
    floor = 1e-6 * max(float(b.abs().max()) for b in want if b.numel())

    def errs(res):
        return [float((a.double() - b).abs().max())
                / max(float(b.abs().max()), floor)
                for a, b in zip(res, want) if b.numel()]

    err, err_plain = errs(got), errs(plain)
    print(f"[k9-k11-chain] {tag}: K9 then K11 against the float64 chain, "
          f"of each output's largest: {', '.join(f'{e:.2e}' for e in err)} "
          f"(tol {GNN_TOL:g}; the float32 plain chain's "
          f"{', '.join(f'{e:.2e}' for e in err_plain)})", flush=True)
    require(all(e <= max(GNN_TOL, 2.0 * p) for e, p in zip(err, err_plain)),
            f"K9 then K11 {tag}: {max(err):.2e}")


def check_k11_memory(K, g, args, keep, lse, out, dout, tag,
                     scores=None) -> dict:
    """K11's scratch: what one call allocates beyond its five outputs (the
    call's peak-memory delta less the outputs' bytes), a few words a slot,
    never a row of H C values a slot: it must stay under a fifth of E' H C
    4 bytes."""
    hc = args[-1].numel()
    row_bytes = g.n_slots * hc * 4
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = K.gatv2_softmax_agg_bwd(g, *args, keep, lse, out, dout, scores)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    outputs = sum(t.nbytes for t in res)
    scratch = peak - outputs
    del res
    print(f"[k11-scratch] {tag} N={g.n} E'={g.n_slots} H*C={hc}: one call's "
          f"peak-memory delta {peak} bytes = the outputs' {outputs} + scratch "
          f"{scratch}, {scratch / row_bytes:.3f} of E' H C 4 = {row_bytes} "
          "bytes", flush=True)
    require(scratch < row_bytes / 5,
            f"K11 {tag}: scratch past a fifth of a row a slot")
    return {"scratch_bytes": scratch, "peak_delta_bytes": peak}


@torch.no_grad()
def check_train_kernels(K, layer1, pool, tag, dev):
    """Phase 12: K9 with its keep-scale and lse, K11, K10 with its keep-scale
    and training outputs, and K12 at one graph's shapes, without and with
    dropout keep-scales and, for K12, on features rounded to a grid of 1/4
    so that many nodes tie at each column's max.  Returns the kernels-line
    rows of the dropout case."""
    g, w_src, w_dst, we, we_loop, att = layer1
    seg, x, score = pool
    heads, hc = att.shape[0], w_src.shape[1]
    f4, e_all, n = 4, g.n_slots, g.n
    gen = torch.Generator(device=dev).manual_seed(2031)
    rows = {}
    for dropout in (False, True):
        keep = _keep((e_all, heads), dev, 5) if dropout else None
        keep64 = None if keep is None else keep.double()
        args64 = tuple(t.double() for t in layer1[1:])
        out64, lse64 = K._gatv2_plain(g, *args64, keep64)
        kt = f"{tag}{' dropout' if dropout else ''}"
        # reads K9's inputs once, writes out, lse and the scores once
        fwd_bytes = ((n + 1) * f4 + 2 * e_all * f4 + 3 * n * hc * f4
                     + g.n_real * hc * f4 + hc * f4 + att.numel() * f4
                     + (e_all * heads * f4 if dropout else 0) + n * heads * f4
                     + e_all * heads * f4)
        row9 = _measure_gnn(
            "gatv2_softmax_agg", f"{kt} train (keep, lse, scores) N={n} "
            f"E'={e_all} {k9_plan_text(K, att)}",
            lambda: k9_train(K, g, layer1[1:], keep)[0],
            lambda: K._gatv2_plain(g, *layer1[1:], keep)[0],
            lambda: out64, fwd_bytes, 9.0 * e_all * hc)
        if dropout:
            check_k9_plans(K, g, layer1[1:], keep, kt)
        out, lse, sc = k9_train(K, g, layer1[1:], keep)
        lse_err = float((lse.double() - lse64).abs().max()
                        / lse64.abs().max())
        require(lse_err <= GNN_TOL, f"K9 {kt}: lse error {lse_err:.2e}")
        dout = torch.randn(out.shape, generator=gen, device=dev)
        # reads K9's inputs, keep, lse, the scores, out, dout and the
        # source CSR once, writes the five gradients; the scratch (a few
        # words a slot) is not compulsory.  About 17 operations per slot and
        # channel.
        bwd_bytes = (fwd_bytes + (n + 1) * f4 + e_all * f4
                     + n * hc * f4 + 2 * n * hc * f4
                     + g.n_real * hc * f4 + hc * f4 + att.numel() * f4)
        p11 = k11_plan_text(K, heads, hc // heads)
        row11 = _measure_gnn(
            "gatv2_softmax_agg_bwd", f"{kt} N={n} E'={e_all} {p11}",
            lambda: K.gatv2_softmax_agg_bwd(g, *layer1[1:], keep, lse, out,
                                            dout, sc),
            lambda: K.gatv2_softmax_agg_bwd_plain(g, *layer1[1:], keep, lse,
                                                  out, dout, sc),
            lambda: K.gatv2_softmax_agg_bwd_plain(g, *args64, keep64,
                                                  lse.double(), out.double(),
                                                  dout.double(), sc.double()),
            bwd_bytes, 17.0 * e_all * hc)
        row11.update(check_k11_memory(K, g, layer1[1:], keep, lse, out, dout,
                                      kt, sc), plan=p11)
        check_gatv2_chain(K, g, layer1[1:], keep, dout, kt)
        for xt, ttag in ((x, ""), (torch.round(4.0 * x) / 4.0, " ties")):
            nn_, d = xt.shape
            keep_p = _keep((nn_,), dev, 6) if dropout else None
            keep_p64 = None if keep_p is None else keep_p.double()
            ref = K._graph_pool_plain(seg, xt.double(), score.double(),
                                      keep_p64)
            out_p, stats, ties = K._graph_pool_forward(seg, xt, score, keep_p,
                                                       True)
            require(torch.equal(ties.double(), ref[2]),
                    f"K10 {kt}{ttag}: tie counts differ")
            stat_err = float((stats.double() - ref[1]).abs().max()
                             / ref[1].abs().max())
            require(stat_err <= GNN_TOL, f"K10 {kt}{ttag}: stats "
                                         f"{stat_err:.2e}")
            print(f"[kernel] graph_pool {kt}{ttag}: most nodes tied at a "
                  f"column max {int(ties.max())}, stats err {stat_err:.2e}")
            B = seg.num_graphs
            pool_bytes = (nn_ * d + nn_ * (2 if dropout else 1) + 2 * (B + 1)
                          + 3 * seg.n_chunks + 3 * B * d + 2 * B + B * d) * f4
            plan10 = check_k10_plans(K, seg, xt, score, keep_p, True,
                                     f"{kt}{ttag}")
            row10 = _measure_gnn(
                "graph_pool", f"{kt}{ttag} train (keep, stats, ties) N={nn_} "
                f"{plan10}",
                lambda: K._graph_pool_forward(seg, xt, score, keep_p,
                                              True)[0],
                lambda: K.graph_pool_plain(seg, xt, score, keep_p),
                lambda: ref[0], pool_bytes, 6.0 * nn_ * d + 4.0 * nn_)
            row10["plan"] = plan10
            dpool = torch.randn(out_p.shape, generator=gen, device=dev)
            row12 = _measure_gnn(
                "graph_pool_bwd", f"{kt}{ttag} B={B} N={nn_} d={d}",
                lambda: K.graph_pool_bwd(seg, xt, score, keep_p, out_p, stats,
                                         ties, dpool),
                lambda: K.graph_pool_bwd_plain(seg, xt, score, keep_p, out_p,
                                               stats, ties, dpool),
                lambda: K.graph_pool_bwd_plain(
                    seg, xt.double(), score.double(), keep_p64,
                    out_p.double(), stats.double(), ties.double(),
                    dpool.double()),
                (2 * nn_ * d + nn_ * (3 if dropout else 2) + 2 * (B + 1)
                 + 3 * seg.n_chunks + 7 * B * d + 2 * B) * f4,
                6.0 * nn_ * d)
            row12["plan"] = check_k12_plans(
                K, (seg, xt, score, keep_p, out_p, stats, ties, dpool),
                f"{kt}{ttag} N={nn_} d={d}")
            if dropout and not ttag:
                rows = {"gatv2_softmax_agg": row9, "graph_pool": row10,
                        "gatv2_softmax_agg_bwd": row11,
                        "graph_pool_bwd": row12}
    return rows


def _train_setup(hidden_dim=None, num_heads=None, small=False,
                 graphs=SMALL_STEP_GRAPHS):
    """The batch, weights, config, dropout coins and log tag of one
    full-width training step (:func:`check_train_step`): the first batch of
    16 of the seeded test split or, with ``small``, its ``graphs``
    smallest graphs."""
    from ltr_lowrank_sdp_torch.data.loader import (collate, create_splits,
                                                   iterate_batches)
    from ltr_lowrank_sdp_torch.models.checkpoint import load_model
    from ltr_lowrank_sdp_torch.models.net import (RankSchedulePredictor,
                                                   init_params)

    ds, _, _, test_idx = create_splits(DATASET, seed=42)
    if small:
        sizes = {i: ds.get(i).x.shape[0] for i in test_idx}
        batch = collate([ds.get(i) for i in sorted(
            test_idx, key=sizes.get)[:graphs]], pad_graphs_to=graphs)
    else:
        batch = next(iterate_batches(ds, test_idx, 16))
    base, cfg = load_model(CKPT, device="cpu")
    cfg = dataclasses.replace(cfg, dropout=0.0)
    tag = "train-step"
    if hidden_dim is not None:
        cfg = dataclasses.replace(cfg, hidden_dim=hidden_dim,
                                  num_heads=num_heads or cfg.num_heads)
        base = RankSchedulePredictor(cfg)
        init_params(base, torch.Generator().manual_seed(hidden_dim))
        tag = f"train-step-h{hidden_dim}" + (
            f"x{num_heads}" if num_heads else "")
    coins = torch.rand(cfg.max_seq_len,
                       generator=torch.Generator().manual_seed(13))
    return batch, base, cfg, coins, tag


TRAIN_LR = 3e-4


def _train_step(K, setup, device, dtype, grads=None):
    """One step of ``setup`` (:func:`_train_setup`) -> (loss, gradients,
    parameters after the step, counts); with ``grads``, the optimizer step
    alone from those gradients."""
    from ltr_lowrank_sdp_torch import train
    from ltr_lowrank_sdp_torch.models.loss import LossWeights
    from ltr_lowrank_sdp_torch.models.net import RankSchedulePredictor
    from ltr_lowrank_sdp_torch.optim import TrainOptimizer

    batch, base, cfg, coins, tag = setup
    model = RankSchedulePredictor(cfg).to(dtype=dtype)
    model.load_state_dict(base.state_dict())
    model.to(device=device).train()
    opt = TrainOptimizer(model.parameters(), TRAIN_LR, 1e-4, 1.0)
    t0 = time.perf_counter()
    K.reset_counts()
    loss = float("nan")
    if grads is None:
        t = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in train.batch_tensors(batch, device).items()}
        out, _ = train.train_loss(model, t, batch,
                                  LossWeights(under_weight=3.67), 0.5,
                                  coins=coins.to(device, dtype))
        out.backward()
        loss = float(out.detach())
    else:
        for k, p in model.named_parameters():
            p.grad = grads[k].to(device, dtype, copy=True)
    g = {k: p.grad.detach().double().cpu().clone()
         for k, p in model.named_parameters()}
    opt.step()
    if device.type == "cuda":
        torch.cuda.synchronize()
    print(f"[{tag}] {device} {dtype}"
          f"{' (given gradients)' if grads is not None else ''}: loss "
          f"{loss:.9f}, step {time.perf_counter() - t0:.2f} s, counts "
          f"{json.dumps({k: v for k, v in K.counts().items() if any(v)})}",
          flush=True)
    return (loss, g, {k: p.detach().double().cpu() for k, p in
                      model.named_parameters()}, K.counts())


def _leaf_errors(g_g, g_c):
    """Each gradient leaf's largest error against the float64 gradients
    ``g_c``, of the leaf's own largest float64 value (a leaf that is 0 up to
    its own rounding: of the model's largest gradient) -> (errors, scales)."""
    largest = max(float(g.abs().max()) for g in g_c.values())
    per_leaf, scale = {}, {}
    for k, g in g_c.items():
        own = float(g.abs().max())
        scale[k] = own if own > 1e-12 * largest else largest
        per_leaf[k] = float((g_g[k] - g).abs().max()) / scale[k]
    return per_leaf, scale


@contextlib.contextmanager
def _gnn_variant(K, fwd, bwd, stash):
    """K9's forward as ``fwd`` ("kernel", or "plain": its plain version on
    the card's float32 tensors, keeping its scores in ``stash`` by the lse's
    address) and K11 as ``bwd`` ("kernel"; "plain32": its plain version in
    float32; "plain64": in float64 on the float32 inputs, scores recomputed
    in float64 as K11 does; "plain64s": in float64 with the forward's own
    float32 scores from ``stash``), for :func:`train_step_parts`."""
    fwd0, bwd0, msg0 = K._gatv2_forward, K.gatv2_softmax_agg_bwd, \
        K._gatv2_messages

    def plain_fwd(g, w_src, w_dst, we, we_loop, att, keep, with_lse,
                  plan=None, scores=None):
        out, lse = K._gatv2_plain(g, w_src, w_dst, we, we_loop, att, keep)
        s = msg0(g, w_src, w_dst, we, we_loop, att)[2]
        stash[lse.data_ptr()] = s
        if scores is not None:
            scores.copy_(s)
        return out, lse if with_lse else None

    def plain_bwd(g, w_src, w_dst, we, we_loop, att, keep, lse, out, dout,
                  scores=None):
        # the plain versions evaluate their own scores (K11's from K9 are
        # not taken), as the variant's name says
        if bwd == "plain32":
            return K.gatv2_softmax_agg_bwd_plain(
                g, w_src, w_dst, we, we_loop, att, keep, lse, out, dout)
        scores = stash.get(lse.data_ptr()) if bwd == "plain64s" else None
        if scores is not None:
            K._gatv2_messages = lambda *a: msg0(*a)[:2] + (scores.double(),)
        try:
            d = K.gatv2_softmax_agg_bwd_plain(
                g, *(None if t is None else t.double() for t in (
                    w_src, w_dst, we, we_loop, att, keep, lse, out, dout)))
        finally:
            K._gatv2_messages = msg0
        return tuple(t.float() for t in d)

    if fwd == "plain":
        K._gatv2_forward = plain_fwd
    if bwd != "kernel":
        K.gatv2_softmax_agg_bwd = plain_bwd
    try:
        yield
    finally:
        K._gatv2_forward, K.gatv2_softmax_agg_bwd = fwd0, bwd0
        stash.clear()


# (K9 forward, K11 backward) of the float32 card steps of --train-step
TRAIN_STEP_PARTS = (("kernel", "kernel"), ("plain", "plain32"),
                    ("kernel", "plain32"), ("plain", "kernel"),
                    ("plain", "plain64"), ("kernel", "plain64"),
                    ("plain", "plain64s"))


# relative changes of every weight (random signs, from a seed) under which
# --train-step takes the float64 CPU step again: how far the float64
# gradients themselves move for a change of a float32 ulp or less
TRAIN_STEP_NUDGES = (1e-7, 1e-9)


def _nudged(setup, rel):
    """``setup`` with every weight w changed to w (1 +- rel)."""
    from ltr_lowrank_sdp_torch.models.net import RankSchedulePredictor

    batch, base, cfg, coins, tag = setup
    g = torch.Generator().manual_seed(7)
    state = {k: v.double() * (1.0 + rel * torch.sign(torch.randn(
        v.shape, generator=g, dtype=torch.float64)))
        if v.is_floating_point() else v
        for k, v in base.state_dict().items()}
    model = RankSchedulePredictor(cfg).double()
    model.load_state_dict(state)
    return batch, model, cfg, coins, tag


def train_step_parts(spec: str) -> int:
    """``--train-step HIDDEN,HEADS``: the training step of
    :func:`check_train_step` at that width, each run's gradient error per
    leaf against the one float64 CPU step (no check, exit 0): float32 on the
    card with K9 and K11 each as its kernel or as its plain version
    (:data:`TRAIN_STEP_PARTS`), float32 on the CPU (every operation plain),
    and float64 on the CPU with the weights nudged by
    :data:`TRAIN_STEP_NUDGES`."""
    from ltr_lowrank_sdp_torch.ops import kernels as K

    hidden, heads = (int(v) for v in spec.split(","))
    print(f"[card] {card_line()}", flush=True)
    K.build_kernels()
    dev, cpu = torch.device("cuda", torch.cuda.current_device()), \
        torch.device("cpu")
    setup = _train_setup(hidden, heads)
    tag = setup[4]
    _, g_c, _, _ = _train_step(K, setup, cpu, torch.float64)

    def report(what, g):
        per_leaf, _ = _leaf_errors(g, g_c)
        top = sorted(per_leaf.items(), key=lambda kv: -kv[1])[:6]
        print(f"[{tag}-parts] {what}: gradient error per leaf (tol "
              f"{GRAD_TOL:g}), worst first: "
              f"{', '.join(f'{k} {v:.2e}' for k, v in top)}", flush=True)
        return g

    stash, runs = {}, {}
    for fwd, bwd in TRAIN_STEP_PARTS:
        with _gnn_variant(K, fwd, bwd, stash):
            runs[fwd, bwd] = report(
                f"card float32, K9 {fwd}, K11 {bwd}",
                _train_step(K, setup, dev, torch.float32)[1])
    g_cpu32 = report("CPU float32, all plain",
                     _train_step(K, setup, cpu, torch.float32)[1])
    # two float32 programs of the same function against each other, on the
    # float64 gradients' scale
    _, scale = _leaf_errors(g_cpu32, g_c)
    for key in (("plain", "plain32"), ("kernel", "kernel")):
        diff = {k: float((runs[key][k] - g_cpu32[k]).abs().max()) / scale[k]
                for k in g_c}
        top = sorted(diff.items(), key=lambda kv: -kv[1])[:4]
        print(f"[{tag}-parts] card float32 (K9 {key[0]}, K11 {key[1]}) "
              f"against CPU float32, of the float64 leaf's largest: "
              f"{', '.join(f'{k} {v:.2e}' for k, v in top)}", flush=True)
    for rel in TRAIN_STEP_NUDGES:
        report(f"CPU float64, weights nudged by {rel:g}",
               _train_step(K, _nudged(setup, rel), cpu, torch.float64)[1])
    return 0


def check_train_step(K, dev, hidden_dim=None, num_heads=None, small=False):
    """Phase 12: one training step at full width (the r5_theta weights,
    dropout 0, fixed coins) on a collated batch of the seeded test split, on
    the card in float32 and on the CPU in float64 (the plain K9-K12 and
    every other operation in float64).  With ``hidden_dim`` (and
    ``num_heads``) the step runs at that GNN width (r5_theta's config
    otherwise, the weights drawn by ``init_params`` from a seed).  Held: the
    loss to LOSS_RTOL relative; every gradient leaf to GRAD_TOL of that
    leaf's own largest float64 value (a leaf that is 0 in exact arithmetic,
    the attention pooling's score bias, to GRAD_TOL of the model's largest
    gradient); the card's optimizer step to PARAM_TOL of each leaf's largest
    value against the float64 step from the card's own gradients; and
    against the float64 step from the float64 gradients, every element to
    PARAM_TOL plus the most that a gradient within the gradient tolerance
    changes Adam's first step, lr * g / (|g| + eps), whose direction the
    rounding of a gradient near 0 decides.

    With ``small`` the step runs on the ``SMALL_STEP_GRAPHS`` smallest
    graphs of the test split, held to the same tolerances, and the worst
    leaf of the CPU's float32 step on that batch (every operation plain, on
    ``SMALL_STEP_THREADS`` threads) is printed beside it: a width where the
    CPU's and the JAX package's own float32 steps miss GRAD_TOL."""
    setup = _train_setup(hidden_dim, num_heads, small)
    cfg, tag, lr = setup[2], setup[4], TRAIN_LR
    cpu = torch.device("cpu")

    def step(device, dtype, grads=None):
        return _train_step(K, setup, device, dtype, grads)

    l_g, g_g, p_g, c_g = step(dev, torch.float32)
    l_c, g_c, p_c, _ = step(cpu, torch.float64)
    _, _, p_s, _ = step(cpu, torch.float64, g_g)
    if small:
        threads = torch.get_num_threads()
        torch.set_num_threads(SMALL_STEP_THREADS)
        try:
            e32, _ = _leaf_errors(step(cpu, torch.float32)[1], g_c)
        finally:
            torch.set_num_threads(threads)
        worst = max(e32.items(), key=lambda kv: kv[1])
        print(f"[{tag}] the CPU's float32 step on this batch, every "
              f"operation plain, {SMALL_STEP_THREADS} threads, against the "
              f"float64 step: worst leaf {worst[0]} {worst[1]:.2e} (not "
              f"held; the card is held to {GRAD_TOL:g})", flush=True)
    require_counts(tag, c_g, TRAIN_KERNELS)
    calls = len(K.k11_groups(cfg.num_heads, cfg.hidden_dim // cfg.num_heads))
    require(c_g["gatv2_softmax_agg_bwd"][0] == cfg.num_gnn_layers * calls
            and c_g["graph_pool_bwd"][0] == 1,
            f"{tag}: K11 once per GATv2 layer and head group "
            f"({calls}), K12 once")
    rel = abs(l_g - l_c) / abs(l_c)
    per_leaf, scale = _leaf_errors(g_g, g_c)
    opt_err = max(float((p_g[k] - p_s[k]).abs().max())
                  / max(float(p_s[k].abs().max()), 1e-30) for k in p_s)
    # Adam's first step moves an element by lr * (u(c g) + wd p), u(c g) =
    # c g / (|c g| + eps), c the clip factor: its direction is as sensitive
    # to the gradient as eps / |c g|.  An element may part from the float64
    # step by PARAM_TOL of its leaf's largest value plus the most that a
    # gradient within the gradient tolerance, g +- GRAD_TOL * scale, moves
    # lr * u (u increases with g: the larger of its two one-sided changes).
    norm = math.sqrt(sum(float(g.square().sum()) for g in g_c.values()))
    c = 1.0 if norm < 1.0 else 1.0 / norm

    def u(g):
        return c * g / ((c * g).abs() + 1e-8)

    parted, unexplained = 0, 0
    for k, g in g_c.items():
        tol = GRAD_TOL * scale[k]
        du = torch.maximum(u(g + tol) - u(g), u(g) - u(g - tol))
        diff = (p_g[k] - p_c[k]).abs()
        floor = PARAM_TOL * float(p_c[k].abs().max())
        parted += int((diff > floor).sum())
        unexplained += int((diff > floor + lr * du).sum())
    top = sorted(per_leaf.items(), key=lambda kv: -kv[1])
    print(f"[{tag}] card float32 vs CPU float64: loss rel diff {rel:.2e} "
          f"(tol {LOSS_RTOL:g}); gradient error per leaf, of the leaf's own "
          f"largest value (tol {GRAD_TOL:g}), worst first: "
          f"{', '.join(f'{k} {v:.2e}' for k, v in top)}", flush=True)
    print(f"[{tag}] parameters after one step: the card's optimizer "
          f"against the float64 step from the card's gradients "
          f"{opt_err:.2e} of each leaf's largest (tol {PARAM_TOL:g}); "
          f"against the float64 step from the float64 gradients {parted} "
          f"elements part by more than {PARAM_TOL:g} of their leaf's "
          f"largest, {unexplained} of them by more than that plus what a "
          f"gradient within the gradient tolerance makes of Adam's first "
          f"step", flush=True)
    require(rel <= LOSS_RTOL, f"{tag}: card and CPU losses differ")
    require(top[0][1] <= GRAD_TOL,
            f"{tag}: card and CPU gradients differ ({top[0][0]})")
    require(opt_err <= PARAM_TOL,
            f"{tag}: the card's optimizer step differs from the CPU's")
    require(unexplained == 0,
            f"{tag}: card and CPU parameters differ after one step")


@contextlib.contextmanager
def _plain_gnn(K, branches=None, record=None):
    """K9-K12 as their plain versions on the card's tensors, for a float64
    step there (the kernels take float32): the GATv2 backward evaluates its
    own scores in the step's type and, with ``branches``, takes each
    call's LeakyReLU branches from the next of them; ``record`` receives
    each call's own branches (``msg >= 0``)."""
    saved = (K._gatv2_forward, K.gatv2_softmax_agg_bwd,
             K._graph_pool_forward, K.graph_pool_bwd)
    given = iter(branches or ())

    def fwd(g, w_src, w_dst, we, we_loop, att, keep, with_lse, plan=None,
            scores=None):
        out, lse = K._gatv2_plain(g, w_src, w_dst, we, we_loop, att, keep)
        return out, lse if with_lse else None

    def bwd(g, w_src, w_dst, we, we_loop, att, keep, lse, out, dout,
            scores=None):
        if record is not None:
            record.append(K._gatv2_messages(g, w_src, w_dst, we, we_loop,
                                            att)[1] >= 0)
        return K.gatv2_softmax_agg_bwd_plain(
            g, w_src, w_dst, we, we_loop, att, keep, lse, out, dout,
            branch=next(given) if branches is not None else None)

    def pool_fwd(seg, x, score, keep, train, plan=None):
        out, stats, ties = K._graph_pool_plain(seg, x, score, keep)
        return (out, stats, ties) if train else (out, None, None)

    (K._gatv2_forward, K.gatv2_softmax_agg_bwd, K._graph_pool_forward,
     K.graph_pool_bwd) = fwd, bwd, pool_fwd, K.graph_pool_bwd_plain
    try:
        yield
    finally:
        (K._gatv2_forward, K.gatv2_softmax_agg_bwd, K._graph_pool_forward,
         K.graph_pool_bwd) = saved


@contextlib.contextmanager
def _fixed_max_node(K, w=None, seen=None):
    """``graph_pool`` with the ``max x`` third of its ``[mean | max |
    attention]`` output replaced by the gather ``sum_i w[i] x[i]`` per graph
    (``w`` (N, d): 1 / k at the k nodes of the float64 step's maximum):
    the max pooling's node fixed, as ``tests/test_torch_f32_faults.py``
    fixes it.  Without ``w`` the pooling is K10's own; ``seen`` receives
    its input and graphs."""
    pool = K.graph_pool

    def fixed(seg, x, score, keep=None):
        out = pool(seg, x, score, keep)
        if seen is not None:
            seen["x"], seen["seg"] = x.detach().clone(), seg
        if w is None:
            return out
        d = x.shape[1]
        mx = torch.zeros((seg.num_graphs, d), dtype=x.dtype,
                         device=x.device).index_add_(
            0, seg.batch_ids, x * w.to(x.dtype))
        return torch.cat([out[:, :d], mx, out[:, 2 * d:]], dim=1)

    K.graph_pool = fixed
    try:
        yield
    finally:
        K.graph_pool = pool


def _max_node_weights(seg, x):
    """(N, d) weights of the max pooling's node: per graph and channel 1 / k
    at the k nodes where x equals the graph's maximum, else 0."""
    ids = seg.batch_ids
    top = torch.full((seg.num_graphs, x.shape[1]), -math.inf,
                     dtype=x.dtype, device=x.device).scatter_reduce_(
        0, ids[:, None].expand_as(x), x, "amax")
    hit = (x == top[ids]).to(x.dtype)
    count = torch.zeros_like(top).index_add_(0, ids, hit)
    return hit / count[ids]


def check_train_step_3g(K, dev) -> None:
    """``[train-step-h512x4-3g]``: the training step at ``--hidden-dim 512``
    (4 heads of 128 channels) on the test split's STEP_3G_GRAPHS smallest
    graphs, the card's float32 kernel step against the card's float64 step
    of the plain versions (``_plain_gnn``), both with the max pooling's node
    fixed to the float64 step's (``_fixed_max_node``: without it both the
    card's and the JAX package's float32 steps cross a jump of that max).
    A second jump of the function: a GATv2 message within float32 rounding
    of 0 takes the other LeakyReLU branch in the float32 step than in the
    float64 one, which moves the leaves behind that layer's softmax by 0.8
    ds att (``tests/test_torch_f32_faults.py``: the JAX package's float32
    step crosses it too).  So the float64 step runs twice: with its own
    branches (printed) and with the card's, each message's sign as K11
    takes it (the float32 inputs summed in float64).  Held: against the
    latter, the worst gradient leaf to STEP_3G_TOL (twice the JAX
    package's float32 worst leaf with the node fixed, on the CPU); printed:
    the worst leaves, ``convs.0.lin_dst.weight`` and the branches the
    programs take apart per layer."""
    setup = _train_setup(*SMALL_STEP, small=True, graphs=STEP_3G_GRAPHS)
    tag = f"{setup[4]}-{STEP_3G_GRAPHS}g"
    setup = setup[:4] + (tag,)
    t = time.perf_counter()
    seen = {}
    with _plain_gnn(K), _fixed_max_node(K, None, seen):
        _train_step(K, setup, dev, torch.float64)
    w = _max_node_weights(seen["seg"], seen["x"])
    del seen
    card, bwd = [], K.gatv2_softmax_agg_bwd

    def keep_branches(g, w_src, w_dst, we, we_loop, att, *rest):
        card.append(K._gatv2_messages(g, *(t.double() for t in (
            w_src, w_dst, we, we_loop, att)))[1] >= 0)
        return bwd(g, w_src, w_dst, we, we_loop, att, *rest)

    K.gatv2_softmax_agg_bwd = keep_branches
    try:
        with _fixed_max_node(K, w):
            _, g32, _, c32 = _train_step(K, setup, dev, torch.float32)
    finally:
        K.gatv2_softmax_agg_bwd = bwd
    require_counts(tag, c32, TRAIN_KERNELS)
    own = []
    with _plain_gnn(K, record=own), _fixed_max_node(K, w):
        g64 = _train_step(K, setup, dev, torch.float64)[1]
    apart = [int((a != b).sum()) for a, b in zip(card, own)]
    del own
    with _plain_gnn(K, branches=card), _fixed_max_node(K, w):
        g64c = _train_step(K, setup, dev, torch.float64)[1]
    del card
    worst = {}
    for name, ref in (("own", g64), ("card", g64c)):
        per_leaf, _ = _leaf_errors(g32, ref)
        top = sorted(per_leaf.items(), key=lambda kv: -kv[1])
        worst[name] = top[0]
        whose = "its own" if name == "own" else "the card's"
        print(f"[{tag}] max pooling's node fixed, card float32 kernels vs "
              f"card float64 plain with {whose} LeakyReLU branches: worst "
              f"leaves {', '.join(f'{k} {v:.3e}' for k, v in top[:3])}; "
              f"convs.0.lin_dst.weight "
              f"{per_leaf['encoder.convs.0.lin_dst.weight']:.3e}", flush=True)
    print(f"[{tag}] messages on other LeakyReLU branches in the two steps, "
          f"by K11 call (last layer first): {apart}; held: the worst leaf "
          f"against the float64 step with the card's branches <= "
          f"{STEP_3G_TOL:g}; {time.perf_counter() - t:.1f} s", flush=True)
    require(worst["card"][1] <= STEP_3G_TOL,
            f"{tag}: worst leaf {worst['card'][0]} {worst['card'][1]:.3e}")
    torch.cuda.empty_cache()


def as_dtype(layout, dtype):
    """A kernel layout (``SymCSR``, ``SegCOO``, ``ConstrCSR``,
    ``LPEntries``) with its values in ``dtype``; the index arrays are
    shared."""
    def cast(v):
        return (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                else v)

    return type(layout)(**{f.name: cast(getattr(layout, f.name))
                           for f in dataclasses.fields(layout)})


def _measure32(name, tag, kern, plain, plain64, nbytes, flops, lib=None,
               lib_check=None, scale=None):
    """The float32 kernel phase: hold one float32 kernel call against its
    plain version evaluated in float64 on the same float32 inputs
    (``plain64``): max |kernel - plain64| / max |plain64| <= F32_KERNEL_TOL
    per output, or, for K4's float64 scalar, |kernel - plain64| / ``scale``
    (the sum of its terms' magnitudes) <= K4_F32_TOL; the same bits on two
    calls.  Then time the kernel, the float32 plain version and the float32
    library yardstick (``lib_check(lib())`` holds it to F32_LIB_TOL of the
    float64 evaluation), the bound at 4-byte values and the FP32 rate.
    Returns the kernels-line fields."""
    def tup(out):
        return out if isinstance(out, tuple) else (out,)

    out_k, ref = tup(kern()), tup(plain64())
    torch.cuda.synchronize()
    diffs = [float((a.double() - b).abs().max()) for a, b in zip(out_k, ref)]
    if scale is None:
        errs = [d / max(float(b.abs().max()), 1e-300)
                for d, b in zip(diffs, ref)]
        tol = F32_KERNEL_TOL
    else:
        errs, tol = [diffs[0] / scale], K4_F32_TOL
    require(max(errs) <= tol,
            f"{name} {tag}: float32 error {max(errs):.3e} > {tol:g}")
    require(all(torch.equal(a, b) for a, b in zip(tup(kern()), out_k)),
            f"{name} {tag}: two calls gave different bits")
    ms, plain_ms, call_ms = time_ms(kern), time_ms(plain), host_call_ms(kern)
    lib_ms = None
    if lib is not None:
        lib_check(lib())
        lib_ms = time_ms(lib)
    b_ms, b_by = bound_ms(nbytes, flops, FP32_FLOP_PER_S)
    lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "null"
    print(f"[kernel-f32] {name} {tag}: max err / "
          f"{'sum |terms|' if scale is not None else 'max |plain64|'} "
          f"{', '.join(f'{e:.2e}' for e in errs)} (tol {tol:g}), max abs "
          f"err {max(diffs):.2e}, same bits on two calls, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
          f"{lib_txt} ms, {nbytes / ms / 1e6:.1f} GB/s; host-issued call "
          f"{call_ms:.4f} ms", flush=True)
    return {"max_abs_err": max(diffs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def _lib_close(name, ref):
    """A check that a float32 library result is within F32_LIB_TOL of the
    float64 evaluation ``ref`` (a tensor or a tuple of them)."""
    def check(out):
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err = max(float((a.double() - b).abs().max() / b.abs().max())
                  for a, b in zip(outs, refs))
        require(err <= F32_LIB_TOL,
                f"{name}: float32 library result differs {err:.2e}")
    return check


def check_capture_kernels(K, cone, mc_cone, lp, dev) -> None:
    """``[capture-kernels]``: each of K1-K8, at its main path's shapes
    (K1-K4 the MaxCut C at rank REPORT_RANK, K5 / K6 the matrix-completion
    cone at MC_REPORT_RANK, K7 / K8 the multi-block + LP path's LP cone),
    captured inside a conditional body of a CUDA graph
    (``solver.devloop.DeviceGraph``: a WHILE of two runs, each an IF around
    the call) and replayed twice.  Each replay's outputs must be the eager
    call's bits, and the launches the graph accounts from its body runs
    (``DeviceGraph.account``) twice the eager call's, float32 and folded
    launches included.  Any failed capture, node or replay raises."""
    from types import SimpleNamespace

    from ltr_lowrank_sdp_torch.solver.devloop import DeviceGraph

    g = torch.Generator(device=dev).manual_seed(1616)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)

    n, r = cone.n, REPORT_RANK
    U, V, Y = rnd(n, r), rnd(n, r), rnd(n, r)
    w = rnd(cone.m)
    nm, rm = mc_cone.n, MC_REPORT_RANK
    Um, Vm = rnd(nm, rm), rnd(nm, rm)
    wm = rnd(mc_cone.m)
    u, v = rnd(lp.n_cols).abs(), rnd(lp.n_cols).abs()
    wl = rnd(lp.m)
    mv = cone.cg_normal_matvec(V)
    calls = (
        ("spmm_sym_csr", "C Y", lambda: cone.apply_c(Y)),
        ("spmm_sym_csr", "A*(w) Y, folded", lambda: cone.apply_a(w, Y)),
        ("diag_rowdot", "A(sym(U V^T))", lambda: cone.constr_vals(U, V)),
        ("diag_rowdot", "pair", lambda: cone.constr_vals_pair(U, V)),
        ("diag_normal_matvec", "CG operator", lambda: mv(Y)),
        ("sym_contract_sum", "<C, sym(U V^T)>", lambda: cone.obj_value(U, V)),
        ("coo_contract_segsum", "A(sym(U V^T))",
         lambda: mc_cone.constr_vals(Um, Vm)),
        ("coo_contract_segsum", "pair",
         lambda: mc_cone.constr_vals_pair(Um, Vm)),
        ("spmm_constr_csr", "A*(w) Y", lambda: mc_cone.apply_a(wm, Um)),
        ("lp_constr_segsum", "A_lp(u o v)", lambda: lp.constr_vals(u, v)),
        ("lp_constr_segsum", "pair", lambda: lp.constr_vals_pair(u, v)),
        ("lp_col_wsum", "c + A_lp^T w",
         lambda: lp.weighted_col_sums(wl, obj_coef=3.0)),
    )

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    def snap():
        return {k.name: (k.launches, k.launches_f32, k.folds)
                for k in K.KERNELS.values()}

    seen = set()
    for name, what, fn in calls:
        before = snap()
        want = [t.clone() for t in tup(fn())]
        torch.cuda.synchronize()
        eager = {k: tuple(a - b for a, b in zip(v, before[k]))
                 for k, v in snap().items() if v != before[k]}
        S = SimpleNamespace(out=[torch.zeros_like(t) for t in want],
                            k=torch.zeros((), dtype=torch.int64, device=dev))

        def body(flow, st):
            st.k.zero_()

            def run():
                for o, x in zip(st.out, tup(fn())):
                    o.copy_(x)

            def step():
                flow.if_(st.k >= 0, run)
                st.k.add_(1)

            flow.while_(lambda: st.k < 2, step)

        t = time.perf_counter()
        graph = DeviceGraph(f"capture-{name}", dev, body, S, lambda: (
            SimpleNamespace(out=[o.clone() for o in S.out], k=S.k.clone())))
        cap_ms = (time.perf_counter() - t) * 1e3
        for rep in range(2):
            for o in S.out:
                o.zero_()
            before = snap()
            graph.launch()
            torch.cuda.synchronize()
            graph.account(graph.runs[:len(graph.bodies)].tolist())
            got = {k: tuple(a - b for a, b in zip(v, before[k]))
                   for k, v in snap().items() if v != before[k]}
            same = all(torch.equal(o, x) for o, x in zip(S.out, want))
            twice = {k: tuple(2 * x for x in v) for k, v in eager.items()}
            print(f"[capture-kernels] {name} ({what}) replay {rep + 1}: "
                  f"bitwise the eager call {same}; launches, float32, "
                  f"folded {got} (eager x 2: {twice}); graph {graph.nodes} "
                  f"nodes, warm-up + capture {cap_ms:.1f} ms, instantiation "
                  f"{graph.instantiate_ms:.2f} ms", flush=True)
            require(same, f"{name} ({what}): a replay is not the eager bits")
            require(got == twice and set(eager) == {name},
                    f"{name} ({what}): launches accounted {got}, the eager "
                    f"calls {twice}")
        seen.add(name)
        del graph
    require(seen == set(list(K.KERNELS)[:8]), "K1-K8 captured")


def check_f32_kernels(K, cone, mc_cone, lp, dev):
    """The float32 kernel phase: K1-K4 on the MaxCut main path's C at rank
    REPORT_RANK, K5 (pair mode) and K6 on the matrix-completion cone at
    MC_REPORT_RANK, K7 (pair) and K8 on the multi-block + LP path's LP cone,
    each in float32.  The yardsticks are float32 library calls:
    ``torch.sparse.mm`` for K1, K6, K7 and K8, ``torch.linalg.vecdot`` (the
    row dot alone) for K2.  Returns {name: row}."""
    f4, i4 = 4, 4
    f32, f64 = torch.float32, torch.float64
    g = torch.Generator(device=dev).manual_seed(2032)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=f32, device=dev)

    def sparse_csr(ptr, idx, vals, size):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # "sparse CSR is beta"
            return torch.sparse_csr_tensor(ptr, idx, vals, size=size)

    rows = {}
    # ---- K1-K4: the MaxCut C, n = 2^14, rank 20 ----
    n, r = cone.n, REPORT_RANK
    csr32 = as_dtype(cone.c_csr, f32)
    csr64 = as_dtype(csr32, f64)
    dv = cone.diag_val.to(f32)
    crows, ccols = cone.c_rows, cone.c_cols
    coef = cone.c_double_coef.to(f32)
    nnz_full, nnz_up = csr32.nnz, cone.c_nnz
    Y, U, V = rnd(n, r), rnd(n, r), rnd(n, r)
    Y64, U64, V64 = Y.double(), U.double(), V.double()
    c_sp = sparse_csr(csr32.indptr, csr32.indices, csr32.vals, (n, n))
    ref1 = K.spmm_sym_csr_plain(csr64, Y64, 1.0)
    shape = f"n={n} r={r}"
    rows["spmm_sym_csr"] = _measure32(
        "spmm_sym_csr", shape,
        lambda: K.spmm_sym_csr(csr32, Y, 1.0),
        lambda: K.spmm_sym_csr_plain(csr32, Y, 1.0), lambda: ref1,
        (n + 1) * i4 + nnz_full * (i4 + f4) + 2 * n * r * f4,
        2.0 * nnz_full * r + n * r, lambda: torch.sparse.mm(c_sp, Y),
        _lib_close("spmm_sym_csr", ref1))
    ref2 = K.diag_rowdot_plain(U64, V64, dv.double(), 2.0, second=True)
    rows["diag_rowdot"] = _measure32(
        "diag_rowdot", shape,
        lambda: K.diag_rowdot(U, V, dv, 2.0, second=True),
        lambda: K.diag_rowdot_plain(U, V, dv, 2.0, second=True),
        lambda: ref2, 2 * n * r * f4 + n * f4 + 2 * n * f4,
        4.0 * n * r + 3 * n, lambda: torch.linalg.vecdot(U, V),
        _lib_close("diag_rowdot", torch.sum(U64 * V64, dim=-1)))
    rows["diag_rowdot"]["plan"] = check_k2_plans(K, U, V, dv,
                                                 f"maxcut {shape}")
    ref3 = K.diag_normal_matvec_plain(U64, V64, dv.double())
    rows["diag_normal_matvec"] = _measure32(
        "diag_normal_matvec", shape,
        lambda: K.diag_normal_matvec(U, V, dv),
        lambda: K.diag_normal_matvec_plain(U, V, dv), lambda: ref3,
        3 * n * r * f4 + n * f4, 4.0 * n * r + 2 * n)
    rows["diag_normal_matvec"]["plan"] = check_k3_plans(K, U, V, dv,
                                                        f"maxcut {shape}")
    coef64 = coef.double()
    ref4 = K.sym_contract_sum_plain(crows, ccols, coef64, U64, U64)
    terms = torch.sum(torch.abs(coef64 * torch.sum(
        U64[crows.long()] * U64[ccols.long()], dim=-1)))
    rows["sym_contract_sum"] = _measure32(
        "sym_contract_sum", shape,
        lambda: K.sym_contract_sum(crows, ccols, coef, U, U),
        lambda: K.sym_contract_sum_plain(crows, ccols, coef, U, U),
        lambda: ref4, nnz_up * (2 * i4 + f4) + n * r * f4 + 8,
        (2.0 * r + 1) * nnz_up, scale=float(terms))
    rows["sym_contract_sum"].update(check_k4_plans(
        K, crows, ccols, coef, U, U, f"float32 {shape}"))
    # ---- K5, K6: the matrix-completion cone, n = 10^4, rank 19 ----
    seg32, acsr32 = as_dtype(mc_cone.a_seg, f32), as_dtype(mc_cone.a_csr, f32)
    seg64, acsr64 = as_dtype(seg32, f64), as_dtype(acsr32, f64)
    n, m, r = seg32.n, seg32.m, MC_REPORT_RANK
    nnz, slots = seg32.nnz, acsr32.nnz
    U, V, w = rnd(n, r), rnd(n, r), rnd(m)
    U64, V64 = U.double(), V.double()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        s_w = torch.sparse_coo_tensor(
            torch.stack([acsr32.row_ids, acsr32.indices.long()]),
            w[acsr32.cid.long()] * acsr32.vals,
            size=(n, n)).coalesce().to_sparse_csr()
    shape = f"matcomp n={n} m={m} nnz={nnz} r={r}"
    ref5 = K.coo_contract_segsum_plain(seg64, U64, V64, pair=True)
    i5 = k56_instance(K, "coo_contract_segsum", r, seg32, f32)
    i6 = k56_instance(K, "spmm_constr_csr", r, acsr32, f32)
    rows["coo_contract_segsum"] = _measure32(
        "coo_contract_segsum", f"pair {shape} {i5}",
        lambda: K.coo_contract_segsum(seg32, U, V, pair=True),
        lambda: K.coo_contract_segsum_plain(seg32, U, V, pair=True),
        lambda: ref5,
        (m + 1) * i4 + nnz * (2 * i4 + f4) + 2 * n * r * f4 + 2 * m * f4,
        6.0 * nnz * r)
    ref6 = K.spmm_constr_csr_plain(acsr64, w.double(), U64)
    rows["spmm_constr_csr"] = _measure32(
        "spmm_constr_csr", f"alone {shape} slots={slots} {i6}",
        lambda: K.spmm_constr_csr(acsr32, w, U),
        lambda: K.spmm_constr_csr_plain(acsr32, w, U), lambda: ref6,
        (n + 1) * i4 + slots * (2 * i4 + f4) + m * f4 + 2 * n * r * f4,
        2.0 * slots * r + slots, lambda: torch.sparse.mm(s_w, U),
        _lib_close("spmm_constr_csr", ref6))
    rows["coo_contract_segsum"]["instance"] = i5
    rows["spmm_constr_csr"]["instance"] = i6
    # ---- K7, K8: the multi-block + LP path's LP cone ----
    lp32 = as_dtype(lp, f32)
    lp64 = as_dtype(lp32, f64)
    m, n_cols, nnz = lp32.m, lp32.n_cols, lp32.nnz
    u, v, w = rnd(n_cols), rnd(n_cols), rnd(m)
    a_sp = sparse_csr(lp32.row_ptr, lp32.row_col, lp32.row_val, (m, n_cols))
    at_sp = sparse_csr(lp32.col_ptr, lp32.col_cid, lp32.col_val, (n_cols, m))
    w1 = w[:, None].contiguous()
    shape = f"multiblock+lp m={m} cols={n_cols} nnz={nnz}"
    ref7 = K.lp_constr_segsum_plain(lp64, u.double(), v.double(), pair=True)
    rows["lp_constr_segsum"] = _measure32(
        "lp_constr_segsum", f"pair {shape}",
        lambda: K.lp_constr_segsum(lp32, u, v, pair=True),
        lambda: K.lp_constr_segsum_plain(lp32, u, v, pair=True),
        lambda: ref7,
        (m + 1) * i4 + nnz * (i4 + f4) + 2 * n_cols * f4 + 2 * m * f4,
        5.0 * nnz,
        lambda: torch.sparse.mm(
            a_sp, torch.stack((2.0 * u * v, v * v), dim=1)).unbind(1),
        _lib_close("lp_constr_segsum", ref7))
    check_k7_plans(K, lp32, u, v, f"float32 {shape}")
    ref8 = K.lp_col_wsum_plain(lp64, w.double(), 0.37)
    rows["lp_col_wsum"] = _measure32(
        "lp_col_wsum", shape,
        lambda: K.lp_col_wsum(lp32, w, 0.37),
        lambda: K.lp_col_wsum_plain(lp32, w, 0.37), lambda: ref8,
        (n_cols + 1) * i4 + nnz * (i4 + f4) + m * f4 + 2 * n_cols * f4,
        2.0 * nnz + 2 * n_cols,
        lambda: 0.37 * lp32.c + torch.sparse.mm(at_sp, w1).reshape(-1),
        _lib_close("lp_col_wsum", ref8))
    return rows


@torch.no_grad()
def check_gnn_widths(K, edge_index, n, dev):
    """The width phase: K9 (serve, and with keep-scale and lse) and K11 on
    the edges of ``theta_n300_d75`` at every GNN_WIDTHS heads x channels,
    K10 (serve, and with keep-scale, stats and tie counts) and K12 on its
    nodes at every POOL_WIDTHS, on seeded inputs, each against its plain
    version evaluated in float64 (phases 9 and 12's GNN_TOL).  Returns
    {name: {width: row}} (the dropout cases for K9 / K10's training
    instances, K11 and K12)."""
    g = K.EdgeCSR.from_edge_index(edge_index.to(dev), n)
    e_all, n_real = g.n_slots, g.n_real
    gen = torch.Generator(device=dev).manual_seed(2033)
    f4 = 4
    out = {k: {} for k in TRAIN_KERNELS}

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    for heads, ch in GNN_WIDTHS:
        hc = heads * ch
        args = (rnd(n, hc), rnd(n, hc), rnd(n_real, hc), rnd(hc),
                rnd(heads, ch, scale=0.5))
        args64 = tuple(t.double() for t in args)
        keep = _keep((e_all, heads), dev, 7)
        tag = (f"width {heads}x{ch} (H*C={hc}) {k9_plan_text(K, args[-1])} "
               f"N={n} E'={e_all}")
        fwd_bytes = ((n + 1) * f4 + 2 * e_all * f4 + 3 * n * hc * f4
                     + n_real * hc * f4 + hc * f4 + hc * f4)
        _measure_gnn("gatv2_softmax_agg", tag,
                     lambda: K.gatv2_softmax_agg(g, *args),
                     lambda: K.gatv2_softmax_agg_plain(g, *args),
                     lambda: K.gatv2_softmax_agg_plain(g, *args64),
                     fwd_bytes, 8.0 * e_all * hc)
        out64, lse64 = K._gatv2_plain(g, *args64, keep.double())
        # keep read, lse and the scores written
        train_bytes = fwd_bytes + 2 * e_all * heads * f4 + n * heads * f4
        out["gatv2_softmax_agg"][f"{heads}x{ch}"] = _measure_gnn(
            "gatv2_softmax_agg", f"{tag} train (keep, lse, scores)",
            lambda: k9_train(K, g, args, keep)[0],
            lambda: K._gatv2_plain(g, *args, keep)[0], lambda: out64,
            train_bytes, 9.0 * e_all * hc)
        o, lse, sc = k9_train(K, g, args, keep)
        lse_err = float((lse.double() - lse64).abs().max()
                        / lse64.abs().max())
        require(lse_err <= GNN_TOL, f"K9 {tag}: lse error {lse_err:.2e}")
        check_k9_plans(K, g, args, None, f"width {heads}x{ch}")
        check_k9_plans(K, g, args, keep, f"width {heads}x{ch}")
        dout = rnd(n, hc)
        bwd_bytes = (train_bytes + (n + 1) * f4 + e_all * f4 + n * hc * f4
                     + 2 * n * hc * f4 + n_real * hc * f4 + 2 * hc * f4)
        p11 = k11_plan_text(K, heads, ch)
        out["gatv2_softmax_agg_bwd"][f"{heads}x{ch}"] = _measure_gnn(
            "gatv2_softmax_agg_bwd", f"{tag} {p11}",
            lambda: K.gatv2_softmax_agg_bwd(g, *args, keep, lse, o, dout,
                                            sc),
            lambda: K.gatv2_softmax_agg_bwd_plain(g, *args, keep, lse, o,
                                                  dout, sc),
            lambda: K.gatv2_softmax_agg_bwd_plain(
                g, *args64, keep.double(), lse.double(), o.double(),
                dout.double(), sc.double()),
            bwd_bytes, 17.0 * e_all * hc)
        out["gatv2_softmax_agg_bwd"][f"{heads}x{ch}"]["plan"] = p11
        check_gatv2_chain(K, g, args, keep, dout, f"width {heads}x{ch}")
    seg = K.GraphSegments.from_counts((n,), dev)
    for d in POOL_WIDTHS:
        x, score = rnd(n, d), rnd(n, scale=3.0)
        keep = _keep((n,), dev, 8)
        ref = K._graph_pool_plain(seg, x.double(), score.double(),
                                  keep.double())
        tag = f"width d={d} N={n} chunks={seg.n_chunks}"
        check_k10_plans(K, seg, x, score, None, False, tag)
        plan10 = check_k10_plans(K, seg, x, score, keep, True, tag)
        pool_bytes = (n * d + 2 * n + 4 + 3 * seg.n_chunks + 4 * d + 2) * f4
        _measure_gnn("graph_pool", tag,
                     lambda: K.graph_pool(seg, x, score),
                     lambda: K.graph_pool_plain(seg, x, score),
                     lambda: K.graph_pool_plain(seg, x.double(),
                                                score.double()),
                     pool_bytes - (n + d) * f4, 5.0 * n * d + 4.0 * n)
        out["graph_pool"][f"d={d}"] = _measure_gnn(
            "graph_pool", f"{tag} train (keep, stats, ties)",
            lambda: K._graph_pool_forward(seg, x, score, keep, True)[0],
            lambda: K.graph_pool_plain(seg, x, score, keep),
            lambda: ref[0], pool_bytes, 6.0 * n * d + 4.0 * n)
        out["graph_pool"][f"d={d}"]["plan"] = plan10
        o, stats, ties = K._graph_pool_forward(seg, x, score, keep, True)
        require(torch.equal(ties.double(), ref[2]),
                f"K10 {tag}: tie counts differ")
        dpool = rnd(1, 3 * d)
        out["graph_pool_bwd"][f"d={d}"] = _measure_gnn(
            "graph_pool_bwd", tag,
            lambda: K.graph_pool_bwd(seg, x, score, keep, o, stats, ties,
                                     dpool),
            lambda: K.graph_pool_bwd_plain(seg, x, score, keep, o, stats,
                                           ties, dpool),
            lambda: K.graph_pool_bwd_plain(
                seg, x.double(), score.double(), keep.double(), o.double(),
                stats.double(), ties.double(), dpool.double()),
            (2 * n * d + 3 * n + 4 + 3 * seg.n_chunks + 7 * d + 2) * f4,
            6.0 * n * d)
        out["graph_pool_bwd"][f"d={d}"]["plan"] = check_k12_plans(
            K, (seg, x, score, keep, o, stats, ties, dpool), tag)
    return out


def run_train_path(K, dev, tmp):
    """Phase 12: the training entry point, 2 epochs at full width on the
    whole dataset with every other flag at its default, the counters set to
    0 just before and read just after; then ``infer`` with the checkpoint it
    wrote.  The entry point's own steps are timed, each followed by a
    synchronize (it reads each step's loss on the host anyway); its first
    epoch runs plain and its second under the profiler.  An epoch's wall
    runs from the training loop's start to the validation's, batch loading
    and collating included.  Returns the entry point's counts."""
    from torch.profiler import ProfilerActivity, profile

    from ltr_lowrank_sdp_torch import infer, train
    from ltr_lowrank_sdp_torch.data.loader import (create_splits,
                                                   iterate_batches)

    out = os.path.join(tmp, "train")
    argv = ["--root", DATASET, "--epochs", str(TRAIN_EPOCHS), "--output-dir",
            out]
    args = train.build_argparser().parse_args(argv)
    ds, tr_idx, va_idx, te_idx = create_splits(DATASET, seed=args.seed)
    n_train = sum(1 for ep in range(TRAIN_EPOCHS) for _ in iterate_batches(
        ds, tr_idx, args.batch_size, shuffle=True, seed=args.seed + ep))
    n_val = sum(1 for _ in iterate_batches(ds, va_idx, args.batch_size))
    n_test = sum(1 for _ in iterate_batches(ds, te_idx, args.batch_size))

    steps = []              # (epoch, seconds, graph names, edges)
    loops, evals = [], []   # training loops' and evaluations' start times
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    step_fn, eval_fn, batches_fn = (train.train_step, train.evaluate,
                                    train.iterate_batches)

    def timed_step(model, opt, b, *rest):
        t0 = time.perf_counter()
        loss = step_fn(model, opt, b, *rest)
        torch.cuda.synchronize()
        steps.append((len(loops) - 1, time.perf_counter() - t0, b.names,
                      b.edge_index.shape[1]))
        return loss

    def timed_batches(*a, **kw):
        if kw.get("shuffle"):               # the training loop of an epoch
            torch.cuda.synchronize()
            loops.append(time.perf_counter())
            if len(loops) == 2:
                prof.start()
        return batches_fn(*a, **kw)

    def timed_eval(*a, **kw):
        torch.cuda.synchronize()
        evals.append(time.perf_counter())
        if len(evals) == 2:
            prof.stop()
        return eval_fn(*a, **kw)

    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    t = time.perf_counter()
    train.train_step, train.evaluate, train.iterate_batches = (
        timed_step, timed_eval, timed_batches)
    try:
        rc = train.main(argv)
    finally:
        train.train_step, train.evaluate, train.iterate_batches = (
            step_fn, eval_fn, batches_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = K.counts()
    peak = torch.cuda.max_memory_allocated()
    require(rc == 0, "train exits 0")
    require_counts("train", counts, TRAIN_KERNELS)
    layers = args.num_gnn_layers
    forwards = n_train + TRAIN_EPOCHS * n_val + 2 * n_test
    print(f"[train] {TRAIN_EPOCHS} epochs, {n_train} training steps, "
          f"{n_val} val and {n_test} test batches; K9 / K10 launches "
          f"expected {layers * forwards} / {forwards}, K11 / K12 "
          f"{layers * n_train} / {n_train}", flush=True)
    require(len(steps) == n_train and len(loops) == TRAIN_EPOCHS,
            "train: the entry point ran every training batch")
    require(counts["gatv2_softmax_agg"][0] == layers * forwards
            and counts["graph_pool"][0] == forwards
            and counts["gatv2_softmax_agg_bwd"][0] == layers * n_train
            and counts["graph_pool_bwd"][0] == n_train,
            "train: K9 / K11 once per GATv2 layer and batch, K10 / K12 once "
            "per batch")
    for name in ("model.msgpack", "config.json", "eval_report.txt",
                 "eval_predictions.json", "training_log.json"):
        require(os.path.exists(os.path.join(out, name)), f"train: {name}")
    with open(os.path.join(out, "training_log.json")) as f:
        log = json.load(f)
    losses = [h["train_loss"] for h in log["history"]]
    require(len(losses) == TRAIN_EPOCHS and all(
        math.isfinite(v) for v in losses), "train: finite losses")
    print(f"[train] entry point wall {wall:.2f} s, peak device memory "
          f"{peak / 2**30:.3f} GiB, train_loss {losses}, val_log_mae "
          f"{[h['val_log_mae'] for h in log['history']]}, best "
          f"{log['best_val_log_mae']}", flush=True)
    for ep in range(TRAIN_EPOCHS):
        mine = [(s, names, e) for k, s, names, e in steps if k == ep]
        secs = sorted(s for s, _, _ in mine)
        big = [s for s, names, _ in mine if BIG_GRAPH in names]
        require(len(big) == 1, "train: MC_600x600_r5 forms one batch")
        ep_wall = evals[ep] - loops[ep]
        print(f"[train-epoch] epoch {ep}"
              f"{' (under the profiler)' if ep == 1 else ''}: {len(mine)} "
              f"steps, epoch wall {ep_wall:.3f} s (steps {sum(secs):.3f} s, "
              f"the rest loading and collating on the host), step median "
              f"{secs[len(secs) // 2] * 1e3:.1f} ms, max "
              f"{secs[-1] * 1e3:.1f} ms, the {BIG_GRAPH} step "
              f"{big[0] * 1e3:.1f} ms", flush=True)
        for s, names, e in mine:
            print(f"[train-epoch] epoch {ep} step {s * 1e3:8.1f} ms  "
                  f"E={e:9d}  {len(names)} graphs")
    print_profile(prof, evals[1] - loops[1], "train-profile",
                  f"the entry point's epoch 1 "
                  f"({sum(1 for k, *_ in steps if k == 1)} steps)")

    # the checkpoint just written serves
    res = os.path.join(tmp, "train-infer.json")
    K.reset_counts()
    require(infer.main(["-c", out, "--root", DATASET, "-i", SERVE_GRAPH,
                        "--output", res]) == 0, "infer with the new "
                                                "checkpoint exits 0")
    require_counts("train-infer", K.counts(), GNN_KERNELS, per_graph=1)
    with open(res) as f:
        pred = json.load(f)
    require(pred["schedule_length"] >= 1
            and len(pred["schedule"]) == pred["schedule_length"],
            "train-infer: a schedule")
    print(f"[train-infer] {SERVE_GRAPH} with the new checkpoint: "
          f"{pred['schedule']}", flush=True)
    return counts


def require_counts(tag, counts, launched, per_graph=None):
    """No plain version ran; exactly the kernels ``launched`` were launched,
    K9 three and K10 one time per graph when ``per_graph`` is given."""
    print(f"[{tag}] counts {json.dumps(counts)}", flush=True)
    for name, (launches, plain_calls) in counts.items():
        require(plain_calls == 0,
                f"{name}'s plain version ran on the {tag} path")
        require((launches > 0) == (name in launched),
                f"{name}: {launches} launches on the {tag} path")
    if per_graph is not None:
        require(counts["gatv2_softmax_agg"][0] == 3 * per_graph
                and counts["graph_pool"][0] == per_graph,
                f"{tag}: K9 three and K10 one launch per graph")


def run_serve_path(K, dev, tmp):
    """Phase 10.  Returns {path: counts} of the serve path's two runs that
    the kernels line reports: ``infer`` on SERVE_GRAPH and ``predict`` on
    BIG_GRAPH."""
    from ltr_lowrank_sdp_torch import infer
    from ltr_lowrank_sdp_torch.data.loader import _load_graph_file
    from ltr_lowrank_sdp_torch.models.checkpoint import (load_model,
                                                         predict_raw)

    def run(tag, args, device):
        out = os.path.join(tmp, f"{tag}-{device}.json")
        K.reset_counts()
        t = time.perf_counter()
        require(infer.main(["-c", CKPT, "--root", DATASET, *args, "--output",
                            out, "--device", device]) == 0,
                f"{tag}: infer exits 0")
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = K.counts()
        with open(out) as f:
            payload = json.load(f)
        print(f"[{tag}] {device}: infer wall {wall:.3f} s", flush=True)
        return payload, counts

    gpu, serve_counts = run("serve", ["-i", SERVE_GRAPH], "cuda")
    require_counts("serve", serve_counts, GNN_KERNELS, per_graph=1)
    cpu, _ = run("serve", ["-i", SERVE_GRAPH], "cpu")
    print(f"[serve] {SERVE_GRAPH}: card {gpu['schedule']} "
          f"({gpu['schedule_length']} steps), CPU {cpu['schedule']}")
    require(gpu == cpu, "serve: the card's schedule is the CPU run's")

    gpu, batch_counts = run("serve-batch", ["--batch"], "cuda")
    require(len(gpu) > 0, "serve-batch: the test split has graphs")
    require_counts("serve-batch", batch_counts, GNN_KERNELS,
                   per_graph=len(gpu))
    cpu, _ = run("serve-batch", ["--batch"], "cpu")
    for name, row in gpu.items():
        print(f"[serve-batch] {name}: card {row['pred']}, CPU "
              f"{cpu[name]['pred']}, ground truth {row['gt']}")
    require(gpu == cpu, "serve-batch: the card's predictions are the CPU "
                        "run's")

    # full width on the largest dataset graph, cold and warm
    graph = _load_graph_file(os.path.join(DATASET, "proc",
                                          f"{BIG_GRAPH}.npz"))
    model, _ = load_model(CKPT, device=dev)
    K.reset_counts()
    t = time.perf_counter()
    raw, L = predict_raw(model, graph)
    cold = time.perf_counter() - t
    big_counts = K.counts()
    require_counts("serve-mc600", big_counts, GNN_KERNELS, per_graph=1)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    raw2, L2 = predict_raw(model, graph)
    warm = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    require(L2 == L and (raw2 == raw).all(), "serve-mc600: warm == cold")
    print(f"[serve-mc600] {BIG_GRAPH}: N={graph['x'].shape[0]} E="
          f"{graph['edge_index'].shape[1]}; predict cold {cold:.4f} s, warm "
          f"{warm:.4f} s, peak device memory {peak / 2**30:.3f} GiB",
          flush=True)
    profile_call(lambda: predict_raw(model, graph), "serve-mc600-profile",
                 "predict")
    t = time.perf_counter()
    raw_cpu, L_cpu = predict_raw(load_model(CKPT, device="cpu")[0], graph)
    print(f"[serve-mc600] CPU predict {time.perf_counter() - t:.2f} s")
    rel = float(abs(raw - raw_cpu).max() / abs(raw_cpu).max())
    print(f"[serve-mc600] raw card {raw.tolist()}")
    print(f"[serve-mc600] raw CPU  {raw_cpu.tolist()}")
    print(f"[serve-mc600] length card {L}, CPU {L_cpu}; max rel diff of the "
          f"raw schedule {rel:.3e} (tol {PREDICT_RTOL:g})", flush=True)
    require(L == L_cpu, "serve-mc600: the predicted length is the CPU run's")
    require(bool((abs(raw - raw_cpu) <= PREDICT_RTOL * abs(raw_cpu)).all()),
            "serve-mc600: the raw schedule is within 1e-4 of the CPU run's")
    for k, (a, b) in enumerate(zip(raw[:L], raw_cpu[:L])):
        if round(a) == round(b):
            continue
        near_half = abs(abs(b - int(b)) - 0.5) <= HALF_INTEGER_BAND
        print(f"[serve-mc600] step {k}: card {a:.6f} and CPU {b:.6f} round "
              f"apart ({'within' if near_half else 'outside'} "
              f"{HALF_INTEGER_BAND:g} of a half-integer)")
        require(near_half, "serve-mc600: the rounded schedule differs")
    return {"serve": serve_counts, "serve_mc600": big_counts}


def run_predict_then_solve(K, tmp, optimal):
    """Phase 11: the benchmark twin on one generated theta instance."""
    from ltr_lowrank_sdp_torch import benchmark
    from ltr_lowrank_sdp_torch.testing import theta_sdpa, write_sdpa

    inst_dir = os.path.join(tmp, "bench")
    name = f"theta{BENCH_THETA[0]}_gen"
    path = os.path.join(inst_dir, "hansmittel", f"{name}.dat-s")
    os.makedirs(os.path.dirname(path))
    write_sdpa(path, theta_sdpa(*BENCH_THETA))
    out = os.path.join(inst_dir, "results")
    K.reset_counts()
    t = time.perf_counter()
    require(benchmark.main(["--checkpoint", CKPT, "--instances", inst_dir,
                            "--root", DATASET, "--subtypes", "hansmittel",
                            "--output-dir", out]) == 0,
            "benchmark exits 0")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = K.counts()
    require_counts("predict-solve", counts, GNN_KERNELS + DENSE_KERNELS,
                   per_graph=1)
    with open(os.path.join(out, f"{name}_r_sched.json")) as f:
        sched = json.load(f)
    require(set(sched) == {"rank_schedule", "schedule_length"},
            "predict-solve: r_sched.json keys")
    with open(os.path.join(out, "results.json")) as f:
        row = json.load(f)[name]
    require(set(row) == {"name", "subtype", "n", "default", "schedule",
                         "speedup", "obj_rel_diff"},
            "predict-solve: results.json row keys")
    pinf_lim, gap_lim, dinf_lim = (1e-5, 5e-5, 5e-5)
    for side in ("default", "schedule"):
        r = row[side]
        print(f"[predict-solve] {side}: {r['status']} in "
              f"{r['solve_time_sec']:.3f} s, pobj {r['primal_obj']:.10e}, "
              f"pinf_l1 {r['pinf_l1']:.3e} gap {r['gap']:.3e} dinf_l1 "
              f"{r['dinf_l1']:.3e}", flush=True)
        require(set(r) == {"solve_time_sec", "primal_obj", "gap", "pinf_l1",
                           "dinf_l1", "status"},
                f"predict-solve: {side} keys")
        require(r["status"] in [s.value for s in optimal],
                f"predict-solve: {side} status {r['status']}")
        # a primal_optimal solve is one whose dual is not certified: the
        # dual limit holds where the status claims it
        require(r["pinf_l1"] <= pinf_lim and r["gap"] <= gap_lim
                and (r["status"] != "primal_dual_optimal"
                     or r["dinf_l1"] <= dinf_lim)
                and r["solve_time_sec"] < benchmark.DEFAULT_TIMEOUT,
                f"predict-solve: {side} outside phase 7's error limits or "
                f"stopped by the time limit")
    print(f"[predict-solve] theta_sdpa{BENCH_THETA}: schedule "
          f"{sched['rank_schedule']} ({sched['schedule_length']} steps), "
          f"speedup {row['speedup']:.4f}, obj_rel_diff "
          f"{row['obj_rel_diff']:.3e}, benchmark wall {wall:.2f} s",
          flush=True)


def run_main_path(tag, path, flags, launched, statuses, limits, dev,
                  n_blocks=1, repeat=True, profile=True, f32=False,
                  pobj_rtol=1e-8):
    """Drive one main path through the CLI with the launch counters set to 0
    just before and read just after, check the result by the repo's own
    means, then (with ``repeat``) solve again warm with a new Solver and
    again with the same one, and (with ``profile``) once more with its graph
    replays timed (``graph_spans``).  With ``f32`` the flags ask for float32: every
    kernel of ``launched`` must have float32 launches (a float64 polish adds
    float64 ones).  Returns the counts of the CLI run, its result and its
    float32 launches per kernel."""
    from ltr_lowrank_sdp_torch import cli
    from ltr_lowrank_sdp_torch.ops import kernels as K
    from ltr_lowrank_sdp_torch.problem import load_problem
    from ltr_lowrank_sdp_torch.solver.common import host_metrics_f64
    from ltr_lowrank_sdp_torch.solver.driver import Solver

    jpath = os.path.join(os.path.dirname(path), f"{tag}_solution.json")
    K.reset_counts()
    EAGER_STEPS.clear()
    t = time.perf_counter()
    res = cli.main([path, *flags, "--jsonfile", jpath])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = K.counts()
    print(f"[{tag}] host reads {res.host_syncs}, graph replays "
          f"{res.graph_replays}, graphs (name, nodes, instantiation ms) "
          f"{json.dumps(res.graphs)}; eager loop calls {dict(EAGER_STEPS)}",
          flush=True)
    require(res.graph_replays > 0 and not EAGER_STEPS,
            f"{tag}: the solve left the replayed loops")
    counts32 = K.counts_f32()
    K1_FOLDS[tag] = K.KERNELS["spmm_sym_csr"].folds
    print(f"[{tag}] counts {json.dumps(counts)}")
    if f32:
        print(f"[{tag}] float32 launches {json.dumps(counts32)}, float64 "
              f"polish runs {res.polish_runs}")
        for name in launched:
            require(counts32.get(name, 0) > 0,
                    f"{name} had no float32 launch on the {tag} path")
    print(f"[{tag}] cli wall {wall:.3f} s, solve {res.solve_time:.3f} s, "
          f"stages {json.dumps({k: round(v, 4) for k, v in res.stage_times.items()})}")
    print(f"[{tag}] status {res.status.value}, ALM outer "
          f"{res.alm_outer_iters} inner {res.alm_inner_iters}, ADMM "
          f"{res.admm_iters}, CG total {res.cg_iters}, host syncs "
          f"{res.host_syncs}, final ranks {res.final_ranks}", flush=True)
    for name, (launches, plain_calls) in counts.items():
        if name in launched:
            require(launches > 0, f"{name} was not launched on the {tag} path")
        else:
            require(launches == 0, f"{name} ran on the {tag} path")
        require(plain_calls == 0,
                f"{name}'s plain version ran on the {tag} path")
    require(res.status in statuses, f"{tag}: status {res.status.value}")
    require(len(res.final_ranks) == n_blocks,
            f"{tag}: one final rank per block")
    t = time.perf_counter()
    prob = load_problem(path)
    print(f"[{tag}] load_problem {time.perf_counter() - t:.3f} s")
    Ravg = tuple(0.5 * (u + v) for u, v in zip(res.U, res.V))
    lp_avg = None if res.ulp is None else 0.5 * (res.ulp + res.vlp)
    require((lp_avg is None) == (prob.lp is None),
            f"{tag}: LP factors returned with an LP cone")
    pobj, dobj, pinf, pinf_inf, gap = host_metrics_f64(
        prob, Ravg, Ravg, lp_avg, lp_avg, res.dual, res.obj_scale)
    print(f"[{tag}] host f64: pobj {pobj:.10e} dobj {dobj:.10e} "
          f"pinf_l1 {pinf:.3e} gap {gap:.3e}; solver dinf_l1 "
          f"{res.dinf_l1:.3e}")
    pinf_lim, gap_lim, dinf_lim = limits
    require(pinf <= pinf_lim and gap <= gap_lim and res.dinf_l1 <= dinf_lim,
            f"{tag}: DIMACS errors above {limits}")
    print(f"[{tag}] device pobj against the host recomputation: "
          f"{abs(pobj - res.pobj) / abs(pobj):.3e} relative (tol "
          f"{pobj_rtol:g})")
    require(abs(pobj - res.pobj) <= pobj_rtol * abs(pobj),
            f"{tag}: device pobj disagrees with the host recomputation")
    with open(jpath) as f:
        payload = json.load(f)
    require(set(payload) == {"problem_id", "file_path", "metrics",
                             "trajectory"}, f"{tag}: trajectory JSON keys")
    require(set(payload["trajectory"]) == {"phase_1", "phase_2"},
            f"{tag}: trajectory phases")
    if not repeat:
        return counts, res, counts32

    # the same solve again, warm, then again on the same Solver, then once
    # more under the profiler
    params = cli.params_from_args(cli.build_arg_parser().parse_args(
        [path, *flags]))
    solver = Solver(prob, params, device=dev)
    t = time.perf_counter()
    warm = solver.solve()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    print(f"[{tag}] warm solve {warm_s:.3f} s (status {warm.status.value}, "
          f"ALM inner {warm.alm_inner_iters}, ADMM {warm.admm_iters}, "
          f"float64 polish runs {warm.polish_runs}; a new Solver captures "
          f"its graphs: {len(warm.graphs)})")
    # the same Solver again: its phases keep their captured graphs
    t = time.perf_counter()
    again = solver.solve()
    torch.cuda.synchronize()
    print(f"[{tag}] solve again on the same Solver {time.perf_counter() - t:.3f}"
          f" s (graphs reused, {len(again.graphs)} captured; host reads "
          f"{again.host_syncs}, graph replays {again.graph_replays})",
          flush=True)
    require((again.pobj, again.alm_inner_iters, again.admm_iters)
            == (warm.pobj, warm.alm_inner_iters, warm.admm_iters),
            f"{tag}: a solve on reused graphs differs")
    if not profile:
        return counts, res, counts32
    graph_spans(solver, "profile" if tag == "main" else f"{tag}-profile")
    if tag == "main":
        check_profiler_refused(prob, params, dev)
    return counts, res, counts32


def graph_spans(solver, tag: str, what: str = "solve") -> None:
    """``[tag]``: one more solve with each CUDA-graph replay timed by CUDA
    events around it, no profiler (the graphs refuse it: PERF.md section
    7): the graph span share, the replays' device spans (first node to
    last, the gaps between nodes included) over the solve's wall time.  The
    kernels' own time inside the graphs is not measured."""
    from ltr_lowrank_sdp_torch.solver import devloop

    spans = []
    launch = devloop.DeviceGraph.launch

    def timed(graph):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        launch(graph)
        b.record()
        spans.append((a, b))

    devloop.DeviceGraph.launch = timed
    try:
        t = time.perf_counter()
        res = solver.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        devloop.DeviceGraph.launch = launch
    span_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    print(f"[{tag}] {what} wall {wall:.3f} s, graph span share "
          f"{100 * span_s / wall:.1f} %: {len(spans)} graph replays "
          f"{span_s:.4f} s (CUDA events, first node to last, gaps "
          f"included); status {res.status.value}", flush=True)


def check_profiler_refused(prob, params, dev) -> None:
    """``[profiler-refused]``: a new Solver's solve under ``torch.profiler``
    (host activity only) must raise before it captures a graph, with the
    reason (PERF.md section 7)."""
    from torch.profiler import ProfilerActivity, profile

    from ltr_lowrank_sdp_torch.solver.driver import Solver

    solver = Solver(prob, params, device=dev)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            solver.solve()
    except RuntimeError as e:
        msg = str(e)
    else:
        msg = ""
    require("torch.profiler is active" in msg,
            "a solve under torch.profiler did not refuse its graphs")
    print(f"[profiler-refused] a solve under torch.profiler raised: "
          f"{msg[:120]}...", flush=True)


def run_f32_paths(paths, dev):
    """Phase 7b, the ``[*-f32]`` solves: each main path again through the
    CLI with ``--dtype float32`` (the JAX package's TPU configuration), the
    counters set to 0 just before and read just after: the same status as
    its float64 run, pinf_l1 <= 1e-5 and gap <= 5e-5 recomputed in float64
    on the host, pobj within F32_POBJ_RTOL of the float64 run's, every
    kernel of the path launched on float32 values and no plain version run;
    then a warm solve.  ``paths``: (key, name, file, flags, kernels, float64
    result, blocks).  Returns {key: float32 launches per kernel}."""
    out = {}
    for key, name, path, flags, launched, res64, n_blocks in paths:
        tag = f"{name}-f32"
        _, res, counts32 = run_main_path(
            tag, path, (*flags, *F32_FLAGS), launched, (res64.status,),
            (1e-5, 5e-5, 5e-5), dev, n_blocks=n_blocks, profile=False,
            f32=True, pobj_rtol=F32_DEVICE_POBJ_RTOL)
        rel = abs(res.pobj - res64.pobj) / abs(res64.pobj)
        print(f"[{tag}] pobj {res.pobj:.10e} against the float64 run's "
              f"{res64.pobj:.10e}: {rel:.3e} relative (tol "
              f"{F32_POBJ_RTOL:g}); solve {res.solve_time:.3f} s against "
              f"{res64.solve_time:.3f} s in float64", flush=True)
        require(rel <= F32_POBJ_RTOL,
                f"{tag}: float32 pobj differs from the float64 run's")
        out[key] = counts32
    return out


def theta_solve(spec: str, limit_s: float, profile: bool, logfile,
                dtype: str = "auto") -> int:
    """``--theta-solve``: one theta instance through the CLI on the card in
    the compute dtype ``dtype``, whatever its status; the solver's rows go
    to ``logfile`` if one is named.  With ``profile``, a window of the solve
    under the profiler instead."""
    from ltr_lowrank_sdp_torch import cli
    from ltr_lowrank_sdp_torch.config import SolverParams
    from ltr_lowrank_sdp_torch.ops import kernels as K
    from ltr_lowrank_sdp_torch.solver.driver import Solver
    from ltr_lowrank_sdp_torch.testing import (theta_problem, theta_sdpa,
                                               write_sdpa)

    n, deg, seed = (int(x) for x in spec.split(","))
    print(f"[card] {card_line()}")
    K.build_kernels()
    if profile:
        print(f"[theta-profile] theta_sdpa({n}, {deg}, {seed}), the window: "
              f"a solve with a time limit of {limit_s:g} s")
        graph_spans(Solver(theta_problem(n, deg, seed),
                           SolverParams(time_sec_limit=limit_s,
                                        dtype=dtype)), "theta-profile")
        return 0
    log_flags = ("--logfile", logfile) if logfile else ()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"theta_{n}_{deg}_{seed}.dat-s")
        write_sdpa(path, theta_sdpa(n, deg, seed))
        K.reset_counts()
        t = time.perf_counter()
        with open(os.devnull, "w") as null, \
                contextlib.redirect_stdout(null):
            res = cli.main([path, "--timeSecLimit", str(limit_s),
                            "--dtype", dtype, *log_flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    print(f"[theta-solve] theta_sdpa({n}, {deg}, {seed}) dtype {dtype} "
          f"time limit {limit_s:g} s: status {res.status.value}, final ranks "
          f"{res.final_ranks}, ALM outer {res.alm_outer_iters} inner "
          f"{res.alm_inner_iters}, ADMM {res.admm_iters}, CG "
          f"{res.cg_iters}, host syncs {res.host_syncs}, pobj "
          f"{res.pobj:.10e} dobj {res.dobj:.10e} pinf_l1 {res.pinf_l1:.3e} "
          f"gap {res.gap:.3e} dinf_l1 {res.dinf_l1:.3e}, solve "
          f"{res.solve_time:.1f} s, cli wall {wall:.1f} s, stages "
          f"{json.dumps({k: round(v, 2) for k, v in res.stage_times.items()})}"
          f", counts {json.dumps(K.counts())}")
    return 0


def check_gather_rowsum(K, dev):
    """Phase 3 for K13, the port of the repo's one ``pl.pallas_call``, at the
    probe's default shape and at R = 8 and 64: against its plain version
    evaluated in float64 (max |kernel - plain| / max |plain| <= GNN_TOL),
    the same bits on two calls, timed beside the float32 plain version (one
    PyTorch call, ``index_select`` then ``sum``: also the probe's own XLA
    baseline, so it is the library yardstick too), ``torch.bincount`` then
    ``torch.mv`` (two calls, ``two_call_ms``) and the bound (idx, Y and out
    once over 3.35 TB/s); every plan there and at K13_PLAN_SHAPES
    (``[k13-plan]``), the device kernels of a call (``[k13-kernels]``).
    Returns {name: row} at the default shape."""
    from ltr_lowrank_sdp_torch.scripts.gather_probe import (probe_inputs,
                                                            skewed_indices)

    def lib_check(got, ref):
        err = float((got.double() - ref).abs().max() / ref.abs().max())
        require(err <= GNN_TOL, f"gather_rowsum: the library call is {err:.2e} "
                                f"off the float64 sum")

    report = {}
    for N, M, R in GATHER_SHAPES:
        Y, idx = probe_inputs(N, M, R, dev)
        tag = f"N={N} M={M} R={R}"
        row = _measure_gnn(
            "gather_rowsum",
            f"{tag} (gathered {M * R * 4 / 1e6:.1f} MB)",
            lambda: K.gather_rowsum(Y, idx),
            lambda: K.gather_rowsum_plain(Y, idx),
            lambda: K.gather_rowsum_plain(Y.double(), idx),
            M * 4 + N * R * 4 + R * 4, M * R,
            lib=lambda: K.gather_rowsum_plain(Y, idx), lib_check=lib_check)
        row["gathered_bytes"] = M * R * 4
        row["plan"], row["two_call_ms"] = check_k13_plans(K, Y, idx, tag)
        if not report:
            report = {"gather_rowsum": row}
            count_k13_kernels(K, Y, idx, tag)
    for N, M, R, kind in K13_PLAN_SHAPES:
        Y, idx = probe_inputs(N, M, R, dev)
        if kind is not None:
            idx = skewed_indices(N, M, kind, dev)
        check_k13_plans(K, Y, idx, f"N={N} M={M} R={R} "
                                   f"{kind or 'uniform'} indices",
                        equal=kind == "equal")
    return report


def check_k13_plans(K, Y, idx, tag, equal=False):
    """``[k13-plan]``: K13 with every plan of ``k13_plans`` (the gather and
    the counts plans) within GNN_TOL of the plain version evaluated in
    float64 (the gather on all-equal indices, ``equal``, within its float32
    rounding bound ``k13_gather_bound`` instead: 1e-5 does not hold for it
    there) and the same bits on two calls, the counts plans bitwise
    ``gather_rowsum_order``; every plan timed beside the library call and
    ``torch.bincount`` + ``torch.mv``, whose time is returned with the
    planned launch's description."""
    N, R = Y.shape
    M = idx.numel()
    ref = K.gather_rowsum_plain(Y.double(), idx)
    scale = max(float(ref.abs().max()), 1e-30)
    host = K.gather_rowsum_order(Y.cpu(), idx.cpu())
    times, errs = {}, {}
    for plan in K.k13_plans(N, M, R):
        def call(plan=plan):
            return K.gather_rowsum_with(plan, Y, idx)

        got = call()
        torch.cuda.synchronize()
        name = plan.describe()
        errs[name] = float((got.double() - ref).abs().max()) / scale
        tol = (K.k13_gather_bound(Y, idx) / scale if equal and not
               plan.counts else GNN_TOL)
        require(errs[name] <= tol, f"K13 {tag} {name}: error "
                                   f"{errs[name]:.2e} > {tol:.2e}")
        require(torch.equal(call(), got),
                f"K13 {tag} {name}: two calls gave different bits")
        require(not plan.counts or torch.equal(got.cpu(), host),
                f"K13 {tag} {name}: not the bits of gather_rowsum_order")
        times[name] = round(time_ms(call), 5)

    def two_calls():
        return torch.mv(Y.t(), torch.bincount(idx, minlength=N).to(Y.dtype))

    err = float((two_calls().double() - ref[0]).abs().max()) / scale
    require(err <= GNN_TOL, f"K13 {tag}: bincount + mv is {err:.2e} off")
    lib_ms = time_ms(lambda: K.gather_rowsum_plain(Y, idx))
    two_ms = time_ms(two_calls)
    planned = K.k13_plan(N, M, R).describe()
    within = (f"the gather within its rounding bound "
              f"{K.k13_gather_bound(Y, idx) / scale:.2e}, every other plan"
              if equal else "every plan")
    print(f"[k13-plan] {tag}: {within} within {GNN_TOL:g} of float64 and "
          f"the same bits on two calls, every counts plan the bits of "
          f"gather_rowsum_order; planned {planned} {times[planned]:.5f} ms; "
          f"ms by plan {json.dumps(times)}; errors "
          f"{json.dumps({k: f'{v:.2e}' for k, v in errs.items()})}; "
          f"index_select + sum {lib_ms:.5f} ms, bincount + mv {two_ms:.5f} "
          "ms", flush=True)
    return planned, two_ms


def count_k13_kernels(K, Y, idx, tag) -> None:
    """``[k13-kernels]``: the device kernels of one call of each plan of
    K13, exactly: the kernel nodes of a CUDA graph captured from one call
    (``testing.captured_kernel_nodes``): two, the gather and its combine,
    or the histogram and the pass."""
    from ltr_lowrank_sdp_torch.testing import captured_kernel_nodes

    N, R = Y.shape
    nodes = {p.describe(): captured_kernel_nodes(
        lambda p=p: K.gather_rowsum_with(p, Y, idx))
        for p in K.k13_plans(N, idx.numel(), R)}
    print(f"[k13-kernels] {tag}: kernel nodes in a graph captured from one "
          f"call, by plan {json.dumps(nodes)}", flush=True)
    require(all(n == 2 for n in nodes.values()),
            f"K13 {tag}: a plan launched other kernels than its own")


def run_gather_probe(K):
    """The probe twin (``scripts/gather_probe.py``) at its defaults, the
    counters set to 0 just before and read just after: K13 launched and no
    plain version run, ``kernel_ok``."""
    from ltr_lowrank_sdp_torch.scripts import gather_probe

    K.reset_counts()
    res = gather_probe.probe()
    counts = K.counts()
    print(f"[gather-probe] {json.dumps(res)}", flush=True)
    require(res["kernel_ok"] is True, "gather-probe: kernel_ok")
    require_counts("gather-probe", counts, ("gather_rowsum",))
    return counts


def shard_layouts(cone, inner, dev, D, s):
    """Shard ``s`` of ``D``'s two layouts (K5's constraint segment and K6's
    row slice) as a rank of a D-wide constraint axis builds them; no
    process group is needed to build them."""
    from ltr_lowrank_sdp_torch.parallel.mesh import Mesh
    from ltr_lowrank_sdp_torch.parallel.meshops import MeshConeOps

    mesh = Mesh(shape={"batch": 1, "constr": D},
                axis_names=("batch", "constr"), rank=s, coords=(0, s),
                device=dev, groups={"constr": None, "batch": None})
    mops = MeshConeOps(cone, inner, mesh)
    require(mops.sharded and mops.cv_seg is not None
            and mops.mm_csr is not None, f"shard {s} of {D} owns entries")
    return mops


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _ms_per_collective(calls, nbytes, device):
    """On every rank of a world after its sharded solve: the mean ms of one
    all-reduce of the solve's mean payload over the world (the solve's
    axis: its mesh has no other), or None where it issued none."""
    from ltr_lowrank_sdp_torch.parallel.mesh import collective_ms

    return (collective_ms(None, nbytes // calls, torch.device(device))
            if calls else None)


def _parallel_rank(solves, batch, device=None):
    """One rank of phase 14 and of ``[constr-nccl*]`` / ``[batch4]``: the
    sharded solve of each (problem, params) of ``solves``, then, with
    ``batch`` = (problem, R, dual, rho, steps), the batched ALM steps with
    the world on the batch axis; each twice, cold (the rank's first
    launches, as a user's first call) and warm."""
    import torch.distributed as dist

    from ltr_lowrank_sdp_torch.parallel.dryrun import (batched_steps,
                                                       sharded_solve)

    def solve(prob, params):
        o = sharded_solve(prob, params, device)
        o["ms_per_allreduce"] = _ms_per_collective(
            o["allreduce_calls"], o["allreduce_bytes"], o["device"])
        return o

    out = {"solves": [[solve(prob, params) for _ in range(2)]
                      for prob, params in solves]}
    if batch is not None:
        out["batch"] = [batched_steps(*batch, dist.get_world_size(),
                                      device=device) for _ in range(2)]
    return out


def batch_problem(B):
    """B Delaunay MaxCut instances of n = 2^14 (seeds MAIN_SEED + k),
    stacked, with seeded starting factors and zero duals."""
    from ltr_lowrank_sdp_torch.io.maxcut import maxcut_problem_from_adjacency
    from ltr_lowrank_sdp_torch.parallel.batch import batched_from_problems
    from ltr_lowrank_sdp_torch.testing import delaunay_maxcut_adjacency

    t = time.perf_counter()
    bprob = batched_from_problems([
        maxcut_problem_from_adjacency(delaunay_maxcut_adjacency(
            MAIN_N, seed=MAIN_SEED + k)) for k in range(B)])
    g = torch.Generator().manual_seed(B)
    R0 = torch.randn((B, bprob.n, BATCH_RANK), generator=g,
                     dtype=torch.float64) / math.sqrt(BATCH_RANK)
    dual0 = torch.zeros((B, bprob.n), dtype=torch.float64)
    print(f"[batch] {B} Delaunay MaxCut instances n={bprob.n}, "
          f"{bprob.c_vals.shape[1]} objective entries each (padded), rank "
          f"{BATCH_RANK}, built in {time.perf_counter() - t:.1f} s",
          flush=True)
    return bprob, R0, dual0, g


def check_sharded_solves(solves, ranks, ws, backend, tag_of) -> dict:
    """The gate of a constraint-sharded world's solves (``PERF.md`` section
    2): each of ``solves`` = (tag, problem, params, unsharded result,
    kernels, sharded), solved cold and warm on every rank of ``ranks``, has
    the unsharded solve's status and counts, pobj within PAR_POBJ_RTOL, every
    rank and run rank 0's first, its kernels launched and no plain version
    run, and its cones sharded as ``sharded`` says (dense-A cones delegate,
    as the JAX package's ``MeshConeOps`` does).  Returns {tag: rank 0's
    counts}."""
    counts = {}
    for k, (tag, _, _, ref, kernels, sharded) in enumerate(solves):
        ptag = tag_of(tag)
        o, warm = ranks[0]["solves"][k]
        rel = abs(o["pobj"] - ref.pobj) / abs(ref.pobj)
        ms = o["ms_per_allreduce"]
        print(f"[{ptag}] {backend}, {ws} rank(s) on {o['device']}, mesh "
              f"{o['mesh']}: {o['status']} pobj {o['pobj']:.12e} "
              f"(unsharded {ref.pobj:.12e}, {rel:.2e} relative, tol "
              f"{PAR_POBJ_RTOL:g}); ALM outer {o['alm_outer_iters']} "
              f"inner {o['alm_inner_iters']}, ADMM {o['admm_iters']}, CG "
              f"{o['cg_iters']} (unsharded {ref.alm_outer_iters} / "
              f"{ref.alm_inner_iters}, {ref.admm_iters}, {ref.cg_iters}); "
              f"solve cold {o['solve_time']:.3f} s, warm "
              f"{warm['solve_time']:.3f} s (unsharded, CLI "
              f"{ref.solve_time:.3f} s), host syncs {o['host_syncs']}, "
              f"all-reduces {o['allreduce_calls']} of "
              f"{o['allreduce_bytes'] / 1e6:.1f} MB on rank 0, "
              f"{'none' if ms is None else f'{ms:.4f} ms'} each (mean "
              f"payload, after the solve), stop decisions (Mesh.agree) "
              f"{o['agree_calls']}; cones sharded {o['sharded']}",
              flush=True)
        require_counts(ptag, o["counts"], kernels)
        require(o["sharded"] == sharded,
                f"{ptag}: cones sharded {o['sharded']}, expected {sharded}")
        for p in [warm] + [x for r in ranks[1:] for x in r["solves"][k]]:
            require(all(p[f] == o[f] for f in (
                "status", "pobj", "dobj", "alm_outer_iters",
                "alm_inner_iters", "admm_iters", "cg_iters")),
                    f"{ptag}: rank {p['rank']}'s solves part from rank "
                    f"0's first")
        require(o["status"] == ref.status.value,
                f"{ptag}: status {o['status']}, unsharded "
                f"{ref.status.value}")
        require((o["alm_outer_iters"], o["alm_inner_iters"],
                 o["admm_iters"], o["cg_iters"])
                == (ref.alm_outer_iters, ref.alm_inner_iters,
                    ref.admm_iters, ref.cg_iters),
                f"{ptag}: the counts differ from the unsharded solve")
        require(rel <= PAR_POBJ_RTOL,
                f"{ptag}: pobj {rel:.2e} from the unsharded solve")
        counts[ptag] = o["counts"]
    return counts


def check_batch(tag, ranks, bprob, R0, dual0, dev, ws, backend) -> dict:
    """``[tag]``: the batched steps of every rank (cold and warm) against a
    loop over the single instances on ``dev``, to BATCH_TOL of scale; one K1
    launch a step for all of a rank's instances.  Returns rank 0's
    counts."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    from ltr_lowrank_sdp_torch.parallel.batch import local_alm_steps

    B = int(R0.shape[0])
    o, warm = ranks[0]["batch"]
    require_counts(tag, o["counts"], ("spmm_sym_csr", "diag_rowdot"))
    require(o["counts"]["spmm_sym_csr"][0] == BATCH_STEPS,
            f"{tag}: one K1 launch per step for all of a rank's instances")
    K.reset_counts()
    t = time.perf_counter()
    loop = [local_alm_steps(bprob, i, i + 1, R0[i:i + 1], dual0[i:i + 1],
                            BATCH_RHO, BATCH_STEPS, dev) for i in range(B)]
    _sync(dev)
    loop_s = time.perf_counter() - t
    loop_counts = K.counts()
    err = 0.0
    for k, name in enumerate(("R", "dual", "pinf")):
        want = torch.cat([x[k] for x in loop]).cpu()
        for got in (torch.from_numpy(x[name]) for r in ranks
                    for x in r["batch"]):
            err = max(err, float((got - want).abs().max()
                                 / want.abs().max().clamp_min(1.0)))
    pinf = o["pinf"]
    print(f"[{tag}] {ws} {backend} ranks x {B // ws} instances, mesh "
          f"{o['mesh']}, {BATCH_STEPS} steps: cold {o['wall']:.3f} s, warm "
          f"{warm['wall']:.3f} s on rank 0 (layouts and gather included; K1 "
          f"{o['counts']['spmm_sym_csr'][0]}, K2 "
          f"{o['counts']['diag_rowdot'][0]} launches); the loop over "
          f"single instances on one card {loop_s:.3f} s (K1 "
          f"{loop_counts['spmm_sym_csr'][0]} launches); max difference "
          f"{err:.2e} of scale (tol {BATCH_TOL:g}); pinf "
          f"{float(pinf.min()):.3e} .. {float(pinf.max()):.3e}",
          flush=True)
    require(err <= BATCH_TOL, f"{tag}: the batched steps differ from the "
                              f"loop")
    return o["counts"]


def run_parallel_paths(K, dev, solves):
    """Phase 14: the parallel modes.  ``solves``: (tag, problem, params,
    unsharded result) of the main paths that are solved again
    constraint-sharded, at world size 1 (NCCL) and 2 (gloo, both ranks on
    this card: NCCL refuses two ranks on one GPU), one start of the ranks
    for each world size; the world-size-2 ranks then run the batched ALM
    steps with the batch axis over both.  Every rank's counters are set to 0
    just before each solve or run and read just after.  Returns ({path: rank
    0's counts}, row B: K1 on one rank's block-diagonal CSR of the batch)."""
    from ltr_lowrank_sdp_torch.parallel.batch import LocalBatch
    from ltr_lowrank_sdp_torch.parallel.dryrun import dryrun
    from ltr_lowrank_sdp_torch.parallel.launch import spawn

    bprob, R0, dual0, g = batch_problem(BATCH_B)
    # row B: the batched C Y + w o Y (JAX: a scatter-add in vmap) is K1 on
    # one rank's block-diagonal CSR of its BATCH_B // 2 instances
    lb = LocalBatch(bprob, 0, BATCH_B // 2, dev, torch.float64)
    csr, r = lb.csr, BATCH_RANK
    Y = R0[:BATCH_B // 2].reshape(-1, r).to(dev)
    w = torch.randn(csr.n, generator=g, dtype=torch.float64).to(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # "sparse CSR support is beta"
        c_sparse = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.vals,
                                           size=(csr.n, csr.n))
    row_b = _measure(
        "spmm_sym_csr", f"block-diagonal batch {BATCH_B // 2} x "
        f"n={bprob.n} r={r} nnz={csr.nnz}",
        lambda: K.spmm_sym_csr(csr, Y, 1.0, d=w),
        lambda: K.spmm_sym_csr_plain(csr, Y, 1.0, d=w),
        (csr.n + 1) * 4 + csr.nnz * 12 + 2 * csr.n * r * 8 + csr.n * 8,
        2.0 * csr.nnz * r + 2.0 * csr.n * r,
        lib=lambda: torch.sparse.mm(c_sparse, Y),
        lib_ref=lambda: K.spmm_sym_csr(csr, Y, 1.0))
    check_k1_plans(K, csr, dev, f"batch {BATCH_B // 2} x n={bprob.n}")
    del lb, csr, Y, w, c_sparse

    counts = {}
    solves = [(tag, prob, params, ref, PAR_KERNELS, [True])
              for tag, prob, params, ref in solves]
    cases = [(prob, params) for _, prob, params, *_ in solves]
    for ws, backend in PAR_RUNS:
        batch = ((bprob, R0, dual0, BATCH_RHO, BATCH_STEPS) if ws > 1
                 else None)
        t = time.perf_counter()
        ranks = spawn(_parallel_rank, ws, (cases, batch), backend=backend)
        print(f"[parallel] {ws} rank(s), {backend}: start to join "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        counts.update(check_sharded_solves(
            solves, ranks, ws, backend, lambda tag: f"{tag}-sharded{ws}"))
        if batch is not None:
            counts["batch"] = check_batch("batch", ranks, bprob, R0, dual0,
                                          dev, ws, backend)

    t = time.perf_counter()
    line = dryrun(2, "gloo")
    print(f"[dryrun] {line} ({time.perf_counter() - t:.1f} s)", flush=True)
    return counts, row_b


def check_row_kernels(K, cone_data, inner, dev, r) -> dict:
    """``[row-kernels]``: K1-K4 on each of ROW_WORLD ranks' shard layouts of
    ``inner``'s cone (built with no process group; the halo rows taken from
    the whole factor), each against its plain version on the same inputs
    (the ``[kernel]`` tolerance) and against the rank's rows of the
    unsharded operator's output; K4's partials added in rank order against
    the unsharded value.  Returns rank 0's kernels-line rows."""
    from ltr_lowrank_sdp_torch.parallel.rowshard import (RowPartition,
                                                         ShardLayout)

    t = time.perf_counter()
    part = RowPartition.for_cone(cone_data, inner, ROW_WORLD)
    print(f"[row-kernels] n={inner.n} r={r}, {ROW_WORLD} ranks (blocks of "
          f"K1's RCM order): {part.describe()}; partition "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    g = torch.Generator(device=dev).manual_seed(2025)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)

    n = inner.n
    Y, U, V, w = rnd(n, r), rnd(n, r), rnd(n, r), rnd(n)
    dv = inner.diag_val
    full = {"spmm_sym_csr": K.spmm_sym_csr(inner.c_csr, Y, 1.0, d=dv, w=w),
            "diag_rowdot": K.diag_rowdot(U, V, dv, 2.0, second=True),
            "diag_normal_matvec": K.diag_normal_matvec(U, V, dv)}
    obj_full = float(K.sym_contract_sum(inner.c_rows, inner.c_cols,
                                        inner.c_double_coef, U, U))
    f8, i4 = 8, 4
    report, parts = {}, []
    for s in range(ROW_WORLD):
        lay = ShardLayout.build(cone_data, inner, part, s)
        own, no = lay.owned, lay.n_own
        ne = no + lay.n_halo
        Ye = lay.extend(Y[own], lay.halo_from_full(Y, part)).contiguous()
        Ue = lay.extend(U[own], lay.halo_from_full(U, part)).contiguous()
        Uo, Vo, wo, dvo = U[own], V[own], w[own], lay.diag_val
        csr = lay.csr
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # "sparse CSR support is beta"
            c_sparse = torch.sparse_csr_tensor(csr.indptr, csr.indices,
                                               csr.vals, size=(no, ne))
        nk4 = int(lay.k4_rows.numel())
        tag = (f"rank {s}/{ROW_WORLD} of n={n}: {no} rows, {lay.n_halo} "
               f"halo, r={r}")
        cases = {
            "spmm_sym_csr": (
                lambda: K.spmm_sym_csr(csr, Ye, 1.0, d=dvo, w=wo),
                lambda: K.spmm_sym_csr_plain(csr, Ye, 1.0, d=dvo, w=wo),
                (no + 1) * i4 + csr.nnz * (i4 + f8) + (ne + no) * r * f8
                + 2 * no * f8, 2.0 * csr.nnz * r + 2.0 * no * r,
                lambda: torch.sparse.mm(c_sparse, Ye),
                lambda: K.spmm_sym_csr(csr, Ye, 1.0)),
            "diag_rowdot": (
                lambda: K.diag_rowdot(Uo, Vo, dvo, 2.0, second=True),
                lambda: K.diag_rowdot_plain(Uo, Vo, dvo, 2.0, second=True),
                2 * no * r * f8 + 3 * no * f8, 4.0 * no * r + 3 * no,
                lambda: torch.linalg.vecdot(Uo, Vo),
                lambda: torch.sum(Uo * Vo, dim=-1)),
            "diag_normal_matvec": (
                lambda: K.diag_normal_matvec(Uo, Vo, dvo),
                lambda: K.diag_normal_matvec_plain(Uo, Vo, dvo),
                3 * no * r * f8 + no * f8, 4.0 * no * r + 2 * no, None,
                None),
            "sym_contract_sum": (
                lambda: K.sym_contract_sum(lay.k4_rows, lay.k4_cols,
                                           lay.k4_coef, Ue, Ue),
                lambda: K.sym_contract_sum_plain(lay.k4_rows, lay.k4_cols,
                                                 lay.k4_coef, Ue, Ue),
                nk4 * (2 * i4 + f8) + ne * r * f8 + f8,
                (2.0 * r + 1) * nk4, None, None),
        }
        rows = {}
        for name, (kern, plain, nbytes, flops, lib, ref) in cases.items():
            rows[name] = _measure(name, f"[row] {tag}", kern, plain, nbytes,
                                  flops, lib, lib_ref=ref)
            if name == "sym_contract_sum":
                parts.append(float(kern()))
                continue
            got = kern()
            got = got if isinstance(got, tuple) else (got,)
            want = full[name]
            want = want if isinstance(want, tuple) else (want,)
            err = max(rel_err(a, b[own]) for a, b in zip(got, want))
            same = all(torch.equal(a, b[own]) for a, b in zip(got, want))
            print(f"[row-kernels] {name} {tag}: against the unsharded "
                  f"output's rows {err:.2e} relative (tol {KERNEL_RTOL:g}), "
                  f"bitwise equal {same}", flush=True)
            require(err <= KERNEL_RTOL,
                    f"{name} on rank {s}'s shard differs from the unsharded "
                    f"rows")
        if s == 0:
            report = rows
        del lay, csr, c_sparse, Ye, Ue
    total = parts[0]
    for x in parts[1:]:
        total += x
    rel = abs(total - obj_full) / abs(obj_full)
    print(f"[row-kernels] sym_contract_sum: the {ROW_WORLD} partials added "
          f"in rank order {total!r}, unsharded {obj_full!r} ({rel:.2e} "
          f"relative, tol {KERNEL_RTOL:g})", flush=True)
    require(rel <= KERNEL_RTOL, "K4's shard partials miss the unsharded sum")
    return report


def _row_line(tag, backend, o, ref_text=""):
    print(f"[{tag}] {backend}, {o['world']} rank(s) on {o['device']}: "
          f"{o['status']} pobj {o['pobj']:.12e} gap {o['gap']:.3e} pinf_l1 "
          f"{o['pinf_l1']:.3e} dinf_l1 {o['dinf_l1']:.3e}; ALM outer / "
          f"inner, ADMM, CG {o['counts']} ({ref_text}); final "
          f"ranks {o['final_ranks']}; solve {o['solve_time']:.3f} s, stages "
          f"{json.dumps({k: round(v, 4) for k, v in o['stage_times'].items()})}"
          f"; host syncs {o['host_syncs']}; collectives "
          f"{o['collectives']} of {o['collective_bytes'] / 1e6:.3f} MB on "
          f"this rank; peak device memory "
          f"{o.get('peak_bytes', 0) / 2 ** 30:.2f} GiB; partition "
          f"{o['partitions']}", flush=True)


def _require_row(tag, o, ranks, ref_status, ref_counts, ref_pobj):
    rel = abs(o["pobj"] - ref_pobj) / abs(ref_pobj)
    print(f"[{tag}] pobj against the unsharded solve {rel:.2e} relative "
          f"(tol {ROW_POBJ_RTOL:g})", flush=True)
    require(o["status"] == ref_status,
            f"{tag}: status {o['status']}, unsharded {ref_status}")
    require(tuple(o["counts"]) == tuple(ref_counts),
            f"{tag}: counts {o['counts']}, unsharded {ref_counts}")
    require(rel <= ROW_POBJ_RTOL, f"{tag}: pobj {rel:.2e} from unsharded")
    for p in ranks[1:]:
        require(all(p[f] == o[f] for f in ("status", "pobj", "dobj", "gap",
                                           "counts")),
                f"{tag}: rank {p['rank']}'s solve parts from rank 0's")
    require_counts(tag, o["kernels"], MAXCUT_KERNELS)


def _row_rank(prob, params, device=None):
    """One rank of ``[dn20-rowN]``: :func:`row_solve` of ``prob``, the
    gathered factors on rank 0 only (for its host check)."""
    import torch.distributed as dist

    from ltr_lowrank_sdp_torch.parallel.dryrun import row_solve

    o = row_solve(prob, params, device, factors=dist.get_rank() == 0)
    o["ms_per_collective"] = _ms_per_collective(
        o["collectives"], o["collective_bytes"], o["device"])
    return o


def run_dn20(dev, optimal):
    """``[dn20]``: the n = 2^20 Delaunay MaxCut through the CLI (the
    replayed loops), held to the host float64 DIMACS limits, the reference
    of its row-sharded solves.  Returns (its counts, the problem, its
    params, (ALM outer / inner, ADMM, CG counts, status, pobj), the
    adjacency)."""
    import scipy.io

    from ltr_lowrank_sdp_torch import cli
    from ltr_lowrank_sdp_torch.problem import load_problem
    from ltr_lowrank_sdp_torch.testing import delaunay_maxcut_adjacency

    t = time.perf_counter()
    adj = delaunay_maxcut_adjacency(DN20_N, seed=DN20_SEED)
    build_s = time.perf_counter() - t
    print(f"[dn20] Delaunay triangulation of {DN20_N} seeded points (seed "
          f"{DN20_SEED}): {adj.nnz // 2} edges, built in {build_s:.1f} s "
          f"(apart from the solve)", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "delaunay_n20_gen.mat")
        t = time.perf_counter()
        scipy.io.savemat(path, {"Problem": {"A": adj}})
        print(f"[dn20] wrote {os.path.getsize(path) / 1e6:.1f} MB .mat in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        torch.cuda.init()       # the memory statistics need the allocator
        torch.cuda.reset_peak_memory_stats(dev)
        dn_counts, res, _ = run_main_path(
            "dn20", path, MAIN_FLAGS, MAXCUT_KERNELS, optimal[:1],
            DN20_LIMITS, dev, repeat=False)
        print(f"[dn20] unsharded (CLI, replayed loops): peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB, "
              f"final ranks {res.final_ranks}", flush=True)
        prob = load_problem(path)
        params = cli.params_from_args(cli.build_arg_parser().parse_args(
            [path, *MAIN_FLAGS]))
    ref = ((res.alm_outer_iters, res.alm_inner_iters, res.admm_iters,
            res.cg_iters), res.status.value, res.pobj)
    del res
    torch.cuda.empty_cache()
    return dn_counts, prob, params, ref, adj


def run_dn20_rows(prob, params, ref, worlds, backend="nccl", device=None):
    """``[dn20-rowN]`` for each N of ``worlds``: ``prob`` row-sharded over N
    ranks (one card a rank over NCCL), each held to the host float64
    DIMACS limits on rank 0's gathered factors, every rank to rank 0.
    N = 1 is held to the unsharded solve ``ref`` (its status, counts and
    pobj within ROW_POBJ_RTOL).  A larger world adds its partials in its
    own partition, so its counts may part from ``[dn20-row1]``'s: with the
    same counts its pobj is held within ROW_POBJ_RTOL of world 1's; with
    other counts its certified bracket of the optimum
    (``testing.optimum_bracket``, the solver's own least eigenvalue of the
    slack) must overlap world 1's, which bounds the two pobj's distance by
    the brackets' widths with each pobj in its bracket.  Returns ({tag: rank
    0's kernel counts}, {N: rank 0's result without the factors})."""
    from ltr_lowrank_sdp_torch.parallel.launch import spawn
    from ltr_lowrank_sdp_torch.solver.common import host_metrics_f64
    from ltr_lowrank_sdp_torch.testing import optimum_bracket

    def solve(ws, tag):
        t = time.perf_counter()
        ranks = spawn(_row_rank, ws, (prob, params, device), backend=backend)
        o = ranks[0]
        print(f"[{tag}] {ws} rank(s), {backend}: start to join "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        base = results.get(1)
        _row_line(tag, backend, o, f"unsharded {ref[0]}" if base is None
                  else f"world size 1 {base['counts']}")
        U, V, dual = o.pop("U"), o.pop("V"), o.pop("dual")
        Ravg = tuple(0.5 * (u + v) for u, v in zip(U, V))
        pobj, dobj, pinf, _, gap = host_metrics_f64(
            prob, Ravg, Ravg, None, None, dual, o["obj_scale"])
        del Ravg
        # the solver's Lanczos value of the slack's least eigenvalue
        o["lam_min"] = -o["dinf_l1"] * (1.0 + prob.c_nrm1)
        o["bracket"] = optimum_bracket(prob, U, V, dual, o["obj_scale"],
                                       o["lam_min"])
        del U, V, dual
        ms = o["ms_per_collective"]
        print(f"[{tag}] host f64: pobj {pobj:.10e} dobj {dobj:.10e} pinf_l1 "
              f"{pinf:.3e} gap {gap:.3e}; solver dinf_l1 "
              f"{o['dinf_l1']:.3e} (least eigenvalue of the slack "
              f"{o['lam_min']:.6e}); the optimum certified in "
              f"[{o['bracket'][0]:.6f}, {o['bracket'][1]:.6f}]; per rank: "
              f"peak device memory "
              f"{[round(r.get('peak_bytes', 0) / 2 ** 30, 2) for r in ranks]}"
              f" GiB, rows {[r['rows'][0] for r in ranks]}, collectives "
              f"{[r['collectives'] for r in ranks]}, "
              f"{o['collective_bytes'] / max(o['collectives'], 1) / 1e3:.1f}"
              f" kB each on rank 0, "
              f"{'none' if ms is None else f'{ms:.4f} ms'} each (mean "
              f"payload, after the solve), stop decisions "
              f"{o['agree_calls']}", flush=True)
        require(o["status"] == "primal_dual_optimal",
                f"{tag}: status {o['status']}")
        require(pinf <= DN20_LIMITS[0] and gap <= DN20_LIMITS[1]
                and o["dinf_l1"] <= DN20_LIMITS[2],
                f"{tag}: DIMACS errors above {DN20_LIMITS}")
        for p in ranks[1:]:
            require(all(p[f] == o[f] for f in (
                "status", "pobj", "dobj", "gap", "counts")),
                    f"{tag}: rank {p['rank']}'s solve parts from rank 0's")
        require_counts(tag, o["kernels"], MAXCUT_KERNELS)
        return o

    counts, results = {}, {}
    for ws in worlds:
        tag = f"dn20-row{ws}"
        o = solve(ws, tag)
        base = results.get(1)
        if base is None:
            _require_row(tag, o, [o], ref[1], ref[0], ref[2])
        elif tuple(o["counts"]) == tuple(base["counts"]):
            diff = abs(o["pobj"] - base["pobj"])
            print(f"[{tag}] against [dn20-row1]: counts {o['counts']} equal"
                  f"; pobj {diff / abs(base['pobj']):.2e} relative (tol "
                  f"{ROW_POBJ_RTOL:g})", flush=True)
            require(diff <= ROW_POBJ_RTOL * abs(base["pobj"]),
                    f"{tag}: pobj {diff:.6g} from [dn20-row1]")
        else:
            diff = abs(o["pobj"] - base["pobj"])
            (lo, hi), (lo1, hi1) = o["bracket"], base["bracket"]
            overlap = max(lo, lo1) <= min(hi, hi1)
            # each pobj and the optimum lie in its bracket's hull
            bound = sum(max(x["bracket"][1], x["pobj"])
                        - min(x["bracket"][0], x["pobj"]) for x in (o, base))
            gaps = sum(abs(x["pobj"] - x["dobj"]) for x in (o, base))
            print(f"[{tag}] against [dn20-row1]: counts {o['counts']} PART "
                  f"from {base['counts']}; |pobj - pobj_1| {diff:.6g} "
                  f"({diff / abs(base['pobj']):.2e} relative; the two "
                  f"|pobj - dobj| {gaps:.6g}); the certified brackets "
                  f"[{lo:.6f}, {hi:.6f}] and [{lo1:.6f}, {hi1:.6f}] "
                  f"{'overlap' if overlap else 'DO NOT overlap'}, which "
                  f"bounds |pobj - pobj_1| by {bound:.6g}", flush=True)
            require(overlap, f"{tag}: its certified bracket misses "
                             f"[dn20-row1]'s: the two solves share no "
                             f"optimum")
        counts[tag] = o["kernels"]
        results[ws] = o
    return counts, results


def run_dn20_relabeled(adj, params, base, dev):
    """``[dn20-relabeled]``: the unsharded solve, on ``dev``, of the n =
    2^20 Delaunay MaxCut with its vertices relabeled by one seeded
    permutation: the same SDP summed in another order, the control of a
    row-sharded world size whose counts part.  Held as such a world size is
    against ``base`` (``[dn20-row1]``'s result): the host float64 DIMACS
    limits and its certified bracket overlapping ``base``'s."""
    import numpy as np

    from ltr_lowrank_sdp_torch.io.maxcut import maxcut_problem_from_adjacency
    from ltr_lowrank_sdp_torch.solver.common import host_metrics_f64
    from ltr_lowrank_sdp_torch.solver.driver import Solver
    from ltr_lowrank_sdp_torch.testing import optimum_bracket

    perm = np.random.default_rng(0).permutation(adj.shape[0])
    prob = maxcut_problem_from_adjacency(adj[perm][:, perm].tocsc())
    res = Solver(prob, params, device=dev).solve()
    counts = (res.alm_outer_iters, res.alm_inner_iters, res.admm_iters,
              res.cg_iters)
    R = tuple(0.5 * (u + v) for u, v in zip(res.U, res.V))
    pobj, dobj, pinf, _, gap = host_metrics_f64(
        prob, R, R, None, None, res.dual, res.obj_scale)
    lam = -res.dinf_l1 * (1.0 + prob.c_nrm1)
    lo, hi = optimum_bracket(prob, res.U, res.V, res.dual, res.obj_scale,
                             lam)
    lo1, hi1 = base["bracket"]
    diff = abs(res.pobj - base["pobj"])
    print(f"[dn20-relabeled] unsharded, vertices permuted (seed 0): "
          f"{res.status.value} counts {counts} ([dn20-row1] "
          f"{base['counts']}); solve {res.solve_time:.3f} s; host f64 pobj "
          f"{pobj:.10e} dobj {dobj:.10e} pinf_l1 {pinf:.3e} gap {gap:.3e}; "
          f"solver dinf_l1 {res.dinf_l1:.3e}; |pobj - pobj_1| {diff:.6g} "
          f"({diff / abs(base['pobj']):.2e} relative); the certified bracket "
          f"[{lo:.6f}, {hi:.6f}] "
          f"{'overlaps' if max(lo, lo1) <= min(hi, hi1) else 'MISSES'} "
          f"[dn20-row1]'s", flush=True)
    require(res.status.value == "primal_dual_optimal"
            and pinf <= DN20_LIMITS[0] and gap <= DN20_LIMITS[1]
            and res.dinf_l1 <= DN20_LIMITS[2],
            "dn20-relabeled: not optimal within the DIMACS limits")
    require(max(lo, lo1) <= min(hi, hi1),
            "dn20-relabeled: its certified bracket misses [dn20-row1]'s")


def run_row_paths(K, dev, mc_prob, mc_params, mc_res, optimal):
    """Phase 16: the row-sharded mode.  ``[mc-row2]``: phase 4's problem
    row-sharded at world size ROW_WORLD over gloo, both ranks on this card;
    ``[dn20]``: the n = 2^20 Delaunay MaxCut through the CLI (the replayed
    loops) and row-sharded at world size 1 over NCCL, both held to the host
    float64 DIMACS limits and to each other; ``[row-kernels]`` on its cone.
    Every rank's counters are set to 0 just before its solve and read just
    after.  Returns ({path: rank 0's counts}, the kernels-line rows)."""
    from ltr_lowrank_sdp_torch.io.maxcut import maxcut_problem_from_adjacency
    from ltr_lowrank_sdp_torch.ops.coneops import ConeOps
    from ltr_lowrank_sdp_torch.parallel.dryrun import row_solve
    from ltr_lowrank_sdp_torch.parallel.launch import spawn
    from ltr_lowrank_sdp_torch.problem import initial_ranks

    counts = {}
    ref_counts = (mc_res.alm_outer_iters, mc_res.alm_inner_iters,
                  mc_res.admm_iters, mc_res.cg_iters)
    t = time.perf_counter()
    ranks = spawn(row_solve, ROW_WORLD, (mc_prob, mc_params), backend="gloo")
    print(f"[mc-row2] {ROW_WORLD} ranks, gloo: start to join "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    o = ranks[0]
    _row_line("mc-row2", "gloo", o, f"unsharded {ref_counts}")
    _require_row("mc-row2", o, ranks, mc_res.status.value, ref_counts,
                 mc_res.pobj)
    counts["mc-row2"] = o["kernels"]

    dn_counts, prob, params, ref, adj = run_dn20(dev, optimal)
    counts["dn20"] = dn_counts
    row_counts, _ = run_dn20_rows(prob, params, ref, (1,))
    counts.update(row_counts)

    cone_data = maxcut_problem_from_adjacency(adj).cones[0]
    inner = ConeOps(cone_data, dev)
    r = initial_ranks(prob)[0][0]
    del prob, adj
    rows = check_row_kernels(K, cone_data, inner, dev, r)
    del inner
    torch.cuda.empty_cache()
    return counts, rows


# phase 17: the label pipeline.  The dataset's instance families at the
# names that pick harvest's presets (gen_instances' default seed 0), the
# kernels their solves launch, the CPU twin's torch threads (the host flow
# with torch's default thread count ran 70x slower on a loaded host), the
# predictor that writes benchmark/r_sched/ and a tuner trial: the stub's
# answers to the search space and the smallest labelled graphs it trains on
LABEL_INSTANCES = (
    ("maxcut_n3200_d14", ("maxcut", "--n", "3200", "--avg-degree", "14")),
    ("MC_100x100_r2", ("matcomp", "--n1", "100", "--n2", "100", "--rank",
                       "2")))
HARVEST_KERNELS = MAXCUT_KERNELS + DENSE_KERNELS
HARVEST_CPU_THREADS = 1
LABEL_CKPT = os.path.join(ROOT, "runs", "r5")
TUNE_TRIAL = dict(hidden_dim=64, num_heads=4, edge_dim=32, global_dim=32,
                  num_gnn_layers=3, decoder_hidden_dim=96,
                  decoder_num_layers=2, dropout=0.15, length_weight=0.5,
                  mono_weight=0.1, initial_weight=0.25, final_weight=0.25,
                  under_weight=3.67, lr=3e-4, weight_decay=1e-4,
                  batch_size=16)
TUNE_EPOCHS = 2
TUNE_GRAPHS = 20


def check_parse(files) -> None:
    """``[parse]``: the native parser, which the card's machine must build,
    against the Python tokenizer on each (tag, path): identical arrays,
    each reader's seconds."""
    from ltr_lowrank_sdp_torch.io import native, sdpa
    from ltr_lowrank_sdp_torch.testing import same_sdpa

    fresh = not native.lib_path().exists()
    t = time.perf_counter()
    require(native.available(), f"the native SDPA parser builds "
                                f"({native.build_error()})")
    built = (f"built with g++ in {time.perf_counter() - t:.2f} s" if fresh
             else "built by an earlier phase's first read")
    print(f"[parse] native parser {native.lib_path().name}: {built}",
          flush=True)
    for tag, path in files:
        t = time.perf_counter()
        got = sdpa.read_sdpa(path)
        t_native = time.perf_counter() - t
        t = time.perf_counter()
        want = sdpa.read_sdpa(path, use_native=False)
        t_py = time.perf_counter() - t
        require(same_sdpa(got, want),
                f"parse: the native and Python readers part on {tag}")
        print(f"[parse] {tag} ({os.path.getsize(path) / 1e6:.1f} MB, m = "
              f"{got.n_constrs}): native {t_native:.3f} s, Python "
              f"{t_py:.3f} s ({t_py / t_native:.1f}x), identical arrays",
              flush=True)


def _labels_agree(tag, got, want) -> None:
    """The card's label file against the CPU's: the same keys and rank
    trajectories, the final oracle rank within one."""
    require(got.keys() == want.keys()
            and got["metrics"].keys() == want["metrics"].keys(),
            f"{tag}: label keys")
    final = (got["metrics"]["oracle_rank"], want["metrics"]["oracle_rank"])
    require(abs(final[0] - final[1]) <= 1, f"{tag}: final oracle rank "
                                           f"{final} (card, CPU)")
    for phase in ("phase_1", "phase_2"):
        g, w = got["trajectory"][phase], want["trajectory"][phase]
        require(g == w, f"{tag}: {phase} trajectory card {g} CPU {w}")


def run_harvest(K, dev, tmp) -> dict:
    """``[harvest]``: the generator twin writes LABEL_INSTANCES, the harvest
    twin solves and processes them on the card, then solves them again in
    the same process (``--overwrite --skip-parse``: the kernels loaded, each
    new Solver's graphs captured again), then runs on the CPU (one torch
    thread); the counts set to 0 just before the card's first run and read
    just after its second.  Returns its counts."""
    import numpy as np

    from ltr_lowrank_sdp_torch.scripts import gen_instances, harvest

    inst = os.path.join(tmp, "instances")
    for name, argv in LABEL_INSTANCES:
        require(gen_instances.main([*argv, "--out", os.path.join(
            inst, f"{name}.dat-s")]) == 0, f"gen_instances {name}")
    roots = {side: os.path.join(tmp, side) for side in ("card", "cpu")}

    def labels(side, name):
        with open(os.path.join(roots[side], "sol_json", f"{name}.json")) as f:
            return json.load(f)

    def run(side, device, *flags):
        return harvest.harvest(harvest.build_argparser().parse_args(
            ["--instances", inst, "--root", roots[side], *flags]), device)

    K.reset_counts()
    t = time.perf_counter()
    rows = run("card", dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    first = {r["name"]: labels("card", r["name"]) for r in rows}
    t = time.perf_counter()
    again = run("card", dev, "--overwrite", "--skip-parse")
    torch.cuda.synchronize()
    wall_again = time.perf_counter() - t
    counts = K.counts()
    require_counts("harvest", counts, HARVEST_KERNELS)
    n = torch.get_num_threads()
    torch.set_num_threads(HARVEST_CPU_THREADS)
    try:
        t = time.perf_counter()
        cpu_rows = run("cpu", torch.device("cpu"))
        cpu_wall = time.perf_counter() - t
    finally:
        torch.set_num_threads(n)
    for row, row2, cpu in zip(rows, again, cpu_rows):
        name = row["name"]
        for r in (row, row2, cpu):
            require(r["status"] == "primal_dual_optimal",
                    f"harvest: {name} {r['status']}")
        # the graph features: a check of the host path (the same numpy
        # processor on both sides), that the card run wrote them whole
        require(row["process_s"] is not None and cpu["process_s"] is not None,
                f"harvest: {name}'s graph features")
        with np.load(os.path.join(roots["card"], "proc", f"{name}.npz")) as a, \
                np.load(os.path.join(roots["cpu"], "proc",
                                     f"{name}.npz")) as b:
            require(sorted(a.files) == sorted(b.files) and all(
                a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
                for k in a.files), f"harvest: {name}'s graph features")
        card = labels("card", name)
        _labels_agree(f"harvest {name} (again)", card, first[name])
        _labels_agree(f"harvest {name}", card, labels("cpu", name))
        traj = card["trajectory"]
        print(f"[harvest] {name}: card parse {row['parse_s']:.3f} s, solve "
              f"{row['solve_s']:.3f} s (first, its graphs captured) / "
              f"{row2['solve_s']:.3f} s (again, captured again in a warm "
              f"process), process {row['process_s']:.3f} s (host); CPU "
              f"solve {cpu['solve_s']:.3f} s; oracle ranks phase 1 "
              f"{traj['phase_1']['oracle_rank']} phase 2 "
              f"{traj['phase_2']['oracle_rank']}, final "
              f"{card['metrics']['oracle_rank']} (CPU "
              f"{labels('cpu', name)['metrics']['oracle_rank']}); "
              f"trajectories equal to the first run's and the CPU's, graph "
              f"features equal to the CPU run's (host path)",
              flush=True)
    print(f"[harvest] {len(rows)} instances: card first run {wall:.3f} s, "
          f"again {wall_again:.3f} s (solves only), CPU run "
          f"({HARVEST_CPU_THREADS} torch thread) {cpu_wall:.3f} s",
          flush=True)
    return counts


def run_predict_all(K, dev, tmp) -> dict:
    """``[predict-all]``: the twin on the card over the benchmark names'
    cached graphs, the counts set to 0 just before and read just after,
    against its CPU run (schedules equal, raw within PREDICT_RTOL) and the
    committed ``benchmark/r_sched``.  Returns its counts."""
    import numpy as np

    from ltr_lowrank_sdp_torch.scripts import predict_all

    insts = os.path.join(ROOT, "benchmark", "instances")
    K.reset_counts()
    t = time.perf_counter()
    done = predict_all.predict_all(LABEL_CKPT, insts, os.path.join(
        tmp, "card"), DATASET, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = K.counts()
    require_counts("predict-all", counts, GNN_KERNELS, per_graph=len(done))
    t = time.perf_counter()
    ref = predict_all.predict_all(LABEL_CKPT, insts, os.path.join(
        tmp, "cpu"), DATASET, "cpu")
    cpu_wall = time.perf_counter() - t
    require(len(done) == len(ref) == 10, "predict-all: ten schedules")
    worst = 0.0
    for (art, raw), (art_c, raw_c) in zip(done, ref):
        name = art["name"]
        with open(os.path.join(ROOT, "benchmark", "r_sched",
                               f"{name}.json")) as f:
            committed = json.load(f)
        for key in ("rank_schedule", "schedule_length"):
            require(art[key] == art_c[key] == committed[key],
                    f"predict-all: {name}'s {key}")
        require(bool((abs(raw - raw_c) <= PREDICT_RTOL * abs(raw_c)).all()),
                f"predict-all: {name}'s raw schedule, card against CPU")
        worst = max(worst, float(np.max(abs(raw - raw_c) / abs(raw_c))))
    print(f"[predict-all] {len(done)} schedules on the card in {wall:.3f} s "
          f"(the model's load included), CPU {cpu_wall:.3f} s; equal to the "
          f"CPU run's and the committed benchmark/r_sched, raw within "
          f"{worst:.3e} relative (tol {PREDICT_RTOL:g})", flush=True)
    return counts


def run_tune_trial(K, dev, tmp) -> dict:
    """``[tune]``: one trial of the tuner's objective on the card (a stub in
    place of Optuna's trial), TUNE_EPOCHS epochs on the TUNE_GRAPHS
    smallest labelled graphs, the counts set to 0 just before and read
    just after.  Returns its counts."""
    import argparse

    import numpy as np

    from ltr_lowrank_sdp_torch import tune
    from ltr_lowrank_sdp_torch.testing import StubTrial

    src = os.path.join(DATASET, "sol_json")
    names = [f[:-5] for f in os.listdir(src) if os.path.exists(
        os.path.join(DATASET, "proc", f[:-5] + ".npz"))]
    sizes = {}
    for name in names:
        with np.load(os.path.join(DATASET, "proc", f"{name}.npz")) as z:
            sizes[name] = z["x"].shape[0]
    root = os.path.join(tmp, "dataset")
    for sub, ext in (("proc", "npz"), ("sol_json", "json")):
        os.makedirs(os.path.join(root, sub))
        for name in sorted(names, key=lambda n: (sizes[n], n))[:TUNE_GRAPHS]:
            os.symlink(os.path.join(DATASET, sub, f"{name}.{ext}"),
                       os.path.join(root, sub, f"{name}.{ext}"))
    args = argparse.Namespace(root=root, seed=42, cpu=False, device=str(dev),
                              epochs_per_trial=TUNE_EPOCHS)
    trial = StubTrial(TUNE_TRIAL)
    K.reset_counts()
    t = time.perf_counter()
    best = tune.objective(trial, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = K.counts()
    require_counts("tune", counts, TRAIN_KERNELS)
    values = [float(v) for _, v in trial.reports]
    require(len(values) == TUNE_EPOCHS and all(
        math.isfinite(v) for v in values) and best == min(values),
        f"tune: a finite val_log_mae each epoch ({values})")
    print(f"[tune] one trial, {TUNE_EPOCHS} epochs on the {TUNE_GRAPHS} "
          f"smallest labelled graphs on the card: {wall:.3f} s, "
          f"val_log_mae per epoch {values}, best {best}", flush=True)
    return counts


def run_label_paths(K, dev, mc_data=None, mb_data=None) -> dict:
    """Phase 17, the label pipeline: ``[parse]`` on phase 5's and 6's
    files, then ``[harvest]``, ``[predict-all]`` and ``[tune]``.  Returns
    {path: counts}."""
    from ltr_lowrank_sdp_torch.testing import (matcomp_sdpa,
                                               multiblock_lp_sdpa, write_sdpa)

    t17 = time.perf_counter()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for tag, data, make in (
                ("matcomp", mc_data, lambda: matcomp_sdpa(*MC_ARGS)),
                ("multiblock_lp", mb_data, lambda: multiblock_lp_sdpa(
                    MB_DIMS, MB_M, MB_NLP, MB_SEED))):
            files.append((tag, os.path.join(tmp, f"{tag}.dat-s")))
            write_sdpa(files[-1][1], make() if data is None else data)
        check_parse(files)
        for tag, fn in (("harvest", run_harvest),
                        ("predict_all", run_predict_all),
                        ("tune", run_tune_trial)):
            t = time.perf_counter()
            sub = os.path.join(tmp, tag)
            os.makedirs(sub)
            counts[tag] = fn(K, dev, sub)
            print(f"[time] {tag} {time.perf_counter() - t:.1f} s",
                  flush=True)
    print(f"[time] phase 17 (label pipeline) {time.perf_counter() - t17:.1f} "
          "s", flush=True)
    return counts


def run_scaling(tag, worlds, cases, out_dir=None, device=None) -> list:
    """``[tag]``: the scaling twin (``scripts/scaling_report.py``) at each
    world size of ``worlds`` for each (axis, problem) of ``cases``, with its
    JAX configuration's parameters.  Every world size must give a row; on
    the constraint axis every row must have the same inner iterations (the
    sums are exact by ownership), on the row axis they are printed.  With
    ``out_dir`` each payload is written there as ``scaling_<axis>.json``.
    Returns the payloads."""
    from ltr_lowrank_sdp_torch.scripts import scaling_report as SR

    payloads = []
    for axis, prob in cases:
        t = time.perf_counter()
        payload = SR.report(worlds, prob, SR.jax_params(), axis, device)
        require(payload is not None, f"{tag}: no row measured")
        rows = payload["rows"]
        for r in rows:
            ms = r["ms_per_collective"]
            secs = [round(x, 4) for x in r["seconds_by_rank"]]
            peaks = [None if b is None else round(b / 2 ** 30, 3)
                     for b in r["peak_bytes_by_rank"]]
            print(f"[{tag}] {axis} axis, {prob.name} n={prob.block_dims[0]}"
                  f": {r['devices']} rank(s) {r['mode']}, {r['backend']}: "
                  f"inner {r['inner_iters']} in {r['dispatches']} "
                  f"dispatch(es), {r['seconds']:.4f} s, "
                  f"{r['alm_inner_iters_per_sec']:.2f} inner/s, speedup "
                  f"{r.get('speedup_vs_1dev', float('nan')):.3f} (against "
                  f"the sharded world size 1); collectives "
                  f"{r['collectives']} of {r['collective_bytes'] / 1e6:.3f} "
                  f"MB, {'none' if ms is None else f'{ms:.4f} ms'} each; "
                  f"seconds by rank {secs}, peak GiB by rank {peaks}",
                  flush=True)
        got = sorted({r["devices"] for r in rows if r["mode"] == "sharded"})
        require(got == sorted(worlds),
                f"{tag}: sharded rows at {got}, asked {list(worlds)}")
        inner = {r["inner_iters"] for r in rows}
        print(f"[{tag}] {axis} axis: inner iterations "
              f"{[r['inner_iters'] for r in rows]} "
              f"({'identical' if len(inner) == 1 else 'PART'}); cards "
              f"{payload['cards']}; peer access {payload['peer_access']}; "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        if axis == "constr":
            require(len(inner) == 1,
                    f"{tag}: the constraint axis parts the inner iterations")
        if out_dir is not None:
            path = os.path.join(out_dir, f"scaling_{axis}.json")
            with open(path, "w") as f:
                json.dump(payload, f, indent=1)
            print(f"[{tag}] wrote {path}", flush=True)
        payloads.append(payload)
    return payloads


def check_scaling_one() -> None:
    """``[scaling-1]``: the scaling twin at world size 1 on its JAX
    configuration, the unsharded solver and the sharded one over one NCCL
    rank: the same inner iterations."""
    from ltr_lowrank_sdp_torch.scripts import scaling_report as SR

    t = time.perf_counter()
    torch.cuda.empty_cache()
    run_scaling("scaling-1", (1,), [("constr", SR.jax_problem())])
    print(f"[time] scaling-1 {time.perf_counter() - t:.1f} s", flush=True)


def run_multi_card(dev, names=MULTI_PHASES, backend="nccl", device=None,
                   scaling_out=None):
    """The multi-card mode's sub-phases ``names`` (of MULTI_PHASES, in
    order) on ``dev`` (the parent's card) and ranks over ``backend`` (on
    ``device``: None, one card a rank).  Each sub-phase prints its
    ``[time]``; one that fails is reported and the next runs.  Returns the
    names of the failed ones."""
    from ltr_lowrank_sdp_torch import cli
    from ltr_lowrank_sdp_torch.config import SolverStatus
    from ltr_lowrank_sdp_torch.parallel.dryrun import dryrun
    from ltr_lowrank_sdp_torch.parallel.launch import spawn
    from ltr_lowrank_sdp_torch.problem import load_problem
    from ltr_lowrank_sdp_torch.testing import (delaunay_maxcut_adjacency,
                                               matcomp_sdpa,
                                               multiblock_lp_sdpa,
                                               write_sdpa)

    optimal = (SolverStatus.PRIMAL_DUAL_OPTIMAL, SolverStatus.PRIMAL_OPTIMAL)
    failed = []
    state = {}

    def phase(name, fn):
        t = time.perf_counter()
        try:
            fn()
        except Exception:       # report it, run the next sub-phase
            import traceback

            print(f"[{name}] FAILED\n{traceback.format_exc()}", flush=True)
            failed.append(name)
        print(f"[time] {name} {time.perf_counter() - t:.1f} s", flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def constr():
        # the unsharded CLI solves of phases 4-6's files, then each file
        # constraint-sharded over every world size
        import scipy.io

        solves = []
        with tempfile.TemporaryDirectory() as tmp:
            # (tag, writer, flags, the CLI's kernels, the sharded solve's,
            # blocks)
            for tag, write, flags, launched, kernels, n_blocks in (
                    ("main", lambda p: scipy.io.savemat(p, {"Problem": {
                        "A": delaunay_maxcut_adjacency(MAIN_N,
                                                       seed=MAIN_SEED)}}),
                     MAIN_FLAGS, MAXCUT_KERNELS, PAR_KERNELS, 1),
                    ("matcomp", lambda p: write_sdpa(p, matcomp_sdpa(
                        *MC_ARGS)), MC_FLAGS, SPARSE_KERNELS, PAR_KERNELS,
                     1),
                    ("multiblock_lp", lambda p: write_sdpa(
                        p, multiblock_lp_sdpa(MB_DIMS, MB_M, MB_NLP,
                                              MB_SEED)), (), MB_KERNELS,
                     MB_KERNELS, len(MB_DIMS))):
                path = os.path.join(tmp, f"{tag}.mat" if tag == "main"
                                    else f"{tag}.dat-s")
                write(path)
                c, res, _ = run_main_path(
                    tag, path, flags, launched,
                    optimal[:1] if tag == "main" else optimal,
                    (1e-5, 1e-5, 1e-5) if tag == "main"
                    else (1e-5, 5e-5, 5e-5), dev, n_blocks=n_blocks,
                    repeat=False)
                check_solve_counts(tag, res, c)
                params = cli.params_from_args(
                    cli.build_arg_parser().parse_args([path, *flags]))
                prob = load_problem(path)
                # MeshConeOps leaves a dense-A cone whole (the multi-block
                # + LP path's blocks), as the JAX package's does
                solves.append((tag, prob, params, res, kernels,
                               [c.kind_a != "dense" for c in prob.cones]))
        cases = [(prob, params) for _, prob, params, *_ in solves]
        for ws in MULTI_WORLDS:
            t = time.perf_counter()
            ranks = spawn(_parallel_rank, ws, (cases, None, device),
                          backend=backend)
            print(f"[constr-nccl{ws}] {ws} ranks, {backend}: start to join "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
            check_sharded_solves(solves, ranks, ws, backend,
                                 lambda tag: f"constr-nccl{ws} {tag}")

    def rows():
        # the n = 2^20 Delaunay MaxCut at world size 1 against its unsharded
        # solve, then every world size against world size 1, then the
        # unsharded solve of the graph relabeled
        _, prob, params, ref, adj = run_dn20(dev, optimal)
        state["dn20"] = prob
        _, results = run_dn20_rows(prob, params, ref, (1,) + MULTI_WORLDS,
                                   backend, device)
        run_dn20_relabeled(adj, params, results[1], dev)

    def batch4():
        bprob, R0, dual0, _ = batch_problem(BATCH4_B)
        t = time.perf_counter()
        ranks = spawn(_parallel_rank, MULTI_CARDS,
                      ([], (bprob, R0, dual0, BATCH_RHO, BATCH_STEPS),
                       device), backend=backend)
        print(f"[batch4] {MULTI_CARDS} ranks, {backend}: start to join "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        check_batch("batch4", ranks, bprob, R0, dual0, dev, MULTI_CARDS,
                    backend)

    def dryrun4():
        line = dryrun(MULTI_CARDS, backend, device)
        print(f"[dryrun4] {line}", flush=True)
        require("mesh batch=2 constr=2" in line,
                "dryrun4: the dry run's mesh is 2 x 2")

    def scaling():
        from ltr_lowrank_sdp_torch.scripts import scaling_report as SR

        run_scaling("scaling", SCALING_WORLDS,
                    [("constr", SR.jax_problem()),
                     ("row", state.pop("dn20", None)
                      or SR.delaunay_problem(DN20_SEED))],
                    scaling_out, device)

    subphases = {"constr-nccl": constr, "row-nccl": rows,
                 "batch4": batch4, "dryrun4": dryrun4, "scaling": scaling}
    for name in names:
        phase(name, subphases[name])
    return failed


def multi_card(names, scaling_out) -> int:
    """``--multi-card``: the build, then the sharded modes over NCCL at
    world sizes 2 and 4, one card a rank (:func:`run_multi_card`), all of
    them or the sub-phases ``names``.  Needs MULTI_CARDS cards: with fewer
    it exits 1 with the count."""
    from ltr_lowrank_sdp_torch.ops import kernels as K
    from ltr_lowrank_sdp_torch.scripts.scaling_report import (card_lines,
                                                              peer_access)

    cards = torch.cuda.device_count()
    if cards < MULTI_CARDS:
        print(f"chip_smoke --multi-card: needs {MULTI_CARDS} cards, this "
              f"host has {cards}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    lines = card_lines()
    for k, line in enumerate(lines):
        print(f"[card {k}] {line}", flush=True)
    print(f"[peer-access] {peer_access()} (can_device_access_peer, row i "
          f"column j)", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    t = time.perf_counter()
    K.build_kernels()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    failed = run_multi_card(dev, names, scaling_out=scaling_out)
    print(f"[total] {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"chip_smoke --multi-card: failed: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(lines[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def print_ptxas(K, kernels) -> None:
    """``[ptxas]``: each kernel's registers and spills as ``-Xptxas -v``
    gave them in this process's build; those of PTXAS_BY_INSTANCE by their
    template arguments."""
    for k in kernels:
        if k.name not in PTXAS_BY_INSTANCE:
            for line in k.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[ptxas] {k.name}: {line.strip()}")
            continue
        for key, (regs, st, ld) in sorted(K.ptxas_usage(k.name).items()):
            print(f"[ptxas] {k.name} {key[0]}<{key[1]}"
                  f"{''.join(f', {x}' for x in key[2])}>: {regs} registers, "
                  f"spill stores / loads {st} / {ld} bytes")


def hallar_path_alone() -> int:
    """``--hallar-path``: the build with the HALLaR kernels' registers, the
    launch floor, then phase 13 (the HALLaR path, ``[k14-plan]`` with it)
    alone."""
    from ltr_lowrank_sdp_torch.ops import kernels as K

    t0 = time.perf_counter()
    print(f"[card] {card_line()}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    t = time.perf_counter()
    K.build_kernels()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    print_ptxas(K, [{**K.KERNELS, **K.LOOP_KERNELS}[name]
                    for name in HALLAR_KERNELS])
    print(f"[launch-floor] {time_ms(lambda: K.launch_floor(dev)):.5f} ms",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        counts, _, rows = run_hallar_path(K, dev, tmp)
    print(json.dumps({"hallar_counts": counts, "hallar_kernels": rows}))
    print(f"[total] {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def label_paths_alone() -> int:
    """``--label-paths``: the build, then phase 17 (the label pipeline)
    alone."""
    from ltr_lowrank_sdp_torch.ops import kernels as K

    t0 = time.perf_counter()
    print(f"[card] {card_line()}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    t = time.perf_counter()
    K.build_kernels()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    counts = run_label_paths(K, dev)
    print(json.dumps({"label_counts": counts}))
    print(f"[total] {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def row_paths_alone() -> int:
    """``--row-paths``: the build, phase 4's MaxCut solve through the CLI,
    then phase 16 (the row-sharded mode) alone."""
    import scipy.io

    from ltr_lowrank_sdp_torch import cli
    from ltr_lowrank_sdp_torch.config import SolverStatus
    from ltr_lowrank_sdp_torch.ops import kernels as K
    from ltr_lowrank_sdp_torch.problem import load_problem
    from ltr_lowrank_sdp_torch.testing import delaunay_maxcut_adjacency

    t0 = time.perf_counter()
    print(f"[card] {card_line()}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    t = time.perf_counter()
    K.build_kernels()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    optimal = (SolverStatus.PRIMAL_DUAL_OPTIMAL, SolverStatus.PRIMAL_OPTIMAL)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"delaunay_n14_seed{MAIN_SEED}.mat")
        scipy.io.savemat(path, {"Problem": {"A": delaunay_maxcut_adjacency(
            MAIN_N, seed=MAIN_SEED)}})
        _, res, _ = run_main_path("main", path, MAIN_FLAGS, MAXCUT_KERNELS,
                                  optimal[:1], (1e-5, 1e-5, 1e-5), dev,
                                  repeat=False)
        prob = load_problem(path)
        params = cli.params_from_args(cli.build_arg_parser().parse_args(
            [path, *MAIN_FLAGS]))
    counts, rows = run_row_paths(K, dev, prob, params, res, optimal)
    print(json.dumps({"row_counts": counts, "row_kernels": rows}))
    print(f"[total] {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        ap = argparse.ArgumentParser()
        mode = ap.add_mutually_exclusive_group(required=True)
        mode.add_argument("--theta-solve", metavar="N,AVG_DEGREE,SEED")
        mode.add_argument("--train-step", metavar="HIDDEN,HEADS")
        mode.add_argument("--row-paths", action="store_true",
                          help="phase 16 alone, after phase 4's solve")
        mode.add_argument("--label-paths", action="store_true",
                          help="phase 17 (the label pipeline) alone")
        mode.add_argument("--hallar-path", action="store_true",
                          help="phase 13 (the HALLaR path) alone")
        mode.add_argument("--multi-card", nargs="*", metavar="SUBPHASE",
                          choices=MULTI_PHASES,
                          help=f"the sharded modes over NCCL on "
                               f"{MULTI_CARDS} cards: every sub-phase, or "
                               f"those named (a four-card call costs four "
                               f"times its seconds)")
        ap.add_argument("--scaling-out", default=os.path.join(
            ROOT, "ltr_lowrank_sdp_torch", "scripts"),
            help="where --multi-card writes the scaling twin's artifacts")
        ap.add_argument("--time-limit", type=float, default=600.0)
        ap.add_argument("--profile", action="store_true")
        ap.add_argument("--logfile", default=None)
        ap.add_argument("--dtype", default="auto",
                        choices=["auto", "float32", "float64"],
                        help="the solver's compute dtype (auto: float64)")
        args = ap.parse_args()
        if args.train_step:
            return train_step_parts(args.train_step)
        if args.row_paths:
            return row_paths_alone()
        if args.label_paths:
            return label_paths_alone()
        if args.hallar_path:
            return hallar_path_alone()
        if args.multi_card is not None:
            return multi_card(
                [n for n in MULTI_PHASES if n in args.multi_card]
                or MULTI_PHASES, args.scaling_out)
        return theta_solve(args.theta_solve, args.time_limit, args.profile,
                           args.logfile, args.dtype)
    card = card_line()
    print(f"[card] {card}")
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    import scipy.io

    from ltr_lowrank_sdp_torch.config import SolverParams, SolverStatus
    from ltr_lowrank_sdp_torch.io.maxcut import maxcut_problem_from_adjacency
    from ltr_lowrank_sdp_torch.ops import kernels as K
    from ltr_lowrank_sdp_torch.ops.coneops import ConeOps, LPOps
    from ltr_lowrank_sdp_torch import cli
    from ltr_lowrank_sdp_torch.problem import (canonicalize, initial_ranks,
                                               load_problem)
    from ltr_lowrank_sdp_torch.solver.driver import Solver
    from ltr_lowrank_sdp_torch.testing import (delaunay_maxcut_adjacency,
                                               matcomp_problem, matcomp_sdpa,
                                               multiblock_lp_problem,
                                               multiblock_lp_sdpa,
                                               random_maxcut_problem,
                                               random_multiblock_problem,
                                               theta_problem, theta_sdpa,
                                               write_sdpa)

    dev = torch.device("cuda", torch.cuda.current_device())

    # ---- phase 2: build ------------------------------------------------ #
    t = time.perf_counter()
    built = K.build_kernels()
    print(f"[build] {len(built)} kernels in {time.perf_counter() - t:.1f} s "
          f"({', '.join(built)})")
    require(len(K.KERNELS) == 13 and len(K.LOOP_KERNELS) == 3 and all(
        k.lib_path is not None and k.lib_path.exists()
        for k in (*K.KERNELS.values(), *K.LOOP_KERNELS.values())),
        "sixteen kernels built")
    print_ptxas(K, (*K.KERNELS.values(), *K.LOOP_KERNELS.values()))

    # the launch floor: an empty kernel through the same ctypes path
    floor_ms = time_ms(lambda: K.launch_floor(dev))
    print(f"[launch-floor] an empty kernel (csrc/launch_floor.cu, one block "
          f"of one warp) launched through the kernels' ctypes path: "
          f"{floor_ms:.5f} ms a launch on the device (time_ms: CUDA events "
          f"over 50 launches queued behind a sleep kernel), host-issued "
          f"call {host_call_ms(lambda: K.launch_floor(dev)):.4f} ms",
          flush=True)

    # ---- phase 3: each kernel against its plain version ---------------- #
    adj = delaunay_maxcut_adjacency(MAIN_N, seed=MAIN_SEED)
    cone = ConeOps(maxcut_problem_from_adjacency(adj).cones[0], dev)
    print(f"[problem] delaunay n={MAIN_N} seed={MAIN_SEED}: "
          f"{adj.nnz // 2} edges, C upper nnz {cone.c_nnz}, "
          f"full CSR nnz {cone.c_csr.nnz}", flush=True)
    report = {"maxcut": check_kernels(K, cone, dev)}
    t = time.perf_counter()
    check_k1_plans(K, cone.c_csr, dev, "maxcut")

    t = time.perf_counter()
    mc_data = matcomp_sdpa(*MC_ARGS)
    mc_cone_data = canonicalize(mc_data).cones[0]
    mc_cone = ConeOps(mc_cone_data, dev)
    require((mc_cone.kind_a, mc_cone.kind_c) == ("sparse", "sparse")
            and not mc_cone.diag_identity, "matrix completion is a sparse cone")
    print(f"[problem] matcomp {MC_ARGS}: n={mc_cone.n} m={mc_cone.m} "
          f"A upper nnz {mc_cone.a_seg.nnz}, full CSR slots "
          f"{mc_cone.a_csr.nnz}, C nnz {mc_cone.c_nnz}, rank cap "
          f"{mc_cone.rank_max}, built in {time.perf_counter() - t:.1f} s",
          flush=True)
    report["matcomp"] = {
        **check_objective_kernels(K, mc_cone, dev, MC_CHECK_RANKS,
                                  MC_REPORT_RANK, "matcomp"),
        **check_general_kernels(K, mc_cone.a_seg, mc_cone.a_csr, dev,
                                MC_CHECK_RANKS, MC_REPORT_RANK, "matcomp")}
    check_k1_plans(K, mc_cone.c_csr, dev, "matcomp")
    print(f"[time] K1 plans (maxcut, matcomp) {time.perf_counter() - t:.1f} "
          "s", flush=True)
    trace_entries = trace_cone_entries()
    rows, cols, vals, cid, tn, tm = trace_entries
    check_general_kernels(
        K, K.SegCOO.from_coo(rows, cols, vals, cid, tn, tm, dev),
        K.ConstrCSR.from_upper_coo(rows, cols, vals, cid, tn, tm, dev), dev,
        (19,), 19, "random+trace")
    check_long_segments(K, trace_entries, dev, 19, "random+trace")

    # the Lovasz theta cone at the width of Mittelmann theta12: dense C, one
    # 600-entry trace segment, one entry per edge
    check_dense_cone(K, canonicalize(theta_sdpa(*THETA12_ARGS)).cones[0],
                     dev, THETA12_RANKS, THETA12_RANKS[0],
                     f"theta12 {THETA12_ARGS}", relabel=True)

    # the cone that the theta main path solves, at the rank it starts from
    # (its rank cap, so it stays there) and r = 1: this is the path's row of
    # the kernels line
    th_data = theta_sdpa(THETA_N, THETA_N // 4, THETA_N)
    th_prob = canonicalize(th_data)
    require(initial_ranks(th_prob)[0] == [THETA_RANKS[0]],
            f"theta: the solve starts at rank {THETA_RANKS[0]}")
    report["theta"] = check_dense_cone(
        K, th_prob.cones[0], dev, THETA_RANKS, THETA_RANKS[0],
        f"theta{THETA_N}", relabel=True)

    # the multi-block + LP main path's shapes: K5 / K6 and the dense product
    # on each of its three blocks at the block's starting rank (the rank the
    # solve ends at) and r = 1, K7 / K8 on its LP cone and on one ten times
    # that; the largest block's row goes into the kernels line
    t = time.perf_counter()
    mb_data = multiblock_lp_sdpa(MB_DIMS, MB_M, MB_NLP, MB_SEED)
    mb_prob = canonicalize(mb_data)
    mb_ranks = initial_ranks(mb_prob)[0]
    require(mb_prob.n_lp_cols == MB_NLP and mb_ranks[0] == MB_REPORT_RANK,
            "multi-block + LP: an LP cone, block 0 starts at MB_REPORT_RANK")
    mb_lp = LPOps(mb_prob.lp, dev)
    print(f"[problem] multiblock+lp dims={MB_DIMS} m={MB_M} n_lp={MB_NLP} "
          f"seed={MB_SEED}: starting ranks {mb_ranks}, LP entries "
          f"{mb_lp.entries.nnz}, built in {time.perf_counter() - t:.1f} s",
          flush=True)
    mb_rows = [check_dense_cone(K, c, dev, (r, 1), r, f"multiblock[{k}]")
               for k, (c, r) in enumerate(zip(mb_prob.cones, mb_ranks))]
    report["multiblock_lp"] = {
        **mb_rows[0], **check_lp_kernels(K, mb_lp.entries, dev,
                                         "multiblock+lp")}
    big_lp = canonicalize(multiblock_lp_sdpa((2,), 10 * MB_M, 10 * MB_NLP,
                                             1)).lp
    check_lp_kernels(K, LPOps(big_lp, dev).entries, dev, "10x LP")
    check_k8_plans(K, mb_lp.entries, dev, "multiblock+lp")
    check_k8_plans(K, long_column_lp(dev), dev, "long columns")

    # row 16: K5 and K6 on each shard's layouts of the matrix-completion
    # cone at world size 2 (rank 0's is the row of the kernels line)
    shard_rows = {}
    for shard in range(2):
        mops = shard_layouts(mc_cone_data, mc_cone, dev, 2, shard)
        rows = check_general_kernels(
            K, mops.cv_seg, mops.mm_csr, dev, (MC_REPORT_RANK,),
            MC_REPORT_RANK, f"matcomp shard {shard}/2 (constraints "
            f"{mops.cv_range}, rows {mops.mm_range})")
        shard_rows = shard_rows or rows
        check_shard_bits(K, mc_cone, mops, dev, MC_REPORT_RANK,
                         f"matcomp shard {shard}/2")
        del mops

    # K13, the repo's one pl.pallas_call, then the probe twin through its
    # entry point
    report["gather_probe"] = check_gather_rowsum(K, dev)
    gather_counts = run_gather_probe(K)

    # the float32 kernel phase: K1-K8 on float32 values at the same shapes
    t = time.perf_counter()
    report_f32 = check_f32_kernels(K, cone, mc_cone, mb_lp.entries, dev)
    print(f"[time] float32 kernel phase {time.perf_counter() - t:.1f} s",
          flush=True)
    # K1-K8 inside the conditional bodies of a CUDA graph, as the solver's
    # replayed loops run them
    t = time.perf_counter()
    check_capture_kernels(K, cone, mc_cone, mb_lp, dev)
    print(f"[time] capture-kernels phase {time.perf_counter() - t:.1f} s",
          flush=True)
    count_eager_steps()
    del mb_lp, big_lp, mc_cone

    optimal = (SolverStatus.PRIMAL_DUAL_OPTIMAL, SolverStatus.PRIMAL_OPTIMAL)
    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 4: the MaxCut main path through the CLI ------------- #
        path = os.path.join(tmp, f"delaunay_n14_seed{MAIN_SEED}.mat")
        scipy.io.savemat(path, {"Problem": {"A": adj}})
        maxcut_path = path
        counts, main_res, _ = run_main_path(
            "main", path, MAIN_FLAGS, MAXCUT_KERNELS, optimal[:1],
            (1e-5, 1e-5, 1e-5), dev)
        check_solve_counts("main", main_res, counts)

        # ---- phase 5: the sparse-cone main path through the CLI -------- #
        path = os.path.join(tmp, f"mc{2 * MC_N1}.dat-s")
        t = time.perf_counter()
        write_sdpa(path, mc_data)
        print(f"[matcomp] wrote {os.path.getsize(path) / 1e6:.1f} MB .dat-s "
              f"in {time.perf_counter() - t:.1f} s", flush=True)
        mc_path = path
        mc_counts, mc_res, _ = run_main_path("matcomp", path, MC_FLAGS,
                                             SPARSE_KERNELS, optimal,
                                             (1e-5, 5e-5, 5e-5), dev)
        check_solve_counts("matcomp", mc_res, mc_counts)

        # ---- phase 6: the multi-block + LP main path through the CLI --- #
        path = os.path.join(tmp, "multiblock_lp.dat-s")
        t = time.perf_counter()
        write_sdpa(path, mb_data)
        print(f"[multiblock_lp] wrote {os.path.getsize(path) / 1e6:.1f} MB "
              f".dat-s in {time.perf_counter() - t:.1f} s", flush=True)
        mb_path = path
        mb_counts, mb_res, _ = run_main_path(
            "multiblock_lp", path, (), MB_KERNELS, optimal,
            (1e-5, 5e-5, 5e-5), dev, n_blocks=len(MB_DIMS))
        check_solve_counts("multiblock_lp", mb_res, mb_counts)
        for k, (c, r0, r) in enumerate(zip(mb_prob.cones, mb_ranks,
                                           mb_res.final_ranks)):
            if r != r0:     # a rank the solve grew to: hold the kernels there
                check_dense_cone(K, c, dev, (r,), r, f"multiblock[{k}] final")

        # ---- phase 7: the Lovasz theta path through the CLI ------------ #
        path = os.path.join(tmp, f"theta{THETA_N}.dat-s")
        write_sdpa(path, th_data)
        th_counts, th_res, _ = run_main_path(
            "theta", path, ("--timeSecLimit", str(THETA_LIMIT_S)),
            DENSE_KERNELS, optimal, (1e-5, 5e-5, 5e-5), dev, repeat=False)
        require(th_res.solve_time <= THETA_LIMIT_S,
                f"theta: the solve took more than {THETA_LIMIT_S} s")
        if th_res.final_ranks[0] not in THETA_RANKS:
            check_dense_cone(K, th_prob.cones[0], dev, th_res.final_ranks,
                             th_res.final_ranks[0], f"theta{THETA_N} final",
                             relabel=True)

        # ---- phase 7b: the three main paths in float32 ----------------- #
        t7b = time.perf_counter()
        f32_counts = run_f32_paths(
            (("maxcut", "main", maxcut_path, MAIN_FLAGS, MAXCUT_KERNELS,
              main_res, 1),
             ("matcomp", "matcomp", mc_path, MC_FLAGS, SPARSE_KERNELS,
              mc_res, 1),
             ("multiblock_lp", "multiblock_lp", mb_path, (), MB_KERNELS,
              mb_res, len(MB_DIMS))), dev)
        print(f"[time] phase 7b (float32 main paths) "
              f"{time.perf_counter() - t7b:.1f} s", flush=True)
        # phase 14 solves phases 4 and 5's files again, sharded
        par_solves = [
            (tag, load_problem(path), cli.params_from_args(
                cli.build_arg_parser().parse_args([path, *flags])), res)
            for tag, path, flags, res in (
                ("maxcut", maxcut_path, MAIN_FLAGS, main_res),
                ("matcomp", mc_path, MC_FLAGS, mc_res))]

    # ---- phase 8: small problems on the card ---------------------------- #
    # (tag, problem, params, also solved on the CPU): the CPU twins of the
    # three that take under a second there
    small_pobj = {}
    for tag, small, params, twin in (
            ("g11", random_maxcut_problem(800, avg_degree=4, seed=11),
             SolverParams(), True),
            ("mc400", matcomp_problem(*MC_SMALL_ARGS),
             SolverParams(heuristic_factor=10.0), False),
            ("multiblock-gs", random_multiblock_problem(), SolverParams(),
             True),
            ("multiblock-jacobi", random_multiblock_problem(),
             SolverParams(admm_jacobi=True), True),
            ("multiblock_lp-small", multiblock_lp_problem(**MB_SMALL),
             SolverParams(), False),
            ("theta80", theta_problem(80, 20, 80), SolverParams(), False)):
        runs = []
        for side in ("gpu", "cpu") if twin else ("gpu",):
            t = time.perf_counter()
            r = Solver(small, params,
                       device=dev if side == "gpu" else "cpu").solve()
            runs.append(r)
            print(f"[{tag}] {side} {r.status.value} pobj {r.pobj:.12e} gap "
                  f"{r.gap:.2e} ranks {r.final_ranks} ALM outer "
                  f"{r.alm_outer_iters} inner {r.alm_inner_iters} ADMM "
                  f"{r.admm_iters} {time.perf_counter() - t:.2f} s",
                  flush=True)
        r = runs[0]
        require(r.status in optimal, f"{tag}: not solved on the card")
        small_pobj[tag] = r
        if twin:
            c = runs[1]
            diff, tol = abs(r.pobj - c.pobj), SMALL_POBJ_RTOL * abs(c.pobj)
            print(f"[{tag}] |pobj gpu - pobj cpu| {diff:.3e}, bound "
                  f"{tol:.3e} ({SMALL_POBJ_RTOL:g} relative)", flush=True)
            require(c.status == r.status and c.final_ranks == r.final_ranks
                    and diff <= tol, f"{tag}: GPU and CPU part")
    # the two ADMM sweeps end at one optimum, each pobj within its own
    # certified gap of it: |pobj - opt| <= gap (1 + |pobj| + |dobj|)
    gs, jac = small_pobj["multiblock-gs"], small_pobj["multiblock-jacobi"]
    diff = abs(gs.pobj - jac.pobj)
    tol = sum(x.gap * (1.0 + abs(x.pobj) + abs(x.dobj)) for x in (gs, jac))
    print(f"[multiblock] |pobj Gauss-Seidel - pobj Jacobi| on the card "
          f"{diff:.3e}, bound {tol:.3e} (their certified gaps)", flush=True)
    require(diff <= tol, "multiblock: the two ADMM sweeps end apart")

    # ---- phase 9: the predictor's kernels at the serve path's shapes --- #
    import numpy as np

    from ltr_lowrank_sdp_torch.data.loader import _load_graph_file
    from ltr_lowrank_sdp_torch.models.checkpoint import load_model

    print(f"[gnn] TF32 in float32 matmuls: "
          f"{torch.backends.cuda.matmul.allow_tf32} (cudnn, unused: "
          f"{torch.backends.cudnn.allow_tf32})", flush=True)
    require(not torch.backends.cuda.matmul.allow_tf32,
            "float32 matrix products run in full float32")
    gnn_model, _ = load_model(CKPT, device=dev)
    for path, gname in (("serve", SERVE_GRAPH), ("serve_mc600", BIG_GRAPH)):
        graph = _load_graph_file(os.path.join(DATASET, "proc",
                                              f"{gname}.npz"))
        layer1, (seg, x, score) = gnn_inputs(gnn_model, graph, dev)
        report[path] = {
            "gatv2_softmax_agg": check_gatv2(K, layer1, gname),
            "graph_pool": check_graph_pool(K, seg, x, score, gname)}
        del layer1, seg, x, score
    sizes = []
    for gname in POOL_BATCH:
        with np.load(os.path.join(DATASET, "proc", f"{gname}.npz")) as z:
            sizes.append(int(z["x"].shape[0]))
    sizes.insert(4, 0)          # an empty graph among them
    g = torch.Generator(device=dev).manual_seed(2030)
    x = torch.randn((sum(sizes), 64), generator=g, device=dev)
    score = 3.0 * torch.randn(sum(sizes), generator=g, device=dev)
    check_graph_pool(K, K.GraphSegments.from_counts(sizes, dev), x, score,
                     f"batch {sizes}")
    del gnn_model, x, score
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # ---- phase 10: the serve path through infer ------------------- #
        serve_counts = run_serve_path(K, dev, tmp)
        # ---- phase 11: predict, then solve ----------------------------- #
        run_predict_then_solve(K, tmp, optimal)

    # ---- phase 12: training ------------------------------------------- #
    # K9 / K11 and K10 / K12 against their plain versions at two dataset
    # graphs' shapes, a train step on the card against the CPU, then the
    # entry point for two epochs over the whole dataset
    t12 = time.perf_counter()
    gnn_model, _ = load_model(CKPT, device=dev)
    for gname in (SERVE_GRAPH, BIG_GRAPH):
        graph = _load_graph_file(os.path.join(DATASET, "proc",
                                              f"{gname}.npz"))
        layer1, pool = gnn_inputs(gnn_model, graph, dev)
        rows = check_train_kernels(K, layer1, pool, gname, dev)
        del layer1, pool
    report["train"] = rows               # BIG_GRAPH: the largest batch
    del gnn_model
    torch.cuda.empty_cache()
    check_train_step(K, dev)
    # the GNN widths the tuner samples and rows past 256 channels: K9-K12 on
    # theta_n300_d75's edges at every GNN_WIDTHS / POOL_WIDTHS, and one step
    # at each width of WIDE_STEPS
    t = time.perf_counter()
    with np.load(os.path.join(DATASET, "proc", f"{SERVE_GRAPH}.npz")) as z:
        width_rows = check_gnn_widths(
            K, torch.tensor(z["edge_index"], dtype=torch.long),
            int(z["x"].shape[0]), dev)
    for hidden, heads in WIDE_STEPS:
        check_train_step(K, dev, hidden_dim=hidden, num_heads=heads)
    check_train_step(K, dev, *SMALL_STEP, small=True)
    check_train_step_3g(K, dev)
    print(f"[time] width phase {time.perf_counter() - t:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        train_counts = run_train_path(K, dev, tmp)
    print(f"[time] phase 12 (training) {time.perf_counter() - t12:.1f} s",
          flush=True)

    # ---- phase 13: the HALLaR path -------------------------------------- #
    with tempfile.TemporaryDirectory() as tmp:
        hallar_counts, hallar_res, report["hallar"] = run_hallar_path(
            K, dev, tmp)

    # ---- phase 14: the parallel modes ----------------------------------- #
    t14 = time.perf_counter()
    par_counts, batch_row = run_parallel_paths(K, dev, par_solves)
    _, mc_prob, mc_params, _ = par_solves[0]
    del par_solves
    print(f"[time] phase 14 (parallel modes) {time.perf_counter() - t14:.1f} s",
          flush=True)

    # ---- phase 16: the row-sharded mode --------------------------------- #
    t16 = time.perf_counter()
    row_counts, row_rows = run_row_paths(K, dev, mc_prob, mc_params,
                                         main_res, optimal)
    del mc_prob
    print(f"[time] phase 16 (row-sharded mode) "
          f"{time.perf_counter() - t16:.1f} s", flush=True)

    # ---- phase 18: the scaling twin at world size 1 -------------------- #
    check_scaling_one()

    # ---- phase 17: the label pipeline ----------------------------------- #
    label_counts = run_label_paths(K, dev, mc_data, mb_data)
    del mc_data, mb_data

    # ---- phase 15: report --------------------------------------------- #
    # one row per kernel, measured at the shapes of the path that first
    # carried it (MaxCut for K1-K4, the sparse cone for K5 and K6, the
    # multi-block + LP problem for K7 and K8, the serve path's graph for K9
    # and K10, the training path's largest batch, MC_600x600_r5 with
    # dropout, for K11 and K12); under "by_path" the same fields for every
    # main path that launches it, each measured at that path's shapes with
    # that path's launch count (for K9 and K10 also "serve_mc600", the
    # largest graph, and "train", the training path)
    path_counts = {"maxcut": counts, "matcomp": mc_counts,
                   "multiblock_lp": mb_counts, "theta": th_counts,
                   **serve_counts, "train": train_counts,
                   "hallar": hallar_counts, "gather_probe": gather_counts}
    first_path = {**{name: "hallar" for name in K.LOOP_KERNELS},
                  **{name: "matcomp" for name in SPARSE_KERNELS},
                  **{name: "maxcut" for name in MAXCUT_KERNELS},
                  "lp_constr_segsum": "multiblock_lp",
                  "lp_col_wsum": "multiblock_lp",
                  **{name: "serve" for name in GNN_KERNELS},
                  "gatv2_softmax_agg_bwd": "train",
                  "graph_pool_bwd": "train",
                  "gather_rowsum": "gather_probe"}
    kernels = []
    for name, k in (*K.KERNELS.items(), *K.LOOP_KERNELS.items()):
        by_path = {path: {"launches": path_counts[path][name][0], **rows[name]}
                   for path, rows in report.items() if name in rows}
        if name in HALLAR_KERNELS:
            # HALLaR's inner loop replays CUDA graphs: the counter saw each
            # launch inside one once, at capture; the replays ran it again
            by_path["hallar"].update(
                replaces=HALLAR_REPLACES[name],
                graph_replay_launches=hallar_res["graph_runs"].get(name, 0))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"ltr_lowrank_sdp_torch/csrc/{name}.cu",
            "replaces": k.replaces,
            **by_path[first_path[name]],
            "by_path": by_path})
        if name in width_rows:
            # K9-K12 at the GNN widths (training instances, dropout on)
            kernels[-1]["widths"] = width_rows[name]
        # phase 17's paths that launched it: harvest (K1-K6), predict_all
        # (K9, K10), tune (K9-K12)
        kernels[-1]["label_path_launches"] = {
            path: c[name][0] for path, c in label_counts.items()
            if c.get(name, (0, 0))[0]}
    # K1-K8 on float32 values: launches from the float32 run of the path
    # whose shapes the row was measured at
    for name, row in report_f32.items():
        k = K.KERNELS[name]
        kernels.append({
            "name": f"{name}[float32]", "route": "cuda",
            "source": f"ltr_lowrank_sdp_torch/csrc/{name}.cu",
            "replaces": k.replaces,
            "launches": f32_counts[first_path[name]][name], **row,
            "launches_by_path": {path: c[name]
                                 for path, c in f32_counts.items()}})
    # row 16: K5 and K6 on one rank's shard of the matrix-completion cone,
    # launches from rank 0 of that path's world-size-2 sharded solve
    for name, row in shard_rows.items():
        kernels.append({
            "name": f"{name}[shard]", "route": "cuda",
            "source": f"ltr_lowrank_sdp_torch/csrc/{name}.cu",
            "replaces": SHARD_REPLACES[name],
            "launches": par_counts["matcomp-sharded2"][name][0], **row,
            "launches_by_path": {path: c[name][0]
                                 for path, c in par_counts.items()
                                 if path != "batch"}})
    # row B: K1 on one rank's block-diagonal CSR of the batched instances,
    # launches from rank 0 of the batched steps
    kernels.append({
        "name": "spmm_sym_csr[batch]", "route": "cuda",
        "source": "ltr_lowrank_sdp_torch/csrc/spmm_sym_csr.cu",
        "replaces": "ltr_lowrank_sdp_tpu/parallel/batch.py:76",
        "launches": par_counts["batch"]["spmm_sym_csr"][0], **batch_row})
    # rows 1+2 to 6 on a rank's shard: K1-K4 on rank 0 of ROW_WORLD's
    # layouts of the n = 2^20 cone, launches from the n = 2^20 row-sharded
    # solve (world size 1, column DN-R of PERF.md's table)
    for name, row in row_rows.items():
        kernels.append({
            "name": f"{name}[row]", "route": "cuda",
            "source": f"ltr_lowrank_sdp_torch/csrc/{name}.cu",
            "replaces": ROW_REPLACES[name],
            "launches": row_counts["dn20-row1"][name][0], **row,
            "launches_by_path": {path: c[name][0]
                                 for path, c in row_counts.items()}})
    for row in kernels:
        row["launch_floor_ms"] = floor_ms
    for row in UNPORTED:
        print(f"[unported] {row}")
    for row in LOOPS:
        print(f"[loop, plain torch over the kernels] {row}")
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
