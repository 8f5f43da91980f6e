#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, one line each (any failure exits non-zero):

1. build   — compile the six kernel sources of ``src/repro_torch/csrc`` for
             sm_90a with nvcc (one process per source, all started
             together); print the seconds and the card's name and power
             limit as nvidia-smi reports them.
2. main    — the paper's solver at the per-process scale of its largest
             run: Barabási–Albert n = 2^20, m = 4 (about 4.2 M undirected
             edges), ``LaplacianSolver.setup(SetupConfig(matvec_backend=
             "ell"))`` (the super-step setup, the default) and four seeded
             mean-free solves at tol 1e-6. Every solve must converge and
             pass a float64 host residual certificate (‖b − Lx‖/‖b‖ ≤
             1e-4); a repeated solve must be bitwise equal; each kernel's
             launch count, reset to 0 just before and read just after, must
             be above 0. Then, as the ``[superstep]`` line, the eager setup
             of the same graph: the levels must agree, the aggregate ids
             and elimination masks and the PCG residual history must be
             bitwise equal, and the super-step setup must have made at most
             one host fetch per constructed level plus 3; with its time,
             peak device memory and registry entries/calls per step.
3. kernels — each kernel against its plain PyTorch version on the card at
             the main path's shapes (spmv_ell and jacobi at rtol 1e-5 /
             atol 1e-6, agg_vote bit-exact), with its times, the plain
             version's, its bound, and for spmv_ell a
             ``torch.sparse_csr_tensor`` product as a yardstick. Two
             times per kernel: ``kernel_ms``, CUDA events over 20
             back-to-back wrapper calls (the wrapper's host time included,
             which is what such a call costs where the host is slower
             than the kernel), and ``device_ms``, the kernel's own device
             time per launch from ``torch.profiler`` over another 20
             calls (``trace_solve.kernel_device_ms``); a record whose
             profile shows no launch of its kernel fails. ``ms``,
             ``of_bound`` and the launches × (time − bound) sums use
             ``device_ms``. Then, as ``[levels]`` lines, spmv_ell and
             jacobi at every ELL level of the main path (launches per
             solve at that level, counted on the main path's last solve)
             and agg_vote at every aggregation level of the main setup,
             on the inputs of the setup's last vote at that level
             (launches per setup; the rows padded to the level's bucket):
             the tile plan, both times against the bound, a check against
             the plain version and a bitwise repeat. Then the k-column
             forms (``spmv_ell_block``, ``jacobi_block``: the TPU kernels
             under ``jax.vmap``) at the main path's shapes with k = 8,
             each against its plain version, bitwise on a repeat and,
             column by column, bitwise the one-vector kernel; its
             launches are those of the facade's throughput block.
4. facade  — the facade (``repro_torch.api``) on the main graph, after the
             main solver is dropped: ``Problem.from_edges`` and
             ``fingerprint()`` (seconds), ``setup(problem, SolverOptions(
             matvec_backend="ell", tol=1e-6), backend="auto")``, which must
             resolve to ``"single"`` and launch ``agg_vote``; ``solve(b)``
             bitwise equal to the main phase's direct solve of the same b;
             a seeded block of 8 right-hand sides, which must launch
             ``spmv_ell`` and ``jacobi``, converge in every column with a
             float64 host residual ≤ 1e-4, and equal looped single solves
             bit for bit (ms per right-hand side at k = 1 and 8), as must
             the block with guards off and with ``x0`` zeros; the same
             block at ``exact_columns=False`` (the reference's vmapped
             throughput path), after one warm-up solve: ms per right-hand
             side, iterations against the looped ones, host residual
             ≤ 1e-4 in every column, and the launches of each form with
             the counts set to 0 just before (the k-column kernels > 0,
             the one-vector ones 0); a second
             equal setup from the cache (``setup_seconds == 0.0``);
             ``verify="paranoid"`` and ``"cheap"``, bitwise equal with a
             passing certificate (the certificate's seconds; the check's cost per
             iteration by CUDA events on the block's shapes, and from the
             two handles' block solves in turns);
             the ladder under ``inject`` (a NaN SpMV at call 2 and a
             rebuild that raises: status ``"degraded"``, stages exactly
             primary, rebuild, diag_pcg, host residual ≤ 1e-4); a
             ``bitflip`` of the stored edge weights on the paranoid solver
             (flagged ``sdc_spmv``, recovered by the rebuild rung, bitwise
             the direct solve) and, printed only, a ``perturb``; then
             ``build_solve_step`` and the guarded ``pcg_scanned`` under
             ``torch.cuda.set_sync_debug_mode("error")``: code ``SCAN_OK``
             and x within 1e-5 of the eager PCG on the same b.
5. paper   — the paper's Fig 3 evaluation (``benchmarks/port_wda.py``).
             (a) The seven graphs of ``PAPER_FIG3`` at the paper's sizes
             (seeded stand-ins, 8,192 to 32,768 vertices), each with one
             seeded mean-free b at tol 1e-8 through the facade's
             ``single`` backend (ours, ``matvec_backend="ell"``, maxiter
             300) and its ``serial_ref`` backend (maxiter 300), both with
             the float64 certificate judging the status, and Jacobi-PCG
             on the graph's Laplacian and its ELL twin (maxiter 4000): one
             ``[paper]`` line a graph with n, nnz, the three WDAs beside
             the paper's, iterations, statuses, setup s, solve ms, the
             float64 host residuals, each solver's launches and, where a
             solver missed 1e-4, the float32 floor (the float64 direct
             solution's residual rounded to float32). No solver may report
             ``converged`` at a host residual above 1e-4. Ours and
             serial_ref must converge to a host residual ≤ 1e-4 unless
             the float32 floor is itself above 1e-4 (no float32 answer
             near the solution meets the bound); ours must launch all
             three solver kernels,
             serial_ref ``spmv_ell`` and ``jacobi`` and no ``agg_vote``,
             Jacobi-PCG ``spmv_ell``; on ``de2010`` ours' WDA must be below
             Jacobi-PCG's. (b) A Delaunay triangulation of 2^20 uniform
             points (unweighted; the class and size of DIMACS10
             delaunay_n20): the super-step setup with ``setup_ell_sweeps``
             off and on and the eager setup with it on, 4 seeded solves
             each at tol 1e-6 (host residual ≤ 1e-4); ``spmv_ell`` must
             launch in setup only with the switch on (tallied by shape and
             aggregation level), and the eager residual histories must be
             bitwise the super-step's; each aggregation level's strength
             stage is timed alone without and with the twin; Jacobi-PCG at
             tol 1e-6 is recorded, not required to converge. The sweeps
             run the k-column ``spmv_ell`` (8 vectors a launch; the
             setup's launches by form are printed). Then the k-column
             ``spmv_ell`` at every shape the sweeps-on setups launched it
             (both modes), on the setup's own last arguments at that
             shape, against its plain version, for a bitwise repeat and
             column by column against the one-vector kernel, and its
             record at the largest such shape.
             The phase's launches (read before these checks) go into the
             kernels JSON as ``paper_launches``.
6. service — the serving layer (``repro_torch.service``) at a serving
             deployment's size: eight Barabási–Albert graphs n = 2^17,
             m = 4, seeds 1–8 (generated in parallel processes, one bucket
             signature) and the main BA 2^20 graph in its own bucket,
             through ``SolverService(SolverOptions(matvec_backend="ell",
             tol=1e-6, verify="cheap"), max_batch=8)``: three tickets per
             2^17 graph (k = 1 and 4 at tol 1e-6, k = 8 at tol 1e-8 with
             max_iters 100) and two on the 2^20 graph (k = 1, 8), seeded
             and mean-free, one ``flush()``. ``stats()`` must show one
             batch of 8 setups, 1 looped, 9 solve blocks and 113 columns;
             every ticket ``converged`` with a passing certificate and a
             float64 host residual ≤ 1e-4 in every column; ``agg_vote``
             launched in the setup pass, ``spmv_ell`` and ``jacobi`` in
             the solve pass; the batched setup pass (the 8 graphs' stacked
             steps) must launch the graph-batched ``agg_vote`` and the
             one-graph one only for the agg steps of a member alone in
             its bucket (its launches by kernel, registry calls and peak
             are printed, and beside them the looped ``max_batch=1``
             pass's). Then, bitwise: the 2^20 graph's and two 2^17
             graphs' tickets against direct facade solves of the same
             columns, a ``max_batch=1`` service on those two graphs
             (batched = looped), and the re-submitted stream (cache hits
             only, no setup seconds); strict admission (the reference
             tests' hopeless grid rejected; a ``service.solve`` fault
             raising at the first group's attempt and retry requeues that
             ticket, served after its backoff); kill and resume (a child
             process on the card serves the two graphs' stream with
             ``checkpoint_every=1`` and is killed in its second group with
             ``KILL_EXIT_CODE``; a fresh service here resumes the snapshot
             and flushes bitwise the uninterrupted results). Prints
             setups/s batched and looped (wall), latency p50/p90/p99,
             solve seconds per column and peak memory, with the card's
             name and power limit. Last, spmv_ell and jacobi at the
             finest shapes of a 2^17 and the 2^20 hierarchy, on the
             flush's own last arguments there, against the plain version
             and for a bitwise repeat; and the graph-batched ``agg_vote``
             (what ``jax.vmap`` over a group of graphs makes of
             ``vote_reduce_pallas``) at the batched setup's first level
             (8 × 131,072 × 8), on its own last arguments there: bitwise
             its plain version, the one-graph kernel on each graph's
             slice and a repeat, with its record (device ms against its
             bound, the time of the eight one-graph launches beside it),
             printed last in the kernels JSON. The phase's launches (read
             before those checks) go into the kernels JSON as
             ``service_launches``.
7. spectral — the spectral layer (``repro_torch.spectral``) on a Delaunay
             triangulation of 2^15 uniform points (unweighted), with the
             entry points' default options (``exact_columns=False``) on
             ``matvec_backend="ell"``: ``lobpcg`` k = 8 at tol 1e-8 (all
             pairs converged; eigenvalues within rtol 1e-6 of scipy's
             float64 shift-invert ``eigsh``; iterations, preconditioner
             solves and columns, setup / preconditioner / host-algebra
             seconds, and the unpreconditioned method's residual after as
             many iterations), ``fiedler_bisect`` with and without the
             sweep (the sweep's conductance ≤ the sign cut's),
             ``spectral_clustering(k=4)`` and ``recursive_bisection(
             n_parts=4)`` with their cut quality, ``laplacian_pe(k=8)``
             twice from one cache (the second makes no setup and launches
             no agg_vote; both bitwise equal), and
             ``effective_resistance(n_probes=64)`` (every column's float64
             host residual ≤ 1e-4), each step with its launches by form.
             Every solve is blocked on the throughput path: the k-column
             ``spmv_ell`` and ``jacobi`` and ``agg_vote`` must launch, the
             one-vector ``spmv_ell`` and ``jacobi`` never; then the same
             kernel checks as ``service`` (on the k-column forms) at the
             mesh's finest shapes and its setup's first agg_vote level,
             and the k-column records there at k = 8 and 64; launches as
             ``spectral_launches``.
8. e2e     — the same path at n = 2^16 with the kernels and with the plain
             versions (the setup registry cleared between the two):
             identical levels, iteration counts within ±1 and ‖x_k −
             x_p‖/‖x_p‖ ≤ 1e-4. Then the super-step contracts, at a bucket
             floor of 2^20 so that two graphs of the generator (seeds 1
             and 2) land in the same buckets: a cold super-step setup with
             ``torch.cuda.set_sync_debug_mode("error")`` on from the
             plan's start to its end (lifted only in its host fetches and
             the host work after the last) completes and launches
             ``agg_vote``, and so does one with ``setup_ell_sweeps`` (its
             own registry entries), which must launch the k-column
             ``spmv_ell`` (the sweeps' 8 vectors); the
             eager loop's host syncs (mode ``"warn"``)
             are counted beside the super-step's fetches; the second graph
             adds no registry entry; the batched setups of both graphs,
             with and without ``setup_ell_sweeps``, under sync debug
             ``"error"`` too, are bitwise equal, tensor by tensor, to
             their single builds, and their vote rounds run the
             graph-batched ``agg_vote``.
9. dist    — the 2D-distributed solver (``repro_torch.dist``). (a) A
             world of one over NCCL on ``cuda:0`` (``init_world``) on the
             main graph, ``matvec_backend="ell"``, the distributed
             super-step, the default split (10,000 nnz, 3 levels): setup
             seconds (the super-step, then the host partition of each
             distributed level) and each level's ``DistLevelMeta``; the
             distributed super-step's hierarchy, built under
             ``torch.cuda.set_sync_debug_mode("error")``, bitwise the
             serial super-step's, with host fetches ≤ constructed levels
             + 3; the main phase's four right-hand sides at tol 1e-6
             through ``DistLaplacianSolver.solve_block``, guarded (codes
             0, float64 host residual ≤ 1e-4 in every column, iterations
             within one of the main phase's ``single`` solves, printed
             where they differ), unguarded and repeated (both bitwise),
             with all-reduce calls and bytes and launches per solve; the
             facade's ``dist`` backend on the same mesh (converged,
             bitwise the direct solve). The blocked solves run the matvec
             and the V-cycle on the whole block: the k-column forms of
             ``spmv_ell`` (every distributed level's rank block, and the
             tail) and ``jacobi`` (the tail) must launch, each then at
             the solves' shapes, ``agg_vote`` on every row block of the
             setup, each against its plain version (a k-column form also
             column by column against the one-vector kernel) with both
             times, the bound and launches per solve or setup.
             The kernels' launches there go into the kernels JSON as
             ``dist_launches``. (b) BA 2^18 on a 2×2 mesh of four gloo
             processes on the one card (``run_world``, joined under a
             timeout; every reduction staged through host memory): each
             rank's levels and integer decisions equal a world of one's
             on the same graph, equal iterations, the same x in every
             rank, host residual ≤ 1e-4, ``agg_vote`` and the k-column
             ``spmv_ell`` and ``jacobi`` launched, the k-column
             ``spmv_ell`` and ``agg_vote`` at the rank's block shapes
             against their plain versions; and the paper's §2.2 balance
             (``balance_report``) of the finest level with random ordering
             on and off.
10. deepfm — DeepFM serving at full width (``configs/deepfm.py::FULL``: 39
             fields, d = 10, H = 2, MLP 390-400-400-400-1, 3,729,408 table
             rows), weights from a seeded generator: 8 serve_p99 requests
             (B = 512, ``recsys_batch_stream`` steps 0-7, seed 0), one
             serve_bulk batch (B = 262,144) and one retrieval_cand call (one
             user against the 10^6 ids of field 0). Every logit and score
             must be finite; the embedding-bag launch count, reset to 0 just
             before and read just after, must rise by exactly 2 per forward
             and 1 per retrieval; with the wrappers rebound to their plain
             versions the same requests give logits and scores within
             rtol 1e-5 / atol 1e-5 and launch no kernel; 64 retrieval scores
             must match a float64 host computation. Then the kernels phase's
             ``embedding_bag`` record at the bulk batch's shapes (10,223,616
             bags, hot 2, d 10; bitwise equal to the plain version), with
             ``F.embedding_bag`` as a yardstick, the d = 1 ``first_order``
             launch's device time, a case with the sentinel ids −2, −1, V
             and V + 3, and an ids view that does not start on a 16-byte
             boundary (``flat[1:]``), which must launch the kernel. Serving
             runs under ``torch.no_grad()``: it must launch no backward.
11. train  — DeepFM training at ``FULL``, ``train_batch`` B = 65,536
             (``recsys_batch_stream(FULL.vocab_per_field, 65536,
             multi_hot=2, seed=0)``; 2,555,904 bags and 5,111,808 ids a
             step), weights from a seeded generator on the card, through
             ``configs.deepfm.make_train_step`` (loss and gradients, then
             AdamW: lr 1e-3, warm-up 5, 30 total steps, f32 moments) and
             ``TrainLoopRunner`` (30 steps, checkpoints every 10, in a
             temporary directory removed afterwards). Run A injects
             failures at steps 13 and 24 (``FailureInjector``); run B has
             none. Both failures must fire; every leaf of A's final
             parameters and optimizer state must be bitwise B's;
             ``restore_checkpoint`` of A's step 30 with ``shardings=`` (the
             card, leaf by leaf) bitwise A's state in memory; every loss
             finite and the mean of the last 5 below that of the first 5.
             The launch counts, reset to 0 just before run A and read just
             after, must show 2 ``embedding_bag`` and 2
             ``embedding_bag_backward`` launches and one
             ``bag_grad_plan`` build and launch (the batch's one id sort,
             which both tables' backward share) per step run. Prints the
             step's ms on the device (median of steps 5–29 of run B,
             synchronised), the loop's seconds per step with ``data_fn``,
             examples/s and model TFLOP/s, AdamW's ms, checkpoint save and
             restore seconds and peak GiB. Then the ``bag_grad_plan``
             record (bitwise its plain version, a stable ``torch.sort``,
             on the first batch's ids and on sentinel ids) and the
             ``embedding_bag_backward`` record at the first batch's ids
             (both tables, d = 10 and 1 over one plan; seeded output
             gradients): within 1e-6 of each row's sum of |g| of its plain
             version, bitwise equal on a repeat and without the plan,
             every row written (launched into an output full of NaN),
             sentinel ids (−1, V) giving zero rows; for each d its device
             and event times with the plan built beforehand, the plan
             alone, plan and kernel together, the plain version's time,
             ``torch.zeros(V, d).index_add_`` as the library yardstick,
             and the bound.

12. gnn   — the scalar-payload GNNs (``repro_torch.configs.meshgraphnet``,
             ``pna``, ``egnn``) training at their ``FULL`` widths on
             ``minibatch_lg``: the neighbour-sampled subgraph (batch 1024,
             fanouts 15-10, seed 0, 602 features; 169,984 node and 168,960
             edge slots) of a seeded Barabási–Albert stand-in (m = 4) for
             the 232,965-vertex graph, labels ``argmax(node_feat[:,
             :41])``, a seeded ``[E, 8]`` edge_feat (MeshGraphNet) and
             ``[N, 3]`` pos (EGNN). The launch counts are set to 0, the
             graph's two plans (``GraphBatch.with_plans``: senders,
             receivers) built, and (a) each model takes 20 steps of
             ``gnn_train_step`` on ``node_class_loss`` (AdamW lr 1e-3,
             warm-up 5): every loss finite, the mean of the last 5 below
             the first 5's, ``embedding_bag`` and ``embedding_bag_backward``
             launched by each model, exactly 2 plan builds and launches in
             all, no solver kernel; step ms (CUDA events, median of steps
             5–19), nodes/s, model TFLOP/s from the config's ``flops``,
             peak GiB. (b) Each trained model's forward with the kernels,
             twice (bitwise), against the same forward with the bag
             wrappers rebound to their plain versions (no launch; within
             1e-5 of the output's max |x|). (c) MeshGraphNet's 20 steps
             through ``TrainLoopRunner`` with a failure injected at step 11
             and checkpoints every 5: bitwise (a)'s parameters and
             optimizer state. (d) EGNN at ``molecule`` (128 graphs of 30
             nodes and 128 seeded edges, ``graph_reg_loss``, 3 plans): 10
             finite steps, then a seeded rotation and translation of pos
             leaves node_out within 1e-4 relative and moves the coordinates
             with it within 1e-4 relative. (e) ``gnn_gather_d{128,75,3}``
             (``embedding_bag`` with bags of one id over the senders:
             bitwise its plain version, ``index_select`` as the library
             yardstick) and ``gnn_scatter_d{…}`` (``embedding_bag_backward``
             over the receivers' plan: within 1e-6 of each row's sum of |m|,
             bitwise on a repeat, every row written; ``zeros(N,
             d).index_add_``) records, each with the ``path`` that ran
             (``kernels.bag_path``: ``wide`` at 128 and 75, ``narrow`` at
             3); then ``gnn_scatter_acc_d128``, the scatter's accumulate
             form into a seeded running sum: bitwise ``add_`` of the
             scatter, its bound counting the rows the receivers touch
             (read and written, counted on the card),
             ``acc.index_add_``; every record gets ``gnn_launches``, the
             launches of (a).
13. equiformer — Equiformer-v2 (``repro_torch.configs.equiformer_v2``)
             training at ``FULL`` widths (C = 128, l_max = 6, m_max = 2,
             8 heads, 602 features in, 47 out) on the gnn phase's
             ``minibatch_lg`` graph, EQF_LAYERS layers, with the config's
             edge chunk (65,536) and per-layer remat. The launch counts
             are set to 0 and the graph's 8 plans built
             (``with_plans(edge_chunk=65536)``: the endpoints' two and
             each of the 3 chunks' two). The memory plan: one step at 1, 2
             and 4 layers, their peak GiB, the per-layer slope and base.
             Then the counts are set to 0 again and (a) EQF_STEPS steps of
             ``gnn_train_step`` on ``node_class_loss`` (AdamW lr 1e-3,
             warm-up 3): every loss finite, the mean of the last 3 below
             the first 3's, both bag kernels launched, no plan built and
             no solver kernel launched in a step, the phase's own peak
             (above what was live at its start) ≤ EQF_PEAK_LIMIT_GIB;
             step ms (CUDA events, median of steps 3–7), nodes/s, model
             TFLOP/s by the config's ``flops`` and by ``flops_executed``,
             bag launches a step and the backward's by path; a chunk's
             scatter must have added into its running sum (the
             accumulate form) in (a). (b) The trained forward with the
             kernels, twice (bitwise), against the plain versions (within
             1e-5 of max |out|). (c) ``molecule`` at 12 layers: the loss
             and gradients with remat on and off, bitwise. (d) 10 steps of
             ``graph_reg_loss`` there (3 plans), then a seeded rotation
             and translation of pos moves the output by ≤ EQF_MOVE_TOL of
             its max |x|. (e) ``eqf_gather_d6272`` (``embedding_bag``, a
             chunk's 65,536 senders' rows of 6,272 floats from 169,984
             nodes: bitwise its plain version, ``index_select``) and
             ``eqf_scatter_d6272`` (``embedding_bag_backward`` over the
             chunk's receivers' plan: within 1e-6 of each row's Σ|m|,
             bitwise on a repeat, every row written; ``zeros(N,
             d).index_add_``), both on the wide path, and
             ``eqf_scatter_acc_d6272`` (its accumulate form, as
             ``gnn_scatter_acc_d128``, with ``accumulate_launches``, the
             form's launches in (a)); every record gets
             ``equiformer_launches``, the launches of the plans' build and
             (a).
14. lm     — the dense LM family (``repro_torch.models.transformer``,
             ``configs.lm_common``), after freeing what the equiformer
             phase held; bfloat16 products accumulate in float32. (a)
             qwen2-0.5b ``FULL`` (24 layers, d 896, 14 heads with kv 2,
             d_ff 4,864, vocab 151,936, bf16, remat, q_chunk 1024) trains
             LM_STEPS steps of ``lm_train_step`` on train_4k's 4,096
             tokens at global batch 16 (256 cut) in 4 microbatches
             (``lm_common.CARD_BATCH``, ``CARD_MICROBATCHES``), AdamW
             with f32 moments (lr 1e-3, warm-up 2),
             through ``TrainLoopRunner`` with a checkpoint every
             LM_CKPT_EVERY: losses finite, the last 3 below the first 3;
             step ms (CUDA events, median of steps 2–5), tokens/s, model
             TFLOP/s at 6·active params·tokens, peak GiB. (b) A run
             with (a)'s checkpoint of step 3 (hard-linked) that starts at
             step 4, where a failure is injected: the runner restores
             step 3 onto the card and replays steps 3–5, bitwise (a)'s
             parameters and moments; the embedding's gradient at a
             microbatch's Zipf ids bitwise on a repeat under
             ``torch.use_deterministic_algorithms``. (c) ``forward`` on 1 ×
             prefill_32k's 32,768 tokens without a graph: ms, tokens/s,
             peak GiB, finite logits. (d) decode_32k: B = 128 against a
             32,768-slot cache (51.5 GB, filled from a seeded generator),
             LM_DECODE_STEPS ``decode_step``s at cache_len 32,767: ms
             against the bound (bytes read and written over the HBM
             rate), the cache's storage unmoved. (e) In float32 at FULL
             widths (a copy of (a)'s weights, TF32 off), 4 sequences of 64
             tokens decoded token by token from an empty cache give
             ``forward``'s logits within 1e-4 of max |logits|; the bf16
             forward's distance from the float32 one. (f) qwen2.5-3b and
             starcoder2-3b at FULL widths and 2 layers: one step on 1 ×
             4,096 tokens, a finite loss, ms and peak GiB. (g)
             ``repro_torch.launch.train.main`` on the card: 30 steps end
             below a loss of 5.0. No kernel of the port is on this path:
             every launch count of the phase must stay 0, and each record
             gets ``lm_launches``.
15. moe    — the MoE half of the LM family (``moe_ffn``'s top-k dispatch
             and combine: cuBLAS products and plain ops, no float atomic),
             at ``lm_common``'s ``MOE_CARD_*`` cuts. (a)
             moonshot-v1-16b-a3b at ``FULL`` widths (d 2,048, 16 heads
             with kv 16, 64 experts of 1,408, top-6, 2 shared, vocab
             163,840, bf16, remat), MOE_CARD_LAYERS = 4 of 48 layers:
             MOE_STEPS steps of ``lm_train_step`` (donated) at 8 × 4,096
             tokens in 8 microbatches of 1, AdamW with f32 moments: every
             loss finite, the mean of the last 2 below the first 2's; step
             ms (median of steps 2–4), tokens/s, model TFLOP/s at
             6·active params·tokens and at the executed count (E·cap
             expert rows a layer and microbatch), peak GiB, each layer's
             dropped share of routed entries in step 1. (b) One
             microbatch's loss and every gradient leaf bitwise on a repeat
             (no deterministic-algorithms switch); layer 0's ``(idx, pos,
             keep)`` equal to a numpy recount of the capacity rule from
             its router probabilities. (c) ``forward`` on 1 × 32,768
             tokens. (d) decode at B = 32 (MOE_CARD_DECODE_BATCH) against
             a 32,768-slot cache, in place, against its bound (every
             expert's weights read). (e) arctic-480b at ``FULL`` widths,
             1 of 35 layers (128 experts, the dense residual FFN): prefill
             1 × 32,768 and decode B = 128 × 32,768 slots, forward only.
             (f) Both MoE archs' registry smoke cases on the card and a
             step of arctic's ``SMOKE`` with its int8 moments: finite.
             Every launch count must stay 0; each record gets
             ``moe_launches``.

16. dryrun — the multi-chip dry-run (``repro_torch.launch.dryrun``): each
             cell's step traced once as rank 0 of a fake process group on
             fake CUDA tensors (the solver's rank program for real), each
             job in a child process of its own (one default group a
             process), all started together. (a) On the 16×16 world:
             qwen2-0.5b train_4k, moonshot-v1-16b-a3b train_4k at FULL
             widths and DRYRUN_MOE_LAYERS of its 48 layers (its full
             depth's 4 microbatches), deepfm train_batch, meshgraphnet
             minibatch_lg, laplacian-solver rmat_16; and qwen2-0.5b
             train_4k on 2×16×16. A line each: per-rank argument and
             temporary bytes, FLOPs, HBM bytes, collective bytes by kind,
             bottleneck and roofline fraction; every field finite, every
             cell with collectives; the kernels' shape-only launches sum
             into the kernels JSON as ``dryrun_launches`` (DeepFM's and
             MeshGraphNet's must be above 0, and no real launch may come
             from a fake tensor). (b) On a 1×1 world on the card,
             qwen2-0.5b at ``lm_common``'s card shape (CARD_BATCH ×
             4,096 in CARD_MICROBATCHES, not donated, as phase ``lm``
             runs it): the predicted peak (arguments + temporaries)
             beside phase ``lm``'s measured peak, with their ratio, and
             the roofline's bound at or below ``lm``'s measured step
             time. (c) The solver's ``build_solve_step`` (rmat_16) on an
             NCCL world of one and on a fake world of one: the same
             collective calls and bytes.

Then a ``[total]`` line with the script's seconds. The line before the
last is the card's name and power limit, the one before it the kernels'
JSON record; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
MAIN_N, E2E_N = 1 << 20, 1 << 16
PAPER_SCALE = 1.0               # the Fig 3 stand-ins at the paper's sizes
PAPER_DELAUNAY_N = 1 << 20      # DIMACS10 delaunay_n20's class and size
E2E_FLOOR = 1 << 20     # above every level's n and nnz of the e2e graphs
# the service and spectral phases' sizes, halved from 2^18 (once and
# three times): their solves are bound by the host's launches (ROADMAP
# B1), so their time falls slower than n; the spectral phase's third
# halving keeps the script within its budget with the equiformer phase
SERVICE_N, SERVICE_GRAPHS = 1 << 17, 8      # one batched setup of eight
SPECTRAL_N = 1 << 15    # Delaunay points of the spectral phase
DIST_RHS = 4            # right-hand sides of the dist phase's solves
DIST_GRID_N = 1 << 18   # the dist phase's 2×2 world: BA n = 2^18
DIST_WORLD_TIMEOUT_S = 400.0
TRAIN_STEPS, TRAIN_CKPT_EVERY = 30, 10   # each run of the train phase
TRAIN_FAIL_AT = (13, 24)                 # run A's injected failures
GNN_ARCHS = ("meshgraphnet", "pna", "egnn")
GNN_BA_N = 232_965      # the vertices of minibatch_lg's full graph
GNN_BATCH, GNN_FANOUTS = 1024, (15, 10)  # its sampler: seeds, fanouts
GNN_STEPS, GNN_TIMED_FROM = 20, 5        # (a): the median of steps 5–19
GNN_CKPT_EVERY, GNN_FAIL_AT = 5, (11,)   # (c): MeshGraphNet's replay
GNN_MOLECULE_STEPS = 10
GNN_WIDTHS = (128, 75, 3)   # MeshGraphNet, PNA, EGNN's coordinates
# (b): kernels vs plain, of the output's max |x|: 7× the largest error
# measured on an H100 (1.38e-6, EGNN; PERF.md)
GNN_REL_TOL = 1e-5
EQF_STEPS, EQF_TIMED_FROM = 8, 3    # equiformer (a): median of steps 3–7
# the depth that (a) trains at minibatch_lg, and the depths whose peak
# memory gives the plan's per-layer slope and base (PERF.md §4)
EQF_LAYERS = 12
EQF_PROBE_LAYERS = (1, 2, 4)
EQF_PEAK_LIMIT_GIB = 75.0
EQF_MOVE_TOL = 1e-3     # (d): output moved by a rotation, of max |out|
# the lm phase: qwen2-0.5b FULL on train_4k's sequence, its global batch
# 256 cut to lm_common's CARD_BATCH in CARD_MICROBATCHES microbatches
# (PERF.md §4); prefill_32k's length at batch 1 (its 32 would need 318 GB
# of logits); decode_32k's B = 128 against a 32,768-slot cache
# (b) starts at its failing step 4 with (a)'s checkpoint of step 3, rather
# than training from step 0 again: 3 step calls instead of 7 (PERF.md §4)
LM_STEPS, LM_CKPT_EVERY, LM_FAIL_AT = 6, 3, (4,)
LM_TIMED_FROM = 2                        # (a): the median of steps 2–5
LM_PREFILL_BATCH = 1
LM_DECODE_STEPS = 20
LM_EQ_SEQS, LM_EQ_LEN, LM_EQ_TOL = 4, 64, 1e-4   # (e), of max |logits|
LM_OTHER = ("qwen2p5_3b", "starcoder2_3b")       # (f), at LM_OTHER_LAYERS
LM_OTHER_LAYERS = 2
LM_LAUNCHER_BAR = 5.0                    # (g): the reference test's bar
# the dryrun phase: moonshot's depth cut to fit the phase's time (the full
# depth is PERF.md §4's CPU run); the phase's bound and its jobs' timeout
DRYRUN_MOE_LAYERS = 12
DRYRUN_BUDGET_S, DRYRUN_JOB_TIMEOUT_S = 90.0, 300.0
# the moe phase: moonshot-v1-16b-a3b FULL at lm_common's MOE_CARD_* cuts
# (PERF.md §4); (a)'s steps, the median of steps 2–4, the drop shares of
# step 1 (0-based, as the median's)
MOE_STEPS, MOE_TIMED_FROM, MOE_DROP_STEP = 5, 2, 1
BF16_FLOPS_PER_S = 989e12                # H100 SXM dense bf16 tensor cores
BAG_OPS = ("repro_torch.kernels.embedding_bag",
           "repro_torch.kernels.embedding_bag.ops")
BAG_PLAIN = {"embedding_bag_kernel": "embedding_bag_ref",
             "embedding_bag_backward": "embedding_bag_backward_ref"}
REPLACES = {
    "spmv_ell": "src/repro/kernels/spmv_ell/spmv_ell.py:41",
    "jacobi": "src/repro/kernels/jacobi/jacobi.py:35",
    "agg_vote": "src/repro/kernels/agg_vote/agg_vote.py:51",
    "embedding_bag": "src/repro/kernels/embedding_bag/embedding_bag.py:36",
    # no TPU kernel: the reference differentiates the jnp.take composition
    # (XLA's scatter-add), not embedding_bag_pallas; the plan is the
    # backward's id sort
    "embedding_bag_backward": "src/repro/models/recsys/embedding.py:14",
    "bag_grad_plan": "src/repro/models/recsys/embedding.py:14",
    # the k-column forms: the same TPU kernels under jax.vmap over a column
    # axis (VMAPPED_AT)
    "spmv_ell_block": "src/repro/kernels/spmv_ell/spmv_ell.py:41",
    "jacobi_block": "src/repro/kernels/jacobi/jacobi.py:35",
}
# where the reference vmaps those kernels over the columns of a block
VMAPPED_AT = {
    "spmv_ell_block": "src/repro/core/krylov.py:311, "
                      "src/repro/sparse/matvec.py:203, "
                      "src/repro/dist/solver.py:249",
    "jacobi_block": "src/repro/core/krylov.py:312, "
                    "src/repro/dist/solver.py:250",
}
# a kernel form's module (the k-column forms share their kernel's wrapper)
BLOCK_FORMS = {"spmv_ell_block": "spmv_ell", "jacobi_block": "jacobi"}
# the graph-batched vote (the batched setup's form of agg_vote, what
# jax.vmap over a group of graphs makes of it): its own wrapper in the
# agg_vote package, beside the one-graph one
REPLACES["agg_vote_batched"] = REPLACES["agg_vote"]
VMAPPED_AT["agg_vote_batched"] = ("src/repro/core/setup_step.py:561 "
                                  "(reached from :328-334 through "
                                  "src/repro/core/aggregation.py:86-94)")
VOTE_BATCHED = ("repro_torch.kernels.agg_vote.ops", "vote_reduce_batched")


def module_of(name: str) -> str:
    """The kernel package of a kernel or kernel form's name."""
    return {**BLOCK_FORMS, "agg_vote_batched": "agg_vote"}.get(name, name)


def vote_batched():
    """The graph-batched vote's wrapper (read from the ``ops`` module)."""
    return getattr(importlib.import_module(VOTE_BATCHED[0]), VOTE_BATCHED[1])
# each kernel package's wrapper and its plain version
WRAPPERS = {
    "repro_torch.kernels.spmv_ell": ("spmv_ell", "spmv_ell_ref"),
    "repro_torch.kernels.jacobi": ("jacobi_step", "jacobi_step_ref"),
    "repro_torch.kernels.agg_vote": ("vote_reduce", "vote_reduce_ref"),
    "repro_torch.kernels.embedding_bag": ("embedding_bag_kernel",
                                          "embedding_bag_ref"),
}
SOLVER_KERNELS = ("repro_torch.kernels.spmv_ell", "repro_torch.kernels.jacobi",
                  "repro_torch.kernels.agg_vote")
# the bag backward's wrappers (its plan and itself), in the embedding_bag
# package beside the forward's (they have no place in WRAPPERS, which
# pairs one per package)
BAG_BACKWARD = ("repro_torch.kernels.embedding_bag.ops",
                ("embedding_bag_backward", "bag_grad_plan"))


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def time_ms(torch, fn, reps: int = 20) -> float:
    """Mean time of one call, by CUDA events over ``reps`` back-to-back
    calls after a warm-up: the device time where the device is the slower
    side, the host's time per call where the host is."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, kernel: str, reps: int = 20) -> tuple[float, int]:
    """The device time of one launch of ``kernel`` in ``fn`` (which launches
    it once a call), from ``torch.profiler`` over ``reps`` calls: the mean
    over the launches the profiler saw (it may miss one at the window's
    start), and the windows profiled until one saw a launch; fails if it
    saw none, or more than one a call."""
    from repro_torch.trace_solve import kernel_device_ms

    ms, count, windows = kernel_device_ms(torch, fn, kernel, reps)
    check(0 < count <= reps, f"{kernel}: the profiler saw {count} launches "
          f"of its kernel in {reps} calls in {windows} windows")
    return ms, windows


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_work(name: str, args) -> tuple[int, int]:
    """The bytes an ELL kernel must move (each input read once, each output
    written once) and the operations it does, for its wrapper's positional
    ``args``: ``spmv_ell(col, val, x)``, ``jacobi(col, val, x, b, deg)``,
    ``agg_vote(col, sq, state)``; the k-column forms ``spmv_ell_block``
    and ``jacobi_block`` on ``x`` [n_x, k] (the tables read once for all k
    columns). Only the table's real entries count."""
    col = args[0]
    n, w = col.shape
    n_x = args[2].shape[0]
    k = args[2].shape[1] if args[2].dim() == 2 else 1
    real = int((col < n_x).sum()) if name in ("spmv_ell", "jacobi",
                                              *BLOCK_FORMS) else 0
    if module_of(name) == "spmv_ell":
        return 8 * n * w + 4 * k * (n_x + n), 2 * real * k
    if module_of(name) == "jacobi":
        return 8 * n * w + 12 * k * n + 4 * n, (2 * real + 6 * n) * k
    return (8 * n * w + 4 * n_x + 8 * n,
            4 * int(((col >= 0) & (col < n_x)).sum()))


@contextlib.contextmanager
def shapes_launched(mods):
    """Within the block, tally the calls of the ELL kernels of ``mods`` by
    table shape: yields {kernel: {(n_rows, width): [calls, args, kw]}},
    with the arguments of the last call at that shape; the calls of
    ``spmv_ell`` and ``jacobi`` on ``[n, k]`` blocks (their k-column
    forms) under ``spmv_ell_block`` and ``jacobi_block``, those of the
    graph-batched vote under ``agg_vote_batched`` by ``(graphs, n_rows,
    width)``. The wrapper is
    rebound to a function that counts and calls it, so its own launch
    count rises as before."""
    tally = {}
    saved = {}
    for mod_name in mods:
        mod = importlib.import_module(mod_name)
        wrapper_name = WRAPPERS[mod_name][0]
        real = saved[mod_name] = getattr(mod, wrapper_name)
        name = mod_name.rsplit(".", 1)[1]
        forms = {1: tally.setdefault(name, {})}
        if name in BLOCK_FORMS.values():
            forms[2] = tally.setdefault(f"{name}_block", {})

        def counted(col, *args, _real=real, _forms=forms, **kw):
            counts = _forms[args[1].dim() if len(_forms) > 1 else 1]
            key = tuple(col.shape)
            calls = counts[key][0] if key in counts else 0
            counts[key] = [calls + 1, (col, *args), kw]
            return _real(col, *args, **kw)

        setattr(mod, wrapper_name, counted)
    vote_pkg = importlib.import_module("repro_torch.kernels.agg_vote")
    real_batched = vote_pkg.vote_reduce_batched
    if "repro_torch.kernels.agg_vote" in mods:
        counts_b = tally.setdefault("agg_vote_batched", {})

        def counted_batched(col, *args, **kw):
            key = tuple(col.shape)
            calls = counts_b[key][0] if key in counts_b else 0
            counts_b[key] = [calls + 1, (col, *args), kw]
            return real_batched(col, *args, **kw)

        vote_pkg.vote_reduce_batched = counted_batched
    try:
        yield tally
    finally:
        for mod_name, real in saved.items():
            setattr(importlib.import_module(mod_name),
                    WRAPPERS[mod_name][0], real)
        vote_pkg.vote_reduce_batched = real_batched


@contextlib.contextmanager
def plain_versions():
    """Rebind each kernel package's wrapper to its plain version for the
    duration of the block. The port's modules import the wrappers at call
    time, so the whole path then runs the plain versions, on the card too.
    This is a check of the kernels only; the port itself has no such
    switch."""
    saved = {}
    for mod_name, (wrapper, ref) in WRAPPERS.items():
        mod = importlib.import_module(mod_name)
        saved[mod_name] = getattr(mod, wrapper)
        setattr(mod, wrapper, getattr(mod, ref))
    try:
        yield
    finally:
        for mod_name, (wrapper, _) in WRAPPERS.items():
            setattr(importlib.import_module(mod_name), wrapper,
                    saved[mod_name])


def block_launches() -> dict:
    """The k-column forms' launch counts, by form name."""
    return {form: getattr(importlib.import_module(
        f"repro_torch.kernels.{mod}.ops"), WRAPPERS[
            f"repro_torch.kernels.{mod}"][0]).block_launches
        for form, mod in BLOCK_FORMS.items()}


def launch_counts(mods=SOLVER_KERNELS) -> tuple:
    """The launch counts of the wrappers of ``mods`` (read from the ``ops``
    modules, which :func:`plain_versions` leaves alone)."""
    return tuple(getattr(importlib.import_module(f"{m}.ops"),
                         WRAPPERS[m][0]).launches for m in mods)


def hierarchy_tensors(obj, path=""):
    """Every tensor of a hierarchy (or a tree of dicts) with its path, in a
    fixed order."""
    import dataclasses

    if hasattr(obj, "data_ptr"):
        yield path, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from hierarchy_tensors(getattr(obj, f.name),
                                         f"{path}.{f.name}")
    elif isinstance(obj, dict):
        for k in sorted(obj):
            yield from hierarchy_tensors(obj[k], f"{path}.{k}")
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            yield from hierarchy_tensors(x, f"{path}[{i}]")


def bitwise_equal(torch, ha, hb) -> bool:
    """Two hierarchies with the same structure and every tensor equal bit
    for bit."""
    la, lb = list(hierarchy_tensors(ha)), list(hierarchy_tensors(hb))
    if [p for p, _ in la] != [p for p, _ in lb]:
        return False
    for (_, x), (_, y) in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.is_floating_point():           # bits, bfloat16 included
            x, y = x.reshape(-1).view(torch.uint8), y.reshape(-1).view(
                torch.uint8)
        if not torch.equal(x, y):
            return False
    return True


def registry_line(ledger: dict) -> str:
    """The setup registry's entries/calls per step."""
    return json.dumps({k: f"{v['compiles']}/{v['calls']}"
                       for k, v in ledger["steps"].items()})


def kernel_record(torch, name, launches, err, kernel, plain, bytes_moved,
                  ops, library=None, label=None, replaces=None,
                  path=None) -> dict:
    """One kernel's entry of the ``kernels`` JSON line, printed as it is
    made: ``kernel``, ``plain`` and ``library`` are calls to time. A
    ``label`` names a record of kernel ``name`` at another path's shapes
    (the record then says ``kernel``: ``name``), ``replaces`` what it
    stands in for there; ``path`` the kernel's path that ran (the bag
    kernels': :func:`path_of`)."""
    b_ms, b_by = bound(bytes_moved, ops)
    k_ms, (d_ms, windows) = (time_ms(torch, kernel),
                             device_ms(torch, kernel, name))
    plain_ms = time_ms(torch, plain)
    library_ms = time_ms(torch, library) if library else None
    say("kernels", name=label or name, max_abs_err=err, kernel_ms=k_ms,
        device_ms=d_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        of_bound=round(b_ms / d_ms, 4), library_ms=library_ms,
        bytes=int(bytes_moved), profiler_windows=windows,
        **({} if path is None else dict(path=path)))
    rec = dict(name=label or name, route="cuda",
               source=f"src/repro_torch/csrc/{module_of(name)}.cu",
               replaces=replaces or REPLACES[name], launches=launches,
               max_abs_err=err, ms=d_ms, kernel_ms=k_ms, device_ms=d_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=library_ms)
    if path is not None:
        rec["path"] = path
    return rec if label is None else dict(rec, kernel=name)


def path_of(wrapper, call):
    """``call()`` (one launch of the bag kernel ``wrapper``) and the path
    that launch ran (``kernels.bag_path``; ``"wide_accumulate"`` for the
    backward's accumulate form): the one of ``wrapper.paths`` that rose."""
    before = dict(wrapper.paths)
    out = call()
    ran = [k for k, v in wrapper.paths.items() if v != before[k]]
    check(len(ran) == 1, f"one launch ran the paths {ran}")
    return out, ran[0]


def graph(n: int, seed: int):
    from repro_torch.graphs.generators import barabasi_albert, ensure_connected

    return ensure_connected(*barabasi_albert(n, m=4, seed=seed,
                                             weighted=True))


def host_residual(n, r, c, v, b, x):
    """‖b − Lx‖ / ‖b‖ in float64 on the host, from the input edge list: a
    float for vectors, one per column for ``(n, k)`` blocks."""
    import numpy as np
    import scipy.sparse as sp

    a = sp.csr_matrix((v.astype(np.float64), (r, c)), shape=(n, n))
    deg = np.asarray(a.sum(axis=1)).ravel()
    x = x.astype(np.float64)
    if x.ndim == 2:
        deg = deg[:, None]
    res = b.astype(np.float64) - (deg * x - a @ x)
    rel = np.linalg.norm(res, axis=0) / np.linalg.norm(b, axis=0)
    return float(rel) if x.ndim == 1 else rel


def phase_build(torch):
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    regs = {name: sorted({int(line.split("Used ")[1].split()[0])
                          for line in out.splitlines() if "Used " in line})
            for name, out in _build.build_info.get("ptxas", {}).items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("build", seconds=round(secs, 2), arch="sm_90a",
        cached=_build.build_info.get("cached"), registers=json.dumps(regs))
    print(smi, flush=True)
    return smi


def phase_main(torch, np):
    from repro_torch.core import setup_step
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver
    from repro_torch.kernels.agg_vote import vote_reduce
    from repro_torch.kernels.jacobi import jacobi_step
    from repro_torch.kernels.spmv_ell import spmv_ell

    t0 = time.perf_counter()
    n, r, c, v = graph(MAIN_N, seed=0)
    gen_s = time.perf_counter() - t0
    say("main", graph=f"barabasi_albert(n={n},m=4,seed=0)",
        undirected_edges=len(r) // 2, stored_nnz=len(r),
        generate_s=round(gen_s, 1))

    zero_launches()
    setup_step.reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with shapes_launched(SOLVER_KERNELS[2:]) as per_setup:     # agg_vote
        solver = LaplacianSolver.setup(n, r, c, v,
                                       SetupConfig(matvec_backend="ell"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup = dict(setup_s=setup_s, ledger=setup_step.counters(),
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    for i, row in enumerate(solver.stats()["levels"]):
        say("main", level=i, kind=row["kind"], n=row["n"], nnz=row["nnz"],
            ell_width=row["ell_width"], ell_spill=row["ell_spill"])
    say("main", setup_s=round(setup_s, 3))

    first_b = None
    iters = []
    for k in range(4):
        b = mean_free_block(np, n, [100 + k])[:, 0]
        first_b = b if first_b is None else first_b
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = solver.solve(b, tol=1e-6, maxiter=200)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rel = host_residual(n, r, c, v, b, x.cpu().numpy())
        iters.append(info.iters)
        say("main", rhs=k, iters=info.iters, status=info.status,
            solve_ms=round(ms, 1), wda=round(info.wda, 3),
            host_f64_rel_residual=f"{rel:.3e}")
        check(info.converged, f"solve {k} did not converge: {info.status}")
        check(rel <= 1e-4, f"solve {k}: host residual {rel:.3e} > 1e-4")
    x1, _ = solver.solve(first_b, tol=1e-6, maxiter=200)
    mark = (spmv_ell.launches, jacobi_step.launches)
    with shapes_launched(SOLVER_KERNELS[:2]) as per_shape:  # spmv, jacobi
        x2, info = solver.solve(first_b, tol=1e-6, maxiter=200)
    torch.cuda.synchronize()
    launches = dict(spmv_ell=spmv_ell.launches, jacobi=jacobi_step.launches,
                    agg_vote=vote_reduce.launches)
    check(torch.equal(x1, x2), "a repeated solve is not bitwise equal")
    say("main", bitwise_repeat=True, launches=json.dumps(launches),
        one_solve_iters=info.iters,
        one_solve_spmv_ell=spmv_ell.launches - mark[0],
        one_solve_jacobi=jacobi_step.launches - mark[1],
        one_solve_by_shape=json.dumps({k: {f"{n}x{w}": c[0] for (n, w), c
                                           in v.items()}
                                       for k, v in per_shape.items()}),
        setup_agg_vote_by_shape=json.dumps({
            f"{n}x{w}": c[0] for (n, w), c in per_setup["agg_vote"].items()}))
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    for name, mod, start in (("spmv_ell", spmv_ell, mark[0]),
                             ("jacobi", jacobi_step, mark[1])):
        tallied = sum(c[0] for c in per_shape[name].values())
        check(tallied == mod.launches - start,
              f"{name}: {tallied} calls tallied by shape, "
              f"{mod.launches - start} launches in the same solve")
    tallied = sum(c[0] for c in per_setup["agg_vote"].values())
    check(tallied == launches["agg_vote"],
          f"agg_vote: {tallied} calls tallied by shape, "
          f"{launches['agg_vote']} launches in the setup")
    setup.update(graph=(n, r, c, v), b=first_b, info=info,
                 x=x2.cpu().numpy(), iters=iters)
    return solver, launches, {**per_shape, **per_setup}, setup


def phase_superstep(torch, solver, setup) -> None:
    """The main path's super-step setup against the eager loop on the same
    graph: levels, aggregate ids and elimination masks, iterations and the
    residual history of the main path's last solve; and its host fetches
    against the one-per-level contract."""
    from repro_torch.core.coarsen import AggregationLevel
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver

    n, r, c, v = setup["graph"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = LaplacianSolver.setup(n, r, c, v, SetupConfig(
        matvec_backend="ell", setup_mode="eager"))
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    keys = ("kind", "n", "nnz", "ell_width", "ell_spill")   # capacities differ
    levels_equal = [[row[k] for k in keys] for row in solver.stats()["levels"]] \
        == [[row[k] for k in keys] for row in eager.stats()["levels"]]
    pairs = list(zip(solver.hierarchy.transfers, eager.hierarchy.transfers))
    ids_equal = levels_equal and all(
        torch.equal(ts.coarse_id, te.coarse_id)
        if isinstance(ts, AggregationLevel)
        else torch.equal(ts.elim_mask, te.elim_mask) for ts, te in pairs)
    _, info_e = eager.solve(setup["b"], tol=1e-6, maxiter=200)
    info_s = setup["info"]
    bitwise = info_s.residual_norms == info_e.residual_norms
    syncs = setup["ledger"]["host_syncs"]
    constructed = len(solver.hierarchy.transfers)
    say("superstep", n=n, setup_s=round(setup["setup_s"], 3),
        eager_setup_s=round(eager_s, 3), host_syncs=syncs,
        constructed_levels=constructed, levels_equal=levels_equal,
        ids_bitwise=ids_equal, iters=f"{info_s.iters}/{info_e.iters}",
        residual_norms_bitwise=bitwise,
        peak_gib=round(setup["peak_gib"], 3),
        registry=registry_line(setup["ledger"]))
    check(levels_equal, "super-step and eager setups built different levels")
    check(ids_equal, "super-step and eager aggregates or elimination masks "
          "differ")
    check(info_s.iters == info_e.iters and bitwise,
          "super-step and eager residual histories differ")
    check(syncs <= constructed + 3,
          f"super-step setup fetched {syncs} times for {constructed} levels")


def phase_kernels(torch, np, solver, launches, per_shape):
    from repro_torch.core.aggregation import AggregationConfig
    from repro_torch.core.coarsen import AggregationLevel
    from repro_torch.kernels.agg_vote import vote_reduce, vote_reduce_ref
    from repro_torch.kernels.jacobi import jacobi_step, jacobi_step_ref
    from repro_torch.kernels.spmv_ell import spmv_ell, spmv_ell_ref

    dev = solver.device
    gen = torch.Generator(device=dev).manual_seed(0)
    before = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    records = []

    def record(name, *args, **kw):
        records.append(kernel_record(torch, name, launches[name], *args,
                                     **kw))

    # spmv_ell: the finest level's ELL table (every PCG matvec)
    top = solver.hierarchy.transfers[0].fine
    col, val = top.ell.col, top.ell.val
    n, w = col.shape
    x = torch.randn(n, generator=gen, device=dev)
    y, y_ref = spmv_ell(col, val, x), spmv_ell_ref(col, val, x)
    torch.cuda.synchronize()
    check(torch.allclose(y, y_ref, rtol=1e-5, atol=1e-6),
          "spmv_ell disagrees with its plain version")
    csr = csr_of(torch, col, val, n)
    record("spmv_ell", (y - y_ref).abs().max().item(),
           lambda: spmv_ell(col, val, x), lambda: spmv_ell_ref(col, val, x),
           *kernel_work("spmv_ell", (col, val, x)),
           library=lambda: torch.mv(csr, x))

    # jacobi: the first aggregation level's ELL table (its smoothing sweeps)
    agg = next(t for t in solver.hierarchy.transfers
               if isinstance(t, AggregationLevel)).fine
    col, val, deg = agg.ell.col, agg.ell.val, agg.deg
    n, w = col.shape
    x = torch.randn(n, generator=gen, device=dev)
    b = torch.randn(n, generator=gen, device=dev)
    deg0 = deg.clone()
    deg0[::97] = 0.0                       # rows that must keep x as is
    out = jacobi_step(col, val, x, b, deg0)
    out_ref = jacobi_step_ref(col, val, x, b, deg0)
    torch.cuda.synchronize()
    check(torch.allclose(out, out_ref, rtol=1e-5, atol=1e-6),
          "jacobi disagrees with its plain version")
    check(torch.equal(out[::97], x[::97]), "jacobi changed a deg == 0 row")
    record("jacobi", (out - out_ref).abs().max().item(),
           lambda: jacobi_step(col, val, x, b, deg),
           lambda: jacobi_step_ref(col, val, x, b, deg),
           *kernel_work("jacobi", (col, val, x, b, deg)))

    # agg_vote: the main setup's largest vote layout (the first aggregation
    # level, its rows padded to the bucket) with its quantised strengths,
    # and a mid-round state with Decided neighbours
    cfg = AggregationConfig()
    col, sq, _ = per_shape["agg_vote"][max(per_shape["agg_vote"])][1]
    n, w = col.shape
    state = torch.randint(0, 3, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    err = 0
    for table in (sq, sq % 4):             # real strengths, then many ties
        got = vote_reduce(col, table, state, levels=cfg.strength_levels)
        want = vote_reduce_ref(col, table, state, levels=cfg.strength_levels)
        torch.cuda.synchronize()
        for g, r in zip(got, want):
            check(torch.equal(g, r), "agg_vote is not bit-exact")
            err = max(err, (g.long() - r.long()).abs().max().item())
    empty = torch.zeros((n, 0), dtype=torch.int32, device=dev)
    k0 = vote_reduce.launches
    ek, ei = vote_reduce(empty, empty, state, levels=cfg.strength_levels)
    check(vote_reduce.launches == k0, "agg_vote launched at width 0")
    check(bool((ek == torch.iinfo(torch.int32).min).all()
               and (ei == torch.iinfo(torch.int32).max).all()),
          "agg_vote width 0 is not the identity")
    record("agg_vote", err,
           lambda: vote_reduce(col, sq, state, levels=cfg.strength_levels),
           lambda: vote_reduce_ref(col, sq, state,
                                   levels=cfg.strength_levels),
           *kernel_work("agg_vote", (col, sq, state)))
    after = (spmv_ell.launches, jacobi_step.launches, vote_reduce.launches)
    check(all(a > b for a, b in zip(after, before)),
          "a kernel was not launched in the comparison phase")

    # the k-column forms at the main path's shapes for the facade's
    # throughput block of 8 (phase facade, whose launches they get):
    # spmv_ell on the finest table, jacobi on the first aggregation level's
    top_col, top_val = top.ell.col, top.ell.val
    X = torch.randn(top_col.shape[0], 8, generator=gen, device=dev)
    records.append(block_record(torch, "spmv_ell_block", top_col, top_val, X))
    n = agg.ell.col.shape[0]
    X, B = (torch.randn(n, 8, generator=gen, device=dev) for _ in range(2))
    records.append(block_record(torch, "jacobi_block", agg.ell.col,
                                agg.ell.val, X, B, agg.deg))
    return records


def csr_of(torch, col, val, n_cols):
    """The real slots of an ELL table as a CSR tensor (the library
    yardstick's operand)."""
    n = col.shape[0]
    real = col < n_cols
    crow = torch.zeros(n + 1, dtype=torch.int64, device=col.device)
    crow[1:] = torch.cumsum(real.sum(dim=1), 0)
    with warnings.catch_warnings():       # sparse CSR is a beta API
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, col[real].long(), val[real],
                                       (n, n_cols), check_invariants=False)


def block_record(torch, name, col, val, X, B=None, deg=None, launches=0,
                 label=None) -> dict:
    """A k-column form's entry of the ``kernels`` JSON line on ``X`` [n, k]
    (and ``B``, ``deg`` for ``jacobi_block``): against its plain version
    (rtol 1e-5 / atol 1e-6), bitwise on a repeat and, column by column,
    bitwise the one-vector kernel; its times, bound and, for
    ``spmv_ell_block``, ``torch.sparse.mm`` of the table's CSR by ``X`` as
    the library yardstick. ``launches`` is replaced by the path's own
    count where the record is of a main path's shapes."""
    mod = f"repro_torch.kernels.{module_of(name)}"
    run, plain = (getattr(importlib.import_module(mod), f)
                  for f in WRAPPERS[mod])
    args = (col, val, X) if B is None else (col, val, X, B, deg)
    got, want, again = run(*args), plain(*args), run(*args)
    torch.cuda.synchronize()
    where = f"{label or name} ({tuple(col.shape)}, k={X.shape[1]})"
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
          f"{where} disagrees with its plain version")
    check(torch.equal(got, again), f"{where} is not bitwise repeatable")
    check(columns_bitwise(torch, run, args, {}, got),
          f"{where}: a column differs from the one-vector kernel")
    library = None
    if B is None:
        csr = csr_of(torch, col, val, X.shape[0])
        library = lambda: torch.sparse.mm(csr, X)          # noqa: E731
    rec = kernel_record(torch, name, launches,
                        (got - want).abs().max().item(),
                        lambda: run(*args), lambda: plain(*args),
                        *kernel_work(name, args), library=library,
                        label=label)
    from repro_torch.kernels import ell_block_tile_plan

    rec.update(rows=col.shape[0], width=col.shape[1], k=X.shape[1],
               plan=list(ell_block_tile_plan(col.shape[1], X.shape[1])),
               vmapped_at=VMAPPED_AT[name])
    return rec


def phase_levels(torch, solver, per_shape) -> None:
    """spmv_ell and jacobi at every ELL level where the main path's last
    solve ran them, agg_vote at every aggregation level where its setup
    did (``per_shape``, from ``phase_main``): tile plan, both times against
    the bound, and launches per solve or per setup at that level; each
    checked against its plain version and for a bitwise repeat."""
    from repro_torch.core.coarsen import AggregationLevel
    from repro_torch.core.graph import pow2_bucket
    from repro_torch.kernels import ell_tile_plan
    from repro_torch.kernels.agg_vote import vote_reduce, vote_reduce_ref
    from repro_torch.kernels.jacobi import jacobi_step, jacobi_step_ref
    from repro_torch.kernels.spmv_ell import spmv_ell, spmv_ell_ref

    ts = solver.hierarchy.transfers
    levels = [t.fine for t in ts] + [ts[-1].coarse] if ts else []
    gen = torch.Generator(device=solver.device).manual_seed(1)
    gap = {"spmv_ell": 0.0, "jacobi": 0.0, "agg_vote": 0.0}
    measured = {"spmv_ell": 0, "jacobi": 0, "agg_vote": 0}

    def line(name, i, n, w, kernel, plain, same, bytes_moved, ops, calls,
             unit, **extra):
        got, want = kernel(), plain()
        again = kernel()
        torch.cuda.synchronize()
        check(same(got, want),
              f"{name} disagrees with its plain version at level {i}")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{name} is not bitwise repeatable at level {i}")
        k_ms, (d_ms, windows) = (time_ms(torch, kernel),
                                 device_ms(torch, kernel, name))
        b_ms, b_by = bound(bytes_moved, ops)
        gap[name] += calls * (d_ms - b_ms)
        measured[name] += 1
        say("levels", kernel=name, level=i, n=n, **extra, width=w,
            plan=json.dumps(ell_tile_plan(w)), kernel_ms=k_ms,
            device_ms=d_ms, bound_ms=b_ms, bound_by=b_by,
            of_bound=round(b_ms / d_ms, 4), **{f"launches_per_{unit}": calls},
            profiler_windows=windows, max_abs_err=max(float((g.double() - r.double()).abs().max())
                            for g, r in zip(got, want)))

    for i, level in enumerate(levels):
        ell = getattr(level, "ell", None)
        if ell is None or ell.width == 0:
            continue
        col, val = ell.col, ell.val
        n, w = col.shape
        x = torch.randn(ell.n_cols, generator=gen, device=solver.device)
        b = torch.randn(n, generator=gen, device=solver.device)
        runs = {
            "spmv_ell": (lambda: (spmv_ell(col, val, x),),
                         lambda: (spmv_ell_ref(col, val, x),),
                         *kernel_work("spmv_ell", (col, val, x))),
            "jacobi": (lambda: (jacobi_step(col, val, x, b, level.deg),),
                       lambda: (jacobi_step_ref(col, val, x, b, level.deg),),
                       *kernel_work("jacobi", (col, val, x, b, level.deg))),
        }
        for name, (kernel, plain, bytes_moved, ops) in runs.items():
            calls = per_shape[name].get((n, w), [0])[0]
            if calls == 0:                 # not run at this level
                continue
            line(name, i, n, w, kernel, plain,
                 lambda g, r: torch.allclose(g[0], r[0], rtol=1e-5,
                                             atol=1e-6),
                 bytes_moved, ops, calls, "solve")
    # the setup votes at the aggregation levels' rows padded to buckets
    agg_levels = [i for i, t in enumerate(ts)
                  if isinstance(t, AggregationLevel)]
    for (n_cap, w), (calls, args, kw) in sorted(
            per_shape["agg_vote"].items(), reverse=True):
        at = [i for i in agg_levels if pow2_bucket(levels[i].n) == n_cap]
        line("agg_vote", at[0] if at else -1,
             ",".join(str(levels[i].n) for i in at), w,
             lambda: vote_reduce(*args, **kw),
             lambda: vote_reduce_ref(*args, **kw),
             lambda g, r: all(torch.equal(a, b) for a, b in zip(g, r)),
             *kernel_work("agg_vote", args), calls,
             "setup", n_cap=n_cap)
    for name, count in measured.items():
        check(count > 0, f"{name}: no level of the main path measured")
    say("levels", launches_x_gap_ms=json.dumps(
        dict(spmv_ell_per_solve=gap["spmv_ell"],
             jacobi_per_solve=gap["jacobi"],
             agg_vote_per_setup=gap["agg_vote"])))


def bits_equal(np, a, b) -> bool:
    """Two float32 host arrays equal bit for bit."""
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def phase_facade(torch, np, setup) -> dict:
    """The facade (``repro_torch.api``) on the main graph: the Problem, a
    setup through backend "auto", one and eight right-hand sides against
    the direct solve and looped solves, the cache, paranoid verification,
    the degradation ladder and silent-corruption detection under injected
    faults, and the scanned solve under sync debug mode "error". Returns
    each solver kernel's launches on the facade's path (agg_vote in its
    setup, spmv_ell and jacobi in its solves of one and eight
    right-hand sides, and embedding_bag over the whole phase, which must
    be 0)."""
    from repro_torch.api import Problem, SolverOptions
    from repro_torch.api import setup as api_setup
    from repro_torch.core.krylov import SCAN_OK, pcg, pcg_scanned
    from repro_torch.core.verify import certify
    from repro_torch.kernels.agg_vote import vote_reduce
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.jacobi import jacobi_step
    from repro_torch.kernels.spmv_ell import spmv_ell
    from repro_torch.testing import Fault, FaultPlan, inject

    bag_ops.embedding_bag_kernel.launches = 0   # not on the facade's path
    bag_ops.embedding_bag_backward.launches = 0
    bag_ops.bag_grad_plan.launches = 0
    n, r, c, v = setup["graph"]
    b0, x_direct = setup["b"], setup["x"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # 1. the problem, and a setup through backend "auto"
    problem, build_s = timed(lambda: Problem.from_edges(n, r, c, v))
    fp, fp_s = timed(problem.fingerprint)
    opts = SolverOptions(matvec_backend="ell", tol=1e-6)
    vote_reduce.launches = 0
    solver, setup_s = timed(lambda: api_setup(problem, opts, backend="auto"))
    votes = vote_reduce.launches
    say("facade", step="problem", n=n, stored_nnz=len(problem.rows),
        from_edges_s=round(build_s, 3), fingerprint_s=round(fp_s, 3),
        fingerprint=fp[:16], backend=solver.backend,
        setup_s=round(setup_s, 3), agg_vote_launches=votes)
    check(solver.backend == "single",
          f"backend auto resolved to {solver.backend!r} on one card")
    check(votes > 0, "the facade's setup launched no agg_vote kernel")

    # 2. one right-hand side, then a block of 8
    spmv_ell.launches = jacobi_step.launches = 0
    (x, res), one_s = timed(lambda: solver.solve(b0))
    B = np.random.default_rng(200).normal(size=(n, 8)).astype(np.float32)
    B -= B.mean(axis=0)
    (X, res_b), block_s = timed(lambda: solver.solve(B))
    launched = dict(spmv_ell=spmv_ell.launches, jacobi=jacobi_step.launches)
    looped_s, same, iters_same = 0.0, [], []
    for j in range(B.shape[1]):
        (xj, rj), sec = timed(lambda: solver.solve(B[:, j]))
        looped_s += sec
        same.append(bits_equal(np, X[:, j], xj))
        iters_same.append(rj.iters == res_b.iters_per_rhs[j])
    rels = host_residual(n, r, c, v, B, X)
    X_ng = solver._handle.solve_block(B, 1e-6, 200, guard=False)[0]
    X_z, _ = solver.solve(B, x0=np.zeros_like(B))
    pairs = dict(guards_off=bits_equal(np, X_ng, X),
                 x0_zeros=bits_equal(np, X_z, X))
    say("facade", step="solve", direct_bitwise=bits_equal(np, x, x_direct),
        iters=res.iters, ms_per_rhs_k1=one_s * 1e3,
        ms_per_rhs_k8=block_s * 1e3 / 8, looped_ms_per_rhs=looped_s * 1e3 / 8,
        block_iters=json.dumps(res_b.iters_per_rhs.tolist()),
        statuses=json.dumps(res_b.statuses.tolist()),
        blocked_vs_looped_bitwise=json.dumps(same),
        bitwise=json.dumps(pairs),
        max_host_f64_rel_residual=f"{rels.max():.3e}",
        launches=json.dumps(launched))
    check(bits_equal(np, x, x_direct),
          "the facade's solve is not bitwise equal to the direct solve")
    check(all(count > 0 for count in launched.values()),
          f"a solver kernel was not launched through the facade: {launched}")
    check(all(same) and all(iters_same),
          "blocked columns differ from looped solves")
    check(all(pairs.values()), f"bitwise pairs {pairs}")
    check(res_b.converged and all(s == "converged" for s in res_b.statuses),
          f"a column did not converge: {res_b.statuses.tolist()}")
    check(bool((rels <= 1e-4).all()), f"host residuals {rels.tolist()}")
    throughput = phase_facade_throughput(torch, np, problem, opts, B, res_b,
                                         block_s, looped_s, (n, r, c, v))

    # 3. the cache
    again = api_setup(problem, opts, backend="auto")
    say("facade", step="cache", setup_seconds=again.setup_seconds)
    check(again.setup_seconds == 0.0, "an equal setup missed the cache")

    # 4. paranoid verification; the check's cost from the two handles'
    # block solves in turns (off, paranoid, paranoid, off), no certificate
    popts = SolverOptions(matvec_backend="ell", tol=1e-6, verify="paranoid")
    par, par_setup_s = timed(lambda: api_setup(problem, popts,
                                               backend="auto"))
    (X_p, res_p), par_s = timed(lambda: par.solve(B))
    cert, cert_s = timed(lambda: certify(problem, B, X, 1e-6))
    turns = {False: [], True: []}
    for checked in (False, True, True, False):
        handle = (par if checked else solver)._handle
        turns[checked].append(timed(lambda: handle.solve_block(
            B, 1e-6, 200))[1])
    overhead = ((min(turns[True]) - min(turns[False])) * 1e3
                / max(res_b.iters, 1))
    # what the check adds to one iteration of the block: stacking P and Ap
    # (8 columns each) and the check's reductions, by CUDA events
    cols = [torch.as_tensor(B[:, j], device=par._handle._solver.device)
            for j in range(B.shape[1])]
    chk = par._handle._check
    check_ms = time_ms(torch, lambda: chk(torch.stack(cols, 1),
                                          torch.stack(cols, 1)))
    say("facade", step="verify", mode="paranoid",
        setup_s=round(par_setup_s, 3), bitwise=bits_equal(np, X_p, X),
        certificate_passed=res_p.certificate.passed,
        certificate_max_rel=f"{max(res_p.certificate.rel_residuals):.3e}",
        certificate_s=round(cert_s, 3), solve_ms=par_s * 1e3,
        block_ms_off=json.dumps([round(t * 1e3, 1) for t in turns[False]]),
        block_ms_paranoid=json.dumps([round(t * 1e3, 1)
                                      for t in turns[True]]),
        turns_overhead_ms_per_iteration=round(overhead, 3),
        check_ms_per_iteration=round(check_ms, 4))
    check(bits_equal(np, X_p, X),
          "verify='paranoid' changed the solution bits")
    check(res_p.certificate.passed and cert.passed,
          "the certificate refused a clean solve")
    copts = SolverOptions(matvec_backend="ell", tol=1e-6, verify="cheap")
    x_c, res_c = api_setup(problem, copts, backend="auto").solve(b0)
    say("facade", step="verify", mode="cheap",
        direct_bitwise=bits_equal(np, x_c, x_direct),
        certificate_passed=res_c.certificate.passed)
    check(bits_equal(np, x_c, x_direct) and res_c.certificate.passed,
          "verify='cheap' changed the solution bits or refused it")

    # 5. the ladder: a NaN SpMV in the primary solve, a rebuild that raises
    plan = FaultPlan({"solve.spmv": Fault("nan", at_calls=(2,)),
                      "setup.build": Fault("raise", at_calls=(0,))})
    with inject(plan):
        (x_l, res_l), ladder_s = timed(lambda: solver.solve(b0,
                                                            max_iters=1000))
    stages = [d["stage"] for d in res_l.diagnostics]
    rel_l = host_residual(n, r, c, v, b0, x_l)
    say("facade", step="ladder", status=res_l.status,
        stages=json.dumps(stages), fired=json.dumps(plan.fired),
        rung_statuses=json.dumps([d["status"] for d in res_l.diagnostics]),
        diag_pcg_iters=res_l.iters, seconds=round(ladder_s, 3),
        host_f64_rel_residual=f"{rel_l:.3e}")
    check(res_l.status == "degraded" and plan.fired,
          f"the ladder ended {res_l.status!r}, fired {plan.fired}")
    check(stages == ["primary", "rebuild", "diag_pcg"],
          f"ladder stages {stages}")
    check(rel_l <= 1e-4, f"ladder host residual {rel_l:.3e}")

    # silent corruption of the stored edge weights, on the paranoid solver
    for mode in ("bitflip", "perturb"):
        plan = FaultPlan({"sdc.edge_weights": Fault(mode, at_calls=(0,))})
        with inject(plan):
            (x_s, res_s), sdc_s = timed(lambda: par.solve(b0))
        stages = [d["stage"] for d in res_s.diagnostics]
        primary = res_s.diagnostics[0]["statuses"] if stages else []
        say("facade", step="sdc", mode=mode, status=res_s.status,
            stages=json.dumps(stages), primary=json.dumps(primary),
            certificate_passed=res_s.certificate.passed,
            direct_bitwise=bits_equal(np, x_s, x_direct),
            seconds=round(sdc_s, 3))
        if mode == "bitflip":
            check(primary == ["sdc_spmv"] and stages == ["primary",
                                                         "rebuild"],
                  f"bitflip: primary {primary}, stages {stages}")
            check(res_s.status == "degraded" and res_s.certificate.passed
                  and bits_equal(np, x_s, x_direct),
                  "the rebuild rung did not recover the flagged column")

    # 6. the scanned solve: no host read inside
    lsolver = solver._handle._solver
    b_int = lsolver._to_internal(torch.as_tensor(b0, device=lsolver.device))
    (x_e, info_e), eager_s = timed(lambda: pcg(
        lsolver.matvec, b_int, precond=lsolver.precondition, tol=1e-6,
        maxiter=200))
    step = lsolver.build_solve_step(info_e.iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x_u, norms_u = step(b_int)
        x_g, norms_g, code = pcg_scanned(
            lsolver.matvec, b_int, precond=lsolver.precondition,
            n_iters=info_e.iters, guard=True, tol=1e-6)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    diffs = [float(torch.linalg.norm(a - x_e) / torch.linalg.norm(x_e))
             for a in (x_u, x_g)]
    say("facade", step="scanned", sync_debug="error", n_iters=info_e.iters,
        code=int(code), rel_diff_unguarded=f"{diffs[0]:.3e}",
        rel_diff_guarded=f"{diffs[1]:.3e}",
        bitwise=bool(torch.equal(x_u, x_e) and torch.equal(x_g, x_e)),
        eager_ms=eager_s * 1e3, two_scanned_ms=scan_s * 1e3)
    check(int(code) == SCAN_OK, f"guarded scanned solve code {int(code)}")
    check(max(diffs) <= 1e-5, f"scanned solves differ from eager: {diffs}")
    bags = bag_ops.embedding_bag_kernel.launches
    grads = bag_ops.embedding_bag_backward.launches
    plans = bag_ops.bag_grad_plan.launches
    check(bags == grads == plans == 0, f"the facade's path launched "
          f"embedding_bag {bags}, its backward {grads} and its plan {plans} "
          "times")
    return dict(launched, agg_vote=votes, embedding_bag=bags,
                embedding_bag_backward=grads, bag_grad_plan=plans,
                **throughput)


def phase_facade_throughput(torch, np, problem, opts, B, res_b, block_s,
                            looped_s, graph) -> dict:
    """Step 2b of phase facade: the block of 8 again at
    ``exact_columns=False``, the reference's vmapped throughput path, after
    one warm-up solve: ms per right-hand side beside the exact block's and
    the looped solves', per-column iterations against the looped ones
    (``res_b``'s, which equal them), a float64 host residual ≤ 1e-4 in
    every column, and the launches of each form in the timed solve, the
    counts set to 0 just before it: the k-column kernels > 0, the
    one-vector kernels 0. Returns those launches by form."""
    from repro_torch.api import setup as api_setup

    n, r, c, v = graph
    topts = dataclasses.replace(opts, exact_columns=False)
    # out of the process-wide cache, so that its hierarchy is freed here
    tsolver = api_setup(problem, topts, backend="auto", cache=False)
    tsolver.solve(B)                                   # warm
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X_t, res_t = tsolver.solve(B)
    torch.cuda.synchronize()
    thr_s = time.perf_counter() - t0
    forms = ("spmv_ell", "jacobi", *BLOCK_FORMS)
    launched = {k: phase_launches()[k] for k in forms}
    rels = host_residual(n, r, c, v, B, X_t)
    say("facade", step="throughput", exact_columns=False,
        ms_per_rhs_k8=thr_s * 1e3 / 8,
        exact_ms_per_rhs_k8=block_s * 1e3 / 8,
        looped_ms_per_rhs=looped_s * 1e3 / 8,
        block_iters=json.dumps(res_t.iters_per_rhs.tolist()),
        looped_iters=json.dumps(res_b.iters_per_rhs.tolist()),
        statuses=json.dumps(res_t.statuses.tolist()),
        max_host_f64_rel_residual=f"{rels.max():.3e}",
        launches=json.dumps(launched))
    check(res_t.converged and all(s == "converged" for s in res_t.statuses),
          f"throughput block: {res_t.statuses.tolist()}")
    check(bool((rels <= 1e-4).all()), f"throughput host residuals "
          f"{rels.tolist()}")
    check(all(launched[k] > 0 for k in BLOCK_FORMS)
          and launched["spmv_ell"] == launched["jacobi"] == 0,
          f"the throughput block launched {launched}")
    return {k: launched[k] for k in BLOCK_FORMS}


def _bag_backward() -> dict:
    """The bag backward's wrappers by name."""
    mod = importlib.import_module(BAG_BACKWARD[0])
    return {name: getattr(mod, name) for name in BAG_BACKWARD[1]}


def phase_launches() -> dict:
    """Every kernel's launch count, by kernel name (the k-column forms by
    form name)."""
    counts = dict(zip((m.rsplit(".", 1)[1] for m in WRAPPERS),
                      launch_counts(tuple(WRAPPERS))))
    return dict(counts, **block_launches(),
                agg_vote_batched=vote_batched().launches,
                **{name: fn.launches for name, fn in _bag_backward().items()})


def zero_launches() -> None:
    for mod_name, (wrapper, _) in WRAPPERS.items():
        fn = getattr(importlib.import_module(f"{mod_name}.ops"), wrapper)
        fn.launches = 0
        if hasattr(fn, "block_launches"):
            fn.block_launches = 0
    for fn in _bag_backward().values():
        fn.launches = 0
    vote_batched().launches = 0


def phase_paper(torch, np) -> dict:
    """The paper's Fig 3 evaluation on the card. (a) The seven graphs of
    ``PAPER_FIG3`` at the paper's sizes, each through the facade's
    ``single`` (ours) and ``serial_ref`` backends under the float64
    certificate, and Jacobi-PCG (``benchmarks/port_wda.py``'s
    ``fig3_row``). (b) A Delaunay triangulation of 2^20 points through the
    super-step setup with ``setup_ell_sweeps`` off and on, the eager setup
    with it on, and Jacobi-PCG; then the sweeps' ``spmv_ell`` shapes
    against the plain version. Returns each kernel's launches over the
    phase before that check."""
    from benchmarks.port_wda import PAPER_FIG3, fig3_row

    t0 = time.perf_counter()
    zero_launches()
    ok_status = ("converged", "max_iters")
    for name in PAPER_FIG3:
        row = fig3_row(torch, name, scale=PAPER_SCALE, tol=1e-8, seed=0)
        ours, ser, jac = row["ours"], row["serial_ref"], row["jacobi_pcg"]
        floor = row["float32_floor"]
        say("paper", graph=name, n=row["n"], nnz=row["nnz"],
            wda=json.dumps(dict(serial_ref=ser["wda"], ours=ours["wda"],
                                jacobi_pcg=jac["wda"])),
            paper=json.dumps(dict(lamg=row["paper_lamg"],
                                  ours=row["paper_ours"],
                                  pcg=row["paper_pcg"])),
            iters=f"{ser['iters']}/{ours['iters']}/{jac['iters']}",
            status=f"{ser['status']}/{ours['status']}/{jac['status']}",
            levels=f"{ser['levels']}/{ours['levels']}",
            setup_s=f"{ser['setup_s']:.3f}/{ours['setup_s']:.3f}",
            solve_ms=f"{ser['solve_ms']:.1f}/{ours['solve_ms']:.1f}/"
                     f"{jac['solve_ms']:.1f}",
            host_f64_rel_residual=f"{ser['host_residual']:.3e}/"
                                  f"{ours['host_residual']:.3e}/"
                                  f"{jac['host_residual']:.3e}",
            float32_floor=json.dumps(floor),
            launches=json.dumps(dict(serial_ref=ser["launches"],
                                     ours=ours["launches"],
                                     jacobi_pcg=jac["launches"])))
        for who, res in (("ours", ours), ("serial_ref", ser),
                         ("jacobi_pcg", jac)):
            check(res["status"] != "converged" or res["host_residual"] <= 1e-4,
                  f"{name} {who}: reports converged at host residual "
                  f"{res['host_residual']:.3e}")
        # the bound is required unless the float64 solution rounded to
        # float32 already misses it: then the status check above holds
        beyond_f32 = floor is not None and floor["f32_rounded_residual"] > 1e-4
        for who, res in (("ours", ours), ("serial_ref", ser)):
            check(beyond_f32 or (res["host_residual"] <= 1e-4
                                 and res["status"] in ok_status),
                  f"{name} {who}: status {res['status']}, host residual "
                  f"{res['host_residual']:.3e}, float32 floor {floor}")
        check(all(v > 0 for v in ours["launches"].values()),
              f"{name} ours launched {ours['launches']}")
        check(ser["launches"]["spmv_ell"] > 0 and ser["launches"]["jacobi"] > 0
              and ser["launches"]["agg_vote"] == 0,
              f"{name} serial_ref launched {ser['launches']}")
        check(jac["launches"]["spmv_ell"] > 0,
              f"{name} Jacobi-PCG launched {jac['launches']}")
        if name == "de2010":
            check(ours["wda"] < jac["wda"], f"de2010: ours' WDA "
                  f"{ours['wda']:.3f} is not below Jacobi-PCG's "
                  f"{jac['wda']:.3f}")
    sweeps_shapes, twin_rec = phase_paper_delaunay(torch, np)
    launched = phase_launches()
    check_setup_sweeps(torch, sweeps_shapes)
    say("paper", seconds=round(time.perf_counter() - t0, 1))
    return dict(launched, records=[twin_rec])


def check_setup_sweeps(torch, shapes) -> None:
    """The k-column ``spmv_ell`` at every (rows, width) where a sweeps-on
    setup launched it, on that setup's last arguments at the shape
    (``check_kernel_shapes``)."""
    check_kernel_shapes(torch, "paper", [
        ("spmv_ell_block", shape, entry, dict(step="setup_spmv_ell",
                                              setup_mode=mode))
        for mode, tally in shapes.items()
        for shape, entry in sorted(tally.items())])


def check_kernel_shapes(torch, phase, picks) -> None:
    """Each solver kernel on a phase's own last arguments at a shape it
    launched at: ``picks`` holds ``(kernel, (rows, width), (calls, args,
    kw), labels)`` from ``shapes_launched``. Against the plain version
    (spmv_ell and jacobi at rtol 1e-5 / atol 1e-6, agg_vote bit-exact) and
    for a bitwise repeat; a k-column form also column by column, bitwise
    against the one-vector kernel."""
    for name, (rows, w), (calls, args, kw), labels in picks:
        mod = importlib.import_module(
            f"repro_torch.kernels.{module_of(name)}")
        wrapper, ref = WRAPPERS[mod.__name__]
        run, plain = getattr(mod, wrapper), getattr(mod, ref)
        got, want, again = (run(*args, **kw), plain(*args, **kw),
                            run(*args, **kw))
        torch.cuda.synchronize()
        got, want, again = ((o,) if torch.is_tensor(o) else tuple(o)
                            for o in (got, want, again))
        err = max(float((g.double() - r.double()).abs().max())
                  for g, r in zip(got, want))
        say(phase, **labels, kernel=name, rows=rows, width=w,
            launches=calls, max_abs_err=err)
        where = f"{phase} {name} ({labels}, {rows}x{w})"
        if name == "agg_vote":
            check(all(torch.equal(g, r) for g, r in zip(got, want)),
                  f"{where} is not bit-exact against its plain version")
        else:
            check(all(torch.allclose(g, r, rtol=1e-5, atol=1e-6)
                      for g, r in zip(got, want)),
                  f"{where} disagrees with its plain version: max abs err "
                  f"{err:.3e}")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{where} is not bitwise repeatable")
        if name in BLOCK_FORMS:
            check(columns_bitwise(torch, run, args, kw, got[0]),
                  f"{where}: a column differs from the one-vector kernel")


def columns_bitwise(torch, run, args, kw, block) -> bool:
    """Each column j of a k-column result ``block`` of ``run(*args)`` (x,
    and b for jacobi, ``[n, k]``) bitwise the one-vector kernel on column
    j."""
    cols = [i for i, a in enumerate(args) if a.dim() == 2 and i >= 2]
    for j in range(block.shape[1]):
        one = list(args)
        for i in cols:
            one[i] = args[i][:, j].contiguous()
        if not torch.equal(run(*one, **kw), block[:, j]):
            return False
    return True


def phase_paper_delaunay(torch, np) -> dict:
    """Part (b): Delaunay n = 2^20 (unweighted, planar; the class and size
    of DIMACS10 delaunay_n20), the super-step setup with
    ``setup_ell_sweeps`` off and on (spmv_ell launched in setup only with it
    on, tallied by shape), 4 seeded solves each at tol 1e-6 with a float64
    host residual ≤ 1e-4, the eager setup with it on (residual histories
    bitwise the super-step's), each aggregation level's strength stage
    timed alone without and with the twin, and Jacobi-PCG (recorded, not
    required to converge, never reporting a convergence that the host
    residual refutes). Returns the sweeps-on setups' ``spmv_ell`` calls by
    shape, each with its last arguments, by setup mode."""
    from repro_torch.core.coarsen import AggregationLevel
    from repro_torch.core.graph import attach_setup_twin, pow2_bucket
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.krylov import jacobi_pcg
    from repro_torch.core.solver import LaplacianSolver
    from repro_torch.core.strength import algebraic_distance_strength
    from repro_torch.core.wda import wda
    from repro_torch.graphs.generators import delaunay, ensure_connected
    from repro_torch.kernels.spmv_ell import spmv_ell
    from repro_torch.sparse.ell import ell_layout_traced

    t0 = time.perf_counter()
    n, r, c, v = ensure_connected(*delaunay(PAPER_DELAUNAY_N, seed=0))
    gen_s = time.perf_counter() - t0
    deg = np.bincount(r, minlength=n)
    say("paper", graph=f"delaunay(n={n},seed=0)", stored_nnz=len(r),
        max_degree=int(deg.max()), degree_p95=float(np.percentile(deg, 95)),
        generate_s=round(gen_s, 1))
    rhs = []
    for k in range(4):
        b = np.random.default_rng(300 + k).normal(size=n).astype(np.float32)
        rhs.append(b - b.mean())

    def run(sweeps, mode):
        cfg = SetupConfig(matvec_backend="ell", setup_ell_sweeps=sweeps,
                          setup_mode=mode)
        torch.cuda.synchronize()
        k0, t0 = phase_launches(), time.perf_counter()
        with shapes_launched(SOLVER_KERNELS[:1]) as tally:
            solver = LaplacianSolver.setup(n, r, c, v, cfg)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        # the setup's launches by form: the sweeps' k-column spmv_ell (8
        # vectors a sweep, as the reference's vmap), λmax's one-vector one
        in_setup = {k: phase_launches()[k] - k0[k]
                    for k in ("spmv_ell", "spmv_ell_block")}
        ts = solver.hierarchy.transfers
        agg_ns = [t.fine.n for t in ts if isinstance(t, AggregationLevel)]
        by_level = {}
        for (rows, w), (calls, _, _) in tally["spmv_ell_block"].items():
            at = [m for m in agg_ns if rows in (m, pow2_bucket(m))]
            by_level[f"{','.join(map(str, at)) or '?'}:{rows}x{w}"] = calls
        solves = []
        for k, b in enumerate(rhs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x, info = solver.solve(b, tol=1e-6, maxiter=200)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rel = host_residual(n, r, c, v, b, x.cpu().numpy())
            solves.append((info, ms, rel))
            check(info.converged and rel <= 1e-4,
                  f"delaunay sweeps={sweeps} {mode} rhs {k}: {info.status}, "
                  f"host residual {rel:.3e}")
        say("paper", graph="delaunay_2^20", setup_ell_sweeps=sweeps,
            setup_mode=mode, setup_s=round(setup_s, 3),
            levels=json.dumps([(row["kind"], row["n"])
                               for row in solver.stats()["levels"]]),
            setup_launches=json.dumps(in_setup),
            setup_spmv_ell_block_by_level=json.dumps(by_level),
            iters=json.dumps([s[0].iters for s in solves]),
            solve_ms=json.dumps([round(s[1], 1) for s in solves]),
            wda=round(solves[0][0].wda, 3),
            host_f64_rel_residual=f"{max(s[2] for s in solves):.3e}")
        return (solver, in_setup, [s[0].residual_norms for s in solves],
                tally["spmv_ell_block"])

    off, off_launches, _, _ = run(False, "superstep")
    check(not any(off_launches.values()), f"spmv_ell launched "
          f"{off_launches} in a setup without setup_ell_sweeps")
    del off
    on, on_launches, hist_on, shapes_on = run(True, "superstep")
    # the sweeps run the k-column form (8 vectors); λmax's power
    # iteration on the twin stays one vector, as in the reference
    check(on_launches["spmv_ell_block"] > 0, f"a setup with "
          f"setup_ell_sweeps launched {on_launches}: no k-column spmv_ell")
    eager, _, hist_eager, shapes_eager = run(True, "eager")
    check(hist_on == hist_eager, "setup_ell_sweeps: eager and super-step "
          "residual histories differ")
    del eager

    # the strength stage alone at each aggregation level, without and with
    # the setup twin (the super-step runs it on bucket-padded levels)
    strength_s = {False: 0.0, True: 0.0}
    for t in on.hierarchy.transfers:
        if not isinstance(t, AggregationLevel):
            continue
        level = dataclasses.replace(t.fine, ell=None, ell_rem=None)
        twin = attach_setup_twin(level, ell_layout_traced(
            level.adj.row, level.adj.col, level.n, 8))
        for sweeps, lv in ((False, level), (True, twin)):
            algebraic_distance_strength(lv)            # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            algebraic_distance_strength(lv)
            torch.cuda.synchronize()
            strength_s[sweeps] += time.perf_counter() - t0

    fine = on.hierarchy.transfers[0].fine
    b_int = on._to_internal(torch.as_tensor(rhs[0], device=on.device))
    k0 = spmv_ell.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_j, info_j = jacobi_pcg(fine, b_int, tol=1e-6, maxiter=4000)
    torch.cuda.synchronize()
    jac_ms = (time.perf_counter() - t0) * 1e3
    rel_j = host_residual(n, r, c, v, rhs[0],
                          on._from_internal(x_j).cpu().numpy())
    # the k-column spmv_ell at the sweeps' largest shape (the finest
    # aggregation level's width-8 twin, rows padded to the bucket), on the
    # setup's own last arguments there: 8 vectors
    shape = max(shapes_on)
    calls, args, _ = shapes_on[shape]
    twin_rec = block_record(torch, "spmv_ell_block", *args,
                            launches=on_launches["spmv_ell_block"],
                            label="spmv_ell_block@setup_twin")
    twin_rec["launches_at_shape"] = calls
    say("paper", graph="delaunay_2^20", eager_vs_superstep_bitwise=True,
        strength_s_warm=json.dumps({"coo": strength_s[False],
                                    "ell_twin": strength_s[True]}),
        jacobi_pcg_iters=info_j.iters, jacobi_pcg_status=info_j.status,
        jacobi_pcg_wda=round(wda(info_j.residual_norms, 1.0), 3),
        jacobi_pcg_ms=round(jac_ms, 1),
        jacobi_pcg_host_f64_rel_residual=f"{rel_j:.3e}",
        jacobi_pcg_spmv_ell=spmv_ell.launches - k0)
    check(spmv_ell.launches > k0, "Jacobi-PCG launched no spmv_ell")
    check(info_j.status != "converged" or rel_j <= 1e-4, "delaunay Jacobi-PCG "
          f"reports converged at host residual {rel_j:.3e}")
    return {"superstep": shapes_on, "eager": shapes_eager}, twin_rec


def finest_picks(solver, tally, labels, forms=("spmv_ell", "jacobi")) -> list:
    """``check_kernel_shapes`` picks for spmv_ell at the finest level of
    ``solver``'s hierarchy (every PCG matvec) and jacobi at its first
    aggregation level (the finest it smooths), from ``tally``; ``forms``
    names the forms to pick (the k-column ones for blocked solves)."""
    from repro_torch.core.coarsen import AggregationLevel

    ts = solver.hierarchy.transfers
    agg = next(t for t in ts if isinstance(t, AggregationLevel)).fine
    picks = []
    for name, level in zip(forms, (ts[0].fine, agg)):
        shape = tuple(level.ell.col.shape)
        check(shape in tally[name], f"{labels}: {name} was not launched at "
              f"the finest shape {shape}")
        picks.append((name, shape, tally[name][shape], labels))
    return picks


def hopeless_graph():
    """``tests/test_service_checkpoint.py``'s hopeless problem: a grid
    12×12 with a pair-symmetric 1e16 weight scaling, beyond float32."""
    import numpy as np

    from repro_torch.graphs.generators import ensure_connected, grid_2d

    n, r, c, v = ensure_connected(*grid_2d(12, 12))
    v = np.where(np.minimum(r, c) % 2 == 0, np.asarray(v) * 1e16,
                 np.asarray(v, np.float64))
    return n, r, c, v


KILL_CHILD = """
import json, sys
import numpy as np
sys.path.insert(0, {src!r})
from repro_torch.api import Problem, SolverOptions
from repro_torch.service import SolverService
from repro_torch.testing import Fault, FaultPlan, inject

d = np.load({npz!r})
reqs = json.loads({reqs!r})
problems = [Problem.from_edges(int(d[f"n{{g}}"]), d[f"r{{g}}"], d[f"c{{g}}"],
                               d[f"v{{g}}"]) for g in range(2)]
svc = SolverService(SolverOptions(matvec_backend="ell", tol=1e-6,
                                  verify="cheap", checkpoint_every=1,
                                  device={device!r}),
                    max_batch=8, checkpoint_dir={ckpt!r})
for j, (g, kw) in enumerate(reqs):
    svc.submit(problems[g], d[f"b{{j}}"], **kw)
if any(m.split(".")[0] in ("jax", "repro") for m in sys.modules):
    sys.exit(3)
with inject(FaultPlan({{"service.solve": Fault(mode="kill",
                                              at_calls=(1,))}})):
    svc.flush()
sys.exit("the kill fault did not fire")
"""


def phase_service(torch, np, main_graph, smi) -> dict:
    """A stream of solves through ``repro_torch.service.SolverService`` at
    a serving deployment's size: eight BA 2^17 graphs (one bucket, one
    batched setup) and the main BA 2^20 graph (looped), 113 right-hand
    sides in 26 requests and one flush; then the contracts (direct solves,
    batched = looped, the re-submitted stream, strict admission, kill and
    resume) and the kernels at the flush's finest shapes. Returns each
    kernel's launches over the phase before that check."""
    import shutil

    from benchmarks.port_service import ba_graphs, stream
    from repro_torch.api import HierarchyCache, Problem, SolverOptions
    from repro_torch.api import setup as api_setup
    from repro_torch.core import setup_step
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.device import resolve_device
    from repro_torch.service import SolverService
    from repro_torch.testing import KILL_EXIT_CODE, Fault, FaultPlan, inject

    t_phase = time.perf_counter()
    graphs = ba_graphs(SERVICE_N, range(1, SERVICE_GRAPHS + 1))
    gen_s = time.perf_counter() - t_phase
    graphs.append(main_graph)
    t0 = time.perf_counter()
    problems = [Problem.from_edges(*g) for g in graphs]
    for p in problems:
        p.fingerprint()
    prob_s = time.perf_counter() - t0
    sigs = [p.bucket_signature() for p in problems]
    say("service", graphs=f"{SERVICE_GRAPHS} x barabasi_albert(n="
        f"{SERVICE_N},m=4,seeds 1-{SERVICE_GRAPHS}) + main "
        f"n={main_graph[0]}",
        stored_nnz=json.dumps([len(g[1]) for g in graphs]),
        buckets=json.dumps(sorted(set(sigs))), generate_s=round(gen_s, 1),
        problems_s=round(prob_s, 1), card=smi)
    check(len(set(sigs[:-1])) == 1 and sigs[-1] != sigs[0],
          f"the service graphs' bucket signatures {sigs}")
    main_i = len(problems) - 1
    rng = np.random.default_rng(1)
    requests = stream(problems[:-1])
    for k in (1, 8):
        B = rng.normal(size=(problems[main_i].n, k)).astype(np.float32)
        B -= B.mean(axis=0)
        requests.append((main_i, B[:, 0] if k == 1 else B, {}))
    opts = SolverOptions(matvec_backend="ell", tol=1e-6, verify="cheap")

    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    svc = SolverService(opts, max_batch=8)
    passes, batched_votes, peaks = {}, {}, [0]

    def instrument(service, name, after=None, key=None):
        real = getattr(service, name)

        def run(*args, **kw):
            torch.cuda.synchronize()
            if name == "_setup_batched":    # the batched setup pass's peak
                peaks[0] = max(peaks[0], torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                setup_step.reset_counters()
            k0, t0 = phase_launches(), time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            passes[key or name] = dict(
                seconds=time.perf_counter() - t0, launches={
                    k: v - k0[k] for k, v in phase_launches().items()})
            if name == "_setup_batched":
                passes[name].update(
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    steps=setup_step.counters()["steps"])
            if after:
                after()
            return out

        setattr(service, name, run)

    with shapes_launched(SOLVER_KERNELS) as tally:
        instrument(svc, "_setup_pass")
        instrument(svc, "_solve_pass")
        instrument(svc, "_setup_batched", after=lambda: batched_votes.update(
            tally["agg_vote_batched"]))
        t0 = time.perf_counter()
        tickets = [svc.submit(problems[i], B, **kw) for i, B, kw in requests]
        svc.flush()
        flush_s = time.perf_counter() - t0
    st = svc.stats()
    peak_gib = max(peaks[0], torch.cuda.max_memory_allocated()) / 2**30
    batched_pass = passes["_setup_batched"]
    # agg steps a member ran alone (its levels left the group's buckets):
    # the only one-graph votes the batched pass may launch
    alone = batched_pass["steps"].get("agg", {}).get("calls", 0)
    counts = {k: st[k] for k in ("setup_batches", "setups_batched",
                                 "setups_looped", "solve_blocks",
                                 "rhs_columns")}
    # float64 host residuals, one pass over each graph's columns
    worst, bad = 0.0, []
    for i, (n, r, c, v) in enumerate(graphs):
        mine = [(t, B) for t, (j, B, _) in zip(tickets, requests) if j == i]
        Bs = np.concatenate([B.reshape(n, -1) for _, B in mine], axis=1)
        Xs = np.concatenate([t.result()[0].reshape(n, -1) for t, _ in mine],
                            axis=1)
        rels = host_residual(n, r, c, v, Bs, Xs)
        worst = max(worst, float(rels.max()))
        for t, _ in mine:
            res = t.result()[1]
            if not (res.status == "converged" and res.certificate.passed):
                bad.append((t.seq, res.status))
        if (rels > 1e-4).any():
            bad.append((i, "host residual", float(rels.max())))
    lat = st["latency_seconds"]
    say("service", step="flush", flush_s=round(flush_s, 3),
        counters=json.dumps(counts), setup_s=round(st["setup_seconds"], 3),
        batched_setup_s=passes.get("_setup_batched", {}).get("seconds"),
        solve_s=round(st["solve_seconds"], 3),
        solve_s_per_rhs_column=st["solve_seconds"] / st["rhs_columns"],
        latency_p50_p90_p99_s=json.dumps([lat["p50"], lat["p90"],
                                          lat["p99"]]),
        peak_gib=round(peak_gib, 3),
        max_host_f64_rel_residual=f"{worst:.3e}",
        setup_pass_launches=json.dumps(passes["_setup_pass"]["launches"]),
        batched_setup_pass_launches=json.dumps(batched_pass["launches"]),
        batched_setup_pass_registry=json.dumps(batched_pass["steps"]),
        batched_setup_pass_peak_gib=round(batched_pass["peak_gib"], 3),
        solve_pass_launches=json.dumps(passes["_solve_pass"]["launches"]),
        card=smi)
    check(counts == dict(setup_batches=1, setups_batched=SERVICE_GRAPHS,
                         setups_looped=1, solve_blocks=SERVICE_GRAPHS + 1,
                         rhs_columns=13 * SERVICE_GRAPHS + 9),
          f"service counters {counts}")
    check(not bad, f"tickets not converged, certified and within 1e-4: {bad}")
    check(passes["_setup_pass"]["launches"]["agg_vote"] > 0,
          "the setup pass launched no agg_vote")
    check(batched_pass["launches"]["agg_vote_batched"] > 0,
          "the batched setup pass launched no graph-batched agg_vote")
    check(batched_pass["launches"]["agg_vote"]
          == alone * SetupConfig().aggregation.n_rounds,
          f"the batched setup pass launched the one-graph agg_vote "
          f"{batched_pass['launches']['agg_vote']} times for {alone} agg "
          f"steps of a member alone")
    check(all(passes["_solve_pass"]["launches"][k] > 0
              for k in ("spmv_ell", "jacobi")),
          "the solve pass launched no spmv_ell or jacobi")

    # the tickets of the 2^20 graph and two of the eight against direct
    # facade solves of the same columns on the same hierarchies
    direct = [bits_equal(np, t.result()[0], api_setup(
        problems[i], opts, cache=svc.cache).solve(B, **kw)[0])
              for t, (i, B, kw) in zip(tickets, requests)
              if i in (0, 1, main_i)]
    # batched = looped: the same two graphs through a max_batch=1 service
    looped_svc = SolverService(opts, max_batch=1)
    instrument(looped_svc, "_setup_pass", key="looped_setup_pass")
    pair = [(t, i, B, kw) for t, (i, B, kw) in zip(tickets, requests)
            if i in (0, 1)]
    looped = [looped_svc.submit(problems[i], B, **kw) for _, i, B, kw in pair]
    looped_svc.flush()
    lst = looped_svc.stats()
    same_looped = [bits_equal(np, t.result()[0], u.result()[0])
                   for (t, *_), u in zip(pair, looped)]
    del looped_svc, looped
    # the re-submitted stream: cache hits only, no setup, the same bits
    before = svc.stats()
    again = [svc.submit(problems[i], B, **kw) for i, B, kw in requests]
    svc.flush()
    after = svc.stats()
    hits = after["cache"]["hits"] - before["cache"]["hits"]
    same_again = all(bits_equal(np, t.result()[0], u.result()[0])
                     for t, u in zip(tickets, again))
    batched_rate = SERVICE_GRAPHS / passes["_setup_batched"]["seconds"]
    looped_rate = lst["setups_looped"] / lst["setup_seconds"]
    say("service", step="contracts", direct_bitwise=all(direct),
        direct_tickets=len(direct), looped_bitwise=all(same_looped),
        setups_per_s_batched=batched_rate, setups_per_s_looped=looped_rate,
        batched_over_looped=batched_rate / looped_rate,
        batched_setup_pass_launches=json.dumps(batched_pass["launches"]),
        looped_setup_pass_launches=json.dumps(
            passes["looped_setup_pass"]["launches"]),
        batched_setup_pass_total=sum(batched_pass["launches"].values()),
        looped_setup_pass_total=sum(
            passes["looped_setup_pass"]["launches"].values()),
        looped_setups=lst["setups_looped"],
        resubmit_hits=hits,
        resubmit_misses=after["cache"]["misses"] - before["cache"]["misses"],
        resubmit_setup_s=after["setup_seconds"] - before["setup_seconds"],
        resubmit_bitwise=same_again, card=smi)
    check(all(direct), "service results differ from direct facade solves")
    check(lst["setups_looped"] == 2 and all(same_looped),
          "batched setups differ from looped ones")
    check(hits == main_i + 1 and after["cache"]["misses"]
          == before["cache"]["misses"]
          and after["setup_seconds"] == before["setup_seconds"]
          and same_again, "the re-submitted stream set up again or differs")

    # strict admission: the hopeless problem is turned away; a raising
    # serve requeues its ticket and the rest of the flush completes
    strict = SolverService(opts, max_batch=8, cache=svc.cache,
                           admission="strict")
    b_h = rng.normal(size=144).astype(np.float32)
    rejected = strict.submit(Problem.from_edges(*hopeless_graph()),
                             b_h - b_h.mean())
    picked = [j for j, (i, _, _) in enumerate(requests) if i in (0, 1)][::3]
    plan = FaultPlan({"service.solve": Fault(mode="raise",
                                             at_calls=(0, 1))})
    with inject(plan):
        sts = [strict.submit(problems[requests[j][0]], requests[j][1],
                             **requests[j][2]) for j in picked]
        strict.flush()
    first = [t.status for t in sts]
    strict.flush()
    strict.flush()
    requeued = [t for t, s0 in zip(sts, first) if s0 == "requeued"]
    sst = strict.stats()
    say("service", step="strict", rejected=rejected.status,
        statuses_after_fault=json.dumps(first),
        statuses_after_backoff=json.dumps([t.status for t in sts]),
        requeued=sst["requeued"], rejected_count=sst["rejected"],
        fired=json.dumps(plan.fired))
    check(rejected.status == "rejected", "strict admission admitted the "
          "hopeless problem")
    check(sorted(first) == ["done", "requeued"] and sst["requeued"] == 1,
          f"strict admission after a raising serve: {first}")
    check(all(t.status == "done" for t in sts) and all(
        bits_equal(np, t.result()[0], tickets[j].result()[0])
        for t, j in zip(sts, picked)),
        "the requeued ticket was not served, or differs")

    # kill and resume: a child process on the card serves the two
    # graphs' stream with snapshots and is killed in its second group
    work = ROOT / "build" / "service_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckpt, npz = str(work / "ckpt"), str(work / "stream.npz")
    arrays, reqs = {}, []
    for g in (0, 1):
        n, r, c, v = graphs[g]
        arrays.update({f"n{g}": n, f"r{g}": r, f"c{g}": c, f"v{g}": v})
    for j, (_, i, B, kw) in enumerate(pair):
        arrays[f"b{j}"] = B
        reqs.append((i, kw))
    np.savez(npz, **arrays)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", KILL_CHILD.format(
            src=str(ROOT / "src"), npz=npz, reqs=json.dumps(reqs),
            ckpt=ckpt, device=str(resolve_device(None)))],
        capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    fresh = SolverService(opts, max_batch=8, cache=svc.cache,
                          checkpoint_dir=ckpt)
    resumed_t = [fresh.submit(problems[i], B, **kw) for _, i, B, kw in pair]
    resumed = fresh.resume()
    fresh.flush()
    same_resume = [bits_equal(np, t.result()[0], u.result()[0])
                   for (t, *_), u in zip(pair, resumed_t)]
    say("service", step="kill_resume", child_exit=child.returncode,
        child_s=round(child_s, 1), resumed=resumed,
        bitwise=json.dumps(same_resume), card=smi)
    check(child.returncode == KILL_EXIT_CODE,
          f"the killed child exited {child.returncode}: "
          f"{child.stderr[-3000:]}")
    check(resumed > 0 and all(same_resume),
          "the resumed flush differs from the uninterrupted one")
    shutil.rmtree(work, ignore_errors=True)

    launched = phase_launches()
    check(launched["embedding_bag"] == 0,
          "the service phase launched embedding_bag")
    picks = []
    for i in (0, main_i):
        handle = svc.cache.peek(HierarchyCache.key(problems[i], opts,
                                                   svc.backend))
        picks += finest_picks(handle._solver, tally,
                              dict(graph=f"ba_n{problems[i].n}"))
    check_kernel_shapes(torch, "service", picks)
    first_vote = max(batched_votes, key=lambda shape: (shape[1], shape[0]))
    record = vote_batched_record(torch, first_vote, batched_votes[first_vote],
                                 batched_pass["launches"]["agg_vote_batched"])
    say("service", seconds=round(time.perf_counter() - t_phase, 1),
        launches=json.dumps(launched), card=smi)
    return dict(launched, records=[record])


def vote_batched_record(torch, shape, entry, launches) -> dict:
    """The graph-batched vote on the batched setup's own last arguments at
    ``shape`` (graphs, rows a graph, width): bitwise its plain version,
    the one-graph kernel on each graph's tables and state, and itself on a
    repeat; its entry of the ``kernels`` JSON line (``launches``: the
    batched setup pass's), with the time of one one-graph launch a graph
    at the same shape beside it."""
    from repro_torch.kernels import ell_tile_plan
    from repro_torch.kernels.agg_vote import (vote_reduce,
                                              vote_reduce_batched,
                                              vote_reduce_batched_ref)

    calls, (col, sq, state), kw = entry
    n_graphs, n, w = shape
    got, want, again = (vote_reduce_batched(col, sq, state, **kw),
                        vote_reduce_batched_ref(col, sq, state, **kw),
                        vote_reduce_batched(col, sq, state, **kw))
    members = [(col[g].clone(), sq[g].clone(), state[g].clone())
               for g in range(n_graphs)]
    ones = [vote_reduce(*m, **kw) for m in members]
    torch.cuda.synchronize()
    where = f"service agg_vote_batched ({n_graphs} x {n} x {w})"
    check(all(torch.equal(g, r) for g, r in zip(got, want)),
          f"{where} is not bit-exact against its plain version")
    check(all(torch.equal(g, a) for g, a in zip(got, again)),
          f"{where} is not bitwise repeatable")
    check(all(torch.equal(o[j], got[j][g]) for g, o in enumerate(ones)
              for j in (0, 1)),
          f"{where} differs from the one-graph kernel on a graph's slice")
    say("service", kernel="agg_vote_batched", graphs=n_graphs, rows=n,
        width=w, calls_at_shape=calls, plain_bitwise=True,
        one_graph_bitwise=True, repeat_bitwise=True)
    real = int(((col >= 0) & (col < state.shape[1])).sum())
    bytes_moved = n_graphs * (8 * n * w + 4 * state.shape[1] + 8 * n)
    rec = kernel_record(
        torch, "agg_vote_batched", launches, 0.0,
        lambda: vote_reduce_batched(col, sq, state, **kw),
        lambda: vote_reduce_batched_ref(col, sq, state, **kw), bytes_moved,
        4 * real)
    one_device_ms, _ = device_ms(
        torch, lambda: vote_reduce(*members[0], **kw), "agg_vote")
    per_graph_ms = time_ms(
        torch, lambda: [vote_reduce(*m, **kw) for m in members])
    say("service", kernel="agg_vote_batched", graphs=n_graphs,
        device_ms=rec["device_ms"], bound_ms=rec["bound_ms"],
        of_bound=round(rec["bound_ms"] / rec["device_ms"], 4),
        one_graph_device_ms_times_graphs=n_graphs * one_device_ms,
        one_graph_launches_kernel_ms=per_graph_ms,
        batched_kernel_ms=rec["kernel_ms"])
    rec.update(graphs=n_graphs, rows=n, width=w,
               plan=list(ell_tile_plan(w)),
               vmapped_at=VMAPPED_AT["agg_vote_batched"],
               library="— (no single call)",
               one_graph_device_ms_times_graphs=n_graphs * one_device_ms,
               one_graph_launches_kernel_ms=per_graph_ms)
    return rec


@contextlib.contextmanager
def timed_solves(seconds: list):
    """Within the block, add the wall seconds of every facade
    ``Solver.solve`` (which returns host arrays) to ``seconds[0]``."""
    from repro_torch.api.facade import Solver

    real = Solver.solve

    def solve(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return real(self, *args, **kw)
        finally:
            seconds[0] += time.perf_counter() - t0

    Solver.solve = solve
    try:
        yield
    finally:
        Solver.solve = real


def launches_since(before: dict) -> dict:
    """The solver kernels' launches by form since ``before`` (a
    ``phase_launches()``)."""
    now = phase_launches()
    return {k: now[k] - before[k] for k in ("spmv_ell", "jacobi",
                                             *BLOCK_FORMS, "agg_vote")}


def phase_spectral(torch, np, smi) -> dict:
    """The spectral layer (``repro_torch.spectral``) on a Delaunay mesh of
    2^15 uniform points: LOBPCG k = 8 at tol 1e-8 against scipy's
    shift-invert ``eigsh``, Fiedler bisection with and without the sweep,
    spectral clustering and recursive bisection into 4, two positional
    encodings from one cache, the resistance sketch with 64 probes, each
    step with its launches by form (every solve is a blocked one on the
    throughput path: k-column kernels only); then the kernels at the
    mesh's finest shapes, and the k-column records there at k = 8 and 64.
    Returns each kernel's launches over the phase before that check, and
    the records."""
    from scipy.sparse.linalg import eigsh

    from repro_torch.api import HierarchyCache, Problem
    from repro_torch.graphs.generators import delaunay, ensure_connected
    from repro_torch.spectral import (effective_resistance, fiedler_bisect,
                                      laplacian_pe, lobpcg,
                                      recursive_bisection,
                                      spectral_clustering)
    from repro_torch.spectral.lobpcg import _default_options, _laplacian_csr
    from repro_torch.spectral.resistance import _incidence_rhs

    # the entry points' default options (exact_columns=False), with the
    # ELL backend as on every other path of this script: the reference's
    # default "coo" would run no spmv_ell or jacobi
    opts = dataclasses.replace(_default_options(SPECTRAL_N, None),
                               matvec_backend="ell")

    t_phase = time.perf_counter()
    n, r, c, v = ensure_connected(*delaunay(SPECTRAL_N, seed=0))
    p = Problem.from_edges(n, r, c, v)
    say("spectral", graph=f"delaunay(n={n},seed=0)", stored_nnz=len(r),
        generate_s=round(time.perf_counter() - t_phase, 1), card=smi)
    cache = HierarchyCache()
    zero_launches()
    with shapes_launched(SOLVER_KERNELS) as tally:
        # LOBPCG through the default (exact_columns=False) options
        k0 = phase_launches()
        precond = [0.0]
        t0 = time.perf_counter()
        with timed_solves(precond):
            eig = lobpcg(p, 8, tol=1e-8, options=opts, cache=cache)
        total = time.perf_counter() - t0
        t0 = time.perf_counter()
        lap = _laplacian_csr(p).tocsc()
        ref = np.sort(eigsh(lap, k=9, sigma=-1e-2, which="LM",
                            return_eigenvectors=False))[1:]
        eigsh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        unp = lobpcg(p, 8, tol=1e-8, precondition=False,
                     max_iters=eig.iters)
        unp_s = time.perf_counter() - t0
        rel = np.abs(eig.eigenvalues / ref - 1.0)
        say("spectral", step="lobpcg", k=8, tol=1e-8, iters=eig.iters,
            launches=json.dumps(launches_since(k0)),
            converged=int(eig.converged.sum()),
            precond_solves=eig.precond_solves,
            precond_columns=eig.precond_columns,
            precond_status=eig.precond_status,
            setup_s=round(eig.setup_seconds, 3),
            precond_s=round(precond[0], 3),
            host_algebra_s=round(total - eig.setup_seconds - precond[0], 3),
            eigenvalues=json.dumps(eig.eigenvalues.tolist()),
            eigsh_max_rel_diff=f"{rel.max():.3e}",
            eigsh_s=round(eigsh_s, 1),
            final_residual_max=f"{eig.residual_norms[-1].max():.3e}",
            unpreconditioned_residual_max=(
                f"{unp.residual_norms[-1].max():.3e}"),
            unpreconditioned_converged=int(unp.converged.sum()),
            unpreconditioned_s=round(unp_s, 1), card=smi)
        check(eig.converged.all(), f"lobpcg: {int(eig.converged.sum())} of 8 "
              "pairs converged")
        check(rel.max() <= 1e-6, f"lobpcg eigenvalues vs eigsh: {rel}")

        # Fiedler bisection, clustering and partitioning
        k0, t0 = phase_launches(), time.perf_counter()
        mask_s, sweep = fiedler_bisect(p, options=opts, cache=cache)
        mask_n, sign = fiedler_bisect(p, sweep=False, options=opts,
                                      cache=cache)
        clus = spectral_clustering(p, 4, options=opts, cache=cache)
        parts = recursive_bisection(p, 4, options=opts, cache=cache)
        say("spectral", step="cuts", fiedler_value=sweep["fiedler_value"],
            sweep_conductance=sweep["conductance"],
            sign_conductance=sign["conductance"],
            sweep_side=int(mask_s.sum()), sign_side=int(mask_n.sum()),
            clustering_ncut=clus.ncut,
            clustering_conductances=json.dumps(clus.conductances.tolist()),
            clustering_sizes=json.dumps(np.bincount(clus.labels).tolist()),
            bisection_ncut=parts.ncut,
            bisection_conductances=json.dumps(parts.conductances.tolist()),
            bisection_sizes=json.dumps(np.bincount(parts.labels).tolist()),
            launches=json.dumps(launches_since(k0)),
            seconds=round(time.perf_counter() - t0, 1), card=smi)
        check(sweep["conductance"] <= sign["conductance"] + 1e-12,
              "the sweep cut's conductance is above the sign cut's")
        check(clus.n_clusters == 4 and parts.n_clusters == 4
              and np.isfinite(clus.conductances).all(),
              "clustering or partitioning did not give 4 parts")

        # two positional encodings from one cache: no setup the second time
        k0, pe = phase_launches(), []
        for _ in range(2):
            misses, votes = cache.stats()["misses"], phase_launches()
            t0 = time.perf_counter()
            pe.append(laplacian_pe(p, k=8, options=opts, cache=cache,
                                   seed=0))
            pe_s = time.perf_counter() - t0
        new_misses = cache.stats()["misses"] - misses
        new_votes = phase_launches()["agg_vote"] - votes["agg_vote"]
        say("spectral", step="pe", k=8, bitwise=bool(np.array_equal(*pe)),
            launches=json.dumps(launches_since(k0)),
            second_call_misses=new_misses, second_call_agg_vote=new_votes,
            second_call_s=round(pe_s, 1), card=smi)
        check(np.array_equal(*pe) and new_misses == 0 and new_votes == 0,
              "the second laplacian_pe set up again or differs")

        # the resistance sketch: 64 probes in one blocked solve
        k0, t0 = phase_launches(), time.perf_counter()
        sk = effective_resistance(p, n_probes=64, options=opts, cache=cache)
        res_s = time.perf_counter() - t0
        B = _incidence_rhs(p, 64, 0).astype(np.float32)
        rels = host_residual(n, r, c, v, B, sk.Z)
        say("spectral", step="resistance", n_probes=sk.n_probes,
            solve_iters=sk.solve_iters, seconds=round(res_s, 1),
            launches=json.dumps(launches_since(k0)),
            max_host_f64_rel_residual=f"{rels.max():.3e}", card=smi)
        check((rels <= 1e-4).all(), f"resistance columns above 1e-4: "
              f"{np.flatnonzero(rels > 1e-4).tolist()}")
    # every solve of the phase is blocked (the throughput path): the
    # k-column kernels run, the one-vector ones never
    launched = phase_launches()
    check(all(launched[k] > 0 for k in (*BLOCK_FORMS, "agg_vote"))
          and launched["spmv_ell"] == launched["jacobi"] == 0
          and launched["embedding_bag"] == 0,
          f"spectral phase launches {launched}")
    handle = cache.peek(HierarchyCache.key(p, opts, "single"))
    solver = handle._solver
    picks = finest_picks(solver, tally, dict(graph="delaunay"),
                         forms=tuple(BLOCK_FORMS))
    first_vote = max(tally["agg_vote"])
    picks.append(("agg_vote", first_vote, tally["agg_vote"][first_vote],
                  dict(graph="delaunay setup")))
    check_kernel_shapes(torch, "spectral", picks)
    # the k-column records at the mesh's finest shapes: LOBPCG's blocks of
    # 8 and the sketch's 64 probes
    records = []
    gen = torch.Generator(device=solver.device).manual_seed(9)
    (_, fshape, (fcalls, _, _), _), (_, jshape, (jcalls, jargs, _), _) = \
        picks[:2]
    top = solver.hierarchy.transfers[0].fine.ell
    for k in (8, 64):
        X = torch.randn(top.n_cols, k, generator=gen, device=solver.device)
        records.append(block_record(
            torch, "spmv_ell_block", top.col, top.val, X,
            launches=launched["spmv_ell_block"],
            label=f"spmv_ell_block@spectral_k{k}"))
        col, val, deg = jargs[0], jargs[1], jargs[4]
        X, B = (torch.randn(col.shape[0], k, generator=gen,
                            device=solver.device) for _ in range(2))
        records.append(block_record(
            torch, "jacobi_block", col, val, X, B, deg,
            launches=launched["jacobi_block"],
            label=f"jacobi_block@spectral_k{k}"))
    for rec in records:
        rec["launches_at_shape"] = fcalls if rec["kernel"] == \
            "spmv_ell_block" else jcalls
    say("spectral", seconds=round(time.perf_counter() - t_phase, 1),
        launches=json.dumps(launched), card=smi)
    return dict(launched, records=records)


def phase_e2e(torch, np):
    from repro_torch.core import setup_step
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.core.solver import LaplacianSolver

    n, r, c, v = graph(E2E_N, seed=1)
    b = np.random.default_rng(7).normal(size=n).astype(np.float32)
    b -= b.mean()
    out = {}
    for mode, ctx in (("kernel", contextlib.nullcontext),
                      ("plain", plain_versions)):
        setup_step.clear_cache()
        before = launch_counts()
        with ctx():
            s = LaplacianSolver.setup(n, r, c, v,
                                      SetupConfig(matvec_backend="ell"))
            x, info = s.solve(b, tol=1e-6, maxiter=200)
        grew = [a > b for a, b in zip(launch_counts(), before)]
        check(all(grew) if mode == "kernel" else not any(grew),
              f"e2e {mode} run launched the wrong kernels: {grew}")
        check(info.converged, f"e2e {mode} solve did not converge")
        out[mode] = (s.stats()["levels"], info.iters, x)
    (lk, ik, xk), (lp, ip, xp) = out["kernel"], out["plain"]
    rel = float(torch.linalg.norm(xk - xp) / torch.linalg.norm(xp))
    say("e2e", n=n, levels=len(lk), same_levels=lk == lp, iters_kernel=ik,
        iters_plain=ip, rel_diff=f"{rel:.3e}")
    check(lk == lp, "kernel and plain runs built different levels")
    check(abs(ik - ip) <= 1, "iteration counts differ by more than 1")
    check(rel <= 1e-4, f"kernel vs plain solutions differ: {rel:.3e}")
    phase_e2e_superstep(torch, [(n, r, c, v), graph(E2E_N, seed=2)])


def phase_e2e_superstep(torch, graphs) -> None:
    """The super-step contracts on two graphs of one generator: steps that
    never sync (with and without ``setup_ell_sweeps``), the registry reused,
    batched builds equal to single ones."""
    from repro_torch.core import setup_step as ss
    from repro_torch.core.graph import pow2_bucket
    from repro_torch.core.hierarchy import SetupConfig, build_hierarchy_eager
    from repro_torch.graphs.generators import to_laplacian_coo

    cfg = SetupConfig(matvec_backend="ell", setup_bucket_floor=E2E_FLOOR)
    # one input capacity for both graphs: the ingest step's key holds it
    adjs = [to_laplacian_coo(n, r, c, v, capacity=pow2_bucket(len(r)))
            for n, r, c, v in graphs]
    ss.clear_cache()
    ss.reset_counters()
    votes = launch_counts(SOLVER_KERNELS[2:])[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = ss.build_hierarchy_superstep(adjs[0], cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    votes = launch_counts(SOLVER_KERNELS[2:])[0] - votes
    ledger = ss.counters()
    # the same under setup_ell_sweeps: spmv_ell and the spill path inside
    # the agg step (a registry entry of its own, built under the mode too)
    # (the sweeps' k-column form: 8 vectors a launch)
    spmvs = block_launches()["spmv_ell_block"]
    sweeps = dataclasses.replace(cfg, setup_ell_sweeps=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sweeps_single = [ss.build_hierarchy_superstep(adjs[0], sweeps)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    spmvs = block_launches()["spmv_ell_block"] - spmvs
    sweeps_single.append(ss.build_hierarchy_superstep(adjs[1], sweeps))

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            build_hierarchy_eager(adjs[0], cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager_syncs = sum("synchroniz" in str(w.message) for w in caught)

    ss.reset_counters()
    t0 = time.perf_counter()
    second = ss.build_hierarchy_superstep(adjs[1], cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    new_entries = sum(st["compiles"]
                      for st in ss.counters()["steps"].values())
    # the batched setups (stacked steps, one graph-batched vote launch a
    # round) under the same sync debug mode as the single ones
    ss.reset_counters()
    k0 = phase_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = ss.build_hierarchy_superstep_batch(adjs, cfg)
        batch_ledger = ss.counters()
        batch_sweeps = ss.build_hierarchy_superstep_batch(adjs, sweeps)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    batch_votes = {k: phase_launches()[k] - k0[k]
                   for k in ("agg_vote", "agg_vote_batched")}
    # agg steps a graph ran alone (its decisions left the group's round):
    # the only one-graph votes the batched builds may launch
    alone = ss.counters()["steps"].get("agg", {}).get("calls", 0)
    same = [bitwise_equal(torch, h, hb)
            for h, hb in zip((first, second), batch)]
    same_sweeps = [bitwise_equal(torch, h, hb)
                   for h, hb in zip(sweeps_single, batch_sweeps)]
    say("e2e", superstep_floor=E2E_FLOOR, sync_debug="error",
        no_sync_in_steps=True, cold_setup_s=round(cold_s, 3),
        host_syncs=ledger["host_syncs"], eager_host_syncs=eager_syncs,
        agg_vote_launches=votes, registry=registry_line(ledger),
        ell_sweeps_no_sync=True, ell_sweeps_spmv_ell_block_launches=spmvs,
        second_graph_new_entries=new_entries, second_setup_s=round(warm_s, 3),
        batch_sync_debug="error", batch_bitwise=json.dumps(same),
        batch_registry=registry_line(batch_ledger),
        batch_host_syncs=batch_ledger["host_syncs"],
        batch_sweeps_bitwise=json.dumps(same_sweeps),
        batch_vote_launches=json.dumps(batch_votes), batch_agg_alone=alone)
    check(votes > 0, "the super-step setup launched no agg_vote kernel")
    check(spmvs > 0, "the super-step setup with setup_ell_sweeps launched "
          "no spmv_ell kernel")
    check(new_entries == 0,
          f"a second same-bucket graph added {new_entries} registry entries")
    check(all(same), "batched setups differ from single ones")
    check(all(same_sweeps), "batched setups with setup_ell_sweeps differ "
          "from single ones")
    check(batch_votes["agg_vote_batched"] > 0 and batch_votes["agg_vote"]
          == alone * cfg.aggregation.n_rounds,
          f"the batched setups' votes {batch_votes} with {alone} agg steps "
          f"of a graph alone: a group's rounds must run the graph-batched "
          f"kernel")


def dist_decisions(solver) -> dict:
    """A distributed solver's integer decisions: level kinds and sizes and
    a digest of each level's elimination mask or coarse ids."""
    import hashlib

    from repro_torch.core.elimination import EliminationLevel

    out = dict(kinds=[], sizes=[], ids=[])
    for t in solver.arrays.transfers + solver.coarse_h.transfers:
        elim = isinstance(t, EliminationLevel)
        ids = (t.elim_mask if elim else t.coarse_id).cpu().numpy()
        out["kinds"].append("elim" if elim else "agg")
        out["sizes"].append((t.fine.n, t.coarse.n, t.coarse.adj.nnz))
        out["ids"].append(hashlib.sha256(ids.tobytes()).hexdigest()[:16])
    return out


def dist_child(rank, world_size, graph, device):
    """One rank of phase dist (b): the 2×2 mesh over a gloo group of four
    processes on one card (reductions staged through host memory). Sets
    up and solves the graph, checks the kernels at its block shapes, and
    returns what the parent compares with a world of one."""
    import numpy as np
    import torch

    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.dist import DistLaplacianSolver, make_mesh

    n, r, c, v = graph
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    zero_launches()
    t0 = time.perf_counter()
    with shapes_launched(SOLVER_KERNELS[2:]) as votes:
        solver = DistLaplacianSolver.setup(n, r, c, v, mesh,
                                           SetupConfig(matvec_backend="ell"))
    setup_s = time.perf_counter() - t0
    b = np.random.default_rng(7).normal(size=n).astype(np.float32)
    b -= b.mean()
    t0 = time.perf_counter()
    with shapes_launched(SOLVER_KERNELS[:1]) as spmvs:
        X, norms, iters, codes = solver.solve_block(b[:, None], n_iters=200,
                                                    tol=1e-6, guard=True)
    solve_s = time.perf_counter() - t0
    launched = phase_launches()
    # the kernels at this rank's shapes: spmv_ell on each distributed
    # level's block, agg_vote on each row block the setup voted on
    gen = torch.Generator(device=solver.device).manual_seed(3)
    shapes = [tuple(t.fine.ell_col.shape) for t in solver.arrays.transfers]
    picks = [("spmv_ell_block", shape,
              (spmvs["spmv_ell_block"].get(shape, [0])[0],
               (t.fine.ell_col, t.fine.ell_val,
                torch.randn(t.fine.n_pad, 1, generator=gen,
                            device=solver.device)), {}),
              dict(rank=rank, block=json.dumps(mesh.block)))
             for shape, t in zip(shapes, solver.arrays.transfers)]
    picks += [("agg_vote", shape, entry,
               dict(rank=rank, block=json.dumps(mesh.block)))
              for shape, entry in sorted(votes["agg_vote"].items())]
    # its lines go back to the parent, which prints them in rank order
    with contextlib.redirect_stdout(io.StringIO()) as lines:
        check_kernel_shapes(torch, "dist", picks)
    return dict(setup_s=setup_s, solve_s=solve_s,
                decisions=dist_decisions(solver), iters=int(iters[0]),
                code=int(codes[0]), x=X[:, 0].cpu().numpy(), b=b,
                launches=launched, stats=mesh.stats(),
                kernels=[(name, shape) for name, shape, _, _ in picks],
                lines=lines.getvalue())


def measure_shape(torch, phase, name, shape, args, kw, calls, unit,
                  **labels) -> None:
    """One kernel at one shape of a phase's own last arguments there:
    ``check_kernel_shapes``'s checks, then both times, the bound and the
    launches per ``unit`` at that shape."""
    check_kernel_shapes(torch, phase, [(name, shape, (calls, args, kw),
                                        labels)])
    mod = f"repro_torch.kernels.{module_of(name)}"
    run = getattr(importlib.import_module(mod), WRAPPERS[mod][0])
    n, w = args[0].shape
    b_ms, b_by = bound(*kernel_work(name, args))
    k_ms = time_ms(torch, lambda: run(*args, **kw))
    d_ms, windows = device_ms(torch, lambda: run(*args, **kw), name)
    say(phase, kernel=name, **labels, rows=n, width=w, kernel_ms=k_ms,
        device_ms=d_ms, bound_ms=b_ms, bound_by=b_by,
        of_bound=round(b_ms / d_ms, 4), **{f"launches_per_{unit}": calls},
        profiler_windows=windows)


def mean_free_block(np, n: int, seeds) -> "np.ndarray":
    """The main phase's right-hand sides: one seeded mean-free column a
    seed, as ``phase_main`` makes them."""
    cols = []
    for seed in seeds:
        b = np.random.default_rng(seed).normal(size=n).astype(np.float32)
        b -= b.mean()
        cols.append(b)
    return np.stack(cols, axis=1)


def phase_dist(torch, np, main_graph, main_iters) -> dict:
    """The 2D-distributed solver (``repro_torch.dist``). (a) A world of one
    over NCCL on the main graph: the distributed super-step setup (timed,
    with each distributed level's host partition), its hierarchy bitwise
    the serial super-step's under sync debug ``"error"`` with at most one
    host fetch per constructed level plus 3, four solves through
    ``solve_block`` and through the facade's ``dist`` backend (host
    residual, iterations against the main phase's ``single`` solves,
    guards on/off and a repeat bitwise), all-reduce calls and bytes per
    solve; then every kernel at the distributed path's shapes. (b) A 2×2
    world of four gloo processes on the card on BA 2^18
    (``phase_dist_grid``). Returns each kernel's launches in (a)."""
    from repro_torch.dist import init_world

    t_phase = time.perf_counter()
    mesh = init_world("cuda")
    try:
        launched = phase_dist_one(torch, np, mesh, main_graph, main_iters)
        phase_dist_grid(torch, np, mesh)
    finally:
        torch.distributed.destroy_process_group()
    say("dist", seconds=round(time.perf_counter() - t_phase, 1))
    return launched


def phase_dist_one(torch, np, mesh, main_graph, main_iters) -> dict:
    """Phase dist (a) on the world of one ``mesh``; returns each kernel's
    launches there."""
    from repro_torch.api import Problem, SolverOptions
    from repro_torch.api import setup as api_setup
    from repro_torch.core import setup_step as ss
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.dist import (DistLaplacianSolver,
                                  build_hierarchy_superstep_dist)
    from repro_torch.graphs.generators import random_relabel, to_laplacian_coo

    # the communicator starts with the first collective: here, before any
    # check under sync debug mode
    mesh.psum(torch.zeros(1, device=mesh.device))
    torch.cuda.synchronize()
    n, r, c, v = main_graph
    zero_launches()
    ss.clear_cache()
    ss.reset_counters()
    prof = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with shapes_launched(SOLVER_KERNELS[2:]) as per_setup:
        solver = DistLaplacianSolver.setup(n, r, c, v, mesh,
                                           SetupConfig(matvec_backend="ell"),
                                           profile=prof)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_votes = launch_counts(SOLVER_KERNELS[2:])[0]
    say("dist", world=f"{mesh.backend} {mesh.shape}", n=n,
        setup_s=round(setup_s, 3), superstep_s=round(prof[0][1], 3),
        partition_s=json.dumps([round(p[2], 3) for p in prof[1:]]),
        setup_agg_vote=setup_votes, setup_allreduce=json.dumps(mesh.stats()))
    for i, m in enumerate(solver.level_meta):
        say("dist", level=i, **dataclasses.asdict(m))
    check(len(solver.level_meta) >= 1, "no level was distributed")
    check(per_setup["agg_vote"], "the distributed setup launched no agg_vote")

    # the hierarchy: the serial super-step's bit for bit, steps that never
    # sync, one host fetch per constructed level
    rr, cc, _, _ = random_relabel(n, r, c, 0)
    adj = to_laplacian_coo(n, rr, cc, v, device=mesh.device)
    ss.clear_cache()
    ss.reset_counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h_dist = build_hierarchy_superstep_dist(adj, SetupConfig(), mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fetches = ss.counters()["host_syncs"]
    constructed = len(h_dist.transfers)
    # the dist path's launches so far; the serial build it is held against
    # launches agg_vote too, and those are not counted
    launched = phase_launches()
    h_serial = ss.build_hierarchy_superstep(adj, SetupConfig())
    zero_launches()
    same = bitwise_equal(torch, h_dist, h_serial)
    say("dist", hierarchy_bitwise_serial=same, sync_debug="error",
        host_fetches=fetches, constructed_levels=constructed)
    check(same, "the distributed hierarchy is not the serial super-step's")
    check(fetches <= constructed + 3, f"the distributed setup fetched "
          f"{fetches} times for {constructed} levels")
    del h_dist, h_serial, adj

    B = mean_free_block(np, n, range(100, 100 + DIST_RHS))
    out = {}
    for run in ("guarded", "unguarded", "repeat"):
        mesh.reset_stats()
        with shapes_launched(SOLVER_KERNELS[:2]) as per_solve:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solver.solve_block(B, n_iters=200, tol=1e-6,
                                     guard=run != "unguarded")
            torch.cuda.synchronize()
        out[run] = (res, (time.perf_counter() - t0) * 1e3, mesh.stats(),
                    per_solve)
    (X, norms, iters, codes), solve_ms, red, per_solve = out["guarded"]
    X = X.cpu().numpy()
    rel = host_residual(n, r, c, v, B, X)
    say("dist", rhs=DIST_RHS, iters=json.dumps(iters.tolist()),
        single_iters=json.dumps(list(main_iters[:DIST_RHS])),
        codes=json.dumps(codes.tolist()), solve_ms=round(solve_ms, 1),
        steps=norms.shape[0] - 1,
        host_f64_rel_residual=json.dumps([f"{x:.3e}" for x in rel]),
        allreduce_calls=red["calls"], allreduce_bytes=red["bytes"],
        launches=json.dumps({k: sum(e[0] for e in t.values())
                             for k, t in per_solve.items()}))
    check((codes == 0).all(), f"a dist solve broke down: codes {codes}")
    check((rel <= 1e-4).all(), f"dist host residuals {rel} > 1e-4")
    diff = [int(a) - int(b) for a, b in zip(iters, main_iters)]
    check(all(abs(d) <= 1 for d in diff), f"dist iterations {iters} vs "
          f"single {main_iters}")
    if any(diff):
        say("dist", iters_differ_from_single_by=json.dumps(diff))
    for run in ("unguarded", "repeat"):
        check(bits_equal(np, out[run][0][0].cpu().numpy(), X)
              and np.array_equal(out[run][0][1], norms),
              f"the {run} dist solve is not bitwise the guarded one")

    # the facade's dist backend on the same mesh: bitwise the direct solve
    t0 = time.perf_counter()
    fs = api_setup(Problem.from_edges(n, r, c, v),
                   SolverOptions(matvec_backend="ell", tol=1e-6),
                   backend="dist", mesh=mesh, cache=False)
    Xf, fres = fs.solve(B)
    facade_s = time.perf_counter() - t0
    say("dist", facade_backend=fs.backend, statuses=json.dumps(
        list(fres.statuses)), iters=json.dumps(fres.iters_per_rhs.tolist()),
        bitwise_direct=bits_equal(np, Xf, X), facade_s=round(facade_s, 2),
        mesh_shape=json.dumps(fs.stats()["mesh_shape"]))
    check(fs.backend == "dist" and fres.status == "converged",
          f"facade dist: {fs.backend} {fres.status}")
    check(bits_equal(np, Xf, X), "the facade's dist solve is not bitwise "
          "the direct solve_block")
    del fs, Xf
    launched = {k: n + launched[k] for k, n in phase_launches().items()}
    # the blocked solves run the matvec and the V-cycle on the whole block:
    # the k-column kernels, one launch a level operation for all columns
    check(all(launched[k] > 0 for k in (*BLOCK_FORMS, "agg_vote")),
          f"the dist path launched {launched}")

    # every kernel at the distributed path's shapes: spmv_ell on every
    # distributed level's block (the solve runs it on the finest and the
    # aggregation levels; an elimination level below the finest has no
    # SpMV in a V-cycle), jacobi and spmv_ell on the tail, agg_vote on
    # every row block of the setup; the solves' k-column forms, on the
    # block of DIST_RHS columns
    gen = torch.Generator(device=mesh.device).manual_seed(5)
    tally = per_solve["spmv_ell_block"]
    check(tuple(solver.arrays.fine.ell_col.shape) in tally,
          "spmv_ell did not run on the finest distributed level's block")
    for i, t in enumerate(solver.arrays.transfers):
        lvl = t.fine
        shape = tuple(lvl.ell_col.shape)
        x = torch.randn(lvl.n_pad, DIST_RHS, generator=gen,
                        device=mesh.device)
        measure_shape(torch, "dist", "spmv_ell_block", shape,
                      (lvl.ell_col, lvl.ell_val, x), {},
                      tally.get(shape, [0])[0], "solve",
                      level=f"distributed {i}")
    dist_shapes = {tuple(t.fine.ell_col.shape)
                   for t in solver.arrays.transfers}
    for name in BLOCK_FORMS:
        for shape, (calls, args, kw) in sorted(per_solve[name].items(),
                                               reverse=True):
            if shape not in dist_shapes:
                measure_shape(torch, "dist", name, shape, args, kw,
                              calls, "solve", level="tail")
    check(len(per_solve["jacobi_block"]) > 0,
          "jacobi did not run on the tail")
    for shape, (calls, args, kw) in sorted(per_setup["agg_vote"].items(),
                                           reverse=True):
        measure_shape(torch, "dist", "agg_vote", shape, args, kw, calls,
                      "setup", level="row block")
    return launched


def phase_dist_grid(torch, np, mesh_one) -> None:
    """Phase dist (b): BA 2^18 on a 2×2 mesh of four gloo processes on the
    card (``dist_child``, joined under a timeout), against a world of one
    (this process's NCCL mesh) on the same graph: the same levels and
    integer decisions, equal iterations, host residual ≤ 1e-4, the
    kernels at the 2×2 block shapes in every rank; and the finest level's
    §2.2 balance with random ordering on and off."""
    from repro_torch.core.hierarchy import SetupConfig
    from repro_torch.dist import (DistLaplacianSolver, balance_report,
                                  partition_edges_2d, run_world)

    n, r, c, v = graph(DIST_GRID_N, seed=0)
    on_card = mesh_one.device.type == "cuda"
    t0 = time.perf_counter()
    ranks = run_world(dist_child, 4,
                      args=((n, r, c, v), str(mesh_one.device)),
                      timeout=DIST_WORLD_TIMEOUT_S,
                      threads=2)
    world_s = time.perf_counter() - t0
    one = DistLaplacianSolver.setup(n, r, c, v, mesh_one,
                                    SetupConfig(matvec_backend="ell"))
    b = ranks[0]["b"]
    _, _, iters1, _ = one.solve_block(b[:, None], n_iters=200, tol=1e-6,
                                      guard=True)
    want = dist_decisions(one)
    rel = host_residual(n, r, c, v, b, ranks[0]["x"])
    say("dist", world="gloo (2, 2)", n=n, world_s=round(world_s, 1),
        setup_s=json.dumps([round(x["setup_s"], 2) for x in ranks]),
        solve_s=json.dumps([round(x["solve_s"], 2) for x in ranks]),
        iters=ranks[0]["iters"], world_of_one_iters=int(iters1[0]),
        host_f64_rel_residual=f"{rel:.3e}",
        levels=json.dumps(want["sizes"]), staged=ranks[0]["stats"]["staged"],
        allreduce_calls=ranks[0]["stats"]["calls"],
        launches=json.dumps(ranks[0]["launches"]))
    for rank, res in enumerate(ranks):
        check(res["decisions"] == want, f"rank {rank}'s levels or integer "
              f"decisions differ from the world of one's")
        check(res["iters"] == int(iters1[0]) and res["code"] == 0,
              f"rank {rank}: {res['iters']} iterations, code {res['code']}, "
              f"world of one {int(iters1[0])}")
        check(bits_equal(np, res["x"], ranks[0]["x"]),
              f"rank {rank}'s x differs from rank 0's")
        # gloo takes host tensors: every reduction of the card's tensors
        # is staged through host memory, and counted
        staged = res["stats"]["calls"] if on_card else 0
        check(res["stats"]["calls"] > 0 and res["stats"]["staged"] == staged,
              f"rank {rank}: {res['stats']}")
        check(all(res["launches"][k] > 0
                  for k in (*BLOCK_FORMS, "agg_vote")),
              f"rank {rank} launched {res['launches']}")
        print(res["lines"], end="", flush=True)
        check({k for k, _ in res["kernels"]} == {"spmv_ell_block",
                                                 "agg_vote"},
              f"rank {rank} checked {res['kernels']}")
    check(rel <= 1e-4, f"2x2 host residual {rel:.3e} > 1e-4")
    for ordering in (True, False):
        rep = balance_report(partition_edges_2d(n, r, c, v, 2, 2,
                                                random_ordering=ordering))
        say("dist", balance_random_ordering=ordering,
            imbalance=rep["imbalance"], fill_fraction=rep["fill_fraction"],
            max_nnz=rep["max_nnz"], min_nnz=rep["min_nnz"],
            capacity=rep["capacity"])


def _bag_launches() -> int:
    return launch_counts(("repro_torch.kernels.embedding_bag",))[0]


def phase_deepfm(torch, np):
    """DeepFM serving at FULL: returns the model, the bulk batch's
    fused-table ids and the embedding-bag launches of the served run, and
    its bag-backward and plan launches by name (both must be 0)."""
    from repro_torch.configs.deepfm import FULL, SHAPE_DIMS, serve_flops
    from repro_torch.data.synthetic import recsys_batch_stream
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.models.recsys.deepfm import DeepFM, _flat_ids

    cfg, dev = FULL, torch.device("cuda")
    t0 = time.perf_counter()
    model = DeepFM(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say("deepfm", config="FULL", fields=cfg.n_fields, embed_dim=cfg.embed_dim,
        multi_hot=cfg.multi_hot, mlp=cfg.mlp_sizes,
        total_vocab=cfg.total_vocab, table_rows=model.table.shape[0],
        params=n_params, param_mb=round(4 * n_params / 1e6, 1),
        init_s=round(time.perf_counter() - t0, 2))

    b_p99 = SHAPE_DIMS["serve_p99"]["batch"]
    b_bulk = SHAPE_DIMS["serve_bulk"]["batch"]
    n_cand = SHAPE_DIMS["retrieval_cand"]["n_candidates"]
    p99 = recsys_batch_stream(cfg.vocab_per_field, b_p99, cfg.multi_hot,
                              seed=0)
    requests = [next(p99)[1] for _ in range(8)]
    t0 = time.perf_counter()
    bulk_np = next(recsys_batch_stream(cfg.vocab_per_field, b_bulk,
                                       cfg.multi_hot, seed=0))[1]
    gen_s = time.perf_counter() - t0
    user = requests[0][:1]
    cands = torch.arange(n_cand, dtype=torch.int32, device=dev)
    bulk = torch.from_numpy(bulk_np).to(dev)

    def serve(idx_np):                  # host ids in, host logits out
        return model(torch.from_numpy(idx_np).to(dev)).cpu()

    def serve_bulk():
        out = model(bulk)
        torch.cuda.synchronize()
        return out

    def retrieve():
        out = model.retrieval_scores(torch.from_numpy(user).to(dev), cands)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()            # warm-up: cuBLAS handles, shapes
    serve(requests[0])
    serve_bulk()
    retrieve()
    warm_ms = (time.perf_counter() - t0) * 1e3

    bag_ops.embedding_bag_kernel.launches = 0
    bag_ops.embedding_bag_backward.launches = 0
    bag_ops.bag_grad_plan.launches = 0
    torch.cuda.synchronize()
    req_ms, logits, per_call = [], [], []
    for idx in requests:
        k0, t0 = _bag_launches(), time.perf_counter()
        logits.append(serve(idx))
        req_ms.append((time.perf_counter() - t0) * 1e3)
        per_call.append(_bag_launches() - k0)
    k0, t0 = _bag_launches(), time.perf_counter()
    bulk_logits = serve_bulk()
    bulk_ms = (time.perf_counter() - t0) * 1e3
    per_call.append(_bag_launches() - k0)
    k0, t0 = _bag_launches(), time.perf_counter()
    scores = retrieve()
    ret_ms = (time.perf_counter() - t0) * 1e3
    per_call.append(_bag_launches() - k0)
    launches = _bag_launches()

    say("deepfm", shape="serve_p99", batch=b_p99, requests=len(requests),
        request_ms_median=float(np.median(req_ms)),
        request_ms_max=max(req_ms),
        request_ms=json.dumps([round(m, 4) for m in req_ms]),
        model_gflop=serve_flops(cfg, b_p99) / 1e9)
    say("deepfm", shape="serve_bulk", batch=b_bulk,
        bags=b_bulk * cfg.n_fields, bulk_ms=bulk_ms,
        examples_per_s=b_bulk / (bulk_ms / 1e3),
        model_gflop=serve_flops(cfg, b_bulk) / 1e9,
        host_batch_gen_s=round(gen_s, 2), warmup_ms=round(warm_ms, 1))
    say("deepfm", shape="retrieval_cand", candidates=n_cand,
        retrieval_ms=ret_ms, launches=launches,
        launches_per_call=json.dumps(per_call))
    check(all(bool(torch.isfinite(x).all())
              for x in (*logits, bulk_logits, scores)),
          "deepfm: a logit or score is not finite")
    check(per_call == [2] * (len(requests) + 1) + [1],
          f"deepfm: embedding_bag launches per call {per_call}, "
          "expected 2 per forward and 1 per retrieval")
    check(launches == 2 * (len(requests) + 1) + 1,
          f"deepfm: embedding_bag launched {launches} times")
    backward = dict(embedding_bag_backward=bag_ops.embedding_bag_backward
                    .launches, bag_grad_plan=bag_ops.bag_grad_plan.launches)
    check(not any(backward.values()),
          f"deepfm: serving launched the bag backward or its plan {backward}")

    before = launch_counts(tuple(WRAPPERS))
    with plain_versions():
        plain = (serve(requests[0]), serve_bulk(), retrieve())
    check(launch_counts(tuple(WRAPPERS)) == before,
          "deepfm: the plain run launched a kernel")
    errs = []
    for name, got, want in (("serve_p99", logits[0], plain[0]),
                            ("serve_bulk", bulk_logits, plain[1]),
                            ("retrieval", scores, plain[2])):
        errs.append(float((got - want.to(got.device)).abs().max()))
        check(torch.allclose(got, want.to(got.device), rtol=1e-5,
                             atol=1e-5),
              f"deepfm {name}: kernel and plain outputs differ")

    # 64 retrieval scores against float64 on the host
    pick = torch.arange(0, n_cand, n_cand // 64, device=dev)[:64]
    uid = _flat_ids(cfg, torch.from_numpy(user).to(dev))[0, 1:]
    v_user = model.table[uid.reshape(-1).long()].double().sum(0)
    off = int(cfg.field_offsets()[0])
    want = (model.first_order[pick + off, 0].double()
            + model.table[pick + off].double() @ v_user)
    host_err = float((scores[pick].double() - want).abs().max())
    say("deepfm", kernel_vs_plain_max_abs=json.dumps(errs),
        retrieval_vs_f64_max_abs=host_err)
    check(host_err <= 1e-6, "deepfm: retrieval disagrees with float64")
    flat = _flat_ids(cfg, bulk).reshape(-1, cfg.multi_hot)
    return model, flat, launches, backward


def phase_kernels_deepfm(torch, model, flat, launches):
    """The embedding_bag record at the bulk batch's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import (embedding_bag_kernel,
                                                   embedding_bag_ref)

    table = model.table.detach()
    w1 = model.first_order.detach()
    n_vocab, d = table.shape
    n_bags, hot = flat.shape
    before = embedding_bag_kernel.launches
    err = 0.0
    paths = {}
    for name, t in (("table", table), ("first_order", w1)):
        got, paths[name] = path_of(embedding_bag_kernel,
                                   lambda: embedding_bag_kernel(t, flat))
        want = embedding_bag_ref(t, flat)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        check(torch.equal(got, want), f"embedding_bag on the {name} is not "
              "bitwise equal to its plain version")
        check(torch.equal(embedding_bag_kernel(t, flat), got),
              f"embedding_bag on the {name} is not bitwise repeatable")

    # sentinel ids: −2, −1, V (the reference's pad row) and V + 3
    sent = flat[:100_003].clone()
    pos = torch.arange(0, sent.numel(), 5, device=sent.device)
    bad = torch.tensor([-2, -1, n_vocab, n_vocab + 3], dtype=torch.int32,
                       device=sent.device)
    sent.view(-1)[pos] = bad[torch.arange(len(pos), device=sent.device) % 4]
    sent[:7] = bad[:2]                     # bags of sentinels alone sum to 0
    s_got, s_want = (embedding_bag_kernel(table, sent),
                     embedding_bag_ref(table, sent))
    # an ids view 8 bytes past a 16-byte boundary: read with plain loads
    k0 = embedding_bag_kernel.launches
    view = flat[1:]
    u_got, u_want = (embedding_bag_kernel(table, view),
                     embedding_bag_ref(table, view))
    check(embedding_bag_kernel.launches == k0 + 1 and view.data_ptr() % 16,
          "embedding_bag did not launch on an unaligned ids view")
    empty = flat[:1000, :0]
    k0 = embedding_bag_kernel.launches
    e_got = embedding_bag_kernel(table, empty)
    torch.cuda.synchronize()
    check(torch.equal(s_got, s_want) and not s_got[:7].any(),
          "embedding_bag disagrees with its plain version on sentinel ids")
    check(torch.equal(u_got, u_want),
          "embedding_bag disagrees with its plain version on an unaligned "
          "ids view")
    check(embedding_bag_kernel.launches == k0 and not e_got.any(),
          "embedding_bag at hot 0 launched or did not return zeros")
    say("kernels", name="embedding_bag", bit_exact=True,
        sentinel_max_abs=float((s_got - s_want).abs().max()),
        unaligned_view_max_abs=float((u_got - u_want).abs().max()))

    valid = (flat >= 0) & (flat < n_vocab)
    distinct = int(torch.unique(flat[valid]).numel())
    padded = torch.cat([table, table.new_zeros((1, d))])   # yardstick only
    mapped = torch.where(valid, flat, n_vocab)
    rec = kernel_record(
        torch, "embedding_bag", launches, err,
        lambda: embedding_bag_kernel(table, flat),
        lambda: embedding_bag_ref(table, flat),
        4 * n_bags * hot + 4 * n_bags * d + 4 * d * distinct,
        n_bags * hot * d,
        library=lambda: F.embedding_bag(mapped, padded, mode="sum",
                                        padding_idx=n_vocab),
        path=paths["table"])
    check(set(paths.values()) == {"narrow"}, f"DeepFM's bags (d = {d} and "
          f"1) ran the paths {paths}, expected the narrow one")
    say("kernels", name="embedding_bag", bags=n_bags, hot=hot, d=d,
        vocab=n_vocab, distinct_valid_ids=distinct)
    # the d = 1 first-order launch of every forward, at the same ids
    fo = lambda: embedding_bag_kernel(w1, flat)            # noqa: E731
    b_ms, b_by = bound(4 * n_bags * hot + 4 * n_bags + 4 * distinct,
                       n_bags * hot)
    d_ms, windows = device_ms(torch, fo, "embedding_bag")
    say("kernels", name="embedding_bag", shape="first_order", d=1,
        kernel_ms=time_ms(torch, fo), device_ms=d_ms, bound_ms=b_ms,
        bound_by=b_by, of_bound=round(b_ms / d_ms, 4),
        profiler_windows=windows)
    check(embedding_bag_kernel.launches > before,
          "embedding_bag was not launched in the comparison phase")
    return rec


def phase_train(torch, np) -> dict:
    """DeepFM training at FULL through the fault-tolerant loop (run A with
    failures, run B without). Returns the launches of run A by kernel,
    with the first batch's fused ids under ``"flat"`` for the kernel
    record."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs.deepfm import (FULL, SHAPE_DIMS, _train_flops,
                                            loss_and_grads, make_train_step)
    from repro_torch.data.synthetic import recsys_batch_stream
    from repro_torch.kernels.embedding_bag import bag_grad_plan
    from repro_torch.models.recsys.deepfm import _flat_ids, init_deepfm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.runtime import FailureInjector, TrainLoopRunner
    from repro_torch.tree import leaves, tree_map

    cfg, dev = FULL, torch.device("cuda")
    B = SHAPE_DIMS["train_batch"]["batch"]
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=TRAIN_STEPS)
    train_step = make_train_step(cfg, opt_cfg)
    t_phase = time.perf_counter()
    log = {}

    def data_fn(s):
        t0 = time.perf_counter()
        _, idx, lab = next(recsys_batch_stream(cfg.vocab_per_field, B,
                                               cfg.multi_hot, seed=0,
                                               start_step=s))
        batch = (torch.from_numpy(idx).to(dev),
                 torch.from_numpy(lab).to(dev))
        log["data_s"].append(time.perf_counter() - t0)
        log["step"] = s
        return batch

    def step_fn(params, opt, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = train_step(params, opt, *batch)
        torch.cuda.synchronize()
        log["step_ms"][log["step"]] = (time.perf_counter() - t0) * 1e3
        log["loss"][log["step"]] = float(metrics["loss"])
        log["calls"] += 1
        return params, opt, metrics

    def run(directory, injector):
        log.update(data_s=[], step_ms={}, loss={}, calls=0, step=None)
        params = init_deepfm(cfg, torch.Generator(device=dev).manual_seed(0))
        runner = TrainLoopRunner(step_fn, data_fn, directory,
                                 ckpt_every=TRAIN_CKPT_EVERY,
                                 failure_injector=injector)
        t0 = time.perf_counter()
        params, opt, _ = runner.run(params, adamw_init(params, opt_cfg),
                                    TRAIN_STEPS)
        torch.cuda.synchronize()
        return params, opt, time.perf_counter() - t0, dict(log)

    work = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        inj = FailureInjector(TRAIN_FAIL_AT)
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        bag_grad_plan.builds = 0
        pa, oa, secs_a, log_a = run(os.path.join(work, "a"), inj)
        launched = phase_launches()
        plan_builds = bag_grad_plan.builds
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        pb, ob, secs_b, log_b = run(os.path.join(work, "b"), None)

        state = dict(params=pa, opt=oa)
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(work, "timed"), TRAIN_STEPS, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, _ = restore_checkpoint(
            os.path.join(work, "a"), TRAIN_STEPS, state,
            shardings=tree_map(lambda t: t.device, state))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_ok = bitwise_equal(torch, restored, state)
        placed = all(t.device.type == dev.type for t in leaves(restored))
        del restored
    finally:
        shutil.rmtree(work, ignore_errors=True)

    calls = log_a["calls"]
    steps_b = [log_b["step_ms"][k] for k in range(5, TRAIN_STEPS)]
    step_ms = float(np.median(steps_b))
    losses = [log_b["loss"][k] for k in range(TRAIN_STEPS)]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    n_params = sum(t.numel() for t in leaves(pa))
    say("train", config="FULL", batch=B, bags=B * cfg.n_fields,
        ids=B * cfg.n_fields * cfg.multi_hot, params=n_params,
        steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
        fail_at=json.dumps(list(TRAIN_FAIL_AT)),
        fired=json.dumps(sorted(inj.fired)), step_calls_a=calls,
        step_calls_b=log_b["calls"])
    say("train", step_ms_median=step_ms, step_ms_min=min(steps_b),
        step_ms_max=max(steps_b),
        loop_s_per_step_a=secs_a / TRAIN_STEPS,
        loop_s_per_step_b=secs_b / TRAIN_STEPS,
        data_fn_s_mean=float(np.mean(log_b["data_s"])),
        examples_per_s=B / (step_ms / 1e3),
        model_tflop_per_step=_train_flops(cfg, B) / 1e12,
        model_tflops=_train_flops(cfg, B) / (step_ms / 1e3) / 1e12,
        peak_gib=round(peak_gib, 3), ckpt_save_s=round(save_s, 3),
        ckpt_restore_s=round(restore_s, 3))
    say("train", loss_first5_mean=first, loss_last5_mean=last,
        losses=json.dumps([round(x, 6) for x in losses]),
        launches=json.dumps(launched),
        bag_launches_per_step=launched["embedding_bag"] / calls,
        bag_backward_launches_per_step=launched["embedding_bag_backward"]
        / calls, bag_grad_plan_builds_per_step=plan_builds / calls)
    check(inj.fired == set(TRAIN_FAIL_AT),
          f"train: injected failures fired at {sorted(inj.fired)}")
    check(calls == TRAIN_STEPS + sum(f % TRAIN_CKPT_EVERY
                                     for f in TRAIN_FAIL_AT),
          f"train: run A ran {calls} steps")
    check(bitwise_equal(torch, dict(params=pa, opt=oa),
                          dict(params=pb, opt=ob)),
          "train: the recovered run is not bitwise the uninterrupted one")
    check(placed, "train: the placed restore left a leaf off the card")
    check(restored_ok,
          "train: the placed restore is not bitwise the state in memory")
    check(all(np.isfinite(list(log_a["loss"].values())))
          and all(np.isfinite(losses)), "train: a loss is not finite")
    check(last < first, f"train: the loss did not fall ({first} -> {last})")
    check(launched["embedding_bag"] == 2 * calls
          and launched["embedding_bag_backward"] == 2 * calls,
          f"train: launches {launched} for {calls} steps, expected 2 "
          "forward and 2 backward bag launches a step")
    check(plan_builds == launched["bag_grad_plan"] == calls,
          f"train: {plan_builds} bag_grad_plan builds and "
          f"{launched['bag_grad_plan']} launches for {calls} steps, expected "
          "one a step")
    check(all(launched[k] == 0 for k in ("spmv_ell", "jacobi", "agg_vote")),
          f"train: a solver kernel launched: {launched}")

    # AdamW alone, on run B's state and one batch's gradients
    idx, lab = data_fn(0)
    _, grads = loss_and_grads(cfg, pb, idx, lab)
    adamw_ms = time_ms(torch, lambda: adamw_update(opt_cfg, pb, grads, ob),
                       reps=10)
    say("train", adamw_ms=adamw_ms,
        seconds=round(time.perf_counter() - t_phase, 1))
    del grads
    return dict(launched, flat=_flat_ids(cfg, idx).reshape(-1, cfg.multi_hot),
                n_vocab=pa["table"].shape[0])


def phase_kernels_train(torch, train) -> list:
    """The bag_grad_plan and embedding_bag_backward records at the first
    batch's ids: the plan bitwise its plain version; the backward at d =
    10 (the record) and d = 1 (under its ``d1`` key), both over one plan
    of those ids."""
    from repro_torch.kernels.embedding_bag import (bag_grad_plan,
                                                   bag_grad_plan_ref,
                                                   embedding_bag_backward,
                                                   embedding_bag_backward_ref)

    flat, n_vocab = train["flat"], train["n_vocab"]
    n_bags, hot = flat.shape
    dev = flat.device
    gen = torch.Generator(device=dev).manual_seed(1)
    valid = (flat >= 0) & (flat < n_vocab)
    n_valid = int(valid.sum())
    ids = flat.reshape(-1)[valid.reshape(-1)].long()     # yardstick only
    # sentinel ids: half the slots −1, a quarter V; and only sentinels
    sent = flat.clone()
    sent.view(-1)[::2] = -1
    sent.view(-1)[1::4] = n_vocab
    only = torch.full_like(flat, -1)
    only.view(-1)[1::2] = n_vocab
    before = embedding_bag_backward.launches, bag_grad_plan.launches
    plan, want_plan = bag_grad_plan(flat, n_vocab), bag_grad_plan_ref(
        flat, n_vocab)
    s_plan, s_want = bag_grad_plan(sent, n_vocab), bag_grad_plan_ref(
        sent, n_vocab)
    same = [torch.equal(a.sorted_ids, b.sorted_ids) and torch.equal(
        a.rows, b.rows) for a, b in ((plan, want_plan), (s_plan, s_want))]
    check(all(same), f"bag_grad_plan is not bitwise its plain version "
          f"(first batch, sentinel ids): {same}")
    n_slots = n_bags * hot
    plan_rec = kernel_record(
        torch, "bag_grad_plan", train["bag_grad_plan"], 0.0,
        lambda: bag_grad_plan(flat, n_vocab),
        lambda: bag_grad_plan_ref(flat, n_vocab), 12 * n_slots, n_slots)
    del want_plan, s_plan, s_want
    err, rec = 0.0, None
    for d in (10, 1):
        g = torch.randn((n_bags, d), generator=gen, device=dev) / n_bags
        got, path = path_of(embedding_bag_backward,
                            lambda: embedding_bag_backward(g, flat, n_vocab,
                                                           plan))
        check(path == "narrow", f"DeepFM's backward at d = {d} ran the "
              f"{path} path, expected the narrow one")
        want = embedding_bag_backward_ref(g, flat, n_vocab, plan)
        scale = embedding_bag_backward_ref(g.abs(), flat, n_vocab, plan)
        torch.cuda.synchronize()
        check(bool(((got - want).abs() <= 1e-6 * scale).all()),
              f"embedding_bag_backward at d = {d} is not within 1e-6 of each "
              "row's sum of |g| of its plain version")
        check(torch.equal(embedding_bag_backward(g, flat, n_vocab, plan), got)
              and torch.equal(embedding_bag_backward(g, flat, n_vocab), got),
              f"embedding_bag_backward at d = {d} is not bitwise repeatable "
              "(with the plan, and building its own)")
        d_err = float((got - want).abs().max())
        err = max(err, d_err)
        # every row written: into an output full of NaN
        nan = torch.full((n_vocab, d), float("nan"), device=dev)
        embedding_bag_backward(g, flat, n_vocab, plan, _out=nan)
        check(not torch.isnan(nan).any() and torch.equal(nan, got),
              f"embedding_bag_backward at d = {d} left a row unwritten")
        s_got = embedding_bag_backward(g, sent, n_vocab)
        s_want = embedding_bag_backward_ref(g, sent, n_vocab)
        s_scale = embedding_bag_backward_ref(g.abs(), sent, n_vocab)
        nan.fill_(float("nan"))
        zero = embedding_bag_backward(g, only, n_vocab, _out=nan)
        torch.cuda.synchronize()
        check(bool(((s_got - s_want).abs() <= 1e-6 * s_scale).all())
              and not s_got[s_scale.sum(1) == 0].any() and not zero.any()
              and not torch.isnan(zero).any(),
              f"embedding_bag_backward at d = {d} on sentinel ids")
        del got, want, scale, nan, s_got, s_want, s_scale, zero
        rows = g.repeat_interleave(hot, dim=0)[valid.reshape(-1)]
        r = kernel_record(
            torch, "embedding_bag_backward", train["embedding_bag_backward"],
            d_err, lambda: embedding_bag_backward(g, flat, n_vocab, plan),
            lambda: embedding_bag_backward_ref(g, flat, n_vocab, plan),
            4 * n_bags * hot + 4 * n_bags * d + 4 * n_vocab * d,
            n_valid * d, library=lambda: torch.zeros(
                (n_vocab, d), device=dev).index_add_(0, ids, rows),
            path=path)
        plan_ms = plan_rec["kernel_ms"]
        plan_kernel_ms = time_ms(
            torch, lambda: embedding_bag_backward(g, flat, n_vocab))
        say("kernels", name="embedding_bag_backward", d=d, plan_ms=plan_ms,
            plan_kernel_ms=plan_kernel_ms, kernel_ms=r["kernel_ms"],
            device_ms=r["device_ms"], library_ms=r["library_ms"],
            plan_kernel_vs_library=round(plan_kernel_ms / r["library_ms"],
                                         4))
        r.update(plan_ms=plan_ms, plan_kernel_ms=plan_kernel_ms)
        if d == 10:
            rec = r
        else:
            rec["d1"] = {k: r[k] for k in (
                "max_abs_err", "device_ms", "kernel_ms", "plan_ms",
                "plan_kernel_ms", "plain_ms", "library_ms", "bound_ms",
                "path")}
        del rows
    check(embedding_bag_backward.launches > before[0]
          and bag_grad_plan.launches > before[1], "embedding_bag_backward "
          "or bag_grad_plan was not launched in the comparison phase")
    rec["max_abs_err"] = err
    say("kernels", name="embedding_bag_backward", bags=n_bags, hot=hot,
        vocab=n_vocab, valid_ids=n_valid,
        distinct_valid_ids=int(torch.unique(ids).numel()),
        largest_run=int(torch.bincount(ids).max()))
    return [rec, plan_rec]


@contextlib.contextmanager
def plain_bag_ops():
    """Rebind the bag forward and backward wrappers to their plain versions
    in the package and in ``ops`` (whose globals ``BagSum`` and
    ``ScatterSum`` read) for the duration of the block: the GNNs' gathers
    and scatters then run the plain versions, on the card too. A check of
    the kernels only; the port has no such switch."""
    mods = [importlib.import_module(m) for m in BAG_OPS]
    saved = [(m, k, getattr(m, k)) for m in mods for k in BAG_PLAIN]
    for m in mods:
        for k, ref in BAG_PLAIN.items():
            setattr(m, k, getattr(mods[1], ref))
    try:
        yield
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)


def gnn_minibatch(torch, np):
    """``minibatch_lg`` on the card (``configs.gnn_common.
    minibatch_lg_graph``: GNN_BATCH seeds, GNN_FANOUTS, a BA stand-in of
    GNN_BA_N vertices), checked for the shape's slot counts, every slot
    real. Returns the GraphBatch (no plans yet), the labels and the
    seconds it took (host numpy, then the copy)."""
    from repro_torch.configs.gnn_common import SHAPE_DIMS, minibatch_lg_graph

    dims = SHAPE_DIMS["minibatch_lg"]
    t0 = time.perf_counter()
    g, labels = minibatch_lg_graph("cuda", GNN_BA_N, GNN_BATCH, GNN_FANOUTS)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    N, E = g.n_nodes, g.n_edges
    check((N, E) == (dims["n_nodes"], dims["n_edges"])
          and bool((g.senders < N).all()) and bool((g.receivers < N).all()),
          f"gnn: the sample has {N} node and {E} edge slots, expected "
          f"{dims['n_nodes']} and {dims['n_edges']}, all real")
    return g, labels, host_s


def gnn_model(arch):
    """``(cfg, init, forward, flops)`` of ``arch`` at ``minibatch_lg``:
    the config's FULL widths with 602 input features."""
    from repro_torch.configs.gnn_common import SHAPE_DIMS

    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    cfg, init, fwd = mod.make_model("minibatch_lg",
                                    SHAPE_DIMS["minibatch_lg"]["d_feat"])
    return cfg, init, fwd, mod.flops


def first_out(out):
    return out[0] if isinstance(out, tuple) else out


def gnn_train(torch, np, arch, g, labels, opt_cfg, cfg=None,
              steps=GNN_STEPS) -> dict:
    """(a) ``steps`` steps of ``gnn_train_step`` on ``node_class_loss``
    from seeded weights on the card (``cfg``: the arch's minibatch_lg
    config, or another of its configs); each step's device time by CUDA
    events, and the peak memory."""
    from repro_torch.configs.gnn_common import gnn_train_step, node_class_loss
    from repro_torch.optim.adamw import adamw_init

    arch_cfg, init, fwd, _ = gnn_model(arch)
    cfg = cfg or arch_cfg

    def loss_fn(p, b):
        return node_class_loss(first_out(fwd(cfg, p, b["graph"])),
                               b["labels"], b["graph"].n_nodes)

    step = gnn_train_step(loss_fn, opt_cfg)
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(params, opt_cfg)
    batch = dict(graph=g, labels=labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, losses = [], []
    for _ in range(steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        params, opt, metrics = step(params, opt, batch)
        e1.record()
        marks.append((e0, e1))
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    return dict(cfg=cfg, fwd=fwd, step=step, batch=batch, params=params,
                opt=opt, losses=[float(x) for x in losses],
                step_ms=[a.elapsed_time(b) for a, b in marks],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def gnn_vs_plain(torch, run) -> dict:
    """(b) The trained model's forward with the kernels, twice (bitwise),
    against the same forward through the plain versions on the card."""
    cfg, fwd, params, g = run["cfg"], run["fwd"], run["params"], \
        run["batch"]["graph"]
    with torch.no_grad():
        got = fwd(cfg, params, g)
        again = fwd(cfg, params, g)
        before = phase_launches()
        with plain_bag_ops():
            want = fwd(cfg, params, g)
        after = phase_launches()
    got, again, want = ((x,) if not isinstance(x, tuple) else x
                        for x in (got, again, want))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "gnn: a repeated forward is not bitwise equal")
    check(before == after, "gnn: the plain forward launched a kernel")
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    scale = max(float(b.abs().max()) for b in want)
    check(all(bool(torch.isfinite(a).all()) for a in got)
          and err <= GNN_REL_TOL * scale,
          f"gnn: the forward with the kernels is {err} off the plain "
          f"versions' (max |out| {scale})")
    return dict(max_abs_err=err, max_abs_out=scale, rel_err=err / scale)


def gnn_replay(torch, run) -> dict:
    """(c) The same steps through ``TrainLoopRunner`` with an injected
    failure and checkpoints: bitwise the uninterrupted run."""
    import shutil
    import tempfile

    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime import FailureInjector, TrainLoopRunner

    cfg, init, _, _ = gnn_model("meshgraphnet")
    calls = [0]

    def step_fn(params, opt, batch):
        calls[0] += 1
        return run["step"](params, opt, batch)

    params = init(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt_state = adamw_init(params, run["opt_cfg"])
    inj = FailureInjector(GNN_FAIL_AT)
    work = tempfile.mkdtemp(prefix="repro_torch_gnn_")
    t0 = time.perf_counter()
    try:
        runner = TrainLoopRunner(step_fn, lambda s: run["batch"], work,
                                 ckpt_every=GNN_CKPT_EVERY,
                                 failure_injector=inj)
        params, opt_state, _ = runner.run(params, opt_state, GNN_STEPS)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    secs = time.perf_counter() - t0
    check(inj.fired == set(GNN_FAIL_AT), f"gnn: injected failures fired at "
          f"{sorted(inj.fired)}")
    check(bitwise_equal(torch, dict(params=params, opt=opt_state),
                        dict(params=run["params"], opt=run["opt"])),
          "gnn: the recovered MeshGraphNet run is not bitwise the "
          "uninterrupted one")
    return dict(step_calls=calls[0], loop_s=secs)


def molecule_graph(torch, np, n_graphs=128, nodes=30, edges=128):
    """``molecule``: ``n_graphs`` graphs of ``nodes`` nodes and ``edges``
    seeded edges each, endpoints inside their graph; 16 seeded features,
    seeded positions and per-graph targets."""
    from repro_torch.models.gnn.common import GraphBatch

    rng = np.random.default_rng(4)
    base = np.repeat(np.arange(n_graphs) * nodes, edges)
    s = (base + rng.integers(0, nodes, n_graphs * edges)).astype(np.int32)
    r = (base + rng.integers(0, nodes, n_graphs * edges)).astype(np.int32)
    n = n_graphs * nodes

    def dev(a):
        return torch.as_tensor(a, device="cuda")

    g = GraphBatch(senders=dev(s), receivers=dev(r),
                   node_feat=dev(rng.normal(size=(n, 16)).astype(np.float32)),
                   pos=dev(rng.normal(size=(n, 3)).astype(np.float32)),
                   graph_id=dev(np.repeat(np.arange(n_graphs),
                                          nodes).astype(np.int32)))
    targets = dev(rng.normal(size=n_graphs).astype(np.float32))
    return g, targets


def gnn_molecule(torch, np, opt_cfg) -> dict:
    """(d) EGNN at FULL widths on ``molecule``: GNN_MOLECULE_STEPS steps
    of ``graph_reg_loss`` (its pooling a scatter-sum over ``graph_id``
    with its own plan), then a seeded rotation and translation of ``pos``
    on the trained weights."""
    from repro_torch.configs import egnn
    from repro_torch.configs.gnn_common import (SHAPE_DIMS, gnn_train_step,
                                                graph_reg_loss)
    from repro_torch.kernels.embedding_bag import bag_grad_plan
    from repro_torch.optim.adamw import adamw_init

    dims = SHAPE_DIMS["molecule"]
    n_graphs = dims["n_graphs"]
    g, targets = molecule_graph(torch, np, n_graphs)
    check((g.n_nodes, g.n_edges) == (dims["n_nodes"], dims["n_edges"]),
          f"gnn: molecule has {g.n_nodes} nodes and {g.n_edges} edges")
    cfg, init, fwd = egnn.make_model("molecule", dims["d_feat"])
    builds = bag_grad_plan.builds
    g = g.with_plans()
    gplan = bag_grad_plan(g.graph_id.view(-1, 1), n_graphs)
    plans = bag_grad_plan.builds - builds

    def loss_fn(p, b):
        return graph_reg_loss(fwd(cfg, p, b)[0], b.graph_id, targets,
                              n_graphs, gplan)

    step = gnn_train_step(loss_fn, opt_cfg)
    params = init(cfg, torch.Generator(device="cuda").manual_seed(1))
    opt = adamw_init(params, opt_cfg)
    losses = []
    for _ in range(GNN_MOLECULE_STEPS):
        params, opt, m = step(params, opt, g)
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)), f"gnn: a molecule loss is not finite: "
          f"{losses}")
    check(plans == 3 and bag_grad_plan.builds - builds == 3,
          f"gnn: molecule built {bag_grad_plan.builds - builds} plans, "
          "expected 3 (senders, receivers, graph_id)")
    rot, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(3, 3)))
    if np.linalg.det(rot) < 0:
        rot[:, 0] = -rot[:, 0]
    rot = torch.as_tensor(rot.astype(np.float32), device="cuda")
    shift = torch.tensor([0.7, -1.3, 2.1], device="cuda")
    moved = dataclasses.replace(g, pos=g.pos @ rot.T + shift)
    with torch.no_grad():
        h, x = fwd(cfg, params, g)
        h2, x2 = fwd(cfg, params, moved)
    want = x @ rot.T + shift
    h_err = float((h2 - h).abs().max() / h.abs().max())
    x_err = float((x2 - want).abs().max() / want.abs().max())
    check(h_err <= 1e-4 and x_err <= 1e-4, f"gnn: EGNN is not E(n) "
          f"equivariant on the card: node_out {h_err}, coords {x_err} "
          "relative")
    return dict(losses=losses, node_out_rel_err=h_err, coords_rel_err=x_err,
                moved=float((x - g.pos).abs().max()))


def phase_gnn(torch, np) -> dict:
    """The scalar-payload GNNs training at FULL widths on minibatch_lg.
    Returns the launches of the main path (a) by kernel and the GNN-shape
    kernel records."""
    from repro_torch.kernels.embedding_bag import bag_grad_plan
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    g, labels, host_s = gnn_minibatch(torch, np)
    N, E = g.n_nodes, g.n_edges
    say("gnn", shape="minibatch_lg", nodes=N, edges=E,
        d_feat=g.node_feat.shape[1], classes=int(labels.max()) + 1,
        graph_s=round(host_s, 2))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=GNN_STEPS)
    zero_launches()
    builds = bag_grad_plan.builds
    g = g.with_plans()
    plans = bag_grad_plan.builds - builds
    runs, per_model = {}, {}
    for arch in GNN_ARCHS:
        before = phase_launches()
        run = runs[arch] = gnn_train(torch, np, arch, g, labels, opt_cfg)
        run["opt_cfg"] = opt_cfg
        after = phase_launches()
        per_model[arch] = {k: after[k] - before[k] for k in after}
    launched = phase_launches()
    check(plans == 2 and bag_grad_plan.builds - builds == 2
          and launched["bag_grad_plan"] == 2,
          f"gnn: {bag_grad_plan.builds - builds} plan builds and "
          f"{launched['bag_grad_plan']} launches for the graph's 2 index "
          "arrays (senders, receivers), expected one each")
    check(all(launched[k] == 0 for k in ("spmv_ell", "jacobi", "agg_vote")),
          f"gnn: a solver kernel launched: {launched}")
    for arch, run in runs.items():
        cfg, losses = run["cfg"], run["losses"]
        timed = run["step_ms"][GNN_TIMED_FROM:]
        step_ms = float(np.median(timed))
        flop = gnn_model(arch)[3](cfg, N, E)
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        k = per_model[arch]
        say("gnn", model=arch, layers=cfg.n_layers, d_hidden=cfg.d_hidden,
            d_out=cfg.d_out,
            params=sum(t.numel() for t in leaves(run["params"])),
            step_ms_median=step_ms, step_ms_min=min(timed),
            step_ms_max=max(timed), first_step_ms=run["step_ms"][0],
            nodes_per_s=N / (step_ms / 1e3),
            model_tflop_per_step=flop / 1e12,
            model_tflops=flop / (step_ms / 1e3) / 1e12,
            peak_gib=round(run["peak_gib"], 3),
            bag_launches_per_step=k["embedding_bag"] / GNN_STEPS,
            bag_backward_launches_per_step=k["embedding_bag_backward"]
            / GNN_STEPS)
        say("gnn", model=arch, loss_first5_mean=first, loss_last5_mean=last,
            losses=json.dumps([round(x, 5) for x in losses]))
        check(all(np.isfinite(losses)), f"gnn: {arch}: a loss is not finite")
        check(last < first, f"gnn: {arch}: the loss did not fall "
              f"({first} -> {last})")
        check(k["embedding_bag"] > 0 and k["embedding_bag_backward"] > 0,
              f"gnn: {arch} did not launch the gather and scatter kernels: "
              f"{k}")
    t_a = time.perf_counter() - t_phase
    for arch in GNN_ARCHS:                     # (b)
        say("gnn", model=arch, check="kernels_vs_plain",
            **gnn_vs_plain(torch, runs[arch]))
    replay = gnn_replay(torch, runs["meshgraphnet"])    # (c)
    say("gnn", model="meshgraphnet", check="replay",
        fail_at=json.dumps(list(GNN_FAIL_AT)), ckpt_every=GNN_CKPT_EVERY,
        bitwise=True, **replay)
    del runs
    mol = gnn_molecule(torch, np, opt_cfg)             # (d)
    say("gnn", model="egnn", shape="molecule",
        losses=json.dumps([round(x, 5) for x in mol.pop("losses")]), **mol)
    records = phase_kernels_gnn(torch, np, g, launched)    # (e)
    secs = time.perf_counter() - t_phase
    say("gnn", seconds=round(secs, 1), train_seconds=round(t_a, 1))
    return dict(launched, records=records, graph=(g, labels))


def phase_kernels_gnn(torch, np, g, launched) -> list:
    """(e) The gather (``embedding_bag``, bags of one id) and the scatter
    (``embedding_bag_backward`` over the receivers' plan) at the
    minibatch_lg graph and each width of GNN_WIDTHS, against their plain
    versions, with ``index_select`` and ``zeros(N, d).index_add_`` as the
    library yardsticks, each record with the path that ran (the one
    ``kernels.bag_path`` names); then the scatter's accumulate form at
    d = GNN_WIDTHS[0] (:func:`accumulate_record`)."""
    from repro_torch.kernels import bag_path
    from repro_torch.kernels.embedding_bag import (embedding_bag_backward,
                                                   embedding_bag_backward_ref,
                                                   embedding_bag_kernel,
                                                   embedding_bag_ref)

    N, E = g.n_nodes, g.n_edges
    S, R = g.senders.view(-1, 1), g.receivers.view(-1, 1)
    plan = g.receiver_plan
    s_long, r_long = g.senders.long(), g.receivers.long()
    gen = torch.Generator(device="cuda").manual_seed(6)
    before = embedding_bag_kernel.launches, embedding_bag_backward.launches
    records = []
    for d in GNN_WIDTHS:
        x = torch.randn((N, d), generator=gen, device="cuda")
        m = torch.randn((E, d), generator=gen, device="cuda")
        got, g_path = path_of(embedding_bag_kernel,
                              lambda: embedding_bag_kernel(x, S))
        want = embedding_bag_ref(x, S)
        check(torch.equal(got, want) and torch.equal(
            embedding_bag_kernel(x, S), got),
            f"gnn gather at d = {d} is not bitwise its plain version, or "
            "not bitwise on a repeat")
        records.append(kernel_record(
            torch, "embedding_bag", launched["embedding_bag"], 0.0,
            lambda: embedding_bag_kernel(x, S),
            lambda: embedding_bag_ref(x, S), 4 * E + 8 * E * d, 0,
            library=lambda: x.index_select(0, s_long),
            label=f"gnn_gather_d{d}",
            replaces="src/repro/models/gnn/common.py:50", path=g_path))
        got, s_path = path_of(embedding_bag_backward,
                              lambda: embedding_bag_backward(m, R, N, plan))
        want = embedding_bag_backward_ref(m, R, N, plan)
        scale = embedding_bag_backward_ref(m.abs(), R, N, plan)
        nan = torch.full((N, d), float("nan"), device="cuda")
        embedding_bag_backward(m, R, N, plan, _out=nan)
        torch.cuda.synchronize()
        check(bool(((got - want).abs() <= 1e-6 * scale).all())
              and torch.equal(embedding_bag_backward(m, R, N, plan), got)
              and torch.equal(nan, got),
              f"gnn scatter at d = {d}: not within 1e-6 of each row's sum of "
              "|m| of its plain version, not bitwise on a repeat, or a row "
              "left unwritten")
        check(g_path == s_path == bag_path(d), f"gnn at d = {d}: the gather "
              f"ran the {g_path} path and the scatter the {s_path} path, "
              f"expected {bag_path(d)}")
        err = float((got - want).abs().max())
        del got, want, scale, nan
        records.append(kernel_record(
            torch, "embedding_bag_backward",
            launched["embedding_bag_backward"], err,
            lambda: embedding_bag_backward(m, R, N, plan),
            lambda: embedding_bag_backward_ref(m, R, N, plan),
            8 * E + 4 * E * d + 4 * N * d, E * d,
            library=lambda: torch.zeros((N, d), device="cuda").index_add_(
                0, r_long, m),
            label=f"gnn_scatter_d{d}",
            replaces="src/repro/models/gnn/common.py:58", path=s_path))
        if d == GNN_WIDTHS[0]:
            records.append(accumulate_record(
                torch, m, R, N, plan, launched["embedding_bag_backward"],
                f"gnn_scatter_acc_d{d}",
                "src/repro/models/gnn/common.py:58"))
    check(embedding_bag_kernel.launches > before[0]
          and embedding_bag_backward.launches > before[1],
          "gnn: the gather or scatter was not launched in the comparison")
    for rec in records:
        rec["gnn_launches"] = rec["launches"]
    return records


def accumulate_record(torch, m, R, n, plan, launches, label, replaces):
    """The bag backward's accumulate form: the messages ``m`` [E, d] at
    the ids ``R`` [E, 1] (every one in ``[0, n)``) over ``plan`` added into
    a seeded running sum ``acc`` [n, d]: bitwise ``acc.add_`` of the
    scatter, and against its plain version (``acc + the plain sums``).
    Its bound counts the ids and the plan's rows, the messages, and the
    rows the ids touch read and written, counted on the card;
    ``acc.index_add_`` is its yardstick. The record's
    ``touched_rows`` is that count."""
    from repro_torch.kernels.embedding_bag import (embedding_bag_backward,
                                                   embedding_bag_backward_ref)

    E, d = m.shape
    gen = torch.Generator(device="cuda").manual_seed(8)
    acc0 = torch.randn((n, d), generator=gen, device="cuda")
    got, path = path_of(embedding_bag_backward,
                        lambda: embedding_bag_backward(m, R, n, plan,
                                                       acc=acc0.clone()))
    want = acc0.clone().add_(embedding_bag_backward(m, R, n, plan))
    torch.cuda.synchronize()
    check(path == "wide_accumulate" and torch.equal(got, want),
          f"{label}: the accumulate form ({path}) is not bitwise the "
          "scatter added with add_")
    del want
    plain = embedding_bag_backward_ref(m, R, n, plan, acc=acc0.clone())
    err = float((got - plain).abs().max())
    del got, plain
    ids = plan.sorted_ids
    touched = int(torch.unique_consecutive(ids[ids < n]).numel())
    r_long = R[:, 0].long()
    acc = acc0
    rec = kernel_record(
        torch, "embedding_bag_backward", launches, err,
        lambda: embedding_bag_backward(m, R, n, plan, acc=acc),
        lambda: embedding_bag_backward_ref(m, R, n, plan, acc=acc),
        8 * E + 4 * E * d + 8 * touched * d, E * d,
        library=lambda: acc.index_add_(0, r_long, m), label=label,
        replaces=replaces, path=path)
    say("kernels", name=label, touched_rows=touched, edges=E, rows=n, d=d)
    rec["touched_rows"] = touched
    return rec


def eqf_probe(torch, np, g, labels, cfg, opt_cfg) -> dict:
    """The memory plan's probes: one step at each depth of
    EQF_PROBE_LAYERS, its peak GiB; the per-layer slope (between the two
    deepest probes) and the base, and the peak they predict at the
    depth (a) runs."""
    peaks = {}
    for n in EQF_PROBE_LAYERS:
        run = gnn_train(torch, np, "equiformer_v2", g, labels, opt_cfg,
                        dataclasses.replace(cfg, n_layers=n), steps=1)
        check(np.isfinite(run["losses"][0]),
              f"equiformer: the {n}-layer probe's loss is not finite")
        peaks[n] = run["peak_gib"]
        del run
    lo, hi = EQF_PROBE_LAYERS[-2:]
    slope = (peaks[hi] - peaks[lo]) / (hi - lo)
    base = peaks[hi] - slope * hi
    return dict(peaks_gib=peaks, slope_gib_per_layer=slope, base_gib=base,
                predicted_gib=base + slope * cfg.n_layers)


def eqf_molecule(torch, np, opt_cfg) -> dict:
    """(c) and (d): Equiformer-v2 at FULL (12 layers) on ``molecule``.
    (c) the loss and gradients with remat on and off, bitwise; (d)
    GNN_MOLECULE_STEPS steps of ``graph_reg_loss`` (pooled over the
    ``graph_id`` plan), then a seeded rotation and translation of ``pos``
    on the trained weights."""
    from repro_torch.configs import equiformer_v2
    from repro_torch.configs.gnn_common import (SHAPE_DIMS, gnn_train_step,
                                                graph_reg_loss)
    from repro_torch.kernels.embedding_bag import bag_grad_plan
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import leaves, value_and_grad

    dims = SHAPE_DIMS["molecule"]
    n_graphs = dims["n_graphs"]
    g, targets = molecule_graph(torch, np, n_graphs)
    cfg, init, fwd = equiformer_v2.make_model("molecule", dims["d_feat"])
    builds = bag_grad_plan.builds
    g = g.with_plans()
    gplan = bag_grad_plan(g.graph_id.view(-1, 1), n_graphs)
    params = init(cfg, torch.Generator(device="cuda").manual_seed(1))

    def loss_fn(p, b, c=cfg):
        return graph_reg_loss(fwd(c, p, b), b.graph_id, targets, n_graphs,
                              gplan)

    remat = [value_and_grad(lambda p: loss_fn(p, g, dataclasses.replace(
        cfg, remat=r)), params) for r in (False, True)]
    torch.cuda.synchronize()
    (l0, g0), (l1, g1) = remat
    check(torch.equal(l0, l1) and bitwise_equal(torch, g0, g1),
          "equiformer: molecule's loss or gradients with remat differ from "
          "those without")
    nonzero = sum(int(bool((t != 0).any())) for t in leaves(g0))
    del remat, g0, g1
    step = gnn_train_step(loss_fn, opt_cfg)
    opt = adamw_init(params, opt_cfg)
    losses = []
    for _ in range(GNN_MOLECULE_STEPS):
        params, opt, m = step(params, opt, g)
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)), f"equiformer: a molecule loss is not "
          f"finite: {losses}")
    check(bag_grad_plan.builds - builds == 3,
          f"equiformer: molecule built {bag_grad_plan.builds - builds} "
          "plans, expected 3 (senders, receivers, graph_id)")
    rot, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(3, 3)))
    if np.linalg.det(rot) < 0:
        rot[:, 0] = -rot[:, 0]
    rot = torch.as_tensor(rot.astype(np.float32), device="cuda")
    shift = torch.tensor([0.7, -1.3, 2.1], device="cuda")
    moved = dataclasses.replace(g, pos=g.pos @ rot.T + shift)
    with torch.no_grad():
        out, out2 = fwd(cfg, params, g), fwd(cfg, params, moved)
    rel = float((out2 - out).abs().max() / out.abs().max())
    check(bool(torch.isfinite(out).all()) and rel <= EQF_MOVE_TOL,
          f"equiformer: a rotation and translation of pos moved the "
          f"output by {rel} of its max |x| (limit {EQF_MOVE_TOL})")
    return dict(layers=cfg.n_layers, remat_bitwise=True,
                nonzero_grad_leaves=nonzero, losses=losses,
                moved_rel=rel)


def phase_equiformer(torch, np, graph) -> dict:
    """Equiformer-v2 training at FULL widths on minibatch_lg (the gnn
    phase's graph) at EQF_LAYERS layers, with the chunk (65,536 edges)
    and remat of the config. Returns the launches of its main path (the
    plans' build and (a)) by kernel and its kernel records."""
    from repro_torch.configs import equiformer_v2
    from repro_torch.configs.gnn_common import SHAPE_DIMS
    from repro_torch.kernels.embedding_bag import (bag_grad_plan,
                                                   embedding_bag_backward)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.tree import leaves

    import gc

    t_phase = time.perf_counter()
    g, labels = graph
    N, E = g.n_nodes, g.n_edges
    cfg = dataclasses.replace(gnn_model("equiformer_v2")[0],
                              n_layers=EQF_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    live_gib = torch.cuda.memory_allocated() / 2 ** 30
    say("equiformer", shape="minibatch_lg", nodes=N, edges=E,
        layers=cfg.n_layers, channels=cfg.channels, l_max=cfg.l_max,
        m_max=cfg.m_max, heads=cfg.n_heads, edge_chunk=cfg.edge_chunk_size,
        remat=cfg.remat, d_feat=g.node_feat.shape[1],
        live_gib_at_start=round(live_gib, 3))
    zero_launches()
    builds = bag_grad_plan.builds
    g = dataclasses.replace(g, sender_plan=None, receiver_plan=None)
    g = g.with_plans(edge_chunk=cfg.edge_chunk_size)
    plans = bag_grad_plan.builds - builds
    launched = phase_launches()
    n_chunks = len(g.chunk_plans)
    check(plans == 2 + 2 * n_chunks == 8
          and launched["bag_grad_plan"] == plans,
          f"equiformer: {plans} plan builds and "
          f"{launched['bag_grad_plan']} launches, expected 8 (the "
          f"endpoints', and each of the {n_chunks} chunks' two)")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=3, total_steps=EQF_STEPS)
    probe = eqf_probe(torch, np, g, labels, cfg, opt_cfg)
    say("equiformer", check="memory_plan",
        **{f"peak_gib_{n}_layers": round(v, 3)
           for n, v in probe.pop("peaks_gib").items()},
        **{k: round(v, 3) for k, v in probe.items()})
    zero_launches()
    paths0 = dict(embedding_bag_backward.paths)
    t_a = time.perf_counter()
    run = gnn_train(torch, np, "equiformer_v2", g, labels, opt_cfg, cfg,
                    steps=EQF_STEPS)                              # (a)
    t_a = time.perf_counter() - t_a
    after = phase_launches()
    adds = {k: v - paths0[k] for k, v in embedding_bag_backward.paths.items()}
    launched = {k: launched[k] + after[k] for k in launched}
    losses, timed = run["losses"], run["step_ms"][EQF_TIMED_FROM:]
    step_ms = float(np.median(timed))
    flop = equiformer_v2.flops(cfg, N, E)
    flop_exec = equiformer_v2.flops_executed(cfg, N, E)
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    say("equiformer", model="equiformer-v2", layers=cfg.n_layers,
        params=sum(t.numel() for t in leaves(run["params"])),
        step_ms_median=step_ms, step_ms_min=min(timed),
        step_ms_max=max(timed), first_step_ms=run["step_ms"][0],
        nodes_per_s=N / (step_ms / 1e3),
        model_tflop_per_step=flop / 1e12,
        model_tflops=flop / (step_ms / 1e3) / 1e12,
        executed_tflop_per_step=flop_exec / 1e12,
        executed_tflops=flop_exec / (step_ms / 1e3) / 1e12,
        peak_gib=round(run["peak_gib"], 3),
        phase_peak_gib=round(run["peak_gib"] - live_gib, 3),
        bag_launches_per_step=after["embedding_bag"] / EQF_STEPS,
        bag_backward_launches_per_step=after["embedding_bag_backward"]
        / EQF_STEPS, bag_backward_paths_per_step=json.dumps(
            {k: v / EQF_STEPS for k, v in adds.items()}),
        plan_builds=plans, train_s=round(t_a, 1))
    say("equiformer", loss_first3_mean=first, loss_last3_mean=last,
        losses=json.dumps([round(x, 5) for x in losses]))
    check(all(np.isfinite(losses)), "equiformer: a loss is not finite")
    check(last < first, f"equiformer: the loss did not fall ({first} -> "
          f"{last})")
    check(after["embedding_bag"] > 0 and after["embedding_bag_backward"] > 0
          and after["bag_grad_plan"] == 0,
          f"equiformer: the gather and scatter kernels did not launch, or "
          f"a step built a plan: {after}")
    check(adds["wide_accumulate"] > 0, f"equiformer: no chunk scatter added "
          f"into its running sum (the accumulate form): {adds}")
    check(run["peak_gib"] - live_gib <= EQF_PEAK_LIMIT_GIB,
          f"equiformer: peak {run['peak_gib']} GiB with {live_gib} GiB live "
          f"at the phase's start, above the plan's {EQF_PEAK_LIMIT_GIB}")
    check(all(launched[k] == 0 for k in ("spmv_ell", "jacobi", "agg_vote")),
          f"equiformer: a solver kernel launched: {launched}")
    say("equiformer", check="kernels_vs_plain",
        **gnn_vs_plain(torch, run))                               # (b)
    del run
    mol = eqf_molecule(torch, np, opt_cfg)                        # (c), (d)
    say("equiformer", shape="molecule",
        losses=json.dumps([round(x, 5) for x in mol.pop("losses")]), **mol)
    records = phase_kernels_eqf(torch, g, launched,
                                adds["wide_accumulate"])          # (e)
    say("equiformer", seconds=round(time.perf_counter() - t_phase, 1),
        train_seconds=round(t_a, 1))
    return dict(launched, records=records)


def phase_kernels_eqf(torch, g, launched, adds) -> list:
    """(e) The gather (``embedding_bag``, bags of one id) of a chunk's
    65,536 senders' rows of (l_max+1)²·C = 6,272 floats from the 169,984
    nodes, and the scatter (``embedding_bag_backward``) of the chunk's
    messages over its receivers' plan, against their plain versions, with
    ``index_select`` and ``zeros(N, d).index_add_`` as the library
    yardsticks, each with the path that ran (the wide one); then the
    scatter's accumulate form (:func:`accumulate_record`), the form (a)
    ran ``adds`` times, into a running sum as (a)'s chunks do."""
    from repro_torch.kernels.embedding_bag import (embedding_bag_backward,
                                                   embedding_bag_backward_ref,
                                                   embedding_bag_kernel,
                                                   embedding_bag_ref)
    from repro_torch.models.gnn.so3 import n_coeffs

    cfg = gnn_model("equiformer_v2")[0]
    N, Ec = g.n_nodes, cfg.edge_chunk_size
    d = n_coeffs(cfg.l_max) * cfg.channels
    S, R = g.senders[:Ec].view(-1, 1), g.receivers[:Ec].view(-1, 1)
    plan = g.chunk_plans[0][1]
    s_long, r_long = S[:, 0].long(), R[:, 0].long()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((N, d), generator=gen, device="cuda")
    m = torch.randn((Ec, d), generator=gen, device="cuda")
    got, g_path = path_of(embedding_bag_kernel,
                          lambda: embedding_bag_kernel(x, S))
    want = embedding_bag_ref(x, S)
    check(torch.equal(got, want) and torch.equal(embedding_bag_kernel(x, S),
                                                 got) and g_path == "wide",
          f"equiformer gather at d = {d} ({g_path} path) is not bitwise its "
          "plain version, or not bitwise on a repeat")
    del got, want
    records = [kernel_record(
        torch, "embedding_bag", launched["embedding_bag"], 0.0,
        lambda: embedding_bag_kernel(x, S), lambda: embedding_bag_ref(x, S),
        4 * Ec + 8 * Ec * d, 0,
        library=lambda: x.index_select(0, s_long),
        label=f"eqf_gather_d{d}",
        replaces="src/repro/models/gnn/equiformer.py:150", path=g_path)]
    del x
    got, s_path = path_of(embedding_bag_backward,
                          lambda: embedding_bag_backward(m, R, N, plan))
    want = embedding_bag_backward_ref(m, R, N, plan)
    scale = embedding_bag_backward_ref(m.abs(), R, N, plan)
    ok = bool(((got - want).abs() <= 1e-6 * scale).all())
    err = float((got - want).abs().max())
    del want, scale
    nan = torch.full((N, d), float("nan"), device="cuda")
    embedding_bag_backward(m, R, N, plan, _out=nan)
    check(ok and torch.equal(embedding_bag_backward(m, R, N, plan), got)
          and torch.equal(nan, got) and s_path == "wide",
          f"equiformer scatter at d = {d} ({s_path} path): not within 1e-6 "
          "of each row's sum of |m| of its plain version, not bitwise on a "
          "repeat, or a row left unwritten")
    del got, nan
    records.append(kernel_record(
        torch, "embedding_bag_backward", launched["embedding_bag_backward"],
        err, lambda: embedding_bag_backward(m, R, N, plan),
        lambda: embedding_bag_backward_ref(m, R, N, plan),
        8 * Ec + 4 * Ec * d + 4 * N * d, Ec * d,
        library=lambda: torch.zeros((N, d), device="cuda").index_add_(
            0, r_long, m),
        label=f"eqf_scatter_d{d}",
        replaces="src/repro/models/gnn/equiformer.py:158", path=s_path))
    records.append(dict(accumulate_record(
        torch, m, R, N, plan, launched["embedding_bag_backward"],
        f"eqf_scatter_acc_d{d}",
        "src/repro/models/gnn/equiformer.py:249"),
        accumulate_launches=adds))
    for rec in records:
        rec["equiformer_launches"] = rec["launches"]
    return records


def gpu_clocks() -> str:
    """The card's SM and memory clocks, power draw and temperature now, as
    ``nvidia-smi`` reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def free_card(torch) -> float:
    """Collect what nothing holds any more and give the cache back; the
    GiB still allocated."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2 ** 30


def lm_tokens(torch, vocab, batch, seq, step=0):
    """``lm_batch_stream``'s tokens of ``step`` ([batch, seq + 1], int32)
    on the card."""
    from repro_torch.data.synthetic import lm_batch_stream

    toks = next(lm_batch_stream(vocab, batch, seq, start_step=step))[1]
    return torch.as_tensor(toks, device="cuda")


def lm_train(torch, cfg, opt_cfg, directory, injector=None,
             resume_from=None) -> dict:
    """(a), (b): steps of ``lm_train_step`` (CARD_MICROBATCHES microbatches
    of train_4k's sequence) up to LM_STEPS through ``TrainLoopRunner``, a
    checkpoint every LM_CKPT_EVERY; each call's CUDA-event ms and loss.
    ``resume_from``, another run's checkpoint directory: its checkpoint at
    step LM_CKPT_EVERY is hard-linked into ``directory`` and the run
    starts at the failing step LM_FAIL_AT[0] with fresh weights, so the
    injected failure makes the runner restore that checkpoint onto the
    card (``restore_checkpoint(..., shardings=)``) and replay from it."""
    import shutil

    from repro_torch.configs.lm_common import (CARD_BATCH, CARD_MICROBATCHES,
                                               SHAPE_DIMS, lm_train_step)
    from repro_torch.models.sharding import null_plan
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime import TrainLoopRunner

    seq = SHAPE_DIMS["train_4k"]["seq_len"]
    train_step = lm_train_step(cfg, null_plan(), opt_cfg,
                               n_microbatches=CARD_MICROBATCHES)
    log = dict(step_ms={}, loss={}, calls=0, step=None)

    def data_fn(s):
        log["step"] = s
        return lm_tokens(torch, cfg.vocab, CARD_BATCH, seq, s)

    def step_fn(params, opt, tokens):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, metrics = train_step(params, opt, tokens)
        end.record()
        end.synchronize()
        log["step_ms"][log["step"]] = start.elapsed_time(end)
        log["loss"][log["step"]] = float(metrics["loss"])
        log["calls"] += 1
        return params, opt, metrics

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt, start = adamw_init(params, opt_cfg), 0
    if resume_from is not None:
        name = f"step_{LM_CKPT_EVERY:08d}"
        shutil.copytree(os.path.join(resume_from, name),   # hard links
                        os.path.join(directory, name), copy_function=os.link)
        start = LM_FAIL_AT[0]
    runner = TrainLoopRunner(step_fn, data_fn, directory,
                             ckpt_every=LM_CKPT_EVERY,
                             failure_injector=injector)
    params, opt, _ = runner.run(params, opt, LM_STEPS, start_step=start)
    torch.cuda.synchronize()
    return dict(log, params=params, opt=opt,
                loop_s=time.perf_counter() - t0, clocks=gpu_clocks())


def lm_embedding_grad_repeat(torch, cfg, params) -> dict:
    """The embedding's gradient (Zipf ids, so many duplicates) at one
    microbatch's shape, twice under ``torch.use_deterministic_algorithms``
    (an op without a deterministic version raises): bitwise equal."""
    from repro_torch.configs.lm_common import (CARD_BATCH, CARD_MICROBATCHES,
                                               SHAPE_DIMS)

    seq = SHAPE_DIMS["train_4k"]["seq_len"]
    toks = lm_tokens(torch, cfg.vocab, CARD_BATCH // CARD_MICROBATCHES, seq)
    toks = toks[:, :-1]
    table = params["embed"].detach().requires_grad_()
    gen = torch.Generator(device="cuda").manual_seed(3)
    up = torch.randn((*toks.shape, cfg.d_model), generator=gen,
                     device="cuda").to(table.dtype)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        grads = [torch.autograd.grad(
            torch.nn.functional.embedding(toks, table), table, up)[0]
            for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(was)
    ids = toks.reshape(-1)
    distinct = int(torch.unique(ids).numel())
    check(torch.equal(grads[0].view(torch.int16), grads[1].view(torch.int16)),
          "lm: the embedding's gradient is not bitwise equal on a repeat")
    return dict(embed_grad_ids=int(ids.numel()), embed_grad_distinct=distinct,
                embed_grad_bitwise_repeat=True)


def lm_prefill(torch, np, cfg, params) -> dict:
    """(c) ``forward`` on LM_PREFILL_BATCH × prefill_32k's 32,768 tokens,
    without a graph: ms (CUDA events, one call), tokens/s, peak GiB;
    every logit finite."""
    from repro_torch.configs.lm_common import SHAPE_DIMS
    from repro_torch.models.transformer import forward

    seq = SHAPE_DIMS["prefill_32k"]["seq_len"]
    toks = lm_tokens(torch, cfg.vocab, LM_PREFILL_BATCH, seq - 1, step=7)
    live = free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        start.record()
        logits = forward(cfg, params, toks)
        end.record()
        end.synchronize()
        finite = bool(torch.isfinite(logits).all())
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    shape = tuple(logits.shape)
    del logits
    check(finite and shape == (LM_PREFILL_BATCH, seq, cfg.vocab),
          f"lm prefill: logits {shape}, all finite: {finite}")
    tokens = LM_PREFILL_BATCH * seq
    flop = 2.0 * cfg.active_param_count() * tokens
    return dict(prefill_batch=LM_PREFILL_BATCH, prefill_seq=seq,
                prefill_ms=ms, prefill_tokens_per_s=tokens / (ms / 1e3),
                prefill_model_tflops=flop / (ms / 1e3) / 1e12,
                prefill_peak_gib=round(peak, 3),
                prefill_phase_peak_gib=round(peak - live, 3))


def lm_decode(torch, np, cfg, params, batch=None) -> dict:
    """(d) decode_32k: B = 128 (or ``batch``) against a 32,768-slot cache
    (filled from a seeded generator in place), LM_DECODE_STEPS
    ``decode_step``s at ``cache_len`` 32,767; each step's ms against its
    bound (the cache, the weights (an MoE's every expert: its dense
    ``[E, cap, d]`` buffer runs them all) and one embedding row a
    sequence read, the new K/V and the logits written, over the HBM
    rate); the cache written in place."""
    from repro_torch.configs.lm_common import SHAPE_DIMS
    from repro_torch.models.transformer import decode_step, init_kv_cache

    dims = SHAPE_DIMS["decode_32k"]
    B, T = batch or dims["global_batch"], dims["seq_len"]
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    cache = init_kv_cache(cfg, B, T)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for c in cache:
        c.normal_(generator=gen)
    ptrs = [c.untyped_storage().data_ptr() for c in cache]
    toks = lm_tokens(torch, cfg.vocab, B, 0, step=9)
    times = []
    with torch.no_grad():
        for _ in range(LM_DECODE_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits, out = decode_step(cfg, params, toks, cache, T - 1)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            check(out[0] is cache[0] and out[1] is cache[1],
                  "lm decode: decode_step returned another cache")
        finite = bool(torch.isfinite(logits).all())
    clocks = gpu_clocks()
    in_place = [c.untyped_storage().data_ptr() for c in cache] == ptrs
    cache_bytes = sum(c.numel() * c.element_size() for c in cache)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del cache, logits, out
    check(in_place, "lm decode: the cache's storage moved")
    check(finite, "lm decode: a logit is not finite")
    item = params["embed"].element_size()
    weights = sum(t.numel() * t.element_size() for k, t in params.items()
                  if k != "embed")
    written = (2 * cfg.n_layers * B * cfg.n_kv_heads * cfg.d_head
               + B * cfg.vocab) * item
    read = cache_bytes + weights + B * cfg.d_model * item
    b_ms = (read + written) / HBM_BYTES_PER_S * 1e3
    ms = float(np.median(times[1:]))
    return dict(decode_batch=B, decode_cache_slots=T,
                decode_cache_gib=round(cache_bytes / 2 ** 30, 3),
                decode_ms_median=ms, decode_ms_min=min(times[1:]),
                decode_ms_first=times[0], decode_bound_ms=b_ms,
                decode_of_bound=round(b_ms / ms, 4),
                decode_bytes=int(read + written),
                decode_tokens_per_s=B / (ms / 1e3),
                decode_peak_gib=round(peak, 3), cache_in_place=in_place,
                decode_clocks_after=json.dumps(clocks))


def lm_decode_equals_forward(torch, np, cfg, params) -> dict:
    """(e) At FULL widths in float32 (a float32 copy of the trained
    weights, TF32 off): LM_EQ_SEQS sequences of LM_EQ_LEN tokens decoded
    token by token from an empty cache give each position's logits of
    ``forward`` on the whole sequence within LM_EQ_TOL of max |logits|;
    and the bfloat16 forward's distance from the float32 one."""
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_kv_cache)

    free_card(torch)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: v.float() for k, v in params.items()}
    toks = lm_tokens(torch, cfg.vocab, LM_EQ_SEQS, LM_EQ_LEN - 1, step=13)
    with torch.no_grad():
        full = forward(cfg32, p32, toks)
        cache = init_kv_cache(cfg32, LM_EQ_SEQS, LM_EQ_LEN)
        steps = []
        for i in range(LM_EQ_LEN):
            logits, cache = decode_step(cfg32, p32, toks[:, i:i + 1], cache,
                                        i)
            steps.append(logits)
        dec = torch.cat(steps, 1)
        scale = float(full.abs().max())
        err = float((dec - full).abs().max()) / scale
        bf16 = forward(cfg, params, toks).float()
        bf16_err = float((bf16 - full).abs().max()) / scale
    del p32, full, cache, dec, bf16, steps
    check(err <= LM_EQ_TOL, f"lm: decode token by token is {err} of max "
          f"|logits| from the forward, above {LM_EQ_TOL}")
    return dict(eq_seqs=LM_EQ_SEQS, eq_len=LM_EQ_LEN,
                decode_vs_forward_f32=err, bf16_vs_f32_forward=bf16_err,
                max_abs_logit_f32=scale)


def lm_other_configs(torch, np) -> list:
    """(f) qwen2.5-3b and starcoder2-3b at FULL widths and LM_OTHER_LAYERS
    layers: one train step on 1 × 4,096 tokens (one microbatch): a finite
    loss; ms (CUDA events, the shapes' first call) and peak GiB."""
    from repro_torch.configs.lm_common import SHAPE_DIMS, lm_train_step
    from repro_torch.models.sharding import null_plan
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    seq = SHAPE_DIMS["train_4k"]["seq_len"]
    out = []
    for name in LM_OTHER:
        full = importlib.import_module(f"repro_torch.configs.{name}").FULL
        cfg = dataclasses.replace(full, n_layers=LM_OTHER_LAYERS)
        live = free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0))
        opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
        step = lm_train_step(cfg, null_plan(), opt_cfg)
        toks = lm_tokens(torch, cfg.vocab, 1, seq, step=5)
        opt = adamw_init(params, opt_cfg)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, metrics = step(params, opt, toks)
        end.record()
        end.synchronize()
        loss = float(metrics["loss"])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del params, opt, metrics
        rec = dict(model=full.name, layers=cfg.n_layers, d_model=cfg.d_model,
                   heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                   vocab=cfg.vocab, loss=loss,
                   step_ms=start.elapsed_time(end),
                   peak_gib=round(peak, 3),
                   phase_peak_gib=round(peak - live, 3))
        check(np.isfinite(loss), f"lm: {full.name}'s loss is not finite")
        out.append(rec)
    return out


def lm_launcher(torch) -> dict:
    """(g) ``repro_torch.launch.train.main`` on the card (its default
    device): the reference test's 30 steps of qwen2-0.5b-smoke at batch 4
    × 32 tokens end below a loss of LM_LAUNCHER_BAR."""
    import shutil
    import tempfile

    from repro_torch.launch.train import main as train_main

    work = tempfile.mkdtemp(prefix="repro_torch_lm_launch_")
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            loss = train_main(["--steps", "30", "--batch", "4", "--seq",
                               "32", "--ckpt-dir", work, "--ckpt-every",
                               "10"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    secs = time.perf_counter() - t0
    check(loss < LM_LAUNCHER_BAR, f"lm: the launcher's loss {loss} is not "
          f"below {LM_LAUNCHER_BAR} ({printed.getvalue().strip()})")
    return dict(launcher_loss=loss, launcher_s=round(secs, 2))


def phase_lm(torch, np) -> dict:
    """The dense LM family: qwen2-0.5b at FULL trains, replays, prefills
    and decodes on the card; decode equals the forward in float32; the
    other two dense configs take a step; the launcher trains. Returns the
    launches of the phase by kernel (none of the port's kernels is on
    this path) and (a)'s measured ``phase_peak_gib`` and median
    ``step_ms``, which phase ``dryrun`` predicts."""
    import shutil
    import tempfile

    from repro_torch.configs import qwen2_0p5b
    from repro_torch.configs.lm_common import (CARD_BATCH, CARD_MICROBATCHES,
                                               SHAPE_DIMS)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import FailureInjector

    t_phase = time.perf_counter()
    live = free_card(torch)
    cfg = qwen2_0p5b.FULL
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=LM_STEPS)
    seq = SHAPE_DIMS["train_4k"]["seq_len"]
    tokens = CARD_BATCH * seq
    flop = 6.0 * cfg.active_param_count() * tokens
    say("lm", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
        vocab=cfg.vocab, dtype=str(cfg.dtype).split(".")[1],
        remat=cfg.remat, q_chunk=cfg.q_chunk, params=cfg.param_count(),
        batch=CARD_BATCH, microbatches=CARD_MICROBATCHES, seq=seq,
        steps=LM_STEPS, ckpt_every=LM_CKPT_EVERY,
        live_gib_at_start=round(live, 3))
    zero_launches()
    work = tempfile.mkdtemp(prefix="repro_torch_lm_")
    try:
        torch.cuda.reset_peak_memory_stats()
        a = lm_train(torch, cfg, opt_cfg, os.path.join(work, "a"))   # (a)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        inj = FailureInjector(LM_FAIL_AT)
        b = lm_train(torch, cfg, opt_cfg, os.path.join(work, "b"), inj,
                     resume_from=os.path.join(work, "a"))            # (b)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    timed = [a["step_ms"][k] for k in range(LM_TIMED_FROM, LM_STEPS)]
    step_ms = float(np.median(timed))
    losses = [a["loss"][k] for k in range(LM_STEPS)]
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    say("lm", step_ms_median=step_ms, step_ms_min=min(timed),
        step_ms_max=max(timed), first_step_ms=a["step_ms"][0],
        tokens_per_step=tokens, tokens_per_s=tokens / (step_ms / 1e3),
        model_tflop_per_step=flop / 1e12,
        model_tflops=flop / (step_ms / 1e3) / 1e12,
        mfu_bf16=round(flop / (step_ms / 1e3) / BF16_FLOPS_PER_S, 4),
        peak_gib=round(peak, 3), phase_peak_gib=round(peak - live, 3),
        clocks_after_a=json.dumps(a["clocks"]),
        loop_s_a=round(a["loop_s"], 2), loop_s_b=round(b["loop_s"], 2),
        step_calls_b=b["calls"], fired=json.dumps(sorted(inj.fired)))
    say("lm", loss_first3_mean=first, loss_last3_mean=last,
        losses=json.dumps([round(x, 5) for x in losses]),
        losses_b=json.dumps([round(b["loss"][k], 5)
                             for k in range(LM_CKPT_EVERY, LM_STEPS)]))
    check(all(np.isfinite(losses)), "lm: a loss is not finite")
    check(last < first, f"lm: the loss did not fall ({first} -> {last})")
    check(inj.fired == set(LM_FAIL_AT),
          f"lm: injected failures fired at {sorted(inj.fired)}")
    check(b["calls"] == LM_STEPS - LM_CKPT_EVERY,
          f"lm: the replayed run ran {b['calls']} steps")
    replay = bitwise_equal(torch, dict(params=a["params"], opt=a["opt"]),
                           dict(params=b["params"], opt=b["opt"]))
    params = a["params"]
    del a, b
    say("lm", check="replay_bitwise", replay_bitwise=replay,
        **lm_embedding_grad_repeat(torch, cfg, params))
    check(replay, "lm: the replayed run is not bitwise the uninterrupted one")
    for part in (lm_prefill, lm_decode, lm_decode_equals_forward):  # (c-e)
        t0 = time.perf_counter()
        rec = part(torch, np, cfg, params)
        say("lm", **rec, seconds=round(time.perf_counter() - t0, 1))
    del params
    t0 = time.perf_counter()
    for rec in lm_other_configs(torch, np):                          # (f)
        say("lm", **rec)
    say("lm", other_configs_s=round(time.perf_counter() - t0, 1),
        **lm_launcher(torch))                                        # (g)
    launched = phase_launches()
    check(all(n == 0 for n in launched.values()),
          f"lm: a kernel of the port launched on the LM path: {launched}")
    say("lm", launches=json.dumps(launched),
        seconds=round(time.perf_counter() - t_phase, 1))
    return launched, dict(phase_peak_gib=peak - live, step_ms=step_ms)


@contextlib.contextmanager
def moe_routes(routers):
    """Within the block, record each call of ``moe_ffn``'s routing
    (``transformer.moe_route``, which ``moe_ffn`` looks up at call time):
    yields a list of ``{layer, probs, idx, pos, keep, cap}`` (detached,
    on the card), the layer found by the address of its router in
    ``routers`` (the stacked ``[L, d, E]`` leaf the layers' views share)."""
    import repro_torch.models.transformer as T

    real = T.moe_route
    layer = {routers[i].data_ptr(): i for i in range(routers.shape[0])}
    calls = []

    def recorded(xt, router, m):
        r = real(xt, router, m)
        calls.append(dict(layer=layer.get(router.data_ptr()),
                          probs=r.probs.detach(), idx=r.idx, pos=r.pos,
                          keep=r.keep, cap=r.cap))
        return r

    T.moe_route = recorded
    try:
        yield calls
    finally:
        T.moe_route = real


def moe_recount(np, probs, k: int, cap: int):
    """The reference's routing rule recounted on the host from ``probs``
    [shards, Tl, E]: each token's k experts, highest first and the lower
    expert first among ties; each entry's rank among the earlier entries
    of its shard routed to its expert, counted entry by entry; kept if
    below ``cap``."""
    idx = np.argsort(-probs, axis=-1, kind="stable")[..., :k]
    flat = idx.reshape(idx.shape[0], -1)
    pos = np.empty_like(flat)
    for s in range(flat.shape[0]):
        seen = np.zeros(probs.shape[-1], np.int64)
        for n, e in enumerate(flat[s]):
            pos[s, n] = seen[e]
            seen[e] += 1
    pos = pos.reshape(idx.shape)
    return idx, pos, pos < cap


def moe_train(torch, np, cfg, opt_cfg) -> dict:
    """(a) MOE_STEPS steps of ``lm_train_step`` (donated) at
    MOE_CARD_BATCH × train_4k's 4,096 tokens in MOE_CARD_MICROBATCHES
    microbatches: each step's CUDA-event ms and loss, the peak GiB, and in
    step MOE_DROP_STEP the share of routed entries each layer dropped
    (every forward of the step, the remat recomputation included)."""
    from repro_torch.configs.lm_common import (MOE_CARD_BATCH,
                                               MOE_CARD_MICROBATCHES,
                                               SHAPE_DIMS, lm_train_step)
    from repro_torch.models.sharding import null_plan
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import adamw_init

    seq = SHAPE_DIMS["train_4k"]["seq_len"]
    live = free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(params, opt_cfg)
    step = lm_train_step(cfg, null_plan(), opt_cfg,
                         n_microbatches=MOE_CARD_MICROBATCHES, donate=True)
    step_ms, losses, drops = [], [], None
    for s in range(MOE_STEPS):
        toks = lm_tokens(torch, cfg.vocab, MOE_CARD_BATCH, seq, s)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with contextlib.ExitStack() as stack:
            if s == MOE_DROP_STEP:
                calls = stack.enter_context(moe_routes(params["router"]))
            start.record()
            params, opt, metrics = step(params, opt, toks)
            end.record()
            end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(metrics["loss"]))
        if s == MOE_DROP_STEP:
            dropped = [0] * cfg.n_layers
            routed = [0] * cfg.n_layers
            for c in calls:
                dropped[c["layer"]] += int((~c["keep"]).sum())
                routed[c["layer"]] += c["keep"].numel()
            drops = [d / r for d, r in zip(dropped, routed)]
            cap = calls[0]["cap"]
            del calls
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del opt
    return dict(params=params, step_ms=step_ms, losses=losses, drops=drops,
                cap=cap, peak_gib=peak, phase_peak_gib=peak - live,
                loop_s=time.perf_counter() - t0, clocks=gpu_clocks())


def moe_repeat(torch, np, cfg, params) -> dict:
    """(b) One microbatch's loss and gradients twice: every leaf's bits
    equal; and layer 0's routing in the first run (its first forward)
    equal to ``moe_recount`` on the host from its router probabilities."""
    from repro_torch.configs.lm_common import SHAPE_DIMS
    from repro_torch.models.transformer import lm_loss
    from repro_torch.tree import value_and_grad

    seq = SHAPE_DIMS["train_4k"]["seq_len"]
    toks = lm_tokens(torch, cfg.vocab, 1, seq, step=MOE_STEPS)
    runs = []
    with moe_routes(params["router"]) as calls:
        for _ in range(2):
            runs.append(value_and_grad(lambda p: lm_loss(cfg, p, toks),
                                       params))
    bitwise = bitwise_equal(torch, runs[0], runs[1])
    finite = all(bool(torch.isfinite(g).all()) for g in runs[0][1].values())
    del runs
    first = next(c for c in calls if c["layer"] == 0)
    probs = first["probs"].cpu().numpy()
    k = cfg.moe.top_k
    idx, pos, keep = moe_recount(np, probs, k, first["cap"])
    recount = (np.array_equal(first["idx"].cpu().numpy(), idx)
               and np.array_equal(first["pos"].cpu().numpy(), pos)
               and np.array_equal(first["keep"].cpu().numpy(), keep))
    top = -np.sort(-probs, axis=-1)
    boundary = int((top[..., k - 1] == top[..., k]).sum())
    within = int((top[..., :k] == top[..., 1:k + 1]).any(-1).sum())
    del calls, first
    check(bitwise, "moe: a microbatch's loss and gradients are not bitwise "
          "equal on a repeat")
    check(finite, "moe: a gradient is not finite")
    check(recount, "moe: layer 0's (idx, pos, keep) differ from the host "
          "recount of the capacity rule")
    return dict(grads_bitwise_repeat=bitwise, routing_equals_recount=recount,
                recount_tokens=int(probs.shape[0] * probs.shape[1]),
                recount_dropped=int((~keep).sum()),
                boundary_ties=boundary, ties_in_top_k_plus_1=within)


def moe_arctic(torch, np) -> dict:
    """(e) arctic-480b at FULL widths, ARCTIC_CARD_LAYERS layer(s) with
    all 128 experts and the dense residual FFN: prefill (``lm_prefill``)
    and decode at B = 128 (``lm_decode``); forward only."""
    from repro_torch.configs import arctic_480b
    from repro_torch.configs.lm_common import ARCTIC_CARD_LAYERS
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(arctic_480b.FULL, n_layers=ARCTIC_CARD_LAYERS)
    free_card(torch)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out = dict(arctic_layers=cfg.n_layers, arctic_params=cfg.param_count(),
               arctic_init_s=round(time.perf_counter() - t0, 2))
    for part in (lm_prefill, lm_decode):
        out.update({f"arctic_{k}": v
                    for k, v in part(torch, np, cfg, params).items()})
    del params
    return out


def moe_smoke(torch, np) -> dict:
    """(f) Both MoE archs' registry smoke cases on the card (a train step
    and a decode), and a step of arctic's ``SMOKE`` with its registered
    int8 moments (``arctic_480b.OPT_CFG``): losses and logits finite."""
    from repro_torch.configs import arctic_480b, get_arch
    from repro_torch.configs.lm_common import lm_train_step
    from repro_torch.models.sharding import null_plan
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.adamw import adamw_init

    out = {}
    for arch in ("arctic-480b", "moonshot-v1-16b-a3b"):
        res = get_arch(arch).make_smoke_case()()
        finite = bool(torch.isfinite(res["loss"])
                      and torch.isfinite(res["logits"]).all())
        check(finite, f"moe: {arch}'s smoke case is not finite")
        out[f"smoke_{arch}_loss"] = float(res["loss"])
    cfg = arctic_480b.SMOKE
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(params, arctic_480b.OPT_CFG)
    toks = lm_tokens(torch, cfg.vocab, 2, 16, step=3)
    _, opt, metrics = lm_train_step(cfg, null_plan(), arctic_480b.OPT_CFG)(
        params, opt, toks)
    loss = float(metrics["loss"])
    q = opt["mu"]["moe_gate"]["q"]
    check(np.isfinite(loss) and q.dtype == torch.int8,
          f"moe: arctic's int8 step gave loss {loss}, moments {q.dtype}")
    out["smoke_arctic_int8_loss"] = loss
    return out


def phase_moe(torch, np) -> dict:
    """The MoE half of the LM family: moonshot-v1-16b-a3b at FULL widths
    (MOE_CARD_LAYERS layers) trains, repeats a microbatch bitwise,
    prefills and decodes; arctic-480b at FULL widths prefills and decodes;
    both smoke cases run. Returns the phase's launches by kernel (none of
    the port's kernels is on this path)."""
    from repro_torch.configs import moonshot_v1_16b_a3b
    from repro_torch.configs.lm_common import (MOE_CARD_BATCH,
                                               MOE_CARD_DECODE_BATCH,
                                               MOE_CARD_LAYERS,
                                               MOE_CARD_MICROBATCHES,
                                               SHAPE_DIMS)
    from repro_torch.optim.adamw import AdamWConfig

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(moonshot_v1_16b_a3b.FULL,
                              n_layers=MOE_CARD_LAYERS)
    m = cfg.moe
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=MOE_STEPS)
    seq = SHAPE_DIMS["train_4k"]["seq_len"]
    tokens = MOE_CARD_BATCH * seq
    say("moe", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, experts=m.n_experts,
        top_k=m.top_k, d_ff_expert=m.d_ff_expert, shared=m.n_shared,
        capacity_factor=m.capacity_factor, vocab=cfg.vocab,
        dtype=str(cfg.dtype).split(".")[1], remat=cfg.remat,
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        batch=MOE_CARD_BATCH, microbatches=MOE_CARD_MICROBATCHES, seq=seq,
        steps=MOE_STEPS, live_gib_at_start=round(free_card(torch), 3))
    zero_launches()
    a = moe_train(torch, np, cfg, opt_cfg)                         # (a)
    timed = a["step_ms"][MOE_TIMED_FROM:]
    step_ms = float(np.median(timed))
    routed = cfg.n_layers * 3 * cfg.d_model * m.d_ff_expert
    flop = 6.0 * cfg.active_param_count() * tokens
    executed = flop + 6.0 * routed * (
        m.n_experts * a["cap"] * MOE_CARD_MICROBATCHES - m.top_k * tokens)
    losses = a["losses"]
    first, last = float(np.mean(losses[:2])), float(np.mean(losses[-2:]))
    say("moe", step_ms_median=step_ms, step_ms_min=min(timed),
        step_ms_max=max(timed), first_step_ms=a["step_ms"][0],
        step_ms_all=json.dumps([round(x, 1) for x in a["step_ms"]]),
        tokens_per_step=tokens, tokens_per_s=tokens / (step_ms / 1e3),
        model_tflop_per_step=flop / 1e12,
        model_tflops=flop / (step_ms / 1e3) / 1e12,
        executed_tflop_per_step=executed / 1e12,
        executed_tflops=executed / (step_ms / 1e3) / 1e12,
        mfu_bf16=round(flop / (step_ms / 1e3) / BF16_FLOPS_PER_S, 4),
        cap=a["cap"], peak_gib=round(a["peak_gib"], 3),
        phase_peak_gib=round(a["phase_peak_gib"], 3),
        loop_s=round(a["loop_s"], 2), clocks_after_a=json.dumps(a["clocks"]))
    say("moe", loss_first2_mean=first, loss_last2_mean=last,
        losses=json.dumps([round(x, 5) for x in losses]),
        dropped_share_by_layer=json.dumps([round(x, 5) for x in a["drops"]]),
        dropped_in_step=MOE_DROP_STEP)
    check(all(np.isfinite(losses)), "moe: a loss is not finite")
    check(last < first, f"moe: the loss did not fall ({first} -> {last})")
    params = a.pop("params")
    del a
    t0 = time.perf_counter()
    say("moe", check="repeat_and_recount",                          # (b)
        **moe_repeat(torch, np, cfg, params),
        seconds=round(time.perf_counter() - t0, 1))
    for part, kw in ((lm_prefill, {}),                              # (c)
                     (lm_decode, dict(batch=MOE_CARD_DECODE_BATCH))):  # (d)
        t0 = time.perf_counter()
        rec = part(torch, np, cfg, params, **kw)
        say("moe", **rec, seconds=round(time.perf_counter() - t0, 1))
    del params
    t0 = time.perf_counter()
    say("moe", **moe_arctic(torch, np),                             # (e)
        seconds=round(time.perf_counter() - t0, 1))
    t0 = time.perf_counter()
    say("moe", **moe_smoke(torch, np),                              # (f)
        seconds=round(time.perf_counter() - t0, 1))
    launched = phase_launches()
    check(all(n == 0 for n in launched.values()),
          f"moe: a kernel of the port launched on the MoE path: {launched}")
    say("moe", launches=json.dumps(launched),
        seconds=round(time.perf_counter() - t_phase, 1))
    return launched


# ----------------------------------------------------------------------
# 16. dryrun
# ----------------------------------------------------------------------

def fake_launch_counts() -> dict:
    """Every kernel wrapper's shape-only calls, by kernel name (the
    k-column forms by form name)."""
    wrappers = {m.rsplit(".", 1)[1]: getattr(importlib.import_module(
        f"{m}.ops"), w) for m, (w, _) in WRAPPERS.items()}
    counts = {name: fn.fake_launches for name, fn in wrappers.items()}
    counts.update({form: wrappers[mod].block_fake_launches
                   for form, mod in BLOCK_FORMS.items()})
    return dict(counts, **{name: fn.fake_launches
                           for name, fn in _bag_backward().items()})


def _finite_fields(rec, path="rec") -> list:
    """The paths of the record's numbers that are not finite."""
    import math

    if isinstance(rec, dict):
        return [p for k, v in rec.items()
                for p in _finite_fields(v, f"{path}.{k}")]
    if isinstance(rec, (int, float)) and not isinstance(rec, bool):
        return [] if math.isfinite(rec) else [path]
    return []


def dryrun_child(device: str, job) -> dict:
    """:func:`dryrun_job` in a child process of the phase's pool."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    torch.set_num_threads(1)
    return dryrun_job(device, job)


def dryrun_job(device: str, job) -> dict:
    """One job of the dryrun phase on ``device`` ("cuda"; "cpu" to
    rehearse it), in a process with no default group: ``("cell", arch,
    shape, multi_pod)``, ``("card",)`` (phase (b)) or ``("world",)``
    (phase (c)). Returns its record(s) and the kernels' launches, real
    and shape-only, of the job; leaves no default group."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import (get_arch, laplacian_solver, lm_common,
                                     moonshot_v1_16b_a3b, qwen2_0p5b)
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.dryrun import cell_record

    cuda = torch.device(device)
    t0 = time.perf_counter()
    out = dict(job=list(job))
    if job[0] == "cell":
        _, arch, shape, multi_pod = job
        mesh = lmesh.make_production_mesh(multi_pod=multi_pod,
                                          device_type=device)
        if arch == "moonshot-v1-16b-a3b":
            full = moonshot_v1_16b_a3b.FULL
            dims = lm_common.SHAPE_DIMS[shape]
            n_mb = lm_common._auto_microbatches(
                full, dims["global_batch"], dims["seq_len"],
                lm_common.make_lm_plan(mesh).dp_size())
            case = lm_common.make_lm_dryrun_case(
                dataclasses.replace(full, n_layers=DRYRUN_MOE_LAYERS),
                shape, mesh, n_microbatches=n_mb)
            out["layers"] = DRYRUN_MOE_LAYERS
        else:
            case = get_arch(arch).make_dryrun_case(shape, mesh)
        out["rec"] = cell_record(case, cuda, mesh.size())
    elif job[0] == "card":
        mesh = lmesh.make_test_mesh((1, 1), device_type=device)
        case = lm_common.make_lm_dryrun_case(
            qwen2_0p5b.FULL, "train_4k", mesh, batch=lm_common.CARD_BATCH,
            n_microbatches=lm_common.CARD_MICROBATCHES, donate=False)
        out["rec"] = cell_record(case, cuda, 1)
    else:                               # (c): NCCL world of one, fake one
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.dist import init_world

        stats = {}
        for world in ("real", "fake"):
            if world == "real":         # NCCL on the card
                init_world(device)
            else:
                lmesh.start_fake_world(1)
            mesh = DeviceMesh(device, torch.zeros((1, 1), dtype=torch.int64),
                              mesh_dim_names=("data", "model"))
            case = laplacian_solver.make_dryrun_case("rmat_16", mesh)
            args = case.make_inputs(case.args)
            case.process_mesh.reset_stats()
            _, norms = case.fn(*args)
            if device == "cuda":
                torch.cuda.synchronize()
            stats[world] = dict(case.process_mesh.stats(), norms=len(norms),
                                backend=case.process_mesh.backend)
            dist.destroy_process_group()
        out["stats"] = stats
    if dist.is_initialized():
        dist.destroy_process_group()
    out.update(seconds=round(time.perf_counter() - t0, 1),
               launches=phase_launches(), fake_launches=fake_launch_counts())
    return out


DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", False),
                ("moonshot-v1-16b-a3b", "train_4k", False),
                ("deepfm", "train_batch", False),
                ("meshgraphnet", "minibatch_lg", False),
                ("laplacian-solver", "rmat_16", False),
                ("qwen2-0.5b", "train_4k", True))


def phase_dryrun(torch, lm_measured, device: str = "cuda") -> dict:
    """16. dryrun (see the module docstring): every job but (b) in a child
    process of its own, all started together; (b), the longest trace, in
    this process meanwhile (its imports are done). ``lm_measured``: phase
    ``lm``'s ``phase_peak_gib`` and ``step_ms``. Returns the shape-only
    launches of (a) by kernel."""
    import functools
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    jobs = [("cell",) + c for c in DRYRUN_CELLS] + [("world",)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(jobs), mp_context=ctx) as pool:
        pending = pool.map(functools.partial(dryrun_child, device), jobs,
                           timeout=DRYRUN_JOB_TIMEOUT_S)
        card = dryrun_job(device, ("card",))
        results = list(pending) + [card]
    fake = {}
    for r in results:
        # a model cell's only real launches: the GNN's plans, sorted on
        # the real ids of the rank's share of the edges
        real = {k: n for k, n in r["launches"].items()
                if n and not (k == "bag_grad_plan"
                              and r["job"][1:2] == ["meshgraphnet"])}
        check(r["job"][0] == "world" or r["job"][1:2] == ["laplacian-solver"]
              or not real,
              f"dryrun: a kernel launched on fake tensors in {r['job']}: "
              f"{real}")
        if r["job"][0] != "cell":
            continue
        _, arch, shape, multi_pod = r["job"]
        rec = r["rec"]
        bad = _finite_fields(rec)
        check(rec["status"] == "ok" and not bad,
              f"dryrun: {arch}/{shape} record not finite at {bad}")
        check(rec["per_rank"]["coll_bytes"] > 0,
              f"dryrun: {arch}/{shape} made no collective")
        for k, n in r["fake_launches"].items():
            fake[k] = fake.get(k, 0) + n
        m, roof = rec["memory"], rec["roofline"]
        say("dryrun", cell=f"{arch}/{shape}",
            mesh="2x16x16" if multi_pod else "16x16",
            layers=r.get("layers"), comment=rec["comment"],
            args_bytes=m["argument_bytes"], temp_bytes=m["temp_bytes"],
            total_per_device_gib=round(m["total_per_device"] / 2 ** 30, 3),
            flops_per_rank=rec["per_rank"]["flops"],
            hbm_bytes_per_rank=rec["per_rank"]["hbm_bytes"],
            coll_bytes_per_rank=rec["per_rank"]["coll_bytes"],
            coll_bytes=json.dumps(rec["collectives"]["bytes_by_kind"]),
            coll_calls=json.dumps(rec["collectives"]["counts"]),
            kernels=json.dumps(rec["kernels"]),
            bottleneck=roof["bottleneck"],
            roofline_fraction=roof["roofline_fraction"],
            compute_s=roof["compute_s"], memory_s=roof["memory_s"],
            collective_s=roof["collective_s"], trace_s=rec["trace_s"],
            job_s=r["seconds"])
    check(fake.get("embedding_bag", 0) > 0
          and fake.get("embedding_bag_backward", 0) > 0,
          f"dryrun: the bag kernels' shape-only path did not run: {fake}")
    rec = card["rec"]
    pred = rec["memory"]["total_per_device"] / 2 ** 30
    meas = lm_measured["phase_peak_gib"]
    bound_ms = 1e3 * max(rec["roofline"][k] for k in
                         ("compute_s", "memory_s", "collective_s"))
    say("dryrun", check="card_1x1", cell="qwen2-0.5b/train_4k@card",
        predicted_peak_gib=round(pred, 3), measured_peak_gib=round(meas, 3),
        predicted_over_measured=round(pred / meas, 4),
        args_gib=round(rec["memory"]["argument_bytes"] / 2 ** 30, 3),
        temp_gib=round(rec["memory"]["temp_bytes"] / 2 ** 30, 3),
        bound_ms=round(bound_ms, 1), bottleneck=rec["roofline"]["bottleneck"],
        measured_step_ms=round(lm_measured["step_ms"], 1),
        bound_over_step=round(bound_ms / lm_measured["step_ms"], 4),
        flops=rec["per_rank"]["flops"], hbm_bytes=rec["per_rank"]["hbm_bytes"],
        trace_s=rec["trace_s"], job_s=card["seconds"])
    check(not _finite_fields(rec), "dryrun: the 1x1 record is not finite")
    check(bound_ms <= lm_measured["step_ms"],
          f"dryrun: the roofline's bound {bound_ms:.1f} ms is above the "
          f"measured step, {lm_measured['step_ms']:.1f} ms: a wrong roof")
    world = next(r for r in results if r["job"][0] == "world")["stats"]
    keys = ("calls", "bytes", "norms")
    say("dryrun", check="solver_world_of_one", real=json.dumps(world["real"]),
        fake=json.dumps(world["fake"]))
    check(world["real"]["backend"] == ("nccl" if device == "cuda" else "gloo")
          and world["fake"]["backend"] == "fake"
          and all(world["real"][k] == world["fake"][k] for k in keys)
          and world["fake"]["calls"] > 0,
          f"dryrun: the fake world of one counted {world['fake']}, the real "
          f"world of one {world['real']}")
    seconds = time.perf_counter() - t0
    say("dryrun", dryrun_launches=json.dumps(fake),
        seconds=round(seconds, 1))
    check(seconds <= DRYRUN_BUDGET_S,
          f"dryrun: the phase took {seconds:.1f} s, above "
          f"{DRYRUN_BUDGET_S} s")
    return fake



def main() -> int:
    t_start = time.perf_counter()
    # the equiformer phase's step peaks at ≈ 73 GiB of the card's 79.2:
    # expandable segments keep what earlier phases leave live from
    # splitting the free memory (with fixed segments 5.9 GiB of it stayed
    # reserved but unusable there, and a 3.97-GiB request failed)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not here ({exc})", file=sys.stderr)
        return 2
    import numpy as np

    # the coarse solve's dense product in full float32, never TF32; the
    # LM's bfloat16 products accumulate in float32, as XLA's do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = phase_build(torch)
    solver, launches, per_shape, setup = phase_main(torch, np)
    phase_superstep(torch, solver, setup)
    records = phase_kernels(torch, np, solver, launches, per_shape)
    phase_levels(torch, solver, per_shape)
    del solver, per_shape
    facade = phase_facade(torch, np, setup)
    main_graph, main_iters = setup["graph"], setup["iters"]
    del setup
    for rec in records:                 # the facade path's own launches
        rec["facade_launches"] = facade[rec["name"]]
        if rec["name"] in BLOCK_FORMS:  # its throughput block's are theirs
            rec["launches"] = facade[rec["name"]]
    paper = phase_paper(torch, np)
    service = phase_service(torch, np, main_graph, smi)
    spectral = phase_spectral(torch, np, smi)
    # the k-column records at the sweeps' and the spectral mesh's shapes,
    # printed last with their own phase's launches
    block_extra = (paper.pop("records") + service.pop("records")
                   + spectral.pop("records"))
    phase_e2e(torch, np)
    dist = phase_dist(torch, np, main_graph, main_iters)
    del main_graph
    for rec in records:                 # each later phase's own launches
        rec.update(paper_launches=paper[rec["name"]],
                   service_launches=service[rec["name"]],
                   spectral_launches=spectral[rec["name"]],
                   dist_launches=dist[rec["name"]])
    with torch.no_grad():               # serving builds no graph
        model, flat, bag_launches, deepfm_bwd = phase_deepfm(torch, np)
        records.append(dict(phase_kernels_deepfm(torch, model, flat,
                                                 bag_launches),
                            facade_launches=facade["embedding_bag"],
                            paper_launches=paper["embedding_bag"],
                            service_launches=service["embedding_bag"],
                            spectral_launches=spectral["embedding_bag"],
                            dist_launches=dist["embedding_bag"]))
    del model, flat
    train = phase_train(torch, np)
    for rec in phase_kernels_train(torch, train):
        name = rec["name"]
        records.append(dict(rec, facade_launches=facade[name],
                            paper_launches=paper[name],
                            service_launches=service[name],
                            spectral_launches=spectral[name],
                            dist_launches=dist[name],
                            deepfm_launches=deepfm_bwd[name]))
    for rec in records:                 # the train phase's own launches
        rec["train_launches"] = train[rec["name"]]
    del train
    gnn = phase_gnn(torch, np)
    for rec in records:                 # the gnn phase's own launches
        rec["gnn_launches"] = gnn[rec["name"]]
    records += gnn["records"]
    eqf = phase_equiformer(torch, np, gnn.pop("graph"))
    for rec in records:                 # the equiformer phase's own
        rec["equiformer_launches"] = eqf[rec.get("kernel", rec["name"])]
    for rec in eqf["records"]:
        rec["gnn_launches"] = gnn[rec["kernel"]]
    records += eqf["records"]
    del gnn, eqf
    lm, lm_measured = phase_lm(torch, np)
    for rec in records:                 # the lm phase's own (none)
        rec["lm_launches"] = lm[rec.get("kernel", rec["name"])]
    moe = phase_moe(torch, np)
    for rec in records:                 # the moe phase's own (none)
        rec["moe_launches"] = moe[rec.get("kernel", rec["name"])]
    free_card(torch)
    dryrun = phase_dryrun(torch, lm_measured)
    for rec in records:                 # (a)'s shape-only launches
        rec["dryrun_launches"] = dryrun[rec.get("kernel", rec["name"])]
    records += block_extra
    say("total", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
