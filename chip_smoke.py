#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (slate_tpu_torch) on one card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line; any failed phase makes the
script exit non-zero without the final result line:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    compile every CUDA kernel from ops/csrc (nvcc, in
              parallel) and report the seconds and ptxas usage;
  3. kernels  each kernel against its plain PyTorch version on the
              card, at the shapes the main paths give it, in f32 and
              bf16 where the kernel takes both, timed beside the plain
              version, one PyTorch library call computing the same
              function (timed only; the port never calls it) and the
              least time the card could take:
                kernel.compose_swaps  the swap composition, bitwise
                                      (first 2048 swaps over 10240
                                      rows, the process's first
                                      launch at the walk's shared-
                                      memory boundary), then over
                                      16384 rows: LU sequences of 512,
                                      256, 128, 64 and 32 swaps, one
                                      of targets below their steps and
                                      one outside the rows, also
                                      replayed from a CUDA graph, with
                                      a latency floor;
                kernel.lu_panel       the rank-1 panel, bitwise (packed
                                      LU and pivots): adversarial suites
                                      at 256 x 32 and 512 x 256, then
                                      4096, 2048, 1024 and 256 x 256;
                kernel.lu_panel_rec   the recursive panel (both panels
                                      also replayed from a CUDA graph,
                                      graph_ms, and with a latency
                                      bound of one exchange between
                                      SMs a column);
                kernel.rank_update    the trailing update of its split
                                      (and a height off its 128-row
                                      tile), timed replayed from a CUDA
                                      graph and back to back;
                kernel.qr_panel       the Householder panel (f32, bf16):
                                      an adversarial suite, then
                                      8192, 4096, 1024 and 256 x 128,
                                      timed replayed from a CUDA graph
                                      and back to back, with a latency
                                      bound (w exchanges); a bf16
                                      panel is held on what precedes
                                      its first sign tie (a reflector
                                      whose alpha lies within rounding
                                      of 0, where two valid factors
                                      part), the fixed sign-tie panel
                                      (testing.qr_sign_tie_panel, its
                                      own seed) among them;
                kernel.chol_panel     the Cholesky block: adversarial
                                      suite, then n = 1024, 512, 256,
                                      each also with its blocks
                                      launched one at a time;
                kernel.trtri_lower    the triangular inverse, unit and
                                      non-unit: adversarial suite, then
                                      n = 512, 256, 128;
                kernel.ragged_potrf   the ragged batched Cholesky,
                kernel.ragged_getrf   LU (pivots bitwise) and
                kernel.ragged_trsm    triangular solve (all eight
                                      modes): the adversarial suites of
                                      tests/test_ragged.py (garbage
                                      pads), then the serving stream's
                                      first flush (64 elements,
                                      ceiling 608), the plain version
                                      on four of its elements; the
                                      potrf and trsm phases also time
                                      the flush that holds the stream's
                                      order-1024 request (ceiling 1024),
                                      the trsm phase in the four modes
                                      the posv / gesv flushes run,
                                      replayed from a CUDA graph; the
                                      getrf phase adds a suite at
                                      ceiling 384 (a cluster of three
                                      blocks an element), times both
                                      flushes replayed from a CUDA
                                      graph too, with a latency floor,
                                      and also holds the
                                      batched compose_swaps on that
                                      flush's (64, 608) swap targets
                                      bitwise against its plain version;
                kernel.givens_chain   the Givens chain apply, bitwise: an
                                      adversarial suite (identity
                                      rotations, c = 0 / s = +-1, 8
                                      rows), then Z 2048 x 2048 and
                                      512 x 512 (row-major and
                                      transposed), beside Z @ G, both
                                      also replayed from a CUDA graph,
                                      with the chain's latency bound;
                kernel.qr_sweep       the tridiagonal and bidiagonal QR
                                      passes (steqr_sweep, bdsqr_sweep),
                                      bitwise in d, e, the rotations and
                                      the count over 3 passes at
                                      n = 2048 and 512; the multi-pass
                                      steqr_sweeps and bdsqr_sweeps
                                      bitwise against their plain twins
                                      over several launches (a stop at
                                      the cap, one at a count of 0);
                                      replayed from a CUDA graph, with
                                      each sweep's bitwise floor;
              chol_panel and trtri_lower have no driver call site (as
              in the reference): their launches are counted over a run
              of their public entries on the random cases;
  4. gesv     the f32 main path: gesv at n = 16384, 64 right-hand
              sides, tiles and Option.BlockSize of 512, with a tune
              cache routing every LU panel to the recursive kernel; its
              kernels' launch counts must rise during the call, the
              backward error must be <= 1e-6, and X must agree with the
              cold route (library LU panels) to 1e-3;
  5. gesv_mixed.cold  the users' default mixed-precision route, with
              an empty tune cache: gesv_mixed at n = 4096, 64
              right-hand sides, tiles 256, no options (the bf16 factor
              caps the frozen nb 512 to the rank-1 kernel's 256: 16
              pipelined steps, each panel one lu_panel launch), then
              gesv_mixed_gmres with one right-hand side; both must
              converge to a backward error <= 1e-6 and agree with the
              f32 gesv to 1e-5;
  6. gesv_mixed  the mixed-precision main path at the working size:
              the system of phase 4, Option.BlockSize 512, a tune cache
              routing f32 and bf16 panels to the recursive kernel; the
              bf16 recursive panel, trailing update and swap
              composition must launch, the refinement converge to a
              backward error <= 1e-6, and X agree with phase 4's to
              1e-5;
  7. tune.autotune  the tuner from an empty cache: the LU panel route
              probed for f32 and bf16 at the panel-height buckets 512
              ... 16384 (the reference's probe width), getrf / geqrf at
              4096 and heev at 512, each call's results and choice on a
              line of its own; then gesv and gesv_mixed at n = 16384 on
              the probed cache: backward error <= 1e-6, the LU panel
              kernels launched exactly as the persisted routes predict,
              pallas_rec measured wherever its gate takes the probe's
              panel (a cached kernel route its gate rejects takes the
              panel's cold route), gesv's pivots bitwise phase 4's
              where every bucket chose pallas_rec; walls beside phases
              4 and 6's (cold and hand-written cache) and one cold
              gesv_mixed call;
  8. lu.variants  the rest of LU at n = 4096 f32, tiles 256, cold:
              gesv_nopiv on a diagonally dominant matrix,
              getrf_tntpiv + getrs (pivot growth printed), gesv_rbt,
              getri and gecondest, each timed after a warm-up; backward
              error <= 1e-6 (gesv_rbt on the permuted boosted system,
              RBT_PERMUTED_LIMIT; on G + 0.1 n I, 1e-6), ||A A^-1 - I||_F /
              (||A||_F ||A^-1||_F) <= 1e-6, and the condition estimate
              within a factor of 3 of the one from getri;
  9. band     the band solvers at n = 16384, 64 right-hand sides,
              tiles 512, f32 panels routed to the recursive kernel:
              pbsv (kd = 512) on testing.band_spd_system (backward
              error <= 1e-6, X within 1e-5 of posv's, no hand kernel);
              gbsv (kl = ku = 512) on testing.band_general_system, its
              rows permuted within groups of 256 (backward error
              <= 1e-6, X within 1e-3 of gesv's, kappa_1 <= 1e5, a row
              swap in every block step, one lu_panel_rec and two
              compose_swaps launches a step), gbtrs (Op.Trans) and tbsm with
              the band factors (<= 1e-6); gbmm and hbmm against
              torch.matmul (1e-6), each timed beside that product and
              the dense route (gemm / hemm) on the same matrix;
 10. indefinite  Aasen's hesv at n = 16384 on
              testing.indefinite_system: f32 with the recursive panels
              (lu_panel_rec, _rank_update and compose_swaps launched
              exactly as hetrf's and T's gbsv's panels and their splits
              predict, every panel of one more hesv held against the
              plain version, sysv bitwise hesv, T
              banded, L unit lower, the factor residual and backward
              error within 4x of the cold route's: the reference's f32
              accuracy, ROADMAP queue 3), then f64 (factor residual and
              backward error <= 1e-6, X within 1e-5 of gesv's); the
              Parlett-Reid path at n = 1000 (f64 <= 1e-6, f32 printed)
              and info > 0 on a zero matrix;
 11. api      lapack_compat, numpy in and out, at n = 2048 on f64 input:
              solve (gen, pos, sym), cholesky, lu_factor / lu_solve,
              solve_triangular, lstsq, inv (backward error <= 1e-6 on
              the host), eigh and svdvals (EIG_LIMIT of scipy); then
              stacked f32 (64, 256, 256) solve and cholesky under the
              bucket and the ragged strategy (ragged equal to bucket to
              1e-5, the three ragged kernels launched);
 12. posv     f32 posv at n = 16384, 64 right-hand sides, tiles 512, on
              S = G G^T / n + I made on the card from --seed: the Fused
              route (one library Cholesky) and MethodFactor.Tiled (the
              pipelined blocked loop); backward error <= 1e-6 on both,
              X equal between them to 1e-5, no hand kernel launched;
 13. posv_mixed  the same system with a bf16 factor: converged,
              backward error <= 1e-6, X within 1e-5 of phase 12's;
 14. gels     f32 least squares: the square system of phase 4 through
              the QR route (the geqrf carry form, nb 1024, library
              panels, no qr_panel launch): backward error <= 1e-6, X
              within 1e-4 of phase 4's; and a tall Gaussian 65536 x
              2048 with 64 right-hand sides through Auto (CholQR) and
              MethodGels.QR: ||A^T (A X - B)|| / (||A|| ||A X - B||)
              <= 1e-4 on both, their X equal to 1e-4;
 15. gels_bf16  bf16 gels on the permuted boosted system at n = 8192,
              64 right-hand sides, tiles 512: the carry form, nb 512,
              every 128-wide sub-panel through the qr_panel kernel
              (exactly 64 launches); X within GELS_BF16_LIMIT of the
              f32 gels;
 16. batch.serve  the batch layer's serving path, on the reference's
              stream (bench.py --serve: 256 f32 SPD requests
              x x^T / n + 4 I, n lognormal around 180, clipped to
              [64, 1024], seed 0): potrf through
              CoalescingQueue(max_batch=64, max_wait_us=0) under the
              bucket and the ragged strategy (a warm-up pass, then a
              measured one: matrices/s, p50/p99 latency, dispatches,
              padding waste, launches), then posv and gesv (on
              x / sqrt(n) + 2 sqrt(n) I) with one right-hand side on the
              first 64 requests under both, and a bf16 posv leg on the
              ragged route. Backward error <= 1e-6 per request (f32),
              ragged equal to bucket to 1e-5, bf16 within
              BF16_POSV_LIMIT of f32; 8 requests flushed by the
              background flusher thread at its deadline, equal to the
              coalesced results to 1e-5; whether a flush of batch 1
              equals the coalesced flush bitwise is reported, not
              checked;
 17. heev     n = 2048, A = (G + G^T)/2 from --seed made on the card,
              tiles 256: Auto (the library eigensolver) as the reference
              values; MethodEig.QRIteration with ('steqr2', 'chain')
              routed to the chain kernel (he2hb -> hb2st -> steqr2: the
              passes in steqr_sweeps launches of up to 32, one host read
              a launch, one givens_chain_apply launch a pass; passes
              and launches counted apart);
              then he2hb and hb2st once, timed, and on that tridiagonal
              steqr2 cold (dense compose) and stedc. Residual,
              orthogonality and values against Auto within EIG_LIMIT
              (Auto) or STAGED_EIG_LIMIT (the staged routes);
 18. svd      512 x 512 Gaussian, tiles 64: Auto (the library SVD) and
              MethodSVD.QRIteration with ('bdsqr', 'chain') routed to
              the chain kernel (ge2tb -> tb2bd -> bdsqr_qr: the passes
              in bdsqr_sweeps launches of up to 32, one host read a
              launch, two givens_chain_apply launches a pass; passes
              and launches counted apart); reconstruction and values
              within EIG_LIMIT;
 19. spectral_dc  the spectral divide & conquer eigensolver
              (linalg/spectral_dc.py, polar.py; library calls, no hand
              kernel): the library eigensolver at the leaves' orders
              (64, 256, 512 and a stack of 64 x 32), PyTorch's f32 route
              beside blocked.library_eigh, the latter's residual and
              orthogonality within LEAF_EIGH_LIMIT; polar_unitary on an
              f32 Gaussian at n = 4096
              (iterations, converged, max |U^T U - I| <= POLAR_ORTH_LIMIT,
              ms); the two ADVICE diagonals at n = 48, each within 5e-5
              of diag(sign(d)); eigh_dc at n = 8192 (leaf 256) on
              (G + G^T)/2 from --seed: ok, eigenvalues within
              DC_EIG_LIMIT ||H||_2 of eigvalsh in f64 (4 n eps, the
              staged eigensolvers' limit), residual and orthogonality
              within DC_RESID_LIMIT / DC_ORTH_LIMIT, the counts of
              splits, leaves, polar iterations (the root's apart) and
              host reads, its wall beside torch.linalg.eigh f32 on the
              same matrix; check_polar under SLATE_TPU_CHECK_POLAR=1
              with obs on records polar.unconverged False;
 20. obs.resil  obs (bus, metrics), the flight recorder, request traces
              and series on: phase 16's posv and gesv legs (64 requests
              each, one flush each) through CoalescingQueue(ragged)
              twice, clean and then under a FaultPlan injecting one
              transient failure at the "batch" site of the second
              dispatch: the retry counted (guard.counts()), every
              ticket bitwise the clean run's, the ragged kernels'
              launches equal between the runs and to phase 16's legs,
              one ledger record a dispatch, one request span a ticket,
              p50 / p99 in the series, a Perfetto JSON written and read
              back with its flow events, a non-empty report, and
              xprof.analyze's peak memory on a gesv at 4096; then
              everything off, and gesv at n = 16384 (phase 4's route)
              timed with obs off and on, alternately, three each.
              Every other phase must end with guard.counts() empty;
 21. serve    the serving daemon (serve/) over the batch queue:
              (1) phase 16's stream as potrf through
              Server(cache_mb=0) over CoalescingQueue(max_batch=64,
              max_wait_us=0, ragged), bitwise the same queue driven
              directly, in turns with it (matrices/s, p50 / p99
              submit-to-result, the daemon's overhead); (2) bench.py
              --serve-daemon's repeat stream (4 operators, n = 128,
              6 rounds of potrf + posv each, bucket) with cache 0 then
              64 MB: repeat-round dispatches down >= 2x, results bitwise
              where a round's flushes held the same elements in both
              runs, else within SERVE_SPLIT_LIMIT (the chainer forces a
              factor flush as soon as it sees the miss, so round 0's
              flushes may split); (3) 16 operators at full width (the
              stream's first 15 SPD requests and its largest, order
              1024, with their general twins), 8 rounds of posv + gesv
              (1 rhs), ragged, cache 0 then 256 MB: backward error
              <= 1e-6, no ragged_potrf / ragged_getrf launch and some
              ragged_trsm launches in the cache-on repeat rounds,
              cache on against off as in (2); the cache-off run's
              launches go beside each kernel (launches_by_phase);
              (4) drain under one `batch` fault on posv and one
              `serve_drain` fault: every ticket drained, guard.counts()
              exactly {"resil.retries": 2}, then cleared; (5) an
              RpcServer on 127.0.0.1 and an RpcClient: 8 f32 posv and
              1 bf16 posv bitwise the in-process Server, stats and
              metrics; (6) request tracing and series on over (2)'s
              cache-off stream, in turns with them off: bitwise,
              latency quantiles, the admit / queue-wait / dispatch /
              solve split, the overhead;
 22. grid     the in-core distribution (parallel/, dist/, the grid
              routes). Leg A: a world of one rank under NCCL (a file://
              rendezvous), make_grid(1, 1): gesv and posv at n = 16384
              on phases gesv's and posv's systems (tiles 512; gesv's
              panels on lu_panel_rec by phase gesv's tune cache):
              backward error <= 1e-6, the difference from the one-device
              X and the wall beside the one-device wall, lu_panel_rec
              and compose_swaps launched, collectives counted; a bf16
              grid getrf at 4096 (16 lu_panel launches, factor residual
              within 2x of the one-device bf16 getrf's); summa_gemm at
              16384 within 1e-6 of torch.matmul; steqr2_qr_dist at
              2048 on a seeded tridiagonal with the chain routed to its
              kernel (bitwise the one-device steqr2_qr, steqr_sweeps and
              givens_chain_apply launched, no collective) and
              stedc_solve_dist (within 1e-6 of stedc_solve); gels_tsqr
              65536 x 512 within 2x of the one-device gels'
              orthogonality (or 1e-4). Leg B: four ranks on the card
              under gloo (testing.multiproc.launch, suite "chip" of
              testing.grid_checks) on a 2 x 2 grid, posv, gesv and
              SUMMA at 4096: every rank bitwise rank 0, within 1e-5 of
              the same run on the one-rank grid, each rank's counted
              trailing-update FLOPs below half the solo run's; a lost
              or hung rank fails the phase (WorkerLost, the launch
              timeout);
 23. ooc      the out-of-core stream (linalg/stream.py, ooc.py, sched/;
              host-resident numpy matrices made on the card from
              --seed): the engine's transfer pieces on one 1 GiB panel
              (the host gather into pinned memory, also from never-
              touched pages, each DMA, a staged upload and writeback);
              posv_ooc f32 at n = 32768 (4 panels of 8192,
              64 rhs, S = G G^T / 2048 + I) at budget 0 and at 3 panels
              (mru, evicting): factors bitwise, backward error <= 1e-6,
              the transfer counters, walls beside the in-core posv;
              gesv_ooc at 32768 with its panels on the recursive kernel
              (incore_nb 512, a tune cache routing pallas_rec up to
              32768 rows; lu_panel_rec launched exactly as predicted
              from the panel shapes, _rank_update and compose_swaps
              launched; getrf_ooc once more with every panel held
              against the plain version by held_panel, pivots equal to
              the timed run's) and at the default incore_nb (library
              panels, pivots equal to the kernel route's), beside the
              in-core gesv; getrf_tntpiv_ooc + getrs_ooc at
              a budget of 2 panels (no invalidation); gels_ooc 32768 x
              16384 (panels of 4096) against the in-core gels (1e-4)
              and gemm_ooc against torch.matmul (1e-5); posv_ooc and
              gesv_ooc under bf16 residency at 32768, refined to 1e-6,
              every revisit and sweep byte staged in bf16 (the H2D bytes
              equal to the count predicted from the shapes); at 16384
              (panels of 2048): the graph scheduler bitwise the walk
              with the watchdog on (nt + 1 heartbeats a call), the
              fused visits, crash and resume at panel 3 with a
              checkpoint a panel, one h2d and one d2h fault retried
              bitwise; tune.autotune(ops=("ooc",)) at 32768 over
              widths 4096 and 8192 (8192, the default, is the baseline;
              a persisted winner is another width). Each part ends
              with guard.counts() empty (the crash runs' checkpoint
              commits counted and cleared, the planned transfer
              faults' two retries counted and cleared);
 24. shard_ooc  the sharded out-of-core stream and the elastic mesh
              (dist/shard_ooc.py, dist/elastic.py). Leg A: a world of one
              NCCL rank, make_grid(1, 1), at phase ooc's sizes:
              shard_potrf_ooc at 32768 (panels of 8192) at budget 0 and
              3 panels, shard_getrf_ooc at 32768 (2 panels), and
              shard_geqrf_ooc at 32768 x 16384 (panels of 4096), each
              bitwise its single-engine twin (potrf_ooc,
              getrf_tntpiv_ooc with its pivots, geqrf_ooc with its taus)
              run on the same matrix, walls side by side; at 16384
              (panels of 2048, the size of phase ooc's scheduler runs)
              shard_potrf_ooc bitwise potrf_ooc, lookahead 1, the graph
              route and the fused visits bitwise it, bf16 frames of
              exactly half its broadcast bytes, posv_ooc(grid=...)
              routed Sharded to phase ooc's backward-error limit, and
              the three drivers at leg B's budget for leg B. Leg B: four
              gloo ranks on the card (testing.shard_checks suite
              "chip", 2 x 2, a budget of 2 panels a rank): potrf, getrf
              and geqrf, every rank's factor bitwise rank 0's and leg
              A's at 16384, each rank's ooc.h2d_bytes its schedule's
              staged_bytes, the ranks' panels disjoint with their union
              all panels, the tree's rounds counted, lookahead 1 with
              its overlap fraction, the elastic route with rank 3
              slowed (at least one remap, bitwise); then shrink to fit:
              a kill rule ends rank 3 at panel 3 (WorkerLost), and the
              three survivors resume from the per-rank checkpoints,
              bitwise. guard.counts() stays empty but for the planned
              shrink's rung, counted and cleared;
 25. harness  the sweep tester (testing/tester.py, run_tests.py), the
              tune cache routing the f32 LU as phase gesv: gemm, potrf,
              posv, getrf, gesv, geqrf and gels at n = 16384, f32, nb
              512, --check y (the error ratios on the card): every row
              pass, with its time and GFLOP/s; the launches of
              lu_panel_rec, _rank_update and compose_swaps under the
              tester's gesv equal to a direct st.gesv's on the same
              matrix; the seven at 2048 with --ref y (numpy / scipy on
              the host); run_tests --quick (all groups), its junit
              written and read back;
 26. c_api    the C API: the library built, a C program (C_PROGRAM)
              compiled against the port's header and run with
              slate_tpu_init("cuda"): posv, gesv and gemm at 8192 and
              gels at 16384 x 2048 in s and d, residuals computed in C
              (f64 solves: the reference C test's bound scaled by n;
              f32: backward error <= 1e-6; gels: the tester's ratio;
              gemm: 64 entries within the rounding bound), two non-SPD
              posv reporting their exact failing minor, heev and
              svd_vals at 1024 against numpy; then the same calls'
              walls through the bridge in this process;
 27. nonuniform  TiledMatrix.from_func tiles 4 x 2048 + 8 x 1024 at
              n = 16384: gemm, potrf, getrf and gesv on the non-uniform
              matrices beside the same calls on uniform() (in turns,
              two walls each): residuals
              <= 1e-6, pivots, factors and X bitwise the uniform
              route's, the LU kernels launched;
 28. examples  examples/torch/run_all.py --device cuda (the 17 twins);
 29. profile  gesv on both routes, gesv_mixed, gesv_mixed cold at
              n = 4096, posv on both routes, gbsv and the f32 hesv, the
              square gels, the bf16 gels, one ragged posv flush of 64,
              posv_ooc at 16384 (panels of 2048), the heev and
              svd QR iterations, once more under torch.profiler: host
              wall, device busy time (the union of the kernel, copy and
              memset intervals of the trace), idle share, the heaviest
              kernels by device time and the shares of the trailing
              update (rank_update's kernels), of the LU base case, of
              the rank-1 panel's trailing-column updates, of qr_panel,
              of ragged_trsm, of compose_swaps and of the tridiagonal
              and bidiagonal sweeps, and the LU base case's mean bound a
              segment;
 30. the {"phase_walls": {...}} line (each phase's wall, also its
     line's "wall_s", and the script's), the {"kernels": [...]}
     summary, then the card's nvidia-smi line, then {"ok": true,
     "device": {...}}.

Bounds: the larger of bytes over the memory rate and operations over
the peak rate of their type: a panel's per-column recurrence at the
f32 CUDA-core rate, products of bf16 inputs at the bf16 tensor-core
rate. Needs a CUDA card: without one it exits 2 and prints no result.
"""

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import importlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import slate_tpu_torch as st
from slate_tpu_torch import batch
from slate_tpu_torch.ops import _build
from slate_tpu_torch.ops import kernels as pk
from slate_tpu_torch.linalg import eig as teig
from slate_tpu_torch.linalg import qr as tqr
from slate_tpu_torch.resil import guard
from slate_tpu_torch.testing import (EXACT_KINDS, band_general_system,
                                     band_spd_system, bf16_ulps, chol_cases,
                                     indefinite_system, panel_cases,
                                     permuted_boosted_system,
                                     qr_before_tie, qr_panel_cases,
                                     qr_sign_tie, qr_sign_tie_panel,
                                     ragged_cases,
                                     ragged_getrf_wide_case, serve_stream,
                                     spd_system, trtri_cases)
from slate_tpu_torch.core.methods import MethodLUPanel
from slate_tpu_torch.tune import autotune
from slate_tpu_torch.tune import cache as tcache
from slate_tpu_torch.tune import select as tselect
from slate_tpu_torch.tune import stats as tstats

# the package re-exports the svd function under the module's name
tsvd = importlib.import_module("slate_tpu_torch.linalg.svd")

#: published H100 SXM peaks (NVIDIA data sheet): f32 outside the
#: tensor cores, bf16 on the tensor cores (dense), and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
#: latency floors of the dependent recurrences (the "latency_bound_ms"
#: beside the contract's bound): the card's boost clock (H100 SXM,
#: nvidia-smi clocks.max.sm); a dependent f32 multiply or add, 4 cycles;
#: an exchange between SMs, one round trip through L2 that finds its
#: data ready (~1.1k cycles by clock64 marks on an H100)
SM_HZ = 1.98e9
DEP_OP_CYCLES = 4
EXCHANGE_CYCLES = 1100

N, NRHS, NB = 16384, 64, 512
N_COLD, NB_COLD = 4096, 256
#: the bf16 gels path: the largest square whose every 128-wide
#: sub-panel passes qr_panel's 8192-row gate
N_QR_BF16 = 8192
M_TALL, N_TALL = 65536, 2048
#: bf16 gels X against the f32 gels, relative (Frobenius): twice what
#: the JAX package's own bf16 gels gives against its f32 gels on this
#: system on the CPU (0.0248 at n = 512, 0.0217 at n = 1024)
GELS_BF16_LIMIT = 0.05
#: path name of the kernels the reference calls from no driver
PUBLIC_ENTRY = "public entry (no driver call site in the reference)"

SRC = "slate_tpu_torch/ops/csrc/"
REPO = os.path.dirname(os.path.abspath(__file__))
PK = "slate_tpu/ops/pallas_kernels.py:"
DTYPES = (("float32", torch.float32), ("bfloat16", torch.bfloat16))


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound_ms(flops, nbytes, peak=PEAK_F32_FLOPS):
    """Least time for the work: the larger of operations over `peak`
    and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def latency_ms(steps, cycles):
    """Least time of `steps` dependent steps of `cycles` each."""
    return steps * cycles / SM_HZ * 1e3


def try_graph_ms(fn, reps=20):
    """graph_ms, or the reason the calls could not be captured."""
    try:
        return graph_ms(fn, reps), None
    except Exception as e:                   # report, do not fail
        torch.cuda.synchronize()
        return None, "%s: %s" % (type(e).__name__, str(e)[:200])


def cuda_ms(fn, reps):
    """Mean ms per call over `reps` calls after one warm-up, by CUDA
    events around the whole run."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps=20):
    """Mean device ms per call of `reps` calls captured into one CUDA
    graph and replayed once (warmed up first): the card's time without
    the host's launch overhead, which a kernel of a few microseconds
    called from Python would otherwise measure instead."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def wall_s(fn):
    """Host seconds of one call, ended by a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def lu_residual(a, packed, piv):
    """||P A - L U||_F / ||A||_F of a packed (m, w) panel, in f64."""
    m, w = a.shape
    perm = pk.compose_swaps_plain(piv, m)
    p64 = packed.double()
    L = torch.tril(p64, -1)
    L[:w].diagonal().fill_(1)
    U = torch.triu(p64[:w])
    return float(torch.linalg.norm(a.double()[perm] - L @ U)
                 / torch.linalg.norm(a.double()))


def values_ok(kind, dtype, kp, pp):
    """The adversarial suite's value check: the zero-noise kinds are
    exact in every operation, so bitwise; the others agree to rounding
    of differently ordered sums: 1e-4 in f32, 2 bf16 ulps in bf16."""
    err = float((kp.double() - pp.double()).abs().max())
    if kind in EXACT_KINDS:
        return err == 0.0, err
    if dtype == torch.bfloat16:
        return bf16_ulps(kp.float().cpu().numpy(),
                         pp.float().cpu().numpy()) <= 2.0, err
    return err <= 1e-4, err


def panel_flops(m, w):
    return m * w * w - w ** 3 / 3.0


def berr(A, X, B):
    """||A X - B||_F / (||A||_F ||X||_F) in f64."""
    a64, x64 = A.data.double(), X.data.double()
    r = float(torch.linalg.norm(a64 @ x64 - B.data.double())
              / (torch.linalg.norm(a64) * torch.linalg.norm(x64)))
    return r


def rel_diff(x, ref):
    return float(torch.linalg.norm((x - ref).double())
                 / torch.linalg.norm(ref.double()))


_TUNE_DIRS = []


def fresh_tune_cache(routes=(), top=None):
    """Point the port's tune cache at a new empty directory and put
    method_lu_panel = "pallas_rec" into it for each dtype in `routes`,
    panel-height buckets 512 ... `top` (default N; the out-of-core LU
    reaches N_OOC_LU rows)."""
    d = tempfile.TemporaryDirectory(prefix="slate_tpu_torch_tune_")
    _TUNE_DIRS.append(d)
    os.environ["SLATE_TPU_TORCH_TUNE_CACHE"] = d.name
    os.environ.pop("SLATE_TPU_TORCH_TUNE", None)
    tcache.reset_cache()
    cache = tcache.get_cache()
    for dtype in routes:
        n = 512
        while n <= (top or N):
            cache.put("lu_panel", dtype, n, {"method_lu_panel": "pallas_rec"})
            n *= 2
    cache.save()


def entry(name, dtype, source, replaces, path, s, worst):
    """One row of the {"kernels": [...]} line from a shape's numbers."""
    return {"name": name, "dtype": dtype, "route": "cuda",
            "source": SRC + source, "replaces": replaces, "path": path,
            "shape": s["shape"], "launches": None, "max_abs_err": worst,
            "ms": s["ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"],
            **{k: s[k] for k in ("graph_ms", "library_graph_ms",
                                 "latency_bound_ms", "bitwise_floor_ms")
               if s.get(k) is not None}}


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    return {"phase": "device", "ok": True,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build():
    secs = _build.build_all()
    for name in _build.LIBS:
        _build.load(name)
    return {"phase": "build", "ok": True, "seconds": secs,
            "libs": {k: v for k, v in _build.build_log.items()}}


#: the LU panels' swap compositions over N rows: gesv's 512-wide
#: panels, then the recursive panel's split sizes
SWAP_WIDTHS = (512, 256, 128, 64, 32)


def compose_latency_ms(w):
    """The swap composition's latency floor: the swaps read back through
    L2 (one round trip, EXCHANGE_CYCLES) and ceil(log2 w) dependent
    combining steps (a link of the forest each) before the write."""
    return latency_ms(1, EXCHANGE_CYCLES) + latency_ms(
        int(np.ceil(np.log2(max(w, 2)))), DEP_OP_CYCLES)


def lu_swaps(rng, m, w):
    """An LU swap sequence: piv[j] uniform in [j, m)."""
    return np.array([j + rng.integers(0, m - j) for j in range(w)],
                    np.int32)


def compose_row(piv, m, plain_reps=5):
    """One compose_swaps shape: bitwise against the plain version, its
    times back to back and replayed from a CUDA graph, the plain
    version's, the bound (the swaps read, the permutation written) and
    the latency floor."""
    perm = pk.lu_pivots_to_permutation(piv, m)
    ref = pk.compose_swaps_plain(piv, m)
    torch.cuda.synchronize()
    B = piv.shape[0] if piv.dim() == 2 else 1
    w = piv.shape[-1]
    run = functools.partial(pk.lu_pivots_to_permutation, piv, m)
    b_ms, b_by = bound_ms(0.0, B * (4.0 * w + 8.0 * m))
    return {"shape": ("%d x " % B if piv.dim() == 2 else "")
            + "%d swaps over %d" % (w, m),
            "bitwise": bool(torch.equal(perm, ref)),
            "ms": cuda_ms(run, 50), "graph_ms": graph_ms(run, 50),
            "plain_ms": cuda_ms(lambda: pk.compose_swaps_plain(piv, m),
                                plain_reps),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "latency_bound_ms": compose_latency_ms(w)}


def phase_compose_swaps(rng, seed, results):
    """The swap composition over m = 16384 rows, bitwise against the
    plain version (first, as the process's first launch, 2048 swaps over
    10240 rows, the shared-memory boundary of its walk): LU sequences of
    gesv's 512 swaps and of the recursive
    panel's split sizes (the kernel's sorted path), then 512 targets
    below their steps (not an LU sequence) and 512 outside [0, m) (its
    in-order walk, XLA's semantics). No PyTorch call composes swaps
    into a permutation vector (torch.lu_unpack builds the m x m
    matrix), so library_ms is null. The kernel phases after this one
    draw their panels from `rng` too: it gives the 512 swaps' draws, as
    it did when that was the phase's only case, and the other cases
    come from a generator of their own (from `seed`)."""
    m = N
    out = {"phase": "kernel.compose_swaps", "ok": True}
    # the process's first launch at m + w = 12288: 48 KiB of dynamic
    # shared memory, which with the kernel's static flags needs the
    # opt-in (the sharded stream's tournament met it on a fresh rank)
    s = compose_row(torch.as_tensor(lu_swaps(
        np.random.default_rng(seed + 2), 10240, 2048), device="cuda"),
        10240)
    out["first_launch.2048_over_10240"] = s
    out["ok"] &= s["bitwise"]
    own = np.random.default_rng(seed + 1)
    cases = [("lu.512", lu_swaps(rng, m, 512))]
    cases += [("lu.%d" % w, lu_swaps(own, m, w)) for w in SWAP_WIDTHS[1:]]
    cases += [("any.512", own.integers(0, m, 512).astype(np.int32)),
              ("out_of_range.512",
               own.integers(-2 * m, 2 * m, 512).astype(np.int32))]
    for label, p in cases:
        s = compose_row(torch.as_tensor(p, device="cuda"), m)
        out[label] = s
        out["ok"] &= s["bitwise"]
    s = out["lu.512"]
    results["compose_swaps"] = entry(
        "compose_swaps", "int32", "compose_swaps.cu",
        "slate_tpu/linalg/lu.py:63 (XLA lu_pivots_to_permutation)",
        "gesv_mixed", s, 0.0 if s["bitwise"] else None)
    return out


def adversarial(dtype, run, plain, shape=(256, 32, 8), bitwise=False):
    """The adversarial suite (m, w, ib = `shape`; 256, 32, 8 unless
    given) through `run` and `plain`: pivots bitwise, values by
    values_ok, or bitwise throughout with `bitwise`."""
    ok, worst, kinds = True, 0.0, {}
    for kind, a_np in panel_cases(np.random.default_rng(42),
                                  *shape).items():
        a = torch.as_tensor(a_np, device="cuda").to(dtype)
        kp, kpiv = run(a)
        pp, ppiv = plain(a)
        torch.cuda.synchronize()
        piv_eq = torch.equal(kpiv, ppiv)
        if bitwise:
            err = float((kp.double() - pp.double()).abs().max())
            val_ok = bool(torch.equal(kp, pp))
        else:
            val_ok, err = values_ok(kind, dtype, kp, pp)
        ok &= piv_eq and val_ok
        worst = max(worst, err)
        kinds[kind] = {"pivots_bitwise": piv_eq, "max_abs_err": err,
                       "values_ok": val_ok}
    return ok, worst, kinds


def time_panel(rng, dtype, m, w, run, plain, reps, peak, latency=None,
               held=False):
    """A random (m, w) panel: residual of the kernel's factors, pivots
    against the plain version, and times. `latency`: the latency floor
    (one exchange between SMs a column unless given). `held`: also the
    held_panel row of the kernel's factors against the plain's."""
    a = torch.as_tensor(rng.standard_normal((m, w), dtype=np.float32),
                        device="cuda").to(dtype)
    kp, kpiv = run(a)
    pp, ppiv = plain(a)
    res = lu_residual(a, kp, kpiv)
    piv_eq = torch.equal(kpiv, ppiv)
    err = float((kp.double() - pp.double()).abs().max()) if piv_eq \
        else None
    row = held_panel(a, kp, kpiv, pp, ppiv) if held else None
    ms = cuda_ms(lambda: run(a), reps)
    g_ms, g_err = try_graph_ms(lambda: run(a), reps)
    plain_ms = cuda_ms(lambda: plain(a), 1)
    a32 = a.float()
    lib_ms = cuda_ms(lambda: torch.linalg.lu_factor_ex(a32), reps)
    b_ms, b_by = bound_ms(panel_flops(m, w), 2.0 * a.element_size() * m * w,
                          peak)
    return {"shape": "%dx%d" % (m, w), "residual": res,
            "graph_ms": g_ms, "graph_error": g_err,
            "latency_bound_ms": latency_ms(w, EXCHANGE_CYCLES)
                                if latency is None else latency,
            "residual_plain": lu_residual(a, pp, ppiv),
            "pivots_equal_plain": piv_eq, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "torch.linalg.lu_factor_ex"
                       + (" (f32 upcast)" if dtype != torch.float32 else ""),
            "bound_ms": b_ms, "bound_by": b_by,
            **({"held": row} if held else {})}


#: residual limits of a random Gaussian panel. f32: rounding. bf16:
#: every update is rounded to bf16 (u = 2^-8), and the error grows with
#: the number of updates a value takes; the JAX reference's own bf16
#: factors of such panels (its kernels through the Pallas interpreter on
#: the CPU) have residuals of 0.05 (rank-1, 256 and 512 x 256) and 0.03
#: (recursive, 256 and 512 x 256)
RES_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 0.1}


#: heights of the rank-1 panels timed: the cold mixed path's panels run
#: 4096, 3840, ..., 256 rows of 256 columns
LU_PANEL_HEIGHTS = (N_COLD, 2048, 1024, 256)


def lu_panel_latency_ms(m, w):
    """The rank-1 panel's latency floor, a segment of 32 columns at a
    time (csrc/lu_panel.cu): a column of a segment whose base case runs
    over the grid takes one exchange between SMs; one of a segment that
    runs in one block (the kernel's library says which) stays inside
    the SM, the in-SM floor of ragged_lu_latency_ms over the segment's
    rows."""
    lib = _build.load("lu_panel")
    total = 0.0
    for c0 in range(0, min(m, w), 32):
        cols = min(32, w - c0, m - c0)
        if lib.lu_panel_block_takes(m, w, c0):
            total += ragged_lu_latency_ms(m - c0, cols)
        else:
            total += latency_ms(cols, EXCHANGE_CYCLES)
    return total


def phase_lu_panel(rng, results):
    """lu_panel, f32 and bf16, held BITWISE to lu_panel_plain (packed LU
    and pivots): the adversarial suite at 256 x 32 (one segment of the
    kernel) and at 512 x 256 with the spikes at the 32-column segment
    edges, then random panels of 256 columns at LU_PANEL_HEIGHTS (the
    cold mixed path's first panel and three of its later ones)."""
    ok, out = True, {"phase": "kernel.lu_panel"}
    for dname, dtype in DTYPES:
        kinds = {}
        worst = 0.0
        for shape in ((256, 32, 8), (512, 256, 32)):
            a_ok, err, k = adversarial(dtype, pk.lu_panel, pk.lu_panel_plain,
                                       shape, bitwise=True)
            ok &= a_ok
            worst = max(worst, err)
            kinds["%dx%d" % shape[:2]] = k
        shapes = {}
        for m in LU_PANEL_HEIGHTS:
            s = time_panel(rng, dtype, m, 256, pk.lu_panel,
                           pk.lu_panel_plain, 5, PEAK_F32_FLOPS,
                           lu_panel_latency_ms(m, 256))
            s["bitwise_plain"] = s["max_abs_err"] == 0.0
            ok &= s["residual"] <= RES_LIMIT[dtype] and s["bitwise_plain"]
            shapes[s["shape"]] = s
            if s["max_abs_err"] is not None:
                worst = max(worst, s["max_abs_err"])
        out[dname] = {"adversarial": kinds, "shapes": shapes}
        if dtype == torch.bfloat16:
            results["lu_panel.bfloat16"] = entry(
                "lu_panel", dname, "lu_panel.cu", PK + "249",
                "gesv_mixed.cold", shapes["%dx256" % N_COLD], worst)
    out["ok"] = bool(ok)
    return out


def phase_panel_rec(rng, results):
    """lu_panel_rec: the adversarial suite (m=256, w=32, ib=8), then
    random panels at the main paths' shapes: one dispatch (f32
    16384x128, bf16 16384x64) and the tall split (16384x512); in f32
    also the out-of-core LU's tallest panel (N_OOC_LU x 512, split into
    dispatches of N_OOC_LU x 64), held against the plain version by
    held_panel (pivots equal or parted at a tie, |L| <= 1)."""
    ok, out = True, {"phase": "kernel.lu_panel_rec"}
    for dname, dtype in DTYPES:
        a_ok, worst, kinds = adversarial(
            dtype, lambda a: pk.lu_panel_rec(a, ib=8),
            lambda a: pk.lu_panel_rec_plain(a, ib=8))
        ok &= a_ok
        one = 128 if dtype == torch.float32 else 64
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        shapes = {}
        f32 = dtype == torch.float32
        for m, w in ((N, one), (N, 512)) + (((N_OOC_LU, 512),) if f32
                                            else ()):
            s = time_panel(rng, dtype, m, w, pk.lu_panel_rec,
                           pk.lu_panel_rec_plain, 5 if w == one else 3, peak,
                           held=m == N_OOC_LU)
            s["split"] = m * w > pk._rec_max_elems(dtype, None)
            ok &= s["residual"] <= RES_LIMIT[dtype]
            if "held" in s:
                ok &= s["held"]["ok"]
            shapes[s["shape"]] = s
            if s["max_abs_err"] is not None:
                worst = max(worst, s["max_abs_err"])
        out[dname] = {"adversarial": kinds, "shapes": shapes}
        results["lu_panel_rec." + dname] = entry(
            "lu_panel_rec", dname, "lu_panel_rec.cu", PK + "454",
            "gesv" if dtype == torch.float32 else "gesv_mixed",
            shapes["%dx%d" % (N, one)], worst)
    out["ok"] = bool(ok)
    return out


def phase_rank_update(rng, results):
    """_rank_update at the shapes the split of a 16384x512 panel gives
    it: f32 (two) and bf16 (three), and a height that is not a multiple
    of the kernels' 128-row tile (the masked edge). Times: `ms`,
    `plain_ms`, `library_ms` with the host's launch overhead removed
    (graph_ms); `eager_ms`, `eager_library_ms` as a Python caller sees
    them back to back."""
    ok, out = True, {"phase": "kernel.rank_update"}
    for dname, dtype in DTYPES:
        dims = [(N - 256, 256, 256), (N - 128, 128, 128)]
        if dtype == torch.bfloat16:
            dims.append((N - 64, 64, 64))
        dims.append((N - 256 - 37, 256, 256))
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        # sums of w1 products in another order than the plain version's:
        # 1e-4 relative is far above f32 rounding (~1e-6); in bf16 the
        # rounded product may differ by an ulp in a few entries, 2^-7
        # normwise
        lim = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        worst, shapes = 0.0, {}
        for m2, w1, w2 in dims:
            a22, l21, u12 = (torch.as_tensor(
                rng.standard_normal(sh, dtype=np.float32),
                device="cuda").to(dtype)
                for sh in ((m2, w2), (m2, w1), (w1, w2)))
            o = pk._rank_update(a22, l21, u12)
            ref = pk.rank_update_plain(a22, l21, u12)
            rel = rel_diff(o, ref)
            err = float((o.double() - ref.double()).abs().max())
            worst = max(worst, err)
            ok &= rel <= lim and bool(torch.isfinite(o).all())
            b_ms, b_by = bound_ms(2.0 * m2 * w1 * w2,
                                  a22.element_size()
                                  * (2 * m2 * w2 + m2 * w1 + w1 * w2), peak)
            key = "%dx%dx%d" % (m2, w1, w2)
            shapes[key] = {
                "shape": key, "rel_err": rel, "max_abs_err": err,
                "ms": graph_ms(lambda: pk._rank_update(a22, l21, u12)),
                "eager_ms": cuda_ms(lambda: pk._rank_update(a22, l21, u12),
                                    20),
                "plain_ms": graph_ms(
                    lambda: pk.rank_update_plain(a22, l21, u12)),
                "library_ms": graph_ms(
                    lambda: torch.addmm(a22, l21, u12, alpha=-1)),
                "eager_library_ms": cuda_ms(
                    lambda: torch.addmm(a22, l21, u12, alpha=-1), 20),
                "library": "torch.addmm", "bound_ms": b_ms,
                "bound_by": b_by}
        out[dname] = shapes
        results["rank_update." + dname] = entry(
            "rank_update", dname, "rank_update.cu", PK + "594",
            "gesv" if dtype == torch.float32 else "gesv_mixed",
            shapes["%dx%dx%d" % dims[0]], worst)
    out["ok"] = bool(ok)
    return out


def scaled_err(kp, pp):
    """max |kernel - plain| over the plain version's largest |value|
    (the adversarial suites sit at scales 2^-40 ... 2^40)."""
    d = float((kp.double() - pp.double()).abs().max())
    return d / max(float(pp.double().abs().max()), 1e-300)


def qr_values_ok(kind, dtype, kp, kt, pp, pt):
    """A qr_panel kernel result against its plain version: f32 to 1e-5
    of the scale (norms and v^T A sums taken in another order), bf16
    normwise to 2^-8 (a rounding that flips differently feeds every
    later column), taus (in [0, 2]) to 1e-6 / 2^-7. "equal": after the
    first column the rest is rounding noise with arbitrary reflectors,
    so only R and the first tau count. A bf16 "random" panel is held on
    what the steps before its first sign tie write (testing.qr_sign_tie:
    from a column whose alpha lies within rounding of zero the two take
    opposite reflectors, both valid, and part); the residual holds the
    whole factor. Returns (ok, err, tau_err, tie column or None)."""
    w = kp.shape[1]
    t = None
    if kind == "equal":
        kp, pp, kt, pt = kp.triu(), pp.triu(), kt[:1], pt[:1]
    if dtype == torch.bfloat16:
        kn, pn = kp.double().cpu().numpy(), pp.double().cpu().numpy()
        if kind == "random":
            t = qr_sign_tie(kn, kt.cpu().numpy(), pn, pt.cpu().numpy())
            kn, pn = qr_before_tie(kn, t), qr_before_tie(pn, t)
            kt, pt = kt[:t], pt[:t]
            t = t if t < min(kp.shape) else None
        err = float(np.linalg.norm(kn - pn) / np.linalg.norm(pn))
        ok = err <= 2.0 ** -8
    else:
        err = scaled_err(kp, pp)
        ok = err <= 1e-5
    terr = float((kt.double() - pt.double()).abs().max()) if len(kt) \
        else 0.0
    return ok and terr <= (2.0 ** -7 if dtype == torch.bfloat16 else 1e-6), \
        err, terr, t


def qr_residual(a, packed, taus):
    """||A - Q R||_F / ||A||_F of a packed (m, w) Householder panel in
    f64: R's rows with the reflectors applied in reverse."""
    m, w = a.shape
    p = packed.double()
    x = torch.zeros((m, w), dtype=torch.float64, device=a.device)
    x[:w] = torch.triu(p[:w])
    V = torch.tril(p, -1)
    V[:w].diagonal().fill_(1)
    t = taus.double()
    for j in reversed(range(w)):
        x -= t[j] * torch.outer(V[:, j], V[:, j] @ x)
    return float(torch.linalg.norm(a.double() - x)
                 / torch.linalg.norm(a.double()))


#: residual limits of a random Gaussian QR panel: f32 rounding; bf16:
#: every stored value is rounded to bf16 (u = 2^-8)
QR_RES_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 0.05}
#: the qr_panel phase's random panels, all 128 wide: the bf16 gels
#: path's first sub-panel (8192 rows), 4096, and two of its last
#: sub-panels' heights (the path runs 8192, 8064, ..., 128)
QR_SHAPES = (N_QR_BF16, 4096, 1024, 256)
#: heights from which a bf16 panel is held to qr_values_ok; below, to
#: the residual only (its numbers reported): in a panel of m < 8 w rows
#: the last columns hold few rows, whose reflectors follow each sum's
#: rounding, and two valid factors part. At 256 x 128 the plain version
#: differs from the reference's interpreted kernel by 0.0041 normwise
#: (2^-8 = 0.0039), at 128 x 128 by 0.009, with no kernel involved
#: (tests/test_torch_kernels.py test_qr_panel_gels_subpanels_match_jax);
#: on the card the first kernel (PR 3's) differed from the plain version
#: there by 0.0061, as the new one does
QR_BF16_VALUES_MIN_M = 8 * 128


def qr_bounds(m, w, elsize):
    """The Householder panel's bounds: operations or bytes (the panel
    read and written once, the taus), and the latency of w exchanges
    between SMs, one a column (the norm and v^T A share it:
    csrc/qr_panel.cu)."""
    b_ms, b_by = bound_ms(2.0 * m * w * w - 2.0 * w ** 3 / 3.0,
                          2.0 * elsize * m * w + 4.0 * w)
    return {"bound_ms": b_ms, "bound_by": b_by,
            "latency_bound_ms": latency_ms(w, EXCHANGE_CYCLES)}


def phase_qr_panel(rng, results):
    """qr_panel, f32 and bf16: the adversarial suite (m = 256, w = 32),
    then random 8192, 4096, 1024 and 256 x 128 panels: kernel against
    plain, the factors' residual, times back to back and replayed from
    a CUDA graph, beside torch.geqrf."""
    ok, out = True, {"phase": "kernel.qr_panel"}
    for dname, dtype in DTYPES:
        kinds, worst = {}, 0.0
        for kind, a_np in qr_panel_cases(np.random.default_rng(21), 256,
                                         32).items():
            a = torch.as_tensor(a_np, device="cuda").to(dtype)
            kp, kt = pk._qr_panel_launch(a)
            pp, pt = pk.qr_panel_plain(a)
            torch.cuda.synchronize()
            v_ok, err, terr, _ = qr_values_ok(kind, dtype, kp, kt, pp, pt)
            ok &= v_ok
            kinds[kind] = {"err": err, "tau_err": terr, "ok": v_ok}
        shapes = {}
        for m in QR_SHAPES:
            w = 128
            a = torch.as_tensor(rng.standard_normal((m, w),
                                                    dtype=np.float32),
                                device="cuda").to(dtype)
            kp, kt = pk._qr_panel_launch(a)
            pp, pt = pk.qr_panel_plain(a)
            v_ok, err, terr, tie = qr_values_ok("random", dtype, kp, kt,
                                                pp, pt)
            res = qr_residual(a, kp, kt)
            held = dtype == torch.float32 or m >= QR_BF16_VALUES_MIN_M
            ok &= (v_ok or not held) and res <= QR_RES_LIMIT[dtype]
            if held:
                worst = max(worst, float((kp.double() - pp.double()).abs()
                                         .max()))
            ms = cuda_ms(lambda: pk._qr_panel_launch(a), 5)
            g_ms, g_err = try_graph_ms(lambda: pk._qr_panel_launch(a), 10)
            plain_ms = cuda_ms(lambda: pk.qr_panel_plain(a), 1)
            a32 = a.float()
            lib_ms = cuda_ms(lambda: torch.geqrf(a32), 5)
            lib_g, _ = try_graph_ms(lambda: torch.geqrf(a32), 10)
            key = "%dx%d" % (m, w)
            shapes[key] = {"shape": key, "err": err, "tau_err": terr,
                           "values_ok": v_ok, "values_held": held,
                           "sign_tie_column": tie,
                           "residual": res,
                           "residual_plain": qr_residual(a, pp, pt),
                           "ms": g_ms if g_ms is not None else ms,
                           "eager_ms": ms, "graph_ms": g_ms,
                           "graph_error": g_err, "plain_ms": plain_ms,
                           "library_ms": lib_ms, "library_graph_ms": lib_g,
                           "library": "torch.geqrf"
                           + (" (f32 upcast)" if dtype != torch.float32
                              else ""),
                           **qr_bounds(m, w, a.element_size())}
        out[dname] = {"adversarial": kinds, "shapes": shapes}
        if dtype == torch.bfloat16:
            tie_ok, out["sign_tie_panel"] = qr_sign_tie_case()
            ok &= tie_ok
            results["qr_panel.bfloat16"] = entry(
                "qr_panel", dname, "qr_panel.cu", PK + "136", "gels_bf16",
                shapes["%dx128" % N_QR_BF16], worst)
    out["ok"] = bool(ok)
    return out


def qr_step_evidence(a, j, kp, kt, pp, pt):
    """Column j of the kernel's and the plain version's bf16 factors of
    the panel `a`: both taus and alphas (R[j, j] (1 - tau[j])), the plain
    version's column before step j (alpha, the norm below the diagonal
    and the whole norm in f32, that norm rounded to bf16), and whether
    the kernel's step from that same state is bitwise the plain step."""
    state = pk.qr_panel_plain(a, steps=j)[0][j:, j:].contiguous()
    x = state[:, 0].float()
    nrm = float(pk._sqrt((x * x).sum()))
    ks, kst = pk._qr_panel_launch(state)
    ps, pst = pk.qr_panel_plain(state)
    return {"tau": [float(kt[j]), float(pt[j])],
            "alpha": [float(kp[j, j].float()) * (1.0 - float(kt[j])),
                      float(pp[j, j].float()) * (1.0 - float(pt[j]))],
            "plain_alpha": float(x[0]),
            "plain_norm_below_f32": float(pk._sqrt((x[1:] * x[1:]).sum())),
            "plain_norm_f32": nrm,
            "plain_norm_bf16": float(torch.tensor(nrm).bfloat16().float()),
            "kernel_step_bitwise": bool(torch.equal(ks[:, 0], ps[:, 0])
                                        and torch.equal(kst[:1], pst[:1]))}


def qr_sign_tie_case():
    """The fixed sign-tie panel (testing.qr_sign_tie_panel, its own seed
    0: a 1024 x 128 bf16 panel whose kernel and plain factors part at a
    reflector's sign at column 101): held as every bf16 panel is, on
    what precedes its first tie, and to the residual. Reports the
    evidence: the share of the squared difference in the tie's column
    and row, the columns before it whose R diagonals round apart, and
    qr_step_evidence at the first of those and at the tie and the
    column before it."""
    a = torch.as_tensor(qr_sign_tie_panel(0), device="cuda").to(
        torch.bfloat16)
    kp, kt = pk._qr_panel_launch(a)
    pp, pt = pk.qr_panel_plain(a)
    v_ok, err, terr, tie = qr_values_ok("random", torch.bfloat16, kp, kt,
                                        pp, pt)
    res, res_p = qr_residual(a, kp, kt), qr_residual(a, pp, pt)
    ok = v_ok and res <= QR_RES_LIMIT[torch.bfloat16]
    out = {"shape": "1024x128", "seed": 0, "ok": bool(ok),
           "sign_tie_column": tie, "err": err, "tau_err": terr,
           "err_whole": rel_diff(kp, pp), "residual": res,
           "residual_plain": res_p}
    if tie is not None:
        d = (kp.double() - pp.double()) ** 2
        out["tie_share"] = float((d[tie:, tie].sum() + d[tie, tie + 1:].sum())
                                 / d.sum())
        rounded = [j for j in range(tie) if kp[j, j] != pp[j, j]]
        out["diagonal_rounded_apart"] = rounded
        for j in sorted(set(rounded[:1] + [tie - 1, tie])):
            out["column_%d" % j] = qr_step_evidence(a, j, kp, kt, pp, pt)
    return ok, out


def exact_or_scaled(kind, kp, pp, exact):
    """Bitwise for the kinds whose every operation is exact, else to
    1e-5 of the scale (products summed in another order)."""
    if kind in exact:
        return bool(torch.equal(kp, pp)), 0.0
    err = scaled_err(kp, pp)
    return err <= 1e-5, err


def phase_chol_panel(results):
    """chol_panel: the adversarial suite (n = 256, two stripes), then
    SPD blocks at n = 1024, 512, 256 (the public entry, counted), each
    against the plain version, the library's factor, its own launch
    with the blocks started one at a time, and times."""
    ok, out, kinds = True, {"phase": "kernel.chol_panel"}, {}
    for kind, a_np in chol_cases(np.random.default_rng(22), 256).items():
        a = torch.as_tensor(a_np, device="cuda")
        kp = pk._chol_panel_launch(a)
        pp = pk.chol_panel_plain(a)
        torch.cuda.synchronize()
        k_ok, err = exact_or_scaled(kind, kp, pp, ("diag", "equal"))
        k_ok &= bool(torch.equal(kp, torch.tril(kp)))
        ok &= k_ok
        kinds[kind] = {"err": err, "ok": k_ok}
    gen = torch.Generator("cuda").manual_seed(22)
    blocks = {n: spd_system(gen, n, 1)[0] for n in (1024, 512, 256)}
    pk.reset_launch_counts()
    outs = {n: pk.chol_panel(s) for n, s in blocks.items()}
    torch.cuda.synchronize()
    launches = pk.launch_counts()["chol_panel"]
    shapes, worst = {}, 0.0
    for n, s in blocks.items():
        pp = pk.chol_panel_plain(s)
        err = scaled_err(outs[n], pp)
        lib = torch.linalg.cholesky(s)
        # the stripe's blocks one at a time, block 0 (which writes the
        # diagonal block) first: bitwise the concurrent launch's factor
        serial_eq = bool(torch.equal(pk._chol_panel_launch(s, serial=True),
                                     pk._chol_panel_launch(s)))
        ok &= err <= 1e-5 and serial_eq
        worst = max(worst, float((outs[n] - pp).abs().max()))
        ms = cuda_ms(lambda: pk._chol_panel_launch(s), 10)
        plain_ms = cuda_ms(lambda: pk.chol_panel_plain(s), 1)
        lib_ms = cuda_ms(lambda: torch.linalg.cholesky(s), 10)
        b_ms, b_by = bound_ms(n ** 3 / 3.0, 2.0 * 4 * n * n)
        shapes[str(n)] = {"shape": "%dx%d" % (n, n), "err": err,
                          "err_library": scaled_err(outs[n], lib),
                          "serial_equal": serial_eq,
                          "ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms,
                          "library": "torch.linalg.cholesky",
                          "bound_ms": b_ms, "bound_by": b_by}
    ok &= launches == len(blocks)
    results["chol_panel"] = entry("chol_panel", "float32", "chol_panel.cu",
                                  PK + "933", PUBLIC_ENTRY, shapes["1024"],
                                  worst)
    results["chol_panel"]["launches"] = launches
    out.update(ok=bool(ok), adversarial=kinds, shapes=shapes,
               launches=launches)
    return out


def phase_trtri_lower(results):
    """trtri_lower, non-unit and unit: the adversarial suite (n = 256),
    then Cholesky factors at n = 512, 256, 128 (the public entry,
    counted), each against the plain version, and times: back to back
    (ms, library_ms) and replayed from a CUDA graph (graph_ms,
    library_graph_ms: the card's time without the wrapper's launch
    overhead, which dominates a call at n = 128)."""
    ok, out, kinds = True, {"phase": "kernel.trtri_lower"}, {}
    for kind, a_np in trtri_cases(np.random.default_rng(23), 256).items():
        a = torch.as_tensor(a_np, device="cuda")
        for unit in (False, True):
            if (kind, unit) == ("huge", True):
                continue        # a unit triangle at 2^40 has no f32 inverse
            kp = pk._trtri_lower_launch(a, unit)
            pp = pk.trtri_lower_plain(a, unit)
            torch.cuda.synchronize()
            k_ok, err = exact_or_scaled(kind, kp, pp, ("diag", "equal"))
            ok &= k_ok
            kinds["%s.%s" % (kind, "unit" if unit else "nonunit")] = {
                "err": err, "ok": k_ok}
    gen = torch.Generator("cuda").manual_seed(23)
    blocks = {n: torch.linalg.cholesky(spd_system(gen, n, 1)[0])
              for n in (512, 256, 128)}
    pk.reset_launch_counts()
    outs = {(n, u): pk.trtri_lower(L, unit_diagonal=u)
            for n, L in blocks.items() for u in (False, True)}
    torch.cuda.synchronize()
    launches = pk.launch_counts()["trtri_lower"]
    shapes, worst = {}, 0.0
    for (n, unit), X in outs.items():
        L = blocks[n]
        pp = pk.trtri_lower_plain(L, unit)
        err = scaled_err(X, pp)
        ok &= err <= 1e-5
        worst = max(worst, float((X - pp).abs().max()))
        if unit:
            continue
        eye = torch.eye(n, device="cuda")
        ms = cuda_ms(lambda: pk._trtri_lower_launch(L, False), 10)
        plain_ms = cuda_ms(lambda: pk.trtri_lower_plain(L), 1)
        lib_ms = cuda_ms(lambda: torch.linalg.solve_triangular(
            L, eye, upper=False), 10)
        b_ms, b_by = bound_ms(n ** 3 / 3.0, 2.0 * 4 * n * n)
        shapes[str(n)] = {"shape": "%dx%d" % (n, n), "err": err,
                          "ms": ms, "plain_ms": plain_ms,
                          "graph_ms": graph_ms(
                              lambda: pk._trtri_lower_launch(L, False)),
                          "library_graph_ms": graph_ms(
                              lambda: torch.linalg.solve_triangular(
                                  L, eye, upper=False)),
                          "library_ms": lib_ms,
                          "library": "torch.linalg.solve_triangular "
                                     "against I",
                          "bound_ms": b_ms, "bound_by": b_by}
    ok &= launches == len(outs)
    results["trtri_lower"] = entry("trtri_lower", "float32",
                                   "trtri_lower.cu", PK + "854",
                                   PUBLIC_ENTRY, shapes["512"], worst)
    results["trtri_lower"]["launches"] = launches
    out.update(ok=bool(ok), adversarial=kinds, shapes=shapes,
               launches=launches)
    return out


def set_launches(results, path, counts):
    for e in results.values():
        if e["path"] == path:
            e["launches"] = counts[e["name"]]


def phase_gesv(seed, results, system):
    """The f32 main path, routed to the recursive panel kernel by a
    tune cache of its own. Leaves A, B, X and the options in `system`
    for the later phases."""
    fresh_tune_cache([torch.float32])
    a_np, b_np = permuted_boosted_system(np.random.default_rng(seed), N,
                                         NRHS)
    A = st.Matrix(a_np, mb=NB)
    B = st.Matrix(b_np, mb=NB)
    del a_np, b_np
    opts = {st.Option.BlockSize: NB}
    st.gesv(A, B, opts)                       # warm-up
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    wall, (F, X) = wall_s(lambda: st.gesv(A, B, opts))
    launches = pk.launch_counts()
    set_launches(results, "gesv", launches)
    e = berr(A, X, B)
    with tselect.disabled():                  # the cold route
        st.gesv(A, B, opts)
        wall_cold, (Fc, Xc) = wall_s(lambda: st.gesv(A, B, opts))
    xdiff = rel_diff(X.data, Xc.data)
    ok = (all(launches[k] > 0 for k in ("lu_panel_rec", "rank_update",
                                        "compose_swaps"))
          and e <= 1e-6 and xdiff <= 1e-3 and int(F.info) == 0
          and bool(torch.isfinite(X.data).all()))
    system.update(A=A, B=B, X=X, opts=opts, wall=wall, wall_cold=wall_cold,
                  piv=F.pivots)
    return {"phase": "gesv", "ok": bool(ok), "n": N, "nrhs": NRHS,
            "nb": NB, "dtype": "float32", "seed": seed,
            "driver_wall_s": wall, "launches": launches,
            "backward_error": e,
            "x_rel_diff_cold": xdiff,
            "pivots_equal_cold": torch.equal(F.pivots, Fc.pivots),
            "wall_s_cold_route": wall_cold,
            "gflops": (2.0 / 3.0 * N ** 3 + 2.0 * N * N * NRHS) / wall / 1e9,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def mixed_check(name, A, B, call, ref_x, factor="LU"):
    """One mixed solve, after a warm-up, with the launch counts of the
    measured call: converged (iters >= 0), backward error <= 1e-6, X
    within 1e-5 of the f32 solve's, the factor (attribute `factor` of
    the first result) in bf16."""
    call()
    pk.reset_launch_counts()
    wall, (F, X, iters) = wall_s(call)
    launches = pk.launch_counts()
    e = berr(A, X, B)
    xdiff = rel_diff(X.data, ref_x)
    fdt = getattr(F, factor).dtype
    ok = (iters >= 0 and e <= 1e-6 and xdiff <= 1e-5
          and fdt == torch.bfloat16
          and bool(torch.isfinite(X.data).all()))
    return ok, launches, {"driver": name, "driver_wall_s": wall,
                          "iters": iters,
                          "launches": launches, "backward_error": e,
                          "x_rel_diff_f32": xdiff,
                          "factor_dtype": str(fdt)}


def phase_mixed_cold(seed, results, system):
    """gesv_mixed and gesv_mixed_gmres on the cold route at n = 4096;
    leaves the system in `system` for the profile phase."""
    fresh_tune_cache()
    a_np, b_np = permuted_boosted_system(np.random.default_rng(seed),
                                         N_COLD, NRHS)
    A = st.Matrix(a_np, mb=NB_COLD)
    B = st.Matrix(b_np, mb=NB_COLD)
    B1 = st.Matrix(b_np[:, :1], mb=NB_COLD)
    system["cold"] = (A, B)
    steps = N_COLD // min(512, pk.LU_PANEL_MAX_W)
    out = {"phase": "gesv_mixed.cold", "n": N_COLD, "tiles": NB_COLD,
           "lu_panel_launches_expected": steps}
    ok = True
    for name, fn, rhs in (("gesv_mixed", st.gesv_mixed, B),
                          ("gesv_mixed_gmres", st.gesv_mixed_gmres, B1)):
        wall_f32, (_, Xf) = wall_s(lambda: st.gesv(A, rhs))
        c_ok, launches, rep = mixed_check(name, A, rhs,
                                          lambda: fn(A, rhs), Xf.data)
        c_ok &= launches["lu_panel"] == steps
        if name == "gesv_mixed_gmres":
            # one packed solve a preconditioner solve: the first x and
            # 30 a restart cycle
            c_ok &= launches["lu_solve_packed"] == 1 + rep["iters"]
        rep["ok"] = bool(c_ok)
        rep["gesv_f32_wall_s"] = wall_f32
        out[name] = rep
        ok &= c_ok
        set_launches(results, name + ".cold", launches)
    out["ok"] = bool(ok)
    return out


def phase_mixed(results, system):
    """The mixed-precision main path at n = 16384 (the system of phase
    gesv), recursive panels for f32 and bf16."""
    fresh_tune_cache([torch.float32, torch.bfloat16])
    A, B, opts = system["A"], system["B"], system["opts"]
    ok, launches, rep = mixed_check(
        "gesv_mixed", A, B, lambda: st.gesv_mixed(A, B, opts),
        system["X"].data)
    ok &= all(launches[k] > 0 for k in ("lu_panel_rec", "rank_update",
                                        "compose_swaps"))
    set_launches(results, "gesv_mixed", launches)
    system["mixed_wall"] = rep["driver_wall_s"]
    return {"phase": "gesv_mixed", "ok": bool(ok), "n": N, "nrhs": NRHS,
            "nb": NB, **rep, "gesv_f32_wall_s": system["wall"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


#: the panel-height buckets the tune phase probes: those that
#: fresh_tune_cache writes by hand (512 ... N)
LU_BUCKETS = tuple(512 * 2 ** k for k in range(6))
#: where the tune phase probes getrf / geqrf and heev (heev at the
#: reference's bench.py --tune size: its staged routes take seconds)
N_TUNE_BLOCK, N_TUNE_EIG = 4096, 512


def rec_launches(m, w, dtype):
    """lu_panel_rec kernel launches of one (m, w) panel: one dispatch
    within the element budget, else the halving of kernels._lu_rec_split
    (the left half, then the right half's rows below it)."""
    if m * w <= pk._rec_max_elems(dtype, None):
        return 1
    h = w // 2
    return rec_launches(m, h, dtype) + rec_launches(m - h, h, dtype)


def expected_panel_launches(routes, dtype, n, nb):
    """The LU panel kernels' launches in one getrf of an n x n matrix at
    width nb, from the routes a tune cache holds per panel-height bucket
    (None: no entry), by lu._lu_panel's arbitration: a cached kernel
    route where its gate takes the panel, else the panel's cold route
    (the library LU for f32; for bf16 the rank-1 kernel where its gate
    takes the panel, else the column loop), for a rejected ``pallas`` as
    for a rejected ``pallas_rec``. Returns the counts and the panels by
    the route they took."""
    counts = {"lu_panel_rec": 0, "lu_panel": 0}
    taken = {}
    for k0 in range(0, n, nb):
        m, w = n - k0, min(nb, n - k0)
        route = routes.get(tcache.size_bucket(m))
        if route == "pallas_rec" \
                and not pk.lu_panel_rec_eligible(m, w, dtype, "cuda"):
            route = None
        if route == "pallas" \
                and not pk.lu_panel_eligible(m, w, dtype, "cuda"):
            route = None
        if route is None:
            route = MethodLUPanel.cold_default(m, w, dtype, "cuda").value
            if route == "pallas" \
                    and not pk.lu_panel_eligible(m, w, dtype, "cuda"):
                route = "fori"
        if route == "pallas_rec":
            counts["lu_panel_rec"] += rec_launches(m, w, dtype)
        elif route == "pallas":
            counts["lu_panel"] += 1
        taken[route] = taken.get(route, 0) + 1
    return counts, taken


def phase_autotune(results, system):
    """tune.autotune from an empty cache: the LU panel route for f32 and
    bf16 at every bucket of LU_BUCKETS (the reference's probe width
    min(max(h / 16, 64), 512) at height h), then getrf and geqrf at
    N_TUNE_BLOCK and heev at N_TUNE_EIG; each call's results and choice
    on a line of its own. Then gesv and gesv_mixed at N on the probed
    cache: backward error <= 1e-6, the panel kernels' launches those the
    persisted routes predict (expected_panel_launches), pallas_rec among
    the candidates wherever its gate takes the probe's panel, gesv's
    pivots bitwise phase gesv's where every f32 bucket chose pallas_rec;
    their walls beside phase gesv's cold and hand-written-cache walls
    and phase gesv_mixed's (the cold gesv_mixed at N: one call here)."""
    t0 = time.perf_counter()
    fresh_tune_cache()
    tstats.reset()
    out = {"phase": "tune.autotune"}
    ok = True
    routes = {}
    for dname, dtype in DTYPES:
        routes[dtype] = {}
        for h in LU_BUCKETS:
            r = autotune(ops=("lu_panel",), n=h, dtype=dtype)["lu_panel"]
            w = min(max(h // 16, 64), 512)
            labels = [x["method"] for x in r["results"]]
            rec_measured = "pallas_rec" in labels
            ok &= rec_measured or not pk.lu_panel_rec_eligible(h, w, dtype,
                                                                "cuda")
            routes[dtype][h] = r["chosen"].get("method_lu_panel")
            emit({"autotune": "lu_panel", "dtype": dname, "n": h, "w": w,
                  "results": r["results"], "chosen": r["chosen"]})
        out["lu_panel." + dname] = {str(h): routes[dtype][h]
                                    for h in LU_BUCKETS}
    for ops, n in ((("getrf", "geqrf"), N_TUNE_BLOCK),
                   (("heev",), N_TUNE_EIG)):
        # heev's staged routes take ~2 s a call at 512: one rep
        rep = autotune(ops=ops, n=n, reps=1 if ops == ("heev",) else 3)
        for op in ops:
            emit({"autotune": op, "dtype": "float32", "n": n,
                  "results": rep[op]["results"],
                  "chosen": rep[op]["chosen"]})
            out[op] = rep[op]["chosen"]
    out["probe_seconds"] = tstats.snapshot()["probe_seconds"]
    out["probe_wall_s"] = time.perf_counter() - t0
    A, B, opts = system["A"], system["B"], system["opts"]
    # gesv (f32) on the probed cache
    st.gesv(A, B, opts)
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    wall, (F, X) = wall_s(lambda: st.gesv(A, B, opts))
    launches = pk.launch_counts()
    want, taken = expected_panel_launches(routes[torch.float32],
                                          torch.float32, N, NB)
    e = berr(A, X, B)
    all_rec = all(v == "pallas_rec" for v in routes[torch.float32].values())
    piv_eq = bool(torch.equal(F.pivots, system["piv"]))
    g_ok = (e <= 1e-6 and int(F.info) == 0
            and all(launches[k] == v for k, v in want.items())
            and (piv_eq or not all_rec))
    out["gesv"] = {"ok": bool(g_ok), "wall_s": wall,
                   "wall_s_hand_cache": system["wall"],
                   "wall_s_cold": system["wall_cold"], "backward_error": e,
                   "launches": launches, "launches_expected": want,
                   "panel_routes_expected": taken,
                   "every_bucket_pallas_rec": all_rec,
                   "pivots_equal_hand_cache": piv_eq}
    # gesv_mixed (bf16 factor) on the probed cache
    m_ok, launches, rep = mixed_check(
        "gesv_mixed", A, B, lambda: st.gesv_mixed(A, B, opts),
        system["X"].data)
    want, taken = expected_panel_launches(routes[torch.bfloat16],
                                          torch.bfloat16, N, NB)
    m_ok &= all(launches[k] == v for k, v in want.items())
    with tselect.disabled():
        wall_cold, _ = wall_s(lambda: st.gesv_mixed(A, B, opts))
    out["gesv_mixed"] = {"ok": bool(m_ok), **rep,
                         "launches_expected": want,
                         "panel_routes_expected": taken,
                         "wall_s_hand_cache": system["mixed_wall"],
                         "wall_s_cold_one_call": wall_cold}
    ok &= g_ok and m_ok
    # the cache the later phases were written for (phase gesv_mixed's)
    fresh_tune_cache([torch.float32, torch.bfloat16])
    out["seconds"] = time.perf_counter() - t0
    out["ok"] = bool(ok)
    return out


#: gesv_rbt's backward error on the permuted boosted system, whose
#: pivots sit in random rows: it is no-pivot LU after a depth-2
#: butterfly, whose factor grows with the draw there (1.7e-5 at
#: n = 4096 on the card). On a matrix boosted in place (the reference's
#: own gesv_rbt test, G + 0.1 n I) it is held to 1e-6.
RBT_PERMUTED_LIMIT = 1e-4


def phase_lu_variants(seed):
    """The rest of LU at n = N_COLD f32, tiles NB_COLD, on a cold cache
    (the tournament nominates with the library LU): gesv_nopiv on a
    diagonally dominant matrix, getrf_tntpiv + getrs on the permuted
    boosted system (backward error <= 1e-6, pivot growth printed),
    gesv_rbt on G + 0.1 n I (<= 1e-6) and on the permuted system
    (<= RBT_PERMUTED_LIMIT), getri (||A A^-1 - I||_F /
    (||A||_F ||A^-1||_F) <= 1e-6) and gecondest (within a factor of 3
    of 1 / (||A||_1 ||A^-1||_1) from getri); each timed after a
    warm-up."""
    t0 = time.perf_counter()
    fresh_tune_cache()
    n, nb = N_COLD, NB_COLD
    a_np, b_np = permuted_boosted_system(np.random.default_rng(seed), n,
                                         NRHS)
    d_np = a_np.copy()
    d_np[np.diag_indices(n)] = np.abs(d_np).sum(axis=1) + 1.0
    w_np = np.random.default_rng(seed + 2).standard_normal(
        (n, n), dtype=np.float32) + np.float32(0.1 * n) * np.eye(
            n, dtype=np.float32)
    A, B, D, W = (st.Matrix(x, mb=nb) for x in (a_np, b_np, d_np, w_np))
    out = {"phase": "lu.variants", "n": n, "tiles": nb}

    def run(name, fn):
        fn()
        pk.reset_launch_counts()
        wall, res = wall_s(fn)
        out[name] = {"wall_s": wall,
                     "launches": {k: v for k, v in pk.launch_counts().items()
                                  if v}}
        return res

    F, X = run("gesv_nopiv", lambda: st.gesv_nopiv(D, B))
    out["gesv_nopiv"]["backward_error"] = e_np = berr(D, X, B)
    F, X = run("getrf_tntpiv", lambda: (lambda F: (F, st.getrs(F, B)))(
        st.getrf_tntpiv(A)))
    out["getrf_tntpiv"]["backward_error"] = e_tnt = berr(A, X, B)
    out["getrf_tntpiv"]["pivot_growth"] = float(
        F.LU.data.triu().abs().max() / A.data.abs().max())
    _, X = run("gesv_rbt", lambda: st.gesv_rbt(W, B))
    out["gesv_rbt"]["backward_error"] = e_rbt = berr(W, X, B)
    _, X = run("gesv_rbt.permuted", lambda: st.gesv_rbt(A, B))
    out["gesv_rbt.permuted"]["backward_error"] = e_rbt_p = berr(A, X, B)
    Fp = st.getrf(A)
    Ainv = run("getri", lambda: st.getri(Fp))
    a64, i64 = A.data.double(), Ainv.data.double()
    r = a64 @ i64 - torch.eye(n, dtype=torch.float64, device=a64.device)
    inv_err = float(torch.linalg.norm(r) / (torch.linalg.norm(a64)
                                            * torch.linalg.norm(i64)))
    out["getri"].update(inverse_error=inv_err,
                        max_abs_residual=float(r.abs().max()))
    anorm = float(a64.abs().sum(dim=0).max())
    rc = run("gecondest", lambda: st.gecondest(st.Norm.One, Fp, anorm))
    exact = 1.0 / (anorm * float(i64.abs().sum(dim=0).max()))
    out["gecondest"].update(rcond=float(rc), rcond_from_getri=exact)
    ok = (e_np <= 1e-6 and e_tnt <= 1e-6 and e_rbt <= 1e-6
          and e_rbt_p <= RBT_PERMUTED_LIMIT
          and inv_err <= 1e-6 and exact / 3 <= float(rc) <= 3 * exact
          and int(Fp.info) == 0)
    out["seconds"] = time.perf_counter() - t0
    out["ok"] = bool(ok)
    return out


def no_hand_kernel(launches):
    return all(v == 0 for v in launches.values())


def add_phase_launches(results, phase, counts):
    """Record a phase's launches beside each f32 kernel row
    ("launches_by_phase"), the main path's count ("launches") kept."""
    for e in results.values():
        if e["dtype"] in ("float32", "int32") and counts.get(e["name"]):
            e.setdefault("launches_by_phase", {})[phase] = counts[e["name"]]


def timed(fn):
    """fn after a warm-up: (wall seconds, result, launch counts of the
    timed call)."""
    fn()
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    wall, out = wall_s(fn)
    return wall, out, pk.launch_counts()


def berr_dense(a, x, b):
    """||A X - B||_F / (||A||_F ||X||_F) in f64 of dense tensors."""
    a64, x64 = a.double(), x.double()
    return float(torch.linalg.norm(a64 @ x64 - b.double())
                 / (torch.linalg.norm(a64) * torch.linalg.norm(x64)))


#: the band phase: kd = kl = ku = 512 at n = N, tiles NB
KD = KL = KU = 512
#: the general band: rows permuted within groups of BAND_GROUP rows
#: (testing.band_general_system), over a band of half the width
#: shifted by twice its spectral radius
BAND_GROUP = 256
BAND_SHIFT = 2.0 * float(np.sqrt(KL + KU - 2 * (BAND_GROUP - 1) + 1))
KAPPA_LIMIT = 1e5
#: the dense route beside the band and indefinite ones: phase gesv's
#: options (panels nb wide, the recursive kernel's width)
DENSE_OPTS = {st.Option.BlockSize: NB}


def band_swaps(piv, n, nb):
    """Swaps that move a row (piv[j] != j), in all and per block step."""
    moved = (piv[:n].long() != torch.arange(n, device=piv.device))
    per = moved[:n - n % nb].view(-1, nb).sum(dim=1)
    return int(moved.sum()), int(per.min()), int((per > 0).sum())


def kappa1(A, F):
    """gecondest's estimate of the 1-norm condition number."""
    anorm = float(A.to_dense().double().abs().sum(dim=0).max())
    rc = float(st.gecondest(st.Norm.One, F, anorm))
    return 1.0 / rc if rc > 0 else float("inf")


def phase_band(seed, results, system):
    """The band solvers at n = N, f32, tiles NB, 64 right-hand sides,
    with f32 LU panels routed to the recursive kernel: pbsv (kd = 512)
    on testing.band_spd_system against posv on the same matrix, no hand
    kernel; gbsv (kl = ku = 512) on testing.band_general_system (its
    rows permuted within groups of BAND_GROUP), one lu_panel_rec and two
    compose_swaps launches a block step, a swap in every block step,
    kappa_1 <= KAPPA_LIMIT, against gesv on the same matrix; gbtrs
    (Op.Trans) and tbsm with the band factors; gbmm and hbmm against
    torch.matmul of the dense matrix, both timed beside that product
    and beside the dense route (gemm / hemm) on the same matrix."""
    t0 = time.perf_counter()
    fresh_tune_cache([torch.float32])
    out = {"phase": "band", "n": N, "nrhs": NRHS, "tiles": NB, "kd": KD,
           "kl": KL, "ku": KU, "seed": seed}
    ok = True
    # pbsv
    a, b = band_spd_system(seed, N, KD, NRHS, "cuda")
    A = st.HermitianBandMatrix(st.Uplo.Lower, KD, a, mb=NB)
    AH = st.HermitianMatrix(st.Uplo.Lower, a, mb=NB)
    B = st.Matrix(b, mb=NB)
    wall, (L, X), launches = timed(lambda: st.pbsv(A, B))
    wall_d, (_, Xd), _ = timed(lambda: st.posv(AH, B))
    e = berr_dense(a, X.to_dense(), b)
    xdiff = rel_diff(X.data, Xd.data)
    p_ok = (e <= 1e-6 and xdiff <= 1e-5 and no_hand_kernel(launches)
            and L.mtype is st.MatrixType.TriangularBand)
    out["pbsv"] = {"ok": bool(p_ok), "wall_s": wall, "wall_s_posv": wall_d,
                   "backward_error": e, "x_rel_diff_posv": xdiff,
                   "launches": {k: v for k, v in launches.items() if v}}
    ok &= p_ok
    # hbmm on the same band
    C0 = st.Matrix(torch.zeros_like(b), mb=NB)
    C = st.hbmm(st.Side.Left, 1.0, A, B, 0.0, C0)
    ref = a @ b
    out["hbmm"] = {"rel_err": rel_diff(C.to_dense(), ref),
                   "ms": cuda_ms(lambda: st.hbmm(st.Side.Left, 1.0, A, B,
                                                 0.0, C0), 5),
                   "hemm_ms": cuda_ms(lambda: st.hemm(
                       st.Side.Left, 1.0, AH, B, 0.0, C0), 5),
                   "matmul_ms": cuda_ms(lambda: a @ b, 5)}
    ok &= out["hbmm"]["rel_err"] <= 1e-6
    del a, b, A, AH, L, X, Xd, C, ref
    # gbsv
    a, b = band_general_system(seed + 1, N, KL, KU, NRHS, "cuda",
                               shift=BAND_SHIFT, group=BAND_GROUP)
    A = st.BandMatrix(KL, KU, a, mb=NB)
    AD = st.Matrix(a, mb=NB)
    B = st.Matrix(b, mb=NB)
    wall, (F, X), launches = timed(lambda: st.gbsv(A, B))
    add_phase_launches(results, "band", launches)
    wall_d, (_, Xd), _ = timed(lambda: st.gesv(AD, B, DENSE_OPTS))
    steps = N // NB
    moved, least, with_swap = band_swaps(F.pivots, N, NB)
    kap = kappa1(A, F)
    e = berr_dense(a, X.to_dense(), b)
    xdiff = rel_diff(X.data, Xd.data)
    Xt = st.gbtrs(F, B, trans=st.Op.Trans)
    e_t = berr_dense(a.T, Xt.to_dense(), b)
    r = F.LU.resolve()
    Lb = dataclasses.replace(r, mtype=st.MatrixType.TriangularBand,
                             uplo=st.Uplo.Lower, diag=st.Diag.Unit)
    Ub = dataclasses.replace(r, mtype=st.MatrixType.TriangularBand,
                             uplo=st.Uplo.Upper, diag=st.Diag.NonUnit)
    Xtb = st.tbsm(st.Side.Left, 1.0, Ub,
                  st.tbsm(st.Side.Left, 1.0, Lb, B, pivots=F))
    e_tb = berr_dense(a, Xtb.to_dense(), b)
    g_ok = (e <= 1e-6 and xdiff <= 1e-3 and e_t <= 1e-6 and e_tb <= 1e-6
            and F.band and int(F.info) == 0 and kap <= KAPPA_LIMIT
            and with_swap == steps
            and launches["lu_panel_rec"] == steps
            and launches["rank_update"] == 0
            and launches["compose_swaps"] == 2 * steps)
    out["gbsv"] = {"ok": bool(g_ok), "wall_s": wall, "wall_s_gesv": wall_d,
                   "shift": BAND_SHIFT, "group": BAND_GROUP,
                   "backward_error": e, "x_rel_diff_gesv": xdiff,
                   "swaps": moved, "least_swaps_a_step": least,
                   "steps_with_a_swap": with_swap, "steps": steps,
                   "kappa1": kap, "gbtrs_trans_backward_error": e_t,
                   "tbsm_backward_error": e_tb,
                   "launches": {k: v for k, v in launches.items() if v},
                   "launches_expected": {"lu_panel_rec": steps,
                                         "compose_swaps": 2 * steps}}
    ok &= g_ok
    # gbmm
    C0 = st.Matrix(torch.zeros_like(b), mb=NB)
    C = st.gbmm(1.0, A, B, 0.0, C0)
    out["gbmm"] = {"rel_err": rel_diff(C.to_dense(), a @ b),
                   "ms": cuda_ms(lambda: st.gbmm(1.0, A, B, 0.0, C0), 5),
                   "gemm_ms": cuda_ms(lambda: st.gemm(1.0, AD, B, 0.0, C0),
                                      5),
                   "matmul_ms": cuda_ms(lambda: a @ b, 5)}
    ok &= out["gbmm"]["rel_err"] <= 1e-6
    system["band"] = (A, B)
    out["seconds"] = time.perf_counter() - t0
    out["ok"] = bool(ok)
    return out


#: the Parlett-Reid case (n <= 2 nb at tiles NB) and the stacked api
#: systems
N_PR = 1000
N_API = 2048
API_STACK = (64, 256)


def aasen_residual(a64, F):
    """||P A P^T - L T L^H||_F / ||A||_F in f64 from the factors' stored
    entries, whether T's are zero outside |i - j| < 2 nb (1 on the
    Parlett-Reid path) and whether L's are unit lower."""
    n = a64.shape[0]
    p = F.pivots[:n].long()
    L = F.L.data[:n, :n]
    T = F.T.data[:n, :n]
    bw = F.T.kl if F.T.mtype is st.MatrixType.GeneralBand else 1
    band_ok = bool(torch.equal(T, torch.triu(torch.tril(T, bw), -bw)))
    unit = bool(torch.equal(torch.diagonal(L), torch.ones_like(L[0]))
                and torch.equal(L, torch.tril(L)))
    L, T = L.double(), T.double()
    r = float(torch.linalg.norm(a64[p][:, p] - L @ T @ L.T)
              / torch.linalg.norm(a64))
    return r, band_ok, unit


def rec_splits(m, w, dtype):
    """_rank_update launches of one (m, w) recursive panel: one a
    host-level split of kernels._lu_rec_split, which also composes two
    swap sequences."""
    if m * w <= pk._rec_max_elems(dtype, None):
        return 0
    h = w // 2
    return 1 + rec_splits(m, h, dtype) + rec_splits(m - h, h, dtype)


def panel_launches(heights, w, dtype):
    """Kernel launches of recursive panels (m, w) for m in `heights`,
    each followed by one composition of its swaps (the driver's)."""
    splits = sum(rec_splits(m, w, dtype) for m in heights)
    return {"lu_panel_rec": sum(rec_launches(m, w, dtype) for m in heights),
            "rank_update": splits,
            "compose_swaps": len(heights) + 2 * splits}


def aasen_panel_heights(n, nb):
    """Heights of the nb-wide LU panels of one hesv at order n, tiles
    nb: hetrf's panels (n - r0) x nb, r0 = nb, 2 nb, ... while more than
    nb rows lie below, then the gbsv of T (bandwidth 2 nb - 1): its
    windows ((nb + round_up(2 nb - 1, nb)) x nb), one a block step."""
    wr = -(-(2 * nb - 1) // nb) * nb
    return ([n - r0 for r0 in range(nb, n, nb) if n - r0 > nb]
            + [nb + wr] * (n // nb))


def aasen_launches(n, nb, dtype):
    """Kernel launches of one hesv at order n, tiles nb: its panels
    (aasen_panel_heights), and the forward sweep's swaps of T's gbsv,
    one composition a block step."""
    want = panel_launches(aasen_panel_heights(n, nb), nb, dtype)
    want["compose_swaps"] += n // nb
    return want


#: the held panels' value tolerance, of max(1, max |a|): the
#: adversarial suite's f32 one
HELD_TOL = 1e-4
#: two f32 roundings past 1
L_MAX_SLACK = 2.0 ** -22


def held_panel(a, kp, kpiv, pp, ppiv):
    """One panel of held_panels: the kernel's factor residual, max |L|
    (1 at most under partial pivoting, each multiplier a candidate over
    the largest, and 1 + L_MAX_SLACK for a product with the pivot's
    rounded reciprocal), and against the plain version either equal
    pivots and values within HELD_TOL, or, from the first column j
    where the pivots part, pivots of equal magnitude within HELD_TOL: a
    tie at the values' rounding, which the two orders of summation
    break apart."""
    w = a.shape[1]
    scale = max(1.0, float(a.abs().max()))
    row = {"shape": list(a.shape), "residual": lu_residual(a, kp, kpiv),
           "l_max": float(torch.tril(kp, -1)[:, :w].abs().max())
           if w > 1 else 0.0}
    part = (kpiv != ppiv).nonzero()
    if len(part) == 0:
        row["err"] = float((kp.double() - pp.double()).abs().max()) / scale
        held = row["err"] <= HELD_TOL
    else:
        j = int(part[0])
        row["first_parted"] = j
        row["pivots_parted"] = len(part)
        row["pivot_gap"] = abs(abs(float(kp[j, j])) - abs(float(pp[j, j]))
                               ) / scale
        held = row["pivot_gap"] <= HELD_TOL
    row["ok"] = bool(held and row["residual"] <= RES_LIMIT[torch.float32]
                     and row["l_max"] <= 1.0 + L_MAX_SLACK)
    return row


def held_panels(fn):
    """fn() with every lu_panel_rec call held against
    lu_panel_rec_plain on a copy of the same input (held_panel). Returns
    the calls, the worst of each number and the panels whose pivots
    part from the plain version's."""
    real = pk.lu_panel_rec
    rows = []

    def check(a, *args, **kw):
        a0 = a.clone()
        got = real(a, *args, **kw)
        if got is not None:
            pp, ppiv = pk.lu_panel_rec_plain(a0.clone(), *args, **kw)
            rows.append(held_panel(a0, *got, pp, ppiv))
        return got

    pk.lu_panel_rec = check
    try:
        fn()
    finally:
        pk.lu_panel_rec = real
    parted = [r for r in rows if "first_parted" in r]
    return {"ok": all(r["ok"] for r in rows), "calls": len(rows),
            "heights": sorted({r["shape"][0] for r in rows}),
            "worst_residual": max((r["residual"] for r in rows),
                                  default=None),
            "l_max": max((r["l_max"] for r in rows), default=None),
            "worst_err_equal_pivots": max(
                (r["err"] for r in rows if "err" in r), default=None),
            "pivots_parted": [{k: r[k] for k in (
                "shape", "first_parted", "pivots_parted", "pivot_gap",
                "residual")} for r in parted],
            "failed": [r for r in rows if not r["ok"]][:4]}


def phase_indefinite(seed, results, system):
    """Aasen's hesv at n = N, tiles NB, 64 right-hand sides on
    testing.indefinite_system: f32 with f32 panels routed to the
    recursive kernel (lu_panel_rec, _rank_update and compose_swaps
    launched exactly as aasen_launches counts them; every panel of one
    more hesv held against the plain version by held_panel, since the
    reference's f32 accuracy (ROADMAP queue 3) leaves the solve's own
    residual too loose to fail a wrong panel; sysv bitwise hesv; the
    factor residual and backward error no worse than 4x the cold
    route's on the same matrix), then f64 (library panels): the factor
    residual, backward error <= 1e-6 and X within 1e-5 of gesv's, T
    banded, L unit lower. Small cases: the Parlett-Reid path at
    n = N_PR (f64, backward error <= 1e-6; f32 printed) and info > 0
    on a zero matrix."""
    t0 = time.perf_counter()
    fresh_tune_cache([torch.float32])
    out = {"phase": "indefinite", "n": N, "nrhs": NRHS, "tiles": NB,
           "seed": seed}
    a, b = indefinite_system(seed, N, NRHS, "cuda")
    A = st.HermitianMatrix(st.Uplo.Lower, a, mb=NB)
    B = st.Matrix(b, mb=NB)
    wall, (F, X), launches = timed(lambda: st.hesv(A, B))
    add_phase_launches(results, "indefinite", launches)
    want = aasen_launches(N, NB, torch.float32)
    a64 = a.double()
    res, band_ok, unit = aasen_residual(a64, F)
    e = berr_dense(a, X.to_dense(), b)
    _, X2 = st.sysv(A, B)
    held = held_panels(lambda: st.hesv(A, B))
    held["ok"] &= held["calls"] == len(aasen_panel_heights(N, NB))
    with tselect.disabled():
        wall_c, (Fc, Xc), _ = timed(lambda: st.hesv(A, B))
    res_c = aasen_residual(a64, Fc)[0]
    e_c = berr_dense(a, Xc.to_dense(), b)
    wall_g, (_, Xg), _ = timed(lambda: st.gesv(st.Matrix(a, mb=NB), B,
                                               DENSE_OPTS))
    f_ok = (all(launches[k] == v for k, v in want.items())
            and held["ok"] and band_ok and unit and bool(torch.equal(X.data, X2.data))
            and res <= 4 * res_c and e <= 4 * e_c
            and bool(torch.isfinite(X.data).all()))
    out["float32"] = {"ok": bool(f_ok), "wall_s": wall, "wall_s_cold": wall_c,
                      "wall_s_gesv": wall_g, "factor_residual": res,
                      "factor_residual_cold": res_c, "backward_error": e,
                      "backward_error_cold": e_c,
                      "backward_error_gesv": berr_dense(a, Xg.to_dense(), b),
                      "x_rel_diff_gesv": rel_diff(X.data, Xg.data),
                      "t_banded": band_ok, "l_unit_lower": unit,
                      "sysv_bitwise_hesv": bool(torch.equal(X.data,
                                                            X2.data)),
                      "launches": {k: v for k, v in launches.items() if v},
                      "launches_expected": want,
                      "panels_held_plain": held,
                      "swaps": int((F.pivots[:N].long() != torch.arange(
                          N, device="cuda")).sum())}
    system["indefinite"] = (A, B)
    del F, X, X2, Fc, Xc, Xg
    A64 = st.HermitianMatrix(st.Uplo.Lower, a64, mb=NB)
    B64 = st.Matrix(b.double(), mb=NB)
    del a, A
    wall, (F, X), launches = timed(lambda: st.hesv(A64, B64))
    res, band_ok, unit = aasen_residual(a64, F)
    e = berr_dense(a64, X.to_dense(), B64.to_dense())
    wall_g, (_, Xg), _ = timed(lambda: st.gesv(st.Matrix(a64, mb=NB), B64,
                                               DENSE_OPTS))
    xdiff = rel_diff(X.data, Xg.data)
    d_ok = (res <= 1e-6 and e <= 1e-6 and xdiff <= 1e-5 and band_ok
            and unit)
    out["float64"] = {"ok": bool(d_ok), "wall_s": wall,
                      "wall_s_gesv": wall_g, "factor_residual": res,
                      "backward_error": e, "x_rel_diff_gesv": xdiff,
                      "t_banded": band_ok, "l_unit_lower": unit,
                      "launches": {k: v for k, v in launches.items() if v}}
    del F, X, Xg, A64, B64, a64, b
    # the Parlett-Reid path (n <= 2 nb) and info
    ap, bp = indefinite_system(seed + 1, N_PR, 4, "cuda", torch.float64)
    pr = {}
    for name, dt in (("float64", torch.float64), ("float32", torch.float32)):
        Ap = st.HermitianMatrix(st.Uplo.Lower, ap.to(dt), mb=NB)
        wall, (F, X), _ = timed(lambda: st.hesv(Ap, st.Matrix(bp.to(dt),
                                                               mb=NB)))
        pr[name] = {"wall_s": wall, "t_general": F.T.mtype.name,
                    "backward_error": berr_dense(ap, X.to_dense(), bp)}
    _, info = st.hetrf(st.HermitianMatrix(
        st.Uplo.Lower, torch.zeros((N_PR, N_PR), device="cuda"), mb=NB),
        return_info=True)
    pr["info_zero_matrix"] = int(info)
    s_ok = (pr["float64"]["backward_error"] <= 1e-6 and int(info) > 0
            and pr["float64"]["t_general"] == "General")
    out["parlett_reid"] = {"ok": bool(s_ok), "n": N_PR, **pr}
    out["seconds"] = time.perf_counter() - t0
    out["ok"] = bool(f_ok and d_ok and s_ok)
    return out


def np_berr(a, x, b):
    """berr_dense of numpy arrays, on the host."""
    return berr_dense(*(torch.as_tensor(v) for v in (a, x, b)))


def phase_api(seed, results):
    """lapack_compat, numpy in and out, the work on the card: at
    n = N_API on f64 input (numpy's default), each held by its residual
    in f64 on the host: solve (gen, pos, sym), cholesky, lu_factor /
    lu_solve, solve_triangular, lstsq, inv (backward error <= 1e-6),
    eigh and svdvals (within EIG_LIMIT of scipy); the f32 sym solve
    (Aasen in f32) printed. Then stacked f32 (64, 256, 256) solve and
    cholesky under the bucket and the ragged strategy (a tune row
    "batch/strategy"): ragged equal to bucket to 1e-5, the three ragged
    kernels launched."""
    import scipy.linalg as sla
    t0 = time.perf_counter()
    fresh_tune_cache()
    lc = st.lapack_compat
    rng = np.random.default_rng(seed)
    n = N_API
    g = rng.standard_normal((n, n))
    gen = g + 2.0 * np.sqrt(n) * np.eye(n)
    spd = g @ g.T / n + np.eye(n)
    sym = (g + g.T) / 2 + 4.0 * np.sqrt(n) * np.diag(
        rng.choice([-1.0, 1.0], n))
    tri = np.tril(g) + 2.0 * np.sqrt(n) * np.eye(n)
    b = rng.standard_normal((n, 8))
    tall = rng.standard_normal((2 * n, n))
    bt = rng.standard_normal((2 * n, 8))
    out = {"phase": "api", "n": n}
    errs = {}
    for kind, a in (("gen", gen), ("pos", spd), ("sym", sym)):
        wall, x = wall_s(lambda: lc.solve(a, b, assume_a=kind))
        errs["solve." + kind] = np_berr(a, x, b)
        out["solve." + kind + ".wall_s"] = wall
    x32 = lc.solve(sym.astype(np.float32), b.astype(np.float32),
                   assume_a="sym")
    out["solve.sym.float32.backward_error"] = np_berr(sym, x32, b)
    Lc = lc.cholesky(spd, lower=True)
    errs["cholesky"] = float(np.linalg.norm(Lc @ Lc.T - spd)
                             / np.linalg.norm(spd))
    luf = lc.lu_factor(gen)
    errs["lu_solve"] = np_berr(gen, lc.lu_solve(luf, b), b)
    errs["lu_solve.trans"] = np_berr(gen.T, lc.lu_solve(luf, b, trans=1), b)
    errs["solve_triangular"] = np_berr(
        tri, lc.solve_triangular(tri, b, lower=True), b)
    xl = lc.lstsq(tall, bt)[0]
    r = bt - tall @ xl
    errs["lstsq"] = float(np.linalg.norm(tall.T @ r)
                          / (np.linalg.norm(tall) * np.linalg.norm(r)))
    ai = lc.inv(gen)
    errs["inv"] = float(np.linalg.norm(gen @ ai - np.eye(n))
                        / (np.linalg.norm(gen) * np.linalg.norm(ai)))
    h = (g + g.T) / 2
    w = lc.eigh(h, eigvals_only=True)
    w_ref = sla.eigh(h, eigvals_only=True)
    eig_err = float(np.abs(w - w_ref).max() / np.abs(w_ref).max())
    sv = lc.svdvals(g)
    sv_err = float(np.abs(sv - sla.svdvals(g)).max() / sv.max())
    out.update(backward_errors=errs, eigh_rel_err=eig_err,
               svdvals_rel_err=sv_err)
    ok = (max(errs.values()) <= 1e-6 and eig_err <= EIG_LIMIT
          and sv_err <= EIG_LIMIT)
    # stacked f32: bucket, then ragged
    bsz, m = API_STACK
    gs = rng.standard_normal((bsz, m, m)).astype(np.float32)
    sgen = gs + np.float32(2.0 * np.sqrt(m)) * np.eye(m, dtype=np.float32)
    sspd = (np.einsum("bij,bkj->bik", gs, gs) / m
            + np.eye(m)).astype(np.float32)
    sb = rng.standard_normal((bsz, m)).astype(np.float32)
    stacked = {}
    for strategy in ("bucket", "ragged"):
        fresh_tune_cache()
        if strategy == "ragged":
            tcache.get_cache().put("batch", None, None,
                                   {"strategy": "ragged"})
            tcache.get_cache().save()
        lc.solve(sgen, sb)                    # warm-up
        pk.reset_launch_counts()
        wall_x, xs = wall_s(lambda: lc.solve(sgen, sb))
        wall_l, ls = wall_s(lambda: lc.cholesky(sspd, lower=True))
        launches = pk.launch_counts()
        stacked[strategy] = {"x": xs, "l": ls, "rep": {
            "solve_wall_s": wall_x, "cholesky_wall_s": wall_l,
            "launches": {k: v for k, v in launches.items() if v},
            "solve_backward_error": max(np_berr(sgen[i], xs[i], sb[i])
                                        for i in range(bsz))}}
    rag, buc = stacked["ragged"], stacked["bucket"]
    xd = float(np.linalg.norm(rag["x"] - buc["x"]) / np.linalg.norm(buc["x"]))
    ld = float(np.linalg.norm(rag["l"] - buc["l"]) / np.linalg.norm(buc["l"]))
    launches = rag["rep"]["launches"]
    add_phase_launches(results, "api", launches)
    s_ok = (xd <= 1e-5 and ld <= 1e-5
            and all(launches.get(k, 0) > 0 for k in
                    ("ragged_potrf", "ragged_getrf", "ragged_trsm"))
            and rag["rep"]["solve_backward_error"] <= 1e-6)
    out["stacked"] = {"ok": bool(s_ok), "shape": [bsz, m, m],
                      "bucket": buc["rep"], "ragged": rag["rep"],
                      "x_rel_diff_ragged_bucket": xd,
                      "l_rel_diff_ragged_bucket": ld}
    fresh_tune_cache()
    out["seconds"] = time.perf_counter() - t0
    out["ok"] = bool(ok and s_ok)
    return out


def phase_posv(seed, system):
    """f32 posv at n = 16384 on both routes, on an SPD system made on
    the card. Leaves the system and X in `system`."""
    gen = torch.Generator("cuda").manual_seed(seed)
    s, b = spd_system(gen, N, NRHS)
    A = st.HermitianMatrix(st.Uplo.Lower, s, mb=NB)
    B = st.Matrix(b, mb=NB)
    del s, b
    out = {"phase": "posv", "n": N, "nrhs": NRHS, "tiles": NB,
           "dtype": "float32", "seed": seed}
    ok, xs = True, {}
    for name, opts in (("fused", None),
                       ("tiled", {st.Option.MethodFactor:
                                  st.MethodFactor.Tiled})):
        st.posv(A, B, opts)                     # warm-up
        torch.cuda.synchronize()
        pk.reset_launch_counts()
        wall, (L, X) = wall_s(lambda: st.posv(A, B, opts))
        launches = pk.launch_counts()
        e = berr(A, X, B)
        ok &= (e <= 1e-6 and no_hand_kernel(launches)
               and bool(torch.isfinite(X.data).all()))
        xs[name] = X
        out[name] = {"wall_s": wall, "backward_error": e,
                     "launches": launches,
                     "gflops": (N ** 3 / 3.0 + 2.0 * N * N * NRHS)
                     / wall / 1e9}
    xdiff = rel_diff(xs["tiled"].data, xs["fused"].data)
    ok &= xdiff <= 1e-5
    system.update(SA=A, SB=B, SX=xs["fused"], posv_wall=out["fused"]
                  ["wall_s"])
    out.update(ok=bool(ok), x_rel_diff_routes=xdiff,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def phase_posv_mixed(system):
    """posv_mixed on the system of phase posv: a bf16 factor (the f32
    library Cholesky of the upcast, rounded), f32 refinement."""
    A, B = system["SA"], system["SB"]
    ok, launches, rep = mixed_check("posv_mixed", A, B,
                                    lambda: st.posv_mixed(A, B),
                                    system["SX"].data, factor="data")
    ok &= no_hand_kernel(launches)
    return {"phase": "posv_mixed", "ok": bool(ok), "n": N, "nrhs": NRHS,
            **rep, "posv_f32_wall_s": system["posv_wall"]}


def ls_orthogonality(a, x, b):
    """||A^T (A X - B)||_F / (||A||_F ||A X - B||_F) in f64: the
    least-squares residual's angle to the range of A."""
    a64 = a.double()
    r = a64 @ x.double() - b.double()
    return float(torch.linalg.norm(a64.T @ r)
                 / (torch.linalg.norm(a64) * torch.linalg.norm(r)))


def phase_gels(seed, system):
    """f32 gels: the square system of phase gesv through the QR route
    (the geqrf carry form, library panels), then a tall Gaussian
    through Auto (CholQR) and MethodGels.QR."""
    A, B = system["A"], system["B"]
    opts = {st.Option.MethodGels: st.MethodGels.QR}
    carry_nb = []
    orig = tqr._geqrf_carry
    tqr._geqrf_carry = lambda a, nb, *r: carry_nb.append(nb) \
        or orig(a, nb, *r)
    try:
        st.gels(A, B, opts)                     # warm-up
        torch.cuda.synchronize()
        pk.reset_launch_counts()
        wall, X = wall_s(lambda: st.gels(A, B, opts))
        launches = pk.launch_counts()
    finally:
        tqr._geqrf_carry = orig
    e = berr(A, X, B)
    xdiff = rel_diff(X.data[:N, :NRHS], system["X"].data[:N, :NRHS])
    ok = (e <= 1e-6 and xdiff <= 1e-4 and carry_nb[-1] == 1024
          and no_hand_kernel(launches)
          and bool(torch.isfinite(X.data).all()))
    system.update(gels_X=X)
    out = {"phase": "gels", "square": {
        "n": N, "nrhs": NRHS, "tiles": NB, "route": "qr", "wall_s": wall,
        "geqrf_carry_nb": carry_nb[-1], "launches": launches,
        "backward_error": e, "x_rel_diff_gesv": xdiff,
        "gflops": (4.0 / 3.0 * N ** 3) / wall / 1e9}}
    gen = torch.Generator("cuda").manual_seed(seed + 1)
    at = torch.randn((M_TALL, N_TALL), generator=gen, device="cuda")
    bt = torch.randn((M_TALL, NRHS), generator=gen, device="cuda")
    At, Bt = st.Matrix(at, mb=NB), st.Matrix(bt, mb=NB)
    del at, bt
    xs = {}
    for name, o in (("auto", None),
                    ("qr", {st.Option.MethodGels: st.MethodGels.QR})):
        st.gels(At, Bt, o)
        torch.cuda.synchronize()
        pk.reset_launch_counts()
        wall, Xt = wall_s(lambda: st.gels(At, Bt, o))
        launches = pk.launch_counts()
        x = Xt.data[:N_TALL, :NRHS]
        orth = ls_orthogonality(At.data[:M_TALL, :N_TALL], x,
                                Bt.data[:M_TALL, :NRHS])
        ok &= orth <= 1e-4 and no_hand_kernel(launches)
        xs[name] = x
        out["tall." + name] = {
            "m": M_TALL, "n": N_TALL, "nrhs": NRHS, "wall_s": wall,
            "resolves_to": st.MethodGels.select(M_TALL, N_TALL).value
            if o is None else "qr", "orthogonality": orth,
            "launches": launches,
            "gflops": (2.0 * M_TALL * N_TALL ** 2) / wall / 1e9}
    xdiff_t = rel_diff(xs["auto"], xs["qr"])
    ok &= xdiff_t <= 1e-4
    out.update(ok=bool(ok), tall_x_rel_diff_routes=xdiff_t,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def phase_gels_bf16(seed, results, system):
    """bf16 gels at n = 8192: every sub-panel through the qr_panel
    kernel (64 launches), X against the f32 gels."""
    a_np, b_np = permuted_boosted_system(np.random.default_rng(seed),
                                         N_QR_BF16, NRHS)
    A = st.Matrix(a_np, mb=NB)
    B = st.Matrix(b_np, mb=NB)
    del a_np, b_np
    Ab = st.Matrix(A.data.bfloat16(), mb=NB)
    Bb = st.Matrix(B.data.bfloat16(), mb=NB)
    wall_f32, X32 = wall_s(lambda: st.gels(A, B))
    st.gels(Ab, Bb)                             # warm-up
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    wall, X = wall_s(lambda: st.gels(Ab, Bb))
    launches = pk.launch_counts()
    set_launches(results, "gels_bf16", launches)
    expected = (N_QR_BF16 // tqr.geqrf_default_nb(N_QR_BF16, NB)) \
        * (tqr.geqrf_default_nb(N_QR_BF16, NB) // 128)
    xdiff = rel_diff(X.data.float(), X32.data)
    ok = (launches["qr_panel"] == expected == 64
          and xdiff <= GELS_BF16_LIMIT and X.dtype == torch.bfloat16
          and bool(torch.isfinite(X.data).all()))
    system["gels_bf16"] = (Ab, Bb)
    return {"phase": "gels_bf16", "ok": bool(ok), "n": N_QR_BF16,
            "nrhs": NRHS, "tiles": NB, "driver_wall_s": wall,
            "gels_f32_wall_s": wall_f32, "launches": launches,
            "qr_panel_launches_expected": expected,
            "x_rel_diff_f32": xdiff, "limit": GELS_BF16_LIMIT}


# -- the batch layer: ragged kernels and the serving stream ------------------

#: the serving stream's queue (the reference's bench.py --serve)
SERVE_REQS, SERVE_BATCH, SERVE_LEG = 256, 64, 64
#: ragged kernel against its plain version: pivots bitwise; values f32
#: to 1e-5 of the scale (sums in another order), bf16 to one bf16 ulp
#: of the scale (the same rounding points; a sum that lands on the
#: other side of a rounding boundary moves one ulp)
RAGGED_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
#: bf16 ragged posv against the f32 answer on the serving stream,
#: relative (Frobenius) per request: bf16 storage (u = 2^-8) of a
#: system with cond <= 2 whose factor and sweeps round every stored
#: value; the plain version on the CPU gives 0.004-0.01 at n = 64-600
BF16_POSV_LIMIT = 0.05
RG = "slate_tpu/ops/pallas_kernels.py:"


def to_card(stack, dtype):
    return torch.as_tensor(stack, device="cuda").to(dtype)


def ragged_compare(dtype, kp, pp, sizes):
    """Kernel against plain: the scaled error over the live blocks and
    whether every pad is bitwise the plain version's."""
    err = scaled_err(kp, pp)
    pad_eq = True
    for i, s in enumerate(sizes):
        mask = torch.ones(kp.shape[1:], dtype=torch.bool, device=kp.device)
        mask[:s, :s] = False
        pad_eq &= bool(torch.equal(kp[i][mask], pp[i][mask]))
    return err <= RAGGED_LIMIT[dtype] and pad_eq, err, pad_eq


def largest_flush(seed):
    """Index of the serving stream's first flush of SERVE_BATCH that
    holds its largest order (order 1024 at seed 0: flush 3)."""
    sizes = serve_stream_sizes(seed)
    top = max(sizes)
    return next(f for f in range(len(sizes) // SERVE_BATCH)
                if top in sizes[f * SERVE_BATCH:(f + 1) * SERVE_BATCH])


@functools.lru_cache(maxsize=1)
def serve_stream_sizes(seed):
    return serve_stream(seed, SERVE_REQS)[0]


@functools.lru_cache(maxsize=2)
def path_stacks(seed, flush=0):
    """Flush `flush` (SERVE_BATCH requests) of the serving stream as the
    ragged route stacks it: sizes, ceiling, and the zero-padded SPD,
    gesv (x / sqrt(n) + 2 sqrt(n) I) and one-column right-hand-side
    stacks (numpy f32)."""
    from slate_tpu_torch.batch import bucket
    sizes, xs, spds = serve_stream(seed, SERVE_REQS)
    part = slice(flush * SERVE_BATCH, (flush + 1) * SERVE_BATCH)
    sizes, xs, spds = sizes[part], xs[part], spds[part]
    ceil = bucket.ragged_ceiling(sizes, blk=pk.ragged_blk())
    B = len(sizes)
    spd = np.zeros((B, ceil, ceil), np.float32)
    gen = np.zeros_like(spd)
    rhs = np.zeros((B, ceil, 1), np.float32)
    rng = np.random.default_rng(seed + 7)
    for i, (n, x, a) in enumerate(zip(sizes, xs, spds)):
        spd[i, :n, :n] = a
        gen[i, :n, :n] = x / np.sqrt(n) + 2.0 * np.sqrt(n) * np.eye(n)
        rhs[i, :n, 0] = rng.standard_normal(n)
    return sizes, ceil, spd, gen, rhs


def identity_padded(stack, sizes):
    """The stack with its pads set to the identity (the library calls'
    input: the same function of the live blocks)."""
    out = stack.clone()
    for i, s in enumerate(sizes):
        out[i, s:, :] = 0
        out[i, :, s:] = 0
        out[i, s:, s:] = torch.eye(stack.shape[1] - s, dtype=stack.dtype,
                                   device=stack.device)
    return out


#: elements of the path stack the plain version is held and timed on
#: (its per-column Python loop is slow at order ~600): the largest and
#: three others
def plain_subset(sizes):
    big = int(np.argmax(sizes))
    return sorted({big, 0, 1, 2})


def ragged_row(name, dtype, source, line, path, shape, worst, ms, plain_ms,
               plain_of, lib_ms, library, flops, nbytes, peak):
    b_ms, b_by = bound_ms(flops, nbytes, peak)
    s = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
         "plain_elements": plain_of, "library_ms": lib_ms,
         "library": library, "bound_ms": b_ms, "bound_by": b_by,
         "flops": flops, "bytes": nbytes}
    return entry(name, dtype, source, RG + line, path, s, worst), s


def phase_ragged_potrf(seed, results):
    """ragged_potrf, f32 and bf16: the adversarial suite (garbage pads,
    orders 1 ... ceiling), then the serving stream's first flush
    (64 elements, ceiling 608) and the flush that holds its largest
    order (ceiling 1024, the gate's largest): kernel against plain (on
    four elements of the flush, its largest among them), the factor's
    residual, times, and the library Cholesky of the identity-padded
    stack."""
    ok, out = True, {"phase": "kernel.ragged_potrf"}
    cases = ragged_cases(np.random.default_rng(31))
    flushes = (("first", 0), ("largest", largest_flush(seed)))
    for dname, dtype in DTYPES:
        st, sz = cases["potrf"]
        a = to_card(st, dtype)
        kp = pk.ragged_potrf(a, sz)
        pp = pk.ragged_potrf_plain(a, sz, pk.ragged_blk())
        torch.cuda.synchronize()
        a_ok, a_err, a_pad = ragged_compare(dtype, kp, pp, sz)
        ok &= a_ok
        out[dname] = {"adversarial": {"err": a_err, "pad_bitwise": a_pad,
                                      "ok": a_ok}}
        for label, flush in flushes:
            sizes, ceil, spd, _gen, _rhs = path_stacks(seed, flush)
            sub = plain_subset(sizes)
            a = to_card(spd, dtype)
            szc = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            kp = pk.ragged_potrf(a, szc)
            pp = pk.ragged_potrf_plain(a[sub], [sizes[i] for i in sub],
                                       pk.ragged_blk())
            p_ok, p_err, p_pad = ragged_compare(dtype, kp[sub], pp,
                                                [sizes[i] for i in sub])
            res = max(float(torch.linalg.norm(
                (kp[i, :s, :s].double() @ kp[i, :s, :s].double().T)
                - a[i, :s, :s].double()) / torch.linalg.norm(
                    a[i, :s, :s].double())) for i, s in enumerate(sizes))
            res_ok = res <= (1e-6 if dtype == torch.float32 else 2e-2)
            ok &= p_ok and res_ok
            ms = cuda_ms(lambda: pk.ragged_potrf(a, szc), 5)
            a4 = a[sub]
            plain_ms = cuda_ms(lambda: pk.ragged_potrf_plain(
                a4, [sizes[i] for i in sub], pk.ragged_blk()), 1)
            aid = identity_padded(a, sizes).float()
            lib_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(aid), 5)
            del aid
            live2 = sum(s * s for s in sizes)
            row, s = ragged_row(
                "ragged_potrf", dname, "ragged_potrf.cu", "1147",
                "batch.serve (ragged potrf)" if dtype == torch.float32
                else "batch.serve (ragged bf16 posv)",
                "%dx%dx%d" % a.shape, max(a_err, p_err), ms, plain_ms,
                len(sub), lib_ms,
                "torch.linalg.cholesky_ex (identity pad, f32)",
                sum(s ** 3 for s in sizes) / 3.0,
                a.element_size() * (live2 + a.numel()) + 4.0 * len(sizes),
                PEAK_F32_FLOPS if dtype == torch.float32
                else PEAK_BF16_FLOPS)
            key = "ragged_potrf." + dname
            results[key if label == "first" else key + "." + str(ceil)] = \
                row
            out[dname][label] = dict(s, err=p_err, pad_bitwise=p_pad,
                                     residual=res, ok=p_ok and res_ok)
            del a, kp
    out["ok"] = bool(ok)
    return out


def compose_swaps_stack(piv, m, results, suffix=""):
    """The batched compose_swaps (one launch for the stack, one sorting
    block a sequence) on the ragged gesv's own swap targets: bitwise
    equal to the plain version, timed, and its row of the kernels
    line (key suffix `suffix`)."""
    s = compose_row(piv, m, plain_reps=3)
    results["compose_swaps.batched" + suffix] = entry(
        "compose_swaps", "int32", "compose_swaps.cu",
        "slate_tpu/batch/drivers.py:389 (XLA lu_pivots_to_permutation "
        "under vmap)", "batch.serve (ragged gesv)", s,
        0.0 if s["bitwise"] else None)
    return dict(s, ok=s["bitwise"])


def ragged_lu_latency_ms(s_max, cols=None):
    """The ragged LU's latency floor: its largest element's s_max
    dependent columns (or `cols` of them), each an argmax tree over the
    column (ceil(log2 s_max) compare-selects), the pivot's broadcast, a
    divide, a product and a difference, DEP_OP_CYCLES each."""
    steps = int(np.ceil(np.log2(max(s_max, 2)))) + 4
    return latency_ms(s_max if cols is None else cols,
                      steps * DEP_OP_CYCLES)


def ragged_getrf_cluster(n):
    """Blocks of the ragged LU kernel's cluster at ceiling n, as its
    launch takes them (the kernel's library says)."""
    return _build.load("ragged_getrf").ragged_getrf_cluster(n)


def getrf_adversarial(dtype, st, sz):
    """One ragged LU suite (garbage pads) against the plain version:
    pivots bitwise, values by ragged_compare (pads bitwise)."""
    a = to_card(st, dtype)
    kl, kpv = pk.ragged_getrf(a, sz)
    pl, ppv = pk.ragged_getrf_plain(a, sz, pk.ragged_blk())
    torch.cuda.synchronize()
    piv = bool(torch.equal(kpv, ppv))
    ok, err, pad = ragged_compare(dtype, kl, pl, sz)
    return {"ceiling": a.shape[-1], "cluster": ragged_getrf_cluster(
                a.shape[-1]), "pivots_bitwise": piv, "err": err,
            "pad_bitwise": pad, "ok": ok and piv}


def phase_ragged_getrf(seed, results):
    """ragged_getrf, f32 and bf16: the adversarial suites (ceiling 64:
    pivots across elements, a zero column, order 1, exact ties, garbage
    pads; ceiling 384, wide enough for a cluster of several blocks an
    element), then the serving stream's first flush (64 x 608^2) and
    the flush that holds its order-1024 request (64 x 1024^2) as the
    ragged gesv stacks them: pivots and pads bitwise, values against the
    plain version on four elements, times (back to back and replayed
    from a CUDA graph), the latency floor, and the library LU of the
    identity-padded stack; each f32 flush's swap targets ((64, 608), then
    (64, 1024)) then go through the batched compose_swaps, as the ragged
    gesv sends them."""
    ok, out = True, {"phase": "kernel.ragged_getrf"}
    cases = ragged_cases(np.random.default_rng(32))
    wide = ragged_getrf_wide_case(np.random.default_rng(33))
    flushes = (("first", 0), ("largest", largest_flush(seed)))
    for dname, dtype in DTYPES:
        adv = [getrf_adversarial(dtype, *cases["getrf"]),
               getrf_adversarial(dtype, *wide)]
        ok &= all(r["ok"] for r in adv)
        out[dname] = {"adversarial": adv}
        worst = max(r["err"] for r in adv)
        for label, flush in flushes:
            sizes, ceil, _spd, gen, _rhs = path_stacks(seed, flush)
            sub = plain_subset(sizes)
            a = to_card(gen, dtype)
            szc = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            kl, kpv = pk.ragged_getrf(a, szc)
            pl, ppv = pk.ragged_getrf_plain(a[sub], [sizes[i] for i in sub],
                                            pk.ragged_blk())
            p_piv = bool(torch.equal(kpv[sub], ppv))
            p_ok, p_err, p_pad = ragged_compare(dtype, kl[sub], pl,
                                                [sizes[i] for i in sub])
            ok &= p_ok and p_piv
            call = lambda: pk.ragged_getrf(a, szc)
            ms = cuda_ms(call, 5)
            g_ms, g_err = try_graph_ms(call, 5)
            a4 = a[sub]
            plain_ms = cuda_ms(lambda: pk.ragged_getrf_plain(
                a4, [sizes[i] for i in sub], pk.ragged_blk()), 1)
            aid = identity_padded(a, sizes).float()
            lib_ms = cuda_ms(lambda: torch.linalg.lu_factor_ex(aid), 5)
            del aid
            live2 = sum(s * s for s in sizes)
            row, s = ragged_row(
                "ragged_getrf", dname, "ragged_getrf.cu", "1263",
                "batch.serve (ragged gesv)", "%dx%dx%d" % a.shape,
                max(worst, p_err), ms, plain_ms, len(sub), lib_ms,
                "torch.linalg.lu_factor_ex (identity pad, f32"
                + (" upcast)" if dtype != torch.float32 else ")"),
                2.0 / 3.0 * sum(s ** 3 for s in sizes),
                a.element_size() * (live2 + a.numel()) + 4.0 * a.shape[0]
                * (1 + ceil),
                PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS)
            s.update(graph_ms=g_ms, graph_error=g_err,
                     latency_bound_ms=ragged_lu_latency_ms(max(sizes)),
                     cluster=ragged_getrf_cluster(ceil))
            row.update(graph_ms=g_ms, latency_bound_ms=s["latency_bound_ms"])
            if dtype == torch.float32:
                key = "ragged_getrf." + dname
                results[key if label == "first" else key + "." + str(ceil)] \
                    = row
                out["compose_swaps." + label] = compose_swaps_stack(
                    kpv, ceil, results,
                    "" if label == "first" else "." + str(ceil))
                ok &= out["compose_swaps." + label]["ok"]
            out[dname][label] = dict(s, pivots_bitwise=p_piv, err=p_err,
                                     pad_bitwise=p_pad, ok=p_ok and p_piv)
            del a, kl
    out["ok"] = bool(ok)
    return out


TRSM_MODES = [(u, t, d) for u in (False, True) for t in (False, True)
              for d in (False, True)]
#: the (upper, trans, unit) modes the ragged posv / gesv compositions
#: run: posv L then L^T, gesv unit L then U
TRSM_PATH_MODES = ((False, False, False), (False, True, False),
                   (False, False, True), (True, False, False))


def trsm_bounds(sizes, b):
    """The ragged solve's bounds over a flush: operations (s^2 K each)
    or bytes (each element's live triangle, its live right-hand-side
    rows read, the whole (N, K) solution written, the sizes), and the
    latency of the largest element's s dependent rows, each a
    product-add, a subtract, a divide and a broadcast."""
    K, el = b.shape[-1], b.element_size()
    tri = sum(s * (s + 1) // 2 for s in sizes)
    nbytes = el * (tri + K * sum(sizes) + b[0].numel() * len(sizes)) \
        + 4.0 * len(sizes)
    b_ms, b_by = bound_ms(float(K * sum(s * s for s in sizes)), nbytes)
    return {"bound_ms": b_ms, "bound_by": b_by,
            "latency_bound_ms": latency_ms(4 * max(sizes), DEP_OP_CYCLES)}


def trsm_library(Tid, b32, up, tr, un):
    """One library call of a ragged solve mode: solve_triangular on the
    identity-padded factors Tid (f32) and right-hand sides b32."""
    A = Tid.mT if tr else Tid
    return lambda: torch.linalg.solve_triangular(
        A, b32, upper=up != tr, unitriangular=un)


def phase_ragged_trsm(seed, results):
    """ragged_trsm, f32 and bf16: all eight (upper, trans, unit) modes
    on the adversarial suite (garbage pads, orders 17 ... ceiling, 3
    right-hand sides), then the four modes the compositions run on the
    serving stream's first flush and on the flush that holds its
    order-1024 request (the factors from ragged_potrf, one right-hand
    side): against the plain version, times back to back and replayed
    from a CUDA graph, and the library solve on the identity-padded
    factors."""
    ok, out = True, {"phase": "kernel.ragged_trsm"}
    cases = ragged_cases(np.random.default_rng(33))
    flushes = (("first", 0), ("largest", largest_flush(seed)))
    for dname, dtype in DTYPES:
        modes, worst = {}, 0.0
        for up, tr, un in TRSM_MODES:
            st, sz, b = cases["trsm_upper" if up else "trsm_lower"]
            t, bb = to_card(st, dtype), to_card(b, dtype)
            kx = pk.ragged_trsm(t, bb, sz, upper=up, trans=tr, unit=un)
            px = pk.ragged_trsm_plain(t, bb, sz, pk.ragged_blk(), up, tr, un)
            torch.cuda.synchronize()
            err = scaled_err(kx, px)
            zero_pad = all(bool((kx[i, s:] == 0).all())
                           for i, s in enumerate(sz))
            m_ok = err <= RAGGED_LIMIT[dtype] and zero_pad
            ok &= m_ok
            worst = max(worst, err)
            modes["%d%d%d" % (up, tr, un)] = {"err": err, "ok": m_ok}
        paths = {}
        for fname, f in flushes:
            sizes, ceil, spd, _gen, rhs = path_stacks(seed, f)
            sub = plain_subset(sizes)
            szc = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            L = pk.ragged_potrf(to_card(spd, dtype), szc)
            U = L.mT.contiguous()
            b = to_card(rhs, dtype)
            Lid = identity_padded(L, sizes).float()
            Uid, b32 = Lid.mT.contiguous(), b.float()
            rows = {}
            for up, tr, un in TRSM_PATH_MODES:
                T, Tid = (U, Uid) if up else (L, Lid)
                kx = pk.ragged_trsm(T, b, szc, upper=up, trans=tr, unit=un)
                px = pk.ragged_trsm_plain(T[sub], b[sub],
                                          [sizes[i] for i in sub],
                                          pk.ragged_blk(), up, tr, un)
                err = scaled_err(kx[sub], px)
                zero_pad = all(bool((kx[i, s:] == 0).all())
                               for i, s in enumerate(sizes))
                ok &= err <= RAGGED_LIMIT[dtype] and zero_pad
                worst = max(worst, err)
                run = (lambda: pk.ragged_trsm(T, b, szc, upper=up,
                                              trans=tr, unit=un))
                g_ms, g_err = try_graph_ms(run)
                lib = trsm_library(Tid, b32, up, tr, un)
                lib_g, _ = try_graph_ms(lib)
                rows["%d%d%d" % (up, tr, un)] = {
                    "err": err, "zero_pad": zero_pad,
                    "eager_ms": cuda_ms(run, 20), "graph_ms": g_ms,
                    "graph_error": g_err, "library_ms": cuda_ms(lib, 20),
                    "library_graph_ms": lib_g}
            T4, b4 = L[sub], b[sub]
            plain_ms = cuda_ms(lambda: pk.ragged_trsm_plain(
                T4, b4, [sizes[i] for i in sub], pk.ragged_blk()), 1)
            first = rows["000"]
            s = {"shape": "%dx%dx%d, K = 1, lower" % L.shape,
                 "ms": first["graph_ms"] if first["graph_ms"] is not None
                 else first["eager_ms"],
                 "eager_ms": first["eager_ms"],
                 "graph_ms": first["graph_ms"], "plain_ms": plain_ms,
                 "plain_elements": len(sub),
                 "library_ms": first["library_ms"],
                 "library_graph_ms": first["library_graph_ms"],
                 "library": "torch.linalg.solve_triangular (identity pad, "
                            "f32)",
                 "modes": rows, **trsm_bounds(sizes, b)}
            paths[fname] = s
            if fname == "first":
                results["ragged_trsm." + dname] = entry(
                    "ragged_trsm", dname, "ragged_trsm.cu", RG + "1418",
                    "batch.serve (ragged posv)" if dtype == torch.float32
                    else "batch.serve (ragged bf16 posv)", s, worst)
        out[dname] = {"adversarial": modes, "paths": paths, "worst": worst}
    out["ok"] = bool(ok)
    return out


def serve_run(op, mats, rhss, strategy, max_batch=SERVE_BATCH):
    """One pass of `mats` (and `rhss`) through a fresh queue (max_wait
    0, flushed at max_batch and at the end), after a synchronise: the
    CPU results, the record the reference's bench prints, and the
    launch counts of the pass."""
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    with batch.CoalescingQueue(max_batch=max_batch, max_wait_us=0,
                               strategy=strategy) as q:
        ts = [q.submit(op, a) for a in mats] if rhss is None \
            else [q.submit(op, a, b) for a, b in zip(mats, rhss)]
        q.flush()
        outs = [t.result() for t in ts]
    wall = time.perf_counter() - t0
    launches = pk.launch_counts()
    lats = sorted(t.latency_s for t in ts)
    s = q.stats()
    n = len(ts)
    return outs, {"wall_s": wall, "matrices_per_s": n / wall,
                  "p50_ms": lats[n // 2] * 1e3,
                  "p99_ms": lats[min(int(n * 0.99), n - 1)] * 1e3,
                  "dispatches": s["dispatches"],
                  "mean_occupancy": s["mean_occupancy"],
                  "mean_padding_waste_flops":
                      s["mean_padding_waste_flops"],
                  "mean_occupancy_weighted": s["mean_occupancy_weighted"],
                  "ragged_dispatches": s["ragged_dispatches"],
                  "launches": {k: v for k, v in launches.items() if v}}, \
        launches


def chol_berr(L, a):
    """||L L^T - A||_F / ||A||_F in f64 on the card."""
    L, a = L.cuda().double(), torch.as_tensor(a, device="cuda").double()
    return float(torch.linalg.norm(L @ L.T - a) / torch.linalg.norm(a))


def solve_berr(x, a, b):
    """||A x - b||_F / (||A||_F ||x||_F) in f64 on the card."""
    x = x.cuda().double()
    a = torch.as_tensor(a, device="cuda").double()
    b = torch.as_tensor(b, device="cuda").double()
    return float(torch.linalg.norm(a @ x - b)
                 / (torch.linalg.norm(a) * torch.linalg.norm(x)))


def rel(x, ref):
    return float(torch.linalg.norm((x.double() - ref.double()))
                 / torch.linalg.norm(ref.double()))


def phase_batch_serve(seed, results, system):
    """The batch layer's serving path: the reference's stream (256 f32
    SPD requests, n lognormal around 180 clipped to [64, 1024]) as
    potrf through CoalescingQueue(max_batch=64, max_wait_us=0) under
    the bucket and then the ragged strategy, each after a warm-up pass;
    then posv and gesv with one right-hand side on the first 64
    requests under both, and a bf16 posv leg on the ragged route."""
    sizes, xs, spds = serve_stream(seed, SERVE_REQS)
    out = {"phase": "batch.serve", "requests": SERVE_REQS,
           "n_range": [min(sizes), max(sizes)],
           "n_median": float(np.median(sizes))}
    ok = True
    recs, outs = {}, {}
    for strategy in ("bucket", "ragged"):
        serve_run("potrf", spds, None, strategy)              # warm-up
        o, rec, launches = serve_run("potrf", spds, None, strategy)
        berr = max(chol_berr(L, a) for L, a in zip(o, spds))
        rec["max_backward_error"] = berr
        ok &= berr <= 1e-6 and (launches["ragged_potrf"] > 0) \
            == (strategy == "ragged")
        if strategy == "ragged":
            set_launches(results, "batch.serve (ragged potrf)", launches)
        recs["potrf." + strategy], outs["potrf." + strategy] = rec, o
    diff = max(rel(r, b) for r, b in zip(outs["potrf.ragged"],
                                         outs["potrf.bucket"]))
    ok &= diff <= 1e-5
    out["potrf"] = {"bucket": recs["potrf.bucket"],
                    "ragged": recs["potrf.ragged"],
                    "ragged_vs_bucket": diff}
    rng = np.random.default_rng(seed + 1)
    leg = slice(0, SERVE_LEG)
    b1 = [rng.standard_normal((n, 1)).astype(np.float32)
          for n in sizes[leg]]
    gens = [x / np.float32(np.sqrt(n))
            + np.float32(2.0 * np.sqrt(n)) * np.eye(n, dtype=np.float32)
            for n, x in zip(sizes[leg], xs[leg])]
    for op, mats, need in (("posv", spds[leg], ("ragged_potrf",
                                                 "ragged_trsm")),
                           ("gesv", gens, ("ragged_getrf", "ragged_trsm",
                                           "compose_swaps"))):
        rep = {}
        for strategy in ("bucket", "ragged"):
            serve_run(op, mats, b1, strategy)                 # warm-up
            o, rec, launches = serve_run(op, mats, b1, strategy)
            berr = max(solve_berr(x, a, b) for x, a, b in zip(o, mats, b1))
            rec["max_backward_error"] = berr
            ok &= berr <= 1e-6
            if strategy == "ragged":
                ok &= all(launches[k] > 0 for k in need)
                set_launches(results, "batch.serve (ragged %s)" % op,
                             launches)
                system.setdefault("serve_launches", {})[op] = launches
            rep[strategy], outs[op + "." + strategy] = rec, o
        rep["ragged_vs_bucket"] = max(
            rel(r, b) for r, b in zip(outs[op + ".ragged"],
                                      outs[op + ".bucket"]))
        ok &= rep["ragged_vs_bucket"] <= 1e-5
        out[op] = rep
    mb = [torch.as_tensor(a).bfloat16() for a in spds[leg]]
    bb = [torch.as_tensor(b).bfloat16() for b in b1]
    serve_run("posv", mb, bb, "ragged")                       # warm-up
    o, rec, launches = serve_run("posv", mb, bb, "ragged")
    set_launches(results, "batch.serve (ragged bf16 posv)", launches)
    rec["max_rel_err_vs_f32"] = max(
        rel(x.float(), r) for x, r in zip(o, outs["posv.ragged"]))
    rec["limit"] = BF16_POSV_LIMIT
    ok &= rec["max_rel_err_vs_f32"] <= BF16_POSV_LIMIT \
        and all(x.dtype == torch.bfloat16 for x in o) \
        and launches["ragged_potrf"] > 0 and launches["ragged_trsm"] > 0
    out["posv_bf16_ragged"] = rec
    # the reference's determinism contract, reported: a flush of batch
    # 1 against the coalesced flush, bitwise, on the first 8 requests
    det = {}
    for strategy in ("bucket", "ragged"):
        ones, _, _ = serve_run("potrf", spds[:8], None, strategy,
                               max_batch=1)
        det[strategy] = all(bool(torch.equal(a, b)) for a, b in
                            zip(ones, outs["potrf." + strategy][:8]))
    out["batch1_bitwise_vs_coalesced"] = det
    # the background flusher issues the dispatches from its own thread:
    # 8 requests left to its 2 ms deadline on the ragged route
    with batch.CoalescingQueue(max_batch=SERVE_BATCH, max_wait_us=2000,
                               background=True, strategy="ragged") as q:
        ts = [q.submit("potrf", a) for a in spds[:8]]
        deadline = time.perf_counter() + 60
        while not all(t.done() for t in ts) \
                and time.perf_counter() < deadline:
            time.sleep(0.01)
        flushed = all(t.done() for t in ts)
    bg_err = max(rel(t.result(), r) for t, r in
                 zip(ts, outs["potrf.ragged"][:8]))
    out["background_flusher"] = {"flushed_by_deadline": flushed,
                                 "rel_err_vs_coalesced": bg_err}
    ok &= flushed and bg_err <= 1e-5
    system["serve_posv"] = (spds[leg], b1)
    system["serve_gesv"] = (gens, b1)
    out["ok"] = bool(ok)
    return out


# -- the spectral divide & conquer eigensolver --------------------------------

N_POLAR = 4096
N_DC, LEAF_DC = 8192, 256
N_ADVICE = 48
#: the ADVICE diagonals' polar factor against diag(sign(d)): the
#: reference tests' limit (tests/test_tune.py)
ADVICE_LIMIT = 5e-5
#: max |U^T U - I| of the polar factor at N_POLAR, f32
POLAR_ORTH_LIMIT = 5e-5
#: eigh_dc's eigenvalues against eigvalsh in f64, relative to ||H||_2:
#: the staged eigensolvers' f32 limit (ROADMAP queue 3), 4 n eps
DC_EIG_LIMIT = 4.0 * N_DC * float(torch.finfo(torch.float32).eps)
#: residual and orthogonality of the library eigensolver through
#: blocked.library_eigh at the leaves' orders, f32 (LAPACK on the CPU
#: gives ~1e-6; cuSOLVER's syevj, PyTorch's f32 route at orders 32-512
#: on the card, ~1e-4)
LEAF_EIGH_LIMIT = 1e-5
LEAF_EIGH_CASES = ((1, 64), (1, 256), (1, 512), (64, 32))
#: ||H V - V diag(w)||_F / ||H||_F and max |V^T V - I| of eigh_dc in
#: f32: ten times what it gives on the CPU at n = 1024 and 2048 (4.0e-6
#: / 1.7e-6 and 3.4e-6 / 1.6e-6, flat in n)
DC_RESID_LIMIT = 5e-5
DC_ORTH_LIMIT = 5e-5


def advice_diagonal(case, n=N_ADVICE):
    """tests/test_tune.py's two ADVICE cases: a singular value at the
    capped-weight dip, and clustered tiny ones."""
    if case == "dip":
        d = np.linspace(0.5, 1.0, n).astype(np.float32)
        d[0], d[1] = 0.12, -0.12
    else:
        d = np.full(n, 1e-4, np.float32)
        d[n // 2:] = 1.0
        d[::2] *= -1.0
    return d


def phase_spectral_dc(seed):
    from slate_tpu_torch.linalg import polar as tpolar
    from slate_tpu_torch.linalg import spectral_dc as sdc
    from slate_tpu_torch.obs import events as obs_events
    from slate_tpu_torch.obs import metrics as obs_metrics
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 14)
    out = {"phase": "spectral_dc"}
    # the polar factor of a Gaussian
    x = torch.randn(N_POLAR, N_POLAR, generator=g, device="cuda")
    tpolar.polar_unitary(x[:512, :512])                  # warm-up
    wall, (u, k, conv) = wall_s(lambda: tpolar.polar_unitary(x))
    u64 = u.double()
    orth = float((u64.T @ u64 - torch.eye(N_POLAR, dtype=torch.float64,
                                          device="cuda")).abs().max())
    out["polar"] = {"n": N_POLAR, "iterations": k, "converged": conv,
                    "orth_max": orth, "limit": POLAR_ORTH_LIMIT,
                    "ms": wall * 1e3}
    ok = conv and orth <= POLAR_ORTH_LIMIT
    del x, u, u64
    adv = {}
    for case in ("dip", "clustered"):
        d = advice_diagonal(case)
        u, k, conv = tpolar.polar_unitary(np.diag(d))
        err = float((u.cpu() - torch.diag(torch.sign(torch.as_tensor(d))))
                    .abs().max())
        adv[case] = {"iterations": k, "converged": conv, "err": err}
        ok &= conv and err <= ADVICE_LIMIT
    out["advice"] = dict(adv, limit=ADVICE_LIMIT)
    # the leaves' eigensolver: the library's f32 route against the
    # port's (f64 where that route is syevj)
    from slate_tpu_torch.linalg.blocked import library_eigh
    leaves = {}
    for batch_, n in LEAF_EIGH_CASES:
        x = torch.randn(batch_, n, n, generator=g, device="cuda")
        a = 0.5 * (x + x.mT)
        a64 = a.double()
        eye = torch.eye(n, dtype=torch.float64, device="cuda")
        row = {}
        for name, fn in (("torch.linalg.eigh", torch.linalg.eigh),
                         ("library_eigh", library_eigh)):
            w, v = fn(a)
            v64 = v.double()
            row[name] = {
                "residual": float((torch.linalg.norm(
                    a64 @ v64 - v64 * w.double()[:, None, :], dim=(1, 2))
                    / torch.linalg.norm(a64, dim=(1, 2))).max()),
                "orth_max": float((v64.mT @ v64 - eye).abs().max())}
        leaves["%dx%d" % (batch_, n)] = row
        ok &= max(row["library_eigh"].values()) <= LEAF_EIGH_LIMIT
    out["leaf_eigh"] = dict(leaves, limit=LEAF_EIGH_LIMIT)
    # the eigensolver at full width
    x = torch.randn(N_DC, N_DC, generator=g, device="cuda")
    h = 0.5 * (x + x.T)
    del x
    sdc.eigh_dc(h[:1024, :1024], leaf=LEAF_DC)           # warm-up
    stats = {}
    wall, (w, v, dc_ok) = wall_s(lambda: sdc.eigh_dc(h, leaf=LEAF_DC,
                                                     stats=stats))
    wall_eigh, _ = wall_s(lambda: torch.linalg.eigh(h))
    h64 = h.double()
    w_ref = torch.linalg.eigvalsh(h64)
    hn2 = float(w_ref.abs().max())
    eig_err = float((w.double() - w_ref).abs().max()) / hn2
    del w_ref
    v64 = v.double()
    resid = float(torch.linalg.norm(h64 @ v64 - v64 * w.double())
                  / torch.linalg.norm(h64))
    del h64
    orth = float((v64.T @ v64 - torch.eye(N_DC, dtype=torch.float64,
                                          device="cuda")).abs().max())
    del v64
    ascending = bool((w[1:] >= w[:-1]).all())
    out["eigh_dc"] = {
        "n": N_DC, "leaf": LEAF_DC, "dtype": "float32", "ok": dc_ok,
        "ascending": ascending, "eig_err_rel": eig_err,
        "eig_limit": DC_EIG_LIMIT, "residual": resid,
        "residual_limit": DC_RESID_LIMIT, "orth_max": orth,
        "orth_limit": DC_ORTH_LIMIT, "wall_s": wall,
        "eigh_wall_s": wall_eigh, "wall_over_eigh": wall / wall_eigh,
        **stats}
    ok &= dc_ok and ascending and eig_err <= DC_EIG_LIMIT \
        and resid <= DC_RESID_LIMIT and orth <= DC_ORTH_LIMIT
    # the opt-in check, with obs on
    prev = os.environ.get(sdc.CHECK_POLAR_ENV)
    os.environ[sdc.CHECK_POLAR_ENV] = "1"
    obs_metrics.reset()
    obs_events.enable()
    try:
        read = sdc.check_polar(dc_ok)
        unconverged = obs_metrics.snapshot()["counters"].get(
            "polar.unconverged", 0)
    finally:
        obs_events.disable()
        obs_events.clear()
        obs_metrics.reset()
        if prev is None:
            os.environ.pop(sdc.CHECK_POLAR_ENV)
        else:
            os.environ[sdc.CHECK_POLAR_ENV] = prev
    out["check_polar"] = {"read": read, "polar.unconverged": unconverged}
    ok &= read is True and unconverged == 0
    out["ok"] = bool(ok)
    return out


# -- obs and resil around the serving path ------------------------------------

#: gesv at N timed with obs off and on, alternately, this many times each
OBS_REPS = 3


def obs_all(on):
    """The bus (and metrics), the flight recorder, request traces and
    series, all on or all off."""
    from slate_tpu_torch.obs import events, ledger, reqtrace, series
    for mod in (events, ledger, reqtrace, series):
        (mod.enable if on else mod.disable)()


def phase_obs_resil(seed, results, system):
    from slate_tpu_torch import obs
    from slate_tpu_torch.obs import (events, export, ledger, metrics,
                                     reqtrace, series, xprof)
    from slate_tpu_torch.resil import faults, guard
    spds, b1 = system["serve_posv"]
    gens, _ = system["serve_gesv"]
    reqs = [("posv", a, b) for a, b in zip(spds, b1)] \
        + [("gesv", a, b) for a, b in zip(gens, b1)]
    serve = system["serve_launches"]
    want = {k: serve["posv"][k] + serve["gesv"][k]
            for k in ("ragged_potrf", "ragged_getrf", "ragged_trsm",
                      "compose_swaps")}
    out = {"phase": "obs.resil", "requests": len(reqs)}
    for mod in (ledger, reqtrace, series):
        mod.reset()
    events.clear()
    metrics.reset()
    guard.reset_counts()
    obs_all(True)

    def run(tenant):
        led0 = len(ledger.records("batch.dispatch"))
        span0 = len(reqtrace.spans(reqtrace.REQUEST_SPAN))
        torch.cuda.synchronize()
        pk.reset_launch_counts()
        with batch.CoalescingQueue(max_batch=SERVE_BATCH, max_wait_us=0,
                                   strategy="ragged") as q:
            ts = [q.submit(op, a, b, trace=reqtrace.begin(tenant=tenant,
                                                          op=op))
                  for op, a, b in reqs]
            q.flush()
            outs = [t.result() for t in ts]
        launches = pk.launch_counts()
        req = reqtrace.spans(reqtrace.REQUEST_SPAN)[span0:]
        return outs, {
            "dispatches": q.stats()["dispatches"],
            "ledger_records": len(ledger.records("batch.dispatch")) - led0,
            "spans": len(req),
            "spans_with_flush": sum(1 for sp in req
                                    if "flush_id" in sp.args),
            "launches": {k: v for k, v in launches.items() if v}}

    ok = True
    clean, rec_clean = run("clean")
    plan = faults.install(faults.FaultPlan(
        [{"site": "batch", "after": 1, "times": 1, "kind": "error"}]))
    try:
        faulted, rec_fault = run("faulted")
    finally:
        faults.clear()
    counts = guard.counts()
    bitwise = all(torch.equal(a, b) for a, b in zip(faulted, clean))
    rec_fault["fired"] = plan.fired()
    rec_fault["injections"] = plan.log()
    rec_fault["guard_counts"] = counts
    for rec in (rec_clean, rec_fault):
        ok &= rec["dispatches"] == rec["ledger_records"] == 2 \
            and rec["spans"] == rec["spans_with_flush"] == len(reqs) \
            and all(rec["launches"].get(k) == v for k, v in want.items())
    ok &= bitwise and counts == {"resil.retries": 1} and plan.fired() == 1
    add_phase_launches(results, "obs.resil", rec_clean["launches"])
    out.update(clean=rec_clean, faulted=rec_fault,
               faulted_bitwise_clean=bitwise, serve_launches=want)
    guard.reset_counts()
    qs = {t: {op: series.quantiles("serve.latency_s", t, op)
              for op in ("posv", "gesv")} for t in ("clean", "faulted")}
    ok &= all(q is not None and q["p50"] <= q["p99"]
              for per in qs.values() for q in per.values())
    out["latency_s"] = qs
    path = os.path.join(tempfile.mkdtemp(prefix="obs_trace_"),
                        "obs_resil.trace.json")
    export.write_trace(path)
    with open(path) as f:
        tr = json.load(f)["traceEvents"]
    phs = sorted({e["ph"] for e in tr})
    out["trace"] = {"events": len(tr), "phases": phs}
    ok &= {"X", "i", "s", "f", "C"} <= set(phs)
    text = obs.report()
    out["report_lines"] = len(text.splitlines())
    ok &= "batch.dispatches" in text and "critical path" in text
    a4, b4 = permuted_boosted_system(np.random.default_rng(seed + 4),
                                     N_COLD, NRHS)
    A4, B4 = st.Matrix(a4, mb=NB), st.Matrix(b4, mb=NB)
    del a4, b4
    xp = xprof.analyze("gesv", st.gesv, A4, B4, {st.Option.BlockSize: NB})
    out["xprof_gesv"] = xp
    ok &= xp["peak_bytes"] is not None and xp["peak_bytes"] > 0
    del A4, B4
    obs_all(False)
    for mod in (ledger, reqtrace, series):
        mod.reset()
    events.clear()
    metrics.reset()
    xprof.clear_analyses()
    # gesv at N on phase 4's route, obs off and on alternately
    fresh_tune_cache([torch.float32])
    A, B, opts = system["A"], system["B"], system["opts"]
    st.gesv(A, B, opts)                       # warm-up
    walls = {"off": [], "on": []}
    for _ in range(OBS_REPS):
        for mode in ("off", "on"):
            obs_all(mode == "on")
            wall, _ = wall_s(lambda: st.gesv(A, B, opts))
            walls[mode].append(wall)
    obs_all(False)
    n_events = events.count()
    events.clear()
    metrics.reset()
    med = {k: float(np.median(v)) for k, v in walls.items()}
    out["gesv_obs"] = {"n": N, "wall_s": walls, "median_s": med,
                       "on_over_off": med["on"] / med["off"],
                       "events_on": n_events}
    ok &= guard.counts() == {}
    out["ok"] = bool(ok)
    return out


# -- the serving daemon (serve/) ---------------------------------------------

#: the reference's bench.py --serve-daemon repeat stream: operators of
#: order DAEMON_N (x x^T + 2 n I, f32, default_rng(7)), rounds of one
#: potrf and one posv (2 rhs) per operator
DAEMON_OPS, DAEMON_N, DAEMON_ROUNDS = 4, 128, 6
#: leg 3: the stream's first REPEAT_OPS - 1 SPD requests and its
#: largest, their general twins, rounds of one posv and one gesv each
REPEAT_OPS, REPEAT_ROUNDS = 16, 8
#: leg 3's cache: every factor of the 16 operators (~20 MB) fits
REPEAT_CACHE_MB = 256
#: cache on against cache off where a flush held other elements than
#: its twin (the kernels may split the work otherwise): relative
SERVE_SPLIT_LIMIT = 1e-5
RPC_REQS = 8


class LoggedQueue(batch.CoalescingQueue):
    """The port's queue, logging each dispatch's op and its requests'
    orders in flush order: which flushes of two runs held the same
    elements."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.log = []

    def _dispatch(self, key, entries):
        self.log.append((key[0], tuple(e[3][1] for e in entries)))
        return super()._dispatch(key, entries)


def serve_latencies(tickets, t_sub):
    """Submit-to-result seconds of each daemon request: the queue
    ticket's own latency plus the daemon's time before it (admission,
    routing)."""
    return sorted(t._inner.latency_s + (t._inner._t_submit - t0)
                  for t, t0 in zip(tickets, t_sub))


def serve_cold(spds):
    """Leg 1: the stream as potrf through Server(cache_mb=0) over a
    ragged queue, against the same queue driven directly, in turns
    (direct, daemon, daemon, direct, three times) after a warm-up of
    each; the latencies are the last daemon pass's."""
    def direct():
        with batch.CoalescingQueue(max_batch=SERVE_BATCH, max_wait_us=0,
                                   strategy="ragged") as q:
            ts = [q.submit("potrf", a) for a in spds]
            q.flush()
            return [t.result(timeout=120) for t in ts], None

    def daemon():
        q = batch.CoalescingQueue(max_batch=SERVE_BATCH, max_wait_us=0,
                                  strategy="ragged")
        srv = st.serve.Server(queue=q, cache_mb=0)
        try:
            ts, t_sub = [], []
            for a in spds:
                t_sub.append(time.perf_counter())
                ts.append(srv.submit("potrf", a))
            q.flush()
            outs = [t.result(timeout=120) for t in ts]
            return outs, serve_latencies(ts, t_sub)
        finally:
            srv.close()

    direct()                                                # warm-ups
    daemon()
    walls = {"direct": [], "daemon": []}
    outs = {}
    for name in ("direct", "daemon", "daemon", "direct") * 3:
        wall, (o, lats) = wall_s(direct if name == "direct" else daemon)
        walls[name].append(wall)
        outs.setdefault(name, o)
        if lats is not None:
            daemon_lats = lats
    n = len(spds)
    bitwise = all(torch.equal(a, b)
                  for a, b in zip(outs["daemon"], outs["direct"]))
    med = {k: float(np.median(v)) for k, v in walls.items()}
    return {"requests": n, "wall_s": walls,
            "matrices_per_s": n / med["daemon"],
            "direct_matrices_per_s": n / med["direct"],
            "p50_ms": daemon_lats[n // 2] * 1e3,
            "p99_ms": daemon_lats[min(int(n * 0.99), n - 1)] * 1e3,
            "overhead_pct": (med["daemon"] / med["direct"] - 1) * 100,
            "bitwise_direct_queue": bitwise}, bitwise


def daemon_stream(rounds, cache_mb, strategy, reqs):
    """One run of a repeat stream through Server(cache_mb) over a
    non-background LoggedQueue: per round, every (op, a, b) of
    `reqs(r)` submitted, then every result. Returns the results per
    round, the record (walls, dispatches and launches of the whole run
    and of the repeat rounds 1 ...), the queue's log split by round and
    the whole run's launch counts."""
    q = LoggedQueue(background=False, strategy=strategy)
    srv = st.serve.Server(queue=q, cache_mb=cache_mb)
    outs, logs = [], []
    try:
        torch.cuda.synchronize()
        pk.reset_launch_counts()
        t0 = time.perf_counter()
        for r in range(rounds):
            if r == 1:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                warm = q.stats()["dispatches"]
                warm_launches = pk.launch_counts()
            n0 = len(q.log)
            ts = [srv.submit(op, a, b) for op, a, b in reqs(r)]
            outs.append([t.result(timeout=120) for t in ts])
            logs.append(q.log[n0:])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = pk.launch_counts()
        s = srv.stats()
    finally:
        srv.close()
    n_req = sum(len(o) for o in outs)
    n_rep = n_req - len(outs[0])
    return outs, {"wall_s": t2 - t0, "matrices_per_s": n_req / (t2 - t0),
                  "repeat_wall_s": t2 - t1,
                  "repeat_matrices_per_s": n_rep / (t2 - t1),
                  "dispatches_total": s["queue"]["dispatches"],
                  "dispatches_repeat": s["queue"]["dispatches"] - warm,
                  "cache": s["cache"], "admission": s["admission"],
                  "launches": {k: v for k, v in launches.items() if v},
                  "launches_repeat": {
                      k: v - warm_launches.get(k, 0)
                      for k, v in launches.items()
                      if v - warm_launches.get(k, 0)}}, logs, launches


def same_flushes(off_logs, on_logs, full, pairs):
    """Per round, whether every cache-on flush of a request held the
    elements of its cache-off twin: the factor flushes of round 0 (the
    cache's factors) and the round's solve flushes each equal to `full`
    (the round's requests in order). `pairs`: cache-on factor op ->
    solve op, for the fused cache-off op."""
    factors_full = all([s for o, s in on_logs[0] if o == f] == [full]
                       for f in pairs)
    return [factors_full and all(
        [s for o, s in on_logs[r] if o == solve] == [full]
        for solve in pairs.values()) for r in range(len(on_logs))]


def split_compare(off, on, same):
    """Cache on against cache off, round by round: (bitwise in every
    round whose flushes held the same elements, the largest relative
    difference in the other rounds); the gate is both, the second within
    SERVE_SPLIT_LIMIT."""
    worst, exact = 0.0, True
    for r, (ro, rn) in enumerate(zip(off, on)):
        for a, b in zip(ro, rn):
            if same[r]:
                exact &= torch.equal(a, b)
            else:
                worst = max(worst, rel(b, a))
    return bool(exact), worst


def serve_daemon_leg():
    """Leg 2: bench.py --serve-daemon's stream, cache 0 then 64 MB."""
    rng = np.random.default_rng(7)
    operators = []
    for _ in range(DAEMON_OPS):
        x = rng.standard_normal((DAEMON_N, DAEMON_N)).astype(np.float32)
        operators.append(x @ x.T + np.float32(2.0 * DAEMON_N)
                         * np.eye(DAEMON_N, dtype=np.float32))
    rhss = [rng.standard_normal((DAEMON_N, 2)).astype(np.float32)
            for _ in range(DAEMON_ROUNDS)]

    def reqs(r):
        return [x for a in operators
                for x in (("potrf", a, None), ("posv", a, rhss[r]))]

    for mb in (0, 64):                                      # warm-ups
        daemon_stream(DAEMON_ROUNDS, mb, "bucket", reqs)
    off, rec_off, logs_off, _ = daemon_stream(DAEMON_ROUNDS, 0, "bucket",
                                              reqs)
    on, rec_on, logs_on, _ = daemon_stream(DAEMON_ROUNDS, 64, "bucket",
                                           reqs)
    full = (DAEMON_N,) * DAEMON_OPS
    same = same_flushes(logs_off, logs_on, full, {"potrf": "potrs"})
    exact, worst = split_compare(off, on, same)
    ratio = rec_off["dispatches_repeat"] / max(rec_on["dispatches_repeat"],
                                               1)
    rec = {"operators": DAEMON_OPS, "n": DAEMON_N, "rounds": DAEMON_ROUNDS,
           "cache_off": rec_off, "cache_on": rec_on,
           "repeat_dispatch_reduction": ratio,
           "rounds_same_flushes": same, "bitwise_where_same": exact,
           "max_rel_diff_other_flushes": worst,
           "limit_other_flushes": SERVE_SPLIT_LIMIT}
    ok = ratio >= 2.0 and exact and worst <= SERVE_SPLIT_LIMIT
    return rec, ok, (operators, reqs, off)


def serve_repeat_leg(sizes, spds, gens, seed):
    """Leg 3: 16 operators at the serving band's full width (the
    stream's first 15 SPD requests and its largest, with their general
    twins), rounds of one posv and one gesv (1 rhs) each, ragged, cache
    0 then a cache that holds every factor."""
    idx = list(range(REPEAT_OPS - 1)) + [int(np.argmax(sizes))]
    ops = [(spds[i], gens[i]) for i in idx]
    ns = [sizes[i] for i in idx]
    rng = np.random.default_rng(seed + 16)
    rhss = [[rng.standard_normal((n, 1)).astype(np.float32) for n in ns]
            for _ in range(REPEAT_ROUNDS)]

    def reqs(r):
        return [("posv", s, b) for (s, _g), b in zip(ops, rhss[r])] \
            + [("gesv", g, b) for (_s, g), b in zip(ops, rhss[r])]

    for mb in (0, REPEAT_CACHE_MB):                         # warm-ups
        daemon_stream(REPEAT_ROUNDS, mb, "ragged", reqs)
    off, rec_off, logs_off, launches_off = daemon_stream(
        REPEAT_ROUNDS, 0, "ragged", reqs)
    on, rec_on, logs_on, _ = daemon_stream(
        REPEAT_ROUNDS, REPEAT_CACHE_MB, "ragged", reqs)
    berr = 0.0
    for outs in (off, on):
        for r, ro in enumerate(outs):
            for x, (op, a, b) in zip(ro, reqs(r)):
                berr = max(berr, solve_berr(x, a, b))
    same = same_flushes(logs_off, logs_on, tuple(ns),
                        {"potrf": "potrs", "getrf": "getrs"})
    exact, worst = split_compare(off, on, same)
    rep = rec_on["launches_repeat"]
    hits_skip = "ragged_potrf" not in rep and "ragged_getrf" not in rep \
        and rep.get("ragged_trsm", 0) > 0
    rec = {"operators": len(ops), "orders": ns, "rounds": REPEAT_ROUNDS,
           "cache_mb": REPEAT_CACHE_MB, "cache_off": rec_off,
           "cache_on": rec_on, "max_backward_error": berr,
           "rounds_same_flushes": same, "bitwise_where_same": exact,
           "max_rel_diff_other_flushes": worst,
           "limit_other_flushes": SERVE_SPLIT_LIMIT,
           "repeat_rounds_skip_factors": hits_skip}
    ok = berr <= 1e-6 and exact and worst <= SERVE_SPLIT_LIMIT \
        and hits_skip
    return rec, ok, launches_off


def serve_drain_leg(operators, rhs):
    """Leg 4: one `batch` fault on posv and one `serve_drain` fault; the
    retry ladder absorbs both and the drain completes every ticket."""
    from slate_tpu_torch.resil import faults
    guard.reset_counts()
    try:
        plan = faults.install(faults.FaultPlan([
            {"site": "batch", "match": {"op": "posv"}, "times": 1},
            {"site": "serve_drain", "times": 1}]))
        srv = st.serve.Server(queue=batch.CoalescingQueue(background=False),
                              cache_mb=0)
        try:
            ts = [srv.submit("posv", operators[i % len(operators)], rhs)
                  for i in range(len(operators))]
            summary = srv.drain(timeout=120)
        finally:
            srv.close()
        counts = guard.counts()
        rec = dict(summary, submitted=len(ts), fired=plan.fired(),
                   guard_counts=counts)
        ok = summary["drained"] == len(ts) and summary["failed"] == 0 \
            and plan.fired() == 2 and counts == {"resil.retries": 2}
        return rec, ok
    finally:
        faults.clear()
        guard.reset_counts()


def serve_rpc_leg(spds, seed):
    """Leg 5: RPC on loopback, 8 f32 posv and 1 bf16 posv, then stats
    and metrics, against the same requests through the in-process
    Server (one request a flush in both)."""
    rng = np.random.default_rng(seed + 5)
    reqs = [(a, rng.standard_normal((a.shape[0], 1)).astype(np.float32))
            for a in spds[:RPC_REQS]]
    a0, b0 = reqs[0]
    reqs.append((torch.from_numpy(a0).bfloat16(),
                 torch.from_numpy(b0).bfloat16()))

    def server():
        return st.serve.Server(queue=batch.CoalescingQueue(
            background=False, strategy="ragged"), cache_mb=0)

    srv = server()
    try:
        ref = [srv.submit("posv", a, b).result(timeout=120)
               for a, b in reqs]
    finally:
        srv.close()
    srv = server()
    try:
        with st.serve.RpcServer(srv, host="127.0.0.1", port=0) as rs, \
                st.serve.RpcClient(rs.address) as cl:
            t0 = time.perf_counter()
            got = [cl.submit("posv", a, b) for a, b in reqs]
            wall = time.perf_counter() - t0
            stats = cl.stats()
            metrics = cl.metrics()
    finally:
        srv.close()
    bitwise = all(torch.equal(g, r) and g.dtype == r.dtype
                  for g, r in zip(got, ref))
    rec = {"requests": len(reqs), "wall_s": wall, "bitwise": bitwise,
           "bf16_dtype": str(got[-1].dtype), "stats_submitted":
           stats["submitted"], "metrics_chars": len(metrics)}
    return rec, bitwise and stats["submitted"] == len(reqs)


def serve_telemetry_leg(reqs, off):
    """Leg 6: leg 2's cache-off stream with request tracing and series
    on, in turns with it off (off, on, on, off): bitwise the untraced
    run; latency quantiles, the phase split and the overhead (medians)."""
    from slate_tpu_torch.obs import reqtrace, series
    walls = {"off": [], "on": []}
    bitwise = True
    try:
        for mode in ("off", "on", "on", "off"):
            reqtrace.reset()
            series.reset()
            for mod in (reqtrace, series):
                (mod.enable if mode == "on" else mod.disable)()
            outs, rec, _, _ = daemon_stream(DAEMON_ROUNDS, 0, "bucket",
                                            reqs)
            walls[mode].append(rec["wall_s"])
            bitwise &= all(torch.equal(a, b) for ro, rt in zip(off, outs)
                           for a, b in zip(ro, rt))
            if mode == "on":    # the last traced run's numbers
                lat, split = {}, {}
                for op in ("potrf", "posv"):
                    q = series.quantiles("serve.latency_s",
                                         tenant="default", op=op)
                    if q:
                        lat[op] = {k: v * 1e3 for k, v in q.items()}
                    for ph in ("admit_wait", "queue_wait", "dispatch",
                               "solve"):
                        sm = series.summary("serve.%s_s" % ph,
                                            tenant="default", op=op)
                        if sm:
                            split[ph] = split.get(ph, 0.0) \
                                + sm["sum"] * 1e3
                spans = reqtrace.count()
    finally:
        reqtrace.disable()
        series.disable()
        reqtrace.reset()
        series.reset()
    med = {k: float(np.median(v)) for k, v in walls.items()}
    rec = {"wall_s": walls, "overhead_pct": (med["on"] / med["off"] - 1)
           * 100, "latency_ms": lat, "phase_split_ms": split,
           "spans": spans, "bitwise_untraced": bool(bitwise)}
    return rec, bitwise and "posv" in lat and len(split) == 4


def phase_serve(seed, results):
    """The serving daemon (serve/) on the card, legs 1-6 (module doc).
    Leg 4 injects faults: its counts are checked there and cleared, so
    the phase ends with guard.counts() empty."""
    sizes, xs, spds = serve_stream(seed, SERVE_REQS)
    gens = [x / np.float32(np.sqrt(n))
            + np.float32(2.0 * np.sqrt(n)) * np.eye(n, dtype=np.float32)
            for n, x in zip(sizes, xs)]
    out = {"phase": "serve"}
    ok = True
    out["cold"], good = serve_cold(spds)
    ok &= good
    out["daemon"], good, (operators, reqs, off) = serve_daemon_leg()
    ok &= good
    out["repeat"], good, launches = serve_repeat_leg(sizes, spds, gens, seed)
    ok &= good and all(launches[k] > 0 for k in (
        "ragged_potrf", "ragged_getrf", "ragged_trsm", "compose_swaps"))
    add_phase_launches(results, "serve", launches)
    out["drain"], good = serve_drain_leg(
        operators, np.ones((DAEMON_N, 2), np.float32))
    ok &= good
    out["rpc"], good = serve_rpc_leg(spds, seed)
    ok &= good
    out["telemetry"], good = serve_telemetry_leg(reqs, off)
    ok &= good and guard.counts() == {}
    out["ok"] = bool(ok)
    return out


# -- the in-core distribution (parallel/, dist/, the grid routes) -----------

#: the grid phase's tridiagonal order and tall least-squares shape
N_GRID_TRI, M_GRID_TS, N_GRID_TS = 2048, 65536, 512
#: the four-rank leg's launch limit (seconds)
GRID_LAUNCH_TIMEOUT = 600


def grid_timed(fn):
    """(wall, result, kernel launches, collectives) of fn() after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    c0 = st.collectives.counts()
    wall, out = wall_s(fn)
    comms = st.collectives.counts_delta(c0)
    return wall, out, pk.launch_counts(), {k: v for k, v in comms.items()
                                           if v}


def grid_solves(grid, system, out):
    """gesv and posv at N on the 1 x 1 NCCL grid against their
    one-device phases: backward error, the difference from the
    one-device X, walls side by side. Returns gesv's launches."""
    o = {st.Option.Grid: grid}
    fresh_tune_cache([torch.float32])
    A, B = system["A"], system["B"]
    wall, (F, X), launches, comms = grid_timed(lambda: st.gesv(A, B, o))
    e = berr(A, X, B)
    rec = {"n": N, "nrhs": NRHS, "tiles": NB, "wall_s": wall,
           "one_device_wall_s": system["wall"], "backward_error": e,
           "x_rel_diff_one_device": rel_diff(X.data, system["X"].data),
           "pivots_equal_one_device": torch.equal(F.pivots, system["piv"]),
           "launches": {k: v for k, v in launches.items() if v},
           "collectives": comms,
           "xprof_collectives": st.obs.xprof.collective_counts()}
    ok = (e <= 1e-6 and launches["lu_panel_rec"] > 0
          and launches["compose_swaps"] > 0 and sum(comms.values()) > 0
          and bool(torch.isfinite(X.data).all()))
    out["gesv"] = rec
    SA, SB = system["SA"], system["SB"]
    wall, (L, X), plaunch, comms = grid_timed(lambda: st.posv(SA, SB, o))
    e = berr(SA, X, SB)
    out["posv"] = {"n": N, "nrhs": NRHS, "tiles": NB, "wall_s": wall,
                   "one_device_wall_s": system["posv_wall"],
                   "backward_error": e,
                   "x_rel_diff_one_device": rel_diff(X.data,
                                                     system["SX"].data),
                   "collectives": comms}
    ok &= e <= 1e-6 and bool(torch.isfinite(X.data).all())
    return ok, launches


def grid_bf16_getrf(grid, system, out):
    """A bf16 getrf at N_COLD on the grid: the rank-1 panel kernel on
    every panel (the bf16 width cap), the factor residual beside the
    one-device bf16 getrf's."""
    fresh_tune_cache()
    A32 = system["cold"][0]
    A16 = st.Matrix(A32.data.to(torch.bfloat16), mb=NB_COLD,
                    device=A32.device)
    a = A32.data[:N_COLD, :N_COLD].to(torch.bfloat16)
    wall, F, launches, _ = grid_timed(
        lambda: st.getrf(A16, {st.Option.Grid: grid}))
    wall1, F1 = wall_s(lambda: st.getrf(A16))
    res = lu_residual(a, F.LU.data[:N_COLD, :N_COLD], F.pivots[:N_COLD])
    res1 = lu_residual(a, F1.LU.data[:N_COLD, :N_COLD],
                       F1.pivots[:N_COLD])
    out["getrf_bf16"] = {"n": N_COLD, "tiles": NB_COLD, "wall_s": wall,
                         "one_device_wall_s": wall1, "residual": res,
                         "one_device_residual": res1,
                         "lu_panel_launches": launches["lu_panel"]}
    return launches["lu_panel"] > 0 and res <= max(2.0 * res1, 1e-2), \
        launches


def grid_summa(grid, seed, out):
    """summa_gemm at N on the 1 x 1 grid against torch.matmul."""
    gen = torch.Generator("cuda").manual_seed(seed + 17)
    a = torch.randn((N, N), generator=gen, device="cuda")
    b = torch.randn((N, N), generator=gen, device="cuda")
    coll = st.collectives
    wall, c, _, comms = grid_timed(lambda: coll.summa_gemm(grid, a, b))
    wall_lib, ref = wall_s(lambda: torch.matmul(a, b))
    d = rel_diff(c, ref)
    out["summa"] = {"n": N, "wall_s": wall, "torch_matmul_wall_s": wall_lib,
                    "rel_diff_matmul": d, "collectives": comms}
    del a, b, c, ref
    return d <= 1e-6


def grid_tridiagonal(grid, seed, out):
    """steqr2_qr_dist and stedc_solve_dist at N_GRID_TRI on a seeded
    tridiagonal: the row-local QR iteration bitwise the one-device
    steqr2_qr with the chain routed to its kernel (steqr_sweeps and
    givens_chain_apply launched, no collective), the distributed D&C
    against the one-device stedc_solve."""
    d, e = tridiag(np.random.default_rng(seed + 23), N_GRID_TRI)
    route_chain("steqr2", torch.float32, N_GRID_TRI)
    pk.reset_launch_counts()
    c0 = st.collectives.counts()
    wall, (w2, Z2, info) = wall_s(lambda: st.dist.steqr2_qr_dist(grid, d,
                                                                e))
    launches = pk.launch_counts()
    comms = {k: v for k, v in st.collectives.counts_delta(c0).items()
             if v}
    wall1, (w1, Z1, _) = wall_s(lambda: teig.steqr2_qr(d, e))
    bitwise = torch.equal(w1, w2) and torch.equal(Z1, Z2)
    fresh_tune_cache()
    st.stedc_solve(d, e)                      # warm-up
    walld, (wd, Vd) = wall_s(lambda: st.dist.stedc_solve_dist(grid, d, e))
    walls, (ws, Vs) = wall_s(lambda: st.stedc_solve(d, e))
    t = torch.diag(d.double()) + torch.diag(e.double(), 1) \
        + torch.diag(e.double(), -1)
    resid = float((t @ Vd.double() - Vd.double() * wd.double()[None])
                  .abs().max() / t.abs().max())
    out["steqr2_dist"] = {"n": N_GRID_TRI, "wall_s": wall,
                          "one_device_wall_s": wall1, "bitwise": bitwise,
                          "info": int(info), "collectives": comms,
                          "launches": {k: v for k, v in launches.items()
                                       if v}}
    out["stedc_dist"] = {"n": N_GRID_TRI, "wall_s": walld,
                         "one_device_wall_s": walls,
                         "w_rel_diff_one_device": rel_diff(wd, ws),
                         "residual": resid}
    ok = (bitwise and not comms and launches["steqr_sweep"] > 0
          and launches["givens_chain_apply"] > 0
          and rel_diff(wd, ws) <= 1e-6 and resid <= 1e-5)
    return ok, launches


def grid_gels_tsqr(grid, seed, out):
    """gels_tsqr at M_GRID_TS x N_GRID_TS on the grid beside the
    one-device gels: the least-squares orthogonality of both."""
    gen = torch.Generator("cuda").manual_seed(seed + 29)
    at = torch.randn((M_GRID_TS, N_GRID_TS), generator=gen, device="cuda")
    bt = torch.randn((M_GRID_TS, NRHS), generator=gen, device="cuda")
    At = st.Matrix(at, mb=NB, device=at.device)
    Bt = st.Matrix(bt, mb=NB, device=at.device)
    wall, X, _, comms = grid_timed(
        lambda: st.gels_tsqr(At, Bt, {st.Option.Grid: grid}))
    wall1, X1 = wall_s(lambda: st.gels(At, Bt))
    orth = ls_orthogonality(at, X.data[:N_GRID_TS, :NRHS], bt)
    orth1 = ls_orthogonality(at, X1.data[:N_GRID_TS, :NRHS], bt)
    out["gels_tsqr"] = {"m": M_GRID_TS, "n": N_GRID_TS, "nrhs": NRHS,
                        "wall_s": wall, "one_device_gels_wall_s": wall1,
                        "orthogonality": orth,
                        "one_device_orthogonality": orth1,
                        "collectives": comms}
    return orth <= max(2.0 * orth1, 1e-4)


def grid_four_ranks(ref1, out):
    """Leg B: four ranks on the one card under gloo (NCCL refuses two
    ranks on one GPU), testing.grid_checks suite "chip" on a 2 x 2 grid.
    Every rank's X bitwise rank 0's, within 1e-5 of the world-size-1
    result `ref1`, each rank's trailing-update FLOPs below half the
    solo run's. A lost or hung rank raises (WorkerLost, the launch
    timeout), failing the phase."""
    from slate_tpu_torch.testing import grid_checks, multiproc
    d = tempfile.mkdtemp(prefix="slate_grid_")
    try:
        t0 = time.perf_counter()
        procs, outs = multiproc.launch(
            "slate_tpu_torch.testing.grid_checks", 4,
            extra_args=["chip", "--device", "cuda:0", "--backend", "gloo"],
            outdir=d, timeout=GRID_LAUNCH_TIMEOUT)
        wall = time.perf_counter() - t0
        multiproc.assert_success(procs, outs)
        recs = [r["2x2.chip"] for r in grid_checks.load(outs)]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    keys = ("posv", "gesv", "piv", "summa")
    bitwise = all(np.array_equal(recs[0][k], r[k]) for r in recs
                  for k in keys)
    diffs = {k: float(np.linalg.norm(recs[0][k] - ref1[k].cpu().numpy())
                      / np.linalg.norm(ref1[k].cpu().numpy()))
             for k in ("posv", "gesv", "summa")}
    share = {op: max(r["flops"][op] for r in recs) / ref1["flops"][op]
             for op in ("potrf", "getrf")}
    pivots = bool(np.array_equal(recs[0]["piv"],
                                 ref1["piv"].cpu().numpy()))
    out["four_ranks"] = {"grid": "2x2", "backend": "gloo",
                         "n": grid_checks.CHIP_N,
                         "tiles": grid_checks.CHIP_NB,
                         "launch_wall_s": wall, "bitwise_rank0": bitwise,
                         "rel_diff_world_size_1": diffs,
                         "pivots_equal_world_size_1": pivots,
                         "max_rank_flops_share_of_solo": share}
    return bitwise and pivots and max(diffs.values()) <= 1e-5 \
        and max(share.values()) < 0.5


def phase_grid(seed, results, system):
    """The in-core distribution on the card. Leg A: a world of one rank
    under NCCL (file:// rendezvous), make_grid(1, 1): gesv and posv at
    N beside their one-device phases, a bf16 getrf at N_COLD (lu_panel),
    summa_gemm at N, steqr2_qr_dist (bitwise, the chain kernels) and
    stedc_solve_dist at N_GRID_TRI, gels_tsqr at M_GRID_TS x N_GRID_TS,
    and the 4096 systems of leg B on this one rank. Leg B: four ranks on
    the card (grid_four_ranks). The group is destroyed at the end."""
    import torch.distributed as tdist
    from slate_tpu_torch.testing import grid_checks
    out = {"phase": "grid"}
    rdzv = tempfile.mkdtemp(prefix="slate_grid_pg_")
    tdist.init_process_group("nccl", init_method="file://%s/store" % rdzv,
                             rank=0, world_size=1)
    try:
        grid = st.make_grid(1, 1)
        out["grid"] = repr(grid)
        st.collectives.reset_counts()
        ok, launches = grid_solves(grid, system, out)
        good, more = grid_bf16_getrf(grid, system, out)
        ok &= good
        launches = {k: launches[k] + more[k] for k in launches}
        ok &= grid_summa(grid, seed, out)
        good, more = grid_tridiagonal(grid, seed, out)
        ok &= good
        launches = {k: launches[k] + more[k] for k in launches}
        ok &= grid_gels_tsqr(grid, seed, out)
        fresh_tune_cache()
        ref1 = grid_checks.chip_run(grid)
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)
    add_phase_launches(results, "grid", launches)
    out["launches"] = {k: v for k, v in launches.items() if v}
    ok &= grid_four_ranks(ref1, out)
    out["ok"] = bool(ok)
    return out


# -- the out-of-core stream (linalg/stream.py, ooc.py, sched/) --------------

#: posv_ooc's size: 4 panels of the frozen width 8192, 4.3 GB of f32 in
#: host memory (cut from 65536, 17.2 GB, to keep the script's wall
#: under 900 s: PERF.md section 4); the SPD matrix is S = G G^T / k + I
#: with G of n x k. The cache budget of its runs that must evict (also
#: leg A of shard_ooc's), in panels: 3 of the 4 (at 2 the cache keeps
#: fewer panels and never evicts: 7 hits, 7 misses)
N_OOC, W_OOC, K_OOC = 32768, 8192, 2048
OOC_BUDGET_PANELS = 3
#: the LU, bf16 and tuner runs (4 panels), and the scheduler / fused /
#: resilience runs (8 panels of 2048)
N_OOC_LU, N_OOC_SCHED, W_OOC_SCHED = 32768, 16384, 2048
#: gels_ooc / gemm_ooc: 32768 x 16384 (cut from 65536 rows, as N_OOC),
#: panels of 4096; gemm's B 16384 x 4096
GELS_M, GELS_N, GELS_W, GEMM_N = 32768, 16384, 4096, 4096
OOC_TUNE_CANDIDATES = (4096, 8192)
#: limits: backward error, gels against the in-core gels, gemm against
#: torch.matmul (relative)
OOC_BERR, OOC_GELS, OOC_GEMM = 1e-6, 1e-4, 1e-5
#: the counters each run prints
OOC_COUNTERS = ("ooc.h2d_bytes", "ooc.d2h_bytes", "ooc.cache.hits",
                "ooc.cache.misses", "ooc.cache.evictions",
                "ooc.cache.served_bytes", "ooc.lu_invalidations",
                "ooc.cast_demote_bytes", "ooc.prefetch.issued")


def ooc_spd(gen, n, k=K_OOC):
    """S = G G^T / k + I on the card, G (n, k) Gaussian, made exactly
    symmetric ((S + S^T) / 2), so the refinement's host residual needs
    no mirrored copy. Eigenvalues in 1 + [0, (1 + sqrt(n / k))^2 k / n
    ... ]: kappa ~45 at 65536, ~26 at 32768."""
    g = torch.randn((n, k), generator=gen, device="cuda")
    s = g @ g.T
    del g
    s.div_(k)
    s.diagonal().add_(1.0)
    t = s + s.T
    del s
    return t.mul_(0.5)


def host(t):
    """A card tensor as a numpy array in host memory."""
    return t.cpu().numpy()


def ooc_berr(a_dev, x, b, rows=8192):
    """||A X - B||_F / (||A||_F ||X||_F) in f64, A on the card, X and B
    numpy; A's rows in blocks, so no f64 copy of A is made."""
    xd = torch.from_numpy(np.ascontiguousarray(x)).cuda().double()
    bd = torch.from_numpy(np.ascontiguousarray(b)).cuda().double()
    r2 = a2 = 0.0
    for i in range(0, a_dev.shape[0], rows):
        blk = a_dev[i:i + rows].double()
        r2 += float(((blk @ xd - bd[i:i + rows]) ** 2).sum())
        a2 += float((blk ** 2).sum())
    return float(np.sqrt(r2) / (np.sqrt(a2) * float(torch.linalg.norm(xd))))


def host_equal(x, y):
    """Bitwise equality of two host arrays (torch's threaded compare)."""
    return x.shape == y.shape and torch.equal(torch.from_numpy(x),
                                              torch.from_numpy(y))


def ooc_run(fn):
    """One out-of-core call with the bus and the flight recorder on:
    (host wall seconds, result, its counters and the recorder's phase
    split a driver); the drivers return host arrays, so the wall ends
    with the card's work."""
    from slate_tpu_torch.obs import events, ledger, metrics
    metrics.reset()
    ledger.reset()
    events.enable()
    ledger.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
        snap = metrics.snapshot()
        recs = ledger.records()
    finally:
        events.disable()
        events.clear()
        ledger.disable()
        ledger.reset()
    c = snap["counters"]
    rep = {k: c.get(k, 0) for k in OOC_COUNTERS}
    rep.update({k: v for k, v in c.items()
                if k.startswith("refine.ooc") or k.startswith("ooc.visit")
                or k.startswith("ooc.shard.")})
    hist = snap.get("histograms", {})
    for k in ("ooc.prefetch.overlap_fraction", "ooc.d2h.overlap_fraction",
              "refine.ooc.iters"):
        if k in hist:
            rep[k] = hist[k]
    # the flight recorder's phase split of the factor's panel steps
    steps = {}
    for r in recs:
        d = steps.setdefault(r.op, {"steps": 0, "wall_s": 0.0})
        d["steps"] += 1
        d["wall_s"] += r.wall
        for ph, t in r.phases.items():
            d[ph] = d.get(ph, 0.0) + t
    rep["ledger"] = steps
    return wall, res, rep


def free_card():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def ooc_transfers(a, reps=2):
    """The engine's transfer pieces on one stream panel (rows of a
    C-ordered host matrix `a`, its first W_OOC columns: N_OOC rows of
    32 KiB at a stride of 128 KiB): the host gather into pinned memory
    (also from never-touched zero pages), each direction's DMA, the pinned-to-strided host copy, one staged
    upload and writeback (stream._Stager) into touched and into
    fresh (first-touch) host pages, and one 1 GiB pinned allocation;
    best of `reps`, GB/s of the panel's bytes."""
    from slate_tpu_torch.linalg import stream
    view = a[:, :W_OOC]
    src = torch.from_numpy(view)
    gb = view.size * 4 / 1e9
    t0 = time.perf_counter()
    pin = torch.empty(view.shape, dtype=torch.float32, pin_memory=True)
    rec = {"pin_alloc_s": time.perf_counter() - t0}
    dev = torch.empty(view.shape, dtype=torch.float32, device="cuda")
    stg = stream._Stager(view.size * 4, dev.device)
    back = np.zeros(view.shape, np.float32)

    def best(fn, reps=reps):
        t = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t = min(t, time.perf_counter() - t1)
        return t

    rec["gather_to_pinned_s"] = best(lambda: pin.copy_(src))
    # the same gather from never-touched zero pages (the upper part of
    # a fresh host factor, which potrs_ooc's sweeps and the cached
    # loaders read): one read, since the first maps the pages
    fresh = np.zeros(view.shape, np.float32)
    rec["gather_untouched_zeros_s"] = best(
        lambda: pin.copy_(torch.from_numpy(fresh)), reps=1)
    del fresh
    rec["dma_h2d_s"] = best(lambda: dev.copy_(pin, non_blocking=True))
    rec["dma_d2h_s"] = best(lambda: pin.copy_(dev, non_blocking=True))
    rec["pinned_to_host_s"] = best(lambda: torch.from_numpy(back).copy_(pin))
    rec["staged_h2d_s"] = best(lambda: stg.h2d(view))
    rec["staged_d2h_s"] = best(lambda: stg.d2h(dev, back))
    rec["staged_d2h_fresh_pages_s"] = best(
        lambda: stg.d2h(dev, np.zeros(view.shape, np.float32)))
    rec.update({k[:-2] + "_GBps": gb / v for k, v in list(rec.items())
                if k != "pin_alloc_s"})
    del pin, dev, stg, back
    free_card()
    return {"panel_gb": gb, **rec}


def ooc_posv(seed, out):
    """Run 1: posv_ooc f32 at N_OOC, budget 0 and OOC_BUDGET_PANELS
    panels (mru, must evict): bitwise factors, backward error, beside
    the in-core posv."""
    gen = torch.Generator("cuda").manual_seed(seed + 15)
    A = ooc_spd(gen, N_OOC)
    B = torch.randn((N_OOC, NRHS), generator=gen, device="cuda")
    a, b = host(A), host(B)
    out["transfers"] = ooc_transfers(a)
    runs, ok = {}, True
    budget = OOC_BUDGET_PANELS * N_OOC * W_OOC * 4
    cached = "budget%d" % OOC_BUDGET_PANELS
    factors = {}
    for name, bud in (("budget0", 0), (cached, budget)):
        wall, (L, X), rep = ooc_run(lambda: st.posv_ooc(
            a, b, panel_cols=W_OOC, cache_budget_bytes=bud))
        e = ooc_berr(A, X, b)
        ok &= e <= OOC_BERR and bool(np.isfinite(X).all())
        runs[name] = {"budget_bytes": bud, "wall_s": wall,
                      "backward_error": e, **rep}
        factors[name] = L
        del X
    ok &= runs[cached]["ooc.cache.evictions"] > 0
    same = host_equal(factors["budget0"], factors[cached])
    ok &= same
    del factors
    # the in-core posv on the same matrix: its tiled copy replaces A on
    # the card (A, the copy and the factor would not fit beside the
    # stream's cached blocks)
    Ah = st.HermitianMatrix(st.Uplo.Lower, A, mb=NB)
    Bm = st.Matrix(B, mb=NB)
    del A, B
    free_card()
    st.posv(Ah, Bm)
    torch.cuda.synchronize()
    wall_in, (_, Xin) = wall_s(lambda: st.posv(Ah, Bm))
    e_in = ooc_berr(Ah.data, host(Xin.data[:N_OOC, :NRHS]), b)
    del Ah, Bm, Xin
    free_card()
    out["posv_ooc"] = {"n": N_OOC, "panel_cols": W_OOC, "nrhs": NRHS,
                       "runs": runs, "factors_bitwise": same,
                       "incore_posv_wall_s": wall_in,
                       "incore_backward_error": e_in,
                       "ooc_over_incore": runs["budget0"]["wall_s"]
                       / wall_in}
    return ok


def ooc_lu(seed, results, out):
    """Runs 2 and 3: gesv_ooc (partial pivoting) at N_OOC_LU with its
    panels on the recursive kernel (incore_nb 512, a tune cache routing
    every height to pallas_rec; lu_panel_rec launched exactly as
    rec_launches predicts from the panel shapes), getrf_ooc once more
    with every panel held against lu_panel_rec_plain (held_panels: the
    permuted boosted system's pivots are plain to see, so its backward
    error alone would pass a wrong pivot search) and its pivots equal to
    the timed run's; then at the default incore_nb (1024: the library),
    pivots equal to the kernel route's, beside the in-core gesv;
    getrf_tntpiv_ooc + getrs_ooc with a budget of 2 panels."""
    gen = torch.Generator("cuda").manual_seed(seed + 16)
    A, B = permuted_boosted_system(gen, N_OOC_LU, NRHS)
    a, b = host(A), host(B)
    budget = 2 * N_OOC_LU * W_OOC * 4
    ok, rec = True, {}
    fresh_tune_cache([torch.float32], top=N_OOC_LU)
    pk.reset_launch_counts()
    wall, ((lu, piv), X), rep = ooc_run(lambda: st.gesv_ooc(
        a, b, panel_cols=W_OOC, cache_budget_bytes=budget, incore_nb=512))
    launches = pk.launch_counts()
    e = ooc_berr(A, X, b)
    want = sum(rec_launches(m - 512 * i, 512, torch.float32)
               for k0 in range(0, N_OOC_LU, W_OOC)
               for m in (N_OOC_LU - k0,) for i in range(W_OOC // 512))
    ok &= e <= OOC_BERR and launches["lu_panel_rec"] == want > 0 \
        and launches["rank_update"] > 0 and launches["compose_swaps"] > 0
    add_phase_launches(results, "ooc.gesv_ooc", launches)
    rec["gesv_ooc_rec"] = {"incore_nb": 512, "wall_s": wall,
                           "backward_error": e,
                           "launches": {k: v for k, v in launches.items()
                                        if v},
                           "lu_panel_rec_predicted": want, **rep}
    del lu, X
    got = {}
    held = held_panels(lambda: got.setdefault("f", st.getrf_ooc(
        a, panel_cols=W_OOC, cache_budget_bytes=budget, incore_nb=512)))
    calls = (N_OOC_LU // W_OOC) * (W_OOC // 512)
    heights = held.pop("heights")
    held["heights"] = {"count": len(heights), "min": min(heights, default=0),
                       "max": max(heights, default=0)}
    held["calls_predicted"] = calls
    held["pivots_equal_timed"] = bool(np.array_equal(got["f"][1], piv))
    ok &= held["ok"] and held["calls"] == calls \
        and held["pivots_equal_timed"]
    rec["gesv_ooc_rec"]["held"] = held
    del got
    # the in-core gesv on the same cache (phase gesv's route)
    Am, Bm = st.Matrix(A, mb=NB), st.Matrix(B, mb=NB)
    opts = {st.Option.BlockSize: NB}
    st.gesv(Am, Bm, opts)
    wall_in, (_, Xin) = wall_s(lambda: st.gesv(Am, Bm, opts))
    rec["incore_gesv_wall_s"] = wall_in
    del Am, Bm, Xin
    free_card()
    fresh_tune_cache()
    pk.reset_launch_counts()
    wall, ((lu, piv2), X), rep = ooc_run(lambda: st.gesv_ooc(
        a, b, panel_cols=W_OOC, cache_budget_bytes=budget))
    e = ooc_berr(A, X, b)
    same = bool(np.array_equal(piv, piv2))
    ok &= e <= OOC_BERR and same and no_hand_kernel(
        {k: v for k, v in pk.launch_counts().items()
         if k in ("lu_panel_rec", "lu_panel")})
    rec["gesv_ooc_library"] = {"incore_nb": 1024, "wall_s": wall,
                               "backward_error": e,
                               "pivots_equal_rec": same, **rep}
    del lu, X
    wall, (lu, piv3), rep_f = ooc_run(lambda: st.getrf_tntpiv_ooc(
        a, panel_cols=W_OOC, cache_budget_bytes=budget))
    wall2, X, rep_s = ooc_run(lambda: st.getrs_ooc(
        lu, piv3, b, panel_cols=W_OOC, cache_budget_bytes=budget))
    e = ooc_berr(A, X, b)
    ok &= e <= OOC_BERR and rep_f["ooc.lu_invalidations"] == 0 \
        and rep_f["ooc.cache.hits"] > 0
    rec["getrf_tntpiv_ooc"] = {"wall_s": wall, "getrs_wall_s": wall2,
                               "backward_error": e, "factor": rep_f,
                               "solve": rep_s}
    del lu, X, A, B
    free_card()
    ok &= guard.counts() == {}
    out["lu"] = {"n": N_OOC_LU, "panel_cols": W_OOC, "nrhs": NRHS,
                 "budget_bytes": budget, **rec}
    return ok


def ooc_gels(seed, out):
    """Run 4: gels_ooc at GELS_M x GELS_N (panels of GELS_W) against the
    in-core gels; gemm_ooc against torch.matmul."""
    gen = torch.Generator("cuda").manual_seed(seed + 17)
    A = torch.randn((GELS_M, GELS_N), generator=gen, device="cuda")
    B = torch.randn((GELS_M, NRHS), generator=gen, device="cuda")
    a, b = host(A), host(B)
    wall, (_, X), rep = ooc_run(lambda: st.gels_ooc(a, b,
                                                    panel_cols=GELS_W))
    Am, Bm = st.Matrix(A, mb=NB), st.Matrix(B, mb=NB)
    st.gels(Am, Bm)
    wall_in, Xin = wall_s(lambda: st.gels(Am, Bm))
    xin = Xin.data[:GELS_N, :NRHS]
    d = rel_diff(torch.from_numpy(X).cuda(), xin)
    ok = d <= OOC_GELS and bool(np.isfinite(X).all())
    rec = {"m": GELS_M, "n": GELS_N, "panel_cols": GELS_W, "wall_s": wall,
           "x_rel_diff_incore": d, "incore_gels_wall_s": wall_in, **rep}
    del Am, Bm, Xin, xin, X, B
    Bg = torch.randn((GELS_N, GEMM_N), generator=gen, device="cuda")
    bg = host(Bg)
    c = np.empty((GELS_M, GEMM_N), np.float32)    # beta 0: never read
    wall_g, C, rep_g = ooc_run(lambda: st.gemm_ooc(
        1.0, a, bg, 0.0, c, row_panel=W_OOC))
    ref = A @ Bg
    dg = rel_diff(torch.from_numpy(C).cuda(), ref)
    torch.cuda.synchronize()
    wall_mm, _ = wall_s(lambda: A @ Bg)
    ok &= dg <= OOC_GEMM
    del A, Bg, ref, C
    free_card()
    out["gels"] = rec
    out["gemm"] = {"m": GELS_M, "k": GELS_N, "n": GEMM_N, "wall_s": wall_g,
                   "rel_diff_matmul": dg, "matmul_wall_s": wall_mm,
                   **rep_g}
    return ok


def panel_bytes(n, w, item, full=True):
    """Bytes of the input panels a stream stages: full columns (n x n
    in all) or potrf's lower rows (rows k0: of each panel)."""
    if full:
        return n * n * item
    return sum((n - k0) * min(w, n - k0) * item for k0 in range(0, n, w))


def ooc_bf16(seed, out):
    """Run 5: bf16 residency at N_OOC_LU: posv_ooc and gesv_ooc
    (tournament) under precision="bf16", refined by host_ir to the f32
    backward error; every revisit and solve-sweep byte staged in bf16
    (exactly half of f32's; the input panels and the rhs stay f32)."""
    n, w, item = N_OOC_LU, W_OOC, 4
    gen = torch.Generator("cuda").manual_seed(seed + 18)
    S = ooc_spd(gen, n)
    B = torch.randn((n, NRHS), generator=gen, device="cuda")
    s, b = host(S), host(B)
    rhs = n * NRHS * item
    ok, rec = True, {}
    wall, (_, X), rep = ooc_run(lambda: st.posv_ooc(s, b, panel_cols=w))
    nt = n // w
    revisit = sum(k * (n - k * w) * w * item for k in range(nt))
    f32 = panel_bytes(n, w, item, full=False) + revisit + 2 * n * n * item \
        + rhs
    ok &= rep["ooc.h2d_bytes"] == f32
    rec["posv_f32"] = {"wall_s": wall, "backward_error": ooc_berr(S, X, b),
                       "h2d_predicted": f32, **rep}
    wall, (_, X), rep = ooc_run(lambda: st.posv_ooc(
        s, b, panel_cols=w, precision="bf16"))
    e = ooc_berr(S, X, b)
    iters = int(rep["refine.ooc.iters"]["total"])
    # a bf16 solve: the f32 rhs and two sweeps of n x n bf16 panels;
    # the first, one a sweep, and host_ir's polish
    solve = n * n * item + rhs
    bf16 = panel_bytes(n, w, item, full=False) + revisit // 2 \
        + (2 + iters) * solve
    ok &= e <= OOC_BERR and rep["ooc.h2d_bytes"] == bf16
    rec["posv_bf16"] = {"wall_s": wall, "backward_error": e,
                        "h2d_predicted": bf16, "sweeps": iters, **rep}
    del S, X
    free_card()
    A, B2 = permuted_boosted_system(gen, n, NRHS)
    a, b2 = host(A), host(B2)
    wall, (_, X), rep = ooc_run(lambda: st.gesv_ooc(
        a, b2, panel_cols=w, precision="bf16"))
    e = ooc_berr(A, X, b2)
    iters = int(rep["refine.ooc.iters"]["total"])
    revisit = sum(k * n * w * item for k in range(nt))
    f32 = n * n * item + revisit + 2 * n * n * item + rhs
    bf16 = n * n * item + revisit // 2 + (2 + iters) * (n * n * item + rhs)
    ok &= e <= OOC_BERR and rep["ooc.h2d_bytes"] == bf16 \
        and rep["ooc.lu_invalidations"] == 0
    rec["gesv_bf16"] = {"wall_s": wall, "backward_error": e,
                        "h2d_predicted": bf16, "h2d_f32_predicted": f32,
                        "sweeps": iters, **rep}
    del A, B2, X, B
    free_card()
    out["bf16"] = {"n": n, "panel_cols": w, **rec}
    return ok


def ooc_sched(seed, out, system):
    """Runs 6 and 7 at N_OOC_SCHED, panels of W_OOC_SCHED: the graph
    route bitwise the walk for potrf / geqrf / getrf_tntpiv (watchdog on:
    nt + 1 heartbeats a call), the fused visits, crash and resume with a
    checkpoint a panel, one transient fault each at h2d and d2h."""
    from slate_tpu_torch.obs import health
    from slate_tpu_torch.resil import faults
    n, w = N_OOC_SCHED, W_OOC_SCHED
    nt = n // w
    gen = torch.Generator("cuda").manual_seed(seed + 19)
    S = ooc_spd(gen, n)
    G, _ = permuted_boosted_system(gen, n, 1)
    s, g = host(S), host(G)
    del S, G
    free_card()
    system["ooc"] = (s, np.ones((n, NRHS), np.float32))
    calls = {"potrf_ooc": lambda **kw: (st.potrf_ooc(s, w, **kw),),
             "geqrf_ooc": lambda **kw: st.geqrf_ooc(g, w, **kw),
             "getrf_tntpiv_ooc": lambda **kw: st.getrf_tntpiv_ooc(
                 g, w, **kw)}
    ok, rec, walk = True, {}, {}
    health.enable(min_budget_s=60.0)
    try:
        for op, call in calls.items():
            t0 = time.perf_counter()
            walk[op] = call()
            t_walk = time.perf_counter() - t0
            beats = health.stats()["heartbeats"]
            t0 = time.perf_counter()
            graph = call(scheduler="graph")
            t_graph = time.perf_counter() - t0
            beats = health.stats()["heartbeats"] - beats
            bit = all(host_equal(x, y) for x, y in zip(walk[op], graph))
            ok &= bit and beats == nt + 1
            rec[op] = {"graph_bitwise_walk": bit, "heartbeats": beats,
                       "walk_s": t_walk, "graph_s": t_graph}
    finally:
        health.disable()
    ok &= not health.thread_alive()
    rec["watchdog_stopped"] = not health.thread_alive()
    for op, call in calls.items():
        fused = call(visit_fuse="fused")
        if op == "potrf_ooc":
            d = float(np.abs(fused[0] - walk[op][0]).max()
                      / np.abs(walk[op][0]).max())
            good = d <= 1e-5
        elif op == "geqrf_ooc":
            d = all(host_equal(x, y) for x, y in zip(fused, walk[op]))
            good = d
        else:
            d = bool(np.array_equal(fused[1], walk[op][1]))
            good = d
        ok &= good
        rec[op]["fused"] = d
    rec["guard_counts_before_crash_runs"] = guard.counts()
    ok &= guard.counts() == {}
    for op in ("potrf_ooc", "getrf_tntpiv_ooc"):
        with tempfile.TemporaryDirectory(prefix="ooc_ckpt_") as ck:
            faults.install(faults.FaultPlan(
                [{"site": "step", "match": {"op": op, "step": 3},
                  "times": 1}]))
            try:
                calls[op](ckpt_path=ck, ckpt_every=1)
                crashed = False
            except faults.InjectedFault:
                crashed = True
            finally:
                faults.clear()
            with open(os.path.join(ck, "meta.json")) as f:
                epoch = json.load(f)["epoch"]
            resumed = calls[op](ckpt_path=ck, ckpt_every=1)
            bit = all(host_equal(x, y) for x, y in zip(resumed, walk[op]))
            ok &= crashed and epoch == 3 and bit
            rec[op]["crash_resume"] = {"crashed_at_epoch": epoch,
                                       "resume_bitwise": bit}
    # each of the two ops commits each of its nt panels once: 3 before
    # the crash, the rest after the resume
    rec["guard_counts_crash_runs"] = guard.counts()
    ok &= guard.counts() == {"resil.ckpt_commits": 2 * nt}
    guard.reset_counts()
    faults.install(faults.FaultPlan(
        [{"site": "h2d", "match": {"buf": "A"}, "after": 1, "times": 1},
         {"site": "d2h", "match": {"buf": "L", "idx": 2}, "times": 1}]))
    try:
        L = calls["potrf_ooc"](cache_budget_bytes=4 * n * w * 4)[0]
        plan = faults.active()
    finally:
        faults.clear()
    counts = guard.counts()
    bit = host_equal(L, walk["potrf_ooc"][0])
    ok &= bit and counts == {"resil.retries": 2} and plan.fired() == 2
    rec["transfer_faults"] = {"injections": plan.log(),
                              "guard_counts": counts, "bitwise": bit}
    guard.reset_counts()
    out["sched"] = {"n": n, "panel_cols": w, **rec}
    return ok


def ooc_autotune(out):
    """Run 8: tune.autotune(ops=("ooc",)) at N_OOC_LU with candidate
    widths OOC_TUNE_CANDIDATES, best of 2 timed calls each: each width's
    seconds and the winner. The default width (the frozen 8192, row
    panel_cols None) is the baseline and is not raced against itself; a
    persisted winner is another width."""
    from slate_tpu_torch.linalg.ooc import _panel_cols
    fresh_tune_cache()
    default = _panel_cols(None, N_OOC_LU, np.float32)
    rep = autotune(ops=("ooc",), n=N_OOC_LU, dtype=torch.float32, reps=2,
                   ooc_candidates=OOC_TUNE_CANDIDATES)
    chosen = rep["ooc"]["chosen"]
    out["autotune"] = {"n": N_OOC_LU, "default_width": default,
                       "chosen": chosen, "results": rep["ooc"]["results"]}
    fresh_tune_cache()
    raced = {r["panel_cols"] for r in rep["ooc"]["results"]}
    return raced == {None} | (set(OOC_TUNE_CANDIDATES) - {default}) \
        and chosen.get("panel_cols") != default


def phase_ooc(seed, results, system):
    """The out-of-core stream on the card (the module doc's phase
    21)."""
    out = {"phase": "ooc"}
    fresh_tune_cache()
    ok = True
    for part in (lambda: ooc_posv(seed, out),
                 lambda: ooc_lu(seed, results, out),
                 lambda: ooc_gels(seed, out),
                 lambda: ooc_bf16(seed, out),
                 lambda: ooc_sched(seed, out, system),
                 lambda: ooc_autotune(out)):
        t0 = time.perf_counter()
        good = part()
        out.setdefault("part_seconds", []).append(
            round(time.perf_counter() - t0, 3))
        counts = guard.counts()
        out.setdefault("part_guard_counts", []).append(counts)
        ok &= bool(good) and counts == {}
    import resource
    out["host_peak_rss_gib"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    out["ok"] = bool(ok and guard.counts() == {})
    return out


# -- the sharded out-of-core stream and the elastic mesh (dist/) ------------

#: leg B's launches: their time limit, and the grace the survivors of the
#: planned kill get before the launch reaps them
SHARD_LAUNCH_TIMEOUT, SHARD_DEATH_GRACE = 600, 5.0


def shard_digest(r):
    """shard_checks.digest of each part of a driver's result."""
    from slate_tpu_torch.testing.shard_checks import digest
    return "".join(digest(v) for v in (r if isinstance(r, tuple)
                                       else (r,)))


def host_rss_gib():
    """This process's resident host memory, GiB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 2 ** 20
    return float("nan")


def shard_call(fn, launches):
    """ooc_run of one sharded call, its kernel launches added to
    `launches`. Collects first: leg A holds two factors at a time
    (17.2 GB each at n = 65536), and a third left to the collector would
    not fit the host at that size."""
    import gc
    gc.collect()
    pk.reset_launch_counts()
    wall, r, rep = ooc_run(fn)
    rep["host_rss_gib"] = host_rss_gib()
    for k, v in pk.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    return wall, r, rep


def same_result(x, y):
    """Bitwise equality of two driver results (arrays or tuples)."""
    x = x if isinstance(x, tuple) else (x,)
    y = y if isinstance(y, tuple) else (y,)
    return all(host_equal(u, v) for u, v in zip(x, y))


def shard_twin(name, shard, twin, out, launches):
    """One sharded call beside its single-engine twin on the same host
    matrix: both walls, bitwise equality."""
    import gc
    gc.collect()
    wall_t, rt, _ = ooc_run(twin)
    wall_s_, rs, rep = shard_call(shard, launches)
    same = same_result(rs, rt)
    del rs, rt
    out[name] = {"wall_s": wall_s_, "single_engine_wall_s": wall_t,
                 "bitwise_single_engine": same,
                 "bcast_bytes": rep.get("ooc.shard.bcast_bytes"),
                 "h2d_bytes": rep["ooc.h2d_bytes"],
                 "host_rss_gib": rep["host_rss_gib"],
                 "ledger": rep["ledger"]}
    return same


def shard_variants(grid, s16, b16, w, out, launches):
    """On s16 (n = 16384 on the card, the size of phase ooc's scheduler
    runs) in panels of w: shard_potrf_ooc beside potrf_ooc at budget 0,
    then lookahead 1, the graph route and the fused visits bitwise it,
    bf16 frames at exactly half its broadcast bytes, and posv_ooc routed
    Sharded to phase ooc's backward-error limit."""
    n = s16.shape[0]
    wall_t, L0, _ = ooc_run(lambda: st.potrf_ooc(s16, w, 0))
    ok = True
    for name, kw in (("potrf_16384", {}),
                     ("potrf_d1", dict(lookahead=1)),
                     ("potrf_graph", dict(scheduler="graph")),
                     ("potrf_fused", dict(lookahead=1,
                                          visit_fuse="fused")),
                     ("potrf_bf16", dict(precision="bf16"))):
        wall, L, rep = shard_call(lambda: st.dist.shard_potrf_ooc(
            s16, grid, panel_cols=w, cache_budget_bytes=0, **kw),
            launches)
        rec = {"n": n, "panel_cols": w, "wall_s": wall,
               "bcast_bytes": rep.get("ooc.shard.bcast_bytes")}
        if name == "potrf_bf16":
            rec["f32_bcast_bytes"] = out["potrf_16384"]["bcast_bytes"]
            rec["max_abs_diff_f32"] = float(np.abs(L - L0).max())
            ok &= 2 * rec["bcast_bytes"] == rec["f32_bcast_bytes"] \
                and bool(np.isfinite(L).all())
        else:
            rec["bitwise_single_engine"] = host_equal(L, L0)
            ok &= rec["bitwise_single_engine"]
        out[name] = rec
    out["potrf_16384"]["single_engine_wall_s"] = wall_t
    wall, (_, X), rep = shard_call(lambda: st.posv_ooc(
        s16, b16, panel_cols=w, grid=grid, method="sharded"), launches)
    e = ooc_berr(torch.from_numpy(s16).cuda(), X, b16)
    ok &= e <= OOC_BERR and rep["ooc.shard.bcast_panels"] == n // w
    out["posv_ooc_sharded"] = {"n": n, "panel_cols": w, "wall_s": wall,
                               "backward_error": e,
                               "bcast_panels":
                               rep["ooc.shard.bcast_panels"]}
    return ok


def shard_leg_a(seed, results, out):
    """Leg A (module doc, phase 24): one NCCL rank at phase ooc's sizes,
    then at 16384 the variants and the runs leg B is held to. Returns
    (ok, leg B's reference digests)."""
    import torch.distributed as tdist
    from slate_tpu_torch.testing import shard_checks as sc
    rdzv = tempfile.mkdtemp(prefix="slate_shard_pg_")
    tdist.init_process_group("nccl", init_method="file://%s/store" % rdzv,
                             rank=0, world_size=1)
    launches, ok, ref = {}, True, {}
    try:
        grid = st.make_grid(1, 1)
        out["grid"] = repr(grid)
        gen = torch.Generator("cuda").manual_seed(seed + 24)
        a = host(ooc_spd(gen, N_OOC))
        free_card()
        budget = OOC_BUDGET_PANELS * N_OOC * W_OOC * 4
        for name, bud in (("potrf_budget0", 0),
                          ("potrf_budget%d" % OOC_BUDGET_PANELS, budget)):
            ok &= shard_twin(
                name, lambda: st.dist.shard_potrf_ooc(
                    a, grid, panel_cols=W_OOC, cache_budget_bytes=bud),
                lambda: st.potrf_ooc(a, W_OOC, bud), out, launches)
        del a
        G, _ = permuted_boosted_system(gen, N_OOC_LU, 1)
        g = host(G)
        del G
        lbud = 2 * N_OOC_LU * W_OOC * 4
        ok &= shard_twin(
            "getrf", lambda: st.dist.shard_getrf_ooc(
                g, grid, panel_cols=W_OOC, cache_budget_bytes=lbud),
            lambda: st.getrf_tntpiv_ooc(g, W_OOC,
                                        cache_budget_bytes=lbud),
            out, launches)
        del g
        G = torch.randn((GELS_M, GELS_N), generator=gen, device="cuda")
        g = host(G)
        del G
        free_card()
        ok &= shard_twin(
            "geqrf", lambda: st.dist.shard_geqrf_ooc(
                g, grid, panel_cols=GELS_W, cache_budget_bytes=0),
            lambda: st.geqrf_ooc(g, GELS_W, cache_budget_bytes=0),
            out, launches)
        del g
        free_card()
        # at 16384: the variants, and leg B's references (one rank, the
        # same matrices and budget)
        n, w = sc.CHIP_N, sc.CHIP_W
        s16 = sc.chip_matrix(n, torch.device("cuda"))
        g16 = sc.chip_lu_matrix(n, torch.device("cuda"))
        b16 = torch.randn((n, NRHS), generator=gen,
                          device="cuda").cpu().numpy()
        ok &= shard_variants(grid, s16, b16, w, out, launches)
        cb = sc.CHIP_BUDGET_PANELS * n * w * 4
        pk.reset_launch_counts()
        walls = {}
        for name, call in (
                ("potrf", lambda: st.dist.shard_potrf_ooc(
                    s16, grid, panel_cols=w, cache_budget_bytes=cb)),
                ("getrf", lambda: st.dist.shard_getrf_ooc(
                    g16, grid, panel_cols=w, cache_budget_bytes=cb)),
                ("geqrf", lambda: st.dist.shard_geqrf_ooc(
                    g16, grid, panel_cols=w, cache_budget_bytes=cb))):
            walls[name], r = wall_s(call)
            ref[name] = shard_digest(r)
        for k, v in pk.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        out["one_rank_16384_wall_s"] = walls
        del s16, g16
    finally:
        tdist.destroy_process_group()
        shutil.rmtree(rdzv, ignore_errors=True)
    add_phase_launches(results, "shard_ooc", launches)
    out["launches"] = {k: v for k, v in launches.items() if v}
    ok &= launches.get("compose_swaps", 0) > 0
    return ok, ref


def shard_launch(suite, n, d, **kw):
    """One launch of testing.shard_checks on the card under gloo:
    (wall seconds, per-rank records)."""
    from slate_tpu_torch.testing import grid_checks, multiproc
    from slate_tpu_torch.testing import shard_checks as sc
    extra = kw.pop("extra", [])
    t0 = time.perf_counter()
    procs, outs = multiproc.launch(
        "slate_tpu_torch.testing.shard_checks", n,
        extra_args=[suite, "--device", "cuda:0", "--backend", "gloo",
                    "--n", str(sc.CHIP_N), "--w", str(sc.CHIP_W)]
        + extra, outdir=d, timeout=SHARD_LAUNCH_TIMEOUT, **kw)
    wall = time.perf_counter() - t0
    bad = [i for i, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError("shard_checks %s: ranks %s exited nonzero\n%s" % (
            suite, bad, "\n".join("-- rank %d --\n%s" % (i, outs[i][-2500:])
                                  for i in bad)))
    return wall, grid_checks.load(outs)


def shard_leg_b(ref, out):
    """Leg B (module doc, phase 24): four gloo ranks on the card, then
    the planned kill and the survivors' resume."""
    from slate_tpu_torch.dist import elastic
    from slate_tpu_torch.dist.tree import schedule_ppermutes
    from slate_tpu_torch.resil import faults
    from slate_tpu_torch.testing import shard_checks as sc
    d = tempfile.mkdtemp(prefix="slate_shard_")
    ok = True
    try:
        wall, ranks = shard_launch("chip", 4, d)
        recs = [r["2x2.chip"] for r in ranks]
        nt = sc.CHIP_N // sc.CHIP_W
        mine = [set(r["my_panels"]) for r in recs]
        disjoint = sum(len(m_) for m_ in mine) == nt \
            and set().union(*mine) == set(range(nt))
        rounds = nt * schedule_ppermutes(4, 2)
        runs = {}
        for name in ("potrf", "potrf_d1", "getrf", "geqrf", "elastic"):
            want = ref["potrf" if name in ("potrf_d1", "elastic")
                       else name]
            rs = [r[name] for r in recs]
            runs[name] = {
                "walls_s": [r_["wall_s"] for r_ in rs],
                "bitwise_rank0": all(r_["sha"] == rs[0]["sha"]
                                     for r_ in rs),
                "bitwise_one_rank": rs[0]["sha"] == want,
                "h2d_equals_staged_bytes": all(
                    r_["h2d"] == r_["expect"] for r_ in rs),
                "spills": [r_["spills"] for r_ in rs],
                "rounds": [r_["permutes"] for r_ in rs],
                "bcast_bytes": rs[0]["bcast_bytes"],
                "gloo_host_staged_bytes": [r_["gloo_staged_bytes"]
                                           for r_ in rs],
                "overlap_fraction": [r_["overlap_fraction"] for r_ in rs]}
            ok &= runs[name]["bitwise_rank0"] \
                and runs[name]["bitwise_one_rank"] \
                and all(r_["permutes"] == rounds for r_ in rs)
            if name != "elastic":
                ok &= runs[name]["h2d_equals_staged_bytes"] \
                    and not any(runs[name]["spills"])
        remaps = [r["elastic"]["records"] for r in recs]
        runs["elastic"]["remap_records"] = remaps
        ok &= disjoint and all(r_["remaps"] >= 1 for r_ in remaps)
        out["four_ranks"] = {"grid": "2x2", "backend": "gloo",
                             "n": sc.CHIP_N, "panel_cols": sc.CHIP_W,
                             "budget_panels": sc.CHIP_BUDGET_PANELS,
                             "launch_wall_s": wall,
                             "panels_disjoint_cover": disjoint,
                             "rounds_expected": rounds, "runs": runs}
        # shrink to fit: rank 3 is killed at panel KILL_STEP; the three
        # survivors resume from the per-rank checkpoints
        ck = os.path.join(d, "ck")
        os.makedirs(ck)
        plan = faults.FaultPlan([{
            "site": "step", "match": {"op": "shard_potrf_ooc",
                                      "step": sc.KILL_STEP, "host": 3},
            "times": 1, "kind": "kill"}])
        lost, guard_seen = [], {}

        def primary():
            shard_launch("chip_shrink", 4, d, extra=["--ckpt", ck],
                         death_grace=SHARD_DEATH_GRACE,
                         lost_on_failure=True,
                         env=faults.install_env_var(plan))
            return None            # a run the kill missed fails below

        def survivors(e):
            lost.append((e.process_id, e.returncode))
            guard_seen.update(guard.counts())
            return shard_launch("chip_survivors", 3, d,
                                extra=["--ckpt", ck])

        assert guard.counts() == {}
        elastic.reset_remap_records()
        t0 = time.perf_counter()
        res = elastic.shrink_to_fit(primary, survivors, op="shard_potrf_ooc")
        shrink_wall = time.perf_counter() - t0
        shrinks = elastic.remap_records()["shrinks"]
        guard.reset_counts()
        srecs = [r["1x3.survivors"] for r in res[1]] if res else []
        out["shrink"] = {
            "lost": lost, "guard_counts": guard_seen,
            "shrinks": shrinks, "wall_s": shrink_wall,
            "survivor_launch_wall_s": res[0] if res else None,
            "resume_epochs": [r["resume_epoch"] for r in srecs],
            "survivor_walls_s": [r["wall_s"] for r in srecs],
            "bitwise_static": bool(srecs) and all(
                r["sha"] == ref["potrf"] for r in srecs)}
        ok &= lost == [(3, faults.KILL_EXIT_CODE)] and shrinks == 1 \
            and guard_seen == {"resil.fallback.shard_shrink": 1,
                               "resil.fallbacks": 1} \
            and out["shrink"]["bitwise_static"] \
            and out["shrink"]["resume_epochs"] == [sc.KILL_STEP] * 3
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return ok


def phase_shard_ooc(seed, results):
    """The sharded out-of-core stream and the elastic mesh (the module
    doc's phase 24)."""
    out = {"phase": "shard_ooc"}
    fresh_tune_cache()
    t0 = time.perf_counter()
    ok, ref = shard_leg_a(seed, results, out)
    out["leg_a_ok"] = bool(ok)
    out["leg_a_seconds"] = round(time.perf_counter() - t0, 3)
    out["leg_a_guard_counts"] = guard.counts()
    ok &= guard.counts() == {}
    free_card()
    t0 = time.perf_counter()
    out["leg_b_ok"] = shard_leg_b(ref, out)
    ok &= out["leg_b_ok"]
    out["leg_b_seconds"] = round(time.perf_counter() - t0, 3)
    out["ok"] = bool(ok and guard.counts() == {})
    return out


# -- the eigen / SVD slice: the Givens chain, the QR sweeps, heev, svd ------

#: heev: the largest n at which the reference's single-device steqr2
#: runs without its warning; tiles (and he2hb's band width) of 256
N_EIG, MB_EIG = 2048, 256
#: svd: BDSQR_QR_MAX_N, the largest k the reference's bdsqr iterates;
#: tiles of 64 make ge2tb's band narrow enough for tb2bd's chase
N_SVD, MB_SVD = 512, 64
#: limits of the library routes (heev and svd Auto) and of the SVD's QR
#: iteration in f32: residual and orthogonality, and agreement with the
#: library (Auto) route, relative to ||A||_2 (eigenvalues) or s_max
#: (singular values)
EIG_LIMIT = 1e-5
#: limit of the staged eigen routes (QR iteration, cold steqr2, stedc)
#: at n = N_EIG in f32, as a LAPACK test ratio: error / (n eps) <= 4
#: (LAPACK's own testers pass a ratio below 30). 1e-5 is out of reach
#: of these algorithms in f32 at this n, in both packages: the
#: windowed band chase (hb2st, ~18 000 two-sided QR steps of width 256)
#: moves the eigenvalues by 2.1e-5 of ||A||_2 at n = 2048 on the CPU
#: (the port; its band from he2hb is within 6e-8), and the f32 divide &
#: conquer's eigenvectors are orthogonal to ~2 n eps (the JAX package's
#: stedc_solve: 1.34e-4 at n = 512 on the CPU)
STAGED_EIG_LIMIT = 4.0 * N_EIG * float(torch.finfo(torch.float32).eps)


def chain_cases(rng, rows, n):
    """The chain kernel's adversarial suite: identity rotations,
    c = 0 / s = +-1 (pure swaps with signs), random angles, and a
    matrix of 8 rows."""
    th = rng.standard_normal(n - 1)
    sgn = np.where(rng.standard_normal(n - 1) >= 0, 1.0, -1.0)
    return {"identity": (np.ones(n - 1), np.zeros(n - 1), rows),
            "swap": (np.zeros(n - 1), sgn, rows),
            "random": (np.cos(th), np.sin(th), rows),
            "rows8": (np.cos(th), np.sin(th), 8)}


def phase_givens_chain(rng, results):
    """givens_chain_apply against its plain version, bitwise: the
    adversarial suite at 256 columns, then the paths' shapes in f32:
    Z 2048 x 2048 (steqr2) and 512 x 512 row-major and transposed
    (bdsqr applies its right chain to Gvh^T). Times, back to back and
    replayed from a CUDA graph (graph_ms), beside the library product
    Z @ G with G precomposed (timed only), the bound (Z read and
    written once at the memory rate) and the chain's latency bound
    (n-1 dependent steps a row)."""
    from slate_tpu_torch.linalg.svd import _givens_chain_matrix
    out = {"phase": "kernel.givens_chain", "ok": True, "cases": {}}
    for kind, (c, s, rows) in chain_cases(rng, 256, 256).items():
        Z = torch.as_tensor(rng.standard_normal((rows, 256)),
                            dtype=torch.float32, device="cuda")
        cs = torch.as_tensor(c, dtype=torch.float32, device="cuda")
        sn = torch.as_tensor(s, dtype=torch.float32, device="cuda")
        k = pk._givens_chain_launch(Z, cs, sn)
        p = pk.givens_chain_apply_plain(Z, cs, sn)
        torch.cuda.synchronize()
        same = torch.equal(k, p)
        out["cases"][kind] = same
        out["ok"] &= same
    for path, rows, n, trans in (("heev", N_EIG, N_EIG, False),
                                 ("svd", N_SVD, N_SVD, False),
                                 ("svd", N_SVD, N_SVD, True)):
        th = rng.standard_normal(n - 1)
        cs = torch.as_tensor(np.cos(th), dtype=torch.float32, device="cuda")
        sn = torch.as_tensor(np.sin(th), dtype=torch.float32, device="cuda")
        Z = torch.as_tensor(rng.standard_normal((rows, n)),
                            dtype=torch.float32, device="cuda")
        if trans:
            Z = Z.T                   # a view: the kernel takes strides
        k = pk._givens_chain_launch(Z, cs, sn)
        p = pk.givens_chain_apply_plain(Z, cs, sn)
        G = _givens_chain_matrix(cs, sn, n)
        torch.cuda.synchronize()
        same = torch.equal(k, p)
        dense_err = float((k.double() - (Z.double() @ G.double())).abs()
                          .max())
        b_ms, b_by = bound_ms(6.0 * rows * (n - 1), 8.0 * rows * n)
        run = functools.partial(pk._givens_chain_launch, Z, cs, sn)
        s = {"shape": "%dx%d%s" % (rows, n, " transposed" if trans else ""),
             "ms": cuda_ms(run, 50), "graph_ms": graph_ms(run),
             "plain_ms": cuda_ms(
                 lambda: pk.givens_chain_apply_plain(Z, cs, sn), 1),
             "library_ms": cuda_ms(lambda: Z @ G, 20),
             "library_graph_ms": graph_ms(lambda: Z @ G),
             "bound_ms": b_ms, "bound_by": b_by,
             # each row's chain: n-1 steps of a multiply then an add
             "latency_bound_ms": latency_ms(n - 1, 2 * DEP_OP_CYCLES)}
        out["ok"] &= same and dense_err <= 1e-4
        key = "givens_chain_apply." + path + (".T" if trans else "")
        out[key] = {**s, "bitwise": same, "max_abs_err_dense": dense_err}
        if not trans:
            results[key] = entry(
                "givens_chain_apply", "float32", "givens_chain.cu",
                PK + "739 (_givens_apply_pallas)", path, s,
                0.0 if same else None)
    return out


def tridiag(rng, n):
    """A random symmetric tridiagonal (d, e), f32 on the card."""
    return (torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device="cuda"),
            torch.as_tensor(rng.standard_normal(n - 1),
                            dtype=torch.float32, device="cuda"))


def sweep_bound(steps, n, nrot):
    """One pass's least time: ~40 f32 operations a chase step, and d, e
    read and d, e, the rotations and the count written once."""
    return bound_ms(40.0 * steps, 4.0 * (2 * n - 1) * 2 + 4.0 * nrot
                    * (n - 1) + 4)


def sweep_floor_ms(name, d, e):
    """A sweep's bitwise floor on (d, e): the chase's dependent chain
    with the rounding its contract fixes (f64 hypot, IEEE divides, one
    rounding an operation), measured on one warp in step by the
    library's `name` entry (steqr_chain_cycles or bdsqr_chain_cycles:
    clock64 over the n-1 steps, no stores), as time at the boost clock;
    and the cycles a step."""
    lib = _build.load("qr_sweep")
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    for _ in range(2):                       # the second call is warm
        _build.check(getattr(lib, name)(
            d.data_ptr(), e.data_ptr(), d.shape[0], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), name)
        torch.cuda.synchronize()
    per_step = int(out[0]) / (d.shape[0] - 1)
    return latency_ms(d.shape[0] - 1, per_step), per_step


#: each sweep: its one-pass entry and plain version, its multi-pass
#: entry, plain version and pass cap, its floor entry, its path's order
SWEEPS = {"steqr_sweep": (pk.steqr_sweep, pk.steqr_sweep_plain,
                          pk.steqr_sweeps, pk.steqr_sweeps_plain,
                          pk.STEQR_PASSES_PER_LAUNCH, "steqr_chain_cycles",
                          N_EIG, "heev", "slate_tpu/linalg/eig.py:553 "
                          "(_steqr_shifted_sweep, XLA scan)"),
          "bdsqr_sweep": (pk.bdsqr_sweep, pk.bdsqr_sweep_plain,
                          pk.bdsqr_sweeps, pk.bdsqr_sweeps_plain,
                          pk.BDSQR_PASSES_PER_LAUNCH, "bdsqr_chain_cycles",
                          N_SVD, "svd", "slate_tpu/linalg/svd.py:472 "
                          "(_bdsqr_shifted_sweep, XLA scan)")}


def phase_qr_sweep(rng, results):
    """steqr_sweep and bdsqr_sweep against their plain versions,
    bitwise in every output, over 3 passes from a random n = 2048
    tridiagonal and a random 512 bidiagonal (each pass fed the kernel's
    previous output); the multi-pass entries steqr_sweeps and
    bdsqr_sweeps against their plain twins, bitwise (d, e, every pass's
    rotations, passes run and count), over 3 launches of 4 passes at the
    same order and, on a 64-order matrix, launches of the path's pass
    cap until one stops at a count of 0 (multi_pass); times of the
    first pass, back to back and replayed from a CUDA graph, of a full
    multi-pass launch a pass, with the 4-operation latency bound and
    the bitwise floor (sweep_floor_ms)."""
    out = {"phase": "kernel.qr_sweep", "ok": True}
    for name, (run, plain, multi, multi_plain, cap, floor, n, path,
               line) in SWEEPS.items():
        d0, e0 = tridiag(rng, n)
        d, e = d0, e0
        passes = []
        for _ in range(3):
            k = run(d, e)
            p = plain(d, e)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(k, p))
            passes.append(same)
            out["ok"] &= same
            d, e = k[0], k[1]
        nrot = len(k) - 3
        b_ms, b_by = sweep_bound(n - 1, n, nrot)
        one = functools.partial(run, d0, e0)
        s = {"shape": "n = %d, one pass" % n,
             "ms": cuda_ms(one, 20), "graph_ms": graph_ms(one, 20),
             "plain_ms": cuda_ms(lambda: plain(d0, e0), 2),
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
             # the chase: n-1 dependent steps, each at least four
             # dependent f32 operations on the bulge
             "latency_bound_ms": latency_ms(n - 1, 4 * DEP_OP_CYCLES)}
        s["bitwise_floor_ms"], s["floor_cycles_per_step"] = \
            sweep_floor_ms(floor, d0, e0)
        s["multi_pass"] = multi_pass(multi, multi_plain, cap, d0, e0)
        out["ok"] &= s["multi_pass"]["ok"]
        out[name] = {**s, "passes_bitwise": passes}
        results[name] = entry(name, "float32", "qr_sweep.cu", line, path,
                              s, 0.0 if all(passes) else None)
    return out


def multi_pass(multi, plain, k, d0, e0):
    """A multi-pass entry (steqr_sweeps or bdsqr_sweeps) against its
    plain twin, bitwise, over 3 chained launches of 4 passes from
    (d0, e0), then on a random 64-order matrix launches of k passes (the
    path's cap) until one stops at a count of 0 (and one more, which
    runs no pass); the graph time of a launch of k passes from
    (d0, e0), a pass."""
    def held(d, e, k):
        got = multi(d, e, k)
        ref = plain(d, e, k)
        torch.cuda.synchronize()
        return got, all(torch.equal(a, b) for a, b in zip(got, ref))

    launches, d, e = [], d0, e0
    for _ in range(3):
        got, same = held(d, e, 4)
        launches.append({"ran": got[-1].tolist(), "bitwise": same})
        d, e = got[0], got[1]
    d, e = tridiag(np.random.default_rng(64), 64)
    for _ in range(12):
        got, same = held(d, e, k)
        launches.append({"ran": got[-1].tolist(), "bitwise": same})
        d, e = got[0], got[1]
        if got[-1][0] == 0:
            break
    ran = multi(d0, e0, k)[-1].tolist()
    g_ms = graph_ms(lambda: multi(d0, e0, k), 3)
    ok = all(x["bitwise"] for x in launches) \
        and launches[-1]["ran"] == [0, 0] \
        and any(x["ran"][0] > 0 and x["ran"][1] == 0 for x in launches)
    return {"ok": bool(ok), "launches": launches,
            "passes_per_launch": k, "graph_ms_a_launch": g_ms,
            "graph_ms_a_pass": g_ms / max(ran[0], 1), "ran": ran}


def route_chain(op, dtype, n):
    """A fresh tune cache routing (op, 'chain') to the chain kernel at
    size n."""
    fresh_tune_cache()
    cache = tcache.get_cache()
    cache.put(op, dtype, n, {"chain": "pallas_rec"})
    cache.save()


def eig_checks(a64, w, V, w_ref, anorm2, limit=EIG_LIMIT):
    """Residual ||A V - V diag(w)||_F / ||A||_F, orthogonality
    max|V^T V - I| and max|w - w_ref| / ||A||_2, in f64 on the card,
    each within `limit`."""
    v = V.to_dense().double()
    w64 = w.double()
    res = float(torch.linalg.norm(a64 @ v - v * w64[None, :])
                / torch.linalg.norm(a64))
    orth = float((v.T @ v - torch.eye(v.shape[1], dtype=torch.float64,
                                      device="cuda")).abs().max())
    werr = float((w64 - w_ref.double()).abs().max()) / anorm2
    ok = max(res, orth, werr) <= limit \
        and bool(torch.isfinite(v).all()) and tuple(w.shape) == (a64.shape[0],)
    return ok, {"residual": res, "orthogonality": orth,
                "values_vs_auto": werr, "limit": limit}


def phase_heev(seed, results, system):
    """heev at n = 2048 on A = (G + G^T)/2 made on the card from --seed,
    tiles 256. (c) Auto (the library eigensolver) gives the reference
    values. (a) MethodEig.QRIteration with ('steqr2', 'chain') routed to
    the chain kernel: he2hb -> hb2st -> steqr2, the passes in
    steqr_sweeps launches (up to STEQR_PASSES_PER_LAUNCH each, one host
    read a launch) and one givens_chain_apply launch a pass, passes
    counted apart from launches. (b) he2hb and hb2st once, timed,
    then on that tridiagonal and its back-transform steqr2 cold (the
    dense compose, sweeps still on the card) and stedc. The library
    route within EIG_LIMIT, the staged ones within STAGED_EIG_LIMIT
    (eig_checks)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn((N_EIG, N_EIG), generator=gen, device="cuda")
    a = (g + g.T) / 2
    del g
    A = st.HermitianMatrix(st.Uplo.Lower, a, mb=MB_EIG)
    a64 = a.double()
    out = {"phase": "heev", "ok": True, "n": N_EIG, "mb": MB_EIG,
           "seed": seed}
    fresh_tune_cache()
    wall_c, (w_ref, V_c) = wall_s(lambda: st.heev(A))
    anorm2 = float(w_ref.abs().max())
    ok, chk = eig_checks(a64, w_ref, V_c, w_ref, anorm2)
    out["auto"] = {"wall_s": wall_c, **chk}
    out["ok"] &= ok
    route_chain("steqr2", torch.float32, N_EIG)
    opts = {st.Option.MethodEig: st.MethodEig.QRIteration}
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    teig.steqr2_qr.passes = 0
    wall_a, (w_a, V_a) = wall_s(lambda: st.heev(A, opts))
    launches = pk.launch_counts()
    set_launches(results, "heev", launches)
    ok, chk = eig_checks(a64, w_a, V_a, w_ref, anorm2, STAGED_EIG_LIMIT)
    # passes counted by the loop, apart from the sweep launches (each
    # runs up to STEQR_PASSES_PER_LAUNCH passes; one host read each)
    passes, sweeps = teig.steqr2_qr.passes, launches["steqr_sweep"]
    ok &= passes > 0 and launches["givens_chain_apply"] == passes \
        and -(-passes // pk.STEQR_PASSES_PER_LAUNCH) <= sweeps <= passes + 1
    out["qr_iteration"] = {"wall_s": wall_a, "passes": passes,
                           "sweep_launches": sweeps, "host_reads": sweeps,
                           "launches": {k: v for k, v in launches.items()
                                        if v}, **chk}
    out["ok"] &= ok
    fresh_tune_cache()
    stages = {}
    stages["he2hb"], (Band, Q1) = wall_s(lambda: st.he2hb(A))
    stages["hb2st"], tri = wall_s(lambda: st.hb2st(Band))
    Q = st.unmtr_he2hb(Q1, tri.Q)
    pk.reset_launch_counts()
    teig.steqr2_qr.passes = 0
    stages["steqr2_cold"], (w_b, V_b) = wall_s(
        lambda: st.steqr2(tri.d, tri.e, Q))
    cold = pk.launch_counts()
    ok_s, chk_s = eig_checks(a64, w_b, V_b, w_ref, anorm2,
                             STAGED_EIG_LIMIT)
    ok_s &= cold["givens_chain_apply"] == 0 and cold["steqr_sweep"] > 0
    stages["stedc"], (w_d, V_d) = wall_s(lambda: st.stedc(tri.d, tri.e, Q))
    ok_d, chk_d = eig_checks(a64, w_d, V_d, w_ref, anorm2,
                             STAGED_EIG_LIMIT)
    out["staged"] = {"stage_wall_s": stages, "band_kd": MB_EIG,
                     "steqr2_cold": {"passes": teig.steqr2_qr.passes,
                                     "sweep_launches": cold["steqr_sweep"],
                                     **chk_s},
                     "stedc": chk_d}
    out["ok"] &= ok_s and ok_d
    system.update(eig_A=A, eig_opts=opts)
    return out


#: the svd QR iteration's wall at N_SVD with one bdsqr_sweep launch and
#: one host read a pass, as PERF.md section 5 records it: one call under
#: torch.profiler (phase profile; H100 80GB HBM3, 700 W), beside which
#: phase svd reports its own unprofiled wall
SVD_QR_PARENT_WALL_S = 4.620


def phase_svd(seed, results, system):
    """svd at 512 x 512 on a Gaussian A from --seed, tiles 64: Auto (the
    library SVD) gives the reference values; MethodSVD.QRIteration with
    ('bdsqr', 'chain') routed to the chain kernel runs ge2tb -> tb2bd
    -> bdsqr_qr, the passes in bdsqr_sweeps launches (up to
    BDSQR_PASSES_PER_LAUNCH each, one host read a launch) and two
    givens_chain_apply launches a pass, passes counted apart from
    launches. ||U diag(s) Vh - A||_F / ||A||_F and max|s - s_auto| /
    s_max within EIG_LIMIT."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    a = torch.randn((N_SVD, N_SVD), generator=gen, device="cuda")
    A = st.Matrix(a, mb=MB_SVD)
    a64 = a.double()
    fresh_tune_cache()
    wall_c, res_c = wall_s(lambda: st.svd(A))
    smax = float(res_c.s.max())
    route_chain("bdsqr", torch.float32, N_SVD)
    opts = {st.Option.MethodSVD: st.MethodSVD.QRIteration}
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    tsvd.bdsqr_qr.passes = 0
    wall, res = wall_s(lambda: st.svd(A, opts))
    launches = pk.launch_counts()
    set_launches(results, "svd", launches)
    out = {"phase": "svd", "ok": True, "n": N_SVD, "mb": MB_SVD,
           "seed": seed, "auto_wall_s": wall_c, "qr_iteration_wall_s": wall,
           "parent_qr_iteration_wall_s": SVD_QR_PARENT_WALL_S}
    for name, r in (("auto", res_c), ("qr_iteration", res)):
        u, vh = r.U.to_dense().double(), r.Vh.to_dense().double()
        recon = float(torch.linalg.norm(u * r.s.double()[None, :] @ vh - a64)
                      / torch.linalg.norm(a64))
        serr = float((r.s.double() - res_c.s.double()).abs().max()) / smax
        out[name] = {"reconstruction": recon, "values_vs_auto": serr}
        out["ok"] &= max(recon, serr) <= EIG_LIMIT \
            and bool(torch.isfinite(r.s).all())
    # passes counted by the loop, apart from the sweep launches (each
    # runs up to BDSQR_PASSES_PER_LAUNCH passes; one host read each)
    passes, sweeps = tsvd.bdsqr_qr.passes, launches["bdsqr_sweep"]
    out.update(passes=passes, sweep_launches=sweeps, host_reads=sweeps,
               launches={k: v for k, v in launches.items() if v})
    out["ok"] &= passes > 0 \
        and launches["givens_chain_apply"] == 2 * passes \
        and -(-passes // pk.BDSQR_PASSES_PER_LAUNCH) <= sweeps <= passes + 1
    system.update(svd_A=A, svd_opts=opts)
    return out


# -- item 12: the sweep tester, the C API, non-uniform tiles, examples ----

#: the sweep tester's routines at full width (the same gesv / posv /
#: gels as phases gesv, posv and gels, reached through the harness)
HARNESS_ROUTINES = ("gemm", "potrf", "posv", "getrf", "gesv", "geqrf",
                    "gels")
HARNESS_REF_N = 2048
#: the LU kernels whose launches under the tester's gesv must equal a
#: direct gesv's
HARNESS_KERNELS = ("lu_panel_rec", "rank_update", "compose_swaps")


def harness_tune_cache():
    """Phase gesv's routes for the tester's calls, which pass no
    options: every f32 LU panel to the recursive kernel, and getrf's
    blocking at N the 512 of phase gesv's Option.BlockSize (the frozen
    blocking, 1024, is wider than the recursive kernel takes)."""
    fresh_tune_cache([torch.float32])
    cache = tcache.get_cache()
    cache.put("getrf", torch.float32, N, {"nb": NB})
    cache.save()


def harness_direct_gesv(seed=42, nrhs=10):
    """The tester's gesv inputs (run_one's generator, seed and order:
    A, then B, drawn in f64 and cast), solved by a direct st.gesv on
    the same tiles."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    a = torch.randn((N, N), generator=gen, dtype=torch.float64,
                    device="cuda").float()
    b = torch.randn((N, nrhs), generator=gen, dtype=torch.float64,
                    device="cuda").float()
    return st.gesv(st.Matrix(a, mb=NB, device="cuda"),
                   st.Matrix(b, mb=NB, device="cuda"))


def phase_harness(results):
    """The sweep tester (testing/tester.py, run_tests.py) on the card:
    the seven routines at n = N, f32, nb = NB with --check y (every row
    pass), the launches of the LU kernels under its gesv equal to a
    direct gesv's on the same matrix; the seven at HARNESS_REF_N with
    --ref y; run_tests --quick (all groups) with its junit read back.
    The f32 LU panels route to the recursive kernel, as in phase
    gesv."""
    import xml.etree.ElementTree as ET
    from slate_tpu_torch.testing import run_tests as trun
    from slate_tpu_torch.testing import tester
    harness_tune_cache()
    out = {"phase": "harness", "n": N, "nb": NB}
    tester.run_one("gesv", N, np.float32, NB, True, False,
                   device="cuda")                       # warm-up
    torch.cuda.synchronize()
    pk.reset_launch_counts()
    row = tester.run_one("gesv", N, np.float32, NB, True, False,
                         device="cuda")
    via_tester = pk.launch_counts()
    pk.reset_launch_counts()
    harness_direct_gesv()
    torch.cuda.synchronize()
    direct = pk.launch_counts()
    out["gesv_launches"] = {k: [via_tester[k], direct[k]]
                            for k in HARNESS_KERNELS}
    launches_equal = all(via_tester[k] == direct[k] > 0
                         for k in HARNESS_KERNELS)
    t_wall = time.perf_counter()
    pk.reset_launch_counts()
    table = io.StringIO()
    rows = tester.sweep(HARNESS_ROUTINES, str(N), "s", str(NB), "1x1",
                        check=True, ref=False, out=table, device="cuda")
    add_phase_launches(results, "harness", pk.launch_counts())
    out["rows"] = [{k: r[k] for k in ("routine", "time", "gflops",
                                      "error", "status")} for r in rows]
    out["sweep_s"] = time.perf_counter() - t_wall
    t_wall = time.perf_counter()
    ref_rows = tester.sweep(HARNESS_ROUTINES, str(HARNESS_REF_N), "s",
                            str(NB), "1x1", check=True, ref=True,
                            out=table, device="cuda")
    out["ref_rows"] = [{k: r[k] for k in ("routine", "time", "error",
                                          "status")} for r in ref_rows]
    out["ref_sweep_s"] = time.perf_counter() - t_wall
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "quick.xml")
        t_wall = time.perf_counter()
        with contextlib.redirect_stdout(table):
            rc = trun.main(["--quick", "--xml", path, "--device", "cuda"])
        out["quick_s"] = time.perf_counter() - t_wall
        suite = ET.parse(path).getroot()
        cases = suite.findall("testcase")
        out["quick"] = {"rc": rc, "tests": int(suite.get("tests")),
                        "failures": int(suite.get("failures"))}
    print(table.getvalue(), flush=True)
    out["ok"] = bool(
        row["status"] == "pass" and launches_equal
        and all(r["status"] == "pass" for r in rows + ref_rows)
        and len(rows) == len(ref_rows) == len(HARNESS_ROUTINES)
        and rc == 0 and out["quick"]["failures"] == 0
        and len(cases) == out["quick"]["tests"] == 2 * len(trun.ALL))
    return out


#: sizes of the C program (phase c_api)
C_N, C_M_GELS, C_N_GELS, C_N_EIG = 8192, 16384, 2048, 1024
#: the reference C test's bound on max |A x - b| (tests/test_c_api.py,
#: f64 at N = 24), scaled by n; f32 solves are held to the normwise
#: backward error the other phases hold them to (1e-6); gels to the
#: sweep tester's ratio (< 100 n eps); gemm entries to the product's
#: rounding bound 2 k eps (|alpha| |A| |B| + |beta| |C|)
C_REF_BOUND, C_REF_N = 1e-8, 24
C_PROGRAM = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include "slate_c.h"

static unsigned long long rs = 88172645463325252ULL;
static double urand(void) {          /* xorshift64, uniform [0, 1) */
    rs ^= rs << 13; rs ^= rs >> 7; rs ^= rs << 17;
    return (double)(rs >> 11) / 9007199254740992.0;
}
static double now(void) {
    struct timespec t; clock_gettime(CLOCK_MONOTONIC, &t);
    return t.tv_sec + 1e-9 * t.tv_nsec;
}
static double ld(const void* p, char dt, size_t i) {
    return dt == 's' ? ((const float*)p)[i] : ((const double*)p)[i];
}
static void sv(void* p, char dt, size_t i, double v) {
    if (dt == 's') ((float*)p)[i] = (float)v; else ((double*)p)[i] = v;
}
static void* mat(char dt, size_t count) {
    void* p = malloc(count * (dt == 's' ? 4 : 8));
    if (!p) { printf("OUT OF MEMORY\n"); exit(2); }
    return p;
}
static double eps_of(char dt) { return dt == 's' ? 0x1p-23 : 0x1p-52; }
static int all_ok = 1;
static void report(const char* op, char dt, long long n, double wall,
                   double maxres, double berr, double bound, int ok) {
    printf("{\"op\": \"%s\", \"dtype\": \"%c\", \"n\": %lld, "
           "\"wall_s\": %.6f, \"maxres\": %.6e, \"berr\": %.6e, "
           "\"bound\": %.6e, \"ok\": %s}\n", op, dt, n, wall, maxres, berr,
           bound, ok ? "true" : "false");
    fflush(stdout);
    all_ok &= ok;
}
/* max |A x - b| over the columns, and ||A x - b||_inf / (||A||_inf
 * ||x||_inf) */
static void residual(char dt, long long n, long long nrhs, const void* a,
                     const void* x, const void* b, double* maxres,
                     double* berr) {
    double anorm = 0, xnorm = 0, rnorm = 0;
    for (long long i = 0; i < n; i++) {
        double rowsum = 0;
        for (long long j = 0; j < n; j++)
            rowsum += fabs(ld(a, dt, (size_t)i * n + j));
        if (rowsum > anorm) anorm = rowsum;
        for (long long r = 0; r < nrhs; r++) {
            double s = 0;
            for (long long j = 0; j < n; j++)
                s += ld(a, dt, (size_t)i * n + j) * ld(x, dt, j * nrhs + r);
            double d = fabs(s - ld(b, dt, i * nrhs + r));
            if (d > rnorm) rnorm = d;
            if (fabs(ld(x, dt, i * nrhs + r)) > xnorm)
                xnorm = fabs(ld(x, dt, i * nrhs + r));
        }
    }
    *maxres = rnorm;
    *berr = rnorm / (anorm * xnorm);
}
static double solve_bound(char dt, long long n) {
    return dt == 'd' ? REF_BOUND * n / REF_N : 1e-6;
}

static void solves(char dt, long long n) {
    const long long nrhs = 2;
    size_t nn = (size_t)n * n;
    void *a = mat(dt, nn), *acpy = mat(dt, nn), *b = mat(dt, n * nrhs),
         *x = mat(dt, n * nrhs);
    int32_t* ipiv = malloc(n * sizeof(int32_t));
    for (long long i = 0; i < n; i++)
        for (long long j = 0; j <= i; j++) {
            double v = urand() - 0.5;
            sv(acpy, dt, i * n + j, v); sv(acpy, dt, j * n + i, v);
        }
    for (long long i = 0; i < n; i++)
        sv(acpy, dt, i * n + i, ld(acpy, dt, i * n + i) + n);
    for (long long i = 0; i < n * nrhs; i++) sv(b, dt, i, urand());
    double wall = 0, maxres, berr;
    int info = 0;
    for (int rep = 0; rep < 2; rep++) {       /* the second is timed */
        memcpy(a, acpy, nn * (dt == 's' ? 4 : 8));
        memcpy(x, b, n * nrhs * (dt == 's' ? 4 : 8));
        double t0 = now();
        info = slate_posv(dt, n, nrhs, a, n, x, nrhs);
        wall = now() - t0;
    }
    residual(dt, n, nrhs, acpy, x, b, &maxres, &berr);
    report("posv", dt, n, wall, maxres, berr, solve_bound(dt, n),
           info == 0 && (dt == 'd' ? maxres : berr) <= solve_bound(dt, n));
    /* gesv: a general matrix, the same diagonal shift */
    for (long long i = 0; i < n; i++)
        for (long long j = 0; j < n; j++)
            sv(acpy, dt, i * n + j, urand() - 0.5 + (i == j ? n : 0));
    for (int rep = 0; rep < 2; rep++) {
        memcpy(a, acpy, nn * (dt == 's' ? 4 : 8));
        memcpy(x, b, n * nrhs * (dt == 's' ? 4 : 8));
        double t0 = now();
        info = slate_gesv(dt, n, nrhs, a, n, ipiv, x, nrhs);
        wall = now() - t0;
    }
    residual(dt, n, nrhs, acpy, x, b, &maxres, &berr);
    int piv_ok = 1;
    for (long long j = 0; j < n; j++)
        piv_ok &= ipiv[j] >= j && ipiv[j] < n;
    report("gesv", dt, n, wall, maxres, berr, solve_bound(dt, n),
           info == 0 && piv_ok
           && (dt == 'd' ? maxres : berr) <= solve_bound(dt, n));
    /* a non-SPD matrix: posv reports the exact failing minor */
    for (long long i = 0; i < n; i++)
        for (long long j = 0; j <= i; j++) {
            double v = urand() - 0.5;
            sv(acpy, dt, i * n + j, v); sv(acpy, dt, j * n + i, v);
        }
    for (long long i = 0; i < n; i++)
        sv(acpy, dt, i * n + i, ld(acpy, dt, i * n + i) + n);
    long long ks[2] = {5, n / 2 + 4};
    for (int t = 0; t < 2; t++) {
        memcpy(a, acpy, nn * (dt == 's' ? 4 : 8));
        sv(a, dt, ks[t] * n + ks[t], -1000.0);
        memcpy(x, b, n * nrhs * (dt == 's' ? 4 : 8));
        info = slate_posv(dt, n, nrhs, a, n, x, nrhs);
        report("posv_nonspd", dt, ks[t] + 1, 0.0, (double)info, 0.0, 0.0,
               info == ks[t] + 1);
    }
    /* gemm: C = 1.5 A B - 0.5 C, 64 sampled entries held in f64 */
    void *A = mat(dt, nn), *B = mat(dt, nn), *C0 = mat(dt, nn);
    for (size_t i = 0; i < nn; i++) {
        sv(A, dt, i, urand() - 0.5); sv(B, dt, i, urand() - 0.5);
        sv(C0, dt, i, urand() - 0.5);
    }
    for (int rep = 0; rep < 2; rep++) {
        memcpy(a, C0, nn * (dt == 's' ? 4 : 8));
        double t0 = now();
        info = slate_gemm(dt, n, n, n, 1.5, A, n, B, n, -0.5, a, n);
        wall = now() - t0;
    }
    double worst = 0;
    for (int s = 0; s < 64; s++) {
        long long i = (long long)(urand() * n), j = (long long)(urand() * n);
        double ref = 0, mag = 0;
        for (long long k = 0; k < n; k++) {
            double p = ld(A, dt, i * n + k) * ld(B, dt, k * n + j);
            ref += p; mag += fabs(p);
        }
        double c0 = ld(C0, dt, i * n + j);
        double d = fabs(ld(a, dt, i * n + j) - (1.5 * ref - 0.5 * c0));
        double r = d / (2.0 * n * eps_of(dt) * (1.5 * mag + 0.5 * fabs(c0)));
        if (r > worst) worst = r;
    }
    report("gemm", dt, n, wall, worst, 0.0, 1.0, info == 0 && worst <= 1.0);
    free(A); free(B); free(C0);
    free(a); free(acpy); free(b); free(x); free(ipiv);
}

static void least_squares(char dt, long long m, long long n) {
    const long long nrhs = 2;
    void *a = mat(dt, (size_t)m * n), *acpy = mat(dt, (size_t)m * n),
         *b = mat(dt, m * nrhs), *x = mat(dt, m * nrhs);
    for (size_t i = 0; i < (size_t)m * n; i++) sv(acpy, dt, i, urand() - 0.5);
    for (long long i = 0; i < m * nrhs; i++) sv(b, dt, i, urand() - 0.5);
    double wall = 0;
    int info = 0;
    for (int rep = 0; rep < 2; rep++) {
        memcpy(a, acpy, (size_t)m * n * (dt == 's' ? 4 : 8));
        memcpy(x, b, m * nrhs * (dt == 's' ? 4 : 8));
        double t0 = now();
        info = slate_gels(dt, m, n, nrhs, a, n, x, nrhs);
        wall = now() - t0;
    }
    /* the tester's ratio ||A^T (A x - b)|| / (||A||^2 ||x|| n eps) */
    double* r = calloc(m * nrhs, sizeof(double));
    double anorm2 = 0, xnorm2 = 0, gnorm2 = 0;
    for (long long i = 0; i < m; i++)
        for (long long c = 0; c < nrhs; c++) {
            double s = -ld(b, dt, i * nrhs + c);
            for (long long j = 0; j < n; j++)
                s += ld(acpy, dt, (size_t)i * n + j) * ld(x, dt, j * nrhs + c);
            r[i * nrhs + c] = s;
        }
    for (size_t i = 0; i < (size_t)m * n; i++)
        anorm2 += ld(acpy, dt, i) * ld(acpy, dt, i);
    for (long long j = 0; j < n * nrhs; j++)
        xnorm2 += ld(x, dt, j) * ld(x, dt, j);
    for (long long j = 0; j < n; j++)
        for (long long c = 0; c < nrhs; c++) {
            double s = 0;
            for (long long i = 0; i < m; i++)
                s += ld(acpy, dt, (size_t)i * n + j) * r[i * nrhs + c];
            gnorm2 += s * s;
        }
    double ratio = sqrt(gnorm2) / (anorm2 * sqrt(xnorm2) * n * eps_of(dt));
    report("gels", dt, m, wall, ratio, 0.0, 100.0, info == 0 && ratio < 100);
    free(r); free(a); free(acpy); free(b); free(x);
}

/* heev and svd_vals: the inputs and outputs go to files in `dir` for
 * the comparison with numpy */
static void spectra(char dt, long long n, const char* dir) {
    size_t nn = (size_t)n * n, es = dt == 's' ? 4 : 8;
    void *h = mat(dt, nn), *g = mat(dt, nn), *w = mat(dt, n),
         *s = mat(dt, n), *work = mat(dt, nn);
    for (long long i = 0; i < n; i++)
        for (long long j = 0; j <= i; j++) {
            double v = urand() - 0.5;
            sv(h, dt, i * n + j, v); sv(h, dt, j * n + i, v);
        }
    for (size_t i = 0; i < nn; i++) sv(g, dt, i, urand() - 0.5);
    memcpy(work, h, nn * es);
    double t0 = now();
    int info = slate_heev(dt, n, work, n, w);
    double wall = now() - t0;
    report("heev", dt, n, wall, 0.0, 0.0, 0.0, info == 0);
    memcpy(work, g, nn * es);
    t0 = now();
    info = slate_svd_vals(dt, n, n, work, n, s);
    wall = now() - t0;
    report("svd_vals", dt, n, wall, 0.0, 0.0, 0.0, info == 0);
    const char* names[4] = {"h", "w", "g", "s"};
    void* bufs[4] = {h, w, g, s};
    size_t counts[4] = {nn, (size_t)n, nn, (size_t)n};
    for (int f = 0; f < 4; f++) {
        char path[4096];
        snprintf(path, sizeof path, "%s/%s_%c.bin", dir, names[f], dt);
        FILE* fp = fopen(path, "wb");
        if (!fp || fwrite(bufs[f], es, counts[f], fp) != counts[f]) {
            printf("WRITE FAILED %s\n", path); exit(2);
        }
        fclose(fp);
    }
    free(h); free(g); free(w); free(s); free(work);
}

int main(int argc, char** argv) {
    if (argc < 6) {
        printf("usage: c_smoke DIR N M_GELS N_GELS N_EIG\n");
        return 2;
    }
    double t0 = now();
    if (slate_tpu_init("cuda") != 0) { printf("INIT FAIL\n"); return 1; }
    printf("{\"op\": \"init\", \"wall_s\": %.6f}\n", now() - t0);
    const char dts[2] = {'s', 'd'};
    for (int t = 0; t < 2; t++) {
        solves(dts[t], atoll(argv[2]));
        least_squares(dts[t], atoll(argv[3]), atoll(argv[4]));
        spectra(dts[t], atoll(argv[5]), argv[1]);
    }
    printf(all_ok ? "C API OK\n" : "C API FAILED\n");
    return all_ok ? 0 : 1;
}
"""



def c_direct_walls(seed):
    """The walls of the C program's posv / gesv / gemm / gels calls
    made in this process through the same bridge functions (no C shim,
    no embedded interpreter), on inputs of the same shapes and types;
    the second of two calls each, the input copies outside the clock as
    in the C program."""
    from slate_tpu_torch.c_api import bridge
    bridge.set_platform("cuda")
    rng = np.random.default_rng(seed)
    walls = {}
    for dt, npt in (("s", np.float32), ("d", np.float64)):
        n, nrhs, m, w = C_N, 2, C_M_GELS, C_N_GELS
        g = (rng.random((n, n)) - 0.5).astype(npt)
        inputs = {
            "posv": ((g + g.T) / 2 + n * np.eye(n, dtype=npt),
                     rng.random((n, nrhs)).astype(npt)),
            "gesv": (g + n * np.eye(n, dtype=npt),
                     np.zeros(n, np.int32),
                     rng.random((n, nrhs)).astype(npt)),
            "gemm": (g, np.zeros((n, n), npt)),
            "gels": ((rng.random((m, w)) - 0.5).astype(npt),
                     (rng.random((m, nrhs)) - 0.5).astype(npt))}
        shape_args = {
            "posv": lambda p: (n, nrhs, p[0], n, p[1], nrhs),
            "gesv": lambda p: (n, nrhs, p[0], n, p[1], p[2], nrhs),
            "gemm": lambda p: (n, n, n, 1.5, p[0], n, p[0], n, -0.5,
                               p[1], n),
            "gels": lambda p: (m, w, nrhs, p[0], w, p[1], nrhs)}
        for op, arrays in inputs.items():
            for _ in range(2):
                # fresh copies, alive through the call: the bridge
                # writes through their addresses
                bufs = [x.copy() for x in arrays]
                args = shape_args[op]([x.ctypes.data for x in bufs])
                t0 = time.perf_counter()
                info = getattr(bridge, op)(dt, *args)
                walls[op + "." + dt] = time.perf_counter() - t0
                if info != 0:
                    raise RuntimeError("bridge.%s(%r): info %d"
                                       % (op, dt, info))
            del bufs
    return walls


def phase_c_api(seed):
    """The C API (slate_tpu_torch/c_api): build the library, compile a C
    program (C_PROGRAM) against the port's header and run it with
    slate_tpu_init("cuda"), its embedded interpreter handed this
    interpreter's sys.path: posv, gesv and gemm at C_N and gels at
    C_M_GELS x C_N_GELS in s and d, residuals computed in C against
    the bounds above; two non-SPD posv reporting their exact failing
    minor; heev and svd_vals at C_N_EIG held here against numpy's f64
    eigvalsh / svd of the same matrices (4 n eps of the largest). Then
    the same calls' walls made in this process through the bridge."""
    from slate_tpu_torch import c_api
    out = {"phase": "c_api"}
    t0 = time.perf_counter()
    so = c_api.build_library(force=True)
    out["build_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        src, exe = os.path.join(d, "c_smoke.c"), os.path.join(d, "c_smoke")
        with open(src, "w") as f:
            f.write(C_PROGRAM)
        subprocess.run(["gcc", "-O2", src, "-o", exe,
                        f"-I{c_api.HEADER.parent}",
                        f"-DREF_BOUND={C_REF_BOUND!r}",
                        f"-DREF_N={C_REF_N}", str(so),
                        f"-Wl,-rpath,{so.parent}", "-lm"],
                       check=True, capture_output=True, timeout=180)
        t0 = time.perf_counter()
        run = subprocess.run([exe, d, str(C_N), str(C_M_GELS),
                              str(C_N_GELS), str(C_N_EIG)],
                             env=c_api.embed_env(), capture_output=True,
                             text=True, timeout=600)
        out["program_s"] = time.perf_counter() - t0
        rows = [json.loads(line) for line in run.stdout.splitlines()
                if line.startswith("{")]
        spectra = {}
        for dt, npt in (("s", np.float32), ("d", np.float64)):
            if not os.path.exists(os.path.join(d, "s_%s.bin" % dt)):
                continue
            buf = {k: np.fromfile(os.path.join(d, "%s_%s.bin" % (k, dt)),
                                  npt) for k in "hwgs"}
            n = C_N_EIG
            wr = np.linalg.eigvalsh(buf["h"].reshape(n, n).astype(
                np.float64))
            sr = np.linalg.svd(buf["g"].reshape(n, n).astype(np.float64),
                               compute_uv=False)
            eps = float(np.finfo(npt).eps)
            spectra[dt] = {
                "heev": float(np.abs(buf["w"] - wr).max()
                              / np.abs(wr).max()),
                "svd_vals": float(np.abs(buf["s"] - sr).max() / sr.max()),
                "limit": 4.0 * n * eps}
    out["rows"] = rows
    out["spectra"] = spectra
    if run.returncode != 0:
        out["stdout_tail"] = run.stdout[-2000:]
        out["stderr_tail"] = run.stderr[-2000:]
    out["direct_walls_s"] = c_direct_walls(seed)
    out["ok"] = bool(
        run.returncode == 0 and "C API OK" in run.stdout
        and rows and all(r.get("ok", True) for r in rows)
        and len([r for r in rows if r["op"] != "init"]) == 2 * 8
        and len(spectra) == 2
        and all(v[k] <= v["limit"] for v in spectra.values()
                for k in ("heev", "svd_vals")))
    return out


#: non-uniform tiles at N: four tiles of 2048, then eight of 1024 (the
#: largest divides N, so uniform() re-tiles without padding and getrf
#: takes phase gesv's blocking; 3072 would pad to 18432, whose blocking
#: and panel route are another cell's)
NU_SIZES = [2048] * 4 + [1024] * 8


def nu_pair(walls, name, nu_call, u_call):
    """The non-uniform call and its uniform() twin in turns (nu, u, u,
    nu), each's two walls; returns the last results of both."""
    w_nu, w_u = [], []
    w, _ = wall_s(nu_call)
    w_nu.append(w)
    for _ in range(2):
        w, u = wall_s(u_call)
        w_u.append(w)
    w, nu = wall_s(nu_call)
    w_nu.append(w)
    walls[name], walls[name + ".uniform"] = w_nu, w_u
    return nu, u


def phase_nonuniform(seed, results):
    """Non-uniform tiles (TiledMatrix.from_func) at N: gemm on
    non-uniform operands against the same product on uniform() and
    against torch.matmul (1e-6); potrf and getrf / gesv on the
    non-uniform matrices (the drivers re-tile at entry) beside the same
    calls on uniform(): the residuals within the uniform route's bound
    (1e-6), getrf's pivots equal, the factors and X bitwise. The tune
    cache routes the f32 LU as phase gesv (harness_tune_cache)."""
    harness_tune_cache()
    TM = st.TiledMatrix
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    g = torch.randn((N, N), generator=gen, device="cuda")
    h = torch.randn((N, N), generator=gen, device="cuda")
    A = TM.from_func(g, NU_SIZES, device="cuda")
    B = TM.from_func(h, NU_SIZES, device="cuda")
    C0 = TM.from_func(torch.zeros_like(g), NU_SIZES, device="cuda")
    out = {"phase": "nonuniform", "n": N, "tiles": NU_SIZES,
           "uniform_tile": A.uniform().mb}
    walls = {}
    C, Cu = nu_pair(walls, "gemm", lambda: st.gemm(1.0, A, B, 0.0, C0),
                    lambda: st.gemm(1.0, A.uniform(), B.uniform(), 0.0,
                                    C0.uniform()))
    ref = g @ h
    out["gemm_rel_diff"] = [rel_diff(C.to_dense(), Cu.to_dense()),
                            rel_diff(C.to_dense(), ref)]
    del C, Cu, ref
    s = g @ g.T / N + torch.eye(N, device="cuda")
    S = dataclasses.replace(TM.from_func(s, NU_SIZES, device="cuda"),
                            mtype=st.MatrixType.Hermitian,
                            uplo=st.Uplo.Lower)
    L, Lu = nu_pair(walls, "potrf", lambda: st.potrf(S),
                    lambda: st.potrf(S.uniform()))

    def chol_res(F):
        l64 = F.to_dense().double()
        return float(torch.linalg.norm(l64 @ l64.T - s.double())
                     / torch.linalg.norm(s.double()))

    out["potrf_residual"] = [chol_res(L), chol_res(Lu)]
    out["potrf_equal"] = torch.equal(L.to_dense(), Lu.to_dense())
    del L, Lu, S, s
    a = g + 2.0 * float(np.sqrt(N)) * torch.eye(N, device="cuda")
    Anu = TM.from_func(a, NU_SIZES, device="cuda")
    st.getrf(Anu)                                    # warm-up
    pk.reset_launch_counts()
    st.getrf(Anu)
    torch.cuda.synchronize()
    launches = pk.launch_counts()
    add_phase_launches(results, "nonuniform", launches)
    F, Fu = nu_pair(walls, "getrf", lambda: st.getrf(Anu),
                    lambda: st.getrf(Anu.uniform()))
    out["getrf_residual"] = [
        lu_residual(a, F.LU.data[:N, :N], F.pivots[:N]),
        lu_residual(a, Fu.LU.data[:N, :N], Fu.pivots[:N])]
    out["pivots_equal"] = torch.equal(F.pivots, Fu.pivots)
    out["factors_equal"] = torch.equal(F.LU.data, Fu.LU.data)
    del F, Fu
    b = torch.randn((N, NRHS), generator=gen, device="cuda")
    Bnu = TM.from_func(b, NU_SIZES, [NRHS], device="cuda")
    (_, X), (_, Xu) = nu_pair(walls, "gesv", lambda: st.gesv(Anu, Bnu),
                              lambda: st.gesv(Anu.uniform(),
                                              Bnu.uniform()))
    out["gesv_backward_error"] = [berr_dense(a, X.to_dense(), b),
                                  berr_dense(a, Xu.to_dense(), b)]
    out["x_equal"] = torch.equal(X.to_dense(), Xu.to_dense())
    out["walls_s"] = walls
    out["launches"] = launches
    out["ok"] = bool(
        max(out["gemm_rel_diff"]) <= 1e-6
        and max(out["potrf_residual"]) <= 1e-6
        and max(out["getrf_residual"]) <= 1e-6
        and max(out["gesv_backward_error"]) <= 1e-6
        and out["pivots_equal"] and out["factors_equal"]
        and out["potrf_equal"] and out["x_equal"]
        and all(launches[k] > 0 for k in HARNESS_KERNELS))
    return out


def phase_examples():
    """The example twins: examples/torch/run_all.py --device cuda in a
    process of its own (every twin's own assertions; ex13 on a world of
    one rank)."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch",
                                      "run_all.py"), "--device", "cuda"],
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    ran = run.stdout.count("=== ex")
    return {"phase": "examples", "ok": bool(
        run.returncode == 0 and "All examples passed" in run.stdout
        and ran == 17), "examples": ran, "wall_s": wall,
        "tail": run.stdout[-1500:] if run.returncode else
        run.stdout.splitlines()[-1]}


#: trace categories of work on the card; other rows of a profiler trace
#: (operators, runtime calls, the profiler's own buffer flushes) are not
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


#: kernels whose share of a profiled call's busy time is reported: the
#: trailing update of the LU panel split (its bf16 path transposes U12
#: first), the LU panels' base case over the grid (either panel kernel),
#: the rank-1 panel's one-block base case and its trailing-column
#: updates (the three together: lu_panel's device time), the
#: Householder panel, the ragged solve, the swap composition, the
#: QR iterations' sweeps and Givens chain, and the packed bf16 LU solve
WATCH = {"rank_update": ("rank_update_", "transpose_bf16"),
         "lu_base": ("lu_base_",), "lu_block": ("lu_block_kernel",),
         "lu_trail": ("lu_trail_kernel",),
         "qr_panel": ("qr_panel_kernel",),
         "ragged_trsm": ("ragged_trsm_kernel",),
         "compose_swaps": ("compose_swaps_kernel",),
         "steqr_sweep": ("steqr_sweep",),
         "bdsqr_sweep": ("bdsqr_sweeps_kernel",),
         "givens_chain_apply": ("givens_chain_tma",),
         "lu_solve_packed": ("lu_solve_kernel",)}


def profile_call(fn, top=8):
    """One (already warm) call under torch.profiler. Busy time is the
    union of the device intervals in the exported trace, so overlapping
    kernels count once; `watch` gives the device ms, launches and share
    of busy time of the WATCH kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, _ = wall_s(fn)
    with tempfile.TemporaryDirectory(prefix="slate_tpu_torch_prof_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t, dur = float(e["ts"]), float(e.get("dur", 0.0))
        spans.append((t, t + dur))
        ms, calls = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + dur / 1e3, calls + 1)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e6
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    watch = {}
    for label, subs in WATCH.items():
        hits = [v for k, v in by_name.items() if any(x in k for x in subs)]
        ms = sum(v[0] for v in hits)
        watch[label] = {"device_ms": ms, "calls": sum(v[1] for v in hits),
                        "busy_share": ms / 1e3 / busy if busy else None}
    return {"wall_s": wall, "device_events": len(spans),
            "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall if spans else None,
            "watch": watch,
            "top": [{"kernel": k[:100], "device_ms": ms, "calls": c}
                    for k, (ms, c) in heavy]}


def lu_base_bound_ms(dtype):
    """The LU base case's bound a segment (32 columns, the frozen ib),
    over gesv's 512 of them at n = N, nb = NB (panel k at height
    N - NB k, its segment j at N - NB k - 32 j): the mean segment read
    and written once, or its operations at the f32 rate."""
    ib = pk.LU_REC_IB
    hs = [N - NB * k - ib * j for k in range(N // NB)
          for j in range(NB // ib)]
    esize = torch.tensor([], dtype=dtype).element_size()
    return bound_ms(sum(panel_flops(h, ib) for h in hs) / len(hs),
                    2.0 * esize * ib * sum(hs) / len(hs))


def phase_profile(system):
    """Where the time of the main paths goes: gesv on both routes (f32
    recursive panels cached), gesv_mixed (recursive panels cached for
    both types), gesv_mixed cold at n = 4096 (its 16 lu_panel
    launches), posv on both routes, gbsv and the f32 hesv of phases
    band and indefinite (f32 recursive panels cached), the square gels,
    the bf16 gels (its 64 qr_panel launches), one ragged
    posv flush of the serving stream's first 64 requests (host stacking
    and copies included), and posv_ooc at N_OOC_SCHED (panels of
    W_OOC_SCHED, budget 0: the copies' share of the card's time)."""
    A, B, opts = system["A"], system["B"], system["opts"]
    fresh_tune_cache([torch.float32])
    out = {"phase": "profile", "ok": True,
           "pallas_rec": profile_call(lambda: st.gesv(A, B, opts)),
           "lu_base_bound_ms": {dn: lu_base_bound_ms(dt)
                                for dn, dt in DTYPES}}
    with tselect.disabled():
        out["cold"] = profile_call(lambda: st.gesv(A, B, opts))
    fresh_tune_cache([torch.float32, torch.bfloat16])
    out["gesv_mixed"] = profile_call(lambda: st.gesv_mixed(A, B, opts))
    fresh_tune_cache()
    CA, CB = system["cold"]
    out["gesv_mixed.cold"] = profile_call(lambda: st.gesv_mixed(CA, CB))
    SA, SB = system["SA"], system["SB"]
    out["posv.fused"] = profile_call(lambda: st.posv(SA, SB))
    out["posv.tiled"] = profile_call(lambda: st.posv(
        SA, SB, {st.Option.MethodFactor: st.MethodFactor.Tiled}))
    fresh_tune_cache([torch.float32])
    BA, BB = system["band"]
    out["band.gbsv"] = profile_call(lambda: st.gbsv(BA, BB))
    IA, IB = system["indefinite"]
    out["indefinite.hesv"] = profile_call(lambda: st.hesv(IA, IB))
    fresh_tune_cache()
    out["gels.qr"] = profile_call(lambda: st.gels(
        A, B, {st.Option.MethodGels: st.MethodGels.QR}))
    Ab, Bb = system["gels_bf16"]
    out["gels_bf16"] = profile_call(lambda: st.gels(Ab, Bb))
    mats, rhss = system["serve_posv"]
    out["batch.ragged_posv"] = profile_call(
        lambda: serve_run("posv", mats, rhss, "ragged"))
    s_ooc, b_ooc = system["ooc"]
    out["ooc.posv_ooc"] = profile_call(lambda: st.posv_ooc(
        s_ooc, b_ooc, panel_cols=W_OOC_SCHED))
    route_chain("steqr2", torch.float32, N_EIG)
    out["heev.qr_iteration"] = profile_call(
        lambda: st.heev(system["eig_A"], system["eig_opts"]))
    route_chain("bdsqr", torch.float32, N_SVD)
    out["svd.qr_iteration"] = profile_call(
        lambda: st.svd(system["svd_A"], system["svd_opts"]))
    return out


#: the packed bf16 solve: the mixed cell's preconditioner solve (order
#: N, one right-hand side), and its adversarial shapes (orders not a
#: multiple of its 128-row blocks, up to 4 right-hand sides)
LS_SHAPES = ((1, 1), (33, 3), (200, 1), (529, 3), (1000, 4), (4100, 2))
#: the cycles of one U quotient (Markstein: a product and four
#: dependent fmas), for the kernel's latency floor
LS_DIV_CYCLES = 5 * DEP_OP_CYCLES


def ls_system(n, seed, zero_pivot=None):
    """A packed bf16 LU factor of a permuted boosted system, stored as
    getrf stores it (leading dimension a multiple of 8), its composed
    permutation, and a 512-column bf16 right-hand side (B as users
    wrap it)."""
    a, _ = permuted_boosted_system(torch.Generator(device="cuda")
                                   .manual_seed(seed), n, 1)
    lu, piv = torch.linalg.lu_factor(a)
    del a
    store = torch.zeros((n, -(-n // 8) * 8), dtype=torch.bfloat16,
                        device="cuda")
    store[:, :n] = lu
    if zero_pivot is not None:
        store[zero_pivot, zero_pivot] = 0
    perm = pk.lu_pivots_to_permutation((piv - 1).to(torch.int32), n)
    b = torch.randn((n, 512), generator=torch.Generator(device="cuda")
                    .manual_seed(seed + 1), device="cuda").to(torch.bfloat16)
    return store[:, :n], perm, b


def ls_library(lu, perm, b, k):
    """The route the kernel replaced in getrs, on the same operands:
    B permuted, each half of the factor masked (tril / triu, L's
    diagonal set to 1) and upcast, two library triangular solves, y and
    x rounded to bf16."""
    n = lu.shape[0]
    L = lu.tril()
    L.diagonal().fill_(1)
    y = torch.linalg.solve_triangular(
        L.float(), b[perm[:n], :k].float(), upper=False,
        unitriangular=True).to(torch.bfloat16)
    del L
    return torch.linalg.solve_triangular(
        lu.triu().float(), y.float(), upper=True).to(torch.bfloat16)


def ls_agree(x, ref):
    """The kernel's agreement rule: ||x - ref|| <= 2^-7 ||ref|| and at
    least 99% of the entries within one bf16 ulp of ref (not bitwise:
    a 1-ulp flip in the bf16 y carries into x through U)."""
    x, ref = x.double(), ref.double()
    norm = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
    _, e = torch.frexp(ref)
    within = float((torch.abs(x - ref)
                    <= torch.ldexp(torch.ones_like(ref), e - 8))
                   .double().mean())
    return {"normwise": norm, "within_ulp": within,
            "ok": norm <= 2.0 ** -7 and within >= 0.99}


def ls_latency_ms(n):
    """The kernel's latency floor: per row of each sweep one dependent
    fma (U's also its quotient), and one exchange through L2 a block
    boundary."""
    return latency_ms(n, 2 * DEP_OP_CYCLES + LS_DIV_CYCLES) \
        + latency_ms(2 * (-(-n // pk.LU_SOLVE_PACKED_ROWS)), EXCHANGE_CYCLES)


def phase_lu_solve_packed(seed, results):
    """The packed bf16 LU solve: held against its plain version and
    against the library route it replaced (the same agreement rule
    for both) on the adversarial shapes, at order N with one
    right-hand side (the mixed cell's preconditioner solve), and through
    getrs; a zero pivot gives the library's inf / nan pattern and
    returns. Times at N: back to back and replayed from a CUDA graph,
    the plain version's, the library route's, the byte bound (the
    factor read once as bf16) and the latency floor; 2 and 4
    right-hand sides timed too."""
    out = {"phase": "kernel.lu_solve_packed", "ok": True}
    for n, k in LS_SHAPES:
        lu, perm, b = ls_system(n, seed + n)
        x = pk.lu_solve_packed(lu, perm, b, k)
        torch.cuda.synchronize()
        r = {"plain": ls_agree(x, pk.lu_solve_packed_plain(lu, perm, b, k)),
             "library": ls_agree(x, ls_library(lu, perm, b, k))}
        out["n%d.k%d" % (n, k)] = r
        out["ok"] &= r["plain"]["ok"] and r["library"]["ok"]
    lu, perm, b = ls_system(1000, seed, zero_pivot=700)
    x = pk.lu_solve_packed(lu, perm, b, 1).float()
    torch.cuda.synchronize()
    ref = ls_library(lu, perm, b, 1).float()
    fin = torch.isfinite(ref)
    zp = {"same_nan": bool(torch.equal(torch.isnan(x), torch.isnan(ref))),
          "same_inf": bool(torch.equal(torch.isinf(x), torch.isinf(ref))),
          "nan": int(torch.isnan(x).sum()), "inf": int(torch.isinf(x).sum()),
          "finite_equal": bool(torch.equal(x[fin], ref[fin]))}
    out["zero_pivot.n1000"] = zp
    out["ok"] &= zp["same_nan"] and zp["same_inf"] and zp["nan"] > 0
    n = N
    lu, perm, b = ls_system(n, seed)
    pk.reset_launch_counts()
    x = pk.lu_solve_packed(lu, perm, b, 1)
    launches = pk.launch_counts()["lu_solve_packed"]
    xp = pk.lu_solve_packed_plain(lu, perm, b, 1)
    xl = ls_library(lu, perm, b, 1)
    s = {"shape": "%d x %d bf16, 1 rhs" % (n, n),
         "max_abs_err": float((x.float() - xl.float()).abs().max()),
         "plain": ls_agree(x, xp), "library": ls_agree(x, xl),
         "plain_vs_library": ls_agree(xp, xl), "launches_a_call": launches}
    del xp, xl
    buf = torch.empty((n, 1), dtype=torch.bfloat16, device="cuda")
    run = functools.partial(pk.lu_solve_packed, lu, perm, b, 1, out=buf)
    s["ms"] = cuda_ms(run, 20)
    s["graph_ms"] = graph_ms(run, 20)
    s["plain_ms"] = cuda_ms(lambda: pk.lu_solve_packed_plain(lu, perm, b, 1),
                            3)
    s["library_ms"] = cuda_ms(lambda: ls_library(lu, perm, b, 1), 5)
    s["bound_ms"], s["bound_by"] = bound_ms(0.0, 2.0 * n * n + 8.0 * n
                                            + 2.0 * 2 * n)
    s["latency_bound_ms"] = ls_latency_ms(n)
    for k in (2, 4):
        s["ms.k%d" % k] = cuda_ms(
            functools.partial(pk.lu_solve_packed, lu, perm, b, k), 10)
    # through getrs: the bf16 factor and B as the mixed cell holds them
    F = st.LUFactors(st.Matrix(lu, mb=NB, device=lu.device), torch.arange(
        n, dtype=torch.int32, device=lu.device))
    B1 = st.Matrix(b[:, :1].contiguous(), mb=NB, device=lu.device)
    pk.reset_launch_counts()
    xg = st.getrs(F, B1).to_dense()
    s["getrs_launches"] = pk.launch_counts()["lu_solve_packed"]
    s["getrs"] = ls_agree(xg, ls_library(lu, torch.arange(
        n, device="cuda"), b, 1))
    out["n%d.k1" % n] = s
    out["ok"] &= (s["plain"]["ok"] and s["library"]["ok"]
                  and s["getrs"]["ok"] and launches == 1
                  and s["getrs_launches"] == 1)
    results["lu_solve_packed"] = entry(
        "lu_solve_packed", "bfloat16", "lu_solve_packed.cu",
        "slate_tpu/linalg/lu.py getrs (XLA triangular_solve, twice)",
        "gesv_mixed_gmres.cold", s, s["max_abs_err"])
    return out


def main():
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 2
    rng = np.random.default_rng(args.seed)
    results, system = {}, {}
    failed = []
    device = None
    phases = (
        ("device", phase_device), ("build", phase_build),
        ("kernel.compose_swaps",
         lambda: phase_compose_swaps(rng, args.seed, results)),
        ("kernel.lu_panel", lambda: phase_lu_panel(rng, results)),
        ("kernel.lu_panel_rec", lambda: phase_panel_rec(rng, results)),
        ("kernel.rank_update", lambda: phase_rank_update(rng, results)),
        ("kernel.qr_panel", lambda: phase_qr_panel(rng, results)),
        ("kernel.chol_panel", lambda: phase_chol_panel(results)),
        ("kernel.trtri_lower", lambda: phase_trtri_lower(results)),
        ("kernel.ragged_potrf",
         lambda: phase_ragged_potrf(args.seed, results)),
        ("kernel.ragged_getrf",
         lambda: phase_ragged_getrf(args.seed, results)),
        ("kernel.ragged_trsm",
         lambda: phase_ragged_trsm(args.seed, results)),
        ("kernel.givens_chain", lambda: phase_givens_chain(rng, results)),
        ("kernel.qr_sweep", lambda: phase_qr_sweep(rng, results)),
        ("kernel.lu_solve_packed",
         lambda: phase_lu_solve_packed(args.seed, results)),
        ("gesv", lambda: phase_gesv(args.seed, results, system)),
        ("gesv_mixed.cold",
         lambda: phase_mixed_cold(args.seed, results, system)),
        ("gesv_mixed", lambda: phase_mixed(results, system)),
        ("tune.autotune", lambda: phase_autotune(results, system)),
        ("lu.variants", lambda: phase_lu_variants(args.seed)),
        ("band", lambda: phase_band(args.seed, results, system)),
        ("indefinite",
         lambda: phase_indefinite(args.seed, results, system)),
        ("api", lambda: phase_api(args.seed, results)),
        ("posv", lambda: phase_posv(args.seed, system)),
        ("posv_mixed", lambda: phase_posv_mixed(system)),
        ("gels", lambda: phase_gels(args.seed, system)),
        ("gels_bf16", lambda: phase_gels_bf16(args.seed, results, system)),
        ("batch.serve",
         lambda: phase_batch_serve(args.seed, results, system)),
        ("heev", lambda: phase_heev(args.seed, results, system)),
        ("svd", lambda: phase_svd(args.seed, results, system)),
        ("spectral_dc", lambda: phase_spectral_dc(args.seed)),
        ("obs.resil", lambda: phase_obs_resil(args.seed, results, system)),
        ("serve", lambda: phase_serve(args.seed, results)),
        ("grid", lambda: phase_grid(args.seed, results, system)),
        ("ooc", lambda: phase_ooc(args.seed, results, system)),
        ("shard_ooc", lambda: phase_shard_ooc(args.seed, results)),
        ("harness", lambda: phase_harness(results)),
        ("c_api", lambda: phase_c_api(args.seed)),
        ("nonuniform", lambda: phase_nonuniform(args.seed, results)),
        ("examples", phase_examples),
        ("profile", lambda: phase_profile(system)))
    walls = {}
    try:
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                out = fn()
            except Exception as e:          # report the phase, then stop
                import traceback
                traceback.print_exc()
                out = {"phase": name, "ok": False,
                       "error": "%s: %s" % (type(e).__name__, e)}
            if name != "obs.resil" and guard.counts():
                # only obs.resil injects a fault: any other phase that
                # retried or fell back is a failure
                out["ok"] = False
                out["guard_counts"] = guard.counts()
            out["wall_s"] = walls[name] = time.perf_counter() - t0
            emit(out)
            if name == "device":
                device = out
            if not out["ok"]:
                failed.append(name)
                break
    finally:
        for d in _TUNE_DIRS:
            d.cleanup()
    emit({"phase_walls": {**walls, "phases_s": sum(walls.values()),
                          "script_s": time.perf_counter() - t_start}})
    if not failed:
        unlaunched = [e["name"] + "." + e["dtype"] for e in results.values()
                      if not e["launches"]]
        if unlaunched:
            print("chip_smoke: kernels not launched on their path: %s"
                  % unlaunched, file=sys.stderr)
            failed.append("launches")
    if failed:
        print("chip_smoke: failed phase(s): %s" % failed, file=sys.stderr)
        return 1
    # MAGMA, under the library LU of the cold routes, writes its
    # warnings through C stdio: flush them before the result lines
    ctypes.CDLL(None).fflush(None)
    emit({"kernels": list(results.values())})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["kind"],
                                 "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
