#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from the sources in this checkout (one
   nvcc per source, all started together), and fails unless the SASS of
   ``hpd_stream.cu`` shows warpgroup MMAs (HGMMA) in every instance of
   every pass of the dedup route's tail (the forward's rows and columns
   passes, K7, the backward's four kernels) and no tensor-core instruction
   in the forward's exact fp32 fix-up, and that of ``hpd_full.cu`` and
   ``hpd_tail.cu`` shows warp-level MMAs (HMMA) in every instance of K11's
   ``full_bwd_kernel`` (its head's products and its hidden layers' dW and
   dh), K10's ``full_fwd_kernel`` and K9's
   ``tail_bwd_kernel`` (their head products) and none in K8's
   ``tail_fwd_kernel`` (redesigned in fp32 on the CUDA cores: its
   tensor-core design lost to it), that of ``hidden.cu``
   HMMA in every instance (precision x row tile x weight staging) of K3a's
   and K3b's kernels and in K3b's dW kernel, that of the forward's wide
   passes of ``hpd_stream.cu`` (heads past 128) no tensor-core instruction, and
   that of ``probe.cu`` HMMA in both instances of K13's tensor-core kernel
   (which 'default' runs too) and none in its fp32 SGEMM ('highest');
2. holds every kernel of the dedup route against its plain PyTorch
   version on the same inputs at the path's shapes (scaled grid-4061
   geometry on the strawberry image: H=128, T=16384, L=16, K=4, the full
   U_c = 161,792 rows of the first batch, real h for the tail), checks
   that the deterministic outputs are bitwise equal run to run, and times
   kernel and plain version on the same inputs (K3a and K3b, on the
   init's stack and on the wide stack [2 -> 256 -> 512 -> 256] at the same
   U_c and the init's scale, against the stack's algebra in float64 with
   the kernels' own ReLU decisions, the flips against the fp32 plain
   version counted and its own error logged; K1 and K2 beside their
   times before the tensor-core redesigns; step 5 prints K2's device time
   by launch); K1's top-K must be identical on every row, and it prints
   how many rows its guard handed to the fp32 fix-up; holds K12's narrow
   variant bitwise to its plain version on ``gather_rows``' table gradient
   of batch 0 (rows of F = 2 columns on L * U_c slots), timed beside
   ``index_add_``;
3. trains a small streamed geometry on the card and on the CPU and
   compares the losses (kernels vs plain versions end to end);
4. runs ``fit`` on grid 4061 at scaled geometry for 3 epochs with the
   launch counts set to 0 just before (every fit of steps 3-16 writes no
   checkpoint; each prints its counts epochs' statistics seconds), and fails unless every kernel
   launched (K12 in both variants: the blend's and ``gather_rows``' table
   gradients) and the loss is finite and falls;
5. profiles one more epoch of that training (device time by kernel, the
   device's idle share);
6. holds the per-row kernels K8-K11 against their plain versions on all
   918,464 rows (L * P_batch * V) of batch 0 of the per-row route (grid
   4061, default geometry, ``batchnorm_input=True`` on raw pixel coords:
   T=256, L=4, K=4, HPD [2->32->64->128->256]), real vertices for K10/K11
   and real last hidden activations for K8/K9, with the same checks and
   timings as step 2; K10's top-K must be identical on every row, and it
   prints how many rows its guard left to its fp32 redo; then K10 on a
   planted network at the same L and N (near-ties at the K-th place on
   every row, a cluster deeper than the candidates on every 8th), where
   the top-K must again be identical on every row and exactly the cluster
   rows must be redone in fp32 (the redo at a tiling where each block
   walks many row tiles); K8 also at K = 32 and 128 on the same rows, and
   on the planted network's head input at K = 4 and 8 (top-K identical on
   every row, bitwise stable); K8, K9, K10 and K11 beside their times
   before their redesigns, the bounds of K9-K11 their tensor-core products
   (the head's; K11's hidden dW and dh too) as 3xTF32 at the TF32 peak
   plus the rest at the fp32 peak, the all-fp32 bound beside;
7. trains a small per-row geometry on the card and on the CPU, through
   K10/K11 and through K8/K9, and compares the losses;
8. runs ``fit`` on that per-row configuration for 3 epochs through
   K10/K11 (hpd_backend "auto"), then through K8/K9 ("pallas"), each with
   its launch counts set to 0 just before, and fails unless its kernels
   launched (K12's ring too: ``lookup_topk_blend``'s table gradient) and
   the loss is finite and falls; then fits twice from one
   start, at the scaled geometry of step 4 and on the per-row route, 3
   epochs each, and fails unless the two fits' parameters are bitwise
   equal (the table gradients' fixed order); then profiles one per-row
   epoch;
9. holds the split streamed tail K4, K5, K6 (noop both ways) against their
   plain versions (K4's top-K identical on every row, its fix-up rows
   printed) on all U_c = 161,792 rows of batch 0 of grid 4061 at
   ``instantngp_scaled_model(hash_table_size=2**16)`` (T = 65,536, past the
   fused gate; real h from K3a), times K1/K2 at the same shapes, and holds
   the serial scatter K12's ring variant (the blend's table gradient:
   N = U_c * K rows of C = L * F = 32, idx from K4's top-4) bitwise to its
   plain version, the serial row-order sum, times its wrapper's index
   preparation apart from its kernel and the hottest slot alone, and times
   ``index_add_`` on the same inputs;
10. trains a small geometry through the split route and K12 (gate
   forced) on the card and on the CPU and compares the losses;
11. runs ``fit`` at T = 2^16 for 3 epochs, the launch counts set to 0
   just before, and fails unless K3a, K3b, K4, K5, K6 and K12 (both
   variants) launched, K1 and K2 did not, and the loss is finite and
   falls; then profiles one epoch of it (and prints K6's device time by
   launch from that profile);
12. K > 16 and an approximate top-k: trains small streamed geometries at
   K = 20 (grid 4062) and at K = 4 with a recall target of 0.95 on the
   card and on the CPU through the chunked PyTorch tail (no kernel of the
   streamed tail may launch; losses compared), then runs ``fit`` at the
   scaled geometry for grid 4064 (K = 128) and grid 4062 (K = 20), 3
   epochs each, the counts set to 0 just before, and fails unless K3a,
   K3b and K12 (both variants) launched, K1, K2 and K4-K6 did not, and the
   loss is finite and falls; profiles one epoch at K = 128; holds K12
   at that fit's batch-0 shapes bitwise to its plain version and run to
   run (the ring on the blend's table gradient, U_c * 128 rows of C = 32
   with ids from the chunked tail's top-128 of real h, and the hottest
   slot alone; the narrow variant on ``gather_rows``'); fits twice from
   one start at K = 20 and fails unless the parameters are bitwise equal;
13. the wide stack ``hpd_hidden=(256, 512, 256)`` (ROADMAP §3.1): holds
   every tail kernel at a head input of 256 against its plain version at
   a small L and T (K1, K2, K4-K6: U = 20,000, T = 4096, L = 4; K8-K11:
   L = 2, N = 20,000, T = 256, the stack at the init's scale), bitwise run
   to run and timed (bounds: 3xTF32 at the TF32 peak, the fp32 bound
   beside them for the forward's wide streamed passes; K2 and K6, on the
   tensor cores at every width, beside their times before); trains the
   dedup, split, per-row "auto" and per-row "pallas" routes at small
   geometries on the card and on the CPU (losses compared; K4-K6's and
   K8/K9's launches there); then fits 3 epochs each, the counts set to 0
   just before, at the scaled geometry (K3a, K3b, K1, K2, K12) and on the
   per-row route with ``batchnorm_input`` (K10, K11, K12), and fails unless
   each launched and the loss is finite and falls; profiles one epoch of
   the scaled wide fit (its epoch seconds, the backward's device ms by
   kernel name, which must show K2's ``hpd_bwd_rows_kernel`` and
   ``hpd_bwd_cols_kernel``, and K2's share of the epoch); then heads past 512
   (K1, K2, K4-K6, K8, K9 at H = 640 and 1000 against their plain
   versions, bitwise run to run), and the stack [2 -> 512 x 4 -> 2048],
   whose row tile K10/K11 cannot hold, on the per-row route "auto": it must
   launch K8 and K9 once each and K10/K11 never, and match the chunked
   PyTorch tail in the forward and every layer's gradients;
14. the measurement path, part 1: holds the probe K7 (both variants)
   against its plain version on all U_c = 161,792 rows of real h from K3a
   at T = 2^14 (the head of ``instantngp_scaled_model()``), bitwise run to
   run and timed; then, with K7's counts set to 0 just before, runs the
   sweep ladder of ``tools/sweep_probe.py`` (dots, softmax, K4, K1) at
   'highest', prints its four rungs and three differences, and fails
   unless both variants launched and the rungs telescope (each within 3 %);
15. the measurement path, part 2, at ``tools/mxu_probe.py``'s shapes
   (U = 162,304, H = 128, T = 16,384): holds K13 in its four regimes
   against their plain versions and K14, K15 exactly, bitwise run to run,
   each timed beside one PyTorch call that computes the same function
   (K13, K14 and K15, redesigned, with their TF/s or GB/s and their times
   before the redesign);
   then, with their counts set to 0 just before, runs the tool's ``main``
   (its TF/s and GB/s lines; the calibration goes to
   ``chiprun_out/roofline_calibration.json``) and fails unless each
   launched;
16. the vanilla hash (``use_hash_function=True``, no HPD): trains a small
   geometry on the card and on the CPU and compares the losses; runs
   ``fit`` on grid 4061 for 3 epochs at the default geometry and at
   ``instantngp_scaled_model()``, the launch counts set to 0 just before,
   and fails unless K12 launched (its ring at the default geometry, its
   narrow variant at the scaled one), no HPD kernel did, and the loss is
   finite and falls; profiles one epoch of each; holds K12 at each fit's
   batch-0 shapes (the hash ids of 918,464 and 3,673,856 rows of F = 2 on
   1,024 and 262,144 slots) bitwise to its plain version and run to run,
   timed beside ``index_add_``, the hottest slot alone; fits twice from one
   start at each geometry and fails unless the parameters are bitwise
   equal;
17. checkpoints, histograms and warm start: ``fit`` at the scaled geometry
   with ``save_params``, a counts epoch every epoch and a JSONL logger
   without media, 3 epochs into a scratch directory under chiprun_out/;
   fails unless the five artifacts and the stamp are written (no
   ``bn_state.pkl``), each counts epoch's slot counts equal a host
   ``np.bincount`` of that epoch's ids, and a 1-epoch warm start from the
   best checkpoint gives a 4-epoch fit's parameters bitwise; prints each
   epoch's stats and checkpoint seconds;
18. the grid driver, render and the CLI at ``instantngp_scaled_model()``:
   ``run_grid_search`` over ids [4061, 4064], 2 epochs each, with a
   manifest and checkpoints under chiprun_out/ (K1, K2, K3a, K3b and K12
   must launch, K4-K6 not), then again (nothing launches, the rows are
   replayed), 4062 by ``ids=``, and shards 0/2 and 1/2 over [4061, 4062,
   4064] against that manifest ([4061, 4064] and [4062], replayed);
   ``render_image`` of 4061's best checkpoint at 508 x 339 (K3a and K1
   alone must launch; PSNR within 0.3 dB of the fit's best), timed there
   and 2x supersampled; K1 at render's shapes (the whole vertex grid,
   U = 264,196, one level of zero counts, trained weights) against its
   plain version (top-K identical on every row, values normwise 1e-5,
   bitwise run to run, its fix-up rows printed, timed: the kernels line's
   ``hpd_stream_fused_fwd[render]``); the CLI with ``--scaled --should_bw
   -t`` on grid 4061 for 2 epochs (exit 0, a one-channel checkpoint, the
   render, the figure or the line saying none is written);
19. spans and ensembles: ``fit`` on grid 4061 for 6 epochs at
   ``epoch_span=1`` and at ``epoch_span=3`` from one start, at the scaled
   geometry (K1, K2, K3a, K3b, K12), per-row with ``batchnorm_input`` (K10,
   K11, K12) and the vanilla hash (K12), each span under
   ``torch.cuda.set_sync_debug_mode("error")``; fails unless the kernels
   launched, equally often, and history, final and best params are bitwise
   equal; prints the epoch seconds at both spans, the idle share of a
   profiled epoch against a profiled span of 3 and the best-epoch
   snapshot's time; then ``fit_ensemble`` of
   grids [4061, 4051, 3961] at the scaled geometry (4 epochs, span 2,
   checkpoints under chiprun_out/, removed), each member bitwise its solo
   fit (best PSNR, final loss, epochs, final image, checkpoint), K1-K3 and
   K12 launched 3x a solo fit's count; and a vanilla ensemble of four
   against its solo fits, seconds per member-epoch of each;
20. data parallelism over pixels and tables sharded by slot on this one
   card (``parallel/``): every kernel built first, then five cases, each
   a set of ranks started with the ``spawn`` method on cuda:0 (a timeout
   a case; a rank that fails, hangs or launches nothing fails the run),
   each rank training grid 4061 on the strawberry for 3 epochs with
   ``fit``'s batches and seeds, its launch counts set to 0 just before:
   ``instantngp_scaled_model()`` over NCCL with a world of one (bitwise
   the single-process run, or within 1e-6 and said so), over gloo on
   (data 2, model 1) and (data 1, model 2) (losses rtol 2e-5, params rtol
   2e-4 / atol 1e-7, collisions equal; K1, K2, K3a, K3b and K12 launched
   on every rank; under (1, 2) K12 with each rank's slot range), the
   per-row route with ``batchnorm_input`` on (data 2) (K10, K11, K12; the
   running statistics within 1e-6), the vanilla hash on (data 2, model
   2), four ranks (K12 with a slot range); each against the
   single-process run on the card; then every rank holds each kernel of
   its case against its plain version on its own batch-0 inputs, at the
   shapes the parallel path gives it (top-K identical, values normwise
   1e-5, gradients 1e-4, K12 bitwise, over the rank's slot range under a
   shard and then also rows lo..hi of the whole) and profiles one more
   epoch; prints each case's epoch seconds beside the single-process
   epoch, the collectives' calls, bytes a step and host seconds, each
   rank's max_abs_err by kernel, and a profiled epoch's collective host
   time and NCCL / copy device time;
21. the measurement tools: ``tools/roofline.py --measure`` (nominal
   peaks, span 10, 30 epochs after two warm-up calls) at ``gngf`` (grid
   4061 at the default geometry) and ``scaled``, each with every kernel's
   count set to 0 just before and read just after, failing unless each
   kernel of the mode's path launched (``gngf``: K12, its HPD and decoder
   in cuBLAS; ``scaled``: K1, K2, K3a, K3b, K12) and unless ``0 <
   fraction_of_roofline <= 1``; K12 held bitwise against its plain version
   on the ``gngf`` run's own batch-0 table gradients (``gather_rows``'
   918,464 rows of C = 2 on 4,624 slots, the blend's 4,624 rows of C = 8
   on 256), timed, as two entries; and ``tools/time_kernels.py`` once at
   the JAX tool's shapes (U = 264,196, H = 128, T = 2^14, L = 16, K = 4,
   and the compacted U = 162,304), which holds each kernel against its
   plain version before timing it, each row's kernel launched;
22. the grid study's drivers at the default geometry (T = 2^8, L = 4,
   the dense HPD on the dedup route: K12 takes both table gradients), in
   a scratch directory (removed): ``tools/run_grid_demo.py`` on 4 ids from
   4048 (K = 32, 128, 1, 4) for 20 epochs over 2 shards, at ``ensemble`` 1
   and 2 (the rows must be bitwise equal apart from ``run_dir``; its
   configs/hour printed); ``tools/grid_leaderboard.py`` on the committed
   screening manifest (115 winners, 34 distinct); ``tools/rerank_top.py``,
   whose pick at 20 must be the committed rerank's ids, on its first 2
   winners and 4061 for 20 epochs; ``tools/seed_panel.py`` on (3761, 4061)
   x (7, 42) for 20 epochs, each member's row equal to a solo ``fit``;
   ``tools/usage_stats.py --flagship`` on 4061's seed-7 checkpoint;
   ``tools/run_macaws.py`` for 10 epochs. Every kernel's count is set to 0
   before each tool and read after it (K12 must launch in each training
   tool; the others launched are printed), and every fit's loss must be
   finite and fall. K12 is held bitwise to its plain version on the
   blend's batch-0 table gradient of the rerank's K = 20 id and the
   screening's K = 32 id (23,120 and 36,992 rows of C = 8 on 256 slots,
   kept from those runs), timed beside ``index_add_``: two entries;
23. the step split by stage (``tools/attribution.py``, ``floor_table.py``,
   ``ablate_scaled.py``, ``gather_probe.py``) in a scratch directory
   (removed): ``attribution --mode scaled`` and ``--mode gngf`` at 2 reps,
   each with every kernel's count set to 0 just before; each must pass its
   own gate (the last prefix bitwise the real loss), its rows must sum to
   its step, and K3a, K3b, K1, K2 and K12 must launch at 'scaled', K12 at
   'gngf'; ``gather_probe`` at 2 reps (K12 bitwise its plain version at
   U * K = 649,216 rows of C = 32 on T = 16,384 slots, then held and timed
   again here beside ``index_add_``: one entry); ``floor_table`` on the two
   artifacts, with a floor beside hidden, tail and decoder; ``ablate_scaled
   --mode scaled`` at 2 reps, every stage's time finite and positive;
24. ``ModelConfig.dedup_cell_gather``'s A/B and the scaling harness:
   ``ablate_scaled --mode scaled --cell-gather`` at 2 reps with K12's count
   set to 0 just before (every stage time of both runs finite and
   positive, K12 launched; the field selects nothing in the port, so the
   two runs are one program); ``tools/scaling_bench.py --world 1 --mode
   gngf`` over NCCL for 2 epochs, px/s finite and positive, and a world of
   2 must raise on one card;
25. prints the card's name and power limit, a ``{"kernels": [...]}`` line,
   and last ``{"ok": true, "device": {...}}``. Every number also goes to
   ``chiprun_out/chip_smoke.json``, with the allocated and peak device
   memory at the end of each route's and each measurement step's phase
   (``utils.memory``), and for the redesigned kernels (K1, K2, K4-K7,
   K8-K11, K12's ring, K13-K15) their time before the redesign
   (``before_redesign_ms``, the records' figures in BEFORE_REDESIGN_MS)
   beside this run's; the tensor-core kernels' ``bound_ms`` is that of
   3xTF32 at the TF32 peak (K9-K11: their head's products so, and K11's
   hidden dW and dh; the rest at the fp32 peak), with the fp32 CUDA-core
   bound as ``bound_fp32_ms``.

Any failure raises, so the run exits non-zero without the last line. It
exits non-zero at once where CUDA is not available.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from collision_handling_in_instantngp_tpu_torch.utils import memory  # noqa: E402
from collision_handling_in_instantngp_tpu_torch.utils.profiling import cuda_ms, host_ms  # noqa: E402
# every kernel's count of work and its bound at the published H100 peaks
from collision_handling_in_instantngp_tpu_torch.tools.roofline import kernel_work  # noqa: E402

OUT_DIR = os.path.join(HERE, "chiprun_out")
SEED = 65535
# normwise tolerances: max |kernel - plain| <= tol * max |plain| (fp32,
# different summation order; outputs sum up to 161,792 rows)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
# K3a's ReLU decisions against float64: a (row, unit) pair flips only where
# its pre-activation lies within the sums' rounding of zero; the kernel's
# 3xTF32 products and fp32 adds may flip this many more pairs of a layer
# than cuBLAS's fp32 plain stack does (seen: 5 against 1 of 41 M pairs)
FLIP_MARGIN = 8
# K7 "dots": a sum of 2^14 mixed-sign logits per row (the JAX package's
# test of the probe uses rtol 1e-4)
DOTS_TOL = 1e-4
# K13 bf16x3: three tensor-core products per term into one fp32
# accumulator, against three fp32 products summed after them
BF16X3_TOL = 1e-4
# the redesigned kernels' times before their redesign, as PERF.md's
# records give them (NVIDIA H100 80GB HBM3, 700.00 W), written
# beside this run's. A parent's times from the same chip call come from
# tools/ab_smoke.py, not from here.
BEFORE_REDESIGN_MS = {"hpd_stream_fused_bwd": 340.15, "hpd_tail_unique_bwd": 1352.97,
                      "scatter_add_serial[ring]": 13.11, "hpd_stream_fused_fwd": 74.95,
                      "hpd_stream_select": 117.44, "hpd_stream_marginal": 171.63,
                      "hpd_stream_fused_probe[dots]": 25.63,
                      "hpd_stream_fused_probe[softmax]": 26.50, "hpd_full_bwd": 24.82,
                      "hpd_tail_bwd": 15.82, "hpd_full_fwd": 7.861, "hpd_tail_fwd": 6.777,
                      "rowsum_dot[highest]": 25.38, "rowsum_dot[default]": 40.20,
                      "rowsum_dot[bf16]": 3.674, "rowsum_dot[bf16x3]": 8.649,
                      "hbm_scale_copy": 1.905, "hbm_write": 0.842,
                      # the CUDA-core wide passes at H = 256 (step 13's shape), the
                      # backward's and the forward's (PERF.md, heads past 128)
                      "hpd_stream_fused_bwd[H=256]": 26.40,
                      "hpd_tail_unique_bwd[H=256]": 26.36,
                      "hpd_stream_fused_fwd[H=256]": 5.08, "hpd_stream_select[H=256]": 2.88,
                      "hpd_stream_marginal[H=256]": 2.20}
SRC = "collision_handling_in_instantngp_tpu_torch/ops/cuda/"
VARIANT_OF = {False: "ring", True: "narrow"}     # K12's variant by scatter.narrow_path
JAX_SRC = "collision_handling_in_instantngp_tpu/ops/pallas/"


def log(*parts) -> None:
    print(*parts, flush=True)


COMPARES = []   # (what, max abs error, normwise error) of every comparison, in order


def compare(name, got, ref, tol):
    """max abs error; raises if it exceeds tol * max |ref|."""
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    log(f"  {name}: max_abs_err {err:.3e} max_rel_err {err / max(scale, 1e-30):.3e} (scale {scale:.3e})")
    COMPARES.append((name, err, err / max(scale, 1e-30)))
    if not torch.isfinite(got).all() or err > tol * scale:
        raise AssertionError(f"{name}: kernel disagrees with plain version ({err} > {tol} * {scale})")
    return err


def bitwise_same(name, a, b):
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: outputs differ between two identical runs")
    log(f"  {name}: bitwise equal run to run")


def profile_epoch(exp, statics, batches, dev) -> dict:
    """Device time by kernel over one training epoch (``run_epoch`` on the
    prepared batches, after one unprofiled warm-up epoch), from
    torch.profiler's device events (``utils.profiling.device_time_by_kernel``)."""
    from torch.profiler import ProfilerActivity, profile
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.train.optimizer import make_optimizer
    from collision_handling_in_instantngp_tpu_torch.train.train_step import (
        initial_collision_state, run_epoch,
    )
    from collision_handling_in_instantngp_tpu_torch.utils.profiling import device_time_by_kernel

    params = gngf.init_params(exp.model, exp.train.seed, dev)
    optimizer = make_optimizer(exp.optimizer, params)
    prev, min_poss = initial_collision_state(exp, statics, dev)
    run_epoch(params, optimizer, batches, exp, statics, prev, min_poss)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_epoch(params, optimizer, batches, exp, statics, prev, min_poss)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return device_time_by_kernel(prof, wall_ms)


def watermark(marks: dict, tag: str, dev) -> None:
    """Allocated and peak device memory of the phase that ends here (the
    measurement phases hold the 10.6 GB (U, T) products of the library
    calls); the peak restarts for the next phase."""
    marks[tag] = memory.print_allocated_memory(tag, log=True, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)


def kernel_entry(name, source, replaces, err, ms, plain, work, library=None):
    """A kernel's entry; its bound (and ``bound_fp32_ms``, where the count
    has one) from ``work``, a ``roofline.kernel_work`` count."""
    b_ms, b_by = work["bound_ms"], work["bound_by"]
    lib = "" if library is None else f", library {library:.3f} ms"
    log(f"  kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {b_ms:.3f} ms ({b_by}){lib}")
    entry = dict(name=name, source=source, replaces=replaces, max_abs_err=err, ms=ms,
                 plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=library)
    if "bound_fp32_ms" in work:
        entry["bound_fp32_ms"] = work["bound_fp32_ms"]
    return entry


def per_row_kernel_phases(exp, batches, statics, dev, gen) -> dict:
    """K8-K11 against their plain versions on batch 0 of the per-row route:
    every (level, pixel, corner) row of the batch."""
    import torch.nn.functional as F
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_full, hpd_tail
    from collision_handling_in_instantngp_tpu_torch.ops.grid import scale_to_grid

    mcfg = exp.model
    params = gngf.init_params(mcfg, SEED, dev)
    with torch.no_grad():
        x, _ = gngf.batchnorm(params.batchnorm, {"mean": params.batchnorm.mean,
                                                 "var": params.batchnorm.var}, batches.x[0], True)
        _, corners = scale_to_grid(x, torch.as_tensor(statics.n_ls, device=dev),
                                   torch.as_tensor(statics.offsets, device=dev))
        p_b, L, V, d = corners.shape
        verts = corners.permute(1, 0, 2, 3).reshape(L, p_b * V, d).contiguous()
        layers = [(w.detach(), b.detach()) for w, b in params.hpd.layers()]
        h = verts
        for w, b in layers[:-1]:
            h = F.relu(h @ w + b)
        h = h.contiguous()
    n = verts.shape[1]
    rows = L * n
    k, T = mcfg.topk_k, mcfg.hash_table_size
    (w_head, b_head), H = layers[-1], layers[-1][0].shape[0]
    widths = [d] + [w.shape[1] for w, _ in layers]
    log(f"per-row route, batch 0: P={p_b}, L={L}, V={V}, rows={rows}, widths {widths}, K={k}")
    g_marg = torch.randn(L, T, device=dev, generator=gen)
    g_vals = torch.randn(L, n, k, device=dev, generator=gen)
    entries = {}

    def check_fwd(tag, out_k, out_p, again, kk=k):
        same = (out_k[2] == out_p[2]).all(dim=2).double().mean().item()
        log(f"  idx: rows with identical top-{kk}: {same:.6f}")
        if same != 1.0:
            raise AssertionError(f"{tag}: top-K indices differ from the plain version")
        err = max(compare("marg", out_k[0], out_p[0], FWD_TOL), compare("vals", out_k[1], out_p[1], FWD_TOL))
        bitwise_same("marg/vals/idx", out_k, again)
        return err

    # bounds (roofline.kernel_work): the head's products (K10's logits,
    # K11's logits replay, dW_head and dh, and K9's three) and K11's hidden
    # dW and dh as 3xTF32 on the tensor cores, three tf32 passes at the TF32
    # peak; the hidden stack (K10's, K11's replay) on the CUDA cores

    log("K10 hpd_full_fwd, all rows of real vertices:")
    out_k = hpd_full.hpd_full_fwd(verts, layers, k)
    fix = fixup_rows(hpd_full.hpd_full_fwd, "K10")
    out_p = hpd_full.hpd_full_fwd_plain(verts, layers, k)
    err = check_fwd("K10", out_k, out_p, hpd_full.hpd_full_fwd(verts, layers, k))
    idx_full = out_k[2]
    work = kernel_work("K10", rows=rows, widths=widths, l=L, k=k)
    entries["hpd_full_fwd"] = kernel_entry(
        "hpd_full_fwd", SRC + "hpd_full.cu", JAX_SRC + "hpd_full.py:162", err,
        cuda_ms(lambda: hpd_full.hpd_full_fwd(verts, layers, k), 10),
        cuda_ms(lambda: hpd_full.hpd_full_fwd_plain(verts, layers, k), 3),
        work)
    entries["hpd_full_fwd"]["fixup_rows"] = fix
    redesigned(entries["hpd_full_fwd"])
    del out_k, out_p
    entries["hpd_full_fwd"]["planted_fixup_rows"] = planted_near_ties(L, n, dev, check_fwd)

    log("K11 hpd_full_bwd, all rows of real vertices:")
    bargs = (verts, layers, idx_full, g_marg, g_vals, k)
    got = hpd_full.hpd_full_bwd(*bargs)
    want = hpd_full.hpd_full_bwd_plain(*bargs)
    err = max(compare(f"{nm}{i}", a, r, GRAD_TOL)
              for i, (ka, pa) in enumerate(zip(got, want)) for nm, a, r in zip(("dW", "db"), ka, pa))
    bitwise_same("dW/db", [t for pair in got for t in pair],
                 [t for pair in hpd_full.hpd_full_bwd(*bargs) for t in pair])
    # the head's three products and the hidden layers' dW and dh on the
    # tensor cores; the hidden stack's replay on the CUDA cores
    work = kernel_work("K11", rows=rows, widths=widths, l=L, k=k)
    entries["hpd_full_bwd"] = kernel_entry(
        "hpd_full_bwd", SRC + "hpd_full.cu", JAX_SRC + "hpd_full.py:236", err,
        cuda_ms(lambda: hpd_full.hpd_full_bwd(*bargs), 5),
        cuda_ms(lambda: hpd_full.hpd_full_bwd_plain(*bargs), 2),
        work)
    redesigned(entries["hpd_full_bwd"])
    del got, want

    log("K8 hpd_tail_fwd, all rows of real h:")
    out_k = hpd_tail.hpd_tail_fwd(h, w_head, b_head, k)
    out_p = hpd_tail.hpd_tail_fwd_plain(h, w_head, b_head, k)
    err = check_fwd("K8", out_k, out_p, hpd_tail.hpd_tail_fwd(h, w_head, b_head, k))
    idx_tail = out_k[2]
    work = kernel_work("K8", rows=rows, h=H, t=T, l=L, k=k)
    entries["hpd_tail_fwd"] = kernel_entry(
        "hpd_tail_fwd", SRC + "hpd_tail.cu", JAX_SRC + "hpd_tail.py:87", err,
        cuda_ms(lambda: hpd_tail.hpd_tail_fwd(h, w_head, b_head, k), 10),
        cuda_ms(lambda: hpd_tail.hpd_tail_fwd_plain(h, w_head, b_head, k), 3),
        work)
    redesigned(entries["hpd_tail_fwd"])
    del out_k, out_p
    by_k = {}
    for kk in (32, 128):    # the rest of K8's K range, on the same rows
        log(f"K8 at K={kk}, all rows of real h:")
        out_k = hpd_tail.hpd_tail_fwd(h, w_head, b_head, kk)
        check_fwd(f"K8 K={kk}", out_k, hpd_tail.hpd_tail_fwd_plain(h, w_head, b_head, kk),
                  hpd_tail.hpd_tail_fwd(h, w_head, b_head, kk), kk)
        by_k[kk] = cuda_ms(lambda: hpd_tail.hpd_tail_fwd(h, w_head, b_head, kk), 5)
        log(f"  kernel {by_k[kk]:.3f} ms")
        del out_k
    entries["hpd_tail_fwd"]["ms_by_k"] = by_k
    entries["hpd_tail_fwd"]["planted"] = planted_tail_ties(L, n, dev, check_fwd)

    log("K9 hpd_tail_bwd, all rows of real h:")
    bargs = (h, w_head, b_head, idx_tail, g_marg, g_vals, k)
    got = hpd_tail.hpd_tail_bwd(*bargs)
    want = hpd_tail.hpd_tail_bwd_plain(*bargs)
    err = max(compare(nm, a, r, GRAD_TOL) for nm, a, r in zip(("dh", "dw", "db"), got, want))
    bitwise_same("dh/dw/db", got, hpd_tail.hpd_tail_bwd(*bargs))
    # its three products (logits replay, dW, dh) on the tensor cores: no other product
    work = kernel_work("K9", rows=rows, h=H, t=T, l=L, k=k)
    entries["hpd_tail_bwd"] = kernel_entry(
        "hpd_tail_bwd", SRC + "hpd_tail.cu", JAX_SRC + "hpd_tail.py:182", err,
        cuda_ms(lambda: hpd_tail.hpd_tail_bwd(*bargs), 5),
        cuda_ms(lambda: hpd_tail.hpd_tail_bwd_plain(*bargs), 2),
        work)
    redesigned(entries["hpd_tail_bwd"])
    del got, want, h
    torch.cuda.empty_cache()
    return entries


def planted_network(L, n, dev):
    """The planted [2 -> 128 -> 256] network of ``tests/test_torch_cuda.py
    -k full_fwd_guard`` on L levels of n rows: on every row an exact tie at
    the top and a near-tie at the K-th place (K = 4) that only the fp32
    logits order (both orders occur), and on every 8th row a cluster of 8
    columns within 1.4e-4 at the top. Returns (verts, layers, lift), lift
    the cluster rows."""
    rng = np.random.default_rng(SEED)
    hd, t = 128, 256
    v = rng.uniform(0.0, 0.75, size=(L, n))
    v = np.where(v < 0.375, v, v + 0.25)
    lift = np.broadcast_to((np.arange(n) % 8 == 0).astype(np.float64), (L, n))
    w0, b0 = rng.standard_normal((2, hd)) * 0.5, rng.standard_normal(hd) * 0.3
    w0[:, :4], b0[:4] = [[0, 0, 0.8, -0.8], [0, 1, 0, 0]], [1, 0, 0.2, 1]
    w, b = rng.standard_normal((hd, t)) * 0.05, rng.standard_normal(t) * 0.05
    w[:4] = 0.0
    base = w[:, 30].copy()
    for col, bias in ((30, 3.0), (70, 3.0), (150, 2.9), (120, 2.0), (45, 2.0)):
        w[:, col], b[col] = base, bias
    w[2, 45], w[3, 45] = 2e-5, -2e-5
    for j, col in enumerate((200, 6, 99, 123, 77, 160, 41, 101)):
        w[:, col], w[1, col], b[col] = base, 10.0, (j * 37 % 8) * 2e-5
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
    return f32(np.stack([v, lift], axis=-1)), [(f32(w0), f32(b0)), (f32(w), f32(b))], lift


def planted_near_ties(L, n, dev, check_fwd) -> int:
    """K10's guard and fp32 redo at the per-row route's tiling (L levels of
    n rows: a block walks many row tiles) on the planted network
    (planted_network). Fails unless the top-K is identical to the plain
    version's on every row, marg/vals agree, the outputs are bitwise equal
    run to run and exactly the cluster rows were redone in fp32. Returns
    that count."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_full

    k = 4
    verts, layers, lift = planted_network(L, n, dev)
    log(f"K10 on planted near-ties, L={L}, N={n}, [2 -> 128 -> 256], K={k}:")
    out_k = hpd_full.hpd_full_fwd(verts, layers, k)
    fix = fixup_rows(hpd_full.hpd_full_fwd, "K10, planted")
    out_p = hpd_full.hpd_full_fwd_plain(verts, layers, k)
    fourth = set(out_p[2][torch.as_tensor(lift == 0, device=dev)][:, k - 1].tolist())
    if fourth != {120, 45}:
        raise AssertionError(f"planted near-tie: the plain version's K-th places are {fourth}")
    check_fwd("K10 planted", out_k, out_p, hpd_full.hpd_full_fwd(verts, layers, k))
    want = int(lift.sum())
    if fix != want:
        raise AssertionError(f"K10 planted: {fix} rows redone in fp32, the cluster rows are {want}")
    del out_k, out_p
    return fix


def planted_tail_ties(L, n, dev, check_fwd) -> dict:
    """K8 on the planted network's head input (planted_network: its hidden
    layer's ReLU output, h (L, n, 128), and its head) at the per-row
    route's tiling, at K = 4 (the near-tie at the K-th place, both orders)
    and K = 8 (the clusters of 8 within 1.4e-4 at the top): the top-K
    identical to the plain version's on every row, marg/vals agreeing,
    bitwise equal run to run. Returns the rows where the plain version's
    K-th place is each near-tie column."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_tail

    verts, layers, lift = planted_network(L, n, dev)
    h = torch.relu(verts @ layers[0][0] + layers[0][1]).contiguous()
    w, b = layers[1]
    out = {}
    for k in (4, 8):
        log(f"K8 on planted near-ties, L={L}, N={n}, H=128, T=256, K={k}:")
        out_p = hpd_tail.hpd_tail_fwd_plain(h, w, b, k)
        check_fwd(f"K8 planted K={k}", hpd_tail.hpd_tail_fwd(h, w, b, k), out_p,
                  hpd_tail.hpd_tail_fwd(h, w, b, k), k)
        if k == 4:
            kth = out_p[2][torch.as_tensor(lift == 0, device=dev)][:, k - 1]
            out = {int(c): int((kth == c).sum()) for c in kth.unique()}
            log(f"  the plain version's K-th places on the rows without a cluster: {out}")
            if set(out) != {120, 45}:
                raise AssertionError(f"planted near-tie: the plain version's K-th places are {set(out)}")
        del out_p
    return out


def fixup_rows(wrapper, what) -> int:
    """Rows the last launch of a rows-pass wrapper handed to its fp32
    fix-up; printed."""
    n = int(wrapper.fixup_rows.item())
    log(f"  {what}: rows settled by the fp32 fix-up: {n}")
    return n


def per_launch(name, profile, kernels) -> dict:
    """Device ms per call of each of a wrapper's launches (kernel names
    containing one of ``kernels``), from a training epoch's profile; printed.
    Raises unless every named launch is in the profile with a call."""
    rows = [r for r in profile["kernels"] if any(k in r["name"] for k in kernels)]
    missing = [k for k in kernels if not any(k in r["name"] and r["calls"] > 0 for r in rows)]
    if missing:
        raise RuntimeError(f"{name}: the profile holds no call of {missing}")
    log(f"  {name} per launch in training (device ms per call):")
    for r in rows:
        log(f"    {r['ms'] / r['calls']:10.3f} ms ({r['calls']} calls) {r['name'][:90]}")
    return {r["name"]: r["ms"] / r["calls"] for r in rows}


def redesigned(entry) -> None:
    """Add a redesigned kernel's time before its redesign to its entry and
    print both, with its fp32 bound beside the tensor-core one."""
    before = entry["before_redesign_ms"] = BEFORE_REDESIGN_MS[entry["name"]]
    bounds = ("" if "bound_fp32_ms" not in entry else
              f"; bound {entry['bound_ms']:.3f} ms on the tensor cores, "
              f"{entry['bound_fp32_ms']:.3f} as fp32")
    log(f"  redesigned: {entry['ms']:.3f} ms, before {before:.2f} ms "
        f"({before / entry['ms']:.2f}x){bounds}")


def scatter_phase(variant, rows, flat, t) -> dict:
    """K12 on (rows, flat ids, T), which must take ``variant``: bitwise
    equal run to run and to its plain version, the serial row-order sum;
    timed beside the plain version and ``index_add_`` (atomic, so only
    timed), with its wrapper's index preparation (sort, searchsorted and
    the range check, one host sync) and the kernel alone on its output.
    Returns the kernel entry."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import scatter

    n, c = rows.shape
    log(f"  N={n} rows of C={c} on T={t} slots")
    if VARIANT_OF[scatter.narrow_path(n, c, t)] != variant:
        raise AssertionError(f"K12: these shapes do not take its {variant} variant")
    before = scatter.scatter_add_serial.variant_launches[variant]
    got = scatter.scatter_add_serial(rows, flat, t)
    if scatter.scatter_add_serial.variant_launches[variant] != before + 1:
        raise AssertionError(f"K12 [{variant}] did not launch")
    bitwise_same("dt", [got], [scatter.scatter_add_serial(rows, flat, t)])
    plain = scatter.scatter_add_serial_plain(rows, flat, t)
    if not torch.equal(got, plain):
        raise AssertionError(f"K12 [{variant}] differs from its plain version, the serial row-order sum")
    err = (got - plain).abs().max().item()
    per_slot = torch.bincount(flat.long(), minlength=t)
    log(f"  dt: bitwise equal to the plain version (serial row-order sum); rows per slot max "
        f"{int(per_slot.max().item())}, slots used {int((per_slot > 0).sum().item())} of {t}")
    flat_long = flat.long()
    acc = torch.zeros(t, c, device=rows.device)
    name = f"scatter_add_serial[{variant}]"
    entry = kernel_entry(
        name, SRC + "scatter.cu", JAX_SRC + "scatter_probe.py:42", err,
        cuda_ms(lambda: scatter.scatter_add_serial(rows, flat, t), 20),
        cuda_ms(lambda: scatter.scatter_add_serial_plain(rows, flat, t), 2),
        kernel_work("K12", n=n, c=c, t=t, idx_bytes=flat.element_size()),
        cuda_ms(lambda: acc.index_add_(0, flat_long, rows), 20))
    prep = scatter.prepare(flat, t)
    entry["prepare_ms"] = cuda_ms(lambda: scatter.prepare(flat, t), 20)
    entry["kernel_only_ms"] = cuda_ms(lambda: scatter.scatter_sorted(rows, *prep), 20)
    log(f"  wrapper share: prepare {entry['prepare_ms']:.3f} ms, kernel alone "
        f"{entry['kernel_only_ms']:.3f} ms")
    return entry


def hot_slot(entry, rows, flat, t) -> None:
    """The hottest slot's rows alone through K12 (one block's chain: the
    kernel's floor), timed into ``entry["hot_slot_ms"]``."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import scatter

    hot = torch.bincount(flat.long(), minlength=t).argmax().item()
    hot_rows = rows[flat == hot].contiguous()
    hot_prep = scatter.prepare(torch.zeros(hot_rows.shape[0], dtype=torch.int32, device=rows.device), 8)
    entry["hot_slot_ms"] = cuda_ms(lambda: scatter.scatter_sorted(hot_rows, *hot_prep), 20)
    log(f"  the hottest slot's {hot_rows.shape[0]} rows alone: kernel {entry['hot_slot_ms']:.3f} ms")


def gather_scatter_phase(geom, feature_dim, dev, gen) -> dict:
    """K12's narrow variant on ``gather_rows``' table gradient of one batch
    (flat ids = vertex id + level * U_c, rows of F columns on L * U_c
    slots), as ``models/encoding.py`` forms them. Returns the kernel entry."""
    ids = geom.ids
    l, u = geom.counts.shape
    level = torch.arange(l, device=ids.device).view(1, l, *([1] * (ids.dim() - 2)))
    flat = (ids.long() + level * u).reshape(-1)
    log(f"K12 scatter_add_serial [narrow], gather_rows' table gradient of batch 0, "
        f"ids {tuple(ids.shape)}:")
    rows = torch.randn(flat.numel(), feature_dim, device=dev, generator=gen)
    return scatter_phase("narrow", rows, flat, l * u)


def split_kernel_phases(exp, batches, dev, gen):
    """K4-K6 against their plain versions on batch 0 of the split route
    (every active vertex, real h from K3a), K1/K2 timed at the same shapes,
    and K12 on the blend's table-gradient shape with K4's indices. Returns
    (entries, fused-vs-split times)."""
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops import dedup
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hidden, hpd_stream

    mcfg = exp.model
    geom = batches.dedup[0]
    x = dedup.active_coords(geom.active, dedup.grid_side(mcfg.n_max))
    params = gngf.init_params(mcfg, SEED, dev)
    layers = [(w_.detach(), b_.detach()) for w_, b_ in params.hpd.layers()]
    h = hidden.hidden_stack_fwd(x, layers[:-1]).contiguous()
    w, b = layers[-1]
    counts = geom.counts.contiguous()
    u, H = h.shape
    k, L, T = mcfg.topk_k, mcfg.num_levels, mcfg.hash_table_size
    if hpd_stream.fused_supports(T, k, H) or not hpd_stream.supports(T, k):
        raise AssertionError(f"T={T}, K={k}, H={H} does not take the split route")
    log(f"split route, batch 0: U_c={u}, H={H}, T={T}, L={L}, K={k}")
    entries = {}

    log("K4 hpd_stream_select, full U_c of real h:")
    out_k = hpd_stream.hpd_stream_select(h, w, b, k)
    out_p = hpd_stream.hpd_stream_select_plain(h, w, b, k, "highest")
    same = (out_k[1] == out_p[1]).all(dim=1).double().mean().item()
    log(f"  idx: rows with identical top-{k}: {same:.6f}")
    if same != 1.0:
        raise AssertionError("K4: top-K indices differ from the plain version")
    fix = fixup_rows(hpd_stream.hpd_stream_select, "K4")
    err = max(compare(n, a, r, FWD_TOL)
              for n, a, r in zip(("vals", "m", "s"), (out_k[0], *out_k[2:]), (out_p[0], *out_p[2:])))
    bitwise_same("vals/idx/m/s", out_k, hpd_stream.hpd_stream_select(h, w, b, k))
    del out_p
    vals, idx, m, s = out_k
    work = kernel_work("K4", u=u, h=H, t=T, k=k)
    entries["hpd_stream_select"] = kernel_entry(
        "hpd_stream_select", SRC + "hpd_stream.cu", JAX_SRC + "hpd_stream.py:193", err,
        cuda_ms(lambda: hpd_stream.hpd_stream_select(h, w, b, k), 5),
        cuda_ms(lambda: hpd_stream.hpd_stream_select_plain(h, w, b, k, "highest"), 2),
        work)
    entries["hpd_stream_select"]["fixup_rows"] = fix
    redesigned(entries["hpd_stream_select"])

    log("K5 hpd_stream_marginal, full U_c:")
    marg = hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s)
    err = compare("marg", marg, hpd_stream.hpd_stream_marginal_plain(h, w, b, counts, m, s, "highest"),
                  FWD_TOL)
    bitwise_same("marg", [marg], [hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s)])
    work = kernel_work("K5", u=u, h=H, t=T, l=L, k=k, counts=counts)
    entries["hpd_stream_marginal"] = kernel_entry(
        "hpd_stream_marginal", SRC + "hpd_stream.cu", JAX_SRC + "hpd_stream.py:282", err,
        cuda_ms(lambda: hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s), 5),
        cuda_ms(lambda: hpd_stream.hpd_stream_marginal_plain(h, w, b, counts, m, s, "highest"), 2),
        work)
    redesigned(entries["hpd_stream_marginal"])

    log("K6 hpd_tail_unique_bwd (B1 + B2), full U_c:")
    g_marg = torch.randn(L, T, device=dev, generator=gen)
    g_vals = torch.randn(u, k, device=dev, generator=gen)
    args = (h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k)
    errs = []
    for noop in (False, True):
        got = hpd_stream.hpd_tail_unique_bwd(*args, noop_topk=noop)
        want = hpd_stream.hpd_tail_unique_bwd_plain(*args, "highest", noop)
        errs += [compare(f"{n} noop={noop}", a, r, GRAD_TOL)
                 for n, a, r in zip(("dh", "dw", "db"), got, want)]
        bitwise_same(f"dh/dw/db noop={noop}", got, hpd_stream.hpd_tail_unique_bwd(*args, noop_topk=noop))
        del got, want
    work = kernel_work("K6", u=u, h=H, t=T, l=L, k=k)
    entries["hpd_tail_unique_bwd"] = kernel_entry(
        "hpd_tail_unique_bwd", SRC + "hpd_stream.cu", JAX_SRC + "hpd_stream.py:921", max(errs),
        cuda_ms(lambda: hpd_stream.hpd_tail_unique_bwd(*args), 3),
        cuda_ms(lambda: hpd_stream.hpd_tail_unique_bwd_plain(*args, "highest", False), 2),
        work)
    redesigned(entries["hpd_tail_unique_bwd"])

    log("K1 / K2 at the same shapes (the fused pair, which the gate does not pick here):")
    fused = dict(
        K1_ms=cuda_ms(lambda: hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k), 3),
        K2_ms=cuda_ms(lambda: hpd_stream.hpd_stream_fused_bwd(*args), 3),
        K4_K5_ms=entries["hpd_stream_select"]["ms"] + entries["hpd_stream_marginal"]["ms"],
        K6_ms=entries["hpd_tail_unique_bwd"]["ms"],
    )
    log(f"  K1 {fused['K1_ms']:.3f} ms vs K4+K5 {fused['K4_K5_ms']:.3f} ms; "
        f"K2 {fused['K2_ms']:.3f} ms vs K6 {fused['K6_ms']:.3f} ms")
    del args, g_marg, g_vals, marg

    c = L * mcfg.feature_dim
    flat = idx.reshape(-1)
    log(f"K12 scatter_add_serial [ring], the blend's table gradient: idx from K4's top-{k}, "
        f"T={T}:")
    rows = torch.randn(flat.numel(), c, device=dev, generator=gen)
    ring = entries["scatter_add_serial[ring]"] = scatter_phase("ring", rows, flat, T)
    hot_slot(ring, rows, flat, T)
    redesigned(ring)
    del h, out_k, vals, idx, m, s, rows
    torch.cuda.empty_cache()
    return entries, fused


def probe_ladder_phase(h, w, b, counts, k):
    """K7 (both variants) against its plain version on all rows of h, then
    the sweep ladder at 'highest' through ``tools.sweep_probe.ladder`` with
    K7's counts set to 0 just before. Returns (entries, rungs)."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_stream
    from collision_handling_in_instantngp_tpu_torch.tools import sweep_probe

    u, H = h.shape
    T = w.shape[1]
    probe = hpd_stream.hpd_stream_fused_probe
    entries = {}
    for variant, tol in (("dots", DOTS_TOL), ("softmax", FWD_TOL)):
        log(f"K7 hpd_stream_fused_probe [{variant}], U_c = {u} rows of real h, H = {H}, T = {T}:")
        got = probe(h, w, b, "highest", variant)
        ref = hpd_stream.hpd_stream_fused_probe_plain(h, w, b, "highest", variant)
        err = max(compare(n, a, r, tol) for n, a, r in zip(("m", "s"), got, ref))
        bitwise_same("m/s", got, probe(h, w, b, "highest", variant))
        name = f"hpd_stream_fused_probe[{variant}]"
        # dots: the row sum of h w + b is one addmm (TF32 off; it writes the
        # (U, T) logits, 10.6 GB) and a sum; no one call returns softmax's m and s
        library = cuda_ms(lambda: torch.addmm(b, h, w).sum(-1), 3) if variant == "dots" else None
        torch.cuda.empty_cache()
        work = kernel_work("K7", u=u, h=H, t=T)
        entries[name] = kernel_entry(
            name, SRC + "hpd_stream.cu", JAX_SRC + "hpd_stream.py:1081", err,
            cuda_ms(lambda: probe(h, w, b, "highest", variant), 10),
            cuda_ms(lambda: hpd_stream.hpd_stream_fused_probe_plain(h, w, b, "highest", variant), 3),
            work, library)
        redesigned(entries[name])
        del got, ref

    log("sweep ladder (tools/sweep_probe.py: ladder) at 'highest', same inputs:")
    probe.launches = 0
    probe.variant_launches = dict.fromkeys(probe.variant_launches, 0)
    rung = sweep_probe.ladder(h, w, b[None], counts, k, "highest", reps=5)
    launches = dict(probe.variant_launches)
    for key, v in rung.items():
        log(f"  {key:20s} {v:10.3f} ms")
    for variant, n in launches.items():
        if n == 0:
            raise AssertionError(f"K7 [{variant}] never launched in the sweep ladder")
        entries[f"hpd_stream_fused_probe[{variant}]"].update(launches=n, route="cuda")
    order = ("dots_ms", "softmax_ms", "select_ms", "full_ms")
    for lo, hi in zip(order[:-1], order[1:]):
        if rung[lo] > 1.03 * rung[hi]:
            raise AssertionError(f"the ladder does not telescope: {lo} {rung[lo]} > {hi} {rung[hi]}")
    return entries, rung


def mxu_probe_phase(dev):
    """K13 (four regimes), K14 and K15 against their plain versions at
    ``tools/mxu_probe.py``'s shapes, each timed beside one PyTorch call of
    the same function; then the tool's ``main`` with their counts set to 0
    just before. Returns (entries, the tool's rates)."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import probe
    from collision_handling_in_instantngp_tpu_torch.ops.precision import bf16_round
    from collision_handling_in_instantngp_tpu_torch.tools import mxu_probe

    U, H, T = mxu_probe.U, mxu_probe.H, mxu_probe.T
    h, w, _, _ = mxu_probe.make_inputs(U, H, T, mxu_probe.L, dev)
    flops = 2.0 * U * H * T
    entries = {}
    for regime in probe.REGIMES:
        log(f"K13 rowsum_dot [{regime}], ({U}, {H}) x ({H}, {T}):")
        got = probe.rowsum_dot(h, w, regime)
        err = compare("rowsum", got, probe.rowsum_dot_plain(h, w, regime),
                      BF16X3_TOL if regime == "bf16x3" else FWD_TOL)
        bitwise_same("rowsum", [got], [probe.rowsum_dot(h, w, regime)])
        # fp32 FMA at 'highest'; bf16 products ('default' and 'bf16' run one
        # tensor-core kernel); bf16x3 three products per term
        work = kernel_work("K13", u=U, h=H, t=T, regime=regime)
        library = None
        if regime != "bf16x3":
            # fp32 operands (rounded to bf16 first for default/bf16), TF32
            # off; writes the (U, T) product, 10.6 GB
            a, c = (h, w) if regime == "highest" else (bf16_round(h), bf16_round(w))
            library = cuda_ms(lambda: torch.matmul(a, c).sum(-1), 3)
            del a, c
            torch.cuda.empty_cache()
        entry = entries[f"rowsum_dot[{regime}]"] = kernel_entry(
            f"rowsum_dot[{regime}]", SRC + "probe.cu", "tools/mxu_probe.py:119", err,
            cuda_ms(lambda: probe.rowsum_dot(h, w, regime), 5),
            cuda_ms(lambda: probe.rowsum_dot_plain(h, w, regime), 2), work, library)
        log(f"  {flops / entry['ms'] / 1e9:.2f} TF/s (2 U H T over the kernel's time)")
        redesigned(entry)

    shape = (U, T // 4)
    nbytes = 4.0 * U * (T // 4)
    log(f"K14 hbm_write {shape} fp32 ({nbytes / 1e9:.2f} GB):")
    got = probe.hbm_write(shape, dev)
    if not torch.equal(got, probe.hbm_write_plain(shape, dev)):
        raise AssertionError("K14 differs from its plain version")
    log("  ones: exactly equal to the plain version")
    buf = torch.empty(shape, device=dev)
    entry = entries["hbm_write"] = kernel_entry(
        "hbm_write", SRC + "probe.cu", "tools/mxu_probe.py:157", 0.0,
        cuda_ms(lambda: probe.hbm_write(shape, dev), 10),
        cuda_ms(lambda: probe.hbm_write_plain(shape, dev), 10),
        kernel_work("K14", nbytes=nbytes),
        cuda_ms(lambda: buf.fill_(1.0), 10))
    log(f"  {nbytes / entry['ms'] / 1e6:.1f} GB/s (writes over the kernel's time)")
    redesigned(entry)
    del got, buf
    torch.cuda.empty_cache()

    log(f"K15 hbm_scale_copy {shape} fp32 (2 x {nbytes / 1e9:.2f} GB):")
    x = torch.randn(shape, device=dev, generator=torch.Generator(device=dev).manual_seed(SEED))
    got = probe.hbm_scale_copy(x)
    if not (torch.equal(got, probe.hbm_scale_copy_plain(x)) and torch.equal(got, probe.hbm_scale_copy(x))):
        raise AssertionError("K15 differs from its plain version or between two runs")
    log("  2x: exactly equal to the plain version, bitwise run to run")
    del got
    y = torch.empty_like(x)
    entry = entries["hbm_scale_copy"] = kernel_entry(
        "hbm_scale_copy", SRC + "probe.cu", "tools/mxu_probe.py:183", 0.0,
        cuda_ms(lambda: probe.hbm_scale_copy(x), 10),
        cuda_ms(lambda: probe.hbm_scale_copy_plain(x), 10),
        kernel_work("K15", nbytes=nbytes),
        cuda_ms(lambda: torch.mul(x, 2.0, out=y), 10))
    log(f"  {2 * nbytes / entry['ms'] / 1e6:.1f} GB/s (read + write over the kernel's time)")
    redesigned(entry)
    del x, y, h, w
    torch.cuda.empty_cache()

    log("tools/mxu_probe.py main at its shapes:")
    for fn in (probe.rowsum_dot, probe.hbm_write, probe.hbm_scale_copy):
        fn.launches = 0
    probe.rowsum_dot.regime_launches = dict.fromkeys(probe.REGIMES, 0)
    rates = mxu_probe.main(["--reps", "3"])
    launches = {"hbm_write": probe.hbm_write.launches,
                "hbm_scale_copy": probe.hbm_scale_copy.launches,
                **{f"rowsum_dot[{r}]": n for r, n in probe.rowsum_dot.regime_launches.items()}}
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} never launched in tools/mxu_probe.py")
        entries[name].update(launches=n, route="cuda")
    torch.cuda.empty_cache()
    return entries, rates


# The wide stack of ROADMAP §3.1: HPD hidden widths past the tensor-core
# passes' 128, at the JAX kernels' contract (hidden widths <= 512)
WIDE_HIDDEN = (256, 512, 256)
WIDE_TAG = "[2-256-512-256]"
WIDE_H = f"[H={WIDE_HIDDEN[-1]}]"


def seeded_layers(widths, dev, seed=SEED):
    """Layers [(w, b)] of an HPD stack at the init's scale, from a seed."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return [((torch.randn(a, b, generator=gen) / math.sqrt(a)).to(dev),
             (torch.randn(b, generator=gen) * 0.1).to(dev)) for a, b in zip(widths[:-1], widths[1:])]


def per_row_layers(verts, widths, head, dev, seed=SEED):
    """Hidden layers of ``widths`` at the init's scale (seeded_layers), then
    a seeded (w_n x head) head scaled to logits of about 4 at most on the
    rows of verts (..., d)."""
    layers = seeded_layers(widths, dev, seed)
    a = verts.reshape(-1, widths[0])
    for w, b in layers:
        a = torch.relu(a @ w + b)
    w, b = seeded_layers([widths[-1], head], dev, seed + 2)[0]
    return layers + [(w * (4.0 / (a @ w).abs().max()), b)]


def kernel_relu_masks(hidden, x, layers) -> list:
    """The K3 kernels' own ReLU decisions, pre_l >= 0, of every layer l on
    the rows of x: K3a on the stack cut after layer l, that layer negated,
    gives relu(-pre_l), which is 0 exactly where pre_l >= 0. (The 3xTF32
    split, the tensor cores' sums and the fp32 adds are odd in the weights,
    so the kernel's -pre_l is its pre_l negated bit for bit; K3b recomputes
    with K3a's arithmetic.) Checked against the full stack's h: h > 0
    wherever the last layer's mask says off would be a contradiction."""
    masks = [hidden.hidden_stack_fwd(x, layers[:l] + [(-w, -b)]) == 0
             for l, (w, b) in enumerate(layers)]
    h = hidden.hidden_stack_fwd(x, layers)
    if ((h > 0) & ~masks[-1]).any():
        raise AssertionError("K3's ReLU masks from the negated stack contradict its h")
    return masks


def masked_reference(x, layers, gh, masks):
    """h, [(dW, db)] and the pre-activations of the stack in float64, the
    backward's ReLU masks given (hidden.hidden_stack_bwd_plain's algebra)."""
    a = x.double()
    acts, pres = [a], []
    for w, b in layers:
        z = a @ w.double() + b.double()
        pres.append(z)
        a = z.clamp(min=0.0)
        acts.append(a)
    g = gh.double()
    grads = [None] * len(layers)
    for i in reversed(range(len(layers))):
        g = torch.where(masks[i], g, torch.zeros_like(g))
        grads[i] = (acts[i].T @ g, g.sum(dim=0))
        if i > 0:
            g = g @ layers[i][0].double().T
    return acts[-1], grads, pres


def hidden_stack_phase(hidden, x, layers, gen, tag, exact=False) -> dict:
    """K3a and K3b on all U_c rows of x through ``layers``: against their
    plain versions, bitwise run to run, timed. ``exact``: against the plain
    algebra in float64 with the kernel's own ReLU masks (kernel_relu_masks)
    instead of the fp32 plain version, whose decisions at the pre-activations
    within rounding of zero differ from the kernel's (each such (row, unit)
    moves dW by up to that row's whole term); the flips, and the fp32 plain
    version's own error against that reference, are logged and kept, and
    the kernel may decide against float64 on at most FLIP_MARGIN more
    (row, unit) pairs of a layer than the fp32 plain version does.
    Bounds: the products as 3xTF32 at the TF32 peak (the kernels' route)
    against the bytes of x, h (K3a) or gh (K3b) and the parameters; the fp32
    CUDA-core bound (the route before the redesign) as ``bound_fp32_ms``."""
    u_c = x.shape[0]
    widths = [x.shape[1]] + [w.shape[1] for w, _ in layers]
    gh = torch.randn(u_c, widths[-1], device=x.device, generator=gen) * 1e-3
    out, notes = {}, {}
    if exact:
        masks = kernel_relu_masks(hidden, x, layers)
        h_ref, g_ref, pres = masked_reference(x, layers, gh, masks)
        a = x
        for i, ((w, b), m, z) in enumerate(zip(layers, masks, pres)):
            zp = hidden.hidden_stack_fwd_plain(a, [(w, b)], "highest")  # relu(fp32 plain pre)
            pre_p = a @ w + b
            a = zp
            notes[f"layer{i}"] = dict(
                units=m.numel(), kernel_vs_float64=int((m != (z >= 0)).sum()),
                plain_vs_float64=int(((pre_p >= 0) != (z >= 0)).sum()),
                kernel_vs_plain=int((m != (pre_p >= 0)).sum()))
            log(f"  ReLU decisions, layer {i}: kernel vs float64 {notes[f'layer{i}']['kernel_vs_float64']}, "
                f"fp32 plain vs float64 {notes[f'layer{i}']['plain_vs_float64']}, kernel vs fp32 plain "
                f"{notes[f'layer{i}']['kernel_vs_plain']} of {m.numel()} (row, unit) pairs")
            if notes[f"layer{i}"]["kernel_vs_float64"] > notes[f"layer{i}"]["plain_vs_float64"] + FLIP_MARGIN:
                raise AssertionError(f"K3a{tag} layer {i}: {notes[f'layer{i}']} ReLU decisions "
                                     f"off float64's, past the fp32 plain version's + {FLIP_MARGIN}")
        del masks, pres, a, zp, pre_p
    log(f"K3a hidden_stack forward{tag}, widths {widths}, full U_c:")
    h_k = hidden.hidden_stack_fwd(x, layers)
    h_p = hidden.hidden_stack_fwd_plain(x, layers, "highest")
    err = compare("h", h_k, h_ref if exact else h_p, FWD_TOL)
    if exact:
        notes["plain_h_err"] = (h_p.double() - h_ref).abs().max().item() / h_ref.abs().max().item()
        log(f"  (fp32 plain h against the float64 reference: {notes['plain_h_err']:.3e} normwise)")
    bitwise_same("h", [h_k], [hidden.hidden_stack_fwd(x, layers)])
    del h_k, h_p
    ms = cuda_ms(lambda: hidden.hidden_stack_fwd(x, layers), 20)
    plain = cuda_ms(lambda: hidden.hidden_stack_fwd_plain(x, layers, "highest"), 20)
    work = kernel_work("K3a", u=u_c, widths=widths)
    out["hidden_stack_fwd" + tag] = kernel_entry(
        "hidden_stack_fwd" + tag, SRC + "hidden.cu", JAX_SRC + "hidden.py:126", err, ms, plain,
        work)

    log(f"K3b hidden_stack backward{tag}, widths {widths}, full U_c:")
    g_k = hidden.hidden_stack_bwd(x, layers, gh)
    g_p = hidden.hidden_stack_bwd_plain(x, layers, gh, "highest")
    ref = g_ref if exact else g_p
    err = max(compare(f"{n}{i}", a, r, GRAD_TOL)
              for i, (ka, pa) in enumerate(zip(g_k, ref)) for n, a, r in zip("dW db".split(), ka, pa))
    if exact:
        for i, ((kw, kb), (pw, pb), (rw, rb)) in enumerate(zip(g_k, g_p, g_ref)):
            for n, a, p_, r in (("dW", kw, pw, rw), ("db", kb, pb, rb)):
                sc = r.abs().max().item()
                notes[f"{n}{i}"] = dict(kernel=(a.double() - r).abs().max().item() / sc,
                                        plain=(p_.double() - r).abs().max().item() / sc,
                                        kernel_vs_plain=(a.double() - p_.double()).abs().max().item()
                                        / max(p_.abs().max().item(), 1e-30))
                log(f"  {n}{i} normwise against the float64 reference: kernel "
                    f"{notes[f'{n}{i}']['kernel']:.3e}, fp32 plain {notes[f'{n}{i}']['plain']:.3e}; "
                    f"kernel against fp32 plain {notes[f'{n}{i}']['kernel_vs_plain']:.3e}")
    g_k2 = hidden.hidden_stack_bwd(x, layers, gh)
    bitwise_same("dW/db", [t for pair in g_k for t in pair], [t for pair in g_k2 for t in pair])
    del g_k, g_k2, g_p, ref
    if exact:
        del g_ref, h_ref
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: hidden.hidden_stack_bwd(x, layers, gh), 10)
    plain = cuda_ms(lambda: hidden.hidden_stack_bwd_plain(x, layers, gh, "highest"), 10)
    work = kernel_work("K3b", u=u_c, widths=widths)
    out["hidden_stack_bwd" + tag] = kernel_entry(
        "hidden_stack_bwd" + tag, SRC + "hidden.cu", JAX_SRC + "hidden.py:161", err, ms, plain,
        work)
    if exact:
        out["hidden_stack_bwd" + tag]["relu_check"] = notes
    return out


def wide_tail_phase(hpd_stream, hpd_tail, hpd_full, dev, gen, u=20_000, t=4096, n=20_000) -> dict:
    """Every tail kernel at a head input of 256 (the wide stack's), against
    its plain version at a small L and T, bitwise run to run, timed: the
    dedup route's K1, K2 (fused gate holds at T = 2^12), K4, K5, K6, K7,
    and the per-row route's K8, K9, K10, K11 (the stack [2 -> 256 -> 512 ->
    256]). K1, K2 and K4-K7 run their own passes on the tensor cores (the
    contraction over H in two 128-deep chunks), K1, K2, K4-K6 beside their
    times before (the CUDA-core wide passes); K1's and K4's fix-up rows
    printed. Bounds from ``roofline.kernel_work``, as at H = 128."""
    hd, l, k = WIDE_HIDDEN[-1], 4, 4
    f32 = lambda *shape, scale=1.0: torch.randn(*shape, device=dev, generator=gen) * scale
    h = torch.rand(u, hd, device=dev, generator=gen) * 0.1
    w, b = f32(hd, t, scale=0.2), f32(t, scale=0.1)
    counts = torch.randint(0, 5, (l, u), device=dev, generator=gen).float()
    g_marg, g_vals = f32(l, t), f32(u, k)
    out = {}

    def entry(name, src, fn, plain_fn, reps, err, work):
        out[name + WIDE_H] = kernel_entry(name + WIDE_H, SRC + src, JAX_SRC + REPLACES[name], err,
                                          cuda_ms(fn, reps), cuda_ms(plain_fn, reps), work)

    log(f"K1/K2 and K4-K7 at H={hd}, U={u}, T={t}, L={l}, K={k} (two 128-deep chunks):")
    fwd_k = hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k)
    fixup_rows(hpd_stream.hpd_stream_fused_fwd, "K1")
    fwd_p = hpd_stream.hpd_stream_fused_fwd_plain(h, w, b, counts, k, "highest")
    if not torch.equal(fwd_k[2], fwd_p[2]):
        raise AssertionError("K1 at H = 256: top-K indices differ from the plain version")
    err = max(compare(n, a, r, FWD_TOL) for n, a, r in zip(("marg", "vals", "m", "s"),
              (fwd_k[0], fwd_k[1], *fwd_k[3:]), (fwd_p[0], fwd_p[1], *fwd_p[3:])))
    bitwise_same("K1 outputs", fwd_k, hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k))
    shapes = dict(u=u, h=hd, t=t, l=l, k=k)
    entry("hpd_stream_fused_fwd", "hpd_stream.cu",
          lambda: hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k),
          lambda: hpd_stream.hpd_stream_fused_fwd_plain(h, w, b, counts, k, "highest"), 3,
          err, kernel_work("K1", counts=counts, **shapes))
    sel_k = hpd_stream.hpd_stream_select(h, w, b, k)
    fixup_rows(hpd_stream.hpd_stream_select, "K4")
    if not torch.equal(sel_k[1], fwd_p[2]):
        raise AssertionError("K4 at H = 256: top-K indices differ from the plain version")
    err = max(compare(n, a, r, FWD_TOL) for n, a, r in zip(("vals", "m", "s"),
              (sel_k[0], *sel_k[2:]), (fwd_p[1], *fwd_p[3:])))
    bitwise_same("K4 outputs", sel_k, hpd_stream.hpd_stream_select(h, w, b, k))
    entry("hpd_stream_select", "hpd_stream.cu", lambda: hpd_stream.hpd_stream_select(h, w, b, k),
          lambda: hpd_stream.hpd_stream_select_plain(h, w, b, k, "highest"), 3,
          err, kernel_work("K4", **shapes))
    _, vals, idx, m, s = fwd_p
    marg_k = hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s)
    err = compare("marg", marg_k, fwd_p[0], FWD_TOL)
    bitwise_same("K5 marg", [marg_k], [hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s)])
    entry("hpd_stream_marginal", "hpd_stream.cu",
          lambda: hpd_stream.hpd_stream_marginal(h, w, b, counts, m, s),
          lambda: hpd_stream.hpd_stream_marginal_plain(h, w, b, counts, m, s, "highest"), 3,
          err, kernel_work("K5", counts=counts, **shapes))
    for name in ("hpd_stream_fused_fwd", "hpd_stream_select", "hpd_stream_marginal"):
        redesigned(out[name + WIDE_H])
    for variant, tol in (("dots", DOTS_TOL), ("softmax", FWD_TOL)):
        got = hpd_stream.hpd_stream_fused_probe(h, w, b, "highest", variant)
        ref = hpd_stream.hpd_stream_fused_probe_plain(h, w, b, "highest", variant)
        err = max(compare(f"K7 [{variant}] {n}", a, r, tol) for n, a, r in zip(("m", "s"), got, ref))
        bitwise_same(f"K7 [{variant}] m/s", got, hpd_stream.hpd_stream_fused_probe(h, w, b, "highest", variant))
        name = f"hpd_stream_fused_probe[{variant}]"
        ms, plain = (cuda_ms(lambda: hpd_stream.hpd_stream_fused_probe(h, w, b, "highest", variant), 3),
                     cuda_ms(lambda: hpd_stream.hpd_stream_fused_probe_plain(h, w, b, "highest", variant), 3))
        out[name + WIDE_H] = kernel_entry(name + WIDE_H, SRC + "hpd_stream.cu",
                                          JAX_SRC + REPLACES["hpd_stream_fused_probe"], err, ms, plain,
                                          kernel_work("K7", u=u, h=hd, t=t))
    # K7's path: the sweep ladder (tools/sweep_probe.py), its counts set to 0 just before
    from collision_handling_in_instantngp_tpu_torch.tools import sweep_probe

    zero_counts([hpd_stream.hpd_stream_fused_probe])
    rung = sweep_probe.ladder(h, w, b[None], counts, k, "highest", reps=3)
    log("  sweep ladder: " + ", ".join(f"{key} {v:.3f} ms" for key, v in rung.items()))
    for variant, count in hpd_stream.hpd_stream_fused_probe.variant_launches.items():
        if count == 0:
            raise AssertionError(f"K7 [{variant}] at H = {hd} never launched in the sweep ladder")
        out[f"hpd_stream_fused_probe[{variant}]{WIDE_H}"].update(launches=count, route="cuda")
    bargs = (h, w, b, counts, idx, vals, m, s, g_marg, g_vals, k)
    bwd_p = hpd_stream.hpd_stream_fused_bwd_plain(*bargs, "highest", False)
    for name, fn in (("hpd_stream_fused_bwd", hpd_stream.hpd_stream_fused_bwd),
                     ("hpd_tail_unique_bwd", hpd_stream.hpd_tail_unique_bwd)):
        got = fn(*bargs)
        err = max(compare(f"{name} {n}", a, r, GRAD_TOL) for n, a, r in zip(("dh", "dw", "db"), got, bwd_p))
        bitwise_same(f"{name} dh/dw/db", got, fn(*bargs))
        entry(name, "hpd_stream.cu", lambda: fn(*bargs),
              lambda: hpd_stream.hpd_stream_fused_bwd_plain(*bargs, "highest", False), 2,
              err, kernel_work("K2", **shapes))
        redesigned(out[name + WIDE_H])
    del fwd_k, fwd_p, sel_k, bwd_p, got

    lr, tr = 2, 256
    log(f"K8/K9 and K10/K11 at H={hd}, L={lr}, N={n}, T={tr}, K={k}:")
    verts = torch.randint(0, 64, (lr, n, 2), device=dev, generator=gen).float()
    layers = per_row_layers(verts, [2, *WIDE_HIDDEN], tr, dev)
    full_k = hpd_full.hpd_full_fwd(verts, layers, k)
    full_p = hpd_full.hpd_full_fwd_plain(verts, layers, k)
    if not torch.equal(full_k[2], full_p[2]):
        raise AssertionError("K10 at H = 256: top-K indices differ from the plain version")
    err = max(compare(f"K10 {n_}", a, r, FWD_TOL) for n_, a, r in zip(("marg", "vals"), full_k, full_p))
    bitwise_same("K10 outputs", full_k, hpd_full.hpd_full_fwd(verts, layers, k))
    row_shapes = dict(rows=lr * n, l=lr, k=k)
    net = dict(widths=[2, *WIDE_HIDDEN, tr], **row_shapes)
    entry("hpd_full_fwd", "hpd_full.cu", lambda: hpd_full.hpd_full_fwd(verts, layers, k),
          lambda: hpd_full.hpd_full_fwd_plain(verts, layers, k), 3, err, kernel_work("K10", **net))
    gm, gv = f32(lr, tr), f32(lr, n, k)
    fb_k = hpd_full.hpd_full_bwd(verts, layers, full_p[2], gm, gv, k)
    fb_p = hpd_full.hpd_full_bwd_plain(verts, layers, full_p[2], gm, gv, k)
    err = max(compare(f"K11 {n_}{i}", a, r, GRAD_TOL) for i, (ka, pa) in enumerate(zip(fb_k, fb_p))
              for n_, a, r in zip(("dW", "db"), ka, pa))
    bitwise_same("K11 dW/db", [t_ for pr in fb_k for t_ in pr],
                 [t_ for pr in hpd_full.hpd_full_bwd(verts, layers, full_p[2], gm, gv, k) for t_ in pr])
    entry("hpd_full_bwd", "hpd_full.cu",
          lambda: hpd_full.hpd_full_bwd(verts, layers, full_p[2], gm, gv, k),
          lambda: hpd_full.hpd_full_bwd_plain(verts, layers, full_p[2], gm, gv, k), 2,
          err, kernel_work("K11", **net))
    ht = torch.relu(torch.randn(lr, n, hd, device=dev, generator=gen))
    wt, bt = seeded_layers([hd, tr], dev)[0]
    tf_k = hpd_tail.hpd_tail_fwd(ht, wt, bt, k)
    tf_p = hpd_tail.hpd_tail_fwd_plain(ht, wt, bt, k)
    if not torch.equal(tf_k[2], tf_p[2]):
        raise AssertionError("K8 at H = 256: top-K indices differ from the plain version")
    err = max(compare(f"K8 {n_}", a, r, FWD_TOL) for n_, a, r in zip(("marg", "vals"), tf_k, tf_p))
    bitwise_same("K8 outputs", tf_k, hpd_tail.hpd_tail_fwd(ht, wt, bt, k))
    entry("hpd_tail_fwd", "hpd_tail.cu", lambda: hpd_tail.hpd_tail_fwd(ht, wt, bt, k),
          lambda: hpd_tail.hpd_tail_fwd_plain(ht, wt, bt, k), 3, err,
          kernel_work("K8", h=hd, t=tr, **row_shapes))
    targs = (ht, wt, bt, tf_p[2], gm, gv, k)
    tb_k = hpd_tail.hpd_tail_bwd(*targs)
    err = max(compare(f"K9 {n_}", a, r, GRAD_TOL)
              for n_, a, r in zip(("dh", "dw", "db"), tb_k, hpd_tail.hpd_tail_bwd_plain(*targs)))
    bitwise_same("K9 dh/dw/db", tb_k, hpd_tail.hpd_tail_bwd(*targs))
    entry("hpd_tail_bwd", "hpd_tail.cu", lambda: hpd_tail.hpd_tail_bwd(*targs),
          lambda: hpd_tail.hpd_tail_bwd_plain(*targs), 2, err,
          kernel_work("K9", h=hd, t=tr, **row_shapes))
    return out


def dyadic(gen, shape, lo, hi, scale, dev):
    """Integers in [lo, hi) times scale (a power of two), from gen."""
    return torch.randint(lo, hi, shape, device=dev, generator=gen).float() * scale


# marg against its plain version by precision: at 'high' / 'default' its p
# is rounded to bf16 operands, where one ulp of p can move a rounding
MARG_TOL = {"highest": FWD_TOL, "high": 1e-3, "default": 1e-2}


def wide_heads_phase(hpd_stream, hpd_tail, dev, gen) -> dict:
    """Heads past 128 (ROADMAP §3.1), on inputs whose logits are exact in
    fp32 and bf16 (h, w, b multiples of 1/8, 1/128, 1/512), so that the
    kernels' sums and cuBLAS's rank the columns alike (random fp32 data puts
    near-ties within their rounding differences at these widths): K1, K4,
    K5 and K7 (U = 4,000, T = 2048, L = 4, K = 4) at H = 256, 640 and 1000
    and at each precision against their plain versions (identical top-K;
    vals, m, s and K7's m, s within 1e-5; marg within MARG_TOL), bitwise
    run to run, with the rows K1's guard sent to the fix-up (exact ties
    among the columns) printed; K2 and K6 at 'highest' (1e-4 gradients),
    bitwise run to run; and K8, K9 (L = 2, N = 4,000, T = 256, K = 4) at
    640 and 1000, their times logged. Returns {H: {check: normwise error
    or fix-up rows}}."""
    out = {}
    for hd in (256, 640, 1000):
        u, t, l, k = 4000, 2048, 4, 4
        errs = out[hd] = {}
        h = dyadic(gen, (u, hd), 0, 8, 1 / 8, dev)
        w = dyadic(gen, (hd, t), -8, 9, 1 / 128, dev)
        b = dyadic(gen, (t,), -64, 65, 1 / 512, dev)
        counts = torch.randint(0, 5, (l, u), device=dev, generator=gen).float()
        log(f"K1/K2, K4-K7 at H={hd}, U={u}, T={t}, L={l}, K={k}:")
        for prec in ("high", "default", "highest"):   # 'highest' last: its ref feeds K2 / K6
            ref = hpd_stream.hpd_stream_fused_fwd_plain(h, w, b, counts, k, prec)
            fwd = hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k, prec)
            errs[f"{prec} K1 fix-up rows"] = fixup_rows(hpd_stream.hpd_stream_fused_fwd, f"K1 '{prec}'")
            sel = hpd_stream.hpd_stream_select(h, w, b, k, prec)
            if not (torch.equal(fwd[2], ref[2]) and torch.equal(sel[1], ref[2])):
                raise AssertionError(f"K1/K4 at H = {hd}, '{prec}': top-K indices differ from the "
                                     "plain version")
            for n_, a, r in zip(("K1 vals", "K1 m", "K1 s", "K4 vals", "K4 m", "K4 s"),
                                (fwd[1], fwd[3], fwd[4], sel[0], sel[2], sel[3]),
                                (ref[1], ref[3], ref[4], ref[1], ref[3], ref[4])):
                errs[f"{prec} {n_}"] = compare(f"'{prec}' {n_}", a, r, FWD_TOL)
            marg = hpd_stream.hpd_stream_marginal(h, w, b, counts, *ref[3:], prec)
            for n_, a in (("K1 marg", fwd[0]), ("K5 marg", marg)):
                errs[f"{prec} {n_}"] = compare(f"'{prec}' {n_}", a, ref[0], MARG_TOL[prec])
            bitwise_same(f"K1 at H={hd} '{prec}'", fwd, hpd_stream.hpd_stream_fused_fwd(h, w, b, counts, k, prec))
            bitwise_same(f"K5 at H={hd} '{prec}'", [marg],
                         [hpd_stream.hpd_stream_marginal(h, w, b, counts, *ref[3:], prec)])
            for variant in ("dots", "softmax"):
                got = hpd_stream.hpd_stream_fused_probe(h, w, b, prec, variant)
                want = hpd_stream.hpd_stream_fused_probe_plain(h, w, b, prec, variant)
                for n_, a, r in zip(("m", "s"), got, want):
                    errs[f"{prec} K7 {variant} {n_}"] = compare(f"'{prec}' K7 [{variant}] {n_}", a, r, FWD_TOL)
                bitwise_same(f"K7 [{variant}] at H={hd} '{prec}'", got,
                             hpd_stream.hpd_stream_fused_probe(h, w, b, prec, variant))
        del fwd, sel, marg, got, want
        bargs = (h, w, b, counts, ref[2], ref[1], ref[3], ref[4],
                 torch.randn(l, t, device=dev, generator=gen), torch.randn(u, k, device=dev, generator=gen), k)
        want = hpd_stream.hpd_stream_fused_bwd_plain(*bargs, "highest", False)
        for name, fn in (("K2", hpd_stream.hpd_stream_fused_bwd), ("K6", hpd_stream.hpd_tail_unique_bwd)):
            got = fn(*bargs)
            for n_, a, r in zip(("dh", "dw", "db"), got, want):
                errs[f"{name} {n_}"] = compare(f"{name} {n_}", a, r, GRAD_TOL)
            bitwise_same(f"{name} at H={hd}", got, fn(*bargs))
        del ref, want, got
        if hd < 512:
            continue
        lr, nr, tr = 2, 4000, 256
        log(f"K8/K9 at H={hd}, L={lr}, N={nr}, T={tr}, K={k}:")
        ht = dyadic(gen, (lr, nr, hd), 0, 8, 1 / 8, dev)
        wt, bt = dyadic(gen, (hd, tr), -8, 9, 1 / 128, dev), dyadic(gen, (tr,), -64, 65, 1 / 512, dev)
        tf = hpd_tail.hpd_tail_fwd(ht, wt, bt, k)
        tp = hpd_tail.hpd_tail_fwd_plain(ht, wt, bt, k)
        if not torch.equal(tf[2], tp[2]):
            raise AssertionError(f"K8 at H = {hd}: top-K indices differ from the plain version")
        errs["K8 marg"], errs["K8 vals"] = (compare(f"K8 {n_}", a, r, FWD_TOL)
                                            for n_, a, r in zip(("marg", "vals"), tf[:2], tp[:2]))
        bitwise_same(f"K8 at H={hd}", tf, hpd_tail.hpd_tail_fwd(ht, wt, bt, k))
        targs = (ht, wt, bt, tp[2], torch.randn(lr, tr, device=dev, generator=gen),
                 torch.randn(lr, nr, k, device=dev, generator=gen), k)
        got = hpd_tail.hpd_tail_bwd(*targs)
        for n_, a, r in zip(("dh", "dw", "db"), got, hpd_tail.hpd_tail_bwd_plain(*targs)):
            errs[f"K9 {n_}"] = compare(f"K9 {n_}", a, r, GRAD_TOL)
        bitwise_same(f"K9 at H={hd}", got, hpd_tail.hpd_tail_bwd(*targs))
        errs["K8 ms"] = cuda_ms(lambda: hpd_tail.hpd_tail_fwd(ht, wt, bt, k), 3)
        errs["K9 ms"] = cuda_ms(lambda: hpd_tail.hpd_tail_bwd(*targs), 3)
        log(f"  K8 {errs['K8 ms']:.3f} ms, K9 {errs['K9 ms']:.3f} ms")
    torch.cuda.empty_cache()
    return out


# ROADMAP §3.1's overflowing stack: four hidden layers of 512 at T = 2048,
# whose 16-row tile K10/K11 cannot hold
DEEP_HIDDEN = (512, 512, 512, 512)


def overflow_stack_phase(hpd_tail, hpd_full, dev) -> dict:
    """The per-row route "auto" on [2 -> 512 x 4 -> 2048], K = 4, L = 4, N =
    16,384 a level (apply_hpd_fused with the wrappers' counts set to 0 just
    before): it must take the plain stack and K8/K9 (one launch each, none
    of K10/K11), and match the chunked PyTorch tail (the plain stack and
    the tail's plain version, "jax") in the forward (identical top-K, 1e-5)
    and in every layer's gradients (1e-4)."""
    from collision_handling_in_instantngp_tpu_torch.config import ModelConfig
    from collision_handling_in_instantngp_tpu_torch.models import hpd as port_hpd
    from collision_handling_in_instantngp_tpu_torch.models.mlp import MLP, init_layers
    from collision_handling_in_instantngp_tpu_torch.utils import prng

    cfg = ModelConfig(hpd_hidden=DEEP_HIDDEN, hash_table_size=2048, topk_k=4)
    widths = (2, *DEEP_HIDDEN, 2048)
    route = port_hpd.fused_backend(cfg)
    log(f"the stack {list(widths)} on the per-row route 'auto': K10/K11 tile fits "
        f"{hpd_full.supports(widths, 4)}, route {route!r}")
    if route != "pallas":
        raise AssertionError(f"the overflowing stack takes {route!r}, not K8/K9")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    verts = torch.randint(0, 64, (4096, 4, 4, 2), generator=gen).float().to(dev)
    g_marg = torch.randn(4, 2048, generator=gen).to(dev)
    g_vals = torch.randn(4096, 4, 4, 4, generator=gen).to(dev)
    wrappers = (hpd_tail.hpd_tail_fwd, hpd_tail.hpd_tail_bwd, hpd_full.hpd_full_fwd, hpd_full.hpd_full_bwd)
    outs = []
    for backend in ("auto", "jax"):
        net = MLP(init_layers(prng.prng_key(SEED), widths), dev)
        for fn in wrappers:
            fn.launches = 0
        marg, vals, idx = port_hpd.apply_hpd_fused(net, verts, dataclasses.replace(cfg, hpd_backend=backend))
        ((marg * g_marg).sum() + (vals * g_vals).sum()).backward()
        outs.append((marg.detach(), vals.detach(), idx, [p.grad for p in net.parameters()]))
        if backend == "auto":
            launches = [fn.launches for fn in wrappers]
            log(f"  launches K8, K9, K10, K11: {launches}")
            if launches != [1, 1, 0, 0]:
                raise AssertionError(f"the overflowing stack launched K8, K9, K10, K11 {launches} times")
    (mk, vk, ik, gk), (mp, vp, ip, gp) = outs
    same = (ik == ip).all(dim=-1).double().mean().item()
    log(f"  idx: rows with identical top-4: {same:.6f}")
    if same != 1.0:
        raise AssertionError("the overflowing stack: top-K indices differ from the plain version")
    errs = {"marg": compare("marg", mk, mp, FWD_TOL), "vals": compare("vals", vk, vp, FWD_TOL)}
    for i, (a, r) in enumerate(zip(gk, gp)):
        errs[f"grad{i}"] = compare(f"grad {i}", a, r, GRAD_TOL)
    return dict(route=route, launches=dict(zip(("K8", "K9", "K10", "K11"), launches)), errors=errs)


def wide_scaled_profile(exp, data, shuffled, history, dev) -> dict:
    """One profiled epoch of the wide stack's ``--scaled`` training (K1 and
    K2 at H = 256, U_c = 161,792, T = 2^14, L = 16): prints the fit's epoch
    seconds, the forward's and the backward's device ms by launch and K1's
    and K2's shares of the epoch's device time. Returns the profile with
    ``k1_ms``, ``k1_share`` (K1's rows pass, fix-up and columns pass) and
    ``k2_ms``, ``k2_share`` (K2's row and columns kernels), the reduces
    apart."""
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.train.train_step import build_epoch_batches

    statics = gngf.make_statics(exp.model)
    batches = build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction, shuffled,
                                  data.image, exp.model, statics, dev)
    log(f"profile: one epoch of the wide --scaled training, device time by kernel "
        f"(the fit's epoch s {[round(r['seconds'], 4) for r in history]}):")
    prof = profile_epoch(exp, statics, batches, dev)
    log_profile(prof)
    for key, what, kernels in (
            ("k1", "K1", ("hpd_fwd_rows_kernel", "hpd_fix_rows_kernel", "hpd_fwd_cols_kernel")),
            ("k2", "K2", ("hpd_bwd_rows_kernel", "hpd_bwd_cols_kernel"))):
        prof[f"{key}_per_launch_ms"] = per_launch(f"{what} at H=256 in training", prof, kernels)
        prof[f"{key}_ms"] = sum(r["ms"] for r in prof["kernels"] if any(k in r["name"] for k in kernels))
        prof[f"{key}_share"] = prof[f"{key}_ms"] / max(prof["busy_ms"], 1e-9)
        log(f"  {what}'s launches: {prof[f'{key}_ms']:.2f} ms of the epoch's {prof['busy_ms']:.2f} ms "
            f"of device time ({prof[f'{key}_share']:.1%})")
    log(f"  idle {prof['idle_share']:.2%}")
    return prof


# the JAX kernel each wrapper replaces (JAX_SRC + this)
REPLACES = {"hpd_stream_fused_fwd": "hpd_stream.py:570", "hpd_stream_fused_bwd": "hpd_stream.py:722",
            "hpd_stream_fused_probe": "hpd_stream.py:1081",
            "hpd_stream_select": "hpd_stream.py:193", "hpd_stream_marginal": "hpd_stream.py:282",
            "hpd_tail_unique_bwd": "hpd_stream.py:921", "hpd_tail_fwd": "hpd_tail.py:87",
            "hpd_tail_bwd": "hpd_tail.py:182", "hpd_full_fwd": "hpd_full.py:162",
            "hpd_full_bwd": "hpd_full.py:236"}


def wide_fits(fit, routes, dev) -> dict:
    """The wide stack on each of ``routes`` ((what, config overrides,
    image, {name: wrapper}, force the split route)): 2 epochs on the card
    and on the CPU from one start, the losses compared; fails unless each
    wrapper launched. Returns {name[H=256]: launches}."""
    from collision_handling_in_instantngp_tpu_torch.config import ModelConfig, experiment_from_grid_id
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hpd_stream

    launches = {}
    for what, kw, img, wrappers, force_split in routes:
        exp = experiment_from_grid_id(4061, base_model=ModelConfig(hpd_hidden=WIDE_HIDDEN, **kw))
        start = gngf.init_params(exp.model, SEED, "cpu")
        saved_gate = hpd_stream.FUSED_W_MAX_BYTES
        if force_split:
            hpd_stream.FUSED_W_MAX_BYTES = 0
        try:
            for fn in wrappers.values():
                fn.launches = 0
            r_gpu = fit(exp, img, epochs=2, device=dev, params=start, verbose=False)
            for name, fn in wrappers.items():
                if fn.launches == 0:
                    raise AssertionError(f"{name} never launched on the wide {what}")
                launches[name + WIDE_H] = fn.launches
            r_cpu = fit(exp, img, epochs=2, device="cpu", params=start, verbose=False)
        finally:
            hpd_stream.FUSED_W_MAX_BYTES = saved_gate
        for hg, hc in zip(r_gpu.history, r_cpu.history):
            log(f"  wide {what} epoch {hg['epoch']}: loss card {hg['train_loss']:.7f} "
                f"cpu {hc['train_loss']:.7f}")
            if not math.isclose(hg["train_loss"], hc["train_loss"], rel_tol=1e-4):
                raise AssertionError(f"wide {what}: training on the card disagrees with the CPU")
    return launches



def zero_counts(fns) -> None:
    """Set each wrapper's launch count, and its counts by variant, to 0."""
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "variant_launches"):
            fn.variant_launches = dict.fromkeys(fn.variant_launches, 0)


def fit_checked(fit, exp, data, dev, wrappers, what, absent=(), variants=()):
    """fit for 3 epochs with the wrappers' counts, by variant too (and those
    of ``absent``), set to 0 just before; fails unless each wrapper and each
    of ``variants`` ("name[variant]") launched, no ``absent`` one did, and
    the loss is finite and falls. Returns (launches, history, seconds)."""
    zero_counts((*wrappers.values(), *absent))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit(exp, data, epochs=3, device=dev, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    launches.update({f"{name}[{v}]": n for name, fn in wrappers.items()
                     for v, n in getattr(fn, "variant_launches", {}).items()})
    for row in res.history:
        log(f"  epoch {row['epoch']}: loss {row['train_loss']:.6f} mse {row['mse_loss']:.6f} "
            f"psnr {row['train_psnr']:.4f} {row['seconds']:.3f} s {row['pixels_per_s']:.0f} px/s "
            f"(stats {row['stats_seconds']:.3f} s, best-params copy {row['ckpt_seconds']:.3f} s)")
    log(f"  fit total {fit_s:.2f} s, launches {launches}")
    losses = [row["train_loss"] for row in res.history]
    mses = [row["mse_loss"] for row in res.history]
    # epoch 0 carries no collision term (no previous epoch); it enters at epoch 1
    if not all(math.isfinite(v) for v in losses) or not (losses[-1] < losses[1] and mses[-1] < mses[0]):
        raise AssertionError(f"{what}: loss not finite and falling: {losses}, mse {mses}")
    for name in (*wrappers, *variants):
        if launches[name] == 0:
            raise AssertionError(f"{name} never launched on {what}")
    for fn in absent:
        if fn.launches:
            raise AssertionError(f"{fn.__name__} launched {fn.launches} times on {what}")
    return launches, res.history, fit_s


def two_fits(fit, runs, dev) -> dict:
    """Each (what, exp, data, epochs) of ``runs`` fit twice on the card from
    one start; every final parameter and buffer compared bitwise, the
    result printed on a line of its own. Raises if any differ. Returns
    {what: {"bitwise": bool, "differ": [...], "max_abs_diff": x, "epoch_s": [...]}}."""
    from collision_handling_in_instantngp_tpu_torch.models import gngf

    out = {}
    for what, exp, data, epochs in runs:
        start = gngf.init_params(exp.model, SEED, "cpu")
        fits = [fit(exp, data, epochs=epochs, device=dev, params=start, verbose=False)
                for _ in range(2)]
        sa, sb = (f.params.state_dict() for f in fits)
        differ = [name for name in sa if not torch.equal(sa[name], sb[name])]
        diff = max(((sa[n].double() - sb[n].double()).abs().max().item() for n in differ), default=0.0)
        secs = [row["seconds"] for f in fits for row in f.history]
        verdict = "bitwise equal" if not differ else f"DIFFER in {differ} (max abs diff {diff:.3e})"
        log(f"two fits from one start, {what}, {epochs} epochs: {verdict}; epoch s {secs}")
        out[what] = dict(bitwise=not differ, differ=differ, max_abs_diff=diff, epoch_s=secs)
        if differ:
            raise AssertionError(f"{what}: two fits from one start differ: {differ}")
    return out


# grid ids 4062 and 4064: grid 4061 with K = 20 and K = 128
WIDE_K_GRIDS = {20: 4062, 128: 4064}


def wide_k_scatter_phase(mcfg, geom, dev, gen) -> dict:
    """K12 at the shapes the chunked tail's route gives it on batch 0: the
    ring variant on the blend's table gradient (flat ids from the chunked
    tail's top-K of real h from K3a, rows of C = L * F on T slots, as
    ``models/encoding.py: blend_unique`` forms them), with the hottest
    slot's time; the narrow variant on ``gather_rows``' table gradient.
    Returns {variant: entry}."""
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops import dedup
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hidden
    from collision_handling_in_instantngp_tpu_torch.ops.fused_hpd import hpd_tail_unique

    x = dedup.active_coords(geom.active, dedup.grid_side(mcfg.n_max))
    params = gngf.init_params(mcfg, SEED, dev)
    layers = [(w_.detach(), b_.detach()) for w_, b_ in params.hpd.layers()]
    k, t = mcfg.topk_k, mcfg.hash_table_size
    with torch.no_grad():
        h = hidden.hidden_stack_fwd(x, layers[:-1]).contiguous()
        w, b = layers[-1]
        _, _, idx = hpd_tail_unique(h, w, b, geom.counts, k, mcfg.matmul_precision, False, "jax")
    flat = idx.reshape(-1).long()
    log(f"K12 scatter_add_serial [ring], the blend's table gradient at K = {k}: idx from the "
        f"chunked tail's top-{k} of real h, U_c={h.shape[0]}, T={t}:")
    del h, idx, params, layers
    rows = torch.randn(flat.numel(), mcfg.num_levels * mcfg.feature_dim, device=dev, generator=gen)
    ring = scatter_phase("ring", rows, flat, t)
    hot_slot(ring, rows, flat, t)
    del rows, flat
    torch.cuda.empty_cache()
    narrow = gather_scatter_phase(geom, mcfg.feature_dim, dev, gen)
    return {"ring": ring, "narrow": narrow}


def wide_k_phase(fit, data, small_data, dev, gen) -> dict:
    """K > 16 and an approximate top-k on the dedup route: the chunked
    PyTorch tail (``ops/fused_hpd.py: HpdTailUniqueChunked``, not a kernel)
    with K3a/K3b for the hidden stack and K12 for the table gradients.
    Small streamed geometries at K = 20 and at K = 4 with a recall target,
    card against CPU; then ``fit`` at ``--scaled`` for grid 4064 (K = 128)
    and 4062 (K = 20), 3 epochs each, the counts set to 0 just before:
    K3a, K3b and both K12 variants must launch, K1, K2 and K4-K6 never;
    one profiled epoch at K = 128, then K12 at that fit's shapes against
    its plain version; two fits from one start at K = 20, bitwise equal."""
    from collision_handling_in_instantngp_tpu_torch.config import (
        ModelConfig, experiment_from_grid_id, instantngp_scaled_model,
    )
    from collision_handling_in_instantngp_tpu_torch.data import make_shuffle_permutations
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.models.hpd import unique_tail_backend
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hidden, hpd_stream, scatter
    from collision_handling_in_instantngp_tpu_torch.train.train_step import build_epoch_batches

    def chunked_route(exp) -> None:
        m = exp.model
        if unique_tail_backend(m, m.hash_table_size, m.topk_k, m.hpd_hidden[-1]) != "jax":
            raise AssertionError(f"grid {exp.grid_id}: not routed to the chunked tail")

    kernels = (hpd_stream.hpd_stream_fused_fwd, hpd_stream.hpd_stream_fused_bwd,
               hpd_stream.hpd_stream_select, hpd_stream.hpd_stream_marginal,
               hpd_stream.hpd_tail_unique_bwd)
    log("small streamed geometry at K = 20 and at K = 4 with a recall target, 2 epochs, "
        "card vs CPU (the chunked tail on both):")
    for what, grid_id, kw in (("K = 20", 4062, {}),
                              ("K = 4, recall 0.95", 4061, dict(topk_approx_recall=0.95))):
        small = experiment_from_grid_id(grid_id, base_model=ModelConfig(
            hash_table_size=2048, num_levels=4, n_min=8, n_max=48, hpd_backend="unique_stream",
            **kw))
        chunked_route(small)
        start = gngf.init_params(small.model, SEED, "cpu")
        for fn in kernels:
            fn.launches = 0
        r_gpu = fit(small, small_data, epochs=2, device=dev, params=start, verbose=False)
        if any(fn.launches for fn in kernels):
            raise AssertionError(f"small geometry, {what}: a kernel of the streamed tail ran")
        r_cpu = fit(small, small_data, epochs=2, device="cpu", params=start, verbose=False)
        for hg, hc in zip(r_gpu.history, r_cpu.history):
            log(f"  {what} epoch {hg['epoch']}: loss card {hg['train_loss']:.7f} "
                f"cpu {hc['train_loss']:.7f}")
            if not math.isclose(hg["train_loss"], hc["train_loss"], rel_tol=1e-4):
                raise AssertionError(f"small geometry, {what}: the card disagrees with the CPU")

    wrappers = {"hidden_stack_fwd": hidden.hidden_stack_fwd,
                "hidden_stack_bwd": hidden.hidden_stack_bwd,
                "scatter_add_serial": scatter.scatter_add_serial}
    out = {}
    for k, grid_id in sorted(WIDE_K_GRIDS.items(), reverse=True):
        exp = experiment_from_grid_id(grid_id, base_model=instantngp_scaled_model())
        if exp.model.topk_k != k:
            raise AssertionError(f"grid {grid_id} has K = {exp.model.topk_k}, not {k}")
        chunked_route(exp)
        log(f"fit: grid {grid_id} (K = {k}), scaled geometry, strawberry, 3 epochs:")
        launches, history, fit_s = fit_checked(
            fit, exp, data, dev, wrappers, f"the chunked tail at K = {k}", absent=kernels,
            variants=("scatter_add_serial[ring]", "scatter_add_serial[narrow]"))
        out[f"k{k}"] = dict(grid_id=grid_id, history=history, fit_s=fit_s, launches=launches)
        if k == 128:
            statics = gngf.make_statics(exp.model)
            shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed,
                                                    exp.train.shuffle_pixels)
            batches = build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction,
                                          shuffled, data.image, exp.model, statics, dev)
            log(f"profile: one epoch at K = {k}, device time by kernel:")
            out[f"k{k}"]["profile"] = profile_epoch(exp, statics, batches, dev)
            log_profile(out[f"k{k}"]["profile"])
            out[f"k{k}"]["scatter"] = wide_k_scatter_phase(exp.model, batches.dedup[0], dev, gen)
            del batches
            torch.cuda.empty_cache()
    exp20 = experiment_from_grid_id(WIDE_K_GRIDS[20], base_model=instantngp_scaled_model())
    out["two_fits"] = two_fits(fit, [("the chunked tail at K = 20", exp20, data, 3)], dev)
    return out


def log_profile(profile) -> None:
    for row in profile["kernels"][:14]:
        log(f"  {row['ms']:10.3f} ms {row['share']:7.2%} x{row['calls']:<4d} {row['name'][:90]}")
    log(f"  epoch wall {profile['wall_ms']:.1f} ms, device busy {profile['busy_ms']:.1f} ms, "
        f"idle share {profile['idle_share']:.2%}")


def vanilla_phase(fit, data, small_data, dev, gen) -> dict:
    """Step 16, the vanilla hash (``use_hash_function=True``: no HPD; the
    table gradient of ``lookup_vanilla`` on K12): a small geometry card vs
    CPU; ``fit`` of grid 4061 for 3 epochs at the default geometry (K12's
    ring) and at ``instantngp_scaled_model()`` (its narrow variant), the
    counts set to 0 just before, no HPD kernel allowed; a profiled epoch of
    each; K12 at each fit's batch-0 shapes (flat hash ids of every (pixel,
    level, corner) row, rows of F = 2 on L * T slots) bitwise to its plain
    version and run to run, timed beside ``index_add_``, the hottest slot
    alone; two fits from one start at each geometry, bitwise equal."""
    from collision_handling_in_instantngp_tpu_torch.config import (
        ModelConfig, experiment_from_grid_id, instantngp_scaled_model,
    )
    from collision_handling_in_instantngp_tpu_torch.data import make_shuffle_permutations
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import (
        hidden, hpd_full, hpd_stream, hpd_tail, scatter,
    )
    from collision_handling_in_instantngp_tpu_torch.ops.grid import scale_to_grid
    from collision_handling_in_instantngp_tpu_torch.ops.hashing import fast_hash
    from collision_handling_in_instantngp_tpu_torch.train.train_step import build_epoch_batches

    hpd_kernels = (hpd_stream.hpd_stream_fused_fwd, hpd_stream.hpd_stream_fused_bwd,
                   hpd_stream.hpd_stream_select, hpd_stream.hpd_stream_marginal,
                   hpd_stream.hpd_tail_unique_bwd, hidden.hidden_stack_fwd,
                   hidden.hidden_stack_bwd, hpd_tail.hpd_tail_fwd, hpd_tail.hpd_tail_bwd,
                   hpd_full.hpd_full_fwd, hpd_full.hpd_full_bwd)
    log("small vanilla geometry, 2 epochs, card (K12) vs CPU (its plain version):")
    small = experiment_from_grid_id(4061, base_model=ModelConfig(use_hash_function=True))
    start = gngf.init_params(small.model, SEED, "cpu")
    r_gpu = fit(small, small_data, epochs=2, device=dev, params=start, verbose=False)
    r_cpu = fit(small, small_data, epochs=2, device="cpu", params=start, verbose=False)
    for hg, hc in zip(r_gpu.history, r_cpu.history):
        log(f"  epoch {hg['epoch']}: loss card {hg['train_loss']:.7f} cpu {hc['train_loss']:.7f}")
        if not math.isclose(hg["train_loss"], hc["train_loss"], rel_tol=1e-4):
            raise AssertionError("vanilla training on the card disagrees with the CPU")

    out, exps = {}, []
    for name, base, variant in (("default", ModelConfig(use_hash_function=True), "ring"),
                                ("scaled", instantngp_scaled_model(use_hash_function=True),
                                 "narrow")):
        exp = experiment_from_grid_id(4061, base_model=base)
        exps.append((f"the vanilla hash, {name} geometry", exp, data, 3))
        m = exp.model
        log(f"fit: grid 4061, vanilla hash, {name} geometry (T={m.hash_table_size}, "
            f"L={m.num_levels}), strawberry, 3 epochs:")
        launches, history, fit_s = fit_checked(
            fit, exp, data, dev, {"scatter_add_serial": scatter.scatter_add_serial},
            f"the vanilla hash ({name})", absent=hpd_kernels,
            variants=(f"scatter_add_serial[{variant}]",))
        statics = gngf.make_statics(m)
        shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed,
                                                exp.train.shuffle_pixels)
        batches = build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction,
                                      shuffled, data.image, m, statics, dev)
        log(f"profile: one vanilla epoch ({name}), device time by kernel:")
        profile = profile_epoch(exp, statics, batches, dev)
        log_profile(profile)
        _, corners = scale_to_grid(batches.x[0], torch.as_tensor(statics.n_ls, device=dev),
                                   torch.as_tensor(statics.offsets, device=dev))
        ids = fast_hash(corners, m.hash_table_size)
        level = torch.arange(m.num_levels, device=dev).view(1, -1, 1)
        flat = (ids.long() + level * m.hash_table_size).reshape(-1)
        slots = m.num_levels * m.hash_table_size
        log(f"K12 scatter_add_serial [{variant}], lookup_vanilla's table gradient of batch 0, "
            f"ids {tuple(ids.shape)}:")
        rows = torch.randn(flat.numel(), m.feature_dim, device=dev, generator=gen)
        entry = scatter_phase(variant, rows, flat, slots)
        hot_slot(entry, rows, flat, slots)
        out[name] = dict(history=history, fit_s=fit_s, launches=launches, profile=profile,
                         scatter=entry)
        del batches, rows, flat, ids, corners
        torch.cuda.empty_cache()
    out["two_fits"] = two_fits(fit, exps, dev)
    return out


def host_slot_counts(ids, num_levels, t) -> np.ndarray:
    """A counts epoch's (L, T) slot counts recounted on the host with
    ``np.bincount`` from its per-row ids (on the dedup route each batch's
    ``idx_unique[vertex ids]``, the (B, L, V, K) ids the JAX package
    materializes)."""
    per_batch = ([ids.rows] if ids.rows is not None
                 else [idx_u[vid.long()] for idx_u, _, vid in ids.unique])
    total = np.zeros(num_levels * t, np.int64)
    for rows in per_batch:
        r = rows.cpu().numpy().astype(np.int64)
        level = np.arange(num_levels).reshape(1, num_levels, *([1] * (r.ndim - 2)))
        total += np.bincount((r + level * t).reshape(-1), minlength=num_levels * t)
    return total.reshape(num_levels, t)


def checkpoint_phase(fit_with_checkpoints, data, dev) -> dict:
    """Step 17, checkpoints, histograms and warm start on the card: grid
    4061 at ``--scaled`` (dedup route, K1-K3, K12) with ``save_params``,
    ``histograms_rate=1`` and ``JsonlLogger(save_media=False)`` into a
    scratch ``checkpoint_dir`` under chiprun_out/, 3 epochs. Fails unless
    the five artifacts and the stamp are written (no ``bn_state.pkl``:
    no BatchNorm), every counts epoch's slot counts equal a host
    ``np.bincount`` of that epoch's ids, the log rows carry them, and a
    1-epoch warm start from the best checkpoint (the last epoch) gives a
    4-epoch fit's parameters bitwise. Prints the stats and checkpoint-write
    seconds of each epoch; the scratch directory is removed."""
    import shutil

    from collision_handling_in_instantngp_tpu_torch.config import (
        experiment_from_grid_id, instantngp_scaled_model,
    )
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.train import trainer
    from collision_handling_in_instantngp_tpu_torch.utils import checkpoint as ckpt
    from collision_handling_in_instantngp_tpu_torch.utils.logging import JsonlLogger

    ck_dir = os.path.join(OUT_DIR, "step17")
    shutil.rmtree(ck_dir, ignore_errors=True)
    exp = experiment_from_grid_id(4061, base_model=instantngp_scaled_model())
    m = exp.model
    exp = dataclasses.replace(exp, train=dataclasses.replace(
        exp.train, save_params=True, histograms_rate=1, checkpoint_dir=ck_dir))
    recounts = []
    make_stats_fn = trainer.make_stats_fn

    def recording(exp_, statics_):
        stats_fn = make_stats_fn(exp_, statics_)

        def stats(ids, coords):
            slot_c, cell_c = stats_fn(ids, coords)
            t0 = time.perf_counter()
            recounts.append((slot_c.cpu().numpy(), host_slot_counts(ids, m.num_levels,
                                                                     m.hash_table_size),
                             time.perf_counter() - t0))
            return slot_c, cell_c
        return stats

    log_path = os.path.join(ck_dir, "run.jsonl")
    log("fit: grid 4061, scaled geometry, checkpoints and a counts epoch every epoch, 3 epochs:")
    trainer.make_stats_fn = recording
    try:
        res = fit_with_checkpoints(exp, data, epochs=3, device=dev, verbose=False,
                                   logger=JsonlLogger(log_path, save_media=False),
                                   run_name="smoke")
    finally:
        trainer.make_stats_fn = make_stats_fn
    for row, (*_, recount_s) in zip(res.history, recounts):
        # stats_seconds holds this smoke's host recount too: taken out
        row["stats_seconds"] -= recount_s
        log(f"  epoch {row['epoch']}: loss {row['train_loss']:.6f} psnr {row['train_psnr']:.4f} "
            f"{row['seconds']:.3f} s; stats {row['stats_seconds']:.3f} s (the host recount "
            f"{recount_s:.3f} s apart), checkpoint {row['ckpt_seconds']:.3f} s")
    files = sorted(os.listdir(res.run_dir))
    want = sorted(["whole_model.pkl", "whole_opt.pkl", "encoding_model.pkl", "HPD_model.pkl",
                   "MLP_model.pkl", "checkpoint_meta.json"])
    log(f"  {res.run_dir}: {files}")
    if files != want:
        raise AssertionError(f"the run directory holds {files}, not {want}")
    if len(recounts) != 3:
        raise AssertionError(f"{len(recounts)} counts epochs, not 3")
    for ep, (dev_counts, host_counts, _) in enumerate(recounts):
        if not np.array_equal(dev_counts, host_counts):
            raise AssertionError(f"epoch {ep}: slot counts differ from the host's np.bincount")
    log(f"  slot counts of the 3 counts epochs equal the host's np.bincount of their ids "
        f"({int(recounts[0][1].sum())} entries an epoch)")
    with open(log_path) as f:
        rows = [json.loads(line) for line in f]
    # T = 16,384 counts a level are logged as "<array(16384,)>" (lists up to 4,096)
    keys = [f"hist_counts_level{l_}_counts" for l_ in range(m.num_levels)] + ["train_image"]
    if len(rows) != 3 or not all(k in row for row in rows for k in keys):
        raise AssertionError("the log rows lack the counts epochs' counts or image")
    psnrs = [row["train_psnr"] for row in res.history]
    if psnrs[-1] != max(psnrs):
        raise AssertionError(f"the best epoch is not the last: {psnrs}")
    tree, _, bn_state = ckpt.load_run_checkpoint(res.run_dir, model_cfg=m)
    best = gngf.params_to_numpy(res.best_params)
    if bn_state is not None or not all(np.array_equal(a, b) for a, b in zip(
            (tree["tables"], *[l_["w"] for l_ in tree["hpd"]]),
            (best["tables"], *[l_["w"] for l_ in best["hpd"]]))):
        raise AssertionError("the checkpoint is not the best epoch's parameters")
    plain = dataclasses.replace(exp, train=dataclasses.replace(exp.train, save_params=False))
    t0 = time.perf_counter()
    warm = fit_with_checkpoints(plain, data, epochs=1, device=dev, verbose=False,
                                warm_start_dir=res.run_dir)
    warm_s = time.perf_counter() - t0
    four = fit_with_checkpoints(plain, data, epochs=4, device=dev, verbose=False)
    sa, sb = warm.params.state_dict(), four.params.state_dict()
    differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
    log(f"warm start from the best checkpoint, 1 epoch ({warm_s:.2f} s with the load) vs a "
        f"4-epoch fit: {'bitwise equal' if not differ else f'DIFFER in {differ}'}")
    if differ:
        raise AssertionError(f"the warm start differs from continuing: {differ}")
    shutil.rmtree(ck_dir)
    return dict(history=res.history, files=files, warm_start_s=warm_s,
                counts_entries=int(recounts[0][1].sum()), warm_bitwise=True)


def grid_render_phase(data, dev) -> tuple:
    """Step 18, the grid driver, render and the CLI on the card, at
    ``instantngp_scaled_model()`` on the strawberry:

    (a) ``run_grid_search`` over ids [4061, 4064] (K = 4 on K1/K2, K = 128
        on the chunked tail), 2 epochs each, checkpoints and the manifest in
        a scratch directory under chiprun_out/: two rows of the nine keys,
        K1, K2, K3a, K3b and K12 launched, the split kernels not; a second
        call launches nothing and replays both rows; 4062 by ``ids=``; then
        shards 0/2 and 1/2 over [4061, 4062, 4064] against that manifest
        return [4061, 4064] and [4062], the stored rows, and launch nothing;
    (b) ``render_image`` of 4061's best checkpoint at 508 x 339: K3a and K1
        launched (three chunks of 65,536 rows), no backward or split kernel;
        its PSNR within 0.3 dB of that fit's best; K1 at render's shapes
        (the whole vertex grid, U = 264,196, one level of zero counts) on
        the trained weights against its plain version: top-K identical on
        every row, values normwise 1e-5, the marginal zero, bitwise run to
        run, the fix-up rows printed, timed; the render timed at 508 x 339
        and 2x supersampled (1016 x 678);
    (c) the CLI, ``--scaled --should_bw -t -s 4061 -e 4061 --epochs 2`` in a
        scratch working directory: exit 0, a one-channel checkpoint, the
        render's line, and the comparison figure or (without matplotlib)
        the line that says none is written.

    The scratch directory is removed. Returns (the kernels-line entry of K1
    at render's shapes, the step's numbers)."""
    import contextlib
    import io
    import shutil

    from collision_handling_in_instantngp_tpu_torch import cli, render
    from collision_handling_in_instantngp_tpu_torch.config import (
        TrainConfig, experiment_from_grid_id, instantngp_scaled_model,
    )
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hidden, hpd_stream, scatter
    from collision_handling_in_instantngp_tpu_torch.train.grid_search import (
        load_manifest, run_grid_search,
    )
    from collision_handling_in_instantngp_tpu_torch.utils import checkpoint as ckpt
    from collision_handling_in_instantngp_tpu_torch.utils.metrics import calc_psnr

    root = os.path.join(OUT_DIR, "step18")
    shutil.rmtree(root, ignore_errors=True)
    manifest = os.path.join(root, "grid_manifest.jsonl")
    model = instantngp_scaled_model()
    train = TrainConfig(checkpoint_dir=os.path.join(root, "weights"))
    dedup_kernels = {
        "hpd_stream_fused_fwd": hpd_stream.hpd_stream_fused_fwd,
        "hpd_stream_fused_bwd": hpd_stream.hpd_stream_fused_bwd,
        "hidden_stack_fwd": hidden.hidden_stack_fwd,
        "hidden_stack_bwd": hidden.hidden_stack_bwd,
        "scatter_add_serial": scatter.scatter_add_serial,
    }
    split_kernels = {
        "hpd_stream_select": hpd_stream.hpd_stream_select,
        "hpd_stream_marginal": hpd_stream.hpd_stream_marginal,
        "hpd_tail_unique_bwd": hpd_stream.hpd_tail_unique_bwd,
    }
    every = {**dedup_kernels, **split_kernels}

    def counted(fn, what):
        zero_counts(every.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: f.launches for n, f in every.items()}
        log(f"  {what}: {secs:.2f} s, launches {launches}")
        return out, launches, secs

    def sweep(what, **kw):
        return counted(lambda: run_grid_search(
            data, base_model=model, base_train=train, epochs=2, manifest_path=manifest,
            verbose=False, device=dev, **kw), what)

    keys = ["grid_id", "image", "best_psnr", "final_psnr", "final_loss", "epochs_run",
            "stopped_early", "zero_collision_abort", "run_dir"]
    log("grid driver: ids [4061, 4064] at scaled geometry, 2 epochs, manifest and "
        "checkpoints under chiprun_out/step18/:")
    rows, launches, sweep_s = sweep("sweep", ids=[4061, 4064])
    for row in rows:
        log(f"  {json.dumps(row)}")
    if [r["grid_id"] for r in rows] != [4061, 4064] or any(list(r) != keys for r in rows):
        raise AssertionError(f"the sweep's rows are not those of 4061 and 4064: {rows}")
    if not all(math.isfinite(r["final_loss"]) and r["epochs_run"] == 2 for r in rows):
        raise AssertionError("a sweep row has a non-finite loss or not 2 epochs")
    if any(launches[n] == 0 for n in dedup_kernels) or any(launches[n] for n in split_kernels):
        raise AssertionError(f"the sweep did not run the dedup route's kernels alone: {launches}")
    again, launches2, _ = sweep("the same sweep again (manifest resume)", ids=[4061, 4064])
    if again != rows or any(launches2.values()):
        raise AssertionError("the resumed sweep trained again or did not replay the rows")
    (row4062,), _, _ = sweep("id 4062 by ids=", ids=[4062])
    stored = load_manifest(manifest)
    if sorted(stored) != [4061, 4062, 4064]:
        raise AssertionError(f"the manifest holds {sorted(stored)}")
    shards = {}
    for index, want in ((0, [4061, 4064]), (1, [4062])):
        got, shard_launches, _ = sweep(f"shard {index}/2 of [4061, 4062, 4064]",
                                       ids=[4061, 4062, 4064], shard_index=index, shard_count=2)
        shards[index] = [r["grid_id"] for r in got]
        if shards[index] != want or got != [stored[i] for i in want] or any(
                shard_launches.values()):
            raise AssertionError(f"shard {index}/2 returned {shards[index]}, not {want}")
    log(f"  shards 0/2 and 1/2: {shards[0]} and {shards[1]}, replayed, no launch")

    best = rows[0]
    exp = experiment_from_grid_id(4061, base_model=model)
    tree = ckpt.load_pytree(os.path.join(best["run_dir"], "whole_model.pkl"))
    params = gngf.params_from_jax(tree, dev)
    h_img, w_img = data.height, data.width
    log(f"render: grid 4061's best checkpoint at {h_img} x {w_img}:")
    img, render_launches, render_s = counted(lambda: render.render_image(
        params, exp.model, height=h_img, width=w_img, device=dev), "render")
    if any(render_launches[n] == 0 for n in ("hidden_stack_fwd", "hpd_stream_fused_fwd")) or any(
            render_launches[n] for n in every if n not in ("hidden_stack_fwd",
                                                           "hpd_stream_fused_fwd")):
        raise AssertionError(f"the render did not run K3a and K1 alone: {render_launches}")
    psnr = calc_psnr(img.astype(np.int64), data.image)
    log(f"  image {img.shape} {img.dtype}, PSNR {psnr:.4f} dB against the fit's best "
        f"{best['best_psnr']:.4f}")
    if img.shape != (h_img, w_img, 3) or abs(psnr - best["best_psnr"]) >= 0.3:
        raise AssertionError("the rendered image is not the best checkpoint's reconstruction")
    times = {}
    for what, kw in (("native", dict(height=h_img, width=w_img)),
                     ("supersampled", dict(height=2 * h_img, width=2 * w_img,
                                           train_shape=(h_img, w_img)))):
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render.render_image(params, exp.model, device=dev, **kw)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        if out.shape != (kw["height"], kw["width"], 3):
            raise AssertionError(f"{what} render: shape {out.shape}")
        times[what] = secs
        log(f"  {what} render {kw['height']} x {kw['width']}: s {secs}")

    statics = gngf.make_statics(exp.model)
    ucoords = torch.as_tensor(statics.unique_coords, device=dev)
    layers = [(w.detach(), b.detach()) for w, b in params.hpd.layers()]
    h = hidden.hidden_stack_fwd(ucoords, layers[:-1]).contiguous()
    w_head, b_head = layers[-1]
    u, H, T, k = h.shape[0], h.shape[1], w_head.shape[1], exp.model.topk_k
    counts = torch.zeros(1, u, device=dev)
    log(f"K1 at render's shapes: U = {u}, H = {H}, T = {T}, K = {k}, one level of zero "
        "counts, trained weights:")
    out_k = hpd_stream.hpd_stream_fused_fwd(h, w_head, b_head, counts, k)
    fix = fixup_rows(hpd_stream.hpd_stream_fused_fwd, "K1 at render's shapes")
    out_p = hpd_stream.hpd_stream_fused_fwd_plain(h, w_head, b_head, counts, k, "highest")
    same_idx = (out_k[2] == out_p[2]).all(dim=1).double().mean().item()
    log(f"  idx: rows with identical top-{k}: {same_idx:.6f}")
    if same_idx != 1.0:
        raise AssertionError("K1 at render's shapes: top-K indices differ from the plain version")
    if out_k[0].abs().max().item() != 0.0:
        raise AssertionError("K1 at render's shapes: the marginal of zero counts is not zero")
    err = max(compare(n, a, r, FWD_TOL) for n, a, r in zip(
        ("vals", "m", "s"), (out_k[1], out_k[3], out_k[4]), (out_p[1], out_p[3], out_p[4])))
    bitwise_same("marg/vals/idx/m/s", out_k,
                 hpd_stream.hpd_stream_fused_fwd(h, w_head, b_head, counts, k))
    del out_p
    ms = cuda_ms(lambda: hpd_stream.hpd_stream_fused_fwd(h, w_head, b_head, counts, k), 5)
    plain = cuda_ms(lambda: hpd_stream.hpd_stream_fused_fwd_plain(
        h, w_head, b_head, counts, k, "highest"), 2)
    entry = kernel_entry("hpd_stream_fused_fwd[render]", SRC + "hpd_stream.cu",
                         JAX_SRC + "hpd_stream.py:570", err, ms, plain,
                         kernel_work("K1", u=u, h=H, t=T, l=1, k=k, counts=counts))
    entry.update(route="cuda", launches=render_launches["hpd_stream_fused_fwd"], fixup_rows=fix,
                 rows=u)
    del h, out_k, params

    cli_dir = os.path.join(root, "cli")
    cli_manifest = os.path.join(root, "cli_manifest.jsonl")
    argv = ["-f", "strawberry.npy", "--images_dir", os.path.join(HERE, "images"), "--scaled",
            "--should_bw", "-t", "-s", "4061", "-e", "4061", "--epochs", "2",
            "--manifest", cli_manifest]
    log(f"CLI: {' '.join(argv)} (in a scratch working directory):")
    os.makedirs(cli_dir)
    cwd, buf = os.getcwd(), io.StringIO()
    os.chdir(cli_dir)
    try:
        with contextlib.redirect_stdout(buf):
            rc, cli_launches, cli_s = counted(lambda: cli.main(argv), "cli")
    finally:
        os.chdir(cwd)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"  | {line}")
    log(f"  exit {rc}, {cli_s:.2f} s, launches {cli_launches}")
    cli_row = load_manifest(cli_manifest).get(4061)
    if rc != 0 or cli_row is None:
        raise AssertionError("the CLI did not exit 0 with a manifest row")
    mlp = ckpt.load_pytree(os.path.join(cli_dir, cli_row["run_dir"], "whole_model.pkl"))["mlp"]
    if mlp[-1]["w"].shape[-1] != 1 or f"({h_img}x{w_img}, {data.num_pixels} pixels, 1 channels)" \
            not in out:
        raise AssertionError("--should_bw did not train a one-channel model on the gray image")
    figure = os.path.join(cli_dir, "runs", "strawberry_4061_comparison.png")
    no_figure = "matplotlib not available; no comparison figure is written"
    if "rendered grid 4061" not in out or not (
            os.path.exists(figure) if cli.has_matplotlib() else no_figure in out):
        raise AssertionError("-t did not render, or neither wrote the figure nor said so")
    if cli_launches["hpd_stream_fused_fwd"] == 0 or cli_launches["hpd_stream_fused_bwd"] == 0:
        raise AssertionError(f"the CLI's run did not go through K1/K2: {cli_launches}")
    shutil.rmtree(root)
    return entry, dict(rows=rows, sweep_s=sweep_s, sweep_launches=launches, row_4062=row4062,
                       shards=shards, render_launches=render_launches, render_s=render_s,
                       render_psnr=psnr, best_psnr=best["best_psnr"], render_times_s=times,
                       cli_row=cli_row, cli_s=cli_s, cli_launches=cli_launches,
                       cli_figure=cli.has_matplotlib())


# history keys that hold times, not results (a span's rows share its time)
TIMING_KEYS = {"seconds", "pixels_per_s", "stats_seconds", "ckpt_seconds", "span_epochs"}


def same_state(a, b) -> list:
    """The state_dict keys (params and buffers) where two models differ."""
    sa, sb = a.state_dict(), b.state_dict()
    return [k for k in sa if not torch.equal(sa[k], sb[k])]


def tree_leaves(tree) -> list:
    """The leaves of a checkpoint tree (dicts by key, lists, tuples and the
    optax stand-ins, which are named tuples) as numpy arrays, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def same_checkpoint(dir_a, dir_b, model_cfg) -> bool:
    """Two run directories hold bitwise the same params, optimizer state
    (Adam's moments and count) and BatchNorm statistics."""
    from collision_handling_in_instantngp_tpu_torch.utils import checkpoint as ckpt

    la, lb = (tree_leaves(ckpt.load_run_checkpoint(d, model_cfg=model_cfg)) for d in (dir_a, dir_b))
    return len(la) == len(lb) and all(a.shape == b.shape and np.array_equal(a, b)
                                      for a, b in zip(la, lb))


def profile_single_and_span(exp, data, dev, n) -> tuple:
    """Device time by kernel of one epoch (``run_epoch``, its scalars to the
    host) and of one span of ``n`` epochs (``run_span`` and its one
    transfer), after a warm-up epoch: (single, span), each from
    ``utils.profiling.device_time_by_kernel``; then the best-epoch snapshot
    of a checkpointing span (``BestTracker.update`` over the params, buffers
    and Adam state): {"mb", "ms" (CUDA events over 20 updates), "host_ms"
    (the host's time to enqueue one)} as a third element."""
    from torch.profiler import ProfilerActivity, profile
    from collision_handling_in_instantngp_tpu_torch.data import make_shuffle_permutations
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.train import train_step
    from collision_handling_in_instantngp_tpu_torch.train.optimizer import make_optimizer
    from collision_handling_in_instantngp_tpu_torch.utils.profiling import device_time_by_kernel

    statics = gngf.make_statics(exp.model)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed,
                                            exp.train.shuffle_pixels)
    batches = train_step.build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction,
                                             shuffled, data.image, exp.model, statics, dev)
    params = gngf.init_params(exp.model, exp.train.seed, dev)
    optimizer = make_optimizer(exp.optimizer, params)
    prev, min_poss = train_step.initial_collision_state(exp, statics, dev)
    prev = train_step.run_epoch(params, optimizer, batches, exp, statics, prev,
                                min_poss).collisions_device
    tracker = train_step.BestTracker(params)
    out = []
    for span in (1, n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if span == 1:
                prev = train_step.run_epoch(params, optimizer, batches, exp, statics, prev,
                                            min_poss).collisions_device
            else:
                tracker.reset()
                scalars, _ = train_step.run_span(params, optimizer, batches, exp, statics, prev,
                                                 min_poss, span, tracker)
                scalars.to_host()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        out.append(device_time_by_kernel(prof, wall_ms))
    snap = train_step.BestTracker(params, optimizer)
    err = torch.zeros((), device=dev)
    snap.update(err, 0)
    bufs = [*snap.state.values(), *(t for st in snap.opt.values() for t in st.values())]
    mb = sum(t.numel() * t.element_size() for t in bufs) / 1e6
    out.append(dict(mb=mb, ms=cuda_ms(lambda: snap.update(err, 1), 20),
                    host_ms=host_ms(lambda: snap.update(err, 1), 20)))
    return tuple(out)


def timed_ensemble(trainer, exps, data, dev, epochs, span) -> tuple:
    """(``fit_ensemble``'s results, its seconds on the host clock, the card
    synchronised on both sides); run names ``ens{id}``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.fit_ensemble(exps, data, epochs=epochs, epoch_span=span, device=dev,
                               run_names=[f"ens{e.grid_id}" for e in exps])
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def span_ensemble_phase(fit_with_checkpoints, data, dev) -> dict:
    """Step 19, multi-epoch spans and ensembles on the card.

    (a) Spans on three routes, grid 4061 on the strawberry: the dedup route
        at ``instantngp_scaled_model()`` (K1, K2, K3a, K3b, K12), the per-row
        route at the default geometry with ``batchnorm_input`` (K10, K11,
        K12), the vanilla hash at the default geometry (K12). Each fits 6
        epochs at ``epoch_span=1`` and the same 6 at ``epoch_span=3`` from
        one start, ``histograms_rate=4`` (counts epochs 0, 4 and the last;
        one span of 3, epochs 1-3), the counts set to 0 before each; fails
        unless every kernel of the route launched, equally often in both,
        the loss is finite and falls, and the per-epoch history (times
        aside), the final params (buffers included) and the best params
        are bitwise equal, and on the dedup route, which writes its best
        checkpoint (under chiprun_out/, removed), the checkpoints too,
        Adam's state included. Every span runs under
        ``torch.cuda.set_sync_debug_mode("error")`` (``trainer.run_span``
        wrapped; its one transfer to the host comes after), so any op that
        waits for the device inside it raises. Prints the epoch seconds at
        span 1 and at span 3, the idle share of a profiled single epoch
        against a profiled span of 3, and the time of one best-epoch
        snapshot (params, buffers and Adam state).
    (b) Ensembles: grids [4061, 4051, 3961] (one shape class) at
        ``instantngp_scaled_model()``, 4 epochs, ``epoch_span=2``,
        checkpoints on (under chiprun_out/, removed), against each one's
        solo ``fit``: best PSNR, final loss, epochs run and final image
        equal, the checkpoints bitwise equal, and K1, K2, K3a, K3b and K12
        launched as often as the three solo fits together (3x one). Then
        the vanilla hash at the default geometry, E = 4 ids of one shape
        class ([4061, 4051, 3961, 4056]), 10 epochs at span 5, against
        their 4 solo fits: final losses equal. Seconds per member-epoch: the
        ensemble's, less its set-up (a 0-epoch call), against the solo
        fits' epochs (their history's ``seconds``). Peak device memory of
        each ensemble (``utils.memory``)."""
    import shutil

    from collision_handling_in_instantngp_tpu_torch.config import (
        ModelConfig, experiment_from_grid_id, instantngp_scaled_model,
    )
    from collision_handling_in_instantngp_tpu_torch.data import load_image_dataset
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import (
        hidden, hpd_full, hpd_stream, scatter,
    )
    from collision_handling_in_instantngp_tpu_torch.train import trainer

    k12 = {"scatter_add_serial": scatter.scatter_add_serial}
    dedup_kernels = {"hpd_stream_fused_fwd": hpd_stream.hpd_stream_fused_fwd,
                     "hpd_stream_fused_bwd": hpd_stream.hpd_stream_fused_bwd,
                     "hidden_stack_fwd": hidden.hidden_stack_fwd,
                     "hidden_stack_bwd": hidden.hidden_stack_bwd, **k12}
    data_raw = load_image_dataset(os.path.join(HERE, "images", "strawberry.npy"), normalize=False)
    routes = (("dedup --scaled", instantngp_scaled_model(), data, dedup_kernels),
              ("per-row auto", ModelConfig(batchnorm_input=True), data_raw,
               {"hpd_full_fwd": hpd_full.hpd_full_fwd, "hpd_full_bwd": hpd_full.hpd_full_bwd,
                **k12}),
              ("vanilla default", ModelConfig(use_hash_function=True), data, k12))

    real_run_span, checked_spans = trainer.run_span, []

    def sync_checked_span(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real_run_span(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checked_spans.append(args[7])
        return out

    ck_dir = os.path.join(OUT_DIR, "step19")
    shutil.rmtree(ck_dir, ignore_errors=True)
    out = {}
    for what, base, route_data, wrappers in routes:
        # the dedup route writes its best checkpoint at every new best (the
        # span's copy of the Adam state, its host-side step too)
        exp = experiment_from_grid_id(4061, base_model=base)
        exp = dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, save_params=base.hash_table_size > 256, histograms_rate=4,
            checkpoint_dir=os.path.join(ck_dir, "spans"), checkpoint_min_interval_s=0.0))
        start = gngf.init_params(exp.model, SEED, "cpu")
        fits = {}
        for span in (1, 3):
            zero_counts(wrappers.values())
            checked_spans.clear()
            trainer.run_span = sync_checked_span
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = fit_with_checkpoints(exp, route_data, epochs=6, device=dev, params=start,
                                           verbose=False, epoch_span=span, run_name=f"span{span}")
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
            finally:
                trainer.run_span = real_run_span
            fits[span] = dict(res=res, fit_s=fit_s, spans=list(checked_spans),
                              launches={n: fn.launches for n, fn in wrappers.items()})
        one, three = fits[1]["res"], fits[3]["res"]
        log(f"spans, {what}, grid 4061, 6 epochs at span 1 and at span 3 from one start:")
        for span, f in fits.items():
            secs = [round(r["seconds"], 6) for r in f["res"].history]
            log(f"  span {span}: epoch s {secs}, fit {f['fit_s']:.3f} s, spans run {f['spans']}, "
                f"launches {f['launches']}")
        if fits[3]["spans"] != [3] or fits[1]["spans"]:
            raise AssertionError(f"{what}: spans run {fits[1]['spans']} / {fits[3]['spans']}, "
                                 "not none / one of 3 (epochs 1-3)")
        log("  no op inside the span waited for the device (set_sync_debug_mode('error'))")
        for name in wrappers:
            if not fits[1]["launches"][name] or fits[1]["launches"][name] != fits[3]["launches"][name]:
                raise AssertionError(f"{what}: {name} launched {fits[1]['launches'][name]} / "
                                     f"{fits[3]['launches'][name]} times")
        losses = [r["train_loss"] for r in one.history]
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[1]:
            raise AssertionError(f"{what}: loss not finite and falling: {losses}")
        rows_differ = [r1["epoch"] for r1, r3 in zip(one.history, three.history)
                       if {k: v for k, v in r1.items() if k not in TIMING_KEYS}
                       != {k: v for k, v in r3.items() if k not in TIMING_KEYS}]
        differ = same_state(one.params, three.params) + same_state(one.best_params,
                                                                   three.best_params)
        if exp.train.save_params and not same_checkpoint(one.run_dir, three.run_dir, exp.model):
            differ.append("the best checkpoint")
        verdict = ("bitwise equal" if not rows_differ and not differ
                   else f"DIFFER: history rows {rows_differ}, state {differ}")
        log(f"  span 3 against span 1: history, final and best params"
            f"{', best checkpoint' if exp.train.save_params else ''} {verdict}")
        if rows_differ or differ or len(one.history) != 6 or len(three.history) != 6:
            raise AssertionError(f"{what}: the span-3 fit differs from the span-1 fit")
        single, spanned, snap = profile_single_and_span(exp, route_data, dev, 3)
        log(f"  profiled: one epoch {single['wall_ms']:.1f} ms wall, {single['busy_ms']:.1f} busy, "
            f"idle {single['idle_share']:.2%}; a span of 3 {spanned['wall_ms']:.1f} ms wall "
            f"({spanned['wall_ms'] / 3:.1f} an epoch), {spanned['busy_ms']:.1f} busy, "
            f"idle {spanned['idle_share']:.2%}")
        log(f"  best-epoch snapshot ({snap['mb']:.1f} MB of params, buffers and Adam state): "
            f"{snap['ms']:.3f} ms an update (CUDA events), {snap['host_ms']:.3f} ms to enqueue")
        out[what] = dict(
            epoch_s={s: [r["seconds"] for r in f["res"].history] for s, f in fits.items()},
            fit_s={s: f["fit_s"] for s, f in fits.items()},
            launches=fits[1]["launches"], history=three.history,
            profile_single={k: single[k] for k in ("wall_ms", "busy_ms", "idle_share")},
            profile_span3={k: spanned[k] for k in ("wall_ms", "busy_ms", "idle_share")},
            snapshot=snap,
            kernels_single=single["kernels"][:12], kernels_span3=spanned["kernels"][:12])
        torch.cuda.empty_cache()

    # ------------------------------ ensembles ------------------------------ #
    ids = [4061, 4051, 3961]
    exps = [experiment_from_grid_id(g, base_model=instantngp_scaled_model()) for g in ids]
    exps = [dataclasses.replace(e, train=dataclasses.replace(
        e.train, save_params=True, checkpoint_dir=os.path.join(ck_dir, "ensemble")))
        for e in exps]
    log(f"ensemble: grids {ids} at the scaled geometry, 4 epochs, span 2, checkpoints on:")
    setup_s = timed_ensemble(trainer, exps, data, dev, 0, 2)[1]
    zero_counts(dedup_kernels.values())
    torch.cuda.reset_peak_memory_stats(dev)
    ens, ens_s = timed_ensemble(trainer, exps, data, dev, 4, 2)
    ens_peak = memory.device_memory_stats(dev)["peak_gb"]
    ens_launches = {n: fn.launches for n, fn in dedup_kernels.items()}
    solos, solo_launches, solo_s = [], [], 0.0
    for e in exps:
        solo_exp = dataclasses.replace(e, train=dataclasses.replace(
            e.train, checkpoint_dir=os.path.join(ck_dir, "solo")))
        zero_counts(dedup_kernels.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solos.append(fit_with_checkpoints(solo_exp, data, epochs=4, device=dev, verbose=False,
                                          run_name="solo"))
        torch.cuda.synchronize()
        solo_s += time.perf_counter() - t0
        solo_launches.append({n: fn.launches for n, fn in dedup_kernels.items()})
    for g, r, s in zip(ids, ens, solos):
        same = (r.best_psnr == s.best_psnr and r.final_loss == s.final_loss
                and r.epochs_run == s.epochs_run and np.array_equal(r.final_image, s.final_image)
                and same_checkpoint(r.run_dir, s.run_dir, exps[0].model))
        log(f"  grid {g}: best PSNR {r.best_psnr:.6f} (solo {s.best_psnr:.6f}), final loss "
            f"{r.final_loss:.7f} (solo {s.final_loss:.7f}), {r.epochs_run} epochs; final image "
            f"and checkpoint {'bitwise equal to the solo fit' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"ensemble member {g} differs from its solo fit")
    want = {n: sum(sl[n] for sl in solo_launches) for n in dedup_kernels}
    log(f"  launches: ensemble {ens_launches}, solo fits {solo_launches}")
    if ens_launches != want or any(sl != solo_launches[0] for sl in solo_launches) or not all(
            ens_launches.values()):
        raise AssertionError("the ensemble's launches are not 3x one solo fit's")
    solo_epoch_s = [row["seconds"] for r in solos for row in r.history]
    ens_epoch = (ens_s - setup_s) / 12
    log(f"  {ens_s:.3f} s the ensemble, {setup_s:.3f} s of it set-up (a 0-epoch call): "
        f"{ens_epoch:.4f} s a member-epoch; the solo fits' epochs {np.median(solo_epoch_s):.4f} s "
        f"median ({min(solo_epoch_s):.4f}-{max(solo_epoch_s):.4f}), {solo_s:.3f} s the three "
        f"fits; peak device memory {ens_peak:.2f} GB")
    shutil.rmtree(ck_dir)

    vids = [4061, 4051, 3961, 4056]
    vexps = [experiment_from_grid_id(g, base_model=ModelConfig(use_hash_function=True))
             for g in vids]
    vexps = [dataclasses.replace(e, train=dataclasses.replace(e.train, save_params=False))
             for e in vexps]
    log(f"ensemble: the vanilla hash at the default geometry, grids {vids}, 10 epochs, span 5:")
    vsetup_s = timed_ensemble(trainer, vexps, data, dev, 0, 5)[1]
    torch.cuda.reset_peak_memory_stats(dev)
    vens, vens_s = timed_ensemble(trainer, vexps, data, dev, 10, 5)
    vens_peak = memory.device_memory_stats(dev)["peak_gb"]
    vsolo_s, vsolo_epoch_s = 0.0, []
    for e, r in zip(vexps, vens):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = fit_with_checkpoints(e, data, epochs=10, device=dev, verbose=False)
        torch.cuda.synchronize()
        vsolo_s += time.perf_counter() - t0
        vsolo_epoch_s += [row["seconds"] for row in s.history]
        if r.final_loss != s.final_loss or r.epochs_run != s.epochs_run:
            raise AssertionError(f"vanilla ensemble member {e.grid_id} differs from its solo fit")
    vens_epoch = (vens_s - vsetup_s) / 40
    log(f"  final losses equal the solo fits'; {vens_s:.3f} s the ensemble, {vsetup_s:.3f} s of it "
        f"set-up: {vens_epoch:.4f} s a member-epoch; the solo fits' epochs "
        f"{np.median(vsolo_epoch_s):.4f} s median ({min(vsolo_epoch_s):.4f}-"
        f"{max(vsolo_epoch_s):.4f}), {vsolo_s:.3f} s the four fits; peak device memory "
        f"{vens_peak:.2f} GB")
    out["ensemble_scaled"] = dict(ids=ids, seconds=ens_s, setup_s=setup_s,
                                  member_epoch_s=ens_epoch, solo_seconds=solo_s,
                                  solo_epoch_s=solo_epoch_s, launches=ens_launches,
                                  solo_launches=solo_launches, peak_gb=ens_peak)
    out["ensemble_vanilla"] = dict(ids=vids, seconds=vens_s, setup_s=vsetup_s,
                                   member_epoch_s=vens_epoch, solo_seconds=vsolo_s,
                                   solo_epoch_s=vsolo_epoch_s, peak_gb=vens_peak)
    return out


# step 20: (case, model, data set, backend, world, model axis, kernels every
# rank must launch); "scaled" instantngp_scaled_model(), "per_row" the
# default geometry with batchnorm_input (hpd_backend "auto"), "vanilla" the
# vanilla hash at the default geometry
PARALLEL_CASES = (
    ("nccl, world 1, DP", "scaled", "nccl", 1, 1,
     ("hpd_stream_fused_fwd", "hpd_stream_fused_bwd", "hidden_stack_fwd", "hidden_stack_bwd",
      "scatter_add_serial")),
    ("gloo, (data 2, model 1)", "scaled", "gloo", 2, 1,
     ("hpd_stream_fused_fwd", "hpd_stream_fused_bwd", "hidden_stack_fwd", "hidden_stack_bwd",
      "scatter_add_serial")),
    ("gloo, (data 1, model 2)", "scaled", "gloo", 2, 2,
     ("hpd_stream_fused_fwd", "hpd_stream_fused_bwd", "hidden_stack_fwd", "hidden_stack_bwd",
      "scatter_add_serial", "scatter_add_serial[range]")),
    ("gloo, (data 2, model 1), per-row BatchNorm", "per_row", "gloo", 2, 1,
     ("hpd_full_fwd", "hpd_full_bwd", "scatter_add_serial")),
    ("gloo, (data 2, model 2), vanilla", "vanilla", "gloo", 4, 2,
     ("scatter_add_serial", "scatter_add_serial[range]")),
)
PARALLEL_EPOCHS = 3
# single-process runs from the start nudged one ulp (check_parallel's witness)
PARALLEL_NUDGES = 8
RANK_TIMEOUT_S = 420


def profile_collectives(run_epoch, dev: torch.device) -> dict:
    """One epoch under torch.profiler: the host ms of the collectives'
    calls, the device ms of NCCL's kernels and of the copies (gloo stages a
    CUDA tensor through host memory), beside the epoch's wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run_epoch()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    keys = ("all_reduce", "allreduce", "all_gather", "allgather", "broadcast")
    host_ms_ = nccl_ms = copy_ms = busy_ms = 0.0
    for e in prof.events():
        name = e.name.lower()
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            ms = e.device_time_total / 1e3
            busy_ms += ms
            if "nccl" in name:
                nccl_ms += ms
            elif "memcpy" in name:
                copy_ms += ms
        elif any(k in name for k in keys) and ("gloo" in name or "nccl" in name or "c10d" in name):
            host_ms_ += e.cpu_time_total / 1e3
    return dict(wall_ms=wall_ms, collective_host_ms=host_ms_, nccl_device_ms=nccl_ms,
                copy_device_ms=copy_ms, busy_device_ms=busy_ms)


def flat_gather_keys(indices, t, shard):
    """The ids that ``models/encoding.py: flat_gather`` gives K12 for (P, L,
    ...) slot ids on T slots a level: id + level * T on the (L * T, F) view;
    under a ``TableShard`` slot * L + level on the slot-major view, over
    the shard's range times L. Returns (ids, slots, slot range or None)."""
    l = indices.shape[1]
    level = torch.arange(l, device=indices.device).view(1, l, *([1] * (indices.dim() - 2)))
    if shard is None:
        return (indices.long() + level * t).reshape(-1), l * t, None
    return (indices.long() * l + level).reshape(-1), t * l, (shard.lo * l, shard.hi * l)


def k12_check(what, ids, t, c, rng, gen, timed=False) -> dict:
    """K12 on ``ids`` (T = ``t``; over the slot range ``rng``, or every slot)
    with random rows of ``c`` columns against its plain version, bitwise;
    over a range also against rows lo..hi of the whole plain scatter.
    ``timed``: the kernel and the plain version timed on these inputs."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import scatter
    from collision_handling_in_instantngp_tpu_torch.utils.profiling import time_ms

    rows = torch.randn(ids.shape[0], c, device=ids.device, generator=gen)
    got = scatter.scatter_add_serial(rows, ids, t, ids_checked=True, slot_range=rng)
    plain = scatter.scatter_add_serial_plain(rows, ids, t, slot_range=rng)
    same = torch.equal(got, plain)
    if rng is not None:
        same = same and torch.equal(plain, scatter.scatter_add_serial_plain(rows, ids, t)[rng[0]:rng[1]])
    lo, hi = (0, t) if rng is None else rng
    out = dict(what=what, rows=int(ids.shape[0]), columns=c, slots=t,
               slot_range=None if rng is None else list(rng),
               rows_in_range=int(((ids >= lo) & (ids < hi)).sum()), bitwise=bool(same),
               max_abs_err=float((got - plain).abs().max()) if got.numel() else 0.0)
    if not same:
        raise AssertionError(f"K12 on {what} ({out}) differs from its plain version")
    if timed:
        dev = ids.device
        out["ms"] = time_ms(lambda: scatter.scatter_add_serial(
            rows, ids, t, ids_checked=True, slot_range=rng), 5, dev)
        out["plain_ms"] = time_ms(lambda: scatter.scatter_add_serial_plain(
            rows, ids, t, slot_range=rng), 1, dev)
    return out


def check_top_k(what, idx_k, idx_p, dim) -> None:
    same = (idx_k == idx_p).all(dim=dim).double().mean().item()
    if same != 1.0:
        raise AssertionError(f"{what}: top-K indices differ from the plain version on "
                             f"{1.0 - same:.3e} of the rows")


def parallel_rank_hook(state, needs) -> dict:
    """Step 20's hook on every rank (``train_epochs(hook=...)``: after the
    launch counts are read, so its launches count nowhere). Every kernel of
    ``needs`` on this rank's batch-0 inputs, at the shapes the parallel
    path gives it (the rank's rows and their dedup geometry, its shard of
    the tables), against its plain version: the top-K identical, values
    normwise FWD_TOL, gradients GRAD_TOL, K12 bitwise (with the rank's
    slot range under a shard, and then also rows lo..hi of the whole); K3a
    and K3b against the float64 algebra with the kernel's ReLU masks
    (``hidden_stack_phase(exact=True)``, which also logs the ReLU
    decisions in which the fp32 plain version differs).
    The BatchNorm ahead of K10 normalizes by the rank's own rows here. Then
    one more epoch under the profiler. Returns {"errors": {kernel: max
    abs error}, "k12": [the K12 checks], "profile": ...}."""
    from collision_handling_in_instantngp_tpu_torch.config import TopkScatterMode
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops import dedup
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import hidden, hpd_full, hpd_stream
    from collision_handling_in_instantngp_tpu_torch.ops.grid import scale_to_grid
    from collision_handling_in_instantngp_tpu_torch.ops.hashing import fast_hash
    from collision_handling_in_instantngp_tpu_torch.ops.precision import kernel_precision

    mcfg, dev, params = state.exp.model, state.device, state.params
    tag = f"rank {state.mesh.rank}"
    gen = torch.Generator(device=dev).manual_seed(SEED + state.mesh.rank)
    k, L, T, F = mcfg.topk_k, mcfg.num_levels, mcfg.hash_table_size, mcfg.feature_dim
    consts = gngf.device_statics(state.statics, dev)
    layers = [] if params.hpd is None else [(w.detach(), b.detach()) for w, b in params.hpd.layers()]
    errs, k12 = {}, []
    with torch.no_grad():
        if "hidden_stack_fwd" in needs:     # the dedup route's streamed tail
            prec = kernel_precision(mcfg.matmul_precision)
            geom = state.batches.dedup[0]
            x = (consts.unique_coords if geom.active is None
                 else dedup.active_coords(geom.active, dedup.grid_side(mcfg.n_max)))
            hl, (w_head, b_head) = layers[:-1], layers[-1]
            u = x.shape[0]
            # trained weights put pre-activations within rounding of zero,
            # where the fp32 plain stack's ReLU decisions differ from the
            # kernel's: held, as step 13 holds the wide stack, to the
            # float64 algebra with the kernel's own ReLU masks
            k3 = hidden_stack_phase(hidden, x, hl, gen, f" [{tag}, U_c {u}]", exact=True)
            for name, e in k3.items():
                errs[name.split(" ")[0]] = e["max_abs_err"]
            h = hidden.hidden_stack_fwd(x, hl, prec)
            counts = geom.counts
            out_k = hpd_stream.hpd_stream_fused_fwd(h, w_head, b_head, counts, k, prec)
            out_p = hpd_stream.hpd_stream_fused_fwd_plain(h, w_head, b_head, counts, k, prec)
            check_top_k(f"{tag} K1", out_k[2], out_p[2], 1)
            errs["hpd_stream_fused_fwd"] = max(
                compare(f"{tag} K1 {n}", out_k[i], out_p[i], FWD_TOL)
                for i, n in ((0, "marg"), (1, "vals"), (3, "m"), (4, "s")))
            del out_p
            _, vals, idx, m, s_ = out_k
            args = (h, w_head, b_head, counts, idx, vals, m, s_,
                    torch.randn(L, T, device=dev, generator=gen),
                    torch.randn(u, k, device=dev, generator=gen), k)
            noop = mcfg.topk_scatter is TopkScatterMode.NOOP
            got = hpd_stream.hpd_stream_fused_bwd(*args, precision=prec, noop_topk=noop)
            want = hpd_stream.hpd_stream_fused_bwd_plain(*args, prec, noop)
            errs["hpd_stream_fused_bwd"] = max(compare(f"{tag} K2 {n}", a, r, GRAD_TOL)
                                               for n, a, r in zip(("dh", "dw", "db"), got, want))
            del got, want
            # the blend's table gradient (U_c * K rows of L * F, over the
            # rank's slots under a shard) and gather_rows' (every (pixel,
            # level, corner) row of F on L * U_c slots)
            shard = params.shard
            k12.append(k12_check("blend", idx.reshape(-1).long(), T, L * F,
                                 None if shard is None else (shard.lo, shard.hi), gen,
                                 timed=shard is not None))
            k12.append(k12_check("gather_rows", *flat_gather_keys(geom.ids, u, None)[:2], F,
                                 None, gen))
        elif "hpd_full_fwd" in needs:       # the per-row route's whole network
            x = state.batches.x[0]
            if mcfg.batchnorm_input:
                bn = params.batchnorm
                x, _ = gngf.batchnorm(bn, {"mean": bn.mean, "var": bn.var}, x, True)
            _, corners = scale_to_grid(x, consts.n_ls, consts.offsets)
            p_b, _, v, d = corners.shape
            verts = corners.permute(1, 0, 2, 3).reshape(L, p_b * v, d).contiguous()
            out_k = hpd_full.hpd_full_fwd(verts, layers, k)
            out_p = hpd_full.hpd_full_fwd_plain(verts, layers, k)
            check_top_k(f"{tag} K10", out_k[2], out_p[2], 2)
            errs["hpd_full_fwd"] = max(compare(f"{tag} K10 {n}", out_k[i], out_p[i], FWD_TOL)
                                       for i, n in ((0, "marg"), (1, "vals")))
            bargs = (verts, layers, out_k[2], torch.randn(L, T, device=dev, generator=gen),
                     torch.randn(L, p_b * v, k, device=dev, generator=gen), k)
            got, want = hpd_full.hpd_full_bwd(*bargs), hpd_full.hpd_full_bwd_plain(*bargs)
            errs["hpd_full_bwd"] = max(
                compare(f"{tag} K11 {n}{i}", a, r, GRAD_TOL)
                for i, (ka, pa) in enumerate(zip(got, want)) for n, a, r in zip(("dW", "db"), ka, pa))
            indices = out_k[2].reshape(L, p_b, v, k).permute(1, 0, 2, 3)
            ids, slots, rng = flat_gather_keys(indices, T, params.shard)
            k12.append(k12_check("lookup_topk_blend", ids, slots, F, rng, gen))
        else:                               # the vanilla hash's lookup
            _, corners = scale_to_grid(state.batches.x[0], consts.n_ls, consts.offsets)
            ids, slots, rng = flat_gather_keys(fast_hash(corners, T), T, params.shard)
            k12.append(k12_check("lookup_vanilla", ids, slots, F, rng, gen))
    errs["scatter_add_serial"] = max(c["max_abs_err"] for c in k12)
    missing = [n for n in needs if n not in errs and not n.startswith("scatter_add_serial")]
    if missing:
        raise AssertionError(f"{tag}: no check for {missing}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(errors=errs, k12=k12, k3=k3 if "hidden_stack_fwd" in needs else None,
                profile=profile_collectives(lambda: state.next_epoch().to_host(), dev))


def held_to(r, ref, bitwise, bn) -> dict:
    """One rank's run against one single-process run: losses rtol 2e-5,
    every parameter leaf (tables gathered) rtol 2e-4 / atol 1e-7 (JAX's own
    bounds, tests/test_parallel.py), collisions equal, the BatchNorm
    statistics rtol 1e-6; ``bitwise``: losses and params 1e-6. Returns
    {"missed": [the bounds missed, "params" among them where a parameter
    element is past its bound], "use" (the largest share of its bound a
    parameter element takes), "loss_rel_diff", "bitwise"}."""
    rtol, (prtol, patol) = (1e-6, (1e-6, 0.0)) if bitwise else (2e-5, (2e-4, 1e-7))
    losses = np.asarray([h["loss"] for h in r["history"]])
    ref_losses = np.asarray([h["loss"] for h in ref["history"]])
    leaves, ref_leaves = tree_leaves(r["params"]), tree_leaves(ref["params"])
    use = 0.0
    for a, b in zip(leaves, ref_leaves):
        if a.size:
            use = max(use, float(np.max(np.abs(a - b) / np.maximum(patol + prtol * np.abs(b), 1e-30))))
    missed = []
    if not np.all(np.abs(losses - ref_losses) <= rtol * np.abs(ref_losses)):
        missed.append(f"losses {losses.tolist()} against {ref_losses.tolist()} (rtol {rtol})")
    if not use <= 1.0:
        missed.append("params")
    if [h["collisions"] for h in r["history"]] != [h["collisions"] for h in ref["history"]]:
        missed.append(f"collisions {[h['collisions'] for h in r['history']]} against "
                      f"{[h['collisions'] for h in ref['history']]}")
    if bn and not all(np.allclose(r["bn_state"][k], ref["bn_state"][k], rtol=1e-6, atol=0.0)
                      for k in ("mean", "var")):
        missed.append("BatchNorm statistics past rtol 1e-6")
    return dict(missed=missed, use=use,
                loss_rel_diff=float(np.max(np.abs(losses - ref_losses) / np.abs(ref_losses))),
                bitwise=bool(np.array_equal(losses, ref_losses)
                             and all(np.array_equal(a, b) for a, b in zip(leaves, ref_leaves))))


def envelope_use(r, runs) -> float:
    """The largest share of JAX's parameter bound (rtol 2e-4, atol 1e-7)
    by which an element of ``r``'s parameters lies outside the range its
    element spans over the single-process ``runs``."""
    use = 0.0
    for a, *bs in zip(tree_leaves(r["params"]), *(tree_leaves(n["params"]) for n in runs)):
        if a.size:
            lo, hi = np.minimum.reduce(bs), np.maximum.reduce(bs)
            near = np.clip(a, lo, hi)
            use = max(use, float(np.max(np.abs(a - near) / (1e-7 + 2e-4 * np.abs(near)))))
    return use


def check_parallel(what, results, ref, bitwise, needs, bn, nudged=None) -> dict:
    """Every rank of a parallel run held to the single-process run ``ref``
    (:func:`held_to`), every kernel of ``needs`` launched on every rank;
    ``bitwise``: to 1e-6, and logged where not bit for bit.
    Where a rank's parameters alone miss JAX's bound and ``nudged`` is
    given, ``nudged()`` gives the single-process runs from the same start
    with every parameter moved one ulp (:func:`nudged_params`); each one's
    largest share of the bound against ``ref`` is the witness. If a witness
    is past the bound, the bound is finer than the single process's own
    rounding (Adam at eps 1e-15 and the top-K's near ties carry a one-ulp
    difference past it within 3 epochs): then every parameter element of
    the rank must lie within JAX's bound of the range its element spans
    over ``ref`` and the nudged runs (:func:`envelope_use`); else it fails.
    Losses, collisions and BatchNorm statistics are held to ``ref`` in
    every case. Returns the verdict, with each rank's use of the bound
    against ``ref`` and, where the witness came in, against the range."""
    out = dict(bitwise=True, param_tolerance_used=[], envelope_used=[], loss_rel_diff=[])
    for r in results:
        v = held_to(r, ref, bitwise, bn)
        out["bitwise"] &= v["bitwise"]
        env = None
        if v["missed"] == ["params"] and not bitwise and nudged is not None:
            runs = nudged()
            witness = out["witness_use"] = [held_to(n, ref, False, bn)["use"] for n in runs]
            log(f"  {what}: rank {r['rank']}'s params take {v['use']:.3f} of JAX's bound against "
                f"the single process; the single process one ulp from its start takes "
                f"{[round(w, 3) for w in witness]} of it")
            if max(witness) > 1.0:
                env = envelope_use(r, [ref, *runs])
                log(f"    against the range of the {len(runs) + 1} single-process runs: "
                    f"{env:.3f} of the bound")
        if [m for m in v["missed"] if m != "params"] or not (v["use"] <= 1.0 or
                                                             (env is not None and env <= 1.0)):
            why = [m if m != "params" else f"params take {v['use']:.3f} of JAX's bound"
                   + ("" if env is None else f", {env:.3f} against the single-process runs' range")
                   for m in v["missed"]]
            raise AssertionError(f"{what}: rank {r['rank']}: {'; '.join(why)}")
        missing = [k for k in needs if r["launches"][k] == 0]
        if missing:
            raise AssertionError(f"{what}: rank {r['rank']} launched no {missing}")
        out["param_tolerance_used"].append(v["use"])
        out["envelope_used"].append(env)
        out["loss_rel_diff"].append(v["loss_rel_diff"])
    if bitwise and not out["bitwise"]:
        log(f"  {what}: NOT bitwise the single-process run (held to 1e-6)")
    return out


def nudged_params(exp, seed: int, dev):
    """``init_params`` for ``exp`` with every parameter element moved one
    ulp, up or down by a draw from ``seed``: a start that no bound of step
    20 can tell from ``init_params``'s."""
    from collision_handling_in_instantngp_tpu_torch.models import gngf

    params = gngf.init_params(exp.model, exp.train.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in params.parameters():
            up = torch.rand(p.shape, device=dev, generator=gen) < 0.5
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf)))
    return params


def parallel_phase(data, data_raw, dev) -> tuple:
    """Step 20: data parallelism over pixels, tables sharded by slot, on
    this one card. Every kernel is built first, in this process, so that no
    rank runs nvcc. Each case starts its ranks with the ``spawn`` start
    method on cuda:0 (``parallel.launch.spawn``: a FileStore under
    chiprun_out/step20/, a timeout per case; a rank that fails, hangs or
    launches nothing fails the run), each rank training 3 epochs of grid
    4061 on the strawberry with ``fit``'s batches and seeds
    (``parallel.train_parallel.rank_worker``), then holding each kernel of
    its case against its plain version on its batch-0 inputs and
    profiling one more epoch (:func:`parallel_rank_hook`); the parent holds
    each rank against the single-process run on the same card
    (``train_epochs`` without a mesh: ``fit``'s epochs). NCCL takes the
    world of one (one card a rank); two to four ranks share the card over
    gloo, which stages CUDA tensors through host memory, so its times are
    no forecast of NCCL across cards. Returns (the kernels line's entry for
    K12 with a slot range, the step's numbers)."""
    import functools
    import shutil

    from collision_handling_in_instantngp_tpu_torch.config import (
        ModelConfig, experiment_from_grid_id, instantngp_scaled_model,
    )
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import build
    from collision_handling_in_instantngp_tpu_torch.parallel import launch, train_parallel

    build.build_all()
    root = os.path.join(OUT_DIR, "step20")
    exps = {
        "scaled": (experiment_from_grid_id(4061, base_model=instantngp_scaled_model()), data),
        "per_row": (experiment_from_grid_id(4061, base_model=ModelConfig(batchnorm_input=True)),
                    data_raw),
        "vanilla": (experiment_from_grid_id(4061, base_model=ModelConfig(use_hash_function=True)),
                    data),
    }
    refs = {}
    for key, (exp, d) in exps.items():
        refs[key] = train_parallel.train_epochs(exp, d, PARALLEL_EPOCHS, device=dev)
        log(f"step 20: single-process {key}: epochs "
            f"{[round(h['seconds'], 4) for h in refs[key]['history']]} s, losses "
            f"{[h['loss'] for h in refs[key]['history']]}")
    nudged = {}

    def nudged_runs(key):
        if key not in nudged:
            exp, d = exps[key]
            t0 = time.perf_counter()
            nudged[key] = [train_parallel.train_epochs(exp, d, PARALLEL_EPOCHS,
                                                       params=nudged_params(exp, SEED + j, dev),
                                                       device=dev)
                           for j in range(PARALLEL_NUDGES)]
            log(f"  {PARALLEL_NUDGES} single-process {key} runs, each parameter one ulp from "
                f"the start: {time.perf_counter() - t0:.1f} s")
        return nudged[key]

    out, range_check = {}, None
    for what, key, backend, world, mp, needs in PARALLEL_CASES:
        exp, d = exps[key]
        log(f"step 20: {what}: {world} rank(s) on {dev}, {exp.model.hash_table_size} slots, "
            f"{PARALLEL_EPOCHS} epochs:")
        spec = dict(exp=exp, data=d, epochs=PARALLEL_EPOCHS, model_parallel=mp,
                    shard_tables=mp > 1, device=str(dev),
                    hook=functools.partial(parallel_rank_hook, needs=needs))
        store = os.path.join(root, f"case{len(out)}")
        t0 = time.perf_counter()
        results = launch.spawn(train_parallel.rank_worker, world, (spec,), store_dir=store,
                               backend=backend, device=str(dev), timeout=RANK_TIMEOUT_S)
        wall = time.perf_counter() - t0
        shutil.rmtree(store, ignore_errors=True)
        if any(r["backend"] != backend for r in results):
            raise AssertionError(f"{what}: a rank ran {[r['backend'] for r in results]}")
        verdict = check_parallel(what, results, refs[key], backend == "nccl", needs,
                                 key == "per_row", functools.partial(nudged_runs, key))
        ref_s = [h["seconds"] for h in refs[key]["history"]]
        r0 = results[0]
        ep_s = [[h["seconds"] for h in r["history"]] for r in results]
        steps = int(np.ceil(1.0 / exp.train.batch_fraction))
        case = dict(
            model=key, backend=backend, world=world, mesh=r0["mesh"], wall_s=wall,
            epoch_s=ep_s, single_epoch_s=ref_s,
            epoch_s_median=float(np.median([s for e in ep_s for s in e[1:]])),
            single_epoch_s_median=float(np.median(ref_s[1:])),
            collective_calls_per_epoch=r0["history"][-1]["collective_calls"],
            collective_bytes_per_step=r0["history"][-1]["collective_bytes"] / steps,
            collective_host_s_per_epoch=[h["collective_host_s"] for h in r0["history"]],
            grad_floats_per_step=r0["grad_floats"], grad_bytes_per_step=4 * r0["grad_floats"],
            profile=[r["hook"]["profile"] for r in results],
            kernel_errors=[r["hook"]["errors"] for r in results],
            k12_checks=[r["hook"]["k12"] for r in results],
            launches=[r["launches"] for r in results], **verdict)
        log(f"  epoch s by rank {[[round(s, 4) for s in e] for e in ep_s]} (median of epochs 1-2 "
            f"{case['epoch_s_median']:.4f}) vs single-process {[round(s, 4) for s in ref_s]} "
            f"({case['single_epoch_s_median']:.4f}); bitwise {verdict['bitwise']}, params use "
            f"{max(verdict['param_tolerance_used']):.3f} of JAX's bound (against the "
            f"single-process runs' range: {verdict['envelope_used']}), losses differ by "
            f"{max(verdict['loss_rel_diff']):.3e} (relative)")
        log(f"  collectives: {case['collective_calls_per_epoch']} calls an epoch, "
            f"{case['collective_bytes_per_step'] / 1e6:.3f} MB a step on rank 0 "
            f"(gradients {case['grad_bytes_per_step'] / 1e6:.3f} MB = {r0['grad_floats']} floats), "
            f"host s in them {[round(s, 4) for s in case['collective_host_s_per_epoch']]}; "
            f"U_c by batch: single process {refs[key]['vertices']}, ranks "
            f"{[r['vertices'] for r in results]}")
        for r, prof in zip(results, case["profile"]):
            log(f"  rank {r['rank']} profiled epoch: wall {prof['wall_ms']:.1f} ms, collectives' "
                f"host {prof['collective_host_ms']:.1f} ms, NCCL kernels {prof['nccl_device_ms']:.3f} "
                f"ms, copies {prof['copy_device_ms']:.3f} ms, device busy {prof['busy_device_ms']:.1f} ms")
        log(f"  launches by rank: " + "; ".join(
            ", ".join(f"{k} {r['launches'][k]}" for k in needs) for r in results))
        for r in results:
            log(f"  rank {r['rank']} against the plain versions on its batch 0, max_abs_err: "
                + ", ".join(f"{n} {e:.3e}" for n, e in r["hook"]["errors"].items()))
            for c in r["hook"]["k12"]:
                rng = "every slot" if c["slot_range"] is None else f"slot range {c['slot_range']}"
                timed = ("" if "ms" not in c else
                         f"; kernel {c['ms']:.3f} ms, plain {c['plain_ms']:.3f} ms")
                log(f"    K12 on {c['what']}: {c['rows_in_range']} of {c['rows']} rows x "
                    f"{c['columns']} on {c['slots']} slots, {rng}, bitwise the plain version"
                    f"{timed}")
        if key == "scaled" and mp > 1:
            range_check = ([c for r in results for c in r["hook"]["k12"] if "ms" in c],
                           r0["launches"]["scatter_add_serial[range]"])
        out[what] = case
    shutil.rmtree(root, ignore_errors=True)
    log("step 20: gloo carried all_reduce, all_gather and broadcast of CUDA tensors; NCCL the "
        "world of one")
    checks, n = range_check
    c = max(checks, key=lambda c: c["ms"])
    # the rows in range read and added, every id read, the range's slots written
    work = kernel_work("K12", n=c["rows_in_range"], c=c["columns"],
                       t=c["slot_range"][1] - c["slot_range"][0], ids=c["rows"])
    entry = kernel_entry("scatter_add_serial[range]", SRC + "scatter.cu",
                         JAX_SRC + "scatter_probe.py:42", max(x["max_abs_err"] for x in checks),
                         c["ms"], c["plain_ms"], work)
    entry.update(route="cuda", launches=n)
    return entry, out


# every instance of these kernels must hold warpgroup MMAs (HGMMA): the
# tensor-core passes of the dedup route's tail, forward and backward, and
# K7, each with a one-chunk instance (last template argument CH = 0, heads
# up to 128) and a chunked one (CH = 1, past 128) at every precision; the
# fix-up of the rows pass is the exact fp32 sweep and must hold none
TENSOR_CORE_KERNELS = ("hpd_fwd_rows_kernel", "hpd_fwd_cols_kernel", "hpd_probe_kernel",
                       "hpd_bwd_rows_kernel", "hpd_bwd_cols_kernel", "hpd_b1_kernel",
                       "hpd_b2_rows_kernel")
FP32_KERNELS = ("hpd_fix_rows_kernel",)
# K3a / K3b take every product as mma.sync (HMMA) at every precision, row
# tile and (K3b's backward kernel) weight staging; so does K3b's dW kernel
HIDDEN_KERNELS = {"hidden_fwd_kernel": [(rt,) for rt in (16, 32, 64)],
                  "hidden_bwd_kernel": [(rt, ws) for rt in (16, 32, 64) for ws in (0, 1)],
                  "hidden_dw_kernel": [()]}
# K9, K10 and K11 take their head's products as mma.sync (HMMA) at every
# tile size; K8 is fp32 FMA on the CUDA cores (its 3xTF32 design lost to
# it on the card) and must hold none
PER_ROW_TENSOR_CORE = {"hpd_full": ("full_fwd_kernel", "full_bwd_kernel"),
                       "hpd_tail": ("tail_bwd_kernel",)}
PER_ROW_FP32 = {"hpd_tail": ("tail_fwd_kernel",)}

def sass_counts(build, lib: str) -> dict:
    """{kernel<template args>: {"HGMMA": n, "HMMA": n}} of a built library,
    from ``cuobjdump -sass``; printed."""
    import re
    import subprocess
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build._library_path(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            # e.g. ..._116hpd_probe_kernelILi0ELb1EEEv... -> hpd_probe_kernel<0,1>
            found = re.search(r"\d+((?:hpd|full|tail|hidden)_\w+?_kernel)I((?:L[a-z]+\d+E)+)E", line)
            name = None
            if found:
                args = ",".join(re.findall(r"L[a-z]+(\d+)E", found.group(2)))
                name = f"{found.group(1)}<{args}>"
                counts.setdefault(name, {"HGMMA": 0, "HMMA": 0})
        elif name and ("HGMMA" in line or "HMMA" in line):
            counts[name]["HGMMA" if "HGMMA" in line else "HMMA"] += 1
    log(f"  SASS tensor-core instructions ({lib}.cu):")
    for k_, c in sorted(counts.items()):
        log(f"    {k_:34s} HGMMA {c['HGMMA']:4d}  HMMA {c['HMMA']:4d}")
    return counts


def tensor_core_sass(build) -> dict:
    """Tensor-core instructions per kernel instance of the built hpd_stream,
    hpd_full and hpd_tail libraries. Raises unless every instance (each
    template argument list) of TENSOR_CORE_KERNELS holds HGMMA, each of them
    has an instance at every precision (<0>, <1>, <2>), and FP32_KERNELS
    hold none; unless each of TENSOR_CORE_KERNELS has, at every precision,
    a one-chunk and a chunked instance (last argument 0 and 1); unless each
    kernel of PER_ROW_TENSOR_CORE has an instance
    at every tile size and width (<1 / 2 / 4, WIDE 0 / 1>), each holding
    HMMA, and the instances
    of PER_ROW_FP32 hold none; and unless every instance of HIDDEN_KERNELS
    (K3a's and K3b's kernels) holds HMMA."""
    counts = sass_counts(build, "hpd_stream")
    for k_ in TENSOR_CORE_KERNELS:
        for p in range(3):
            inst = [n for n in counts if n.startswith(f"{k_}<{p}")]
            for ch in (0, 1):
                if not any(n.endswith(f",{ch}>") for n in inst):
                    raise RuntimeError(f"{k_}<{p}, ..., CH={ch}>: no instance in the SASS")
            for n in inst:
                if counts[n]["HGMMA"] == 0:
                    raise RuntimeError(f"{n}: no HGMMA in the SASS")
    for n, c in counts.items():
        if n.split("<")[0] in FP32_KERNELS and c["HGMMA"] + c["HMMA"]:
            raise RuntimeError(f"{n}: tensor-core instructions in the exact fp32 sweep")
    for lib in ("hpd_full", "hpd_tail"):
        per_row = sass_counts(build, lib)
        for k_ in PER_ROW_TENSOR_CORE.get(lib, ()):
            for rpt in (1, 2, 4):
                for wide in (0, 1):
                    n = f"{k_}<{rpt},{wide}>"
                    if n not in per_row:
                        raise RuntimeError(f"{n}: no instance in the SASS")
                    if per_row[n]["HMMA"] == 0:
                        raise RuntimeError(f"{n}: no HMMA in the SASS")
        for k_ in PER_ROW_FP32.get(lib, ()):
            inst = [n for n in per_row if n.startswith(k_ + "<")]
            if not inst:
                raise RuntimeError(f"{k_}: no instance in the SASS")
            for n in inst:
                if per_row[n]["HGMMA"] + per_row[n]["HMMA"]:
                    raise RuntimeError(f"{n}: tensor-core instructions in K8's fp32 forward")
        counts.update(per_row)
    k3 = sass_counts(build, "hidden")
    for k_, args in HIDDEN_KERNELS.items():
        for p in range(3):
            for rest in args:
                n = f"{k_}<{','.join(str(a_) for a_ in (p, *rest))}>"
                if n not in k3:
                    raise RuntimeError(f"{n}: no instance in the SASS")
                if k3[n]["HMMA"] == 0:
                    raise RuntimeError(f"{n}: no HMMA in the SASS")
    counts.update(k3)
    counts.update(probe_sass(build))
    return counts


def probe_sass(build) -> dict:
    """HMMA per kernel of the built probe library (K13): raises unless every
    instance of ``rowsum_tc_kernel`` (the tensor-core regimes, 'default'
    among them) holds HMMA and ``rowsum_sgemm_kernel`` ('highest', fp32 on
    the CUDA cores) none."""
    import re
    import subprocess
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build._library_path("probe")],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            found = re.search(r"\d+(rowsum_\w+?_kernel)(I(?:L[a-z]+\d+E)+E)?", line)
            name = None
            if found:
                args = ",".join(re.findall(r"L[a-z]+(\d+)E", found.group(2) or ""))
                name = f"{found.group(1)}<{args}>"
                counts.setdefault(name, {"HMMA": 0})
        elif name and "HMMA" in line:
            counts[name]["HMMA"] += 1
    log("  SASS tensor-core instructions (probe.cu):")
    for k_, c in sorted(counts.items()):
        log(f"    {k_:34s} HMMA {c['HMMA']:4d}")
    tc = [n for n in counts if n.startswith("rowsum_tc_kernel<")]
    if len(tc) < 2 or any(counts[n]["HMMA"] == 0 for n in tc):
        raise RuntimeError(f"K13's tensor-core kernels: {tc}, each must hold HMMA")
    if counts.get("rowsum_sgemm_kernel<>", {"HMMA": 1})["HMMA"]:
        raise RuntimeError("rowsum_sgemm_kernel: missing, or tensor-core instructions in K13 'highest'")
    return counts


# the kernels each mode's epoch (step 21) and step split (step 23) launch:
# at 'gngf' the HPD and the decoder run in cuBLAS and K12 takes both table
# gradients
TOOL_PATHS = {"gngf": ("scatter_add_serial",),
              "scaled": ("hidden_stack_fwd", "hidden_stack_bwd", "hpd_stream_fused_fwd",
                         "hpd_stream_fused_bwd", "scatter_add_serial")}


def tool_wrappers() -> dict:
    """Every kernel wrapper of the dedup, split and per-row routes and K12,
    by name (steps 21-23 count their launches)."""
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import (
        hidden, hpd_full, hpd_stream, hpd_tail, scatter,
    )

    return {fn.__name__: fn for fn in (
        hidden.hidden_stack_fwd, hidden.hidden_stack_bwd, hpd_stream.hpd_stream_fused_fwd,
        hpd_stream.hpd_stream_fused_bwd, hpd_stream.hpd_stream_select, hpd_stream.hpd_stream_marginal,
        hpd_stream.hpd_tail_unique_bwd, hpd_stream.hpd_stream_fused_probe, hpd_tail.hpd_tail_fwd,
        hpd_tail.hpd_tail_bwd, hpd_full.hpd_full_fwd, hpd_full.hpd_full_bwd,
        scatter.scatter_add_serial)}


def measurement_tools_phase() -> tuple:
    """Step 21: the epoch roofline at 'gngf' and 'scaled' (nominal peaks,
    epochs timed at span 10), each run with every kernel's launch count set
    to 0 just before and read just after; fails unless each kernel of the
    mode's path (TOOL_PATHS) launched and the fraction is in (0, 1]. The
    'gngf' run keeps the inputs of its first two K12 calls (batch 0's table
    gradients, ``gather_rows``' then the blend's, taken from
    ``models/encoding.py``'s wrapper), on which K12 is then held bitwise
    against its plain version and timed (``scatter_phase``). Then the kernel
    timer at the JAX tool's shapes, which holds each kernel against its
    plain version before timing it. Returns (kernel entries, results)."""
    from collision_handling_in_instantngp_tpu_torch.models import encoding
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import scatter
    from collision_handling_in_instantngp_tpu_torch.tools import roofline, time_kernels

    wrappers = tool_wrappers()
    original, captured = encoding.scatter_add_serial, []

    def recording(rows, ids, t, **kw):
        captured.append((rows.clone(), ids.clone(), t))
        if len(captured) == 2:
            encoding.scatter_add_serial = original
        return original(rows, ids, t, **kw)

    out, entries = {}, {}
    for mode in ("gngf", "scaled"):
        log(f"step 21: roofline --mode {mode} --measure --span 10 --epochs 30:")
        zero_counts(wrappers.values())
        if mode == "gngf":
            encoding.scatter_add_serial = recording
        try:
            r = roofline.main(["--mode", mode, "--measure", "--span", "10", "--epochs", "30"])
        finally:
            encoding.scatter_add_serial = original
        launches = {name: fn.launches for name, fn in wrappers.items()}
        launches.update({f"{name}[{v}]": n for name, fn in wrappers.items()
                         for v, n in getattr(fn, "variant_launches", {}).items()})
        r["launches"] = launches
        frac = r.get("fraction_of_roofline")
        log(f"  bound {r['sol_epoch_ms']:.3f} ms an epoch ({r['sol_bound']}), measured "
            f"{r['measured_epoch_ms']:.3f} ms ({r['measured_pixels_per_s']:.0f} px/s): "
            f"fraction {frac}; launches {({n: c for n, c in launches.items() if c})}")
        missing = [name for name in TOOL_PATHS[mode] if launches[name] == 0]
        if missing:
            raise AssertionError(f"roofline {mode}: {missing} never launched in its epochs")
        if frac is None or not 0.0 < frac <= 1.0:
            raise AssertionError(f"roofline {mode}: fraction_of_roofline {frac} outside (0, 1]")
        out[mode] = r

    t_blend = roofline.experiment("gngf").model.hash_table_size
    if len(captured) != 2:
        raise AssertionError(f"roofline gngf: {len(captured)} K12 calls kept, expected 2")
    for rows, flat, t in captured:
        what = "blend" if t == t_blend else "gather_rows"
        variant = VARIANT_OF[scatter.narrow_path(rows.shape[0], rows.shape[1], t)]
        log(f"step 21: K12 scatter_add_serial [{variant}] on the gngf run's batch-0 {what} "
            "table gradient:")
        entry = scatter_phase(variant, rows, flat, t)
        name = entry["name"] = f"scatter_add_serial[gngf {what}]"
        entry.update(route="cuda", launches=out["gngf"]["launches"][f"scatter_add_serial[{variant}]"],
                     variant=variant)
        entries[name] = entry
    del captured
    log("step 21: time_kernels at the JAX tool's shapes, each kernel held against its plain version:")
    out["time_kernels"] = time_kernels.main(["--reps", "4"])
    torch.cuda.empty_cache()
    return entries, out


def split_tools_phase(dev) -> tuple:
    """Step 23: the step split by stage. ``attribution`` at 'scaled' and
    'gngf' (2 reps; its gate raises unless the last prefix is bitwise the
    real loss), every kernel's count set to 0 just before each and read
    just after (fails unless the mode's kernels launched); ``gather_probe`` (K12 bitwise at its shape, then one
    kernel entry there beside ``index_add_``); ``floor_table`` on both
    artifacts (fails unless hidden, tail and decoder each get a floor);
    ``ablate_scaled --mode scaled`` (fails unless every stage's time is
    finite and positive). Files go to a scratch directory, removed after.
    Returns (kernel entries, results)."""
    import shutil
    import tempfile

    from collision_handling_in_instantngp_tpu_torch.ops.cuda import scatter
    from collision_handling_in_instantngp_tpu_torch.tools import (
        ablate_scaled, attribution, floor_table, gather_probe,
    )

    wrappers = tool_wrappers()
    tmp = tempfile.mkdtemp(prefix="split_tools_")
    out, entries, paths = {}, {}, []
    try:
        for mode in ("scaled", "gngf"):
            log(f"step 23: attribution --mode {mode} --reps 2:")
            path = os.path.join(tmp, f"attribution_{mode}.json")
            zero_counts(wrappers.values())
            r = attribution.main(["--mode", mode, "--reps", "2", "--json-out", path])
            launches = {name: fn.launches for name, fn in wrappers.items()}
            missing = [name for name in TOOL_PATHS[mode] if launches[name] == 0]
            if missing:
                raise AssertionError(f"attribution {mode}: {missing} never launched")
            log(f"  gate held; step {r['step_ms']:.3f} ms; launches "
                f"{({n: c for n, c in launches.items() if c})}")
            out[f"attribution_{mode}"] = dict(r, launches=launches)
            paths.append(path)

        log("step 23: gather_probe --reps 2:")
        gp_path = os.path.join(tmp, "gather_probe.json")
        zero_counts([scatter.scatter_add_serial])
        out["gather_probe"] = gather_probe.main(["--reps", "2", "--json-out", gp_path])
        k12_launches = scatter.scatter_add_serial.launches
        x = gather_probe.make_inputs(gather_probe.U, gather_probe.T, gather_probe.L,
                                     gather_probe.K, gather_probe.F, dev)
        log("step 23: K12 scatter_add_serial [ring] at gather_probe's shape:")
        entry = scatter_phase("ring", x.rows, x.flat, gather_probe.T)
        entry.update(name="scatter_add_serial[gather_probe]", route="cuda", launches=k12_launches,
                     variant="ring")
        entries[entry["name"]] = entry
        del x

        log("step 23: floor_table on the two attribution artifacts:")
        ft = floor_table.main([*paths, "--gather-probe", gp_path,
                               "--sweep-probe", os.path.join(tmp, "no_sweep_probe.json")])
        for name, res in ft.items():
            if sorted(res["floors_ms"]) != ["decoder", "hidden", "tail"]:
                raise AssertionError(f"floor_table {name}: floors {sorted(res['floors_ms'])}")
        if len(ft) != 2:
            raise AssertionError(f"floor_table printed {len(ft)} of 2 tables")
        out["floor_table"] = ft

        log("step 23: ablate_scaled --mode scaled --reps 2:")
        ab = ablate_scaled.main(["--mode", "scaled", "--reps", "2"])
        if not all(math.isfinite(v) and v > 0 for v in ab["ms"].values()):
            raise AssertionError(f"ablate_scaled: stage times {ab['ms']}")
        out["ablate_scaled"] = ab
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return entries, out


class LossTap:
    """A metric logger around another: keeps each epoch's ``train_loss``
    (step 22's check that every fit's loss is finite and falls)."""

    def __init__(self, inner):
        self.inner, self.losses = inner, []
        self.stores_media = getattr(inner, "stores_media", False)

    def log(self, metrics, step=None):
        self.losses.append(float(metrics["train_loss"]))
        self.inner.log(metrics, step=step)

    def finish(self):
        self.inner.finish()


def checked_fits(trainer, run_macaws, seed_panel):
    """Wrap ``trainer.fit`` and ``trainer.fit_ensemble`` (and the names the
    study tools imported them under) so that every fit logs through a
    ``LossTap``, fails unless its loss is finite and falls, and records
    (grid id, K, epochs, host seconds). Returns (the records, a function that
    restores the originals)."""
    from collision_handling_in_instantngp_tpu_torch.utils.logging import NullLogger

    real_fit, real_ens = trainer.fit, trainer.fit_ensemble
    fits = []

    def check(exp, tap, res, seconds):
        losses = tap.losses
        # epoch 0 carries no collision term (no previous epoch)
        if len(losses) < 3 or not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[1]:
            raise AssertionError(f"grid {exp.grid_id}: loss not finite and falling: {losses}")
        fits.append(dict(grid_id=exp.grid_id, k=exp.model.topk_k, epochs=res.epochs_run,
                         seconds=seconds, loss_epoch1=losses[1], last_loss=losses[-1]))

    def fit(exp, data, **kw):
        tap = kw["logger"] = LossTap(kw.get("logger") or NullLogger())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_fit(exp, data, **kw)
        torch.cuda.synchronize()
        check(exp, tap, res, time.perf_counter() - t0)
        return res

    def fit_ensemble(exps, data, **kw):
        taps = kw["loggers"] = [LossTap(lg) for lg in (kw.get("loggers") or
                                                     [NullLogger() for _ in exps])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_ens(exps, data, **kw)
        torch.cuda.synchronize()
        for exp, tap, r in zip(exps, taps, res):
            check(exp, tap, r, (time.perf_counter() - t0) / len(exps))
        return res

    patched = [(trainer, "fit", fit), (trainer, "fit_ensemble", fit_ensemble),
               (run_macaws, "fit", fit), (seed_panel, "fit_ensemble", fit_ensemble)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    for mod, name, fn in patched:
        setattr(mod, name, fn)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return fits, restore


def study_tools_phase(dev) -> tuple:
    """Step 22: the grid study's drivers (``tools/run_grid_demo``,
    ``grid_leaderboard``, ``rerank_top``, ``seed_panel``, ``usage_stats``,
    ``run_macaws``) on the card at the default geometry (T = 2^8, L = 4,
    n = 8..32, the dense HPD on the dedup route, K12 both table gradients),
    in a scratch directory (removed). Before each tool every kernel's count
    is set to 0, and read after it: it fails unless K12 launched in each
    training tool, and prints which other kernels did. Every fit's loss must be
    finite and fall (``checked_fits``). The screening driver on 4 ids from
    4048 (K = 32, 128, 1, 4) for 20 epochs over 2 shards, one by one and
    with ``ensemble`` 2: the rows equal apart from ``run_dir``, bitwise. The
    leaderboard of the committed screening manifest: 115 winners, 34
    distinct; the rerank's pick at 20 the committed rerank's ids, then its
    first 2 winners and 4061 for 20 epochs. The seed panel of (3761, 4061)
    x (7, 42) for 20 epochs, each member's row equal to a solo ``fit``.
    ``usage_stats --flagship`` on 4061's seed-7 checkpoint; the macaws for 10
    epochs. K12 held bitwise to its plain version on the blend's table
    gradient of batch 0 of the first K = 20 id (the rerank's) and of the
    K = 32 id (the screening's), kept from those runs, and timed beside
    ``index_add_``. Returns (kernel entries, results)."""
    import gzip
    import shutil
    import tempfile

    from collision_handling_in_instantngp_tpu_torch.config import experiment_from_grid_id
    from collision_handling_in_instantngp_tpu_torch.data import load_image_dataset
    from collision_handling_in_instantngp_tpu_torch.models import encoding, gngf
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import scatter
    from collision_handling_in_instantngp_tpu_torch.tools import (
        grid_leaderboard, rerank_top, run_grid_demo, run_macaws, seed_panel, usage_stats,
    )
    from collision_handling_in_instantngp_tpu_torch.train import trainer

    wrappers = tool_wrappers()
    mcfg = experiment_from_grid_id(4061).model
    t_blend, u = mcfg.hash_table_size, gngf.make_statics(mcfg).unique_coords.shape[0]
    blend_rows = {u * k: k for k in (20, 32)}          # the blend's rows (U * K) at K = 20, 32
    original, captured = encoding.scatter_add_serial, {}

    def recording(rows, ids, t, **kw):
        k = blend_rows.get(rows.shape[0]) if t == t_blend else None
        if k is not None and k not in captured:
            captured[k] = (rows.clone(), ids.clone(), t)
        return original(rows, ids, t, **kw)

    def counted(what, call, trains=True):
        zero_counts(wrappers.values())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        launches.update({f"scatter_add_serial[{v}]": n
                         for v, n in scatter.scatter_add_serial.variant_launches.items()})
        others = {n: c for n, c in launches.items() if c and not n.startswith("scatter_add_serial")}
        log(f"  {what}: {seconds:.1f} s; K12 launched {launches['scatter_add_serial']} times "
            f"(ring {launches['scatter_add_serial[ring]']}, narrow "
            f"{launches['scatter_add_serial[narrow]']}); other kernels launched: {others or 'none'}")
        if trains and not launches["scatter_add_serial"]:
            raise AssertionError(f"{what}: K12 never launched")
        return result, dict(launches=launches, seconds=seconds)

    fits, restore = checked_fits(trainer, run_macaws, seed_panel)
    home, scratch = os.getcwd(), tempfile.mkdtemp(prefix="study_tools_")
    image = os.path.join(HERE, "images", "strawberry.npy")
    out, entries = {}, {}
    try:
        os.chdir(scratch)
        # --------------------- the screening driver ---------------------- #
        encoding.scatter_add_serial = recording
        demo = {}
        for ens in (1, 2):
            log(f"step 22: run_grid_demo 4048 4 20 2 {ens}: ids 4048-4051, 20 epochs, 2 shards, "
                f"ensemble {ens}:")
            (summary, rows), demo[ens] = counted(
                f"run_grid_demo ensemble {ens}",
                lambda: run_grid_demo.main(4048, 4, 20, 2, ens, f"e{ens}", device=dev.type,
                                           image=image))
            encoding.scatter_add_serial = original
            log(f"  configs/hour {summary['configs_per_hour_per_chip']} ({summary['gpu']}), "
                f"{summary['wall_s']} s")
            demo[ens].update(summary=summary, rows=sorted(
                ({k: v for k, v in r.items() if k != "run_dir"} for r in rows),
                key=lambda r: r["grid_id"]))
        if demo[1]["rows"] != demo[2]["rows"] or len(demo[1]["rows"]) != 4:
            raise AssertionError(f"run_grid_demo: the rows depend on the ensemble: {demo[1]['rows']} "
                                 f"against {demo[2]['rows']}")
        log("  the rows of ensemble 1 and 2 are equal apart from run_dir, bitwise: " + ", ".join(
            f"{r['grid_id']} {r['best_psnr']:.4f}" for r in demo[1]["rows"]))
        out["run_grid_demo"] = demo

        # ------------------ the leaderboard and the rerank ------------------ #
        log("step 22: grid_leaderboard on evidence/grid_demor4grid_manifest.jsonl:")
        board = grid_leaderboard.main(grid_leaderboard.DEFAULT, 5)
        if (board["better_raw"], board["better_distinct"]) != (115, 34):
            raise AssertionError(f"grid_leaderboard: {board}, not 115 / 34")
        winners, _ = rerank_top.pick_ids(grid_leaderboard.DEFAULT, 20)
        with gzip.open(os.path.join(HERE, "evidence", "rerank_full_manifest.jsonl.gz"), "rt") as f:
            committed = sorted(json.loads(line)["grid_id"] for line in f)
        if sorted(winners + [4061]) != committed:
            raise AssertionError(f"rerank_top: picked {winners}, the committed rerank ran {committed}")
        log(f"  115 / 34; rerank_top's pick at 20 equals the committed rerank's ids: {winners}")
        log(f"step 22: rerank_top, its first 2 winners {winners[:2]} and 4061, 20 epochs:")
        encoding.scatter_add_serial = recording
        rerank, out["rerank_top"] = counted(
            "rerank_top", lambda: rerank_top.main(grid_leaderboard.DEFAULT, 2, 20, 1,
                                                  device=dev.type, image=image))
        encoding.scatter_add_serial = original
        out["rerank_top"]["summary"] = rerank
        if rerank["n_rerun"] != 3:
            raise AssertionError(f"rerank_top: {rerank['n_rerun']} runs, not 3")

        # ---------------------------- the seed panel ------------------------- #
        log("step 22: seed_panel 20 --ids=3761,4061 --seeds=7,42:")
        panel, out["seed_panel"] = counted(
            "seed_panel", lambda: seed_panel.main(20, ids=(3761, 4061), seeds=(7, 42),
                                                  device=dev.type, image=image))
        data = load_image_dataset(image)
        for row in panel:
            exp = experiment_from_grid_id(row["grid_id"])
            exp = dataclasses.replace(exp, train=dataclasses.replace(
                exp.train, seed=row["seed"], save_params=False))
            solo = trainer.fit(exp, data, epochs=20, epoch_span=33, device=dev, verbose=False)
            got = (row["best_psnr"], row["final_psnr"], row["epochs_run"], row["stopped_early"])
            want = (solo.best_psnr, solo.final_psnr, solo.epochs_run, solo.stopped_early)
            log(f"  grid {row['grid_id']} seed {row['seed']}: best {got[0]:.6f} final {got[1]:.6f} "
                f"{got[2]} epochs; solo fit {'equal' if got == want else want}")
            if got != want:
                raise AssertionError(f"seed_panel member {row['grid_id']}/{row['seed']} differs from "
                                     "its solo fit")
        out["seed_panel"]["rows"] = panel

        # ------------------------ usage stats, macaws ------------------------ #
        log("step 22: usage_stats --flagship on weights/4061_panel4061s7:")
        usage, out["usage_stats"] = counted(
            "usage_stats", lambda: usage_stats.main([os.path.join("weights", "4061_panel4061s7")],
                                                    flagship=True, device=dev.type, image=image),
            trains=False)
        for lv in usage[0]["levels"]:
            if not (0 < lv["slots_used"] <= t_blend and lv["cells"] > 0
                    and math.isfinite(lv["marginal_kl_uniform_nats"])):
                raise AssertionError(f"usage_stats: level {lv}")
        out["usage_stats"]["levels"] = usage[0]["levels"]
        log("step 22: run_macaws 10:")
        out["run_macaws"] = dict(zip(("rows", "counts"), counted(
            "run_macaws", lambda: run_macaws.main(10, device=dev.type))))
    finally:
        encoding.scatter_add_serial = original
        restore()
        os.chdir(home)
        shutil.rmtree(scratch, ignore_errors=True)
    for f in fits:
        log(f"  fit of grid {f['grid_id']} (K = {f['k']}): {f['epochs']} epochs in "
            f"{f['seconds']:.2f} s ({f['seconds'] / f['epochs']:.4f} s an epoch), loss at "
            f"epoch 1 {f['loss_epoch1']:.4f}, at the last {f['last_loss']:.4f}")
    out["fits"] = fits

    sources = {20: ("the rerank's K = 20 id", out["rerank_top"]),
               32: ("the screening's K = 32 id", out["run_grid_demo"][1])}
    if sorted(captured) != [20, 32]:
        raise AssertionError(f"step 22: blend table gradients kept at K = {sorted(captured)}")
    for k, (rows, flat, t) in sorted(captured.items()):
        what, run = sources[k]
        log(f"step 22: K12 scatter_add_serial [ring] on {what} batch-0 blend table gradient:")
        entry = scatter_phase("ring", rows, flat, t)
        name = entry["name"] = f"scatter_add_serial[blend K={k}]"
        entry.update(route="cuda", launches=run["launches"]["scatter_add_serial[ring]"],
                     variant="ring")
        entries[name] = entry
    torch.cuda.empty_cache()
    return entries, out


def cell_gather_scaling_phase(dev) -> dict:
    """Step 24: ``ablate_scaled --cell-gather`` and ``scaling_bench`` (the
    module's docstring, item 24). Returns their results."""
    import tempfile

    from collision_handling_in_instantngp_tpu_torch.ops.cuda import scatter
    from collision_handling_in_instantngp_tpu_torch.tools import ablate_scaled, scaling_bench

    k12 = scatter.scatter_add_serial
    out = {}
    t_step = time.perf_counter()
    log("step 24: ablate_scaled --mode scaled --cell-gather --reps 2:")
    zero_counts([k12])
    ab = ablate_scaled.main(["--mode", "scaled", "--cell-gather", "--reps", "2"])
    launches = {f"scatter_add_serial[{v}]": n for v, n in k12.variant_launches.items()}
    if set(ab["cell_gather"]) != {"on", "off"}:
        raise AssertionError(f"ablate_scaled --cell-gather ran {sorted(ab['cell_gather'])}")
    for label, run in ab["cell_gather"].items():
        if not all(math.isfinite(v) and v > 0 for v in run["ms"].values()):
            raise AssertionError(f"ablate_scaled --cell-gather ({label}): stage times {run['ms']}")
    if not k12.launches:
        raise AssertionError("ablate_scaled --cell-gather: K12 never launched")
    log(f"  K12 launches {k12.launches} ({launches})")
    out["ablate_cell_gather"] = dict(ab, k12_launches=launches)

    log("step 24: scaling_bench --world 1 --mode gngf --epochs 2 (NCCL):")
    sb = scaling_bench.main(["--world", "1", "--mode", "gngf", "--epochs", "2"])
    if len(sb) != 1 or not (math.isfinite(sb[0]["pixels_per_s"]) and sb[0]["pixels_per_s"] > 0):
        raise AssertionError(f"scaling_bench: {sb}")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            scaling_bench.run_world(2, "gngf", 3000, 1, "cuda", tmp)
        except ValueError as e:
            log(f"  --world 2 on one card: ValueError: {e}")
        else:
            raise AssertionError("scaling_bench ran a world of 2 on one card")
    out["scaling_bench"] = sb
    out["seconds"] = time.perf_counter() - t_step
    log(f"step 24: {out['seconds']:.1f} s")
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from collision_handling_in_instantngp_tpu_torch.config import (
        ModelConfig, experiment_from_grid_id, instantngp_scaled_model,
    )
    from collision_handling_in_instantngp_tpu_torch.data import (
        image_dataset, load_image_dataset, make_shuffle_permutations,
    )
    from collision_handling_in_instantngp_tpu_torch.models import gngf
    from collision_handling_in_instantngp_tpu_torch.ops import dedup
    from collision_handling_in_instantngp_tpu_torch.ops.cuda import (
        build, hidden, hpd_full, hpd_stream, hpd_tail, scatter,
    )
    from collision_handling_in_instantngp_tpu_torch.train.train_step import build_epoch_batches
    from collision_handling_in_instantngp_tpu_torch.train.trainer import fit as fit_with_checkpoints
    from collision_handling_in_instantngp_tpu_torch.utils import profiling

    def fit(exp, data, **kw):
        """``fit`` without checkpoint files: steps 3-16 write none (the
        default config asks for them; step 17 checks them)."""
        return fit_with_checkpoints(dataclasses.replace(exp, train=dataclasses.replace(
            exp.train, save_params=False)), data, **kw)

    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = profiling.gpu_name_and_power_limit()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ------------------------------ build --------------------------------- #
    t0 = time.perf_counter()
    reports = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernel build: {build_s:.1f} s ({', '.join(build.SOURCES)})")
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in reports.items():
            f.write(f"== {name}\n{text}\n")
    sass = tensor_core_sass(build)

    # ---------------------- inputs of the training path -------------------- #
    data = load_image_dataset(os.path.join(HERE, "images", "strawberry.npy"))
    exp = experiment_from_grid_id(4061, base_model=instantngp_scaled_model())
    mcfg = exp.model
    statics = gngf.make_statics(mcfg)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp.train.seed, exp.train.shuffle_pixels)
    batches = build_epoch_batches(data.coords, data.targets, exp.train.batch_fraction,
                                  shuffled, data.image, mcfg, statics, dev)
    geom = batches.dedup[0]
    x = dedup.active_coords(geom.active, dedup.grid_side(mcfg.n_max))
    params = gngf.init_params(mcfg, SEED, dev)
    layers = [(w.detach(), b.detach()) for w, b in params.hpd.layers()]
    hidden_layers, (w_head, b_head) = layers[:-1], layers[-1]
    u_c = x.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    log(f"image {data.height}x{data.width}, {len(batches.dedup)} batches, U_c={u_c}, "
        f"H={w_head.shape[0]}, T={mcfg.hash_table_size}, L={mcfg.num_levels}, K={mcfg.topk_k}")

    entries = {}

    # --------------------------- K3a / K3b --------------------------------- #
    # against the float64 algebra with the kernels' own ReLU decisions: at
    # the init's weights some pre-activations on the vertex grid lie within
    # rounding of zero, where the fp32 plain version decides otherwise
    entries.update(hidden_stack_phase(hidden, x, hidden_layers, gen, "", exact=True))
    h_k = hidden.hidden_stack_fwd(x, hidden_layers)
    wide_layers = seeded_layers([x.shape[1], *WIDE_HIDDEN], dev)
    entries.update(hidden_stack_phase(hidden, x, wide_layers, gen, WIDE_TAG, exact=True))
    del wide_layers

    # ------------------------------ K1 / K2 -------------------------------- #
    k, L, T, H = mcfg.topk_k, mcfg.num_levels, mcfg.hash_table_size, w_head.shape[0]
    h_full = h_k.contiguous()
    counts_full = geom.counts.contiguous()

    log("K1 hpd_stream_fused_fwd, full U_c of real h:")
    out_k = hpd_stream.hpd_stream_fused_fwd(h_full, w_head, b_head, counts_full, k)
    out_p = hpd_stream.hpd_stream_fused_fwd_plain(h_full, w_head, b_head, counts_full, k, "highest")
    same_idx = (out_k[2] == out_p[2]).all(dim=1).double().mean().item()
    log(f"  idx: rows with identical top-{k}: {same_idx:.6f}")
    if same_idx != 1.0:
        raise AssertionError("K1: top-K indices differ from the plain version")
    fix = fixup_rows(hpd_stream.hpd_stream_fused_fwd, "K1")
    log(f"  largest count: {counts_full.max().item():.0f}")
    err = max(compare(n, a, r, FWD_TOL)
              for n, a, r in zip(("marg", "vals", "m", "s"),
                                 (out_k[0], out_k[1], out_k[3], out_k[4]),
                                 (out_p[0], out_p[1], out_p[3], out_p[4])))
    bitwise_same("marg/vals/idx/m/s", out_k,
                 hpd_stream.hpd_stream_fused_fwd(h_full, w_head, b_head, counts_full, k))
    del out_p
    ms = cuda_ms(lambda: hpd_stream.hpd_stream_fused_fwd(h_full, w_head, b_head, counts_full, k), 5)
    plain = cuda_ms(lambda: hpd_stream.hpd_stream_fused_fwd_plain(
        h_full, w_head, b_head, counts_full, k, "highest"), 2)
    entries["hpd_stream_fused_fwd"] = kernel_entry(
        "hpd_stream_fused_fwd", SRC + "hpd_stream.cu", JAX_SRC + "hpd_stream.py:570", err, ms,
        plain, kernel_work("K1", u=u_c, h=H, t=T, l=L, k=k, counts=counts_full))
    entries["hpd_stream_fused_fwd"]["fixup_rows"] = fix
    redesigned(entries["hpd_stream_fused_fwd"])

    log("K2 hpd_stream_fused_bwd, full U_c of real h:")
    g_marg = torch.randn(L, T, device=dev, generator=gen)
    g_vals = torch.randn(u_c, k, device=dev, generator=gen)
    _, vals, idx, m, s = out_k
    args = (h_full, w_head, b_head, counts_full, idx, vals, m, s, g_marg, g_vals, k)
    errs = []
    for noop in (False, True):
        res_k = hpd_stream.hpd_stream_fused_bwd(*args, noop_topk=noop)
        res_p = hpd_stream.hpd_stream_fused_bwd_plain(*args, "highest", noop)
        errs += [compare(f"{n} noop={noop}", a, r, GRAD_TOL)
                 for n, a, r in zip(("dh", "dw", "db"), res_k, res_p)]
        bitwise_same(f"dh/dw/db noop={noop}", res_k,
                     hpd_stream.hpd_stream_fused_bwd(*args, noop_topk=noop))
        del res_k, res_p
    ms = cuda_ms(lambda: hpd_stream.hpd_stream_fused_bwd(*args), 3)
    plain = cuda_ms(lambda: hpd_stream.hpd_stream_fused_bwd_plain(*args, "highest", False), 2)
    entries["hpd_stream_fused_bwd"] = kernel_entry(
        "hpd_stream_fused_bwd", SRC + "hpd_stream.cu", JAX_SRC + "hpd_stream.py:722", max(errs),
        ms, plain, kernel_work("K2", u=u_c, h=H, t=T, l=L, k=k))
    redesigned(entries["hpd_stream_fused_bwd"])
    entries["scatter_add_serial[narrow]"] = gather_scatter_phase(geom, mcfg.feature_dim, dev, gen)

    # --------------- kernels vs plain versions end to end ------------------ #
    log("small streamed geometry, 2 epochs, card (kernels) vs CPU (plain versions):")
    small = experiment_from_grid_id(4061, base_model=ModelConfig(
        hash_table_size=2048, num_levels=4, n_min=8, n_max=48, hpd_backend="unique_stream"))
    img = torch.randint(0, 256, (24, 20, 3), generator=torch.Generator().manual_seed(SEED))
    small_data = image_dataset(img.numpy().astype("uint8"), "synthetic")
    start = gngf.init_params(small.model, SEED, "cpu")
    r_gpu = fit(small, small_data, epochs=2, device=dev, params=start, verbose=False)
    r_cpu = fit(small, small_data, epochs=2, device="cpu", params=start, verbose=False)
    for hg, hc in zip(r_gpu.history, r_cpu.history):
        log(f"  epoch {hg['epoch']}: loss card {hg['train_loss']:.7f} cpu {hc['train_loss']:.7f}")
        if not math.isclose(hg["train_loss"], hc["train_loss"], rel_tol=1e-4):
            raise AssertionError("training on the card disagrees with the plain versions on the CPU")

    # ------------------------- the main path ------------------------------- #
    wrappers = {
        "hpd_stream_fused_fwd": hpd_stream.hpd_stream_fused_fwd,
        "hpd_stream_fused_bwd": hpd_stream.hpd_stream_fused_bwd,
        "hidden_stack_fwd": hidden.hidden_stack_fwd,
        "hidden_stack_bwd": hidden.hidden_stack_bwd,
    }
    k12 = {"scatter_add_serial": scatter.scatter_add_serial}   # both gathers' table gradients
    log("fit: grid 4061, scaled geometry, strawberry, 3 epochs:")
    launches, history, fit_s = fit_checked(
        fit, exp, data, dev, {**wrappers, **k12}, "the dedup route",
        variants=("scatter_add_serial[ring]", "scatter_add_serial[narrow]"))
    for name in (*wrappers, "scatter_add_serial[narrow]"):
        entries[name]["launches"] = launches[name]
        entries[name]["route"] = "cuda"
    fixup_rows(hpd_stream.hpd_stream_fused_fwd, "K1, the fit's last launch")

    # ------------------ where one epoch's device time goes ------------------ #
    log("profile: one epoch of the same training, device time by kernel:")
    profile = profile_epoch(exp, statics, batches, dev)
    log_profile(profile)
    entries["hpd_stream_fused_bwd"]["per_launch_ms"] = per_launch(
        "K2", profile, ("hpd_bwd_rows_kernel", "hpd_bwd_cols_kernel"))
    del batches, geom, h_k, h_full, args, out_k       # x, counts_full: step 14
    torch.cuda.empty_cache()
    marks = {}
    watermark(marks, "dedup route (steps 2-5)", dev)

    # ------------------- the per-row route: K8-K11 ------------------------- #
    data_raw = load_image_dataset(os.path.join(HERE, "images", "strawberry.npy"), normalize=False)
    pr_exp = experiment_from_grid_id(4061, base_model=ModelConfig(batchnorm_input=True))
    pr_statics = gngf.make_statics(pr_exp.model)
    shuffled, _ = make_shuffle_permutations(data_raw.num_pixels, pr_exp.train.seed,
                                            pr_exp.train.shuffle_pixels)
    pr_batches = build_epoch_batches(data_raw.coords, data_raw.targets, pr_exp.train.batch_fraction,
                                     shuffled, data_raw.image, pr_exp.model, pr_statics, dev)
    entries.update(per_row_kernel_phases(pr_exp, pr_batches, pr_statics, dev, gen))

    routes = {
        "auto": ({"hpd_full_fwd": hpd_full.hpd_full_fwd, "hpd_full_bwd": hpd_full.hpd_full_bwd}, "auto"),
        "pallas": ({"hpd_tail_fwd": hpd_tail.hpd_tail_fwd, "hpd_tail_bwd": hpd_tail.hpd_tail_bwd}, "pallas"),
    }
    log("small per-row geometry, 2 epochs, card (kernels) vs CPU (plain versions):")
    small_img = image_dataset(img.numpy().astype("uint8"), "synthetic", normalize=False)
    for route, (_, backend) in routes.items():
        small = experiment_from_grid_id(4061, base_model=ModelConfig(
            batchnorm_input=True, hpd_backend=backend))
        start = gngf.init_params(small.model, SEED, "cpu")
        r_gpu = fit(small, small_img, epochs=2, device=dev, params=start, verbose=False)
        r_cpu = fit(small, small_img, epochs=2, device="cpu", params=start, verbose=False)
        for hg, hc in zip(r_gpu.history, r_cpu.history):
            log(f"  {route} epoch {hg['epoch']}: loss card {hg['train_loss']:.7f} cpu {hc['train_loss']:.7f}")
            if not math.isclose(hg["train_loss"], hc["train_loss"], rel_tol=1e-4):
                raise AssertionError(f"per-row training ({route}) on the card disagrees with the CPU")

    per_row_fits = {}
    for route, (route_wrappers, backend) in routes.items():
        run_exp = dataclasses.replace(pr_exp, model=dataclasses.replace(pr_exp.model, hpd_backend=backend))
        log(f"fit: grid 4061, default geometry, batchnorm_input, hpd_backend {backend!r}, "
            "strawberry raw coords, 3 epochs:")
        launches, pr_history, pr_fit_s = fit_checked(
            fit, run_exp, data_raw, dev, {**route_wrappers, **k12}, f"the per-row route ({backend})",
            variants=("scatter_add_serial[ring]",))
        per_row_fits[route] = dict(history=pr_history, fit_s=pr_fit_s, launches=launches)
        for name in route_wrappers:
            entries[name]["launches"] = launches[name]
            entries[name]["route"] = "cuda"
        if route == "auto":
            fixup_rows(hpd_full.hpd_full_fwd, "K10, the fit's last launch")

    log("two fits from one start on the card, every parameter and buffer compared bitwise:")
    determinism = two_fits(fit, [("the dedup route at T = 2^14", exp, data, 3),
                                 ("the per-row route", pr_exp, data_raw, 3)], dev)

    log("profile: one per-row epoch (hpd_backend 'auto'), device time by kernel:")
    pr_profile = profile_epoch(pr_exp, pr_statics, pr_batches, dev)
    log_profile(pr_profile)
    watermark(marks, "per-row route (steps 6-8)", dev)

    # ----------- the split route at T = 2^16: K4-K6 and K12 ---------------- #
    exp16 = experiment_from_grid_id(4061, base_model=instantngp_scaled_model(hash_table_size=2**16))
    statics16 = gngf.make_statics(exp16.model)
    shuffled, _ = make_shuffle_permutations(data.num_pixels, exp16.train.seed, exp16.train.shuffle_pixels)
    batches16 = build_epoch_batches(data.coords, data.targets, exp16.train.batch_fraction,
                                    shuffled, data.image, exp16.model, statics16, dev)
    split_entries, fused_vs_split = split_kernel_phases(exp16, batches16, dev, gen)
    entries.update(split_entries)

    split_wrappers = {
        "hidden_stack_fwd": hidden.hidden_stack_fwd,
        "hidden_stack_bwd": hidden.hidden_stack_bwd,
        "hpd_stream_select": hpd_stream.hpd_stream_select,
        "hpd_stream_marginal": hpd_stream.hpd_stream_marginal,
        "hpd_tail_unique_bwd": hpd_stream.hpd_tail_unique_bwd,
        "scatter_add_serial": scatter.scatter_add_serial,
    }
    fused_pair = (hpd_stream.hpd_stream_fused_fwd, hpd_stream.hpd_stream_fused_bwd)
    log("small split geometry (fused gate forced), 2 epochs, card (kernels) vs CPU (plain versions):")
    saved_gate = hpd_stream.FUSED_W_MAX_BYTES
    hpd_stream.FUSED_W_MAX_BYTES = 0
    small = experiment_from_grid_id(4061, base_model=ModelConfig(
        hash_table_size=4096, num_levels=4, n_min=8, n_max=48, hpd_backend="unique_stream"))
    start = gngf.init_params(small.model, SEED, "cpu")
    for fn in (*split_wrappers.values(), *fused_pair):
        fn.launches = 0
    r_gpu = fit(small, small_data, epochs=2, device=dev, params=start, verbose=False)
    small_launches = {name: fn.launches for name, fn in split_wrappers.items()}
    if min(small_launches.values()) == 0 or any(fn.launches for fn in fused_pair):
        raise AssertionError(f"small split geometry did not run the split kernels: {small_launches}")
    r_cpu = fit(small, small_data, epochs=2, device="cpu", params=start, verbose=False)
    for hg, hc in zip(r_gpu.history, r_cpu.history):
        log(f"  epoch {hg['epoch']}: loss card {hg['train_loss']:.7f} cpu {hc['train_loss']:.7f}")
        if not math.isclose(hg["train_loss"], hc["train_loss"], rel_tol=1e-4):
            raise AssertionError("split training on the card disagrees with the plain versions on the CPU")
    hpd_stream.FUSED_W_MAX_BYTES = saved_gate

    log("fit: grid 4061, instantngp_scaled_model(hash_table_size=2**16), strawberry, 3 epochs:")
    launches16, history16, fit16_s = fit_checked(
        fit, exp16, data, dev, split_wrappers, "the split route", absent=fused_pair,
        variants=("scatter_add_serial[ring]", "scatter_add_serial[narrow]"))
    for name in ("hpd_stream_select", "hpd_stream_marginal", "hpd_tail_unique_bwd",
                 "scatter_add_serial[ring]"):
        entries[name]["launches"] = launches16[name]
        entries[name]["route"] = "cuda"
    fixup_rows(hpd_stream.hpd_stream_select, "K4, the fit's last launch")
    log("profile: one epoch of the T = 2^16 training, device time by kernel:")
    profile16 = profile_epoch(exp16, statics16, batches16, dev)
    log_profile(profile16)
    entries["hpd_tail_unique_bwd"]["per_launch_ms"] = per_launch(
        "K6", profile16, ("hpd_b1_kernel", "hpd_b2_rows_kernel", "hpd_bwd_cols_kernel"))
    del batches16
    torch.cuda.empty_cache()
    watermark(marks, "split route (steps 9-11)", dev)

    # ------- K > 16 and approximate top-k: the chunked tail (step 12) ------- #
    wide_k = wide_k_phase(fit, data, small_data, dev, gen)
    torch.cuda.empty_cache()
    watermark(marks, "K > 16 (step 12)", dev)

    # -------- the wide stack [2 -> 256 -> 512 -> 256] (ROADMAP §3.1) -------- #
    entries.update(wide_tail_phase(hpd_stream, hpd_tail, hpd_full, dev, gen))
    wide_heads = wide_heads_phase(hpd_stream, hpd_tail, dev, gen)
    overflow = overflow_stack_phase(hpd_tail, hpd_full, dev)
    k3_pair = {"hidden_stack_fwd": hidden.hidden_stack_fwd, "hidden_stack_bwd": hidden.hidden_stack_bwd}
    small_stream = dict(num_levels=4, n_min=8, n_max=48, hpd_backend="unique_stream")
    log(f"wide stack {WIDE_HIDDEN}: small geometries, 2 epochs, card (kernels) vs CPU (plain versions):")
    wide_launches = wide_fits(fit, [
        ("dedup route", dict(hash_table_size=2048, **small_stream), small_data,
         {**k3_pair, "hpd_stream_fused_fwd": hpd_stream.hpd_stream_fused_fwd,
          "hpd_stream_fused_bwd": hpd_stream.hpd_stream_fused_bwd}, False),
        ("split route", dict(hash_table_size=4096, **small_stream), small_data,
         {"hpd_stream_select": hpd_stream.hpd_stream_select,
          "hpd_stream_marginal": hpd_stream.hpd_stream_marginal,
          "hpd_tail_unique_bwd": hpd_stream.hpd_tail_unique_bwd}, True),
        ("per-row route (auto)", dict(batchnorm_input=True), small_img,
         {"hpd_full_fwd": hpd_full.hpd_full_fwd, "hpd_full_bwd": hpd_full.hpd_full_bwd}, False),
        ("per-row route (pallas)", dict(batchnorm_input=True, hpd_backend="pallas"), small_img,
         {"hpd_tail_fwd": hpd_tail.hpd_tail_fwd, "hpd_tail_bwd": hpd_tail.hpd_tail_bwd}, False),
    ], dev)
    exp_w = experiment_from_grid_id(4061, base_model=instantngp_scaled_model(hpd_hidden=WIDE_HIDDEN))
    log(f"fit: grid 4061, scaled geometry, hpd_hidden {WIDE_HIDDEN}, strawberry, 3 epochs:")
    wide_dedup = {**k3_pair, "hpd_stream_fused_fwd": hpd_stream.hpd_stream_fused_fwd,
                  "hpd_stream_fused_bwd": hpd_stream.hpd_stream_fused_bwd}
    launches_w, history_w, fit_w_s = fit_checked(fit, exp_w, data, dev, {**wide_dedup, **k12},
                                                 "the wide dedup route")
    profile_w = wide_scaled_profile(exp_w, data, shuffled, history_w, dev)
    pr_exp_w = experiment_from_grid_id(4061, base_model=ModelConfig(batchnorm_input=True,
                                                                    hpd_hidden=WIDE_HIDDEN))
    log(f"fit: grid 4061, default geometry, batchnorm_input, hpd_hidden {WIDE_HIDDEN}, "
        "hpd_backend 'auto', strawberry raw coords, 3 epochs:")
    wide_full = {"hpd_full_fwd": hpd_full.hpd_full_fwd, "hpd_full_bwd": hpd_full.hpd_full_bwd}
    launches_pw, history_pw, fit_pw_s = fit_checked(fit, pr_exp_w, data_raw, dev, {**wide_full, **k12},
                                                    "the wide per-row route (auto)")
    for name in (*wide_dedup, *wide_full):
        wide_launches[name + (WIDE_TAG if name.startswith("hidden") else WIDE_H)] = (
            launches_w if name in wide_dedup else launches_pw)[name]
    for name, n in wide_launches.items():
        if name in entries:
            entries[name]["launches"] = n
            entries[name]["route"] = "cuda"
    wide_fit = dict(dedup=dict(history=history_w, fit_s=fit_w_s, launches=launches_w,
                               profile=profile_w),
                    per_row_auto=dict(history=history_pw, fit_s=fit_pw_s, launches=launches_pw))
    torch.cuda.empty_cache()
    watermark(marks, "wide stack (step 13)", dev)

    # ------ the measurement path: the K7 ladder, then the mxu probe --------- #
    h_c = hidden.hidden_stack_fwd(x, hidden_layers).contiguous()
    ladder_entries, ladder = probe_ladder_phase(h_c, w_head, b_head, counts_full, k)
    entries.update(ladder_entries)
    del h_c, x, counts_full
    torch.cuda.empty_cache()
    watermark(marks, "K7 ladder (step 14)", dev)
    mxu_entries, mxu_rates = mxu_probe_phase(dev)
    entries.update(mxu_entries)
    watermark(marks, "mxu probe (step 15)", dev)

    # ------------- the vanilla hash, then checkpoints (steps 16-17) ---------- #
    vanilla = vanilla_phase(fit, data, small_data, dev, gen)
    torch.cuda.empty_cache()
    watermark(marks, "vanilla hash (step 16)", dev)
    checkpoints = checkpoint_phase(fit_with_checkpoints, data, dev)
    watermark(marks, "checkpoints (step 17)", dev)

    # ------------- the grid driver, render and the CLI (step 18) ------------ #
    entries["hpd_stream_fused_fwd[render]"], grid_render = grid_render_phase(data, dev)
    watermark(marks, "grid driver, render, CLI (step 18)", dev)

    # --------------------- spans and ensembles (step 19) -------------------- #
    spans = span_ensemble_phase(fit_with_checkpoints, data, dev)
    watermark(marks, "spans and ensembles (step 19)", dev)

    # ------ data parallelism, tables sharded by slot, on one card (step 20) ---- #
    entries["scatter_add_serial[range]"], parallel = parallel_phase(data, data_raw, dev)
    watermark(marks, "parallel (step 20)", dev)

    # ------------- the roofline and the kernel timer (step 21) ------------- #
    tool_entries, tools = measurement_tools_phase()
    entries.update(tool_entries)
    watermark(marks, "measurement tools (step 21)", dev)

    # ---------------- the grid study's drivers (step 22) ------------------- #
    study_entries, study = study_tools_phase(dev)
    entries.update(study_entries)
    watermark(marks, "study tools (step 22)", dev)

    # ---------------- the step split by stage (step 23) ------------------- #
    split_entries, split_tools = split_tools_phase(dev)
    entries.update(split_entries)
    watermark(marks, "step split (step 23)", dev)

    # ------- dedup_cell_gather's A/B and the scaling harness (step 24) ----- #
    field_scaling = cell_gather_scaling_phase(dev)
    watermark(marks, "cell gather A/B, scaling (step 24)", dev)

    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(gpu=smi, build_s=build_s, kernels=list(entries.values()),
                       fit=history, fit_s=fit_s, profile=profile, per_row_fits=per_row_fits,
                       per_row_profile=pr_profile, fused_vs_split=fused_vs_split,
                       split_fit=history16, split_fit_s=fit16_s, split_launches=launches16,
                       split_profile=profile16, sweep_ladder_highest=ladder,
                       mxu_probe_rates=mxu_rates, memory_gb=marks, compares=COMPARES,
                       wide_fit=wide_fit, wide_heads=wide_heads, overflow_stack=overflow,
                       sass_tensor_ops=sass, two_fits=determinism, wide_k=wide_k,
                       vanilla=vanilla, checkpoints=checkpoints, grid_render=grid_render,
                       spans=spans, parallel=parallel, measurement_tools=tools,
                       study_tools=study, split_tools=split_tools,
                       field_scaling=field_scaling),
                  f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(smi)
    log(json.dumps({"kernels": [{k_: e[k_] for k_ in keys} for e in entries.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
