#!/usr/bin/env python3
"""Drive brancher_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --phases 1,2   # a subset (no "ok" line then)

Phases (each prints one or more JSON lines tagged "phase"):
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, and the builds of brancher_torch/csrc/glm_vg.cu (with
     the header glm_sm90.cuh it includes), leapfrog.cu and nuts_leaf.cu
     (one nvcc each, started together) with ptxas's register, spill and
     shared-memory lines;
  2. every kernel against its plain PyTorch version: K1-K4 at the floor
     shape (C=1024, N=1000, D=32), the conjugate shape (C=64, N=20, D=1),
     the MXU-scale GLM shape (C=256, N=131072, D=1024) and a ragged shape
     (C=100, N=1037, D=33: no axis a multiple of 8), K3/K4 also at phase
     5's linear-Gaussian shape (C=256, N=131072, D=1025), and K1 at the
     benchmark's covtype shapes (C=1024 and 64, N=581012, D=55); K5 (the fused
     leapfrog) for both families at the floor and conjugate shapes with 1,
     8 and 32 steps; K6 (logreg) at the floor and MXU shapes.  Each row has
     errors, a control, the determinism check, the kernel's and the plain
     version's median ms, the bound's ms and TFLOP/s; the value+grad rows
     also the median ms of the two products alone through cuBLAS
     (matmul_pair_ms), their path (the f32 narrow pass or passes A and B)
     and, where the narrow pass ran, passes A and B at the same shape
     (two_pass_ms).  K3/K4 also run at phase 11's AR(1) and AR(2)
     shapes (C=512; N=1999, D=2 and N=998, D=3) and K5 at AR(1)'s, on the
     family the recognizer extracts from those models.  K7 (the NUTS
     leaf's head and tail) runs at the benchmark cells' (C, d) in
     LEAF_SHAPES: LEAF_COUNT leaves, n one index and one a chain, against
     the plain leaf from the card tests' random states (every buffer to
     TOL_LEAF, the flags exactly, a second K7 tree bit for bit), then on
     live trees, both walks captured in CUDA graphs and timed, ms a leaf,
     beside the least bytes a leaf moves;
  3. vectorized NUTS at the floor config: make_logreg_data(1000, 32) ->
     logistic_regression_model -> sample(NUTS(max_depth=8), 500 warmup,
     1000 draws, 1024 chains) with fused_potential "auto" (K1), "bf16" (K2)
     and "off" (autodiff, the yardstick), fewer draws for the last two
     (250) after FLOOR_SIDE_WARMUP warmup transitions ("reduced");
  4. NUTS on the conjugate model with "auto" (K3) and "bf16" (K4) against
     its closed-form posterior;
  5. the MXU-scale logistic regression (N=131072, D=1024, 256 chains) with
     "auto" (K1) and "bf16" (K2), and the peak card memory of the
     recognizer's prior probe with the whole log density and with the
     prior alone; then a linear-Gaussian regression on the same X (w ~
     N(0, 1) [1024], sigma ~ LogNormal(0, 0.5), y ~ N(X w, sigma): D=1025)
     with "auto" (K3) and "bf16" (K4);
  6. ChEES at the floor config (500 warmup, 1000 draws, 1024 chains) three
     ways: fused_leapfrog=True (K5), a loop of K1, and value_and_grad_fn=
     K6; posterior means against phase 3's "auto" run;
  7. HMC with fused_leapfrog=True: HMC(num_integration_steps=16) on the
     conjugate model (K5 on normal_learned), against the closed form; and
     HMC(num_integration_steps=32) on the floor model (1024 chains, 100
     warmup + 200 draws: K5 on bernoulli_logit with up to 32 steps a
     transition), posterior means against phase 3's "auto" run, with the
     sampler's ms per transition;
  8. the ARD headline, bench.py's child_ard at full width:
     make_logreg_data(100, 32, seed=0), tau ~ LogNormal(0, 0.75) [32], w
     non-centered, 1024 chains, NUTS(max_depth=8), target_accept 0.95,
     500 warmup + 2000 draws, on bench's hand-fused value+grad replayed
     from a CUDA graph as bench jit-compiles it (held to autodiff at three
     random z first, and the replay to the eager call bit for bit at the
     run's shape; no kernel: the recognizer declines, logits are not
     affine in z); min-ESS over w and tau,
     min-ESS/s, divergences, max R-hat, leaves per draw, and the device
     diagnostics against the host ones on the same draws (the first
     ARD_DIAG_CHAINS chains), both timed;
  9. SVI on the floor model: perform_inference with AutoMeanField, 16
     samples, lr 0.02, 1500 steps; the guide's loc within 0.15 of phase
     3's NUTS means; ELBO steps/s over the call's wall time;
 10. the VAE, bench.py's child_vae at full width: make_vae_data(4096, 64),
     latent 8, hidden 64, batch 256, 1 sample, lr 1e-3, 500 steps; ELBO
     steps/s (perform_inference._benchmark), the loss means of the first
     and last 100 steps (the last lower) and peak memory, TF32 off;
 11. AR(p) series under NUTS, scripts/exp_glm_speedup.py:12-14's AR(1) at
     full width: make_ar_data(2000, (0.7,), 0.3, seed=0) -> ar_model(order=1),
     512 chains, NUTS(max_depth=8), 400 warmup + AR1_DRAWS draws
     ("reduced" from 800), with fused_potential "auto" (K3), "bf16" (K4)
     and "off" (autodiff, the yardstick); the same model under ChEES with fused_leapfrog=True (K5);
     and examples/03_autoregressive_timeseries.py:10-13's AR(2) (T=1000,
     coefficients (0.5, 0.2)) under "auto" (AR2_WARMUP + AR2_DRAWS, "reduced"),
     against its least-squares fit.  The recognizer finds normal_learned over the lag matrix (D =
     order + 1); phase 2 holds K3/K4 (and K5 at AR(1)) at these shapes on
     that family;
 12. the particle methods (no kernel): the bootstrap filter at
     examples/04_state_space_smc.py:17-21's config (LGSSM T=200, 8192
     particles) and the streaming filter (T=300, 2048 particles, lag 16,
     chunks of 64) against the Kalman filter; tempered SMC on the
     conjugate model (2048 particles) against the closed form; PMMH (T=60,
     128 particles, 8 chains) and particle Gibbs (32 particles), both at
     PMMH17_DEPTH ("reduced" from 200 + 400),
     against the Kalman grid posterior of a; each with the limits of its
     JAX test, its wall time and the filters' particle-steps per second;
 13. the remaining MCMC modes at full width: phase 11's AR(2) under
     mass="dense" (stage A and the whitened stage B both on K3; AR_WARMUP
     + AR2_DRAWS, "reduced"), resumed
     for 400 draws from its resume_state after a torch.save/torch.load
     round trip, and under NUTS(max_depth=8, pipelined=True) (K3;
     AR2_WARMUP + AR2_DRAWS, "reduced"); phase 3's floor under the pipelined
     engine (K1; PIPELINED_FLOOR_WARMUP + PIPELINED_FLOOR_DRAWS,
     "reduced"); phase 11's AR(1) ChEES
     run resumed for 400 draws with fused_leapfrog=True (K5 once a
     transition); chain_method="vmap" (no kernel) at the floor (1024
     chains, 200 + 200) and on the conjugate model (64 chains,
     CONJUGATE_VMAP_DEPTH, "reduced" from 500 + 1000); and phase 8's ARD under the pipelined engine (ARD13_DRAWS
     draws, resumed from phase 8's run, or after 500 warmup transitions
     where phase 8 did not run), its iterations a draw and ms an
     iteration beside phase 8's lockstep leaves.  Each against its
     phase's reference (least squares, MCSE, closed form) with R-hat;
 14. the model zoo, no kernel on any run: softmax classification at
     scripts/exp_categorical_speedup.py:26-34's full width (N=2000, d=32,
     K=10, D=330; 256 chains, NUTS(max_depth=7), fused_potential="auto",
     which keeps it on autodiff; warmup and draws in ZOO_RUNS) with the
     recognized CategoricalFusedFamily held to autodiff and both timed;
     WAIC and PSIS-LOO on phase 3's "auto" draws (a [1000, 1000] pointwise
     matrix); eight schools (HalfCauchy), GP regression and a two-
     component GMM at their JAX tests' runs and limits (ZOO_RUNS; a cut
     prints "reduced"); WVGD and SVGD on the conjugate model; flow VI
     (TriangularLinear + Shift); and phase 9's floor SVI with
     matmul_precision="bfloat16";
 15. exact enumeration of discrete latents, no kernel on any run: the
     sequence HMM of tests/test_discrete_latents.py:624-661 (MarkovProcess,
     T=500, K=2, BF.take emissions) at 256 chains, NUTS, 100 + 100
     ("reduced" from 200 + 200), on a
     value+grad that must replay a CUDA graph; _markov_hmm_model (:531, K=3)
     at T=100 and T=10,000, one value+grad of 256 chains (capture seconds,
     ms a replay and an eager call, graphed held to eager); the element-
     wise mixture (:57-124) at 256 chains (200 + 200, "reduced") with its
     responsibilities, and enumerated SVI on it (:127-139); the Gaussian
     HMM (tests/test_hmm.py:67-87) at 256 chains (200 + 200, "reduced")
     and the Poisson HMM (:154-175) at its 4 (200 +
     200, "reduced"); the chain, factor and group models (:242-255, :350-370, :497-529) at their
     tests' runs against quadrature.  Each prints its dispatch's method and
     seconds, whether the value+grad was graphed, leaves a draw, ms a call
     and min-ESS/s (on each draw's sorted components where the labels are
     exchangeable);
 16. the auxiliary modules on phase 3's floor model (1024 chains): NUTS
     200 + 200 on K1; its resume_state through save_checkpoint /
     restore_checkpoint, resumed for 200 draws on K1 (within 5 MCSE of
     the first run); posterior_predictive (1000 draws of y, all 0 or 1);
     summarize_mcmc and export_dashboard_html (24 panels); profile_trace
     around 10 resumed transitions, with the trace's bytes and the card's
     busy share over the traced window (information); MetricsLogger's
     JSONL over 300 steps of phase 9's floor SVI; the spec round trip
     (the floor model's expression link refused, a direct-link model over
     the floor's X rebuilt with a bit-identical log density); phase 12's
     streaming filter checkpointed at t=150 and resumed bit for bit; and,
     where pandas, cloudpickle and matplotlib import (the phase prints
     which do), to_pandas, get_sample(1000), save_model -> load_model
     (the same draws and log density) and a plot;
 17. the sharded modes through a one-rank NCCL group opened in-process
     (parallel.initialize_distributed on a FileStore in a temporary
     directory, with a timeout; its line prints "world_size" and
     "backend"), every mesh built by the port's parallel functions: floor
     NUTS with mesh=chain_mesh() (phase 3's config but SHARDED_FLOOR_DRAWS
     draws, "reduced"; K1 once a value+grad call, R-hat, means within 5
     MCSE of phase 3's, ms a leaf iteration beside phase 3's); floor ChEES with fused_leapfrog=True (K5 once a
     transition, means against phase 6's); chain_method="shard_map" at the
     floor, 200 + 200 (beside phase 13's vmap row); mass="dense" on the
     conjugate model (K3, SHARDED_DENSE_DEPTH, "reduced"; against the
     closed form); floor SVI with
     mesh=batch_mesh() (phase 9's config); phase 12's LGSSM through
     smc_sample(mesh=particle_mesh()) with exchange "ppermute", "gather"
     and "island" (phase 12's limits; ppermute and gather bit for bit; the
     ring's host reads a step); the streaming filter with mesh= (phase
     12's); PMMH with shard="chain" and "particle" at phase 12's size (a
     cut of depth prints "reduced").  The group is destroyed at the end;
 18. the port's programs and the suite's cross-cutting checks:
     examples/torch/01, 02, 04, 05 and 07 through main() at the JAX
     examples' own sizes but for the cuts in EXAMPLE_CUTS (printed as
     "reduced"; 03 does not run here, as phase 11 runs its AR(2), and 06
     needs scikit-learn, which the card's machine lacks), each with its
     numbers against its reference limits (the closed form; corr >= 0.9;
     the Kalman filter; a falling loss; Stan's mu 4.4 and tau 3.6), wall
     seconds and launches (K3 = calls for 01, K1 = calls for 02, none for
     the rest); rerun pairs at one
     key on the floor at full width (1024 chains, RERUN_WARMUP +
     RERUN_DRAWS, "reduced"): NUTS "auto" (K1), "bf16" (K2), pipelined
     (K1) and "off" (the graphed autodiff value+grad, whose second call
     must capture no graph), HMC(8) and ChEES with fused_leapfrog=True
     (K5), the bootstrap filter at example 04's config, floor SVI for
     RERUN_SVI_STEPS steps and the softmax family's scatter_add value+grad
     at phase 14's shape, each "bit_identical" or the script fails (after
     naming what torch calls nondeterministic in one more run); SBC at
     tests/test_calibration.py's sizes (conjugate NUTS and ChEES, the
     non-centered hierarchy on a graphed autograd value+grad, its depth
     halved, "reduced") with the chi-square p-values (> 0.005); the
     centered funnel under NUTS, ChEES
     and HMC (16 chains, FUNNEL_WARMUP + FUNNEL_DRAWS, NUTS at
     FUNNEL_NUTS_DEPTH; a cut prints "reduced"), each count nonzero;
 19. the {"kernels": [...]} summary (K1 for its main paths, for the
     pipelined floor, for phase 16's floor run, for phase 17's sharded
     floor and for example 02, K3 once for each of its eight paths
     (example 01's among them), K4 for each of its three, K5 for each of
     its six, K7 once for each of its shapes with the leaves of every
     sample() run), the card's name and power limit, and the last line
     {"ok": true, "device": {...}}.

Every launch counter is set to 0 just before each sample() or
perform_inference() run and read just after it; a run whose kernels did
not launch as expected (the value+grad kernel once per value+grad call,
K5 once per transition, K7 once a leaf of the vectorized NUTS engine (the
leaves its diagnostics report; in SBC its result's, in the examples the
recorder's "nuts.leaves"), and no kernel on the paths of phases 8-10, 12,
14 and 15,
on phase 13's vmap and ARD runs, on phase 16's SVI and posterior
predictive, on phase 17's shard_map, SVI and particle runs and on phase
18's examples 04, 05 and 07, SBC, funnel, filter and SVI runs, K7 aside
where they run that engine) fails the
script.  The whole script must end within 1200 s on
one card.  Any failed check raises: the script then exits
non-zero and prints no "ok" line.  Without CUDA, or without the
brancher_torch package beside it, it exits 2 at once.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent

# published H100 SXM peaks (dense): HBM bytes/s, f32 CUDA-core and bf16
# tensor-core operations/s; the card's power limit is printed beside them
PEAK_BYTES = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12}

SHAPES = {
    "floor": (1024, 1000, 32),
    "conjugate": (64, 20, 1),
    "mxu": (256, 131072, 1024),
    "ragged": (100, 1037, 33),
    "linreg": (256, 131072, 1025),
    # phase 18's examples: 02's logistic regression (64 chains, N=1000,
    # D=16) and 01's conjugate mean (8 chains, N=50, D=1; K3/K4 only)
    "ex02": (64, 1000, 16),
    "ex01": (8, 50, 1),
    # the benchmark's covtype cells: UCI Covertype's shape at 1024 and 64 chains
    "covtype_c1024": (1024, 581012, 55),
    "covtype_c64": (64, 581012, 55),
}
# phase 5's linear-Gaussian regression (z = [sigma, w]) and example 01: K3/K4 only
NORMAL_ONLY_SHAPES = ("linreg", "ex01")
# the covtype shapes: K1 only
K1_ONLY_SHAPES = ("covtype_c1024", "covtype_c64")
LEAPFROG_SHAPES = ("floor", "conjugate")
LEAPFROG_STEPS = (1, 8, 32)
LOGREG_SHAPES = ("floor", "mxu")
SOURCES = ("glm_vg", "leapfrog", "nuts_leaf")
# each value+grad kernel's shape on its main path (phase 3 and 6 for K1,
# K2 and K6)
MAIN_SHAPE = {"glm_bernoulli_f32": "floor", "glm_bernoulli_bf16": "floor", "logreg_f32": "floor"}
# K3 runs on eight main paths and K4 on three, one entry each in the
# summary, and K1 has entries for the pipelined, the auxiliaries', the
# sharded floor and example 02 beside its own: (section and run of RESULTS,
# phase-2 shape)
VG_PATHS = {"glm_bernoulli_f32": ((("floor_pipelined", "auto"), "floor"),
                                  (("aux", "aux/floor"), "floor"),
                                  (("sharded_floor", "auto"), "floor"),
                                  (("examples", "02"), "ex02")),
            "glm_normal_f32": ((("conjugate", "auto"), "conjugate"),
                               (("examples", "01"), "ex01"),
                               (("sharded_dense", "auto"), "conjugate"),
                               (("mxu_linreg", "auto"), "linreg"),
                               (("ar1", "auto"), "ar1"), (("ar2", "auto"), "ar2"),
                               (("ar2_dense", "auto"), "ar2"), (("ar2_pipelined", "auto"), "ar2")),
            "glm_normal_bf16": ((("conjugate", "bf16"), "conjugate"),
                                (("mxu_linreg", "bf16"), "linreg"),
                                (("ar1", "bf16"), "ar1"))}
# K5 runs on six main paths, one entry each in the summary: (section and
# run of RESULTS, phase-2 shape, family, phase-2 step count; None: the one
# nearest the run's leapfrogs per draw)
LEAPFROG_PATHS = ((("chees", "fused"), "floor", "bernoulli_logit", None),
                  (("sharded_chees", "fused"), "floor", "bernoulli_logit", None),
                  (("hmc_conjugate", "fused"), "conjugate", "normal_learned", None),
                  (("hmc_floor", "fused"), "floor", "bernoulli_logit", 32),
                  (("ar1_chees", "fused"), "ar1", "normal_learned", None),
                  (("ar1_chees", "resume"), "ar1", "normal_learned", None))
HMC_FLOOR_STEPS = 32
# Limit on max|kernel - plain| / max(max|plain|, 1), for val and grad.  The
# kernel and its plain version differ only in summation order: the worst
# reading on an H100 was 9.4e-7 (PERF.md).  For bf16 the product of two
# bf16 values is exact in f32, so the sums that feed the bf16 rounding of
# the residual agree as closely.  The limit sits above that reading and
# below the controls that each row also measures: the f32 plain version
# with TF32 products, and for bf16 the plain version without the bf16
# rounding of z and the residual.  A kernel that did either would fail.
TOL = 1e-5
# The bf16 kernels (K2, K4) sum their linear predictor (logit or loc) on
# the tensor cores, in another order than cuBLAS's f32 product in the plain
# version, and cuBLAS's own order changes with the shape.  Where the last
# bits of the predictor move the f32 residual across a bf16 rounding
# boundary, the kernel's bf16 residual is another bf16 value (a tie), and
# the gradient of its chain moves by that step times ll_scale times the
# chain's e2 (normal_learned) times the row of X: up to 2e-5 of the
# gradient's scale for one tie at the floor.  So a bf16 row (_bf16_ok)
# holds:
#   - its value to TOL;
#   - its gradient to TOL plus the bound of its ties' move
#     (glm.bf16_residual_readings' flip_allowance_rel, 0 without ties);
#   - its gradient to TOL against the plain formula applied to the kernel's
#     own bf16 residual;
#   - every differing residual to a tie (glm.TIE_UNITS of the residual's f32
#     precision from rounding to the kernel's value), at most FLIP_SHARE of
#     the residuals.  K2 on an H100 read 1.7e-5 at the MXU shape.  A Normal
#     residual near 0, where bf16's step is finest, flips for the same last
#     bits of loc, so K4's share is higher: 1.77e-4 at the linear-Gaussian
#     shape on an H100, each tie within 1.125 units (PERF.md).
# The unrounded control goes through the same gate and must fail it.
FLIP_SHARE = {"bernoulli_logit": 1e-4, "normal_learned": 1e-3}
# The same quantity for K5's z, r, val and grad after a trajectory.  A
# trajectory carries each step's rounding into the next, so the error
# grows with the step count: on an H100 the worst reading was 3.6e-6
# (normal_learned, floor shape, 32 steps; PERF.md).  The limit sits 8x
# above it and below every floor-shape TF32 control (2.1e-4 to 1.9e-3 at
# 1 to 32 steps); at D=1 (conjugate) the control uses no tensor cores.
TOL_LEAPFROG = 3e-5
LEAPFROG_EPS = 0.05
# Phase 11's AR series: scripts/exp_glm_speedup.py:12-14's AR(1), the JAX
# package's own AR record, and examples/03_autoregressive_timeseries.py:10-13's
# AR(2): order -> (T, coefficients), noise 0.3; 512 chains, NUTS(max_depth=8),
# 400 warmup + 800 draws.  z = [coefficients, log noise scale], D = order + 1.
AR_DATA = {1: (2000, (0.7,)), 2: (1000, (0.5, 0.2))}
AR_NOISE = 0.3
AR_CHAINS = 512
AR_WARMUP, AR_DRAWS = 400, 800
# phase 11's AR(1) NUTS draws ("auto", "bf16", "off"), cut from AR_DRAWS for
# time (printed as "reduced"): their ESS sat at its cap (512 x 800) with
# R-hat 1.0000 on an H100 (PERF.md)
AR1_DRAWS = 400
# AR(2)'s warmup and draws, cut from AR_WARMUP + AR_DRAWS for time in phases
# 11 and 13 (printed as "reduced"): its lockstep run fills 24 leaves a draw,
# and with phase 18 added the script read 1186.3 s on an H100 (700 W), then
# ran over 1200 s on a slow host at 400 + 400 (PERF.md).  The dense run
# keeps AR_WARMUP: at 300 its stage B adapted a worse metric, 15.2 leaves a
# draw against 3.0, and took longer.
AR2_WARMUP, AR2_DRAWS = 300, 300
# phase 2's K5 rows at AR(1): a diagonal inverse mass of the posterior's
# scale (sd about 0.016 in both coordinates at T=2000) and a step size
# well inside the integrator's stability limit there (about 2)
AR_INV_MASS = 2.5e-4
AR_EPS = 0.5

# K7, the NUTS leaf's bookkeeping (csrc/nuts_leaf.cu), at the (C, d) of the
# benchmark's cells: covtype at 1024 and 64 chains (D 55), German Credit's
# ARD (51 latents) and stochastic volatility (3,002 latents)
LEAF_SHAPES = {"covtype_c1024": (1024, 55), "covtype_c64": (64, 55),
               "ard_c1024": (1024, 51), "sv_c1024": (1024, 3002)}
# the leaves checked and timed: n = 128 .. 143 of a depth-8 tree, the first
# 16 of its last doubling (a subtree's start, then even and odd leaves)
LEAF_FIRST, LEAF_COUNT = 128, 16
# Limit on max|kernel - plain| / max(max|plain|, 1) over every buffer a
# later leaf or transition reads.  K7 rounds each product and sum as the
# plain leaf's ops do, so every elementwise value agrees bit for bit; the
# energy and the dots are summed in another order, which moves the
# per-chain log weights and accept sums by a few f32 units in their last
# place (tests/test_torch_nuts_leaf_cuda.py holds the same limit).
TOL_LEAF = 1e-5

RESULTS: dict = {}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 11, warm_ms: float = 50.0) -> float:
    """Median ms of ``reps`` launches enqueued back to back, each between
    two CUDA events (so host time between launches hides behind the card
    unless the host is the slower one), after at least ``warm_ms`` of
    calls so that the card's clocks have settled under the load."""
    import torch

    t0 = time.perf_counter()
    for i in range(10**6):
        fn()
        torch.cuda.synchronize()
        if i >= 1 and (time.perf_counter() - t0) * 1e3 >= warm_ms:
            break
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def _bound(nbytes: int, flops: int, dtype: str = "f32") -> dict:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_OPS[dtype] * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _tflops(row: dict) -> float:
    return row["flops"] / (row["ms"] * 1e-3) / 1e12


def _all_kernels():
    from brancher_torch.ops import kernel_wrappers

    return kernel_wrappers()


def _reset_launches() -> None:
    for k in _all_kernels().values():
        k.launches = 0


# ---------------------------------------------------------------------------
def phase_environment():
    import torch
    from brancher_torch.ops import cuda_build

    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, together
        list(pool.map(cuda_build.load_library, SOURCES))
    build_s = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    env = {
        "phase": 1, "nvidia_smi": smi, "python": sys.version.split()[0],
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
        "peak_bytes_per_s": PEAK_BYTES, "peak_ops_per_s": PEAK_OPS,
        "build_seconds": round(build_s, 3),
        "headers": {name: [p.name for p in cuda_build.included_headers(name)] for name in SOURCES},
        "ptxas": {name: [ln.strip() for ln in (cuda_build.BUILD_DIR / f"{name}.log")
                         .read_text().splitlines()
                         if "registers" in ln or "Compiling" in ln or "spill" in ln]
                  for name in SOURCES},
    }
    RESULTS["environment"] = env
    emit(env)


def _rel(got, ref) -> float:
    """max|got - ref| over max(max|ref|, 1): the quantity the limits bound."""
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1.0)


def _glm_inputs(c, n, d, family, gen):
    import torch

    dev = "cuda"
    x = torch.randn((n, d), generator=gen, device=dev) / d**0.5
    if family == "bernoulli_logit":
        y = (torch.rand((n,), generator=gen, device=dev) < 0.5).float()
    else:
        y = torch.randn((n,), generator=gen, device=dev)
    b = 0.3 * torch.randn((n,), generator=gen, device=dev)
    z = torch.randn((c, d), generator=gen, device=dev)
    m = torch.linspace(-1, 1, d, device=dev)
    iv = torch.linspace(0.5, 2.0, d, device=dev)
    u = torch.zeros(d, device=dev)
    u[-1] = 0.1
    return x, y, b, z, m, iv, u


def _glm_rows(gen, per_kernel):
    import torch
    from brancher_torch.ops import glm

    for shape_name, (c, n, d) in SHAPES.items():
        for family in ("bernoulli_logit", "normal_learned"):
            if family != "normal_learned" and shape_name in NORMAL_ONLY_SHAPES:
                continue
            if family != "bernoulli_logit" and shape_name in K1_ONLY_SHAPES:
                continue
            x, y, b, z, m, iv, u = _glm_inputs(c, n, d, family, gen)
            for dtype in ("f32",) if shape_name in K1_ONLY_SHAPES else ("f32", "bf16"):
                data = glm.build_glm_data(
                    family, x, y, b, m, iv, u=u if family == "normal_learned" else None,
                    c0=-0.3, ll_scale=1.3, dtype=dtype, device="cuda")
                _glm_row(data, z, dtype, shape_name, per_kernel)
            del x, y, b, z, data
            torch.cuda.empty_cache()


def _glm_row(data, z, dtype, shape_name, per_kernel):
    """One value+grad kernel on ``data`` at z [C, D] against its plain
    version: errors, control, determinism, times, bound; fails the script
    on a disagreement."""
    import torch
    from brancher_torch.ops import glm

    family = data.family
    (c, d), n = z.shape, data.x.shape[0]
    kernel = glm.kernel_for(family, dtype)
    v, g = kernel(z, data)
    v2, g2 = kernel(z, data)
    v_ref, g_ref = data.plain(z)
    if dtype == "f32":  # control: the products in TF32
        torch.backends.cuda.matmul.allow_tf32 = True
        v_ctl, g_ctl = data.plain(z)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:  # control: z and the residual not rounded to bf16
        v_ctl, g_ctl = data._replace(x=data.x.float()).plain(z)
    torch.cuda.synchronize()
    err = {
        "val_max_abs": float((v - v_ref).abs().max()),
        "grad_max_abs": float((g - g_ref).abs().max()),
        "val_max_rel": _rel(v, v_ref), "grad_max_rel": _rel(g, g_ref),
    }
    control = {
        "control": "tf32" if dtype == "f32" else "unrounded_bf16",
        "control_val_rel": _rel(v_ctl, v_ref), "control_grad_rel": _rel(g_ctl, g_ref),
    }
    ties = dtype == "bf16"
    if ties:
        err.update(glm.bf16_residual_readings(g, kernel.residual(z, data), z, data, g_ref))
        err["grad_limit_rel"] = TOL + err["flip_allowance_rel"]
        r_ctl = glm.residual_reference(z, data._replace(x=data.x.float()))
        ctl = glm.bf16_residual_readings(g_ctl, r_ctl, z, data, g_ref)
        ctl["val_max_rel"] = control["control_val_rel"]
        control.update({f"control_{k}": ctl[k] for k in (
            "resid_flips", "flips_legal", "flip_allowance_rel")})
        control["control_passes_gate"] = _bf16_ok(ctl, family)
    ok = ((_bf16_ok(err, family) if ties
           else err["val_max_rel"] <= TOL and err["grad_max_rel"] <= TOL)
          and bool(torch.isfinite(v).all()) and bool(torch.isfinite(g).all()))
    deterministic = bool(torch.equal(v, v2) and torch.equal(g, g2))
    ms = time_ms(lambda: kernel(z, data))
    plain_ms = time_ms(lambda: data.plain(z))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    narrow = glm.plan_glm(c, n, d, dtype, sms).narrow
    # "before": passes A and B at the same shape, where the narrow pass took their place
    two_pass = glm.plan_two_pass(c, n, d, dtype, sms)
    two_pass_ms = time_ms(lambda: kernel._launch(z, data, two_pass)) if narrow else None
    if dtype == "bf16":
        z16, x16 = z.to(torch.bfloat16), data.x
        r16 = torch.zeros((c, n), device="cuda", dtype=torch.bfloat16)
        pair = lambda: (z16 @ x16.T, r16 @ x16)
    else:
        r32 = torch.zeros((c, n), device="cuda")
        pair = lambda: (z @ data.x.T, r32 @ data.x)
    matmul_ms = time_ms(pair)
    row = {
        "phase": 2, "kernel": kernel.name, "shape": shape_name, "C": c, "N": n, "D": d,
        **err, **control, "tolerance_rel": TOL, "ok": ok, "deterministic": deterministic,
        **({"tie_units_limit": glm.TIE_UNITS, "flip_share_limit": FLIP_SHARE[family]}
           if ties else {}),
        "path": "narrow" if narrow else "two_pass", "ms": ms, "two_pass_ms": two_pass_ms,
        "plain_ms": plain_ms, "matmul_pair_ms": matmul_ms, "library_ms": None,
        **_bound(glm.glm_bytes(c, n, d, 2 if dtype == "bf16" else 4, family),
                 glm.glm_flops(c, n, d), dtype),
    }
    row["tflops"] = _tflops(row)
    emit(row)
    per_kernel[kernel.name].append(row)
    check(ok, f"{kernel.name} at {shape_name} disagrees with its plain version: {err}")
    check(not (ties and control["control_passes_gate"]),
          f"{kernel.name} at {shape_name}: the unrounded control passes the bf16 gate")
    check(deterministic, f"{kernel.name} at {shape_name} is not bit-reproducible")


def _bf16_ok(r: dict, family: str) -> bool:
    """The bf16 kernels' gate on glm.bf16_residual_readings and the value's
    error (see FLIP_SHARE)."""
    return (r["val_max_rel"] <= TOL and r["grad_max_rel"] <= TOL + r["flip_allowance_rel"]
            and r["grad_given_resid_rel"] <= TOL and r["flips_legal"]
            and r["flip_share"] <= FLIP_SHARE[family])


def _leapfrog_rows(gen, per_kernel):
    import torch
    from brancher_torch.ops import leapfrog as lf

    for shape_name in LEAPFROG_SHAPES:
        c, n, d = SHAPES[shape_name]
        for family in ("bernoulli_logit", "normal_learned"):
            x, y, b, z, m, iv, u = _glm_inputs(c, n, d, family, gen)
            u_fam = u if family == "normal_learned" else None
            fused = lf.build_fused_leapfrog(family, x, y, b, m, iv, u=u_fam, c0=-0.3,
                                            ll_scale=1.3, device="cuda")
            check(fused is not None, f"{family} at {shape_name} fails K5's size gate")
            r = torch.randn((c, d), generator=gen, device="cuda")
            im = torch.linspace(0.5, 1.5, d, device="cuda")
            _leapfrog_steps(fused, z, r, im, LEAPFROG_EPS, shape_name, per_kernel)
            del x, y, b, z, fused
            torch.cuda.empty_cache()


def _leapfrog_steps(fused, z, r, im, eps, shape_name, per_kernel):
    """K5 on ``fused``'s data from (z, r) for each of LEAPFROG_STEPS against
    its plain version; fails the script on a disagreement."""
    import torch
    from brancher_torch.ops import leapfrog as lf

    data, family = fused.data, fused.data.family
    (c, d), n = z.shape, data.x.shape[0]
    _, g = data.plain(z)
    eps = torch.tensor(eps, device="cuda")
    plain = lf.reference_leapfrog(data.plain)  # K5's plain version
    for n_steps in LEAPFROG_STEPS:
        steps_t = torch.tensor(n_steps, dtype=torch.int32, device="cuda")
        out = fused(z, r, g, eps, im, steps_t)
        out2 = fused(z, r, g, eps, im, steps_t)
        ref = plain(z, r, g, eps, im, n_steps)
        torch.backends.cuda.matmul.allow_tf32 = True  # control: TF32 products
        ctl = plain(z, r, g, eps, im, n_steps)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        names = ("z", "r", "val", "grad")
        err = {f"{k}_max_rel": _rel(a, bb) for k, a, bb in zip(names, out, ref)}
        err["max_abs"] = max(float((a - bb).abs().max()) for a, bb in zip(out, ref))
        control = {"control": "tf32",
                   "control_max_rel": max(_rel(a, bb) for a, bb in zip(ctl, ref))}
        worst = max(err[f"{k}_max_rel"] for k in names)
        ok = worst <= TOL_LEAPFROG and all(bool(torch.isfinite(t).all()) for t in out)
        deterministic = all(torch.equal(a, bb) for a, bb in zip(out, out2))
        ms = time_ms(lambda: fused(z, r, g, eps, im, steps_t))
        plain_ms = time_ms(lambda: plain(z, r, g, eps, im, n_steps))
        row = {
            "phase": 2, "kernel": lf.LEAPFROG.name, "family": family, "shape": shape_name,
            "C": c, "N": n, "D": d, "n_steps": n_steps, "plan": fused.plan(z)._asdict(),
            **err, "max_rel": worst,
            **control, "tolerance_rel": TOL_LEAPFROG, "ok": ok,
            "deterministic": deterministic, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None,
            **_bound(lf.leapfrog_bytes(c, n, d, family), lf.leapfrog_flops(c, n, d, n_steps)),
        }
        row["tflops"] = _tflops(row)
        emit(row)
        per_kernel[lf.LEAPFROG.name].append(row)
        check(ok, f"K5 {family} at {shape_name}, {n_steps} steps, disagrees: {err}")
        check(deterministic, f"K5 {family} at {shape_name} is not bit-reproducible")


def _ar_family(order):
    """The AR path's normal_learned family (phase 11's data and model, as
    the recognizer extracts it on the card: X the lag matrix with a zero
    column for the noise coordinate) and z [AR_CHAINS, order + 1] near
    the posterior."""
    import torch
    from brancher_torch.models import ar_model, make_ar_data
    from brancher_torch.ops import glm

    length, coeffs = AR_DATA[order]
    comp = ar_model(make_ar_data(length, coeffs, AR_NOISE, seed=0), order).compiled("cuda")
    fam = glm.recognize_fused_family(comp, comp.initial_params)
    check(fam is not None and fam.family == "normal_learned",
          f"AR({order}) is not recognized as normal_learned")
    gen = torch.Generator(device="cuda").manual_seed(order)
    z = 0.1 * torch.randn((AR_CHAINS, order + 1), generator=gen, device="cuda")
    z[:, :order] += torch.tensor(coeffs, device="cuda")
    z[:, -1] += math.log(AR_NOISE)
    return fam, z


def _ar_rows(per_kernel):
    """K3 and K4 at the AR(1) and AR(2) shapes of phase 11, K5 at AR(1)'s
    (its ChEES path), each on the family the recognizer extracts."""
    import torch
    from brancher_torch.ops import glm

    for order in AR_DATA:
        fam, z = _ar_family(order)
        for dtype in ("f32", "bf16"):
            data = glm.build_glm_data(fam.family, fam.x, fam.y, fam.b, fam.prior_mean,
                                      fam.prior_inv_var, u=fam.u, c0=fam.c0,
                                      ll_scale=fam.ll_scale, dtype=dtype, device="cuda")
            _glm_row(data, z, dtype, f"ar{order}", per_kernel)
        if order == 1:
            fused = fam.leapfrog()
            check(getattr(fused, "uses_kernel", False), "AR(1) fails K5's size gate")
            r = torch.randn(z.shape, generator=torch.Generator("cuda").manual_seed(3),
                            device="cuda")
            im = torch.full((order + 1,), AR_INV_MASS, device="cuda")
            _leapfrog_steps(fused, z, r, im, AR_EPS, "ar1", per_kernel)


def _logreg_rows(gen, per_kernel):
    import torch
    from brancher_torch.ops import glm, logreg

    for shape_name in LOGREG_SHAPES:
        c, n, d = SHAPES[shape_name]
        x = torch.randn((n, d), generator=gen, device="cuda") / d**0.5
        y = (torch.rand((n,), generator=gen, device="cuda") < 0.5).float()
        w = torch.randn((c, d), generator=gen, device="cuda")
        r32 = torch.zeros((c, n), device="cuda")
        v, g = logreg.logreg_value_and_grad(w, x, y, 1.5)
        v2, g2 = logreg.logreg_value_and_grad(w, x, y, 1.5)
        v_ref, g_ref = logreg.logreg_value_and_grad_reference(w, x, y, 1.5)
        torch.backends.cuda.matmul.allow_tf32 = True
        v_ctl, g_ctl = logreg.logreg_value_and_grad_reference(w, x, y, 1.5)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.synchronize()
        err = {"val_max_abs": float((v - v_ref).abs().max()),
               "grad_max_abs": float((g - g_ref).abs().max()),
               "val_max_rel": _rel(v, v_ref), "grad_max_rel": _rel(g, g_ref)}
        ok = (err["val_max_rel"] <= TOL and err["grad_max_rel"] <= TOL
              and bool(torch.isfinite(v).all()) and bool(torch.isfinite(g).all()))
        deterministic = bool(torch.equal(v, v2) and torch.equal(g, g2))
        row = {
            "phase": 2, "kernel": logreg.LOGREG.name, "shape": shape_name, "C": c, "N": n, "D": d,
            **err, "control": "tf32", "control_val_rel": _rel(v_ctl, v_ref),
            "control_grad_rel": _rel(g_ctl, g_ref), "tolerance_rel": TOL, "ok": ok,
            "deterministic": deterministic,
            "ms": time_ms(lambda: logreg.logreg_value_and_grad(w, x, y, 1.5)),
            "plain_ms": time_ms(lambda: logreg.logreg_value_and_grad_reference(w, x, y, 1.5)),
            "matmul_pair_ms": time_ms(lambda: (w @ x.T, r32 @ x)), "library_ms": None,
            # X, y, w read once; val and grad written once
            **_bound(n * d * 4 + n * 4 + (2 * c * d + c) * 4, glm.glm_flops(c, n, d)),
        }
        row["tflops"] = _tflops(row)
        emit(row)
        per_kernel[logreg.LOGREG.name].append(row)
        check(ok, f"K6 at {shape_name} disagrees with its plain version: {err}")
        check(deterministic, f"K6 at {shape_name} is not bit-reproducible")
        del x, y, w, r32
        torch.cuda.empty_cache()


def _live_leaf_tree(c, d, seed):
    """A float32 depth-8 tree whose chains all stay live through the
    LEAF_COUNT leaves from LEAF_FIRST, for the timing: every momentum 1 on
    every axis (the moving end's, the checkpoints', the sums'), no gradient
    and a flat energy, so no U-turn and no divergence; positions drawn from
    ``seed``."""
    import torch
    from brancher_torch.inference.vectorized_nuts import _NutsTree

    tree = _NutsTree(c, d, torch.float32, "cuda", 8, 1000.0)
    z = torch.randn((c, d), generator=torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda")
    for point in (tree.ends[0], tree.ends[1], tree.mov):
        point[0].copy_(z)
        point[2].fill_(1.0)
    tree.r_ck.fill_(1.0)
    tree.r_sum.fill_(float(LEAF_FIRST - 1))
    tree.eps.fill_(0.01)
    tree.inv_mass.fill_(1.0)
    tree.h0.fill_(0.5 * d)  # the kinetic energy at r = 1: a leaf's log weight is 0
    tree.active.fill_(True)
    return tree


def _leaf_cases():
    """tests/test_torch_nuts_leaf_cuda.py, whose tree states away from ties
    (random per-chain gradients, inverse mass and mixed momenta; planted
    NaN, +-inf and divergent energies; stopped, failed and waiting chains)
    and comparison this phase shares."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "test_torch_nuts_leaf_cuda.py"
    spec = importlib.util.spec_from_file_location("nuts_leaf_cases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel_leaf(got, ref) -> float:
    """``_rel`` over the entries where got and ref differ: an infinity or a
    NaN equal to its reference counts 0, one that is not counts inf."""
    import torch

    got, ref = got.double(), ref.double()
    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
    diff = (got - ref).abs()
    diff = torch.where(same, 0.0, torch.where(torch.isnan(diff), math.inf, diff))
    finite = ref[torch.isfinite(ref)]
    return float(diff.max()) / max(float(finite.abs().max()) if finite.numel() else 0.0, 1.0)


def _leaf_check(cases, c, d, seed):
    """K7 against the plain leaf and against itself at the LEAF_COUNT leaves
    from LEAF_FIRST, with n one index for every chain and one a chain, each
    leaf from the card tests' random float32 state of ``seed``: (max_rel
    over the buffers a later leaf or transition reads, flags and n equal,
    two K7 trees bit for bit)."""
    import torch

    dev, f32 = torch.device("cuda"), torch.float32
    s = cases._state(c, d, f32, dev, seed)
    plain, kern, again = (cases.TV._NutsTree(c, d, f32, dev, cases.DEPTH, cases.MAX_DELTA)
                          for _ in range(3))
    gen = torch.Generator(device=dev).manual_seed(seed)
    chains = torch.arange(c, device=dev)
    err, flags_equal, same = 0.0, True, True
    for per_chain in (False, True):
        for leaf in range(LEAF_FIRST, LEAF_FIRST + LEAF_COUNT):
            n = (leaf + chains) % 2**cases.DEPTH if per_chain else torch.tensor([leaf], device=dev)
            entry = dict(s, active=s["active"] & (n > 0))
            start = kern.flags[n.expand(c), 0]
            live = entry["active"] & (start | ~entry["s_failed"])
            swap_u, take_u = cases._uniforms(s, start, gen)
            for tree in (plain, kern, again):
                cases._load(tree, entry, n)
            plain.plain_leaf(cases._potential(plain, s), s["dir_pos"], swap_u, take_u)
            for tree in (kern, again):
                tree.leaf(cases._potential(tree, s), s["dir_pos"], swap_u, take_u)
            for f, got, want in cases._pairs(plain, kern, entry, live, entry["active"]):
                if f in cases.FLAGS + ("n",):
                    flags_equal &= torch.equal(got, want)
                else:
                    err = max(err, _rel_leaf(got, want))
            same &= all(torch.equal(getattr(kern, f), getattr(again, f))
                        for f in cases.STATE + ("z_new", "n"))
    del plain, kern, again, s
    return err, flags_equal, same


def _graph_ms(fn) -> float:
    """``time_ms`` of a CUDA graph of ``fn``, run once eagerly first."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay)


def _nuts_leaf_rows(per_kernel):
    """K7 at LEAF_SHAPES: checked against the plain leaf on the card tests'
    random states (``_leaf_check``), then timed on live trees, both walks of
    LEAF_COUNT leaves captured in CUDA graphs, ms a leaf, beside the least
    bytes the leaves move."""
    import torch
    from brancher_torch.ops import NUTS_LEAF
    from brancher_torch.ops.nuts_leaf import leaf_bytes

    cases = _leaf_cases()
    gen = torch.Generator(device="cuda").manual_seed(21)
    for seed, (shape_name, (c, d)) in enumerate(LEAF_SHAPES.items(), start=21):
        err, flags_equal, deterministic = _leaf_check(cases, c, d, seed)
        ok = err <= TOL_LEAF and flags_equal
        torch.cuda.empty_cache()
        val0 = torch.zeros((c,), device="cuda")
        grad0 = torch.zeros((c, d), device="cuda")
        draws = [(torch.rand((c,), generator=gen, device="cuda") < 0.5,
                  torch.rand((c,), generator=gen, device="cuda"),
                  torch.rand((c,), generator=gen, device="cuda")) for _ in range(LEAF_COUNT)]

        def walk(tree, plain):
            tree.n.fill_(LEAF_FIRST)
            for dr in draws:
                (tree.plain_leaf if plain else tree.leaf)(lambda z: (val0, grad0), *dr)

        plain, kern = (_live_leaf_tree(c, d, 5) for _ in range(2))
        walk(kern, False)
        torch.cuda.synchronize()
        live = bool(kern.active.all()) and not bool(kern.s_failed.any())
        kdim = kern.r_ck.shape[0] - 1
        rows = range(LEAF_FIRST, LEAF_FIRST + LEAF_COUNT)
        flags = kern.flags.cpu()
        nbytes = sum(leaf_bytes(c, d, 4, int(flags[n, 2:].sum()), int(kern.slot[n]) < kdim)
                     for n in rows) // LEAF_COUNT
        row = {
            "phase": 2, "kernel": NUTS_LEAF.name, "shape": shape_name, "C": c, "N": None, "D": d,
            "tiling": list(NUTS_LEAF.tiling(d)), "leaves": [rows[0], rows[-1]],
            "max_rel": err, "flags_equal": flags_equal, "tolerance_rel": TOL_LEAF, "ok": ok,
            "deterministic": deterministic, "timed_all_live": live,
            "ms": _graph_ms(lambda: walk(kern, False)) / LEAF_COUNT,
            "plain_ms": _graph_ms(lambda: walk(plain, True)) / LEAF_COUNT, "library_ms": None,
            # the head alone, LEAF_COUNT times at the leaf after the walk (144, even)
            "head_ms": _graph_ms(lambda: [NUTS_LEAF.head(kern.leaf_args, kern.n, dr[0])
                                          for dr in draws]) / LEAF_COUNT,
            **_bound(nbytes, 0),
        }
        row["gb_per_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
        emit(row)
        per_kernel[NUTS_LEAF.name].append(row)
        check(ok, f"K7 at {shape_name} disagrees with the plain leaf: {err}, flags {flags_equal}")
        check(deterministic, f"K7 at {shape_name} is not bit-reproducible")
        check(live, f"K7 at {shape_name}: the timed tree did not stay live")
        del plain, kern, val0, grad0, draws
        torch.cuda.empty_cache()


def phase_kernels():
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    per_kernel = {k: [] for k in _all_kernels()}
    _glm_rows(gen, per_kernel)
    _leapfrog_rows(gen, per_kernel)
    _logreg_rows(gen, per_kernel)
    _ar_rows(per_kernel)
    _nuts_leaf_rows(per_kernel)
    _reset_launches()  # comparison launches do not count for the main path
    RESULTS["kernels"] = per_kernel


def _leaf_range(kw, d, draw_leaves):
    """(least, most) launches of K7 in a sample() run: 0 unless the kernel
    is NUTS on the vectorized engine, else one a leaf, the warmup's and the
    draws' (stage A's too under mass="dense").  The pipelined engine reports
    its draws' leaves as a whole number a draw, rounded up, so up to
    num_samples - 1 fewer ran."""
    from brancher_torch.inference import NUTS

    kernel = kw.get("kernel")
    if not isinstance(kernel, NUTS) or kw.get("chain_method", "vectorized") != "vectorized":
        return 0, 0
    parts = [(d.get("warmup_leapfrog") or 0, draw_leaves, kw["num_samples"])]
    if "dense_stage_a" in d:
        a = d["dense_stage_a"]
        parts.append((a["warmup_leapfrog"] or 0, a["sampling_leapfrog"], a["num_samples"]))
    most = sum(round(w) + s for w, s, _ in parts)
    slack = sum(n - 1 for _, _, n in parts) if kernel.pipelined else 0
    return most - slack, most


def _run_sample(model, tag, kernel_name, transition_kernel=None, **kw):
    """One sample() run with every launch counter at 0 before it; checks
    that the value+grad kernel ran once per value+grad call, the
    trajectory kernel (K5) once per transition, the NUTS leaf's (K7) once a
    leaf of the vectorized NUTS engine (``_leaf_range``), and no other
    kernel."""
    import torch
    from brancher_torch.inference import sample
    from brancher_torch.ops import NUTS_LEAF

    _reset_launches()
    gc.collect()  # an earlier phase's tensors held in reference cycles
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sample(model, device="cuda", **kw)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in _all_kernels().items()}
    d = res.diagnostics
    calls = d["value_and_grad_calls"]
    transitions = kw.get("num_warmup", 0) + kw["num_samples"]
    steps = int(res.stats["num_steps"][0].sum())
    leaves = _leaf_range(kw, d, steps)
    for name, count in launches.items():
        if name == NUTS_LEAF.name:
            check(leaves[0] <= count <= leaves[1],
                  f"{tag}: {name} launched {count} times, expected {leaves[0]}-{leaves[1]}")
            continue
        want = calls if name == kernel_name else transitions if name == transition_kernel else 0
        check(count == want, f"{tag}: {name} launched {count} times, expected {want}")
    check(kernel_name is None or calls > 0, f"{tag}: no value+grad call")
    check(d["fused_leapfrog"] == (transition_kernel is not None),
          f"{tag}: fused_leapfrog diagnostic is {d['fused_leapfrog']}")
    draws = res.stats["num_steps"].shape[1]
    info = {
        "run": tag, "kernel": kernel_name, "transition_kernel": transition_kernel,
        "launches": launches, "fused_family": d["fused_family"], "fused_dtype": d["fused_dtype"],
        "fused_leapfrog": d["fused_leapfrog"],
        "sampler_seconds": d["sampler_seconds"], "wall_seconds": wall,
        "value_and_grad_calls": calls, "warmup_leaf_iterations": d.get("warmup_leapfrog"),
        "sampling_leaf_iterations": steps, "leaves_per_draw": steps / draws,
        "host_syncs": d["host_syncs"], "host_syncs_per_draw": d["host_syncs"] / transitions,
        "sampler_ms_per_vg_call": d["sampler_seconds"] * 1e3 / max(calls, 1),
        "divergences": d["num_divergences"], "mean_accept": d["mean_accept_prob"],
        "step_size": float(torch.as_tensor(d["step_size"]).flatten()[0]),  # vmap: one a chain, all equal
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if "trajectory_length" in d:
        info["trajectory_length"] = float(d["trajectory_length"])
    if "dense_stage_a" in d:  # mass="dense": stage A's leaves apart from stage B's
        a = dict(d["dense_stage_a"])
        a["warmup_leaves_per_transition"] = (a["warmup_leapfrog"] or 0) / max(a["num_warmup"], 1)
        a["leaves_per_draw"] = a["sampling_leapfrog"] / a["num_samples"]
        info["stage_a"] = a
    if kw.get("chain_method") == "vmap":  # each leaf of the masked batch is one call
        info["value_and_grad_calls_per_transition"] = calls / max(transitions, 1)
    if "sampling_seconds" in d:  # NUTS: the draws' loop alone
        info["sampling_seconds"] = d["sampling_seconds"]
        info["sampling_ms_per_iteration"] = d["sampling_seconds"] * 1e3 / max(steps, 1)
    return res, info


def _post_stats(res, name):
    import numpy as np

    x = res.samples[name].double().cpu().numpy()
    ess = np.asarray(res.diagnostics["ess"][name], np.float64)
    mean = x.mean(axis=(0, 1))
    sd = x.std(axis=(0, 1))
    return mean, sd, ess, np.asarray(res.diagnostics["r_hat"][name], np.float64)


def _mcse_compare(phase, tag, ref, run, section):
    import numpy as np

    (m0, s0, e0), (m1, s1, e1) = ref, run
    z = np.abs(m1 - m0) / np.sqrt(s0**2 / e0 + s1**2 / e1)
    line = {"phase": phase, "compare": tag, "max_abs_diff": float(np.abs(m1 - m0).max()),
            "max_diff_in_mcse": float(z.max())}
    emit(line)
    RESULTS[section][tag] = line
    check(float(z.max()) < 5.0, f"{tag}: posterior means differ by {z.max():.2f} MCSE")


def _floor_model():
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    x, y, _ = make_logreg_data(1000, 32, seed=0)
    return x, y, logistic_regression_model(x, y)


def _floor_run(section, tag, kname, phase, draws, warmup=500, reduced=None, **kw):
    """One sample() run on the floor model (1024 chains): its line with
    min-ESS, min-ESS/s and R-hat over w; fails unless R-hat < 1.01 and the
    means are finite, and (after phase 3) holds the means within 5 MCSE of
    phase 3's "auto" run.  Returns (means, sds, ESS)."""
    import numpy as np

    _, _, model = _floor_model()
    res, info = _run_sample(model, f"{section}/{tag}", kname, num_warmup=warmup,
                            num_samples=draws, num_chains=1024, key=0, **kw)
    if (section, tag) == ("floor", "auto"):  # phase 14's WAIC and PSIS-LOO read these draws
        RESULTS["floor_auto_samples"] = {"w": res.samples["w"].cpu()}
    mean, sd, ess, rhat = _post_stats(res, "w")
    info.update({
        "phase": phase, "num_warmup": warmup, "num_samples": draws, "min_ess": float(ess.min()),
        "ess_per_second": float(ess.min()) / info["sampler_seconds"],
        "max_rhat": float(rhat.max()),
        **({"reduced": reduced} if reduced else {}),
    })
    emit(info)
    RESULTS.setdefault(section, {})[tag] = info
    if kname is not None:
        check(info["fused_family"] == "bernoulli_logit", f"{section}/{tag}: family {info['fused_family']}")
    check(info["max_rhat"] < 1.01, f"{section}/{tag}: max R-hat {info['max_rhat']}")
    check(bool(np.isfinite(mean).all()) and mean.shape == (32,), f"{section}/{tag}: bad means")
    if "floor_auto_moments" in RESULTS:  # phase 3 ran
        _mcse_compare(phase, f"{section}/{tag} vs floor/auto", RESULTS["floor_auto_moments"],
                      (mean, sd, ess), section)
    return mean, sd, ess


# the warmup of phase 3's "bf16" and "off" runs, cut from 500 for time
# ("reduced"; their ESS sat at its cap, R-hat 0.998; PERF.md)
FLOOR_SIDE_WARMUP = 250


def phase_floor():
    from brancher_torch.inference import NUTS

    runs = {}
    for tag, fp, kname, draws in (("auto", "auto", "glm_bernoulli_f32", 1000),
                                  ("bf16", "bf16", "glm_bernoulli_bf16", 250),
                                  ("off", "off", None, 250)):
        warmup = 500 if tag == "auto" else FLOOR_SIDE_WARMUP
        runs[tag] = _floor_run("floor", tag, kname, 3, draws, warmup=warmup,
                               kernel=NUTS(max_depth=8), fused_potential=fp,
                               reduced=None if warmup == 500 else {"num_warmup": [500, warmup]})
    for tag in ("auto", "bf16"):
        _mcse_compare(3, f"{tag} vs off", runs["off"], runs[tag], "floor")
    RESULTS["floor_auto_moments"] = runs["auto"]


def phase_conjugate():
    from brancher_torch.inference import NUTS
    from brancher_torch.models import conjugate_normal_model

    model, info = conjugate_normal_model()
    for tag, fp, kname in (("auto", "auto", "glm_normal_f32"), ("bf16", "bf16", "glm_normal_bf16")):
        res, run = _run_sample(model, f"conjugate/{tag}", kname, fused_potential=fp,
                               kernel=NUTS(max_depth=8), num_warmup=500, num_samples=1000,
                               num_chains=64, key=1)
        _check_conjugate(res, run, info, 4, f"conjugate/{tag}")
        RESULTS.setdefault("conjugate", {})[tag] = run


def _check_conjugate(res, run, info, phase, tag, family="normal_learned"):
    import numpy as np

    mean, sd, ess, rhat = _post_stats(res, "mu")
    mcse = float(sd / np.sqrt(ess))
    var_rel = float(sd**2 / info["post_var"] - 1.0)
    run.update({
        "phase": phase, "post_mean": float(mean), "closed_form_mean": float(info["post_mean"]),
        "mean_diff_in_mcse": abs(float(mean) - float(info["post_mean"])) / mcse,
        "post_var": float(sd**2), "closed_form_var": float(info["post_var"]),
        "var_rel_err": var_rel, "var_rel_tol": float(5 * np.sqrt(2.0 / ess)),
        "ess": float(ess), "ess_per_second": float(ess) / run["sampler_seconds"],
        "max_rhat": float(rhat),
    })
    emit(run)
    check(run["fused_family"] == family, f"{tag}: family {run['fused_family']}")
    check(run["mean_diff_in_mcse"] < 5.0, f"{tag}: mean off by {run['mean_diff_in_mcse']:.2f} MCSE")
    check(abs(var_rel) < run["var_rel_tol"], f"{tag}: variance off by {var_rel:.4f}")


def _probe_peak_gib(comp, prior_f) -> float:
    """Peak card memory (GiB above what was allocated) of the recognizer's
    diagonal-Gaussian probe of ``prior_f``."""
    import torch
    from brancher_torch.ops import glm

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    check(glm._diag_gaussian_prior(prior_f, comp.dim, comp.device) is not None,
          "the MXU-scale prior is not a diagonal Gaussian")
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def _linreg_model(x, w_true):
    """The linear-Gaussian regression of phase 5, from the ported DSL:
    w ~ N(0, 1) [D], sigma ~ LogNormal(0, 0.5), y ~ N(X w, sigma) with y =
    X w_true + 0.5 noise.  Its z is [sigma, w] (sorted keys), D + 1 wide."""
    import numpy as np
    import torch
    import brancher_torch as BT
    import brancher_torch.functions as BF

    d = x.shape[1]
    y = x @ w_true + 0.5 * np.random.RandomState(1).normal(size=x.shape[0]).astype(np.float32)
    w = BT.NormalVariable(torch.zeros(d), torch.ones(d), "w")
    sigma = BT.LogNormalVariable(0.0, 0.5, "sigma")
    yv = BT.NormalVariable(BF.matmul(torch.as_tensor(x), w), sigma, "y")
    yv.observe(y.astype(np.float32))
    return BT.ProbabilisticModel([yv])


def _mxu_runs(model, section, runs, family, setup, n, w_dim):
    """Phase 5's sample() runs of one model: 256 chains, NUTS(max_depth=5),
    10 warmup + 10 draws; finite draws of w [256, 10, w_dim] and the
    family.  Each run's D is its z's width."""
    import numpy as np
    from brancher_torch.inference import NUTS

    for tag, fp, kname in runs:
        res, run = _run_sample(model, f"{section}/{tag}", kname, fused_potential=fp,
                               kernel=NUTS(max_depth=5), num_warmup=10, num_samples=10,
                               num_chains=256, key=2)
        w = res.samples["w"]
        check(tuple(w.shape) == (256, 10, w_dim), f"{section}/{tag}: samples shape {tuple(w.shape)}")
        finite = all(bool(np.isfinite(v.float().cpu().numpy()).all()) for v in res.samples.values())
        check(finite, f"{section}/{tag}: non-finite samples")
        check(run["fused_family"] == family, f"{section}/{tag}: family {run['fused_family']}")
        run.update({"phase": 5, "data_setup_seconds": setup, "N": n,
                    "D": sum(int(np.prod(v.shape[2:])) for v in res.samples.values())})
        emit(run)
        RESULTS.setdefault(section, {})[tag] = run


def phase_mxu():
    import torch
    from brancher_torch.models import logistic_regression_model, make_logreg_data

    t0 = time.perf_counter()
    x, y, w_true = make_logreg_data(131072, 1024, seed=0)
    model = logistic_regression_model(x, y)
    setup = time.perf_counter() - t0
    comp = model.compiled("cuda")
    params = comp.initial_params
    probe = {
        "phase": 5, "run": "mxu/prior_probe",
        # the probe as it was: the whole log density, its likelihood dropped
        "whole_density_peak_gib": _probe_peak_gib(
            comp, lambda zf: comp.log_density_z_parts(params, comp.unravel_z(zf))[0]),
        # the probe as it is: the prior alone
        "prior_only_peak_gib": _probe_peak_gib(
            comp, lambda zf: comp.log_prior_z(params, comp.unravel_z(zf))),
    }
    emit(probe)
    RESULTS.setdefault("mxu", {})["prior_probe"] = probe
    _mxu_runs(model, "mxu", (("auto", "auto", "glm_bernoulli_f32"),
                             ("bf16", "bf16", "glm_bernoulli_bf16")),
              "bernoulli_logit", setup, 131072, 1024)
    del model, comp, params  # the compiled model holds its fused data and scratch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = _linreg_model(x, w_true)
    _mxu_runs(model, "mxu_linreg", (("auto", "auto", "glm_normal_f32"),
                                    ("bf16", "bf16", "glm_normal_bf16")),
              "normal_learned", time.perf_counter() - t0, 131072, 1024)


def phase_chees():
    import numpy as np
    import torch
    from brancher_torch.inference import ChEESHMC
    from brancher_torch.ops import logreg

    x, y, model = _floor_model()
    xd = torch.as_tensor(x, device="cuda")
    yd = torch.as_tensor(np.asarray(y, np.float32), device="cuda")
    base = dict(kernel=ChEESHMC(), num_warmup=500, num_samples=1000, num_chains=1024, key=3)
    for tag, kname, trans, kw in (
            ("fused", "glm_bernoulli_f32", "leapfrog_f32", {"fused_leapfrog": True}),
            ("loop", "glm_bernoulli_f32", None, {}),
            ("logreg", "logreg_f32", None,
             {"value_and_grad_fn": lambda w: logreg.logreg_value_and_grad(w, xd, yd, 1.0)})):
        res, info = _run_sample(model, f"chees/{tag}", kname, transition_kernel=trans, **base, **kw)
        mean, sd, ess, rhat = _post_stats(res, "w")
        info.update({
            "phase": 6, "num_samples": 1000, "min_ess": float(ess.min()),
            "ess_per_second": float(ess.min()) / info["sampler_seconds"],
            "max_rhat": float(rhat.max()),
        })
        emit(info)
        RESULTS.setdefault("chees", {})[tag] = info
        if tag == "fused":  # phase 17's sharded ChEES is held to these
            RESULTS["chees_fused_moments"] = (mean, sd, ess)
        check(info["max_rhat"] < 1.01, f"chees/{tag}: max R-hat {info['max_rhat']}")
        check(bool(np.isfinite(mean).all()) and mean.shape == (32,), f"chees/{tag}: bad means")
        if "floor_auto_moments" in RESULTS:  # phase 3 ran
            _mcse_compare(6, f"chees/{tag} vs nuts/auto", RESULTS["floor_auto_moments"],
                          (mean, sd, ess), "chees")


def phase_hmc():
    import numpy as np
    from brancher_torch.inference import HMC
    from brancher_torch.models import conjugate_normal_model

    model, info = conjugate_normal_model()
    res, run = _run_sample(model, "hmc_conjugate/fused", "glm_normal_f32",
                           transition_kernel="leapfrog_f32", kernel=HMC(num_integration_steps=16),
                           fused_leapfrog=True, num_warmup=500, num_samples=1000,
                           num_chains=64, key=4)
    # HMC's num_steps stat is the JAX package's (L+1)//2, not the drawn counts
    run["leaves_per_draw_is"] = "jax_estimate"
    _check_conjugate(res, run, info, 7, "hmc_conjugate/fused")
    RESULTS["hmc_conjugate"] = {"fused": run}

    # a long trajectory on the floor model, where K5 does most of the work
    _, _, model = _floor_model()
    warmup, draws = 100, 200
    res, run = _run_sample(model, "hmc_floor/fused", "glm_bernoulli_f32",
                           transition_kernel="leapfrog_f32",
                           kernel=HMC(num_integration_steps=HMC_FLOOR_STEPS), fused_leapfrog=True,
                           num_warmup=warmup, num_samples=draws, num_chains=1024, key=5)
    mean, sd, ess, rhat = _post_stats(res, "w")
    run.update({
        "phase": 7, "num_samples": draws, "leaves_per_draw_is": "jax_estimate",
        "sampler_ms_per_transition": run["sampler_seconds"] * 1e3 / (warmup + draws),
        "k5_launches": run["launches"]["leapfrog_f32"], "min_ess": float(ess.min()),
        "ess_per_second": float(ess.min()) / run["sampler_seconds"],
        "max_rhat": float(rhat.max()),
    })
    emit(run)
    RESULTS["hmc_floor"] = {"fused": run}
    check(run["fused_family"] == "bernoulli_logit", f"hmc_floor: family {run['fused_family']}")
    check(run["max_rhat"] < 1.01, f"hmc_floor: max R-hat {run['max_rhat']}")
    check(bool(np.isfinite(mean).all()) and mean.shape == (32,), "hmc_floor: bad means")
    if "floor_auto_moments" in RESULTS:  # phase 3 ran
        _mcse_compare(7, "hmc_floor/fused vs nuts/auto", RESULTS["floor_auto_moments"],
                      (mean, sd, ess), "hmc_floor")


ARD_N, ARD_D, ARD_TAU_SD = 100, 32, 0.75
# bench.py's ARD_DRAWS, not cut although the phase took 300-470 s on an
# H100 with the potential run eagerly (126 leaves a transition at 1.0-1.5
# ms): where the slowest coordinate's autocorrelation time tau is 12-16
# draws, as on the card, split R-hat reads about 1 + (tau - 1) / draws, and
# 1400 draws read 1.0114, over the 1.01 limit (PERF.md).  A cut would be
# printed as "reduced" in phase 8's line.
ARD_DRAWS = 2000
ARD_WARMUP = 500
# the chains on which phase 8 holds the device diagnostics to the host's:
# the host's numpy took 12.2-14.7 s over all 1024 (PERF.md)
ARD_DIAG_CHAINS = 256


def _ard_model_and_potential():
    """bench.py:195-227: the non-centered ARD model from the ported DSL and
    bench's hand-fused value+grad of its z-density, z = [log tau, w_raw],
    replayed from a CUDA graph as bench jit-compiles it (the same kernels
    on the same numbers; the eager call is the wrapper's ``fn``)."""
    import numpy as np
    import torch
    import brancher_torch as BT
    import brancher_torch.functions as BF
    from brancher_torch.inference.hmc import GraphedValueAndGrad
    from brancher_torch.models import make_logreg_data

    x, y, _ = make_logreg_data(ARD_N, ARD_D, seed=0)
    tau = BT.LogNormalVariable(torch.zeros(ARD_D), ARD_TAU_SD * torch.ones(ARD_D), "tau")
    w = BT.NonCenteredNormalVariable(0.0, tau, name="w", shape=(ARD_D,))
    yv = BT.BernoulliVariable(logits=BF.matmul(torch.as_tensor(x), w), name="y")
    yv.observe(y)
    xt = torch.as_tensor(x, device="cuda")
    yt = torch.as_tensor(np.asarray(y, np.float32), device="cuda")
    sd2 = ARD_TAU_SD**2

    def fused(zc):
        v, wr = zc[:, :ARD_D], zc[:, ARD_D:]
        tau_ = torch.exp(v)
        logits = (wr * tau_) @ xt.T
        ll = torch.sum(yt * logits - torch.nn.functional.softplus(logits), -1)
        val = ll - 0.5 * torch.sum(v * v, -1) / sd2 - 0.5 * torch.sum(wr * wr, -1)
        s = (yt - torch.sigmoid(logits)) @ xt
        return val, torch.cat([s * wr * tau_ - v / sd2, s * tau_ - wr], -1)

    return BT.ProbabilisticModel([yv]), GraphedValueAndGrad(fused)


def phase_ard():
    import numpy as np
    import torch
    from brancher_torch.inference import NUTS
    from brancher_torch.inference import diagnostics as dg
    from brancher_torch.inference.mcmc import autodiff_value_and_grad, make_potential

    model, fused = _ard_model_and_potential()
    comp = model.compiled("cuda")
    potential, _, _ = make_potential(comp, comp.initial_params)
    zp = 0.5 * torch.randn((3, 2 * ARD_D), generator=torch.Generator("cuda").manual_seed(9),
                           device="cuda")
    va, ga = autodiff_value_and_grad(potential)(zp)
    vf, gf = fused(zp)
    const_sd = float(torch.std(vf - va))
    grad_ok = bool(torch.all(torch.abs(gf - ga) <= 2e-3 * (1.0 + torch.abs(ga))))
    check(const_sd < 1e-2 and grad_ok,
          f"ard: the fused potential disagrees with autodiff (sd {const_sd}, grad_ok {grad_ok})")
    # the replayed graph against the eager call, bit for bit, at the run's shape
    zc = 0.5 * torch.randn((1024, 2 * ARD_D), generator=torch.Generator("cuda").manual_seed(10),
                           device="cuda")
    graph_same = all(torch.equal(a, b) for a, b in zip(fused(zc), fused.fn(zc)))
    check(graph_same and len(fused.graphs) == 2 and not fused.eager_shapes,
          f"ard: the graphed potential ({len(fused.graphs)} graphs) differs from its eager call")
    potential_ms = {"graphed": time_ms(lambda: fused(zc)), "eager": time_ms(lambda: fused.fn(zc))}

    res, run = _run_sample(model, "ard/fused", None, kernel=NUTS(max_depth=8),
                           num_warmup=ARD_WARMUP, num_samples=ARD_DRAWS, num_chains=1024, key=6,
                           target_accept=0.95, value_and_grad_fn=fused, ess_vars=["w", "tau"])
    d = res.diagnostics
    check(run["fused_family"] is None, f"ard: the recognizer took it as {run['fused_family']}")
    ess = np.concatenate([np.ravel(d["ess"][n]) for n in ("w", "tau")])
    rhat = np.concatenate([np.ravel(d["r_hat"][n]) for n in ("w", "tau")])

    # the device diagnostics against the host ones, on the same draws (the
    # first ARD_DIAG_CHAINS chains)
    draws = [res.samples[n][:ARD_DIAG_CHAINS] for n in ("w", "tau")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev = [(dg.effective_sample_size_device(x), dg.potential_scale_reduction_device(x)) for x in draws]
    dev = [(e.cpu().numpy(), r.cpu().numpy()) for e, r in dev]
    device_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [(dg.effective_sample_size(x.cpu().numpy()), dg.potential_scale_reduction(x.cpu().numpy()))
            for x in draws]
    host_s = time.perf_counter() - t0
    ess_rel = max(float(np.max(np.abs(e / he - 1.0))) for (e, _), (he, _) in zip(dev, host))
    rhat_abs = max(float(np.max(np.abs(r - hr))) for (_, r), (_, hr) in zip(dev, host))
    run.update({
        "phase": 8, "N": ARD_N, "D": ARD_D, "chains": 1024, "num_warmup": ARD_WARMUP,
        "num_samples": ARD_DRAWS, "min_ess": float(ess.min()),
        "ess_cap": float(1024 * ARD_DRAWS), "ess_per_second": float(ess.min()) / run["sampler_seconds"],
        "max_rhat": float(rhat.max()), "diagnostics_backend": d["diagnostics_backend"],
        "fused_potential_const_sd": const_sd, "potential_graphed": True,
        "graph_vs_eager_bit_identical": graph_same, "capture_seconds": fused.capture_seconds,
        "potential_ms": potential_ms,
        "device_diag_seconds": device_s,
        "host_diag_seconds": host_s, "diag_chains": ARD_DIAG_CHAINS,
        "device_vs_host_ess_max_rel": ess_rel,
        "device_vs_host_rhat_max_abs": rhat_abs,
        **({"reduced": {"num_samples": [2000, ARD_DRAWS]}} if ARD_DRAWS != 2000 else {}),
    })
    emit(run)
    RESULTS["ard"] = {"fused": run}
    RESULTS.setdefault("resume_states", {})["ard/fused"] = d["resume_state"]
    check(d["diagnostics_backend"] == "device", f"ard: diagnostics ran on {d['diagnostics_backend']}")
    check(run["max_rhat"] < 1.01, f"ard: max R-hat {run['max_rhat']}")
    check(ess_rel <= 0.05, f"ard: device ESS {ess_rel:.4f} from the host's")
    check(rhat_abs <= 1e-3, f"ard: device R-hat {rhat_abs:.2e} from the host's")


def _run_svi(tag, model, iterations, benchmark, **kw):
    """One perform_inference run with every launch counter at 0 before it
    (no kernel is on the SVI paths).  With ``benchmark`` the step loop runs
    three more times from the same start and its best time gives the
    steps/s (perform_inference._benchmark); without, the call's own wall
    time, setup included, ended by a device synchronize."""
    import numpy as np
    import torch
    from brancher_torch.inference import perform_inference

    _reset_launches()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    perform_inference._benchmark = benchmark
    try:
        t0 = time.perf_counter()
        res = perform_inference(model, number_iterations=iterations, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        perform_inference._benchmark = False
    launches = {name: k.launches for name, k in _all_kernels().items()}
    check(not any(launches.values()), f"{tag}: a kernel launched on the SVI path: {launches}")
    curve = np.asarray(res.loss_curve, np.float64)
    first, last = float(curve[:100].mean()), float(curve[-100:].mean())
    loop_s = perform_inference._last_run_seconds if benchmark else wall
    info = {
        "run": tag, "launches": launches, "number_iterations": iterations,
        "timed": "best of 3 step loops" if benchmark else "one call, setup included",
        "loop_seconds": loop_s, "elbo_steps_per_sec": iterations / loop_s,
        "wall_seconds": wall,
        "loss_first_100_mean": first, "loss_last_100_mean": last,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "tf32": torch.backends.cuda.matmul.allow_tf32,
    }
    check(bool(np.isfinite(curve).all()), f"{tag}: non-finite loss")
    check(last < first, f"{tag}: the loss did not fall ({first} -> {last})")
    return res, info


def phase_svi_floor():
    import numpy as np

    _, _, model = _floor_model()
    res, info = _run_svi("svi_floor/meanfield", model, 1500, False, number_samples=16, lr=0.02,
                         key=7)
    loc = res.guide.posterior_moments(res.params["q"])[0].cpu().numpy()
    info.update({"phase": 9, "guide": type(res.guide).__name__, "number_samples": 16})
    check(bool(np.isfinite(loc).all()) and loc.shape == (32,), "svi_floor: bad loc")
    if "floor_auto_moments" in RESULTS:  # phase 3 ran
        info["max_abs_diff_to_nuts_mean"] = float(np.abs(loc - RESULTS["floor_auto_moments"][0]).max())
        info["tolerance"] = 0.15
    emit(info)
    RESULTS["svi_floor"] = {"meanfield": info}
    if "tolerance" in info:
        check(info["max_abs_diff_to_nuts_mean"] < 0.15,
              f"svi_floor: loc {info['max_abs_diff_to_nuts_mean']:.3f} from the NUTS means")


def phase_vae():
    from brancher_torch.models import VAEConfig, make_vae_data, vae_model

    data = make_vae_data(num_points=4096, obs_dim=64)
    p_model, _ = vae_model(data, VAEConfig(latent_dim=8, hidden_dim=64, batch_size=256))
    _, info = _run_svi("vae", p_model, 500, True, number_samples=1, lr=1e-3, key=3)
    info.update({"phase": 10, "num_points": 4096, "obs_dim": 64, "latent": 8, "hidden": 64,
                 "batch": 256, "number_samples": 1})
    emit(info)
    RESULTS["vae"] = {"adam": info}


def _ar_run(model, section, tag, kname, trans=None, phase=11, reduced=None, **kw):
    """One sample() run on an AR model (AR_CHAINS chains, AR_WARMUP +
    AR_DRAWS unless given): the run's line with min-ESS, min-ESS/s and
    R-hat over [coefficients, noise scale]; fails unless R-hat < 1.01, the
    draws are finite and a fused run recognized normal_learned.  Returns
    (means, sds, ESS) for the MCSE comparisons."""
    import numpy as np

    kw = {"num_warmup": AR_WARMUP, "num_samples": AR_DRAWS, **kw}
    res, info = _run_sample(model, f"{section}/{tag}", kname, transition_kernel=trans,
                            num_chains=AR_CHAINS, **kw)
    RESULTS.setdefault("resume_states", {})[f"{section}/{tag}"] = res.diagnostics["resume_state"]
    parts = [_post_stats(res, n) for n in ("coeffs", "noise_scale")]
    mean, sd, ess, rhat = (np.concatenate([np.ravel(p[i]) for p in parts]) for i in range(4))
    info.update({
        "phase": phase, "chains": AR_CHAINS, "num_warmup": kw["num_warmup"],
        "num_samples": kw["num_samples"],
        "post_mean": mean.tolist(), "post_sd": sd.tolist(), "min_ess": float(ess.min()),
        "ess_per_second": float(ess.min()) / info["sampler_seconds"],
        "max_rhat": float(rhat.max()),
        **({"reduced": reduced} if reduced else {}),
    })
    emit(info)
    RESULTS.setdefault(section, {})[tag] = info
    if kname is not None:
        check(info["fused_family"] == "normal_learned",
              f"{section}/{tag}: family {info['fused_family']}")
    check(bool(np.isfinite(mean).all()), f"{section}/{tag}: non-finite means")
    check(info["max_rhat"] < 1.01, f"{section}/{tag}: max R-hat {info['max_rhat']}")
    return mean, sd, ess


def _ar_least_squares(data, order):
    """[coefficients, residual sd] of the series' least-squares AR fit."""
    import numpy as np

    x = np.asarray(data, np.float64)
    lags = np.stack([x[order - 1 - i:len(x) - 1 - i] for i in range(order)], axis=-1)
    c, *_ = np.linalg.lstsq(lags, x[order:], rcond=None)
    return np.concatenate([c, [np.sqrt(np.mean((x[order:] - lags @ c) ** 2))]])


def phase_ar():
    import numpy as np
    from brancher_torch.inference import NUTS, ChEESHMC
    from brancher_torch.models import ar_model, make_ar_data

    length, coeffs = AR_DATA[1]
    model = ar_model(make_ar_data(length, coeffs, AR_NOISE, seed=0), 1)
    runs = {}
    for tag, fp, kname in (("auto", "auto", "glm_normal_f32"), ("bf16", "bf16", "glm_normal_bf16"),
                           ("off", "off", None)):
        runs[tag] = _ar_run(model, "ar1", tag, kname, kernel=NUTS(max_depth=8),
                            fused_potential=fp, key=11, num_samples=AR1_DRAWS,
                            reduced={"num_samples": [AR_DRAWS, AR1_DRAWS]})
    for tag in ("auto", "bf16"):
        _mcse_compare(11, f"ar1/{tag} vs off", runs["off"], runs[tag], "ar1")
    RESULTS["ar1_off_moments"] = runs["off"]
    chees = _ar_run(model, "ar1_chees", "fused", "glm_normal_f32", trans="leapfrog_f32",
                    kernel=ChEESHMC(), fused_leapfrog=True, key=12)
    _mcse_compare(11, "ar1_chees/fused vs ar1/off", runs["off"], chees, "ar1_chees")

    # AR(2): against the least-squares fit, which the posterior mean sits
    # within a few hundredths of a posterior sd of at T=1000 (the prior's
    # pull and the noise scale's O(1/T) offset)
    length, coeffs = AR_DATA[2]
    data = make_ar_data(length, coeffs, AR_NOISE, seed=0)
    mean, sd, ess = _ar_run(ar_model(data, 2), "ar2", "auto", "glm_normal_f32",
                            kernel=NUTS(max_depth=8), fused_potential="auto", key=13,
                            num_warmup=AR2_WARMUP, num_samples=AR2_DRAWS,
                            reduced={"num_warmup": [AR_WARMUP, AR2_WARMUP],
                                     "num_samples": [AR_DRAWS, AR2_DRAWS]})
    RESULTS["ar2_auto_moments"] = (mean, sd, ess)
    lsq = _ar_least_squares(data, 2)
    line = {"phase": 11, "compare": "ar2/auto vs least squares", "least_squares": lsq.tolist(),
            "max_diff_in_post_sd": float(np.max(np.abs(mean - lsq) / sd)), "limit": 0.5}
    emit(line)
    RESULTS["ar2"]["vs least squares"] = line
    check(line["max_diff_in_post_sd"] < 0.5,
          f"ar2: posterior means {line['max_diff_in_post_sd']:.2f} sd from least squares")


# phase 13's ARD run under the pipelined engine: phase 8's model, chains and
# key, its draws cut from phase 8's ARD_DRAWS for time (printed as "reduced"
# in its line): with 500 draws the whole script took 967 s on an H100, too
# near its 1200 s limit for a slower host, and with 300 (52.6 s of the run)
# and phase 17 added it took 1124.4 s on a slow host (PERF.md).  Where phase 8 ran, the
# run resumes from phase 8's resume_state with no warmup, also printed as
# "reduced": the pipelined engine warms up with the lockstep engine, so its
# 500 warmup transitions (about 79 s of the run's 129 s on an H100) repeat
# phase 8's warmup at the same key.  With phase 18 added the script read
# 1186.3 s (150 draws: 27.4 s, R-hat 1.0034), so 100.
ARD13_DRAWS = 100
# the pipelined floor's warmup and draws, cut from phase 3's 500 + 1000 for
# time ("reduced"; its ESS sits at the cap, and phase 18 reruns the engine
# bit for bit), and the per-chain engine's conjugate run, cut from 500 +
# 1000 (its ESS read 4.7k of 64k draws, R-hat 1.0008; PERF.md)
PIPELINED_FLOOR_WARMUP, PIPELINED_FLOOR_DRAWS = 250, 300
CONJUGATE_VMAP_DEPTH = (250, 500)


def _roundtrip(state):
    """A resume_state through torch.save and torch.load."""
    import io
    import torch

    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    return torch.load(buf)


def _lsq_check(section, tag, mean, sd, lsq):
    import numpy as np

    line = {"phase": 13, "compare": f"{section}/{tag} vs least squares",
            "least_squares": lsq.tolist(),
            "max_diff_in_post_sd": float(np.max(np.abs(mean - lsq) / sd)), "limit": 0.5}
    emit(line)
    RESULTS[section][f"{tag} vs least squares"] = line
    check(line["max_diff_in_post_sd"] < 0.5,
          f"{section}/{tag}: posterior means {line['max_diff_in_post_sd']:.2f} sd from least squares")


def phase_modes():
    import numpy as np
    from brancher_torch.inference import NUTS, ChEESHMC
    from brancher_torch.models import ar_model, conjugate_normal_model, make_ar_data

    # AR(2) under dense mass: stage A (diagonal) and the whitened stage B,
    # both on K3; then resumed from its checkpoint with no warmup
    length, coeffs = AR_DATA[2]
    data = make_ar_data(length, coeffs, AR_NOISE, seed=0)
    ar2 = ar_model(data, 2)
    lsq = _ar_least_squares(data, 2)
    mean, sd, _ = _ar_run(ar2, "ar2_dense", "auto", "glm_normal_f32", phase=13,
                          kernel=NUTS(max_depth=8), mass="dense", key=14, num_samples=AR2_DRAWS,
                          reduced={"num_samples": [AR_DRAWS, AR2_DRAWS]})
    _lsq_check("ar2_dense", "auto", mean, sd, lsq)
    rs = _roundtrip(RESULTS["resume_states"]["ar2_dense/auto"])
    mean, sd, _ = _ar_run(ar2, "ar2_dense", "resume", "glm_normal_f32", phase=13,
                          kernel=NUTS(max_depth=8), mass="dense", resume_state=rs, num_warmup=0,
                          num_samples=400, key=15)
    _lsq_check("ar2_dense", "resume", mean, sd, lsq)
    run = RESULTS["ar2_dense"]["resume"]
    check(run["warmup_leaf_iterations"] == 0 and "stage_a" not in run,
          "ar2_dense/resume: the resumed run warmed up")
    check(run["mean_accept"] > 0.5, f"ar2_dense/resume: mean accept {run['mean_accept']}")

    # the draw-pipelined engine on AR(2) (K3) and the floor (K1)
    mean, sd, ess = _ar_run(ar2, "ar2_pipelined", "auto", "glm_normal_f32", phase=13,
                            kernel=NUTS(max_depth=8, pipelined=True), key=16,
                            num_warmup=AR2_WARMUP, num_samples=AR2_DRAWS,
                            reduced={"num_warmup": [AR_WARMUP, AR2_WARMUP],
                                     "num_samples": [AR_DRAWS, AR2_DRAWS]})
    _lsq_check("ar2_pipelined", "auto", mean, sd, lsq)
    if "ar2_auto_moments" in RESULTS:  # phase 11 ran
        _mcse_compare(13, "ar2_pipelined/auto vs ar2/auto", RESULTS["ar2_auto_moments"],
                      (mean, sd, ess), "ar2_pipelined")
    _floor_run("floor_pipelined", "auto", "glm_bernoulli_f32", 13, PIPELINED_FLOOR_DRAWS,
               warmup=PIPELINED_FLOOR_WARMUP, kernel=NUTS(max_depth=8, pipelined=True),
               reduced={"num_warmup": [500, PIPELINED_FLOOR_WARMUP],
                        "num_samples": [1000, PIPELINED_FLOOR_DRAWS]})

    # AR(1) ChEES resumed with K5, its adapted trajectory length carried
    length, coeffs = AR_DATA[1]
    ar1 = ar_model(make_ar_data(length, coeffs, AR_NOISE, seed=0), 1)
    chees = dict(kernel=ChEESHMC(), fused_leapfrog=True)
    if "ar1_chees/fused" not in RESULTS.get("resume_states", {}):  # phase 11 did not run
        _ar_run(ar1, "ar1_chees", "fused", "glm_normal_f32", trans="leapfrog_f32", phase=13,
                key=12, **chees)
    rs = _roundtrip(RESULTS["resume_states"]["ar1_chees/fused"])
    moments = _ar_run(ar1, "ar1_chees", "resume", "glm_normal_f32", trans="leapfrog_f32",
                      phase=13, resume_state=rs, num_warmup=0, num_samples=400, key=17, **chees)
    run = RESULTS["ar1_chees"]["resume"]
    traj = float(rs["trajectory_length"])
    run["trajectory_length_rel_diff"] = abs(run["trajectory_length"] / traj - 1.0)
    check(run["trajectory_length_rel_diff"] <= 1e-6,
          f"ar1_chees/resume: trajectory length {run['trajectory_length']} against {traj}")
    if "ar1_off_moments" in RESULTS:  # phase 11 ran
        _mcse_compare(13, "ar1_chees/resume vs ar1/off", RESULTS["ar1_off_moments"], moments,
                      "ar1_chees")

    # the per-chain engines (no kernel): the floor, depth cut for time, and
    # the conjugate model against its closed form
    _floor_run("floor_vmap", "auto", None, 13, 200, warmup=200, kernel=NUTS(max_depth=8),
               chain_method="vmap")
    model, info = conjugate_normal_model()
    warm, draws = CONJUGATE_VMAP_DEPTH
    res, run = _run_sample(model, "conjugate_vmap/auto", None, kernel=NUTS(max_depth=8),
                           chain_method="vmap", num_warmup=warm, num_samples=draws, num_chains=64,
                           key=1)
    run["reduced"] = {"num_warmup": [500, warm], "num_samples": [1000, draws]}
    RESULTS["conjugate_vmap"] = {"auto": run}
    _check_conjugate(res, run, info, 13, "conjugate_vmap/auto", family=None)
    check(run["max_rhat"] < 1.01, f"conjugate_vmap/auto: R-hat {run['max_rhat']}")

    # phase 8's ARD under the pipelined engine (no kernel), resumed from
    # phase 8's run where it ran
    model, fused = _ard_model_and_potential()
    rs = RESULTS.get("resume_states", {}).get("ard/fused")
    warmup = ARD_WARMUP if rs is None else 0
    res, run = _run_sample(model, "ard_pipelined/fused", None,
                           kernel=NUTS(max_depth=8, pipelined=True), num_warmup=warmup,
                           num_samples=ARD13_DRAWS, num_chains=1024, key=6, target_accept=0.95,
                           value_and_grad_fn=fused, ess_vars=["w", "tau"], resume_state=rs)
    d = res.diagnostics
    ess = np.concatenate([np.ravel(d["ess"][n]) for n in ("w", "tau")])
    rhat = np.concatenate([np.ravel(d["r_hat"][n]) for n in ("w", "tau")])
    run.update({
        "phase": 13, "chains": 1024, "num_warmup": warmup, "num_samples": ARD13_DRAWS,
        "min_ess": float(ess.min()), "ess_cap": float(1024 * ARD13_DRAWS),
        "ess_per_second": float(ess.min()) / run["sampler_seconds"], "max_rhat": float(rhat.max()),
        "mean_live_leapfrogs_per_draw": float(d["chain_leapfrog"].mean()),
        "reduced": {"num_samples": [ARD_DRAWS, ARD13_DRAWS],
                    **({"num_warmup": [ARD_WARMUP, 0], "resumed_from": "ard/fused (phase 8)"}
                       if rs is not None else {})},
    })
    if "ard" in RESULTS:  # phase 8 ran: its lockstep leaves and ms a leaf beside these
        lock = RESULTS["ard"]["fused"]
        run["lockstep"] = {k: lock[k] for k in ("leaves_per_draw", "sampling_ms_per_iteration",
                                                "sampler_ms_per_vg_call", "ess_per_second")}
    emit(run)
    RESULTS["ard_pipelined"] = {"fused": run}
    check(run["max_rhat"] < 1.01, f"ard_pipelined: max R-hat {run['max_rhat']}")


def _lgssm_ssm_of_theta(theta):
    """tests/test_pmmh.py's LGSSM with a = tanh(theta[0]) unknown, over the
    chains of theta [C, D] (the port's batched StateSpace)."""
    import torch
    from brancher_torch.inference.smc import StateSpace
    from brancher_torch.models import LGSSMParams

    a = torch.tanh(theta[:, 0])[:, None]
    p = LGSSMParams()

    def randn(g, shape):
        return torch.randn(tuple(shape), generator=g, device=g.device)

    return StateSpace(
        init_sample=lambda g, shape: math.sqrt(p.init_var) * randn(g, shape),
        init_log_prob=lambda x: -0.5 * x * x / p.init_var,
        trans_sample=lambda g, xp, t: a * xp + math.sqrt(p.q) * randn(g, xp.shape),
        trans_log_prob=lambda x, xp, t: -0.5 * (x - a * xp) ** 2 / p.q,
        obs_log_prob=lambda y, x, t: -0.5 * (y - p.c * x) ** 2 / p.r
        - 0.5 * math.log(2 * math.pi * p.r),
    )


def _kalman_grid(ys):
    """The exact posterior mean and sd of a (tests/test_pmmh.py:33-48): the
    Kalman likelihood on a grid, theta ~ N(0, 1.5^2), a = tanh(theta)."""
    import numpy as np
    from brancher_torch.models import LGSSMParams, kalman_filter

    grid = np.linspace(0.5, 0.995, 120)
    lls = np.asarray([kalman_filter(ys, LGSSMParams(a=float(a)))[0] for a in grid])
    logp = lls - 0.5 * (np.arctanh(grid) / 1.5) ** 2 - np.log1p(-grid**2)
    w = np.exp(logp - logp.max())
    w /= w.sum()
    mean = float((w * grid).sum())
    return mean, float(np.sqrt((w * (grid - mean) ** 2).sum()))


def _particle_run(tag, fn, phase=12):
    """One particle-method run with every launch counter at 0 before it (no
    kernel is on these paths), timed to a device synchronize."""
    import torch

    _reset_launches()
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in _all_kernels().items()}
    check(not any(launches.values()), f"{tag}: a kernel launched on a particle path: {launches}")
    return out, {"phase": phase, "run": tag, "seconds": seconds, "launches": launches}


def _grid_check(tag, info, a_draws, accept, grid, accept_range, section="particles"):
    """PMMH and PGAS against the Kalman grid, the JAX tests' limits."""
    mean_a, sd_a = grid
    info.update({"a_mean": float(a_draws.mean()), "a_sd": float(a_draws.std()),
                 "grid_mean": mean_a, "grid_sd": sd_a, "accept_rate": accept,
                 "mean_diff_in_grid_sd": abs(float(a_draws.mean()) - mean_a) / sd_a})
    emit(info)
    RESULTS.setdefault(section, {})[tag] = info
    check(accept_range[0] < accept < accept_range[1], f"{tag}: accept rate {accept}")
    check(info["mean_diff_in_grid_sd"] < 2.5, f"{tag}: mean of a off the Kalman grid's")
    check(0.3 * sd_a < info["a_sd"] < 3.5 * sd_a, f"{tag}: sd of a {info['a_sd']} against {sd_a}")


def phase_particles():
    import numpy as np
    import torch
    from brancher_torch.inference import (
        particle_gibbs_sample, pmmh_sample, smc_posterior_sample, smc_sample,
        streaming_particle_filter,
    )
    from brancher_torch.models import (
        LGSSMParams, conjugate_normal_model, kalman_filter, lgssm_state_space, make_lgssm_data,
    )

    RESULTS["particles"] = {}
    params = LGSSMParams()
    ssm = lgssm_state_space(params)

    # the bootstrap filter at examples/04_state_space_smc.py:17-21's config,
    # held to tests/test_smc.py:28-38's limits
    t_len, p = 200, 8192
    _, ys = make_lgssm_data(t_len, params)
    ll, means, _ = kalman_filter(ys, params)
    res, info = _particle_run("particles/bootstrap", lambda: smc_sample(
        ssm, ys, num_particles=p, key=21, device="cuda"))
    info.update({"T": t_len, "particles": p, "particle_steps_per_second": p * t_len / info["seconds"],
                 "log_marginal": float(res.log_marginal), "kalman_log_marginal": float(ll),
                 "max_filter_mean_err": float(np.abs(res.filter_means.cpu().numpy() - means).max()),
                 "min_ess": float(res.ess_history.min())})
    emit(info)
    RESULTS["particles"]["bootstrap"] = info
    check(abs(info["log_marginal"] - ll) < 0.5, "bootstrap: log-marginal off Kalman's")
    check(info["max_filter_mean_err"] < 0.08, "bootstrap: filter means off Kalman's")
    check(info["min_ess"] > 100, "bootstrap: ESS collapsed")

    # the streaming filter, tests/test_smc.py:144-167's config and limits
    t_len, p = 300, 2048
    xs_true, ys = make_lgssm_data(t_len, params, seed=0)
    kl, km, _ = kalman_filter(ys, params)
    res, info = _particle_run("particles/streaming", lambda: streaming_particle_filter(
        ssm, ys, num_particles=p, key=22, lag=16, chunk_size=64, device="cuda"))
    fm, sm = res.filter_means.ravel(), res.smoothed_means.ravel()
    info.update({"T": t_len, "particles": p, "lag": 16, "chunk": 64,
                 "particle_steps_per_second": p * t_len / info["seconds"],
                 "log_marginal": float(res.log_marginal), "kalman_log_marginal": float(kl),
                 "max_filter_mean_err": float(np.abs(fm - km).max()),
                 "rmse_filter": float(np.sqrt(((fm - xs_true) ** 2).mean())),
                 "rmse_smoothed": float(np.sqrt(((sm - xs_true) ** 2).mean()))})
    emit(info)
    RESULTS["particles"]["streaming"] = info
    check(info["max_filter_mean_err"] < 0.15, "streaming: filter means off Kalman's")
    check(abs(info["log_marginal"] - kl) < 2.0, "streaming: log-marginal off Kalman's")
    check(info["rmse_smoothed"] < info["rmse_filter"], "streaming: smoothing did not help")

    # tempered SMC on the conjugate model, tests/test_tempered_smc.py:13-27
    model, truth = conjugate_normal_model(num_obs=20)
    n = len(truth["data"])
    cov = np.eye(n) + 4.0 * np.ones((n, n))
    logz = float(-0.5 * truth["data"] @ np.linalg.solve(cov, truth["data"])
                 - 0.5 * np.linalg.slogdet(2 * np.pi * cov)[1])
    (samples, res), info = _particle_run("particles/tempered", lambda: smc_posterior_sample(
        model, num_particles=2048, key=23, device="cuda"))
    mu = samples["mu"].double().cpu().numpy()
    info.update({"particles": 2048, "stages": res.num_stages, "post_mean": float(mu.mean()),
                 "closed_form_mean": float(truth["post_mean"]), "post_var": float(mu.var()),
                 "closed_form_var": float(truth["post_var"]),
                 "log_evidence": float(res.log_evidence), "exact_log_evidence": logz})
    emit(info)
    RESULTS["particles"]["tempered"] = info
    check(abs(info["post_mean"] - truth["post_mean"]) < 0.05, "tempered: posterior mean")
    check(abs(info["post_var"] - truth["post_var"]) < 0.03, "tempered: posterior variance")
    check(res.num_stages >= 2, "tempered: one stage")
    check(abs(info["log_evidence"] - logz) < 0.3, "tempered: log evidence")

    # PMMH and PGAS on a = tanh(theta), tests/test_pmmh.py:51-74 and
    # tests/test_particle_gibbs.py:36-56
    _, ys = make_lgssm_data(60, LGSSMParams(a=0.85), seed=0)
    grid = _kalman_grid(ys)
    common = dict(log_prior=lambda th: -0.5 * torch.sum((th / 1.5) ** 2, dim=-1),
                  theta0=[float(np.arctanh(0.7))], num_samples=400, num_warmup=200,
                  num_chains=8, device="cuda")
    warm, draws = PMMH17_DEPTH  # phase 17's cut, for time ("reduced")
    res, info = _particle_run("particles/pmmh", lambda: pmmh_sample(
        _lgssm_ssm_of_theta, ys, num_particles=128, key=24,
        **{**common, "num_warmup": warm, "num_samples": draws}))
    info.update({"T": 60, "particles": 128, "chains": 8, "num_warmup": warm, "num_samples": draws,
                 "particle_steps_per_second": 8 * 128 * 60 * (warm + draws + 1) / info["seconds"],
                 "reduced": {"num_warmup": [200, warm], "num_samples": [400, draws]}})
    _grid_check("pmmh", info, np.tanh(res.thetas[..., 0].cpu().numpy().ravel()),
                float(res.accept_rate), grid, (0.05, 0.8))
    res, info = _particle_run("particles/pgas", lambda: particle_gibbs_sample(
        _lgssm_ssm_of_theta, ys, num_particles=32, key=25,
        **{**common, "num_warmup": warm, "num_samples": draws}))
    info.update({"T": 60, "particles": 32, "chains": 8, "num_warmup": warm, "num_samples": draws,
                 "particle_steps_per_second": 8 * 32 * 60 * (warm + draws) / info["seconds"],
                 "reduced": {"num_warmup": [200, warm], "num_samples": [400, draws]}})
    _grid_check("pgas", info, np.tanh(res.thetas[..., 0].cpu().numpy().ravel()),
                float(res.accept_rate), grid, (0.05, 0.9))


# ---------------------------------------------------------------------------
# Phase 14: the model zoo (no kernel on any of its runs).  The softmax model
# at scripts/exp_categorical_speedup.py:26-34's full width and depth; the
# small models (eight schools, GP, GMM) at their JAX tests' chains, with the
# warmup and draws of eight schools and the GP cut for time (printed as
# "reduced"): the whole script read 988.6 s with 800 + 800 and 200 + 100 on
# an H100 (700 W), against its 1200 s limit, and the GP fills NUTS's tree (131
# leaves a transition), so its 400 + 400 alone would cost about 85 s of the
# phase's 180 (PERF.md §6).  The softmax run's draws are cut from 500 to 300
# (its 500 took 95.8 s of a 1124.4 s script with phase 17; PERF.md), and
# its warmup from 300 to 200 and eight schools' and the GP's depths cut
# again when the script with phase 18 ran over its 1200 s on a slow host.
SOFTMAX_N, SOFTMAX_D, SOFTMAX_K = 2000, 32, 10
ZOO_RUNS = {  # tag: (chains, max_depth, warmup, draws, the reference's (warmup, draws))
    "softmax": (256, 7, 200, 300, (300, 500)),
    "eight_schools": (16, 9, 300, 300, (800, 800)),
    "gp": (8, 8, 100, 50, (400, 400)),
    "gmm": (8, 7, 400, 300, (400, 300)),
}


def _zoo_line(info: dict, tag: str) -> dict:
    """A phase-14 line: the card beside the run's seconds, and any cut."""
    info.update({"phase": 14, "nvidia_smi": RESULTS["environment"]["nvidia_smi"]})
    if tag in ZOO_RUNS:
        chains, depth, warmup, draws, ref = ZOO_RUNS[tag]
        info.update({"chains": chains, "max_depth": depth, "num_warmup": warmup,
                     "num_samples": draws})
        if (warmup, draws) != ref:
            info["reduced"] = {"num_warmup": [ref[0], warmup], "num_samples": [ref[1], draws]}
    return info


def _zoo_sample(model, tag, **kw):
    """A phase-14 sample() run: no kernel may launch (the zoo's models are
    not recognized GLMs, or are not auto-upgraded)."""
    import numpy as np
    from brancher_torch.inference import NUTS

    if tag in ZOO_RUNS:
        chains, depth, warmup, draws, _ = ZOO_RUNS[tag]
        kw.update(kernel=NUTS(max_depth=depth), num_chains=chains, num_warmup=warmup,
                  num_samples=draws)
    res, info = _run_sample(model, f"zoo/{tag}", None, key=0, **kw)
    check(info["fused_family"] is None, f"zoo/{tag}: sampled on family {info['fused_family']}")
    rhat = max(float(np.max(v)) for v in res.diagnostics["r_hat"].values())
    ess = min(float(np.min(v)) for v in res.diagnostics["ess"].values())
    info.update({"max_rhat": rhat, "min_ess": ess, "ess_per_second": ess / info["sampler_seconds"]})
    RESULTS.setdefault("zoo", {})[tag] = info
    return res, _zoo_line(info, tag)


def _softmax_data():
    import numpy as np
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, size=(SOFTMAX_N, SOFTMAX_D)).astype(np.float32)
    w_true = rng.normal(0, 1.0, size=(SOFTMAX_D, SOFTMAX_K)).astype(np.float32)
    y = np.argmax(x @ w_true + rng.gumbel(size=(SOFTMAX_N, SOFTMAX_K)), -1).astype(np.int32)
    return x, w_true, y


def _zoo_softmax():
    """Softmax classification at exp_categorical_speedup.py's full width,
    fused_potential="auto": the recognizer finds the CategoricalFusedFamily
    and sample() keeps the model on autodiff, as JAX does."""
    import numpy as np
    import torch
    import brancher_torch as BT
    import brancher_torch.functions as BF
    from brancher_torch.inference.hmc import autodiff_value_and_grad
    from brancher_torch.inference.mcmc import make_potential
    from brancher_torch.ops.glm import CategoricalFusedFamily

    x, w_true, y = _softmax_data()
    w = BT.NormalVariable(np.zeros((SOFTMAX_D, SOFTMAX_K), np.float32),
                          np.ones((SOFTMAX_D, SOFTMAX_K), np.float32), "w")
    b = BT.NormalVariable(np.zeros(SOFTMAX_K, np.float32), 2.0 * np.ones(SOFTMAX_K, np.float32), "b")
    yv = BT.CategoricalVariable(logits=BF.matmul(x, w) + b, name="y")
    yv.observe(y)
    model = BT.ProbabilisticModel([yv])
    res, info = _zoo_sample(model, "softmax", fused_potential="auto")
    comp = model.compiled("cuda")
    fam = comp._fused_family_cache
    check(isinstance(fam, CategoricalFusedFamily), f"softmax: recognizer found {type(fam).__name__}")
    # the family's value+grad against autodiff at three random z, then both
    # timed at the run's chain count
    potential, _, _ = make_potential(comp, comp.initial_params, None)
    auto_vg = autodiff_value_and_grad(potential)  # replayed from a CUDA graph, as in sample()
    eager_vg = auto_vg.fn
    gen = torch.Generator(device="cuda").manual_seed(3)
    z3 = torch.randn((3, comp.dim), generator=gen, device="cuda")
    with torch.no_grad():
        v_f, g_f = fam.plain(z3)
    v_a, g_a = auto_vg(z3)
    v_e, g_e = eager_vg(z3)
    dv = v_f - v_a
    val_rel = float((dv - dv[0]).abs().max()) / max(float(v_a.abs().max()), 1.0)
    grad_rel = _rel(g_f, g_a)
    graph_rel = max(_rel(v_a, v_e), _rel(g_a, g_e))
    zc = torch.randn((ZOO_RUNS["softmax"][0], comp.dim), generator=gen, device="cuda")
    with torch.no_grad():
        fam_ms = time_ms(lambda: fam.plain(zc))
    auto_ms = time_ms(lambda: auto_vg(zc))
    eager_ms = time_ms(lambda: eager_vg(zc))
    wm = res.samples["w"].double().mean(dim=(0, 1)).cpu().numpy()
    bm = res.samples["b"].double().mean(dim=(0, 1)).cpu().numpy()
    acc_post = float(np.mean(np.argmax(x @ wm + bm, -1) == y))
    acc_true = float(np.mean(np.argmax(x @ w_true, -1) == y))
    info.update({
        "N": SOFTMAX_N, "d": SOFTMAX_D, "K": SOFTMAX_K, "D": comp.dim,
        "family_found": type(fam).__name__, "family_x_shape": list(fam.x.shape),
        "family_vs_autodiff": {"val_max_rel": val_rel, "grad_max_rel": grad_rel, "limit": 1e-4},
        "family_vg_ms": fam_ms, "autodiff_vg_ms": auto_ms, "autodiff_eager_vg_ms": eager_ms,
        "autodiff_graph_vs_eager_max_rel": graph_rel,
        "train_accuracy_posterior_mean": acc_post, "train_accuracy_w_true": acc_true,
    })
    emit(info)
    check(info["max_rhat"] < 1.01, f"softmax: max R-hat {info['max_rhat']}")
    check(val_rel < 1e-4 and grad_rel < 1e-4,
          f"softmax: family vs autodiff {val_rel:.2e} / {grad_rel:.2e}")
    check(graph_rel < 1e-6, f"softmax: graphed autodiff {graph_rel:.2e} from eager")
    check(abs(acc_post - acc_true) < 0.03, f"softmax: accuracy {acc_post} vs w_true's {acc_true}")


def _zoo_waic():
    """WAIC and PSIS-LOO on phase 3's floor "auto" draws (1024 chains x 1000,
    thinned to 1000), with the limits of tests/test_model_comparison.py."""
    import numpy as np
    import torch
    from brancher_torch.inference import NUTS
    from brancher_torch.model_comparison import loo, pointwise_log_likelihood, waic

    if "floor_auto_samples" not in RESULTS:  # phase 3 did not run: its run, here
        _floor_run("floor", "auto", "glm_bernoulli_f32", 14, 1000, kernel=NUTS(max_depth=8),
                   fused_potential="auto")
    draws = RESULTS["floor_auto_samples"]
    _, _, model = _floor_model()
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll = pointwise_log_likelihood(model, draws, max_draws=1000, device="cuda")
    matrix_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    w = waic(model, draws, max_draws=1000, device="cuda")
    waic_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lo = loo(model, draws, max_draws=1000, device="cuda")
    loo_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in _all_kernels().items()}
    dim = draws["w"].shape[-1]
    info = _zoo_line({
        "run": "zoo/waic_loo", "launches": launches, "matrix_shape": list(ll.shape),
        "matrix_seconds": matrix_s, "waic_seconds": waic_s, "loo_seconds": loo_s,
        "elpd_waic": w.elpd, "se_waic": w.se, "p_eff_waic": w.p_eff,
        "elpd_loo": lo.elpd, "se_loo": lo.se, "p_eff_loo": lo.p_eff,
        "pareto_k_below_0.7": float(np.mean(lo.pareto_k < 0.7)), "pareto_k_max": float(np.max(lo.pareto_k)),
        "latent_dim": dim,
    }, "waic_loo")
    RESULTS.setdefault("zoo", {})["waic_loo"] = info
    emit(info)
    check(not any(launches.values()), f"waic_loo: a kernel launched: {launches}")
    check(ll.shape == (1000, 1000) and bool(np.isfinite(ll).all()), f"waic_loo: matrix {ll.shape}")
    check(abs(w.elpd - lo.elpd) < max(0.2 * w.se, 2.0), f"waic_loo: elpd {w.elpd} vs {lo.elpd}")
    check(info["pareto_k_below_0.7"] > 0.95, f"waic_loo: k < 0.7 on {info['pareto_k_below_0.7']}")
    for name, p_eff in (("waic", w.p_eff), ("loo", lo.p_eff)):
        check(0.5 * dim <= p_eff <= 2.0 * dim, f"waic_loo: p_eff ({name}) {p_eff} for dim {dim}")


def _zoo_small_models():
    """Eight schools, GP regression and a two-component GMM, each at its
    JAX test's run and limits."""
    import numpy as np
    import brancher_torch as BT
    import brancher_torch.distributions as D
    from brancher_torch.stochastic_processes import GaussianProcess

    # eight schools: examples/07_eight_schools.py:15-26, tests/test_eight_schools.py:33-45
    y_obs = np.asarray([28., 8., -3., 7., -1., 1., 18., 12.], np.float32)
    sigma = np.asarray([15., 10., 16., 11., 9., 11., 10., 18.], np.float32)
    mu = BT.NormalVariable(0., 5., "mu")
    tau = BT.HalfCauchyVariable(5., "tau")
    theta_raw = BT.NormalVariable(np.zeros(8, np.float32), np.ones(8, np.float32), "theta_raw")
    theta = BT.DeterministicVariable(mu + tau * theta_raw, "theta")
    y = BT.NormalVariable(theta, sigma, "y")
    y.observe(y_obs)
    res, info = _zoo_sample(BT.ProbabilisticModel([y]), "eight_schools")
    mu_s, tau_s = res.samples["mu"].double(), res.samples["tau"].double()
    per_chain_tau = tau_s.mean(dim=1)
    info.update({"mu_mean": float(mu_s.mean()), "tau_mean": float(tau_s.mean()),
                 "tau_sd": float(tau_s.std(unbiased=False)),
                 "max_chain_tau_mean": float(per_chain_tau.max()),
                 "stan_reference": {"mu": [4.4, 3.3], "tau": [3.6, 3.2]}})
    emit(info)
    check(abs(info["mu_mean"] - 4.4) < 1.0, f"eight_schools: mu mean {info['mu_mean']}")
    check(abs(info["tau_mean"] - 3.6) < 1.2, f"eight_schools: tau mean {info['tau_mean']}")
    check(abs(info["tau_sd"] - 3.2) < 2.0, f"eight_schools: tau sd {info['tau_sd']}")
    check(info["max_chain_tau_mean"] < 20.0, f"eight_schools: a chain's tau {info['max_chain_tau_mean']}")
    check(info["divergences"] < 0.02 * tau_s.numel(), f"eight_schools: {info['divergences']} divergences")

    # GP regression: tests/test_gp.py:24-38
    rng = np.random.RandomState(0)
    xs = np.linspace(0, 2, 15).astype(np.float32)
    f_true = np.sin(2 * xs)
    y_gp = (f_true + 0.1 * rng.normal(size=len(xs))).astype(np.float32)
    f = GaussianProcess(xs, lengthscale=0.5, variance=1.0, name="f")
    yg = BT.NormalVariable(f, 0.1, "y")
    yg.observe(y_gp)
    res, info = _zoo_sample(BT.ProbabilisticModel([yg]), "gp")
    err = float(np.max(np.abs(res.samples["f"].double().mean(dim=(0, 1)).cpu().numpy() - f_true)))
    info.update({"max_abs_err_to_f_true": err, "limit": 0.35})
    emit(info)
    check(err < 0.35, f"gp: posterior mean {err} from sin(2x)")

    # two-component GMM: tests/test_mixture.py:37-52
    rng = np.random.RandomState(0)
    data = np.concatenate([rng.normal(-2, 0.5, 150), rng.normal(2.0, 0.5, 350)]).astype(np.float32)
    mus = BT.NormalVariable(np.zeros(2, np.float32), 5.0 * np.ones(2, np.float32), "mus")
    x = BT.MixtureVariable(D.Normal(), probs=np.asarray([0.3, 0.7], np.float32), loc=mus,
                           scale=0.5, name="x")
    x.observe(data)
    res, info = _zoo_sample(BT.ProbabilisticModel([x]), "gmm")
    per_chain = np.sort(res.samples["mus"].double().mean(dim=1).cpu().numpy(), axis=1)
    dev = [float(np.max(np.abs(per_chain[:, 0] + 1.94))), float(np.max(np.abs(per_chain[:, 1] - 1.96)))]
    info.update({"per_chain_sorted_means": per_chain.tolist(), "max_abs_dev": dev,
                 "reference": [-1.94, 1.96], "limit": 0.15})
    emit(info)
    check(max(dev) < 0.15, f"gmm: per-chain means off by {dev}")


def _zoo_svi():
    """WVGD and SVGD on the conjugate model (tests/test_particles.py:18-53),
    flow VI (tests/test_transformations.py:67-80) and floor SVI with
    matmul_precision="bfloat16" (phase 9's config)."""
    import numpy as np
    import torch
    import brancher_torch as BT
    from brancher_torch.inference import ReverseKL
    from brancher_torch.inference.guides import AutoMeanField
    from brancher_torch.inference.svi import (
        SteinVariationalGradientDescent, WassersteinVariationalGradientDescent,
        matmul_precision_scope,
    )
    from brancher_torch.models import conjugate_normal_model
    from brancher_torch.transformations import Shift, TransformedVariable, TriangularLinear

    zoo = RESULTS.setdefault("zoo", {})
    for tag, method, iters, lr in (
            ("wvgd", WassersteinVariationalGradientDescent(number_particles=64), 600, 0.15),
            ("svgd", SteinVariationalGradientDescent(number_particles=64), 400, 0.05)):
        model, truth = conjugate_normal_model(num_obs=20)
        res, info = _run_svi(f"zoo/{tag}", model, iters, False, inference_method=method, lr=lr,
                             key=0)
        particles = res.extras["particles"]["mu"].double().cpu().numpy()
        info.update({"particles": 64, "mean": float(particles.mean()), "var": float(particles.var()),
                     "post_mean": float(truth["post_mean"]), "post_var": float(truth["post_var"]),
                     "limits": {"mean": 0.1, "var": 0.04}})
        zoo[tag] = _zoo_line(info, tag)
        emit(info)
        check(abs(info["mean"] - info["post_mean"]) < 0.1, f"{tag}: mean {info['mean']}")
        check(abs(info["var"] - info["post_var"]) < 0.04, f"{tag}: var {info['var']}")

    model, truth = conjugate_normal_model(num_obs=15)
    qmu = TransformedVariable("mu", dim=1, flows=[TriangularLinear(), Shift()])
    model.set_posterior_model(BT.ProbabilisticModel([qmu]))
    res, info = _run_svi("zoo/flow_vi", model, 1500, False, number_samples=16, lr=0.02, key=0)
    post = model.get_posterior_sample_dict(2000, key=5, device="cuda")["mu"].double()
    info.update({"mean": float(post.mean()), "var": float(post.var(unbiased=False)),
                 "post_mean": float(truth["post_mean"]), "post_var": float(truth["post_var"]),
                 "limits": {"mean": 0.1, "var": 0.05}})
    zoo["flow_vi"] = _zoo_line(info, "flow_vi")
    emit(info)
    check(abs(info["mean"] - info["post_mean"]) < 0.1, f"flow_vi: mean {info['mean']}")
    check(abs(info["var"] - info["post_var"]) < 0.05, f"flow_vi: var {info['var']}")

    # floor SVI with bf16 products (TF32 off, phase 1): the first loss at
    # fixed draws differs from the f32 loss, so the scope took effect
    _, _, model = _floor_model()
    res, info = _run_svi("zoo/svi_floor_bf16", model, 1500, False, number_samples=16, lr=0.02,
                         key=7, matmul_precision="bfloat16")
    comp = model.compiled("cuda")
    guide = AutoMeanField(comp)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = {"p": comp.initial_params, "q": guide.init_params(gen)}
    noise = torch.randn((16, comp.dim), generator=gen, device="cuda")
    loss_fn = ReverseKL().make_loss(comp, guide)
    with torch.no_grad():
        loss32 = float(loss_fn(params, None, 16, draws={"noise": noise}))
        with matmul_precision_scope("bfloat16"):
            loss16 = float(loss_fn(params, None, 16, draws={"noise": noise}))
    loc = res.guide.posterior_moments(res.params["q"])[0].cpu().numpy()
    info.update({"matmul_precision": "bfloat16", "loss_f32_at_fixed_draws": loss32,
                 "loss_bf16_at_fixed_draws": loss16,
                 "precision_after": torch.get_float32_matmul_precision()})
    if "floor_auto_moments" in RESULTS:  # phase 3 ran
        info["max_abs_diff_to_nuts_mean"] = float(np.abs(loc - RESULTS["floor_auto_moments"][0]).max())
        info["tolerance"] = 0.15
    zoo["svi_floor_bf16"] = _zoo_line(info, "svi_floor_bf16")
    emit(info)
    check(loss16 != loss32 and abs(loss16 - loss32) < 1e-2 * abs(loss32),
          f"svi_floor_bf16: bf16 loss {loss16} against f32 {loss32}")
    check(info["precision_after"] == "highest", "svi_floor_bf16: precision not restored")
    if "tolerance" in info:
        check(info["max_abs_diff_to_nuts_mean"] < 0.15,
              f"svi_floor_bf16: loc {info['max_abs_diff_to_nuts_mean']:.3f} from the NUTS means")


def phase_zoo():
    _zoo_softmax()
    _zoo_waic()
    _zoo_small_models()
    _zoo_svi()


# ---------------------------------------------------------------------------
# Phase 15: exact enumeration of discrete latents.  No kernel is on any of
# its runs: under enumerate_discrete sample() forces fused_potential="off",
# as JAX does (brancher_tpu/inference/mcmc.py:598-624), and the enumerated
# potential runs on the autodiff value+grad, replayed from a CUDA graph.
# The headline is tests/test_discrete_latents.py:624-661's sequence HMM
# (T=500, K=2) at 256 chains; the lengths row is :531's _markov_hmm_model
# (K=3; scripts/exp_enum_sequence.py) at T=100 and 10,000, one value+grad
# of 256 chains; the other rows are their JAX tests' runs (ENUM_RUNS) with
# the mixture and the Gaussian HMM at 256 chains.
ENUM_T = 500
ENUM_LENGTHS = (100, 10_000)
ENUM_LENGTH_CHAINS = 256
ENUM_RUNS = {  # tag: (chains, NUTS max_depth (None: NUTS()), warmup, draws, the JAX test's chains)
    "sequence_hmm": (256, None, 100, 100, 4),
    "mixture": (256, 8, 200, 200, 4),
    "gaussian_hmm": (256, 7, 200, 200, 4),
    "poisson_hmm": (4, 7, 200, 200, 4),
    "chain": (2, 6, 200, 200, 2),
    "factor": (2, 6, 300, 400, 2),
    "group": (4, None, 300, 400, 4),
}
# the runs held at 256 chains: a cut for time is printed as "reduced"
ENUM_TARGET_CHAINS = {"sequence_hmm": 256, "mixture": 256, "gaussian_hmm": 256}
# runs whose warmup and draws were cut for time, "reduced" from these: the
# sequence HMM took 40.0 s at 200 + 200 and the Poisson HMM 26.8 s at 400 +
# 400 of a script that read 1186.3 s with phase 18, and the mixture and the
# Gaussian HMM, whose ESS sat at its cap at 400 + 400, are halved with
# phase 18's other cuts (PERF.md)
ENUM_DEPTH_CUTS = {"sequence_hmm": (200, 200), "poisson_hmm": (400, 400),
                   "mixture": (400, 400), "gaussian_hmm": (400, 400)}


def _enum_line(info: dict, tag: str) -> dict:
    """A phase-15 line: the card beside the run's numbers, and any cut of
    its chains below its target (ENUM_TARGET_CHAINS)."""
    info.update({"phase": 15, "nvidia_smi": RESULTS["environment"]["nvidia_smi"]})
    if tag in ENUM_RUNS:
        chains, depth, warmup, draws, _ = ENUM_RUNS[tag]
        info.update({"chains": chains, "max_depth": depth, "num_warmup": warmup,
                     "num_samples": draws})
        target = ENUM_TARGET_CHAINS.get(tag, chains)
        reduced = {"chains": [target, chains]} if chains != target else {}
        if tag in ENUM_DEPTH_CUTS:
            ref_warmup, ref_draws = ENUM_DEPTH_CUTS[tag]
            reduced.update({"num_warmup": [ref_warmup, warmup], "num_samples": [ref_draws, draws]})
        if reduced:
            info["reduced"] = reduced
    return info


def _enum_sample(model, tag, enumerate_discrete=True, require_graph=False, exchangeable=None):
    """A phase-15 sample() run: no kernel may launch; with
    ``enumerate_discrete`` the dispatch is made (and timed) first, and the
    run reuses it.  ``exchangeable`` names a latent whose components are
    exchangeable labels (a mixture's or an HMM's states): chains settle in
    permuted modes, so its min-ESS and R-hat are read on each draw's
    sorted components."""
    import numpy as np
    import torch
    from brancher_torch.inference import NUTS
    from brancher_torch.inference.diagnostics import (
        effective_sample_size, potential_scale_reduction)

    chains, depth, warmup, draws, _ = ENUM_RUNS[tag]
    line = {}
    if enumerate_discrete:
        comp = model.compiled("cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn = comp.enum_log_density_fn(comp.initial_params)
        torch.cuda.synchronize()
        line = {"dispatch_method": fn.__name__, "dispatch_seconds": time.perf_counter() - t0}
    res, info = _run_sample(model, f"enum/{tag}", None, key=0,
                            kernel=NUTS() if depth is None else NUTS(max_depth=depth),
                            num_chains=chains, num_warmup=warmup, num_samples=draws,
                            enumerate_discrete=enumerate_discrete)
    d = res.diagnostics
    check(d["fused_family"] is None, f"enum/{tag}: sampled on family {d['fused_family']}")
    if require_graph:
        check(d["value_and_grad_graphed"] is True, f"enum/{tag}: the value+grad ran eagerly")
    ess = min(float(np.min(v)) for v in d["ess"].values())
    rhat = max(float(np.max(v)) for v in d["r_hat"].values())
    if exchangeable is not None:
        x = np.sort(res.samples[exchangeable].double().cpu().numpy(), axis=-1)
        ess = float(np.min(effective_sample_size(x)))
        rhat = float(np.max(potential_scale_reduction(x)))
        line["ess_and_rhat_on"] = f"{exchangeable}, each draw's components sorted"
    info.update(line)
    info.update({"value_and_grad_graphed": d["value_and_grad_graphed"], "min_ess": ess,
                 "ess_per_second": ess / info["sampler_seconds"], "max_rhat": rhat})
    RESULTS.setdefault("enum", {})[tag] = info
    return res, _enum_line(info, tag)


def _markov_chain_model(data, trans_logits, scale):
    """A MarkovProcess HMM with BF.take(locs, s) emissions (the sequence
    node), its transition logits a link so that they follow it to the card."""
    import numpy as np
    import brancher_torch as BT
    import brancher_torch.functions as BF
    from brancher_torch.distributions import Categorical
    from brancher_torch.stochastic_processes import MarkovProcess

    k = trans_logits.shape[0]
    s = MarkovProcess(len(data), Categorical(), lambda prev, lt: {"logits": lt[prev]},
                      links={"lt": trans_logits}, init_dist=Categorical(),
                      init_links={"logits": np.zeros(k, np.float32)}, name="s")
    locs = BT.NormalVariable(np.zeros(k, np.float32), 2.0 * np.ones(k, np.float32), "locs")
    y = BT.NormalVariable(BF.take(locs, s), scale, "y")
    y.observe(data)
    return BT.ProbabilisticModel([y])


def _enum_headline():
    """tests/test_discrete_latents.py:624-661 at 256 chains: per-chain sorted
    emission means within 0.25 of (-1.5, 1.5), on a graphed value+grad."""
    import numpy as np

    rng = np.random.RandomState(3)
    lt = np.asarray([[2.0, -2.0], [-2.0, 2.0]], np.float32)
    p = np.exp(lt) / np.exp(lt).sum(-1, keepdims=True)
    states = [0]
    for _ in range(ENUM_T - 1):
        states.append(rng.choice(2, p=p[states[-1]]))
    true_locs = np.asarray([-1.5, 1.5], np.float32)
    data = (true_locs[np.asarray(states)] + 0.5 * rng.normal(size=ENUM_T)).astype(np.float32)
    res, info = _enum_sample(_markov_chain_model(data, lt, 0.5), "sequence_hmm",
                             require_graph=True, exchangeable="locs")
    per_chain = np.sort(res.samples["locs"].double().mean(dim=1).cpu().numpy(), axis=-1)
    got = per_chain.mean(axis=0)
    info.update({"T": ENUM_T, "K": 2, "per_chain_sorted_mean": got.tolist(),
                 "max_abs_dev": float(np.abs(got - true_locs).max()), "limit": 0.25,
                 "worst_chain_dev": float(np.abs(per_chain - true_locs).max())})
    emit(info)
    check(info["max_abs_dev"] < 0.25, f"enum/sequence_hmm: sorted locs {got}")


def _enum_lengths():
    """_markov_hmm_model(T, k=3) at T=100 and 10,000: one value+grad of 256
    chains, its capture seconds, ms a replay and ms an eager call, and the
    graphed call held to the eager one to 1e-5."""
    import numpy as np
    import torch
    from brancher_torch.inference.hmc import autodiff_value_and_grad
    from brancher_torch.inference.mcmc import make_enum_potential

    lt = np.random.RandomState(0).normal(0, 1.5, (3, 3)).astype(np.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for t_len in ENUM_LENGTHS:
        data = np.random.RandomState(0).normal(0, 2, t_len).astype(np.float32)
        comp = _markov_chain_model(data, lt, 0.7).compiled("cuda")
        _reset_launches()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn = comp.enum_log_density_fn(comp.initial_params)
        torch.cuda.synchronize()
        dispatch_s = time.perf_counter() - t0
        graphed = autodiff_value_and_grad(
            make_enum_potential(comp, comp.initial_params, None, comp.unravel_z))
        z = torch.randn((ENUM_LENGTH_CHAINS, comp.dim), generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, g = graphed(z)  # two eager calls on a side stream, the capture, one replay
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        check(len(graphed.graphs) == 1, f"enum/length {t_len}: the value+grad was not captured")
        replay_ms = time_ms(lambda: graphed(z), reps=5, warm_ms=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v_e, g_e = graphed.fn(z)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        rel = max(_rel(v, v_e), _rel(g, g_e))
        launches = {name: k.launches for name, k in _all_kernels().items()}
        info = {"phase": 15, "run": f"enum/sequence_length_{t_len}", "T": t_len, "K": 3,
                "chains": ENUM_LENGTH_CHAINS, "dispatch_method": fn.__name__,
                "dispatch_seconds": dispatch_s, "capture_seconds": capture_s,
                "graphed_ms_per_call": replay_ms, "eager_ms_per_call": eager_ms,
                "graphed_vs_eager_rel": rel, "launches": launches,
                "finite": bool(torch.isfinite(v).all() and torch.isfinite(g).all()),
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "nvidia_smi": RESULTS["environment"]["nvidia_smi"]}
        RESULTS.setdefault("enum", {})[f"length_{t_len}"] = info
        emit(info)
        check(not any(launches.values()), f"enum/length {t_len}: a kernel launched: {launches}")
        check(info["finite"], f"enum/length {t_len}: non-finite value or gradient")
        check(rel < 1e-5, f"enum/length {t_len}: graphed differs from eager by {rel}")
        del graphed, v, g, v_e, g_e


def _enum_mixture_model(data, k=2):
    import numpy as np
    import brancher_torch as BT
    import brancher_torch.functions as BF

    mu = BT.NormalVariable(np.zeros(k, np.float32), 3.0 * np.ones(k, np.float32), "mu")
    z = BT.CategoricalVariable(probs=np.ones(k, np.float32) / k, name="z",
                               plate_shape=(data.shape[0],))
    x = BT.NormalVariable(BF.take(mu, z), 0.5, "x")
    x.observe(data)
    return BT.ProbabilisticModel([x])


def _enum_mixture_data(n=40, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    comp = rng.randint(0, 2, n)
    return (np.asarray([-2.0, 2.0])[comp] + 0.5 * rng.normal(size=n)).astype(np.float32), comp


def _enum_mixture():
    """tests/test_discrete_latents.py:100-124 at 256 chains: sorted means
    within 0.2 of +-2, responsibilities at them classify > 95 %; and
    :127-139's enumerated SVI (800 steps, 8 samples, lr 0.05)."""
    import numpy as np
    import torch
    from brancher_torch.inference import ReverseKL

    data, true_comp = _enum_mixture_data()
    model = _enum_mixture_model(data)
    res, info = _enum_sample(model, "mixture", exchangeable="mu")
    mu_sorted = np.sort(res.samples["mu"].double().cpu().numpy().reshape(-1, 2), axis=1).mean(0)
    comp = model.compiled("cuda")
    _, resp = comp.enumerated_log_density(
        comp.initial_params, {"mu": torch.as_tensor(mu_sorted, dtype=torch.float32, device="cuda")},
        return_responsibilities=True)
    hard = resp["z"].argmax(-1).cpu().numpy()
    acc = float(max((hard == true_comp).mean(), (1 - hard == true_comp).mean()))
    info.update({"sorted_mean": mu_sorted.tolist(), "limit": 0.2, "assignment_accuracy": acc})
    emit(info)
    check(float(np.abs(mu_sorted - [-2.0, 2.0]).max()) < 0.2, f"enum/mixture: means {mu_sorted}")
    check(acc > 0.95, f"enum/mixture: responsibilities classify {acc}")

    res, info = _run_svi("enum/svi_mixture", _enum_mixture_model(data), 800, False,
                         number_samples=8, lr=0.05, key=0,
                         inference_method=ReverseKL(enumerate_discrete=True))
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        zs, _ = res.guide.sample_and_log_prob(res.params["q"], gen, 200)
    mu_q = np.sort(zs["mu"].double().cpu().numpy(), axis=1).mean(0)
    info.update({"phase": 15, "number_samples": 8, "lr": 0.05, "sorted_mean": mu_q.tolist(),
                 "limit": 0.3, "nvidia_smi": RESULTS["environment"]["nvidia_smi"]})
    RESULTS.setdefault("enum", {})["svi_mixture"] = info
    emit(info)
    check(float(np.abs(mu_q - [-2.0, 2.0]).max()) < 0.3, f"enum/svi_mixture: means {mu_q}")


def _enum_hmms():
    """The HMM variables under NUTS (the forward algorithm in the density, no
    discrete latent left to enumerate): tests/test_hmm.py:67-87's Gaussian
    HMM at 256 chains and :154-175's Poisson HMM at its own 4."""
    import numpy as np
    import brancher_torch as BT
    from brancher_torch.distributions import Poisson
    from brancher_torch.stochastic_processes import EmissionHMMVariable, HMMVariable

    trans = np.asarray([[0.9, 0.1], [0.2, 0.8]])
    rng = np.random.RandomState(1)
    s, ys = rng.choice(2, p=[0.6, 0.4]), []
    for _ in range(120):
        ys.append(np.asarray([-2.0, 2.0])[s] + 0.7 * rng.randn())
        s = rng.choice(2, p=trans[s])
    locs = BT.NormalVariable(np.zeros(2, np.float32), 5.0 * np.ones(2, np.float32), "locs")
    series = HMMVariable(120, init_logits=np.zeros(2, np.float32),
                         trans_logits=np.log(trans).astype(np.float32), locs=locs,
                         scales=np.asarray([0.7, 0.7], np.float32), name="y")
    series.observe(np.asarray(ys, np.float32))
    res, info = _enum_sample(BT.ProbabilisticModel([series]), "gaussian_hmm",
                             enumerate_discrete=False, exchangeable="locs")
    locs_hat = np.sort(res.samples["locs"].double().cpu().numpy().reshape(-1, 2), axis=1).mean(0)
    info.update({"T": 120, "sorted_mean": locs_hat.tolist(), "limit": 0.25,
                 "jax_test_divergences": "0 at 4 chains"})
    emit(info)
    check(float(np.abs(locs_hat - [-2.0, 2.0]).max()) < 0.25, f"enum/gaussian_hmm: {locs_hat}")

    ptrans = np.asarray([[0.92, 0.08], [0.15, 0.85]])
    rng = np.random.RandomState(5)
    s, counts = 0, []
    for _ in range(200):
        counts.append(rng.poisson((1.0, 8.0)[s]))
        s = rng.choice(2, p=ptrans[s])
    rates = BT.LogNormalVariable(np.zeros(2, np.float32), 2.0 * np.ones(2, np.float32), "rates")
    series = EmissionHMMVariable(200, Poisson(), init_logits=np.zeros(2, np.float32),
                                 trans_logits=np.log(ptrans).astype(np.float32), rate=rates,
                                 name="y")
    series.observe(np.asarray(counts, np.float32))
    res, info = _enum_sample(BT.ProbabilisticModel([series]), "poisson_hmm",
                             enumerate_discrete=False, exchangeable="rates")
    r_hat = np.sort(res.samples["rates"].double().cpu().numpy().reshape(-1, 2), axis=1).mean(0)
    info.update({"T": 200, "sorted_mean": r_hat.tolist(), "limits": [0.4, 1.2]})
    emit(info)
    check(abs(r_hat[0] - 1.0) < 0.4 and abs(r_hat[1] - 8.0) < 1.2, f"enum/poisson_hmm: {r_hat}")


def _quadrature(comp, density, grid):
    """Posterior mean and sd of the scalar mu by quadrature over ``grid``
    of ``density(mu)`` (mu's unconstrained transform is the identity)."""
    import torch

    with torch.no_grad():
        lps = torch.func.vmap(density)(grid).double()
    w = torch.exp(lps - torch.logsumexp(lps, 0))
    g = grid.double()
    mean = float(torch.sum(w * g))
    return mean, float(torch.sqrt(torch.sum(w * g**2) - mean**2))


def _enum_structures():
    """tests/test_discrete_latents.py:242-255's chain HMM, :350-370's
    three-way collider and :497-529's plated pair, each at its test's run
    and limits against quadrature of the exact marginal (brute force for
    the group, as there)."""
    import itertools
    import numpy as np
    import torch
    import brancher_torch as BT
    import brancher_torch.functions as BF

    a = np.asarray([[0.9, 0.1], [0.2, 0.8]], np.float32)
    rng = np.random.RandomState(3)
    s, xs = rng.randint(0, 2), []
    for _ in range(12):
        xs.append(0.5 + 2.0 * (2 * s - 1) + 0.6 * rng.normal())
        s = rng.choice(2, p=a[s])
    mu = BT.NormalVariable(0.0, 3.0, "mu")
    st = BT.CategoricalVariable(probs=np.asarray([0.5, 0.5], np.float32), name="s0")
    outs = []
    for t in range(12):
        if t:
            st = BT.CategoricalVariable(probs=BF.take(a, st, axis=0), name=f"s{t}")
        x = BT.NormalVariable(2.0 * (2.0 * st - 1.0) + mu, 0.6, f"x{t}")
        x.observe(np.float32(xs[t]))
        outs.append(x)
    chain = BT.ProbabilisticModel(outs)

    d1, d2, d3 = (BT.BernoulliVariable(p, name=n) for p, n in ((0.4, "d1"), (0.5, "d2"), (0.6, "d3")))
    mu = BT.NormalVariable(0.0, 2.0, "mu")
    y = BT.NormalVariable(mu + d1 + 0.5 * d2 - d3 + 2.0 * d1 * d2 * d3, 0.7, "y")
    y.observe(np.float32(1.2))
    factor = BT.ProbabilisticModel([y])

    mu = BT.NormalVariable(0.0, 2.0, "mu")
    z1 = BT.BernoulliVariable(0.4, name="z1", plate_shape=(2,))
    z2 = BT.BernoulliVariable(logits=1.5 * z1 - 0.5, name="z2")
    y = BT.NormalVariable(mu + z1 + 0.5 * z2 + 1.2 * z1 * z2, 0.7, "y")
    y.observe(np.linspace(-0.5, 1.5, 2).astype(np.float32))
    group = BT.ProbabilisticModel([y])

    dev = "cuda"
    for tag, model, grid, limits in (
            ("chain", chain, torch.linspace(-3.0, 4.0, 2001, device=dev), (0.4, 0.4)),
            ("factor", factor, torch.linspace(-4.0, 5.0, 1501, device=dev), (0.35, 0.4)),
            ("group", group, torch.linspace(-3.0, 3.0, 241, device=dev), None)):
        res, info = _enum_sample(model, tag)  # the dispatch first, timed
        comp = model.compiled(dev)
        p = comp.initial_params
        if tag == "group":
            assigns = [{"z1": torch.tensor(u, device=dev), "z2": torch.tensor(v, device=dev)}
                       for u in itertools.product([0, 1], repeat=2)
                       for v in itertools.product([0, 1], repeat=2)]
            density = lambda m: torch.logsumexp(torch.stack(  # noqa: E731
                [comp.log_density_z(p, {"mu": m}, g) for g in assigns]), 0)
        else:
            fn = comp.enum_log_density_fn(p)
            density = lambda m, _fn=fn: _fn(p, {"mu": m})  # noqa: E731
        exact_mean, exact_sd = _quadrature(comp, density, grid)
        draws = res.samples["mu"].double().cpu().numpy().ravel()
        info.update({"mean": float(draws.mean()), "sd": float(draws.std()),
                     "exact_mean": exact_mean, "exact_sd": exact_sd})
        if limits is None:  # the group test's limits (4 chains x 400 draws)
            info["limits"] = {"mean": 3.5 * exact_sd / np.sqrt(40), "sd": [0.6, 1.5]}
            ok = (abs(info["mean"] - exact_mean) < info["limits"]["mean"]
                  and 0.6 * exact_sd < info["sd"] < 1.5 * exact_sd)
        else:
            info["limits"] = {"mean_in_sd": limits[0], "sd_in_sd": limits[1]}
            ok = (abs(info["mean"] - exact_mean) < limits[0] * exact_sd
                  and abs(info["sd"] - exact_sd) < limits[1] * exact_sd)
        emit(info)
        check(ok, f"enum/{tag}: mean {info['mean']} sd {info['sd']} against "
                  f"{exact_mean} {exact_sd}")


def phase_enumeration():
    _enum_headline()
    _enum_lengths()
    _enum_mixture()
    _enum_hmms()
    _enum_structures()


# ---------------------------------------------------------------------------
# Phase 16: the auxiliary modules on phase 3's floor model at full width
# (1024 chains, N=1000, D=32), K1 under every sample() run.  The runs are
# shorter than phase 3's (200 + 200, then 200 resumed): the phase checks the
# modules around the sampler, and phase 3 measures the sampler.  Steps that
# need a package the card machine may lack (pandas, cloudpickle, matplotlib,
# TensorBoard) print "not_run" with the package's name where it is absent.
AUX_WARMUP, AUX_DRAWS = 200, 200
AUX_PROFILE_DRAWS = 10  # transitions in the profiled window: a trace of a few MB
AUX_SVI_STEPS = 300
AUX_PPC_DRAWS = 1000
OPTIONAL_PACKAGES = ("pandas", "cloudpickle", "matplotlib", "tensorboard")


def _installed(name: str) -> bool:
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def _busy_share(trace_path):
    """The card's busy time in a Chrome trace, the union of its kernel,
    memcpy and memset intervals, as a share of the span of all its events
    (the traced window) and of the span from the first device interval to
    the last; the window's ms and the number of kernels."""
    events = [e for e in json.loads(Path(trace_path).read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in device:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    device_span = (device[-1][1] - device[0][0]) if device else 0.0
    return (busy / max(end - start, 1e-9), busy / max(device_span, 1e-9), (end - start) * 1e-3,
            kernels)


def _aux_line(info: dict) -> dict:
    info["phase"] = 16
    emit(info)
    RESULTS.setdefault("aux", {})[info["run"]] = info
    return info


def phase_aux():
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_aux_") as d:
        _phase_aux(Path(d))


def _phase_aux(work):
    import numpy as np
    import torch
    from brancher_torch.checkpoint import restore_checkpoint, save_checkpoint
    from brancher_torch.dashboard import export_dashboard_html
    from brancher_torch.inference import NUTS
    from brancher_torch.inference.streaming_smc import StreamingSMC
    from brancher_torch.metrics import TRACE_FILE, MetricsLogger, profile_trace, summarize_mcmc
    from brancher_torch.models import LGSSMParams, lgssm_state_space, make_lgssm_data
    from brancher_torch.serialization import build_model, model_spec

    present = {name: _installed(name) for name in OPTIONAL_PACKAGES}
    emit({"phase": 16, "optional_packages": present})
    nuts = NUTS(max_depth=8)
    x, y, model = _floor_model()

    # 1. the floor run (K1 once per value+grad call)
    res, info = _run_sample(model, "aux/floor", "glm_bernoulli_f32", kernel=nuts,
                            num_warmup=AUX_WARMUP, num_samples=AUX_DRAWS, num_chains=1024, key=30)
    mean, sd, ess, rhat = _post_stats(res, "w")
    info.update({"num_warmup": AUX_WARMUP, "num_samples": AUX_DRAWS, "min_ess": float(ess.min()),
                 "max_rhat": float(rhat.max())})
    _aux_line(info)
    check(info["fused_family"] == "bernoulli_logit", f"aux/floor: family {info['fused_family']}")
    check(info["max_rhat"] < 1.01, f"aux/floor: max R-hat {info['max_rhat']}")
    if "floor_auto_moments" in RESULTS:  # phase 3 ran
        _mcse_compare(16, "aux/floor vs floor/auto", RESULTS["floor_auto_moments"],
                      (mean, sd, ess), "aux")

    # 2. the resume state through a checkpoint, then 200 draws with no warmup
    t0 = time.perf_counter()
    rs = res.diagnostics["resume_state"]
    save_checkpoint(str(work / "resume"), rs)
    rs2 = restore_checkpoint(str(work / "resume"))
    ckpt_s = time.perf_counter() - t0
    check(all(torch.equal(torch.as_tensor(rs[k]), torch.as_tensor(rs2[k])) for k in rs)
          and rs2["z"].device.type == "cuda", "aux: the checkpoint changed the resume state")
    res2, info = _run_sample(model, "aux/resume", "glm_bernoulli_f32", kernel=nuts,
                             resume_state=rs2, num_warmup=0, num_samples=AUX_DRAWS,
                             num_chains=1024, key=31)
    m2, s2, e2, r2 = _post_stats(res2, "w")
    info.update({"num_samples": AUX_DRAWS, "checkpoint_seconds": ckpt_s,
                 "min_ess": float(e2.min()), "max_rhat": float(r2.max())})
    _aux_line(info)
    check(info["warmup_leaf_iterations"] == 0, "aux/resume: the resumed run warmed up")
    _mcse_compare(16, "aux/resume vs aux/floor", (mean, sd, ess), (m2, s2, e2), "aux")

    # 3. the posterior predictive: y's draws are 0 or 1
    _reset_launches()
    t0 = time.perf_counter()
    ppc = res.posterior_predictive(model, num_draws=AUX_PPC_DRAWS, key=32)
    torch.cuda.synchronize()
    ppc_s = time.perf_counter() - t0
    yd = ppc["y"]
    agree = float((yd.float().mean(0).round().cpu().numpy() == y).mean())
    _aux_line({"run": "aux/posterior_predictive", "num_draws": AUX_PPC_DRAWS,
               "shape": list(yd.shape), "seconds": ppc_s, "agreement_with_data": agree,
               "launches": {n: k.launches for n, k in _all_kernels().items()}})
    check(tuple(yd.shape) == (AUX_PPC_DRAWS, x.shape[0]) and bool(((yd == 0) | (yd == 1)).all()),
          "aux/posterior_predictive: y's draws are not 0/1 of the data's shape")
    check(not any(RESULTS["aux"]["aux/posterior_predictive"]["launches"].values()),
          "aux/posterior_predictive: a kernel launched")

    # 4. the summaries: summarize_mcmc and the dashboard (24 panels of 32)
    t0 = time.perf_counter()
    summary = summarize_mcmc(res)
    summary_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    page = Path(export_dashboard_html(res, str(work / "dashboard.html"), max_panels=24)).read_text()
    dash_s = time.perf_counter() - t0
    panels = page.count('class="panel"')
    _aux_line({"run": "aux/summaries", "summarize_seconds": summary_s, "dashboard_seconds": dash_s,
               "dashboard_bytes": len(page.encode()), "panels": panels})
    check(summary["w"]["mean"].shape == (32,) and "ess" in summary["w"], "aux: summarize_mcmc")
    check(panels == 24 and "truncated at max_panels" in page, f"aux: dashboard has {panels} panels")

    # 5. profiling a short window of the resumed sampler (information only)
    trace_dir = work / "trace"
    with profile_trace(str(trace_dir)):
        _, info = _run_sample(model, "aux/profiled", "glm_bernoulli_f32", kernel=nuts,
                              resume_state=rs2, num_warmup=0, num_samples=AUX_PROFILE_DRAWS,
                              num_chains=1024, key=33, diagnostics_backend="none")
    trace = trace_dir / TRACE_FILE
    share, span_share, window_ms, kernels = _busy_share(trace)
    info.update({"num_samples": AUX_PROFILE_DRAWS, "trace_bytes": trace.stat().st_size,
                 "traced_window_ms": window_ms, "kernel_events": kernels,
                 "device_busy_share": share, "device_busy_share_first_to_last_kernel": span_share,
                 "nvidia_smi": RESULTS["environment"]["nvidia_smi"]})
    _aux_line(info)
    check(kernels > 0, "aux/profiled: the trace holds no kernel")

    # 6. the metrics logger over phase 9's floor SVI
    svi, info = _run_svi("aux/svi_metrics", model, AUX_SVI_STEPS, False, number_samples=16,
                         lr=0.02, key=34)
    tb = str(work / "tensorboard") if present["tensorboard"] else None
    logger = MetricsLogger(str(work / "metrics.jsonl"), tensorboard_dir=tb)
    t0 = time.perf_counter()
    for step, loss in enumerate(svi.loss_curve):
        logger.log(step, loss=loss)
    logger.close()
    info.update({"log_seconds": time.perf_counter() - t0,
                 "jsonl_lines": len((work / "metrics.jsonl").read_text().splitlines()),
                 "tensorboard": bool(tb) or {"not_run": "tensorboard is not installed"}})
    _aux_line(info)
    check(info["jsonl_lines"] == AUX_SVI_STEPS, f"aux: {info['jsonl_lines']} metric lines")

    # 7. specs: the floor model's logits are an expression link, which the
    # spec holds as opaque and build_model refuses, as in JAX; the round
    # trip is held on a model of the floor's data with direct links
    import brancher_torch as BT

    spec = json.loads(json.dumps(model_spec(model, include_links=True, device="cuda")))
    try:
        build_model(spec)
        refused = False
    except ValueError as e:
        refused = "opaque" in str(e)
    check(refused, "aux/spec: build_model did not refuse the floor model's expression link")
    mu = BT.NormalVariable(np.zeros(32, np.float32), np.ones(32, np.float32), "mu")
    sigma = BT.LogNormalVariable(0.0, 0.5, "sigma")
    xv = BT.NormalVariable(mu, sigma, "x", plate_shape=(x.shape[0],))
    xv.observe(x)
    direct = BT.ProbabilisticModel([xv])
    t0 = time.perf_counter()
    rebuilt = build_model(json.loads(json.dumps(model_spec(direct, include_links=True,
                                                           device="cuda"))))
    spec_s = time.perf_counter() - t0
    z = torch.randn((1024, 33), generator=torch.Generator("cuda").manual_seed(35), device="cuda")
    dens = []
    for m in (direct, rebuilt):
        comp = m.compiled("cuda")
        dens.append(torch.func.vmap(lambda zf, c=comp: c.log_density_z(
            c.initial_params, c.unravel_z(zf)))(z))
    _aux_line({"run": "aux/spec", "floor_spec_refused": refused, "seconds": spec_s,
               "rebuilt_model": "x ~ N(mu [32], sigma) over the floor's 1000 x 32 X",
               "bit_identical": bool(torch.equal(dens[0], dens[1]))})
    check(torch.equal(dens[0], dens[1]), "aux/spec: the rebuilt log density differs")

    # 8. the streaming filter at phase 12's size, checkpointed at t=150 and
    # resumed in a fresh StreamingSMC: bit for bit the uninterrupted run
    _, ys = make_lgssm_data(300, LGSSMParams(), seed=0)
    ys = np.asarray(ys)
    kw = dict(num_particles=2048, lag=16, device="cuda")
    f = StreamingSMC(lgssm_state_space(LGSSMParams()), **kw)
    state, _ = f.init(ys[0], key=22)
    state, _ = f.process(state, ys[1:150])
    t0 = time.perf_counter()
    save_checkpoint(str(work / "stream"), state)
    ckpt_s = time.perf_counter() - t0
    state, (means, sms, _, _) = f.process(state, ys[150:])
    t0 = time.perf_counter()
    state2 = restore_checkpoint(str(work / "stream"))
    restore_s = time.perf_counter() - t0
    state2, (means2, sms2, _, _) = StreamingSMC(lgssm_state_space(LGSSMParams()), **kw).process(
        state2, ys[150:])
    same = (torch.equal(means, means2) and torch.equal(sms, sms2) and state.t == state2.t
            and all(torch.equal(a, b) for a, b in zip(state[1:5], state2[1:5])))
    _aux_line({"run": "aux/streaming_resume", "T": 300, "particles": 2048, "lag": 16,
               "checkpoint_at": 150, "save_seconds": ckpt_s, "restore_seconds": restore_s,
               "bit_identical": same})
    check(same, "aux/streaming_resume: the resumed filter differs from the uninterrupted one")

    # 9. what needs pandas, cloudpickle or matplotlib
    line = {"run": "aux/optional"}
    if present["pandas"]:
        t0 = time.perf_counter()
        df = res.to_pandas()
        gs = model.get_sample(1000, key=36, device="cuda")
        line.update({"to_pandas_rows": len(df), "get_sample_shape": list(gs.shape),
                     "pandas_seconds": time.perf_counter() - t0})
        check(len(df) == math.prod(res.samples["w"].shape[:2]) and list(gs.columns) == ["w", "y"]
              and len(gs) == 1000, "aux: DataFrames")
    else:
        line["pandas"] = {"not_run": "pandas is not installed"}
    if present["cloudpickle"]:
        from brancher_torch.serialization import load_model, save_model

        t0 = time.perf_counter()
        save_model(model, str(work / "model.pkl"))
        loaded = load_model(str(work / "model.pkl"), device="cuda")
        pickle_s = time.perf_counter() - t0
        draws = [m.get_sample_dict(1000, key=37, device="cuda") for m in (model, loaded)]
        lps = [m.calculate_log_probability({"w": res.samples["w"][0, :64]}, device="cuda")
               for m in (model, loaded)]
        same = (all(torch.equal(draws[0][k], draws[1][k]) for k in draws[0])
                and torch.equal(lps[0], lps[1]))
        line.update({"pickle_seconds": pickle_s, "pickle_bytes": (work / "model.pkl").stat().st_size,
                     "pickle_bit_identical": same})
        check(same, "aux: the loaded model's draws or log density differ")
    else:
        line["cloudpickle"] = {"not_run": "cloudpickle is not installed"}
    if present["matplotlib"]:
        from brancher_torch.visualizations import plot_posterior

        t0 = time.perf_counter()
        plot_posterior(res, variables=["w"]).savefig(str(work / "posterior.png"))
        line["plot_seconds"] = time.perf_counter() - t0
    else:
        line["matplotlib"] = {"not_run": "matplotlib is not installed"}
    _aux_line(line)


# ---------------------------------------------------------------------------
# Phase 17: every sharded mode through a one-rank NCCL group.  PMMH's depth
# (warmup, draws), here and in phase 12, is cut from the JAX tests' 200 +
# 400 to 50 + 100, printed as "reduced": at 200 + 400 its two runs took
# 68.4 s of the phase's 117.9 on an H100 (700 W), at 150 + 300 56.6 s of a
# whole script of 1124.4 s on a slow host, and at 100 + 200 the four runs
# of phases 12 and 17 took 55.8 s of a script that ran over its 1200 s on
# a slow host (PERF.md).
PMMH17_DEPTH = (50, 100)
# the sharded floor's draws and the sharded dense run's depth, cut for time
# ("reduced"; phase 3's floor is compared by ms a leaf iteration)
SHARDED_FLOOR_DRAWS = 500
SHARDED_DENSE_DEPTH = (250, 500)
COLLECTIVE_TIMEOUT_S = 300


def _sharded_line(info: dict, section: str, tag: str) -> dict:
    """A phase-17 line, kept under RESULTS[section][tag]."""
    info.update({"phase": 17, "nvidia_smi": RESULTS["environment"]["nvidia_smi"]})
    emit(info)
    RESULTS.setdefault(section, {})[tag] = info
    return info


def _sharded_mcmc(meshes):
    """The sharded MCMC and SVI runs at full width."""
    import numpy as np
    from brancher_torch.inference import NUTS, ChEESHMC
    from brancher_torch.models import conjugate_normal_model

    chain = meshes["chain"]
    # floor NUTS, phase 3's config, the rank's [C / n, D] block on K1
    _floor_run("sharded_floor", "auto", "glm_bernoulli_f32", 17, SHARDED_FLOOR_DRAWS,
               kernel=NUTS(max_depth=8), fused_potential="auto", mesh=chain,
               reduced={"num_samples": [1000, SHARDED_FLOOR_DRAWS]})
    run = RESULTS["sharded_floor"]["auto"]
    if "floor" in RESULTS:  # phase 3 ran: the same run without a mesh, on the same card
        key = "sampling_ms_per_iteration"
        run["unsharded_" + key] = RESULTS["floor"]["auto"][key]
        emit({"phase": 17, "compare": f"sharded_floor/auto vs floor/auto {key}",
              "sharded": run[key], "unsharded": run["unsharded_" + key]})

    # floor ChEES with K5 on the rank's block
    _, _, model = _floor_model()
    res, info = _run_sample(model, "sharded_chees/fused", "glm_bernoulli_f32",
                            transition_kernel="leapfrog_f32", kernel=ChEESHMC(), num_warmup=500,
                            num_samples=1000, num_chains=1024, key=3, fused_leapfrog=True,
                            mesh=chain)
    mean, sd, ess, rhat = _post_stats(res, "w")
    info.update({"min_ess": float(ess.min()), "max_rhat": float(rhat.max()),
                 "ess_per_second": float(ess.min()) / info["sampler_seconds"]})
    _sharded_line(info, "sharded_chees", "fused")
    check(info["max_rhat"] < 1.01, f"sharded_chees: max R-hat {info['max_rhat']}")
    ref = RESULTS.get("chees_fused_moments", RESULTS.get("floor_auto_moments"))
    if ref is not None:
        _mcse_compare(17, "sharded_chees/fused vs chees/fused" if "chees_fused_moments" in RESULTS
                      else "sharded_chees/fused vs floor/auto", ref, (mean, sd, ess),
                      "sharded_chees")

    # the per-chain runner over the rank's block (autodiff, no kernel)
    _floor_run("sharded_shard_map", "auto", None, 17, 200, warmup=200, kernel=NUTS(max_depth=8),
               chain_method="shard_map", mesh=chain)
    if "floor_vmap" in RESULTS:  # phase 13 ran
        emit({"phase": 17, "compare": "sharded_shard_map/auto vs floor_vmap/auto seconds",
              "sharded": RESULTS["sharded_shard_map"]["auto"]["sampler_seconds"],
              "unsharded": RESULTS["floor_vmap"]["auto"]["sampler_seconds"]})

    # dense mass with a mesh on the conjugate model (K3 in both stages)
    model, truth = conjugate_normal_model()
    warm, draws = SHARDED_DENSE_DEPTH
    res, run = _run_sample(model, "sharded_dense/auto", "glm_normal_f32",
                           kernel=NUTS(max_depth=8), mass="dense", num_warmup=warm,
                           num_samples=draws, num_chains=64, key=1, mesh=chain)
    run["reduced"] = {"num_warmup": [500, warm], "num_samples": [1000, draws]}
    RESULTS["sharded_dense"] = {"auto": run}
    _check_conjugate(res, run, truth, 17, "sharded_dense/auto")
    check(tuple(res.diagnostics["inv_mass"].shape) == (1, 1), "sharded_dense: not a dense metric")

    # floor SVI, phase 9's config, its samples split over the batch axis
    _, _, model = _floor_model()
    res, info = _run_svi("sharded_svi/meanfield", model, 1500, False, number_samples=16, lr=0.02,
                         key=7, mesh=meshes["batch"])
    loc = res.guide.posterior_moments(res.params["q"])[0].cpu().numpy()
    check(bool(np.isfinite(loc).all()) and loc.shape == (32,), "sharded_svi: bad loc")
    if "floor_auto_moments" in RESULTS:
        info["max_abs_diff_to_nuts_mean"] = float(np.abs(loc - RESULTS["floor_auto_moments"][0]).max())
        info["tolerance"] = 0.15
    _sharded_line(info, "sharded_svi", "meanfield")
    if "tolerance" in info:
        check(info["max_abs_diff_to_nuts_mean"] < 0.15,
              f"sharded_svi: loc {info['max_abs_diff_to_nuts_mean']:.3f} from the NUTS means")


def _sharded_particles(meshes):
    """Phase 12's particle runs with mesh=, at its sizes and limits."""
    import numpy as np
    import torch
    from brancher_torch.inference import pmmh_sample, smc_sample, streaming_particle_filter
    from brancher_torch.models import LGSSMParams, kalman_filter, lgssm_state_space, make_lgssm_data

    particle = meshes["particle"]
    params = LGSSMParams()
    ssm = lgssm_state_space(params)
    t_len, p = 200, 8192
    _, ys = make_lgssm_data(t_len, params)
    ll, means, _ = kalman_filter(ys, params)
    results = {}
    for exchange in ("ppermute", "gather", "island"):
        res, info = _particle_run(f"sharded_particles/{exchange}", lambda: smc_sample(
            ssm, ys, num_particles=p, key=21, mesh=particle, exchange=exchange), phase=17)
        results[exchange] = res
        info.update({"T": t_len, "particles": p, "exchange": exchange,
                     "particle_steps_per_second": p * t_len / info["seconds"],
                     "log_marginal": float(res.log_marginal), "kalman_log_marginal": float(ll),
                     "max_filter_mean_err": float(np.abs(res.filter_means.cpu().numpy() - means).max()),
                     "min_ess": float(res.ess_history.min()), "host_syncs": res.host_syncs,
                     "host_syncs_per_step": res.host_syncs / (t_len - 1)})
        _sharded_line(info, "sharded_particles", exchange)
        check(abs(info["log_marginal"] - ll) < 0.5, f"sharded {exchange}: log-marginal off Kalman's")
        check(info["max_filter_mean_err"] < 0.08, f"sharded {exchange}: filter means off Kalman's")
        check(info["min_ess"] > 100, f"sharded {exchange}: ESS collapsed")
    ring, gather = results["ppermute"], results["gather"]
    same = all(torch.equal(getattr(ring, k), getattr(gather, k))
               for k in ("log_marginal", "particles", "weights", "filter_means", "ess_history"))
    emit({"phase": 17, "compare": "sharded ppermute vs gather", "bit_identical": same})
    check(same, "sharded ppermute and gather differ")

    t_len, p = 300, 2048
    xs_true, ys = make_lgssm_data(t_len, params, seed=0)
    kl, km, _ = kalman_filter(ys, params)
    res, info = _particle_run("sharded_particles/streaming", lambda: streaming_particle_filter(
        ssm, ys, num_particles=p, key=22, lag=16, chunk_size=64, mesh=particle), phase=17)
    fm, sm = res.filter_means.ravel(), res.smoothed_means.ravel()
    info.update({"T": t_len, "particles": p, "lag": 16, "chunk": 64,
                 "particle_steps_per_second": p * t_len / info["seconds"],
                 "log_marginal": float(res.log_marginal), "kalman_log_marginal": float(kl),
                 "max_filter_mean_err": float(np.abs(fm - km).max()),
                 "rmse_filter": float(np.sqrt(((fm - xs_true) ** 2).mean())),
                 "rmse_smoothed": float(np.sqrt(((sm - xs_true) ** 2).mean()))})
    _sharded_line(info, "sharded_particles", "streaming")
    check(info["max_filter_mean_err"] < 0.15, "sharded streaming: filter means off Kalman's")
    check(abs(info["log_marginal"] - kl) < 2.0, "sharded streaming: log-marginal off Kalman's")
    check(info["rmse_smoothed"] < info["rmse_filter"], "sharded streaming: smoothing did not help")

    _, ys = make_lgssm_data(60, LGSSMParams(a=0.85), seed=0)
    grid = _kalman_grid(ys)
    warm, draws = PMMH17_DEPTH
    for shard, mesh in (("chain", meshes["chain"]), ("particle", particle)):
        res, info = _particle_run(f"sharded_particles/pmmh_{shard}", lambda: pmmh_sample(
            _lgssm_ssm_of_theta, ys, lambda th: -0.5 * torch.sum((th / 1.5) ** 2, dim=-1),
            [float(np.arctanh(0.7))], num_samples=draws, num_warmup=warm, num_particles=128,
            num_chains=8, key=24, mesh=mesh, shard=shard), phase=17)
        info.update({"T": 60, "particles": 128, "chains": 8, "shard": shard, "num_warmup": warm,
                     "num_samples": draws, "nvidia_smi": RESULTS["environment"]["nvidia_smi"],
                     "particle_steps_per_second": 8 * 128 * 60 * (warm + draws + 1) / info["seconds"]})
        if (warm, draws) != (200, 400):
            info["reduced"] = {"num_warmup": [200, warm], "num_samples": [400, draws]}
        _grid_check(f"pmmh_{shard}", info, np.tanh(res.thetas[..., 0].cpu().numpy().ravel()),
                    float(res.accept_rate), grid, (0.05, 0.8), section="sharded_particles")


def phase_sharded():
    import tempfile

    import torch.distributed as dist
    from brancher_torch.parallel import batch_mesh, chain_mesh, initialize_distributed, particle_mesh

    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        initialize_distributed(coordinator_address=f"file://{tmp}/store", num_processes=1,
                               process_id=0, device="cuda", timeout_seconds=COLLECTIVE_TIMEOUT_S)
        try:
            meshes = {"chain": chain_mesh(), "particle": particle_mesh(), "batch": batch_mesh()}
            line = {"phase": 17, "world_size": dist.get_world_size(), "backend": dist.get_backend(),
                    "meshes": {k: [list(m.mesh_dim_names), list(m.mesh.shape)]
                               for k, m in meshes.items()},
                    "nvidia_smi": RESULTS["environment"]["nvidia_smi"]}
            emit(line)
            check(line["backend"] == "nccl", f"phase 17: backend {line['backend']}")
            _sharded_mcmc(meshes)
            _sharded_particles(meshes)
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Phase 18: the port's programs and the suite's cross-cutting checks on the
# card.  examples/torch/NN_*.py through main() at each example's own sizes;
# 06 reads scikit-learn's digits, which the card's machine lacks, so it runs
# in the CPU tests only.  A size cut for time is printed as "reduced":
# stem -> {size: (the example's, used)}.
# The whole script read 1186.3 s with every example at its size but 02's, and
# later ran over its 1200 s on a slow host with 07's and 05's depths halved
# (PERF.md): 02's trees fill (about 117 leaves a transition at its 64
# chains; the JAX package's CPU run reads 148 a chain), 118.8 s at 500 +
# 500, so its NUTS run is cut; 01's, 05's and 07's runs are cut too; and 03
# does not run here, as phase 11 runs its AR(2) (T=1000, K3) at 512 chains.
EXAMPLES_ON_CARD = ("01", "02", "04", "05", "07")
EXAMPLES_NOT_RUN = {"03": "phase 11 runs its AR(2), T=1000, on K3 at 512 chains"}
EXAMPLE_CUTS = {"01": {"svi_iterations": (2000, 1000), "num_warmup": (500, 250),
                       "num_samples": (1000, 500)},
                "02": {"num_warmup": (500, 50), "num_samples": (500, 50),
                       "svi_iterations": (2000, 1000)},
                "05": {"iterations": (2000, 500)},
                "07": {"num_warmup": (1000, 300), "num_samples": (1000, 300)}}
# the value+grad kernel each example's NUTS run launches once a call
EXAMPLE_KERNELS = {"01": "glm_normal_f32", "02": "glm_bernoulli_f32"}
# rerun pairs at the floor (make_logreg_data(1000, 32), 1024 chains), cut
# from phase 3's 500 + 1000 (bit-identity needs no depth): each pair runs
# twice at one key
RERUN_WARMUP, RERUN_DRAWS = 20, 20
RERUN_SVI_STEPS = 300
# SBC at tests/test_calibration.py's sizes, at the first of the seeds the
# CPU tests hold (0, 1, 2); the hierarchy's warmup and draws halved for time
# ("reduced": 35.6 s at 500 + 511), its draws thinned by 8 to the same 32
SBC_REPS, SBC_N_OBS, SBC_PRIOR, SBC_LIK = 128, 10, 2.0, 1.0
SBC_SEEDS = {"nuts": (0,), "chees": (0,), "hierarchy": (0,)}
SBC_HIERARCHY_WARMUP, SBC_HIERARCHY_DRAWS = 250, 255
SBC_P_MIN = 0.005
# the funnel at tests/test_divergences.py's run (16 chains, 500 + 500,
# NUTS() at max_depth 10), cut for time ("reduced"): NUTS's depth first (at
# depth 6 it read 53 leaves a draw, 56.1 s, and 313 divergences; at depth 5
# and 200 + 200, 1), then every engine's warmup and draws (at 150 + 150
# NUTS read 25 divergences, ChEES 87 and HMC 233)
FUNNEL_CHAINS, FUNNEL_WARMUP, FUNNEL_DRAWS = 16, 100, 100
FUNNEL_NUTS_DEPTH = 6


def _load_example(stem):
    import importlib.util

    path = next((HERE / "examples" / "torch").glob(f"{stem}_*.py"))
    spec = importlib.util.spec_from_file_location(f"torch_example_{stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _example_limits(stem, out, module):
    """(name, value, "<=" or ">=", limit) for each of the example's
    reference limits: the closed form (01), corr >= 0.9 (02), the least
    squares fit (03), the Kalman filter (04), a falling loss (05), Stan's
    posterior (07)."""
    import numpy as np

    if stem == "01":
        mcse = math.sqrt(out["nuts_var"] / out["min_ess"])
        return [("nuts_mean_err_in_mcse", abs(out["nuts_mean"] - out["analytic_mean"]) / mcse, "<=", 5.0),
                ("nuts_var_rel_err", abs(out["nuts_var"] / out["analytic_var"] - 1), "<=", 0.1),
                ("svi_mean_abs_err", abs(out["svi_mean"] - out["analytic_mean"]), "<=", 0.05),
                ("svi_var_rel_err", abs(out["svi_var"] / out["analytic_var"] - 1), "<=", 0.25),
                ("r_hat", out["r_hat"], "<=", 1.01)]
    if stem == "02":
        return [("corr_nuts_truth", out["corr_nuts_truth"], ">=", 0.9),
                ("corr_svi_nuts", out["corr_svi_nuts"], ">=", 0.9),
                ("max_r_hat", out["max_r_hat"], "<=", 1.01)]
    if stem == "03":
        return [("coeffs_err_in_sd", float(np.max(np.abs(out["coeffs"] - out["lsq_coeffs"])
                                                  / out["coeffs_sd"])), "<=", 4.0),
                ("noise_abs_err", abs(out["noise_scale"] - out["lsq_noise"]), "<=", 0.02),
                ("max_r_hat", out["max_r_hat"], "<=", 1.01)]
    if stem == "04":
        return [("log_marginal_abs_err", abs(out["smc_log_marginal"] - out["kalman_log_marginal"]),
                 "<=", 0.5),
                ("max_filter_mean_error", out["max_filter_mean_error"], "<=", 0.08),
                ("min_ess", out["min_ess"], ">=", 100.0)]
    if stem == "05":
        return [("loss_last_over_first_tenth", out["loss_last_tenth_mean"]
                 / out["loss_first_tenth_mean"], "<=", 0.9)]
    # 07: Stan's mu 4.4 and tau 3.6, within 5 MCSE plus the 0.05 of their rounding
    return [(f"{n}_abs_err_over_limit", abs(out[f"{n}_mean"] - ref)
             / (5 * out[f"{n}_sd"] / math.sqrt(out[f"{n}_ess"]) + 0.05), "<=", 1.0)
            for n, ref in (("mu", module.STAN_MU), ("tau", module.STAN_TAU))] + [
            ("r_hat_mu", out["r_hat_mu"], "<=", 1.01)]


def _jsonable(v):
    import numpy as np

    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return v


def _phase18_examples():
    import torch
    from brancher_torch import metrics
    from brancher_torch.ops import NUTS_LEAF

    for stem, why in EXAMPLES_NOT_RUN.items():
        emit({"phase": 18, "example": stem, "reduced": f"not run: {why}"})
    for stem in EXAMPLES_ON_CARD:
        module = _load_example(stem)
        sizes = {k: used for k, (_, used) in EXAMPLE_CUTS.get(stem, {}).items()}
        _reset_launches()
        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the recorder counts the vectorized NUTS engine's leaves, K7's launches
        with metrics.tracing() as tr:
            out = module.main(device="cuda", **sizes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in _all_kernels().items()}
        leaves = sum(c.get("nuts.leaves", 0) for c in tr.counters.values())
        kname = EXAMPLE_KERNELS.get(stem)
        limits = _example_limits(stem, out, module)
        line = {"phase": 18, "example": stem, "file": f"examples/torch/{Path(module.__file__).name}",
                "wall_seconds": wall, "launches": launches,
                "numbers": {k: _jsonable(v) for k, v in out.items()},
                "limits": [{"name": n, "value": v, "op": op, "limit": lim,
                            "ok": bool(v <= lim if op == "<=" else v >= lim)}
                           for n, v, op, lim in limits]}
        if stem in EXAMPLE_CUTS:
            line["reduced"] = {k: list(v) for k, v in EXAMPLE_CUTS[stem].items()}
        emit(line)
        RESULTS.setdefault("examples", {})[stem] = line
        for name, count in launches.items():
            want = (out["value_and_grad_calls"] if name == kname
                    else leaves if name == NUTS_LEAF.name else 0)
            check(count == want, f"example {stem}: {name} launched {count} times, expected {want}")
        if kname is not None:
            check(out["fused_family"] is not None and out["value_and_grad_calls"] > 0,
                  f"example {stem}: the fused potential did not run")
        for lim in line["limits"]:
            check(lim["ok"], f"example {stem}: {lim['name']} {lim['value']} not {lim['op']} {lim['limit']}")


def _nondeterminism_probe(fn):
    """The operations torch names as nondeterministic while ``fn`` runs
    under ``use_deterministic_algorithms(True, warn_only=True)``."""
    import warnings

    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).splitlines()[0] for w in caught})


def _rerun_line(tag, first, second, pairs, rerun):
    """A pair's line; fails, after naming what torch calls nondeterministic
    in one more run, unless every pair of tensors is equal bit for bit."""
    import torch

    same = {k: bool(torch.equal(a, b)) for k, (a, b) in pairs.items()}
    line = {"phase": 18, "rerun": tag, "bit_identical": all(same.values()), "compared": same,
            **first, "second": second}
    if not line["bit_identical"]:
        line["nondeterministic_ops"] = _nondeterminism_probe(rerun)
    emit(line)
    RESULTS.setdefault("reruns", {})[tag] = line
    check(line["bit_identical"], f"rerun {tag}: two runs at one key differ: {same}")


def _rerun_sample(tag, kname, trans=None, **kw):
    """Two floor runs at one key through _run_sample (launch checks each)."""
    _, _, model = _floor_model()
    base = dict(num_warmup=RERUN_WARMUP, num_samples=RERUN_DRAWS, num_chains=1024, key=0)
    runs = [_run_sample(model, f"reruns/{tag}", kname, transition_kernel=trans, **base, **kw)
            for _ in range(2)]
    (r1, i1), (r2, i2) = runs
    keep = ("launches", "sampler_seconds", "value_and_grad_calls", "fused_family", "fused_dtype",
            "fused_leapfrog", "leaves_per_draw", "divergences")
    first = {k: i1[k] for k in keep}
    first.update({"num_warmup": RERUN_WARMUP, "num_samples": RERUN_DRAWS, "chains": 1024,
                  "reduced": {"num_warmup": [500, RERUN_WARMUP], "num_samples": [1000, RERUN_DRAWS]}})
    second = {k: i2[k] for k in ("launches", "sampler_seconds", "value_and_grad_calls")}
    for k in ("value_and_grad_graphed", "value_and_grad_captures", "value_and_grad_capture_seconds"):
        first[k], second[k] = r1.diagnostics[k], r2.diagnostics[k]
    pairs = {"samples": (r1.samples["w"], r2.samples["w"]),
             "accept_prob": (r1.stats["accept_prob"], r2.stats["accept_prob"])}
    _rerun_line(tag, first, second, pairs,
                lambda: _run_sample(model, f"reruns/{tag}", kname, transition_kernel=trans,
                                    **base, **kw))
    if r1.diagnostics["value_and_grad_graphed"]:
        check(second["value_and_grad_captures"] == 0 and second["value_and_grad_capture_seconds"] == 0,
              f"rerun {tag}: the second call captured {second['value_and_grad_captures']} graphs")
        check(first["value_and_grad_captures"] > 0, f"rerun {tag}: the first call captured nothing")


def _phase18_reruns():
    import numpy as np
    import torch
    from brancher_torch.inference import HMC, NUTS, ChEESHMC, smc_sample
    from brancher_torch.models import LGSSMParams, lgssm_state_space, make_lgssm_data
    from brancher_torch.ops import glm

    _rerun_sample("nuts_auto", "glm_bernoulli_f32", kernel=NUTS(max_depth=8), fused_potential="auto")
    _rerun_sample("nuts_bf16", "glm_bernoulli_bf16", kernel=NUTS(max_depth=8), fused_potential="bf16")
    _rerun_sample("nuts_pipelined", "glm_bernoulli_f32", kernel=NUTS(max_depth=8, pipelined=True))
    # the autodiff value+grad, replayed from a CUDA graph: the second call
    # reuses the first one's graphs (captures 0, 0 s)
    _rerun_sample("nuts_off", None, kernel=NUTS(max_depth=8), fused_potential="off")
    _rerun_sample("hmc8_fused", "glm_bernoulli_f32", "leapfrog_f32",
                  kernel=HMC(num_integration_steps=8), fused_leapfrog=True)
    _rerun_sample("chees_fused", "glm_bernoulli_f32", "leapfrog_f32", kernel=ChEESHMC(),
                  fused_leapfrog=True)

    # the bootstrap filter at example 04's config
    params = LGSSMParams(a=0.9, q=0.3, c=1.0, r=0.5)
    _, ys = make_lgssm_data(200, params)
    ssm = lgssm_state_space(params)
    (a, b), info = _particle_run("reruns/bootstrap", lambda: [smc_sample(
        ssm, ys, num_particles=8192, key=0, device="cuda") for _ in range(2)], phase=18)
    _rerun_line("bootstrap", {**info, "T": 200, "particles": 8192}, {},
                {f: (getattr(a, f), getattr(b, f))
                 for f in ("log_marginal", "particles", "weights", "filter_means", "ess_history")},
                lambda: smc_sample(ssm, ys, num_particles=8192, key=0, device="cuda"))

    # floor SVI, RERUN_SVI_STEPS steps
    _, _, model = _floor_model()
    svi = [_run_svi("reruns/svi", model, RERUN_SVI_STEPS, False, number_samples=16, lr=0.02, key=7)
           for _ in range(2)]
    (s1, i1), (s2, i2) = svi
    _rerun_line("svi", {"launches": i1["launches"], "wall_seconds": i1["wall_seconds"],
                        "number_iterations": RERUN_SVI_STEPS,
                        "reduced": {"number_iterations": [1500, RERUN_SVI_STEPS]}},
                {"wall_seconds": i2["wall_seconds"]},
                {"loss_curve": (torch.as_tensor(np.asarray(s1.loss_curve)),
                                torch.as_tensor(np.asarray(s2.loss_curve))),
                 "q_loc": (s1.params["q"]["loc"].detach(), s2.params["q"]["loc"].detach())},
                lambda: _run_svi("reruns/svi", model, RERUN_SVI_STEPS, False, number_samples=16,
                                 lr=0.02, key=7))

    # the softmax family's scatter_add (ops/glm.py: one contributor per
    # cell), at phase 14's softmax shape: the same bits on two calls
    gen = torch.Generator(device="cuda").manual_seed(18)
    c, n, m, k = 256, 2000, 33, 10
    z = torch.randn((c, m * k), generator=gen, device="cuda")
    x = torch.randn((n, m), generator=gen, device="cuda")
    y1h = torch.nn.functional.one_hot(torch.randint(0, k, (n,), generator=gen, device="cuda"), k).float()
    cells = torch.arange(m * k, device="cuda")
    args = (z, x, y1h, torch.zeros((n, k), device="cuda"), cells // k, cells % k,
            torch.zeros(m * k, device="cuda"), torch.ones(m * k, device="cuda"))
    v1, g1 = glm.categorical_vg_reference(*args)
    v2, g2 = glm.categorical_vg_reference(*args)
    _rerun_line("categorical_vg", {"shape": [c, n, m, k]}, {},
                {"val": (v1, v2), "grad": (g1, g2)}, lambda: glm.categorical_vg_reference(*args))


def _chisquare_p(ranks, n_draws):
    import numpy as np
    import scipy.stats as st

    counts = np.bincount(ranks, minlength=n_draws + 1)
    return float(st.chisquare(counts)[1]), counts.tolist()


def _sbc_conjugate(seed):
    """tests/test_torch_calibration.py's conjugate target: (mu_true, data,
    value+grad, z0) on the card."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    mu_true = SBC_PRIOR * rs.normal(size=SBC_REPS)
    data = mu_true[:, None] + SBC_LIK * rs.normal(size=(SBC_REPS, SBC_N_OBS))
    z0 = torch.as_tensor(SBC_PRIOR * rs.normal(size=(SBC_REPS, 1)), dtype=torch.float32, device="cuda")
    d = torch.as_tensor(data, dtype=torch.float32, device="cuda")

    def vg(z):
        mu = z[:, 0]
        lp = -0.5 * (mu / SBC_PRIOR) ** 2
        ll = -0.5 * torch.sum((d - mu[:, None]) ** 2, -1) / SBC_LIK**2
        grad = -mu / SBC_PRIOR**2 + torch.sum(d - mu[:, None], -1) / SBC_LIK**2
        return lp + ll, grad[:, None]

    return torch.as_tensor(mu_true, dtype=torch.float32), data, vg, z0


def _sbc_hierarchy(seed):
    """tests/test_torch_calibration.py's non-centered hierarchy, its
    autograd value+grad replayed from a CUDA graph."""
    import numpy as np
    import torch
    from brancher_torch.inference.hmc import GraphedValueAndGrad

    j_n, n_obs, s_tau, sigma = 4, 5, 0.75, 1.0
    rs = np.random.RandomState(seed)
    u_true = s_tau * rs.normal(size=SBC_REPS)
    raw_true = rs.normal(size=(SBC_REPS, j_n))
    theta_true = np.exp(u_true)[:, None] * raw_true
    data = torch.as_tensor(theta_true[:, :, None] + sigma * rs.normal(size=(SBC_REPS, j_n, n_obs)),
                           dtype=torch.float32, device="cuda")
    z0 = torch.as_tensor(0.1 * rs.normal(size=(SBC_REPS, 1 + j_n)), dtype=torch.float32,
                         device="cuda")

    def logp_all(z):
        u, raw = z[:, 0], z[:, 1:]
        theta = torch.exp(u)[:, None] * raw
        lp = -0.5 * (u / s_tau) ** 2 - 0.5 * torch.sum(raw**2, -1)
        return lp - 0.5 * torch.sum((data - theta[:, :, None]) ** 2, (-1, -2)) / sigma**2

    def vg(z):
        with torch.enable_grad():
            zg = z.detach().requires_grad_(True)
            val = logp_all(zg)
            grad, = torch.autograd.grad(val.sum(), zg)
        return val.detach(), grad

    return u_true, theta_true, GraphedValueAndGrad(vg), z0


def _phase18_sbc():
    import numpy as np
    import torch
    from brancher_torch.inference.chees import chees_hmc
    from brancher_torch.inference.vectorized_nuts import nuts_batched
    from brancher_torch.ops import NUTS_LEAF

    post_var = 1.0 / (1 / SBC_PRIOR**2 + SBC_N_OBS / SBC_LIK**2)
    for engine, seeds in SBC_SEEDS.items():
        for seed in seeds:
            _reset_launches()
            gen = torch.Generator(device="cuda").manual_seed(seed)
            t0 = time.perf_counter()
            line = {"phase": 18, "sbc": engine, "seed": seed, "reps": SBC_REPS}
            if engine == "hierarchy":
                u_true, theta_true, vg, z0 = _sbc_hierarchy(seed)
                res = nuts_batched(vg, z0, num_warmup=SBC_HIERARCHY_WARMUP,
                                   num_samples=SBC_HIERARCHY_DRAWS, generator=gen, max_depth=8,
                                   target_accept=0.9)
                thin = res.samples[:, ::(SBC_HIERARCHY_DRAWS + 1) // 32].cpu()
                ranks_u = (thin[:, :, 0] < torch.as_tensor(u_true)[:, None]).sum(1).numpy()
                theta1 = torch.exp(thin[:, :, 0]) * thin[:, :, 1]
                ranks_t = (theta1 < torch.as_tensor(theta_true[:, 0])[:, None]).sum(1).numpy()
                line["p_u"], line["counts_u"] = _chisquare_p(ranks_u, 32)
                line["p_theta1"], line["counts_theta1"] = _chisquare_p(ranks_t, 32)
                line.update({"warmup": SBC_HIERARCHY_WARMUP, "draws": SBC_HIERARCHY_DRAWS,
                             "max_depth": 8, "target_accept": 0.9,
                             "p_values": [line["p_u"], line["p_theta1"]]})
                if (SBC_HIERARCHY_WARMUP, SBC_HIERARCHY_DRAWS) != (500, 511):
                    line["reduced"] = {"num_warmup": [500, SBC_HIERARCHY_WARMUP],
                                       "num_samples": [511, SBC_HIERARCHY_DRAWS]}
            else:
                mu_true, data, vg, z0 = _sbc_conjugate(seed)
                if engine == "nuts":
                    res = nuts_batched(vg, z0, num_warmup=300, num_samples=255, generator=gen,
                                       max_depth=6)
                    line.update({"warmup": 300, "draws": 255, "max_depth": 6})
                else:
                    res = chees_hmc(vg, z0, num_warmup=400, num_samples=255, generator=gen)
                    line.update({"warmup": 400, "draws": 255,
                                 "divergences": int(res.diverging.sum())})
                draws = res.samples[:, :, 0].cpu()
                ranks = (draws[:, ::8] < mu_true[:, None]).sum(1).numpy()
                line["p"], line["counts"] = _chisquare_p(ranks, 32)
                line["p_values"] = [line["p"]]
                analytic = post_var * data.sum(-1) / SBC_LIK**2
                line["median_mean_err"] = float(np.median(np.abs(draws.mean(-1).numpy() - analytic)))
                line["median_mean_err_limit"] = 3 * math.sqrt(post_var / 32)
            torch.cuda.synchronize()
            line["seconds"] = time.perf_counter() - t0
            line["launches"] = {name: k.launches for name, k in _all_kernels().items()}
            emit(line)
            RESULTS.setdefault("sbc", {})[f"{engine}/{seed}"] = line
            # the NUTS leaf's kernel (K7) once a leaf of the lockstep engine
            leaves = (int(res.warmup_leapfrog) + int(res.num_leapfrog.sum())
                      if engine != "chees" else 0)
            for name, count in line["launches"].items():
                want = leaves if name == NUTS_LEAF.name else 0
                check(count == want, f"sbc {engine}: {name} launched {count} times, expected {want}")
            check(all(p > SBC_P_MIN for p in line["p_values"]),
                  f"sbc {engine} seed {seed}: p {line['p_values']} <= {SBC_P_MIN}")
            if "median_mean_err" in line:
                check(line["median_mean_err"] < line["median_mean_err_limit"],
                      f"sbc {engine} seed {seed}: posterior means off the closed form")
            if engine == "chees":
                check(line["divergences"] == 0, f"sbc chees seed {seed}: divergences")


def _phase18_funnel():
    import torch
    import brancher_torch.functions as BF
    from brancher_torch import NormalVariable, ProbabilisticModel
    from brancher_torch.inference import HMC, NUTS, ChEESHMC

    v = NormalVariable(0.0, 3.0, "v")
    x = NormalVariable(torch.zeros(9), BF.exp(v / 2.0), "x")
    model = ProbabilisticModel([v, x])
    for name, kern in (("nuts", NUTS(max_depth=FUNNEL_NUTS_DEPTH)), ("chees", ChEESHMC()),
                       ("hmc", HMC())):
        res, info = _run_sample(model, f"funnel/{name}", None, kernel=kern,
                                num_warmup=FUNNEL_WARMUP, num_samples=FUNNEL_DRAWS,
                                num_chains=FUNNEL_CHAINS, key=0)
        info.update({"phase": 18, "funnel": name, "chains": FUNNEL_CHAINS,
                     "num_warmup": FUNNEL_WARMUP, "num_samples": FUNNEL_DRAWS,
                     "diverging_shape_ok": res.stats["diverging"].shape == res.stats["accept_prob"].shape})
        reduced = {}
        if name == "nuts" and FUNNEL_NUTS_DEPTH != 10:
            reduced["max_depth"] = [10, FUNNEL_NUTS_DEPTH]
        if (FUNNEL_WARMUP, FUNNEL_DRAWS) != (500, 500):
            reduced.update({"num_warmup": [500, FUNNEL_WARMUP], "num_samples": [500, FUNNEL_DRAWS]})
        if reduced:
            info["reduced"] = reduced
        emit(info)
        RESULTS.setdefault("funnel", {})[name] = info
        check(info["diverging_shape_ok"], f"funnel/{name}: diverging shaped unlike accept_prob")
        check(info["divergences"] > 0, f"funnel/{name}: no divergence on the funnel")


def phase_programs():
    import torch

    for part in (_phase18_examples, _phase18_reruns, _phase18_sbc, _phase18_funnel):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        part()
        RESULTS.setdefault("phase18_seconds", {})[part.__name__] = time.perf_counter() - t0
    emit({"phase": 18, "part_seconds": RESULTS["phase18_seconds"],
          "nvidia_smi": RESULTS["environment"]["nvidia_smi"]})


def _main_launches():
    totals = {name: 0 for name in _all_kernels()}
    for section in ("floor", "conjugate", "mxu", "mxu_linreg", "chees", "hmc_conjugate",
                    "hmc_floor", "ard", "svi_floor", "vae", "ar1", "ar1_chees", "ar2",
                    "particles", "ar2_dense", "ar2_pipelined", "floor_pipelined", "floor_vmap",
                    "conjugate_vmap", "ard_pipelined", "zoo", "enum", "aux", "sharded_floor",
                    "sharded_chees", "sharded_shard_map", "sharded_dense", "sharded_svi",
                    "sharded_particles", "examples", "reruns", "sbc", "funnel"):
        for run in RESULTS.get(section, {}).values():
            for name, count in run.get("launches", {}).items():
                totals[name] += count
    return totals


def _summary_entry(name, k, rows, main, launches, err_keys):
    check(launches > 0, f"{name} was never launched on a sample() path")
    return {
        "name": name, "route": "cuda", "source": k.source,
        "replaces": k.replaces.split()[0], "launches": launches,
        "max_abs_err": max(r[e] for r in rows for e in err_keys),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "matmul_pair_ms": main.get("matmul_pair_ms"), "tflops": main["tflops"],
        "shape": [main["C"], main["N"], main["D"]], "n_steps": main.get("n_steps"),
        "ok": all(r["ok"] for r in rows),
    }


def summary_line():
    from brancher_torch.ops import NUTS_LEAF

    main_launches = _main_launches()
    out = []
    for name, k in _all_kernels().items():
        rows = RESULTS["kernels"][name]
        if k is NUTS_LEAF:
            out.extend(_leaf_summary(rows, main_launches[name]))
            continue
        if name in MAIN_SHAPE:
            main = next(r for r in rows if r["shape"] == MAIN_SHAPE[name])
            out.append(_summary_entry(name, k, rows, main, main_launches[name],
                                      ("val_max_abs", "grad_max_abs")))
        # K3/K4, and K1's pipelined floor: one entry per path, its run's launches
        for (section, tag), shape in VG_PATHS.get(name, ()):
            main = next(r for r in rows if r["shape"] == shape)
            out.append(_summary_entry(f"{name}/{section}", k, rows, main,
                                      RESULTS[section][tag]["launches"][name],
                                      ("val_max_abs", "grad_max_abs")))
        if name in MAIN_SHAPE or name in VG_PATHS:
            continue
        # K5: one entry per path, its launches from that path's run and its
        # row at that path's shape and family, at the path's step count (or
        # the one nearest the run's leapfrogs per draw)
        for (section, tag), shape, family, steps in LEAPFROG_PATHS:
            run = RESULTS[section][tag]
            check(run["fused_family"] == family, f"{section}/{tag}: family {run['fused_family']}")
            path_rows = [r for r in rows if r["shape"] == shape and r["family"] == family]
            want = run["leaves_per_draw"] if steps is None else steps
            main = min(path_rows, key=lambda r: abs(r["n_steps"] - want))
            label = f"{name}/{section}" + ("" if tag == "fused" else f"/{tag}")
            out.append(_summary_entry(label, k, path_rows, main, run["launches"][name],
                                      ("max_abs",)))
    return {"kernels": out}


def _leaf_summary(rows, launches):
    """K7's entries: one per cell shape, with the leaves of every sample()
    path."""
    from brancher_torch.ops import NUTS_LEAF

    check(launches > 0, "nuts_leaf was never launched on a sample() path")
    return [{"name": f"{NUTS_LEAF.name}/{row['shape']}", "route": "cuda",
             "source": NUTS_LEAF.source, "replaces": "none", "launches": launches,
             "max_rel_err": max(r["max_rel"] for r in rows), "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": None, "gb_per_s": row["gb_per_s"],
             "shape": [row["C"], row["D"]], "tiling": row["tiling"],
             "ok": all(r["ok"] for r in rows)} for row in rows]


STEPS = {1: phase_environment, 2: phase_kernels, 3: phase_floor, 4: phase_conjugate,
         5: phase_mxu, 6: phase_chees, 7: phase_hmc, 8: phase_ard, 9: phase_svi_floor,
         10: phase_vae, 11: phase_ar, 12: phase_particles, 13: phase_modes, 14: phase_zoo,
         15: phase_enumeration, 16: phase_aux, 17: phase_sharded, 18: phase_programs}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="", help="comma-separated subset of 1-18 (default: all)")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import brancher_torch
    except ImportError:
        print("chip_smoke: brancher_torch is not beside this script", file=sys.stderr)
        return 2
    if Path(brancher_torch.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: brancher_torch found outside this checkout", file=sys.stderr)
        return 2

    chosen = sorted(STEPS) if not args.phases else sorted({int(p) for p in args.phases.split(",")} | {1})
    t0 = time.perf_counter()
    for num in chosen:
        t = time.perf_counter()
        STEPS[num]()
        RESULTS.setdefault("phase_seconds", {})[num] = time.perf_counter() - t
    RESULTS["total_seconds"] = time.perf_counter() - t0
    emit({"phase": 19, "phase_seconds": RESULTS["phase_seconds"], "total_seconds": RESULTS["total_seconds"]})
    if chosen != sorted(STEPS):
        return 0  # a subset: no summary, no "ok" line
    emit(summary_line())
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
