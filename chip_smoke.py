#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--baseline OLD.cu]

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit; TF32 must be off;
  2. build the CUDA kernels from ``apg_trajectory_tracking_tpu_torch/csrc``
     (and an empty kernel for the launch floor), one nvcc each, in parallel;
  3. forward kernel vs its plain twin, B in {1, 8, 31, 32, 33, 4096, 4097}
     (whole and ragged tiles of 8 and 32 rows), k in {1, 10, 11, 32}
     (around the 10-step chunks), and B in {512, 1024, 2048} at k = 10
     (the multihost legs' batches), default params and a set with drag
     and a tilted gravity vector, and on aligned views one row into
     larger tensors;
  4. backward kernel vs the hand-derived plain backward and vs torch
     autograd of the twin, at the same shapes; then the wing's two
     kernels (``csrc/wing_rollout.cu``) the same way, B in {1, 8, 33,
     4096, 4097}, k in {1, 10, 11}, default params and a mismatched lift
     slope (CL_alpha 3.0), a third of the rows beyond the alpha clamp,
     and on aligned views; then the nets' reference-branch kernels
     (``csrc/conv_ref.cu``): the forward bit-equal to cuDNN's float32
     convolution, bias and ReLU, and the forward and the input, weight
     and bias gradients against a float64 twin beside cuDNN's float32
     error, B in {1, 8, 4097, 65536}, H in {10, 20}; each timed at
     B = 4096 and 65536 beside its byte bound and cuDNN's time for the
     same function;
  5. shipped controllers, carried across from the JAX npz, flown on the
     card and on the CPU: ``assets/quad_trained_9k``,
     ``assets/quad_ar_trained`` and ``assets/quad_lstm_trained`` (a
     20-row window, the LSTM from a zero carry) over the same 10 test
     references of the numpy-generated bank, and ``assets/wing_trained``
     to 10 fixed waypoints, 1000 steps at test time;
  6. the training paths, each with every launch count set to 0 just
     before it and read just after: ``TrainQuad`` from
     ``configs/quad_config.json`` for 1 epoch in the concurrent mode (the
     main path: one launch of each kernel per step) and 1 epoch each in
     the autoregressive and LSTM modes (horizon launches of each kernel
     per step, at k = 1), and ``TrainWing`` from
     ``configs/wing_config.json`` with 500 of its 2000 self-play rows for
     1 epoch (one launch of each wing kernel per step, none of the
     quad's); each with a finite loss and a checkpoint that reloads
     bit-equal; and the conv kernels' launches (``CONV_PER_STEP``: the
     concurrent step 1 forward, 1 weight-gradient pair, no input
     gradient; the recurrent steps 10, 10 and 9 input gradients; the wing
     none; the epoch's evaluation a forward per net call);
  7. timings: the concurrent, autoregressive, LSTM and wing train steps
     at B = 8 (the shipped configs' batch) and B = 4096 (the wing's first
     call launching one of each wing kernel), and each kernel, quad and
     wing, at B = 8 and 4096 with k = 10 and k = 1, beside its bound, its
     plain twin (k = 10; the quad's at B = 4096) and the device time of an
     empty kernel;
  8. only with ``--baseline OLD.cu``: another source with the same C
     interface, such as an earlier revision of ``csrc/quad_rollout.cu``,
     built and checked against the plain versions, then timed with the
     port's kernels in turns (baseline, port, port, baseline) at B = 8 and
     4096, k = 10;
  9. the three shipped cartpole controllers (``assets/cartpole_trained``,
     ``cartpole_balance_trained``, ``cartpole_swingup_trained``), carried
     across from the JAX npz, through the balance protocol (10 episodes x
     250 steps from rest) and the swing-up protocol (10 starts from one
     seeded generator, 250 steps, burn-in 100) on the card and on the CPU;
  10. ``TrainCartpole`` from ``configs/cartpole_config.json`` for 2 epochs
     in swing-up mode (epoch 0 never saves a best model), with its launch
     counts set to 0 just before and read just after (no rollout kernel),
     a finite loss and a final checkpoint that reloads bit-equal;
  11. the solvers: the Flightmare labelling solve of
     ``scripts/distill_mpc.py`` (one batched solve of 8000 bank states, H =
     10, 50 Adam iterations) with its launch counts set to 0 just before
     and read just after (50 of each kernel), held against the same solve
     on the plain twin, timed, and the kernels timed at B = 8000 beside
     their bound; short closed loops of the Adam ``MPC`` on all six
     dynamics models (50 iterations per control step, 1-3 control steps);
     the iLQR solve of 8 states near hover on the card against the CPU; the
     first control steps of the swing-up protocol under the iLQR and the
     CEM controllers on the card and on the CPU, the CPU's closed loop
     driving both, with each episode's choice of start and costs logged.
     The eager solvers launch tens of thousands of kernels per control
     step, so a whole 250-step swing-up protocol does not fit in this run;
  12. adaptation, each leg (evaluation, dynamics fit, controller epoch)
     with its launch counts set to 0 just before each call and read just
     after: ``TrainQuadAdapt`` with the settings of
     ``scripts/adapt_quad.py`` (from ``assets/quad_trained_9k``, 512 + 256
     buffer rows, speed 0.4, the rate/drag sysid at base_lr 0.02, the
     translational-drag x1.9 plant) for 3 epochs, two of them fitting the
     dynamics (no kernel) and one training the controller against the
     learnt model (10 launches of each kernel per step, at k = 1); after
     the sysid, one controller step on the kernels held against the same
     step on the plain twin; the one-step gaps, the true-plant eval and a
     bit-equal reload; the controller and fit steps timed. Then
     ``TrainWingAdapt`` (from ``assets/wing_trained``, CL_alpha 3.0 and
     CD0 0.15, 64 + 64 rows, the config's l2 0.01) for 2 epochs and
     ``TrainCartpoleAdapt`` (wind 0.5, 256 states) for 3, with no kernel,
     finite losses and models, and the cartpole's learnt step on the card
     against the CPU;
  13. the baselines, each path with its launch counts set to 0 just
     before it and read just after: one PPO train iteration of each env
     (cartpole, quad with the mpc reward, wing) at 16 envs x 128 steps on
     the card and on the CPU from the same draws, then 3 more on the card,
     and ``evaluate_policy`` of the quad (one forward-kernel launch per
     env step, none of the backward); the shipped PPO controllers
     (``assets/quad_ppo_2m``, ``quad_ppo_mpc_2m`` through ``run_eval`` on
     the 20 test references at speed 0.4, lifted 3 m; ``wing_ppo_500k`` to
     10 waypoints; ``cartpole_ppo_500k`` from 10 starts) on card and CPU;
     one PETS trial per system (the quad's plant one forward launch per
     env step), the shipped PETS ensembles flown on the card under the
     head-to-head evaluators, and 3 control steps of each on card and CPU
     from the same draws (plans within 1e-3, the same elites);
  14. the comparison tables' controllers and the analytic references, each
     path with its launch counts set to 0 just before it and read just
     after: the quad MPC closed loop (``mpc_follow_trajectories``) of the
     Adam solve at h = 10 and 50 iterations on 4 test references of the
     200/20 bank picked by ``quad_references``' rule, 20 control steps on
     the card and on the CPU (exactly 20 x 50 launches of each kernel on
     the card), then 2 control steps each at h = 14 and h = 20 with 100
     iterations and 3 iLQR control steps card vs CPU (no kernel); the
     rows through ``tracking_metrics`` and ``format_table``; the wing MPC
     (``mpc_fly_to_point``, h = 10, 10 iterations, 2 control steps to 2
     targets) and the cartpole MPC (``make_cartpole_mpc_apply`` through
     ``evaluate_balance``, 2 starts, 2 steps) card vs CPU; the shipped
     ``quad_minjerk_trained`` and ``quad_trained`` through
     ``follow_analytic`` on the hover, straight and circle references as
     the quad eval CLI sets them up (10 episodes, 251 steps) card vs CPU;
     one epoch of ``TrainQuad`` with ``minjerk_mix`` 0.5 at the shipped
     config (its mixed windows card vs CPU, one launch of each kernel per
     step, the mix saved in ``config.json``); both kernels against their
     plain twins at the table's new shapes (B = 4 and 100, k = 14 and 20);
  15. distillation (``training/distill.py``), each run with its launch
     counts set to 0 just before it and read just after, and each stage
     (labelling call, fit, teacher rollout, evaluation, DAgger flight)
     timed with its launches: the feed-forward student at the CLI's widths
     (8000 pairs, batch 256, hidden 64, h = 10, 50 iterations) on the
     200/20 bank, cut to 100 steps and one DAgger round of 20 rollouts
     (every labelling call exactly 50 launches of each kernel, nothing
     else any), then one resumed round from its checkpoint with
     ``--failure_focus --select stable``; the LSTM student (hidden 64, h =
     20, 30 teacher rollouts at 20 iterations, 4 steps, one round; the
     teacher exactly 251 x 20 launches of each kernel); the wing student
     (6000 pairs, h = 20, 5 iterations, 200 steps, one round; no launch);
     tiny quad and LSTM runs on card and CPU from the same initial nets
     (round metrics within 1e-3 relative, saved weights within 1e-4; the
     LSTM's own teacher card vs CPU over 6 steps, then both runs on the
     CPU's teacher sequences); the wing, cartpole (balance and swing-up)
     and epoch-sweep eval CLIs on the card against themselves with
     ``--cpu`` (no launch), the sweep over a 2-epoch ``train_quad`` run;
  16. the published-results pipeline (``evaluation/tables.py`` and the
     analysis modules), each path with its launch counts set to 0 just
     before it and read just after: the tables' wide, wall (no MPC row),
     speed and analytic sections, each for a few of its models, and the
     swing-up APG rows at the ``--quick`` sizes on the card and on the
     CPU, the quad protocols on the 200/20 bank, the robustness sweep for
     one model at factors 1.0 and 1.9 (rows within 1e-3 relative, counts
     equal, no launch); the wall's ``MPC
     (adam, h=20)`` row at 100 iterations for 3 control steps (exactly 300
     launches of each kernel); 5 concurrent steps of the rate-cap ablation
     at scale 2 (one launch of each kernel per step) and its widened unroll
     on the kernels against the twin, forward and gradient; one cell of
     the quad adaptation protocol (``training/adapt_protocol.py``, 1 fit
     epoch and 1 controller epoch: 10 launches of each kernel per
     controller step, none elsewhere) writing its JSON; and ``python -m
     ...evaluation.tables --quick --sections wing --skip_mpc`` into a
     temporary directory on the card, the repo's README.md and docs/
     hashed before and after;
  17. the image and sequence cartpole and the deployment path, each path
     with its launch counts set to 0 just before it and read just after:
     ``collect_image_rollouts`` at the trainer's 64 rollouts x 20 steps
     (1,280 stacks of 5 x 50 x 60) card vs CPU on the same draws;
     ``fit_image_dynamics`` for 2 of its 20 epochs at batch 64 and
     ``fit_sequence_dynamics`` for 3 of its 30, card vs CPU from the same
     data, net and batches, one more image-fit epoch timed on the warm
     card; both one-step gaps; the image RL env (16 envs, reset and 5
     steps) card vs CPU; the DQN net forward and backward at (64, 3, 100,
     120) on the card and the CPU against a float64 reference (none of
     these launches a rollout kernel); then the native runtime built with
     g++, ``assets/quad_trained``, ``quad_lstm_trained``, ``wing_trained``
     and ``cartpole_trained`` exported, each one's native decisions held
     to the port's net on the card; ``evaluate_external`` with the C++
     and the mock backend on 4 references of the 200/20 bank against
     ``run_eval`` on the card (the native loop launches nothing, the mock
     exactly one forward kernel per control step and no backward), the
     mock's step against the plain twin, and the quad eval CLI with
     ``--external_sim native`` and ``mock`` on the card against
     ``--cpu``;
  18. data parallel on ``torch.distributed`` and the infrastructure, at
     the shipped quad config's widths (hidden 64, conv 20, h = 10, batch
     8) for 2 epochs: a plain ``TrainQuad`` (concurrent) and one with the
     mesh of an NCCL process group of one, each with its launch counts
     set to 0 just before it and read just after (one launch of each
     kernel per step), every loss, eval metric and parameter equal bit
     for bit; a ``debug.trace`` of 3 mesh train steps (the Chrome trace
     names both rollout kernels and one ``nccl:all_reduce`` per step; the
     NCCL kernels are counted too); the step
     timed with the all-reduce and without it; the multihost smoke with
     two ranks on the one card through gloo (both ranks report the same
     loss and checksum, within 1e-5 relative of one process; the sharded
     ``run_eval`` at 5 episodes, padded to 6, within 1e-6 of one
     process); the multihost smoke's ``--bench`` (two gloo ranks on the
     card, then one process, 16384 rows in minibatches of 4096, 3 timed
     epochs) and ``--sweep`` (one process, then two ranks, at 4096 rows
     in minibatches of 1024, 3 timed epochs and 10 timed all-reduces;
     the kernels are held against their twins at the legs' batches in
     phases 3-4), each record written to a temporary ``--out``
     and printed, each worker's launches counted over its timed epochs
     (one of each kernel per step), every time finite and positive, the
     repo's ``MULTIHOST_BENCH.json`` unchanged; the mesh trainer logs to
     TensorBoard and writes
     ``performance.png``, and the quad eval CLI runs ``--animate`` and
     ``--live`` on the card, where tensorboard and matplotlib are
     installed (the phase prints which step did not run where one is
     absent);
  19. the four measuring modules (``apg_trajectory_tracking_tpu_torch/
     perf``), each with its launch counts set to 0 just before it and
     read just after, each printing its table and its JSON on a line of
     its own: ``perf.latency`` at ``--n 10``, B = 1 and 1024 (the
     swing-up row timed once, after one warm call: a decision takes
     seconds), every Adam row exactly 50 launches of each kernel per
     decision and every other row none; ``perf.ab`` at B = 4096, 10
     steps per call, 3 rounds of 2 calls (its loss agreement must hold:
     ``base`` and ``halfsplit`` on the kernels, one and two launches of
     each per step); ``perf.layout`` at B = 4096, 16384 and 65536, 5
     steps per call, 2 calls (its parity check must hold; one launch of
     each kernel per AoS step); ``perf.scaling`` at D = 1 (the card
     count), 4096 rows per card, 5 steps per epoch (its rank's launches
     reported by the worker process, one of each per step);
  20. the headline bench and the JAX repo's entry points, each with its
     launch counts set to 0 just before it and read just after: ``python
     -m apg_trajectory_tracking_tpu_torch.bench`` at its defaults (B =
     4096, 16384 and 65536; its JSON line printed after ``[20] bench
     JSON:``), exactly one launch of each kernel per step and its counts
     from shapes at B = 4096 equal to the host's; both kernels against
     their plain twins (phases 3-4's tolerances) and timed beside their
     bounds and their twins at B = 16384 and 65536, k = 10;
     ``benchmark_rollout`` at B = 4096 (101 forward launches); ``entry()``
     on the card against the CPU (one forward launch); and
     ``dryrun_multichip(1)``, every check of the JAX repo's dry run on an
     NCCL group of one in a worker process, whose launches it reports
     (one of each kernel in the concurrent step, 10 in the LSTM step, one
     per step of the trainer's epoch, none in the fit and the
     evaluation).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import copy
import ctypes
import functools
import importlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

B_LIST = (1, 8, 31, 32, 33, 4096, 4097)
K_LIST = (1, 10, 11, 32)
HORIZON = 10
# the wing's train-step Euler step (configs/wing_config.json delta_t_train)
WING_DT = 0.05
DT = 0.1
TIMING_B = 4096
TRAIN_B = 8  # the batch of configs/quad_config.json
TIMING_RUNS = 50
# forward tolerance of the Pallas kernel's own test (rtol 1e-4, atol 1e-5);
# the backward's atol scales with the gradient's largest magnitude
RTOL, ATOL = 1e-4, 1e-5
BWD_ATOL_REL = 1e-5
# at most this many of the 10 eval episodes may flip their success flag
# between card and CPU (float rounding compounds over the closed loop)
MAX_FLIPS = 2
# (timed, profiled) runs of each train step in phase 7: the recurrent and
# wing steps launch thousands of kernels each, and the profiler's trace
# of them takes long to process
STEP_RUNS = {"concurrent": (TIMING_RUNS, TIMING_RUNS),
             "autoregressive": (10, 2), "LSTM": (10, 2), "wing": (10, 2),
             "cartpole": (10, 2)}
CARTPOLE_ASSETS = ("cartpole_trained", "cartpole_balance_trained",
                   "cartpole_swingup_trained")
# the batch of one labelling solve (scripts/distill_mpc.py --n_pairs) and
# the Adam iterations of every MPC solve (--mpc_iters, MPC's default)
LABEL_B = 8000
MPC_ITERS = 50
# the labelling solve against its plain twin: the 50-iteration shooting
# solve's bounds (tests/test_torch_controllers.py), cost rtol 1e-4 with an
# atol of 1e-5 for the costs near 0 of states that start on their
# reference, and u atol 1e-3
SOLVE_RTOL, SOLVE_COST_ATOL, SOLVE_ATOL = 1e-4, 1e-5, 1e-3
# control steps of each model in the closed loops of phase 11, each of
# MPC_ITERS Adam iterations. The eager solvers are host-bound: one H100
# took 24-34 s per control step of the RK4 quaternion model and 7-8 s of
# the 3D wing, 2-3 s of the others
CONTROL_STEPS = {"flightmare": 3, "simple_quad": 1, "high_mpc": 1,
                 "cartpole": 1, "fixed_wing_3D": 1, "fixed_wing_2D": 1}
# control steps of the swing-up protocol under each solver (iLQR: 8-13 s
# per control step of 10 episodes on one H100)
SWINGUP_STEPS = {"iLQR": 1, "CEM": 3}
# the swing-up iLQR on the card against the CPU. Its float32 solve is
# chaotic (tests/test_torch_ilqr_cem.py: at its default iterations a
# float64 solve parts from it by the whole action range in 4 of 6
# episodes), so its plans are not compared. Instead: the cost the card
# reports for each accepted plan against that plan's cost in float64 on
# the CPU (on the CPU, the float32 cost of these plans drifts from the
# float64 cost by up to 8.6e-4 relative), and the total cost of the 10
# accepted plans against the CPU's (the local minima of float32 and float64
# solves differ by up to 12 % in one episode, 2 % in the total)
SWINGUP_COST_RTOL = 5e-3
SWINGUP_TOTAL_RTOL = 0.1
# the CEM on the same noise on card and CPU: plan gap (observed 2.2e-4)
CEM_PLAN_ATOL = 1e-3
# the iLQR's machinery (torch.func derivatives, batched Riccati pass, line
# search) on a well-conditioned problem, card against CPU: 8 states near
# hover, 10 iterations. On the CPU float32 and float64 solves of these
# states differ by up to 4.8e-4 in u and 1.8e-7 relative in cost
ILQR_HOVER_ATOL, ILQR_HOVER_COST_RTOL = 2e-3, 1e-4

# phase 6's wing path at a quarter of the config's 2000 self-play rows (62
# steps instead of 250, and a quarter of the ring-filling flights before
# epoch 0), cut from half to make room for phase 16 within about 450 s
PHASE6_WING_CFG = {"self_play": 500}
# phase 12: scripts/adapt_quad.py's settings and its translational-drag
# cell, 2 fit epochs then 1 controller epoch; the wing and cartpole
# adaptations at the sizes of the JAX package's adaptation tests
ADAPT_QUAD_CFG = {"epoch_size": 512, "self_play": 0.5, "speed_factor": 0.4,
                  "learning_rate_base": 0.02}
ADAPT_QUAD_CELL = "trans"
ADAPT_WING_CFG = {"epoch_size": 64, "self_play": 64, "batch_size": 8}
ADAPT_WING_MISMATCH = {"CL_alpha": 3.0, "CD0": 0.15}
ADAPT_CARTPOLE_CFG = {"sample_data": 256}
# a learnt step on the card against the CPU: the single-step bar of the
# dynamics tests
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
# (timed, profiled) runs of the adaptation's controller and fit steps
ADAPT_STEP_RUNS = (10, 3)
# phase 13: PPO at the CLI's width (16 envs x 128 steps, PPOConfig's 10
# epochs of 8 minibatches; the quad env with the mpc reward at speed 0.4,
# as assets/quad_ppo_mpc_2m was trained), one iteration per env on card
# and CPU from the same draws, then PPO_CARD_ITERS more on the card;
# evaluate_policy at its defaults (20 episodes, 500 steps)
PPO_ENVS, PPO_STEPS, PPO_CARD_ITERS = 16, 128, 3
PPO_SPEED = 0.4
PPO_EVAL_EPISODES, PPO_EVAL_STEPS = 20, 500
# card vs CPU after one iteration: every parameter within PPO_PARAM_ATOL,
# or within Adam's step bound (lr per update) on a leaf whose gradient is
# at float roundoff
PPO_PARAM_ATOL = 1e-4
# the shipped PPO and PETS controllers, card vs CPU: no success flip;
# divergence and target error within this relative gap
BASELINE_METRIC_RTOL = 1e-3
# the shipped cartpole PPO policy is bang-bang: roundoff between two closed
# loops grows about 4x per step and flips a saturated action within 10
# steps (tests/test_torch_pets.py), so its velocity is compared over the
# first 5 steps
CARTPOLE_PPO_SHORT_STEPS, CARTPOLE_PPO_SHORT_RTOL = 5, 1e-4
# the wing PPO flight stops at WING_PPO_STEPS of the protocol's 1000: every
# episode has ended by then (asserted; they pass at about 95 steps), so the
# metrics are the 1000-step protocol's
WING_PPO_STEPS = 300
# PETS: one trial per system of PETS_TRIAL_LENGTH steps after the
# exploration trial of the same length (the runners' 200 cut), the
# runners' planner (horizon 10, population 150, 15 elites, 5 particles, 5
# CEM iterations); the shipped ensembles fly 4 quad references for
# PETS_QUAD_STEPS control steps, 4 wing targets and 2 cartpole starts for
# PETS_CARTPOLE_STEPS (the protocol: 50 references for 251 steps, 50
# targets, 50 starts of 250 steps; a PETS control step takes about 55 ms
# on the card); then PETS_PLAN_STEPS control steps of PETS_PLAN_EPISODES
# episodes of each on card and CPU from the same draws, the CPU's closed
# loop driving both
PETS_TRIAL_LENGTH = 20
PETS_QUAD_REFS, PETS_WING_TARGETS, PETS_CARTPOLE_STARTS = 4, 4, 2
PETS_QUAD_STEPS, PETS_CARTPOLE_STEPS = 100, 50
PETS_PLAN_STEPS, PETS_PLAN_EPISODES = 3, 2
PETS_PLAN_ATOL = 1e-3
# a CEM iteration's returns card vs CPU, relative to the largest |return|
# (observed 7.6e-6 absolute on returns of about 38: 2e-7). Late iterations
# pull the population together, so the 15th and 16th returns can tie
# within that gap (observed: 37.6973991 and 37.6973953 on the CPU, equal
# on the card), and the card may keep the other one
PETS_RETURN_RTOL = 1e-5
# phase 14: the quad MPC closed loop of the comparison table (h = 10, 50
# Adam iterations) on MPC_REFS test references for MPC_STEPS control
# steps, card vs CPU; the CLI's wider rows (h, iterations) for
# MPC_WIDE_STEPS steps on the card; ILQR_STEPS iLQR control steps card vs
# CPU; the wing MPC (WING_MPC_ITERS iterations, h = 10) and the cartpole
# MPC (50 iterations) for 2 control steps from 2 targets and 2 starts (a
# 50-iteration wing control step takes about 7 s on the card)
MPC_REFS, MPC_STEPS, MPC_ITERS_H10 = 4, 20, 50
MPC_WIDE = ((14, 100), (20, 100))
MPC_WIDE_STEPS, ILQR_STEPS = 2, 3
WING_MPC_ITERS, SYSTEM_MPC_STEPS, SYSTEM_MPC_EPISODES = 10, 2, 2
MPC_CARD_ATOL = 1e-3
# the analytic flights of the quad eval CLI (its default -a 10, 251 steps)
ANALYTIC_ASSETS = ("quad_minjerk_trained", "quad_trained")
ANALYTIC_REFS = ("hover", "straight", "circle")
ANALYTIC_N, ANALYTIC_STEPS = 10, 251
ANALYTIC_RTOL = 1e-4
# the mixed windows card vs CPU, relative to their largest |value| (the
# positions, up to about 10 m; the card contracts the quintic's
# multiply-adds, observed 3.05e-5 absolute)
MINJERK_MIX, MIX_RTOL = 0.5, 1e-5
# the kernels at the comparison table's shapes
NEW_B, NEW_K = (4, 100), (14, 20)
# phase 15: the distillation CLI's widths on the 200/20 bank, cut in depth
# (the CLI: 4000 steps, 3 DAgger rounds, 50 evaluation references, of
# which the 200/20 bank's test split holds 20). The steps were cut from
# 500 (quad) and 20 (LSTM) after a whole run took 486.4 s on one H100
# 80GB HBM3 at 700 W (phase 15 97.9 s, 17.8 s of it the LSTM's 30 BPTT
# steps at 0.57 s each)
DISTILL_QUAD = ["--n_pairs", "8000", "--batch", "256", "--hidden", "64",
                "--teacher_horizon", "10", "--mpc_iters", "50", "--speed",
                "0.4"]
DISTILL_QUAD_CUTS = ["--steps", "100", "--dagger_iters", "1",
                     "--dagger_rollouts", "20", "--eval", "50"]
# the LSTM student at the CLI's hidden 64 and h = 20 (the CLI: 100
# iterations, 1500 steps, 4 rounds), the wing at its 6000 pairs and h = 20
# (the CLI: 100 iterations, 4000 steps, 4 rounds)
DISTILL_LSTM = ["--hidden", "64", "--teacher_horizon", "20", "--rollouts",
                "30", "--seq_batch", "32", "--speed", "0.4"]
DISTILL_LSTM_CUTS = ["--mpc_iters", "20", "--steps", "4", "--dagger_iters",
                     "1", "--dagger_rollouts", "20", "--eval", "50"]
DISTILL_WING = ["--n_pairs", "6000", "--batch", "256", "--teacher_horizon",
                "20"]
DISTILL_WING_CUTS = ["--mpc_iters", "5", "--steps", "200", "--dagger_iters",
                     "1", "--dagger_rollouts", "20", "--eval", "20"]
# the tiny runs card vs CPU, at the CPU tests' sizes and bounds
# (tests/test_torch_distill.py, tests/test_torch_distill_lstm.py): round
# metrics 1e-3 relative, saved weights 1e-4; the LSTM's own teacher card
# vs CPU over TINY_TEACHER_STEPS steps within 1e-4 (the warm-started
# teacher is chaotic under roundoff over 251 steps, so the tiny LSTM run
# takes the CPU's teacher sequences on both sides)
TINY_QUAD = ["--n_pairs", "32", "--steps", "20", "--batch", "16",
             "--dagger_iters", "1", "--dagger_rollouts", "2", "--eval", "2",
             "--mpc_iters", "3"]
TINY_LSTM = ["--rollouts", "2", "--steps", "4", "--seq_batch", "2",
             "--dagger_iters", "1", "--dagger_rollouts", "2", "--eval", "2",
             "--mpc_iters", "3", "--hidden", "16", "--teacher_horizon", "10"]
ROUND_RTOL, NPZ_ATOL, TEACHER_ATOL, TINY_TEACHER_STEPS = 1e-3, 1e-4, 1e-4, 6
# the eval CLIs card vs CPU: counts equal, errors and velocities 1e-3
# relative
EVAL_CLI_RTOL = 1e-3
# phase 16: the tables' sections at their --quick sizes (wide 4, wall 3,
# speeds 2, robustness 2, swing-up 3 references or starts), the quad
# protocols on the 200/20 bank; card vs CPU within the CPU tests' row bar
# (tests/test_torch_tables.py): counts equal, errors and velocities 1e-3
# relative plus 1e-6. The card flies a 251-step closed loop in about 0.5
# s, so each section flies a few of its models (the feed-forward, LSTM
# and wide-window kinds among them; the analytic section a model that
# phase 14 does not fly), and the robustness sweep one model's 6
# parameters at factors 1.0 and 1.9 (12 of its 60 cells: the whole sweep
# took 42.8 s on the card)
TABLES_ROW_RTOL, TABLES_ROW_ATOL = 1e-3, 1e-6
TABLES_ROBUSTNESS_FACTORS = (1.0, 1.9)
TABLES_QUICK = {"wide_eval": 4, "wall_eval": 3, "speed_eval": 2,
                "robustness_eval": 2, "swingup_eval": 3}
TABLES_MODELS = {
    "WIDE_MODELS": ["assets/quad_mpc_distilled_stable_ff",
                    "assets/quad_mpc_distilled_lstm_h14",
                    "assets/quad_mpc_distilled_stable",
                    "assets/reference_pretrained"],
    "WALL_MODELS": ["assets/quad_mpc_distilled_s05_ff",
                    "assets/quad_mpc_distilled_s05_h14"],
    "SPEED_MODELS": ["assets/quad_trained_9k"],
    "ROBUSTNESS_MODELS": ["assets/quad_trained_9k"],
    "ANALYTIC_MODELS": ["assets/quad_mpc_distilled_h14"],
}
# the wall row's h = 20 Adam MPC at its 100 iterations, cut to a few control
# steps (its 251-step protocol is minutes on the card)
WALL_MPC_STEPS = 3
# the rate-cap ablation's widened step (scale 2) in concurrent training at
# the quad config's batch 8, speed 0.5, no curriculum: RATE_CAP_ROWS / 8
# steps; the widened unroll on the kernels against the twin at B = 1024
RATE_CAP_SCALE = 2.0
RATE_CAP_ROWS = 40
RATE_CAP_B = 1024
# the quad adaptation protocol: one cell (translational drag x1.9) at its
# 512 + 256 rows, cut to 1 fit epoch and 1 controller epoch, 2 references
ADAPT_PROTOCOL_ARGS = ["--eval", "2", "--cells", "trans", "--epochs", "2",
                       "--dyn_epochs", "0"]
# phase 17: the image and sequence cartpole at the JAX trainers' defaults
# (64 rollouts x 20 steps, batch 64), the fits cut to 2 of 20 and 3 of 30
# epochs; the image env at 16 envs for 5 steps; the DQN net at batch 64.
# Card vs CPU: the collections and the env's frames within 1e-5; a fit's
# losses within 1e-2 relative and each leaf's gap within 10% (in norm) of
# the distance the CPU's fit moved it: Adam turns float roundoff in a
# near-zero gradient entry into a whole step of either sign (the CPU tests
# measure up to 2e-4 and 1% against JAX after 8 steps; these fits take 40
# and 60, and the card's image-fit leaves parted by 1.8% and 3.2% of their
# movement in two runs of the same inputs); the one-step gaps of one net 1e-4 relative; the DQN's output
# rtol 1e-4, atol 1e-4 of its largest entry, and each gradient no further
# from a float64 CPU reference than twice the CPU float32's own distance
# plus 1e-4 of its largest entry: relu masks flip where batch-normalized
# values sit at 0, so float32 gradients part from exact by up to 8e-3 of
# their largest entry
IMAGE_N, IMAGE_T, IMAGE_B = 64, 20, 64
IMAGE_EPOCHS, SEQUENCE_EPOCHS = 2, 3
IMAGE_MISMATCH = {"length": 0.8}
SEQUENCE_MISMATCH = {"wind": 0.5}
IMAGE_ENV_N, IMAGE_ENV_STEPS = 16, 5
DQN_B = 64
IMAGE_TOL = 1e-5
FIT_LOSS_RTOL, FIT_LEAF_REL = 1e-2, 1e-1
GAP_RTOL = 1e-4
DQN_TOL = 1e-4
# deployment: the four shipped kinds exported; the native controller's
# decisions against the port's nets on the card within 1e-5; the external
# loops on 4 references of the 200/20 bank (up to 251 steps) against
# run_eval on the card: counts equal, mean divergence within 1e-3
DEPLOY_ASSETS = ("quad_trained", "quad_lstm_trained", "wing_trained",
                 "cartpole_trained")
NATIVE_ACT_ATOL = 1e-5
EXTERNAL_REFS = 4
EXTERNAL_DIV_ATOL = 1e-3
# phase 19: the measuring modules cut in depth (their defaults: latency
# --n 100, ab 50 steps x 5 rounds x 4 calls, layout 20-50 steps x 4-6
# calls, scaling 20 steps per epoch); latency at --n 10 makes room for
# phase 20
PERF_LATENCY_N = 10
PERF_BATCH = 1024
PERF_AB_B = 4096
PERF_AB_ITERS = 10
PERF_LAYOUT_ITERS = 5
PERF_SCALING_ITERS = 5
PERF_BATCH_PER_CARD = 4096
# phase 20: the kernels held against their twins and timed at the bench's
# two large batches; benchmark_rollout at its defaults; entry() card vs CPU
BENCH_KERNEL_BATCHES = (16384, 65536)
ROLLOUT_BENCH_B = 4096
ROLLOUT_BENCH_ITERS = 100
ENTRY_ATOL = 1e-5

# H100 SXM peaks at a 700 W limit (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
KERNELS = ("quad_rollout_fwd", "quad_rollout_bwd")
WING_KERNELS = ("wing_rollout_fwd", "wing_rollout_bwd")
# the nets' reference-branch kernels (csrc/conv_ref.cu): held against a
# float64 twin beside cuDNN's float32 at these batches and horizons, and
# timed at the benchmark's two batches; their launches per step of each
# train path: (forward, weight gradient, its sum, input gradient). A
# recurrent step's first window is data, its nine later ones are built
# from the unrolled state and take an input gradient.
CONV_SOURCE = "apg_trajectory_tracking_tpu_torch/csrc/conv_ref.cu"
CONV_B_LIST = (1, 8, 4097, 65536)
CONV_H_LIST = (10, 20)
CONV_TIMING_B = (4096, 65536)
CONV_TOL = 1e-6
CONV_PER_STEP = {"concurrent": (1, 1, 1, 0), "autoregressive": (10, 10, 10, 9),
                 "LSTM": (10, 10, 10, 9), "wing": (0, 0, 0, 0)}
PALLAS_CALL = "apg_trajectory_tracking_tpu/ops/pallas_rollout.py:114"
SOURCE = "apg_trajectory_tracking_tpu_torch/csrc/quad_rollout.cu"
WING_SOURCE = "apg_trajectory_tracking_tpu_torch/csrc/wing_rollout.cu"
# the wing kernels against their plain versions: every batch and horizon,
# the default params and a mismatched lift slope
WING_B_LIST = (1, 8, 33, 4096, 4097)
WING_K_LIST = (1, 10, 11)
WING_MISMATCH = {"CL_alpha": 3.0}
# |roll| and |pitch| of the wing's stable envelope (wing_is_stable)
WING_ENVELOPE = 0.7
# rows per block of the kernels (kRows in SOURCE): the empty kernel's grid
TILE_ROWS = 8
EMPTY_KERNEL_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
DRAG_PARAMS = {
    "translational_drag": [0.1, -0.2, 0.3],
    "rotational_drag": [0.05, 0.02, -0.01],
    "gravity": [0.4, -0.3, -9.81],
}


def log(msg):
    print(msg, flush=True)


def max_errs(got, ref):
    diff = (got - ref).abs()
    rel = diff / ref.abs().clamp_min(1e-30)
    return diff.max().item(), rel.max().item()


def rollout_inputs(B, seed, device, k=HORIZON):
    rng = np.random.RandomState(seed)
    states = torch.tensor(rng.randn(B, 12).astype(np.float32) * 0.3,
                          device=device)
    actions = torch.tensor(rng.rand(B, k, 4).astype(np.float32),
                           device=device)
    grad_out = torch.tensor(rng.randn(B, k, 12).astype(np.float32),
                            device=device)
    return states, actions, grad_out


def one_row_in(x):
    """A copy of ``x`` as the view ``big[1:]`` of a tensor one row longer:
    contiguous, with a nonzero (16-byte aligned) storage offset."""
    big = torch.zeros((x.shape[0] + 1, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    big[1:] = x
    return big[1:]


def time_cuda(fn, runs=TIMING_RUNS, warmup=5):
    """Median device time of ``fn`` in ms, CUDA events around each run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_kernels(fn, runs=TIMING_RUNS, warmup=5):
    """torch.profiler trace of ``runs`` calls of ``fn`` -> (device time in
    us of each CUDA kernel run, as a list of (name, us); wall time in us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    return kernels, wall_us


def kernel_device_ms(fn, kernel):
    """Median device time in ms of the CUDA kernel whose name contains
    ``kernel``, one launch per call of ``fn``."""
    return group_device_ms([("one", kernel, fn)])["one"]


def group_device_ms(groups, warmup=5):
    """Median device time in ms of each (label, kernel, fn) of ``groups``,
    from one torch.profiler session that calls each ``fn`` TIMING_RUNS
    times, group after group, each call launching one kernel whose name
    contains ``kernel``. One stream runs the launches in order, so the k-th
    group's runs are the k-th TIMING_RUNS kernel events. The profiler now
    and then drops events. With one group, the runs it saw are enough if
    they are at least half; with more, a session whose events do not line
    up is traced again, up to five times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _, _, fn in groups:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    expected = [kernel for _, kernel, _ in groups for _ in range(TIMING_RUNS)]
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _, _, fn in groups:
                for _ in range(TIMING_RUNS):
                    fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if len(groups) == 1:
            (label, kernel, _), = groups
            us = [e.time_range.elapsed_us() for e in events
                  if kernel in e.name]
            if len(us) >= TIMING_RUNS // 2:
                return {label: float(np.median(us)) / 1e3}
        elif len(events) == len(expected) and all(
                kernel in e.name for kernel, e in zip(expected, events)):
            us = [e.time_range.elapsed_us() for e in events]
            return {label: float(np.median(
                        us[i * TIMING_RUNS:(i + 1) * TIMING_RUNS])) / 1e3
                    for i, (label, _, _) in enumerate(groups)}
        log(f"    (profiler saw {len(events)} kernel runs, expected "
            f"{len(expected)} in order; tracing again)")
    raise AssertionError(
        f"profiler saw {len(events)} kernel runs, expected {len(expected)} "
        f"in order"
    )


def time_host(fn, runs=TIMING_RUNS, warmup=5):
    """Median host time of ``fn`` in ms, synchronised before and after."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound_ms(n_bytes, n_ops):
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kernel_bounds(n, k, wing=False):
    """{kernel: (bound ms, "bytes" or "operations")} at n rows and k steps,
    from the kernels' bytes and operations (``ops/rollout.py``, with
    ``wing`` ``ops/wing_rollout.py``)."""
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R
    from apg_trajectory_tracking_tpu_torch.ops import wing_rollout as W

    names, counts = ((WING_KERNELS, (W.wing_rollout_bytes, W.wing_rollout_ops))
                     if wing else (KERNELS, (R.rollout_bytes, R.rollout_ops)))
    return {name: bound_ms(n_bytes, n_ops) for name, n_bytes, n_ops in zip(
        names, counts[0](n, k), counts[1](n, k))}


def wing_inputs(B, seed, device, k=HORIZON):
    """Wing rollout inputs: states near level flight at 11.5 m/s with every
    third row's angle of attack beyond the clamp, roll and pitch inside
    the envelope the wing flies in (``wing_is_stable``'s 0.7 rad), uniform
    actions and a Gaussian output gradient. A pitch that reaches 90 degrees
    within the k steps makes tan and sec of theta unbounded, and there any
    two float32 computations of the same step part by more than the
    forward tolerance: a row that started at 66 degrees of pitch put the
    float32 twin itself 2.6e-4 from the float64 twin."""
    rng = np.random.RandomState(seed)
    states = rng.randn(B, 12).astype(np.float32) * 0.3
    states[:, 3] += 11.5
    states[::3, 5] += 4.0
    states[:, 6:8] = np.clip(states[:, 6:8], -WING_ENVELOPE, WING_ENVELOPE)
    actions = rng.rand(B, k, 4).astype(np.float32)
    grad_out = rng.randn(B, k, 12).astype(np.float32)
    return tuple(torch.tensor(x, device=device)
                 for x in (states, actions, grad_out))


def rollout_kit(params, wing=False):
    """(kernel names, forward kernel, backward kernel, plain forward twin,
    plain backward) of the quad's rollout or, with ``wing``, the wing's,
    each on (states, actions[, states_out, grad_out])."""
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R
    from apg_trajectory_tracking_tpu_torch.ops import wing_rollout as W

    if wing:
        packed = W.pack_wing_params(params)
        return (WING_KERNELS,
                lambda s, a: W.wing_rollout_fwd(s, a, packed, WING_DT),
                lambda s, a, o, g: W.wing_rollout_bwd(s, a, packed, o, g,
                                                      WING_DT),
                lambda s, a: W.wing_rollout_reference(params, s, a, WING_DT),
                lambda s, a, o, g: W.wing_rollout_backward_reference(
                    params, s, a, o, g, WING_DT))
    scalars = params.kernel_scalars
    return (KERNELS,
            lambda s, a: R.quad_rollout_fwd(s, a, scalars, DT),
            lambda s, a, o, g: R.quad_rollout_bwd(s, a, o, g, scalars, DT),
            lambda s, a: R.quad_rollout_reference(params, s, a, DT),
            lambda s, a, o, g: R.quad_rollout_backward_reference(
                params, s, a, o, g, DT))


def kernel_rows(phase, params, n, seed, device, plain=False):
    """Each kernel's device time at n rows, k = 10, beside its bound and,
    with ``plain``, its plain version's time (CUDA events) -> {kernel:
    row}."""
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    scalars = params.kernel_scalars
    s, a, g = rollout_inputs(n, seed, device)
    out = R.quad_rollout_fwd(s, a, scalars, DT)
    cases = {
        "quad_rollout_fwd": (
            lambda: R.quad_rollout_fwd(s, a, scalars, DT),
            lambda: R.quad_rollout_reference(params, s, a, DT)),
        "quad_rollout_bwd": (
            lambda: R.quad_rollout_bwd(s, a, out, g, scalars, DT),
            lambda: R.quad_rollout_backward_reference(params, s, a, out, g,
                                                      DT)),
    }
    rows = {}
    for name, (bnd, by) in kernel_bounds(n, HORIZON).items():
        kernel, plain_fn = cases[name]
        row = rows[name] = {"ms": kernel_device_ms(kernel, name + "_kernel"),
                            "bound_ms": bnd, "bound_by": by}
        if plain:
            row["plain_ms"] = time_cuda(plain_fn)
        log(f"[{phase}] {name} B={n} k={HORIZON}: kernel device time "
            f"{row['ms']:.5f} ms, bound {bnd:.6f} ms ({by})"
            + (f", plain {row['plain_ms']:.5f} ms" if plain else ""))
    return rows


def phase_device():
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    # the line exactly as nvidia-smi prints it: name, power limit
    log(smi)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on for matmul or cuDNN")
    log("[1] TF32 off for matmul and cuDNN")
    return device, smi


def phase_build(baseline=None):
    """Build the port's kernels, the empty kernel and, if given, the
    ``baseline`` source through the port's loader: one nvcc each, all
    started together -> {name: library path}."""
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    empty_src = cuda_lib.BUILD_DIR / "empty_kernel.cu"
    empty_src.write_text(EMPTY_KERNEL_SOURCE)
    sources = {"quad_rollout": None, "wing_rollout": None, "conv_ref": None,
               "empty_kernel": empty_src}
    if baseline:
        sources["quad_rollout_baseline"] = baseline
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {name: pool.submit(cuda_lib.build, name, src)
                   for name, src in sources.items()}
        built = {name: f.result() for name, f in futures.items()}
    log(f"[2] built {len(built)} libraries in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (path, build_log) in built.items():
        log(f"[2] {os.path.relpath(path, ROOT)}")
        for line in build_log.strip().splitlines():
            log(f"[2]   {line}")
    return {name: path for name, (path, _) in built.items()}


def check_kernels(params, states, actions, grad_out, worst, tag, view=False,
                  wing=False):
    """Run both kernel wrappers (the quad's, with ``wing`` the wing's) and
    hold them against the plain forward twin, the hand-derived plain
    backward and torch autograd of the twin. With ``view`` the kernels get
    each tensor as ``big[1:]`` of a tensor one row longer, and the plain
    versions the fresh tensors."""
    (fwd_name, bwd_name), fwd, bwd, twin, plain_bwd = rollout_kit(params,
                                                                  wing)
    place = one_row_in if view else (lambda x: x)
    out = fwd(place(states), place(actions))
    ga, gs = bwd(place(states), place(actions), place(out), place(grad_out))
    ref = twin(states, actions)
    ga_ref, gs_ref = plain_bwd(states, actions, out, grad_out)
    s_ag = states.clone().requires_grad_()
    a_ag = actions.clone().requires_grad_()
    ga_ag, gs_ag = torch.autograd.grad(twin(s_ag, a_ag), (a_ag, s_ag),
                                       grad_out)
    torch.cuda.synchronize()
    f_abs, f_rel = max_errs(out, ref)
    worst[fwd_name] = max(worst[fwd_name], f_abs)
    checks = [(out, ref, ATOL)]
    parts = []
    for name, got, plain, auto in (("grad_actions", ga, ga_ref, ga_ag),
                                   ("grad_states0", gs, gs_ref, gs_ag)):
        atol = BWD_ATOL_REL * plain.abs().max().item()
        e_plain, e_auto = max_errs(got, plain)[0], max_errs(got, auto)[0]
        worst[bwd_name] = max(worst[bwd_name], e_plain)
        parts.append(f"{name} abs {e_plain:.2e} (vs autograd {e_auto:.2e}, "
                     f"atol {atol:.1e})")
        checks += [(got, plain, atol), (got, auto, atol)]
    log(f"[3-4] {tag}: fwd abs {f_abs:.2e} rel {f_rel:.2e}; bwd "
        + "; ".join(parts))
    for got, want, atol in checks:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=atol)


def phase_kernels(device):
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params

    worst = dict.fromkeys(KERNELS + WING_KERNELS, 0.0)
    for label, mods in (("default", {}), ("drag+gravity", DRAG_PARAMS)):
        params = quad_params(mods, device)
        for B in B_LIST:
            for k in K_LIST:
                inputs = rollout_inputs(B, 100 * B + k, device, k)
                check_kernels(params, *inputs, worst, f"{label} B={B} k={k}")
        for B in DP_KERNEL_BATCHES:
            inputs = rollout_inputs(B, 100 * B + HORIZON, device, HORIZON)
            check_kernels(params, *inputs, worst,
                          f"{label} B={B} k={HORIZON} (multihost legs)")
        inputs = rollout_inputs(4097, 3, device, 11)
        check_kernels(params, *inputs, worst,
                      f"{label} B=4097 k=11 offset views", view=True)
    for label, mods in (("default", {}), ("CL_alpha 3.0", WING_MISMATCH)):
        params = wing_params(mods, device)
        for B in WING_B_LIST:
            for k in WING_K_LIST:
                inputs = wing_inputs(B, 100 * B + k, device, k)
                check_kernels(params, *inputs, worst,
                              f"wing {label} B={B} k={k}", wing=True)
        inputs = wing_inputs(4097, 3, device, 11)
        check_kernels(params, *inputs, worst,
                      f"wing {label} B=4097 k=11 offset views", view=True,
                      wing=True)
    return worst


def phase_conv_kernels(device):
    """The reference-branch kernels against a float64 twin (on the float32
    forward's ReLU mask), beside cuDNN's float32 error on the same inputs
    (each leaf's norm of the difference over its norm), the forward
    against cuDNN's bit for bit, then timed at the benchmark's batches
    beside their byte bounds and cuDNN's time for the same function ->
    {kernel: row}."""
    import torch.nn.functional as F

    from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
    from apg_trajectory_tracking_tpu_torch.ops import conv_ref as CR

    conv = ControlNet(15, HORIZON, 9, 4 * HORIZON,
                      generator=torch.Generator().manual_seed(0)).conv_ref
    w = conv.weight.detach().to(device)
    b = conv.bias.detach().to(device)

    def grads(fn, ref, g, *leaves):
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        y = fn(*leaves)
        return (y.detach(), *torch.autograd.grad(y, leaves, g))

    names = ("forward", "input", "weight", "bias")
    for H in CONV_H_LIST:
        for B in CONV_B_LIST:
            rng = np.random.RandomState(B + H)
            ref = torch.tensor(rng.randn(B, H, 9), dtype=torch.float32,
                               device=device)
            g = torch.tensor(rng.randn(B, 20, H - 2), dtype=torch.float32,
                             device=device)
            # the float64 twin on the float32 forward's ReLU mask: a
            # pre-activation within float32 rounding of zero (about one in
            # 10^7 here) would flip a whole term of each gradient
            mask = (CR.conv_ref_relu_reference(ref, w, b) > 0).double()
            exact = grads(lambda r, w_, b_: F.conv1d(r.transpose(1, 2), w_, b_)
                          * mask, ref, g.double(), ref.double(), w.double(),
                          b.double())
            kernel = grads(CR.conv_ref_relu, ref, g, ref, w, b)
            cudnn = grads(CR.conv_ref_relu_reference, ref, g, ref, w, b)
            errs = {n: (float((k.double() - e).norm() / e.norm()),
                        float((c.double() - e).norm() / e.norm()))
                    for n, k, c, e in zip(names, kernel, cudnn, exact)}
            same = torch.equal(kernel[0], cudnn[0])
            log(f"[3-4] conv_ref H={H} B={B}: forward bit-equal to cuDNN's "
                f"{same}; (kernels, cuDNN float32) relative error against "
                "float64: " + ", ".join(
                    f"{n} {k:.3e} / {c:.3e}" for n, (k, c) in errs.items()))
            bad = [n for n, (k, _) in errs.items() if not k < CONV_TOL]
            if not same:
                bad.append("forward not bit-equal to cuDNN's")
            if bad:
                raise AssertionError(f"conv_ref H={H} B={B}: {bad} at or "
                                     f"above {CONV_TOL}")
    rows = {name: {} for name in CR.KERNELS}
    for B in CONV_TIMING_B:
        rng = np.random.RandomState(B)
        ref = torch.tensor(rng.randn(B, HORIZON, 9), dtype=torch.float32,
                           device=device)
        g = torch.tensor(rng.randn(B, 20, HORIZON - 2), dtype=torch.float32,
                         device=device)
        y = CR.conv_ref_fwd(ref, w, b)

        def library_fwd():
            return torch.relu(F.conv1d(ref.transpose(1, 2), w, b))

        def library_wgrad():
            dz = torch.where(y > 0, g, 0.0)
            return (torch.nn.grad.conv1d_weight(ref.transpose(1, 2),
                                                w.shape, dz),
                    dz.sum((0, 2)))

        def library_dgrad():
            dz = torch.where(y > 0, g, 0.0)
            return torch.nn.grad.conv1d_input(ref.transpose(1, 2).shape, w,
                                              dz)

        cases = zip(
            (CR.FWD, CR.WGRAD, CR.DGRAD),
            (lambda: CR.conv_ref_fwd(ref, w, b),
             lambda: CR.conv_ref_wgrad(ref, y, g),
             lambda: CR.conv_ref_dgrad(y, g, w, HORIZON)),
            (library_fwd, library_wgrad, library_dgrad),
            map(bound_ms, CR.conv_ref_bytes(B), CR.conv_ref_ops(B)))
        for name, kernel, library, (bnd, by) in cases:
            row = {"ms": kernel_device_ms(kernel, name + "_kernel"),
                   "call_ms": time_cuda(kernel), "bound_ms": bnd,
                   "bound_by": by, "library_ms": time_cuda(library)}
            if name == CR.WGRAD:
                row["sum_ms"] = kernel_device_ms(
                    kernel, CR.WGRAD_SUM + "_kernel")
            rows[name][B] = row
            log(f"[3-4] {name} B={B}: kernel device time {row['ms']:.5f} ms"
                + (f" (+ its float64 sum {row['sum_ms']:.5f} ms)"
                   if "sum_ms" in row else "")
                + f", per call with launches {row['call_ms']:.5f} ms, "
                f"bound {bnd:.6f} ms ({by}); cuDNN and PyTorch for the same "
                f"function {row['library_ms']:.5f} ms")
    return rows


def read_conv_launches():
    from apg_trajectory_tracking_tpu_torch.perf.common import conv_launches

    torch.cuda.synchronize()
    return conv_launches()


def flips_and_gap(tag, success, values, valid):
    """Log and check the card-vs-CPU agreement of one shipped controller:
    ``success`` per episode, ``values`` per step (states or divergences)
    and ``valid`` masks, each a {"card": ..., "cpu": ...} of numpy
    arrays."""
    both = valid["card"] & valid["cpu"]
    gap = np.abs(values["card"] - values["cpu"])[both].max()
    check_flips(f"[5] {tag}", success,
                f"; max |state card - state cpu| over shared valid steps "
                f"{gap:.3e}")


def check_flips(tag, success, more=""):
    """Log the episodes whose ``success`` flag ({"card": ..., "cpu": ...})
    differs between card and CPU; fail above ``MAX_FLIPS``."""
    flips = [int(i) for i in np.nonzero(success["card"] != success["cpu"])[0]]
    log(f"{tag}: episodes whose success flag flips card vs CPU: {flips}"
        + more)
    if len(flips) > MAX_FLIPS:
        raise AssertionError(f"{tag}: {len(flips)} episodes flipped "
                             f"(> {MAX_FLIPS})")


def check_finite(tag, metrics, keys):
    if not all(math.isfinite(metrics[k]) for k in keys):
        raise AssertionError(f"{tag}: non-finite eval metrics {metrics}")


def phase_carried_weights(device):
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import run_eval
    from apg_trajectory_tracking_tpu_torch.models.rnn import (
        LSTMNet,
        init_lstm_state,
        lstm_net_apply,
    )
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
        load_trajectory_bank,
        prepare_trajectory,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        load_config,
        net_from_jax,
    )

    t0 = time.perf_counter()
    data_dir = ensure_trajectory_bank(os.path.join(ROOT, "data", "traj_data"))
    bank = load_trajectory_bank(data_dir, test=True)
    log(f"[5] test bank {bank.shape} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    idx = np.random.RandomState(42).choice(len(bank), size=10, replace=False)

    for asset in ("quad_trained_9k", "quad_ar_trained", "quad_lstm_trained"):
        asset_dir = os.path.join(ROOT, "assets", asset)
        cfg = load_config(asset_dir)
        weights = load_checkpoint(asset_dir, "model_quad")
        refs = np.stack([prepare_trajectory(bank[i], DT, cfg["speed_factor"])
                         for i in idx])
        refs[:, :, 2] += 3.0
        ref_len = refs.shape[1] - HORIZON
        success, states, valid = {}, {}, {}
        for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
            net = net_from_jax(weights, dev)
            recurrent = {"window_len": cfg.get("ref_length", HORIZON)}
            if isinstance(net, LSTMNet):
                recurrent.update(net_apply=lstm_net_apply,
                                 net_carry=init_lstm_state(10, net.hidden))
            metrics, roll = run_eval(
                net, quad_params(), refs, ref_len, thresh_div=1.0,
                thresh_stable=1.0, horizon=HORIZON, dt=DT, test_time=True,
                **recurrent,
            )
            divs = roll["divergences"].cpu().numpy()
            valid[side] = roll["valid"].cpu().numpy()
            success[side] = ((divs < 1.0) & valid[side]).sum(
                axis=1) == min(251, ref_len + 1)
            states[side] = roll["states"].cpu().numpy()
            log(f"[5] {asset} on the {side}: " + json.dumps(
                {k: metrics[k] for k in ("mean_divergence", "ratio_stable",
                                         "mean_success", "n")}))
            check_finite(asset, metrics, ("mean_divergence", "mean_success",
                                          "ratio_stable"))
        flips_and_gap(asset, success, states, valid)

    phase_carried_wing(device)


def phase_carried_wing(device):
    """``assets/wing_trained`` flown to 10 waypoints from
    ``RandomState(42)`` on the card and on the CPU, with the thresholds of
    ``scripts/evaluate_wing.py`` (the checkpoint's thresh_div, thresh_stable
    3), at test time for 1000 steps."""
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        WING_MEAN,
        WING_STD,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.wing_eval import (
        fly_to_point,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        load_config,
        net_from_jax,
    )

    asset_dir = os.path.join(ROOT, "assets", "wing_trained")
    cfg = load_config(asset_dir)
    weights = load_checkpoint(asset_dir, "model_wing")
    targets = waypoints(10)
    success, states, valid = {}, {}, {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        roll = fly_to_point(
            net_from_jax(weights, dev), wing_params(device=dev),
            torch.tensor(targets, device=dev),
            torch.tensor(WING_MEAN, device=dev),
            torch.tensor(WING_STD, device=dev),
            thresh_div=cfg["thresh_div"], thresh_stable=3.0,
            horizon=cfg["horizon"], max_steps=1000, dt=cfg["delta_t"],
            test_time=True,
        )
        per_ep = (roll["div_target_sum"].cpu().numpy()
                  / roll["div_target_cnt"].cpu().numpy())
        success[side] = roll["passed"].cpu().numpy()
        states[side] = roll["states"].cpu().numpy()
        valid[side] = roll["valid"].cpu().numpy()
        metrics = {"mean_target_error": float(per_ep.mean()),
                   "passed": int(success[side].sum()),
                   "mean_steps_alive": float(valid[side].sum(1).mean())}
        log(f"[5] wing_trained on the {side}: " + json.dumps(metrics))
        check_finite("wing_trained", metrics, list(metrics))
    flips_and_gap("wing_trained", success, states, valid)


def reset_launches():
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

    cuda_lib.LAUNCHES.clear()


def read_launches():
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    return {name: cuda_lib.LAUNCHES[name] for name in KERNELS + WING_KERNELS}


def launch_counts(**counts):
    """{kernel: launches} as ``read_launches`` reads them: ``counts`` by
    kernel, every other kernel 0."""
    return {**dict.fromkeys(KERNELS + WING_KERNELS, 0), **counts}


def check_checkpoint(tag, trainer, name, device):
    """The run's checkpoint files exist, and ``name`` reloads into the net
    and momentum of ``trainer``, bit for bit."""
    from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        momentum_to_jax,
        restore_train_state,
    )

    for f in (f"{name}.npz", f"{name}_opt.npz", "config.json"):
        if not os.path.isfile(os.path.join(trainer.save_path, f)):
            raise AssertionError(f"{tag}: {f} was not written")
    net, opt, _ = restore_train_state(trainer.save_path, name, device)
    if type(net) is not type(trainer.net):
        raise AssertionError(f"{tag}: reloaded a {type(net).__name__}")
    for saved, live in ((net_to_jax(net), net_to_jax(trainer.net)),
                        (momentum_to_jax(net, opt),
                         momentum_to_jax(trainer.net, trainer.optimizer))):
        if sorted(saved) != sorted(live):
            raise AssertionError(f"{tag}: reloaded keys differ")
        for key in live:
            if not np.array_equal(saved[key], live[key]):
                raise AssertionError(f"{tag}: reloaded {key} differs")


def phase_training(device):
    """Drive each training path with the launch counts set to 0 just
    before it and read just after -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.training.common import load_config
    from apg_trajectory_tracking_tpu_torch.training.train_quad import TrainQuad
    from apg_trajectory_tracking_tpu_torch.training.train_wing import (
        TrainWing,
    )

    by_path = {}
    for path, epochs in (("concurrent", 1), ("autoregressive", 1),
                         ("LSTM", 1), ("wing", 1)):
        save_name = f"chip_smoke_{path}"
        system = "wing" if path == "wing" else "quad"
        shutil.rmtree(os.path.join("trained_models", system, save_name),
                      ignore_errors=True)
        reset_launches()
        t0 = time.perf_counter()
        if path == "wing":
            trainer = TrainWing(load_config("wing", PHASE6_WING_CFG),
                                save_name=save_name, device=device)
        else:
            trainer = TrainQuad(
                load_config("quad"), train_mode=path, save_name=save_name,
                data_dir=os.path.join(ROOT, "data", "traj_data"),
                device=device,
            )
        trainer.fit(epochs, verbose=False)
        launches = read_launches()
        conv = read_conv_launches()
        by_path[path] = {**launches, "conv_ref": conv}
        # the wing's step unrolls in the wing kernels, the quad's in the
        # quad kernels (k = 1 launches a step in the recurrent modes)
        names = WING_KERNELS if path == "wing" else KERNELS
        per_step = {"concurrent": 1, "wing": 1}.get(path, trainer.horizon)
        want = launch_counts(**dict.fromkeys(
            names, per_step * trainer.steps_taken))
        log(f"[6] {path}: {epochs} epoch(s) in "
            f"{time.perf_counter() - t0:.1f} s; train steps "
            f"{trainer.steps_taken}; launches {launches}; epoch times "
            f"{trainer.logger.results['epoch_time_s']} s")
        loss = trainer.logger.results["loss"][-1]
        if not math.isfinite(loss):
            raise AssertionError(f"{path}: loss {loss} is not finite")
        if launches != want or not trainer.steps_taken:
            raise AssertionError(
                f"{path}: launched {launches} in {trainer.steps_taken} "
                f"steps, expected {want} ({per_step} of each of {names} per "
                f"step)"
            )
        # the conv kernels: the train steps' exactly, and one more forward
        # per net call of the epoch's evaluation, which takes no gradient
        conv_want = [n * trainer.steps_taken for n in CONV_PER_STEP[path]]
        log(f"[6] {path}: conv_ref launches (forward, weight gradient, its "
            f"sum, input gradient) {conv}; the train steps' {conv_want}")
        if list(conv[1:]) != conv_want[1:] or conv[0] < conv_want[0] or (
                path == "wing" and conv[0]):
            raise AssertionError(f"{path}: conv_ref launched {conv}, the "
                                 f"train steps {conv_want}")
        name = "model_wing_final" if path == "wing" else "model_quad_final"
        check_checkpoint(path, trainer, name, device)
        log(f"[6] {path}: final loss {loss:.3f}; checkpoint reloads "
            f"bit-equal")
    return by_path


def train_step_cases(device, batch):
    """{path: one train step at ``batch`` on fresh random inputs}, each path
    with its own net and optimizer, and the concurrent step's plain-twin
    version."""
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        WING_MEAN,
        WING_STD,
        quad_prepare_data,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.losses import quad_mpc_loss
    from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
    from apg_trajectory_tracking_tpu_torch.models.rnn import LSTMNet
    from apg_trajectory_tracking_tpu_torch.models.simple import CartpoleNet
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R
    from apg_trajectory_tracking_tpu_torch.training.common import sgd_momentum
    from apg_trajectory_tracking_tpu_torch.training.train_cartpole import (
        build_cartpole_step,
    )
    from apg_trajectory_tracking_tpu_torch.training.train_quad import (
        build_concurrent_step,
        build_recurrent_step,
    )
    from apg_trajectory_tracking_tpu_torch.training.train_wing import (
        build_wing_step,
    )

    params = quad_params(device=device)
    rng = np.random.RandomState(0)

    def tensor(*shape, scale=0.3):
        return torch.tensor(rng.randn(*shape).astype(np.float32) * scale,
                            device=device)

    def seeded():
        return torch.Generator().manual_seed(0)

    states = tensor(batch, 12)
    refs = tensor(batch, HORIZON, 9)
    refs2h = tensor(batch, 2 * HORIZON, 9)
    cases = {}

    net = ControlNet(15, HORIZON, 9, 4 * HORIZON, generator=seeded()).to(device)
    opt = sgd_momentum(net.parameters(), 1e-5)
    step = build_concurrent_step(net, opt, DT, HORIZON)
    cases["concurrent"] = lambda: step(params, states, refs)

    def plain_step():
        # the same step with the unroll on the plain twin under autograd
        opt.zero_grad(set_to_none=True)
        in_s, cur, in_r, rel = quad_prepare_data(states, refs)
        acts = torch.sigmoid(net(in_s, in_r)).reshape(-1, HORIZON, 4)
        inter = R.quad_rollout_reference(params, cur, acts, DT)
        quad_mpc_loss(inter, rel, acts).backward()
        opt.step()

    for path, make in (
            ("autoregressive",
             lambda: ControlNet(15, HORIZON, 9, 4, generator=seeded())),
            ("LSTM", lambda: LSTMNet(15, HORIZON, 9, 4, generator=seeded()))):
        r_net = make().to(device)
        r_step = build_recurrent_step(
            r_net, sgd_momentum(r_net.parameters(), 1e-5), DT, HORIZON,
            lstm=path == "LSTM")
        cases[path] = functools.partial(r_step, params, states, refs2h)

    w_states = torch.zeros((batch, 12), device=device)
    w_states[:, 3] = 11.5
    w_states[:, 3:] += tensor(batch, 9, scale=0.1)
    w_targets = torch.tensor(
        np.concatenate([np.full((batch, 1), 50.0),
                        (rng.rand(batch, 2) - 0.5) * 10], axis=1),
        dtype=torch.float32, device=device)
    w_net = ControlNet(9, 1, 3, 4 * HORIZON, conv=False,
                       generator=seeded()).to(device)
    w_step = build_wing_step(
        w_net, sgd_momentum(w_net.parameters(), 1e-4), 0.05, 0.05, HORIZON,
        torch.tensor(WING_MEAN, device=device),
        torch.tensor(WING_STD, device=device))
    w_params = wing_params(device=device)
    cases["wing"] = lambda: w_step(w_params, w_states, w_targets)

    c_states = tensor(batch, 4, scale=1.0)
    c_net = CartpoleNet(generator=seeded()).to(device)
    c_step = build_cartpole_step(
        c_net, sgd_momentum(c_net.parameters(), 1e-5), 0.05, HORIZON)
    c_params = cartpole_params(device=device)
    cases["cartpole"] = lambda: c_step(c_params, c_states)
    return cases, plain_step


def phase_timing(device, empty_lib):
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params

    # loaded and launched once before any profiler session, as the
    # rollout library is
    empty_launch = empty_launcher(empty_lib)
    for n in (TRAIN_B, TIMING_B):
        cases, plain_step = train_step_cases(device, n)
        for path, step in cases.items():
            timed, profiled = STEP_RUNS[path]
            if path == "wing":
                # its first call runs eagerly, on the wing kernels
                reset_launches()
                step()
                launches = read_launches()
                want = launch_counts(**dict.fromkeys(WING_KERNELS, 1))
                if launches != want:
                    raise AssertionError(f"[7] wing step B={n}: launched "
                                         f"{launches}, expected {want}")
            step_ms = time_host(step, runs=timed, warmup=2)
            runs, wall_us = profile_kernels(step, runs=profiled, warmup=2)
            device_us = sum(us for _, us in runs)
            row = {
                "path": path,
                "batch": n,
                "step_ms": step_ms,
                "env_steps_per_s": n * HORIZON / (step_ms / 1e3),
                "kernels_per_step": len(runs) / profiled,
                "device_busy_share": device_us / wall_us,
                "rollout_kernels_share_of_device_time": sum(
                    us for name, us in runs if "_rollout_" in name
                ) / device_us,
            }
            if path == "concurrent" and n == TIMING_B:
                row = {"metric": "quad_apg_train_env_steps_per_s_per_chip",
                       "value": row["env_steps_per_s"],
                       "unit": "env-steps/s", **row,
                       "plain_twin_step_ms": time_host(plain_step)}
            log(f"[7] train step: {json.dumps(row)}")

    timings = {name: {} for name in KERNELS + WING_KERNELS}
    for wing in (False, True):
        params = (wing_params if wing else quad_params)(device=device)
        names, fwd, bwd, twin, plain_bwd = rollout_kit(params, wing)
        for k in (HORIZON, 1):
            for n in (TRAIN_B, TIMING_B):
                s, a, g = (wing_inputs if wing else rollout_inputs)(
                    n, 1, device, k)
                out = fwd(s, a)
                bounds = kernel_bounds(n, k, wing)
                cases = (
                    (names[0], lambda: fwd(s, a), lambda: twin(s, a)),
                    (names[1], lambda: bwd(s, a, out, g),
                     lambda: plain_bwd(s, a, out, g)),
                )
                for name, kernel, plain in cases:
                    bnd, by = bounds[name]
                    row = {"ms": kernel_device_ms(kernel, name + "_kernel"),
                           "call_ms": time_cuda(kernel), "bound_ms": bnd,
                           "bound_by": by}
                    # the plain versions at k = 10: the quad's at its
                    # timing batch, the wing's at its train batch too
                    if k == HORIZON and (n == TIMING_B or wing):
                        row["plain_ms"] = time_cuda(plain)
                    timings[name][(n, k)] = row
                    log(f"[7] {name} B={n} k={k}: kernel device time "
                        f"{row['ms']:.5f} ms, per call with launch "
                        f"{row['call_ms']:.5f} ms, bound {bnd:.6f} ms ({by})"
                        + (f", plain twin {row['plain_ms']:.5f} ms"
                           if "plain_ms" in row else ""))
    floors = {n: kernel_device_ms(functools.partial(empty_launch, n),
                                  "empty_kernel")
              for n in (TRAIN_B, TIMING_B)}
    log("[7] launch floor, an empty kernel launched through ctypes on the "
        "same grid: " + ", ".join(
            f"B={n} ({-(-n // TILE_ROWS)} blocks of {TILE_ROWS}) "
            f"{ms:.5f} ms" for n, ms in floors.items()))
    return timings


def empty_launcher(path):
    """Load the empty kernel's library ``path`` and launch it once ->
    launch(n), which launches it on the rollout's grid for a batch of
    ``n``."""
    lib = ctypes.CDLL(str(path))
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.empty_launch.restype = ctypes.c_int

    def launch(n):
        err = lib.empty_launch(-(-n // TILE_ROWS), TILE_ROWS,
                               torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")

    launch(1)
    torch.cuda.synchronize()
    return launch


def phase_cartpole_controllers(device):
    """The shipped cartpole controllers through both protocols, on the card
    and on the CPU."""
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        reset_swingup,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.cartpole_eval import (
        balance_metrics,
        evaluate_balance,
        evaluate_swingup,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        net_from_jax,
    )

    starts = reset_swingup(torch.Generator().manual_seed(0), 10)
    for asset in CARTPOLE_ASSETS:
        weights = load_checkpoint(os.path.join(ROOT, "assets", asset),
                                  "model_cartpole")
        held, upright = {}, {}
        for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
            net, params = net_from_jax(weights, dev), cartpole_params(
                device=dev)
            raw = evaluate_balance(net, params)
            held[side] = raw["steps_per_episode"].cpu().numpy() >= 249
            bal = balance_metrics(raw)
            raw = evaluate_swingup(net, params, starts)
            upright[side] = raw["success_per_episode"].cpu().numpy()
            su = {k: float(raw[k]) for k in ("success_rate", "mean_vel")}
            su["mean_final_angle"] = float(
                raw["final_angle_per_episode"].mean())
            log(f"[9] {asset} on the {side}: balance " + json.dumps(
                {k: bal[k] for k in ("mean_vel", "mean_stable",
                                     "ratio_full", "n")})
                + "; swing-up " + json.dumps(su))
            check_finite(asset, {"stable": bal["mean_stable"], **su},
                         ("stable", "mean_vel", "success_rate"))
        check_flips(f"[9] {asset} balance", held)
        check_flips(f"[9] {asset} swing-up", upright)


def phase_cartpole_training(device):
    """``TrainCartpole`` for 2 epochs with the launch counts set to 0 just
    before and read just after -> its launches."""
    from apg_trajectory_tracking_tpu_torch.training.common import load_config
    from apg_trajectory_tracking_tpu_torch.training.train_cartpole import (
        TrainCartpole,
    )

    save_name = "chip_smoke_cartpole"
    shutil.rmtree(os.path.join("trained_models", "cartpole", save_name),
                  ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    trainer = TrainCartpole(load_config("cartpole"), swingup=True,
                            save_name=save_name, device=device)
    trainer.fit(2, verbose=False)
    launches = read_launches()
    res = trainer.logger.results
    log(f"[10] cartpole: 2 epochs in {time.perf_counter() - t0:.1f} s; "
        f"train steps {trainer.steps_taken}; launches {launches}; epoch "
        f"times {res['epoch_time_s']} s; swing-up mean_vel "
        f"{res['mean_vel']}, success_rate {res['success_rate']}")
    loss = res["loss"][-1]
    if not math.isfinite(loss):
        raise AssertionError(f"cartpole: loss {loss} is not finite")
    if any(launches.values()):
        raise AssertionError(f"cartpole: rollout kernels launched "
                             f"{launches}, expected none")
    check_checkpoint("cartpole", trainer, "model_cartpole_final", device)
    if not os.path.isfile(os.path.join(trainer.save_path,
                                       "model_cartpole.npz")):
        raise AssertionError("cartpole: no best model was saved")
    log(f"[10] cartpole: final loss {loss:.3f}; checkpoint reloads "
        f"bit-equal")
    return launches


def labelling_problem(device):
    """The (state, window) pairs of one labelling solve of
    ``scripts/distill_mpc.py``: ``LABEL_B`` bank states at speed 0.4, each
    window padded to the 12 state dims -> (x0, ref, z0) on ``device``."""
    from apg_trajectory_tracking_tpu_torch.envs.quad_env import (
        full_state_training_data,
    )
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
        load_trajectory_bank,
    )

    bank = load_trajectory_bank(ensure_trajectory_bank(
        os.path.join(ROOT, "data", "traj_data")))
    states, windows = full_state_training_data(
        np.random.RandomState(0), bank, LABEL_B, ref_length=HORIZON, dt=DT,
        speed_factor=0.4)
    win12 = np.concatenate(
        [windows, np.zeros(windows.shape[:2] + (3,), np.float32)], axis=2)
    return (torch.tensor(states, device=device),
            torch.tensor(win12, device=device),
            torch.zeros((LABEL_B, HORIZON, 4), device=device))


def phase_labelling_solve(device):
    """The batched Flightmare solve on the kernels, its launches, its plain
    twin, its time, and the kernels' time at its batch -> (launches,
    {name: kernel row at B = LABEL_B})."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import (
        _SPECS,
        _make_solver,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        quad_params,
        quad_step,
    )
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    x0, ref, z0 = labelling_problem(device)
    params = quad_params(device=device)
    spec = _SPECS["flightmare"].to(device)
    solve = _make_solver(quad_step, spec, HORIZON, DT, MPC_ITERS, 0.1)
    twin = _make_solver(
        quad_step, spec, HORIZON, DT, MPC_ITERS, 0.1,
        unroll=lambda p, x, u: R.quad_rollout_reference(p, x, u, DT))

    reset_launches()
    u_k, _, c_k = solve(params, x0, ref, z0)
    launches = read_launches()
    if launches != launch_counts(quad_rollout_fwd=MPC_ITERS,
                                 quad_rollout_bwd=MPC_ITERS):
        raise AssertionError(f"labelling solve launched {launches}, "
                             f"expected {MPC_ITERS} of each kernel")
    u_p, _, c_p = twin(params, x0, ref, z0)
    torch.cuda.synchronize()
    u_gap = (u_k - u_p).abs().max().item()
    c_gap = (c_k - c_p).abs()
    log(f"[11] labelling solve B={LABEL_B}: launches {launches}; kernels vs "
        f"plain twin: max |u| gap {u_gap:.3e} (atol {SOLVE_ATOL}), max cost "
        f"gap {c_gap.max().item():.3e} absolute, "
        f"{(c_gap / c_p.abs()).max().item():.3e} relative (rtol "
        f"{SOLVE_RTOL}, atol {SOLVE_COST_ATOL}); mean cost "
        f"{c_k.mean().item():.4f}")
    torch.testing.assert_close(c_k, c_p, rtol=SOLVE_RTOL,
                               atol=SOLVE_COST_ATOL)
    torch.testing.assert_close(u_k, u_p, rtol=0, atol=SOLVE_ATOL)
    if not torch.isfinite(u_k).all():
        raise AssertionError("labelling solve: non-finite actions")

    def run():
        solve(params, x0, ref, z0)

    solve_ms = time_host(run, runs=5, warmup=1)
    twin_ms = time_host(lambda: twin(params, x0, ref, z0), runs=1, warmup=0)
    runs, wall_us = profile_kernels(run, runs=2, warmup=0)
    device_us = sum(us for _, us in runs)
    log("[11] labelling solve: " + json.dumps({
        "batch": LABEL_B, "iterations": MPC_ITERS, "solve_ms": solve_ms,
        "plain_twin_solve_ms": twin_ms, "kernels_per_solve": len(runs) / 2,
        "device_busy_share": device_us / wall_us,
        "rollout_kernels_share_of_device_time": sum(
            us for name, us in runs if "quad_rollout" in name) / device_us,
    }))

    rows = kernel_rows(11, params, LABEL_B, 2, device)
    return launches, rows


def mpc_case(dynamics, device):
    """(start state, reference argument, dt, plant step, plant params) of a
    closed loop of ``dynamics``."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import _STEPS

    step, params_fn = _STEPS[dynamics]
    params = params_fn(device=device)
    if dynamics in ("flightmare", "simple_quad", "high_mpc"):
        ref = np.zeros((HORIZON, 9), np.float32)
        ref[:, 2] = 3.0
        ref[:, 6] = 0.3
        if dynamics == "high_mpc":
            state = [0, 0, 2.8, 1, 0, 0, 0, 0.3, -0.2, 0.1]
        else:
            state = [0, 0, 2.8, 0.05, -0.1, 0.2, 0.3, -0.2, 0.1, 0, 0, 0]
        return state, ref, 0.1, step, params
    if dynamics == "cartpole":
        return [0.1, 0.0, 0.15, 0.0], None, 0.05, step, params
    if dynamics == "fixed_wing_3D":
        return ([0, 0, 0, 11.5] + [0] * 8, np.array([50.0, 2.0, 1.0]), 0.05,
                step, params)
    return [0, 0, 11.5, 0, 0, 0], np.array([50.0, 2.0]), 0.05, step, params


def phase_mpc_loops(device):
    """A short closed loop of the Adam MPC on each dynamics model, timed
    per control step."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC, _STEPS

    for dynamics in _STEPS:
        state, ref, dt, step, params = mpc_case(dynamics, device)
        mpc = MPC(horizon=HORIZON, dt=dt, dynamics=dynamics,
                  n_iters=MPC_ITERS, device=device)
        state = torch.tensor([state], dtype=torch.float32, device=device)
        times = []
        for _ in range(CONTROL_STEPS[dynamics]):
            t0 = time.perf_counter()
            u = mpc.predict_actions(state[0].cpu().numpy(), ref)
            times.append((time.perf_counter() - t0) * 1e3)
            state = step(params, state, torch.tensor(u[:1], device=device),
                         dt)
        if not (np.isfinite(u).all() and torch.isfinite(state).all()):
            raise AssertionError(f"{dynamics} MPC: non-finite actions or "
                                 f"states")
        log(f"[11] MPC {dynamics}: {len(times)} control steps of "
            f"{MPC_ITERS} Adam iterations; ms per control step "
            f"{[round(t, 1) for t in times]} ({times[-1] / MPC_ITERS:.2f} "
            f"per iteration in the last); final state "
            f"{np.round(state[0].cpu().numpy(), 3).tolist()}")


def phase_ilqr_hover(device):
    """The iLQR solve of 8 states near hover on the card against the CPU."""
    from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
        make_ilqr_solver,
    )
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import _SPECS
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        quad_params,
        quad_step,
    )

    x0 = torch.from_numpy(
        (np.random.RandomState(0).randn(8, 12) * 0.1).astype(np.float32))
    x0[:, 2] += 0.8
    ref = torch.zeros(8, HORIZON, 12)
    ref[..., 2] = 1.0
    out = {}
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        solve = make_ilqr_solver(quad_step, _SPECS["flightmare"].to(dev),
                                 HORIZON, DT, n_iters=10)
        u, _, cost = solve(quad_params(device=dev), x0.to(dev), ref.to(dev),
                           torch.zeros(8, HORIZON, 4, device=dev))
        out[side] = (u.cpu(), cost.cpu())
    u_gap = float((out["card"][0] - out["cpu"][0]).abs().max())
    c_gap = float(((out["card"][1] - out["cpu"][1]) / out["cpu"][1]).abs()
                  .max())
    log(f"[11] iLQR hover solve, 8 states: card vs CPU max |u| gap "
        f"{u_gap:.3e} (atol {ILQR_HOVER_ATOL}), max cost gap {c_gap:.3e} "
        f"relative (rtol {ILQR_HOVER_COST_RTOL})")
    if u_gap > ILQR_HOVER_ATOL or c_gap > ILQR_HOVER_COST_RTOL:
        raise AssertionError("iLQR hover solve: card and CPU disagree")


def swingup_plan_cost64(starts, u):
    """The swing-up cost of each plan u (n, horizon) from ``starts``, in
    float64 on the CPU: the iLQR controller's cost of its warm start, with
    no iteration."""
    from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
        make_cartpole_swingup_ilqr,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )

    evaluate, _ = make_cartpole_swingup_ilqr(
        cartpole_params().to(torch.float64), horizon=u.shape[1], n_iters=0,
        lqr_iters=0)
    frac = (u.cpu().double() + 1.0) / 2.0
    z = torch.log(frac / (1.0 - frac))[..., None]
    return evaluate(None, starts.cpu().double(), z,
                    return_info=True)[2]["cost_warm"]


def check_swingup_ilqr(starts, actions, infos):
    """Log each episode's choice of start and both costs on card and CPU,
    and hold the card's accepted plans to their float64 cost and the CPU's
    total (see ``SWINGUP_COST_RTOL``)."""
    chosen = {}
    for side, info in infos.items():
        pick = info["pick_hold"].cpu()
        cw, cl = info["cost_warm"].cpu(), info["cost_hold"].cpu()
        chosen[side] = torch.where(pick, cl, cw).double()
        log(f"[11] swing-up iLQR on the {side}: start picked per episode "
            f"{['hold' if p else 'warm' for p in pick.tolist()]}; cost of "
            f"the warm start {np.round(cw.numpy(), 2).tolist()}, of the "
            f"hold start {np.round(cl.numpy(), 2).tolist()}")
    c64 = swingup_plan_cost64(starts, actions["card"])
    self_gap = float(((chosen["card"] - c64) / c64).abs().max())
    total = {side: float(c.sum()) for side, c in chosen.items()}
    total_gap = abs(total["card"] - total["cpu"]) / total["cpu"]
    gaps = (actions["card"].cpu() - actions["cpu"]).abs().amax(dim=1)
    log(f"[11] swing-up iLQR: card's cost of its accepted plans vs their "
        f"float64 cost on the CPU, max gap {self_gap:.3e} relative (rtol "
        f"{SWINGUP_COST_RTOL}); total cost card {total['card']:.2f}, CPU "
        f"{total['cpu']:.2f}, gap {total_gap:.3e} (rtol "
        f"{SWINGUP_TOTAL_RTOL}); max |plan card - plan cpu| per episode "
        f"{[f'{g:.2e}' for g in gaps.tolist()]}")
    if self_gap > SWINGUP_COST_RTOL or total_gap > SWINGUP_TOTAL_RTOL:
        raise AssertionError("swing-up iLQR: the card's plans fail their "
                             "cost checks")


def phase_swingup_solvers(device):
    """The first ``SWINGUP_STEPS`` control steps of the swing-up protocol
    (10 episodes, horizon 60) under the iLQR and the CEM controllers, the
    CPU's closed loop driving both: at every control step the card solves
    from the CPU's states and warm start. The CEM's plans (the same noise
    on both) must agree within ``CEM_PLAN_ATOL``; the iLQR's are held to
    their costs (``check_swingup_ilqr``)."""
    from apg_trajectory_tracking_tpu_torch.controllers.cem import (
        make_cartpole_swingup_cem,
    )
    from apg_trajectory_tracking_tpu_torch.controllers.ilqr import (
        make_cartpole_swingup_ilqr,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        env_step,
        reset_swingup,
    )

    cpu = torch.device("cpu")
    sides = (("cpu", cpu), ("card", device))
    starts = reset_swingup(torch.Generator().manual_seed(0), 10)
    for name, make in (("iLQR", make_cartpole_swingup_ilqr),
                       ("CEM", make_cartpole_swingup_cem)):
        ctl = {side: make(cartpole_params(device=dev)) for side, dev in sides}
        carry = {side: ctl[side][1](starts.to(dev)) for side, dev in sides}
        state, times, gaps = starts, {"cpu": [], "card": []}, []
        for _ in range(SWINGUP_STEPS[name]):
            actions, infos = {}, {}
            for side, dev in sides:
                t0 = time.perf_counter()
                out = ctl[side][0](None, state.to(dev), carry[side],
                                   **({"return_info": True}
                                      if name == "iLQR" else {}))
                actions[side] = out[0].cpu()
                times[side].append((time.perf_counter() - t0) * 1e3)
                carry[side] = out[1]
                if name == "iLQR":
                    infos[side] = out[2]
            if not all(np.isfinite(a.numpy()).all()
                       for a in actions.values()):
                raise AssertionError(f"{name}: non-finite plan")
            gaps.append(float((actions["card"] - actions["cpu"]).abs()
                              .max()))
            if name == "iLQR":
                check_swingup_ilqr(state, actions, infos)
            # the card's next solve starts where the CPU's does
            carry["card"] = (carry["cpu"].to(device) if name == "iLQR"
                             else (carry["cpu"][0].to(device),
                                   carry["card"][1]))
            state = env_step(cartpole_params(), state,
                             actions["cpu"][:, :1], 0.05)
        log(f"[11] swing-up {name}, 10 episodes: ms per control step card "
            f"{[round(t, 1) for t in times['card']]}, CPU "
            f"{[round(t, 1) for t in times['cpu']]}; max |plan card - plan "
            f"cpu| per control step {[f'{g:.2e}' for g in gaps]}; a "
            f"250-step protocol would take about "
            f"{250 * float(np.median(times['card'])) / 1e3:.0f} s on the "
            f"card")
        if name == "CEM" and max(gaps) > CEM_PLAN_ATOL:
            raise AssertionError(f"CEM: card and CPU plans differ by "
                                 f"{max(gaps):.3e} (> {CEM_PLAN_ATOL})")


def count_legs(trainer, names):
    """Wrap each method ``names`` of ``trainer`` so that every call sets
    the launch counts to 0 just before and reads them just after -> {name:
    {"calls", "s", kernel: launches}}, summed over the calls."""
    legs = {}
    for name in names:
        leg = legs[name] = {"calls": 0, "s": 0.0, **launch_counts()}

        def wrapped(*args, _fn=getattr(trainer, name), _leg=leg, **kwargs):
            reset_launches()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            launches = read_launches()
            _leg["s"] += time.perf_counter() - t0
            _leg["calls"] += 1
            for key, n in launches.items():
                _leg[key] += n
            return out

        setattr(trainer, name, wrapped)
    return legs


def path_launches(legs):
    return {key: sum(leg[key] for leg in legs.values())
            for key in ("quad_rollout_fwd", "quad_rollout_bwd")}


def check_finite_model(tag, ld):
    from apg_trajectory_tracking_tpu_torch.dynamics.learnt import (
        learnt_leaves,
    )

    bad = [path for path, t in learnt_leaves(ld)
           if not torch.isfinite(t).all()]
    if bad:
        raise AssertionError(f"{tag}: non-finite model leaves {bad}")


def check_finite_losses(tag, results):
    for key in ("loss_dyn", "loss"):
        if not all(math.isfinite(v) for v in results.get(key, [])):
            raise AssertionError(f"{tag}: non-finite {key} {results[key]}")


def adapt_step_timing(tag, step):
    """ms per call of ``step``, kernels per call and the card's busy share,
    from ``ADAPT_STEP_RUNS``."""
    timed, profiled = ADAPT_STEP_RUNS
    step_ms = time_host(step, runs=timed, warmup=2)
    runs, wall_us = profile_kernels(step, runs=profiled, warmup=1)
    device_us = sum(us for _, us in runs)
    row = {"step": tag, "batch": TRAIN_B, "step_ms": step_ms,
           "kernels_per_step": len(runs) / profiled,
           "device_busy_share": device_us / wall_us,
           "rollout_kernels_share_of_device_time": sum(
               us for name, us in runs if "quad_rollout" in name)
           / device_us}
    log(f"[12] {json.dumps(row)}")


def kernel_step_vs_twin(trainer, device):
    """One controller step against the learnt quad on the kernels and on
    the plain twin, from copies of the same net, on the same batch."""
    from apg_trajectory_tracking_tpu_torch.dynamics.learnt import detached
    from apg_trajectory_tracking_tpu_torch.dynamics.unroll import step_rollout
    from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
    from apg_trajectory_tracking_tpu_torch.training import adapt
    from apg_trajectory_tracking_tpu_torch.training.train_quad import (
        concurrent_loss,
    )

    inner = trainer.inner
    ld = detached(trainer.ld)
    rows = torch.arange(TRAIN_B, device=device)
    states, refs = inner.buffers.states[rows], inner.buffers.refs[rows]
    out = {}
    for side, unroll in (
            ("kernels", adapt.quad_learnt_rollout),
            ("twin", lambda p, x, u, dt: step_rollout(
                adapt.quad_learnt_step, p, x, u, dt))):
        net = copy.deepcopy(inner.net)
        loss = concurrent_loss(net, ld, states, refs, inner.dt,
                               inner.horizon, unroll=unroll)
        loss.backward()
        out[side] = (loss.detach(), net_to_jax(net, lambda p: p.grad))
    torch.cuda.synchronize()
    loss_k, loss_t = out["kernels"][0], out["twin"][0]
    gaps = []
    for key, want in out["twin"][1].items():
        want = torch.from_numpy(want)
        got = torch.from_numpy(out["kernels"][1][key])
        atol = BWD_ATOL_REL * want.abs().max().item()
        gaps.append(max_errs(got, want)[0] / max(atol, 1e-30))
        torch.testing.assert_close(got, want, rtol=RTOL, atol=atol)
    log(f"[12] quad controller step after the sysid, kernels vs twin: "
        f"loss {loss_k.item():.6f} vs {loss_t.item():.6f}; worst gradient "
        f"gap {max(gaps):.3f} of its atol")
    torch.testing.assert_close(loss_k, loss_t, rtol=1e-5, atol=0)


def phase_adapt_quad(device):
    """``TrainQuadAdapt`` on the kernels -> the path's launches."""
    from apg_trajectory_tracking_tpu_torch.dynamics.learnt import detached
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        DEFAULT_QUAD_CFG,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.robustness import (
        increase_param,
    )
    from apg_trajectory_tracking_tpu_torch.training import adapt
    from apg_trajectory_tracking_tpu_torch.training.common import load_config

    save_name = "chip_smoke_adapt_quad"
    shutil.rmtree(os.path.join("trained_models", "quad", save_name),
                  ignore_errors=True)
    param, factor = adapt.QUAD_CELLS[ADAPT_QUAD_CELL]
    plant = {param: increase_param(DEFAULT_QUAD_CFG[param], factor)}
    t0 = time.perf_counter()
    trainer = adapt.TrainQuadAdapt(
        load_config("quad", ADAPT_QUAD_CFG), modified_params=plant,
        base_model=os.path.join(ROOT, "assets", "quad_trained_9k"),
        train_base_params=adapt.QUAD_SYSID["rate"], save_name=save_name,
        data_dir=os.path.join(ROOT, "data", "traj_data"), device=device,
    )
    inner = trainer.inner
    log(f"[12] quad: plant {json.dumps(plant)}; {len(inner.buffers.states)} "
        f"buffer rows; set up in {time.perf_counter() - t0:.1f} s")

    def gaps():
        return trainer.dynamics_gap(generator=torch.Generator().manual_seed(7))

    gap0 = gaps()
    kinv0 = trainer.ld.base.kinv_ang_vel_tau.clone()
    legs = count_legs(trainer, ("evaluate", "evaluate_selection",
                                "run_dynamics_epoch",
                                "run_controller_epoch_learnt"))
    t0 = time.perf_counter()
    trainer.run_dynamics(nr_epochs=3, train_dyn_for_epochs=1, verbose=False)
    log(f"[12] quad run_dynamics, 3 epochs, in "
        f"{time.perf_counter() - t0:.1f} s; legs " + json.dumps(legs))
    ctrl_steps = inner.steps_taken
    for name, leg in legs.items():
        per_step = HORIZON if name == "run_controller_epoch_learnt" else 0
        for key in ("quad_rollout_fwd", "quad_rollout_bwd"):
            if leg[key] != per_step * (ctrl_steps if per_step else 1):
                raise AssertionError(
                    f"quad adaptation: {name} launched {key} {leg[key]} "
                    f"times, expected {per_step} per controller step of "
                    f"{ctrl_steps}")
    if ctrl_steps != len(inner.buffers.states) // inner.batch_size:
        raise AssertionError(f"quad adaptation: {ctrl_steps} controller "
                             f"steps")
    check_finite_losses("quad adaptation", inner.logger.results)
    check_finite_model("quad adaptation", trainer.ld)
    check_checkpoint("quad adaptation", inner, "model_quad_final", device)
    kinv1 = trainer.ld.base.kinv_ang_vel_tau
    if torch.equal(kinv1, kinv0):
        raise AssertionError("quad adaptation: the sysid left kinv as it was")
    gap1 = gaps()
    true_plant = trainer.evaluate_mismatched()
    log(f"[12] quad: losses dyn {inner.logger.results['loss_dyn']} "
        f"controller {inner.logger.results['loss'][1:]}; one-step gap "
        f"adapted {gap0[0]:.5f} -> {gap1[0]:.5f}, analytic {gap1[1]:.5f}; "
        f"identified " + json.dumps({
            k: getattr(trainer.ld.base, k).tolist()
            for k in adapt.QUAD_SYSID["rate"]})
        + "; true plant " + json.dumps(
            {k: true_plant[k] for k in ("mean_divergence", "ratio_stable",
                                        "mean_success", "n")}))
    if not gap1[0] < gap1[1]:
        raise AssertionError(f"quad adaptation: adapted gap {gap1[0]} is not "
                             f"below the analytic {gap1[1]}")
    check_finite("quad true plant", true_plant,
                 ("mean_divergence", "mean_success", "ratio_stable"))
    kernel_step_vs_twin(trainer, device)

    # the steps' times, last: these steps move the net
    ld = detached(trainer.ld)
    rows = torch.arange(TRAIN_B, device=device)
    states, refs = inner.buffers.states[rows], inner.buffers.refs[rows]
    actions = trainer.controller_actions()[rows]
    adapt_step_timing("quad controller step against the learnt model",
                      lambda: trainer._ctrl_step(ld, states, refs))
    adapt_step_timing("quad dynamics fit step",
                      lambda: trainer._fit_step(ld, trainer.dyn_opt_state,
                                                inner.eval_dyn, states,
                                                actions))
    return path_launches(legs)


def phase_adapt_wing_cartpole(device):
    """``TrainWingAdapt`` and ``TrainCartpoleAdapt``, each with the launch
    counts set to 0 just before and read just after -> their launches."""
    from apg_trajectory_tracking_tpu_torch.training import adapt
    from apg_trajectory_tracking_tpu_torch.training.common import load_config

    by_path = {}
    for system in ("wing", "cartpole"):
        save_name = f"chip_smoke_adapt_{system}"
        shutil.rmtree(os.path.join("trained_models", system, save_name),
                      ignore_errors=True)
        reset_launches()
        t0 = time.perf_counter()
        if system == "wing":
            cfg = load_config("wing", ADAPT_WING_CFG)
            trainer = adapt.TrainWingAdapt(
                cfg, modified_params=ADAPT_WING_MISMATCH,
                base_model=os.path.join(ROOT, "assets", "wing_trained"),
                save_name=save_name, device=device)
            inner = trainer.inner
            if inner.thresh_div < 20 or inner.thresh_stable < 1.5:
                raise AssertionError(
                    f"wing adaptation: thresholds {inner.thresh_div}, "
                    f"{inner.thresh_stable} below 20, 1.5")
            epochs, fit_epochs = 2, 0
        else:
            cfg = load_config("cartpole", ADAPT_CARTPOLE_CFG)
            trainer = inner = adapt.TrainCartpoleAdapt(
                cfg, modified_params={"wind": 0.5}, save_name=save_name,
                device=device)
            epochs, fit_epochs = 3, 1

        def gaps():
            return trainer.dynamics_gap(
                generator=torch.Generator().manual_seed(7))

        gap0 = gaps()
        trainer.run_dynamics(nr_epochs=epochs,
                             train_dyn_for_epochs=fit_epochs, verbose=False)
        gap1 = gaps()
        launches = read_launches()
        by_path[f"{system}_adapt"] = launches
        res = inner.logger.results
        log(f"[12] {system}: {epochs} epochs in "
            f"{time.perf_counter() - t0:.1f} s; launches {launches}; "
            f"l2_lambda {cfg.get('l2_lambda')}; losses dyn "
            f"{res['loss_dyn']} controller {res['loss'][1:]}; one-step gap "
            f"adapted {gap0[0]:.5f} -> {gap1[0]:.5f}, analytic "
            f"{gap1[1]:.5f}")
        if any(launches.values()):
            raise AssertionError(f"{system} adaptation: rollout kernels "
                                 f"launched {launches}, expected none")
        check_finite_losses(f"{system} adaptation", res)
        check_finite_model(f"{system} adaptation", trainer.ld)
        if not all(math.isfinite(g) for g in gap0 + gap1):
            raise AssertionError(f"{system} adaptation: gaps {gap0} {gap1}")
        if system == "wing":
            true_plant = trainer.evaluate_mismatched()
            log("[12] wing true plant " + json.dumps(
                {k: true_plant[k] for k in ("mean_success",
                                            "mean_steps_alive", "n")}))
            check_finite("wing true plant", true_plant, ("mean_success",))
        else:
            check_learnt_step_card_vs_cpu(trainer, device)
    return by_path


def check_learnt_step_card_vs_cpu(trainer, device):
    from apg_trajectory_tracking_tpu_torch.training import adapt

    g = torch.Generator().manual_seed(3)
    states = torch.randn((256, 4), generator=g) * torch.tensor(
        [1.0, 1.0, 0.5, 1.0])
    actions = torch.rand((256, 1), generator=g) * 2 - 1
    card = adapt.cartpole_learnt_step(trainer.ld, states.to(device),
                                      actions.to(device), trainer.dt)
    cpu = adapt.cartpole_learnt_step(trainer.ld.to("cpu"), states, actions,
                                     trainer.dt)
    gap = max_errs(card.cpu(), cpu)
    log(f"[12] cartpole learnt step, 256 states, card vs CPU: max abs "
        f"{gap[0]:.2e}, rel {gap[1]:.2e} (rtol {STEP_RTOL}, atol "
        f"{STEP_ATOL})")
    torch.testing.assert_close(card.cpu(), cpu, rtol=STEP_RTOL,
                               atol=STEP_ATOL)


def counted(fn):
    """Run ``fn`` with the launch counts set to 0 just before and read
    just after -> (its result, launches, seconds)."""
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    launches = read_launches()
    return out, launches, time.perf_counter() - t0


def check_path_launches(tag, launches, forward):
    """The path launched the forward kernel ``forward`` times and the
    backward kernel never."""
    want = launch_counts(quad_rollout_fwd=forward)
    if launches != want:
        raise AssertionError(f"{tag}: launched {launches}, expected {want}")


def check_ppo_params(tag, card, cpu, lr, n_updates):
    """Card and CPU parameters after the same iteration: each leaf within
    PPO_PARAM_ATOL, else within Adam's step bound -> worst gap."""
    worst = 0.0
    for key, want in cpu.items():
        gap = float(np.abs(card[key] - want).max())
        worst = max(worst, gap)
        if gap > PPO_PARAM_ATOL:
            if gap > lr * n_updates:
                raise AssertionError(f"{tag}: {key} differs by {gap:.3e} "
                                     f"card vs CPU")
            log(f"[13] {tag}: {key} differs by {gap:.3e} (inside Adam's "
                f"step bound {lr * n_updates:.1e})")
    return worst


def phase_ppo(device):
    """PPO on each env: card vs CPU, then more iterations on the card, and
    the quad's evaluate_policy -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.baselines import ppo

    data_dir = os.path.join(ROOT, "data", "traj_data")
    cpu = torch.device("cpu")
    by_path = {}
    for robot in ("cartpole", "quad", "wing"):
        out = {}
        for side, dev in (("card", device), ("cpu", cpu)):
            env, _, lo, hi = ppo.make_env(robot, dev, speed=PPO_SPEED,
                                          reward="mpc", data_dir=data_dir)
            cfg = ppo.PPOConfig(n_envs=PPO_ENVS, n_steps=PPO_STEPS,
                                act_low=lo, act_high=hi)
            init, train_iter = ppo.make_ppo(env, cfg, dev)
            state = init(torch.Generator().manual_seed(0))
            draws = ppo.draw_iter(torch.Generator().manual_seed(1), env, cfg)
            (state, metrics), launches, secs = counted(
                lambda: train_iter(state, draws))
            out[side] = (env, state, {k: float(v) for k, v in metrics.items()},
                         launches, secs, train_iter)
        env, state, metrics, launches, secs, train_iter = out["card"]
        n_updates = cfg.n_epochs * cfg.n_minibatches
        worst = check_ppo_params(
            f"PPO {robot}", ppo.actor_critic_to_jax(state.params),
            ppo.actor_critic_to_jax(out["cpu"][1].params), cfg.lr, n_updates)
        cpu_metrics = out["cpu"][2]
        log(f"[13] PPO {robot} train_iter ({PPO_ENVS} envs x {PPO_STEPS} "
            f"steps, {n_updates} updates): card {secs:.2f} s, CPU "
            f"{out['cpu'][4]:.2f} s; launches {launches}; worst parameter "
            f"gap {worst:.3e}; card " + json.dumps(metrics) + "; CPU "
            + json.dumps(cpu_metrics))
        if metrics["mean_episode_len"] != cpu_metrics["mean_episode_len"]:
            raise AssertionError(f"PPO {robot}: the rollouts' episodes end "
                                 f"differently on card and CPU")
        for k in ("loss", "mean_reward"):
            if not math.isclose(metrics[k], cpu_metrics[k], rel_tol=1e-4,
                                abs_tol=1e-6):
                raise AssertionError(f"PPO {robot}: {k} card "
                                     f"{metrics[k]} vs CPU {cpu_metrics[k]}")
        per_step = PPO_STEPS if robot == "quad" else 0
        check_path_launches(f"PPO {robot} train_iter", launches, per_step)
        by_path[f"ppo_{robot}_train"] = launches
        times, losses = [], []
        for _ in range(PPO_CARD_ITERS):
            (state, m), more, secs = counted(lambda: train_iter(state))
            check_path_launches(f"PPO {robot} train_iter", more, per_step)
            times.append(secs)
            losses.append(float(m["loss"]))
        log(f"[13] PPO {robot}: {PPO_CARD_ITERS} more iterations on the "
            f"card, {np.mean(times):.2f} s each ({times}); losses {losses}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"PPO {robot}: non-finite losses {losses}")
        if robot == "quad":
            res, launches, secs = counted(lambda: ppo.evaluate_policy(
                state.params, env, torch.Generator().manual_seed(123),
                n_episodes=PPO_EVAL_EPISODES, max_steps=PPO_EVAL_STEPS))
            log(f"[13] PPO quad evaluate_policy ({PPO_EVAL_EPISODES} "
                f"episodes x {PPO_EVAL_STEPS} steps) in {secs:.2f} s; "
                f"launches {launches}; " + json.dumps(res))
            check_path_launches("PPO quad evaluate_policy", launches,
                                PPO_EVAL_STEPS)
            check_finite("PPO quad evaluate_policy", res, list(res))
            by_path["ppo_quad_eval"] = launches
    return by_path


def check_close(tag, got, want, rtol=BASELINE_METRIC_RTOL):
    if not math.isclose(got, want, rel_tol=rtol, abs_tol=1e-9):
        raise AssertionError(f"{tag}: card {got} vs CPU {want} (rtol "
                             f"{rtol})")


def check_no_flips(tag, success):
    flips = [int(i) for i in np.nonzero(success["card"] != success["cpu"])[0]]
    log(f"[13] {tag}: episodes whose success flag flips card vs CPU: "
        f"{flips}")
    if flips:
        raise AssertionError(f"{tag}: success flips {flips}")


def test_references(n=None):
    """The head-to-head protocol's references from the 200/20 bank:
    distinct test trajectories in RandomState(42)'s order, at speed 0.4,
    lifted 3 m -> (refs, ref_len)."""
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
        load_trajectory_bank,
        prepare_trajectory,
    )

    bank = load_trajectory_bank(ensure_trajectory_bank(
        os.path.join(ROOT, "data", "traj_data")), test=True)
    n = len(bank) if n is None else n
    idx = np.random.RandomState(42).choice(len(bank), size=n, replace=False)
    refs = np.stack([prepare_trajectory(bank[i], DT, PPO_SPEED)
                     for i in idx])
    refs[:, :, 2] += 3.0
    return refs, refs.shape[1] - HORIZON


def waypoints(n):
    """n targets at x = 50 m, y and z from RandomState(42) in +-5 m."""
    yz = (np.random.RandomState(42).rand(n, 2) - 0.5) * 2 * 5.0
    return np.concatenate([np.full((n, 1), 50.0), yz],
                          axis=1).astype(np.float32)


def phase_ppo_fixtures(device):
    """The four shipped PPO controllers on card and CPU -> {path:
    launches}."""
    from apg_trajectory_tracking_tpu_torch.baselines import ppo
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        WING_MEAN,
        WING_STD,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        reset_upright,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation import compare
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import run_eval
    from apg_trajectory_tracking_tpu_torch.evaluation.wing_eval import (
        fly_to_point,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
    )

    def actor(name, dev):
        return ppo.actor_critic_from_jax(load_checkpoint(
            os.path.join(ROOT, "assets", name), "model_ppo"), dev)

    cpu = torch.device("cpu")
    by_path = {}
    refs, ref_len = test_references()
    for name in ("quad_ppo_2m", "quad_ppo_mpc_2m"):
        success, metrics = {}, {}
        for side, dev in (("card", device), ("cpu", cpu)):
            (m, roll), launches, secs = counted(lambda: run_eval(
                actor(name, dev), quad_params(), refs, ref_len,
                thresh_div=1.0, thresh_stable=1.0, horizon=HORIZON, dt=DT,
                test_time=True, net_apply=compare.ppo_net_apply,
                action_transform=compare.ppo_action_transform))
            divs = roll["divergences"].cpu().numpy()
            valid = roll["valid"].cpu().numpy()
            success[side] = ((divs < 1.0) & valid).sum(axis=1) == min(
                251, ref_len + 1)
            metrics[side] = m
            log(f"[13] {name} on the {side} ({len(refs)} references) in "
                f"{secs:.2f} s: " + json.dumps(
                    {k: m[k] for k in ("mean_divergence", "ratio_stable",
                                       "mean_success", "n")}))
            if side == "card":
                check_path_launches(name, launches, 0)
                by_path["ppo_quad_fixture_eval"] = launches
        check_no_flips(name, success)
        check_close(f"{name} mean_divergence",
                    metrics["card"]["mean_divergence"],
                    metrics["cpu"]["mean_divergence"])

    targets = waypoints(10)
    success, metrics = {}, {}
    for side, dev in (("card", device), ("cpu", cpu)):
        roll, launches, secs = counted(lambda: fly_to_point(
            actor("wing_ppo_500k", dev), wing_params({}, device=dev),
            torch.tensor(targets, device=dev),
            torch.tensor(WING_MEAN, device=dev),
            torch.tensor(WING_STD, device=dev), thresh_div=10.0,
            thresh_stable=3.0, horizon=HORIZON, max_steps=WING_PPO_STEPS,
            dt=0.05, test_time=True, net_apply=compare.ppo_wing_net_apply,
            action_transform=compare.ppo_wing_action_transform))
        if not bool((roll["steps_alive"] < WING_PPO_STEPS).all()):
            raise AssertionError(f"wing_ppo_500k: an episode is still "
                                 f"flying after {WING_PPO_STEPS} steps")
        metrics[side] = compare.wing_point_metrics(roll)
        success[side] = roll["passed"].cpu().numpy()
        log(f"[13] wing_ppo_500k on the {side} (10 targets) in {secs:.2f} "
            f"s: " + json.dumps({k: metrics[side][k] for k in (
                "mean_target_error", "pass_rate", "mean_steps_alive", "n")}))
        if side == "card":
            check_path_launches("wing_ppo_500k", launches, 0)
            by_path["ppo_wing_eval"] = launches
    check_no_flips("wing_ppo_500k", success)
    check_close("wing_ppo_500k mean_target_error",
                metrics["card"]["mean_target_error"],
                metrics["cpu"]["mean_target_error"])

    starts = reset_upright(torch.Generator().manual_seed(7), 10)
    out = {}
    for side, dev in (("card", device), ("cpu", cpu)):
        params = actor("cartpole_ppo_500k", dev)
        (full, short), launches, secs = counted(lambda: tuple(
            compare.eval_cartpole_ppo_balance(
                params, cartpole_params(), starts, max_steps=steps)
            for steps in (250, CARTPOLE_PPO_SHORT_STEPS)))
        out[side] = (full, short)
        log(f"[13] cartpole_ppo_500k on the {side} (10 starts) in "
            f"{secs:.2f} s: " + json.dumps({k: full[k] for k in (
                "mean_stable", "ratio_full", "mean_vel", "n")})
            + f"; over {CARTPOLE_PPO_SHORT_STEPS} steps mean_vel "
            f"{short['mean_vel']}")
        if side == "card":
            check_path_launches("cartpole_ppo_500k", launches, 0)
            by_path["ppo_cartpole_eval"] = launches
    for k in ("mean_stable", "ratio_full"):
        if out["card"][0][k] != out["cpu"][0][k]:
            raise AssertionError(f"cartpole_ppo_500k: {k} card "
                                 f"{out['card'][0][k]} vs CPU "
                                 f"{out['cpu'][0][k]}")
    check_close("cartpole_ppo_500k short mean_vel",
                out["card"][1]["mean_vel"], out["cpu"][1]["mean_vel"],
                CARTPOLE_PPO_SHORT_RTOL)
    return by_path


def pets_agents(device):
    """{system: (card agent, CPU agent, state dim, act dim)} with the
    shipped ensembles and the runners' planner."""
    from apg_trajectory_tracking_tpu_torch.baselines import pets
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
    )

    specs = {
        "quad": (12, 4, pets.make_quad_tracking_reward(), 0.0, 1.0),
        "wing": (12, 4, pets.make_wing_pets_reward(), 0.0, 1.0),
        "cartpole": (4, 1, pets.cartpole_reward, -1.0, 1.0),
    }
    agents = {}
    for system, (sd, ad, reward, lo, hi) in specs.items():
        arrays = load_checkpoint(os.path.join(ROOT, "assets",
                                              f"{system}_pets"), "model_pets")
        pair = []
        for dev in (device, torch.device("cpu")):
            agent = pets.runner_agent(sd, ad, reward, lo, hi, 0, dev)
            agent.load_model(arrays)
            pair.append(agent)
        agents[system] = (*pair, sd, ad)
    return agents


def phase_pets(device):
    """One PETS trial per system, the shipped ensembles under the
    head-to-head evaluators on the card, and a few control steps card vs
    CPU -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.baselines import pets
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        reset_upright,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation import compare
    from apg_trajectory_tracking_tpu_torch.evaluation.quad_eval import (
        metrics_from_rollout,
    )

    by_path = {}
    data_dir = os.path.join(ROOT, "data", "traj_data")
    for system, run in (("cartpole", pets.run_pets_cartpole),
                        ("wing", pets.run_pets_wing),
                        ("quad", functools.partial(pets.run_pets_quad,
                                                   data_dir=data_dir))):
        (agent, history), launches, secs = counted(lambda: run(
            trials=1, trial_length=PETS_TRIAL_LENGTH, verbose=False,
            device=device))
        if isinstance(history, list):
            history = {"rewards": history}
        env_steps = len(agent.buffer["s"])
        log(f"[13] PETS {system}: 1 trial of at most {PETS_TRIAL_LENGTH} "
            f"steps after {PETS_TRIAL_LENGTH} exploration steps in "
            f"{secs:.2f} s ({env_steps} env steps); launches {launches}; "
            + json.dumps(history))
        check_path_launches(f"PETS {system} trial", launches,
                            env_steps if system == "quad" else 0)
        if not all(math.isfinite(r) for r in history["rewards"]):
            raise AssertionError(f"PETS {system}: rewards {history}")
        by_path[f"pets_{system}_trial"] = launches

    agents = pets_agents(device)
    refs, ref_len = test_references(PETS_QUAD_REFS)
    targets = waypoints(PETS_WING_TARGETS)
    starts = reset_upright(torch.Generator().manual_seed(7),
                           PETS_CARTPOLE_STARTS).numpy()
    card = {system: pair[0] for system, pair in agents.items()}
    roll, launches, secs = counted(lambda: pets.eval_pets_quad_tracking(
        card["quad"], quad_params(), refs, ref_len,
        max_steps=PETS_QUAD_STEPS))
    m = metrics_from_rollout(roll["divergences"], roll["valid"], 1.0,
                             PETS_QUAD_STEPS, ref_len)
    steps = roll["control_steps"]
    log(f"[13] quad_pets ({PETS_QUAD_REFS} references, at most "
        f"{PETS_QUAD_STEPS} steps) on the card in "
        f"{secs:.2f} s, {steps} control steps, {1e3 * secs / steps:.1f} ms "
        f"each; launches {launches}; " + json.dumps(
            {k: m[k] for k in ("mean_divergence", "ratio_stable",
                               "mean_success", "n")}))
    check_path_launches("quad_pets tracking eval", launches, steps)
    check_finite("quad_pets", m, ("mean_divergence", "mean_success"))
    by_path["pets_quad_eval"] = launches

    roll, launches, secs = counted(lambda: pets.eval_pets_wing_waypoints(
        card["wing"], wing_params({}), targets))
    m = compare.wing_point_metrics(roll)
    steps = roll["control_steps"]
    log(f"[13] wing_pets ({PETS_WING_TARGETS} targets) on the card in "
        f"{secs:.2f} s, {steps} control steps, {1e3 * secs / steps:.1f} ms "
        f"each; launches {launches}; " + json.dumps(
            {k: m[k] for k in ("mean_target_error", "pass_rate",
                               "mean_steps_alive", "n")}))
    check_path_launches("wing_pets waypoint eval", launches, 0)
    check_finite("wing_pets", m, ("mean_target_error",))
    by_path["pets_wing_eval"] = launches

    m, launches, secs = counted(lambda: pets.eval_pets_balance(
        card["cartpole"], cartpole_params(), starts,
        max_steps=PETS_CARTPOLE_STEPS))
    steps = int(round(m["mean_stable"] + 1)) * PETS_CARTPOLE_STARTS
    log(f"[13] cartpole_pets ({PETS_CARTPOLE_STARTS} starts x "
        f"{PETS_CARTPOLE_STEPS} steps) on the card in {secs:.2f} s, about "
        f"{1e3 * secs / steps:.1f} ms per control step; launches "
        f"{launches}; " + json.dumps({k: m[k] for k in (
            "mean_stable", "mean_vel", "n")}))
    check_path_launches("cartpole_pets balance eval", launches, 0)
    check_finite("cartpole_pets", m, ("mean_stable", "mean_vel"))
    by_path["pets_cartpole_eval"] = launches

    k = PETS_PLAN_EPISODES
    pets_plans_card_vs_cpu(agents, refs[:k], targets[:k], starts[:k])
    return by_path


def elites_agree(tag, card, cpu, n_elites):
    """Card and CPU CEM iterations from the same inputs: returns within
    PETS_RETURN_RTOL, and the same elite sets, except where the CPU's
    returns tie at the cut within the card-vs-CPU return gap -> whether
    the sets were equal."""
    r_card, r_cpu = card[3], cpu[3]
    gap = (r_card - r_cpu).abs()
    scale = r_cpu.abs().max(dim=1, keepdim=True).values.clamp_min(1.0)
    if (gap / scale).max() > PETS_RETURN_RTOL:
        raise AssertionError(f"{tag}: returns differ by "
                             f"{float(gap.max()):.3e} card vs CPU")
    equal = True
    for b in range(r_cpu.shape[0]):
        swapped = set(card[2][b].tolist()) ^ set(cpu[2][b].tolist())
        if not swapped:
            continue
        equal = False
        cut = torch.sort(r_cpu[b], descending=True).values[n_elites - 1]
        tie = 2 * float(gap[b].max())
        far = [j for j in swapped if abs(float(r_cpu[b, j] - cut)) > tie]
        log(f"[13] {tag}, episode {b}: elites {sorted(swapped)} swap at "
            f"the cut ({float(cut):.7f}); their CPU returns "
            f"{[float(r_cpu[b, j]) for j in sorted(swapped)]}, the largest "
            f"card-vs-CPU return gap {tie / 2:.2e}")
        if far:
            raise AssertionError(f"{tag}: elites {far} differ card vs CPU "
                                 f"beyond a tie at the cut")
    return equal


def pets_plans_card_vs_cpu(agents, refs, targets, starts):
    """PETS_PLAN_STEPS control steps of each shipped ensemble, card vs CPU
    from the same draws, the CPU's closed loop driving both. Each CEM
    iteration runs on both from the CPU's Gaussian: returns within
    PETS_RETURN_RTOL, the same elites (a swap is allowed only between
    returns that tie within the card-vs-CPU gap); then the whole plans,
    within PETS_PLAN_ATOL unless such a tie moved the card's."""
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
        wing_step,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        quad_params,
        quad_step,
    )
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import env_step
    from apg_trajectory_tracking_tpu_torch.trajectory.refs import (
        array_ref_window,
    )

    refs_t = torch.tensor(refs)
    wing0 = torch.zeros((len(targets), 12))
    wing0[:, 3] = 11.5
    quad0 = torch.zeros((len(refs), 12))
    quad0[:, :3] = refs_t[:, 0, :3]
    cases = {
        "quad": (quad0, lambda i: array_ref_window(refs_t, i, 10),
                 quad_step, quad_params(), 0.1),
        "wing": (wing0, lambda i: torch.tensor(targets)[:, None].expand(
            -1, 10, 3), wing_step, wing_params({}), 0.05),
        "cartpole": (torch.tensor(starts),
                     lambda i: torch.zeros((len(starts), 10, 0)),
                     env_step, cartpole_params(), 0.05),
    }
    for system, (state, ctx_of, step, params, dt) in cases.items():
        card, cpu, _, ad = agents[system]
        planner = cpu.plan
        gen = torch.Generator().manual_seed(5)
        n = state.shape[0]
        prev = torch.zeros((n, 10, ad))
        plan_gaps, ret_gaps, ties = [], [], 0
        times = {"card": [], "cpu": []}
        for i in range(PETS_PLAN_STEPS):
            draws = planner.draw(gen, n)
            ctx = ctx_of(i)
            mean, std = prev, planner.initial_std(prev)
            no_tie = True
            for it in range(planner.n_iters):
                out = {}
                for side, agent in (("card", card), ("cpu", cpu)):
                    dev = agent.device
                    out[side] = [x.cpu() for x in planner.iterate(
                        agent.model, state.to(dev), mean.to(dev),
                        std.to(dev), ctx.to(dev),
                        draws.samples[it].to(dev), draws.members[it].to(dev),
                        draws.noise[it].to(dev))]
                ret_gaps.append(float((out["card"][3] - out["cpu"][3])
                                      .abs().max()))
                if not elites_agree(f"PETS {system} step {i} iteration {it}",
                                    out["card"], out["cpu"],
                                    planner.n_elites):
                    no_tie = False
                    ties += 1
                mean, std = out["cpu"][0], out["cpu"][1]
            plans = {}
            for side, agent in (("card", card), ("cpu", cpu)):
                t0 = time.perf_counter()
                plans[side] = [x.cpu() for x in agent.plan(
                    agent.model, state.to(agent.device),
                    prev.to(agent.device), ctx.to(agent.device),
                    draws=draws)]
                times[side].append(time.perf_counter() - t0)
            gap = max(float((plans["card"][j] - plans["cpu"][j]).abs().max())
                      for j in range(2))
            if no_tie:
                plan_gaps.append(gap)
            else:
                log(f"[13] PETS {system} step {i}: a tie at the cut moved "
                    f"the card's plan by {gap:.3e}; not held to "
                    f"{PETS_PLAN_ATOL}")
            prev = plans["cpu"][1]
            state = step(params, state, plans["cpu"][0], dt)
        log(f"[13] PETS {system}, {PETS_PLAN_STEPS} control steps of {n} "
            f"episodes from the same draws: worst return gap card vs CPU "
            f"{max(ret_gaps):.3e}; elites the same in "
            f"{len(ret_gaps) - ties} of {len(ret_gaps)} iterations (the "
            f"rest ties at the cut); worst plan gap "
            f"{max(plan_gaps, default=float('nan')):.3e} (atol "
            f"{PETS_PLAN_ATOL}); ms per plan card "
            f"{1e3 * np.mean(times['card']):.1f}, CPU "
            f"{1e3 * np.mean(times['cpu']):.1f}")
        if plan_gaps and max(plan_gaps) > PETS_PLAN_ATOL:
            raise AssertionError(f"PETS {system}: plans differ by "
                                 f"{max(plan_gaps):.3e} card vs CPU")


def mpc_loop(solver, horizon, iters, refs, ref_len, dev, steps):
    """``steps`` control steps of the quad MPC closed loop on ``dev`` ->
    (rollout on the host, launches, seconds)."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.evaluation import compare

    mpc = MPC(horizon=horizon, dt=DT, solver=solver, n_iters=iters,
              device=dev)
    refs_d = torch.as_tensor(refs, device=dev)
    params = quad_params(device=dev)
    roll, launches, secs = counted(lambda: compare.mpc_follow_trajectories(
        mpc._solve, params, refs_d, ref_len, horizon=horizon,
        max_steps=steps, dt=DT))
    return {k: v.cpu().numpy() for k, v in roll.items()}, launches, secs


def check_loop_card_vs_cpu(tag, card, cpu, atol=MPC_CARD_ATOL):
    gap = float(np.abs(card["divergences"] - cpu["divergences"]).max())
    log(f"[14] {tag}: divergences card vs CPU within {gap:.2e}")
    if not np.array_equal(card["valid"], cpu["valid"]):
        raise AssertionError(f"{tag}: valid masks differ card vs CPU")
    if gap > atol:
        raise AssertionError(f"{tag}: divergences differ by {gap:.3e}")


def check_launches(tag, launches, per_kernel):
    want = launch_counts(quad_rollout_fwd=per_kernel,
                         quad_rollout_bwd=per_kernel)
    if launches != want:
        raise AssertionError(f"{tag}: launched {launches}, expected {want}")


def phase_quad_mpc(device):
    """The quad MPC rows of the comparison table -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.evaluation import compare

    cpu = torch.device("cpu")
    refs, n = compare.quad_references(
        os.path.join(ROOT, "data", "traj_data"), MPC_REFS, DT, PPO_SPEED,
        bank_train=200, bank_test=20)
    ref_len = refs.shape[1] - HORIZON
    by_path = {}
    rows = {}
    out = {}
    for side, dev in (("card", device), ("CPU", cpu)):
        out[side] = mpc_loop("adam", HORIZON, MPC_ITERS_H10, refs, ref_len,
                             dev, MPC_STEPS)
        log(f"[14] MPC (adam) h={HORIZON}, {MPC_ITERS_H10} iterations, "
            f"{n} references on the {side}: {MPC_STEPS} control steps in "
            f"{out[side][2]:.2f} s, "
            f"{out[side][2] / MPC_STEPS * 1e3:.1f} ms per control step; "
            f"launches {out[side][1]}")
        rows[f"MPC (adam) {side}"] = compare.tracking_metrics(
            out[side][0], 1.0, ref_len, max_steps=MPC_STEPS)
    check_loop_card_vs_cpu("MPC (adam) h=10", out["card"][0], out["CPU"][0])
    check_launches("MPC (adam) h=10", out["card"][1],
                   MPC_STEPS * MPC_ITERS_H10)
    by_path["mpc_adam_h10"] = out["card"][1]
    for horizon, iters in MPC_WIDE:
        roll, launches, secs = mpc_loop("adam", horizon, iters, refs,
                                        ref_len, device, MPC_WIDE_STEPS)
        log(f"[14] MPC (adam, h={horizon}) {iters} iterations on the card: "
            f"{MPC_WIDE_STEPS} control steps in {secs:.2f} s, "
            f"{secs / MPC_WIDE_STEPS * 1e3:.1f} ms per control step; "
            f"launches {launches}")
        check_launches(f"MPC (adam, h={horizon})", launches,
                       MPC_WIDE_STEPS * iters)
        if not np.isfinite(roll["divergences"]).all():
            raise AssertionError(f"MPC h={horizon}: non-finite divergences")
        by_path[f"mpc_adam_h{horizon}"] = launches
    out = {}
    for side, dev in (("card", device), ("CPU", cpu)):
        out[side] = mpc_loop("ilqr", HORIZON, None, refs, ref_len, dev,
                             ILQR_STEPS)
        log(f"[14] MPC (ilqr) on the {side}: {ILQR_STEPS} control steps in "
            f"{out[side][2]:.2f} s, "
            f"{out[side][2] / ILQR_STEPS * 1e3:.1f} ms per control step; "
            f"launches {out[side][1]}")
        rows[f"MPC (ilqr) {side}"] = compare.tracking_metrics(
            out[side][0], 1.0, ref_len, max_steps=ILQR_STEPS)
    check_loop_card_vs_cpu("MPC (ilqr)", out["card"][0], out["CPU"][0])
    check_launches("MPC (ilqr)", out["card"][1], 0)
    by_path["mpc_ilqr"] = out["card"][1]
    for name, m in rows.items():
        check_finite(name, m, ["mean_divergence", "mean_success"])
    table = compare.format_table(
        rows, compare.QUAD_COLUMNS,
        title=f"Quadrotor tracking, {n} test references, the first "
              f"{MPC_STEPS} (Adam) and {ILQR_STEPS} (iLQR) steps")
    for line in table.splitlines():
        log(f"[14] {line}")
    return by_path


def recording(step, states):
    """``step`` that also keeps every state it returns."""

    def run(*args):
        out = step(*args)
        states.append(out.cpu())
        return out

    return run


def phase_system_mpc(device):
    """The wing and cartpole MPC rows, card vs CPU -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
        wing_params,
        wing_step,
    )
    from apg_trajectory_tracking_tpu_torch.envs.cartpole_env import (
        reset_upright,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation import compare
    from apg_trajectory_tracking_tpu_torch.evaluation.cartpole_eval import (
        evaluate_balance,
    )

    targets = waypoints(SYSTEM_MPC_EPISODES)
    starts = reset_upright(torch.Generator().manual_seed(7),
                           SYSTEM_MPC_EPISODES)
    wing, cartpole = {}, {}
    by_path = {}
    for side, dev in (("card", device), ("CPU", torch.device("cpu"))):
        mpc = MPC(horizon=HORIZON, dt=0.05, dynamics="fixed_wing_3D",
                  n_iters=WING_MPC_ITERS, device=dev)
        states = []
        roll, launches, secs = counted(lambda: compare.mpc_fly_to_point(
            mpc._solve, wing_params({}, dev), torch.as_tensor(targets,
                                                              device=dev),
            dyn_step=recording(wing_step, states), horizon=HORIZON,
            max_steps=SYSTEM_MPC_STEPS, dt=0.05))
        wing[side] = (torch.stack(states), roll)
        log(f"[14] wing MPC on the {side}: {SYSTEM_MPC_STEPS} control steps "
            f"of {WING_MPC_ITERS} iterations in {secs:.2f} s; launches "
            f"{launches}")
        if side == "card":
            check_launches("wing MPC", launches, 0)
            by_path["mpc_wing"] = launches

        mpc = MPC(horizon=HORIZON, dt=0.05, dynamics="cartpole", device=dev)
        apply = compare.make_cartpole_mpc_apply(mpc)
        seen = []

        def recorded(params, states, apply=apply, seen=seen):
            seen.append(states.cpu())
            return apply(params, states)

        raw, launches, secs = counted(lambda: evaluate_balance(
            None, cartpole_params(device=dev), states=starts.to(dev),
            net_apply=recorded, max_steps=SYSTEM_MPC_STEPS))
        cartpole[side] = (torch.stack(seen), raw)
        log(f"[14] cartpole MPC on the {side}: {SYSTEM_MPC_STEPS} control "
            f"steps in {secs:.2f} s; launches {launches}")
        if side == "card":
            check_launches("cartpole MPC", launches, 0)
            by_path["mpc_cartpole"] = launches
    gap = float((wing["card"][0] - wing["CPU"][0]).abs().max())
    log(f"[14] wing MPC states card vs CPU within {gap:.2e}")
    if gap > MPC_CARD_ATOL:
        raise AssertionError(f"wing MPC: states differ by {gap:.3e}")
    for k in ("div_target_cnt", "passed", "steps_alive"):
        if not torch.equal(wing["card"][1][k].cpu(), wing["CPU"][1][k]):
            raise AssertionError(f"wing MPC: {k} differs card vs CPU")
    gap = float((cartpole["card"][0] - cartpole["CPU"][0]).abs().max())
    log(f"[14] cartpole MPC states card vs CPU within {gap:.2e}")
    if gap > MPC_CARD_ATOL:
        raise AssertionError(f"cartpole MPC: states differ by {gap:.3e}")
    if not torch.equal(cartpole["card"][1]["steps_per_episode"].cpu(),
                       cartpole["CPU"][1]["steps_per_episode"]):
        raise AssertionError("cartpole MPC: balance counts differ")
    return by_path


def phase_analytic(device):
    """Two shipped controllers on the analytic references as the quad eval
    CLI flies them, card vs CPU -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval

    total = launch_counts()
    for name in ANALYTIC_ASSETS:
        path = os.path.join(ROOT, "assets", name)
        for ref in ANALYTIC_REFS:
            out = {}
            for side, dev in (("card", device), ("CPU", torch.device("cpu"))):
                net, cfg = quad_eval.load_quad_controller(path, device=dev)
                init, window_fn, project_fn = quad_eval.analytic_setup(
                    ref, cfg, ANALYTIC_N, dev, cfg["horizon"])
                roll, launches, secs = counted(
                    lambda: quad_eval.follow_analytic(
                        net, quad_params(device=dev), window_fn, project_fn,
                        init, max_steps=ANALYTIC_STEPS, dt=cfg["delta_t"]))
                divs = roll["divergences"].cpu().numpy()
                valid = roll["valid"].cpu().numpy()
                err = float((divs * valid).sum() / max(valid.sum(), 1))
                out[side] = (err, valid.sum(axis=1))
                log(f"[14] {name} {ref} on the {side}: avg divergence "
                    f"{err:.6f}, mean steps before divergence "
                    f"{valid.sum(axis=1).mean():.1f}, in {secs:.2f} s; "
                    f"launches {launches}")
                if side == "card":
                    check_launches(f"{name} {ref}", launches, 0)
                    for kernel, count in launches.items():
                        total[kernel] += count
                if not math.isfinite(err):
                    raise AssertionError(f"{name} {ref}: divergence {err}")
            success = {side: steps == ANALYTIC_STEPS
                       for side, (_, steps) in out.items()}
            if not np.array_equal(success["card"], success["CPU"]):
                raise AssertionError(f"{name} {ref}: success flips card vs "
                                     f"CPU")
            check_close(f"{name} {ref} divergence", out["card"][0],
                        out["CPU"][0], rtol=ANALYTIC_RTOL)
    return {"analytic": total}


def phase_minjerk_training(device):
    """One concurrent epoch of TrainQuad with minjerk_mix at the shipped
    config -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.training.common import load_config
    from apg_trajectory_tracking_tpu_torch.training.train_quad import TrainQuad
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_config as load_run_config,
    )

    save_name = "chip_smoke_minjerk"
    shutil.rmtree(os.path.join("trained_models", "quad", save_name),
                  ignore_errors=True)
    trainers = {}
    for side, dev in (("card", device), ("CPU", torch.device("cpu"))):
        trainers[side] = TrainQuad(
            load_config("quad"), save_name=save_name,
            data_dir=os.path.join(ROOT, "data", "traj_data"),
            minjerk_mix=MINJERK_MIX, device=dev)
    card, cpu = trainers["card"], trainers["CPU"]
    n = card.buffers.num_sampled
    refs = card.buffers.refs.cpu()
    mixed = (refs[:n, :, 3:6] == 0).all(dim=2).all(dim=1)
    gap = float((refs - cpu.buffers.refs).abs().max())
    scale = float(cpu.buffers.refs.abs().max())
    log(f"[14] minjerk_mix {MINJERK_MIX}: {int(mixed.sum())} of {n} sampled "
        f"windows mixed; windows card vs CPU within {gap:.2e} (largest "
        f"|value| {scale:.2f})")
    if int(mixed.sum()) != int(MINJERK_MIX * n) or gap > MIX_RTOL * scale:
        raise AssertionError("minjerk_mix: the mixed windows differ")
    _, launches, secs = counted(lambda: card.fit(1, verbose=False))
    loss = card.logger.results["loss"][-1]
    saved = load_run_config(card.save_path)["minjerk_mix"]
    log(f"[14] minjerk_mix: 1 epoch in {secs:.1f} s; train steps "
        f"{card.steps_taken}; launches {launches}; loss {loss:.3f}; "
        f"config.json minjerk_mix {saved}")
    check_launches("minjerk_mix epoch", launches, card.steps_taken)
    if not math.isfinite(loss) or saved != MINJERK_MIX:
        raise AssertionError(f"minjerk_mix: loss {loss}, saved {saved}")
    return {"minjerk_mix": launches}


def phase_new_shapes(device, worst):
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params

    params = quad_params({}, device)
    for B in NEW_B:
        for k in NEW_K:
            inputs = rollout_inputs(B, 100 * B + k, device, k)
            check_kernels(params, *inputs, worst,
                          f"[14] default B={B} k={k}")


def phase_comparison(device, worst):
    """Phase 14, leg by leg with its time -> {path: launches}."""
    by_path = {}
    for leg, fn in (("quad MPC", lambda: phase_quad_mpc(device)),
                    ("wing and cartpole MPC",
                     lambda: phase_system_mpc(device)),
                    ("analytic flights", lambda: phase_analytic(device)),
                    ("minjerk_mix training",
                     lambda: phase_minjerk_training(device)),
                    ("kernels at the new shapes",
                     lambda: phase_new_shapes(device, worst) or {})):
        t = time.perf_counter()
        by_path.update(fn())
        log(f"[time] phase 14 {leg} {time.perf_counter() - t:.1f} s")
    return by_path


class StageClock:
    """Wraps functions: each call's seconds (synchronised on both ends),
    its launches of each kernel and its positional arguments."""

    def __init__(self):
        self.calls = []

    def timed(self, label, fn):
        from apg_trajectory_tracking_tpu_torch.perf.common import launches

        def run(*args, **kw):
            torch.cuda.synchronize()
            f0, b0 = launches()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            f1, b1 = launches()
            self.calls.append({
                "stage": label(kw) if callable(label) else label,
                "s": time.perf_counter() - t0,
                "fwd": f1 - f0, "bwd": b1 - b0, "args": args})
            return out

        return run

    def of(self, stage):
        return [c for c in self.calls if c["stage"] == stage]

    def summary(self):
        """{stage: [calls, seconds, forward launches, backward launches]}"""
        out = {}
        for c in self.calls:
            row = out.setdefault(c["stage"], [0, 0.0, 0, 0])
            row[0] += 1
            row[1] += c["s"]
            row[2] += c["fwd"]
            row[3] += c["bwd"]
        return out


@contextlib.contextmanager
def instrumented(clock):
    """Every stage of ``training/distill.py`` timed by ``clock``: the
    labelling calls, the fits, the teacher rollout, the evaluations and the
    DAgger flights (the two evaluators' test-time and train-time runs)."""
    from apg_trajectory_tracking_tpu_torch.evaluation import (
        quad_eval,
        wing_eval,
    )
    from apg_trajectory_tracking_tpu_torch.training import distill

    def wing_flight(kw):
        return "evaluate" if kw.get("test_time") else "DAgger flight"

    patches = {
        "label_quad": clock.timed("label", distill.label_quad),
        "label_wing": clock.timed("label", distill.label_wing),
        "label_sequences": clock.timed("label",
                                       distill.label_sequences),
        "teacher_rollout": clock.timed("teacher rollout",
                                       distill.teacher_rollout),
        "fit_steps": clock.timed("fit", distill.fit_steps),
        "quad_eval": types.SimpleNamespace(
            run_eval=clock.timed("evaluate", quad_eval.run_eval),
            follow_trajectories=clock.timed("DAgger flight",
                                            quad_eval.follow_trajectories),
            resolve_model_dir=quad_eval.resolve_model_dir),
        "wing_eval": types.SimpleNamespace(
            run_eval=clock.timed(wing_flight, wing_eval.run_eval)),
    }
    saved = {name: getattr(distill, name) for name in patches}
    for name, fn in patches.items():
        setattr(distill, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(distill, name, fn)


def captured(fn, phase=15):
    """Run ``fn``, its standard output logged line by line under
    [``phase``] -> (its result, the output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"[{phase}]   | {line}")
    return out, text


def round_metrics(text):
    """{line head: metrics} of the printed rounds ("cloned", "dagger i
    (...)", "teacher-forced", "distilled+APG")."""
    rounds = {}
    for line in text.splitlines():
        head, sep, tail = line.partition(": {")
        if sep:
            rounds[head] = json.loads("{" + tail)
    return rounds


def log_stages(tag, clock):
    for stage, (n, secs, fwd, bwd) in clock.summary().items():
        log(f"[15] {tag}: {stage}: {n} calls, {secs:.2f} s; launches "
            f"fwd {fwd} bwd {bwd}")


def distill_leg(tag, run, clock=None):
    """One distillation run with its launch counts set to 0 just before and
    read just after -> (clock, output, launches, seconds)."""
    clock = clock or StageClock()
    with instrumented(clock):
        (_, text), launches, secs = counted(lambda: captured(run))
    log(f"[15] {tag}: {secs:.1f} s; launches {launches}")
    log_stages(tag, clock)
    return clock, text, launches, secs


def check_labels(tag, clock, iters):
    """Each labelling call launched ``iters`` of each kernel -> the
    launches of all of them."""
    labels = clock.of("label")
    for c in labels:
        if (c["fwd"], c["bwd"]) != (iters, iters):
            raise AssertionError(f"{tag}: a labelling call launched "
                                 f"{c['fwd']} / {c['bwd']}, expected {iters}")
    if any(c["fwd"] or c["bwd"] for c in clock.calls
           if c["stage"] not in ("label", "teacher rollout")):
        raise AssertionError(f"{tag}: a stage other than the teacher's "
                             f"launched a rollout kernel")
    return sum(c["fwd"] for c in labels)


def check_rounds(tag, text, keys):
    rounds = round_metrics(text)
    if [k.split(" (")[0] for k in rounds] != keys:
        raise AssertionError(f"{tag}: printed rounds {list(rounds)}")
    for head, m in rounds.items():
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{tag}: {head} {m}")
    return rounds


def phase_distill_quad(device):
    """Phase 15 (a): the feed-forward student at the CLI's widths, then one
    resumed round -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.training import distill

    data_dir = os.path.join(ROOT, "data", "traj_data")
    name = "chip_smoke_distilled"
    flags = [*DISTILL_QUAD, *DISTILL_QUAD_CUTS, "--data_dir", data_dir]
    for cut in ("--steps 100 of 4000", "--dagger_iters 1 of 3",
                "--eval 50 (the 200/20 bank's 20 test references)"):
        log(f"[15] quad student cut: {cut}")
    args = distill.parse_args(["quad", *flags, "-s", name])
    clock, text, launches, _ = distill_leg(
        "quad student", lambda: distill.distill_quad(args, device=device))
    total = check_labels("quad student", clock, args.mpc_iters)
    check_launches("quad student", launches, total)
    rounds = check_rounds("quad student", text, ["cloned", "dagger 0"])
    fits = clock.of("fit")
    for c in clock.of("label"):
        log(f"[15] quad labelling call: B = {c['args'][2].shape[0]}, "
            f"{c['s'] * 1e3:.1f} ms, launches {c['fwd']} / {c['bwd']} "
            f"(mpc_iters {args.mpc_iters})")
    log(f"[15] quad fit: {fits[0]['s'] / args.steps * 1e3:.2f} ms per step "
        f"at batch {args.batch}")
    for head, m in rounds.items():
        log(f"[15] quad {head}: err {m['err']} stable {m['stable']}")

    resume = distill.parse_args([
        "quad", *flags, "--dagger_iters", "1", "--base_model",
        os.path.join("trained_models", "quad", name), "--failure_focus",
        "--select", "stable", "-s", name + "_resumed"])
    clock, text, r_launches, _ = distill_leg(
        "quad resumed (failure focus, select stable)",
        lambda: distill.distill_quad(resume, device=device))
    total = check_labels("quad resumed", clock, resume.mpc_iters)
    check_launches("quad resumed", r_launches, total)
    if len(clock.of("fit")) != 1:
        raise AssertionError("quad resumed: cloned again")
    check_rounds("quad resumed", text, ["cloned", "dagger 0"])
    return {"distill_quad": launches, "distill_quad_resumed": r_launches}


def phase_distill_lstm(device):
    """Phase 15 (b): the recurrent student -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.training import distill

    for cut in ("--mpc_iters 20 of 100", "--steps 4 of 1500",
                "--dagger_iters 1 of 4",
                "--eval 50 (the 200/20 bank's 20 test references)"):
        log(f"[15] LSTM student cut: {cut}")
    args = distill.parse_args([
        "lstm", *DISTILL_LSTM, *DISTILL_LSTM_CUTS, "--data_dir",
        os.path.join(ROOT, "data", "traj_data"), "-s",
        "chip_smoke_distilled_lstm"])
    clock, text, launches, _ = distill_leg(
        "LSTM student", lambda: distill.distill_quad_lstm(args,
                                                          device=device))
    teacher = clock.of("teacher rollout")
    want = distill.TEACHER_STEPS * args.mpc_iters
    if [(c["fwd"], c["bwd"]) for c in teacher] != [(want, want)]:
        raise AssertionError(f"LSTM teacher launched "
                             f"{[(c['fwd'], c['bwd']) for c in teacher]}, "
                             f"expected {want} of each")
    labels = check_labels("LSTM student", clock, args.mpc_iters)
    check_launches("LSTM student", launches, want + labels)
    check_rounds("LSTM student", text, ["teacher-forced", "dagger 0"])
    fits = clock.of("fit")
    log(f"[15] LSTM teacher rollout: {teacher[0]['s']:.1f} s for "
        f"{args.rollouts} rollouts x {distill.TEACHER_STEPS} steps at "
        f"{args.mpc_iters} iterations, launches {want} of each kernel")
    log(f"[15] LSTM fit: {fits[0]['s'] / args.steps:.3f} s per step at "
        f"{args.seq_batch} sequences of {distill.TEACHER_STEPS} steps")
    return {"distill_lstm": launches}


def phase_distill_wing(device):
    """Phase 15 (c): the wing student -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.training import distill

    for cut in ("--mpc_iters 5 of 100", "--steps 200 of 4000",
                "--dagger_iters 1 of 4"):
        log(f"[15] wing student cut: {cut}")
    args = distill.parse_args(["wing", *DISTILL_WING, *DISTILL_WING_CUTS,
                               "-s", "chip_smoke_distilled_wing"])
    targets = distill.wing_cli_targets(args)
    clock, text, launches, _ = distill_leg(
        "wing student", lambda: distill.distill_wing(args, *targets,
                                                     device=device))
    check_launches("wing student", launches, 0)
    check_rounds("wing student", text, ["cloned", "dagger 0"])
    for c in clock.of("label"):
        log(f"[15] wing labelling call: B = {c['args'][2].shape[0]}, "
            f"{c['s']:.2f} s at {args.mpc_iters} iterations, h = "
            f"{args.teacher_horizon}")
    return {"distill_wing": launches}


def compare_rounds(tag, card, cpu):
    """The printed round metrics card vs CPU -> worst relative gap."""
    a, b = round_metrics(card), round_metrics(cpu)
    if list(a) != list(b):
        raise AssertionError(f"{tag}: rounds {list(a)} vs {list(b)}")
    worst = 0.0
    for head, m in a.items():
        for key, value in m.items():
            gap = abs(value - b[head][key]) / max(abs(b[head][key]), 1e-12)
            worst = max(worst, gap)
            if gap > ROUND_RTOL:
                raise AssertionError(f"{tag}: {head} {key} {value} vs "
                                     f"{b[head][key]}")
    return worst


def compare_saved(tag, path_card, path_cpu, name):
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        load_config,
    )

    a, b = load_checkpoint(path_card, name), load_checkpoint(path_cpu, name)
    if sorted(a) != sorted(b) or load_config(path_card) != load_config(
            path_cpu):
        raise AssertionError(f"{tag}: saved keys or config differ")
    gap = max(float(np.abs(a[k] - b[k]).max()) for k in a)
    if gap > NPZ_ATOL:
        raise AssertionError(f"{tag}: saved weights differ by {gap:.3e}")
    return gap


def phase_distill_card_vs_cpu(device):
    """Phase 15 (d): tiny quad and LSTM runs on card and CPU from the same
    initial nets and seed."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import (
        _SPECS,
        _make_solver,
    )
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        quad_params,
        quad_step,
    )
    from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
    from apg_trajectory_tracking_tpu_torch.models.rnn import LSTMNet
    from apg_trajectory_tracking_tpu_torch.training import distill

    data_dir = os.path.join(ROOT, "data", "traj_data")
    cpu = torch.device("cpu")
    out = {}
    for side, dev in (("card", device), ("CPU", cpu)):
        args = distill.parse_args(["quad", *TINY_QUAD, "--data_dir",
                                   data_dir, "-s", f"chip_smoke_tiny_{side}"])
        net = ControlNet(15, 10, 9, 40, generator=torch.Generator(
        ).manual_seed(0))
        _, out[side], launches, _ = distill_leg(
            f"tiny quad on the {side}",
            lambda: distill.distill_quad(args, net=net, device=dev))
    rounds_gap = compare_rounds("tiny quad", out["card"], out["CPU"])
    npz_gap = compare_saved(
        "tiny quad", *(os.path.join("trained_models", "quad",
                                    f"chip_smoke_tiny_{side}")
                       for side in ("card", "CPU")), "model_quad")
    log(f"[15] tiny quad card vs CPU: rounds within {rounds_gap:.2e} "
        f"relative, saved weights within {npz_gap:.2e}")

    seqs = {}
    for side, dev in (("card", device), ("CPU", cpu)):
        solve = _make_solver(quad_step, _SPECS["flightmare"].to(dev), 10,
                             DT, 3, 0.1)
        refs = torch.as_tensor(test_references(2)[0], device=dev)
        seqs[side] = [x.cpu() for x in distill.teacher_rollout(
            solve, quad_params(device=dev), refs, 10,
            steps=TINY_TEACHER_STEPS)]
    gap = max(float((a - b).abs().max()) for a, b in zip(
        (seqs["card"][0], seqs["card"][2]), (seqs["CPU"][0], seqs["CPU"][2])))
    log(f"[15] LSTM teacher card vs CPU over {TINY_TEACHER_STEPS} steps: "
        f"states and actions within {gap:.2e}")
    if gap > TEACHER_ATOL:
        raise AssertionError(f"LSTM teacher differs by {gap:.3e}")

    real_teacher = distill.teacher_rollout
    cpu_teacher = []

    def keep(*args, **kw):
        cpu_teacher.append(real_teacher(*args, **kw))
        return cpu_teacher[-1]

    def replay(solve, dyn, references, *args, **kw):
        return tuple(x.to(references.device) for x in cpu_teacher[0])

    for side, dev, teacher in (("CPU", cpu, keep), ("card", device, replay)):
        args = distill.parse_args(["lstm", *TINY_LSTM, "--data_dir",
                                   data_dir, "-s",
                                   f"chip_smoke_tiny_lstm_{side}"])
        net = LSTMNet(15, 10, 9, 4, hidden=16,
                      generator=torch.Generator().manual_seed(0))
        distill.teacher_rollout = teacher
        try:
            _, out[side], _, _ = distill_leg(
                f"tiny LSTM on the {side}",
                lambda: distill.distill_quad_lstm(args, net=net,
                                                  device=dev))
        finally:
            distill.teacher_rollout = real_teacher
    rounds_gap = compare_rounds("tiny LSTM", out["card"], out["CPU"])
    npz_gap = compare_saved(
        "tiny LSTM", *(os.path.join("trained_models", "quad",
                                    f"chip_smoke_tiny_lstm_{side}")
                       for side in ("card", "CPU")), "model_quad")
    log(f"[15] tiny LSTM card vs CPU (the CPU's teacher sequences): rounds "
        f"within {rounds_gap:.2e} relative, saved weights within "
        f"{npz_gap:.2e}")


def eval_cli(tag, main, argv):
    """One eval CLI on the card and with --cpu -> the last JSON line of
    each; the card's run launches no rollout kernel."""
    outs = {}
    for side, extra in (("card", []), ("CPU", ["--cpu"])):
        (_, text), launches, secs = counted(
            lambda: captured(lambda: main(argv + extra)))
        log(f"[15] {tag} on the {side}: {secs:.1f} s; launches {launches}")
        if side == "card":
            check_launches(tag, launches, 0)
            card_launches = launches
        outs[side] = text
    return outs, card_launches


def check_eval_row(tag, card, cpu, exact, close):
    worst = 0.0
    for key in exact:
        if card[key] != cpu[key]:
            raise AssertionError(f"{tag}: {key} {card[key]} vs {cpu[key]}")
    for key in close:
        gap = abs(card[key] - cpu[key]) / max(abs(cpu[key]), 1e-12)
        worst = max(worst, gap)
        if gap > EVAL_CLI_RTOL:
            raise AssertionError(f"{tag}: {key} {card[key]} vs {cpu[key]}")
    log(f"[15] {tag} card vs CPU: {', '.join(exact)} equal; "
        f"{', '.join(close)} within {worst:.2e} relative")


def phase_eval_clis(device):
    """Phase 15 (e): the wing, cartpole and epoch-sweep CLIs on the card,
    each against itself with --cpu -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.evaluation import (
        cartpole_eval,
        epochs,
        wing_eval,
    )
    from apg_trajectory_tracking_tpu_torch.training import train_quad

    def last(text):
        return json.loads(text.strip().splitlines()[-1])

    by_path = {}
    outs, by_path["wing_eval_cli"] = eval_cli(
        "wing eval CLI", wing_eval.main, ["-m", "assets/wing_trained", "-a",
                                          "3"])
    check_eval_row("wing eval CLI", last(outs["card"]), last(outs["CPU"]),
                   ["n"], ["mean_success", "mean_steps_alive"])
    for name, extra, exact, close in (
            ("cartpole_balance_trained", [], ["mean_stable", "n"],
             ["mean_vel"]),
            ("cartpole_swingup_trained", ["--swingup"],
             ["success_rate", "n"], ["mean_vel"])):
        tag = f"cartpole eval CLI {name}"
        outs, by_path[f"cartpole_eval_cli{extra and '_swingup' or ''}"] = (
            eval_cli(tag, cartpole_eval.main,
                     ["-m", f"assets/{name}", "-a", "3", *extra]))
        check_eval_row(tag, last(outs["card"]), last(outs["CPU"]), exact,
                       close)

    run = os.path.join("trained_models", "quad", "chip_smoke_epochs")
    shutil.rmtree(run, ignore_errors=True)
    data_dir = os.path.join(ROOT, "data", "traj_data")
    captured(lambda: train_quad.main([
        "-s", "chip_smoke_epochs", "--epochs", "2", "--data_dir", data_dir]))
    outs, by_path["epochs_cli"] = eval_cli(
        "epoch sweep CLI", epochs.main, ["-m", run, "-a", "10",
                                         "--data_dir", data_dir])
    rows = {side: [json.loads(line) for line in text.splitlines()
                   if line.startswith("[")] for side, text in outs.items()}
    if not rows["card"] or [r[0] for r in rows["card"]] != [
            r[0] for r in rows["CPU"]]:
        raise AssertionError(f"epoch sweep rows {rows}")
    for card, cpu in zip(rows["card"], rows["CPU"]):
        check_eval_row(f"epoch sweep CLI epoch {card[0]}",
                       dict(zip(("epoch", "div", "std", "stable"), card)),
                       dict(zip(("epoch", "div", "std", "stable"), cpu)),
                       ["epoch", "stable"], ["div"])
    return by_path


def phase_distillation(device):
    """Phase 15, leg by leg with its time -> {path: launches}."""
    by_path = {}
    for leg, fn in (("quad student", lambda: phase_distill_quad(device)),
                    ("LSTM student", lambda: phase_distill_lstm(device)),
                    ("wing student", lambda: phase_distill_wing(device)),
                    ("card vs CPU",
                     lambda: phase_distill_card_vs_cpu(device) or {}),
                    ("eval CLIs", lambda: phase_eval_clis(device))):
        t = time.perf_counter()
        by_path.update(fn())
        log(f"[time] phase 15 {leg} {time.perf_counter() - t:.1f} s")
    return by_path


def cpu_flag(device):
    """A CLI's ``--cpu`` when ``device`` is the CPU (a dry run of a phase
    off the card)."""
    return ["--cpu"] if device.type == "cpu" else []


def tables_args(**kw):
    return types.SimpleNamespace(
        **TABLES_QUICK, skip_mpc=True,
        data_dir=os.path.join(ROOT, "data", "traj_data"),
        wide_data_dir=os.path.join(ROOT, "data", "traj_data"), **kw)


def quad_rows(section):
    """[(tag, row)] of a wide, wall, speed or robustness section's
    result."""
    res = section["results"]
    if "0.4" in res:  # the speed matrix
        return [(f"{s} {m}", row) for s, per in res.items()
                for m, row in per.items()]
    first = next(iter(res.values()), {})
    if "translational_drag" in first:  # model -> param -> factor
        return [(f"{m} {p} x{f}", {"mean_divergence": row["err"],
                                   "ratio_stable": row["stable"],
                                   "n": row["n"]})
                for m, per in res.items() for p, cells in per.items()
                for f, row in cells.items()]
    return list(res.items())


def check_rows(tag, card, cpu, exact, close):
    """Rows of one section card vs CPU: the same rows, ``exact`` keys
    equal, ``close`` keys within TABLES_ROW_RTOL relative plus
    TABLES_ROW_ATOL -> the worst relative gap of a value above
    TABLES_ROW_ATOL."""
    if [t for t, _ in card] != [t for t, _ in cpu]:
        raise AssertionError(f"{tag}: rows {card} vs {cpu}")
    worst = 0.0
    for (name, g), (_, w) in zip(card, cpu):
        for key in exact:
            if g[key] != w[key]:
                raise AssertionError(f"{tag} {name}: {key} {g[key]} vs "
                                     f"{w[key]}")
        for key in close:
            diff = abs(g[key] - w[key])
            if abs(w[key]) > TABLES_ROW_ATOL:
                worst = max(worst, diff / abs(w[key]))
            if diff > TABLES_ROW_RTOL * abs(w[key]) + TABLES_ROW_ATOL:
                raise AssertionError(f"{tag} {name}: {key} {g[key]} vs "
                                     f"{w[key]}")
    return worst


def phase_table_sections(device):
    """The tables' sections card vs CPU -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.evaluation import tables

    cpu = torch.device("cpu")
    saved = {name: getattr(tables, name) for name in TABLES_MODELS}
    for name, models in TABLES_MODELS.items():
        setattr(tables, name, models)
    by_path = {}
    try:
        for name, fn in (
                ("wide", tables.wide_section),
                ("wall", tables.wall_section),
                ("speeds", tables.speeds_section),
                ("robustness", lambda a, d: tables.robustness_section(
                    a, d, factors=TABLES_ROBUSTNESS_FACTORS)),
                ("analytic", tables.analytic_section),
                ("swingup", tables.swingup_section)):
            out, secs = {}, {}
            for side, dev in (("card", device), ("CPU", cpu)):
                out[side], launches, secs[side] = counted(
                    lambda: fn(tables_args(), dev))
                if side == "card":
                    check_launches(f"tables {name}", launches, 0)
                    by_path[f"tables_{name}"] = launches
            if name == "swingup":
                rows = {side: list(o[0].items()) for side, o in out.items()}
                worst = check_rows(name, rows["card"], rows["CPU"],
                                   ("n", "success_rate"),
                                   ("mean_vel", "mean_final_angle"))
            elif name == "analytic":
                rows = {side: [(f"{m} {r}", row)
                               for m, per in o["results"].items()
                               for r, row in per.items()]
                        for side, o in out.items()}
                worst = check_rows(name, rows["card"], rows["CPU"],
                                   ("steps",), ("mean_divergence",))
            else:
                rows = {side: quad_rows(o) for side, o in out.items()}
                worst = check_rows(name, rows["card"], rows["CPU"],
                                   ("n", "ratio_stable"),
                                   ("mean_divergence",))
            log(f"[16] tables {name}: {len(rows['card'])} rows, card "
                f"{secs['card']:.2f} s, CPU {secs['CPU']:.2f} s; card vs CPU "
                f"within {worst:.2e} relative, counts equal; launches 0")
    finally:
        for name, models in saved.items():
            setattr(tables, name, models)
    return by_path


def phase_wall_mpc(device):
    """The wall's MPC (adam, h=20) row for WALL_MPC_STEPS control steps ->
    {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.evaluation import tables

    refs, n = tables.wide_references(
        TABLES_QUICK["wall_eval"], speed=0.5,
        data_dir=os.path.join(ROOT, "data", "traj_data"))
    row, launches, secs = counted(lambda: tables.wall_mpc_row(
        refs, device, n_iters=100, max_steps=WALL_MPC_STEPS))
    log(f"[16] wall MPC (adam, h=20), 100 iterations, {n} references: "
        f"{WALL_MPC_STEPS} control steps in {secs:.2f} s, "
        f"{secs / WALL_MPC_STEPS * 1e3:.1f} ms per control step; launches "
        f"{launches}")
    check_launches("wall MPC (adam, h=20)", launches, WALL_MPC_STEPS * 100)
    check_finite("wall MPC", row, ("mean_divergence", "mean_success"))
    return {"wall_mpc_adam_h20": launches}


def phase_rate_cap(device):
    """Concurrent steps of the rate-cap ablation and its widened unroll
    card vs twin -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.training import rate_cap
    from apg_trajectory_tracking_tpu_torch.training.common import load_config
    from apg_trajectory_tracking_tpu_torch.training.train_quad import (
        TrainQuad,
        dyn_step_unroll,
    )

    step = rate_cap.widened_step(RATE_CAP_SCALE)
    unroll = dyn_step_unroll(step)
    s, a, _ = rollout_inputs(RATE_CAP_B, 16, device)
    out = {}
    for side, dev in (("card", device), ("CPU", torch.device("cpu"))):
        actions = a.detach().to(dev).clone().requires_grad_()
        reset_launches()
        y = unroll(quad_params(device=dev), s.to(dev), actions, DT)
        (y ** 2).sum().backward()
        out[side] = (y.detach().cpu(), actions.grad.cpu())
        if side == "card":
            # a comparison launch: in no path's count
            check_launches("widened unroll", read_launches(), 1)
    fwd_err = max_errs(out["card"][0], out["CPU"][0])[0]
    scale = out["CPU"][1].abs().max().item()
    bwd_err = (out["card"][1] - out["CPU"][1]).abs().max().item()
    log(f"[16] rate cap: widened unroll (scale {RATE_CAP_SCALE}) at B = "
        f"{RATE_CAP_B}, k = {HORIZON} on the kernels vs the twin: forward "
        f"within {fwd_err:.2e}, action gradient within {bwd_err:.2e} (largest "
        f"{scale:.2e})")
    torch.testing.assert_close(out["card"][0], out["CPU"][0], rtol=RTOL,
                               atol=ATOL)
    torch.testing.assert_close(out["card"][1], out["CPU"][1], rtol=RTOL,
                               atol=BWD_ATOL_REL * scale)

    save_name = "chip_smoke_rate_cap"
    shutil.rmtree(os.path.join("trained_models", "quad", save_name),
                  ignore_errors=True)
    trainer = TrainQuad(
        load_config("quad", {"speed_factor": 0.5,
                             "epoch_size": RATE_CAP_ROWS, "self_play": 0}),
        save_name=save_name, curriculum=False, dyn_step=step,
        data_dir=os.path.join(ROOT, "data", "traj_data"), device=device)
    loss, step_launches, secs = counted(trainer.run_epoch)
    log(f"[16] rate cap: {trainer.steps_taken} concurrent steps in "
        f"{secs:.2f} s, loss {loss:.3f}; launches {step_launches}")
    check_launches("rate-cap steps", step_launches, trainer.steps_taken)
    if trainer.steps_taken != RATE_CAP_ROWS // TRAIN_B or not math.isfinite(
            loss):
        raise AssertionError(f"rate cap: {trainer.steps_taken} steps, loss "
                             f"{loss}")
    metrics, launches, secs = counted(lambda: trainer.evaluate(0))
    log(f"[16] rate cap: in-training evaluation under the widened step in "
        f"{secs:.2f} s; launches {launches}")
    check_launches("rate-cap evaluation", launches, 0)
    check_finite("rate-cap evaluation", metrics, ("mean_divergence",))
    return {"rate_cap_steps": step_launches}


def phase_adapt_protocol(device, tmp):
    """One cell of the quad adaptation protocol -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.training import adapt_protocol
    from apg_trajectory_tracking_tpu_torch.training.adapt import (
        TrainQuadAdapt,
    )

    bank = os.path.join(ROOT, "data", "traj_data")
    out_path = os.path.join(tmp, "robustness_adapt.json")
    real = TrainQuadAdapt.run_controller_epoch_learnt
    leg = {"calls": 0, "steps": 0, **launch_counts()}

    def counted_epoch(self, idx=None):
        reset_launches()
        steps0 = self.inner.steps_taken
        loss = real(self, idx)
        for key, n in read_launches().items():
            leg[key] += n
        leg["calls"] += 1
        leg["steps"] += self.inner.steps_taken - steps0
        return loss

    TrainQuadAdapt.run_controller_epoch_learnt = counted_epoch
    try:
        (_, text), launches, secs = counted(lambda: captured(
            lambda: adapt_protocol.main(
                ["quad", *ADAPT_PROTOCOL_ARGS, "--data_dir", bank,
                 "--train_data_dir", bank, "--out", out_path,
                 *cpu_flag(device)]), phase=16))
    finally:
        TrainQuadAdapt.run_controller_epoch_learnt = real
    with open(out_path) as f:
        result = json.load(f)
    cell = result["cells"]["translational_drag x1.9"]
    log(f"[16] quad adaptation protocol, one cell: {secs:.1f} s; controller "
        f"epoch {leg}; after {json.dumps(cell['after'])}; rate authority "
        f"feasible {cell['rate_authority']['feasible']}")
    per_step = HORIZON * leg["steps"]
    if leg["calls"] != 1 or leg["steps"] == 0:
        raise AssertionError(f"adaptation protocol: controller epoch {leg}")
    check_launches("adaptation protocol controller epoch",
                   {k: leg[k] for k in launches}, per_step)
    # the fit epoch and the protocol's evaluations launch nothing
    check_launches("adaptation protocol", launches, per_step)
    for key in ("before", "after", "after_final_epoch"):
        check_finite(f"adaptation protocol {key}", cell[key], ("err",))
    if not cell["rate_authority"]["feasible"] or set(result) != {
            "base_model", "protocol", "nominal", "cells"}:
        raise AssertionError(f"adaptation protocol: {result}")
    return {"adapt_protocol_controller_epoch": {
        k: leg[k] for k in ("quad_rollout_fwd", "quad_rollout_bwd")}}


def tree_digest(*paths):
    import hashlib

    h = hashlib.sha256()
    for path in paths:
        files = [path] if os.path.isfile(path) else sorted(
            os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs)
        for f in files:
            h.update(f.encode())
            with open(f, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def phase_tables_cli(device, tmp):
    """The tables CLI's --quick wing section on the card -> {path:
    launches}."""
    from apg_trajectory_tracking_tpu_torch.evaluation import tables

    published = [os.path.join(ROOT, "README.md"), os.path.join(ROOT, "docs")]
    before = tree_digest(*published)
    out_dir = os.path.join(tmp, "tables")
    (_, text), launches, secs = counted(lambda: captured(lambda: tables.main(
        ["--quick", "--sections", "wing", "--skip_mpc", "--out_dir",
         out_dir, *cpu_flag(device)]), phase=16))
    with open(os.path.join(out_dir, "all_results.json")) as f:
        rows = json.load(f)["wing_waypoint"]["results"]
    with open(os.path.join(out_dir, "tables_manifest.json")) as f:
        manifest = json.load(f)
    apg = rows["APG wing_trained"]
    log(f"[16] tables CLI --quick --sections wing --skip_mpc on the card: "
        f"{secs:.1f} s; rows {list(rows)}; APG {json.dumps(apg)}; launches "
        f"{launches}")
    check_launches("tables CLI wing", launches, 0)
    lo, hi = apg["pass_rate_ci"]
    wing = manifest["sections"]["wing"]
    if (apg["n"] != 3 or not lo <= apg["pass_rate"] <= hi
            or not wing["artifact"] or manifest["device"] != device.type):
        raise AssertionError(f"tables CLI: {apg}, {manifest}")
    if not os.path.isfile(os.path.join(out_dir, "WING_COMPARISON.md")):
        raise AssertionError("tables CLI: WING_COMPARISON.md not written")
    if tree_digest(*published) != before:
        raise AssertionError("tables CLI: the repo's README.md or docs/ "
                             "changed")
    log("[16] the repo's README.md and docs/ hash the same before and after")
    return {"tables_cli_wing": launches}


def phase_published_results(device):
    """Phase 16, leg by leg with its time -> {path: launches}."""
    tmp = os.path.join(ROOT, "trained_models", "chip_smoke_tables")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    by_path = {}
    for leg, fn in (("table sections", lambda: phase_table_sections(device)),
                    ("wall MPC row", lambda: phase_wall_mpc(device)),
                    ("rate cap", lambda: phase_rate_cap(device)),
                    ("adaptation protocol",
                     lambda: phase_adapt_protocol(device, tmp)),
                    ("tables CLI", lambda: phase_tables_cli(device, tmp))):
        t = time.perf_counter()
        by_path.update(fn())
        log(f"[time] phase 16 {leg} {time.perf_counter() - t:.1f} s")
    return by_path


# ---------------------------------------------------------------------------
# phase 17: the image and sequence cartpole, and the deployment path
# ---------------------------------------------------------------------------


def leaf_gaps(card, cpu, init):
    """{leaf: |card - cpu| / |cpu - init|} in norm over {key: array}
    dicts."""
    return {k: float(np.linalg.norm(card[k] - cpu[k])
                     / max(np.linalg.norm(cpu[k] - init[k]), 1e-30))
            for k in cpu}


def check_fit(tag, hist, leaves, init):
    """A fit card vs CPU: losses within FIT_LOSS_RTOL, each leaf within
    FIT_LEAF_REL of the distance the CPU's fit moved it."""
    loss_gap = max(abs(c - w) / abs(w) for c, w in zip(hist["card"],
                                                       hist["CPU"]))
    gaps = leaf_gaps(leaves["card"], leaves["CPU"], init)
    worst = max(gaps, key=gaps.get)
    log(f"[17] {tag} card vs CPU: losses {hist['card']} vs {hist['CPU']} "
        f"(within {loss_gap:.2e} relative); worst leaf {worst} within "
        f"{gaps[worst]:.2e} of its movement")
    if not all(math.isfinite(x) for x in hist["card"]) or (
            loss_gap > FIT_LOSS_RTOL or gaps[worst] > FIT_LEAF_REL):
        raise AssertionError(f"{tag}: card vs CPU {hist}, {gaps}")


def check_gap(tag, card, cpu):
    rel = max(abs(c - w) / abs(w) for c, w in zip(card, cpu))
    log(f"[17] {tag}: one-step error model {card[0]:.5f}, analytic "
        f"{card[1]:.5f} on the card; CPU {cpu[0]:.5f}, {cpu[1]:.5f} "
        f"(within {rel:.2e} relative)")
    if rel > GAP_RTOL:
        raise AssertionError(f"{tag}: {card} vs {cpu}")


def phase_image_cartpole(device):
    """The image and sequence cartpole card vs CPU -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )
    from apg_trajectory_tracking_tpu_torch.models import image_cartpole as ic
    from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
    from apg_trajectory_tracking_tpu_torch.training import (
        train_image_cartpole as tic,
    )
    from apg_trajectory_tracking_tpu_torch.training.common import (
        shuffled_batches,
    )
    from apg_trajectory_tracking_tpu_torch.training import (
        train_sequence_cartpole as tsc,
    )

    cpu = torch.device("cpu")
    sides = (("card", device), ("CPU", cpu))
    by_path = {}
    g = torch.Generator().manual_seed(17)
    s0, a = tic.draw_rollout_inputs(g, IMAGE_N, IMAGE_T)
    mismatch = cartpole_params(IMAGE_MISMATCH)
    data, secs = {}, {}
    for side, dev in sides:
        data[side], launches, secs[side] = counted(
            lambda: tic.collect_image_rollouts(None, mismatch, states0=s0,
                                               actions=a, device=dev))
        if side == "card":
            check_path_launches("image collection", launches, 0)
            by_path["image_collect"] = launches
    for got, want in zip(data["card"], data["CPU"]):
        torch.testing.assert_close(got.cpu(), want, rtol=IMAGE_TOL,
                                   atol=IMAGE_TOL)
    gap = max(max_errs(got.cpu(), want)[0]
              for got, want in zip(data["card"], data["CPU"]))
    log(f"[17] collect_image_rollouts n = {IMAGE_N}, t = {IMAGE_T}: stacks "
        f"{tuple(data['card'][1].shape)}, card {secs['card']:.3f} s, CPU "
        f"{secs['CPU']:.3f} s; card vs CPU within {gap:.2e}")

    net0 = ic.ImageCartpoleDynamics(tic.IMG_W, tic.IMG_H, generator=g)
    init = net_to_jax(net0)
    n_rows = IMAGE_N * IMAGE_T
    batches = [shuffled_batches(g, n_rows, IMAGE_B)
               for _ in range(IMAGE_EPOCHS)]
    hist, leaves = {}, {}
    for side, dev in sides:
        def fit(epochs=IMAGE_EPOCHS):
            return tic.fit_image_dynamics(
                None, mismatch, epochs=epochs, batch_size=IMAGE_B,
                data=tuple(x.to(dev) for x in data["CPU"]),
                net=ic.image_dynamics_from_jax(init, tic.IMG_W, tic.IMG_H,
                                               device=dev),
                batches=batches, device=dev)

        (net, hist[side], _), launches, secs = counted(fit)
        leaves[side] = net_to_jax(net)
        log(f"[17] fit_image_dynamics on the {side}: {IMAGE_EPOCHS} epochs "
            f"of {n_rows // IMAGE_B} steps at batch {IMAGE_B} in "
            f"{secs:.2f} s; launches {launches}")
        if side == "card":
            check_path_launches("image fit", launches, 0)
            by_path["image_fit"] = launches
            _, _, epoch_s = counted(lambda: fit(1))
            log(f"[17] one more image-fit epoch on the warm card: "
                f"{epoch_s:.3f} s")
    check_fit("image fit", hist, leaves, init)

    gaps = {}
    for side, dev in sides:
        # the CPU's fitted net on both: the gap's own arithmetic
        net = ic.image_dynamics_from_jax(leaves["CPU"], tic.IMG_W, tic.IMG_H,
                                         device=dev)
        gaps[side], launches, _ = counted(lambda: tic.image_dynamics_gap(
            net, mismatch, torch.Generator().manual_seed(3)))
        if side == "card":
            check_path_launches("image gap", launches, 0)
            by_path["image_gap"] = launches
    check_gap("image_dynamics_gap", gaps["card"], gaps["CPU"])

    seq_mismatch = cartpole_params(SEQUENCE_MISMATCH)
    seq_data = tsc.collect_history_rollouts(None, seq_mismatch, states0=s0,
                                            actions=a, device=cpu)
    p0 = tsc.init_sequence_dynamics(g, buffer_length=tsc.BUF)
    seq_init = {k: getattr(p0, k).numpy() for k in ("w1", "b1", "w2")}
    seq_batches = [shuffled_batches(g, n_rows, IMAGE_B)
                   for _ in range(SEQUENCE_EPOCHS)]
    hist, leaves, params = {}, {}, {}
    for side, dev in sides:
        (params[side], hist[side]), launches, secs = counted(
            lambda: tsc.fit_sequence_dynamics(
                None, seq_mismatch, epochs=SEQUENCE_EPOCHS,
                batch_size=IMAGE_B, data=tuple(x.to(dev) for x in seq_data),
                params=p0.to(dev), batches=seq_batches, device=dev))
        leaves[side] = {k: getattr(params[side], k).cpu().numpy()
                        for k in seq_init}
        log(f"[17] fit_sequence_dynamics on the {side}: {SEQUENCE_EPOCHS} "
            f"epochs of {n_rows // IMAGE_B} steps, "
            f"{secs / SEQUENCE_EPOCHS:.4f} s per epoch; launches {launches}")
        if side == "card":
            check_path_launches("sequence fit", launches, 0)
            by_path["sequence_fit"] = launches
    check_fit("sequence fit", hist, leaves, seq_init)
    gaps = {side: tsc.sequence_dynamics_gap(
        params["CPU"].to(dev), seq_mismatch, torch.Generator().manual_seed(4))
        for side, dev in sides}
    check_gap("sequence_dynamics_gap", gaps["card"], gaps["CPU"])

    by_path["image_env"] = phase_image_env(device)
    phase_image_dqn(device)
    return by_path


def phase_image_env(device):
    """make_cartpole_rl(image_obs=True), reset and IMAGE_ENV_STEPS steps
    card vs CPU on the same draws -> its launches."""
    from apg_trajectory_tracking_tpu_torch.baselines import rl_envs
    from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
        cartpole_params,
    )

    g = torch.Generator().manual_seed(5)
    draws = [rl_envs.reset_upright(g, IMAGE_ENV_N)
             for _ in range(IMAGE_ENV_STEPS + 1)]
    actions = [torch.rand((IMAGE_ENV_N, 1), generator=g) * 2 - 1
               for _ in range(IMAGE_ENV_STEPS)]
    frames = {}
    for side, dev in (("card", device), ("CPU", torch.device("cpu"))):
        env = rl_envs.make_cartpole_rl(cartpole_params(), max_steps=3,
                                       image_obs=True, device=dev)

        def run():
            s, obs = env.reset(draws[0])
            out = [obs]
            for act, d in zip(actions, draws[1:]):
                s, obs, rew, _ = env.step(s, act.to(dev), d)
                out += [obs, rew]
            return [x.cpu() for x in out]

        frames[side], launches, secs = counted(run)
        log(f"[17] image env on the {side}: reset and {IMAGE_ENV_STEPS} steps "
            f"of {IMAGE_ENV_N} envs, frames {tuple(frames[side][0].shape)}, "
            f"{secs:.3f} s; launches {launches}")
        if side == "card":
            check_path_launches("image env", launches, 0)
            card_launches = launches
    for got, want in zip(frames["card"], frames["CPU"]):
        torch.testing.assert_close(got, want, rtol=IMAGE_TOL, atol=IMAGE_TOL)
    gap = max(max_errs(got, want)[0]
              for got, want in zip(frames["card"], frames["CPU"]))
    log(f"[17] image env card vs CPU: frames and rewards within {gap:.2e}")
    return card_launches


def phase_image_dqn(device):
    """The DQN net's forward and backward at (DQN_B, 3, 100, 120) on the
    card, the CPU and the CPU in float64, and its card time."""
    from apg_trajectory_tracking_tpu_torch.models import image_cartpole as ic
    from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax

    g = torch.Generator().manual_seed(6)
    net0 = ic.ImageControllerNetDQN(ic.IMG_H, ic.IMG_W, out_size=2,
                                    generator=g)
    x = torch.rand((DQN_B, 3, ic.IMG_H, ic.IMG_W), generator=g)
    cot = torch.randn((DQN_B, 2), generator=g)
    cpu = torch.device("cpu")
    out = {}
    for side, dev, dtype in (("card", device, torch.float32),
                             ("CPU", cpu, torch.float32),
                             ("float64", cpu, torch.float64)):
        net = ic.image_dqn_from_jax(net_to_jax(net0), ic.IMG_H, ic.IMG_W,
                                    device=dev).to(dtype)
        xd, cd = x.to(dev, dtype), cot.to(dev, dtype)

        def fwd_bwd():
            net.zero_grad()
            y = net(xd)
            (y * cd).sum().backward()
            return y

        y = fwd_bwd()
        out[side] = (y.detach().cpu().double(),
                     {k: v.astype(np.float64) for k, v in net_to_jax(
                         net, lambda p: p.grad).items()})
        if side == "card":
            ms = time_cuda(fwd_bwd, runs=20)
    torch.testing.assert_close(out["card"][0], out["CPU"][0], rtol=DQN_TOL,
                               atol=DQN_TOL * out["CPU"][0].abs().max())
    worst = {"card": 0.0, "CPU": 0.0}
    for k, exact in out["float64"][1].items():
        if k in ("['conv1'][1]", "['conv2'][1]", "['conv3'][1]"):
            continue  # a bias before a batch-statistics norm: gradient 0
        scale = np.abs(exact).max()
        err = {side: np.abs(out[side][1][k] - exact).max() / scale
               for side in worst}
        for side in worst:
            worst[side] = max(worst[side], err[side])
        if err["card"] > 2 * err["CPU"] + DQN_TOL:
            raise AssertionError(f"DQN gradient {k}: card {err['card']:.2e}"
                                 f" vs CPU {err['CPU']:.2e} from float64")
    log(f"[17] DQN net (B = {DQN_B}, 3 x 100 x 120) forward + backward: "
        f"{ms:.3f} ms on the card; output card vs CPU within {DQN_TOL}; "
        f"gradients from the float64 reference within {worst['card']:.2e} "
        f"(card) and {worst['CPU']:.2e} (CPU float32) of their largest "
        f"entry")


def phase_deployment(device, tmp):
    """Exports, the native controller, the external loops and the eval
    CLI's --external_sim -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.envs import external_sim as xs
    from apg_trajectory_tracking_tpu_torch.utils import export_controller
    from apg_trajectory_tracking_tpu_torch.utils import native_runtime as nr

    t = time.perf_counter()
    libs = [nr.build_native(lib_name=name)
            for name in ("libapgctrl.so", "libapgsim.so")]
    log(f"[17] native runtime built with g++ in "
        f"{time.perf_counter() - t:.1f} s: {libs}")
    exported = {}
    for asset in DEPLOY_ASSETS:
        out = os.path.join(tmp, f"{asset}.apgc")
        header = export_controller.export_control_net(
            os.path.join(ROOT, "assets", asset), out)
        exported[asset] = out
        log(f"[17] exported assets/{asset}: {header['kind']} "
            f"{header['system']}, {os.path.getsize(out)} bytes")
    by_path = {"native_controller": phase_native_controller(device,
                                                             exported)}
    by_path.update(phase_external_loops(device, xs))
    by_path.update(phase_external_cli(device, xs))
    return by_path


def phase_native_controller(device, exported):
    """Each export's native decisions against the port's net on the card
    on fixed states -> the launches of the native path (none)."""
    from apg_trajectory_tracking_tpu_torch.data.dataset import (
        WING_MEAN,
        WING_STD,
        quad_prepare_data,
        wing_prepare_data,
    )
    from apg_trajectory_tracking_tpu_torch.models.rnn import init_lstm_state
    from apg_trajectory_tracking_tpu_torch.utils import native_runtime as nr
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        load_checkpoint,
        load_config,
        net_from_jax,
    )

    rng = np.random.RandomState(7)
    total = {"quad_rollout_fwd": 0, "quad_rollout_bwd": 0}
    for asset, path in exported.items():
        model = os.path.join(ROOT, "assets", asset)
        cfg = load_config(model)
        net = net_from_jax(load_checkpoint(
            model, "model_" + cfg.get("system", "quad")), device)
        nc = nr.NativeController(path)
        states = (rng.randn(8, 12) * 0.3).astype(np.float32)
        if cfg["system"] == "wing":
            states[:, 3] += 11.5  # level flight

        def both():
            with torch.no_grad():
                s = torch.tensor(states, device=device)
                if nc.kind == "cartpole_net":
                    return (net(s[:, :4]).cpu().numpy(),
                            [nc.cartpole_predict(x[:4]) for x in states])
                if cfg["system"] == "wing":
                    targets = (rng.randn(8, 3) * 4 + [30, 0, 0]).astype(
                        np.float32)
                    normed, _, rel, _ = wing_prepare_data(
                        torch.tensor(states, device=device),
                        torch.tensor(targets, device=device),
                        torch.tensor(cfg.get("mean") or WING_MEAN,
                                     device=device),
                        torch.tensor(cfg.get("std") or WING_STD,
                                     device=device),
                        dt=cfg["delta_t"], horizon=cfg["horizon"])
                    return (torch.sigmoid(net(normed, rel)).cpu().numpy(),
                            [nc.wing_predict(x, y)
                             for x, y in zip(states, targets)])
                refs = (rng.randn(8, nc.window, 9) * 0.3).astype(np.float32)
                in_s, _, in_r, _ = quad_prepare_data(
                    s, torch.tensor(refs, device=device))
                if nc.kind != "lstm_net":
                    return (torch.sigmoid(net(in_s, in_r)).cpu().numpy(),
                            [nc.quad_predict(x, r)
                             for x, r in zip(states, refs)])
                carry, nat, want, got = init_lstm_state(
                    1, net.hidden, device=device), nc.init_carry(), [], []
                for b in range(len(states)):
                    carry, logits = net(carry, in_s[b:b + 1], in_r[b:b + 1])
                    want.append(torch.sigmoid(logits)[0].cpu().numpy())
                    act, nat = nc.lstm_predict(states[b], refs[b], nat)
                    got.append(act)
                return np.stack(want), got

        (want, got), launches, _ = counted(both)
        gap = float(np.abs(np.stack(got) - want).max())
        timing = ""
        if nc.kind == "control_net" and cfg["system"] == "quad":
            window = np.zeros((nc.window, 9), np.float32)
            t = time.perf_counter()
            for _ in range(1000):
                nc.quad_predict(states[0], window)
            timing = (f"; quad_predict {(time.perf_counter() - t) * 1e3:.1f} "
                      f"us per call on the host")
        log(f"[17] native {nc.kind} of assets/{asset} vs the port's net on "
            f"the card, {len(states)} decisions: within {gap:.2e}{timing}; "
            f"launches {launches}")
        check_path_launches(f"native {asset}", launches, 0)
        for k in total:
            total[k] += launches[k]
        if gap > NATIVE_ACT_ATOL:
            raise AssertionError(f"native {asset}: {gap}")
        nc.close()
    return total


def counting_adapter(xs):
    """Wrap ExternalSimAdapter.step with a counter of control steps ->
    (counter dict, restore function)."""
    real = xs.ExternalSimAdapter.step
    steps = {"n": 0}

    def step(self, action01):
        steps["n"] += 1
        return real(self, action01)

    xs.ExternalSimAdapter.step = step
    return steps, lambda: setattr(xs.ExternalSimAdapter, "step", real)


def phase_external_loops(device, xs):
    """evaluate_external with the native and the mock backend on
    EXTERNAL_REFS references, against run_eval on the card; the mock's
    step against the plain twin -> {path: launches}."""
    import functools

    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    refs, ref_len = test_references(EXTERNAL_REFS)
    net, cfg = quad_eval.load_quad_controller(
        os.path.join(ROOT, "assets", "quad_trained"), device=device)
    want, _ = run_eval_counted(quad_eval, net, refs, ref_len)
    by_path = {}
    for sim, factory in (
            ("native", xs.NativeQuadSimBackend),
            ("mock", functools.partial(xs.MockFlightgymBackend,
                                       device=device))):
        predict, _ = quad_eval.external_predict(net, cfg, HORIZON, device)
        steps, restore = counting_adapter(xs)
        try:
            metrics, launches, secs = counted(lambda: xs.evaluate_external(
                predict, factory, refs, ref_len))
        finally:
            restore()
        gap = abs(metrics["mean_divergence"] - want["mean_divergence"])
        log(f"[17] evaluate_external ({sim}) on {EXTERNAL_REFS} references: "
            f"{steps['n']} control steps in {secs:.2f} s, "
            f"{secs / steps['n'] * 1e3:.3f} ms per control step; "
            f"mean_success {metrics['mean_success']} vs run_eval "
            f"{want['mean_success']}, mean_divergence within {gap:.2e}; "
            f"launches {launches}")
        check_path_launches(f"external {sim}", launches,
                            steps["n"] if sim == "mock" else 0)
        by_path[f"external_{sim}"] = launches
        if (metrics["mean_success"] != want["mean_success"]
                or metrics["n"] != want["n"] or gap > EXTERNAL_DIV_ATOL):
            raise AssertionError(f"external {sim}: {metrics} vs {want}")

    # the mock's step (a comparison launch, in no path's count) vs the twin
    params = quad_params(device=device)
    s, a, _ = rollout_inputs(1, 18, device, k=1)
    backend = xs.MockFlightgymBackend(init_state=s[0].cpu().numpy(),
                                      device=device)
    backend.step(xs.action_to_fm(a[0, 0].cpu().numpy()))
    twin = R.quad_rollout_reference(params, s, a, DT)[0, 0].cpu().numpy()
    err = float(np.abs(backend._state - twin).max())
    log(f"[17] the mock's step on the kernel vs the plain twin: within "
        f"{err:.2e}")
    np.testing.assert_allclose(backend._state, twin, rtol=RTOL, atol=ATOL)
    return by_path


def run_eval_counted(quad_eval, net, refs, ref_len):
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params

    (metrics, roll), launches, secs = counted(lambda: quad_eval.run_eval(
        net, quad_params(), refs, ref_len, thresh_div=1.0, thresh_stable=1.0,
        horizon=HORIZON, dt=DT, test_time=True))
    log(f"[17] run_eval on the card on the same references: {secs:.2f} s, "
        f"mean_success {metrics['mean_success']}, mean_divergence "
        f"{metrics['mean_divergence']:.5f}; launches {launches}")
    return metrics, roll


def phase_external_cli(device, xs):
    """The quad eval CLI with --external_sim native and mock on the card
    and with --cpu -> {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval

    argv = ["-m", "assets/quad_trained", "-a", str(EXTERNAL_REFS),
            "--data_dir", os.path.join(ROOT, "data", "traj_data")]
    by_path = {}
    for sim in ("native", "mock"):
        out = {}
        for side, extra in (("card", cpu_flag(device)), ("CPU", ["--cpu"])):
            steps, restore = counting_adapter(xs)
            try:
                (_, text), launches, secs = counted(lambda: captured(
                    lambda: quad_eval.main(argv + ["--external_sim", sim]
                                           + extra), phase=17))
            finally:
                restore()
            lines = text.strip().splitlines()
            out[side] = json.loads(lines[-1])
            log(f"[17] eval CLI --external_sim {sim} on the {side}: "
                f"{secs:.1f} s, {steps['n']} control steps; launches "
                f"{launches}")
            if lines[0] != f"[external sim: {sim}]":
                raise AssertionError(f"eval CLI {sim}: {lines}")
            if side == "card":
                check_path_launches(f"eval CLI {sim}", launches,
                                    steps["n"] if sim == "mock" else 0)
                by_path[f"eval_cli_external_{sim}"] = launches
        card, cpu = out["card"], out["CPU"]
        gap = abs(card["mean_divergence"] - cpu["mean_divergence"])
        log(f"[17] eval CLI --external_sim {sim} card vs CPU: mean_success "
            f"{card['mean_success']} vs {cpu['mean_success']}, "
            f"mean_divergence within {gap:.2e}")
        if (card["mean_success"] != cpu["mean_success"]
                or card["n"] != cpu["n"] or gap > EXTERNAL_DIV_ATOL):
            raise AssertionError(f"eval CLI {sim}: {card} vs {cpu}")
    return by_path


def phase_image_and_deployment(device):
    """Phase 17, leg by leg with its time -> {path: launches}."""
    tmp = os.path.join(ROOT, "trained_models", "chip_smoke_deploy")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    by_path = {}
    for leg, fn in (("image and sequence cartpole",
                     lambda: phase_image_cartpole(device)),
                    ("deployment", lambda: phase_deployment(device, tmp))):
        t = time.perf_counter()
        by_path.update(fn())
        log(f"[time] phase 17 {leg} {time.perf_counter() - t:.1f} s")
    return by_path


DP_EPOCHS = 2
DP_TRACE_STEPS = 3
SMOKE_TIMEOUT = 300
# the multihost smoke's measuring legs, each at 4 steps per epoch: --bench
# on 16384 rows, and --sweep on one cell of the JAX record's 4096 rows (the
# default batch of 8 would take 512 steps per epoch)
DP_BENCH_ARGS = ["--bench", "--nproc", "2", "--backend", "gloo", "--device",
                 "cuda", "--n_rows", "16384", "--batch_size", "4096"]
DP_SWEEP_ARGS = ["--sweep", "--sweep_nproc", "2", "--sweep_rows", "4096",
                 "--time_collectives", "10", "--device", "cuda",
                 "--batch_size", "1024"]
DP_STEPS = 4 * 3  # timed steps per worker in each leg
# the batches those legs give the kernels that B_LIST lacks: the sweep's
# ranks and single process, the bench's ranks (its single process runs
# 4096)
DP_KERNEL_BATCHES = (512, 1024, 2048)


def importable(name):
    """Whether ``name`` imports; a missing optional package is the JAX
    package's own documented fallback, not a failure."""
    try:
        importlib.import_module(name)
    except ImportError:
        return False
    return True


def captured_or_logged(fn):
    """:func:`captured` under [18]; if ``fn`` raises, what it printed is
    logged before the error goes on."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn()
    finally:
        for line in buf.getvalue().splitlines():
            log(f"[18]   | {line}")
    return out, buf.getvalue()


def dp_trainers(device, tmp):
    """The plain TrainQuad and, inside an NCCL process group of one, the
    mesh TrainQuad (with TensorBoard), 2 epochs each with the launch
    counts set to 0 just before and read just after -> (plain, meshed,
    {path: launches})."""
    from apg_trajectory_tracking_tpu_torch.parallel import mesh as M
    from apg_trajectory_tracking_tpu_torch.training.common import load_config
    from apg_trajectory_tracking_tpu_torch.training.train_quad import TrainQuad

    data_dir = os.path.join(ROOT, "data", "traj_data")
    trainers, by_path = {}, {}
    for path in ("dp_plain", "dp_group_of_one"):
        save_name = f"chip_smoke_{path}"
        shutil.rmtree(os.path.join("trained_models", "quad", save_name),
                      ignore_errors=True)
        kw = {}
        if path == "dp_group_of_one":
            M.init_distributed("file://" + os.path.join(tmp, "store"), 1, 0,
                               backend="nccl")
            kw = {"mesh": M.make_mesh(), "tensorboard": True}
            assert kw["mesh"].collective and kw["mesh"].size == 1
        trainer = TrainQuad(load_config("quad"), save_name=save_name,
                            data_dir=data_dir, device=device, **kw)
        reset_launches()
        t0 = time.perf_counter()
        trainer.fit(DP_EPOCHS, verbose=False)
        by_path[path] = launches = read_launches()
        log(f"[18] {path}: {DP_EPOCHS} epochs in "
            f"{time.perf_counter() - t0:.1f} s; steps "
            f"{trainer.steps_taken}; launches {launches}; mesh "
            f"{trainer.mesh}")
        want = launch_counts(**dict.fromkeys(KERNELS, trainer.steps_taken))
        if launches != want or not trainer.steps_taken:
            raise AssertionError(f"[18] {path}: launched {launches} in "
                                 f"{trainer.steps_taken} steps")
        trainers[path] = trainer
    plain, meshed = trainers["dp_plain"], trainers["dp_group_of_one"]
    for key in ("loss", "mean_success", "mean_divergence"):
        if plain.logger.results[key] != meshed.logger.results[key]:
            raise AssertionError(f"[18] {key} differs in a group of one: "
                                 f"{plain.logger.results[key]} vs "
                                 f"{meshed.logger.results[key]}")
    for (name, a), b in zip(plain.net.named_parameters(),
                            meshed.net.parameters()):
        if not torch.equal(a, b):
            raise AssertionError(f"[18] {name} differs in a group of one")
    log(f"[18] group of one: losses {plain.logger.results['loss']} and "
        f"every parameter bit-equal to the plain trainer")
    return plain, meshed, by_path


def dp_trace_and_timing(plain, meshed, tmp):
    """A Chrome trace of DP_TRACE_STEPS mesh train steps, and the step's
    host time with and without the all-reduce -> the numbers."""
    from apg_trajectory_tracking_tpu_torch.parallel import mesh as M
    from apg_trajectory_tracking_tpu_torch.utils import debug

    dyn = meshed.train_dyn
    states, refs = meshed.buffers.states, meshed.buffers.refs
    b = torch.arange(TRAIN_B, device=states.device)
    step = M.make_sharded_train_step(meshed.mesh, meshed._train_step)
    step(dyn, states[b], refs[b])
    torch.cuda.synchronize()
    trace_dir = os.path.join(tmp, "trace")
    with debug.trace(trace_dir):
        for _ in range(DP_TRACE_STEPS):
            step(dyn, states[b], refs[b])
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    counts = {k: sum(k in n for n in names)
              for k in ("quad_rollout_fwd_kernel", "quad_rollout_bwd_kernel")}
    # the collective as issued, and the kernels NCCL launched for it: an
    # in-place sum over one rank needs none
    counts["nccl:all_reduce"] = sum(e.get("name") == "nccl:all_reduce"
                                    for e in events)
    nccl_kernels = sum("nccl" in n.lower() for n in names)
    nccl_names = sorted({str(e.get("name")) for e in events
                         if "nccl" in str(e.get("name", "")).lower()})
    log(f"[18] trace of {DP_TRACE_STEPS} mesh steps: {len(names)} kernels, "
        f"{counts}, NCCL kernels {nccl_kernels}; NCCL-named events "
        f"{nccl_names}")
    for name, n in counts.items():
        if n != DP_TRACE_STEPS:
            raise AssertionError(f"[18] the trace holds {n} {name} in "
                                 f"{DP_TRACE_STEPS} steps")

    def plain_step():
        plain._train_step(plain.train_dyn, states[b], refs[b])

    def mesh_step():
        step(dyn, states[b], refs[b])

    ms = {"plain": [], "all_reduce": []}
    for label, fn in (("plain", plain_step), ("all_reduce", mesh_step),
                      ("all_reduce", mesh_step), ("plain", plain_step)):
        ms[label].append(time_host(fn))
    out = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"[18] train step at B = {TRAIN_B}, median host ms (ABBA): plain "
        f"{ms['plain']}, with the all-reduce {ms['all_reduce']}")
    return {"all_reduce_calls_per_step":
            counts["nccl:all_reduce"] / DP_TRACE_STEPS,
            "nccl_kernels_per_step": nccl_kernels / DP_TRACE_STEPS,
            "step_ms": out["plain"], "step_all_reduce_ms": out["all_reduce"]}


def dp_two_ranks():
    """The multihost smoke: two ranks on the one card through gloo, and
    the sharded run_eval, against one process."""
    from apg_trajectory_tracking_tpu_torch.parallel import multihost_smoke

    t0 = time.perf_counter()
    result, _ = captured_or_logged(lambda: multihost_smoke.main([
        "--nproc", "2", "--device", "cuda", "--backend", "gloo",
        "--eval", "5", "--eval_model",
        os.path.join(ROOT, "assets", "quad_trained"), "--timeout",
        str(SMOKE_TIMEOUT)]))
    log(f"[18] two gloo ranks on the card in {time.perf_counter() - t0:.1f} "
        f"s: loss {result['epoch_loss']!r} (one process "
        f"{result['single_epoch_loss']!r}), checksum "
        f"{result['param_checksum']!r} (one process "
        f"{result['single_param_checksum']!r}); sharded eval max gap "
        f"{result['eval_max_abs_gap']}")
    return result


def check_measuring_leg(tag, record, text, steps):
    """A multihost bench or sweep record and its workers' reports: the
    card named, every time finite and positive, each of the three workers
    (two ranks, one process) one launch of each kernel per timed step ->
    the workers' summed launches."""
    from apg_trajectory_tracking_tpu_torch.parallel import multihost_smoke

    if not record["device"].startswith(torch.cuda.get_device_name(0)):
        raise AssertionError(f"[18] {tag}: device {record['device']!r}")
    rows = record["sweep"] if "sweep" in record else [record]
    for row in rows:
        times = {k: v for k, v in row.items()
                 if k.startswith(("epoch_s_", "allreduce_s", "collective_s",
                                  "rows_per_s", "env_steps_per_s",
                                  "mechanics_"))}
        if not all(math.isfinite(v) and v > 0 for v in times.values()):
            raise AssertionError(f"[18] {tag}: a time is not finite and "
                                 f"positive: {times}")
    reports = multihost_smoke.worker_launches(text)
    if len(reports) != 3 or any(
            r != {"fwd": steps, "bwd": steps, "steps": steps}
            for r in reports):
        raise AssertionError(f"[18] {tag}: worker launches {reports}, "
                             f"expected {steps} of each kernel in each of 3")
    log(f"[18] {tag}: each worker {steps} launches of each kernel in "
        f"{steps} timed steps")
    return {"quad_rollout_fwd": sum(r["fwd"] for r in reports),
            "quad_rollout_bwd": sum(r["bwd"] for r in reports)}


def dp_bench_and_sweep(tmp):
    """The multihost smoke's --bench and --sweep on the card, each leg
    timed, its record printed on a line of its own -> ({"multihost_bench":
    the workers' summed launches}, {leg: record})."""
    from apg_trajectory_tracking_tpu_torch.parallel import multihost_smoke

    published = os.path.join(ROOT, "MULTIHOST_BENCH.json")
    launches = {"quad_rollout_fwd": 0, "quad_rollout_bwd": 0}
    records = {}
    for tag, argv in (("bench", DP_BENCH_ARGS), ("sweep", DP_SWEEP_ARGS)):
        before = tree_digest(published)
        out = os.path.join(tmp, f"multihost_{tag}.json")
        t = time.perf_counter()
        record, text = captured_or_logged(lambda: multihost_smoke.main(
            argv + ["--out", out, "--timeout", str(SMOKE_TIMEOUT)]))
        log(f"[time] phase 18 multihost {tag} {time.perf_counter() - t:.1f}"
            f" s")
        if tree_digest(published) != before:
            raise AssertionError(f"[18] {tag} changed {published}")
        with open(out) as f:
            if json.load(f) != record:
                raise AssertionError(f"[18] {tag}: {out} is not the record")
        log(f"[18] multihost {tag} JSON:")
        print(json.dumps(record), flush=True)
        for name, n in check_measuring_leg(tag, record, text,
                                           DP_STEPS).items():
            launches[name] += n
        records[tag] = record
    return {"multihost_bench": launches}, records


def dp_logging_and_drawing(meshed, tmp):
    """TensorBoard and the performance plot of the mesh trainer, and the
    quad eval CLI's --animate and --live on the card, where the optional
    packages are installed."""
    from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval

    have = {name: importable(name) for name in ("tensorboard", "matplotlib")}
    log(f"[18] importable: {have}")
    files = os.listdir(meshed.save_path)
    if have["tensorboard"]:
        if not any(f.startswith("events.out.tfevents") for f in files):
            raise AssertionError("[18] no TensorBoard events were written")
        log("[18] TensorBoard events written")
    else:
        log("[18] tensorboard absent: the TensorBoard step did not run "
            "(the logger printed its fallback)")
    if not have["matplotlib"]:
        log("[18] matplotlib absent: performance.png, --animate and --live "
            "did not run")
        return
    if "performance.png" not in files:
        raise AssertionError("[18] performance.png was not written")
    gif = os.path.join(tmp, "flight.gif")
    (_, text), launches, secs = counted(lambda: captured_or_logged(
        lambda: quad_eval.main([
            "-m", os.path.join(ROOT, "assets", "quad_trained"), "-a", "1",
            "--speed", "1.0", "--data_dir",
            os.path.join(ROOT, "data", "traj_data"), "--animate", gif,
            "--live", "20"])))
    log(f"[18] quad eval CLI with --animate and --live on the card: "
        f"{secs:.1f} s; launches {launches}")
    if not os.path.isfile(gif) or "live replay: 20 frames" not in text:
        raise AssertionError(f"[18] --animate/--live did not run: {text}")
    log("[18] performance.png, the --animate GIF and a 20-frame --live "
        "replay written on the card's rollout")


def phase_data_parallel(device, smi):
    """Phase 18, leg by leg with its time -> ({path: launches}, numbers)."""
    import torch.distributed as dist

    tmp = os.path.join(ROOT, "trained_models", "chip_smoke_dp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    log(f"[18] {smi}")
    t = time.perf_counter()
    try:
        plain, meshed, by_path = dp_trainers(device, tmp)
        log(f"[time] phase 18 trainers {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        numbers = dp_trace_and_timing(plain, meshed, tmp)
        log(f"[time] phase 18 trace and timing {time.perf_counter() - t:.1f}"
            f" s")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    t = time.perf_counter()
    numbers["two_ranks"] = dp_two_ranks()
    log(f"[time] phase 18 two ranks {time.perf_counter() - t:.1f} s")
    bench_paths, numbers["multihost"] = dp_bench_and_sweep(tmp)
    by_path.update(bench_paths)
    t = time.perf_counter()
    dp_logging_and_drawing(meshed, tmp)
    log(f"[time] phase 18 logging and drawing {time.perf_counter() - t:.1f}"
        f" s")
    log(f"[18] {json.dumps(numbers)}")
    return by_path, numbers


def check_launches_per_step(tag, payload_rows, want):
    """Each (label, launches per step {fwd, bwd}) of a module's report
    against ``want(label) -> expected launches of each kernel``."""
    for label, per_step in payload_rows:
        expected = want(label)
        if per_step != {"fwd": expected, "bwd": expected}:
            raise AssertionError(f"{tag} {label}: {per_step} rollout "
                                 f"launches per step, expected {expected} "
                                 f"of each")


def measured_leg(tag, fn, expected):
    """Run one measuring module with the launch counts set to 0 just
    before and read just after, its JSON on a line of its own ->
    (its payload, {kernel: launches})."""
    reset_launches()
    t = time.perf_counter()
    payload = fn()
    launches = read_launches()
    log(f"[time] phase 19 {tag} {time.perf_counter() - t:.1f} s")
    log(f"[19] {tag} JSON:")
    print(json.dumps(payload), flush=True)
    if launches != launch_counts(**dict.fromkeys(KERNELS, expected)):
        raise AssertionError(f"{tag}: {launches} rollout launches, expected "
                             f"{expected} of each quad kernel")
    log(f"[19] {tag} launches {json.dumps(launches)}")
    return payload, launches


def phase_measuring_modules(device):
    """Phase 19: the four measuring modules on the card, cut in depth ->
    {path: launches}."""
    from apg_trajectory_tracking_tpu_torch.perf import (
        ab,
        latency,
        layout,
        scaling,
    )

    adam_iters = {label: iters for label, solver, _, iters
                  in latency.SOLVER_ROWS if solver == "adam"}
    n = PERF_LATENCY_N
    # the Adam rows: one of each kernel per iteration, over every call
    # (5 warm-up calls, n timed at B = 1, max(n // 10, 10) batched)
    expected = sum(iters * (n + 5 + max(n // 10, 10) + 5)
                   for iters in adam_iters.values())
    by_path = {}
    out, by_path["perf_latency"] = measured_leg(
        "latency", lambda: latency.main(
            ["--n", str(n), "--batch", str(PERF_BATCH), "--swingup_n",
             "1"]), expected)
    check_launches_per_step(
        "latency", [(label.rsplit(" @ ", 1)[0],
                     row["rollout_launches_per_step"])
                    for label, row in out["latency"].items()],
        lambda label: adam_iters.get(label, 0))

    it, rounds, repeats = PERF_AB_ITERS, 3, 2
    # base one launch of each kernel per step, halfsplit two, over the
    # loss check's call and every timed call
    _, by_path["perf_ab"] = measured_leg(
        "ab", lambda: ab.run(PERF_AB_B, it, rounds, repeats, device),
        3 * it * (1 + rounds * repeats))

    it, repeats = PERF_LAYOUT_ITERS, 2
    # the parity step, then per batch one warm and `repeats` timed calls
    _, by_path["perf_layout"] = measured_leg(
        "layout", lambda: layout.main(
            ["--iters", str(it), "--repeats", str(repeats)]),
        1 + len(layout.BATCHES) * it * (1 + repeats))

    it = PERF_SCALING_ITERS
    rows, _ = measured_leg(
        "scaling", lambda: scaling.main(
            ["--per_chip_batch", str(PERF_BATCH_PER_CARD), "--iters",
             str(it)]), 0)
    # the rank's own launches, one of each per step: a warm and 3 timed
    # epochs
    workers = {"quad_rollout_fwd": sum(r["rollout_launches"]["fwd"]
                                       for r in rows.values()),
               "quad_rollout_bwd": sum(r["rollout_launches"]["bwd"]
                                       for r in rows.values())}
    want = sum(d * it * (1 + scaling.TIMED_EPOCHS) for d in rows)
    if workers != {name: want for name in workers}:
        raise AssertionError(f"scaling workers: {workers} rollout launches, "
                             f"expected {want} of each")
    by_path["perf_scaling_workers"] = workers
    return by_path


def check_counts_on_the_host(row, batch):
    """The bench's counts from shapes at ``batch`` on the card against the
    same counts of a step on the host's twin: they must be equal."""
    from apg_trajectory_tracking_tpu_torch import bench
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.perf import ab

    cpu = torch.device("cpu")
    states, refs = ab.inputs(batch, cpu)
    host = bench.count_step(ab.control_net(cpu), quad_params(), states, refs)
    card = (row["flops_per_step"], row["hbm_bytes_per_step"],
            row["min_bytes_per_step"])
    if card != host:
        raise AssertionError(f"bench B={batch}: the card's (flops, bytes, "
                             f"min bytes) {card} differ from the host's "
                             f"{host}")
    log(f"[20] bench B={batch}: counts from shapes equal on card and host")


def phase_headline_bench(device, worst):
    """Phase 20: the headline bench at its defaults, the kernels at its two
    large batches, ``benchmark_rollout``, ``entry()`` and a dry run on an
    NCCL group of one -> ({path: launches}, {batch: kernel rows})."""
    from apg_trajectory_tracking_tpu_torch import bench, entry
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    by_path = {}
    # per batch: the counted steps (2), a warm window and the timed windows
    expected = sum(2 + it * (1 + rep) for it, rep in
                   map(bench.iters_and_repeats, bench.BATCHES))
    reset_launches()
    t = time.perf_counter()
    log("[20] bench JSON:")
    out = bench.main([])
    by_path["bench"] = launches = read_launches()
    conv = read_conv_launches()
    log(f"[time] phase 20 bench {time.perf_counter() - t:.1f} s; conv_ref "
        f"launches {conv}")
    if launches != launch_counts(**dict.fromkeys(KERNELS, expected)):
        raise AssertionError(f"bench: {launches} rollout launches, expected "
                             f"{expected} of each quad kernel")
    if conv != (expected, expected, expected, 0):
        raise AssertionError(f"bench: conv_ref launched {conv}, expected "
                             f"{expected} of each but the input gradient")
    if not out["device_kind"].startswith(torch.cuda.get_device_name(0)):
        raise AssertionError(f"bench: device_kind {out['device_kind']}")
    for batch, row in out["roofline"].items():
        if row["rollout_launches_per_step"] != {"fwd": 1.0, "bwd": 1.0}:
            raise AssertionError(f"bench B={batch}: "
                                 f"{row['rollout_launches_per_step']} "
                                 f"launches per step, expected 1 of each")
        if row.get("mfu") is None or not row["time_per_step_ms"] > 0:
            raise AssertionError(f"bench B={batch}: no time or no roofline "
                                 f"against the card's peaks: {row}")
        log(f"[20] bench B={batch}: {row['time_per_step_ms']} ms per step "
            f"(median {row['median_time_per_step_ms']}), loss "
            f"{row['first_loss']} first, {row['loss']} last, fp32 bound "
            f"share {row['fp32_bound_share']:.3g}")
    check_counts_on_the_host(out["roofline"][str(bench.BATCHES[0])],
                             bench.BATCHES[0])

    t = time.perf_counter()
    params = quad_params(device=device)
    rows = {}
    for n in BENCH_KERNEL_BATCHES:
        check_kernels(params, *rollout_inputs(n, 20 + n, device), worst,
                      f"default B={n} k={HORIZON}")
        rows[n] = kernel_rows(20, params, n, 20 + n, device, plain=True)
    log(f"[time] phase 20 kernels {time.perf_counter() - t:.1f} s")

    reset_launches()
    times = R.benchmark_rollout(batch=ROLLOUT_BENCH_B,
                                iters=ROLLOUT_BENCH_ITERS)
    by_path["benchmark_rollout"] = launches = read_launches()
    want = launch_counts(quad_rollout_fwd=1 + ROLLOUT_BENCH_ITERS)
    if launches != want or sorted(times) != ["cuda", "reference"]:
        raise AssertionError(f"benchmark_rollout: {times}, launches "
                             f"{launches}, expected {want}")
    log(f"[20] benchmark_rollout B={ROLLOUT_BENCH_B}: " + json.dumps(
        {name: s * 1e3 for name, s in times.items()}) + " ms per call")

    reset_launches()
    fn, args = entry.entry()
    with torch.no_grad():
        got = fn(*args)
    by_path["entry"] = launches = read_launches()
    cpu_fn, (cpu_net, states, refs) = entry.entry("cpu")
    with torch.no_grad():
        want_out = cpu_fn(cpu_net, states, refs)
    err = (got.cpu() - want_out).abs().max().item()
    if (launches != launch_counts(quad_rollout_fwd=1)
            or tuple(got.shape) != (8, 12) or not err <= ENTRY_ATOL):
        raise AssertionError(f"entry: shape {tuple(got.shape)}, launches "
                             f"{launches}, card vs CPU {err:.2e}")
    log(f"[20] entry: next state {tuple(got.shape)}, card vs CPU "
        f"{err:.2e}, launches {json.dumps(launches)}")

    t = time.perf_counter()
    reset_launches()
    report = entry.dryrun_multichip(1)
    here = read_launches()
    legs = report["launches"]
    steps = report["epoch_steps"]
    want = {"concurrent": [1, 1], "lstm": [HORIZON, HORIZON],
            "fit": [0, 0], "evaluate": [0, 0], "epoch": [steps, steps]}
    if legs != want or any(here.values()):
        raise AssertionError(f"dry run: rank launches {legs}, expected "
                             f"{want}; the launcher's own {here}")
    by_path["dryrun"] = {name: sum(v[i] for v in legs.values())
                         for i, name in enumerate(KERNELS)}
    log(f"[20] dry run on an NCCL group of one: {json.dumps(report)}")
    log(f"[time] phase 20 dry run {time.perf_counter() - t:.1f} s")
    return by_path, rows


def raw_launchers(lib, n, params, device):
    """The forward and backward C functions of the rollout library ``lib``
    on fresh inputs of batch ``n``, k = 10, checked once against the plain
    versions. They go around the wrappers' checks (``cuda_lib.launch``
    counts them as launches of the port's kernels): these runs only
    compare builds."""
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    scalars = params.kernel_scalars
    s, a, g = rollout_inputs(n, 1, device)
    out = torch.empty(n, HORIZON, 12, device=device)
    ga, gs = torch.empty_like(a), torch.empty_like(s)

    def fwd():
        cuda_lib.launch(lib, "quad_rollout_fwd", device, s.data_ptr(),
                        a.data_ptr(), out.data_ptr(), n, HORIZON, *scalars,
                        DT)

    def bwd():
        cuda_lib.launch(lib, "quad_rollout_bwd", device, s.data_ptr(),
                        a.data_ptr(), out.data_ptr(), g.data_ptr(),
                        ga.data_ptr(), gs.data_ptr(), n, HORIZON, *scalars,
                        DT)

    fwd()
    bwd()
    ga_ref, gs_ref = R.quad_rollout_backward_reference(params, s, a, out, g,
                                                       DT)
    torch.testing.assert_close(
        out, R.quad_rollout_reference(params, s, a, DT), rtol=RTOL,
        atol=ATOL)
    for got, want in ((ga, ga_ref), (gs, gs_ref)):
        torch.testing.assert_close(
            got, want, rtol=RTOL, atol=BWD_ATOL_REL * want.abs().max().item())
    return fwd, bwd


def phase_baseline(device, src):
    """Check the kernels built from ``src`` against the plain versions, then
    time them and the port's own in turns: baseline, port, port,
    baseline."""
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.ops import cuda_lib
    from apg_trajectory_tracking_tpu_torch.ops import rollout as R

    params = quad_params(device=device)
    groups = {}
    for label, name, lib_src in (("baseline", "quad_rollout_baseline", src),
                                 ("port", "quad_rollout", None)):
        lib = cuda_lib.load(name, R._SIGNATURES, lib_src)
        groups[label] = []
        for n in (TRAIN_B, TIMING_B):
            fwd, bwd = raw_launchers(lib, n, params, device)
            groups[label] += [(f"fwd_B{n}", "quad_rollout_fwd_kernel", fwd),
                              (f"bwd_B{n}", "quad_rollout_bwd_kernel", bwd)]
        log(f"[8] {label}: matches the plain versions at B = {TRAIN_B} and "
            f"{TIMING_B}, k = {HORIZON}")
    turns = {label: [] for label in groups}
    for label in ("baseline", "port", "port", "baseline"):
        row = group_device_ms(groups[label])
        turns[label].append(row)
        log(f"[8] {label} turn {len(turns[label])}: kernel device ms "
            + json.dumps(row))
    for label, rows in turns.items():
        log(f"[8] {label} mean of its 2 turns: " + json.dumps(
            {key: float(np.mean([r[key] for r in rows])) for key in rows[0]}))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", metavar="OLD.cu",
                        help="a source with the same C interface, checked "
                             "and timed in turns with the port's kernels")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    baseline = args.baseline and os.path.abspath(args.baseline)
    os.chdir(ROOT)
    t0 = time.perf_counter()

    def done(phase):
        log(f"[time] phase {phase} done at {time.perf_counter() - t0:.1f} s")

    device, smi = phase_device()
    libs = phase_build(baseline)
    done(2)
    worst = phase_kernels(device)
    conv_rows = phase_conv_kernels(device)
    done("3-4")
    phase_carried_weights(device)
    done(5)
    by_path = phase_training(device)
    done(6)
    timings = phase_timing(device, libs["empty_kernel"])
    done(7)
    if baseline:
        phase_baseline(device, baseline)
        done(8)
    phase_cartpole_controllers(device)
    done(9)
    by_path["cartpole"] = phase_cartpole_training(device)
    done(10)
    by_path["flightmare_solve"], label_rows = phase_labelling_solve(device)
    phase_mpc_loops(device)
    phase_ilqr_hover(device)
    phase_swingup_solvers(device)
    done(11)
    by_path["quad_adapt"] = phase_adapt_quad(device)
    by_path.update(phase_adapt_wing_cartpole(device))
    done(12)
    t13 = time.perf_counter()
    by_path.update(phase_ppo(device))
    log(f"[time] phase 13 PPO training legs {time.perf_counter() - t13:.1f} s")
    t = time.perf_counter()
    by_path.update(phase_ppo_fixtures(device))
    log(f"[time] phase 13 PPO fixtures {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    by_path.update(phase_pets(device))
    log(f"[time] phase 13 PETS {time.perf_counter() - t:.1f} s")
    log(f"[time] phase 13 in all {time.perf_counter() - t13:.1f} s")
    done(13)
    t14 = time.perf_counter()
    by_path.update(phase_comparison(device, worst))
    log(f"[time] phase 14 in all {time.perf_counter() - t14:.1f} s")
    done(14)
    t15 = time.perf_counter()
    by_path.update(phase_distillation(device))
    log(f"[time] phase 15 in all {time.perf_counter() - t15:.1f} s")
    done(15)
    t16 = time.perf_counter()
    by_path.update(phase_published_results(device))
    log(f"[time] phase 16 in all {time.perf_counter() - t16:.1f} s")
    done(16)
    t17 = time.perf_counter()
    by_path.update(phase_image_and_deployment(device))
    log(f"[time] phase 17 in all {time.perf_counter() - t17:.1f} s")
    done(17)
    t18 = time.perf_counter()
    dp_paths, dp_numbers = phase_data_parallel(device, smi)
    by_path.update(dp_paths)
    log(f"[time] phase 18 in all {time.perf_counter() - t18:.1f} s")
    done(18)
    t19 = time.perf_counter()
    by_path.update(phase_measuring_modules(device))
    log(f"[time] phase 19 in all {time.perf_counter() - t19:.1f} s")
    done(19)
    t20 = time.perf_counter()
    bench_paths, big_rows = phase_headline_bench(device, worst)
    by_path.update(bench_paths)
    log(f"[time] phase 20 in all {time.perf_counter() - t20:.1f} s")
    done(20)
    kernels = []
    for name in KERNELS:
        rows = timings[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": PALLAS_CALL,
            "launches": by_path["concurrent"][name],
            "max_abs_err": worst[name],
            "ms": rows[(TIMING_B, HORIZON)]["ms"],
            "plain_ms": rows[(TIMING_B, HORIZON)]["plain_ms"],
            "bound_ms": rows[(TIMING_B, HORIZON)]["bound_ms"],
            "bound_by": rows[(TIMING_B, HORIZON)]["bound_by"],
            "library_ms": None,
            "ms_b8": rows[(TRAIN_B, HORIZON)]["ms"],
            "bound_ms_b8": rows[(TRAIN_B, HORIZON)]["bound_ms"],
            "ms_k1": rows[(TIMING_B, 1)]["ms"],
            "bound_ms_k1": rows[(TIMING_B, 1)]["bound_ms"],
            "ms_k1_b8": rows[(TRAIN_B, 1)]["ms"],
            "bound_ms_k1_b8": rows[(TRAIN_B, 1)]["bound_ms"],
            "ms_b8000": label_rows[name]["ms"],
            "bound_ms_b8000": label_rows[name]["bound_ms"],
            **{f"{key}_b{n}": big_rows[n][name][key]
               for n in BENCH_KERNEL_BATCHES
               for key in ("ms", "bound_ms", "plain_ms")},
            "launches_by_path": {path: launches[name]
                                 for path, launches in by_path.items()},
            "data_parallel": {
                "launches_group_of_one": dp_paths["dp_group_of_one"][name],
                "all_reduce_calls_per_step":
                    dp_numbers["all_reduce_calls_per_step"],
                "nccl_kernels_per_step": dp_numbers["nccl_kernels_per_step"],
                "step_ms": dp_numbers["step_ms"],
                "step_all_reduce_ms": dp_numbers["step_all_reduce_ms"],
            },
        })
    for name in WING_KERNELS:
        rows = timings[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": WING_SOURCE,
            "replaces": None,  # the JAX package unrolls the wing with lax
            "launches": by_path["wing"][name],
            "max_abs_err": worst[name],
            **{f"{key}{suffix}": rows[(n, k)][key]
               for n, k, suffix in ((TIMING_B, HORIZON, ""),
                                    (TRAIN_B, HORIZON, "_b8"),
                                    (TIMING_B, 1, "_k1"),
                                    (TRAIN_B, 1, "_k1_b8"))
               for key in ("ms", "plain_ms", "bound_ms", "bound_by")
               if key in rows[(n, k)]},
            "library_ms": None,
            "launches_by_path": {path: launches[name]
                                 for path, launches in by_path.items()
                                 if name in launches},
        })
    for name, rows in conv_rows.items():
        if not rows:
            continue
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": CONV_SOURCE,
            "replaces": None,  # the JAX package leaves the Conv1d to XLA
            **{f"{key}_b{n}": row[key] for n, row in rows.items()
               for key in row},
            "launches_by_path": {
                path: launches["conv_ref"] for path, launches in
                by_path.items() if "conv_ref" in launches},
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
