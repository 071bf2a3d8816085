"""MPC distillation: supervise a controller net on batched shooting-MPC
solutions, then DAgger on the student's own closed-loop states
(counterpart of the JAX package's ``scripts/distill_mpc.py``,
``scripts/distill_mpc_lstm.py`` and ``scripts/distill_mpc_wing.py``).

  * :func:`distill_quad`: the feed-forward quad student. Sample (state,
    window) pairs from the trajectory bank, label each with the cold-started
    Flightmare solve over the teacher's horizon (:func:`label_quad`),
    regress the net onto the labels in sigmoid space with optax's Adam,
    then DAgger rounds: fly the student, relabel the states it visits, fit
    on the union, keep the best round (optionally with a failure-focused
    harvest, and an APG fine-tune at the end);
  * :func:`distill_quad_lstm`: the recurrent student, trained by teacher
    forcing on whole sequences of the warm-started receding-horizon teacher
    (:func:`teacher_rollout`), then DAgger on its own sequences;
  * :func:`distill_wing`: the fixed-wing student, labelled by the solve on
    ``wing_step`` toward a linear ramp to the target (:func:`teacher_ref`).

Every quad labelling solve unrolls on :func:`quad_rollout`, so on the card
each Adam iteration launches the rollout's forward and backward kernel
once; the teacher rollout does so at every step. The wing's solve, the
imitation fits and the evaluations launch no hand-written kernel.

The quad runs draw everything from one ``np.random.RandomState``, in the
scripts' order: the pairs, every minibatch, each DAgger and failure-focus
draw and the LSTM's evaluation references. The initial net is an input
(the CLI draws it from a seeded ``torch.Generator``). The wing's
evaluation and DAgger targets are inputs too; the CLI draws them from
``torch.Generator`` streams seeded 123 and ``--seed``, the integers of the
JAX script's keys, from the same distribution.

Run it with::

    python -m apg_trajectory_tracking_tpu_torch.training.distill quad \\
        [--n_pairs N] [--steps N] [--dagger_iters N] [--teacher_horizon H] \\
        [--student_window W] [--base_model DIR] [--failure_focus] \\
        [--select err|stable] [--apg_epochs N] [--data_dir D] [--cpu] ...
    python -m apg_trajectory_tracking_tpu_torch.training.distill lstm \\
        [--rollouts N] [--steps N] [--seq_batch N] [--hidden N] ... [--cpu]
    python -m apg_trajectory_tracking_tpu_torch.training.distill wing \\
        [--n_pairs N] [--steps N] [--teacher_horizon H] ... [--cpu]

Checkpoints go to ``trained_models/{quad,wing}/<save_name>/`` in the JAX
package's format, with the scripts' config keys.
"""

import argparse
import copy
import json
import os

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.controllers.mpc import (
    _SPECS,
    _make_solver,
)
from apg_trajectory_tracking_tpu_torch.data.dataset import (
    WING_MEAN,
    WING_STD,
    quad_prepare_data,
    wing_prepare_data,
)
from apg_trajectory_tracking_tpu_torch.dynamics.fixed_wing import (
    wing_params,
    wing_step,
)
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_params,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.envs.quad_env import (
    full_state_training_data,
)
from apg_trajectory_tracking_tpu_torch.evaluation import quad_eval, wing_eval
from apg_trajectory_tracking_tpu_torch.models.common import (
    load_from_jax,
    net_to_jax,
)
from apg_trajectory_tracking_tpu_torch.models.mlp import ControlNet
from apg_trajectory_tracking_tpu_torch.models.rnn import (
    LSTMNet,
    init_lstm_state,
    lstm_net_apply,
)
from apg_trajectory_tracking_tpu_torch.training.common import (
    adam_init,
    adam_step,
)
from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
    ensure_trajectory_bank,
    load_trajectory_bank,
    prepare_trajectory,
)
from apg_trajectory_tracking_tpu_torch.trajectory.refs import array_ref_window
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
    load_checkpoint,
    load_config,
    save_checkpoint,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

QUAD_DT, WING_DT = 0.1, 0.05
# the solve's Adam rate, as in the scripts
SOLVE_LR = 0.1
# the recurrent teacher's episode length (the evaluators' max_steps)
TEACHER_STEPS = 251
LABEL_CLIP = 1e-4


def _logits(u, horizon):
    """The first ``horizon`` planned actions (B, H, 4) clipped to [1e-4,
    1 - 1e-4] -> their logits (B, horizon * 4)."""
    u = torch.clamp(u[:, :horizon], LABEL_CLIP, 1 - LABEL_CLIP)
    return torch.log(u / (1 - u)).reshape(u.shape[0], -1)


def _pad12(windows):
    """(B, H, 9) windows -> (B, H, 12) reference rows, zero rates (a fresh
    tensor, 16-byte aligned for the rollout kernels)."""
    return torch.cat([windows, torch.zeros_like(windows[..., :3])], dim=-1)


def label_quad(solve, dyn, states, windows, th, horizon):
    """Cold-start teacher labels: the first ``th`` rows of each window,
    zero-padded to 12 dims, solved from z = 0 -> (B, horizon * 4) logits
    of the first ``horizon`` planned actions."""
    z = torch.zeros((states.shape[0], th, 4), dtype=torch.float32,
                    device=states.device)
    u, _, _ = solve(dyn, states, _pad12(windows[:, :th]), z)
    return _logits(u, horizon)


def quad_imitation_loss(net, states, windows, target_logits, net_window):
    """Sigmoid-space MSE of the net's actions on the first ``net_window``
    window rows against the teacher's."""
    in_state, _, in_ref, _ = quad_prepare_data(states,
                                               windows[:, :net_window])
    logits = net(in_state, in_ref)
    return torch.mean(
        (torch.sigmoid(logits) - torch.sigmoid(target_logits)) ** 2
    )


def imitation_step(net, opt, lr, loss_fn, *batch):
    """One ``optax.adam(lr)`` step of ``loss_fn(net, *batch)`` on the net,
    in place -> the loss before the step (a 0-dim tensor, no host sync)."""
    loss = loss_fn(net, *batch)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    adam_step(net, grads, opt, lr)
    return loss.detach()


def fit_steps(step, data, rng, steps, batch, every=1000,
              what="imitation loss"):
    """``steps`` minibatch steps on rows of the tensors ``data``, each
    minibatch ``rng.randint(n, size=batch)``; the loss printed every
    ``every`` steps."""
    n = int(data[0].shape[0])
    for i in range(steps):
        idx = torch.as_tensor(rng.randint(n, size=batch),
                              device=data[0].device)
        loss = step(*(d[idx] for d in data))
        if i % every == 0:
            print(f"  step {i}: {what} {float(loss):.5f}", flush=True)


def _metrics_line(m):
    return json.dumps({"err": round(m["mean_divergence"], 4),
                       "stable": m["ratio_stable"]})


def _score_of(select):
    """'stable' ranks by stability first (divergence as tiebreak), 'err' by
    divergence."""
    if select == "stable":
        return lambda m: (-m["ratio_stable"], m["mean_divergence"])
    return lambda m: (m["mean_divergence"],)


def _fold_seed(seed, base_model):
    """A resumed leg draws another stream than its base run: the base
    name folded into the seed."""
    if base_model is None:
        return seed
    return seed + int.from_bytes(base_model.encode(), "little") % 100003


def _bank_refs(bank, idx, dt, speed, device):
    refs = np.stack([prepare_trajectory(bank[i], dt, speed) for i in idx])
    refs[:, :, 2] += 3.0
    return torch.as_tensor(refs, device=device)


def _resume(base_model, net, hidden_default, window, window_flag, hidden):
    """Load ``base_model``'s student into ``net`` after checking the width
    and the window it was trained with."""
    base_dir = quad_eval.resolve_model_dir(base_model, "quad")
    base_cfg = load_config(base_dir)
    if base_cfg.get("hidden", hidden_default) != hidden:
        raise SystemExit(
            f"--base_model was trained with hidden="
            f"{base_cfg.get('hidden', hidden_default)}; pass --hidden to "
            f"match"
        )
    if base_cfg.get("net_window", base_cfg["horizon"]) != window:
        raise SystemExit(
            f"--base_model was trained with net_window="
            f"{base_cfg.get('net_window', base_cfg['horizon'])}; "
            f"pass {window_flag} to match"
        )
    return load_from_jax(net, load_checkpoint(base_dir, "model_quad"))


# ---------------------------------------------------------------------------
# the feed-forward quad student
# ---------------------------------------------------------------------------


def distill_quad(args, net=None, device="cuda"):
    """``scripts/distill_mpc.py``'s run from the parsed ``quad`` flags
    ``args``. ``net`` is the initial ControlNet (15 state features, window
    ``student_window``, ``student_horizon * 4`` outputs, width
    ``hidden``); without one it is drawn from ``torch.Generator(seed)``.
    Returns the best student."""
    device = resolve_device(device)
    horizon, dt = args.student_horizon, QUAD_DT
    rng = np.random.RandomState(_fold_seed(args.seed, args.base_model))
    bank = load_trajectory_bank(ensure_trajectory_bank(args.data_dir))
    bank_test = load_trajectory_bank(args.data_dir, test=True)
    sw = args.student_window or horizon
    th = args.teacher_horizon
    dyn = quad_params(device=device)

    def eval50(net):
        r = np.random.RandomState(42)
        idx = r.choice(len(bank_test), size=min(args.eval, len(bank_test)),
                       replace=False)
        refs = _bank_refs(bank_test, idx, dt, args.speed, device)
        kw = {}
        if sw != horizon:
            kw = {"window_len": sw, "net_window": sw}
        m, _ = quad_eval.run_eval(
            net, dyn, refs, refs.shape[1] - sw, thresh_div=1.0,
            thresh_stable=1.0, horizon=horizon, dt=dt, test_time=True, **kw,
        )
        return m

    # the pairs' windows carry max(th, sw) rows: the teacher solves over
    # the first th, the student sees the first sw
    win_rows = max(th, sw)
    states, windows = full_state_training_data(
        rng, bank, args.n_pairs, ref_length=win_rows, dt=dt,
        speed_factor=args.speed,
    )
    states = torch.as_tensor(states, device=device)
    windows = torch.as_tensor(windows, device=device)

    solve = _make_solver(quad_step, _SPECS["flightmare"].to(device), th, dt,
                         args.mpc_iters, SOLVE_LR)

    def label(s, w):
        return label_quad(solve, dyn, s, w, th, horizon)

    target_logits = label(states, windows)
    print(f"labeled {states.shape[0]} pairs (teacher horizon {th})")

    if net is None:
        net = ControlNet(15, sw, 9, horizon * 4, hidden=args.hidden,
                         generator=torch.Generator().manual_seed(args.seed))
    net = net.to(device)
    opt = adam_init(net)

    def step(s, w, t):
        return imitation_step(net, opt, args.lr, quad_imitation_loss, s, w,
                              t, sw)

    def fit(data, steps):
        fit_steps(step, data, rng, steps, args.batch)

    if args.base_model is not None:
        # resume: the student without the behavior-cloning stage (the
        # fresh teacher pairs still seed the aggregate)
        net = _resume(args.base_model, net, 64, sw, "--student_window",
                      args.hidden)
        opt = adam_init(net)
    else:
        fit([states, windows, target_logits], args.steps)

    save_path = os.path.join("trained_models", "quad", args.save_name)
    student_cfg = {
        "train_mode": "concurrent", "horizon": horizon, "ref_dim": 9,
        "action_dim": 4, "delta_t": dt, "speed_factor": args.speed,
        "hidden": args.hidden, "net_window": sw, "ref_length": sw,
        "distilled_from": "mpc_adam", "mpc_iters": args.mpc_iters,
        "teacher_horizon": th,
    }

    def save_best(best):
        save_checkpoint(save_path, "model_quad", net_to_jax(best),
                        student_cfg)

    score_of = _score_of(args.select)
    m = eval50(net)
    print("cloned:", _metrics_line(m), flush=True)
    best_net, best_score = copy.deepcopy(net), score_of(m)
    save_best(best_net)

    def fly(bank_idx, test_time):
        refs = _bank_refs(bank, bank_idx, dt, args.speed, device)
        return refs, quad_eval.follow_trajectories(
            net, dyn, refs, refs.shape[1] - win_rows, thresh_div=1.0,
            thresh_stable=1.0, horizon=horizon, dt=dt, test_time=test_time,
            window_len=win_rows, net_window=sw,
        )

    all_s, all_w, all_t = [states], [windows], [target_logits]
    for it in range(args.dagger_iters):
        # reset-to-ref rollouts keep the coverage on the trajectories
        idx = rng.choice(len(bank), size=args.dagger_rollouts, replace=False)
        _, roll = fly(idx, test_time=False)
        valid = roll["valid"].reshape(-1).cpu().numpy()
        take = torch.as_tensor(np.where(valid)[0][::2][:args.n_pairs],
                               device=device)
        vs = roll["states"].reshape(-1, 12)[take]
        vw = roll["windows"].reshape(-1, win_rows, 9)[take]
        all_s.append(vs)
        all_w.append(vw)
        all_t.append(label(vs, vw))
        if args.failure_focus:
            fs, fw, n_fail = failure_harvest(
                *fly(rng.choice(len(bank), size=args.dagger_rollouts,
                                replace=False), test_time=True),
                win_rows, args.n_pairs)
            if n_fail:
                ft = label(fs, fw)
                for _ in range(2):  # oversample the failure tail
                    all_s.append(fs)
                    all_w.append(fw)
                    all_t.append(ft)
            print(f"  failure focus: {n_fail}/{args.dagger_rollouts} "
                  f"episodes broke", flush=True)
        data = [torch.cat(all_s), torch.cat(all_w), torch.cat(all_t)]
        fit(data, args.steps // 2)
        m = eval50(net)
        print(f"dagger {it} ({data[0].shape[0]} pairs):", _metrics_line(m),
              flush=True)
        if score_of(m) < best_score:
            best_net, best_score = copy.deepcopy(net), score_of(m)
            save_best(best_net)
    # the checkpoint is the best round, the model only: the distillation's
    # Adam state is not the APG trainer's SGD momentum
    print(f"best round score {tuple(round(s, 4) for s in best_score)}")
    print("saved to", save_path)

    if args.apg_epochs > 0:
        _apg_finetune(args, save_path, device, eval50)
    return best_net


def failure_harvest(refs, froll, win_rows, n_pairs):
    """The states and windows of the episodes of a test-time rollout that
    ended early: a full episode executes steps 0 .. ref_len, ref_len + 1
    valid entries, so anything shorter broke somewhere, the near misses on
    the last steps included -> (states (m, 12), windows (m, win_rows, 9),
    number of broken episodes), at most ``n_pairs`` rows."""
    fvalid = froll["valid"].cpu().numpy()
    failed = fvalid.sum(axis=1) < (refs.shape[1] - win_rows) + 1
    n_fail = int(failed.sum())
    if not n_fail:
        return None, None, 0
    rows = torch.as_tensor(np.where(failed)[0], device=refs.device)
    take = torch.as_tensor(
        np.where(fvalid[failed].reshape(-1))[0][:n_pairs], device=refs.device)
    fs = froll["states"][rows].reshape(-1, 12)[take]
    fw = froll["windows"][rows].reshape(-1, win_rows, 9)[take]
    return fs, fw, n_fail


def _apg_finetune(args, save_path, device, eval50):
    """The ``--apg_epochs`` leg: ``TrainQuad`` from the distilled weights
    without the speed curriculum at thresh_div 1.0, then the evaluation of
    its best restored net."""
    from apg_trajectory_tracking_tpu_torch.training.common import (
        load_config as load_system_config,
    )
    from apg_trajectory_tracking_tpu_torch.training.train_quad import (
        TrainQuad,
    )
    from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
        restore_train_state,
    )

    cfg = load_system_config(
        "quad", dict(nr_epochs=args.apg_epochs, speed_factor=args.speed),
    )
    tr = TrainQuad(
        config=cfg, seed=args.seed, save_name=args.save_name + "_apg",
        data_dir=args.data_dir, curriculum=False, base_model=save_path,
        device=device,
    )
    tr.thresh_div = 1.0
    tr.speed_factor = args.speed
    tr.fit(verbose=False)
    best, _, _ = restore_train_state(tr.save_path, "model_quad", device)
    print("distilled+APG:", _metrics_line(eval50(best)))


# ---------------------------------------------------------------------------
# the recurrent quad student
# ---------------------------------------------------------------------------


@torch.no_grad()
def teacher_rollout(solve, dyn, references, th, dt=QUAD_DT,
                    steps=TEACHER_STEPS):
    """The warm-started receding-horizon teacher flown on ``references``
    (n, T, 9), recording its sequences. Each step solves from the previous
    plan shifted by one step (``z[1:] ++ z[-1:]``), flies the first action
    and resets to the reference where the divergence passes 1 (the
    train-time reset, so the sequences cover the trajectory); a step is
    valid while i <= T - th.

    Returns (states (n, steps, 12), windows (n, steps, th, 9), executed
    actions (n, steps, 4), valid (n, steps))."""
    n, T = references.shape[0], references.shape[1]
    state = torch.zeros((n, 12), dtype=torch.float32,
                        device=references.device)
    state[:, :3] = references[:, 0, :3]
    z = torch.zeros((n, th, 4), dtype=torch.float32, device=state.device)
    ref_len = T - th
    out = {"states": [], "windows": [], "actions": [], "valid": []}
    for i in range(steps):
        window = array_ref_window(references, i, th)
        u, z_new, _ = solve(dyn, state, _pad12(window), z)
        new_state = quad_step(dyn, state, u[:, 0], dt)
        z = torch.cat([z_new[:, 1:], z_new[:, -1:]], dim=1)
        proj = references[:, min(i + 1, T - 1)]
        div = torch.linalg.norm(proj[:, :3] - new_state[:, :3], dim=1)
        reset = torch.cat([proj, torch.zeros_like(proj[:, :3])], dim=1)
        out["states"].append(state)
        out["windows"].append(window)
        out["actions"].append(u[:, 0])
        out["valid"].append(torch.full((n,), i <= ref_len,
                                       device=state.device))
        state = torch.where((div > 1.0)[:, None], reset, new_state)
    return tuple(torch.stack(out[k], dim=1)
                 for k in ("states", "windows", "actions", "valid"))


def label_sequences(solve, dyn, states, windows, th):
    """Cold teacher labels for the (n, T, ...) visited sequences, one
    batched solve over n * T -> the first planned action (n, T, 4)."""
    n, T = states.shape[:2]
    s_flat = states.reshape(-1, 12)
    w_flat = windows.reshape(-1, th, 9)
    z = torch.zeros((n * T, th, 4), dtype=torch.float32,
                    device=states.device)
    u, _, _ = solve(dyn, s_flat, _pad12(w_flat), z)
    return u[:, 0].reshape(n, T, 4)


def lstm_sequence_loss(net, states, windows, actions, valid):
    """Teacher-forced loss over whole sequences: the LSTM scanned over time
    from a zero carry, the squared error of its sigmoid actions summed over
    the 4 actions, averaged over the valid steps."""
    n, T = states.shape[:2]
    carry = init_lstm_state(n, hidden=net.hidden, device=states.device)
    preds = []
    for t in range(T):
        in_state, _, in_ref, _ = quad_prepare_data(states[:, t],
                                                   windows[:, t])
        carry, logits = net(carry, in_state, in_ref)
        preds.append(torch.sigmoid(logits))
    err = torch.sum((torch.stack(preds, dim=1) - actions) ** 2, dim=-1)
    mask = valid.to(torch.float32)
    return torch.sum(err * mask) / torch.clamp(torch.sum(mask), min=1.0)


def distill_quad_lstm(args, net=None, device="cuda"):
    """``scripts/distill_mpc_lstm.py``'s run from the parsed ``lstm`` flags
    ``args``. ``net`` is the initial LSTMNet (window ``teacher_horizon``,
    cell width ``hidden``); without one it is drawn from
    ``torch.Generator(seed)``. Returns the best student."""
    device = resolve_device(device)
    th, dt, horizon = args.teacher_horizon, QUAD_DT, 10
    rng = np.random.RandomState(_fold_seed(args.seed, args.base_model))
    dyn = quad_params(device=device)
    bank = load_trajectory_bank(ensure_trajectory_bank(args.data_dir))
    bank_test = load_trajectory_bank(args.data_dir, test=True)
    solve = _make_solver(quad_step, _SPECS["flightmare"].to(device), th, dt,
                         args.mpc_iters, SOLVE_LR)

    def refs_from(bank_arr, n):
        idx = rng.choice(len(bank_arr), size=n, replace=False)
        return _bank_refs(bank_arr, idx, dt, args.speed, device)

    if net is None:
        net = LSTMNet(15, th, 9, 4, hidden=args.hidden,
                      generator=torch.Generator().manual_seed(args.seed))
    net = net.to(device)
    opt = adam_init(net)

    def step(*seqs):
        return imitation_step(net, opt, args.lr, lstm_sequence_loss, *seqs)

    def fit(data, steps):
        fit_steps(step, data, rng, steps,
                  min(args.seq_batch, int(data[0].shape[0])), every=300,
                  what="loss")

    def lstm_kwargs(n):
        return {"net_apply": lstm_net_apply,
                "net_carry": init_lstm_state(n, hidden=args.hidden,
                                             device=device),
                "window_len": th, "net_window": th}

    def eval_n(net):
        refs = refs_from(bank_test, min(args.eval, len(bank_test)))
        m, _ = quad_eval.run_eval(
            net, dyn, refs, refs.shape[1] - th, thresh_div=1.0,
            thresh_stable=1.0, horizon=horizon, dt=dt, test_time=True,
            **lstm_kwargs(refs.shape[0]),
        )
        return m

    def fly(test_time):
        refs = refs_from(bank, args.dagger_rollouts)
        return refs, quad_eval.follow_trajectories(
            net, dyn, refs, refs.shape[1] - th, thresh_div=1.0,
            thresh_stable=1.0, horizon=horizon, dt=dt, test_time=test_time,
            **lstm_kwargs(refs.shape[0]),
        )

    data = list(teacher_rollout(solve, dyn, refs_from(bank, args.rollouts),
                                th, dt, TEACHER_STEPS))
    print(f"teacher sequences: {tuple(data[0].shape)}", flush=True)
    if args.base_model is not None:
        # resume: the student straight to DAgger (the teacher sequences
        # still seed the aggregate)
        net = _resume(args.base_model, net, 8, th, "--teacher_horizon",
                      args.hidden)
        opt = adam_init(net)
    else:
        fit(data, args.steps)
    m = eval_n(net)
    print("teacher-forced:", _metrics_line(m), flush=True)
    score_of = _score_of(args.select)
    best_net, best_score = copy.deepcopy(net), score_of(m)

    def add(seqs):
        for i, seq in enumerate(seqs):
            data[i] = torch.cat([data[i], seq])

    saved = False
    for it in range(args.dagger_iters):
        _, roll = fly(test_time=False)
        add((roll["states"], roll["windows"],
             label_sequences(solve, dyn, roll["states"], roll["windows"], th),
             roll["valid"]))
        if args.failure_focus:
            frefs, froll = fly(test_time=True)
            fvalid = froll["valid"].cpu().numpy()
            # a full episode is ref_len + 1 valid steps, as in the
            # feed-forward student's harvest
            failed = fvalid.sum(axis=1) < (frefs.shape[1] - th) + 1
            n_fail = int(failed.sum())
            if n_fail:
                rows = torch.as_tensor(np.where(failed)[0], device=device)
                fs, fw = froll["states"][rows], froll["windows"][rows]
                seqs = (fs, fw, label_sequences(solve, dyn, fs, fw, th),
                        froll["valid"][rows])
                for _ in range(2):  # oversample the failure sequences
                    add(seqs)
            print(f"  failure focus: {n_fail}/{args.dagger_rollouts} "
                  f"episodes broke", flush=True)
        fit(data, args.steps // 2)
        m = eval_n(net)
        print(f"dagger {it} ({data[0].shape[0]} seqs):", _metrics_line(m),
              flush=True)
        if score_of(m) < best_score:
            best_net, best_score = copy.deepcopy(net), score_of(m)
            # every improvement is saved: a long run never loses its best
            _save_lstm(best_net, args, horizon, dt, th)
            saved = True
    print(f"best round score {tuple(round(x, 4) for x in best_score)}")
    if not saved:  # no round improved: the (resumed) best, once
        _save_lstm(best_net, args, horizon, dt, th)
    return best_net


def _save_lstm(net, args, horizon, dt, th):
    save_path = os.path.join("trained_models", "quad", args.save_name)
    save_checkpoint(
        save_path, "model_quad", net_to_jax(net),
        {"train_mode": "LSTM", "horizon": horizon, "ref_dim": 9,
         "action_dim": 4, "delta_t": dt, "speed_factor": args.speed,
         "hidden": args.hidden, "net_window": th, "ref_length": th,
         "distilled_from": "mpc_adam_warmstart",
         "teacher_horizon": th},
    )
    print("saved to", save_path)


# ---------------------------------------------------------------------------
# the fixed-wing student
# ---------------------------------------------------------------------------


def teacher_ref(states, targets, th, dt=WING_DT):
    """The wing teacher's reference (``MPC._ref_wing``): ``th`` rows of a
    linear ramp from the position toward the target at the current speed,
    the direction's norm floored at 1e-6 -> (B, th, 12), position slots
    only."""
    pos, vel = states[:, :3], states[:, 3:6]
    vec = targets - pos
    speed = torch.linalg.norm(vel, dim=1, keepdim=True)
    step_vec = vec * (speed * dt / torch.clamp(
        torch.linalg.norm(vec, dim=1, keepdim=True), min=1e-6))
    steps = torch.arange(1, th + 1, dtype=torch.float32,
                         device=states.device)[None, :, None]
    ref = torch.zeros((states.shape[0], th, 12), dtype=torch.float32,
                      device=states.device)
    ref[:, :, :3] = pos[:, None, :] + steps * step_vec[:, None, :]
    return ref


def label_wing(solve, dyn, states, targets, th, horizon, dt=WING_DT):
    """Cold-start teacher labels toward the ramp -> (B, horizon * 4)
    logits."""
    z = torch.zeros((states.shape[0], th, 4), dtype=torch.float32,
                    device=states.device)
    u, _, _ = solve(dyn, states, teacher_ref(states, targets, th, dt), z)
    return _logits(u, horizon)


def wing_imitation_loss(net, states, targets, target_logits, mean, std,
                        dt=WING_DT, horizon=10):
    normed, _, rel_ref, _ = wing_prepare_data(states, targets, mean, std,
                                              dt=dt, horizon=horizon)
    logits = net(normed, rel_ref)
    return torch.mean(
        (torch.sigmoid(logits) - torch.sigmoid(target_logits)) ** 2
    )


def wing_harvest(roll, targets, n_pairs):
    """Every third valid (state, episode target) pair of a train-time
    flight, at most ``n_pairs`` -> (states (m, 12), targets (m, 3))."""
    T = roll["valid"].shape[1]
    valid = roll["valid"].reshape(-1).cpu().numpy()
    take = torch.as_tensor(np.where(valid)[0][::3][:n_pairs],
                           device=targets.device)
    vs = roll["states"].reshape(-1, 12)[take]
    vt = targets[:, None, :].expand(-1, T, -1).reshape(-1, 3)[take]
    return vs, vt


def distill_wing(args, eval_targets, dagger_targets, net=None,
                 device="cuda"):
    """``scripts/distill_mpc_wing.py``'s run from the parsed ``wing`` flags
    ``args``. ``eval_targets`` (n, 3) are the waypoints of every
    evaluation, ``dagger_targets`` one (``dagger_rollouts``, 3) array per
    DAgger round; ``net`` is the initial dense ControlNet, drawn from
    ``torch.Generator(seed)`` without one. The pairs come from
    ``sample_training_data`` on ``RandomState(seed)`` (its flights draw
    their noise from a ``torch.Generator``). Returns the best student."""
    from apg_trajectory_tracking_tpu_torch.envs.wing_env import (
        sample_training_data,
    )

    device = resolve_device(device)
    horizon, dt, th = 10, WING_DT, args.teacher_horizon
    rng = np.random.RandomState(args.seed)
    dyn = wing_params({}, device)
    mean = torch.as_tensor(WING_MEAN, device=device)
    std = torch.as_tensor(WING_STD, device=device)

    def eval_n(net):
        m, _, _ = wing_eval.run_eval(net, dyn, eval_targets, mean, std,
                                     horizon=horizon, dt=dt, test_time=True)
        return m

    solve = _make_solver(wing_step, _SPECS["fixed_wing_3D"].to(device), th,
                         dt, args.mpc_iters, SOLVE_LR)

    def label(s, tg):
        return label_wing(solve, dyn, s, tg, th, horizon, dt)

    states, targets = sample_training_data(rng, args.n_pairs, dt=dt,
                                           params=dyn)
    states = torch.as_tensor(states, device=device)
    targets = torch.as_tensor(targets, device=device)
    target_logits = label(states, targets)
    print(f"labeled {states.shape[0]} pairs (teacher horizon {th})")

    if net is None:
        net = ControlNet(9, 1, 3, horizon * 4, conv=False,
                         generator=torch.Generator().manual_seed(args.seed))
    net = net.to(device)
    opt = adam_init(net)

    def step(s, tg, t):
        return imitation_step(net, opt, args.lr, wing_imitation_loss, s, tg,
                              t, mean, std, dt, horizon)

    def fit(data, steps):
        fit_steps(step, data, rng, steps, args.batch)

    fit([states, targets, target_logits], args.steps)
    m = eval_n(net)
    print("cloned:", json.dumps({"err": round(m["mean_success"], 5)}),
          flush=True)
    best_net, best_err = copy.deepcopy(net), m["mean_success"]

    all_s, all_t, all_l = [states], [targets], [target_logits]
    for it in range(args.dagger_iters):
        _, roll, ep_targets = wing_eval.run_eval(
            net, dyn, dagger_targets[it], mean, std, horizon=horizon, dt=dt,
            test_time=False,
        )
        vs, vt = wing_harvest(roll, ep_targets, args.n_pairs)
        all_s.append(vs)
        all_t.append(vt)
        all_l.append(label(vs, vt))
        data = [torch.cat(all_s), torch.cat(all_t), torch.cat(all_l)]
        fit(data, args.steps // 2)
        m = eval_n(net)
        print(f"dagger {it} ({data[0].shape[0]} pairs):",
              json.dumps({"err": round(m["mean_success"], 5)}), flush=True)
        if m["mean_success"] < best_err:
            best_net, best_err = copy.deepcopy(net), m["mean_success"]
    print(f"best err {best_err:.5f}")

    save_path = os.path.join("trained_models", "wing", args.save_name)
    save_checkpoint(
        save_path, "model_wing", net_to_jax(best_net),
        {"state_size": 12, "horizon": horizon, "ref_dim": 3,
         "action_dim": 4, "delta_t": dt, "distilled_from": "mpc_adam",
         "teacher_horizon": th, "mpc_iters": args.mpc_iters,
         "mean": WING_MEAN.tolist(), "std": WING_STD.tolist()},
    )
    print("saved to", save_path)
    return best_net


def wing_cli_targets(args):
    """The CLI's wing draws: the evaluation targets from
    ``torch.Generator(123)`` and each DAgger round's from one
    ``torch.Generator(seed)`` stream."""
    eval_targets = wing_eval.draw_targets(torch.Generator().manual_seed(123),
                                          args.eval)
    gen = torch.Generator().manual_seed(args.seed)
    return eval_targets, [wing_eval.draw_targets(gen, args.dagger_rollouts)
                          for _ in range(args.dagger_iters)]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="MPC distillation with the PyTorch port (on the card "
                    "unless --cpu)."
    )
    sub = parser.add_subparsers(dest="student", required=True)

    quad = sub.add_parser("quad", help="the feed-forward quad student "
                                       "(scripts/distill_mpc.py)")
    quad.add_argument("--n_pairs", type=int, default=8000)
    quad.add_argument("--speed", type=float, default=0.4)
    quad.add_argument("--steps", type=int, default=4000,
                      help="supervised Adam steps")
    quad.add_argument("--batch", type=int, default=256)
    quad.add_argument("--lr", type=float, default=1e-3)
    quad.add_argument("--dagger_iters", type=int, default=3)
    quad.add_argument("--dagger_rollouts", type=int, default=20,
                      help="student rollouts per DAgger round")
    quad.add_argument("--apg_epochs", type=int, default=0,
                      help="APG fine-tune epochs after distillation")
    quad.add_argument("--eval", type=int, default=50)
    quad.add_argument("-s", "--save_name", default="mpc_distilled")
    quad.add_argument("--data_dir", default="data/traj_data_full")
    quad.add_argument("--mpc_iters", type=int, default=50)
    quad.add_argument("--teacher_horizon", type=int, default=10,
                      help="the teacher's planning horizon (the student "
                           "still emits student_horizon actions)")
    quad.add_argument("--hidden", type=int, default=64,
                      help="student width (64 = reference architecture)")
    quad.add_argument("--student_horizon", type=int, default=10,
                      help="actions the student emits per query (only the "
                           "first executes closed-loop)")
    quad.add_argument("--student_window", type=int, default=None,
                      help="reference rows the student sees (default 10; "
                           "= teacher_horizon makes a long-horizon teacher "
                           "realizable)")
    quad.add_argument("--base_model", default=None,
                      help="resume the DAgger loop from a saved student "
                           "(dir under trained_models/quad)")
    quad.add_argument("--failure_focus", action="store_true",
                      help="each DAgger round also flies the student under "
                           "test-time break semantics and oversamples (x2) "
                           "the states leading up to each break")
    quad.add_argument("--select", default="err", choices=["err", "stable"],
                      help="round selection: best mean divergence, or best "
                           "(stable ratio, then divergence)")
    quad.add_argument("--seed", type=int, default=0)
    quad.add_argument("--cpu", action="store_true",
                      help="run on the CPU instead of the card")

    lstm = sub.add_parser("lstm", help="the recurrent quad student "
                                       "(scripts/distill_mpc_lstm.py)")
    lstm.add_argument("--teacher_horizon", type=int, default=20)
    lstm.add_argument("--mpc_iters", type=int, default=100)
    lstm.add_argument("--rollouts", type=int, default=30,
                      help="teacher rollouts for the initial dataset")
    lstm.add_argument("--dagger_iters", type=int, default=4)
    lstm.add_argument("--dagger_rollouts", type=int, default=20)
    lstm.add_argument("--steps", type=int, default=1500,
                      help="minibatch gradient steps per fit stage")
    lstm.add_argument("--seq_batch", type=int, default=32,
                      help="sequences per minibatch")
    lstm.add_argument("--lr", type=float, default=1e-3)
    lstm.add_argument("--hidden", type=int, default=64)
    lstm.add_argument("--speed", type=float, default=0.4)
    lstm.add_argument("--eval", type=int, default=50)
    lstm.add_argument("-s", "--save_name", default="mpc_distilled_lstm")
    lstm.add_argument("--data_dir", default="data/traj_data_full")
    lstm.add_argument("--seed", type=int, default=0)
    lstm.add_argument("--base_model", default=None,
                      help="resume the DAgger loop from a saved student "
                           "(dir under trained_models/quad)")
    lstm.add_argument("--failure_focus", action="store_true",
                      help="each DAgger round also flies the student under "
                           "test-time break semantics and oversamples (x2) "
                           "the sequences of episodes that break")
    lstm.add_argument("--select", default="err", choices=["err", "stable"],
                      help="round selection: best divergence, or best "
                           "(stable ratio, then divergence)")
    lstm.add_argument("--cpu", action="store_true",
                      help="run on the CPU instead of the card")

    wing = sub.add_parser("wing", help="the fixed-wing student "
                                       "(scripts/distill_mpc_wing.py)")
    wing.add_argument("--n_pairs", type=int, default=6000)
    wing.add_argument("--steps", type=int, default=4000)
    wing.add_argument("--batch", type=int, default=256)
    wing.add_argument("--lr", type=float, default=1e-3)
    wing.add_argument("--dagger_iters", type=int, default=4)
    wing.add_argument("--dagger_rollouts", type=int, default=20)
    wing.add_argument("--teacher_horizon", type=int, default=20)
    wing.add_argument("--mpc_iters", type=int, default=100)
    wing.add_argument("--eval", type=int, default=20)
    wing.add_argument("-s", "--save_name", default="wing_mpc_distilled")
    wing.add_argument("--seed", type=int, default=0)
    wing.add_argument("--cpu", action="store_true",
                      help="run on the CPU instead of the card")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.student == "quad":
        distill_quad(args, device=device)
    elif args.student == "lstm":
        distill_quad_lstm(args, device=device)
    else:
        distill_wing(args, *wing_cli_targets(args), device=device)


if __name__ == "__main__":
    main()
