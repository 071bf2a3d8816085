"""Batched closed-loop quadrotor evaluation on reference trajectories
(counterpart of the JAX package's ``evaluation/quad_eval.py``).

All test trajectories roll out in lockstep, one action at a time through
:func:`quad_step` (or the ``dyn_step`` given, a learnt model's step for
instance), in a fixed-length masked loop:

  * divergence > thresh or instability -> at train time the state resets
    onto the reference; at test time the episode is marked done and its
    state frozen;
  * steps past the reference's end (i > ref_len) are masked invalid.

A recurrent controller threads a carry through the loop (``net_apply`` +
``net_carry``) and sees the first ``net_window`` rows of a ``window_len``
window (the recurrent modes carry a 2 * horizon window).

:func:`follow_analytic` flies the analytic references (hover, straight,
circle), whose window is recomputed from the drone's state at each step.
:func:`load_quad_controller` and :func:`eval_kwargs_for` load any shipped
or trained quad checkpoint and set the evaluator up for its mode.

Run the evaluation CLI with::

    python -m apg_trajectory_tracking_tpu_torch.evaluation.quad_eval \
        [-m MODEL|mpc] [-e EPOCH] [-r rand|poly|hover|straight|circle] \
        [-p eight|curve|flat_eight|sinus] [-a N] [--speed S] [--sweep] \
        [--data_dir D] [--mpc_dynamics M] [--solver adam|ilqr] \
        [--mpc_horizon H] [--external_sim native|mock] \
        [--animate FILE.gif] [--live [N]] [--cpu]

``--animate`` saves a 3D animation of the first (up to three) rollouts,
``--live`` replays the first one in the live 2D viewer; both draw on the
host after one ``.cpu()`` of the card's rollout. ``--external_sim`` flies
the rand, poly or waypoint references through an external simulator
(``envs/external_sim.py``): the C++ quad sim or the port's quad step
behind the flightgym conventions, one net call per control step on the
device.
"""

import argparse
import json
import os

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.data.dataset import quad_prepare_data
from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
    quad_is_stable,
    quad_step,
)
from apg_trajectory_tracking_tpu_torch.evaluation.stats import (
    bootstrap_ci,
    wilson_ci,
)
from apg_trajectory_tracking_tpu_torch.models.rnn import (
    init_lstm_state,
    lstm_net_apply,
)
from apg_trajectory_tracking_tpu_torch.parallel.mesh import (
    gather_rows,
    pad_to_multiple,
    shard_batch,
)
from apg_trajectory_tracking_tpu_torch.trajectory.refs import array_ref_window
from apg_trajectory_tracking_tpu_torch.utils.checkpoints import (
    load_checkpoint,
    load_config,
    net_from_jax,
)


def _feedforward_apply(net, carry, in_state, in_ref):
    return carry, net(in_state, in_ref)


@torch.no_grad()
def follow_trajectories(
    net,
    dyn_params,
    references,
    ref_len,
    thresh_div=1.0,
    thresh_stable=1.0,
    horizon=10,
    max_steps=251,
    dt=0.1,
    test_time=False,
    net_apply=_feedforward_apply,
    net_carry=None,
    window_len=None,
    net_window=None,
    dyn_step=quad_step,
    action_transform=torch.sigmoid,
):
    """Roll out the controller on a batch of reference trajectories.

    Args:
        net: the controller on the references' device.
        dyn_params: the params of ``dyn_step`` (QuadParams for
            :func:`quad_step`) on the same device.
        references: (n_test, T, 9) prepared references [pos, att, vel].
        ref_len: usable reference length (the same for all tests).
        net_apply: (net, carry, in_state, in_ref) -> (carry, logits).
        net_carry: the initial carry (None for a feed-forward net).
        window_len: rows of each reference window (horizon by default).
        net_window: rows of it that the net sees (horizon by default).
        dyn_step: (dyn_params, state, action, dt) -> next state, the plant
            (a learnt model's step, for instance).
        action_transform: the net's output -> actions in [0, 1] (a PPO
            actor's clip and rescale, for instance).
    Returns dict with:
        divergences: (n_test, max_steps) distance to the reference point.
        valid: (n_test, max_steps) step-executed mask.
        states: (n_test, max_steps, 12) visited states (for self-play).
        windows: (n_test, max_steps, window_len, 9) matching windows.
    """
    window_len = window_len or horizon
    net_window = net_window or horizon
    n_test, T = references.shape[0], references.shape[1]
    state = torch.zeros((n_test, 12), dtype=torch.float32,
                        device=references.device)
    state[:, :3] = references[:, 0, :3]
    done = torch.zeros(n_test, dtype=torch.bool, device=references.device)

    divs, valid, states, windows = [], [], [], []
    for i in range(max_steps):
        window = array_ref_window(references, i, window_len)
        in_state, _, in_ref, _ = quad_prepare_data(state, window)
        net_carry, logits = net_apply(net, net_carry, in_state,
                                      in_ref[:, :net_window])
        actions = action_transform(logits).reshape(n_test, -1, 4)
        new_state = dyn_step(dyn_params, state, actions[:, 0], dt)

        stable = quad_is_stable(new_state, thresh_stable)
        ref_row = references[:, min(i + 1, T - 1)]
        div = torch.linalg.norm(ref_row[:, :3] - new_state[:, :3], dim=1)
        diverged = (div > thresh_div) | ~stable

        if test_time:
            step_valid = ~done & (i <= ref_len)
            next_state = torch.where(done[:, None], state, new_state)
            done = done | diverged
        else:
            reset_state = torch.cat(
                [ref_row, torch.zeros_like(ref_row[:, :3])], dim=1
            )
            next_state = torch.where(diverged[:, None], reset_state,
                                     new_state)
            step_valid = torch.full_like(done, i <= ref_len)

        divs.append(div)
        valid.append(step_valid)
        states.append(state)
        windows.append(window)
        state = next_state

    return {
        "divergences": torch.stack(divs, dim=1),
        "valid": torch.stack(valid, dim=1),
        "states": torch.stack(states, dim=1),
        "windows": torch.stack(windows, dim=1),
    }


@torch.no_grad()
def follow_analytic(
    net,
    dyn_params,
    ref_window_fn,
    project_fn,
    init_state,
    thresh_div=1.0,
    thresh_stable=1.0,
    dyn_step=quad_step,
    horizon=10,
    max_steps=251,
    dt=0.1,
    net_apply=_feedforward_apply,
    net_carry=None,
):
    """Closed loop on an analytic reference (hover, straight, circle).

    The window is recomputed from the drone's state at each step, and an
    episode ends at its first divergence or instability (test-time
    semantics; there is no reference to reset onto). Unlike
    :func:`follow_trajectories`, every step before the end is valid (no
    ``ref_len``), ``states`` holds the state after each step and the
    actions are always the sigmoid of the net's output. The window
    functions set the window's length: ``horizon`` is accepted and unused,
    as in the JAX package.

    Args:
        ref_window_fn: states (n, 12) -> (n, H, 9) min-jerk windows.
        project_fn: positions (n, 3) -> (n, 3) projections onto the
            reference.
        init_state: (n, 12) initial states on the net's device.
    Returns dict: divergences (n, T), valid (n, T), states (n, T, 12).
    """
    n = init_state.shape[0]
    state = init_state
    done = torch.zeros(n, dtype=torch.bool, device=state.device)
    divs, valid, states = [], [], []
    for _ in range(max_steps):
        window = ref_window_fn(state)
        in_state, _, in_ref, _ = quad_prepare_data(state, window)
        net_carry, logits = net_apply(net, net_carry, in_state, in_ref)
        actions = torch.sigmoid(logits).reshape(n, -1, 4)
        new_state = dyn_step(dyn_params, state, actions[:, 0], dt)
        stable = quad_is_stable(new_state, thresh_stable)
        proj = project_fn(new_state[:, :3])
        div = torch.linalg.norm(proj - new_state[:, :3], dim=1)
        diverged = (div > thresh_div) | ~stable
        valid.append(~done)
        state = torch.where(done[:, None], state, new_state)
        done = done | diverged
        divs.append(div)
        states.append(state)
    return {
        "divergences": torch.stack(divs, dim=1),
        "valid": torch.stack(valid, dim=1),
        "states": torch.stack(states, dim=1),
    }


def run_eval(
    net,
    dyn_params,
    references,
    ref_len,
    thresh_div=1.0,
    thresh_stable=1.0,
    horizon=10,
    max_steps=251,
    dt=0.1,
    test_time=False,
    net_apply=_feedforward_apply,
    net_carry=None,
    window_len=None,
    net_window=None,
    dyn_step=quad_step,
    action_transform=torch.sigmoid,
    mesh=None,
):
    """Closed-loop eval on the net's device -> (metrics dict, rollout dict).

    ``references`` may be a numpy array or a tensor; it, ``dyn_params`` (any
    params object with ``.to``, a LearntDynamics too) and ``net_carry`` are
    moved to the net's device.

    With a ``mesh`` of several ranks the episodes are padded (repeating
    episodes from the start) to a multiple of its size, each rank flies its
    slice of them, the rollouts are gathered on every rank and the pad rows
    cut off before the metrics, so the protocol is unchanged. Each rank
    passes its own ``references``: rank r flies slice r of them.
    """
    device = next(net.parameters()).device
    references = torch.as_tensor(references, dtype=torch.float32,
                                 device=device)
    if net_carry is not None:
        net_carry = tuple(t.to(device) for t in net_carry)
    n_req = references.shape[0]
    sharded = mesh is not None and mesh.size > 1
    if sharded:
        references = shard_batch(
            mesh, pad_to_multiple(references, mesh.size)[0])
        if net_carry is not None:
            net_carry = shard_batch(
                mesh, pad_to_multiple(net_carry, mesh.size)[0])
    roll = follow_trajectories(
        net, dyn_params.to(device), references, ref_len,
        thresh_div=thresh_div, thresh_stable=thresh_stable, horizon=horizon,
        max_steps=max_steps, dt=dt, test_time=test_time, net_apply=net_apply,
        net_carry=net_carry, window_len=window_len, net_window=net_window,
        dyn_step=dyn_step, action_transform=action_transform,
    )
    if sharded:
        roll = {k: gather_rows(mesh, v)[:n_req] for k, v in roll.items()}
    metrics = metrics_from_rollout(
        roll["divergences"].cpu().numpy(), roll["valid"].cpu().numpy(),
        thresh_div, max_steps, ref_len,
    )
    return metrics, roll


def metrics_from_rollout(divs, valid, thresh_div, max_steps, ref_len):
    """The reference's 6-tuple of eval metrics from per-step divergence and
    valid masks (numpy), plus the episode count and 95% CIs (Wilson for
    ratio_stable, seeded bootstrap for mean divergence)."""
    n_steps = valid.sum(axis=1)
    div_mean_per = np.where(
        n_steps > 0, (divs * valid).sum(axis=1) / np.maximum(n_steps, 1), 0.0
    )
    stable_counts = ((divs < thresh_div) & valid).sum(axis=1)
    max_steps_stable = int(min(max_steps, ref_len + 1))
    full = stable_counts == max_steps_stable
    ratio_stable = float(full.mean())
    div_full = div_mean_per[full] if full.any() else div_mean_per

    n = int(len(div_mean_per))
    return {
        "mean_success": float(stable_counts.mean()),
        "std_success": float(stable_counts.std()),
        "mean_divergence_full": float(div_full.mean()),
        "std_divergence_full": float(div_full.std()),
        "mean_divergence": float(div_mean_per.mean()),
        "std_divergence": float(div_mean_per.std()),
        "ratio_stable": ratio_stable,
        "n": n,
        "ratio_stable_ci": list(wilson_ci(int(full.sum()), n)),
        "mean_divergence_ci": list(bootstrap_ci(div_mean_per)),
    }


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------


def resolve_model_dir(model, system):
    """A ``-m`` argument: a directory holding ``config.json`` as it is,
    else a run name under ``trained_models/<system>/``."""
    if os.path.isfile(os.path.join(model, "config.json")):
        return model
    return os.path.join("trained_models", system, model)


def load_quad_controller(model_path, epoch="", device="cuda"):
    """Any quad controller checkpoint (concurrent or autoregressive
    ControlNet, LSTM, wide-window student) -> (net, config); the npz's keys
    and shapes decide the net."""
    cfg = load_config(model_path)
    net = net_from_jax(load_checkpoint(model_path, "model_quad" + epoch),
                       device)
    return net, cfg


def eval_kwargs_for(cfg, nr_test):
    """The :func:`run_eval` keywords of a checkpoint's mode: an LSTM's
    apply and zero carry (cell width ``hidden``, 8 by default), the
    ``window_len`` when ``ref_length`` is not the horizon, and the
    ``net_window`` of a wide-window student."""
    mode = cfg.get("train_mode", "concurrent")
    kwargs = {}
    if mode == "LSTM":
        kwargs["net_apply"] = lstm_net_apply
        kwargs["net_carry"] = init_lstm_state(nr_test,
                                              hidden=cfg.get("hidden", 8))
    ref_length = cfg.get("ref_length", cfg["horizon"])
    if ref_length != cfg["horizon"]:
        kwargs["window_len"] = ref_length
    net_window = cfg.get("net_window", cfg["horizon"])
    if net_window != cfg["horizon"]:
        kwargs["net_window"] = net_window
    return kwargs


def external_predict(net, cfg, horizon, device):
    """The ``--external_sim`` controller -> (predict, reset_fn): ``predict
    (state (12,), window (rows, 9))`` featurizes one step on ``device``,
    runs the net once and returns the first action (4,) in [0, 1] as
    numpy; ``reset_fn`` zeroes an LSTM's carry (None for a feed-forward
    net), called at each trajectory start."""
    net_window = cfg.get("net_window", horizon)
    carry = {}

    def prepared(state, window):
        return quad_prepare_data(
            torch.as_tensor(state[None], device=device),
            torch.as_tensor(window[None], device=device))

    def first_action(logits):
        return torch.sigmoid(logits)[0].cpu().numpy().reshape(-1, 4)[0]

    if cfg.get("train_mode") == "LSTM":
        def reset_fn():
            carry["c"] = init_lstm_state(1, hidden=cfg.get("hidden", 8),
                                         device=device)

        @torch.no_grad()
        def predict(state, window):
            in_s, _, in_r, _ = prepared(state, window)
            carry["c"], logits = lstm_net_apply(net, carry["c"], in_s,
                                                in_r[:, :net_window])
            return first_action(logits)

        reset_fn()
        return predict, reset_fn

    @torch.no_grad()
    def predict(state, window):
        in_s, _, in_r, _ = prepared(state, window)
        return first_action(net(in_s, in_r[:, :net_window]))

    return predict, None


def _external_main(args, net, cfg, references, horizon, dt, device):
    """``--external_sim native|mock``: the closed loop through an external
    simulator backend, one net call per control step on ``device``."""
    import functools

    from apg_trajectory_tracking_tpu_torch.envs.external_sim import (
        MockFlightgymBackend,
        NativeQuadSimBackend,
        evaluate_external,
    )

    backend = (NativeQuadSimBackend if args.external_sim == "native"
               else functools.partial(MockFlightgymBackend, device=device))
    predict, reset_fn = external_predict(net, cfg, horizon, device)
    metrics = evaluate_external(
        predict, backend, references, references.shape[1] - horizon,
        thresh_div=1.0, thresh_stable=1.0, horizon=horizon, dt=dt,
        window_len=cfg.get("ref_length", horizon), reset_fn=reset_fn,
    )
    print(f"[external sim: {args.external_sim}]")
    print("Average tracking error: %.2f (%.2f)"
          % (metrics["mean_divergence"], metrics["std_divergence"]))
    print("Ratio of stable runs: %.2f" % metrics["ratio_stable"])
    print(json.dumps(metrics))


def _mpc_main(args, device):
    """-m mpc: the Adam or iLQR MPC on random test references, one episode
    after the other, the plant ``quad_step``."""
    from apg_trajectory_tracking_tpu_torch.controllers.mpc import MPC
    from apg_trajectory_tracking_tpu_torch.dynamics.quad import quad_params
    from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
        ensure_trajectory_bank,
        load_trajectory_bank,
        prepare_trajectory,
    )

    dt, horizon = 0.1, args.mpc_horizon
    speed = args.speed or 0.4
    mpc_kwargs = {}
    if args.mpc_dynamics == "high_mpc":
        # the quaternion model's own weights track only y and z; weight
        # all of position and velocity to track a bank trajectory
        mpc_kwargs["q_pen"] = [100, 100, 100, 0, 0, 0, 0, 10, 10, 10]
    mpc = MPC(horizon=horizon, dt=dt, dynamics=args.mpc_dynamics,
              solver=args.solver, device=device, **mpc_kwargs)
    bank = load_trajectory_bank(ensure_trajectory_bank(args.data_dir),
                                test=True)
    rng = np.random.RandomState(42)
    dyn = quad_params(device=device)
    divs_all, stable_all = [], []
    for _ in range(args.eval):
        ref = prepare_trajectory(bank[rng.randint(len(bank))], dt, speed)
        ref[:, 2] += 3.0
        mpc.reset()
        state = np.zeros(12, dtype=np.float32)
        state[:3] = ref[0, :3]
        divs = []
        for i in range(min(251, len(ref) - horizon)):
            actions = mpc.predict_actions(state, ref[i + 1:i + 1 + horizon])
            if args.mpc_dynamics == "high_mpc":
                # (thrust m/s^2, body rates rad/s) -> the quad's normalized
                # action; the map is linear and unclipped, so the planned
                # command is flown exactly
                actions = np.concatenate(
                    [(actions[:, :1] - 9.81 + 7.5) / 15.0,
                     actions[:, 1:4] + 0.5], axis=1,
                )
            with torch.no_grad():
                state = quad_step(
                    dyn, torch.as_tensor(state[None], device=device),
                    torch.as_tensor(actions[:1], dtype=torch.float32,
                                    device=device), dt,
                )[0].cpu().numpy()
            div = np.linalg.norm(ref[i + 1, :3] - state[:3])
            divs.append(div)
            if div > 1.0:
                break
        divs_all.append(np.mean(divs))
        stable_all.append(len(divs))
    print("MPC tracking error: %.3f (%.3f), mean steps %.1f"
          % (np.mean(divs_all), np.std(divs_all), np.mean(stable_all)))


def analytic_setup(ref, cfg, n, device, horizon):
    """The CLI's analytic reference ``ref`` (hover, straight or circle),
    started at [0, 0, 3] -> (init_state (n, 12), window_fn, project_fn),
    windows of ``net_window`` rows."""
    from apg_trajectory_tracking_tpu_torch.trajectory import refs as R

    dt = cfg["dt"] if "dt" in cfg else cfg["delta_t"]
    init_state = torch.zeros((n, 12), dtype=torch.float32, device=device)
    init_state[:, 2] = 3.0
    max_dist = cfg.get("max_drone_dist", 0.25)
    win_rows = cfg.get("net_window", horizon)
    start = torch.tensor([0.0, 0.0, 3.0], device=device)
    if ref == "hover":
        def window_fn(s):
            return R.hover_ref_window(start, s, dt, win_rows)

        def project_fn(p):
            return start.expand_as(p)
    elif ref == "straight":
        line = R.straight_init(start,
                               torch.tensor([1.0, 0.3, 0.1], device=device))

        def window_fn(s):
            return R.straight_ref_window(line, s, dt, win_rows, max_dist)

        def project_fn(p):
            return R.straight_project(line, p)
    else:
        circle = R.circle_init(start, torch.tensor([0.0, 1.0, 0.0],
                                                   device=device),
                               radius=2.0, direction=1.0, plane=(0, 1))

        def window_fn(s):
            return R.circle_ref_window(circle, s, dt, win_rows, max_dist,
                                       (0, 1))

        def project_fn(p):
            return R.circle_project(circle, p, (0, 1))
    return init_state, window_fn, project_fn


def _draw(args, references, states, valid, dt):
    """``--animate``: one animation per rollout (up to three), each against
    its own reference; ``--live``: replay the first rollout. Host arrays
    in."""
    if args.animate:
        from apg_trajectory_tracking_tpu_torch.utils.plotting import (
            animate_quad,
        )

        k = min(3, references.shape[0])
        base, ext = os.path.splitext(args.animate)
        for i in range(k):
            out = args.animate if k == 1 else f"{base}_{i}{ext}"
            animate_quad(references[i], [states[i][valid[i]]], savefile=out)
            print(f"animation saved to {out}")
    if args.live is not None and not args.sweep:
        from apg_trajectory_tracking_tpu_torch.utils.live_view import (
            replay_quad,
        )

        n, _ = replay_quad(
            states[0][valid[0]], reference=np.asarray(references[0]), dt=dt,
            max_frames=None if args.live < 0 else args.live,
        )
        print(f"live replay: {n} frames")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Evaluate a quad controller with the PyTorch port (on "
                    "the card unless --cpu).")
    parser.add_argument("-m", "--model", default="test",
                        help="checkpoint dir, run name under "
                             "trained_models/quad/, or mpc")
    parser.add_argument("-e", "--epoch", default="")
    parser.add_argument("-r", "--ref", default="rand",
                        choices=["rand", "poly", "hover", "straight",
                                 "circle"])
    parser.add_argument("-p", "--points", default=None,
                        choices=["eight", "curve", "flat_eight", "sinus"],
                        help="predefined waypoint set")
    parser.add_argument("-a", "--eval", type=int, default=10,
                        help="number of eval runs")
    parser.add_argument("--speed", type=float, default=None)
    parser.add_argument("--sweep", action="store_true",
                        help="robustness sweep over dynamics params")
    parser.add_argument("--data_dir", default="data/traj_data")
    parser.add_argument("--cpu", action="store_true",
                        help="evaluate on the CPU instead of the card")
    parser.add_argument("--mpc_dynamics", default="flightmare",
                        choices=["flightmare", "simple_quad", "high_mpc"],
                        help="internal model for -m mpc")
    parser.add_argument("--solver", default="adam", choices=["adam", "ilqr"],
                        help="OCP solver for -m mpc")
    parser.add_argument("--mpc_horizon", type=int, default=10,
                        help="planning horizon for -m mpc")
    parser.add_argument("--animate", default=None, metavar="FILE.gif",
                        help="save a 3D flight animation of the first "
                             "rollouts (rand/poly/waypoint refs)")
    parser.add_argument("--external_sim", default=None,
                        choices=["native", "mock"],
                        help="fly the closed loop through an external "
                             "simulator: 'native' = the C++ sim "
                             "(native/quad_sim.cc), 'mock' = the port's "
                             "quad step on the device; rand/poly/waypoint "
                             "refs only")
    parser.add_argument("--live", nargs="?", type=int, const=-1,
                        default=None, metavar="N",
                        help="replay the first rollout in the live 2D "
                             "viewer (interactive with a GUI backend, "
                             "offscreen under Agg); optional N caps the "
                             "frames")
    args = parser.parse_args(argv)
    if args.external_sim is not None:
        if args.model == "mpc" or (args.points is None
                                   and args.ref not in ("rand", "poly")):
            raise SystemExit(
                "--external_sim supports neural controllers on rand/poly/"
                "waypoint references (the reference's Flightmare-eval "
                "protocol); analytic refs and -m mpc run on the batched "
                "evaluator")
        if args.sweep or args.animate or args.live is not None:
            raise SystemExit("--external_sim is a plain-eval path "
                             "(no --sweep/--animate/--live)")

    from apg_trajectory_tracking_tpu_torch.dynamics.quad import (
        DEFAULT_QUAD_CFG,
        quad_params,
    )
    from apg_trajectory_tracking_tpu_torch.evaluation.robustness import (
        param_sweep,
    )
    from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.model == "mpc":
        _mpc_main(args, device)
        return

    net, cfg = load_quad_controller(resolve_model_dir(args.model, "quad"),
                                    args.epoch, device)
    speed = args.speed or cfg.get("speed_factor", 0.4)
    dt, horizon = cfg["dt"] if "dt" in cfg else cfg["delta_t"], cfg["horizon"]

    if args.ref in ("rand", "poly") or args.points is not None:
        from apg_trajectory_tracking_tpu_torch.trajectory.generate import (
            ensure_trajectory_bank,
            load_trajectory_bank,
            prepare_trajectory,
        )
        from apg_trajectory_tracking_tpu_torch.trajectory.refs import (
            polynomial_reference,
            waypoint_reference,
        )

        rng = np.random.RandomState(42)

        def stack_cut(ref_list):
            T = min(len(r) for r in ref_list)
            return np.stack([r[:T] for r in ref_list])

        if args.points is not None:
            from apg_trajectory_tracking_tpu_torch.trajectory.predefined import (
                collected_trajectories,
            )

            pts = collected_trajectories[args.points]

            def make_refs():
                return stack_cut([
                    waypoint_reference(rng, pts, [0, 0, 3.0], dt=dt)
                    for _ in range(args.eval)
                ])
        elif args.ref == "poly":
            def make_refs():
                return stack_cut([
                    polynomial_reference(rng, [0, 0, 3.0], dt=dt)
                    for _ in range(args.eval)
                ])
        else:
            bank = load_trajectory_bank(ensure_trajectory_bank(args.data_dir),
                                        test=True)

            def make_refs():
                # distinct trajectories when the bank is big enough
                if args.eval <= len(bank):
                    idx = rng.choice(len(bank), size=args.eval,
                                     replace=False)
                else:
                    idx = rng.randint(len(bank), size=args.eval)
                out = np.stack([prepare_trajectory(bank[i], dt, speed)
                                for i in idx])
                out[:, :, 2] += 3.0
                return out

        if args.external_sim is not None:
            _external_main(args, net, cfg, make_refs(), horizon, dt, device)
            return

        def eval_with(modified_params):
            references = make_refs()
            metrics, roll = run_eval(
                net, quad_params(modified_params), references,
                references.shape[1] - horizon, thresh_div=1.0,
                thresh_stable=1.0, horizon=horizon, dt=dt, test_time=True,
                **eval_kwargs_for(cfg, references.shape[0]),
            )
            if args.animate or (args.live is not None and not args.sweep):
                # one copy to the host, then every drawing reads it
                _draw(args, references, roll["states"].cpu().numpy(),
                      roll["valid"].cpu().numpy(), dt)
            return metrics

        if args.sweep:
            # one eval per parameter value: both numbers from the same
            # rollouts
            def sweep_metrics(mp):
                m = eval_with(mp)
                return {"err": m["mean_divergence"],
                        "stable": m["ratio_stable"]}

            results = param_sweep(sweep_metrics, DEFAULT_QUAD_CFG)
            print(json.dumps(results, indent=1, default=float))
            return
        metrics = eval_with({})
        print("Average tracking error: %.2f (%.2f)"
              % (metrics["mean_divergence"], metrics["std_divergence"]))
        print("Ratio of stable runs: %.2f" % metrics["ratio_stable"])
        print(json.dumps(metrics, default=float))
        return

    n = args.eval
    init_state, window_fn, project_fn = analytic_setup(args.ref, cfg, n,
                                                       device, horizon)
    an_kwargs = {}
    if cfg.get("train_mode") == "LSTM":
        an_kwargs["net_apply"] = lstm_net_apply
        an_kwargs["net_carry"] = init_lstm_state(
            n, hidden=cfg.get("hidden", 8), device=device)
    roll = follow_analytic(
        net, quad_params(device=device), window_fn, project_fn, init_state,
        thresh_div=1.0, thresh_stable=1.0, dt=dt, **an_kwargs,
    )
    divs = roll["divergences"].cpu().numpy()
    valid = roll["valid"].cpu().numpy()
    err = (divs * valid).sum() / max(valid.sum(), 1)
    print(f"{args.ref}: avg divergence {err:.3f}, "
          f"mean steps before divergence "
          f"{valid.sum(axis=1).mean():.1f}")
    if args.live is not None:
        from apg_trajectory_tracking_tpu_torch.utils.live_view import (
            replay_quad,
        )

        states = roll["states"].cpu().numpy()
        n_frames, _ = replay_quad(
            states[0][valid[0]], dt=dt,
            max_frames=None if args.live < 0 else args.live,
        )
        print(f"live replay: {n_frames} frames")


if __name__ == "__main__":
    main()
