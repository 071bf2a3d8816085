"""Plotting and 3D animation helpers, host-side matplotlib (counterpart of
the JAX package's ``utils/plotting.py``).

They take host arrays: move a rollout off the card once (``.cpu()``)
before drawing. Saving to a file uses the Agg backend, so they run
headless.
"""

import numpy as np


def _agg():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_loss(losses, save_path):
    plt = _agg()
    plt.figure(figsize=(6, 4))
    plt.plot(losses)
    plt.xlabel("epoch")
    plt.ylabel("loss")
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close()


def plot_success(x, means, stds, save_path):
    """Success-vs-parameter plot of a robustness sweep."""
    plt = _agg()
    means = np.asarray(means, dtype=float)
    stds = np.asarray(stds, dtype=float)
    plt.figure(figsize=(6, 4))
    plt.plot(x, means)
    plt.fill_between(x, means - stds, means + stds, alpha=0.3)
    plt.xlabel("parameter scale")
    plt.ylabel("performance")
    plt.tight_layout()
    plt.savefig(save_path)
    plt.close()


def plot_trajectory_3d(reference, drone_traj, save_path, title=""):
    """Static 3D comparison of reference vs flown trajectory."""
    plt = _agg()
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ref = np.asarray(reference)
    tr = np.asarray(drone_traj)
    ax.plot(ref[:, 0], ref[:, 1], ref[:, 2], "g-", label="reference")
    ax.plot(tr[:, 0], tr[:, 1], tr[:, 2], "b-", label="drone")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(save_path)
    plt.close(fig)


def animate_quad(reference, drone_trajs, savefile=None, interval=50):
    """3D animation of quad flight(s) vs reference.

    Args:
        reference: (T, >=3) reference positions.
        drone_trajs: list of (T, >=3) flown trajectories.
        savefile: mp4/gif path; None shows interactively (needs a display).
    """
    import matplotlib

    if savefile is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    reference = np.asarray(reference)
    drone_trajs = [np.asarray(t) for t in drone_trajs]
    fig = plt.figure(figsize=(8, 7))
    ax = fig.add_subplot(projection="3d")
    ax.plot(reference[:, 0], reference[:, 1], reference[:, 2], "g-",
            alpha=0.5, label="reference")
    lines = [ax.plot([], [], [], "-")[0] for _ in drone_trajs]
    points = [ax.plot([], [], [], "o")[0] for _ in drone_trajs]
    all_pts = np.concatenate([reference[:, :3]] + [t[:, :3] for t in drone_trajs])
    ax.set_xlim(all_pts[:, 0].min(), all_pts[:, 0].max())
    ax.set_ylim(all_pts[:, 1].min(), all_pts[:, 1].max())
    ax.set_zlim(all_pts[:, 2].min(), all_pts[:, 2].max())
    ax.legend()

    def update(i):
        for line, pt, traj in zip(lines, points, drone_trajs):
            j = min(i, len(traj) - 1)
            line.set_data(traj[:j, 0], traj[:j, 1])
            line.set_3d_properties(traj[:j, 2])
            pt.set_data(traj[j:j + 1, 0], traj[j:j + 1, 1])
            pt.set_3d_properties(traj[j:j + 1, 2])
        return lines + points

    n_frames = max(len(t) for t in drone_trajs)
    anim = animation.FuncAnimation(
        fig, update, frames=n_frames, interval=interval, blit=False
    )
    if savefile:
        anim.save(savefile, writer="pillow" if savefile.endswith(".gif")
                  else None)
        plt.close(fig)
    else:  # pragma: no cover
        plt.show()
    return anim


def animate_fixed_wing(target_points, drone_trajs, savefile=None,
                       interval=50):
    """3D animation of wing flight(s) to waypoints."""
    import matplotlib

    if savefile is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    drone_trajs = [np.asarray(t) for t in drone_trajs]
    targets = np.asarray(target_points).reshape(-1, 3)
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(targets[:, 0], targets[:, 1], targets[:, 2], c="r", marker="x",
               s=80, label="targets")
    lines = [ax.plot([], [], [], "-")[0] for _ in drone_trajs]
    all_pts = np.concatenate([targets] + [t[:, :3] for t in drone_trajs])
    ax.set_xlim(all_pts[:, 0].min() - 1, all_pts[:, 0].max() + 1)
    ax.set_ylim(all_pts[:, 1].min() - 1, all_pts[:, 1].max() + 1)
    ax.set_zlim(all_pts[:, 2].min() - 1, all_pts[:, 2].max() + 1)
    ax.legend()

    def update(i):
        for line, traj in zip(lines, drone_trajs):
            j = min(i, len(traj) - 1)
            line.set_data(traj[:j, 0], traj[:j, 1])
            line.set_3d_properties(traj[:j, 2])
        return lines

    n_frames = max(len(t) for t in drone_trajs)
    anim = animation.FuncAnimation(
        fig, update, frames=n_frames, interval=interval, blit=False
    )
    if savefile:
        anim.save(savefile, writer="pillow" if savefile.endswith(".gif")
                  else None)
        plt.close(fig)
    else:  # pragma: no cover
        plt.show()
    return anim


def print_state_ref_div(states, ref_states, precision=3):
    """Debug printout of per-step state vs reference divergence."""
    states = np.asarray(states)
    ref_states = np.asarray(ref_states)
    np.set_printoptions(precision=precision, suppress=True)
    div = np.linalg.norm(states[:, :3] - ref_states[:, :3], axis=1)
    print("position divergence per step:", div)
    print("state[0]:", states[0], "ref[0]:", ref_states[0])
