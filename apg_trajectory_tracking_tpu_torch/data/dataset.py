"""Training buffers and state featurization for the quad and the wing
(counterpart of the JAX package's ``data/dataset.py``).

The buffers hold a sampled segment ``[0:num_sampled]`` and a self-play ring
``[num_sampled:]`` written at a moving cursor, as tensors on the training
device. Unlike the JAX functions, :func:`insert_self_play` and
:func:`replace_sampled` write into the buffer tensors in place (no copy of
the whole buffer per update) and return the buffers with the new cursor.
"""

import dataclasses

import numpy as np
import torch

from apg_trajectory_tracking_tpu_torch.ops.rotations import world_to_body_matrix

# fixed normalization stats of the fixed-wing state
WING_MEAN = np.array(
    [
        0.0, 0.0, 0.0, 11.525899887084961, -0.00016766408225521445,
        0.16617104411125183, 0.007394296582788229, 0.018172707409,
        0.020353179425001144, -0.0005361468647606671,
        0.01662314310669899, 0.004487641621381044,
    ],
    dtype=np.float32,
)
WING_STD = np.array(
    [
        16.626325607299805, 0.8449159860610962, 0.8879243731498718,
        0.6243225932121277, 0.28072822093963623, 0.29176747798,
        0.04499124363064766, 0.10370047390460968, 0.049977313727,
        0.06449887901544571, 0.27508440613746643, 0.05634994804859,
    ],
    dtype=np.float32,
)


def quad_state_features(states):
    """(B, 12) raw states -> (B, 15) features: world velocity (3), the first
    two columns of the world-to-body matrix flattened row-major (6), body
    velocity (3), angular velocity (3)."""
    vel = states[:, 6:9]
    wtb = world_to_body_matrix(states[:, 3:6])
    vel_body = torch.einsum("bij,bj->bi", wtb, vel)
    rot_cols = wtb[:, :, :2].reshape(states.shape[0], 6)
    return torch.cat([vel, rot_cols, vel_body, states[:, 9:12]], dim=1)


def quad_prepare_data(states, ref_states):
    """Featurize a (state, reference window) batch in the drone's frame.

    Args:
        states: (B, 12) raw states.
        ref_states: (B, H, 9) windows [pos, att, vel].
    Returns:
        (in_state (B, 15), current_state (B, 12) with zeroed position,
         in_ref (B, H, 9), rel_ref (B, H, 9)).
    """
    rel_pos = ref_states[:, :, :3] - states[:, None, :3]
    rel_ref = torch.cat([rel_pos, ref_states[:, :, 3:]], dim=2)
    current = torch.cat(
        [torch.zeros_like(states[:, :3]), states[:, 3:]], dim=1
    )
    in_state = quad_state_features(current)
    vel_minus = rel_ref[:, :, 6:9] - states[:, None, 6:9]
    in_ref = torch.cat([rel_pos, rel_ref[:, :, 6:9], vel_minus], dim=2)
    return in_state, current, in_ref, rel_ref


def wing_prepare_data(states, ref_pos, mean, std, dt=0.05, horizon=10):
    """Featurize a (state, target point) batch for the wing controller.

    The normalized state drops the position. The loss target is a ramp
    from the current position toward the unit target direction at 12 m/s
    (``12 * dt`` per step); the net's reference input is the ramp's last
    point relative to the vehicle. The direction's norm is floored at 1e-6,
    so a vehicle on its waypoint gives no NaN.

    Args:
        states: (B, 12) raw wing states.
        ref_pos: (B, 3) absolute target waypoints.
        mean, std: (12,) normalization stats on the states' device.
    Returns:
        (normed_state (B, 9), states (B, 12) unchanged, rel_ref (B, 3),
         target_pos (B, horizon, 3)).
    """
    normed = ((states - mean) / std)[:, 3:]
    rel = ref_pos - states[:, :3]
    direction = rel / torch.clamp(
        torch.linalg.norm(rel, dim=1, keepdim=True), min=1e-6
    )
    steps = torch.arange(1, horizon + 1, dtype=states.dtype,
                         device=states.device) * (12.0 * dt)
    target_pos = (states[:, None, :3]
                  + direction[:, None, :] * steps[None, :, None])
    rel_ref = target_pos[:, -1] - states[:, :3]
    return normed, states, rel_ref, target_pos


@dataclasses.dataclass
class QuadBuffers:
    """``states`` (N, 12), ``refs`` (N, ref_len, 9); rows ``[0:num_sampled]``
    are resampled wholesale, rows ``[num_sampled:]`` form the self-play ring
    written at ``eval_counter``. ``mean``/``std`` are the z-score stats of
    the first sample, carried into checkpoints."""

    states: torch.Tensor
    refs: torch.Tensor
    num_sampled: int
    num_self_play: int
    eval_counter: int
    mean: np.ndarray
    std: np.ndarray


def make_quad_buffers(states, refs, num_sampled, device="cpu"):
    """Buffers from ``full_state_training_data`` output (numpy arrays)."""
    states = np.asarray(states, dtype=np.float32)
    refs = np.asarray(refs, dtype=np.float32)
    return QuadBuffers(
        states=torch.as_tensor(states, device=device),
        refs=torch.as_tensor(refs, device=device),
        num_sampled=int(num_sampled),
        num_self_play=int(states.shape[0] - num_sampled),
        eval_counter=0,
        mean=states.mean(axis=0),
        std=states.std(axis=0),
    )


@dataclasses.dataclass
class WingBuffers:
    """``states`` (N, 12), ``refs`` (N, 3) target waypoints; the same
    sampled segment and self-play ring as :class:`QuadBuffers`, with the
    fixed ``WING_MEAN``/``WING_STD`` as stats."""

    states: torch.Tensor
    refs: torch.Tensor
    num_sampled: int
    num_self_play: int
    eval_counter: int
    mean: np.ndarray
    std: np.ndarray


def make_wing_buffers(states, refs, num_self_play, device="cpu"):
    """Buffers from ``sample_training_data`` output (numpy arrays); the
    last ``num_self_play`` rows form the ring."""
    states = np.asarray(states, dtype=np.float32)
    refs = np.asarray(refs, dtype=np.float32)
    return WingBuffers(
        states=torch.as_tensor(states, device=device),
        refs=torch.as_tensor(refs, device=device),
        num_sampled=int(states.shape[0] - num_self_play),
        num_self_play=int(num_self_play),
        eval_counter=0,
        mean=WING_MEAN,
        std=WING_STD,
    )


def insert_self_play(buffers, states, refs):
    """Write visited (state, ref) pairs into the self-play ring.

    Rows land at ``num_sampled + (eval_counter + i) % num_self_play``; when
    more rows arrive than the ring holds, only the newest ``num_self_play``
    are kept (the end state of sequential ring writes). ``eval_counter``
    grows monotonically; only the write index wraps.
    """
    k = int(states.shape[0])
    nsp = buffers.num_self_play
    if nsp == 0 or k == 0:
        return buffers
    new_counter = buffers.eval_counter + k
    if k > nsp:
        states = states[-nsp:]
        refs = refs[-nsp:]
        start = buffers.eval_counter + (k - nsp)
        k = nsp
    else:
        start = buffers.eval_counter
    pos = buffers.num_sampled + (start + np.arange(k)) % nsp
    pos = torch.as_tensor(pos, device=buffers.states.device)
    buffers.states[pos] = states.to(buffers.states.device)
    buffers.refs[pos] = refs.to(buffers.refs.device)
    return dataclasses.replace(buffers, eval_counter=new_counter)


def replace_sampled(buffers, states, refs):
    """Replace the sampled segment; the self-play ring is untouched."""
    n = buffers.num_sampled
    buffers.states[:n] = torch.as_tensor(
        states[:n], device=buffers.states.device
    )
    buffers.refs[:n] = torch.as_tensor(refs[:n], device=buffers.refs.device)
    return buffers
