"""Image-based cartpole components (counterpart of the JAX package's
``models/image_cartpole.py``):

  * :func:`render_cartpole_image`: a procedural soft raster of the
    cartpole, batched over any leading shape of states, on the states'
    device;
  * :class:`StateToImg`: state -> image generator;
  * :class:`ImageControllerNet`: conv controller over an image-history
    stack;
  * :class:`ImageCartpoleDynamics`: the analytic step plus a conv residual
    over the image stack;
  * :class:`SequenceResidual` with :func:`sequence_dynamics_apply`: the
    analytic step plus an MLP residual over a (state, action) history;
  * :class:`ImageControllerNetDQN`: 3 x (strided conv + batch-statistics
    norm + relu) and a linear head.

Convolutions are NCHW with (O, I, H, W) weights, as the JAX package's
``lax.conv_general_dilated`` with ``("NCHW", "OIHW", "NCHW")``: both are
cross-correlations. Its ``"SAME"`` padding at k = 5 and k = 3 is
``padding=2`` and ``padding=1``. Linear weights are stored (in, out) in the
npz format; each ``*_from_jax`` carries a net's JAX parameters (numpy
arrays under the npz keys) into the port.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import cartpole_step
from apg_trajectory_tracking_tpu_torch.dynamics.learnt import (
    ResidualParams,
    init_residual_params,
    residual_delta,
)
from apg_trajectory_tracking_tpu_torch.models.common import (
    conv2d,
    jax_key,
    linear,
    load_from_jax,
)
from apg_trajectory_tracking_tpu_torch.utils.device import resolve_device

IMG_H, IMG_W = 100, 120


def render_cartpole_image(state, height=IMG_H, width=IMG_W,
                          x_threshold=2.4, pole_len_px=40.0,
                          x_offset_px=0.0):
    """Soft binary image of the cartpole, centered at the cart's x position.

    ``x_offset_px`` (a float, or a tensor of the states' leading shape)
    shifts the cart horizontally: the RL env renders each buffered frame
    displaced relative to the current cart position, so velocity shows in
    frame differences. Edges are sigmoids, so the raster is differentiable.

    Args:
        state: (..., 4) states.
    Returns:
        (..., height, width) in [0, 1].
    """
    device = state.device
    theta = state[..., 2]
    ys = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    offset = torch.as_tensor(x_offset_px, dtype=torch.float32, device=device)
    cx = (width / 2.0 + offset)[..., None, None]  # cart pivot point
    cy = height * 0.75
    sharp = 2.0

    # cart: rectangle around the pivot
    cart = torch.sigmoid(sharp * (12.0 - torch.abs(xs - cx))) * torch.sigmoid(
        sharp * (5.0 - torch.abs(ys - cy - 6.0)))

    # pole: distance of each pixel to the pole segment
    dx = torch.sin(theta)[..., None, None]
    dy = -torch.cos(theta)[..., None, None]
    px = xs - cx
    py = ys - cy
    t = torch.clamp(px * dx + py * dy, 0.0, pole_len_px)
    dist = torch.sqrt((px - t * dx) ** 2 + (py - t * dy) ** 2 + 1e-6)
    pole = torch.sigmoid(sharp * (2.0 - dist))
    return torch.clamp(cart + pole, 0.0, 1.0)


def render_image_stack(states, **kwargs):
    """(T, 4) state history -> (T, H, W) image stack."""
    return render_cartpole_image(states, **kwargs)


def _place(net, device):
    return net.to(resolve_device(device))


# ---------------------------------------------------------------------------
# StateToImg
# ---------------------------------------------------------------------------


class StateToImg(nn.Module):
    def __init__(self, width=IMG_W, height=IMG_H, generator=None):
        super().__init__()
        self.width, self.height = width, height
        self.fc1 = linear(2, 32, generator)
        self.fc2 = linear(32, 128, generator)
        self.fc3 = linear(128, 256, generator)
        self.fc_out = linear(256, width * height, generator)

    def forward(self, x):
        """(B, 2) [x_pos, theta] -> (B, H, W) in [0, 1]."""
        for layer in (self.fc1, self.fc2, self.fc3):
            x = torch.tanh(layer(x))
        x = torch.sigmoid(self.fc_out(x))
        return x.reshape(-1, self.height, self.width)


def state_to_img_from_jax(arrays, width=IMG_W, height=IMG_H, device="cuda"):
    net = StateToImg(width, height)
    return _place(load_from_jax(net, arrays), device)


# ---------------------------------------------------------------------------
# conv helpers
# ---------------------------------------------------------------------------


def _stack_with_diffs(images):
    """Channel stack [images, image differences]: (B, n, H, W) ->
    (B, 2n - 1, H, W)."""
    diffs = images[:, 1:] - images[:, :-1]
    return torch.cat([images, diffs], dim=1)


# ---------------------------------------------------------------------------
# ImageControllerNet
# ---------------------------------------------------------------------------


class ImageControllerNet(nn.Module):
    def __init__(self, img_h, img_w, out_size=1, nr_img=5, generator=None):
        super().__init__()
        flat = 2 * (img_h - 6) * (img_w - 6)
        self.conv1 = conv2d(nr_img * 2 - 1, 10, 5, generator)
        self.conv2 = conv2d(10, 2, 3, generator)
        self.fc1 = linear(flat, 64, generator)
        self.fc2 = linear(64, 64, generator)
        self.fc3 = linear(64, 32, generator)
        self.fc_out = linear(32, out_size, generator)

    def forward(self, images):
        """(B, nr_img, H, W) image history -> (B, out) actions in
        [-1, 1]."""
        x = _stack_with_diffs(images)
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        x = x.reshape(x.shape[0], -1)
        for layer in (self.fc1, self.fc2, self.fc3):
            x = torch.tanh(layer(x))
        return torch.tanh(self.fc_out(x))


def image_controller_from_jax(arrays, img_h, img_w, device="cuda"):
    """The image sizes are not in the shapes (only their product is)."""
    c_in = np.shape(arrays[jax_key("conv1", 0)])[1]
    out_size = np.shape(arrays[jax_key("fc_out", 0)])[1]
    net = ImageControllerNet(img_h, img_w, out_size, (c_in + 1) // 2)
    return _place(load_from_jax(net, arrays), device)


# ---------------------------------------------------------------------------
# ImageCartpoleDynamics
# ---------------------------------------------------------------------------


class ImageCartpoleDynamics(nn.Module):
    def __init__(self, img_w, img_h, nr_img=5, state_size=4, action_dim=1,
                 generator=None):
        super().__init__()
        flat = 10 * img_w * img_h
        self.conv1 = conv2d(nr_img * 2 - 1, 10, 5, generator, padding=2)
        self.conv2 = conv2d(10, 10, 3, generator, padding=1)
        self.linear_act = linear(action_dim, 32, generator)
        self.linear_state_1 = linear(flat + 32, 64, generator)
        # no-bias output layer, near zero at init: the model starts at the
        # analytic one
        self.linear_state_2 = nn.Linear(64, state_size, bias=False)
        with torch.no_grad():
            self.linear_state_2.weight.copy_(
                1e-4 * torch.randn((64, state_size), generator=generator).T)

    def forward(self, dyn_params, state, images, action, dt):
        """f_hat(s, image stack, a) = analytic step + conv residual."""
        new_state = cartpole_step(dyn_params, state, action, dt)
        x = _stack_with_diffs(images)
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        flat = x.reshape(x.shape[0], -1)
        act_enc = torch.relu(self.linear_act(action))
        sa = torch.cat([flat, act_enc], dim=1)
        h = torch.relu(self.linear_state_1(sa))
        return new_state + self.linear_state_2(h)


def image_dynamics_from_jax(arrays, img_w, img_h, device="cuda"):
    """The image sizes are not in the shapes (only their product is)."""
    c_in = np.shape(arrays[jax_key("conv1", 0)])[1]
    action_dim = np.shape(arrays[jax_key("linear_act", 0)])[0]
    state_size = np.shape(arrays[jax_key("linear_state_2", 0)])[1]
    net = ImageCartpoleDynamics(img_w, img_h, (c_in + 1) // 2, state_size,
                                action_dim)
    return _place(load_from_jax(net, arrays), device)


# ---------------------------------------------------------------------------
# SequenceCartpoleDynamics
# ---------------------------------------------------------------------------

# w1 (in, 64) and b1 with a relu, then w2 (64, 4) with no bias: the same
# three tensors as the state residual of dynamics/learnt.py
SequenceResidual = ResidualParams


def init_sequence_dynamics(generator, buffer_length=3, std=1e-4,
                           device="cpu"):
    """Residual over a (state + action) history of ``buffer_length`` steps
    and the action: in = 5 * buffer_length + 1. ``w1`` and ``b1`` fan-in
    uniform, ``w2`` ``std`` times a standard normal, as the JAX package
    draws them."""
    return init_residual_params(generator, 5 * buffer_length, 1,
                                out_state_size=4, std=std, device=device)


def sequence_dynamics_apply(params, dyn_params, state, history, action, dt):
    """f_hat(s, history, a) = analytic step + relu([h; a] W1 + b1) W2."""
    new_state = cartpole_step(dyn_params, state, action, dt)
    return new_state + residual_delta(params, history, action)


def sequence_dynamics_from_jax(w1, b1, w2, device="cuda"):
    """The JAX ``SequenceResidual``'s three arrays -> the port's."""
    device = resolve_device(device)
    return SequenceResidual(*(torch.tensor(np.asarray(a, np.float32),
                                           device=device)
                              for a in (w1, b1, w2)))


# ---------------------------------------------------------------------------
# ImageControllerNetDQN
# ---------------------------------------------------------------------------


class BatchStatNorm2d(nn.Module):
    """Normalization over (N, H, W) per channel with the batch's own mean
    and biased variance, then a per-channel scale and shift: the training
    mode of ``nn.BatchNorm2d``, which is how the DQN net is used.
    ``F.batch_norm`` with ``training=True`` and no running buffers computes
    exactly this (its normalizing variance is the biased one, as
    ``jnp.var``)."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=self.eps)


def _conv_out(size, k=5, s=2):
    return (size - (k - 1) - 1) // s + 1


class ImageControllerNetDQN(nn.Module):
    """3 x (conv k5 s2 + BatchStatNorm2d + relu) -> linear head; channel
    widths 16/32/32."""

    def __init__(self, img_h, img_w, out_size=1, nr_img=3, generator=None):
        super().__init__()
        convw = _conv_out(_conv_out(_conv_out(img_w)))
        convh = _conv_out(_conv_out(_conv_out(img_h)))
        self.conv1 = conv2d(nr_img, 16, 5, generator, stride=2)
        self.bn1 = BatchStatNorm2d(16)
        self.conv2 = conv2d(16, 32, 5, generator, stride=2)
        self.bn2 = BatchStatNorm2d(32)
        self.conv3 = conv2d(32, 32, 5, generator, stride=2)
        self.bn3 = BatchStatNorm2d(32)
        self.head = linear(convw * convh * 32, out_size, generator)

    def forward(self, images):
        """(B, nr_img, H, W) -> (B, out)."""
        x = images
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = torch.relu(bn(conv(x)))
        return self.head(x.reshape(x.shape[0], -1))


def image_dqn_from_jax(arrays, img_h, img_w, device="cuda"):
    nr_img = np.shape(arrays[jax_key("conv1", 0)])[1]
    out_size = np.shape(arrays[jax_key("head", 0)])[1]
    net = ImageControllerNetDQN(img_h, img_w, out_size, nr_img)
    return _place(load_from_jax(net, arrays), device)
