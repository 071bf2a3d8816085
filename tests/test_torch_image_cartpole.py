"""The port's image and sequence cartpole against the JAX package on the CPU:
the renderer, the five nets and the residual MLP controller, the rollout
collections, two fit epochs of each residual, the one-step gaps and the
image observations of the cartpole RL env.

The JAX package is imported inside the tests (the ``J`` fixture), so this
file also collects on a machine with a card and no JAX; there the card
tests run with ``python -m pytest --noconftest
tests/test_torch_image_cartpole.py -m cuda``.

Both sides take the same inputs: fixed numpy arrays, JAX's initial
parameters carried across, and JAX's draws (start states, actions,
minibatch indices, env resets) fed to the port. Tolerances:
  * renders: 1e-5 absolute (values in [0, 1]);
  * each net's forward and the gradient of a fixed projection of it with
    respect to every parameter: rtol 1e-5, atol 1e-5 (of the largest entry
    of the gradient, for the gradients); the DQN's conv biases, whose exact
    gradient is 0 (a batch-statistics norm follows them), within 1e-5 of
    their weight's largest gradient on both sides;
  * the rollout collections: states and images 1e-5;
  * the fits: one Adam step of the image residual and two epochs of the
    sequence residual, the per-epoch losses rtol 1e-5 and every weight
    within 1e-5 absolute (1/300 of Adam's step at lr 3e-3); two epochs of
    the image residual, the losses rtol 1e-3 and each leaf's gap within 2%
    (in norm) of the distance JAX's fit moved it: Adam turns float roundoff
    in a near-zero gradient entry of the conv layers into a whole step of
    either sign (measured: up to 2e-4 in the losses, 1% in the norm);
  * the one-step gaps: rtol 1e-5;
  * the image env's observations and rewards: 1e-5.
On the card (``cuda`` marker): the image collection, two fit epochs and
the image env against the CPU, with no rollout kernel launched.
"""

import types

import numpy as np
import pytest
import torch

from apg_trajectory_tracking_tpu_torch.baselines import rl_envs
from apg_trajectory_tracking_tpu_torch.dynamics.cartpole import (
    cartpole_params,
)
from apg_trajectory_tracking_tpu_torch.models import image_cartpole as ic
from apg_trajectory_tracking_tpu_torch.models import resnet_from_jax
from apg_trajectory_tracking_tpu_torch.models.common import net_to_jax
from apg_trajectory_tracking_tpu_torch.ops import rollout as R
from apg_trajectory_tracking_tpu_torch.training import (
    train_image_cartpole as tic,
)
from apg_trajectory_tracking_tpu_torch.training import (
    train_sequence_cartpole as tsc,
)

IMG_ATOL = 1e-5
NET_RTOL, NET_ATOL = 1e-5, 1e-5
FIT_RTOL, FIT_ATOL = 1e-5, 1e-5
IMAGE_FIT_LOSS_RTOL, IMAGE_FIT_REL = 1e-3, 2e-2
ENV_TOL = 1e-5
DT = 0.05
MISMATCH = {"length": 0.8, "wind": 0.3}
# a small fit: 4 rollouts of 8 steps, batches of 8
FIT_N, FIT_T, FIT_B = 4, 8, 8
CPU = "cpu"


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules."""
    import jax
    import jax.numpy as jnp

    from apg_trajectory_tracking_tpu.baselines import rl_envs as jenvs
    from apg_trajectory_tracking_tpu.dynamics import cartpole
    from apg_trajectory_tracking_tpu.envs import cartpole_env
    from apg_trajectory_tracking_tpu.models import image_cartpole, resnet
    from apg_trajectory_tracking_tpu.training import (
        common,
        train_image_cartpole,
        train_sequence_cartpole,
    )

    def flatten(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, envs=jenvs, cartpole=cartpole, ic=image_cartpole,
        resnet=resnet, common=common, tic=train_image_cartpole,
        tsc=train_sequence_cartpole, cartpole_env=cartpole_env,
        flatten=flatten,
    )


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Many small CPU ops: one intra-op thread keeps them fast beside other
    busy workers; the worker's next module gets its count back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _states(n, seed):
    rng = np.random.RandomState(seed)
    states = (rng.uniform(-1, 1, (n, 4)) * [1.0, 2.0, 3.0, 2.0]).astype(
        np.float32)
    states[0, 2] = 0.0
    states[1, 2] = np.pi
    return states


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the renderer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(100, 120, 40.0), (50, 60, 20.0)],
                         ids=["full", "half"])
@pytest.mark.parametrize("offset", [False, True], ids=["centered", "shifted"])
def test_render_matches_jax(J, size, offset):
    h, w, pole = size
    states = _states(6, 0)
    offsets = np.linspace(-30, 30, 6).astype(np.float32)
    kw = {"height": h, "width": w, "pole_len_px": pole}
    want = np.stack([
        np.asarray(J.ic.render_cartpole_image(
            J.jnp.asarray(s), x_offset_px=float(o) if offset else 0.0, **kw))
        for s, o in zip(states, offsets)])
    got = ic.render_cartpole_image(
        _t(states), x_offset_px=_t(offsets) if offset else 0.0, **kw)
    assert got.shape == (6, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMG_ATOL)


def test_render_image_stack_matches_jax(J):
    states = _states(5, 1)
    want = np.asarray(J.ic.render_image_stack(J.jnp.asarray(states),
                                              height=50, width=60))
    got = ic.render_image_stack(_t(states), height=50, width=60)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=IMG_ATOL)


# ---------------------------------------------------------------------------
# the nets, forward and gradients
# ---------------------------------------------------------------------------


def _images(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _net_case(J, name):
    """(JAX params, JAX apply(params, *inputs), port net, port apply(net,
    *inputs), numpy inputs)."""
    key = J.jax.random.PRNGKey(7)
    cart = cartpole_params()
    jcart = J.cartpole.cartpole_params()
    if name == "state_to_img":
        p = J.ic.init_state_to_img(key, width=24, height=20)
        net = ic.state_to_img_from_jax(J.flatten(p), 24, 20, device=CPU)
        return (p, lambda p, x: J.ic.state_to_img_apply(p, x, 24, 20), net,
                lambda n, x: n(x), [_states(4, 2)[:, [0, 2]]])
    if name == "image_controller":
        p = J.ic.init_image_controller(key, 20, 24)
        net = ic.image_controller_from_jax(J.flatten(p), 20, 24, device=CPU)
        return (p, J.ic.image_controller_apply, net, lambda n, x: n(x),
                [_images((3, 5, 20, 24), 3)])
    if name == "image_dynamics":
        p = J.ic.init_image_dynamics(key, 60, 50)
        # a residual large enough to matter beside the analytic step
        p["linear_state_2"] = (p["linear_state_2"][0] * 1e3,)
        net = ic.image_dynamics_from_jax(J.flatten(p), 60, 50, device=CPU)
        actions = np.random.RandomState(4).uniform(-1, 1, (3, 1)).astype(
            np.float32)
        return (p, lambda p, s, im, a: J.ic.image_dynamics_apply(
                    p, jcart, s, im, a, DT),
                net, lambda n, s, im, a: n(cart, s, im, a, DT),
                [_states(3, 5), _images((3, 5, 50, 60), 6), actions])
    if name == "sequence":
        p = J.ic.init_sequence_dynamics(key)
        p = p._replace(w2=p.w2 * 1e3)
        net = ic.sequence_dynamics_from_jax(p.w1, p.b1, p.w2, device=CPU)
        rng = np.random.RandomState(8)
        return (p, lambda p, s, h, a: J.ic.sequence_dynamics_apply(
                    p, jcart, s, h, a, DT),
                net, lambda n, s, h, a: ic.sequence_dynamics_apply(
                    n, cart, s, h, a, DT),
                [_states(6, 9), rng.randn(6, 15).astype(np.float32),
                 rng.uniform(-1, 1, (6, 1)).astype(np.float32)])
    if name == "dqn":
        p = J.ic.init_image_dqn(key, 40, 48, out_size=2)
        # scales and shifts away from 1 and 0
        for i in (1, 2, 3):
            scale, bias = p[f"bn{i}"]
            p[f"bn{i}"] = (scale * 1.5, bias + 0.1)
        net = ic.image_dqn_from_jax(J.flatten(p), 40, 48, device=CPU)
        return (p, J.ic.image_dqn_apply, net, lambda n, x: n(x),
                [_images((4, 3, 40, 48), 10)])
    p = J.resnet.init_resnet_net(key, 6, 3)
    net = resnet_from_jax(J.flatten(p), device=CPU)
    return (p, J.resnet.resnet_net_apply, net, lambda n, x: n(x),
            [np.random.RandomState(11).randn(5, 6).astype(np.float32)])


def _param_leaves(net):
    """{JAX key: gradient} of the port's net or SequenceResidual."""
    if isinstance(net, ic.SequenceResidual):
        return {f".{k}": getattr(net, k).grad.numpy()
                for k in ("w1", "b1", "w2")}
    return net_to_jax(net, lambda p: p.grad)


NETS = ("state_to_img", "image_controller", "image_dynamics", "sequence",
        "dqn", "resnet")
# a conv bias that feeds a batch-statistics norm cancels in it: its exact
# gradient is 0, and both sides hold float roundoff (~1e-6 of the weight's)
ZERO_GRADS = {"dqn": ("['conv1'][1]", "['conv2'][1]", "['conv3'][1]")}


@pytest.mark.parametrize("name", NETS)
def test_net_forward_and_gradients_match_jax(J, name):
    jp, japply, net, tapply, inputs = _net_case(J, name)
    jin = [J.jnp.asarray(x) for x in inputs]
    want = np.asarray(japply(jp, *jin))
    cot = np.random.RandomState(12).randn(*want.shape).astype(np.float32)
    jgrads = J.flatten(J.jax.grad(
        lambda p: J.jnp.sum(japply(p, *jin) * cot))(jp))

    if isinstance(net, ic.SequenceResidual):
        for t in (net.w1, net.b1, net.w2):
            t.requires_grad_()
    out = tapply(net, *[_t(x) for x in inputs])
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=NET_RTOL,
                               atol=NET_ATOL)
    (out * _t(cot)).sum().backward()
    got = _param_leaves(net)
    assert sorted(got) == sorted(jgrads)
    for key, g in jgrads.items():
        if key in ZERO_GRADS.get(name, ()):
            bound = NET_ATOL * np.abs(jgrads[key[:-3] + "[0]"]).max()
            assert np.abs(got[key]).max() <= bound, key
            assert np.abs(g).max() <= bound, key
            continue
        np.testing.assert_allclose(got[key], g, rtol=NET_RTOL,
                                   atol=NET_ATOL * np.abs(g).max(),
                                   err_msg=key)


def test_dqn_normalizes_with_batch_statistics():
    """Every channel after the first norm has the batch's zero mean and unit
    biased variance (a constant input channel stays zero)."""
    x = torch.randn(8, 4, 6, 5) * 3 + 2
    y = ic.BatchStatNorm2d(4)(x)
    assert torch.allclose(y.mean(dim=(0, 2, 3)), torch.zeros(4), atol=1e-5)
    assert torch.allclose(y.var(dim=(0, 2, 3), unbiased=False),
                          torch.ones(4), atol=1e-3)


# ---------------------------------------------------------------------------
# collections, fits and gaps
# ---------------------------------------------------------------------------


def _jax_draws(J, key, n, t):
    """The start states and actions a JAX collection draws from ``key``."""
    k1, k2 = J.jax.random.split(key)
    states0 = (J.jax.random.uniform(k1, (n, 4)) - 0.5) * J.jnp.asarray(
        [0.4, 0.4, 0.4, 0.4])
    actions = J.jax.random.uniform(k2, (n, t, 1), minval=-1.0, maxval=1.0)
    return np.array(states0), np.array(actions)


def _assert_data(got, want, tol=IMG_ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.cpu().numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("kind", ["image", "history"])
def test_collect_rollouts_match_jax(J, kind):
    key = J.jax.random.PRNGKey(3)
    jcollect, tcollect = {
        "image": (J.tic.collect_image_rollouts, tic.collect_image_rollouts),
        "history": (J.tsc.collect_history_rollouts,
                    tsc.collect_history_rollouts)}[kind]
    want = jcollect(key, J.cartpole.cartpole_params(MISMATCH), n=5, t=6)
    s0, a = _jax_draws(J, key, 5, 6)
    got = tcollect(None, cartpole_params(MISMATCH), states0=s0, actions=a,
                   device=CPU)
    _assert_data(got, want)


def _jax_epoch_batches(J, key, n_data, epochs):
    """The minibatch indices of each epoch of a JAX fit from ``key``."""
    _, _, k_train = J.jax.random.split(key, 3)
    out = []
    for _ in range(epochs):
        k_train, k = J.jax.random.split(k_train)
        out.append(np.asarray(J.common.shuffled_batches(k, n_data, FIT_B)))
    return out


def _image_fit_pair(J, seed, n_rollouts, epochs):
    """The JAX fit from PRNGKey(seed) and the port's on its data, initial
    net and batches -> (JAX net, JAX losses, port net, port losses, the
    initial params)."""
    key = J.jax.random.PRNGKey(seed)
    jnet, jhist, jdata = J.tic.fit_image_dynamics(
        key, J.cartpole.cartpole_params(MISMATCH), n_rollouts=n_rollouts,
        t=FIT_T, epochs=epochs, batch_size=FIT_B)
    _, k_net, _ = J.jax.random.split(key, 3)
    init = J.flatten(J.ic.init_image_dynamics(k_net, tic.IMG_W, tic.IMG_H))
    net, hist, _ = tic.fit_image_dynamics(
        None, cartpole_params(MISMATCH), epochs=epochs, batch_size=FIT_B,
        data=tuple(_t(x) for x in jdata),
        net=ic.image_dynamics_from_jax(init, tic.IMG_W, tic.IMG_H,
                                       device=CPU),
        batches=_jax_epoch_batches(J, key, n_rollouts * FIT_T, epochs),
        device=CPU)
    return J.flatten(jnet), jhist, net_to_jax(net), hist, init


def test_image_fit_step_matches_jax(J):
    """One rollout of 8 steps is one batch: one Adam step."""
    want, jhist, got, hist, _ = _image_fit_pair(J, 5, 1, 1)
    np.testing.assert_allclose(hist, jhist, rtol=FIT_RTOL)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=FIT_ATOL,
                                   err_msg=k)


def test_image_fit_epochs_match_jax(J):
    """Two epochs of 4 Adam steps. Adam turns float roundoff in a near-zero
    gradient entry into a whole step of either sign, and the conv
    residual's gradients are sums of thousands of pixel terms, so single
    weights part by up to lr after a few steps; each leaf is held by the
    norm of its gap against the distance JAX's fit moved it."""
    want, jhist, got, hist, init = _image_fit_pair(J, 5, FIT_N, 2)
    np.testing.assert_allclose(hist, jhist, rtol=IMAGE_FIT_LOSS_RTOL)
    assert sorted(got) == sorted(want)
    for k in want:
        moved = np.linalg.norm(want[k] - init[k])
        assert np.linalg.norm(got[k] - want[k]) <= IMAGE_FIT_REL * moved, k


def test_fit_sequence_dynamics_matches_jax(J):
    key = J.jax.random.PRNGKey(6)
    jnet, jhist = J.tsc.fit_sequence_dynamics(
        key, J.cartpole.cartpole_params(MISMATCH), n_rollouts=FIT_N, t=FIT_T,
        epochs=2, batch_size=FIT_B)
    k_data, k_net, _ = J.jax.random.split(key, 3)
    init = J.ic.init_sequence_dynamics(k_net, buffer_length=tsc.BUF)
    s0, a = _jax_draws(J, k_data, FIT_N, FIT_T)
    params, hist = tsc.fit_sequence_dynamics(
        None, cartpole_params(MISMATCH), epochs=2, batch_size=FIT_B,
        data=tsc.collect_history_rollouts(None, cartpole_params(MISMATCH),
                                          states0=s0, actions=a, device=CPU),
        params=ic.sequence_dynamics_from_jax(*init, device=CPU),
        batches=_jax_epoch_batches(J, key, FIT_N * FIT_T, 2), device=CPU)
    np.testing.assert_allclose(hist, jhist, rtol=FIT_RTOL)
    for name in ("w1", "b1", "w2"):
        np.testing.assert_allclose(getattr(params, name).numpy(),
                                   np.asarray(getattr(jnet, name)), rtol=0,
                                   atol=FIT_ATOL, err_msg=name)


def test_image_dynamics_gap_matches_jax(J):
    key, gap_key = J.jax.random.split(J.jax.random.PRNGKey(8))
    init = J.ic.init_image_dynamics(key, tic.IMG_W, tic.IMG_H)
    init["linear_state_2"] = (init["linear_state_2"][0] * 1e3,)
    want = J.tic.image_dynamics_gap(init, J.cartpole.cartpole_params(
        MISMATCH), gap_key, n_rollouts=4, t=5)
    s0, a = _jax_draws(J, gap_key, 4, 5)
    net = ic.image_dynamics_from_jax(J.flatten(init), tic.IMG_W, tic.IMG_H,
                                     device=CPU)
    got = tic.image_dynamics_gap(net, cartpole_params(MISMATCH), None,
                                 states0=s0, actions=a)
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL)


def test_sequence_dynamics_gap_matches_jax(J):
    key, gap_key = J.jax.random.split(J.jax.random.PRNGKey(9))
    init = J.ic.init_sequence_dynamics(key)
    init = init._replace(w2=init.w2 * 1e3)
    want = J.tsc.sequence_dynamics_gap(init, J.cartpole.cartpole_params(
        MISMATCH), gap_key, n_rollouts=4, t=5)
    s0, a = _jax_draws(J, gap_key, 4, 5)
    got = tsc.sequence_dynamics_gap(
        ic.sequence_dynamics_from_jax(*init, device=CPU),
        cartpole_params(MISMATCH), None, states0=s0, actions=a)
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL)


def test_fits_draw_from_the_generator():
    """Without fed draws, the generator gives the data, the net and the
    batches: the same seed, the same fit; the losses finite."""
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(4)
        params, hist = tsc.fit_sequence_dynamics(
            g, cartpole_params(MISMATCH), n_rollouts=4, t=8, epochs=2,
            batch_size=8, device=CPU)
        runs.append((params.w2.clone(), hist))
    assert runs[0][1] == runs[1][1] and all(np.isfinite(runs[0][1]))
    assert torch.equal(runs[0][0], runs[1][0])
    s, stacks, a, nxt = tic.collect_image_rollouts(
        torch.Generator().manual_seed(1), cartpole_params(), n=3, t=4,
        device=CPU)
    assert stacks.shape == (12, tic.NR_IMG, tic.IMG_H, tic.IMG_W)
    assert float(s[:3].abs().max()) <= 0.2 and float(a.abs().max()) <= 1.0
    # the first step's stack holds the start state's frame 5 times
    assert torch.equal(stacks[0], stacks[0, :1].expand(tic.NR_IMG, -1, -1))


# ---------------------------------------------------------------------------
# the image RL env
# ---------------------------------------------------------------------------


def _image_env_run(env, draws, actions, step_draws):
    s, obs = env.reset(draws)
    out = [(obs, None)]
    for a, d in zip(actions, step_draws):
        s, obs, rew, _ = env.step(s, a, d)
        out.append((obs, rew))
    return out


def test_image_env_matches_jax(J):
    jax = J.jax
    j_reset, j_step, obs_dim, act_dim = J.envs.make_cartpole_rl(
        J.cartpole.cartpole_params(), max_steps=3, image_obs=True)
    env = rl_envs.make_cartpole_rl(cartpole_params(), max_steps=3,
                                   image_obs=True, device=CPU)
    assert (env.obs_dim, env.act_dim) == (obs_dim, act_dim) == (
        (3, 100, 120), 1)
    n = 3

    def draw(k):
        return J.cartpole_env.reset_upright(k, 1)[0]

    keys = jax.random.split(jax.random.PRNGKey(2), n)
    js, jobs = jax.vmap(j_reset)(keys)
    ts, tobs = env.reset(_t(jax.vmap(draw)(keys)))
    assert tobs.shape == (n, 3, 100, 120)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0,
                               atol=ENV_TOL)
    rng = np.random.RandomState(3)
    for t in range(6):  # past max_steps: auto-resets run
        action = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
        keys = jax.random.split(jax.random.PRNGKey(50 + t), n)
        js, jobs, jrew, jdone = jax.vmap(j_step)(js, J.jnp.asarray(action),
                                                 keys)
        ts, tobs, trew, tdone = env.step(ts, _t(action),
                                         _t(jax.vmap(draw)(keys)))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew),
                                   rtol=ENV_TOL, atol=ENV_TOL)
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0,
                                   atol=ENV_TOL)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_card_image_fit_matches_cpu(cuda_device):
    """Collection and two fit epochs at the trainer's image size on the
    card and the CPU from the same draws and initial net: data within
    1e-5, losses rtol 1e-4, weights within 1e-4; no rollout kernel."""
    g = torch.Generator().manual_seed(0)
    s0, a = tic.draw_rollout_inputs(g, 8, 8)
    net0 = ic.ImageCartpoleDynamics(tic.IMG_W, tic.IMG_H, generator=g)
    batches = [torch.randperm(64, generator=g).reshape(8, 8)
               for _ in range(2)]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        R.FORWARD_LAUNCHES = R.BACKWARD_LAUNCHES = 0
        data = tic.collect_image_rollouts(None, cartpole_params(MISMATCH),
                                          states0=s0, actions=a, device=dev)
        net, hist, _ = tic.fit_image_dynamics(
            None, cartpole_params(MISMATCH), epochs=2, batch_size=8,
            data=data, net=ic.image_dynamics_from_jax(
                net_to_jax(net0), tic.IMG_W, tic.IMG_H, device=dev),
            batches=batches, device=dev)
        assert (R.FORWARD_LAUNCHES, R.BACKWARD_LAUNCHES) == (0, 0)
        out[dev.type] = ([x.cpu() for x in data], hist, net_to_jax(net))
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4)
    for k, w in out["cpu"][2].items():
        np.testing.assert_allclose(out["cuda"][2][k], w, rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.cuda
def test_card_image_env_matches_cpu(cuda_device):
    g = torch.Generator().manual_seed(1)
    actions = [torch.rand((4, 1), generator=g) * 2 - 1 for _ in range(5)]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        env = rl_envs.make_cartpole_rl(cartpole_params(), max_steps=3,
                                       image_obs=True, device=dev)
        draws = env.draw_resets(torch.Generator().manual_seed(2), (4,))
        steps = [env.draw_resets(torch.Generator().manual_seed(10 + t), (4,))
                 for t in range(5)]
        R.FORWARD_LAUNCHES = R.BACKWARD_LAUNCHES = 0
        run = _image_env_run(env, draws, [x.to(dev) for x in actions], steps)
        assert (R.FORWARD_LAUNCHES, R.BACKWARD_LAUNCHES) == (0, 0)
        out[dev.type] = [o.cpu() for o, _ in run]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=ENV_TOL)
