"""The port is complete: every public name, every script flag and every
keyword of the JAX package has its counterpart in
``apg_trajectory_tracking_tpu_torch/``, or a listed reason.

The check reads source with ``ast`` only and imports neither package. For
each module of the JAX package, each public top-level function and class
must be bound at the top of the port's module of the same path (the
``MODULES`` table maps the one path that differs), or stand in
``EQUIVALENTS`` with the port's counterpart, which must exist. For each
``scripts/*.py``, its flags must be a subset of its port module's
(``SCRIPT_MODULES``). For each pair of top-level functions of the same
name, the port must accept every keyword of the JAX function, apart from
those in ``KEYWORD_EXCEPTIONS``; a ``**kwargs`` accepts nothing by name.
Each table must also be exact: an entry for a gap that no longer exists
fails as a stale entry.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "apg_trajectory_tracking_tpu")
PORT = os.path.join(ROOT, "apg_trajectory_tracking_tpu_torch")
SCRIPTS = os.path.join(ROOT, "scripts")

# JAX module -> the port's module, where the path differs
MODULES = {"ops/pallas_rollout.py": "ops/rollout.py"}

# JAX modules with nothing to port, and why
NOTHING_TO_PORT = {
    "utils/backend.py": "force_cpu_backend selects JAX's platform; the port "
                        "picks a device per call (utils/device.py)",
}

NET = "a functional init/apply pair became an nn.Module"
# (JAX module, name) -> (port module, counterpart, why); ``Class.method``
# names a method
EQUIVALENTS = {
    ("ops/pallas_rollout.py", "make_quad_rollout_pallas"): (
        "ops/rollout.py", "quad_rollout",
        "the Pallas kernel became the CUDA kernels behind one wrapper"),
    ("ops/pallas_rollout.py", "quad_rollout_scan"): (
        "ops/rollout.py", "quad_rollout_reference",
        "the scan reference is the kernels' plain twin"),
    ("training/common.py", "epoch_scan"): (
        "parallel/mesh.py", "make_sharded_epoch",
        "a lax.scan over minibatches is an eager loop: the trainers' epoch "
        "runner"),
    ("training/train_cartpole.py", "build_train_step"): (
        "training/train_cartpole.py", "build_cartpole_step",
        "the step binds the net and its optimizer"),
    ("parallel/mesh.py", "make_sharded_eval"): (
        "evaluation/quad_eval.py", "run_eval",
        "the evaluators pad, shard and gather their episodes under mesh="),
    ("utils/checkpoints.py", "resolve_model_dir"): (
        "evaluation/quad_eval.py", "resolve_model_dir",
        "it resolves the eval CLIs' -m names, beside them"),
    ("baselines/pets.py", "EnsembleParams"): ("baselines/pets.py",
                                              "Ensemble", NET),
    ("baselines/pets.py", "init_ensemble"): ("baselines/pets.py",
                                             "Ensemble", NET),
    ("baselines/pets.py", "make_model_trainer"): (
        "baselines/pets.py", "train_model",
        "a jitted trainer factory became the training function"),
    ("baselines/pets.py", "make_cem_planner"): (
        "baselines/pets.py", "CEMPlanner",
        "the planner closure became a class holding its draws"),
    ("baselines/ppo.py", "init_actor_critic"): ("baselines/ppo.py",
                                                "ActorCritic", NET),
    ("baselines/ppo.py", "policy_mean"): ("baselines/ppo.py",
                                          "ActorCritic.policy_mean", NET),
    ("baselines/ppo.py", "value"): ("baselines/ppo.py", "ActorCritic.value",
                                    NET),
    ("models/common.py", "linear_init"): ("models/common.py", "linear", NET),
    ("models/common.py", "conv1d_init"): ("models/common.py", "conv1d", NET),
    ("models/common.py", "conv1d_apply"): (
        "models/common.py", "conv1d",
        "the nn.Conv1d that conv1d builds applies itself"),
    ("models/image_cartpole.py", "init_state_to_img"): (
        "models/image_cartpole.py", "StateToImg", NET),
    ("models/image_cartpole.py", "state_to_img_apply"): (
        "models/image_cartpole.py", "StateToImg.forward", NET),
    ("models/image_cartpole.py", "init_image_controller"): (
        "models/image_cartpole.py", "ImageControllerNet", NET),
    ("models/image_cartpole.py", "image_controller_apply"): (
        "models/image_cartpole.py", "ImageControllerNet.forward", NET),
    ("models/image_cartpole.py", "init_image_dynamics"): (
        "models/image_cartpole.py", "ImageCartpoleDynamics", NET),
    ("models/image_cartpole.py", "image_dynamics_apply"): (
        "models/image_cartpole.py", "ImageCartpoleDynamics.forward", NET),
    ("models/image_cartpole.py", "init_image_dqn"): (
        "models/image_cartpole.py", "ImageControllerNetDQN", NET),
    ("models/image_cartpole.py", "image_dqn_apply"): (
        "models/image_cartpole.py", "ImageControllerNetDQN.forward", NET),
    ("models/mlp.py", "init_control_net"): ("models/mlp.py", "ControlNet",
                                            NET),
    ("models/resnet.py", "init_resnet_net"): ("models/resnet.py", "ResNet",
                                              NET),
    ("models/rnn.py", "init_lstm_net"): ("models/rnn.py", "LSTMNet", NET),
    ("models/simple.py", "init_cartpole_net"): ("models/simple.py",
                                                "CartpoleNet", NET),
}

# JAX script -> the port modules that hold its flags
SCRIPT_MODULES = {
    "adapt_cartpole.py": ("training/adapt.py",),
    "adapt_quad.py": ("training/adapt_protocol.py",),
    "adapt_wing.py": ("training/adapt_protocol.py",),
    "bench_scaling.py": ("perf/scaling.py",),
    "compare_baselines.py": ("evaluation/compare.py",),
    "convert_reference_checkpoint.py": ("utils/convert_reference.py",),
    "distill_mpc.py": ("training/distill.py",),
    "distill_mpc_lstm.py": ("training/distill.py",),
    "distill_mpc_wing.py": ("training/distill.py",),
    "evaluate_cartpole.py": ("evaluation/cartpole_eval.py",),
    "evaluate_epochs.py": ("evaluation/epochs.py",),
    "evaluate_quad.py": ("evaluation/quad_eval.py",),
    "evaluate_wing.py": ("evaluation/wing_eval.py",),
    "export_controller.py": ("utils/export_controller.py",),
    "generate_trajectories.py": ("trajectory/generate.py",),
    "latency_bench.py": ("perf/latency.py",),
    "layout_exp.py": ("perf/layout.py",),
    "make_tables.py": ("evaluation/tables.py",),
    "multihost_smoke.py": ("parallel/multihost_smoke.py",),
    "perf_ab.py": ("perf/ab.py",),
    "pets_baseline.py": ("baselines/pets.py",),
    "ppo_baseline.py": ("baselines/ppo.py",),
    "ppo_sweep.py": ("baselines/ppo_sweep.py",),
    "rate_cap_ablation.py": ("training/rate_cap.py",),
    "speed_feasibility.py": ("evaluation/feasibility.py",),
    "swingup_adapt.py": ("training/swingup_adapt.py",),
    "swingup_robustness.py": ("evaluation/swingup_robustness.py",),
    # the train CLIs share their infrastructure flags (add_infra_args)
    "train_cartpole.py": ("training/train_cartpole.py", "training/common.py"),
    "train_quad.py": ("training/train_quad.py", "training/common.py"),
    "train_wing.py": ("training/train_wing.py", "training/common.py"),
    "wall_feasibility_accounting.py": ("evaluation/wall_feasibility.py",),
}

STATE = "functional state: the port's call holds the module or tensors"
PRNG = ("a JAX PRNG key: the port takes a torch.Generator or the draws "
        "(JAX's streams cannot be reproduced)")
ORBAX = "orbax imports JAX: the port's checkpoints are npz only, by rule"
ENV = "the port takes the RLEnv that holds the reset, step and widths"
STEP = ("the port's step binds the net, and the unroll is an argument of "
        "the step (unroll=)")
# (JAX module, function) -> {JAX keyword the port lacks: why}
KEYWORD_EXCEPTIONS = {
    ("evaluation/cartpole_eval.py", "evaluate_swingup"): {
        "key": "the port takes the starts drawn from it"},
    ("evaluation/cartpole_eval.py", "swingup_metrics"): {
        "key": "the port takes the starts drawn from it"},
    ("evaluation/quad_eval.py", "follow_trajectories"): {
        "net_params": STATE},
    ("evaluation/quad_eval.py", "follow_analytic"): {"net_params": STATE},
    ("evaluation/quad_eval.py", "run_eval"): {"net_params": STATE},
    ("evaluation/wing_eval.py", "fly_to_point"): {"net_params": STATE},
    ("evaluation/wing_eval.py", "run_eval"): {
        "net_params": STATE, "key": "the port takes the targets drawn from "
                                    "it"},
    ("training/common.py", "shuffled_batches"): {"key": PRNG},
    ("training/dynamics_fit.py", "fit_dynamics_epoch"): {
        "actions_fn": "-> actions: the port takes the epoch's actions, "
                      "computed once by the caller"},
    ("training/train_image_cartpole.py", "collect_image_rollouts"): {
        "key": PRNG},
    ("training/train_image_cartpole.py", "fit_image_dynamics"): {
        "key": PRNG},
    ("training/train_image_cartpole.py", "image_dynamics_gap"): {
        "key": PRNG},
    ("training/train_quad.py", "build_concurrent_step"): {"dyn_step": STEP},
    ("training/train_quad.py", "build_recurrent_step"): {"dyn_step": STEP},
    ("training/train_sequence_cartpole.py", "collect_history_rollouts"): {
        "key": PRNG},
    ("training/train_sequence_cartpole.py", "fit_sequence_dynamics"): {
        "key": PRNG},
    ("training/train_sequence_cartpole.py", "sequence_dynamics_gap"): {
        "net": "-> params: " + STATE, "key": PRNG},
    ("dynamics/learnt.py", "init_residual_params"): {"key": PRNG},
    ("dynamics/learnt.py", "make_learnt_cartpole"): {"key": PRNG},
    ("dynamics/learnt.py", "make_learnt_quad"): {"key": PRNG},
    ("dynamics/learnt.py", "make_learnt_wing"): {"key": PRNG},
    ("envs/cartpole_env.py", "reset_random"): {"key": PRNG},
    ("envs/cartpole_env.py", "reset_swingup"): {"key": PRNG},
    ("envs/cartpole_env.py", "reset_upright"): {"key": PRNG},
    ("envs/cartpole_env.py", "construct_states"): {"key": PRNG},
    ("envs/quad_env.py", "quad_random_reset"): {"key": PRNG},
    ("envs/wing_env.py", "run_wing_flight"): {"key": PRNG},
    ("parallel/mesh.py", "shard_batch"): {"tree": STATE},
    ("parallel/mesh.py", "replicate"): {"tree": STATE},
    ("parallel/mesh.py", "make_sharded_epoch"): {
        "dyn_arg": "the port's epoch always passes the dynamics parameters",
        "donate": "the optimizer updates in place: no buffer to donate",
        "unroll": "no scan to unroll: one step per loop trip"},
    ("parallel/mesh.py", "host_local_fold"): {
        "key": "-> generator_seed: " + PRNG},
    ("baselines/ppo.py", "make_ppo"): {
        "reset_fn": ENV, "step_fn": ENV, "obs_dim": ENV, "act_dim": ENV},
    ("baselines/ppo.py", "train_ppo"): {
        "reset_fn": ENV, "step_fn": ENV, "obs_dim": ENV, "act_dim": ENV},
    ("baselines/ppo.py", "evaluate_policy"): {
        "reset_fn": ENV, "step_fn": ENV, "key": "-> generator: " + PRNG},
    ("models/image_cartpole.py", "init_sequence_dynamics"): {"key": PRNG},
    ("models/mlp.py", "control_net_apply"): {"params": STATE},
    ("models/resnet.py", "resnet_net_apply"): {"params": STATE},
    ("models/rnn.py", "init_lstm_state"): {
        "batch_size": "-> batch", "key": "-> generator: " + PRNG},
    ("models/rnn.py", "lstm_net_apply"): {"params": STATE},
    ("models/simple.py", "cartpole_net_apply"): {"params": STATE},
    ("utils/checkpoints.py", "save_checkpoint"): {
        "tree": STATE, "backend": ORBAX},
    ("utils/checkpoints.py", "load_checkpoint"): {"template": STATE},
    ("utils/checkpoints.py", "save_train_state"): {
        "opt_state": "-> optimizer: " + STATE, "backend": ORBAX},
    ("utils/checkpoints.py", "restore_train_state"): {
        "net_template": STATE, "opt_template": STATE},
}

JAX_IGNORES = "accepted and never read, as in the JAX package"
# What the port accepts for parity only, in one place, so that no change
# mistakes it for a real option: (port module, function, keyword) -> why,
# each keyword unread in both packages; (port module, flag) -> why
ACCEPTED_AND_IGNORED = {
    ("evaluation/quad_eval.py", "follow_analytic", "horizon"): JAX_IGNORES,
    ("baselines/rl_envs.py", "make_quad_rl_mario", "speed_factor"):
        JAX_IGNORES,
    ("training/train_quad.py", "build_recurrent_step", "action_dim"):
        JAX_IGNORES,
    ("parallel/multihost_smoke.py", "--local_devices"):
        "a torch rank drives one device: 1 is the only value, any other "
        "exits (README, design differences)",
}


# ---------------------------------------------------------------------------
# the checker: source text in, gaps out
# ---------------------------------------------------------------------------


def _read(path):
    with open(path) as f:
        return f.read()


def top_level(src):
    """{name: node} of the defs, classes, assignments and imports at the
    top of a module's source."""
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            for target in targets:
                if isinstance(target, ast.Name):
                    out[target.id] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out[(alias.asname or alias.name).split(".")[0]] = node
    return out


def public_names(src):
    """The public top-level functions and classes of a module's source."""
    return {name for name, node in top_level(src).items()
            if not name.startswith("_") and isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}


def missing_names(jax_src, port_src):
    return public_names(jax_src) - set(top_level(port_src))


def has_name(src, dotted):
    """Whether ``name`` or ``Class.method`` is defined in a source."""
    name, _, method = dotted.partition(".")
    node = top_level(src).get(name)
    if node is None or not method:
        return node is not None
    return isinstance(node, ast.ClassDef) and any(
        isinstance(n, ast.FunctionDef) and n.name == method
        for n in node.body)


def flags(src):
    """Every option string of every ``add_argument`` call in a source."""
    out = set()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            out |= {a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and a.value.startswith("-")}
    return out


def missing_flags(script_src, module_srcs):
    return flags(script_src) - set().union(*map(flags, module_srcs))


def keywords(fn):
    """The names a call can pass by keyword (``**kwargs`` names none)."""
    a = fn.args
    return [x.arg for x in a.args + a.kwonlyargs]


def missing_keywords(jax_fn, port_fn):
    return set(keywords(jax_fn)) - set(keywords(port_fn))


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _jax_modules():
    for dirpath, _, files in os.walk(JAX):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), JAX)


JAX_MODULES = sorted(_jax_modules())


def _port_path(rel):
    return os.path.join(PORT, MODULES.get(rel, rel))


def _function_pairs():
    for rel in JAX_MODULES:
        if rel in NOTHING_TO_PORT:
            continue
        jax_top = top_level(_read(os.path.join(JAX, rel)))
        port_top = top_level(_read(_port_path(rel)))
        for name, node in sorted(jax_top.items()):
            if (not name.startswith("_")
                    and isinstance(node, ast.FunctionDef)
                    and isinstance(port_top.get(name), ast.FunctionDef)):
                yield rel, name


FUNCTION_PAIRS = sorted(_function_pairs())


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_name_has_a_counterpart(rel):
    if rel in NOTHING_TO_PORT:
        return
    assert os.path.isfile(_port_path(rel)), f"no port module for {rel}"
    missing = missing_names(_read(os.path.join(JAX, rel)),
                            _read(_port_path(rel)))
    listed = {name for (mod, name) in EQUIVALENTS if mod == rel}
    assert missing - listed == set(), f"{rel}: no counterpart"
    assert listed - missing == set(), f"{rel}: stale EQUIVALENTS entries"


@pytest.mark.parametrize("entry", sorted(EQUIVALENTS),
                         ids=[":".join(e) for e in sorted(EQUIVALENTS)])
def test_each_equivalent_exists(entry):
    port_rel, counterpart, why = EQUIVALENTS[entry]
    assert why
    assert has_name(_read(os.path.join(PORT, port_rel)), counterpart), (
        f"{entry}: {port_rel} defines no {counterpart}")


def test_nothing_to_port_lists_modules_of_the_package():
    assert set(NOTHING_TO_PORT) <= set(JAX_MODULES)
    assert set(MODULES) <= set(JAX_MODULES)


@pytest.mark.parametrize("script", sorted(
    f for f in os.listdir(SCRIPTS) if f.endswith(".py")))
def test_script_flags_are_a_subset_of_the_port_module(script):
    modules = SCRIPT_MODULES[script]
    missing = missing_flags(
        _read(os.path.join(SCRIPTS, script)),
        [_read(os.path.join(PORT, m)) for m in modules])
    assert missing == set(), f"{script}: {modules} lack {sorted(missing)}"


@pytest.mark.parametrize("pair", FUNCTION_PAIRS,
                         ids=[":".join(p) for p in FUNCTION_PAIRS])
def test_the_port_accepts_every_jax_keyword(pair):
    rel, name = pair
    missing = missing_keywords(top_level(_read(os.path.join(JAX, rel)))[name],
                               top_level(_read(_port_path(rel)))[name])
    listed = KEYWORD_EXCEPTIONS.get(pair, {})
    assert all(listed.values())
    assert missing == set(listed), (
        f"{rel}::{name}: lacks {sorted(missing - set(listed))}; stale "
        f"entries {sorted(set(listed) - missing)}")


def reads(fn, name):
    """Whether a function's body reads the name ``name``."""
    return any(isinstance(n, ast.Name) and n.id == name
               and isinstance(n.ctx, ast.Load) for n in ast.walk(fn))


IGNORED = sorted(ACCEPTED_AND_IGNORED)


@pytest.mark.parametrize("entry", IGNORED,
                         ids=[":".join(e) for e in IGNORED])
def test_accepted_and_ignored_parameters(entry):
    assert ACCEPTED_AND_IGNORED[entry]
    src = _read(os.path.join(PORT, entry[0]))
    if len(entry) == 2:
        assert entry[1] in flags(src)
        return
    rel, name, keyword = entry
    for fn in (top_level(src)[name],
               top_level(_read(os.path.join(JAX, rel)))[name]):
        assert keyword in keywords(fn) and not reads(fn, keyword), entry


def test_keyword_exceptions_name_function_pairs():
    assert set(KEYWORD_EXCEPTIONS) <= set(FUNCTION_PAIRS)


def test_the_checker_reports_a_missing_name_flag_and_keyword():
    jax_src = (
        "import argparse\n"
        "def kept(a, b=1, *, c=2):\n    pass\n"
        "def dropped():\n    pass\n"
        "class Kept:\n    pass\n"
        "def _private():\n    pass\n"
        "p = argparse.ArgumentParser()\n"
        "p.add_argument('-s', '--save_name')\n"
        "p.add_argument('--lost', type=int)\n")
    port_src = (
        "from x import Kept\n"
        "def kept(a, *args, c=2, **kwargs):\n    pass\n"
        "p.add_argument('-s', '--save_name')\n")
    assert missing_names(jax_src, port_src) == {"dropped"}
    assert missing_flags(jax_src, [port_src]) == {"--lost"}
    assert missing_keywords(top_level(jax_src)["kept"],
                            top_level(port_src)["kept"]) == {"b"}
    assert reads(top_level("def f(a, b):\n    return b\n")["f"], "b")
    assert not reads(top_level("def f(a, b):\n    return a\n")["f"], "b")
    assert has_name("class A:\n    def f(self):\n        pass\n", "A.f")
    assert not has_name("class A:\n    pass\n", "A.f")
