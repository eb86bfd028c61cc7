"""The JAX package's own validation scenes of the r5c bundle and of the
simplified-task bundles, in the port.

`deep_rl_grasping_tpu_torch/data/r5c_val_scenes.npz` holds the 100 env
states that the JAX package's protocol evaluation of
`trained/sac_full_flagship_r5c` starts from: `EvalMixin.evaluate`
(deep_rl_grasping_tpu/training/trainer.py:150-168) builds the eval
`GraspEnv` of the bundle's config, `BatchedGraspEnv(..., 100)` and resets
it with `PRNGKey(1)` at curriculum lambda 1. The file was built with the
JAX package on the CPU (XLA physics for the settle) and also holds, for the
first 8 envs:

* the JAX package's first observation, through its Pallas raster in
  interpret mode (the kernel the port replaces; see tests/test_torch_env.py
  on why not the XLA renderer);
* the r5c actor's deterministic action on that observation (the port's
  actor; tests/test_torch_networks.py holds it against the JAX actor);
* the JAX state, reward and done after one control step with those
  actions (`BatchedGraspEnv.step`, XLA physics).

The port's evaluation can start from these states
(`EvalMixin.evaluate(initial_states=...)`), which settles whether the
port's 100-episode success rate differs from the JAX figure by scene luck
(chip_smoke.py evaluates the bundle from them on the card).

Tolerances: the observation as in tests/test_torch_env.py (1e-4 on all but
0.1% of the values; a pixel whose nearest primitive flips under float32
rounding differs by more); the action to 2e-2 (bf16 layers, run on
observations that agree to 1e-4); after the step, rewards to 1e-2 (height
changes are scaled by 1000), dones exactly, gripper coordinates and object
positions to 1e-5 m (16 substeps of float32 contact solving in two
summation orders; the gaps seen are under 1e-7 m).

`deep_rl_grasping_tpu_torch/data/simplified_r5_val_scenes.npz` holds the
same for `trained/bdq_simplified_r5` (simplified task, encoder latents;
its curriculum and gripper start differ from r5c's, so its scenes do too):
the first 8 observations are 100-wide latents of the Pallas render through
the JAX package's encoder, the actions are the BDQ policy's greedy bins
(the port's network; tests/test_torch_discrete.py holds it against Flax),
and the step is the simplified task's three-call step with branched
actions at the BDQ block's 8 pads. There the latents are held to 3e-2
(tests/test_torch_encoder.py: the port's plain render may flip an edge
pixel's id), the bins exactly where the top two Q values of a branch are
more than 2e-2 apart (bf16 layers), and after the step rewards and
statuses exactly, gripper coordinates and object positions to 1e-4 m
(40 substeps of float32 contact solving in two summation orders).

`data/r5b_val_scenes.npz` and `data/clearing_v2_val_scenes.npz` hold the
same for `trained/sac_full_flagship_r5b` (whose default object-object
solver options settle the scenes elsewhere than r5c's) and for
`trained/sac_table_clearing_v2` (table clearing on the tray), with the
r5c file's tolerances.

Rebuild the files (JAX on the CPU, a few minutes each):

    JAX_PLATFORMS=cpu python tests/test_torch_eval_scenes.py --rebuild
    JAX_PLATFORMS=cpu python tests/test_torch_eval_scenes.py --rebuild \
        trained/bdq_simplified_r5
    JAX_PLATFORMS=cpu python tests/test_torch_eval_scenes.py --rebuild \
        trained/sac_full_flagship_r5b
    JAX_PLATFORMS=cpu python tests/test_torch_eval_scenes.py --rebuild \
        trained/sac_table_clearing_v2

`--episodes N` builds the N scenes of an N-episode protocol instead (the
JAX package's `run --episodes N` draws them in one batch), into
`<file>_<N>.npz`, for example the 500 of
`deep_rl_grasping_tpu_torch/data/simplified_r5_val_scenes_500.npz`, whose
first 100 scenes are those of the 100-scene file:

    JAX_PLATFORMS=cpu python tests/test_torch_eval_scenes.py --rebuild \
        trained/bdq_simplified_r5 --episodes 500

Another bundle whose config differs in no scene, curriculum, camera or
simulation key starts from the same scenes; check that it does (about a
minute; exit code 0 when every array is equal):

    JAX_PLATFORMS=cpu python tests/test_torch_eval_scenes.py \
        --compare trained/sac_encoder_flagship_r5
    JAX_PLATFORMS=cpu python tests/test_torch_eval_scenes.py \
        --compare trained/dqn_simplified_r5

(`--compare <bundle> <scenes npz>` compares with another file.)
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deep_rl_grasping_tpu_torch.algos import normalize as norm_mod  # noqa: E402
from deep_rl_grasping_tpu_torch.algos import sac  # noqa: E402
from deep_rl_grasping_tpu_torch.algos.bdq import BDQ  # noqa: E402
from deep_rl_grasping_tpu_torch.envs import grasp_env as tenv  # noqa: E402
from deep_rl_grasping_tpu_torch.envs import rewards as trew  # noqa: E402
from deep_rl_grasping_tpu_torch.training import train as ttrain  # noqa: E402
from deep_rl_grasping_tpu_torch.utils import io_utils  # noqa: E402

BUNDLE = os.path.join(REPO, "trained", "sac_full_flagship_r5c")
SCENES_R5C_VAL = os.path.join(REPO, "deep_rl_grasping_tpu_torch", "data", "r5c_val_scenes.npz")
BDQ_BUNDLE = os.path.join(REPO, "trained", "bdq_simplified_r5")
SCENES_SIMP_VAL = os.path.join(REPO, "deep_rl_grasping_tpu_torch", "data",
                               "simplified_r5_val_scenes.npz")
R5B_BUNDLE = os.path.join(REPO, "trained", "sac_full_flagship_r5b")
SCENES_R5B_VAL = os.path.join(REPO, "deep_rl_grasping_tpu_torch", "data", "r5b_val_scenes.npz")
CLEARING_BUNDLE = os.path.join(REPO, "trained", "sac_table_clearing_v2")
SCENES_CLEARING_VAL = os.path.join(REPO, "deep_rl_grasping_tpu_torch", "data",
                                   "clearing_v2_val_scenes.npz")
# the scenes file each bundle's JAX validation scenes are stored in
SCENE_FILES = {BUNDLE: SCENES_R5C_VAL, BDQ_BUNDLE: SCENES_SIMP_VAL, R5B_BUNDLE: SCENES_R5B_VAL,
               CLEARING_BUNDLE: SCENES_CLEARING_VAL}
N_EPISODES = 100  # the protocol
N_CHECK = 8       # envs whose observation and first step are stored


def _flat(s):
    """A JAX env state as the npz's flat arrays."""
    import dataclasses

    out = {}
    for part in ("gripper", "objects"):
        sub = getattr(s.sim, part)
        for f in dataclasses.fields(sub):
            out[f"{part}.{f.name}"] = np.asarray(getattr(sub, f.name))
    for f in tenv._ENV_FIELDS:
        out[f] = np.asarray(getattr(s, f))
    for f in tenv._REWARD_FIELDS:
        out[f"reward_state.{f}"] = np.asarray(getattr(s.reward_state, f))
    return out


def scene_file(bundle, n_episodes=N_EPISODES):
    """The npz of a bundle's JAX validation scenes for an n-episode protocol."""
    path = SCENE_FILES[bundle]
    return path if n_episodes == N_EPISODES else path[:-len(".npz")] + f"_{n_episodes}.npz"


def jax_val_scenes(bundle, n_episodes=N_EPISODES):
    """The JAX package's eval env of a bundle's config (with its trained
    encoder, and for BDQ its action interface, as the JAX trainer builds
    them) and the `n_episodes` states its protocol evaluation starts from."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from deep_rl_grasping_tpu.envs import grasp_env as jenv
    from deep_rl_grasping_tpu.training.trainer import _maybe_load_encoder
    from deep_rl_grasping_tpu.utils import config as jcfg

    cfg = jcfg.load_config(os.path.join(bundle, "config.yaml"))
    je = jenv.GraspEnv(cfg, evaluate=True, validate=True, encoder_fn=_maybe_load_encoder(cfg))
    if cfg.get("algorithm") == "bdq":
        je.branched_actions = True
        je.actuator_spec = dataclasses.replace(
            je.actuator_spec, num_actions_pad=int(cfg["BDQ"]["num_actions_pad"]))
    jb = jenv.BatchedGraspEnv(je, n_episodes, use_pallas=False)
    cur = jb.init_curriculum()
    cur = cur.replace(lam=jnp.asarray(1.0, jnp.float32))
    states, _ = jax.jit(jb.reset)(jax.random.PRNGKey(1), cur)
    return cfg, je, states


def same_scenes(bundle, path):
    """Whether another bundle's JAX validation scenes are the file's
    (run by hand, see the docstring); returns the keys that differ."""
    _, _, states = jax_val_scenes(bundle)
    got, data = _flat(states), np.load(path)
    stored = {k[len("scene."):] for k in data.files if k.startswith("scene.")}
    return sorted(k for k in stored | set(got) if k not in stored or k not in got
                  or not np.array_equal(data["scene." + k], got[k]))


def build_scenes(bundle=BUNDLE, n_episodes=N_EPISODES):
    """Build a bundle's npz with the JAX package (run by hand, see the
    docstring)."""
    import jax
    import jax.numpy as jnp

    from deep_rl_grasping_tpu.envs import grasp_env as jenv
    from deep_rl_grasping_tpu_torch.training.trainer import act
    from tests.test_torch_env import _pallas_obs

    path = scene_file(bundle, n_episodes)
    cfg, je, states = jax_val_scenes(bundle, n_episodes)

    first = jax.tree.map(lambda x: x[:N_CHECK], states)
    obs = _pallas_obs(je, first)
    _, policy, normalizer = ttrain.load_bundle_actor(bundle, "cpu")
    obs_in = torch.as_tensor(np.array(obs))
    if cfg.get("normalize", False):
        obs_in = norm_mod.normalize_obs(normalizer, obs_in)
    with torch.no_grad():
        actions = act(policy, obs_in, torch.Generator(), deterministic=True).numpy()
    jb8 = jenv.BatchedGraspEnv(je, N_CHECK, use_pallas=False)
    cur8 = jb8.init_curriculum()
    cur8 = cur8.replace(lam=jnp.asarray(1.0, jnp.float32))
    stepped, _, reward, done, _, _ = jax.jit(jb8.step)(first, jnp.asarray(actions), cur8)
    out = {f"scene.{k}": v for k, v in _flat(states).items()}
    out.update({f"step.{k}": v for k, v in _flat(stepped).items()})
    out.update({"obs": obs.astype(np.float32), "step.reward": np.asarray(reward),
                "step.done": np.asarray(done),
                "actions": actions if isinstance(policy, BDQ) else actions.astype(np.float32)})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **out)
    return path


def _part(data, prefix):
    return {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}


@pytest.fixture(scope="module")
def scenes():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    data = np.load(SCENES_R5C_VAL)
    config, actor, normalizer = ttrain.load_bundle_actor(BUNDLE, "cpu")
    env = tenv.GraspEnv(config, evaluate=True, validate=True, device="cpu")
    states = tenv.env_state_from_numpy(_part(data, "scene."))
    yield data, config, actor, normalizer, env, states
    torch.set_num_threads(n)


def _first(states, n=N_CHECK):
    import dataclasses

    def cut(x):
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: cut(getattr(x, f.name)) for f in dataclasses.fields(x)})
        return x[:n]
    return cut(states)


def test_scenes_load_into_the_port(scenes):
    """100 fresh episodes of the eval env's shapes, drawn from the
    validation object split, at lambda 1."""
    data, _, _, _, env, states = scenes
    assert states.episode_step.shape == (N_EPISODES,)
    assert states.sim.objects.pos.shape == (N_EPISODES, env.max_slots, 3)
    assert bool((states.episode_step == 0).all()) and bool((states.status == trew.RUNNING).all())
    alive_types = states.sim.objects.obj_type[states.sim.objects.alive]
    assert bool(torch.isin(alive_types, env.type_ids).all())
    # lambda 1: up to the curriculum's most objects, lift at its full distance
    assert int(states.sim.objects.alive.sum(-1).max()) <= env.max_slots
    assert float(states.lift_dist.min()) == pytest.approx(0.1)
    assert all(bool(torch.isfinite(t).all()) for t in
               (states.sim.objects.pos, states.sim.objects.quat, states.sim.gripper.q))
    # the round trip through numpy is exact
    again = tenv.env_state_to_numpy(states)
    for k, v in _part(data, "scene.").items():
        np.testing.assert_array_equal(again[k], v.astype(again[k].dtype), err_msg=k)


def test_first_observation_matches_jax(scenes):
    data, _, _, _, env, states = scenes
    benv = tenv.BatchedGraspEnv(env, N_CHECK, torch.Generator().manual_seed(0))
    obs = benv.observe_batch(_first(states)).numpy()
    ref = data["obs"]
    assert obs.shape == ref.shape == (N_CHECK, 64, 64, 2)
    off = np.abs(obs - ref) > 1e-4
    assert off.mean() <= 1e-3, f"{off.sum()} observation values differ by more than 1e-4"
    np.testing.assert_allclose(obs[:, 0, 0, -1], ref[:, 0, 0, -1], atol=1e-5)
    assert (ref[..., 0] > 0).mean() > 0.99  # a real depth image, not an empty one


def test_one_control_step_matches_jax(scenes):
    """The r5c actor's deterministic action on the port's observation
    agrees with the stored one; one control step with the stored actions
    matches the JAX step, and is bit-equal when repeated."""
    data, config, actor, normalizer, env, states = scenes
    benv = tenv.BatchedGraspEnv(env, N_CHECK, torch.Generator().manual_seed(0))
    first = _first(states)
    obs = benv.observe_batch(first)
    obs_in = norm_mod.normalize_obs(normalizer, obs) if config.get("normalize") else obs
    with torch.no_grad():
        act = sac.act(actor, obs_in, torch.Generator(), deterministic=True)
    np.testing.assert_allclose(act.numpy(), data["actions"], atol=2e-2, rtol=0)
    cur = benv.init_curriculum()
    cur = cur.replace(lam=torch.full_like(cur.lam, 1.0))
    actions = torch.as_tensor(data["actions"])
    runs = [benv.step(first, actions, cur) for _ in range(2)]
    (s1, o1, r1, d1, _, _), (s2, o2, r2, d2, _, _) = runs
    assert torch.equal(o1, o2) and torch.equal(r1, r2) and torch.equal(d1, d2)
    assert torch.equal(s1.sim.objects.pos, s2.sim.objects.pos)
    ref = _part(data, "step.")
    np.testing.assert_array_equal(d1.numpy(), ref["done"])
    np.testing.assert_allclose(r1.numpy(), ref["reward"], atol=1e-2, rtol=0)
    got = tenv.env_state_to_numpy(s1)
    live = ~ref["done"]
    for key in ("gripper.q", "objects.pos"):
        np.testing.assert_allclose(got[key][live], ref[key][live], atol=1e-5, rtol=0, err_msg=key)
    # the step moved the grippers (the policy acts, it is not a no-op)
    moved = np.abs(ref["gripper.q"][:, :3] - data["scene.gripper.q"][:N_CHECK, :3])
    assert float(moved.max()) > 1e-3


def test_evaluate_starts_from_given_states(scenes):
    """`EvalMixin.evaluate(initial_states=...)` runs the protocol from the
    stored scenes (here 8 of them, with a one-step horizon) and refuses a
    batch of the wrong size."""
    from deep_rl_grasping_tpu_torch.training.trainer import Evaluator

    _, config, actor, normalizer, _, states = scenes
    cfg = dict(config, time_horizon=1)
    states = _first(states)
    res = Evaluator(cfg, device="cpu").evaluate(actor, normalizer, n_episodes=N_CHECK,
                                                initial_states=states)
    assert res["episodes"] == N_CHECK and res["control_steps"] == 1
    assert res["mean_length"] == 1.0 and np.isfinite(res["mean_return"])
    with pytest.raises(ValueError):
        Evaluator(cfg, device="cpu").evaluate(actor, normalizer, n_episodes=N_CHECK + 1,
                                              initial_states=states)


# ------------------------------------------------------------------ r5b, clearing

@pytest.fixture(scope="module", params=["r5b", "clearing_v2"])
def more_scenes(request):
    """The JAX validation scenes of `trained/sac_full_flagship_r5b` (the
    default object-object solver options; r5c's scenes do not serve it:
    `--compare` finds the object poses differ) and of
    `trained/sac_table_clearing_v2` (table clearing on the tray, a
    200-step horizon)."""
    bundle = {"r5b": R5B_BUNDLE, "clearing_v2": CLEARING_BUNDLE}[request.param]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    data = np.load(SCENE_FILES[bundle])
    config, actor, normalizer = ttrain.load_bundle_actor(bundle, "cpu")
    env = tenv.GraspEnv(config, evaluate=True, validate=True, device="cpu")
    states = tenv.env_state_from_numpy(_part(data, "scene."))
    yield request.param, data, config, actor, normalizer, env, states
    torch.set_num_threads(n)


def test_more_scenes_load_and_match_jax(more_scenes):
    """100 fresh episodes at lambda 1 of each bundle's own config (the
    clearing env on the tray, r5b's without the object-object knobs); the
    port's first observation of 8 of them against the JAX package's Pallas
    render (tolerances as for r5c); the bundle's deterministic action on it
    against the stored one; one control step with the stored actions
    against the JAX step: dones and statuses exactly, rewards to 1e-2,
    gripper coordinates and object positions to 1e-5 m, alive flags
    exactly."""
    name, data, config, actor, normalizer, env, states = more_scenes
    assert states.episode_step.shape == (N_EPISODES,)
    assert env.reward_spec.table_clearing == (name == "clearing_v2")
    assert env.sim_params.has_tray == (name == "clearing_v2")
    assert env.time_horizon == {"r5b": 150, "clearing_v2": 200}[name]
    assert env.sim_params.oo_pass_stride == {"r5b": 1, "clearing_v2": 2}[name]
    assert bool(torch.isin(states.sim.objects.obj_type[states.sim.objects.alive],
                           env.type_ids).all())
    assert float(states.lift_dist.min()) == pytest.approx(0.1)
    again = tenv.env_state_to_numpy(states)
    for k, v in _part(data, "scene.").items():
        np.testing.assert_array_equal(again[k], v.astype(again[k].dtype), err_msg=k)
    benv = tenv.BatchedGraspEnv(env, N_CHECK, torch.Generator().manual_seed(0))
    first = _first(states)
    obs = benv.observe_batch(first)
    off = np.abs(obs.numpy() - data["obs"]) > 1e-4
    assert off.mean() <= 1e-3, f"{off.sum()} observation values differ by more than 1e-4"
    obs_in = norm_mod.normalize_obs(normalizer, obs) if config.get("normalize") else obs
    with torch.no_grad():
        act = sac.act(actor, obs_in, torch.Generator(), deterministic=True)
    np.testing.assert_allclose(act.numpy(), data["actions"], atol=2e-2, rtol=0)
    cur = benv.init_curriculum()
    cur = cur.replace(lam=torch.full_like(cur.lam, 1.0))
    with torch.no_grad():
        s1, _, r1, d1, _, _ = benv.step(first, torch.as_tensor(data["actions"]), cur)
    ref = _part(data, "step.")
    np.testing.assert_array_equal(d1.numpy(), ref["done"])
    np.testing.assert_allclose(r1.numpy(), ref["reward"], atol=1e-2, rtol=0)
    got = tenv.env_state_to_numpy(s1)
    live = ~ref["done"]
    np.testing.assert_array_equal(got["status"][live], ref["status"][live])
    np.testing.assert_array_equal(got["objects.alive"], ref["objects.alive"])
    for key in ("gripper.q", "objects.pos"):
        np.testing.assert_allclose(got[key][live], ref[key][live], atol=1e-5, rtol=0, err_msg=key)


# ------------------------------------------------------------------ simplified

@pytest.fixture(scope="module")
def simp_scenes():
    from deep_rl_grasping_tpu_torch.training.trainer import (_maybe_load_encoder,
                                                             set_action_interface)

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    data = np.load(SCENES_SIMP_VAL)
    config, policy, _ = ttrain.load_bundle_actor(BDQ_BUNDLE, "cpu")
    env = tenv.GraspEnv(config, evaluate=True, validate=True, device="cpu",
                        encoder=_maybe_load_encoder(config, "cpu"))
    set_action_interface(env, "BDQ", config)
    states = tenv.env_state_from_numpy(_part(data, "scene."))
    yield data, config, policy, env, states
    torch.set_num_threads(n)


def test_simplified_scenes_load_into_the_port(simp_scenes):
    """100 fresh episodes at lambda 1: the gripper at the curriculum's
    highest start (0.27 m), up to 5 objects of the validation split."""
    data, _, _, env, states = simp_scenes
    assert env.simplified and env.branched_actions and env.actuator_spec.num_actions_pad == 8
    assert states.sim.objects.pos.shape == (N_EPISODES, env.max_slots, 3)
    assert bool((states.episode_step == 0).all()) and bool((states.status == trew.RUNNING).all())
    np.testing.assert_allclose(states.sim.gripper.q[:, 2].numpy(), 0.27, atol=1e-6)
    np.testing.assert_allclose(states.reward_state.old_height.numpy(), 0.27, atol=1e-6)
    alive_types = states.sim.objects.obj_type[states.sim.objects.alive]
    assert bool(torch.isin(alive_types, env.type_ids).all())
    again = tenv.env_state_to_numpy(states)
    for k, v in _part(data, "scene.").items():
        np.testing.assert_array_equal(again[k], v.astype(again[k].dtype), err_msg=k)


def test_simplified_first_observation_and_bins_match_jax(simp_scenes):
    """The port's latents of the first 8 scenes to 3e-2 of the JAX ones; the
    BDQ policy's greedy bins on them equal to the stored ones wherever the
    top two Q values of a branch are further apart than twice the largest
    change the port's observation makes to any Q value."""
    data, _, policy, env, states = simp_scenes
    benv = tenv.BatchedGraspEnv(env, N_CHECK, torch.Generator().manual_seed(0))
    with torch.no_grad():
        obs = benv.observe_batch(_first(states))
        q_own = policy.net(obs).numpy()
        q_ref = policy.net(torch.as_tensor(data["obs"])).numpy()
    assert obs.shape == data["obs"].shape == (N_CHECK, 100)
    np.testing.assert_allclose(obs.numpy(), data["obs"], atol=3e-2, rtol=0)
    np.testing.assert_array_equal(q_ref.argmax(-1), data["actions"])
    top2 = np.sort(q_ref, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 2 * np.abs(q_own - q_ref).max()
    np.testing.assert_array_equal(q_own.argmax(-1)[clear], data["actions"][clear])
    assert clear.any()


def test_simplified_one_control_step_matches_jax(simp_scenes):
    """The simplified three-call step with the stored bins: rewards, dones
    and statuses exactly, gripper coordinates and object positions of the
    envs that go on to 1e-4 m; bit-equal when repeated."""
    data, _, _, env, states = simp_scenes
    benv = tenv.BatchedGraspEnv(env, N_CHECK, torch.Generator().manual_seed(0))
    cur = benv.init_curriculum()
    cur = cur.replace(lam=torch.full_like(cur.lam, 1.0))
    first, bins = _first(states), torch.as_tensor(data["actions"])
    with torch.no_grad():
        runs = [benv.step(first, bins, cur) for _ in range(2)]
    (s1, o1, r1, d1, i1, _), (s2, o2, r2, d2, _, _) = runs
    assert torch.equal(o1, o2) and torch.equal(r1, r2) and torch.equal(d1, d2)
    assert torch.equal(s1.sim.objects.pos, s2.sim.objects.pos)
    ref = _part(data, "step.")
    np.testing.assert_array_equal(d1.numpy(), ref["done"])
    np.testing.assert_array_equal(r1.numpy(), ref["reward"])
    got = tenv.env_state_to_numpy(s1)
    live = ~ref["done"]
    np.testing.assert_array_equal(got["status"][live], ref["status"][live])
    for key in ("gripper.q", "gripper.target", "objects.pos"):
        np.testing.assert_allclose(got[key][live], ref[key][live], atol=1e-4, rtol=0, err_msg=key)
    # the step descended 5 mm and moved the grippers sideways by the bins
    np.testing.assert_allclose(got["gripper.target"][live, 2], 0.265, atol=1e-6)
    assert float(np.abs(ref["gripper.q"][:, :2]).max()) > 1e-2


if __name__ == "__main__":
    usage = ("usage: JAX_PLATFORMS=cpu python tests/test_torch_eval_scenes.py "
             "--rebuild [<bundle dir>] [--episodes N] | --compare <bundle dir> [<scenes npz>]")
    argv = sys.argv[1:]
    n_episodes = N_EPISODES
    if "--episodes" in argv:
        i = argv.index("--episodes")
        n_episodes = int(argv[i + 1])
        del argv[i:i + 2]
    if not argv or argv[0] not in ("--rebuild", "--compare"):
        raise SystemExit(usage)
    import jax

    jax.config.update("jax_platforms", "cpu")
    if argv[0] == "--rebuild":
        print("wrote", build_scenes(os.path.abspath(argv[1]) if len(argv) > 1 else BUNDLE,
                                    n_episodes))
    else:
        cfg = io_utils.load_yaml(os.path.join(argv[1], "config.yaml"))
        path = SCENES_SIMP_VAL if cfg.get("simplified") else SCENES_R5C_VAL
        if len(argv) > 2:
            path = os.path.abspath(argv[2])
        differ = same_scenes(argv[1], path)
        print(f"{argv[1]}: validation scenes", "differ in " + ", ".join(differ) if differ
              else f"equal to {os.path.relpath(path, REPO)}")
        sys.exit(1 if differ else 0)
