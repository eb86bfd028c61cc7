"""The PyTorch port's numpy-only copies and its import boundary.

* The object library is the JAX package's, array for array (exact: both are
  the same numpy code with the same seed).
* The port's YAML reader gives what `yaml.safe_load` gives on every config
  the repo ships (exact equality of the parsed trees).
* No module of the port, and not chip_smoke.py, imports JAX, Flax, Optax,
  PyYAML, torch.utils.cpp_extension or the JAX package.
"""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from deep_rl_grasping_tpu.sim import objects as jobj
from deep_rl_grasping_tpu_torch.sim import objects as tobj
from deep_rl_grasping_tpu_torch.utils import config as tcfg
from deep_rl_grasping_tpu_torch.utils import io_utils

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "deep_rl_grasping_tpu_torch")

LIB_FIELDS = ["centers", "radii", "oo_centers", "oo_radii", "mass", "inv_mass",
              "inv_inertia", "color", "bound_radius"]


@pytest.mark.parametrize("spheres,oo", [(8, 3), (8, 4), (4, 2)])
def test_object_library_matches_jax(spheres, oo):
    a = jobj.ObjectLibrary(spheres, oo_spheres=oo)
    b = tobj.ObjectLibrary(spheres, oo_spheres=oo)
    for f in LIB_FIELDS:
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    np.testing.assert_array_equal(b.shape_class, a.shape_class)
    for split in (dict(), dict(validate=True), dict(test=True)):
        np.testing.assert_array_equal(b.random_urdf_ids(**split), a.random_urdf_ids(**split))
    assert len(b.random_urdf_ids(validate=True)) == 150
    assert len(b.random_urdf_ids(test=True)) == 150
    assert len(b.random_urdf_ids()) == 700


CONFIG_FILES = sorted(
    glob.glob(os.path.join(REPO, "configs", "*.yaml"))
    + glob.glob(os.path.join(REPO, "trained", "*", "config.yaml"))
)


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_yaml_reader_matches_pyyaml(path):
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert io_utils.load_yaml(path) == ref


def test_yaml_reader_scalars_and_flow():
    text = """
# comment
a: 1            # int
b: 1.0e-4       # float (needs a dot in YAML 1.1)
c: 1e-4         # a string in YAML 1.1
d: [1, [2, 3], {x: "q # not a comment", y: null}]
e:
- 0.
- True
- off
f: {}
g:
  h: ~
  i: 'it''s'
"""
    assert io_utils.parse_yaml(text) == yaml.safe_load(text)


def test_load_config_fills_defaults_like_jax():
    from deep_rl_grasping_tpu.utils import config as jcfg

    path = os.path.join(REPO, "trained", "sac_full_flagship_r5c", "config.yaml")
    assert tcfg.load_config(path) == jcfg.load_config(path)
    assert tcfg.resolve_path("configs/camera_info.yaml") == jcfg.resolve_path(
        "configs/camera_info.yaml")


def _port_sources():
    files = sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True))
    return files + [os.path.join(REPO, "chip_smoke.py")]


BANNED = ("jax", "flax", "optax", "yaml", "deep_rl_grasping_tpu", "torch.utils.cpp_extension")


def test_port_sources_import_nothing_banned():
    """Static check of every import statement, including imports inside
    functions."""
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                for banned in BANNED:
                    assert not (name == banned or name.startswith(banned + ".")), (
                        f"{os.path.relpath(path, REPO)} imports {name}")
        with open(path) as f:
            src = f.read()
        assert "import deep_rl_grasping_tpu." not in src
        assert "from deep_rl_grasping_tpu." not in src
        assert "cpp_extension" not in src


def test_port_imports_with_jax_and_yaml_blocked():
    """Import every module of the port in a fresh interpreter where jax,
    flax, optax, yaml and the JAX package cannot be imported."""
    code = f"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "yaml", "deep_rl_grasping_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {REPO!r})
import deep_rl_grasping_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import runpy
runpy.run_path({os.path.join(REPO, "chip_smoke.py")!r}, run_name="not_main")
print(" ".join(mods))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.strip().splitlines()[-1].split())
    assert len(mods) >= 27
    pkg = "deep_rl_grasping_tpu_torch."
    assert {pkg + m for m in ("algos.replay", "algos.sac", "envs.scripted", "envs.curriculum",
                              "training.callbacks", "training.trainer", "training.train",
                              "utils.tb_events", "models.networks", "algos.ddpg", "algos.ppo",
                              "algos.trpo", "training.onpolicy", "models.autoencoder",
                              "training.collect_dataset", "training.train_encoder")} <= mods


def test_chip_smoke_refuses_without_a_card():
    """On a machine without CUDA the smoke exits non-zero and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the refusal path needs one without")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
