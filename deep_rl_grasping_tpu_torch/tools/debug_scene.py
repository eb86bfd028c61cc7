"""Headless scene inspector (port of scripts/debug_scene.py).

    python -m deep_rl_grasping_tpu_torch.tools.debug_scene \
        [--config configs/gripper_grasp.yaml] [--agent random|scripted] \
        [--steps 20] [--out debug_scene_out] [--seed 0] [--device cuda|cpu]

Steps a random or scripted agent (agents/agents.py) in the gym adapter
(envs/gym_adapter.py) and writes, before each step, the wrist camera's RGB,
depth and segmentation side by side as <out>/step_NNN.png, each pixel
drawn SCALE x SCALE. The images come from the raster kernel
(ops/raster_cuda.py `render_batch`; its plain version on the CPU), the
renderer the env observes through. Depth is grey, white at the image's
nearest pixel and black at its farthest; segment ids get fixed colours, the background
(id 0) black. The JAX script draws with matplotlib; this one writes the
PNG itself with zlib and struct, since the card's machine has neither
matplotlib nor PIL. Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np
import torch

SCALE = 4
# segment id -> RGB, a fixed spread of colours; id 0 (background) black
PALETTE = ((np.arange(256)[:, None] * np.array([97, 57, 151]) + np.array([40, 80, 120]))
           % 256).astype(np.uint8)
PALETTE[0] = 0


def write_png(path, rgb):
    """An 8-bit RGB PNG of `rgb` (H, W, 3) uint8."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def read_png(path):
    """The (H, W, 3) uint8 pixels of a PNG that `write_png` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return rows[:, 1:].reshape(h, w, 3)


def camera_images(env):
    """The wrist camera's (rgb, depth, seg) of the adapter's env, as numpy."""
    from deep_rl_grasping_tpu_torch.ops import raster_cuda
    from deep_rl_grasping_tpu_torch.render import raycast

    e, state = env.env, env._state
    cam_pos, cam_R = raycast.camera_pose_from_gripper(state.sim.gripper.q, state.cam_t,
                                                      state.cam_R)
    rgb, depth, seg = raster_cuda.render_batch(state.sim, e.sim_params, cam_pos, cam_R,
                                               state.intrinsics, H=e.im_h, W=e.im_w,
                                               near=e.near, far=e.far, with_rgb=True)
    return rgb[0].cpu().numpy(), depth[0].cpu().numpy(), seg[0].cpu().numpy()


def panel(rgb, depth, seg):
    """RGB | depth | seg side by side, uint8, each pixel SCALE x SCALE."""
    lo, hi = float(depth.min()), float(depth.max())
    grey = (hi - depth) / max(hi - lo, 1e-6)
    parts = [np.clip(rgb, 0.0, 1.0), np.repeat(grey[..., None], 3, -1)]
    img = np.concatenate([(p * 255.0 + 0.5).astype(np.uint8) for p in parts]
                         + [PALETTE[seg.astype(np.int64) % 256]], 1)
    return np.repeat(np.repeat(img, SCALE, 0), SCALE, 1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="configs/gripper_grasp.yaml")
    p.add_argument("--agent", choices=["random", "scripted"], default="random")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--out", default="debug_scene_out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from deep_rl_grasping_tpu_torch.agents.agents import RandomAgent, ScriptedGraspAgent
    from deep_rl_grasping_tpu_torch.envs.gym_adapter import GymGraspEnv

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to run on the CPU")
    env = GymGraspEnv(args.config, seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    agent = RandomAgent(env, rng) if args.agent == "random" else ScriptedGraspAgent(env, rng)
    os.makedirs(args.out, exist_ok=True)
    obs = env.reset()
    frames = []
    for t in range(args.steps):
        path = os.path.join(args.out, f"step_{t:03d}.png")
        write_png(path, panel(*camera_images(env)))
        frames.append(path)
        obs, reward, done, _info = env.step(agent.act(obs))
        pos, _ = env.get_pose()
        print(f"step {t}: reward {reward:.2f} done {done} pos {np.round(pos, 3)} "
              f"width {env.get_gripper_width():.3f}")
        if done:
            obs = env.reset()
            if hasattr(agent, "reset"):
                agent.reset()
    print(f"wrote {len(frames)} frames to {args.out}/")
    return frames


if __name__ == "__main__":
    main()
