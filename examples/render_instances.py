"""Instancing demo: a ring of dragons from ONE shared MeshAsset.

Shows Scene.from_instances (scene/instancing.py): shared geometry placed
under affine transforms, flattened into one BVH so the traversal walks a
single table.  Writes instances.png (+ optional
instances.pfm with --hdr).

    python examples/render_instances.py [--n 8] [--steps 64]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from tyrant_tpu.camera import Camera
from tyrant_tpu.config import RenderConfig
from tyrant_tpu.render import Renderer
from tyrant_tpu.scene.instancing import MeshAsset, rotate_y, scale, translate
from tyrant_tpu.scene.scene import Scene

DRAGON = "/root/reference/PathTracer/Data/dragon.ply"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8, help="instances in the ring")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--rays", type=int, default=1 << 19)
    ap.add_argument("--out", default="instances.png")
    ap.add_argument("--hdr", default=None)
    args = ap.parse_args()

    dragon = MeshAsset.load(DRAGON, scale=60.0)
    ring = 55.0
    insts = []
    for i in range(args.n):
        th = 2 * np.pi * i / args.n
        pos = [ring * np.sin(th), ring * np.cos(th) - 40.0, -20.0]
        s = 0.7 + 0.5 * (i % 3) / 2
        insts.append((0, translate(pos) @ rotate_y(th) @ scale(s)))
    scene = Scene.from_instances([dragon], insts, builder="auto")
    print("scene:", scene.stats)

    cfg = RenderConfig(width=args.width, height=args.height,
                       num_rays=args.rays)
    cam = Camera()
    cam.position = np.array([0.0, -150.0, 25.0], np.float32)
    cam.vertical_angle = -0.25
    r = Renderer(scene, cfg)
    for i in range(args.steps):
        r.step(cam)
    from tyrant_tpu.ops.tonemap import to_uint8
    img = np.asarray(to_uint8(r.image()))
    from PIL import Image
    Image.fromarray(img).save(args.out)
    print("wrote", args.out)
    if args.hdr:
        from tyrant_tpu.utils.pfm import write_pfm
        write_pfm(args.hdr, np.asarray(r.radiance()))
        print("wrote", args.hdr)


if __name__ == "__main__":
    main()
