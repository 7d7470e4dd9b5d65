"""Host brute-force ground truth for specific rays of the bench scene.

    python tools/bruteforce_rays.py RAY_INDEX [RAY_INDEX ...]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

from bench import N_RAYS, SCENE_RES, headline_rays
from embree_tpu.verify.fixtures import bruteforce_closest, triangle_sphere

verts, idx = triangle_sphere((0.0, 0.0, 0.0), 2.0, SCENE_RES)
org, d = headline_rays(N_RAYS)

v = np.asarray(verts)
i = np.asarray(idx)
rows = [int(a) for a in sys.argv[1:]]
t, prim = bruteforce_closest(v[i[:, 0]], v[i[:, 1]], v[i[:, 2]],
                             org[rows], d[rows])
for r, tr, pr in zip(rows, t, prim):
    print(f"ray {r}: HIT prim={pr} t={tr:.6f}" if pr >= 0 else
          f"ray {r}: MISS")
