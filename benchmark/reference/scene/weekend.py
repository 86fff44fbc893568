"""The frozen generator of the `weekend` scene kind's mesh and sky.

Frozen copies of the port's `scene.presets.uv_sphere` (the lat-long unit
sphere every sphere of the scene instances) and `book_sky` (the sky of
Ray Tracing in One Weekend as a lat-long radiance texture), numpy only.
The scene kind builds them once and hands the same arrays to the program
and to the reference.
"""

import numpy as np


def uv_sphere(stacks, slices):
    """Lat-long unit sphere; front faces outward under the left-handed
    cross(v0v2, v0v1) convention. Returns (positions (V, 3) f32, indices
    (T, 3) int64): 2 * stacks * slices - 2 * slices triangles."""
    verts = []
    for i in range(stacks + 1):
        th = np.pi * i / stacks
        for j in range(slices + 1):
            ph = 2.0 * np.pi * j / slices
            verts.append((np.sin(th) * np.cos(ph), np.cos(th),
                          np.sin(th) * np.sin(ph)))
    verts = np.asarray(verts, np.float32)
    idx = []
    for i in range(stacks):
        for j in range(slices):
            a = i * (slices + 1) + j
            b = a + slices + 1
            if i > 0:
                idx.append([a, b, a + 1])
            if i < stacks - 1:
                idx.append([a + 1, b, b + 1])
    return verts, np.asarray(idx, np.int64)


def book_sky(height, width):
    """(height, width, 3) f32 lat-long radiance: white lerped to (0.5, 0.7,
    1.0) by t = 0.5 (y + 1), y the height of the direction at each texel
    centre (row i at polar angle pi (i + 0.5) / height)."""
    y = np.cos(np.pi * (np.arange(height) + 0.5) / height)
    t = (0.5 * (y + 1.0))[:, None]
    rgb = (1.0 - t) + t * np.asarray([0.5, 0.7, 1.0])
    return np.ascontiguousarray(np.broadcast_to(
        rgb[:, None, :], (height, width, 3)), dtype=np.float32)
