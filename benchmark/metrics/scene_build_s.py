"""scene_build_s: host seconds from the benchmark's inputs to a
constructed `Renderer`: writing the scene files, the program's loaders,
its flatten (BVH builds, cluster tables) and the tables' move to the
card. Layer: scene and flatten."""


def read(run):
    return run.scene_build_s
