"""Native (C++) host components, loaded through ctypes.

The port's own copy of the reference's `ops` package: `native` holds the
C++ SAH BVH builder that `accel.build.build_bvh` uses by default. It is
host code, run once a scene at load time, not a GPU kernel.
"""
