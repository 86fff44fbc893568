"""Shared constants and bit-layout definitions, numpy only.

The port's own copy of `directcomputeraytracing_tpu.core.constants`
(the reference renderer's Shaders/CppTypes.h and *SharedDef.inc.hlsl
family): material, light, BVH and LUT layouts. The tests hold every
value equal to the JAX package's.
"""

import numpy as np

# ---------------------------------------------------------------------------
# Math
# ---------------------------------------------------------------------------
PI = float(np.pi)
PI_MUL_2 = float(2.0 * np.pi)
INV_PI = float(1.0 / np.pi)
FLT_INF = float(np.inf)
SHADOW_EPSILON = 1e-3

# ---------------------------------------------------------------------------
# Material model (reference: Shaders/Material.inc.hlsl:6-21, Source/Material.h:5-12)
# ---------------------------------------------------------------------------
MATERIAL_TYPE_DIFFUSE = 0
MATERIAL_TYPE_PLASTIC = 1
MATERIAL_TYPE_CONDUCTOR = 2
MATERIAL_TYPE_DIELECTRIC = 3
MATERIAL_TYPE_THIN_DIELECTRIC = 4

MATERIAL_FLAG_TYPE_MASK = 0x0000000F
MATERIAL_FLAG_ALBEDO_TEXTURE = 0x10
MATERIAL_FLAG_ROUGHNESS_TEXTURE = 0x20
MATERIAL_FLAG_IS_TWOSIDED = 0x40
MATERIAL_FLAG_MULTISCATTERING = 0x80
MATERIAL_FLAG_INTERNAL_SCATTERING_SHIFT = 8
MATERIAL_FLAG_INTERNAL_SCATTERING_MASK = 0x00000300

# Internal scattering handling for the plastic BRDF's diffuse substrate
# (reference: Shaders/InternalScatteringMode.inc.hlsl)
INTERNAL_SCATTERING_MODE_IGNORE = 0
INTERNAL_SCATTERING_MODE_ONCE = 1
INTERNAL_SCATTERING_MODE_MULTIPLE = 2

# Clamps applied by the scene editor/ingestion (reference: Source/Constants.h:3-5)
MAX_MATERIAL_IOR = 3.0
MAX_MATERIAL_ETA = 7.0
MAX_MATERIAL_K = 9.5

# Below this GGX alpha the lobe is treated as a perfect-specular delta
# (reference: Shaders/BSDFs.inc.hlsl:12)
ALPHA_THRESHOLD = 0.00052441

# ---------------------------------------------------------------------------
# Lights (reference: Shaders/LightSharedDef.inc.hlsl:6-13)
# ---------------------------------------------------------------------------
LIGHT_INDEX_INVALID = 0xFFFFFFFF
LIGHT_FLAGS_POINT = 0x1
LIGHT_FLAGS_MESH = 0x2
LIGHT_FLAGS_DIRECTIONAL = 0x4
LIGHT_FLAGS_ENVIRONMENT = 0x8

MAX_LIGHTS_COUNT = 5000  # reference: Source/Scene.h:109

# ---------------------------------------------------------------------------
# BVH node layout (reference: Shaders/BVHNode.inc.hlsl:8-14,
# BVHSharedDef.inc.hlsl:4, Source/BVHAccel.cpp:413-447)
#
# SoA arrays: bbox_min (N,3) f32, bbox_max (N,3) f32,
#             right_or_prim (N,) u32, misc (N,) u32.
#   interior node: misc = split_axis (bits 0-1); right_or_prim = right child
#                  (left child is node_index + 1, depth-first layout)
#   BLAS leaf:     misc = prim_count << 3 | split_axis; right_or_prim = first
#                  primitive index (prims reordered into leaf order)
#   TLAS leaf:     misc = instance_index << 3 | 0x4; right_or_prim = BLAS root
#                  node offset in the concatenated node buffer
# ---------------------------------------------------------------------------
BVHNODE_MISC_MASK_PRIMITIVE_COUNT = 0x1FFFFFFF
BVHNODE_MISC_HAS_BLAS = 0x4
BVHNODE_MISC_SPLIT_AXIS_MASK = 0x3
BVHNODE_MISC_COUNT_SHIFT = 3

# Traversal stack node-index packing (reference: Shaders/BVHAccel.inc.hlsl:32-41)
BVH_STACK_IS_BLAS_BIT = np.uint32(0x80000000)
BVH_STACK_INDEX_MASK = np.uint32(0x7FFFFFFF)

MAX_BVH_DEPTH = 40  # reference: Source/BVHAccel.h (sanity bound for stack sizing)
MAX_RAY_BOUNCE = 20  # reference: Source/Scene.h:108

# ---------------------------------------------------------------------------
# Instances (reference: Shaders/InstanceSharedDef.inc.hlsl)
# ---------------------------------------------------------------------------
INSTANCE_FLAG_OPAQUE = 0x1
INSTANCE_MATERIAL_OVERRIDE_NONE = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# Kulla-Conty energy LUT dimensions (reference: Shaders/BxDFTextureDef.inc.hlsl)
# ---------------------------------------------------------------------------
BXDFTEX_BRDF_SIZE_X = 32  # cosTheta
BXDFTEX_BRDF_SIZE_Y = 32  # alpha
BXDFTEX_BRDF_DIELECTRIC_SIZE_X = 32  # cosTheta
BXDFTEX_BRDF_DIELECTRIC_SIZE_Y = 16  # alpha
BXDFTEX_BRDF_DIELECTRIC_SIZE_Z = 16  # eta in [1, 3]
