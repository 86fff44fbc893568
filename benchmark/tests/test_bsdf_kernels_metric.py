"""`bsdf_kernels_per_spp` on synthetic traces: the spans of the two BSDF
kernels per traced sample, nothing to read where neither ran."""

from benchmark.named import load
from benchmark.run import Run


def _run(device_ops, samples=2):
    trace = {"device_ops": device_ops, "host_ops": [], "samples": samples}
    return Run(spp_per_pass=1, setup_s=1.0, scene_build_s=0.1,
               pass_s=[0.3, 0.3], window_s=0.6, samples=2,
               window_peak_bytes=0, launches={}, alpha_calls=0,
               alpha_passes=0, trace=trace)


def _read(run):
    return load("metrics", "bsdf_kernels_per_spp").read(run)


EVAL = "(anonymous namespace)::bsdf_eval_kernel((anonymous namespace)::Args)"
SAMPLE = ("(anonymous namespace)::bsdf_sample_kernel((anonymous "
          "namespace)::Args, float*)")


def test_counts_both_kernels_per_sample():
    ops = []
    for k in range(10):   # two passes of five bounces
        ops += [(EVAL, 10.0 * k, 10.0 * k + 1), ("void at::native::"
                "elementwise_kernel<128, 2>", 10.0 * k + 2, 10.0 * k + 3),
                (SAMPLE, 10.0 * k + 4, 10.0 * k + 5)]
    ops.append(("void (anonymous namespace)::closest_kernel<"
                "MoellerSieve>(float const*)", 200.0, 201.0))
    assert _read(_run(ops)) == 10.0
    assert _read(_run(ops, samples=4)) == 5.0


def test_nothing_to_read_without_the_kernels():
    assert _read(_run([("void at::native::elementwise_kernel", 0.0, 1.0)]))\
        is None
    assert _read(_run([])) is None
    assert _read(Run(spp_per_pass=1, setup_s=1.0, scene_build_s=0.1,
                     pass_s=[0.3], window_s=0.3, samples=1,
                     window_peak_bytes=0, launches={}, alpha_calls=0,
                     alpha_passes=0, trace=None)) is None
