"""bsdf_kernels_per_spp: the device spans of the BSDF kernels
(`bsdf_eval_kernel`, `bsdf_sample_kernel`) in the traced passes, per
traced sample: the fused BSDF's engagement, one evaluation (NEE) and one
sample a bounce. Layer: integrator. Nothing to read where the program
launched neither kernel."""

KERNELS = ("bsdf_eval_kernel", "bsdf_sample_kernel")


def read(run):
    t = run.trace
    if not t or not t["device_ops"] or not t["samples"]:
        return None
    spans = sum(1 for name, _, _ in t["device_ops"]
                if any(k in name for k in KERNELS))
    return spans / t["samples"] if spans else None
