"""peak_mem_gib: `torch.cuda.max_memory_allocated` over the window, in
GiB: what a speed-up paid for in chunk or pool size. Layer: renderer."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2**30
