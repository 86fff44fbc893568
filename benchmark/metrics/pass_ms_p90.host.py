"""pass_ms_p90.host: the 90th percentile of the window's pass times, in
ms (host clock around each `Renderer.render` call, which returns the
resolved image): the frame time an interactive user feels. The card
idles for about half of a Cornell pass, so the host paces this tail; it
is read beside `ms_per_spp`, which it moves. A window of a hundred
passes or more holds ten beyond it."""

import statistics


def read(run):
    if len(run.pass_s) < 2:
        return None
    return 1000.0 * statistics.quantiles(run.pass_s, n=10)[8]
