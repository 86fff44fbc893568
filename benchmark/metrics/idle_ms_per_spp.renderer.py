"""idle_ms_per_spp.renderer: the card's idle ms per traced sample while
the host was in the renderer's own spans and none below them (the
`render` call and its pass outside the integrator, the film, the image's
resolve and copy to the host), charged as `idle_ms_per_spp.integrator`
says (`spans.py`). Traced-run milliseconds, which sum with the other two
to the traced idle, not to `device_idle` times the untraced pass.
Layer: renderer."""

from ..spans import idle_ms_per_spp


def read(run):
    return idle_ms_per_spp(run, "renderer")
