"""Host time of `Mapper.optimize` over its iterations (each span closed by
a synchronisation, so it covers the iterations' device work)."""


def read(view):
    iters = view.spans.count("optimize") * view.extra.get(
        "iterations_per_step", 0)
    if not iters:
        return None
    return 1e3 * view.spans.total_s("optimize") / iters
