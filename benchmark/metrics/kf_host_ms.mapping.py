"""Host time of a keyframe outside `Mapper.optimize`: the span of each
keyframe step less its `optimize` span, averaged over the traced
keyframes (add_keyframe, the late metrics readback, the bookkeeping)."""


def read(view):
    n = view.spans.count("step")
    if not n or not view.spans.count("optimize"):
        return None
    return 1e3 * (view.spans.total_s("step")
                  - view.spans.total_s("optimize")) / n
