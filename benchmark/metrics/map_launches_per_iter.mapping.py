"""Device operations (kernels, copies, fills) the traced window ran, over
its mapping iterations: an exact count of what the host launches."""


def read(view):
    if view.window_us is None or not view.work:
        return None
    ops = view.ops_in_window()
    return len(ops) / view.work if ops else None
