"""Device operations the traced window ran, over its alignment iterations
(the teacher renders included): an exact count of what the host
launches."""


def read(view):
    iters = view.work * view.extra.get("iterations_per_step", 0)
    if view.window_us is None or not iters:
        return None
    ops = view.ops_in_window()
    return len(ops) / iters if ops else None
