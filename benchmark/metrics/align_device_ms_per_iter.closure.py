"""Device-busy time of the alignments outside the teacher renders (the
target render's forward and backward to the pose, the loss, Adam on the
pose, the best-pose choice) over the alignment iterations."""


def read(view):
    iters = view.work * view.extra.get("iterations_per_step", 0)
    if view.window_us is None or not iters:
        return None
    busy_us = view.busy_in("step") - view.busy_in("teacher")
    if busy_us <= 0:
        return None
    return 1e-3 * busy_us / iters
