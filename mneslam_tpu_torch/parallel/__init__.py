"""Multi-process execution of the port on `torch.distributed`.

Port of `mneslam_tpu/parallel/`: `mesh` (the (agent, ray) layout of the
world's ranks, its collectives, the row-sharded mapper's collective seam,
the descriptor exchange) and `fleet` (agents as mesh slices).
"""
