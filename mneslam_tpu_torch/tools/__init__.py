"""H100 probes of the kernels' design variants (the counterparts of the TPU
probes under the repository's `tools/`) and the timing and bound helpers
they share with `chip_smoke.py`.

    python -m mneslam_tpu_torch.tools.prof_corr [--device cpu] [--small]
    python -m mneslam_tpu_torch.tools.prof_scatter [--bf16] [--device cpu] [--small]
"""
