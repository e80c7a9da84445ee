"""H100 probes of the kernels' design variants (the counterparts of the TPU
probes under the repository's `tools/`) and the timing and bound helpers
they share with `chip_smoke.py`.

    python -m mneslam_tpu_torch.tools.prof_corr [--device cpu] [--small]
    python -m mneslam_tpu_torch.tools.prof_scatter [--bf16] [--device cpu] [--small]

where the tracking-parity check's GPU side loses determinism, and its
GPU-vs-CPU gap by update (GPU only):

    python -m mneslam_tpu_torch.tools.prof_determinism

and the reconstruction metrics of a mesh (host numpy and scipy):

    python -m mneslam_tpu_torch.tools.eval_recon --rec X.ply --gt Y.ply
"""
