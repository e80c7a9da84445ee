"""H100 probe of the correlation-window kernel's variants, at the frontend's
shapes.

    python -m mneslam_tpu_torch.tools.prof_corr [--device cpu] [--small]

The counterpart of the two TPU probes `tools/prof_corr4.py` and
`tools/prof_corr6.py`, on their inputs (64 frames of 128-channel features
at 40 x 80, 91 edge slots of which 75 are real, radius 3; made here from a
numpy seed). Each TPU variant and its H100 counterpart:

  TPU probe variant                      H100 variant (this probe)
  alt_corr_pallas_ml (production)        alt_corr[pallas]: `ops.correlation.
                                         alt_corr` end to end with
                                         MNESLAM_CORR_IMPL=pallas (pyramid,
                                         kernel 2, bilinear combine)
  alt_corr_xla                           alt_corr[xla]: the same with
                                         MNESLAM_CORR_IMPL=xla (slab gather)
  int-window kernel [vpu]                kernel2: `corr_window_multilevel`
                                         with no mask (all 91 slots computed)
  int-window kernel [vpu+skip]           kernel2+skip: with the mask (the 16
                                         padded slots written as zeros; the
                                         TPU probe leaves them unwritten)
  int-window kernel [mxu] / [mxu+skip]   kernel2b / kernel2b+skip:
                                         `corr_window_multilevel_mma`
                                         (tensor cores, 3xTF32)
  int-window kernel [vpu+skip u1/u2/     kernel2+skip u1 / u2 / u4 / u8, and
  u4/u8] (prof_corr6.py)                 u16: `corr_window_multilevel_
                                         unrolled`, the pixel loop unrolled
                                         U-fold

Protocol: each kernel variant is first checked against the plain version
(`corr_window_multilevel_plain`) per output within CORR_RTOL x the dot of
the magnitudes + CORR_ATOL (both sum C fp32 products, in their own orders;
MMA_RTOL for kernel 2b's 3xTF32), with the masked slots exactly zero; the
unrolled variants are also compared with kernel 2 bit for bit (reported).
alt_corr[pallas] and alt_corr[xla] are checked against each other within
ALT_RTOL x the combine of the dot magnitudes + CORR_ATOL. Then each is
timed: CUDA events around K calls after a warm-up, the median of 5. Each
line gives ms per call, the bound (as `measure.corr_bound_ms`: bytes at
3.35 TB/s or useful flops at the fp32 or TF32 rate) and the error ratio.
The last line is a JSON dict of the results. A wrong or failing variant is
printed, and the probe then exits non-zero. Without `--device cpu` it runs
on the GPU and raises without one; on the CPU every kernel variant runs its
plain version and the times are host-clock times.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.corr_window import (UNROLLS, corr_window_multilevel,
                                   corr_window_multilevel_mma,
                                   corr_window_multilevel_plain,
                                   corr_window_multilevel_unrolled)
from ..ops import correlation
from .measure import FP32_FLOPS, TF32_FLOPS, bound_ms, corr_bound_ms, median_ms

FULL = {"N": 64, "C": 128, "H": 40, "W": 80, "E": 91, "n_real": 75,
        "n_kf": 26}
SMALL = {"N": 8, "C": 128, "H": 16, "W": 24, "E": 12, "n_real": 9,
         "n_kf": 6}
RADIUS = 3
K = 5                       # calls per timed run
WALLS = 5                   # timed runs; the median is reported
# kernel vs plain version: each sums C = 128 fp32 products in its own order
CORR_RTOL = 2 * 128 * 2.0 ** -24
CORR_ATOL = 1e-7
# kernel 2b: 3xTF32 products, summed by the tensor core (chip_smoke.py)
MMA_RTOL = 3 * 2.0 ** -22 + 3 * 128 * 2.0 ** -23 + 128 * 2.0 ** -24
# alt_corr[pallas] vs [xla]: the dots as above, then each side combines four
# weighted dots (four products, three sums: 7 roundings of 2^-24 each)
ALT_RTOL = CORR_RTOL + 2 * 7 * 2.0 ** -24

# each TPU probe variant -> the names of its H100 counterparts
TPU_COUNTERPARTS = {
    "alt_corr_pallas_ml (production)": ["alt_corr[pallas]"],
    "alt_corr_xla": ["alt_corr[xla]"],
    "int-window kernel [vpu]": ["kernel2"],
    "int-window kernel [vpu+skip]": ["kernel2+skip"],
    "int-window kernel [mxu]": ["kernel2b"],
    "int-window kernel [mxu+skip]": ["kernel2b+skip"],
    **{f"int-window kernel [vpu+skip u{u}]": [f"kernel2+skip u{u}"]
       for u in (1, 2, 4, 8)},
}


@contextlib.contextmanager
def corr_impl(value: str):
    """MNESLAM_CORR_IMPL set for the block, restored after."""
    old = os.environ.get("MNESLAM_CORR_IMPL")
    os.environ["MNESLAM_CORR_IMPL"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MNESLAM_CORR_IMPL")
        else:
            os.environ["MNESLAM_CORR_IMPL"] = old


def probe_inputs(device: torch.device, N, C, H, W, E, n_real, n_kf,
                 seed: int = 0):
    """The TPU probes' inputs (`tools/prof_corr4.py:46-62`) from a numpy
    seed: fmaps [N, C, H, W] ~ 0.1 N(0, 1), lookup centres = pixel grid +
    N(0, 1) [E, H, W, 2], the four-band (ii, jj) edge list of n_kf frames,
    the first n_real slots real."""
    rng = np.random.default_rng(seed)
    fmaps = (0.1 * rng.standard_normal((N, C, H, W))).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"),
                    axis=-1).astype(np.float32)
    coords = (grid[None] + rng.standard_normal((E, H, W, 2))).astype(
        np.float32)
    ii = np.concatenate([np.arange(0, n_kf - 1), np.arange(1, n_kf),
                         np.arange(0, n_kf - 2), np.arange(2, n_kf)])[:E]
    jj = np.concatenate([np.arange(1, n_kf), np.arange(0, n_kf - 1),
                         np.arange(2, n_kf), np.arange(0, n_kf - 2)])[:E]
    mask = (np.arange(E) < n_real).astype(np.int32)
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
    return (t(fmaps), t(ii, torch.int32), t(jj, torch.int32), t(coords),
            t(mask))


def kernel_inputs(fmaps, coords):
    """f1 rows, padded levels, widths and slab starts as `alt_corr` builds
    them."""
    pyr = correlation.build_pyramid(fmaps)
    N, C, H, W = pyr[0].shape
    f1 = pyr[0].permute(0, 2, 3, 1).reshape(N, H * W, C).contiguous()
    levels, w2ps, xs, _ = correlation._padded_levels(pyr, coords, RADIUS)
    return f1, levels, w2ps, xs


def alt_corr_bound(fmaps, coords, ii, jj, mask, f1, levels, xs):
    """alt_corr's least time: bytes (fmaps, the centres, the [E, 196, H, W]
    output, each once) against the kernel's useful flops at the fp32 rate."""
    E = coords.shape[0]
    HW = fmaps.shape[2] * fmaps.shape[3]
    nbytes = (fmaps.numel() * 4 + coords.numel() * 4
              + E * 4 * (2 * RADIUS + 1) ** 2 * HW * 4)
    flops = corr_bound_ms(f1, levels, ii, jj, xs, mask)[3]
    return bound_ms(nbytes, flops, FP32_FLOPS)


def run(device="cuda", small: bool = False, reps: int = None,
        walls: int = None, log: Callable[[str], None] = print) -> Dict:
    """Check, then time, every variant -> {"device", "failed": [names],
    "<variant>": {"ms", "bound_ms", "bound_by", "max_abs_err",
    "err_ratio"[, "equal_to_kernel2", "max_abs_diff_kernel2"]} or
    "wrong: ..." / "failed: ..."}."""
    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    reps = (K if on_gpu else 1) if reps is None else reps
    walls = (WALLS if on_gpu else 1) if walls is None else walls
    shape = SMALL if small else FULL
    kind = torch.cuda.get_device_name(dev) if on_gpu else "cpu"
    log(f"device={kind} ({'CUDA events' if on_gpu else 'host clock'})  "
        f"K={reps}  median of {walls}  {json.dumps(shape)}")
    results: Dict = {"device": kind, "failed": []}

    fmaps, ii, jj, coords, mask = probe_inputs(dev, **shape)
    f1, levels, w2ps, xs = kernel_inputs(fmaps, coords)
    ones = torch.ones_like(mask)
    args = (f1, levels, ii, jj, xs, w2ps)
    ref = corr_window_multilevel_plain(*args)
    mag = corr_window_multilevel_plain(f1.abs(), [lv.abs() for lv in levels],
                                       ii, jj, xs, w2ps)
    real = (mask != 0)[:, None, None, None]
    with torch.no_grad():
        alt_mag = correlation.alt_corr_plain(fmaps.abs(), ii, jj, coords,
                                             radius=RADIUS) * mask[
            :, None, None, None]

    def record(name, fn, expect, tol, bound, extra=None):
        try:
            got = fn()
            err = (got - expect).abs()
            ratio = float((err / tol).max())
            if got.shape != expect.shape or not ratio <= 1.0:
                log(f"{name:34s} WRONG (err / tolerance {ratio:.3g})")
                results[name] = f"wrong: err / tolerance {ratio:.3g}"
                results["failed"].append(name)
                return None
            ms = median_ms(fn, dev, reps, walls)
        except Exception as e:  # noqa: BLE001 — reported, then exit 1
            msg = str(e).split("\n")[0][:160]
            log(f"{name:34s} FAILED: {msg}")
            results[name] = f"failed: {msg}"
            results["failed"].append(name)
            return None
        b_ms, by = bound
        results[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": by,
                         "max_abs_err": float(err.max()), "err_ratio": ratio,
                         **(extra or {})}
        log(f"{name:34s} {ms:9.4f} ms/call  bound {b_ms:.4f} ms ({by})  "
            f"err/tol {ratio:.3g}"
            + "".join(f"  {k} {v}" for k, v in (extra or {}).items()))
        return got

    # end to end through the MNESLAM_CORR_IMPL selection
    outs = {}
    for impl in ("pallas", "xla"):
        with corr_impl(impl), torch.no_grad():
            outs[impl] = correlation.alt_corr(fmaps, ii, jj, coords,
                                              radius=RADIUS, mask=mask)
    alt_tol = ALT_RTOL * alt_mag + CORR_ATOL
    alt_b = alt_corr_bound(fmaps, coords, ii, jj, mask, f1, levels, xs)
    for impl, other in (("pallas", "xla"), ("xla", "pallas")):
        def alt(impl=impl):
            with corr_impl(impl), torch.no_grad():
                return correlation.alt_corr(fmaps, ii, jj, coords,
                                            radius=RADIUS, mask=mask)
        record(f"alt_corr[{impl}]", alt, outs[other], alt_tol, alt_b)
    del outs

    # the int-window kernels
    tol = CORR_RTOL * mag + CORR_ATOL
    tol_mma = MMA_RTOL * mag + CORR_ATOL
    ref_skip = torch.where(real, ref, torch.zeros_like(ref))
    b_all = corr_bound_ms(f1, levels, ii, jj, xs, ones)[:2]
    b_skip = corr_bound_ms(f1, levels, ii, jj, xs, mask)[:2]
    b_all_tc = corr_bound_ms(f1, levels, ii, jj, xs, ones, TF32_FLOPS)[:2]
    b_skip_tc = corr_bound_ms(f1, levels, ii, jj, xs, mask, TF32_FLOPS)[:2]
    record("kernel2", lambda: corr_window_multilevel(*args), ref, tol, b_all)
    k2 = record("kernel2+skip",
                lambda: corr_window_multilevel(*args, mask=mask), ref_skip,
                tol, b_skip)
    record("kernel2b", lambda: corr_window_multilevel_mma(*args), ref,
           tol_mma, b_all_tc)
    record("kernel2b+skip", lambda: corr_window_multilevel_mma(*args,
                                                               mask=mask),
           ref_skip, tol_mma, b_skip_tc)
    for u in UNROLLS:
        fn = (lambda u=u: corr_window_multilevel_unrolled(*args, mask=mask,
                                                          unroll=u))
        extra = None
        if k2 is not None:
            got = fn()
            extra = {"equal_to_kernel2": bool(torch.equal(got, k2)),
                     "max_abs_diff_kernel2": float((got - k2).abs().max())}
            del got
        record(f"kernel2+skip u{u}", fn, ref_skip, tol, b_skip, extra)
    return results


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--small", action="store_true",
                    help="8 frames of 16 x 24, 12 edge slots: a quick run "
                         "on the CPU")
    args = ap.parse_args(argv)
    results = run(args.device, small=args.small)
    print(json.dumps(results), flush=True)
    return 1 if results["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
