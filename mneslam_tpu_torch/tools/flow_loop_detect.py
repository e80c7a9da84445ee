"""Offline pairwise-flow loop detection between two image lists.

    python -m mneslam_tpu_torch.tools.flow_loop_detect --list_a a.txt \
        --list_b b.txt --weights droid.pth --out flows.csv \
        [--H 240] [--W 320] [--device cuda|cpu]

Each list file names one image a line. For every pair (a, b) the tool
estimates the DROID flow magnitude between the two frames with the motion
filter's machinery (`tracking/motion_filter`: encode_frame, encode_context,
flow_magnitude, whose lookup is `ops/correlation.self_corr`, the
correlation kernel at one edge on a GPU), writes the pairs to a CSV
(image_a, image_b, flow_px) and prints the minimum-flow pair. Without
`--weights` the nets get random weights and the flows mean nothing. On the
GPU the nets run in bf16, as the tracker's do; on the CPU in fp32. Runs on
the GPU unless `--device cpu` is given.

Images load as the reference loader's do: 8-bit RGB (PNG through the
port's own codec, other files through cv2), resized with cv2's
INTER_LINEAR on the 8-bit image when their size is not H x W, then divided
by 255. Port of the repository's `tools/flow_loop_detect.py`.
"""

from __future__ import annotations

import argparse
import csv

import numpy as np
import torch


def load_image(path: str, H: int, W: int, device) -> torch.Tensor:
    """[3, H, W] float32 in [0, 1] on `device`."""
    from ..data.image_io import imread_color_u8

    img = imread_color_u8(path)
    if img.shape[:2] != (H, W):
        import cv2

        img = cv2.resize(img, (W, H))
    img = img.astype(np.float32) / 255.0
    return torch.from_numpy(img.transpose(2, 0, 1).copy()).to(device)


def droid_params(weights, device) -> dict:
    """droid.pth's weights, or without a path random ones drawn on the CPU
    from seed 0 (the same on every device); in bf16 on a GPU."""
    from ..device import make_generator
    from ..models import droid_net

    if weights:
        params = droid_net.load_droid_weights(weights, device=device)
    else:
        print("WARNING: no weights given — flow magnitudes are meaningless")
        params = droid_net.map_params(
            droid_net.init_droid_net(make_generator(torch.device("cpu"), 0)),
            lambda t: t.to(device))
    if device.type == "cuda":
        params = droid_net.cast_params(params, torch.bfloat16)
    return params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--list_a", required=True)
    ap.add_argument("--list_b", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--out", default="flows.csv")
    ap.add_argument("--H", type=int, default=240)
    ap.add_argument("--W", type=int, default=320)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..tracking.motion_filter import (encode_context, encode_frame,
                                          flow_magnitude)

    device = resolve_device(args.device)
    params = droid_params(args.weights, device)
    with open(args.list_a) as f:
        paths_a = [line.strip() for line in f if line.strip()]
    with open(args.list_b) as f:
        paths_b = [line.strip() for line in f if line.strip()]

    rows = []
    best = (None, None, float("inf"))
    with torch.no_grad():
        for pa in paths_a:
            img_a = load_image(pa, args.H, args.W, device)
            fmap_a = encode_frame(params, img_a)
            net_a, inp_a = encode_context(params, img_a)
            for pb in paths_b:
                img_b = load_image(pb, args.H, args.W, device)
                fmap_b = encode_frame(params, img_b)
                flow = float(flow_magnitude(params, fmap_a, fmap_b, net_a,
                                            inp_a))
                rows.append((pa, pb, flow))
                if flow < best[2]:
                    best = (pa, pb, flow)

    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image_a", "image_b", "flow_px"])
        w.writerows(rows)
    print(f"{len(rows)} pairs -> {args.out}")
    print(f"min-flow pair: {best[0]} <-> {best[1]} ({best[2]:.2f} px)")
    return {"pairs": rows, "best": best}


if __name__ == "__main__":
    main()
