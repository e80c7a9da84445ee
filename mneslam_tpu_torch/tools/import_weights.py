"""External weights to a `.npz` the port (and the JAX package) reads.

    python -m mneslam_tpu_torch.tools.import_weights droid.pth --out droid.npz
    python -m mneslam_tpu_torch.tools.import_weights Pitts30K_struct.mat \
        --out vlad.npz [--kind droid|netvlad] [--device cuda|cpu]

For each input the tool
  1. validates the checkpoint: droid.pth's state dict against the manifest
     beside this file (`droid_state_dict_manifest.json`), key for key and
     shape for shape (missing, unexpected and mismatched keys reported);
     the NetVLAD `.mat` against the VGG16 + NetVLAD + whitening shapes;
  2. converts it to the parameter tree (`models/droid_net.
     load_droid_weights`: 'module.' stripped, the delta / weight heads cut
     to 2 channels; `agents/netvlad.load_netvlad_mat`);
  3. writes a self-describing `.npz` (`utils/params_io`: the JAX package's
     key format, so either package reads the file) and reads it back bit
     for bit; `tracking.pretrained:` / `checkpoints.<model_name>:` take it;
  4. runs a smoke on `--device` (default cuda; cpu only when asked): DROID
     encodes a random 120 x 160 frame and runs one update; NetVLAD
     describes one image (4096-d, unit norm).

Exit code 0: the file is ready. A validation or smoke failure exits 1 with
its report on stderr. Port of the repository's `tools/import_weights.py`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "droid_state_dict_manifest.json")
VGG16_CHANNELS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512,
                  512]


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def validate_droid_state_dict(path: str):
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    with open(MANIFEST) as f:
        manifest = json.load(f)
    got = {k: list(v.shape) for k, v in sd.items()}
    missing = sorted(set(manifest) - set(got))
    extra = sorted(set(got) - set(manifest))
    bad = sorted(k for k in set(manifest) & set(got)
                 if manifest[k] != got[k])
    problems = []
    if missing:
        problems.append(f"missing keys ({len(missing)}): {missing[:5]} ...")
    if extra:
        problems.append(f"unexpected keys ({len(extra)}): {extra[:5]} ...")
    if bad:
        detail = [f"{k}: expected {manifest[k]}, got {got[k]}"
                  for k in bad[:5]]
        problems.append(f"shape mismatches ({len(bad)}): {detail}")
    if problems:
        fail("droid.pth does not match the golden manifest:\n  "
             + "\n  ".join(problems))
    print(f"validated: {len(got)} tensors match the golden droid manifest")


def _leaves(tree, path=()):
    """[(path, tensor)] of a nested dict / list tree."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _save_and_reload(out: str, params, device):
    """Write the `.npz`, read it back, and check it leaf for leaf."""
    from ..utils.params_io import load_pytree_npz, save_pytree_npz

    save_pytree_npz(out, params)
    reloaded = load_pytree_npz(out, device=device)
    a, b = dict(_leaves(params)), dict(_leaves(reloaded))
    if set(a) != set(b):
        fail("the written .npz does not hold the converted tree's leaves")
    for p, x in a.items():
        if not np.array_equal(x.cpu().numpy(), b[p].cpu().numpy()):
            fail(f"the written .npz differs at {p}")
    return reloaded


def import_droid(path: str, out: str, device):
    import torch

    from ..models import droid_net
    from ..tracking.motion_filter import (encode_and_flow, encode_context,
                                          encode_frame)

    validate_droid_state_dict(path)
    params = droid_net.load_droid_weights(path)

    # structural parity with the runtime-initialised net
    ref = droid_net.init_droid_net(torch.Generator().manual_seed(0))
    got, want = dict(_leaves(params)), dict(_leaves(ref))
    if set(got) != set(want):
        fail("the converted tree's structure differs from init_droid_net")
    for p, a in got.items():
        if a.shape != want[p].shape:
            fail(f"converted shape mismatch at {p}: {tuple(a.shape)} vs "
                 f"{tuple(want[p].shape)}")

    reloaded = _save_and_reload(out, params, device)

    # one-frame smoke: encode, then one GRU / flow update
    H, W = 120, 160
    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.random((3, H, W), np.float32), device=device)
    with torch.no_grad():
        fmap = encode_frame(reloaded, img)
        net, inp = encode_context(reloaded, img)
        _, delta = encode_and_flow(reloaded, fmap, net, inp, img)
    if tuple(fmap.shape) != (128, H // 8, W // 8):
        fail(f"smoke: fmap shape {tuple(fmap.shape)}")
    if not bool(torch.isfinite(delta).all()):
        fail("smoke: GRU/flow update produced non-finite output")
    print(f"smoke OK: fmap {tuple(fmap.shape)}, one GRU update flow delta "
          f"{float(delta):.4f} px")
    print(f"wrote {out} — use it as tracking.pretrained in your config")


def import_netvlad(path: str, out: str, device):
    import torch

    from ..agents import netvlad

    params = netvlad.load_netvlad_mat(path)
    if len(params["convs"]) != 13:
        fail(f"expected 13 VGG16 convs, parsed {len(params['convs'])}")
    in_ch = 3
    for i, (conv, oc) in enumerate(zip(params["convs"], VGG16_CHANNELS)):
        if tuple(conv["weight"].shape) != (oc, in_ch, 3, 3):
            fail(f"conv{i}: expected {(oc, in_ch, 3, 3)}, got "
                 f"{tuple(conv['weight'].shape)}")
        if tuple(conv["bias"].shape) != (oc,):
            fail(f"conv{i} bias: expected ({oc},), got "
                 f"{tuple(conv['bias'].shape)}")
        in_ch = oc
    for key, shape in (("score_w", (64, 512)), ("centers", (512, 64)),
                       ("whiten_w", (4096, 512 * 64)), ("whiten_b", (4096,)),
                       ("mean", (3,))):
        if tuple(params[key].shape) != shape:
            fail(f"{key}: expected {shape}, got {tuple(params[key].shape)}")
    print("validated: VGG16+NetVLAD+whitening shapes all match")

    reloaded = _save_and_reload(out, params, device)

    rng = np.random.default_rng(0)
    img = torch.as_tensor(rng.random((1, 3, 120, 160), np.float32),
                          device=device)
    with torch.no_grad():
        desc = netvlad.netvlad_apply(reloaded, img).cpu().numpy()
    if desc.shape != (1, 4096):
        fail(f"smoke: descriptor shape {desc.shape} != (1, 4096)")
    if not np.isfinite(desc).all():
        fail("smoke: descriptor has non-finite entries")
    if abs(float(np.linalg.norm(desc[0])) - 1.0) > 1e-3:
        fail(f"smoke: descriptor not unit-norm "
             f"({np.linalg.norm(desc[0]):.4f})")
    print("smoke OK: one descriptor, 4096-d, unit norm")
    print(f"wrote {out} — point checkpoints.<model_name> at it in your "
          f"config")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", help="droid.pth / .pt or NetVLAD .mat")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--kind", choices=["droid", "netvlad"], default=None,
                    help="override auto-detection by extension")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the smoke (default cuda; cpu only "
                         "when asked)")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)
    kind = args.kind
    if kind is None:
        ext = os.path.splitext(args.checkpoint)[1].lower()
        kind = {".pth": "droid", ".pt": "droid", ".mat": "netvlad"}.get(ext)
        if kind is None:
            fail(f"cannot infer checkpoint kind from extension {ext!r}; "
                 "pass --kind")
    if kind == "droid":
        import_droid(args.checkpoint, args.out, device)
    else:
        import_netvlad(args.checkpoint, args.out, device)


if __name__ == "__main__":
    main()
