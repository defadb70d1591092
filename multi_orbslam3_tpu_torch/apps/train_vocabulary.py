"""Train and persist the BoW vocabulary on real extracted descriptors
(counterpart of apps/train_vocabulary.py).

Replaces the reference's dependency on the pre-trained ORBvoc.txt
(src/ClientSystem.cc:69-77): renders a corpus of synthetic textured
worlds (many seeds, varied trajectories/viewpoints), extracts ORB
descriptors with the port's frontend (K1 on the card), trains the
hierarchical binary k-means tree, and saves the artifact in the JAX
package's .npz layout, by default next to the port's bow package, where
`default_vocabulary` loads it.

Usage:
    python -m multi_orbslam3_tpu_torch.apps.train_vocabulary [--worlds 30] \\
        [--frames 6] [--branching 10] [--depth 4] [--out <path>] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=30)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--branching", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--max-train", type=int, default=80000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()
    from multi_orbslam3_tpu_torch import devices
    dev = devices.resolve(args.device, "train_vocabulary")

    import numpy as np
    import torch

    from multi_orbslam3_tpu_torch import config as cfg
    from multi_orbslam3_tpu_torch.bow import vocabulary as vocm
    from multi_orbslam3_tpu_torch.dataio import synthetic
    from multi_orbslam3_tpu_torch.frontend import extractor

    c = cfg.synthetic_mono()
    all_desc = []
    for w in range(args.worlds):
        seq = synthetic.make_sequence(
            c, n_frames=args.frames, n_points=700, seed=100 + w,
            trajectory="circle" if w % 2 else "forward",
            phase=0.2 * (w % 5))
        for i in range(seq.images.shape[0]):
            feats = extractor.extract_features(
                torch.from_numpy(np.asarray(seq.images[i], np.float32)).to(dev), c)
            valid = feats.valid.cpu().numpy()
            all_desc.append(feats.desc.cpu().numpy().view(np.uint32)[valid])
        print(f"world {w}: {sum(d.shape[0] for d in all_desc)} descriptors",
              file=sys.stderr, flush=True)
    descs = np.concatenate(all_desc)
    print(f"training on {descs.shape[0]} descriptors "
          f"(k={args.branching}, L={args.depth})", file=sys.stderr)
    voc = vocm.train_vocabulary(descs, args.branching, args.depth,
                                max_train=args.max_train, device=dev)
    out = args.out or vocm.bundled_path(args.branching, args.depth)
    vocm.save_vocabulary(voc, out)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
