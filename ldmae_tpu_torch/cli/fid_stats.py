"""FID reference statistics from an image folder or an ``arr_0`` npz (port of
``ldmae_tpu/cli/fid_stats.py``): the {mu, sigma, mu_s, sigma_s} npz that
the evaluator and the sampling CLI's FID pass read (the role of ADM's
VIRTUAL_imagenet256_labeled.npz, ``data.fid_reference_file`` in a config).

Usage:
    python -m ldmae_tpu_torch.cli.fid_stats --input <folder or npz> --out ref.npz [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..eval.evaluator import Evaluator, compute_statistics


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="image folder or arr_0 .npz")
    p.add_argument("--out", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--spatial_tap", default="mixed_6_conv",
                   help="sFID feature node: mixed_6_conv (the ADM tap, default) or any Mixed_* block")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    a = p.parse_args(argv)
    ev = Evaluator(weights_path=a.weights, batch_size=a.batch_size, spatial_tap=a.spatial_tap, device=a.device)
    pooled, spatial = ev.read_activations(a.input, limit=a.limit)
    st, st_s = compute_statistics(pooled), compute_statistics(spatial)
    np.savez(a.out, mu=st.mu, sigma=st.sigma, mu_s=st_s.mu, sigma_s=st_s.sigma)
    print(f"wrote {a.out}: mu {st.mu.shape}, sigma {st.sigma.shape}, mu_s {st_s.mu.shape} from {len(pooled)} images")
    return a.out


if __name__ == "__main__":
    main()
