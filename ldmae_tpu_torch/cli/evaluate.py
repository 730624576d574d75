"""Generation-metric CLI (port of ``ldmae_tpu/cli/evaluate.py``).

``python -m ldmae_tpu_torch.cli.evaluate ref_batch.npz sample_batch.npz`` —
the ADM evaluator: FID, sFID, Inception Score (with the weights file's fc
head), precision, recall, printed as one JSON block.

``python -m ldmae_tpu_torch.cli.evaluate --fid path1 path2 [--sp_len N]`` —
pytorch-fid's two-path FID.

Both run on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

from ..eval.evaluator import Evaluator
from ..eval.fid import calculate_fid_given_paths
from ..models.inception import default_feature_fn


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("paths", nargs=2, help="reference batch/stats, sample batch")
    p.add_argument("--fid", action="store_true", help="plain FID only (pytorch-fid style)")
    p.add_argument("--sp_len", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--weights", default=None, help="pt_inception weights path")
    p.add_argument("--ref_stats", default=None, help="npz with mu/sigma/mu_s/sigma_s")
    p.add_argument("--spatial_tap", default="mixed_6_conv",
                   help="sFID feature node: mixed_6_conv (the ADM tap, default) or any Mixed_* block")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    a = p.parse_args(argv)
    if a.fid:
        fid = calculate_fid_given_paths(a.paths, feature_fn=default_feature_fn(a.weights, a.device),
                                        batch_size=a.batch_size, sp_len=a.sp_len)
        print(f"FID: {fid:.6f}")
        return {"fid": fid}
    ev = Evaluator(weights_path=a.weights, batch_size=a.batch_size, spatial_tap=a.spatial_tap, device=a.device)
    report = ev.full_report(a.paths[0], a.paths[1], ref_stats_npz=a.ref_stats, limit=a.sp_len)
    print("computing/reading reference batch statistics... done")
    print(json.dumps({k: float(v) for k, v in report.items()}, indent=2))
    return report


if __name__ == "__main__":
    main()
