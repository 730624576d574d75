"""Stack sample PNGs into an ``arr_0`` npz for the ADM evaluator (the port's
copy of ``ldmae_tpu/eval/save_npz.py``).

``python -m ldmae_tpu_torch.eval.save_npz --sample_dir <dir>`` or
``--config <yaml>`` (the sample folder derived from the YAML as the
sampling CLI names it). The npz member is written as a stream, a batch of
rows at a time, so the images are never all in memory.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def folder_name_from_config(config, ckpt_path=None, cfg_scale=None) -> str:
    """The reference's sample-folder naming: lowercase
    ``{model}-ckpt-{stem}-{method}-{steps}`` plus, when cfg_scale > 1,
    ``-interval{start:.2f}-cfg{scale:.2f}-shift{shift:.2f}``."""
    s = config.sample
    ckpt = ckpt_path if ckpt_path is not None else (config.ckpt_path or "random")
    stem = str(ckpt).split("/")[-1].split(".")[0]
    name = (
        f"{config.model.model_type.replace('/', '-')}-ckpt-{stem}"
        f"-{s.sampling_method}-{s.num_sampling_steps}"
    ).lower()
    if cfg_scale is None:
        cfg_scale = s.cfg_scale
    start = s.cfg_interval_start or 0
    shift = s.timestep_shift or 0
    if cfg_scale > 1.0:
        name += f"-interval{start:.2f}" + f"-cfg{cfg_scale:.2f}"
        name += f"-shift{shift:.2f}"
    return name


def _write_npz_streaming(out_path: str, name: str, shape, dtype, batches) -> None:
    """Write one array member into a fresh npz (zip) from an iterator of
    row batches — no full-array materialisation."""
    import zipfile

    from numpy.lib import format as npf

    header = {
        "descr": npf.dtype_to_descr(np.dtype(dtype)),
        "fortran_order": False,
        "shape": tuple(shape),
    }
    with zipfile.ZipFile(out_path, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        with zf.open(f"{name}.npy", "w", force_zip64=True) as f:
            npf.write_array_header_1_0(f, header)
            written = 0
            for b in batches:
                b = np.ascontiguousarray(b, dtype=dtype)
                f.write(b.tobytes())
                written += len(b)
    if written != shape[0]:
        raise ValueError(f"wrote {written} rows, expected {shape[0]}")


def save_npz(
    sample_dir: str,
    out_path: Optional[str] = None,
    num: int = 50000,
    batch: int = 256,
) -> str:
    from PIL import Image

    files = sorted(
        f for f in os.listdir(sample_dir) if f.endswith(".png")
    )[:num]
    if len(files) < num:
        raise ValueError(f"{sample_dir}: {len(files)} < {num} pngs")

    first = np.asarray(Image.open(os.path.join(sample_dir, files[0])).convert("RGB"))
    shape = (num,) + first.shape

    def batches():
        for s in range(0, num, batch):
            yield np.stack([
                np.asarray(Image.open(os.path.join(sample_dir, f)).convert("RGB"))
                for f in files[s : s + batch]
            ])

    out_path = out_path or (sample_dir.rstrip("/") + ".npz")
    _write_npz_streaming(out_path, "arr_0", shape, np.uint8, batches())
    import resource

    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(f"save_npz: {num} images, peak RSS {peak_kb / 1024:.0f} MB")
    return out_path


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--sample_dir", default=None)
    p.add_argument(
        "--config", default=None,
        help="derive the sample folder from the YAML as the sampling CLI names it",
    )
    p.add_argument("--out", default=None)
    p.add_argument("--num", type=int, default=50000)
    a = p.parse_args(argv)
    sample_dir = a.sample_dir
    if sample_dir is None:
        if a.config is None:
            p.error("one of --sample_dir / --config is required")
        from ..core.config import LDMAEConfig

        config = LDMAEConfig.from_yaml(a.config)
        sample_dir = os.path.join(
            config.train.output_dir, config.train.exp_name,
            folder_name_from_config(config),
        )
    print(save_npz(sample_dir, a.out, a.num))


if __name__ == "__main__":
    main()
