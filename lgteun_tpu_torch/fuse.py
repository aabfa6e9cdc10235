"""Whole-scene pan-sharpening CLI of the port (counterpart of
`lgteun_tpu/fuse.py`, the JAX package's production serving entry):

    python -m lgteun_tpu_torch.fuse --lr scene_lr.tif --pan scene_pan.tif \\
        -o fused.tif [--method UnlgFormer] [--checkpoint FILE] \\
        [--tile 128 --halo 16 --batch 32] [--bit-depth 11] [--geo ref] \\
        [--device cuda]

- inputs: LrMS [h/4, w/4, C] and PAN [h, w] TIFFs (the reference's
  11-bit uint16 convention, normalised by 2^bit_depth - 0.5 as the
  benchmark pipeline does, reference dataset/utils.py:232);
- the scene runs through `parallel.scene.fuse_scene`: overlapping tiles
  at the model's native size, fused in batches on `--device` (the card
  by default), cosine-blended seams; `--tile 0` fuses the whole scene in
  one forward (UnlgFormer: PAN sides multiples of 16, each factor of any
  size; the FFT mixer's planes up to H 14,514 and W 29,026, odd W
  14,513, `ops.spectral_kernel`);
- `--checkpoint` takes a Runner checkpoint (`Runner.save`) or a
  reference-keyed torch state_dict file (what `convert/from_jax.py`
  produces, saved with `torch.save`), both through
  `Runner.load_checkpoint`; without it the method warns and fuses with
  seeded-init weights;
- output: uint16 TIFF; `--geo ref` stamps the reference's GeoTIFF tags,
  `--geo none` writes a bare TIFF. The log line gives MP/s.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m lgteun_tpu_torch.fuse",
        description="Fuse one large LrMS+PAN scene into HrMS")
    p.add_argument("--lr", required=True, help="LrMS TIFF [h/4, w/4, C]")
    p.add_argument("--pan", required=True, help="PAN TIFF [h, w]")
    p.add_argument("-o", "--out", required=True, help="output TIFF path")
    p.add_argument("--method", default="UnlgFormer",
                   help="registry name (default UnlgFormer)")
    p.add_argument("--checkpoint", default=None,
                   help="a Runner checkpoint or a reference-keyed torch "
                        "state_dict file (omitted: warn and fuse with "
                        "seeded-init weights)")
    p.add_argument("--tile", type=int, default=128,
                   help="0 = fuse the whole scene in ONE forward (no "
                        "tiling; on the card UnlgFormer's FFT mixer takes "
                        "planes up to H 14514 and W 29026, odd W 14513, of "
                        "any factorization, so a PAN of sides that are "
                        "multiples of 16 up to 14512 x 29024); DL "
                        "methods should keep their native training tile")
    p.add_argument("--halo", type=int, default=16)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--bit-depth", type=int, default=11,
                   help="input bit depth; normalisation divides by "
                        "2^bit_depth - 0.5 (reference dataset/utils"
                        ".py:232)")
    p.add_argument("--stage", type=int, default=2,
                   help="unfolding stages for UnlgFormer (reference "
                        "configs/unlg_former.py:93)")
    p.add_argument("--geo", choices=["ref", "none"], default="ref")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions of the kernels)")
    return p


def fuse_scene_files(args, logger=None) -> str:
    logger = logger or logging.getLogger("lgteun_torch.fuse")
    from lgteun_tpu_torch.config import Config
    from lgteun_tpu_torch.data.tiff import REFERENCE_GEO, read_tiff, write_tiff
    from lgteun_tpu_torch.parallel.scene import fuse_scene
    from lgteun_tpu_torch.registry import build_model
    from lgteun_tpu_torch.runner import Runner

    lr = read_tiff(args.lr).astype(np.float32)
    pan = read_tiff(args.pan).astype(np.float32)
    if lr.ndim == 2:
        lr = lr[:, :, None]
    pan = pan[..., :1] if pan.ndim == 3 else pan[:, :, None]
    chans = lr.shape[-1]
    scale = float(2 ** args.bit_depth - 0.5)

    cfg = Config(model_type=args.method, ms_chans=chans,
                 model_cfg={"core_module": {"stage": args.stage}}
                 if args.method == "UnlgFormer" else {})
    method = build_model(args.method, cfg, device=args.device)
    runner = Runner(cfg, method, args.device, logger=logger)
    if args.checkpoint:
        runner.load_checkpoint(args.checkpoint)
    else:
        logger.warning("method %s without --checkpoint: fusing with "
                       "seeded-init weights (seed %d)", args.method,
                       cfg.seed)
        runner.init()

    t0 = time.perf_counter()
    if args.tile == 0:
        out = method.apply({"input_lr": (lr / scale)[None],
                            "input_pan": (pan / scale)[None]})[0]
    else:
        out = fuse_scene(method, lr / scale, pan / scale, tile=args.tile,
                         halo=args.halo, batch=args.batch)
    out = out.cpu().numpy()
    dt = time.perf_counter() - t0
    h, w = out.shape[:2]
    logger.info("fused %dx%dx%d in %.2fs (%.2f MP/s) on %s", h, w, chans,
                dt, h * w / dt / 1e6, args.device)

    dn = np.clip(np.round(out * scale), 0, 2 ** args.bit_depth - 1)
    geo = REFERENCE_GEO if args.geo == "ref" else None
    write_tiff(args.out, dn.astype(np.uint16), geo=geo)
    logger.info("wrote %s", args.out)
    return args.out


def cli(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_argparser().parse_args(argv)
    fuse_scene_files(args)


if __name__ == "__main__":
    cli()
