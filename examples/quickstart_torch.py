"""Quickstart on the PyTorch port: the paper's pipeline with a measured
privacy profile.

1. Measure privacy: VGG16's activations at all 43 split points for a batch
   of textured images, and dCor(input, activation) at each (the CUDA
   pairwise-distance kernel on a card).
2. Profile the 43 split points (FLOPs, bytes, the measured privacy) and
   build the PSO lookup table (Algorithm 1).
3. Drive the adaptive controller through a throughput collapse and watch
   the split move; run split inference, with the int8 boundary codec, at
   both operating points.

Run: PYTHONPATH=src python examples/quickstart_torch.py   # FULL, on the card
     (--smoke: REDUCED width and one operating point; --device cpu runs
      without a card)
"""
import argparse

import numpy as np
import torch

from repro_torch.core import boundary
from repro_torch.core.controller import AdaptiveSplitController
from repro_torch.core.energy import EDGE_A40X2, UE_VM_2CORE
from repro_torch.core.objective import Constraints, Weights
from repro_torch.core.pso import pso_vectorized
from repro_torch.core.splitting import vgg_head, vgg_tail
from repro_torch.kernels.dcor import dcor_kernel
from repro_torch.models.vgg import (FULL, REDUCED, forward, init_vgg,
                                    vgg_split_profile)

IMAGES, SEED = 16, 0


def main():
    ap = argparse.ArgumentParser(description="paper pipeline quickstart "
                                 "on the PyTorch port")
    ap.add_argument("--smoke", action="store_true",
                    help="REDUCED width, one operating point")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = REDUCED if args.smoke else FULL

    # 1. measured privacy ----------------------------------------------------
    params = init_vgg(cfg, torch.Generator().manual_seed(SEED),
                      device=args.device)
    rng = np.random.default_rng(SEED)  # fig5's textured inputs
    xs = np.cumsum(np.cumsum(rng.normal(size=(
        IMAGES, cfg.image_size, cfg.image_size, 3)), 1), 2)
    xs = (xs * 0.05).astype(np.float32)
    acts = forward(cfg, params, xs, collect=True, device=args.device)
    x = acts[0].reshape(IMAGES, -1)  # op 'input': the images
    privacy = np.array([float(dcor_kernel(x, a.reshape(IMAGES, -1)))
                        for a in acts])
    del acts
    print(f"measured privacy (dCor, {IMAGES} images, "
          f"{cfg.image_size}px x{cfg.width_mult}): splits 1..43 =",
          np.round(privacy, 3).tolist())

    # 2. profile + PSO lookup table (Algorithm 1) ----------------------------
    profile = vgg_split_profile(FULL, privacy=privacy)
    print(f"profile: {profile.n_splits} split points, "
          f"{profile.total_flops / 1e9:.1f} GFLOPs total")
    table = pso_vectorized(
        profile, UE_VM_2CORE, EDGE_A40X2,
        Weights(w_delay=1.0, w_privacy=0.15, w_energy=0.1),
        Constraints(rho_max=0.92, tau_max_s=6.0, e_max_j=40.0),
        tp_max_mbps=130)
    print("lookup table (TP Mbps -> split):",
          {tp: int(table.table[tp]) + 1 for tp in (5, 10, 20, 40, 80, 130)})

    # 3. adaptive control through a throughput collapse ----------------------
    ctl = AdaptiveSplitController(table, device=args.device)
    for tp in [120, 118, 95, 60, 22, 9, 8, 7, 9, 8]:
        l = ctl.update(tp)
        print(f"  estimator reports {tp:4d} Mbps -> run layers 1..{l + 1} "
              "on UE")

    # split inference at the operating points --------------------------------
    for tp in ((130,) if args.smoke else (130, 8)):
        l = table.query(tp)
        act = vgg_head(cfg, params, xs[:2], l, device=args.device)  # UE
        act = boundary.roundtrip(act, boundary.INT8)  # 4x smaller uplink
        out = vgg_tail(cfg, params, act, l, device=args.device)  # edge
        print(f"TP={tp:3d} Mbps: split at {l + 1}, boundary "
              f"{act.numel()} els "
              f"({boundary.transmit_bytes(act.shape, boundary.INT8)} B "
              f"int8), probs sum={float(out.sum()):.3f}")
    print("done.")


if __name__ == "__main__":
    main()
