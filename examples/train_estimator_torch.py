"""Train the AI throughput estimator (Fig. 3 / Table I) with the PyTorch
port on simulated 5G channels and evaluate R^2 / RMSE per scenario.

Run: PYTHONPATH=src python examples/train_estimator_torch.py [--full-iq]
     [--steps N] [--device cuda|cpu]
(--full-iq uses the paper's full 3276-row spectrograms; the default is 1/3
height, the architecture otherwise identical. The estimator trains on the
card unless --device cpu is given; the LSTM branch runs the lstm_scan
kernel there.)
"""
import argparse

import numpy as np

from repro_torch.channel import scenarios as sc
from repro_torch.estimator.model import EstimatorConfig
from repro_torch.estimator.train import predict, r2_rmse, train_estimator


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-iq", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    n_sc = 3276 if args.full_iq else 1092
    e = EstimatorConfig(n_sc=n_sc)  # lstm_hidden=124, window=30 (paper)
    rng = np.random.default_rng(1)
    print("generating channel dataset...")
    tr = sc.gen_dataset(100, rng, episode_len=12, n_sc=n_sc)
    te = sc.gen_dataset(40, rng, episode_len=8, n_sc=n_sc)
    print(f"train={len(tr['tp'])} test={len(te['tp'])} samples, "
          f"iq={tr['iq'].shape[1:]}, device={args.device}")
    params, hist, (r2, rmse) = train_estimator(
        e, tr, steps=args.steps, batch=24, eval_data=te, log_every=50,
        device=args.device)
    for s, l in hist:
        print(f"  step {s:4d} mse {l:9.1f}")
    print(f"TEST: R2={r2:.4f} RMSE={rmse:.3f} Mbps "
          f"(paper: R2=0.9636 RMSE=2.48)")
    pred = predict(e, params, te, device=args.device)
    for i, scen in enumerate(sc.SCENARIOS):
        m = te["scenario"] == i
        if m.sum() > 2:
            r2s, rmses = r2_rmse(pred[m], te["tp"][m])
            print(f"  {scen:8s}: R2={r2s:.3f} RMSE={rmses:.2f} "
                  f"(n={int(m.sum())})")


if __name__ == "__main__":
    main()
