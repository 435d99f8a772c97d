"""Explore the PLS knob (PyTorch port): overhead vs accuracy across
target-PLS values (paper Fig. 9), plus the analytic benefit analysis
(paper Fig. 5 logic).  The sizes and printed lines are
``examples/cpr_tradeoff.py``'s.  Runs on ``cuda`` unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_cpr_tradeoff.py [--device cpu]
"""
import argparse

from repro_torch.configs.dlrm import DLRM_KAGGLE, scaled
from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                              SystemParams, choose_strategy)
from repro_torch.data.synthetic import ClickLogDataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    device = ap.parse_args(argv).device

    p = SystemParams()
    print("Analytic benefit analysis (paper Fig. 5 / §4.1):")
    for pls in (0.01, 0.05, 0.1, 0.2):
        d = choose_strategy(p, pls)
        print(f"  target PLS={pls:<5} -> T_save={d['T_save']:5.1f}h  "
              f"partial={d['use_partial']}  "
              f"overhead full={d['overhead_full']:.2f}h "
              f"partial={d['overhead_partial']:.2f}h")

    cfg = scaled(DLRM_KAGGLE, max_rows=5000)
    ds = ClickLogDataset(cfg.table_sizes, num_samples=20000, seed=3)
    print("\nMeasured (emulation, 2 failures x 25% shards):")
    for pls in (0.02, 0.1, 0.2):
        mgr = CPRManager("cpr-ssu", p, cfg.table_sizes, target_pls=pls,
                         device=device)
        inj = FailureInjector(2, 0.25, p.N_emb, p.T_total, seed=11)
        r = Emulator(cfg, ds, mgr, inj, batch_size=256, device=device).run()
        o = r.report["overheads"]
        print(f"  PLS={pls:<5} auc={r.auc:.4f} "
              f"overhead={o['fraction'] * 100:.2f}% "
              f"measured_pls={r.report['measured_pls']:.4f}")


if __name__ == "__main__":
    main()
