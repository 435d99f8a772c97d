"""Quickstart (PyTorch port): train DLRM with CPR partial recovery under
injected failures.

The port's run of the paper's core experiment end to end: full recovery
vs CPR-MFU on a synthetic Criteo-like click log, with two failures each
clearing 25 % of the embedding-PS shards.  The sizes and printed lines are
``examples/quickstart.py``'s.  Runs on ``cuda`` unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.configs.dlrm import DLRM_KAGGLE, scaled
from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                              SystemParams)
from repro_torch.data.synthetic import ClickLogDataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    device = ap.parse_args(argv).device

    cfg = scaled(DLRM_KAGGLE, max_rows=5000)
    ds = ClickLogDataset(cfg.table_sizes, num_samples=20000, seed=3)
    params = SystemParams()      # production-projected failure/overhead model

    print(f"{len(cfg.table_sizes)} embedding tables, "
          f"{cfg.total_emb_rows()} rows, CTR={ds.ctr:.3f}\n")

    for mode in ("full", "cpr-mfu"):
        mgr = CPRManager(mode, params, cfg.table_sizes, target_pls=0.1,
                         device=device)
        inj = FailureInjector(n_failures=2, fail_fraction=0.25,
                              n_shards=params.N_emb, T_total=params.T_total,
                              seed=11)
        result = Emulator(cfg, ds, mgr, inj, batch_size=256,
                          device=device).run()
        print(result.summary())

    print("\nCPR keeps the AUC of full recovery at ~1/15th of the checkpoint "
          "overhead (paper Fig. 7).")


if __name__ == "__main__":
    main()
