"""`inspect_data` entry of the port (iinsvae_tpu/cli/inspect_data.py): the reference's data
smoke tests (data_tools.py:453-486, dataset.py:139-241) as one command.

Resolves the data as training does (cli/common.resolve_data: the real dataset or the
synthetic fixture, the ``--mode`` split, the mmap cache) and prints the pipeline's wall time,
the split's shapes, value ranges and class counts and one item's shapes, then plots one
train CIR into ``--out_dir`` (matplotlib, imported only for that plot). ``--verify_data``
checks a real dataset's placement instead (data/verify.py) and exits 0 where its schema is
usable, 1 where not.

    python -m iinsvae_torch.cli.inspect_data --dataset_env room_full
    python -m iinsvae_torch.cli.inspect_data --dataset_name ewine
    python -m iinsvae_torch.cli.inspect_data --verify_data
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from iinsvae_torch.cli.common import resolve_data
from iinsvae_torch.config import Config, add_args, add_train_args, from_args
from iinsvae_torch.data.pipeline import UWBDataset
from iinsvae_torch.data.zenodo import label_int2str


def verify_data_main(cfg: Config) -> int:
    """--verify_data: the real dataset's schema and documented scale, nothing trained. -> 0
    where the schema is usable, 1 where not."""
    from iinsvae_torch.data.verify import print_report, verify_ewine, verify_zenodo

    if cfg.dataset_name == "zenodo":
        report = verify_zenodo(cfg.data_root)
        print_report(f"zenodo {cfg.data_root}", report)
    else:
        # --data_root names the Zenodo pickle by default; for eWine verify the directory the
        # user names, and ./data/data_ewine only where --data_root kept its default
        base = "./data/data_ewine" if cfg.data_root == Config().data_root else cfg.data_root
        report = verify_ewine(base)
        print_report(f"ewine {base}", report)
    return 0 if report["ok"] else 1


def main(argv=None):
    """-> (train, test) as resolve_data gives them; with --verify_data, SystemExit with the
    verification's code."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--verify_data", action="store_true",
                        help="check a real dataset's placement (schema and documented counts) "
                             "and exit")
    add_args(parser)
    add_train_args(parser)
    args = parser.parse_args(argv)
    cfg = from_args(args)
    if args.verify_data:
        raise SystemExit(verify_data_main(cfg))
    t0 = time.time()
    data_train, data_test = resolve_data(cfg)
    dt = time.time() - t0
    train_cir, train_err, train_label = data_train

    print(f"pipeline time: {dt:.2f}s")
    print(f"train: cir {train_cir.shape} err {train_err.shape} label {train_label.shape}")
    print(f"test:  cir {data_test[0].shape}")
    print(f"scaled cir range: ({train_cir.min():.4f}, {train_cir.max():.4f})")
    print(f"err range: ({train_err.min():.4f}, {train_err.max():.4f})")
    env = cfg.dataset_env if cfg.dataset_name == "zenodo" else "nlos"
    for c, n in zip(*np.unique(train_label.astype(int), return_counts=True)):
        print(f"class {c} ({label_int2str(env, c)}): {n}")
    item = UWBDataset(data_train)[0]
    print("item shapes:", {k: v.shape for k, v in item.items()})

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(cfg.out_dir, exist_ok=True)
    plt.plot(train_cir[0], color="blue")
    out = os.path.join(cfg.out_dir, "%s_sample_%s.png"
                       % (cfg.dataset_name, label_int2str(env, int(train_label[0][0]))))
    plt.savefig(out)
    plt.close()
    print("wrote", out)
    return data_train, data_test


if __name__ == "__main__":
    main()
