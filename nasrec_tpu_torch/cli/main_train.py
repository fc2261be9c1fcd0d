"""Fixed-subnet / full-supernet training CLI (port of
`nasrec_tpu/cli/main_train.py`).

Example (on the card; add --device cpu to run on the CPU):
  python -m nasrec_tpu_torch.cli.main_train --arch criteo-kaggle/xlarge \
      --data_source synthetic --max_train_steps 50 \
      --train_batch_size 2048 --test_batch_size 4096

--net supernet trains the full path of the xlarge supernet (7 blocks, LayerNorm
on) through workloads.train_supernet, as the JAX CLI does.

--net dcnv2 trains DLRM-DCNv2 (configs/dcnv2.py: MLPerf Training's
recommender, 26 multi-hot bags of 128-wide rows, 3 low-rank cross layers)
through workloads.train_dcnv2 on --data_source synthetic multi-hot batches,
each slot's table min(its published rows, --synthetic_vocab) rows, with the
preset's optimiser (Adagrad at 0.005, constant, eps 1e-8, no clip) in place
of --learning_rate, --lr_schedule and the clip; one process:
  python -m nasrec_tpu_torch.cli.main_train --net dcnv2 --data_source synthetic \
      --train_batch_size 16384 --test_batch_size 16384 --max_train_steps 50

Several processes (one per card, or on the CPU with --device cpu and gloo):
every process runs the same command with --num_processes N --process_id i
--coordinator_address host:port and --mesh_model M (the table row-sharded
over M ranks, the batch over N / M); e.g. two processes on the CPU:
  python -m nasrec_tpu_torch.cli.main_train --arch criteo-kaggle/xlarge \
      --data_source synthetic --device cpu --train_batch_size 64 \
      --num_processes 2 --process_id 0 --coordinator_address 127.0.0.1:29500 \
      --mesh_model 2
"""

from __future__ import annotations

import argparse
import dataclasses

from nasrec_tpu_torch.choices import load_choice_file
from nasrec_tpu_torch.cli.common import (
    add_data_args,
    add_distributed_args,
    add_train_args,
    data_options,
    distributed_run,
    train_options,
)
from nasrec_tpu_torch.configs import get_best_arch


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_data_args(p)
    add_train_args(p, lr=0.16)
    add_distributed_args(p)
    p.add_argument("--net", default="supernet-config",
                   choices=["supernet", "supernet-config", "dcnv2"])
    p.add_argument("--supernet_config", default=None,
                   help="Path to a best-arch choice JSON (reference schema)")
    p.add_argument("--arch", default=None,
                   help="Built-in arch '<dataset>/<space>', e.g. criteo-kaggle/autoctr")
    p.add_argument("--use_layernorm", type=int, default=0,
                   help="Fixed subnets train with LN off by default (ref: main_train.py:262)")
    p.add_argument("--use_final_sigmoid", type=int, default=0)
    p.add_argument("--last_n_blocks_out", type=int, default=1)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    with distributed_run(args):    # up before any other work, down before return
        return _run(args)


def _run(args):
    from nasrec_tpu_torch.workloads import (
        SupernetOptions,
        train_dcnv2,
        train_fixed_subnet,
        train_supernet,
    )

    if args.net == "dcnv2":
        from nasrec_tpu_torch.configs import dcnv2

        train = dataclasses.replace(
            train_options(args), learning_rate=dcnv2.LEARNING_RATE,
            lr_schedule="constant-no-warmup", grad_clip=None, adagrad_eps=dcnv2.ADAGRAD_EPS)
        return train_dcnv2(dcnv2.DCNV2_CRITEO1TB, data_options(args), train)
    if args.net == "supernet":
        # Train the full supernet path (ref: main_train.py:244-254).
        return train_supernet(
            SupernetOptions(config="xlarge", num_blocks=7, use_layernorm=True,
                            strategy="full-path", supernet_training_steps=0,
                            last_n_blocks_out=args.last_n_blocks_out),
            data_options(args), train_options(args),
        )
    if args.supernet_config:
        payload = load_choice_file(args.supernet_config)
    elif args.arch:
        dataset, space = args.arch.split("/")
        choice = get_best_arch(dataset, space)
        payload = {**choice, "config": space, "num_blocks": len(choice["macro"])}
    else:
        raise SystemExit("--supernet_config or --arch is required for supernet-config")

    return train_fixed_subnet(
        payload, data_options(args), train_options(args),
        use_layernorm=args.use_layernorm == 1,
        use_final_sigmoid=args.use_final_sigmoid == 1,
        last_n_blocks_out=args.last_n_blocks_out,
    )


if __name__ == "__main__":
    main()
