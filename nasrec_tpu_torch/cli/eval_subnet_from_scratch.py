"""Subnet-from-scratch evaluation CLI (port of
`nasrec_tpu/cli/eval_subnet_from_scratch.py`; ref:
nasrec/eval_subnet_from_scratch.py).

Trains N random (or pickled) subnets from scratch under step budgets, for
search-space and supernet-rank-correlation studies, and writes
from_scratch_results.pickle into --logging_dir.  On the card by default
(add --device cpu to run on the CPU):
  python -m nasrec_tpu_torch.cli.eval_subnet_from_scratch --data_source synthetic \\
      --num_subnets 4 --max_train_steps 200 --max_eval_steps 2 \\
      --train_batch_size 512 --test_batch_size 4096 --logging_dir /tmp/scratch_eval

It takes every flag of the JAX CLI but one: --use_final_sigmoid.  The JAX CLI
accepts that flag (through its shared training flags) and never reads it, so
its runs ignore it; this CLI rejects it as an unrecognized argument rather
than accept a flag that changes nothing (ROADMAP.md, Queue C).  Like the JAX
CLI it takes no multi-process flags.
"""

from __future__ import annotations

import argparse
import pickle

from nasrec_tpu_torch.cli.common import add_data_args, add_train_args, data_options, train_options


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_data_args(p)
    add_train_args(p, lr=0.12)
    p.add_argument("--config", default="xlarge",
                   choices=["xlarge", "xlarge-zeros", "autoctr"])
    p.add_argument("--num_blocks", type=int, default=7)
    p.add_argument("--num_subnets", type=int, default=10)
    p.add_argument("--use_layernorm", type=int, default=0)
    p.add_argument("--choices_pickle", default=None,
                   help="optional pickle with a list of choices to evaluate")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from nasrec_tpu_torch.workloads import eval_subnets_from_scratch

    choices = None
    if args.choices_pickle:
        with open(args.choices_pickle, "rb") as f:
            loaded = pickle.load(f)
        choices = [r["choice"] if isinstance(r, dict) and "choice" in r else r
                   for r in loaded]
    return eval_subnets_from_scratch(
        num_subnets=args.num_subnets,
        choices=choices,
        config=args.config,
        num_blocks=args.num_blocks,
        data=data_options(args),
        train=train_options(args),
        use_layernorm=args.use_layernorm == 1,
        logging_dir=args.logging_dir,
        seed=args.seed,
    )


if __name__ == "__main__":
    main()
