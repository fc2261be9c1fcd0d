"""Supernet one-shot training CLI (port of `nasrec_tpu/cli/train_supernet.py`;
ref: nasrec/train_supernet.py).

Canonical configuration (ref: scripts/train_supernet/train_supernet_xlarge_criteo.sh),
on the card on synthetic data (add --device cpu, and fewer blocks, to run on
the CPU):
  python -m nasrec_tpu_torch.cli.train_supernet --data_source synthetic \
      --learning_rate 0.12 --train_batch_size 512 --strategy default \
      --anypath_choice binomial-0.5 --use_layernorm 1 \
      --supernet_training_steps 15000 --config xlarge --num_blocks 7 \
      --cap_vocab 1 --logging_dir ./experiments/criteo_supernet

Writes configs_args.json, train_test_logs.{json,pickle}, metrics.jsonl and
supernet_checkpoint.pkl (the JAX package's layout) into --logging_dir;
--checkpoint_path resumes from such a checkpoint at its step (a pickle, or
the directory that --ckpt_backend orbax writes).  The multi-process flags
(--num_processes, --process_id, --coordinator_address, --host_id,
--num_hosts) run several processes over a --mesh_model mesh, as in
cli/main_train.py.
"""

from __future__ import annotations

import argparse

from nasrec_tpu_torch.cli.common import (
    add_data_args,
    add_distributed_args,
    add_train_args,
    data_options,
    distributed_run,
    train_options,
)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_data_args(p, train_bs=512, test_bs=4096)
    add_train_args(p, lr=0.12)
    add_distributed_args(p)
    p.add_argument("--config", default="xlarge",
                   choices=["xlarge", "xlarge-zeros", "autoctr"])
    p.add_argument("--num_blocks", type=int, default=7)
    p.add_argument("--use_layernorm", type=int, default=1)
    p.add_argument("--use_final_sigmoid", type=int, default=0,
                   help="apply sigmoid to the model output (ref: supernet.py:284-287)")
    p.add_argument("--last_n_blocks_out", type=int, default=1,
                   help="head reads the concat of the last N blocks' outputs "
                        "(ref constructor param: supernet.py:226)")
    p.add_argument("--strategy", default="default",
                   choices=["default", "single-path", "any-path", "full-path",
                            "fixed-path", "evo-2shot-path"])
    p.add_argument("--anypath_choice", default="binomial-0.5",
                   choices=["uniform", "binomial-0.5"])
    p.add_argument("--supernet_training_steps", type=int, default=15000,
                   help="full-path warmup steps with linearly decayed probability")
    p.add_argument("--checkpoint_path", default=None, help="resume checkpoint")
    p.add_argument("--evo_2shot_path_candidates", default=None,
                   help="pickle with candidate choices for evo-2shot-path")
    p.add_argument("--pretrained_emb_path", default=None,
                   help="seed the embedding table from a donor checkpoint")
    p.add_argument("--eval_path", default="sampled", choices=["sampled", "full-path"],
                   help="supernet eval forward: sample a random subnet per eval "
                        "batch (reference behavior, ref: train_utils.py:144-147) "
                        "or run every node")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    with distributed_run(args):    # up before any other work, down before return
        return _run(args)


def _run(args):
    from nasrec_tpu_torch.workloads import SupernetOptions, train_supernet

    sn = SupernetOptions(
        config=args.config,
        num_blocks=args.num_blocks,
        use_layernorm=args.use_layernorm == 1,
        strategy=args.strategy,
        anypath_choice=args.anypath_choice,
        supernet_training_steps=args.supernet_training_steps,
        checkpoint_path=args.checkpoint_path,
        evo_2shot_candidates_path=args.evo_2shot_path_candidates,
        pretrained_emb_path=args.pretrained_emb_path,
        use_final_sigmoid=args.use_final_sigmoid == 1,
        eval_path=args.eval_path,
        last_n_blocks_out=args.last_n_blocks_out,
    )
    return train_supernet(sn, data_options(args), train_options(args))


if __name__ == "__main__":
    main()
