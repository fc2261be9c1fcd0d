"""EA / random search over a trained supernet (port of
`nasrec_tpu/cli/eval_subnet_from_supernet.py`; ref:
nasrec/eval_subnet_from_supernet.py).

Canonical EA hyperparameters (ref: scripts/run_ea/criteo_run_ea_from_supernet_xlarge.sh),
on the card on synthetic data (add --device cpu, and fewer blocks, to run on
the CPU):
  python -m nasrec_tpu_torch.cli.eval_subnet_from_supernet --data_source synthetic \\
      --ckpt_path .../supernet_checkpoint.pkl \\
      --method regularized-ea --n_generations 240 --n_childs 8 \\
      --init_population 128 --sample_size 64 --ea_top_k 2 \\
      --learning_rate 0.04 --max_train_steps 500 --max_eval_steps 150 \\
      --train_batch_size 512 --test_batch_size 8192 --use_layernorm 1 \\
      --config xlarge --cap_vocab 1 --logging_dir ./experiments/criteo_ea

--ckpt_path takes a supernet checkpoint of either package.  --method cached
re-scores the candidates of a record file and carries each record's
test_loss as gt_test_loss.  --criterion test_loss_penalty_lat with --beta != 0
adds each candidate's forward latency at --latency_batch_size to its
objective: --latency_estimator cost-model (the default; counted, nothing
timed) or measured (timed through the kernels).  --attention_impl as in
cli/common.py.  With --num_processes N (and --process_id,
--coordinator_address on each process) the candidate groups fan out across
the processes (search/evolution.py :: SearchConfig.distribute): each reads the
whole stream, evaluates its own groups, and the metrics are exchanged over
gloo; process 0 writes the results.  N processes may share one card.
"""

from __future__ import annotations

import argparse
import os
import pickle

from nasrec_tpu_torch.cli.common import (
    add_attention_impl_arg,
    add_data_args,
    add_distributed_args,
    data_options,
    distributed_run,
)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_data_args(p, train_bs=512, test_bs=8192)
    add_distributed_args(p)
    p.add_argument("--method", default="regularized-ea",
                   choices=["regularized-ea", "random", "cached"])
    p.add_argument("--choice_from_pickle_file", default=None,
                   help="pickle of candidate records to re-score with "
                        "--method cached (ref: eval_subnet_from_supernet.py:252-283)")
    p.add_argument("--config", default="xlarge",
                   choices=["xlarge", "xlarge-zeros", "autoctr"])
    p.add_argument("--num_blocks", type=int, default=7)
    p.add_argument("--use_layernorm", type=int, default=1)
    p.add_argument("--ckpt_path", default=None, help="trained supernet checkpoint")
    p.add_argument("--learning_rate", type=float, default=0.04)
    p.add_argument("--max_train_steps", type=int, default=500)
    p.add_argument("--max_eval_steps", type=int, default=150)
    p.add_argument("--n_generations", type=int, default=240)
    p.add_argument("--n_childs", type=int, default=8)
    p.add_argument("--init_population", type=int, default=128)
    p.add_argument("--sample_size", type=int, default=64)
    p.add_argument("--ea_top_k", type=int, default=2)
    p.add_argument("--budget", type=int, default=200, help="random-search budget")
    p.add_argument("--criterion", default="test_loss",
                   choices=["test_loss", "test_acc", "test_auroc",
                            "test_loss_penalty_lat"])
    p.add_argument("--group_size", type=int, default=8,
                   help="candidates per evaluation group")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--beta", type=float, default=0.0,
                   help="latency penalty strength (test_loss_penalty_lat)")
    p.add_argument("--target_latency", type=float, default=-1.0)
    p.add_argument("--latency_batch_size", type=int, default=512)
    p.add_argument("--latency_trials", type=int, default=50)
    p.add_argument("--latency_estimator", default="cost-model",
                   choices=["cost-model", "measured"],
                   help="'cost-model' (default): matmul FLOPs and tensor bytes of the "
                        "plain forward, counted on the meta device, over one chip "
                        "calibration; 'measured': time each distinct plan's forward")
    p.add_argument("--finetune_whole_supernet", type=int, default=0,
                   help="1: fine-tune all params, one candidate at a time")
    add_attention_impl_arg(p)
    p.add_argument("--logging_dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default; raises without one) or the CPU")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    with distributed_run(args):    # up before any other work, down before return
        return _run(args)


def _run(args):
    from nasrec_tpu_torch.workloads import (
        SearchOptions,
        evaluate_choices_from_supernet,
        search_from_supernet,
    )

    so = SearchOptions(
        method=args.method, config=args.config, num_blocks=args.num_blocks,
        use_layernorm=args.use_layernorm == 1, ckpt_path=args.ckpt_path,
        learning_rate=args.learning_rate, max_train_steps=args.max_train_steps,
        max_eval_steps=args.max_eval_steps, n_generations=args.n_generations,
        n_childs=args.n_childs, init_population=args.init_population,
        sample_size=args.sample_size, ea_top_k=args.ea_top_k, budget=args.budget,
        criterion=args.criterion, group_size=args.group_size, seed=args.seed,
        beta=args.beta, target_latency=args.target_latency,
        latency_batch_size=args.latency_batch_size,
        latency_trials=args.latency_trials,
        latency_estimator=args.latency_estimator,
        finetune_mode="whole" if args.finetune_whole_supernet == 1 else "final-only",
        attention_impl=args.attention_impl,
        device=args.device,
    )
    if args.method != "cached":
        return search_from_supernet(so, data_options(args, globalized=False),
                                    logging_dir=args.logging_dir)
    # Re-score an explicit candidate pickle against the supernet: the
    # reference's rank-correlation workflow (ref:
    # eval_subnet_from_supernet.py:252-283, flag :356).
    if args.choice_from_pickle_file is None:
        raise SystemExit("--choice_from_pickle_file is required with --method cached")
    with open(args.choice_from_pickle_file, "rb") as f:
        records = pickle.load(f)
    # Accept both raw choice dicts and {"choice": ..., ...} records.
    choices = [r["choice"] if isinstance(r, dict) and "choice" in r else r for r in records]
    print(f"Evaluating {len(choices)} subnets from record file: "
          f"{args.choice_from_pickle_file}")
    results = evaluate_choices_from_supernet(choices, so, data_options(args, globalized=False))
    for rec, res in zip(records, results):
        if isinstance(rec, dict) and "test_loss" in rec:
            res["gt_test_loss"] = rec["test_loss"]
    if args.logging_dir:
        os.makedirs(args.logging_dir, exist_ok=True)
        with open(os.path.join(args.logging_dir, "results.pickle"), "wb") as f:
            pickle.dump(results, f)
    return results


if __name__ == "__main__":
    main()
