"""Train the top-k EA-discovered architectures end-to-end and rank them on
the validation split (the port's counterpart of
scripts/eval_best_candidate/eval_best_candidates_topk.py: the same flags,
HPARAMS and summary file, plus --device).

Re-imagining of the reference's SLURM job generator
(ref: nasrec/scripts/eval_best_candidate/eval_best_candidate_top15.py:52-148):
instead of emitting one sbatch job per candidate, this runs the candidates
directly, sequentially in one process or sharded across processes with
--host_id/--num_hosts (candidate i runs where i % num_hosts == host_id).

Usage (on the card; add --device cpu to run on the CPU):
  python -m nasrec_tpu_torch.tools.eval_best_candidates_topk \
      --ea_dir ./experiments/ea/criteo_xlarge/export \
      --dataset criteo-kaggle --root_dir ./data/criteo_kaggle_autoctr \
      --top_k 15 [--host_id 0 --num_hosts 1]

Expects ea_dir to hold best_config_{i}.json files (written by
nasrec_tpu_torch.tools.export_ea_results).  Validation-split protocol as in
the reference: train on the `train` split, validate on `val`
(ref: eval_best_candidate_top15.py:138-139).  Writes each candidate's run
under <logging_root>/config-<i>/ and the ranking, best first, to
<logging_root>/summary_host<host_id>.json.
"""

from __future__ import annotations

import argparse
import json
import os

from nasrec_tpu_torch.choices import load_choice_file
from nasrec_tpu_torch.workloads import DataOptions, TrainOptions, train_fixed_subnet

# Reference per-dataset split sizes and hyperparams
# (ref: eval_best_candidate_top15.py:6-49).
HPARAMS = {
    "criteo-kaggle": {"batch_size": 512, "train_limit": 36672495, "val_limit": 4584061},
    "avazu": {"batch_size": 512, "train_limit": 32343175, "val_limit": 4042896},
    "kdd": {"batch_size": 1024, "train_limit": 119711284, "val_limit": 14963910},
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ea_dir", required=True,
                   help="directory holding best_config_{i}.json")
    p.add_argument("--dataset", default="criteo-kaggle", choices=list(HPARAMS.keys()))
    p.add_argument("--root_dir", default="")
    p.add_argument("--data_source", default="tsv", choices=["tsv", "synthetic"])
    p.add_argument("--top_k", type=int, default=15)
    p.add_argument("--learning_rate", type=float, default=0.12)
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--test_interval", type=int, default=10000)
    p.add_argument("--max_train_steps", type=int, default=-1)
    p.add_argument("--max_eval_steps", type=int, default=-1)
    p.add_argument("--train_batch_size", type=int, default=0,
                   help="0: the reference per-dataset batch size")
    p.add_argument("--test_batch_size", type=int, default=16368)
    p.add_argument("--mesh_model", type=int, default=0)
    p.add_argument("--host_id", type=int, default=0)
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--logging_root", default="./experiments/best-candidates")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default; raises without one) or the CPU")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    hp = HPARAMS[args.dataset]
    results = []
    for i in range(args.top_k):
        if i % args.num_hosts != args.host_id:
            continue
        cfg_path = os.path.join(args.ea_dir, f"best_config_{i}.json")
        if not os.path.exists(cfg_path):
            print(f"skip candidate {i}: {cfg_path} missing")
            continue
        payload = load_choice_file(cfg_path)
        logging_dir = os.path.join(args.logging_root, f"config-{i}")
        print(f"=== candidate {i}: {cfg_path} -> {logging_dir}")
        data = DataOptions(
            dataset=args.dataset, root_dir=args.root_dir, data_source=args.data_source,
            train_split="train", validate_split="val",
            train_batch_size=args.train_batch_size or hp["batch_size"],
            test_batch_size=args.test_batch_size,
        )
        train = TrainOptions(
            learning_rate=args.learning_rate, wd=args.wd,
            train_limit=hp["train_limit"], test_limit=hp["val_limit"],
            test_interval=args.test_interval, max_train_steps=args.max_train_steps,
            max_eval_steps=args.max_eval_steps, logging_dir=logging_dir,
            mesh_model=args.mesh_model, device=args.device,
        )
        out = train_fixed_subnet(payload, data, train)
        logs = out["logs"][-1]
        val_loss = logs["test_loss"][-1] if logs["test_loss"] else float("inf")
        results.append({"candidate": i, "val_loss": val_loss, "config": cfg_path})
        print(f"candidate {i}: val_loss {val_loss:.6f}")

    results.sort(key=lambda r: r["val_loss"])
    summary = os.path.join(args.logging_root, f"summary_host{args.host_id}.json")
    os.makedirs(args.logging_root, exist_ok=True)
    with open(summary, "w") as f:
        json.dump(results, f, indent=2)
    print(f"ranked {len(results)} candidates -> {summary}")
    return results


if __name__ == "__main__":
    main()
